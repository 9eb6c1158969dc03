"""The attribution suite's runner, embedding arithmetic and the CLI's
--visualize, against the JAX package on the CPU.

The suite: the port's and the JAX package's `Visualizations` over one
2-volume dataset (tests/test_torch_port_attribution.py's SMALL_VIT, a BERT
of 2048 words so the stand-in WordTokenizer's ids fit, 16-token reports),
the same weights (convert.from_jax_params), render_gifs off: raw attention,
rollout, Grad-CAM and occlusion through the flags dict (a coarse
OcclusionConfig: 8 windows) in both of its modes, then integrated gradients
at 6 steps through the worklists. Every .npy sits at the same relative
path in both results folders and lies within the methods' map band, 1e-3
(tests/test_torch_port_attribution.py, test_torch_port_grad_attribution.py).

Embedding arithmetic: the diff embeddings against JAX
`compute_diff_embeddings` within 1e-5 (a missing label, a pathology with no
positive); the .npy files load in the other package; the script's CSV
reading (csv, with empty and "NA" cells, a report with no labels row, two
labels rows of one volume) gives pandas' merge's texts and labels; the
script writes what compute_diff_embeddings computes.

The CLI: `inference_ctclip.main` with --zero-shot, all five methods,
--diff-embeds and --occlusion-text-embeds writes metrics.txt and every
method's maps and GIFs (the renders recorded, not drawn, and occlusion's
window shrunk to this volume); its refusals stay those of the JAX parser.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ct_clip_ut_tpu import config as jconfig
from ct_clip_ut_tpu.attribution import embedding_arithmetic as jea
from ct_clip_ut_tpu.attribution import suite as jsuite
from ct_clip_ut_tpu.models import ctclip as jclip
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.attribution import embedding_arithmetic as tea
from ct_clip_ut_tpu_torch.attribution import suite as tsuite
from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
from ct_clip_ut_tpu_torch.scripts import embedding_arithmetic as escript
from ct_clip_ut_tpu_torch.scripts import inference_ctclip as cli

from test_torch_port_attribution import SMALL_VIT
from test_torch_port_data import CFG, TINY_CLIP, fake_dataset_dir  # noqa: F401  (a fixture)
from test_torch_port_modules import port_config

BERT = jconfig.BertConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=4,
                          intermediate_size=64, max_position_embeddings=512)
SUITE_CLIP = jconfig.CTCLIPConfig(dim_text=32, dim_image=4 * 4 * 16, dim_latent=8,
                                  ctvit=SMALL_VIT, bert=BERT)
MAP_BAND = 1e-3
TEXT_LEN = 16
PATHS = pconfig.PATHOLOGIES
COARSE = dict(patch_size=(10, 16, 16), stride=(10, 16, 16))


@functools.cache
def models():
    params = jax.jit(lambda key: jclip.init_ctclip(key, SUITE_CLIP))(jax.random.PRNGKey(1))
    return params, convert.from_jax_params(jax.tree.map(np.asarray, params),
                                           port_config(SUITE_CLIP), device="cpu")


def _samples():
    rng = np.random.default_rng(31)
    out = []
    for i, text in enumerate(("Emphysema and a nodule.", "Mild cardiomegaly, no effusion.")):
        labels = np.zeros(18, np.float32)
        labels[[7, 9] if i == 0 else [2]] = 1
        out.append((rng.standard_normal((1, 20, 32, 32)).astype(np.float32), text, labels,
                    f"scan_{i}", f"/data/scan_{i}.nii.gz"))
    return out


def _diff_embeds():
    rng = np.random.default_rng(32)
    return {p: rng.standard_normal(32).astype(np.float32) for p in ("Emphysema", "Cardiomegaly")}


def _npys(root):
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*.npy"))}


def test_suite_artifacts_match_the_jax_suite(tmp_path):
    params, model = models()
    tok = WordTokenizer(BERT.vocab_size)
    data, diff = _samples(), _diff_embeds()
    jvis = jsuite.Visualizations(jsuite.AttributionContext(
        params=params, cfg=SUITE_CLIP, tokenizer=tok, data=data, diff_embeds=diff,
        text_max_length=TEXT_LEN, render_gifs=False), tmp_path / "jax")
    tvis = tsuite.Visualizations(tsuite.AttributionContext(
        model=model, tokenizer=tok, data=data, diff_embeds=diff, text_max_length=TEXT_LEN,
        render_gifs=False), tmp_path / "port")
    for vis, cfg in ((jvis, jconfig), (tvis, pconfig)):
        occ = cfg.OcclusionConfig(**COARSE)
        vis.visualize(raw_attention_maps=True, attention_rollout=True, grad_cam=True,
                      occlusion={"occ": occ, "prompt": "report"}, not_a_method=True)
        vis.visualize(occlusion={"occ": occ, "use_text_embeds": True, "prompt": "diff"})
    jvis.integrated_gradients_worklist(
        ((jnp.asarray(s[0])[None], jvis._tokenize(s[1]), s[3]) for s in data), steps=6)
    tvis.integrated_gradients_worklist(
        ((img, t, nm) for img, t, _, nm, _ in tvis.prepared()), steps=6)
    want, got = _npys(tmp_path / "jax"), _npys(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * (2 + 2 + 6 + 1 + 1 + 1)
    assert "occlusion/3/scan_0_(10, 16, 16)_(10, 16, 16)_diff_heatmaps.npy" in got
    for rel, path in got.items():
        g, w = np.load(path, allow_pickle=True), np.load(want[rel], allow_pickle=True)
        if g.dtype == object:                        # the text-embeds mode's dict
            g, w = g.item(), w.item()
            assert sorted(g) == sorted(w) and g
            for k in g:
                np.testing.assert_allclose(g[k], w[k], atol=MAP_BAND, rtol=0, err_msg=rel)
        else:
            assert g.shape == w.shape, rel
            np.testing.assert_allclose(g, w, atol=MAP_BAND, rtol=0, err_msg=rel)
    assert set(tvis.timings) == {"raw_attention_maps", "attention_rollout", "grad_cam",
                                 "occlusion"}


def test_suite_is_one_process_on_one_card(tmp_path):
    """A mesh must be a DataMesh; over more than one rank integrated
    gradients are collective, and without a process group their first
    collective (rank 0's sample broadcast) raises."""
    from ct_clip_ut_tpu_torch.parallel.mesh import DataMesh

    _, model = models()
    ctx = tsuite.AttributionContext(model=model, tokenizer=None, data=[], render_gifs=False,
                                    mesh=object())
    with pytest.raises(TypeError, match="DataMesh"):
        tsuite.Visualizations(ctx, tmp_path)
    ctx = dataclasses.replace(ctx, mesh=DataMesh(world=2, rank=1, device=torch.device("cpu")),
                              tokenizer=WordTokenizer(2048),
                              data=[(np.zeros((1, 20, 32, 32), np.float32), "a report",
                                     np.zeros(18), "scan", "path")])
    with pytest.raises(RuntimeError, match="needs a process group"):
        tsuite.Visualizations(ctx, tmp_path).visualize(integrated_gradients=True)
    assert not (tmp_path / "integrated_gradients").exists()
    ctx = dataclasses.replace(ctx, mesh=None, diff_embeds=None)
    vis = tsuite.Visualizations(ctx, tmp_path)
    with pytest.raises(ValueError, match="diff_embeds"):
        vis.occlusion(None, None, np.ones(18), "s", "p", use_text_embeds=True)


# ---- embedding arithmetic ------------------------------------------------------

REPORTS = ["Emphysema in both lungs.", "Clear lungs.", "A lung nodule and emphysema.",
           "Cardiomegaly.", "Normal study, no nodule.", "Small effusion and cardiomegaly."]


def _labels():
    labels = np.zeros((len(REPORTS), 18))
    labels[[0, 2], 7] = 1                   # Emphysema
    labels[2, 9] = 1                        # Lung nodule
    labels[[3, 5], 2] = 1                   # Cardiomegaly
    labels[1, 7] = np.nan                   # a missing label counts for neither side
    labels[:, 17] = 1                       # no negative: left out
    return labels


def test_diff_embeddings_match_jax_and_cross_load(tmp_path):
    params, model = models()
    tok = WordTokenizer(BERT.vocab_size)
    labels = _labels()
    got = tea.compute_diff_embeddings(model, tok, REPORTS, labels, batch_size=4,
                                      max_length=TEXT_LEN)
    want = jea.compute_diff_embeddings(params, SUITE_CLIP, tok, REPORTS, labels, batch_size=4,
                                       max_length=TEXT_LEN)
    assert sorted(got) == sorted(want) == ["Cardiomegaly", "Emphysema", "Lung nodule"]
    for k in got:
        assert got[k].shape == (32,)
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    tea.save_diff_embeddings(got, tmp_path / "a" / "port.npy")
    jea.save_diff_embeddings(want, tmp_path / "jax.npy")
    for path, ref in ((tmp_path / "a" / "port.npy", got), (tmp_path / "jax.npy", want)):
        for load in (tea.load_diff_embeddings, jea.load_diff_embeddings):
            back = load(path)
            assert sorted(back) == sorted(ref)
            assert all(np.array_equal(back[k], ref[k]) for k in ref)


def _write_corpus(d):
    names = [f"v{i}.nii.gz" for i in range(len(REPORTS))]
    pd.DataFrame({
        "VolumeName": names + ["v9.nii.gz"],
        "Findings_EN": [REPORTS[0], float("nan"), REPORTS[2], "NA", REPORTS[4], REPORTS[5], "x"],
        "Impressions_EN": ["No change.", REPORTS[1], float("nan"), REPORTS[3], "", " ok", "y"],
    }).to_csv(d / "reports.csv", index=False)
    labels = pd.DataFrame(_labels()[[0, 1, 2, 3, 5, 5]], columns=list(PATHS))
    labels.insert(0, "VolumeName", names[:4] + [names[5], names[5]])   # v4 unlabelled, v5 twice
    labels.to_csv(d / "labels.csv", index=False)


def test_script_reads_the_corpus_as_pandas_does(tmp_path):
    _write_corpus(tmp_path)
    texts, labels = escript.read_corpus(tmp_path / "reports.csv", tmp_path / "labels.csv")
    # the JAX script's reading (scripts/embedding_arithmetic.py:50-57)
    merged = pd.read_csv(tmp_path / "reports.csv").merge(pd.read_csv(tmp_path / "labels.csv"),
                                                         on="VolumeName")
    want = [(str(r) if not pd.isna(r) else "") + (str(i) if not pd.isna(i) else "")
            for r, i in zip(merged.get("Findings_EN", ""), merged.get("Impressions_EN", ""))]
    assert texts == want and len(texts) == 6
    np.testing.assert_array_equal(labels, merged[list(PATHS)].values.astype(np.float64))


def test_script_writes_the_diff_embeddings(tmp_path):
    _, model = models()
    _write_corpus(tmp_path)
    torch.save(model.state_dict(), tmp_path / "ctclip.pt")
    out = tmp_path / "res" / "diff.npy"
    argv = ["--reports", str(tmp_path / "reports.csv"), "--labels", str(tmp_path / "labels.csv"),
            "--checkpoint", str(tmp_path / "ctclip.pt"), "--out", str(out), "--batch-size", "4",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="--stand-in-tokenizer"):
        escript.main(argv, model_cfg=port_config(SUITE_CLIP))
    embeds = escript.main(argv + ["--stand-in-tokenizer"], model_cfg=port_config(SUITE_CLIP))
    texts, labels = escript.read_corpus(tmp_path / "reports.csv", tmp_path / "labels.csv")
    want = tea.compute_diff_embeddings(model, WordTokenizer(BERT.vocab_size), texts, labels,
                                       batch_size=4)
    back = jea.load_diff_embeddings(out)
    assert sorted(back) == sorted(want) == sorted(embeds)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    # --tokenizer DIR: the reports through DIR/vocab.txt's WordPiece tokenizer
    from ct_clip_ut_tpu_torch.data.tokenizer import BertWordPiece
    from test_torch_port_train_cli import write_vocab
    vocab = write_vocab(tmp_path / "tok", sorted({w.strip(".,").lower() for t in texts
                                                 for w in t.split()}))
    embeds = escript.main(argv + ["--tokenizer", str(vocab)], model_cfg=port_config(SUITE_CLIP))
    want = tea.compute_diff_embeddings(model, BertWordPiece.from_dir(vocab), texts, labels,
                                       batch_size=4)
    assert sorted(embeds) == sorted(want)
    assert all(np.array_equal(embeds[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        escript.main(["--reports", "r", "--labels", "l", "--tokenizer", "t", "--device", "cpu"])


# ---- the CLI -------------------------------------------------------------------

def test_cli_runs_zero_shot_and_every_method(fake_dataset_dir, tmp_path, monkeypatch):
    d = fake_dataset_dir
    renders = []
    for fn in ("visualize_overlay", "visualize_attention_grid_gif",
               "visualize_pathology_heatmaps"):
        monkeypatch.setattr(tsuite.viz, fn,
                            lambda *a, _fn=fn, **k: renders.append((_fn, a[2] if _fn ==
                                                                    "visualize_pathology_heatmaps"
                                                                    else a[-1])))
    coarse = pconfig.OcclusionConfig(**COARSE)
    monkeypatch.setattr(tsuite.Visualizations.occlusion, "__defaults__", (coarse, False, ""))
    diff = tmp_path / "diff.npy"
    tea.save_diff_embeddings({PATHS[0]: np.ones(TINY_CLIP.dim_text, np.float32)}, diff)
    out = tmp_path / "results"
    argv = ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata", str(d / "metadata.csv"),
            "--results-folder", str(out), "--zero-shot", "--num-valid-samples", "1",
            "--num-workers", "1", "--device", "cpu", "--visualize", "raw_attention_maps",
            "attention_rollout", "integrated_gradients", "grad_cam", "occlusion",
            "--diff-embeds", str(diff), "--occlusion-text-embeds", "--occlusion-prompt", "t"]
    metrics, preds, _ = cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert (out / "metrics.txt").read_text().startswith("Epoch 0 Metrics:")
    assert preds.shape == (1, 18)
    scan = "valid_0_a_1"
    npys = sorted(str(p.relative_to(out)) for p in out.rglob("*.npy"))
    assert npys == sorted(
        [f"raw_attention_grids/1/{scan}_{k}.npy" for k in ("spatial", "temporal")]
        + [f"attention_rollout/1/{scan}_{k}.npy" for k in ("spatial", "temporal")]
        + [f"integrated_gradients/1/{scan}.npy"]
        + [f"grad_cam/1/{scan}_{k}.npy" for k in ("spatial", "temporal", "spatial_ff",
                                                  "temporal_ff", "combined", "vq")]
        + [f"occlusion/1/{scan}_{coarse.patch_size}_{coarse.stride}_t_heatmaps.npy"])
    assert [n for n, _ in renders].count("visualize_attention_grid_gif") == 2
    assert [n for n, _ in renders].count("visualize_overlay") == 2 + 1 + 6 + 1
    assert renders[-1][0] == "visualize_pathology_heatmaps"
    heat = np.load(out / npys[-3], allow_pickle=True).item()
    assert list(heat) == [PATHS[0]] and heat[PATHS[0]].shape == (20, 32, 32)


def test_cli_visualize_without_matplotlib(fake_dataset_dir, tmp_path, monkeypatch):
    """--visualize raises ImportError naming matplotlib before the model
    loads (a missing --checkpoint would raise otherwise); with --no-gifs it
    writes the maps and imports no renderer."""
    import sys

    d = fake_dataset_dir
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata", str(d / "metadata.csv"),
            "--results-folder", str(tmp_path), "--num-valid-samples", "1", "--device", "cpu",
            "--visualize", "raw_attention_maps"]
    with pytest.raises(ImportError, match="needs matplotlib"):
        cli.main(argv + ["--checkpoint", str(tmp_path / "missing.pt")], model_cfg=TINY_CLIP,
                 preprocess_cfg=CFG)
    assert cli.main(argv + ["--no-gifs"], model_cfg=TINY_CLIP, preprocess_cfg=CFG) is None
    assert sorted(p.name for p in tmp_path.rglob("*.npy")) == [
        "valid_0_a_1_spatial.npy", "valid_0_a_1_temporal.npy"]
    assert not list(tmp_path.rglob("*.gif"))
