"""CTGenerate's one-scan fp32 route and the GIF renderers, against the
JAX package on the CPU.

`inference_ctgenerate.main --data-valid ... --batch-size 1` over synthetic
NIfTI volumes and CSVs (the reports name some of each volume's positive
pathologies) at tests/test_torch_port_ctgenerate.py's SMALL_GEN (the JAX
init carried across by from_jax_ctgenerate_params, saved as a port state
dict for --checkpoint): each heatmap file against the JAX package's
`ctgenerate_apply` (fp32), `keyword_heatmap` and `rot90_ct` on the same
preprocessed scans and the same stand-in token ids (--stand-in-tokenizer;
the JAX script itself needs HF T5 files), within 1e-5 (fp32 sums in another order); its file
names those of the JAX script's `render`. --batch-size 2 --compute-dtype
float32 against the JAX batched forward in the same band. With --gifs the
overlays are written beside the maps and decode to the frames the JAX
package's `visualize_overlay` renders from the same arrays.

The renderers (utils/visualizations, which imports no JAX in either
package) on the same arrays give the same GIF bytes; `results_subdirectory`
claims 1, 2, 3 ... and skips a taken index; a render without matplotlib
raises ImportError naming it, as does the CLI before its model loads.
"""

import csv
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.attribution.capture import rot90_ct as jrot90
from ct_clip_ut_tpu.models import ctgenerate as jcg
from ct_clip_ut_tpu.models import t5 as jt5
from ct_clip_ut_tpu.utils import visualizations as jviz
from ct_clip_ut_tpu_torch.config import PATHOLOGIES, PreprocessConfig
from ct_clip_ut_tpu_torch.data import datasets as tdatasets
from ct_clip_ut_tpu_torch.data import nifti as tnifti
from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as script
from ct_clip_ut_tpu_torch.utils import visualizations as tviz

from test_torch_port_ctgenerate import SCAN, SMALL_GEN, SMALL_T5, jit, models, port_config

PRE = PreprocessConfig(ctgenerate_shape=SCAN)
VOLUMES = {   # name: (findings, impressions, positive pathologies)
    "valid_1_a_1.nii.gz": ("Emphysema in both upper lobes.", "A lung nodule on the left.",
                           ("Emphysema", "Lung nodule", "Atelectasis")),
    "valid_2_a_1.nii.gz": ("", "Cardiomegaly, no effusion.",
                           ("Cardiomegaly", "Pericardial effusion")),
}


@pytest.fixture(scope="module")
def ctgen_dataset(tmp_path_factory):
    """Two raw CT grids with their reports, 18 labels (PATHOLOGIES columns)
    and metadata; the port model's state dict for --checkpoint."""
    d = tmp_path_factory.mktemp("ctgen")
    (d / "volumes").mkdir()
    rng = np.random.default_rng(21)
    with open(d / "reports.csv", "w", newline="") as fr, \
            open(d / "labels.csv", "w", newline="") as fl, \
            open(d / "metadata.csv", "w", newline="") as fm:
        reports, labels, meta = csv.writer(fr), csv.writer(fl), csv.writer(fm)
        reports.writerow(["VolumeName", "Findings_EN", "Impressions_EN"])
        labels.writerow(["VolumeName", *PATHOLOGIES])
        meta.writerow(["VolumeName", "RescaleSlope", "RescaleIntercept", "XYSpacing",
                       "ZSpacing"])
        for name, (find, imp, pos) in VOLUMES.items():
            tnifti.write_nii(d / "volumes" / name,
                             rng.integers(0, 2000, (40, 40, 12)).astype(np.float32))
            reports.writerow([name, find, imp])
            labels.writerow([name, *(int(p in pos) for p in PATHOLOGIES)])
            meta.writerow([name, 1, -1024, "[0.6, 0.6]", 2.0])
    _, model = models("gen")
    torch.save(model.state_dict(), d / "ctgen.pt")
    return d


def _argv(d, out, *extra):
    return ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata",
            str(d / "metadata.csv"), "--num-valid-samples", "2", "--checkpoint",
            str(d / "ctgen.pt"), "--stand-in-tokenizer", "--results-folder", str(out),
            "--device", "cpu", *extra]


def _jax_heatmaps(d, batched: bool) -> dict:
    """file name -> the JAX package's rotated heatmap of the same scans and
    stand-in token ids."""
    params, _ = models("gen")
    ds = tdatasets.InferenceDataset(d / "volumes", d / "reports.csv", d / "metadata.csv",
                                    d / "labels.csv", num_samples=2, model_type="ctgenerate",
                                    preprocess_cfg=PRE)
    cond = jt5.T5TextConditioner(params["t5"], SMALL_T5, WordTokenizer(SMALL_T5.vocab_size))
    samples = [ds[i] for i in range(len(ds))]
    want = {}
    if batched:
        emb, mask = cond.encode([s[1] for s in samples])
        out = jcg.ctgenerate_apply_batched(params, SMALL_GEN,
                                           jnp.asarray(np.stack([s[0] for s in samples])),
                                           emb, mask, compute_dtype="float32")
    for i, (image, text, labels, name, _) in enumerate(samples):
        positives = [p for p, v in zip(PATHOLOGIES, labels.tolist()) if v == 1.0]
        if batched:
            crosses = {p: np.asarray(out.cross_attention)[i:i + 1][..., idx]
                       for p, idx in cond.get_token_indices(positives, index=i).items()}
            grid = out.video_patch_shape
        else:
            emb, mask = cond.encode(text)
            kw = cond.get_token_indices(positives)
            one = jit(jcg.ctgenerate_apply, cfg=SMALL_GEN, keyword_indices=kw)(
                params, jnp.asarray(image)[None], emb, mask)
            crosses, grid = one.kw_attention, one.video_patch_shape
        for p, cross in crosses.items():
            heat = jcg.keyword_heatmap(jnp.asarray(cross), grid, SCAN)
            want[f"ctgenerate_{name}_{p}.npy"] = jrot90(np.asarray(heat))
    return want


@pytest.mark.parametrize("batch", [1, 2])
def test_data_valid_route_matches_jax(ctgen_dataset, tmp_path, batch):
    d = ctgen_dataset
    extra = ["--batch-size", str(batch)] + (["--compute-dtype", "float32"] if batch > 1 else [])
    written = script.main(_argv(d, tmp_path, *extra), model_cfg=port_config(SMALL_GEN),
                          preprocess_cfg=PRE)
    want = _jax_heatmaps(d, batched=batch > 1)
    # the positives whose words the report holds (not Atelectasis, not Pericardial effusion)
    assert sorted(want) == sorted(p.name for p in written) == [
        "ctgenerate_valid_1_a_1_Emphysema.npy", "ctgenerate_valid_1_a_1_Lung nodule.npy",
        "ctgenerate_valid_2_a_1_Cardiomegaly.npy"]
    for name, heat in want.items():
        got = np.load(tmp_path / name)
        assert got.shape == (SCAN[0], SCAN[2], SCAN[1]) and got.dtype == np.float32
        np.testing.assert_allclose(got, heat, atol=1e-5, rtol=0)


def test_one_scan_route_takes_fp32_scans_only():
    _, model = models("gen")
    from ct_clip_ut_tpu_torch.models.t5 import T5TextConditioner
    t5 = T5TextConditioner(model.t5, WordTokenizer(SMALL_T5.vocab_size))
    scan = torch.zeros((1, 1, *SCAN), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="fp32"):
        script.localize_scan(model, t5, scan, "Emphysema.", ["Emphysema"])


def test_gifs_beside_the_maps_render_the_jax_frames(ctgen_dataset, tmp_path):
    d = ctgen_dataset
    written = script.main(_argv(d, tmp_path, "--gifs", "--num-valid-samples", "1"),
                          model_cfg=port_config(SMALL_GEN), preprocess_cfg=PRE)
    assert sorted(p.name for p in written) == sorted(
        f"ctgenerate_valid_1_a_1_{p}{ext}" for p in ("Emphysema", "Lung nodule")
        for ext in (".npy", ".gif"))
    ds = tdatasets.InferenceDataset(d / "volumes", d / "reports.csv", d / "metadata.csv",
                                    d / "labels.csv", num_samples=1, model_type="ctgenerate",
                                    preprocess_cfg=PRE)
    img = jrot90(ds[0][0].squeeze())
    heat = np.load(tmp_path / "ctgenerate_valid_1_a_1_Emphysema.npy")
    jviz.visualize_overlay(img, heat, "valid_1_a_1", "GenerateCT Attention", tmp_path / "j.gif")
    assert (tmp_path / "j.gif").read_bytes() == \
        (tmp_path / "ctgenerate_valid_1_a_1_Emphysema.gif").read_bytes()


# ---- the renderers ---------------------------------------------------------------

def _frames(path):
    from PIL import Image
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return np.stack(out)


@pytest.mark.parametrize("renderer", ["overlay", "overlay_heat_only", "grid", "pathologies"])
def test_renderers_decode_to_the_jax_frames(tmp_path, renderer):
    rs = np.random.RandomState(4)
    image = rs.rand(3, 16, 16).astype(np.float32)
    heat = rs.rand(3, 16, 16).astype(np.float32)
    for mod, name in ((tviz, "t.gif"), (jviz, "j.gif")):
        if renderer == "overlay":
            mod.visualize_overlay(image, heat, "scan", "Method", tmp_path / name, threshold=0.2,
                                  extra_info="info")
        elif renderer == "overlay_heat_only":
            mod.visualize_overlay(image, heat, "scan", "Method", tmp_path / name,
                                  display_flags={"heatmap": True})
        elif renderer == "grid":
            grid = np.stack([np.stack([heat[:, :8, :8] * (i + 1) / 6 for i in range(3)])] * 2)
            mod.visualize_attention_grid_gif(grid, "scan", tmp_path / name)
        else:
            mod.visualize_pathology_heatmaps(image, {"Emphysema": heat, "Other": 1 - heat},
                                             tmp_path / name)
    t, j = _frames(tmp_path / "t.gif"), _frames(tmp_path / "j.gif")
    assert t.shape[0] == 3 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_results_subdirectory_claims_the_next_free_index(tmp_path):
    got = [tviz.results_subdirectory(tmp_path, "grad_cam") for _ in range(2)]
    assert [p.name for p in got] == ["1", "2"]
    (tmp_path / "grad_cam" / "4").mkdir()           # 3 dirs: the next count is 4, taken
    assert tviz.results_subdirectory(tmp_path, "grad_cam").name == "5"
    (tmp_path / "grad_cam" / "note.txt").write_text("")   # files are not counted
    assert tviz.results_subdirectory(tmp_path, "grad_cam").name == "6"
    assert jviz.results_subdirectory(tmp_path, "grad_cam").name == "7"
    np.testing.assert_array_equal(tviz.normalize(np.array([2.0, 4.0, 3.0])), [0.0, 1.0, 0.5])
    np.testing.assert_array_equal(tviz.normalize(np.full(3, 5.0)), np.zeros(3))


def test_a_render_without_matplotlib_raises(monkeypatch, ctgen_dataset, tmp_path):
    import matplotlib
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        tviz.visualize_overlay(np.zeros((2, 4, 4)), np.zeros((2, 4, 4)), "s", "M",
                               tmp_path / "x.gif")
    with pytest.raises(ImportError, match="needs matplotlib"):
        script.main(_argv(ctgen_dataset, tmp_path, "--gifs", "--checkpoint", "missing.pt"),
                    model_cfg=port_config(SMALL_GEN), preprocess_cfg=PRE)
    monkeypatch.setitem(sys.modules, "matplotlib", matplotlib)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs pillow"):
        tviz.require_renderer()
