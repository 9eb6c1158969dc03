"""The port's data pipeline (ct_clip_ut_tpu_torch/data/) and zero-shot CLI
(scripts/inference_ctclip.py) against the JAX package's, on the CPU.

The pipeline: NIfTI files written by either package read back equal by
both; the torch preprocessing chain (F.interpolate trilinear) within 1e-5
of the JAX chain (the JAX package's native C++ chain switched off: it is
not ported); `InferenceDataset` / `TrainDataset` (CSVs read with the csv
module) give the JAX datasets' samples, texts, labels and images on a fake
CT-RATE directory whose CSVs pandas writes (pandas serves the JAX side
only); `ShardedSampler` indices and the loader's batches equal; the .npy
cache is shared (same file names) and served without re-processing.

The CLI: the JAX parser's flags and refusals (tests/test_cli.py:40-98), the
features left for later raising with their ROADMAP items after those
refusals, and `main` on a tiny configuration writing metrics.txt with and
without --quantize-ff.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import ct_clip_ut_tpu.native
from ct_clip_ut_tpu.config import PreprocessConfig as JaxPreprocessConfig
from ct_clip_ut_tpu.data import datasets as jdatasets
from ct_clip_ut_tpu.data import loader as jloader
from ct_clip_ut_tpu.data import nifti as jnifti
from ct_clip_ut_tpu.data import preprocess as jpre
from ct_clip_ut_tpu_torch.config import BertConfig, PreprocessConfig
from ct_clip_ut_tpu_torch.data import datasets as tdatasets
from ct_clip_ut_tpu_torch.data import loader as tloader
from ct_clip_ut_tpu_torch.data import nifti as tnifti
from ct_clip_ut_tpu_torch.data import preprocess as tpre
from ct_clip_ut_tpu_torch.scripts import inference_ctclip as cli

from test_torch_port_modules import PORT_CLIP, SMALL_VIT_CONV, port_config

CFG = PreprocessConfig(target_shape_hwd=(32, 32, 20))
JCFG = JaxPreprocessConfig(target_shape_hwd=(32, 32, 20))


@pytest.fixture
def jax_chain(monkeypatch):
    """The JAX package's datasets on its JAX chain, not its native one."""
    monkeypatch.setattr(ct_clip_ut_tpu.native, "available", lambda: False)


def test_preprocess_config_mirrors_jax():
    assert dataclasses.asdict(PreprocessConfig()) == dataclasses.asdict(JaxPreprocessConfig())
    assert str(CFG) == str(JCFG)            # the cache digest's input


def test_nifti_round_trips_between_the_packages(tmp_path):
    vol = np.random.default_rng(0).standard_normal((7, 9, 5)).astype(np.float32)
    for name, write, read in (("a.nii", tnifti.write_nii, jnifti.read_nii),
                              ("b.nii.gz", jnifti.write_nii, tnifti.read_nii),
                              ("c.nii.gz", tnifti.write_nii, tnifti.read_nii)):
        write(tmp_path / name, vol, pixdim=(0.5, 0.5, 2.0))
        back = read(tmp_path / name)
        assert back.dtype == np.float64 and back.shape == vol.shape
        np.testing.assert_array_equal(back, vol)
        np.testing.assert_array_equal(back, jnifti.read_nii(tmp_path / name))
    (tmp_path / "bad.nii").write_bytes(b"\0" * 400)
    assert tnifti.read_nii_data(tmp_path / "bad.nii") is None


@pytest.mark.parametrize("shape,new", [((13, 17, 11), (20, 9, 23)), ((8, 8, 8), (8, 5, 8)),
                                       ((6, 10, 4), (6, 10, 4))])
def test_resize_trilinear_matches_jax(shape, new):
    vol = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 1000
    want = np.asarray(jpre.resize_trilinear(vol, new))
    got = tpre.resize_trilinear(torch.from_numpy(vol), new)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * 1000, rtol=0)


def test_crop_and_pad_matches_jax():
    vol = np.random.default_rng(2).standard_normal((10, 6, 9)).astype(np.float32)
    for target in ((6, 12, 9), (10, 3, 14), (4, 6, 2)):
        want = np.asarray(jpre.crop_and_pad(vol, target, pad_value=-1.0))
        got = tpre.crop_and_pad(torch.from_numpy(vol), target, pad_value=-1.0)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model_type", ["ctclip", "ctgenerate"])
def test_process_volume_matches_jax(model_type):
    raw = np.random.default_rng(3).integers(-50, 3000, (40, 40, 12)).astype(np.float32)
    cfg = dataclasses.replace(CFG, ctgenerate_shape=(11, 16, 16))
    jcfg = dataclasses.replace(JCFG, ctgenerate_shape=(11, 16, 16))
    want = jpre.process_volume(raw, 1.0, -1024.0, 2.0, 0.6, model_type, jcfg)
    got = tpre.process_volume(raw, 1.0, -1024.0, 2.0, 0.6, model_type, cfg)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == ((1, 20, 32, 32) if model_type == "ctclip" else (1, 11, 16, 16))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_process_file_native_chain_raises(fake_dataset_dir):
    d = fake_dataset_dir
    meta = tdatasets.load_metadata(d / "metadata.csv")
    path, name = d / "volumes" / "sub" / NAMES[0], NAMES[0]
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tpre.process_file(path, name, meta, use_native=True)
    assert tpre.process_file(path, name, meta, cfg=CFG).shape == (1, 20, 32, 32)
    assert tpre.process_file(path, "unknown.nii.gz", meta, cfg=CFG) is None


NAMES = [f"valid_{i}_a_1.nii.gz" for i in range(5)]


@pytest.fixture
def fake_dataset_dir(tmp_path):
    """Five small raw CT grids [40, 40, 12] that the chain resamples and
    pads to [1, 20, 32, 32], with reports (one field empty, one "NA", one
    with quotes and parentheses), 18 labels (one missing) and metadata
    written by pandas; the reports list a volume that has no file."""
    data = tmp_path / "volumes" / "sub"
    data.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for name in NAMES:
        jnifti.write_nii(data / name, rng.integers(0, 2000, (40, 40, 12)).astype(np.float32))
    pd.DataFrame({
        "VolumeName": NAMES + ["valid_9_a_1.nii.gz"],
        "Findings_EN": ["lungs are clear", float("nan"), "noted (mild) 'opacity'", "NA",
                        "small nodule", "x"],
        "Impressions_EN": ["no issue", "effusion present", float("nan"), " ok ", "\"none\"",
                           "y"],
    }).to_csv(tmp_path / "reports.csv", index=False)
    pd.DataFrame({
        "VolumeName": NAMES,
        "RescaleSlope": [1, 1, 1, 2, 1],
        "RescaleIntercept": [-1024, -1024, -1000, -1024, -1024],
        "XYSpacing": ["[0.6, 0.6]"] * 5,
        "ZSpacing": [2.0, 2.0, 1.5, 2.0, 2.0],
    }).to_csv(tmp_path / "metadata.csv", index=False)
    labels = pd.DataFrame(np.eye(5, 18), columns=[f"p{i}" for i in range(18)])
    labels.iloc[2, 3] = np.nan
    labels.insert(0, "VolumeName", NAMES)
    labels.to_csv(tmp_path / "labels.csv", index=False)
    return tmp_path


def _datasets(d, cache=None):
    args = (d / "volumes", d / "reports.csv", d / "metadata.csv", d / "labels.csv")
    return (jdatasets.InferenceDataset(*args, num_samples=10, preprocess_cfg=JCFG,
                                       cache_dir=cache),
            tdatasets.InferenceDataset(*args, num_samples=10, preprocess_cfg=CFG,
                                       cache_dir=cache))


def test_inference_dataset_matches_jax(fake_dataset_dir, jax_chain):
    jds, tds = _datasets(fake_dataset_dir)
    assert len(tds) == len(jds) == 5
    for i in range(5):
        (jimg, jtext, jlab, jname, jpath), (img, text, lab, name, path) = jds[i], tds[i]
        assert (text, name, str(path)) == (jtext, jname, str(jpath))
        np.testing.assert_array_equal(lab, jlab)
        assert img.dtype == np.float32 and img.shape == jimg.shape == (1, 20, 32, 32)
        np.testing.assert_allclose(img, jimg, atol=1e-5, rtol=0)
    assert tds[1][1] == "effusion present" and tds[3][1] == "ok"     # NaN and "NA" read ""
    assert np.isnan(tds[2][2][3])
    short = tdatasets.InferenceDataset(fake_dataset_dir / "volumes",
                                       *(fake_dataset_dir / f for f in
                                         ("reports.csv", "metadata.csv", "labels.csv")),
                                       num_samples=2, preprocess_cfg=CFG)
    assert [s[3] for s in short.samples] == NAMES[:2]


def test_train_dataset_matches_jax(fake_dataset_dir, jax_chain):
    d = fake_dataset_dir
    args = (d / "volumes", d / "reports.csv", d / "metadata.csv")
    jds = jdatasets.TrainDataset(*args, num_samples=4, preprocess_cfg=JCFG)
    tds = tdatasets.TrainDataset(*args, num_samples=4, preprocess_cfg=CFG)
    assert tds.samples == jds.samples and len(tds) == 4
    for i in (0, 2):
        (jimg, jtext), (img, text) = jds[i], tds[i]
        assert text == jtext
        np.testing.assert_allclose(img, jimg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,shards,shuffle,drop_last", [(5, 2, True, True), (5, 2, False, False),
                                                        (7, 3, True, False), (4, 1, False, True)])
def test_sharded_sampler_matches_jax(n, shards, shuffle, drop_last):
    for index in range(shards):
        kw = dict(num_shards=shards, shard_index=index, shuffle=shuffle, drop_last=drop_last,
                  seed=3)
        j, t = jloader.ShardedSampler(n, **kw), tloader.ShardedSampler(n, **kw)
        j.set_epoch(2)
        t.set_epoch(2)
        assert t.indices() == j.indices()


def test_loader_batches_match_jax(fake_dataset_dir, jax_chain):
    jds, tds = _datasets(fake_dataset_dir)
    kw = dict(batch_size=2, num_workers=3, drop_last=False)
    jb = list(jloader.DataLoader(jds, sampler=jloader.ShardedSampler(5, shuffle=False,
                                                                     drop_last=False), **kw))
    tl = tloader.DataLoader(tds, sampler=tloader.ShardedSampler(5, shuffle=False,
                                                                drop_last=False), **kw)
    tb = list(tl)
    assert len(tb) == len(jb) == len(tl) == 3
    for t, j in zip(tb, jb):
        np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=0)
        assert t[1:2] + t[3:] == j[1:2] + j[3:] and isinstance(t[1], list)
        np.testing.assert_array_equal(t[2], j[2])
    resumed = list(tl.iter_from(1))
    assert [b[3] for b in resumed] == [b[3] for b in tb[1:]]


def test_npy_cache_is_shared_with_jax(fake_dataset_dir, tmp_path, jax_chain, monkeypatch):
    """The port writes the JAX package's cache files (same names), a second
    read comes from the cache, and another config gets its own entry."""
    cache = tmp_path / "ppcache"
    _, tds = _datasets(fake_dataset_dir, str(cache))
    img0 = tds[0][0]
    entries = sorted(p.name for p in cache.glob("*.npy"))
    assert len(entries) == 1 and entries[0].startswith("valid_0_a_1.")
    jcache = tmp_path / "jcache"
    jds, _ = _datasets(fake_dataset_dir, str(jcache))
    jds[0]
    assert sorted(p.name for p in jcache.glob("*.npy")) == entries
    monkeypatch.setattr(tdatasets, "process_file",
                        lambda *a, **k: pytest.fail("re-processed a cached volume"))
    np.testing.assert_array_equal(tds[0][0], img0)
    monkeypatch.undo()
    other = tdatasets.TrainDataset(fake_dataset_dir / "volumes", fake_dataset_dir / "reports.csv",
                                   fake_dataset_dir / "metadata.csv", preprocess_cfg=dataclasses.replace(
                                       CFG, target_shape_hwd=(16, 16, 8)), cache_dir=str(cache))
    assert other[0][0].shape == (1, 8, 16, 16)
    assert len(list(cache.glob("valid_0_a_1.*.npy"))) == 2


BASE = ["--data-valid", "/d/v", "--valid-reports", "v.csv", "--valid-labels", "l.csv",
        "--valid-metadata", "m.csv"]


def test_inference_parser_matches_jax_flags():
    args = cli.build_parser().parse_args(BASE + ["--checkpoint", "ck.pt", "--zero-shot",
                                                 "--visualize", "occlusion", "grad_cam"])
    assert args.zero_shot and args.visualize == ["occlusion", "grad_cam"]
    assert not args.occlusion_text_embeds and args.checkpoint == "ck.pt"
    args = cli.build_parser().parse_args(BASE + ["--visualize", "occlusion",
                                                 "--occlusion-text-embeds", "--occlusion-prompt",
                                                 "panel", "--diff-embeds", "diff.npy",
                                                 "--mesh-data", "4", "--mesh-model", "2"])
    assert args.occlusion_text_embeds and args.occlusion_prompt == "panel"
    assert args.mesh_data == 4 and args.mesh_model == 2
    args = cli.build_parser().parse_args(BASE)
    assert args.mesh_data is None and args.mesh_model == 1 and not args.multihost
    assert args.num_processes is None and not args.quantize_ff and args.checkpoint is None
    assert (args.batch_size, args.num_workers, args.num_valid_samples) == (1, 4, 10)
    assert args.results_folder == "./results/valid/ctclip" and args.device == "cuda"
    assert cli.build_parser().parse_args(BASE + ["--zero-shot", "--quantize-ff"]).quantize_ff
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(BASE + ["--visualize", "not_a_method"])


@pytest.mark.parametrize("extra", [["--quantize-ff", "--visualize", "grad_cam"],
                                   ["--quantize-ff", "--visualize", "integrated_gradients",
                                    "occlusion"],
                                   ["--occlusion-text-embeds", "--diff-embeds", "d.npy"],
                                   ["--occlusion-text-embeds", "--visualize", "occlusion"]])
def test_inference_cli_refusals(extra):
    """The JAX script's parser.error refusals, before any other check."""
    with pytest.raises(SystemExit):
        cli.main(BASE + extra)


@pytest.mark.parametrize("extra,item", [(["--tokenizer", "tok/"], "vocab.txt"),
                                        (["--mesh-model", "2", "--mesh-data", "1"],
                                         "item 11c"),
                                        (["--quantize-ff", "--visualize", "grad_cam",
                                          "raw_attention_maps"], None),
                                        (["--multihost", "--num-processes", "2"], "address"),
                                        (["--mesh-data", "2"], "needs 2 processes"),
                                        (["--mesh-model", "2"], "item 11c")])
def test_inference_cli_unported_features_raise(extra, item):
    """Each raises with its ROADMAP item after the parser's refusals (the
    third, a gradient method with --quantize-ff, is the parser's own); a
    process group without its address, and a data axis wider than the
    processes, raise ValueError; a --tokenizer directory without vocab.txt
    raises FileNotFoundError naming it (the tokenizer itself:
    test_inference_cli_zero_shot_with_a_wordpiece_vocab). --quantize-ff with
    the forward methods runs (tests/test_torch_port_int8_f32.py)."""
    if item is None:
        with pytest.raises(SystemExit):
            cli.main(BASE + ["--zero-shot", "--device", "cpu"] + extra)
        return
    if not item.startswith("item"):
        with pytest.raises(FileNotFoundError if item == "vocab.txt" else ValueError, match=item):
            cli.main(BASE + ["--zero-shot", "--device", "cpu"] + extra)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue [12] {item}"):
        cli.main(BASE + ["--zero-shot", "--device", "cpu"] + extra)


TINY_CLIP = dataclasses.replace(
    PORT_CLIP, ctvit=port_config(SMALL_VIT_CONV),
    bert=BertConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=4,
                    intermediate_size=64, max_position_embeddings=512))


@pytest.mark.parametrize("quantize", [False, True])
def test_inference_cli_zero_shot_writes_metrics(fake_dataset_dir, tmp_path, quantize):
    d = fake_dataset_dir
    out = tmp_path / "results"
    argv = ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata", str(d / "metadata.csv"),
            "--results-folder", str(out), "--zero-shot", "--batch-size", "2",
            "--num-workers", "2", "--device", "cpu"] + (["--quantize-ff"] if quantize else [])
    metrics, preds, targets = cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert preds.shape == targets.shape == (5, 18) and np.isfinite(preds).all()
    assert ((preds >= 0) & (preds <= 1)).all()
    report = (out / "metrics.txt").read_text()
    assert report.startswith("Epoch 0 Metrics:") and "mean_roc_auc" in metrics
    if quantize:
        plain = cli.main([a for a in argv if a != "--quantize-ff"], model_cfg=TINY_CLIP,
                         preprocess_cfg=CFG)[1]
        assert not np.array_equal(plain, preds) and np.abs(plain - preds).max() < 0.05


def test_inference_cli_zero_shot_with_a_wordpiece_vocab(fake_dataset_dir, tmp_path):
    """--tokenizer DIR: the prompts tokenised by DIR/vocab.txt's WordPiece
    tokenizer (data/tokenizer.py) score the volumes; the stand-in
    tokenizer's ids give other probabilities. Weights from --checkpoint
    without --tokenizer raise unless --stand-in-tokenizer asks for the
    stand-in, which then scores as the same weights from --seed."""
    from test_torch_port_train_cli import write_vocab

    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip

    d = fake_dataset_dir
    argv = ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata", str(d / "metadata.csv"),
            "--results-folder", str(tmp_path / "results"), "--zero-shot", "--batch-size", "2",
            "--num-workers", "2", "--device", "cpu"]
    vocab = write_vocab(tmp_path / "tok", ("there", "is", "no", *_pathology_words()))
    _, preds, _ = cli.main(argv + ["--tokenizer", str(vocab)], model_cfg=TINY_CLIP,
                           preprocess_cfg=CFG)
    _, stand_in, _ = cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    assert preds.shape == (5, 18) and np.isfinite(preds).all()
    assert not np.array_equal(preds, stand_in)
    torch.save(init_ctclip(TINY_CLIP, seed=0, device="cpu").state_dict(), tmp_path / "ck.pt")
    argv += ["--checkpoint", str(tmp_path / "ck.pt")]
    with pytest.raises(ValueError, match="--stand-in-tokenizer"):
        cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG)
    _, again, _ = cli.main(argv + ["--stand-in-tokenizer"], model_cfg=TINY_CLIP,
                           preprocess_cfg=CFG)
    np.testing.assert_array_equal(again, stand_in)


def _pathology_words():
    from ct_clip_ut_tpu_torch.config import PATHOLOGIES
    return sorted({w.lower() for p in PATHOLOGIES for w in p.split()})
