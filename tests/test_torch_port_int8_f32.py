"""Row 15f: the W8A8 GEGLU FF on fp32 activations, and the forward
attribution methods on a quantised model, against the JAX package on the
CPU.

`geglu_ff_int8_plain` at fp32 x (an odd 77 rows, D = 128, inner 85 padded
to 96), residual off and on, against `xla_int8_reference` and the Pallas
kernel in interpret mode: 1e-4, with .5-boundary code flips counted and
bounded by one LSB of h's row scale (tests/test_torch_port_quant.py's
check). The wrapper on a (stand-in) card tensor: fp32 x reaches the fp32
C entry `ctc_geglu_ff_int8_f32` and its counter, bf16 the bf16 entry,
fp16 is refused, and no plain version runs. On `quantize_ctclip_ff` of
tests/test_torch_port_attribution.py's SMALL_CLIP: every FF call of raw
attention, rollout and occlusion (each of its routes) gets fp32 x
uncast; the maps against JAX's attribution on the JAX quantised tree
within 1e-3, occlusion scores within 1e-5. The CLI runs --quantize-ff
with the three forward methods.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.attribution import occlusion as jocc
from ct_clip_ut_tpu.attribution import raw_attention as jraw
from ct_clip_ut_tpu.attribution import rollout as jroll
from ct_clip_ut_tpu.ops import pallas_ff_int8 as jint8
from ct_clip_ut_tpu.ops import quant as jquant
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.attribution import occlusion, raw_attention, rollout
from ct_clip_ut_tpu_torch.ops import geglu_ff_int8 as tint8
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops import layers as tlayers
from ct_clip_ut_tpu_torch.ops import quant as tquant
from ct_clip_ut_tpu_torch.scripts import inference_ctclip as cli

from test_torch_port_attribution import (GEOMETRIES, MAP_BAND, LATENT_BAND, MODES, SMALL_CLIP,
                                         close, models, occ_pair, prompts, volume)
from test_torch_port_data import CFG, TINY_CLIP, fake_dataset_dir  # noqa: F401  (a fixture)
from test_torch_port_f32_hopper import FakeLib
from test_torch_port_quant import _ff_arrays, _jax_args, _port_args, _quantized, assert_int8_close


# ---- the plain version at fp32 x ------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
def test_geglu_ff_int8_plain_fp32_matches_jax(residual):
    a = _ff_arrays(np.random.default_rng(11), dim=128, inner=85, n=77)
    jff, ff = _quantized(a)
    assert ff.wv_q.shape == (96, 128)
    x = jnp.asarray(a["x"])
    ref = jax.jit(lambda v: jint8.xla_int8_reference(v, *_jax_args(jff), residual=residual))(x)
    kern = jint8.geglu_ff_int8(x, *_jax_args(jff), True, residual)
    got = tint8.geglu_ff_int8_plain(torch.from_numpy(a["x"]), *_port_args(ff), residual=residual)
    assert got.dtype == torch.float32 and got.shape == (77, 128)
    for want in (ref, kern):
        assert_int8_close(got.numpy(), np.asarray(want), a["x"], jff, ff)


# ---- the wrapper's routes on a stand-in card -----------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)

    def refused(*args, **kwargs):
        raise AssertionError("a plain version ran on a card tensor")

    monkeypatch.setattr(tint8, "geglu_ff_int8_plain", refused)
    launches.reset_launch_counts()
    yield lib
    launches.reset_launch_counts()


@pytest.mark.parametrize("residual", [False, True])
def test_fp32_x_takes_the_fp32_entry(fake_card, residual):
    """fp32 x: `ctc_geglu_ff_int8_f32` with (M, D, ldh, residual), an fp32
    out, counted as geglu_ff_int8_f32; bf16 x: the bf16 entry and counter;
    fp16 raises."""
    _, ff = _quantized(_ff_arrays(np.random.default_rng(12), dim=64, inner=42, n=77))
    x = torch.randn(77, 64)
    out = tint8.geglu_ff_int8(x, *_port_args(ff), residual=residual)
    assert out.dtype == torch.float32 and out.shape == x.shape
    out16 = tint8.geglu_ff_int8(x.bfloat16(), *_port_args(ff), residual=residual)
    assert out16.dtype == torch.bfloat16
    assert [c[0] for c in fake_card.calls] == ["ctc_geglu_ff_int8_f32", "ctc_geglu_ff_int8"]
    for name, args in fake_card.calls:
        assert args[-5:-1] == (77, 64, 48, int(residual)), name
    counts = launches.launch_counts()
    assert counts["geglu_ff_int8_f32"] == 1 and counts["geglu_ff_int8"] == 1
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tint8.geglu_ff_int8(x.half(), *_port_args(ff))


# ---- the forward attribution methods on a quantised model -----------------------

@pytest.fixture(scope="module")
def quantized():
    params, model = models()
    return jquant.quantize_ctclip_ff(params), tquant.quantize_ctclip_ff(model)


def test_fp32_x_reaches_the_int8_ff_uncast(quantized, monkeypatch):
    """Raw attention, rollout and occlusion in each route (frame-sparse,
    dense shortcut, full forward) call the W8A8 FF of every layer of the
    quantised model with fp32 x, through the module (`feedforward` routes by
    type), never the dense FF."""
    _, qmodel = quantized
    seen = []

    def recording(x, *args, **kw):
        seen.append(x.dtype)
        return tint8.geglu_ff_int8_plain(x, *args, **kw)

    def no_dense(*args, **kw):
        raise AssertionError("the dense FF ran on a quantised model")

    monkeypatch.setattr(tlayers, "geglu_ff_int8", recording)
    monkeypatch.setattr(tlayers, "geglu_ff_grad", no_dense)
    _, tt = prompts()
    img = torch.from_numpy(volume(20, 1))
    raw_attention.raw_attention_maps(qmodel, tt, img)
    rollout.rollout_maps(qmodel, tt, img)
    _, po = occ_pair(patch_size=(10, 16, 16), stride=(10, 16, 16))
    lat = occlusion.report_text_latent(qmodel, tt)
    coords = occlusion.window_grid((20, 32, 32), po.patch_size, po.stride)
    for shortcut, sparse in MODES.values():
        occlusion.occlusion_scores(qmodel, img, lat, coords, occ=po, chunk=4,
                                   token_shortcut=shortcut, frame_sparse=sparse)
    assert len(seen) > 4 * 4 and set(seen) == {torch.float32}


def test_quantized_raw_attention_and_rollout_match_jax(quantized):
    jq, tq = quantized
    jt, tt = prompts()
    img = volume(20, 1)
    sp, tm = raw_attention.raw_attention_maps_np(tq, tt, torch.from_numpy(img))
    jsp, jtm = jraw.raw_attention_maps_np(jq, SMALL_CLIP, jt, jnp.asarray(img))
    close(sp, jsp, MAP_BAND)
    close(tm, jtm, MAP_BAND)
    for got, want in zip(rollout.rollout_maps(tq, tt, torch.from_numpy(img)),
                         jroll.rollout_maps(jq, SMALL_CLIP, jt, jnp.asarray(img))):
        close(got, want, MAP_BAND)
    # the quantised model's maps are not the dense model's
    params, model = models()
    dense, _ = raw_attention.raw_attention_maps_np(model, tt, torch.from_numpy(img))
    assert np.abs(dense - sp).max() > 1e-4


@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_occlusion_matches_jax(quantized, mode):
    jq, tq = quantized
    jt, tt = prompts()
    depth, patch, stride = GEOMETRIES["20 frames"]
    token_shortcut, frame_sparse = MODES[mode]
    img = volume(depth, 9)
    jo, po = occ_pair(patch_size=patch, stride=stride, threshold=0.0)
    coords = occlusion.window_grid(img.shape[-3:], patch, stride)[::3]
    jl = jocc.report_text_latent(jq, SMALL_CLIP, jt)
    tl = occlusion.report_text_latent(tq, tt)
    close(tl, jl, LATENT_BAND)
    want_o, want = jocc.occlusion_scores(jq, SMALL_CLIP, jnp.asarray(img), jl,
                                         jnp.asarray(coords), occ=jo, chunk=4,
                                         token_shortcut=token_shortcut, frame_sparse=frame_sparse)
    got_o, got = occlusion.occlusion_scores(tq, torch.from_numpy(img), tl, coords, occ=po, chunk=4,
                                            token_shortcut=token_shortcut,
                                            frame_sparse=frame_sparse)
    close(got_o, want_o, LATENT_BAND)
    close(got, want, LATENT_BAND)


# ---- the CLI --------------------------------------------------------------------

def test_cli_quantize_ff_runs_the_forward_methods(fake_dataset_dir, tmp_path, monkeypatch):
    """--quantize-ff with raw attention, rollout and occlusion (a window
    shrunk to this volume) writes their maps, every FF call on fp32 x in
    the attribution pass; the gradient methods stay refused."""
    from ct_clip_ut_tpu_torch.attribution import suite as tsuite
    from ct_clip_ut_tpu_torch.config import OcclusionConfig

    d = fake_dataset_dir
    seen = []

    def recording(x, *args, **kw):
        seen.append(x.dtype)
        return tint8.geglu_ff_int8_plain(x, *args, **kw)

    monkeypatch.setattr(tlayers, "geglu_ff_int8", recording)
    monkeypatch.setattr(tsuite.Visualizations.occlusion, "__defaults__",
                        (OcclusionConfig(patch_size=(10, 16, 16), stride=(10, 16, 16)),
                         False, ""))
    argv = ["--data-valid", str(d / "volumes"), "--valid-reports", str(d / "reports.csv"),
            "--valid-labels", str(d / "labels.csv"), "--valid-metadata", str(d / "metadata.csv"),
            "--results-folder", str(tmp_path), "--num-valid-samples", "1", "--num-workers", "1",
            "--device", "cpu", "--quantize-ff", "--no-gifs", "--visualize",
            "raw_attention_maps", "attention_rollout", "occlusion"]
    assert cli.main(argv, model_cfg=TINY_CLIP, preprocess_cfg=CFG) is None
    scan = "valid_0_a_1"
    assert sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.npy")) == sorted(
        [f"raw_attention_grids/1/{scan}_{k}.npy" for k in ("spatial", "temporal")]
        + [f"attention_rollout/1/{scan}_{k}.npy" for k in ("spatial", "temporal")]
        + [f"occlusion/1/{scan}__heatmap.npy"])
    assert seen and set(seen) == {torch.float32}
    with pytest.raises(SystemExit):
        cli.main(argv + ["grad_cam"], model_cfg=TINY_CLIP, preprocess_cfg=CFG)
