"""The port's W8A8 FF (ct_clip_ut_tpu_torch/ops/{quant,geglu_ff_int8}.py)
against the JAX package's (ops/quant.py, ops/pallas_ff_int8.py), on the CPU.

`quantize_weight_int8` gives the JAX codes (transposed: per output row of
the nn.Linear layout) and scales bit for bit. `geglu_ff_int8_plain` is held
against `xla_int8_reference` and the Pallas kernel in interpret mode at
atol = rtol = 1e-4 (tests/test_quant.py:47-54), fp32 and bf16 x, residual
off and on. The port's GELU takes torch.erf where the JAX package takes the
A&S polynomial (max error 1.5e-7), and LN sums run in another order, so a
quantised code may land on the other side of a .5 boundary: the check
counts those flips in xn's and h's codes, allows them in at most a few
rows, and bounds the entries of such a row by one LSB of h's row scale
(through the output weights) per flipped h code plus one for the scale's
own drift. The quantised CT-CLIP (SMALL_CLIP) is held against the JAX
quantised tree (latents 1e-5, equal codebook ids), the converter against
quantisation in the port (bit for bit), and the spatial stack's
continuous error against tests/test_quant.py:125's bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import TransformerConfig
from ct_clip_ut_tpu.models import ctclip as jctclip
from ct_clip_ut_tpu.ops import pallas_ff_int8 as jint8
from ct_clip_ut_tpu.ops import quant as jquant
from ct_clip_ut_tpu.ops import transformer as jtransformer
from ct_clip_ut_tpu_torch import _build, convert
from ct_clip_ut_tpu_torch.models import ctclip as tctclip
from ct_clip_ut_tpu_torch.ops import geglu_ff_int8 as tint8
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops import layers as tlayers
from ct_clip_ut_tpu_torch.ops import quant as tquant
from ct_clip_ut_tpu_torch.ops.transformer import Transformer, transformer

from test_torch_port_modules import (DEPTH, IMG, PORT_CLIP, SMALL_CLIP, jax_and_port_models,
                                     port_config)

TOL = 1e-4
MAX_FLIP_ROW_SHARE = 0.05


def _ff_arrays(rng, dim=64, inner=42, n=100):
    """numpy FF weights in the JAX layouts (w_in [dim, 2*inner], w_out
    [inner, dim]), LN params away from the init, and x [n, dim]."""
    f = np.float32
    return dict(x=rng.standard_normal((n, dim)).astype(f),
                gamma=(1.0 + 0.2 * rng.standard_normal(dim)).astype(f),
                beta=(0.1 * rng.standard_normal(dim)).astype(f),
                w_in=(rng.standard_normal((dim, 2 * inner)) / np.sqrt(dim)).astype(f),
                w_out=(rng.standard_normal((inner, dim)) / np.sqrt(inner)).astype(f))


def _quantized(a):
    """(JAX quantised FF dict, the port's Int8FeedForward) of the same weights."""
    jff = jquant.quantize_ff_params({"norm": {"gamma": jnp.asarray(a["gamma"]),
                                              "beta": jnp.asarray(a["beta"])},
                                     "proj_in": {"w": jnp.asarray(a["w_in"])},
                                     "proj_out": {"w": jnp.asarray(a["w_out"])}})
    dim, inner = a["w_out"].shape[1], a["w_out"].shape[0]
    ff = tlayers.FeedForward(dim, inner)
    with torch.no_grad():
        ff[0].weight.copy_(torch.from_numpy(a["gamma"]))
        ff[0].bias.copy_(torch.from_numpy(a["beta"]))
        ff[1].weight.copy_(torch.from_numpy(a["w_in"].T.copy()))
        ff[4].weight.copy_(torch.from_numpy(a["w_out"].T.copy()))
    return jff, tquant.quantize_ff_params(ff)


def _jax_args(q):
    return (q["norm"]["gamma"], q["norm"]["beta"], q["wv_q"], q["wg_q"], q["w2_q"],
            q["sv"], q["sg"], q["s2"])


def _port_args(ff):
    return (ff.gamma, ff.beta, ff.wv_q, ff.wg_q, ff.w2_q, ff.sv, ff.sg, ff.s2)


def _jax_codes(x, q):
    """xla_int8_reference's quantised codes of xn and h, step by step."""
    gamma, beta, wvq, wgq, w2q, sv, sg, s2 = _jax_args(q)
    x32 = jnp.asarray(x, jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(x32 * x32, axis=-1, keepdims=True) - mean * mean
    xn = (x32 - mean) * jax.lax.rsqrt(jnp.maximum(var, 0.0) + 1e-5) * gamma + beta
    xi, rx = jint8._row_quant(xn)
    value = jint8._int8_dot(xi, wvq).astype(jnp.float32) * rx * sv
    gate = jint8._int8_dot(xi, wgq).astype(jnp.float32) * rx * sg
    hi, rh = jint8._row_quant(jint8._gelu_exact(gate) * value)
    return np.asarray(xi), np.asarray(hi), np.asarray(rh)[:, 0]


def _port_codes(x, ff):
    """geglu_ff_int8_plain's quantised codes of xn and h, step by step."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    xn = (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5) * ff.gamma + ff.beta
    xi, rx = tint8.row_quant(xn)
    value = tint8.int8_dot(xi, ff.wv_q).float() * rx * ff.sv
    gate = tint8.int8_dot(xi, ff.wg_q).float() * rx * ff.sg
    hi, _ = tint8.row_quant(0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value)
    return xi.numpy(), hi[:, :ff.inner_dim].numpy()


def assert_int8_close(got, want, x, jff, ff):
    """got (port) and want (JAX) [n, D] within TOL, except in rows where a
    quantised code of xn or h flipped; there each entry is within (flipped
    h codes + 1) LSBs of h's row scale through the output weights."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    jxi, jhi, rh = _jax_codes(x, jff)
    pxi, phi = _port_codes(torch.from_numpy(np.array(x, np.float32)), ff)
    h_flips = (jhi != phi).sum(-1)
    flipped = ((jxi != pxi).sum(-1) + h_flips) > 0
    assert flipped.mean() <= MAX_FLIP_ROW_SHARE, f"codes flipped in {flipped.sum()} rows"
    w2 = np.abs(np.asarray(jff["w2_q"], np.float32)).max(0) * np.asarray(jff["s2"])   # [D]
    lsb = rh[:, None] * w2[None, :] * (h_flips[:, None] + 1)
    err = np.abs(got - want)
    tight = err <= TOL + TOL * np.abs(want)
    assert (tight[~flipped]).all(), f"max err {err[~flipped].max()} outside flipped rows"
    assert (err[flipped] <= lsb[flipped] + TOL).all()


def test_quantize_weight_int8_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 96)) * 0.3).astype(np.float32)     # JAX layout [in, out]
    w[:, 5] = 0.0                                                     # a zero column: clamp
    w[:, 7] = 0.0                                                     # scale 31.75 / 127 = 0.25:
    w[0, 7] = 31.75                                                   # exact .5 ties, rounded
    w[1:13, 7] = 0.25 * (np.arange(12) - 5.5)                         # half to even
    jq, js = jint8.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tquant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_ff_int8_plain_matches_jax(dtype, residual):
    """Against xla_int8_reference and the Pallas kernel in interpret mode
    (n = 100 pads the kernel's 384-row tile)."""
    a = _ff_arrays(np.random.default_rng(1))
    jff, ff = _quantized(a)
    x = jnp.asarray(a["x"]).astype(dtype)
    ref = jax.jit(lambda v: jint8.xla_int8_reference(v, *_jax_args(jff), residual=residual))(x)
    kern = jint8.geglu_ff_int8(x, *_jax_args(jff), True, residual)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tint8.geglu_ff_int8_plain(xt, *_port_args(ff), residual=residual)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    for want in (ref, kern):
        assert_int8_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                          np.asarray(x.astype(jnp.float32)), jff, ff)


def test_padded_inner_width_is_exact():
    """The zero-padded module (42 -> 48) gives bit for bit the output of
    the unpadded codes."""
    a = _ff_arrays(np.random.default_rng(2))
    _, ff = _quantized(a)
    inner = ff.inner_dim
    assert ff.wv_q.shape == (48, 64) and ff.w2_q.shape == (64, 48) and inner == 42
    assert not ff.wv_q[inner:].any() and not ff.w2_q[:, inner:].any() and not ff.sv[inner:].any()
    x = torch.from_numpy(a["x"])
    unpadded = (ff.gamma, ff.beta, ff.wv_q[:inner], ff.wg_q[:inner], ff.w2_q[:, :inner],
                ff.sv[:inner], ff.sg[:inner], ff.s2)
    assert torch.equal(tint8.geglu_ff_int8_plain(x, *_port_args(ff), residual=True),
                       tint8.geglu_ff_int8_plain(x, *unpadded, residual=True))


def test_int8_route_is_serving_only():
    a = _ff_arrays(np.random.default_rng(3))
    _, ff = _quantized(a)
    x = torch.from_numpy(a["x"]).reshape(4, 25, 64).requires_grad_()
    for plain in (False, True):
        with pytest.raises(NotImplementedError, match="serving-only"):
            tlayers.feedforward(ff, x, plain=plain)
    with pytest.raises(NotImplementedError, match="serving-only"):
        tint8.geglu_ff_int8(x.reshape(100, 64), *_port_args(ff))
    with torch.no_grad():
        assert tlayers.feedforward(ff, x).shape == x.shape


def test_feedforward_routes_by_module_type(monkeypatch):
    """An Int8FeedForward takes geglu_ff_int8 (plain=True its plain
    version), a FeedForward the bf16 route; CPU tensors never load the
    library or count a launch."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    a = _ff_arrays(np.random.default_rng(4))
    _, qff = _quantized(a)
    calls, bf16_route = [], tlayers.geglu_ff_grad
    monkeypatch.setattr(tlayers, "geglu_ff_int8",
                        lambda *args, **kw: calls.append("int8") or tint8.geglu_ff_int8(*args, **kw))
    monkeypatch.setattr(tlayers, "geglu_ff_grad",
                        lambda *args, **kw: calls.append("bf16") or bf16_route(*args, **kw))
    x = torch.from_numpy(a["x"]).reshape(4, 25, 64)
    with torch.no_grad():
        got = qff(x, residual=True)
        plain = qff(x, residual=True, plain=True)
        tlayers.FeedForward(64, 42)(x)
    assert calls == ["int8", "bf16"]
    assert torch.equal(got, plain)
    want = tint8.geglu_ff_int8_plain(x.reshape(100, 64), *_port_args(qff), residual=True)
    assert torch.equal(got, want.reshape(x.shape))
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)


def test_quantize_ctclip_ff_matches_jax_and_shares_modules(shared_q):
    """SMALL_CLIP: only the visual FFs change, into new modules; the text
    tower, projections, VQ and attention are the input's objects; the input
    is untouched; the image latents equal JAX's quantised tree's."""
    params, model, qparams, qmodel = shared_q
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert type(qmodel) is type(model) and qmodel is not model
    for name in ("text_transformer", "to_text_latent", "to_visual_latent"):
        assert getattr(qmodel, name) is getattr(model, name)
    assert qmodel.temperature is model.temperature
    qvit, vit = qmodel.visual_transformer, model.visual_transformer
    assert qvit is not vit and qvit.vq is vit.vq and qvit.to_patch_emb is vit.to_patch_emb
    for stack in ("enc_spatial_transformer", "enc_temporal_transformer"):
        for qlayer, layer in zip(getattr(qvit, stack).layers, getattr(vit, stack).layers):
            assert tquant.is_quantized_ff(qlayer[3]) and not tquant.is_quantized_ff(layer[3])
            assert qlayer[1] is layer[1] and qlayer[0] is layer[0]
    after = model.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], before[k]) for k in after)

    img = np.random.default_rng(7).standard_normal((2, 1, DEPTH, IMG, IMG)).astype(np.float32)
    want, wout = jax.jit(lambda p, v: jctclip.encode_image_latents(p, SMALL_CLIP, v))(qparams,
                                                                                      img)
    with torch.no_grad():
        got, gout = tctclip.encode_image_latents(qmodel, torch.from_numpy(img))
    np.testing.assert_array_equal(gout.codebook_ids.numpy(), np.asarray(wout.codebook_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_convert_commutes_with_quantize_ctclip_ff(shared_q):
    """from_jax_params(quantize_ctclip_ff(tree)) == quantize_ctclip_ff(
    from_jax_params(tree)), every buffer bit for bit."""
    params, _, qparams, qmodel = shared_q
    converted = convert.from_jax_params(jax.tree.map(np.asarray, qparams), PORT_CLIP,
                                        device="cpu")
    a, b = converted.state_dict(), qmodel.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    ff = converted.visual_transformer.enc_spatial_transformer.layers[0][3]
    assert isinstance(ff, tlayers.Int8FeedForward) and ff.inner_dim == 42


def test_int8_spatial_stack_continuous_error():
    """Pre-VQ error through a full transformer stack (tests/test_quant.py:125):
    the quantised stack within 2% of the fp stack, and equal to the JAX
    quantised stack's output within 1e-4."""
    jcfg = TransformerConfig(dim=64, depth=3, dim_head=16, heads=4, peg=False)
    p = jtransformer.init_transformer(jax.random.PRNGKey(0), jcfg)
    q = jquant.quantize_transformer_ff(p)
    x = np.array(jax.random.normal(jax.random.PRNGKey(11), (2, 24, 64)))
    want_q = jax.jit(lambda t, v: jtransformer.transformer(t, jcfg, v))(q, x)
    want_q = want_q[0] if isinstance(want_q, tuple) else want_q

    tf = Transformer(port_config(jcfg))
    sd = {}
    convert._transformer(sd, "t", jax.tree.map(np.asarray, p))
    tf.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    qtf = tquant.quantize_transformer_ff(tf)
    with torch.no_grad():
        fp, _ = transformer(tf, torch.from_numpy(x))
        got, _ = transformer(qtf, torch.from_numpy(x))
    rel = float((got - fp).norm() / fp.norm())
    assert 0 < rel < 0.02, rel
    np.testing.assert_allclose(got.numpy(), np.asarray(want_q), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def shared_q():
    params, model = jax_and_port_models()
    return params, model, jquant.quantize_ctclip_ff(params), tquant.quantize_ctclip_ff(model)
