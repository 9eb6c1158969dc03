"""The backward kernels of the training slice, on the CPU
(ct_clip_ut_tpu_torch/ops/{attn_block,attn_packed,geglu_ff,patch_embed}.py).

Each plain backward, and each autograd Function (which takes the plain
versions for CPU tensors), against jax.vjp of the JAX custom-VJP op with
interpret=True: that runs the Pallas `_backward_impl` / `_dkw_impl`
kernels in interpret mode, as tests/test_pallas.py does. Every gradient is
compared, with and without the residual and the bias. Tolerances: fp32
rtol 1e-4 / atol 5e-4 (tests/test_pallas.py's band); bf16 max relative
error 1.5e-2 (the JAX package's bf16 kernel band, bench.py:62-71), each
side rounding at the same points but summing in another order. The card's
checks of the same kernels are in test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_attn_block import attention_block_fused
from ct_clip_ut_tpu.ops.pallas_attn_packed import attention_block_packed
from ct_clip_ut_tpu.ops.pallas_ff import geglu_ff_fused
from ct_clip_ut_tpu.ops.pallas_patch_embed import (_dkw_impl, _forward_res_impl,
                                                   patch_embed_fused as jax_patch_embed)
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attention import _BlockFn
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd, attn_block_bwd_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd, attn_packed_bwd_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_plain, geglu_ff_grad
from ct_clip_ut_tpu_torch.ops.patch_embed import (patch_embed_dkw, patch_embed_dkw_plain,
                                                  patch_embed_grad, patch_embed_res,
                                                  patch_embed_res_plain)

from test_torch_port_cuda import (_attn_inputs, _ff_inputs, _patch_args, _patch_inputs,
                                  _torch_attn_args, _torch_ff_args)
from test_torch_port_kernels import PE_PATCH, PE_SHAPE, PE_TPATCH, _jax_fold

RTOL, ATOL = 1e-4, 5e-4
BF16_BAND = 1.5e-2
ATTN_NAMES = ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks", "bias")


def _close(name, got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got.detach().float()) - want).max() / np.abs(want).max())


def _attn_case(rng, with_bias, dtype=np.float32):
    r, n = (3, 16) if with_bias else (6, 12)
    a = _attn_inputs(rng, r=r, n=n, d=32, heads=4, dh=8, with_bias=with_bias)
    g = rng.standard_normal((r, n, 32)).astype(np.float32)
    return a, g


def _jax_attn_grads(a, g, with_bias, residual, dtype=jnp.float32):
    keys = ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks")
    cast = {"x", "wq", "wk", "wv", "wo"}
    args = [jnp.asarray(a[k]).astype(dtype if k in cast else jnp.float32) for k in keys]
    if with_bias:
        fn = lambda *p: attention_block_fused(*p, 8.0, True, residual)   # noqa: E731
        args.append(jnp.asarray(a["bias"]))
    else:
        fn = lambda *p: attention_block_packed(*p, 8.0, True, residual)  # noqa: E731
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(g).astype(out.dtype))
    return [np.asarray(t, np.float32) for t in grads]


def _port_layout(name, t):
    """The port's (out, in) weight gradients in the JAX (in, out) layout."""
    return t.t() if name in ("wq", "wk", "wv", "wo") else t


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_attention_plain_backward_matches_pallas_kernel(with_bias, residual):
    a, g = _attn_case(np.random.default_rng(20), with_bias)
    want = _jax_attn_grads(a, g, with_bias, residual)
    args = list(_torch_attn_args(a))
    gt = torch.from_numpy(g)
    if with_bias:
        got = attn_block_bwd_plain(*args, torch.from_numpy(a["bias"]), gt, 8.0, residual)
    else:
        got = attn_packed_bwd_plain(*args, gt, 8.0, residual)
    assert len(got) == len(want)
    for name, x, y in zip(ATTN_NAMES, got, want):
        _close(name, _port_layout(name, x), y)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_attention_function_backward_matches_pallas_kernel(with_bias, residual):
    """The autograd Function on CPU tensors: saved tensors, the residual
    path, the gradients' dtypes, and None for inputs that need none (qs and
    ks here)."""
    a, g = _attn_case(np.random.default_rng(21), with_bias)
    want = _jax_attn_grads(a, g, with_bias, residual)
    args = [t.clone().requires_grad_(i not in (6, 7)) for i, t in enumerate(_torch_attn_args(a))]
    bias = torch.from_numpy(a["bias"]).requires_grad_(True) if with_bias else None
    out = _BlockFn.apply(*args, bias, 8.0, residual)
    out.backward(torch.from_numpy(g))
    for i, (name, t) in enumerate(zip(ATTN_NAMES, args)):
        if i in (6, 7):
            assert t.grad is None
            continue
        assert t.grad.dtype == t.dtype
        _close(name, _port_layout(name, t.grad), want[i])
    if with_bias:
        _close("bias", bias.grad, want[8])


def test_attention_function_backward_bf16_within_band_of_pallas_kernel():
    a, g = _attn_case(np.random.default_rng(22), True)
    want = _jax_attn_grads(a, g, True, True, jnp.bfloat16)
    args = list(_torch_attn_args(a))
    for i in (0, 2, 3, 4, 5):
        args[i] = args[i].bfloat16()
    args = [t.requires_grad_(True) for t in args]
    bias = torch.from_numpy(a["bias"]).requires_grad_(True)
    out = _BlockFn.apply(*args, bias, 8.0, True)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).bfloat16())
    for i, (name, t) in enumerate(zip(ATTN_NAMES, args)):
        assert t.grad.dtype == t.dtype
        assert _rel(_port_layout(name, t.grad), want[i]) <= BF16_BAND, name
    assert _rel(bias.grad, want[8]) <= BF16_BAND


def _jax_ff_grads(a, g, residual, dtype=jnp.float32):
    keys = ("x", "gamma", "beta", "wv", "wg", "w2")
    cast = {"x", "wv", "wg", "w2"}
    args = [jnp.asarray(a[k]).astype(dtype if k in cast else jnp.float32) for k in keys]
    out, vjp = jax.vjp(lambda *p: geglu_ff_fused(*p, True, residual), *args)
    dx, dgamma, dbeta, dwv, dwg, dw2 = (np.asarray(t, np.float32)
                                        for t in vjp(jnp.asarray(g).astype(out.dtype)))
    # the port's layouts: w_in [2*inner, D] (value rows, then gate rows), w_out [D, inner]
    return [dx, dgamma, dbeta, np.concatenate([dwv.T, dwg.T]), dw2.T]


@pytest.mark.parametrize("residual", [False, True])
def test_geglu_ff_plain_backward_matches_pallas_kernel(residual):
    rng = np.random.default_rng(23)
    a = _ff_inputs(rng, n=40)
    g = rng.standard_normal(a["x"].shape).astype(np.float32)
    want = _jax_ff_grads(a, g, residual)
    got = geglu_ff_bwd_plain(*_torch_ff_args(a), torch.from_numpy(g), residual)
    for name, x, y in zip(("dx", "dgamma", "dbeta", "dw_in", "dw_out"), got, want):
        _close(name, x, y)


@pytest.mark.parametrize("residual", [False, True])
def test_geglu_ff_function_backward_matches_pallas_kernel(residual):
    rng = np.random.default_rng(24)
    a = _ff_inputs(rng, n=40)
    g = rng.standard_normal(a["x"].shape).astype(np.float32)
    want = _jax_ff_grads(a, g, residual)
    args = [t.clone().requires_grad_(True) for t in _torch_ff_args(a)]
    geglu_ff_grad(*args, residual=residual).backward(torch.from_numpy(g))
    for name, t, y in zip(("dx", "dgamma", "dbeta", "dw_in", "dw_out"), args, want):
        assert t.grad.dtype == t.dtype
        _close(name, t.grad, y)


def test_geglu_ff_function_backward_bf16_within_band_of_pallas_kernel():
    rng = np.random.default_rng(25)
    a = _ff_inputs(rng, n=40)
    g = rng.standard_normal(a["x"].shape).astype(np.float32)
    want = _jax_ff_grads(a, g, True, jnp.bfloat16)
    args = list(_torch_ff_args(a))
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    args = [t.requires_grad_(True) for t in args]
    geglu_ff_grad(*args, residual=True).backward(torch.from_numpy(g).bfloat16())
    for name, t, y in zip(("dx", "dgamma", "dbeta", "dw_in", "dw_out"), args, want):
        assert t.grad.dtype == t.dtype
        assert _rel(t.grad, y) <= BF16_BAND, name


def _patch_case(seed):
    a = _patch_inputs(np.random.default_rng(seed), *PE_SHAPE, PE_PATCH, PE_TPATCH, 128)
    return a, _patch_args(a, PE_PATCH, PE_TPATCH)


def test_patch_embed_res_plain_matches_pallas_kernel():
    a, args = _patch_case(26)
    jargs = (jnp.asarray(a["image"]), *_jax_fold(a, PE_PATCH, PE_TPATCH), jnp.asarray(a["g2"]),
             jnp.asarray(a["b2"]))
    out, conv, mean2, var2 = _forward_res_impl(*jargs, patch=PE_PATCH, t_patch=PE_TPATCH,
                                               interpret=True)
    got_out, got_conv, stats = patch_embed_res_plain(*args, PE_PATCH, PE_TPATCH)
    _close("out", got_out, out)
    _close("conv", got_conv, np.asarray(conv).reshape(got_conv.shape))
    _close("mean", stats[:, 0], np.asarray(mean2).reshape(-1))
    _close("rstd", stats[:, 1], 1.0 / np.sqrt(np.asarray(var2).reshape(-1) + 1e-5))


def test_patch_embed_dkw_plain_matches_pallas_kernel():
    """The weight grad's layout: [wv, cin, dim]; a wv / cin transpose fails."""
    a, args = _patch_case(27)
    rng = np.random.default_rng(28)
    m = int(np.prod(PE_SHAPE)) // (PE_TPATCH * PE_PATCH * PE_PATCH)
    dconv = rng.standard_normal((m, 128)).astype(np.float32)
    b, T, H, W = PE_SHAPE
    want = _dkw_impl(jnp.asarray(a["image"]),
                     jnp.asarray(dconv).reshape(b, T // PE_TPATCH, H // PE_PATCH, W // PE_PATCH,
                                                128),
                     patch=PE_PATCH, t_patch=PE_TPATCH, interpret=True)
    got = patch_embed_dkw_plain(args[0], torch.from_numpy(dconv), PE_PATCH, PE_TPATCH)
    assert got.shape == want.shape == (PE_PATCH, PE_TPATCH * PE_PATCH, 128)
    _close("dkw", got, want)
    swapped = got.reshape(PE_TPATCH * PE_PATCH, PE_PATCH, 128).transpose(0, 1)
    assert np.abs(np.asarray(swapped) - np.asarray(want)).max() > 10 * ATOL


@pytest.mark.parametrize("image_grad", [False, True])
def test_patch_embed_function_backward_matches_pallas_kernel(image_grad):
    """Every parameter gradient of the residual-based backward against
    jax.vjp of patch_embed_fused (interpret: _forward_res_impl, _pe_bwd,
    _dkw_impl); the image cotangent only when the image requires grad."""
    a, args = _patch_case(29)
    rng = np.random.default_rng(30)
    jargs = [jnp.asarray(a["image"]), *_jax_fold(a, PE_PATCH, PE_TPATCH), jnp.asarray(a["g2"]),
             jnp.asarray(a["b2"])]
    out, vjp = jax.vjp(lambda *p: jax_patch_embed(*p, PE_PATCH, PE_TPATCH, True), *jargs)
    g = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
    ins = [t.clone().requires_grad_(i > 0 or image_grad) for i, t in enumerate(args)]
    patch_embed_grad(*ins, PE_PATCH, PE_TPATCH).backward(torch.from_numpy(g))
    for i, (name, t) in enumerate(zip(("image", "kw", "s1", "b1", "g2", "b2"), ins)):
        if i == 0 and not image_grad:
            assert t.grad is None
            continue
        _close(name, t.grad, want[i])


def test_backward_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach the CUDA library and never count a launch."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    rng = np.random.default_rng(31)
    a, g = _attn_case(rng, True)
    args, gt = _torch_attn_args(a), torch.from_numpy(g)
    bias = torch.from_numpy(a["bias"])
    for x, y in zip(attn_block_bwd(*args, bias, gt), attn_block_bwd_plain(*args, bias, gt)):
        assert torch.equal(x, y)
    a, g = _attn_case(rng, False)
    args, gt = _torch_attn_args(a), torch.from_numpy(g)
    for x, y in zip(attn_packed_bwd(*args, gt), attn_packed_bwd_plain(*args, gt)):
        assert torch.equal(x, y)
    fa = _torch_ff_args(_ff_inputs(rng))
    gf = torch.randn(fa[0].shape)
    for x, y in zip(geglu_ff_bwd(*fa, gf), geglu_ff_bwd_plain(*fa, gf)):
        assert torch.equal(x, y)
    _, pargs = _patch_case(32)
    for x, y in zip(patch_embed_res(*pargs, PE_PATCH, PE_TPATCH),
                    patch_embed_res_plain(*pargs, PE_PATCH, PE_TPATCH)):
        assert torch.equal(x, y)
    dconv = torch.randn((96, 128))
    assert torch.equal(patch_embed_dkw(pargs[0], dconv, PE_PATCH, PE_TPATCH),
                       patch_embed_dkw_plain(pargs[0], dconv, PE_PATCH, PE_TPATCH))
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)
