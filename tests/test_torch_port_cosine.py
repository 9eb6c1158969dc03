"""The bare cosine-attention core (ct_clip_ut_tpu_torch/ops/cosine_attention.py)
against the JAX package's (ops/pallas_attention.py), on the CPU.

`cosine_attention_plain` against `cosine_attention_fused` in interpret
mode: fp32 within 2e-5 (tests/test_pallas.py:592's band), bf16 within
1.5e-2 max relative error (the bf16 kernel band; both round p to bf16 but
sum in another order), with the [h, n, m] bias and without. Its recompute
backward against jax.vjp of the custom VJP (every input's gradient, fp32,
1e-4 relative). The route in ops/attention.py: a cross-attention of n >=
128 queries without mask, null key/values or requested weights goes
through the core and equals JAX attention() (its XLA path on the CPU)
within 1e-5; the calls the route leaves alone take the plain path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import AttentionConfig
from ct_clip_ut_tpu.ops import attention as jattn
from ct_clip_ut_tpu.ops.pallas_attention import cosine_attention_fused
from ct_clip_ut_tpu_torch import _build, convert
from ct_clip_ut_tpu_torch.ops import attention as tattn
from ct_clip_ut_tpu_torch.ops import cosine_attention as tcos
from ct_clip_ut_tpu_torch.ops import launches

from test_torch_port_modules import port_config

HEADS, DH = 4, 8


def _inputs(b, n, m, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(q=rng.standard_normal((b * HEADS, n, DH)).astype(f),
                k=rng.standard_normal((b * HEADS, m, DH)).astype(f),
                v=rng.standard_normal((b * HEADS, m, DH)).astype(f),
                qs=(1.0 + 0.1 * rng.standard_normal(DH)).astype(f),
                ks=(1.0 + 0.1 * rng.standard_normal(DH)).astype(f),
                bias=(0.5 * rng.standard_normal((HEADS, n, m))).astype(f) if with_bias else None)


def _torch_args(a, dtype=torch.float32):
    t = torch.from_numpy
    return (t(a["q"]).to(dtype), t(a["k"]).to(dtype), t(a["v"]).to(dtype), t(a["qs"]),
            t(a["ks"]), None if a["bias"] is None else t(a["bias"]))


def _jax_args(a, dtype=jnp.float32):
    return (jnp.asarray(a["q"], dtype), jnp.asarray(a["k"], dtype), jnp.asarray(a["v"], dtype),
            jnp.asarray(a["qs"]), jnp.asarray(a["ks"]),
            None if a["bias"] is None else jnp.asarray(a["bias"]))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_attention_plain_matches_pallas_kernel(dtype, with_bias):
    a = _inputs(2, 24, 40, with_bias)
    want = cosine_attention_fused(*_jax_args(a, getattr(jnp, dtype)), HEADS, 8.0, True)
    got = tcos.cosine_attention_plain(*_torch_args(a, getattr(torch, dtype)), HEADS, 8.0)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2 * HEADS, 24, DH)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    else:
        rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert rel <= 1.5e-2, rel


@pytest.mark.parametrize("with_bias", [True, False])
def test_cosine_attention_backward_matches_jax_vjp(with_bias):
    a = _inputs(2, 16, 20, with_bias, seed=1)
    g = np.random.default_rng(2).standard_normal((2 * HEADS, 16, DH)).astype(np.float32)
    jargs = _jax_args(a)
    diff = [x for x in jargs if x is not None]

    def f(*xs):
        q, k, v, qs, ks, *bias = xs
        return cosine_attention_fused(q, k, v, qs, ks, bias[0] if bias else None, HEADS, 8.0,
                                      True)

    _, vjp = jax.vjp(f, *diff)
    want = vjp(jnp.asarray(g))
    targs = [x.requires_grad_() if x is not None else None for x in _torch_args(a)]
    out = tcos.cosine_attention_grad(*targs, HEADS, 8.0)
    got = torch.autograd.grad(out, [x for x in targs if x is not None], torch.from_numpy(g))
    assert len(got) == len(want) == (6 if with_bias else 5)
    for gt, wt in zip(got, want):
        wt = np.asarray(wt)
        np.testing.assert_allclose(gt.numpy(), wt, atol=1e-4 * np.abs(wt).max(), rtol=0)


def _cross(n, m, seed=3, **kw):
    """A JAX cross-attention's params and config, the port's module with the
    same weights, x [2, n, 32] and a context [2, m, 24]."""
    cfg = AttentionConfig(dim=32, dim_head=DH, heads=HEADS, dim_context=24, norm_context=True,
                          **kw)
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg)
    attn = tattn.Attention(port_config(cfg))
    sd = {}
    convert._attention(sd, "a", jax.tree.map(np.asarray, p))
    attn.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, m, 24)).astype(np.float32)
    return p, cfg, attn, x, ctx


@pytest.mark.parametrize("with_bias", [True, False])
def test_cross_attention_routes_through_the_core(monkeypatch, with_bias):
    """n = 128 queries, no mask / null key/values / weights: the core, on
    the CPU its plain version (no library load, no launch counted), equal to
    JAX attention(); with residual too."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    calls = []
    core = tcos.cosine_attention_grad
    monkeypatch.setattr(tattn, "cosine_attention_grad",
                        lambda *args: calls.append(args[0].shape) or core(*args))
    launches.reset_launch_counts()
    p, cfg, attn, x, ctx = _cross(128, 40)
    bias = (0.3 * np.random.default_rng(4).standard_normal((HEADS, 128, 40))).astype(np.float32)
    jbias = jnp.asarray(bias) if with_bias else None
    tbias = torch.from_numpy(bias) if with_bias else None
    for residual in (False, True):
        want = jax.jit(lambda xx, cc: jattn.attention(p, cfg, xx, context=cc, attn_bias=jbias,
                                                      return_weights=False,
                                                      residual=residual).out)(x, ctx)
        with torch.no_grad():
            out, w = tattn.attention(attn, torch.from_numpy(x), context=torch.from_numpy(ctx),
                                     attn_bias=tbias, return_weights=False, residual=residual)
            plain, _ = tattn.attention(attn, torch.from_numpy(x), context=torch.from_numpy(ctx),
                                       attn_bias=tbias, return_weights=False,
                                       residual=residual, plain=True)
        assert w is None
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert torch.equal(out, plain)
    assert calls == [(2 * HEADS, 128, DH)] * 2
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)


@pytest.mark.parametrize("case", ["short", "mask", "weights", "null_kv"])
def test_cross_attention_outside_the_route_is_plain(monkeypatch, case):
    """n < 128, a mask, requested weights or null key/values: the plain
    path, as the JAX gate sends them to XLA; the outputs still equal JAX's."""
    monkeypatch.setattr(tattn, "cosine_attention_grad",
                        lambda *a: pytest.fail("the core took a call outside its route"))
    p, cfg, attn, x, ctx = _cross(64 if case == "short" else 128, 40,
                                  num_null_kv=2 if case == "null_kv" else 0)
    mask = np.ones((2, 40), bool)
    mask[1, 30:] = False
    kw = dict(mask=mask) if case == "mask" else {}
    weights = case == "weights"
    want = jattn.attention(p, cfg, jnp.asarray(x), context=jnp.asarray(ctx),
                           return_weights=weights, **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = tattn.attention(attn, torch.from_numpy(x), context=torch.from_numpy(ctx),
                              return_weights=weights,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), atol=1e-5, rtol=0)
    assert (got.weights is None) == (not weights)


def test_cosine_wrapper_takes_plain_version_on_cpu(monkeypatch):
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    a = _inputs(1, 8, 12, True, seed=5)
    args = _torch_args(a, torch.bfloat16)
    assert torch.equal(tcos.cosine_attention(*args, HEADS, 8.0),
                       tcos.cosine_attention_plain(*args, HEADS, 8.0))
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)
