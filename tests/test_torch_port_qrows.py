"""attn_qrows's plain version, the q-row-block attention and the 3-D CPB
table against their JAX twins, on the CPU.

`attn_qrows_plain` (the rounding points of the TPU kernel's kv variant) is
held against `attention_qrows_fused` in interpret mode: at B = 2 with a
bias the JAX kernel takes its kv variant, at B = 1 or without a bias its
per-item grid. In fp32 both variants compute the plain version's function
(2e-5, the JAX suite's band for the kernel, tests/test_pallas.py:592); in
bf16 the rounding points differ between the variants (max relative error
1.5e-2, the bf16 kernel band). `blockwise_cosine_attention_qrows` is held
against the JAX function (its XLA scan on the CPU) with a dense bias, no
bias, a padded last stripe and the row-stripe callback; the 3-D table and
its row stripes against continuous_pos_bias_grouped3 / _row_stripe3 to
1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import AttentionConfig
from ct_clip_ut_tpu.ops import attention as jattn
from ct_clip_ut_tpu.ops import attention_blockwise as jblock
from ct_clip_ut_tpu.ops import posbias as jposbias
from ct_clip_ut_tpu.ops.pallas_attn_qrows import attention_qrows_fused
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch import config as pconfig
from ct_clip_ut_tpu_torch.ops import attention as tattn
from ct_clip_ut_tpu_torch.ops import attention_blockwise as tblock
from ct_clip_ut_tpu_torch.ops import posbias as tposbias
from ct_clip_ut_tpu_torch.ops.attn_qrows import attn_qrows, attn_qrows_grad, attn_qrows_plain

KEY = jax.random.PRNGKey(0)


def jit(fn, *bound, **static):
    """fn with its leading arguments and static keywords bound, jitted
    (eager JAX on the CPU compiles op by op: several times slower)."""
    return jax.jit(lambda *args, **kw: fn(*bound, *args, **static, **kw))


def _inputs(b, n, d=64, heads=4, dh=16, with_bias=True, seed=0):
    rng = np.random.default_rng(seed)
    hd = heads * dh
    f = np.float32
    return dict(x=rng.standard_normal((b, n, d)).astype(f),
                gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(f),
                wq=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
                wk=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
                wv=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
                wo=(rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(f),
                qs=(1.0 + 0.1 * rng.standard_normal(dh)).astype(f),
                ks=(1.0 + 0.1 * rng.standard_normal(dh)).astype(f),
                bias=(0.4 * rng.standard_normal((heads, n, n))).astype(f) if with_bias else None)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _port_args(a, dtype):
    t = torch.from_numpy
    args = [t(a["x"]).to(dtype), t(a["gamma"]), t(a["wq"].T.copy()).to(dtype),
            t(a["wk"].T.copy()).to(dtype), t(a["wv"].T.copy()).to(dtype),
            t(a["wo"].T.copy()).to(dtype), t(a["qs"]), t(a["ks"])]
    return args + [None if a["bias"] is None else t(a["bias"]).to(dtype)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias,residual,b", [(True, True, 2),    # kv variant
                                                  (True, False, 2),
                                                  (True, True, 1),    # per-item grid
                                                  (False, True, 2),   # no bias: per-item
                                                  (False, False, 1)])
def test_attn_qrows_plain_matches_the_pallas_kernel(with_bias, residual, b, dtype):
    a = _inputs(b, 64, with_bias=with_bias)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in a.items()}
    want = jit(lambda *t: attention_qrows_fused(*t, 8.0, 16, True, residual))(
        j["x"].astype(jdt), j["gamma"], j["wq"].astype(jdt), j["wk"].astype(jdt),
        j["wv"].astype(jdt), j["wo"].astype(jdt), j["qs"], j["ks"],
        None if j["bias"] is None else j["bias"].astype(jdt))
    args = _port_args(a, tdt)
    got = attn_qrows_plain(*args, 8.0, residual, q_block=16)
    assert got.dtype == tdt
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(attn_qrows(*args, 8.0, residual), got, rtol=0, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    else:
        assert _rel_err(got.float(), np.asarray(want, np.float32)) <= 1.5e-2


def test_attn_qrows_backward_matches_the_jax_custom_vjp():
    """The recompute backward of attn_qrows_grad against jax.vjp of the
    Pallas kernel's custom VJP (the XLA dense twin), every input, fp32."""
    a = _inputs(2, 32, with_bias=True, seed=3)
    j = [jnp.asarray(a[k]) for k in ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks", "bias")]
    g = np.random.default_rng(4).standard_normal(a["x"].shape).astype(np.float32)
    want = jit(lambda g, *t: jax.vjp(lambda *u: attention_qrows_fused(*u, 8.0, 16, True, True),
                                     *t)[1](g))(jnp.asarray(g), *j)
    args = [t.requires_grad_(True) for t in _port_args(a, torch.float32)]
    attn_qrows_grad(*args, 8.0, True).backward(torch.from_numpy(g))
    for name, t, w in zip("x gamma wq wk wv wo qs ks bias".split(), args, want):
        w = np.asarray(w)
        got = t.grad.numpy()
        got = got.T if name in ("wq", "wk", "wv", "wo") else got
        np.testing.assert_allclose(got, w, atol=5e-4, rtol=5e-4, err_msg=name)


def _attention_pair(seed=0, dim=16, heads=4, dim_head=4):
    """A JAX attention params tree and the port's Attention with its weights."""
    cfg = AttentionConfig(dim=dim, dim_head=dim_head, heads=heads)
    params = jattn.init_attention(jax.random.PRNGKey(seed), cfg)
    sd = {}
    convert._attention(sd, "a", jax.tree.map(np.asarray, params))
    mod = tattn.Attention(pconfig.AttentionConfig(dim=dim, dim_head=dim_head, heads=heads))
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return cfg, params, mod


@pytest.mark.parametrize("n,q_block,with_bias", [(32, 16, True), (40, 16, True), (24, 8, False)])
def test_qrows_attention_matches_jax_with_a_dense_bias(n, q_block, with_bias):
    """The dense-bias (or no-bias) route: on CPU tensors the kernel's plain
    version; n = 40 leaves the last 16-row stripe ragged (JAX pads q)."""
    cfg, params, mod = _attention_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n, cfg.dim)).astype(np.float32)
    bias = (0.4 * rng.standard_normal((cfg.heads, n, n))).astype(np.float32) if with_bias else None
    want = jit(jblock.blockwise_cosine_attention_qrows, params, cfg, q_block=q_block,
               residual=True)(jnp.asarray(x), attn_bias=None if bias is None else jnp.asarray(bias))
    got = tblock.blockwise_cosine_attention_qrows(
        mod, torch.from_numpy(x), q_block=q_block,
        attn_bias=None if bias is None else torch.from_numpy(bias), residual=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    plain = tblock.blockwise_cosine_attention_qrows(
        mod, torch.from_numpy(x), q_block=q_block,
        attn_bias=None if bias is None else torch.from_numpy(bias), residual=True, plain=True)
    torch.testing.assert_close(plain, got.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("q_block", [8, 16])
def test_qrows_attention_matches_jax_with_row_stripes(q_block):
    """The bias_row_fn route over the 3-D CPB of a (3, 2, 4) grid: 24
    tokens; at q_block 16 the last stripe runs past the grid's frames."""
    cfg, params, mod = _attention_pair(seed=1)
    d1, d2, d3 = 3, 2, 4
    n = d1 * d2 * d3
    cpb = jposbias.init_continuous_pos_bias(jax.random.PRNGKey(5), dim=8, heads=cfg.heads,
                                            num_dims=3)
    tcpb = _port_cpb(cpb, cfg.heads)
    jtable = jposbias.cpb_offset_table(cpb, (d1, d2, d3))
    ttable = tposbias.cpb_offset_table(tcpb, (d1, d2, d3))

    def jfn(row0):
        return jposbias.continuous_pos_bias_row_stripe3(None, d1, d2, d3, row0 // (d2 * d3),
                                                        q_block // (d2 * d3), table=jtable)

    def tfn(row0):
        return tposbias.continuous_pos_bias_row_stripe3(tcpb, d1, d2, d3, row0 // (d2 * d3),
                                                        q_block // (d2 * d3), table=ttable)

    x = np.random.default_rng(2).standard_normal((2, n, cfg.dim)).astype(np.float32)
    want = jit(jblock.blockwise_cosine_attention_qrows, params, cfg, q_block=q_block,
               bias_row_fn=jfn, residual=True)(jnp.asarray(x))
    got = tblock.blockwise_cosine_attention_qrows(mod, torch.from_numpy(x), q_block=q_block,
                                                  bias_row_fn=tfn, residual=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _port_cpb(cpb, heads, num_dims=3):
    mod = tposbias.ContinuousPositionBias(dim=np.asarray(cpb["net"][0]["w"]).shape[1],
                                          heads=heads, num_dims=num_dims)
    sd = {}
    convert._cpb(sd, "c", jax.tree.map(np.asarray, cpb))
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return mod


@pytest.mark.parametrize("dims", [(5, 4, 4), (3, 2, 5)])
def test_3d_cpb_table_and_row_stripes_match_jax(dims):
    d1, d2, d3 = dims
    cpb = jposbias.init_continuous_pos_bias(jax.random.PRNGKey(7), dim=8, heads=4, num_dims=3)
    tcpb = _port_cpb(cpb, 4)
    want = np.asarray(jit(jposbias.continuous_pos_bias_grouped3, d1=d1, d2=d2, d3=d3)(cpb))
    got = tposbias.continuous_pos_bias_grouped3(tcpb, d1, d2, d3).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the generic N-D table of the dense route is the same function
    np.testing.assert_allclose(tposbias.continuous_pos_bias(tcpb, d1, d2, d3).detach().numpy(),
                               want, atol=1e-6, rtol=0)
    # row stripes, one running past the last frame (padded q rows)
    for start, length in ((0, 1), (1, 2), (d1 - 1, 2)):
        w = np.asarray(jit(jposbias.continuous_pos_bias_row_stripe3, d1=d1, d2=d2, d3=d3,
                           row_start=start, row_len=length)(cpb))
        g = tposbias.continuous_pos_bias_row_stripe3(tcpb, d1, d2, d3, start, length)
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-6, rtol=0)
    bf = tposbias.continuous_pos_bias_grouped3(tcpb, d1, d2, d3, dtype=torch.bfloat16)
    torch.testing.assert_close(bf, torch.from_numpy(got).to(torch.bfloat16), rtol=0, atol=0)
