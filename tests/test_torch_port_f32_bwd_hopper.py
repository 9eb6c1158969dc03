"""What the CPU can check of the fp32 data-gradient chains of the block and
FF kernels (`ctc_attn_block_bwd_f32` / `ctc_attn_packed_bwd_f32` on
tc::block_backward_f32, `ctc_geglu_ff_bwd_f32`), the backward of the
gradient attribution methods.

The chains run only on the card (chip_smoke.py phase 11 and the card tests
`-k fp32_bwd` hold them against the plain backwards there). Here each is
emulated in torch plane by plane, as tests/test_torch_port_f32_hopper.py
does for the forwards: every fp32 product three bf16 products of hi / lo
planes, the planes written where the kernels write them (the weights once,
read K-major and MN-major; xn and x; g; q and k l2-normed and scaled; v;
dO; P and dS in registers; dq; dk | dv; dvalue | dgate), LayerNorm and its
backward in one-pass moments, D = rowsum(dO o) from the fp32 o. The
emulations are held against jax.vjp of the JAX package's XLA twins
(`_xla_reference_block`, `packed_attention_xla`, `pallas_ff._xla_reference`)
with respect to x and against the port's plain backwards, at fp32, within
2e-5 of dx's largest value (the max relative error the card's checks read;
the chains read 0.8e-5 to 1.3e-5, against 5e-7 between the plain backward
and the XLA VJP); the one-pass control (every lo plane zero, ~6e-3) misses
each band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_block import _xla_reference_block
from ct_clip_ut_tpu.ops.pallas_attn_packed import packed_attention_xla
from ct_clip_ut_tpu.ops.pallas_ff import _xla_reference
from ct_clip_ut_tpu_torch.ops import attn_block, geglu_ff

from test_torch_port_cuda import _attn_inputs, _ff_inputs, _torch_attn_args, _torch_ff_args
from test_torch_port_f32_hopper import _ln_planes, _product, _split

BAND = 2e-5     # max |got - want| / max |want|
SCALE = 8.0


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(planes):
    """The planes of a matrix read MN-major: its transpose's planes."""
    return [p.transpose(-1, -2) for p in planes]


def _ln_bwd(x, gamma, dxn, direct=None):
    """ln_bwd_f32_kernel: the moments recomputed in one-pass form."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + 1e-5)
    xhat = (x - mean) * rstd
    dxhat = dxn * gamma
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    return dx if direct is None else dx + direct


def emulated_geglu_ff_bwd_f32(x, gamma, beta, w_in, w_out, g, residual=False, one_pass=False):
    """ctc_geglu_ff_bwd_f32: the weights', xn's and g's planes; dh = g W2
    (W2's planes read MN-major) in fp32; [value | gate] recomputed
    (GegluSplitPlan) with dvalue | dgate written as planes; dxn = [dvalue |
    dgate] [Wv; Wg] (w_in's planes read MN-major); the LN backward (+ g)."""
    inner = w_out.shape[1]
    w = _split(w_in, one_pass)
    vg = _product(_ln_planes(x, gamma, beta, one_pass), w)
    value, gate = vg[:, :inner], vg[:, inner:]
    dh = _product(_split(g, one_pass), _t(_split(w_out, one_pass)))
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gprime = cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)
    dvg = torch.cat([dh * gate * cdf, dh * value * gprime], dim=-1)
    dxn = _product(_split(dvg, one_pass), _t(w))
    return _ln_bwd(x, gamma, dxn, g if residual else None)


def emulated_block_bwd_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, residual=False,
                           one_pass=False):
    """tc::block_backward_f32: the weights' planes (wq | wk | wv, wo), xn's,
    x's and g's; q, k (l2-normed, scaled) and v as planes with q's and k's
    unit rows and norms in fp32; dO = g Wo as planes; the statistics pass's
    p and D = rowsum(dO o) from the fp32 o; the query pass (dP = dO V^T, dS
    = P (dP - D), dq^ = dS K split) and the key pass (dV = P^T dO, dk^ =
    dS^T Q, P and dS split); the scale and l2-norm backward into dq, dk
    planes; dxn = dq Wq, dx_direct = [dk | dv] [Wk; Wv]; the LN backward +
    dx_direct (+ g)."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    m = r * n
    x2, g2 = x.reshape(m, d), g.reshape(m, d)
    sp = (lambda t: _split(t, one_pass))
    wqs, wks, wvs, wos = sp(wq), sp(wk), sp(wv), sp(wo)

    def heads_of(t):   # [m, h*dh] -> [r, h, n, dh]
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def merged(t):     # [r, h, n, dh] -> [m, h*dh]
        return t.transpose(1, 2).reshape(m, heads * dh)

    xn, xs = _ln_planes(x2, gamma, None, one_pass), sp(x2)
    q, k = heads_of(_product(xn, wqs)), heads_of(_product(xs, wks))
    v = sp(heads_of(_product(xs, wvs)))
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    uq, uk = q / qn, k / kn
    qsc = qs * scale
    qh, kh = sp(uq * qsc), sp(uk * ks)
    do = sp(heads_of(_product(sp(g2), _t(wos))))
    s = _product(qh, kh)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    o = _product(sp(p), _t(v))
    dsum = ((do[0] + do[1]) * o).sum(-1, keepdim=True)
    ds = p * (_product(do, v) - dsum)
    dqh = _product(sp(ds), _t(kh))
    dkh = _product(sp(ds.transpose(-1, -2)), _t(qh))
    dv = _product(sp(p.transpose(-1, -2)), _t(do))
    duq, duk = dqh * qsc, dkh * ks
    dq = (duq - uq * (uq * duq).sum(-1, keepdim=True)) / qn
    dk = (duk - uk * (uk * duk).sum(-1, keepdim=True)) / kn
    dxn = _product(sp(merged(dq)), _t(wqs))
    dkv = torch.cat([merged(dk), merged(dv)], dim=-1)
    dxd = _product(sp(dkv), _t(sp(torch.cat([wk, wv]))))
    dx = _ln_bwd(x2, gamma, dxn, dxd)
    return (dx + g2 if residual else dx).reshape(r, n, d)


def _vjp_x(fn, x, g):
    """d <fn(x), g> / dx by jax.vjp, jitted."""
    return np.asarray(jax.jit(lambda x, g: jax.vjp(fn, x)[1](g)[0])(x, g))


@pytest.mark.parametrize("r,n,with_bias,residual", [(3, 40, True, False), (2, 64, True, True),
                                                    (4, 24, False, False), (6, 7, False, True)])
def test_block_bwd_f32_chain_matches_the_jax_vjp(r, n, with_bias, residual):
    rng = np.random.default_rng(n + r + 100)
    a = _attn_inputs(rng, r, n, 64, 4, 32, with_bias)
    g = rng.standard_normal((r, n, 64)).astype(np.float32)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"]) if with_bias else None
    tg = torch.from_numpy(g)
    got = emulated_block_bwd_f32(*args, bias, tg, SCALE, residual).numpy()
    control = emulated_block_bwd_f32(*args, bias, tg, SCALE, residual, one_pass=True).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items() if v is not None}
    rest = (j["gamma"], j["wq"], j["wk"], j["wv"], j["wo"], j["qs"], j["ks"])
    if with_bias:
        twin = _vjp_x(lambda x: _xla_reference_block(x, *rest, j["bias"], SCALE, residual),
                      j["x"], jnp.asarray(g))
    else:
        twin = _vjp_x(lambda x: packed_attention_xla(x, *rest, SCALE, residual), j["x"],
                      jnp.asarray(g))
    plain = attn_block.attn_block_bwd_plain(*args, bias, tg, SCALE, residual)[0].numpy()
    for want in (twin, plain):
        assert _rel_err(got, want) <= BAND
        assert _rel_err(control, want) > BAND


@pytest.mark.parametrize("n,dim,residual", [(20, 64, False), (77, 64, True), (33, 128, False)])
def test_geglu_ff_bwd_f32_chain_matches_the_jax_vjp(n, dim, residual):
    rng = np.random.default_rng(n + 200)
    a = _ff_inputs(rng, n, dim)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    args = _torch_ff_args(a)
    tg = torch.from_numpy(g)
    got = emulated_geglu_ff_bwd_f32(*args, tg, residual).numpy()
    control = emulated_geglu_ff_bwd_f32(*args, tg, residual, one_pass=True).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    twin = _vjp_x(lambda x: _xla_reference(x, j["gamma"], j["beta"], j["wv"], j["wg"], j["w2"],
                                           residual), j["x"], jnp.asarray(g))
    plain = geglu_ff.geglu_ff_bwd_plain(*args, tg, residual)[0].numpy()
    for want in (twin, plain):
        assert _rel_err(got, want) <= BAND
        assert _rel_err(control, want) > BAND
