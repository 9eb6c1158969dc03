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
backward in one-pass moments; the spatial chain's wgmma passes take D =
rowsum(P dP) / rowsum(P) from the row term's walk over the same split S
and dP (`_row_term`, F11; the first design's D = rowsum(dO o) from the fp32 o is the
`d_from_o` control; the temporal chain at n <= 64 is the fused pass of
tests/test_torch_port_packed_bwd_hopper.py, D = rowsum(P dP)). The
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
from test_torch_port_f32_hopper import _ln_planes, _product, _split, fake_card  # noqa: F401

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


def _row_term(p, dp):
    """The row term's walk: D = c + rowsum(P (dP - c)) / rowsum(P), c each
    row's dP at key 0 (summands near zero over close tokens), so that each
    row of dS = P (dP - D) sums to zero whatever the l that scaled P."""
    c = dp[..., :1]
    return c + (p * (dp - c)).sum(-1, keepdim=True) / p.sum(-1, keepdim=True)


def emulated_block_bwd_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, residual=False,
                           one_pass=False, d_from_o=False):
    """tc::block_backward_f32 over whole sequences: the weights' planes (wq |
    wk | wv, wo), xn's, x's and g's; q, k (l2-normed, scaled) and v as planes
    with q's and k's unit rows and norms in fp32; dO = g Wo as planes; the
    statistics pass's p and D = rowsum(P dP) from the split dP (d_from_o:
    the first design's rowsum(dO o) from the fp32 o); the query pass (dP = dO V^T, dS
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
    dp = _product(do, v)
    if d_from_o:
        dsum = ((do[0] + do[1]) * _product(sp(p), _t(v))).sum(-1, keepdim=True)
    else:
        dsum = _row_term(p, dp)
    ds = p * (dp - dsum)
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
    if with_bias:
        got = emulated_block_bwd_f32(*args, bias, tg, SCALE, residual).numpy()
        control = emulated_block_bwd_f32(*args, bias, tg, SCALE, residual, one_pass=True).numpy()
    else:
        # the temporal chain at n <= 64: the fused pass
        from test_torch_port_packed_bwd_hopper import emulated_packed_bwd_f32

        got = emulated_packed_bwd_f32(*args, tg, SCALE, residual).numpy()
        control = emulated_packed_bwd_f32(*args, tg, SCALE, residual, one_pass=True).numpy()
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


# ---- the redesigned chains (rows 7f / 9f): launch by launch ---------------------

LOG2E = 1.4426950408889634
TILE = 64        # keys (queries) a streamed tile of the wgmma passes (csrc/attn_bwd_wg.cuh)
ROWS, COLS = 128, 64   # the FF recompute's tile: rows x inner columns (gate_bwd_split_kernel)


def _forward_core_stats(qh, kh, v, bias, one_pass=False):
    """The fp32 forward core with STATS, as the forward keeps it for the
    backward (ctc_attn_block_f32 with its mld): split scores (+ bias), each
    row's (m log2 e, 1 / l), p = exp2(s log2 e - m log2 e) / l, o = P.V
    split, written as planes."""
    s = _product(qh, kh)
    if bias is not None:
        s = s + bias
    m = s.max(-1, keepdim=True).values
    l = torch.exp(s - m).sum(-1, keepdim=True)
    base, inv = m * LOG2E, 1.0 / l
    p = torch.exp2(s * LOG2E - base) * inv
    o = _product(_split(p, one_pass), _t(v))
    return base, inv, _split(o, one_pass)


def _wg_passes(qh, kh, v, do, bias, base, inv, o, one_pass=False, d_from_o=False):
    """bwd_dq_wg_kernel's row-term walk and passes and bwd_dkv_wg_kernel on
    planes [r, h, n, 32]: D = rowsum(P dP) / rowsum(P) over the split S (+
    bias) and dP with P from the saved (m, l) (`_row_term`) (d_from_o: the
    first design's D =
    rowsum((dO_hi + dO_lo)(o_hi + o_lo)), F11's control) and lse = m log2 e
    - log2(1 / l); the query pass over 64-key tiles (S, dP, P, dS = P (dP -
    D) split, dq^ summed tile by tile in order), the key pass over 64-query
    tiles (S^T, dP^T, P^T from lse, dV and dk^ summed tile by tile).
    Returns (dq^, dk^, dv)."""
    n = qh[0].shape[-2]
    sp = (lambda t: _split(t, one_pass))
    if d_from_o:
        d = ((do[0] + do[1]) * (o[0] + o[1])).sum(-1, keepdim=True)
    else:
        s = _product(qh, kh) + (bias if bias is not None else 0.0)
        p = torch.exp2(s * LOG2E - base) * inv
        d = _row_term(p, _product(do, v))
    lse = base - torch.log2(inv)
    dq = torch.zeros_like(qh[0])
    for j0 in range(0, n, TILE):
        keys = slice(j0, min(n, j0 + TILE))
        kt, vt = [t[..., keys, :] for t in kh], [t[..., keys, :] for t in v]
        s = _product(qh, kt) + (bias[..., keys] if bias is not None else 0.0)
        p = torch.exp2(s * LOG2E - base) * inv
        ds = p * (_product(do, vt) - d)
        dq = dq + _product(sp(ds), _t(kt))
    dk, dv = torch.zeros_like(kh[0]), torch.zeros_like(v[0])
    bias_t = bias.transpose(-1, -2) if bias is not None else None
    for i0 in range(0, n, TILE):
        qs_ = slice(i0, min(n, i0 + TILE))
        qt, dot = [t[..., qs_, :] for t in qh], [t[..., qs_, :] for t in do]
        st = _product(kh, qt) + (bias_t[..., qs_] if bias is not None else 0.0)
        pt = torch.exp2(st * LOG2E - lse[..., qs_, :].transpose(-1, -2))
        dst = pt * (_product(v, dot) - d[..., qs_, :].transpose(-1, -2))
        dv = dv + _product(sp(pt), _t(dot))
        dk = dk + _product(sp(dst), _t(qt))
    return dq, dk, dv


def emulated_block_bwd_f32_wg(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, residual=False,
                              one_pass=False, saved=None, d_from_o=False, params=False):
    """tc::block_backward_f32 with a bias (rows 7f / 7F): the weights', xn's,
    x's and g's planes; q, k (l2-normed, scaled) and v as planes with q's and
    k's unit rows and norms; dO = g Wo as planes; the forward core's
    statistics and o's planes from `saved` (the forward's, as
    `_forward_core_stats` writes them) or rerun here; the two wgmma passes
    (`_wg_passes`); the scale and l2-norm backward; dxn = dq Wq, dx_direct =
    [dk | dv] [Wk; Wv]; the LN backward + dx_direct (+ g). Returns (dx, the
    statistics and o's planes the chain used); with params (dx, dWq = dq^T
    xn, dWk = dk^T x) on the planes, as BlockWgradSplitPlan takes them.
    d_from_o: the first design's row term (`_wg_passes`)."""
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
    stats = saved if saved is not None else _forward_core_stats(qh, kh, v, bias, one_pass)
    dqh, dkh, dv = _wg_passes(qh, kh, v, do, bias, *stats, one_pass, d_from_o)
    duq, duk = dqh * qsc, dkh * ks
    dq = (duq - uq * (uq * duq).sum(-1, keepdim=True)) / qn
    dk = (duk - uk * (uk * duk).sum(-1, keepdim=True)) / kn
    dqs_ = sp(merged(dq))
    dxn = _product(dqs_, _t(wqs))
    dkv = sp(torch.cat([merged(dk), merged(dv)], dim=-1))
    dxd = _product(dkv, _t(sp(torch.cat([wk, wv]))))
    dx = _ln_bwd(x2, gamma, dxn, dxd)
    dx = (dx + g2 if residual else dx).reshape(r, n, d)
    if params:
        hd = heads * dh
        return dx, _product(_t(dqs_), _t(xn)), _product(_t([p[:, :hd] for p in dkv]), _t(xs))
    return dx, stats


def emulated_block_forward_saving(x, gamma, wq, wk, wv, scale, qs, ks, bias):
    """ctc_attn_block_f32 with its mld: the projections' planes and the
    core's statistics and o planes, what _BlockFn keeps for the backward."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x2 = x.reshape(r * n, d)

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    xn, xs = _ln_planes(x2, gamma, None, False), _split(x2)
    q, k = heads_of(_product(xn, _split(wq))), heads_of(_product(xs, _split(wk)))
    v = _split(heads_of(_product(xs, _split(wv))))
    uq = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    uk = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    return _forward_core_stats(_split(uq * (qs * scale)), _split(uk * ks), v, bias)


@pytest.mark.parametrize("r,n,residual", [(3, 40, False), (2, 64, True), (2, 130, False)])
def test_block_bwd_f32_wg_chain_matches_the_jax_vjp(r, n, residual):
    """The spatial chain's wgmma passes emulated tile by tile (64-key and
    64-query tiles, n = 130 a ragged third tile) from the forward's saved
    statistics: within BAND of jax.vjp of the XLA twin and of the plain
    backward; the same bits as the chain that reruns the forward core; the
    one-pass control outside the band; the tiles' sums within BAND / 4 of
    the whole-sequence emulation."""
    rng = np.random.default_rng(n + r + 300)
    a = _attn_inputs(rng, r, n, 64, 4, 32, True)
    g = rng.standard_normal((r, n, 64)).astype(np.float32)
    args = _torch_attn_args(a)
    bias, tg = torch.from_numpy(a["bias"]), torch.from_numpy(g)
    x, gamma, wq, wk, wv, wo, qs, ks = args
    saved = emulated_block_forward_saving(x, gamma, wq, wk, wv, SCALE, qs, ks, bias)
    got, used = emulated_block_bwd_f32_wg(*args, bias, tg, SCALE, residual, saved=saved)
    rerun, _ = emulated_block_bwd_f32_wg(*args, bias, tg, SCALE, residual)
    assert torch.equal(got, rerun)
    control, _ = emulated_block_bwd_f32_wg(*args, bias, tg, SCALE, residual, one_pass=True)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    rest = (j["gamma"], j["wq"], j["wk"], j["wv"], j["wo"], j["qs"], j["ks"])
    twin = _vjp_x(lambda x_: _xla_reference_block(x_, *rest, j["bias"], SCALE, residual), j["x"],
                  jnp.asarray(g))
    plain = attn_block.attn_block_bwd_plain(*args, bias, tg, SCALE, residual)[0].numpy()
    for want in (twin, plain):
        assert _rel_err(got.numpy(), want) <= BAND
        assert _rel_err(control.numpy(), want) > BAND
    # the tiles' sums against the whole-sequence passes
    whole = emulated_block_bwd_f32(*args, bias, tg, SCALE, residual).numpy()
    assert _rel_err(got.numpy(), whole) <= BAND / 4


def emulated_gate_bwd_tiles(x, gamma, beta, w_in, w_out, g, one_pass=False):
    """gate_bwd_split_kernel tile by tile (128 rows x 64 inner columns):
    [value | gate] of the tile's columns over xn's planes (three passes),
    then dh of the same columns in the block's second K loop over g's and
    W2's planes (read MN-major), never stored; the epilogue's dvalue |
    dgate. Returns [dvalue | dgate] [N, 2 inner]."""
    inner = w_out.shape[1]
    n = x.shape[0]
    xn = _ln_planes(x, gamma, beta, one_pass)
    w = _split(w_in, one_pass)
    gs, w2 = _split(g, one_pass), _t(_split(w_out, one_pass))
    dvg = torch.zeros((n, 2 * inner))
    for r0 in range(0, n, ROWS):
        rows = slice(r0, min(n, r0 + ROWS))
        a, ga = [t[rows] for t in xn], [t[rows] for t in gs]
        for c0 in range(0, inner, COLS):
            cols = slice(c0, min(inner, c0 + COLS))
            value = _product(a, [t[cols] for t in w])
            gate = _product(a, [t[inner + c0:inner + cols.stop] for t in w])
            dh = _product(ga, [t[cols] for t in w2])
            cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
            gprime = cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)
            dvg[rows, cols] = dh * gate * cdf
            dvg[rows, inner + c0:inner + cols.stop] = dh * value * gprime
    return dvg


@pytest.mark.parametrize("n,dim,residual", [(20, 64, False), (300, 64, True), (33, 128, False)])
def test_geglu_ff_bwd_f32_gate_tiles_match_the_jax_vjp(n, dim, residual):
    """dh from the recompute block's second K loop: the tiles' dvalue |
    dgate within 1e-6 of the whole products' (the first design's dh through
    memory), and dx from them (dxn = [dvalue | dgate] [Wv; Wg], the LN
    backward) within BAND of jax.vjp of the XLA twin and of the plain
    backward; the one-pass control outside."""
    rng = np.random.default_rng(n + 400)
    a = _ff_inputs(rng, n, dim)
    g = rng.standard_normal((n, dim)).astype(np.float32)
    args = _torch_ff_args(a)
    x, gamma, beta, w_in, w_out = args
    tg = torch.from_numpy(g)

    def chain(one_pass=False):
        dvg = emulated_gate_bwd_tiles(*args, tg, one_pass)
        dxn = _product(_split(dvg, one_pass), _t(_split(w_in, one_pass)))
        return _ln_bwd(x, gamma, dxn, tg if residual else None), dvg

    got, dvg = chain()
    inner = w_out.shape[1]
    vg = _product(_ln_planes(x, gamma, beta, False), _split(w_in))
    value, gate = vg[:, :inner], vg[:, inner:]
    dh = _product(_split(tg), _t(_split(w_out)))
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    gprime = cdf + gate * 0.3989422804014327 * torch.exp(-0.5 * gate * gate)
    whole = torch.cat([dh * gate * cdf, dh * value * gprime], dim=-1)
    assert _rel_err(dvg.numpy(), whole.numpy()) <= 1e-6
    j = {k: jnp.asarray(v) for k, v in a.items()}
    twin = _vjp_x(lambda x_: _xla_reference(x_, j["gamma"], j["beta"], j["wv"], j["wg"], j["w2"],
                                            residual), j["x"], jnp.asarray(g))
    plain = geglu_ff.geglu_ff_bwd_plain(*args, tg, residual)[0].numpy()
    control = chain(one_pass=True)[0].numpy()
    for want in (twin, plain):
        assert _rel_err(got.numpy(), want) <= BAND
        assert _rel_err(control, want) > BAND


def test_block_fn_keeps_the_forward_statistics_for_the_backward(fake_card):
    """Through a stand-in library: `_BlockFn` with keep launches the fp32
    forward with a statistics buffer and the backward with flags 2 and the
    forward's o planes and statistics in place of its own workspaces (the
    core is not rerun); without keep, neither. The wrapper refuses saved
    tensors of another shape."""
    from ct_clip_ut_tpu_torch.ops.attention import _BlockFn

    a = _attn_inputs(np.random.default_rng(3), 2, 24, 64, 4, 32, True)
    args = list(_torch_attn_args(a))
    bias = torch.from_numpy(a["bias"])
    for keep in (True, None):
        fake_card.calls.clear()
        x = args[0].clone().requires_grad_(True)
        extra = () if keep is None else (keep,)
        y = _BlockFn.apply(x, *args[1:], bias, SCALE, False, *extra)
        torch.autograd.grad(y, [x], torch.ones_like(y))
        (fwd, fargs), (bwd, bargs) = fake_card.calls
        assert (fwd, bwd) == ("ctc_attn_block_f32", "ctc_attn_block_bwd_f32")
        # forward: 9 inputs, 6 workspaces (o's planes last), mld; backward: 10
        # inputs, then xs, w_s, wo_s, gs, qk, unit, norm, biasT, v, dO, o, mld
        assert (fargs[15] is not None) == bool(keep)
        assert bargs[-2] == (2 if keep else 0)
        if keep:
            assert (bargs[20], bargs[21]) == (fargs[14], fargs[15])
    with pytest.raises(ValueError):
        attn_block.attn_block_bwd_f32(*args, bias, torch.zeros_like(args[0]),
                                      saved=(torch.empty(2, 48, 64, dtype=torch.bfloat16),
                                             torch.empty(48 * 4, 4)))
