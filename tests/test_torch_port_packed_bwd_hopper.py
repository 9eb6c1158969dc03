"""What the CPU can check of the temporal block's fused fp32 backward pass
(rows 8f and 8F: `ctc_attn_packed_bwd_f32` at n <= 64 on
tc::block_backward_f32, its attention in csrc/attn_bwd_packed.cuh) and of
the block weight gradient with its tokens split into chunks
(BlockWgradSplitPlan, rows 7F and 8F).

The kernels run only on the card (chip_smoke.py phases 11 and 14 and the
card tests `-k "fp32_bwd or fp32_full or wgrad_chunks"` hold them against
the plain backwards there). Here the chain is emulated in torch plane by
plane, as tests/test_torch_port_f32_bwd_hopper.py does for the spatial
chain: every fp32 product three bf16 products of hi / lo planes, the
planes written where the kernels write them. The fused pass: per
(sequence, head) the whole row, S and dP split, P = exp2(S log2 e - m log2
e) / l, D = rowsum(P dP) from the same dP, dS = P (dP - D), dq^ = dS K and
(train form) o = P V with dS and P split; then the key phase from the
staged planes, S^T, dP^T, P^T = exp2(S^T log2 e - lse) with each query's
(lse, D) from the first phase, dV = P^T dO, dk^ = dS^T Q with P^T and dS^T
split; the scale sums per (sequence, head), then in order. The weight
gradients: each tile's token slices in chunks (`block_wgrad_partition`),
three passes a chunk flushed every WG_FLUSH slices, the chunks' fp32
partials added in chunk order.

(a) The chain against jax.vjp of `packed_attention_xla` with respect to x
and every parameter, and against the plain backward, within BAND of each
gradient's largest entry (the scale gradients SCALE_GRAD_BAND, as in
tests/test_torch_port_f32_train_hopper.py); the one-pass control (every lo
plane zero) misses each band.

(b) F10, the row term of the temporal chain: a stack of two temporal
blocks over tokens 2% apart along each sequence (adjacent CT slices lie
that close), a cotangent on one token, each layer's query / key weight
gradients and dx against the XLA twins' stack. The fused pass's D =
rowsum(P dP) stays within D_BAND, as the plain fp32 backward does; the
first design's D = rowsum(dO o) from the core's fp32 o (another product
than dP, whose ~2^-16 split errors then do not cancel in dP - D) misses it
(F8 of 12F, reproduced on this chain).

(c) The weight gradient's token partition: every token in exactly one
chunk, the chunks in order, a ragged last one; their partials added in
chunk order within WGRAD_BAND of the fp64 product, one chunk left out
missing it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_packed import packed_attention_xla
from ct_clip_ut_tpu_torch.ops import attn_block, attn_packed

from test_torch_port_cuda import _attn_inputs, _torch_attn_args
from test_torch_port_f32_bwd_hopper import _ln_bwd, _t
from test_torch_port_f32_hopper import _ln_planes, _product, _split
from test_torch_port_f32_train_hopper import _ln_gain_grads

BAND = 2e-5              # max |got - want| / max |want| of each gradient
SCALE_GRAD_BAND = 5e-5   # of dq_scale and dk_scale
D_BAND = 1e-2            # (b): the query / key weight gradients and dx over close tokens
WGRAD_BAND = 2e-5        # (c): the chunked weight gradient against fp64
SCALE = 8.0
LOG2E = 1.4426950408889634
WG_FLUSH = 4             # slices between the three-pass block's flushes (csrc/wgrad_sm90.cuh)
SLICE = 64               # tokens a slice
NAMES = ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def chunked_wgrad(a, b, chunk):
    """A^T B over the token rows of planes a [M, i] and b [M, j] as
    wgrad_kernel sums it: per chunk of `chunk` slices (0: one chunk of
    every token) three passes flushed into fp32 sums every WG_FLUSH slices,
    then the chunks' partials added in order (wgrad_sum_kernel)."""
    m = a[0].shape[0]
    step = chunk * SLICE if chunk else m
    total = None
    for c0 in range(0, m, step):
        part = None
        for f0 in range(c0, min(m, c0 + step), WG_FLUSH * SLICE):
            rows = slice(f0, min(m, c0 + step, f0 + WG_FLUSH * SLICE))
            flush = _product(_t([t[rows] for t in a]), _t([t[rows] for t in b]))
            part = flush if part is None else part + flush
        total = part if total is None else total + part
    return total


def emulated_packed_bwd_f32(x, gamma, wq, wk, wv, wo, qs, ks, g, scale, residual=False,
                            one_pass=False, params=False, d_from_o=False):
    """tc::block_backward_f32 without a bias at n <= 64: the weights', xn's,
    x's and g's planes; q, k (l2-normed, scaled) and v as planes with q's and
    k's unit rows and norms; dO = g Wo as planes; the fused pass (the module
    docstring; d_from_o: the first design's row term, rowsum(dO o) from the
    core's fp32 o); the scale and l2-norm backward into dq's and dk | dv's
    planes; dxn = dq Wq, dx_direct = [dk | dv] [Wk; Wv]; the LN backward +
    dx_direct (+ g). Returns dx, or with params the gradients of
    attn_packed_bwd_plain, the weight gradients chunked as the launch
    splits them."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    hd, m = heads * dh, r * n
    x2, g2 = x.reshape(m, d), g.reshape(m, d)
    sp = (lambda t: _split(t, one_pass))
    wqs, wks, wvs, wos = sp(wq), sp(wk), sp(wv), sp(wo)

    def heads_of(t):   # [m, h*dh] -> [r, h, n, dh]
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def merged(t):     # [r, h, n, dh] -> [m, h*dh]
        return t.transpose(1, 2).reshape(m, hd)

    xn, xs, gs = _ln_planes(x2, gamma, None, one_pass), sp(x2), sp(g2)
    q, k = heads_of(_product(xn, wqs)), heads_of(_product(xs, wks))
    v = sp(heads_of(_product(xs, wvs)))
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    uq, uk = q / qn, k / kn
    qsc = qs * scale
    qh, kh = sp(uq * qsc), sp(uk * ks)
    do = sp(heads_of(_product(gs, _t(wos))))
    # the query phase: whole rows
    s = _product(qh, kh)
    base = s.max(-1, keepdim=True).values * LOG2E
    e = torch.exp2(s * LOG2E - base)
    inv = 1.0 / e.sum(-1, keepdim=True)
    p = e * inv
    dp = _product(do, v)
    o = _product(sp(p), _t(v))
    dsum = (((do[0] + do[1]) * o) if d_from_o else (p * dp)).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dqh = _product(sp(ds), _t(kh))
    lse = base - torch.log2(inv)
    # the key phase: S^T and dP^T again, each query's (lse, D)
    pt = torch.exp2(_product(kh, qh) * LOG2E - lse.transpose(-1, -2))
    dst = pt * (_product(v, do) - dsum.transpose(-1, -2))
    dv = _product(sp(pt), _t(do))
    dkh = _product(sp(dst), _t(qh))
    duq, duk = dqh * qsc, dkh * ks
    dq = merged((duq - uq * (uq * duq).sum(-1, keepdim=True)) / qn)
    dk = merged((duk - uk * (uk * duk).sum(-1, keepdim=True)) / kn)
    dqs_, dkvs = sp(dq), sp(torch.cat([dk, merged(dv)], dim=-1))
    dxn = _product(dqs_, _t(wqs))
    dxd = _product(dkvs, _t(sp(torch.cat([wk, wv]))))
    dx = _ln_bwd(x2, gamma, dxn, dxd)
    dx = (dx + g2 if residual else dx).reshape(r, n, d)
    if not params:
        return dx
    dgamma = _ln_gain_grads(x2, dxn)[0]
    chunk, _ = attn_block.block_wgrad_partition(m, d, hd)
    dwqkv = torch.cat([chunked_wgrad(dqs_, xn, chunk), chunked_wgrad(dkvs, xs, chunk)])
    dwo = chunked_wgrad(gs, sp(merged(o)), chunk)
    # each (sequence, head)'s sums over its rows, then the items in order
    dqsc = (uq * dqh).sum(2).reshape(r * heads, dh).sum(0) * scale
    dksc = (uk * dkh).sum(2).reshape(r * heads, dh).sum(0)
    return (dx, dgamma, dwqkv[:hd], dwqkv[hd:2 * hd], dwqkv[2 * hd:], dwo, dqsc, dksc)


def _jax_vjp(fn, primals, g):
    """Every primal's cotangent of <fn(*primals), g> by jax.vjp, jitted."""
    return [np.asarray(t) for t in jax.jit(lambda p, g: jax.vjp(fn, *p)[1](g))(primals, g)]


@pytest.mark.parametrize("r,n,residual", [(4, 24, False), (6, 7, True), (3, 40, True)])
def test_fused_temporal_pass_matches_the_jax_vjp(r, n, residual):
    """(a): dx and every parameter gradient (n = 40: the pass's 64-key
    template), the one-pass control outside each band."""
    rng = np.random.default_rng(n + r + 500)
    a = _attn_inputs(rng, r, n, 64, 4, 32, False)
    g = rng.standard_normal((r, n, 64)).astype(np.float32)
    args, tg = _torch_attn_args(a), torch.from_numpy(g)
    got = emulated_packed_bwd_f32(*args, tg, SCALE, residual, params=True)
    control = emulated_packed_bwd_f32(*args, tg, SCALE, residual, one_pass=True, params=True)
    assert torch.equal(got[0], emulated_packed_bwd_f32(*args, tg, SCALE, residual))
    twin = _jax_vjp(lambda *p: packed_attention_xla(*p, SCALE, residual),
                    [jnp.asarray(a[k]) for k in NAMES], jnp.asarray(g))
    twin[2:6] = [t.T for t in twin[2:6]]          # the JAX layouts [D, h*dh] / [h*dh, D]
    plain = attn_packed.attn_packed_bwd_plain(*args, tg, SCALE, residual)
    for want in (twin, plain):
        for name, gt, ct, wt in zip(NAMES, got, control, want):
            band = SCALE_GRAD_BAND if name in ("qs", "ks") else BAND
            assert _rel_err(gt, wt) <= band, name
            assert _rel_err(ct, wt) > band, name


# ---- (b) F10: the row term over close tokens ---------------------------------------

LAYERS = 2


@functools.lru_cache(maxsize=1)
def _close_stack():
    """Two temporal blocks (residual) over R = 4 sequences of 24 tokens 2%
    apart, a cotangent on the first token: (each layer's input from the
    plain forward, each layer's weights, the cotangent, jax.vjp of the XLA
    twins' stack with respect to x and every layer's weights)."""
    rng = np.random.default_rng(90)
    cases = [_attn_inputs(np.random.default_rng(91 + i), 4, 24, 64, 4, 32, False)
             for i in range(LAYERS)]
    base = rng.standard_normal((4, 1, 64)).astype(np.float32)
    x0 = (base + 0.02 * cases[0]["x"]).astype(np.float32)
    g = np.zeros_like(x0)
    g[:, 0] = rng.standard_normal((4, 64))
    ws = [_torch_attn_args(c)[1:] for c in cases]
    xs = [torch.from_numpy(x0)]
    for w in ws[:-1]:
        xs.append(attn_packed.attn_packed_plain(xs[-1], *w, SCALE, True))
    jw = [jnp.asarray(c[k]) for c in cases for k in NAMES[1:]]

    def stack(x, *flat):
        for i in range(LAYERS):
            x = packed_attention_xla(x, *flat[7 * i:7 * i + 7], SCALE, True)
        return x

    twin = jax.jit(lambda x, *f: jax.vjp(stack, x, *f)[1](jnp.asarray(g)))(jnp.asarray(x0), *jw)
    return xs, ws, torch.from_numpy(g), [np.asarray(t) for t in twin]


def _close_stack_errors(**scheme):
    """Each layer's dWq, dWk (and the stack's dx) from the chain (scheme:
    d_from_o, or plain: the port's plain backward) against the twins'
    stack, each over its largest entry."""
    xs, ws, dout, twin = _close_stack()
    errs = []
    for i in reversed(range(LAYERS)):
        if scheme.get("plain"):
            got = attn_packed.attn_packed_bwd_plain(xs[i], *ws[i], dout, SCALE, True)
        else:
            got = emulated_packed_bwd_f32(xs[i], *ws[i], dout, SCALE, True, params=True,
                                          d_from_o=scheme.get("d_from_o", False))
        jq, jk = twin[1 + 7 * i + 1].T, twin[1 + 7 * i + 2].T
        errs += [_rel_err(got[2], jq), _rel_err(got[3], jk)]
        dout = got[0]
    return errs + [_rel_err(dout, twin[0])]


@pytest.mark.parametrize("scheme,inside", [({}, True), ({"plain": True}, True),
                                           ({"d_from_o": True}, False)])
def test_fused_pass_keeps_the_cancelling_query_key_gradients(scheme, inside):
    """(b): D = rowsum(P dP) keeps every layer's query / key weight gradients
    and dx within D_BAND of the XLA twins' stack, as the plain fp32 backward
    does; the first design's D from o's product misses it (F10)."""
    errs = _close_stack_errors(**scheme)
    assert (max(errs) <= D_BAND) == inside, errs


# ---- (c) the weight gradient's token partition ---------------------------------------

@pytest.mark.parametrize("tokens,d,hd", [(27648, 512, 256), (1000, 64, 128), (144, 64, 128),
                                         (64, 64, 128), (100, 2048, 1024)])
def test_block_wgrad_chunks_cover_every_token_once_in_order(tokens, d, hd):
    """The partition: chunks of whole slices covering [0, tokens) once, in
    order, the last one ragged where the slices do not divide; (0, 1)
    where there is one slice or a tile a block already (512 tiles at D =
    2048, HD = 1024); at the fp32 step's shapes 4 chunks of the 32 tiles'
    432 slices (128 blocks on the H100's 132 SMs)."""
    chunk, chunks = attn_block.block_wgrad_partition(tokens, d, hd)
    tiles = 4 * -(-d // 128) * (hd // 128)
    slices = -(-tokens // SLICE)
    if chunk == 0:
        assert chunks == 1 and min(slices, attn_block.WGRAD_BLOCKS // tiles) <= 1
        return
    bounds = [(c * chunk * SLICE, min(tokens, (c + 1) * chunk * SLICE)) for c in range(chunks)]
    seen = np.zeros(tokens, np.int64)
    for lo, hi in bounds:
        seen[lo:hi] += 1
    assert (seen == 1).all() and bounds[0][0] == 0 and bounds[-1][1] == tokens
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert 1 < chunks <= slices and chunks * tiles <= attn_block.WGRAD_BLOCKS
    if (tokens, d, hd) == (27648, 512, 256):
        assert (chunk, chunks, chunks * tiles) == (108, 4, 128)


@pytest.mark.parametrize("tokens", [1000, 300])
def test_block_wgrad_chunk_partials_sum_to_the_product(tokens):
    """The partials of every chunk (the last ragged), added in chunk order,
    within WGRAD_BAND of the fp64 product of the fp32 operands; leaving one
    chunk out misses it."""
    rng = np.random.default_rng(tokens)
    a = torch.from_numpy(rng.standard_normal((tokens, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((tokens, 64)).astype(np.float32))
    chunk, chunks = attn_block.block_wgrad_partition(tokens, 64, 128)
    assert chunks > 2 and tokens % (chunk * SLICE) != 0
    want = (a.double().t() @ b.double()).numpy()
    got = chunked_wgrad(_split(a), _split(b), chunk)
    assert _rel_err(got, want) <= WGRAD_BAND
    whole = chunked_wgrad(_split(a), _split(b), 0)
    assert _rel_err(whole, want) <= WGRAD_BAND
    keep = torch.ones(tokens, 1)
    keep[chunk * SLICE:2 * chunk * SLICE] = 0.0      # the second chunk left out
    dropped = chunked_wgrad(_split(a * keep), _split(b), chunk)
    assert _rel_err(dropped, want) > WGRAD_BAND
