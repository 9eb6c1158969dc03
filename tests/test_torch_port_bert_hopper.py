"""The bf16 BERT layer's chain on the Hopper pieces (csrc/bert_bf16.cuh,
csrc/bert_layer_bwd.cu), emulated launch by launch in torch on the CPU.

At B = 2, n = 96 tokens (ragged: the passes' 64-key chunks end in a short
one), a key mask cutting sequence 1 at 70 tokens, 2 heads of 64, F = 256,
inputs from a numpy seed:

- the attention core as its kernels compute it: the forward's two passes
  over 64-key chunks, the even chunks in one half of a block's warps and
  the odd ones in the other (pass 1 each half's row max and sum, the halves
  met; pass 2 p normalised in fp32, times the keep mask, rounded to bf16,
  P.V summed per half and the halves added); the backward's query and key
  passes from the forward's row statistics with the row term D =
  rowsum(dctx ctx) of the bf16 dctx and ctx, dv from bf16(p keep) and ds =
  bf16(p (dP keep - D) / sqrt(dh)). The layer around it at the chain's
  rounding points. Its forward and all thirteen gradients against
  `bert_layer_plain` / `bert_layer_bwd_plain` through the same Philox masks
  and, at p = 0, against jax.vjp of the JAX package's `bert_layer_xla`,
  band 1.5e-2 max relative; two faulty cores outside it: ds without its row
  term, and the keep mask applied to p inside ds instead of to dp;
- the Philox draw in the mma.sync / wgmma fragment order (keep_frag: the
  even lane of a pair draws row g's group of four columns, the odd lane
  row g + 8's, and they swap halves) reproducing `philox_keep` bit for bit
  for the attention site and both hidden sites, and the attention mask's
  bits as the recompute forward packs them and the query and key passes
  read them back;
- the two weight-gradient launches' tile lists (dW2 | dW1, dWo | dWqkv; the
  kernel's BertWgradPlan): every output element in exactly one tile, the
  same bits in any tile order, a tile left out outside the band.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_bert_layer import bert_layer_xla
from ct_clip_ut_tpu_torch.ops import bert_layer as bl

from test_torch_port_cuda import BERT_KEYS, _bert_inputs, _torch_bert_args
from test_torch_port_split import SLICE, TILE, emulated_wgrad

B, N, D, HEADS, F, EPS = 2, 96, 128, 2, 256, 1e-12
LENGTHS = (96, 70)
BAND = 1.5e-2
KC = 64                    # the passes' key (query) chunk, bl.KEY_CHUNK
NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "dbe1", "dw1", "db1", "dw2", "db2",
         "dg2", "dbe2")
TRAIN = dict(p_attn=0.25, p_hidden=0.25, train=True)


def _rnd(t):
    return t.to(torch.bfloat16).float()


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _halves(n):
    """The 64-row chunks [c0, c1) each half of a block walks, in order."""
    chunks = [(c0, min(c0 + KC, n)) for c0 in range(0, n, KC)]
    return chunks[0::2], chunks[1::2]


# ---- the attention core -------------------------------------------------------

def core_forward(q, k, v, mask_row, keep, scale):
    """fwd_core_kernel on [b, h, n, 64] q / k / v (bf16 values): (ctx in bf16
    values, each row's max and 1 / sum)."""
    s = (q @ k.transpose(-1, -2)) * scale + mask_row[:, None, None, :]
    stats = []
    for chunks in _halves(s.shape[-1]):
        m = torch.full(s.shape[:-1], -math.inf)
        l = torch.zeros(s.shape[:-1])
        for c0, c1 in chunks:
            mx = torch.maximum(m, s[..., c0:c1].amax(-1))
            l = torch.where(m == -math.inf, 0.0, l * torch.exp(m - mx)) \
                + torch.exp(s[..., c0:c1] - mx[..., None]).sum(-1)
            m = mx
        stats.append((m, l))
    (m0, l0), (m1, l1) = stats
    big = torch.maximum(m0, m1)
    total = sum(torch.where(m == -math.inf, 0.0, l * torch.exp(m - big)) for m, l in stats)
    inv = 1.0 / total
    p = torch.exp(s - big[..., None]) * inv[..., None]
    pu = _rnd(p if keep is None else p * keep)
    o = sum(sum(pu[..., c0:c1] @ v[..., c0:c1, :] for c0, c1 in chunks)
            for chunks in _halves(s.shape[-1]))
    return _rnd(o), big, inv


def core_backward(q, k, v, ctx, dctx, mask_row, keep, big, inv, scale, fault=""):
    """dq_pass_kernel and dkv_pass_kernel: (dq, dk, dv) in fp32. fault "no
    row term" drops D from ds; "keep on p" multiplies p by the keep mask
    inside ds instead of dP."""
    row_d = (dctx * ctx).sum(-1, keepdim=True)
    if fault == "no row term":
        row_d = torch.zeros_like(row_d)
    s = (q @ k.transpose(-1, -2)) * scale + mask_row[:, None, None, :]
    p = torch.exp(s - big[..., None]) * inv[..., None]
    dp = dctx @ v.transpose(-1, -2)
    kf = torch.ones_like(p) if keep is None else keep
    if fault == "keep on p":
        ds = _rnd(p * kf * (dp - row_d) * scale)
    else:
        ds = _rnd(p * (dp * kf - row_d) * scale)
    pu = _rnd(p * kf)
    n = s.shape[-1]
    dq = sum(sum(ds[..., c0:c1] @ k[..., c0:c1, :] for c0, c1 in ch) for ch in _halves(n))
    dk = sum(sum(ds[..., c0:c1, :].transpose(-1, -2) @ q[..., c0:c1, :] for c0, c1 in ch)
             for ch in _halves(n))
    dv = sum(sum(pu[..., c0:c1, :].transpose(-1, -2) @ dctx[..., c0:c1, :] for c0, c1 in ch)
             for ch in _halves(n))
    return dq, dk, dv


def emulated_layer(x, mask_row, w, dout, heads, eps, *, p_attn=0.0, p_hidden=0.0, train=False,
                   seeds=None, fault=""):
    """The bf16 chain, forward and recompute backward, at its rounding
    points with core_forward / core_backward for the attention: (out, the
    thirteen gradients of bert_layer_bwd)."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    b, n, d = x.shape
    dh = d // heads
    scale = 1.0 / dh ** 0.5
    ka, k1, k2 = bl._masks(x, heads, p_attn, p_hidden, train, seeds)
    one = torch.ones((b, n, d))
    k1 = one if k1 is None else k1
    k2 = one if k2 is None else k2
    wq, wob, w1b, w2b = (_rnd(t) for t in (wqkv, wo, w1, w2))

    def heads_of(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    def merged(t):
        return t.transpose(1, 2).reshape(b, n, d)

    def rows(t):
        return t.reshape(b * n, -1)

    x32 = x.float()
    qkv = _rnd(x32 @ wq.t() + bqkv)                                    # QkvEpi
    q, k, v = (heads_of(t) for t in qkv.split(d, dim=-1))
    ctx_h, big, inv = core_forward(q, k, v, mask_row, ka, scale)
    ctx = merged(ctx_h)
    r1 = (ctx @ wob.t() + bo) * k1 + x32                               # HiddenEpi, site 1
    y, xhat1, rstd1 = bl._ln(r1, g1, be1, eps)
    h1 = _rnd(y) @ w1b.t() + b1                                        # GeluEpi
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    g = _rnd(h1 * cdf)
    r2 = (g @ w2b.t() + b2) * k2 + y                                   # HiddenEpi, site 2
    out, xhat2, rstd2 = bl._ln(r2, g2, be2, eps)

    dr2, dg2, dbe2 = bl._ln_bwd(dout.float(), xhat2, rstd2, g2)        # ln_bwd_kernel
    do2 = dr2 * k2
    dh1 = (_rnd(do2) @ w2b) * (cdf + h1 * 0.3989422804014327 * torch.exp(-0.5 * h1 * h1))
    dy = dr2 + _rnd(dh1) @ w1b                                         # AddF32Epi
    dr1, dg1, dbe1 = bl._ln_bwd(dy, xhat1, rstd1, g1)
    do1 = dr1 * k1
    dctx = _rnd(_rnd(do1) @ wob)                                       # DctxEpi
    dq, dk, dv = core_backward(q, k, v, ctx_h, heads_of(dctx), mask_row, ka, big, inv, scale,
                               fault)
    dqkv = torch.cat([merged(dq), merged(dk), merged(dv)], dim=-1)
    dx = _rnd(dr1 + _rnd(dqkv) @ wq)                                   # AddBf16Epi
    grads = (dx.to(x.dtype), rows(_rnd(dqkv)).t() @ rows(x32), dqkv.sum((0, 1)),
             rows(_rnd(do1)).t() @ rows(ctx), do1.sum((0, 1)), dg1, dbe1,
             rows(_rnd(dh1)).t() @ rows(_rnd(y)), dh1.sum((0, 1)),
             rows(_rnd(do2)).t() @ rows(g), do2.sum((0, 1)), dg2, dbe2)
    return out.to(x.dtype), grads


def _case(seed=70):
    a = _bert_inputs(np.random.default_rng(seed), B, N, D, F, list(LENGTHS))
    args = _torch_bert_args(a)
    args[0] = args[0].bfloat16()
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((B, N, D))
                            .astype(np.float32)).bfloat16()
    return a, args, dout


SEEDS = torch.tensor([123, 4567, 2 ** 30 + 5], dtype=torch.int32)


@pytest.mark.parametrize("kw", [{}, dict(TRAIN, seeds=SEEDS)], ids=["deterministic", "train"])
def test_emulated_chain_matches_plain(kw):
    _, args, dout = _case()
    out, got = emulated_layer(args[0], args[1], args[2:], dout, HEADS, EPS, **kw)
    assert _rel(out, bl.bert_layer_plain(*args, HEADS, EPS, **kw)) <= BAND
    want = bl.bert_layer_bwd_plain(*args, dout, HEADS, EPS, **kw)
    for name, x, y in zip(NAMES, got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert _rel(x, y) <= BAND, (name, _rel(x, y))


def test_emulated_chain_matches_jax_xla_vjp():
    """At p = 0 the chain's gradients against jax.vjp of bert_layer_xla in
    fp32 at the same bf16 values of x (the exact function; the chain's bf16
    rounding moves the gradients by ~5e-3). In bf16 the twin rounds at other
    points (y before the FF residual, the biases) and bert_layer_bwd_plain
    itself reads 1.5e-2 against it at this seed."""
    a, args, dout = _case(71)
    _, got = emulated_layer(args[0], args[1], args[2:], dout, HEADS, EPS)
    x, mask, *w = (jnp.asarray(a[k]) for k in BERT_KEYS)
    x = x.astype(jnp.bfloat16).astype(jnp.float32)
    _, vjp = jax.vjp(lambda x_, *w_: bert_layer_xla(x_, mask, *w_, HEADS, EPS), x, *w)
    want = vjp(jnp.asarray(dout.float().numpy()))
    for i, (name, g, j) in enumerate(zip(NAMES, got, want)):
        j = np.array(j, np.float32)
        if i in (1, 3, 7, 9):        # the matrices: the port's (out, in)
            j = np.ascontiguousarray(j.T)
        assert _rel(g, torch.from_numpy(j)) <= BAND, (name, _rel(g, torch.from_numpy(j)))


@pytest.mark.parametrize("fault", ["no row term", "keep on p"])
def test_faulty_cores_miss_the_band(fault):
    _, args, dout = _case()
    kw = dict(TRAIN, seeds=SEEDS)
    _, bad = emulated_layer(args[0], args[1], args[2:], dout, HEADS, EPS, fault=fault, **kw)
    want = bl.bert_layer_bwd_plain(*args, dout, HEADS, EPS, **kw)
    errs = {name: _rel(x, y) for name, x, y in zip(NAMES, bad, want)}
    assert max(errs.values()) > BAND, errs
    # the fault sits in the attention core: what lies downstream of it in the
    # backward stays in the band
    for name in ("dw2", "db2", "dg2", "dbe2", "dw1", "db1", "dwo", "dbo"):
        assert errs[name] <= BAND, (name, errs[name])


def test_row_term_from_ctx_matches_rowsum_dp_p():
    """D = rowsum(dctx ctx) of the bf16 dctx and ctx against the plain
    version's rowsum(dp p) (dp = dP keep): ctx's bf16 rounding moves it by
    ~2^-9 of |dctx| |ctx|."""
    _, args, dout = _case(72)
    x = args[0]
    wq = _rnd(args[2])
    qkv = _rnd(x.float() @ wq.t() + args[3])
    q, k, v = (t.reshape(B, N, HEADS, 64).transpose(1, 2) for t in qkv.split(D, dim=-1))
    keep = bl.philox_keep(SEEDS, 0, B, HEADS, N * N, 0.25).reshape(B, HEADS, N, N)
    ctx, big, inv = core_forward(q, k, v, args[1], keep, 0.125)
    dctx = _rnd(torch.randn(ctx.shape, generator=torch.Generator().manual_seed(3)))
    s = (q @ k.transpose(-1, -2)) * 0.125 + args[1][:, None, None, :]
    p = torch.exp(s - big[..., None]) * inv[..., None]
    want = (dctx @ v.transpose(-1, -2) * keep * p).sum(-1)
    got = (dctx * ctx).sum(-1)
    scale = (dctx.abs() * ctx.abs()).sum(-1)
    err = ((got - want).abs() / scale).max().item()
    assert err <= 2 ** -7, err


# ---- the Philox draw in fragment order --------------------------------------------

def keep_frag_tile(seeds, site, seq_of, idx_of, heads_idx, r0, c0, thresh, scale):
    """keep_frag for the 32 lanes of one 16 x 8 fragment tile at rows r0 ...,
    columns c0 ...: [16, 8] keep factors. seq_of / idx_of map a row and a
    group's first column to the slab's sequence and position."""
    out = torch.zeros((16, 8))
    words = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c = c0 + 2 * t
        row = r0 + g + (8 if lane & 1 else 0)      # the even lane draws row a, the odd row b
        ctr = [torch.tensor([v], dtype=torch.int64)
               for v in (idx_of(row, c & ~3) >> 2, site, seq_of(row), heads_idx)]
        key = [seeds[site].to(torch.int64).reshape(1) & 0xFFFFFFFF,
               torch.zeros(1, dtype=torch.int64)]
        words[lane] = [int(w_) for w_ in bl.philox4x32(*ctr, *key)]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        own, other = words[lane], words[lane ^ 1]
        if lane & 1:      # row a's words 2, 3 from the even partner; row b's own 2, 3
            w = [other[2], other[3], own[2], own[3]]
        else:             # row a's own 0, 1; row b's words 0, 1 from the odd partner
            w = [own[0], own[1], other[0], other[1]]
        for i, word in enumerate(w):
            out[g + 8 * (i >> 1), 2 * t + (i & 1)] = scale if word >= thresh else 0.0
    return out


@pytest.mark.parametrize("site", [0, 1, 2])
def test_fragment_order_philox_is_philox_keep(site):
    rate = 0.25 if site else 0.1
    thresh, scale = bl.dropout_threshold(rate), 1.0 / (1.0 - rate)
    npad = -(-N // KC) * KC
    if site == 0:
        want = bl.philox_keep(SEEDS, 0, B, HEADS, N * N, rate).reshape(B, HEADS, N, N)
        for bb, hh in ((0, 0), (1, 1)):
            got = torch.zeros((N, N))
            for r0 in range(0, N, 16):
                for c0 in range(0, N, 8):
                    got[r0:r0 + 16, c0:c0 + 8] = keep_frag_tile(
                        SEEDS, 0, lambda r: bb, lambda r, c: r * N + c, hh, r0, c0, thresh,
                        scale)
            assert torch.equal(got, want[bb, hh])
    else:
        # the hidden sites over the chain's rows m = sequence * npad + i
        want = bl.philox_keep(SEEDS, site, B, 1, N * D, rate).reshape(B, N, D)
        got = torch.zeros((B * npad, D))
        for r0 in range(0, B * npad, 16):
            for c0 in range(0, D, 8):
                got[r0:r0 + 16, c0:c0 + 8] = keep_frag_tile(
                    SEEDS, site, lambda r: r // npad, lambda r, c: (r % npad) * D + c, 0, r0, c0,
                    thresh, scale)
        assert torch.equal(got.reshape(B, npad, D)[:, :N], want)


def test_keep_bits_round_trip_through_both_passes():
    """The recompute forward packs the attention mask per row as words of 32
    keys (bit 8 (jt % 4) + 2 t + e of word 2 c + jt / 4 for key 64 c + 8 jt +
    2 t + e); the query pass tests (word >> bit) & 1 for its fragment's keys
    and the key pass its staged pair of words for its 64-key chunk."""
    npad = -(-N // KC) * KC
    keep = bl.philox_keep(SEEDS, 0, B, HEADS, N * N, 0.1).reshape(B, HEADS, N, N) > 0
    kept = torch.zeros((B, HEADS, npad, npad), dtype=torch.bool)
    kept[:, :, :N, :N] = keep
    words = torch.zeros((B, HEADS, npad, npad // 32), dtype=torch.int64)
    for c in range(npad // KC):
        for jt in range(8):
            for t in range(4):
                for e in range(2):
                    key = c * KC + 8 * jt + 2 * t + e
                    bit = 8 * (jt & 3) + 2 * t + e
                    words[..., 2 * c + (jt >> 2)] |= kept[..., key].long() << bit
    # the query pass, row r's keys
    for c in range(npad // KC):
        for jt in range(8):
            for t in range(4):
                for e in range(2):
                    key = c * KC + 8 * jt + 2 * t + e
                    got = (words[..., 2 * c + (jt >> 2)] >> (8 * (jt & 3) + 2 * t + e)) & 1
                    assert torch.equal(got.bool(), kept[..., key])
    # the key pass: the block's 64 keys kt0 ..., word kt0 / 64 * 2 + (kl >> 5), bit kl & 31
    for kt0 in range(0, npad, KC):
        pair = words[..., kt0 // KC * 2: kt0 // KC * 2 + 2]
        for kl in range(KC):
            got = (pair[..., kl >> 5] >> (kl & 31)) & 1
            assert torch.equal(got.bool(), kept[..., kt0 + kl])


# ---- the weight-gradient launches --------------------------------------------------

def bert_wgrad_tiles(rows0, cols0, rows1, cols1) -> list:
    """bh::BertWgradPlan::tile for every block: C0 = A0^T B0 (maps 0, 1;
    output 0) on the first tiles, C1 = A1^T B1 (maps 2, 3; output 1) after,
    each row-major over 128 x 128."""
    ct0, ct1 = -(-cols0 // TILE), -(-cols1 // TILE)
    tiles0 = -(-rows0 // TILE) * ct0
    tiles = []
    for t in range(tiles0 + -(-rows1 // TILE) * ct1):
        second = t >= tiles0
        u = t - tiles0 if second else t
        ct, rows = (ct1, rows1) if second else (ct0, rows0)
        i0, j0 = (u // ct) * TILE, (u % ct) * TILE
        tiles.append((2 if second else 0, 3 if second else 1, i0, j0, int(second), i0,
                      min(TILE, rows - i0)))
    return tiles


def _wgrad_case(seed=73, m=B * 128):
    g = torch.Generator().manual_seed(seed)

    def op(cols):
        return _rnd(torch.randn((m, cols), generator=g))

    return op


@pytest.mark.parametrize("launch", ["dW2 | dW1", "dWo | dWqkv"])
def test_wgrad_launches_cover_each_tile_once_in_any_order(launch):
    """At the layer's widths: D = 768, F = 3072 (144 + 144 tiles), D x D and
    3D x D (36 + 108)."""
    d, f = 768, 3072
    shapes = {"dW2 | dW1": (d, f, f, d), "dWo | dWqkv": (d, d, 3 * d, d)}[launch]
    rows0, cols0, rows1, cols1 = shapes
    tiles = bert_wgrad_tiles(*shapes)
    assert len(tiles) == {"dW2 | dW1": 288, "dWo | dWqkv": 144}[launch]
    covered = [torch.zeros((rows0, cols0), dtype=torch.int32),
               torch.zeros((rows1, cols1), dtype=torch.int32)]
    for _, _, i0, j0, o, orow0, nrows in tiles:
        covered[o][orow0:orow0 + nrows, j0:j0 + TILE] += 1
    assert all(bool((c == 1).all()) for c in covered)


def test_wgrad_tiles_same_bits_in_any_order_and_controls():
    """The tiles of a launch at test width (D = 128, F = 256 and 3D = 384)
    summed over the token slices in order: against the plain products within
    the band, the same bits in reverse order; a tile left out (NaN, as the
    output is never zeroed) or a token slice left out miss."""
    op = _wgrad_case()
    for rows0, cols0, rows1, cols1 in ((D, F, F, D), (D, D, 3 * D, D)):
        ops = [op(rows0), op(cols0), op(rows1), op(cols1)]
        tiles = bert_wgrad_tiles(rows0, cols0, rows1, cols1)

        def run(**kw):
            outs = [torch.full((rows0, cols0), math.nan), torch.full((rows1, cols1), math.nan)]
            return emulated_wgrad(ops, outs, tiles, **kw)

        fwd, rev = run(), run(order=range(len(tiles) - 1, -1, -1))
        want = [ops[0].t() @ ops[1], ops[2].t() @ ops[3]]
        for x, y, z in zip(fwd, rev, want):
            assert torch.equal(x, y)
            assert _rel(x, z) <= BAND
        for fault in (dict(unwritten=0), dict(unwritten=len(tiles) - 1), dict(drop_slice=SLICE)):
            bad = run(**fault)
            errs = [_rel(torch.nan_to_num(x, nan=0.0), z) for x, z in zip(bad, want)]
            assert max(errs) > BAND, (fault, errs)
