"""What the CPU can check of the staged split weight gradient of rows 11f
and 9F (`wgrad4_kernel` in csrc/wgrad_sm90.cuh under
`ctc_patch_embed_dkw_f32`'s PatchWgradSplitPlan and `ctc_geglu_ff_bwd_f32`'s
FFWgradSplitPlan) and of F11, the row term of the spatial fp32 backward
(csrc/attn_bwd_wg.cuh).

The kernels run only on the card (chip_smoke.py phase 14 and the card tests
`-k "fp32_full or fp32_patch_embed"` hold them against the plain versions
there; phase 14 holds the spatial chain against a float64 block over close
patches). Here:

(a) F11: a stack of two spatial blocks (residual, with the bias) over
frames of patches 2% apart (adjacent patches of a frame lie that close), a
cotangent on each frame's first patch, each layer's query / key weight
gradients and the stack's dx from the spatial chain emulated plane by
plane (tests/test_torch_port_f32_bwd_hopper.py's wgmma passes) against
jax.vjp of the XLA twins' stack (`_xla_reference_block`). The row term D =
rowsum(P dP) / rowsum(P) from the same split S and dP (the row term's walk)
stays within CLOSE_BAND, as the plain fp32 backward does; the first
design's D = rowsum(dO o) from o's and dO's planes misses it, and so does
the one-pass control (every lo plane zero).

(b) PatchWgradSplitPlan's tiles, mirrored from csrc/: every element of dkw
written by one tile (the ragged last row tile's rows past K stored by
none). FFWgradSplitPlan's are test_torch_port_f32_train_hopper.py's.

(c) The staged sums: each tile's sums in wgrad4_kernel's order (per
64-token slice, per 16-deep step a_hi b_lo, a_lo b_hi, a_hi b_hi into one
accumulator, added into fp32 sums every WG4_FLUSH slices and after the
last slice) within WGRAD_BAND of the fp64 product; the last flush left out
misses it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_block import _xla_reference_block
from ct_clip_ut_tpu_torch.ops import attn_block

from test_torch_port_cuda import _attn_inputs, _torch_attn_args
from test_torch_port_f32_bwd_hopper import emulated_block_bwd_f32_wg
from test_torch_port_f32_hopper import _split
from test_torch_port_f32_train_hopper import BM, BN, _written, ff_wgrad_tiles

CLOSE_BAND = 1e-2    # (a): the query / key weight gradients and dx over close tokens (F10's)
WGRAD_BAND = 2e-5    # (c): a staged tile against the fp64 product
SCALE = 8.0
SLICE, STEP = 64, 16  # tokens a slice, a wgmma step's depth
WG4_FLUSH = 2         # slices between the staged kernel's flushes (csrc/wgrad_sm90.cuh)
NAMES = ("gamma", "wq", "wk", "wv", "wo", "qs", "ks", "bias")
LAYERS = 2


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- (a) F11: the spatial chain's row term over close tokens ----------------------

@functools.lru_cache(maxsize=2)
def _close_frames(r, n):
    """Two spatial blocks (residual, bias) over r frames of n patches 2%
    apart, a cotangent on each frame's first patch: (each layer's input from
    the plain forward, each layer's weights and bias, the cotangent, jax.vjp
    of the XLA twins' stack with respect to x and every layer's parameters)."""
    rng = np.random.default_rng(110 + n)
    cases = [_attn_inputs(np.random.default_rng(111 + n + i), r, n, 64, 4, 32, True)
             for i in range(LAYERS)]
    base = rng.standard_normal((r, 1, 64)).astype(np.float32)
    x0 = (base + 0.02 * cases[0]["x"]).astype(np.float32)
    g = np.zeros_like(x0)
    g[:, 0] = rng.standard_normal((r, 64))
    ws = [(*_torch_attn_args(c)[1:], torch.from_numpy(c["bias"])) for c in cases]
    xs = [torch.from_numpy(x0)]
    for w in ws[:-1]:
        xs.append(attn_block.attn_block_plain(xs[-1], *w, SCALE, True))
    jw = [jnp.asarray(c[k]) for c in cases for k in NAMES]

    def stack(x, *flat):
        for i in range(LAYERS):
            x = _xla_reference_block(x, *flat[8 * i:8 * i + 8], SCALE, True)
        return x

    twin = jax.jit(lambda x, *f: jax.vjp(stack, x, *f)[1](jnp.asarray(g)))(jnp.asarray(x0), *jw)
    return xs, ws, torch.from_numpy(g), [np.asarray(t) for t in twin]


def _close_frame_errors(r, n, **scheme):
    """Each layer's dWq, dWk (and the stack's dx) from the chain (scheme:
    d_from_o, one_pass, or plain: the port's plain backward), each layer
    propagating its own dx, against the twins' stack, each over its largest
    entry."""
    xs, ws, dout, twin = _close_frames(r, n)
    errs = []
    for i in reversed(range(LAYERS)):
        if scheme.get("plain"):
            got = attn_block.attn_block_bwd_plain(xs[i], *ws[i], dout, SCALE, True)[:4]
            dx, dwq, dwk = got[0], got[2], got[3]
        else:
            dx, dwq, dwk = emulated_block_bwd_f32_wg(
                xs[i], *ws[i], dout, SCALE, True, params=True,
                d_from_o=scheme.get("d_from_o", False), one_pass=scheme.get("one_pass", False))
        errs += [_rel_err(dwq, twin[1 + 8 * i + 1].T), _rel_err(dwk, twin[1 + 8 * i + 2].T)]
        dout = dx
    return errs + [_rel_err(dout, twin[0])]


@pytest.mark.parametrize("r,n", [(4, 64), (2, 130)])
@pytest.mark.parametrize("scheme,inside", [({}, True), ({"plain": True}, True),
                                           ({"d_from_o": True}, False),
                                           ({"one_pass": True}, False)])
def test_spatial_row_term_keeps_the_cancelling_query_key_gradients(r, n, scheme, inside):
    """(a) F11: the row term's walk (D = rowsum(P dP) from the same split
    dP) keeps every layer's query / key weight gradients and dx within
    CLOSE_BAND of the XLA twins' stack, as the plain fp32 backward does
    (n = 130: a ragged third key tile); the first design's D from o's
    product misses it, and so does the one-pass control."""
    errs = _close_frame_errors(r, n, **scheme)
    assert (max(errs) <= CLOSE_BAND) == inside, errs


# ---- (b) PatchWgradSplitPlan's tiles, mirrored ------------------------------------

def patch_wgrad_tiles(k, dim):
    """PatchWgradSplitPlan's tiles (map a, map b, i0, j0, out, orow0, nrows):
    ceil(K / 128) row tiles x ceil(dim / 128) column tiles, row-major."""
    col_tiles = -(-dim // BN)
    return [(0, 2, (t // col_tiles) * BM, (t % col_tiles) * BN, 0, (t // col_tiles) * BM,
             min(BM, k - (t // col_tiles) * BM))
            for t in range(-(-k // BM) * col_tiles)]


@pytest.mark.parametrize("k,dim", [(4000, 512), (200, 64), (256, 384)])
def test_patch_wgrad_split_plan_writes_dkw_once(k, dim):
    """11f's plan: every element of [K, dim] written once (the ragged last
    row tile, columns past dim masked by the store); at B = 2's K = 4,000,
    dim 512, 128 tiles in one wave on the 132 SMs."""
    tiles = patch_wgrad_tiles(k, dim)
    (seen,) = _written(tiles, [(k, dim)])
    assert (seen == 1).all()
    if (k, dim) == (4000, 512):
        assert len(tiles) == 128 and tiles[-1][-1] == 32


# ---- (c) the staged sums ----------------------------------------------------------

def _box(t, k0, c0):
    """A TMA box of 64 columns x 64 tokens of t [M, cols]: zeros past either edge."""
    box = torch.zeros((SLICE, 64))
    part = t[k0:k0 + SLICE, c0:c0 + 64]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def _operand(planes, k0, c0):
    """A stage's two planes (hi, lo) of one operand's 128 columns for the
    slice at k0, as its two boxes each."""
    return [torch.cat([_box(p, k0, c0), _box(p, k0, c0 + 64)], dim=1) for p in planes]


def staged_wgrad(ops, outs, tiles, last_flush=True):
    """wgrad4_kernel over the plan's tiles (ops: each map's plane, hi maps
    even, lo at + 1): per slice, the stage's four planes; per 16-deep step
    a_hi b_lo, a_lo b_hi, a_hi b_hi into the accumulator, added into the
    sums every WG4_FLUSH slices and after the last (last_flush=False: that
    one left out, the control); the epilogue stores rows < nrows, columns <
    the output's."""
    tokens = ops[0].shape[0]
    for a, b, i0, j0, o, orow0, nrows in tiles:
        acc, sums = torch.zeros((BM, BN)), torch.zeros((BM, BN))
        for kt, k0 in enumerate(range(0, tokens, SLICE)):
            ah, al = _operand(ops[a:a + 2], k0, i0)
            bh, bl = _operand(ops[b:b + 2], k0, j0)
            for s0 in range(0, SLICE, STEP):
                st = slice(s0, s0 + STEP)
                for x, y in ((ah, bl), (al, bh), (ah, bh)):
                    acc = acc + x[st].t() @ y[st]
            if (kt + 1) % WG4_FLUSH == 0 or (last_flush and k0 + SLICE >= tokens):
                sums, acc = sums + acc, torch.zeros_like(acc)
        if nrows > 0:
            out = outs[o]
            ncols = max(0, min(BN, out.shape[1] - j0))
            out[orow0:orow0 + nrows, j0:j0 + ncols] = sums[:nrows, :ncols]
    return outs


def _planes(*mats):
    return [p for m in mats for p in _split(m)]


def _patch_case():
    """11f at a small size: P [150, 200] (K = 200: a ragged row tile; 150
    tokens: a ragged third slice), dconv [150, 64] (columns past dim
    masked): dkw = P^T dconv."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.standard_normal((150, 200)).astype(np.float32))
    dconv = torch.from_numpy(rng.standard_normal((150, 64)).astype(np.float32))
    want = p.double().t() @ dconv.double()
    return _planes(p, dconv), patch_wgrad_tiles(200, 64), [(200, 64)], [want]


def _ff_case():
    """9F at a small size: N = 150 tokens (a ragged third slice), D = 128,
    inner 100 (ldh 104; a value tile's columns past inner read gate
    columns): dW2 = g^T h, [dWv; dWg] = [dvalue | dgate]^T xn."""
    n, d, inner, ldh = 150, 128, 100, 104
    rng = np.random.default_rng(6)

    def mat(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    g, xn, h, dv, dg = mat(n, d), mat(n, d), mat(n, inner), mat(n, inner), mat(n, inner)
    hp = torch.zeros((n, ldh))
    hp[:, :inner] = h
    dvg = torch.zeros((n, 2 * ldh))
    dvg[:, :inner], dvg[:, ldh:ldh + inner] = dv, dg
    want = [g.double().t() @ h.double(),
            torch.cat([dv, dg], dim=1).double().t() @ xn.double()]
    return (_planes(g, hp, dvg, xn), ff_wgrad_tiles(d, inner, ldh), [(d, inner), (2 * inner, d)],
            want)


@pytest.mark.parametrize("case", [_patch_case, _ff_case])
def test_staged_sums_match_the_fp64_product(case):
    """(c): every output element within WGRAD_BAND of the fp64 products;
    the last flush left out (the third slice's sums lost) misses it."""
    ops, tiles, shapes, want = case()

    def run(**kw):
        return staged_wgrad(ops, [torch.full(s, float("nan")) for s in shapes], tiles, **kw)

    for got, lost, w in zip(run(), run(last_flush=False), want):
        assert _rel_err(got, w) <= WGRAD_BAND
        assert _rel_err(lost, w) > WGRAD_BAND
