"""The designs of two card chains, emulated in torch on the CPU: the W8A8
GEGLU FF on the int8 wgmma path (csrc/geglu_ff_int8.cu) and the PEG
weight gradient as a shared-memory stencil reduction (csrc/peg_wgrad.cu).

geglu_ff_int8: the launch sequence over 128-row tiles, 64 value + 64 gate
columns a tile of the first product: LN and xn's codes; the product whose
epilogue writes h in fp32 tile by tile; h's row scales and codes over the
full padded width; the W2 product in 128-column tiles over 128-deep K
slices with TMA's zero fill past K. At a ragged N (77) with inner 1365
padded to 1376 (K = 10 x 128 + 96) it gives `geglu_ff_int8_plain`'s codes
and output bit for bit, residual off and on (h is computed tile by tile in
one thread: torch's vectorised erf takes every element of both shapes),
and it lies within test_torch_port_quant's band of the JAX Pallas kernel in
interpret mode. Control: one tile's h left out of the row scales. The
kernels' codes take v * (1 / s) where it cannot round otherwise than the
IEEE quotient v / s (`code_of`): emulated in fp32, the same codes as
torch.round(v / s), .5 ties and their neighbours included.

peg_weight_grads: the kernel's partition (`ops.peg.wgrad_partition`):
blocks of 64 channels x one video x a band of 6 rows x a column segment x
a chunk of frames, the x rows staged with a zero halo, each row's walk
along x in fp32 (the sliding window's order), the block's rows added in
order, the partials in order. Within 1e-5 relative of
`peg_weight_grads_plain` in fp32 for front 0, 1 and 2 at shapes whose H is
no multiple of the band, whose C is no multiple of 64, and (the second)
whose W takes two segments; within 1e-4 of the JAX Pallas kernel in
interpret mode; every (position, tap) visited exactly once. Controls: a
band left out, the halo taken as the edge value.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.ops import pallas_ff_int8 as jint8
from ct_clip_ut_tpu.ops.pallas_peg_bwd import peg_weight_grads as jax_peg_weight_grads
from ct_clip_ut_tpu_torch.ops import geglu_ff_int8 as tint8
from ct_clip_ut_tpu_torch.ops.peg import (WGRAD_ROWS, WGRAD_SLAB, front_pad,
                                          peg_weight_grads_plain, wgrad_partition)

from test_torch_port_quant import _ff_arrays, _jax_args, _port_args, _quantized, assert_int8_close

BM, BN, BK8 = 128, 128, 128       # the int8 core's tile rows, columns, K slice
H_TILE = 64                       # value (and gate) columns of a first-product tile


# ---- geglu_ff_int8 -----------------------------------------------------------

def _ln_codes(x, gamma, beta):
    """Launch (1): LN and xn's per-row codes, the plain version's steps."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    xn = (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5) * gamma.float() + beta.float()
    return tint8.row_quant(xn)


def _k_sliced_dot(a, b):
    """a [M, K] . b [N, K]^T of int8 codes in int32, K in slices of 128
    (the last zero-filled past K, as TMA fills it)."""
    k = a.shape[1]
    kp = -(-k // BK8) * BK8
    a, b = F.pad(a.int(), (0, kp - k)), F.pad(b.int(), (0, kp - k))
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32)
    for k0 in range(0, kp, BK8):
        out += a[:, k0:k0 + BK8] @ b[:, k0:k0 + BK8].t()
    return out


def _h_tile(xq, rx, wv, wg, sv, sg, nt):
    """The first product's tile nt: h [M, 64] in fp32 from 64 value and 64
    gate rows (rows past the padded width zero, as TMA fills them)."""
    ldh = wv.shape[0]
    rows = slice(nt * H_TILE, min(ldh, (nt + 1) * H_TILE))
    pad = H_TILE - (rows.stop - rows.start)
    cv = F.pad(_k_sliced_dot(xq, wv[rows]), (0, pad)).float()
    cg = F.pad(_k_sliced_dot(xq, wg[rows]), (0, pad)).float()
    value = cv * rx * F.pad(sv[rows].float(), (0, pad))
    gate = cg * rx * F.pad(sg[rows].float(), (0, pad))
    return (0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value).contiguous()


def int8_chain(x, gamma, beta, wv, wg, w2, sv, sg, s2, residual=False, drop_tile=None):
    """The card chain's four launches in torch on the CPU. Returns (out,
    xn's codes, h's codes). drop_tile leaves that tile's columns of h out
    of the row scales (the control)."""
    m, ldh = x.shape[0], wv.shape[0]
    tiles = -(-ldh // H_TILE)
    xq, rx = _ln_codes(x, gamma, beta)                                   # (1)
    h = torch.cat([_h_tile(xq, rx, wv, wg, sv, sg, nt) for nt in range(tiles)],
                  dim=1)[:, :ldh]                                         # (2) [M, ldh]
    kept = h if drop_tile is None else torch.cat(
        [h[:, :drop_tile * H_TILE], h[:, (drop_tile + 1) * H_TILE:]], dim=1)
    rh = (kept.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)      # (3)
    hq = torch.round(h / rh).to(torch.int8)
    out = torch.empty((m, x.shape[1]), dtype=torch.float32)
    for nt in range(-(-x.shape[1] // BN)):                                # (4)
        cols = slice(nt * BN, (nt + 1) * BN)
        y = _k_sliced_dot(hq, w2[cols]).float() * rh * s2[cols].float()
        out[:, cols] = y + x.float()[:, cols] if residual else y
    return out.to(x.dtype), xq, hq


def _plain_codes(x, ff):
    """geglu_ff_int8_plain's codes of xn and h, step by step."""
    xq, rx = _ln_codes(x, ff.gamma, ff.beta)
    value = tint8.int8_dot(xq, ff.wv_q).float() * rx * ff.sv
    gate = tint8.int8_dot(xq, ff.wg_q).float() * rx * ff.sg
    hq, _ = tint8.row_quant(0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value)
    return xq, hq


@pytest.fixture
def one_thread():
    """One intra-op thread: torch's erf then takes its vectorised path for
    every element of a [77, 64] tile and of the [77, 1376] row block alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("residual", [False, True])
def test_int8_chain_gives_the_plain_codes_and_output_bit_for_bit(one_thread, residual):
    a = _ff_arrays(np.random.default_rng(130), dim=64, inner=1365, n=77)
    jff, ff = _quantized(a)
    assert ff.wv_q.shape == (1376, 64) and 1376 == 10 * BK8 + 96
    x = torch.from_numpy(a["x"]).bfloat16()
    got, xq, hq = int8_chain(x, *_port_args(ff), residual=residual)
    want_xq, want_hq = _plain_codes(x, ff)
    assert torch.equal(xq, want_xq) and torch.equal(hq, want_hq)
    plain = tint8.geglu_ff_int8_plain(x, *_port_args(ff), residual=residual)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    kern = jint8.geglu_ff_int8(jnp.asarray(a["x"]).astype(jnp.bfloat16), *_jax_args(jff), True,
                               residual)
    xj = np.asarray(jnp.asarray(a["x"]).astype(jnp.bfloat16).astype(jnp.float32))
    assert_int8_close(got.float().numpy(), np.asarray(kern.astype(jnp.float32)), xj, jff, ff)


def test_int8_chain_without_a_tile_in_the_row_scale_is_caught(one_thread):
    """Leaving the tile that holds row 0's absmax of h out of the row
    scales shrinks that row's scale: codes overflow, and the output leaves
    both bands."""
    a = _ff_arrays(np.random.default_rng(131), dim=64, inner=1365, n=77)
    jff, ff = _quantized(a)
    x = torch.from_numpy(a["x"]).bfloat16()
    xq, rx = _ln_codes(x, ff.gamma, ff.beta)
    tiles = -(-ff.wv_q.shape[0] // H_TILE)
    row0 = torch.cat([_h_tile(xq, rx, *_port_args(ff)[2:4], *_port_args(ff)[5:7], nt)[0]
                      for nt in range(tiles)])
    drop = int(row0.abs().argmax()) // H_TILE
    got, _, hq = int8_chain(x, *_port_args(ff), drop_tile=drop)
    plain = tint8.geglu_ff_int8_plain(x, *_port_args(ff))
    assert not torch.equal(hq, _plain_codes(x, ff)[1])
    assert ((got.float() - plain.float()).norm() / plain.float().norm()).item() > 2e-3
    kern = jint8.geglu_ff_int8(jnp.asarray(a["x"]).astype(jnp.bfloat16), *_jax_args(jff), True,
                               False)
    xj = np.asarray(jnp.asarray(a["x"]).astype(jnp.bfloat16).astype(jnp.float32))
    with pytest.raises(AssertionError):
        assert_int8_close(got.float().numpy(), np.asarray(kern.astype(jnp.float32)), xj, jff, ff)


def code_of(v, s):
    """The kernels' code_of in fp32: v * (1 / s) rounded half to even,
    unless it lies within 2^-20 (|q| + 1) of a .5 boundary, where the
    quotient v / s is taken."""
    inv = (1.0 / s).float()
    q = v * inv
    n = torch.round(q)
    near = ((q - n).abs() - 0.5).abs() <= 9.5367431640625e-07 * (q.abs() + 1.0)
    return torch.where(near, torch.round(v / s), n).to(torch.int8), near


def test_code_fast_path_gives_the_quotients_codes():
    """On h rows of the FF (random scales) and on values placed at .5
    boundaries of the codes and a few ulps either side, the fast path's
    codes equal torch.round(v / s) (IEEE quotient, half to even)."""
    rng = np.random.default_rng(132)
    s = torch.from_numpy((rng.uniform(0.5, 2.0, (64, 1)) * 10.0 ** rng.integers(-6, 3, (64, 1)))
                         .astype(np.float32))
    v = torch.from_numpy(rng.uniform(-127, 127, (64, 4096)).astype(np.float32)) * s
    half = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    ties = (half * s).repeat(1, 5)
    ulps = torch.tensor([-2, -1, 0, 1, 2], dtype=torch.float32).repeat_interleave(half.numel())
    ties = ties + ulps * torch.finfo(torch.float32).eps * ties.abs()
    nears = []
    for vals in (v, ties):
        got, near = code_of(vals, s)
        assert torch.equal(got, torch.round(vals / s).to(torch.int8))
        nears.append(near)
    # the quotient is taken near every boundary, and almost nowhere else
    assert nears[1].all() and nears[0].float().mean() < 1e-3


# ---- peg_weight_grads ----------------------------------------------------------

def peg_wgrad_chain(x, g, front, skip_band=None, halo="zeros", visits=None):
    """The card kernel's partition in torch: (dw [c, 1, 3, 3, 3], db [c]).
    Each block (slab, video, chunk, band, segment) walks its rows along x
    in fp32, the sums of a row kept apart; the block adds its rows in order
    and the partials are added in (video, chunk, band, segment) order.
    skip_band leaves one band out and halo="edge" stages the edge value in
    the halo (the controls); visits [b, t, h, w, 27] counts each (position,
    tap) a walk takes."""
    b, t, h, w, c = x.shape
    tc, wseg, parts = wgrad_partition(b, t, h, w, c)
    rows = WGRAD_ROWS
    bands, segs, tchunks = -(-h // rows), -(-w // wseg), -(-t // tc)
    assert parts == b * tchunks * bands * segs
    x32, g32 = x.float(), g.float()
    # the staged video: a zero frame halo (front before, 2 - front after), a
    # one-wide spatial halo of zeros (or of the edge value), rows and columns
    # past the last band and segment zero, channels to whole slabs
    cp = -(-c // WGRAD_SLAB) * WGRAD_SLAB
    hp, wp = bands * rows, segs * wseg
    spatial = F.pad(x32.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w), (1, 1, 1, 1),
                    mode="replicate" if halo == "edge" else "constant")
    xs = spatial.reshape(b, t, c, h + 2, w + 2).permute(0, 1, 3, 4, 2)
    xs = F.pad(xs, (0, cp - c, 0, wp - w, 0, hp - h, front, 2 - front))
    gs = F.pad(g32, (0, cp - c, 0, wp - w, 0, hp - h))
    partial = torch.zeros((parts, 28, cp))
    for p in range(parts):
        seg, rest = p % segs, p // segs
        band, rest = rest % bands, rest // bands
        chunk, bi = rest % tchunks, rest // tchunks
        if band == skip_band:
            continue
        y0, x0 = band * rows, seg * wseg
        acc = torch.zeros((28, rows, cp))          # [tap, warp (row), channel]
        for ti in range(chunk * tc, min(t, (chunk + 1) * tc)):
            for xi in range(min(wseg, w - x0)):
                gv = gs[bi, ti, y0:y0 + rows, x0 + xi]                  # [rows, cp]
                acc[27] += gv
                for dt in range(3):
                    for dh in range(3):
                        for dw in range(3):
                            xv = xs[bi, ti + dt, y0 + dh:y0 + dh + rows, x0 + xi + dw]
                            acc[9 * dt + 3 * dh + dw] += xv * gv
                if visits is not None:
                    visits[bi, ti, y0:min(h, y0 + rows), x0 + xi] += 1
        block = torch.zeros((28, cp))
        for r in range(rows):                      # the block's rows, in order
            block += acc[:, r]
        partial[p] = block
    dwb = torch.zeros((28, cp))
    for p in range(parts):                         # the partials, in order
        dwb += partial[p]
    dwb = dwb[:, :c]
    return dwb[:27].t().reshape(c, 1, 3, 3, 3), dwb[27]


def _video(seed, shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return x, g


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


SHAPES = [(1, 5, 7, 9, 24), (2, 4, 13, 30, 72)]


@pytest.mark.parametrize("front", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_peg_wgrad_chain_matches_plain(shape, front):
    x, g = _video(170 + front, shape)
    got_dw, got_db = peg_wgrad_chain(x, g, front)
    want_dw, want_db = peg_weight_grads_plain(x, g, front)
    assert _rel(got_dw, want_dw) <= 1e-5 and _rel(got_db, want_db) <= 1e-5
    xb, gb = x.bfloat16(), g.bfloat16()
    bf_dw, bf_db = peg_wgrad_chain(xb, gb, front)
    want_dw, want_db = peg_weight_grads_plain(xb, gb, front)
    assert _rel(bf_dw, want_dw) <= 1e-5 and _rel(bf_db, want_db) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_peg_wgrad_chain_matches_pallas_kernel(causal):
    x, g = _video(175, SHAPES[0])
    dw, db = jax_peg_weight_grads(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), causal=causal,
                                  interpret=True)
    got_dw, got_db = peg_wgrad_chain(x, g, front_pad(causal))
    want = np.asarray(dw).transpose(4, 3, 0, 1, 2)                          # DHWIO -> Conv3d
    np.testing.assert_allclose(got_dw.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(db), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_peg_wgrad_chain_visits_every_position_and_tap_once(shape):
    b, t, h, w, c = shape
    x, g = _video(176, shape)
    visits = torch.zeros((b, t, h, w), dtype=torch.int32)
    peg_wgrad_chain(x, g, 2, visits=visits)
    assert (visits == 1).all()
    # (and each visit takes all 27 taps: with x and g all ones, dw counts
    # the neighbours inside the video, as the plain version does)
    ones = torch.ones(shape)
    got_dw, got_db = peg_wgrad_chain(ones, ones, 1)
    want_dw, want_db = peg_weight_grads_plain(ones, ones, 1)
    assert torch.equal(got_dw, want_dw) and torch.equal(got_db, want_db)
    assert got_db[0].item() == b * t * h * w


@pytest.mark.parametrize("shape", SHAPES)
def test_peg_wgrad_chain_controls_leave_the_band(shape):
    x, g = _video(177, shape)
    want_dw, want_db = peg_weight_grads_plain(x, g, 2)
    dw, db = peg_wgrad_chain(x, g, 2, skip_band=1)
    assert _rel(dw, want_dw) > 1e-2 and _rel(db, want_db) > 1e-2
    dw, _ = peg_wgrad_chain(x, g, 2, halo="edge")
    assert _rel(dw, want_dw) > 1e-2
