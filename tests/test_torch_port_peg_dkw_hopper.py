"""The designs of two card kernels, emulated in torch on the CPU: the PEG
stencil as a staged shared-memory stencil (csrc/peg.cu) and the patch
embed's projection weight gradient on the MN-major weight-gradient core
over the patch matrix (csrc/patch_embed_dkw.cu, PatchWgradPlan on
csrc/wgrad_sm90.cuh).

peg: the kernel's partition (`ops.peg.stencil_partition`): blocks of 64
channels x one video x a band of 12 rows (6 in fp32) x a column segment x
a chunk of frames; each chunk's three-frame warm-up and the ring of four
frame slots (the emulation checks that every slot it reads holds the frame
it wants);
the staged tile with a zero halo; each row's walk along x with the sliding
window of three columns, the 27 products in tap order in fp32, the bias,
the centre input from the window. Within 1e-5 relative of `peg_plain` in
fp32 for front 0, 1 and 2 at shapes whose H is no multiple of the band,
whose C is no multiple of 64 (24, 72) and (the second) whose W takes two
segments; within 1e-4 of the JAX Pallas `peg_fused` in interpret mode; every
(position, tap) visited exactly once. Controls: a band left out, the halo
taken as the edge value.

patch_embed_dkw: PatchWgradPlan's tiles of [K, dim] (row tiles of 128 P
columns, the last one ragged, x column tiles of 128), each summed over the
64-token slices in order with P's columns past K read as zeros (TMA's fill)
and stored over an output that is never zeroed. At small patch geometries,
one whose K (144) is no multiple of 128 and one with the flagship's patch
(K = 4000: 32 row tiles, the last of 32 rows): within FLOAT_BAND of
`patch_embed_dkw_plain` and within test_torch_port_train_kernels' tolerance
of the JAX `_dkw_impl` in interpret mode; any tile order gives the same
bits. Controls: the last row tile's rows dropped, wv / cin swapped.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_patch_embed import _dkw_impl
from ct_clip_ut_tpu.ops.pallas_peg import peg_fused
from ct_clip_ut_tpu_torch.ops.patch_embed import _patches, patch_embed_dkw_plain
from ct_clip_ut_tpu_torch.ops.peg import (STENCIL_BLOCKS, STENCIL_ROWS, WGRAD_SLAB, front_pad,
                                          peg_plain, stencil_partition, wgrad_partition)

from test_torch_port_split import FLOAT_BAND, TILE, emulated_wgrad
from test_torch_port_train_kernels import ATOL, RTOL

SLOTS = 4                         # frame slots of the stencil's ring


# ---- peg -----------------------------------------------------------------------

def peg_stencil_chain(x, taps, bias, front, rows=None, skip_band=None, halo="zeros",
                      visits=None):
    """The card kernel's partition and walk in torch: out [b, t, h, w, c]
    in x's dtype, with bands of `rows` rows (x's dtype's by default: 12 for
    bf16, 6 for fp32). skip_band leaves one band out (its outputs stay zero) and
    halo="edge" stages the edge value in the spatial halo (the controls);
    visits [b, t, h, w] counts the walks that reach each output position.
    All rows of a band go at once ([rows, cp] a column); each row walks
    along x with the window of three columns."""
    b, t, h, w, c = x.shape
    if rows is None:
        rows, tc, wseg, parts = stencil_partition(x)
    else:
        tc, wseg, parts = wgrad_partition(b, t, h, w, c, rows, STENCIL_BLOCKS)
    bands, segs, tchunks = -(-h // rows), -(-w // wseg), -(-t // tc)
    assert parts == b * tchunks * bands * segs
    # the video as the blocks stage it: a one-wide spatial halo of zeros (or
    # of the edge value), rows and columns past the last band and segment
    # zero, channels to whole slabs; frame fi of the video is frame fi + 2
    cp = -(-c // WGRAD_SLAB) * WGRAD_SLAB
    hp, wp = bands * rows, segs * wseg
    spatial = F.pad(x.float().permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w), (1, 1, 1, 1),
                    mode="replicate" if halo == "edge" else "constant")
    xs = spatial.reshape(b, t, c, h + 2, w + 2).permute(0, 1, 3, 4, 2)
    xs = F.pad(xs, (0, cp - c, 0, wp - w, 0, hp - h, 2, 2))
    tp = F.pad(taps.float(), (0, cp - c))
    bp = None if bias is None else F.pad(bias.float(), (0, cp - c))
    out = torch.zeros((b, t, h, w, cp))
    for p in range(parts):
        seg, rest = p % segs, p // segs
        band, rest = rest % bands, rest // bands
        chunk, bi = rest % tchunks, rest // tchunks
        if band == skip_band:
            continue
        y0, x0 = band * rows, seg * wseg
        ws = min(wseg, w - x0)
        t0, t1 = chunk * tc, min(t, (chunk + 1) * tc)
        ring = [None] * SLOTS

        def stage(fi):
            """Frame fi's (rows + 2) x (wseg + 2) tile into slot (fi + 4) % 4."""
            ring[(fi + SLOTS) % SLOTS] = (fi, xs[bi, fi + 2, y0:y0 + rows + 2,
                                                 x0:x0 + wseg + 2])

        for dt in range(3):                        # the warm-up
            stage(t0 - front + dt)
        if t0 + 1 < t1:
            stage(t0 - front + 3)
        for ti in range(t0, t1):
            tiles = []
            for dt in range(3):
                fi = ti - front + dt
                held, tile = ring[(fi + SLOTS) % SLOTS]
                assert held == fi, (held, fi)      # the ring holds the frame read
                tiles.append(tile)
            def column(ci):
                return [tiles[dt][dh:dh + rows, ci] for dt in range(3) for dh in range(3)]

            win = [column(0), column(1), None]
            for xi in range(ws):
                win[(xi + 2) % 3] = column(xi + 2)
                acc = torch.zeros((rows, cp))
                for k in range(9):
                    for dw in range(3):
                        acc = acc + win[(xi + dw) % 3][k] * tp[3 * k + dw]
                if bp is not None:
                    acc = acc + bp
                acc = acc + win[(xi + 1) % 3][3 * front + 1]      # the centre input
                n = min(rows, h - y0)
                out[bi, ti, y0:y0 + n, x0 + xi] = acc[:n]
                if visits is not None:
                    visits[bi, ti, y0:y0 + n, x0 + xi] += 1
            if ti + 2 < t1:
                stage(ti - front + 4)
    return out[..., :c].to(x.dtype)


def _video(seed, shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    taps = torch.from_numpy((rng.standard_normal((27, c)) / 5.0).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    return x, taps, bias


def _rel(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return ((got - want).abs().max() / want.abs().max()).item()


PEG_SHAPES = [(1, 5, 7, 9, 24), (2, 4, 13, 30, 72)]


@pytest.mark.parametrize("front", [0, 1, 2])
@pytest.mark.parametrize("shape", PEG_SHAPES)
def test_peg_stencil_chain_matches_plain(shape, front):
    """In fp32, with the bands of both dtypes' partitions (12 rows: one band
    at H = 7, two at H = 13)."""
    x, taps, bias = _video(180 + front, shape)
    for rows in sorted(set(STENCIL_ROWS.values())):
        for b in (bias, None):
            got = peg_stencil_chain(x, taps, b, front, rows)
            assert _rel(got - x, peg_plain(x, taps, b, front) - x) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_peg_stencil_chain_matches_pallas_kernel(causal):
    x, taps, bias = _video(184, PEG_SHAPES[0])
    c = x.shape[-1]
    want = np.asarray(peg_fused(jnp.asarray(x.numpy()), jnp.asarray(taps.numpy()).reshape(27, c),
                                jnp.asarray(bias.numpy()), causal, True))
    got = peg_stencil_chain(x, taps, bias, front_pad(causal))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", PEG_SHAPES)
def test_peg_stencil_chain_visits_every_position_and_tap_once(shape):
    """Each output position is walked once, and each walk takes all 27
    taps: with ones for x and the taps and no bias, every output counts
    the neighbours inside the video plus the centre, as the plain version
    does."""
    b, t, h, w, c = shape
    x, taps, _ = _video(185, shape)
    for rows in sorted(set(STENCIL_ROWS.values())):
        visits = torch.zeros((b, t, h, w), dtype=torch.int32)
        peg_stencil_chain(x, taps, None, 2, rows, visits=visits)
        assert (visits == 1).all()
    ones = torch.ones(shape)
    for front in (0, 1, 2):
        got = peg_stencil_chain(ones, torch.ones((27, c)), None, front)
        assert torch.equal(got, peg_plain(ones, torch.ones((27, c)), None, front))
    assert got.max().item() == 28


@pytest.mark.parametrize("shape", PEG_SHAPES)
def test_peg_stencil_chain_controls_leave_the_band(shape):
    x, taps, bias = _video(186, shape)
    want = peg_plain(x, taps, bias, 2) - x
    assert _rel(peg_stencil_chain(x, taps, bias, 2, skip_band=1) - x, want) > 1e-2
    assert _rel(peg_stencil_chain(x, taps, bias, 2, halo="edge") - x, want) > 1e-2
    assert _rel(peg_stencil_chain(x, taps, bias, 2, 12, skip_band=0) - x, want) > 1e-2


# ---- patch_embed_dkw ------------------------------------------------------------

def patch_wgrad_tiles(k: int, dim: int) -> list:
    """pe::PatchWgradPlan::tile for every block, in the tuple of
    test_torch_port_split.emulated_wgrad: (A = P, B = dconv, P's first
    column, dconv's first column, output 0, first output row, rows)."""
    col_tiles = -(-dim // TILE)
    tiles = []
    for t in range(-(-k // TILE) * col_tiles):
        i0, j0 = (t // col_tiles) * TILE, (t % col_tiles) * TILE
        tiles.append((0, 1, i0, j0, 0, i0, min(TILE, k - i0)))
    return tiles


def dkw_chain(image, dconv, patch, t_patch, tiles=None, order=None):
    """dkw [wv, cin, dim] fp32 as the card computes it: P from the volume
    (the patchify pass, bf16 as the volume), the tiles over an output of
    NaN (never zeroed), each row k = c * patch + wv of [K, dim] stored as
    row (wv, c) (pe::DkwStoreEpi)."""
    p = _patches(image, patch, t_patch).float()
    k, dim = p.shape[1], dconv.shape[1]
    sums = torch.full((k, dim), float("nan"))
    emulated_wgrad([p, dconv.float()], [sums], tiles or patch_wgrad_tiles(k, dim), order=order)
    out = torch.full((patch, k // patch, dim), float("nan"))
    for row in range(k):
        out[row % patch, row // patch] = sums[row]
    return out


# (b, T, H, W, patch, t_patch, dim): K = 32 in one ragged row tile and 128
# tokens in two slices; K = 144 in two row tiles (the last of 16 rows) and a
# dim of 136 in two column tiles; the flagship patch, K = 4000 in 32 row
# tiles, the last of 32 rows
DKW_CASES = [(2, 8, 16, 16, 4, 2, 64), (1, 8, 12, 18, 6, 4, 136), (1, 10, 40, 40, 20, 10, 128)]


def _dkw_case(seed, b, T, H, W, patch, t_patch, dim):
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.standard_normal((b, 1, T, H, W)).astype(np.float32)).bfloat16()
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    dconv = torch.from_numpy(rng.standard_normal((m, dim)).astype(np.float32)).bfloat16()
    return image, dconv


@pytest.mark.parametrize("case", DKW_CASES)
def test_dkw_tiles_match_plain_and_pallas_kernel(case):
    b, T, H, W, patch, t_patch, dim = case
    image, dconv = _dkw_case(190, *case)
    got = dkw_chain(image, dconv, patch, t_patch)
    assert torch.isfinite(got).all()
    assert _rel(got, patch_embed_dkw_plain(image, dconv, patch, t_patch)) <= FLOAT_BAND
    want = _dkw_impl(jnp.asarray(image.float().numpy()),
                     jnp.asarray(dconv.float().numpy()).reshape(b, T // t_patch, H // patch,
                                                                W // patch, dim),
                     patch=patch, t_patch=t_patch, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", DKW_CASES[1:])
def test_dkw_tiles_same_bits_in_any_order_and_controls(case):
    """The plan's tiles: the last row tile is the ragged one, every row of
    [K, dim] is written by exactly one row tile and column tile. Reversed
    tiles give the same bits. Controls: the last row tile's rows dropped
    (its rows stay as the never-zeroed output left them, NaN here, read as
    0), wv / cin swapped."""
    b, T, H, W, patch, t_patch, dim = case
    image, dconv = _dkw_case(191, *case)
    k = t_patch * patch * patch
    tiles = patch_wgrad_tiles(k, dim)
    col_tiles = -(-dim // TILE)
    assert len(tiles) == -(-k // TILE) * col_tiles
    assert tiles[-1][6] == k - (-(-k // TILE) - 1) * TILE < TILE
    assert sum(t[6] for t in tiles) == k * col_tiles
    got = dkw_chain(image, dconv, patch, t_patch)
    assert torch.equal(got, dkw_chain(image, dconv, patch, t_patch,
                                      order=range(len(tiles) - 1, -1, -1)))
    plain = patch_embed_dkw_plain(image, dconv, patch, t_patch)
    dropped = [t[:6] + (0,) if t[2] == tiles[-1][2] else t for t in tiles]
    bad = dkw_chain(image, dconv, patch, t_patch, tiles=dropped)
    assert _rel(torch.nan_to_num(bad, nan=0.0), plain) > FLOAT_BAND
    swapped = got.reshape(k // patch, patch, dim).transpose(0, 1)
    assert _rel(swapped, plain) > FLOAT_BAND
