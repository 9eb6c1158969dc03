"""Two card chains' designs, emulated in torch on the CPU: the W8A8 GEGLU
FF (csrc/geglu_ff_int8.cu) with fp32 rows (row 15f) beside bf16 ones (row
15), and the fp32 residual-saving patch embed's staged product
(csrc/patch_embed.cu, row 10f).

geglu_ff_int8: its four launches (`int8_chain` of
tests/test_torch_port_int8_peg_hopper.py: LN and xn's codes, the value |
gate product writing h in 64-column tiles, h's row scales and codes, the
W2 product over 128-deep K slices) at 77 rows, D = 128 and inner 85
padded to 96 (two first-product tiles, the second a third full; one W2
slice, past K from 96) give `geglu_ff_int8_plain`'s codes and output bit
for bit, with bf16 and with fp32 x, residual off and on. Control: a
column tile left out of the row scales.

patch_embed_res_f32: patchify into P's hi / lo planes with the LN1
moments, P . Kw^T as split4_kernel takes it (K zero-filled up to its
64-wide slices, each 16-deep step's a_hi b_lo, a_lo b_hi, a_hi b_hi into
one fp32 sum), PatchF32Epi storing conv and h, LN2. At K = 200 (three
slices and a ragged fourth) and K = 4,000 (the flagship's 62.5 slices) its
out, conv and moments lie within the fp32 band of `patch_embed_res_plain`
and of the JAX package's `_forward_res_impl` (the Pallas kernel row 10f
ports) in interpret mode, its out within the band of `_xla_twin`.
Control: the lo planes zeroed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_patch_embed import _forward_res_impl, _xla_twin
from ct_clip_ut_tpu_torch.ops import geglu_ff_int8 as tint8
from ct_clip_ut_tpu_torch.ops import patch_embed
from ct_clip_ut_tpu_torch.ops.patch_embed import EPS, _kernel_weight, _patches

from test_torch_port_cuda import _patch_args, _patch_inputs
from test_torch_port_f32_hopper import _split, _staged_product
from test_torch_port_f32_train_hopper import BAND, _rel_err
from test_torch_port_int8_peg_hopper import H_TILE, _h_tile, _ln_codes, _plain_codes, int8_chain
from test_torch_port_kernels import _jax_fold
from test_torch_port_quant import _ff_arrays, _port_args, _quantized

INT8_BAND = 2e-3   # relative rms of the card's int8 FF against its plain version


@pytest.fixture
def one_thread():
    """One intra-op thread: torch's erf then takes its vectorised path for
    every element of a [77, 64] tile and of the [77, 96] rows alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ff(seed):
    a = _ff_arrays(np.random.default_rng(seed), dim=128, inner=85, n=77)
    ff = _quantized(a)[1]
    assert ff.wv_q.shape == (96, 128) and ff.w2_q.shape == (128, 96)
    return a, ff


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_chain_gives_the_plain_bits_at_either_row_type(one_thread, dtype, residual):
    a, ff = _ff(250)
    x = torch.from_numpy(a["x"]).to(dtype)
    got, xq, hq = int8_chain(x, *_port_args(ff), residual=residual)
    want_xq, want_hq = _plain_codes(x, ff)
    assert torch.equal(xq, want_xq) and torch.equal(hq, want_hq)
    plain = tint8.geglu_ff_int8_plain(x, *_port_args(ff), residual=residual)
    assert got.dtype == plain.dtype == dtype and torch.equal(got, plain)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_chain_without_a_tile_in_the_row_scale_is_caught(one_thread, dtype):
    """Leaving the tile that holds row 0's absmax of h out of the row scales
    shrinks that row's scale: codes overflow, and the output leaves the
    card's band."""
    a, ff = _ff(251)
    x = torch.from_numpy(a["x"]).to(dtype)
    xq, rx = _ln_codes(x, ff.gamma, ff.beta)
    args = _port_args(ff)
    row0 = torch.cat([_h_tile(xq, rx, args[2], args[3], args[5], args[6], nt)[0]
                      for nt in range(-(-ff.wv_q.shape[0] // H_TILE))])
    drop = int(row0.abs().argmax()) // H_TILE
    got, _, hq = int8_chain(x, *args, drop_tile=drop)
    plain = tint8.geglu_ff_int8_plain(x, *args)
    assert not torch.equal(hq, _plain_codes(x, ff)[1])
    assert ((got.float() - plain.float()).norm() / plain.float().norm()).item() > INT8_BAND


def emulated_patch_embed_res_staged(image, kw, s1, b1, g2, b2, patch, t_patch, one_pass=False):
    """ctc_patch_embed_res_f32 with its product on split4_kernel: P's
    planes and the LN1 moments (one-pass, fp32), the staged product with
    PatchF32Epi storing conv and h, LN2 (two-pass). Returns (out, conv,
    stats)."""
    b, _, T, H, W = image.shape
    p = _patches(image, patch, t_patch)
    mean = p.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((p * p).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + EPS)
    conv = _staged_product(_split(p, one_pass),
                           _split(_kernel_weight(kw, torch.float32), one_pass))
    h = (conv - mean * s1) * rstd + b1
    mu = h.mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + EPS) * g2 + b2
    return (out.reshape(b, T // t_patch, H // patch, W // patch, -1), conv,
            torch.cat([mean, rstd], dim=-1))


# (shape, patch, t_patch, dim): K = 200 (three 64-wide slices and 8 columns),
# K = 4,000 (the flagship patch: 62 slices and 32 columns)
@pytest.mark.parametrize("shape,patch,t_patch,dim", [((2, 1, 6, 20, 20), 10, 2, 64),
                                                     ((1, 1, 10, 40, 40), 20, 10, 128)])
def test_staged_patch_product_matches_plain_and_the_jax_kernels(shape, patch, t_patch, dim):
    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(253 + patch), b, T, H, W, patch, t_patch, dim)
    args = _patch_args(a, patch, t_patch)
    assert (t_patch * patch * patch) % 64 != 0
    jargs = (jnp.asarray(a["image"]), *_jax_fold(a, patch, t_patch), jnp.asarray(a["g2"]),
             jnp.asarray(a["b2"]))
    out, conv, mean2, var2 = _forward_res_impl(*jargs, patch=patch, t_patch=t_patch,
                                               interpret=True)
    kernel = (np.asarray(out), np.asarray(conv).reshape(-1, dim),
              np.stack([np.asarray(mean2).reshape(-1),
                        1.0 / np.sqrt(np.asarray(var2).reshape(-1) + 1e-5)], -1))
    plain = patch_embed.patch_embed_res_plain(*args, patch, t_patch)
    got = emulated_patch_embed_res_staged(*args, patch, t_patch)
    one = emulated_patch_embed_res_staged(*args, patch, t_patch, one_pass=True)
    for want in (kernel, plain):
        for name, gt, wt in zip(("out", "conv", "stats"), got, want):
            assert _rel_err(gt, wt) <= BAND, name
        assert _rel_err(one[1], want[1]) > BAND
    twin = np.asarray(jax.jit(_xla_twin, static_argnums=(6, 7))(*jargs, patch, t_patch))
    assert _rel_err(got[0], twin) <= BAND < _rel_err(one[0], twin)
