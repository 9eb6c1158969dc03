"""What the CPU can check of the Hopper kernels of csrc/gemm_sm90.cuh.

The kernels run only on the card (tests/test_torch_port_cuda.py holds them
against their plain versions there). Here, on the CPU:

- the wrappers' TMA plan, which is plain Python: every operand the
  geglu_ff kernel reads through TMA has a 16-B aligned base and a row
  stride of whole 16-B units, and w_out [D, 1365] (2730-B rows) goes as a
  zero-padded copy [D, 1368] whose first 1365 columns are the weight;
- the attention core's arithmetic, emulated in torch: scores as q_hi.k_hi
  + q_hi.k_lo + q_lo.k_hi from bf16 hi / lo pairs stay within 1e-4 of the
  fp32 scores at scale 8, where one bf16 product (the control) does not;
  and the two-pass softmax over 64-key chunks (running max and sum, then p
  = exp(s - m) / l rounded to bf16 before P.V) gives attn_block_plain's
  block within the card's band, where a core with the bias left out of
  pass 2, or a running sum not rescaled when the max grows (the
  controls), does not.

Inputs are made from a seed with numpy.
"""

import math

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import tma_operands

SCORE_BAND = 1e-4    # max abs error of the split-bf16 scores vs fp32 at scale 8
FLOAT_BAND = 1.5e-2  # the card's max relative error band of the bf16 kernels
KC = 64              # keys a chunk of the core (csrc/attn_block.cu)
LOG2E = 1.4426950408889634


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("inner,padded", [(1365, 1368), (1344, 1344), (42, 48)])
def test_geglu_tma_operands_are_16_byte_strided(inner, padded):
    """Each TMA operand: row stride a whole number of 16-B units, base
    16-B aligned, columns within the stride. w_out is padded per call to
    `padded` columns where 2 * inner is not a multiple of 16: the copy
    holds the weight in its first `inner` columns and zeros after; an
    aligned w_out goes as it is."""
    rng = np.random.default_rng(31)
    d = 512
    x = _bf16(rng.standard_normal((77, d)))
    w_in = _bf16(rng.standard_normal((2 * inner, d)))
    w_out = _bf16(rng.standard_normal((d, inner)))
    ops = tma_operands(x, w_in, w_out)
    assert set(ops) == {"xn", "w_value", "w_gate", "hbuf", "w_out"}
    for name, (t, rows, cols, ld) in ops.items():
        assert (ld * t.element_size()) % _build.TMA_ALIGN == 0, name
        assert t.data_ptr() % _build.TMA_ALIGN == 0, name
        assert t.stride(0) == ld and t.shape[0] == rows and cols <= ld <= t.shape[1], name
    w2, rows, cols, ld = ops["w_out"]
    assert (rows, cols, ld) == (d, inner, padded)
    assert torch.equal(w2[:, :inner], w_out)
    assert not w2[:, inner:].any()
    if padded == inner:
        assert w2.data_ptr() == w_out.data_ptr()
    assert ops["hbuf"][3] == padded
    assert torch.equal(ops["w_gate"][0], w_in[inner:])


@pytest.mark.parametrize("cols,itemsize,pitch", [(1365, 2, 1368), (512, 2, 512), (1, 2, 8),
                                                 (33, 4, 36)])
def test_tma_pitch_rounds_rows_to_16_bytes(cols, itemsize, pitch):
    assert _build.tma_pitch(cols, itemsize) == pitch


def test_tma_rows_copies_a_misaligned_base():
    """A view whose data starts off a 16-B boundary is copied, even when
    its row stride would do."""
    t = torch.zeros(65 * 8, dtype=torch.bfloat16)[1:513].view(64, 8)
    assert t.data_ptr() % 16 != 0
    got, ld = _build.tma_rows(t)
    assert ld == 8 and got.data_ptr() % 16 == 0 and torch.equal(got, t)


def _unit_heads(rng, shape, scale):
    """fp32 rows of norm `scale` times a gain drawn around 1 per column,
    as the projection epilogue writes q (q_scale * 8) and k (k_scale)."""
    v = rng.standard_normal(shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    gain = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return torch.from_numpy(v * gain * scale)


def _split(t):
    """(hi, lo) bf16 pair of an fp32 tensor, returned as fp32: hi = bf16(t),
    lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def split_scores(q, k):
    """The core's scores from bf16 hi / lo pairs: every bf16 x bf16 product
    is exact in fp32, the three products are summed in fp32."""
    qh, ql = _split(q)
    kh, kl = _split(k)
    return qh @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2) + ql @ kh.transpose(-1, -2)


@pytest.mark.parametrize("n", [576, 33])
def test_split_bf16_scores_hold_fp32_at_scale_8(n):
    rng = np.random.default_rng(32)
    q = _unit_heads(rng, (2, 8, n, 32), 8.0)
    k = _unit_heads(rng, (2, 8, n, 32), 1.0)
    exact = (q.double() @ k.double().transpose(-1, -2))
    fp32 = q @ k.transpose(-1, -2)
    got = split_scores(q, k)
    assert (got.double() - exact).abs().max().item() <= SCORE_BAND
    assert (got - fp32).abs().max().item() <= SCORE_BAND
    one_pass = q.to(torch.bfloat16).float() @ k.to(torch.bfloat16).float().transpose(-1, -2)
    assert (one_pass.double() - exact).abs().max().item() > SCORE_BAND


def two_pass_core(q, k, v, bias, *, fault: str = ""):
    """The core of csrc/attn_block.cu in torch: split-bf16 scores + bias;
    pass 1 walks 64-key chunks keeping each row's running max m and sum l
    (l rescaled by exp(m_old - m_new) when the max grows, in exp2 form);
    pass 2 takes p = exp(s - m) / l, rounds it to bf16 and sums p v in
    fp32; o is rounded to bf16. q, k fp32 [r, h, n, dh]; v bf16-valued
    fp32; bias [h, n, n]. `fault` builds the controls: "no_rescale" leaves
    l unrescaled, "pass2_no_bias" leaves the bias out of pass 2's scores."""
    rescale = fault != "no_rescale"
    s0 = split_scores(q, k)
    s = s0 + bias
    n = s.shape[-1]
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    for kc in range(0, n, KC):
        chunk = s[..., kc:kc + KC]
        m_new = torch.maximum(m, chunk.amax(-1))
        grow = torch.exp2(m * LOG2E - m_new * LOG2E) if rescale else torch.ones_like(l)
        l = l * grow + torch.exp2(chunk * LOG2E - m_new[..., None] * LOG2E).sum(-1)
        m = m_new
    if fault == "pass2_no_bias":
        s = s0
    p = (torch.exp2(s * LOG2E - (m * LOG2E)[..., None]) / l[..., None]).to(torch.bfloat16)
    return (p.float() @ v).to(torch.bfloat16).float()


def block_with_core(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, core):
    """attn_block_plain with its softmax core replaced by `core` (the same
    projections, l2 norms, scales and output projection)."""
    dt = x.dtype
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma.float()).to(dt).float()

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    q = heads_of(xn @ wq.float().t())
    k = heads_of(x32 @ wk.float().t())
    v = heads_of(x32 @ wv.float().t()).to(dt).float()
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12) * (qs * scale)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12) * ks
    o = core(q, k, v, bias).transpose(1, 2).reshape(r, n, heads * dh)
    return (o @ wo.float().t()).to(dt)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("n", [200, 33])
def test_two_pass_core_matches_attn_block_plain(n):
    """The emulated core (split scores, 64-key chunks, p rounded after
    normalisation) against attn_block_plain's fp32 softmax, at a length
    that spans chunks and at an odd one within one chunk. The controls miss
    the band: the bias left out of pass 2, and (where there is more than
    one chunk) a running sum never rescaled."""
    rng = np.random.default_rng(33)
    d, heads, dh = 128, 4, 32
    hd = heads * dh
    x = _bf16(rng.standard_normal((3, n, d)))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    wq, wk, wv = (_bf16(rng.standard_normal((hd, d)) / np.sqrt(d)) for _ in range(3))
    wo = _bf16(rng.standard_normal((d, hd)) / np.sqrt(hd))
    qs, ks = (torch.from_numpy((1.0 + 0.1 * rng.standard_normal(dh)).astype(np.float32))
              for _ in range(2))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n)).astype(np.float32))
    args = (x, gamma, wq, wk, wv, wo, qs, ks, bias, 8.0)
    want = attn_block_plain(*args)
    got = block_with_core(*args, two_pass_core)
    assert _rel_err(got, want) <= FLOAT_BAND
    for fault in ("pass2_no_bias",) + (("no_rescale",) if n > KC else ()):
        bad = block_with_core(*args, lambda *a: two_pass_core(*a, fault=fault))
        assert _rel_err(bad, want) > FLOAT_BAND, fault
