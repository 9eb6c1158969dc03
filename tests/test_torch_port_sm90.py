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
  controls), does not;
- vq_nearest's argmax epilogue (csrc/vq_nearest.cu), emulated in torch:
  each thread's strict > over its columns of a 128-code tile, the two quad
  shuffles, the 64-bit key (orderable(sim) << 32) | (0xFFFFFFFF - column)
  with -0.0 taken as +0.0, and the max over tiles that the atomics take,
  equal torch.argmax on random sims, on negative ones, on equal maxima in
  one tile and in tiles far apart (the lowest index wins), on -0.0 /
  +0.0 ties and on NaN (above every number, the first NaN wins); a key
  that keeps -0.0 below +0.0, the column not inverted, a plain > that
  never takes a NaN, or a decode that gives a row of -inf index -1 (the
  controls) does not;
- attn_qrows's chain (csrc/attn_qrows.cu), emulated in torch at the
  kernel's rounding points and tiles: 128-row query stripes, 64-key tiles
  with the bias (zero past N, keys past N at -inf), pass 1's running max
  and sum in exp2 form, pass 2 from the last tile to the first with p =
  exp2(s log2 e - (max log2 e + log2 sum)) rounded to bf16, equals
  attn_qrows_plain within the card's band at ragged N; a pass 2 without the
  bias, a sum never rescaled, or the sum's natural log folded in for its
  log2 (the controls) does not.
- the attention backward's tensor-core passes (csrc/attn_bwd.cuh), emulated
  pass by pass: the forward core saving each row's max, sum and rowsum(dO
  o), the query pass's dS from them, the key pass's S^T recomputed from
  the split pair (within SCORE_BAND of S) with p from the log-sum-exp,
  and dbias summed over the sequences in the dbias pass's 64 x 64 blocks,
  gives every gradient of attn_block_bwd_plain within the card's band at
  n = 64 and a ragged 100; a core without the row term, a dbias block
  never written or a dbias sum short of one sequence (the controls) does
  not;
- cosine_attention's prologue (l2-norm, scales) and the shared core with
  m keys and bias head bh % h against cosine_attention_plain at m != n;
  q_scale left out or the wrong bias head (the controls) miss the band.

Inputs are made from a seed with numpy.
"""

import math

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd_plain, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_qrows import attn_qrows_plain
from ct_clip_ut_tpu_torch.ops.cosine_attention import cosine_attention_plain
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


# ---- vq_nearest's argmax epilogue ----

VQ_TILE = 128   # codes a tile of the GEMM core


NO_COL = 2 ** 31 - 1   # a thread's column before it keeps one


def _above(a, b, nan_rule=True):
    """torch.argmax's strict order (the kernel's `above`, b == b && !(a <=
    b)): a > b, or a NaN and b not."""
    return (b == b) & ~(a <= b) if nan_rule else a > b


def _tile_first_max(block, valid, nan_rule=True):
    """One tile's (max, column) per row as the epilogue finds it: thread t
    of a quad scans columns 8j + 2t + e in increasing order from -inf,
    keeping a strict `above`, then two shuffles combine the quad, a lower
    column winning equal values. block [M, 128] fp32, valid [128] bool.
    Without `nan_rule` (a control) it is the plain >: a NaN never wins."""
    m = block.shape[0]
    vals = torch.full((m, 4), -math.inf)
    cols = torch.full((m, 4), NO_COL, dtype=torch.int64)
    for t in range(4):
        for j in range(VQ_TILE // 8):
            for e in range(2):
                c = 8 * j + 2 * t + e
                if not valid[c]:
                    continue
                better = _above(block[:, c], vals[:, t], nan_rule)
                vals[:, t] = torch.where(better, block[:, c], vals[:, t])
                cols[:, t] = torch.where(better, torch.tensor(c), cols[:, t])
    for o in (1, 2):
        ov, oc = vals[:, [t ^ o for t in range(4)]], cols[:, [t ^ o for t in range(4)]]
        level = ~_above(vals, ov) if nan_rule else ov == vals   # no lower
        take = _above(ov, vals, nan_rule) | (level & (oc < cols))
        vals, cols = torch.where(take, ov, vals), torch.where(take, oc, cols)
    return vals[:, 0], cols[:, 0]


def argmax_key(v, col, *, canonical_zero=True, invert=True, nan_rule=True, zero_key=True):
    """The 64-bit key as a signed int64 of the same order (the unsigned key
    minus 2^63): orderable(v) << 32 | (0xFFFFFFFF - col), every NaN at the
    top of the order."""
    if canonical_zero:
        v = torch.where(v == 0, torch.zeros_like(v), v)
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ord_ = torch.where(bits >= 2 ** 31, 0xFFFFFFFF - bits, bits + 2 ** 31)
    if nan_rule:
        ord_ = torch.where(v != v, torch.tensor(0xFFFFFFFF), ord_)
    low = (0xFFFFFFFF - col) if invert else col
    return (ord_ - 2 ** 31) * 2 ** 32 + low


def vq_argmax_emulated(sims, **key_opts):
    """csrc/vq_nearest.cu's indices from fp32 sims [M, C]: a key per (row,
    tile where a column was kept, their max (what the atomicMax calls
    leave, in any order, over the zeroed workspace), the column decoded as
    the kernel's int32; a key still zero (a row of -inf) gives 0, or -1
    without `zero_key` (a control: the decode alone)."""
    m, c = sims.shape
    best = torch.full((m,), -2 ** 63, dtype=torch.int64)
    for c0 in range(0, c, VQ_TILE):
        block = torch.full((m, VQ_TILE), -math.inf)
        n = min(VQ_TILE, c - c0)
        block[:, :n] = sims[:, c0:c0 + n]
        valid = torch.arange(VQ_TILE) < n
        v, col = _tile_first_max(block, valid, key_opts.get("nan_rule", True))
        key = torch.where(col == NO_COL, best, argmax_key(v, c0 + col, **key_opts))
        best = torch.maximum(best, key)
    low = (best + 2 ** 63) & 0xFFFFFFFF
    idx = (0xFFFFFFFF - low) if key_opts.get("invert", True) else low
    idx = torch.where(idx >= 2 ** 31, idx - 2 ** 32, idx)
    return torch.where(best == -2 ** 63, 0, idx) if key_opts.get("zero_key", True) else idx


def _vq_sims(rng, m, c):
    tok = _bf16(rng.standard_normal((m, 64))).float()
    cb = _bf16(rng.standard_normal((c, 64))).float()
    return tok @ cb.t()


@pytest.mark.parametrize("c", [8192, 300])
def test_vq_argmax_epilogue_matches_torch_argmax(c):
    """Random sims, all-negative rows, equal maxima in one tile (5 and 9)
    and in tiles far apart (5 and 4100, 130 and 290), -0.0 / +0.0 ties in
    either order and across tiles: the emulated epilogue gives
    torch.argmax's first maximum on every row."""
    rng = np.random.default_rng(34)
    sims = _vq_sims(rng, 40, c)
    sims[1] = -sims[1].abs() - 0.5                       # all negative
    far = 4100 if c > 4100 else 290
    top = sims.abs().max() + 1.0
    sims[2, 5] = sims[2, 9] = top                         # one tile
    sims[3, 5] = sims[3, far] = top                       # tiles apart
    sims[4, 130] = sims[4, far] = top
    for r, (lo, hi) in zip((5, 6, 7, 8), ((-0.0, 0.0), (0.0, -0.0), (-0.0, 0.0), (0.0, -0.0))):
        sims[r] = -1.0 - torch.rand(c)
        a, b = (3, 7) if r < 7 else (9, far)
        sims[r, a], sims[r, b] = lo, hi
    assert torch.signbit(sims[5, 3]) and torch.signbit(sims[8, far])
    want = torch.argmax(sims, dim=-1)
    assert want[2] == 5 and want[3] == 5 and want[4] == 130
    assert want[5] == want[6] == 3 and want[7] == want[8] == 9
    assert torch.equal(vq_argmax_emulated(sims), want)


def test_vq_argmax_epilogue_controls_miss():
    """A key that orders -0.0 below +0.0 takes +0.0 in the later tile over
    the first maximum; a key with the column not inverted takes the last
    of equal maxima."""
    rng = np.random.default_rng(35)
    sims = _vq_sims(rng, 4, 8192)
    sims[0] = -1.0 - torch.rand(8192)
    sims[0, 9], sims[0, 4100] = -0.0, 0.0
    top = sims.abs().max() + 1.0
    sims[1, 5] = sims[1, 4100] = top
    want = torch.argmax(sims, dim=-1)
    assert want[0] == 9 and want[1] == 5
    assert vq_argmax_emulated(sims, canonical_zero=False)[0] == 4100
    assert vq_argmax_emulated(sims, invert=False)[1] == 4100


def test_vq_argmax_epilogue_nan_rule():
    """A diverged row: all NaN gives index 0, NaN among numbers gives the
    first NaN (in a later tile too, above +inf, and across a quad), a row
    of -inf index 0, as torch.argmax does. Controls: a plain > never takes
    a NaN; the key decoded without the zero-key rule gives the row of -inf
    index -1."""
    rng = np.random.default_rng(37)
    sims = _vq_sims(rng, 5, 300)
    sims[0] = math.nan
    sims[1, 200], sims[1, 290] = math.nan, -math.nan
    sims[2, 3] = math.inf
    sims[2, 130] = math.nan
    sims[3] = -math.inf
    sims[4, 11], sims[4, 9] = math.nan, math.nan           # two threads of a quad
    want = torch.argmax(sims, dim=-1)
    assert want.tolist() == [0, 200, 130, 0, 9]
    assert torch.equal(vq_argmax_emulated(sims), want)
    bad = vq_argmax_emulated(sims, nan_rule=False)
    assert bad[1] != 200 and bad[2] == 3
    assert vq_argmax_emulated(sims, zero_key=False)[3] == -1


# ---- attn_qrows's two-pass core at its tiles ----

QR_ROWS, QR_KT = 128, 64    # query rows a block, keys a tile (csrc/attn_qrows.cu)


def qrows_core(q, k, v, bias, *, fault: str = ""):
    """The core of csrc/attn_qrows.cu in torch, stripe by stripe: s = bias +
    q . k in fp32 (q, k, v bf16-valued fp32 [b, h, n, 64]; bias [h, n, n]
    bf16-valued or None), keys past N at -inf; pass 1 over 64-key tiles
    keeps each row's running max m and sum l (exp2 form); pass 2 walks the
    tiles from the last to the first, p = exp2(s log2 e - (m log2 e + log2
    l)) rounded to bf16, o += p v in fp32; o rounded. `fault` builds the
    controls: "pass2_no_bias", "no_rescale", "ln_for_log2" (the sum's
    natural log folded in)."""
    b, h, n, dh = q.shape
    o = torch.zeros_like(q)
    ntiles = -(-n // QR_KT)
    pad = ntiles * QR_KT
    kp = torch.zeros((b, h, pad, dh))
    vp = torch.zeros((b, h, pad, dh))
    kp[:, :, :n], vp[:, :, :n] = k, v
    for r0 in range(0, n, QR_ROWS):
        rows = slice(r0, r0 + QR_ROWS)
        qr = q[:, :, rows]
        bias_r = torch.zeros((h, qr.shape[2], pad))
        if bias is not None:
            bias_r[:, :, :n] = bias[:, rows]

        def scores(t, with_bias=True):
            keys = slice(t * QR_KT, (t + 1) * QR_KT)
            s = qr @ kp[:, :, keys].transpose(-1, -2)
            if with_bias:
                s = s + bias_r[:, :, keys]
            past = torch.arange(t * QR_KT, (t + 1) * QR_KT) >= n
            return s.masked_fill(past, -math.inf)

        m = torch.full(qr.shape[:-1], -math.inf)
        l = torch.zeros(qr.shape[:-1])
        for t in range(ntiles):
            s = scores(t)
            x = torch.maximum(m, s.amax(-1))
            base = x * LOG2E
            grow = torch.exp2(m * LOG2E - base) if fault != "no_rescale" else torch.ones_like(l)
            l = l * grow + torch.exp2(s * LOG2E - base[..., None]).sum(-1)
            m = x
        lb = m * LOG2E + (torch.log(l) if fault == "ln_for_log2" else torch.log2(l))
        acc = torch.zeros_like(qr)
        for t in reversed(range(ntiles)):
            s = scores(t, with_bias=fault != "pass2_no_bias")
            p = torch.exp2(s * LOG2E - lb[..., None]).to(torch.bfloat16).float()
            acc = acc + p @ vp[:, :, t * QR_KT:(t + 1) * QR_KT]
        o[:, :, rows] = acc.to(torch.bfloat16).float()
    return o


def qrows_chain(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, core):
    """attn_qrows's chain in torch at the kernel's rounding points, with the
    core replaced by `core`: xn = bf16(LN(x) gamma); q = bf16(l2n(xn Wq^T)
    qs scale), k = bf16(l2n(bf16(x Wk^T)) ks), v = bf16(x Wv^T) (the QkvPlan
    GEMM's epilogue); o Wo^T in fp32, rounded."""
    b, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma).to(torch.bfloat16).float()

    def heads_of(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    def unit(t):
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)

    def bf(t):
        return t.to(torch.bfloat16).float()

    q = bf(unit(heads_of(xn @ wq.float().t())) * (qs * scale))
    k = bf(unit(heads_of(bf(x32 @ wk.float().t()))) * ks)
    v = bf(heads_of(x32 @ wv.float().t()))
    o = core(q, k, v, None if bias is None else bias.float())
    return (o.transpose(1, 2).reshape(b, n, heads * dh) @ wo.float().t()).to(torch.bfloat16)


@pytest.mark.parametrize("b,n,bias", [(2, 200, True), (1, 77, True), (1, 150, False)])
def test_qrows_core_tiles_match_attn_qrows_plain(b, n, bias):
    """The emulated chain against attn_qrows_plain (q_block 64) within the
    card's band: two query stripes at N = 200 and 150 (the second ragged),
    one at 77, a last key tile partly past N each time. The controls miss
    it (the bias ones where there is a bias)."""
    rng = np.random.default_rng(36)
    d, heads, dh = 128, 2, 64
    hd = heads * dh
    x = _bf16(rng.standard_normal((b, n, d)))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    wq, wk, wv = (_bf16(rng.standard_normal((hd, d)) / np.sqrt(d)) for _ in range(3))
    wo = _bf16(rng.standard_normal((d, hd)) / np.sqrt(hd))
    qs, ks = (torch.from_numpy((1.0 + 0.1 * rng.standard_normal(dh)).astype(np.float32))
              for _ in range(2))
    tb = _bf16(rng.standard_normal((heads, n, n))) if bias else None
    args = (x, gamma, wq, wk, wv, wo, qs, ks, tb, 8.0)
    want = attn_qrows_plain(*args)
    assert _rel_err(qrows_chain(*args, qrows_core), want) <= FLOAT_BAND
    faults = ("no_rescale", "ln_for_log2") + (("pass2_no_bias",) if bias else ())
    for fault in faults:
        bad = qrows_chain(*args, lambda *a: qrows_core(*a, fault=fault))
        assert _rel_err(bad, want) > FLOAT_BAND, fault


# ---- the spatial block's backward on the tensor cores (csrc/attn_bwd.cuh) ----

DB_QT = 64   # query rows of a dbias block; its key chunk is KC


def bwd_core(qh, kh, v, do, bias, *, fault: str = ""):
    """The tensor-core passes of csrc/attn_bwd.cuh in torch, one by one.
    qh, kh fp32 scaled unit rows [r, h, n, dh]; v, do bf16-valued fp32;
    bias [h, n, n] or None. Forward pass: split-bf16 scores + bias, the
    running max m and sum l over 64-key chunks (exp2 form), p = exp(s - m)
    / l rounded to bf16, o = bf16(p v), D = rowsum(do o); the row saves (m
    log2 e, 1 / l, D). Query pass: p from the saved (m, l) unrounded, dp =
    do v^T, ds = p (dp - D), dqh = bf16(ds) bf16(kh). Key pass: S^T from
    the split pair (k, q) + bias^T, p^T = exp2(s log2 e - lse), lse = m
    log2 e + log2 l, dv = bf16(p^T) do, dkh = bf16(ds^T) bf16(qh). dbias
    pass: per (64-query tile, 64-key chunk) the query pass's ds summed over
    the sequences in order. Returns (o, dqh, dkh, dv, dbias, s, s^T).
    `fault` builds the controls: "row_term" drops D, "dbias_tile" leaves
    the last (query tile, key chunk) block of dbias unwritten, "dbias_seq"
    leaves the last sequence out of dbias's sum."""
    r, h, n, dh = qh.shape
    bias_t = torch.zeros((h, n, n)) if bias is None else bias
    s = split_scores(qh, kh) + bias_t
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    for kc in range(0, n, KC):
        chunk = s[..., kc:kc + KC]
        m_new = torch.maximum(m, chunk.amax(-1))
        l = l * torch.exp2(m * LOG2E - m_new * LOG2E) \
            + torch.exp2(chunk * LOG2E - m_new[..., None] * LOG2E).sum(-1)
        m = m_new
    base, inv = m * LOG2E, 1.0 / l
    p = torch.exp2(s * LOG2E - base[..., None]) * inv[..., None]
    o = (p.to(torch.bfloat16).float() @ v).to(torch.bfloat16).float()
    d_row = torch.zeros_like(base) if fault == "row_term" else (do * o).sum(-1)

    def bf(t):
        return t.to(torch.bfloat16).float()

    ds = p * (do @ v.transpose(-1, -2) - d_row[..., None])
    dqh = bf(ds) @ bf(kh)
    st = split_scores(kh, qh) + bias_t.transpose(-1, -2)
    lse = base - torch.log2(inv)
    pt = torch.exp2(st * LOG2E - lse[..., None, :])
    dst = pt * (v @ do.transpose(-1, -2) - d_row[..., None, :])
    dv = bf(pt) @ do
    dkh = bf(dst) @ bf(qh)
    dbias = torch.zeros((h, n, n))
    last = ((n - 1) // DB_QT * DB_QT, (n - 1) // KC * KC)
    for q0 in range(0, n, DB_QT):
        for k0 in range(0, n, KC):
            if fault == "dbias_tile" and (q0, k0) == last:
                continue
            acc = torch.zeros_like(dbias[:, q0:q0 + DB_QT, k0:k0 + KC])
            for seq in range(r - 1 if fault == "dbias_seq" else r):
                acc = acc + ds[seq, :, q0:q0 + DB_QT, k0:k0 + KC]
            dbias[:, q0:q0 + DB_QT, k0:k0 + KC] = acc
    return o, dqh, dkh, dv, dbias, s, st


def block_bwd_with_core(x, gamma, wq, wk, wv, wo, qs, ks, bias, g, scale, core):
    """attn_block_bwd_plain's chain at the kernel's rounding points with its
    core replaced by `core` (bwd_core's signature): LN, the projections, q /
    k l2-normed and scaled (the QkvEpi epilogue's unit rows and norms), dO
    = bf16(g Wo), then the scale and l2-norm backward, the data and weight
    gradients and the LN backward around the core's outputs."""
    dt = x.dtype
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    m = r * n
    x32 = x.float().reshape(m, d)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + 1e-5)
    xhat = (x32 - mean) * rstd
    xn = (xhat * gamma).to(dt).float()
    wqf, wkf, wvf, wof = (w.float() for w in (wq, wk, wv, wo))

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def merged(t):
        return t.transpose(1, 2).reshape(m, heads * dh)

    def bf(t):
        return t.to(dt).float()

    q, k = heads_of(xn @ wqf.t()), heads_of(x32 @ wkf.t())
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12)
    uq, uk = q / qn, k / kn
    qsc = qs * scale
    v = bf(heads_of(x32 @ wvf.t()))
    gb = bf(g.reshape(m, d))
    do = bf(heads_of(gb @ wof))
    o, dqh, dkh, dv, dbias, _, _ = core(uq * qsc, uk * ks, v, do, bias)
    dqs = (uq * dqh).sum((0, 1, 2)) * scale
    dks = (uk * dkh).sum((0, 1, 2))
    duq, duk = dqh * qsc, dkh * ks
    dq = bf(merged((duq - uq * (uq * duq).sum(-1, keepdim=True)) / qn))
    dk = bf(merged((duk - uk * (uk * duk).sum(-1, keepdim=True)) / kn))
    dv = bf(merged(dv))
    o = merged(o)
    dxn = dq @ wqf
    dgamma = (dxn * xhat).sum(0)
    dxhat = dxn * gamma
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd + dk @ wkf + dv @ wvf
    return (dx.reshape(r, n, d).to(dt), dgamma, dq.t() @ xn, dk.t() @ x32, dv.t() @ x32,
            gb.t() @ o, dqs, dks, dbias if bias is not None else None)


ATTN_GRADS = ("dx", "dgamma", "dwq", "dwk", "dwv", "dwo", "dqs", "dks", "dbias")


def _bwd_case(n, heads, r=5, d=64, dh=32, seed=37):
    rng = np.random.default_rng(seed)
    hd = heads * dh
    x = _bf16(rng.standard_normal((r, n, d)))
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    wq, wk, wv = (_bf16(rng.standard_normal((hd, d)) / np.sqrt(d)) for _ in range(3))
    wo = _bf16(rng.standard_normal((d, hd)) / np.sqrt(hd))
    qs, ks = (torch.from_numpy((1.0 + 0.1 * rng.standard_normal(dh)).astype(np.float32))
              for _ in range(2))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n)).astype(np.float32))
    g = _bf16(rng.standard_normal((r, n, d)))
    return (x, gamma, wq, wk, wv, wo, qs, ks, bias, g, 8.0)


def _grad_errs(got, want):
    return {k: _rel_err(a, b) for k, a, b in zip(ATTN_GRADS, got, want) if b is not None}


@pytest.mark.parametrize("n,heads", [(64, 2), (100, 4)])
def test_backward_core_tiles_match_attn_block_bwd_plain(n, heads):
    """The emulated tensor-core backward (R = 5 sequences; n one key chunk,
    or ragged against the 64-row tiles) gives every gradient of
    attn_block_bwd_plain within the card's band, and the key pass's
    recomputed S^T stays within SCORE_BAND of the query pass's S and of
    the fp32 scores."""
    args = _bwd_case(n, heads)
    want = attn_block_bwd_plain(*args)
    got = block_bwd_with_core(*args, bwd_core)
    errs = _grad_errs(got, want)
    assert max(errs.values()) <= FLOAT_BAND, errs
    rng = np.random.default_rng(38)
    qh = _unit_heads(rng, (2, heads, n, 32), 8.0)
    kh = _unit_heads(rng, (2, heads, n, 32), 1.0)
    v = _bf16(rng.standard_normal((2, heads, n, 32))).float()
    *_, s, st = bwd_core(qh, kh, v, v, None)
    assert (st.transpose(-1, -2) - s).abs().max().item() <= SCORE_BAND
    assert (s - qh @ kh.transpose(-1, -2)).abs().max().item() <= SCORE_BAND


@pytest.mark.parametrize("fault,grad", [("row_term", "dx"), ("dbias_tile", "dbias"),
                                        ("dbias_seq", "dbias")])
def test_backward_core_controls_miss(fault, grad):
    """A core without the softmax row term, a dbias block never written,
    or a dbias sum that leaves out a sequence lies outside the band."""
    args = _bwd_case(100, 4)
    want = attn_block_bwd_plain(*args)
    got = block_bwd_with_core(*args, lambda *a: bwd_core(*a, fault=fault))
    assert _grad_errs(got, want)[grad] > FLOAT_BAND


# ---- the bare cosine core on the shared core (csrc/cosine_attention.cu) ----

def cosine_core(q, k, v, qs, ks, bias, heads, scale, *, fault: str = ""):
    """csrc/cosine_attention.cu in torch: the prologue l2-normalises each
    bf16 row in fp32 (max(||.||, 1e-12)), times q_scale * scale or k_scale;
    the shared two-pass core runs over m keys (split-bf16 scores of the hi /
    lo pairs) with slice bh taking bias head bh % heads. `fault`:
    "bias_head" takes head bh // (BH / heads) instead."""
    bh = q.shape[0]

    def unit(t):
        t = t.float()
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)

    qh, kh = unit(q) * (qs * scale), unit(k) * ks
    if bias is None:
        b = torch.zeros((bh, q.shape[1], k.shape[1]))
    elif fault == "bias_head":
        b = bias.repeat_interleave(bh // heads, 0)
    else:
        b = bias.repeat(bh // heads, 1, 1)
    return two_pass_core(qh, kh, v.float(), b).to(torch.bfloat16)


@pytest.mark.parametrize("bh,n,m,bias", [(8, 70, 130, True), (16, 24, 24, False),
                                         (8, 100, 33, True)])
def test_cosine_core_matches_cosine_attention_plain(bh, n, m, bias):
    """The emulated prologue + shared core against cosine_attention_plain
    within the card's band, m != n and keys ragged against the 64-key
    chunks; with a bias, a core that takes the wrong bias head or leaves
    q_scale out misses it."""
    rng = np.random.default_rng(39)
    heads = 4
    q = _bf16(rng.standard_normal((bh, n, 32)))
    k, v = (_bf16(rng.standard_normal((bh, m, 32))) for _ in range(2))
    qs, ks = (torch.from_numpy((1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32))
              for _ in range(2))
    b = torch.from_numpy(rng.standard_normal((heads, n, m)).astype(np.float32)) if bias else None
    want = cosine_attention_plain(q, k, v, qs, ks, b, heads, 8.0)
    assert _rel_err(cosine_core(q, k, v, qs, ks, b, heads, 8.0), want) <= FLOAT_BAND
    assert _rel_err(cosine_core(q, k, v, torch.ones_like(qs), ks, b, heads, 8.0),
                    want) > FLOAT_BAND
    if bias:
        bad = cosine_core(q, k, v, qs, ks, b, heads, 8.0, fault="bias_head")
        assert _rel_err(bad, want) > FLOAT_BAND
