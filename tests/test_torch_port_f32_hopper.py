"""What the CPU can check of the fp32 variants of the block, FF and VQ
kernels (`ctc_attn_block_f32` / `ctc_attn_packed_f32` on
tc::block_forward_f32, `ctc_geglu_ff_f32`, `ctc_vq_nearest_f32`).

The kernels run only on the card (chip_smoke.py phase 10 holds them against
their plain versions there). Here each chain is emulated in torch plane by
plane, as tests/test_torch_port_split.py does for the fp32 BERT layer:
every fp32 product as three bf16 products of hi / lo planes (hi = bf16(a),
lo = bf16(a - hi); a_hi b_hi + a_lo b_hi + a_hi b_lo in fp32), the planes
written where the kernels write them (xn and x; the weights; q and k
l2-normed and scaled; v; p in registers; o; h), LayerNorm in one-pass
moments. The emulations are held against the JAX package's XLA twins and
its Pallas kernels in interpret mode, both at fp32: the attention blocks
and the FF within 2e-5 (tests/test_pallas.py:592's band), the VQ
indices equal, even on tokens built as near-ties of two codes (a sim gap
of ~1e-4). The one-pass control (every lo plane zero, one bf16 product for
each fp32 one) misses each band. Last, the wrappers' routing by dtype,
through a stand-in for the kernel library: fp32 CUDA tensors reach the
fp32 entries with their workspaces, fp16 ones are refused.

Two orders of work are emulated: the three passes above (`_product`: the
form split_product keeps for the chains' other callers), and the order in
which the forward chains of rows 1f-3f now take their products and their
temporal core (`staged=True`): split4_kernel's K slices of 64, zero-filled
past a ragged K (an inner of 85 or 42), each 16-deep step's a_hi b_lo, a_lo
b_hi, a_hi b_hi added into one fp32 sum in that order; and at n <= 64
without a bias the whole-item core, each (sequence, head) with its keys
padded only to the mma tile of 16, the rows past n the next sequence's
under P = 0, S formed once and P.V in 16-key steps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_block import _xla_reference_block, attention_block_fused
from ct_clip_ut_tpu.ops.pallas_attn_packed import attention_block_packed, packed_attention_xla
from ct_clip_ut_tpu.ops.pallas_ff import _xla_reference, geglu_ff_fused
from ct_clip_ut_tpu.ops.pallas_vq import vq_nearest_pallas
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.models import ctvit as tctvit
from ct_clip_ut_tpu_torch.ops import attn_block, attn_packed, geglu_ff, launches, vq_nearest

from test_torch_port_cuda import _attn_inputs, _ff_inputs, _torch_attn_args, _torch_ff_args

ATTN_TOL = 2e-5        # atol and rtol, tests/test_pallas.py:592
# atol and rtol: three bf16 passes keep ~2^-16 of each product, and the FF's
# two products read up to 1.04e-5 of the output's largest value here
FF_TOL = 2e-5
# the staged order's cases: the fp32 band the card holds rows 1f-3f to
# (chip_smoke.py's F32_BAND); on their inputs either order of work reads
# up to 2.4e-5 off the twins (the split's ~2^-16 a product, through the
# planes of q, k, h and o)
STAGED_TOL = 1e-4
SCALE = 8.0


def _split(t, one_pass=False):
    """The hi / lo planes a kernel writes, as fp32 tensors."""
    hi = t.to(torch.bfloat16).float()
    lo = torch.zeros_like(t) if one_pass else (t - hi).to(torch.bfloat16).float()
    return hi, lo


def _product(a, b):
    """a . b^T of planes a [.., m, k] and b [.., n, k]: SplitPlan's three
    passes (A_hi B_hi, A_lo B_hi, A_hi B_lo) into one fp32 sum."""
    (ah, al), (bh, bl) = a, b

    def t(x):
        return x.transpose(-1, -2)

    return ah @ t(bh) + al @ t(bh) + ah @ t(bl)


def _staged_product(a, b):
    """a . b^T as split4_kernel takes it: K zero-filled up to its 64-wide
    slices, then each 16-deep step's a_hi b_lo, a_lo b_hi, a_hi b_hi added
    in that order into one fp32 sum."""
    (ah, al), (bh, bl) = a, b
    k = ah.shape[-1]
    pad = -k % 64
    ah, al, bh, bl = (torch.nn.functional.pad(t, (0, pad)) for t in (ah, al, bh, bl))
    acc = torch.zeros(ah.shape[:-1] + bh.shape[-2:-1])
    for k0 in range(0, k + pad, 16):
        step = slice(k0, k0 + 16)
        for u, v in ((ah, bl), (al, bh), (ah, bh)):
            acc = acc + u[..., step] @ v[..., step].transpose(-1, -2)
    return acc


def _ln_planes(x, gamma, beta, one_pass):
    """ln_split_kernel: one-pass moments, xn = LN(x) * gamma (+ beta) as planes."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x - mean) * torch.rsqrt(var + 1e-5) * gamma
    return _split(y if beta is None else y + beta, one_pass)


def emulated_geglu_ff_f32(x, gamma, beta, w_in, w_out, residual=False, one_pass=False,
                          staged=False):
    """ctc_geglu_ff_f32: the weights' split pass, xn's planes,
    GegluSplitPlan with h = gelu(gate) * value written as planes, SplitPlan
    over h and W2 with the residual added in fp32 (staged: both products in
    split4_kernel's order)."""
    product = _staged_product if staged else _product
    inner = w_out.shape[1]
    xn = _ln_planes(x, gamma, beta, one_pass)
    vg = product(xn, _split(w_in, one_pass))
    value, gate = vg[:, :inner], vg[:, inner:]
    h = 0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value
    out = product(_split(h, one_pass), _split(w_out, one_pass))
    return out + x if residual else out


def emulated_vq_f32(tok, cb, one_pass=False):
    """ctc_vq_nearest_f32: both operands split, SplitPlan into the argmax
    epilogue (the first maximum wins)."""
    return torch.argmax(_product(_split(tok, one_pass), _split(cb, one_pass)), dim=-1)


def _whole_item_core(q, k, v, one_pass):
    """The forward core at n <= 64 without a bias (attn_fwd_packed.cuh) on
    q, k, v [r, h, n, dh]: a stage holds each plane of a sequence's heads as
    one TMA box of nr = n rounded up to 8 rows a head, so the rows past n
    are the next sequence's (zeros past the last); the keys are read in
    8-key groups for S and 16-key steps for P.V, past n under P = 0. S =
    q_hi k_lo + q_lo k_hi + q_hi k_hi; P = exp2(S log2 e - m log2 e) / l
    over the row's n keys; o = the 16-key steps' p_lo v_hi + p_hi v_lo +
    p_hi v_hi."""
    n = q.shape[-2]
    keys = -(-n // 16) * 16
    planes = [*_split(q, one_pass), *_split(k, one_pass), *_split(v, one_pass)]

    def rows(i):   # plane i's rows 0 .. keys - 1 of each sequence as the core reads them
        t = planes[i]
        after = torch.cat([t[1:], torch.zeros_like(t[:1])])
        return torch.cat([t, after, torch.zeros_like(t)], dim=-2)[..., :keys, :]

    s = torch.zeros(q.shape[:-1] + (keys,))
    for pair in ((0, 3), (1, 2), (0, 2)):            # q_hi k_lo, q_lo k_hi, q_hi k_hi
        s = s + planes[pair[0]] @ rows(pair[1]).transpose(-1, -2)
    real = torch.arange(keys) < n
    log2e = 1.4426950408889634
    base = s.masked_fill(~real, -math.inf).amax(-1, keepdim=True) * log2e
    e = torch.where(real, torch.exp2(s * log2e - base), torch.zeros(()))
    p_hi, p_lo = _split(e * (1.0 / e.sum(-1, keepdim=True)), one_pass)
    o = torch.zeros(q.shape)
    for k0 in range(0, keys, 16):
        step = slice(k0, k0 + 16)
        for pp, vi in ((p_lo, 4), (p_hi, 5), (p_hi, 4)):   # p_lo v_hi, p_hi v_lo, p_hi v_hi
            o = o + pp[..., step] @ rows(vi)[..., step, :]
    return o


def emulated_block_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual=False,
                       one_pass=False, staged=False):
    """tc::block_forward_f32: ln_split_kernel (xn's and x's planes),
    QkvSplitPlan with QkvEpi (q, k l2-normed per head and scaled, v, all as
    planes), the fp32 core (split scores; two passes: the row max and sum,
    then p = exp(s - m) / l split in registers and P.V as p_lo v_hi + p_hi
    v_lo + p_hi v_hi; o as planes), SplitPlan over o and Wo (+ x). staged:
    the products in split4_kernel's order, and without a bias at n <= 64 the
    whole-item core."""
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    product = _staged_product if staged else _product
    xn, xs = _ln_planes(x, gamma, None, one_pass), _split(x, one_pass)

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    def unit(t, s):
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12) * s

    q = unit(heads_of(product(xn, _split(wq, one_pass))), qs * scale)
    k = unit(heads_of(product(xs, _split(wk, one_pass))), ks)
    v = heads_of(product(xs, _split(wv, one_pass)))
    if staged and bias is None and n <= 64:
        o = _whole_item_core(q, k, v, one_pass)
    else:
        s = _product(_split(q, one_pass), _split(k, one_pass))
        if bias is not None:
            s = s + bias
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        p = e / e.sum(-1, keepdim=True)
        o = _product(_split(p, one_pass), [t.transpose(-1, -2) for t in _split(v, one_pass)])
    o = o.transpose(1, 2).reshape(r, n, heads * dh)
    out = product(_split(o, one_pass), _split(wo, one_pass))
    return out + x if residual else out


def _missed(got, want, tol) -> float:
    """The largest |got - want| beyond atol = rtol = tol (0 inside the band)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) - tol * (1 + np.abs(want))).max())


# ---- the attention blocks ------------------------------------------------------

# (r, n, bias, residual, staged): the three-pass cases keep their ids
@pytest.mark.parametrize("r,n,with_bias,residual,staged", [
    pytest.param(3, 40, True, False, False, id="3-40-True-False"),
    pytest.param(2, 64, True, True, False, id="2-64-True-True"),
    pytest.param(4, 24, False, False, False, id="4-24-False-False"),
    pytest.param(6, 7, False, True, False, id="6-7-False-True"),
    pytest.param(4, 24, False, True, True, id="staged-4-24-False-True"),
    pytest.param(6, 7, False, False, True, id="staged-6-7-False-False"),
    pytest.param(2, 40, True, True, True, id="staged-2-40-True-True")])
def test_block_f32_chain_matches_the_jax_twin_and_kernel(r, n, with_bias, residual, staged):
    a = _attn_inputs(np.random.default_rng(n + r), r, n, 64, 4, 32, with_bias)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"]) if with_bias else None
    got = emulated_block_f32(*args, bias, SCALE, residual, staged=staged).numpy()
    control = emulated_block_f32(*args, bias, SCALE, residual, one_pass=True,
                                 staged=staged).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items() if v is not None}
    jargs = (j["x"], j["gamma"], j["wq"], j["wk"], j["wv"], j["wo"], j["qs"], j["ks"])
    if with_bias:
        twin = _xla_reference_block(*jargs, j["bias"], SCALE, residual)
        kernel = attention_block_fused(*jargs, j["bias"], SCALE, True, residual)
    else:
        twin = packed_attention_xla(*jargs, SCALE, residual)
        kernel = attention_block_packed(*jargs, SCALE, True, residual)
    plain = attn_block.attn_block_plain(*args, bias, SCALE, residual).numpy()
    tol = STAGED_TOL if staged else ATTN_TOL
    for want in (twin, kernel, plain):
        np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)
        assert _missed(control, want, tol) > 0


# ---- the FF --------------------------------------------------------------------

# (n, dim, residual, staged): inner 42 at dim 64, 85 at 128 (ragged K
# slices); the three-pass cases keep their ids
@pytest.mark.parametrize("n,dim,residual,staged", [
    pytest.param(20, 64, False, False, id="20-64-False"),
    pytest.param(77, 64, True, False, id="77-64-True"),
    pytest.param(33, 128, False, False, id="33-128-False"),
    pytest.param(20, 64, True, True, id="staged-20-64-True"),
    pytest.param(33, 128, True, True, id="staged-33-128-True")])
def test_geglu_ff_f32_chain_matches_the_jax_twin_and_kernel(n, dim, residual, staged):
    a = _ff_inputs(np.random.default_rng(n), n, dim)
    args = _torch_ff_args(a)
    got = emulated_geglu_ff_f32(*args, residual, staged=staged).numpy()
    control = emulated_geglu_ff_f32(*args, residual, one_pass=True, staged=staged).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jargs = (j["x"], j["gamma"], j["beta"], j["wv"], j["wg"], j["w2"])
    twin = _xla_reference(*jargs, residual)
    kernel = geglu_ff_fused(*jargs, True, residual)
    plain = geglu_ff.geglu_ff_plain(*args, residual).numpy()
    tol = STAGED_TOL if staged else FF_TOL
    for want in (twin, kernel, plain):
        np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)
        assert _missed(control, want, tol) > 0


# ---- the VQ --------------------------------------------------------------------

def _near_tie_tokens(rng, m, c, d):
    """Unit codes, and unit tokens: half random, half halfway between two
    codes nudged toward one (sims ~1e-4 apart)."""
    def unit(t):
        return t / np.linalg.norm(t, axis=-1, keepdims=True)

    cb = unit(rng.standard_normal((c, d))).astype(np.float32)
    tok = unit(rng.standard_normal((m, d)))
    i, j = rng.integers(0, c, m // 2), rng.integers(0, c, m // 2)
    tok[: m // 2] = unit(cb[i] * (1 + 2e-4) + cb[j])
    return unit(tok).astype(np.float32), cb


def test_vq_nearest_f32_indices_equal_the_jax_twin_and_kernel():
    tok, cb = _near_tie_tokens(np.random.default_rng(5), 400, 512, 64)
    got = emulated_vq_f32(torch.from_numpy(tok), torch.from_numpy(cb)).numpy()
    control = emulated_vq_f32(torch.from_numpy(tok), torch.from_numpy(cb), one_pass=True).numpy()
    twin = np.asarray(jnp.argmax(jnp.asarray(tok) @ jnp.asarray(cb).T, axis=-1))
    kernel = np.asarray(vq_nearest_pallas(jnp.asarray(tok), jnp.asarray(cb), tm=8, tc=256,
                                          interpret=True))
    plain = vq_nearest.vq_nearest_plain(torch.from_numpy(tok), torch.from_numpy(cb)).numpy()
    for want in (twin, kernel, plain):
        np.testing.assert_array_equal(got, want)
        assert (control != want).sum() > 0


# ---- the wrappers' routing by dtype, through a stand-in library ----------------

class FakeLib:
    """Records each C entry called with its arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("max_n"):
            return lambda: 896
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    launches.reset_launch_counts()
    yield lib
    launches.reset_launch_counts()


@pytest.mark.parametrize("kernel", ["geglu_ff", "vq_nearest", "attn_block", "attn_packed"])
def test_fp32_tensors_reach_the_fp32_entries_and_fp16_is_refused(fake_card, kernel):
    rng = np.random.default_rng(0)
    if kernel == "geglu_ff":
        args = _torch_ff_args(_ff_inputs(rng, 20, 64))
        call = geglu_ff.geglu_ff
        # n, d, inner, ldh, ldw (the planes' rows padded to 128 B), residual, flags
        want_ints = (20, 64, 170, 192, 192, 0, 0)
    elif kernel == "vq_nearest":
        args = (torch.randn(10, 64), torch.randn(30, 64))
        call = vq_nearest.vq_nearest
        want_ints = (10, 30, 64, 0)
    else:
        a = _attn_inputs(rng, 2, 24, 64, 4, 32, kernel == "attn_block")
        args = _torch_attn_args(a) + ((torch.from_numpy(a["bias"]),) if a["bias"] is not None
                                      else ())
        call = getattr(attn_block if kernel == "attn_block" else attn_packed, kernel)
        want_ints = (2, 24, 64, 4, SCALE, 0, 0)       # R, n, D, H, scale, residual, flags
    call(*args)
    assert [c[0] for c in fake_card.calls] == [f"ctc_{kernel}_f32"]
    assert fake_card.calls[0][1][-1 - len(want_ints):-1] == want_ints
    assert launches.launch_counts()[f"{kernel}_f32"] == 1
    assert launches.launch_counts()[kernel] == 0
    half = [t.half() if t.dtype == torch.float32 and t.dim() > 1 else t for t in args]
    with pytest.raises(TypeError, match="dtype"):
        call(*half)


def test_the_fp32_backwards_raise_on_the_card(fake_card, monkeypatch):
    """The fp32 backwards' routes on the card: the wrappers launch the
    dx-only entries (`*_bwd_f32`) with their sizes and every
    parameter-gradient pointer null, and the full wrappers the same entries
    with every pointer set (the fp32 train step); fp16 tensors raise. Through
    the autograd Functions, frozen parameters take the dx-only entries and
    parameters that want their gradients the full ones, the patch embed its
    fp32 residual-saving chain and fp32 weight gradient; no plain version
    runs on a (stand-in) card tensor."""
    from ct_clip_ut_tpu_torch.ops import patch_embed
    from ct_clip_ut_tpu_torch.ops.attention import _BlockFn

    from test_torch_port_cuda import _patch_args, _patch_inputs

    def refused(*args, **kwargs):
        raise AssertionError("a plain version ran on a card tensor")

    for mod, name in ((attn_block, "attn_block_bwd_plain"), (attn_packed, "attn_packed_bwd_plain"),
                      (geglu_ff, "geglu_ff_bwd_plain"), (patch_embed, "patch_embed_res_plain"),
                      (patch_embed, "patch_embed_dkw_plain")):
        monkeypatch.setattr(mod, name, refused)
    a = _attn_inputs(np.random.default_rng(1), 2, 24, 64, 4, 32, True)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"])
    g = torch.zeros_like(args[0])
    ff = _torch_ff_args(_ff_inputs(np.random.default_rng(2)))
    gf = torch.zeros_like(ff[0])
    attn_block.attn_block_bwd_f32(*args, bias, g)
    attn_packed.attn_packed_bwd_f32(*args, g)
    geglu_ff.geglu_ff_bwd_f32(*ff, gf)
    full = (attn_block.attn_block_bwd(*args, bias, g), attn_packed.attn_packed_bwd(*args, g),
            geglu_ff.geglu_ff_bwd(*ff, gf))
    entries = ["ctc_attn_block_bwd_f32", "ctc_attn_packed_bwd_f32", "ctc_geglu_ff_bwd_f32"]
    assert [c[0] for c in fake_card.calls] == entries * 2
    # R, n, D, H, scale, residual, the weight gradient's slices a chunk (0: the
    # 48 tokens in one), flags
    block_ints = (2, 24, 64, 4, SCALE, 0, 0, 0)
    ff_ints = (20, 64, 170, 176, 176, 0, 0)           # n, d, inner, ldh, ldw, residual, flags
    # the parameter-gradient pointers before the sizes: dgamma, dw_qkv, dwo,
    # dqs, dks, [dbias], ln_part, q_part, k_part (then wg_part, null without
    # chunks); h_s, ln_part, dgb, dw_in, dw_out
    for i, (call, ints, grads, tail) in enumerate(zip(fake_card.calls,
                                                      (block_ints, block_ints, ff_ints) * 2,
                                                      (9, 8, 5) * 2, (1, 1, 0) * 2)):
        assert call[1][-1 - len(ints):-1] == ints
        ptrs = call[1][-1 - len(ints) - tail - grads:-1 - len(ints) - tail]
        assert all((p is not None) == (i >= 3) for p in ptrs), call[0]
        assert all(p is None for p in call[1][-1 - len(ints) - tail:-1 - len(ints)])
    counts = launches.launch_counts()
    assert [counts[k] for k in ("attn_block_bwd_f32", "attn_packed_bwd_f32", "geglu_ff_bwd_f32",
                                "attn_block_bwd_f32_full", "attn_packed_bwd_f32_full",
                                "geglu_ff_bwd_f32_full")] == [1] * 6
    assert counts["attn_block_bwd"] + counts["attn_packed_bwd"] + counts["geglu_ff_bwd"] == 0
    hd, d = args[2].shape
    assert [tuple(t.shape) for t in full[0]] == [(2, 24, d), (d,), (hd, d), (hd, d), (hd, d),
                                                 (d, hd), (32,), (32,), (4, 24, 24)]
    assert len(full[1]) == 8
    assert [tuple(t.shape) for t in full[2]] == [(20, 64), (64,), (64,), (340, 64), (64, 170)]
    with pytest.raises(TypeError, match="dtype"):
        attn_block.attn_block_bwd(*(t.half() if t.dim() > 1 else t for t in args), bias, g.half())
    with pytest.raises(TypeError, match="dtype"):
        geglu_ff.geglu_ff_bwd(*(t.half() if t.dim() > 1 else t for t in ff), gf.half())

    def frozen_and_trained(fn, leaves, trained):
        """The entries one backward through fn launches with x alone wanting
        its gradient, then with the leaves in `trained` too."""
        names = []
        for want in (set(), trained):
            fake_card.calls.clear()
            ins = [t.clone().requires_grad_(i == 0 or i in want) for i, t in enumerate(leaves)]
            fn(*ins).sum().backward()
            names.append([c[0] for c in fake_card.calls])
        return names

    launches.reset_launch_counts()
    block = frozen_and_trained(lambda *t: _BlockFn.apply(*t, bias, SCALE, True), args, {2})
    assert block == [["ctc_attn_block_f32", "ctc_attn_block_bwd_f32"]] * 2
    packed = frozen_and_trained(lambda *t: _BlockFn.apply(*t, None, SCALE, True), args, {1, 6})
    assert packed == [["ctc_attn_packed_f32", "ctc_attn_packed_bwd_f32"]] * 2
    ffr = frozen_and_trained(lambda *t: geglu_ff.geglu_ff_grad(*t, True), ff, {1, 4})
    assert ffr == [["ctc_geglu_ff_f32", "ctc_geglu_ff_bwd_f32"]] * 2
    counts = launches.launch_counts()
    assert [counts[k] for k in ("attn_block_bwd_f32", "attn_block_bwd_f32_full",
                                "attn_packed_bwd_f32", "attn_packed_bwd_f32_full",
                                "geglu_ff_bwd_f32", "geglu_ff_bwd_f32_full")] == [1] * 6

    pa = _patch_inputs(np.random.default_rng(3), 2, 4, 8, 8, 4, 2, 64)
    pargs = _patch_args(pa, 4, 2)
    fake_card.calls.clear()
    launches.reset_launch_counts()
    kw = pargs[1].clone().requires_grad_(True)
    patch_embed.patch_embed_grad(pargs[0], kw, *pargs[2:], 4, 2).sum().backward()
    assert [c[0] for c in fake_card.calls] == ["ctc_patch_embed_res_f32",
                                               "ctc_patch_embed_dkw_f32"]
    counts = launches.launch_counts()
    assert (counts["patch_embed_res_f32"], counts["patch_embed_dkw_f32"]) == (1, 1)
    assert counts["patch_embed_res"] + counts["patch_embed_dkw"] == 0
    assert kw.grad.shape == kw.shape


def test_image_dtype_gate():
    """On the card: bf16 and fp32, whichever patch embed (the conv embed's
    fp32 variant, row 5f, serves CTGenerate's one-scan route; the matmul
    embed the attribution suite); fp16 never; any dtype on the CPU."""
    tctvit.check_image_dtype(torch.float32, "cuda", plain=False)
    tctvit.check_image_dtype(torch.bfloat16, "cuda", plain=False)
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        tctvit.check_image_dtype(torch.float16, "cuda", plain=False)
    tctvit.check_image_dtype(torch.float16, "cpu", plain=False)
