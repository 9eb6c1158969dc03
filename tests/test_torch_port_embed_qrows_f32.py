"""What the CPU can check of the fp32 patch embed and the fp32 q-row
attention (`ctc_patch_embed_f32`, rows 5f; `ctc_attn_qrows_f32`, row 13f):
CTGenerate's one-scan route.

The kernels run only on the card (chip_smoke.py phase 12 holds them against
their plain versions there). Here each chain is emulated in torch launch by
launch, as tests/test_torch_port_f32_hopper.py does for rows 1f-4f: every
fp32 product as three bf16 products of hi / lo planes. The patch embed:
the patch matrix P written as planes, each patch's LN1 moments in one-pass
fp32, P . Kw^T as SplitPlan, the folded LN1 in fp32, LN2 two-pass. The q-row
attention: LN and x as planes, the split projections, q / k l2-normed and
scaled, v; the core's one pass over 64-key tiles in order (each row's
running max; o's fp32 accumulators and the row sum rescaled by exp(m_old -
m_new) when the max moves; p = exp(s - m_new) split in registers and P.V
as three products; o divided by the row sum once, at the end); the split
output projection with the residual. Each emulation is held against the
port's plain version at fp32 and the JAX package's Pallas kernel in
interpret mode at fp32 (the patch embed also against its XLA twin) within
2e-5 of the output's scale (three bf16 passes keep ~2^-16 of each product;
tests/test_pallas.py:592's band), at temporal patch 1 (the first frame) and
2, K = 4000, and a dense [h, N, N] bias; the one-pass control (every lo
plane zero) misses the band, and so does the core without o's rescale
wherever a row's max moves after its first tile. Last, the wrappers' routing through a stand-in
for the kernel library: fp32 CUDA tensors reach the fp32 entries with their
sizes and count their launches, fp16 and shapes the kernels do not take
raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_attn_qrows import attention_qrows_fused
from ct_clip_ut_tpu.ops.pallas_patch_embed import _xla_twin, patch_embed_fused
from ct_clip_ut_tpu_torch.ops import attn_qrows, launches, patch_embed
from ct_clip_ut_tpu_torch.ops.patch_embed import EPS, _kernel_weight, _patches

from test_torch_port_cuda import _attn_inputs, _patch_args, _patch_inputs, _torch_attn_args
from test_torch_port_f32_hopper import FakeLib, _ln_planes, _missed, _product, _split  # noqa: F401
from test_torch_port_f32_hopper import fake_card  # noqa: F401  (a fixture)

TOL = 2e-5      # atol and rtol, relative to the output's scale (see the docstring)
SCALE = 8.0
KT = 64         # keys a tile of the q-row core


def emulated_patch_embed_f32(image, kw, s1, b1, g2, b2, patch, t_patch, one_pass=False):
    """ctc_patch_embed_f32: patchify_f32_kernel (P's planes, LN1 moments
    one-pass in fp32), SplitPlan P . Kw^T with PatchF32Epi (the folded LN1
    and b1), pe_ln_f32_kernel (LN2, two-pass)."""
    b, _, T, H, W = image.shape
    p = _patches(image, patch, t_patch)
    mean = p.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((p * p).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + EPS)
    conv = _product(_split(p, one_pass), _split(_kernel_weight(kw, torch.float32), one_pass))
    h = (conv - mean * s1) * rstd + b1
    mu = h.mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + EPS) * g2 + b2
    return out.reshape(b, T // t_patch, H // patch, W // patch, -1)


def emulated_qrows_f32(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale, residual=False,
                       one_pass=False, rescale=True):
    """ctc_attn_qrows_f32: ln_split_kernel, QkvSplitPlan + QkvEpi (q, k
    l2-normed per head of 64 and scaled, v, as planes), core_f32_kernel's
    one pass over 64-key tiles, SplitPlan o . Wo^T (+ x). rescale=False
    leaves o's accumulators unscaled when a row's max moves (the control)."""
    b, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    xn, xs = _ln_planes(x, gamma, None, one_pass), _split(x, one_pass)

    def heads_of(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    def unit(t, s):
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12) * s

    q = _split(unit(heads_of(_product(xn, _split(wq, one_pass))), qs * scale), one_pass)
    k = _split(unit(heads_of(_product(xs, _split(wk, one_pass))), ks), one_pass)
    v = _split(heads_of(_product(xs, _split(wv, one_pass))), one_pass)

    def scores(k0):
        s = _product(q, [t[:, :, k0:k0 + KT] for t in k])
        return s if bias is None else s + bias[..., k0:k0 + KT]

    m = torch.full((b, heads, n, 1), -torch.inf)
    l = torch.zeros((b, heads, n, 1))
    o = torch.zeros((b, heads, n, dh))
    for k0 in range(0, n, KT):                      # each tile once, in order
        s = scores(k0)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = _product(_split(p, one_pass), [t[:, :, k0:k0 + KT].transpose(-1, -2) for t in v])
        o = (o * alpha if rescale else o) + pv
        m = mx
    o = (o / l).transpose(1, 2).reshape(b, n, heads * dh)
    out = _product(_split(o, one_pass), _split(wo, one_pass))
    return out + x if residual else out


def _within(got, want, scale):
    """|got - want| <= TOL (scale + |want|), the band relative to the output's scale."""
    return _missed(np.asarray(got) / scale, np.asarray(want) / scale, TOL) <= 0


# ---- row 5f: the patch embed ----------------------------------------------------

@pytest.mark.parametrize("shape,patch,t_patch", [
    ((1, 1, 1, 32, 32), 8, 1),         # the first frame: temporal patch 1, one tile of 16 rows
    ((2, 1, 4, 32, 48), 16, 2),        # temporal patch 2, CTGenerate's K = 512
    ((1, 1, 10, 40, 40), 20, 10)])     # the flagship CT-CLIP patch, K = 4000
def test_patch_embed_f32_chain_matches_plain_and_the_jax_kernel(shape, patch, t_patch):
    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(71 + t_patch), b, T, H, W, patch, t_patch, 64)
    args = _patch_args(a, patch, t_patch)
    got = emulated_patch_embed_f32(*args, patch, t_patch).numpy()
    control = emulated_patch_embed_f32(*args, patch, t_patch, one_pass=True).numpy()
    j = [jnp.asarray(t.numpy()) for t in args]
    kernel = patch_embed_fused(*j, patch, t_patch, True)
    twin = _xla_twin(*j, patch, t_patch)
    plain = patch_embed.patch_embed_plain(*args, patch, t_patch).numpy()
    assert got.shape == (b, T // t_patch, H // patch, W // patch, 64)
    for want in (kernel, twin, plain):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert _within(got, want, scale)
        assert not _within(control, want, scale)


# ---- row 13f: the q-row attention ---------------------------------------------

@pytest.mark.parametrize("b,n,with_bias,residual", [
    (1, 192, True, True),      # the per-item grid: three 64-key tiles, a dense bias
    (2, 128, True, False),     # B = 2 (the JAX kv variant at fp32: the same function)
    (1, 64, False, False)])    # no bias, one tile
def test_qrows_f32_chain_matches_plain_and_the_jax_kernel(b, n, with_bias, residual):
    a = _attn_inputs(np.random.default_rng(81 + n), b, n, 64, 2, 64, with_bias)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"]) if with_bias else None
    got = emulated_qrows_f32(*args, bias[None] if with_bias else None, SCALE, residual).numpy()
    control = emulated_qrows_f32(*args, bias[None] if with_bias else None, SCALE, residual,
                                 one_pass=True).numpy()
    unscaled = emulated_qrows_f32(*args, bias[None] if with_bias else None, SCALE, residual,
                                  rescale=False).numpy()
    j = {k: jnp.asarray(v) for k, v in a.items() if v is not None}
    kernel = attention_qrows_fused(j["x"], j["gamma"], j["wq"], j["wk"], j["wv"], j["wo"],
                                   j["qs"], j["ks"], j.get("bias"), SCALE, 64, True, residual)
    plain = attn_qrows.attn_qrows_plain(*args, bias, SCALE, residual).numpy()
    for want in (kernel, plain):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert _within(got, want, scale)
        assert not _within(control, want, scale)
        # one tile: no max moves, the rescale is the identity
        assert _within(unscaled, want, scale) == (n <= KT)


# ---- the wrappers' routing, through a stand-in library ------------------------

def test_fp32_volumes_reach_the_fp32_patch_embed_entry(fake_card):
    a = _patch_inputs(np.random.default_rng(3), 1, 4, 32, 48, 16, 2, 64)
    args = _patch_args(a, 16, 2)
    out = patch_embed.patch_embed_fused(*args, 16, 2)
    assert out.shape == (1, 2, 2, 3, 64) and out.dtype == torch.float32
    assert [c[0] for c in fake_card.calls] == ["ctc_patch_embed_f32"]
    # B, T, H, W, patch, t_patch, dim, ld, flags
    assert fake_card.calls[0][1][-10:-1] == (1, 4, 32, 48, 16, 2, 64, 512, 0)
    assert launches.launch_counts()["patch_embed_f32"] == 1
    assert launches.launch_counts()["patch_embed"] == 0
    with pytest.raises(TypeError, match="dtype"):
        patch_embed.patch_embed_fused(args[0].half(), *args[1:], 16, 2)
    with pytest.raises(ValueError, match="one channel"):
        patch_embed.patch_embed_fused(args[0][:, :, :3], *args[1:], 16, 2)
    narrow = _patch_args(_patch_inputs(np.random.default_rng(4), 1, 4, 32, 48, 16, 2, 6), 16, 2)
    with pytest.raises(ValueError, match="width that 4 divides"):
        patch_embed.patch_embed_fused(*narrow, 16, 2)
    assert len(fake_card.calls) == 1


def test_fp32_tensors_reach_the_fp32_qrows_entry(fake_card):
    a = _attn_inputs(np.random.default_rng(5), 1, 100, 64, 2, 64, True)
    args = _torch_attn_args(a)
    bias = torch.from_numpy(a["bias"])
    out = attn_qrows.attn_qrows(*args, bias, SCALE, True)
    assert out.shape == (1, 100, 64) and out.dtype == torch.float32
    assert [c[0] for c in fake_card.calls] == ["ctc_attn_qrows_f32"]
    # B, N, D, H, ldb (the fp32 rows 16-B strided as they are), scale, residual, flags
    assert fake_card.calls[0][1][-9:-1] == (1, 100, 64, 2, 100, SCALE, 1, 0)
    assert launches.launch_counts()["attn_qrows_f32"] == 1
    assert launches.launch_counts()["attn_qrows"] == 0
    fake_card.calls.clear()
    odd = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 101, 101))
                           .astype(np.float32))
    x101 = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 101, 64))
                            .astype(np.float32))
    attn_qrows.attn_qrows(x101, *args[1:], odd, SCALE)
    assert fake_card.calls[0][1][-5] == 104          # N = 101: a zero-padded copy, rows of 104
    half = [t.half() if t.dim() > 1 else t for t in args]
    with pytest.raises(TypeError, match="dtype"):
        attn_qrows.attn_qrows(*half, bias.half(), SCALE)
    with pytest.raises(TypeError, match="dtype"):
        attn_qrows.attn_qrows(*args, bias.to(torch.bfloat16), SCALE)
    a32 = _attn_inputs(np.random.default_rng(8), 1, 100, 64, 4, 32, False)
    with pytest.raises(ValueError, match="heads of 64"):
        attn_qrows.attn_qrows(*_torch_attn_args(a32), None, SCALE)
    assert len(fake_card.calls) == 1
