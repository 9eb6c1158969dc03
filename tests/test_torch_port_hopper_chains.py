"""What the CPU can check of the temporal attention block's and the patch
embed's chains on the Hopper GEMM core (csrc/attn_packed.cu through
attn_mma.cuh's block_forward, csrc/patch_embed.cu).

The kernels run only on the card (tests/test_torch_port_cuda.py holds them
against their plain versions there). Here, on the CPU:

- the temporal block's chain emulated in torch at its rounding points and
  tiles: LN rounded to bf16; q from it, k and v from the pre-norm x, in
  fp32; q and k l2-normed and scaled, then split into bf16 hi / lo pairs;
  the split-bf16 scores over keys padded to 64 with zeros and masked to
  -inf past n; the two-pass softmax with p rounded to bf16; o rounded to
  bf16; the output projection with the residual in fp32. At n = 24 and 8
  it equals attn_packed_plain and the JAX XLA twin packed_attention_xla
  within the card's band; padded keys left unmasked (the zero keys take a
  share of the softmax) or k taken from LN(x) (the controls) does not;
- the patchify pass's index map (PatchGeom.base / pixel of
  csrc/patch_common.cuh, restated in Python): the patch matrix it gathers
  equals `_patches` and, frame by frame, the order of the JAX
  `_frame_rearrange`, at 20 x 20 x 10 patches and CTGenerate's 16 x 16 x 2
  and 16 x 16 x 1; every 8-pixel chunk is two 8-B aligned runs of 4
  contiguous pixels there (the kernel's 8-B loads); the chain from that
  matrix (moments, product, folded LN1, h rounded to bf16, LN2) equals
  patch_embed_plain and the JAX `_xla_twin`;
- the TMA plan of the patch GEMM (`ops.patch_embed.tma_operands`): 16-B
  aligned bases and row strides of whole 16-B units at K = 4,000, 512, 256
  and a K that is not a multiple of 8, with ragged M.

Inputs are made from a seed with numpy.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_attn_packed import packed_attention_xla
from ct_clip_ut_tpu.ops.pallas_patch_embed import _frame_rearrange, _xla_twin
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_plain
from ct_clip_ut_tpu_torch.ops.patch_embed import (EPS, _kernel_weight, _patches,
                                                  patch_embed_plain, tma_operands)

from test_torch_port_cuda import _attn_inputs, _patch_args, _patch_inputs, _torch_attn_args

FLOAT_BAND = 1.5e-2  # the card's max relative error band of the bf16 kernels
KC = 64              # keys a chunk of the core; staged keys are padded to it (attn_mma.cuh)
LOG2E = 1.4426950408889634


def _rel_err(got, want):
    got, want = (torch.from_numpy(np.array(t, np.float32)) for t in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


def _split(t):
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def packed_chain(x, gamma, wq, wk, wv, wo, qs, ks, scale, residual, *, fault=""):
    """ctc_attn_packed in torch. fault "unmasked" leaves the padded keys'
    scores in the softmax; "k_from_ln" projects k from LN(x)."""
    bf = torch.bfloat16
    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma).to(bf).float()

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    q = heads_of(xn @ wq.float().t())
    k = heads_of((xn if fault == "k_from_ln" else x32) @ wk.float().t())
    v = heads_of(x32 @ wv.float().t()).to(bf).float()
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12) * (qs * scale)
    k = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-12) * ks
    m_pad = -(-n // KC) * KC
    pad = (0, 0, 0, m_pad - n)
    k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    qh, ql = _split(q)
    kh, kl = _split(k)
    s = qh @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2) + ql @ kh.transpose(-1, -2)
    if fault != "unmasked":
        s[..., n:] = -math.inf
    mx, l = torch.full(s.shape[:-1], -math.inf), torch.zeros(s.shape[:-1])
    for kc in range(0, m_pad, KC):     # pass 1: the running max and sum
        chunk = s[..., kc:kc + KC]
        m_new = torch.maximum(mx, chunk.amax(-1))
        l = (l * torch.exp2(mx * LOG2E - m_new * LOG2E)
             + torch.exp2(chunk * LOG2E - m_new[..., None] * LOG2E).sum(-1))
        mx = m_new
    p = (torch.exp2(s * LOG2E - (mx * LOG2E)[..., None]) / l[..., None]).to(bf).float()
    o = (p @ v).to(bf).float().transpose(1, 2).reshape(r, n, heads * dh)
    out = o @ wo.float().t()
    if residual:
        out = out + x32
    return out.to(bf)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [24, 8])
def test_packed_chain_matches_plain_and_the_jax_twin(n, residual):
    a = _attn_inputs(np.random.default_rng(61), r=5, n=n, d=128, heads=4, dh=32,
                     with_bias=False)
    args = list(_torch_attn_args(a))
    for i in (0, 2, 3, 4, 5):                      # x and the weights in bf16
        args[i] = args[i].to(torch.bfloat16)
    got = packed_chain(*args, 8.0, residual)
    assert _rel_err(got.float(), attn_packed_plain(*args, 8.0, residual).float()) <= FLOAT_BAND
    bf = jnp.bfloat16
    twin = packed_attention_xla(
        jnp.asarray(a["x"], bf), jnp.asarray(a["gamma"]), jnp.asarray(a["wq"], bf),
        jnp.asarray(a["wk"], bf), jnp.asarray(a["wv"], bf), jnp.asarray(a["wo"], bf),
        jnp.asarray(a["qs"]), jnp.asarray(a["ks"]), 8.0, residual)
    twin = np.asarray(twin.astype(jnp.float32))
    assert _rel_err(got.float(), twin) <= FLOAT_BAND
    if not residual:
        for fault in ("unmasked", "k_from_ln"):
            bad = packed_chain(*args, 8.0, False, fault=fault)
            assert _rel_err(bad.float(), twin) > FLOAT_BAND, fault


# ---- the patch embed's patchify pass and its GEMM's TMA plan ----

def patch_base(m, T, H, W, patch, t_patch):
    """PatchGeom::base: element offset of patch m's first pixel, m ordered
    (b, t, hp, wp), in a [B, 1, T, H, W] volume."""
    wp, hp, tt = W // patch, H // patch, T // t_patch
    wi, r = m % wp, m // wp
    hi, r = r % hp, r // hp
    ti, b = r % tt, r // tt
    return ((b * T + ti * t_patch) * H + hi * patch) * W + wi * patch


def patch_pixel(k, H, W, patch):
    """PatchGeom::pixel: offset of pixel k = (tv, p1, wv) within a patch."""
    wv, r = k % patch, k // patch
    return (r // patch * H + r % patch) * W + wv


def patchify(image, patch, t_patch):
    """The patch matrix [M, K] the patchify pass writes, from the index map."""
    b, _, T, H, W = image.shape
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    k = t_patch * patch * patch
    base = patch_base(np.arange(m), T, H, W, patch, t_patch)
    pix = patch_pixel(np.arange(k), H, W, patch)
    return image.reshape(-1)[torch.from_numpy(base[:, None] + pix[None, :])]


GEOMETRIES = [((2, 1, 20, 60, 80), 20, 10), ((1, 1, 4, 32, 48), 16, 2), ((2, 1, 3, 32, 32), 16, 1)]


@pytest.mark.parametrize("shape,patch,t_patch", GEOMETRIES)
def test_patchify_index_map_matches_patches_and_the_jax_rearrange(shape, patch, t_patch):
    rng = np.random.default_rng(62)
    image = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = patchify(image, patch, t_patch)
    assert torch.equal(got, _patches(image, patch, t_patch))
    b, _, T, H, W = shape
    frames = []
    for bi in range(b):
        for ti in range(T // t_patch):
            frame = jnp.asarray(image[bi, 0, ti * t_patch:(ti + 1) * t_patch].numpy())
            xt = np.asarray(_frame_rearrange(frame, patch, t_patch, H, W)[1])  # [wv, m, cin]
            frames.append(xt.transpose(1, 2, 0).reshape(xt.shape[1], -1))     # column (cin, wv)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(frames))
    # each 8-pixel chunk: two runs of 4 contiguous pixels at 8-B aligned offsets
    k = t_patch * patch * patch
    pix = patch_pixel(np.arange(k), H, W, patch)
    base = patch_base(np.arange(got.shape[0]), T, H, W, patch, t_patch)
    runs = pix.reshape(-1, 4)
    assert (np.diff(runs, axis=1) == 1).all()
    assert (runs[:, 0] % 4 == 0).all() and (base % 4 == 0).all()


@pytest.mark.parametrize("shape,patch,t_patch", GEOMETRIES)
def test_patch_chain_from_the_patch_matrix_matches_plain_and_the_jax_twin(shape, patch,
                                                                          t_patch):
    """P from the index map, its LN1 moments (one-pass), P . Kw^T in fp32,
    the folded LN1 and b1, h rounded to bf16, LN2 (two-pass): the kernel's
    rounding points; against patch_embed_plain and `_xla_twin`."""
    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(63), b, T, H, W, patch, t_patch, 64)
    image, kw, s1, b1, g2, b2 = _patch_args(a, patch, t_patch)
    image = image.to(torch.bfloat16)
    p = patchify(image, patch, t_patch).float()
    mean = p.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((p * p).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + EPS)
    conv = p @ _kernel_weight(kw, torch.bfloat16).float().t()
    h = ((conv - mean * s1) * rstd + b1).to(torch.bfloat16).float()
    mu = h.mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(((h - mu) ** 2).mean(-1, keepdim=True) + EPS) * g2 + b2
    got = out.to(torch.bfloat16).reshape(b, T // t_patch, H // patch, W // patch, -1).float()
    want = patch_embed_plain(image, kw, s1, b1, g2, b2, patch, t_patch).float()
    assert _rel_err(got, want) <= FLOAT_BAND
    twin = _xla_twin(jnp.asarray(image.float().numpy(), jnp.bfloat16), jnp.asarray(kw.numpy()),
                     jnp.asarray(s1.numpy()), jnp.asarray(b1.numpy()), jnp.asarray(g2.numpy()),
                     jnp.asarray(b2.numpy()), patch, t_patch)
    assert _rel_err(got, np.asarray(twin.astype(jnp.float32))) <= FLOAT_BAND
    shifted = torch.roll(p, 1, dims=1) @ _kernel_weight(kw, torch.bfloat16).float().t()
    assert _rel_err(shifted, conv) > FLOAT_BAND      # a map one pixel off shows


@pytest.mark.parametrize("shape,patch,t_patch,k,ldp", [
    ((2, 1, 20, 40, 60), 20, 10, 4000, 4000),      # M = 12: ragged
    ((1, 1, 4, 48, 32), 16, 2, 512, 512),          # M = 12
    ((3, 1, 1, 16, 48), 16, 1, 256, 256),          # M = 9
    ((1, 1, 2, 18, 12), 6, 1, 36, 40)])            # K not a multiple of 8
def test_patch_tma_operands_are_16_byte_strided(shape, patch, t_patch, k, ldp):
    """P is a fresh [M, ldp] workspace (ldp = K rounded up to 16 B); the
    folded weight [dim, K] goes as it is where its rows are 16-B strided,
    else as a zero-padded copy whose first K columns are the weight."""
    b, _, T, H, W = shape
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    dim = 64
    rng = np.random.default_rng(64)
    image = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    kw = torch.from_numpy(rng.standard_normal((patch, t_patch * patch, dim)).astype(np.float32))
    ops = tma_operands(image, kw, patch, t_patch)
    assert set(ops) == {"patches", "kwd"}
    for name, (t, rows, cols, ld) in ops.items():
        assert (ld * t.element_size()) % _build.TMA_ALIGN == 0, name
        assert t.data_ptr() % _build.TMA_ALIGN == 0, name
        assert t.stride(0) == ld and t.shape[0] == rows and cols <= ld <= t.shape[1], name
    assert ops["patches"][1:] == (m, k, ldp) and ops["patches"][0].dtype == torch.bfloat16
    kwd, rows, cols, ldk = ops["kwd"]
    assert (rows, cols, ldk) == (dim, k, ldp)
    assert torch.equal(kwd[:, :k], _kernel_weight(kw, torch.bfloat16))
    assert not kwd[:, k:].any()
