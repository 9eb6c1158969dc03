"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX (the GPU machine has none), and the repository's
conftest.py does, so run it there with:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are the flagship widths (D = 512, 8 heads of 32, inner 1365, 8192
codes; the patch embed's 20 x 20 x 10 patches into 512; BERT's 768 wide
layer of 12 heads of 64, FF 3072) with ragged lengths besides the flagship
ones; inputs are bf16, the BERT layer's fp32. The bands: 1.5e-2 max
relative error for the bf16 kernels (both sides round at the same points
and differ in the order of fp32 sums), held on the branch alone as well as
with the residual, and shown to reject a plain version with a norm gain,
LN bias, q/k scale or bias left out; BERT_BAND for the fp32 layer, shown
to reject a plain version without the mask, LN1 gain or QKV bias; >= 99.9%
equal VQ indices, and the first maximum winning a tie.
"""

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_fused,
                                                  patch_embed_plain)
from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

BERT_BAND = 1e-4   # max relative error of the fp32 BERT layer vs its plain version


def _attn_inputs(rng, r, n, d, heads, dh, with_bias):
    """numpy inputs in the JAX kernels' layouts: w* [D, h*dh], wo [h*dh, D]."""
    hd = heads * dh
    f = np.float32
    return dict(
        x=rng.standard_normal((r, n, d)).astype(f),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(f),
        wq=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
        wk=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
        wv=(rng.standard_normal((d, hd)) / np.sqrt(d)).astype(f),
        wo=(rng.standard_normal((hd, d)) / np.sqrt(hd)).astype(f),
        qs=(1.0 + 0.1 * rng.standard_normal(dh)).astype(f),
        ks=(1.0 + 0.1 * rng.standard_normal(dh)).astype(f),
        bias=rng.standard_normal((heads, n, n)).astype(f) if with_bias else None)


def _torch_attn_args(a):
    """The port's layouts: nn.Linear (out, in) weights."""
    t = torch.from_numpy
    return (t(a["x"]), t(a["gamma"]), t(a["wq"].T.copy()), t(a["wk"].T.copy()),
            t(a["wv"].T.copy()), t(a["wo"].T.copy()), t(a["qs"]), t(a["ks"]))


def _ff_inputs(rng, n=20, dim=64):
    inner = int(4 * 2 / 3 * dim)                 # 42: a ragged inner width, like 1365
    f = np.float32
    return dict(x=rng.standard_normal((n, dim)).astype(f),
                gamma=(1.0 + 0.1 * rng.standard_normal(dim)).astype(f),
                beta=(0.1 * rng.standard_normal(dim)).astype(f),
                wv=(rng.standard_normal((dim, inner)) / np.sqrt(dim)).astype(f),
                wg=(rng.standard_normal((dim, inner)) / np.sqrt(dim)).astype(f),
                w2=(rng.standard_normal((inner, dim)) / np.sqrt(inner)).astype(f))


def _torch_ff_args(a):
    w_in = np.concatenate([a["wv"], a["wg"]], axis=1).T.copy()   # [2*inner, dim]
    return (torch.from_numpy(a["x"]), torch.from_numpy(a["gamma"]),
            torch.from_numpy(a["beta"]), torch.from_numpy(w_in),
            torch.from_numpy(a["w2"].T.copy()))


def _patch_inputs(rng, b, T, H, W, patch, t_patch, dim):
    """numpy weights of the plain embed (LN1 gamma/beta [K], projection w
    [K, dim] (in, out) and bias, LN2 gamma/beta [dim]; gains drawn as
    1 + 0.1 N, biases 0.1 N) and an image [b, 1, T, H, W]; K = t_patch *
    patch^2."""
    f = np.float32
    k = t_patch * patch * patch
    return dict(image=rng.standard_normal((b, 1, T, H, W)).astype(f),
                g1=(1.0 + 0.1 * rng.standard_normal(k)).astype(f),
                be1=(0.1 * rng.standard_normal(k)).astype(f),
                w=(rng.standard_normal((k, dim)) / np.sqrt(k)).astype(f),
                bias=(0.1 * rng.standard_normal(dim)).astype(f),
                g2=(1.0 + 0.1 * rng.standard_normal(dim)).astype(f),
                b2=(0.1 * rng.standard_normal(dim)).astype(f))


def _patch_args(a, patch, t_patch, device="cpu", ln1_gain=True):
    """The port's patch_embed arguments (image, kw, s1, b1, g2, b2) from
    _patch_inputs, folded by fold_patch_embed (LN1's gain replaced by ones
    with ln1_gain=False)."""
    k, dim = a["w"].shape
    emb = torch.nn.Sequential(torch.nn.Identity(), torch.nn.LayerNorm(k),
                              torch.nn.Linear(k, dim), torch.nn.LayerNorm(dim))
    with torch.no_grad():
        for mod, weight, bias in ((emb[1], a["g1"], a["be1"]), (emb[2], a["w"].T, a["bias"]),
                                  (emb[3], a["g2"], a["b2"])):
            mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(weight)))
            mod.bias.copy_(torch.from_numpy(bias))
        if not ln1_gain:
            emb[1].weight.fill_(1.0)
        kw, s1, b1 = fold_patch_embed(emb, patch, t_patch)
    return [t.to(device) for t in (torch.from_numpy(a["image"]), kw, s1, b1,
                                   emb[3].weight.detach(), emb[3].bias.detach())]


def _bert_inputs(rng, b, n, d, f, lengths):
    """numpy inputs of the JAX BERT layer, weights (in, out): x [b, n, d];
    mask_row [b, n] additive (0 for the first lengths[i] keys of row i,
    float32 min after); wqkv [d, 3d], wo [d, d], w1 [d, f], w2 [f, d]; LN
    gains 1 + 0.1 N, biases 0.1 N."""
    f32 = np.float32
    mask = np.zeros((b, n), f32)
    for i, length in enumerate(lengths):
        mask[i, length:] = np.finfo(np.float32).min

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(f32)

    def vec(k, base=0.0):
        return (base + 0.1 * rng.standard_normal(k)).astype(f32)

    return dict(x=rng.standard_normal((b, n, d)).astype(f32), mask=mask, wqkv=w(d, 3 * d),
                bqkv=vec(3 * d), wo=w(d, d), bo=vec(d), g1=vec(d, 1.0), be1=vec(d),
                w1=w(d, f), b1=vec(f), w2=w(f, d), b2=vec(d), g2=vec(d, 1.0), be2=vec(d))


BERT_KEYS = ("x", "mask", "wqkv", "bqkv", "wo", "bo", "g1", "be1", "w1", "b1", "w2", "b2",
             "g2", "be2")


def _torch_bert_args(a):
    """The port's layouts: the weight matrices transposed to (out, in)."""
    return [torch.from_numpy(a[k].T.copy() if k in ("wqkv", "wo", "w1", "w2") else a[k])
            for k in BERT_KEYS]


def _unit_rows(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,bias", [(576, True), (100, True), (24, False), (7, False)])
def test_attention_kernels_match_plain_on_card(cuda_device, n, bias, residual):
    """bf16 band 1.5e-2 relative: both sides round at the same points and
    differ only in the order of fp32 sums. Without the residual the band
    holds the attention branch alone, and it rejects a plain version that
    leaves out gamma, q_scale, k_scale or the bias."""
    a = _attn_inputs(np.random.default_rng(5), r=5, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    for i in (0, 2, 3, 4, 5):                         # x and the weights in bf16
        args[i] = args[i].to(torch.bfloat16)
    kern, plain = (attn_block, attn_block_plain) if bias else (attn_packed, attn_packed_plain)
    if bias:
        args.append(torch.from_numpy(a["bias"]).to(cuda_device))
    launches.reset_launch_counts()
    got = kern(*args, 8.0, residual)
    assert _rel_err(got, plain(*args, 8.0, residual)) <= 1.5e-2
    assert sum(launches.launch_counts().values()) == 1
    if not residual:
        for i in (1, 6, 7) + ((8,) if bias else ()):
            wrong = list(args)
            wrong[i] = torch.zeros_like(args[i]) if i == 8 else torch.ones_like(args[i])
            assert _rel_err(got, plain(*wrong, 8.0, False)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [13824, 77])
def test_geglu_ff_kernel_matches_plain_on_card(cuda_device, n, residual):
    rng = np.random.default_rng(6)
    a = _ff_inputs(rng, n=n, dim=512)
    args = [t.to(cuda_device) for t in _torch_ff_args(a)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    got = geglu_ff(*args, residual=residual)
    assert _rel_err(got, geglu_ff_plain(*args, residual=residual)) <= 1.5e-2
    if not residual:
        for i, neutral in ((1, torch.ones_like), (2, torch.zeros_like)):
            wrong = list(args)
            wrong[i] = neutral(args[i])
            assert _rel_err(got, geglu_ff_plain(*wrong, residual=False)) > 1.5e-2, i


@pytest.mark.cuda
def test_vq_nearest_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(_unit_rows(rng, (5000, 512))).to(cuda_device, torch.bfloat16)
    cb = torch.from_numpy(_unit_rows(rng, (8192, 512))).to(cuda_device, torch.bfloat16)
    got, want = vq_nearest(tok, cb), vq_nearest_plain(tok, cb)
    assert (got == want).float().mean().item() >= 0.999
    base = torch.ones((1, 512), device=cuda_device, dtype=torch.bfloat16) / 512 ** 0.5
    tie = torch.cat([-base, base, base, -base.expand(300, 512)])        # duplicates at 1 and 2
    assert int(vq_nearest(base, tie.contiguous())[0]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,H,W", [(2, 240, 480, 480), (1, 20, 60, 100)])
def test_patch_embed_kernel_matches_plain_on_card(cuda_device, b, T, H, W):
    """The flagship volume at B = 2, and B = 1 with a non-flagship H and W
    that 20 divides. Controls: LN1 gain left out of the fold, no mean
    correction (s1 = 0), LN2 bias left out."""
    a = _patch_inputs(np.random.default_rng(8), b, T, H, W, 20, 10, 512)
    args = _patch_args(a, 20, 10, cuda_device)
    args[0] = args[0].to(torch.bfloat16)
    launches.reset_launch_counts()
    got = patch_embed_fused(*args, 20, 10)
    assert launches.launch_counts()["patch_embed"] == 1
    assert got.shape == (b, T // 10, H // 20, W // 20, 512) and got.dtype == torch.bfloat16
    assert _rel_err(got, patch_embed_plain(*args, 20, 10)) <= 1.5e-2
    no_gain = _patch_args(a, 20, 10, cuda_device, ln1_gain=False)
    for i, wrong in ((1, no_gain[1]), (2, torch.zeros_like(args[2])),
                     (5, torch.zeros_like(args[5]))):
        bad = list(args)
        bad[i] = wrong
        if i == 1:
            bad[2] = no_gain[2]
        assert _rel_err(got, patch_embed_plain(*bad, 20, 10)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,lengths", [(36, 512, None), (1, 512, [512]), (3, 136, [7, 136, 60])])
def test_bert_layer_kernel_matches_plain_on_card(cuda_device, b, n, lengths):
    """fp32 [b, n, 768], 12 heads, FF 3072: ragged masks (6 to 14 real keys
    per row and two full rows at the flagship shape), B = 1, and a length
    that 64 does not divide. Controls: mask dropped (where a row is
    padded), LN1 gain left out, QKV bias left out."""
    rng = np.random.default_rng(9)
    if lengths is None:
        lengths = list(rng.integers(6, 15, b))
        lengths[3] = lengths[17] = n
    a = _bert_inputs(rng, b, n, 768, 3072, lengths)
    args = [t.to(cuda_device) for t in _torch_bert_args(a)]
    launches.reset_launch_counts()
    got = bert_layer(*args, 12, 1e-12)
    assert launches.launch_counts()["bert_layer"] == 1
    assert _rel_err(got, bert_layer_plain(*args, 12, 1e-12)) <= BERT_BAND
    for i in (1, 6, 3) if min(lengths) < n else (6, 3):
        bad = list(args)
        bad[i] = torch.ones_like(args[i]) if i == 6 else torch.zeros_like(args[i])
        assert _rel_err(got, bert_layer_plain(*bad, 12, 1e-12)) > BERT_BAND, i
