"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX (the GPU machine has none), and the repository's
conftest.py does, so run it there with:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are the flagship widths (D = 512, 8 heads of 32, inner 1365, 8192
codes; the patch embed's 20 x 20 x 10 patches into 512; BERT's 768 wide
layer of 12 heads of 64, FF 3072) with ragged lengths besides the flagship
ones; inputs are bf16, the zero-shot BERT layer's fp32 (the train step's bf16
variant, its backward, its Philox masks and the two PEG kernels are at the
end of the file). The bands: 1.5e-2 max
relative error for the bf16 kernels (both sides round at the same points
and differ in the order of fp32 sums), held on the branch alone as well as
with the residual, and shown to reject a plain version with a norm gain,
LN bias, q/k scale or bias left out; BERT_BAND for the fp32 layer, shown
to reject a plain version without the mask, LN1 gain or QKV bias; >= 99.9%
equal VQ indices, and the first maximum winning a tie. The attention
blocks also run at CTGenerate's tokenizer lengths (64 tokens with a bias,
101 without); attn_qrows at MaskGit's width (8 heads of 64) with a bf16
bias, ragged lengths and one sequence or several. The W8A8 GEGLU at the
flagship FF (relative rms band, see INT8_BAND) and the bare cosine core at
the spatial shape, the temporal one and ragged ones, and through a
cross-attention, are at the end.
"""

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
from ct_clip_ut_tpu_torch.ops.attn_qrows import attn_qrows, attn_qrows_plain
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
@pytest.mark.parametrize("n,bias", [(576, True), (100, True), (64, True), (24, False), (7, False),
                                    (101, False)])
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
@pytest.mark.parametrize("b,n,bias", [(1, 640, True), (2, 200, True), (3, 77, True),
                                      (2, 64, False)])
def test_attn_qrows_kernel_matches_plain_on_card(cuda_device, b, n, bias, residual):
    """The same band; without the residual it rejects a plain version that
    leaves out the bias or q_scale, takes k from the LN'd x, or leaves p
    unnormalised."""
    a = _attn_inputs(np.random.default_rng(8), r=b, n=n, d=512, heads=8, dh=64, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    for i in (0, 2, 3, 4, 5):
        args[i] = args[i].to(torch.bfloat16)
    args.append(torch.from_numpy(a["bias"]).to(cuda_device, torch.bfloat16) if bias else None)
    launches.reset_launch_counts()
    got = attn_qrows(*args, 8.0, residual)
    assert _rel_err(got, attn_qrows_plain(*args, 8.0, residual)) <= 1.5e-2
    assert launches.launch_counts()["attn_qrows"] == 1
    if not residual:
        wrong = list(args)
        wrong[6] = torch.ones_like(args[6])
        controls = [attn_qrows_plain(*wrong, 8.0, False),
                    attn_qrows_plain(*args, 8.0, False, faults=("k_from_ln",)),
                    attn_qrows_plain(*args, 8.0, False, faults=("unnormalised",))]
        if bias:
            controls.append(attn_qrows_plain(*args[:8], None, 8.0, False))
        for i, c in enumerate(controls):
            assert _rel_err(got, c) > 1.5e-2, i


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
    padded), LN1 gain left out, QKV bias left out, and the kernel built
    with every lo plane zeroed (one bf16 product for each fp32 one). The
    key chunks the mask removes are skipped: the output is the same bits
    as the kernel's that walks them."""
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer_fp32

    rng = np.random.default_rng(9)
    if lengths is None:
        lengths = list(rng.integers(6, 15, b))
        lengths[3] = lengths[17] = n
    a = _bert_inputs(rng, b, n, 768, 3072, lengths)
    args = [t.to(cuda_device) for t in _torch_bert_args(a)]
    launches.reset_launch_counts()
    got = bert_layer(*args, 12, 1e-12)
    assert launches.launch_counts()["bert_layer"] == 1
    want = bert_layer_plain(*args, 12, 1e-12)
    assert _rel_err(got, want) <= BERT_BAND, _rel_err(got, want)
    for i in (1, 6, 3) if min(lengths) < n else (6, 3):
        bad = list(args)
        bad[i] = torch.ones_like(args[i]) if i == 6 else torch.zeros_like(args[i])
        assert _rel_err(got, bert_layer_plain(*bad, 12, 1e-12)) > BERT_BAND, i
    assert _rel_err(bert_layer_fp32(*args, 12, 1e-12, one_pass=True), want) > BERT_BAND
    assert torch.equal(got, bert_layer_fp32(*args, 12, 1e-12, skip_masked=False))


ATTN_GRADS = ("dx", "dgamma", "dwq", "dwk", "dwv", "dwo", "dqs", "dks", "dbias")


def _attn_bwd_case(cuda_device, r, n, bias):
    a = _attn_inputs(np.random.default_rng(15), r=r, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    for i in (0, 2, 3, 4, 5):
        args[i] = args[i].to(torch.bfloat16)
    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3)).to(torch.bfloat16)
    if bias:
        args.append(torch.from_numpy(a["bias"]).to(cuda_device))
    return args, g


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("r,n,bias", [(5, 576, True), (48, 576, True), (5, 100, True),
                                      (5, 101, True), (2, 1152, True), (5, 24, False),
                                      (5, 7, False)])
def test_attention_backward_kernels_match_plain_on_card(cuda_device, r, n, bias, residual):
    """Every gradient of the attention backward chains within 1.5e-2 max
    relative error of the plain backward (bf16 inputs, fp32 sums in another
    order; the scales summed with atomics): the spatial chain at the
    flagship's R = 48 sequences of 576, at ragged tiles, at an odd n (the
    passes' scalar bias loads) and at the backward's largest n; the temporal
    chain (no bias) at n = 24 and 7."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd, attn_block_bwd_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd, attn_packed_bwd_plain

    args, g = _attn_bwd_case(cuda_device, r, n, bias)
    kern, plain = ((attn_block_bwd, attn_block_bwd_plain) if bias else
                   (attn_packed_bwd, attn_packed_bwd_plain))
    launches.reset_launch_counts()
    got = kern(*args, g, 8.0, residual)
    want = plain(*args, g, 8.0, residual)
    assert sum(launches.launch_counts().values()) == 1
    for name, x, y in zip(ATTN_GRADS, got, want):
        assert torch.isfinite(x).all(), name
        assert _rel_err(x, y) <= 1.5e-2, (name, _rel_err(x, y))


@pytest.mark.cuda
def test_attn_block_bwd_dbias_same_bits_on_two_calls_on_card(cuda_device):
    """dbias is summed over the sequences in registers in a fixed order (no
    atomics): two calls give the same bits; the other gradients agree
    within fp32 rounding of their atomics (1e-5 of their maxima)."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd

    args, g = _attn_bwd_case(cuda_device, 12, 576, True)
    one = attn_block_bwd(*args, g, 8.0, False)
    two = attn_block_bwd(*args, g, 8.0, False)
    assert torch.equal(one[8], two[8])
    for name, x, y in zip(ATTN_GRADS[:8], one, two):
        assert _rel_err(x, y) <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [27648, 13824, 77])
def test_geglu_ff_backward_kernel_matches_plain_on_card(cuda_device, n, residual):
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_plain

    a = _ff_inputs(np.random.default_rng(16), n=n, dim=512)
    args = [t.to(cuda_device) for t in _torch_ff_args(a)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(4)).to(torch.bfloat16)
    got = geglu_ff_bwd(*args, g, residual)
    want = geglu_ff_bwd_plain(*args, g, residual)
    for name, x, y in zip(("dx", "dgamma", "dbeta", "dw_in", "dw_out"), got, want):
        assert torch.isfinite(x).all(), name
        assert _rel_err(x, y) <= 1.5e-2, (name, _rel_err(x, y))


@pytest.mark.cuda
def test_geglu_ff_backward_weight_grads_same_bits_on_card(cuda_device):
    """dWv | dWg and dW2 are summed per tile over every token in one order
    (no atomics): two calls give the same bits, at B = 2's 27648 rows."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd

    a = _ff_inputs(np.random.default_rng(18), n=27648, dim=512)
    args = [t.to(cuda_device) for t in _torch_ff_args(a)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(6)).to(torch.bfloat16)
    one, two = geglu_ff_bwd(*args, g, True), geglu_ff_bwd(*args, g, True)
    assert torch.equal(one[3], two[3]) and torch.equal(one[4], two[4])


@pytest.mark.cuda
@pytest.mark.parametrize("b,T,H,W", [(2, 240, 480, 480), (1, 20, 60, 100)])
def test_patch_embed_res_and_dkw_kernels_match_plain_on_card(cuda_device, b, T, H, W):
    from ct_clip_ut_tpu_torch.ops.patch_embed import (_res_with_patches, patch_embed_dkw,
                                                      patch_embed_dkw_plain, patch_embed_res,
                                                      patch_embed_res_plain)

    a = _patch_inputs(np.random.default_rng(17), b, T, H, W, 20, 10, 512)
    args = _patch_args(a, 20, 10, cuda_device)
    args[0] = args[0].to(torch.bfloat16)
    launches.reset_launch_counts()
    out, conv, stats = patch_embed_res(*args, 20, 10)
    pout, pconv, pstats = patch_embed_res_plain(*args, 20, 10)
    assert _rel_err(out, pout) <= 1.5e-2
    assert _rel_err(conv, pconv) <= 1e-3 and _rel_err(stats, pstats) <= 1e-4
    dconv = torch.randn(conv.shape, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(5)).to(torch.bfloat16)
    got = patch_embed_dkw(args[0], dconv, 20, 10)
    want = patch_embed_dkw_plain(args[0], dconv, 20, 10)
    assert got.shape == (20, 200, 512)
    assert _rel_err(got, want) <= 1.5e-2
    assert _rel_err(got, want.transpose(0, 1).reshape(20, 200, 512)) > 1.5e-2
    assert launches.launch_counts()["patch_embed_res"] == 1
    assert launches.launch_counts()["patch_embed_dkw"] == 1
    # one order of summation, no atomics: two calls, and the call reading
    # the forward's patch matrix, give the same bits
    assert torch.equal(got, patch_embed_dkw(args[0], dconv, 20, 10))
    patches = _res_with_patches(*args, 20, 10)[3]
    assert torch.equal(got, patch_embed_dkw(args[0], dconv, 20, 10, patches))


# a train step's batch of 8 reports, ragged
BERT_B8_LENGTHS = [512, 300, 512, 77, 400, 512, 128, 256]
BERT_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "dbe1", "dw1", "db1", "dw2", "db2",
              "dg2", "dbe2")


def _bert_bf16_case(cuda_device, b, n, lengths, seed):
    rng = np.random.default_rng(seed)
    a = _bert_inputs(rng, b, n, 768, 3072, lengths)
    args = [t.to(cuda_device) for t in _torch_bert_args(a)]
    args[0] = args[0].to(torch.bfloat16)
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32, device=cuda_device)
    return args, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("site,heads,inner,rate", [(0, 12, 512 * 512, 0.1), (1, 1, 512 * 768, 0.1),
                                                   (2, 1, 136 * 768, 0.25)])
def test_bert_keep_mask_kernel_is_the_plain_philox(cuda_device, site, heads, inner, rate):
    """The kernels' Philox4x32-10 against the plain generator, bit for bit;
    the keep share within 4 sigma of 1 - rate; another seed, another mask."""
    from ct_clip_ut_tpu_torch.ops.bert_layer import keep_mask, philox_keep

    seeds = torch.tensor([5, 2 ** 31 - 2, 123456789], dtype=torch.int32, device=cuda_device)
    got = keep_mask(seeds, site, 2, heads, inner, rate)
    assert torch.equal(got, philox_keep(seeds, site, 2, heads, inner, rate))
    assert torch.equal(got, keep_mask(seeds, site, 2, heads, inner, rate))
    share, count = (got > 0).float().mean().item(), got.numel()
    assert abs(share - (1 - rate)) <= 4 * (rate * (1 - rate) / count) ** 0.5
    assert torch.equal(got[got > 0], torch.full_like(got[got > 0], 1.0 / (1.0 - rate)))
    assert not torch.equal(got, keep_mask(seeds + 1, site, 2, heads, inner, rate))


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("b,n,lengths", [(2, 512, [512, 300]), (3, 136, [7, 136, 60]),
                                         (1, 128, [128]), (2, 40, [40, 12]),
                                         (8, 512, BERT_B8_LENGTHS)])
def test_bert_layer_bf16_kernel_matches_plain_on_card(cuda_device, b, n, lengths, train):
    """bf16 [b, n, 768], deterministic and in train mode (p = 0.1 / 0.1)
    through the same Philox masks, band 1.5e-2; a length that 64 does not
    divide pads inside the wrapper. n = 40 pads to one 64-key chunk (the
    attention core's smallest staging); b = 8 at 512 tokens sends the
    N = 768 products to the 128-row gemm_kernel (at least as many tiles as
    SMs). Controls: other seeds (train), the mask dropped, LN1's gain left
    out."""
    args, seeds = _bert_bf16_case(cuda_device, b, n, lengths, 19)
    kw = dict(p_attn=0.1, p_hidden=0.1, train=train, seeds=seeds)
    launches.reset_launch_counts()
    got = bert_layer(*args, 12, 1e-12, **kw)
    assert launches.launch_counts()["bert_layer_bf16"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, 768)
    assert torch.equal(got, bert_layer(*args, 12, 1e-12, **kw))
    want = bert_layer_plain(*args, 12, 1e-12, **kw)
    assert _rel_err(got, want) <= 1.5e-2, _rel_err(got, want)
    if train:
        other = bert_layer_plain(*args, 12, 1e-12, **{**kw, "seeds": seeds + 1})
        assert _rel_err(got, other) > 1.5e-2
    for i in (1, 6) if min(lengths) < n else (6,):
        bad = list(args)
        bad[i] = torch.ones_like(args[i]) if i == 6 else torch.zeros_like(args[i])
        assert _rel_err(got, bert_layer_plain(*bad, 12, 1e-12, **kw)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("b,n,lengths", [(2, 512, [512, 300]), (3, 136, [7, 136, 60]),
                                         (2, 40, [40, 12]), (8, 512, BERT_B8_LENGTHS)])
def test_bert_layer_bwd_kernel_matches_plain_on_card(cuda_device, b, n, lengths, train):
    """dx and the twelve parameter gradients within 1.5e-2 of the plain
    backward through the same masks, and of autograd through the plain
    forward; other seeds read outside the band. The n = 40 and b = 8 cases
    as in the forward's test."""
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer_bwd, bert_layer_bwd_plain

    args, seeds = _bert_bf16_case(cuda_device, b, n, lengths, 20)
    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(6)).to(torch.bfloat16)
    kw = dict(p_attn=0.1, p_hidden=0.1, train=train, seeds=seeds)
    launches.reset_launch_counts()
    got = bert_layer_bwd(*args, g, 12, 1e-12, **kw)
    assert launches.launch_counts()["bert_layer_bwd"] == 1
    want = bert_layer_bwd_plain(*args, g, 12, 1e-12, **kw)
    for name, x, y in zip(BERT_GRADS, got, want):
        assert torch.isfinite(x).all(), name
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert _rel_err(x, y) <= 1.5e-2, (name, _rel_err(x, y))
    leaves = [args[0].clone().requires_grad_(True), args[1]] + [
        t.clone().requires_grad_(True) for t in args[2:]]
    bert_layer_plain(*leaves, 12, 1e-12, **kw).backward(g)
    for name, x, leaf in zip(BERT_GRADS, got, [leaves[0]] + leaves[2:]):
        assert _rel_err(x, leaf.grad) <= 1.5e-2, (name, _rel_err(x, leaf.grad))
    if train:
        other = bert_layer_bwd_plain(*args, g, 12, 1e-12, **{**kw, "seeds": seeds + 1})
        assert _rel_err(got[0], other[0]) > 1.5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,lengths", [(2, 512, [512, 300]), (3, 136, [7, 136, 60]),
                                         (2, 40, [40, 12]), (8, 512, BERT_B8_LENGTHS)])
def test_bert_layer_bwd_same_bits_on_two_calls_on_card(cuda_device, b, n, lengths):
    """dx and the twelve parameter gradients of the bf16 chain in train mode
    are the same bits on two calls with the same seeds: every sum runs in a
    fixed order (a weight gradient's tile in one block over every token; the
    bias and LayerNorm gradients as partial rows summed in order; the
    attention passes' halves added in order), no atomics."""
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer_bwd

    args, seeds = _bert_bf16_case(cuda_device, b, n, lengths, 24)
    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(8)).to(torch.bfloat16)
    kw = dict(p_attn=0.1, p_hidden=0.1, train=True, seeds=seeds)
    first = bert_layer_bwd(*args, g, 12, 1e-12, **kw)
    second = bert_layer_bwd(*args, g, 12, 1e-12, **kw)
    for name, x, y in zip(BERT_GRADS, first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,lengths", [(2, 512, [512, 300]), (3, 136, [7, 136, 60]),
                                         (1, 128, [100])])
def test_bert_f32_train_kernels_match_plain_on_card(cuda_device, b, n, lengths):
    """Rows 6F and 12F: the fp32 layer in train mode (p = 0.1 / 0.1) and
    its backward (dx and the twelve parameter gradients) within BERT_BAND
    of the plain versions through the same Philox masks; n = 136 leaves a
    ragged last 64-key chunk. Controls: the one-pass chains (every lo plane
    zeroed), other seeds, the plain backward's three faults (the attention
    keep left out of dp, the post-FF keep left out of do2, the dropped
    probabilities in ds). Two calls the same bits; train mode at rate 0
    (both thresholds 0) the deterministic chain's bits."""
    from ct_clip_ut_tpu_torch.ops.bert_layer import (bert_layer_bwd, bert_layer_bwd_f32,
                                                     bert_layer_bwd_plain, bert_layer_fp32)

    args, seeds = _bert_bf16_case(cuda_device, b, n, lengths, 30)
    args[0] = torch.from_numpy(np.random.default_rng(31).standard_normal((b, n, 768))
                               .astype(np.float32)).to(cuda_device)
    kw = dict(p_attn=0.1, p_hidden=0.1, train=True, seeds=seeds)
    launches.reset_launch_counts()
    got = bert_layer(*args, 12, 1e-12, **kw)
    assert launches.launch_counts()["bert_layer_f32_train"] == 1
    want = bert_layer_plain(*args, 12, 1e-12, **kw)
    assert _rel_err(got, want) <= BERT_BAND, _rel_err(got, want)
    assert torch.equal(got, bert_layer(*args, 12, 1e-12, **kw))
    assert _rel_err(bert_layer_fp32(*args, 12, 1e-12, **kw, one_pass=True), want) > BERT_BAND
    other = {**kw, "seeds": seeds + 1}
    assert _rel_err(got, bert_layer_plain(*args, 12, 1e-12, **other)) > BERT_BAND
    zero = dict(p_attn=0.0, p_hidden=0.0, train=True, seeds=seeds)
    assert torch.equal(bert_layer_fp32(*args, 12, 1e-12, **zero), bert_layer(*args, 12, 1e-12))

    g = torch.randn(args[0].shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(7))
    grads = bert_layer_bwd(*args, g, 12, 1e-12, **kw)
    assert launches.launch_counts()["bert_layer_bwd_f32"] == 1
    wants = bert_layer_bwd_plain(*args, g, 12, 1e-12, **kw)
    for name, x, y in zip(BERT_GRADS, grads, wants):
        assert x.shape == y.shape and x.dtype == torch.float32, name
        assert _rel_err(x, y) <= BERT_BAND, (name, _rel_err(x, y))
    for name, x, y in zip(BERT_GRADS, grads, bert_layer_bwd(*args, g, 12, 1e-12, **kw)):
        assert torch.equal(x, y), name

    def off(faulty):
        return max(((x - f).abs().max() / y.abs().max()).item()
                   for x, f, y in zip(grads, faulty, wants))

    assert off(bert_layer_bwd_f32(*args, g, 12, 1e-12, **kw, one_pass=True)) > BERT_BAND
    assert off(bert_layer_bwd_plain(*args, g, 12, 1e-12, **other)) > BERT_BAND
    for fault in ("no_attn_keep", "no_hidden_keep", "p_used_in_ds"):
        assert off(bert_layer_bwd_plain(*args, g, 12, 1e-12, **kw, faults=(fault,))) > BERT_BAND


@pytest.mark.cuda
def test_bert_bf16_chain_runs_on_wgmma_and_mma_sync_on_card(cuda_device):
    """The bf16 BERT chain's products (its epilogues on gemm_kernel and
    gemm64_kernel) and weight gradients (BertWgradPlan) have HGMMA
    instructions in their SASS, its attention passes HMMA (cuobjdump of the
    built library)."""
    import shutil
    import subprocess

    from ct_clip_ut_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    hgmma, hmma, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
        elif fn is not None and "HMMA" in line:
            hmma[fn] = hmma.get(fn, 0) + 1
    for mark in ("2bh6QkvEpi", "2bh9HiddenEpi", "2bh7GeluEpi", "2bh10GeluBwdEpi", "2bh9AddF32Epi",
                 "2bh10AddBf16Epi", "2bh7DctxEpi", "2bh13BertWgradPlan", "13gemm64_kernel"):
        assert any(mark in f and c > 0 for f, c in hgmma.items()), mark
    for mark in ("2bh15fwd_core_kernel", "2bh14dq_pass_kernel", "2bh15dkv_pass_kernel"):
        assert any(mark in f and c > 0 for f, c in hmma.items()), mark


def _peg_case(cuda_device, dtype, shape=(2, 24, 24, 24, 512), seed=21):
    gen = torch.Generator(cuda_device).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    g = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    taps = torch.randn((27, c), device=cuda_device, generator=gen) * (3.0 / 27) ** 0.5
    bias = torch.randn((c,), device=cuda_device, generator=gen) * 0.2
    return x, g, taps, bias


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("front", [2, 1, 0])
@pytest.mark.parametrize("shape", [(2, 24, 24, 24, 512), (1, 3, 5, 7, 40), (1, 5, 7, 9, 24),
                                   (2, 4, 13, 30, 72)])
def test_peg_kernel_matches_plain_on_card(cuda_device, shape, front, dtype, with_bias):
    """The stencil on its branch (output minus residual) within 1.5e-2 of
    the plain version (bf16; 1e-5 in fp32), with and without a bias. The
    ragged shapes: H no multiple of the kernel's band (12 rows in bf16, 6
    in fp32), C no multiple of its 64-channel slab, W = 30 in two column
    segments, T = 3 and 4 in chunks shorter than the warm-up. Controls:
    another frame padding, the taps flipped, the bias left out (or added)."""
    from ct_clip_ut_tpu_torch.ops.peg import peg, peg_plain

    x, _, taps, bias = _peg_case(cuda_device, dtype, shape)
    bias, other = (bias, None) if with_bias else (None, bias)
    band = 1.5e-2 if dtype == torch.bfloat16 else 1e-5
    launches.reset_launch_counts()
    got = peg(x, taps, bias, front).float() - x.float()
    assert launches.launch_counts()["peg"] == 1
    assert _rel_err(got, peg_plain(x, taps, bias, front).float() - x.float()) <= band
    for wrong in (peg_plain(x, taps, bias, (front + 1) % 3), peg_plain(x, taps.flip(0), bias, front),
                  peg_plain(x, taps, other, front)):
        assert _rel_err(got, wrong.float() - x.float()) > band


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("front", [2, 1, 0])
@pytest.mark.parametrize("shape", [(2, 24, 24, 24, 512), (1, 3, 5, 7, 40), (1, 5, 7, 9, 24),
                                   (2, 4, 13, 30, 72)])
def test_peg_weight_grads_kernel_matches_plain_on_card(cuda_device, shape, front, dtype):
    """fp32 sums of the same products in another order: 1e-4 relative.
    Deterministic: two calls give the same bits. Control: x shifted by one
    frame. The ragged shapes: H no multiple of the kernel's 6-row band, C
    no multiple of its 64-channel slab, W = 30 in two column segments."""
    from ct_clip_ut_tpu_torch.ops.peg import peg_weight_grads, peg_weight_grads_plain

    x, g, _, _ = _peg_case(cuda_device, dtype, shape)
    launches.reset_launch_counts()
    dw, db = peg_weight_grads(x, g, front)
    assert launches.launch_counts()["peg_weight_grads"] == 1
    want_dw, want_db = peg_weight_grads_plain(x, g, front)
    assert dw.shape == want_dw.shape == (shape[-1], 1, 3, 3, 3)
    assert _rel_err(dw, want_dw) <= 1e-4 and _rel_err(db, want_db) <= 1e-4
    again = peg_weight_grads(x, g, front)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    assert _rel_err(dw, peg_weight_grads_plain(x.roll(1, 1), g, front)[0]) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_peg_grad_function_matches_autograd_of_plain_on_card(cuda_device, causal):
    """peg_grad's dx, dw and db against autograd through peg_plain."""
    from ct_clip_ut_tpu_torch.ops.peg import front_pad, peg_grad, peg_plain, taps_of

    x, g, taps, bias = _peg_case(cuda_device, torch.bfloat16, (2, 6, 24, 24, 512))
    weight = taps.t().reshape(512, 1, 3, 3, 3).contiguous()
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    peg_grad(*leaves, causal).backward(g)
    ref = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    peg_plain(ref[0], taps_of(ref[1]), ref[2], front_pad(causal)).backward(g)
    for got, want in zip(leaves, ref):
        assert got.grad.dtype == want.grad.dtype
        assert _rel_err(got.grad, want.grad) <= 1.5e-2


@pytest.mark.cuda
def test_bert_apply_train_mode_takes_the_kernels_on_card(cuda_device):
    """A train-mode bert_apply at 512 tokens runs every layer and its
    backward through the kernels, none through the layer loop: in bf16
    bert_layer_bf16 and bert_layer_bwd; in fp32, at BertConfig's 12 layers,
    bert_layer_f32_train and bert_layer_bwd_f32 (12 + 12), no bf16 entry.
    The same generator state repeats each bit for bit, another differs."""
    from ct_clip_ut_tpu_torch.config import BertConfig
    from ct_clip_ut_tpu_torch.models import bert as tbert

    ids = torch.randint(0, 512, (2, 512), device=cuda_device)
    mask = torch.ones_like(ids)
    mask[1, 300:] = 0

    def run(mod, dtype, seed):
        mod.zero_grad()
        gen = torch.Generator(cuda_device).manual_seed(seed)
        out = tbert.bert_apply(mod, ids, mask, compute_dtype=dtype, generator=gen,
                               deterministic=False)
        out.float().square().mean().backward()
        return out.detach(), mod.encoder.layer[0].intermediate["dense"].weight.grad.clone()

    for dtype, layers, fwd, bwd in ((torch.bfloat16, 2, "bert_layer_bf16", "bert_layer_bwd"),
                                    (torch.float32, 12, "bert_layer_f32_train",
                                     "bert_layer_bwd_f32")):
        torch.manual_seed(0)
        mod = tbert.Bert(BertConfig(vocab_size=512, num_layers=layers)).to(cuda_device)
        launches.reset_launch_counts()
        out, grad = run(mod, dtype, 1)
        counts = launches.launch_counts()
        assert {k: v for k, v in counts.items() if v} == {fwd: layers, bwd: layers}
        assert out.dtype == dtype and torch.isfinite(grad).all() and grad.abs().max() > 0
        again, grad_again = run(mod, dtype, 1)
        other, _ = run(mod, dtype, 2)
        assert torch.equal(out, again) and torch.equal(grad, grad_again)
        assert not torch.equal(out, other)


@pytest.mark.cuda
def test_transformer_peg_pallas_runs_no_conv3d_on_card(cuda_device, monkeypatch):
    """Transformer(peg_pallas=True): forward and backward through the peg and
    peg_weight_grads kernels, no F.conv3d; within the bf16 band of the
    default route's output."""
    from ct_clip_ut_tpu_torch.config import TransformerConfig
    from ct_clip_ut_tpu_torch.ops.transformer import Transformer, transformer

    cfg = TransformerConfig(dim=512, depth=2, dim_head=32, heads=8, peg=True, peg_causal=True,
                            peg_pallas=True)
    torch.manual_seed(0)
    fused = Transformer(cfg).to(cuda_device)
    default = Transformer(TransformerConfig(**{**cfg.__dict__, "peg_pallas": False})).to(cuda_device)
    default.load_state_dict(fused.state_dict())
    x = torch.randn((2 * 4, 64, 512), device=cuda_device).to(torch.bfloat16)
    want, _ = transformer(default, x, video_shape=(2, 4, 8, 8))

    def no_conv(*a, **k):
        raise AssertionError("F.conv3d called on the peg_pallas route")

    monkeypatch.setattr(torch.nn.functional, "conv3d", no_conv)
    launches.reset_launch_counts()
    xi = x.clone().requires_grad_(True)
    got, _ = transformer(fused, xi, video_shape=(2, 4, 8, 8))
    got.float().square().mean().backward()
    counts = launches.launch_counts()
    assert counts["peg"] == 4 and counts["peg_weight_grads"] == 2
    assert _rel_err(got, want) <= 3e-2
    assert torch.isfinite(fused.layers[0][0].dsconv.weight.grad).all()


INT8_BAND = 2e-3   # relative rms of geglu_ff_int8 vs its plain version


def _rel_rms(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,d,inner", [(13824, 512, 1365), (77, 512, 1365), (27648, 512, 1365),
                                       (300, 256, 688), (200, 768, 2048)])
def test_geglu_ff_int8_kernel_matches_plain_on_card(cuda_device, n, d, inner, residual):
    """The flagship FF (512 -> 1365, padded to 1376) quantised per row, at
    the smoke's N = 27,648 too, a narrower FF (256 -> 688: 11 tiles of the
    first product, 2 of the second) and a wider one (768 -> 2048: the row
    passes' four- and sixteen-chunk rows, six K slices a first-product
    tile). The two sides differ where LN's
    last bit moves a code across a .5 boundary, a few codes in a tensor:
    INT8_BAND relative rms, which rejects h left unquantised, one scale per
    tensor, and sv and sg swapped. Two calls give the same bits."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import geglu_ff_int8, geglu_ff_int8_plain
    from ct_clip_ut_tpu_torch.ops.layers import FeedForward
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

    torch.manual_seed(0)
    ff = FeedForward(d, inner)
    with torch.no_grad():
        ff[0].weight.normal_(1.0, 0.2)
        ff[0].bias.normal_(0.0, 0.1)
    q = quantize_ff_params(ff).to(cuda_device)
    args = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    x = torch.randn((n, d), device=cuda_device).to(torch.bfloat16)
    launches.reset_launch_counts()
    got = geglu_ff_int8(x, *args, residual=residual)
    assert launches.launch_counts()["geglu_ff_int8"] == 1 and torch.isfinite(got.float()).all()
    assert _rel_rms(got, geglu_ff_int8_plain(x, *args, residual=residual)) <= INT8_BAND
    assert torch.equal(got, geglu_ff_int8(x, *args, residual=residual))
    if not residual:
        swapped = list(args)
        swapped[5], swapped[6] = args[6], args[5]
        for c in (geglu_ff_int8_plain(x, *args, faults=("h_float",)),
                  geglu_ff_int8_plain(x, *args, faults=("per_tensor",)),
                  geglu_ff_int8_plain(x, *swapped)):
            assert _rel_rms(got, c) > INT8_BAND
    with pytest.raises(NotImplementedError, match="serving-only"):
        geglu_ff_int8(x.float().requires_grad_().to(torch.bfloat16), *args)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [27648, 13824, 77, 301, 110592])
def test_geglu_ff_int8_f32_kernel_matches_plain_on_card(cuda_device, n, residual):
    """The fp32-activation form (row 15f) at zero-shot's token count, a
    volume's, 77 and an odd 301 rows, and a quantised occlusion chunk's
    temporal tokens (110,592): fp32 out, counted as
    geglu_ff_int8_f32 (the bf16 form not at all), INT8_BAND against the
    plain version with the same controls, two calls the same bits."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import geglu_ff_int8, geglu_ff_int8_plain
    from ct_clip_ut_tpu_torch.ops.layers import FeedForward
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

    torch.manual_seed(1)
    ff = FeedForward(512, 1365)
    with torch.no_grad():
        ff[0].weight.normal_(1.0, 0.2)
        ff[0].bias.normal_(0.0, 0.1)
    q = quantize_ff_params(ff).to(cuda_device)
    args = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    x = torch.randn((n, 512), device=cuda_device)
    launches.reset_launch_counts()
    got = geglu_ff_int8(x, *args, residual=residual)
    counts = launches.launch_counts()
    assert counts["geglu_ff_int8_f32"] == 1 and counts["geglu_ff_int8"] == 0
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel_rms(got, geglu_ff_int8_plain(x, *args, residual=residual)) <= INT8_BAND
    assert torch.equal(got, geglu_ff_int8(x, *args, residual=residual))
    if not residual:
        swapped = list(args)
        swapped[5], swapped[6] = args[6], args[5]
        for c in (geglu_ff_int8_plain(x, *args, faults=("h_float",)),
                  geglu_ff_int8_plain(x, *args, faults=("per_tensor",)),
                  geglu_ff_int8_plain(x, *swapped)):
            assert _rel_rms(got, c) > INT8_BAND


@pytest.mark.cuda
def test_geglu_ff_int8_chain_runs_on_int8_wgmma_on_card(cuda_device):
    """geglu_ff_int8's two products (HEpi and OutEpi on the Hopper core's
    int8 path) have IGMMA instructions in their SASS
    (cuobjdump of the built library), and the chain launches no kernel
    outside ctc::sm90 / ctc::q8."""
    import shutil
    import subprocess

    from torch.profiler import ProfilerActivity, profile

    from ct_clip_ut_tpu_torch import _build
    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import geglu_ff_int8
    from ct_clip_ut_tpu_torch.ops.layers import FeedForward
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    igmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and "IGMMA" in line:
            igmma[fn] = igmma.get(fn, 0) + 1
    for mark in ("11gemm_kernelINS_2q810GegluPlan8ENS2_4HEpi",
                 "11gemm_kernelINS_2q811LinearPlan8ENS2_6OutEpi"):
        assert any(mark in f and n > 0 for f, n in igmma.items()), mark
    q = quantize_ff_params(FeedForward(512, 1365)).to(cuda_device)
    x = torch.randn((1000, 512), device=cuda_device).to(torch.bfloat16)
    args = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    geglu_ff_int8(x, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        geglu_ff_int8(x, *args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 4 and sum("gemm_kernel" in k for k in names) == 2, names
    assert all("sm90" in k or "q8::" in k for k in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,m,bias", [(384, 576, 576, True), (9216, 24, 24, False),
                                         (24, 200, 77, True), (16, 130, 800, False),
                                         (16, 130, 1152, True)])
def test_cosine_attention_kernel_matches_plain_on_card(cuda_device, bh, n, m, bias):
    """The bf16 band; it rejects a plain version without q_scale, without
    k_scale or without the bias."""
    from ct_clip_ut_tpu_torch.ops.cosine_attention import (cosine_attention,
                                                           cosine_attention_plain)

    g = torch.Generator(device=cuda_device).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    q, k, v = (randn(bh, r, 32).to(torch.bfloat16) for r in (n, m, m))
    qs, ks = 1.0 + 0.1 * randn(32), 1.0 + 0.1 * randn(32)
    b = 0.5 * randn(8, n, m) if bias else None
    launches.reset_launch_counts()
    got = cosine_attention(q, k, v, qs, ks, b, 8, 8.0)
    assert launches.launch_counts()["cosine_attention"] == 1
    assert _rel_err(got, cosine_attention_plain(q, k, v, qs, ks, b, 8, 8.0)) <= 1.5e-2
    controls = [cosine_attention_plain(q, k, v, torch.ones_like(qs), ks, b, 8, 8.0),
                cosine_attention_plain(q, k, v, qs, torch.ones_like(ks), b, 8, 8.0)]
    if bias:
        controls.append(cosine_attention_plain(q, k, v, qs, ks, None, 8, 8.0))
    for i, c in enumerate(controls):
        assert _rel_err(got, c) > 1.5e-2, i


@pytest.mark.cuda
def test_cross_attention_takes_the_cosine_kernel_on_card(cuda_device):
    """A cross-attention of 256 queries, no null key/values or mask: one
    cosine_attention launch, within the bf16 band of plain=True; past the
    kernel's key limit the plain path, no launch."""
    from ct_clip_ut_tpu_torch.config import AttentionConfig
    from ct_clip_ut_tpu_torch.ops.attention import Attention, attention
    from ct_clip_ut_tpu_torch.ops.cosine_attention import cosine_attention_max_m

    torch.manual_seed(1)
    attn = Attention(AttentionConfig(dim=512, dim_head=32, heads=8, dim_context=768)).to(
        cuda_device)
    x = torch.randn((2, 256, 512), device=cuda_device).to(torch.bfloat16)
    for m, launched in ((120, 1), (cosine_attention_max_m() + 1, 0)):
        ctx = torch.randn((2, m, 768), device=cuda_device).to(torch.bfloat16)
        launches.reset_launch_counts()
        with torch.no_grad():
            got = attention(attn, x, context=ctx, return_weights=False, residual=False).out
            want = attention(attn, x, context=ctx, return_weights=False, residual=False,
                             plain=True).out
        assert launches.launch_counts()["cosine_attention"] == launched
        assert _rel_err(got, want) <= 1.5e-2


# ---- the Hopper GEMM core (csrc/gemm_sm90.cuh) and the two kernels on it ----

GEMM_BAND = 1e-4   # max relative error of the core's fp32 sums vs torch.matmul in fp32


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,pad", [(333, 300, 200, 0), (77, 129, 1365, 3), (128, 256, 64, 0),
                                       (1, 8, 8, 8), (27648, 512, 512, 0)])
def test_gemm_sm90_core_matches_matmul_on_card(cuda_device, m, n, k, pad):
    """C = A . B^T through the bare core (ctc_gemm_sm90_check), bf16 operands
    of row stride k + pad, against torch.matmul of the same values in fp32
    (TF32 off). M, N and K that 64 and 128 do not divide exercise TMA's
    zero fill and the epilogue's masks; the padded rows, filled with NaN,
    must not reach C. Controls: B's rows shifted by one, K cut to its first
    64-wide slice."""
    from ct_clip_ut_tpu_torch import _build

    g = torch.Generator(cuda_device).manual_seed(21)
    a = torch.full((m, k + pad), float("nan"), device=cuda_device).to(torch.bfloat16)
    b = torch.full((n, k + pad), float("nan"), device=cuda_device).to(torch.bfloat16)
    a[:, :k] = torch.randn((m, k), device=cuda_device, generator=g).to(torch.bfloat16)
    b[:, :k] = torch.randn((n, k), device=cuda_device, generator=g).to(torch.bfloat16)
    c = torch.empty((m, n), device=cuda_device)
    err = _build.load().ctc_gemm_sm90_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                                            k + pad, k + pad, 0,
                                            torch.cuda.current_stream(cuda_device).cuda_stream)
    _build.check(err, "ctc_gemm_sm90_check")
    af, bf = a[:, :k].float(), b[:, :k].float()
    want = af @ bf.t()
    assert c.isfinite().all()
    assert _rel_err(c, want) <= GEMM_BAND
    if n > 1:
        assert _rel_err(c, af @ bf.roll(1, 0).t()) > GEMM_BAND
    if k > 64:
        assert _rel_err(c, af[:, :64] @ bf[:, :64].t()) > GEMM_BAND


def _planes(t):
    """hi / lo bf16 planes [2, rows, cols] of an fp32 matrix, as the fp32
    BERT layer's split pass writes them."""
    hi = t.to(torch.bfloat16)
    return torch.stack([hi, (t - hi.float()).to(torch.bfloat16)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(18432, 2304, 768), (333, 300, 200), (77, 136, 3072)])
def test_gemm_sm90_split_plan_matches_fp32_matmul_on_card(cuda_device, m, n, k):
    """SplitPlan's three passes over hi / lo planes of fp32 A [M, K] and B
    [N, K] (ctc_gemm_sm90_check with split) against torch.matmul in fp32
    (TF32 off), within GEMM_BAND; the hi planes alone (one bf16 product)
    miss it."""
    from ct_clip_ut_tpu_torch import _build

    g = torch.Generator(cuda_device).manual_seed(22)
    a = torch.randn((m, k), device=cuda_device, generator=g)
    b = torch.randn((n, k), device=cuda_device, generator=g) / k ** 0.5
    pa, pb = _planes(a), _planes(b)
    c = torch.empty((m, n), device=cuda_device)
    err = _build.load().ctc_gemm_sm90_check(pa.data_ptr(), pb.data_ptr(), c.data_ptr(), m, n, k,
                                            k, k, 1,
                                            torch.cuda.current_stream(cuda_device).cuda_stream)
    _build.check(err, "ctc_gemm_sm90_check")
    want = a @ b.t()
    assert c.isfinite().all()
    assert _rel_err(c, want) <= GEMM_BAND, _rel_err(c, want)
    assert _rel_err(pa[0].float() @ pb[0].float().t(), want) > GEMM_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [2, 3, 4])
@pytest.mark.parametrize("m,n,k", [(1024, 768, 3072), (576, 768, 2304), (333, 304, 200),
                                   (64, 128, 64)])
def test_gemm_sm90_narrow_tiles_and_stored_weights_on_card(cuda_device, mode, m, n, k):
    """The bf16 BERT chain's variants of the core through ctc_gemm_sm90_check:
    64-row tiles with the K slices split between the two warpgroups and
    summed in order (mode 2: gemm64_kernel), B read MN-major from a weight
    W [K, N] as it is stored (mode 3: LinearKNPlan), both (mode 4); against
    torch.matmul in fp32 within GEMM_BAND, the same bits on two calls.
    Control: B's rows shifted by one."""
    from ct_clip_ut_tpu_torch import _build

    g = torch.Generator(cuda_device).manual_seed(26)
    a = torch.randn((m, k), device=cuda_device, generator=g).to(torch.bfloat16)
    w = torch.randn((n, k), device=cuda_device, generator=g).to(torch.bfloat16)
    b, ldb = (w.t().contiguous(), n) if mode >= 3 else (w, k)

    def run():
        c = torch.empty((m, n), device=cuda_device)
        err = _build.load().ctc_gemm_sm90_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n,
                                                k, k, ldb, mode,
                                                torch.cuda.current_stream(cuda_device).cuda_stream)
        _build.check(err, "ctc_gemm_sm90_check")
        return c

    c = run()
    af, wf = a.float(), w.float()
    want = af @ wf.t()
    assert c.isfinite().all()
    assert _rel_err(c, want) <= GEMM_BAND, _rel_err(c, want)
    assert torch.equal(c, run())
    assert _rel_err(c, af @ wf.roll(1, 0).t()) > GEMM_BAND


def _wgrad_check(cuda_device, a, b, rows, cols):
    from ct_clip_ut_tpu_torch import _build

    c = torch.empty((rows, cols), device=cuda_device)
    err = _build.load().ctc_wgrad_sm90_check(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                             a.shape[0], rows, cols, a.shape[1], b.shape[1],
                                             torch.cuda.current_stream(cuda_device).cuda_stream)
    _build.check(err, "ctc_wgrad_sm90_check")
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,rows,cols,pad", [(27648, 512, 1365, 11), (27648, 2730, 512, 0),
                                                  (200, 300, 129, 8), (64, 128, 128, 0),
                                                  (77, 5, 9, 7)])
def test_wgrad_sm90_core_matches_matmul_on_card(cuda_device, tokens, rows, cols, pad):
    """C = A^T B over the token rows through the MN-major core
    (ctc_wgrad_sm90_check; A [tokens, rows], B [tokens, cols], bf16 with
    rows padded by `pad` or more NaN columns to a 16-B stride, which must
    not reach C) against
    torch.matmul in fp32: dW2's and dWv | dWg's shapes at B = 2, and ragged
    tiles and token slices. The same bits on two calls (one block sums a
    tile over every token in order). Controls: B's columns shifted by one,
    the tokens cut to the first 64-row slice."""
    g = torch.Generator(cuda_device).manual_seed(23)
    lda, ldb = (-(-(c + pad) // 8) * 8 for c in (rows, cols))     # 16-B rows for TMA
    a = torch.full((tokens, lda), float("nan"), device=cuda_device).to(torch.bfloat16)
    b = torch.full((tokens, ldb), float("nan"), device=cuda_device).to(torch.bfloat16)
    a[:, :rows] = torch.randn((tokens, rows), device=cuda_device, generator=g).to(torch.bfloat16)
    b[:, :cols] = torch.randn((tokens, cols), device=cuda_device, generator=g).to(torch.bfloat16)
    c = _wgrad_check(cuda_device, a, b, rows, cols)
    af, bf = a[:, :rows].float(), b[:, :cols].float()
    want = af.t() @ bf
    assert c.isfinite().all()
    assert _rel_err(c, want) <= GEMM_BAND, _rel_err(c, want)
    assert torch.equal(c, _wgrad_check(cuda_device, a, b, rows, cols))
    if cols > 1:
        assert _rel_err(c, af.t() @ bf.roll(1, 1)) > GEMM_BAND
    if tokens > 64:
        assert _rel_err(c, af[:64].t() @ bf[:64]) > GEMM_BAND


@pytest.mark.cuda
def test_wgrad_sm90_kernels_run_on_wgmma_on_card(cuda_device):
    """The weight-gradient kernels on the MN-major core (the FF backward's
    FFWgradPlan, the check entry's WgradPlan, the patch embed's
    PatchWgradPlan) have HGMMA instructions in
    their SASS (cuobjdump of the built library); the fp32 BERT layer's
    products (SplitPlan) and the FF backward's value / gate and dh kernel
    too."""
    import shutil
    import subprocess

    from ct_clip_ut_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    for mark in ("4sm9012wgrad_kernel", "11FFWgradPlan", "9WgradPlan", "9SplitPlan",
                 "3ffb15gate_bwd_kernel", "2pe14PatchWgradPlan"):
        assert any(mark in f and n > 0 for f, n in counts.items()), mark


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,inner", [(12928, 1365), (300, 1344)])
def test_geglu_ff_kernel_on_the_hopper_core_on_card(cuda_device, n, inner, residual):
    """MaskGit's FF rows at B = 2 (12928 = 2 x 6464) with the ragged inner
    width 1365 (w_out padded per call), and an inner width that 64 divides
    (w_out read as it is, every tile of the first product full). The bf16
    band and its controls as for the flagship shapes."""
    rng = np.random.default_rng(22)
    a = _ff_inputs(rng, n=n, dim=512)
    a["wv"], a["wg"] = (rng.standard_normal((512, inner)).astype(np.float32) / np.sqrt(512)
                        for _ in range(2))
    a["w2"] = (rng.standard_normal((inner, 512)) / np.sqrt(inner)).astype(np.float32)
    args = [t.to(cuda_device) for t in _torch_ff_args(a)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    launches.reset_launch_counts()
    got = geglu_ff(*args, residual=residual)
    assert launches.launch_counts()["geglu_ff"] == 1
    assert _rel_err(got, geglu_ff_plain(*args, residual=residual)) <= 1.5e-2
    if not residual:
        for i, neutral in ((1, torch.ones_like), (2, torch.zeros_like)):
            wrong = list(args)
            wrong[i] = neutral(args[i])
            assert _rel_err(got, geglu_ff_plain(*wrong, residual=False)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [832, 33])
def test_attn_block_kernel_long_and_odd_on_card(cuda_device, n, residual):
    """R = 3 sequences of 832 tokens (the longest length callers gave the
    earlier kernel, 160 KB of staged keys a block) and of 33 (odd: the bias
    read one column at a time, a query tile and a key chunk mostly
    padding). The bf16 band; controls: gamma, q_scale, k_scale or the bias
    left out."""
    a = _attn_inputs(np.random.default_rng(23), r=3, n=n, d=512, heads=8, dh=32, with_bias=True)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    for i in (0, 2, 3, 4, 5):
        args[i] = args[i].to(torch.bfloat16)
    args.append(torch.from_numpy(a["bias"]).to(cuda_device))
    launches.reset_launch_counts()
    got = attn_block(*args, 8.0, residual)
    assert launches.launch_counts()["attn_block"] == 1
    assert _rel_err(got, attn_block_plain(*args, 8.0, residual)) <= 1.5e-2
    if not residual:
        for i in (1, 6, 7, 8):
            wrong = list(args)
            wrong[i] = torch.zeros_like(args[i]) if i == 8 else torch.ones_like(args[i])
            assert _rel_err(got, attn_block_plain(*wrong, 8.0, False)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [8, 24, 40])
@pytest.mark.parametrize("r", [1, 3, 577])
def test_attn_packed_kernel_on_the_hopper_chain_on_card(cuda_device, r, n, residual):
    """The temporal block's chain (LN pass, QkvPlan + QkvEpi, the split-bf16
    core without a bias, the output projection) at ragged sequence counts
    (577: four full and one partial 128-row tile of rows past 128 x 4) and
    lengths inside one 64-key chunk. The bf16 band; controls: gamma,
    q_scale or k_scale left out."""
    a = _attn_inputs(np.random.default_rng(24), r=r, n=n, d=512, heads=8, dh=32,
                     with_bias=False)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    for i in (0, 2, 3, 4, 5):
        args[i] = args[i].to(torch.bfloat16)
    launches.reset_launch_counts()
    got = attn_packed(*args, 8.0, residual)
    assert launches.launch_counts()["attn_packed"] == 1
    assert got.shape == (r, n, 512) and got.dtype == torch.bfloat16
    assert _rel_err(got, attn_packed_plain(*args, 8.0, residual)) <= 1.5e-2
    if not residual:
        for i in (1, 6, 7):
            wrong = list(args)
            wrong[i] = torch.ones_like(args[i])
            assert _rel_err(got, attn_packed_plain(*wrong, 8.0, False)) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,t_patch,dim", [
    ((1, 1, 20, 60, 100), 20, 10, 512), ((3, 1, 10, 40, 60), 20, 10, 512),  # M = 30, 18
    ((2, 1, 200, 128, 128), 16, 2, 512), ((2, 1, 1, 128, 128), 16, 1, 512),  # CTGenerate's
    ((2, 1, 2, 18, 30), 6, 1, 512),                                  # K = 36, 2-B pixel loads
    ((1, 1, 10, 40, 40), 20, 10, 99)])                               # an odd width
def test_patch_embed_chain_on_the_hopper_core_on_card(cuda_device, shape, patch, t_patch, dim):
    """patch_embed and patch_embed_res (the patchify pass, the GEMM on the
    Hopper core reading P through TMA with the folded-LN1 epilogue, LN2) at
    B = 1 and 3 on small volumes, at CTGenerate's geometries (K = 512 and
    256), at a patch width 4 does not divide (the pixel-by-pixel gather, a
    K that is no multiple of 8: P and the weight padded to 40 columns) and
    at an odd embedding width (scalar stores). Both entries give the same
    bits; conv and stats come from the res launch. The bf16 band; controls:
    LN1 gain left out of the fold, no mean correction (s1 = 0), LN2 bias
    left out."""
    from ct_clip_ut_tpu_torch.ops.patch_embed import patch_embed_res, patch_embed_res_plain

    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(25), b, T, H, W, patch, t_patch, dim)
    args = _patch_args(a, patch, t_patch, cuda_device)
    args[0] = args[0].to(torch.bfloat16)
    launches.reset_launch_counts()
    got = patch_embed_fused(*args, patch, t_patch)
    out, conv, stats = patch_embed_res(*args, patch, t_patch)
    assert launches.launch_counts()["patch_embed"] == 1
    assert launches.launch_counts()["patch_embed_res"] == 1
    assert got.shape == (b, T // t_patch, H // patch, W // patch, dim)
    assert torch.equal(got, out)
    pout, pconv, pstats = patch_embed_res_plain(*args, patch, t_patch)
    assert _rel_err(got, pout) <= 1.5e-2
    assert _rel_err(conv, pconv) <= 1e-3 and _rel_err(stats, pstats) <= 1e-4
    no_gain = _patch_args(a, patch, t_patch, cuda_device, ln1_gain=False)
    for i, wrong in ((1, no_gain[1]), (2, torch.zeros_like(args[2])),
                     (5, torch.zeros_like(args[5]))):
        bad = list(args)
        bad[i] = wrong
        if i == 1:
            bad[2] = no_gain[2]
        assert _rel_err(got, patch_embed_plain(*bad, patch, t_patch)) > 1.5e-2, i


# ---- vq_nearest and attn_qrows on the Hopper core ----

def _vq_mismatch_gap(tok, cb, got, want):
    """Largest |sim(got) - sim(want)| over the rows where the two differ."""
    bad = (got != want).nonzero().flatten()
    if not bad.numel():
        return 0.0
    sims = tok[bad].float() @ cb.float().t()
    return (sims.gather(1, got[bad, None].long()) -
            sims.gather(1, want[bad, None].long())).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 77, 5000, 27648])
def test_vq_nearest_argmax_epilogue_on_card(cuda_device, m):
    """The argmax epilogue over 8192 codes (64 code tiles): at most 0.1% of
    the indices differ from the plain version's, every difference a
    near-tie (sims within 1e-3); codes 5 and 4100 (tiles 0 and 32) equal,
    token 0 a copy of them, so both are its maximum and index 5 must win;
    one launch."""
    rng = np.random.default_rng(41)
    tok = torch.from_numpy(_unit_rows(rng, (m, 512))).to(cuda_device, torch.bfloat16)
    cb = torch.from_numpy(_unit_rows(rng, (8192, 512))).to(cuda_device, torch.bfloat16)
    cb[4100] = cb[5]
    tok[0] = cb[5]
    launches.reset_launch_counts()
    got = vq_nearest(tok, cb)
    assert launches.launch_counts()["vq_nearest"] == 1
    want = vq_nearest_plain(tok, cb)
    assert got.dtype == torch.int32 and got.shape == (m,)
    assert int(got[0]) == int(want[0]) == 5
    assert int((got != want).sum()) <= int(0.001 * m)
    assert _vq_mismatch_gap(tok, cb, got, want) <= 1e-3


@pytest.mark.cuda
def test_vq_nearest_signed_zero_tie_on_card(cuda_device):
    """Token e_0 against codes whose sims are -1 but for code 3 (all -0.0:
    its sim is a zero of either sign) and code 7 (+0.0): the two zeros are
    equal maxima, as torch.argmax counts them, so code 3 wins; in a second
    tile the same pair at 131 and 135 loses to code 3."""
    tok = torch.zeros((2, 512), device=cuda_device, dtype=torch.bfloat16)
    tok[:, 0] = 1.0
    cb = torch.zeros((300, 512), device=cuda_device, dtype=torch.bfloat16)
    cb[:, 0] = -1.0
    cb[3] = -0.0
    cb[7] = 0.0
    cb[131] = -0.0
    cb[135] = 0.0
    assert torch.signbit(cb[3]).all() and not torch.signbit(cb[7]).any()
    assert vq_nearest(tok, cb).tolist() == vq_nearest_plain(tok, cb).tolist() == [3, 3]


@pytest.mark.cuda
def test_vq_nearest_nan_row_on_card(cuda_device):
    """A diverged step, as torch.argmax orders it (NaN above every number,
    the first NaN wins): token 0 all NaN gets index 0 and the clean rows
    their near-ties at worst; with NaN in codes 4100 and 6000 (tiles 32
    and 46) every clean token gets 4100. Always the plain version's index
    on the NaN rows, never one out of range."""
    rng = np.random.default_rng(45)
    tok = torch.from_numpy(_unit_rows(rng, (300, 512))).to(cuda_device, torch.bfloat16)
    cb = torch.from_numpy(_unit_rows(rng, (8192, 512))).to(cuda_device, torch.bfloat16)
    tok[0] = float("nan")
    got, want = vq_nearest(tok, cb), vq_nearest_plain(tok, cb)
    assert int(got[0]) == int(want[0]) == 0
    assert bool(((got >= 0) & (got < 8192)).all())
    assert _vq_mismatch_gap(tok[1:], cb, got[1:], want[1:]) <= 1e-3
    cb[4100, 7] = float("nan")
    cb[6000] = float("nan")
    got, want = vq_nearest(tok, cb), vq_nearest_plain(tok, cb)
    assert want.tolist() == [0] + [4100] * 299
    assert got.tolist() == want.tolist()


def _maskgit_inputs(cuda_device, b, n=6464, seed=42):
    """x [b, n, 512] bf16 and layer weights at MaskGit's width (8 heads of 64),
    the bf16 [8, n, n] table of a CPB's scale (N(0, 1))."""
    g = torch.Generator(device=cuda_device).manual_seed(seed)

    def randn(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device=cuda_device)

    bf = torch.bfloat16
    x = randn(b, n, 512).to(bf)
    gamma = 1.0 + randn(512, s=0.1)
    wq, wk, wv = (randn(512, 512, s=512 ** -0.5).to(bf) for _ in range(3))
    wo = randn(512, 512, s=512 ** -0.5).to(bf)
    qs, ks = 1.0 + randn(64, s=0.1), 1.0 + randn(64, s=0.1)
    bias = randn(8, n, n).to(bf)
    return [x, gamma, wq, wk, wv, wo, qs, ks, bias]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_attn_qrows_kernel_at_maskgit_shape_on_card(cuda_device, b):
    """x [b, 6464, 512] with the bf16 [8, 6464, 6464] table: blocks of 256
    query rows of one sequence at b = 1 (a last stripe of 64 rows) and of
    128 at b = 2, 101 key tiles. The bf16 band, with
    and without the residual; it rejects the bias left out, k from the LN'd
    x, q_scale dropped and p unnormalised."""
    args = _maskgit_inputs(cuda_device, b)
    launches.reset_launch_counts()
    got = attn_qrows(*args, 8.0, False)
    assert launches.launch_counts()["attn_qrows"] == 1
    assert _rel_err(got, attn_qrows_plain(*args, 8.0, False)) <= 1.5e-2
    assert _rel_err(attn_qrows(*args, 8.0, True), attn_qrows_plain(*args, 8.0, True)) <= 1.5e-2
    wrong = list(args)
    wrong[6] = torch.ones_like(args[6])
    controls = [attn_qrows_plain(*args[:8], None, 8.0, False),
                attn_qrows_plain(*args, 8.0, False, faults=("k_from_ln",)),
                attn_qrows_plain(*wrong, 8.0, False),
                attn_qrows_plain(*args, 8.0, False, faults=("unnormalised",))]
    for i, c in enumerate(controls):
        assert _rel_err(got, c) > 1.5e-2, i


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(2, 300), (3, 77)])
def test_attn_qrows_projection_epilogue_on_card(cuda_device, b, n):
    """The chain's workspaces after one launch: xn = LN(x) * gamma, and the
    QkvPlan GEMM's epilogue, q = bf16(l2n(xn Wq^T) q_scale 8), k =
    bf16(l2n(bf16(x Wk^T)) k_scale), v = bf16(x Wv^T) written transposed
    per head ([b, 8, 64, N], rows padded to 16 B), against the same
    arithmetic in torch: within one bf16 step (4e-3 of the largest value).
    Controls: q without q_scale, k from the LN'd x, v from xn. N = 77 takes
    the bias as a padded copy (`_build.tma_rows`)."""
    from ct_clip_ut_tpu_torch.ops.attn_qrows import launch_chain

    args = _maskgit_inputs(cuda_device, b, n, seed=43)
    x, gamma, wq, wk, wv, wo, qs, ks, bias = args
    m, bf = b * n, torch.bfloat16
    _, ws = launch_chain(*args, 8.0, False)
    torch.cuda.synchronize()
    xn, q, k = ws["xn"], ws["q"], ws["k"]
    # v^T [b, 8, 64, pitch] back to [b * n, 512]
    v = ws["vt"][:, :n].reshape(b, 8, 64, n).permute(0, 3, 1, 2).reshape(m, 512)
    x32 = x.float().reshape(m, 512)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn_want = ((x32 - mean) * torch.rsqrt(var + 1e-5) * gamma).to(bf).float()

    def unit_heads(t, scale):
        t = t.reshape(m, 8, 64)
        return (t / t.norm(dim=-1, keepdim=True).clamp_min(1e-12) * scale).reshape(m, 512)

    q_want = unit_heads(xn_want @ wq.float().t(), qs * 8.0).to(bf)
    k_want = unit_heads((x32 @ wk.float().t()).to(bf).float(), ks).to(bf)
    v_want = (x32 @ wv.float().t()).to(bf)
    for got, want in ((xn, xn_want), (q, q_want), (k, k_want), (v, v_want)):
        assert _rel_err(got, want) <= 4e-3
    assert _rel_err(q, unit_heads(xn_want @ wq.float().t(), 8.0)) > 4e-3
    assert _rel_err(k, unit_heads((xn_want @ wk.float().t()).to(bf).float(), ks)) > 4e-3
    assert _rel_err(v, xn_want @ wv.float().t()) > 4e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("n,bias", [(300, True), (77, True), (200, False)])
def test_attn_qrows_core_blocks_on_card(cuda_device, b, n, bias):
    """Both block sizes of the core (256 query rows at b = 1, 128 at b = 2)
    at ragged N (a last stripe and key tile partly past N; 77 takes the
    bias as a padded copy), with the table and without, with the residual:
    the bf16 band against attn_qrows_plain."""
    args = _maskgit_inputs(cuda_device, b, n, seed=44)
    tb = args[8] if bias else None
    got = attn_qrows(*args[:8], tb, 8.0, True)
    assert _rel_err(got, attn_qrows_plain(*args[:8], tb, 8.0, True)) <= 1.5e-2


# ---- the fp32 variants (the attribution suite's image tower) -----------------------

F32_BAND = 1e-4   # max relative error of an fp32 variant vs its plain version


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("r,n,bias", [(24, 576, True), (3, 100, True), (4608, 24, False),
                                      (5, 7, False)])
def test_fp32_attention_blocks_match_plain_on_card(cuda_device, r, n, bias, residual):
    """The fp32 chain (tc::block_forward_f32) at the spatial shape, a ragged
    one, the temporal stack of one volume and an odd one: within F32_BAND
    of the plain version in fp32, where the same chain with its lo planes
    zeroed (one bf16 product for each fp32 one) and the plain version
    without the LN gain or q_scale are not."""
    from ct_clip_ut_tpu_torch.ops.attn_block import launch_block_f32

    a = _attn_inputs(np.random.default_rng(61), r=r, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    b = torch.from_numpy(a["bias"]).to(cuda_device) if bias else None
    kern = attn_block if bias else attn_packed
    name = "attn_block_f32" if bias else "attn_packed_f32"
    launches.reset_launch_counts()
    got = kern(*args, *([b] if bias else []), 8.0, residual)
    assert launches.launch_counts()[name] == 1 and got.dtype == torch.float32
    want = attn_block_plain(*args, b, 8.0, residual)
    assert _rel_err(got, want) <= F32_BAND
    if not residual:
        entry = "ctc_attn_block_f32" if bias else "ctc_attn_packed_f32"
        one = launch_block_f32(entry, *args, b, 8.0, False, one_pass=True)
        assert _rel_err(one, want) > F32_BAND
        for i in (1, 6):
            wrong = list(args)
            wrong[i] = torch.ones_like(args[i])
            assert _rel_err(got, attn_block_plain(*wrong, b, 8.0, False)) > F32_BAND, i


@pytest.mark.cuda
@pytest.mark.parametrize("n,residual", [(13824, False), (13824, True), (77, False)])
def test_fp32_geglu_ff_matches_plain_on_card(cuda_device, n, residual):
    """The fp32 FF (three bf16 products of hi / lo planes a product, inner
    1365 with w_out padded per call) within F32_BAND; the one-pass chain
    and the plain version without the LN gain or bias outside it."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_f32

    args = [t.to(cuda_device) for t in _torch_ff_args(_ff_inputs(np.random.default_rng(62),
                                                                  n=n, dim=512))]
    launches.reset_launch_counts()
    got = geglu_ff(*args, residual=residual)
    assert launches.launch_counts()["geglu_ff_f32"] == 1 and got.dtype == torch.float32
    want = geglu_ff_plain(*args, residual=residual)
    assert _rel_err(got, want) <= F32_BAND
    if not residual:
        assert _rel_err(geglu_ff_f32(*args, one_pass=True), want) > F32_BAND
        for i, neutral in ((1, torch.ones_like), (2, torch.zeros_like)):
            wrong = list(args)
            wrong[i] = neutral(args[i])
            assert _rel_err(got, geglu_ff_plain(*wrong, residual=False)) > F32_BAND, i


@pytest.mark.cuda
def test_fp32_vq_nearest_matches_plain_on_card(cuda_device):
    """fp32 tokens [13824, 512] x 8192 codes: >= 99.99% of the indices equal
    the plain version's, every mismatch a tie within 1e-5 of cosine; the
    one-pass chain below that share."""
    from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest_f32

    rng = np.random.default_rng(63)
    tok = torch.from_numpy(_unit_rows(rng, (13824, 512))).to(cuda_device)
    cb = torch.from_numpy(_unit_rows(rng, (8192, 512))).to(cuda_device)
    launches.reset_launch_counts()
    got = vq_nearest(tok, cb).long()
    assert launches.launch_counts()["vq_nearest_f32"] == 1
    want = vq_nearest_plain(tok, cb).long()
    bad = (got != want).nonzero().flatten()
    assert 1 - bad.numel() / got.numel() >= 0.9999
    if bad.numel():
        sims = tok[bad] @ cb.t()
        assert (sims.gather(1, got[bad, None]) - sims.gather(1, want[bad, None])).abs().max() <= 1e-5
    one = vq_nearest_f32(tok, cb, one_pass=True).long()
    assert (one == want).float().mean().item() < 0.9999


# ---- the fp32 data-gradient chains (the gradient attribution methods) ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("r,n,bias", [(24, 576, True), (3, 100, True), (2, 101, True),
                                      (576, 24, False), (5, 7, False), (2, 101, False)])
def test_fp32_bwd_attention_blocks_match_plain_on_card(cuda_device, r, n, bias, residual):
    """dx of the fp32 chains (tc::block_backward_f32) at Grad-CAM's spatial
    and temporal shapes, ragged and odd ones (n = 101: the bias read one
    key at a time; without a bias, the temporal chain above its fused
    pass): within F32_BAND of the plain backward's dx in fp32,
    the same bits on two calls; the chain with its lo planes zeroed and
    the plain backward with the softmax row term, the l2-norm projection
    or the LN gain left out outside it."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd_f32, attn_block_bwd_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd_f32

    rng = np.random.default_rng(71)
    a = _attn_inputs(rng, r=r, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    b = torch.from_numpy(a["bias"]).to(cuda_device) if bias else None
    g = torch.from_numpy(rng.standard_normal((r, n, 512)).astype(np.float32)).to(cuda_device)

    def kern(one_pass=False):
        if bias:
            return attn_block_bwd_f32(*args, b, g, 8.0, residual, one_pass=one_pass)
        return attn_packed_bwd_f32(*args, g, 8.0, residual, one_pass=one_pass)

    name = "attn_block_bwd_f32" if bias else "attn_packed_bwd_f32"
    launches.reset_launch_counts()
    got = kern()
    assert launches.launch_counts()[name] == 1 and got.dtype == torch.float32
    assert torch.equal(got, kern())
    want = attn_block_bwd_plain(*args, b, g, 8.0, residual)[0]
    assert _rel_err(got, want) <= F32_BAND
    if not residual:
        assert _rel_err(kern(one_pass=True), want) > F32_BAND
        for fault in ("row_term", "l2norm", "gamma"):
            wrong = attn_block_bwd_plain(*args, b, g, 8.0, False, faults=(fault,))[0]
            assert _rel_err(got, wrong) > F32_BAND, fault


@pytest.mark.cuda
@pytest.mark.parametrize("n,residual", [(13824, False), (13824, True), (77, False)])
def test_fp32_bwd_geglu_ff_matches_plain_on_card(cuda_device, n, residual):
    """dx of the fp32 FF chain (ctc_geglu_ff_bwd_f32: the recompute and dh
    in one block, dvalue | dgate written as planes, inner 1365 padded to
    1368) within F32_BAND of the plain backward's, the same bits on two
    calls; the one-pass chain and the plain backward with GELU for its
    derivative or without the LN gain outside it."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd_f32, geglu_ff_bwd_plain

    rng = np.random.default_rng(72)
    args = [t.to(cuda_device) for t in _torch_ff_args(_ff_inputs(rng, n=n, dim=512))]
    g = torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32)).to(cuda_device)
    launches.reset_launch_counts()
    got = geglu_ff_bwd_f32(*args, g, residual)
    assert launches.launch_counts()["geglu_ff_bwd_f32"] == 1 and got.dtype == torch.float32
    assert torch.equal(got, geglu_ff_bwd_f32(*args, g, residual))
    want = geglu_ff_bwd_plain(*args, g, residual)[0]
    assert _rel_err(got, want) <= F32_BAND
    if not residual:
        assert _rel_err(geglu_ff_bwd_f32(*args, g, one_pass=True), want) > F32_BAND
        for fault in ("gelu_prime", "gamma"):
            wrong = geglu_ff_bwd_plain(*args, g, False, faults=(fault,))[0]
            assert _rel_err(got, wrong) > F32_BAND, fault


@pytest.mark.cuda
def test_fp32_bwd_autograd_routes_on_card(cuda_device):
    """Under autograd at fp32 with every parameter frozen, the blocks'
    Functions launch the data-gradient chains (one each) and their dx
    matches autograd of the plain blocks; with the parameters wanting their
    gradients, the full chains (the fp32 train step's) launch instead, and
    dx and every parameter's gradient match autograd of the plain blocks."""
    from ct_clip_ut_tpu_torch.config import TransformerConfig
    from ct_clip_ut_tpu_torch.ops.attention import attention
    from ct_clip_ut_tpu_torch.ops.layers import feedforward
    from ct_clip_ut_tpu_torch.ops.transformer import Transformer

    torch.manual_seed(73)
    tf = Transformer(TransformerConfig(dim=512, depth=1, dim_head=32, heads=8)).to(cuda_device)
    _, attn, _, ff = tf.layers[0]
    x0 = torch.randn((3, 24, 512), device=cuda_device)
    bias = torch.randn((8, 24, 24), device=cuda_device)
    params = [p for m in (attn, ff) for p in m.parameters()]

    def run(plain, attn_bias, trained):
        x = x0.clone().requires_grad_(True)
        y = attention(attn, x, attn_bias=attn_bias, return_weights=False, residual=True,
                      plain=plain).out
        y = feedforward(ff, y, residual=True, plain=plain)
        wrt = [x] + ([p for p in params if p.requires_grad] if trained else [])
        return torch.autograd.grad((y * y).sum(), wrt, allow_unused=True)

    for attn_bias, name in ((None, "attn_packed_bwd_f32"), (bias, "attn_block_bwd_f32")):
        for trained in (False, True):
            for p in tf.parameters():
                p.requires_grad_(trained)
            launches.reset_launch_counts()
            got = run(False, attn_bias, trained)
            counts = launches.launch_counts()
            suffix = "_full" if trained else ""
            assert counts[name + suffix] == 1 and counts["geglu_ff_bwd_f32" + suffix] == 1, counts
            assert counts[name + ("" if trained else "_full")] == 0
            want = run(True, attn_bias, trained)
            for gt, wt in zip(got, want):
                if wt is not None:
                    assert _rel_err(gt, wt) <= F32_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(24, 576), (3, 101)])
def test_fp32_bwd_saved_statistics_match_the_rerun_on_card(cuda_device, r, n):
    """The spatial fp32 backward from the forward's o planes and row
    statistics (attn_block(..., keep=True)) gives the bits of the chain
    that reruns the forward core, dx alone and every gradient, on two
    calls from the same saved tensors; _BlockFn with keep takes that route
    (one forward launch, one backward, the rerun's dx bits)."""
    from ct_clip_ut_tpu_torch.ops.attention import _BlockFn
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_bwd, attn_block_bwd_f32

    rng = np.random.default_rng(77)
    a = _attn_inputs(rng, r=r, n=n, d=512, heads=8, dh=32, with_bias=True)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    b = torch.from_numpy(a["bias"]).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((r, n, 512)).astype(np.float32)).to(cuda_device)
    out, saved = attn_block(*args, b, 8.0, True, keep=True)
    assert torch.equal(out, attn_block(*args, b, 8.0, True))
    rerun = attn_block_bwd_f32(*args, b, g, 8.0, True)
    for _ in range(2):
        assert torch.equal(attn_block_bwd_f32(*args, b, g, 8.0, True, saved=saved), rerun)
    full = attn_block_bwd(*args, b, g, 8.0, True)
    kept = attn_block_bwd(*args, b, g, 8.0, True, saved=saved)
    assert all(torch.equal(x, y) for x, y in zip(full, kept))
    x = args[0].clone().requires_grad_(True)
    launches.reset_launch_counts()
    y = _BlockFn.apply(x, *args[1:], b, 8.0, True, True)
    (dx,) = torch.autograd.grad(y, [x], g)
    counts = launches.launch_counts()
    assert counts["attn_block_f32"] == 1 and counts["attn_block_bwd_f32"] == 1, counts
    assert torch.equal(dx, rerun)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,bias", [(48, 576, True), (3, 100, True), (2, 101, True),
                                      (1152, 24, False), (5, 7, False), (2, 101, False)])
def test_fp32_full_bwd_attention_blocks_match_plain_on_card(cuda_device, r, n, bias):
    """Every gradient of the fp32 train step's block backward (the full
    tc::block_backward_f32: dx, dgamma, dWq, dWk, dWv, dWo, dqs, dks and
    dbias) at the B = 2 step's spatial and temporal shapes and ragged / odd
    ones within F32_BAND of the plain backward's largest entry, dx the
    dx-only chain's bits, the same bits on two calls; the chain with its lo
    planes zeroed outside the band."""
    from ct_clip_ut_tpu_torch.ops.attn_block import (attn_block_bwd, attn_block_bwd_f32,
                                                     attn_block_bwd_plain)
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd, attn_packed_bwd_f32

    rng = np.random.default_rng(74)
    a = _attn_inputs(rng, r=r, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    b = torch.from_numpy(a["bias"]).to(cuda_device) if bias else None
    g = torch.from_numpy(rng.standard_normal((r, n, 512)).astype(np.float32)).to(cuda_device)

    def kern(one_pass=False):
        if bias:
            return attn_block_bwd(*args, b, g, 8.0, True, one_pass=one_pass)
        return attn_packed_bwd(*args, g, 8.0, True, one_pass=one_pass)

    name = "attn_block_bwd_f32_full" if bias else "attn_packed_bwd_f32_full"
    launches.reset_launch_counts()
    got = kern()
    assert launches.launch_counts()[name] == 1
    want = attn_block_bwd_plain(*args, b, g, 8.0, True)[:len(got)]
    again = kern()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    dx_only = (attn_block_bwd_f32(*args, b, g, 8.0, True) if bias
               else attn_packed_bwd_f32(*args, g, 8.0, True))
    assert torch.equal(got[0], dx_only)
    for k, (gt, wt) in enumerate(zip(got, want)):
        assert gt.dtype == torch.float32 and _rel_err(gt, wt) <= F32_BAND, k
    one = kern(one_pass=True)
    assert max(_rel_err(o, w) for o, w in zip(one, want)) > F32_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,bias", [(1152, 24, False), (48, 576, True)])
def test_fp32_full_bwd_wgrad_chunks_same_bits_on_card(cuda_device, monkeypatch, r, n, bias):
    """The block weight gradient of the B = 2 fp32 step (27,648 tokens, D =
    512, HD = 256) split into 4 chunks of 108 slices (128 blocks), summed
    in chunk order: the same bits on two calls, and within F32_BAND of the
    same chain with one chunk (each tile over every token)."""
    from ct_clip_ut_tpu_torch.ops import attn_block as ab
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd

    assert ab.block_wgrad_partition(r * n, 512, 256) == (108, 4)
    rng = np.random.default_rng(76)
    a = _attn_inputs(rng, r=r, n=n, d=512, heads=8, dh=32, with_bias=bias)
    args = [t.to(cuda_device) for t in _torch_attn_args(a)]
    b = torch.from_numpy(a["bias"]).to(cuda_device) if bias else None
    g = torch.from_numpy(rng.standard_normal((r, n, 512)).astype(np.float32)).to(cuda_device)

    def kern():
        if bias:
            return ab.attn_block_bwd(*args, b, g, 8.0, True)
        return attn_packed_bwd(*args, g, 8.0, True)

    got = kern()
    assert all(torch.equal(x, y) for x, y in zip(got, kern()))
    monkeypatch.setattr(ab, "block_wgrad_partition", lambda *a, **k: (0, 1))
    whole = kern()
    assert torch.equal(got[0], whole[0])
    for k in (2, 3, 4, 5):
        assert _rel_err(got[k], whole[k]) <= F32_BAND, k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [27648, 77])
def test_fp32_full_bwd_geglu_ff_matches_plain_on_card(cuda_device, n):
    """Every gradient of the fp32 train step's FF backward (dx, dgamma,
    dbeta, dW_in, dW2: h's planes from the recompute, inner 1365 padded to
    1368 and kept out of the outputs) within F32_BAND of the plain
    backward's, the same bits on two calls; the one-pass chain outside."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_f32, geglu_ff_bwd_plain

    rng = np.random.default_rng(75)
    args = [t.to(cuda_device) for t in _torch_ff_args(_ff_inputs(rng, n=n, dim=512))]
    g = torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32)).to(cuda_device)
    launches.reset_launch_counts()
    got = geglu_ff_bwd(*args, g, True)
    assert launches.launch_counts()["geglu_ff_bwd_f32_full"] == 1
    assert all(torch.equal(x, y) for x, y in zip(got, geglu_ff_bwd(*args, g, True)))
    assert torch.equal(got[0], geglu_ff_bwd_f32(*args, g, True))
    want = geglu_ff_bwd_plain(*args, g, True)
    for k, (gt, wt) in enumerate(zip(got, want)):
        assert gt.shape == wt.shape and _rel_err(gt, wt) <= F32_BAND, k
    one = geglu_ff_bwd(*args, g, True, one_pass=True)
    assert max(_rel_err(o, w) for o, w in zip(one, want)) > F32_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,t_patch,dim", [((2, 1, 240, 480, 480), 20, 10, 512),
                                                     ((2, 1, 6, 48, 32), 16, 2, 64)])
def test_fp32_patch_embed_res_and_dkw_on_card(cuda_device, shape, patch, t_patch, dim):
    """The fp32 train step's patch embed: ctc_patch_embed_res_f32's out,
    conv and LN1 moments, and ctc_patch_embed_dkw_f32 from the forward's P
    planes and from the volume (the same bits), within F32_BAND of the
    plain versions; the one-pass weight gradient outside."""
    from ct_clip_ut_tpu_torch.ops.patch_embed import (_res_with_patches, patch_embed_dkw,
                                                      patch_embed_dkw_plain,
                                                      patch_embed_res_plain)

    rng = np.random.default_rng(76)
    b, _, T, H, W = shape
    args = _patch_args(_patch_inputs(rng, b, T, H, W, patch, t_patch, dim), patch, t_patch,
                       cuda_device)
    launches.reset_launch_counts()
    out, conv, stats, planes = _res_with_patches(*args, patch, t_patch)
    assert launches.launch_counts()["patch_embed_res_f32"] == 1
    want = patch_embed_res_plain(*args, patch, t_patch)
    for gt, wt in zip((out, conv, stats), want):
        assert gt.dtype == torch.float32 and _rel_err(gt, wt) <= F32_BAND
    dconv = torch.from_numpy(rng.standard_normal(conv.shape).astype(np.float32)).to(cuda_device)
    got = patch_embed_dkw(args[0], dconv, patch, t_patch, planes)
    assert launches.launch_counts()["patch_embed_dkw_f32"] == 1
    assert torch.equal(got, patch_embed_dkw(args[0], dconv, patch, t_patch))
    want = patch_embed_dkw_plain(args[0], dconv, patch, t_patch)
    assert _rel_err(got, want) <= F32_BAND
    one = patch_embed_dkw(args[0], dconv, patch, t_patch, one_pass=True)
    assert _rel_err(one, want) > F32_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim", [(27648, 512), (77, 512), (301, 384)])
def test_fp32_staged_wgrad_geglu_ff_on_card(cuda_device, n, dim):
    """9F's weight gradients (FFWgradSplitPlan on wgrad4_kernel's staged
    walk; n = 77 and 301 ragged slices, D = 384 an odd count of D's tiles)
    within F32_BAND of the plain backward, the same bits on two calls, one
    launch counted; the one-pass control outside."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_plain

    rng = np.random.default_rng(78)
    args = [t.to(cuda_device) for t in _torch_ff_args(_ff_inputs(rng, n=n, dim=dim))]
    g = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32)).to(cuda_device)
    launches.reset_launch_counts()
    got = geglu_ff_bwd(*args, g, True)
    assert launches.launch_counts()["geglu_ff_bwd_f32_full"] == 1
    assert all(torch.equal(x, y) for x, y in zip(got, geglu_ff_bwd(*args, g, True)))
    want = geglu_ff_bwd_plain(*args, g, True)
    one = geglu_ff_bwd(*args, g, True, one_pass=True)
    for k in (3, 4):   # dw_in, dw_out
        assert _rel_err(got[k], want[k]) <= F32_BAND, k
        assert _rel_err(one[k], want[k]) > F32_BAND, k


@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,t_patch,dim", [((2, 1, 240, 480, 480), 20, 10, 512),
                                                     ((2, 1, 6, 48, 32), 16, 2, 64),
                                                     ((1, 1, 20, 60, 100), 20, 10, 384)])
def test_fp32_staged_wgrad_patch_dkw_on_card(cuda_device, shape, patch, t_patch, dim):
    """11f (PatchWgradSplitPlan on wgrad4_kernel's staged walk; dim 64 and
    384 a column tile masked past dim) within F32_BAND of the plain version,
    the same bits on two calls, one launch counted; the one-pass control
    outside."""
    from ct_clip_ut_tpu_torch.ops.patch_embed import patch_embed_dkw, patch_embed_dkw_plain

    rng = np.random.default_rng(79)
    b, _, T, H, W = shape
    image = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    m = b * (T // t_patch) * (H // patch) * (W // patch)
    dconv = torch.from_numpy(rng.standard_normal((m, dim)).astype(np.float32)).to(cuda_device)
    launches.reset_launch_counts()
    got = patch_embed_dkw(image, dconv, patch, t_patch)
    assert launches.launch_counts()["patch_embed_dkw_f32"] == 1
    assert torch.equal(got, patch_embed_dkw(image, dconv, patch, t_patch))
    want = patch_embed_dkw_plain(image, dconv, patch, t_patch)
    assert _rel_err(got, want) <= F32_BAND
    assert _rel_err(patch_embed_dkw(image, dconv, patch, t_patch, one_pass=True), want) > F32_BAND


# ---- CTGenerate's one-scan route in fp32 (rows 5f, 13f) -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,patch,t_patch", [((1, 1, 1, 128, 128), 16, 1),
                                                 ((1, 1, 200, 128, 128), 16, 2),
                                                 ((1, 1, 240, 480, 480), 20, 10),
                                                 ((2, 1, 6, 48, 32), 16, 2)])
def test_patch_embed_f32_kernel_on_card(cuda_device, shape, patch, t_patch):
    """The fp32 patch embed (ctc_patch_embed_f32) at CTGenerate's two
    temporal patches, the flagship CT-CLIP patch (K = 4000) and a ragged
    batch: within F32_BAND of patch_embed_plain at fp32; the one-pass
    control (lo planes zeroed) outside it."""
    from ct_clip_ut_tpu_torch.ops.patch_embed import patch_embed_f32

    b, _, T, H, W = shape
    a = _patch_inputs(np.random.default_rng(29), b, T, H, W, patch, t_patch, 512)
    args = _patch_args(a, patch, t_patch, cuda_device)
    launches.reset_launch_counts()
    got = patch_embed_fused(*args, patch, t_patch)
    assert launches.launch_counts()["patch_embed_f32"] == 1 and got.dtype == torch.float32
    want = patch_embed_plain(*args, patch, t_patch)
    assert _rel_err(got, want) <= F32_BAND
    assert _rel_err(patch_embed_f32(*args, patch, t_patch, one_pass=True), want) > F32_BAND


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,with_bias", [(1, 6464, True), (2, 300, True), (1, 77, False)])
def test_attn_qrows_f32_kernel_on_card(cuda_device, b, n, with_bias):
    """The fp32 q-row attention (ctc_attn_qrows_f32) at MaskGit's shape with
    the fp32 table, a batch of 2 over a ragged last key tile, and N = 77
    without a bias (its rows padded for TMA): within F32_BAND of
    attn_qrows_plain at fp32 with and without the residual; the one-pass
    control, the bias left out and q_scale dropped outside it."""
    from ct_clip_ut_tpu_torch.ops.attn_qrows import launch_chain_f32

    args = [t.float() for t in _maskgit_inputs(cuda_device, b, n)]
    if not with_bias:
        args[8] = None
    launches.reset_launch_counts()
    got = attn_qrows(*args, 8.0, False)
    assert launches.launch_counts()["attn_qrows_f32"] == 1 and got.dtype == torch.float32
    want = attn_qrows_plain(*args, 8.0, False)
    assert _rel_err(got, want) <= F32_BAND
    assert _rel_err(attn_qrows(*args, 8.0, True), attn_qrows_plain(*args, 8.0, True)) <= F32_BAND
    wrong = list(args)
    wrong[6] = torch.ones_like(args[6])
    controls = [launch_chain_f32(*args, 8.0, False, one_pass=True),
                attn_qrows_plain(*wrong, 8.0, False)]
    if with_bias:
        controls.append(attn_qrows_plain(*args[:8], None, 8.0, False))
    for i, c in enumerate(controls):
        assert _rel_err(c, want) > F32_BAND, i
