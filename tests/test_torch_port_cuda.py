"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The module
imports no JAX (the GPU machine has none), and the repository's
conftest.py does, so run it there with:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are the flagship widths (D = 512, 8 heads of 32, inner 1365, 8192
codes) with ragged lengths besides the flagship ones; inputs are bf16.
The bands: 1.5e-2 max relative error for the float kernels (both sides
round at the same points and differ in the order of fp32 sums), held on
the branch alone as well as with the residual, and shown to reject a
plain version with a norm gain, LN bias, q/k scale or bias left out;
>= 99.9% equal VQ indices, and the first maximum winning a tie.
"""

import numpy as np
import pytest
import torch

from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain


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
