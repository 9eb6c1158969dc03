"""NN primitives: linear, layer norms, l2norm, dropout, GEGLU feed-forward, PEG.

Counterpart of ct_clip_ut_tpu/ops/layers.py. Weights are torch-layout
(nn.Linear (out, in), Conv3d [dim, 1, 3, 3, 3]); normalisation runs in
fp32 whatever the compute dtype, and weights are cast to the activation
dtype inside `linear`, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .geglu_ff import geglu_ff_grad, geglu_ff_plain
from .peg import front_pad, peg_grad, peg_plain, taps_of


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight^T (+ bias), weight and bias cast to x's dtype
    (ct_clip_ut_tpu/ops/layers.py:44-48)."""
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layernorm(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32. bf16 inputs take the
    E[x^2] - E[x]^2 moments (layers.py:76-86); other dtypes the two-pass
    variance (layers.py:87-94)."""
    orig = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    if orig == torch.bfloat16:
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(orig)


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=-1) in fp32, cast back (layers.py:97-110)."""
    t32 = t.float()
    if t.dtype == torch.bfloat16:
        out = t32 * (1.0 / (t32 * t32).sum(-1, keepdim=True).sqrt().clamp_min(eps))
    else:
        out = t32 / torch.linalg.vector_norm(t32, dim=-1, keepdim=True).clamp_min(eps)
    return out.to(t.dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout at rate p (layers.py:113-118): keep each element with
    probability 1 - p and scale it by 1 / (1 - p), in x's dtype. The mask is
    drawn with torch.bernoulli from `generator` (a torch.Generator on x's
    device): the JAX package's threefry bits cannot be reproduced, so runs
    agree in distribution, not bit for bit. p == 0 returns x."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with p > 0 needs a torch.Generator")
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full(x.shape, keep, device=x.device), generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype,
                                                          device=x.device)).to(x.dtype)


class FrozenBiasLayerNorm(nn.Module):
    """The reference's LayerNorm with a learned `gamma` and a zero `beta`
    buffer (attention norm and `norm_out`); `beta` never enters the math."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.register_buffer("beta", torch.zeros(dim))


class FeedForward(nn.Sequential):
    """LN -> Linear(dim, 2*inner) -> GEGLU -> Dropout -> Linear(inner, dim),
    indexed like the reference Sequential (0 norm, 1 proj_in, 4 proj_out;
    the GEGLU and the inference-time dropout hold no weights and run inside
    `feedforward`)."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__(nn.LayerNorm(dim), nn.Linear(dim, 2 * inner_dim, bias=False),
                         nn.Identity(), nn.Identity(),
                         nn.Linear(inner_dim, dim, bias=False))

    def forward(self, x: torch.Tensor, residual: bool = False,
                plain: bool = False) -> torch.Tensor:
        return feedforward(self, x, residual=residual, plain=plain)


def feedforward(ff: FeedForward, x: torch.Tensor, *, residual: bool = False,
                plain: bool = False) -> torch.Tensor:
    """GEGLU FF of [b, n, dim] tokens through the geglu_ff kernel and its
    backward (their plain versions on CPU tensors), or with plain=True the
    plain forward everywhere, differentiated by autograd."""
    b, n, d = x.shape
    dt = x.dtype
    args = (x.reshape(b * n, d).contiguous(), ff[0].weight.float(), ff[0].bias.float(),
            ff[1].weight.to(dt), ff[4].weight.to(dt))
    fn = geglu_ff_plain if plain else geglu_ff_grad
    return fn(*args, residual=residual).reshape(b, n, d)


class PEG(nn.Module):
    """Depthwise 3x3x3 conv positional encoding (`dsconv`, reference naming).
    With `fused` (TransformerConfig.peg_pallas) the forward is the peg
    stencil kernel and the backward its flipped-tap stencil and the
    peg_weight_grads kernel (ops/peg.py); otherwise F.conv3d and autograd."""

    def __init__(self, dim: int, causal: bool = True, fused: bool = False):
        super().__init__()
        self.causal = causal
        self.fused = fused
        self.dsconv = nn.Conv3d(dim, dim, 3, groups=dim)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                plain: bool = False) -> torch.Tensor:
        if self.fused:
            return peg_fused_residual(self.dsconv.weight, self.dsconv.bias, x, video_shape,
                                      self.causal, plain=plain)
        return peg_residual(self.dsconv.weight, self.dsconv.bias, x, video_shape, self.causal)


def peg_fused_residual(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                       video_shape: Tuple[int, int, int, int], causal: bool = True,
                       plain: bool = False) -> torch.Tensor:
    """peg(x) + x through the stencil of ops/peg.py on the token buffer as
    it lies in memory, the same raw reshape to (b, t, h, w, D) as
    `peg_residual` and no layout copy. plain=True runs the kernel's plain
    version, differentiated by autograd."""
    b, t, h, w = video_shape
    v = x.reshape(b, t, h, w, x.shape[-1]).contiguous()
    if plain:
        out = peg_plain(v, taps_of(weight), bias.float(), front_pad(causal))
    else:
        out = peg_grad(v, weight, bias, causal)
    return out.reshape(x.shape)


def peg_residual(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                 video_shape: Tuple[int, int, int, int], causal: bool = True) -> torch.Tensor:
    """peg(x) + x (layers.py:208-240, 346-377). `x` is [B, N, D] and is
    reinterpreted as (b, t, h, w, D) without a permute, exactly as the JAX
    package does: for the temporal stack that is a raw reshape of the
    ((b h w), t, d) buffer. The conv runs in x's dtype; bias and residual are
    added in fp32. Frame padding is (2, 0) when causal, else (1, 1)."""
    b, t, h, w = video_shape
    dim = x.shape[-1]
    # a contiguous NCDHW copy: cuDNN's depthwise conv3d on the channels-last
    # view runs one kernel per channel group, 5.3x slower on the H100
    v = x.reshape(b, t, h, w, dim).permute(0, 4, 1, 2, 3).contiguous()
    pad = (1, 1, 1, 1, 2, 0) if causal else (1, 1, 1, 1, 1, 1)
    out = F.conv3d(F.pad(v, pad), weight.to(x.dtype), groups=dim)
    out = out.float() + bias.float()[:, None, None, None] + v.float()
    return out.to(x.dtype).permute(0, 2, 3, 4, 1).reshape(x.shape)
