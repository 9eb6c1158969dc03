"""Position biases: ALiBi and the continuous position bias (CPB).

Counterpart of ct_clip_ut_tpu/ops/posbias.py. Both are fp32 functions of
static shapes; the CPB MLP runs over the distinct relative offsets only and
the [heads, N, N] table is a gather (posbias.py:73-117).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def alibi_slopes(heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (posbias.py:21-32)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(heads).is_integer():
        s = pow2_slopes(heads)
    else:
        closest = 2 ** math.floor(math.log2(heads))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def alibi_bias(heads: int, i: int, j: int, device=None) -> torch.Tensor:
    """[heads, i, j] causal ALiBi bias, the last query aligned with the
    last key (posbias.py:35-42)."""
    i_pos = torch.arange(j - i, j, dtype=torch.float32, device=device)
    j_pos = torch.arange(j, dtype=torch.float32, device=device)
    bias = -(j_pos[None, None, :] - i_pos[None, :, None]).abs()
    return bias * alibi_slopes(heads).to(device)[:, None, None]


def causal_mask(i: int, j: int, device=None) -> torch.Tensor:
    """[i, j] True where a query may NOT attend (strictly future keys)."""
    return torch.ones((i, j), dtype=torch.bool, device=device).triu(j - i + 1)


class ContinuousPositionBias(nn.Module):
    """2-layer LeakyReLU(0.1) MLP from relative ND offsets to per-head
    biases, indexed like the reference (net.0.0, net.1.0, ..., net.<layers>)."""

    def __init__(self, dim: int, heads: int, num_dims: int = 2, layers: int = 2,
                 log_dist: bool = True):
        super().__init__()
        self.log_dist = log_dist
        net = [nn.Sequential(nn.Linear(num_dims, dim), nn.LeakyReLU(0.1))]
        for _ in range(layers - 1):
            net.append(nn.Sequential(nn.Linear(dim, dim), nn.LeakyReLU(0.1)))
        net.append(nn.Linear(dim, heads))
        self.net = nn.ModuleList(net)


def continuous_pos_bias(cpb: ContinuousPositionBias, *dimensions: int) -> torch.Tensor:
    """[heads, N, N] fp32 bias for an N = prod(dimensions) token grid."""
    dims = tuple(int(d) for d in dimensions)
    dev = cpb.net[-1].weight.device
    axes = [torch.arange(-(d - 1), d, dtype=torch.float32, device=dev) for d in dims]
    rel = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, len(dims))
    if cpb.log_dist:
        rel = torch.sign(rel) * torch.log(rel.abs() + 1.0)
    h = rel
    for idx, layer in enumerate(cpb.net):
        lin = layer[0] if isinstance(layer, nn.Sequential) else layer
        h = h @ lin.weight.float().t() + lin.bias.float()
        if idx < len(cpb.net) - 1:
            h = torch.where(h >= 0, h, 0.1 * h)
    table = h                                               # [O, heads]

    # offset id of every (query, key) pair: mixed radix over (2d - 1) per axis
    pos = torch.stack(torch.meshgrid(
        *[torch.arange(d, device=dev) for d in dims], indexing="ij"), dim=-1).reshape(-1, len(dims))
    rel_id = pos[:, None, :] - pos[None, :, :] + torch.tensor([d - 1 for d in dims], device=dev)
    flat = torch.zeros(rel_id.shape[:2], dtype=torch.long, device=dev)
    for ax, d in enumerate(dims):
        flat = flat * (2 * d - 1) + rel_id[..., ax]
    return table[flat].permute(2, 0, 1).contiguous()
