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


def cpb_offset_table(cpb: ContinuousPositionBias, dims) -> torch.Tensor:
    """The CPB MLP over every distinct relative offset, fp32
    [2*d1-1, ..., 2*dc-1, heads] (posbias.py:156-167)."""
    dims = tuple(int(d) for d in dims)
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
    return h.reshape(*(2 * d - 1 for d in dims), -1)


def continuous_pos_bias(cpb: ContinuousPositionBias, *dimensions: int) -> torch.Tensor:
    """[heads, N, N] fp32 bias for an N = prod(dimensions) token grid."""
    dims = tuple(int(d) for d in dimensions)
    dev = cpb.net[-1].weight.device
    table = cpb_offset_table(cpb, dims).reshape(-1, cpb.net[-1].weight.shape[0])  # [O, heads]

    # offset id of every (query, key) pair: mixed radix over (2d - 1) per axis
    pos = torch.stack(torch.meshgrid(
        *[torch.arange(d, device=dev) for d in dims], indexing="ij"), dim=-1).reshape(-1, len(dims))
    rel_id = pos[:, None, :] - pos[None, :, :] + torch.tensor([d - 1 for d in dims], device=dev)
    flat = torch.zeros(rel_id.shape[:2], dtype=torch.long, device=dev)
    for ax, d in enumerate(dims):
        flat = flat * (2 * d - 1) + rel_id[..., ax]
    return table[flat].permute(2, 0, 1).contiguous()


def continuous_pos_bias_row_stripe3(cpb: ContinuousPositionBias, d1: int, d2: int, d3: int,
                                    row_start: int, row_len: int, *, table=None,
                                    dtype=torch.float32, row_chunk: int = 512) -> torch.Tensor:
    """[heads, row_len * d2 * d3, d1 * d2 * d3]: the 3-D CPB rows of the
    queries whose first-axis index lies in [row_start, row_start + row_len)
    against every key (posbias.py:293-306). One gather of the offset table
    by (dt, dh, dw) per (query, key) pair picks the entry the JAX package's
    one-hot contractions select, so the floats are the same. Query rows past
    d1 (q-block padding) get 0 where the frame offset leaves the table, as
    the one-hot of an out-of-range offset does there. `table` is
    cpb_offset_table(cpb, (d1, d2, d3)), when the caller holds it; the
    result is built in `dtype` (the gather is exact, so building in bf16
    equals rounding the fp32 table)."""
    if table is None:
        table = cpb_offset_table(cpb, (d1, d2, d3))
    dev = table.device
    heads = table.shape[-1]
    o2, o3 = 2 * d2 - 1, 2 * d3 - 1
    flat = table.reshape(-1, heads).t().to(dtype).contiguous()        # [heads, O]

    def grid_ids(t0: int, t_len: int):   # (frame, mixed-radix offset base) of each token
        t, h, w = torch.meshgrid(torch.arange(t0, t0 + t_len, device=dev),
                                 torch.arange(d2, device=dev), torch.arange(d3, device=dev),
                                 indexing="ij")
        return t.reshape(-1), (t * (o2 * o3) + h * o3 + w).reshape(-1)

    center = (d1 - 1) * o2 * o3 + (d2 - 1) * o3 + (d3 - 1)
    tk, bk = grid_ids(0, d1)
    tq, aq = grid_ids(row_start, row_len)
    out = torch.empty((heads, aq.numel(), bk.numel()), dtype=dtype, device=dev)
    for r0 in range(0, aq.numel(), row_chunk):
        a, t = aq[r0:r0 + row_chunk, None], tq[r0:r0 + row_chunk, None]
        valid = (t - tk[None]) < d1
        ids = torch.where(valid, a - bk[None] + center, 0)
        out[:, r0:r0 + a.shape[0]] = torch.where(valid, flat[:, ids], 0)
    return out


def continuous_pos_bias_grouped3(cpb: ContinuousPositionBias, d1: int, d2: int, d3: int, *,
                                 dtype=torch.float32) -> torch.Tensor:
    """The dense [heads, n, n] 3-D CPB table, n = d1 * d2 * d3: the floats
    of posbias.py:248-284. The JAX package's frame grouping only avoids TPU
    lane padding; here it is the row stripe over every frame."""
    return continuous_pos_bias_row_stripe3(cpb, d1, d2, d3, 0, d1, dtype=dtype)
