"""Which backward an fp32 kernel Function takes on the card.

At fp32 the block and FF Functions (`attention._BlockFn`,
`geglu_ff._GegluFFFn`) take the data-gradient chains (`*_bwd_f32`: dx
alone) when no parameter wants its gradient, the gradient attribution
methods' case, and the full fp32 chains (`attn_block_bwd`,
`attn_packed_bwd`, `geglu_ff_bwd` on fp32 tensors: every parameter
gradient too) when one does, the fp32 train step's.
"""

from __future__ import annotations

import torch

from .. import _build

# Rows a block of the LayerNorm backward sums into one row of the gains'
# partial sums (LNG_ROWS, csrc/split_sm90.cuh): the full chains' workspace
# holds ln_parts(M) rows of [dgamma | dbeta]
LN_PART_ROWS = 64


def ln_parts(m: int) -> int:
    return -(-m // LN_PART_ROWS)


def fp32_data_grad_only(ctx, x: torch.Tensor) -> bool:
    """Whether a Function's backward takes the card's fp32 data-gradient
    chain: an fp32 CUDA x (its first input) and no other input wanting its
    gradient."""
    return _build.on_cuda(x) and x.dtype == torch.float32 and not any(ctx.needs_input_grad[1:])
