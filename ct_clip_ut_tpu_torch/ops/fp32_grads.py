"""Which backward an fp32 kernel Function takes on the card.

At fp32 the card computes the data gradient alone: the block and FF
Functions (`attention._BlockFn`, `geglu_ff._GegluFFFn`) take the dx-only
chains (`*_bwd_f32`) when no parameter wants its gradient, the gradient
attribution methods' case, and raise `FP32_PARAM_GRADS` otherwise, as the
full fp32 backward wrappers do.
"""

from __future__ import annotations

import torch

from .. import _build

FP32_PARAM_GRADS = ("the fp32 parameter gradients of the block and FF kernels on the card are "
                    "not ported yet (ROADMAP Queue 2 item 14, fourth group: the fp32 train "
                    "step); the data gradient alone runs (the *_bwd_f32 chains)")


def fp32_data_grad_only(ctx, x: torch.Tensor) -> bool:
    """Whether a Function's backward takes the card's fp32 data-gradient
    chain (an fp32 CUDA x, its first input); raises where a parameter also
    wants its gradient."""
    if not (_build.on_cuda(x) and x.dtype == torch.float32):
        return False
    if any(ctx.needs_input_grad[1:]):
        raise NotImplementedError(FP32_PARAM_GRADS)
    return True
