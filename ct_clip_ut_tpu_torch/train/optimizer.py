"""The optimizer of the train step: the counterpart of
ct_clip_ut_tpu/train/optimizer.py (an optax chain).

`get_optimizer` returns an `Optimizer` that applies, in one `step()`, what
the JAX package chains in optax:
  * clip_by_global_norm(max_grad_norm): when the global norm of the
    gradients reaches the limit, every gradient is scaled by max / norm
    (optax's formula; torch's clip_grad_norm_ uses max / (norm + 1e-6));
  * Adam (wd == 0, the trainer default) or AdamW with weight decay only on
    parameters of ndim >= 2 (reference optimizer.py:4-12, 42): optax's
    update mu_hat / (sqrt(nu_hat) + eps), the decay added to the update,
    both scaled by the learning rate;
  * the learning-rate schedule `make_lr_schedule` (constant, linear warmup,
    or warmup then cosine decay: optax.linear_schedule /
    warmup_cosine_decay_schedule), read at the update count before it
    increments, as optax's scale_by_schedule does;
  * the opt-in bf16 first moment (mu_dtype): b1 * mu is taken in bf16,
    the update is computed in fp32 and mu stored rounded, as optax does.
Gradients that are None count as zeros, as JAX's gradient of an unused
parameter is. Everything stays on the device: the clip factor is a tensor,
the schedule and bias corrections are host floats of the host step count.
The updates use torch._foreach_* (one multi-tensor launch per operation).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch


def make_lr_schedule(lr: float, warmup_steps: int = 0, decay_steps: int = 0,
                     end_lr_frac: float = 0.0) -> Callable[[int], float]:
    """count -> learning rate: constant unless warmup / decay are asked
    for; decay_steps counts after warmup, ending at lr * end_lr_frac."""
    def linear(count, init, end, steps):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    if warmup_steps <= 0 and decay_steps <= 0:
        return lambda count: lr
    if decay_steps <= 0:
        return lambda count: linear(count, 0.0, lr, max(warmup_steps, 1))
    init = 0.0 if warmup_steps > 0 else lr
    alpha = 0.0 if lr == 0.0 else lr * end_lr_frac / lr

    def warmup_cosine(count):
        if count < warmup_steps:
            return linear(count, init, lr, warmup_steps)
        c = min(count - warmup_steps, decay_steps)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)

    return warmup_cosine


class Optimizer:
    """Global-norm clip + Adam / AdamW over `params` (see the module doc)."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr: float, wd: float,
                 betas: Tuple[float, float], eps: float, max_grad_norm: Optional[float],
                 schedule: Callable[[int], float], mu_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.wd, self.betas, self.eps = wd, betas, eps
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.decayed = [i for i, p in enumerate(self.params) if p.ndim >= 2]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> list:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad; returns the global norm
        of the gradients before clipping (a device scalar)."""
        grads = self.grads()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.max_grad_norm is not None:
            limit = torch.as_tensor(self.max_grad_norm, dtype=norm.dtype, device=norm.device)
            torch._foreach_mul_(grads, torch.where(norm < limit, torch.ones_like(norm),
                                                   limit / norm))
        b1, b2 = self.betas
        lr = self.schedule(self.count)
        self.count += 1
        # b1 * mu in mu's own dtype, b1 rounded to it too, then the fp32 sum
        # (optax's update_moment with a bf16 moment: the weakly typed product)
        mu = [m.mul_(b1) if m.dtype == torch.float32
              else (m * torch.tensor(b1, dtype=m.dtype, device=m.device)).float()
              for m in self.mu]
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, den)
        if self.wd != 0.0 and self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed], alpha=self.wd)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        for stored, m in zip(self.mu, mu):
            if stored is not m:
                stored.copy_(m)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def get_optimizer(params: Sequence[torch.nn.Parameter], lr: float = 1e-4, wd: float = 1e-4,
                  betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8,
                  max_grad_norm: Optional[float] = None, warmup_steps: int = 0,
                  decay_steps: int = 0, end_lr_frac: float = 0.0,
                  mu_dtype: Optional[str] = None) -> Optimizer:
    """The counterpart of the JAX package's get_optimizer, over `params`."""
    return Optimizer(params, lr, wd, betas, eps, max_grad_norm,
                     make_lr_schedule(lr, warmup_steps, decay_steps, end_lr_frac),
                     getattr(torch, mu_dtype) if mu_dtype else None)
