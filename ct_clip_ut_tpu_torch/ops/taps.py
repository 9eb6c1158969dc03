"""Hook-free activation capture and gradient injection.

Counterpart of ct_clip_ut_tpu/ops/taps.py: a `Taps` object threads through
a forward; `tap(name, x)` adds the injected tensor of that name (a zero
tensor whose gradient is d objective / d activation) and records x when
the name is captured. The port's modules could take forward hooks instead,
but the named points and the injection contract are what the JAX package's
callers (MaskGit's last cross-attention, the attribution suite) are written
against.

The port's transformer has one tap point per layer i so far,
{i}.cross_attn_weights. The forward attribution methods (`attribution/`:
raw attention, rollout, occlusion) read the self-attention weights as the
transformer's outputs (return_weights) and need no tap; the JAX package's
other points (block outputs before the residual with the `spatial.` /
`temporal.` scope prefixes, vq.features and vq.input) come with the
gradient methods that inject at them (ROADMAP Queue 1 item 9 (c)).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch


class Taps:
    def __init__(self, capture: Union[bool, Iterable[str]] = False,
                 inject: Optional[Dict[str, torch.Tensor]] = None):
        self.capture_all = capture is True
        self.capture = frozenset(capture) if not isinstance(capture, bool) else frozenset()
        self.inject = dict(inject or {})
        self.collected: Dict[str, torch.Tensor] = {}

    def wants(self, name: str) -> bool:
        return self.capture_all or name in self.capture

    def tap(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name in self.inject:
            x = x + self.inject[name].to(x.dtype)
        if self.wants(name):
            self.collected[name] = x
        return x


NULL_TAPS = Taps()
