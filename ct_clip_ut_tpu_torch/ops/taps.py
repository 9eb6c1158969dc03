"""Hook-free activation capture and gradient injection.

Counterpart of ct_clip_ut_tpu/ops/taps.py: a `Taps` object threads through
a forward; `tap(name, x)` adds the injected tensor of that name (a zero
tensor whose gradient is d objective / d activation) and records x when
the name is captured. The port's modules could take forward hooks instead,
but the named points and the injection contract are what the JAX package's
callers (MaskGit's last cross-attention, the attribution suite) are written
against.

Tap names (the scope prefixes "spatial." / "temporal." in the CT-ViT, ""
in MaskGit), per layer i of a transformer (ops/transformer.py):
  {scope}{i}.attn_weights        self-attention weights [b, heads, n, n]
  {scope}{i}.attn_out            self-attention block output, pre-residual
  {scope}{i}.cross_attn_weights  cross-attention weights (MaskGit's last
                                 layer's are the one the port's callers read)
  {scope}{i}.cross_attn_out      cross-attention block output, pre-residual
  {scope}{i}.ff_out              feed-forward block output, pre-residual
and in the CT-ViT (models/ctvit.py):
  vq.input                       the encoder output before the VQ [b, n, d]
  vq.features                    the straight-through quantized tokens
Grad-CAM (attribution/grad_cam.py) injects zeros at the block outputs and
vq.features and reads their gradients; the forward methods read the
weights as the transformer's outputs (return_weights) and need no tap.
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
