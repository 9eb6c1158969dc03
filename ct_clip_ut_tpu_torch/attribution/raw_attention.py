"""Raw attention maps: per-layer, per-head received-attention volumes.

Counterpart of ct_clip_ut_tpu/attribution/raw_attention.py (reference
visualizations.py:570-704). A spatial layer's weights are [b*t, heads, hw,
hw]; their mean over the query axis is the attention each key token
receives, a [D, h, w] grid per head. Temporal weights [b*h*w, heads, t, t]
average to [hw, t], laid out (h, w, t) and permuted depth-first. Each
volume is shift-max normalised; the host variant rotates them as the
reference's GIF grid does. No backward pass: the reference runs one but never
reads its gradients for this method.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.ctclip import CTCLIP
from .capture import forward_only, score_and_weights, shiftmax


def spatial_received_volumes(attn: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[D, heads, hw, hw] -> [heads, D, h, w] received-attention volumes,
    shift-max normalised per head (reference visualizations.py:662-677)."""
    d = attn.shape[0]
    received = attn.float().mean(dim=2)               # mean over queries: [D, heads, hw]
    vol = received.transpose(0, 1).reshape(-1, d, h, w)
    return shiftmax(vol, batched=True)


def temporal_received_volumes(attn: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[hw, heads, t, t] -> [heads, t, h, w] (reference visualizations.py:668-672:
    view(H, W, D) then permute(2, 0, 1))."""
    t = attn.shape[-1]
    received = attn.float().mean(dim=2)               # [hw, heads, t]
    vol = received.transpose(0, 1).reshape(-1, h, w, t).permute(0, 3, 1, 2)
    return shiftmax(vol, batched=True)


@forward_only
def raw_attention_maps(model: CTCLIP, text_tokens, image: torch.Tensor, *,
                       plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spatial [layers, heads, D, h, w], temporal [layers, heads, t, h, w])
    on the image's device; plain=True runs every kernel's plain version."""
    cfg = model.visual_transformer.cfg
    h, w = cfg.patch_height, cfg.patch_width
    _, spatial, temporal = score_and_weights(model, text_tokens, image, plain=plain)
    sp = torch.stack([spatial_received_volumes(a, h, w) for a in spatial])
    tm = torch.stack([temporal_received_volumes(a, h, w) for a in temporal])
    return sp, tm


def raw_attention_maps_np(model: CTCLIP, text_tokens, image: torch.Tensor, *,
                          plain: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Host variant with the reference's rot90 applied per volume, ready for
    GIF rendering: each [D, h, w] volume rotated over its first two axes, as
    the reference's np.rot90(vol, k=-1, axes=(0, 1)) does
    (visualizations.py:676). numpy arrays [layers, heads, ., ., .]."""
    sp, tm = raw_attention_maps(model, text_tokens, image, plain=plain)
    return (np.rot90(sp.cpu().numpy(), k=-1, axes=(2, 3)),
            np.rot90(tm.cpu().numpy(), k=-1, axes=(2, 3)))
