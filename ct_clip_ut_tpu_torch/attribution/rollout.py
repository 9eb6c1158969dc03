"""Attention rollout (identity-augmented, row-normalised attention products).

Counterpart of ct_clip_ut_tpu/attribution/rollout.py (reference
visualizations.py:707-849). Two products:

  * spatial: each depth slice of each spatial layer is a one-layer rollout
    (reference visualizations.py:800-813); L layers give an [L*D, h, w]
    stack, min-max normalised as one volume and trilinear-upsampled to the
    scan shape;
  * temporal: per spatial token, a multi-layer rollout over that token's
    [heads, t, t] attention across the temporal layers, summed over queries
    (reference visualizations.py:819-841), laid out (h, w, t) -> (t, h, w).

The reference loops over the 4 x 24 spatial slices and the 576 tokens in
Python; `rollout_matrix` takes leading batch axes, so each product is one
batched chain of fp32 matmuls on the device (the JAX package vmaps it).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..models.ctclip import CTCLIP
from .capture import forward_only, minmax, score_and_weights, upsample_to_host


def rollout_matrix(attn_layers: torch.Tensor, head_fusion: str = "mean",
                   discard_ratio: float = 0.0, use_residual: bool = True) -> torch.Tensor:
    """Rollout over stacked layers [..., L, heads, N, N] -> [..., N, N]
    (reference attention_rollout, visualizations.py:707-743), any leading
    axes batched. discard_ratio keeps, in each row, the values at or above
    the row's k-th largest, k = int(N * N * (1 - discard_ratio)) (the JAX
    package's top_k per row, which needs k <= N)."""
    if head_fusion == "mean":
        fused = attn_layers.float().mean(dim=-3)
    elif head_fusion == "max":
        fused = attn_layers.float().amax(dim=-3)
    else:
        raise ValueError(f"unsupported head_fusion: {head_fusion}")
    n = fused.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=fused.device)
    result = eye.expand(*fused.shape[:-3], n, n)
    for layer in range(fused.shape[-3]):
        attn = fused[..., layer, :, :]
        if discard_ratio > 0.0:
            k = int(n * n * (1.0 - discard_ratio))
            thresh = attn.topk(k, dim=-1).values.amin(dim=-1, keepdim=True)
            attn = torch.where(attn >= thresh, attn, torch.zeros_like(attn))
        attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-8)
        if use_residual:
            attn = attn + eye
            attn = attn / attn.sum(dim=-1, keepdim=True)
        result = attn @ result
    return result


@forward_only
def rollout_volumes(model: CTCLIP, text_tokens, image: torch.Tensor, *,
                    plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spatial [L*D, h, w] stack before the upsample, temporal [t, h, w]),
    both min-max normalised (reference visualizations.py:813-814, 836-839),
    on the image's device."""
    cfg = model.visual_transformer.cfg
    h, w = cfg.patch_height, cfg.patch_width
    _, spatial, temporal = score_and_weights(model, text_tokens, image, plain=plain)

    # spatial: a one-layer rollout per (layer, depth) slice, all slices at once
    sp = torch.stack(spatial)                         # [L, D, heads, hw, hw]
    L, D = sp.shape[0], sp.shape[1]
    per_slice = rollout_matrix(sp.reshape(L * D, 1, *sp.shape[2:]))   # [L*D, hw, hw]
    spatial_vol = minmax(per_slice.sum(dim=1).reshape(L * D, h, w))   # sum over queries

    # temporal: a multi-layer rollout per spatial token, all tokens at once
    per_token = torch.stack(temporal).transpose(0, 1)  # [hw, L, heads, t, t]
    token_importance = rollout_matrix(per_token).sum(dim=1)   # [hw, t]
    t = token_importance.shape[-1]
    temporal_vol = minmax(token_importance.reshape(h, w, t).permute(2, 0, 1))
    return spatial_vol, temporal_vol


def rollout_maps(model: CTCLIP, text_tokens, image: torch.Tensor, *,
                 plain: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Full-resolution saliency maps [D, H, W] (before rot90) as host numpy
    arrays (reference visualizations.py:815-816, 840-841). Only the grid
    volumes (~230 KB) leave the device; the trilinear expansion to the scan
    shape runs on the host (`upsample_to_host`)."""
    target = tuple(image.shape[-3:])
    sp, tm = rollout_volumes(model, text_tokens, image, plain=plain)
    return upsample_to_host(sp.cpu().numpy(), target), upsample_to_host(tm.cpu().numpy(), target)


def rollout_maps_pipelined(model: CTCLIP, items: Iterable, *,
                           plain: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Rollout map pairs for a sequence of (text_tokens, image) items, in
    order, with the device and the host overlapped: item k + 1's forward is
    queued on the card before item k's two host expansions run, and each
    item's grid volumes come back by a non-blocking copy into pinned host
    memory, waited on only when that item is expanded. A pair then costs
    max(device, host) rather than their sum."""
    def fetch(t):
        if t.device.type != "cuda":
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    def expand(entry):
        target, sp, tm, done = entry
        if done is not None:
            done.synchronize()
        return upsample_to_host(sp.numpy(), target), upsample_to_host(tm.numpy(), target)

    pending = None
    for text_tokens, image in items:
        sp, tm = rollout_volumes(model, text_tokens, image, plain=plain)
        sp, tm = fetch(sp), fetch(tm)
        done = None
        if image.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            yield expand(pending)
        pending = (tuple(image.shape[-3:]), sp, tm, done)
    if pending is not None:
        yield expand(pending)
