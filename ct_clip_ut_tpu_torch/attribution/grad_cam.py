"""Grad-CAM over CT-ViT intermediates: six CAM variants.

Counterpart of ct_clip_ut_tpu/attribution/grad_cam.py (reference
visualizations.py:913-1026). From one scored forward and one backward,
the spatial / temporal self-attention block outputs, the feed-forward
outputs and the VQ features are captured with their gradients with
respect to the per-sample similarity score (tap points, capture.py's
`score_captures_and_grads`). Each CAM is relu(sum_c feats_c * mean-grad_c)
on the 24^3 token grid (temporal layouts permuted depth-first), shift-max
normalised; the combined map is sqrt(spatial * temporal + 1e-8).

Gradient pairing: the reference indexes features[-1] and gradients[-1]
(visualizations.py:929-934, 954-959), but features append in forward order
while register_hook gradients fire in backward order, so features[-1] is
the LAST layer's and gradients[-1] the FIRST layer's gradient.
`pairing="reference"` (the default) reproduces that for output parity;
`pairing="aligned"` is the intent (the last layer's features with their own
gradients).

On the card the backward runs the fp32 data-gradient chains of the blocks
and the FF: a map set launches attn_block_bwd_f32 3 times (spatial layers
1-3: layer 0's block sits under its tap, with no gradient behind it),
attn_packed_bwd_f32 4 times and geglu_ff_bwd_f32 8 times.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.ctclip import CTCLIP
from .capture import score_captures_and_grads, shiftmax, upsample_to_host

PAIRINGS = ("reference", "aligned")


def _cam(features: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """relu(sum_c feats * mean-grad_c), the channel weights averaged over
    every token axis (reference visualizations.py:933-938)."""
    weights = grads.mean(dim=(0, 1))                     # [channels]
    return torch.relu((features * weights).sum(dim=-1))


def grad_cam_volumes(model: CTCLIP, text_tokens, image: torch.Tensor, *, text_embeds=None,
                     pairing: str = "reference", plain: bool = False) -> Dict[str, torch.Tensor]:
    """Six token-grid CAM volumes, each [t, h, w] shift-max normalised, on
    the image's device: spatial, temporal, spatial_ff, temporal_ff,
    combined, vq. plain=True runs every kernel's plain version."""
    if pairing not in PAIRINGS:
        raise ValueError(f"pairing {pairing!r}: one of {PAIRINGS}")
    vit = model.visual_transformer.cfg
    h, w = vit.patch_height, vit.patch_width
    last_sp, last_tm = vit.spatial_depth - 1, vit.temporal_depth - 1
    # the backward-order quirk: gradients[-1] belongs to layer 0
    gsp, gtm = (0, 0) if pairing == "reference" else (last_sp, last_tm)
    names = {f"spatial.{last_sp}.attn_out", f"temporal.{last_tm}.attn_out",
             f"spatial.{last_sp}.ff_out", f"temporal.{last_tm}.ff_out",
             f"spatial.{gsp}.attn_out", f"temporal.{gtm}.attn_out",
             f"spatial.{gsp}.ff_out", f"temporal.{gtm}.ff_out", "vq.features"}
    _, feats, grads = score_captures_and_grads(model, text_tokens, image, sorted(names),
                                               text_embeds, plain=plain)
    # spatial blocks are [(b t), hw, d]; batch 1, so the leading axis is t
    t = feats[f"spatial.{last_sp}.attn_out"].shape[0]

    def spatial_cam(stage, layer, glayer):
        cam = _cam(feats[f"spatial.{layer}.{stage}"], grads[f"spatial.{glayer}.{stage}"])
        return shiftmax(cam.reshape(t, h, w))                        # from [t, hw]

    def temporal_cam(stage, layer, glayer):
        cam = _cam(feats[f"temporal.{layer}.{stage}"], grads[f"temporal.{glayer}.{stage}"])
        return shiftmax(cam.reshape(h, w, t).permute(2, 0, 1))       # from [hw, t]

    sp = spatial_cam("attn_out", last_sp, gsp)
    tm = temporal_cam("attn_out", last_tm, gtm)
    vq_f, vq_g = feats["vq.features"][0], grads["vq.features"][0]    # [t h w, d]
    vq = torch.relu((vq_f * vq_g.mean(dim=0)).sum(dim=-1))
    return {"spatial": sp, "temporal": tm,
            "spatial_ff": spatial_cam("ff_out", last_sp, gsp),
            "temporal_ff": temporal_cam("ff_out", last_tm, gtm),
            "combined": torch.sqrt(sp * tm + 1e-8),                  # visualizations.py:975
            "vq": shiftmax(vq.reshape(t, h, w))}


def grad_cam_maps(model: CTCLIP, text_tokens, image: torch.Tensor,
                  **kw) -> Dict[str, np.ndarray]:
    """Full-resolution [D, H, W] CAMs (before rot90) as host numpy arrays,
    trilinear-upsampled (reference visualizations.py:993-1000): the grid
    CAMs leave the device and expand on the host (`upsample_to_host`)."""
    target = tuple(image.shape[-3:])
    vols = grad_cam_volumes(model, text_tokens, image, **kw)
    return {k: upsample_to_host(v.cpu().numpy(), target) for k, v in vols.items()}
