"""Zero-shot pathology classification, single device.

Counterpart of ct_clip_ut_tpu/infer/zeroshot.py: the 36 prompt latents are
encoded once per checkpoint, each batch of volumes is encoded once, and the
[B, 36] similarity gives softmax([present, absent]) per pathology.
`CTClipInference.predict` is the batch loop alone, so it runs where
scikit-learn is absent; `zeroshot` adds the metrics, and is the one place
the port loads anything of the JAX package (its framework-free
`ct_clip_ut_tpu.utils.metrics`, numpy and scikit-learn only).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import PATHOLOGIES
from ..models.ctclip import CTCLIP, encode_image_latents, encode_text_latents


def prompt_texts(pathologies: Sequence[str] = PATHOLOGIES):
    """36 interleaved prompts: (present, absent) per pathology."""
    out = []
    for p in pathologies:
        out.append(f"There is {p}.")
        out.append(f"There is no {p}.")
    return out


@torch.no_grad()
def encode_prompt_latents(model: CTCLIP, prompt_tokens: dict) -> torch.Tensor:
    """[2 * n_pathologies, dim_latent] fp32, computed once per checkpoint."""
    return encode_text_latents(model, prompt_tokens)


@torch.no_grad()
def zeroshot_probs(model: CTCLIP, image: torch.Tensor, prompt_latents: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   plain: bool = False) -> torch.Tensor:
    """[B, n_pathologies] positive-class probabilities of a [B, 1, T, H, W]
    batch. plain=True runs every kernel's plain version instead (the
    reference the card compares the kernel path with)."""
    img_lat, _ = encode_image_latents(model, image.to(compute_dtype), plain=plain)
    temp = model.temperature.exp()
    sim = (img_lat.float() @ prompt_latents.float().t()) * temp
    pair = torch.stack([sim[:, 0::2], sim[:, 1::2]], dim=-1)      # [B, 18, 2]
    return torch.softmax(pair, dim=-1)[..., 0]


class CTClipInference:
    """Zero-shot driver. `data` yields (images [B, 1, D, H, W], texts,
    labels [B, 18], ...); `prompt_tokens` is the tokenised prompt_texts()
    (input_ids [36, n] and optionally attention_mask / token_type_ids) on
    the model's device."""

    def __init__(self, model: CTCLIP, prompt_tokens: dict, data: Iterable,
                 results_folder: str = "./results",
                 pathologies: Sequence[str] = PATHOLOGIES,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded evaluation is not ported yet (ROADMAP, Queue 1 item 11)")
        self.model = model
        self.prompt_tokens = prompt_tokens
        self.data = data
        self.results_folder = Path(results_folder)
        self.pathologies = tuple(pathologies)
        self.compute_dtype = compute_dtype
        self.metrics_history = []
        self._prompt_latents: Optional[torch.Tensor] = None

    def prompt_latents(self) -> torch.Tensor:
        if self._prompt_latents is None:
            self._prompt_latents = encode_prompt_latents(self.model, self.prompt_tokens)
        return self._prompt_latents

    def predict(self):
        """(preds [N, 18], targets [N, 18]) as numpy. Batches are queued on
        the device without a host sync; the probabilities are fetched once
        at the end."""
        device = self.model.temperature.device
        latents = self.prompt_latents()
        preds, targets = [], []
        for images, _texts, labels, *_ in self.data:
            images = torch.as_tensor(images).to(device, non_blocking=True)
            preds.append(zeroshot_probs(self.model, images, latents, self.compute_dtype))
            targets.append(np.asarray(labels))
        return torch.cat(preds).float().cpu().numpy(), np.concatenate(targets, axis=0)

    def zeroshot(self):
        """predict(), then the metrics of ct_clip_ut_tpu.utils.metrics
        (needs scikit-learn; loads that module and the JAX package's
        config, not JAX). Returns (metrics, preds, targets)."""
        from ct_clip_ut_tpu.utils import metrics as M
        preds, targets = self.predict()
        m = M.calculate_metrics(preds, targets, list(self.pathologies))
        self.metrics_history.append(m)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        M.save_metrics(self.metrics_history, list(self.pathologies), self.results_folder)
        return m, preds, targets
