"""CTCLIP: BERT text tower + CT-ViT image tower, l2-normalised latents.

Counterpart of ct_clip_ut_tpu/models/ctclip.py: the latents (from a
volume, from an embedded token grid, from the spatial stack's output), the
full forward `ctclip_apply` (sim matrix scaled by exp(temperature), the
text latents from tokens or from precomputed embeddings) and the
symmetric InfoNCE `contrastive_loss` the train step minimises. Submodule
names follow the reference state dict (text_transformer, visual_transformer,
to_text_latent, to_visual_latent, temperature).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..config import CTCLIPConfig
from ..ops.attention import Attention
from ..ops.layers import FrozenBiasLayerNorm, l2norm, linear
from ..ops.taps import NULL_TAPS, Taps
from ..ops.vq import VQState, _Codebook, vq_apply
from ..parallel.collectives import all_gather
from .bert import Bert, bert_cls
from .ctvit import CTViT, ctvit_apply, ctvit_encode_tokens, ctvit_temporal_encode


class CTCLIP(nn.Module):
    def __init__(self, cfg: CTCLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.text_transformer = Bert(cfg.bert)
        self.visual_transformer = CTViT(cfg.ctvit)
        self.to_text_latent = nn.Linear(cfg.dim_text, cfg.dim_latent, bias=False)
        self.to_visual_latent = nn.Linear(cfg.dim_image, cfg.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.tensor(cfg.temperature_init))


class SeededInit:
    """Draws a module's weights from one torch.Generator with the JAX
    package's init distributions, remembering which tensors it has set."""

    def __init__(self, seed: int, device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.done = set()

    def uniform_(self, t, bound):
        t.copy_(torch.rand(t.shape, generator=self.gen, device=self.device) * (2 * bound) - bound)
        self.done.add(id(t))

    def normal_(self, t, std):
        t.copy_(torch.randn(t.shape, generator=self.gen, device=self.device) * std)
        self.done.add(id(t))

    def fill_(self, t, value):
        t.fill_(value)
        self.done.add(id(t))

    def modules_(self, model: nn.Module) -> None:
        """Linear and conv weights U(+-sqrt(3/fan_in)), biases
        U(+-1/sqrt(fan_in)), embeddings N(0, 0.02^2), null key/values
        N(0, 1), LayerNorm and q/k scales ones, the codebook l2-normalised
        N(0, 1) rows."""
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                self.uniform_(m.weight, math.sqrt(3.0 / fan_in))
                if m.bias is not None:
                    self.uniform_(m.bias, 1.0 / math.sqrt(fan_in))
            elif isinstance(m, nn.LayerNorm):
                self.fill_(m.weight, 1.0)
                self.fill_(m.bias, 0.0)
            elif isinstance(m, FrozenBiasLayerNorm):
                self.fill_(m.gamma, 1.0)
                self.fill_(m.beta, 0.0)
            elif isinstance(m, nn.Embedding):
                self.normal_(m.weight, 0.02)
            elif isinstance(m, Attention):
                self.fill_(m.q_scale, 1.0)
                self.fill_(m.k_scale, 1.0)
                self.normal_(m.null_kv, 1.0)
            elif isinstance(m, _Codebook):
                self.normal_(m.embed, 1.0)
                m.embed.copy_(l2norm(m.embed))
                m.embed_avg.copy_(m.embed)
                self.fill_(m.cluster_size, 0.0)
                self.done.add(id(m.embed_avg))

    def check(self, model: nn.Module) -> nn.Module:
        """Raise unless every parameter and buffer was set; returns the
        model in eval mode."""
        missing = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
                   if id(t) not in self.done]
        if missing:
            raise AssertionError(f"the seeded init left tensors uninitialised: {missing}")
        return model.eval()


@torch.no_grad()
def init_ctclip(cfg: CTCLIPConfig, seed: int = 0, device="cuda") -> CTCLIP:
    """A CTCLIP in eval mode with weights drawn from `seed` with the JAX
    package's init distributions (SeededInit.modules_). Built on the meta
    device first, so no default init is paid. On the card unless `device`
    says otherwise; without one, the default raises."""
    device = _build.check_device(device)
    with torch.device("meta"):
        model = CTCLIP(cfg)
    model.to_empty(device=device)
    init = SeededInit(seed, device)
    init.modules_(model)
    init.fill_(model.temperature, cfg.temperature_init)
    return init.check(model)


def encode_image_latents(model: CTCLIP, image: torch.Tensor, *, freeze_vq: bool = True,
                         return_weights: bool = False, taps: Taps = NULL_TAPS,
                         deterministic: bool = True, prepatchified: bool = False,
                         plain: bool = False, vq_axis=None):
    """CT-ViT -> fp32 temporal mean (cast back) -> flatten -> project ->
    l2norm (ctclip.py:63-83). Returns (latents, CTViTOutput). With
    prepatchified=True `image` is a [b, t, h, w, patch_dim] patch tensor
    (the gradient attribution entry, ctvit.ctvit_apply); `vq_axis` as
    ctvit.ctvit_apply's."""
    vit_out = ctvit_apply(model.visual_transformer, image, freeze_vq=freeze_vq,
                          return_weights=return_weights, taps=taps,
                          deterministic=deterministic, prepatchified=prepatchified, plain=plain,
                          vq_axis=vq_axis)
    return _image_latents_of(model, vit_out.tokens), vit_out


def _image_latents_of(model: CTCLIP, tokens: torch.Tensor) -> torch.Tensor:
    """Quantized [b, t, h, w, d] tokens -> fp32 temporal mean (cast back) ->
    flatten -> project -> l2norm."""
    pooled = tokens.float().mean(dim=1).to(tokens.dtype)
    return l2norm(linear(pooled.reshape(pooled.shape[0], -1), model.to_visual_latent.weight))


def encode_image_latents_from_tokens(model: CTCLIP, token_grid: torch.Tensor, *,
                                     freeze_vq: bool = True, return_weights: bool = False,
                                     taps: Taps = NULL_TAPS, plain: bool = False):
    """The image half from an embedded [b, t, h, w, d] token grid (the patch
    embed's output): transformer encode -> VQ -> the latents of
    `encode_image_latents` (ctclip.py:86-105). Occlusion's token shortcut
    and the attribution suite's scored forward call it. Returns (latents,
    CTViTOutput)."""
    vit_out = ctvit_encode_tokens(model.visual_transformer, token_grid, freeze_vq=freeze_vq,
                                  return_weights=return_weights, taps=taps, plain=plain)
    return _image_latents_of(model, vit_out.tokens), vit_out


def encode_image_latents_from_spatial_out(model: CTCLIP, spatial_out: torch.Tensor, *,
                                          freeze_vq: bool = True,
                                          plain: bool = False) -> torch.Tensor:
    """The image half from the spatial stack's output grid [b, t, h, w, d]
    (after its norm_out): temporal transformer -> VQ -> the latents
    (ctclip.py:108-126). Occlusion's frame-sparse recompute calls it.
    Returns [b, dim_latent] latents."""
    vit = model.visual_transformer
    cfg = vit.cfg
    x, _ = ctvit_temporal_encode(vit, spatial_out, plain=plain)
    b, t, h, w, d = x.shape
    quant, _, _ = vq_apply(vit.vq.state(), x.reshape(b, t * h * w, d), freeze=freeze_vq,
                           decay=cfg.vq_decay, eps=cfg.vq_eps, plain=plain)
    return _image_latents_of(model, quant.reshape(b, t, h, w, d))


def encode_text_latents(model: CTCLIP, text_tokens: dict,
                        compute_dtype: torch.dtype = torch.float32,
                        plain: bool = False, *, generator: Optional[torch.Generator] = None,
                        deterministic: bool = True) -> torch.Tensor:
    """BERT CLS -> project -> l2norm (ctclip.py:129-141). `text_tokens`
    holds input_ids and optionally attention_mask / token_type_ids."""
    cls = bert_cls(model.text_transformer, text_tokens["input_ids"],
                   text_tokens.get("attention_mask"), text_tokens.get("token_type_ids"),
                   compute_dtype=compute_dtype, plain=plain, generator=generator,
                   deterministic=deterministic)
    return l2norm(linear(cls, model.to_text_latent.weight))


def text_latents_of(model: CTCLIP, text_tokens: Optional[dict],
                    text_embeds: Optional[torch.Tensor] = None,
                    compute_dtype: torch.dtype = torch.float32, plain: bool = False, *,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """The text latents from tokens (`encode_text_latents`) or, with
    text_tokens None, from CLS-level embeddings [b, dim_text]:
    l2norm(text_embeds W^T) (the bypass, ctclip.py:167-172)."""
    if text_tokens is not None:
        return encode_text_latents(model, text_tokens, compute_dtype, plain,
                                   generator=generator, deterministic=deterministic)
    return l2norm(linear(text_embeds, model.to_text_latent.weight))


class CTCLIPOutput(NamedTuple):
    sim_matrix: torch.Tensor            # [B_img, B_txt] fp32
    image_latents: torch.Tensor         # [B, dim_latent], l2-normalised
    text_latents: torch.Tensor
    temperature: torch.Tensor           # exp(temperature)
    image_tokens: torch.Tensor          # [b, t, h, w, d] quantized CT-ViT tokens
    spatial_attn: Optional[tuple]
    temporal_attn: Optional[tuple]
    vq_state: VQState
    moe_aux: Optional[torch.Tensor] = None


def ctclip_apply(model: CTCLIP, text_tokens: dict, image: torch.Tensor, *,
                 text_embeds: Optional[torch.Tensor] = None, gather_axis=None,
                 freeze_vq: bool = True, return_weights: bool = False,
                 taps: Taps = NULL_TAPS, generator: Optional[torch.Generator] = None,
                 deterministic: bool = True, prepatchified: bool = False,
                 plain: bool = False) -> CTCLIPOutput:
    """Full forward (ctclip.py:144-197): text latents in the image's dtype,
    image latents, sim = image_latents @ text_latents^T * exp(temperature)
    in fp32. `generator` draws the text tower's dropout masks when
    deterministic=False. With text_tokens None, `text_embeds` [b, dim_text]
    (CLS-level embeddings, e.g. occlusion's pathology diff embeddings) give
    the text latents l2norm(text_embeds W^T) (ctclip.py:167-172). `taps`
    and `prepatchified` as ctvit.ctvit_apply's.

    With a data-axis mesh `gather_axis` (parallel/mesh.py) the local
    latents of every rank are gathered, with a gradient, before the sim
    matrix, which is then the global [B, B] one (ctclip.py:179-182; the
    reference's GatherWithGrad): image and text latents in one
    `all_gather`, image rows first. The VQ's EMA statistics are summed over
    the same ranks."""
    text_latents = text_latents_of(model, text_tokens, text_embeds, image.dtype, plain,
                                   generator=generator, deterministic=deterministic)
    image_latents, vit_out = encode_image_latents(
        model, image, freeze_vq=freeze_vq, return_weights=return_weights, taps=taps,
        deterministic=deterministic, prepatchified=prepatchified, plain=plain,
        vq_axis=gather_axis)
    if gather_axis is not None:
        d = image_latents.shape[-1]
        both = all_gather(torch.cat([image_latents, text_latents.to(image_latents.dtype)], -1),
                          gather_axis)
        image_latents = both[:, :d].contiguous()
        text_latents = both[:, d:].to(text_latents.dtype).contiguous()
    temp = model.temperature.exp()
    sim = (image_latents.float() @ text_latents.float().t()) * temp
    return CTCLIPOutput(sim_matrix=sim, image_latents=image_latents, text_latents=text_latents,
                        temperature=temp, image_tokens=vit_out.tokens,
                        spatial_attn=vit_out.spatial_attn, temporal_attn=vit_out.temporal_attn,
                        vq_state=vit_out.vq_state)


def contrastive_loss(sim_matrix: torch.Tensor,
                     targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE: the mean of the cross-entropies over rows and over
    columns, arange targets by default (ctclip.py:200-210)."""
    if targets is None:
        targets = torch.arange(sim_matrix.shape[0], device=sim_matrix.device)
    return (F.cross_entropy(sim_matrix, targets) + F.cross_entropy(sim_matrix.t(), targets)) / 2.0
