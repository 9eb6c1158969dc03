"""CTCLIP: BERT text tower + CT-ViT image tower, l2-normalised latents.

Counterpart of ct_clip_ut_tpu/models/ctclip.py: the latents, the full
forward `ctclip_apply` (sim matrix scaled by exp(temperature)) and the
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
from ..ops.vq import _Codebook
from .bert import Bert, bert_cls
from ..ops.vq import VQState
from .ctvit import CTViT, ctvit_apply


class CTCLIP(nn.Module):
    def __init__(self, cfg: CTCLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.text_transformer = Bert(cfg.bert)
        self.visual_transformer = CTViT(cfg.ctvit)
        self.to_text_latent = nn.Linear(cfg.dim_text, cfg.dim_latent, bias=False)
        self.to_visual_latent = nn.Linear(cfg.dim_image, cfg.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.tensor(cfg.temperature_init))


@torch.no_grad()
def init_ctclip(cfg: CTCLIPConfig, seed: int = 0, device="cuda") -> CTCLIP:
    """A CTCLIP in eval mode with weights drawn from `seed`, with the JAX
    package's init distributions: linear and conv weights U(+-sqrt(3/fan_in)),
    biases U(+-1/sqrt(fan_in)), embeddings N(0, 0.02^2), null key/values
    N(0, 1), LayerNorm and q/k scales ones, the codebook l2-normalised N(0, 1)
    rows. Built on the meta device first, so no default init is paid. On
    the card unless `device` says otherwise; without one, the default
    raises."""
    device = _build.check_device(device)
    with torch.device("meta"):
        model = CTCLIP(cfg)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    done = set()

    def uniform_(t, bound):
        t.copy_(torch.rand(t.shape, generator=gen, device=device) * (2 * bound) - bound)
        done.add(id(t))

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=device) * std)
        done.add(id(t))

    def fill_(t, value):
        t.fill_(value)
        done.add(id(t))

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            uniform_(m.weight, math.sqrt(3.0 / fan_in))
            if m.bias is not None:
                uniform_(m.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(m, nn.LayerNorm):
            fill_(m.weight, 1.0)
            fill_(m.bias, 0.0)
        elif isinstance(m, FrozenBiasLayerNorm):
            fill_(m.gamma, 1.0)
            fill_(m.beta, 0.0)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, Attention):
            fill_(m.q_scale, 1.0)
            fill_(m.k_scale, 1.0)
            normal_(m.null_kv, 1.0)
        elif isinstance(m, _Codebook):
            normal_(m.embed, 1.0)
            m.embed.copy_(l2norm(m.embed))
            m.embed_avg.copy_(m.embed)
            fill_(m.cluster_size, 0.0)
            done.add(id(m.embed_avg))
    fill_(model.temperature, cfg.temperature_init)
    missing = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if id(t) not in done]
    if missing:
        raise AssertionError(f"init_ctclip left tensors uninitialised: {missing}")
    return model.eval()


def encode_image_latents(model: CTCLIP, image: torch.Tensor, *, freeze_vq: bool = True,
                         return_weights: bool = False, taps=None, deterministic: bool = True,
                         plain: bool = False):
    """CT-ViT -> fp32 temporal mean (cast back) -> flatten -> project ->
    l2norm (ctclip.py:63-83). Returns (latents, CTViTOutput)."""
    vit_out = ctvit_apply(model.visual_transformer, image, freeze_vq=freeze_vq,
                          return_weights=return_weights, taps=taps,
                          deterministic=deterministic, plain=plain)
    tokens = vit_out.tokens
    pooled = tokens.float().mean(dim=1).to(tokens.dtype)
    latents = linear(pooled.reshape(pooled.shape[0], -1), model.to_visual_latent.weight)
    return l2norm(latents), vit_out


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
                 freeze_vq: bool = True, return_weights: bool = False, taps=None,
                 generator: Optional[torch.Generator] = None, deterministic: bool = True,
                 plain: bool = False) -> CTCLIPOutput:
    """Full forward (ctclip.py:144-197): text latents in the image's dtype,
    image latents, sim = image_latents @ text_latents^T * exp(temperature)
    in fp32. `generator` draws the text tower's dropout masks when
    deterministic=False."""
    if text_embeds is not None or text_tokens is None:
        raise NotImplementedError(
            "the precomputed text-embedding bypass is not ported yet "
            "(ROADMAP, Queue 1 item 9: attribution / occlusion)")
    if gather_axis is not None:
        raise NotImplementedError(
            "the gradient-carrying all-gather of latents is not ported yet "
            "(ROADMAP, Queue 1 item 11: parallel)")
    text_latents = encode_text_latents(model, text_tokens, compute_dtype=image.dtype,
                                       plain=plain, generator=generator,
                                       deterministic=deterministic)
    image_latents, vit_out = encode_image_latents(
        model, image, freeze_vq=freeze_vq, return_weights=return_weights, taps=taps,
        deterministic=deterministic, plain=plain)
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
