"""Configuration: frozen dataclasses mirroring ct_clip_ut_tpu/config.py.

The port keeps its own copy of the config classes it uses, field for field
and default for default, because the port (and chip_smoke.py, which drives
it) loads nothing of the JAX package: the GPU machine runs the checkout's
port alone. tests/test_torch_port_modules.py holds each class equal to its
JAX counterpart. The JAX package's config objects work wherever these do
(the port reads attributes only).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# the 18-pathology label set (ct_clip_ut_tpu/config.py:19-38)
PATHOLOGIES: Tuple[str, ...] = (
    "Medical material",
    "Arterial wall calcification",
    "Cardiomegaly",
    "Pericardial effusion",
    "Coronary artery wall calcification",
    "Hiatal hernia",
    "Lymphadenopathy",
    "Emphysema",
    "Atelectasis",
    "Lung nodule",
    "Lung opacity",
    "Pulmonary fibrotic sequela",
    "Pleural effusion",
    "Mosaic attenuation pattern",
    "Peribronchial thickening",
    "Consolidation",
    "Bronchiectasis",
    "Interlobular septal thickening",
)


@dataclass(frozen=True)
class AttentionConfig:
    """Cosine-sim (QK-normalised) attention."""
    dim: int = 512
    dim_context: Optional[int] = None  # None -> dim
    dim_head: int = 64
    heads: int = 8
    causal: bool = False
    num_null_kv: int = 0
    norm_context: bool = True
    dropout: float = 0.0
    scale: float = 8.0  # fixed post-l2norm scale

    @property
    def inner_dim(self) -> int:
        return self.dim_head * self.heads

    @property
    def context_dim(self) -> int:
        return self.dim_context if self.dim_context is not None else self.dim


@dataclass(frozen=True)
class TransformerConfig:
    """Transformer block stack."""
    dim: int = 512
    depth: int = 4
    dim_context: Optional[int] = None
    causal: bool = False
    dim_head: int = 64
    heads: int = 8
    ff_mult: float = 4.0
    peg: bool = False
    peg_causal: bool = False
    peg_pallas: bool = False
    attn_num_null_kv: int = 2
    has_cross_attn: bool = False
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    def self_attn(self) -> AttentionConfig:
        return AttentionConfig(
            dim=self.dim, dim_head=self.dim_head, heads=self.heads,
            causal=self.causal, dropout=self.attn_dropout)

    def cross_attn(self) -> AttentionConfig:
        return AttentionConfig(
            dim=self.dim, dim_head=self.dim_head, dim_context=self.dim_context,
            heads=self.heads, causal=False, num_null_kv=self.attn_num_null_kv,
            dropout=self.attn_dropout)

    @property
    def ff_inner_dim(self) -> int:
        # GEGLU inner dim = int(mult * 2/3 * dim)
        return int(self.ff_mult * (2.0 / 3.0) * self.dim)


@dataclass(frozen=True)
class CTViTConfig:
    """CT-ViT 3-D video tokenizer: 480^2 x 240 volume -> 24 x 24 spatial x
    24 temporal patch grid, dim 512."""
    dim: int = 512
    codebook_size: int = 8192
    image_size: int = 480
    patch_size: int = 20
    temporal_patch_size: int = 10
    spatial_depth: int = 4
    temporal_depth: int = 4
    dim_head: int = 32
    heads: int = 8
    channels: int = 1
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    model_type: str = "ctclip"  # or "ctgenerate" (first-frame embed path)
    vq_decay: float = 0.8
    vq_eps: float = 1e-5
    patch_embed_conv: bool = True
    remat: bool = False
    peg_pallas: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2

    @property
    def patch_height(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_width(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2 * self.temporal_patch_size

    @property
    def first_frame_patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    def spatial_transformer(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, depth=self.spatial_depth, dim_head=self.dim_head,
            heads=self.heads, attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout, peg=True, peg_causal=True,
            peg_pallas=self.peg_pallas,
            remat=self.remat, moe_experts=self.moe_experts,
            moe_top_k=self.moe_top_k)

    def temporal_transformer(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, depth=self.temporal_depth, dim_head=self.dim_head,
            heads=self.heads, attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout, peg=True, peg_causal=True,
            remat=self.remat, moe_experts=self.moe_experts,
            moe_top_k=self.moe_top_k)


@dataclass(frozen=True)
class BertConfig:
    """BERT-style text tower (CXR-BERT-specialized shape)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1


@dataclass(frozen=True)
class CTCLIPConfig:
    """Dual-tower contrastive model."""
    dim_text: int = 768
    dim_image: int = 294912  # 24*24*512 after temporal mean + flatten
    dim_latent: int = 512
    temperature_init: float = 1.0
    ctvit: CTViTConfig = field(default_factory=CTViTConfig)
    bert: BertConfig = field(default_factory=BertConfig)


def replace(cfg, **kw):
    """dataclasses.replace that works on any frozen config."""
    return dataclasses.replace(cfg, **kw)


def flagship_cfg() -> CTCLIPConfig:
    """The zero-shot flagship (bench.py:102-109: CT-ViT dim 512, 4 + 4
    layers of 8 heads of 32, 8192 codes, 480 x 480 x 240 volumes; CXR-BERT
    text tower) at the JAX default, the LN-folded conv patch embed
    (`patch_embed_conv=True`, the patch_embed kernel). The plain embed is
    the same function: `replace(cfg.ctvit, patch_embed_conv=False)`."""
    return CTCLIPConfig(
        dim_text=768, dim_image=294912, dim_latent=512,
        ctvit=CTViTConfig(dim=512, codebook_size=8192, image_size=480,
                          patch_size=20, temporal_patch_size=10,
                          spatial_depth=4, temporal_depth=4,
                          dim_head=32, heads=8, patch_embed_conv=True),
        bert=BertConfig())
