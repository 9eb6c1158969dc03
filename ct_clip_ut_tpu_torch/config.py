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
            # the JAX package's flag reaches its spatial stack only (a serving
            # experiment there); here it selects the PEG kernels of both stacks
            peg_pallas=self.peg_pallas,
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
class T5EncoderConfig:
    """T5-v1_1-base encoder shape."""
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    max_length: int = 256  # tokenizer truncation


@dataclass(frozen=True)
class MaskGitConfig:
    """MaskGit transformer over CT-ViT codebook ids."""
    dim: int = 512
    num_tokens: int = 8192
    max_seq_len: int = 10000
    gradient_shrink_alpha: float = 0.1
    heads: int = 8
    dim_head: int = 64
    depth: int = 6
    dim_context: int = 768
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, depth=self.depth, dim_context=self.dim_context,
            dim_head=self.dim_head, heads=self.heads, attn_num_null_kv=2,
            has_cross_attn=True, attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout, peg=True, peg_causal=False)


@dataclass(frozen=True)
class CTCLIPConfig:
    """Dual-tower contrastive model."""
    dim_text: int = 768
    dim_image: int = 294912  # 24*24*512 after temporal mean + flatten
    dim_latent: int = 512
    temperature_init: float = 1.0
    ctvit: CTViTConfig = field(default_factory=CTViTConfig)
    bert: BertConfig = field(default_factory=BertConfig)


@dataclass(frozen=True)
class CTGenerateConfig:
    """CT-ViT tokenizer + MaskGit + T5: [1, 201, 128, 128] scans -> a
    101 x 8 x 8 token grid."""
    ctvit: CTViTConfig = field(default_factory=lambda: CTViTConfig(
        image_size=128, patch_size=16, temporal_patch_size=2,
        model_type="ctgenerate"))
    maskgit: MaskGitConfig = field(default_factory=MaskGitConfig)
    t5: T5EncoderConfig = field(default_factory=T5EncoderConfig)


@dataclass(frozen=True)
class PreprocessConfig:
    """CT preprocessing chain (ct_clip_ut_tpu/config.py:348-356)."""
    target_spacing: Tuple[float, float, float] = (1.5, 0.75, 0.75)  # (z, x, y) mm
    hu_min: float = -1000.0
    hu_max: float = 1000.0
    target_shape_hwd: Tuple[int, int, int] = (480, 480, 240)  # (H, W, D)
    pad_value: float = -1.0
    ctgenerate_shape: Tuple[int, int, int] = (201, 128, 128)  # (D, H, W)


@dataclass(frozen=True)
class OcclusionConfig:
    """Occlusion sensitivity sweep (ct_clip_ut_tpu/config.py:359-366): a
    20 x 40 x 40 window at stride 10 x 20 x 20 filled with -1 (23^3 =
    12,167 windows over a 240 x 480 x 480 volume)."""
    patch_size: Tuple[int, int, int] = (20, 40, 40)
    stride: Tuple[int, int, int] = (10, 20, 20)
    threshold: float = 0.0
    fill_value: float = -1.0
    batch_size: int = 8  # masked forwards evaluated per device batch


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (ct_clip_ut_tpu/config.py:280-289). `data` shards
    the batch over processes (parallel/mesh.py); a `model` (tensor-parallel)
    axis above 1 is not ported and raises."""
    data: int = 1
    model: int = 1

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", "model")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (ct_clip_ut_tpu/config.py:293-345; reference
    CTClipTrainer.py:38-59, optimizer.py). The port runs single-pass and
    GradCache (grad_accum > 1) steps on one card or data-parallel over
    processes; fsdp shards the parameters, gradients and Adam's moments
    over the ranks at rest (parallel/sharding.py) and sharded_checkpoints
    writes directories every rank writes its pieces into
    (train/checkpoint.py). The MoE aux loss raises in the trainer (ROADMAP
    Queue 1 item 11h)."""
    batch_size: int = 1          # per-device
    lr: float = 1.25e-5
    wd: float = 0.0              # wd==0 -> plain Adam (reference optimizer.py:42)
    betas: Tuple[float, float] = (0.9, 0.99)
    eps: float = 1e-8
    max_grad_norm: float = 0.5
    num_epochs: int = 10
    num_save_split: int = 5
    num_train_samples: int = 100
    num_valid_samples: int = 20
    save_best_model: bool = False
    # atomically write last_checkpoint every N global steps (0 = off)
    save_every_steps: int = 0
    text_max_length: int = 512   # tokenizer truncation (CTClipTrainer.py:191)
    compute_dtype: str = "bfloat16"
    seed: int = 42
    # GradCache chunking (the JAX package's make_train_step_gradcache); 1 = single pass
    grad_accum: int = 1
    sharded_checkpoints: bool = False
    moe_aux_weight: float = 0.01
    # profiler window of steps [2, 2 + profile_steps) (0 = off)
    profile_steps: int = 0
    profile_dir: str = "/tmp/ctclip_trace"
    # LR schedule (both 0 = constant lr): linear warmup, then cosine decay
    warmup_steps: int = 0
    decay_steps: int = 0
    end_lr_frac: float = 0.0
    # Adam's first moment in this dtype ("bfloat16"); None = fp32
    adam_mu_dtype: Optional[str] = None
    fsdp: bool = False


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
