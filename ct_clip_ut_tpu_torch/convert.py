"""Carry JAX weights into the port: the JAX CTCLIP (or CTGenerate) params
pytree, with its leaves as numpy arrays, becomes the port's module with the
same weights.

Transposes: JAX linear `w` is (in, out), nn.Linear stores (out, in); the
PEG kernel is DHWIO [3, 3, 3, 1, dim], Conv3d wants [dim, 1, 3, 3, 3]. The
reference's frozen LayerNorm `beta` buffers, which the JAX tree drops, are
zeros. A W8A8 tree (the JAX `quantize_ctclip_ff`: int8 codes and scales
under `ff`) gives Int8FeedForward modules, the codes transposed and the
inner width padded as `ops/quant.py` pads its own. The state dict is
loaded strictly, so a weight left out raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .config import CTCLIPConfig, CTGenerateConfig
from .models.ctclip import CTCLIP
from .models.ctgenerate import CTGenerate
from .ops.layers import Int8FeedForward


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["gamma"])
    sd[f"{prefix}.bias"] = _t(p["beta"])


def _ln_frozen(sd, prefix, p):
    sd[f"{prefix}.gamma"] = _t(p["gamma"])
    sd[f"{prefix}.beta"] = torch.zeros(np.asarray(p["gamma"]).shape)


def _attention(sd, prefix, p):
    _ln_frozen(sd, f"{prefix}.norm", p["norm"])
    for name in ("to_q", "to_kv", "to_out"):
        _linear(sd, f"{prefix}.{name}", p[name])
    for name in ("q_scale", "k_scale", "null_kv"):
        sd[f"{prefix}.{name}"] = _t(p[name])
    if "context_norm" in p:
        _ln_frozen(sd, f"{prefix}.context_norm", p["context_norm"])


def _transformer(sd, prefix, p):
    for i, layer in enumerate(p["layers"]):
        lp = f"{prefix}.layers.{i}"
        if "peg" in layer:
            w = np.asarray(layer["peg"]["w"])                   # [3, 3, 3, 1, dim]
            sd[f"{lp}.0.dsconv.weight"] = _t(np.transpose(w, (4, 3, 0, 1, 2)))
            sd[f"{lp}.0.dsconv.bias"] = _t(layer["peg"]["b"])
        _attention(sd, f"{lp}.1", layer["self_attn"])
        if "cross_attn" in layer:
            _attention(sd, f"{lp}.2", layer["cross_attn"])
        ff = layer["ff"]
        if "wv_q" in ff:            # quantize_ff_params' tree: an Int8FeedForward
            codes = [torch.tensor(np.asarray(ff[k]).T.copy()) for k in ("wv_q", "wg_q", "w2_q")]
            q = Int8FeedForward.from_codes(_t(ff["norm"]["gamma"]), _t(ff["norm"]["beta"]),
                                           *codes, *(_t(ff[k]) for k in ("sv", "sg", "s2")))
            sd.update({f"{lp}.3.{k}": t for k, t in q.state_dict().items()})
        else:
            _ln(sd, f"{lp}.3.0", ff["norm"])
            _linear(sd, f"{lp}.3.1", ff["proj_in"])
            _linear(sd, f"{lp}.3.4", ff["proj_out"])
    _ln_frozen(sd, f"{prefix}.norm_out", p["norm_out"])


def _bert(sd, prefix, p):
    e = p["embeddings"]
    sd[f"{prefix}.embeddings.word_embeddings.weight"] = _t(e["word"])
    sd[f"{prefix}.embeddings.position_embeddings.weight"] = _t(e["position"])
    sd[f"{prefix}.embeddings.token_type_embeddings.weight"] = _t(e["token_type"])
    _ln(sd, f"{prefix}.embeddings.LayerNorm", e["ln"])
    for i, layer in enumerate(p["layers"]):
        lp = f"{prefix}.encoder.layer.{i}"
        _linear(sd, f"{lp}.attention.self.query", layer["q"])
        _linear(sd, f"{lp}.attention.self.key", layer["k"])
        _linear(sd, f"{lp}.attention.self.value", layer["v"])
        _linear(sd, f"{lp}.attention.output.dense", layer["attn_out"])
        _ln(sd, f"{lp}.attention.output.LayerNorm", layer["attn_ln"])
        _linear(sd, f"{lp}.intermediate.dense", layer["ffn_in"])
        _linear(sd, f"{lp}.output.dense", layer["ffn_out"])
        _ln(sd, f"{lp}.output.LayerNorm", layer["ffn_ln"])


def _cpb(sd, prefix, p):
    for i, layer in enumerate(p["net"]):
        _linear(sd, f"{prefix}.net.{i}" + ("" if i == len(p["net"]) - 1 else ".0"), layer)


def _ctvit(sd, prefix, v):
    _cpb(sd, f"{prefix}.spatial_rel_pos_bias", v["spatial_rel_pos_bias"])
    for emb in ("to_patch_emb", "to_patch_emb_first_frame"):
        if emb in v:
            for idx, name in ((1, "norm_in"), (3, "norm_out")):
                _ln(sd, f"{prefix}.{emb}.{idx}", v[emb][name])
            _linear(sd, f"{prefix}.{emb}.2", v[emb]["proj"])
    _transformer(sd, f"{prefix}.enc_spatial_transformer", v["spatial"])
    _transformer(sd, f"{prefix}.enc_temporal_transformer", v["temporal"])
    vq = v["vq"]
    sd[f"{prefix}.vq._codebook.embed"] = _t(vq.embed)
    sd[f"{prefix}.vq._codebook.embed_avg"] = _t(vq.embed_avg)
    sd[f"{prefix}.vq._codebook.cluster_size"] = _t(vq.cluster_size)


def _load(model_cls, cfg, sd, device):
    """The module built on the meta device, filled strictly from sd; each FF
    whose weights sd holds as int8 codes becomes an Int8FeedForward."""
    device = _build.check_device(device)
    with torch.device("meta"):
        model = model_cls(cfg)
        for key in [k for k in sd if k.endswith(".3.wv_q")]:
            layer = model.get_submodule(key[:-len(".3.wv_q")])
            layer[3] = Int8FeedForward(layer[3][1].in_features, layer[3][4].in_features)
    model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def from_jax_params(np_tree, cfg: CTCLIPConfig, device="cuda") -> CTCLIP:
    """CTCLIP (eval mode, on `device`: the card unless told otherwise)
    holding the weights of the JAX params tree. The conv patch embed
    (`patch_embed_conv=True`) reads the same norm_in / proj / norm_out
    weights and folds them at call time, as the JAX package does."""
    sd = {}
    _bert(sd, "text_transformer", np_tree["text_transformer"])
    _ctvit(sd, "visual_transformer", np_tree["visual_transformer"])
    _linear(sd, "to_text_latent", np_tree["to_text_latent"])
    _linear(sd, "to_visual_latent", np_tree["to_visual_latent"])
    sd["temperature"] = _t(np_tree["temperature"]).reshape(())
    return _load(CTCLIP, cfg, sd, device)


def from_jax_ctgenerate_params(np_tree, cfg: CTGenerateConfig, device="cuda") -> CTGenerate:
    """CTGenerate (eval mode, on `device`) holding the weights of the JAX
    init_ctgenerate tree: the ctgenerate CT-ViT, MaskGit (cross-attention
    at ModuleList index 2) and the T5 encoder under HF T5's names."""
    sd = {}
    _ctvit(sd, "ctvit", np_tree["ctvit"])
    m = np_tree["maskgit"]
    sd["maskgit.token_emb.weight"] = _t(m["token_emb"])
    sd["maskgit.pos_emb.weight"] = _t(m["pos_emb"])
    _cpb(sd, "maskgit.continuous_pos_bias", m["continuous_pos_bias"])
    _transformer(sd, "maskgit.transformer", m["transformer"])
    _linear(sd, "maskgit.to_logits", m["to_logits"])
    t = np_tree["t5"]
    sd["t5.shared.weight"] = _t(t["shared"])
    sd["t5.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
        _t(t["rel_bias"])
    sd["t5.encoder.final_layer_norm.weight"] = _t(t["final_norm"])
    for i, blk in enumerate(t["blocks"]):
        bp = f"t5.encoder.block.{i}.layer"
        sd[f"{bp}.0.layer_norm.weight"] = _t(blk["attn_norm"])
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{bp}.0.SelfAttention.{name}", blk[name])
        sd[f"{bp}.1.layer_norm.weight"] = _t(blk["ff_norm"])
        for name in ("wi_0", "wi_1", "wo"):
            _linear(sd, f"{bp}.1.DenseReluDense.{name}", blk[name])
    return _load(CTGenerate, cfg, sd, device)
