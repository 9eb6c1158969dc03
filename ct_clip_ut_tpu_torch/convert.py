"""Carry JAX weights into the port: the JAX CTCLIP params pytree, with its
leaves as numpy arrays, becomes a CTCLIP module with the same weights.

Transposes: JAX linear `w` is (in, out), nn.Linear stores (out, in); the
PEG kernel is DHWIO [3, 3, 3, 1, dim], Conv3d wants [dim, 1, 3, 3, 3]. The
reference's frozen LayerNorm `beta` buffers, which the JAX tree drops, are
zeros. The state dict is loaded strictly, so a weight left out raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .config import CTCLIPConfig
from .models.ctclip import CTCLIP


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
        _ln(sd, f"{lp}.3.0", layer["ff"]["norm"])
        _linear(sd, f"{lp}.3.1", layer["ff"]["proj_in"])
        _linear(sd, f"{lp}.3.4", layer["ff"]["proj_out"])
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


def from_jax_params(np_tree, cfg: CTCLIPConfig, device="cuda") -> CTCLIP:
    """CTCLIP (eval mode, on `device`: the card unless told otherwise)
    holding the weights of the JAX params tree. The conv patch embed
    (`patch_embed_conv=True`) reads the same norm_in / proj / norm_out
    weights and folds them at call time, as the JAX package does."""
    device = _build.check_device(device)
    sd = {}
    _bert(sd, "text_transformer", np_tree["text_transformer"])
    v = np_tree["visual_transformer"]
    for i, layer in enumerate(v["spatial_rel_pos_bias"]["net"]):
        last = i == len(v["spatial_rel_pos_bias"]["net"]) - 1
        _linear(sd, f"visual_transformer.spatial_rel_pos_bias.net.{i}" + ("" if last else ".0"),
                layer)
    for idx, name in ((1, "norm_in"), (3, "norm_out")):
        _ln(sd, f"visual_transformer.to_patch_emb.{idx}", v["to_patch_emb"][name])
    _linear(sd, "visual_transformer.to_patch_emb.2", v["to_patch_emb"]["proj"])
    _transformer(sd, "visual_transformer.enc_spatial_transformer", v["spatial"])
    _transformer(sd, "visual_transformer.enc_temporal_transformer", v["temporal"])
    vq = v["vq"]
    sd["visual_transformer.vq._codebook.embed"] = _t(vq.embed)
    sd["visual_transformer.vq._codebook.embed_avg"] = _t(vq.embed_avg)
    sd["visual_transformer.vq._codebook.cluster_size"] = _t(vq.cluster_size)
    _linear(sd, "to_text_latent", np_tree["to_text_latent"])
    _linear(sd, "to_visual_latent", np_tree["to_visual_latent"])
    sd["temperature"] = _t(np_tree["temperature"]).reshape(())

    with torch.device("meta"):
        model = CTCLIP(cfg)
    model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()
