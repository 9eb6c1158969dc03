"""Weights into the port: the JAX params tree, the reference's torch
checkpoints, and the one loader every CLI shares.

`from_jax_params` carries a JAX CTCLIP (or CTGenerate) params pytree, its
leaves as numpy arrays, into the port's module with the same weights.
Transposes: JAX linear `w` is (in, out), nn.Linear stores (out, in); the
PEG kernel is DHWIO [3, 3, 3, 1, dim], Conv3d wants [dim, 1, 3, 3, 3]. The
reference's frozen LayerNorm `beta` buffers, which the JAX tree drops, are
zeros. A W8A8 tree (the JAX `quantize_ctclip_ff`: int8 codes and scales
under `ff`) gives Int8FeedForward modules, the codes transposed and the
inner width padded as `ops/quant.py` pads its own. The state dict is
loaded strictly, so a weight left out raises.

`reference_ctclip_state` / `reference_ctgenerate_state` read the
reference's own state dicts (`ctclip_v2.pt`, `ctgenerate_filtered.pt`; the
counterpart of ct_clip_ut_tpu/train/checkpoint.py:107-350). The port's
modules carry the reference's torch names, so the map is direct, with the
quirks the JAX converter handles: the trainer's `{"model": ...}` wrapper
and DDP's `module.` prefix; the VQ buffers under `_codebook.` or
`codebook.`, with a leading num_codebooks axis, `embed_avg` defaulting to
`embed` and `cluster_size` to zeros; an attention's `context_norm` where
the checkpoint has one (self-attention never reads it: the init's ones
otherwise); the frozen LayerNorm `beta` buffers as zeros, as the JAX tree
drops them; `temperature` as a scalar; every tensor as fp32. The
reference's keys the port has no place for are `REFERENCE_DROPPED`; any
other unknown key, and any key of the port's module the checkpoint lacks,
raises and names it. CTGenerate's T5 tower comes from a separate HF
`T5EncoderModel` state dict (scripts/convert_checkpoint.py --t5).

`ctclip_from` / `load_ctclip` take any of three checkpoints: the
reference's, a state dict of the port's CTCLIP, or the port's train-state
checkpoint (train/checkpoint.py). `load_ctgenerate` takes a state dict of
the port's CTGenerate (the reference's file converted with its T5 tower).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .config import CTCLIPConfig, CTGenerateConfig
from .models.ctclip import CTCLIP
from .models.ctgenerate import CTGenerate
from .ops.layers import FrozenBiasLayerNorm, Int8FeedForward

# The reference's keys with no place in the port, as suffixes: HF BERT's
# position-id buffer and pooler (CT-CLIP reads the [CLS] row, not the
# pooler), and HF T5's tied copy of `shared.weight`.
REFERENCE_DROPPED = ("embeddings.position_ids", "pooler.dense.weight", "pooler.dense.bias",
                     "encoder.embed_tokens.weight")


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


# -- the reference's checkpoints -------------------------------------------

def _unwrap(sd: dict) -> dict:
    """The state dict inside the reference trainer's {"model": ..., "optim":
    ...} wrapper, DDP's `module.` prefix removed."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _meta(model_cls, cfg):
    with torch.device("meta"):
        return model_cls(cfg)


def _reference_state(sd: dict, model: torch.nn.Module) -> dict:
    """The reference-named state dict `sd` as `model`'s state dict (its keys
    and shapes; `model` may live on the meta device), with the module doc's
    quirks. Raises KeyError naming every unknown and every missing key."""
    want = {k: v.shape for k, v in model.state_dict().items()}
    frozen_beta = {f"{name}.beta" for name, mod in model.named_modules()
                   if isinstance(mod, FrozenBiasLayerNorm)}
    out, unknown = {}, []
    for key, value in sd.items():
        name = key.replace(".vq.codebook.", ".vq._codebook.")
        if name in want:
            out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32)
        elif not key.endswith(REFERENCE_DROPPED):
            unknown.append(key)
    for name in want:
        if name in frozen_beta:
            out[name] = torch.zeros(want[name])
        elif name.endswith(".context_norm.gamma") and name not in out:
            out[name] = torch.ones(want[name])
        elif name.endswith("vq._codebook.embed_avg") and name not in out:
            embed = name[:-len("embed_avg")] + "embed"
            if embed in out:
                out[name] = out[embed].clone()
        elif name.endswith("vq._codebook.cluster_size") and name not in out:
            out[name] = torch.zeros(want[name])
    missing = sorted(set(want) - set(out))
    if unknown or missing:
        raise KeyError(f"not a reference checkpoint of this configuration: unknown keys "
                       f"{sorted(unknown)}, missing keys {missing}")
    for name, shape in want.items():
        t = out[name]
        if name.endswith("vq._codebook.cluster_size"):
            t = t.reshape(-1)[:shape[0]]      # a leading num_codebooks axis
        elif name.endswith(("vq._codebook.embed", "vq._codebook.embed_avg")) or name == "temperature":
            t = t.reshape(shape)
        if t.shape != shape:
            raise ValueError(f"{name}: the checkpoint's shape {tuple(t.shape)}, the port's "
                             f"{tuple(shape)}")
        out[name] = t.contiguous()
    return out


def reference_ctclip_state(sd: dict, cfg: CTCLIPConfig) -> dict:
    """A reference CTCLIP state dict (`ctclip_v2.pt`) as the port's CTCLIP
    state dict (ct_clip_ut_tpu/train/checkpoint.py:convert_ctclip)."""
    return _reference_state(_unwrap(sd), _meta(CTCLIP, cfg))


def reference_ctgenerate_state(sd: dict, cfg: CTGenerateConfig, t5_sd: dict) -> dict:
    """The reference's `ctgenerate_filtered.pt` (ctvit.* and maskgit.*) with
    the T5 tower from an HF `T5EncoderModel` state dict, as the port's
    CTGenerate state dict (checkpoint.py:convert_ctgenerate)."""
    if t5_sd is None:
        raise ValueError("CTGenerate's T5 tower is not in the reference's checkpoint: pass an "
                         "HF T5EncoderModel state dict")
    merged = dict(_unwrap(sd))
    merged.update({f"t5.{k}": v for k, v in _unwrap(t5_sd).items()})
    return _reference_state(merged, _meta(CTGenerate, cfg))


def read_checkpoint(path) -> dict:
    """A torch checkpoint file's tensors and containers, on the CPU (the
    weights-only unpickler: the file runs no code)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def is_train_state(blob) -> bool:
    """Whether a checkpoint's contents are the port's train state
    (train/checkpoint.py: model, optimizer, step, generator)."""
    return isinstance(blob, dict) and {"model", "optimizer", "step"} <= set(blob)


def _port_state(blob: dict, model: torch.nn.Module) -> Optional[dict]:
    """The port's own state dict in `blob` (a train-state checkpoint's
    "model", or `blob` itself when its keys and shapes are the module's),
    else None."""
    if is_train_state(blob):
        blob = blob["model"]
    want = {k: v.shape for k, v in model.state_dict().items()}
    if set(blob) == set(want) and all(torch.as_tensor(blob[k]).shape == want[k] for k in want):
        return blob
    return None


def ctclip_from(blob: dict, cfg: CTCLIPConfig, device="cuda") -> CTCLIP:
    """CTCLIP (eval mode, on `device`) from a checkpoint's contents: the
    reference's state dict, a state dict of the port's CTCLIP, or the
    port's train state."""
    sd = _port_state(blob, _meta(CTCLIP, cfg))
    return _load(CTCLIP, cfg, sd if sd is not None else reference_ctclip_state(blob, cfg),
                 device)


def load_ctclip(path, cfg: CTCLIPConfig, device="cuda") -> CTCLIP:
    """`ctclip_from` of the file at `path`."""
    return ctclip_from(read_checkpoint(path), cfg, device)


def load_ctgenerate(path, cfg: CTGenerateConfig, device="cuda") -> CTGenerate:
    """CTGenerate (eval mode, on `device`) from `path`, a state dict of the
    port's CTGenerate. The reference's `ctgenerate_filtered.pt` holds no T5
    tower and raises: convert it with one first (scripts/convert_checkpoint.py
    --t5)."""
    sd = _port_state(read_checkpoint(path), _meta(CTGenerate, cfg))
    if sd is None:
        raise ValueError(
            f"{path} is not a state dict of the port's CTGenerate. The reference's "
            "ctgenerate_filtered.pt holds no T5 tower: convert it with one (python -m "
            f"ct_clip_ut_tpu_torch.scripts.convert_checkpoint --kind ctgenerate --in {path} "
            "--t5 T5_STATE_DICT.pt --out PORT.pt)")
    return _load(CTGenerate, cfg, sd, device)
