"""Post-training W8A8 quantisation of the CT-ViT GEGLU feed-forwards.

Counterpart of ct_clip_ut_tpu/ops/quant.py. `quantize_ctclip_ff(model)`
returns a NEW CTCLIP in which every dense FF of the visual transformer
(spatial and temporal stacks) is an `Int8FeedForward`: int8 weights with
fp32 per-output-row scales in place of the fp proj_in / proj_out
matrices. `ops.layers.feedforward` routes that module through the
geglu_ff_int8 kernel (its plain version on CPU tensors); nothing else in
the model changes, so `zeroshot_probs` and `CTClipInference` serve the
quantised model unmodified. The text tower, the projections, the VQ and
every attention module of the new model are the input's own objects; the
input model is left unchanged.

Serving only: the int8 route raises under autograd (ops/geglu_ff_int8.py).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .geglu_ff_int8 import row_quant
from .layers import FeedForward, Int8FeedForward


def quantize_weight_int8(w: torch.Tensor) -> tuple:
    """[out, in] fp weight (the nn.Linear layout) -> (int8 codes [out, in],
    fp32 per-output-row scale [out]): `row_quant`'s absmax / 127 clamped at
    1e-8, codes rounded half to even. The JAX package's per-column scale of
    its [in, out] weight (pallas_ff_int8.py:56-61), bit for bit."""
    q, s = row_quant(w.detach().float())
    return q, s[:, 0]


def quantize_ff_params(ff: FeedForward) -> Int8FeedForward:
    """One dense GEGLU FF -> its Int8FeedForward (the LN kept in fp32; the
    value, gate and output weights quantised per output row)."""
    inner = ff[4].in_features
    w_in = ff[1].weight
    wv_q, sv = quantize_weight_int8(w_in[:inner])
    wg_q, sg = quantize_weight_int8(w_in[inner:])
    w2_q, s2 = quantize_weight_int8(ff[4].weight)
    return Int8FeedForward.from_codes(ff[0].weight, ff[0].bias, wv_q, wg_q, w2_q, sv, sg, s2)


def is_quantized_ff(ff: nn.Module) -> bool:
    return isinstance(ff, Int8FeedForward)


def _with_children(module: nn.Module, **children: nn.Module) -> nn.Module:
    """A shallow copy of `module` holding the same submodules, parameters
    and buffers, but those named in `children` replaced. The registries are
    its own, so registering on the copy leaves `module` as it was."""
    out = copy.copy(module)
    out._modules = {**module._modules, **children}
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    return out


def quantize_transformer_ff(tf: nn.Module) -> nn.Module:
    """A Transformer whose dense FFs are quantised; every other submodule
    is the input's. (The port has no MoE FF: the JAX package leaves those
    untouched.)"""
    layers = nn.ModuleList(
        _with_children(layer, **{"3": quantize_ff_params(layer[3])})
        if isinstance(layer[3], FeedForward) else layer for layer in tf.layers)
    return _with_children(tf, layers=layers)


def quantize_ctvit_ff(vit: nn.Module) -> nn.Module:
    return _with_children(
        vit, enc_spatial_transformer=quantize_transformer_ff(vit.enc_spatial_transformer),
        enc_temporal_transformer=quantize_transformer_ff(vit.enc_temporal_transformer))


@torch.no_grad()
def quantize_ctclip_ff(model: nn.Module) -> nn.Module:
    """CTCLIP -> a new CTCLIP with the visual transformer's FFs quantised
    W8A8. Text tower, projections, VQ and attention stay fp (the same
    module objects)."""
    return _with_children(model, visual_transformer=quantize_ctvit_ff(model.visual_transformer))


def ff_weight_bytes(model: nn.Module) -> dict:
    """Bytes of the visual transformer's FF weights: `stored`, as the model
    holds them, and `served`, as the kernels read them (an fp FF's weight
    matrices cast to bf16 per call; an Int8FeedForward's buffers as they
    are)."""
    vit = model.visual_transformer
    stored = served = 0
    for tf in (vit.enc_spatial_transformer, vit.enc_temporal_transformer):
        for layer in tf.layers:
            ff = layer[3]
            tensors = (list(ff.buffers()) if is_quantized_ff(ff)
                       else [ff[0].weight, ff[0].bias, ff[1].weight, ff[4].weight])
            for t in tensors:
                stored += t.numel() * t.element_size()
                served += t.numel() * (2 if t.dim() == 2 and t.is_floating_point()
                                       else t.element_size())
    return dict(stored=stored, served=served)
