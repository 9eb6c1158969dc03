"""One post-LN BERT encoder layer: kernel wrapper and plain version.

Replaces ct_clip_ut_tpu/ops/pallas_bert_layer.py:bert_layer_fused, forward
and deterministic (the text tower at n >= 128 tokens: the zero-shot prompts
padded to 512). The CUDA chain is `csrc/bert_layer.cu`; its header says
what bounds it on the H100 and what the design does about it.

Both versions take fp32 only: the zero-shot path encodes its prompts in
fp32 (`encode_text_latents`), and the bf16 variant belongs to the training
path, which comes with the layer's backward. Weights are in the nn.Linear
(out, in) layout: wqkv [3D, D] (query, key, value rows), wo [D, D],
w1 [F, D], w2 [D, F].

`bert_layer_plain` is `pallas_bert_layer._fwd_body` (:99-151) in plain
PyTorch: fp32 qkv with bias, scores scaled by 1/sqrt(dh) plus HF's additive
key mask, softmax, out-projection + bias + residual, LayerNorm in the
one-pass E[r^2] - E[r]^2 form, exact-erf GELU FF, the second residual
taken from the fp32 LN1 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from . import launches

DIM_HEAD = 64   # the head width the CUDA attention core takes


def _ln(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    mean = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mean * mean
    return (r - mean) * torch.rsqrt(var.clamp_min(0.0) + eps) * gamma + beta


def _check_dropout(p_attn: float, p_hidden: float, train: bool) -> None:
    if train or p_attn > 0.0 or p_hidden > 0.0:
        raise NotImplementedError(
            "bert_layer runs the deterministic forward only: dropout and train mode come "
            "with the layer's backward and its Philox masks (ROADMAP, Queue 2 item 8)")


def bert_layer_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                     heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                     train: bool = False) -> torch.Tensor:
    """x [B, n, D] fp32; mask_row [B, n] additive fp32 (0 or dtype-min).
    Returns [B, n, D] fp32."""
    _check_dropout(p_attn, p_hidden, train)
    if x.dtype != torch.float32:
        raise TypeError(f"bert_layer takes fp32 activations, got {x.dtype} (the bf16 "
                        "training variant is not ported yet)")
    b, n, d = x.shape
    dh = d // heads
    qkv = x @ wqkv.t() + bqkv
    q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (1.0 / dh ** 0.5) + mask_row[:, None, None, :]
    ctx = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, n, d)
    y = _ln(ctx @ wo.t() + bo + x, g1, be1, eps)
    g = F.gelu(y @ w1.t() + b1)
    return _ln(g @ w2.t() + b2 + y, g2, be2, eps)


def bert_layer(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
               heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
               train: bool = False) -> torch.Tensor:
    """The bert_layer kernel chain on CUDA tensors (all fp32, contiguous,
    heads of 64), the plain version on CPU tensors."""
    _check_dropout(p_attn, p_hidden, train)
    if not _build.on_cuda(x):
        return bert_layer_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2,
                                g2, be2, heads, eps)
    b, n, d = x.shape
    f = w1.shape[0]
    if d != heads * DIM_HEAD or f % 4:
        raise ValueError(f"the bert_layer kernel takes heads of {DIM_HEAD} and an FF width "
                         f"that 4 divides; got D={d}, heads={heads}, F={f}")
    dev = x.device
    args = ((x, "x", (b, n, d)), (mask_row, "mask_row", (b, n)),
            (wqkv, "wqkv", (3 * d, d)), (bqkv, "bqkv", (3 * d,)), (wo, "wo", (d, d)),
            (bo, "bo", (d,)), (g1, "g1", (d,)), (be1, "be1", (d,)), (w1, "w1", (f, d)),
            (b1, "b1", (f,)), (w2, "w2", (d, f)), (b2, "b2", (d,)), (g2, "g2", (d,)),
            (be2, "be2", (d,)))
    for t, name, shape in args:
        _build.require(t, name, torch.float32, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads float4, the data must be 16-B aligned")
    m = b * n
    f32 = dict(dtype=torch.float32, device=dev)
    ws = (torch.empty((m, 3 * d), **f32), torch.empty((m, d), **f32),
          torch.empty((m, d), **f32), torch.empty((m, d), **f32), torch.empty((m, f), **f32))
    out = torch.empty_like(x)
    err = _build.load().ctc_bert_layer(
        *(t.data_ptr() for t, _, _ in args), *(w.data_ptr() for w in ws), out.data_ptr(),
        b, n, d, f, heads, float(eps), 1.0 / DIM_HEAD ** 0.5, _build.stream_of(x))
    _build.check(err, "bert_layer")
    launches.count("bert_layer")
    return out
