#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ct_clip_ut_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the device: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. the build of csrc/*.cu (one nvcc per source, in parallel), with its
     seconds;
  3. each of the six forward kernels against its plain PyTorch version on the card,
     at the shapes the zero-shot path gives it (2 volumes; 36 prompts of
     512 tokens), with both times, the least time the card could take
     (`bound_ms`) and, for the BERT layer, one PyTorch call computing the
     same function (`library_ms`); each float check also shows that its
     band rejects a plain version that leaves out a norm gain, LN bias, q/k
     scale, the position bias, the LN1 fold's gain or mean correction, the
     key mask or the QKV bias;
  4. the zero-shot slice at flagship width and the default configuration
     (conv patch embed; random weights from a seed): CTClipInference.predict
     over 3 batches of 2 bf16 volumes [2, 1, 240, 480, 480], encoding the 36
     prompts (stand-in tokenizer, padded to 512 tokens) on the way, with
     every kernel's launch count > 0; one prompt encoding timed alone; the
     prompt latents, the patch embed's token grid (against the plain
     embed), the encoder output and one batch's image latents held against
     the plain path; then zeroshot() writes metrics.txt;
  5. each of the five backward kernels of the train step against its plain
     version at the shapes a B = 2 train step gives it (every gradient),
     with both times, `bound_ms` and, for the patch embed's weight grad,
     one PyTorch call computing the same function (`library_ms`); the
     controls are the gradients of a plain backward with one fault (the
     LN gain left out of dx, the softmax row term or the l2-norm
     projection dropped, g missing from dx under the residual, dbias zero,
     GELU for its derivative, wv / cin swapped in the weight grad);
  6. the four kernels of the 512-token train step at the shapes a B = 2
     step gives them: the bf16 BERT layer, deterministic and in train mode
     (dropout 0.1 / 0.1), and its backward (dx and the twelve parameter
     gradients) against their plain versions through the same Philox masks,
     the masks themselves bit for bit against the plain generator with
     their keep shares, and nn.TransformerEncoderLayer as the library call;
     the PEG stencil (causal, and the backward's flipped form) and its
     weight gradient against their plain versions, with the default
     route's copy + F.conv3d + copy and torch.nn.grad.conv3d_weight as the
     library calls; each with the controls a faulty kernel would give;
  7. the earlier train path (120-token reports, the PEG on F.conv3d): two
     steps of make_train_step and one evaluation, its kernels' launch
     counters > 0 and the new kernels' at 0;
  8. the train path as users run it, at flagship width, B = 2, 512-token
     reports, peg_pallas=True: one step's gradients held against the same
     step on the plain path from the same generator state (relative rms
     per parameter group, with the gradients of another batch as the
     control), then CTClipTrainer.train() over three steps (the step-0
     evaluation and a checkpoint included) with every train-path launch
     counter > 0, finite losses, the VQ cluster sizes grown by
     b t h w (1 - decay^3), and the time of three more steps.
The line before the last is the kernels' JSON record (launches: the
zero-shot run's counts for the forward kernels, phase 8's for the train
kernels); the last line is {"ok": true, "device": {...}}. Any failed phase
exits non-zero before it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

# Read on an H100 80GB HBM3 at 700 W: the bf16 kernels' branches within
# 3.3e-3 to 5.4e-3 of their plain versions, the fault controls 0.038 to 0.94;
# the fp32 BERT layer within 5.5e-7 (controls 0.020 to 0.44) and the prompt
# latents within 6e-8 (1 - cos; control 0.19).
FLOAT_BAND = 1.5e-2      # max relative error of a bf16 kernel's branch vs its plain version
VQ_AGREE = 0.999         # least share of equal VQ indices
VQ_TIE = 1e-3            # a mismatch must be a near-tie: fp32 sims within this
# The end-to-end bands sit between the same card's readings (encoder 1.2e-2: bf16
# flips from fp32 sums in another order, over 8 layers; latents 8.6e-3: 2.3%
# of VQ indices flip at near-ties) and the controls (1.0 and 0.8), see PERF.md.
ENCODER_BAND = 3e-2      # relative rms of the CT-ViT encoder output vs the plain path
LATENT_BAND = 3e-2       # 1 - cosine of batch 0's image latents vs the plain path
PROMPT_BAND = 1e-4       # 1 - cosine of the fp32 prompt latents vs the plain path
BERT_BAND = 1e-4         # max relative error of the fp32 BERT layer vs its plain version
# Train-path gradients vs the plain path, relative rms per parameter group.
# Read on an H100 80GB HBM3 at 700 W: the CT-ViT groups 0.028 to 0.040; the
# text tower and the latent projections / temperature 0.16 to 0.17, since
# their gradients are functions of the image latents, which differ from the
# plain path's where bf16 flips VQ indices at near ties (PR 1: 2.7% of
# indices, latents 1 - cos 9e-3); the controls (another batch) 1.30 to 1.58.
GRAD_BAND = 0.1          # the CT-ViT groups
LATENT_GRAD_BAND = 0.5   # the groups downstream of the image latents only
BATCHES, BATCH = 3, 2
TEXT_LEN = 512           # the train slice's reports: the TrainConfig default
EARLIER_TEXT_LEN = 120   # the earlier train path: under the fused BERT layer's gate
# fp32 sums of the same bf16 (or fp32) products in another order
PEG_WGRAD_BAND = 1e-4    # max relative error of the PEG weight and bias gradients
# The bf16 BERT layer's second residual, read from its own workspaces: r2 - y against
# g W2^T + b2 (times the keep mask), relative rms. The output's bf16 rounding hides a
# residual taken from the rounded y; this difference shows it
RESIDUAL_BAND = 1e-4
VOLUME = (1, 240, 480, 480)
PROMPTS, PROMPT_LEN = 36, 512

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its FLOPs over the peak of its operands' type and its bytes (each
# input read once, each output written once) over the memory rate
BF16_PEAK, FP32_PEAK, HBM_RATE = 989e12, 67e12, 3.35e12

KERNELS = {
    "attn_block": ("ct_clip_ut_tpu_torch/csrc/attn_block.cu",
                   "ct_clip_ut_tpu/ops/pallas_attn_block.py:192"),
    "attn_packed": ("ct_clip_ut_tpu_torch/csrc/attn_packed.cu",
                    "ct_clip_ut_tpu/ops/pallas_attn_packed.py:230"),
    "geglu_ff": ("ct_clip_ut_tpu_torch/csrc/geglu_ff.cu",
                 "ct_clip_ut_tpu/ops/pallas_ff.py:120"),
    "vq_nearest": ("ct_clip_ut_tpu_torch/csrc/vq_nearest.cu",
                   "ct_clip_ut_tpu/ops/pallas_vq.py:56"),
    "patch_embed": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                    "ct_clip_ut_tpu/ops/pallas_patch_embed.py:287"),
    "bert_layer": ("ct_clip_ut_tpu_torch/csrc/bert_layer.cu",
                   "ct_clip_ut_tpu/ops/pallas_bert_layer.py:440"),
    "attn_block_bwd": ("ct_clip_ut_tpu_torch/csrc/attn_block_bwd.cu",
                       "ct_clip_ut_tpu/ops/pallas_attn_block.py:407"),
    "attn_packed_bwd": ("ct_clip_ut_tpu_torch/csrc/attn_packed_bwd.cu",
                        "ct_clip_ut_tpu/ops/pallas_attn_packed.py:424"),
    "geglu_ff_bwd": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_bwd.cu",
                     "ct_clip_ut_tpu/ops/pallas_ff.py:234"),
    "patch_embed_res": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                        "ct_clip_ut_tpu/ops/pallas_patch_embed.py:329"),
    "patch_embed_dkw": ("ct_clip_ut_tpu_torch/csrc/patch_embed_dkw.cu",
                        "ct_clip_ut_tpu/ops/pallas_patch_embed.py:381"),
    "bert_layer_bf16": ("ct_clip_ut_tpu_torch/csrc/bert_layer_bf16.cu",
                        "ct_clip_ut_tpu/ops/pallas_bert_layer.py:440"),
    "bert_layer_bwd": ("ct_clip_ut_tpu_torch/csrc/bert_layer_bwd.cu",
                       "ct_clip_ut_tpu/ops/pallas_bert_layer.py:473"),
    "peg": ("ct_clip_ut_tpu_torch/csrc/peg.cu", "ct_clip_ut_tpu/ops/pallas_peg.py:131"),
    "peg_weight_grads": ("ct_clip_ut_tpu_torch/csrc/peg_wgrad.cu",
                         "ct_clip_ut_tpu/ops/pallas_peg_bwd.py:85"),
}
BERT_PEG_KERNELS = ("bert_layer_bf16", "bert_layer_bwd", "peg", "peg_weight_grads")
TRAIN_KERNELS = ("attn_block_bwd", "attn_packed_bwd", "geglu_ff_bwd", "patch_embed_res",
                 "patch_embed_dkw", *BERT_PEG_KERNELS)


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """bound_ms and what sets it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def rel_rms(got, want) -> float:
    """||got - want|| / ||want||."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def around_ones(torch, g, n: int, base: float = 1.0):
    """base + 0.1 N: a norm gain or scale drawn away from the init's ones."""
    return base + 0.1 * torch.randn((n,), generator=g, device="cuda")


def block_args(torch, g, tf) -> list:
    """Layer 0's attention weights of a stack in the block kernels' argument
    order (gamma, wq, wk, wv, wo, q_scale, k_scale), gains drawn by around_ones."""
    a = tf.layers[0][1]
    bf = torch.bfloat16
    wkv = a.to_kv.weight.to(bf)
    inner, d, dh = a.cfg.inner_dim, a.cfg.dim, a.cfg.dim_head
    return [around_ones(torch, g, d), a.to_q.weight.to(bf), wkv[:inner].contiguous(),
            wkv[inner:].contiguous(), a.to_out.weight.to(bf), around_ones(torch, g, dh),
            around_ones(torch, g, dh)]


def kernel_phase(torch, model, card: str) -> dict:
    """Each kernel vs its plain version at the shapes predict() gives it at
    B = BATCH; returns the per-kernel record (without launch counts).

    The float kernels are compared on their branch (residual=False), with
    the norm gains, LN bias and q/k scales drawn as 1 + 0.1 N (beta 0.1 N)
    rather than the init's ones and zeros. Each check also reads its
    controls: the kernel's output against the plain version with one of
    those parameters (or the position bias) left out. A control at or under
    the band means the band cannot tell such a faulty kernel from a right
    one, and fails the phase."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import l2norm
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias
    from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def around(base, n):
        return around_ones(torch, g, n, base)

    def attn_args(tf):
        return block_args(torch, g, tf)

    bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height, cfg.patch_width)
    xs = torch.randn((BATCH * t, hw, d), generator=g, device="cuda").to(bf)
    xt = torch.randn((BATCH * hw, t, d), generator=g, device="cuda").to(bf)
    ff = vit.enc_spatial_transformer.layers[0][3]
    xf = torch.randn((BATCH * t * hw, d), generator=g, device="cuda").to(bf)
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale

    # name: (kernel, plain, args before `residual`, {control: (arg index, neutral value)})
    attn_faults = {"no gamma": (1, 1.0), "no q_scale": (6, 1.0), "no k_scale": (7, 1.0)}
    cases = {
        "attn_block": (attn_block, attn_block_plain,
                       [xs, *attn_args(vit.enc_spatial_transformer), bias, scale],
                       {**attn_faults, "no bias": (8, 0.0)}),
        "attn_packed": (attn_packed, attn_packed_plain,
                        [xt, *attn_args(vit.enc_temporal_transformer), scale], attn_faults),
        "geglu_ff": (geglu_ff, geglu_ff_plain,
                     [xf, around(1.0, d), 0.1 * torch.randn((d,), generator=g, device="cuda"),
                      ff[1].weight.to(bf), ff[4].weight.to(bf)],
                     {"no gamma": (1, 1.0), "no beta": (2, 0.0)}),
    }
    out = {}
    for name, (kern, plain, args, faults) in cases.items():
        got = kern(*args, residual=False)
        want = plain(*args, residual=False)
        torch.cuda.synchronize()
        controls = {}
        for fault, (i, value) in faults.items():
            wrong = list(args)
            wrong[i] = torch.full_like(args[i], value)
            controls[fault] = rel_err(got, plain(*wrong, residual=False))
        abs_err = band_check(name, got, want, FLOAT_BAND, controls,
                             f"x {list(args[0].shape)}, branch max "
                             f"{want.float().abs().max().item():.3e}")
        ms = cuda_ms(torch, lambda: kern(*args, residual=True))
        plain_ms = cuda_ms(torch, lambda: plain(*args, residual=True))
        print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
        x = args[0]
        m, dm = x.numel() // x.shape[-1], x.shape[-1]
        if name == "geglu_ff":
            flops = 2 * m * dm * args[4].shape[1] * 3
        else:
            r, n, hd = x.shape[0], x.shape[1], args[2].shape[0]
            flops = 2 * m * dm * hd * 4 + 4 * r * n * n * hd
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         **bound(flops, nbytes(*tensors, got), BF16_PEAK), library_ms=None)

    tok = l2norm(torch.randn((BATCH * t * hw, d), generator=g, device="cuda")).to(bf)
    cb = vit.vq.state().embed.to(bf)
    got, want = vq_nearest(tok, cb).long(), vq_nearest_plain(tok, cb).long()
    torch.cuda.synchronize()
    agree = (got == want).float().mean().item()
    bad = (got != want).nonzero().flatten()
    gap = 0.0
    if bad.numel():
        sims = tok[bad].float() @ cb.float().t()
        gap = (sims.gather(1, got[bad, None]) - sims.gather(1, want[bad, None])).abs().max().item()
    ms = cuda_ms(torch, lambda: vq_nearest(tok, cb))
    plain_ms = cuda_ms(torch, lambda: vq_nearest_plain(tok, cb))
    print(f"kernel vq_nearest {list(tok.shape)} x {list(cb.shape)}: {agree:.6f} of indices "
          f"equal (band {VQ_AGREE}), {bad.numel()} mismatches, largest sim gap {gap:.3e} "
          f"(band {VQ_TIE}); {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
    if agree < VQ_AGREE or gap > VQ_TIE:
        raise AssertionError(f"vq_nearest: agreement {agree}, tie gap {gap}")
    out["vq_nearest"] = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms,
                             **bound(2 * tok.shape[0] * cb.shape[0] * tok.shape[1],
                                     nbytes(tok, cb) + 4 * tok.shape[0], BF16_PEAK),
                             library_ms=None)
    out["patch_embed"] = patch_embed_check(torch, model, card, g)
    out["bert_layer"] = bert_layer_check(torch, model, card, g)
    return out


def band_check(name: str, got, want, band: float, controls: dict, line: str) -> float:
    """Print the check's line; raise unless got is within `band` of want
    and every control (the output a faulty kernel would give) lies above
    it. Returns the max abs error."""
    abs_err = (got.float() - want.float()).abs().max().item()
    rel = rel_err(got, want)
    print(f"kernel {name} {line}: max_rel_err {rel:.3e} (band {band}) max_abs_err {abs_err:.3e}; "
          "controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    if not got.float().isfinite().all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not rel <= band:
        raise AssertionError(f"{name}: max relative error {rel} over {band}")
    blind = {k: v for k, v in controls.items() if not v > band}
    if blind:
        raise AssertionError(f"{name}: the band {band} passes faulty kernels {blind}")
    return abs_err


def patch_embed_check(torch, model, card: str, g) -> dict:
    """The patch embed on a [2, 1, 240, 480, 480] bf16 volume, LN1 / LN2
    gains drawn as 1 + 0.1 N and biases as 0.1 N, on the branch output
    (there is no residual). Controls: LN1's gain left out of the fold, no
    mean correction (s1 = 0), LN2's bias left out."""
    import copy

    from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_fused,
                                                      patch_embed_plain)

    cfg = model.visual_transformer.cfg
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = copy.deepcopy(model.visual_transformer.to_patch_emb)
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
        image = torch.randn((BATCH, *VOLUME), generator=g, device="cuda").to(torch.bfloat16)
        kw, s1, b1 = fold_patch_embed(emb, p, tp)
        args = [image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()]
        got = patch_embed_fused(*args, p, tp)
        want = patch_embed_plain(*args, p, tp)
        torch.cuda.synchronize()
        emb[1].weight.fill_(1.0)
        kw0, s10, _ = fold_patch_embed(emb, p, tp)
        faults = {"no LN1 gain": {1: kw0, 2: s10}, "s1 = 0": {2: torch.zeros_like(s1)},
                  "no LN2 beta": {5: torch.zeros_like(args[5])}}
        controls = {}
        for fault, swap in faults.items():
            wrong = [swap.get(i, a) for i, a in enumerate(args)]
            controls[fault] = rel_err(got, patch_embed_plain(*wrong, p, tp))
        ms = cuda_ms(torch, lambda: patch_embed_fused(*args, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_plain(*args, p, tp))
    abs_err = band_check("patch_embed", got, want, FLOAT_BAND, controls,
                         f"{list(image.shape)} -> {list(got.shape)}")
    print(f"kernel patch_embed: {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
    m, dim = got.numel() // got.shape[-1], got.shape[-1]
    k = kw.shape[0] * kw.shape[1]
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(2 * m * k * dim, nbytes(image, got) + 2 * k * dim + 4 * 4 * dim,
                        BF16_PEAK),
                library_ms=None)


def bert_layer_check(torch, model, card: str, g) -> dict:
    """One BERT layer in fp32 on [36, 512, 768], keys padded after 6 to 14
    real tokens per row and two rows at full length, LN gains drawn as
    1 + 0.1 N and biases as 0.1 N. Controls: mask dropped, LN1's gain left
    out, QKV bias left out. library_ms: nn.TransformerEncoderLayer (post-LN,
    exact GELU) in eval mode with the same weights and key padding mask,
    one PyTorch call computing the same function (a yardstick: the port
    never calls it)."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_plain

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    lengths = torch.randint(6, 15, (PROMPTS,), generator=g, device="cuda")
    lengths[3] = lengths[17] = PROMPT_LEN
    pad = torch.arange(PROMPT_LEN, device="cuda")[None, :] >= lengths[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((PROMPTS, PROMPT_LEN, d), generator=g, device="cuda")
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    for i in (4, 10):                                  # LN gains
        w[i] = 1.0 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    for i in (5, 11):                                  # LN biases
        w[i] = 0.1 * torch.randn((d,), generator=g, device="cuda")
    args = [x, mask_row, *w]
    with torch.no_grad():
        got = bert_layer(*args, heads, eps)
        want = bert_layer_plain(*args, heads, eps)
        torch.cuda.synchronize()
        faults = {"no mask": (1, torch.zeros_like(mask_row)), "no LN1 gain": (6, torch.ones_like(w[4])),
                  "no QKV bias": (3, torch.zeros_like(w[1]))}
        controls = {}
        for fault, (i, value) in faults.items():
            wrong = list(args)
            wrong[i] = value
            controls[fault] = rel_err(got, bert_layer_plain(*wrong, heads, eps))
        ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps))
        plain_ms = cuda_ms(torch, lambda: bert_layer_plain(*args, heads, eps))

        lib = torch.nn.TransformerEncoderLayer(d, heads, w[6].shape[0], dropout=0.0,
                                               activation="gelu", batch_first=True,
                                               norm_first=False, layer_norm_eps=eps,
                                               device="cuda").eval()
        sd = dict(zip(["self_attn.in_proj_weight", "self_attn.in_proj_bias",
                       "self_attn.out_proj.weight", "self_attn.out_proj.bias", "norm1.weight",
                       "norm1.bias", "linear1.weight", "linear1.bias", "linear2.weight",
                       "linear2.bias", "norm2.weight", "norm2.bias"], w))
        lib.load_state_dict(sd, strict=True)
        lib_out = lib(x, src_key_padding_mask=pad)
        keep = ~pad
        lib_err = rel_err(lib_out[keep], want[keep])
        library_ms = cuda_ms(torch, lambda: lib(x, src_key_padding_mask=pad))
    abs_err = band_check("bert_layer", got, want, BERT_BAND, controls,
                         f"fp32 {list(x.shape)}, {int(keep.sum())} real tokens")
    print(f"kernel bert_layer: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
          f"nn.TransformerEncoderLayer {library_ms:.3f} ms (its real rows vs the plain "
          f"version: max_rel_err {lib_err:.3e}) [{card}]")
    b, n, f = PROMPTS, PROMPT_LEN, w[6].shape[0]
    flops = 2 * b * n * d * (3 * d + d + 2 * f) + 4 * b * n * n * d
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(flops, nbytes(x, mask_row, *w, got), FP32_PEAK), library_ms=library_ms)


def slice_phase(torch, model, card: str) -> dict:
    """The zero-shot path through CTClipInference.predict; returns launch counts."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.infer.zeroshot import (CTClipInference, WordTokenizer,
                                                     encode_prompt_latents, tokenize_prompts,
                                                     zeroshot_probs)
    from ct_clip_ut_tpu_torch.models.ctclip import encode_image_latents, encode_text_latents
    from ct_clip_ut_tpu_torch.models.ctvit import (_patch_embed, _patch_embed_conv,
                                                   ctvit_encode, patchify, token_grid_shape)
    from ct_clip_ut_tpu_torch.ops import launches

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = tokenize_prompts(WordTokenizer(cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    real = prompts["attention_mask"].sum(1)
    rng = np.random.default_rng(1)
    data = [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
             None, rng.integers(0, 2, (BATCH, 18))) for _ in range(BATCHES)]
    latents = encode_prompt_latents(model, prompts)                # warm-up
    zeroshot_probs(model, data[0][0], latents)
    torch.cuda.synchronize()

    runner = CTClipInference(model, prompts, data)
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    preds, targets = runner.predict()
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"slice: CTClipInference.predict {BATCHES} x {BATCH} volumes with one encoding of "
          f"{PROMPTS} prompts x {PROMPT_LEN} tokens ({int(real.min())} to {int(real.max())} real) "
          f"in {seconds:.3f} s (smoke reading, host clock) [{card}]; launches {json.dumps(counts)}")
    if preds.shape != (BATCHES * BATCH, 18) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    if not ((preds >= 0) & (preds <= 1)).all():
        raise AssertionError("probabilities outside [0, 1]")
    missing = [k for k, v in counts.items() if v <= 0 and k not in TRAIN_KERNELS]
    if missing:
        raise AssertionError(f"kernels not launched on the zero-shot path: {missing}")

    # one prompt encoding alone (12 bert_layer chains), then its latents
    # against the plain path; the control drops the attention mask
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = CTClipInference(model, prompts, []).prompt_latents()
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.perf_counter() - t0)
    text_counts = launches.launch_counts()
    with torch.no_grad():
        text_plain = encode_text_latents(model, prompts, plain=True)
        text_nomask = encode_text_latents(model, {**prompts, "attention_mask":
                                                  torch.ones_like(prompts["attention_mask"])},
                                          plain=True)
    cos = torch.nn.functional.cosine_similarity
    text_err = (1.0 - cos(text, text_plain, dim=-1)).max().item()
    text_control = (1.0 - cos(text_nomask, text_plain, dim=-1)).min().item()
    print(f"slice: CTClipInference.prompt_latents() {prompt_ms:.3f} ms (host clock, "
          f"synchronised) [{card}]; launches {json.dumps(text_counts)}; prompt latents vs the "
          f"plain path: 1 - cos {text_err:.3e} (band {PROMPT_BAND}); control (mask dropped) "
          f"1 - cos >= {text_control:.3e}")
    if text_counts["bert_layer"] != cfg.bert.num_layers:
        raise AssertionError(f"prompt encoding launched bert_layer {text_counts['bert_layer']} "
                             f"times, not {cfg.bert.num_layers}")
    if not text_err <= PROMPT_BAND < text_control:
        raise AssertionError(f"prompt latents: 1 - cos {text_err}, band {PROMPT_BAND}, "
                             f"control {text_control}")

    # the patch embed's token grid against the plain embed (PR 1's path) on
    # the same volume; the encoder (spatial + temporal stacks, every float
    # kernel) on N(0, 1) tokens; batch 0's image latents, kernel path vs
    # plain path. The controls are the distances between the batch's two
    # volumes (the signal).
    vit = model.visual_transformer
    vcfg = vit.cfg
    t, h, w = token_grid_shape(vcfg, VOLUME)
    tokens = torch.randn((BATCH, t, h, w, vcfg.dim), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    with torch.no_grad():
        vol = data[0][0]
        grid = _patch_embed_conv(vit, vol).float()
        grid_plain = _patch_embed(vit.to_patch_emb, patchify(vol, vcfg.patch_size,
                                                             vcfg.temporal_patch_size)).float()
        enc = ctvit_encode(vit, tokens)[0].float()
        enc_plain = ctvit_encode(vit, tokens, plain=True)[0].float()
        enc_fp32 = ctvit_encode(vit, tokens.float(), plain=True)[0]
        lat, out = encode_image_latents(model, vol)
        lat_plain, out_plain = encode_image_latents(model, vol, plain=True)
    lat, lat_plain = lat.float(), lat_plain.float()
    if not all(torch.isfinite(v).all() for v in (grid, enc, lat)):
        raise AssertionError("non-finite token grid, encoder output or image latents")
    if lat.shape != (BATCH, cfg.dim_latent):
        raise AssertionError(f"bad image latents: shape {tuple(lat.shape)}")
    grid_err = rel_rms(grid, grid_plain)
    grid_control = rel_rms(grid_plain[1], grid_plain[0])
    enc_err = rel_rms(enc, enc_plain)
    enc_control = rel_rms(enc_plain[1], enc_plain[0])
    lat_err = (1.0 - cos(lat, lat_plain, dim=-1)).max().item()
    lat_control = (1.0 - cos(lat_plain[0], lat_plain[1], dim=-1)).item()
    same_ids = (out.codebook_ids == out_plain.codebook_ids).float().mean().item()
    print(f"slice: patch_embed token grid vs the plain embed (patch_embed_conv=False): relative "
          f"rms {grid_err:.3e} (band {ENCODER_BAND}), max_rel_err {rel_err(grid, grid_plain):.3e};"
          f" control (volume 0 vs 1) {grid_control:.3e}")
    print(f"slice: encoder output vs the plain path: relative rms {enc_err:.3e} (band "
          f"{ENCODER_BAND}), max_rel_err {rel_err(enc, enc_plain):.3e}; control (volume 0 vs 1) "
          f"{enc_control:.3e}; the plain path in bf16 vs in fp32: relative rms "
          f"{rel_rms(enc_plain, enc_fp32):.3e}")
    print(f"slice: batch 0 image latents vs the plain path: 1 - cos {lat_err:.3e} (band "
          f"{LATENT_BAND}), max abs diff {(lat - lat_plain).abs().max().item():.3e}, "
          f"{same_ids:.6f} of VQ indices equal; control (volume 0 vs 1) 1 - cos "
          f"{lat_control:.3e}; probabilities in [{preds.min():.4f}, {preds.max():.4f}]")
    if not grid_err <= ENCODER_BAND < grid_control:
        raise AssertionError(f"token grid: relative rms {grid_err}, band {ENCODER_BAND}, "
                             f"control {grid_control}")
    if not enc_err <= ENCODER_BAND < enc_control:
        raise AssertionError(f"encoder output: relative rms {enc_err}, band {ENCODER_BAND}, "
                             f"control {enc_control}")
    if not lat_err <= LATENT_BAND < lat_control:
        raise AssertionError(f"image latents: 1 - cos {lat_err}, band {LATENT_BAND}, "
                             f"control {lat_control}")

    # the metrics, with numpy alone (the card's machine has no scikit-learn)
    with tempfile.TemporaryDirectory() as tmp:
        runner.results_folder = Path(tmp)
        m, _, _ = runner.zeroshot()
        report = (Path(tmp) / "metrics.txt").read_text()
    if not report.startswith("Epoch 0 Metrics:") or "+=" not in report:
        raise AssertionError("zeroshot() wrote no metrics table")
    print(f"slice: zeroshot() wrote metrics.txt ({len(report.splitlines())} lines): label "
          f"accuracy {m['label_accuracy']:.4f}, mean ROC-AUC {m['mean_roc_auc']:.4f}")
    return counts


def grads_check(name: str, got: dict, want: dict, band: float, faulty: dict, line: str) -> float:
    """Every gradient of a backward kernel within `band` (max relative
    error) of its plain version; each control (the gradients a kernel with
    one fault would give) must differ from the kernel's by more than the
    band in at least one gradient. Returns the largest abs error."""
    errs = {k: rel_err(got[k], want[k]) for k in want}
    # a control's distance is taken relative to the right gradient's maximum
    controls = {f: max(((got[k].float() - v[k].float()).abs().max()
                        / want[k].float().abs().max()).item() for k in v)
                for f, v in faulty.items()}
    abs_err = max((got[k].float() - want[k].float()).abs().max().item() for k in want)
    print(f"kernel {name} {line}: max_rel_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (band {band}); controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    if not all(got[k].float().isfinite().all() for k in got):
        raise AssertionError(f"{name}: non-finite gradients")
    bad = {k: v for k, v in errs.items() if not v <= band}
    if bad:
        raise AssertionError(f"{name}: gradients over the band {band}: {bad}")
    blind = {k: v for k, v in controls.items() if not v > band}
    if blind:
        raise AssertionError(f"{name}: the band {band} passes faulty kernels {blind}")
    return abs_err


def backward_phase(torch, model, card: str) -> dict:
    """The five backward kernels of the train step against their plain
    versions at the shapes a B = BATCH train step gives them; returns the
    per-kernel record (without launch counts). The attention and FF checks
    run on the branch (residual=False) with the math-fault controls, then
    with the residual, whose control leaves g out of dx."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd, attn_block_bwd_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd, attn_packed_bwd_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_plain
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    attn_names = ("dx", "dgamma", "dwq", "dwk", "dwv", "dwo", "dqs", "dks", "dbias")
    ff_names = ("dx", "dgamma", "dbeta", "dw_in", "dw_out")
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale
    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height, cfg.patch_width)
    ff = vit.enc_spatial_transformer.layers[0][3]
    attn_faults = {"no LN gain in dx": "gamma", "softmax row term dropped": "row_term",
                   "l2-norm projection dropped": "l2norm"}
    # name: (kernel, plain, args before g, names, {control: fault})
    cases = {
        "attn_block_bwd": (attn_block_bwd, attn_block_bwd_plain,
                           [randn(BATCH * t, hw, d),
                            *block_args(torch, g, vit.enc_spatial_transformer), bias],
                           attn_names, attn_faults),
        "attn_packed_bwd": (attn_packed_bwd, attn_packed_bwd_plain,
                            [randn(BATCH * hw, t, d),
                             *block_args(torch, g, vit.enc_temporal_transformer)],
                            attn_names[:8], attn_faults),
        "geglu_ff_bwd": (geglu_ff_bwd, geglu_ff_bwd_plain,
                         [randn(BATCH * t * hw, d), around_ones(torch, g, d),
                          0.1 * torch.randn((d,), generator=g, device="cuda"),
                          ff[1].weight.to(bf), ff[4].weight.to(bf)],
                         ff_names, {"no LN gain in dx": "gamma", "GELU for GELU'": "gelu_prime"}),
    }
    out = {}
    for name, (kern, plain, args, names, faults) in cases.items():
        gr = randn(*args[0].shape)
        extra = (scale,) if name.startswith("attn") else ()
        got = dict(zip(names, kern(*args, gr, *extra, False)))
        want = dict(zip(names, plain(*args, gr, *extra, False)))
        torch.cuda.synchronize()
        faulty = {f: dict(zip(names, plain(*args, gr, *extra, False, faults=(fault,))))
                  for f, fault in faults.items()}
        if "dbias" in want:
            faulty["dbias zero"] = {"dbias": torch.zeros_like(want["dbias"])}
        abs_err = grads_check(name, got, want, FLOAT_BAND, faulty,
                              f"x {list(args[0].shape)} (branch)")
        got = dict(zip(names, kern(*args, gr, *extra, True)))
        want = dict(zip(names, plain(*args, gr, *extra, True)))
        no_g = {"g missing from dx": {"dx": plain(*args, gr, *extra, False)[0]}}
        grads_check(name, got, want, FLOAT_BAND, no_g, "(residual)")
        ms = cuda_ms(torch, lambda: kern(*args, gr, *extra, True))
        plain_ms = cuda_ms(torch, lambda: plain(*args, gr, *extra, True))
        print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
        x = args[0]
        m = x.numel() // d
        grads = [v for v in got.values() if v is not None]
        if name == "geglu_ff_bwd":
            flops = 2 * 8 * m * d * args[4].shape[1]
        else:
            r, n, hd = x.shape[0], x.shape[1], args[2].shape[0]
            heads = hd // 32
            flops = 2 * r * (9 * n * d * hd + heads * 6 * n * n * 32)
        tensors = [a for a in args if isinstance(a, torch.Tensor)] + [gr]
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         **bound(flops, nbytes(*tensors, *grads), BF16_PEAK), library_ms=None)
    out.update(patch_embed_train_check(torch, model, card, g))
    return out


def patch_embed_train_check(torch, model, card: str, g) -> dict:
    """The residual-saving patch embed (out, the fp32 product, the LN1
    moments) and the projection weight grad on a [2, 1, 240, 480, 480] bf16
    volume. Controls: LN1's gain left out of the fold (the saved product
    and output change), LN2's bias left out; the weight grad with wv / cin
    swapped, and with the second volume's patches left out. library_ms of
    the weight grad: torch.nn.grad.conv3d_weight on the same volume and
    cotangent (laid out as [b, dim, t, hp, wp] outside the timed call)."""
    import copy

    from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_dkw,
                                                      patch_embed_dkw_plain, patch_embed_res,
                                                      patch_embed_res_plain)

    cfg = model.visual_transformer.cfg
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = copy.deepcopy(model.visual_transformer.to_patch_emb)
    out = {}
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
        image = torch.randn((BATCH, *VOLUME), generator=g, device="cuda").to(torch.bfloat16)
        kw, s1, b1 = fold_patch_embed(emb, p, tp)
        args = [image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()]
        names = ("out", "conv", "stats")
        got = dict(zip(names, patch_embed_res(*args, p, tp)))
        want = dict(zip(names, patch_embed_res_plain(*args, p, tp)))
        torch.cuda.synchronize()
        emb[1].weight.fill_(1.0)
        kw0, s10, _ = fold_patch_embed(emb, p, tp)
        faulty = {"no LN1 gain": dict(zip(names, patch_embed_res_plain(image, kw0, s10, *args[3:],
                                                                       p, tp))),
                  "no LN2 beta": {"out": patch_embed_res_plain(
                      *args[:5], torch.zeros_like(args[5]), p, tp)[0]}}
        abs_err = grads_check("patch_embed_res", got, want, FLOAT_BAND, faulty,
                              f"{list(image.shape)} -> out, conv {list(got['conv'].shape)}, stats")
        ms = cuda_ms(torch, lambda: patch_embed_res(*args, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_res_plain(*args, p, tp))
        print(f"kernel patch_embed_res: {ms:.3f} ms vs plain {plain_ms:.3f} ms [{card}]")
        m, dim = got["conv"].shape
        k = kw.shape[0] * kw.shape[1]
        out["patch_embed_res"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * m * k * dim, nbytes(image, *args[1:], *got.values()), BF16_PEAK),
            library_ms=None)

        dconv = torch.randn((m, dim), generator=g, device="cuda").to(torch.bfloat16)
        got = patch_embed_dkw(image, dconv, p, tp)
        want = patch_embed_dkw_plain(image, dconv, p, tp)
        torch.cuda.synchronize()
        half = dconv.clone()
        half[m // BATCH:] = 0
        faulty = {"wv/cin swapped": {"dkw": want.permute(1, 0, 2).reshape(want.shape)},
                  "one volume only": {"dkw": patch_embed_dkw_plain(image, half, p, tp)}}
        abs_err = grads_check("patch_embed_dkw", {"dkw": got}, {"dkw": want}, FLOAT_BAND, faulty,
                              f"{list(image.shape)}, dconv {list(dconv.shape)} -> "
                              f"{list(got.shape)}")
        ms = cuda_ms(torch, lambda: patch_embed_dkw(image, dconv, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_dkw_plain(image, dconv, p, tp))
        b, _, T, H, W = image.shape
        go = dconv.reshape(b, T // tp, H // p, W // p, dim).permute(0, 4, 1, 2, 3).contiguous()
        lib = torch.nn.grad.conv3d_weight(image, (dim, 1, tp, p, p), go, stride=(tp, p, p))
        lib_err = rel_err(lib.reshape(dim, k // p, p).permute(2, 1, 0), want)
        library_ms = cuda_ms(torch, lambda: torch.nn.grad.conv3d_weight(
            image, (dim, 1, tp, p, p), go, stride=(tp, p, p)))
        print(f"kernel patch_embed_dkw: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms (vs the plain version: "
              f"max_rel_err {lib_err:.3e}) [{card}]")
        out["patch_embed_dkw"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * m * k * dim, nbytes(image, dconv, got), BF16_PEAK), library_ms=library_ms)
    return out


def bert_train_check(torch, model, card: str) -> dict:
    """The bf16 BERT layer and its backward at the shapes of a B = 2,
    512-token train step: [2, 512, 768], one row padded after 300 tokens,
    LN gains drawn as 1 + 0.1 N and biases as 0.1 N, fp32 weights as the
    model holds them.

    Forward, deterministic and in train mode (p = 0.1 / 0.1), against
    bert_layer_plain through the same Philox masks. Controls: the masks of
    other seeds, the key mask dropped, LN1's gain left out; and, on the
    second residual read from the chain's own fp32 workspaces (the output's
    bf16 rounding hides it), the FF residual taken from the rounded y. The masks themselves: the kernels' generator
    bit for bit against the plain one per site, the keep share within 4
    sigma of 1 - p, two calls equal, another seed different.

    Backward: dx and the twelve parameter gradients against autograd of the
    plain forward through the same masks. Controls (a plain backward with
    one fault): masks from other seeds, the attention keep mask left out of
    dp, the post-FF keep mask left out, p_used in place of p in ds.

    library_ms: nn.TransformerEncoderLayer (bf16, post-LN, exact GELU,
    dropout 0) with the same weights, its forward in eval mode, and forward
    + backward in train mode: yardsticks the port never calls."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import (SITES, bert_layer, bert_layer_bwd,
                                                     bert_layer_bwd_plain, bert_layer_plain,
                                                     keep_mask, philox_keep)

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    pa, ph = bcfg.attention_dropout, bcfg.hidden_dropout
    b, n = BATCH, TEXT_LEN
    g = torch.Generator(device="cuda").manual_seed(13)
    bf = torch.bfloat16
    pad = torch.arange(n, device="cuda")[None, :] >= torch.tensor([n, 300], device="cuda")[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((b, n, d), generator=g, device="cuda").to(bf)
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    for i in (4, 10):                                  # LN gains
        w[i] = around_ones(torch, g, d)
    for i in (5, 11):                                  # LN biases
        w[i] = 0.1 * torch.randn((d,), generator=g, device="cuda")
    f = w[6].shape[0]
    seeds = torch.tensor([20231, 77, 1 << 30], dtype=torch.int32, device="cuda")
    args = [x, mask_row, *w]
    train = dict(p_attn=pa, p_hidden=ph, train=True, seeds=seeds)
    other = {**train, "seeds": seeds + 1}
    out = {}

    with torch.no_grad():
        # the masks
        for site, name in enumerate(SITES):
            hh, inner, rate = (heads, n * n, pa) if site == 0 else (1, n * d, ph)
            got = keep_mask(seeds, site, b, hh, inner, rate)
            share = (got > 0).float().mean().item()
            sigma = (rate * (1 - rate) / got.numel()) ** 0.5
            same = torch.equal(got, philox_keep(seeds, site, b, hh, inner, rate))
            again = torch.equal(got, keep_mask(seeds, site, b, hh, inner, rate))
            moved = (got != keep_mask(seeds + 1, site, b, hh, inner, rate)).float().mean().item()
            print(f"kernel bert_layer_bf16 dropout site {name} [{b}, {hh}, {inner}] at p = {rate}: "
                  f"kernel bits == plain Philox4x32-10 bits: {same}; two calls equal: {again}; "
                  f"keep share {share:.6f} (1 - p = {1 - rate}, 4 sigma = {4 * sigma:.2e}); another "
                  f"seed changes {moved:.4f} of the mask")
            if not (same and again and abs(share - (1 - rate)) <= 4 * sigma and moved > rate):
                raise AssertionError(f"dropout site {name}: mask check failed")

        # the forward
        faults = {"no mask": (1, torch.zeros_like(mask_row)),
                  "no LN1 gain": (6, torch.ones_like(w[4]))}
        for label, kw in (("deterministic", {}), ("train", train)):
            parts, plain_parts = {}, {}
            got = bert_layer(*args, heads, eps, **kw, parts=parts)
            want = bert_layer_plain(*args, heads, eps, **kw, parts=plain_parts)
            torch.cuda.synchronize()
            controls = {}
            if kw:
                controls["other seeds"] = rel_err(got, bert_layer_plain(*args, heads, eps, **other))
            for fault, (i, value) in faults.items():
                wrong = list(args)
                wrong[i] = value
                controls[fault] = rel_err(got, bert_layer_plain(*wrong, heads, eps, **kw))
            abs_err = band_check("bert_layer_bf16", got, want, FLOAT_BAND, controls,
                                 f"{label} bf16 {list(x.shape)}")
            o2 = parts["g"].float() @ w[8].to(bf).float().t() + w[9]
            if kw:
                o2 = o2 * philox_keep(seeds, 2, b, 1, n * d, ph).reshape(b, n, d)
            y = parts["y"]
            r2_err = rel_rms(parts["r2"] - y, o2)
            r2_control = rel_rms(parts["r2"] - y + y.to(bf).float() - y, o2)
            print(f"kernel bert_layer_bf16 {label}: its second residual r2 - y vs g W2^T + b2"
                  f"{' (x keep)' if kw else ''} from its own workspaces: relative rms {r2_err:.3e} "
                  f"(band {RESIDUAL_BAND}); control (the residual taken from the rounded y) "
                  f"{r2_control:.3e}; r2 vs the plain version's {rel_rms(parts['r2'], plain_parts['r2']):.3e}")
            if not r2_err <= RESIDUAL_BAND < r2_control:
                raise AssertionError(f"bert_layer_bf16 {label}: second residual {r2_err}, band "
                                     f"{RESIDUAL_BAND}, control {r2_control}")
        if not torch.equal(got, bert_layer(*args, heads, eps, **train)):
            raise AssertionError("bert_layer_bf16: two train-mode calls with the same seeds differ")
        ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps, **train))
        det_ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps))
        plain_ms = cuda_ms(torch, lambda: bert_layer_plain(*args, heads, eps, **train))

    lib = torch.nn.TransformerEncoderLayer(d, heads, f, dropout=0.0, activation="gelu",
                                           batch_first=True, norm_first=False,
                                           layer_norm_eps=eps, device="cuda")
    lib.load_state_dict(dict(zip(
        ["self_attn.in_proj_weight", "self_attn.in_proj_bias", "self_attn.out_proj.weight",
         "self_attn.out_proj.bias", "norm1.weight", "norm1.bias", "linear1.weight",
         "linear1.bias", "linear2.weight", "linear2.bias", "norm2.weight", "norm2.bias"], w)),
        strict=True)
    lib = lib.to(bf)
    with torch.no_grad():
        lib.eval()
        lib_out = lib(x, src_key_padding_mask=pad)
        det = bert_layer_plain(*args, heads, eps)
        lib_err = rel_err(lib_out[~pad], det[~pad])
        library_ms = cuda_ms(torch, lambda: lib(x, src_key_padding_mask=pad))
    print(f"kernel bert_layer_bf16: train {ms:.3f} ms, deterministic {det_ms:.3f} ms vs plain "
          f"(train) {plain_ms:.3f} ms, nn.TransformerEncoderLayer (bf16, eval) {library_ms:.3f} ms "
          f"(its real rows vs the plain version: max_rel_err {lib_err:.3e}) [{card}]")
    flops = 2 * b * n * d * (3 * d + d + 2 * f) + 4 * b * heads * n * n * (d // heads)
    wbytes = 2 * (4 * d * d + 2 * d * f) + 4 * (3 * d + d + f + 5 * d)     # bf16 matrices, fp32 vectors
    out["bert_layer_bf16"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes(x, mask_row, seeds, got) + wbytes, BF16_PEAK), library_ms=library_ms)

    # the backward
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "dbe1", "dw1", "db1", "dw2", "db2",
             "dg2", "dbe2")
    dout = torch.randn((b, n, d), generator=g, device="cuda").to(bf)
    for label, kw in (("deterministic", {}), ("train", train)):
        got = dict(zip(names, bert_layer_bwd(*args, dout, heads, eps, **kw)))
        leaves = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True) for t in w]
        bert_layer_plain(leaves[0], mask_row, *leaves[1:], heads, eps, **kw).backward(dout)
        want = dict(zip(names, (t.grad for t in leaves)))
        torch.cuda.synchronize()
        faulty = {}
        if kw:
            with torch.no_grad():
                cases = {"masks from other seeds": dict(kw=other),
                         "attention keep mask left out of dp": dict(faults=("no_attn_keep",)),
                         "post-FF keep mask left out": dict(faults=("no_hidden_keep",)),
                         "p_used for p in ds": dict(faults=("p_used_in_ds",))}
                for fault, c in cases.items():
                    faulty[fault] = dict(zip(names, bert_layer_bwd_plain(
                        *args, dout, heads, eps, **c.get("kw", kw), faults=c.get("faults", ()))))
        else:
            faulty["mask dropped"] = dict(zip(names, bert_layer_bwd_plain(
                x, torch.zeros_like(mask_row), *w, dout, heads, eps)))
        abs_err = grads_check("bert_layer_bwd", got, want, FLOAT_BAND, faulty,
                              f"{label} bf16 {list(x.shape)} vs autograd of the plain forward")
    with torch.no_grad():
        ms = cuda_ms(torch, lambda: bert_layer_bwd(*args, dout, heads, eps, **train))
        plain_ms = cuda_ms(torch, lambda: bert_layer_bwd_plain(*args, dout, heads, eps, **train))
    lib.train()
    xl = x.clone().requires_grad_(True)

    def lib_step():
        lib.zero_grad(set_to_none=True)
        xl.grad = None
        lib(xl, src_key_padding_mask=pad).backward(dout)

    library_ms = cuda_ms(torch, lib_step)
    print(f"kernel bert_layer_bwd: {ms:.3f} ms (the forward recomputed inside) vs plain "
          f"{plain_ms:.3f} ms, nn.TransformerEncoderLayer forward + backward (bf16, dropout 0) "
          f"{library_ms:.3f} ms [{card}]")
    flops = 6 * b * n * d * (3 * d + d + 2 * f) + 12 * b * heads * n * n * (d // heads)
    out["bert_layer_bwd"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes(x, mask_row, seeds, dout, *got.values()) + wbytes, BF16_PEAK),
        library_ms=library_ms)
    return out


def peg_check(torch, model, card: str) -> dict:
    """The PEG stencil and its weight gradient on the token video of a B = 2
    step, [2, 24, 24, 24, 512] bf16, with layer 0's Conv3d taps and a bias
    drawn as 0.2 N. The stencil on its branch (output minus residual), in
    the causal forward form (front padding 2, bias) and the input
    gradient's form (front padding 0, flipped taps, no bias). Controls: the
    frame padding (1, 1) for (2, 0), the bias left out; the taps unflipped
    in the backward form. The weight gradient's controls: x shifted by one
    frame, the non-causal padding. library_ms: what the default route runs,
    the NCDHW copy + F.conv3d + bias + residual + copy back (peg_residual),
    and torch.nn.grad.conv3d_weight on NCDHW copies made outside the timed
    call."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import peg_residual
    from ct_clip_ut_tpu_torch.ops.peg import (peg, peg_plain, peg_weight_grads,
                                              peg_weight_grads_plain, taps_of)

    vit = model.visual_transformer
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    c = vit.cfg.dim
    g = torch.Generator(device="cuda").manual_seed(17)
    bf = torch.bfloat16
    x = torch.randn((BATCH, t, h, w, c), generator=g, device="cuda").to(bf)
    gr = torch.randn((BATCH, t, h, w, c), generator=g, device="cuda").to(bf)
    weight = vit.enc_spatial_transformer.layers[0][0].dsconv.weight.detach()
    taps = taps_of(weight)
    flipped = taps.flip(0).contiguous()
    bias = 0.2 * torch.randn((c,), generator=g, device="cuda")
    out = {}
    with torch.no_grad():
        def branch(y, base):
            return y.float() - base.float()

        got = branch(peg(x, taps, bias, 2), x)
        want = branch(peg_plain(x, taps, bias, 2), x)
        torch.cuda.synchronize()
        controls = {"frame padding (1, 1)": rel_err(got, branch(peg_plain(x, taps, bias, 1), x)),
                    "no bias": rel_err(got, branch(peg_plain(x, taps, None, 2), x))}
        abs_err = band_check("peg", got, want, FLOAT_BAND, controls,
                             f"causal forward {list(x.shape)} bf16, branch max "
                             f"{want.abs().max().item():.3e}")
        got = branch(peg(gr, flipped, None, 0), gr)
        want = branch(peg_plain(gr, flipped, None, 0), gr)
        controls = {"taps unflipped": rel_err(got, branch(peg_plain(gr, taps, None, 0), gr)),
                    "frame padding (2, 0)": rel_err(got, branch(peg_plain(gr, flipped, None, 2), gr))}
        abs_err = max(abs_err, band_check("peg", got, want, FLOAT_BAND, controls,
                                          "input-gradient form (front 0, flipped taps, no bias)"))
        tokens = x.reshape(BATCH, t * h * w, c)
        lib_err = rel_err(peg_residual(weight, bias, tokens, (BATCH, t, h, w), True),
                          peg_plain(x, taps, bias, 2).reshape(tokens.shape))
        ms = cuda_ms(torch, lambda: peg(x, taps, bias, 2))
        plain_ms = cuda_ms(torch, lambda: peg_plain(x, taps, bias, 2))
        library_ms = cuda_ms(torch, lambda: peg_residual(weight, bias, tokens,
                                                         (BATCH, t, h, w), True))
        print(f"kernel peg: {ms:.3f} ms vs plain {plain_ms:.3f} ms, the default route (NCDHW copy "
              f"+ F.conv3d + copy back) {library_ms:.3f} ms (vs the plain version, with its "
              f"residual: max_rel_err {lib_err:.3e}) [{card}]")
        npos = x.numel() // c
        out["peg"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          **bound(2 * 27 * npos * c, nbytes(x, taps, bias, x), FP32_PEAK),
                          library_ms=library_ms)

        names = ("dw", "db")
        got = dict(zip(names, peg_weight_grads(x, gr, 2)))
        want = dict(zip(names, peg_weight_grads_plain(x, gr, 2)))
        torch.cuda.synchronize()
        again = peg_weight_grads(x, gr, 2)
        if not (torch.equal(got["dw"], again[0]) and torch.equal(got["db"], again[1])):
            raise AssertionError("peg_weight_grads: two calls on the same inputs differ")
        faulty = {"x shifted by one frame": {"dw": peg_weight_grads_plain(x.roll(1, 1), gr, 2)[0]},
                  "frame padding (1, 1)": {"dw": peg_weight_grads_plain(x, gr, 1)[0]}}
        abs_err = grads_check("peg_weight_grads", got, want, PEG_WGRAD_BAND, faulty,
                              f"{list(x.shape)} bf16 -> dw {list(got['dw'].shape)}, db (fp32 sums; "
                              "two calls bit-equal)")
        ms = cuda_ms(torch, lambda: peg_weight_grads(x, gr, 2))
        plain_ms = cuda_ms(torch, lambda: peg_weight_grads_plain(x, gr, 2))
        xc = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 2, 0)).contiguous()
        gc = gr.permute(0, 4, 1, 2, 3).contiguous()
        lib = torch.nn.grad.conv3d_weight(xc, (c, 1, 3, 3, 3), gc, groups=c)
        lib_err = rel_err(lib, want["dw"])
        library_ms = cuda_ms(torch, lambda: torch.nn.grad.conv3d_weight(xc, (c, 1, 3, 3, 3), gc,
                                                                         groups=c))
        print(f"kernel peg_weight_grads: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms (vs the plain version: max_rel_err "
              f"{lib_err:.3e}) [{card}]")
        out["peg_weight_grads"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * 28 * npos * c, nbytes(x, gr, *got.values()), FP32_PEAK),
            library_ms=library_ms)
    return out


def param_group(name: str) -> str:
    """The parameter group of a CTCLIP parameter, for the gradient check."""
    import re

    if name.startswith("text_transformer"):
        return "text tower"
    if "to_patch_emb" in name:
        return "patch embed"
    if "spatial_rel_pos_bias" in name:
        return "CPB MLP"
    hit = re.match(r"visual_transformer\.enc_(spatial|temporal)_transformer\.layers\.\d+\.(\d)\.",
                   name)
    if hit:
        return f"{hit[1]} " + {"0": "PEG", "1": "attention", "3": "FF"}[hit[2]]
    if "norm_out" in name:
        return "norm_out"
    return "latents + temperature"


REPORT_WORDS = ("the lungs are clear without consolidation effusion or nodule heart size is normal "
                "mild emphysema and atelectasis in the lower lobes no lymphadenopathy").split()


def train_batches(torch, g, count: int, words: int) -> list:
    """`count` batches of BATCH bf16 volumes and stand-in reports of about
    `words` words (one token a word)."""
    def texts(i):
        return [" ".join(REPORT_WORDS[(i * 5 + j * 3 + k) % len(REPORT_WORDS)]
                         for k in range(words + 9 * j)) for j in range(BATCH)]

    return [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
             texts(i)) for i in range(count)]


def earlier_train_phase(torch, model, card: str) -> dict:
    """The earlier train path: 120-token reports (under the fused BERT
    layer's gate, so BERT trains on its layer loop) and the PEG on F.conv3d
    and autograd. Two steps of make_train_step and one evaluation; its
    kernels must launch and this slice's must not. Returns the launch counts."""
    from ct_clip_ut_tpu_torch.config import TrainConfig
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.train.trainer import (create_train_state, make_eval_step,
                                                    make_train_step)

    cfg = model.cfg
    tcfg = TrainConfig(text_max_length=EARLIER_TEXT_LEN)
    g = torch.Generator(device="cuda").manual_seed(2)
    image, texts = train_batches(torch, g, 1, 40)[0]
    enc = WordTokenizer(cfg.bert.vocab_size)(texts, max_length=EARLIER_TEXT_LEN)
    text = {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}
    state = create_train_state(cfg, tcfg, params=model, device="cuda")
    step, eval_step = make_train_step(cfg, tcfg), make_eval_step(cfg, tcfg)
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(state, image, text) for _ in range(2)] + [eval_step(state.model, image, text)]
    losses = [v.item() for v in losses]
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"earlier train path: 2 steps of make_train_step and 1 evaluation at B = {BATCH}, "
          f"{EARLIER_TEXT_LEN}-token reports, peg_pallas=False in {seconds:.3f} s (host clock, "
          f"first calls) [{card}]; losses {losses}; launches {json.dumps(counts)}")
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite losses on the earlier train path: {losses}")
    missing = [k for k, v in counts.items() if v <= 0 and k not in BERT_PEG_KERNELS
               and k != "bert_layer"]
    stray = [k for k in (*BERT_PEG_KERNELS, "bert_layer") if counts[k] != 0]
    if missing or stray:
        raise AssertionError(f"earlier train path: kernels not launched {missing}, kernels of "
                             f"another path launched {stray}")
    return counts


def train_phase(torch, model, card: str) -> dict:
    """The train path as users run it, at flagship width: 512-token reports
    through the fused BERT layer (bf16, Philox dropout, backward kernel) and
    the PEG through its stencil and weight-grad kernels (`model` is built
    with peg_pallas=True); returns the train run's launch counts."""
    import tempfile

    from ct_clip_ut_tpu_torch.config import TrainConfig
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply
    from ct_clip_ut_tpu_torch.train.trainer import CTClipTrainer

    cfg = model.cfg
    if not cfg.ctvit.peg_pallas:
        raise AssertionError("the train phase runs the peg_pallas=True configuration")
    tcfg = TrainConfig(num_epochs=1)
    if tcfg.text_max_length != TEXT_LEN or tcfg.compute_dtype != "bfloat16":
        raise AssertionError("the train phase runs the TrainConfig defaults: 512 tokens, bf16")
    g = torch.Generator(device="cuda").manual_seed(3)
    tok = WordTokenizer(cfg.bert.vocab_size)
    data = train_batches(torch, g, 4, 300)

    def tokens(texts):
        enc = tok(texts, max_length=TEXT_LEN)
        return {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}

    # one step's gradients, kernels vs the plain path, from the same weights,
    # inputs and dropout masks; the control is the plain gradient of another batch
    def grads(i, plain):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(5)
        out = ctclip_apply(model, tokens(data[i][1]), data[i][0], freeze_vq=False,
                           generator=gen, deterministic=False, plain=plain)
        loss = contrastive_loss(out.sim_matrix)
        loss.backward()
        by_group = {}
        for name, prm in model.named_parameters():
            if prm.grad is not None:
                by_group.setdefault(param_group(name), []).append(
                    prm.grad.detach().float().flatten())
        model.zero_grad(set_to_none=True)
        return (loss.item(), out.image_latents.detach().float(), out.image_tokens.detach(),
                {k: torch.cat(v) for k, v in by_group.items()})

    loss_k, lat_k, tok_k, gk = grads(0, False)
    loss_p, lat_p, tok_p, gp = grads(0, True)
    gc = grads(1, True)[3]
    cos = torch.nn.functional.cosine_similarity(lat_k, lat_p, dim=-1)
    # a token whose code matches keeps the same row up to the straight-through
    # form's bf16 rounding (~1e-2); a flipped code moves it by ~1
    same = ((tok_k.float() - tok_p.float()).abs().amax(-1) < 0.1).float().mean().item()
    errs = {k: ((gk[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    ctrl = {k: ((gc[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    bands = {k: LATENT_GRAD_BAND if k in ("text tower", "latents + temperature") else GRAD_BAND
             for k in gp}
    real = tokens(data[0][1])["attention_mask"].sum(1).tolist()
    print(f"train: reports of {real} real tokens padded to {TEXT_LEN}, peg_pallas=True")
    print(f"train: one step's loss {loss_k:.6f} (plain path {loss_p:.6f}); image latents vs the "
          f"plain path 1 - cos {(1 - cos).max().item():.3e}, {same:.6f} of quantised tokens on "
          f"the same code; "
          f"gradients vs the plain path, relative rms per group (band {GRAD_BAND}, "
          f"{LATENT_GRAD_BAND} downstream of the latents): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + "; controls (another batch): "
          + ", ".join(f"{k} {v:.3e}" for k, v in ctrl.items()) + f" [{card}]")
    if set(gk) != set(gp) or not all(torch.isfinite(v).all() for v in gk.values()):
        raise AssertionError("kernel-path gradients missing or non-finite")
    bad = {k: v for k, v in errs.items() if not v <= bands[k]}
    blind = {k: v for k, v in ctrl.items() if not v > bands[k]}
    if bad or blind:
        raise AssertionError(f"train gradients: over the band {bad}, controls within it {blind}")

    # CTClipTrainer.train(): 3 steps, the step-0 evaluation, a checkpoint
    vq = model.visual_transformer.vq._codebook
    cs0 = vq.cluster_size.sum().item()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = CTClipTrainer(cfg, tcfg, tok, data[:3], data[3:], results_folder=tmp,
                                params=model, device="cuda")
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches.launch_counts()
        saved = sorted(p.name for p in trainer.results_folder.iterdir())
    losses = trainer.train_losses["epochs"] + trainer.valid_losses
    print(f"train: CTClipTrainer.train() over 3 steps of {BATCH} x {list(VOLUME)} bf16 volumes "
          f"with {TEXT_LEN}-token reports, peg_pallas=True, the step-0 and end-of-epoch evaluations "
          f"and a checkpoint in "
          f"{seconds:.3f} s (host clock) [{card}]; epoch losses {trainer.train_losses['epochs']}, "
          f"validation {trainer.valid_losses}; files {saved}; launches {json.dumps(counts)}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    missing = [k for k, v in counts.items() if v <= 0 and k != "bert_layer"]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    layers, pegs = cfg.bert.num_layers, cfg.ctvit.spatial_depth + cfg.ctvit.temporal_depth
    evals = len(trainer.valid_losses)
    want_counts = {"bert_layer_bf16": (3 + evals) * layers, "bert_layer_bwd": 3 * layers,
                   "peg": (2 * 3 + evals) * pegs, "peg_weight_grads": 3 * pegs}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts:
        raise AssertionError(f"train path launches {got_counts}, expected {want_counts} (3 steps "
                             f"forward and backward, {evals} evaluations)")
    t, h, w = (s // d for s, d in zip(VOLUME[1:], (cfg.ctvit.temporal_patch_size,
                                                   cfg.ctvit.patch_size, cfg.ctvit.patch_size)))
    grow = BATCH * t * h * w
    decay = cfg.ctvit.vq_decay
    want_cs = cs0 * decay ** 3 + grow * (1 - decay ** 3)
    cs = vq.cluster_size.sum().item()
    print(f"train: VQ cluster sizes sum {cs:.3f} after 3 EMA steps (expected "
          f"{want_cs:.3f} = {cs0:.3f} decay^3 + {grow} (1 - {decay}^3))")
    if abs(cs - want_cs) > 1e-3 * want_cs:
        raise AssertionError(f"VQ cluster size sum {cs}, expected {want_cs}")

    # three more steps, each synchronised
    state, step = trainer.state, trainer.train_step
    image, text = data[0][0], tokens(data[0][1])
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = step(state, image, text)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"train: make_train_step at B = {BATCH}: {', '.join(f'{v:.3f}' for v in ms)} ms per "
          f"step (host clock, synchronised; loss {loss.item():.6f}); peak memory of these steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs the port on a GPU", file=sys.stderr)
        return 2
    try:
        from ct_clip_ut_tpu_torch import _build
        from ct_clip_ut_tpu_torch.config import flagship_cfg, replace
        from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    except ImportError:
        print("chip_smoke: run from the root of a checkout (ct_clip_ut_tpu_torch not found)",
              file=sys.stderr)
        return 2
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

        t0 = time.perf_counter()
        lib = _build.build()
        _build.load()
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

        model = init_ctclip(flagship_cfg(), seed=0, device="cuda")
        record = kernel_phase(torch, model, card)
        counts = slice_phase(torch, model, card)
        record.update(backward_phase(torch, model, card))
        record.update(bert_train_check(torch, model, card))
        record.update(peg_check(torch, model, card))
        earlier_train_phase(torch, model, card)
        del model
        torch.cuda.empty_cache()
        cfg = flagship_cfg()
        cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True))
        train_counts = train_phase(torch, init_ctclip(cfg, seed=0, device="cuda"), card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=(train_counts if n in TRAIN_KERNELS else counts)[n], **record[n])
               for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
