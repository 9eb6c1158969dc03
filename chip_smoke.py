#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ct_clip_ut_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the device: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. the build of csrc/*.cu (one nvcc per source, in parallel), with its
     seconds;
  3. each of the six kernels against its plain PyTorch version on the card,
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
     the plain path; then zeroshot() writes metrics.txt.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero before it.
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
BATCHES, BATCH = 3, 2
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
}


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
        return base + 0.1 * torch.randn((n,), generator=g, device="cuda")

    def attn_args(tf):
        a = tf.layers[0][1]
        wkv = a.to_kv.weight.to(bf)
        inner, dh = a.cfg.inner_dim, a.cfg.dim_head
        return [around(1.0, d), a.to_q.weight.to(bf), wkv[:inner].contiguous(),
                wkv[inner:].contiguous(), a.to_out.weight.to(bf), around(1.0, dh),
                around(1.0, dh)]

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
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs the port on a GPU", file=sys.stderr)
        return 2
    try:
        from ct_clip_ut_tpu_torch import _build
        from ct_clip_ut_tpu_torch.config import flagship_cfg
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
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=counts[n],
                    **record[n]) for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
