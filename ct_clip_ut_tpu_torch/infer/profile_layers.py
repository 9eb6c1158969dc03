"""Per-launch device profile of one fp32 BERT layer, one bf16 train-mode
BERT layer forward and backward, one GEGLU FF backward, one prompt
encoding, one temporal attention block, one patch embed and its weight
gradient, one W8A8 GEGLU FF, the PEG stencil in its two forms and one PEG
weight gradient on one GPU.

    python -m ct_clip_ut_tpu_torch.infer.profile_layers [--label L] [--out DIR]

At flagship width (`config.flagship_cfg()`, random weights from seed 0) it
runs under torch.profiler, each after one warm-up call (`profile_call`):

- `bert_layer` in fp32 on [36, 512, 768] with the zero-shot slice's key
  mask as chip_smoke.py draws it (6 to 14 real tokens a prompt, two at
  512), text layer 0's weights;
- `bert_layer` in bf16 and train mode (the config's dropout rates, seeds
  [20231, 77, 2^30]) on [2, 512, 768], one sequence padded after 300
  tokens as chip_smoke.py has it, text layer 0's fp32 weights, and its
  `bert_layer_bwd`: a B = 2 train step's text layer;
- `geglu_ff_bwd` at a B = 2 train step's shape, x and g [27648, 512] bf16,
  spatial layer 0's FF weights, the residual on;
- one `encode_prompt_latents` of the 36 prompts padded to 512 tokens (12
  fp32 layers);
- `attn_packed` at the zero-shot shape of two volumes, x [1152, 24, 512]
  bf16, temporal layer 0's weights, the residual on;
- `patch_embed_fused` and `patch_embed_res` on two flagship volumes [2, 1,
  240, 480, 480] bf16 (the model's embed weights, folded);
- `geglu_ff_int8` at the `--quantize-ff` zero-shot shape of two volumes,
  x [27648, 512] bf16, spatial layer 0's FF quantised (inner 1365 padded
  to 1376), the residual on;
- `peg` at a B = 2 train step's shape, x [2, 24, 24, 24, 512] bf16, spatial
  layer 0's taps: the causal forward (front padding 2, a bias) and the
  input gradient's form (front 0, the taps flipped, no bias);
- `peg_weight_grads` at the same shape, x and g bf16, the causal padding;
- `patch_embed_dkw` on the same two volumes with a dconv [27648, 512] bf16,
  from the volume (the patchify pass writing P, then the weight gradient
  over it).

For each it prints the device kernel time and the kernels ranked by time
with their launch counts (every row into DIR/<name>.table with --out). The
module imports the package by absolute name only, so that it can also be
run as a file against another checkout of the port on PYTHONPATH, to
profile two versions in one session. Each line names the card and its
power limit (`nvidia-smi`).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ct_clip_ut_tpu_torch.config import flagship_cfg
from ct_clip_ut_tpu_torch.infer.profile_zeroshot import card_name, print_profile, profile_call
from ct_clip_ut_tpu_torch.infer.zeroshot import (WordTokenizer, encode_prompt_latents,
                                                 tokenize_prompts)
from ct_clip_ut_tpu_torch.models.bert import layer_args
from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed
from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_bwd
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd
from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import geglu_ff_int8
from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_dkw,
                                                  patch_embed_fused, patch_embed_res)
from ct_clip_ut_tpu_torch.ops.peg import peg, peg_weight_grads, taps_of
from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

PROMPTS, PROMPT_LEN, FF_ROWS = 36, 512, 27648
SEQS, SEQ_LEN = 1152, 24             # the temporal stack's sequences at two volumes
TRAIN_BATCH, TRAIN_LEN, TRAIN_SHORT = 2, 512, 300   # the train step's text layer
VOLUMES = (2, 1, 240, 480, 480)
PEG_VIDEO = (2, 24, 24, 24, 512)     # the token video of a B = 2 train step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="profile_layers", help="prefix of every printed line")
    ap.add_argument("--out", default=None, help="write every kernel's profile row under DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_layers: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    def table(name):
        return os.path.join(args.out, f"{name}.table") if args.out else None

    def run(name, fn, label, top=12):
        """Profile fn() and print it (its rows to DIR/name.table)."""
        with torch.no_grad():
            p = profile_call(fn)
        print_profile(p, f"{args.label}: {label}", card, table(name), top=top)

    bcfg = cfg.bert
    lengths = torch.randint(6, 15, (PROMPTS,), generator=g, device="cuda")
    lengths[3] = lengths[17] = PROMPT_LEN
    pad = torch.arange(PROMPT_LEN, device="cuda")[None] >= lengths[:, None]
    mask = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((PROMPTS, PROMPT_LEN, bcfg.hidden_size), generator=g, device="cuda")
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    run("bert_layer", lambda: bert_layer(x, mask, *w, bcfg.num_heads, bcfg.layer_norm_eps),
        f"one fp32 bert_layer {list(x.shape)}")

    bf = torch.bfloat16
    short = torch.tensor([TRAIN_LEN, TRAIN_SHORT], device="cuda")
    tmask = (torch.arange(TRAIN_LEN, device="cuda")[None] >= short[:, None]).float() \
        * torch.finfo(torch.float32).min
    xb = torch.randn((TRAIN_BATCH, TRAIN_LEN, bcfg.hidden_size), generator=g,
                     device="cuda").to(bf)
    dout = torch.randn(xb.shape, generator=g, device="cuda").to(bf)
    train = dict(p_attn=bcfg.attention_dropout, p_hidden=bcfg.hidden_dropout, train=True,
                 seeds=torch.tensor([20231, 77, 1 << 30], dtype=torch.int32, device="cuda"))
    heads, eps = bcfg.num_heads, bcfg.layer_norm_eps
    run("bert_bf16", lambda: bert_layer(xb, tmask, *w, heads, eps, **train),
        f"one bf16 train-mode bert_layer {list(xb.shape)}")
    run("bert_bwd", lambda: bert_layer_bwd(xb, tmask, *w, dout, heads, eps, **train),
        f"one bf16 train-mode bert_layer_bwd {list(xb.shape)}", top=20)

    vit = model.visual_transformer
    ff = vit.enc_spatial_transformer.layers[0][3]
    d = cfg.ctvit.dim
    xf = torch.randn((FF_ROWS, d), generator=g, device="cuda").to(bf)
    gr = torch.randn((FF_ROWS, d), generator=g, device="cuda").to(bf)
    gamma = 1.0 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    beta = 0.1 * torch.randn((d,), generator=g, device="cuda")
    ff_args = (xf, gamma, beta, ff[1].weight.detach().to(bf), ff[4].weight.detach().to(bf), gr,
               True)
    run("geglu_ff_bwd", lambda: geglu_ff_bwd(*ff_args), f"one geglu_ff_bwd {list(xf.shape)}")
    q = quantize_ff_params(ff)
    with torch.no_grad():
        q.gamma.copy_(gamma)
        q.beta.copy_(beta)
    q8_args = (xf, q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2, True)
    run("geglu_ff_int8", lambda: geglu_ff_int8(*q8_args),
        f"one geglu_ff_int8 {list(xf.shape)}, inner {q.inner_dim} padded to {q.wv_q.shape[0]}")
    xv = torch.randn(PEG_VIDEO, generator=g, device="cuda").to(bf)
    gv = torch.randn(PEG_VIDEO, generator=g, device="cuda").to(bf)
    taps = taps_of(vit.enc_spatial_transformer.layers[0][0].dsconv.weight.detach())
    bias = 0.2 * torch.randn((d,), generator=g, device="cuda")
    run("peg", lambda: peg(xv, taps, bias, 2), f"one peg {list(xv.shape)} bf16, front 2, bias")
    flipped = taps.flip(0).contiguous()
    run("peg_back", lambda: peg(gv, flipped, None, 0),
        f"one peg {list(gv.shape)} bf16, front 0, flipped taps, no bias")
    run("peg_weight_grads", lambda: peg_weight_grads(xv, gv, 2),
        f"one peg_weight_grads {list(xv.shape)} bf16, front 2")

    prompts = tokenize_prompts(WordTokenizer(bcfg.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    run("prompt", lambda: encode_prompt_latents(model, prompts),
        f"one prompt encoding ({PROMPTS} x {PROMPT_LEN})")

    a = vit.enc_temporal_transformer.layers[0][1]
    wkv = a.to_kv.weight.detach().to(bf)
    inner, dh = a.cfg.inner_dim, a.cfg.dim_head
    xt = torch.randn((SEQS, SEQ_LEN, d), generator=g, device="cuda").to(bf)
    at_args = (xt, 1.0 + 0.1 * torch.randn((d,), generator=g, device="cuda"),
               a.to_q.weight.detach().to(bf), wkv[:inner].contiguous(), wkv[inner:].contiguous(),
               a.to_out.weight.detach().to(bf),
               1.0 + 0.1 * torch.randn((dh,), generator=g, device="cuda"),
               1.0 + 0.1 * torch.randn((dh,), generator=g, device="cuda"), a.cfg.scale, True)
    run("attn_packed", lambda: attn_packed(*at_args), f"one attn_packed {list(xt.shape)}")

    vcfg = cfg.ctvit
    pt, tp = vcfg.patch_size, vcfg.temporal_patch_size
    image = torch.randn(VOLUMES, generator=g, device="cuda").to(bf)
    with torch.no_grad():
        emb = vit.to_patch_emb
        kw, s1, b1 = fold_patch_embed(emb, pt, tp)
        pe_args = (image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float(), pt, tp)
    run("patch_embed", lambda: patch_embed_fused(*pe_args),
        f"one patch_embed {list(image.shape)}")
    run("patch_embed_res", lambda: patch_embed_res(*pe_args),
        f"one patch_embed_res {list(image.shape)}")
    dconv = torch.randn((image.numel() // (tp * pt * pt), d), generator=g,
                        device="cuda").to(bf)
    run("patch_embed_dkw", lambda: patch_embed_dkw(image, dconv, pt, tp),
        f"one patch_embed_dkw {list(image.shape)}, dconv {list(dconv.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
