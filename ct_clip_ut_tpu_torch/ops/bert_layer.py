"""One post-LN BERT encoder layer: kernel wrappers and plain versions.

Replaces ct_clip_ut_tpu/ops/pallas_bert_layer.py: `bert_layer_fused`'s
forward (`_fwd_impl`) and its recompute backward (`_bwd_impl`), the text
tower at n >= 128 tokens. Three CUDA chains, each with a header that says
what bounds it on the H100 and what the design does about it:

- `csrc/bert_layer.cu`: fp32, deterministic (the zero-shot prompts, padded
  to 512 tokens and encoded in fp32);
- `csrc/bert_layer_bf16.cu`: bf16, deterministic (the train loop's
  evaluation) or in train mode with dropout on the attention probabilities
  and both hidden outputs (the train step's 512-token reports);
- `csrc/bert_layer_bwd.cu`: the backward of the bf16 chain: dx and the
  twelve parameter gradients, the forward recomputed and the dropout masks
  regenerated from the same seeds.

`bert_layer` picks the chain by x's dtype; `bert_layer_grad` is the layer
with its backward (a torch.autograd.Function, the custom VJP of
`bert_layer_fused`). An fp32 layer in train mode has no kernel: on a CUDA
tensor it raises (ROADMAP, Queue 2 item 8b).

Dropout. The TPU kernel reseeds its hardware PRNG per (site, sequence,
head). Here every element gets its own Philox4x32-10 bits: the counter is
(the element's position in its [n, n] or [n, D] slab // 4, the site, the
sequence, the head), the key (the site's seed, 0), and the four output words
go to four consecutive positions, so a mask depends on nothing a kernel's
tiling decides and the forward, the backward and `philox_keep` (the same
generator in plain PyTorch, on int64 tensors) produce the same bits. An
element is kept iff its bits >= uint32(min(int(rate * 2^32), 2^32 - 1)) and
kept ones are scaled by 1 / (1 - rate) in fp32 (pallas_bert_layer.py:68-74).
The three seeds of a layer are a device tensor (`draw_seeds`): no host
synchronisation inside a step.

Weights are in the nn.Linear (out, in) layout: wqkv [3D, D] (query, key,
value rows), wo [D, D], w1 [F, D], w2 [D, F]; they may be fp32 (the model's
leaves) or already in x's dtype.

`bert_layer_plain` is `_fwd_body` (:99-151) in plain PyTorch with its
rounding points: qkv summed in fp32 and q, k, v rounded to x's dtype as
operands of the score and context products; softmax in fp32, normalised,
then the keep mask, then rounded; the out-projection, keep mask and
residual in fp32; LayerNorm in the one-pass E[r^2] - E[r]^2 form; the FF
reads y rounded, the second residual adds y in fp32; exact-erf GELU.
`bert_layer_bwd_plain` is `_kernel_bwd` (:168-302) the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import launches

DIM_HEAD = 64       # the head width the CUDA attention cores take
MAX_TOKENS = 672    # the bf16 chains keep whole score rows in shared memory
SITES = ("attention", "post-attention", "post-FF")

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def philox4x32(c0, c1, c2, c3, k0, k1) -> tuple:
    """Philox4x32-10 on int64 tensors holding uint32 values (torch has no
    uint32 arithmetic): four counter words, two key words -> four words.
    The 32 x 32 -> 64-bit products wrap in int64; their low and high halves
    are still the unsigned product's."""
    for _ in range(10):
        p0, p1 = c0 * _M0, c2 * _M1
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def philox_keep(seeds: torch.Tensor, site: int, b: int, heads: int, inner: int,
                rate: float) -> torch.Tensor:
    """The keep factors (0 or 1 / (1 - rate), fp32) of dropout site `site`
    as [b, heads, inner]: position i of slab (sequence, head) takes word
    i % 4 of Philox(counter (i // 4, site, sequence, head), key (seed, 0)).
    `seeds` is the layer's [3] integer tensor; inner a multiple of 4."""
    if inner % 4:
        raise ValueError(f"a dropout slab holds a multiple of 4 elements, got {inner}")
    dev = seeds.device
    i64 = dict(dtype=torch.int64, device=dev)
    c0 = torch.arange(inner // 4, **i64)[None, None, :]
    c1 = torch.full((1, 1, 1), site, **i64)
    c2 = torch.arange(b, **i64)[:, None, None]
    c3 = torch.arange(heads, **i64)[None, :, None]
    k0 = seeds[site].to(torch.int64).reshape(1, 1, 1) & _U32
    k1 = torch.zeros((1, 1, 1), **i64)
    shape = (b, heads, inner // 4)
    words = philox4x32(*(t.expand(shape) for t in (c0, c1, c2, c3)), k0, k1)
    bits = torch.stack(words, dim=-1).reshape(b, heads, inner)
    return (bits >= dropout_threshold(rate)).float() * (1.0 / (1.0 - rate))


def draw_seeds(generator: torch.Generator, device) -> torch.Tensor:
    """One layer's three dropout seeds, int32 in [0, 2^31 - 1) on `device`,
    drawn from the caller's generator (models/bert.py:104-107 of the JAX
    package draws them from its key)."""
    return torch.randint(0, 2 ** 31 - 1, (3,), generator=generator, device=device,
                         dtype=torch.int32)


def _ln(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """(y, xhat, rstd) of the one-pass LayerNorm (pallas_bert_layer._ln_fwd)."""
    mean = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    xhat = (r - mean) * rstd
    return xhat * gamma + beta, xhat, rstd


def _ln_bwd(dout, xhat, rstd, gamma):
    dxhat = dout * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd, (dout * xhat).sum((0, 1)), dout.sum((0, 1))


def _check_types(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bert_layer takes fp32 or bf16 activations, got {x.dtype}")


def _masks(x, heads, p_attn, p_hidden, train, seeds):
    """(keep_attn [b, heads, n, n], keep1, keep2 [b, n, d]); None where the
    site drops nothing."""
    b, n, d = x.shape
    drop_a, drop_h = train and p_attn > 0.0, train and p_hidden > 0.0
    if (drop_a or drop_h) and seeds is None:
        raise ValueError("train-mode dropout needs the layer's seeds (draw_seeds)")
    ka = philox_keep(seeds, 0, b, heads, n * n, p_attn).reshape(b, heads, n, n) if drop_a else None
    k1 = philox_keep(seeds, 1, b, 1, n * d, p_hidden).reshape(b, n, d) if drop_h else None
    k2 = philox_keep(seeds, 2, b, 1, n * d, p_hidden).reshape(b, n, d) if drop_h else None
    return ka, k1, k2


def _forward_parts(x, mask_row, w, heads, eps, masks):
    """The layer's forward in fp32 tensors with x's dtype as the rounding
    type; returns the output (fp32, before the last rounding) and what the
    backward reads."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    ka, k1, k2 = masks

    def rnd(t):
        return t.to(dt).float()

    def split(t):
        return t.reshape(b, n, heads, dh).transpose(1, 2)

    x32 = x.float()
    qkv = x32 @ rnd(wqkv).t() + bqkv.float()
    q, k, v = (split(rnd(t)) for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (1.0 / dh ** 0.5) + mask_row.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    p_used = p if ka is None else p * ka
    ctx = rnd((rnd(p_used) @ v).transpose(1, 2).reshape(b, n, d))
    o1 = ctx @ rnd(wo).t() + bo.float()
    if k1 is not None:
        o1 = o1 * k1
    y, xhat1, rstd1 = _ln(o1 + x32, g1.float(), be1.float(), eps)
    h1 = rnd(y) @ rnd(w1).t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    g = rnd(h1 * cdf)
    o2 = g @ rnd(w2).t() + b2.float()
    if k2 is not None:
        o2 = o2 * k2
    r2 = o2 + y
    out, xhat2, rstd2 = _ln(r2, g2.float(), be2.float(), eps)
    return out, dict(q=q, k=k, v=v, p=p, p_used=p_used, ctx=ctx, y=y, xhat1=xhat1,
                     rstd1=rstd1, h1=h1, cdf=cdf, g=g, r2=r2, xhat2=xhat2, rstd2=rstd2)


def bert_layer_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                     heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                     train: bool = False, seeds: Optional[torch.Tensor] = None,
                     parts: Optional[dict] = None) -> torch.Tensor:
    """x [B, n, D] fp32 or bf16; mask_row [B, n] additive fp32 (0 or
    dtype-min). Returns [B, n, D] in x's dtype. Dropout acts only with
    train=True (then `seeds` is required where a rate is > 0). A `parts`
    dict receives intermediates that the output's rounding hides: LN1's
    fp32 output y and the fp32 sum before LN2 r2 [B, n, D], and the FF's
    rounded activations g [B, n, F]."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    masks = _masks(x, heads, p_attn, p_hidden, train, seeds)
    out, f = _forward_parts(x, mask_row, w, heads, eps, masks)
    if parts is not None:
        parts.update(y=f["y"], g=f["g"], r2=f["r2"])
    return out.to(x.dtype)


def bert_layer_bwd_plain(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                         dout, heads: int, eps: float, *, p_attn: float = 0.0,
                         p_hidden: float = 0.0, train: bool = False,
                         seeds: Optional[torch.Tensor] = None, faults: tuple = ()) -> tuple:
    """Gradients of bert_layer_plain's output against cotangent dout
    [B, n, D]: (dx in x's dtype; dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1,
    dw2, db2, dg2, dbe2 in fp32), `_kernel_bwd` with its rounding points.
    `faults` builds a faulty kernel's gradients, the card checks' controls:
    "no_attn_keep" leaves the attention keep mask out of dp, "no_hidden_keep"
    leaves the post-FF keep mask out of do2, "p_used_in_ds" takes the dropped
    probabilities for the pre-dropout ones in ds."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    dt = x.dtype
    b, n, d = x.shape
    dh = d // heads
    scale = 1.0 / dh ** 0.5
    ka, k1, k2 = masks = _masks(x, heads, p_attn, p_hidden, train, seeds)
    _, f = _forward_parts(x, mask_row, w, heads, eps, masks)

    def rnd(t):
        return t.to(dt).float()

    def rows(t):
        return t.reshape(b * n, -1)

    def merge(t):
        return t.transpose(1, 2).reshape(b, n, d)

    x32 = x.float()
    dr2, dg2, dbe2 = _ln_bwd(dout.float(), f["xhat2"], f["rstd2"], g2.float())
    do2 = dr2 if k2 is None or "no_hidden_keep" in faults else dr2 * k2
    dw2 = rows(rnd(do2)).t() @ rows(f["g"])
    db2 = do2.sum((0, 1))
    dh1 = (rnd(do2) @ rnd(w2)) * (f["cdf"] + f["h1"] * 0.3989422804014327
                                  * torch.exp(-0.5 * f["h1"] * f["h1"]))
    dw1 = rows(rnd(dh1)).t() @ rows(rnd(f["y"]))
    db1 = dh1.sum((0, 1))
    dy = dr2 + rnd(dh1) @ rnd(w1)
    dr1, dg1, dbe1 = _ln_bwd(dy, f["xhat1"], f["rstd1"], g1.float())
    do1 = dr1 if k1 is None else dr1 * k1
    dwo = rows(rnd(do1)).t() @ rows(f["ctx"])
    dbo = do1.sum((0, 1))
    dctx = rnd(rnd(do1) @ rnd(wo)).reshape(b, n, heads, dh).transpose(1, 2)

    p = f["p"]
    dp = dctx @ f["v"].transpose(-1, -2)
    dv = rnd(f["p_used"]).transpose(-1, -2) @ dctx
    if ka is not None and "no_attn_keep" not in faults:
        dp = dp * ka
    pd = f["p_used"] if "p_used_in_ds" in faults else p
    ds = rnd(pd * (dp - (dp * pd).sum(-1, keepdim=True)) * scale)
    dq, dk = ds @ f["k"], ds.transpose(-1, -2) @ f["q"]
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    dx = dr1 + rnd(dqkv) @ rnd(wqkv)
    dwqkv = rows(rnd(dqkv)).t() @ rows(x32)
    dbqkv = dqkv.sum((0, 1))
    return (dx.to(dt), dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2)


def _thresholds(p_attn, p_hidden, train, seeds):
    """(thresh_attn, thresh_hidden, scale_attn, scale_hidden) for the kernels:
    a threshold of 0 switches its site off."""
    ta = dropout_threshold(p_attn) if train and p_attn > 0.0 else 0
    th = dropout_threshold(p_hidden) if train and p_hidden > 0.0 else 0
    if (ta or th) and seeds is None:
        raise ValueError("train-mode dropout needs the layer's seeds (draw_seeds)")
    return ta, th, 1.0 / (1.0 - p_attn) if ta else 1.0, 1.0 / (1.0 - p_hidden) if th else 1.0


def _bf16_args(x, mask_row, w, seeds, heads):
    """The bf16 chains' inputs, checked: (x padded to [b, npad, d], the mask
    padded to [b, npad], seeds, the twelve weights with the matrices in
    bf16), npad = n rounded up to 32."""
    b, n, d = x.shape
    dev = x.device
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    f = w1.shape[0]
    if d != heads * DIM_HEAD or f % 8:
        raise ValueError(f"the bert_layer kernel takes heads of {DIM_HEAD} and an FF width "
                         f"that 8 divides; got D={d}, heads={heads}, F={f}")
    if n % 4:
        raise ValueError(f"the bert_layer kernel takes a token count that 4 divides, got {n}")
    npad = (n + 31) // 32 * 32
    if npad > MAX_TOKENS:
        raise ValueError(f"the bf16 bert_layer kernel keeps a score row in shared memory: "
                         f"at most {MAX_TOKENS} tokens, got {n}")
    _build.require(x, "x", torch.bfloat16, (b, n, d), dev)
    _build.require(mask_row, "mask_row", torch.float32, (b, n), dev)
    mats = [t.to(torch.bfloat16).contiguous() for t in (wqkv, wo, w1, w2)]
    vecs = [t.float().contiguous() for t in (bqkv, bo, g1, be1, b1, b2, g2, be2)]
    for t, name, shape in ((mats[0], "wqkv", (3 * d, d)), (mats[1], "wo", (d, d)),
                           (mats[2], "w1", (f, d)), (mats[3], "w2", (d, f)),
                           (vecs[0], "bqkv", (3 * d,)), (vecs[4], "b1", (f,)),
                           *((v, "a [D] vector", (d,)) for v in vecs[1:4] + vecs[5:])):
        _build.require(t, name, t.dtype, shape, dev)
    if npad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
        mask_row = torch.nn.functional.pad(mask_row, (0, npad - n))
    if seeds is None:
        seeds = torch.zeros((3,), dtype=torch.int32, device=dev)
    _build.require(seeds, "seeds", torch.int32, (3,), dev)
    weights = (mats[0], vecs[0], mats[1], vecs[1], vecs[2], vecs[3], mats[2], vecs[4], mats[3],
               vecs[5], vecs[6], vecs[7])
    return _build.aligned16(x), _build.aligned16(mask_row), seeds, weights, npad


def _bf16_work(b, npad, d, f, heads, dev, keep_probs: bool) -> list:
    """The forward chain's workspaces, in the C entry's order."""
    m = b * npad
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    pu = torch.empty((b, heads, npad, npad), **b16) if keep_probs else None
    return [torch.empty((m, 3 * d), **b16), pu, torch.empty((m, d), **b16),
            torch.empty((m, d), **f32), torch.empty((m, 2), **f32), torch.empty((m, d), **f32),
            torch.empty((m, d), **b16), torch.empty((m, f), **f32), torch.empty((m, f), **b16),
            torch.empty((m, d), **f32), torch.empty((m, 2), **f32)]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bert_layer_fp32(x, mask_row, w, heads, eps):
    """The fp32 deterministic chain (csrc/bert_layer.cu)."""
    b, n, d = x.shape
    f = w[6].shape[0]
    if d != heads * DIM_HEAD or f % 4:
        raise ValueError(f"the bert_layer kernel takes heads of {DIM_HEAD} and an FF width "
                         f"that 4 divides; got D={d}, heads={heads}, F={f}")
    dev = x.device
    args = ((x, "x", (b, n, d)), (mask_row, "mask_row", (b, n)),
            *zip(w, ("wqkv", "bqkv", "wo", "bo", "g1", "be1", "w1", "b1", "w2", "b2", "g2", "be2"),
                 ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (f, d), (f,), (d, f), (d,),
                  (d,), (d,))))
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
        *(t.data_ptr() for t, _, _ in args), *(t.data_ptr() for t in ws), out.data_ptr(),
        b, n, d, f, heads, float(eps), 1.0 / DIM_HEAD ** 0.5, _build.stream_of(x))
    _build.check(err, "bert_layer")
    launches.count("bert_layer")
    return out


def bert_layer(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
               heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
               train: bool = False, seeds: Optional[torch.Tensor] = None,
               parts: Optional[dict] = None) -> torch.Tensor:
    """The bert_layer kernel chains on CUDA tensors (contiguous, heads of
    64): fp32 x takes the fp32 deterministic chain (all arguments fp32), bf16
    x the bf16 chain, with dropout when train=True. CPU tensors take the
    plain version. A `parts` dict receives the bf16 chain's y, g and r2
    workspaces, as bert_layer_plain's does."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    if not _build.on_cuda(x):
        return bert_layer_plain(x, mask_row, *w, heads, eps, p_attn=p_attn, p_hidden=p_hidden,
                                train=train, seeds=seeds, parts=parts)
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    if x.dtype == torch.float32:
        if ta or th:
            raise NotImplementedError(
                "the fp32 bert_layer kernel runs the deterministic forward only: train-mode "
                "dropout runs in bf16 (ROADMAP, Queue 2 item 8b)")
        return _bert_layer_fp32(x, mask_row, w, heads, eps)
    b, n, d = x.shape
    xp, mask_p, seeds, weights, npad = _bf16_args(x, mask_row, w, seeds, heads)
    f = weights[6].shape[0]
    work = _bf16_work(b, npad, d, f, heads, x.device, keep_probs=False)
    out = torch.empty((b, npad, d), dtype=torch.bfloat16, device=x.device)
    err = _build.load().ctc_bert_layer_bf16(
        xp.data_ptr(), mask_p.data_ptr(), seeds.data_ptr(), *(t.data_ptr() for t in weights),
        *(_ptr(t) for t in work), out.data_ptr(), b, n, npad, d, f, heads, float(eps),
        1.0 / DIM_HEAD ** 0.5, ta, th, sa, sh, _build.stream_of(x))
    _build.check(err, "bert_layer_bf16")
    launches.count("bert_layer_bf16")
    if parts is not None:
        parts.update({k: work[i].reshape(b, npad, -1)[:, :n]
                      for k, i in (("y", 5), ("g", 8), ("r2", 9))})
    return out if npad == n else out[:, :n].contiguous()


def bert_layer_bwd(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, dout,
                   heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                   train: bool = False, seeds: Optional[torch.Tensor] = None) -> tuple:
    """The bert_layer backward kernel chain on CUDA tensors (bf16 x and
    dout), the plain backward on CPU tensors: (dx, dwqkv, dbqkv, dwo, dbo,
    dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2), dx in x's dtype, the rest
    fp32."""
    _check_types(x)
    w = (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    if not _build.on_cuda(x):
        return bert_layer_bwd_plain(x, mask_row, *w, dout, heads, eps, p_attn=p_attn,
                                    p_hidden=p_hidden, train=train, seeds=seeds)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the bert_layer backward kernel takes bf16 activations: an fp32 layer has no "
            "backward kernel (ROADMAP, Queue 2 item 8b)")
    ta, th, sa, sh = _thresholds(p_attn, p_hidden, train, seeds)
    b, n, d = x.shape
    dev = x.device
    _build.require(dout, "dout", torch.bfloat16, (b, n, d), dev)
    xp, mask_p, seeds, weights, npad = _bf16_args(x, mask_row, w, seeds, heads)
    if npad != n:
        dout = torch.nn.functional.pad(dout, (0, 0, 0, npad - n))
    dout = _build.aligned16(dout)
    f = weights[6].shape[0]
    m = b * npad
    transposed = [weights[i].t().contiguous() for i in (0, 2, 6, 8)]
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    work = _bf16_work(b, npad, d, f, heads, dev, keep_probs=True)
    more = [torch.empty((m, d), **b16), torch.empty((m, d), **f32), torch.empty((m, d), **f32),
            torch.empty((m, d), **b16), torch.empty((m, f), **b16), torch.empty((m, d), **b16),
            torch.empty((b, heads, npad, npad), **b16), torch.empty((m, 3 * d), **f32),
            torch.empty((m, 3 * d), **b16)]
    dx = torch.empty((b, npad, d), **b16)
    grads = [torch.zeros(s, **f32) for s in ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
                                             (f, d), (f,), (d, f), (d,), (d,), (d,))]
    err = _build.load().ctc_bert_layer_bwd(
        xp.data_ptr(), mask_p.data_ptr(), seeds.data_ptr(), *(t.data_ptr() for t in weights),
        *(t.data_ptr() for t in transposed), dout.data_ptr(), *(_ptr(t) for t in work),
        *(t.data_ptr() for t in more), dx.data_ptr(), *(t.data_ptr() for t in grads),
        b, n, npad, d, f, heads, float(eps), 1.0 / DIM_HEAD ** 0.5, ta, th, sa, sh,
        _build.stream_of(x))
    _build.check(err, "bert_layer_bwd")
    launches.count("bert_layer_bwd")
    return (dx if npad == n else dx[:, :n].contiguous(), *grads)


def keep_mask(seeds: torch.Tensor, site: int, b: int, heads: int, inner: int,
              rate: float) -> torch.Tensor:
    """The keep factors the kernels compute for one dropout site, as
    `philox_keep` lays them out: the CUDA generator on a CUDA `seeds`, the
    plain one on the CPU. A run holds the two against each other bit for
    bit."""
    if not _build.on_cuda(seeds):
        return philox_keep(seeds, site, b, heads, inner, rate)
    _build.require(seeds, "seeds", torch.int32, (3,), seeds.device)
    if inner % 4:
        raise ValueError(f"a dropout slab holds a multiple of 4 elements, got {inner}")
    out = torch.empty((b, heads, inner), dtype=torch.float32, device=seeds.device)
    err = _build.load().ctc_bert_keep_mask(seeds.data_ptr(), site, b, heads, inner,
                                           dropout_threshold(rate), 1.0 / (1.0 - rate),
                                           out.data_ptr(), _build.stream_of(seeds))
    _build.check(err, "bert_keep_mask")
    return out


class _BertLayerFn(torch.autograd.Function):
    """The layer with its backward: bert_layer and bert_layer_bwd, on CUDA
    tensors the kernel chains and on CPU tensors their plain versions. Like
    the TPU kernel it saves its inputs only (the weight matrices in x's
    dtype): the backward recomputes the forward and regenerates the masks
    from the seeds."""

    @staticmethod
    def forward(ctx, x, mask_row, seeds, heads, eps, p_attn, p_hidden, train, *w):
        dt = x.dtype
        cast = tuple(t.detach().to(dt) if t.dim() == 2 else t.detach() for t in w)
        ctx.save_for_backward(x, mask_row, seeds, *cast)
        ctx.cfg = (heads, eps, p_attn, p_hidden, train)
        ctx.dtypes = tuple(t.dtype for t in w)
        return bert_layer(x, mask_row, *cast, heads, eps, p_attn=p_attn, p_hidden=p_hidden,
                          train=train, seeds=seeds)

    @staticmethod
    def backward(ctx, dout):
        x, mask_row, seeds, *w = ctx.saved_tensors
        heads, eps, p_attn, p_hidden, train = ctx.cfg
        dx, *grads = bert_layer_bwd(x, mask_row, *w, dout.contiguous(), heads, eps,
                                    p_attn=p_attn, p_hidden=p_hidden, train=train, seeds=seeds)
        return (dx, None, None, None, None, None, None, None,
                *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)))


def bert_layer_grad(x, mask_row, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                    heads: int, eps: float, *, p_attn: float = 0.0, p_hidden: float = 0.0,
                    train: bool = False, seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bert_layer with its backward (the custom VJP of
    pallas_bert_layer.bert_layer_fused): dx in x's dtype and the twelve
    parameter gradients in the parameters' dtypes."""
    return _BertLayerFn.apply(x, mask_row, seeds, heads, eps, p_attn, p_hidden, train,
                              wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
