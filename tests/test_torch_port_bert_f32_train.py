"""What the CPU can check of the fp32 BERT layer in train mode (rows 6F and
12F): the fp32 forward chain with its three dropout sites
(`ctc_bert_layer`, csrc/bert_layer.cu on csrc/bert_f32.cuh) and its fp32
recompute backward with every gradient (`ctc_bert_layer_bwd_f32`,
csrc/bert_layer_bwd_f32.cu).

The chains run only on the card (chip_smoke.py phase 15 and the card tests
`-k "bert_f32"` hold them against their plain versions there). Here each is
emulated in torch plane by plane, as tests/test_torch_port_f32_train_hopper.py
does for rows 7F-9F: every fp32 product three bf16 products of hi / lo
planes (A_hi B_hi + A_lo B_hi + A_hi B_lo in fp32), the planes written where
the kernels write them; the attention an online softmax over 64-key chunks,
each exp(s - m) times its keep factor before it feeds P.V and the row sum
undropped; the hidden sites' keep factors in the products' epilogues, after
the bias and before the residual; the backward's p from the recompute's
(max, 1 / sum), its row term rowsum(p keep dP) from the same split dP the
passes take, the masks
from the same Philox bits (`philox_keep`), and the weight gradients A^T B
over the tokens from the planes, as the three-pass split wgrad plans take
them. The emulations are held, at D = 256, 4 heads of 64, n = 128, F = 512
and one sequence masked to 90 (tests/test_torch_port_bert_train.py's case),
(i) at p = 0 against jax.vjp of the Pallas kernel `bert_layer_fused` in
interpret mode and of its XLA twin `bert_layer_xla`, and (ii) in train mode
against `bert_layer_plain` / `bert_layer_bwd_plain` through the same masks
(there is no JAX twin with dropout on the CPU: the Pallas interpreter's PRNG
is a stub), for the output, x and all twelve parameters, within 2e-5 of each
output's largest entry. The one-pass control (every lo plane zero) and the
plain backward's three faults (the attention keep left out of dp, the
post-FF keep left out of do2, the dropped probabilities in ds) each miss the
band. Then the kept route (the train forward's state, KEPT) against the
rerun, bit for bit, and through a stand-in library that autograd hands the
backward the forward's workspaces and no rerun runs. Last, the keep bits'
layout as the passes read it, the weight gradients' one launch
(SplitQuadPlan, mirrored from csrc/bert_layer_bwd_f32.cu) covering every
element once, and the 64-row staged products (split4_64_kernel's K slices
alternating between two warpgroups) against fp32.

F8, the gradients whose terms cancel: at dropout 0, two layers, tokens
that differ by 2% of their common part and a cotangent on the first token
alone (the CLS latent), the query / key weight gradients cancel in ds = p
(dP - D). The chain is held against jax.vjp of the XLA twins' stack within
F8_BAND of each gradient's largest entry (it reads 9.8e-4 to 1.1e-2, the
plain fp32 backward 1.4e-3 to 2.9e-3); the first design's row term,
rowsum(dctx (ctx_hi + ctx_lo)), whose split errors do not cancel against
dP's, misses it (5.4e-2 to 1.7e-1), and so does that design with a third
plane on dP alone (4.6e-2 to 6.3e-2).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops.pallas_bert_layer import bert_layer_fused, bert_layer_xla
from ct_clip_ut_tpu_torch.ops.bert_layer import (bert_layer_bwd_plain, bert_layer_plain,
                                                 philox_keep)

from test_torch_port_bert_train import EPS, HEADS, MATRICES, NAMES, _case, _jax_grads
from test_torch_port_cuda import BERT_KEYS, _torch_bert_args
from test_torch_port_f32_bwd_hopper import _t
from test_torch_port_f32_hopper import _product, _split

BAND = 2e-5               # max |got - want| / max |want| of each output
KC = 64                   # keys (queries) a chunk of the attention core and passes
MASKED, REAL = -1e30, -1e20
RATE = 0.1                # BertConfig's attention and hidden dropout
SEEDS = torch.tensor([20231, 77, 1 << 30], dtype=torch.int32)
FAULTS = ("no_attn_keep", "no_hidden_keep", "p_used_in_ds")
F8_BAND = 3e-2            # the last layers' query / key gradients, each over its largest entry
CLOSE_BAND = 1e-2         # F12: the stack's dWq, dWk and dx, each over its largest entry (the card's)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ln(r, gamma, beta):
    """ln_split_kernel's one-pass moments: (y, xhat, rstd)."""
    mean = r.mean(-1, keepdim=True)
    var = ((r * r).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + EPS)
    xhat = (r - mean) * rstd
    return xhat * gamma + beta, xhat, rstd


def _ln_bwd(dout, xhat, rstd, gamma):
    """ln_drop_bwd_kernel's dr, before the keep."""
    dxhat = dout * gamma
    return (dxhat - dxhat.mean(-1, keepdim=True)
            - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd


def _keeps(b, n, d, train):
    """(keep_attn [b, heads, n, n], keep1, keep2 [b n, d]) from SEEDS, or Nones."""
    if not train:
        return None, None, None
    ka = philox_keep(SEEDS, 0, b, HEADS, n * n, RATE).reshape(b, HEADS, n, n)
    k1, k2 = (philox_keep(SEEDS, s, b, 1, n * d, RATE).reshape(b * n, d) for s in (1, 2))
    return ka, k1, k2


def _wgrad(a, b):
    """A^T B over the token rows of planes a [M, i], b [M, j]: the split
    pair plan's three passes."""
    return _product(_t(a), _t(b))


def _attention(q, k, v, mask, ka, one_pass, skip):
    """attn_kernel on planes q, k, v [b, heads, n, 64]: per (sequence,
    head) an online softmax over 64-key chunks, the chunks the mask removes
    entirely skipped (with `skip`), each exp(s - m) times its keep factor
    before P.V, the row sum undropped. Returns ctx [b, heads, n, 64] and
    each row's final (max, sum)."""
    b, _, n, dh = q[0].shape
    scale = 1.0 / math.sqrt(dh)
    ctx, mx_out, l_out = (torch.empty(q[0].shape), torch.empty(q[0].shape[:3]),
                          torch.empty(q[0].shape[:3]))
    for s in range(b):
        mrow = mask[s]
        any_real = skip and bool((mrow > REAL).any())
        m = torch.full((HEADS, n), -math.inf)
        l, o = torch.zeros((HEADS, n)), torch.zeros((HEADS, n, dh))
        for c0 in range(0, n, KC):
            keys = slice(c0, min(n, c0 + KC))
            if any_real and bool((mrow[keys] < MASKED).all()):
                continue
            sc = _product([t[s] for t in q], [t[s][:, keys] for t in k]) * scale + mrow[keys]
            mx = torch.maximum(m, sc.max(-1).values)
            alpha = torch.exp(m - mx)
            m = mx
            p = torch.exp(sc - m[..., None])
            l = l * alpha + p.sum(-1)
            if ka is not None:
                p = p * ka[s][:, :, keys]
            o = o * alpha[..., None] + _product(_split(p, one_pass),
                                                [t[s][:, keys].transpose(-1, -2) for t in v])
        ctx[s], mx_out[s], l_out[s] = o / l[..., None], m, l
    return ctx, mx_out, l_out


def emulated_forward(x, mask, w, keeps, *, one_pass=False, skip=True):
    """ctc_bert_layer (forward_chain_f32): the split pass, the QKV product
    (SplitEpi), attn_kernel, the out-projection with bias, keep1 and the
    residual (HiddenF32Epi), LN1 as fp32 and planes, the FF's first product
    with GELU (h1 kept), its second with bias, keep2 and y, LN2. Returns the
    output [b, n, d] and what the backward reads."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    ka, k1, k2 = keeps
    b, n, d = x.shape
    dh = d // HEADS

    def sp(t):
        return _split(t, one_pass)

    def heads_of(t):
        return t.reshape(b, n, HEADS, dh).transpose(1, 2)

    x2 = x.reshape(b * n, d)
    xs = sp(x2)
    ws = [sp(t) for t in (wqkv, wo, w1, w2)]
    qkv32 = _product(xs, ws[0]) + bqkv
    qkv = sp(qkv32)
    q, k, v = ([heads_of(p[:, i * d:(i + 1) * d]) for p in qkv] for i in range(3))
    ctx, mx, l = _attention(q, k, v, mask, ka, one_pass, skip)
    ctx_s = sp(ctx.transpose(1, 2).reshape(b * n, d))
    o1 = _product(ctx_s, ws[1]) + bo
    r1 = (o1 if k1 is None else o1 * k1) + x2
    y, xhat1, rstd1 = _ln(r1, g1, be1)
    y_s = sp(y)
    h1 = _product(y_s, ws[2]) + b1
    g_s = sp(0.5 * h1 * (1.0 + torch.erf(h1 * 0.7071067811865476)))
    o2 = _product(g_s, ws[3]) + b2
    r2 = (o2 if k2 is None else o2 * k2) + y
    out, xhat2, rstd2 = _ln(r2, g2, be2)
    return out.reshape(b, n, d), dict(xs=xs, ws=ws, q=q, k=k, v=v, mx=mx, l=l, ctx_s=ctx_s,
                                      v32=heads_of(qkv32[:, 2 * d:]),
                                      xhat1=xhat1, rstd1=rstd1, y_s=y_s, h1=h1, g_s=g_s,
                                      xhat2=xhat2, rstd2=rstd2)


def _split3(t):
    """Three bf16 planes of t: hi, mid = bf16(t - hi), lo = bf16(t - hi - mid)."""
    hi = t.to(torch.bfloat16).float()
    mid = (t - hi).to(torch.bfloat16).float()
    return hi, mid, (t - hi - mid).to(torch.bfloat16).float()


def _product3(a, b):
    """a . b^T of three-plane operands as six bf16 products (hi hi, hi mid,
    mid hi, hi lo, lo hi, mid mid): the scheme of XLA's highest precision."""
    (ah, am, al), (bh, bm, bl) = a, b

    def mm(x, y):
        return x @ y.transpose(-1, -2)

    return ((mm(ah, bh) + mm(ah, bm)) + mm(am, bh)) + ((mm(ah, bl) + mm(al, bh)) + mm(am, bm))


def emulated_backward(x, mask, w, dout, keeps, *, one_pass=False, d_from_ctx=False,
                      dp_planes=2, unshifted=False, saved=None):
    """ctc_bert_layer_bwd_f32: from the forward's kept state (`saved`, the
    second value of emulated_forward on the same inputs: KEPT) or, with
    none, the forward recomputed the same way (its chunks the mask removes
    entirely skipped), then ln_drop_bwd (LN2, keep2), dh1 = (do2 W2) gelu'(h1) (W2's
    planes read MN-major), dW2 | dW1, dy = dr2 + dh1 W1, ln_drop_bwd (LN1,
    keep1), dctx = do1 Wo as planes, the row-term pass D = c + rowsum(p
    (dp - c)) / rowsum(p) from the split dp = (dctx v^T) keep, c each
    row's dp at key 0 as a kept key gives it, the query and key passes (p =
    exp(s - max) / sum, ds = p (dp - D) / 8, dq = ds k, dk = ds^T q, dv = (p
    keep)^T dctx, each product split), dWo | dWqkv, dx = dr1 + dqkv Wqkv;
    the column sums of fp32 values. F8's variants: d_from_ctx, the first
    design's row term rowsum(dctx (ctx_hi + ctx_lo)); dp_planes=3, dp from
    three planes of dctx and v (six bf16 products); F12's: unshifted, the
    second design's rowsum(p dp) over the forward's 1 / sum. Returns the thirteen
    gradients of bert_layer_bwd_plain."""
    ka, k1, k2 = keeps
    b, n, d = x.shape
    dh = d // HEADS
    f = saved if saved is not None else emulated_forward(x, mask, w, keeps, one_pass=one_pass)[1]
    ws = f["ws"]
    g1, g2 = w[4], w[10]

    def sp(t):
        return _split(t, one_pass)

    def heads_of(t):
        return t.reshape(b, n, HEADS, dh).transpose(1, 2)

    def merged(t):
        return t.transpose(1, 2).reshape(b * n, d)

    dout2 = dout.reshape(b * n, d)
    dr2 = _ln_bwd(dout2, f["xhat2"], f["rstd2"], g2)
    do2 = dr2 if k2 is None else dr2 * k2
    do2_s = sp(do2)
    h1 = f["h1"]
    cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
    dh1 = _product(do2_s, _t(ws[3])) * (cdf + h1 * 0.3989422804014327 * torch.exp(-0.5 * h1 * h1))
    dh1_s = sp(dh1)
    dy = dr2 + _product(dh1_s, _t(ws[2]))
    dr1 = _ln_bwd(dy, f["xhat1"], f["rstd1"], g1)
    do1 = dr1 if k1 is None else dr1 * k1
    do1_s = sp(do1)
    dctx = _product(do1_s, _t(ws[1]))
    ctx_s = f["ctx_s"]
    dc = [heads_of(t) for t in sp(dctx)]
    q, k, v = f["q"], f["k"], f["v"]
    s = _product(q, k) / math.sqrt(dh) + mask[:, None, None, :]
    p = torch.exp(s - f["mx"][..., None]) * (1.0 / f["l"])[..., None]
    kf = 1.0 if ka is None else ka
    dp = (_product3(_split3(heads_of(dctx)), _split3(f["v32"])) if dp_planes == 3
          else _product(dc, v))
    dpk = dp * kf
    if d_from_ctx:
        row_term = heads_of(dctx * (ctx_s[0] + ctx_s[1])).sum(-1)
    elif unshifted:
        row_term = (p * dpk).sum(-1)
    else:
        c = dp[..., :1] * (1.0 if ka is None else 1.0 / (1.0 - RATE))
        row_term = c[..., 0] + (p * (dpk - c)).sum(-1) / p.sum(-1)
    ds = p * (dpk - row_term[..., None]) / math.sqrt(dh)
    dq = _product(sp(ds), _t(k))
    dk = _product(sp(ds.transpose(-1, -2)), _t(q))
    dv = _product(sp((p * kf).transpose(-1, -2)), _t(dc))
    dqkv = torch.cat([merged(dq), merged(dk), merged(dv)], dim=-1)
    dqkv_s = sp(dqkv)
    dx = dr1 + _product(dqkv_s, _t(ws[0]))
    return (dx.reshape(b, n, d), _wgrad(dqkv_s, f["xs"]), dqkv.sum(0), _wgrad(do1_s, ctx_s),
            do1.sum(0), (dy * f["xhat1"]).sum(0), dy.sum(0), _wgrad(dh1_s, f["y_s"]),
            dh1.sum(0), _wgrad(do2_s, f["g_s"]), do2.sum(0), (dout2 * f["xhat2"]).sum(0),
            dout2.sum(0))


def _args(seed):
    a = _case(seed)
    args = _torch_bert_args(a)
    return a, args[0], args[1], args[2:]


def _jax_twin_grads(a, g):
    """jax.vjp of the XLA twin at fp32, weights in the port's layout."""
    x, mask, *w = (jnp.asarray(a[k]) for k in BERT_KEYS)
    fn = jax.jit(lambda x_, *w_: jax.vjp(lambda *p: bert_layer_xla(p[0], mask, *p[1:], HEADS, EPS),
                                         x_, *w_)[1](jnp.asarray(g)))
    return [np.asarray(t).T if nm in MATRICES else np.asarray(t) for nm, t in zip(NAMES, fn(x, *w))]


def test_f32_forward_chain_matches_the_pallas_kernel_at_p0():
    a, x, mask, w = _args(60)
    got = emulated_forward(x, mask, w, _keeps(*x.shape, False))[0]
    one = emulated_forward(x, mask, w, _keeps(*x.shape, False), one_pass=True)[0]
    jx, jmask, *jw = (jnp.asarray(a[k]) for k in BERT_KEYS)
    kernel = bert_layer_fused(jx, jmask, jnp.zeros(3, jnp.int32), *jw, HEADS, EPS, 0.0, 0.0,
                              False, True)
    twin = bert_layer_xla(jx, jmask, *jw, HEADS, EPS)
    for want in (kernel, twin, bert_layer_plain(x, mask, *w, HEADS, EPS)):
        assert _rel(got, want) <= BAND
        assert _rel(one, want) > BAND


def test_f32_train_forward_chain_matches_the_plain_version():
    """The three sites through the same Philox masks; controls the one-pass
    chain and the chain with its keep factors left out of P.V."""
    _, x, mask, w = _args(61)
    keeps = _keeps(*x.shape, True)
    got, _ = emulated_forward(x, mask, w, keeps)
    want = bert_layer_plain(x, mask, *w, HEADS, EPS, p_attn=RATE, p_hidden=RATE, train=True,
                            seeds=SEEDS)
    assert _rel(got, want) <= BAND
    assert _rel(emulated_forward(x, mask, w, keeps, one_pass=True)[0], want) > BAND
    assert _rel(emulated_forward(x, mask, w, (None, *keeps[1:]))[0], want) > BAND
    # the masked chunks are skipped: the same bits as walking them
    assert torch.equal(got, emulated_forward(x, mask, w, keeps, skip=False)[0])


def test_f32_backward_chain_matches_the_jax_vjps_at_p0():
    """x and the twelve parameters against jax.vjp of the Pallas kernel in
    interpret mode and of the XLA twin; the one-pass chain misses the band
    in each but dbeta2, the column sums of dout, which no product touches."""
    a, x, mask, w = _args(62)
    g = np.random.default_rng(63).standard_normal(a["x"].shape).astype(np.float32)
    tg = torch.from_numpy(g)
    got = emulated_backward(x, mask, w, tg, _keeps(*x.shape, False))
    one = emulated_backward(x, mask, w, tg, _keeps(*x.shape, False), one_pass=True)
    for want in (_jax_grads(a, g), _jax_twin_grads(a, g)):
        for name, gt, ct, wt in zip(NAMES, got, one, want):
            assert _rel(gt, wt) <= BAND, name
            assert name == "be2" or _rel(ct, wt) > BAND, name


def test_f32_train_backward_chain_matches_the_plain_backward():
    """Dropout at 0.1 on all three sites, the plain backward through the
    same masks: every gradient within the band; the one-pass chain and each
    of the plain backward's faults outside it in some gradient."""
    a, x, mask, w = _args(64)
    tg = torch.from_numpy(np.random.default_rng(65).standard_normal(a["x"].shape)
                          .astype(np.float32))
    keeps = _keeps(*x.shape, True)
    got = emulated_backward(x, mask, w, tg, keeps)
    kw = dict(p_attn=RATE, p_hidden=RATE, train=True, seeds=SEEDS)
    want = bert_layer_bwd_plain(x, mask, *w, tg, HEADS, EPS, **kw)
    for name, gt, wt in zip(NAMES, got, want):
        assert _rel(gt, wt) <= BAND, name
    one = emulated_backward(x, mask, w, tg, keeps, one_pass=True)
    assert max(_rel(ct, wt) for ct, wt in zip(one, want)) > BAND
    for fault in FAULTS:
        faulty = bert_layer_bwd_plain(x, mask, *w, tg, HEADS, EPS, **kw, faults=(fault,))
        assert max(np.abs(np.asarray(gt) - np.asarray(ft)).max() / np.abs(np.asarray(wt)).max()
                   for gt, ft, wt in zip(got, faulty, want)) > BAND, fault


def test_f32_backward_from_the_kept_state_gives_the_rerun_bits():
    """KEPT: the backward from the train forward's kept state (what
    ctc_bert_layer writes under autograd) and the backward that reruns the
    forward (the same chain, the same flags) give every gradient the same
    bits; a state kept without the attention site's keep mask does not."""
    a, x, mask, w = _args(66)
    tg = torch.from_numpy(np.random.default_rng(67).standard_normal(a["x"].shape)
                          .astype(np.float32))
    keeps = _keeps(*x.shape, True)
    _, state = emulated_forward(x, mask, w, keeps)
    rerun = emulated_backward(x, mask, w, tg, keeps)
    kept = emulated_backward(x, mask, w, tg, keeps, saved=state)
    for name, r, k in zip(NAMES, rerun, kept):
        assert torch.equal(r, k), name
    _, other = emulated_forward(x, mask, w, (None, *keeps[1:]))
    stale = emulated_backward(x, mask, w, tg, keeps, saved=other)
    assert not all(torch.equal(r, k) for r, k in zip(rerun, stale))


def test_autograd_keeps_the_forward_state_for_the_fp32_backward(monkeypatch):
    """Through a stand-in library: under autograd an fp32 layer on the
    (stand-in) card reaches ctc_bert_layer with the state's workspaces
    (h1, r2, rowstat and keep not null), and its backward reaches
    ctc_bert_layer_bwd_f32 with flags KEPT and the forward's fifteen
    workspaces: no rerun. Without autograd, and for a direct
    bert_layer_bwd call, nothing is kept and the backward runs the forward
    again (flags without KEPT)."""
    from ct_clip_ut_tpu_torch import _build
    from ct_clip_ut_tpu_torch.ops import bert_layer as bl
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer_grad

    from test_torch_port_f32_hopper import FakeLib

    lib = FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    for name in ("bert_layer_plain", "bert_layer_bwd_plain"):
        monkeypatch.setattr(bl, name, lambda *a, **k: pytest.fail("a plain version ran"))
    _, x, mask, w = _args(68)
    train = dict(p_attn=RATE, p_hidden=RATE, train=True, seeds=SEEDS)
    xg = x.clone().requires_grad_(True)
    bert_layer_grad(xg, mask, *w, HEADS, EPS, **train).sum().backward()
    (fname, fargs), (bname, bargs) = lib.calls
    assert (fname, bname) == ("ctc_bert_layer", "ctc_bert_layer_bwd_f32")
    # x, mask, seeds, 12 weights, then the workspaces: 15 kept, out
    state = fargs[15:30]
    assert all(p is not None for p in state) and len(set(state)) == 15
    # x, mask, seeds, 12 weights, dout, then the workspaces
    assert bargs[16:31] == state
    flags = bargs[-8]             # (..., heads, flags, eps, scale, four dropout args, stream)
    assert flags == bl.FP32_KEPT
    assert fargs[-8] == 0         # the forward: no one-pass, the masked chunks skipped
    lib.calls.clear()
    with torch.no_grad():
        bert_layer_grad(x, mask, *w, HEADS, EPS, **train)
    assert lib.calls[0][1][26:30] == (None,) * 4
    lib.calls.clear()
    bl.bert_layer_bwd(x, mask, *w, torch.zeros_like(x), HEADS, EPS, **train)
    assert lib.calls[0][1][-8] == 0


def test_keep_bits_read_by_the_passes_are_the_philox_masks():
    """attn_kernel<true> writes the keep mask of row i as keep_words(n)
    words, key j at bit 8 (jt % 4) + 2 t + e of word 2 c + jt / 4 (chunk c,
    8-key tile jt, lane quad column t, e = 0, 1); the query pass reads bit
    j % 32 of word j / 32, the key pass bit kloc % 32 of word 2 c +
    kloc / 32 (kloc = j % 64). All three name the same bit, and the bits
    give philox_keep's mask at n = 120 (a ragged last chunk)."""
    n = 120
    words = -(-n // KC) * 2
    mask = philox_keep(SEEDS, 0, 2, HEADS, n * n, RATE).reshape(2, HEADS, n, n) > 0
    bits = torch.zeros((2, HEADS, n, words), dtype=torch.int64)
    for c in range(words // 2):
        for jt in range(8):
            for t in range(4):
                for e in range(2):
                    j = c * KC + 8 * jt + 2 * t + e
                    if j < n:
                        bit, word = 8 * (jt & 3) + 2 * t + e, 2 * c + (jt >> 2)
                        assert (word, bit) == (j // 32, j % 32)
                        kloc = j % KC
                        assert (2 * (j // KC) + (kloc >> 5), kloc & 31) == (word, bit)
                        bits[..., word] |= mask[..., j].long() << bit
    j = torch.arange(n)
    read = (bits[..., j // 32] >> (j % 32)) & 1
    assert torch.equal(read.bool(), mask)


BM = BN = 128
SMS = 132                 # the H100's SMs (the 64-row rule reads the device's count)


def split_quad_tiles(shapes):
    """SplitQuadPlan's tiles for four [rows, cols] weight gradients: (map a,
    map b, i0, j0, out, orow0, nrows), product i on tiles [first_i,
    first_{i+1})."""
    tiles = []
    for i, (rows, cols) in enumerate(shapes):
        ct = -(-cols // BN)
        for u in range(-(-rows // BM) * ct):
            i0, j0 = (u // ct) * BM, (u % ct) * BN
            tiles.append((4 * i, 4 * i + 2, i0, j0, i, i0, min(BM, rows - i0)))
    return tiles


@pytest.mark.parametrize("d,f", [(768, 3072), (256, 512), (384, 200)])
def test_split_pair_plans_write_every_weight_gradient_once(d, f):
    """The four weight gradients' one launch (SplitQuadPlan, which took the
    place of two pair launches): dW2 [d, f], dW1 [f, d], dWo [d, d], dWqkv
    [3d, d], every element of each written by one tile, the hi maps at 4 i
    and 4 i + 2 (lo at + 1); at the train step's widths 432 tiles, four
    rounds of 132 SMs where the two launches took three and two."""
    shapes = ((d, f), (f, d), (d, d), (3 * d, d))
    tiles = split_quad_tiles(shapes)
    assert all(a % 2 == 0 and b % 2 == 0 and a == 4 * out for a, b, _, _, out, _, _ in tiles)
    seen = [np.zeros(sh, np.int64) for sh in shapes]
    for _, _, _, j0, out, orow0, nrows in tiles:
        seen[out][orow0:orow0 + nrows, j0:j0 + BN] += 1
    assert all((v == 1).all() for v in seen)
    if (d, f) == (768, 3072):
        assert len(tiles) == 432 and -(-len(tiles) // SMS) == 4
        assert -(-288 // SMS) + -(-144 // SMS) == 5


def rows64(m, n):
    """split_sm90.cuh's rows64: 64-row tiles below two rounds of 128-row ones."""
    return -(-m // BM) * -(-n // BN) < 2 * SMS


def staged64_product(a, b, slices=(0, 1)):
    """split4_64_kernel's order on planes a [M, K] and b [N, K] (hi, lo):
    per 64-deep K slice a_hi b_lo, a_lo b_hi, a_hi b_hi into the
    accumulator of warpgroup kt % 2, then the two accumulators added. A K
    past the edge reads zeros. `slices` names the warpgroups whose sums are
    kept (the control leaves one out)."""
    (ah, al), (bh, bl) = a, b
    acc = [torch.zeros(ah.shape[0], bh.shape[0]) for _ in range(2)]
    for kt, k0 in enumerate(range(0, ah.shape[1], 64)):
        ks = slice(k0, k0 + 64)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            acc[kt % 2] = acc[kt % 2] + x[:, ks] @ y[:, ks].t()
    return sum(acc[w] for w in slices) if len(slices) == 2 else acc[slices[0]]


@pytest.mark.parametrize("m,n,k", [(1024, 768, 3072), (1024, 768, 768), (1024, 2304, 768),
                                   (130, 200, 200)])
def test_staged_64_row_products_cover_and_match_fp32(m, n, k):
    """The products of a train step's 1,024 rows take 64-row tiles (the
    48-tile N = 768 products become 96), the prompts' 18,432 rows the
    persistent 128-row kernel; each 64 x 128 tile's K slices alternate
    between its two warpgroups, every slice taken once, and the two sums
    added give the fp32 product within the band (K = 200: a ragged last
    slice of zeros); one warpgroup's sums alone miss it."""
    assert rows64(m, n) and not rows64(36 * 512, n)
    if (m, n) == (1024, 768):
        assert -(-m // BM) * -(-n // BN) == 48 and -(-m // 64) * -(-n // BN) == 96
    nk = -(-k // 64)
    taken = sorted(kt for w in range(2) for kt in range(w, nk, 2))
    assert taken == list(range(nk))
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.standard_normal((min(m, 256), k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((min(n, 256), k)).astype(np.float32))
    want = (a.double() @ b.double().t()).float()
    got = staged64_product(_split(a, False), _split(b, False))
    assert _rel(got, want) <= BAND
    assert _rel(staged64_product(_split(a, False), _split(b, False), slices=(0,)), want) > BAND


@functools.lru_cache(maxsize=1)
def _f8_stack():
    """F8's reproduction (the module docstring): two layers at dropout 0,
    tokens 2% apart, a cotangent on the first token. Returns (each layer's
    input, the mask, the weights, the cotangent, each layer's dWqkv by
    jax.vjp of the XLA twins' stack in the port's layout [3d, d], the
    stack's dx)."""
    layers, d = 2, 256
    rng = np.random.default_rng(70)
    cases = [_case(71 + i) for i in range(layers)]
    base = rng.standard_normal((1, 1, d)).astype(np.float32)
    x0 = (base + 0.02 * cases[0]["x"]).astype(np.float32)
    mask = cases[0]["mask"]
    g = np.zeros_like(x0)
    g[:, 0] = rng.standard_normal((x0.shape[0], d))
    ws = [_torch_bert_args(a)[2:] for a in cases]
    tmask = torch.from_numpy(mask)
    xs = [torch.from_numpy(x0)]
    for w in ws[:-1]:
        xs.append(bert_layer_plain(xs[-1], tmask, *w, HEADS, EPS))
    jw = [jnp.asarray(a[k]) for a in cases for k in BERT_KEYS[2:]]

    def stack(y, *flat):
        for i in range(layers):
            y = bert_layer_xla(y, jnp.asarray(mask), *flat[12 * i:12 * i + 12], HEADS, EPS)
        return y

    grads = jax.jit(lambda *f: jax.vjp(stack, *f)[1](jnp.asarray(g)))(jnp.asarray(x0), *jw)
    return (xs, tmask, ws, torch.from_numpy(g),
            [np.asarray(grads[1 + 12 * i]).T for i in range(layers)], np.asarray(grads[0]))


def _f8_stack_errors(plain=False, **scheme):
    """Each layer's query and key weight gradients from the chain (with
    `scheme`'s knobs of emulated_backward; plain: the port's plain fp32
    backward) against the twins' stack, max |diff| over the gradient's
    largest entry: ([layer][q, k], the stack's dx)."""
    xs, tmask, ws, dout, twin, twin_dx = _f8_stack()
    d = dout.shape[-1]
    errs = [None] * len(xs)
    for i in reversed(range(len(xs))):
        got = (bert_layer_bwd_plain(xs[i], tmask, *ws[i], dout, HEADS, EPS) if plain else
               emulated_backward(xs[i], tmask, ws[i], dout, _keeps(*xs[i].shape, False), **scheme))
        errs[i] = [_rel(got[1].numpy()[part], twin[i][part])
                   for part in (slice(0, d), slice(d, 2 * d))]
        dout = got[0]
    return errs, _rel(dout.numpy(), twin_dx)


@pytest.mark.parametrize("scheme,inside", [({}, True), ({"plain": True}, True),
                                           ({"d_from_ctx": True}, False),
                                           ({"d_from_ctx": True, "dp_planes": 3}, False)])
def test_f32_backward_keeps_the_cancelling_query_key_gradients(scheme, inside):
    """F8: the chain's row term from the same split dP keeps every layer's
    query / key gradients within F8_BAND of the XLA twins' stack, as the
    plain fp32 backward does; the first design's (D from dctx and ctx's
    planes) misses it, and a third plane on dP alone (six bf16 products)
    does not bring it back."""
    errs = [e for layer in _f8_stack_errors(**scheme)[0] for e in layer]
    assert (max(errs) <= F8_BAND) == inside, errs


@pytest.mark.parametrize("scheme,inside", [({}, True), ({"plain": True}, True),
                                           ({"one_pass": True}, False)])
def test_f32_backward_close_tokens_within_the_close_band(scheme, inside):
    """F12, F8's stack (two layers at dropout 0, tokens 2% apart, a
    sequence's keys padded after 90, a cotangent on the first token) held
    to the card's CLOSE_BAND (chip_smoke.py phase 15) in each layer's dWq
    and dWk and the stack's dx: the chain's row term D = c + rowsum(p (dp -
    c)) / rowsum(p) and the plain fp32 backward inside, the one-pass chain
    outside. (At this width the second design's unshifted rowsum(p dp)
    read 1.06e-2 in layer 1's dWk; on the H100 at [2, 512, 768] it read
    1.7e-2 / 2.2e-2 against float64, the shifted form 4.2e-3 / 3.3e-3.)"""
    layers, dx = _f8_stack_errors(**scheme)
    errs = [e for layer in layers for e in layer] + [dx]
    assert (max(errs) <= CLOSE_BAND) == inside, errs
