"""The BERT layer of the 512-token train step, on the CPU
(ct_clip_ut_tpu_torch/ops/bert_layer.py, models/bert.py).

At D = 256, 4 heads of 64, n = 128, F = 512, inputs from a numpy seed:
`bert_layer_plain` (fp32 and bf16, deterministic) against the Pallas kernel
in interpret mode and its XLA twin, as tests/test_pallas.py:656-665 runs
them; every gradient (autograd through the plain forward, the plain
backward, the autograd Function) against jax.vjp of the Pallas kernel in
interpret mode (tests/test_pallas.py:668-692). The dropout generator
against an independent numpy Philox4x32-10 and Random123's known answer.
Train mode has no JAX twin on the CPU (the Pallas interpreter's PRNG is a
stub, tests/test_pallas.py:700-704): it is held to its own properties, and
its gradient through the masks to a finite difference, as
tests/test_pallas.py:720-736 does on the chip. Then the fused route of
models/bert.py called directly on CPU tensors. Tolerances: fp32 2e-5
forward and 1e-3 gradients (test_pallas.py's bands), bf16 1.5e-2 max
relative (the JAX package's bf16 kernel band).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_bert_layer import bert_layer_fused, bert_layer_xla
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.models import bert as tbert
from ct_clip_ut_tpu_torch.ops import bert_layer as bl
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.bert_layer import (bert_layer, bert_layer_bwd,
                                                 bert_layer_bwd_plain, bert_layer_grad,
                                                 bert_layer_plain, philox_keep)

from test_torch_port_cuda import BERT_KEYS, _bert_inputs, _torch_bert_args
from test_torch_port_modules import GATE_BERT, gate_bert_pair

D, HEADS, N, F, EPS = 256, 4, 128, 512, 1e-12
BF16_BAND = 1.5e-2
NAMES = "x wqkv bqkv wo bo g1 be1 w1 b1 w2 b2 g2 be2".split()
MATRICES = ("wqkv", "wo", "w1", "w2")


def _case(seed, b=2, lengths=(N, 90)):
    return _bert_inputs(np.random.default_rng(seed), b, N, D, F, list(lengths))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.detach().float().numpy()


# -- deterministic forward and gradients against the JAX package ------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_layer_plain_matches_pallas_kernel_and_twin(dtype):
    a = _case(40)
    x, mask, *w = (jnp.asarray(a[k]) for k in BERT_KEYS)
    x = x.astype(dtype)
    kernel = bert_layer_fused(x, mask, jnp.zeros(3, jnp.int32), *w, HEADS, EPS, 0.0, 0.0, False,
                              True)
    twin = bert_layer_xla(x, mask, *w, HEADS, EPS)
    args = _torch_bert_args(a)
    args[0] = args[0].to(getattr(torch, dtype))
    got = bert_layer_plain(*args, HEADS, EPS)
    assert got.dtype == getattr(torch, dtype)
    for want in (kernel, twin):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5)
        else:
            assert _rel(_np(got), want) <= BF16_BAND


def _jax_grads(a, g, dtype=jnp.float32):
    x, mask, *w = (jnp.asarray(a[k]) for k in BERT_KEYS)
    seeds = jnp.zeros(3, jnp.int32)
    out, vjp = jax.vjp(lambda x_, *w_: bert_layer_fused(x_, mask, seeds, *w_, HEADS, EPS, 0.0,
                                                        0.0, False, True), x.astype(dtype), *w)
    grads = vjp(jnp.asarray(g).astype(out.dtype))
    # the port's layouts: the weight matrices (out, in)
    return [np.asarray(t, np.float32).T if nm in MATRICES else np.asarray(t, np.float32)
            for nm, t in zip(NAMES, grads)]


@pytest.mark.parametrize("route", ["autograd of the plain forward", "plain backward",
                                   "autograd Function"])
def test_bert_layer_gradients_match_pallas_backward_kernel(route):
    """x and the twelve parameters, fp32, against `_bwd_impl` in interpret mode."""
    a = _case(41)
    g = np.random.default_rng(42).standard_normal(a["x"].shape).astype(np.float32)
    want = _jax_grads(a, g)
    args = _torch_bert_args(a)
    if route == "plain backward":
        got = bert_layer_bwd_plain(*args, torch.from_numpy(g), HEADS, EPS)
    else:
        leaves = [args[0].requires_grad_(True)] + [t.requires_grad_(True) for t in args[2:]]
        fn = bert_layer_plain if route.startswith("autograd of") else bert_layer_grad
        fn(leaves[0], args[1], *leaves[1:], HEADS, EPS).backward(torch.from_numpy(g))
        got = [t.grad for t in leaves]
    assert len(got) == len(want) == 13
    for name, x, y in zip(NAMES, got, want):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(_np(x), y, atol=1e-3, rtol=1e-3, err_msg=name)


def test_bert_layer_function_backward_bf16_within_band_of_pallas_kernel():
    """bf16 activations, fp32 leaves: dx comes back in bf16, the parameter
    gradients in fp32, all within the bf16 band of the Pallas backward."""
    a = _case(43)
    g = np.random.default_rng(44).standard_normal(a["x"].shape).astype(np.float32)
    want = _jax_grads(a, g, jnp.bfloat16)
    args = _torch_bert_args(a)
    x = args[0].bfloat16().requires_grad_(True)
    leaves = [t.requires_grad_(True) for t in args[2:]]
    out = bert_layer_grad(x, args[1], *leaves, HEADS, EPS)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).bfloat16())
    assert x.grad.dtype == torch.bfloat16
    for name, t, y in zip(NAMES, [x] + leaves, want):
        assert t.grad.dtype == t.dtype
        assert _rel(_np(t.grad), y) <= BF16_BAND, name


def test_plain_backward_matches_autograd_through_the_masks():
    """The written-out backward and autograd agree through the same dropout
    masks: fp32 to rounding, bf16 within the band (autograd rounds a few
    cotangents where the TPU kernel keeps fp32)."""
    a = _case(45)
    g = torch.from_numpy(np.random.default_rng(46).standard_normal(a["x"].shape)
                         .astype(np.float32))
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32)
    kw = dict(p_attn=0.25, p_hidden=0.25, train=True, seeds=seeds)
    for dt, band in ((torch.float32, 1e-5), (torch.bfloat16, BF16_BAND)):
        args = _torch_bert_args(a)
        x = args[0].to(dt).requires_grad_(True)
        leaves = [t.requires_grad_(True) for t in args[2:]]
        bert_layer_plain(x, args[1], *leaves, HEADS, EPS, **kw).backward(g.to(dt))
        got = bert_layer_bwd_plain(x.detach(), args[1], *(t.detach() for t in leaves), g.to(dt),
                                   HEADS, EPS, **kw)
        for name, m, leaf in zip(NAMES, got, [x] + leaves):
            assert _rel(_np(m), _np(leaf.grad)) <= band, (dt, name)


# -- the dropout generator ---------------------------------------------------

def _np_philox(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., Random123)."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32-10: the zero counter and key,
    and all ones."""
    assert _np_philox([0] * 4, [0] * 2) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _np_philox([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [0x408F276D, 0x41C83B0E,
                                                              0xA20BC7C6, 0x6D5451FD]
    for ctr, key in (([0] * 4, [0] * 2), ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2),
                     ([7, 1, 2, 3], [0x7FFFFFFE, 0])):
        words = bl.philox4x32(*(torch.tensor([v], dtype=torch.int64) for v in ctr + key))
        assert [int(w) for w in words] == _np_philox(ctr, key)


@pytest.mark.parametrize("site,b,heads,inner,rate", [(0, 2, 3, 64, 0.1), (1, 3, 1, 40, 0.5),
                                                     (2, 1, 1, 8, 0.25)])
def test_philox_keep_matches_an_independent_philox(site, b, heads, inner, rate):
    """Position i of slab (sequence, head) takes word i % 4 of the block at
    counter (i // 4, site, sequence, head), key (seed, 0); kept iff its bits
    reach uint32(min(int(rate * 2^32), 2^32 - 1)), scaled by 1 / (1 - rate)."""
    seeds = torch.tensor([123456789, 2 ** 31 - 2, 5], dtype=torch.int32)
    got = philox_keep(seeds, site, b, heads, inner, rate)
    assert got.shape == (b, heads, inner) and got.dtype == torch.float32
    thresh = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    want = np.zeros((b, heads, inner), np.float32)
    for s in range(b):
        for h in range(heads):
            for i in range(inner):
                bits = _np_philox([i // 4, site, s, h], [int(seeds[site]), 0])[i % 4]
                want[s, h, i] = np.float32(1.0 / (1.0 - rate)) if bits >= thresh else 0.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_philox_keep_share_and_threshold_rule():
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    for rate in (0.1, 0.25):
        keep = philox_keep(seeds, 0, 2, 4, 128 * 128, rate)
        share, count = (keep > 0).float().mean().item(), keep.numel()
        assert abs(share - (1 - rate)) <= 4 * (rate * (1 - rate) / count) ** 0.5
    assert bl.dropout_threshold(0.1) == int(0.1 * 2 ** 32)
    assert bl.dropout_threshold(1.0) == 2 ** 32 - 1
    assert (philox_keep(seeds, 1, 1, 1, 64, 1e-12) > 0).all()      # threshold 0 keeps all
    with pytest.raises(ValueError, match="multiple of 4"):
        philox_keep(seeds, 0, 1, 1, 6, 0.1)
    assert torch.equal(bl.keep_mask(seeds, 2, 2, 1, 64, 0.1), philox_keep(seeds, 2, 2, 1, 64, 0.1))


# -- train mode --------------------------------------------------------------

def test_bert_layer_train_mode_dropout():
    """Same seeds: the same bits; other seeds: another output; rate 0 in
    train mode, or rates without train mode: the deterministic layer; each
    site's seed moves the output on its own."""
    args = _torch_bert_args(_case(47))
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32)
    kw = dict(p_attn=0.25, p_hidden=0.25, train=True)
    det = bert_layer_plain(*args, HEADS, EPS)
    out = bert_layer_plain(*args, HEADS, EPS, seeds=seeds, **kw)
    assert torch.equal(out, bert_layer_plain(*args, HEADS, EPS, seeds=seeds.clone(), **kw))
    assert (out - det).abs().max() > 1e-3
    for site in range(3):
        other = seeds.clone()
        other[site] += 1
        assert (bert_layer_plain(*args, HEADS, EPS, seeds=other, **kw) - out).abs().max() > 1e-3
    assert torch.equal(bert_layer_plain(*args, HEADS, EPS, p_attn=0.0, p_hidden=0.0, train=True),
                       det)
    assert torch.equal(bert_layer_plain(*args, HEADS, EPS, p_attn=0.25, p_hidden=0.25,
                                        train=False, seeds=seeds), det)
    assert torch.equal(bert_layer(*args, HEADS, EPS, seeds=seeds, **kw), out)


@pytest.mark.parametrize("route", ["plain backward", "autograd Function"])
def test_bert_layer_dropout_gradient_matches_finite_difference(route):
    """The analytic gradient through the regenerated masks against a central
    difference of the fp32 forward through the same masks
    (tests/test_pallas.py:720-736), sums in float64."""
    a = _case(48, b=1, lengths=(100,))
    args = _torch_bert_args(a)
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32)
    kw = dict(p_attn=0.25, p_hidden=0.25, train=True, seeds=seeds)
    rng = np.random.default_rng(49)
    r = torch.from_numpy(rng.standard_normal(a["x"].shape).astype(np.float32))
    v = torch.from_numpy((1e-2 * rng.standard_normal(a["x"].shape)).astype(np.float32))
    if route == "plain backward":
        dx = bert_layer_bwd_plain(*args, r, HEADS, EPS, **kw)[0]
    else:
        x = args[0].clone().requires_grad_(True)
        bert_layer_grad(x, *args[1:], HEADS, EPS, **kw).backward(r)
        dx = x.grad

    def f(x):
        return bert_layer_plain(x, *args[1:], HEADS, EPS, **kw).double()

    fd = ((f(args[0] + v) - f(args[0] - v)) * r.double()).sum().item()
    analytic = 2.0 * (dx.double() * v.double()).sum().item()
    np.testing.assert_allclose(fd, analytic, rtol=2e-3)


def test_bert_layer_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach the CUDA library and never count a launch."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    args = _torch_bert_args(_case(50))
    args[0] = args[0].bfloat16()
    seeds = torch.tensor([4, 5, 6], dtype=torch.int32)
    kw = dict(p_attn=0.1, p_hidden=0.1, train=True, seeds=seeds)
    assert torch.equal(bert_layer(*args, HEADS, EPS, **kw), bert_layer_plain(*args, HEADS, EPS, **kw))
    g = torch.randn(args[0].shape).bfloat16()
    for x, y in zip(bert_layer_bwd(*args, g, HEADS, EPS, **kw),
                    bert_layer_bwd_plain(*args, g, HEADS, EPS, **kw)):
        assert torch.equal(x, y)
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)


def test_bert_layer_kernel_shape_limits_raise(monkeypatch):
    """What the chains cannot take raises before any launch: heads of
    another width than 64, more tokens than a shared-memory score row holds
    (bf16); a width that 128 does not divide in the fp32 backward (its row
    term's epilogue takes two heads a 128-column tile)."""
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    args = _torch_bert_args(_bert_inputs(np.random.default_rng(51), 1, 8, 64, 128, [8]))
    args[0] = args[0].bfloat16()
    with pytest.raises(ValueError, match="heads of 64"):
        bert_layer(*args, 2, EPS)
    long = _torch_bert_args(_bert_inputs(np.random.default_rng(52), 1, 680, 64, 128, [680]))
    long[0] = long[0].bfloat16()
    with pytest.raises(ValueError, match="at most 672 tokens"):
        bert_layer(*long, 1, EPS)
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="a width that 128 divides"):
        bert_layer_bwd(*args, torch.zeros_like(args[0]), 1, EPS)


# -- the fused route of models/bert.py ---------------------------------------

DROP_BERT = dataclasses.replace(tbert.BertConfig(**dataclasses.asdict(GATE_BERT)),
                                hidden_dropout=0.2, attention_dropout=0.2)


def _route_inputs(n=128):
    rng = np.random.default_rng(53)
    ids = torch.from_numpy(rng.integers(0, GATE_BERT.vocab_size, (2, n)))
    mask = torch.ones((2, n), dtype=torch.int64)
    mask[1, 70:] = 0
    return ids, mask


@pytest.fixture
def drop_bert():
    _, mod = gate_bert_pair()
    mod.cfg, saved = DROP_BERT, mod.cfg
    yield mod
    mod.cfg = saved


def test_embedding_dropout_feeds_both_routes(drop_bert, monkeypatch):
    """The embeddings are dropped before the gate: from one generator state
    `embed` gives the layer loop and the fused layers the same dropped
    embeddings, at the hidden rate; bert_apply through the fused route is
    `embed` then `fused_layers`."""
    ids, mask = _route_inputs()
    tt = torch.zeros_like(ids)
    det = tbert.embed(drop_bert, ids, tt, torch.float32)
    a = tbert.embed(drop_bert, ids, tt, torch.float32, torch.Generator().manual_seed(3), False)
    b = tbert.embed(drop_bert, ids, tt, torch.float32, torch.Generator().manual_seed(3), False)
    assert torch.equal(a, b)
    dropped = (a == 0).float().mean().item()
    assert abs(dropped - 0.2) < 0.01
    torch.testing.assert_close(a[a != 0], det[a != 0] / 0.8)

    monkeypatch.setattr(tbert, "takes_fused_layers", lambda x, cfg, n: True)
    gen = torch.Generator().manual_seed(3)
    whole = tbert.bert_apply(drop_bert, ids, mask, generator=gen, deterministic=False)
    gen = torch.Generator().manual_seed(3)
    x = tbert.embed(drop_bert, ids, tt, torch.float32, gen, False)
    assert torch.equal(x, a)
    mask_row = (1.0 - mask.float()) * torch.finfo(torch.float32).min
    parts = tbert.fused_layers(drop_bert, x, mask_row, plain=True, generator=gen,
                               deterministic=False)
    assert torch.equal(whole, parts)
    # the layer loop's first layer reads the same tensor: its first draw is the embedding mask
    monkeypatch.setattr(tbert, "takes_fused_layers", lambda x, cfg, n: False)
    seen = []
    real = tbert.linear

    def spy(x, w, bias=None):
        seen.append(x)
        return real(x, w, bias)

    monkeypatch.setattr(tbert, "linear", spy)
    tbert.bert_apply(drop_bert, ids, mask, generator=torch.Generator().manual_seed(3),
                     deterministic=False)
    assert torch.equal(seen[0], a)


def test_fused_route_train_mode_on_cpu(drop_bert, monkeypatch):
    """Train mode through fused_layers on CPU tensors: three seeds a layer
    from the generator; the same generator state gives the same output and
    gradients, through the Function and through plain=True alike; a restored
    generator state (as a checkpoint restores it) repeats the step; another
    state does not; without a generator it raises."""
    ids, mask = _route_inputs()
    tt = torch.zeros_like(ids)
    mask_row = (1.0 - mask.float()) * torch.finfo(torch.float32).min
    drawn = []
    real = tbert.draw_seeds

    def spy(generator, device):
        drawn.append(real(generator, device))
        return drawn[-1]

    monkeypatch.setattr(tbert, "draw_seeds", spy)

    def step(gen, plain):
        drop_bert.zero_grad()
        x = tbert.embed(drop_bert, ids, tt, torch.float32, gen, False)
        out = tbert.fused_layers(drop_bert, x, mask_row, plain=plain, generator=gen,
                                 deterministic=False)
        out.square().mean().backward()
        return out.detach(), {k: p.grad.clone() for k, p in drop_bert.named_parameters()
                              if p.grad is not None}

    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    out_a, grads_a = step(gen, False)
    assert len(drawn) == GATE_BERT.num_layers
    assert all(s.shape == (3,) and s.dtype == torch.int32 and (s >= 0).all() for s in drawn)
    assert not torch.equal(drawn[0], drawn[1])
    after = gen.get_state()
    out_next, _ = step(gen, False)                       # the generator moved on
    assert not torch.equal(out_next, out_a)
    gen.set_state(state)
    out_b, grads_b = step(gen, False)
    assert torch.equal(out_a, out_b) and torch.equal(gen.get_state(), after)
    assert grads_a.keys() == grads_b.keys() and len(grads_a) > 20
    for k in grads_a:
        if k.endswith(("word_embeddings.weight", "token_type_embeddings.weight")):
            # gathered tables: the CPU's scatter-add sums in thread order
            torch.testing.assert_close(grads_a[k], grads_b[k], rtol=1e-6, atol=1e-12)
        else:
            assert torch.equal(grads_a[k], grads_b[k]), k
    gen.set_state(state)
    out_p, grads_p = step(gen, True)
    assert torch.equal(out_p, out_a)
    for k in grads_a:
        torch.testing.assert_close(grads_p[k], grads_a[k], rtol=1e-4, atol=1e-6)
    eval_out = tbert.fused_layers(drop_bert, tbert.embed(drop_bert, ids, tt, torch.float32),
                                  mask_row)
    assert (eval_out - out_a).abs().max() > 1e-2
    with pytest.raises(ValueError, match="Generator"):
        tbert.fused_layers(drop_bert, eval_out, mask_row, deterministic=False)
