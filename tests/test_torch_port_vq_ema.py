"""The VQ's EMA batch statistics in a fixed order (ops/vq.py
`vq_batch_stats`): the indices sorted stably, counts from the runs, sums
from float64 running sums, no atomics, so the fp32 train step repeats its
codebook bit for bit on the card (chip_smoke.py phase 17 (a) holds it so).

On the CPU they are held against the JAX package's one-hot product
(`ct_clip_ut_tpu.ops.vq.vq_batch_stats`) and its EMA update: counts equal,
sums within 2e-6 of each code's largest entry (the one-hot product's fp32
rounding; the float64 running sums themselves land within 1e-12 of the
exact sum), the updated codebook within 2e-6; two calls the same bits,
and the same bits with the tokens regrouped code by code (each run keeps
its order: the stable sort does, and the sums depend on nothing else)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_clip_ut_tpu.ops import vq as jvq
from ct_clip_ut_tpu_torch.ops import vq as tvq

CODEBOOK, DIM = 64, 32


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assignments(rng, n, kind):
    if kind == "one code":        # a collapsed codebook: every token on code 5
        return np.full((n,), 5, np.int32)
    if kind == "skewed":          # half the tokens on three codes, the rest spread
        hot = rng.integers(0, 3, n // 2)
        return np.concatenate([hot, rng.integers(0, CODEBOOK, n - n // 2)]).astype(np.int32)
    return rng.integers(0, CODEBOOK // 2, n).astype(np.int32)   # half the codes empty


@pytest.mark.parametrize("kind", ["one code", "skewed", "sparse"])
@pytest.mark.parametrize("n", [1, 300, 2048])
def test_vq_batch_stats_fixed_order_matches_jax(kind, n):
    rng = np.random.default_rng(n + len(kind))
    idx = _assignments(rng, n, kind)
    flat = _unit_rows(rng, n, DIM)
    counts, esum = tvq.vq_batch_stats(torch.from_numpy(idx), torch.from_numpy(flat), CODEBOOK)
    jcounts, jsum = jvq.vq_batch_stats(jnp.asarray(idx), jnp.asarray(flat), CODEBOOK)
    assert counts.dtype == torch.float32 and esum.dtype == torch.float32
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    scale = max(float(np.abs(np.asarray(jsum)).max()), 1.0)
    assert np.abs(esum.numpy() - np.asarray(jsum)).max() <= 2e-6 * scale
    exact = np.zeros((CODEBOOK, DIM))
    np.add.at(exact, idx, flat.astype(np.float64))
    assert np.abs(esum.numpy() - exact).max() <= 1e-6 * max(np.abs(exact).max(), 1.0)
    # two calls; the tokens regrouped code by code, each run in its order
    again = tvq.vq_batch_stats(torch.from_numpy(idx), torch.from_numpy(flat), CODEBOOK)
    assert torch.equal(again[0], counts) and torch.equal(again[1], esum)
    keep = np.argsort(idx, kind="stable")
    moved = tvq.vq_batch_stats(torch.from_numpy(idx[keep]), torch.from_numpy(flat[keep]),
                               CODEBOOK)
    assert torch.equal(moved[0], counts) and torch.equal(moved[1], esum)


def test_vq_ema_update_from_fixed_order_stats_matches_jax():
    rng = np.random.default_rng(5)
    n = 1500
    idx = _assignments(rng, n, "skewed")
    flat = _unit_rows(rng, n, DIM)
    embed = _unit_rows(rng, CODEBOOK, DIM)
    avg = rng.standard_normal((CODEBOOK, DIM)).astype(np.float32)
    size = rng.uniform(0.0, 5.0, CODEBOOK).astype(np.float32)
    tstate = tvq.VQState(torch.from_numpy(embed), torch.from_numpy(avg), torch.from_numpy(size))
    jstate = jvq.VQState(embed=jnp.asarray(embed), embed_avg=jnp.asarray(avg),
                         cluster_size=jnp.asarray(size))
    counts, esum = tvq.vq_batch_stats(torch.from_numpy(idx), torch.from_numpy(flat), CODEBOOK)
    got = tvq.vq_ema_update(tstate, counts, esum, decay=0.8, eps=1e-5)
    want = jvq.vq_ema_update(jstate, *jvq.vq_batch_stats(jnp.asarray(idx), jnp.asarray(flat),
                                                         CODEBOOK), decay=0.8, eps=1e-5)
    for g, w in ((got.embed, want.embed), (got.embed_avg, want.embed_avg),
                 (got.cluster_size, want.cluster_size)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-6 * max(np.abs(w).max(), 1.0)
    again = tvq.vq_ema_update(tstate, *tvq.vq_batch_stats(torch.from_numpy(idx),
                                                          torch.from_numpy(flat), CODEBOOK),
                              decay=0.8, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
