"""The port's four kernel modules (ct_clip_ut_tpu_torch/ops/{attn_block,
attn_packed,geglu_ff,vq_nearest}.py).

On the CPU: each plain PyTorch version against its JAX Pallas kernel run
in interpret mode (as tests/test_pallas.py runs them), at fp32 with atol
2e-5; VQ indices exactly equal, the first maximum winning a tie. Each
wrapper given CPU tensors takes its plain version, never builds or loads
the CUDA library, and leaves the launch counters at 0.

The card's checks of the same kernels are in test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_attn_block import attention_block_fused
from ct_clip_ut_tpu.ops.pallas_attn_packed import attention_block_packed
from ct_clip_ut_tpu.ops.pallas_ff import geglu_ff_fused
from ct_clip_ut_tpu.ops.pallas_vq import vq_nearest_pallas
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

from test_torch_port_cuda import (_attn_inputs, _ff_inputs, _torch_attn_args, _torch_ff_args,
                                  _unit_rows)

ATOL = 2e-5


@pytest.mark.parametrize("residual", [False, True])
def test_attn_block_plain_matches_pallas_kernel(residual):
    a = _attn_inputs(np.random.default_rng(0), r=3, n=16, d=32, heads=4, dh=8, with_bias=True)
    want = attention_block_fused(
        *(jnp.asarray(a[k]) for k in ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks", "bias")),
        8.0, True, residual)
    got = attn_block_plain(*_torch_attn_args(a), torch.from_numpy(a["bias"]), 8.0, residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("residual", [False, True])
def test_attn_packed_plain_matches_pallas_kernel(residual):
    a = _attn_inputs(np.random.default_rng(1), r=6, n=12, d=32, heads=4, dh=8, with_bias=False)
    want = attention_block_packed(
        *(jnp.asarray(a[k]) for k in ("x", "gamma", "wq", "wk", "wv", "wo", "qs", "ks")),
        8.0, True, residual)
    got = attn_packed_plain(*_torch_attn_args(a), 8.0, residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("residual", [False, True])
def test_geglu_ff_plain_matches_pallas_kernel(residual):
    a = _ff_inputs(np.random.default_rng(2))
    want = geglu_ff_fused(*(jnp.asarray(a[k]) for k in ("x", "gamma", "beta", "wv", "wg", "w2")),
                          True, residual)
    got = geglu_ff_plain(*_torch_ff_args(a), residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vq_nearest_plain_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    codebook, tokens = _unit_rows(rng, (2048, 32)), _unit_rows(rng, (300, 32))
    want = vq_nearest_pallas(jnp.asarray(tokens), jnp.asarray(codebook), tm=128, tc=512,
                             interpret=True)
    got = vq_nearest_plain(torch.from_numpy(tokens), torch.from_numpy(codebook))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vq_nearest_first_max_wins_a_tie():
    base = np.ones((1, 16), np.float32) / 4.0
    codebook = np.concatenate([base, -base, base] + [-base] * 1021)   # duplicates at 0 and 2
    pallas = vq_nearest_pallas(jnp.asarray(base), jnp.asarray(codebook), tm=8, tc=256,
                               interpret=True)
    got = vq_nearest_plain(torch.from_numpy(base), torch.from_numpy(codebook), chunk=1)
    assert int(pallas[0]) == 0 and int(got[0]) == 0


def test_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach the CUDA library and never count a launch."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    rng = np.random.default_rng(4)
    a = _attn_inputs(rng, r=2, n=16, d=32, heads=4, dh=8, with_bias=True)
    args, bias = _torch_attn_args(a), torch.from_numpy(a["bias"])
    assert torch.equal(attn_block(*args, bias, 8.0, True),
                       attn_block_plain(*args, bias, 8.0, True))
    assert torch.equal(attn_packed(*args, 8.0, True), attn_packed_plain(*args, 8.0, True))
    ff = _torch_ff_args(_ff_inputs(rng))
    assert torch.equal(geglu_ff(*ff, residual=True), geglu_ff_plain(*ff, residual=True))
    tok, cb = torch.from_numpy(_unit_rows(rng, (40, 16))), torch.from_numpy(_unit_rows(rng, (64, 16)))
    assert torch.equal(vq_nearest(tok, cb), vq_nearest_plain(tok, cb))
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)


def test_wrappers_refuse_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        vq_nearest(x, x)


def test_launch_counters_count_and_reset():
    launches.reset_launch_counts()
    launches.count("geglu_ff")
    launches.count("geglu_ff")
    assert launches.launch_counts() == {"attn_block": 0, "attn_packed": 0, "geglu_ff": 2,
                                        "vq_nearest": 0}
    launches.reset_launch_counts()
    assert sum(launches.launch_counts().values()) == 0


def test_build_sources_are_the_package_csrc():
    names = {p.name for p in _build.sources()}
    assert names == {"attn_block.cu", "attn_common.cuh", "attn_packed.cu", "gemm_tile.cuh",
                     "geglu_ff.cu", "vq_nearest.cu"}
    assert len(_build.source_hash()) == 16
    assert all(name in _build.SIGNATURES for name in
               ("ctc_attn_block", "ctc_attn_packed", "ctc_geglu_ff", "ctc_vq_nearest"))
