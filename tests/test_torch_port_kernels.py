"""The port's six kernel modules (ct_clip_ut_tpu_torch/ops/{attn_block,
attn_packed,geglu_ff,vq_nearest,patch_embed,bert_layer}.py).

On the CPU: each plain PyTorch version against its JAX Pallas kernel run
in interpret mode (as tests/test_pallas.py runs them), at fp32 with atol
2e-5 (the BERT layer 1e-5, also against its XLA twin; the patch embed also
against its `_xla_twin`); VQ indices exactly equal, the first maximum
winning a tie. Each wrapper given CPU tensors takes its plain version,
never builds or loads the CUDA library, and leaves the launch counters at
0.

The card's checks of the same kernels are in test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ct_clip_ut_tpu.ops.pallas_attn_block import attention_block_fused
from ct_clip_ut_tpu.ops.pallas_attn_packed import attention_block_packed
from ct_clip_ut_tpu.ops.pallas_bert_layer import bert_layer_fused, bert_layer_xla
from ct_clip_ut_tpu.ops.pallas_ff import geglu_ff_fused
from ct_clip_ut_tpu.ops.pallas_patch_embed import _xla_twin, patch_embed_fused as jax_patch_embed
from ct_clip_ut_tpu.ops.pallas_vq import vq_nearest_pallas
from ct_clip_ut_tpu_torch import _build
from ct_clip_ut_tpu_torch.ops import launches
from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_plain
from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
from ct_clip_ut_tpu_torch.ops.patch_embed import patch_embed_fused, patch_embed_plain
from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

from test_torch_port_cuda import (BERT_KEYS, _attn_inputs, _bert_inputs, _ff_inputs,
                                  _patch_args, _patch_inputs, _torch_attn_args,
                                  _torch_bert_args, _torch_ff_args, _unit_rows)

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
    assert launches.launch_counts() == {**dict.fromkeys(launches.KERNELS, 0), "geglu_ff": 2}
    assert len(launches.KERNELS) == 15
    launches.reset_launch_counts()
    assert sum(launches.launch_counts().values()) == 0


def test_build_sources_are_the_package_csrc():
    names = {p.name for p in _build.sources()}
    assert names == {"attn_block.cu", "attn_common.cuh", "attn_packed.cu", "gemm_tile.cuh",
                     "geglu_ff.cu", "vq_nearest.cu", "patch_embed.cu", "bert_layer.cu",
                     "attn_bwd.cuh", "attn_block_bwd.cu", "attn_packed_bwd.cu", "bwd_common.cuh",
                     "geglu_ff_bwd.cu", "patch_common.cuh", "patch_embed_dkw.cu",
                     "bert_bf16.cuh", "bert_layer_bf16.cu", "bert_layer_bwd.cu", "peg.cu",
                     "peg_wgrad.cu"}
    assert len(_build.source_hash()) == 16
    assert all(name in _build.SIGNATURES for name in
               ("ctc_attn_block", "ctc_attn_packed", "ctc_geglu_ff", "ctc_vq_nearest",
                "ctc_patch_embed", "ctc_bert_layer", "ctc_attn_block_bwd", "ctc_attn_packed_bwd",
                "ctc_geglu_ff_bwd", "ctc_patch_embed_res", "ctc_patch_embed_dkw",
                "ctc_bert_layer_bf16", "ctc_bert_layer_bwd", "ctc_bert_keep_mask", "ctc_peg",
                "ctc_peg_wgrad"))


# the patch embed at the geometry of tests/test_pallas.py:361-394
PE_PATCH, PE_TPATCH, PE_DIM, PE_SHAPE = 4, 2, 128, (2, 6, 16, 16)


def _jax_fold(a, patch, t_patch):
    """The JAX package's fold (ctvit.py:80-95): (k1d, s1, b1)."""
    w, dim = a["w"], a["w"].shape[1]
    wg = w * a["g1"][:, None]
    k1d = wg.reshape(t_patch * patch, patch, dim).transpose(1, 0, 2)
    return jnp.asarray(k1d), jnp.asarray(wg.sum(0)), jnp.asarray(a["be1"] @ w + a["bias"])


def _patch_embed_both(dtype):
    a = _patch_inputs(np.random.default_rng(10), *PE_SHAPE, PE_PATCH, PE_TPATCH, PE_DIM)
    img = jnp.asarray(a["image"]).astype(dtype)
    jargs = (img, *_jax_fold(a, PE_PATCH, PE_TPATCH), jnp.asarray(a["g2"]), jnp.asarray(a["b2"]))
    kernel = np.asarray(jax_patch_embed(*jargs, PE_PATCH, PE_TPATCH, True), np.float32)
    twin = np.asarray(_xla_twin(*jargs, PE_PATCH, PE_TPATCH), np.float32)
    args = _patch_args(a, PE_PATCH, PE_TPATCH)
    args[0] = args[0].to(getattr(torch, dtype))
    got = patch_embed_plain(*args, PE_PATCH, PE_TPATCH)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 3, 4, 4, PE_DIM)
    return got.float().numpy(), kernel, twin


def test_patch_embed_fold_matches_jax():
    a = _patch_inputs(np.random.default_rng(11), *PE_SHAPE, PE_PATCH, PE_TPATCH, PE_DIM)
    _, kw, s1, b1, _, _ = _patch_args(a, PE_PATCH, PE_TPATCH)
    for got, want in zip((kw, s1, b1), _jax_fold(a, PE_PATCH, PE_TPATCH)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_patch_embed_plain_matches_pallas_kernel_fp32():
    got, kernel, twin = _patch_embed_both("float32")
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, twin, atol=ATOL, rtol=0)


def test_patch_embed_plain_within_bf16_band_of_pallas_kernel():
    """bf16 volume: the plain version squares pixels in fp32 and keeps the
    product in fp32; the Pallas kernel squares in bf16 for its moments and
    the `_xla_twin` rounds the product to bf16. All three round h and the
    output to bf16, so they differ by single bf16 steps of the output
    (measured max 0.0156, one step at |out| in [2, 4)): within 2^-7
    relative plus 2e-2 absolute near zero, and 3e-3 on average (measured
    2.8e-4 against the kernel, 1.3e-3 against the twin)."""
    got, kernel, twin = _patch_embed_both("bfloat16")
    for want in (kernel, twin):
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-2)
        assert np.abs(got - want).mean() <= 3e-3


@pytest.mark.parametrize("lengths", [[16, 9, 1], [16, 16, 16]])
def test_bert_layer_plain_matches_pallas_kernel(lengths):
    """fp32, 4 heads of 32, padded key rows (9 and 1 real keys)."""
    a = _bert_inputs(np.random.default_rng(12), 3, 16, 128, 256, lengths)
    x, mask, *w = (jnp.asarray(a[k]) for k in BERT_KEYS)
    kernel = bert_layer_fused(x, mask, jnp.zeros(3, jnp.int32), *w, 4, 1e-12, 0.0, 0.0, False,
                              True)
    twin = bert_layer_xla(x, mask, *w, 4, 1e-12)
    got = bert_layer_plain(*_torch_bert_args(a), 4, 1e-12)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), atol=1e-5, rtol=0)


@pytest.mark.parametrize("train,p_attn,p_hidden", [(True, 0.1, 0.1), (False, 0.1, 0.0),
                                                   (False, 0.0, 0.1), (True, 0.0, 0.0)])
def test_bert_layer_dropout_and_train_mode_raise(train, p_attn, p_hidden):
    """Dropout acts only in train mode at a rate > 0, and then needs the
    layer's seeds: without them the call raises; every other combination is
    the deterministic layer. On the card an fp32 layer with dropout has no
    kernel and raises, naming its ROADMAP item."""
    args = _torch_bert_args(_bert_inputs(np.random.default_rng(13), 1, 8, 64, 128, [8]))
    kw = dict(p_attn=p_attn, p_hidden=p_hidden, train=train)
    for fn in (bert_layer, bert_layer_plain):
        if train and (p_attn > 0 or p_hidden > 0):
            with pytest.raises(ValueError, match="seeds"):
                fn(*args, 1, 1e-12, **kw)
        else:
            assert torch.equal(fn(*args, 1, 1e-12, **kw), bert_layer_plain(*args, 1, 1e-12))


def test_bert_layer_fp32_dropout_has_no_kernel(monkeypatch):
    args = _torch_bert_args(_bert_inputs(np.random.default_rng(13), 1, 8, 64, 128, [8]))
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    with pytest.raises(NotImplementedError, match="Queue 2 item 8b"):
        bert_layer(*args, 1, 1e-12, p_attn=0.1, p_hidden=0.1, train=True,
                   seeds=torch.zeros(3, dtype=torch.int32))


def test_bert_layer_takes_fp32_only():
    """fp32 and, since the train slice, bf16: any other dtype raises."""
    args = _torch_bert_args(_bert_inputs(np.random.default_rng(14), 1, 8, 64, 128, [8]))
    assert bert_layer(args[0].bfloat16(), *args[1:], 1, 1e-12).dtype == torch.bfloat16
    args[0] = args[0].half()
    for fn in (bert_layer, bert_layer_plain):
        with pytest.raises(TypeError, match="fp32 or bf16"):
            fn(*args, 1, 1e-12)


def test_new_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """patch_embed and bert_layer on CPU tensors: the plain versions, no
    library load, no launch counted."""
    def no_load():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_load)
    launches.reset_launch_counts()
    a = _patch_inputs(np.random.default_rng(15), *PE_SHAPE, PE_PATCH, PE_TPATCH, PE_DIM)
    args = _patch_args(a, PE_PATCH, PE_TPATCH)
    assert torch.equal(patch_embed_fused(*args, PE_PATCH, PE_TPATCH),
                       patch_embed_plain(*args, PE_PATCH, PE_TPATCH))
    bargs = _torch_bert_args(_bert_inputs(np.random.default_rng(16), 2, 8, 64, 128, [8, 3]))
    assert torch.equal(bert_layer(*bargs, 2, 1e-12), bert_layer_plain(*bargs, 2, 1e-12))
    assert launches.launch_counts() == dict.fromkeys(launches.KERNELS, 0)
