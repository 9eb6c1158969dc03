"""The port's zero-shot slice as a whole, against the JAX package on the CPU,
plus the properties the card relies on: the port imports no JAX, and
chip_smoke.py refuses to report without a GPU.

Small geometry of tests/test_torch_reference_parity.py (see
test_torch_port_modules.py), shared weights through convert.from_jax_params.
The default configuration (conv patch embed, prompts tokenised padded to a
fixed length) runs on a text tower whose positions reach 128 tokens.
"""

import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import BertConfig
from ct_clip_ut_tpu.infer import zeroshot as jz
from ct_clip_ut_tpu.models.ctclip import init_ctclip as jax_init_ctclip
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu.models import ctvit as jctvit
from ct_clip_ut_tpu.models.ctclip import encode_image_latents as jax_image_latents
from ct_clip_ut_tpu_torch.infer import zeroshot as tz
from ct_clip_ut_tpu_torch.models import ctvit as tctvit
from ct_clip_ut_tpu_torch.models.ctclip import encode_image_latents
from ct_clip_ut_tpu_torch.ops import launches

from ct_clip_ut_tpu_torch.utils import metrics as port_metrics

from test_torch_port_modules import (DEPTH, IMG, PATCH, SMALL_CLIP, SMALL_VIT_CONV, T_PATCH,
                                     jax_and_port_models, port_config)

REPO = Path(__file__).resolve().parent.parent
N_PROMPT = 12


@pytest.fixture(scope="module")
def setup():
    params, model = jax_and_port_models()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL_CLIP.bert.vocab_size, (36, N_PROMPT))
    mask = np.ones_like(ids)
    mask[::5, 9:] = 0                                   # some padded prompts
    images = rng.standard_normal((4, 1, DEPTH, IMG, IMG)).astype(np.float32)
    return params, model, ids, mask, images


def _prompts_jax(ids, mask):
    return {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}


def _prompts_torch(ids, mask):
    return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}


def test_prompt_texts_match():
    assert tz.prompt_texts() == jz.prompt_texts()
    assert len(tz.prompt_texts()) == 36


def test_zeroshot_fp32_matches_jax(setup):
    params, model, ids, mask, images = setup
    jl = jz.encode_prompt_latents(params, SMALL_CLIP, _prompts_jax(ids, mask))
    tl = tz.encode_prompt_latents(model, _prompts_torch(ids, mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    jp = jz.zeroshot_probs(params, SMALL_CLIP, jnp.asarray(images), jl, compute_dtype="float32")
    tp = tz.zeroshot_probs(model, torch.from_numpy(images), tl, compute_dtype=torch.float32)
    assert tp.shape == (4, 18)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    ji, _ = jax_image_latents(params, SMALL_CLIP, jnp.asarray(images))
    ti, _ = encode_image_latents(model, torch.from_numpy(images))
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), atol=1e-5, rtol=0)


def test_zeroshot_bf16_within_band_of_jax(setup):
    """bf16 bands. The two sides round at different points: the port follows
    the TPU kernels (fp32 q/k/v and value/gate, VQ similarities on bf16
    tokens) while JAX's CPU path rounds each projection to bf16 and scores
    VQ in fp32. So the fair check is against the fp32 result: the port's
    bf16 encoder output (before VQ) must sit no further from JAX's fp32
    output than JAX's own bf16 output does, within 1.25x (measured 1.08x:
    mean abs 0.032 vs 0.030). The probabilities then differ from JAX's
    bf16 ones through a few flipped VQ near-ties of this geometry's
    32-code, 16-wide codebook: within 0.15 (measured 0.076)."""
    params, model, ids, mask, images = setup
    vp, cfg = params["visual_transformer"], SMALL_CLIP.ctvit

    def jax_encoder(img):
        tok = jctvit._patch_embed(vp["to_patch_emb"], jctvit.patchify(img, PATCH, T_PATCH))
        return np.asarray(jctvit.ctvit_encode(vp, cfg, tok)[0], np.float32)

    ref = jax_encoder(jnp.asarray(images))
    jax_bf16 = jax_encoder(jnp.asarray(images).astype(jnp.bfloat16))
    vit = model.visual_transformer
    with torch.no_grad():
        tok = tctvit._patch_embed(vit.to_patch_emb, tctvit.patchify(
            torch.from_numpy(images).bfloat16(), PATCH, T_PATCH))
        port_bf16 = tctvit.ctvit_encode(vit, tok)[0]
    assert port_bf16.dtype == torch.bfloat16
    port_err = np.abs(port_bf16.float().numpy() - ref).mean()
    assert port_err <= 1.25 * np.abs(jax_bf16 - ref).mean()

    jl = jz.encode_prompt_latents(params, SMALL_CLIP, _prompts_jax(ids, mask))
    tl = tz.encode_prompt_latents(model, _prompts_torch(ids, mask))
    jp = jz.zeroshot_probs(params, SMALL_CLIP, jnp.asarray(images), jl)
    tp = tz.zeroshot_probs(model, torch.from_numpy(images), tl)
    assert np.abs(tp.numpy() - np.asarray(jp, np.float32)).max() <= 0.15


def test_inference_predict_matches_per_batch_scores(setup):
    _, model, ids, mask, images = setup
    labels = np.random.default_rng(1).integers(0, 2, (4, 18))
    data = [(images[:2], None, labels[:2], "a"), (images[2:], None, labels[2:], "b")]
    runner = tz.CTClipInference(model, _prompts_torch(ids, mask), data,
                                compute_dtype=torch.float32)
    launches.reset_launch_counts()
    preds, targets = runner.predict()
    assert sum(launches.launch_counts().values()) == 0     # CPU: plain versions only
    latents = tz.encode_prompt_latents(model, _prompts_torch(ids, mask))
    want = tz.zeroshot_probs(model, torch.from_numpy(images), latents, torch.float32)
    np.testing.assert_allclose(preds, want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(targets, labels)
    assert runner.prompt_latents() is runner.prompt_latents()  # encoded once


def test_plain_flag_gives_the_same_numbers_on_cpu(setup):
    _, model, ids, mask, images = setup
    latents = tz.encode_prompt_latents(model, _prompts_torch(ids, mask))
    x = torch.from_numpy(images)
    assert torch.equal(tz.zeroshot_probs(model, x, latents),
                       tz.zeroshot_probs(model, x, latents, plain=True))


def test_inference_zeroshot_writes_metrics(setup, tmp_path):
    pytest.importorskip("sklearn")
    _, model, ids, mask, images = setup
    labels = np.array([[0, 1] * 9, [1, 0] * 9, [1, 1] * 9, [0, 0] * 9])
    runner = tz.CTClipInference(model, _prompts_torch(ids, mask),
                                [(images, None, labels)], results_folder=str(tmp_path))
    metrics, preds, targets = runner.zeroshot()
    assert preds.shape == (4, 18) and np.isfinite(preds).all()
    assert any(tmp_path.iterdir())
    assert runner.metrics_history == [metrics]


def test_inference_mesh_placement_is_not_ported(setup):
    _, model, ids, mask, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tz.CTClipInference(model, _prompts_torch(ids, mask), [], mesh=object())


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = ("import sys\n"
            "import ct_clip_ut_tpu_torch, ct_clip_ut_tpu_torch.convert, chip_smoke\n"
            "import ct_clip_ut_tpu_torch.infer.zeroshot, ct_clip_ut_tpu_torch._build\n"
            "import ct_clip_ut_tpu_torch.infer.profile_zeroshot\n"
            "import ct_clip_ut_tpu_torch.train.trainer, ct_clip_ut_tpu_torch.train.profile_train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ct_clip_ut_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(), check=True,
                   timeout=300)


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """No CUDA: non-zero exit and no result line. In a directory holding
    only chip_smoke.py: the same."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout


PROMPT_LEN = 128
DEFAULT_CLIP = dataclasses.replace(
    SMALL_CLIP, ctvit=SMALL_VIT_CONV,
    bert=BertConfig(vocab_size=2048, hidden_size=32, num_layers=1, num_heads=4,
                    intermediate_size=64, max_position_embeddings=PROMPT_LEN))


@functools.cache
def default_models():
    params = jax_init_ctclip(jax.random.PRNGKey(1), DEFAULT_CLIP)
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), port_config(DEFAULT_CLIP),
                                    device="cpu")
    return params, model


def test_tokenize_prompts_matches_jax():
    tok = tz.WordTokenizer()
    want = jz.tokenize_prompts(tok)
    got = tz.tokenize_prompts(tok, device="cpu")
    assert set(got) == set(want) == {"input_ids", "attention_mask", "token_type_ids"}
    for k in want:
        assert got[k].dtype == torch.int64 and got[k].shape == (36, 512)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    real = got["attention_mask"].sum(1)
    assert 6 <= int(real.min()) and int(real.max()) <= 14
    assert (got["input_ids"][:, 0] == tz.WordTokenizer.CLS).all()
    assert (got["input_ids"][torch.arange(36), real - 1] == tz.WordTokenizer.SEP).all()


def test_zeroshot_default_config_matches_jax():
    """Conv patch embed, prompts padded to PROMPT_LEN: prompt latents, image
    latents and probabilities within 1e-5 of the JAX package in fp32."""
    params, model = default_models()
    tok = tz.WordTokenizer(DEFAULT_CLIP.bert.vocab_size)
    jtokens = jz.tokenize_prompts(tok, max_length=PROMPT_LEN)
    ttokens = tz.tokenize_prompts(tok, max_length=PROMPT_LEN, device="cpu")
    images = np.random.default_rng(5).standard_normal((3, 1, DEPTH, IMG, IMG)).astype(np.float32)
    jl = jz.encode_prompt_latents(params, DEFAULT_CLIP, jtokens)
    tl = tz.encode_prompt_latents(model, ttokens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    ji, _ = jax_image_latents(params, DEFAULT_CLIP, jnp.asarray(images))
    with torch.no_grad():
        ti, _ = encode_image_latents(model, torch.from_numpy(images))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5, rtol=0)
    jp = jz.zeroshot_probs(params, DEFAULT_CLIP, jnp.asarray(images), jl,
                           compute_dtype="float32")
    tp = tz.zeroshot_probs(model, torch.from_numpy(images), tl, compute_dtype=torch.float32)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)


def test_zeroshot_metrics_need_no_sklearn(setup, tmp_path, monkeypatch):
    """zeroshot() computes and writes its metrics with numpy alone: with
    scikit-learn and tabulate made unimportable it still writes
    metrics.txt, the port's save_metrics of its own metrics."""
    _, model, ids, mask, images = setup
    for name in ("sklearn", "sklearn.metrics", "tabulate"):
        monkeypatch.setitem(sys.modules, name, None)
    labels = np.array([[0, 1] * 9, [1, 0] * 9, [1, 1] * 9, [0, 0] * 9])
    runner = tz.CTClipInference(model, _prompts_torch(ids, mask), [(images, None, labels)],
                                results_folder=str(tmp_path / "run"),
                                compute_dtype=torch.float32)
    metrics, preds, targets = runner.zeroshot()
    port_metrics.save_metrics([metrics], list(tz.PATHOLOGIES), tmp_path / "want")
    assert (tmp_path / "run" / "metrics.txt").read_text() == \
        (tmp_path / "want" / "metrics.txt").read_text()
    assert runner.metrics_history == [metrics]
    assert metrics == port_metrics.calculate_metrics(preds, targets, list(tz.PATHOLOGIES))


FORBIDDEN = ("jax", "jaxlib", "ct_clip_ut_tpu", "flax", "optax")


def _imports(path):
    """Every module name an import statement or __import__ / import_module
    call in `path` names, at any depth (lazy imports inside functions too)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", "")) in
              ("__import__", "import_module")):
            names.append(node.args[0].value)
    return names


def test_port_sources_import_no_jax_even_lazily():
    files = sorted((REPO / "ct_clip_ut_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(REPO)): [n for n in _imports(f) if n.split(".")[0] in FORBIDDEN]
           for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_import_scan_sees_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from ct_clip_ut_tpu.utils import metrics\n"
                   "    import jax.numpy\n    __import__('flax')\n")
    assert _imports(src) == ["ct_clip_ut_tpu.utils", "jax.numpy", "flax"]
