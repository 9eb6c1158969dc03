"""The training slice on the CPU (ct_clip_ut_tpu_torch/{ops/vq.py,
models/ctclip.py, models/bert.py, train/}).

Against the JAX package, from the same inputs (numpy, fixed seeds): the VQ
straight-through gradient and EMA update, the symmetric InfoNCE loss, the
optimizer (clip + Adam, the AdamW mask, the schedules, the bf16 first
moment) against optax at 1e-6, and three whole train steps at a tiny
configuration, fp32 and bf16, against the JAX `make_train_step` from one
JAX parameter tree (BERT dropout 0, so both steps are deterministic).
Then BERT's train-mode dropout, and `CTClipTrainer` end to end in a
temporary folder: two epochs, checkpoints, and step-level resume that
reproduces the uninterrupted run bit for bit.
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ct_clip_ut_tpu.config import TrainConfig as JTrainConfig
from ct_clip_ut_tpu.models.ctclip import contrastive_loss as jax_contrastive_loss
from ct_clip_ut_tpu.ops import vq as jvq
from ct_clip_ut_tpu.train.optimizer import get_optimizer as jax_get_optimizer
from ct_clip_ut_tpu.train.trainer import create_train_state as jax_create_train_state
from ct_clip_ut_tpu.train.trainer import make_train_step as jax_make_train_step
from ct_clip_ut_tpu_torch import convert
from ct_clip_ut_tpu_torch.config import TrainConfig
from ct_clip_ut_tpu_torch.models import bert as tbert
from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss
from ct_clip_ut_tpu_torch.ops import vq as tvq
from ct_clip_ut_tpu_torch.ops.layers import dropout
from ct_clip_ut_tpu_torch.train import trainer as ttrainer
from ct_clip_ut_tpu_torch.train.optimizer import get_optimizer, make_lr_schedule

from test_torch_port_modules import (DEPTH, IMG, SMALL_BERT, SMALL_CLIP, SMALL_VIT_CONV,
                                     jax_and_port_models, port_config)


def _rand(shape, seed):
    return np.array(np.random.default_rng(seed).standard_normal(shape), np.float32)


# -- VQ ----------------------------------------------------------------------

def test_vq_straight_through_gradient_is_the_identity():
    """d out / d x is the identity (vq.py:153): grad of sum(out * r) is r.
    Without the detach the quantised value's own path cancels it to 0."""
    _, model = jax_and_port_models()
    x = torch.from_numpy(_rand((2, 20, 16), 1)).requires_grad_(True)
    r = torch.from_numpy(_rand((2, 20, 16), 2))
    for freeze in (True, False):
        out, _, _ = tvq.vq_apply(model.visual_transformer.vq.state(), x, freeze=freeze)
        grad, = torch.autograd.grad((out * r).sum(), x)
        torch.testing.assert_close(grad, r, rtol=0, atol=0)


def test_vq_ema_matches_jax():
    """Batch statistics (index_add_) and the EMA update at 1e-6."""
    params, model = jax_and_port_models()
    jstate = params["visual_transformer"]["vq"]
    x = _rand((3, 40, 16), 3)
    flat = jvq.vq_stats_input(jnp.asarray(x), 16)
    _, jidx = jvq.vq_lookup(jstate, jnp.asarray(x))
    jcounts, jsum = jvq.vq_batch_stats(jidx, flat, 32)
    counts, esum = tvq.vq_batch_stats(torch.from_numpy(np.array(jidx)),
                                      tvq.vq_stats_input(torch.from_numpy(x), 16), 32)
    np.testing.assert_allclose(counts.numpy(), np.asarray(jcounts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(esum.numpy(), np.asarray(jsum), rtol=0, atol=1e-6)
    want = jvq.vq_ema_update(jstate, jcounts, jsum, decay=0.8, eps=1e-5)
    got = tvq.vq_ema_update(model.visual_transformer.vq.state(), counts, esum, decay=0.8,
                            eps=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# -- loss and optimizer -------------------------------------------------------

def test_contrastive_loss_matches_jax():
    sim = _rand((5, 5), 4) * 3
    for targets in (None, np.array([1, 0, 2, 4, 3])):
        want = jax_contrastive_loss(jnp.asarray(sim),
                                    None if targets is None else jnp.asarray(targets))
        got = contrastive_loss(torch.from_numpy(sim),
                               None if targets is None else torch.from_numpy(targets))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("warmup,decay,end", [(0, 0, 0.0), (3, 0, 0.0), (2, 5, 0.1),
                                              (0, 4, 0.2)])
def test_lr_schedule_matches_optax(warmup, decay, end):
    from ct_clip_ut_tpu.train.optimizer import make_lr_schedule as jax_schedule
    want = jax_schedule(2e-3, warmup, decay, end)
    got = make_lr_schedule(2e-3, warmup, decay, end)
    for count in range(12):
        w = want(count) if callable(want) else want
        np.testing.assert_allclose(got(count), float(w), rtol=1e-6, atol=1e-12)


OPT_CASES = {
    "adam, clipped": dict(lr=1e-2, wd=0.0, max_grad_norm=0.5),
    "adam, no clip": dict(lr=1e-2, wd=0.0, max_grad_norm=None),
    "adamw mask, schedule": dict(lr=1e-2, wd=0.1, max_grad_norm=1.0, warmup_steps=1,
                                 decay_steps=3, end_lr_frac=0.1),
    "bf16 first moment": dict(lr=1e-2, wd=0.0, max_grad_norm=0.5, mu_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Four updates of a matrix, a vector and a scalar (global-norm clip
    sometimes triggered) at 1e-6; decay only on the matrix under AdamW."""
    kw = OPT_CASES[case]
    shapes = [(4, 3), (3,), ()]
    params = [_rand(s, 10 + i) for i, s in enumerate(shapes)]
    tx = jax_get_optimizer(betas=(0.9, 0.99), eps=1e-8, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = get_optimizer(tp, betas=(0.9, 0.99), eps=1e-8, **kw)
    for step in range(4):
        grads = [_rand(s, 20 + 3 * step + i) * (0.1 if step % 2 else 2.0)
                 for i, s in enumerate(shapes)]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(g)
        opt.step()
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{case}, step {step}")
    if kw.get("mu_dtype"):
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)


# -- whole train steps --------------------------------------------------------

TRAIN_CLIP = dataclasses.replace(
    SMALL_CLIP, ctvit=SMALL_VIT_CONV,
    bert=dataclasses.replace(SMALL_BERT, hidden_dropout=0.0, attention_dropout=0.0))
TEXT_LEN = 12


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 1, DEPTH, IMG, IMG)).astype(np.float32)
    ids = rng.integers(5, TRAIN_CLIP.bert.vocab_size, (b, TEXT_LEN))
    mask = np.ones_like(ids)
    mask[0, 7:] = 0
    ids[0, 7:] = 0
    return images, {"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": np.zeros_like(ids)}


# Three steps against the JAX step. fp32 (measured on this CPU): losses
# within 4.3e-6 relative; parameter updates within 8.6e-4 relative rms over
# the whole model (cosine 0.9999994) and 3.3e-3 per tensor; VQ state within
# 1.1e-4 of its largest value. The port's plain kernels take one-pass
# LayerNorm moments where the JAX package's XLA path, which the CPU runs,
# takes two-pass ones, so gradients agree to ~7e-5, and Adam passes that
# on. Two biases have a true gradient of 0 (a key bias and the CPB's last
# bias only shift softmax rows): Adam turns their rounding noise into
# updates of up to lr a step on both sides, so they are held to that bound
# instead. bf16 flips VQ assignments at near ties of the 32-code test
# codebook (bf16 similarities), each flip swapping a whole code vector, so
# its steps diverge (measured: first loss 0.024 apart, later ones up to
# 0.25, global update cosine 0.76); it is held to its first loss and the
# direction of its updates.
SHIFT_INVARIANT = ("text_transformer.encoder.layer.0.attention.self.key.bias",
                   "visual_transformer.spatial_rel_pos_bias.net.2.bias")


def _run_three_steps(dtype, lr=1e-3, grad_accum=1, b=2, steps=3):
    jcfg = JTrainConfig(lr=lr, compute_dtype=dtype, text_max_length=TEXT_LEN,
                        grad_accum=grad_accum)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(3), TRAIN_CLIP, jcfg)
    model = convert.from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                    port_config(TRAIN_CLIP), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jstep = jax_make_train_step(TRAIN_CLIP, jcfg, tx)
    tcfg = port_config(jcfg)
    state = ttrainer.create_train_state(port_config(TRAIN_CLIP), tcfg, params=model,
                                        device="cpu")
    step = ttrainer.make_train_step(port_config(TRAIN_CLIP), tcfg)
    losses = []
    for i in range(steps):
        images, text = _batch(40 + i, b)
        jstate, jloss = jstep(jstate, jnp.asarray(images),
                              {k: jnp.asarray(v) for k, v in text.items()})
        loss = step(state, torch.from_numpy(images),
                    {k: torch.from_numpy(v) for k, v in text.items()})
        losses.append((loss.item(), float(jloss)))
    assert state.step == steps and state.optimizer.count == steps
    want = convert.from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                   port_config(TRAIN_CLIP), device="cpu").state_dict()
    got = state.model.state_dict()
    trained = [k for k in before if ".vq." not in k and k not in SHIFT_INVARIANT
               and got[k].is_floating_point()]
    upd = {k: (got[k] - before[k], want[k] - before[k]) for k in trained}
    for k in SHIFT_INVARIANT:
        assert (got[k] - before[k]).abs().max() <= steps * lr * 1.01, k
    # EMA updates of b x 2 x 4 x 4 assignments a step, decay 0.8
    cs = state.model.visual_transformer.vq._codebook.cluster_size
    np.testing.assert_allclose(cs.sum().item(), 32 * b * (1 - 0.8 ** steps), rtol=1e-5)
    return losses, upd, got, want


def test_three_train_steps_match_jax_fp32():
    check_fp32_steps(*_run_three_steps("float32"))


def check_fp32_steps(losses, upd, got, want):
    """The fp32 steps' bands against the JAX step (see above)."""
    for i, (loss, jloss) in enumerate(losses):
        assert abs(loss - jloss) <= 2e-5 * abs(jloss), (i, loss, jloss)
    up = torch.cat([u.flatten() for u, _ in upd.values()])
    uj = torch.cat([w.flatten() for _, w in upd.values()])
    assert (up - uj).norm() <= 1e-2 * uj.norm()
    for k, (u, w) in upd.items():
        if w.numel():
            assert (u - w).norm() <= 2e-2 * w.norm() + 1e-9, k
    for k in got:
        if ".vq." in k:
            assert (got[k] - want[k]).abs().max() <= 1e-3 * want[k].abs().max(), k


def test_three_train_steps_bf16_within_band_of_jax():
    losses, upd, _, _ = _run_three_steps("bfloat16")
    assert abs(losses[0][0] - losses[0][1]) <= 0.05, losses[0]
    assert all(np.isfinite(loss) and abs(loss - jloss) <= 0.5 for loss, jloss in losses), losses
    up = torch.cat([u.flatten() for u, _ in upd.values()])
    uj = torch.cat([w.flatten() for _, w in upd.values()])
    assert torch.nn.functional.cosine_similarity(up, uj, dim=0) >= 0.5


# -- BERT train mode ----------------------------------------------------------

def test_dropout_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones((200, 500))
    y = dropout(x, 0.1, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.0, None) is x
    yb = dropout(x.bfloat16(), 0.1, gen)
    assert yb.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, None)


def test_bert_train_mode_dropout():
    """Train mode draws masks at the BertConfig rates (same generator state:
    same output); rate 0 in train mode equals eval; a generator is required."""
    _, model = jax_and_port_models()
    bert = model.text_transformer
    _, text = _batch(50)
    ids, mask = torch.from_numpy(text["input_ids"]), torch.from_numpy(text["attention_mask"])
    eval_out = tbert.bert_apply(bert, ids, mask)
    train = [tbert.bert_apply(bert, ids, mask, generator=torch.Generator().manual_seed(s),
                              deterministic=False) for s in (1, 1, 2)]
    assert torch.equal(train[0], train[1]) and not torch.equal(train[0], train[2])
    assert not torch.allclose(train[0], eval_out, atol=1e-3)
    no_drop = dataclasses.replace(bert.cfg, hidden_dropout=0.0, attention_dropout=0.0)
    bert.cfg = no_drop
    try:
        out = tbert.bert_apply(bert, ids, mask, generator=torch.Generator(),
                               deterministic=False)
    finally:
        bert.cfg = SMALL_BERT_PORT
    torch.testing.assert_close(out, eval_out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        tbert.bert_apply(bert, ids, mask, deterministic=False)


SMALL_BERT_PORT = port_config(SMALL_BERT)


def test_bert_train_mode_takes_the_fp32_chains_at_the_fused_gate(monkeypatch):
    """Where the card runs the fused layer (n >= 128), an fp32 train-mode
    call takes the fp32 chains: on a (stand-in) card tensor each layer
    reaches ctc_bert_layer with both dropout thresholds set and its
    backward ctc_bert_layer_bwd_f32, no plain layer and no bf16 entry;
    eval reaches ctc_bert_layer with thresholds 0."""
    from ct_clip_ut_tpu_torch import _build
    from ct_clip_ut_tpu_torch.ops import bert_layer as bl
    from ct_clip_ut_tpu_torch.ops import launches

    from test_torch_port_f32_hopper import FakeLib
    from test_torch_port_modules import GATE_BERT, gate_bert_pair

    _, mod = gate_bert_pair()
    lib = FakeLib()
    monkeypatch.setattr(tbert, "takes_fused_layers", lambda x, cfg, n: True)
    monkeypatch.setattr(_build, "on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    for name in ("bert_layer_plain", "bert_layer_bwd_plain"):
        monkeypatch.setattr(bl, name, lambda *a, **k: pytest.fail("a plain layer ran"))
    ids = torch.ones((2, 128), dtype=torch.int64)
    launches.reset_launch_counts()
    mod.zero_grad()
    out = tbert.bert_apply(mod, ids, generator=torch.Generator(), deterministic=False)
    out.sum().backward()
    layers = GATE_BERT.num_layers
    assert [c[0] for c in lib.calls] == (["ctc_bert_layer"] * layers
                                         + ["ctc_bert_layer_bwd_f32"] * layers)
    threshold = bl.dropout_threshold(GATE_BERT.hidden_dropout)
    assert all(a[-5:-3] == (threshold, threshold) for _, a in lib.calls)
    lib.calls.clear()
    with torch.no_grad():
        tbert.bert_apply(mod, ids)
    assert [c[0] for c in lib.calls] == ["ctc_bert_layer"] * layers
    assert all(a[-5:-3] == (0, 0) for _, a in lib.calls)
    counts = launches.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "bert_layer_f32_train": layers, "bert_layer_bwd_f32": layers, "bert_layer": layers}
    mod.zero_grad()
    launches.reset_launch_counts()


def test_fp32_train_step_at_the_fused_gate_matches_jax(monkeypatch):
    """The port's fp32 step at 128-token reports, BERT forced onto its fused
    route (bert_layer_grad: the autograd Function the card runs, its plain
    versions on the CPU), dropout 0: the loss and every parameter's gradient
    against jax.value_and_grad of the JAX step's loss (the JAX package's
    make_train_step, whose layer loop the CPU runs: the same function).
    Gradients within GATE_GRAD_BAND of each tensor's largest entry (the
    key biases, whose gradient is zero up to rounding, of their layer's
    query bias's)."""
    from ct_clip_ut_tpu.models.ctclip import ctclip_apply as jax_ctclip_apply
    from ct_clip_ut_tpu.models.ctclip import init_ctclip as jax_init_ctclip
    from ct_clip_ut_tpu_torch.models.ctclip import ctclip_apply
    from ct_clip_ut_tpu_torch.ops import bert_layer as bl

    from test_torch_port_modules import GATE_BERT

    cfg = dataclasses.replace(
        TRAIN_CLIP, dim_text=GATE_BERT.hidden_size,
        bert=dataclasses.replace(GATE_BERT, hidden_dropout=0.0, attention_dropout=0.0))
    n = 128
    params = jax.jit(jax_init_ctclip, static_argnums=1)(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(70)
    images = rng.standard_normal((2, 1, DEPTH, IMG, IMG)).astype(np.float32)
    ids = rng.integers(5, cfg.bert.vocab_size, (2, n))
    mask = np.ones_like(ids)
    mask[1, 90:] = 0
    ids[1, 90:] = 0
    text = {"input_ids": ids, "attention_mask": mask, "token_type_ids": np.zeros_like(ids)}

    def jloss(params):
        out = jax_ctclip_apply(params, cfg, {k: jnp.asarray(v) for k, v in text.items()},
                               jnp.asarray(images), freeze_vq=False,
                               rng=jax.random.PRNGKey(6), deterministic=False)
        return jax_contrastive_loss(out.sim_matrix)

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    pcfg = port_config(cfg)
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    want = convert.from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg,
                                   device="cpu").state_dict()
    layers = []
    real = bl.bert_layer_grad
    monkeypatch.setattr(tbert, "bert_layer_grad",
                        lambda *a, **k: layers.append(k["train"]) or real(*a, **k))
    monkeypatch.setattr(tbert, "takes_fused_layers",
                        lambda x, c, n: tbert.fused_layer_gate(c, n))
    out = ctclip_apply(model, {k: torch.from_numpy(v) for k, v in text.items()},
                       torch.from_numpy(images), freeze_vq=False,
                       generator=torch.Generator().manual_seed(0), deterministic=False)
    loss = contrastive_loss(out.sim_matrix)
    loss.backward()
    assert layers == [True] * GATE_BERT.num_layers
    assert abs(loss.item() - float(want_loss)) <= 2e-5 * abs(float(want_loss))
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert len(grads) > 40
    for k, g in grads.items():
        # a shift-invariant bias against its layer's neighbour: the key
        # bias's query bias, the CPB's last bias its weight
        top = want[k.replace(".key.", ".query.") if k.endswith("self.key.bias") else
                   k.replace(".bias", ".weight") if k in SHIFT_INVARIANT else k].abs().max()
        assert (g - want[k]).abs().max() <= GATE_GRAD_BAND * top, k


# fp32 gradients of the fused route's plain versions against the JAX layer
# loop (one-pass against two-pass LayerNorm moments): measured on this CPU
# up to 3.8e-5 of a tensor's largest entry, the loss 3.8e-7 relative
GATE_GRAD_BAND = 1e-4


# -- the driver ---------------------------------------------------------------

class _Tokenizer:
    """Deterministic word ids, HF-style call (as tests/test_trainer_driver.py)."""

    def __call__(self, texts, return_tensors="np", padding="max_length", truncation=True,
                 max_length=TEXT_LEN):
        import zlib
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros_like(ids)
        for i, t in enumerate(texts):
            toks = [1] + [zlib.crc32(w.encode()) % 50 + 5 for w in t.split()][:max_length - 2] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class _Batches:
    """Sized, re-iterable (images, texts) batches; the same order every epoch."""

    def __init__(self, n, b=2, seed=0):
        self.n, self.b, self.seed = n, b, seed

    def __len__(self):
        return self.n

    def __iter__(self):
        rs = np.random.RandomState(self.seed)
        for i in range(self.n):
            yield (rs.randn(self.b, 1, DEPTH, IMG, IMG).astype(np.float32),
                   [f"report {i} sample {j} effusion" for j in range(self.b)])


def _trainer(tmp_path, folder, epochs, save_every=0, save_best=False):
    cfg = TrainConfig(lr=1e-3, num_epochs=epochs, compute_dtype="float32",
                      text_max_length=TEXT_LEN, save_every_steps=save_every,
                      save_best_model=save_best, seed=5)
    return ttrainer.CTClipTrainer(port_config(TRAIN_CLIP), cfg, _Tokenizer(), _Batches(3),
                                  _Batches(1, seed=9), results_folder=tmp_path / folder,
                                  device="cpu")


def test_trainer_two_epochs_and_checkpoint(tmp_path):
    tr = _trainer(tmp_path, "run", 2, save_best=True)
    assert tr.results_folder.parent.parent == tmp_path / "run"
    state = tr.train()
    assert state.step == 6
    assert len(tr.train_losses["epochs"]) == 3 and len(tr.valid_losses) == 3
    assert all(np.isfinite(tr.train_losses["epochs"]))
    best = tr.results_folder / "best_checkpoint.pt"
    assert best.exists() and (tr.results_folder / "architecture.json").exists()
    assert json.loads((tr.results_folder / "best_checkpoint.pt.pos.json").read_text())[
        "global_step"] in (1, 3, 6)
    other = _trainer(tmp_path, "other", 1)
    other.load_model(best)
    assert other.state.step in (1, 3, 6)


def test_trainer_step_level_resume_bitwise(tmp_path):
    """A run saved at step 2 of a 3-step epoch and resumed into a 2-epoch
    run ends with the uninterrupted run's parameters, optimizer moments,
    generator state and epoch losses, bit for bit (tests/test_trainer_driver.py:196)."""
    ref_tr = _trainer(tmp_path, "ref", 2)
    ref = ref_tr.train()
    part = _trainer(tmp_path, "partial", 1, save_every=2)
    part.train()
    last = part.results_folder / "last_checkpoint.pt"
    pos = json.loads((last.parent / (last.name + ".pos.json")).read_text())
    assert {k: pos[k] for k in ("epoch", "step_in_epoch", "steps_per_epoch")} == \
        {"epoch": 1, "step_in_epoch": 2, "steps_per_epoch": 3}
    assert pos["loss_steps"] == 2 and np.isfinite(pos["loss_sum"])
    res_tr = _trainer(tmp_path, "resumed", 2)
    res_tr.load_model(last)
    assert res_tr.state.step == 2
    out = res_tr.train()
    assert out.step == 6
    for (name, a), b in zip(ref.model.state_dict().items(), out.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(ref.optimizer.mu + ref.optimizer.nu, out.optimizer.mu + out.optimizer.nu):
        assert torch.equal(a, b)
    assert torch.equal(ref.generator.get_state(), out.generator.get_state())
    assert res_tr.train_losses["epochs"] == ref_tr.train_losses["epochs"][1:]


def test_trainer_trains_with_gradcache_and_traces_its_window(tmp_path):
    """grad_accum=2 (refused before GradCache was ported): CTClipTrainer's
    GradCache steps give the single-pass trainer's losses (dropout 0); the
    profiler window writes its trace; each evaluation writes the training
    curves."""
    single = _trainer(tmp_path, "single", 1)
    single.train()
    cfg = TrainConfig(lr=1e-3, num_epochs=1, compute_dtype="float32", text_max_length=TEXT_LEN,
                      seed=5, grad_accum=2, profile_steps=1, profile_dir=str(tmp_path / "trace"))
    tr = ttrainer.CTClipTrainer(port_config(TRAIN_CLIP), cfg, _Tokenizer(), _Batches(3),
                                _Batches(1, seed=9), results_folder=tmp_path / "gc",
                                device="cpu")
    assert tr.train().step == 3
    np.testing.assert_allclose(tr.train_losses["epochs"], single.train_losses["epochs"],
                               rtol=1e-6)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert (tr.results_folder / "training_progress.png").exists()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """A model axis above 1 and a mesh that is not a DataMesh raise; FSDP
    over more than one process without sharded checkpoints raises before
    any state is built or collective run (JAX trainer.py:295-304)."""
    from ct_clip_ut_tpu_torch.parallel.mesh import DataMesh
    base = dict(text_max_length=TEXT_LEN, compute_dtype="float32")
    with pytest.raises(ValueError, match="sharded_checkpoints=True"):
        ttrainer.CTClipTrainer(port_config(TRAIN_CLIP), TrainConfig(**base, fsdp=True),
                               _Tokenizer(), _Batches(1), _Batches(1), results_folder=tmp_path,
                               mesh=DataMesh(2, 0, torch.device("cpu")), device="cpu")
    from ct_clip_ut_tpu_torch.config import MeshConfig
    from ct_clip_ut_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(NotImplementedError, match="item 11c"):
        make_mesh(MeshConfig(data=1, model=2), device="cpu")
    with pytest.raises(TypeError, match="DataMesh"):
        ttrainer.CTClipTrainer(port_config(TRAIN_CLIP), TrainConfig(**base), _Tokenizer(),
                               _Batches(1), _Batches(1), results_folder=tmp_path, mesh=object(),
                               device="cpu")


def test_train_sources_are_scanned_for_jax_imports():
    from test_torch_port_zeroshot import FORBIDDEN, REPO, _imports
    files = sorted((REPO / "ct_clip_ut_tpu_torch" / "train").glob("*.py"))
    assert {f.name for f in files} >= {"optimizer.py", "checkpoint.py", "trainer.py",
                                       "profile_train.py"}
    for f in files:
        assert not [n for n in _imports(f) if n.split(".")[0] in FORBIDDEN], f
