"""Training: the single-card train and eval steps and the host-side driver.

Counterpart of ct_clip_ut_tpu/train/trainer.py. One `train_step` call does
what the JAX package's jitted step does (trainer.py:86-113): the forward
with the VQ codebook unfrozen and text dropout drawn from the state's
generator, the symmetric InfoNCE loss, the backward (the kernels' autograd
Functions on the card), the global-norm clip and the Adam update
(train/optimizer.py), and the VQ EMA write-back (not a gradient step). It
returns the loss as a device tensor, without a host sync. The model's
parameters stay fp32; the forward runs in `compute_dtype` (bf16).

`CTClipTrainer` is the driver of trainer.py:267-672: tokenising on the
host, the epoch loop with the loss fetched one step late, the step-0
bootstrap evaluation, `save_every_steps` checkpoints with the position
sidecar (`<name>.pos.json`) that step-level resume reads, and the dated /
indexed results folder. Not ported yet, and raising with their ROADMAP
item: GradCache (grad_accum > 1), FSDP, sharded checkpoints, the MoE
CT-ViT, meshes; the profiler window (`profile_steps`) is replaced by
`python -m ct_clip_ut_tpu_torch.train.profile_train`. The training-curve
plots are skipped.
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .. import _build
from ..config import CTCLIPConfig, TrainConfig
from ..models.ctclip import CTCLIP, contrastive_loss, ctclip_apply, init_ctclip
from ..ops.vq import VQState
from . import checkpoint as ckpt
from .optimizer import Optimizer, get_optimizer


@dataclass
class TrainState:
    model: CTCLIP
    optimizer: Optimizer
    step: int
    generator: torch.Generator


def _check_supported(model_cfg: CTCLIPConfig, train_cfg: TrainConfig) -> None:
    if train_cfg.grad_accum > 1:
        raise NotImplementedError("GradCache (grad_accum > 1) is not ported yet "
                                  "(ROADMAP, Queue 1 item 8)")
    if train_cfg.fsdp:
        raise NotImplementedError("FSDP is not ported yet (ROADMAP, Queue 1 item 11)")
    if train_cfg.sharded_checkpoints:
        raise NotImplementedError("sharded checkpoints are not ported yet "
                                  "(ROADMAP, Queue 1 item 11)")
    if model_cfg.ctvit.moe_experts > 0:
        raise NotImplementedError("the MoE CT-ViT is not ported yet (ROADMAP, Queue 1 item 11)")


def create_train_state(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                       params: Optional[CTCLIP] = None, device="cuda") -> TrainState:
    """A TrainState on `device`: `params` (a CTCLIP, e.g. from
    convert.from_jax_params) or a model drawn from train_cfg.seed, the
    optimizer over its parameters, step 0, and the dropout generator
    seeded from train_cfg.seed."""
    _check_supported(model_cfg, train_cfg)
    device = _build.check_device(device)
    model = params if params is not None else init_ctclip(model_cfg, seed=train_cfg.seed,
                                                          device=device)
    model = model.to(device)
    opt = get_optimizer(list(model.parameters()), lr=train_cfg.lr, wd=train_cfg.wd,
                        betas=tuple(train_cfg.betas), eps=train_cfg.eps,
                        max_grad_norm=train_cfg.max_grad_norm,
                        warmup_steps=train_cfg.warmup_steps, decay_steps=train_cfg.decay_steps,
                        end_lr_frac=train_cfg.end_lr_frac, mu_dtype=train_cfg.adam_mu_dtype)
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    return TrainState(model=model, optimizer=opt, step=0, generator=gen)


@torch.no_grad()
def write_back_vq(model: CTCLIP, vq_state: VQState) -> None:
    """The EMA codebook into the model's buffers (trainer.py:78-83)."""
    cb = model.visual_transformer.vq._codebook
    cb.embed.copy_(vq_state.embed)
    cb.embed_avg.copy_(vq_state.embed_avg)
    cb.cluster_size.copy_(vq_state.cluster_size)


def make_train_step(model_cfg: CTCLIPConfig, train_cfg: TrainConfig,
                    plain: bool = False) -> Callable:
    """train_step(state, image, text_tokens) -> loss (a device scalar);
    updates `state` in place. plain=True runs every kernel's plain forward
    and lets autograd differentiate it (the reference the card holds its
    backward kernels against)."""
    _check_supported(model_cfg, train_cfg)
    dtype = getattr(torch, train_cfg.compute_dtype)

    def train_step(state: TrainState, image: torch.Tensor, text_tokens: dict) -> torch.Tensor:
        state.optimizer.zero_grad()
        out = ctclip_apply(state.model, text_tokens, image.to(dtype), freeze_vq=False,
                           generator=state.generator, deterministic=False, plain=plain)
        loss = contrastive_loss(out.sim_matrix)
        loss.backward()
        state.optimizer.step()
        write_back_vq(state.model, out.vq_state)
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(model_cfg: CTCLIPConfig, train_cfg: TrainConfig) -> Callable:
    """eval_step(model, image, text_tokens) -> loss (a device scalar), the
    codebook frozen and no dropout (trainer.py:254-264)."""
    dtype = getattr(torch, train_cfg.compute_dtype)

    @torch.no_grad()
    def eval_step(model: CTCLIP, image: torch.Tensor, text_tokens: dict) -> torch.Tensor:
        out = ctclip_apply(model, text_tokens, image.to(dtype), freeze_vq=True)
        return contrastive_loss(out.sim_matrix)

    return eval_step


class CTClipTrainer:
    """Host-side training driver (reference CTClipTrainer.py:33-304).

    `train_data` / `valid_data` are iterables (re-iterable per epoch)
    yielding (images [B, 1, D, H, W], texts) batches, numpy or tensors;
    `tokenizer` is an HF-style callable (max_length = text_max_length).
    On the card unless `device` says otherwise."""

    def __init__(self, model_cfg: CTCLIPConfig, train_cfg: TrainConfig, tokenizer,
                 train_data: Iterable, valid_data: Iterable, results_folder: str = "./results",
                 params: Optional[CTCLIP] = None, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("mesh-parallel training is not ported yet "
                                      "(ROADMAP, Queue 1 item 11)")
        if train_cfg.profile_steps > 0:
            raise NotImplementedError("the trainer's profiler window is not ported; profile "
                                      "with python -m ct_clip_ut_tpu_torch.train.profile_train")
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.tokenizer = tokenizer
        self.train_data = train_data
        self.valid_data = valid_data
        self.device = _build.check_device(device)
        self.state = create_train_state(model_cfg, train_cfg, params=params, device=self.device)
        self.train_step = make_train_step(model_cfg, train_cfg)
        self.eval_step = make_eval_step(model_cfg, train_cfg)

        # dated + indexed results dir (reference CTClipTrainer.py:122-131)
        base = Path(results_folder) / datetime.now().strftime("%d-%m-%Y")
        base.mkdir(parents=True, exist_ok=True)
        idx = len([d for d in base.iterdir() if d.is_dir()]) + 1
        self.results_folder = base / str(idx)
        self.results_folder.mkdir(parents=True, exist_ok=True)

        self.train_losses = {"steps": [], "epochs": []}
        self.valid_losses = []
        self.best_score = float("inf")
        # data-stream position for step-level resume, persisted beside every
        # checkpoint (trainer.py:344-350)
        self._pos = {"epoch": 0, "step_in_epoch": 0, "steps_per_epoch": None}
        self._resume_pos = None

    # -- plumbing -----------------------------------------------------------

    def tokenize(self, texts) -> dict:
        enc = self.tokenizer(list(texts), return_tensors="np", padding="max_length",
                             truncation=True, max_length=self.cfg.text_max_length)
        keys = [k for k in ("input_ids", "attention_mask", "token_type_ids") if k in enc]
        return {k: torch.as_tensor(np.asarray(enc[k]), dtype=torch.int64, device=self.device)
                for k in keys}

    def _put_batch(self, images, texts):
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return images, self.tokenize(texts)

    def save_model(self, name: str) -> None:
        ckpt.save_checkpoint(self.results_folder / name, self.state)
        (self.results_folder / "architecture.json").write_text(
            json.dumps({"model_cfg": repr(self.model_cfg), "train_cfg": repr(self.cfg)},
                       indent=2))
        # the position sidecar, stamped with the checkpoint's step
        # (trainer.py:416-428): atomic, and detectably stale after a crash
        # between the two renames
        pos_path = self.results_folder / (name + ".pos.json")
        tmp = pos_path.with_name(pos_path.name + ".tmp")
        tmp.write_text(json.dumps({**self._pos, "global_step": int(self.state.step)}))
        tmp.replace(pos_path)

    def load_model(self, path) -> None:
        pos_path = Path(str(path) + ".pos.json")
        pos = json.loads(pos_path.read_text()) if pos_path.exists() else None
        ckpt.load_checkpoint(path, self.state)
        step = int(self.state.step)
        if pos is not None and pos.get("global_step") is not None \
                and int(pos["global_step"]) != step:
            # stale sidecar: re-derive the position from the step counter
            spe = pos.get("steps_per_epoch")
            if spe:
                pos = {"epoch": step // int(spe) + 1, "step_in_epoch": step % int(spe),
                       "steps_per_epoch": int(spe)}
                print(f"resume sidecar was stale (crash window); position re-derived from "
                      f"step {step}")
            else:
                pos = None
        self._resume_pos = pos

    # -- loops --------------------------------------------------------------

    def evaluate(self, epoch: int) -> float:
        total, n = 0.0, 0
        for images, texts, *_ in self.valid_data:
            images, tokens = self._put_batch(images, texts)
            total += float(self.eval_step(self.state.model, images, tokens))
            n += 1
        avg = total / max(n, 1)
        self.valid_losses.append(avg)
        print(f"Epoch {epoch} - Validation Loss: {avg:.4f}")
        if epoch == 0 or (avg < self.best_score and self.cfg.save_best_model):
            self.best_score = min(avg, self.best_score)
            self.save_model("best_checkpoint.pt")
        return avg

    def _start(self, steps_per_epoch):
        """(first epoch, batches to skip in it) after a resume (trainer.py:540-569)."""
        resumed_step = int(self.state.step)
        start_epoch, skip = 1, 0
        if resumed_step and self._resume_pos:
            pos = self._resume_pos
            start_epoch = max(int(pos.get("epoch") or 1), 1)
            skip = int(pos.get("step_in_epoch") or 0)
            saved_spe = pos.get("steps_per_epoch")
            if saved_spe and steps_per_epoch and saved_spe != steps_per_epoch:
                print(f"steps_per_epoch changed ({saved_spe} -> {steps_per_epoch}); falling "
                      "back to epoch-level resume")
                skip = 0
            spe = steps_per_epoch or saved_spe
            if spe and skip >= spe:
                start_epoch, skip = start_epoch + 1, 0
            if start_epoch <= self.cfg.num_epochs:
                print(f"Resuming at step {resumed_step}: epoch {start_epoch}"
                      + (f", batch {skip + 1}" if skip else ""))
        elif resumed_step and steps_per_epoch:
            done = min(resumed_step // steps_per_epoch, self.cfg.num_epochs)
            start_epoch = done + 1
            if done:
                print(f"Resuming at step {resumed_step}: skipping {done} completed epoch(s)")
        return start_epoch, skip

    def train(self) -> TrainState:
        print("Training started")
        start = time.time()
        try:
            steps_per_epoch = len(self.train_data)
            save_at = max(1, steps_per_epoch // self.cfg.num_save_split)
        except TypeError:   # unsized iterable: log every step
            steps_per_epoch, save_at = None, 1
        resumed_step = int(self.state.step)
        start_epoch, resume_skip = self._start(steps_per_epoch)
        for epoch in range(start_epoch, self.cfg.num_epochs + 1):
            skip = resume_skip if epoch == start_epoch else 0
            epoch_start = time.time()
            sampler = getattr(self.train_data, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            total_loss, steps = 0.0, 0
            if skip and self._resume_pos:
                total_loss = float(self._resume_pos.get("loss_sum") or 0.0)
                steps = int(self._resume_pos.get("loss_steps") or 0)
            pending = None   # (step, device loss), fetched one step late

            def log_step(step, loss):
                nonlocal total_loss, steps
                loss = float(loss)
                total_loss += loss
                steps += 1
                if step % save_at == 0:
                    self.train_losses["steps"].append(loss)
                print(f"Epoch {epoch} | Step {step} | Loss: {loss:.6f}")
                return loss

            if not skip:
                data_iter = self.train_data
            elif hasattr(self.train_data, "iter_from"):
                data_iter = self.train_data.iter_from(skip)
            else:
                data_iter = itertools.islice(iter(self.train_data), skip, None)
            for step, (images, texts, *_) in enumerate(data_iter, start=skip + 1):
                self._pos = {"epoch": epoch, "step_in_epoch": step,
                             "steps_per_epoch": steps_per_epoch}
                images, tokens = self._put_batch(images, texts)
                loss = self.train_step(self.state, images, tokens)
                if epoch == 1 and step == 1 and resumed_step == 0:
                    l0 = log_step(1, loss)
                    self.train_losses["epochs"].append(l0)
                    if 1 % save_at != 0:
                        self.train_losses["steps"].append(l0)
                    self.evaluate(0)   # step-0 bootstrap eval (reference :278-281)
                    continue
                # the previous step's loss is read after this step is queued
                if pending is not None:
                    log_step(*pending)
                pending = (step, loss)
                if self.cfg.save_every_steps and self.state.step % self.cfg.save_every_steps == 0:
                    log_step(*pending)
                    pending = None
                    self._pos = {**self._pos, "loss_sum": total_loss, "loss_steps": steps}
                    self.save_model("last_checkpoint.pt")
            if pending is not None:
                log_step(*pending)
            self._pos = {"epoch": epoch + 1, "step_in_epoch": 0,
                         "steps_per_epoch": steps_per_epoch}
            avg = total_loss / max(steps, 1)
            self.train_losses["epochs"].append(avg)
            print(f"Epoch {epoch} done. Avg loss {avg:.6f} ({time.time() - epoch_start:.1f}s)")
            self.evaluate(epoch)
        print(f"Training completed in {time.time() - start:.1f}s")
        return self.state
