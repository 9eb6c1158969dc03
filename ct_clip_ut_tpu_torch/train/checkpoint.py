"""Single-file checkpoints of the train state.

Counterpart of the msgpack path of ct_clip_ut_tpu/train/checkpoint.py: one
file holds the model's state dict (parameters and buffers, the VQ codebook
included), the optimizer's moments and update count, the global step and
the dropout generator's state, so a resumed run continues bit for bit.
Writes are atomic (a temporary file beside the target, then os.replace):
a crash mid-write leaves the previous checkpoint intact. Sharded (orbax)
checkpoints and the reference-checkpoint converter are not ported yet
(ROADMAP Queue 1 items 11 and 12).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def save_checkpoint(path, state) -> None:
    """Write `state` (a trainer.TrainState) to `path` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step), "generator": state.generator.get_state()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, state):
    """Load `path` into `state` in place (its tensors keep their devices);
    returns it."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    state.generator.set_state(blob["generator"])
    return state
