"""Single-file checkpoints of the train state.

Counterpart of the msgpack path of ct_clip_ut_tpu/train/checkpoint.py: one
file holds the model's state dict (parameters and buffers, the VQ codebook
included), the optimizer's moments and update count, the global step and
the dropout generator's state, so a resumed run continues bit for bit.
Writes are atomic (a temporary file beside the target, then os.replace):
a crash mid-write leaves the previous checkpoint intact. A data-parallel
run's file also holds every rank's generator state. The reference's
checkpoints go through convert.py (`load_ctclip` reads this module's files
too). Sharded (orbax) checkpoints are not ported yet (ROADMAP Queue 1 item
11b).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def save_checkpoint(path, state, rank_generators=None) -> None:
    """Write `state` (a trainer.TrainState) to `path` atomically; a
    data-parallel run adds every rank's dropout generator state
    (`rank_generators` [world, n] uint8)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    blob = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "generator": state.generator.get_state()}
    if rank_generators is not None:
        blob["rank_generators"] = rank_generators
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, state, rank=None, blob=None):
    """Load `path` (or `blob`, its contents already read) into `state` in
    place (its tensors keep their devices); returns it. A data-parallel
    `rank` takes its own generator state where the file holds every
    rank's."""
    if blob is None:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    gens = blob.get("rank_generators")
    # a row of its own (clone): set_state reads a view's storage from its start
    state.generator.set_state(gens[rank].clone() if rank is not None and gens is not None
                              else blob["generator"])
    return state
