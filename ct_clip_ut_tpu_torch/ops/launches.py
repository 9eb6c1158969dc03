"""Launch counters of the port's hand-written kernels.

Each kernel wrapper adds one to its counter where it launches its kernel
chain on a CUDA tensor, and nowhere else: the plain versions the CPU takes
never count. A run can then show that its main path went through every
kernel (`chip_smoke.py` resets the counters, drives the path and reads
them back). These integers are the package's only global state.
"""

from __future__ import annotations

KERNELS = ("attn_block", "attn_packed", "geglu_ff", "vq_nearest", "patch_embed", "bert_layer",
           "attn_block_bwd", "attn_packed_bwd", "geglu_ff_bwd", "patch_embed_res",
           "patch_embed_dkw", "bert_layer_bf16", "bert_layer_bwd", "peg", "peg_weight_grads")

attn_block = 0
attn_packed = 0
geglu_ff = 0
vq_nearest = 0
patch_embed = 0
bert_layer = 0
attn_block_bwd = 0
attn_packed_bwd = 0
geglu_ff_bwd = 0
patch_embed_res = 0
patch_embed_dkw = 0
bert_layer_bf16 = 0
bert_layer_bwd = 0
peg = 0
peg_weight_grads = 0


def count(name: str) -> None:
    globals()[name] += 1


def launch_counts() -> dict:
    return {name: globals()[name] for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        globals()[name] = 0
