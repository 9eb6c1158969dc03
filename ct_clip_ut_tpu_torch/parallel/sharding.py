"""The data axis's placement rules: replicated state, row-sharded batches,
averaged gradients.

Counterpart of the data-axis half of ct_clip_ut_tpu/parallel/sharding.py.
Under GSPMD the JAX package states placements and XLA inserts the
collectives; here each rank holds a full replica of the parameters and the
optimizer state (`broadcast_state` makes them rank 0's at the start), its
own rows of each global batch (`shard_host_batch`, `local_rows`), and
averages its gradients with the other ranks' before the clip and the
update (`allreduce_grads`), so every rank takes the same step and holds
the same bits after it. FSDP (params and moments sharded at rest) and the
tensor-parallel rules are not ported (ROADMAP Queue 1 items 11b, 11c).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .collectives import _live, broadcast

# gradient buckets of at most this many bytes, filled in parameter order
BUCKET_BYTES = 32 * 2 ** 20


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, optimizer, mesh) -> None:
    """Rank 0's parameters, buffers (the VQ codebook) and optimizer moments
    on every rank, in place, in their registration order."""
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        tensors += [*optimizer.mu, *optimizer.nu]
    for t in tensors:
        broadcast(t.data, mesh)


def shard_host_batch(batch, mesh, device=None):
    """This rank's rows of a global host batch (rank r takes rows [r b, (r +
    1) b) of world * b), on `device` (the mesh's by default): a tensor, a
    numpy array, or a dict of them (tokenised text)."""
    device = mesh.device if device is None else device
    if isinstance(batch, dict):
        return {k: shard_host_batch(v, mesh, device) for k, v in batch.items()}
    b = batch.shape[0] // mesh.world
    if b * mesh.world != batch.shape[0]:
        raise ValueError(f"global batch {batch.shape[0]} not divisible by data={mesh.world}")
    rows = batch[mesh.rank * b:(mesh.rank + 1) * b]
    return torch.as_tensor(np.asarray(rows) if isinstance(rows, np.ndarray) else rows,
                           device=device)


def local_rows(x, mesh):
    """This rank's rows of a global [world * b, ...] array gathered in rank
    order (the inverse of `collectives.gather_rows`)."""
    b = x.shape[0] // mesh.world
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def _buckets(grads: Sequence[torch.Tensor]) -> Iterable[list]:
    """Consecutive runs of gradients of one dtype and device, each at most
    BUCKET_BYTES (a larger gradient is a bucket of its own)."""
    bucket, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or g.dtype != bucket[0].dtype
                       or g.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def allreduce_grads(params: Sequence[torch.nn.Parameter], mesh) -> None:
    """Every parameter's .grad replaced by its mean over the ranks (a None
    gradient counts as zeros, as the optimizer reads it), bucket by bucket
    in parameter order: the same order, and so the same bits, on every
    rank."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p) if p.grad is None else p.grad.contiguous()
    if not _live(mesh):
        return
    for bucket in _buckets([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in bucket]) if len(bucket) > 1 \
            else bucket[0].reshape(-1)
        torch.distributed.all_reduce(flat)
        flat.div_(mesh.world)
        if len(bucket) > 1:
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def shard_loader(data, mesh) -> None:
    """Give a loader whose `sampler` is a one-shard ShardedSampler
    (data/loader.py) this rank's shard: num_shards = world, shard_index =
    rank (the DistributedSampler of the reference). A sampler already
    sharded must match the mesh; any other iterable is left as it is."""
    sampler = getattr(data, "sampler", None)
    if sampler is None or not hasattr(sampler, "num_shards") or mesh.world == 1:
        return
    if sampler.num_shards == 1:
        sampler.num_shards, sampler.shard_index = mesh.world, mesh.rank
    elif (sampler.num_shards, sampler.shard_index) != (mesh.world, mesh.rank):
        raise ValueError(f"the loader's sampler takes shard {sampler.shard_index} of "
                         f"{sampler.num_shards}; this rank is {mesh.rank} of {mesh.world}")
