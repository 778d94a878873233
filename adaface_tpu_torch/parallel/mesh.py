"""Data parallelism over `torch.distributed`.

Counterpart of `adaface_tpu/parallel/mesh.py`. The JAX package's 'dp' mesh
axis is SPMD: every rank runs the graph of the global batch and XLA places
each leaf's shard. The port runs one process a rank (`torchrun`), each on
its slice of the global batch, and keeps JAX's invariant by construction:
a dp-rank step computes the single-device step on the global batch.

- `make_mesh(dp)`: the process group (NCCL on CUDA, gloo on the CPU), one
  rank a process, rank and local rank from the environment `torchrun`
  sets. Tensor parallelism (`tp > 1`, `shard_params`) is not ported.
- `shard_batch`: a rank's slice by JAX's placement rule (leading axis;
  axis 1 for the step-major teacher chains and `recon_phase_a`'s `eps_*`;
  a leaf whose axis does not divide by dp is replicated), with the port's
  two additions for what SPMD places freely: the prompt leaves of nB rows
  split block by block, and named leaves replicated (`shard_train_batch`).
- Global reductions in the losses (`collectives.py`): under
  `data_parallel(mesh)`, `gsum` all-reduces a local sum, `gmean` is a
  global mean; outside they are the identity and `Tensor.mean`.
- `ShardedDraws`: the random draws of a loss taken for the global batch and
  sliced, so a rank draws what the single process draws for its instances.
- `all_reduce_grads`: the gradients summed over the ranks in one flat
  buffer per dtype, in parameter order, before clipping and the optimizer.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from adaface_tpu_torch.utils.tensor import Draws

# the step-major leaves [S, B, …] (`mesh.py:65-90` of the JAX package)
STEP_MAJOR_KEYS = ("teacher_x_ts", "teacher_ts", "teacher_noise_preds")
# the prompt leaves of a train batch: nB rows, block-major
PROMPT_BLOCK_KEYS = ("prompt_ids", "splice_map", "prompt_emb_mask", "prompt_pad_mask",
                     "merge_map")
# leaves of a train batch that hold no batch axis, whatever their shape
REPLICATED_KEYS = ("uncond_ids", "clip_skip_weights", "clip_skip_weights_fixed",
                   "recon_attn_lora_gate")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: the default process
    group."""

    dp: int
    rank: int
    local_rank: int
    device: torch.device = torch.device("cpu")


def make_mesh(dp: int | None = None, tp: int = 1) -> Mesh:
    """The data-parallel group of `dp` ranks, one a process: the default
    process group where one is already up (it must hold `dp` ranks), else
    one initialised from `torchrun`'s environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) over NCCL when CUDA is up, gloo
    otherwise. Each rank's device is cuda:LOCAL_RANK where CUDA is up (gloo
    takes CUDA tensors too: two ranks may share a card over gloo, as NCCL
    refuses)."""
    if tp != 1:
        raise NotImplementedError(
            "tensor parallelism (tp > 1, shard_params with DEFAULT_TP_RULES) is not ported: "
            "ROADMAP §1 item 6 queues it")
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"data parallelism (dp={dp}) needs one process a rank: start it with "
                f"`torchrun --nproc_per_node {dp or 'N'} ...`, or set up "
                "torch.distributed.init_process_group before")
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo")
    world = dist.get_world_size()
    if dp is not None and dp != world:
        raise ValueError(f"dp={dp} but the process group holds {world} ranks")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    device = torch.device("cuda", local) if torch.cuda.is_available() else torch.device("cpu")
    return Mesh(world, dist.get_rank(), local, device)


def _slice(x, rank: int, dp: int, axis: int):
    if not isinstance(x, torch.Tensor) or x.ndim <= axis or x.shape[axis] % dp:
        return x  # replicated
    n = x.shape[axis] // dp
    return x.narrow(axis, rank * n, n)


def shard_batch(batch, rank: int, dp: int, replicated=(), blocks: dict | None = None):
    """This rank's part of a batch by JAX's rule: each leaf's leading axis
    split in dp equal slices, axis 1 for the step-major leaves, a leaf whose
    axis does not divide by dp (or is not a tensor) replicated. `replicated`
    names leaves kept whole; `blocks` maps a leaf to its number of
    block-major row blocks, each split on its own."""
    blocks = blocks or {}

    def leaf(k, x, axis=0):
        if k in replicated:
            return x
        if k in blocks and isinstance(x, torch.Tensor):
            nb = blocks[k]
            return torch.cat([_slice(c, rank, dp, 0) for c in x.chunk(nb)])
        return _slice(x, rank, dp, axis)

    if not isinstance(batch, dict):
        return _slice(batch, rank, dp, 0)
    out = {}
    for k, v in batch.items():
        if k == "recon_phase_a" and isinstance(v, dict):
            out[k] = {k2: _slice(x, rank, dp, 1 if k2.startswith("eps_") else 0)
                      for k2, x in v.items()}
        elif isinstance(v, dict):
            out[k] = {k2: leaf(k2, x) for k2, x in v.items()}
        else:
            out[k] = leaf(k, v, 1 if k in STEP_MAJOR_KEYS else 0)
    return out


def shard_train_batch(batch: dict, mesh: Mesh) -> dict:
    """A prepared train batch's slice for this rank: the prompt leaves split
    block by block, the named leaves whole, the rest by `shard_batch`; the
    global batch's first instance's image-prompt embeddings and noise ride
    whole beside (`first_img_prompt_embs`, `first_noise`: the comp iteration
    conditions every instance on them)."""
    b = batch["x_start"].shape[0]
    if b % mesh.dp:
        raise ValueError(f"a global batch of {b} does not split over dp={mesh.dp}")
    blocks = {k: batch[k].shape[0] // b for k in PROMPT_BLOCK_KEYS if k in batch}
    first = {f"first_{k}": batch[k][:1] for k in ("img_prompt_embs", "noise") if k in batch}
    return shard_batch({**batch, **first}, mesh.rank, mesh.dp,
                       REPLICATED_KEYS + tuple(first), blocks)


class ShardedDraws(Draws):
    """Draws for the global batch, sliced: a draw whose `batch_axis` is
    given is taken at dp × its local size on that axis and narrowed to this
    rank's slice; the others are taken whole. So each rank draws, in order,
    what the single process draws, and keeps its own instances'."""

    def __init__(self, base: Draws, mesh: Mesh):
        self.base, self.mesh = base, mesh

    def _global(self, shape, batch_axis):
        shape = list(shape)
        if batch_axis is not None:
            shape[batch_axis] *= self.mesh.dp
        return tuple(shape)

    def _local(self, x, shape, batch_axis):
        if batch_axis is None:
            return x
        n = shape[batch_axis]
        return x.narrow(batch_axis, self.mesh.rank * n, n)

    def normal(self, shape, device, batch_axis=None):
        return self._local(self.base.normal(self._global(shape, batch_axis), device), shape,
                           batch_axis)

    def uniform(self):
        return self.base.uniform()

    def integers(self, shape, low, high, device, batch_axis=None):
        return self._local(self.base.integers(self._global(shape, batch_axis), low, high,
                                              device), shape, batch_axis)

    def uniforms(self, shape, device, batch_axis=None):
        return self._local(self.base.uniforms(self._global(shape, batch_axis), device), shape,
                           batch_axis)


def all_reduce_grads(params: list[torch.nn.Parameter], mesh: Mesh | None) -> None:
    """Sum each parameter's gradient over the ranks: one flat buffer per
    dtype, in the parameters' order, one all-reduce each. A parameter with
    no gradient on any rank keeps none (an optimizer skips it, as a single
    process does); one missing on some ranks only counts as zero there."""
    if mesh is None or mesh.dp == 1:
        return
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.int32,
                       device=mesh.device)
    dist.all_reduce(has, op=dist.ReduceOp.MAX)
    live = [p for p, h in zip(params, has.tolist()) if h]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict = {}
    for p in live:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        off = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def all_reduce_metrics(metrics: dict, mesh: Mesh | None) -> dict:
    """Scalar metrics averaged over the ranks, in one all-reduce (where
    the losses reduced globally every rank holds the same values already)."""
    if mesh is None or mesh.dp == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=mesh.device).reshape(()) for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    vals = vals / mesh.dp
    return {k: vals[i] for i, k in enumerate(keys)}
