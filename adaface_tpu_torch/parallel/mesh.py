"""Data and tensor parallelism over `torch.distributed`.

Counterpart of `adaface_tpu/parallel/mesh.py`. The JAX package's mesh is
SPMD: every rank runs the graph of the global batch and XLA places each
leaf's shard and the collectives. The port runs one process a rank
(`torchrun`) and keeps JAX's invariant by construction: a step on the mesh
computes the single-device step on the global batch.

- `make_mesh(dp, tp)`: the process group (NCCL on CUDA, gloo on the CPU),
  one rank a process, rank and local rank from the environment `torchrun`
  sets; the dp × tp grid as JAX's `reshape(dp, tp)` lays it out (global
  rank = dp_rank · tp + tp_rank), with a process group for each dp column
  and each tp row.
- `shard_batch`: a dp rank's slice by JAX's placement rule (leading axis;
  axis 1 for the step-major teacher chains and `recon_phase_a`'s `eps_*`;
  a leaf whose axis does not divide by dp is replicated), with the port's
  two additions for what SPMD places freely: the prompt leaves of nB rows
  split block by block, and named leaves replicated (`shard_train_batch`).
  The tp ranks of one dp rank hold the same slice.
- Global reductions in the losses (`collectives.py`): under
  `data_parallel(mesh)`, `gsum` all-reduces a local sum over the dp group,
  `gmean` is a global mean; outside they are the identity and `Tensor.mean`.
- `ShardedDraws`: the random draws of a loss taken for the global batch and
  sliced, so a dp rank draws what the single process draws for its
  instances (and its tp ranks draw alike).
- `all_reduce_grads`: the gradients summed over the dp group in one flat
  buffer per dtype, in parameter order, before clipping and the optimizer.
- `shard_params` with `DEFAULT_TP_RULES`: JAX's rules, matched against the
  JAX parameter path of each weight of a UNet or a CLIP tower; a matched
  weight is cut in place to this tp rank's part, and its layer computes
  under the placement (`models/unet.py`, `models/clip.py`: heads split,
  partial products reduced over tp, the bias of a row-split projection
  added once).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

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
    """One rank's view of the dp × tp grid: `rank` is the global rank
    (dp_rank · tp + tp_rank); `dp_group` the ranks of this tp rank's column
    (None: the default group, where tp is 1), `tp_group` those of this dp
    rank's row (None where tp is 1)."""

    dp: int
    rank: int
    local_rank: int
    device: torch.device = torch.device("cpu")
    tp: int = 1
    dp_group: Any = None
    tp_group: Any = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: int | None = None, tp: int = 1) -> Mesh:
    """The dp × tp grid of ranks, one a process: the default process group
    where one is already up (it must hold dp · tp ranks), else one
    initialised from `torchrun`'s environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) over NCCL when CUDA is up, gloo otherwise.
    `dp` None: the world over tp. Each rank's device is cuda:LOCAL_RANK
    where CUDA is up (gloo takes CUDA tensors too: two ranks may share a card
    over gloo, as NCCL refuses). Every rank builds every dp and tp group, in
    one order."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            n = (dp or 1) * tp if dp else "N"
            raise RuntimeError(
                f"a mesh of dp={dp} × tp={tp} needs one process a rank: start it with "
                f"`torchrun --nproc_per_node {n} ...`, or set up "
                "torch.distributed.init_process_group before")
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo")
    world = dist.get_world_size()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp={dp} × tp={tp} but the process group holds {world} ranks")
    rank = dist.get_rank()
    dp_group = tp_group = None
    if tp > 1:
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if rank % tp == t:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if rank // tp == d:
                tp_group = g
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda", local) if torch.cuda.is_available() else torch.device("cpu")
    return Mesh(dp, rank, local, device, tp, dp_group, tp_group)


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
    return shard_batch({**batch, **first}, mesh.dp_rank, mesh.dp,
                       REPLICATED_KEYS + tuple(first), blocks)


class ShardedDraws(Draws):
    """Draws for the global batch, sliced: a draw whose `batch_axis` is
    given is taken at dp × its local size on that axis and narrowed to this
    dp rank's slice; the others are taken whole. So each rank draws, in
    order, what the single process draws, and keeps its own instances' (the
    tp ranks of a dp rank, the same)."""

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
        return x.narrow(batch_axis, self.mesh.dp_rank * n, n)

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
    """Sum each parameter's gradient over the dp ranks: one flat buffer per
    dtype, in the parameters' order, one all-reduce each. A parameter with
    no gradient on any rank keeps none (an optimizer skips it, as a single
    process does); one missing on some ranks only counts as zero there.
    The tp ranks of a dp rank hold the whole gradient already (the tp
    region's `copy_to_tp` sums the partial ones)."""
    if mesh is None or mesh.dp == 1:
        return
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.int32,
                       device=mesh.device)
    dist.all_reduce(has, op=dist.ReduceOp.MAX, group=mesh.dp_group)
    live = [p for p, h in zip(params, has.tolist()) if h]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict = {}
    for p in live:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.dp_group)
        off = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def all_reduce_metrics(metrics: dict, mesh: Mesh | None) -> dict:
    """Scalar metrics averaged over the dp ranks, in one all-reduce (where
    the losses reduced globally every rank holds the same values already)."""
    if mesh is None or mesh.dp == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=mesh.device).reshape(()) for k in keys])
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    vals = vals / mesh.dp
    return {k: vals[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# tensor parallelism: JAX's rules on the port's weights
# ---------------------------------------------------------------------------

# JAX's `DEFAULT_TP_RULES` (`mesh.py:95-102`): (regex of a leaf's path, its
# PartitionSpec as a tuple over JAX's [in, out] weight): the out-features of
# the q/k/v and MLP-in projections split over 'tp', the in-features of the
# output projections
DEFAULT_TP_RULES: list[tuple[str, tuple]] = [
    (r".*attn.*/(q|k|v)/w$", (None, "tp")),
    (r".*attn.*/o/w$", ("tp", None)),
    (r".*mlp/fc1/w$", (None, "tp")),
    (r".*mlp/fc2/w$", ("tp", None)),
    (r".*ff/proj_in/w$", (None, "tp")),
    (r".*ff/proj_out/w$", ("tp", None)),
]


def _shardable_types() -> tuple:
    """The modules whose forward computes under a tp placement: the UNets and
    the CLIP towers, what the JAX package's callers shard."""
    from adaface_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
    from adaface_tpu_torch.models.unet import UNet2DConditionModel

    return UNet2DConditionModel, CLIPTextModel, CLIPVisionModel


def _tp_plan(module: torch.nn.Module, tp: int, rules) -> tuple[dict, dict, list]:
    """→ (plan {port weight: (dim, parts)}, placements {JAX path: spec},
    units [(layer, attribute)]) of `module` at `tp`. A unit (a layer's
    attention, MLP or GEGLU) is split where the rules match its weights as
    JAX's defaults do and tp divides its heads (its width); where they do
    not, it stays whole on every rank."""
    from adaface_tpu_torch.core.bridge import jax_leaf_paths

    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def rule(path: str):
        return next((spec for pat, spec in compiled if pat.match(path)), None)

    placements = {path: () for path in jax_leaf_paths(module)}
    plan, units, covered = {}, [], set()
    for name, layer in module.named_modules():
        if not hasattr(layer, "tp_units"):
            continue
        prefix = f"{name}." if name else ""
        for attr, splits, divides in layer.tp_units():
            want = {prefix.replace(".", "/") + leaf: (None, "tp") if dim == 0 else ("tp", None)
                    for _, leaves, dim, _ in splits for leaf in leaves}
            covered.update(want)
            got = {path: rule(path) for path in want}
            if all(spec is None for spec in got.values()):
                continue
            if got != want:
                raise ValueError(f"shard_params: the rules place {prefix}{attr[3:]} as "
                                 f"{got}; the port splits a unit only as {want}")
            if not divides(tp):
                continue  # the split would not fall on head boundaries: whole
            for weight, _, dim, parts in splits:
                plan[prefix + weight] = (dim, parts)
            placements.update(want)
            units.append((layer, attr))
    stray = sorted(p for p in placements if p not in covered and rule(p) is not None)
    if stray:
        raise NotImplementedError(
            f"shard_params: no tensor-parallel forward for {stray[:4]} of "
            f"{type(module).__name__}")
    return plan, placements, units


def shard_params(module_or_state_dict, mesh: Mesh, rules=None, like=None) -> dict:
    """JAX's `shard_params` (`mesh.py:105-128`) on the port: each weight of
    a UNet or a CLIP tower whose JAX path a rule matches is cut, in place, to
    this tp rank's part, and its layer computes under the placement from
    then on. → the placement map {JAX path: spec} of every leaf (() for a
    replicated one; a fused `qkv` / `kv` weight answers for each of q, k, v).

    The port's conditions beyond JAX's divisibility: a split falls on head
    boundaries (else the layer's q, k, v and o stay whole), and a GEGLU /
    MKV weight takes this rank's slice of each of its parts (`tp_part`).
    The column-split projections' biases stay whole, as JAX leaves them,
    and are sliced at use. A module without a tp-aware forward (the MMDiT,
    the motion modules, the adapters' towers) is refused by name.

    A state dict (the comp UNet's weights, before they are swapped in) is
    cut in place by the map of `like`, the module it loads into. At tp 1
    nothing is cut."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    if isinstance(module_or_state_dict, dict):
        if like is None:
            raise ValueError("shard_params: a state dict is cut by the map of the module it "
                             "loads into (like=)")
        sharded = getattr(like, "_tp_plan", None)
        plan, placements = sharded if sharded is not None else _tp_plan(like, mesh.tp,
                                                                          rules)[:2]
        if mesh.tp > 1:
            sd = module_or_state_dict
            for key, (dim, parts) in plan.items():
                sd[key] = _part(sd[key], mesh, dim, parts)
        return placements
    module = module_or_state_dict
    if not isinstance(module, _shardable_types()):
        raise NotImplementedError(
            f"shard_params: {type(module).__name__} has no tensor-parallel forward (the port "
            "splits the UNets and the CLIP towers, what the JAX package's callers shard)")
    if getattr(module, "_tp_plan", None) is not None:
        raise ValueError("shard_params: the module is sharded already")
    plan, placements, units = _tp_plan(module, mesh.tp, rules)
    if mesh.tp == 1:
        return placements
    with torch.no_grad():
        for key, (dim, parts) in plan.items():
            lin = module.get_submodule(key.rpartition(".")[0])
            w = _part(lin.weight, mesh, dim, parts)
            lin.weight = torch.nn.Parameter(w, requires_grad=lin.weight.requires_grad)
            lin.out_features, lin.in_features = w.shape
    for layer, attr in units:
        setattr(layer, attr, mesh)
    module._tp_plan = (plan, placements)
    return placements


def _part(t: torch.Tensor, mesh: Mesh, dim: int, parts: int) -> torch.Tensor:
    from adaface_tpu_torch.parallel.collectives import tp_part

    return tp_part(t, mesh, dim, parts).contiguous().clone()
