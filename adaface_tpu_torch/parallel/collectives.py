"""The losses' global reductions under data parallelism.

Under `data_parallel(mesh)`, `gsum` all-reduces a local sum. Its backward
passes the gradient through: every rank builds the same loss from the same
summed values, and each differentiates its own addends; `all_reduce_grads`
(`mesh.py`) then adds the ranks' gradients. A loss that divides by a
batch-dependent count (a masked mean, the detected faces) divides by the
summed count, so the ranks' losses equal the single-device loss on the
global batch. A global value that feeds a rank's own computation again
(the perturbation's std scaling each rank's noise) enters it through
`to_local`, whose backward sums the ranks' gradients. Outside
`data_parallel`, `gsum` and `to_local` are the identity and `gmean` is
`Tensor.mean`: a single process computes what it did before, bit for bit. No import of `utils.tensor` here: it imports these.

Under a dp × tp mesh these reduce over the dp group (the ranks of one tp
rank's column): the tp ranks of one dp rank hold the same instances.

The tensor-parallel region (`models/unet.py`, `models/clip.py` under
`mesh.shard_params`) takes three autograd Functions over the tp group:
`copy_to_tp` (a replicated input entering column-split projections:
identity forward, the gradient summed over tp backward), `reduce_from_tp`
(a row-split projection's partial products summed over tp forward, the
gradient passed through backward) and `gather_heads` (the heads of every tp
rank for a consumer that reads them all: all-gathered forward, this rank's
slice of the gradient backward). `all_reduce_tp` sums forward and backward
(a partial value every rank then reads for its own slice). The collectives
run in fp32 (bf16 values are widened, exactly, and narrowed back); over
gloo a gather stages CUDA tensors through the host.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_ACTIVE: list = []  # the meshes of the open `data_parallel` blocks


@contextlib.contextmanager
def data_parallel(mesh):
    """Within: `gsum` / `gmean` reduce over `mesh`'s dp ranks (nothing when it
    is None or of one dp rank), and `active_tp_mesh` names a mesh of tp > 1."""
    active = mesh is not None and (mesh.dp > 1 or mesh.tp > 1)
    if active:
        _ACTIVE.append(mesh)
    try:
        yield
    finally:
        if active:
            _ACTIVE.pop()


def active_mesh():
    """The innermost `data_parallel` mesh of more than one dp rank, or None."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].dp > 1 else None


def active_tp_mesh():
    """The innermost `data_parallel` mesh of more than one tp rank, or None."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].tp > 1 else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank builds the same loss from the summed value: each takes
        # the gradient of its own addend, and `all_reduce_grads` adds them
        return g, None


def gsum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of the active mesh (x itself outside
    `data_parallel`)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(float(x), device=mesh.device)
    return _AllReduceSum.apply(x, mesh.dp_group)


def gmean(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """The mean of `x` over the global batch (over `dim` only, where given:
    the batch's axis): `x.mean()` outside `data_parallel`, else the summed
    local sums over dp × the local count (every rank holds an equal slice)."""
    mesh = active_mesh()
    if mesh is None:
        return x.mean() if dim is None else x.mean(dim)
    if dim is None:
        return gsum(x.sum()) / (x.numel() * mesh.dp)
    return gsum(x.sum(dim)) / (x.shape[dim] * mesh.dp)


def global_batch_size(b: int) -> int:
    mesh = active_mesh()
    return b * mesh.dp if mesh is not None else b


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def to_local(x: torch.Tensor) -> torch.Tensor:
    """A global value (made of `gsum`s, the same on every rank) entering a
    rank's own computation: the identity forward; backward, the ranks'
    gradients summed, since each rank's part of the loss reads it. (A global
    value that only the replicated loss reads needs no marking: `gsum`'s
    pass-through backward is right for it.) Outside `data_parallel`, x."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _ToLocal.apply(x, mesh.dp_group)


def _reduce_nograd(x: torch.Tensor, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=active_mesh().dp_group)
    return y


def _local(x: torch.Tensor, reduce, identity: float) -> torch.Tensor:
    """`reduce(x)`, or the reduction's identity where x is empty (a rank that
    holds none of the instances still joins the collective)."""
    if x.numel() == 0:
        return torch.full((), identity, dtype=x.dtype, device=x.device)
    return reduce(x)


def gmin(x: torch.Tensor) -> torch.Tensor:
    """`x.min()` over the global batch, without gradient (a gate); +inf
    where no rank holds an instance."""
    m = _local(x, torch.min, float("inf"))
    if active_mesh() is None:
        return m
    return _reduce_nograd(m, dist.ReduceOp.MIN)


def gmax(x: torch.Tensor) -> torch.Tensor:
    """`x.max()` over the global batch, without gradient; -inf where no
    rank holds an instance."""
    m = _local(x, torch.max, float("-inf"))
    if active_mesh() is None:
        return m
    return _reduce_nograd(m, dist.ReduceOp.MAX)


def gall(x: torch.Tensor) -> torch.Tensor:
    """`x.prod()` of {0, 1} flags over the global batch: 1 where every
    instance's flag is (without gradient, a gate; 1 over no instance)."""
    if active_mesh() is None:
        return x.prod()
    return _reduce_nograd(_local(x, torch.min, 1.0), dist.ReduceOp.MIN)


def gstd(x: torch.Tensor) -> torch.Tensor:
    """`x.std(unbiased=False)` over the global batch."""
    if active_mesh() is None:
        return x.std(unbiased=False)
    return gmean((x - to_local(gmean(x))) ** 2).sqrt()


def gnorm(x: torch.Tensor) -> torch.Tensor:
    """`x.norm()` over the global batch."""
    if active_mesh() is None:
        return x.norm()
    return gsum((x * x).sum()).sqrt()


# ---------------------------------------------------------------------------
# the tensor-parallel region
# ---------------------------------------------------------------------------


def _tp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the tp group, in fp32 (x's dtype kept)."""
    y = x.float().contiguous()
    if y is x:
        y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.tp_group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each tp rank differentiated its own columns: the input's gradient is
        # their sum
        return _tp_sum(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _tp_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # every tp rank reads the summed output alike
        return g, None


class _AllReduceTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _tp_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        # each tp rank reads the sum for its own slice: the gradients add
        return _tp_sum(g, ctx.mesh), None


def _tp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    stage = x.is_cuda and dist.get_backend(mesh.tp_group) == "gloo"
    src = x.detach().float()
    if stage:
        src = src.cpu()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.tp)]
    dist.all_gather(parts, src, group=mesh.tp_group)
    return torch.cat(parts, dim=dim).to(device=x.device, dtype=x.dtype)


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _tp_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        # the consumer is replicated: every tp rank holds the whole gradient
        return g.narrow(ctx.dim, ctx.mesh.tp_rank * ctx.n, ctx.n), None, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated value entering this rank's column-split projections: x
    itself; backward, the gradient summed over the tp group."""
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-split projection's partial product summed over the tp group;
    backward, the gradient passed through."""
    return _ReduceFromTP.apply(x, mesh)


def all_reduce_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """A partial value summed over the tp group, forward and backward."""
    return _AllReduceTP.apply(x, mesh)


def gather_heads(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """Every tp rank's heads (or width) of x along `dim`, in rank order;
    backward, this rank's slice of the gradient."""
    return _GatherHeads.apply(x, mesh, dim)


def row_parallel_out(partial: torch.Tensor, bias, mesh) -> torch.Tensor:
    """A row-split projection's output: the partial products summed over the
    tp group, then the bias, once."""
    out = reduce_from_tp(partial, mesh)
    return out if bias is None else out + bias.to(out.dtype)


def tp_part(t: torch.Tensor, mesh, dim: int = 0, parts: int = 1) -> torch.Tensor:
    """This tp rank's part of `t` along `dim`, where that axis holds `parts`
    blocks laid side by side (q | k | v; a GEGLU's val | gate; MKV's copies):
    the rank's slice of each block, in block order."""
    shape = list(t.shape)
    n = shape[dim]
    blocks = t.reshape(*shape[:dim], parts, mesh.tp, n // (parts * mesh.tp), *shape[dim + 1:])
    return blocks.select(dim + 1, mesh.tp_rank).reshape(
        *shape[:dim], n // mesh.tp, *shape[dim + 1:])


def check_tp_equal(x: torch.Tensor, what: str) -> None:
    """Under a mesh of tp > 1, raise on every tp rank unless x is the same,
    bit for bit, on all of them (host work on replicated values, such as
    face detection, must see one input)."""
    mesh = active_tp_mesh()
    if mesh is None:
        return
    src = x.detach().cpu().contiguous() if dist.get_backend(mesh.tp_group) == "gloo" \
        else x.detach().contiguous()
    ref = src.clone()
    dist.broadcast(ref, src=mesh.rank - mesh.tp_rank, group=mesh.tp_group)
    bad = torch.tensor([0.0 if torch.equal(ref, src) else 1.0], device=src.device)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=mesh.tp_group)
    if bad.item():
        raise RuntimeError(f"tensor parallelism: {what} differs between the tp ranks of dp "
                           f"rank {mesh.dp_rank}")
