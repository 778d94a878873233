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
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_ACTIVE: list = []  # the meshes of the open `data_parallel` blocks


@contextlib.contextmanager
def data_parallel(mesh):
    """Within: `gsum` / `gmean` reduce over `mesh`'s ranks (nothing when it is
    None or of one rank)."""
    active = mesh is not None and mesh.dp > 1
    if active:
        _ACTIVE.append(mesh)
    try:
        yield
    finally:
        if active:
            _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank builds the same loss from the summed value: each takes
        # the gradient of its own addend, and `all_reduce_grads` adds them
        return g


def gsum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of the active mesh (x itself outside
    `data_parallel`)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(float(x), device=mesh.device)
    return _AllReduceSum.apply(x)


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
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def to_local(x: torch.Tensor) -> torch.Tensor:
    """A global value (made of `gsum`s, the same on every rank) entering a
    rank's own computation: the identity forward; backward, the ranks'
    gradients summed, since each rank's part of the loss reads it. (A global
    value that only the replicated loss reads needs no marking: `gsum`'s
    pass-through backward is right for it.) Outside `data_parallel`, x."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _ToLocal.apply(x)


def _reduce_nograd(x: torch.Tensor, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op)
    return y


def gmin(x: torch.Tensor) -> torch.Tensor:
    """`x.min()` over the global batch, without gradient (a gate)."""
    if active_mesh() is None:
        return x.min()
    return _reduce_nograd(x.min(), dist.ReduceOp.MIN)


def gall(x: torch.Tensor) -> torch.Tensor:
    """`x.prod()` of {0, 1} flags over the global batch: 1 where every
    instance's flag is (without gradient, a gate)."""
    if active_mesh() is None:
        return x.prod()
    return _reduce_nograd(x.min(), dist.ReduceOp.MIN)


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
