"""Data parallelism over ``torch.distributed`` (counterpart of
``scanobjectnn_tpu/parallel/mesh.py``).

JAX jits the training step over a 1-D ``Mesh(('data',))`` and GSPMD
computes the step of the global batch: global BatchNorm statistics, summed
gradients, the random draws of the global batch.  A process group gives
none of that, so this module names what each rank owns and the reductions
that rebuild the global step:

  * ``make_mesh(devices=None, axes=("data",), shape=None)``: the ranks of
    the default process group, one device each (``devices``: this rank's
    one device; default ``cuda:LOCAL_RANK``), along the one batch axis.
    Without an initialised group it is a world of one with no group, on
    which no collective is called.  The port has no model axis, so a mesh
    of more than one axis is refused; ``shape`` may only restate the world.
  * ``batch_sharding(mesh)`` / ``replicated_sharding(mesh)``: the rows of a
    global batch this rank owns (its contiguous share; all of them).  A
    batch that does not split evenly raises, as JAX's sharding does.
    ``shard_batch(batch, mesh)`` takes those rows of a host batch and puts
    them on the rank's device.
  * ``all_reduce_sum`` / ``all_reduce_mean``: differentiable cross-replica
    reductions, the analogue of ``jax.lax.psum``/``pmean`` under autodiff.
    The forward sums over the group (and divides by its size); the
    backward sums the incoming gradients over the group (and divides): the
    rule under which the average of every rank's parameter gradients, which
    the ``Trainer`` takes, is the gradient of the mean of the ranks' losses.
    ``sum_parts`` sums a few 1-D tensors over the group in one collective,
    without a gradient (the fused ops' statistics and backward sums).
  * ``global_batch(mesh)``: the block in which a training forward draws as
    the global batch would.  ``draw_rows`` makes a random draw of the
    global batch's rows and keeps this rank's (dropout's masks, PointCNN's
    "ids" sampling), so a draw does not depend on the sharding, as a JAX
    key's does not.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "RowSharding",
    "all_reduce_mean",
    "all_reduce_sum",
    "batch_sharding",
    "draw_rows",
    "gather_rows",
    "global_batch",
    "make_mesh",
    "replicated_sharding",
    "shard_batch",
    "sum_parts",
]


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the group: ``rank`` of ``size`` ranks along the
    batch axis ``axis_name``, driving ``device``.  ``group`` is None for a
    world of one without a process group."""

    axis_name: str
    size: int
    rank: int
    device: torch.device
    group: object | None


def make_mesh(
    devices: Sequence[str | torch.device] | str | torch.device | None = None,
    axes: Sequence[str] = ("data",),
    shape: Sequence[int] | None = None,
) -> Mesh:
    """The mesh of the default process group (module doc).  ``devices`` is
    this rank's device, alone or in a sequence of one: every rank drives
    exactly one.  ``axes`` names the one (batch) axis; ``shape``, where
    given, is the world size alone."""
    if devices is None:
        devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    if len(devices) != 1:
        raise ValueError(f"a mesh rank drives one device, got {len(devices)}: {devices}")
    device = devices[0]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: device {device} asked for, but torch.cuda.is_available() is False")
    if len(axes) != 1:
        raise ValueError(f"the port's mesh has one axis, the batch's: got axes {tuple(axes)}")
    if dist.is_available() and dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if shape is not None and tuple(int(s) for s in shape) != (world,):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the world of {world} ranks")
    return Mesh(axes[0], world, rank, device, group)


@dataclass(frozen=True)
class RowSharding:
    """Part ``index`` of ``parts`` equal contiguous parts of the leading
    axis."""

    index: int
    parts: int

    def rows(self, n: int) -> slice:
        if n % self.parts:
            raise ValueError(f"a global batch of {n} rows does not split evenly over {self.parts} ranks")
        b = n // self.parts
        return slice(self.index * b, (self.index + 1) * b)


def batch_sharding(mesh: Mesh, axis: str = "data") -> RowSharding:
    """The leading (batch) axis split across ``axis``: this rank's part."""
    if axis != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis!r}")
    return RowSharding(mesh.rank, mesh.size)


def replicated_sharding(mesh: Mesh) -> RowSharding:
    """Every row on every rank."""
    return RowSharding(0, 1)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of every array or tensor of a host ``batch``, on the
    rank's device."""
    sharding = batch_sharding(mesh, axis)
    return {k: torch.as_tensor(v[sharding.rows(len(v))]).to(mesh.device) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is the sum of the
    incoming gradients over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (the sum divided by its size; at a
    world of one, ``x`` bit for bit); its gradient the mean of the incoming
    gradients."""
    return all_reduce_sum(x, group) / dist.get_world_size(group)


def sum_parts(parts: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Each 1-D tensor of ``parts`` summed over ``group``, by one
    ``all_reduce`` of their concatenation.  No gradient: for the fused ops'
    own forward and backward."""
    both = torch.cat(list(parts))
    dist.all_reduce(both, group=group)
    return list(both.split([int(p.shape[0]) for p in parts]))


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``x`` (this rank's share of the batch along the
    leading axis), in rank order, on every rank: the shares summed into a
    zero buffer by one ``all_reduce`` (gloo reduces CUDA tensors but
    gathers none), so each value arrives unchanged but for the sign of a
    zero.  No gradient."""
    sharding = batch_sharding(mesh, mesh.axis_name)
    work = x.float() if x.is_floating_point() and x.element_size() < 4 else x  # bf16 rides in f32, exactly
    out = work.new_zeros((x.shape[0] * sharding.parts, *x.shape[1:]))
    out[sharding.rows(out.shape[0])] = work
    dist.all_reduce(out, group=mesh.group)
    return out.to(x.dtype)


_STEP_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar("step_mesh", default=None)


@contextlib.contextmanager
def global_batch(mesh: Mesh | None):
    """Inside the block, ``draw_rows`` acts for the global
    batch sharded over ``mesh`` (a mesh without a group, or None: this
    process holds the whole batch)."""
    token = _STEP_MESH.set(mesh if mesh is not None and mesh.group is not None else None)
    try:
        yield
    finally:
        _STEP_MESH.reset(token)


def draw_rows(draw: Callable[[int, slice], torch.Tensor], rows: int) -> torch.Tensor:
    """``draw(n, mine)`` makes a random tensor of ``n`` leading rows, of
    which rows ``mine`` are this rank's.  Returns this rank's ``rows`` rows
    of the draw for the global batch inside ``global_batch``, else
    ``draw(rows, slice(0, rows))``."""
    mesh = _STEP_MESH.get()
    if mesh is None:
        return draw(rows, slice(0, rows))
    sharding = batch_sharding(mesh, mesh.axis_name)
    n = rows * sharding.parts
    mine = sharding.rows(n)
    return draw(n, mine)[mine]

