"""The device mesh on ``torch.distributed`` (port of ``cryovit_tpu/parallel/mesh.py``).

The JAX package is one process driving many devices: a ``jax.sharding.Mesh``
over the chips, the batch axis sharded along ``"data"``, parameters
replicated, and XLA inserting the collectives. PyTorch runs one process per
GPU, so here the mesh is the world of processes (the group, this rank, the
axis names and sizes, the rank's device) and the collectives are written
out.

``mesh_shape`` (``TrainerConfig.mesh_shape``) keeps the JAX package's rules:
a name → size mapping where −1 fills with the remaining processes, e.g.
``{"data": -1}``. The port has no model parallelism: a batch is split only
over a ``"data"`` axis (:data:`DATA_AXIS`) that is the whole mesh; an axis
other than that only shapes the mesh, and the trainer then takes the
replicated step.

Every collective goes through :class:`Mesh`, which uses only
``all_reduce`` (sum) and ``broadcast``: the two collectives that NCCL,
gloo on CPU tensors and gloo on CUDA tensors all have. A gather is an
all-reduce of zero-filled per-rank slots.

Launching: ``torchrun --nproc_per_node=N -m ... trainer.mesh_shape='{data:
-1}'``. Where no process group exists and the environment names one
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
as ``torchrun`` sets them), :func:`make_mesh` initialises it: NCCL with the
rank on ``cuda:LOCAL_RANK``, gloo when the caller asked for the CPU by
name; a caller that made its own group (gloo for ranks sharing one GPU)
keeps it. Without either the world is one process. As everywhere in the
port, no device means the GPU.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from cryovit_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "Sharding",
    "all_reduce_sum",
    "batch_sharding",
    "global_sum",
    "make_mesh",
    "replicate",
    "shard_batch",
]


# the mesh axis a batch is split over (the port has no model parallelism)
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world of processes and its collectives.

    ``shape`` maps axis names to sizes (in order); ``group`` is the process
    group (None for a mesh of one, or for a mesh made from a bare world
    size, which can describe a layout but not communicate); ``backend`` is
    the group's backend; ``device`` the rank's device (None for a mesh
    that only lays out axes). All collectives are sums or broadcasts, in
    place, and no-ops on a mesh of one.
    """

    shape: dict[str, int]
    rank: int = 0
    device: torch.device | None = None
    group: Any = None
    backend: str | None = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _check(self) -> None:
        if self.group is None:
            raise RuntimeError(
                f"mesh {self.shape} has no process group: it was made from a world size "
                "alone; initialise torch.distributed (or launch with torchrun) first"
            )

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.size == 1:
            return t
        self._check()
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
        if self.size == 1:
            return t
        self._check()
        dist.broadcast(t, src, group=self.group)
        return t

    def gather(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's equal-size ``local`` concatenated along ``dim`` in
        rank order, on every rank: an all-reduce of zero-filled slots (each
        slot written by one rank, so the sum is exact)."""
        if self.size == 1:
            return local
        k = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = k * self.size
        out = local.new_zeros(shape)
        out.narrow(dim, self.rank * k, k).copy_(local)
        return self.all_reduce_(out)

    def all_reduce_flat_(self, tensors: list[torch.Tensor]) -> None:
        """Sum a list of tensors of one dtype over the ranks, in place, with
        one collective on their concatenation (on the rank's device, so
        NCCL may take tensors that lie elsewhere, as AdamW's step counts do)."""
        self._flat(tensors, self.all_reduce_)

    def broadcast_flat_(self, tensors: list[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s values of a list of tensors of one dtype, in place,
        with one collective on their concatenation."""
        self._flat(tensors, lambda t: self.broadcast_(t, src))

    def _flat(self, tensors: list[torch.Tensor], op) -> None:
        if self.size == 1 or not tensors:
            return
        device = self.device if self.device is not None else tensors[0].device
        flat = torch.cat([t.reshape(-1).to(device) for t in tensors])
        op(flat)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset : offset + n].view_as(t))
            offset += n


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    incoming gradient: each rank's backward carries the paths through its
    own outputs, and the owner of an input needs them all."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, differentiably; ``x`` itself
    without a mesh or on a mesh of one."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


def global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The JAX package's ``_gsum`` (``models/losses.py``): ``x.sum()``, and
    with a mesh its value summed over the ranks while autograd sees only the
    local sum (``allreduce(s) + (s − s)``, the first term detached: the value
    is the all-reduce's bit for bit, the same on every rank). So each rank's
    gradient is its own data's contribution at the global sums, and the
    trainer's sum of the ranks' gradients is the global gradient."""
    s = x.sum()
    if mesh is None:
        return s
    local = s.detach()
    return mesh.all_reduce_(local.clone()) + (s - local)


def _env_world() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) from a ``torchrun``-style environment."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def _rank_device(device: torch.device | str | None) -> torch.device:
    """The rank's device: ``device`` as :func:`resolve_device` reads it (the
    GPU when None), on ``cuda:LOCAL_RANK`` under a ``torchrun``-style
    environment when no index is given."""
    device = resolve_device(device)
    env = _env_world()
    if device.type == "cuda" and env is not None and device.index is None:
        device = torch.device("cuda", env[2])
    return device


def _init_from_env(device: torch.device) -> None:
    """Initialise the default process group from a ``torchrun``-style
    environment: NCCL for a CUDA rank, gloo for the CPU."""
    env = _env_world()
    if env is None or dist.is_initialized():
        return
    rank, world, _ = env
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    logger.info("initialising a %s process group: rank %d of %d", backend, rank, world)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)


def _mesh_sizes(spec: dict[str, int], n: int) -> list[int]:
    """The JAX package's spec rules over ``n`` processes: −1 fills, at most
    one −1, ``n`` divisible by the fixed axes, and enough processes."""
    sizes = list(spec.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n % fixed:
            raise ValueError(f"{n} processes not divisible by fixed axes {spec}")
        sizes[sizes.index(-1)] = n // fixed
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {spec} needs {total} processes, have {n}")
    return sizes


def make_mesh(
    mesh_shape: dict[str, int] | None = None,
    world: int | None = None,
    device: torch.device | str | None = None,
) -> Mesh:
    """A mesh from a ``{axis: size}`` spec (−1 = fill; default ``{"data":
    -1}``) over ``world`` processes.

    ``world`` None takes the process group's size: the existing group (a
    caller may make its own, e.g. gloo for ranks sharing one GPU), or one
    initialised here from a ``torchrun``-style environment (NCCL for a CUDA
    ``device``, gloo for ``device="cpu"``), or a world of one. ``device``
    None means the GPU, as everywhere in the port (``cuda:LOCAL_RANK``
    under ``torchrun``); it raises where there is none.
    An explicit ``world`` only lays out the axes, as the JAX package's
    ``make_mesh(spec, devices)`` does for a device list. A mesh must span the
    whole process group: the ranks beyond a smaller mesh would have nothing
    to do, so that raises (JAX leaves the devices beyond it idle).
    """
    spec = dict(mesh_shape or {"data": -1})
    if world is not None:
        sizes = _mesh_sizes(spec, world)
        return Mesh(dict(zip(spec, sizes)), device=None if device is None else torch.device(device))
    device = _rank_device(device)
    _init_from_env(device)
    if not dist.is_initialized():
        sizes = _mesh_sizes(spec, 1)
        return Mesh(dict(zip(spec, sizes)), device=device)
    n = dist.get_world_size()
    sizes = _mesh_sizes(spec, n)
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {spec} uses {int(np.prod(sizes))} of the {n} processes; give it all of them "
            "(e.g. {'data': -1})"
        )
    return Mesh(dict(zip(spec, sizes)), rank=dist.get_rank(), device=device,
                group=dist.group.WORLD, backend=dist.get_backend())


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a batch lies on the mesh: ``dim`` is the array axis split over
    the whole mesh (0 the batch, 1 the depth), None for a replicated batch,
    which every rank holds whole. ``encoder`` (with ``dim`` None): the batch
    is whole on every rank, and the model's frozen per-slice encoder splits
    its slices over the mesh (SAM2 at a batch of one); its losses, metrics,
    gradients and predictions are a replicated batch's."""

    mesh: Mesh
    dim: int | None
    encoder: bool = False

    def local(self, x):
        """This rank's part of ``x`` (an array or tensor): its equal slice of
        ``dim``, or ``x`` itself when replicated or of too few dims. A dict
        does not split here (a family splits its own input form:
        ``BaseModel.split_inputs``): it raises."""
        n = self.mesh.size
        if self.dim is None or n == 1:
            return x
        if isinstance(x, dict):
            raise ValueError(f"a dict with entries {sorted(x)} does not split along axis "
                             f"{self.dim}: the model family splits its own inputs")
        if getattr(x, "ndim", 0) <= self.dim:
            return x
        k = x.shape[self.dim] // n
        index = [slice(None)] * x.ndim
        index[self.dim] = slice(self.mesh.rank * k, (self.mesh.rank + 1) * k)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Sharding that splits axis 0 (batch / slice stack) across the mesh."""
    return Sharding(mesh, 0)


def _map_batch(tree, fn):
    """``fn`` over the arrays of a TomogramBatch-like dataclass, a dict, a
    list or tuple, or an array."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_batch(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_batch(v, fn) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's slice of axis 0 of every array in ``tree``."""
    return _map_batch(tree, batch_sharding(mesh).local)


def replicate(obj: torch.nn.Module | torch.optim.Optimizer, mesh: Mesh):
    """Broadcast rank 0's values into ``obj`` on every rank, in place: a
    module's parameters and buffers, or an optimizer's state. Returns
    ``obj``."""
    if mesh.size == 1:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = [t.data for t in obj.parameters()] + list(obj.buffers())
    else:
        tensors = [v for state in obj.state.values() for v in state.values()
                   if isinstance(v, torch.Tensor)]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            mesh.broadcast_flat_(group)
    return obj
