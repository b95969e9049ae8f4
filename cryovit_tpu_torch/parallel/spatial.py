"""Depth sharding of single-tomogram batches (port of ``cryovit_tpu/parallel/spatial.py``).

The reference trains with **batch = 1 tomogram**, so data parallelism over
the batch axis cannot use a mesh at the default settings. The answer, as in
the JAX package, is to shard the tomogram's depth axis across the
``"data"`` axis instead: every array of the batch is ``(B, D, ...)`` and
each rank holds ``D / n`` consecutive slices.

In JAX, GSPMD partitions the step and inserts the halo exchanges for the
depth-dilated convolutions. Here they are written out: :func:`halo_exchange`
gives a rank's slab ``d`` slices of each neighbour (zeros at the global
edges, the convolution's zero padding) before a conv of depth dilation
``d``, and its backward sends each halo's gradient back to its owner. A
halo may span several ranks (dilation 32 over 32-slice slabs). The exchange
is one all-reduce of the windows around the inner slab boundaries, each
window filled by the ranks that own it. So every rank's buffer holds
``(n − 1)·2d`` slices whatever its own slab: its memory and traffic grow
with the number of ranks (at 4 ranks and 128 slices block 0's ``d`` = 32
gives 192 slices, more than the whole depth), which point-to-point halos
would avoid (ROADMAP B.2 item 14).

Fallback order in :func:`place_batch`: batch axis if divisible, else depth
axis if divisible (and the model can take it: a family with a depth-sharded
forward, whose slabs are each a multiple of the depth its forward needs),
else replicate with a one-time warning. JAX shards the depth whenever it
divides the mesh, for every model; the port replicates a UNet3D tomogram
whose slabs its stride-2 pools would split (ROADMAP Queue C, deliberate
difference 13), with the same numbers.

SAM2 (whose input the family prepares from the whole batch, so the trainer
places it) keeps that order with its own middle step: batch axis, else its
frozen encoder's slices split over the ranks while every rank holds the
whole batch (:func:`encoder_divides`: the depth the encoder sees,
``min(D, 255)``, divides the mesh; so a 256-slice tomogram, cut to 255,
replicates), else replicate with the warning. A batch of one with cached
pyramids has no encoder to split and is replicated without a warning.
"""

from __future__ import annotations

import logging

import torch

from cryovit_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, Sharding, _map_batch, batch_sharding
from cryovit_tpu_torch.types import TomogramBatch

logger = logging.getLogger(__name__)

__all__ = [
    "batch_divides",
    "encoder_divides",
    "halo_exchange",
    "place_batch",
    "shard_batch_spatial",
    "spatial_batch_sharding",
    "warn_replicated",
]

_warned_replicate = False
_warned_slab = False


def spatial_batch_sharding(mesh: Mesh) -> Sharding:
    """Sharding that splits axis 1 (tomogram depth) across the mesh."""
    return Sharding(mesh, 1)


def shard_batch_spatial(batch, mesh: Mesh):
    """This rank's depth slab of every ``(B, D, ...)`` array of a batch whose
    depth divides the mesh; other leaves (``num_slices``) stay whole."""
    sharding = spatial_batch_sharding(mesh)

    def leaf(x):
        if getattr(x, "ndim", 0) >= 2 and x.shape[1] % mesh.size == 0:
            return sharding.local(x)
        return x

    return _map_batch(batch, leaf)


def _data_is_whole(mesh: Mesh) -> bool:
    """Whether the data axis is the whole mesh: the port has no model
    parallelism, so only then may a batch be split."""
    return mesh.shape.get(DATA_AXIS, 1) == mesh.size


def batch_divides(mesh: Mesh, *arrays) -> bool:
    """Whether a batch may be split along its axis 0 over the mesh: the data
    axis is the whole mesh and its size divides axis 0 of every array
    (None skipped). Always so on a mesh of one."""
    return _data_is_whole(mesh) and all(
        a.shape[0] % mesh.size == 0 for a in arrays if a is not None)


def encoder_divides(mesh: Mesh, depth: int) -> bool:
    """Whether a frozen per-slice encoder may split its slices over the mesh
    (SAM2, at a batch the batch axis does not split): the data axis is the
    whole mesh of more than one rank, and it divides ``depth``, the slices of
    a tomogram the encoder sees."""
    return mesh.size > 1 and _data_is_whole(mesh) and depth % mesh.size == 0


def warn_replicated(batch: TomogramBatch, mesh: Mesh, depth: bool = True,
                    encoder_depth: int | None = None) -> None:
    """The one-time warning that a batch is held whole by every rank;
    ``encoder_depth`` names the depth a splittable encoder sees."""
    global _warned_replicate
    if _warned_replicate:
        return
    _warned_replicate = True
    if encoder_depth is not None:
        note = f" (its encoder sees {encoder_depth} slices of a tomogram)"
    else:
        note = "" if depth else " (this model has no depth-sharded forward)"
    logger.warning(
        "batch (B=%d, D=%d) divides neither the batch nor the depth axis "
        "by the %d-way %r mesh axis%s; replicating (redundant compute). "
        "Pick bucket depths divisible by the mesh size to avoid this.",
        batch.data.shape[0],
        batch.data.shape[1],
        mesh.shape.get(DATA_AXIS, 1),
        DATA_AXIS,
        note,
    )


def _warn_slab(batch: TomogramBatch, mesh: Mesh, multiple: int) -> None:
    """The one-time warning that a depth dividing the mesh is replicated
    because its slabs are not a multiple of ``multiple``."""
    global _warned_slab
    if _warned_slab:
        return
    _warned_slab = True
    n = mesh.shape.get(DATA_AXIS, 1)
    logger.warning(
        "batch (B=%d, D=%d): the depth divides the %d-way %r mesh axis, but a slab of %d "
        "slices is not a multiple of the %d this model's stride-2 depth pools need; "
        "replicating (redundant compute). Pick bucket depths divisible by %d to avoid this.",
        batch.data.shape[0], batch.data.shape[1], n, DATA_AXIS, batch.data.shape[1] // n,
        multiple, n * multiple,
    )


def place_batch(
    batch: TomogramBatch, mesh: Mesh, depth: bool = True, multiple: int = 1
) -> tuple[TomogramBatch, Sharding]:
    """This rank's part of a batch and how it lies: batch axis → depth axis
    → replicate.

    At the reference default of batch = 1 the depth axis is sharded, so an
    ``n``-rank mesh does ``1/n`` of the work per rank instead of ``n×``
    redundant compute. ``depth`` False (a model without a depth-sharded
    forward) skips that branch; ``multiple`` is the depth each rank's slab
    must be a multiple of (``BaseModel.depth_multiple``: UNet3D's
    ``2 ** pools``), so the depth must divide by ``n · multiple``. Both
    split branches need the data axis to be the whole mesh
    (:func:`batch_divides`); otherwise every rank holds the whole batch.
    """
    if batch_divides(mesh, batch.data):
        sharding = batch_sharding(mesh)
        return _map_batch(batch, sharding.local), sharding
    if depth and _data_is_whole(mesh) and batch.data.shape[1] % mesh.size == 0:
        if batch.data.shape[1] % (mesh.size * multiple) == 0:
            return shard_batch_spatial(batch, mesh), spatial_batch_sharding(mesh)
        _warn_slab(batch, mesh, multiple)
        return batch, Sharding(mesh, None)
    warn_replicated(batch, mesh, depth)
    return batch, Sharding(mesh, None)


def _windows(n: int, local: int, d: int) -> list[tuple[int, int, int]]:
    """(boundary, start, stop) of each inner slab boundary's window: the
    global slices within ``d`` of it."""
    total = n * local
    out = []
    for k in range(1, n):
        b = k * local
        out.append((b, max(b - d, 0), min(b + d, total)))
    return out


class _HaloExchange(torch.autograd.Function):
    """``x`` (this rank's slab along ``dim``) with ``d`` slices of the
    neighbouring slabs on each side; zeros beyond the global edges."""

    @staticmethod
    def forward(ctx, x, mesh, dim, d):
        ctx.mesh, ctx.dim, ctx.d = mesh, dim, d
        n, r, local = mesh.size, mesh.rank, x.shape[dim]
        s, e = r * local, (r + 1) * local
        windows = _windows(n, local, d)
        buf = _window_buffer(x, windows, dim)
        for (_, lo, hi), off in zip(windows, _offsets(windows)):
            a, b = max(lo, s), min(hi, e)
            if a < b:
                buf.narrow(dim, off + a - lo, b - a).copy_(x.narrow(dim, a - s, b - a))
        mesh.all_reduce_(buf)
        shape = list(x.shape)
        shape[dim] = local + 2 * d
        out = x.new_zeros(shape)
        out.narrow(dim, d, local).copy_(x)
        for (bnd, lo, hi), off in zip(windows, _offsets(windows)):
            if bnd == s:  # left halo: [s - d, s) ∩ [0, D)
                a = max(s - d, 0)
                out.narrow(dim, d - (s - a), s - a).copy_(buf.narrow(dim, off + a - lo, s - a))
            elif bnd == e:  # right halo: [e, e + d) ∩ [0, D)
                b = min(e + d, hi)
                out.narrow(dim, d + local, b - e).copy_(buf.narrow(dim, off + e - lo, b - e))
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, dim, d = ctx.mesh, ctx.dim, ctx.d
        n, r, local = mesh.size, mesh.rank, g.shape[dim] - 2 * d
        s, e = r * local, (r + 1) * local
        windows = _windows(n, local, d)
        buf = _window_buffer(g, windows, dim)
        for (bnd, lo, hi), off in zip(windows, _offsets(windows)):
            if bnd == s:
                a = max(s - d, 0)
                buf.narrow(dim, off + a - lo, s - a).copy_(g.narrow(dim, d - (s - a), s - a))
            elif bnd == e:
                b = min(e + d, hi)
                buf.narrow(dim, off + e - lo, b - e).copy_(g.narrow(dim, d + local, b - e))
        mesh.all_reduce_(buf)
        dx = g.narrow(dim, d, local).clone()
        for (_, lo, hi), off in zip(windows, _offsets(windows)):
            a, b = max(lo, s), min(hi, e)
            if a < b:
                dx.narrow(dim, a - s, b - a).add_(buf.narrow(dim, off + a - lo, b - a))
        return dx, None, None, None


def _offsets(windows) -> list[int]:
    out, off = [], 0
    for _, lo, hi in windows:
        out.append(off)
        off += hi - lo
    return out


def _window_buffer(x: torch.Tensor, windows, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = sum(hi - lo for _, lo, hi in windows)
    return x.new_zeros(shape)


def halo_exchange(x: torch.Tensor, mesh: Mesh, dim: int, d: int) -> torch.Tensor:
    """This rank's depth slab ``x`` (slabs of equal size along ``dim``, in
    rank order) with ``d`` slices of its neighbours on each side, zeros
    beyond the global edges: the input of a conv of depth dilation ``d``
    with no depth padding. Differentiable: the halos' gradients go back to
    the ranks that own them."""
    return _HaloExchange.apply(x, mesh, dim, d)
