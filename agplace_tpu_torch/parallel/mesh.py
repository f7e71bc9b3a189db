"""Meshes of ranks, batch sharding and the two collectives
(``agplace_tpu/parallel/mesh.py``).

A ``Mesh`` is a grid of process-group ranks shaped ``(data, gallery)``
with ``MeshConfig``'s axis names.  When a process group is up, building a
mesh makes one ``torch.distributed`` group per row and per column and one
over the whole grid.  ``new_group`` is collective over the world, members
or not, so every rank builds the same meshes in the same order (the
entry points resolve them from the same flags).

The resolution rules are JAX's, with ranks in place of devices: the
functions take ``devices=`` (a list of ranks, by default every rank of the
group, ``[0]`` with no group), so the rules hold in one process too.

The port needs two collectives, ``all_reduce_sum`` and ``all_gather``,
both differentiable.  ``all_gather`` is an all-reduce of a zero-filled
``[W, ...]`` buffer in which each rank writes its own slot (exact for fp32
and int64: x + 0 = x).  So the port runs on all-reduce and broadcast
alone, which gloo takes on CUDA tensors as well: two ranks can share one
card over gloo, where NCCL refuses them.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from agplace_tpu_torch.config import MeshConfig


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()


class MeshAxis(NamedTuple):
    """This rank's place along one axis of a mesh: the axis's process
    group (None without a process group: a world of one), this rank's
    index along the axis, and the axis's width."""

    group: Any
    index: int
    size: int


class Mesh:
    """``devices``: [data, gallery] ranks; ``axis_names``: the two axes'
    names; ``shape``: {name: width}."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        self.devices = np.asarray(devices, np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        me = np.argwhere(self.devices == rank())
        self.coords = tuple(int(c) for c in me[0]) if len(me) else None
        self._groups = {}
        if dist.is_initialized():
            # every rank calls new_group for every line, in this order
            for ax, lines in ((0, self.devices.T), (1, self.devices)):
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.coords is not None and rank() in line:
                        self._groups[self.axis_names[ax]] = g
            g = dist.new_group([int(r) for r in self.devices.flat])
            if self.coords is not None:
                self._groups[None] = g

    def axis(self, name: Optional[str]) -> Optional[MeshAxis]:
        """This rank's ``MeshAxis`` along ``name`` (None: the whole grid,
        in row-major order), or None when this rank is not in the mesh."""
        if self.coords is None:
            return None
        if name is None:
            return MeshAxis(self._groups.get(None),
                            int(np.ravel_multi_index(self.coords,
                                                     self.devices.shape)),
                            int(self.devices.size))
        ax = self.axis_names.index(name)
        return MeshAxis(self._groups.get(name), self.coords[ax],
                        int(self.devices.shape[ax]))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"


def mesh_axis(mesh: Optional[Mesh], name: str) -> Optional[MeshAxis]:
    """The ``MeshAxis`` of this rank when ``mesh`` splits ``name`` over
    more than one rank and this rank is in it; None means single-device."""
    if mesh is None or mesh.shape.get(name, 1) <= 1:
        return None
    return mesh.axis(name)


def _ranks(devices: Optional[Sequence[int]]) -> list:
    return list(devices if devices is not None else range(world_size()))


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    cfg = cfg or MeshConfig()
    devices = _ranks(devices)
    n = len(devices)
    gp = max(cfg.gallery_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // gp
    if dp * gp > n:
        raise ValueError(f"mesh {dp}x{gp} > {n} ranks")
    return Mesh(np.array(devices[: dp * gp]).reshape(dp, gp),
                (cfg.data_axis, cfg.gallery_axis))


def resolve_data_mesh(cfg: Optional[MeshConfig],
                      batch_sizes: Sequence[int] = (),
                      devices: Optional[Sequence[int]] = None
                      ) -> Optional[Mesh]:
    """Data-parallel mesh for the entry points, or None for single-device.
    ``data_parallel=-1`` means every rank; the width is capped at the rank
    count, then lowered until it divides every batch size."""
    cfg = cfg or MeshConfig()
    devices = _ranks(devices)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else len(devices)
    dp = min(dp, len(devices))
    while dp > 1 and any(b % dp for b in batch_sizes):
        dp -= 1
    if dp <= 1:
        return None
    return make_mesh(
        MeshConfig(data_axis=cfg.data_axis, gallery_axis=cfg.gallery_axis,
                   data_parallel=dp, gallery_parallel=1),
        devices=devices[:dp])


def resolve_gallery_mesh(cfg: Optional[MeshConfig],
                         devices: Optional[Sequence[int]] = None
                         ) -> Optional[Mesh]:
    """Gallery-sharded retrieval mesh (``gallery_parallel=-1``: every
    rank, capped at the rank count), or None for single-device."""
    cfg = cfg or MeshConfig()
    devices = _ranks(devices)
    gp = cfg.gallery_parallel if cfg.gallery_parallel != -1 else len(devices)
    gp = min(gp, len(devices))
    if gp <= 1:
        return None
    return make_mesh(
        MeshConfig(data_axis=cfg.data_axis, gallery_axis=cfg.gallery_axis,
                   data_parallel=1, gallery_parallel=gp),
        devices=devices[:gp])


def resolve_meshes(cfg: MeshConfig, batch_sizes: Sequence[int],
                   log: logging.Logger):
    """(data mesh, gallery mesh) as the train and test entry points resolve
    them, logged; in a world of one rank a flag above 1 is logged as
    resolving to single-device."""
    mesh = resolve_data_mesh(cfg, batch_sizes)
    gallery_mesh = resolve_gallery_mesh(cfg)
    if mesh is not None:
        log.info("data mesh: %s", mesh.shape)
    if gallery_mesh is not None:
        log.info("gallery mesh: %s", gallery_mesh.shape)
    if world_size() == 1 and (cfg.data_parallel > 1
                              or cfg.gallery_parallel not in (0, 1)):
        log.info("one rank (no process group): data_parallel %d / "
                 "gallery_parallel %d resolve to single-device",
                 cfg.data_parallel, cfg.gallery_parallel)
    return mesh, gallery_mesh


def _tree_map(tree, fn: Callable):
    """``fn`` over the arrays of dicts, dataclasses (``BEVGrid``,
    ``SparseVoxels``, ...), lists and tuples; other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(v, fn) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def shard_batch(mesh: Mesh, batch: Any, axis: str = "data",
                keys: Optional[Sequence[str]] = None) -> Any:
    """This rank's contiguous block of the leading axis of every array of
    ``batch`` (of the dict entries ``keys`` only, when given), split over
    ``axis`` in rank order, as JAX's ``P(axis)``.  0-d arrays stay whole,
    and so does the whole batch on a rank outside the mesh."""
    ax = mesh_axis(mesh, axis)
    if ax is None:
        return batch

    def block(x):
        if x.ndim == 0:
            return x
        if x.shape[0] % ax.size:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"over {ax.size} ranks")
        b = x.shape[0] // ax.size
        return x[ax.index * b:(ax.index + 1) * b]

    if keys is None:
        return _tree_map(batch, block)
    return {k: _tree_map(v, block) if k in keys else v
            for k, v in batch.items()}


def batch_sharding(mesh: Mesh, axis: str = "data",
                   keys: Optional[Sequence[str]] = None) -> Callable:
    """Leading-axis sharding for batches (of the entries ``keys``): called
    on a host batch, it returns this rank's part (``shard_batch``)."""
    return functools.partial(shard_batch, mesh, axis=axis, keys=keys)


def replicated(mesh: Mesh) -> Callable:
    """The whole batch on every rank of ``mesh``."""
    return lambda batch: batch


def replicate_tree(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of ``tree`` (a module, a train state or
    anything with ``state_dict``, dicts, lists) in place from the mesh's
    first rank to its other ranks; returns ``tree``."""
    ax = mesh.axis(None)
    if ax is None or ax.group is None:
        return tree
    src = int(mesh.devices.flat[0])
    tensors = []

    def walk(x):
        if hasattr(x, "state_dict") and not isinstance(x, torch.Tensor):
            x = x.state_dict()
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            tensors.append(x)

    walk(tree)
    with torch.no_grad():
        for t in tensors:
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src, group=ax.group)
            if buf is not t:
                t.copy_(buf)
    return tree


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        buf = x.new_zeros((ax.size, *x.shape))
        buf[ax.index] = x
        dist.all_reduce(buf, group=ax.group)
        return buf.flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ax.group)
        return g.view(ax.size, -1, *g.shape[1:])[ax.index], None


def _alone(ax: MeshAxis) -> bool:
    """True for a world of one process (nothing to reduce)."""
    if ax.group is None and ax.size > 1:
        raise RuntimeError(f"a mesh axis of {ax.size} ranks needs a "
                           f"process group (parallel.bootstrap)")
    return ax.group is None


def all_reduce_sum(x: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``ax``; its gradient is the sum
    of the ranks' gradients.  With no process group, ``x``."""
    if _alone(ax):
        return x
    return _AllReduceSum.apply(x, ax.group)


def all_gather(x: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """[W * n, ...]: the ranks' ``x`` [n, ...] of ``ax`` concatenated in
    the axis's order (an all-reduce of a zero-filled [W, n, ...] buffer).
    Its gradient is each rank's slot of the all-reduced gradient.  With no
    process group, ``x``."""
    if _alone(ax):
        return x
    return _AllGather.apply(x, ax)
