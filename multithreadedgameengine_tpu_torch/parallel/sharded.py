"""The entity-sharded step: each process holds N/D rows of every entity
leaf of the world.

PyTorch counterpart of ``multithreadedgameengine_tpu/parallel/sharded.py``.
There, ``world_shardings`` (sharded.py:39-50) shards every leaf with a
leading entity axis over the device mesh and replicates the rest, and
GSPMD partitions the one-device step, inserting the collectives where the
step reads across shards (the spatial table, the candidate gathers).

Torch has no partitioner. DTensor can carry neither the hand-written pair
kernels nor the sort and scatter ops of the step without redistributing
them to replicated anyway. So this step is the honest counterpart of GSPMD
with a replicated spatial table: each call all-gathers the sharded leaves
in rank order, which is entity order (as exact int64 lanes,
``parallel.halo.to_lanes``, the slab steps' row format), runs the
one-device step on the gathered world on the mesh's device, keeps this
rank's own rows and returns the step's metrics, which every rank computes
alike. Every rank computes the whole frame: the step is bit-equal with
``Engine.step`` by construction and measures the API and the gather, not
parallel speed-up. The spatial-domain halo and homed steps
(``parallel.halo``, ``parallel.homed``) are the parallel ones.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..state import World
from .halo import from_lanes, to_lanes


def _rank_of(mesh) -> int:
    if len(mesh.slabs) != 1:
        raise ValueError("the entity-sharded step runs one shard a process: "
                         f"this mesh holds slabs {mesh.slabs}")
    return mesh.slabs[0]


def _tensor_leaves(world: World) -> List[torch.Tensor]:
    """The world's tensor leaves in ``map_tensors`` order (every rank's
    world has the same structure, so the same order)."""
    out: List[torch.Tensor] = []
    world.map_tensors(lambda a: out.append(a) or a)
    return out


def _with_leaves(world: World, leaves: List[torch.Tensor]) -> World:
    it = iter(leaves)
    return world.map_tensors(lambda _a: next(it))


def shard_world(world: World, mesh) -> World:
    """This rank's shard of ``world``: rows ``rank*N/D .. (rank+1)*N/D - 1``
    of every tensor leaf with a leading entity axis ``N``, every other leaf
    whole (replicated), all copied to the mesh's device. Every rank is
    handed the same world. Raises ``ValueError`` when N is not divisible by
    D, or when a replicated leaf has a leading axis of ``N/D`` (the shard
    could not tell it from a sharded one)."""
    rank, d = _rank_of(mesh), mesh.n_slabs
    n = world.n_entities
    if n % d != 0:
        raise ValueError(f"entity count {n} is not divisible by the mesh size {d}")
    n_loc = n // d

    def cut(a: torch.Tensor) -> torch.Tensor:
        if a.ndim >= 1 and a.shape[0] == n:
            return a[rank * n_loc:(rank + 1) * n_loc].to(mesh.device, copy=True)
        if a.ndim >= 1 and a.shape[0] == n_loc:
            raise ValueError(f"a replicated leaf of shape {tuple(a.shape)} has the shard's "
                             f"row count {n_loc}")
        return a.to(mesh.device, copy=True)

    return world.map_tensors(cut)


def make_sharded_step(step_fn, shard: World, mesh):
    """The entity-sharded frame over ``mesh`` (one shard a process) for a
    one-device ``step_fn(world, inputs) -> (world, metrics)``, such as
    ``Engine.raw_step_fn()``. ``shard``: this rank's world from
    :func:`shard_world`, which fixes which leaves are sharded. Returns
    ``call(shard, inputs) -> (shard, metrics)``: the sharded leaves
    all-gathered in rank order, the frame run on the whole world, this
    rank's rows kept; the metrics are the step's own, equal on every rank."""
    rank, d = _rank_of(mesh), mesh.n_slabs
    n_loc = shard.n_entities
    n = n_loc * d
    sharded: Tuple[bool, ...] = tuple(a.ndim >= 1 and a.shape[0] == n_loc
                                      for a in _tensor_leaves(shard))

    def split(leaves: List[torch.Tensor]):
        if len(leaves) != len(sharded):
            raise ValueError(f"the world has {len(leaves)} tensor leaves, the shard it was "
                             f"built from {len(sharded)}")
        return [a for a, s in zip(leaves, sharded) if s]

    def call(world: World, inputs):
        leaves = _tensor_leaves(world)
        parts = split(leaves)
        rows = torch.cat([to_lanes(a) for a in parts], dim=1)
        full_rows = mesh.all_gather([rows]).flatten(0, 1)
        widths = [math.prod(a.shape[1:]) for a in parts]
        full = iter(from_lanes(c, a.dtype, (n, *a.shape[1:]))
                    for c, a in zip(full_rows.split(widths, dim=1), parts))
        whole = _with_leaves(world, [next(full) if s else a for a, s in zip(leaves, sharded)])
        out, metrics = step_fn(whole, inputs)
        out_leaves = _tensor_leaves(out)
        for a in split(out_leaves):
            if a.shape[0] != n:
                raise ValueError(f"the step returned a sharded leaf of shape {tuple(a.shape)}, "
                                 f"not {n} rows")
        own = [a[rank * n_loc:(rank + 1) * n_loc].clone() if s else a
               for a, s in zip(out_leaves, sharded)]
        return _with_leaves(out, own), metrics

    return call
