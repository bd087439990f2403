"""The in-process slab mesh: D world slabs held on one device.

The reference runs its spatial-domain step under ``shard_map`` on a device
mesh, and its tests run that mesh as 8 virtual CPU devices in one process
(tests/conftest.py:8-13). The port's counterpart holds the D slabs on one
device; ``parallel.halo`` runs the step slab by slab between exchange
points, in bulk-synchronous order, and each collective of the reference is
an explicit copy between slab buffers:

- ``jax.lax.all_to_all`` (halo.py:202, :213): :meth:`SlabMesh.all_to_all`,
  a transpose of the ``[D, D, cap, L]`` send blocks;
- ``jax.lax.ppermute`` with ``_edge_perms`` (halo.py:230-233, :789-799):
  :meth:`SlabMesh.shift_down` and :meth:`SlabMesh.shift_up`, a copy of each
  slab's edge row into its neighbour's border row, zeros for a slab that
  receives nothing (the world's top and bottom);
- ``jax.lax.psum``: :meth:`SlabMesh.psum`, a sum over slabs;
- ``jax.lax.all_gather(x, axis)``: :meth:`SlabMesh.all_gather`, the slabs'
  parts stacked in slab order.

It is deterministic, cannot hang, and runs on one card. Its counterpart
with one slab per process, ``parallel.dist.ProcessMesh``, offers the same
methods over ``torch.distributed`` collectives, and the slab steps call the
same per-slab functions on either.

The contract every mesh keeps:

- ``mesh.slabs`` is the tuple of slab indices this process holds, in
  order: ``tuple(range(n_slabs))`` here, ``(rank,)`` on a process mesh.
  The slab steps read a slab's index from it, never from a position in a
  list;
- ``all_to_all``, ``ppermute``, ``shift_down`` and ``shift_up`` take one
  entry per local slab, in the order of ``slabs``, and return one entry per
  local slab;
- ``all_gather`` takes one entry per local slab and returns the full ``[D,
  ...]`` stack in slab order on every process; ``psum`` returns the full
  sum, taken left to right in slab order, on every process;
- ``gather`` takes one entry per local slab and returns the full ``[D,
  ...]`` stack on the process that holds slab 0, None on the others (what
  ``unplace`` reads).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


def _edge_perms(n_slabs: int):
    """The reference's two edge permutations (halo.py:230-233) as (source,
    destination) pairs: toward higher slabs, and toward lower slabs."""
    down = [(i, i + 1) for i in range(n_slabs - 1)]
    up = [(i, i - 1) for i in range(1, n_slabs)]
    return down, up


@dataclass(frozen=True)
class SlabMesh:
    """``n_slabs`` slabs on ``device``, all held by this process: every
    method takes and returns one entry per slab, in slab order."""

    n_slabs: int
    device: torch.device

    @property
    def slabs(self) -> Tuple[int, ...]:
        """The slabs this process holds: all of them."""
        return tuple(range(self.n_slabs))

    def _check(self, parts: Sequence[torch.Tensor]) -> None:
        if len(parts) != self.n_slabs:
            raise ValueError(f"expected one entry per slab ({self.n_slabs}), got {len(parts)}")

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks[s]``: slab s's send buffer ``[D, cap, L]``, block d bound
        for slab d. Returns ``recv[d]`` ``[D, cap, L]`` with ``recv[d][s] ==
        blocks[s][d]``: source-major, as ``all_to_all(x, axis, 0, 0)``."""
        self._check(blocks)
        routed = torch.stack(list(blocks)).transpose(0, 1).contiguous()
        return list(routed.unbind(0))

    def ppermute(self, parts: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``out[dst] = parts[src]`` for each ``(src, dst)`` of ``perm``;
        zeros for a slab that is no pair's destination."""
        self._check(parts)
        out = [torch.zeros_like(p) for p in parts]
        for src, dst in perm:
            out[dst] = parts[src]
        return out

    def shift_down(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each slab's part to the next higher slab (``_edge_perms``' down
        permutation); slab 0 receives zeros."""
        return self.ppermute(parts, _edge_perms(self.n_slabs)[0])

    def shift_up(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each slab's part to the next lower slab (``_edge_perms``' up
        permutation); the last slab receives zeros."""
        return self.ppermute(parts, _edge_perms(self.n_slabs)[1])

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The slabs' parts stacked in slab order, ``[D, ...]``: what every
        slab of the reference receives from ``all_gather(x, axis)``, so
        ``.reshape(-1, ...)`` reads as it does there."""
        self._check(parts)
        return torch.stack(list(parts))

    def psum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over slabs, in the values' own dtype, left to right."""
        self._check(values)
        return sum_in_order(values)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The slabs' parts stacked in slab order: this process holds slab 0."""
        return self.all_gather(parts)


def sum_in_order(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """``values[0] + values[1] + ...``, left to right: the order every mesh's
    ``psum`` takes, so float sums agree bit for bit between meshes."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


def make_mesh(n_slabs: int, device="cuda") -> SlabMesh:
    """The slab mesh of ``n_slabs`` slabs on ``device``: the card unless the
    caller asks for ``"cpu"``, as every entry point of the port."""
    if n_slabs < 1:
        raise ValueError(f"a mesh needs at least one slab, got {n_slabs}")
    return SlabMesh(n_slabs=int(n_slabs), device=torch.device(device))
