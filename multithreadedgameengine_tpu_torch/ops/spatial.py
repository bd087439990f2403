"""Binning of entities into a uniform grid: cell, rank within the cell.

PyTorch counterpart of ``GridGeom`` and ``bin_entities`` (with its
``row``/``col`` override) in
``multithreadedgameengine_tpu/ops/spatial.py:40-163``. The neighbour lists
built on top of the bins there (slice C of the port) are not ported yet.

Translation: the stable argsort is ``torch.sort(stable=True)``, the
associative max-scan is ``torch.cummax``, the rank inverse is a scatter
through the sort permutation, and the reference's ``mode="drop"`` scatter is
an explicit spare row that is cut off. Results are exactly the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..components import Struct


@dataclass(frozen=True)
class GridGeom:
    """Static geometry of a binning grid (host-side, hashable)."""

    cell_size: float
    rows: int
    cols: int
    capacity: int

    @property
    def num_cells(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass
class BinTable(Struct):
    """Entities binned into grid cells by stable sort and rank.

    ``table[c, k]`` is the id of the k-th entity (ascending id) in cell c,
    -1 when empty; row ``num_cells`` is the all-empty sentinel. Entities
    past ``capacity`` in one cell are left out of the table (``n_binned``
    counts the ones in it)."""

    table: torch.Tensor  # int32[num_cells + 1, capacity]
    cell_id: torch.Tensor  # int32[N] (num_cells for invalid entities)
    rank: torch.Tensor  # int32[N] rank within cell (may exceed capacity)
    row: torch.Tensor  # int32[N] clamped cell row
    col: torch.Tensor  # int32[N] clamped cell col
    n_binned: torch.Tensor  # int32 scalar


def _cell_coord(v: torch.Tensor, inv: float, n: int) -> torch.Tensor:
    """``clip(int32(v * inv), 0, n - 1)`` with the reference's conversion:
    XLA converts NaN to 0 and saturates out-of-range values, while a raw
    float-to-int cast in torch is undefined there. Clamping in float first
    gives the same cells for every input."""
    s = v * inv
    s = torch.where(torch.isnan(s), 0.0, s)
    return torch.clamp(s, 0.0, float(n - 1)).to(torch.int32)


def bin_entities(
    x: torch.Tensor,
    y: torch.Tensor,
    valid: torch.Tensor,
    geom: GridGeom,
    build_table: bool = True,
    row: torch.Tensor = None,
    col: torch.Tensor = None,
) -> BinTable:
    """Clamped truncation cell assignment (spatial_worker.js:157-161), then a
    stable sort by cell, the rank within each cell, and optionally the
    ``[cells + 1, capacity]`` id table. ``build_table=False`` skips the table
    (the grid solver scatters its own layout from cell and rank); ``table``
    is then a ``[1, capacity]`` placeholder.

    ``row``/``col``: precomputed int32 cell coordinates in ``geom``'s grid
    (the halo step's slab grids bin by the GLOBAL truncation, offset to the
    slab, so that ranks match the single-device binning)."""
    n = x.shape[0]
    device = x.device
    cells = geom.num_cells
    if row is None:
        inv = 1.0 / geom.cell_size
        col = _cell_coord(x, inv, geom.cols)
        row = _cell_coord(y, inv, geom.rows)
    cell_id = torch.where(valid, row * geom.cols + col, cells).to(torch.int32)

    sorted_cid, order = torch.sort(cell_id, stable=True)
    arange_n = torch.arange(n, dtype=torch.int64, device=device)
    is_start = torch.ones(n, dtype=torch.bool, device=device)
    is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
    run_start = torch.cummax(torch.where(is_start, arange_n, 0), dim=0).values
    rank_sorted = arange_n - run_start
    # undo the sort: order is a permutation, so the scatter is a bijection
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank.scatter_(0, order, rank_sorted)
    rank = rank.to(torch.int32)

    cap = geom.capacity
    if build_table:
        in_table = (sorted_cid < cells) & (rank_sorted < cap)
        # one spare slot past the table takes every entry left out
        dest = torch.where(
            in_table, sorted_cid.to(torch.int64) * cap + rank_sorted, (cells + 1) * cap
        )
        flat = torch.full(((cells + 1) * cap + 1,), -1, dtype=torch.int32, device=device)
        flat.index_copy_(0, dest, order.to(torch.int32))
        table = flat[: (cells + 1) * cap].reshape(cells + 1, cap)
        n_binned = torch.sum(in_table, dtype=torch.int32)
    else:
        table = torch.full((1, cap), -1, dtype=torch.int32, device=device)
        n_binned = torch.sum(valid, dtype=torch.int32)
    return BinTable(
        table=table, cell_id=cell_id, rank=rank, row=row, col=col,
        n_binned=n_binned,
    )
