"""Spatial hash grid: binning, then fixed-degree neighbour lists.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/spatial.py``:
``GridGeom`` and ``bin_entities`` (with its ``row``/``col`` override and its
f32 ``table_values`` rows), ``NeighborPayload``, ``NeighborLists``,
``cell_coords``, ``_cap_first_k`` and the three list functions
(``neighbor_lists_grid`` in both assembly forms, ``neighbor_lists_by_class``
and the O(N^2) ``neighbor_lists_bruteforce``) behind ``neighbor_lists``.
The reference writes these in XLA, not Pallas, so here they are plain torch
ops, except that both grid functions hand each list's assembly and
acceptance to ``ops.cuda_kernels.neighbor_build``: on the card one
hand-written kernel that reads the binned table in place, on the CPU its
plain version, the cell-major form.

Translation: the stable argsort is ``torch.sort(stable=True)``, the
associative max-scan is ``torch.cummax``, the rank inverse is a scatter
through the sort permutation, and the reference's ``mode="drop"`` scatter is
an explicit spare row that is cut off. Results are exactly the reference's
ids, counts and slot order; ``d2`` differs only where XLA:CPU contracts
``dx*dx + dy*dy`` into a fused multiply-add.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..components import Struct
from ..config import EngineConfig
from ..profiling import span


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
    order: torch.Tensor  # int64[N]: the entities in cell order (the stable sort)


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
    table_values: torch.Tensor = None,
) -> BinTable:
    """Clamped truncation cell assignment (spatial_worker.js:157-161), then a
    stable sort by cell, the rank within each cell, and optionally the
    ``[cells + 1, capacity]`` id table. ``build_table=False`` skips the table
    (the grid solver scatters its own layout from cell and rank); ``table``
    is then a ``[1, capacity]`` placeholder.

    ``row``/``col``: precomputed int32 cell coordinates in ``geom``'s grid
    (the halo step's slab grids bin by the GLOBAL truncation, offset to the
    slab, so that ranks match the single-device binning).

    ``table_values``: f32 ``[N, F]`` rows to place instead of the ids: the
    table is then f32 ``[cells + 1, capacity, F]``, channel 0 acting as the
    id (-1 in empty slots), and ``n_binned`` counts the slots whose channel
    0 is >= 0 (spatial.py:128-137)."""
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
        if table_values is not None:
            f = table_values.shape[1]
            flat = torch.zeros(((cells + 1) * cap + 1, f), dtype=torch.float32, device=device)
            flat[:, 0] = -1.0  # empty: id channel -1
            flat.index_copy_(0, dest, table_values[order].to(torch.float32))
            table = flat[: (cells + 1) * cap].view(cells + 1, cap, f)
            n_binned = torch.sum(table[..., 0] >= 0, dtype=torch.int32)
        else:
            flat = torch.full(((cells + 1) * cap + 1,), -1, dtype=torch.int32, device=device)
            flat.index_copy_(0, dest, order.to(torch.int32))
            table = flat[: (cells + 1) * cap].reshape(cells + 1, cap)
            n_binned = torch.sum(in_table, dtype=torch.int32)
    else:
        table = torch.full((1, cap), -1, dtype=torch.int32, device=device)
        n_binned = torch.sum(valid, dtype=torch.int32)
    return BinTable(
        table=table, cell_id=cell_id, rank=rank, row=row, col=col,
        n_binned=n_binned, order=order,
    )


@dataclasses.dataclass
class NeighborPayload(Struct):
    """Per-candidate field channels gathered with the table rows
    (spatial.py:166-178): ``data`` f32 ``[N, S, F]``, channels id, x, y, then
    the ticking classes' declared ``neighbor_fields`` (engine's payload
    plan). A tick reads a declared field per neighbour as a slice of it
    instead of a gather."""

    data: torch.Tensor  # f32[N, S, F]


@dataclasses.dataclass
class NeighborLists(Struct):
    """Fixed-degree neighbour lists (spatial.py:181-201): slots in
    candidate-scan order with gaps, -1 in an empty slot, not the
    reference's compacted prefix; every consumer masks on ``ids >= 0``.
    ``count`` is the reference's neighbourCount (capped at max_neighbors),
    and the cap keeps its scan-order truncation (spatial_worker.js:258-270)."""

    ids: torch.Tensor  # int32[N, S], -1 = empty slot
    d2: torch.Tensor  # f32[N, S], squared distances (0 in empty slots)
    count: torch.Tensor  # int32[N]
    # how many active entities made it into the grid table (n_active -
    # n_binned = cell-capacity drops); -1 when no lists were built
    n_binned: torch.Tensor  # int32 scalar
    payload: NeighborPayload


def empty_neighbor_lists(n: int, device) -> NeighborLists:
    """The lists of a frame that builds none (no tick reads neighbours):
    one empty slot a row, ``n_binned`` -1 (engine.py:1506-1518)."""
    return NeighborLists(
        ids=torch.full((n, 1), -1, dtype=torch.int32, device=device),
        d2=torch.zeros((n, 1), dtype=torch.float32, device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        n_binned=torch.full((), -1, dtype=torch.int32, device=device),
        payload=NeighborPayload(data=torch.zeros((n, 1, 0), dtype=torch.float32, device=device)),
    )


def cell_coords(x: torch.Tensor, y: torch.Tensor, cfg: EngineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamped integer cell coordinates (spatial_worker.js:157-161)."""
    inv = 1.0 / cfg.spatial.cell_size
    return _cell_coord(y, inv, cfg.grid_rows), _cell_coord(x, inv, cfg.grid_cols)


def _cap_first_k(cand: torch.Tensor, d2: torch.Tensor, valid: torch.Tensor, k: int):
    """The max_neighbors cap in candidate-scan order without compaction:
    every valid candidate past the k-th is masked out (spatial.py:214-226).
    ``cand``/``d2``/``valid``: ``[N, M]``. Returns the slot-form ids, d2 and
    the per-row counts, int32."""
    rank = torch.cumsum(valid, dim=1, dtype=torch.int32)  # 1-based rank
    keep = valid & (rank <= k)
    ids = torch.where(keep, cand, -1)
    d2_out = torch.where(keep, d2, 0.0)
    count = torch.clamp(torch.sum(valid, dim=1, dtype=torch.int32), max=k)
    return ids, d2_out, count


#: the most bytes the cell-major assembled table may take before the grid
#: function falls back to the per-entity gather (spatial.py:275-276)
CELLMAJOR_BUDGET_BYTES = 256 * 1024 * 1024


def _payload_rows(ids_f: torch.Tensor, x, y, extra_fields) -> torch.Tensor:
    return torch.stack([ids_f, x, y] + [f.to(torch.float32) for f in extra_fields], dim=1)


def _grid_bins(x, y, active, cfg: EngineConfig, extra_fields):
    """Binning shared by the grid functions: the NaN-guarded valid mask, the
    f32 ``[id, x, y, *extra]`` rows and their table."""
    n = x.shape[0]
    if n >= (1 << 24):
        raise ValueError("neighbor table packs ids into f32: N must be < 2^24")
    sp = cfg.spatial
    geom = GridGeom(cell_size=sp.cell_size, rows=cfg.grid_rows, cols=cfg.grid_cols,
                    capacity=sp.cell_capacity)
    valid_entity = active & torch.isfinite(x) & torch.isfinite(y)  # spatial_worker.js:152-153
    arange_n = torch.arange(n, dtype=torch.int32, device=x.device)
    rows_vals = _payload_rows(arange_n.to(torch.float32), x, y, extra_fields)
    bins = bin_entities(x, y, valid_entity, geom, table_values=rows_vals)
    return bins, valid_entity, arange_n


def cellmajor_table(table: torch.Tensor, rows_n: int, cols: int, r: int) -> torch.Tensor:
    """Every cell's whole ``(2r+1)^2`` neighbourhood, row-major, from the
    padded table by static shifts (spatial.py:277-292): ``[cells + 1,
    (2r+1)^2 * cap, F]`` with the all-empty sentinel row last."""
    cells = rows_n * cols
    cap, f_ch = table.shape[1], table.shape[2]
    tbl = table[:cells].view(rows_n, cols, cap, f_ch)
    padded = torch.zeros((rows_n + 2 * r, cols + 2 * r, cap, f_ch), dtype=torch.float32,
                         device=table.device)
    padded[..., 0] = -1.0  # out-of-world cells: empty
    padded[r:r + rows_n, r:r + cols] = tbl
    b_cells = (2 * r + 1) ** 2
    nbh = torch.cat([
        padded[r + dr:r + dr + rows_n, r + dc:r + dc + cols]
        for dr in range(-r, r + 1) for dc in range(-r, r + 1)
    ], dim=2).view(cells, b_cells * cap, f_ch)
    sentinel = torch.zeros((1, b_cells * cap, f_ch), dtype=torch.float32, device=table.device)
    sentinel[..., 0] = -1.0
    return torch.cat([nbh, sentinel])


def gathered_candidates(table: torch.Tensor, row: torch.Tensor, col: torch.Tensor, rows_n: int,
                        cols: int, r: int) -> torch.Tensor:
    """The per-entity assembly (spatial.py:294-306): each entity's ``(2r+1)^2``
    cells around its clamped ``row``/``col``, row-major, gathered from the
    padded table, out-of-world cells as the sentinel row: ``[N, (2r+1)^2 *
    cap, F]``."""
    offs = torch.arange(-r, r + 1, dtype=torch.int32, device=table.device)
    off_r = offs.repeat_interleave(2 * r + 1)  # row-major: row outer
    off_c = offs.repeat(2 * r + 1)
    cand_row = row[:, None] + off_r[None, :]
    cand_col = col[:, None] + off_c[None, :]
    in_bounds = (cand_row >= 0) & (cand_row < rows_n) & (cand_col >= 0) & (cand_col < cols)
    cand_cell = torch.where(in_bounds, cand_row * cols + cand_col, rows_n * cols)
    return table[cand_cell.to(torch.int64)].view(row.shape[0], -1, table.shape[2])


def accept_candidates(flat, x, y, self_ids, visual_range, valid_entity, k: int,
                      n_binned: torch.Tensor) -> NeighborLists:
    """The exact acceptance test ``0 < d^2 < visual_range^2`` over assembled
    candidate rows ``flat`` ``[M, S, F]`` (spatial_worker.js:257), then the
    cap. ``self_ids``: each row's own id, never its own neighbour."""
    cand = flat[..., 0].to(torch.int32)
    dx = flat[..., 1] - x[:, None]
    dy = flat[..., 2] - y[:, None]
    d2 = dx * dx + dy * dy
    vr2 = (visual_range * visual_range)[:, None]
    ok = ((cand >= 0) & (cand != self_ids[:, None]) & (d2 < vr2) & (d2 > 0)
          & valid_entity[:, None])
    ids, d2_out, count = _cap_first_k(cand, d2, ok, k)
    return NeighborLists(ids=ids, d2=d2_out, count=count, n_binned=n_binned,
                         payload=NeighborPayload(data=flat))


def _lists(built, n_binned: torch.Tensor) -> NeighborLists:
    """``neighbor_build``'s (ids, d2, count, payload) as lists."""
    ids, d2, count, payload = built
    return NeighborLists(ids=ids, d2=d2, count=count, n_binned=n_binned,
                         payload=NeighborPayload(data=payload))


def neighbor_lists_grid(x, y, active, visual_range, cfg: EngineConfig,
                        extra_fields=()) -> NeighborLists:
    """Hash-grid neighbour search (spatial.py:229-327). ``extra_fields``:
    ``[N]`` tensors whose per-candidate values ride the table rows as
    channels 3.. (:class:`NeighborPayload`).

    One call of ``neighbor_build`` over every row, in the binning's cell
    order: on the card its kernel, on the CPU its plain version, the
    cell-major form (:func:`cellmajor_table`, then one row per entity). On
    the CPU the reference's rule still applies: when the cell-major table
    would pass :data:`CELLMAJOR_BUDGET_BYTES`, the per-entity gather of the
    ``(2R+1)^2`` candidate cells (:func:`gathered_candidates`) takes its
    place. Both give the same ids, d2 and counts; the payload rows of
    entities that are not valid are the empty sentinel's in the cell-major
    form and on the card, the cells around their clamped coordinates in the
    gather form."""
    from .cuda_kernels import neighbor_build

    sp = cfg.spatial
    cells, cols, rows_n = cfg.total_cells, cfg.grid_cols, cfg.grid_rows
    radius = max(1, sp.max_cell_radius)
    bins, valid_entity, arange_n = _grid_bins(x, y, active, cfg, extra_fields)
    cap, f_ch = sp.cell_capacity, bins.table.shape[2]
    b_cells = (2 * radius + 1) ** 2
    if x.device.type == "cpu" and (cells + 1) * b_cells * cap * f_ch * 4 > CELLMAJOR_BUDGET_BYTES:
        flat = gathered_candidates(bins.table, bins.row, bins.col, rows_n, cols, radius)
        return accept_candidates(flat, x, y, arange_n, visual_range, valid_entity,
                                 sp.max_neighbors, bins.n_binned)
    xc, yc, vc = x.contiguous(), y.contiguous(), visual_range.contiguous()
    return _lists(neighbor_build(bins.table, bins.cell_id, bins.order, xc, yc, vc, 0, rows_n,
                                 cols, radius, sp.max_neighbors), bins.n_binned)


def neighbor_lists_by_class(x, y, active, visual_range, cfg: EngineConfig, extra_fields,
                            ranges) -> Tuple[Dict[str, NeighborLists], torch.Tensor]:
    """Per-class candidate assembly at per-class scan radii
    (spatial.py:330-423). ``ranges``: ``(name, start, count, radius)`` of
    each class's contiguous slot range. Bins once, then each class is one
    call of ``neighbor_build`` over its rows, in the order of one stable
    sort of their cells (on the CPU its plain version, the cell-major form);
    acceptance, slot order and truncation per row are
    :func:`neighbor_lists_grid`'s. Returns ({name: lists of the class's
    rows}, n_binned)."""
    from .cuda_kernels import neighbor_build

    bins, _valid, _ids = _grid_bins(x, y, active, cfg, extra_fields)
    rows_n, cols, k = cfg.grid_rows, cfg.grid_cols, cfg.spatial.max_neighbors
    xc, yc, vc = x.contiguous(), y.contiguous(), visual_range.contiguous()
    out = {}
    for name, start, count, r in ranges:
        with span(f"spatial.{name}"):
            order = torch.sort(bins.cell_id[start:start + count], stable=True).indices
            out[name] = _lists(neighbor_build(bins.table, bins.cell_id, order, xc, yc, vc, start,
                                              rows_n, cols, r, k), bins.n_binned)
    return out, bins.n_binned


def neighbor_lists_bruteforce(x, y, active, visual_range, cfg: EngineConfig,
                              extra_fields=()) -> NeighborLists:
    """The O(N^2) oracle with the same acceptance (spatial.py:426-466);
    candidates in ascending id order, so the sets agree with the grid's
    whenever max_neighbors is not exceeded."""
    n = x.shape[0]
    valid_entity = active & torch.isfinite(x) & torch.isfinite(y)
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    d2 = dx * dx + dy * dy
    arange_n = torch.arange(n, dtype=torch.int32, device=x.device)
    vr2 = (visual_range * visual_range)[:, None]
    valid = (valid_entity[:, None] & valid_entity[None, :]
             & (arange_n[:, None] != arange_n[None, :]) & (d2 < vr2) & (d2 > 0))
    cand = arange_n[None, :].expand(n, n)
    ids, d2_out, count = _cap_first_k(cand, d2, valid, cfg.spatial.max_neighbors)
    # every entity is a candidate of every other: payload rows in id order,
    # inactive ids -1 as the grid table's empty slots
    rows_vals = _payload_rows(torch.where(valid_entity, arange_n, -1).to(torch.float32),
                              x, y, extra_fields)
    return NeighborLists(
        ids=ids, d2=d2_out, count=count,
        n_binned=torch.sum(valid_entity, dtype=torch.int32),
        payload=NeighborPayload(data=rows_vals[None].expand(n, n, rows_vals.shape[1])),
    )


def neighbor_lists(x, y, active, visual_range, cfg: EngineConfig,
                   extra_fields=()) -> NeighborLists:
    if cfg.spatial.method == "bruteforce":
        return neighbor_lists_bruteforce(x, y, active, visual_range, cfg, extra_fields)
    return neighbor_lists_grid(x, y, active, visual_range, cfg, extra_fields)
