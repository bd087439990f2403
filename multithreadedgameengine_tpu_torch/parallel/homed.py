"""The position-homed spatial-domain step, on a slab mesh (``parallel.mesh``).

PyTorch counterpart of ``multithreadedgameengine_tpu/parallel/homed.py``.
Where the halo step (``parallel.halo``) keeps each entity at a fixed slot
and routes its whole row to its slab and back every frame, here each slab
OWNS the entities inside its band of spatial grid rows: its chunk is a
dense table of ``n_cap`` rows sorted by global id, with a gid tensor (-1: a
free slot). Every frame

- phase A builds the slab's neighbour table from the rows it holds, fills
  the ``hw`` halo rows from the neighbour slabs and runs the ticks, the pair
  recording and the light rows on them: no entity row moves;
- the replicated passes run once, as under the halo step
  (``halo.replicated_passes``);
- phase B sends only the solver rows whose post-move position lies in an
  adjacent slab's solver band, in a fixed block of ``cap_pb`` rows each
  way; each slab merges its own rows and the arrivals into gid order (the
  chunk is gid-sorted, so two ``searchsorted`` calls place them), bins
  them, runs the substeps on its grid, and the arrivals' results go back;
- the entities whose final position left their band MIGRATE, under a
  per-destination grant that never overfills a chunk, and every chunk
  re-sorts to gid order. Movers that were not granted stay as VIOLATORS:
  out-of-band residents with no neighbour list (no ticks of neighbour
  classes, no pairs, no shadows) that retry next frame; ``home_violators``
  counts them.

Solver bands align to the spatial seams: each band boundary is the solver
row nearest its spatial seam, so the bands differ in length by one row.
Every slab's grid is padded to the longest band, and the lower halo row of
slab d sits at the per-slab row ``len_d + 1`` -- inside the padded window
when the band is short, where K3 computes a displacement for it that is
never read. ``len_d`` and the band starts are host ints, one per slab.

Ported here: ``make_homed_step`` with the band geometry, ``n_cap``,
``m_mig`` and the automatic ``cap_pb`` (homed.py:223-293), ``band_of_y``,
``phase_a``/``phase_a_local`` (homed.py:303-488, over ``parallel.halo``'s
per-slab functions), ``phase_b`` (:492-700, as :func:`slab_phase_b_merge`,
the mesh's block exchanges, :func:`slab_phase_b_finish`), ``migrate`` and
``finish_migration`` (:702-770, as :func:`slab_demand`,
:func:`grant_matrix`, :func:`slab_migration_rows` and
:func:`finish_migration`), ``local_step`` (:778-953), ``place_fn`` and
``unplace_fn`` (:991-1041), and the live control plane
(``_insert_local``, ``_remove_local``, ``ctl``; :1053-1146).

The step is bit-exact with the single-device ``Engine.step``: gid-sorted
chunks bin their cells in entity order, and phase B's merge restores the
global order of the solver rows. K3 reads the grid's border rows (ROADMAP
§3), so ``solver="pallas"`` is held to bit-equality here too, where the
reference's tests check only finiteness for its kernel. Differences of
form are those of ``parallel.halo``: the replicated leaves are shared by
every chunk of a process, each replicated pass runs once a process; screen
events are refused. A tick sees ``ctx.i`` as the local row index, as in the
reference. Like the halo step it runs on any mesh of ``parallel.mesh``'s
contract: each per-slab function takes its slab's index from
``mesh.slabs``; placement, the control plane and ``unplace`` run on every
process with the same arguments, each process applying its own slabs' part.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..behavior import read_field
from ..inputs import InputState
from ..ops.culling import update_entity_visibility
from ..ops.physics import update_derived
from ..ops.physics_grid import pack_solver_rows
from ..ops.spatial import GridGeom, _cell_coord
from ..state import World
from .halo import (
    _ENTITY_COMPONENTS,
    SlabPlan,
    _exchange_table_rows,
    _rank_within_dest,
    apply_solved,
    bin_solver_rows,
    gather_chunks,
    pack_world_rows,
    replicated_leaves,
    replicated_passes,
    route_capacity,
    run_slab_substeps,
    slab_logic,
    slab_move,
    slab_neighbor_logic,
    slab_neighbor_table,
    slab_plan_fields,
    unpack_world_rows,
)
from .mesh import SlabMesh

_I32_MAX = 2**31 - 1


@dataclasses.dataclass
class HomedPlan(SlabPlan):
    """The homed step's plan: ``n`` entities, ``n_cap`` rows a chunk,
    ``m_mig`` migration slots per (source, destination) pair, ``cap_pb``
    rows in each adjacent exchange block of phase B, and the solver bands:
    ``band_start`` and ``band_len`` (host ints, one per slab) and the
    boundaries between them as a device tensor."""

    n: int
    n_cap: int
    m_mig: int
    cap_pb: int
    band_start: Tuple[int, ...]
    band_len: Tuple[int, ...]
    band_bounds: torch.Tensor  # int32 [D - 1]


def solver_bands(n_dev: int, rows_sp: int, cell_sp: float, solver_geom: GridGeom):
    """The solver bands aligned to the spatial seams (homed.py:249-259):
    each boundary on the solver row nearest its seam, kept increasing.
    Returns (starts, lengths), host ints."""
    R_s = solver_geom.rows
    seams = [0]
    for dd in range(1, n_dev):
        raw = int(round(dd * rows_sp * cell_sp / solver_geom.cell_size))
        seams.append(min(max(raw, seams[-1] + 1), R_s - (n_dev - dd)))
    seams.append(R_s)
    if any(b <= a for a, b in zip(seams, seams[1:])):
        raise ValueError(f"solver grid has too few rows ({R_s}) for {n_dev} slabs")
    return tuple(seams[:n_dev]), tuple(b - a for a, b in zip(seams, seams[1:]))


def band_of_y(y: torch.Tensor, plan: SlabPlan) -> torch.Tensor:
    """The slab whose band holds spatial grid row ``y`` (homed.py:296-298)."""
    cfg = plan.cfg
    grow = _cell_coord(y, 1.0 / cfg.spatial.cell_size, cfg.grid_rows)
    return torch.clamp(grow // plan.rows_per_slab_sp, max=plan.n_dev - 1)


def _apply_inputs_by_gid(chunk: World, gid: torch.Tensor, inputs: InputState) -> World:
    """The mouse inputs written to entity 0 on whichever slab holds it
    (homed.py:780-795)."""
    t, m = chunk.transform, chunk.mouse
    is_mouse = gid == 0
    b = inputs.mouse_buttons

    def put(arr, value):
        return torch.where(is_mouse, torch.as_tensor(value, dtype=arr.dtype, device=arr.device),
                           arr)

    return chunk.replace(
        transform=t.replace(x=put(t.x, inputs.mouse_x), y=put(t.y, inputs.mouse_y)),
        mouse=m.replace(button0_down=put(m.button0_down, b[0]),
                        button1_down=put(m.button1_down, b[1]),
                        button2_down=put(m.button2_down, b[2]),
                        is_present=put(m.is_present, inputs.mouse_present)),
    )


def later_rows(gd: torch.Tensor, n: int) -> torch.Tensor:
    """For each of ``n`` entities, the position in ``gd`` (gids in slab
    then row order, -1 free) of the LAST row that holds it, -1 for none.

    A gid can be held by two rows: a live insert (``HomedControl``) leaves
    the inactive row parked on slab 0 in place, as the reference's does.
    The later row wins, as in the reference's numpy assignment: the
    inserted or arrived row, which the stable merge puts after the parked
    one. (A scatter of duplicate indices, such as ``index_copy_``, lets
    whichever CPU thread writes last win.)"""
    pos = torch.arange(gd.numel(), dtype=torch.int64, device=gd.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=gd.device)
    last.scatter_reduce_(0, torch.where(gd >= 0, gd, n), pos, "amax")  # free rows: a spare
    return last[:n]


def _gather_homed(mesh: SlabMesh, homes: Sequence[World], gids: Sequence[torch.Tensor], n: int):
    """``ctx.gather``'s resolver under the homed step (homed.py:400-409):
    the path's field of every slab at frame start, gathered over the mesh
    and read by gid into entity order, a gid held twice from its later row
    (:func:`later_rows`), 0 for an entity held by no slab. The gids do not
    change within the frame: the first path gathers them and finds the
    later rows, every path reuses them."""
    rows: List[torch.Tensor] = []

    def gather(path):
        vals = mesh.all_gather([read_field(c, path) for c in homes]).flatten(0, 1)
        if not rows:
            rows.append(later_rows(mesh.all_gather(list(gids)).flatten(0, 1).to(torch.int64), n))
        last = rows[0]
        return torch.where(last >= 0, vals[torch.clamp(last, min=0)], vals.new_zeros(()))

    return gather


# ---------------------------------------------------------------------------
# phase A on the held rows
# ---------------------------------------------------------------------------

def phase_a(mesh: SlabMesh, chunks: List[World], gids: List[torch.Tensor],
            inputs: InputState, plan: HomedPlan):
    """The neighbour-reading phase A (homed.py:303-452): each slab's table
    from its in-band rows, the tables' halo rows from the neighbour slabs,
    then lists, ticks, pairs and lights slab by slab. Rows out of their band
    (violators) are left out of the table and get no list. Returns (chunks,
    n_binned summed, violators per slab, passes per slab)."""
    gather_fn = _gather_homed(mesh, chunks, gids, plan.n)
    valid, violators = [], []
    for d, c, g in zip(mesh.slabs, chunks, gids):
        lt = c.transform
        fin = torch.isfinite(lt.x) & torch.isfinite(lt.y)
        in_band = band_of_y(lt.y, plan) == d
        valid.append(lt.active & fin & (g >= 0) & in_band)
        violators.append(torch.sum(lt.active & (g >= 0) & fin & ~in_band, dtype=torch.int32))
    bins = [slab_neighbor_table(c, g, ok, plan, d)
            for d, c, g, ok in zip(mesh.slabs, chunks, gids, valid)]
    _exchange_table_rows(mesh, [b.table for b in bins], plan)
    out, passes = [], []
    for d, c, g, ok, b in zip(mesh.slabs, chunks, gids, valid, bins):
        local, p = slab_neighbor_logic(c, g, ok, b, inputs, plan, d, gather_fn)
        out.append(local)
        passes.append(p)
    return out, mesh.psum([b.n_binned for b in bins]), violators, passes


def phase_a_local(mesh: SlabMesh, chunks: List[World], gids: List[torch.Tensor],
                  inputs: InputState, plan: HomedPlan):
    """Phase A without neighbours (homed.py:454-486): the ticks on every
    slab's rows with empty lists, then the violators by the post-tick
    position. Returns (chunks, violators per slab, passes per slab)."""
    gather_fn = _gather_homed(mesh, chunks, gids, plan.n)
    out, violators, passes = [], [], []
    for d, c, g in zip(mesh.slabs, chunks, gids):
        local, p = slab_logic(c, inputs, plan, torch.clamp(g, min=0), gather_fn)
        lt = local.transform
        in_band = band_of_y(lt.y, plan) == d
        violators.append(torch.sum(lt.active & (g >= 0) & torch.isfinite(lt.y) & ~in_band,
                                   dtype=torch.int32))
        out.append(local)
        passes.append(p)
    return out, violators, passes


# ---------------------------------------------------------------------------
# phase B: the held rows and the adjacent slabs' arrivals, merged by gid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlabSolverRows:
    """One slab's phase-B rows before the exchange (homed.py:509-536): the
    packed f32 solver rows (occupancy lane 7), which of them are valid and
    solved here, go up or go down, and the two staged blocks with each
    row's slot in them (-1: not staged)."""

    packed: torch.Tensor
    valid: torch.Tensor
    is_loc: torch.Tensor
    to_up: torch.Tensor
    to_dn: torch.Tensor
    buf_up: torch.Tensor
    slot_up: torch.Tensor
    buf_dn: torch.Tensor
    slot_dn: torch.Tensor


def _stage(packed: torch.Tensor, mask: torch.Tensor, cap: int):
    """The masked rows in row (= gid) order into a ``[cap, 8]`` block;
    rows past it are left out. Returns (block, each row's slot or -1)."""
    rank = torch.cumsum(mask, dim=0, dtype=torch.int64) - 1
    ok = mask & (rank < cap)
    slot = torch.where(ok, rank, cap)
    buf = packed.new_zeros((cap + 1, 8))
    buf.index_copy_(0, slot, packed)  # the rows left out go to a spare row
    return buf[:cap], torch.where(ok, slot, -1)


def slab_solver_stage(local: World, gid: torch.Tensor, plan: HomedPlan, d: int) -> SlabSolverRows:
    """Phase B's send side on slab d (homed.py:509-536): each valid row's
    owner from the band table; the rows of the slab above and below staged
    into their blocks."""
    t = local.transform
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y) & (gid >= 0)
    packed = pack_solver_rows(local, gid=torch.clamp(gid, min=0))
    packed[:, 7] = valid.to(torch.float32)  # occupancy lane
    g = plan.solver_geom
    grow = _cell_coord(t.y, 1.0 / g.cell_size, g.rows)
    dest = torch.sum(grow[:, None] >= plan.band_bounds[None, :], dim=1, dtype=torch.int32)
    is_loc, to_up, to_dn = valid & (dest == d), valid & (dest == d - 1), valid & (dest == d + 1)
    buf_up, slot_up = _stage(packed, to_up, plan.cap_pb)
    buf_dn, slot_dn = _stage(packed, to_dn, plan.cap_pb)
    return SlabSolverRows(packed, valid, is_loc, to_up, to_dn, buf_up, slot_up, buf_dn, slot_dn)


@dataclasses.dataclass
class SlabMerge:
    """Phase B's merged rows on one slab (homed.py:541-578): ``res``
    ``[n_cap + 2 cap_pb, 8]`` in gid order, each held row's and each
    arrival's position in it, and the arrivals' sort."""

    res: torch.Tensor
    is_loc: torch.Tensor
    pos_loc: torch.Tensor
    pos_arr: torch.Tensor
    arr_order: torch.Tensor
    arr_valid_s: torch.Tensor


def slab_phase_b_merge(rows: SlabSolverRows, gid: torch.Tensor, from_above: torch.Tensor,
                       from_below: torch.Tensor, n_cap: int) -> SlabMerge:
    """The held rows and the two arrival blocks merged into gid order
    without a full-size sort (homed.py:541-578): the held valid rows are
    already ascending, the arrivals sort (stably), and two
    ``searchsorted`` (side left) give every row its merged position; gids
    are unique, so nothing ties."""
    arr = torch.cat([from_above, from_below])
    arr_n = arr.shape[0]
    arr_valid = arr[:, 7] > 0
    arr_key = torch.where(arr_valid, arr[:, 6].to(torch.int32), _I32_MAX)
    arr_key_s, arr_order = torch.sort(arr_key, stable=True)
    arr_sorted, arr_valid_s = arr[arr_order], arr_valid[arr_order]
    is_loc = rows.is_loc
    loc_key = torch.where(is_loc, gid, _I32_MAX)
    loc_rank = torch.cumsum(is_loc, dim=0, dtype=torch.int64) - 1
    # the held valid gids, dense (tail 2^31 - 1): what the arrivals search
    loc_compact = torch.full((n_cap + 1,), _I32_MAX, dtype=torch.int32, device=gid.device)
    loc_compact.index_copy_(0, torch.where(is_loc, loc_rank, n_cap), loc_key)
    loc_compact = loc_compact[:n_cap]
    m = n_cap + arr_n
    pos_loc = loc_rank + torch.searchsorted(arr_key_s.contiguous(), loc_key)
    pos_arr = (torch.arange(arr_n, device=gid.device)
               + torch.searchsorted(loc_compact, arr_key_s.contiguous()))
    res = rows.packed.new_zeros((m + 1, 8))
    res.index_copy_(0, torch.where(is_loc, pos_loc, m), rows.packed)
    res.index_copy_(0, torch.where(arr_valid_s, pos_arr, m), arr_sorted)
    return SlabMerge(res[:m], is_loc, pos_loc, pos_arr, arr_order, arr_valid_s)


def slab_phase_b_out(st, flat: torch.Tensor, in_grid: torch.Tensor, mg: SlabMerge,
                     cap_pb: int):
    """The solved grid read back in merged order (homed.py:628-654): x,
    y, px, py, contact count and in-grid flag, f32 ``[m, 6]``; the held
    rows' share in chunk order, and the two return blocks (the arrivals'
    rows un-sorted, zero where no arrival)."""
    n_slots = st.gx.numel()
    out = torch.stack([st.gx, st.gy, st.gpx, st.gpy], dim=-1).reshape(n_slots, 4)
    safe = torch.where(in_grid, flat, 0)
    out_rows = torch.cat([out[safe], st.count.reshape(n_slots)[safe][:, None].to(torch.float32),
                          in_grid.to(torch.float32)[:, None]], dim=1)
    loc_out = out_rows[torch.where(mg.is_loc, mg.pos_loc, 0)]
    arr_out_s = torch.where(mg.arr_valid_s[:, None],
                            out_rows[torch.where(mg.arr_valid_s, mg.pos_arr, 0)], 0.0)
    arr_out = torch.zeros_like(arr_out_s)
    arr_out.index_copy_(0, mg.arr_order, arr_out_s)
    return loc_out, arr_out[:cap_pb], arr_out[cap_pb:]


def slab_phase_b_finish(local: World, rows: SlabSolverRows, loc_out: torch.Tensor,
                        got_up: torch.Tensor, got_dn: torch.Tensor, cfg):
    """Phase B's home side (homed.py:658-700): each row takes its result
    from its own slab or from the slab above or below it was sent to; a
    valid row that none solved (a far jump, a full block, a full cell)
    takes the boundary clamp alone. Returns (local, solved, degraded)."""
    up = got_up[torch.clamp(rows.slot_up, min=0)]
    dn = got_dn[torch.clamp(rows.slot_dn, min=0)]
    ok_loc = rows.is_loc & (loc_out[:, 5] > 0)
    ok_up = rows.to_up & (rows.slot_up >= 0) & (up[:, 5] > 0)
    ok_dn = rows.to_dn & (rows.slot_dn >= 0) & (dn[:, 5] > 0)
    solved = ok_loc | ok_up | ok_dn
    v = torch.where(ok_up[:, None], up, loc_out)
    v = torch.where(ok_dn[:, None], dn, v)
    local = apply_solved(local, rows.valid, solved, v[:, :4], v[:, 4].to(torch.int32), cfg)
    return (local, torch.sum(solved, dtype=torch.int32),
            torch.sum(rows.valid & ~solved, dtype=torch.int32))


def phase_b(mesh: SlabMesh, chunks: List[World], gids: List[torch.Tensor], plan: HomedPlan):
    """The homed solver phase over all slabs (homed.py:492-700). Returns
    (chunks, solved per slab, degraded per slab)."""
    cap_pb = plan.cap_pb
    staged = [slab_solver_stage(c, g, plan, d) for d, c, g in zip(mesh.slabs, chunks, gids)]
    # my up block goes to d-1; I receive d+1's up block (and d-1's down)
    from_above = mesh.shift_up([s.buf_up for s in staged])
    from_below = mesh.shift_down([s.buf_dn for s in staged])
    merged = [slab_phase_b_merge(s, g, a, b, plan.n_cap)
              for s, g, a, b in zip(staged, gids, from_above, from_below)]
    grids = [bin_solver_rows(mg.res, plan, plan.band_start[d])
             for d, mg in zip(mesh.slabs, merged)]
    states = run_slab_substeps(mesh, [g[0] for g in grids], [plan.band_len[d] for d in mesh.slabs],
                               plan.cfg, chunks[0].step_count & 0xFFFFFFFF)
    outs = [slab_phase_b_out(st, flat, in_grid, mg, cap_pb)
            for st, (_g, flat, in_grid), mg in zip(states, grids, merged)]
    # the blocks back to their senders
    back_up = mesh.shift_down([o[1] for o in outs])
    back_dn = mesh.shift_up([o[2] for o in outs])
    done = [slab_phase_b_finish(c, s, o[0], bu, bd, plan.cfg)
            for c, s, o, bu, bd in zip(chunks, staged, outs, back_up, back_dn)]
    return [x[0] for x in done], [x[1] for x in done], [x[2] for x in done]


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def slab_demand(local: World, gid: torch.Tensor, plan: HomedPlan, d: int):
    """Slab d's movers (homed.py:703-720): each held active row's band by
    its final position (a non-finite one stays), the rows that want out,
    their count per destination and the slab's occupied rows. Returns
    (dest, wants_out, demand [D], occupied count)."""
    t = local.transform
    occupied = gid >= 0
    dest = torch.where(occupied & t.active & torch.isfinite(t.y), band_of_y(t.y, plan), d)
    wants_out = occupied & t.active & (dest != d)
    onehot = (dest[:, None] == torch.arange(plan.n_dev, device=gid.device)[None, :]) \
        & wants_out[:, None]
    return dest, wants_out, torch.sum(onehot, dim=0, dtype=torch.int32), \
        torch.sum(occupied, dtype=torch.int32)


def grant_matrix(demand: torch.Tensor, occupied: torch.Tensor, n_cap: int, m_mig: int):
    """How many rows each source may send each destination
    (homed.py:721-729): the demand capped at ``m_mig`` a pair, granted in
    source order against the destination's free rows, which count every
    occupied row as staying (a denied mover stays too). ``demand`` ``[D
    src, D dst]``, ``occupied`` ``[D]``; returns ``[D, D]`` int32."""
    demand = torch.clamp(demand, max=m_mig)
    free = torch.clamp(n_cap - occupied, min=0)
    used_before = torch.cumsum(demand, dim=0, dtype=torch.int32) - demand
    return torch.minimum(torch.clamp(free[None, :] - used_before, min=0), demand)


def slab_migration_rows(local: World, gid: torch.Tensor, dest: torch.Tensor,
                        wants_out: torch.Tensor, my_grant: torch.Tensor, plan: HomedPlan):
    """Slab d's send buffer (homed.py:731-752): its movers ranked per
    destination in gid order, the granted prefix sent, each row packed with
    its gid + 1 in the last lane (so an empty slot decodes to -1). Returns
    (send ``[D, m_mig, L + 1]``, sent mask, ungranted count, packed rows)."""
    n_dev, m_mig = plan.n_dev, plan.m_mig
    rank = _rank_within_dest(dest, wants_out, n_dev)
    send_ok = wants_out & (rank < my_grant[dest.to(torch.int64)])
    rows = torch.cat([pack_world_rows(local, plan.leaf_specs),
                      (gid.to(torch.int64) + 1)[:, None]], dim=1)
    total = n_dev * m_mig
    slot = torch.where(send_ok, dest.to(torch.int64) * m_mig + rank, total)
    send = rows.new_zeros((total + 1, rows.shape[1]))
    send.index_copy_(0, slot, rows)
    return (send[:total].view(n_dev, m_mig, rows.shape[1]), send_ok,
            torch.sum(wants_out & ~send_ok, dtype=torch.int32), rows)


def _sorted_merge(local: World, all_rows: torch.Tensor, all_gid: torch.Tensor,
                  plan: HomedPlan):
    """Rows and gids merged into gid order, cut to ``n_cap``, free rows
    zeroed (homed.py:760-769)."""
    key = torch.where(all_gid >= 0, all_gid.to(torch.int64), _I32_MAX)
    skey, order = torch.sort(key, stable=True)
    skey, order = skey[:plan.n_cap], order[:plan.n_cap]
    new_gid = torch.where(skey < _I32_MAX, all_gid[order], -1).to(torch.int32)
    new_rows = torch.where(new_gid[:, None] >= 0, all_rows[order], 0)
    return unpack_world_rows(new_rows, local, plan.leaf_specs), new_gid


def finish_migration(local: World, gid: torch.Tensor, recv: torch.Tensor,
                     send_ok: torch.Tensor, rows: torch.Tensor, plan: HomedPlan):
    """The stays and the arrivals merged into gid order (homed.py:754-769);
    a departure frees its slot. Returns (local, gid)."""
    n_lanes = len(plan.leaf_specs)
    all_rows = torch.cat([rows[:, :n_lanes], recv[:, :n_lanes]])
    all_gid = torch.cat([torch.where(send_ok, -1, gid.to(torch.int64)), recv[:, n_lanes] - 1])
    return _sorted_merge(local, all_rows, all_gid, plan)


def migrate(mesh: SlabMesh, chunks: List[World], gids: List[torch.Tensor], plan: HomedPlan):
    """Movers-only migration on final positions (homed.py:702-770, :921-924)
    over all slabs. Returns (chunks, gids, sent per slab, ungranted per
    slab)."""
    dem = [slab_demand(c, g, plan, d) for d, c, g in zip(mesh.slabs, chunks, gids)]
    # every process computes the whole grant from the gathered demand
    grant = grant_matrix(mesh.all_gather([x[2] for x in dem]),
                         mesh.all_gather([x[3] for x in dem]), plan.n_cap, plan.m_mig)
    sends = [slab_migration_rows(c, g, x[0], x[1], grant[d], plan)
             for d, c, g, x in zip(mesh.slabs, chunks, gids, dem)]
    recv = mesh.all_to_all([s[0] for s in sends])
    width = sends[0][3].shape[1]
    done = [finish_migration(c, g, r.reshape(-1, width), s[1], s[3], plan)
            for c, g, r, s in zip(chunks, gids, recv, sends)]
    return ([x[0] for x in done], [x[1] for x in done],
            [torch.sum(s[1], dtype=torch.int32) for s in sends], [s[2] for s in sends])


# ---------------------------------------------------------------------------
# building the step
# ---------------------------------------------------------------------------

class HomedControl:
    """The live host control plane of a placed homed world
    (homed.py:1043-1146): spawned rows insert into the chunk of the band
    that holds their position through the migration's gid-sorted merge, and
    a despawn clears its row where it lives; no re-placement."""

    def __init__(self, mesh: SlabMesh, plan: HomedPlan):
        self.mesh, self.plan = mesh, plan
        self._y_lane = next(i for i, (c, f, _dt) in enumerate(plan.leaf_specs)
                            if c == "transform" and f == "y")

    def pack_rows(self, world: World, gids) -> torch.Tensor:
        """``[K, lanes]`` packed rows (int64, the port's row dtype) of
        ``gids`` from an entity-ordered world (e.g. the engine's world after
        ``spawn_batch``), on the mesh's device."""
        idx = torch.as_tensor(np.asarray(gids), dtype=torch.int64, device=world.device)
        return pack_world_rows(world, self.plan.leaf_specs)[idx].to(self.mesh.device)

    def insert(self, chunks: Sequence[World], gids: Sequence[torch.Tensor], new_rows, new_gids):
        """Insert spawned rows into their bands' chunks (``_insert_local``).
        Returns (chunks, gids, denied): ``denied > 0`` means a destination
        chunk was full, and those rows were left out; re-place the world
        (``place_fn(unplace_fn(...))``) then."""
        plan, dev = self.plan, self.mesh.device
        new_rows = torch.as_tensor(new_rows, device=dev).to(torch.int64)
        new_gids = torch.as_tensor(np.asarray(new_gids), device=dev).to(torch.int64)
        y = new_rows[:, self._y_lane].to(torch.int32).view(torch.float32)
        valid = new_gids >= 0
        dest = torch.where(valid & torch.isfinite(y), band_of_y(y, plan), -1)
        out_c, out_g, denied = [], [], []
        for d, c, g in zip(self.mesh.slabs, chunks, gids):
            mine = dest == d
            occ = torch.sum(g >= 0, dtype=torch.int64)
            rank = torch.cumsum(mine, dim=0, dtype=torch.int64) - 1
            ok = mine & (rank < torch.clamp(plan.n_cap - occ, min=0))
            denied.append(torch.sum(mine & ~ok, dtype=torch.int32))
            c, g = _sorted_merge(
                c, torch.cat([pack_world_rows(c, plan.leaf_specs), new_rows]),
                torch.cat([g.to(torch.int64), torch.where(ok, new_gids, -1)]), plan)
            out_c.append(c)
            out_g.append(g)
        return out_c, out_g, self.mesh.psum(denied)

    def remove(self, chunks: Sequence[World], gids: Sequence[torch.Tensor], victim_gids):
        """Host despawn (``_remove_local``): clear the rows of
        ``victim_gids`` wherever they live (the free slots compact at the
        next migration). Returns (chunks, gids, removed count)."""
        plan, dev = self.plan, self.mesh.device
        victims = torch.as_tensor(np.asarray(victim_gids), device=dev).to(torch.int32)
        out_c, out_g, removed = [], [], []
        for c, g in zip(chunks, gids):
            hit = ((g[:, None] == victims[None, :]) & (victims >= 0)[None, :]).any(dim=1)
            rows = torch.where(hit[:, None], 0, pack_world_rows(c, plan.leaf_specs))
            out_c.append(unpack_world_rows(rows, c, plan.leaf_specs))
            out_g.append(torch.where(hit, -1, g))
            removed.append(torch.sum(hit, dtype=torch.int32))
        return out_c, out_g, self.mesh.psum(removed)


def make_homed_step(engine, mesh: SlabMesh, headroom: float = 2.0, mig_oversub: float = 1.0,
                    adjacent_frac: Optional[float] = None):
    """Build the position-homed step for an initialized engine.

    Returns (step_fn, place_fn, unplace_fn, ctl):

    - ``place_fn(world) -> (chunks, gids)``: every entity to the slab of its
      position's band (inactive ones parked on slab 0), each chunk
      gid-sorted in ``n_cap`` rows with the replicated leaves shared;
      ``gids`` one int32 ``[n_cap]`` tensor per slab, -1 for a free row; the
      mesh's local slabs only (every process is handed the whole world);
    - ``step_fn(chunks, gids, inputs) -> (chunks, gids, metrics)``: one
      frame, with the reference's ten metrics as 0-dim int32 tensors;
      ``step_fn.plan`` is the :class:`HomedPlan`;
    - ``unplace_fn(chunks, gids) -> world``: the entity-ordered world (on a
      process mesh every rank calls it; rank 0 returns the world, the others
      None);
    - ``ctl``: :class:`HomedControl` (``pack_rows``, ``insert``,
      ``remove``).

    ``headroom``: rows a chunk = ``ceil(N/D * headroom)`` rounded up to 8.
    ``mig_oversub``: migration slots per (source, destination) pair =
    ``route_capacity(n_cap, D, mig_oversub)``. ``adjacent_frac``: phase B's
    block each way = ``ceil(n_cap * adjacent_frac)`` rows; None derives it
    from the seams: half a solver cell of rounding plus one frame's largest
    per-axis move of the spawned entities, sized for twice the uniform
    density (at least 64 rows). Each frame launches K3 once per slab and
    substep, as the halo step."""
    common = slab_plan_fields(engine, mesh, "homed")
    n_dev = mesh.n_slabs
    n_held = len(mesh.slabs)
    world0 = engine.world
    n = world0.n_entities
    cfg, sp, g = common["cfg"], common["cfg"].spatial, common["solver_geom"]
    rows_sp = common["rows_per_slab_sp"]
    band_start, band_len = solver_bands(n_dev, rows_sp, sp.cell_size, g)
    n_cap = int((math.ceil(n / n_dev * headroom) + 7) // 8 * 8)
    if adjacent_frac is None:
        act = world0.transform.active.cpu().numpy()
        vel = world0.rigid_body.max_vel.cpu().numpy()
        vel_bound = max(float(vel[act].max()) if act.any() else float(vel.max()), 1.0)
        strip = 0.5 * g.cell_size + vel_bound
        frac = min(2.0 * strip / (rows_sp * sp.cell_size), 1.0)
        cap_pb = int(min(max((math.ceil(n_cap * frac) + 7) // 8 * 8, 64), n_cap))
    else:
        cap_pb = int(min(max((math.ceil(n_cap * adjacent_frac) + 7) // 8 * 8, 8), n_cap))
    plan = HomedPlan(
        **common,
        slab_geom=GridGeom(cell_size=g.cell_size, rows=max(band_len), cols=g.cols,
                           capacity=g.capacity),
        n=n,
        n_cap=n_cap,
        m_mig=route_capacity(n_cap, n_dev, mig_oversub),
        cap_pb=cap_pb,
        band_start=band_start,
        band_len=band_len,
        band_bounds=torch.tensor(band_start[1:], dtype=torch.int32, device=mesh.device),
    )
    cfg = plan.cfg

    def full_step(chunks: Sequence[World], gids: Sequence[torch.Tensor], inputs: InputState):
        if len(chunks) != n_held or len(gids) != n_held:
            raise ValueError(f"expected {n_held} chunk worlds and gid tensors")
        gids = list(gids)
        chunks = [_apply_inputs_by_gid(c, gd, inputs) for c, gd in zip(chunks, gids)]
        if plan.need_neighbors:
            chunks, n_binned, violators, passes = phase_a(mesh, chunks, gids, inputs, plan)
        else:
            chunks, violators, passes = phase_a_local(mesh, chunks, gids, inputs, plan)
            n_binned = torch.full((), -1, dtype=torch.int32, device=mesh.device)
        rep, pair_count, pairs_dropped, p_active = replicated_passes(
            mesh, plan, chunks[0], inputs, passes)
        chunks = [slab_move(c, plan) for c in chunks]
        chunks, solved, degraded = phase_b(mesh, chunks, gids, plan)
        chunks = [update_entity_visibility(update_derived(c, cfg), cfg, inputs) for c in chunks]
        chunks, gids, sent, ungranted = migrate(mesh, chunks, gids, plan)
        chunks = [c.replace(step_count=c.step_count + 1, **rep) for c in chunks]
        ts = [(c.transform, gd >= 0) for c, gd in zip(chunks, gids)]
        metrics = {
            "active_count": mesh.psum([torch.sum(t.active & occ, dtype=torch.int32)
                                       for t, occ in ts]),
            "collision_pair_count": pair_count,
            "collision_pairs_dropped": pairs_dropped,
            "n_binned": n_binned,
            "active_particles": p_active,
            "nonfinite_count": mesh.psum([
                torch.sum(t.active & occ & ~(torch.isfinite(t.x) & torch.isfinite(t.y)),
                          dtype=torch.int32) for t, occ in ts]),
            "solver_binned": mesh.psum(solved),
            "route_overflow_solver": mesh.psum(degraded),
            "migrated_rows": mesh.psum(sent),
            "home_violators": mesh.psum([v + u for v, u in zip(violators, ungranted)]),
        }
        return chunks, gids, metrics

    step_fn = full_step
    step_fn.plan = plan
    specs = plan.leaf_specs

    def place_fn(world: World):
        """Every entity to its position's band, gid-sorted chunks, free
        rows at the end (homed.py:991-1030). Raises ``ValueError`` when a
        band holds more than ``n_cap`` entities."""
        t = world.transform
        dest = torch.where(t.active, band_of_y(t.y, plan), 0)
        dest = torch.where(torch.isfinite(t.y), dest, 0).cpu()
        rows = pack_world_rows(world, specs).to(mesh.device)
        rep = replicated_leaves(world, mesh.device)
        chunks, gids = [], []
        for d in mesh.slabs:
            idx = torch.nonzero(dest == d).flatten()
            if idx.numel() > n_cap:
                raise ValueError(f"placement overflow: band {d} holds {idx.numel()} entities "
                                 f"> chunk capacity {n_cap}; raise headroom")
            gid = torch.full((n_cap,), -1, dtype=torch.int32)
            gid[:idx.numel()] = idx.to(torch.int32)
            gid = gid.to(mesh.device)
            r = rows.new_zeros((n_cap, rows.shape[1]))
            r[:idx.numel()] = rows[idx.to(mesh.device)]
            chunk = World(**{name: getattr(world, name) for name in _ENTITY_COMPONENTS},
                          step_count=world.step_count, custom=world.custom)
            chunks.append(unpack_world_rows(r, chunk, specs).replace(**rep))
            gids.append(gid)
        return chunks, gids

    def unplace_fn(chunks: Sequence[World], gids: Sequence[torch.Tensor]) -> World:
        """The entity-ordered world (homed.py:1032-1041), with chunk 0's
        replicated leaves; an entity held by no slab reads as zeros, a gid
        held twice from its later row (:func:`later_rows`). On a process
        mesh the chunks and gids gather to rank 0 first, in slab order."""
        chunks = gather_chunks(mesh, chunks)
        gd = mesh.gather(list(gids))
        if chunks is None:
            return None
        rows = torch.cat([pack_world_rows(c, specs) for c in chunks])
        last = later_rows(gd.flatten(0, 1).to(torch.int64), n)
        out = torch.where((last >= 0)[:, None], rows[torch.clamp(last, min=0)], 0)
        return unpack_world_rows(out, chunks[0], specs)

    return step_fn, place_fn, unplace_fn, HomedControl(mesh, plan)

