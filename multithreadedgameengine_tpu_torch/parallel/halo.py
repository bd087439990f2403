"""The spatial-domain halo step, on the in-process slab mesh.

PyTorch counterpart of ``multithreadedgameengine_tpu/parallel/halo.py``: the
world is cut into D horizontal slabs; every frame

- phase A: when a ticking class reads neighbours, each active entity's
  whole row travels to the slab that owns its spatial grid row; the slab
  bins its residents into a neighbour table of its rows plus ``hw`` halo
  rows from each neighbour slab (``hw`` = the cell-scan radius), builds its
  residents' neighbour lists, runs the ticks, and the rows travel home.
  Otherwise the ticks run at home with empty lists (``phase_a_local``);
- each entity's solver row travels to the slab that owns its post-move
  position, each slab bins its residents into its own bordered grid, the
  border rows are filled from the neighbour slabs, and the substeps run
  with the border positions refreshed at the start of each; the results
  travel home. BASELINE config 5's rung, with K3 (``pair_pass_grid``) as
  the solver of ``solver="pallas"`` (what "auto" resolves to).

Ported here: ``entity_leaf_specs`` (built-ins, then the sorted user
components), ``pack_world_rows``/``unpack_world_rows`` (exact transport:
float32 lanes travel as their int32 bits, every lane is int64, so the
port's int64 colours never wrap), ``_rank_within_dest``,
``route_out``/``route_back`` (split into the per-slab ``route_send`` and
``route_take`` around the mesh's all_to_all), ``route_capacity``, and
``make_halo_step`` with ``phase_a``, ``phase_a_local``, ``phase_b`` and
``local_step`` (halo.py:108-233, 559-1003) as per-slab functions;
``_edge_perms`` lives in ``parallel/mesh.py``, behind the mesh's
``shift_down``/``shift_up``. The step is bit-exact with the single-device
``Engine.step``: binning uses the global cell truncation offset to the
slab, and residents arrive source-major in ascending index order, so every
cell ranks its entities in global-id order, and the candidate scan reads
the same cells in the same order.

One deliberate difference from the reference: its K3 never reads the grid's
border rows (pallas_kernels.py:814-825), so under its halo step
``solver="pallas"`` misses every contact across a slab seam. The port's K3
reads them, as the reference's XLA formulation does (ROADMAP §3).

Under phase A a tick's ``ctx.world`` holds the slab's routed rows, as in
the reference, and ``ctx.gather`` resolves a path against the home chunks'
frame-start fields in global-id order (halo.py:664-672).

Not ported yet under this step, and refused: collision and screen events
(per-slab pair recording, with the mixed passes of ROADMAP slice C, item
14), particles, decals and lighting (the mixed passes of item 14);
``Engine.step`` runs them all on one device. The chunk's input
timeline is a list of ``InputState``. ``check_vma`` is an XLA-only knob
and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..behavior import read_field, run_logic_phase_masked
from ..components import BUILTIN_COMPONENTS
from ..config import EngineConfig
from ..engine import _check_supported, _refuse, apply_inputs
from ..inputs import InputState
from ..ops.culling import update_entity_visibility
from ..ops.physics import update_derived, verlet_move
from ..ops.physics_grid import (
    _overflow_fallback,
    grid_solver_state,
    pack_solver_rows,
    scatter_solver_grid,
    solver_substep,
)
from ..ops.spatial import (
    GridGeom,
    NeighborLists,
    _cell_coord,
    accept_candidates,
    bin_entities,
    empty_neighbor_lists,
)
from ..render.extract import advance_animation
from ..state import World
from .mesh import SlabMesh

_ENTITY_COMPONENTS = tuple(BUILTIN_COMPONENTS)


# ---------------------------------------------------------------------------
# packed-row transport: every per-entity field as one int64 lane
# ---------------------------------------------------------------------------

def entity_leaf_specs(world: World) -> List[Tuple[str, str, Any]]:
    """Deterministic [(component, field, dtype)] over every per-entity
    leaf: the built-ins, then the user components sorted by name, as
    ``"custom:<name>"`` (halo.py:108-121)."""
    specs = [
        (name, f.name, getattr(getattr(world, name), f.name).dtype)
        for name in _ENTITY_COMPONENTS
        for f in dataclasses.fields(getattr(world, name))
    ]
    for cname in sorted(world.custom):
        comp = world.custom[cname]
        specs += [(f"custom:{cname}", f.name, getattr(comp, f.name).dtype)
                  for f in dataclasses.fields(comp)]
    return specs


def _get_comp(world: World, cname: str):
    if cname.startswith("custom:"):
        return world.custom[cname[7:]]
    return getattr(world, cname)


def pack_world_rows(world: World, specs) -> torch.Tensor:
    """[n, L] int64 rows, one lane per field: float32 as its int32 bit
    pattern, bool and integers widened (an int64 tint as it is)."""
    cols = []
    for cname, fname, dt in specs:
        arr = getattr(_get_comp(world, cname), fname)
        if dt == torch.float32:
            arr = arr.view(torch.int32)
        cols.append(arr.to(torch.int64))
    return torch.stack(cols, dim=1)


def unpack_world_rows(rows: torch.Tensor, world: World, specs) -> World:
    """A world whose per-entity leaves are the unpacked rows (the exact
    inverse of :func:`pack_world_rows`); ``step_count`` from ``world``."""
    fields = {}
    for k, (cname, fname, dt) in enumerate(specs):
        col = rows[:, k]
        if dt == torch.float32:
            arr = col.to(torch.int32).view(torch.float32)
        elif dt == torch.bool:
            arr = col != 0
        else:
            arr = col.to(dt)
        fields.setdefault(cname, {})[fname] = arr
    built, custom = {}, dict(world.custom)
    for cname, fs in fields.items():
        comp = _get_comp(world, cname).replace(**fs)
        if cname.startswith("custom:"):
            custom[cname[7:]] = comp
        else:
            built[cname] = comp
    return world.replace(custom=custom, **built)


# ---------------------------------------------------------------------------
# routing: per-slab halves around the mesh's all_to_all
# ---------------------------------------------------------------------------

def _rank_within_dest(dest: torch.Tensor, valid: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Rank of each row among the valid rows of its destination, in row
    order: a stable sort and a run scan (as ``bin_entities``), which keeps
    ascending-index order within a destination and so the within-cell ranks
    of the single-device binning. int64."""
    n = dest.shape[0]
    key = torch.where(valid, dest, n_dest).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    ar = torch.arange(n, dtype=torch.int64, device=dest.device)
    is_start = torch.ones(n, dtype=torch.bool, device=dest.device)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.int64, device=dest.device)
    rank.scatter_(0, order, ar - run_start)
    return rank


def route_send(rows: torch.Tensor, dest: torch.Tensor, valid: torch.Tensor,
               n_dev: int, cap: int):
    """One slab's half of ``route_out``: row i goes to block ``dest[i]`` of
    the send buffer, at its rank among that destination's rows; rows past
    ``cap`` stay home. Returns (send ``[n_dev, cap, L]`` with empty slots
    zero, sent_slot ``[n]`` -- the row's flat send slot or -1, the int32
    overflow count)."""
    rank = _rank_within_dest(dest, valid, n_dev)
    ok = valid & (rank < cap)
    total = n_dev * cap
    slot = torch.where(ok, dest.to(torch.int64) * cap + rank, total)
    send = torch.zeros((total + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    send.index_copy_(0, slot, rows)  # one spare row takes every row left home
    overflow = torch.sum(valid & ~ok, dtype=torch.int32)
    return send[:total].view(n_dev, cap, rows.shape[1]), torch.where(ok, slot, -1), overflow


def route_take(back: torch.Tensor, sent_slot: torch.Tensor):
    """One slab's half of ``route_back``: each sent row's processed row from
    the returned ``[n_dev * cap, L]`` buffer. Returns (rows, sent mask)."""
    return back[torch.clamp(sent_slot, min=0)], sent_slot >= 0


def route_out(mesh: SlabMesh, rows, dest, valid, cap: int):
    """Send row i of slab s to slab ``dest[s][i]``; lists over slabs.
    Returns (recv ``[D*cap, L]`` per slab -- source-major blocks, empty slots
    zero; sent_slot per slab; overflow per slab)."""
    n = mesh.n_slabs
    sends = [route_send(r, de, v, n, cap) for r, de, v in zip(rows, dest, valid)]
    recv = mesh.all_to_all([s[0] for s in sends])
    width = rows[0].shape[1]
    return ([r.reshape(n * cap, width) for r in recv],
            [s[1] for s in sends], [s[2] for s in sends])


def route_back(mesh: SlabMesh, out_rows, sent_slot, cap: int):
    """The reverse of :func:`route_out`: every processed resident row
    returns to its source slab and send slot. Returns (rows, sent mask) per
    slab."""
    n = mesh.n_slabs
    width = out_rows[0].shape[1]
    back = mesh.all_to_all([o.reshape(n, cap, width) for o in out_rows])
    return [route_take(b.reshape(n * cap, width), s) for b, s in zip(back, sent_slot)]


def route_capacity(n_loc: int, n_dev: int, oversub: float) -> int:
    """Row slots per (source, destination) pair: ``ceil(n_loc * oversub /
    n_dev)`` rounded up to 8, clamped to [8, n_loc]."""
    cap = math.ceil(n_loc * oversub / n_dev)
    return int(min(max(((cap + 7) // 8) * 8, 8), n_loc))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def place_world(world: World, mesh: SlabMesh) -> List[World]:
    """The world as D chunk worlds of ``N/D`` consecutive entities on the
    mesh's device (chunk s holds entities ``s*N/D .. (s+1)*N/D - 1``).
    Solver caches are left behind: the halo step bins every frame."""
    n = world.n_entities
    if n % mesh.n_slabs != 0:
        raise ValueError(f"entity count {n} is not divisible by the mesh size {mesh.n_slabs}")
    n_loc = n // mesh.n_slabs
    base = World(**{name: getattr(world, name) for name in _ENTITY_COMPONENTS},
                 step_count=world.step_count, custom=world.custom)
    return [
        base.map_tensors(lambda a, s=s: a[s * n_loc:(s + 1) * n_loc].to(mesh.device, copy=True))
        for s in range(mesh.n_slabs)
    ]


def unplace_fn(chunks: Sequence[World]) -> World:
    """The inverse of ``place_fn``: one world of the chunks' entities, in
    order (for ``Engine.restore`` and comparisons)."""
    first = chunks[0]

    def joined(get):
        comp = get(first)
        return comp.replace(**{
            f.name: torch.cat([getattr(get(c), f.name) for c in chunks])
            for f in dataclasses.fields(comp)
        })

    comps = {name: joined(lambda w, name=name: getattr(w, name)) for name in _ENTITY_COMPONENTS}
    custom = {name: joined(lambda w, name=name: w.custom[name]) for name in first.custom}
    return World(**comps, step_count=first.step_count, custom=custom)


# ---------------------------------------------------------------------------
# the per-slab functions of one frame
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HaloPlan:
    """What one halo frame needs besides the slabs: resolved at build."""

    cfg: EngineConfig
    n_dev: int
    n_loc: int
    solver_geom: GridGeom  # the whole world's solver grid
    slab_geom: GridGeom  # one slab's interior: rows_per_slab x cols
    route_cap: int
    type_specs: Tuple[Tuple[type, int], ...]
    frame_counts: torch.Tensor
    # phase A (halo.py:525-541): whether the ticks read neighbours, the
    # payload channels, and the neighbour table's slab geometry: the halo
    # width ``hw`` (the cell-scan radius), the spatial grid rows a slab
    # owns, and its table of those rows plus hw halo rows on each side
    need_neighbors: bool
    payload_channels: Dict[str, int]
    extra_paths: Tuple[str, ...]
    hw: int
    rows_per_slab_sp: int
    table_geom: GridGeom
    leaf_specs: List[Tuple[str, str, Any]]
    empty_nbr: NeighborLists  # the home chunk's lists without phase A

    def gid(self, d: int, device) -> torch.Tensor:
        return d * self.n_loc + torch.arange(self.n_loc, dtype=torch.int32, device=device)


def _gather_home(homes: Sequence[World]):
    """``ctx.gather``'s resolver under the halo step: the path's field of the
    home chunks at frame start, concatenated into global-id order (the
    reference's all_gather, halo.py:669-672)."""
    return lambda path: torch.cat([read_field(c, path) for c in homes])


def slab_logic(chunk: World, inputs: InputState, plan: HaloPlan, d: int, gather_fn) -> World:
    """Phase A without neighbours (``phase_a_local``, halo.py:730-754): the
    ticks on slab d's home chunk, with empty lists. The step refuses a
    particle pool, so emissions drop, as the reference's do without one."""
    return run_logic_phase_masked(chunk, plan.empty_nbr, inputs, plan.cfg, plan.type_specs,
                                  plan.payload_channels, row_ids=plan.gid(d, chunk.device),
                                  gather_fn=gather_fn)[0]


def slab_move(chunk: World, plan: HaloPlan) -> World:
    """The animation advance and the Verlet move on a home chunk."""
    cfg = plan.cfg
    chunk = advance_animation(chunk, plan.frame_counts, cfg.dt_ratio)
    return verlet_move(chunk, cfg, cfg.dt_ratio)


def slab_logic_rows(chunk: World, plan: HaloPlan, d: int):
    """Phase A's send side (halo.py:560-570): every row packed whole with
    its global id in the last lane, its destination from its spatial grid
    row (home for a non-finite position), and the routed mask (active)."""
    cfg = plan.cfg
    t = chunk.transform
    finite = torch.isfinite(t.x) & torch.isfinite(t.y)
    grow = _cell_coord(t.y, 1.0 / cfg.spatial.cell_size, cfg.grid_rows)
    dest = torch.where(finite, torch.clamp(grow // plan.rows_per_slab_sp, max=plan.n_dev - 1), d)
    gid = plan.gid(d, chunk.device).to(torch.int64)
    rows = torch.cat([pack_world_rows(chunk, plan.leaf_specs), gid[:, None]], dim=1)
    return rows, dest, t.active


def slab_neighbor_table(recv: torch.Tensor, chunk: World, plan: HaloPlan, d: int):
    """Phase A's binning on slab d (halo.py:571-613): the received rows
    unpacked, and their table of f32 ``[gid, x, y, *declared fields]``
    rows, binned by the global cell truncation offset to the slab's table
    rows (``hw`` halo rows above). Returns (local world, gids, table)."""
    cfg, sp = plan.cfg, plan.cfg.spatial
    res_gid = recv[:, -1].to(torch.int32)
    local = unpack_world_rows(recv[:, :-1], chunk, plan.leaf_specs)
    lt = local.transform
    valid_ent = lt.active & torch.isfinite(lt.x) & torch.isfinite(lt.y)
    inv = 1.0 / sp.cell_size
    grow = _cell_coord(lt.y, inv, cfg.grid_rows)
    gcol = _cell_coord(lt.x, inv, cfg.grid_cols)
    geom = plan.table_geom
    loc_row = torch.clamp(grow - d * plan.rows_per_slab_sp + plan.hw, 0, geom.rows - 1)
    rows_vals = torch.stack(
        [res_gid.to(torch.float32), lt.x, lt.y]
        + [read_field(local, p).to(torch.float32) for p in plan.extra_paths], dim=1)
    bins = bin_entities(lt.x, lt.y, valid_ent, geom, row=loc_row, col=gcol,
                        table_values=rows_vals)
    return local, res_gid, bins


def _exchange_table_rows(mesh: SlabMesh, tables: List[torch.Tensor], plan: HaloPlan) -> None:
    """The neighbour tables' halo (halo.py:615-628): each slab's ``hw`` top
    rows from the slab above's last owned rows, its ``hw`` bottom rows from
    the slab below's first. In place; sources and targets never overlap
    (``hw <= rows_per_slab_sp``)."""
    geom, hw, rps = plan.table_geom, plan.hw, plan.rows_per_slab_sp
    bodies = [t[:geom.num_cells].view(geom.rows, geom.cols, *t.shape[1:]) for t in tables]
    from_up = mesh.shift_down([b[rps:rps + hw] for b in bodies])
    from_dn = mesh.shift_up([b[hw:2 * hw] for b in bodies])
    for b, a, c in zip(bodies, from_up, from_dn):
        b[0:hw] = a
        b[hw + rps:2 * hw + rps] = c


def slab_neighbor_logic(local: World, res_gid: torch.Tensor, bins, inputs: InputState,
                        plan: HaloPlan, d: int, gather_fn) -> torch.Tensor:
    """Phase A's lists and ticks on slab d (halo.py:630-677): every
    resident's row-major ``(2hw+1)^2`` candidate cells by global bounds (a
    row outside the world, or outside this slab's table for a row that is
    not resident here, reads the empty sentinel), the acceptance test and
    the cap, then the masked ticks. Returns the residents' packed rows."""
    cfg = plan.cfg
    geom, hw = plan.table_geom, plan.hw
    lt = local.transform
    valid_ent = lt.active & torch.isfinite(lt.x) & torch.isfinite(lt.y)
    inv = 1.0 / cfg.spatial.cell_size
    grow = _cell_coord(lt.y, inv, cfg.grid_rows)
    gcol = _cell_coord(lt.x, inv, cfg.grid_cols)
    offs = torch.arange(-hw, hw + 1, dtype=torch.int32, device=lt.x.device)
    cand_grow = grow[:, None] + offs.repeat_interleave(2 * hw + 1)[None, :]
    cand_gcol = gcol[:, None] + offs.repeat(2 * hw + 1)[None, :]
    cand_lrow = cand_grow - d * plan.rows_per_slab_sp + hw
    in_b = ((cand_grow >= 0) & (cand_grow < cfg.grid_rows) & (cand_gcol >= 0)
            & (cand_gcol < cfg.grid_cols) & (cand_lrow >= 0) & (cand_lrow < geom.rows))
    cand_cell = torch.where(in_b, cand_lrow * geom.cols + cand_gcol, geom.num_cells)
    table = bins.table
    flat = table[cand_cell.to(torch.int64)].view(lt.x.shape[0], -1, table.shape[-1])
    nbr = accept_candidates(flat, lt.x, lt.y, res_gid, local.collider.visual_range, valid_ent,
                            cfg.spatial.max_neighbors, bins.n_binned)
    local, _emissions = run_logic_phase_masked(local, nbr, inputs, cfg, plan.type_specs,
                                               plan.payload_channels, row_ids=res_gid,
                                               gather_fn=gather_fn)
    return pack_world_rows(local, plan.leaf_specs)


def phase_a(mesh: SlabMesh, chunks: List[World], inputs: InputState, plan: HaloPlan):
    """The neighbour-reading phase A over all slabs (halo.py:559-725).
    Returns (chunks, n_binned, route overflow), the counts summed over
    slabs. Slabs build their candidate rows one at a time, so one slab's
    ``[m, S, F]`` payload is alive at once."""
    gather_fn = _gather_home(chunks)
    sent = [slab_logic_rows(c, plan, d) for d, c in enumerate(chunks)]
    recv, sent_slot, ovf = route_out(mesh, *zip(*sent), plan.route_cap)
    tabled = [slab_neighbor_table(r, c, plan, d) for d, (r, c) in enumerate(zip(recv, chunks))]
    _exchange_table_rows(mesh, [b.table for _l, _g, b in tabled], plan)
    out = [slab_neighbor_logic(local, gid, bins, inputs, plan, d, gather_fn)
           for d, (local, gid, bins) in enumerate(tabled)]
    back = route_back(mesh, out, sent_slot, plan.route_cap)
    n_lanes = len(plan.leaf_specs)
    chunks = [unpack_world_rows(torch.where(ok[:, None], got, rows[:, :n_lanes]), c,
                                plan.leaf_specs)
              for c, (rows, _d, _v), (got, ok) in zip(chunks, sent, back)]
    return chunks, mesh.psum([b.n_binned for _l, _g, b in tabled]), mesh.psum(ovf)


def slab_solver_rows(chunk: World, plan: HaloPlan, d: int):
    """Phase B's send side (halo.py:760-768): the chunk's packed solver rows
    as int32 lanes with the occupancy lane set, each row's destination slab
    from its post-move y, and the valid mask (active and finite)."""
    t = chunk.transform
    geom = plan.solver_geom
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)
    packed = pack_solver_rows(chunk, gid=plan.gid(d, chunk.device))
    packed[:, 7] = 1.0  # occupancy lane
    grow = _cell_coord(t.y, 1.0 / geom.cell_size, geom.rows)
    dest = torch.clamp(grow // plan.slab_geom.rows, max=plan.n_dev - 1)
    return packed.view(torch.int32), dest, valid


def slab_grid(recv: torch.Tensor, plan: HaloPlan, d: int):
    """Phase B's bin and scatter on slab d (halo.py:770-785): global cell
    truncation offset to the slab, a stable binning in arrival order, and
    the bordered grid ``[rows_per_slab+2, C+2, cap, 8]``. Returns (grid,
    flat slot of each received row, in-grid mask)."""
    res = recv.view(torch.float32)
    res_valid = res[:, 7] > 0
    rx, ry = res[:, 0], res[:, 1]
    g, sg = plan.solver_geom, plan.slab_geom
    inv = 1.0 / g.cell_size
    grow = _cell_coord(ry, inv, g.rows)
    gcol = _cell_coord(rx, inv, g.cols)
    lrow = torch.clamp(grow - d * sg.rows, 0, sg.rows - 1)
    bins = bin_entities(rx, ry, res_valid, sg, build_table=False, row=lrow, col=gcol)
    cap = sg.capacity
    in_grid = res_valid & (bins.rank < cap)
    flat = ((bins.row.to(torch.int64) + 1) * (sg.cols + 2)
            + (bins.col.to(torch.int64) + 1)) * cap + bins.rank.to(torch.int64)
    flat_cells = (sg.rows + 2) * (sg.cols + 2) * cap
    flat = torch.where(in_grid, flat, flat_cells)
    return scatter_solver_grid(res, flat, sg.rows, sg.cols, cap), flat, in_grid


def slab_solver_out(st, flat: torch.Tensor, in_grid: torch.Tensor) -> torch.Tensor:
    """Phase B's read-back (halo.py:807-818): each resident row's x, y, px,
    py (int32 bits), contact count and in-grid flag, ``[m, 6]`` int32."""
    n_slots = st.gx.numel()
    out = torch.stack([st.gx, st.gy, st.gpx, st.gpy], dim=-1).reshape(n_slots, 4)
    safe = torch.where(in_grid, flat, 0)
    return torch.cat([
        out[safe].view(torch.int32),
        st.count.reshape(n_slots)[safe][:, None],
        in_grid.to(torch.int32)[:, None],
    ], dim=1)


def slab_solver_finish(chunk: World, got: torch.Tensor, got_ok: torch.Tensor,
                       cfg: EngineConfig):
    """Phase B's home side (halo.py:819-848): solved rows take the returned
    state; rows that overflowed routing or their cell's capacity fall back
    to the boundary clamp alone, as on one device. Returns (chunk, solved
    count)."""
    t, rb, c = chunk.transform, chunk.rigid_body, chunk.collider
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)
    solved = got_ok & (got[:, 5] > 0)
    h = got[:, :4].contiguous().view(torch.float32)
    moving = t.active & rb.active & ~rb.static
    over = valid & ~solved
    fx, fy, fpx, fpy = _overflow_fallback(t.x, t.y, rb.px, rb.py, c.radius, moving, over, cfg)

    def pick(i, own, fallback):
        return torch.where(over, fallback, torch.where(solved, h[:, i], own))

    chunk = chunk.replace(
        transform=t.replace(x=pick(0, t.x, fx), y=pick(1, t.y, fy)),
        rigid_body=rb.replace(px=pick(2, rb.px, fpx), py=pick(3, rb.py, fpy),
                              collision_count=torch.where(solved, got[:, 4], 0)),
    )
    return chunk, torch.sum(solved, dtype=torch.int32)


def slab_finish(chunk: World, inputs: InputState, cfg: EngineConfig) -> World:
    """Derived velocity/angle, screen culling and the frame count."""
    chunk = update_derived(chunk, cfg)
    chunk = update_entity_visibility(chunk, cfg, inputs)
    return chunk.replace(step_count=chunk.step_count + 1)


def _fill_border(mesh: SlabMesh, grids: List[torch.Tensor], rows: int) -> None:
    """Border rows <- the neighbour slabs' edge rows, every channel (once a
    frame; halo.py:788-793). In place on the fresh grids."""
    from_above = mesh.shift_down([g[rows:rows + 1] for g in grids])
    from_below = mesh.shift_up([g[1:2] for g in grids])
    for g, a, b in zip(grids, from_above, from_below):
        g[0:1] = a
        g[rows + 1:rows + 2] = b


def _halo_xy(mesh: SlabMesh, states, rows: int):
    """The per-substep refresh of the border rows' x and y from the
    neighbour slabs (halo.py:795-800)."""
    out = list(states)
    for name in ("gx", "gy"):
        vals = [getattr(st, name) for st in out]
        from_above = mesh.shift_down([v[rows:rows + 1] for v in vals])
        from_below = mesh.shift_up([v[1:2] for v in vals])
        out = [st.replace(**{name: torch.cat([a, v[1:rows + 1], b])})
               for st, v, a, b in zip(out, vals, from_above, from_below)]
    return out


# ---------------------------------------------------------------------------
# building the step
# ---------------------------------------------------------------------------

METRIC_KEYS = (
    "active_count", "collision_pair_count", "collision_pairs_dropped",
    "n_binned", "active_particles", "nonfinite_count", "solver_binned",
    "route_overflow_logic", "route_overflow_solver",
)


def make_halo_step(engine, mesh: SlabMesh, oversub: float = 4.0, chunk_steps: int = 1):
    """Build the spatial-domain step for an initialized engine.

    Returns (step_fn, place_fn): ``place_fn(world)`` cuts the world into the
    mesh's D chunk worlds (:func:`place_world`; :func:`unplace_fn` is the
    inverse); ``step_fn(chunks, inputs) -> (chunks, metrics)`` runs one
    frame, with the reference's nine metrics as 0-dim int32 tensors.
    ``chunk_steps=K > 1``: ``step_fn(chunks, inputs_timeline)`` runs K
    frames, one per ``InputState`` of the sequence, with every metric
    stacked ``[K]``. ``step_fn.plan`` is the :class:`HaloPlan`.

    The solver grid is sized from the world as it stands (flush queued
    spawns first). Solver "auto" resolves as "pallas": K3 on the card, its
    plain version on the CPU. Each frame launches K3 once per slab and
    substep. When a ticking class reads neighbours, each frame runs
    :func:`phase_a`: its ``n_binned`` and ``route_overflow_logic`` are then
    summed over slabs (-1 and 0 otherwise)."""
    engine._require_init()
    n_dev = mesh.n_slabs
    n = engine.world.n_entities
    if n % n_dev != 0:
        raise ValueError(
            f"halo step needs entity count divisible by the mesh size "
            f"({n} % {n_dev} != 0); pad a registration"
        )
    if n >= (1 << 24):
        raise ValueError("the halo step packs entity ids into f32: N must be < 2^24")
    cfg = engine._resolve_spatial()
    if cfg.spatial.method != "grid":
        raise ValueError("halo step requires spatial.method='grid'")
    if cfg.physics.solver == "neighbors":
        raise ValueError("halo step requires the grid constraint solver")
    _check_supported(cfg)  # the neighbour-list solver
    if cfg.logic.collision_events or cfg.logic.screen_events:
        _refuse("collision and screen events under the halo step",
                "slice C, item 14 (per-slab pair recording with the mixed passes)")
    if cfg.particle.max_particles > 0 or cfg.particle.decals or cfg.lighting.enabled:
        _refuse("particles, decals and lighting under the halo step",
                "slice C, item 14 (the mixed halo passes)")
    cfg, solver_geom, forced = engine._solver_plan(cfg)
    if solver_geom is None or forced:
        raise ValueError("halo step could not derive a solver geometry (no radii)")
    payload_channels, extra_paths = engine._payload_plan(cfg)
    type_specs = tuple(
        (reg.cls, reg.entity_type) for reg in engine.classes.values()
        if reg.count > 0 and getattr(reg.cls, "tick", None) is not None
    )
    need_neighbors = engine._ticks_read_neighbors()
    sp = cfg.spatial
    hw = max(1, sp.max_cell_radius)  # the spatial halo width: the scan radius
    rows_sp = math.ceil(cfg.grid_rows / n_dev)
    if need_neighbors and hw > rows_sp:
        raise ValueError(
            f"spatial halo width {hw} exceeds rows-per-slab {rows_sp}: "
            f"too many slabs for this grid (rows={cfg.grid_rows})"
        )

    plan = HaloPlan(
        cfg=cfg,
        n_dev=n_dev,
        n_loc=n // n_dev,
        solver_geom=solver_geom,
        slab_geom=GridGeom(cell_size=solver_geom.cell_size,
                           rows=math.ceil(solver_geom.rows / n_dev),
                           cols=solver_geom.cols, capacity=solver_geom.capacity),
        route_cap=route_capacity(n // n_dev, n_dev, oversub),
        type_specs=type_specs,
        frame_counts=engine._frame_counts().to(mesh.device),
        need_neighbors=need_neighbors,
        payload_channels=payload_channels,
        extra_paths=extra_paths,
        hw=hw,
        rows_per_slab_sp=rows_sp,
        table_geom=GridGeom(cell_size=sp.cell_size, rows=rows_sp + 2 * hw,
                            cols=cfg.grid_cols, capacity=sp.cell_capacity),
        leaf_specs=entity_leaf_specs(engine.world),
        empty_nbr=empty_neighbor_lists(n // n_dev, mesh.device),
    )
    rows = plan.slab_geom.rows

    def zero(v):
        return torch.full((), v, dtype=torch.int32, device=mesh.device)

    def full_step(chunks: Sequence[World], inputs: InputState):
        if len(chunks) != n_dev:
            raise ValueError(f"expected {n_dev} chunk worlds, got {len(chunks)}")
        chunks = list(chunks)
        chunks[0] = apply_inputs(chunks[0], inputs)  # entity 0 is the mouse
        if plan.need_neighbors:
            chunks, n_binned, ovf_a = phase_a(mesh, chunks, inputs, plan)
        else:
            gather_fn = _gather_home(chunks)
            chunks = [slab_logic(c, inputs, plan, d, gather_fn) for d, c in enumerate(chunks)]
            n_binned, ovf_a = zero(-1), zero(0)
        chunks = [slab_move(c, plan) for c in chunks]

        sent = [slab_solver_rows(c, plan, d) for d, c in enumerate(chunks)]
        recv, sent_slot, ovf = route_out(mesh, *zip(*sent), plan.route_cap)
        slabs = [slab_grid(r, plan, d) for d, r in enumerate(recv)]
        grids = [s[0] for s in slabs]
        _fill_border(mesh, grids, rows)
        states = [grid_solver_state(g) for g in grids]
        salt = chunks[0].step_count & 0xFFFFFFFF
        for _ in range(cfg.physics.sub_step_count):
            states = _halo_xy(mesh, states, rows)
            states = [solver_substep(st, cfg, salt) for st in states]
        back = route_back(mesh, [slab_solver_out(st, s[1], s[2])
                                 for st, s in zip(states, slabs)],
                          sent_slot, plan.route_cap)
        done = [slab_solver_finish(c, got, ok, cfg) for c, (got, ok) in zip(chunks, back)]
        chunks = [slab_finish(c, inputs, cfg) for c, _ in done]
        ts = [c.transform for c in chunks]
        metrics = {
            "active_count": mesh.psum([torch.sum(t.active, dtype=torch.int32) for t in ts]),
            "collision_pair_count": zero(0),
            "collision_pairs_dropped": zero(0),
            "n_binned": n_binned,
            "active_particles": zero(-1),
            "nonfinite_count": mesh.psum([
                torch.sum(t.active & ~(torch.isfinite(t.x) & torch.isfinite(t.y)),
                          dtype=torch.int32) for t in ts]),
            "solver_binned": mesh.psum([s for _, s in done]),
            "route_overflow_logic": ovf_a,
            "route_overflow_solver": mesh.psum(ovf),
        }
        return chunks, metrics

    if chunk_steps > 1:
        def step_fn(chunks, inputs_timeline):
            if len(inputs_timeline) != chunk_steps:
                raise ValueError(f"expected {chunk_steps} input states, "
                                 f"got {len(inputs_timeline)}")
            frames = []
            for ins in inputs_timeline:
                chunks, m = full_step(chunks, ins)
                frames.append(m)
            return chunks, {k: torch.stack([m[k] for m in frames]) for k in METRIC_KEYS}
    else:
        step_fn = full_step
    step_fn.plan = plan

    def place_fn(world: World) -> List[World]:
        return place_world(world, mesh)

    return step_fn, place_fn
