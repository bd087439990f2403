"""The spatial-domain halo step, on the in-process slab mesh.

PyTorch counterpart of ``multithreadedgameengine_tpu/parallel/halo.py``: the
world is cut into D horizontal slabs of solver-grid rows; every frame each
active entity's solver row travels to the slab that owns its post-move
position, each slab bins its residents into its own bordered grid, the
border rows are filled from the neighbour slabs, and the substeps run with
the border positions refreshed at the start of each; the results travel
home. BASELINE config 5's rung, with K3 (``pair_pass_grid``) as the solver
of ``solver="pallas"`` (what "auto" resolves to).

Ported here: ``entity_leaf_specs``, ``pack_world_rows``/``unpack_world_rows``
(exact transport: float32 lanes travel as their int32 bits, every lane is
int64, so the port's int64 tints never wrap), ``_rank_within_dest``,
``route_out``/``route_back`` (split into the per-slab ``route_send`` and
``route_take`` around the mesh's all_to_all), ``route_capacity``, and
``make_halo_step`` with ``phase_a_local``, ``phase_b`` and ``local_step``
(halo.py:108-233, 730-1003) as per-slab functions; ``_edge_perms`` lives
in ``parallel/mesh.py``, behind the mesh's ``shift_down``/``shift_up``. The
step is bit-exact with the single-device ``Engine.step``: binning uses the
global cell truncation offset to the slab, and residents arrive
source-major in ascending index order, so every cell ranks its entities in
global-id order.

One deliberate difference from the reference: its K3 never reads the grid's
border rows (pallas_kernels.py:814-825), so under its halo step
``solver="pallas"`` misses every contact across a slab seam. The port's K3
reads them, as the reference's XLA formulation does (ROADMAP §3).

Not ported yet, and refused: neighbour-reading phase A, collision events,
particles, decals and shadows (ROADMAP slice C); the chunk's input timeline
is a list of ``InputState``. ``check_vma`` is an XLA-only knob and is not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import torch

from ..behavior import run_logic_phase_masked
from ..components import BUILTIN_COMPONENTS
from ..config import EngineConfig
from ..engine import _check_supported, apply_inputs
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
from ..ops.spatial import GridGeom, _cell_coord, bin_entities
from ..render.extract import advance_animation
from ..state import World
from .mesh import SlabMesh

_ENTITY_COMPONENTS = tuple(BUILTIN_COMPONENTS)


# ---------------------------------------------------------------------------
# packed-row transport: every per-entity field as one int64 lane
# ---------------------------------------------------------------------------

def entity_leaf_specs(world: World) -> List[Tuple[str, str, Any]]:
    """Deterministic [(component, field, dtype)] over every per-entity
    leaf of the ported components."""
    return [
        (name, f.name, getattr(getattr(world, name), f.name).dtype)
        for name in _ENTITY_COMPONENTS
        for f in dataclasses.fields(getattr(world, name))
    ]


def pack_world_rows(world: World, specs) -> torch.Tensor:
    """[n, L] int64 rows, one lane per field: float32 as its int32 bit
    pattern, bool and integers widened (an int64 tint as it is)."""
    cols = []
    for cname, fname, dt in specs:
        arr = getattr(getattr(world, cname), fname)
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
    return world.replace(**{
        cname: getattr(world, cname).replace(**fs) for cname, fs in fields.items()
    })


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
                 step_count=world.step_count)
    return [
        base.map_tensors(lambda a, s=s: a[s * n_loc:(s + 1) * n_loc].to(mesh.device, copy=True))
        for s in range(mesh.n_slabs)
    ]


def unplace_fn(chunks: Sequence[World]) -> World:
    """The inverse of ``place_fn``: one world of the chunks' entities, in
    order (for ``Engine.restore`` and comparisons)."""
    first = chunks[0]
    comps = {}
    for name in _ENTITY_COMPONENTS:
        comp = getattr(first, name)
        comps[name] = comp.replace(**{
            f.name: torch.cat([getattr(getattr(c, name), f.name) for c in chunks])
            for f in dataclasses.fields(comp)
        })
    return World(**comps, step_count=first.step_count)


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

    def gid(self, d: int, device) -> torch.Tensor:
        return d * self.n_loc + torch.arange(self.n_loc, dtype=torch.int32, device=device)


def slab_logic(chunk: World, inputs: InputState, plan: HaloPlan, d: int) -> World:
    """Phase A without neighbours (``phase_a_local``, halo.py:730-754), the
    animation advance and the Verlet move, on slab d's home chunk."""
    cfg = plan.cfg
    chunk = run_logic_phase_masked(chunk, inputs, cfg, plan.type_specs,
                                   row_ids=plan.gid(d, chunk.device))
    chunk = advance_animation(chunk, plan.frame_counts, cfg.dt_ratio)
    return verlet_move(chunk, cfg, cfg.dt_ratio)


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
    substep."""
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
    cfg = engine.config
    if cfg.spatial.method != "grid":
        raise ValueError("halo step requires spatial.method='grid'")
    if cfg.physics.solver == "neighbors":
        raise ValueError("halo step requires the grid constraint solver")
    _check_supported(cfg)  # events, particles, decals, lighting: slice C
    cfg, solver_geom, forced = engine._solver_plan(cfg)
    if solver_geom is None or forced:
        raise ValueError("halo step could not derive a solver geometry (no radii)")

    plan = HaloPlan(
        cfg=cfg,
        n_dev=n_dev,
        n_loc=n // n_dev,
        solver_geom=solver_geom,
        slab_geom=GridGeom(cell_size=solver_geom.cell_size,
                           rows=math.ceil(solver_geom.rows / n_dev),
                           cols=solver_geom.cols, capacity=solver_geom.capacity),
        route_cap=route_capacity(n // n_dev, n_dev, oversub),
        type_specs=tuple(
            (reg.cls, reg.entity_type) for reg in engine.classes.values()
            if reg.count > 0 and getattr(reg.cls, "tick", None) is not None
        ),
        frame_counts=engine._frame_counts().to(mesh.device),
    )
    rows = plan.slab_geom.rows

    def full_step(chunks: Sequence[World], inputs: InputState):
        if len(chunks) != n_dev:
            raise ValueError(f"expected {n_dev} chunk worlds, got {len(chunks)}")
        chunks = list(chunks)
        chunks[0] = apply_inputs(chunks[0], inputs)  # entity 0 is the mouse
        chunks = [slab_logic(c, inputs, plan, d) for d, c in enumerate(chunks)]

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

        def zero(v):
            return torch.full((), v, dtype=torch.int32, device=mesh.device)

        ts = [c.transform for c in chunks]
        metrics = {
            "active_count": mesh.psum([torch.sum(t.active, dtype=torch.int32) for t in ts]),
            "collision_pair_count": zero(0),
            "collision_pairs_dropped": zero(0),
            "n_binned": zero(-1),
            "active_particles": zero(-1),
            "nonfinite_count": mesh.psum([
                torch.sum(t.active & ~(torch.isfinite(t.x) & torch.isfinite(t.y)),
                          dtype=torch.int32) for t in ts]),
            "solver_binned": mesh.psum([s for _, s in done]),
            "route_overflow_logic": zero(0),
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
