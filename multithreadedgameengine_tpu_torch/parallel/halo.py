"""The spatial-domain halo step, on a slab mesh (``parallel.mesh``).

PyTorch counterpart of ``multithreadedgameengine_tpu/parallel/halo.py``: the
world is cut into D horizontal slabs; every frame

- phase A: when a ticking class reads neighbours, or collision events or
  shadows are on, each active entity's whole row travels to the slab that
  owns its spatial grid row; the slab bins its residents into a neighbour
  table of its rows plus ``hw`` halo rows from each neighbour slab (``hw``
  = the cell-scan radius), builds its residents' neighbour lists, runs the
  ticks, records its residents' contact pairs with global ids and the
  shadow rows of its lights, and the rows travel home. Otherwise the ticks
  run at home with empty lists (``phase_a_local``);
- the frame's replicated passes (:func:`replicated_passes`): the slabs'
  pair tables merged into one and diffed into the Enter/Stay/Exit tables,
  the particle pool moved, the landed particles stamped into the decal
  canvas, the slabs' tick emissions merged into the single-device order and
  claimed, and the shadow sprites summed from the slabs' disjoint shares;
- each entity's solver row travels to the slab that owns its post-move
  position, each slab bins its residents into its own bordered grid, the
  border rows are filled from the neighbour slabs, and the substeps run
  with the border positions refreshed at the start of each; the results
  travel home. BASELINE config 5's rung, with K3 (``pair_pass_grid``) as
  the solver of ``solver="pallas"`` (what "auto" resolves to).

Ported here: ``entity_leaf_specs`` (built-ins, then the sorted user
components), ``pack_world_rows``/``unpack_world_rows`` (exact transport through
:func:`to_lanes`: float32 lanes travel as their int32 bits, every lane is
int64, so the port's int64 colours never wrap), ``_rank_within_dest``,
``route_out``/``route_back`` (split into the per-slab ``route_send`` and
``route_take`` around the mesh's all_to_all), ``route_capacity``,
``_merge_emissions``, ``_slab_shadow_sprites`` (with its light selection
split out, :func:`_shadow_selection`) and ``make_halo_step`` with
``phase_a``, ``phase_a_local``, ``phase_b`` and ``local_step``
(halo.py:108-379, 559-1003) as per-slab functions; ``_edge_perms`` lives in
``parallel/mesh.py``, behind the mesh's ``shift_down``/``shift_up``. The
step is bit-exact with the single-device ``Engine.step``: binning uses the
global cell truncation offset to the slab, and residents arrive
source-major in ascending index order, so every cell ranks its entities in
global-id order, and the candidate scan reads the same cells in the same
order. Pair tables merge in slab order where the single device records in
entity order, so ``collision_pairs`` holds the same pairs in another order;
the diffed event tables are sorted, and equal. The shadow sprites read the
casters' frame-start state (the payload channels), as in the reference:
on a moving scene they lag ``Engine.step``'s by a frame.

The step runs on any mesh of ``parallel.mesh``'s contract: on the
in-process ``SlabMesh`` a process holds every slab, on
``parallel.dist.ProcessMesh`` one. Each per-slab function takes its slab's
index from ``mesh.slabs``, and reads other slabs only through the mesh's
collectives. On one process the particle pool, the decal canvas and its
tiles, the pair and event tables and the shadow sprites are the SAME
tensors on every chunk world, and each replicated pass runs once a frame;
on a process mesh each process holds its own copy and runs the pass once,
on the same gathered inputs, as the reference computes it once per device.
No pass changes a shared tensor in place. ``unplace_fn`` takes them from
chunk 0 (on a process mesh, rank 0's).

Two deliberate differences from the reference's results: its K3 never
reads the grid's border rows (pallas_kernels.py:814-825), so under its halo
step ``solver="pallas"`` misses every contact across a slab seam; the
port's K3 reads them, as the reference's XLA formulation does (ROADMAP §3).
And ``logic.screen_events`` is refused: the reference's slab steps compute
no screen events (``parallel/*.py`` has no such pass), and an empty table
handed back in silence would lose every transition.

Under phase A a tick's ``ctx.world`` holds the slab's routed rows, as in
the reference, and ``ctx.gather`` resolves a path against the home chunks'
frame-start fields in global-id order (halo.py:664-672). Hook dispatch is
the engine's: the step leaves the event tables in the chunk worlds. The
chunk's input timeline is a list of ``InputState``. ``check_vma`` is an
XLA-only knob and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..behavior import read_field, run_logic_phase_masked
from ..components import BUILTIN_COMPONENTS, ShadowSprites
from ..config import EngineConfig
from ..engine import apply_inputs
from ..inputs import InputState
from ..ops.culling import update_entity_visibility, update_particle_visibility
from ..ops.decals import default_decal_textures, stamp_decals
from ..ops.events import compact_rows, diff_pairs
from ..ops.lighting import shadow_math
from ..ops.particles import apply_emission, first_k_where, update_particles
from ..ops.physics import _sqrt, compact_pairs, update_derived, verlet_move
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
from ..state import EVENT_TABLES, World
from .mesh import SlabMesh

_ENTITY_COMPONENTS = tuple(BUILTIN_COMPONENTS)
#: the world leaves every chunk shares (the reference's replicated leaves)
REPLICATED = ("particles", "decal_canvas", "decal_dirty", "shadow_sprites") + tuple(
    name for pair in EVENT_TABLES for name in pair)
_I32_MAX = 2**31 - 1
#: the "__collision__" channel of an inactive collider (engine._NO_COLLIDER)
_NO_COLLIDER = -3.0e38


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


def to_lanes(a: torch.Tensor) -> torch.Tensor:
    """``a`` ``[n, ...]`` as exact int64 lanes ``[n, k]``: float32 as its
    int32 bit pattern, float64 as its int64 bits, bool and integers
    widened (an int64 tint as it is). The one row format of the slab
    steps' routing and the entity-sharded step's gather."""
    a = a.reshape(a.shape[0], -1)
    if a.dtype == torch.float32:
        return a.view(torch.int32).to(torch.int64)
    if a.dtype == torch.float64:
        return a.view(torch.int64)
    return a.to(torch.int64)


def from_lanes(lanes: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The exact inverse of :func:`to_lanes`: ``lanes`` ``[n, k]`` as a
    ``dtype`` tensor of ``shape`` (``n`` rows)."""
    if dtype == torch.float32:
        a = lanes.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        a = lanes.contiguous().view(torch.float64)
    elif dtype == torch.bool:
        a = lanes != 0
    else:
        a = lanes.to(dtype)
    return a.reshape(shape)


def pack_world_rows(world: World, specs) -> torch.Tensor:
    """[n, L] int64 rows, one lane per field (:func:`to_lanes`)."""
    return torch.cat([to_lanes(getattr(_get_comp(world, cname), fname))
                      for cname, fname, _dt in specs], dim=1)


def unpack_world_rows(rows: torch.Tensor, world: World, specs) -> World:
    """A world whose per-entity leaves are the unpacked rows (the exact
    inverse of :func:`pack_world_rows`); ``step_count`` from ``world``."""
    fields = {}
    for k, (cname, fname, dt) in enumerate(specs):
        fields.setdefault(cname, {})[fname] = from_lanes(rows[:, k:k + 1], dt, rows.shape[:1])
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

def replicated_leaves(world: World, device) -> Dict[str, Any]:
    """The world's replicated leaves that exist, copied once to ``device``:
    every chunk world holds these same tensors."""
    out = {}
    for name in REPLICATED:
        v = getattr(world, name)
        if v is not None:
            out[name] = (v.to(device, copy=True) if isinstance(v, torch.Tensor)
                         else v.map_tensors(lambda a: a.to(device, copy=True)))
    return out


def place_world(world: World, mesh: SlabMesh) -> List[World]:
    """The world's chunks of the mesh's local slabs, ``N/D`` consecutive
    entities each, on the mesh's device (chunk s holds entities ``s*N/D ..
    (s+1)*N/D - 1``), each holding the same replicated leaves. Every process
    of a process mesh is handed the whole world and keeps its own slab.
    Solver caches are left behind: the halo step bins every frame."""
    n = world.n_entities
    if n % mesh.n_slabs != 0:
        raise ValueError(f"entity count {n} is not divisible by the mesh size {mesh.n_slabs}")
    n_loc = n // mesh.n_slabs
    base = World(**{name: getattr(world, name) for name in _ENTITY_COMPONENTS},
                 step_count=world.step_count, custom=world.custom)
    rep = replicated_leaves(world, mesh.device)
    return [
        base.map_tensors(lambda a, s=s: a[s * n_loc:(s + 1) * n_loc].to(mesh.device, copy=True))
        .replace(**rep)
        for s in mesh.slabs
    ]


def gather_chunks(mesh: SlabMesh, chunks: Sequence[World]) -> Optional[List[World]]:
    """Every slab's chunk world on the process that holds slab 0 (None on
    the others): the local chunks as they are when this process holds every
    slab, else each chunk's entity rows packed exactly, gathered through
    ``mesh.gather`` and unpacked over rank 0's chunk, whose replicated leaves
    and host ints they keep. Every slab's chunk has the same row count."""
    if len(mesh.slabs) == mesh.n_slabs:
        return list(chunks)
    specs = entity_leaf_specs(chunks[0])
    rows = mesh.gather([pack_world_rows(c, specs) for c in chunks])
    if rows is None:
        return None
    return [unpack_world_rows(r, chunks[0], specs) for r in rows.unbind(0)]


def unplace_fn(chunks: Sequence[World], mesh: SlabMesh) -> Optional[World]:
    """The inverse of ``place_fn``: one world of the chunks' entities, in
    order, with chunk 0's replicated leaves (for ``Engine.restore`` and
    comparisons). ``chunks`` are this process's, one for each slab of
    ``mesh.slabs``, and every process calls it: the chunks gather to the
    holder of slab 0 (:func:`gather_chunks`), which returns the world, and
    the other processes return None. Raises ``ValueError`` when the chunks
    are not one for each of the mesh's local slabs."""
    if len(chunks) != len(mesh.slabs):
        raise ValueError(f"{len(chunks)} chunks for a mesh that holds slabs {mesh.slabs} "
                         "here: unplace the chunks of the mesh that placed them")
    chunks = gather_chunks(mesh, chunks)
    if chunks is None:
        return None
    first = chunks[0]

    def joined(get):
        comp = get(first)
        return comp.replace(**{
            f.name: torch.cat([getattr(get(c), f.name) for c in chunks])
            for f in dataclasses.fields(comp)
        })

    comps = {name: joined(lambda w, name=name: getattr(w, name)) for name in _ENTITY_COMPONENTS}
    custom = {name: joined(lambda w, name=name: w.custom[name]) for name in first.custom}
    return World(**comps, step_count=first.step_count, custom=custom,
                 **{name: getattr(first, name) for name in REPLICATED})


# ---------------------------------------------------------------------------
# what both slab steps resolve at build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlabPlan:
    """What a frame of the halo or the homed step needs besides the slabs:
    resolved at build."""

    cfg: EngineConfig
    n_dev: int
    solver_geom: GridGeom  # the whole world's solver grid
    slab_geom: GridGeom  # one slab's interior: rows_per_slab x cols
    type_specs: Tuple[Tuple[type, int], ...]
    frame_counts: torch.Tensor
    # phase A (halo.py:496-541): whether the frame builds neighbour lists
    # (a ticking class reads them, or events or shadows are on), the
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
    # the mixed passes (halo.py:470-505): collision events, hook-scoped
    # over the entity types of the hooked classes; shadows; the particle
    # pool, its emission budget and the decal textures (None: no decals)
    events: bool
    scope_hooked: bool
    hooked_types: Tuple[int, ...]
    max_pairs: int
    shadows_on: bool
    has_particles: bool
    emit_budget: int
    decal_textures: Optional[torch.Tensor]


def slab_plan_fields(engine, mesh: SlabMesh, what: str) -> Dict[str, Any]:
    """The :class:`SlabPlan` fields of an initialized engine on ``mesh``
    (halo.py:423-541; homed.py:155-237), and the resolved config. Solver
    "auto" resolves as "pallas". ``what`` names the step in errors."""
    engine._require_init()
    n_dev = mesh.n_slabs
    if engine.world.n_entities >= (1 << 24):
        raise ValueError(f"the {what} step packs entity ids into f32: N must be < 2^24")
    cfg = engine._resolve_spatial()
    if cfg.spatial.method != "grid":
        raise ValueError(f"{what} step requires spatial.method='grid'")
    if cfg.physics.solver == "neighbors":
        raise ValueError(f"{what} step requires the grid constraint solver")
    if cfg.logic.screen_events:
        raise NotImplementedError(
            "logic.screen_events under the halo and homed steps: the reference's slab steps "
            "compute no screen events (parallel/*.py has no such pass), and the port refuses "
            "them rather than hand back empty tables (ROADMAP §3, kept difference)")
    cfg, solver_geom, forced = engine._solver_plan(cfg)
    if solver_geom is None or forced:
        raise ValueError(f"{what} step could not derive a solver geometry (no radii)")
    lg, lc = cfg.logic, cfg.lighting
    hooked_types = tuple(reg.entity_type for reg in engine.classes.values()
                         if reg.count > 0 and engine._class_has_hooks(reg.cls))
    shadows_on = lc.enabled and lc.shadows_enabled
    payload_channels, extra_paths = engine._payload_plan(cfg)
    if shadows_on:
        # caster data rides the candidate table: one packed validity/radius
        # channel and the caster height
        payload_channels = dict(payload_channels)
        extra_paths = list(extra_paths)
        for p in ("__shadow__", "shadow.height"):
            if p not in payload_channels:
                payload_channels[p] = 3 + len(extra_paths)
                extra_paths.append(p)
    need_neighbors = engine._ticks_read_neighbors() or lg.collision_events or shadows_on
    sp = cfg.spatial
    hw = max(1, sp.max_cell_radius)  # the spatial halo width: the scan radius
    rows_sp = math.ceil(cfg.grid_rows / n_dev)
    if need_neighbors and hw > rows_sp:
        raise ValueError(
            f"spatial halo width {hw} exceeds rows-per-slab {rows_sp}: "
            f"too many slabs for this grid (rows={cfg.grid_rows})"
        )
    has_particles = cfg.particle.max_particles > 0
    return dict(
        cfg=cfg,
        n_dev=n_dev,
        solver_geom=solver_geom,
        type_specs=tuple(
            (reg.cls, reg.entity_type) for reg in engine.classes.values()
            if reg.count > 0 and getattr(reg.cls, "tick", None) is not None
        ),
        frame_counts=engine._frame_counts().to(mesh.device),
        need_neighbors=need_neighbors,
        payload_channels=payload_channels,
        extra_paths=tuple(extra_paths),
        hw=hw,
        rows_per_slab_sp=rows_sp,
        table_geom=GridGeom(cell_size=sp.cell_size, rows=rows_sp + 2 * hw,
                            cols=cfg.grid_cols, capacity=sp.cell_capacity),
        leaf_specs=entity_leaf_specs(engine.world),
        events=lg.collision_events,
        scope_hooked=lg.collision_events and not lg.record_all_pairs and bool(hooked_types),
        hooked_types=hooked_types,
        max_pairs=cfg.physics.max_collision_pairs,
        shadows_on=shadows_on,
        has_particles=has_particles,
        emit_budget=cfg.particle.max_emit_per_step if has_particles else 0,
        decal_textures=(default_decal_textures(len(engine.sprites.textures), mesh.device)
                        if has_particles and cfg.particle.decals else None),
    )


@dataclasses.dataclass
class HaloPlan(SlabPlan):
    """The halo step's plan: chunks of ``n_loc`` entities, ``route_cap``
    slots per (source, destination) pair, and the home chunk's empty lists
    for a frame without phase A."""

    n_loc: int
    route_cap: int
    empty_nbr: NeighborLists

    def gid(self, d: int, device) -> torch.Tensor:
        return d * self.n_loc + torch.arange(self.n_loc, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# phase A on one slab
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlabLights:
    """One slab's first L eligible lights by global id after its ticks
    (``_slab_shadow_sprites``' local selection, halo.py:308-319): their
    keys (the gid, ``2^31 - 1`` past the slab's lights), and their rows'
    neighbour ids and d^2, the casters' x, y, packed shadow channel and
    height from the payload, and the lights' x, y and intensity."""

    key: torch.Tensor  # int64[L]
    ids: torch.Tensor  # int32[L, S]
    d2: torch.Tensor  # f32[L, S]
    casters: torch.Tensor  # f32[L, S, 4]
    x: torch.Tensor  # f32[L]
    y: torch.Tensor
    intensity: torch.Tensor


@dataclasses.dataclass
class SlabPasses:
    """What phase A on one slab hands the replicated passes: the ticks'
    emission blocks with the rows' global ids, the slab's pair table
    (pairs, count, dropped) or None, and its lights or None."""

    emissions: Tuple[List[Dict[str, Any]], torch.Tensor]
    pairs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    lights: Optional[SlabLights] = None


def _gather_home(mesh: SlabMesh, homes: Sequence[World]):
    """``ctx.gather``'s resolver under the halo step: the path's field of the
    home chunks at frame start, gathered over the mesh into global-id order
    (the reference's all_gather, halo.py:669-672). Every process resolves
    the same paths, since every class's tick runs on every slab."""
    return lambda path: mesh.all_gather([read_field(c, path) for c in homes]).flatten(0, 1)


def slab_logic(chunk: World, inputs: InputState, plan: SlabPlan, row_ids: torch.Tensor,
               gather_fn) -> Tuple[World, SlabPasses]:
    """Phase A without neighbours (``phase_a_local``, halo.py:730-754): the
    ticks on a home chunk with empty lists. ``row_ids``, the rows' global
    ids, key its emissions for the merge. Returns (chunk, its emissions)."""
    empty = empty_neighbor_lists(chunk.transform.x.shape[0], chunk.device)
    chunk, emissions = run_logic_phase_masked(chunk, empty, inputs, plan.cfg, plan.type_specs,
                                              plan.payload_channels, gather_fn=gather_fn)
    return chunk, SlabPasses(emissions=(emissions, row_ids))


def slab_move(chunk: World, plan: SlabPlan) -> World:
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


def _hooked_mask(local: World, plan: SlabPlan) -> torch.Tensor:
    """Rows whose class defines a collision hook (halo.py:578-582)."""
    et = local.transform.entity_type
    m = torch.zeros_like(local.transform.active)
    for t in plan.hooked_types:
        m = m | (et == t)
    return m


def _table_channel(local: World, path: str, plan: SlabPlan) -> torch.Tensor:
    """One payload channel of the neighbour table (halo.py:589-606): the
    packed ``"__collision__"`` channel (an active collider's radius, or
    ``-radius - 1`` for a class without hooks under hook-scoped recording,
    as ``Engine._collision_channel``), the packed ``"__shadow__"`` channel
    (a visible active caster's shadow radius, else -1), or a field."""
    if path == "__collision__":
        c = local.collider
        enc = c.radius
        if plan.scope_hooked:
            enc = torch.where(_hooked_mask(local, plan), enc, -enc - 1.0)
        return torch.where(c.active, enc, _NO_COLLIDER)
    if path == "__shadow__":
        ok = local.shadow.active & local.sprite.is_on_screen
        return torch.where(ok, local.shadow.shadow_radius, -1.0)
    return read_field(local, path).to(torch.float32)


def slab_residents(recv: torch.Tensor, chunk: World, plan: SlabPlan):
    """Phase A's received rows unpacked (halo.py:571-576). Returns (local
    world, gids, valid rows: active with a finite position)."""
    res_gid = recv[:, -1].to(torch.int32)
    local = unpack_world_rows(recv[:, :-1], chunk, plan.leaf_specs)
    lt = local.transform
    return local, res_gid, lt.active & torch.isfinite(lt.x) & torch.isfinite(lt.y)


def slab_neighbor_table(local: World, res_gid: torch.Tensor, valid_ent: torch.Tensor,
                        plan: SlabPlan, d: int):
    """Phase A's binning on slab d (halo.py:584-613): the table of f32
    ``[gid, x, y, *payload channels]`` rows of the ``valid_ent`` rows,
    binned by the global cell truncation offset to the slab's table rows
    (``hw`` halo rows above)."""
    cfg, sp = plan.cfg, plan.cfg.spatial
    lt = local.transform
    inv = 1.0 / sp.cell_size
    grow = _cell_coord(lt.y, inv, cfg.grid_rows)
    gcol = _cell_coord(lt.x, inv, cfg.grid_cols)
    geom = plan.table_geom
    loc_row = torch.clamp(grow - d * plan.rows_per_slab_sp + plan.hw, 0, geom.rows - 1)
    rows_vals = torch.stack(
        [res_gid.to(torch.float32), lt.x, lt.y]
        + [_table_channel(local, p, plan) for p in plan.extra_paths], dim=1)
    return bin_entities(lt.x, lt.y, valid_ent, geom, row=loc_row, col=gcol,
                        table_values=rows_vals)


def _exchange_table_rows(mesh: SlabMesh, tables: List[torch.Tensor], plan: SlabPlan) -> None:
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


def _slab_pairs(local: World, hooked: torch.Tensor, res_gid: torch.Tensor,
                res_fin: torch.Tensor, nbr: NeighborLists, plan: SlabPlan):
    """The slab's contact pairs with global ids (halo.py:683-705): the
    engine's acceptance over its residents' lists (post-tick flags,
    frame-start positions and d^2), hook-scoped unless
    ``record_all_pairs``, each pair once; then ``compact_pairs``. Returns
    (pairs ``[max_pairs, 2]``, count, dropped)."""
    lt, lc = local.transform, local.collider
    ids = nbr.ids
    ch = nbr.payload.data[..., plan.payload_channels["__collision__"]]
    coll_j = ch > -1.0e30
    self_ok = lt.active & lc.active & res_fin & (res_gid >= 0)
    if plan.scope_hooked:
        hooked_j = ch >= 0
        r_j = torch.where(hooked_j, ch, -ch - 1.0)
        ok = (self_ok & hooked)[:, None] & (ids >= 0) & coll_j
        once = torch.where(hooked_j, ids > res_gid[:, None], True)
    else:
        r_j = ch
        ok = self_ok[:, None] & (ids >= 0) & coll_j
        once = ids > res_gid[:, None]
    min_d = lc.radius[:, None] + r_j
    rec = ok & (nbr.d2 < min_d * min_d) & once
    return compact_pairs(ids, rec, plan.max_pairs, row_ids=res_gid)


def _slab_lights(local: World, res_gid: torch.Tensor, valid_ent: torch.Tensor,
                 nbr: NeighborLists, plan: SlabPlan) -> SlabLights:
    """The slab's first L eligible lights by gid (halo.py:308-319), with
    the rows the sprite math reads. A light is eligible when it and its
    entity are active, on screen, of positive intensity and a valid row."""
    t, li = local.transform, local.light
    light_ok = (li.active & t.active & local.sprite.is_on_screen
                & (li.light_intensity > 0) & valid_ent)
    key = torch.where(light_ok, res_gid.to(torch.int64), _I32_MAX)
    L = plan.cfg.lighting.max_shadow_casting_lights
    skey, sidx = torch.sort(key, stable=True)
    skey, sidx = skey[:L], sidx[:L]
    if skey.shape[0] < L:  # fewer rows than lights: pad with none
        skey = torch.nn.functional.pad(skey, (0, L - skey.shape[0]), value=_I32_MAX)
        sidx = torch.nn.functional.pad(sidx, (0, L - sidx.shape[0]))
    ch = plan.payload_channels
    rows = nbr.payload.data[sidx]
    casters = torch.stack([rows[..., k] for k in (1, 2, ch["__shadow__"], ch["shadow.height"])],
                          dim=-1)
    return SlabLights(key=skey, ids=nbr.ids[sidx], d2=nbr.d2[sidx], casters=casters,
                      x=t.x[sidx], y=t.y[sidx], intensity=li.light_intensity[sidx])


def slab_neighbor_logic(local: World, res_gid: torch.Tensor, valid_ent: torch.Tensor, bins,
                        inputs: InputState, plan: SlabPlan, d: int,
                        gather_fn) -> Tuple[World, SlabPasses]:
    """Phase A's lists, ticks, pairs and lights on slab d (halo.py:630-718):
    every resident's row-major ``(2hw+1)^2`` candidate cells by global
    bounds (a row outside the world, or outside this slab's table for a row
    that is not resident here, reads the empty sentinel), the acceptance
    test and the cap, the masked ticks, then the pair recording and the
    light rows. Returns (the residents after their ticks, the slab's share
    of the replicated passes)."""
    cfg = plan.cfg
    geom, hw = plan.table_geom, plan.hw
    lt = local.transform
    res_fin = torch.isfinite(lt.x) & torch.isfinite(lt.y)
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
    hooked = _hooked_mask(local, plan) if plan.scope_hooked else None
    row_ids = torch.clamp(res_gid, min=0)  # a free homed row (-1) is inactive
    local, emissions = run_logic_phase_masked(local, nbr, inputs, cfg, plan.type_specs,
                                              plan.payload_channels, gather_fn=gather_fn)
    passes = SlabPasses(emissions=(emissions, row_ids))
    if plan.events:
        passes.pairs = _slab_pairs(local, hooked, res_gid, res_fin, nbr, plan)
    if plan.shadows_on:
        passes.lights = _slab_lights(local, res_gid, valid_ent, nbr, plan)
    return local, passes


def phase_a(mesh: SlabMesh, chunks: List[World], inputs: InputState, plan: HaloPlan):
    """The neighbour-reading phase A over all slabs (halo.py:559-725).
    Returns (chunks, n_binned, route overflow, each slab's passes), the
    counts summed over slabs. Slabs build their candidate rows one at a
    time, so one slab's ``[m, S, F]`` payload is alive at once."""
    gather_fn = _gather_home(mesh, chunks)
    sent = [slab_logic_rows(c, plan, d) for d, c in zip(mesh.slabs, chunks)]
    recv, sent_slot, ovf = route_out(mesh, *zip(*sent), plan.route_cap)
    residents = [slab_residents(r, c, plan) for r, c in zip(recv, chunks)]
    bins = [slab_neighbor_table(local, gid, ok, plan, d)
            for d, (local, gid, ok) in zip(mesh.slabs, residents)]
    _exchange_table_rows(mesh, [b.table for b in bins], plan)
    out, passes = [], []
    for d, (local, gid, ok), b in zip(mesh.slabs, residents, bins):
        local, p = slab_neighbor_logic(local, gid, ok, b, inputs, plan, d, gather_fn)
        out.append(pack_world_rows(local, plan.leaf_specs))
        passes.append(p)
    back = route_back(mesh, out, sent_slot, plan.route_cap)
    n_lanes = len(plan.leaf_specs)
    chunks = [unpack_world_rows(torch.where(ok[:, None], got, rows[:, :n_lanes]), c,
                                plan.leaf_specs)
              for c, (rows, _d, _v), (got, ok) in zip(chunks, sent, back)]
    return chunks, mesh.psum([b.n_binned for b in bins]), mesh.psum(ovf), passes


# ---------------------------------------------------------------------------
# the replicated passes, once a frame
# ---------------------------------------------------------------------------

def _merge_emissions(mesh: SlabMesh, slab_emissions, budget: int):
    """The slabs' tick-emission blocks merged into the single-device
    emission batch (halo.py:239-286): requests sort by (emitter gid, slot),
    which is ``apply_tick_emissions``' class, row, slot order since class
    slot ranges ascend in registration order. Each slab sorts its keys and
    keeps the first ``budget`` (what the pool could take at most), then the
    gathered ``[D * budget]`` keys sort and truncate again; the sorts are
    stable. ``slab_emissions``: per slab (requests, gids). Returns (batch,
    total) for ``apply_emission``, or (None, None) with no requests."""
    if budget <= 0 or not slab_emissions[0][0]:
        return None, None
    stride = max(r["valid"].shape[1] for r in slab_emissions[0][0])
    keys, fields = [], {k: [] for k in slab_emissions[0][0][0]["fields"]}
    for requests, gids in slab_emissions:
        g = gids.to(torch.int64)
        key = torch.cat([(g[:, None] * stride + torch.arange(r["valid"].shape[1],
                                                             device=g.device)).reshape(-1)
                         for r in requests])
        valid = torch.cat([r["valid"].reshape(-1) for r in requests])
        big = torch.where(valid, key, _I32_MAX)
        vals = {k: torch.cat([r["fields"][k].reshape(-1) for r in requests]) for k in fields}
        if big.shape[0] < budget:
            pad = budget - big.shape[0]
            big = torch.nn.functional.pad(big, (0, pad), value=_I32_MAX)
            vals = {k: torch.cat([v, v.new_zeros((pad,))]) for k, v in vals.items()}
        keyl, ordl = torch.sort(big, stable=True)
        ordl = ordl[:budget]
        keys.append(keyl[:budget])
        for k, v in vals.items():
            fields[k].append(v[ordl])
    allk = mesh.all_gather(keys).reshape(-1)
    ordg = torch.sort(allk, stable=True).indices[:budget]
    batch = {k: mesh.all_gather(v).reshape(-1)[ordg] for k, v in fields.items()}
    total = torch.clamp(torch.sum(allk < _I32_MAX, dtype=torch.int32), max=budget)
    return batch, total


def _shadow_selection(mesh: SlabMesh, keys: Sequence[torch.Tensor], n_lights: int) -> torch.Tensor:
    """The global first-L light selection (halo.py:320): the slabs' first-L
    gids gathered and sorted; ``2^31 - 1`` marks a slot with no light."""
    return torch.sort(mesh.all_gather(keys).reshape(-1)).values[:n_lights]


def _slab_shadow_sprites(lights: SlabLights, sel: torch.Tensor,
                         cfg: EngineConfig) -> Dict[str, torch.Tensor]:
    """This slab's shadow-sprite share (halo.py:289-375): each selected
    light whose row is on this slab walks its list and keeps its first
    ``max_shadows_per_light`` visible casters at distance >= 1 in scan
    order; every other slot is zero, so the slabs' shares sum to the whole
    ``[L * M]`` output. Caster state is the frame-start payload. Returns
    {field: f32 [L * M]}, ``active`` as 0/1."""
    lc = cfg.lighting
    M = lc.max_shadows_per_light
    eq = (lights.key[None, :] == sel[:, None]) & (sel < _I32_MAX)[:, None]  # [L, L]
    has = eq.any(dim=1)
    lrow = torch.argmax(eq.to(torch.int32), dim=1)  # the first match (0 without)
    ids, d2, cs = lights.ids[lrow], lights.d2[lrow], lights.casters[lrow]
    caster_ok = has[:, None] & (ids >= 0) & (cs[..., 2] >= 0) & (_sqrt(d2) >= 1.0)
    rank = torch.cumsum(caster_ok, dim=1, dtype=torch.int32)
    keep = caster_ok & (rank <= M)
    ord2 = first_k_where(keep, M, dim=1)  # [L, min(S, M)]
    c2 = ord2.shape[1]
    kept = torch.gather(keep, 1, ord2)

    def take(a):
        return torch.gather(a, 1, ord2)

    c_sh, c_h_raw = take(cs[..., 2]), take(cs[..., 3])
    c_rad = torch.where(c_sh > 0, c_sh, 10.0)  # || 10 (particle_worker.js:945)
    c_h = torch.where(c_h_raw > 0, c_h_raw, c_rad)  # || radius (:946)
    fields = shadow_math(take(cs[..., 0]), take(cs[..., 1]), c_rad, c_h, lights.x[lrow][:, None],
                         lights.y[lrow][:, None], lights.intensity[lrow][:, None], take(d2))

    def out(a):
        a = torch.where(kept, torch.broadcast_to(a, kept.shape).to(torch.float32), 0.0)
        return torch.nn.functional.pad(a, (0, M - c2)).reshape(-1)

    return {"active": out(kept), **{k: out(v) for k, v in fields.items()}}


def merge_pair_tables(mesh: SlabMesh, slab_pairs, max_pairs: int):
    """The slabs' pair tables into one (halo.py:874-886): gathered in slab
    order, the valid rows compacted by a ``cumsum`` rank into
    ``[max_pairs, 2]``; rows past it drop and are counted. Returns (pairs,
    count, dropped)."""
    allp = mesh.all_gather([p[0] for p in slab_pairs]).reshape(-1, 2)
    allc = mesh.all_gather([p[1] for p in slab_pairs])  # [D]
    p_loc = slab_pairs[0][0].shape[0]
    ar = torch.arange(p_loc, dtype=torch.int32, device=allp.device)
    validp = (ar[None, :] < allc[:, None]).reshape(-1)
    pairs = compact_rows(validp, allp, max_pairs)
    total = torch.sum(validp, dtype=torch.int32)
    count = torch.clamp(total, max=max_pairs)
    dropped = mesh.psum([p[2] for p in slab_pairs]) + (total - count)
    return pairs, count, dropped


def replicated_passes(mesh: SlabMesh, plan: SlabPlan, world: World, inputs: InputState,
                      passes: Sequence[SlabPasses]):
    """The frame's replicated passes, once a process (halo.py:867-980),
    each slab's share gathered over the mesh: the merged
    pair table, its Enter/Stay/Exit difference against the last frame's and
    the swap; the particle pool moved, the landed particles stamped, the
    tick emissions merged and claimed, the pool's visibility; the shadow
    sprites summed from the slabs' shares. ``world`` holds the replicated
    leaves at frame start (any chunk). Returns (the new replicated leaves,
    the pair count, pairs dropped, live particles (-1: no pool))."""
    cfg = plan.cfg
    zero = torch.zeros((), dtype=torch.int32, device=mesh.device)
    rep: Dict[str, Any] = {}
    pair_count, pairs_dropped = zero, zero
    if plan.events:
        pairs, pair_count, pairs_dropped = merge_pair_tables(
            mesh, [p.pairs for p in passes], plan.max_pairs)
        enter, n_e, stay, n_s, exit_, n_x = diff_pairs(
            pairs, pair_count, world.prev_collision_pairs, world.prev_collision_pair_count)
        rep.update(collision_pairs=pairs, collision_pair_count=pair_count,
                   prev_collision_pairs=pairs, prev_collision_pair_count=pair_count,
                   event_enter=enter, event_enter_count=n_e, event_stay=stay,
                   event_stay_count=n_s, event_exit=exit_, event_exit_count=n_x)
    p_active = zero - 1
    if plan.has_particles:
        pool, stamps, p_active = update_particles(world.particles, cfg, cfg.dt_ratio,
                                                  plan.decal_textures is not None)
        if plan.decal_textures is not None:
            rep["decal_canvas"], rep["decal_dirty"] = stamp_decals(
                world.decal_canvas, world.decal_dirty, stamps, plan.decal_textures, cfg)
        batch, total = _merge_emissions(mesh, [p.emissions for p in passes], plan.emit_budget)
        if batch is not None:
            pool, spawned = apply_emission(pool, batch, total)
            p_active = p_active + spawned
        rep["particles"] = update_particle_visibility(world.replace(particles=pool), cfg,
                                                      inputs).particles
    if plan.shadows_on:
        sel = _shadow_selection(mesh, [p.lights.key for p in passes],
                                cfg.lighting.max_shadow_casting_lights)
        shares = [_slab_shadow_sprites(p.lights, sel, cfg) for p in passes]
        summed = {k: mesh.psum([s[k] for s in shares]) for k in shares[0]}
        active = summed.pop("active") > 0
        rep["shadow_sprites"] = ShadowSprites(active=active, **summed)
    return rep, pair_count, pairs_dropped, p_active


# ---------------------------------------------------------------------------
# phase B on one slab
# ---------------------------------------------------------------------------

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


def bin_solver_rows(res: torch.Tensor, plan: SlabPlan, row0: int):
    """Bin and scatter a slab's f32 solver rows ``[m, 8]`` (occupancy in
    lane 7) into its bordered grid ``[rows_per_slab+2, C+2, cap, 8]``
    (halo.py:770-785, homed.py:580-592): global cell truncation offset to
    the slab's first solver row ``row0``, a stable binning in row order.
    Returns (grid, flat slot of each row, in-grid mask)."""
    res_valid = res[:, 7] > 0
    rx, ry = res[:, 0], res[:, 1]
    g, sg = plan.solver_geom, plan.slab_geom
    inv = 1.0 / g.cell_size
    grow = _cell_coord(ry, inv, g.rows)
    gcol = _cell_coord(rx, inv, g.cols)
    lrow = torch.clamp(grow - row0, 0, sg.rows - 1)
    bins = bin_entities(rx, ry, res_valid, sg, build_table=False, row=lrow, col=gcol)
    cap = sg.capacity
    in_grid = res_valid & (bins.rank < cap)
    flat = ((bins.row.to(torch.int64) + 1) * (sg.cols + 2)
            + (bins.col.to(torch.int64) + 1)) * cap + bins.rank.to(torch.int64)
    flat_cells = (sg.rows + 2) * (sg.cols + 2) * cap
    flat = torch.where(in_grid, flat, flat_cells)
    return scatter_solver_grid(res, flat, sg.rows, sg.cols, cap), flat, in_grid


def slab_grid(recv: torch.Tensor, plan: HaloPlan, d: int):
    """Phase B's bin and scatter on slab d of the halo step, whose rows
    start at ``d * rows_per_slab``."""
    return bin_solver_rows(recv.view(torch.float32), plan, d * plan.slab_geom.rows)


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


def apply_solved(chunk: World, valid: torch.Tensor, solved: torch.Tensor, h: torch.Tensor,
                 count: torch.Tensor, cfg: EngineConfig) -> World:
    """Phase B's home side (halo.py:826-847, homed.py:675-694): solved rows
    take the returned x, y, px, py (``h`` ``[n, 4]``) and contact count;
    valid rows that were not solved (routing or cell-capacity overflow)
    fall back to the boundary clamp alone, as on one device."""
    t, rb, c = chunk.transform, chunk.rigid_body, chunk.collider
    moving = t.active & rb.active & ~rb.static
    over = valid & ~solved
    fx, fy, fpx, fpy = _overflow_fallback(t.x, t.y, rb.px, rb.py, c.radius, moving, over, cfg)

    def pick(i, own, fallback):
        return torch.where(over, fallback, torch.where(solved, h[:, i], own))

    return chunk.replace(
        transform=t.replace(x=pick(0, t.x, fx), y=pick(1, t.y, fy)),
        rigid_body=rb.replace(px=pick(2, rb.px, fpx), py=pick(3, rb.py, fpy),
                              collision_count=torch.where(solved, count, 0)),
    )


def slab_solver_finish(chunk: World, got: torch.Tensor, got_ok: torch.Tensor,
                       cfg: EngineConfig):
    """The halo step's home side of phase B (halo.py:819-848). Returns
    (chunk, solved count)."""
    t = chunk.transform
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)
    solved = got_ok & (got[:, 5] > 0)
    h = got[:, :4].contiguous().view(torch.float32)
    return apply_solved(chunk, valid, solved, h, got[:, 4], cfg), torch.sum(solved, dtype=torch.int32)


def slab_finish(chunk: World, inputs: InputState, cfg: EngineConfig) -> World:
    """Derived velocity/angle and screen culling."""
    chunk = update_derived(chunk, cfg)
    return update_entity_visibility(chunk, cfg, inputs)


def fill_border(mesh: SlabMesh, grids: List[torch.Tensor], lens: Sequence[int]) -> None:
    """Border rows <- the neighbour slabs' edge rows, every channel, once a
    frame (halo.py:788-793; homed.py:599-610): slab d's row 0 from the slab
    above's last interior row, its row ``lens[d] + 1`` from the slab
    below's first. ``lens``: each slab's interior rows (host ints). In place
    on the fresh grids; no row that is read is written."""
    from_above = mesh.shift_down([g[n:n + 1] for g, n in zip(grids, lens)])
    from_below = mesh.shift_up([g[1:2] for g in grids])
    for g, n, a, b in zip(grids, lens, from_above, from_below):
        g[0:1] = a
        g[n + 1:n + 2] = b


def refresh_halo_xy(mesh: SlabMesh, states, lens: Sequence[int]):
    """The per-substep refresh of the border rows' x and y from the
    neighbour slabs (halo.py:795-800; homed.py:612-621)."""
    out = list(states)
    for name in ("gx", "gy"):
        vals = [getattr(st, name) for st in out]
        from_above = mesh.shift_down([v[n:n + 1] for v, n in zip(vals, lens)])
        from_below = mesh.shift_up([v[1:2] for v in vals])
        out = [st.replace(**{name: torch.cat([a, v[1:n + 1], b, v[n + 2:]])})
               for st, v, n, a, b in zip(out, vals, lens, from_above, from_below)]
    return out


def run_slab_substeps(mesh: SlabMesh, grids: List[torch.Tensor], lens: Sequence[int],
                      cfg: EngineConfig, salt: int):
    """The substeps of every slab's grid, in step: the border rows filled
    once, then each substep refreshes the border positions and runs
    ``solver_substep`` (K3 for "pallas") slab by slab. Returns the states."""
    fill_border(mesh, grids, lens)
    states = [grid_solver_state(g) for g in grids]
    for _ in range(cfg.physics.sub_step_count):
        states = refresh_halo_xy(mesh, states, lens)
        states = [solver_substep(st, cfg, salt) for st in states]
    return states


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
    chunk worlds of the mesh's local slabs (:func:`place_world`;
    :func:`unplace_fn` is the inverse); ``step_fn(chunks, inputs) ->
    (chunks, metrics)`` runs one frame, with the reference's nine metrics as
    0-dim int32 tensors, summed over every slab of the mesh.
    ``chunk_steps=K > 1``: ``step_fn(chunks, inputs_timeline)`` runs K
    frames, one per ``InputState`` of the sequence, with every metric
    stacked ``[K]``. ``step_fn.plan`` is the :class:`HaloPlan`.

    The solver grid is sized from the world as it stands (flush queued
    spawns first). Solver "auto" resolves as "pallas": K3 on the card, its
    plain version on the CPU. Each frame launches K3 once per slab and
    substep. When the frame builds neighbour lists, it runs
    :func:`phase_a`: its ``n_binned`` and ``route_overflow_logic`` are then
    summed over slabs (-1 and 0 otherwise). Collision events, particles,
    decals and shadows run as :func:`replicated_passes`; screen events
    raise ``NotImplementedError``."""
    n_dev = mesh.n_slabs
    n_held = len(mesh.slabs)
    engine._require_init()
    n = engine.world.n_entities
    if n % n_dev != 0:
        raise ValueError(
            f"halo step needs entity count divisible by the mesh size "
            f"({n} % {n_dev} != 0); pad a registration"
        )
    common = slab_plan_fields(engine, mesh, "halo")
    g = common["solver_geom"]
    plan = HaloPlan(
        **common,
        slab_geom=GridGeom(cell_size=g.cell_size, rows=math.ceil(g.rows / n_dev),
                           cols=g.cols, capacity=g.capacity),
        n_loc=n // n_dev,
        route_cap=route_capacity(n // n_dev, n_dev, oversub),
        empty_nbr=empty_neighbor_lists(n // n_dev, mesh.device),
    )
    cfg = plan.cfg
    lens = [plan.slab_geom.rows] * n_held

    def zero(v):
        return torch.full((), v, dtype=torch.int32, device=mesh.device)

    def full_step(chunks: Sequence[World], inputs: InputState):
        if len(chunks) != n_held:
            raise ValueError(f"expected {n_held} chunk worlds, got {len(chunks)}")
        chunks = list(chunks)
        if 0 in mesh.slabs:  # entity 0, the mouse, lives on slab 0
            k = mesh.slabs.index(0)
            chunks[k] = apply_inputs(chunks[k], inputs)
        if plan.need_neighbors:
            chunks, n_binned, ovf_a, passes = phase_a(mesh, chunks, inputs, plan)
        else:
            gather_fn = _gather_home(mesh, chunks)
            done = [slab_logic(c, inputs, plan, plan.gid(d, c.device), gather_fn)
                    for d, c in zip(mesh.slabs, chunks)]
            chunks, passes = [c for c, _ in done], [p for _, p in done]
            n_binned, ovf_a = zero(-1), zero(0)
        rep, pair_count, pairs_dropped, p_active = replicated_passes(
            mesh, plan, chunks[0], inputs, passes)
        chunks = [slab_move(c, plan) for c in chunks]

        sent = [slab_solver_rows(c, plan, d) for d, c in zip(mesh.slabs, chunks)]
        recv, sent_slot, ovf = route_out(mesh, *zip(*sent), plan.route_cap)
        slabs = [slab_grid(r, plan, d) for d, r in zip(mesh.slabs, recv)]
        states = run_slab_substeps(mesh, [s[0] for s in slabs], lens, cfg,
                                   chunks[0].step_count & 0xFFFFFFFF)
        back = route_back(mesh, [slab_solver_out(st, s[1], s[2])
                                 for st, s in zip(states, slabs)],
                          sent_slot, plan.route_cap)
        done = [slab_solver_finish(c, got, ok, cfg) for c, (got, ok) in zip(chunks, back)]
        chunks = [slab_finish(c, inputs, cfg).replace(step_count=c.step_count + 1, **rep)
                  for c, _ in done]
        ts = [c.transform for c in chunks]
        metrics = {
            "active_count": mesh.psum([torch.sum(t.active, dtype=torch.int32) for t in ts]),
            "collision_pair_count": pair_count,
            "collision_pairs_dropped": pairs_dropped,
            "n_binned": n_binned,
            "active_particles": p_active,
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
