"""The Engine — host orchestrator and Scene API, on the card by default.

PyTorch counterpart of ``multithreadedgameengine_tpu/engine.py``:
entity-class registration with parent-chain registration, ``init``, the
spawn/despawn control plane (``spawn``, ``spawn_batch``, ``despawn``,
``despawn_batch``, ``despawn_all``, ``active_indices``; each split, as in
the reference, into a half that claims or releases slots and builds the
writes and a half that scatters them), ``step(n)``, frame plans
(:class:`FramePlan`, ``begin_plan``, ``run_plan``), ``pause``/``resume``,
``destroy``, ``snapshot``/``restore``, checkpoints, ``stats`` with the step
timer, the timeline and the phase profiler (``profiling``), the debug
flags (``debugging``), ``update_physics_config``, the Mouse as entity 0
and ``apply_inputs``; for renderers, ``render_packet``, ``screenshot``,
``load_assets`` (with the constructor's ``images``/``sheets`` and
``engine.atlas``) and the sprite-override RPC (``set_sprite_prop``,
``call_sprite_method``, ``sprite_overrides_payload``).

One frame (the reference's ``one_step_impl`` with the grid solver,
engine.py:1460-1824), run eagerly:

1. ``apply_inputs`` writes the mouse as entity 0;
2. when a ticking class reads neighbours, shadows are on, collision
   events are or the neighbour-list solver runs, the neighbour lists
   (``ops.spatial.neighbor_lists``, or ``neighbor_lists_by_class`` with
   ``spatial.per_class_assembly``) with the declared payload channels; then
   ``behavior.run_logic_phase`` runs the ticks;
3. ``render.extract.advance_animation``, by the registry's frame counts;
4. physics: ``ops.physics.physics_step`` (Verlet move, the grid solver
   or, for solver "neighbors" and a scene with no collider radius, the
   neighbour-list solver over the frame's lists, derived properties), or
   with position residency
   ``ops.physics_grid.resident_persistent_step`` then ``update_derived``;
5. with ``logic.collision_events``: the frame's contact pairs recorded from
   its neighbour lists (``ops.physics.record_collision_pairs``: per class,
   over the hooked classes' rows, or over every row) and diffed against the
   last frame's (``ops.events.diff_pairs``) into the Enter/Stay/Exit tables;
6. with a particle pool: ``ops.particles.update_particles``, then
   ``ops.decals.stamp_decals``, then the ticks' ``"emit"`` requests
   (``apply_tick_emissions``), then ``ops.culling.update_particle_visibility``;
7. ``ops.culling.update_entity_visibility``;
8. with ``logic.screen_events``, the onScreen Enter/Exit difference against
   the last frame's visibility, packed into one table;
9. with shadows: ``ops.lighting.shadow_sprites`` (or
   ``shadow_sprites_by_class`` over per-class lists), and the step metrics.

While a ``torch.profiler`` records, each of these calls, the call's
preparation and the hook dispatch is a named span (``profiling.span``).

Events reach the host in one of two ways (engine.py:2516-2583). A frame
stepped alone reads the three event counts (and the screen table) and fires
the hooks at once: scalar hooks per pair, both orientations in table order,
``_batch`` hooks once per class (``_fire_collision_tables``). ``step(n)``
with ``logic.event_chunk > 1`` runs chunks of frames that log every frame's
tables and their participants' positions into device tensors, copies each
chunk's log to the host once, and fires the hooks per frame from the copy;
with ``logic.event_overlap`` a chunk's hooks fire after the next chunk is
queued, and the held log is flushed at every barrier (``sync``,
``snapshot``, ``restore``, a plan rebuild).

Host-side, ``Engine.sprites`` is the sprite registry (``assets``) and
``Engine.emitter`` the particle emitter (``emitter``), whose queue lands in
the pool before each ``step`` (``_flush_emissions``).

A frame plan queues each frame's spawns, despawns and input snapshot on
the host, claiming slots and drawing the seeded stream as it is built;
``run_plan`` runs it in chunks, each chunk an eager loop of full frames
whose op table and input timeline reach the card in one copy, with no host
read inside the chunk (engine.py:2330-2488; the reference's compiled chunk
program exists for XLA). A chunk in which any frame writes rebins on every
frame, and a chunk whose frames mostly write runs off the resident layout,
as the reference's do.

The plan (``_build_plan``, the reference's ``_build_step``) resolves what
the reference resolves before tracing: the solver geometry; solver "auto"
as "pallas", the resident solver; the pair kernel (K1, or K2 where the
reference's gate picks it, ``physics_grid.use_symmetric``); the bin and
attribute caches of ``rebin_interval > 1``; position residency; the banded
boundary; whether ``step(n)`` runs the lazy-readback chunk; the cell-scan
radius (``_resolve_spatial``), whether the frame builds neighbour lists, the
per-class assembly specs (lights included when shadows are on) and the
payload channels (``_payload_plan``); the particle, decal and shadow phases
and the decal texture bank.

``device`` defaults to ``"cuda"``, which runs the CUDA kernels; ``"cpu"``
runs their plain PyTorch versions. There is no automatic choice and no
fallback: without a card, the default raises at the first allocation.

Every configuration of the reference's one-device engine runs here; the
multi-card mesh and the GSPMD step are ROADMAP items 21 and 22.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .behavior import (
    BUILTIN_PATHS,
    BatchSpawnCtx,
    EntityClass,
    FIELD_ALIASES,
    SetupCtx,
    SpawnCtx,
    _tick_fn,
    get_component,
    probe_layout_safe,
    put_component,
    read_field,
    run_logic_phase,
    snake_case,
    write_field,
)
from . import checkpoint
from .assets import SpriteRegistry
from .components import Collider, LightEmitter, MouseComponent
from .config import EngineConfig, make_config
from .debugging import Debug
from .emitter import ParticleEmitterAPI, batch_to_device
from .inputs import InputController, InputState
from .ops.culling import update_entity_visibility, update_particle_visibility
from .ops.decals import canvas_shape, default_decal_textures, stamp_decals, tile_grid_shape
from .ops.lighting import shadow_sprites, shadow_sprites_by_class
from .ops.particles import apply_emission, apply_tick_emissions, update_particles
from .ops.events import compact_rows, diff_pairs
from .ops.physics import PER_ENTITY, physics_step, record_collision_pairs, update_derived
from .ops.physics_grid import (
    bins_expired,
    layout_shape,
    resident_lazy_frame,
    resident_persistent_step,
    resident_sync_entity,
    solver_geometry,
    use_symmetric,
)
from .ops.spatial import (
    NeighborLists,
    empty_neighbor_lists,
    neighbor_lists,
    neighbor_lists_by_class,
)
from .profiling import PhaseProfiler, StepTimer, TimelineLog, span
from .render.extract import (
    RenderPacket,
    advance_animation,
    extract_render_packet,
    host_copy,
    packet_to_host,
)
from .rng import Mulberry32
from .state import EntityPool, World, make_world, scatter_fields


def apply_inputs(world: World, inputs: InputState) -> World:
    """Mouse statics -> Transform[0] / MouseComponent[0] (Mouse.js:30-104)."""

    def put0(arr, value):
        out = arr.clone()
        out[0] = value
        return out

    t, m = world.transform, world.mouse
    b = inputs.mouse_buttons
    return world.replace(
        transform=t.replace(x=put0(t.x, inputs.mouse_x), y=put0(t.y, inputs.mouse_y)),
        mouse=m.replace(
            button0_down=put0(m.button0_down, b[0]),
            button1_down=put0(m.button1_down, b[1]),
            button2_down=put0(m.button2_down, b[2]),
            is_present=put0(m.is_present, inputs.mouse_present),
        ),
    )


class Mouse(EntityClass):
    """Mouse as entity index 0 (src/core/Mouse.js): a radius-0 trigger
    collider with visualRange 150 (:139-145)."""

    components = [Collider, MouseComponent]

    @classmethod
    def setup(cls, ctx):
        return {
            "collider.radius": 0.0,
            "collider.is_trigger": True,
            "collider.visual_range": 150.0,
        }


class _RowView:
    """id -> value mapping read as ``view[i]``, so hooks written against the
    reference's direct SoA reads (``Transform.x[i]``, predator.js:94-125)
    work on a sparse participant set (engine.py:91-107)."""

    __slots__ = ("_m",)

    def __init__(self, m):
        self._m = m

    def __getitem__(self, i):
        return self._m[int(i)]

    def take(self, ids) -> np.ndarray:
        """Vector read for batch hooks: the values of an array of ids."""
        m = self._m
        return np.asarray([m[int(i)] for i in np.asarray(ids).ravel()])


class CollisionEventCtx:
    """The host context handed to collision hooks (engine.py:110-170): the
    participants' x, y and entity type, and the emitter. Mutations go
    through the control plane (``engine.emitter``, ``spawn``, ``despawn``)
    and land before the next frame."""

    def __init__(self, engine: "Engine", participant_ids: np.ndarray):
        """Read only the participants' rows from the device, in one copy."""
        self.engine = engine
        self.emitter = engine.emitter
        ids = np.unique(np.asarray(participant_ids, np.int64).ravel())
        ids = ids[ids >= 0]
        t = engine.world.transform
        idx = torch.from_numpy(ids).to(engine.device)
        xs, ys, ts = torch.stack(
            [t.x[idx], t.y[idx], t.entity_type[idx].to(torch.float32)]).cpu().numpy()
        self.x = _RowView({int(i): float(v) for i, v in zip(ids, xs)})
        self.y = _RowView({int(i): float(v) for i, v in zip(ids, ys)})
        self.entity_type = _RowView({int(i): int(v) for i, v in zip(ids, ts)})

    @classmethod
    def from_logged(cls, engine: "Engine", rows) -> "CollisionEventCtx":
        """From one frame's logged tables: ``rows`` is a list of (ids [m, 2],
        coords [m, 2, 3] (x, y, entity type)) read from a chunk's event log,
        the positions after that frame. No device read."""
        self = cls.__new__(cls)
        self.engine = engine
        self.emitter = engine.emitter
        xm: Dict[int, float] = {}
        ym: Dict[int, float] = {}
        tm: Dict[int, int] = {}
        for ids, coords in rows:
            for i, co in zip(np.asarray(ids).reshape(-1), np.asarray(coords).reshape(-1, 3)):
                i = int(i)
                if i >= 0:
                    xm[i], ym[i], tm[i] = float(co[0]), float(co[1]), int(co[2])
        self.x, self.y, self.entity_type = _RowView(xm), _RowView(ym), _RowView(tm)
        return self

    def type_of(self, index: int) -> int:
        return self.entity_type[index]


_COLLISION_HOOKS = ("on_collision_enter", "on_collision_stay", "on_collision_exit")


def _hooks(cls, hook_name: str) -> bool:
    """Whether ``cls`` defines the hook, scalar or ``_batch``."""
    return (getattr(cls, hook_name, None) is not None
            or getattr(cls, hook_name + "_batch", None) is not None)


#: the "__collision__" channel's value for a neighbour whose collider is
#: inactive (engine.py:1489); any value above -1e30 is a live collider
_NO_COLLIDER = -3.0e38


class _EventLog:
    """One chunk's device event log (engine.py:1956-2095): for each logged
    kind ``(tag, cap, width, hooked)`` of ``specs``, every frame's table
    ``[k, cap, width]`` int32, its count ``[k]`` and the participants'
    x, y and entity type after that frame ``[k, cap, width, 3]`` float32.
    All of it lives in one flat int32 tensor (the coordinates as float32
    bits), allocated once per chunk and copied to the host once, into
    pinned memory without blocking on the card; ``tables`` waits for that
    copy alone. An unhooked kind keeps a one-row placeholder whose count
    stays 0 and is never written."""

    def __init__(self, specs, k: int, device):
        self.specs, self.k, self.device = specs, k, device
        # per kind: the (offset, shape) of its ids, counts and coordinates
        self._layout = []
        size = 0
        for _tag, cap, width, _hooked in specs:
            parts = []
            for shape in ((k, cap, width), (k,), (k, cap, width, 3)):
                parts.append((size, shape))
                size += math.prod(shape)
            self._layout.append(parts)
        self.buf = torch.zeros((size,), dtype=torch.int32, device=device)
        self.views = self._unpack(self.buf, lambda a: a.view(torch.float32))
        self.host = None
        self.ready = None

    def _unpack(self, flat, as_f32):
        return [(flat[o_ids:o_ids + math.prod(s_ids)].reshape(s_ids),
                 flat[o_n:o_n + s_n[0]],
                 as_f32(flat[o_co:o_co + math.prod(s_co)]).reshape(s_co))
                for (o_ids, s_ids), (o_n, s_n), (o_co, s_co) in self._layout]

    def write(self, world: World, f: int) -> torch.Tensor:
        """Log frame ``f``'s tables; returns the rows of hooked collision
        kinds past their cap (the ``event_rows_dropped`` increment)."""
        dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        t = world.transform
        for (tag, cap, _w, hooked), (ids, counts, coords) in zip(self.specs, self.views):
            if not hooked:
                continue
            table, count = _kind_table(world, tag, cap)
            j = table.clamp(min=0).to(torch.int64)
            ids[f].copy_(table)
            counts[f].copy_(torch.clamp(count, max=cap))
            coords[f].copy_(torch.stack([t.x[j], t.y[j], t.entity_type[j].to(torch.float32)],
                                        dim=-1))
            if tag.startswith("event_"):
                # screen counts are clamped when the table is packed
                dropped = dropped + torch.clamp(count - cap, min=0)
        return dropped

    def fetch(self) -> None:
        """Start the one copy of the log to the host."""
        if self.device.type == "cuda":
            self.host = torch.empty(self.buf.shape, dtype=torch.int32, pin_memory=True)
            self.host.copy_(self.buf, non_blocking=True)
            self.ready = torch.cuda.Event()
            self.ready.record()
        else:
            self.host = self.buf

    def tables(self):
        """{tag: (ids, counts, coords)} as numpy, after the copy landed."""
        if self.ready is not None:
            self.ready.synchronize()
        flat = self.host.numpy()
        unpacked = self._unpack(flat, lambda a: a.view(np.float32))
        return {spec[0]: kind for spec, kind in zip(self.specs, unpacked)}


def _kind_table(world: World, tag: str, cap: int):
    """(ids [cap, width], count) of a logged kind (engine.py:2005-2017): a
    collision kind is named after its table in the world."""
    if tag.startswith("event_"):
        return getattr(world, tag)[:cap], getattr(world, tag + "_count")
    packed = world.screen_events_packed
    full = (packed.shape[0] - 2) // 2
    if tag == "s_enter":
        return packed[2:2 + cap, None], packed[0]
    return packed[2 + full:2 + full + cap, None], packed[1]


class FramePlan:
    """Per-frame spawns, despawns and inputs queued on the host, run by
    :meth:`Engine.run_plan` in chunks of frames (engine.py:173-279). Each
    frame applies its writes and its input snapshot, then steps.

    Slots are claimed, ``on_spawned``/``on_despawned`` hooks fire and the
    seeded stream is drawn when the plan is built, in call order, exactly as
    the immediate calls do; the world writes land when the plan runs. Usage::

        plan = eng.begin_plan()
        for f in range(60):
            plan.despawn_batch(victims(f))
            plan.spawn_batch("Ball", 256, x=..., y=...)
            eng.input.set_mouse(...)        # optional: per-frame inputs
            plan.next_frame()               # frame boundary (captures input)
        eng.run_plan(plan)

    Do not interleave immediate ``spawn``/``despawn``/``step`` calls with
    building a plan: its writes land after any immediate ones."""

    def __init__(self, engine: "Engine"):
        self.engine = engine
        # per finished frame: ({path: (int32 idx, float32 vals)}, host InputState)
        self.frames: List[Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], InputState]] = []
        self._cur: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = []
        self._cur_ops: List[Tuple[str, Any, Any]] = []

    def spawn(self, class_name: str, **spawn_config) -> Optional[int]:
        op = self.engine._spawn_op(class_name, spawn_config, auto_reconcile=False)
        if op is None:
            return None
        i, updates = op
        self._cur_ops.append(("spawn", i, updates))
        return i

    def despawn(self, index: int) -> None:
        if self.engine._despawn_op(index):
            self._cur_ops.append(("despawn", index, None))

    def spawn_batch(self, class_name: str, count: int, call_on_spawned: bool = True,
                    **field_arrays) -> np.ndarray:
        self._flush_singles()
        idx, columns = self.engine._spawn_batch_columns(
            class_name, count, call_on_spawned, field_arrays, auto_reconcile=False)
        if idx.size:
            self._cur.append({p: (idx, np.asarray(v)) for p, v in columns.items()})
        return idx

    def despawn_batch(self, indices) -> int:
        self._flush_singles()
        released, cols = self.engine._despawn_batch_columns(indices)
        if cols:
            self._cur.append({p: (i, np.zeros(i.size, np.float32)) for p, i in cols.items()})
        return released

    def _flush_singles(self) -> None:
        if self._cur_ops:
            ops, self._cur_ops = self._cur_ops, []
            self._cur.append(self.engine._ops_to_columns(ops))

    def next_frame(self) -> None:
        """Close the frame: merge its columns, the last write to an index
        winning (as ``_flush_pending``), and capture the input snapshot on
        the host."""
        self._flush_singles()
        merged: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for colset in self._cur:
            for path, (i, v) in colset.items():
                i = np.asarray(i, np.int32)
                v = np.asarray(v, np.float32)  # float32-exact, see _apply_columns
                if path in merged:
                    pi, pv = merged[path]
                    i, v = np.concatenate([pi, i]), np.concatenate([pv, v])
                merged[path] = (i, v)
        final: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for path, (i, v) in merged.items():
            if i.size > 1:
                _, last = np.unique(i[::-1], return_index=True)
                keep = np.sort(i.size - 1 - last)
                i, v = i[keep], v[keep]
            final[path] = (i, v)
        self._cur = []
        self.frames.append((final, self.engine.input.snapshot("cpu")))

    def __len__(self) -> int:
        return len(self.frames)


#: an input snapshot's float32 and bool fields, in the order a plan chunk
#: packs them (``Engine._plan_chunk_tables``)
_INPUT_F32 = ("mouse_x", "mouse_y", "camera_x", "camera_y", "camera_zoom")
_INPUT_BOOL = ("mouse_buttons", "mouse_present", "keys")


def _scatter_columns(world: World, columns) -> World:
    """Scatter {path: (int64 indices, float32 values)}, tensors on the
    world's device, into the world; each column's values are cast to its
    field's dtype on the device. No index repeats within a column."""
    for path, (idx, vals) in columns.items():
        comp_name, _, field = path.partition(".")
        comp = scatter_fields(get_component(world, comp_name), idx, {field: vals})
        world = put_component(world, comp_name, comp)
    return world


@dataclasses.dataclass
class RegisteredClass:
    cls: type
    entity_type: int
    start_index: int
    count: int
    pool: EntityPool
    component_paths: List[str]
    # spawn-reset defaults {path: value} (shared, copy-on-spawn)
    reset_template: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """What one frame needs beyond the world: resolved once per build."""

    cfg: EngineConfig
    solver_geom: Any
    type_ranges: Tuple[Tuple[type, int, int], ...]
    frame_counts: torch.Tensor
    #: the pair kernel: K2 (pair_pass_symmetric) when True, else K1
    symmetric: bool = False
    #: position residency: (tick_fn, start, count) of each ticking class
    #: evaluated in layout space, and the host-written rows pinned each frame
    residency: bool = False
    force_specs: Tuple[Tuple[Any, int, int], ...] = ()
    pin_rows: Tuple[int, ...] = ()
    #: > 0: the banded boundary, sized for this per-frame displacement
    band_vel_bound: float = 0.0
    #: neighbour lists: built each frame when a ticking class reads them;
    #: else every tick sees ``empty_nbr``
    need_neighbors: bool = False
    empty_nbr: Optional[NeighborLists] = None
    #: per-class assembly: (class name, start, count, scan radius) each
    nbr_specs: Tuple[Tuple[str, int, int, int], ...] = ()
    #: (class name, start, count) of the light classes whose per-class
    #: lists the shadow pass walks
    light_ranges: Tuple[Tuple[str, int, int], ...] = ()
    #: the particle pool's phases, the decal stamping with its texture bank,
    #: and the shadow sprites
    has_particles: bool = False
    decal_textures: Optional[torch.Tensor] = None
    shadows_on: bool = False
    #: whether ``step(n)`` may run the lazy chunk (residency, and nothing
    #: that reads entity order every frame: engine.py:1844-1851)
    lazy_chunks: bool = False
    #: payload channel of each declared per-neighbour field, and the fields
    #: of channels 3.. in order
    payload_channels: Dict[str, int] = dataclasses.field(default_factory=dict)
    extra_paths: Tuple[str, ...] = ()
    #: the hook registration the plan was built for (``_events_signature``)
    events_sig: Any = None
    #: collision events: hook-scoped recording (engine.py:1368-1387) over
    #: the (start, count) ranges of the hooked classes, with their per-class
    #: specs when the lists are assembled per class; whether every contact
    #: lies in the 3 x 3 cells around a row (``_contact_rows``)
    scope_hooked: bool = False
    hooked_ranges: Tuple[Tuple[int, int], ...] = ()
    hooked_specs: Tuple[Tuple[str, int, int, int], ...] = ()
    contact_fits: bool = False


class Engine:
    """``new GameEngine(config)`` analog. Usage::

        eng = Engine(world_width=9000, world_height=4000, seed=42,
                     physics=dict(gravity=(0, 0.5), sub_step_count=2),
                     device="cuda")
        eng.register_entity_class(Ball, 10_000)
        eng.init()
        eng.spawn("Ball", x=..., y=...)
        eng.step(60)
    """

    #: component-reset values applied on every spawn (gameObject.js:879-925)
    _SPAWN_RESETS: Dict[str, Dict[str, Any]] = {
        "rigid_body": dict(
            active=True, ax=0.0, ay=0.0, vx=0.0, vy=0.0,
            speed=0.0, velocity_angle=0.0, px=0.0, py=0.0,
        ),
        "transform": dict(x=0.0, y=0.0, rotation=0.0),
        "collider": dict(active=True),
        "light": dict(active=True),
        "shadow": dict(active=True),
        "sprite": dict(
            active=True, tint=0xFFFFFF, base_tint=0xFFFFFF, alpha=1.0,
            scale_x=1.0, scale_y=1.0, anchor_x=0.5, anchor_y=1.0,
            render_visible=True, is_on_screen=True, render_dirty=True,
        ),
    }

    def __init__(self, config: Optional[EngineConfig] = None,
                 images: Optional[Dict[str, Any]] = None,
                 sheets: Optional[Dict[str, Any]] = None, *, device="cuda", **kwargs):
        """``images``/``sheets`` mirror ``new GameEngine(config, imageUrls)``
        (gameEngine.js:21, :805-889): the assets named are loaded, packed
        into the big atlas and registered at once (:meth:`load_assets`)."""
        if config is None:
            config = make_config(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config object or kwargs, not both")
        self.config = config.validated()
        self.device = torch.device(device)
        self.rng = Mulberry32(self.config.seed)
        self.input = InputController()
        self.sprites = SpriteRegistry()
        self.emitter = ParticleEmitterAPI(self)
        # center camera on world (gameEngine.js camera init)
        self.input.camera_x = self.config.world_width / 2
        self.input.camera_y = self.config.world_height / 2

        self.classes: "OrderedDict[str, RegisteredClass]" = OrderedDict()
        # user components by snake-case name (mounted in world.custom)
        self._custom_components: Dict[str, Any] = {}
        self._next_type = 0
        self._next_index = 0
        self.world: Optional[World] = None
        self._initialized = False
        self._plan: Optional[StepPlan] = None
        self._pending_ops: List[Tuple[str, int, Any]] = []
        # largest collider radius ever written: sizes the solver geometry; a
        # larger later write forces a re-plan
        self._max_radius = 0.0
        self._solver_radius_bound = 0.0
        # largest host-written rigid_body.max_vel (the Verlet per-axis clamp;
        # <= 0 falls back to 100): sizes the banded boundary's drift bound
        self._max_vel_seen = 100.0
        self.metrics: Dict[str, torch.Tensor] = {}
        self.paused = False
        self.debug = Debug(self)
        self.timer = StepTimer()
        self.timeline = TimelineLog()
        self.profiler = PhaseProfiler(self)
        # step() blocks on the card so the timer reads device time
        self._profiling = False
        # the renderer-override channel (set_sprite_prop, call_sprite_method)
        self._sprite_overrides: Dict[int, Dict[str, Any]] = {}
        self._sprite_calls: List[Dict[str, Any]] = []
        self._sprite_call_seq = 0
        # the big atlas (render.atlas.BigAtlas) once assets load: the render
        # server and the headless renderer pick it up from here
        self.atlas = None
        # frames that step(n)'s lazy chunk ran without the entity read-back
        self.lazy_frames = 0
        # the event log of the chunk whose hooks have not fired yet
        # (logic.event_overlap): held across step() calls until the next
        # chunk is queued or a barrier flushes it
        self._pending_log: Optional[_EventLog] = None

        self.timeline.log("engine constructed")

        # Mouse registered first so entity index 0 is the mouse
        self.register_entity_class(Mouse, 1)

        if images or sheets:
            self.load_assets(images=images, sheets=sheets)

    def load_assets(
        self,
        images: Optional[Dict[str, Any]] = None,
        sheets: Optional[Dict[str, Any]] = None,
        atlas_size: int = 1024,
    ):
        """The engine-level asset preload (preloadAssets, gameEngine.js:
        805-889; engine.py:395-460) as one call: load every image and
        spritesheet, cut the sheet frames, pack everything (and the built-in
        ``_lightGradient``) into the big atlas, and register the textures
        and sheets, with their animation index spaces, on ``self.sprites``.

        ``images``: {name: png path or RGBA uint8 ``[H, W, 4]`` array}.
        ``sheets``: {name: (png path or RGBA array, TexturePacker JSON path
        or dict)}; the JSON needs "frames" ({name: {"frame": {x, y, w, h}}})
        and "animations" ({anim: [frame names]}), as
        ``tools/texture_packer.py`` writes it.

        The atlas lands on ``self.atlas`` and is returned. Callable before
        or after ``init()``; registration is idempotent, so classes may also
        register names in ``setup()``."""
        import json
        import os

        from .render.atlas import create_big_atlas, load_png

        def as_img(v):
            if isinstance(v, (str, os.PathLike)):
                return load_png(os.fspath(v))
            arr = np.asarray(v, np.uint8)
            if arr.ndim != 3 or arr.shape[2] != 4:
                raise ValueError("images must be RGBA uint8 [H, W, 4]")
            return arr

        imgs = {name: as_img(v) for name, v in (images or {}).items()}
        sh = {}
        for name, (img, meta) in (sheets or {}).items():
            if isinstance(meta, (str, os.PathLike)):
                with open(os.fspath(meta)) as f:
                    meta = json.load(f)
            sh[name] = (as_img(img), meta)
        self.atlas = create_big_atlas(imgs, sh, size=atlas_size, registry=self.sprites)
        return self.atlas

    # ------------------------------------------------------------------
    # registration (gameEngine.js:292-366, :389-457)
    # ------------------------------------------------------------------
    def register_entity_class(self, cls: type, count: int) -> None:
        if self._initialized:
            raise RuntimeError("register_entity_class must precede init()")
        if not issubclass(cls, EntityClass):
            raise TypeError(f"{cls.__name__} must subclass EntityClass")
        for parent in cls.__mro__[1:]:
            if parent is EntityClass or not issubclass(parent, EntityClass):
                break
            if parent.__name__ not in self.classes:
                self._register_one(parent, 0)
        if cls.__name__ in self.classes:
            reg = self.classes[cls.__name__]
            if reg.count == 0 and count > 0:
                # was auto-registered as a parent; give it its real range
                reg.start_index = self._next_index
                reg.count = count
                reg.pool = EntityPool(self._next_index, count)
                reg.cls.start_index = reg.start_index
                reg.cls.count = count
                self._next_index += count
                return
            raise ValueError(f"{cls.__name__} already registered")
        self._register_one(cls, count)

    def _register_one(self, cls: type, count: int) -> None:
        paths = []
        for comp in cls.collect_components():
            if comp in BUILTIN_PATHS:
                paths.append(BUILTIN_PATHS[comp])
                continue
            if not hasattr(comp, "SCHEMA"):
                raise TypeError(f"{cls.__name__}: component {comp!r} is not a built-in "
                                "and was not made by define_component")
            name = snake_case(comp.__name__)
            existing = self._custom_components.get(name)
            if existing is not None and existing is not comp:
                raise ValueError(f"conflicting custom component name {name!r}")
            self._custom_components[name] = comp
            paths.append(name)
        template = {
            f"{comp_path}.{field}": value
            for comp_path in paths
            for field, value in self._SPAWN_RESETS.get(comp_path, {}).items()
        }
        reg = RegisteredClass(
            cls=cls,
            entity_type=self._next_type,
            start_index=self._next_index,
            count=count,
            pool=EntityPool(self._next_index, count),
            component_paths=paths,
            reset_template=template,
        )
        cls.entity_type = reg.entity_type
        cls.start_index = reg.start_index
        cls.count = count
        self.classes[cls.__name__] = reg
        self._next_type += 1
        self._next_index += count

    @property
    def entity_count(self) -> int:
        return self._next_index

    # ------------------------------------------------------------------
    # init (gameEngine.js:460-499)
    # ------------------------------------------------------------------
    def init(self) -> None:
        if self._initialized:
            raise RuntimeError("already initialized")
        n = max(1, self.entity_count)
        cfg = self.config
        decals = cfg.particle.decals and cfg.particle.max_particles > 0
        lc, lg = cfg.lighting, cfg.logic
        world = make_world(
            n, self.device, self._custom_components,
            max_particles=cfg.particle.max_particles,
            decal_canvas_shape=canvas_shape(cfg) if decals else None,
            decal_tile_shape=tile_grid_shape(cfg) if decals else None,
            n_shadow_sprites=(lc.max_shadow_casting_lights * lc.max_shadows_per_light
                              if lc.enabled and lc.shadows_enabled else 0),
            max_collision_pairs=cfg.physics.max_collision_pairs if lg.collision_events else 0,
            n_screen_events=lg.max_screen_events if lg.screen_events else 0,
        )
        # grid-solver bin cache (physics.rebin_interval): installed at init,
        # stamp -1 = never binned
        if self.config.physics.rebin_interval > 1:
            world = world.replace(
                solver_flat=torch.zeros((n,), dtype=torch.int64, device=self.device),
                solver_in_grid=torch.zeros((n,), dtype=torch.bool, device=self.device),
                solver_bin_step=-1,
            )
        # entityType for every slot, active or not (gameEngine.js:778-791)
        et = np.zeros((n,), np.int32)
        for reg in self.classes.values():
            et[reg.start_index : reg.start_index + reg.count] = reg.entity_type
        world = world.replace(
            transform=world.transform.replace(entity_type=torch.from_numpy(et).to(self.device))
        )
        # setup() once per class range
        for reg in self.classes.values():
            if reg.count == 0:
                continue
            ctx = SetupCtx(self.config, reg.start_index, reg.count, self.rng, self.sprites)
            updates = reg.cls.setup(ctx) or {}
            self._track_radius(updates)
            for path, value in updates.items():
                arr = read_field(world, path).clone()
                value = torch.as_tensor(np.asarray(value), device=self.device).to(arr.dtype)
                arr[reg.start_index : reg.start_index + reg.count] = value
                world = write_field(world, path, arr)
        self.world = world
        self._initialized = True
        self.spawn("Mouse")

    # ------------------------------------------------------------------
    # spawn / despawn control plane
    # ------------------------------------------------------------------
    def spawn(self, class_name: str, **spawn_config) -> Optional[int]:
        """GameObject.spawn (gameObject.js:840-951): pop the free list, reset
        the component slots, apply the spawn config and ``on_spawned``, sync
        Verlet px/py, set active. The writes land before the next step.
        Returns the entity index, or None when the pool is exhausted."""
        op = self._spawn_op(class_name, spawn_config)
        if op is None:
            return None
        i, updates = op
        self._pending_ops.append(("spawn", i, updates))
        return i

    def _spawn_op(self, class_name: str, spawn_config: Dict[str, Any],
                  auto_reconcile: bool = True) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Claim a slot and build its spawn writes: the half of ``spawn``
        that :class:`FramePlan` shares (engine.py:615-665).
        ``auto_reconcile=False`` (a plan) skips the retry after a reconcile:
        the device does not show the earlier plan frames' spawns yet, so a
        reconcile would hand their slots out again."""
        self._require_init()
        reg = self.classes[class_name]
        i = reg.pool.claim()
        if i is None and auto_reconcile and self.reconcile_pools():
            i = reg.pool.claim()
        if i is None:
            self.timeline.log(f"pool exhausted: no inactive {class_name} available "
                              f"(all {reg.count} active)")
            return None

        updates: Dict[str, Any] = dict(reg.reset_template)
        for key, value in spawn_config.items():
            path = FIELD_ALIASES.get(key, key)
            if "." not in path:
                raise KeyError(f"unknown spawn property {key!r}")
            updates[path] = value
        extra = reg.cls.on_spawned(SpawnCtx(self.config, i, self.rng, self.sprites),
                                   dict(spawn_config)) or {}
        for key, value in extra.items():
            updates[FIELD_ALIASES.get(key, key)] = value
        # Verlet previous-position sync: px = x - vx (gameObject.js:938-940)
        if "rigid_body" in reg.component_paths:
            updates["rigid_body.px"] = float(updates.get("transform.x", 0.0)) - float(
                updates.get("rigid_body.vx", 0.0)
            )
            updates["rigid_body.py"] = float(updates.get("transform.y", 0.0)) - float(
                updates.get("rigid_body.vy", 0.0)
            )
        updates["transform.active"] = True
        # the solver bounds see a queued spawn at once (engine.py:664)
        self._track_radius(updates)
        return i, updates

    def spawn_batch(
        self, class_name: str, count: int, call_on_spawned: bool = True,
        **field_arrays,
    ) -> np.ndarray:
        """Bulk spawn: claims ``count`` slots and applies resets and
        per-field arrays (scalars or [count] arrays keyed like spawn config)
        in one set of scatters. ``on_spawned_batch`` (or ``on_spawned`` per
        entity) runs unless ``call_on_spawned=False``. Returns the claimed
        indices (fewer than requested on exhaustion)."""
        self._require_init()
        self._flush_pending()
        idx, columns = self._spawn_batch_columns(class_name, count, call_on_spawned,
                                                 field_arrays)
        if idx.size:
            self.world = self._apply_columns(
                self.world, {path: (idx, vals) for path, vals in columns.items()})
        return idx

    def _spawn_batch_columns(
        self, class_name: str, count: int, call_on_spawned: bool,
        field_arrays: Dict[str, Any], auto_reconcile: bool = True,
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Claim up to ``count`` slots and build their columns of writes:
        the half of ``spawn_batch`` that :class:`FramePlan` shares
        (engine.py:717-813). Returns (claimed indices, {path: [n] values})."""
        reg = self.classes[class_name]
        claimed = reg.pool.claim_many(count)
        if claimed.size < count and auto_reconcile and self.reconcile_pools(exclude=claimed):
            claimed = np.concatenate([claimed, reg.pool.claim_many(count - claimed.size)])
        n = int(claimed.size)
        if n < count:
            self.timeline.log(f"pool exhausted during spawn_batch({class_name}): "
                              f"claimed {n} of {count}")
        if n == 0:
            return np.empty((0,), np.int32), {}
        idx = claimed.astype(np.int32)
        columns: Dict[str, np.ndarray] = {}

        def put(path: str, value) -> None:
            arr = np.asarray(value)
            columns[path] = np.broadcast_to(arr, (n,)).copy() if arr.ndim == 0 else arr[:n]

        for path, value in reg.reset_template.items():
            put(path, value)
        for key, value in field_arrays.items():
            path = FIELD_ALIASES.get(key, key)
            if "." not in path:
                raise KeyError(f"unknown spawn property {key!r}")
            put(path, value)

        batch_hook = getattr(reg.cls, "on_spawned_batch", None)
        if call_on_spawned and batch_hook is not None:
            cfg_arrays = {
                key: (np.asarray(v)[:n] if np.asarray(v).ndim > 0
                      else np.broadcast_to(np.asarray(v), (n,)))
                for key, v in field_arrays.items()
            }
            out = batch_hook(BatchSpawnCtx(self.config, idx, self.rng, self.sprites),
                             cfg_arrays) or {}
            for key, v in out.items():
                put(FIELD_ALIASES.get(key, key), np.asarray(v))
        elif call_on_spawned and (
            reg.cls.on_spawned.__func__ is not EntityClass.on_spawned.__func__
        ):
            extra_cols: Dict[str, list] = {}
            for k in range(n):
                cfg_k = {
                    key: (np.asarray(v).item() if np.asarray(v).ndim == 0 else v[k])
                    for key, v in field_arrays.items()
                }
                ctx = SpawnCtx(self.config, int(idx[k]), self.rng, self.sprites)
                for key, v in (reg.cls.on_spawned(ctx, cfg_k) or {}).items():
                    extra_cols.setdefault(FIELD_ALIASES.get(key, key), [None] * n)[k] = v
            for path, vals in extra_cols.items():
                base = columns.get(path)
                columns[path] = np.asarray(
                    [v if v is not None else (base[k] if base is not None else 0)
                     for k, v in enumerate(vals)]
                )
        if "rigid_body" in reg.component_paths:
            x = columns.get("transform.x", np.zeros(n))
            y = columns.get("transform.y", np.zeros(n))
            vx = columns.get("rigid_body.vx", np.zeros(n))
            vy = columns.get("rigid_body.vy", np.zeros(n))
            columns["rigid_body.px"] = np.asarray(x, np.float64) - np.asarray(vx, np.float64)
            columns["rigid_body.py"] = np.asarray(y, np.float64) - np.asarray(vy, np.float64)
        columns["transform.active"] = np.ones(n, bool)
        self._track_radius(columns)
        return idx, columns

    def despawn(self, index: int) -> None:
        """Despawn by index (gameObject.js:668-691); a no-op on an index that
        is already free (the reference's double-despawn guard)."""
        if self._despawn_op(index):
            self._pending_ops.append(("despawn", index, None))

    def _despawn_op(self, index: int) -> bool:
        """Release the slot and fire ``on_despawned``: the half of
        ``despawn`` that :class:`FramePlan` shares (engine.py:823-831)."""
        self._require_init()
        reg = self._class_of_index(index)
        if not reg.pool.release(index):
            return False
        reg.cls.on_despawned(index)
        return True

    def despawn_batch(self, indices) -> int:
        """Despawn many indices at once (engine.py:833-852): the pools
        release them and the active flags clear in one set of scatters,
        with ``despawn``'s double-despawn guard applied setwise and
        ``on_despawned`` per entity when a class overrides it. Returns how
        many were released. The free lists end as after the same despawns
        issued one by one: duplicates count at their first occurrence and
        each pool takes its indices in the caller's order."""
        self._require_init()
        self._flush_pending()
        released, cols = self._despawn_batch_columns(indices)
        if cols:
            self.world = self._apply_columns(self.world, {
                path: (idx, np.zeros(idx.size, np.float32)) for path, idx in cols.items()})
        return released

    def _despawn_batch_columns(self, indices) -> Tuple[int, Dict[str, np.ndarray]]:
        """Release the slots, fire the hooks and return the active-flag
        columns to clear {path: indices}: the half of ``despawn_batch`` that
        :class:`FramePlan` shares (engine.py:854-896)."""
        idxs = np.asarray(indices, np.int64).reshape(-1)
        if idxs.size > 1:
            _, first = np.unique(idxs, return_index=True)
            idxs = idxs[np.sort(first)]
        cols: Dict[str, List[np.ndarray]] = {}
        released = 0
        for reg in self.classes.values():
            if reg.count == 0:
                continue
            in_range = idxs[(idxs >= reg.start_index) & (idxs < reg.start_index + reg.count)]
            fresh = np.asarray([i for i in in_range if not reg.pool.is_free(int(i))], np.int64)
            if fresh.size == 0:
                continue
            reg.pool.release_many(fresh)
            released += int(fresh.size)
            self._despawn_hooks(reg, fresh)
            self._active_columns(reg, fresh, cols)
        return released, {path: np.concatenate(parts).astype(np.int32)
                          for path, parts in cols.items()}

    @staticmethod
    def _despawn_hooks(reg: RegisteredClass, idxs: np.ndarray) -> None:
        if reg.cls.on_despawned.__func__ is not EntityClass.on_despawned.__func__:
            for i in idxs:
                reg.cls.on_despawned(int(i))

    def _active_paths(self, reg: RegisteredClass) -> List[str]:
        """The active flags a despawn of ``reg`` clears: the transform's and
        every one of its components that has one."""
        return ["transform.active"] + [
            f"{comp_path}.active" for comp_path in reg.component_paths
            if hasattr(get_component(self.world, comp_path), "active")]

    def _active_columns(self, reg: RegisteredClass, idxs: np.ndarray,
                        cols: Dict[str, List[np.ndarray]]) -> None:
        """Add ``idxs`` to the active-flag columns of ``reg``."""
        for path in self._active_paths(reg):
            cols.setdefault(path, []).append(idxs)

    def active_indices(self, class_name: str) -> np.ndarray:
        """The claimed indices of a class, ascending (the host pool's view;
        in-step despawns need :meth:`reconcile_pools` first)."""
        self._require_init()
        self._flush_pending()
        return self.classes[class_name].pool.active_indices()

    def despawn_all(self, class_name: Optional[str] = None) -> None:
        """despawnAllEntities (gameEngine.js:1677, logic_worker.js:654-711),
        of one class or of all: the mouse (index 0) is never despawned.
        The pools release in bulk and the flags clear in one scatter per
        component (engine.py:905-944)."""
        self._require_init()
        self._flush_pending()
        regs = [self.classes[class_name]] if class_name else list(self.classes.values())
        active = self.world.transform.active.cpu().numpy()
        cols: Dict[str, List[np.ndarray]] = {}
        for reg in regs:
            if reg.cls is Mouse or reg.count == 0:
                continue
            sl = slice(reg.start_index, reg.start_index + reg.count)
            idxs = np.nonzero(active[sl])[0] + reg.start_index
            if idxs.size == 0:
                continue
            reg.pool.release_many(idxs)
            self._despawn_hooks(reg, idxs)
            self._active_columns(reg, idxs, cols)
        if cols:
            self.world = self._apply_columns(self.world, {
                path: (np.concatenate(parts).astype(np.int32),
                       np.zeros(sum(p.size for p in parts), np.float32))
                for path, parts in cols.items()})

    def _class_of_index(self, index: int) -> RegisteredClass:
        for reg in self.classes.values():
            if reg.start_index <= index < reg.start_index + reg.count:
                return reg
        raise IndexError(index)

    def reconcile_pools(self, exclude=None) -> int:
        """Sync host free lists with in-step despawns (ticks returning
        ``{"despawn": True}``). Returns the number of reclaimed slots.
        ``exclude``: indices claimed by an in-flight spawn batch."""
        self._require_init()
        self._flush_pending()
        active = self.world.transform.active.cpu().numpy()
        if exclude is not None and len(exclude):
            active[np.asarray(exclude, np.int64)] = True
        reclaimed = 0
        for reg in self.classes.values():
            if reg.count == 0:
                continue
            sl = slice(reg.start_index, reg.start_index + reg.count)
            before = reg.pool.free_count
            reg.pool.release_many(np.nonzero(~active[sl])[0] + reg.start_index)
            reclaimed += reg.pool.free_count - before
        return reclaimed

    def get_pool_stats(self, class_name: str) -> Dict[str, int]:
        """getPoolStats (gameObject.js:957-999)."""
        reg = self.classes[class_name]
        return {"total": reg.count, "active": reg.pool.active_count,
                "available": reg.pool.free_count}

    def _flush_pending(self) -> None:
        """Apply queued spawn/despawn writes, after the hooks of a held event
        chunk fire (engine.py:991-1000)."""
        self._flush_event_log()
        if not self._pending_ops:
            return
        ops, self._pending_ops = self._pending_ops, []
        self.world = self._apply_columns(self.world, self._ops_to_columns(ops))

    def _flush_emissions(self) -> None:
        """Land the emitter's queue in the particle pool (engine.py:
        1109-1122): first-fit claims, the excess past the free slots
        dropped."""
        batch, n = self.emitter.build_batch()
        if batch is None:
            return
        pool, _spawned = apply_emission(self.world.particles,
                                        batch_to_device(batch, self.device), n)
        self.world = self.world.replace(particles=pool)

    def _despawn_updates(self, index: int) -> Dict[str, Any]:
        """Per-component active-flag clears for one despawned index."""
        return {path: False for path in self._active_paths(self._class_of_index(index))}

    def _ops_to_columns(self, ops) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Pending ops -> scatter columns {path: (idx, vals)}, deduped to
        the LAST write per index."""
        by_path: Dict[str, Tuple[List[int], List[Any]]] = {}
        for op, idx, updates in ops:
            if op == "despawn":
                updates = self._despawn_updates(idx)
            for path, value in updates.items():
                idxs, vals = by_path.setdefault(path, ([], []))
                idxs.append(idx)
                vals.append(value)
        deduped = {}
        for path, (idxs, vals) in by_path.items():
            np_idx = np.asarray(idxs, np.int32)
            np_vals = np.asarray(vals)
            if np_vals.dtype == object:
                np_vals = np_vals.astype(np.float64)
            if len(np_idx) > 1:
                _, last = np.unique(np_idx[::-1], return_index=True)
                keep = np.sort(len(np_idx) - 1 - last)
                np_idx, np_vals = np_idx[keep], np_vals[keep]
            deduped[path] = (np_idx, np_vals)
        return deduped

    def _apply_columns(self, world: World, columns) -> World:
        """Scatter {path: (indices, values)} into the world. Values travel as
        float32, as in the reference (every value the control plane writes is
        float32-exact), and are cast to the field's dtype on the device."""
        for path in ("collider.radius", "rigid_body.max_vel"):
            if path in columns:
                self._track_radius({path: columns[path][1]})
        world = _scatter_columns(world, {
            path: (torch.from_numpy(np.asarray(np_idx, np.int64)).to(self.device),
                   torch.from_numpy(np.asarray(np_vals).astype(np.float32)).to(self.device))
            for path, (np_idx, np_vals) in columns.items()})
        # host writes invalidate the solver's bin cache: the next frame
        # re-bins, so despawns drop out of the pair search at once and
        # spawns collide from their first frame (engine.py:1093-1102)
        if columns and world.solver_bin_step is not None:
            world = world.replace(solver_bin_step=-1)
        return world

    def _track_radius(self, updates: Dict[str, Any]) -> None:
        r = updates.get("collider.radius")
        if r is not None:
            r = float(np.max(np.asarray(r)))
            if r > self._max_radius:
                self._max_radius = r
                if self._plan is not None and r > self._solver_radius_bound:
                    self._plan = None  # re-derive the solver geometry
        v = updates.get("rigid_body.max_vel")
        if v is not None:
            v = float(np.max(np.asarray(v)))
            if v > self._max_vel_seen:
                self._max_vel_seen = v
                if (self._plan is not None and self._plan.band_vel_bound > 0.0
                        and v > self._plan.band_vel_bound):
                    self._plan = None  # re-derive the boundary band

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _resolve_spatial(self) -> EngineConfig:
        """The static cell-scan radius from the registered visual ranges
        when ``spatial.max_cell_radius`` is 0 (engine.py:1127-1142). The
        mouse (entity 0, range 150) is left out: only the debug overlay
        reads its range. May update self.config."""
        cfg = self.config
        if cfg.spatial.max_cell_radius > 0:
            return cfg
        vr = float(self.world.collider.visual_range[1:].max()) if self.entity_count > 1 else 0.0
        radius = max(1, math.ceil(vr / cfg.spatial.cell_size)) if vr > 0 else 1
        cfg = dataclasses.replace(
            cfg, spatial=dataclasses.replace(cfg.spatial, max_cell_radius=radius))
        self.config = cfg
        return cfg

    def _payload_plan(self, cfg: EngineConfig):
        """The union of the ticking classes' declared per-neighbour fields:
        they ride the neighbour table as channels 3.. after id, x and y,
        and with collision events the packed ``"__collision__"`` channel
        that pair recording reads (engine.py:1144-1167).
        Returns (payload_channels, extra_paths)."""
        declared: List[str] = []
        for reg in self.classes.values():
            if reg.count > 0:
                for p in getattr(reg.cls, "neighbor_fields", ()):
                    p = FIELD_ALIASES.get(p, p)
                    if p not in declared:
                        declared.append(p)
        if cfg.logic.collision_events and "__collision__" not in declared:
            declared.append("__collision__")
        payload_channels = {"transform.x": 1, "transform.y": 2}
        extra_paths = [p for p in declared if p not in payload_channels]
        for k, p in enumerate(extra_paths):
            payload_channels[p] = 3 + k
        return payload_channels, tuple(extra_paths)

    def _ticks_read_neighbors(self) -> bool:
        """Whether a registered class ticks and reads its neighbour lists
        (engine.py:1248-1260; shadows and collision events are the frame's
        other reasons to build lists, the neighbour-list solver being
        refused)."""
        return any(reg.count > 0 and _tick_fn(reg.cls) is not None and reg.cls.uses_neighbors
                   for reg in self.classes.values())

    def _neighbor_specs(self, cfg: EngineConfig, shadows_on: bool, scope_hooked: bool):
        """Per-class assembly (engine.py:1396-1438): each class that ticks on
        its neighbours, with shadows each class that declares LightEmitter,
        and with hook-scoped recording each hooked class, scans ceil(its
        largest visual range / cell) cells, capped at the global radius.
        Returns (specs, light ranges, hooked specs)."""
        vr = self.world.collider.visual_range.cpu().numpy()
        specs, lights, hooked = [], [], []
        for reg in self.classes.values():
            if reg.count == 0:
                continue
            ticks_nbr = _tick_fn(reg.cls) is not None and reg.cls.uses_neighbors
            is_light = shadows_on and LightEmitter in reg.cls.collect_components()
            is_hooked = scope_hooked and self._class_has_hooks(reg.cls)
            if not (ticks_nbr or is_light or is_hooked):
                continue
            s, c = reg.start_index, reg.count
            vr_c = float(vr[s:s + c].max())
            r_c = max(1, math.ceil(vr_c / cfg.spatial.cell_size)) if vr_c > 0 else 1
            spec = (reg.cls.__name__, s, c, min(r_c, max(1, cfg.spatial.max_cell_radius)))
            specs.append(spec)
            if is_light:
                lights.append((reg.cls.__name__, s, c))
            if is_hooked:
                hooked.append(spec)
        return tuple(specs), tuple(lights), tuple(hooked)

    def _solver_plan(self, cfg: EngineConfig):
        """The grid solver's geometry from the registered radii, and solver
        "auto" resolved as "pallas" (the reference's choice on its
        accelerator; engine.py:1169-1204). Returns (cfg, geometry or None,
        forced): None and True when no radius is known, where the reference
        falls back to its neighbour-list solver. May update self.config."""
        radii = self.world.collider.radius.cpu().numpy()
        r_world = float(radii.max()) if radii.size else 0.0
        max_r = max(self._max_radius, r_world)
        if max_r <= 0:
            return cfg, None, True
        present = radii[radii > 0]
        mean_r = float(present.mean()) if present.size else max_r
        self._solver_radius_bound = max_r
        if cfg.physics.solver == "auto":
            cfg = dataclasses.replace(
                cfg, physics=dataclasses.replace(cfg.physics, solver="pallas"))
            self.config = cfg
        return cfg, solver_geometry(cfg, max_r, mean_radius=mean_r), False

    def _frame_counts(self) -> torch.Tensor:
        """Per-(sheet, animation) frame counts for the animation advance,
        int32 ``[sheets + 1, most animations]`` from the sprite registry
        (engine.py:1206-1218); row 0 (no sheet) and unused entries are 1."""
        sheets = self.sprites.sheets
        fc = np.ones((len(sheets) + 1, max([1] + [len(s.animations) for s in sheets])), np.int32)
        for sheet in sheets:
            fc[sheet.sheet_id, :len(sheet.frame_counts)] = sheet.frame_counts
        return torch.from_numpy(fc).to(self.device)

    def _residency_specs(self, cfg: EngineConfig):
        """The ticking classes' (tick_fn, start, count) when every tick is
        layout-safe, else None (engine.py:1301-1325). Raises ValueError for
        an unsafe tick under ``position_residency="on"``."""
        specs = []
        for reg in self.classes.values():
            if reg.count == 0 or getattr(reg.cls, "tick", None) is None:
                continue
            if not probe_layout_safe(reg.cls, cfg):
                if cfg.physics.position_residency == "on":
                    raise ValueError(
                        "physics.position_residency='on' but "
                        f"{reg.cls.__name__}.tick is not layout-safe (it reads "
                        "beyond self x/y/ax/ay + inputs, or writes beyond "
                        "rigid_body.ax/ay)"
                    )
                return None
            specs.append((_tick_fn(reg.cls), reg.start_index, reg.count))
        return tuple(specs)

    def _build_plan(self) -> StepPlan:
        """What the reference's ``_build_step`` resolves before tracing
        (engine.py:1169-1354): the geometry; solver "auto" as "pallas" (the
        resident solver, as the reference picks it on its accelerator); the
        pair kernel; the solver caches, installed at the layout's shape with
        their stamps reset so the next frame rebins; residency; the band;
        the neighbour lists and the scope of pair recording. A held event
        chunk's hooks fire first."""
        self._flush_event_log()
        cfg = self._resolve_spatial()
        # the neighbour-list solver runs for solver "neighbors" and for a
        # scene with no collider radius (engine.py:1244-1264)
        use_grid = cfg.physics.solver in ("auto", "grid", "pallas")
        geom, forced = None, False
        if use_grid:
            cfg, geom, forced = self._solver_plan(cfg)
        ph = cfg.physics
        dev = self.device
        n = self.world.n_entities
        w = self.world
        if ph.rebin_interval > 1:
            if w.solver_flat is None:
                w = w.replace(
                    solver_flat=torch.zeros((n,), dtype=torch.int64, device=dev),
                    solver_in_grid=torch.zeros((n,), dtype=torch.bool, device=dev),
                )
            w = w.replace(solver_bin_step=-1)
        shape = layout_shape(geom) if geom is not None else None
        pallas = ph.solver == "pallas" and geom is not None

        def layouts(dtype, names):
            return {k: torch.zeros(shape, dtype=dtype, device=dev) for k in names}

        # the static-attribute layout cache rides the bin cache
        if ph.rebin_interval > 1 and pallas and (
                w.solver_grad is None or tuple(w.solver_grad.shape) != shape):
            w = w.replace(**layouts(torch.float32, ("solver_grad",)),
                          **layouts(torch.int32, ("solver_meta",)))

        specs = None
        if ph.position_residency != "off" and pallas and ph.rebin_interval > 1:
            specs = self._residency_specs(cfg)
        pin_rows: Tuple[int, ...] = ()
        if specs is not None:
            if "Mouse" in self.classes and self.classes["Mouse"].count > 0:
                pin_rows = (0,)  # apply_inputs writes entity 0 every frame
            if w.solver_x is None or tuple(w.solver_x.shape) != shape:
                w = w.replace(**layouts(torch.float32, (
                    "solver_x", "solver_y", "solver_px", "solver_py", "solver_maxv")))
            w = w.replace(solver_pos_step=-1)
        self.world = w
        residency = specs is not None
        shadows_on = cfg.lighting.enabled and cfg.lighting.shadows_enabled
        lg = cfg.logic
        # shadow sprites walk each light's neighbour list, pair recording
        # reads every row's (engine.py:1249-1253)
        need_neighbors = (self._ticks_read_neighbors() or shadows_on or lg.collision_events
                          or not use_grid or forced)
        # hook-scoped recording: only the hooked classes' rows record
        # pairs (cfg.logic.record_all_pairs; engine.py:1368-1387)
        hooked_ranges = tuple((reg.start_index, reg.count) for reg in self.classes.values()
                              if reg.count > 0 and self._class_has_hooks(reg.cls))
        scope_hooked = lg.collision_events and not lg.record_all_pairs and bool(hooked_ranges)
        nbr_specs, light_ranges, hooked_specs = (), (), ()
        if (need_neighbors and cfg.spatial.per_class_assembly and geom is not None
                and cfg.spatial.method != "bruteforce"
                and (not lg.collision_events or scope_hooked)):
            nbr_specs, light_ranges, hooked_specs = self._neighbor_specs(
                cfg, shadows_on, scope_hooked)
        has_particles = cfg.particle.max_particles > 0
        decals_on = has_particles and cfg.particle.decals
        payload_channels, extra_paths = self._payload_plan(cfg)
        return StepPlan(
            cfg=cfg,
            solver_geom=geom,
            type_ranges=tuple(
                (reg.cls, reg.start_index, reg.count)
                for reg in self.classes.values() if reg.count > 0
            ),
            frame_counts=self._frame_counts(),
            symmetric=geom is not None and use_symmetric(cfg, geom),
            residency=residency,
            force_specs=specs or (),
            pin_rows=pin_rows,
            # the Verlet clamp bounds per-frame drift; a later host write of
            # a larger max_vel re-plans (_track_radius)
            band_vel_bound=(max(100.0, self._max_vel_seen)
                            if residency and ph.boundary_band == "auto" else 0.0),
            need_neighbors=need_neighbors,
            empty_nbr=None if need_neighbors else empty_neighbor_lists(n, dev),
            nbr_specs=nbr_specs,
            light_ranges=light_ranges,
            payload_channels=payload_channels,
            extra_paths=extra_paths,
            has_particles=has_particles,
            decal_textures=(default_decal_textures(len(self.sprites.textures), dev)
                            if decals_on else None),
            shadows_on=shadows_on,
            lazy_chunks=residency and not (need_neighbors or has_particles or lg.screen_events),
            events_sig=self._events_signature(),
            scope_hooked=scope_hooked,
            hooked_ranges=hooked_ranges,
            hooked_specs=hooked_specs,
            # a contact is closer than 2 r_max (engine.py:1559-1563)
            contact_fits=(2.0 * max(self._max_radius, self._solver_radius_bound)
                          <= cfg.spatial.cell_size),
        )

    def _one_step(self, world: World, inputs: InputState, residency: Optional[bool] = None
                  ) -> Tuple[World, Dict[str, torch.Tensor]]:
        """One full frame. ``residency=False`` runs a resident plan's frame
        through the entity-order solver (a dense plan chunk, engine.py:
        1463-1469); the next resident frame finds its layout stale and
        rebuilds it."""
        plan = self._plan
        if residency is None:
            residency = plan.residency
        cfg = plan.cfg
        world = apply_inputs(world, inputs)
        if plan.need_neighbors:  # the frame's neighbour block (engine.py:1472-1518)
            with span("ops.spatial"):
                t, c = world.transform, world.collider
                extras = tuple(self._collision_channel(world) if p == "__collision__"
                               else read_field(world, p) for p in plan.extra_paths)
                if plan.nbr_specs:
                    nbr, n_binned = neighbor_lists_by_class(
                        t.x, t.y, t.active, c.visual_range, cfg, extras, plan.nbr_specs)
                    accepted = torch.sum(torch.cat([lists.count for lists in nbr.values()]),
                                         dtype=torch.int32)
                else:
                    nbr = neighbor_lists(t.x, t.y, t.active, c.visual_range, cfg, extras)
                    n_binned = nbr.n_binned
                    accepted = torch.sum(nbr.count, dtype=torch.int32)
        else:
            nbr = plan.empty_nbr
            n_binned = accepted = nbr.n_binned
        with span("behavior"):
            world, emissions = run_logic_phase(world, nbr, inputs, cfg, plan.type_ranges,
                                               plan.payload_channels)
        if plan.shadows_on:  # the shadow pass reads the lights' ids and d2
            if plan.nbr_specs:
                light_nbr = [(s, c, nbr[name]) for name, s, c in plan.light_ranges]
            else:
                light_nbr = nbr.replace(payload=None)
        if cfg.logic.collision_events:  # what pair recording reads of the lists
            with span("ops.events"):
                contact_rows = self._contact_rows(nbr)
        # the neighbour-list solver reads the global lists (engine.py:
        # 1536-1543); otherwise the candidate rows (288 MB on boids_15k) go
        # before the solver runs
        solver_nbr = nbr if plan.solver_geom is None else None
        del nbr
        with span("render.animation"):
            world = advance_animation(world, plan.frame_counts, cfg.dt_ratio)
        with span("ops.physics"):
            if residency:
                world, _n_binned, solver_overflow, band_drift = resident_persistent_step(
                    world, cfg, plan.solver_geom, inputs, plan.force_specs,
                    cfg.dt_ratio, plan.pin_rows, plan.band_vel_bound,
                )
                world = update_derived(world, cfg)
            else:
                world, solver_overflow = physics_step(world, cfg, cfg.dt_ratio,
                                                      plan.solver_geom, solver_nbr)
                band_drift = torch.zeros((), dtype=torch.int32, device=self.device)
        if cfg.logic.collision_events:
            # contact pairs from the frame-start lists, the one-frame-stale
            # set the reference's logic workers read (logic_worker.js:429-443),
            # then the Enter/Stay/Exit difference against the last frame's
            with span("ops.events"):
                world, pairs_dropped = self._record_pairs(world, *contact_rows)
                enter, n_e, stay, n_s, exit_, n_x = diff_pairs(
                    world.collision_pairs, world.collision_pair_count,
                    world.prev_collision_pairs, world.prev_collision_pair_count)
                world = world.replace(
                    prev_collision_pairs=world.collision_pairs,
                    prev_collision_pair_count=world.collision_pair_count,
                    event_enter=enter, event_enter_count=n_e, event_stay=stay,
                    event_stay_count=n_s, event_exit=exit_, event_exit_count=n_x)
        p_active = torch.full((), -1, dtype=torch.int32, device=self.device)
        if plan.has_particles:  # the particle worker's phases (engine.py:1714-1741)
            with span("ops.particles"):
                pool, stamps, p_active = update_particles(
                    world.particles, cfg, cfg.dt_ratio, plan.decal_textures is not None)
                world = world.replace(particles=pool)
                if plan.decal_textures is not None:
                    with span("ops.decals"):
                        canvas, dirty = stamp_decals(world.decal_canvas, world.decal_dirty,
                                                     stamps, plan.decal_textures, cfg)
                    world = world.replace(decal_canvas=canvas, decal_dirty=dirty)
                # tick emissions land after this frame's pool update: new
                # particles first move next frame
                if emissions and cfg.particle.max_emit_per_step > 0:
                    pool, spawned = apply_tick_emissions(world.particles, emissions,
                                                         cfg.particle.max_emit_per_step)
                    world = world.replace(particles=pool)
                    p_active = p_active + spawned
                world = update_particle_visibility(world, cfg, inputs)
        with span("ops.culling"):
            world = update_entity_visibility(world, cfg, inputs)
            if cfg.logic.screen_events:  # onScreen Enter/Exit (engine.py:1751-1776)
                cur = world.sprite.is_on_screen & world.transform.active
                prev = world.prev_onscreen
                cap_s = cfg.logic.max_screen_events
                gid = torch.arange(world.n_entities, dtype=torch.int32, device=self.device)

                def compact_ids(mask):
                    return (compact_rows(mask, gid, cap_s),
                            torch.clamp(torch.sum(mask, dtype=torch.int32), max=cap_s))

                (se_tbl, se_n), (sx_tbl, sx_n) = (compact_ids(cur & ~prev),
                                                  compact_ids(~cur & prev))
                world = world.replace(prev_onscreen=cur, screen_events_packed=torch.cat(
                    [se_n[None], sx_n[None], se_tbl, sx_tbl]))
        if plan.shadows_on:  # with this frame's visibility (engine.py:1778-1798)
            with span("ops.lighting"):
                world = world.replace(shadow_sprites=(
                    shadow_sprites_by_class(world, light_nbr, cfg) if plan.nbr_specs
                    else shadow_sprites(world, light_nbr, cfg)))
        with span("engine.metrics"):
            world = world.replace(step_count=world.step_count + 1)
            t = world.transform
            metrics = {
                "active_count": torch.sum(t.active, dtype=torch.int32),
                # entities in the neighbour grid table (-1: no lists built)
                "n_binned": n_binned,
                # the lists' accepted neighbours summed over every row (and
                # class): the filled share of the candidate slots (-1: no lists)
                "neighbors_accepted": accepted,
                # live particles after the frame's emissions (-1: no pool)
                "active_particles": p_active,
                # grid-solver cell-capacity overflow: entities degraded to
                # boundary-only this frame
                "solver_overflow": solver_overflow,
                # NaN/explosion guard: active entities with non-finite positions
                "nonfinite_count": torch.sum(
                    t.active & ~(torch.isfinite(t.x) & torch.isfinite(t.y)), dtype=torch.int32
                ),
                # banded-boundary assumption monitor: entities that out-drifted
                # the px/py bounce band (0 in healthy runs)
                "boundary_band_drift": band_drift,
            }
            if cfg.logic.collision_events:
                metrics["collision_pair_count"] = world.collision_pair_count
                # pairs lost to the per-row cap or to max_collision_pairs
                metrics["collision_pairs_dropped"] = pairs_dropped
        return world, metrics

    def _collision_channel(self, world: World) -> torch.Tensor:
        """The packed ``"__collision__"`` payload channel (engine.py:
        1475-1490): an active collider's radius, or ``-radius - 1`` for a
        class without hooks under hook-scoped recording; an inactive one
        ``_NO_COLLIDER``. All float32, as the reference compares it."""
        c = world.collider
        enc = c.radius
        if self._plan.scope_hooked:
            enc = -enc - 1.0
            for s, n in self._plan.hooked_ranges:
                enc[s:s + n] = c.radius[s:s + n]
        return torch.where(c.active, enc, _NO_COLLIDER)

    def _contact_rows(self, nbr):
        """The candidate rows pair recording reads, taken from this frame's
        lists before they are freed (engine.py:1549-1682): (ids, d2, the
        ``"__collision__"`` channel, the rows' entity ids or None when row r
        is entity r, the (start, count) ranges the rows were cut from or
        None). Per class, each hooked class's own lists, padded to the
        widest and concatenated in registration order; hook-scoped over the
        global lists, the hooked classes' rows; else every row.

        When the scan radius is above 1 and every contact lies within the
        3 x 3 cells around a row (2 r_max <= cell), only those 9 of the
        ``(2R+1)^2`` candidate cells are kept: static slices in scan order,
        as ``_contact_subset`` takes them."""
        plan = self._plan
        cfg = plan.cfg
        ch = plan.payload_channels["__collision__"]
        capk = cfg.spatial.cell_capacity

        def cut(lists, scan_r, ranges=None):
            cols = [lists.ids, lists.d2, lists.payload.data[..., ch]]
            if ranges is not None:  # the hooked classes' rows
                cols = [torch.cat([a[s:s + n] for s, n in ranges]) for a in cols]
            if scan_r > 1 and plan.contact_fits and cols[0].shape[1] == (2 * scan_r + 1) ** 2 * capk:
                w = 2 * scan_r + 1
                # rows dr = -1, 0, 1 of the scan, each 3 cells (dc = -1..1) long
                starts = [((dr + scan_r) * w + scan_r - 1) * capk for dr in (-1, 0, 1)]
                return [torch.cat([a[:, s:s + 3 * capk] for s in starts], dim=1) for a in cols]
            return [a.contiguous() for a in cols]

        def pad(a, width, fill):
            return torch.nn.functional.pad(a, (0, width - a.shape[1]), value=fill)

        def arange_rows(ranges):
            return torch.cat([torch.arange(s, s + n, dtype=torch.int32, device=self.device)
                              for s, n in ranges])

        if plan.nbr_specs:  # per class: scope_hooked holds (the plan's rule)
            parts = [cut(nbr[name], r_c) for name, _s, _c, r_c in plan.hooked_specs]
            width = max(p[0].shape[1] for p in parts)
            ids, d2, chv = (torch.cat([pad(p[k], width, fill) for p in parts])
                            for k, fill in ((0, -1), (1, 0.0), (2, _NO_COLLIDER)))
            ranges = tuple((s, n) for _name, s, n, _r in plan.hooked_specs)
            return ids, d2, chv, arange_rows(ranges), ranges
        if plan.scope_hooked:
            ranges = plan.hooked_ranges
            ids, d2, chv = cut(nbr, cfg.spatial.max_cell_radius, ranges)
            return ids, d2, chv, arange_rows(ranges), ranges
        ids, d2, chv = cut(nbr, cfg.spatial.max_cell_radius)
        return ids, d2, chv, None, None

    def _record_pairs(self, world: World, ids, d2, chv, row_ids, ranges):
        """The recording mask over the rows of ``_contact_rows`` against
        this frame's post-physics world, then the compaction
        (engine.py:1587-1682). Hook-scoped, a pair with one hooked side is
        recorded from that side and a pair of two hooked sides from the
        smaller index; else from the smaller index."""
        t, c = world.transform, world.collider
        self_ok, radius = t.active & c.active, c.radius
        if ranges is not None:
            self_ok, radius = (torch.cat([a[s:s + n] for s, n in ranges])
                               for a in (self_ok, radius))
            hooked_j = chv >= 0
            r_j = torch.where(hooked_j, chv, -chv - 1.0)
            once = torch.where(hooked_j, ids > row_ids[:, None], True)
        else:
            r_j = chv
            once = ids > torch.arange(world.n_entities, dtype=torch.int32,
                                      device=self.device)[:, None]
        ok = self_ok[:, None] & (ids >= 0) & (chv > -1.0e30)
        min_d = radius[:, None] + r_j
        rec = ok & (d2 < min_d * min_d) & once
        return record_collision_pairs(world, ids, rec, row_ids)

    def _lazy_frame(self, world: World, inputs: InputState):
        """A mid-chunk frame of the lazy-readback chunk (engine.py:1877-1888):
        inputs, animation and the layout-only resident frame."""
        plan = self._plan
        cfg = plan.cfg
        world = apply_inputs(world, inputs)
        world = advance_animation(world, plan.frame_counts, cfg.dt_ratio)
        return resident_lazy_frame(
            world, cfg, plan.solver_geom, inputs, plan.force_specs,
            cfg.dt_ratio, plan.pin_rows, plan.band_vel_bound,
        )

    def raw_step_fn(self):
        """The one-device ``(world, inputs) -> (world, metrics)`` frame
        (:meth:`_one_step`, with the plan built now if it is not yet), for
        harnesses that place the world themselves, as the entity-sharded
        step does (``parallel.sharded``; engine.py:2508-2514). It queues
        nothing, flushes nothing and fires no hook: ``step``'s host work
        around the frame is the caller's."""
        self._require_init()
        if self._plan is None:
            self._plan = self._build_plan()
        return self._one_step

    def step(self, n: int = 1, block: bool = False) -> Dict[str, torch.Tensor]:
        """Advance ``n`` frames with the inputs of this call (the reference
        freezes the input snapshot for a chunk of frames the same way).
        Queued spawns/despawns apply first, then queued emissions land in
        the particle pool. Returns the last frame's metrics as device
        tensors; ``block=True`` waits for the device.

        With position residency, no neighbour lists and no particle pool,
        and ``n > 1``, this is the reference's
        lazy-readback chunk (engine.py:1833-1899): a frame is full (entity
        order synced from the layout, then the eager frame) when it is the
        call's last, the layout is stale or the bins have expired; every
        other frame runs in the layout alone. ``boundary_band_drift`` is then
        the chunk's maximum. Bit-exact with ``n`` single steps.

        With collision or screen events and ``n > 1`` (engine.py:2533-2554),
        ``logic.event_chunk > 1`` runs the chunked event log
        (``_step_events_chunked``); otherwise the frames run one
        ``step(1)`` at a time, each dispatching its events, so no
        transition is lost. A frame stepped alone reads its event counts
        and fires the hooks after it."""
        self._require_init()
        if self.paused or n <= 0:
            return self.metrics
        with span("engine.step"):
            return self._step(n, block)

    def _step(self, n: int, block: bool) -> Dict[str, torch.Tensor]:
        self._check_events_rebuild()
        lg = self.config.logic
        if (lg.collision_events or lg.screen_events) and n > 1:
            if lg.event_chunk > 1:
                if self._plan is None:
                    self._plan = self._build_plan()
                metrics = self._step_events_chunked(n)
            else:
                for _ in range(n):
                    metrics = self.step(1)
            if block:
                self.sync()
            return metrics
        with span("engine.prepare"):
            # the plan is built before the queued writes land, as the
            # reference builds its step before flushing (engine.py:
            # 2555-2558): the first step's geometry sees the spawns' radii
            # only through _max_radius
            built_now = self._plan is None
            if built_now:
                self._plan = self._build_plan()
            self._flush_pending()
            if self._plan is None:  # the flush wrote a radius above the bound
                self._plan = self._build_plan()
            self._flush_emissions()
            plan = self._plan
            inputs = self.input.snapshot(self.device)
        t0 = time.perf_counter()
        world = self.world
        if plan.lazy_chunks and n > 1:
            interval = max(2, plan.cfg.physics.rebin_interval)
            drift = torch.zeros((), dtype=torch.int32, device=self.device)
            for i in range(n):
                if (i == n - 1 or world.solver_pos_step != world.step_count
                        or bins_expired(world, interval)):
                    world, metrics = self._one_step(resident_sync_entity(world), inputs)
                    drift = torch.maximum(metrics["boundary_band_drift"], drift)
                    metrics["boundary_band_drift"] = drift
                else:
                    with span("ops.physics.lazy"):
                        world, frame_drift = self._lazy_frame(world, inputs)
                    drift = torch.maximum(drift, frame_drift)
                    self.lazy_frames += 1
        else:
            for _ in range(n):
                world, metrics = self._one_step(world, inputs)
        self.world, self.metrics = world, metrics
        if block or self._profiling:
            self.sync()
        self._time_steps(t0, n, built_now)
        if lg.collision_events or lg.screen_events:
            with span("engine.dispatch_events"):
                if lg.collision_events:
                    self._dispatch_collision_events()
                if lg.screen_events:
                    self._dispatch_screen_events()
        return metrics

    # ------------------------------------------------------------------
    # the chunked event log (engine.py:1956-2319)
    # ------------------------------------------------------------------
    def _log_specs(self):
        """(tag, cap, width, hooked) of each logged kind (engine.py:
        1976-2003): the collision Enter/Stay/Exit pair tables, capped at
        ``min(max_events_per_frame, max_collision_pairs)`` and, under
        hook-scoped recording, at the hooked rows x ``PER_ENTITY``; the
        onScreen Enter/Exit id tables at ``max_screen_events``. A kind that
        no class hooks is a one-row placeholder."""
        lg = self.config.logic
        specs = []
        if lg.collision_events:
            cap = min(lg.max_events_per_frame, self.config.physics.max_collision_pairs)
            if not lg.record_all_pairs:
                n_hooked = sum(reg.count for reg in self.classes.values()
                               if reg.count > 0 and self._class_has_hooks(reg.cls))
                if n_hooked:
                    cap = min(cap, n_hooked * PER_ENTITY)
            for tag, hooked in zip(("event_enter", "event_stay", "event_exit"), self._hooked3()):
                specs.append((tag, cap if hooked else 1, 2, hooked))
        if lg.screen_events:
            for tag, hooked in zip(("s_enter", "s_exit"), self._screen_hooked2()):
                specs.append((tag, lg.max_screen_events if hooked else 1, 1, hooked))
        return tuple(specs)

    def _step_events_chunked(self, n: int) -> Dict[str, torch.Tensor]:
        """``step(n)`` through the device event log (engine.py:2189-2258):
        chunks of up to ``logic.event_chunk`` frames, each logging every
        frame's tables and participants (``_EventLog``) with no host read
        inside the chunk, then one copy to the host a chunk. With
        ``logic.event_overlap`` the hooks of a chunk fire after the next
        chunk is queued, so the copy and the hook bodies overlap the card's
        work; the last chunk's log is held across ``step`` calls until the
        next chunk or a barrier (``_flush_event_log``)."""
        # the held chunk is taken first: _flush_pending would fire it here
        # and lose the overlap across calls
        held, self._pending_log = self._pending_log, None
        with span("engine.prepare"):
            self._flush_pending()
            if self._plan is None:  # the flush wrote a radius above the bound
                self._plan = self._build_plan()
            self._flush_emissions()
            inputs = self.input.snapshot(self.device)
        has_hooks = self._has_collision_hooks() or any(self._screen_hooked2())
        specs = self._log_specs()
        overlap = self.config.logic.event_overlap
        pending = held
        metrics = self.metrics
        remaining = n
        t0 = time.perf_counter()
        while remaining > 0:
            k = min(self.config.logic.event_chunk, remaining)
            remaining -= k
            log = _EventLog(specs, k, self.device)
            world = self.world
            dropped = torch.zeros((), dtype=torch.int32, device=self.device)
            for f in range(k):
                world, metrics = self._one_step(world, inputs)
                with span("engine.event_log"):
                    dropped = dropped + log.write(world, f)
                # rows past the log's cap never reach a hook: counted over
                # the chunk
                metrics["event_rows_dropped"] = dropped
            self.world, self.metrics = world, metrics
            if not has_hooks:
                continue
            with span("engine.event_log"):
                log.fetch()
            if overlap:
                if pending is not None:
                    self._dispatch_logged_events(pending)
                pending = log
            else:
                self._dispatch_logged_events(log)
        self._pending_log = pending
        self._time_steps(t0, n)
        return metrics

    def _time_steps(self, t0: float, n: int, built_now: bool = False) -> None:
        """Record ``n`` frames enqueued since ``t0`` (host clock; the device
        time too when the call blocked). A call that built the plan (and
        may have built the kernels) counts its frames without a sample, as
        the reference skips a compiling call (engine.py:2572-2577)."""
        if built_now:
            self.timer.total_steps += n
        else:
            self.timer.record((time.perf_counter() - t0) / n, n)

    # ------------------------------------------------------------------
    # frame plans (engine.py:2324-2506)
    # ------------------------------------------------------------------
    def begin_plan(self) -> FramePlan:
        """Start a :class:`FramePlan`."""
        self._require_init()
        return FramePlan(self)

    def run_plan(self, plan: FramePlan, max_chunk: int = 32) -> Dict[str, torch.Tensor]:
        """Run a frame plan in chunks of up to ``max_chunk`` frames: each
        frame scatters its writes and takes its input snapshot, then steps.
        A chunk's op table and input timeline reach the card in one copy,
        and no frame of a chunk reads the card. With collision or screen
        hooks the chunk logs every frame's event tables, and the hooks fire
        after the chunk (``_dispatch_logged_events``)."""
        self._require_init()
        if plan._cur or plan._cur_ops:
            plan.next_frame()  # close a trailing partial frame
        if not plan.frames or self.paused:
            return self.metrics
        self._check_events_rebuild()
        with span("engine.prepare"):
            built_now = self._plan is None
            if built_now:
                self._plan = self._build_plan()
            self._flush_pending()
            if self._plan is None:  # the flush wrote a radius above the bound
                self._plan = self._build_plan()
            self._flush_emissions()
        lg = self.config.logic
        events_on = ((lg.collision_events and self._has_collision_hooks())
                     or (lg.screen_events and any(self._screen_hooked2())))
        metrics = self.metrics
        for pos in range(0, len(plan.frames), max_chunk):
            t0 = time.perf_counter()
            chunk = plan.frames[pos:pos + max_chunk]
            with span("engine.run_plan"):
                metrics = self._run_plan_chunk(chunk, events_on)
            self._time_steps(t0, len(chunk), built_now and pos == 0)
        return metrics

    def _run_plan_chunk(self, frames, events_on: bool) -> Dict[str, torch.Tensor]:
        """One chunk of plan frames, each a full frame. When any frame of
        the chunk writes, every frame of it drops the bin cache and rebins,
        as the reference's chunk body does (engine.py:2450-2453). A chunk
        whose frames mostly write runs them off the resident layout (the
        op-density gate, engine.py:2395-2397)."""
        n_frames = len(frames)
        writes = any(cols for cols, _ in frames)
        dense = 2 * sum(1 for cols, _ in frames if cols) >= n_frames
        residency = False if dense else None
        columns, inputs = self._plan_chunk_tables(frames)
        log = _EventLog(self._log_specs(), n_frames, self.device) if events_on else None
        dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        world, metrics = self.world, self.metrics
        for f in range(n_frames):
            world = _scatter_columns(world, columns[f])
            if writes and world.solver_bin_step is not None:
                world = world.replace(solver_bin_step=-1)
            world, metrics = self._one_step(world, inputs[f], residency)
            if log is not None:
                dropped = dropped + log.write(world, f)
                metrics["event_rows_dropped"] = dropped
        self.world, self.metrics = world, metrics
        if log is not None:
            log.fetch()
            self._dispatch_logged_events(log)
        return metrics

    def _plan_chunk_tables(self, frames):
        """A chunk's writes and input timeline on the engine's device: one
        int32 buffer on the host (every frame's inputs, then every column's
        indices, then its values as float32 bits), copied to the card once
        through pinned memory without blocking. Returns (per frame
        {path: (int64 indices, float32 values)}, per frame InputState), all
        views of the copy. Each column is cut to its own length, so no
        index is padded past the world."""
        k = len(frames)
        snaps = [snap for _cols, snap in frames]
        f32 = np.stack([np.stack([getattr(s, name).numpy() for name in _INPUT_F32])
                        for s in snaps]).astype(np.float32)
        bools = np.stack([np.concatenate([getattr(s, name).numpy().reshape(-1)
                                          for name in _INPUT_BOOL]) for s in snaps])
        idx_parts, val_parts, spans = [], [], []
        pos = 0
        for cols, _snap in frames:
            frame_spans = []
            for path, (i, v) in cols.items():
                idx_parts.append(i)
                val_parts.append(v)
                frame_spans.append((path, pos, i.size))
                pos += i.size
            spans.append(frame_spans)
        host = np.concatenate([f32.view(np.int32).reshape(-1), bools.astype(np.int32).reshape(-1)]
                              + idx_parts + [np.asarray(v, np.float32).view(np.int32)
                                             for v in val_parts])
        buf = torch.from_numpy(host)
        if self.device.type == "cuda":
            pinned = torch.empty(buf.shape, dtype=torch.int32, pin_memory=True)
            pinned.copy_(buf)
            buf = pinned.to(self.device, non_blocking=True)
        else:
            buf = buf.to(self.device)
        o = f32.size
        f32_t = buf[:o].view(torch.float32).view(k, len(_INPUT_F32))
        bool_t = buf[o:o + bools.size].view(k, -1) != 0
        o += bools.size
        idx_all = buf[o:o + pos].to(torch.int64)
        val_all = buf[o + pos:o + 2 * pos].view(torch.float32)
        columns = [{path: (idx_all[p:p + m], val_all[p:p + m]) for path, p, m in frame_spans}
                   for frame_spans in spans]
        n_buttons = snaps[0].mouse_buttons.numel()
        inputs = [InputState(
            mouse_x=f32_t[f, 0], mouse_y=f32_t[f, 1],
            mouse_buttons=bool_t[f, :n_buttons], mouse_present=bool_t[f, n_buttons],
            keys=bool_t[f, n_buttons + 1:],
            camera_x=f32_t[f, 2], camera_y=f32_t[f, 3], camera_zoom=f32_t[f, 4],
        ) for f in range(k)]
        return columns, inputs

    def _run_plan_per_frame(self, plan: FramePlan) -> Dict[str, torch.Tensor]:
        """A plan one frame at a time through the immediate paths: each
        frame's columns through ``_apply_columns``, then one frame with its
        snapshot, its events dispatched at once (engine.py:2490-2506). The
        plan-against-immediate oracle of the tests."""
        self._require_init()
        if plan._cur or plan._cur_ops:
            plan.next_frame()
        if self._plan is None:
            self._plan = self._build_plan()
        for cols, snap in plan.frames:
            if cols:
                self.world = self._apply_columns(self.world, dict(cols))
            if self._plan is None:  # the columns wrote a radius above the bound
                self._plan = self._build_plan()
            inputs = snap.map_tensors(lambda a: a.to(self.device))
            self.world, self.metrics = self._one_step(self.world, inputs)
            self.timer.total_steps += 1
            if self.config.logic.collision_events:
                self._dispatch_collision_events()
            if self.config.logic.screen_events:
                self._dispatch_screen_events()
            self._flush_pending()
            self._flush_emissions()
        return self.metrics

    def _flush_event_log(self) -> None:
        """Fire the held chunk's hooks (logic.event_overlap) at a barrier
        that observable state must reflect (engine.py:2260-2273)."""
        pending, self._pending_log = self._pending_log, None
        if pending is not None:
            self._dispatch_logged_events(pending)

    def _dispatch_logged_events(self, log: "_EventLog") -> None:
        """Read a chunk's log from its host copy and fire each frame's hooks
        (engine.py:2275-2319): collision kinds through
        ``CollisionEventCtx.from_logged``, screen kinds per id. The hooks'
        spawns, despawns and emissions land before the next chunk."""
        with span("engine.dispatch_events"):
            by_tag = log.tables()
            if any(int(counts.sum()) for _ids, counts, _co in by_tag.values()):
                for f in range(log.k):
                    if "event_enter" in by_tag:
                        (enter, n_e, e_co), (stay, n_s, s_co), (exit_, n_x, x_co) = (
                            by_tag["event_enter"], by_tag["event_stay"], by_tag["event_exit"])
                        ce, cs, cx = int(n_e[f]), int(n_s[f]), int(n_x[f])
                        if ce or cs or cx:
                            ctx = CollisionEventCtx.from_logged(self, [
                                (enter[f, :ce], e_co[f, :ce]), (stay[f, :cs], s_co[f, :cs]),
                                (exit_[f, :cx], x_co[f, :cx])])
                            self._fire_collision_tables(ctx, enter[f, :ce], stay[f, :cs],
                                                        exit_[f, :cx])
                    if "s_enter" in by_tag:
                        (s_en, n_se, _), (s_ex, n_sx, _) = by_tag["s_enter"], by_tag["s_exit"]
                        cse, csx = int(n_se[f]), int(n_sx[f])
                        if cse or csx:
                            self._fire_screen_tables(s_en[f, :cse, 0], s_ex[f, :csx, 0])
            self._flush_pending()
            self._flush_emissions()

    # ------------------------------------------------------------------
    # event dispatch (logic_worker.js:417-554)
    # ------------------------------------------------------------------
    def _dispatch_collision_events(self) -> None:
        """A frame stepped alone: read its three event counts, then the
        rows they cover, and fire the hooks (engine.py:2694-2717)."""
        if not self._has_collision_hooks():
            return
        w = self.world
        n_e, n_s, n_x = torch.stack(
            [w.event_enter_count, w.event_stay_count, w.event_exit_count]).tolist()
        if not (n_e or n_s or n_x):
            return
        tables = torch.stack([w.event_enter, w.event_stay, w.event_exit])
        tables = tables[:, :max(n_e, n_s, n_x)].cpu().numpy()
        enters, stays, exits = tables[0, :n_e], tables[1, :n_s], tables[2, :n_x]
        ctx = CollisionEventCtx(self, np.concatenate([enters, stays, exits]))
        self._fire_collision_tables(ctx, enters, stays, exits)

    def _dispatch_screen_events(self) -> None:
        """A frame stepped alone: read the packed onScreen table and fire
        the hooks (engine.py:2628-2643). The last frame's mask starts all
        False, so an entity's first visible frame fires Enter."""
        if not any(self._screen_hooked2()):
            return
        packed = self.world.screen_events_packed.cpu().numpy()
        cap_s = (packed.size - 2) // 2
        n_e, n_x = int(packed[0]), int(packed[1])
        if n_e or n_x:
            self._fire_screen_tables(packed[2:2 + n_e], packed[2 + cap_s:2 + cap_s + n_x])

    def _fire_screen_tables(self, entered, exited) -> None:
        for indices, hook_name in ((entered, "on_screen_enter"), (exited, "on_screen_exit")):
            for i in indices:
                hook = getattr(self._class_of_index(int(i)).cls, hook_name, None)
                if hook is not None:
                    hook(int(i))

    def _screen_hooked2(self) -> Tuple[bool, bool]:
        """Which of (screen enter, screen exit) some class hooks."""
        return tuple(any(getattr(reg.cls, h, None) is not None for reg in self.classes.values())
                     for h in ("on_screen_enter", "on_screen_exit"))

    def _has_collision_hooks(self) -> bool:
        return any(self._hooked3())

    def _hooked3(self) -> Tuple[bool, bool, bool]:
        """Which of (enter, stay, exit) some class hooks, scalar or
        ``_batch`` (engine.py:2722-2732)."""
        return tuple(any(_hooks(reg.cls, h) for reg in self.classes.values())
                     for h in _COLLISION_HOOKS)

    @staticmethod
    def _class_has_hooks(cls) -> bool:
        return any(_hooks(cls, h) for h in _COLLISION_HOOKS)

    def _events_signature(self):
        """What the plan derives from hook registration: the hooked kinds
        (the log's tables) and the hooked classes (the recording scope)."""
        return (self._hooked3(), self._screen_hooked2(),
                tuple(name for name, reg in self.classes.items()
                      if reg.count > 0 and self._class_has_hooks(reg.cls)))

    def _check_events_rebuild(self) -> None:
        """Re-plan when hooks were added or removed after the plan was built,
        so a late hook fires (engine.py:2757-2769)."""
        lg = self.config.logic
        if ((lg.collision_events or lg.screen_events) and self._plan is not None
                and self._plan.events_sig != self._events_signature()):
            self._plan = None

    def _fire_collision_tables(self, ctx, enters, stays, exits) -> None:
        """Fire the collision hooks for one frame's tables (engine.py:
        2771-2817). Scalar hooks fire per row in table order with both
        orientations interleaved, (a0, b0), (b0, a0), (a1, b1), ..., the
        reference's per-pair loop (logic_worker.js:429-526), whatever the
        classes. A class with ``on_collision_<kind>_batch(ctx, me, other)``
        gets one call with all its ``me`` rows in table order; batch calls
        go class by class in registration order."""

        def fire(pairs: np.ndarray, hook_name: str) -> None:
            p = np.asarray(pairs, np.int64).reshape(-1, 2)
            if p.shape[0] == 0:
                return
            me = p[:, [0, 1]].reshape(-1)
            other = p[:, [1, 0]].reshape(-1)
            scalar_rows = np.zeros(me.shape[0], dtype=bool)
            for reg in self.classes.values():
                batch = getattr(reg.cls, hook_name + "_batch", None)
                hook = getattr(reg.cls, hook_name, None)
                if batch is None and hook is None:
                    continue
                sel = (me >= reg.start_index) & (me < reg.start_index + reg.count)
                if batch is not None:
                    if sel.any():
                        batch(ctx, me[sel], other[sel])
                else:
                    scalar_rows |= sel
            for k in np.flatnonzero(scalar_rows):
                m = int(me[k])
                getattr(self._class_of_index(m).cls, hook_name)(ctx, m, int(other[k]))

        fire(enters, "on_collision_enter")
        fire(stays, "on_collision_stay")
        fire(exits, "on_collision_exit")

    def sync(self) -> None:
        """Fire a held event chunk's hooks, then wait for all queued device
        work."""
        self._flush_event_log()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats(self) -> Dict[str, Any]:
        """The stats-panel analog (gameEngine.js:1326-1381; engine.py:
        2600-2613): steps/s and ms a step, the moving average of the last
        60 timed ``step``/``run_plan`` calls or chunks (host clock; enqueue
        time unless they blocked), frames stepped, pools, and the last
        metrics."""
        out = {
            "steps_per_sec": round(self.timer.steps_per_sec, 2),
            "ms_per_step": round(self.timer.ms_per_step, 3),
            "total_steps": self.timer.total_steps,
            "pools": {name: self.get_pool_stats(name) for name in self.classes},
        }
        # the metrics reach the host in one copy
        values = host_copy(list(self.metrics.values())) if self.metrics else []
        for key, value in zip(self.metrics, values):
            out[key] = int(value)
        return out

    def enable_profiling(self, on: bool = True) -> None:
        """enableProfiling (gameEngine.js:1731-1747): ``step`` then waits
        for the card, so the timer reads device time."""
        self._profiling = on

    def pause(self) -> None:
        """``step`` and ``run_plan`` return at once until :meth:`resume`."""
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def destroy(self) -> None:
        """gameEngine.destroy (:1585-1639): drop the world and the plan, and
        reset the pools, the queued ops and emissions and the held event
        log, so a later ``init()`` starts clean and reclaims the mouse
        (engine.py:2873-2893)."""
        self.world = None
        self._plan = None
        # a held log's hooks must not fire into a re-initialised world
        self._pending_log = None
        self._initialized = False
        self._pending_ops.clear()
        self.emitter.clear()
        for reg in self.classes.values():
            reg.pool = EntityPool(reg.start_index, reg.count)

    def save_checkpoint(self, path: str) -> None:
        checkpoint.save_checkpoint(self, path)

    def load_checkpoint(self, path: str) -> None:
        checkpoint.load_checkpoint(self, path)

    def update_physics_config(self, **kwargs) -> None:
        """Live physics updates: ``engine.update_physics_config(gravity=(0, 1))``."""
        phys = dataclasses.replace(self.config.physics, **kwargs).validated()
        self.config = dataclasses.replace(self.config, physics=phys)
        self._plan = None

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------
    def snapshot(self) -> World:
        """A copy of the world on the host. With position residency it needs
        no sync: every full frame keeps entity order current, and a step()
        call always ends with a full frame."""
        self._flush_pending()
        return self.world.map_tensors(lambda a: a.to("cpu", copy=True))

    def restore(self, snap: World) -> None:
        """Replace the world with a copy of ``snap`` on the engine's device
        (spawns and despawns queued before the call are superseded)."""
        self._flush_pending()
        self.world = snap.map_tensors(lambda a: a.to(self.device, copy=True))

    # ------------------------------------------------------------------
    # rendering (extraction and the headless view; engine.py:2670-2689)
    # ------------------------------------------------------------------
    def render_packet(self, max_visible: int = 0) -> RenderPacket:
        """The visible-entity packet for a host renderer
        (``render.extract``), compacted on the device and returned as CPU
        tensors through one copy. ``max_visible`` defaults to
        ``min(N, 65536)``."""
        self._require_init()
        max_visible = max_visible or min(self.world.n_entities, 65536)
        return packet_to_host(extract_render_packet(self.world, self.config, max_visible))

    def screenshot(self, path: Optional[str], width: int = 0, height: int = 0) -> np.ndarray:
        """Render the current frame with the headless renderer
        (``render.headless.render_frame``); writes a PNG at ``path`` (none
        when it is None) and returns the RGB image."""
        from .render.headless import render_frame

        return render_frame(self, width or None, height or None, path=path)

    # ------------------------------------------------------------------
    # renderer sprite-override RPC (gameObject.js:546-582 ->
    # pixi_worker.js:2009-2053; engine.py:2828-2870): a host-side escape
    # hatch for driving one entity's renderer sprite directly. Props
    # persist until cleared; method calls are one-shot and sequence-
    # numbered, so a polling client replays each once.
    # ------------------------------------------------------------------
    def set_sprite_prop(self, index: int, prop: str, value) -> None:
        """Override a renderer sprite property of entity ``index`` (the
        setSpriteProp analog, gameObject.js:546-563); ``value=None`` clears
        it. The web client applies tint, alpha, visible, rotation, scale_x,
        scale_y and frame."""
        idx = int(index)
        if value is None:
            ov = self._sprite_overrides.get(idx)
            if ov is not None:
                ov.pop(str(prop), None)
                if not ov:
                    del self._sprite_overrides[idx]
            return
        self._sprite_overrides.setdefault(idx, {})[str(prop)] = value

    def call_sprite_method(self, index: int, method: str, *args) -> None:
        """Queue a one-shot renderer sprite method call for entity
        ``index`` (the callSpriteMethod analog, gameObject.js:565-582),
        served on /overrides with an increasing ``seq``; the last 512
        are kept."""
        self._sprite_call_seq += 1
        self._sprite_calls.append({
            "seq": self._sprite_call_seq,
            "index": int(index),
            "method": str(method),
            "args": list(args),
        })
        if len(self._sprite_calls) > 512:
            del self._sprite_calls[:-512]

    def sprite_overrides_payload(self) -> Dict[str, Any]:
        """The /overrides JSON body: the persistent prop table and the
        queued calls."""
        return {
            "props": {str(k): dict(v) for k, v in self._sprite_overrides.items()},
            "calls": list(self._sprite_calls),
        }

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("call init() first")
