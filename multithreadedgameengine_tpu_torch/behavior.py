"""Entity classes and the batched logic phase — the GameObject/tick() analog.

PyTorch counterpart of ``multithreadedgameengine_tpu/behavior.py``
(behavior.py:58-386, 596-811): :class:`EntityClass` with its host hooks
(``setup``, ``on_spawned``, ``on_spawned_batch``, ``on_despawned``), the
host contexts, field addressing by ``"component.field"`` path (user
components resolve through ``world.custom``), the neighbour view of
:class:`TickCtx`, :func:`run_logic_phase`, and :func:`run_logic_phase_masked`
for the halo step's rows in arbitrary order.

Where the reference vmaps a per-entity tick, the port hands the tick each
class's contiguous slice of the batch: ``ctx.x`` is the ``[count]`` tensor of
the class's x values, ``ctx.neighbor_ids`` the ``[count, S]`` slot table,
``ctx.neighbor_col(path)`` ``[count, S]``, ``ctx.mouse_x`` a 0-dim tensor;
the tick reduces over dim 1 and returns ``[count]`` tensors (or scalars,
broadcast). Ticks are written in torch.

For position residency the module also ports the layout-evaluated ticks
(behavior.py:387-522): :class:`ForceTickCtx`, :func:`probe_layout_safe` and
:func:`eval_layout_forces`, which runs a layout-safe tick once over the
flattened solver layout instead of ``vmap``-ing it over slots.

A tick's ``"emit"`` key asks for particles (behavior.py:525-586): a dict of
:data:`EMIT_FIELDS` plus ``"count"``, each a scalar (every particle), a
``[count]`` tensor (per entity) or a ``[count, emit_cap]`` / ``[1,
emit_cap]`` tensor (per particle; the reference's per-entity ``[emit_cap]``
row). The logic phase returns the requests of each class as one block for
``ops.particles.apply_tick_emissions``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .components import (
    Collider,
    LightEmitter,
    MouseComponent,
    RigidBody,
    ShadowCaster,
    SpriteRenderer,
    Transform,
)
from .config import EngineConfig
from .inputs import InputState, key_index
from .ops.spatial import NeighborLists
from .profiling import span
from .state import World


def snake_case(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


# World attribute name for each built-in component class
BUILTIN_PATHS = {
    Transform: "transform",
    RigidBody: "rigid_body",
    Collider: "collider",
    SpriteRenderer: "sprite",
    MouseComponent: "mouse",
    LightEmitter: "light",
    ShadowCaster: "shadow",
}

# Ergonomic aliases (gameObject.js:226-295 this.x/.vx accessors)
FIELD_ALIASES = {
    "x": "transform.x",
    "y": "transform.y",
    "rotation": "transform.rotation",
    "vx": "rigid_body.vx",
    "vy": "rigid_body.vy",
    "ax": "rigid_body.ax",
    "ay": "rigid_body.ay",
    "radius": "collider.radius",
    "visual_range": "collider.visual_range",
    "tint": "sprite.tint",
    "alpha": "sprite.alpha",
}


def get_component(world: World, name: str):
    """A built-in component by its World attribute, else a user component
    of ``world.custom``."""
    if name in BUILTIN_PATHS.values():
        return getattr(world, name)
    if name in world.custom:
        return world.custom[name]
    raise KeyError(f"unknown component {name!r}")


def put_component(world: World, name: str, comp) -> World:
    """``world`` with component ``name`` replaced (built-in or user)."""
    if name in BUILTIN_PATHS.values():
        return world.replace(**{name: comp})
    return world.replace(custom={**world.custom, name: comp})


def resolve_field(world: World, path: str) -> Tuple[Any, str, str]:
    """Resolve 'component.field' (or an alias) to (component, comp_attr,
    field). User components resolve through ``world.custom``."""
    path = FIELD_ALIASES.get(path, path)
    comp_name, _, field = path.partition(".")
    if not field:
        raise KeyError(f"field path {path!r} must be 'component.field'")
    try:
        comp = get_component(world, comp_name)
    except KeyError:
        raise KeyError(f"unknown component {comp_name!r} in path {path!r}") from None
    if not hasattr(comp, field):
        raise KeyError(f"component {comp_name!r} has no field {field!r}")
    return comp, comp_name, field


def read_field(world: World, path: str) -> torch.Tensor:
    comp, _, field = resolve_field(world, path)
    return getattr(comp, field)


def write_field(world: World, path: str, value: torch.Tensor) -> World:
    comp, comp_name, field = resolve_field(world, path)
    return put_component(world, comp_name, comp.replace(**{field: value}))


class EntityClass:
    """Base entity class. Subclass, declare ``components``, override hooks.
    Registration assigns ``entity_type`` ids in registration order and
    registers parent classes with count 0 (gameEngine.js:389-457)."""

    components: Sequence[Any] = ()

    #: whether the tick reads its neighbour lists; when no ticking class
    #: does, the frame builds none
    uses_neighbors: bool = True

    #: world field paths the tick reads per neighbour: they ride the
    #: neighbour table as payload channels, so ``ctx.neighbor_col(path)`` is
    #: a slice instead of a gather (behavior.py:139-145)
    neighbor_fields: Sequence[str] = ()

    #: the most particles one entity's tick may emit a frame through the
    #: ``"emit"`` key (behavior.py:147-151)
    emit_cap: int = 1

    # populated by the engine at registration
    entity_type: int = -1
    start_index: int = 0
    count: int = 0

    # ---- host-side lifecycle hooks ----
    @classmethod
    def setup(cls, ctx: "SetupCtx") -> Optional[Dict[str, Any]]:
        """Once at init, over the class range. Return {'component.field':
        scalar-or-[count]-array} defaults."""
        return None

    @classmethod
    def on_spawned(cls, ctx: "SpawnCtx", spawn_config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Per spawn (host). Return {'component.field': scalar} writes."""
        return None

    #: Optional vectorized spawn hook, ``on_spawned_batch(ctx: BatchSpawnCtx,
    #: spawn_arrays) -> {path: [n] array}``, consuming the seeded stream in
    #: the same per-entity order as ``on_spawned``.
    on_spawned_batch = None

    @classmethod
    def on_despawned(cls, index: int) -> None:
        """Per despawn (host)."""

    # ---- device-side hook: tick(ctx: TickCtx) -> {path: tensor} ----
    tick: Optional[Callable[["TickCtx"], Optional[Dict[str, Any]]]] = None

    @classmethod
    def collect_components(cls) -> List[Any]:
        """Union of ``components`` up the class hierarchy, Transform always
        included (utils.js:199-221)."""
        seen: List[Any] = []
        for klass in cls.__mro__:
            if klass is EntityClass:
                break
            for comp in getattr(klass, "components", ()):
                if comp not in seen:
                    seen.append(comp)
        if Transform not in seen:
            seen.append(Transform)
        return seen


# The host contexts carry the engine's ``SpriteRegistry`` (``assets``) as
# ``sprites``, as the reference's do (behavior.py:213-247).

class SetupCtx:
    """Host context for EntityClass.setup."""

    def __init__(self, config: EngineConfig, start: int, count: int, rng, sprites=None):
        self.config = config
        self.start = start
        self.count = count
        self.rng = rng  # shared Mulberry32 stream
        self.sprites = sprites

    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.start + self.count)


class SpawnCtx:
    """Host context for EntityClass.on_spawned."""

    def __init__(self, config: EngineConfig, index: int, rng, sprites=None):
        self.config = config
        self.index = index
        self.rng = rng
        self.sprites = sprites


class BatchSpawnCtx:
    """Host context for EntityClass.on_spawned_batch; ``rng.draw(k)``
    consumes exactly the draws ``len(indices)`` on_spawned calls would."""

    def __init__(self, config: EngineConfig, indices, rng, sprites=None):
        self.config = config
        self.indices = indices  # np.int32[n], claim order
        self.rng = rng
        self.sprites = sprites


class TickCtx:
    """The view handed to ``tick``: one class's slice of the batch.

    ``self_view`` holds every component's rows ``[start, start+count)``;
    ``x``, ``vx``, ``field(path)`` read from it. ``world`` and ``inputs`` are
    the whole pre-tick world and the frame's inputs. The neighbour view
    (behavior.py:331-373) is batched the same way: ``neighbor_ids`` ``[count,
    S]`` (-1 gaps), ``neighbor_d2`` ``[count, S]``, ``neighbor_count``
    ``[count]`` and ``neighbor_payload`` ``[count, S, F]`` or None.

    ``gather_fn``: a path -> global-id-indexed field resolver; under the
    halo step neighbour ids are global while ``world`` holds routed rows."""

    __slots__ = ("i", "world", "neighbor_ids", "neighbor_d2", "neighbor_count",
                 "inputs", "dt_ratio", "config", "neighbor_payload",
                 "payload_channels", "self_view", "gather_fn")

    def __init__(self, i: torch.Tensor, world: World, neighbor_ids, neighbor_d2,
                 neighbor_count, inputs: InputState, dt_ratio: float,
                 config: EngineConfig, neighbor_payload=None, payload_channels=None,
                 self_view: Optional[Dict[str, Any]] = None, gather_fn=None):
        self.i = i  # int32[count] entity indices
        self.world = world
        self.neighbor_ids = neighbor_ids
        self.neighbor_d2 = neighbor_d2
        self.neighbor_count = neighbor_count
        self.inputs = inputs
        self.dt_ratio = dt_ratio
        self.config = config
        self.neighbor_payload = neighbor_payload
        self.payload_channels = payload_channels or {}
        self.self_view = self_view
        self.gather_fn = gather_fn

    # -- self accessors (this.x / this.vx ... gameObject.js:226-295) --
    def _self_field(self, comp_name: str, field: str) -> torch.Tensor:
        return getattr(self.self_view[comp_name], field)

    def field(self, path: str) -> torch.Tensor:
        path = FIELD_ALIASES.get(path, path)
        comp_name, _, field = path.partition(".")
        if not field:
            raise KeyError(f"field path {path!r} must be 'component.field'")
        return self._self_field(comp_name, field)

    @property
    def x(self): return self._self_field("transform", "x")
    @property
    def y(self): return self._self_field("transform", "y")
    @property
    def rotation(self): return self._self_field("transform", "rotation")
    @property
    def entity_type(self): return self._self_field("transform", "entity_type")
    @property
    def vx(self): return self._self_field("rigid_body", "vx")
    @property
    def vy(self): return self._self_field("rigid_body", "vy")
    @property
    def ax(self): return self._self_field("rigid_body", "ax")
    @property
    def ay(self): return self._self_field("rigid_body", "ay")
    @property
    def speed(self): return self._self_field("rigid_body", "speed")
    @property
    def velocity_angle(self): return self._self_field("rigid_body", "velocity_angle")

    # -- neighbours (this.neighbors / updateNeighbors, gameObject.js:700-729) --
    @property
    def neighbor_mask(self) -> torch.Tensor:
        """Live slots: those holding a real id (the lists have -1 gaps)."""
        return self.neighbor_ids >= 0

    @property
    def neighbor_ids_safe(self) -> torch.Tensor:
        return torch.clamp(self.neighbor_ids, min=0)

    def gather(self, path_or_array) -> torch.Tensor:
        """A world field (or a raw ``[N]`` tensor) at the neighbour ids,
        ``[count, S]``: the slow path, a random gather (declare the path in
        ``neighbor_fields`` for a payload channel instead). Under the halo
        step a path resolves through ``gather_fn``; a raw tensor cannot."""
        if self.gather_fn is not None:
            if not isinstance(path_or_array, str):
                raise ValueError(
                    "ctx.gather(raw_array) cannot run under the halo step "
                    "(rows are slab-local while neighbor ids are global); "
                    "pass the field path or declare it in neighbor_fields"
                )
            arr = self.gather_fn(path_or_array)
        elif isinstance(path_or_array, str):
            arr = read_field(self.world, path_or_array)
        else:
            arr = path_or_array
        return arr[self.neighbor_ids_safe.to(torch.int64)]

    def neighbor_col(self, path: str) -> torch.Tensor:
        """Per-neighbour values of a world field, ``[count, S]``: a payload
        channel when the field rides the table (declared, or x/y), else a
        gather."""
        path = FIELD_ALIASES.get(path, path)
        ch = self.payload_channels.get(path)
        if ch is not None and self.neighbor_payload is not None:
            return self.neighbor_payload[..., ch]
        return self.gather(path)

    # -- input shortcuts (Mouse statics / Keyboard proxy) --
    @property
    def mouse_x(self): return self.inputs.mouse_x
    @property
    def mouse_y(self): return self.inputs.mouse_y
    @property
    def mouse_down(self): return self.inputs.mouse_buttons[0]

    def key(self, name: str) -> torch.Tensor:
        return self.inputs.keys[key_index(name)]


def _entity_view(world: World, start: int, count: int) -> Dict[str, Any]:
    """Every component's rows [start, start+count), as views (user
    components included)."""
    comps = {name: getattr(world, name) for name in BUILTIN_PATHS.values()}
    comps.update(world.custom)
    return {name: comp.map_tensors(lambda a: a[start:start + count])
            for name, comp in comps.items()}


#: emit-request field -> (dtype, default) (behavior.py:525-543). x and y
#: default to the emitting entity's pre-tick position; the rest are the
#: host emit()'s defaults (ParticleEmitter.js:29-77).
EMIT_FIELDS: Dict[str, Tuple[torch.dtype, Any]] = {
    "x": (torch.float32, None),
    "y": (torch.float32, None),
    "z": (torch.float32, 0.0),
    "vx": (torch.float32, 0.0),
    "vy": (torch.float32, 0.0),
    "vz": (torch.float32, 0.0),
    "lifespan": (torch.float32, 1000.0),
    "gravity": (torch.float32, 0.15),
    "scale": (torch.float32, 1.0),
    "alpha": (torch.float32, 1.0),
    "tint": (torch.int64, 0xFFFFFF),  # a uint32 held as int64
    "texture_id": (torch.int32, 0),
    "fade_on_the_floor": (torch.float32, 0.0),
    "stay_on_the_floor": (torch.bool, False),
}


def _on_device(value, device) -> torch.Tensor:
    """A tick's output value as a tensor on ``device``. A Python number is
    filled there, in the dtype ``torch.as_tensor`` would give it: copying it
    from host memory would make every frame wait for the card."""
    if isinstance(value, (bool, int, float)):
        return torch.full((), value, device=device)
    return torch.as_tensor(value, device=device)


def _emit_block(out_emit: Dict[str, Any], klass: type, start: int, count: int,
                world: World, live: torch.Tensor) -> Dict[str, Any]:
    """One class's ``"emit"`` output as a dense request block
    (behavior.py:546-586): every field ``[count, emit_cap]``, and the slot
    mask ``k < clip(count_i, 0, emit_cap)`` of the live rows ``live``."""
    unknown = set(out_emit) - set(EMIT_FIELDS) - {"count"}
    if unknown:
        raise KeyError(
            f"{klass.__name__}.tick 'emit' request has unknown fields "
            f"{sorted(unknown)}; allowed: count, {sorted(EMIT_FIELDS)}"
        )
    device = world.device
    cap = max(1, int(getattr(klass, "emit_cap", 1)))
    n_req = out_emit.get("count", 1)
    n_req = torch.clamp(_on_device(n_req, device).to(torch.int32), 0, cap)
    n_req = torch.broadcast_to(n_req, (count,))
    slot = torch.arange(cap, dtype=torch.int32, device=device)
    valid = (slot[None, :] < n_req[:, None]) & live[:, None]
    fields: Dict[str, torch.Tensor] = {}
    for key, (dtype, default) in EMIT_FIELDS.items():
        v = out_emit.get(key)
        if v is None:
            v = (read_field(world, f"transform.{key}")[start:start + count]
                 if default is None else default)
        v = _on_device(v, device).to(dtype)
        if v.ndim == 1:  # per entity
            v = v[:, None]
        fields[key] = torch.broadcast_to(v, (count, cap))
    return {"fields": fields, "valid": valid}


def run_logic_phase(
    world: World,
    nbr,
    inputs: InputState,
    cfg: EngineConfig,
    type_ranges: Sequence[Tuple[type, int, int]],
    payload_channels: Optional[Dict[str, int]] = None,
) -> Tuple[World, List[Dict[str, Any]]]:
    """Run each class's tick over its slot range, masked by ``active``
    (logic_worker.js:337-369). ``type_ranges``: (EntityClass, start, count).
    ``nbr``: one :class:`NeighborLists` over all rows, sliced per class, or
    the per-class dict of ``neighbor_lists_by_class`` (a class missing from
    it ticks against empty lists). Every tick reads the pre-tick world; the
    writes are applied after all classes ran, as in the reference. A tick's
    ``"despawn"`` key clears the entity's active flags. Returns (world,
    emissions): one request block per class whose tick returned ``"emit"``,
    in registration order. Each class's tick runs inside the span
    ``behavior.<class name>``."""
    writes: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    emissions: List[Dict[str, Any]] = []
    despawn = None
    device = world.device

    for klass, start, count in type_ranges:
        tick_fn = _tick_fn(klass)
        if tick_fn is None or count == 0:
            continue
        if isinstance(nbr, dict):
            lists = nbr.get(klass.__name__)
            if lists is None:
                ids = torch.full((count, 1), -1, dtype=torch.int32, device=device)
                d2 = torch.zeros((count, 1), dtype=torch.float32, device=device)
                cnt = torch.zeros((count,), dtype=torch.int32, device=device)
                payload = torch.zeros((count, 1, 0), dtype=torch.float32, device=device)
            else:
                ids, d2, cnt, payload = lists.ids, lists.d2, lists.count, lists.payload.data
        else:
            sl = slice(start, start + count)
            ids, d2, cnt = nbr.ids[sl], nbr.d2[sl], nbr.count[sl]
            payload = nbr.payload.data[sl]
        idx = torch.arange(start, start + count, dtype=torch.int32, device=device)
        ctx = TickCtx(idx, world, ids, d2, cnt, inputs, cfg.dt_ratio, cfg,
                      neighbor_payload=payload if payload.shape[-1] > 0 else None,
                      payload_channels=payload_channels,
                      self_view=_entity_view(world, start, count))
        with span(f"behavior.{klass.__name__}"):
            outs = tick_fn(ctx) or {}
        active_slice = world.transform.active[start:start + count]

        for path, value in outs.items():
            if path == "emit":
                emissions.append(_emit_block(value, klass, start, count, world, active_slice))
                continue
            if path == "despawn":
                dm = torch.zeros_like(world.transform.active)
                dm[start:start + count] = _on_device(value, device) & active_slice
                despawn = dm if despawn is None else despawn | dm
                continue
            arr = read_field(world, path)
            value = _on_device(value, device).to(arr.dtype)
            value = torch.broadcast_to(value, (count,))
            mask, vals = writes.get(path, (None, None))
            if mask is None:
                mask = torch.zeros(arr.shape[0], dtype=torch.bool, device=device)
                vals = torch.zeros_like(arr)
            mask[start:start + count] = active_slice
            vals[start:start + count] = torch.where(
                active_slice, value, vals[start:start + count]
            )
            writes[path] = (mask, vals)

    for path, (mask, vals) in writes.items():
        world = write_field(world, path, torch.where(mask, vals, read_field(world, path)))
    if despawn is not None:
        world = apply_despawn_mask(world, despawn)
    return world, emissions


def run_logic_phase_masked(
    world: World,
    nbr: NeighborLists,
    inputs: InputState,
    cfg: EngineConfig,
    type_specs: Sequence[Tuple[type, int]],
    payload_channels: Optional[Dict[str, int]] = None,
    gather_fn=None,
) -> Tuple[World, List[Dict[str, Any]]]:
    """:func:`run_logic_phase` for rows in arbitrary order (the reference's
    behavior.py:723-811): the halo step's slab rows, where class slot
    ranges do not exist. ``type_specs``: (EntityClass, entity_type id).
    Every class's tick runs over all rows, with ``nbr`` covering all rows,
    and is merged under ``active & entity_type == id``; writes apply after
    every class ran; ``"despawn"`` clears the active flags.

    A tick sees ``ctx.i`` as the local row index (behavior.py:758), not
    the row's global id. ``gather_fn``: the resolver of ``ctx.gather`` for global neighbour ids
    (the halo step's, over the home chunks). Returns (world, emissions),
    each class's ``"emit"`` block over all rows, live where the class's
    mask is (behavior.py:790-793)."""
    writes: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    emissions: List[Dict[str, Any]] = []
    despawn = None
    n = world.transform.x.shape[0]
    device = world.device
    row_ids = torch.arange(n, dtype=torch.int32, device=device)
    view = _entity_view(world, 0, n)
    payload = nbr.payload.data
    for klass, type_id in type_specs:
        tick_fn = _tick_fn(klass)
        if tick_fn is None:
            continue
        ctx = TickCtx(row_ids, world, nbr.ids, nbr.d2, nbr.count, inputs, cfg.dt_ratio,
                      cfg, neighbor_payload=payload if payload.shape[-1] > 0 else None,
                      payload_channels=payload_channels, self_view=view,
                      gather_fn=gather_fn)
        outs = tick_fn(ctx) or {}
        mask_cls = world.transform.active & (world.transform.entity_type == type_id)
        for path, value in outs.items():
            if path == "emit":
                emissions.append(_emit_block(value, klass, 0, n, world, mask_cls))
                continue
            if path == "despawn":
                dm = _on_device(value, device) & mask_cls
                despawn = dm if despawn is None else despawn | dm
                continue
            arr = read_field(world, path)
            value = torch.broadcast_to(_on_device(value, device).to(arr.dtype), (n,))
            mask, vals = writes.get(path, (None, None))
            if mask is None:
                mask = torch.zeros(n, dtype=torch.bool, device=device)
                vals = torch.zeros_like(arr)
            writes[path] = (mask | mask_cls, torch.where(mask_cls, value, vals))

    for path, (mask, vals) in writes.items():
        world = write_field(world, path, torch.where(mask, vals, read_field(world, path)))
    if despawn is not None:
        world = apply_despawn_mask(world, despawn)
    return world, emissions


class NotLayoutSafe(Exception):
    """Raised by :class:`ForceTickCtx` when a tick touches state that does
    not exist in the solver's position layout (neighbours, other
    components, the world): the class then disqualifies from
    ``physics.position_residency`` and the scatter-per-frame path runs."""


#: self-field paths a layout-evaluated tick may read (present in the
#: resident layout, or zero at tick time: the Verlet zeroes ax/ay every
#: frame, physics_worker.js:240-316)
_LAYOUT_READABLE = {
    "transform.x", "transform.y", "rigid_body.ax", "rigid_body.ay",
}
#: paths a layout-evaluated tick may write (forces consumed by the Verlet)
LAYOUT_WRITABLE = {"rigid_body.ax", "rigid_body.ay"}


class ForceTickCtx:
    """The TickCtx stand-in for evaluating a tick over SOLVER LAYOUT slots
    (``physics.position_residency``): exactly the state that exists per
    slot -- id, position, zeroed accelerations, the input snapshot, config
    -- and :class:`NotLayoutSafe` on anything else. ``i``, ``x`` and ``y``
    are one batch: the flattened layout (ids decoded from the meta) or, for
    the probe, 0-dim tensors."""

    __slots__ = ("i", "_x", "_y", "inputs", "dt_ratio", "config")

    def __init__(self, i, x, y, inputs: InputState, dt_ratio, config: EngineConfig):
        self.i = i
        self._x = x
        self._y = y
        self.inputs = inputs
        self.dt_ratio = dt_ratio
        self.config = config

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self._x.device)

    def field(self, path: str) -> torch.Tensor:
        path = FIELD_ALIASES.get(path, path)
        if path == "transform.x":
            return self._x
        if path == "transform.y":
            return self._y
        if path in ("rigid_body.ax", "rigid_body.ay"):
            return self._zero()
        raise NotLayoutSafe(path)

    @property
    def x(self): return self._x
    @property
    def y(self): return self._y
    @property
    def ax(self): return self._zero()
    @property
    def ay(self): return self._zero()

    def __getattr__(self, name):  # any other accessor disqualifies
        raise NotLayoutSafe(name)

    @property
    def mouse_x(self): return self.inputs.mouse_x
    @property
    def mouse_y(self): return self.inputs.mouse_y
    @property
    def mouse_down(self): return self.inputs.mouse_buttons[0]

    def key(self, name: str) -> torch.Tensor:
        return self.inputs.keys[key_index(name)]


def _tick_fn(klass: type):
    tick = getattr(klass, "tick", None)
    return tick.__func__ if isinstance(tick, (staticmethod, classmethod)) else tick


def probe_layout_safe(klass: type, cfg: EngineConfig) -> bool:
    """Decide at plan time whether a class's tick can evaluate in solver
    layout space: it reads only what :class:`ForceTickCtx` exposes and
    writes only rigid_body.ax/ay (no despawn or other side effects). The
    tick is called once on 0-dim CPU tensors; any exception makes it unsafe,
    as the reference's abstract probe does."""
    if getattr(klass, "tick", None) is None:
        return True  # nothing to evaluate: contributes zero force
    if getattr(klass, "uses_neighbors", True):
        return False
    from .inputs import InputController

    ctx = ForceTickCtx(
        torch.zeros((), dtype=torch.int32), torch.zeros(()), torch.zeros(()),
        InputController().snapshot("cpu"), cfg.dt_ratio, cfg,
    )
    try:
        out = _tick_fn(klass)(ctx) or {}
    except Exception:
        return False
    keys = {FIELD_ALIASES.get(k, k) for k in out}
    return keys <= LAYOUT_WRITABLE


def eval_layout_forces(
    force_specs: Sequence[Tuple[Callable, int, int]],
    gx: torch.Tensor,
    gy: torch.Tensor,
    gid: torch.Tensor,
    inputs: InputState,
    cfg: EngineConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate layout-safe tick forces directly over layout slots.
    ``force_specs``: (tick_fn, start, count) per qualified ticking class.
    Each tick runs once on the flattened layout as one batch, with ``i`` the
    decoded gid, and its result is merged under the class's gid-range mask.
    Empty slots decode to gid 0 and never consume a force (the Verlet masks
    by the moving flag). Elementwise, so bit-exact with the entity-order
    evaluation of the same tick."""
    shape = gx.shape
    axf = torch.zeros(gx.numel(), dtype=torch.float32, device=gx.device)
    ayf = torch.zeros_like(axf)
    if not force_specs:
        return axf.view(shape), ayf.view(shape)
    fx, fy, fid = gx.reshape(-1), gy.reshape(-1), gid.reshape(-1)
    for tick_fn, start, count in force_specs:
        out = tick_fn(ForceTickCtx(fid, fx, fy, inputs, cfg.dt_ratio, cfg)) or {}
        norm = {FIELD_ALIASES.get(k, k): v for k, v in out.items()}

        def value(path):
            v = norm.get(path)
            if v is None:
                return torch.zeros_like(fx)
            v = torch.as_tensor(v, device=gx.device)
            return torch.broadcast_to(v.to(torch.float32), fx.shape)

        m = (fid >= start) & (fid < start + count)
        axf = torch.where(m, value("rigid_body.ax"), axf)
        ayf = torch.where(m, value("rigid_body.ay"), ayf)
    return axf.view(shape), ayf.view(shape)


def apply_despawn_mask(world: World, mask: torch.Tensor) -> World:
    """In-step despawn: clear every per-component active flag
    (gameObject.js:668-691). The host reconciles its free lists later
    (Engine.reconcile_pools)."""

    def off(comp):
        return comp.replace(active=torch.where(mask, False, comp.active))

    return world.replace(
        transform=off(world.transform),
        rigid_body=off(world.rigid_body),
        collider=off(world.collider),
        sprite=off(world.sprite),
        light=off(world.light),
        shadow=off(world.shadow),
    )
