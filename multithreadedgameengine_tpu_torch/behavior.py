"""Entity classes and the batched logic phase — the GameObject/tick() analog.

PyTorch counterpart of ``multithreadedgameengine_tpu/behavior.py``
(behavior.py:58-386, 596-722): :class:`EntityClass` with its host hooks
(``setup``, ``on_spawned``, ``on_spawned_batch``, ``on_despawned``), the
host contexts, field addressing by ``"component.field"`` path, and
:func:`run_logic_phase`.

Where the reference vmaps a per-entity tick, the port hands the tick each
class's contiguous slice of the batch: ``ctx.x`` is the ``[count]`` tensor of
the class's x values, ``ctx.mouse_x`` a 0-dim tensor, and the tick returns
``[count]`` tensors (or scalars, broadcast). Ticks are written in torch.

For position residency the module also ports the layout-evaluated ticks
(behavior.py:387-522): :class:`ForceTickCtx`, :func:`probe_layout_safe` and
:func:`eval_layout_forces`, which runs a layout-safe tick once over the
flattened solver layout instead of ``vmap``-ing it over slots.

Not ported yet, and refused with ``NotImplementedError``: neighbour views
(``uses_neighbors`` ticks, ROADMAP slice C item 11), the ``"emit"`` tick
key (particles, slice C item 14) and custom components.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .components import (
    Collider,
    MouseComponent,
    RigidBody,
    SpriteRenderer,
    Transform,
)
from .config import EngineConfig
from .inputs import InputState, key_index
from .state import World


# World attribute name for each built-in component class
BUILTIN_PATHS = {
    Transform: "transform",
    RigidBody: "rigid_body",
    Collider: "collider",
    SpriteRenderer: "sprite",
    MouseComponent: "mouse",
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


def resolve_field(world: World, path: str) -> Tuple[Any, str, str]:
    """Resolve 'component.field' (or an alias) to (component, comp_attr,
    field)."""
    path = FIELD_ALIASES.get(path, path)
    comp_name, _, field = path.partition(".")
    if not field:
        raise KeyError(f"field path {path!r} must be 'component.field'")
    if comp_name not in BUILTIN_PATHS.values():
        raise KeyError(f"unknown component {comp_name!r} in path {path!r}")
    comp = getattr(world, comp_name)
    if not hasattr(comp, field):
        raise KeyError(f"component {comp_name!r} has no field {field!r}")
    return comp, comp_name, field


def read_field(world: World, path: str) -> torch.Tensor:
    comp, _, field = resolve_field(world, path)
    return getattr(comp, field)


def write_field(world: World, path: str, value: torch.Tensor) -> World:
    comp, comp_name, field = resolve_field(world, path)
    return world.replace(**{comp_name: comp.replace(**{field: value})})


class EntityClass:
    """Base entity class. Subclass, declare ``components``, override hooks.
    Registration assigns ``entity_type`` ids in registration order and
    registers parent classes with count 0 (gameEngine.js:389-457)."""

    components: Sequence[Any] = ()

    #: whether the tick reads neighbour lists (not ported yet: a ticking
    #: class with uses_neighbors=True is refused)
    uses_neighbors: bool = True

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


class SetupCtx:
    """Host context for EntityClass.setup."""

    def __init__(self, config: EngineConfig, start: int, count: int, rng):
        self.config = config
        self.start = start
        self.count = count
        self.rng = rng  # shared Mulberry32 stream

    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.start + self.count)


class SpawnCtx:
    """Host context for EntityClass.on_spawned."""

    def __init__(self, config: EngineConfig, index: int, rng):
        self.config = config
        self.index = index
        self.rng = rng


class BatchSpawnCtx:
    """Host context for EntityClass.on_spawned_batch; ``rng.draw(k)``
    consumes exactly the draws ``len(indices)`` on_spawned calls would."""

    def __init__(self, config: EngineConfig, indices, rng):
        self.config = config
        self.indices = indices  # np.int32[n], claim order
        self.rng = rng


class TickCtx:
    """The view handed to ``tick``: one class's slice of the batch.

    ``self_view`` holds every component's rows ``[start, start+count)``;
    ``x``, ``vx``, ``field(path)`` read from it. ``world`` and ``inputs`` are
    the whole pre-tick world and the frame's inputs."""

    __slots__ = ("i", "world", "inputs", "dt_ratio", "config", "self_view")

    def __init__(self, i: torch.Tensor, world: World, inputs: InputState,
                 dt_ratio: float, config: EngineConfig,
                 self_view: Dict[str, Any]):
        self.i = i  # int32[count] entity indices
        self.world = world
        self.inputs = inputs
        self.dt_ratio = dt_ratio
        self.config = config
        self.self_view = self_view

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
    """Every component's rows [start, start+count), as views."""
    return {
        name: getattr(world, name).map_tensors(lambda a: a[start:start + count])
        for name in BUILTIN_PATHS.values()
    }


def run_logic_phase(
    world: World,
    inputs: InputState,
    cfg: EngineConfig,
    type_ranges: Sequence[Tuple[type, int, int]],
) -> World:
    """Run each class's tick over its slot range, masked by ``active``
    (logic_worker.js:337-369). ``type_ranges``: (EntityClass, start, count).
    Every tick reads the pre-tick world; the writes are applied after all
    classes ran, as in the reference. A tick's ``"despawn"`` key clears the
    entity's active flags."""
    writes: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    despawn = None
    device = world.device

    for klass, start, count in type_ranges:
        tick = getattr(klass, "tick", None)
        if tick is None or count == 0:
            continue
        tick_fn = tick.__func__ if isinstance(tick, (staticmethod, classmethod)) else tick
        idx = torch.arange(start, start + count, dtype=torch.int32, device=device)
        ctx = TickCtx(idx, world, inputs, cfg.dt_ratio, cfg,
                      _entity_view(world, start, count))
        outs = tick_fn(ctx) or {}
        active_slice = world.transform.active[start:start + count]

        for path, value in outs.items():
            if path == "emit":
                raise NotImplementedError(
                    f"{klass.__name__}.tick returned 'emit': device particle "
                    "emission is not ported yet (ROADMAP slice C, item 14)"
                )
            if path == "despawn":
                dm = torch.zeros_like(world.transform.active)
                dm[start:start + count] = torch.as_tensor(value, device=device) & active_slice
                despawn = dm if despawn is None else despawn | dm
                continue
            arr = read_field(world, path)
            value = torch.as_tensor(value, device=device).to(arr.dtype)
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
    return world


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
    )
