"""The Engine — host orchestrator and Scene API, on an explicit device.

PyTorch counterpart of the core of ``multithreadedgameengine_tpu/engine.py``:
entity-class registration with parent-chain registration, ``init``, the
spawn/despawn control plane (``spawn``, ``spawn_batch``, ``despawn``,
``_apply_columns``), ``step(n)``, ``snapshot``/``restore``, ``stats``,
``update_physics_config``, the Mouse as entity 0 and ``apply_inputs``.

One frame (the reference's ``one_step_impl`` with the grid solver and no
neighbour lists, engine.py:1460-1824), run eagerly:

1. ``apply_inputs`` writes the mouse as entity 0;
2. ``behavior.run_logic_phase`` runs the ticks;
3. ``render.extract.advance_animation``;
4. physics: ``ops.physics.physics_step`` (Verlet move, the grid solver,
   derived properties), or with position residency
   ``ops.physics_grid.resident_persistent_step`` then ``update_derived``;
5. ``ops.culling.update_entity_visibility`` and the step metrics.

The plan (``_build_plan``, the reference's ``_build_step``) resolves what
the reference resolves before tracing: the solver geometry; solver "auto"
as "pallas", the resident solver; the pair kernel (K1, or K2 where the
reference's gate picks it, ``physics_grid.use_symmetric``); the bin and
attribute caches of ``rebin_interval > 1``; position residency; the banded
boundary; and whether ``step(n)`` runs the lazy-readback chunk.

``device`` is required: ``"cuda"`` runs the CUDA kernels, ``"cpu"`` their
plain PyTorch versions. There is no automatic choice.

Configurations outside the ported slices raise ``NotImplementedError``
naming their ROADMAP item (see ``_check_supported``); nothing is silently
ignored.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
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
    probe_layout_safe,
    read_field,
    run_logic_phase,
    write_field,
)
from .components import Collider, MouseComponent
from .config import EngineConfig, make_config
from .inputs import InputController, InputState
from .ops.culling import update_entity_visibility
from .ops.physics import physics_step, update_derived
from .ops.physics_grid import (
    bins_expired,
    layout_shape,
    resident_lazy_frame,
    resident_persistent_step,
    resident_sync_entity,
    solver_geometry,
    use_symmetric,
)
from .render.extract import advance_animation
from .rng import Mulberry32
from .state import EntityPool, World, make_world, scatter_fields


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP: {item})")


def _check_supported(cfg: EngineConfig) -> None:
    """Refuse every configuration the ported slice does not run."""
    ph, lg = cfg.physics, cfg.logic
    if ph.solver == "neighbors":
        _refuse("physics.solver='neighbors'", "slice C, item 12")
    if lg.collision_events or lg.screen_events:
        _refuse("logic.collision_events / logic.screen_events", "slice C, item 13")
    if cfg.particle.max_particles > 0 or cfg.particle.decals:
        _refuse("particles and decals", "slice C, item 14")
    if cfg.lighting.enabled:
        _refuse("lighting", "slice C, item 14")


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
        "sprite": dict(
            active=True, tint=0xFFFFFF, base_tint=0xFFFFFF, alpha=1.0,
            scale_x=1.0, scale_y=1.0, anchor_x=0.5, anchor_y=1.0,
            render_visible=True, is_on_screen=True, render_dirty=True,
        ),
    }

    def __init__(self, config: Optional[EngineConfig] = None, *, device, **kwargs):
        if config is None:
            config = make_config(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config object or kwargs, not both")
        self.config = config.validated()
        _check_supported(self.config)
        self.device = torch.device(device)
        self.rng = Mulberry32(self.config.seed)
        self.input = InputController()
        # center camera on world (gameEngine.js camera init)
        self.input.camera_x = self.config.world_width / 2
        self.input.camera_y = self.config.world_height / 2

        self.classes: "OrderedDict[str, RegisteredClass]" = OrderedDict()
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
        self._step_seconds: deque = deque(maxlen=60)
        self.total_steps = 0
        # frames that step(n)'s lazy chunk ran without the entity read-back
        self.lazy_frames = 0

        # Mouse registered first so entity index 0 is the mouse
        self.register_entity_class(Mouse, 1)

    # ------------------------------------------------------------------
    # registration (gameEngine.js:292-366, :389-457)
    # ------------------------------------------------------------------
    def register_entity_class(self, cls: type, count: int) -> None:
        if self._initialized:
            raise RuntimeError("register_entity_class must precede init()")
        if not issubclass(cls, EntityClass):
            raise TypeError(f"{cls.__name__} must subclass EntityClass")
        if getattr(cls, "tick", None) is not None and cls.uses_neighbors and count > 0:
            _refuse(f"{cls.__name__}: a tick that reads neighbours "
                    "(uses_neighbors=True)", "slice C, item 11")
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
            if comp not in BUILTIN_PATHS:
                _refuse(f"{cls.__name__}: component {comp.__name__}",
                        "slice C, item 14 (custom, light and shadow components)")
            paths.append(BUILTIN_PATHS[comp])
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
        world = make_world(n, self.device)
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
            ctx = SetupCtx(self.config, reg.start_index, reg.count, self.rng)
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
        self._require_init()
        reg = self.classes[class_name]
        i = reg.pool.claim()
        if i is None and self.reconcile_pools():
            i = reg.pool.claim()
        if i is None:
            return None

        updates: Dict[str, Any] = dict(reg.reset_template)
        for key, value in spawn_config.items():
            path = FIELD_ALIASES.get(key, key)
            if "." not in path:
                raise KeyError(f"unknown spawn property {key!r}")
            updates[path] = value
        extra = reg.cls.on_spawned(SpawnCtx(self.config, i, self.rng), dict(spawn_config)) or {}
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
        self._pending_ops.append(("spawn", i, updates))
        return i

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
        reg = self.classes[class_name]
        claimed = reg.pool.claim_many(count)
        if claimed.size < count and self.reconcile_pools(exclude=claimed):
            claimed = np.concatenate([claimed, reg.pool.claim_many(count - claimed.size)])
        n = int(claimed.size)
        if n == 0:
            return np.empty((0,), np.int32)
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
            out = batch_hook(BatchSpawnCtx(self.config, idx, self.rng), cfg_arrays) or {}
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
                ctx = SpawnCtx(self.config, int(idx[k]), self.rng)
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
        self.world = self._apply_columns(
            self.world, {path: (idx, vals) for path, vals in columns.items()}
        )
        return idx

    def despawn(self, index: int) -> None:
        """Despawn by index (gameObject.js:668-691); a no-op on an index that
        is already free (the reference's double-despawn guard)."""
        self._require_init()
        reg = self._class_of_index(index)
        if reg.pool.release(index):
            reg.cls.on_despawned(index)
            self._pending_ops.append(("despawn", index, None))

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
        """Apply queued spawn/despawn writes."""
        if not self._pending_ops:
            return
        ops, self._pending_ops = self._pending_ops, []
        self.world = self._apply_columns(self.world, self._ops_to_columns(ops))

    def _despawn_updates(self, index: int) -> Dict[str, Any]:
        """Per-component active-flag clears for one despawned index."""
        reg = self._class_of_index(index)
        updates = {"transform.active": False}
        for comp_path in reg.component_paths:
            if hasattr(getattr(self.world, comp_path), "active"):
                updates[f"{comp_path}.active"] = False
        return updates

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
        for path, (np_idx, np_vals) in columns.items():
            comp_name, _, field = path.partition(".")
            idx = torch.from_numpy(np.asarray(np_idx, np.int64)).to(self.device)
            vals = torch.from_numpy(np.asarray(np_vals).astype(np.float32)).to(self.device)
            comp = scatter_fields(getattr(world, comp_name), idx, {field: vals})
            world = world.replace(**{comp_name: comp})
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
    def _solver_plan(self, cfg: EngineConfig):
        """The grid solver's geometry from the registered radii."""
        radii = self.world.collider.radius.cpu().numpy()
        r_world = float(radii.max()) if radii.size else 0.0
        max_r = max(self._max_radius, r_world)
        if max_r <= 0:
            # the reference falls back to its neighbour-list solver here
            _refuse("a scene with no collider radius (neighbour-list solver)",
                    "slice C, item 12")
        present = radii[radii > 0]
        mean_r = float(present.mean()) if present.size else max_r
        self._solver_radius_bound = max_r
        return solver_geometry(cfg, max_r, mean_radius=mean_r)

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
        their stamps reset so the next frame rebins; residency; the band."""
        cfg = self.config
        if cfg.physics.solver == "auto":
            cfg = dataclasses.replace(
                cfg, physics=dataclasses.replace(cfg.physics, solver="pallas"))
            self.config = cfg
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
        geom = self._solver_plan(cfg)
        shape = layout_shape(geom)
        pallas = ph.solver == "pallas"

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
        return StepPlan(
            cfg=cfg,
            solver_geom=geom,
            type_ranges=tuple(
                (reg.cls, reg.start_index, reg.count)
                for reg in self.classes.values() if reg.count > 0
            ),
            # no sprite sheets are registered in the port (rendering is not
            # ported), so every animation has one frame
            frame_counts=torch.ones((1, 1), dtype=torch.int32, device=dev),
            symmetric=use_symmetric(cfg, geom),
            residency=residency,
            force_specs=specs or (),
            pin_rows=pin_rows,
            # the Verlet clamp bounds per-frame drift; a later host write of
            # a larger max_vel re-plans (_track_radius)
            band_vel_bound=(max(100.0, self._max_vel_seen)
                            if residency and ph.boundary_band == "auto" else 0.0),
        )

    def _one_step(self, world: World, inputs: InputState) -> Tuple[World, Dict[str, torch.Tensor]]:
        plan = self._plan
        cfg = plan.cfg
        world = apply_inputs(world, inputs)
        world = run_logic_phase(world, inputs, cfg, plan.type_ranges)
        world = advance_animation(world, plan.frame_counts, cfg.dt_ratio)
        if plan.residency:
            world, _n_binned, solver_overflow, band_drift = resident_persistent_step(
                world, cfg, plan.solver_geom, inputs, plan.force_specs,
                cfg.dt_ratio, plan.pin_rows, plan.band_vel_bound,
            )
            world = update_derived(world, cfg)
        else:
            world, solver_overflow = physics_step(world, cfg, cfg.dt_ratio, plan.solver_geom)
            band_drift = torch.zeros((), dtype=torch.int32, device=self.device)
        world = update_entity_visibility(world, cfg, inputs)
        world = world.replace(step_count=world.step_count + 1)
        t = world.transform
        metrics = {
            "active_count": torch.sum(t.active, dtype=torch.int32),
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
        return world, metrics

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

    def step(self, n: int = 1, block: bool = False) -> Dict[str, torch.Tensor]:
        """Advance ``n`` frames with the inputs of this call (the reference
        freezes the input snapshot for a chunk of frames the same way).
        Queued spawns/despawns apply first. Returns the last frame's metrics
        as device tensors; ``block=True`` waits for the device.

        With position residency and ``n > 1`` this is the reference's
        lazy-readback chunk (engine.py:1833-1899): a frame is full (entity
        order synced from the layout, then the eager frame) when it is the
        call's last, the layout is stale or the bins have expired; every
        other frame runs in the layout alone. ``boundary_band_drift`` is then
        the chunk's maximum. Bit-exact with ``n`` single steps."""
        self._require_init()
        if n <= 0:
            return self.metrics
        # the plan is built before the queued writes land, as the reference
        # builds its step before flushing (engine.py:2555-2558): the first
        # step's geometry sees the spawns' radii only through _max_radius
        if self._plan is None:
            self._plan = self._build_plan()
        self._flush_pending()
        if self._plan is None:  # the flush wrote a radius above the bound
            self._plan = self._build_plan()
        plan = self._plan
        inputs = self.input.snapshot(self.device)
        t0 = time.perf_counter()
        world = self.world
        if plan.residency and n > 1:
            interval = max(2, plan.cfg.physics.rebin_interval)
            drift = torch.zeros((), dtype=torch.int32, device=self.device)
            for i in range(n):
                if (i == n - 1 or world.solver_pos_step != world.step_count
                        or bins_expired(world, interval)):
                    world, metrics = self._one_step(resident_sync_entity(world), inputs)
                    drift = torch.maximum(metrics["boundary_band_drift"], drift)
                    metrics["boundary_band_drift"] = drift
                else:
                    world, frame_drift = self._lazy_frame(world, inputs)
                    drift = torch.maximum(drift, frame_drift)
                    self.lazy_frames += 1
        else:
            for _ in range(n):
                world, metrics = self._one_step(world, inputs)
        self.world, self.metrics = world, metrics
        if block:
            self.sync()
        self._step_seconds.append((time.perf_counter() - t0) / n)
        self.total_steps += n
        return metrics

    def sync(self) -> None:
        """Wait for all queued device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stats(self) -> Dict[str, Any]:
        """The stats-panel analog (gameEngine.js:1326-1381): moving-average
        steps/s over the last 60 step() calls (host clock; enqueue time unless
        those calls blocked), pools, and the last metrics."""
        avg = sum(self._step_seconds) / len(self._step_seconds) if self._step_seconds else 0.0
        out = {
            "steps_per_sec": 1.0 / avg if avg > 0 else 0.0,
            "ms_per_step": 1000.0 * avg,
            "total_steps": self.total_steps,
            "pools": {name: self.get_pool_stats(name) for name in self.classes},
        }
        for key, value in self.metrics.items():
            out[key] = int(value)
        return out

    def update_physics_config(self, **kwargs) -> None:
        """Live physics updates: ``engine.update_physics_config(gravity=(0, 1))``."""
        phys = dataclasses.replace(self.config.physics, **kwargs).validated()
        cfg = dataclasses.replace(self.config, physics=phys)
        _check_supported(cfg)
        self.config = cfg
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
    # parts of the reference engine that are not ported yet
    # ------------------------------------------------------------------
    def begin_plan(self, *args, **kwargs):
        _refuse("FramePlan", "slice D, item 15")

    run_plan = begin_plan

    def save_checkpoint(self, *args, **kwargs):
        _refuse("checkpoints", "slice D, item 16")

    load_checkpoint = save_checkpoint

    def render_packet(self, *args, **kwargs):
        _refuse("render extraction and rendering", "slice D, item 17")

    screenshot = render_packet

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("call init() first")
