"""Engine configuration.

One frozen, hashable config tree mirroring the reference engine's nested config
sections and defaults (reference: src/core/gameEngine.js:34-62 for physics
defaults, :99-104 for particles, :145-180 for lighting/decals;
src/core/utils.js:269-301 `validatePhysicsConfig` for clamping semantics).

Being frozen dataclasses of hashable leaves, any config can be passed as a jit
static argument; the whole tree is resolved once at `Engine` construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def _clamp01(v: float) -> float:
    return max(0.0, min(1.0, float(v)))


@dataclass(frozen=True)
class SpatialConfig:
    """Spatial hash grid parameters (reference: src/workers/spatial_worker.js:78-100).

    - ``cell_size``: world units per grid cell.
    - ``max_neighbors``: fixed neighbor-list degree K — the hard cap of the
      reference's ``[count, ids...]`` stride format (gameEngine.js:553-559).
    - ``cell_capacity``: TPU-only parameter: max entities binned per cell in the
      sort-and-scatter grid table (the reference uses growable JS arrays per
      cell; a static-shape device kernel needs a cap).
    - ``max_cell_radius``: static bound on the per-entity cell scan radius
      (``ceil(visual_range / cell_size)`` in the reference,
      spatial_worker.js:211). Entities whose visual range implies a larger
      radius still get *distance-correct* neighbors only within this many
      cells. Resolved at engine init from registered classes when 0.
    """

    cell_size: float = 80.0
    max_neighbors: int = 100
    cell_capacity: int = 64
    max_cell_radius: int = 0  # 0 = resolve from max visual_range at first step
    # 'grid' (sort-and-bin hash grid) or 'bruteforce' (O(N^2), for tests/small N)
    method: str = "grid"
    # per-class candidate assembly (each class's scan sized by its own
    # visual range, spatial_worker.js:207-211). Results are identical to the
    # single global-radius table either way. Default OFF: measured on v5e at
    # the predators operating point (15k prey S=576 vs global S=1600, 3
    # classes), the split tables LOST to one global table — noevents 17.0 vs
    # 13.5 ms/step, events 31.3 vs 19.8 — XLA fuses the one wide gather into
    # its consumers, while per-class materializes a [count, S_r, F] payload
    # per class. Opt in for scenes where a huge-range class dominates a
    # cell-major table that would otherwise blow the memory budget.
    per_class_assembly: bool = False


@dataclass(frozen=True)
class PhysicsConfig:
    """Verlet physics parameters (reference: src/workers/physics_worker.js:33-40
    defaults; src/core/utils.js:269-301 validation/clamping)."""

    sub_step_count: int = 4
    boundary_elasticity: float = 0.8
    collision_response_strength: float = 0.5
    verlet_damping: float = 0.995
    min_speed_for_rotation: float = 0.1
    gravity: Tuple[float, float] = (0.0, 0.0)
    max_collision_pairs: int = 10000
    # constraint backend: 'auto' (grid solver unless collision events are on),
    # 'grid', or 'neighbors' (reference-faithful neighbor-list solver).
    # TPU-only knob — the reference has a single solver.
    solver: str = "auto"
    # Newton-reciprocal pair kernel (5 forward offsets, each pair resolved
    # once): ~45% fewer kernel iterations than the two-sided enumeration.
    # Per-pair forces are bit-identical; only the fp accumulation ORDER
    # into a slot differs (~1e-6 relative on positions; contact counts stay
    # exact). False pins the two-sided kernel whose accumulation order is
    # bit-exact with the XLA grid solver (the conformance tests' oracle).
    solver_symmetric: bool = True
    # Occupancy-predicated symmetric kernel selection. The predicated
    # kernel loops (offset, j, i) planes with per-plane skip flags — a big
    # win when layout lanes are wide (1M-balls: pair pass 9.8 -> 7.0 ms at
    # cols_pad 1280) but scalar-loop overhead-bound when each plane op is
    # tiny (10k-balls: +0.5 ms/step at cols_pad 128, measured). "auto"
    # uses it only when the padded lane width is >= 512; "on"/"off" force
    # it (tests pin "on" at small scale to keep the kernel covered).
    # With the predicated kernel off, the two-sided full-block kernel runs
    # (which is also the bit-exact XLA-parity formulation).
    solver_predicated: str = "auto"
    # solver-grid cell capacity override (0 = size from the radius
    # distribution, ops/physics_grid.py solver_geometry). Pair-kernel work
    # and layout memory scale with capacity; scenes whose settled occupancy
    # is known (profile_1m_inloop.py prints the histogram) can pin a tighter
    # cap — entities beyond a cell's capacity degrade to boundary-only for
    # the frame and show in the `solver_overflow` metric.
    solver_capacity: int = 0
    # Rebin the grid solver every k-th frame instead of every frame (1 =
    # every frame). Between rebins, entities keep their cell/slot from the
    # last binning while positions stay current — the same one-frame-stale
    # candidate semantics the reference ships (its physics worker consumes
    # neighbor lists the spatial worker built on ITS previous frame, an
    # accepted race: physics_worker.js:379-383). Fast movers can miss pairs
    # for up to k-1 frames (the reference misses them for 1). Host-side
    # spawns/despawns/writes invalidate the cache (see the ghost note
    # below), so only IN-STEP evolution rides stale bins. Saves the
    # per-frame binning sort at large N (the #2 cost of the 1M-entity
    # step).
    # Keep positions RESIDENT in the pallas solver's slot-major layout
    # ACROSS frames: Verlet move and (layout-safe) tick forces evaluate in
    # layout space, deleting the per-frame x/y entity→layout scatters that
    # were the largest remaining cost of the 1M-entity step (~13 ms/frame
    # measured on v5e, docs/parity_status.md). "auto" enables it when the
    # pallas solver is active, rebin_interval > 1, and every ticking
    # class's tick is layout-safe (reads only self x/y/ax/ay + inputs +
    # config, writes only rigid_body.ax/ay — probed at build time);
    # "on" forces the probe to be honored but errors if a tick is unsafe;
    # "off" always uses the scatter-per-frame path. Between host
    # mutations, entity-order px/py are stale (synced on demand by
    # snapshot/checkpoint/spawn paths); host mutations force a fresh
    # rebin, which also drops despawn ghosts immediately (stricter than
    # the plain attr-cache path below). Results are bit-exact with
    # position_residency="off" — tests/test_round4.py asserts it.
    position_residency: str = "auto"
    # Despawn-ghost window (pallas solver only): the resident path also
    # caches the attribute layouts between rebins, so an entity despawned
    # IN-STEP (a tick returning {"despawn": True}) keeps its cached
    # active-collider bit and acts as a frozen ghost collider until the
    # next rebin (up to k-1 frames). HOST-side mutations (spawn/despawn/
    # field writes between steps) invalidate the bin cache and re-bin the
    # next frame, so host despawns drop out immediately and host spawns
    # collide from their first frame. The XLA 'grid' backend rebuilds
    # attributes fresh each frame (only bins are cached) and has no ghost
    # window at all — the two backends intentionally diverge for in-step
    # despawns. Avoid rebin_interval > 1 in scenes with heavy in-step
    # despawning.
    rebin_interval: int = 1
    # Banded world boundary for the resident pallas path (round 4): the
    # position clamp folds into the pair kernel's VMEM tiles (every slot,
    # every substep) and the px/py bounce writes shrink to the layout's
    # world-border bands — sized from the Verlet max_vel drift bound so
    # they cover every entity that can possibly clamp between rebins
    # (ops/physics_grid.resident_persistent_step docs; the full-layout
    # boundary pass cost ~3.2 ms/frame of the 1M step's ~28 ms floor).
    # Bit-exact with "off" while the drift bound holds; violations are
    # counted in the `boundary_band_drift` metric. "off" keeps the
    # full-layout clamp every substep.
    boundary_band: str = "auto"

    def validated(self) -> "PhysicsConfig":
        """Mirror of validatePhysicsConfig (utils.js:269-301), plus the
        TPU-only solver knob."""
        if self.solver not in ("auto", "grid", "neighbors", "pallas"):
            raise ValueError(
                "physics.solver must be 'auto', 'grid', 'neighbors' or "
                f"'pallas', got {self.solver!r}"
            )
        if self.solver_predicated not in ("auto", "on", "off"):
            raise ValueError(
                "physics.solver_predicated must be 'auto', 'on' or 'off', "
                f"got {self.solver_predicated!r}"
            )
        if self.position_residency not in ("auto", "on", "off"):
            raise ValueError(
                "physics.position_residency must be 'auto', 'on' or 'off', "
                f"got {self.position_residency!r}"
            )
        if self.boundary_band not in ("auto", "off"):
            raise ValueError(
                "physics.boundary_band must be 'auto' or 'off', got "
                f"{self.boundary_band!r}"
            )
        if self.solver_capacity > 64:
            # the pair kernel's i-plane count / VMEM scratch scale with
            # capacity; refuse instead of silently clamping (scenes that
            # genuinely pack >64 entities per cell need a smaller cell or
            # the neighbor-list solver)
            raise ValueError(
                f"physics.solver_capacity must be <= 64, got "
                f"{self.solver_capacity}"
            )
        return dataclasses.replace(
            self,
            sub_step_count=max(1, int(self.sub_step_count)),
            boundary_elasticity=_clamp01(self.boundary_elasticity),
            collision_response_strength=_clamp01(self.collision_response_strength),
            verlet_damping=_clamp01(self.verlet_damping),
            solver_capacity=max(0, int(self.solver_capacity)),
            rebin_interval=max(1, int(self.rebin_interval)),
        )


@dataclass(frozen=True)
class LogicConfig:
    """Logic-scheduling section. The reference's worker-count / job-size knobs
    (gameEngine.js:62, :744-761) have no meaning for an SPMD device program —
    they are kept for config-surface parity and ignored by the TPU runtime
    (documented no-ops), except ``collision_events`` which gates the
    Enter/Stay/Exit pair-diff machinery (logic_worker.js:417-526)."""

    number_of_logic_workers: int = 1
    number_of_entities_per_job: int = 250
    use_main_thread_as_logic_worker: bool = False
    main_thread_max_jobs_per_frame: int = 0
    collision_events: bool = False
    screen_events: bool = False
    # With collision or screen events on, step(n) runs chunks of this many
    # frames per host roundtrip, accumulating EVERY frame's Enter/Stay/Exit
    # tables in a device log and dispatching them (in frame order) after the
    # chunk. 1 = dispatch every frame (exact reference timing; each frame
    # pays a host sync). >1 amortizes the device roundtrip — events are
    # still per-frame-accurate data, but hooks run up to chunk-1 frames
    # late and their control-plane effects (emissions, spawns) land at the
    # chunk boundary.
    event_chunk: int = 1
    # Overlap host hook dispatch with the NEXT chunk's device execution
    # (double-buffered event logs). The log's copy to the host (one a
    # chunk) and the hook bodies then cost no device idle
    # time, at the price of hooks landing up to ONE EXTRA chunk late and
    # their control-plane effects (spawns, emissions) applying a chunk
    # later — the reference's own callbacks run in a free-running worker
    # with unbounded lag (logic_worker.js:417-526). Only affects chunked
    # stepping (event_chunk > 1).
    event_overlap: bool = False
    # log capacity per frame per event kind under chunked stepping
    max_events_per_frame: int = 1024
    # onScreen Enter/Exit table capacity (screen_events): transitions per
    # frame beyond this drop (the device diff compacts entity ids into a
    # fixed [2 + 2*cap] packed array — see state.World.screen_events_packed)
    max_screen_events: int = 1024
    # Pair-recording scope. By default, when any class registers a collision
    # hook, only pairs with at least one HOOKED participant are recorded
    # (recorded from the hooked side) — the unhooked-vs-unhooked pairs the
    # reference also writes to collisionData could never fire a hook here,
    # and skipping them shrinks the recording pass from O(entities) to
    # O(hooked entities). With no hooks registered, all pairs are recorded
    # (the collisionData-as-user-API case). Set True to force full recording
    # alongside hooks (reading world.collision_pairs for every pair).
    record_all_pairs: bool = False


@dataclass(frozen=True)
class ParticleConfig:
    """Particle pool + decal tilemap section (gameEngine.js:99, :174-180)."""

    max_particles: int = 0
    decals: bool = False
    decals_tile_size: int = 256
    decals_resolution: float = 1.0
    # TPU-only: static per-step budget for DEVICE-side tick emissions (the
    # "emit" tick key); requests beyond it drop, like host emissions beyond
    # the pool's free count. 0 disables the device emission path entirely.
    max_emit_per_step: int = 1024


@dataclass(frozen=True)
class LightingConfig:
    """Lighting/shadow section (gameEngine.js:145-151, pixi_worker.js:2274-2283)."""

    enabled: bool = False
    lighting_ambient: float = 0.05
    max_lights: int = 128
    shadows_enabled: bool = True
    max_shadow_casting_lights: int = 20
    max_shadows_per_light: int = 15
    entity_lighting: bool = False


@dataclass(frozen=True)
class RendererConfig:
    """Renderer section (pixi_worker.js:2107-2127). The TPU build extracts
    render state on-device; these knobs shape the extraction."""

    bg: int = 0x000000
    y_sorting: bool = True
    # margin fraction for offscreen culling (particle_worker.js:1030: 15%)
    cull_margin: float = 0.15


@dataclass(frozen=True)
class ShardingConfig:
    """Multi-device layout. Not part of the reference config surface (the
    reference's analog is its worker counts); controls the pjit/shard_map mesh."""

    # number of devices along the entity/data axis; 0 = all available
    data: int = 0
    axis_name: str = "entities"


@dataclass(frozen=True)
class EngineConfig:
    """Top-level config, one-to-one with the object handed to
    ``new GameEngine(config)`` (gameEngine.js:21-62)."""

    world_width: float = 800.0
    world_height: float = 600.0
    canvas_width: int = 800
    canvas_height: int = 600
    seed: int = 0
    # fixed timestep ratio relative to a 60 FPS frame (the reference's dtRatio,
    # AbstractWorker.js frame loop). Deterministic sims should keep 1.0.
    dt_ratio: float = 1.0
    spatial: SpatialConfig = field(default_factory=SpatialConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    logic: LogicConfig = field(default_factory=LogicConfig)
    particle: ParticleConfig = field(default_factory=ParticleConfig)
    lighting: LightingConfig = field(default_factory=LightingConfig)
    renderer: RendererConfig = field(default_factory=RendererConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)

    def validated(self) -> "EngineConfig":
        return dataclasses.replace(self, physics=self.physics.validated())

    # --- derived grid geometry (spatial_worker.js:80-86) ---
    @property
    def grid_cols(self) -> int:
        import math

        return max(1, math.ceil(self.world_width / self.spatial.cell_size))

    @property
    def grid_rows(self) -> int:
        import math

        return max(1, math.ceil(self.world_height / self.spatial.cell_size))

    @property
    def total_cells(self) -> int:
        return self.grid_cols * self.grid_rows


def make_config(**kwargs) -> EngineConfig:
    """Ergonomic constructor accepting nested dicts, mirroring the reference's
    plain-object config: ``make_config(world_width=9000, physics=dict(gravity=(0, .5)))``.
    """

    def build(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            out = {}
            for k, v in value.items():
                if k not in fields:
                    raise KeyError(f"unknown {cls.__name__} key: {k}")
                sub = _SECTION_TYPES.get(k)
                if sub is not None:
                    out[k] = build(sub, v)
                elif k == "gravity":
                    out[k] = tuple(float(g) for g in v)
                else:
                    out[k] = v
            return cls(**out)
        raise TypeError(f"cannot build {cls.__name__} from {type(value)}")

    top = {}
    for k, v in kwargs.items():
        sub = _SECTION_TYPES.get(k)
        if sub is not None:
            top[k] = build(sub, v)
        else:
            top[k] = v
    return EngineConfig(**top).validated()


_SECTION_TYPES = {
    "spatial": SpatialConfig,
    "physics": PhysicsConfig,
    "logic": LogicConfig,
    "particle": ParticleConfig,
    "lighting": LightingConfig,
    "renderer": RendererConfig,
    "sharding": ShardingConfig,
}
