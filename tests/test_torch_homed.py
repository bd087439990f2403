"""Slice E2: the position-homed step (``parallel.homed``), the PyTorch port
against the JAX package and against itself. Every class of
``tests/test_homed.py`` and ``tests/test_homed_mixed.py`` has its
counterpart here, on the same scene.

Witnesses, from one world: the JAX homed step on conftest's virtual CPU
devices (``make_mesh(D, axis_name="slab")``, its solver "auto" XLA's grid
pass on the CPU), the port's homed step on the CPU (K3's plain version),
and the port's ``Engine.step`` (K1's plain version). The JAX world is
carried across with ``interop.world_from_jax``. Each class runs the
witnesses its reference class holds the step to; the control plane and the
adversarial migrations are the port's own bars (conservation, and
bit-equality with a re-placement), as in the reference.

Tolerances, each with its reason:
- The port's homed step against the port's ``Engine.step``: bit-equal,
  every entity leaf, with ``solver="pallas"`` too (K3 reads the seam rows;
  the reference's tests only check finiteness for its kernel); the event
  tables, the pool, the canvas; the shadow sprites' active slots on static
  scenes (the homed step reads the casters' frame-start state).
- The port against the JAX homed step: integer state exact (active flags,
  contact counts, event tables, the particles' active flags, the canvas,
  the per-frame ``migrated_rows`` and ``home_violators``); float state
  within ``POS_ULPS`` float32 ulps at the world's extent: XLA:CPU fuses
  multiply-adds and sums the grid pass's pushes in chunks of 8, where the
  port rounds every operation and sums one slot at a time
  (``tests/test_torch_halo.py``'s bar, 8 ulps after 3 frames), and the
  boids' neighbour sums run over slots with gaps.
- Function level: the migration (``migrate`` and ``finish_migration``) and
  phase B (its exchange, merge, binning and substeps) against the JAX
  functions run under ``shard_map`` on one placed state: gids, sent masks,
  ungranted counts and packed rows exact; phase B's solved and degraded
  counts and contact counts exact, positions within ``POS_ULPS``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu_torch as port
from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu.models.boids import Boid as RefBoid
from multithreadedgameengine_tpu.parallel import make_halo_step as ref_make_halo_step
from multithreadedgameengine_tpu.parallel import make_homed_step as ref_make_homed_step
from multithreadedgameengine_tpu.parallel import make_mesh as ref_make_mesh
from multithreadedgameengine_tpu_torch.components import Collider, RigidBody, SpriteRenderer
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.models.boids import Boid
from multithreadedgameengine_tpu_torch.parallel import (
    homed,
    make_halo_step,
    make_homed_step,
    make_mesh,
    unplace_fn,
)
from multithreadedgameengine_tpu_torch.parallel.halo import (
    _get_comp,
    entity_leaf_specs,
    pack_world_rows,
    unpack_world_rows,
)
from test_torch_halo_mixed import (
    assert_close_to_ref,
    assert_pool_equal,
    assert_pool_matches_ref,
    assert_shadows_equal,
    assert_shadows_match_ref,
    decal_scene,
    engine,
    event_rows,
    mixed_scene,
    shadow_scene,
)

torch.set_num_threads(2)

D = 8
POS_ULPS = 8


# ---------------------------------------------------------------------------
# scenes (tests/test_homed.py's scene functions) in either package
# ---------------------------------------------------------------------------

def boids_scene(pkg, n_total=256, n_spawned=None, y_range=(50, 1550)):
    eng = engine(pkg, world_width=2000.0, world_height=1600.0, seed=7,
                 spatial=dict(cell_size=100.0, max_neighbors=64, cell_capacity=32),
                 physics=dict(sub_step_count=2, gravity=(0.0, 0.0)))
    eng.register_entity_class(RefBoid if pkg == "jax" else Boid, n_total - 1)
    eng.init()
    rng = np.random.default_rng(3)
    m = n_total - 1 if n_spawned is None else n_spawned
    eng.spawn_batch("Boid", m, x=rng.uniform(50, 1950, m).astype(np.float32),
                    y=rng.uniform(*y_range, m).astype(np.float32),
                    vx=rng.uniform(-3, 3, m).astype(np.float32),
                    vy=rng.uniform(-3, 3, m).astype(np.float32))
    return eng


def pile_scene(pkg, seed=99, **physics):
    make = ref_balls if pkg == "jax" else make_balls_engine
    kw = {} if pkg == "jax" else dict(device="cpu")
    extra = dict(physics=physics) if physics else {}
    return make(n_balls=255, spawn=True, seed=seed, world_width=1600.0, world_height=1000.0,
                spatial=dict(cell_size=50.0, max_neighbors=32), **extra, **kw)


def runner_class(pkg):
    """test_homed's Runner: falls down and despawns below y = 1400."""
    mod = ref if pkg == "jax" else port
    if pkg == "jax":
        from multithreadedgameengine_tpu import components as comps

        def tick(ctx):
            return {"rigid_body.ay": jnp.where(ctx.y < 1500.0, 3.0, 0.0),
                    "despawn": ctx.y > 1400.0}
        components = [comps.RigidBody, comps.Collider, comps.SpriteRenderer]
    else:
        def tick(ctx):
            return {"rigid_body.ay": torch.where(ctx.y < 1500.0, 3.0, 0.0),
                    "despawn": ctx.y > 1400.0}
        components = [RigidBody, Collider, SpriteRenderer]
    return type("Runner", (mod.EntityClass,), {
        "components": components, "uses_neighbors": False,
        "setup": classmethod(lambda cls, ctx: {"collider.radius": 5.0,
                                               "collider.visual_range": 40.0,
                                               "rigid_body.max_vel": 80.0}),
        "tick": staticmethod(tick)})


def runner_scene(pkg, solver="grid"):
    eng = engine(pkg, world_width=800.0, world_height=1600.0, seed=5,
                 spatial=dict(cell_size=100.0, max_neighbors=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0), solver=solver))
    eng.register_entity_class(runner_class(pkg), 63)
    eng.init()
    rng = np.random.default_rng(11)
    eng.spawn_batch("Runner", 63, x=rng.uniform(50, 750, 63).astype(np.float32),
                    y=rng.uniform(50, 400, 63).astype(np.float32))
    return eng


def simple_class(name, tick=None):
    """A port class of radius 3 and max_vel 100 (test_homed's Faller and
    SeamDier)."""
    ns = {"components": [RigidBody, Collider, SpriteRenderer], "uses_neighbors": False,
          "setup": classmethod(lambda cls, ctx: {"collider.radius": 3.0,
                                                 "collider.visual_range": 20.0,
                                                 "rigid_body.max_vel": 100.0})}
    if tick is not None:
        ns["tick"] = staticmethod(tick)
    return type(name, (port.EntityClass,), ns)


def port_scene(cls, n, seed, spawn, **physics):
    eng = port.Engine(port.make_config(
        world_width=2000.0, world_height=1600.0, seed=5,
        spatial=dict(cell_size=100.0, max_neighbors=8, cell_capacity=32),
        physics=dict(sub_step_count=1, **physics)), device="cpu")
    eng.register_entity_class(cls, n)
    eng.init()
    rng = np.random.default_rng(seed)
    eng.spawn_batch(cls.__name__, n, **spawn(rng))
    eng._flush_pending()
    return eng


def witnesses(scene, **kw):
    """(JAX engine, port engine for the homed step, port engine for
    Engine.step), flushed, the port's two from the JAX world."""
    ej = scene("jax", **kw)
    ej._flush_pending()
    ports = []
    for _ in range(2):
        et = scene("torch", **kw)
        et._flush_pending()
        et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
        ports.append(et)
    return ej, *ports


class RefHomed:
    def __init__(self, eng, n_dev=D, **kw):
        self.step, place, self.unplace, self.ctl = ref_make_homed_step(
            eng, ref_make_mesh(n_dev, axis_name="slab"), **kw)
        self.world, self.gid = place(eng.world)

    def __call__(self, ins):
        self.world, self.gid, m = self.step(self.world, self.gid, ins)
        return self.unplace(self.world, self.gid), m


class PortHomed:
    def __init__(self, eng, n_dev=D, **kw):
        self.step, place, self.unplace, self.ctl = make_homed_step(
            eng, make_mesh(n_dev, "cpu"), **kw)
        self.chunks, self.gids = place(eng.world)

    def __call__(self, ins):
        self.chunks, self.gids, m = self.step(self.chunks, self.gids, ins)
        return self.unplace(self.chunks, self.gids), m


def run_port(eng, steps, **kw):
    h = PortHomed(eng, **kw)
    for _ in range(steps):
        w, m = h(eng.input.snapshot("cpu"))
    return w, m, h


def assert_entities_equal(a, b):
    for cname, fname, _dt in entity_leaf_specs(a):
        assert torch.equal(getattr(_get_comp(a, cname), fname),
                           getattr(_get_comp(b, cname), fname)), f"{cname}.{fname}"


def three_way(scene, steps, extent, headroom=8.0, adjacent_frac=1.0, every=None,
              ref_frames=None, **kw):
    """The scene through the JAX homed step, the port's homed step and the
    port's Engine.step; the two port worlds bit-equal every frame, the port
    within POS_ULPS of the JAX step with the same migrated rows and
    violators for the first ``ref_frames`` frames (all by default; a dense
    pile carries XLA's last-bit differences from frame to frame, so it is
    held to the JAX step for 3 frames, as ``tests/test_torch_halo.py``
    does). ``every(k, a, b, s)`` checks each frame while the JAX step runs.
    Returns the last (JAX world, port world, Engine world, port
    metrics)."""
    ej, eh, es = witnesses(scene, **kw)
    ref_frames = steps if ref_frames is None else ref_frames
    rj = RefHomed(ej, headroom=headroom, adjacent_frac=adjacent_frac)
    rh = PortHomed(eh, headroom=headroom, adjacent_frac=adjacent_frac)
    for k in range(steps):
        b, mt = rh(eh.input.snapshot("cpu"))
        es.step(1)
        assert_entities_equal(b, es.world)
        if k < ref_frames:
            a, mj = rj(ej.input.snapshot())
            for key in ("migrated_rows", "home_violators", "route_overflow_solver",
                        "active_count", "n_binned", "solver_binned"):
                assert int(mt[key]) == int(mj[key]), (k, key)
            if every is not None:
                every(k, a, b, es.snapshot())
            if k == ref_frames - 1:
                assert_close_to_ref(a, b, extent)
    s = es.snapshot()
    assert_entities_equal(b, s)
    return a, b, s, mt


# ---------------------------------------------------------------------------
# tests/test_homed.py
# ---------------------------------------------------------------------------

class TestBoidsParity:
    def test_trajectory_bit_exact_20_steps(self):
        """The reference's bar (tests/test_homed.py:81-86): 20 frames bit for
        bit against ``Engine.step``; the JAX homed step for the first 6."""
        _a, b, _s, m = three_way(boids_scene, 20, 2000.0, ref_frames=6)
        assert int(m["home_violators"]) == 0 and int(m["route_overflow_solver"]) == 0
        assert int(m["active_count"]) == int(m["n_binned"]) == 256
        assert set(b.custom) == {"flocking"}

    def test_migration_is_movers_only(self):
        """Routed rows a frame are the band crossers: a few % of N."""
        eng = boids_scene("torch")
        eng._flush_pending()
        h = PortHomed(eng, headroom=8.0)
        moved = []
        for _ in range(10):
            _w, m = h(eng.input.snapshot("cpu"))
            moved.append(int(m["migrated_rows"]))
        assert max(moved[2:]) < 256 // 4 and sum(moved) > 0
        assert int(m["active_count"]) == 256
        # every chunk holds its band's rows, gid-sorted
        for d, (c, g) in enumerate(zip(h.chunks, h.gids)):
            occ = g[g >= 0]
            assert torch.equal(occ, torch.sort(occ).values)
            assert bool((homed.band_of_y(c.transform.y[g >= 0], h.step.plan) == d).all())


class TestBallsParity:
    def test_gravity_piles_bit_exact(self):
        """Balls under gravity, no ticks reading neighbours (phase A
        local): headroom D, so capacity never binds."""
        _a, _b, _s, m = three_way(pile_scene, 20, 1600.0, headroom=float(D), ref_frames=3)
        assert int(m["route_overflow_solver"]) == 0 and int(m["home_violators"]) == 0


class TestValidation:
    def test_event_scene_builds(self):
        eng = boids_scene("torch")
        eng.config = dataclasses.replace(
            eng.config, logic=dataclasses.replace(eng.config.logic, collision_events=True))
        step, _place, _unplace, _ctl = make_homed_step(eng, make_mesh(D, "cpu"))
        assert step.plan.events and step.plan.need_neighbors

    @pytest.mark.parametrize("change,error,match", [
        (dict(spatial=dict(method="none")), ValueError, "grid"),
        (dict(physics=dict(solver="neighbors")), ValueError, "grid constraint solver"),
        (dict(logic=dict(screen_events=True)), NotImplementedError, "screen_events"),
    ])
    def test_non_grid_spatial_raises(self, change, error, match):
        eng = boids_scene("torch")
        cfg = eng.config
        for section, fields in change.items():
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
                getattr(cfg, section), **fields)})
        eng.config = cfg
        with pytest.raises(error, match=match):
            make_homed_step(eng, make_mesh(D, "cpu"))

    def test_placement_overflow_raises(self):
        eng = boids_scene("torch", y_range=(1410, 1590))
        eng._flush_pending()
        _step, place, _u, _c = make_homed_step(eng, make_mesh(D, "cpu"), headroom=1.0)
        with pytest.raises(ValueError, match="placement overflow"):
            place(eng.world)


class TestTickRowIndex:
    """What a tick sees as ``ctx.i``: the row's global id under
    ``Engine.step``, the local row index under both slab steps, as the
    reference's ``run_logic_phase_masked`` hands it (behavior.py:758). The
    tick writes ``ctx.i`` into a user field; 63 static entities, so no row
    migrates."""

    N_DEV = 4

    @staticmethod
    def scene(pkg):
        mod = ref if pkg == "jax" else port
        tag = mod.define_component("RowTag", {"row": "i32"})
        comps = ref.components if pkg == "jax" else port.components
        cls = type("Tagger", (mod.EntityClass,), {
            "components": [comps.RigidBody, comps.Collider, tag], "uses_neighbors": False,
            "setup": classmethod(lambda c, ctx: {"collider.radius": 3.0}),
            "tick": staticmethod(lambda ctx: {"row_tag.row": ctx.i})})
        eng = engine(pkg, world_width=2000.0, world_height=1600.0, seed=5,
                     spatial=dict(cell_size=100.0, max_neighbors=8),
                     physics=dict(sub_step_count=1, gravity=(0.0, 0.0)))
        eng.register_entity_class(cls, 63)
        eng.init()
        rng = np.random.default_rng(2)
        eng.spawn_batch("Tagger", 63, x=rng.uniform(50, 1950, 63).astype(np.float32),
                        y=rng.uniform(50, 1550, 63).astype(np.float32))
        eng._flush_pending()
        return eng

    @staticmethod
    def rows(world):
        return np.asarray(world.custom["row_tag"].row)

    def test_engine_step_hands_the_global_id(self):
        for pkg in ("jax", "torch"):
            eng = self.scene(pkg)
            eng.step(2)
            w = eng.snapshot()
            active = np.asarray(w.transform.active)
            np.testing.assert_array_equal(self.rows(w)[active], np.flatnonzero(active))

    def test_halo_step_hands_the_local_row(self):
        ej, et = self.scene("jax"), self.scene("torch")
        step_j, place_j = ref_make_halo_step(ej, ref_make_mesh(self.N_DEV, axis_name="slab"))
        mesh = make_mesh(self.N_DEV, "cpu")
        step_t, place_t = make_halo_step(et, mesh)
        wj, ct = place_j(ej.world), place_t(et.world)
        for _ in range(2):
            wj, _m = step_j(wj, ej.input.snapshot())
            ct, _m = step_t(ct, et.input.snapshot("cpu"))
        a, b = jax.device_get(wj), unplace_fn(ct, mesh)
        np.testing.assert_array_equal(self.rows(b).astype(np.int32), self.rows(a))
        # a home chunk holds N / D consecutive ids
        rows = 64 // self.N_DEV
        active = b.transform.active.numpy()
        np.testing.assert_array_equal(self.rows(b)[active], np.flatnonzero(active) % rows)

    def test_homed_step_hands_the_local_row(self):
        ej, et = self.scene("jax"), self.scene("torch")
        rj, rt = RefHomed(ej, n_dev=self.N_DEV), PortHomed(et, n_dev=self.N_DEV)
        for _ in range(2):
            a, mj = rj(ej.input.snapshot())
            b, mt = rt(et.input.snapshot("cpu"))
            assert int(mt["migrated_rows"]) == int(mj["migrated_rows"]) == 0
        np.testing.assert_array_equal(self.rows(b), np.asarray(self.rows(a)))
        # each gid's position in its gid-sorted chunk
        for g in rt.gids:
            held = torch.nonzero(g >= 0).flatten()
            np.testing.assert_array_equal(self.rows(b)[g[held].numpy()], held.numpy())


class TestDespawnAndPallasUnderHomed:
    def test_tick_despawn_matches_single_device(self):
        """Runners fall across bands (migrating) and despawn on the device:
        trajectories and active sets as the single device."""
        _a, b, s, m = three_way(runner_scene, 40, 1600.0, ref_frames=10)
        assert int(s.transform.active.sum()) < 64  # some despawned
        assert int(m["home_violators"]) == 0

    def test_pallas_solver_runs_under_homed(self):
        """K3's plain version under the homed step: bit-equal with
        Engine.step (K1) -- where the reference only checks finiteness for
        its kernel, which drops the seam rows -- and with the homed step on
        the grid solver's XLA order on this scene; the JAX homed step on
        its grid solver within POS_ULPS."""
        ej, _e0, _e1 = witnesses(runner_scene)
        worlds = {}
        for solver in ("pallas", "grid"):
            eh, es = runner_scene("torch", solver), runner_scene("torch", solver)
            for e in (eh, es):
                e._flush_pending()
                e.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
            w, m, h = run_port(eh, 10, headroom=8.0, adjacent_frac=1.0)
            assert h.step.plan.cfg.physics.solver == solver
            es.step(10)
            assert_entities_equal(w, es.snapshot())
            assert int(m["active_count"]) > 0 and bool(w.transform.y.isfinite().all())
            worlds[solver] = w
        assert_entities_equal(worlds["pallas"], worlds["grid"])
        rj = RefHomed(ej, headroom=8.0, adjacent_frac=1.0)
        for _ in range(10):
            a, _m = rj(ej.input.snapshot())
        assert_close_to_ref(a, worlds["pallas"], 1600.0)


class TestMigrationConservation:
    def test_extreme_pile_never_loses_entities(self):
        """A hard pile with headroom 1.6 bounces movers as violators; no
        entity is ever lost or duplicated."""
        eng = pile_scene("torch", seed=13, sub_step_count=2, max_collision_pairs=1,
                         verlet_damping=0.99, boundary_elasticity=0.0,
                         collision_response_strength=0.8, gravity=(0.0, 2.0))
        eng._flush_pending()
        h = PortHomed(eng, headroom=1.6)
        saw = 0
        for _ in range(25):
            _w, m = h(eng.input.snapshot("cpu"))
            assert int(m["active_count"]) == 256
            saw = max(saw, int(m["home_violators"]))
        w = h.unplace(h.chunks, h.gids)
        assert int(w.transform.active.sum()) == 256
        assert saw > 0  # the pile stressed the capacity
        occ = torch.cat(h.gids)
        occ = occ[occ >= 0]
        assert torch.unique(occ).numel() == occ.numel() == 256


class TestLiveControlPlane:
    """Host spawns and despawns during a homed run, without re-placement."""

    @staticmethod
    def _engine(n_total=384, n_spawned=255):
        eng = boids_scene("torch", n_total=n_total, n_spawned=n_spawned)
        eng._flush_pending()
        return eng

    @staticmethod
    def _spawn_args(k=40):
        rng = np.random.default_rng(77)
        return dict(x=rng.uniform(100, 1900, k).astype(np.float32),
                    y=rng.uniform(100, 1500, k).astype(np.float32),
                    vx=rng.uniform(-2, 2, k).astype(np.float32),
                    vy=rng.uniform(-2, 2, k).astype(np.float32))

    def test_live_insert_bit_exact_vs_replacement(self):
        K = 40
        eng1 = self._engine()
        h1 = PortHomed(eng1, headroom=8.0)
        ins = eng1.input.snapshot("cpu")
        for _ in range(5):
            h1(ins)
        new1 = eng1.spawn_batch("Boid", K, **self._spawn_args(K))
        eng1._flush_pending()
        rows1 = h1.ctl.pack_rows(eng1.world, new1)
        assert rows1.dtype == torch.int64 and rows1.shape[0] == K
        h1.chunks, h1.gids, denied = h1.ctl.insert(h1.chunks, h1.gids, rows1, new1)
        assert int(denied) == 0
        for _ in range(5):
            s_live, m1 = h1(ins)

        eng2 = self._engine()
        h2 = PortHomed(eng2, headroom=8.0)
        for _ in range(5):
            mid, _m = h2(ins)
        eng2.world = mid
        new2 = eng2.spawn_batch("Boid", K, **self._spawn_args(K))
        eng2._flush_pending()
        np.testing.assert_array_equal(new1, new2)
        place = make_homed_step(eng2, make_mesh(D, "cpu"), headroom=8.0)[1]
        h2.chunks, h2.gids = place(eng2.world)
        for _ in range(5):
            s_rep, m2 = h2(ins)
        assert_entities_equal(s_live, s_rep)
        assert int(m1["active_count"]) == int(m2["active_count"]) == 255 + K + 1

    def test_unplace_reads_the_later_of_two_rows(self):
        """A live insert leaves each spawned gid's inactive row parked on
        slab 0 beside the inserted row, as the reference's does; unplace
        reads the later row in slab-then-row order (the reference's numpy
        assignment), however many CPU threads copy the rows."""
        K = 40
        eng = self._engine()
        h = PortHomed(eng, headroom=8.0)
        new = eng.spawn_batch("Boid", K, **self._spawn_args(K))
        eng._flush_pending()
        rows = h.ctl.pack_rows(eng.world, new)
        h.chunks, h.gids, _denied = h.ctl.insert(h.chunks, h.gids, rows, new)
        held = torch.cat(h.gids)
        held = held[held >= 0]
        assert held.numel() - torch.unique(held).numel() == K
        idx = torch.as_tensor(new, dtype=torch.int64)
        threads = torch.get_num_threads()
        torch.set_num_threads(8)
        try:
            for _ in range(20):
                w = h.unplace(h.chunks, h.gids)
                assert bool(w.transform.active[idx].all())
                assert torch.equal(pack_world_rows(w, h.step.plan.leaf_specs)[idx], rows)
        finally:
            torch.set_num_threads(threads)

    def test_gather_reads_the_later_of_two_rows(self):
        """``ctx.gather``'s resolver under the homed step reads a gid held
        by two rows from the later one in slab-then-row order, as
        ``unplace`` does, however many CPU threads copy the rows (80,000
        gathered entries: torch's CPU ``index_copy_`` splits such a copy
        over threads)."""
        from multithreadedgameengine_tpu_torch.parallel.homed import _gather_homed
        from multithreadedgameengine_tpu_torch.state import make_world

        n, rows = 60_000, 20_000
        homes, gids = [], []
        for s in range(4):  # slabs 0-1 park gids 0-39,999; slabs 2-3 hold them later
            g = torch.arange(rows, dtype=torch.int32) + (s % 2) * rows
            w = make_world(rows, "cpu")
            x = g.to(torch.float32) if s >= 2 else torch.full((rows,), -1.0)
            homes.append(w.replace(transform=w.transform.replace(x=x)))
            gids.append(g)
        want = torch.where(torch.arange(n) < 2 * rows, torch.arange(n, dtype=torch.float32), 0.0)
        threads = torch.get_num_threads()
        torch.set_num_threads(8)
        try:
            for _ in range(10):
                got = _gather_homed(make_mesh(4, "cpu"), homes, gids, n)("transform.x")
                assert torch.equal(got, want)
        finally:
            torch.set_num_threads(threads)

    def test_live_remove_bit_exact_vs_replacement(self):
        eng1 = self._engine()
        victims = np.sort(eng1.classes["Boid"].pool.active_indices())[:5].astype(np.int32)
        h1 = PortHomed(eng1, headroom=8.0)
        ins = eng1.input.snapshot("cpu")
        for _ in range(5):
            h1(ins)
        h1.chunks, h1.gids, removed = h1.ctl.remove(h1.chunks, h1.gids, victims)
        assert int(removed) == victims.size
        for _ in range(5):
            s_live, m1 = h1(ins)

        eng2 = self._engine()
        h2 = PortHomed(eng2, headroom=8.0)
        for _ in range(5):
            mid, _m = h2(ins)
        specs = entity_leaf_specs(mid)
        rows = pack_world_rows(mid, specs)
        rows[torch.from_numpy(victims).long()] = 0
        mid = unpack_world_rows(rows, mid, specs)
        h2.chunks, h2.gids = make_homed_step(eng2, make_mesh(D, "cpu"), headroom=8.0)[1](mid)
        for _ in range(5):
            s_rep, m2 = h2(ins)
        assert_entities_equal(s_live, s_rep)
        assert int(m1["active_count"]) == int(m2["active_count"]) == 256 - victims.size

    def test_insert_denied_when_band_chunk_full(self):
        eng = boids_scene("torch", n_total=384, n_spawned=255, y_range=(1410, 1590))
        eng._flush_pending()
        # headroom 5.5: n_cap = 264, band 7's 255 residents leave 9 rows
        h = PortHomed(eng, headroom=5.5)
        assert h.step.plan.n_cap == 264
        orig = np.sort(eng.classes["Boid"].pool.active_indices())
        K = 64
        new = eng.spawn_batch("Boid", K, x=np.full(K, 1000.0, np.float32),
                              y=np.full(K, 1550.0, np.float32))
        eng._flush_pending()
        rows = h.ctl.pack_rows(eng.world, new)
        h.chunks, h.gids, denied = h.ctl.insert(h.chunks, h.gids, rows, new)
        n_denied = int(denied)
        assert n_denied == K - 9
        active = h.unplace(h.chunks, h.gids).transform.active
        assert bool(active[torch.from_numpy(orig).long()].all())
        assert int(active.sum()) == 256 + K - n_denied


class TestAdversarialMigration:
    """Piles crossing a seam together, denial with retry, despawn at the
    seam: every frame conserves the entities."""

    def test_mass_seam_crossing_under_tight_quota(self):
        """All 255 fall across seams at 40 px a frame with the migration
        quota squeezed (mig_oversub 0.25): denied movers retry; nobody is
        lost or duplicated, positions stay finite and in the world."""
        Faller = simple_class("Faller")

        def spawn(rng):
            return dict(x=rng.uniform(50, 1950, 255).astype(np.float32),
                        y=rng.uniform(210, 390, 255).astype(np.float32),
                        vy=np.full(255, 40.0, np.float32))

        eng = port_scene(Faller, 255, 11, spawn, gravity=(0.0, 0.0))
        h = PortHomed(eng, headroom=8.0, mig_oversub=0.25)
        saw = False
        for k in range(30):
            _w, m = h(eng.input.snapshot("cpu"))
            assert int(m["active_count"]) == 256, k
            saw = saw or int(m["home_violators"]) > 0
        assert saw
        w = h.unplace(h.chunks, h.gids)
        y = w.transform.y[w.transform.active]
        assert bool(y.isfinite().all() and (y >= 0).all() and (y <= 1600).all())
        occ = torch.cat(h.gids)
        occ = occ[occ >= 0]
        assert torch.unique(occ).numel() == occ.numel() == 256

    def test_despawn_at_the_seam(self):
        """Entities despawn on the frame they would cross the 3 -> 4 seam
        (y > 800): active counts track Engine.step every frame, and the
        worlds end bit-equal."""
        SeamDier = simple_class("SeamDier", lambda ctx: {"despawn": ctx.y > 800.0})

        def spawn(rng):
            return dict(x=rng.uniform(50, 1950, 255).astype(np.float32),
                        y=rng.uniform(600, 795, 255).astype(np.float32),
                        vy=rng.uniform(1.0, 8.0, 255).astype(np.float32))

        eh = port_scene(SeamDier, 255, 13, spawn, gravity=(0.0, 0.1))
        es = port_scene(SeamDier, 255, 13, spawn, gravity=(0.0, 0.1))
        h = PortHomed(eh, headroom=8.0)
        for k in range(30):
            es.step(1)
            _w, m = h(eh.input.snapshot("cpu"))
            assert int(m["active_count"]) == int(es.world.transform.active.sum()), k
        s = es.snapshot()
        assert_entities_equal(h.unplace(h.chunks, h.gids), s)
        assert int(s.transform.active.sum()) < 255

    def test_full_chunk_denial_across_consecutive_frames(self):
        """Gravity 4 slams everyone into the floor band with headroom 1.6:
        movers are denied for several frames in a row, retry, and none is
        lost."""
        eng = pile_scene("torch", seed=13, sub_step_count=2, max_collision_pairs=1,
                         verlet_damping=0.99, boundary_elasticity=0.0,
                         collision_response_strength=0.8, gravity=(0.0, 4.0))
        eng._flush_pending()
        h = PortHomed(eng, headroom=1.6)
        run = best = 0
        for k in range(30):
            _w, m = h(eng.input.snapshot("cpu"))
            assert int(m["active_count"]) == 256, k
            run = run + 1 if int(m["home_violators"]) > 0 else 0
            best = max(best, run)
        assert best >= 3, best
        occ = torch.cat(h.gids)
        occ = occ[occ >= 0]
        assert torch.unique(occ).numel() == occ.numel() == 256


# ---------------------------------------------------------------------------
# tests/test_homed_mixed.py
# ---------------------------------------------------------------------------

def homed_events_scene(pkg):
    """test_homed_mixed's event scene: 31 hooked bumpers."""
    from test_torch_halo_mixed import cls_of

    eng = engine(pkg, world_width=2000.0, world_height=1600.0, seed=11,
                 spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0),
                              collision_response_strength=0.2),
                 logic=dict(collision_events=True))
    eng.register_entity_class(cls_of(pkg, "_Bumper"), 31)
    eng.init()
    rng = np.random.default_rng(5)
    for _ in range(31):
        eng.spawn("_Bumper", x=float(rng.uniform(50, 1950)), y=float(rng.uniform(50, 1550)),
                  vx=float(rng.uniform(-4, 4)), vy=float(rng.uniform(-4, 4)))
    return eng


class TestHomedEvents:
    def test_event_tables_match_single_device(self):
        saw = []

        def every(k, a, b, s):
            assert int(b.collision_pair_count) == int(s.collision_pair_count) == int(
                np.asarray(a.collision_pair_count)), k
            assert event_rows(b) == event_rows(s) == event_rows(a), k
            saw.append(any(event_rows(s).values()))

        _a, _b, _s, m = three_way(homed_events_scene, 12, 2000.0, adjacent_frac=None,
                                  headroom=2.0, every=every)
        assert any(saw)
        assert int(m["home_violators"]) == 0


class TestHomedShadows:
    def test_static_scene_shadows_bit_exact(self):
        a, b, s, _m = three_way(shadow_scene, 3, 2000.0)
        assert int(s.shadow_sprites.active.sum()) > 0
        assert_shadows_equal(b, s)
        assert_shadows_match_ref(a, b)


class TestHomedDecals:
    def test_decal_canvas_bit_exact(self):
        a, b, s, _m = three_way(decal_scene, 10, 1000.0)
        assert s.decal_canvas.any()
        assert torch.equal(b.decal_canvas, s.decal_canvas)
        assert torch.equal(b.decal_dirty, s.decal_dirty)
        assert_pool_equal(b, s)
        np.testing.assert_array_equal(b.decal_canvas.numpy(), np.asarray(a.decal_canvas))
        assert_pool_matches_ref(a, b)


class TestHomedMixedScene:
    def test_predators_style_scene_runs_homed(self):
        """Events, shadows, particles and the emit in one homed frame."""
        def every(k, a, b, s):
            assert event_rows(b) == event_rows(s) == event_rows(a), k

        a, b, s, m = three_way(mixed_scene, 6, 2000.0, every=every)
        assert_pool_equal(b, s)
        assert_shadows_equal(b, s)
        assert_pool_matches_ref(a, b)
        assert_shadows_match_ref(a, b)
        assert int(m["home_violators"]) == 0 and int(m["route_overflow_solver"]) == 0
        assert int(m["active_particles"]) == int(s.particles.active.sum()) > 0

    def test_mixed_scene_pallas_solver(self):
        """K3's plain version driving phase B of the mixed scene: bit-equal
        with Engine.step on K1, events flowing."""
        eh, es = mixed_scene("torch"), mixed_scene("torch")
        for e in (eh, es):
            e.config = dataclasses.replace(e.config, physics=dataclasses.replace(
                e.config.physics, solver="pallas"))
            e._flush_pending()
        w, m, _h = run_port(eh, 6, headroom=8.0, adjacent_frac=1.0)
        es.step(6)
        s = es.snapshot()
        assert_entities_equal(w, s)
        assert event_rows(w) == event_rows(s) and any(event_rows(w).values())
        assert_pool_equal(w, s)


# ---------------------------------------------------------------------------
# function level: the JAX step's own migrate, finish_migration and phase_b
# ---------------------------------------------------------------------------

def ref_closure(step_fn, name):
    """The function ``name`` among the closures of the JAX step (its
    ``migrate``, ``finish_migration``, ``phase_b``...)."""
    seen, stack = set(), [step_fn.__wrapped__]
    while stack:
        f = stack.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        if getattr(f, "__name__", None) == name:
            return f
        for cell in getattr(f, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if callable(v) and hasattr(v, "__closure__"):
                stack.append(v)
    raise LookupError(name)


def placed_pair(scene, shift, headroom, **kw):
    """One placed state in both packages: the scene placed by the JAX homed
    step, every y moved by ``shift`` (so rows leave their bands), and the
    same chunks as the port's. Returns (JAX step, JAX world, JAX gid, port
    plan, port chunks, port gids, mesh)."""
    from multithreadedgameengine_tpu.parallel.halo import halo_world_specs

    ej, eh, _es = witnesses(scene)
    step_j, place_j, _u, _c = ref_make_homed_step(ej, ref_make_mesh(D, axis_name="slab"),
                                                  headroom=headroom, **kw)
    wj, gj = place_j(ej.world)
    wj = jax.device_get(wj)
    y = np.asarray(wj.transform.y) + np.float32(shift)
    wj = wj.replace(transform=wj.transform.replace(y=jnp.asarray(y.astype(np.float32))))
    step_t, _p, _u, _c = make_homed_step(eh, make_mesh(D, "cpu"), headroom=headroom, **kw)
    plan = step_t.plan
    whole = world_from_jax(wj, "cpu")
    n_cap = plan.n_cap
    g = torch.from_numpy(np.array(jax.device_get(gj)))
    specs = entity_leaf_specs(whole)
    rows = pack_world_rows(whole, specs)
    template = eh.world
    chunks = [unpack_world_rows(rows[d * n_cap:(d + 1) * n_cap], template, specs)
              for d in range(D)]
    gids = [g[d * n_cap:(d + 1) * n_cap] for d in range(D)]
    return (step_j, wj, gj, halo_world_specs(ej.world, "slab")), (plan, chunks, gids,
                                                                   make_mesh(D, "cpu"))


@pytest.mark.parametrize("mig_oversub,headroom", [(1.0, 8.0), (0.25, 8.0), (1.0, 1.6)])
def test_migration_matches_reference(mig_oversub, headroom):
    """Every row moved 150 px down: migrate + finish_migration against the
    JAX functions, with the quota binding (mig_oversub 0.25) and chunks
    near full (headroom 1.6)."""
    from multithreadedgameengine_tpu.parallel.halo import entity_leaf_specs as ref_specs
    from multithreadedgameengine_tpu.parallel.halo import pack_world_rows as ref_pack

    (step_j, wj, gj, w_specs), (plan, chunks, gids, mesh) = placed_pair(
        pile_scene, 150.0, headroom, mig_oversub=mig_oversub)
    migrate, finish = ref_closure(step_j, "migrate"), ref_closure(step_j, "finish_migration")
    specs_j = ref_specs(wj)

    def body(w, g):
        d = jax.lax.axis_index("slab").astype(jnp.int32)
        recv, send_ok, ungranted, rows = migrate(w, g, d)
        w2, g2 = finish(w, g, recv, send_ok, rows)
        return ref_pack(w2, specs_j), g2, send_ok, jax.lax.psum(ungranted, "slab")[None]

    fn = jax.jit(jax.shard_map(body, mesh=ref_make_mesh(D, axis_name="slab"),
                               in_specs=(w_specs, P("slab")),
                               out_specs=(P("slab"), P("slab"), P("slab"), P()),
                               check_vma=False))
    rows_j, g_j, sent_j, ungranted_j = (np.asarray(v) for v in jax.device_get(fn(wj, gj)))
    out_c, out_g, sent, ungranted = homed.migrate(mesh, chunks, gids, plan)
    np.testing.assert_array_equal(torch.cat(out_g).numpy(), g_j)
    rows_t = torch.cat([pack_world_rows(c, plan.leaf_specs) for c in out_c]).numpy()
    np.testing.assert_array_equal(rows_t, rows_j.astype(np.int64))
    assert sum(int(s) for s in sent) == int(sent_j.sum()) > 0
    assert sum(int(u) for u in ungranted) == int(ungranted_j[0])
    if mig_oversub < 1.0 or headroom < 2.0:
        assert int(ungranted_j[0]) > 0  # the grant bound


@pytest.mark.parametrize("adjacent_frac", [1.0, 0.02])
def test_phase_b_matches_reference(adjacent_frac):
    """Every row moved 30 px down (rows near a seam now in the adjacent
    band): phase B's exchange, gid-order merge, binning and substeps
    against the JAX phase_b, with the blocks large and with them
    overflowing (adjacent_frac 0.02: degraded rows take the boundary
    alone)."""
    (step_j, wj, gj, w_specs), (plan, chunks, gids, mesh) = placed_pair(
        pile_scene, 30.0, 8.0, adjacent_frac=adjacent_frac)
    phase_b = ref_closure(step_j, "phase_b")

    def body(w, g):
        d = jax.lax.axis_index("slab").astype(jnp.int32)
        w2, solved, over = phase_b(w, g, d)
        t, rb = w2.transform, w2.rigid_body
        return (t.x, t.y, rb.px, rb.py, rb.collision_count,
                jax.lax.psum(solved, "slab")[None], jax.lax.psum(over, "slab")[None])

    fn = jax.jit(jax.shard_map(body, mesh=ref_make_mesh(D, axis_name="slab"),
                               in_specs=(w_specs, P("slab")),
                               out_specs=(P("slab"),) * 5 + (P(), P()), check_vma=False))
    x, y, px, py, cc, solved_j, over_j = (np.asarray(v) for v in jax.device_get(fn(wj, gj)))
    out, solved, over = homed.phase_b(mesh, chunks, gids, plan)
    assert sum(int(s) for s in solved) == int(solved_j[0])
    assert sum(int(o) for o in over) == int(over_j[0])
    if adjacent_frac < 1.0:
        assert int(over_j[0]) > 0
    assert int(solved_j[0]) > 0
    tol = POS_ULPS * float(np.spacing(np.float32(1600.0)))
    np.testing.assert_array_equal(torch.cat([c.rigid_body.collision_count for c in out]).numpy(),
                                  cc)
    for got, want in ((lambda c: c.transform.x, x), (lambda c: c.transform.y, y),
                      (lambda c: c.rigid_body.px, px), (lambda c: c.rigid_body.py, py)):
        np.testing.assert_allclose(torch.cat([got(c) for c in out]).numpy(), want,
                                   rtol=0, atol=tol)
