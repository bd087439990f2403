"""The neighbour-list solver (``solver="neighbors"``, ROADMAP item 12) of the
PyTorch port against the JAX package, against the port's own grid solver,
and against ``golden_ref.py``; and the engine's wiring of it (solver
"neighbors", and a scene with no collider radius), against the JAX Engine.

Inputs: the reference's ``random_scene`` of ``tests/test_physics_grid.py``
(statics, triggers, inactive entities, radii 4-12) and a dense pile (a
lattice at 16 px spacing of radius-10 balls), made from numpy seeds; the
two packages read the same neighbour lists at function level.

Tolerances, each with its reason:
- integers and masks exact: candidate ids, flags, response shares, overlap
  counts and masks, contact counts;
- the pair-hash direction within 2 ulps (XLA:CPU's approximate ``rsqrt``,
  as ``tests/test_torch_physics.py``);
- one pass's ``dx``/``dy`` within ``PASS_ULPS`` float32 ulps of the largest
  displacement of the scene: XLA:CPU contracts ``a*b + c`` and approximates
  ``rsqrt``, the port rounds every operation and takes ``1 / sqrt``, so each
  push may differ by about 2 ulps of itself; a row sums up to 8 contacts on
  the dense pile, whose pushes cancel, so the sum carries up to 8 x 2 ulps
  at the scale of its terms, not of the sum (measured: 10 on the pile, 2-38
  ulps of the sums themselves on the random scenes);
- positions after ``apply_constraints`` within ``POS_ULPS`` ulps (measured:
  1 ulp on the random scenes);
- the engines after 3 frames within 2e-3 px (16 ulps at the world's
  extent), as ``tests/test_torch_balls.py``: the differences above carried
  from frame to frame through a dense pile;
- neighbours against grid: the reference's own bars
  (``tests/test_physics_grid.py::TestSolverEquivalence``): 2e-3 after 5
  frames, 1e-2 on the dense pile after 3, contact counts exact after 1.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from golden_ref import GoldenState
from test_physics import base_cfg, run_golden, world_from_golden
from test_physics_grid import make_cfg, random_scene

import multithreadedgameengine_tpu as ref_pkg
from multithreadedgameengine_tpu.ops import physics as ref
from multithreadedgameengine_tpu.ops.spatial import neighbor_lists_bruteforce as ref_lists
from multithreadedgameengine_tpu_torch import Engine, EntityClass, RigidBody, make_config
from multithreadedgameengine_tpu_torch.interop import config_from, world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.ops import physics as port
from multithreadedgameengine_tpu_torch.ops.physics_grid import solver_geometry
from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

torch.set_num_threads(2)

PASS_ULPS = 16.0
POS_ULPS = 2.0
ENGINE_ATOL = 2e-3


def ulps(a, b, scale=None):
    """Largest distance between a and b in float32 ulps of the larger value
    (or of ``scale``)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if scale is None:
        scale = np.maximum(np.abs(a), np.abs(b))
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(np.float32(scale))))


def dense_pile():
    rng = np.random.default_rng(3)
    n = 50
    gx, gy = np.meshgrid(np.arange(10), np.arange(5))
    s = GoldenState.of(n, x=260.0 + gx.ravel() * 16.0 + rng.uniform(-1, 1, n),
                       y=160.0 + gy.ravel() * 16.0 + rng.uniform(-1, 1, n),
                       radius=np.full(n, 10.0), max_vel=np.full(n, 30.0))
    s.px[:] = s.x
    s.py[:] = s.y
    return s


SCENES = {"random0": lambda: random_scene(0), "random1": lambda: random_scene(1),
          "random2": lambda: random_scene(2), "pile": dense_pile}


def both(s, solver="neighbors"):
    """(JAX world, its lists, port world, its lists, JAX cfg, port cfg)."""
    cfg = make_cfg(solver)
    wj = world_from_golden(s, cfg)
    wt = world_from_jax(jax.device_get(wj), "cpu")
    pc = config_from(cfg)
    nj = ref_lists(wj.transform.x, wj.transform.y, wj.transform.active,
                   wj.collider.visual_range, cfg)
    t = wt.transform
    nt = neighbor_lists(t.x, t.y, t.active, wt.collider.visual_range, pc)
    np.testing.assert_array_equal(nt.ids.numpy(), np.asarray(nj.ids))
    return wj, nj, wt, nt, cfg, pc


def invariants(wj, nj, wt, nt, salt):
    t, c, rb = wj.transform, wj.collider, wj.rigid_body
    a = ref.build_pair_invariants(nj, t.active, c.active, c.radius, c.is_trigger,
                                  rb.static, np.uint32(salt))
    t, c, rb = wt.transform, wt.collider, wt.rigid_body
    b = port.build_pair_invariants(nt, t.active, c.active, c.radius, c.is_trigger,
                                   rb.static, salt)
    return a, b


@pytest.mark.parametrize("scene", list(SCENES))
def test_pair_invariants_match_reference(scene):
    wj, nj, wt, nt, _cfg, _pc = both(SCENES[scene]())
    a, b = invariants(wj, nj, wt, nt, salt=5)
    for f in ("j", "j_safe", "pair_ok", "min_dist", "respond_scale", "zero_scale"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)
    assert ulps(a.zero_ux, b.zero_ux.numpy()) <= 2.0
    assert ulps(a.zero_uy, b.zero_uy.numpy()) <= 2.0
    if scene.startswith("random"):  # the scene has statics, triggers, inactive rows
        assert set(np.unique(b.respond_scale.numpy())) == {0.0, 0.5, 1.0}


@pytest.mark.parametrize("scene", list(SCENES))
def test_resolve_pass_matches_reference(scene):
    wj, nj, wt, nt, cfg, _pc = both(SCENES[scene]())
    a, b = invariants(wj, nj, wt, nt, salt=0)
    strength = cfg.physics.collision_response_strength
    ra = ref.resolve_collisions_pass(wj.transform.x, wj.transform.y, a, strength)
    rb = port.resolve_collisions_pass(wt.transform.x, wt.transform.y, b, strength)
    np.testing.assert_array_equal(rb[2].numpy(), np.asarray(ra[2]))
    np.testing.assert_array_equal(rb[3].numpy(), np.asarray(ra[3]))
    assert rb[2].dtype == torch.int32 and rb[3].dtype == torch.bool
    assert int(rb[2].sum()) > 0  # the scenes have contacts
    for u, v in zip(ra[:2], rb[:2]):
        scale = np.max(np.abs(np.asarray(u)))
        assert ulps(u, v.numpy(), scale) <= PASS_ULPS


@pytest.mark.parametrize("scene", list(SCENES))
def test_apply_constraints_matches_reference(scene):
    wj, nj, wt, nt, cfg, pc = both(SCENES[scene]())
    wj = wj.replace(step_count=np.int32(3))
    wt = wt.replace(step_count=3)
    a, oa = ref.apply_constraints(wj, nj, cfg)
    b, ob = port.apply_constraints(wt, nt, pc)
    np.testing.assert_array_equal(ob.numpy(), np.asarray(oa))
    np.testing.assert_array_equal(b.rigid_body.collision_count.numpy(),
                                  np.asarray(a.rigid_body.collision_count))
    for comp, f in (("transform", "x"), ("transform", "y"), ("rigid_body", "px"),
                    ("rigid_body", "py")):
        assert ulps(getattr(getattr(a, comp), f),
                    getattr(getattr(b, comp), f).numpy()) <= POS_ULPS, f


def test_physics_step_solver_choice():
    """Solver "neighbors" runs the lists and reports no overflow; without
    lists it raises, as the reference's does; "grid" with no geometry
    falls back to the lists (physics.py:396-416)."""
    s = random_scene(4)
    _wj, _nj, wt, nt, _cfg, pc = both(s)
    w, overflow = port.physics_step(wt, pc, 1.0, None, nt)
    assert int(overflow) == 0 and bool(torch.isfinite(w.transform.x).all())
    with pytest.raises(ValueError, match="neighbor"):
        port.physics_step(wt, pc, 1.0, None)
    grid = dataclasses.replace(pc, physics=dataclasses.replace(pc.physics, solver="grid"))
    w2, _ = port.physics_step(wt, grid, 1.0, None, nt)
    assert torch.equal(w2.transform.x, w.transform.x)


def _step_port(s, solver, steps):
    """The port's physics_step on the scene, each frame over fresh
    brute-force lists (grid: the solver geometry of the largest radius), as
    the reference's ``step_both`` runs it."""
    _wj, _nj, w, _nt, _cfg, pc = both(s, solver)
    geom = (solver_geometry(pc, float(np.max(s.radius))) if solver == "grid" else None)
    for _ in range(steps):
        t, c = w.transform, w.collider
        nbr = (neighbor_lists(t.x, t.y, t.active, c.visual_range, pc)
               if solver == "neighbors" else None)
        w, _ = port.physics_step(w, pc, 1.0, geom, nbr)
        w = w.replace(step_count=w.step_count + 1)
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neighbors_match_grid_trajectories(seed):
    s = random_scene(seed)
    wn, wg = _step_port(s, "neighbors", 5), _step_port(s, "grid", 5)
    for comp, f in (("transform", "x"), ("transform", "y"), ("rigid_body", "px")):
        np.testing.assert_allclose(getattr(getattr(wn, comp), f).numpy(),
                                   getattr(getattr(wg, comp), f).numpy(), atol=2e-3)


def test_neighbors_match_grid_counts_and_pile():
    s = random_scene(7, n=40)
    wn, wg = _step_port(s, "neighbors", 1), _step_port(s, "grid", 1)
    np.testing.assert_array_equal(wn.rigid_body.collision_count.numpy(),
                                  wg.rigid_body.collision_count.numpy())
    s = dense_pile()
    wn, wg = _step_port(s, "neighbors", 3), _step_port(s, "grid", 3)
    np.testing.assert_allclose(wn.transform.x.numpy(), wg.transform.x.numpy(), atol=1e-2)
    np.testing.assert_allclose(wn.transform.y.numpy(), wg.transform.y.numpy(), atol=1e-2)


@pytest.mark.parametrize("case", ["pair", "static", "trigger"])
def test_golden_witness(case):
    """``golden_ref.py``'s sequential oracle on the reference's isolated
    pairs (``tests/test_physics.py::TestCollisions``): Jacobi equals
    Gauss-Seidel there, so positions agree to 1e-4 and counts exactly."""
    cfg = base_cfg(gravity=(0.0, 0.0), sub_step_count=1)
    extra = {"static": dict(static=[True, False]),
             "trigger": dict(is_trigger=[True, False])}.get(case, {})
    s = GoldenState.of(2, x=[500.0, 508.0], y=[400.0, 400.0], px=[500.0, 508.0],
                       py=[400.0, 400.0], radius=[6.0, 6.0], **extra)
    w = world_from_jax(jax.device_get(world_from_golden(s, cfg)), "cpu")
    pc = config_from(cfg)
    t, c = w.transform, w.collider
    w, _ = port.physics_step(w, pc, pc.dt_ratio,
                             None, neighbor_lists(t.x, t.y, t.active, c.visual_range, pc))
    g = run_golden(s, cfg)
    np.testing.assert_allclose(w.transform.x.numpy(), g.x, atol=1e-4)
    np.testing.assert_allclose(w.transform.y.numpy(), g.y, atol=1e-4)
    assert list(w.rigid_body.collision_count.numpy()) == list(g.collision_count)
    if case == "trigger":
        assert w.transform.x.tolist() == [500.0, 508.0]
    if case == "static":
        assert float(w.transform.x[0]) == 500.0


SCENE = dict(n_balls=300, seed=4321, world_width=900.0, world_height=600.0)


def _compare_worlds(a, b, atol):
    for comp, f in (("rigid_body", "collision_count"), ("transform", "active"),
                    ("sprite", "is_on_screen")):
        np.testing.assert_array_equal(getattr(getattr(b, comp), f).numpy(),
                                      np.asarray(getattr(getattr(a, comp), f)), err_msg=f)
    for comp, f in (("transform", "x"), ("transform", "y"), ("rigid_body", "vx"),
                    ("rigid_body", "vy")):
        np.testing.assert_allclose(getattr(getattr(b, comp), f).numpy(),
                                   np.asarray(getattr(getattr(a, comp), f)),
                                   rtol=0, atol=atol, err_msg=f)
    assert b.step_count == int(a.step_count)


def test_engine_neighbors_solver_matches_reference():
    """The balls scene with ``solver="neighbors"`` through both engines for
    3 frames, the mouse held down over the balls; the frame builds the
    lists for the solver alone (Ball.tick reads none)."""
    from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls

    physics = dict(solver="neighbors", gravity=(0.0, 0.5), sub_step_count=2,
                   boundary_elasticity=0.0, collision_response_strength=0.8)
    ej = ref_balls(**SCENE, physics=physics)
    et = make_balls_engine(**SCENE, physics=physics, device="cpu")
    for e in (ej, et):
        e.input.set_mouse(450.0, 300.0)
        e.input.mouse_button(0, True)
    for _ in range(3):
        ej.step(1)
        m = et.step(1)
    plan = et._plan
    assert plan.solver_geom is None and plan.need_neighbors and not plan.nbr_specs
    assert int(m["solver_overflow"]) == 0 and int(m["n_binned"]) == 301
    assert int(et.world.rigid_body.collision_count.sum()) > 0
    _compare_worlds(ej.snapshot(), et.world, ENGINE_ATOL)


def test_update_physics_config_switches_solver():
    """``update_physics_config(solver="neighbors")`` re-plans onto the
    lists, and back to the grid."""
    et = make_balls_engine(n_balls=60, seed=4, device="cpu", world_width=300.0,
                           world_height=200.0)
    et.step(1)
    assert et._plan.solver_geom is not None and not et._plan.need_neighbors
    et.update_physics_config(solver="neighbors")
    m = et.step(2)
    assert et._plan.solver_geom is None and et._plan.need_neighbors
    assert int(m["n_binned"]) == 61 and int(et.world.rigid_body.collision_count.sum()) > 0
    et.update_physics_config(solver="auto")
    et.step(1)
    assert et.config.physics.solver == "pallas" and et._plan.solver_geom is not None


def _drifters(pkg):
    """A scene with no collider radius (reference engine.py:1185-1186): the
    solver falls back to the lists, and the tick reads them."""
    mod = ref_pkg if pkg == "jax" else None
    if pkg == "jax":
        import jax.numpy as jnp

        class Drifter(ref_pkg.EntityClass):
            components = [ref_pkg.RigidBody]

            @staticmethod
            def tick(ctx):
                return {"rigid_body.ax": ctx.neighbor_count.astype(jnp.float32) * 0.01,
                        "rigid_body.ay": jnp.float32(0.05)}

        eng = mod.Engine(world_width=400.0, world_height=300.0, seed=9)
    else:
        class Drifter(EntityClass):
            components = [RigidBody]

            @staticmethod
            def tick(ctx):
                return {"rigid_body.ax": ctx.neighbor_count.to(torch.float32) * 0.01,
                        "rigid_body.ay": torch.tensor(0.05)}

        eng = Engine(make_config(world_width=400.0, world_height=300.0, seed=9), device="cpu")
    eng.register_entity_class(Drifter, 40)
    eng.init()
    rng = np.random.default_rng(5)
    eng.spawn_batch("Drifter", 40, x=rng.uniform(50, 350, 40).astype(np.float32),
                    y=rng.uniform(50, 250, 40).astype(np.float32))
    return eng


def test_radiusless_scene_matches_reference():
    ej, et = _drifters("jax"), _drifters("torch")
    for _ in range(3):
        ej.step(1)
        et.step(1)
    assert et._plan.solver_geom is None and et._plan.need_neighbors
    a, b = ej.snapshot(), et.world
    np.testing.assert_array_equal(b.rigid_body.ax.numpy(), np.asarray(a.rigid_body.ax))
    for f in ("x", "y"):
        assert ulps(getattr(a.transform, f), getattr(b.transform, f).numpy()) <= POS_ULPS
