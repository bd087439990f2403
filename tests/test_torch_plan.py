"""Slice D1, the frame plan: ``FramePlan`` and ``Engine.run_plan`` of the
PyTorch port against the JAX package on the CPU, and against the port's own
immediate control plane.

The reference's bars, each run through both packages on the same scene
(``tests/test_round3.py::TestFramePlan`` and ``TestPlanBatchHooks``;
``tests/test_round4.py::TestPositionResidency``'s two plan cases,
``TestDeviceScreenEvents::test_plan_matches_per_frame`` and
``test_residency_heterogeneous_max_vel_survives_plan_rebins``), with the
churn of ``benchmarks/run_ladder.py``'s ``rung_churn`` at a small size:
despawns and spawns from seeded numpy draws, the balls' radii and colours
from the engine's seeded Mulberry32 stream at plan-build time.

Tolerances, each with its reason:
- within the port, a plan against the same ops issued immediately
  (``despawn_batch`` + ``spawn_batch`` + ``step(1)``), residency on against
  off, chunked against frame by frame: bit-equal, every leaf compared and
  the free lists exact. Both sides compute the same operations on the same
  values in the same order.
- the port against the JAX engine: integer and boolean state exact (active
  flags, contact counts, step counts, the solver's rebin stamp, every free
  list, every hook call), positions within ``POS_ATOL`` = 2e-3 px, 16
  float32 ulps at the 1000-4000 px extents: the JAX engine on the CPU runs
  XLA's grid solver or K2 in Pallas interpret mode, contracts ``a*b + c``
  into fused multiply-adds and approximates ``rsqrt``, where the port
  rounds every operation (``tests/test_torch_balls.py``'s bar; measured at
  most 7.9e-4 over these cases).
"""

import jax
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu_torch as port
from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu_torch.engine import Engine as PortEngine
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine as port_balls

torch.set_num_threads(2)

PKGS = ("jax", "torch")
POS_ATOL = 2e-3
RES_PHYSICS = dict(
    sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
    boundary_elasticity=0.0, collision_response_strength=0.8,
    gravity=(0.0, 0.5), rebin_interval=3, solver="pallas",
    solver_predicated="on",
)


def balls(pkg, **kw):
    return ref_balls(**kw) if pkg == "jax" else port_balls(device="cpu", **kw)


def small_engine(pkg, n):
    """``tests/test_round3.py``'s ``small_engine``."""
    return balls(pkg, n_balls=n, spawn=False, world_width=1000.0, world_height=800.0,
                 spatial=dict(cell_size=50.0, max_neighbors=32))


def res_engine(pkg, residency, n, seed):
    """``tests/test_round4.py``'s ``_res_engine``."""
    return balls(pkg, n_balls=n, seed=seed,
                 physics=dict(RES_PHYSICS, position_residency=residency))


def np_(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(jax.device_get(a))


def signature(eng):
    """Positions, velocities, flags, contact counts, the step count and
    every free list after a sync."""
    eng.sync()
    w = eng.snapshot()
    out = {f"{c}.{f}": np_(getattr(getattr(w, c), f)) for c, f in (
        ("transform", "x"), ("transform", "y"), ("transform", "active"),
        ("rigid_body", "px"), ("rigid_body", "py"), ("rigid_body", "vx"),
        ("rigid_body", "vy"), ("rigid_body", "collision_count"), ("collider", "radius"),
        ("sprite", "tint"))}
    out["step_count"] = int(w.step_count)
    out["free"] = {name: list(map(int, reg.pool.free)) for name, reg in eng.classes.items()}
    return out


FLOATS = ("transform.x", "transform.y", "rigid_body.px", "rigid_body.py", "rigid_body.vx",
          "rigid_body.vy")


def assert_bit_equal(a, b, tag=""):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{tag} {k}")
        else:
            assert a[k] == b[k], (tag, k)


def assert_matches_reference(ref_sig, port_sig, tag=""):
    for k in ref_sig:
        if k in FLOATS:
            np.testing.assert_allclose(port_sig[k], ref_sig[k], rtol=0, atol=POS_ATOL,
                                       err_msg=f"{tag} {k}")
        elif isinstance(ref_sig[k], np.ndarray):
            np.testing.assert_array_equal(port_sig[k].astype(ref_sig[k].dtype), ref_sig[k],
                                          err_msg=f"{tag} {k}")
        else:
            assert port_sig[k] == ref_sig[k], (tag, k)


# ---------------------------------------------------------------------------
# tests/test_round3.py::TestFramePlan
# ---------------------------------------------------------------------------

def churn(pkg, mode, n=80, frames=6, per_frame=8, max_chunk=4):
    """TestFramePlan's churn: 40 balls, then ``frames`` frames each
    despawning ``per_frame`` active balls and spawning as many, through a
    plan (``mode`` "plan" or "per_frame", the latter the port's
    frame-at-a-time oracle) or immediately ("immediate")."""
    eng = small_engine(pkg, n)
    rng = np.random.default_rng(3)
    eng.spawn_batch("Ball", 40, x=rng.uniform(100, 900, 40).astype(np.float32),
                    y=rng.uniform(100, 700, 40).astype(np.float32))
    eng.step(2, block=True)
    sched = np.random.default_rng(11)
    plan = eng.begin_plan() if mode != "immediate" else None
    for _ in range(frames):
        kill = sched.choice(eng.active_indices("Ball"), size=per_frame, replace=False)
        xs = sched.uniform(100, 900, per_frame).astype(np.float32)
        ys = sched.uniform(100, 700, per_frame).astype(np.float32)
        if plan is not None:
            plan.despawn_batch(kill)
            plan.spawn_batch("Ball", per_frame, x=xs, y=ys)
            plan.next_frame()
        else:
            eng.despawn_batch(kill)
            eng.spawn_batch("Ball", per_frame, x=xs, y=ys)
            eng.step(1)
    if mode == "plan":
        eng.run_plan(plan, max_chunk=max_chunk)
    elif mode == "per_frame":
        eng._run_plan_per_frame(plan)
    return signature(eng)


def test_churn_three_way():
    """One seeded churn through the JAX engine's plan, the port's plan and
    the port's immediate ops (and its frame-at-a-time plan oracle): the
    port's three bit-equal, and the JAX plan's world and free lists."""
    port_plan = churn("torch", "plan")
    assert_bit_equal(port_plan, churn("torch", "immediate"), "immediate")
    assert_bit_equal(port_plan, churn("torch", "per_frame"), "per_frame")
    assert_matches_reference(churn("jax", "plan"), port_plan)


def singles(pkg, use_plan):
    eng = small_engine(pkg, 30)
    ids = [eng.spawn("Ball", x=50.0 * (i + 1), y=100.0) for i in range(10)]
    eng.step(1, block=True)
    plan = eng.begin_plan() if use_plan else None
    tgt = plan if use_plan else eng
    for f in range(4):
        tgt.despawn(ids[f])
        ids.append(tgt.spawn("Ball", x=25.0 * (f + 1), y=50.0))
        if use_plan:
            plan.next_frame()
        else:
            eng.step(1)
    if use_plan:
        eng.run_plan(plan)
    return signature(eng), ids


def test_plan_singles_match_immediate():
    (sig_p, ids_p), (sig_i, ids_i) = singles("torch", True), singles("torch", False)
    assert ids_p == ids_i
    assert_bit_equal(sig_p, sig_i)
    sig_j, ids_j = singles("jax", True)
    assert ids_j == ids_p
    assert_matches_reference(sig_j, sig_p)


def inputs_run(pkg, use_plan):
    eng = small_engine(pkg, 8)
    eng.spawn("Ball", x=500.0, y=400.0)
    eng.step(1, block=True)
    plan = eng.begin_plan() if use_plan else None
    for mx, my in ((100.0, 100.0), (500.0, 405.0), (900.0, 900.0)):
        eng.input.set_mouse(mx, my)
        eng.input.mouse_button(0, True)
        if use_plan:
            plan.next_frame()
        else:
            eng.step(1)
    if use_plan:
        eng.run_plan(plan)
    return signature(eng)


def test_plan_per_frame_inputs():
    """Each planned frame sees the input captured at its ``next_frame``
    (the reference samples the inputs every frame, logic_worker.js:293)."""
    sig_p = inputs_run("torch", True)
    assert_bit_equal(sig_p, inputs_run("torch", False))
    assert_matches_reference(inputs_run("jax", True), sig_p)


def test_plan_chunking_splits_dispatches(monkeypatch):
    sizes = []
    run_chunk = PortEngine._run_plan_chunk

    def spy(self, frames, events_on):
        sizes.append(len(frames))
        return run_chunk(self, frames, events_on)

    monkeypatch.setattr(PortEngine, "_run_plan_chunk", spy)
    counts = {}
    for pkg in PKGS:
        eng = small_engine(pkg, 16)
        eng.spawn("Ball", x=300.0, y=300.0)
        eng.step(1, block=True)
        plan = eng.begin_plan()
        for _ in range(7):
            plan.next_frame()
        eng.run_plan(plan, max_chunk=3)
        counts[pkg] = signature(eng)["step_count"]
    assert counts == {"jax": 8, "torch": 8}
    assert sizes == [3, 3, 1]


def hook_class(pkg, name, log, **extra):
    mod = ref if pkg == "jax" else port
    ns = {"components": [mod.Collider], "uses_neighbors": False,
          "setup": classmethod(lambda cls, ctx: {"collider.radius": 10.0,
                                                 "rigid_body.static": True,
                                                 "collider.visual_range": 60.0})}
    ns.update({k: staticmethod(v) for k, v in extra.items()})
    return type(name, (mod.EntityClass,), ns)


def hook_engine(pkg, cls, count, **physics):
    mod = ref if pkg == "jax" else port
    cfg = mod.make_config(world_width=500.0, world_height=500.0,
                          spatial=dict(cell_size=50.0, max_neighbors=8),
                          logic=dict(collision_events=True, event_chunk=4), physics=physics)
    eng = mod.Engine(cfg) if pkg == "jax" else mod.Engine(cfg, device="cpu")
    eng.register_entity_class(cls, count)
    eng.init()
    return eng


def plan_events(pkg, use_plan):
    log = []
    cls = hook_class(pkg, "_PlanHook", log,
                     on_collision_enter=lambda ctx, me, other: log.append(("enter", me, other)),
                     on_collision_stay=lambda ctx, me, other: log.append(("stay", me, other)))
    eng = hook_engine(pkg, cls, 4)
    eng.spawn("_PlanHook", x=100.0, y=100.0)
    eng.step(1, block=True)
    plan = eng.begin_plan() if use_plan else None
    (plan if use_plan else eng).spawn("_PlanHook", x=110.0, y=100.0)
    for _ in range(3):
        if use_plan:
            plan.next_frame()
        else:
            eng.step(1)
    if use_plan:
        eng.run_plan(plan)
    return [(k, int(a), int(b)) for k, a, b in log]


def test_plan_with_collision_events():
    """Planned frames fire the per-frame Enter/Stay hooks as immediate
    stepping does, and as the JAX engine's plan does."""
    log_p = plan_events("torch", True)
    assert log_p == plan_events("torch", False) == plan_events("jax", True)
    assert any(k == "enter" for k, *_ in log_p) and any(k == "stay" for k, *_ in log_p)


def batch_hook_calls(pkg):
    calls = []
    cls = hook_class(pkg, "_PB", calls, on_collision_enter_batch=lambda ctx, me, other: calls.append(
        (list(map(int, np.asarray(me))), list(map(int, np.asarray(other))))))
    eng = hook_engine(pkg, cls, 8, gravity=(0.0, 0.0))
    eng.spawn("_PB", x=100.0, y=100.0)
    eng.step(1, block=True)
    plan = eng.begin_plan()
    plan.spawn("_PB", x=110.0, y=100.0)  # the contact appears mid-plan
    for _ in range(3):
        plan.next_frame()
    eng.run_plan(plan)
    return calls


def test_batch_hook_fires_through_frame_plan():
    """TestPlanBatchHooks: one Enter frame, one batch call with both
    orientations, the same in both packages."""
    calls = batch_hook_calls("torch")
    assert calls == batch_hook_calls("jax")
    assert len(calls) == 1
    me, other = calls[0]
    assert sorted(me) == sorted(other) and len(me) == 2


# ---------------------------------------------------------------------------
# tests/test_round4.py: plans under position residency
# ---------------------------------------------------------------------------

#: name -> (balls, seed, frames, op frames, per-op count, max_chunk)
RES_PLANS = {
    # every frame writes: dense chunks, run off the resident layout
    "dense": (200, 9, 6, range(6), 16, 4),
    # two op frames in chunks of 6: sparse chunks keep residency, and every
    # frame of a chunk that writes rebins (engine.py:2450-2453)
    "sparse": (200, 9, 12, (0, 5), 8, 6),
}


def resident_plan(pkg, residency, case):
    n, seed, frames, op_frames, k, max_chunk = RES_PLANS[case]
    eng = res_engine(pkg, residency, n, seed)
    eng.step(3)
    r = np.random.default_rng(42)
    plan = eng.begin_plan()
    for f in range(frames):
        if f in op_frames:
            plan.despawn_batch(r.choice(eng.active_indices("Ball"), size=k, replace=False))
            plan.spawn_batch("Ball", k, x=r.uniform(100, 8000, k).astype(np.float32),
                             y=r.uniform(100, 900, k).astype(np.float32))
        plan.next_frame()
    eng.run_plan(plan, max_chunk=max_chunk)
    stamp = int(eng.world.solver_bin_step)
    eng.step(3)
    return signature(eng), stamp


@pytest.mark.parametrize("case", sorted(RES_PLANS))
def test_resident_plan_parity(case):
    """``test_frameplan_resident_parity`` and ``_sparse_ops_parity``: a
    churning plan under residency "on" equals residency "off" bit for bit,
    and the JAX engine's "on" run, with the same rebin stamp after the
    plan (the chunk-wide invalidation)."""
    (on, stamp_on), (off, stamp_off) = (resident_plan("torch", r, case) for r in ("on", "off"))
    assert_bit_equal(on, off, case)
    ref_sig, ref_stamp = resident_plan("jax", "on", case)
    assert stamp_on == stamp_off == ref_stamp
    assert_matches_reference(ref_sig, on, case)


def test_op_density_gate(monkeypatch):
    """A chunk whose frames mostly write (``2 * op frames >= frames``,
    engine.py:2397) runs its frames off the resident layout; a sparse one
    keeps the plan's residency."""
    seen, in_chunk = [], []
    one_step, run_chunk = PortEngine._one_step, PortEngine._run_plan_chunk

    def spy_step(self, world, inputs, residency=None):
        if in_chunk:
            seen.append(residency)
        return one_step(self, world, inputs, residency)

    def spy_chunk(self, frames, events_on):
        in_chunk.append(True)
        try:
            return run_chunk(self, frames, events_on)
        finally:
            in_chunk.clear()

    monkeypatch.setattr(PortEngine, "_one_step", spy_step)
    monkeypatch.setattr(PortEngine, "_run_plan_chunk", spy_chunk)
    resident_plan("torch", "on", "sparse")
    assert seen == [None] * 12
    seen.clear()
    resident_plan("torch", "on", "dense")
    assert seen == [False] * 6


def hetero_max_vel(pkg, residency):
    eng = res_engine(pkg, residency, 300, 21)
    r = np.random.default_rng(4)
    eng.despawn_batch(eng.active_indices("Ball"))
    eng.spawn_batch("Ball", 300, x=r.uniform(100, 8000, 300).astype(np.float32),
                    y=r.uniform(100, 900, 300).astype(np.float32),
                    **{"rigid_body.max_vel": r.uniform(2, 40, 300).astype(np.float32)})
    eng.step(4)
    plan = eng.begin_plan()
    for _ in range(5):
        plan.next_frame()
    eng.run_plan(plan, max_chunk=5)
    eng.step(4)
    return signature(eng)


def test_residency_heterogeneous_max_vel_survives_plan_rebins():
    """An op-free plan chunk after per-entity ``max_vel`` writes keeps the
    layout's ``solver_maxv`` current: "on" equals "off" and the JAX run."""
    on = hetero_max_vel("torch", "on")
    assert_bit_equal(on, hetero_max_vel("torch", "off"))
    assert_matches_reference(hetero_max_vel("jax", "on"), on)


# ---------------------------------------------------------------------------
# tests/test_round4.py::TestDeviceScreenEvents::test_plan_matches_per_frame
# ---------------------------------------------------------------------------

def screen_events(pkg, use_plan, frames=24):
    """The drifters of ``TestDeviceScreenEvents``, radius 20 (as
    ``tests/test_torch_events.py`` runs them, for a smaller solver grid)."""
    events = []
    mod = ref if pkg == "jax" else port
    cls = type("Drifter", (mod.EntityClass,), {
        "components": [mod.RigidBody, mod.Collider, mod.SpriteRenderer],
        "uses_neighbors": False,
        "setup": classmethod(lambda c, ctx: {"collider.radius": 20.0,
                                             "rigid_body.max_vel": 500.0}),
        "on_screen_enter": staticmethod(lambda i: events.append(("enter", int(i)))),
        "on_screen_exit": staticmethod(lambda i: events.append(("exit", int(i))))})
    cfg = mod.make_config(canvas_width=400, canvas_height=300, world_width=4000.0,
                          world_height=600.0, logic=dict(screen_events=True, event_chunk=4),
                          physics=dict(gravity=(0.0, 0.0), max_collision_pairs=1))
    eng = mod.Engine(cfg) if pkg == "jax" else mod.Engine(cfg, device="cpu")
    eng.register_entity_class(cls, 6)
    eng.init()
    eng.input.camera_x, eng.input.camera_y = 200.0, 150.0
    eng.spawn("Drifter", x=100.0, y=150.0, vx=40.0)
    eng.spawn("Drifter", x=-600.0, y=150.0, vx=40.0)
    if use_plan:
        plan = eng.begin_plan()
        for _ in range(frames):
            plan.next_frame()
        eng.run_plan(plan, max_chunk=8)
    else:
        for _ in range(frames):
            eng.step(1)
    eng.sync()
    return events


def test_screen_events_plan_matches_per_frame():
    planned = screen_events("torch", True)
    assert planned == screen_events("torch", False) == screen_events("jax", True)
    assert {k for k, _ in planned} == {"enter", "exit"}
