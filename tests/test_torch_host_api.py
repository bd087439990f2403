"""Slice D1, the rest of the Engine's host API: batch despawns, active
indices, ``despawn_all``, pause and resume, ``destroy``, the step timer and
``stats()``, the phase profiler, the debug flags and the ``utils.mathx``
helpers of the PyTorch port, against the JAX package on the CPU.

The reference's bars, each run through both packages on the same scene:
``tests/test_engine.py`` (``test_despawn_all``, ``test_pause_resume``,
``test_despawn_batch_releases_and_clears``,
``test_despawn_batch_double_despawn_guard``,
``test_batch_matches_singles_after_churn``), ``tests/test_round2.py``
(``test_despawn_all_vectorized``, ``test_destroy_then_reinit``),
``tests/test_round3.py`` (``TestDespawnOrderParity``,
``TestReleaseManyRangeGuard``) and ``tests/test_aux.py`` (``TestStats``,
``TestDebugFlags``).

Tolerances: pool state (free lists, active counts, claimed indices), active
flags, radii, colours, step counts and hook calls exact; positions within
2e-3 px (``tests/test_torch_plan.py``'s bar and reason). The ``mathx``
helpers: integer colours exact, float results equal to float32 rounding
(both packages compute each in float32 in the same order).
"""

import json

import jax
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu.utils as ref_utils
import multithreadedgameengine_tpu_torch as port
import multithreadedgameengine_tpu_torch.utils as port_utils
from multithreadedgameengine_tpu.debugging import Debug as RefDebug
from multithreadedgameengine_tpu.state import EntityPool as RefPool
from multithreadedgameengine_tpu_torch.debugging import Debug
from multithreadedgameengine_tpu_torch.state import EntityPool
from test_torch_plan import POS_ATOL, PKGS, np_, small_engine

torch.set_num_threads(2)


def active(eng):
    return np_(eng.world.transform.active)


def free_lists(eng):
    return {name: list(map(int, reg.pool.free)) for name, reg in eng.classes.items()}


def both(fn):
    """``fn(pkg)`` for each package, as {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PKGS}


# ---------------------------------------------------------------------------
# utils.mathx
# ---------------------------------------------------------------------------

_B = np.asarray([-0.5, 0.0, 0.2, 0.5, 0.7, 1.0, 1.7], np.float32)
_C = np.asarray([0x000000, 0xFFFFFF, 0x123456, 0xFF8040, 0x4ECDC4], np.uint32)
MATHX_CASES = {
    "clamp": lambda m, t: m.clamp(t(np.linspace(-3, 3, 7, dtype=np.float32)), -1.0, 2.0),
    "clamp01": lambda m, t: m.clamp01(t(_B)),
    "lerp": lambda m, t: m.lerp(t(_B), t(_B[::-1].copy()), t(_B * 0.3)),
    "distance_sq_2d": lambda m, t: m.distance_sq_2d(t(_B), t(_B * 2), t(_B[::-1].copy()), 3.0),
    "pack_rgb": lambda m, t: m.pack_rgb(t(np.asarray([0, 255, 18], np.uint32)),
                                        t(np.asarray([128, 0, 52], np.uint32)),
                                        t(np.asarray([7, 255, 86], np.uint32))),
    "unpack_rgb": lambda m, t: m.unpack_rgb(t(_C)),
    "brightness_to_tint": lambda m, t: m.brightness_to_tint(t(_B)),
    "brightness_to_colored_tint": lambda m, t: m.brightness_to_colored_tint(t(_B), 0xFF8040),
    "brightness_to_colored_tint_scalar": lambda m, t: m.brightness_to_colored_tint(0.35),
    "rgb_to_bgr": lambda m, t: m.rgb_to_bgr(t(_C)),
}


def _port_tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("name", sorted(MATHX_CASES))
def test_mathx_helpers_match_reference(name):
    case = MATHX_CASES[name]
    want = case(ref_utils, jax.numpy.asarray)
    got = case(port_utils, _port_tensor)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            assert g.dtype == np.int64
            g = g.astype(np.uint32)
        np.testing.assert_array_equal(g, w)


def test_utils_exports_match_reference():
    # utils.cache is the XLA compile cache, which the port has no use for
    public = {n for n in dir(ref_utils)
              if not n.startswith("_") and n not in ("mathx", "cache")}
    assert public <= set(dir(port_utils))
    assert set(ref.__all__) == set(port.__all__)


# ---------------------------------------------------------------------------
# tests/test_aux.py::TestDebugFlags and TestStats
# ---------------------------------------------------------------------------

def test_debug_flags_chainable_and_presets():
    def drive(d):
        d.show_colliders().show_grid().show_velocity(False)
        first = dict(d.flags)
        d.disable_all().enable_physics_debug()
        second = dict(d.flags)
        d.enable_ai_debug().show_trail().show_indices()
        return first, second, dict(d.flags)

    got, want = drive(Debug()), drive(RefDebug())
    assert got == want
    assert got[0]["colliders"] and got[0]["grid"] and not got[0]["velocity"]
    # the engine's flags; the profiler flag switches the engine's profiling
    for pkg in PKGS:
        eng = small_engine(pkg, 4)
        eng.debug.enable_performance_debug()
        assert eng.debug["fps"] and eng.debug["profiler"] and eng._profiling
        eng.debug.show_profiler(False)
        assert not eng._profiling


def stats_run(pkg):
    eng = small_engine(pkg, 30)
    for _ in range(10):
        eng.spawn("Ball", x=eng.rng() * 800.0, y=eng.rng() * 600.0)
    eng.enable_profiling(True)
    eng.step(3)  # the call that builds the plan: no timing sample
    eng.step(2)
    return eng, eng.stats()


def test_stats_and_timer():
    runs = both(stats_run)
    (ej, sj), (et, st) = runs["jax"], runs["torch"]
    # the pair metrics exist only with collision events in the port, and
    # the port alone counts the lists' accepted neighbours: kept
    # differences (ROADMAP.md section 3)
    assert st.keys() == ((sj.keys() - {"collision_pair_count", "collision_pairs_dropped"})
                         | {"neighbors_accepted"})
    assert st["neighbors_accepted"] == -1  # balls build no lists
    assert st["total_steps"] == sj["total_steps"] == 5
    assert st["steps_per_sec"] > 0 and st["ms_per_step"] > 0
    assert st["pools"] == sj["pools"]
    assert st["pools"]["Ball"]["active"] == 10
    for key in ("active_count", "solver_overflow", "nonfinite_count"):
        assert st[key] == sj[key]
    assert st["active_count"] == 11  # 10 balls and the mouse
    assert [m for _t, m in et.timeline.entries] == [m for _t, m in ej.timeline.entries]
    assert et.timer.total_steps == 5 and len(et.timer._samples) == 1


def test_timeline_logs_pool_exhaustion():
    def run(pkg):
        eng = small_engine(pkg, 2)
        eng.spawn_batch("Ball", 3, x=1.0, y=1.0)
        assert eng.spawn("Ball", x=2.0, y=2.0) is None
        return [m for _t, m in eng.timeline.entries]

    runs = both(run)
    assert runs["torch"] == runs["jax"]
    assert len(runs["torch"]) == 3  # constructed, the batch's shortfall, the single


def test_phase_profiler_and_trace(tmp_path):
    """``profile_phases`` times the reference's five phases without
    changing the world; ``trace`` writes a Chrome trace of real frames."""
    def profiled(pkg):
        eng = small_engine(pkg, 20)
        for _ in range(10):
            eng.spawn("Ball", x=eng.rng() * 800.0, y=eng.rng() * 600.0)
        eng.step(1)
        return eng, eng.profiler.profile_phases(reps=2)

    (_ej, ref_phases), (eng, phases) = profiled("jax"), profiled("torch")
    assert set(phases) == set(ref_phases) == {"spatial", "logic", "verlet_move", "derived",
                                              "full_step"}
    assert all(v >= 0 for v in phases.values())
    before = eng.world
    eng.profiler.profile_phases(reps=1)
    assert eng.world is before and eng.world.step_count == 1
    path = eng.profiler.trace(str(tmp_path / "trace.json"), steps=2)
    assert (tmp_path / "trace.json").stat().st_size > 0 and path.endswith("trace.json")
    assert eng.world.step_count == 3
    # the trace names the engine's spans; a scene that builds neighbour
    # lists opens ops.spatial
    from test_torch_spans import boids_engine

    boids = boids_engine(n=60)
    boids.profiler.trace(str(tmp_path / "boids.json"), steps=2)
    trace = json.loads((tmp_path / "boids.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"engine.step", "engine.prepare", "ops.spatial", "behavior", "ops.physics"} <= names


# ---------------------------------------------------------------------------
# tests/test_engine.py and tests/test_round2.py
# ---------------------------------------------------------------------------

def test_despawn_all():
    def run(pkg):
        eng = small_engine(pkg, 8)
        for _ in range(8):
            eng.spawn("Ball", x=5.0, y=5.0)
        eng.step()
        eng.despawn_all()
        eng.step()
        return active(eng), eng.get_pool_stats("Ball"), free_lists(eng)

    runs = both(run)
    a, stats, free = runs["torch"]
    assert a[0] and not a[1:].any()  # the mouse survives
    assert stats["available"] == 8
    np.testing.assert_array_equal(a, runs["jax"][0])
    assert (stats, free) == runs["jax"][1:]


def test_despawn_all_vectorized():
    def run(pkg):
        eng = small_engine(pkg, 32)
        idx = eng.spawn_batch("Ball", 32, x=np.linspace(10, 900, 32), y=np.full(32, 50.0))
        assert idx.size == 32
        eng.despawn_all("Ball")
        out = (eng.get_pool_stats("Ball"), active(eng), np_(eng.world.rigid_body.active),
               np_(eng.world.collider.active), np_(eng.world.sprite.active), free_lists(eng))
        # the pool is coherent: a fresh spawn works
        assert eng.spawn("Ball", x=5.0, y=5.0) is not None
        return out

    runs = both(run)
    stats, act, rb, col, spr, free = runs["torch"]
    assert stats["active"] == 0 and stats["available"] == 32
    assert act[0] and not act[1:].any()
    assert not rb[1:].any() and not col[1:].any() and not spr[1:].any()
    for g, w in zip(runs["torch"], runs["jax"]):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_pause_resume():
    """``step`` and ``run_plan`` return at once while paused."""
    def run(pkg):
        eng = small_engine(pkg, 4)
        eng.spawn("Ball", x=10.0, y=10.0)
        eng.step()
        counts = [int(eng.world.step_count)]
        eng.pause()
        eng.step(3)
        plan = eng.begin_plan()
        plan.next_frame()
        eng.run_plan(plan)
        counts.append(int(eng.world.step_count))
        eng.resume()
        eng.step()
        eng.run_plan(plan)
        counts.append(int(eng.world.step_count))
        return counts

    runs = both(run)
    assert runs["torch"] == runs["jax"] == [1, 1, 3]


def test_despawn_batch_releases_and_clears():
    def run(pkg):
        eng = small_engine(pkg, 40)
        idx = eng.spawn_batch("Ball", 30, x=1.0, y=1.0)
        victims = idx[:10]
        assert eng.despawn_batch(victims) == 10
        act = eng.active_indices("Ball")
        return idx, act, active(eng), free_lists(eng)

    runs = both(run)
    idx, act, a, free = runs["torch"]
    assert act.size == 20 and not np.intersect1d(act, idx[:10]).size
    assert not a[idx[:10]].any() and a[act].all()
    for g, w in zip(runs["torch"][:3], runs["jax"][:3]):
        np.testing.assert_array_equal(g, w)
    assert free == runs["jax"][3]


def test_despawn_batch_double_despawn_guard():
    def run(pkg):
        eng = small_engine(pkg, 20)
        idx = eng.spawn_batch("Ball", 10, x=1.0, y=1.0)
        released = [eng.despawn_batch(idx[:4]), eng.despawn_batch(idx[:4])]
        after = eng.get_pool_stats("Ball")["active"]
        again = eng.spawn_batch("Ball", 4, x=2.0, y=2.0)
        return released, after, list(map(int, again)), eng.get_pool_stats("Ball"), \
            free_lists(eng)

    runs = both(run)
    released, after, again, stats, _free = runs["torch"]
    assert released == [4, 0] and after == 6 and len(again) == 4 and stats["active"] == 10
    assert runs["torch"] == runs["jax"]


def test_batch_matches_singles_after_churn():
    """A churn cycle through the batch APIs equals the same cycle through
    per-call spawn/despawn (same pool order, same seeded draws), in both
    packages."""
    def build(pkg, batch):
        eng = small_engine(pkg, 30)
        xs = [eng.rng() * 1000.0 for _ in range(12)]
        ys = [eng.rng() * 800.0 for _ in range(12)]
        if batch:
            idx = eng.spawn_batch("Ball", 12, x=np.asarray(xs), y=np.asarray(ys))
            eng.despawn_batch(idx[3:6])
        else:
            idx = [eng.spawn("Ball", x=xs[k], y=ys[k]) for k in range(12)]
            for i in idx[3:6]:
                eng.despawn(i)
        eng.step(3)
        w = eng.snapshot()
        return [np_(v) for v in (w.transform.active, w.transform.x, w.collider.radius)]

    for pkg in PKGS:
        for a, b in zip(build(pkg, False), build(pkg, True)):
            np.testing.assert_array_equal(a, b)
    (ta, tx, tr), (ja, jx, jr) = build("torch", True), build("jax", True)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=POS_ATOL)


def test_destroy_then_reinit():
    """``destroy`` resets the pools, queued ops and the event state, so a
    re-initialised engine has a live mouse and a clean control plane."""
    def run(pkg):
        eng = small_engine(pkg, 4)
        eng.spawn("Ball", x=10.0, y=10.0)
        eng.step(1)
        eng.spawn("Ball", x=20.0, y=10.0)  # queued, dropped by destroy
        eng.destroy()
        assert eng.world is None
        eng.init()
        mouse = eng.get_pool_stats("Mouse")["active"]
        i = eng.spawn("Ball", x=10.0, y=10.0)
        eng.step(1)
        return mouse, i, int(eng.world.step_count), eng.get_pool_stats("Ball"), active(eng)

    runs = both(run)
    mouse, i, steps, stats, a = runs["torch"]
    assert mouse == 1 and i is not None and steps == 1 and stats["active"] == 1
    assert runs["torch"][:4] == runs["jax"][:4]
    np.testing.assert_array_equal(a, runs["jax"][4])


# ---------------------------------------------------------------------------
# tests/test_round3.py::TestDespawnOrderParity and TestReleaseManyRangeGuard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [[9, 3, 7, 1, 8], [2, 4, 2, 0, 4]],
                         ids=["nonascending", "duplicates"])
def test_despawn_batch_order_matches_singles(order):
    """``despawn_batch`` leaves the free stack (so every later spawn's slot)
    as the same despawns issued one by one; duplicates count at their first
    occurrence."""
    def run(pkg, batch):
        eng = small_engine(pkg, 20)
        ids = [eng.spawn("Ball", x=float(i), y=1.0) for i in range(12)]
        kill = [ids[k] for k in order]
        if batch:
            released = eng.despawn_batch(kill)
        else:
            for i in kill:
                eng.despawn(i)
            released = len(set(kill))
        re = eng.spawn_batch("Ball", 5, x=np.arange(5, dtype=np.float32))
        return released, list(map(int, re)), free_lists(eng)

    runs = {(pkg, batch): run(pkg, batch) for pkg in PKGS for batch in (True, False)}
    assert len({repr(v) for v in runs.values()}) == 1
    assert runs[("torch", True)][0] == len(set(order))


@pytest.mark.parametrize("pool_cls", [EntityPool, RefPool], ids=["port", "reference"])
def test_release_many_range_guard_and_order(pool_cls):
    pool = pool_cls(start=100, count=16)
    a, b = pool.claim(), pool.claim()
    pool.release_many([a, 5, 99, 116, 1000, b])  # only a and b are in range
    assert pool.free_count == 16 and pool.active_count == 0
    assert sorted(pool.free.tolist()) == list(range(100, 116))
    pool = pool_cls(start=0, count=8)
    claimed = [pool.claim() for _ in range(4)]
    pool.release_many(claimed[::-1])
    assert [pool.claim() for _ in range(4)] == claimed
