"""The port's scenes on the card (``torch_scenes.py`` builds them): each
main path through ``Engine.step`` with its kernels' launch counts, the
slab steps against ``Engine.step``, residency on against off, frame plans
and chunked events against frame-by-frame runs, the frames that may not
wait for the card (``torch.cuda.set_sync_debug_mode("error")``), the card
against the CPU, the render server with a client over localhost, and the
process mesh on the card against the in-process mesh. Marked ``cuda``;
each test skips without a card. A test of a 1M-row scene has ``1m`` in
its id, so ``-k "not 1m"`` leaves those out. On a machine with a card:
``python -m pytest tests/test_torch_cuda_scenes.py -m cuda --noconftest -q``
(``--noconftest``: the test directory's conftest sets up JAX, which these
tests do not use).

Tolerances: integers, launch counts and the slab steps against
``Engine.step`` exact; the card against the CPU within 8 float32 ulps at
the world's extent where the ticks' or the lists' sums run in another
order on the card (canvas bytes within 1); the neighbour-list solver
against the grid solver within the reference's 2e-3."""

import contextlib
import json
import os
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import torch_scenes as scenes
from torch_scenes import KERNELS, launches, zero_launches

pytestmark = pytest.mark.cuda

SEED = scenes.SEED
#: the 100k checks: 100,000 entities at the demo's density
CHECK_N, CHECK_WORLD = 100_000, (9000.0 * 10 ** 0.5, 4000.0 * 10 ** 0.5)
#: the 400-prey scene on the card against the CPU and with events
PRED_REF = dict(n_prey=400, n_predators=8, n_lights=5, world_width=1600.0, world_height=1000.0)
PRED_REF_FRAMES = 6
REF_ULPS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def assert_launches(seen=None, **counts):
    """The launches since :func:`zero_launches` (or ``seen``): ``counts``
    where given, and none of the pair passes and K4 where not; a tick not
    given is not counted."""
    seen = launches() if seen is None else seen
    for name in KERNELS:
        if name in counts or not name.endswith("_tick"):
            assert seen[name] == counts.get(name, 0), (name, seen)


def finite(w) -> bool:
    return bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all())


def ulps(n, extent) -> float:
    return n * float(np.spacing(np.float32(extent)))


def world_diff(a, b, replicated=True):
    """The entity leaves (and replicated leaves) of two port worlds that
    differ: {name: max abs difference or count of differing entries}."""
    import dataclasses

    from multithreadedgameengine_tpu_torch.parallel.halo import (
        REPLICATED,
        _get_comp,
        entity_leaf_specs,
    )

    def cmp(name, u, v, out):
        if u is None and v is None:
            return
        if not torch.equal(u, v):
            out[name] = ((u.double() - v.double()).abs().max().item()
                         if u.dtype == torch.float32 else int((u != v).sum().item()))

    out = {}
    for cname, fname, _dt in entity_leaf_specs(a):
        cmp(f"{cname}.{fname}", getattr(_get_comp(a, cname), fname),
            getattr(_get_comp(b, cname), fname), out)
    if replicated:
        for name in REPLICATED:
            u, v = getattr(a, name), getattr(b, name)
            if name in ("collision_pairs", "prev_collision_pairs", "shadow_sprites"):
                continue  # slab order / inactive slots: compared by their own checks
            if isinstance(u, torch.Tensor) or u is None:
                cmp(name, u, v, out)
            else:
                for f in dataclasses.fields(u):
                    cmp(f"{name}.{f.name}", getattr(u, f.name), getattr(v, f.name), out)
    return out


def shadows_equal(a, b) -> bool:
    """The active shadow slots of two worlds, and their values, equal."""
    sa, sb = (w.shadow_sprites.map_tensors(torch.Tensor.cpu) for w in (a, b))
    return bool(torch.equal(sa.active, sb.active)) and all(
        torch.equal(getattr(sa, f)[sa.active], getattr(sb, f)[sb.active])
        for f in ("x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius"))


def no_host_reads(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits for the card inside it raises."""
    def wrapped(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return wrapped


@contextlib.contextmanager
def guarded_plan_frames(eng):
    """Every frame of every plan chunk run inside the block, and its op
    table's upload, under the sync check: the chunk's upload, scatters,
    frames and event-log writes may not wait for the card. Yields
    {"frames": the count of guarded frames}."""
    from multithreadedgameengine_tpu_torch import engine as engine_mod

    count = {"frames": 0}
    saved = (engine_mod._scatter_columns, engine_mod._EventLog.write)
    one_step = eng._one_step

    def frame(*args, **kw):
        count["frames"] += 1
        return no_host_reads(one_step)(*args, **kw)

    eng._one_step = frame
    eng._plan_chunk_tables = no_host_reads(eng._plan_chunk_tables)
    engine_mod._scatter_columns = no_host_reads(saved[0])
    engine_mod._EventLog.write = no_host_reads(saved[1])
    try:
        yield count
    finally:
        engine_mod._scatter_columns, engine_mod._EventLog.write = saved
        del eng._one_step, eng._plan_chunk_tables


def run_frames(step, state, ins, warmup, frames, guard=True):
    """``warmup`` frames of a slab step, one more under the sync check
    (``guard``), then ``frames``. Returns (state, every frame's metrics
    after the warm-up)."""
    for _ in range(warmup):
        *state, m = step(*state, ins)
    seen = []
    if guard:
        torch.cuda.synchronize()
        *state, m = no_host_reads(step)(*state, ins)
        seen.append(m)
    for _ in range(frames):
        *state, m = step(*state, ins)
        seen.append(m)
    torch.cuda.synchronize()
    return state, seen


def host_ints(m) -> dict:
    return {k: int(v.item()) for k, v in m.items()}


# ---------------------------------------------------------------------------
# the main paths through Engine.step
# ---------------------------------------------------------------------------

def test_demo_scene_runs_k1_once_a_substep_on_card(cuda):
    """``bench.py``'s scene, 10,000 balls, 10 + 4 x 30 frames: K1 (the
    reference's gate picks the two-sided pass at this width) once a
    substep, no other kernel, finite."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=scenes.N_MAIN, seed=SEED, device=cuda)
    zero_launches()
    eng.step(10, block=True)
    for _ in range(4):
        eng.step(30)
    eng.sync()
    subs = eng.config.physics.sub_step_count
    assert eng.world.step_count == 130 and finite(eng.world)
    assert_launches(pair_pass_resident=130 * subs)


def test_ladder_1m_runs_resident_banded_and_lazy_with_k2_on_card(cuda):
    """The JAX ladder's 1M rung (the auto knobs), 5 + 20 frames: K2 with
    the folded clamp once a substep and no other kernel, residency, the
    banded boundary and the lazy chunk on, no overflow, no band drift."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=1_000_000, seed=SEED, device=cuda, world_width=90_000.0,
                            world_height=40_000.0, physics=scenes.LADDER_PHYSICS)
    zero_launches()
    eng.step(5, block=True)
    eng.step(20)
    eng.sync()
    w, plan, m = eng.world, eng._plan, host_ints(eng.metrics)
    assert w.step_count == 25 and finite(w)
    assert_launches(pair_pass_symmetric=25 * eng.config.physics.sub_step_count)
    assert m["solver_overflow"] == 0 and m["boundary_band_drift"] == 0
    assert plan.residency and plan.symmetric and plan.band_vel_bound > 0 and eng.lazy_frames > 0


def test_boids_15k_runs_k1_and_the_boid_tick_once_a_frame_on_card(cuda):
    """BASELINE config 3, 15,000 boids and the mouse, 5 + 20 frames: K1
    once a substep and the boid tick once a frame, no other kernel; every
    boid binned."""
    eng = scenes.boids_engine(cuda, scenes.BOIDS_N, scenes.BOIDS_WORLD, scenes.CONFIG3_SPATIAL)
    zero_launches()
    eng.step(5, block=True)
    eng.step(20)
    eng.sync()
    m = host_ints(eng.metrics)
    assert eng.world.step_count == 25 and finite(eng.world) and m["nonfinite_count"] == 0
    assert_launches(pair_pass_resident=25 * eng.config.physics.sub_step_count,
                                boid_tick=25)
    assert m["n_binned"] in (scenes.BOIDS_N, scenes.BOIDS_N + 1)


def test_boids_cell_scene_runs_the_boid_tick_once_a_frame_on_card(cuda):
    """The boids benchmark cell's scene (``torch_scenes``': 102,400 boids,
    the mouse held at the world's centre), 30 frames: the boid tick once a
    frame."""
    w, h = scenes.CELL_BOIDS_WORLD
    eng = scenes.boids_engine(cuda, scenes.CELL_BOIDS_N, (w, h), scenes.CONFIG3_SPATIAL)
    eng.input.set_mouse(w / 2, h / 2)
    eng.input.mouse_button(0, True)
    zero_launches()
    eng.step(scenes.CELL_BOIDS_FRAMES, block=True)
    assert launches()["boid_tick"] == scenes.CELL_BOIDS_FRAMES


def test_neighbour_solver_on_the_demo_scene_launches_no_kernel_on_card(cuda):
    """The demo scene with ``solver="neighbors"``, 5 + 20 frames: the
    frame runs the neighbour-list solver and launches no kernel; every
    entity binned, finite."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=scenes.N_MAIN, seed=SEED, device=cuda,
                            physics=dict(solver="neighbors"))
    zero_launches()
    eng.step(5, block=True)
    eng.step(20)
    eng.sync()
    m = host_ints(eng.metrics)
    assert finite(eng.world) and m["nonfinite_count"] == 0
    assert eng._plan.solver_geom is None and eng._plan.need_neighbors
    assert_launches()
    assert m["n_binned"] == m["active_count"]


def random_scene_world(dev, seed, n=60):
    """``tests/test_physics_grid.py``'s ``random_scene`` (statics, triggers,
    inactive entities, radii 4-12 in 600 x 400) as a port world on ``dev``,
    made as ``tests/test_physics.py::world_from_golden`` makes it, and its
    config with ``solver``."""
    from multithreadedgameengine_tpu_torch import make_config
    from multithreadedgameengine_tpu_torch.state import make_world

    rng = np.random.default_rng(seed)
    x, y = rng.uniform(20, 580, n), rng.uniform(20, 380, n)
    radius = rng.uniform(4.0, 12.0, n)
    px, py = x - rng.uniform(-2, 2, n), y - rng.uniform(-2, 2, n)
    static = rng.random(n) < 0.15
    trigger = rng.random(n) < 0.1
    active = ~(rng.random(n) < 0.05)

    def t(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    def cfg(solver):
        return make_config(world_width=600.0, world_height=400.0,
                           spatial=dict(max_neighbors=64, method="bruteforce"),
                           physics=dict(gravity=(0.0, 0.4), sub_step_count=3,
                                        boundary_elasticity=0.5,
                                        collision_response_strength=0.7,
                                        verlet_damping=0.99, solver=solver))

    w = make_world(n, dev)
    ones = t(np.ones(n, bool), torch.bool)
    w = w.replace(
        transform=w.transform.replace(active=t(active, torch.bool), x=t(x), y=t(y)),
        rigid_body=w.rigid_body.replace(active=ones, static=t(static, torch.bool), px=t(px),
                                        py=t(py), max_vel=t(np.full(n, 30.0))),
        collider=w.collider.replace(active=ones, radius=t(radius),
                                    is_trigger=t(trigger, torch.bool),
                                    visual_range=t(np.full(n, 1000.0))))
    return w, cfg, float(radius.max())


def test_neighbour_solver_against_grid_on_card(cuda):
    """The reference's neighbours-against-grid bar on the card:
    ``random_scene`` through both solvers for 5 frames, within 2e-3."""
    from multithreadedgameengine_tpu_torch.ops.physics import physics_step
    from multithreadedgameengine_tpu_torch.ops.physics_grid import solver_geometry
    from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

    walls = {}
    for solver in ("neighbors", "grid"):
        w, cfg, r_max = random_scene_world(cuda, 0)
        c = cfg(solver)
        geom = solver_geometry(c, r_max) if solver == "grid" else None
        for _ in range(5):
            nbr = (neighbor_lists(w.transform.x, w.transform.y, w.transform.active,
                                  w.collider.visual_range, c) if geom is None else None)
            w, _ovf = physics_step(w, c, 1.0, geom, nbr)
            w = w.replace(step_count=w.step_count + 1)
        walls[solver] = w
    a, b = walls["neighbors"].transform, walls["grid"].transform
    assert max((a.x - b.x).abs().max().item(), (a.y - b.y).abs().max().item()) <= 2e-3


# ---------------------------------------------------------------------------
# residency, and the slab steps against Engine.step
# ---------------------------------------------------------------------------

def residency_run(dev, residency, how):
    """The 100k balls scene with the ladder's knobs and the mouse held,
    residency ``"on"`` or ``"off"``: 2 x ``rebin_interval`` frames through
    ``Engine.step`` (``how == "step"``), or 3 frames and then a churning
    plan, sparse (256 despawns and spawns on frames 0 and 5 of 12, chunks
    of 6) or dense (every frame of 8, chunks of 4). Returns (the world, the
    pool's stats)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    e = make_balls_engine(n_balls=CHECK_N, seed=SEED, device=dev, world_width=CHECK_WORLD[0],
                          world_height=CHECK_WORLD[1],
                          physics=dict(scenes.LADDER_PHYSICS, position_residency=residency))
    e.input.set_mouse(14_000.0, 6000.0)
    e.input.mouse_button(0, True)
    if how == "step":
        e.step(2 * scenes.LADDER_PHYSICS["rebin_interval"], block=True)
    else:
        frames, op_frames, chunk = {"sparse_plan": (12, (0, 5), 6),
                                    "dense_plan": (8, range(8), 4)}[how]
        world = (CHECK_WORLD[0] - 100.0, CHECK_WORLD[1] - 100.0)
        e.step(3, block=True)
        rng = np.random.default_rng(5)
        plan = e.begin_plan()
        for f in range(frames):
            if f in op_frames:
                plan.despawn_batch(rng.choice(e.active_indices("Ball"), size=scenes.CHURN,
                                              replace=False))
                plan.spawn_batch("Ball", scenes.CHURN,
                                 x=rng.uniform(100, world[0], scenes.CHURN).astype(np.float32),
                                 y=rng.uniform(100, world[1], scenes.CHURN).astype(np.float32))
            plan.next_frame()
        e.run_plan(plan, max_chunk=chunk)
        e.sync()
    assert e._plan.residency == (residency == "on")
    return e.snapshot(), e.get_pool_stats("Ball")


@pytest.mark.parametrize("how", ["step", "sparse_plan", "dense_plan"])
def test_residency_on_and_off_bit_equal_at_100k_on_card(cuda, how):
    """Position residency on and off give the same world bit for bit, with
    the same pools: every entity leaf through sparse and dense churning
    plans; x, y, px, py and the contact counts through ``Engine.step``,
    where residency runs the frames as a lazy chunk, which derives speed
    and ``velocity_angle`` on other frames (``velocity_angle`` keeps its
    value below the rotation threshold, so it follows the path)."""
    (a, pa), (b, pb) = residency_run(cuda, "on", how), residency_run(cuda, "off", how)
    diff = world_diff(a, b, replicated=False)
    if how == "step":
        diff = {k: v for k, v in diff.items() if k in (
            "transform.x", "transform.y", "rigid_body.px", "rigid_body.py",
            "rigid_body.collision_count")}
    assert diff == {}
    assert pa == pb


def check_scene_engines(dev):
    """Two engines of the 100k balls scene, their queued spawns flushed so
    both plans see the spawned radii (the same solver grid)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    engines = [make_balls_engine(n_balls=CHECK_N - 1, seed=SEED, device=dev,
                                 world_width=CHECK_WORLD[0], world_height=CHECK_WORLD[1])
               for _ in range(2)]
    for e in engines:
        e._flush_pending()
    return engines


def slab_run(eng, how, frames, **kw):
    """``frames`` frames of ``eng``'s scene through the halo or the homed
    step (``kw``: its ``oversub`` or ``headroom``) on ``HALO_SLABS`` slabs
    of its device. Returns (the world gathered back, the last metrics, the
    step)."""
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
        unplace_fn,
    )

    mesh = make_mesh(scenes.HALO_SLABS, eng.device)
    ins = eng.input.snapshot(eng.device)
    if how == "halo":
        step, place = make_halo_step(eng, mesh, **kw)
        chunks = place(eng.world)
        for _ in range(frames):
            chunks, m = step(chunks, ins)
        return unplace_fn(chunks, mesh), m, step
    step, place, unplace, _ctl = make_homed_step(eng, mesh, **kw)
    chunks, gids = place(eng.world)
    for _ in range(frames):
        chunks, gids, m = step(chunks, gids, ins)
    return unplace(chunks, gids), m, step


@pytest.mark.parametrize("how", ["halo", "homed"])
def test_slab_step_bit_equal_with_engine_step_at_100k_on_card(cuda, how):
    """100,000 balls on 4 slabs of the card (the halo step at ``oversub``
    4, the homed step at the rung's headroom) against ``Engine.step`` (K1),
    10 frames: every entity leaf bit for bit, the same solver geometry, K3
    once a slab and substep, no route overflow or home violator."""
    eh, es = check_scene_engines(cuda)
    zero_launches()
    w, m, step = slab_run(eh, how, 10, **({"oversub": 4.0} if how == "halo"
                                          else {"headroom": scenes.HOMED_HEADROOM}))
    k3 = launches()
    zero_launches()
    es.step(10, block=True)
    subs = es.config.physics.sub_step_count
    assert_launches(k3, pair_pass_grid=10 * subs * scenes.HALO_SLABS)
    assert_launches(pair_pass_resident=10 * subs)
    assert es._plan.solver_geom == step.plan.solver_geom
    m = host_ints(m)
    assert m["route_overflow_solver"] == 0 and m.get("home_violators", 0) == 0
    assert world_diff(w, es.world, replicated=False) == {}


@pytest.mark.parametrize("how", ["halo", "homed"])
def test_slab_rung_1m_on_card(cuda, how):
    """The halo scaling benchmark's 1M balls scene on 4 slabs of the card:
    the halo step (``oversub`` 4, 3 + 10 frames) or the homed step (headroom
    1.125, 3 frames, one under the sync check, 10 more): K3 once a slab and
    substep and no other kernel, finite, no route overflow, no home
    violator, no entity lost."""
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
    )

    eng = scenes.halo_balls_engine(cuda)
    mesh = make_mesh(scenes.HALO_SLABS, cuda)
    ins = eng.input.snapshot(cuda)
    zero_launches()
    if how == "halo":
        step, place = make_halo_step(eng, mesh, oversub=4.0)
        (chunks,), seen = run_frames(step, (place(eng.world),), ins, 3, 10, guard=False)
        frames = 13
    else:
        step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=scenes.HOMED_HEADROOM)
        (chunks, _gids), seen = run_frames(step, place(eng.world), ins, 3, 10)
        frames = 14
    subs = step.plan.cfg.physics.sub_step_count
    assert_launches(pair_pass_grid=frames * subs * scenes.HALO_SLABS)
    assert all(finite(c) for c in chunks) and chunks[0].step_count == frames
    last = host_ints(seen[-1])
    assert last["nonfinite_count"] == 0
    for m in map(host_ints, seen):
        assert m["route_overflow_solver"] == 0 and m.get("home_violators", 0) == 0
    if how == "homed":
        assert last["active_count"] == scenes.HALO_N


@pytest.mark.parametrize("how", ["halo", "homed"])
def test_halo_boids_scene_bit_equal_with_engine_step_on_card(cuda, how):
    """The halo benchmark's 102,400-boid scene on 4 slabs of the card, phase
    A building each slab's neighbour tables (the halo step at ``oversub``
    1.5, the homed step at headroom 1.125), against ``Engine.step`` pinned
    to K1 for 10 frames: every entity leaf bit for bit (at this width
    "auto" would pick K2, which sums in another order), K3 once a slab and
    substep, no route overflow or home violator, every boid binned."""
    eh, es = (scenes.boids_engine(cuda, scenes.HALO_BOIDS_N - 1, scenes.HALO_BOIDS_WORLD,
                                  scenes.HALO_BOIDS_SPATIAL, solver_predicated="off")
              for _ in range(2))
    for e in (eh, es):
        e._flush_pending()
    zero_launches()
    w, m, step = slab_run(eh, how, 10, **({"oversub": scenes.HALO_BOIDS_OVERSUB} if how == "halo"
                                          else {"headroom": scenes.HOMED_HEADROOM}))
    k3 = launches()
    zero_launches()
    es.step(10, block=True)
    subs = es.config.physics.sub_step_count
    assert_launches(k3, pair_pass_grid=10 * subs * scenes.HALO_SLABS)
    assert_launches(pair_pass_resident=10 * subs)
    m = host_ints(m)
    assert m["route_overflow_solver"] == 0 and m.get("route_overflow_logic", 0) == 0
    assert m.get("home_violators", 0) == 0 and m["n_binned"] == scenes.HALO_BOIDS_N
    assert world_diff(w, es.world, replicated=False) == {}


# ---------------------------------------------------------------------------
# the predators scene, events and the mixed slab passes
# ---------------------------------------------------------------------------

def test_predators_blood_lands_on_card(cuda):
    """BASELINE config 4 at its operating point after 25 frames, one burst
    of the demo's blood and 100 frames: the live particles fall as they
    land, the canvas and its dirty tiles change, K1 once a substep."""
    eng = scenes.predators_engine(cuda)
    eng.step(25, block=True)
    canvas0 = eng.world.decal_canvas.clone()
    scenes.blood_burst(eng)
    zero_launches()
    live = []
    for i in range(100):
        m = eng.step(1)
        if i % 10 == 0 or i == 99:
            live.append(int(m["active_particles"]))
    w = eng.world
    assert live[0] > 0 and live[-1] < live[0]
    assert all(b <= a for a, b in zip(live, live[1:])), live
    assert int((w.decal_canvas != canvas0).any(-1).sum()) > 0 and int(w.decal_dirty.sum()) > 0
    assert_launches(pair_pass_resident=100 * eng.config.physics.sub_step_count,
                                prey_tick=100)


def test_predators_events_chunk_does_not_wait_and_fires_the_blood_hook_on_card(cuda):
    """BASELINE config 4 with events as the JAX ladder's ``rung_predators``
    runs it (chunks of 60, overlapped): 5 frames, one chunk whose frames
    and log writes run under the sync check, then 3 chunks; contacts fire
    the predators' blood hook, its blood reaches the canvas, K1 once a
    substep, no overflow, finite."""
    from multithreadedgameengine_tpu_torch.engine import _EventLog

    eng = scenes.predators_engine(cuda, logic=scenes.EVENTS_LOGIC)
    eng._flush_pending()
    canvas0 = eng.world.decal_canvas.clone()
    totals = {"stay": 0, "blood": 0}
    fire, emit = eng._fire_collision_tables, eng.emitter.emit_batch

    def counted_fire(ctx, enters, stays, exits):
        totals["stay"] += len(stays)
        return fire(ctx, enters, stays, exits)

    def counted_emit(**kw):
        n = emit(**kw)
        totals["blood"] += n
        return n

    eng._fire_collision_tables, eng.emitter.emit_batch = counted_fire, counted_emit
    zero_launches()
    eng.step(5, block=True)
    write = _EventLog.write
    eng._one_step = no_host_reads(eng._one_step)
    _EventLog.write = no_host_reads(write)
    try:
        eng.step(60)
    finally:
        _EventLog.write = write
        del eng._one_step
    eng.sync()
    for _ in range(3):
        eng.step(60)
    eng.sync()
    w, m = eng.world, host_ints(eng.metrics)
    assert w.step_count == 245 and finite(w) and m["nonfinite_count"] == 0
    subs = eng.config.physics.sub_step_count
    assert_launches(pair_pass_resident=245 * subs, prey_tick=245)
    assert m["solver_overflow"] == 0
    assert totals["stay"] > 0 and totals["blood"] > 0, totals
    assert int((w.decal_canvas != canvas0).any(-1).sum()) > 0


def events_scene(dev, chunk, overlap=False):
    """``PRED_REF``'s scene with events on, spawned as
    ``make_predators_engine`` spawns it but with the first predator 5 px
    from the first prey, so contacts exist from the first frame
    (``tests/test_torch_events.py``'s). Records the rows each frame's
    dispatch hands the hooked kinds (Stay: the predators' batch hook) and
    every ``emit_batch``'s positions. Returns (engine, calls, emits)."""
    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    eng = make_predators_engine(device=dev, spawn=False, **PRED_REF, logic=dict(
        collision_events=True, event_chunk=chunk, event_overlap=overlap))
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = scenes.PRED_CAMERA
    w, h = eng.config.world_width, eng.config.world_height
    first = None
    for name, key in (("Prey", "n_prey"), ("Predator", "n_predators"), ("TallLight", "n_lights")):
        for _ in range(PRED_REF[key]):
            x, y = eng.rng() * w, eng.rng() * h
            if name == "Prey" and first is None:
                first = (x, y)
            elif name == "Predator" and first is not None:
                (x, y), first = (first[0] + 5.0, first[1]), None
            eng.spawn(name, x=x, y=y)
    calls, emits = [], []
    fire, emit = eng._fire_collision_tables, eng.emitter.emit_batch
    hooked = eng._hooked3()

    def recorded_fire(ctx, *tables):
        # the rows of the hooked kinds: what the hooks see (a chunk's log
        # leaves the others empty)
        rows = [[tuple(r) for r in t.tolist()] for t, h in zip(tables, hooked) if h]
        if any(rows):
            calls.append(rows)
        return fire(ctx, *tables)

    def recorded_emit(**kw):
        emits.append((list(kw["x"]), list(kw["y"])))
        return emit(**kw)

    eng._fire_collision_tables, eng.emitter.emit_batch = recorded_fire, recorded_emit
    return eng, calls, emits


def event_tables(eng):
    """The frame's pair table and Enter/Stay/Exit tables, cut to their
    counts, as lists."""
    w = eng.world
    return [getattr(w, t)[:int(getattr(w, c).item())].tolist() for t, c in (
        ("collision_pairs", "collision_pair_count"), ("event_enter", "event_enter_count"),
        ("event_stay", "event_stay_count"), ("event_exit", "event_exit_count"))]


def test_event_scene_on_card_matches_cpu(cuda):
    """The 400-prey event scene on the card against the CPU, 6 frames: every
    frame's event tables and hook calls identical, the blood hook fired,
    its emissions, the live particles, the positions and the particles
    within 8 ulps at the world's extent, canvas bytes within 1."""
    runs = {}
    for d in (cuda, "cpu"):
        eng, calls, emits = events_scene(d, 1)
        tables = []
        for _ in range(PRED_REF_FRAMES):
            eng.step(1)
            tables.append(event_tables(eng))
        runs[str(d)] = (tables, calls, emits, eng.snapshot())
    (ta, ca, ea, a), (tb, cb, eb, b) = runs[str(cuda)], runs["cpu"]
    tol = ulps(REF_ULPS, 1600.0)
    assert ta == tb and ca == cb
    assert sum(len(t[2]) for t in tb) > 0 and len(eb) > 0
    assert len(ea) == len(eb)
    assert max([abs(u - v) for (xa, ya), (xb, yb) in zip(ea, eb)
                for u, v in zip(xa + ya, xb + yb)] or [0.0]) <= tol
    assert torch.equal(a.particles.active, b.particles.active)
    assert max((a.transform.x - b.transform.x).abs().max().item(),
               (a.transform.y - b.transform.y).abs().max().item()) <= tol
    assert max((getattr(a.particles, f) - getattr(b.particles, f)).abs().max().item()
               for f in ("x", "y", "z")) <= tol
    assert (a.decal_canvas.int() - b.decal_canvas.int()).abs().max().item() <= 1


@pytest.mark.parametrize("mode,frames", [("chunk4", 12), ("chunk4_overlap", 12), ("plan", 8)])
def test_event_scene_chunked_and_planned_match_frame_by_frame_on_card(cuda, mode, frames):
    """The 400-prey event scene on the card in chunks of 4, in chunks of 4
    with overlap (12 frames) and through a plan of 8 frames in chunks of 4
    whose every frame runs under the sync check, against ``step(1)`` per
    frame: the same hook calls and emissions; the plan also the same event
    tables and entities."""
    eng, calls, emits = events_scene(cuda, 4, overlap=mode == "chunk4_overlap")
    if mode == "plan":
        plan = eng.begin_plan()
        for _ in range(frames):
            plan.next_frame()
        with guarded_plan_frames(eng) as guard:
            eng.run_plan(plan, max_chunk=4)
        assert guard["frames"] == frames
    else:
        eng.step(frames)
    eng.sync()
    base, base_calls, base_emits = events_scene(cuda, 1)
    for _ in range(frames):
        base.step(1)
    assert calls == base_calls and emits == base_emits and base_calls
    if mode == "plan":
        assert event_tables(eng) == event_tables(base)
        assert world_diff(eng.snapshot(), base.snapshot(), replicated=False) == {}


def test_mixed_scene_halo_and_homed_steps_on_card(cuda):
    """The halo benchmark's 25,600-entity mixed scene (events, particles,
    decals, shadows) on 4 slabs of the card: the halo step (``oversub``
    2.5) and the homed step (headroom 2), each 3 frames, one under the sync
    check and 20 more. The halo run has pairs, particles and shadows, every
    entity binned, K3 once a slab and substep and no other kernel, no route
    overflow; the homed run equals it (entities, event tables, pool,
    canvas, shadows), with no home violator."""
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
        unplace_fn,
    )

    worlds = {}
    for how in ("halo", "homed"):
        eng = scenes.halo_predators_engine(cuda)
        mesh = make_mesh(scenes.HALO_SLABS, cuda)
        ins = eng.input.snapshot(cuda)
        zero_launches()
        if how == "halo":
            step, place = make_halo_step(eng, mesh, oversub=scenes.HALO_PRED_OVERSUB)
            (chunks,), seen = run_frames(step, (place(eng.world),), ins, 3, 20)
            w = unplace_fn(chunks, mesh)
        else:
            step, place, unplace, _ctl = make_homed_step(eng, mesh, headroom=2.0)
            (chunks, gids), seen = run_frames(step, place(eng.world), ins, 3, 20)
            w = unplace(chunks, gids)
        subs = step.plan.cfg.physics.sub_step_count
        assert_launches(pair_pass_grid=24 * scenes.HALO_SLABS * subs)
        assert finite(w) and w.step_count == 24
        for m in map(host_ints, seen):
            assert m["route_overflow_solver"] == 0 and m.get("route_overflow_logic", 0) == 0
            assert m.get("home_violators", 0) == 0 and m["nonfinite_count"] == 0
        last = host_ints(seen[-1])
        if how == "halo":
            assert last["collision_pair_count"] > 0 and last["active_particles"] > 0
            assert int(w.shadow_sprites.active.sum()) > 0
            assert last["n_binned"] == w.n_entities
        worlds[how] = w
    assert world_diff(worlds["homed"], worlds["halo"]) == {}
    assert shadows_equal(worlds["homed"], worlds["halo"])


def test_event_scene_through_halo_step_matches_engine_step_on_card(cuda):
    """The 400-prey event scene through the halo step on 3 slabs of the
    card and through ``Engine.step``, each frame's hooks fired by the
    engine (as ``Engine.step(1)`` fires them around a frame): every frame's
    Enter/Stay/Exit tables, the hook calls, the emissions, and at the end
    the world, pool and canvas included, identical."""
    from multithreadedgameengine_tpu_torch.emitter import batch_to_device
    from multithreadedgameengine_tpu_torch.ops.particles import apply_emission
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn

    es, calls_s, emits_s = events_scene(cuda, 1)
    eh, calls_h, emits_h = events_scene(cuda, 1)
    for e in (es, eh):
        e._flush_pending()
    mesh = make_mesh(3, cuda)
    step, place = make_halo_step(eh, mesh, oversub=3.0)
    chunks, ins = place(eh.world), eh.input.snapshot(cuda)
    tables_s, tables_h = [], []
    for _ in range(PRED_REF_FRAMES):
        es.step(1)
        tables_s.append(event_tables(es)[1:])
        # one halo frame with the engine's dispatch around it: the emitter's
        # queue lands in the shared pool, the frame runs, the hooks fire
        batch, n = eh.emitter.build_batch()
        if batch is not None:
            pool, _n = apply_emission(chunks[0].particles, batch_to_device(batch, cuda), n)
            chunks = [c.replace(particles=pool) for c in chunks]
        chunks, _m = step(chunks, ins)
        eh.world = unplace_fn(chunks, mesh)
        eh._dispatch_collision_events()
        tables_h.append(event_tables(eh)[1:])
    assert tables_s == tables_h and calls_s == calls_h and emits_s == emits_h
    assert sum(len(t[1]) for t in tables_s) > 0 and emits_s
    assert world_diff(unplace_fn(chunks, mesh), es.world) == {}


def static_shadow_engine(dev):
    """``tests/test_halo_mixed.py``'s static shadow scene: 59 casters and 4
    lamps in 2000 x 1600 (a moving caster's shadow would lag a frame under
    the slab steps, by design)."""
    from multithreadedgameengine_tpu_torch import Engine, EntityClass, make_config
    from multithreadedgameengine_tpu_torch.components import (
        Collider,
        LightEmitter,
        RigidBody,
        ShadowCaster,
        SpriteRenderer,
    )

    class Caster(EntityClass):
        components = [RigidBody, Collider, SpriteRenderer, ShadowCaster]
        uses_neighbors = False

        @classmethod
        def setup(cls, ctx):
            return {"collider.radius": 8.0, "collider.visual_range": 40.0,
                    "rigid_body.static": True, "shadow.shadow_radius": 9.0,
                    "shadow.height": 30.0}

    class Lamp(EntityClass):
        components = [RigidBody, Collider, SpriteRenderer, LightEmitter]
        uses_neighbors = False

        @classmethod
        def setup(cls, ctx):
            return {"collider.radius": 4.0, "collider.visual_range": 190.0,
                    "rigid_body.static": True, "light.light_intensity": 500.0,
                    "light.light_color": 0xFFEECC, "light.height": 50.0}

    eng = Engine(make_config(
        world_width=2000.0, world_height=1600.0, seed=21, canvas_width=2000, canvas_height=1600,
        spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
        physics=dict(sub_step_count=1, gravity=(0.0, 0.0)),
        lighting=dict(enabled=True, shadows_enabled=True, max_shadow_casting_lights=4,
                      max_shadows_per_light=6)), device=dev)
    eng.register_entity_class(Caster, 59)
    eng.register_entity_class(Lamp, 4)
    eng.init()
    rng = np.random.default_rng(17)
    for _ in range(59):
        eng.spawn("Caster", x=float(rng.uniform(800, 1200)), y=float(rng.uniform(600, 1000)))
    for k in range(4):
        eng.spawn("Lamp", x=900.0 + 100.0 * k, y=700.0 + 50.0 * k)
    eng._flush_pending()
    eng.input.set_camera(1000.0, 800.0, 1.0)
    return eng


@pytest.mark.parametrize("how", ["halo", "homed"])
def test_static_shadows_on_slab_steps_match_engine_step_on_card(cuda, how):
    """The static shadow scene, 3 frames, through a slab step on 4 slabs of
    the card (the halo step at ``oversub`` 4, the homed step at headroom 4)
    and through ``Engine.step``:
    the same shadow sprites, some cast."""
    single = static_shadow_engine(cuda)
    single.step(3)
    w, _m, _step = slab_run(static_shadow_engine(cuda), how, 3,
                            **({} if how == "halo" else {"headroom": float(scenes.HALO_SLABS)}))
    assert int(single.world.shadow_sprites.active.sum()) > 0
    assert shadows_equal(w, single.snapshot())


# ---------------------------------------------------------------------------
# frame plans
# ---------------------------------------------------------------------------

def test_churn_plan_at_10k_does_not_wait_for_the_card(cuda):
    """BASELINE config 2 as ``rung_churn`` runs it: the demo scene, 5
    frames, then plans whose every frame despawns 256 active balls and
    spawns 256, in chunks of 30: the first plan's 30 frames and their op
    tables' uploads under the sync check, a second plan of 30, then three
    of 60 with K1 once a substep and no other kernel; the population held,
    no overflow, finite."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=scenes.N_MAIN, seed=SEED, device=cuda)
    eng.step(5, block=True)
    rng = np.random.default_rng(7)
    with guarded_plan_frames(eng) as guard:
        scenes.churn_frames(eng, rng, 30, scenes.CHURN, scenes.CHURN_CHUNK)
    assert guard["frames"] == 30
    scenes.churn_frames(eng, rng, 30, scenes.CHURN, scenes.CHURN_CHUNK)
    eng.sync()
    zero_launches()
    for _ in range(3):
        scenes.churn_frames(eng, rng, 60, scenes.CHURN, scenes.CHURN_CHUNK)
    eng.sync()
    assert_launches(pair_pass_resident=180 * eng.config.physics.sub_step_count)
    assert int(eng.metrics["solver_overflow"]) == 0 and finite(eng.world)
    assert eng.get_pool_stats("Ball")["active"] == scenes.N_MAIN
    assert int(eng.world.transform.active.sum()) == scenes.N_MAIN + 1


# ---------------------------------------------------------------------------
# the render server and screenshots
# ---------------------------------------------------------------------------

FRAME_HEADER = struct.Struct("<IIIIIIII")


def parse_frame(buf: bytes):
    """A frame's header fields, after checking the magic, the length the
    header implies and that the entity lanes are finite with their index
    lane an entity id."""
    from multithreadedgameengine_tpu_torch.server.render_server import ENT_LANES, MAGIC

    magic, step, n_e, n_p, n_s, n_l, mask, n_dbg = FRAME_HEADER.unpack_from(buf, 0)
    size = 32 + 4 * (n_e * (ENT_LANES + 1) + 4 * n_dbg + 5 * n_p + 7 * n_s + 5 * n_l)
    assert magic == MAGIC and len(buf) == size, (len(buf), size)
    ent = np.frombuffer(buf, "<f4", n_e * ENT_LANES, 32).reshape(n_e, ENT_LANES)
    assert bool(np.isfinite(ent).all()) and bool((ent[:, 12] >= 0).all())
    return dict(step=step, n_e=n_e, n_p=n_p, n_s=n_s, n_l=n_l, mask=mask, n_dbg=n_dbg)


class FrameClient(threading.Thread):
    """A browser's stand-in: POSTs its camera to /input once (when given),
    then GETs /frame over localhost every 10 ms until stopped, parsing each
    new frame. Only reads bytes the server published."""

    def __init__(self, port: int, camera=None):
        super().__init__(daemon=True)
        self.base = f"http://localhost:{port}"
        self.camera = camera
        self.posted = threading.Event()
        self.stop = threading.Event()
        self.frames, self.error = [], None

    def run(self):
        last = b""
        try:
            if self.camera is not None:
                req = urllib.request.Request(
                    self.base + "/input", data=json.dumps({"camera": self.camera}).encode(),
                    method="POST")
                urllib.request.urlopen(req, timeout=30).close()
            self.posted.set()
            while not self.stop.is_set():
                with urllib.request.urlopen(self.base + "/frame", timeout=30) as r:
                    body = r.read()
                if body and body != last:
                    self.frames.append(parse_frame(body))
                    last = body
                self.stop.wait(0.01)
        except Exception as e:  # reported by the test, which fails on it
            self.error = repr(e)
            self.posted.set()


def http_get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=30) as r:
        return r.read()


@contextlib.contextmanager
def world_on_host(eng):
    """The engine holding a CPU copy of its world for the duration."""
    card = eng.world
    eng.world = eng.snapshot()
    try:
        yield
    finally:
        eng.world = card


@pytest.mark.parametrize("scene", ["balls_10k", "predators_15k"])
def test_render_server_serves_a_client_on_card(cuda, scene):
    """The render server in front of the demo scene (the client's camera
    posted to /input) or BASELINE config 4 with the demo atlas and a blood
    burst, as ``run_scene`` drives it: 80 steps, a publish every 2 (the
    decal PNG every 60), a client thread reading every frame over
    localhost. K1 once a substep and no other kernel; the client read
    frames in order; each published header matches the packet of the same
    world and /stats is the last publish's; for the predators the atlas
    endpoints, the decal PNG and non-empty particle, shadow and light
    sections. Then the packet and the frame of the card's world equal its
    CPU copy's, the packet Y-sorted."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.render.atlas import decode_png
    from multithreadedgameengine_tpu_torch.server.render_server import (
        RenderServer,
        build_demo_atlas,
        encode_frame,
    )

    if scene == "balls_10k":
        eng, atlas = make_balls_engine(n_balls=scenes.N_MAIN, seed=SEED, device=cuda), None
    else:
        eng = scenes.predators_engine(cuda)
        atlas = build_demo_atlas(eng)
        scenes.blood_burst(eng)
    eng.step(4, block=True)
    srv = RenderServer(eng, port=0, atlas=atlas).start()
    client = FrameClient(srv.port, list(scenes.BALLS_CAMERA) if atlas is None else None)
    try:
        client.start()
        client.posted.wait(timeout=60)
        srv.apply_inputs()  # the client's camera, before the published steps
        zero_launches()
        for k in range(40):
            srv.apply_inputs()
            eng.step(2)
            srv.publish(include_decals=(2 * (k + 1)) % 60 == 0)
        eng.sync()
        counted = launches()
        time.sleep(0.05)
        client.stop.set()
        client.join(timeout=60)
        assert not client.is_alive() and client.error is None, client.error
        if atlas is not None:
            scenes.blood_burst(eng)  # the first has landed: the frame shows the live ones
        for _ in range(3):
            eng.step(2)
            srv.publish()
            head = parse_frame(http_get(srv.port, "/frame"))
            pkt = eng.render_packet(20000)
            assert head["n_e"] == int(pkt.count) and head["step"] == eng.world.step_count
        assert json.loads(http_get(srv.port, "/stats"))["total_steps"] == eng.timer.total_steps
        if atlas is not None:
            img = decode_png(http_get(srv.port, "/atlas"))
            payload = json.loads(http_get(srv.port, "/atlas.json"))
            decals = decode_png(http_get(srv.port, "/decals"))
            assert img.shape[2] == 4 and len(payload["sheets"]) > 0 and payload["textures"]
            assert decals.shape[:2] == tuple(eng.world.decal_canvas.shape[:2])
            assert int((decals[..., 3] > 0).sum()) > 0
            assert head["n_p"] > 0 and head["n_s"] > 0 and head["n_l"] > 0
    finally:
        client.stop.set()
        srv.stop()
    subs = eng.config.physics.sub_step_count
    kw = {} if scene == "balls_10k" else {"prey_tick": 80}
    assert_launches(counted, pair_pass_resident=80 * subs, **kw)
    steps = [f["step"] for f in client.frames]
    assert steps and steps == sorted(steps)
    assert finite(eng.world)
    pkt, frame = eng.render_packet(), encode_frame(eng)
    with world_on_host(eng):
        host_pkt, host_frame = eng.render_packet(), encode_frame(eng)
    for f in pkt.__dataclass_fields__:
        assert torch.equal(getattr(pkt, f), getattr(host_pkt, f)), f
    assert frame == host_frame and int(pkt.count) > 0
    assert bool(np.all(np.diff(pkt.y[:int(pkt.count)].numpy()) >= 0))


def test_screenshot_on_card_matches_cpu(cuda, tmp_path):
    """``Engine.screenshot`` of BASELINE config 4 with the demo atlas and a
    blood burst, 30 frames on (decals, shadows, atlas sprites, particles,
    lights and glows), against its world's CPU copy: the same PNG bytes,
    something drawn."""
    from multithreadedgameengine_tpu_torch.render.headless import encode_png
    from multithreadedgameengine_tpu_torch.server.render_server import build_demo_atlas

    eng = scenes.predators_engine(cuda)
    build_demo_atlas(eng)
    scenes.blood_burst(eng)
    eng.step(30)
    path = tmp_path / "shot.png"
    img = eng.screenshot(str(path), 480, 270)
    with world_on_host(eng):
        host = eng.screenshot(None, 480, 270)
    assert encode_png(host) == path.read_bytes()
    assert int((img.std(axis=2) > 5).sum()) > 100


# ---------------------------------------------------------------------------
# the process mesh on the card
# ---------------------------------------------------------------------------

DIST_RANKS, DIST_DEADLINE_S = 4, 600.0
BOIDS_CELL = dict(scene=scenes.boids_engine, args=(scenes.HALO_BOIDS_N - 1,
                                                   scenes.HALO_BOIDS_WORLD,
                                                   scenes.HALO_BOIDS_SPATIAL),
                  kwargs=dict(solver_predicated="off"))


def dist_cells(names):
    """The slab cells (``dryrun.halo_cell``/``homed_cell`` keyword
    arguments, by name) the process mesh is held to the in-process mesh on:
    the halo benchmark's boids scene, the 1M balls scene and the mixed
    scene through both slab steps; each cell's frames as their in-process
    runs take them."""
    from multithreadedgameengine_tpu_torch import dryrun

    cells = {
        "dist_halo_boids_102k_d4": (dryrun.halo_cell, dict(
            frames=10, warmup=2, oversub=scenes.HALO_BOIDS_OVERSUB, **BOIDS_CELL)),
        "dist_homed_boids_102k_d4": (dryrun.homed_cell, dict(
            frames=10, warmup=2, headroom=scenes.HOMED_HEADROOM, **BOIDS_CELL)),
        "dist_halo_1m_d4": (dryrun.halo_cell, dict(
            scene=scenes.halo_balls_engine, frames=13, warmup=2, oversub=4.0)),
        "dist_homed_1m_d4": (dryrun.homed_cell, dict(
            scene=scenes.halo_balls_engine, frames=14, warmup=3,
            headroom=scenes.HOMED_HEADROOM)),
        "dist_halo_mixed": (dryrun.halo_cell, dict(
            scene=scenes.halo_predators_engine, frames=24, warmup=3,
            oversub=scenes.HALO_PRED_OVERSUB)),
        "dist_homed_mixed": (dryrun.homed_cell, dict(
            scene=scenes.halo_predators_engine, frames=24, warmup=3, headroom=2.0)),
    }
    return [(cells[n][0], dict(name=n, **cells[n][1])) for n in names]


def in_process_digests(dev, fn, cell, n_slabs):
    """The chunk digests each rank must report for ``cell``: the same scene
    and frames through the same step on the in-process mesh of ``n_slabs``
    slabs."""
    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.dryrun import leaf_digests, tensor_digest
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
    )

    eng = cell["scene"](dev, *cell.get("args", ()), **cell.get("kwargs", {}))
    eng._flush_pending()
    mesh, ins = make_mesh(n_slabs, dev), eng.input.snapshot(dev)
    if fn is dryrun.homed_cell:
        step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=cell["headroom"])
        chunks, gids = place(eng.world)
        for _ in range(cell["frames"]):
            chunks, gids, _m = step(chunks, gids, ins)
        return [dict(leaf_digests(c), gids=tensor_digest(g)) for c, g in zip(chunks, gids)]
    step, place = make_halo_step(eng, mesh, oversub=cell["oversub"])
    chunks = place(eng.world)
    for _ in range(cell["frames"]):
        chunks, _m = step(chunks, ins)
    return [leaf_digests(c) for c in chunks]


def assert_cell(reps, expect_digests, kernel="K3"):
    """A process-mesh cell's reports: every rank's chunk digests equal to
    the in-process run's, every rank's replicated leaves alike, one frame a
    rank under the sync check, ``kernel`` once a frame and substep on
    every rank and no other pair pass, no overflow, home violator or
    non-finite position."""
    got = [r["digests"][0] for r in reps]
    assert got == expect_digests, reps[0]["cell"]
    assert all(r.get("replicated") == reps[0].get("replicated") for r in reps)
    assert all(r["host_reads_checked"] for r in reps)
    frames, subs, n = reps[0]["frames"], reps[0]["substeps"], reps[0]["ranks"]
    launches = reps[0]["launches_by_rank"]
    for key in ("K1", "K2", "K3"):
        per_rank = frames * subs if key == kernel else 0
        assert launches[key] == [per_rank] * n, (key, launches[key])
    m = reps[0]["metrics"]
    for key in ("route_overflow_logic", "route_overflow_solver", "home_violators",
                "nonfinite_count"):
        assert m.get(key, 0) == 0, (key, m)


def sharded_digests(dev, n_ranks, frames):
    """balls_10k's entity-sharded scene through ``Engine.step`` for
    ``frames`` frames, cut into each rank's rows as ``shard_world`` cuts
    them: the digests each rank must report."""
    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.parallel import ProcessMesh, shard_world

    eng = dryrun.balls_scene(dev, scenes.N_MAIN)
    for _ in range(frames):
        eng.step(1)
    # a rank's view of the mesh, for shard_world's cut (no group is joined)
    return [dryrun.leaf_digests(shard_world(eng.world, ProcessMesh(r, n_ranks, dev, "gloo")))
            for r in range(n_ranks)]


def test_dryrun_and_dist_cells_on_card(cuda):
    """Four gloo ranks sharing the card (every message staged through
    pinned host memory), started once: every rung of the reference's dry
    run with its asserts, the collectives against ``SlabMesh`` bit for bit,
    the rungs' replicated leaves alike on every rank; then the boids and
    mixed scenes through both slab steps and balls_10k through the sharded
    step, each rank's chunk equal to the in-process run's."""
    from multithreadedgameengine_tpu_torch import dryrun

    names = ["dist_halo_boids_102k_d4", "dist_homed_boids_102k_d4", "dist_halo_mixed",
             "dist_homed_mixed"]
    cells = dist_cells(names)
    sharded = (dryrun.sharded_cell, dict(name="dist_sharded_balls_10k", scene=dryrun.balls_scene,
                                         args=(scenes.N_MAIN,), frames=22, warmup=2))
    reports = dryrun.dryrun_multichip(DIST_RANKS, "gloo", "cuda", extra=[*cells, sharded],
                                      deadline_s=DIST_DEADLINE_S)
    by_name = {reps[0]["cell"]: reps for reps in reports}
    col = by_name.pop("0_collectives")
    assert all(all(r["equal"].values()) and r["bytes_staged"] > 0 for r in col)
    for name in ("1_halo_boids", "1b_halo_mixed", "1c_halo_chunked", "1d_homed_boids",
                 "1e_homed_mixed", "2_sharded_balls"):
        reps = by_name.pop(name)
        assert all(r.get("replicated") == reps[0].get("replicated") for r in reps), name
    for fn, cell in cells:
        assert_cell(by_name.pop(cell["name"]),
                    in_process_digests(cuda, fn, cell, DIST_RANKS))
    assert_cell(by_name.pop("dist_sharded_balls_10k"), sharded_digests(cuda, DIST_RANKS, 22),
                kernel="K1")
    assert not by_name, sorted(by_name)


def test_dist_1m_cells_on_card(cuda):
    """The 1M balls scene through both slab steps on four gloo ranks
    sharing the card, each rank's chunk equal to the in-process run's."""
    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.parallel import run_ranks

    cells = dist_cells(["dist_halo_1m_d4", "dist_homed_1m_d4"])
    per_rank = run_ranks(dryrun.run_session, DIST_RANKS, "gloo", "cuda", args=(cells,),
                         deadline_s=DIST_DEADLINE_S,
                         threads=max(1, (os.cpu_count() or 1) // DIST_RANKS))
    for (fn, cell), reps in zip(cells, zip(*per_rank)):
        assert reps[0]["cell"] == cell["name"]
        assert_cell(list(reps), in_process_digests(cuda, fn, cell, DIST_RANKS))


def test_nccl_halo_boids_on_card(cuda):
    """The halo boids cell on NCCL at one rank a card (D = the card count),
    against ``SlabMesh`` at the same D, 6 frames."""
    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.parallel import run_ranks

    count = torch.cuda.device_count()
    cell = dict(name="nccl_halo_boids_102k", frames=6, warmup=1,
                oversub=scenes.HALO_BOIDS_OVERSUB, **BOIDS_CELL)
    per_rank = run_ranks(dryrun.run_session, count, "nccl", "cuda",
                         args=([(dryrun.halo_cell, cell)],), deadline_s=DIST_DEADLINE_S,
                         threads=max(1, 8 // count))
    assert_cell([r[0] for r in per_rank], in_process_digests(cuda, dryrun.halo_cell, cell, count))
