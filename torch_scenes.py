"""The port's scenes on one card and the kernel table's cases, shared by the
card tests and the root scripts.

The scenes without a benchmark cell are built here once (``boids_engine``,
``predators_engine``, ``halo_balls_engine``, ``halo_predators_engine``,
``churn_frames``, ...): ``torch_profile.py`` times them and
``tests/test_torch_cuda_scenes.py`` checks them. The kernel table
(:data:`CASES`) is every CUDA kernel on the inputs ``PERF.md`` §6 reports,
each taken from a frame of a scene run through its main path, with the
launches that run must make: ``chip_smoke.py`` times it, ``kernel_ab.py``
times other versions of the kernels on it and
``tests/test_torch_cuda.py::test_kernel_table_case_on_card`` checks it
(:func:`compare`). The ticks' summing-order tolerances live here too, for
the table and the tick test files.

Importing this module touches no card and imports no test file, no script
and nothing of JAX. The scripts and the tests import it from the repo's
root, the directory they are run from.
"""

from __future__ import annotations

import subprocess
import time
from types import SimpleNamespace as NS
from typing import Callable, NamedTuple, Optional

SEED = 123456
N_MAIN = 10_000
# the JAX ladder's physics from 100k balls up (benchmarks/run_ladder.py:84-93)
LADDER_PHYSICS = dict(
    sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
    boundary_elasticity=0.0, collision_response_strength=0.8,
    gravity=(0.0, 0.5), solver_capacity=12, rebin_interval=8,
)
# the halo rung (benchmarks/halo_scaling.py:104-110 at its default n) and the
# homed rung's headroom (halo_scaling.py:150-186)
HALO_N, HALO_WORLD, HALO_SLABS, HOMED_HEADROOM = 1_000_000, (90_000.0, 40_000.0), 4, 1.125
# BASELINE config 3, the JAX ladder's boids rung
BOIDS_N, BOIDS_WORLD = 15_000, (5000.0, 2000.0)
CONFIG3_SPATIAL = dict(cell_size=50.0, max_neighbors=400, cell_capacity=32)
# the halo benchmark's boids scene at its default size, and its oversub
HALO_BOIDS_N, HALO_BOIDS_WORLD = 102_400, (12_000.0, 6_000.0)
HALO_BOIDS_SPATIAL = dict(cell_size=100.0, max_neighbors=48, cell_capacity=32)
HALO_BOIDS_OVERSUB = 1.5
# BASELINE config 4 at the demo's operating point, the camera zoomed out over
# the whole world (camera x, y and zoom), and with events as the JAX ladder's
# predators rung runs it (run_ladder.py:208-240)
PRED_CAMERA = (0.0, 0.0, 0.3)
EVENTS_LOGIC = dict(collision_events=True, event_chunk=60, event_overlap=True)
# the halo benchmark's mixed scene (halo_scaling.py:61-75) at the size and
# route oversub of HALO_SCALING_PREDATORS_r03.json
HALO_PRED_N, HALO_PRED_OVERSUB = 25_600, 2.5
# BASELINE config 2, the JAX ladder's churn rung (run_ladder.py:110-160):
# despawns and spawns a frame, and the plan's chunk
CHURN, CHURN_CHUNK = 256, 30
# the balls scene's camera behind the render server: the whole 9000 x 4000
# world on its 1600 x 600 canvas, where the default camera (the world's
# centre, zoom 1) sees none of the pile once the balls have fallen
BALLS_CAMERA = (0.0, 0.0, 0.15)
#: the boids benchmark cell's boids and world (``bench_port/configs/
#: boids_102k.json``), and the frames before the boid tick's frame is captured
CELL_BOIDS_N, CELL_BOIDS_WORLD, CELL_BOIDS_FRAMES = 102_400, (13_064.0, 5_226.0), 30
#: K4 at the probe's shapes: 1M entities, chunks of 128 x 1024 slots over
#: the 1M ladder layout rounded up to whole chunks (66)
K4_N, K4_CHUNK = 1_000_000, 128 * 1024
K4_TOTAL = (12 * 556 * 1280 // K4_CHUNK + 1) * K4_CHUNK
#: frames of a scene before its layout or slab grid is taken: the main
#: paths' warm-up and timed frames (the halo rung 3 + 10, the homed rung one
#: more under the sync check); the predators scene's 5 + 20 frames, a blood
#: burst and 100 frames more
SCENE_FRAMES, HALO_FRAMES, HOMED_FRAMES = 25, 13, 14
PRED_WARMUP, PRED_FRAMES, PRED_BLOOD_FRAMES = 5, 20, 100
#: the predators' entity type in the tick tests' scenes (the boids' are 1
#: and 2, the mouse 0)
PRED = 3
#: frames of the mixed cell's scene before the neighbour build's frame is
#: captured
MIXED_BUILD_FRAMES = 5
PAIR_PASSES = ("pair_pass_resident", "pair_pass_symmetric", "pair_pass_grid")
#: every kernel's wrapper in ``ops.cuda_kernels``
KERNELS = (*PAIR_PASSES, "expand", "boid_tick", "prey_tick", "neighbor_build")


def card_name_and_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernels():
    """The port's kernel module (wrappers, plain versions, launch counts)."""
    from multithreadedgameengine_tpu_torch.ops import cuda_kernels as ck

    return ck


def zero_launches() -> None:
    ck = kernels()
    for name in KERNELS:
        getattr(ck, name).launches = 0


def launches() -> dict:
    """Each kernel's launches since :func:`zero_launches`, by wrapper name."""
    ck = kernels()
    return {name: getattr(ck, name).launches for name in KERNELS}


# ---------------------------------------------------------------------------
# the scenes
# ---------------------------------------------------------------------------

def halo_balls_engine(dev):
    """The halo scaling benchmark's balls scene (``benchmarks/
    halo_scaling.py:104-110``): ``HALO_N - 1`` balls and the mouse in
    ``HALO_WORLD``, seed 123456, queued spawns flushed."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=HALO_N - 1, seed=SEED, device=dev,
                            world_width=HALO_WORLD[0], world_height=HALO_WORLD[1])
    eng._flush_pending()
    return eng


def boids_engine(dev, n, world, spatial, **physics):
    """The boids scenes as the JAX benchmarks build them inline
    (``run_ladder.py:166-188``, ``halo_scaling.py:77-102``): ``n`` boids and
    the mouse, one substep (and any other ``physics`` knobs), spawned from
    numpy's stream at ``SEED`` with x and y in ``[50, extent - 50]`` and vx,
    vy in ``[-3, 3]``."""
    import numpy as np

    from multithreadedgameengine_tpu_torch import Engine, make_config
    from multithreadedgameengine_tpu_torch.models.boids import Boid

    eng = Engine(make_config(world_width=world[0], world_height=world[1], seed=SEED,
                             spatial=spatial, physics=dict(sub_step_count=1, **physics)),
                 device=dev)
    eng.register_entity_class(Boid, n)
    eng.init()
    rng = np.random.default_rng(SEED)
    eng.spawn_batch(
        "Boid", n,
        x=rng.uniform(50, world[0] - 50, n).astype(np.float32),
        y=rng.uniform(50, world[1] - 50, n).astype(np.float32),
        vx=rng.uniform(-3, 3, n).astype(np.float32),
        vy=rng.uniform(-3, 3, n).astype(np.float32),
        call_on_spawned=False,
    )
    return eng


def predators_engine(dev, **kw):
    """``make_predators_engine`` on ``dev`` with the camera zoomed out so
    every light and caster is on screen."""
    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    eng = make_predators_engine(device=dev, **kw)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = PRED_CAMERA
    return eng


def blood_burst(eng, k=16):
    """One ``emit_batch`` of the demo's blood at the first ``k`` prey, as
    ``Predator.on_collision_stay_batch`` emits it. Returns the count."""
    from multithreadedgameengine_tpu_torch.models.predators import BLOOD

    s = eng.classes["Prey"].start_index
    t = eng.world.transform
    return eng.emitter.emit_batch(x=t.x[s:s + k].cpu().numpy(), y=t.y[s:s + k].cpu().numpy(),
                                  **BLOOD)


def landing_burst(eng):
    """A burst that lands on its first frame on overlapping patches, so the
    decal stamping runs (``tests/test_torch_predators.py``'s)."""
    return eng.emitter.emit_batch(
        x=[300.0, 310.0, 900.0], y=[300.0, 305.0, 500.0], count={"min": 6, "max": 12},
        z=-1.0, vz=5.0, angle_xy={"min": 0.0, "max": 360.0}, speed={"min": 0.5, "max": 3.0},
        lifespan=9000.0, gravity=0.0, texture="blood", scale={"min": 0.5, "max": 2.0},
        alpha={"min": 0.4, "max": 0.9}, tint={"min": 0xAA0000, "max": 0xFF4444},
        stay_on_the_floor=True)


def halo_predators_engine(dev):
    """The halo benchmark's mixed scene (``benchmarks/halo_scaling.py:
    61-75``): BASELINE config 4 scaled to ``HALO_PRED_N`` entity slots (the
    mouse, 24 predators, 7 lights, the rest prey) in 7000 s x 3500 s, s =
    (N / 15,028)^0.5, with collision events, at ``predators_engine``'s
    camera; one blood burst and one landing burst queued into the pool so
    the particle and decal passes have work."""
    s = (HALO_PRED_N / 15_028) ** 0.5
    eng = predators_engine(dev, n_prey=HALO_PRED_N - 32, n_predators=24, n_lights=7,
                           world_width=7000.0 * s, world_height=3500.0 * s,
                           logic=dict(collision_events=True))
    eng._flush_pending()
    blood_burst(eng)
    landing_burst(eng)
    eng._flush_emissions()
    return eng


def churn_frames(eng, rng, count, churn, chunk, world=(8900.0, 1000.0)):
    """``rung_churn``'s ``run_frames``: a plan of ``count`` frames, each
    despawning ``churn`` active balls and spawning as many at x in
    [100, world[0]], y in [100, world[1]], run in chunks of ``chunk``.
    Returns (seconds building the plan, seconds in ``run_plan``)."""
    import numpy as np

    t0 = time.perf_counter()
    plan = eng.begin_plan()
    for _ in range(count):
        active = eng.active_indices("Ball")
        plan.despawn_batch(rng.choice(active, size=min(churn, active.size), replace=False))
        plan.spawn_batch("Ball", churn,
                         x=rng.uniform(100, world[0], churn).astype(np.float32),
                         y=rng.uniform(100, world[1], churn).astype(np.float32))
        plan.next_frame()
    t1 = time.perf_counter()
    eng.run_plan(plan, max_chunk=chunk)
    return t1 - t0, time.perf_counter() - t1


def cell_engine(dev, config, n=None):
    """A benchmark cell's scene (``bench_port/configs/<config>.json``)
    built by the benchmark's own scene module at ``SEED``; ``n``: that
    many boids (or prey) in place of the configuration's, in its world
    scaled to keep its density."""
    import importlib
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parent / "bench_port" / "configs"
                      / f"{config}.json").read_text())
    if n is not None:
        s = (n / cfg["n_boids"]) ** 0.5
        cfg.update(n_boids=n, world_width=cfg["world_width"] * s,
                   world_height=cfg["world_height"] * s)
    return importlib.import_module(f"bench_port.scenes.{cfg['scene']}").build(
        cfg, SEED, dev).engine


# ---------------------------------------------------------------------------
# the kernels' inputs, from frames of the scenes
# ---------------------------------------------------------------------------

def layout_args(eng):
    """The pair pass's inputs at this moment of a run: the resident layout
    when residency is on, else a fresh binning of the world."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout

    w = eng.world
    strength = float(eng.config.physics.collision_response_strength)
    if eng._plan.residency:
        return (w.solver_x, w.solver_y, w.solver_grad, w.solver_meta, w.step_count,
                strength)
    lay = build_layout(w, eng._plan.solver_geom)
    return (lay.scatter(w.transform.x), lay.scatter(w.transform.y),
            lay.radius, lay.meta, w.step_count, strength)


def stepped_layout(eng, frames=SCENE_FRAMES):
    eng.step(frames, block=True)
    return layout_args(eng)


def slab_grid_args(step, chunks, mesh, d=1):
    """K3's input on slab ``d`` at this moment of a halo run: phase B's
    routing, binning, scatter and border fill (``parallel.halo``'s
    per-slab functions) applied to the placed chunks."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import grid_solver_state
    from multithreadedgameengine_tpu_torch.parallel import halo

    plan = step.plan
    sent = [halo.slab_solver_rows(c, plan, i) for i, c in enumerate(chunks)]
    recv, _slot, _ovf = halo.route_out(mesh, *zip(*sent), plan.route_cap)
    grids = [halo.slab_grid(r, plan, i)[0] for i, r in enumerate(recv)]
    halo.fill_border(mesh, grids, [plan.slab_geom.rows] * mesh.n_slabs)
    st = grid_solver_state(grids[d])
    return (st.gx, st.gy, st.attrs, chunks[0].step_count,
            float(plan.cfg.physics.collision_response_strength))


def halo_slab_args(eng, oversub, frames):
    """K3's input on slab 1 after ``frames`` frames of ``eng``'s scene
    through the halo step on ``HALO_SLABS`` slabs."""
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh

    mesh = make_mesh(HALO_SLABS, eng.device)
    step, place = make_halo_step(eng, mesh, oversub=oversub)
    chunks, ins = place(eng.world), eng.input.snapshot(eng.device)
    for _ in range(frames):
        chunks, _m = step(chunks, ins)
    return slab_grid_args(step, chunks, mesh)


def homed_short_slab_args(dev):
    """K3's input on a slab of the 1M rung under the homed step whose band
    is shorter than the padded grid (its lower halo row inside the computed
    window; an inner slab, whose neighbour below fills that row), after
    ``HOMED_FRAMES`` frames: phase B's staging, block exchange, merge,
    binning and border fill (``parallel.homed``'s per-slab functions)."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import grid_solver_state
    from multithreadedgameengine_tpu_torch.parallel import halo, homed, make_homed_step, make_mesh

    eng = halo_balls_engine(dev)
    mesh = make_mesh(HALO_SLABS, dev)
    step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=HOMED_HEADROOM)
    plan = step.plan
    chunks, gids = place(eng.world)
    ins = eng.input.snapshot(dev)
    for _ in range(HOMED_FRAMES):
        chunks, gids, _m = step(chunks, gids, ins)
    short = [d for d, n in enumerate(plan.band_len) if n < plan.slab_geom.rows]
    if not short:
        raise AssertionError(f"homed_1m: no short band in {plan.band_len}")
    d = ([d for d in short if 0 < d < HALO_SLABS - 1] or short)[-1]
    staged = [homed.slab_solver_stage(c, g, plan, i)
              for i, (c, g) in enumerate(zip(chunks, gids))]
    above = mesh.shift_up([s.buf_up for s in staged])
    below = mesh.shift_down([s.buf_dn for s in staged])
    merged = [homed.slab_phase_b_merge(s, g, a, b, plan.n_cap)
              for s, g, a, b in zip(staged, gids, above, below)]
    grids = [halo.bin_solver_rows(mg.res, plan, row0)[0]
             for mg, row0 in zip(merged, plan.band_start)]
    halo.fill_border(mesh, grids, plan.band_len)
    st = grid_solver_state(grids[d])
    return (st.gx, st.gy, st.attrs, chunks[0].step_count,
            float(plan.cfg.physics.collision_response_strength))


def k4_inputs(dev, n, chunk, total, seed, empty_chunk=None):
    """K4's inputs as the probe makes them: ``n`` distinct slots of
    ``total`` (a seeded permutation; none in chunk ``empty_chunk``), the
    entities sorted by slot, each chunk's range by a search of the sorted
    slots, normal x and y."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(total, generator=g, device=dev)
    if empty_chunk is not None:
        perm = perm[perm // chunk != empty_chunk]
    flat = perm[:n].to(torch.int32)
    order = torch.argsort(flat).to(torch.int32)
    starts = torch.arange(0, total + 1, chunk, device=dev, dtype=torch.int32)
    bounds = torch.searchsorted(flat[order.long()], starts).to(torch.int32)
    x = torch.randn(n, generator=g, device=dev)
    y = torch.randn(n, generator=g, device=dev)
    return (x, y, order, flat, bounds, total, chunk)


def captured_calls(eng, module, name):
    """The arguments of every call of ``module.name`` in the next frame of
    ``eng`` (that frame is run). A wrapper captured in its own module counts
    its launches on the name it is called by, the capture's while it runs:
    they are added to its own after."""
    seen, real = [], getattr(module, name)

    def capture(*args):
        seen.append(args)
        return real(*args)

    before = capture.launches = getattr(real, "launches", 0)
    setattr(module, name, capture)
    try:
        eng.step(1)
    finally:
        setattr(module, name, real)
        if hasattr(real, "launches"):
            real.launches += capture.launches - before
    return seen


def captured_tick_args(eng, kernel):
    """The arguments the model hands ``kernel`` in the next frame of
    ``eng`` (that frame is run): ``Boid.tick``'s to ``boid_tick``, or
    ``Prey.tick``'s to ``prey_tick``."""
    from multithreadedgameengine_tpu_torch.models import boids, predators

    return captured_calls(eng, boids if kernel == "boid_tick" else predators, kernel)[0]


def captured_build_args(eng, start=0):
    """The arguments ``ops.spatial`` hands ``neighbor_build`` for the list
    of rows from ``start`` in the next frame of ``eng`` (that frame is run):
    the global list's, or a class's on a per-class plan."""
    return next(a for a in captured_calls(eng, kernels(), "neighbor_build") if a[6] == start)


def boids_cell_frame(dev):
    """The boid tick's arguments on the boids benchmark cell's boids, world
    and grid: the mouse held at the world's centre, ``CELL_BOIDS_FRAMES``
    frames, then the next frame's."""
    eng = boids_engine(dev, CELL_BOIDS_N, CELL_BOIDS_WORLD, CONFIG3_SPATIAL)
    eng.input.set_mouse(CELL_BOIDS_WORLD[0] / 2, CELL_BOIDS_WORLD[1] / 2)
    eng.input.mouse_button(0, True)
    eng.step(CELL_BOIDS_FRAMES, block=True)
    return captured_tick_args(eng, "boid_tick")


def boids_cell_build(dev):
    """The neighbour build's arguments on the boids benchmark cell's boids,
    world and grid (:func:`boids_cell_frame`'s scene and frame)."""
    eng = boids_engine(dev, CELL_BOIDS_N, CELL_BOIDS_WORLD, CONFIG3_SPATIAL)
    eng.input.set_mouse(CELL_BOIDS_WORLD[0] / 2, CELL_BOIDS_WORLD[1] / 2)
    eng.input.mouse_button(0, True)
    eng.step(CELL_BOIDS_FRAMES, block=True)
    return captured_build_args(eng)


def mixed_cell_build(name):
    """The neighbour build's arguments for class ``name``'s list on the
    mixed benchmark cell's scene after ``MIXED_BUILD_FRAMES`` frames. The
    scene (39 GB on the card) is freed before the inputs are returned."""
    def inputs(dev):
        import gc

        import torch

        eng = cell_engine(dev, "mixed_1m")
        eng.step(MIXED_BUILD_FRAMES, block=True)
        args = captured_build_args(eng, eng.classes[name].start_index)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return args
    return inputs


def mouse_inputs(down, mouse_x, device="cpu"):
    """The input snapshot's mouse fields a tick reads."""
    import torch

    return NS(mouse_x=torch.tensor(mouse_x, dtype=torch.float32, device=device),
              mouse_buttons=torch.tensor([down, False, False], device=device))


def mixed_tick_args(device, seed=7, n=1_000_000, cells=9, cap=64, channels=7):
    """Inputs at the mixed cell's shape: ``[1000000, 576]`` slots (9 cells
    of 64) with a payload of 7 channels, 0-12 live slots a cell as a prefix
    (about 9.4% of them), the mouse in every 97th row's list, prey (type 2)
    with 2% predators (type 3) and 1% lights (type 4) among the neighbours,
    20% of d2 inside the protected range of 12.5, some at 0; the payload
    filled in place, so the largest transient is one ``[n, 576]`` column.
    Returns (the prey tick's arguments less the last two, the flee factor)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    slots = cells * cap

    def u(lo, hi, shape):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    k = torch.randint(0, 13, (n, cells, 1), generator=g, device=device, dtype=torch.int32)
    live = (torch.arange(cap, device=device, dtype=torch.int32).view(1, 1, cap) < k)
    live = live.view(n, slots)
    del k
    ids = torch.randint(1, n, (n, slots), generator=g, device=device, dtype=torch.int32)
    ids.masked_fill_(~live, -1)
    ids[::97, 0] = torch.where(live[::97, 0], 0, -1).to(torch.int32)
    payload = torch.empty((n, slots, channels), device=device)
    payload[..., 0] = ids
    for c, (lo, hi) in zip(range(1, 5), ((0, 40824.0), (0, 16329.0), (-3, 3), (-3, 3))):
        payload[..., c].uniform_(lo, hi, generator=g)
    kind = u(0, 1, (n, slots))
    payload[..., 5] = torch.where(kind < 0.02, 3.0, torch.where(kind < 0.03, 4.0, 2.0))
    payload[..., 5].masked_fill_(ids == 0, 0.0)
    payload[..., 6].uniform_(-1e4, 1e4, generator=g)
    inside = u(0, 1, (n, slots)) < 0.2
    d2 = torch.where(inside, u(1, 156.0, (n, slots)), u(156.25, 25600, (n, slots)))
    d2.masked_fill_(kind > 0.995, 0.0)
    d2.masked_fill_(~live, 0.0)
    del inside, kind, live
    zero = torch.zeros(n, device=device)
    own = (u(0, 40824.0, n), u(0, 16329.0, n), u(-3, 3, n), u(-3, 3, n), zero, zero,
           torch.full((n,), 2, dtype=torch.int32, device=device))
    flock = [torch.full((n,), v, device=device) for v in (12.5, 0.0005, 6.0, 0.05, 0.001, 20.0)]
    inputs = mouse_inputs(True, 20000.0, device)
    mouse = (inputs.mouse_buttons[0], inputs.mouse_x,
             torch.tensor(20000.0, device=device), torch.tensor(8000.0, device=device))
    cols = [payload[..., c] for c in range(1, 6)]
    return (ids, d2, cols, own, flock, mouse, 1.0, (40824.83, 16329.93)), torch.full(
        (n,), 10.0, device=device)


def mixed_cell_inputs(dev):
    """The prey tick on the mixed cell's ``[1000000, 576]`` slots of 7
    payload channels (:func:`mixed_tick_args`)."""
    args, factor = mixed_tick_args(dev)
    return (*args, factor, PRED)


def predators_frame(dev):
    """The prey tick's arguments on BASELINE config 4's next frame after
    ``PRED_WARMUP``."""
    eng = predators_engine(dev)
    eng.step(PRED_WARMUP, block=True)
    return captured_tick_args(eng, "prey_tick")


def predators_blood_layout(dev):
    """K1's input on BASELINE config 4 after ``PRED_WARMUP`` +
    ``PRED_FRAMES`` frames, a blood burst and ``PRED_BLOOD_FRAMES`` frames
    one at a time, as the blood lands."""
    eng = predators_engine(dev)
    eng.step(PRED_WARMUP, block=True)
    eng.step(PRED_FRAMES)
    eng.sync()
    blood_burst(eng)
    for _ in range(PRED_BLOOD_FRAMES):
        eng.step(1)
    return layout_args(eng)


def gathered(make):
    """``make``'s tick arguments with the neighbour columns gathered into
    contiguous tensors, in place of views of the payload."""
    def inputs(dev):
        args = make(dev)
        return (args[0], args[1], [c.contiguous() for c in args[2]], *args[3:])
    return inputs


def ladder_layout(dev):
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    return stepped_layout(make_balls_engine(n_balls=1_000_000, seed=SEED, device=dev,
                                            world_width=90_000.0, world_height=40_000.0,
                                            physics=LADDER_PHYSICS))


def demo_layout(dev):
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    return stepped_layout(make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev), 30)


def demo_slab(dev):
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=N_MAIN - 1, seed=SEED, device=dev)
    eng._flush_pending()
    return halo_slab_args(eng, 4.0, 3)


def halo_boids_slab(dev):
    # K1 pinned as the halo-against-Engine.step check runs this scene; K3
    # does not read the knob
    eng = boids_engine(dev, HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL,
                       solver_predicated="off")
    eng._flush_pending()
    return halo_slab_args(eng, HALO_BOIDS_OVERSUB, 10)


def cell_layout(config):
    """K2's input on a benchmark cell's scene after ``CELL_BOIDS_FRAMES``
    frames through ``Engine.step``."""
    return lambda dev: stepped_layout(cell_engine(dev, config), CELL_BOIDS_FRAMES)


class Case(NamedTuple):
    """One row of the kernel table."""

    kernel: str  # the wrapper's name in ops.cuda_kernels
    inputs: str  # the inputs, as PERF.md §6 names them
    make: Callable  # make(device) -> the wrapper's arguments
    reps: int  # launches in the timed CUDA graph
    launches: dict  # each kernel's launches while ``make`` runs its scene (absent: 0)
    clamp: Optional[tuple] = None  # K2's clamp_bounds

    @property
    def id(self) -> str:
        return f"{self.kernel}-{self.inputs}"


# launches of the scenes' main paths: K1 or K2 once a substep (the demo and
# halo balls scenes have 2, the rest 1), K3 once a substep a slab, a tick
# once a frame (a slab) of its class; the synthetic inputs launch nothing
DEMO = dict(pair_pass_resident=30 * 2)
LADDER = dict(pair_pass_symmetric=SCENE_FRAMES * 2)
# and the neighbour build once a frame where a tick reads lists, once a
# class list a frame on the mixed cell's per-class plan (prey, predators,
# lights)
BOIDS_CELL_TICK = dict(pair_pass_symmetric=CELL_BOIDS_FRAMES + 1, boid_tick=CELL_BOIDS_FRAMES + 1,
                       neighbor_build=CELL_BOIDS_FRAMES + 1)
PRED_TICK = dict(pair_pass_resident=PRED_WARMUP + 1, prey_tick=PRED_WARMUP + 1,
                 neighbor_build=PRED_WARMUP + 1)
MIXED_BUILD = dict(pair_pass_symmetric=MIXED_BUILD_FRAMES + 1, prey_tick=MIXED_BUILD_FRAMES + 1,
                   neighbor_build=3 * (MIXED_BUILD_FRAMES + 1))

CASES = (
    Case("pair_pass_resident", "demo_10k", demo_layout, 200, DEMO),
    Case("pair_pass_resident", "ladder_1m", ladder_layout, 50, LADDER),
    Case("pair_pass_resident", "boids_15k",
         lambda dev: stepped_layout(boids_engine(dev, BOIDS_N, BOIDS_WORLD, CONFIG3_SPATIAL)),
         200, dict(pair_pass_resident=SCENE_FRAMES, boid_tick=SCENE_FRAMES,
                   neighbor_build=SCENE_FRAMES)),
    Case("pair_pass_resident", "predators_15k", predators_blood_layout, 200,
         dict(pair_pass_resident=PRED_WARMUP + PRED_FRAMES + PRED_BLOOD_FRAMES,
              prey_tick=PRED_WARMUP + PRED_FRAMES + PRED_BLOOD_FRAMES,
              neighbor_build=PRED_WARMUP + PRED_FRAMES + PRED_BLOOD_FRAMES)),
    Case("pair_pass_symmetric", "ladder_1m_clamp", ladder_layout, 50, LADDER,
         (90_000.0, 40_000.0)),
    Case("pair_pass_symmetric", "demo_10k", demo_layout, 200, DEMO),
    Case("pair_pass_symmetric", "boids_102k_cell_layout", cell_layout("boids_102k"), 50,
         dict(pair_pass_symmetric=CELL_BOIDS_FRAMES, boid_tick=CELL_BOIDS_FRAMES,
              neighbor_build=CELL_BOIDS_FRAMES)),
    Case("pair_pass_symmetric", "mixed_1m_cell_layout", cell_layout("mixed_1m"), 50,
         dict(pair_pass_symmetric=CELL_BOIDS_FRAMES, prey_tick=CELL_BOIDS_FRAMES,
              neighbor_build=3 * CELL_BOIDS_FRAMES)),
    Case("pair_pass_grid", "halo_1m_slab1",
         lambda dev: halo_slab_args(halo_balls_engine(dev), 4.0, HALO_FRAMES), 50,
         dict(pair_pass_grid=HALO_FRAMES * 2 * HALO_SLABS)),
    Case("pair_pass_grid", "homed_1m_short_slab", homed_short_slab_args, 50,
         dict(pair_pass_grid=HOMED_FRAMES * 2 * HALO_SLABS)),
    Case("pair_pass_grid", "halo_10k_slab1", demo_slab, 200,
         dict(pair_pass_grid=3 * 2 * HALO_SLABS)),
    Case("pair_pass_grid", "halo_boids_slab1", halo_boids_slab, 100,
         dict(pair_pass_grid=10 * HALO_SLABS, boid_tick=10 * HALO_SLABS)),
    Case("expand", "probe_1m", lambda dev: k4_inputs(dev, K4_N, K4_CHUNK, K4_TOTAL, SEED),
         50, {}),
    Case("expand", "ragged_1237",
         lambda dev: k4_inputs(dev, 1237, 8200, 5 * 8200, SEED + 1, empty_chunk=2), 200, {}),
    Case("boid_tick", "boids_102k_cell", boids_cell_frame, 50, BOIDS_CELL_TICK),
    Case("boid_tick", "boids_102k_cell_gathered", gathered(boids_cell_frame), 50,
         BOIDS_CELL_TICK),
    Case("prey_tick", "mixed_1m_cell", mixed_cell_inputs, 20, {}),
    Case("prey_tick", "mixed_1m_cell_gathered", gathered(mixed_cell_inputs), 20, {}),
    Case("prey_tick", "predators_15k_frame", predators_frame, 200, PRED_TICK),
    Case("prey_tick", "predators_15k_frame_gathered", gathered(predators_frame), 200, PRED_TICK),
    Case("neighbor_build", "boids_102k_cell", boids_cell_build, 20, BOIDS_CELL_TICK),
    Case("neighbor_build", "mixed_1m_prey", mixed_cell_build("Prey"), 3, MIXED_BUILD),
    Case("neighbor_build", "mixed_1m_predators", mixed_cell_build("Predator"), 200, MIXED_BUILD),
)


def scene_inputs(case, dev):
    """The case's inputs made on ``dev``, and each kernel's launches while
    its scene ran, which must be ``case.launches``' (absent kernels none)."""
    zero_launches()
    args = case.make(dev)
    seen = launches()
    want = {name: case.launches.get(name, 0) for name in KERNELS}
    if seen != want:
        raise AssertionError(f"{case.id}: launches {seen}, expected {want}")
    return args, seen


# ---------------------------------------------------------------------------
# the kernels against their plain versions
# ---------------------------------------------------------------------------

def boid_order_tolerance(args):
    """Per row, how far the boid tick's ``ax`` and ``ay`` may differ when
    only the order of each row's sums differs: ``(S + 8) 2^-22`` times the
    sum of the magnitudes that make up each (the separation, cohesion and
    alignment terms, the row's own x and vx against which the means are
    taken, ax, the mouse's push and the margin turn), in float64."""
    import torch

    ids, d2, cols, own, flock, mouse, dt, _extent = args
    d = lambda t: t.double()  # noqa: E731
    live = ids >= 0
    nx, ny, nvx, nvy = (torch.where(live, d(c), 0.0) for c in cols[:4])
    ntype = torch.where(live, cols[4], 0.0).to(torch.int32)
    x, y, vx, vy, ax, ay = (d(t) for t in own[:6])
    pr, cf, af, mf, tf, _mg = (d(t) for t in flock)
    d2 = d(d2)
    not_mouse = live & (ntype != 0)
    sep = not_mouse & (d2 < (pr * pr)[:, None]) & (d2 > 0)
    same = not_mouse & ~sep & (ntype == own[6][:, None])
    inv_n = 1.0 / same.sum(1).clamp(min=1).double()
    inv_d2 = torch.where(sep, 1.0 / torch.where(sep, d2, 1.0), 0.0)
    md2 = torch.where(live & (ids == 0), d2, 0.0).sum(1)
    push = torch.where(md2 > 0, 1000.0 * dt / torch.where(md2 > 0, md2, 1.0), 0.0)
    tols = []
    for n_c, n_v, s, v, a, m in ((nx, nvx, x, vx, ax, d(mouse[2])),
                                 (ny, nvy, y, vy, ay, d(mouse[3]))):
        mag = (af * dt * (torch.where(sep, (n_c - s[:, None]).abs(), 0.0) * inv_d2).sum(1)
               + cf * dt * (torch.where(same, n_c.abs(), 0.0).sum(1) * inv_n + s.abs())
               + mf * dt * (torch.where(same, n_v.abs(), 0.0).sum(1) * inv_n + v.abs())
               + a.abs() + push * (m - s).abs() + 2 * tf * dt)
        tols.append((ids.shape[1] + 8) * 2.0**-22 * mag)
    return tols


def prey_order_tolerance(args, factor, predator_type, block=1 << 16):
    """Per row, how far the prey tick's ``ax`` and ``ay`` may differ when
    only the order of each row's sums differs: the boid tick's bound with
    the flee's terms (``predator_avoid_factor dt |d| / d2`` of each predator
    left to the hook) in the magnitudes and ``S + 10`` in place of
    ``S + 8``, in float64, ``block`` rows at a time."""
    import torch

    ids, d2, cols, own, flock, mouse, dt, extent = args
    n, s = ids.shape
    tols = ([], [])
    for r0 in range(0, n, block):
        sl = slice(r0, r0 + block)
        part = (ids[sl], d2[sl], [c[sl] for c in cols], [t[sl] for t in own],
                [t[sl] for t in flock], mouse, dt, extent)
        boid = boid_order_tolerance(part)
        live = part[0] >= 0
        ntype = torch.where(live, part[2][4], 0.0).to(torch.int32)
        pd2 = part[1].double()
        prot2 = (part[4][0].double() ** 2)[:, None]
        sep = live & (ntype != 0) & (pd2 < prot2) & (pd2 > 0)
        is_pred = live & (ntype == predator_type) & ~sep & (pd2 > 0)
        inv = torch.where(is_pred, 1.0 / torch.where(is_pred, pd2, 1.0), 0.0)
        pf = factor[sl].double() * dt
        for k, (c, o) in enumerate(((part[2][0], part[3][0]), (part[2][1], part[3][1]))):
            gap = torch.where(is_pred, (c.double() - o.double()[:, None]).abs(), 0.0)
            flee = pf * (gap * inv).sum(1)
            tols[k].append(boid[k] * ((s + 10) / (s + 8)) + (s + 10) * 2.0**-22 * flee)
    return torch.cat(tols[0]), torch.cat(tols[1])


def compare(case, args, got, want) -> dict:
    """The kernel's outputs ``got`` against its plain version's ``want`` on
    ``args``: {"ok": ..., "max_abs_err": ...}. The pair passes and K4 must
    equal their plain versions bit for bit, since both sides round every
    operation the same way in the same order (--fmad=false, IEEE sqrt and
    division), with contacts in the layout; the ticks sum each row in
    another order than ``torch.sum``, so they must lie within the summing
    order's tolerance (:func:`boid_order_tolerance`,
    :func:`prey_order_tolerance`). The neighbour build must equal its plain
    version bit for bit in ids, d2, count and payload, with some slot
    kept."""
    import torch

    if case.kernel == "neighbor_build":
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
        err = (got[1] - want[1]).abs().max().item()
        return {"ok": same and int(want[2].sum().item()) > 0, "max_abs_err": err}
    if case.kernel in PAIR_PASSES + ("expand",):
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point()
                   else torch.equal(a, b) for a, b in zip(got, want))
        # over the finite words: K4 moves -0.0, inf and NaN bit for bit
        err = max(torch.where(b.isfinite(), a - b, 0.0).abs().max().item()
                  for a, b in zip(got[:2], want[:2]))
        contacts = case.kernel == "expand" or int(want[2].sum().item()) > 0
        return {"ok": same and contacts, "max_abs_err": err}
    if case.kernel == "boid_tick":
        tx, ty = boid_order_tolerance(args)
    else:
        tx, ty = prey_order_tolerance(args[:8], *args[8:])
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    within = bool(((got[0].double() - want[0].double()).abs() <= tx).all().item()
                  and ((got[1].double() - want[1].double()).abs() <= ty).all().item())
    return {"ok": within, "max_abs_err": err}
