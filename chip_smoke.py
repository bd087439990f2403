#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``multithreadedgameengine_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, each printing one line or more before the last:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions, and
   the nvcc build of the kernels from ``multithreadedgameengine_tpu_torch/
   csrc`` (sm_90a, one nvcc per source, in parallel), with each kernel's
   registers, shared memory and spills from ``-Xptxas -v``;
2. kernel parity: K1 (the two-sided pair pass) and K2 (the predicated
   Newton-symmetric pass, with and without its folded boundary clamp)
   against their plain PyTorch versions on the card, on the demo scene's
   layout after 30 frames, on a synthetic layout with statics, a trigger,
   a world-edge pile, a coincident pair, a full cell and moving slots
   outside the world, and on two dense layouts where every cell is full
   (capacity 4 and 64, with occupied slots that hold no collider); then both
   kernels timed, and K1 timed eager beside its graph time (what the host
   adds to a launch at this size);
3. slice A's main path: the ``bench.py`` scene (10,000 balls, seed 123456)
   for 10 + 120 frames through ``Engine.step``, with the launch count of
   every kernel over exactly that run (K1 only: the reference's gate picks
   the two-sided kernel at this width); then a 400-ball scene on the card
   against the same scene on the CPU (plain versions) as the reference;
4. slice B's main path: the JAX ladder's 1M rung (``benchmarks/
   run_ladder.py:84-93``: 1,000,000 balls in 90000 x 40000,
   ``solver_capacity`` 12, ``rebin_interval`` 8, the auto knobs) for 5 + 20
   frames: K2 with the folded clamp, the rebin and attribute caches,
   position residency, the banded boundary and the lazy chunk; launch
   counts, overflow, band drift, lazy frames and steps/s; then K2 against
   its plain version on that layout, and K1 and K2 timed on it;
5. residency on against off on the card: 100,000 balls with the ladder's
   knobs and the mouse held down, 2 x ``rebin_interval`` frames each; x, y,
   px, py and the contact counts must be bit-equal;
6. slice E1's main path, the spatial-domain halo step on the card: (a) K3
   (the legacy grid pair pass) against its plain version on a synthetic
   grid with occupied border rows, a static, a trigger, a coincident pair
   and a full cell, and on two dense grids where every cell, border rows
   included, is full (capacity 4 and 64); (b) the JAX halo scaling
   benchmark's balls scene
   (``benchmarks/halo_scaling.py:104-110``: 999,999 balls and the mouse in
   90000 x 40000, the demo's physics) cut into 4 slabs on one card,
   ``oversub`` 4, 3 + 10 frames through ``make_halo_step``: steps/s, K3
   launches (frames x substeps x slabs), K1 and K2 launches (0), route
   overflow and finiteness; then K3 against its plain version on one slab
   grid of that run, and timed there; (c) 100,000 entities in 28460 x 12649
   on 4 slabs (``oversub`` 4) against ``Engine.step`` (K1) for 10 frames:
   x, y, px, py and the contact counts must be bit-equal; (d) K3 timed on
   one slab grid of the 10,000-ball demo scene on 4 slabs;
7. slice C1's main path, BASELINE config 3 (``benchmarks/run_ladder.py:
   166-188``): 15,000 boids and the mouse in 5000 x 2000 through
   ``Engine.step``, 5 + 20 frames, each building its neighbour lists (the
   cell-major form, 800 candidate slots, 6 payload channels), running the
   batched ``Boid.tick`` (the boid tick kernel) and K1 once
   (``[boids_15k]``: steps/s, launch counts, ``n_binned``, overflow, mean
   neighbour count, finiteness); then 400 boids on the card against the CPU
   for 5 frames (``[boids_reference]``); then the boids benchmark cell's
   scene (102,400 boids, the mouse held, 30 frames) and the boid tick on
   its next frame's arguments against its plain version, timed beside it
   and its two bounds, on the payload's channels and on gathered columns
   (``[boid_tick_102k]``);
8. the halo benchmark's boids scene (``benchmarks/halo_scaling.py:77-102``,
   ``oversub`` 1.5 as at :258): 102,400 entities on 4 slabs of the card,
   phase A building each slab's neighbour tables, for 10 frames against
   ``Engine.step`` (``[halo_boids]``: steps/s, K3 launches, route
   overflows, and the comparison);
9. K4 (``expand``) at the probe's shapes (``benchmarks/
   probe_expand_kernel.py:104-119``: 1,000,000 entities, 66 chunks of
   131,072 slots): one placement through the wrapper as the probe makes
   it, then against its plain version bit for bit there, on a small
   odd-sized case and on the edges of its tiling (a chunk whose every slot
   holds an entity, chunks that are no multiple of the tile, entities on
   the first and last slot of every tile, one entity in 66 probe-sized
   chunks), with its plan (slots a tile, blocks, shared memory a block)
   and its registers and spills from ``-Xptxas -v``, timed beside the
   probe's yardstick (zeros and ``index_copy_``, ``[k4]``);
10. slice C2's main path, BASELINE config 4 (``models/predators.py``'s
   ``make_predators_engine`` at the demo's operating point: 15,000 prey, 8
   predators, 5 lights and the mouse in 5000 x 2000, the 50,000-particle
   pool with decals, lighting with shadows), the camera zoomed out over
   the whole world, 5 + 20 frames through ``Engine.step``
   (``[predators_15k]``: steps/s, launch counts, ``n_binned``, overflow,
   the shadow sprites); then one ``emitter.emit_batch`` of the demo's
   blood and 100 more frames (``[predators_blood]``: the live particles
   falling as they land, the canvas and dirty tiles changed); the 64-stamp
   decal loop alone on that run's stamp batch (``[stamp_decals]``); K1
   against its plain version on the scene's layout and timed there; then
   400 prey on the card against the same scene on the CPU for 6 frames with
   a landing burst (``[predators_reference]``);
11. slice C3's main path, BASELINE config 4 with events on as the JAX
   ladder's ``rung_predators`` runs it (``benchmarks/run_ladder.py:
   199-240``: ``logic.collision_events``, ``event_chunk`` 60,
   ``event_overlap``), at ``[predators_15k]``'s camera: 5 warm-up frames,
   one 60-frame chunk whose frames run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read inside a
   chunk), then 3 chunks back to back with one sync (``[predators_events]``:
   steps/s, the Enter/Stay/Exit rows dispatched, the blood particles the
   predators' hook queued, live particles, pairs recorded and dropped, log
   rows dropped, canvas pixels changed, K1 launches); the 400-prey scene
   with a predator placed on a prey, events on, on the card and on the CPU
   for 6 frames (``[events_reference]``: per-frame event tables and hook
   calls identical, pool and canvas within ``[predators_reference]``'s
   bounds); and on the card at ``event_chunk`` 1, 4 and 4 with overlap for
   12 frames (``[events_chunk]``: hook calls identical);
12. slice E2, the mixed halo passes: the halo benchmark's mixed scene
   (``benchmarks/halo_scaling.py:61-75``: 25,600 entity slots, 24
   predators, 7 lights, the rest prey, in 7000 s x 3500 s with s = (25,600
   / 15,028)^0.5, collision events, ``oversub`` 2.5 as in
   ``HALO_SCALING_PREDATORS_r03.json``) on 4 slabs of the card, a blood and
   a landing burst in the pool, 3 + 1 + 20 frames, the fourth under
   ``set_sync_debug_mode("error")`` (``[halo_predators_d4]``: steps/s,
   pairs, particles, shadows, route overflows, K3 launches); the 400-prey
   event scene through the halo step on 3 slabs and through
   ``Engine.step``, the engine's hooks fired after every frame of both
   (``[halo_events_reference]``: event tables, hook calls, emissions, pool,
   canvas and entities identical); ``tests/test_halo_mixed.py``'s static
   shadow scene through both slab steps and ``Engine.step``
   (``[slab_shadows_static]``);
13. the homed step: halo_1m_d4's scene through ``make_homed_step``
   (headroom 1.125, as ``benchmarks/halo_scaling.py:150-186`` runs it),
   3 + 1 + 10 frames, the fourth under the sync check (``[homed_1m_d4]``:
   steps/s beside phase 6's halo steps/s, migrated rows a frame,
   violators, overflow, K3 launches); K3 on a slab whose band is shorter
   than the padded grid (its lower halo row inside the computed window)
   against its plain version, bit for bit, and timed; the 100k balls
   scene under the homed step against ``Engine.step``
   (``[homed_vs_single_100k]``, bit-equal); phase 8's boids scene under the
   homed step, bit-equal with the halo step and ``Engine.step``
   (``[homed_boids_102k_d4]``, run in phase 8);
14. phase 12's mixed scene through the homed step (headroom 2), one frame
   under the sync check, against phase 12's halo run of the same frames
   (``[homed_mixed]``: entities, event tables, pool, canvas and shadows
   identical);
15. slice D1's main path, BASELINE config 2 as the JAX ladder's
   ``rung_churn`` runs it (``benchmarks/run_ladder.py:110-160``): the demo
   scene, 5 frames, then plans whose every frame despawns 256 active balls
   and spawns 256 (``np.random.default_rng(7)``, x in [100, 8900], y in
   [100, 1000]) through ``FramePlan`` and ``Engine.run_plan`` in chunks of
   30: two warm plans of 30 frames (the first with every frame and its op
   table's upload under ``set_sync_debug_mode("error")``), then three timed
   plans of 60 frames, each timed from building the plan to a sync
   (``[churn_10k]``: steps/s median and quartiles, the host's plan-building
   and ``run_plan`` seconds, K1 and K2 launches over the timed frames,
   overflow, the pool's and the device's active counts); beside it the same
   scene through ``Engine.step`` without churn, timed the same way;
16. 400 balls churning 16 a frame for 8 frames through a plan in chunks of
   4 on the card, against the same ops issued as ``despawn_batch`` +
   ``spawn_batch`` + ``step(1)`` on the card (bit-equal, free lists equal)
   and against the plan on the CPU (integers exact, positions within 8
   ulps; ``[plan_vs_immediate]``);
17. phase 5's 100k scene with the ladder's knobs and the mouse down: a
   sparse plan (256 despawns and spawns on frames 0 and 5 of 12, chunks of
   6) and a dense one (every frame of 8, chunks of 4), each with residency
   on and off, bit-equal, with the kernel the gate picked and its launches
   (``[plan_resident_100k]``);
18. the 400-prey event scene through a plan of 8 frames in chunks of 4,
   every frame under the sync check, against ``step(1)`` per frame: hook
   calls, emissions, tables and entities identical (``[plan_events]``);
19. the demo scene saved at frame 10 and stepped 15 more, against a fresh
   engine loaded from the file and stepped 15: bit-equal, and the next
   ``rng()`` equal (``[checkpoint]``);
20. slice C4's main path: the demo scene with ``solver="neighbors"``
   through ``Engine.step``, 5 + 20 frames, beside phase 3's grid steps/s
   (``[neighbors_10k]``: steps/s, no kernel launched, ``n_binned``); 400
   balls on the neighbour solver on the card against the CPU for 3 frames
   (counts exact, positions within 8 ulps) and ``tests/test_physics_grid.py``'s
   random scene through both solvers on the card for 5 frames (within
   2e-3; ``[neighbors_reference]``);
21. slice D2's main path on the demo scene: the render server as
   ``server/render_server.py::run_scene`` drives it (``apply_inputs``,
   ``step(2)``, ``publish``) for 80 steps, a client thread posting its
   camera to /input and reading every frame over localhost, beside 80
   steps unpublished and 80 with a sync every 2 steps in place of the
   publish, in turns of 40 (unpublished, synced, published, published,
   synced, unpublished; ``[render_server_balls_10k]``: the three steps/s,
   each publish's own ms, K1's launches, the frames the client parsed); the
   published header against the packet; K1 against its plain version on
   the scene's layout after the run; the packet and the frame of the card's
   world against its CPU copy's (``[render_packet]``);
22. the same in front of BASELINE config 4 with the demo atlas
   (``build_demo_atlas``) and a blood burst, the decal PNG every 60 steps
   (``[render_server_predators_15k]``: also a publish with the PNG, the
   atlas endpoints, the decal PNG, non-empty particle, shadow and light
   sections; ``[render_packet]``);
23. ``Engine.screenshot`` of phase 22's world on the card against its CPU
   copy: the same PNG bytes (``[screenshot]``);
24. slice F, the process mesh: four gloo ranks on the card, started once
   by ``dryrun.dryrun_multichip`` after the kernels are built (every
   message staged through pinned host memory, the only host reads a
   dist frame makes): every collective against ``SlabMesh`` on the same
   inputs, bit for bit (``[dist_collectives]``);
25. in the same ranks, every rung of the reference's dry run with its
   asserts (``[dist_dryrun]``), then phases 6, 8 and 12-14's slab runs
   again over the process mesh with the same frames, each rank's chunk
   digests equal to the in-process run's chunk, every rank's replicated
   leaves alike, one frame a rank under the sync check:
   ``[dist_halo_boids_102k_d4]``, ``[dist_homed_boids_102k_d4]``,
   ``[dist_halo_1m_d4]``, ``[dist_homed_1m_d4]``, ``[dist_halo_mixed]``,
   ``[dist_homed_mixed]``; and the entity-sharded step on balls_10k
   (10,000 entities) against ``Engine.step`` (``[dist_sharded_balls_10k]``):
   steps/s beside the in-process rate, the bytes each rank's mesh moves
   and stages a frame, its calls a frame, and the mesh's share of one
   instrumented frame (rank 0, a sync around each mesh call) -- one card,
   no scaling figure;
26. NCCL at ``world_size = torch.cuda.device_count()`` (one rank a card):
   the halo boids cell against ``SlabMesh`` at the same D
   (``[nccl_halo_boids_102k]``; the line before says the count);
27. each dist cell's K3 launches (K1 on the sharded cell), gathered to
   rank 0, in the kernel line as ``launches_dist_*``.

Kernel times are CUDA events around one replay of a CUDA graph of 50-200
launches (the kernel's own time; the wrapper's host cost is not in it);
plain versions run eager. The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": {...}}``.
Any failure raises, exits non-zero and prints no result. Without a CUDA
device it exits 1 at once.
This script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request

N_MAIN = 10_000
SEED = 123456
WARMUP, CHUNK, CHUNKS = 10, 30, 4
# the JAX ladder's physics from 100k balls up (benchmarks/run_ladder.py:84-93)
LADDER_PHYSICS = dict(
    sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
    boundary_elasticity=0.0, collision_response_strength=0.8,
    gravity=(0.0, 0.5), solver_capacity=12, rebin_interval=8,
)
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
# slice E1's halo rung (benchmarks/halo_scaling.py:104-110 at its default n)
HALO_N, HALO_SLABS, HALO_WARMUP, HALO_FRAMES = 1_000_000, 4, 3, 10
HALO_WORLD = (90_000.0, 40_000.0)
# the halo-against-single-device check: 100,000 entities at the demo's density
CHECK_N, CHECK_WORLD = 100_000, (9000.0 * 10 ** 0.5, 4000.0 * 10 ** 0.5)
PEAK_F32_S = 67e12
# slice C1: BASELINE config 3, the JAX ladder's boids rung
BOIDS_N, BOIDS_WORLD, BOIDS_WARMUP, BOIDS_FRAMES = 15_000, (5000.0, 2000.0), 5, 20
#: the boids benchmark cell's scene (``bench_port/configs/boids_102k.json``)
CELL_BOIDS_N, CELL_BOIDS_WORLD, CELL_BOIDS_FRAMES = 102_400, (13_064.0, 5_226.0), 30
CONFIG3_SPATIAL = dict(cell_size=50.0, max_neighbors=400, cell_capacity=32)
# the halo benchmark's boids scene at its default size, and its oversub
HALO_BOIDS_N, HALO_BOIDS_WORLD, HALO_BOIDS_FRAMES = 102_400, (12_000.0, 6_000.0), 10
HALO_BOIDS_SPATIAL = dict(cell_size=100.0, max_neighbors=48, cell_capacity=32)
HALO_BOIDS_OVERSUB = 1.5
# K4 at the probe's shapes: 1M entities, chunks of 128 x 1024 slots over the
# 1M ladder layout rounded up to whole chunks (66)
K4_N, K4_CHUNK = 1_000_000, 128 * 1024
K4_TOTAL = (12 * 556 * 1280 // K4_CHUNK + 1) * K4_CHUNK
# slice C2: BASELINE config 4 at the demo's operating point, the camera
# zoomed out over the whole world (camera x, y and zoom)
PRED_WARMUP, PRED_FRAMES, PRED_BLOOD_FRAMES = 5, 20, 100
PRED_CAMERA = (0.0, 0.0, 0.3)
PRED_REF = dict(n_prey=400, n_predators=8, n_lights=5, world_width=1600.0, world_height=1000.0)
PRED_REF_FRAMES = 6
# slice C3: the JAX ladder's predators rung with events (run_ladder.py:208-240)
EVENTS_LOGIC = dict(collision_events=True, event_chunk=60, event_overlap=True)
EV_WARMUP, EV_CHUNK, EV_CHUNKS = 5, 60, 3
EV_CHUNK_FRAMES = 12
# slice E2: the halo benchmark's mixed scene (halo_scaling.py:61-75) at the
# size and route oversub of HALO_SCALING_PREDATORS_r03.json, the homed
# rung's headroom (halo_scaling.py:150-186), the mixed scene's homed
# headroom (the reference's default), and the slabs of the 414-entity event
# scene (the entity count must split evenly)
HALO_PRED_N, HALO_PRED_OVERSUB, HALO_PRED_WARMUP, HALO_PRED_FRAMES = 25_600, 2.5, 3, 20
HOMED_HEADROOM, HOMED_MIXED_HEADROOM = 1.125, 2.0
HALO_EVENT_SLABS = 3
# slice D1: BASELINE config 2, the JAX ladder's churn rung (run_ladder.py:
# 110-160): despawns and spawns a frame, plan chunk, warm-up plans of one
# chunk, timed plans and their frames; and the small churn of phase 16
CHURN, CHURN_CHUNK, CHURN_WARM_PLANS, CHURN_PLANS, CHURN_FRAMES = 256, 30, 2, 3, 60
SMALL_CHURN = dict(balls=400, frames=8, churn=16, chunk=4)
PLAN_REF_ULPS = 8
PLAN_EVENT_FRAMES, PLAN_EVENT_CHUNK = 8, 4
# slices C4 and D2: the neighbour-list solver on the demo scene, and the
# render server as ``run_scene`` drives it (a publish every 2 steps, the
# decal PNG every 60), over a step budget, beside the same steps
# unpublished; the 400-ball card-against-CPU check of the neighbour solver
# (3 frames, positions within NBR_REF_ULPS ulps at the world's extent: the
# lists' sums run in another order on the card) and the reference's
# neighbours-against-grid bar (tests/test_physics_grid.py, 5 frames)
NBR_WARMUP, NBR_FRAMES, NBR_REF_FRAMES, NBR_REF_ULPS = 5, 20, 3, 8
NBR_GRID_FRAMES, NBR_GRID_ATOL = 5, 2e-3
# the timed runs go in turns, each RENDER_CHUNK steps: unpublished, synced,
# published, published, synced, unpublished (the host's speed drifts within
# a call)
RENDER_CHUNK, STEPS_PER_PUBLISH, DECALS_EVERY = 40, 2, 60
RENDER_STEPS = 2 * RENDER_CHUNK
# the balls client's camera, posted to /input: the whole 9000 x 4000 world
# on the scene's 1600 x 600 canvas, where the default camera (the world's
# centre, zoom 1) sees none of the pile once the balls have fallen
BALLS_CAMERA = (0.0, 0.0, 0.15)
PUBLISH_TIMED = 10
SHOT_SIZE = (480, 270)
# slice F: the process mesh's ranks (four on one card over gloo), the
# deadline of a run of ranks, the sharded cell's frames and the NCCL cell's
DIST_RANKS, DIST_DEADLINE_S, SHARDED_FRAMES, NCCL_FRAMES = 4, 600.0, 22, 6


# Each kernel against its plain version: contact counts must match exactly;
# positions to 2 float32 ulps at the world's extent, and K3's displacements
# to 2 ulps at their own largest magnitude. Both sides round every
# operation the same way and sum in the same order (the kernels are built
# with --fmad=false and use IEEE sqrt and division, as torch's separate CUDA
# ops do), so the expected difference is 0; the bound leaves room for a
# compiler's different but valid rounding of one operation, never for a
# different algorithm.
def pos_tol(extent: float) -> float:
    import numpy as np

    return 2.0 * float(np.spacing(np.float32(extent)))


def card_name_and_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def kernels():
    """The port's kernel module (wrappers, plain versions, launch counts)."""
    from multithreadedgameengine_tpu_torch.ops import cuda_kernels as ck

    return ck


def kernel_vs_plain(kernel, plain, name, args, extent, **kw):
    """Run a kernel and its plain version on the same card inputs; returns
    the max error of the first two outputs (positions, or K3's
    displacements) and the kernel's outputs after checking counts and
    tolerance. ``extent=None`` scales the tolerance to the largest value
    the plain version returns (K3's displacements, of order 1 px), not to
    the world."""
    import torch

    kx, ky, kc = kernel(*args, **kw)
    px, py, pc = plain(*args, **kw)
    torch.cuda.synchronize()
    err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
    if extent is None:
        extent = max(px.abs().max().item(), py.abs().max().item())
    tol = pos_tol(extent)
    n_bad = int((kc != pc).sum().item())
    contacts = int(kc.sum().item())
    label = kernel.__name__ + ("+clamp" if kw.get("clamp_bounds") else "")
    log("parity", kernel=label, layout=name, shape=list(args[0].shape), contacts=contacts,
        count_mismatch=n_bad, max_abs_err=err, tol=tol)
    check(n_bad == 0, f"{label}: contact counts differ from the plain version on {name}")
    check(err <= tol, f"{label}: outputs differ by {err} on {name}")
    check(contacts > 0, f"no contacts in the {name} layout")
    return err, (kx, ky, kc)


def events_ms(run, reps: int) -> float:
    """ms per launch of ``run()``, which issues ``reps`` launches, between
    two CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def eager_timer(fn, args, reps, **kw):
    """A timer of ``reps`` eager calls of ``fn``, each through its Python
    wrapper: what the host adds to every launch is in it."""
    import torch

    def run():
        for _ in range(reps):
            fn(*args, **kw)

    fn(*args, **kw)
    torch.cuda.synchronize()
    return lambda: events_ms(run, reps)


def graph_timer(fn, args, reps, **kw):
    """A timer of one replay of a CUDA graph holding ``reps`` launches of
    ``fn``: the kernels' own time, without the host's. An eager warm-up
    launch first sets the kernel's shared-memory attribute and reads its
    capacity limit outside the capture. Replays do not pass through the
    wrapper, so they add nothing to its launch count."""
    import torch

    fn(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    return lambda: events_ms(graph.replay, reps)


def time_kernel(kernel, plain, args, kernel_reps=200, plain_reps=5, **kw):
    """Median ms of a kernel (graph replay) and of its plain version
    (eager: it reads values on the host, so it cannot be captured), in
    turns plain, kernel, kernel, plain, twice."""
    plain_run = eager_timer(plain, args, plain_reps, **kw)
    kern_run = graph_timer(kernel, args, kernel_reps, **kw)
    plain_t, kern_t = [], []
    for _ in range(2):
        plain_t.append(plain_run())
        kern_t.append(kern_run())
        kern_t.append(kern_run())
        plain_t.append(plain_run())
    return statistics.median(kern_t), statistics.median(plain_t)


def bound(args, contacts: int, symmetric: bool):
    """The least time the card could take for one pass over this layout, in
    ms, and what bounds it: the bytes the function must move (x, y, meta
    read and x, y, count written for every slot, 24 bytes; the radius read
    only for the slots holding a collider, 4 bytes each, since every other
    slot takes part in no pair) over the HBM rate, against the float32
    operations this data needs over the card's non-tensor-core rate.
    Operations: 8 per candidate pair (dx, dy, d2,
    min_d, the overlap test) and 16 more per contact (square root, division,
    the push and its sum), over the candidate pairs of the 3x3 neighbourhood
    -- each pair once for K2, from both sides for K1. ``contacts`` is the
    layout's contact count summed over slots (each contact twice)."""
    import torch

    x, meta = args[0], args[3]
    n_bytes = 24 * x.numel() + 4 * int((((meta >> 24) & 1) != 0).sum().item())
    occ = (meta != 0).sum(0).to(torch.float64)  # entities per cell
    nb = torch.nn.functional.avg_pool2d(occ[None, None], 3, stride=1, padding=1,
                                        divisor_override=1)[0, 0]
    pairs = float((occ * (nb - 1)).sum().item())  # ordered pairs, 3x3
    per_pair = 0.5 if symmetric else 1.0
    n_ops = per_pair * (8 * pairs + 16 * contacts)
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def synthetic_args(device):
    """A hand-made layout: a pile against the world's left and bottom edges
    with a static and a trigger in it, an exactly coincident pair, one cell
    holding more entities than its capacity, and moving entities outside
    ``[r, extent - r]`` on every side (for K2's folded clamp)."""
    import torch

    from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout
    from multithreadedgameengine_tpu_torch.ops.spatial import GridGeom
    from multithreadedgameengine_tpu_torch.state import make_world

    pts = [
        # pile at the bottom-left corner (world 300 x 200)
        (6.0, 194.0, 6.0), (14.0, 194.0, 6.0), (8.0, 184.0, 6.0), (3.0, 188.0, 5.0),
        # a static body and a trigger overlapping dynamic ones
        (100.0, 100.0, 8.0), (110.0, 104.0, 6.0), (104.0, 110.0, 6.0),
        # exactly coincident pair
        (200.0, 60.0, 5.0), (200.0, 60.0, 5.0),
        # six entities in one 30-unit cell of capacity 4
        (245.0, 155.0, 4.0), (250.0, 158.0, 4.0), (255.0, 152.0, 4.0),
        (248.0, 162.0, 4.0), (252.0, 150.0, 4.0), (258.0, 160.0, 4.0),
        # moving entities past each border, two of them overlapping
        (-4.0, 80.0, 5.0), (2.0, 84.0, 5.0), (303.0, 40.0, 6.0),
        (150.0, -2.0, 4.0), (170.0, 205.0, 7.0),
    ]
    n = len(pts)
    w = make_world(n, device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    static = torch.zeros(n, dtype=torch.bool, device=device)
    static[4] = True
    trig = torch.zeros(n, dtype=torch.bool, device=device)
    trig[5] = True
    on = torch.ones(n, dtype=torch.bool, device=device)
    w = w.replace(
        transform=w.transform.replace(active=on, x=f32([p[0] for p in pts]),
                                      y=f32([p[1] for p in pts])),
        rigid_body=w.rigid_body.replace(active=on, static=static),
        collider=w.collider.replace(active=on, is_trigger=trig,
                                    radius=f32([p[2] for p in pts])),
    )
    lay = build_layout(w, GridGeom(cell_size=30.0, rows=7, cols=10, capacity=4))
    check(int((~lay.in_grid).sum().item()) == 2, "synthetic layout: expected 2 over capacity")
    args = (lay.scatter(w.transform.x), lay.scatter(w.transform.y),
            lay.radius, lay.meta, 17, 0.8)
    return args, (lay.flat[7].item(), lay.flat[8].item())  # the coincident pair


def dense_world(device, n, world, seed):
    """``n`` entities placed at random (numpy, ``seed``) in ``world`` and up
    to one cell beyond it on every side: a tenth static, a tenth triggers,
    and one in twenty with its collider off (an occupied slot that holds
    no collider)."""
    import numpy as np
    import torch

    from multithreadedgameengine_tpu_torch.state import make_world

    rng = np.random.default_rng(seed)
    w = make_world(n, device)

    def t(v, dtype=torch.float32):
        return torch.as_tensor(v, dtype=dtype, device=device)

    on = t(np.ones(n, bool), torch.bool)
    return w.replace(
        transform=w.transform.replace(active=on, x=t(rng.uniform(-30, world[0] + 30, n)),
                                      y=t(rng.uniform(-30, world[1] + 30, n))),
        rigid_body=w.rigid_body.replace(active=on, static=t(rng.random(n) < 0.1, torch.bool)),
        collider=w.collider.replace(active=t(rng.random(n) > 0.05, torch.bool),
                                    is_trigger=t(rng.random(n) < 0.1, torch.bool),
                                    radius=t(rng.uniform(3, 12, n))),
    )


#: the dense cases: (name, world, capacity, entities); every cell of the
#: 30-unit grid gets about 5 (capacity 4) or 2 (capacity 64) times its
#: capacity, so all are full
DENSE_CASES = (("full_cap4", (240.0, 150.0), 4, 1400), ("full_cap64", (150.0, 120.0), 64, 5400))


def dense_layout_args(device, world, cap, n):
    """K1's and K2's input on a layout where every cell is full."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout
    from multithreadedgameengine_tpu_torch.ops.spatial import GridGeom

    w = dense_world(device, n, world, seed=cap)
    lay = build_layout(w, GridGeom(cell_size=30.0, rows=int(world[1] // 30),
                                   cols=int(world[0] // 30), capacity=cap))
    check(bool(((lay.meta != 0).sum(0)[1:-1, 1:-1] == cap).all().item()),
          f"dense layout {cap}: a cell is not full")
    return (lay.scatter(w.transform.x), lay.scatter(w.transform.y), lay.radius, lay.meta,
            cap, 0.8)


def dense_grid_args(device, world, cap, n):
    """K3's input on a bordered grid where every cell, border rows
    included, is full."""
    w = dense_world(device, n, world, seed=cap)
    args = bordered_grid_args(w, 30.0, int(world[1] // 30), int(world[0] // 30), cap)
    check(bool(((args[2][..., 2] != -1).sum(-1)[:, 1:-1] == cap).all().item()),
          f"dense grid {cap}: a cell is not full")
    return args


def grid_bound(args, contacts: int):
    """The least time the card could take for one K3 pass over this grid,
    in ms, and what bounds it: the bytes the function must move (the flags
    read and dx, dy and count written for every slot, 16 bytes; x, y,
    radius and gid read only for the slots holding a collider, 16 bytes
    each, since every other slot takes part in no pair) over the HBM rate,
    against the float32 operations this data needs (8 per candidate pair of
    the 3x3 neighbourhood, border rows included, and 16 more per contact
    from each side, as in :func:`bound`) over the non-tensor-core rate."""
    import torch

    x, attrs = args[0], args[2]
    coll = (attrs[..., 1].to(torch.int32) & 1) == 1
    n_bytes = 16 * x.numel() + 16 * int(coll.sum().item())
    occ = coll.sum(-1).to(torch.float64)
    nb = torch.nn.functional.avg_pool2d(occ[None, None], 3, stride=1, padding=1,
                                        divisor_override=1)[0, 0]
    pairs = float((occ * (nb - 1))[1:-1, 1:-1].sum().item())
    n_ops = 8 * pairs + 16 * contacts
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_grid_args(device):
    """A hand-made bordered grid [R+2, C+2, cap] (world 300 x 180, cell 30,
    capacity 4) binned as the halo step bins: entities in both border rows
    overlapping interior ones across the seam, a static body and a trigger
    in a pile, an exactly coincident pair, and six entities in one cell (a
    full cell; two are left out)."""
    import torch

    from multithreadedgameengine_tpu_torch.state import make_world

    pts = [
        # across the top seam (border row 0 holds y in [-30, 0))
        (50.0, 3.0, 6.0), (52.0, -6.0, 6.0), (120.0, -2.0, 5.0), (124.0, 5.0, 5.0),
        # across the bottom seam (border row R+1 holds y in [180, 210))
        (200.0, 176.0, 6.0), (203.0, 186.0, 6.0),
        # a static body and a trigger overlapping dynamic ones
        (100.0, 100.0, 8.0), (110.0, 104.0, 6.0), (104.0, 110.0, 6.0),
        # exactly coincident pair
        (200.0, 60.0, 5.0), (200.0, 60.0, 5.0),
        # six entities in one cell of capacity 4
        (245.0, 125.0, 4.0), (250.0, 128.0, 4.0), (255.0, 122.0, 4.0),
        (248.0, 132.0, 4.0), (252.0, 120.0, 4.0), (258.0, 130.0, 4.0),
    ]
    n = len(pts)
    w = make_world(n, device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    static = torch.zeros(n, dtype=torch.bool, device=device)
    static[6] = True
    trig = torch.zeros(n, dtype=torch.bool, device=device)
    trig[7] = True
    on = torch.ones(n, dtype=torch.bool, device=device)
    w = w.replace(
        transform=w.transform.replace(active=on, x=f32([p[0] for p in pts]),
                                      y=f32([p[1] for p in pts])),
        rigid_body=w.rigid_body.replace(active=on, static=static),
        collider=w.collider.replace(active=on, is_trigger=trig,
                                    radius=f32([p[2] for p in pts])),
    )
    args = bordered_grid_args(w, 30.0, 6, 10, 4)
    check(int((args[2][..., 2] != -1).sum().item()) == n - 2,
          "synthetic grid: expected 2 over capacity")
    return args


def bordered_grid_args(w, cell, R, C, cap):
    """K3's input from a world's active entities: binned as the halo step
    bins (cell rank by id), into rows 0 .. R+1 of a bordered grid [R+2,
    C+2, cap], border rows included; entities past capacity are left out."""
    import torch

    from multithreadedgameengine_tpu_torch.ops.physics_grid import (
        pack_solver_rows,
        scatter_solver_grid,
    )
    from multithreadedgameengine_tpu_torch.ops.spatial import GridGeom, bin_entities

    x, y, on = w.transform.x, w.transform.y, w.transform.active
    row = torch.clamp(torch.floor(y / cell).to(torch.int32) + 1, 0, R + 1)
    col = torch.clamp((x / cell).to(torch.int32), 0, C - 1)
    bins = bin_entities(x, y, on, GridGeom(cell_size=cell, rows=R + 2, cols=C, capacity=cap),
                        build_table=False, row=row, col=col)
    ok = on & (bins.rank < cap)
    flat = (bins.row.long() * (C + 2) + bins.col.long() + 1) * cap + bins.rank.long()
    grid = scatter_solver_grid(pack_solver_rows(w), torch.where(ok, flat, (R + 2) * (C + 2) * cap),
                               R, C, cap)
    return (grid[..., 0].contiguous(), grid[..., 1].contiguous(),
            grid[..., 4:7].contiguous(), 17, 0.8)


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


def zero_counts():
    ck = kernels()
    ck.pair_pass_resident.launches = 0
    ck.pair_pass_symmetric.launches = 0
    ck.pair_pass_grid.launches = 0
    ck.expand.launches = 0
    ck.boid_tick.launches = 0


def read_counts():
    ck = kernels()
    return (ck.pair_pass_resident.launches, ck.pair_pass_symmetric.launches,
            ck.pair_pass_grid.launches)


def finite(w) -> bool:
    import torch

    return bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all().item())


def halo_balls_engine(dev):
    """The halo scaling benchmark's balls scene (``benchmarks/
    halo_scaling.py:104-110``): ``HALO_N - 1`` balls and the mouse in
    ``HALO_WORLD``, seed 123456, queued spawns flushed."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=HALO_N - 1, seed=SEED, device=dev,
                            world_width=HALO_WORLD[0], world_height=HALO_WORLD[1])
    eng._flush_pending()
    return eng


def chunk_digests(chunks, gids=None):
    """Each chunk world's leaf digests (``dryrun.leaf_digests``), with its
    gid tensor's under the homed step: what a rank of the process mesh
    reports for its slab."""
    from multithreadedgameengine_tpu_torch.dryrun import leaf_digests, tensor_digest

    if gids is None:
        return [leaf_digests(c) for c in chunks]
    return [dict(leaf_digests(c), gids=tensor_digest(g)) for c, g in zip(chunks, gids)]


def halo_phase(dev, inproc):
    """Phase 6, slice E1's main path: K3 parity on a synthetic grid, the 1M
    halo rung on 4 slabs (launch counts, overflow, K3 parity and timing
    on one slab grid), and the 100k halo-against-single-device check.
    Returns K3's launches on the rung, its times, bound, slab shape and
    parity errors; the rung's chunk digests go into ``inproc``."""
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn

    ck = kernels()
    k3, k3_plain = ck.pair_pass_grid, ck.pair_pass_grid_plain
    # (a) K3 against its plain version on a grid with occupied border rows
    err, (_x, _y, kc) = kernel_vs_plain(k3, k3_plain, "synthetic_grid",
                                        synthetic_grid_args(dev), None)
    errs = [err]
    check(int(kc[1].sum().item() + kc[-2].sum().item()) > 0,
          "K3: no contact next to a border row of the synthetic grid")
    for name, world, cap, n in DENSE_CASES:
        errs.append(kernel_vs_plain(k3, k3_plain, name, dense_grid_args(dev, world, cap, n),
                                    None)[0])

    # (b) the 1M halo rung: 4 slabs on one card
    halo_eng = halo_balls_engine(dev)
    mesh = make_mesh(HALO_SLABS, dev)
    step, place = make_halo_step(halo_eng, mesh, oversub=4.0)
    hplan = step.plan
    subs = hplan.cfg.physics.sub_step_count
    chunks = place(halo_eng.world)
    ins = halo_eng.input.snapshot(dev)
    zero_counts()
    for _ in range(HALO_WARMUP):
        chunks, hm = step(chunks, ins)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HALO_FRAMES):
        chunks, hm = step(chunks, ins)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1_h, k2_h, k3_h = read_counts()
    frames_h = HALO_WARMUP + HALO_FRAMES
    expected_k3 = frames_h * subs * HALO_SLABS
    ok = all(finite(c) for c in chunks)
    overflow_h = int(hm["route_overflow_solver"].item())
    log("halo_1m_d4", entities=HALO_N, slabs=HALO_SLABS, frames=frames_h,
        steps_per_s=HALO_FRAMES / dt, k3_launches=k3_h, expected_k3=expected_k3,
        k1_launches=k1_h, k2_launches=k2_h, solver_geom=hplan.solver_geom,
        slab_grid=[hplan.slab_geom.rows + 2, hplan.slab_geom.cols + 2,
                   hplan.slab_geom.capacity],
        route_cap=hplan.route_cap, route_overflow_solver=overflow_h,
        solver_binned=int(hm["solver_binned"].item()),
        nonfinite=int(hm["nonfinite_count"].item()), finite=ok,
        mean_contacts=torch.cat([c.rigid_body.collision_count for c in chunks])[1:]
        .float().mean().item())
    check(ok and int(hm["nonfinite_count"].item()) == 0, "non-finite positions on the halo rung")
    check(k3_h == expected_k3 and k1_h == 0 and k2_h == 0,
          f"halo: K3 launched {k3_h} (expected {expected_k3}), K1 {k1_h}, K2 {k2_h}")
    check(chunks[0].step_count == frames_h, "halo: step_count")
    inproc["halo_1m_d4"] = dict(digests=chunk_digests(chunks), steps_per_s=HALO_FRAMES / dt,
                                frames=frames_h)
    slab_args = slab_grid_args(step, chunks, mesh)
    err, (_x, _y, kc) = kernel_vs_plain(k3, k3_plain, "halo_1m_slab1", slab_args, None)
    errs.append(err)
    contacts_slab = int(kc.sum().item())
    slab_shape = list(slab_args[0].shape)
    k3_ms, k3_plain_ms = time_kernel(k3, k3_plain, slab_args, kernel_reps=50, plain_reps=2)
    bound_k3 = grid_bound(slab_args, contacts_slab)
    log("timing", grid="halo_1m_slab1", shape=slab_shape, k3_ms=k3_ms,
        k3_plain_ms=k3_plain_ms, bound_ms=bound_k3[0], bound_by=bound_k3[1],
        border_row_contacts=int(kc[1].sum().item() + kc[-2].sum().item()))
    del halo_eng, chunks, slab_args, kc

    # (c) the halo step against the single-device step, bit for bit
    scene_c = dict(n_balls=CHECK_N - 1, seed=SEED, device=dev, world_width=CHECK_WORLD[0],
                   world_height=CHECK_WORLD[1])
    eh, es = make_balls_engine(**scene_c), make_balls_engine(**scene_c)
    for e in (eh, es):  # both plans see the spawned radii (same solver grid)
        e._flush_pending()
    mesh_c = make_mesh(HALO_SLABS, dev)
    step_c, place_c = make_halo_step(eh, mesh_c, oversub=float(HALO_SLABS))
    chunks_c = place_c(eh.world)
    zero_counts()
    for _ in range(10):
        chunks_c, mc = step_c(chunks_c, eh.input.snapshot(dev))
    k3_c = read_counts()[2]
    zero_counts()
    es.step(10, block=True)
    k1_c, k2_c, _k3 = read_counts()
    check(es._plan.solver_geom == step_c.plan.solver_geom,
          f"100k: geometries differ: {es._plan.solver_geom} vs {step_c.plan.solver_geom}")
    a, b = unplace_fn(chunks_c, mesh_c), es.world
    same = {f: bool(torch.equal(getattr(c(a), f), getattr(c(b), f)))
            for c, f in ((lambda s: s.transform, "x"), (lambda s: s.transform, "y"),
                         (lambda s: s.rigid_body, "px"), (lambda s: s.rigid_body, "py"),
                         (lambda s: s.rigid_body, "collision_count"))}
    log("halo_vs_single_100k", slabs=HALO_SLABS, frames=10, k3_launches=k3_c,
        k1_launches_single=k1_c, k2_launches_single=k2_c, bit_equal=same,
        route_overflow_solver=int(mc["route_overflow_solver"].item()),
        contacts=int(a.rigid_body.collision_count.sum().item()))
    check(all(same.values()), f"100k: the halo step and Engine.step differ: {same}")
    check(k3_c == 10 * subs * HALO_SLABS and k1_c == 10 * subs and k2_c == 0,
          f"100k: K3 {k3_c}, K1 {k1_c}, K2 {k2_c} launches")
    del eh, es, chunks_c, a, b

    # (d) K3 on a slab grid of the 10k demo scene
    small = halo_slab_args(dev, dict(n_balls=N_MAIN - 1, seed=SEED))
    err, (_x, _y, kc) = kernel_vs_plain(k3, k3_plain, "halo_10k_slab1", small, None)
    errs.append(err)
    k3_ms_10k, k3_plain_10k = time_kernel(k3, k3_plain, small)
    bound_10k = grid_bound(small, int(kc.sum().item()))
    log("timing", grid="halo_10k_slab1", shape=list(small[0].shape), k3_ms=k3_ms_10k,
        k3_plain_ms=k3_plain_10k, bound_ms=bound_10k[0], bound_by=bound_10k[1])
    return dict(launches=k3_h, steps_per_s=HALO_FRAMES / dt, ms=k3_ms, plain_ms=k3_plain_ms,
                bound=bound_k3,
                shape=slab_shape, errs=errs, shape_10k=list(small[0].shape), ms_10k=k3_ms_10k,
                plain_ms_10k=k3_plain_10k, bound_ms_10k=bound_10k[0])


def halo_slab_args(dev, scene, frames=3):
    """K3's input on slab 1 after ``frames`` frames of a balls scene on
    ``HALO_SLABS`` slabs (``oversub`` 4)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh

    eng = make_balls_engine(device=dev, **scene)
    eng._flush_pending()
    mesh = make_mesh(HALO_SLABS, dev)
    step, place = make_halo_step(eng, mesh, oversub=4.0)
    chunks = place(eng.world)
    for _ in range(frames):
        chunks, _m = step(chunks, eng.input.snapshot(dev))
    return slab_grid_args(step, chunks, mesh)


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


def neighbor_lists_of(w, cfg):
    """The neighbour lists a frame of ``w`` builds (the boids' payload)."""
    from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

    t = w.transform
    extras = (w.rigid_body.vx, w.rigid_body.vy, t.entity_type)
    return neighbor_lists(t.x, t.y, t.active, w.collider.visual_range, cfg, extras)


#: boids on the card against the CPU: positions within this many float32
#: ulps at the world's extent. The frames sum each boid's neighbour terms
#: with torch.sum, whose order on the card differs from the CPU's, so the
#: accelerations differ in their last bits and positions by an ulp or so a
#: frame; integer state is exact.
BOIDS_REF_ULPS = 8


def boids_phase(dev, errs):
    """Slice C1's main path (BASELINE config 3), K1 against its plain
    version on that run's layout and timed there, then the 400-boid scene
    on the card against the CPU. Returns K1's launches on the main path and
    its times on the boids layout."""
    import numpy as np

    eng = boids_engine(dev, BOIDS_N, BOIDS_WORLD, CONFIG3_SPATIAL)
    ck = kernels()
    zero_counts()
    eng.step(BOIDS_WARMUP, block=True)
    t0 = time.perf_counter()
    eng.step(BOIDS_FRAMES)
    eng.sync()
    dt = time.perf_counter() - t0
    k1, k2, k3 = read_counts()
    k4, ticks = ck.expand.launches, ck.boid_tick.launches
    frames = BOIDS_WARMUP + BOIDS_FRAMES
    w, m, cfg = eng.world, eng.metrics, eng.config
    nbr = neighbor_lists_of(w, cfg)
    ok = finite(w)
    n_binned = int(m["n_binned"].item())
    overflow = int(m["solver_overflow"].item())
    log("boids_15k", boids=BOIDS_N, frames=frames, steps_per_s=BOIDS_FRAMES / dt,
        k1_launches=k1, expected_k1=frames * cfg.physics.sub_step_count, k2_launches=k2,
        k3_launches=k3, k4_launches=k4, boid_tick_launches=ticks, n_binned=n_binned,
        solver_overflow=overflow,
        scan_radius=cfg.spatial.max_cell_radius, slots=list(nbr.ids.shape),
        payload=list(nbr.payload.data.shape), symmetric=eng._plan.symmetric,
        layout=list(layout_args(eng)[0].shape),
        mean_neighbors=nbr.count[1:].float().mean().item(),
        max_neighbors=int(nbr.count.max().item()),
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok and int(m["nonfinite_count"].item()) == 0, "boids_15k: non-finite positions")
    check(w.step_count == frames, "boids_15k: step_count")
    check(k1 == frames * cfg.physics.sub_step_count and k2 == 0 and k3 == 0 and k4 == 0,
          f"boids_15k: K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} launches; expected {frames}, 0, 0, 0")
    check(ticks == frames, f"boids_15k: the boid tick launched {ticks} times, not {frames}")
    check(n_binned in (BOIDS_N, BOIDS_N + 1), f"boids_15k: n_binned {n_binned}")
    kern, plain = ck.pair_pass_resident, ck.pair_pass_resident_plain
    args = layout_args(eng)
    err, (_x, _y, kc) = kernel_vs_plain(kern, plain, "boids_15k", args, max(BOIDS_WORLD))
    errs["K1"].append(err)
    k1_ms, k1_plain_ms = time_kernel(kern, plain, args)
    b = bound(args, int(kc.sum().item()), False)
    log("timing", layout="boids_15k", shape=list(args[0].shape), k1_ms=k1_ms,
        k1_plain_ms=k1_plain_ms, bound_ms=b[0], bound_by=b[1])
    timing = dict(shape_boids=list(args[0].shape), ms_boids=k1_ms,
                  plain_ms_boids=k1_plain_ms, bound_ms_boids=b[0])
    del eng, nbr, w, args

    # reference on a small input: the config-3 knobs, 400 boids in 1200 x
    # 800, on the card and on the CPU
    runs = {}
    for d in (dev, "cpu"):
        e = boids_engine(d, 400, (1200.0, 800.0), CONFIG3_SPATIAL)
        e.step(5)
        runs[str(d)] = (e.snapshot(), e.config)
    (a, cfg), (b, _cfg) = runs[str(dev)], runs["cpu"]
    err = max((a.transform.x - b.transform.x).abs().max().item(),
              (a.transform.y - b.transform.y).abs().max().item())
    contacts_bad = int((a.rigid_body.collision_count != b.rigid_body.collision_count).sum())
    # the lists of one world, built on the card and on the CPU
    lc = neighbor_lists_of(b.map_tensors(lambda v: v.to(dev)), cfg)
    lh = neighbor_lists_of(b, cfg)
    ids_bad = int((lc.ids.cpu() != lh.ids).sum())
    count_bad = int((lc.count.cpu() != lh.count).sum())
    d2_err = (lc.d2.cpu() - lh.d2).abs().max().item()
    tol = BOIDS_REF_ULPS * float(np.spacing(np.float32(1200.0)))
    log("boids_reference", boids=400, frames=5, max_abs_err_vs_cpu=err, tol=tol,
        contact_mismatch=contacts_bad, ids_mismatch=ids_bad, count_mismatch=count_bad,
        d2_max_abs_err=d2_err, mean_neighbors=lh.count[1:].float().mean().item())
    check(ids_bad == 0 and count_bad == 0 and d2_err == 0.0,
          "boids_reference: the card's neighbour lists differ from the CPU's")
    check(err <= tol, f"boids_reference: positions differ by {err} (tol {tol})")
    check(contacts_bad == 0, "boids_reference: contact counts differ")
    return k1, timing


def captured_tick_args(eng):
    """The arguments ``Boid.tick`` hands ``boid_tick`` in the next frame of
    ``eng`` (that frame is run)."""
    from multithreadedgameengine_tpu_torch.models import boids

    seen, real = [], boids.boid_tick

    def capture(*args):
        seen.append(args)
        return real(*args)

    boids.boid_tick = capture
    try:
        eng.step(1)
    finally:
        boids.boid_tick = real
    return seen[0]


def boid_tick_bounds(args):
    """The least time the card could take for one boid tick, in ms: the
    bytes it must move over the HBM rate, (a) reading every slot's id and,
    for the live slots alone, d2 and the neighbour's five channels (24 B),
    (b) reading every slot's id, d2 and whole 24-byte payload record; both
    with 13 fields of each row read and 2 written. Operations (about 20 a
    live slot) are far below either. Returns (live, full, live share)."""
    ids = args[0]
    n, s = ids.shape
    live = int((ids >= 0).sum().item())
    rows = (13 + 2) * 4 * n
    return ((4 * n * s + 24 * live + rows) / PEAK_BYTES_S * 1e3,
            ((4 + 4 + 24) * n * s + rows) / PEAK_BYTES_S * 1e3, live / (n * s))


def boid_tick_phase(dev):
    """The boid tick at the boids benchmark cell's scene: 102,400 boids and
    the mouse held in 13,064 x 5,226 (config 3's density), ``CELL_BOIDS_FRAMES``
    frames through ``Engine.step`` (one launch a frame), then the kernel on
    the next frame's own arguments against its plain version (within the
    sums' order, ``tests/test_torch_boid_tick.py``'s tolerance) and timed
    there beside its plain version and its two bounds, and on the same
    lists gathered into contiguous columns. Returns the timing fields."""
    import importlib.util
    from pathlib import Path

    import torch

    # the tolerance of tests/test_torch_boid_tick.py, loaded from its file
    path = Path(__file__).resolve().parent / "tests" / "test_torch_boid_tick.py"
    spec = importlib.util.spec_from_file_location("test_torch_boid_tick", path)
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)

    ck = kernels()
    eng = boids_engine(dev, CELL_BOIDS_N, CELL_BOIDS_WORLD, CONFIG3_SPATIAL)
    eng.input.set_mouse(CELL_BOIDS_WORLD[0] / 2, CELL_BOIDS_WORLD[1] / 2)
    eng.input.mouse_button(0, True)
    zero_counts()
    eng.step(CELL_BOIDS_FRAMES, block=True)
    ticks = ck.boid_tick.launches
    check(ticks == CELL_BOIDS_FRAMES,
          f"boid_tick_102k: {ticks} launches in {CELL_BOIDS_FRAMES} frames")
    args = captured_tick_args(eng)
    out = {}
    for form in ("payload", "gathered"):
        a = args if form == "payload" else (args[0], args[1], [c.contiguous() for c in args[2]],
                                            *args[3:])
        kx, ky = ck.boid_tick(*a)
        px, py = ck.boid_tick_plain(*a)
        torch.cuda.synchronize()
        tx, ty = tests.order_tolerance(a)
        err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
        within = bool(((kx.double() - px.double()).abs() <= tx).all().item()
                      and ((ky.double() - py.double()).abs() <= ty).all().item())
        check(within, f"boid_tick_102k ({form}): the kernel differs from its plain version "
                      f"beyond the sums' order ({err})")
        ms, plain_ms = time_kernel(ck.boid_tick, ck.boid_tick_plain, a, kernel_reps=50,
                                   plain_reps=3)
        out[form] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
    live_ms, full_ms, fill = boid_tick_bounds(args)
    log("boid_tick_102k", boids=CELL_BOIDS_N, frames=CELL_BOIDS_FRAMES, launches=ticks,
        slots=list(args[0].shape), payload_stride=list(args[2][0].stride()), live_share=fill,
        ms=out["payload"]["ms"], plain_ms=out["payload"]["plain_ms"],
        gathered_ms=out["gathered"]["ms"], bound_live_ms=live_ms, bound_full_ms=full_ms,
        live_roofline=live_ms / out["payload"]["ms"], max_abs_err=out["payload"]["max_abs_err"],
        gathered_max_abs_err=out["gathered"]["max_abs_err"])
    return dict(ms=out["payload"]["ms"], plain_ms=out["payload"]["plain_ms"],
                gathered_ms=out["gathered"]["ms"], bound=(live_ms, "bytes"),
                bound_full_ms=full_ms, live_share=fill, shape=list(args[0].shape),
                max_abs_err=max(o["max_abs_err"] for o in out.values()))


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


def stamp_loop_ms(eng, reps=20):
    """ms of one ``stamp_decals`` call (the 64 sequential stamps) on the
    stamp batch this moment's pool gives, eager between two CUDA events:
    the work does not depend on how many stamps are valid."""
    import torch

    from multithreadedgameengine_tpu_torch.ops.decals import stamp_decals
    from multithreadedgameengine_tpu_torch.ops.particles import update_particles

    w, cfg = eng.world, eng.config
    _pool, stamps, _n = update_particles(w.particles, cfg, cfg.dt_ratio, True)
    tex = eng._plan.decal_textures

    def run():
        for _ in range(reps):
            stamp_decals(w.decal_canvas, w.decal_dirty, stamps, tex, cfg)

    run()
    torch.cuda.synchronize()
    return statistics.median([events_ms(run, reps) for _ in range(3)]), int(stamps.valid.sum())


def predators_phase(dev, errs):
    """Slice C2's main path (BASELINE config 4), the blood burst, the stamp
    loop alone, K1 against its plain version on the scene's layout, and 400
    prey on the card against the CPU. Returns K1's launches on the main path
    and its times on the predators layout."""
    from multithreadedgameengine_tpu_torch.ops.spatial import CELLMAJOR_BUDGET_BYTES

    ck = kernels()
    t0 = time.perf_counter()
    eng = predators_engine(dev)
    eng._flush_pending()
    build_s = time.perf_counter() - t0
    zero_counts()
    eng.step(PRED_WARMUP, block=True)
    t0 = time.perf_counter()
    eng.step(PRED_FRAMES)
    eng.sync()
    dt = time.perf_counter() - t0
    k1, k2, k3 = read_counts()
    k4 = ck.expand.launches
    frames = PRED_WARMUP + PRED_FRAMES
    w, m, cfg, plan = eng.world, eng.metrics, eng.config, eng._plan
    subs = cfg.physics.sub_step_count
    sp, lc = cfg.spatial, cfg.lighting
    n_lights = eng.classes["TallLight"].count
    slots = (2 * sp.max_cell_radius + 1) ** 2 * sp.cell_capacity
    channels = 3 + len(plan.extra_paths)
    cellmajor = (cfg.total_cells + 1) * slots * channels * 4 <= CELLMAJOR_BUDGET_BYTES
    ok = finite(w)
    n_binned, active = int(m["n_binned"].item()), int(m["active_count"].item())
    overflow = int(m["solver_overflow"].item())
    shadows = int(w.shadow_sprites.active.sum().item())
    log("predators_15k", card=repr(card_name_and_limit()), entities=w.n_entities,
        frames=frames, steps_per_s=PRED_FRAMES / dt, build_s=build_s, k1_launches=k1,
        expected_k1=frames * subs, k2_launches=k2, k3_launches=k3, k4_launches=k4,
        n_binned=n_binned, active_count=active, solver_overflow=overflow,
        shadow_sprites=shadows, shadow_cap=n_lights * lc.max_shadows_per_light,
        scan_radius=sp.max_cell_radius, slots=slots, payload_channels=channels,
        assembly="cell-major" if cellmajor else "per-entity gather",
        rows_mb=w.n_entities * slots * channels * 4 / 1e6, symmetric=plan.symmetric,
        layout=list(layout_args(eng)[0].shape), solver_geom=plan.solver_geom,
        active_particles=int(m["active_particles"].item()),
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok and int(m["nonfinite_count"].item()) == 0, "predators_15k: non-finite positions")
    check(w.step_count == frames, "predators_15k: step_count")
    check(k1 == frames * subs and k2 == 0 and k3 == 0 and k4 == 0,
          f"predators_15k: K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} launches; expected {frames}, 0, 0, 0")
    check(overflow == 0, f"predators_15k: solver_overflow {overflow}")
    check(n_binned == active, f"predators_15k: n_binned {n_binned} of {active} active")
    check(0 < shadows <= n_lights * lc.max_shadows_per_light,
          f"predators_15k: {shadows} shadow sprites")

    # the blood burst: live particles fall as they land, the canvas and
    # the dirty tiles change
    canvas0 = w.decal_canvas.clone()
    queued = blood_burst(eng)
    zero_counts()
    live = []
    for i in range(PRED_BLOOD_FRAMES):
        bm = eng.step(1)
        if i % 10 == 0 or i == PRED_BLOOD_FRAMES - 1:
            live.append(int(bm["active_particles"].item()))
    k1_blood = read_counts()[0]
    w = eng.world
    changed = int((w.decal_canvas != canvas0).any(-1).sum().item())
    tiles = int(w.decal_dirty.sum().item())
    log("predators_blood", queued=queued, frames=PRED_BLOOD_FRAMES,
        active_particles_every_10=",".join(map(str, live)), canvas_px_changed=changed,
        dirty_tiles=tiles, k1_launches=k1_blood)
    check(live[0] > 0 and live[-1] < live[0] and all(b <= a for a, b in zip(live, live[1:])),
          f"predators_blood: live particles {live} do not fall")
    check(changed > 0 and tiles > 0, "predators_blood: no stamp reached the canvas")
    check(k1_blood == PRED_BLOOD_FRAMES * subs, f"predators_blood: K1 {k1_blood} launches")
    stamp_ms, valid = stamp_loop_ms(eng)
    frame_ms = dt / PRED_FRAMES * 1e3
    log("stamp_decals", stamps=64, valid=valid, ms=stamp_ms, frame_wall_ms=frame_ms,
        share_of_frame_wall=stamp_ms / frame_ms)

    args = layout_args(eng)
    err, (_x, _y, kc) = kernel_vs_plain(ck.pair_pass_resident, ck.pair_pass_resident_plain,
                                        "predators_15k", args, 5000.0)
    errs["K1"].append(err)
    k1_ms, k1_plain_ms = time_kernel(ck.pair_pass_resident, ck.pair_pass_resident_plain, args)
    b = bound(args, int(kc.sum().item()), False)
    log("timing", layout="predators_15k", shape=list(args[0].shape), k1_ms=k1_ms,
        k1_plain_ms=k1_plain_ms, bound_ms=b[0], bound_by=b[1])
    timing = dict(shape_predators=list(args[0].shape), ms_predators=k1_ms,
                  plain_ms_predators=k1_plain_ms, bound_ms_predators=b[0],
                  stamp_decals_ms=stamp_ms)
    del eng, w, args, canvas0

    predators_reference(dev)
    return k1, timing


#: the predators scene on the card against the CPU: positions (and the
#: active shadow sprites' floats, at each field's largest magnitude) within
#: this many float32 ulps. The ticks' sums over the neighbour slots run in
#: another order on the card, as in ``[boids_reference]``; atan2 is not
#: correctly rounded on either. Integer state exact; canvas bytes within 1.
PRED_REF_ULPS = 8


def predators_reference(dev):
    """400 prey, 8 predators and 5 lights in 1600 x 1000 on the card and on
    the CPU, with the blood and a landing burst, for 6 frames."""
    import numpy as np

    snaps = {}
    for d in (dev, "cpu"):
        e = predators_engine(d, **PRED_REF)
        e.step(1)
        blood_burst(e)
        landing_burst(e)
        e.step(PRED_REF_FRAMES - 1)
        snaps[str(d)] = e.snapshot()
    a, b = snaps[str(dev)], snaps["cpu"]
    exact = {
        "active": (a.transform.active, b.transform.active),
        "contacts": (a.rigid_body.collision_count, b.rigid_body.collision_count),
        "animation_state": (a.sprite.animation_state, b.sprite.animation_state),
        "animation_frame": (a.sprite.animation_frame, b.sprite.animation_frame),
        "render_dirty": (a.sprite.render_dirty, b.sprite.render_dirty),
        "particles_active": (a.particles.active, b.particles.active),
        "decal_dirty": (a.decal_dirty, b.decal_dirty),
        "shadow_active": (a.shadow_sprites.active, b.shadow_sprites.active),
    }
    bad = {k: int((u != v).sum().item()) for k, (u, v) in exact.items()}
    pos_tol = PRED_REF_ULPS * float(np.spacing(np.float32(1600.0)))
    pos_err = max((a.transform.x - b.transform.x).abs().max().item(),
                  (a.transform.y - b.transform.y).abs().max().item())
    p_err = max((getattr(a.particles, f) - getattr(b.particles, f)).abs().max().item()
                for f in ("x", "y", "z"))
    canvas = (a.decal_canvas.int() - b.decal_canvas.int()).abs()
    on = b.shadow_sprites.active
    sh_ulps = {}
    for f in ("x", "y", "rotation", "scale_x", "scale_y", "alpha"):
        u, v = getattr(a.shadow_sprites, f)[on], getattr(b.shadow_sprites, f)[on]
        scale = max(v.abs().max().item(), 1e-30) if v.numel() else 1.0
        sh_ulps[f] = ((u - v).abs().max().item() / float(np.spacing(np.float32(scale)))
                      if v.numel() else 0.0)
    log("predators_reference", prey=PRED_REF["n_prey"], frames=PRED_REF_FRAMES,
        mismatches=json.dumps(bad).replace(" ", ""), max_abs_err_vs_cpu=pos_err, tol=pos_tol,
        particle_max_abs_err=p_err, canvas_max_byte_diff=int(canvas.max().item()),
        canvas_bytes_differing=int((canvas > 0).sum().item()),
        stamped_px=int((b.decal_canvas[..., 3] > 0).sum().item()), shadows=int(on.sum().item()),
        shadow_ulps=json.dumps(sh_ulps).replace(" ", ""),
        live_particles=int(b.particles.active.sum().item()),
        contacts=int(b.rigid_body.collision_count.sum().item()))
    check(not any(bad.values()), f"predators_reference: integer state differs: {bad}")
    check(pos_err <= pos_tol and p_err <= pos_tol,
          f"predators_reference: positions differ by {pos_err}, particles by {p_err}")
    check(int(canvas.max().item()) <= 1, "predators_reference: canvas bytes differ by more than 1")
    check(all(v <= PRED_REF_ULPS for v in sh_ulps.values()),
          f"predators_reference: shadow sprites differ: {sh_ulps}")
    check(bool((b.decal_canvas[..., 3] > 0).any()) and int(on.sum().item()) > 0,
          "predators_reference: nothing stamped or no shadow cast")


def no_host_reads(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits for the card inside it raises."""
    import torch

    def wrapped(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return wrapped


def event_recorders(eng):
    """Count the rows each kind of collision event dispatched and the blood
    particles the hooks queued, by wrapping the engine's dispatch and its
    emitter. Returns the running totals."""
    totals = {"enter": 0, "stay": 0, "exit": 0, "blood": 0}
    fire, emit = eng._fire_collision_tables, eng.emitter.emit_batch

    def counted_fire(ctx, enters, stays, exits):
        for key, table in (("enter", enters), ("stay", stays), ("exit", exits)):
            totals[key] += len(table)
        return fire(ctx, enters, stays, exits)

    def counted_emit(**kw):
        n = emit(**kw)
        totals["blood"] += n
        return n

    eng._fire_collision_tables, eng.emitter.emit_batch = counted_fire, counted_emit
    return totals


def predators_events_phase(dev):
    """Slice C3's main path: BASELINE config 4 with events on, as
    ``rung_predators`` runs it. Returns K1's launches over the run."""
    import torch

    from multithreadedgameengine_tpu_torch.engine import _EventLog

    eng = predators_engine(dev, logic=EVENTS_LOGIC)
    eng._flush_pending()
    canvas0 = eng.world.decal_canvas.clone()
    totals = event_recorders(eng)
    zero_counts()
    eng.step(EV_WARMUP, block=True)
    # one chunk whose frames and log writes may not wait for the card
    eng._one_step = no_host_reads(eng._one_step)
    write = _EventLog.write
    _EventLog.write = no_host_reads(write)
    try:
        eng.step(EV_CHUNK)
    finally:
        _EventLog.write = write
        del eng._one_step
    eng.sync()
    t0 = time.perf_counter()
    for _ in range(EV_CHUNKS):
        eng.step(EV_CHUNK)
    eng.sync()
    dt = time.perf_counter() - t0
    k1, k2, k3 = read_counts()
    frames = EV_WARMUP + (1 + EV_CHUNKS) * EV_CHUNK
    w, m, cfg = eng.world, eng.metrics, eng.config
    subs = cfg.physics.sub_step_count
    ok = finite(w)
    mi = {k: int(v.item()) for k, v in m.items()}
    changed = int((w.decal_canvas != canvas0).any(-1).sum().item())
    log("predators_events", card=repr(card_name_and_limit()), entities=w.n_entities,
        frames=frames, timed_frames=EV_CHUNKS * EV_CHUNK, steps_per_s=EV_CHUNKS * EV_CHUNK / dt,
        event_chunk=cfg.logic.event_chunk, overlap=cfg.logic.event_overlap,
        enter_rows=totals["enter"], stay_rows=totals["stay"], exit_rows=totals["exit"],
        blood_queued=totals["blood"], active_particles=mi["active_particles"],
        collision_pair_count=mi["collision_pair_count"],
        collision_pairs_dropped=mi["collision_pairs_dropped"],
        event_rows_dropped=mi["event_rows_dropped"], canvas_px_changed=changed,
        k1_launches=k1, expected_k1=frames * subs, k2_launches=k2, k3_launches=k3,
        scope_hooked=eng._plan.scope_hooked, solver_overflow=mi["solver_overflow"],
        n_binned=mi["n_binned"], chunk_without_host_reads=True, finite=ok)
    check(ok and mi["nonfinite_count"] == 0, "predators_events: non-finite positions")
    check(w.step_count == frames, "predators_events: step_count")
    check(k1 == frames * subs and k2 == 0 and k3 == 0,
          f"predators_events: K1 {k1}, K2 {k2}, K3 {k3} launches; expected {frames * subs}, 0, 0")
    check(mi["solver_overflow"] == 0, f"predators_events: solver_overflow {mi['solver_overflow']}")
    check(totals["stay"] > 0 and totals["blood"] > 0,
          f"predators_events: no contact fired the blood hook ({totals})")
    check(changed > 0, "predators_events: no blood reached the canvas")
    del eng, w, canvas0
    torch.cuda.empty_cache()
    return k1


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
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = PRED_CAMERA
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


def events_reference(dev):
    """The event scene on the card against the CPU, frame by frame."""
    import numpy as np

    runs = {}
    for d in (dev, "cpu"):
        eng, calls, emits = events_scene(d, 1)
        tables = []
        for _ in range(PRED_REF_FRAMES):
            eng.step(1)
            tables.append(event_tables(eng))
        runs[str(d)] = (tables, calls, emits, eng.snapshot())
    (ta, ca, ea, a), (tb, cb, eb, b) = runs[str(dev)], runs["cpu"]
    tol = PRED_REF_ULPS * float(np.spacing(np.float32(1600.0)))
    emit_err = max([abs(u - v) for (xa, ya), (xb, yb) in zip(ea, eb)
                    for u, v in zip(xa + ya, xb + yb)] or [0.0])
    pos_err = max((a.transform.x - b.transform.x).abs().max().item(),
                  (a.transform.y - b.transform.y).abs().max().item())
    p_err = max((getattr(a.particles, f) - getattr(b.particles, f)).abs().max().item()
                for f in ("x", "y", "z"))
    canvas = (a.decal_canvas.int() - b.decal_canvas.int()).abs()
    same_tables = ta == tb
    stays = sum(len(t[2]) for t in tb)
    log("events_reference", prey=PRED_REF["n_prey"], frames=PRED_REF_FRAMES,
        tables_identical=same_tables, hook_calls_identical=ca == cb, dispatches=len(cb),
        stay_rows=stays, emits=len(eb), emit_max_abs_err=emit_err,
        particles_active_equal=bool((a.particles.active == b.particles.active).all().item()),
        live_particles=int(b.particles.active.sum().item()), max_abs_err_vs_cpu=pos_err,
        particle_max_abs_err=p_err, canvas_max_byte_diff=int(canvas.max().item()), tol=tol)
    check(same_tables and ca == cb, "events_reference: event tables or hook calls differ")
    check(stays > 0 and len(eb) > 0, "events_reference: the blood hook never fired")
    check(len(ea) == len(eb) and emit_err <= tol, f"events_reference: emissions differ by {emit_err}")
    check(bool((a.particles.active == b.particles.active).all().item()),
          "events_reference: the live particles differ")
    check(pos_err <= tol and p_err <= tol,
          f"events_reference: positions differ by {pos_err}, particles by {p_err}")
    check(int(canvas.max().item()) <= 1, "events_reference: canvas bytes differ by more than 1")


def events_chunk(dev):
    """The event scene on the card per frame, in chunks of 4, and in
    chunks of 4 with overlap: the same hook calls and emissions."""
    runs = {}
    for chunk, overlap in ((1, False), (4, False), (4, True)):
        eng, calls, emits = events_scene(dev, chunk, overlap)
        eng.step(EV_CHUNK_FRAMES)
        eng.sync()
        runs[(chunk, overlap)] = (calls, emits)
    base = runs[(1, False)]
    same = {f"chunk{c}{'_overlap' if o else ''}": v == base for (c, o), v in runs.items()}
    log("events_chunk", frames=EV_CHUNK_FRAMES, dispatches=len(base[0]), emits=len(base[1]),
        identical=json.dumps(same).replace(" ", ""))
    check(all(same.values()) and base[1], f"events_chunk: hook calls differ: {same}")


def halo_boids_phase(dev, errs, inproc):
    """The halo benchmark's boids scene on 4 slabs against Engine.step,
    then K3 against its plain version on one slab grid of that run, timed
    there. Returns K3's launches on the scene and its times.

    The single-device step runs the two-sided pass (K1), whose per-slot
    order of pushes is K3's. At this width (482 solver columns) "auto"
    would pick K2, which sums the same pushes in another order (the
    reference's drift within 1e-3, ROADMAP §3), so both engines pin
    ``solver_predicated="off"``; the halo step's K3 does not read it."""
    import torch

    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn
    from multithreadedgameengine_tpu_torch.parallel.halo import _get_comp, entity_leaf_specs

    eh, es = (boids_engine(dev, HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL,
                           solver_predicated="off") for _ in range(2))
    for e in (eh, es):
        e._flush_pending()
    mesh = make_mesh(HALO_SLABS, dev)
    step, place = make_halo_step(eh, mesh, oversub=HALO_BOIDS_OVERSUB)
    plan = step.plan
    chunks = place(eh.world)
    ins = eh.input.snapshot(dev)
    zero_counts()
    chunks, m = step(chunks, ins)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HALO_BOIDS_FRAMES - 1):
        chunks, m = step(chunks, ins)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1_h, k2_h, k3_h = read_counts()
    zero_counts()
    es.step(HALO_BOIDS_FRAMES, block=True)
    k1_s, k2_s, k3_s = read_counts()
    a, b = unplace_fn(chunks, mesh), es.world
    diff = {}
    for cname, fname, dt_ in entity_leaf_specs(a):
        u, v = getattr(_get_comp(a, cname), fname), getattr(_get_comp(b, cname), fname)
        if not torch.equal(u, v):
            diff[f"{cname}.{fname}"] = ((u.double() - v.double()).abs().max().item()
                                        if dt_ == torch.float32 else int((u != v).sum()))
    subs = plan.cfg.physics.sub_step_count
    log("halo_boids", entities=HALO_BOIDS_N, slabs=HALO_SLABS, frames=HALO_BOIDS_FRAMES,
        steps_per_s=(HALO_BOIDS_FRAMES - 1) / dt, k3_launches=k3_h,
        expected_k3=HALO_BOIDS_FRAMES * subs * HALO_SLABS, k1_launches=k1_h, k2_launches=k2_h,
        k1_launches_single=k1_s, route_cap=plan.route_cap, hw=plan.hw,
        table=[plan.table_geom.rows, plan.table_geom.cols, plan.table_geom.capacity],
        n_binned=int(m["n_binned"].item()),
        route_overflow_logic=int(m["route_overflow_logic"].item()),
        route_overflow_solver=int(m["route_overflow_solver"].item()),
        nonfinite=int(m["nonfinite_count"].item()), bit_equal=not diff,
        differing=json.dumps(diff, sort_keys=True).replace(" ", ""))
    check(int(m["route_overflow_logic"].item()) == 0
          and int(m["route_overflow_solver"].item()) == 0, "halo_boids: route overflow")
    check(int(m["n_binned"].item()) == HALO_BOIDS_N, "halo_boids: n_binned")
    check(k3_h == HALO_BOIDS_FRAMES * subs * HALO_SLABS and k1_h == 0 and k2_h == 0,
          f"halo_boids: K3 {k3_h}, K1 {k1_h}, K2 {k2_h} launches")
    check(k1_s == HALO_BOIDS_FRAMES * subs and k3_s == 0 and k2_s == 0,
          f"halo_boids: Engine.step launched K1 {k1_s}, K2 {k2_s}, K3 {k3_s}")
    check(not diff, f"halo_boids: the halo step and Engine.step differ: {diff}")
    inproc["halo_boids_102k_d4"] = dict(digests=chunk_digests(chunks),
                                        steps_per_s=(HALO_BOIDS_FRAMES - 1) / dt,
                                        frames=HALO_BOIDS_FRAMES)

    # the same scene under the homed step, against both
    from multithreadedgameengine_tpu_torch.parallel import make_homed_step

    eo = boids_engine(dev, HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL,
                      solver_predicated="off")
    eo._flush_pending()
    step_o, place_o, unplace_o, _ctl = make_homed_step(eo, make_mesh(HALO_SLABS, dev),
                                                       headroom=HOMED_HEADROOM)
    c, g = place_o(eo.world)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HALO_BOIDS_FRAMES):
        c, g, mo = step_o(c, g, ins)
    torch.cuda.synchronize()
    dt_o = time.perf_counter() - t0
    k3_o = read_counts()[2]
    o = unplace_o(c, g)
    diff_s, diff_h = world_diff(o, b, replicated=False), world_diff(o, a, replicated=False)
    log("homed_boids_102k_d4", entities=HALO_BOIDS_N, slabs=HALO_SLABS,
        frames=HALO_BOIDS_FRAMES, steps_per_s=HALO_BOIDS_FRAMES / dt_o,
        halo_boids_steps_per_s=(HALO_BOIDS_FRAMES - 1) / dt, headroom=HOMED_HEADROOM,
        n_cap=step_o.plan.n_cap, cap_pb=step_o.plan.cap_pb, band_len=list(step_o.plan.band_len),
        k3_launches=k3_o, expected_k3=HALO_BOIDS_FRAMES * subs * HALO_SLABS,
        n_binned=int(mo["n_binned"].item()), migrated_rows=int(mo["migrated_rows"].item()),
        home_violators=int(mo["home_violators"].item()),
        route_overflow_solver=int(mo["route_overflow_solver"].item()),
        bit_equal_single=not diff_s, bit_equal_halo=not diff_h,
        differing=json.dumps(diff_s, sort_keys=True).replace(" ", ""))
    check(int(mo["home_violators"].item()) == 0 and int(mo["route_overflow_solver"].item()) == 0,
          "homed_boids_102k_d4: violators or overflow")
    check(k3_o == HALO_BOIDS_FRAMES * subs * HALO_SLABS,
          f"homed_boids_102k_d4: K3 launched {k3_o}")
    check(not diff_s and not diff_h,
          f"homed_boids_102k_d4: the homed step differs: {diff_s} (single), {diff_h} (halo)")
    inproc["homed_boids_102k_d4"] = dict(digests=chunk_digests(c, g),
                                         steps_per_s=HALO_BOIDS_FRAMES / dt_o,
                                         frames=HALO_BOIDS_FRAMES)
    del eo, c, g, o
    ck = kernels()
    args = slab_grid_args(step, chunks, make_mesh(HALO_SLABS, dev))
    err, (_x, _y, kc) = kernel_vs_plain(ck.pair_pass_grid, ck.pair_pass_grid_plain,
                                        "halo_boids_slab1", args, None)
    errs["K3"].append(err)
    k3_ms, k3_plain_ms = time_kernel(ck.pair_pass_grid, ck.pair_pass_grid_plain, args,
                                     kernel_reps=100, plain_reps=2)
    b = grid_bound(args, int(kc.sum().item()))
    log("timing", grid="halo_boids_slab1", shape=list(args[0].shape), k3_ms=k3_ms,
        k3_plain_ms=k3_plain_ms, bound_ms=b[0], bound_by=b[1])
    return k3_h, dict(launches_homed_boids=k3_o, shape_halo_boids=list(args[0].shape),
                      ms_halo_boids=k3_ms,
                      plain_ms_halo_boids=k3_plain_ms, bound_ms_halo_boids=b[0])


def k4_inputs(dev, n, chunk, total, seed, empty_chunk=None, slots=None, specials=False):
    """K4's inputs as the probe makes them: ``n`` distinct slots of
    ``total`` (a seeded permutation; none in chunk ``empty_chunk``; or the
    given ``slots``, shuffled), the entities sorted by slot, each chunk's
    range by a search of the sorted slots, normal x and y (with -0.0, inf
    and NaN as the first three x if ``specials``)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if slots is None:
        perm = torch.randperm(total, generator=g, device=dev)
        if empty_chunk is not None:
            perm = perm[perm // chunk != empty_chunk]
        flat = perm[:n].to(torch.int32)
    else:
        flat = slots[torch.randperm(slots.numel(), generator=g, device=dev)].to(torch.int32)
        n = flat.numel()
    order = torch.argsort(flat).to(torch.int32)
    starts = torch.arange(0, total + 1, chunk, device=dev, dtype=torch.int32)
    bounds = torch.searchsorted(flat[order.long()], starts).to(torch.int32)
    x = torch.randn(n, generator=g, device=dev)
    y = torch.randn(n, generator=g, device=dev)
    if specials:
        x[:3] = torch.tensor([-0.0, float("inf"), float("nan")], device=dev)[:n]
    return (x, y, order, flat, bounds, total, chunk)


def k4_edge_cases(dev):
    """The edges of K4's tiling, each against its plain version: a tile
    spans a multiple of 8 slots and starts on one, wherever the grid puts
    it, so entities on the first and last slot of every 8-slot group sit on
    the first and last slot of every tile."""
    import torch

    edges = torch.arange(0, 4 * 12_296, 8, device=dev)
    return [
        # every slot of every chunk holds an entity; 8,200 is no multiple
        # of the tile
        ("dense", k4_inputs(dev, 3 * 8200, 8200, 3 * 8200, SEED + 2, specials=True)),
        # chunks of three tiles and 8 slots, chunk 1 empty
        ("ragged", k4_inputs(dev, 20_000, 12_296, 4 * 12_296, SEED + 3, empty_chunk=1,
                             specials=True)),
        ("tile_edges", k4_inputs(dev, 0, 12_296, 4 * 12_296, SEED + 4,
                                 slots=torch.cat([edges, edges + 7]), specials=True)),
        ("single", k4_inputs(dev, 1, K4_CHUNK, K4_TOTAL, SEED + 5)),
        ("chunk_8", k4_inputs(dev, 5, 8, 24, SEED + 6, specials=True)),
    ]


def ptxas_figures(report: str) -> dict:
    """Registers, stack and spills of the one kernel of a ``-Xptxas -v``
    report."""
    import re

    regs = re.search(r"Used (\d+) registers", report)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", report)
    check(regs is not None and frame is not None, f"no ptxas figures in {report!r}")
    return dict(registers=int(regs.group(1)), stack_bytes=int(frame.group(1)),
                spill_stores=int(frame.group(2)), spill_loads=int(frame.group(3)))


def k4_bound(args):
    """The least time for one K4 pass, in ms: x, y, order and flat read
    once (16 B an entity), bounds read, both outputs written (8 B a slot),
    over the HBM rate; it does no arithmetic."""
    x, _y, _o, _f, bounds, total, _c = args
    return (16 * x.numel() + 4 * bounds.numel() + 8 * total) / PEAK_BYTES_S * 1e3


def k4_phase(dev):
    """K4's path (the probe's placement) once through the wrapper, then K4
    against its plain version bit for bit, timed beside the yardstick."""
    import torch

    ck = kernels()
    probe = k4_inputs(dev, K4_N, K4_CHUNK, K4_TOTAL, SEED)
    zero_counts()
    ox, oy = ck.expand(*probe)
    torch.cuda.synchronize()
    launches = ck.expand.launches
    x, y, _order, flat, _b, total, chunk = probe
    fl = flat.long()
    placed = bool(torch.equal(ox.view(-1)[fl], x) and torch.equal(oy.view(-1)[fl], y))
    empty = torch.ones(total, dtype=torch.bool, device=dev)
    empty[fl] = False
    zeros = bool((ox.view(-1)[empty] == 0).all() and (oy.view(-1)[empty] == 0).all()
                 and not torch.signbit(ox.view(-1)[empty]).any())
    check(launches == 1 and placed and zeros, f"K4: launches {launches}, placed {placed}, "
          f"zeros elsewhere {zeros}")
    errs = []
    # a small odd-sized case: an odd entity count, chunks of 8200 slots,
    # chunk 2 with no entity
    small = k4_inputs(dev, 1237, 8200, 5 * 8200, SEED + 1, empty_chunk=2)
    for name, args in (("probe", probe), ("small", small), *k4_edge_cases(dev)):
        kx, ky = ck.expand(*args)
        px, py = ck.expand_plain(*args)
        torch.cuda.synchronize()
        same = bool(torch.equal(kx.view(torch.int32), px.view(torch.int32))
                    and torch.equal(ky.view(torch.int32), py.view(torch.int32)))
        # over the finite words: -0.0, inf and NaN are held by the bits
        err = max(torch.where(p.isfinite(), k - p, 0.0).abs().max().item()
                  for k, p in ((kx, px), (ky, py)))
        errs.append(err)
        log("parity", kernel="expand", case=name, shape=list(kx.shape), entities=args[0].numel(),
            bit_equal=same, max_abs_err=err)
        check(same and err == 0.0, f"K4 differs from its plain version on {name}")
    k4_ms, k4_plain_ms = time_kernel(ck.expand, ck.expand_plain, probe, kernel_reps=50,
                                     plain_reps=5)

    def scatter():
        lx = torch.zeros(total, device=dev)
        ly = torch.zeros(total, device=dev)
        lx.index_copy_(0, fl, x)
        ly.index_copy_(0, fl, y)
        return lx, ly

    lx, _ly = scatter()
    check(bool(torch.equal(lx.view_as(ox), ox)), "K4 yardstick: scatter misplaced")
    lib = graph_timer(lambda: scatter(), (), 50)
    lib_ms = statistics.median([lib(), lib(), lib()])
    bound_ms = k4_bound(probe)
    from multithreadedgameengine_tpu_torch.ops import _build

    figures = ptxas_figures(_build.ptxas_report(_build.library_path(_build.CSRC / "expand.cu")))
    check(figures["spill_stores"] == 0 and figures["spill_loads"] == 0,
          f"K4 spills registers: {figures}")
    log("k4", entities=K4_N, chunks=total // chunk, slots=total, launches=launches,
        **ck.expand_plan(total), **figures,
        k4_ms=k4_ms, plain_ms=k4_plain_ms, library_ms=lib_ms,
        library_call="zeros + index_copy_ of x and y", bound_ms=bound_ms, bound_by="bytes",
        share_of_bound=bound_ms / k4_ms)
    return dict(launches=launches, ms=k4_ms, plain_ms=k4_plain_ms, library_ms=lib_ms,
                bound=(bound_ms, "bytes"), errs=errs, shape=list(ox.shape))


# ---------------------------------------------------------------------------
# slice E2: the mixed halo passes and the position-homed step
# ---------------------------------------------------------------------------

def halo_predators_engine(dev):
    """The halo benchmark's mixed scene (``benchmarks/halo_scaling.py:
    61-75``): BASELINE config 4 scaled to ``HALO_PRED_N`` entity slots (the
    mouse, 24 predators, 7 lights, the rest prey) in 7000 s x 3500 s, s =
    (N / 15,028)^0.5, with collision events, at ``[predators_15k]``'s
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


def run_timed(step, state, ins, warmup, frames, sync_frame=True):
    """``warmup`` frames, one more under ``set_sync_debug_mode("error")``
    (no host read may happen inside a frame), then ``frames`` timed frames.
    ``state`` is the step's state tuple; returns (state, last metrics, the
    metrics of every timed frame, steps/s)."""
    import torch

    for _ in range(warmup):
        *state, m = step(*state, ins)
    if sync_frame:
        torch.cuda.synchronize()
        *state, m = no_host_reads(step)(*state, ins)
    torch.cuda.synchronize()
    timed = []
    t0 = time.perf_counter()
    for _ in range(frames):
        *state, m = step(*state, ins)
        timed.append(m)
    torch.cuda.synchronize()
    return state, m, timed, frames / (time.perf_counter() - t0)


def world_diff(a, b, replicated=True):
    """The entity leaves (and replicated leaves) of two port worlds that
    differ: {name: max abs difference or count of differing entries}."""
    import dataclasses

    import torch

    from multithreadedgameengine_tpu_torch.parallel.halo import (
        REPLICATED,
        _get_comp,
        entity_leaf_specs,
    )

    def cmp(name, u, v, out):
        if u is None and v is None:
            return
        if u.dtype == torch.float32:
            if not torch.equal(u, v):
                out[name] = (u.double() - v.double()).abs().max().item()
        elif not torch.equal(u, v):
            out[name] = int((u != v).sum().item())

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
    import torch

    sa, sb = a.shadow_sprites.map_tensors(torch.Tensor.cpu), b.shadow_sprites.map_tensors(
        torch.Tensor.cpu)
    return bool(torch.equal(sa.active, sb.active)) and all(
        torch.equal(getattr(sa, f)[sa.active], getattr(sb, f)[sb.active])
        for f in ("x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius"))


def halo_predators_phase(dev, inproc):
    """Phase 12: the mixed scene on 4 slabs through the halo step, one frame
    under the sync check. Returns (K3 launches, the run's state for the
    homed comparison)."""
    import torch

    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn

    eng = halo_predators_engine(dev)
    mesh = make_mesh(HALO_SLABS, dev)
    step, place = make_halo_step(eng, mesh, oversub=HALO_PRED_OVERSUB)
    plan = step.plan
    ins = eng.input.snapshot(dev)
    zero_counts()
    (chunks,), m, timed, sps = run_timed(step, (place(eng.world),), ins, HALO_PRED_WARMUP,
                                         HALO_PRED_FRAMES)
    k1, k2, k3 = read_counts()
    frames = HALO_PRED_WARMUP + 1 + HALO_PRED_FRAMES
    subs = plan.cfg.physics.sub_step_count
    mi = {k: int(v.item()) for k, v in m.items()}
    w = unplace_fn(chunks, mesh)
    ok = finite(w)
    shadows = int(w.shadow_sprites.active.sum().item())
    log("halo_predators_d4", card=repr(card_name_and_limit()), entities=w.n_entities,
        slabs=HALO_SLABS, frames=frames, steps_per_s=sps, oversub=HALO_PRED_OVERSUB,
        route_cap=plan.route_cap, hw=plan.hw, need_neighbors=plan.need_neighbors,
        scope_hooked=plan.scope_hooked, payload_channels=len(plan.payload_channels),
        pairs=mi["collision_pair_count"], pairs_dropped=mi["collision_pairs_dropped"],
        enter=int(w.event_enter_count.item()), stay=int(w.event_stay_count.item()),
        exit=int(w.event_exit_count.item()), particles=mi["active_particles"],
        canvas_px=int((w.decal_canvas[..., 3] > 0).sum().item()), shadows=shadows,
        n_binned=mi["n_binned"], route_overflow_logic=mi["route_overflow_logic"],
        route_overflow_solver=mi["route_overflow_solver"], k3_launches=k3,
        expected_k3=frames * HALO_SLABS * subs, k1_launches=k1, k2_launches=k2,
        frame_without_host_reads=True, finite=ok)
    check(ok and mi["nonfinite_count"] == 0, "halo_predators_d4: non-finite positions")
    check(mi["route_overflow_logic"] == 0 and mi["route_overflow_solver"] == 0,
          "halo_predators_d4: route overflow")
    check(k3 == frames * HALO_SLABS * subs and k1 == 0 and k2 == 0,
          f"halo_predators_d4: K3 {k3}, K1 {k1}, K2 {k2} launches")
    check(mi["collision_pair_count"] > 0 and shadows > 0 and mi["active_particles"] > 0,
          f"halo_predators_d4: no pairs, shadows or particles: {mi}, shadows {shadows}")
    check(mi["n_binned"] == w.n_entities, f"halo_predators_d4: n_binned {mi['n_binned']}")
    inproc["halo_mixed"] = dict(digests=chunk_digests(chunks), steps_per_s=sps, frames=frames)
    del eng, chunks
    return k3, dict(world=w, frames=frames, steps_per_s=sps)


def frame_with_hooks(eng, step, chunks, ins, unplace):
    """One halo frame with the engine's hook dispatch around it, as
    ``Engine.step(1)`` runs one: the emitter's queue lands in the shared
    pool, the frame runs, ``eng.world`` takes the frame's world and the
    hooks fire on its event tables. Returns (chunks, metrics)."""
    from multithreadedgameengine_tpu_torch.emitter import batch_to_device
    from multithreadedgameengine_tpu_torch.ops.particles import apply_emission

    batch, n = eng.emitter.build_batch()
    if batch is not None:
        pool, _n = apply_emission(chunks[0].particles, batch_to_device(batch, eng.device), n)
        chunks = [c.replace(particles=pool) for c in chunks]
    chunks, m = step(chunks, ins)
    eng.world = unplace(chunks)
    eng._dispatch_collision_events()
    return chunks, m


def static_shadow_engine(dev, **kw):
    """``tests/test_halo_mixed.py``'s static shadow scene: 59 casters and 4
    lamps in 2000 x 1600 (a moving caster's shadow would lag a frame under
    the slab steps, by design)."""
    import numpy as np

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


def slab_events_reference(dev):
    """The 400-prey event scene through the halo step on
    ``HALO_EVENT_SLABS`` slabs and through ``Engine.step`` on the card,
    each frame's hooks fired by the engine: per-frame event tables and hook
    calls, and the pool, the canvas and the entities at the end,
    identical; then the static shadow scene through the halo step, the
    homed step and ``Engine.step``."""
    import torch

    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
        unplace_fn,
    )

    es, calls_s, emits_s = events_scene(dev, 1)
    eh, calls_h, emits_h = events_scene(dev, 1)
    for e in (es, eh):
        e._flush_pending()
    mesh = make_mesh(HALO_EVENT_SLABS, dev)
    step, place = make_halo_step(eh, mesh, oversub=float(HALO_EVENT_SLABS))
    chunks = place(eh.world)
    ins = eh.input.snapshot(dev)
    tables_s, tables_h = [], []
    zero_counts()
    for _ in range(PRED_REF_FRAMES):
        es.step(1)
        tables_s.append(event_tables(es))
        chunks, m = frame_with_hooks(eh, step, chunks, ins, lambda c: unplace_fn(c, mesh))
        tables_h.append(event_tables(eh))
    k1, k2, k3 = read_counts()
    diff = world_diff(unplace_fn(chunks, mesh), es.world)
    stays = sum(len(t[2]) for t in tables_s)
    same_events = [t[1:] for t in tables_s] == [t[1:] for t in tables_h]
    log("halo_events_reference", prey=PRED_REF["n_prey"], slabs=HALO_EVENT_SLABS,
        frames=PRED_REF_FRAMES, event_tables_identical=same_events,
        pair_counts_identical=[len(t[0]) for t in tables_s] == [len(t[0]) for t in tables_h],
        hook_calls_identical=calls_s == calls_h, emits_identical=emits_s == emits_h,
        stay_rows=stays, emits=len(emits_s), symmetric_single=es._plan.symmetric,
        k3_launches=k3, k1_launches=k1, k2_launches=k2,
        live_particles=int(es.world.particles.active.sum().item()),
        world_identical=not diff, differing=json.dumps(diff, sort_keys=True).replace(" ", ""))
    check(same_events and calls_s == calls_h and emits_s == emits_h,
          "halo_events_reference: event tables, hook calls or emissions differ")
    check(stays > 0 and emits_s, "halo_events_reference: the blood hook never fired")
    check(not diff, f"halo_events_reference: the halo step and Engine.step differ: {diff}")
    del es, eh, chunks

    runs = {}
    for how in ("single", "halo", "homed"):
        e = static_shadow_engine(dev)
        ins = e.input.snapshot(dev)
        if how == "single":
            e.step(3)
            runs[how] = e.snapshot()
        elif how == "halo":
            mesh = make_mesh(HALO_SLABS, dev)
            s, p = make_halo_step(e, mesh)
            c = p(e.world)
            for _ in range(3):
                c, _m = s(c, ins)
            runs[how] = unplace_fn(c, mesh)
        else:
            s, p, u, _ctl = make_homed_step(e, make_mesh(HALO_SLABS, dev), headroom=float(
                HALO_SLABS))
            c, g = p(e.world)
            for _ in range(3):
                c, g, _m = s(c, g, ins)
            runs[how] = u(c, g)
    n_sh = int(runs["single"].shadow_sprites.active.sum().item())
    same = {how: shadows_equal(runs[how], runs["single"]) for how in ("halo", "homed")}
    log("slab_shadows_static", frames=3, shadows=n_sh, identical=json.dumps(same).replace(" ", ""))
    check(n_sh > 0 and all(same.values()), f"slab_shadows_static: shadows differ: {same}")


def homed_slab_grid_args(step, chunks, gids, mesh, d):
    """K3's input on slab ``d`` at this moment of a homed run: phase B's
    staging, block exchange, merge, binning and border fill
    (``parallel.homed``'s per-slab functions) applied to the chunks."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import grid_solver_state
    from multithreadedgameengine_tpu_torch.parallel import halo, homed

    plan = step.plan
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


def homed_phase(dev, halo_sps, errs, inproc):
    """Phase 13: halo_1m_d4's scene through the homed step (headroom
    1.125, as ``benchmarks/halo_scaling.py:150-186`` runs it), one frame
    under the sync check; K3 on its short-band slab against its plain
    version, bit for bit, and timed there; then the 100k balls scene under
    the homed step against ``Engine.step``. Returns K3's launches on the
    1M run and the short slab's figures."""
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import make_homed_step, make_mesh

    ck = kernels()
    eng = halo_balls_engine(dev)
    mesh = make_mesh(HALO_SLABS, dev)
    step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=HOMED_HEADROOM)
    plan = step.plan
    subs = plan.cfg.physics.sub_step_count
    ins = eng.input.snapshot(dev)
    zero_counts()
    (chunks, gids), m, timed, sps = run_timed(step, place(eng.world), ins, HALO_WARMUP,
                                              HALO_FRAMES)
    k1, k2, k3 = read_counts()
    frames = HALO_WARMUP + 1 + HALO_FRAMES
    migrated = [int(t["migrated_rows"].item()) for t in timed]
    violators = max(int(t["home_violators"].item()) for t in timed)
    overflow = max(int(t["route_overflow_solver"].item()) for t in timed)
    ok = all(finite(c) for c in chunks)
    log("homed_1m_d4", card=repr(card_name_and_limit()), entities=HALO_N, slabs=HALO_SLABS,
        frames=frames, steps_per_s=sps, halo_1m_d4_steps_per_s=halo_sps,
        headroom=HOMED_HEADROOM, n_cap=plan.n_cap, m_mig=plan.m_mig, cap_pb=plan.cap_pb,
        band_len=list(plan.band_len), solver_geom=plan.solver_geom,
        migrated_rows_per_frame=json.dumps(migrated).replace(" ", ""),
        home_violators=violators, route_overflow_solver=overflow,
        active_count=int(m["active_count"].item()),
        solver_binned=int(m["solver_binned"].item()), k3_launches=k3,
        expected_k3=frames * subs * HALO_SLABS, k1_launches=k1, k2_launches=k2,
        frame_without_host_reads=True, finite=ok)
    check(ok and int(m["nonfinite_count"].item()) == 0, "homed_1m_d4: non-finite positions")
    check(violators == 0 and overflow == 0,
          f"homed_1m_d4: home_violators {violators}, route_overflow_solver {overflow}")
    check(int(m["active_count"].item()) == HALO_N, "homed_1m_d4: entities lost")
    check(k3 == frames * subs * HALO_SLABS and k1 == 0 and k2 == 0,
          f"homed_1m_d4: K3 {k3}, K1 {k1}, K2 {k2} launches")
    inproc["homed_1m_d4"] = dict(digests=chunk_digests(chunks, gids), steps_per_s=sps,
                                 frames=frames)

    # K3 on a slab whose band is shorter than the padded grid's rows
    short = [d for d, n in enumerate(plan.band_len) if n < plan.slab_geom.rows]
    check(bool(short), f"homed_1m_d4: no short band in {plan.band_len}")
    inner = [d for d in short if 0 < d < HALO_SLABS - 1]  # a slab below fills its halo row
    d = (inner or short)[-1]
    args = homed_slab_grid_args(step, chunks, gids, mesh, d)
    kx, ky, kc = ck.pair_pass_grid(*args)
    px, py, pc = ck.pair_pass_grid_plain(*args)
    torch.cuda.synchronize()
    err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
    n_bad = int((kc != pc).sum().item())
    halo_row = plan.band_len[d] + 1
    log("parity", kernel="pair_pass_grid", layout=f"homed_1m_slab{d}", shape=list(kx.shape),
        band_len=plan.band_len[d], halo_row=halo_row, contacts=int(kc.sum().item()),
        halo_row_colliders=int(((args[2][halo_row, ..., 1].to(torch.int32) & 1) == 1)
                               .sum().item()),
        count_mismatch=n_bad, max_abs_err=err)
    check(n_bad == 0 and err == 0.0, f"K3 differs from its plain version on the short slab {d}")
    errs["K3"].append(err)
    k3_ms, k3_plain_ms = time_kernel(ck.pair_pass_grid, ck.pair_pass_grid_plain, args,
                                     kernel_reps=50, plain_reps=2)
    b = grid_bound(args, int(kc.sum().item()))
    short_shape = list(args[0].shape)
    log("timing", grid=f"homed_1m_slab{d}", shape=short_shape, k3_ms=k3_ms,
        k3_plain_ms=k3_plain_ms, bound_ms=b[0], bound_by=b[1])
    del eng, chunks, gids, args, kx, ky, kc, px, py, pc
    torch.cuda.empty_cache()

    # the 100k balls scene under the homed step against Engine.step
    scene = dict(n_balls=CHECK_N - 1, seed=SEED, device=dev, world_width=CHECK_WORLD[0],
                 world_height=CHECK_WORLD[1])
    eh, es = make_balls_engine(**scene), make_balls_engine(**scene)
    for e in (eh, es):
        e._flush_pending()
    step_c, place_c, unplace_c, _ctl = make_homed_step(eh, make_mesh(HALO_SLABS, dev),
                                                       headroom=HOMED_HEADROOM)
    c, g = place_c(eh.world)
    zero_counts()
    for _ in range(10):
        c, g, mc = step_c(c, g, eh.input.snapshot(dev))
    k3_c = read_counts()[2]
    zero_counts()
    es.step(10, block=True)
    k1_c, k2_c, _k3 = read_counts()
    diff = world_diff(unplace_c(c, g), es.world, replicated=False)
    log("homed_vs_single_100k", slabs=HALO_SLABS, frames=10, k3_launches=k3_c,
        k1_launches_single=k1_c, k2_launches_single=k2_c, bit_equal=not diff,
        differing=json.dumps(diff, sort_keys=True).replace(" ", ""),
        band_len=list(step_c.plan.band_len),
        migrated_rows=int(mc["migrated_rows"].item()),
        home_violators=int(mc["home_violators"].item()),
        route_overflow_solver=int(mc["route_overflow_solver"].item()))
    check(int(mc["home_violators"].item()) == 0 and int(mc["route_overflow_solver"].item()) == 0,
          "homed_vs_single_100k: violators or overflow")
    check(not diff, f"homed_vs_single_100k: the homed step and Engine.step differ: {diff}")
    check(k3_c == 10 * subs * HALO_SLABS and k1_c == 10 * subs and k2_c == 0,
          f"homed_vs_single_100k: K3 {k3_c}, K1 {k1_c}, K2 {k2_c} launches")
    return k3, dict(shape_homed_short=short_shape, band_len_homed_short=plan.band_len[d],
                    ms_homed_short=k3_ms, plain_ms_homed_short=k3_plain_ms,
                    bound_ms_homed_short=b[0], bound_by_homed_short=b[1],
                    launches_homed_1m=k3, launches_homed_100k=k3_c)


def homed_mixed_phase(dev, halo_run, inproc):
    """Phase 14: the mixed scene of phase 12 under the homed step, one frame
    under the sync check, against the halo step's run of the same frames:
    entities, event tables, pool, canvas and shadows identical. Returns K3's
    launches."""
    from multithreadedgameengine_tpu_torch.parallel import make_homed_step, make_mesh

    eng = halo_predators_engine(dev)
    step, place, unplace, _ctl = make_homed_step(eng, make_mesh(HALO_SLABS, dev),
                                                 headroom=HOMED_MIXED_HEADROOM)
    plan = step.plan
    ins = eng.input.snapshot(dev)
    zero_counts()
    (chunks, gids), m, timed, sps = run_timed(step, place(eng.world), ins, HALO_PRED_WARMUP,
                                              HALO_PRED_FRAMES)
    k1, k2, k3 = read_counts()
    frames = HALO_PRED_WARMUP + 1 + HALO_PRED_FRAMES
    subs = plan.cfg.physics.sub_step_count
    mi = {k: int(v.item()) for k, v in m.items()}
    w = unplace(chunks, gids)
    violators = max(int(t["home_violators"].item()) for t in timed)
    overflow = max(int(t["route_overflow_solver"].item()) for t in timed)
    h = halo_run["world"]
    diff = world_diff(w, h)
    same_shadows = shadows_equal(w, h)
    log("homed_mixed", entities=w.n_entities, slabs=HALO_SLABS, frames=frames, steps_per_s=sps,
        halo_predators_d4_steps_per_s=halo_run["steps_per_s"], headroom=HOMED_MIXED_HEADROOM,
        n_cap=plan.n_cap, cap_pb=plan.cap_pb, band_len=list(plan.band_len),
        pairs=mi["collision_pair_count"], particles=mi["active_particles"],
        shadows=int(w.shadow_sprites.active.sum().item()),
        migrated_rows_per_frame=json.dumps([int(t["migrated_rows"].item()) for t in timed])
        .replace(" ", ""), home_violators=violators, route_overflow_solver=overflow,
        k3_launches=k3, expected_k3=frames * HALO_SLABS * subs, k1_launches=k1,
        k2_launches=k2, identical_to_halo=not diff and same_shadows,
        differing=json.dumps(diff, sort_keys=True).replace(" ", ""),
        frame_without_host_reads=True, finite=finite(w))
    check(finite(w) and mi["nonfinite_count"] == 0, "homed_mixed: non-finite positions")
    check(violators == 0 and overflow == 0,
          f"homed_mixed: home_violators {violators}, route_overflow_solver {overflow}")
    check(k3 == frames * HALO_SLABS * subs and k1 == 0 and k2 == 0,
          f"homed_mixed: K3 {k3}, K1 {k1}, K2 {k2} launches")
    check(not diff and same_shadows,
          f"homed_mixed: the homed and halo steps differ: {diff}, shadows {same_shadows}")
    inproc["homed_mixed"] = dict(digests=chunk_digests(chunks, gids), steps_per_s=sps,
                                 frames=frames)
    return k3


# ---------------------------------------------------------------------------
# slice D1: frame plans and the rest of the host API
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def guarded_plan_frames(eng):
    """Every frame of every plan chunk run inside the block, and its op
    table's upload, under ``set_sync_debug_mode("error")``: the chunk's
    upload, scatters, frames and event-log writes may not wait for the
    card. Yields {"frames": the count of guarded frames}."""
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


def quartiles(values):
    q = statistics.quantiles(values, n=4, method="inclusive")
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2]}


def churn_phase(dev):
    """Phase 15: BASELINE config 2 as ``rung_churn`` runs it, beside the
    same scene through ``Engine.step`` without churn. Returns K1's launches
    over the timed frames."""
    import numpy as np
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    eng.step(5, block=True)
    rng = np.random.default_rng(7)
    with guarded_plan_frames(eng) as guard:
        churn_frames(eng, rng, CHURN_CHUNK, CHURN, CHURN_CHUNK)
    for _ in range(CHURN_WARM_PLANS - 1):
        churn_frames(eng, rng, CHURN_CHUNK, CHURN, CHURN_CHUNK)
    eng.sync()
    zero_counts()
    rates, build_s, run_s = [], [], []
    for _ in range(CHURN_PLANS):
        t0 = time.perf_counter()
        b, r = churn_frames(eng, rng, CHURN_FRAMES, CHURN, CHURN_CHUNK)
        eng.sync()
        rates.append(CHURN_FRAMES / (time.perf_counter() - t0))
        build_s.append(b)
        run_s.append(r)
    k1, k2, k3 = read_counts()
    timed = CHURN_PLANS * CHURN_FRAMES
    subs = eng.config.physics.sub_step_count
    overflow = int(eng.metrics["solver_overflow"].item())
    pool = eng.get_pool_stats("Ball")
    w = eng.world
    ok = finite(w)
    device_active = int(w.transform.active.sum().item())
    del eng, w
    # the same scene and frames through Engine.step, no churn
    still = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    still.step(5, block=True)
    still.step(CHURN_CHUNK * CHURN_WARM_PLANS, block=True)
    still_rates = []
    for _ in range(CHURN_PLANS):
        t0 = time.perf_counter()
        still.step(CHURN_FRAMES)
        still.sync()
        still_rates.append(CHURN_FRAMES / (time.perf_counter() - t0))
    del still
    churn_q, still_q = quartiles(rates), quartiles(still_rates)
    log("churn_10k", card=repr(card_name_and_limit()), balls=N_MAIN, churn=CHURN,
        plan_chunk=CHURN_CHUNK, timed_plans=CHURN_PLANS, frames_per_plan=CHURN_FRAMES,
        steps_per_s=json.dumps(churn_q).replace(" ", ""),
        steps_per_s_runs=json.dumps(rates).replace(" ", ""),
        plan_build_s=json.dumps(build_s).replace(" ", ""),
        run_plan_s=json.dumps(run_s).replace(" ", ""),
        no_churn_steps_per_s=json.dumps(still_q).replace(" ", ""),
        churn_over_no_churn=churn_q["median"] / still_q["median"],
        k1_launches=k1, expected_k1=timed * subs, k2_launches=k2, k3_launches=k3,
        solver_overflow=overflow, pool_active=pool["active"], device_active=device_active,
        frames_without_host_reads=guard["frames"], finite=ok)
    check(ok, "churn_10k: non-finite positions")
    check(k1 == timed * subs and k2 == 0 and k3 == 0,
          f"churn_10k: K1 {k1}, K2 {k2}, K3 {k3} launches; expected {timed * subs}, 0, 0")
    check(pool["active"] == N_MAIN and device_active == N_MAIN + 1,
          f"churn_10k: the population moved: pool {pool}, device {device_active}")
    check(guard["frames"] == CHURN_CHUNK, f"churn_10k: {guard['frames']} guarded frames")
    check(overflow == 0, f"churn_10k: solver_overflow {overflow}")
    torch.cuda.empty_cache()
    return k1


def small_churn(dev, mode):
    """Phase 16's scene: phase 3's 400 balls (1200 x 800), churning
    ``SMALL_CHURN`` through a plan or through immediate ops."""
    import numpy as np

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    c = SMALL_CHURN
    eng = make_balls_engine(n_balls=c["balls"], seed=SEED, device=dev, world_width=1200.0,
                            world_height=800.0)
    eng.step(2, block=True)
    rng = np.random.default_rng(7)
    if mode == "plan":
        churn_frames(eng, rng, c["frames"], c["churn"], c["chunk"], (1100.0, 700.0))
    else:
        for _ in range(c["frames"]):
            active = eng.active_indices("Ball")
            eng.despawn_batch(rng.choice(active, size=c["churn"], replace=False))
            eng.spawn_batch("Ball", c["churn"],
                            x=rng.uniform(100, 1100.0, c["churn"]).astype(np.float32),
                            y=rng.uniform(100, 700.0, c["churn"]).astype(np.float32))
            eng.step(1)
    free = {n: list(map(int, r.pool.free)) for n, r in eng.classes.items()}
    return eng.snapshot(), free


def plan_vs_immediate(dev):
    """Phase 16: a churning plan on the card against the same ops issued
    immediately on the card (bit-equal), and against the plan on the CPU
    (integers exact, positions within ``PLAN_REF_ULPS`` ulps)."""
    import numpy as np

    zero_counts()
    (plan, free_p), (imm, free_i) = small_churn(dev, "plan"), small_churn(dev, "immediate")
    k1, _k2, _k3 = read_counts()
    cpu, free_c = small_churn("cpu", "plan")
    diff = world_diff(plan, imm, replicated=False)
    tol = PLAN_REF_ULPS * float(np.spacing(np.float32(1200.0)))
    vs_cpu = world_diff(plan.map_tensors(lambda a: a.cpu()), cpu, replicated=False)
    floats = {k: v for k, v in vs_cpu.items() if isinstance(v, float)}
    ints = {k: v for k, v in vs_cpu.items() if not isinstance(v, float)}
    err = max(floats.values(), default=0.0)
    log("plan_vs_immediate", **SMALL_CHURN, bit_equal_with_immediate=not diff,
        free_lists_equal=free_p == free_i, max_abs_err_vs_cpu=err, int_fields_differ=len(ints),
        tol=tol, k1_launches=k1, contacts=int(plan.rigid_body.collision_count.sum().item()))
    check(not diff and free_p == free_i, f"plan_vs_immediate: the plan differs: {diff}")
    check(not ints and err <= tol and free_p == free_c,
          f"plan_vs_immediate: the card differs from the CPU: {vs_cpu}")
    return k1


def plan_resident_100k(dev):
    """Phase 17: phase 5's 100k scene with the ladder's knobs, a sparse and
    a dense churning plan, each with residency on and off: bit-equal."""
    import numpy as np

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    cases = {"sparse": (12, (0, 5), 6), "dense": (8, range(8), 4)}
    world = (CHECK_WORLD[0] - 100.0, CHECK_WORLD[1] - 100.0)
    out, launches = {}, {}
    for name, (frames, op_frames, chunk) in cases.items():
        snaps = {}
        for residency in ("on", "off"):
            e = make_balls_engine(n_balls=CHECK_N, seed=SEED, device=dev,
                                  world_width=CHECK_WORLD[0], world_height=CHECK_WORLD[1],
                                  physics=dict(LADDER_PHYSICS, position_residency=residency))
            e.input.set_mouse(14_000.0, 6000.0)
            e.input.mouse_button(0, True)
            e.step(3, block=True)
            rng = np.random.default_rng(5)
            zero_counts()
            plan = e.begin_plan()
            for f in range(frames):
                if f in op_frames:
                    active = e.active_indices("Ball")
                    plan.despawn_batch(rng.choice(active, size=CHURN, replace=False))
                    plan.spawn_batch("Ball", CHURN,
                                     x=rng.uniform(100, world[0], CHURN).astype(np.float32),
                                     y=rng.uniform(100, world[1], CHURN).astype(np.float32))
                plan.next_frame()
            e.run_plan(plan, max_chunk=chunk)
            e.sync()
            launches[(name, residency)] = read_counts()[:2]
            check(e._plan.residency == (residency == "on"), f"plan_resident_100k: {residency}")
            snaps[residency] = (e.snapshot(), e.get_pool_stats("Ball"), e._plan.symmetric)
            del e
        (a, pa, sym), (b, pb, _sym) = snaps["on"], snaps["off"]
        out[name] = (world_diff(a, b, replicated=False), pa == pb, sym)
    log("plan_resident_100k", balls=CHECK_N, churn=CHURN,
        bit_equal=json.dumps({k: not v[0] for k, v in out.items()}).replace(" ", ""),
        pools_equal=all(v[1] for v in out.values()),
        kernel="K2" if out["sparse"][2] else "K1",
        launches=json.dumps({f"{k}_{r}": v for (k, r), v in launches.items()}).replace(" ", ""))
    check(all(not v[0] and v[1] for v in out.values()),
          f"plan_resident_100k: residency on and off differ: { {k: v[0] for k, v in out.items()} }")
    return launches


def plan_events(dev):
    """Phase 18: the 400-prey event scene through a plan of
    ``PLAN_EVENT_FRAMES`` frames in chunks of ``PLAN_EVENT_CHUNK`` (every
    frame under the sync check), against ``step(1)`` per frame: the same
    hook calls, emissions, tables and entities."""
    runs = {}
    for mode in ("plan", "per_frame"):
        eng, calls, emits = events_scene(dev, PLAN_EVENT_CHUNK if mode == "plan" else 1)
        if mode == "plan":
            zero_counts()
            plan = eng.begin_plan()
            for _ in range(PLAN_EVENT_FRAMES):
                plan.next_frame()
            with guarded_plan_frames(eng) as guard:
                eng.run_plan(plan, max_chunk=PLAN_EVENT_CHUNK)
            eng.sync()
            k1 = read_counts()[0]
        else:
            for _ in range(PLAN_EVENT_FRAMES):
                eng.step(1)
        runs[mode] = (calls, emits, event_tables(eng), eng.snapshot())
    (cp, ep, tp, wp), (cf, ef, tf, wf) = runs["plan"], runs["per_frame"]
    diff = world_diff(wp, wf, replicated=False)
    log("plan_events", frames=PLAN_EVENT_FRAMES, plan_chunk=PLAN_EVENT_CHUNK, dispatches=len(cf),
        hook_calls_identical=cp == cf, emits_identical=ep == ef, tables_identical=tp == tf,
        entities_identical=not diff, frames_without_host_reads=guard["frames"], k1_launches=k1)
    check(cp == cf and ep == ef and tp == tf and cf,
          "plan_events: hook calls, emissions or tables differ from step(1)")
    check(not diff, f"plan_events: entities differ: {diff}")
    check(guard["frames"] == PLAN_EVENT_FRAMES,
          f"plan_events: {guard['frames']} guarded frames")
    return k1


def checkpoint_phase(dev):
    """Phase 19: the 10k scene saved at frame 10 and stepped 15 more,
    against a fresh engine loaded from the file and stepped 15: bit-equal,
    and the next ``rng()`` equal."""
    from pathlib import Path

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    path = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    zero_counts()
    a = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    a.step(10)
    t0 = time.perf_counter()
    a.save_checkpoint(str(path))
    save_s = time.perf_counter() - t0
    a.step(15)
    b = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    t0 = time.perf_counter()
    b.load_checkpoint(str(path))
    load_s = time.perf_counter() - t0
    b.step(15)
    k1 = read_counts()[0]
    diff = world_diff(a.snapshot(), b.snapshot(), replicated=False)
    same_rng = a.rng() == b.rng()
    size = path.stat().st_size
    path.unlink()
    log("checkpoint", balls=N_MAIN, saved_at=10, then=15, bit_equal=not diff,
        next_rng_equal=same_rng, file_bytes=size, save_s=save_s, load_s=load_s,
        k1_launches=k1)
    check(not diff and same_rng, f"checkpoint: the resumed run differs: {diff}")
    return k1


# ---------------------------------------------------------------------------
# slices C4 and D2: the neighbour-list solver and the render path
# ---------------------------------------------------------------------------

def random_scene_world(dev, seed, n=60):
    """``tests/test_physics_grid.py``'s ``random_scene`` (statics, triggers,
    inactive entities, radii 4-12 in 600 x 400) as a port world on ``dev``,
    made as ``tests/test_physics.py::world_from_golden`` makes it, and its
    config with ``solver``."""
    import numpy as np
    import torch

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


def neighbors_phase(dev, grid_steps_per_s):
    """Slice C4's main path: the demo scene (10,000 balls) with
    ``solver="neighbors"`` through ``Engine.step``, beside phase 3's grid
    steps/s; then 400 balls on the card against the CPU, and the
    reference's neighbours-against-grid bar on the card."""
    import numpy as np
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.ops.physics import physics_step
    from multithreadedgameengine_tpu_torch.ops.physics_grid import solver_geometry
    from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

    eng = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev,
                            physics=dict(solver="neighbors"))
    zero_counts()
    eng.step(NBR_WARMUP, block=True)
    t0 = time.perf_counter()
    eng.step(NBR_FRAMES)
    eng.sync()
    dt = time.perf_counter() - t0
    counts = read_counts() + (kernels().expand.launches,)
    w, m, plan = eng.world, eng.metrics, eng._plan
    ok = finite(w) and int(m["nonfinite_count"].item()) == 0
    n_binned, active = int(m["n_binned"].item()), int(m["active_count"].item())
    sps = NBR_FRAMES / dt
    log("neighbors_10k", card=repr(card_name_and_limit()), balls=N_MAIN,
        frames=NBR_WARMUP + NBR_FRAMES, steps_per_s=sps, grid_steps_per_s=grid_steps_per_s,
        ratio_to_grid=sps / grid_steps_per_s, kernel_launches=counts,
        list_slots=(2 * eng.config.spatial.max_cell_radius + 1) ** 2
        * eng.config.spatial.cell_capacity,
        n_binned=n_binned, active_count=active,
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok, "neighbors_10k: non-finite positions")
    check(plan.solver_geom is None and plan.need_neighbors,
          "neighbors_10k: the frame did not run the neighbour-list solver")
    check(counts == (0, 0, 0, 0), f"neighbors_10k: kernel launches {counts}, expected none")
    check(n_binned == active, f"neighbors_10k: n_binned {n_binned} of {active}")
    del eng, w

    snaps = {}
    for d in (dev, "cpu"):
        e = make_balls_engine(n_balls=400, seed=SEED, device=d, world_width=1200.0,
                              world_height=800.0, physics=dict(solver="neighbors"))
        e.input.set_mouse(600.0, 700.0)
        e.input.mouse_button(0, True)
        e.step(NBR_REF_FRAMES)
        snaps[str(d)] = e.snapshot()
    a, b = snaps[str(dev)], snaps["cpu"]
    err = max((a.transform.x - b.transform.x).abs().max().item(),
              (a.transform.y - b.transform.y).abs().max().item())
    bad = int((a.rigid_body.collision_count != b.rigid_body.collision_count).sum())
    tol = NBR_REF_ULPS * float(np.spacing(np.float32(1200.0)))

    walls = {}
    for solver in ("neighbors", "grid"):
        w, cfg, r_max = random_scene_world(dev, 0)
        c = cfg(solver)
        geom = solver_geometry(c, r_max) if solver == "grid" else None
        for _ in range(NBR_GRID_FRAMES):
            nbr = (neighbor_lists(w.transform.x, w.transform.y, w.transform.active,
                                  w.collider.visual_range, c) if geom is None else None)
            w, _ovf = physics_step(w, c, 1.0, geom, nbr)
            w = w.replace(step_count=w.step_count + 1)
        walls[solver] = w
    gap = max((walls["neighbors"].transform.x - walls["grid"].transform.x).abs().max().item(),
              (walls["neighbors"].transform.y - walls["grid"].transform.y).abs().max().item())
    log("neighbors_reference", balls=400, frames=NBR_REF_FRAMES, max_abs_err_vs_cpu=err,
        count_mismatch=bad, tol=tol, contacts=int(a.rigid_body.collision_count.sum().item()),
        vs_grid_frames=NBR_GRID_FRAMES, vs_grid_max_abs=gap, vs_grid_atol=NBR_GRID_ATOL)
    check(bad == 0 and err <= tol, "neighbors_reference: the card differs from the CPU")
    check(gap <= NBR_GRID_ATOL, f"neighbors_reference: neighbours and grid part by {gap}")


@contextlib.contextmanager
def world_on_host(eng):
    """The engine holding a CPU copy of its world for the duration."""
    card = eng.world
    eng.world = eng.snapshot()
    try:
        yield
    finally:
        eng.world = card


FRAME_HEADER = struct.Struct("<IIIIIIII")


def parse_frame(buf: bytes):
    """A frame's header fields, after checking the magic, the length the
    header implies and that the entity lanes are finite with their index
    lane an entity id."""
    import numpy as np

    from multithreadedgameengine_tpu_torch.server.render_server import ENT_LANES, MAGIC

    magic, step, n_e, n_p, n_s, n_l, mask, n_dbg = FRAME_HEADER.unpack_from(buf, 0)
    size = 32 + 4 * (n_e * (ENT_LANES + 1) + 4 * n_dbg + 5 * n_p + 7 * n_s + 5 * n_l)
    check(magic == MAGIC and len(buf) == size, f"a frame of {len(buf)} bytes, header {size}")
    ent = np.frombuffer(buf, "<f4", n_e * ENT_LANES, 32).reshape(n_e, ENT_LANES)
    check(bool(np.isfinite(ent).all()) and bool((ent[:, 12] >= 0).all()),
          "a frame's entity lanes are not finite ids")
    return dict(step=step, n_e=n_e, n_p=n_p, n_s=n_s, n_l=n_l, mask=mask, n_dbg=n_dbg)


class FrameClient(threading.Thread):
    """A browser's stand-in: POSTs its camera to /input once (when given),
    then GETs /frame over localhost every 10 ms until stopped, parsing each
    new frame (``parse_frame``). Only reads bytes the server published."""

    def __init__(self, port: int, camera=None):
        super().__init__(daemon=True)
        self.base = f"http://localhost:{port}"
        self.url = self.base + "/frame"
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
                with urllib.request.urlopen(self.url, timeout=30) as r:
                    body = r.read()
                if body and body != last:
                    self.frames.append(parse_frame(body))
                    last = body
                self.stop.wait(0.01)
        except Exception as e:  # reported by the phase, which fails on it
            self.error = repr(e)
            self.posted.set()


def http_get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=30) as r:
        return r.read()


def render_server_phase(dev, scene, errs):
    """Slice D2's main path: the render server in front of ``scene`` as
    ``run_scene`` drives it (``apply_inputs``, ``step(2)``, ``publish``,
    the decal PNG every 60 steps) for ``RENDER_STEPS`` steps, a client
    thread reading every frame over localhost, beside as many steps
    unpublished and as many with a sync in place of each publish, the
    three in turns; K1's launches over the published steps, and K1
    against its plain version on the scene's layout after them;
    each publish's own ms (the card idle first); the packet against its CPU
    copy's (``[render_packet]``), the published headers against the packet,
    and for predators the atlas endpoints, the decal PNG and the sections.
    Returns (K1 launches, the engine)."""
    import numpy as np
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.render.atlas import decode_png
    from multithreadedgameengine_tpu_torch.server.render_server import (
        RenderServer,
        build_demo_atlas,
        encode_frame,
    )

    ck = kernels()
    tag = f"render_server_{scene}"
    if scene == "balls_10k":
        eng, atlas = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev), None
    else:
        eng = predators_engine(dev)
        atlas = build_demo_atlas(eng)
        blood_burst(eng)
    subs = eng.config.physics.sub_step_count
    eng.step(2 * STEPS_PER_PUBLISH, block=True)

    published = [0]  # steps published so far: the decal PNG every 60

    def run(mode):
        t0 = time.perf_counter()
        for _ in range(RENDER_CHUNK // STEPS_PER_PUBLISH):
            if mode == "published":
                srv.apply_inputs()
            eng.step(STEPS_PER_PUBLISH)
            if mode == "published":
                published[0] += STEPS_PER_PUBLISH
                srv.publish(include_decals=(published[0] % DECALS_EVERY == 0))
            elif mode == "synced":  # a publish's wait for the card, and nothing else
                torch.cuda.synchronize()
        eng.sync()
        return time.perf_counter() - t0

    srv = RenderServer(eng, port=0, atlas=atlas).start()
    client = FrameClient(srv.port, list(BALLS_CAMERA) if atlas is None else None)
    try:
        client.start()
        client.posted.wait(timeout=60)
        srv.apply_inputs()  # the client's camera, before the timed runs
        secs = {"unpublished": 0.0, "synced": 0.0, "published": 0.0}
        for mode in ("unpublished", "synced"):
            secs[mode] += run(mode)
        zero_counts()
        secs["published"] += run("published") + run("published")
        k1, k2, k3 = read_counts()
        k4 = ck.expand.launches
        for mode in ("synced", "unpublished"):
            secs[mode] += run(mode)
        time.sleep(0.05)
        client.stop.set()
        client.join(timeout=60)
        check(not client.is_alive() and client.error is None,
              f"{tag}: the client failed: {client.error}")

        # each publish's own cost, the card idle first
        publish_ms = []
        for _ in range(PUBLISH_TIMED):
            eng.step(STEPS_PER_PUBLISH)
            torch.cuda.synchronize()
            tp = time.perf_counter()
            srv.publish()
            publish_ms.append((time.perf_counter() - tp) * 1e3)
        decal_ms = None
        if atlas is not None:  # a publish with the decal PNG, as every 60th step's
            torch.cuda.synchronize()
            tp = time.perf_counter()
            srv.publish(include_decals=True)
            decal_ms = (time.perf_counter() - tp) * 1e3
        # the published header against the packet of the same world (a
        # fresh burst: the first has landed by now, and the frame's particle
        # section is the live ones)
        if atlas is not None:
            blood_burst(eng)
        for _ in range(3):
            eng.step(STEPS_PER_PUBLISH)
            srv.publish()
            head = parse_frame(http_get(srv.port, "/frame"))
            pkt = eng.render_packet(20000)
            check(head["n_e"] == int(pkt.count) and head["step"] == eng.world.step_count,
                  f"{tag}: header {head} against packet count {int(pkt.count)}")
        stats = json.loads(http_get(srv.port, "/stats"))
        check(stats["total_steps"] == eng.timer.total_steps, f"{tag}: /stats is stale")
        extra = {}
        if atlas is not None:
            img = decode_png(http_get(srv.port, "/atlas"))
            payload = json.loads(http_get(srv.port, "/atlas.json"))
            decals = decode_png(http_get(srv.port, "/decals"))
            extra = dict(atlas_px=list(img.shape), atlas_sheets=len(payload["sheets"]),
                         decal_png=list(decals.shape),
                         decal_px_set=int((decals[..., 3] > 0).sum()))
            check(img.shape[2] == 4 and len(payload["sheets"]) > 0 and payload["textures"],
                  f"{tag}: the atlas endpoints")
            check(decals.shape[:2] == tuple(eng.world.decal_canvas.shape[:2])
                  and extra["decal_px_set"] > 0, f"{tag}: the decal PNG")
            check(head["n_p"] > 0 and head["n_s"] > 0 and head["n_l"] > 0,
                  f"{tag}: empty particle, shadow or light section: {head}")
    finally:
        client.stop.set()
        srv.stop()
    frames_seen = len(client.frames)
    steps_seen = [f["step"] for f in client.frames]
    log(tag, card=repr(card_name_and_limit()), entities=eng.world.n_entities,
        steps=RENDER_STEPS, steps_per_publish=STEPS_PER_PUBLISH,
        steps_per_s=RENDER_STEPS / secs["published"],
        unpublished_steps_per_s=RENDER_STEPS / secs["unpublished"],
        synced_steps_per_s=RENDER_STEPS / secs["synced"],
        ratio=secs["unpublished"] / secs["published"], publish_ms_median=statistics.median(publish_ms),
        publish_ms_max=max(publish_ms), decal_publish_ms=decal_ms,
        frame_bytes=len(encode_frame(eng)),
        client_frames=frames_seen, k1_launches=k1, expected_k1=RENDER_STEPS * subs,
        header=head, **extra)
    check(k1 == RENDER_STEPS * subs and (k2, k3, k4) == (0, 0, 0),
          f"{tag}: K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} launches; "
          f"expected {RENDER_STEPS * subs}, 0, 0, 0")
    check(frames_seen > 0 and steps_seen == sorted(steps_seen),
          f"{tag}: the client read {frames_seen} frames, steps {steps_seen[:8]}...")
    check(finite(eng.world), f"{tag}: non-finite positions")
    err, _ = kernel_vs_plain(ck.pair_pass_resident, ck.pair_pass_resident_plain, scene,
                             layout_args(eng),
                             max(eng.config.world_width, eng.config.world_height))
    errs["K1"].append(err)

    # the packet and the frame on the card against the CPU copy's
    pkt = eng.render_packet()
    frame = encode_frame(eng)
    with world_on_host(eng):
        host_pkt, host_frame = eng.render_packet(), encode_frame(eng)
    same = all(torch.equal(getattr(pkt, f), getattr(host_pkt, f))
               for f in pkt.__dataclass_fields__)
    log("render_packet", scene=scene, visible=int(pkt.count), rows=pkt.index.shape[0],
        fields_equal=same, frame_bytes_equal=frame == host_frame)
    check(same and frame == host_frame and int(pkt.count) > 0,
          f"render_packet: {scene}'s packet or frame differs from its CPU copy's")
    check(bool(np.all(np.diff(pkt.y[:int(pkt.count)].numpy()) >= 0)),
          f"render_packet: {scene}'s packet is not Y-sorted")
    return k1, eng


def screenshot_phase(eng):
    """``Engine.screenshot`` of the card's world against its CPU copy's:
    the same PNG bytes (the predators scene: decals, shadows, atlas
    sprites, particles, lights and glows)."""
    import os

    from multithreadedgameengine_tpu_torch.render.headless import encode_png

    w, h = SHOT_SIZE
    path = os.path.join("build", "chip_smoke_screenshot.png")
    os.makedirs("build", exist_ok=True)
    t0 = time.perf_counter()
    img = eng.screenshot(path, w, h)
    shot_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        png = f.read()
    os.remove(path)
    with world_on_host(eng):
        host = eng.screenshot(None, w, h)
    same = encode_png(host) == png
    log("screenshot", size=f"{w}x{h}", png_bytes=len(png), seconds=shot_s,
        drawn_px=int((img.std(axis=2) > 5).sum()), png_equal=same)
    check(same, "screenshot: the card's world and its CPU copy give other PNG bytes")
    check(int((img.std(axis=2) > 5).sum()) > 100, "screenshot: nothing drawn")


# ---------------------------------------------------------------------------
# slice F: the process mesh, one slab per process
# ---------------------------------------------------------------------------

#: the staging copies of gloo on a card, the only host reads a dist frame
#: makes (``parallel.dist``), exempt from the sync check
STAGING = "ProcessMesh._to_host,ProcessMesh._to_card"


def dist_cells(inproc):
    """The cells phase 25 runs after the dry run's rungs, in the same four
    processes: each in-process slab run of phases 6, 8 and 12-14 again over
    the process mesh, its frames laid out as the in-process run's (warm-up,
    one frame under the sync check, timed frames, one instrumented frame),
    and the sharded step on balls_10k."""
    from multithreadedgameengine_tpu_torch import dryrun

    boids = dict(scene=boids_engine, args=(HALO_BOIDS_N - 1, HALO_BOIDS_WORLD,
                                           HALO_BOIDS_SPATIAL),
                 kwargs=dict(solver_predicated="off"))
    return [
        (dryrun.halo_cell, dict(name="dist_halo_boids_102k_d4", frames=inproc[
            "halo_boids_102k_d4"]["frames"], warmup=2, oversub=HALO_BOIDS_OVERSUB, **boids)),
        (dryrun.homed_cell, dict(name="dist_homed_boids_102k_d4", frames=inproc[
            "homed_boids_102k_d4"]["frames"], warmup=2, headroom=HOMED_HEADROOM, **boids)),
        (dryrun.halo_cell, dict(name="dist_halo_1m_d4", scene=halo_balls_engine,
                                frames=inproc["halo_1m_d4"]["frames"], warmup=2, oversub=4.0)),
        (dryrun.homed_cell, dict(name="dist_homed_1m_d4", scene=halo_balls_engine,
                                 frames=inproc["homed_1m_d4"]["frames"], warmup=HALO_WARMUP,
                                 headroom=HOMED_HEADROOM)),
        (dryrun.halo_cell, dict(name="dist_halo_mixed", scene=halo_predators_engine,
                                frames=inproc["halo_mixed"]["frames"], warmup=HALO_PRED_WARMUP,
                                oversub=HALO_PRED_OVERSUB)),
        (dryrun.homed_cell, dict(name="dist_homed_mixed", scene=halo_predators_engine,
                                 frames=inproc["homed_mixed"]["frames"],
                                 warmup=HALO_PRED_WARMUP, headroom=HOMED_MIXED_HEADROOM)),
        (dryrun.sharded_cell, dict(name="dist_sharded_balls_10k", scene=dryrun.balls_scene,
                                   args=(N_MAIN,), frames=SHARDED_FRAMES, warmup=2)),
    ]


def sharded_reference(dev, n_ranks):
    """balls_10k's entity-sharded scene through ``Engine.step`` for the
    sharded cell's frames, cut into each rank's rows as ``shard_world``
    cuts them: the digests each rank must report. Returns (digests, steps/s
    of the frames after the first two)."""
    import torch

    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.parallel import ProcessMesh, shard_world

    eng = dryrun.balls_scene(dev, N_MAIN)
    for _ in range(2):
        eng.step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHARDED_FRAMES - 2):
        eng.step(1)
    torch.cuda.synchronize()
    sps = (SHARDED_FRAMES - 2) / (time.perf_counter() - t0)
    # a rank's view of the mesh, for shard_world's cut (no group is joined)
    cuts = [shard_world(eng.world, ProcessMesh(r, n_ranks, dev, "gloo")) for r in range(n_ranks)]
    return [dryrun.leaf_digests(c) for c in cuts], sps


def report_cell(reps, card, expect=None, inproc_sps=None, expected=None):
    """One process-mesh cell's line, and its checks: every rank's chunk
    digests equal to the in-process run's (``expect``, one per slab),
    every rank's replicated leaves alike, no host read in the checked
    frame, and each kernel's launches on every rank as ``expected``
    ({kernel: launches a rank})."""
    r0 = reps[0]
    name = r0["cell"]
    got = [r["digests"][0] for r in reps]
    diff = sorted({k for d, (a, b) in enumerate(zip(got, expect or got))
                   for k in set(a) | set(b) if a.get(k) != b.get(k)})
    replicated_alike = all(r.get("replicated") == r0.get("replicated") for r in reps)
    launches = r0["launches_by_rank"]
    log(name, card=repr(card), ranks=r0["ranks"], backend=r0["backend"], device=r0["device"],
        entities=r0["entities"], frames=r0["frames"], timed_frames=r0["timed_frames"],
        steps_per_s=r0["steps_per_s"], in_process_steps_per_s=inproc_sps,
        bytes_per_frame=r0["bytes_per_frame"], sent_per_frame=r0["sent_per_frame"],
        received_per_frame=r0["received_per_frame"], staged_per_frame=r0["staged_per_frame"],
        mesh_calls_per_frame=r0["mesh_calls_per_frame"], mesh_s=r0["mesh_s"],
        frame_s=r0["frame_s"], mesh_share=r0["mesh_share"],
        bit_equal=bool(expect) and not diff, replicated_alike=replicated_alike,
        frame_without_host_reads=all(r["host_reads_checked"] for r in reps),
        exempt=STAGING if r0["backend"] == "gloo" else "none",
        launches=json.dumps(launches).replace(" ", ""),
        metrics=json.dumps(r0["metrics"]).replace(" ", ""),
        differing=",".join(diff[:8]) or "none", scaling="no (one card)")
    check(expect is not None and len(expect) == len(got) and not diff,
          f"{name}: the process mesh differs from the in-process run: {diff[:8]}")
    check(replicated_alike, f"{name}: the ranks' replicated leaves differ")
    check(all(r["host_reads_checked"] for r in reps), f"{name}: no frame ran under the sync check")
    for k, per_rank in (expected or {}).items():
        check(launches[k] == [per_rank] * r0["ranks"],
              f"{name}: {k} launched {launches[k]} times by rank, expected {per_rank} each")
    m = r0["metrics"]
    for key in ("route_overflow_logic", "route_overflow_solver", "home_violators",
                "nonfinite_count"):
        check(m.get(key, 0) == 0, f"{name}: {key} {m.get(key)}")
    return launches


def dist_phase(dev, inproc):
    """Phases 24 and 25: four gloo ranks on the card (every message staged
    through pinned host memory), started once: the mesh's collectives
    against ``SlabMesh`` (rung 0), every rung of the reference's dry run
    with its asserts, then each in-process slab cell of phases 6, 8 and
    12-14 over the process mesh, bit for bit, and the sharded step on
    balls_10k against ``Engine.step``. Returns each cell's launches by rank
    (phase 27)."""
    from multithreadedgameengine_tpu_torch.dryrun import dryrun_multichip

    card = card_name_and_limit()
    t0 = time.perf_counter()
    reports = dryrun_multichip(DIST_RANKS, "gloo", "cuda", extra=dist_cells(inproc),
                               deadline_s=DIST_DEADLINE_S)
    wall = time.perf_counter() - t0
    by_name = {reps[0]["cell"]: reps for reps in reports}
    # 24. the collectives, bit for bit against SlabMesh on every rank
    col = by_name.pop("0_collectives")
    log("dist_collectives", card=repr(card), ranks=DIST_RANKS, backend="gloo", device="cuda",
        equal=json.dumps([r["equal"] for r in col]).replace(" ", ""),
        staged_bytes=[r["bytes_staged"] for r in col])
    check(all(all(r["equal"].values()) and r["bytes_staged"] > 0 for r in col),
          "dist_collectives: the process mesh differs from SlabMesh")
    # 25. the reference's rungs (their asserts ran on every rank)
    for name in ("1_halo_boids", "1b_halo_mixed", "1c_halo_chunked", "1d_homed_boids",
                 "1e_homed_mixed", "2_sharded_balls"):
        reps = by_name.pop(name)
        check(all(r.get("replicated") == reps[0].get("replicated") for r in reps),
              f"dryrun {name}: the ranks' replicated leaves differ")
    log("dist_dryrun", ranks=DIST_RANKS, rungs=7, seconds=wall)
    sharded_expect, engine_sps = sharded_reference(dev, DIST_RANKS)
    launches = {}
    for key in ("halo_boids_102k_d4", "homed_boids_102k_d4", "halo_1m_d4", "homed_1m_d4",
                "halo_mixed", "homed_mixed"):
        name = f"dist_{key}"
        reps, ref = by_name.pop(name), inproc[key]
        frames = reps[0]["frames"]
        check(frames == ref["frames"],
              f"{name}: {frames} frames, the in-process run {ref['frames']}")
        launches[name] = report_cell(reps, card, ref["digests"], ref["steps_per_s"],
                                     {"K1": 0, "K2": 0, "K3": frames * reps[0]["substeps"]})
    reps = by_name.pop("dist_sharded_balls_10k")
    launches["dist_sharded_balls_10k"] = report_cell(
        reps, card, sharded_expect, engine_sps,
        {"K1": SHARDED_FRAMES * reps[0]["substeps"], "K2": 0, "K3": 0})
    check(not by_name, f"dist: unreported cells {sorted(by_name)}")
    return launches


def nccl_phase(dev):
    """Phase 26: the halo boids cell on NCCL at D = the card count (one
    rank a card), against ``SlabMesh`` at the same D in this process."""
    import torch

    from multithreadedgameengine_tpu_torch import dryrun
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, run_ranks

    count = torch.cuda.device_count()
    cell = dict(name="nccl_halo_boids_102k", scene=boids_engine,
                args=(HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL),
                kwargs=dict(solver_predicated="off"), frames=NCCL_FRAMES, warmup=1,
                oversub=HALO_BOIDS_OVERSUB)
    per_rank = run_ranks(dryrun.run_session, count, "nccl", "cuda",
                         args=([(dryrun.halo_cell, cell)],), deadline_s=DIST_DEADLINE_S,
                         threads=max(1, 8 // count))
    reps = [r[0] for r in per_rank]
    eng = boids_engine(dev, HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL,
                       solver_predicated="off")
    eng._flush_pending()
    step, place = make_halo_step(eng, make_mesh(count, dev), oversub=HALO_BOIDS_OVERSUB)
    chunks, ins = place(eng.world), eng.input.snapshot(dev)
    for _ in range(NCCL_FRAMES):
        chunks, _m = step(chunks, ins)
    print(f"[nccl] world_size={count} (torch.cuda.device_count()); "
          + ("one card: D = 1, so NCCL moves nothing between ranks here"
             if count == 1 else f"{count} cards, one rank each"), flush=True)
    return report_cell(reps, card_name_and_limit(), chunk_digests(chunks), None,
                       {"K1": 0, "K2": 0, "K3": NCCL_FRAMES * reps[0]["substeps"]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.ops import _build

    ck = kernels()
    k1, k1_plain = ck.pair_pass_resident, ck.pair_pass_resident_plain
    k2, k2_plain = ck.pair_pass_symmetric, ck.pair_pass_symmetric_plain

    # 1. card and build
    print(card_name_and_limit(), flush=True)
    fresh = [s.name for s in _build.missing()]
    t0 = time.perf_counter()
    libs = _build.build()
    _build.load()
    log("card", device=repr(torch.cuda.get_device_name(0)), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=round(time.perf_counter() - t0, 3),
        nvcc_ran=",".join(fresh) or "none", flags="'" + " ".join(_build.NVCC_FLAGS) + "'",
        libraries=",".join(str(p.relative_to(_build.BUILD_DIR.parents[1])) for p in libs))
    for lib in libs:
        for line in _build.ptxas_report(lib).splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"[ptxas] {lib.name.rsplit('_', 1)[0]} {line.strip()}", flush=True)
    dev = torch.device("cuda")
    errs = {"K1": [], "K2": []}

    # 2. parity: the demo scene's layout after 30 frames, and a synthetic one
    scene = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    scene.step(30, block=True)
    demo_args = layout_args(scene)
    extent = max(scene.config.world_width, scene.config.world_height)
    bounds = (scene.config.world_width, scene.config.world_height)
    err, (_x, _y, kc) = kernel_vs_plain(k1, k1_plain, "demo_10k", demo_args, extent)
    errs["K1"].append(err)
    contacts_10k = int(kc.sum().item())
    for cb in (None, bounds):
        errs["K2"].append(kernel_vs_plain(k2, k2_plain, "demo_10k", demo_args, extent,
                                          clamp_bounds=cb)[0])
    syn_args, pair = synthetic_args(dev)
    slots = torch.tensor(pair, device=dev)
    for kernel, plain, key, kw in ((k1, k1_plain, "K1", {}), (k2, k2_plain, "K2", {}),
                                   (k2, k2_plain, "K2", dict(clamp_bounds=(300.0, 200.0)))):
        err, (kx, ky, _kc) = kernel_vs_plain(kernel, plain, "synthetic", syn_args, 300.0, **kw)
        errs[key].append(err)
        moved = (kx.view(-1)[slots] != syn_args[0].view(-1)[slots]) | (
            ky.view(-1)[slots] != syn_args[1].view(-1)[slots])
        check(bool(moved.all().item()), f"{key}: the coincident pair was not separated")
        if kw:
            occupied = syn_args[3] != 0
            check(bool(((kx[occupied] >= 0) & (kx[occupied] <= 300.0)).all().item()),
                  "K2's folded clamp left a moving entity outside the world")
    for name, world, cap, n in DENSE_CASES:
        dense_args = dense_layout_args(dev, world, cap, n)
        errs["K1"].append(kernel_vs_plain(k1, k1_plain, name, dense_args, max(world))[0])
        for cb in (None, world):
            errs["K2"].append(kernel_vs_plain(k2, k2_plain, name, dense_args, max(world),
                                              clamp_bounds=cb)[0])
    demo_shape = list(demo_args[0].shape)
    k1_ms_10k, k1_plain_10k = time_kernel(k1, k1_plain, demo_args)
    k2_ms_10k, k2_plain_10k = time_kernel(k2, k2_plain, demo_args)
    # what the host adds: K1 eager, one wrapper call a launch, beside its graph time
    eager, graphed = eager_timer(k1, demo_args, 200), graph_timer(k1, demo_args, 200)
    t_eager, t_graph = [], []
    for _ in range(2):
        t_eager.append(eager())
        t_graph += [graphed(), graphed()]
        t_eager.append(eager())
    k1_eager_10k, k1_graph_10k = statistics.median(t_eager), statistics.median(t_graph)
    del eager, graphed
    log("timing", layout="demo_10k", shape=demo_shape, k1_ms=k1_ms_10k,
        k1_plain_ms=k1_plain_10k, k2_ms=k2_ms_10k, k2_plain_ms=k2_plain_10k,
        k1_eager_ms=k1_eager_10k, k1_graph_ms=k1_graph_10k)
    bound_10k = {"K1": bound(demo_args, contacts_10k, False),
                 "K2": bound(demo_args, contacts_10k, True)}
    del scene, demo_args

    # 3. slice A's main path: bench.py's scene through Engine.step
    eng = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    subs = eng.config.physics.sub_step_count
    zero_counts()
    eng.step(WARMUP, block=True)
    t0 = time.perf_counter()
    for _ in range(CHUNKS):
        eng.step(CHUNK)
    eng.sync()
    dt = time.perf_counter() - t0
    k1_main, k2_main, k3_main = read_counts()
    frames = WARMUP + CHUNKS * CHUNK
    w = eng.world
    ok = finite(w)
    main_sps = CHUNKS * CHUNK / dt
    log("main_10k", balls=N_MAIN, frames=frames, steps_per_s=main_sps,
        k1_launches=k1_main, k2_launches=k2_main, expected_k1=frames * subs,
        layout=list(layout_args(eng)[0].shape),
        solver_overflow=int(eng.metrics["solver_overflow"].item()),
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok, "non-finite positions after the 10k main path")
    check(w.step_count == frames, f"step_count {w.step_count} != {frames}")
    check(k1_main == frames * subs and k2_main == 0 and k3_main == 0,
          f"10k: K1 launched {k1_main}, K2 {k2_main}, K3 {k3_main} times; "
          f"expected {frames * subs}, 0, 0")

    # reference on a small input: the same scene on the card and on the CPU
    small = dict(n_balls=400, seed=SEED, world_width=1200.0, world_height=800.0)
    runs = {}
    for d in ("cuda", "cpu"):
        e = make_balls_engine(device=d, **small)
        e.input.set_mouse(600.0, 700.0)
        e.input.mouse_button(0, True)
        e.step(5)
        runs[d] = e.snapshot()
    a, b = runs["cuda"], runs["cpu"]
    ref_err = max((a.transform.x - b.transform.x).abs().max().item(),
                  (a.transform.y - b.transform.y).abs().max().item())
    ref_bad = int((a.rigid_body.collision_count != b.rigid_body.collision_count).sum())
    log("reference", balls=400, frames=5, max_abs_err_vs_cpu=ref_err, count_mismatch=ref_bad,
        tol=pos_tol(1200.0))
    check(ref_bad == 0 and ref_err <= pos_tol(1200.0),
          "the card's small-scene frames differ from the CPU reference")
    del eng

    # 4. slice B's main path: the ladder's 1M rung with the auto knobs
    big = make_balls_engine(n_balls=1_000_000, seed=SEED, device=dev,
                            world_width=90_000.0, world_height=40_000.0,
                            physics=LADDER_PHYSICS)
    zero_counts()
    big.step(5, block=True)
    t0 = time.perf_counter()
    big.step(20)
    big.sync()
    dt = time.perf_counter() - t0
    k1_big, k2_big, k3_big = read_counts()
    w, plan = big.world, big._plan
    ok = finite(w)
    overflow = int(big.metrics["solver_overflow"].item())
    drift = int(big.metrics["boundary_band_drift"].item())
    log("main_1m", balls=1_000_000, frames=25, steps_per_s=20 / dt, k1_launches=k1_big,
        k2_launches=k2_big, expected_k2=25 * subs, lazy_frames=big.lazy_frames,
        residency=plan.residency, band_vel_bound=plan.band_vel_bound,
        layout=list(w.solver_x.shape), solver_overflow=overflow, boundary_band_drift=drift,
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok, "non-finite positions at 1M")
    check(w.step_count == 25 and k2_big == 25 * subs and k1_big == 0 and k3_big == 0,
          f"1M: K1 launched {k1_big}, K2 {k2_big}, K3 {k3_big} times; "
          f"expected 0, {25 * subs}, 0")
    check(overflow == 0 and drift == 0, f"1M: overflow {overflow}, band drift {drift}")
    check(plan.residency and plan.symmetric and plan.band_vel_bound > 0 and big.lazy_frames > 0,
          "1M: the ladder path did not run resident, banded and lazy with K2")
    big_args = layout_args(big)
    for cb in (None, (90_000.0, 40_000.0)):
        errs["K2"].append(kernel_vs_plain(k2, k2_plain, "ladder_1m", big_args, 90_000.0,
                                          clamp_bounds=cb)[0])
    err, (_x, _y, kc) = kernel_vs_plain(k1, k1_plain, "ladder_1m", big_args, 90_000.0)
    errs["K1"].append(err)
    contacts_1m = int(kc.sum().item())
    big_shape = list(big_args[0].shape)
    k1_ms_1m, k1_plain_1m = time_kernel(k1, k1_plain, big_args, kernel_reps=50, plain_reps=2)
    k2_ms_1m, k2_plain_1m = time_kernel(k2, k2_plain, big_args, kernel_reps=50, plain_reps=2,
                                        clamp_bounds=(90_000.0, 40_000.0))
    log("timing", layout="ladder_1m", shape=big_shape, k1_ms=k1_ms_1m, k1_plain_ms=k1_plain_1m,
        k2_clamp_ms=k2_ms_1m, k2_clamp_plain_ms=k2_plain_1m)
    bound_1m = {"K1": bound(big_args, contacts_1m, False),
                "K2": bound(big_args, contacts_1m, True)}
    del big, big_args

    # 5. residency on against off, 100k balls, the ladder's knobs, mouse down
    frames_100k = 2 * LADDER_PHYSICS["rebin_interval"]
    snaps, lazy = {}, {}
    for residency in ("on", "off"):
        e = make_balls_engine(n_balls=100_000, seed=SEED, device=dev,
                              world_width=9000.0 * 10 ** 0.5, world_height=4000.0 * 10 ** 0.5,
                              physics=dict(LADDER_PHYSICS, position_residency=residency))
        e.input.set_mouse(14_000.0, 6000.0)
        e.input.mouse_button(0, True)
        e.step(frames_100k, block=True)
        check(e._plan.residency == (residency == "on"), f"100k: residency {residency} not run")
        snaps[residency], lazy[residency] = e.snapshot(), e.lazy_frames
    a, b = snaps["on"], snaps["off"]
    same = {f: bool(torch.equal(getattr(c(a), f), getattr(c(b), f)))
            for c, f in ((lambda s: s.transform, "x"), (lambda s: s.transform, "y"),
                         (lambda s: s.rigid_body, "px"), (lambda s: s.rigid_body, "py"),
                         (lambda s: s.rigid_body, "collision_count"))}
    log("residency_100k", frames=frames_100k, lazy_frames_on=lazy["on"], bit_equal=same,
        contacts=int(a.rigid_body.collision_count.sum().item()))
    check(all(same.values()), f"100k: residency on and off differ: {same}")
    del snaps, a, b

    # 6. slice E1's main path: the halo step with K3
    inproc = {}  # the in-process slab runs the process mesh is held against
    halo = halo_phase(dev, inproc)
    errs["K3"] = halo["errs"]

    # 7. slice C1's main path: BASELINE config 3, then the card against the
    # CPU; the boid tick at the benchmark cell's scene
    k1_boids, k1_boids_timing = boids_phase(dev, errs)
    tick = boid_tick_phase(dev)
    errs["boid_tick"] = [tick["max_abs_err"]]

    # 8. the halo step's boids scene
    k3_boids, k3_boids_timing = halo_boids_phase(dev, errs, inproc)

    # 9. K4 at the probe's shapes
    k4 = k4_phase(dev)
    errs["K4"] = k4["errs"]

    # 10. slice C2's main path: BASELINE config 4, then the card against the CPU
    k1_pred, k1_pred_timing = predators_phase(dev, errs)

    # 11. slice C3's main path: config 4 with events, then the card against
    # the CPU and the chunked log against frame-by-frame dispatch
    k1_events = predators_events_phase(dev)
    events_reference(dev)
    events_chunk(dev)

    # 12. slice E2: the mixed halo passes at scale, then against Engine.step
    k3_pred, halo_run = halo_predators_phase(dev, inproc)
    slab_events_reference(dev)

    # 13. the homed step: the 1M rung, K3 on its short band, 100k bit-equality
    k3_homed, homed_timing = homed_phase(dev, halo["steps_per_s"], errs, inproc)

    # 14. the mixed scene under the homed step, against phase 12's run
    k3_homed_mixed = homed_mixed_phase(dev, halo_run, inproc)
    del halo_run

    # 15-19. slice D1: BASELINE config 2 through run_plan, then the plan
    # against immediate ops, residency on and off, events and checkpoints
    k1_churn = churn_phase(dev)
    k1_plan_small = plan_vs_immediate(dev)
    plan_100k = plan_resident_100k(dev)
    k1_plan_events = plan_events(dev)
    k1_checkpoint = checkpoint_phase(dev)

    # 20-23. slices C4 and D2: the neighbour-list solver, then the render
    # server in front of the balls and predators scenes, their packets and
    # frames against their CPU copies', and a screenshot
    neighbors_phase(dev, main_sps)
    k1_render_balls, eng = render_server_phase(dev, "balls_10k", errs)
    del eng
    k1_render_pred, eng = render_server_phase(dev, "predators_15k", errs)
    screenshot_phase(eng)
    del eng

    # 24-26. slice F: the process mesh (four gloo ranks on the card, then
    # NCCL at the card count), the kernels built above before any rank starts
    torch.cuda.empty_cache()
    dist_launches = dist_phase(dev, inproc)
    nccl_launches = nccl_phase(dev)
    # 27. the ranks' launches, gathered to rank 0, into the kernel line
    k3_dist = {f"launches_{name}": v["K3"] for name, v in dist_launches.items()
               if name != "dist_sharded_balls_10k"}
    k3_dist["launches_nccl_halo_boids_102k"] = nccl_launches["K3"]

    def entry(key, kernel, source, replaces, launches, ms, plain_ms, b, extra,
              library_ms=None):
        return {"name": f"{key} {kernel.__name__}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs[key]), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms, **extra}

    print(json.dumps({"kernels": [
        entry("K1", k1, "multithreadedgameengine_tpu_torch/csrc/pair_pass_resident.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:654", k1_main,
              k1_ms_10k, k1_plain_10k, bound_10k["K1"],
              {"shape": demo_shape, "eager_ms": k1_eager_10k, "shape_1m": big_shape,
               "ms_1m": k1_ms_1m, "plain_ms_1m": k1_plain_1m,
               "bound_ms_1m": bound_1m["K1"][0], "launches_boids_15k": k1_boids,
               **k1_boids_timing, "launches_predators_15k": k1_pred, **k1_pred_timing,
               "launches_predators_events": k1_events, "launches_churn_10k": k1_churn,
               "launches_plan_vs_immediate": k1_plan_small,
               "launches_plan_resident_100k": {f"{k}_{r}": v[0] for (k, r), v in
                                               plan_100k.items()},
               "launches_plan_events": k1_plan_events, "launches_checkpoint": k1_checkpoint,
               "launches_render_balls_10k": k1_render_balls,
               "launches_render_predators_15k": k1_render_pred,
               "launches_dist_sharded_balls_10k":
                   dist_launches["dist_sharded_balls_10k"]["K1"]}),
        entry("K2", k2, "multithreadedgameengine_tpu_torch/csrc/pair_pass_symmetric.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:162", k2_big,
              k2_ms_1m, k2_plain_1m, bound_1m["K2"],
              {"shape": big_shape, "shape_10k": demo_shape, "ms_10k": k2_ms_10k,
               "plain_ms_10k": k2_plain_10k, "bound_ms_10k": bound_10k["K2"][0],
               "launches_plan_resident_100k": {f"{k}_{r}": v[1] for (k, r), v in
                                               plan_100k.items()}}),
        entry("K3", ck.pair_pass_grid, "multithreadedgameengine_tpu_torch/csrc/pair_pass_grid.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:793", halo["launches"],
              halo["ms"], halo["plain_ms"], halo["bound"],
              {"shape": halo["shape"], "shape_10k": halo["shape_10k"], "ms_10k": halo["ms_10k"],
               "plain_ms_10k": halo["plain_ms_10k"], "bound_ms_10k": halo["bound_ms_10k"],
               "launches_halo_boids": k3_boids, **k3_boids_timing,
               "launches_halo_predators": k3_pred, "launches_homed_mixed": k3_homed_mixed,
               **homed_timing, **k3_dist}),
        entry("K4", ck.expand, "multithreadedgameengine_tpu_torch/csrc/expand.cu",
              "benchmarks/probe_expand_kernel.py:74", k4["launches"], k4["ms"],
              k4["plain_ms"], k4["bound"], {"shape": k4["shape"]},
              library_ms=k4["library_ms"]),
        entry("boid_tick", ck.boid_tick, "multithreadedgameengine_tpu_torch/csrc/boid_tick.cu",
              "none (the JAX package's tick is XLA)", CELL_BOIDS_FRAMES, tick["ms"],
              tick["plain_ms"], tick["bound"],
              {"shape": tick["shape"], "gathered_ms": tick["gathered_ms"],
               "bound_full_ms": tick["bound_full_ms"], "live_share": tick["live_share"]}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
