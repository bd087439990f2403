#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 torch_profile.py [--frames 20] [--cells a,b] [--out build/torch_profile.json]

For each cell -- the demo scene (10,000 balls, ``bench.py``'s scene), the
JAX ladder's 1M rung (``benchmarks/run_ladder.py:84-93``, the auto knobs),
BASELINE config 3 (``boids_15k``, ``chip_smoke.py`` phase 7: 15,000
boids, ``run_ladder.py:166-188``) and BASELINE config 4
(``predators_15k``, ``chip_smoke.py`` phase 10: the predators demo's
operating point, camera zoomed out) through ``Engine.step``, the same
scene with events on (``predators_15k_events``, ``chip_smoke.py`` phase 11:
``logic.collision_events``, ``event_chunk`` 60, ``event_overlap``, as the
JAX ladder's ``rung_predators`` runs it), and the halo
rungs (``chip_smoke.py`` phases 6, 8 and 12: the 1M balls scene, the
102,400-boid scene and the 25,600-entity mixed predators scene of
``benchmarks/halo_scaling.py`` on 4 slabs of one card) through
``parallel.make_halo_step``, and the 1M balls scene through
``parallel.make_homed_step`` (``homed_1m_d4``, phase 13), and BASELINE
config 2 (``churn_10k``, phase 15: the demo scene churning 256 despawns and
256 spawns a frame through ``FramePlan`` and ``Engine.run_plan`` in chunks
of 30, as ``run_ladder.py``'s ``rung_churn`` runs it; a chunk's wall time
includes building its plan), the demo scene with the render server's
publish every 2 steps as ``server/render_server.py``'s ``run_scene`` drives
it, the camera over the whole world (``render_balls_10k``, ``chip_smoke.py``
phase 21; no HTTP client), and the demo scene on the neighbour-list solver
(``neighbors_10k``, ``solver="neighbors"``, phase 20) -- it warms up, then:

- times three chunks of ``--frames`` frames with the host clock, each
  ending in ``torch.cuda.synchronize`` (profiler off);
- profiles one more chunk with ``torch.profiler`` (CPU and CUDA activities)
  and sums device time by kernel name;
- reduces that chunk's trace by the engine's spans (``profiling.span``,
  through ``bench_port/spans.py``): each span's device ms, operations and
  host self ms a frame (the neighbour build is ``ops.spatial``, the stamp
  loop ``ops.decals``, the event difference ``ops.events``; the slab and
  homed steps open no span, so their work is ``between_spans``);
- for render_balls_10k, profiles ``--frames`` calls of ``encode_frame``
  alone (the frame's extraction, compaction and one copy to the host);
- for predators_15k_events, times each host read and dispatch of a chunk's
  event log (the copy's wait, the hooks, the emissions they queue landing
  in the pool) on the host clock, and reports its bytes.

It prints, per cell, wall ms/step (median of the three chunks, profiler
off), device ms/step and the device's busy share over the profiled chunk,
device operations per step, the top device kernels and the spans' table,
and writes the same as JSON to ``--out``. Device numbers come from the
profiler's CUDA activity; the script fails rather than report them if the
profiler saw no device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import (
    BALLS_CAMERA,
    BOIDS_N,
    BOIDS_WORLD,
    CHURN,
    CHURN_CHUNK,
    CONFIG3_SPATIAL,
    EVENTS_LOGIC,
    HALO_BOIDS_N,
    HALO_BOIDS_OVERSUB,
    HALO_BOIDS_SPATIAL,
    HALO_BOIDS_WORLD,
    HALO_N,
    HALO_PRED_OVERSUB,
    HALO_SLABS,
    HALO_WORLD,
    HOMED_HEADROOM,
    LADDER_PHYSICS,
    boids_engine,
    card_name_and_limit,
    churn_frames,
    halo_predators_engine,
    predators_engine,
)

CELLS = {
    "balls_10k": dict(n_balls=10_000, seed=123456),
    "balls_1m_ladder": dict(n_balls=1_000_000, seed=123456, world_width=90_000.0,
                            world_height=40_000.0, physics=LADDER_PHYSICS),
    "halo_1m_d4": dict(n_balls=HALO_N - 1, seed=123456, world_width=HALO_WORLD[0],
                       world_height=HALO_WORLD[1]),
    "boids_15k": dict(boids=BOIDS_N),
    "predators_15k": dict(predators=True),
    "predators_15k_events": dict(predators=True, events=True),
    "halo_boids_102k_d4": dict(boids=HALO_BOIDS_N - 1),
    "halo_predators_d4": dict(predators=True),
    "homed_1m_d4": dict(homed=True, n_balls=HALO_N - 1, seed=123456,
                        world_width=HALO_WORLD[0], world_height=HALO_WORLD[1]),
    "churn_10k": dict(n_balls=10_000, seed=123456, churn=True),
    "render_balls_10k": dict(n_balls=10_000, seed=123456, render=True),
    "neighbors_10k": dict(n_balls=10_000, seed=123456, physics=dict(solver="neighbors")),
}


def engine_runner(kw: dict):
    """``run(frames)`` through ``Engine.step``, what its plan picked, and
    the parts profiled alone ({name: fn}: ``encode_frame`` behind the render
    server, which opens no span)."""
    import numpy as np

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.server.render_server import (
        RenderServer,
        encode_frame,
    )

    kw = dict(kw)
    churn = kw.pop("churn", False)
    render = kw.pop("render", False)
    if "boids" in kw:
        eng = boids_engine("cuda", kw["boids"], BOIDS_WORLD, CONFIG3_SPATIAL)
    elif "predators" in kw:
        eng = predators_engine("cuda", **({"logic": EVENTS_LOGIC} if kw.get("events") else {}))
    else:
        eng = make_balls_engine(device="cuda", **kw)
    rng = np.random.default_rng(7)
    if render:
        eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = BALLS_CAMERA
        # publish() alone: the server's socket is not needed
        srv = RenderServer(eng, port=0)
        srv.httpd.server_close()

    def run(frames):
        if churn:
            churn_frames(eng, rng, frames, CHURN, CHURN_CHUNK)
        elif render:
            for _ in range(frames // 2):
                eng.step(2)
                srv.publish()
        else:
            eng.step(frames)
        eng.sync()

    reads = []  # (host seconds, log bytes, frames) of each chunk's dispatch
    if kw.get("events"):
        dispatch = eng._dispatch_logged_events

        def timed_dispatch(log):
            t0 = time.perf_counter()
            dispatch(log)
            reads.append((time.perf_counter() - t0, log.buf.numel() * 4, log.k))

        eng._dispatch_logged_events = timed_dispatch

    def info():
        plan = eng._plan
        out = {"kernel": ("none" if plan.solver_geom is None  # the neighbour-list solver
                          else "K2" if plan.symmetric else "K1"),
               "residency": eng._plan.residency, "lazy_frames": eng.lazy_frames}
        if reads:
            out["event_log"] = {
                "chunks_read": len(reads),
                "bytes_per_chunk": reads[-1][1],
                "frames_per_chunk": reads[-1][2],
                "dispatch_ms_per_chunk_median": statistics.median(r[0] for r in reads) * 1e3,
                "dispatch_ms_per_chunk_max": max(r[0] for r in reads) * 1e3,
            }
        return out

    alone = {"encode_frame": lambda: encode_frame(eng)} if render else {}
    return run, info, alone


def halo_runner(kw: dict):
    """``run(frames)`` through the halo step on ``HALO_SLABS`` slabs, or
    through the homed step (``homed``, headroom ``HOMED_HEADROOM``)."""
    import torch

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
    )

    kw = dict(kw)
    homed = kw.pop("homed", False)
    if "boids" in kw:
        eng = boids_engine("cuda", kw["boids"], HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL)
        oversub = HALO_BOIDS_OVERSUB
    elif "predators" in kw:
        eng = halo_predators_engine("cuda")
        oversub = HALO_PRED_OVERSUB
    else:
        eng = make_balls_engine(device="cuda", **kw)
        oversub = 4.0
    eng._flush_pending()
    mesh = make_mesh(HALO_SLABS, "cuda")
    if homed:
        step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=HOMED_HEADROOM)
        state = list(place(eng.world))
    else:
        step, place = make_halo_step(eng, mesh, oversub=oversub)
        state = [place(eng.world)]
    ins = eng.input.snapshot("cuda")

    def run(frames):
        for _ in range(frames):
            *state[:], _m = step(*state, ins)
        torch.cuda.synchronize()

    return run, lambda: {"kernel": "K3", "residency": False, "lazy_frames": 0}, {}


def device_us(prof):
    """[(device us, calls, kernel name)] of a profile, and their sum. A
    span's annotation on the device's timeline (the engine's
    ``record_function`` ranges) is no kernel."""
    import torch

    spans = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    by_kernel = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
                 if ev.self_device_time_total > 0 and ev.key not in spans
                 and ev.device_type == torch.autograd.DeviceType.CUDA]
    return by_kernel, sum(k[0] for k in by_kernel)


def profile_cell(name: str, kw: dict, frames: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench_port.spans import profile_events, reduce_spans
    from bench_port.trace import WINDOW

    run, info, alone = (halo_runner if name.startswith(("halo", "homed"))
                        else engine_runner)(kw)
    run(frames)  # warm-up: the first rebin, the kernel build
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(frames)
        walls.append((time.perf_counter() - t0) / frames)
    lazy0 = info()["lazy_frames"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            run(frames)
            wall_on = time.perf_counter() - t0
    by_kernel, total_us = device_us(prof)
    spans = reduce_spans(profile_events(prof), frames)
    n_ops = sum(k[1] for k in by_kernel)
    if total_us <= 0:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    by_kernel.sort(reverse=True)
    picked = info()
    out = {
        "cell": name,
        "frames": frames,
        "wall_ms_per_step": statistics.median(walls) * 1e3,
        "wall_ms_per_step_all": [w * 1e3 for w in walls],
        "wall_ms_per_step_profiled": wall_on / frames * 1e3,
        "device_ms_per_step": total_us / frames / 1e3,
        "busy_share": total_us / 1e6 / wall_on,
        "device_ops_per_step": n_ops / frames,
        "kernel": picked["kernel"],
        "residency": picked["residency"],
        "lazy_frames_in_profiled_chunk": picked["lazy_frames"] - lazy0,
        **({"event_log": picked["event_log"]} if "event_log" in picked else {}),
        "top": [
            {"name": k[:90], "ms_per_step": us / frames / 1e3, "calls_per_step": c / frames,
             "share": us / total_us}
            for us, c, k in by_kernel[:top]
        ],
        "spans": {path: {"device_ms_per_step": r.device_ns / 1e6 / frames,
                         "device_ops_per_step": r.device_ops / frames,
                         "host_self_ms_per_step": r.host_self_ns / 1e6 / frames}
                  for path, r in sorted(spans.rows.items())},
        "spans_table": spans.table(),
    }
    for part, fn in alone.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                fn()
            torch.cuda.synchronize()
        part_k, part_us = device_us(prof)
        out[f"{part}_device_ms"] = part_us / frames / 1e3
        out[f"{part}_device_ops"] = sum(k[1] for k in part_k) / frames
        out[f"{part}_share"] = part_us / total_us
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells to profile (default: all)")
    ap.add_argument("--out", default="build/torch_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = card_name_and_limit()
    print(smi, flush=True)
    results = {"card": smi, "torch": torch.__version__, "cells": []}
    for name in args.cells.split(","):
        r = profile_cell(name, CELLS[name], args.frames, args.top)
        results["cells"].append(r)
        print(f"[{name}] kernel={r['kernel']} residency={r['residency']} "
              f"wall_ms_per_step={r['wall_ms_per_step']:.4f} "
              f"(chunks {', '.join(f'{w:.4f}' for w in r['wall_ms_per_step_all'])}; "
              f"profiled {r['wall_ms_per_step_profiled']:.4f}) "
              f"device_ms_per_step={r['device_ms_per_step']:.4f} "
              f"busy_share={r['busy_share']:.3f} "
              f"device_ops_per_step={r['device_ops_per_step']:.1f}"
              + "".join(f" {part}_device_ms={r[part + '_device_ms']:.4f} "
                        f"{part}_device_ops={r[part + '_device_ops']:.1f} "
                        f"{part}_share={r[part + '_share']:.3f}"
                        for part in ("encode_frame",) if part + "_share" in r)
              + (f" event_log={json.dumps(r['event_log'])}" if "event_log" in r else ""),
              flush=True)
        for t in r["top"]:
            print(f"    {t['ms_per_step']:9.4f} ms/step {t['share'] * 100:5.1f}% "
                  f"x{t['calls_per_step']:.1f}  {t['name']}", flush=True)
        print(r["spans_table"], flush=True)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
