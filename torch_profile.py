#!/usr/bin/env python3
"""The port's scenes without a benchmark cell, and where their time goes on
one NVIDIA GPU.

    python3 torch_profile.py [--frames 20] [--cells a,b] [--out build/torch_profile.json]

The scenes are built in ``torch_scenes.py``, where the card tests
(``tests/test_torch_cuda_scenes.py``) and ``chip_smoke.py``'s kernel table
take them too. The cells: the demo scene
(``balls_10k``, 10,000 balls, ``bench.py``'s scene), the JAX ladder's 1M
rung (``balls_1m_ladder``, ``benchmarks/run_ladder.py:84-93``, the auto
knobs), BASELINE config 3 (``boids_15k``, ``run_ladder.py:166-188``),
BASELINE config 4 (``predators_15k``: the predators demo's operating
point, the camera zoomed out) and the same with events on
(``predators_15k_events``: ``logic.collision_events``, ``event_chunk`` 60,
``event_overlap``, as the ladder's ``rung_predators`` runs it), all through
``Engine.step``; the halo rungs of ``benchmarks/halo_scaling.py`` on 4
slabs of one card through ``parallel.make_halo_step`` (``halo_1m_d4``, the
1M balls scene; ``halo_boids_102k_d4``, the 102,400-boid scene;
``halo_predators_d4``, the 25,600-entity mixed scene) and the 1M balls
scene through ``parallel.make_homed_step`` (``homed_1m_d4``); BASELINE
config 2 (``churn_10k``: the demo scene churning 256 despawns and 256
spawns a frame through ``FramePlan`` and ``Engine.run_plan`` in chunks of
30, as ``rung_churn`` runs it; a chunk's wall time includes building its
plan); the demo scene with the render server's publish every 2 steps, the
camera over the whole world (``render_balls_10k``; no HTTP client); and
the demo scene on the neighbour-list solver (``neighbors_10k``). The
benchmark's cells are ``bench_port/``'s.

Each cell warms up, then:

- three chunks of ``--frames`` frames are timed with the host clock, each
  ending in ``torch.cuda.synchronize`` (profiler off);
- one more chunk runs under ``torch.profiler``, reduced as the benchmark
  reduces its traced window (``bench_port.spans.traced_spans``): the
  device's busy time, its operations and the operations that took most
  time (``bench_port.trace.reduce_events``), and each span's device ms,
  operations and host self ms a frame (the neighbour build is
  ``ops.spatial``, the stamp loop ``ops.decals``, the event difference
  ``ops.events``; the slab and homed steps open no span, so their work is
  ``between_spans``);
- render_balls_10k's ``encode_frame`` alone (the frame's extraction,
  compaction and one copy to the host) is timed on the device
  (``bench_port.trace.device_seconds``);
- predators_15k_events times each host read and dispatch of a chunk's
  event log on the host clock, and reports its bytes.

It prints, per cell, wall ms/step (median of the three chunks), the
device's busy ms/step and share over the profiled chunk, device
operations per step, the top operations and the spans' table, and writes
the same as JSON to ``--out``. The profile fails rather than report when it
saw no device activity. Run it from the repo's root. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from torch_scenes import (
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
    HALO_PRED_OVERSUB,
    HALO_SLABS,
    HOMED_HEADROOM,
    LADDER_PHYSICS,
    N_MAIN,
    SEED,
    boids_engine,
    card_name_and_limit,
    churn_frames,
    halo_balls_engine,
    halo_predators_engine,
    predators_engine,
)


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------

CELLS = {
    "balls_10k": dict(n_balls=N_MAIN, seed=SEED),
    "balls_1m_ladder": dict(n_balls=1_000_000, seed=SEED, world_width=90_000.0,
                            world_height=40_000.0, physics=LADDER_PHYSICS),
    "halo_1m_d4": dict(halo="balls"),
    "boids_15k": dict(boids=True),
    "predators_15k": dict(predators=True),
    "predators_15k_events": dict(predators=True, events=True),
    "halo_boids_102k_d4": dict(halo="boids"),
    "halo_predators_d4": dict(halo="predators"),
    "homed_1m_d4": dict(halo="balls", homed=True),
    "churn_10k": dict(n_balls=N_MAIN, seed=SEED, churn=True),
    "render_balls_10k": dict(n_balls=N_MAIN, seed=SEED, render=True),
    "neighbors_10k": dict(n_balls=N_MAIN, seed=SEED, physics=dict(solver="neighbors")),
}


def engine_runner(kw: dict):
    """``run(frames)`` through ``Engine.step``, what its plan picked, and
    the parts timed alone ({name: fn}: ``encode_frame`` behind the render
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
    if kw.get("boids"):
        eng = boids_engine("cuda", BOIDS_N, BOIDS_WORLD, CONFIG3_SPATIAL)
    elif kw.get("predators"):
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

    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
    )

    if kw["halo"] == "boids":
        eng = boids_engine("cuda", HALO_BOIDS_N - 1, HALO_BOIDS_WORLD, HALO_BOIDS_SPATIAL)
        eng._flush_pending()
        oversub = HALO_BOIDS_OVERSUB
    elif kw["halo"] == "predators":
        eng, oversub = halo_predators_engine("cuda"), HALO_PRED_OVERSUB
    else:
        eng, oversub = halo_balls_engine("cuda"), 4.0
    mesh = make_mesh(HALO_SLABS, "cuda")
    if kw.get("homed"):
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


def profile_cell(name: str, kw: dict, frames: int) -> dict:
    from bench_port.spans import traced_spans
    from bench_port.trace import device_seconds

    run, info, alone = (halo_runner if "halo" in kw else engine_runner)(kw)
    run(frames)  # warm-up: the first rebin, the kernel build
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(frames)
        walls.append((time.perf_counter() - t0) / frames)
    lazy0 = info()["lazy_frames"]
    t0 = time.perf_counter()
    spans = traced_spans(lambda: run(frames) or frames)
    wall_on = time.perf_counter() - t0
    tr = spans.trace
    picked = info()
    out = {
        "cell": name,
        "frames": frames,
        "wall_ms_per_step": statistics.median(walls) * 1e3,
        "wall_ms_per_step_all": [w * 1e3 for w in walls],
        "wall_ms_per_step_profiled": wall_on / frames * 1e3,
        "device_ms_per_step": tr.busy_s / frames * 1e3,
        "busy_share": tr.busy_s / tr.window_s,
        "device_ops_per_step": tr.device_ops / frames,
        "kernel": picked["kernel"],
        "residency": picked["residency"],
        "lazy_frames_in_profiled_chunk": picked["lazy_frames"] - lazy0,
        **({"event_log": picked["event_log"]} if "event_log" in picked else {}),
        "top": [{"name": n[:90], "ms_per_step": s / frames * 1e3, "share": s / tr.busy_s}
                for n, s in tr.top_ops],
        "spans": {path: {"device_ms_per_step": r.device_ns / 1e6 / frames,
                         "device_ops_per_step": r.device_ops / frames,
                         "host_self_ms_per_step": r.host_self_ns / 1e6 / frames}
                  for path, r in sorted(spans.rows.items())},
        "spans_table": spans.table(),
    }
    for part, fn in alone.items():
        part_s = device_seconds(fn, frames)
        out[f"{part}_device_ms"] = part_s * 1e3
        out[f"{part}_share"] = part_s * frames / tr.busy_s
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
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
        r = profile_cell(name, CELLS[name], args.frames)
        results["cells"].append(r)
        print(f"[{name}] kernel={r['kernel']} residency={r['residency']} "
              f"wall_ms_per_step={r['wall_ms_per_step']:.4f} "
              f"(chunks {', '.join(f'{w:.4f}' for w in r['wall_ms_per_step_all'])}; "
              f"profiled {r['wall_ms_per_step_profiled']:.4f}) "
              f"device_ms_per_step={r['device_ms_per_step']:.4f} "
              f"busy_share={r['busy_share']:.3f} "
              f"device_ops_per_step={r['device_ops_per_step']:.1f}"
              + (f" encode_frame_device_ms={r['encode_frame_device_ms']:.4f} "
                 f"encode_frame_share={r['encode_frame_share']:.3f}"
                 if "encode_frame_share" in r else "")
              + (f" event_log={json.dumps(r['event_log'])}" if "event_log" in r else ""),
              flush=True)
        for t in r["top"]:
            print(f"    {t['ms_per_step']:9.4f} ms/step {t['share'] * 100:5.1f}%  {t['name']}",
                  flush=True)
        print(r["spans_table"], flush=True)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
