#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 torch_profile.py [--frames 20] [--out build/torch_profile.json]

For each cell -- the demo scene (10,000 balls, ``bench.py``'s scene) and the
JAX ladder's 1M rung (``benchmarks/run_ladder.py:84-93``, the auto knobs) --
it warms up, then:

- times three chunks of ``--frames`` frames through ``Engine.step`` with the
  host clock, each ending in ``torch.cuda.synchronize`` (profiler off);
- profiles one more chunk with ``torch.profiler`` (CPU and CUDA activities)
  and sums device time by kernel name.

It prints, per cell, wall ms/step (median of the three chunks, profiler
off), device ms/step and the device's busy share over the profiled chunk,
device operations per step, and the top device kernels, and writes the same
as JSON to ``--out``. Device numbers come from the profiler's CUDA
activity; the script fails rather than report them if the profiler saw no
device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import LADDER_PHYSICS, card_name_and_limit

CELLS = {
    "balls_10k": dict(n_balls=10_000, seed=123456),
    "balls_1m_ladder": dict(n_balls=1_000_000, seed=123456, world_width=90_000.0,
                            world_height=40_000.0, physics=LADDER_PHYSICS),
}


def profile_cell(name: str, kw: dict, frames: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(device="cuda", **kw)
    eng.step(frames, block=True)  # warm-up: the first rebin, the kernel build
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.step(frames)
        eng.sync()
        walls.append((time.perf_counter() - t0) / frames)
    lazy0 = eng.lazy_frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(frames)
        eng.sync()
        wall_on = time.perf_counter() - t0
    events = prof.key_averages()
    by_kernel = []
    device_us = 0.0
    n_ops = 0
    for ev in events:
        us = ev.self_device_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel.append((us, ev.count, ev.key))
            device_us += us
            n_ops += ev.count
    if device_us <= 0:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    by_kernel.sort(reverse=True)
    plan = eng._plan
    out = {
        "cell": name,
        "frames": frames,
        "wall_ms_per_step": statistics.median(walls) * 1e3,
        "wall_ms_per_step_all": [w * 1e3 for w in walls],
        "wall_ms_per_step_profiled": wall_on / frames * 1e3,
        "device_ms_per_step": device_us / frames / 1e3,
        "busy_share": device_us / 1e6 / wall_on,
        "device_ops_per_step": n_ops / frames,
        "kernel": "K2" if plan.symmetric else "K1",
        "residency": plan.residency,
        "lazy_frames_in_profiled_chunk": eng.lazy_frames - lazy0,
        "top": [
            {"name": k[:90], "ms_per_step": us / frames / 1e3, "calls_per_step": c / frames,
             "share": us / device_us}
            for us, c, k in by_kernel[:top]
        ],
    }
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default="build/torch_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = card_name_and_limit()
    print(smi, flush=True)
    results = {"card": smi, "torch": torch.__version__, "cells": []}
    for name, kw in CELLS.items():
        r = profile_cell(name, kw, args.frames, args.top)
        results["cells"].append(r)
        print(f"[{name}] kernel={r['kernel']} residency={r['residency']} "
              f"wall_ms_per_step={r['wall_ms_per_step']:.4f} "
              f"(chunks {', '.join(f'{w:.4f}' for w in r['wall_ms_per_step_all'])}; "
              f"profiled {r['wall_ms_per_step_profiled']:.4f}) "
              f"device_ms_per_step={r['device_ms_per_step']:.4f} "
              f"busy_share={r['busy_share']:.3f} "
              f"device_ops_per_step={r['device_ops_per_step']:.1f}", flush=True)
        for t in r["top"]:
            print(f"    {t['ms_per_step']:9.4f} ms/step {t['share'] * 100:5.1f}% "
                  f"x{t['calls_per_step']:.1f}  {t['name']}", flush=True)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
