#!/usr/bin/env python3
"""Where mixed_1m.chunk30's check gaps come from, row by row, on one NVIDIA
GPU: the benchmark's 1M mixed scene (``bench_port/configs/mixed_1m.json``,
built by ``bench_port/scenes/mixed.py`` from each seed) stepped from its
start with the prey tick kernel (``ops.cuda_kernels.prey_tick``, the
program as it runs) and again with its plain version
(``prey_tick_plain``, the torch composition the kernel replaced).

    python3 mixed_drift.py --seeds 3721000011,3721000023 [--out build/mixed_drift.jsonl]

For each seed and each tick it takes the world after the first call of
``frames_per_call`` frames (the cell's traffic, no mouse) against
``bench_port/reference/mixed.py::run`` from the reference's own start,
which is what the check's ``start_gap`` reads; and the two ticks' worlds
against each other after 1, 2 and 3 such calls. Each comparison is the
largest of |x| and |y| per spawned row, summarised as its largest value,
the rows over 0.01, 0.1 and 1 world units and the eight largest rows with
their entity type. One JSON line a seed, also appended to ``--out``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CELL, CALLS = "mixed_1m.chunk30", 3


def run(cfg, seed, frames, device, plain):
    """The scene of ``seed`` stepped ``CALLS`` calls of ``frames`` frames
    with the kernel or (``plain``) the plain version as the prey tick.
    Returns the start's capture, each call's x and y (float64, on the
    host), the scene's draws and rows, and each row's entity type."""
    import torch

    from bench_port.scenes import mixed
    from bench_port.scenes.common import capture
    from multithreadedgameengine_tpu_torch.models import predators
    from multithreadedgameengine_tpu_torch.ops import cuda_kernels

    real = predators.prey_tick
    if plain:
        predators.prey_tick = cuda_kernels.prey_tick_plain
    try:
        built = mixed.build(cfg, seed, device)
        eng = built.engine
        pre = capture(eng)
        posts = []
        for _ in range(CALLS):
            eng.step(frames)
            t = eng.world.transform
            posts.append(torch.stack([t.x, t.y]).double().cpu())
        kind = eng.world.transform.entity_type.cpu()
        out = (pre, posts, built.inputs, built.rows, built.n_rows, kind)
        del eng, built
        torch.cuda.empty_cache()
        return out
    finally:
        predators.prey_tick = real


def describe(d, rows, kind) -> dict:
    """A per-row gap over the spawned rows: largest, counts over
    thresholds, the eight largest as (row, entity type, gap)."""
    import torch

    d, k = d[rows], kind[rows]
    top = torch.argsort(d, descending=True)[:8]
    return {"max": float(d.max()), "over_0.01": int((d > 0.01).sum()),
            "over_0.1": int((d > 0.1).sum()), "over_1": int((d > 1).sum()),
            "top": [(int(rows[i]), int(k[i]), float(d[i])) for i in top]}


def main() -> int:
    import torch

    from bench_port.harness import cell, load_config, load_spec, load_traffic, module

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, as bench_port/run.py takes them")
    ap.add_argument("--out", default="build/mixed_drift.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mixed_drift: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    entry = cell(load_spec(), CELL)
    cfg = load_config(entry[1])
    frames = load_traffic(entry[0]["traffic"])["frames_per_call"]
    ref = module("reference", cfg["reference"])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        kpre, kposts, inputs, rows, n_rows, kind = run(cfg, seed, frames, dev, plain=False)
        _ppre, pposts, *_ = run(cfg, seed, frames, dev, plain=True)
        rows_t = torch.as_tensor(rows)
        s0 = ref.initial_state(cfg, inputs, rows, n_rows, dev, torch.float32)
        still = dict(mouse_x=0.0, mouse_y=0.0, mouse_down=False)
        r = ref.run(cfg, s0, [still] * frames, kpre["step"])
        rxy = torch.stack([r["x"], r["y"]]).double().cpu()
        del r, s0
        line = {"seed": seed, "frames_per_call": frames}
        for name, posts in (("kernel", kposts), ("plain", pposts)):
            line[f"{name}_vs_reference_{frames}"] = describe(
                (posts[0] - rxy).abs().max(0).values, rows_t, kind)
        for c in range(CALLS):
            line[f"kernel_vs_plain_{frames * (c + 1)}"] = describe(
                (kposts[c] - pposts[c]).abs().max(0).values, rows_t, kind)
        text = json.dumps(line)
        with out.open("a") as f:
            f.write(text + "\n")
        print(text, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
