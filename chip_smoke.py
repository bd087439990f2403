#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``multithreadedgameengine_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, each printing one line before the last:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions, and
   the nvcc build of the kernels from ``multithreadedgameengine_tpu_torch/
   csrc`` (sm_90a);
2. kernel parity: K1 (the pair pass) against its plain PyTorch version on the
   card, on the demo scene's layout after 30 frames and on a synthetic layout
   with statics, triggers, a world-edge pile, a coincident pair and a full
   cell; then both timed with CUDA events;
3. main path: the ``bench.py`` scene (10,000 balls, seed 123456) for 10 + 120
   frames through ``Engine.step``, with the launch count of every kernel over
   exactly that run; then a 400-ball scene on the card against the same
   scene on the CPU (plain versions) as the reference;
4. scale: 1,000,000 balls in the ladder's world (90000 x 40000,
   ``solver_capacity`` 12) for 5 + 20 frames, and K1 against its plain
   version at that layout.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises, exits
non-zero and prints no result. Without a CUDA device it exits 1 at once.
This script imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_MAIN = 10_000
SEED = 123456
WARMUP, CHUNK, CHUNKS = 10, 30, 4

# K1 against its plain version: contact counts must match exactly; positions
# to 2 float32 ulps at the world's extent. Both sides round every operation
# the same way (the kernel is built with --fmad=false and uses IEEE sqrt and
# division, as torch's separate CUDA ops do), so the expected difference is 0;
# the bound leaves room for a compiler's different but valid rounding of one
# operation, never for a different algorithm.
def pos_tol(extent: float) -> float:
    import numpy as np

    return 2.0 * float(np.spacing(np.float32(extent)))


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def kernel_vs_plain(name, args, extent):
    """Run K1 and its plain version on the same card inputs; returns the
    max position error after checking counts and tolerance."""
    import torch

    from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
        pair_pass_resident,
        pair_pass_resident_plain,
    )

    kx, ky, kc = pair_pass_resident(*args)
    px, py, pc = pair_pass_resident_plain(*args)
    torch.cuda.synchronize()
    err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
    n_bad = int((kc != pc).sum().item())
    contacts = int(kc.sum().item())
    log("parity", layout=name, shape=list(args[0].shape), contacts=contacts,
        count_mismatch=n_bad, max_abs_err=err, tol=pos_tol(extent))
    check(n_bad == 0, f"K1 contact counts differ from the plain version on {name}")
    check(err <= pos_tol(extent), f"K1 positions differ by {err} on {name}")
    check(contacts > 0, f"no contacts in the {name} layout")
    return err, (kx, ky, kc)


def time_k1(args, kernel_reps=200, plain_reps=5):
    """Median ms of K1 and of its plain version, in turns plain, kernel,
    kernel, plain, with CUDA events around many launches."""
    import torch

    from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
        pair_pass_resident,
        pair_pass_resident_plain,
    )

    def run(fn, reps):
        fn(*args)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    plain, kern = [], []
    for _ in range(2):
        plain.append(run(pair_pass_resident_plain, plain_reps))
        kern.append(run(pair_pass_resident, kernel_reps))
        kern.append(run(pair_pass_resident, kernel_reps))
        plain.append(run(pair_pass_resident_plain, plain_reps))
    return statistics.median(kern), statistics.median(plain)


def layout_args(eng):
    from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout

    w = eng.world
    lay = build_layout(w, eng._plan.solver_geom)
    strength = float(eng.config.physics.collision_response_strength)
    return (lay.scatter(w.transform.x), lay.scatter(w.transform.y),
            lay.radius, lay.meta, w.step_count, strength)


def synthetic_args(device):
    """A hand-made layout: a pile against the world's left and bottom edges
    with a static and a trigger in it, an exactly coincident pair, and one
    cell holding more entities than its capacity."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.ops import _build
    from multithreadedgameengine_tpu_torch.ops import cuda_kernels

    # 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fresh = not _build.library_path().is_file()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log("card", device=repr(torch.cuda.get_device_name(0)), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=round(time.perf_counter() - t0, 3),
        nvcc_ran=fresh, flags="'" + " ".join(_build.NVCC_FLAGS) + "'",
        library=lib.relative_to(_build.BUILD_DIR.parents[1]))
    dev = torch.device("cuda")

    # 2. K1 parity: the demo scene's layout after 30 frames, and a synthetic one
    scene = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    scene.step(30, block=True)
    demo_args = layout_args(scene)
    extent = max(scene.config.world_width, scene.config.world_height)
    err_demo, _ = kernel_vs_plain("demo_10k", demo_args, extent)
    syn_args, pair = synthetic_args(dev)
    err_syn, (kx, ky, _kc) = kernel_vs_plain("synthetic", syn_args, 300.0)
    slots = torch.tensor(pair, device=dev)
    moved = (kx.view(-1)[slots] != syn_args[0].view(-1)[slots]) | (
        ky.view(-1)[slots] != syn_args[1].view(-1)[slots])
    check(bool(moved.all().item()), "the coincident pair was not separated (hash path)")
    ms_demo, plain_demo = time_k1(demo_args)
    demo_shape = list(demo_args[0].shape)
    log("timing", layout="demo_10k", shape=demo_shape, k1_ms=ms_demo, plain_ms=plain_demo)
    del scene, demo_args

    # 3. the main path: bench.py's scene through Engine.step, counting launches
    eng = make_balls_engine(n_balls=N_MAIN, seed=SEED, device=dev)
    cuda_kernels.pair_pass_resident.launches = 0
    eng.step(WARMUP, block=True)
    t0 = time.perf_counter()
    for _ in range(CHUNKS):
        eng.step(CHUNK)
    eng.sync()
    dt = time.perf_counter() - t0
    launches = cuda_kernels.pair_pass_resident.launches
    frames = WARMUP + CHUNKS * CHUNK
    subs = eng.config.physics.sub_step_count
    w = eng.world
    finite = bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all().item())
    contacts = w.rigid_body.collision_count[1:].float().mean().item()
    overflow = int(eng.metrics["solver_overflow"].item())
    log("main", balls=N_MAIN, frames=frames, steps_per_s=CHUNKS * CHUNK / dt,
        k1_launches=launches, expected=frames * subs, solver_overflow=overflow,
        mean_contacts=contacts, finite=finite)
    check(finite, "non-finite positions after the main path")
    check(w.step_count == frames, f"step_count {w.step_count} != {frames}")
    check(launches == frames * subs, f"K1 launched {launches} times, expected {frames * subs}")

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

    # 4. scale: 1M balls in the ladder's world
    big = make_balls_engine(
        n_balls=1_000_000, seed=SEED, device=dev,
        world_width=90_000.0, world_height=40_000.0,
        physics=dict(sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
                     boundary_elasticity=0.0, collision_response_strength=0.8,
                     gravity=(0.0, 0.5), solver_capacity=12),
    )
    before = cuda_kernels.pair_pass_resident.launches
    big.step(5, block=True)
    t0 = time.perf_counter()
    big.step(20)
    big.sync()
    dt = time.perf_counter() - t0
    w = big.world
    finite = bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all().item())
    big_launches = cuda_kernels.pair_pass_resident.launches - before
    log("scale", balls=1_000_000, frames=25, steps_per_s=20 / dt, k1_launches=big_launches,
        solver_overflow=int(big.metrics["solver_overflow"].item()),
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(),
        finite=finite)
    check(finite, "non-finite positions at 1M")
    check(w.step_count == 25 and big_launches == 25 * subs, "1M run: wrong frame or launch count")
    big_args = layout_args(big)
    err_big, _ = kernel_vs_plain("ladder_1m", big_args, 90_000.0)
    ms_big, plain_big = time_k1(big_args, kernel_reps=50, plain_reps=2)
    log("timing", layout="ladder_1m", shape=list(big_args[0].shape), k1_ms=ms_big,
        plain_ms=plain_big)

    print(json.dumps({"kernels": [{
        "name": "K1 pair_pass_resident",
        "route": "cuda",
        "source": "multithreadedgameengine_tpu_torch/csrc/pair_pass_resident.cu",
        "replaces": "multithreadedgameengine_tpu/ops/pallas_kernels.py:654",
        "launches": launches,
        "max_abs_err": max(err_demo, err_syn, err_big),
        "ms": ms_demo,
        "plain_ms": plain_demo,
        "shape": demo_shape,
        "shape_1m": list(big_args[0].shape),
        "ms_1m": ms_big,
        "plain_ms_1m": plain_big,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
