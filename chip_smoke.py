#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``multithreadedgameengine_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port builds and runs there.

    python3 chip_smoke.py

Phases, each printing one line or more before the last:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions, and
   the nvcc build of the kernels from ``multithreadedgameengine_tpu_torch/
   csrc`` (sm_90a, one nvcc per source, in parallel);
2. kernel parity: K1 (the two-sided pair pass) and K2 (the predicated
   Newton-symmetric pass, with and without its folded boundary clamp)
   against their plain PyTorch versions on the card, on the demo scene's
   layout after 30 frames and on a synthetic layout with statics, a trigger,
   a world-edge pile, a coincident pair, a full cell and moving slots
   outside the world; then both kernels timed with CUDA events;
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
   px, py and the contact counts must be bit-equal.

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
# the JAX ladder's physics from 100k balls up (benchmarks/run_ladder.py:84-93)
LADDER_PHYSICS = dict(
    sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
    boundary_elasticity=0.0, collision_response_strength=0.8,
    gravity=(0.0, 0.5), solver_capacity=12, rebin_interval=8,
)
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


# Each kernel against its plain version: contact counts must match exactly;
# positions to 2 float32 ulps at the world's extent. Both sides round every
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
    the max position error and the kernel's outputs after checking counts
    and tolerance."""
    import torch

    kx, ky, kc = kernel(*args, **kw)
    px, py, pc = plain(*args, **kw)
    torch.cuda.synchronize()
    err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
    n_bad = int((kc != pc).sum().item())
    contacts = int(kc.sum().item())
    label = kernel.__name__ + ("+clamp" if kw.get("clamp_bounds") else "")
    log("parity", kernel=label, layout=name, shape=list(args[0].shape), contacts=contacts,
        count_mismatch=n_bad, max_abs_err=err, tol=pos_tol(extent))
    check(n_bad == 0, f"{label}: contact counts differ from the plain version on {name}")
    check(err <= pos_tol(extent), f"{label}: positions differ by {err} on {name}")
    check(contacts > 0, f"no contacts in the {name} layout")
    return err, (kx, ky, kc)


def time_kernel(kernel, plain, args, kernel_reps=200, plain_reps=5, **kw):
    """Median ms of a kernel and of its plain version, in turns plain,
    kernel, kernel, plain, with CUDA events around many launches."""
    import torch

    def run(fn, reps):
        fn(*args, **kw)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    plain_t, kern_t = [], []
    for _ in range(2):
        plain_t.append(run(plain, plain_reps))
        kern_t.append(run(kernel, kernel_reps))
        kern_t.append(run(kernel, kernel_reps))
        plain_t.append(run(plain, plain_reps))
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


def zero_counts():
    ck = kernels()
    ck.pair_pass_resident.launches = 0
    ck.pair_pass_symmetric.launches = 0


def read_counts():
    ck = kernels()
    return ck.pair_pass_resident.launches, ck.pair_pass_symmetric.launches


def finite(w) -> bool:
    import torch

    return bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all().item())


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
    demo_shape = list(demo_args[0].shape)
    k1_ms_10k, k1_plain_10k = time_kernel(k1, k1_plain, demo_args)
    k2_ms_10k, k2_plain_10k = time_kernel(k2, k2_plain, demo_args)
    log("timing", layout="demo_10k", shape=demo_shape, k1_ms=k1_ms_10k,
        k1_plain_ms=k1_plain_10k, k2_ms=k2_ms_10k, k2_plain_ms=k2_plain_10k)
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
    k1_main, k2_main = read_counts()
    frames = WARMUP + CHUNKS * CHUNK
    w = eng.world
    ok = finite(w)
    log("main_10k", balls=N_MAIN, frames=frames, steps_per_s=CHUNKS * CHUNK / dt,
        k1_launches=k1_main, k2_launches=k2_main, expected_k1=frames * subs,
        layout=list(layout_args(eng)[0].shape),
        solver_overflow=int(eng.metrics["solver_overflow"].item()),
        mean_contacts=w.rigid_body.collision_count[1:].float().mean().item(), finite=ok)
    check(ok, "non-finite positions after the 10k main path")
    check(w.step_count == frames, f"step_count {w.step_count} != {frames}")
    check(k1_main == frames * subs and k2_main == 0,
          f"10k: K1 launched {k1_main}, K2 {k2_main} times; expected {frames * subs}, 0")

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
    k1_big, k2_big = read_counts()
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
    check(w.step_count == 25 and k2_big == 25 * subs and k1_big == 0,
          f"1M: K1 launched {k1_big}, K2 {k2_big} times; expected 0, {25 * subs}")
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

    def entry(key, kernel, source, replaces, launches, ms, plain_ms, b, extra):
        return {"name": f"{key} {kernel.__name__}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs[key]), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("K1", k1, "multithreadedgameengine_tpu_torch/csrc/pair_pass_resident.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:654", k1_main,
              k1_ms_10k, k1_plain_10k, bound_10k["K1"],
              {"shape": demo_shape, "shape_1m": big_shape, "ms_1m": k1_ms_1m,
               "plain_ms_1m": k1_plain_1m, "bound_ms_1m": bound_1m["K1"][0]}),
        entry("K2", k2, "multithreadedgameengine_tpu_torch/csrc/pair_pass_symmetric.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:162", k2_big,
              k2_ms_1m, k2_plain_1m, bound_1m["K2"],
              {"shape": big_shape, "shape_10k": demo_shape, "ms_10k": k2_ms_10k,
               "plain_ms_10k": k2_plain_10k, "bound_ms_10k": bound_10k["K2"][0]}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
