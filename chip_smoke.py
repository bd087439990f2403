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
   layout after 30 frames and on a synthetic layout with statics, a trigger,
   a world-edge pile, a coincident pair, a full cell and moving slots
   outside the world; K2 also on two dense layouts where every cell is full
   (capacity 4 and 64, with occupied slots that hold no collider); then both
   kernels timed with CUDA events;
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
7. the K4 probe's yardstick (K4 is not ported): the scatter
   ``benchmarks/probe_expand_kernel.py`` checks its kernel against, at the
   probe's shapes, timed on its own ``[k4_library]`` line.

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
# slice E1's halo rung (benchmarks/halo_scaling.py:104-110 at its default n)
HALO_N, HALO_SLABS, HALO_WARMUP, HALO_FRAMES = 1_000_000, 4, 3, 10
HALO_WORLD = (90_000.0, 40_000.0)
# the halo-against-single-device check: 100,000 entities at the demo's density
CHECK_N, CHECK_WORLD = 100_000, (9000.0 * 10 ** 0.5, 4000.0 * 10 ** 0.5)
PEAK_F32_S = 67e12


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
    """K2's input on a layout where every cell is full."""
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
    halo._fill_border(mesh, grids, plan.slab_geom.rows)
    st = grid_solver_state(grids[d])
    return (st.gx, st.gy, st.attrs, chunks[0].step_count,
            float(plan.cfg.physics.collision_response_strength))


def zero_counts():
    ck = kernels()
    ck.pair_pass_resident.launches = 0
    ck.pair_pass_symmetric.launches = 0
    ck.pair_pass_grid.launches = 0


def read_counts():
    ck = kernels()
    return (ck.pair_pass_resident.launches, ck.pair_pass_symmetric.launches,
            ck.pair_pass_grid.launches)


def finite(w) -> bool:
    import torch

    return bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all().item())


def halo_phase(dev):
    """Phase 6, slice E1's main path: K3 parity on a synthetic grid, the 1M
    halo rung on 4 slabs (launch counts, overflow, K3 parity and timing
    on one slab grid), and the 100k halo-against-single-device check.
    Returns K3's launches on the rung, its times, bound, slab shape and
    parity errors."""
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
    halo_eng = make_balls_engine(n_balls=HALO_N - 1, seed=SEED, device=dev,
                                 world_width=HALO_WORLD[0], world_height=HALO_WORLD[1])
    halo_eng._flush_pending()
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
    step_c, place_c = make_halo_step(eh, make_mesh(HALO_SLABS, dev), oversub=float(HALO_SLABS))
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
    a, b = unplace_fn(chunks_c), es.world
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
    return dict(launches=k3_h, ms=k3_ms, plain_ms=k3_plain_ms, bound=bound_k3,
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


def k4_library(dev):
    """The K4 probe's yardstick (``benchmarks/probe_expand_kernel.py:104-
    135``): two zeroed ``[total]`` outputs and ``index_copy_`` of x and y at
    ``flat``, with n = 1,000,000 entities and total = 66 x 131,072 slots,
    ``flat`` distinct slots from a seeded permutation. Returns (library ms,
    bound ms): the bound moves x, y, order and flat once (16 B an entity)
    and writes both outputs (8 B a slot)."""
    import torch

    n, chunk = 1_000_000, 128 * 1024
    total = (12 * 556 * 1280 // chunk + 1) * chunk
    g = torch.Generator(device=dev).manual_seed(SEED)
    flat = torch.randperm(total, generator=g, device=dev)[:n]
    x = torch.randn(n, generator=g, device=dev)
    y = torch.randn(n, generator=g, device=dev)

    def scatter():
        ox = torch.zeros(total, device=dev)
        oy = torch.zeros(total, device=dev)
        ox.index_copy_(0, flat, x)
        oy.index_copy_(0, flat, y)
        return ox, oy

    ox, oy = scatter()
    check(bool(torch.equal(ox[flat], x) and torch.equal(oy[flat], y))
          and int((ox != 0).sum().item()) <= n, "K4 yardstick: scatter misplaced")
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            scatter()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 20)
    bound_ms = (16 * n + 8 * total) / PEAK_BYTES_S * 1e3
    return statistics.median(times), bound_ms


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
        for cb in (None, world):
            errs["K2"].append(kernel_vs_plain(k2, k2_plain, name, dense_args, max(world),
                                              clamp_bounds=cb)[0])
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
    k1_main, k2_main, k3_main = read_counts()
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
    halo = halo_phase(dev)
    errs["K3"] = halo["errs"]

    # 7. the K4 probe's yardstick
    k4_ms, k4_bound = k4_library(dev)
    log("k4_library", call="zeros + index_copy_ of x and y", entities=1_000_000,
        slots=66 * 131_072, library_ms=k4_ms, bound_ms=k4_bound, bound_by="bytes")

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
        entry("K3", ck.pair_pass_grid, "multithreadedgameengine_tpu_torch/csrc/pair_pass_grid.cu",
              "multithreadedgameengine_tpu/ops/pallas_kernels.py:793", halo["launches"],
              halo["ms"], halo["plain_ms"], halo["bound"],
              {"shape": halo["shape"], "shape_10k": halo["shape_10k"], "ms_10k": halo["ms_10k"],
               "plain_ms_10k": halo["plain_ms_10k"], "bound_ms_10k": halo["bound_ms_10k"]}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
