#!/usr/bin/env python3
"""A/B of the tiled pair passes K2 and K3 against an earlier version of
their sources, on one NVIDIA GPU.

    python3 kernel_ab.py --old DIR [DIR ...] [--ablate DIR ...] [--out build/kernel_ab.json]

Each ``DIR`` holds another version of ``pair_pass_grid.cu`` and
``pair_pass_symmetric.cu`` (and any header they include), for example
taken out of git with ``git show <commit>:multithreadedgameengine_tpu_torch/
csrc/pair_pass_grid.cu``; their C launch functions must take the current
ones' arguments. ``--ablate`` takes versions that compute something else
(the current sources with a phase cut out, to price that phase): they are
timed the same way but not checked. All are built with ``ops/_build.py``'s
nvcc flags, one nvcc per source in parallel, and each library's
``-Xptxas -v`` lines are printed. Then, for each kernel and shape -- K3 on slab 1 of the
1M halo rung and of the 10k demo scene (4 slabs, 3 frames), K2 with its
folded clamp on the 1M ladder layout and without it on the 10k demo layout
(``chip_smoke.py``'s scenes) -- it checks that each old kernel, the new one
and the plain version agree bit for bit, and times each old one against the
new one in turns (old, new, new, old, twice; CUDA events around 50-200
launches), printing each median beside the bound from ``chip_smoke.py``.
The last line is a JSON object of the results, also written to ``--out``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCES = ("pair_pass_grid.cu", "pair_pass_symmetric.cu")


def build_old(old_dir: Path):
    """Build the sources of ``old_dir`` into ``build/kernels_ab/``; returns
    their launch functions by name and their ptxas reports."""
    import ctypes

    from multithreadedgameengine_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "kernels_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        lib = out_dir / f"lib{Path(name).stem}_{old_dir.name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(old_dir / name)]
        jobs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    fns, reports = {}, {}
    for name, lib, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}:\n{stdout}\n{stderr}")
        reports[lib.name] = stdout + stderr
        fname, argtypes, restype = _build.ENTRY_POINTS[name][0]
        fn = getattr(ctypes.CDLL(str(lib)), fname)
        fn.argtypes, fn.restype = argtypes, restype
        fns[fname] = fn
    return fns, reports


def old_wrappers(fns):
    """The old launch functions behind the current wrappers' signatures."""
    import torch

    def launch(fn, *args):
        with torch.cuda.device(args[0].device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            raise RuntimeError(f"old kernel: CUDA launch failed with error {err}")

    def pair_pass_grid_old(x, y, attrs, salt, strength):
        rows, cols, cap = x.shape
        dx, dy = torch.empty_like(x), torch.empty_like(y)
        c = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        launch(fns["pair_pass_grid_launch"], x, y, attrs, dx, dy, c, rows, cols, cap,
               int(salt) & 0xFFFFFFFF, float(strength))
        return dx, dy, c

    def pair_pass_symmetric_old(x, y, radius, meta, salt, strength, clamp_bounds=None):
        cap, rows, cols = x.shape
        nx, ny = torch.empty_like(x), torch.empty_like(y)
        c = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        w, h = clamp_bounds if clamp_bounds is not None else (0.0, 0.0)
        launch(fns["pair_pass_symmetric_launch"], x, y, radius, meta, nx, ny, c, cap, rows, cols,
               int(salt) & 0xFFFFFFFF, float(strength), int(clamp_bounds is not None),
               float(w), float(h))
        return nx, ny, c

    return pair_pass_grid_old, pair_pass_symmetric_old


def bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(u.view(torch.int32), v.view(torch.int32)) for u, v in zip(a, b))


def time_ab(old, new, args, reps, **kw):
    """Median ms of the old and the new kernel, in turns old, new, new, old."""
    import torch

    def run(fn):
        fn(*args, **kw)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    t_old, t_new = [], []
    for _ in range(2):
        t_old.append(run(old))
        t_new.append(run(new))
        t_new.append(run(new))
        t_old.append(run(old))
    return statistics.median(t_old), statistics.median(t_new)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, nargs="+")
    ap.add_argument("--ablate", type=Path, nargs="*", default=[])
    ap.add_argument("--out", default="build/kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.ops import _build

    smi = cs.card_name_and_limit()
    print(smi, flush=True)
    ck = cs.kernels()
    new_libs = _build.build()
    _build.load()
    reports = {p.name: _build.ptxas_report(p) for p in new_libs
               if p.name.startswith(("libpair_pass_grid", "libpair_pass_symmetric"))}
    olds = {}  # name -> (wrappers, checked against the new kernel)
    for old_dir in [*args.old, *args.ablate]:
        fns, old_reports = build_old(old_dir)
        olds[old_dir.name] = (old_wrappers(fns), old_dir in args.old)
        reports.update(old_reports)
    for lib, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {lib} {line.strip()}", flush=True)
    dev = torch.device("cuda")

    def layout(scene, frames):
        eng = make_balls_engine(device=dev, **scene)
        eng.step(frames, block=True)
        return cs.layout_args(eng)

    ladder = dict(n_balls=1_000_000, seed=cs.SEED, world_width=90_000.0,
                  world_height=40_000.0, physics=cs.LADDER_PHYSICS)
    cases = [
        ("K3", "halo_1m_slab1", ck.pair_pass_grid, ck.pair_pass_grid_plain, 0,
         lambda: cs.halo_slab_args(dev, dict(n_balls=cs.HALO_N - 1, seed=cs.SEED,
                                             world_width=cs.HALO_WORLD[0],
                                             world_height=cs.HALO_WORLD[1])), {}, 50),
        ("K3", "halo_10k_slab1", ck.pair_pass_grid, ck.pair_pass_grid_plain, 0,
         lambda: cs.halo_slab_args(dev, dict(n_balls=cs.N_MAIN - 1, seed=cs.SEED)), {}, 200),
        ("K2+clamp", "ladder_1m", ck.pair_pass_symmetric, ck.pair_pass_symmetric_plain, 1,
         lambda: layout(ladder, 5), dict(clamp_bounds=(90_000.0, 40_000.0)), 50),
        ("K2", "demo_10k", ck.pair_pass_symmetric, ck.pair_pass_symmetric_plain, 1,
         lambda: layout(dict(n_balls=cs.N_MAIN, seed=cs.SEED), 30), {}, 200),
    ]
    rows = []
    for key, shape_name, new, plain, which, make, kw, reps in cases:
        inputs = make()
        got_new = new(*inputs, **kw)
        same_plain = bit_equal(got_new, plain(*inputs, **kw))
        contacts = int(got_new[2].sum().item())
        cs.check(same_plain and contacts > 0, f"{key} on {shape_name}: new vs plain differ")
        b = (cs.grid_bound(inputs, contacts) if key == "K3"
             else cs.bound(inputs, contacts, True))
        for old_name, (wrappers, checked) in olds.items():
            old = wrappers[which]
            cs.check(not checked or bit_equal(got_new, old(*inputs, **kw)),
                     f"{key} on {shape_name}: new vs {old_name} differ")
            ms_old, ms_new = time_ab(old, new, inputs, reps, **kw)
            row = {"kernel": key, "shape_name": shape_name, "shape": list(inputs[0].shape),
                   "contacts": contacts, "old": old_name, "old_ms": ms_old, "new_ms": ms_new,
                   "speedup": ms_old / ms_new, "bound_ms": b[0], "bound_by": b[1],
                   "new_share_of_bound": b[0] / ms_new, "old_share_of_bound": b[0] / ms_old,
                   "bit_equal_old_new_plain": checked}
            cs.log("ab", **row)
            rows.append(row)
        del inputs, got_new
        torch.cuda.empty_cache()
    result = {"card": smi, "torch": torch.__version__, "cases": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
