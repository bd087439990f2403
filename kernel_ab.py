#!/usr/bin/env python3
"""A/B of the port's kernels against other versions of their sources, on
one NVIDIA GPU, on the kernel table's cases.

    python3 kernel_ab.py --old DIR [DIR ...] [--ablate DIR ...] [--out build/kernel_ab.json]

Each ``DIR`` holds another version of some of ``pair_pass_resident.cu``,
``pair_pass_grid.cu``, ``pair_pass_symmetric.cu``, ``expand.cu`` and
``boid_tick.cu`` (and any header they include), for example taken out of git with ``git show
<commit>:multithreadedgameengine_tpu_torch/csrc/expand.cu``; their C launch
functions must take the current ones' arguments. ``--ablate`` takes
versions that compute something else (the current sources with a phase cut
out, to price that phase): they are timed the same way but not checked. All
are built with ``ops/_build.py``'s nvcc flags, one nvcc per source in
parallel, and each library's ``-Xptxas -v`` lines are printed. Then, on
each case of the kernel table (``torch_scenes.py``'s ``CASES``)
whose kernel an old source holds, it checks the new kernel against its
plain version (``compare``) and each old kernel against the new one
bit for bit, and times each old one against the new one in turns (old,
new, new, old, twice; ``chip_smoke.turns``), each turn one replay of a
CUDA graph of the case's launches between CUDA events
(``chip_smoke.graph_timer``), printing each median beside the case's bound
and the new kernel's tile or plan (``chip_smoke.figures``). K4 is timed a
second way too: each launch after a 64 MB write that flushes the 50 MB L2
cache, the write's own time (timed alone the same way) subtracted. The
last line is a JSON object of the results, also written to ``--out``. Run
it from the repo's root. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
from torch_scenes import CASES, card_name_and_limit, compare, kernels, scene_inputs

SOURCES = ("boid_tick.cu", "expand.cu", "pair_pass_grid.cu", "pair_pass_resident.cu",
           "pair_pass_symmetric.cu")


def build_old(old_dir: Path):
    """Build the sources ``old_dir`` holds into ``build/kernels_ab/``;
    returns their launch functions by name and their ptxas reports."""
    import ctypes

    from multithreadedgameengine_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "kernels_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in (n for n in SOURCES if (old_dir / n).is_file()):
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
    """The old launch functions behind the current wrappers' signatures,
    by the current wrapper's name, for the kernels ``fns`` holds."""
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

    def pair_pass_resident_old(x, y, radius, meta, salt, strength):
        cap, rows, cols = x.shape
        nx, ny = torch.empty_like(x), torch.empty_like(y)
        c = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        launch(fns["pair_pass_resident_launch"], x, y, radius, meta, nx, ny, c, cap, rows, cols,
               int(salt) & 0xFFFFFFFF, float(strength))
        return nx, ny, c

    def pair_pass_symmetric_old(x, y, radius, meta, salt, strength, clamp_bounds=None):
        cap, rows, cols = x.shape
        nx, ny = torch.empty_like(x), torch.empty_like(y)
        c = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        w, h = clamp_bounds if clamp_bounds is not None else (0.0, 0.0)
        launch(fns["pair_pass_symmetric_launch"], x, y, radius, meta, nx, ny, c, cap, rows, cols,
               int(salt) & 0xFFFFFFFF, float(strength), int(clamp_bounds is not None),
               float(w), float(h))
        return nx, ny, c

    def expand_old(x, y, order, flat, bounds, total, chunk):
        ox = torch.empty((total // chunk * 8, chunk // 8), dtype=torch.float32, device=x.device)
        oy = torch.empty_like(ox)
        launch(fns["expand_launch"], x, y, order, flat, bounds, ox, oy, total // chunk, chunk)
        return ox, oy

    def boid_tick_old(ids, d2, cols, own, flock, mouse, dt_ratio, extent):
        import ctypes

        count, slots = ids.shape
        ax = torch.empty((count,), dtype=torch.float32, device=ids.device)
        ay = torch.empty_like(ax)
        tensors = (ids, d2, *cols, *own, *flock, *mouse, ax, ay)
        ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
        strides = (ctypes.c_longlong * 10)(*(c.stride(0) for c in cols),
                                           *(c.stride(1) for c in cols))
        with torch.cuda.device(ids.device):
            err = fns["boid_tick_launch"](ptrs, strides, count, slots, float(dt_ratio),
                                          float(extent[0]), float(extent[1]),
                                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old kernel: CUDA launch failed with error {err}")
        return ax, ay

    wrappers = {"boid_tick": boid_tick_old,
                "pair_pass_grid": pair_pass_grid_old,
                "pair_pass_resident": pair_pass_resident_old,
                "pair_pass_symmetric": pair_pass_symmetric_old,
                "expand": expand_old}
    return {k: f for k, f in wrappers.items() if f"{k}_launch" in fns}


def bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(u.view(torch.int32), v.view(torch.int32)) for u, v in zip(a, b))


def time_ab(old, new, args, reps, **kw):
    """Median ms of the old and the new kernel, each from a CUDA graph of
    ``reps`` launches, in turns."""
    return cs.turns(cs.graph_timer(old, args, reps, **kw), cs.graph_timer(new, args, reps, **kw))


def time_ab_flushed(old, new, args, reps):
    """As :func:`time_ab`, each launch after a 64 MB write that evicts the
    50 MB L2 cache; the write's own median, from a graph of ``reps`` writes
    alone, is subtracted from both."""
    import torch

    scratch = torch.empty(16 * 2**20, dtype=torch.float32, device=args[0].device)

    def flushed(fn):
        def run(*a):
            scratch.zero_()
            return fn(*a)
        return run

    flush = cs.graph_timer(scratch.zero_, (), reps)
    ms_flush = statistics.median([flush() for _ in range(4)])
    ms_old, ms_new = time_ab(flushed(old), flushed(new), args, reps)
    return ms_old - ms_flush, ms_new - ms_flush, ms_flush


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

    from multithreadedgameengine_tpu_torch.ops import _build

    smi = card_name_and_limit()
    print(smi, flush=True)
    ck = kernels()
    new_libs = _build.build()
    _build.load()
    reports = {p.name: _build.ptxas_report(p) for p in new_libs}
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
    rows = []
    for case in CASES:
        if not any(case.kernel in wrappers for wrappers, _checked in olds.values()):
            continue
        new, plain = getattr(ck, case.kernel), getattr(ck, f"{case.kernel}_plain")
        kw = {} if case.clamp is None else {"clamp_bounds": case.clamp}
        inputs, _launches = scene_inputs(case, dev)
        got_new = new(*inputs, **kw)
        cmp = compare(case, inputs, got_new, plain(*inputs, **kw))
        cs.check(cmp["ok"], f"{case.id}: new vs plain differ ({cmp['max_abs_err']})")
        fields = cs.figures(case, inputs, got_new)
        for old_name, (wrappers, checked) in olds.items():
            old = wrappers.get(case.kernel)
            if old is None:
                continue
            cs.check(not checked or bit_equal(got_new, old(*inputs, **kw)),
                     f"{case.id}: new vs {old_name} differ")
            ms_old, ms_new = time_ab(old, new, inputs, case.reps, **kw)
            row = {"case": case.id, **fields, "old": old_name, "old_ms": ms_old,
                   "new_ms": ms_new, "speedup": ms_old / ms_new,
                   "new_share_of_bound": fields["bound_ms"] / ms_new,
                   "old_share_of_bound": fields["bound_ms"] / ms_old,
                   "bit_equal_old_new": checked}
            if case.kernel == "expand":
                f_old, f_new, f_write = time_ab_flushed(old, new, inputs, case.reps)
                row.update(old_ms_l2_flushed=f_old, new_ms_l2_flushed=f_new,
                           flush_write_ms=f_write)
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
