#!/usr/bin/env python3
"""The port's CUDA kernels on one NVIDIA GPU: their build and their table.

    python3 chip_smoke.py

1. card: ``nvidia-smi``'s name and power limit, the torch and CUDA
   versions, and the nvcc build of ``multithreadedgameengine_tpu_torch/
   csrc`` (``ops/_build.py``: sm_90a, one nvcc per source, in parallel),
   with each library's registers, shared memory and spills from
   ``-Xptxas -v`` as ``[ptxas]`` lines;
2. the kernel table: every C launch function of ``ops/_build.ENTRY_POINTS``
   through its wrapper in ``ops/cuda_kernels.py``, on the inputs
   ``PERF.md`` §6 reports (``torch_scenes.py``'s ``CASES``: layouts
   and slab grids taken from frames of the scenes and of the benchmark
   cells' scenes run through their main paths, K4 at the probe's shapes,
   the ticks on captured frames and on the mixed cell's inputs). The
   launches each scene made are checked against the case's and kept in
   its row. Each case is held against its plain version (``compare``),
   then timed beside it (:func:`time_kernel`: the kernel as one replay of
   a CUDA graph of 20-200 launches between CUDA events, the plain version
   eager, in turns) and set against the bytes it must move
   (:func:`figures`). One ``[table]`` line a case, then one JSON line of
   them all, and ``{"ok": true, "device": {...}}`` last.

Correctness on the card is the ``cuda``-marked tests' (the README gives the
command); ``tests/test_torch_cuda.py::test_kernel_table_case_on_card``
holds every case against its plain version and its launches too. The
speed of the scenes is ``torch_profile.py``'s, of the benchmark's cells
``bench_port/``'s; ``kernel_ab.py`` times other versions of the kernels'
sources on these cases. Any failure raises and exits non-zero; without a
CUDA device it exits 1 at once. Run it from the repo's root. Importing
this file touches no card, and it imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys

from torch_scenes import (
    CASES,
    PAIR_PASSES,
    card_name_and_limit,
    compare,
    kernels,
    scene_inputs,
)

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

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
    wrapper: what the host adds to every launch is in it. For the plain
    versions, which read values on the host and cannot be captured."""
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


def turns(first, second):
    """Median ms of two timers run in turns first, second, second, first,
    twice (the card's speed drifts within a call)."""
    a, b = [], []
    for _ in range(2):
        a.append(first())
        b += [second(), second()]
        a.append(first())
    return statistics.median(a), statistics.median(b)


def time_kernel(kernel, plain, args, reps, plain_reps=2, **kw):
    """Median ms of a kernel (graph replay of ``reps`` launches) and of its
    plain version (eager), in turns. Returns (kernel ms, plain ms)."""
    plain_ms, kernel_ms = turns(eager_timer(plain, args, plain_reps, **kw),
                                graph_timer(kernel, args, reps, **kw))
    return kernel_ms, plain_ms


# ---------------------------------------------------------------------------
# bounds: the least time the card could take, from the bytes a pass must move
# ---------------------------------------------------------------------------

def bound(args, contacts: int, symmetric: bool):
    """K1's or K2's bound in ms, and what bounds it: the bytes the pass must
    move (x, y, meta read and x, y, count written for every slot, 24 bytes;
    the radius read only for the slots holding a collider, 4 bytes each,
    since every other slot takes part in no pair) over the HBM rate, against
    the float32 operations this data needs over the card's non-tensor-core
    rate: 8 per candidate pair of the 3x3 neighbourhood (dx, dy, d2, min_d,
    the overlap test) and 16 more per contact (square root, division, the
    push and its sum), each pair once for K2, from both sides for K1.
    ``contacts`` is the layout's contact count summed over slots."""
    import torch

    x, meta = args[0], args[3]
    n_bytes = 24 * x.numel() + 4 * int((((meta >> 24) & 1) != 0).sum().item())
    occ = (meta != 0).sum(0).to(torch.float64)  # entities per cell
    nb = torch.nn.functional.avg_pool2d(occ[None, None], 3, stride=1, padding=1,
                                        divisor_override=1)[0, 0]
    pairs = float((occ * (nb - 1)).sum().item())  # ordered pairs, 3x3
    n_ops = (0.5 if symmetric else 1.0) * (8 * pairs + 16 * contacts)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_bound(args, contacts: int):
    """K3's bound in ms, and what bounds it: the flags read and dx, dy and
    count written for every slot (16 bytes), x, y, radius and gid read only
    for the slots holding a collider (16 bytes each), against the operations
    of :func:`bound` over the grid's 3x3 neighbourhoods, border rows
    included, from each side."""
    import torch

    x, attrs = args[0], args[2]
    coll = (attrs[..., 1].to(torch.int32) & 1) == 1
    n_bytes = 16 * x.numel() + 16 * int(coll.sum().item())
    occ = coll.sum(-1).to(torch.float64)
    nb = torch.nn.functional.avg_pool2d(occ[None, None], 3, stride=1, padding=1,
                                        divisor_override=1)[0, 0]
    pairs = float((occ * (nb - 1))[1:-1, 1:-1].sum().item())
    n_ops = 8 * pairs + 16 * contacts
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_bound(args) -> float:
    """K4's bound in ms: x, y, order and flat read once (16 B an entity),
    bounds read, both outputs written (8 B a slot); it does no arithmetic."""
    x, _y, _o, _f, bounds, total, _c = args
    return (16 * x.numel() + 4 * bounds.numel() + 8 * total) / PEAK_BYTES_S * 1e3


def tick_bounds(args, row_fields: int, payload_bytes: int):
    """A tick's bounds in ms: (a) every slot's id read and, for the live
    slots alone, d2 and the neighbour's five channels (24 B); (b) every
    slot's id, d2 and whole payload record (``payload_bytes``); both with
    ``row_fields`` fields of each row read (the boid tick's 13; the prey
    tick's 14 add its flee factor) and 2 written. Operations (about 20 a
    live slot) are far below either. Returns (live, full, live share)."""
    ids = args[0]
    n, s = ids.shape
    live = int((ids >= 0).sum().item())
    rows = (row_fields + 2) * 4 * n
    return ((4 * n * s + 24 * live + rows) / PEAK_BYTES_S * 1e3,
            ((4 + 4 + payload_bytes) * n * s + rows) / PEAK_BYTES_S * 1e3, live / (n * s))


# ---------------------------------------------------------------------------
# one case: checked, bounded, timed
# ---------------------------------------------------------------------------

def figures(case, args, got) -> dict:
    """The case's bound and what the kernel takes there: its shape, its
    tile or plan, its contacts or live share."""
    ck = kernels()
    out = {"shape": list(args[0].shape)}
    if case.kernel in PAIR_PASSES:
        contacts = int(got[2].sum().item())
        b = (grid_bound(args, contacts) if case.kernel == "pair_pass_grid"
             else bound(args, contacts, case.kernel == "pair_pass_symmetric"))
        out.update(contacts=contacts, tile=list(ck.tile_of(case.kernel, args[0].shape)))
    elif case.kernel == "expand":
        b = (k4_bound(args), "bytes")
        out.update(shape=list(got[0].shape), entities=args[0].numel(), **ck.expand_plan(args[5]))
    else:
        prey = case.kernel == "prey_tick"
        live_ms, full_ms, share = tick_bounds(
            args, 14 if prey else 13, 4 * max(args[2][0].stride(1), 5) if prey else 24)
        b = (live_ms, "bytes")
        out.update(payload_stride=list(args[2][0].stride()), live_share=share,
                   bound_full_ms=full_ms)
    return dict(out, bound_ms=b[0], bound_by=b[1])


def yardstick_ms(args, got) -> float:
    """K4's yardstick, the library's placement (zeros and ``index_copy_`` of
    x and y), checked to place as K4 does and timed by graph replay."""
    import torch

    x, y, _order, flat, _b, total, _chunk = args
    fl = flat.long()

    def scatter():
        lx = torch.zeros(total, device=x.device)
        ly = torch.zeros(total, device=x.device)
        lx.index_copy_(0, fl, x)
        ly.index_copy_(0, fl, y)
        return lx, ly

    lx, ly = scatter()
    check(torch.equal(lx.view_as(got[0]), got[0]) and torch.equal(ly.view_as(got[1]), got[1]),
          "K4's yardstick places otherwise than K4")
    timer = graph_timer(scatter, (), 50)
    return statistics.median([timer(), timer(), timer()])


def run_case(case, dev) -> dict:
    """One row of the table: the case's inputs made on ``dev`` (the scene's
    launches checked against the case's and kept in the row), the kernel
    checked against its plain version, bounded and timed beside it."""
    ck = kernels()
    kernel, plain = getattr(ck, case.kernel), getattr(ck, f"{case.kernel}_plain")
    kw = {} if case.clamp is None else {"clamp_bounds": case.clamp}
    args, seen = scene_inputs(case, dev)
    got, want = kernel(*args, **kw), plain(*args, **kw)
    cmp = compare(case, args, got, want)
    check(cmp["ok"], f"{case.id}: the kernel differs from its plain version "
                     f"(max abs err {cmp['max_abs_err']})")
    row = {"kernel": case.kernel, "inputs": case.inputs, **figures(case, args, got),
           "max_abs_err": cmp["max_abs_err"],
           "launches": {k: n for k, n in seen.items() if n}}
    ms, plain_ms = time_kernel(kernel, plain, args, case.reps, **kw)
    row.update(ms=ms, plain_ms=plain_ms, share_of_bound=row["bound_ms"] / ms)
    if case.kernel == "expand":
        row["library_ms"] = yardstick_ms(args, got)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    import time

    from multithreadedgameengine_tpu_torch.ops import _build

    card = card_name_and_limit()
    print(card, flush=True)
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
    rows = []
    for case in CASES:
        row = run_case(case, dev)
        log("table", **row)
        rows.append(row)
        gc.collect()  # the case's engine, before the next scene is built
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "torch": torch.__version__, "kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
