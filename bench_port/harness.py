"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the traced window (``--trace 1``), the metrics, the check against the plain
reference, and the result line.

Everything a cell is made of is found by name: the configuration's file
(``BENCHMARK.json``'s ``configs[].file``) names its scene builder
(``scenes/<scene>.py``) and its plain reference (``reference/<ref>.py``);
the traffic mix is ``traffic/<mix>.json``, read by ``drive.py``; each metric
is ``metrics/<name>.py`` with ``UNIT`` and ``read(run)``. A reader that finds
nothing to read returns None and the metric is left out of the line."""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules no run may load: the JAX package, JAX and its libraries, compared
#: by the part of each module name before the first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "multithreadedgameengine_tpu")


def forbidden_modules(names) -> list:
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str):
    """(workload entry, configuration entry) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return wl, next(c for c in spec["configs"] if c["name"] == wl["config"])


def load_config(entry: dict) -> dict:
    return json.loads((ROOT / entry["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """``bench_port.<kind>.<name>``: a scene, a reference or a metric."""
    return importlib.import_module(f"bench_port.{kind}.{name}")


def metric_names(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


@dataclass
class Run:
    """What the metric readers read."""

    workload: str
    cfg: dict
    traffic: dict
    built: object
    setup_s: float
    calls: list  # the measured window's drive.Call records
    trace: object = None  # trace.TraceSummary of a traced run


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", cfg: Optional[dict] = None, traffic: Optional[dict] = None,
             log=print, variants: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. ``cfg`` and ``traffic``
    replace the files' (the tests' tiny cells). ``variants`` maps a name to
    a ``program(start, sample)`` that stands in for the program's outputs
    in the check (``check.numbers``); their numbers go under the line's
    ``variants`` key (``control.py``'s readings)."""
    import torch

    from . import check, drive
    from .trace import traced

    spec = load_spec()
    wl, cfg_entry = cell(spec, workload)
    cfg = cfg or load_config(cfg_entry)
    traffic = traffic or load_traffic(wl["traffic"])
    scene = module("scenes", cfg["scene"])
    cuda = device == "cuda"

    marks = [("imports", time.perf_counter())]
    built = scene.build(cfg, seed, device)
    marks.append(("spawn", time.perf_counter()))
    d = drive.Drive(built=built, cfg=cfg, traffic=traffic, seed=seed,
                    guards=cfg["guards"])
    d.call(check=True)  # the first call: the plan, the kernels' build, the check's start
    marks.append(("first_call", time.perf_counter()))
    for _ in range(traffic["warmup_calls"] - 1):
        d.call()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warmup", time.perf_counter()))
    # the set-up's objects move out of the collector's reach, so that a
    # collection inside the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    calls = d.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(workload=workload, cfg=cfg, traffic=traffic, built=built, setup_s=setup_s,
              calls=calls)
    if trace:
        def traced_calls():
            return sum(d.call(spans=True).frames for _ in range(traffic["trace_calls"]))

        run.trace = traced(traced_calls)
    metrics = {}
    for m in metric_names(spec, workload, trace):
        reader = module("metrics", m["name"])
        if reader.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: unit {reader.UNIT!r}, BENCHMARK.json {m['unit']!r}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    per = sorted((c.t_read - c.t_input) / c.frames * 1e3 for c in calls)
    steps = [f"{name} {t - prev:.3f}" for (name, t), prev in
             zip(marks, [t_start] + [t for _n, t in marks[:-1]])]
    log(f"set-up s: {', '.join(steps)}; window: {len(calls)} calls, ms a frame min "
        f"{per[0]:.3f} median {per[len(per) // 2]:.3f} max {per[-1]:.3f}", file=sys.stderr)
    attempted = drive.frames_of(calls)
    failed = sum(c.frames for c in calls if not c.ok)

    # the reference runs once the window has closed, the peak has been read
    # and the program's state is freed: the samples are clones
    rows, n_rows = built.rows, built.n_rows
    run.built = built = d.built = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    inputs = scene.draw(cfg, seed)
    numbers = check.numbers(cfg, inputs, rows, n_rows, device, d.samples)
    checks = check.judge(numbers, cfg["limits"])
    for line in d.failures[:5]:
        log(f"guard failed: {line}", file=sys.stderr)
    correct = not d.failures and all(c["ok"] for c in checks.values())

    found = forbidden_modules(sys.modules)
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": wl["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        t = run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [list(o) for o in t.top_ops],
                               "idle_gaps": [list(g) for g in t.idle_gaps]}
    if variants:
        result["variants"] = {name: check.numbers(cfg, inputs, rows, n_rows, device, d.samples,
                                                  program=fn)
                              for name, fn in variants.items()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} {c['op']} {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
            file=sys.stderr)
    return result
