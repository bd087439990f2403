"""Both traffic drivers at a tiny size on the CPU, through the harness's
run: the result line's keys, a traced line's, and the command's refusals."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from bench_port import harness
from bench_port.harness import ROOT, run_cell
from bench_port.trace import TraceSummary

from .tiny import CELLS, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def quiet(*_a, **_k):
    pass


def run(workload, trace=False, seconds=0.5):
    cfg, traffic = tiny(workload)
    return run_cell(workload, 2**31 + 77, seconds, trace, time.perf_counter(), device="cpu",
                    cfg=cfg, traffic=traffic, log=quiet)


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_line(workload):
    r = run(workload)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = [m["name"] for m in harness.metric_names(harness.load_spec(), workload, trace=False)]
    assert sorted(r["metrics"]) == sorted(want)
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["count"] == 1
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def test_traced_line(monkeypatch):
    fake = TraceSummary(window_s=1.0, busy_s=0.5, device_ops=100, frames=2,
                        top_ops=[("k", 0.25)], idle_gaps=[("read", 0.1)])
    monkeypatch.setattr("bench_port.trace.traced", lambda calls: (calls(), fake)[1])
    r = run("boids_102k.interactive", trace=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert r["device"]["busy_s"] == 0.5 and r["device"]["window_s"] == 1.0
    assert r["breakdown"] == {"device_ops": [["k", 0.25]], "idle_gaps": [["read", 0.1]]}
    assert r["metrics"]["device_busy_pct"]["value"] == 50.0
    assert r["metrics"]["device_ops_per_step"]["value"] == 50.0
    # a CPU run has no card: the reader that times a kernel finds nothing to read
    assert "neighbor_build_ms" not in r["metrics"]


def command(cwd):
    return subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                           "boids_102k.interactive", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=120)


def test_command_refuses_without_a_card():
    out = command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port")
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["bench_port"]
