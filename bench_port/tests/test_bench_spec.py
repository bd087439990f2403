"""BENCHMARK.json against the files it names: every configuration, traffic
mix and metric is found by its name, and each cell reports what the
benchmark's contract asks of it."""

import json
import re

import pytest

from bench_port import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_port"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(entry):
    cfg = harness.load_config(entry)
    assert harness.module("scenes", cfg["scene"]).build
    ref = harness.module("reference", cfg["reference"])
    assert ref.initial_state and ref.run
    assert set(cfg["limits"]) and set(cfg["guards"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_reports_its_metrics(wl):
    assert NAME.match(wl["name"]) and wl["chips"] in (1, 4)
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    traffic = harness.load_traffic(wl["traffic"])
    assert traffic["frames_per_call"] >= 1 and traffic["warmup_calls"] >= 1
    e2e = [m["name"] for m in harness.metric_names(SPEC, wl["name"], trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_names(SPEC, wl["name"], trace=True)


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    reader = harness.module("metrics", m["name"])
    assert reader.UNIT == m["unit"] and callable(reader.read)
    assert m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
        for w in m.get("workloads", []):
            assert m["moves"] in [e["name"] for e in harness.metric_names(SPEC, w, False)]
