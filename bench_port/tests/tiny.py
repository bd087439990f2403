"""Tiny versions of the benchmark's cells for CPU tests: the same files,
with the entity count cut and the world cut to keep the density."""

from __future__ import annotations

import math

import torch

from bench_port.harness import cell, load_config, load_spec, load_traffic

N = 600
CELLS = [w["name"] for w in load_spec()["workloads"]]


def tiny(workload: str, n: int = N, **traffic_overrides):
    """(cfg, traffic) of ``workload`` at ``n`` entities, few calls. The CPU
    runs are tiny: one thread a test process keeps parallel workers from
    starving each other."""
    torch.set_num_threads(1)
    wl, entry = cell(load_spec(), workload)
    cfg = load_config(entry)
    f = math.sqrt(n / cfg["n_boids"])
    cfg.update({"n_boids": n, "world_width": cfg["world_width"] * f,
                "world_height": cfg["world_height"] * f})
    traffic = load_traffic(wl["traffic"])
    traffic.update(warmup_calls=2, trace_calls=2, check_span=1, check_calls=1)
    if traffic.get("mouse"):
        traffic["mouse"] = dict(traffic["mouse"], margin=20.0)
    traffic.update(traffic_overrides)
    return cfg, traffic
