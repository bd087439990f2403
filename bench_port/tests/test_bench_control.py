"""The check that decides ``correct`` fails what it must: the reference in
bfloat16 put in the program's place, the reference without cohesion put
there, and the timed path broken underneath (a call that returns its state
unchanged, one that leaves every other entity out, one whose answer is
altered where it is produced)."""

import time

import pytest
import torch

from bench_port import check
from bench_port.control import variants
from bench_port.harness import run_cell
from multithreadedgameengine_tpu_torch.engine import Engine

from .tiny import CELLS, tiny


@pytest.mark.parametrize("workload", CELLS)
def test_lower_precision_fails_and_the_program_passes(workload):
    cfg, traffic = tiny(workload)
    r = run_cell(workload, 2**31 + 3, 0.5, False, time.perf_counter(), device="cpu", cfg=cfg,
                 traffic=traffic, log=lambda *a, **k: None,
                 variants=variants(cfg, ["boid.centering_factor"]))
    assert r["correct"] is True
    assert set(r["variants"]) == {"control", "unchanged", "half", "no_centering_factor"}
    for name, numbers in r["variants"].items():
        assert not all(c["ok"] for c in check.judge(numbers, cfg["limits"]).values()), name


def unchanged(eng, before):
    w = eng.world
    t, rb, b = w.transform, w.rigid_body, before
    eng.world = w.replace(transform=t.replace(x=b.transform.x, y=b.transform.y),
                          rigid_body=rb.replace(px=b.rigid_body.px, py=b.rigid_body.py))


def half(eng, before):
    t = eng.world.transform
    odd = torch.arange(t.x.numel()) % 2 == 1
    eng.world = eng.world.replace(transform=t.replace(
        x=torch.where(odd, before.transform.x, t.x), y=torch.where(odd, before.transform.y, t.y)))


def altered(eng, before):
    t = eng.world.transform
    eng.world = eng.world.replace(transform=t.replace(x=t.x + 1.0))


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    real = Engine.step

    def broken(self, n=1, block=False):
        before = self.world
        metrics = real(self, n, block)
        fault(self, before)
        return metrics

    monkeypatch.setattr(Engine, "step", broken)
    cfg, traffic = tiny(workload)
    r = run_cell(workload, 2**31 + 9, 0.5, False, time.perf_counter(), device="cpu", cfg=cfg,
                 traffic=traffic, log=lambda *a, **k: None)
    assert r["correct"] is False
