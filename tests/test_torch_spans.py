"""The frame's spans and the neighbour counter of the PyTorch port, and the
benchmark's reading of them (``bench_port/spans.py`` and the readers that
use it), on the CPU.

- ``bench_port.spans.reduce_spans`` on events written out by hand: each
  device operation under the innermost span open at its launch (matched by
  correlation id, or by the operator it is linked to), the spans' device
  time a partition of the window's busy time, the idle gaps named by their
  path; the window's own numbers those of ``trace.reduce_events`` on the
  same events without the program's spans.
- ``Engine.step`` on a small boids scene under ``torch.profiler``: every
  span once a frame, nested as ``profiling.span`` lists them; with no
  profiler, ``record_function`` is never entered.
- ``neighbors_accepted``: the lists' counts summed, -1 without lists.
- The metric readers on hand-built runs.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from bench_port.harness import Run
from bench_port.metrics import (
    neighbor_fill_pct,
    physics_ms,
    spatial_ms,
    step_idle_ms,
    tick_ms,
)
from bench_port.scenes.common import Built
from bench_port.spans import BETWEEN, UNMATCHED, Event, nest, reduce_spans
from bench_port.trace import WINDOW, reduce_events
from multithreadedgameengine_tpu_torch import Engine, make_config, profiling
from multithreadedgameengine_tpu_torch.engine import apply_inputs
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.models.boids import Boid
from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

torch.set_num_threads(2)

US = 1000  # ns


def span(name, s, e):
    return Event(name, False, s * US, e * US, "span")


def launch(corr, t):
    return Event("cudaLaunchKernel", False, t * US, (t + 1) * US, "launch", corr)


def dev(name, s, e, corr=0, linked=0):
    return Event(name, True, s * US, e * US, "", corr, linked)


# a traced window of two frames' worth of work, in microseconds
HARNESS = [Event(WINDOW, False, 0, 200 * US), Event("input", False, 0, 10 * US),
           Event("step_call", False, 10 * US, 150 * US), Event("read", False, 150 * US, 200 * US)]
PROGRAM = [span("engine.step", 12, 148), span("engine.prepare", 14, 20),
           span("ops.spatial", 20, 60), span("behavior", 60, 100),
           span("ops.physics", 100, 140), span("engine.metrics", 140, 146)]
HOST = [launch(1, 15), launch(2, 25), launch(3, 65), launch(4, 105), launch(6, 155),
        Event("aten::sum", False, 142 * US, 143 * US, "op", 50)]
DEVICE = [dev("fill", 30, 35, corr=1), dev("gather", 40, 70, corr=2),
          dev("where", 70, 90, corr=3), dev("k2", 85, 120, corr=4),  # overlaps "where"
          dev("sum", 125, 130, corr=99, linked=50),  # no launch record: the operator's
          dev("memcpy", 160, 170, corr=6), dev("lost", 180, 185, corr=7)]
EVENTS = HARNESS + PROGRAM + HOST + DEVICE
STEP = "step_call>engine.step"


def test_reduce_spans_attributes_by_launch_and_partitions_busy_time():
    s = reduce_spans(EVENTS, frames=2)
    dev_us = {path: r.device_ns / US for path, r in s.rows.items() if r.device_ops}
    assert dev_us == {f"{STEP}>engine.prepare": 5, f"{STEP}>ops.spatial": 30,
                      f"{STEP}>behavior": 20, f"{STEP}>ops.physics": 30,
                      f"{STEP}>engine.metrics": 5, "read": 10, UNMATCHED: 5}
    # a partition of the busy time: the union of the device intervals
    assert sum(r.device_ns for r in s.rows.values()) / 1e9 == s.trace.busy_s
    assert s.trace.busy_s == pytest.approx(105e-6)
    assert sum(r.device_ops for r in s.rows.values()) == s.trace.device_ops == 7
    assert s.device_s("engine.step") == pytest.approx(90e-6)
    assert s.device_s("ops.physics") == pytest.approx(30e-6)
    # host self time: a span's own less its child spans'
    assert s.rows[STEP].host_self_ns == 4 * US and s.rows["step_call"].host_self_ns == 4 * US
    assert s.rows[f"{STEP}>ops.spatial"].host_self_ns == 40 * US
    assert all(r.calls == 1 for r in s.rows.values() if r is not s.rows[UNMATCHED])
    # every gap, named by the innermost path at its middle
    assert sorted((path, round(d * 1e6, 6)) for path, d in s.gaps) == sorted([
        (f"{STEP}>engine.prepare", 30), (f"{STEP}>ops.spatial", 5), (f"{STEP}>ops.physics", 5),
        (f"{STEP}>engine.metrics", 30), ("read", 10), ("read", 15)])
    assert s.idle_s("engine.step") == pytest.approx(70e-6)
    assert "ops.spatial" in s.table() and "unmatched" in s.table()


def test_reduce_spans_leaves_the_window_numbers_as_they_were():
    """busy, operations, top operations and gap durations equal those of
    ``reduce_events`` on the same events without the program's spans and
    launches; 4-tuples still reduce, their operations unmatched."""
    s = reduce_spans(EVENTS, frames=2)
    plain = reduce_events([e[:4] for e in HARNESS + DEVICE], frames=2)
    assert s.trace == plain
    assert sorted(d for _p, d in s.gaps) == sorted(d for _n, d in plain.idle_gaps)
    t = reduce_spans([e[:4] for e in HARNESS + DEVICE], frames=2)
    assert t.trace == plain
    assert set(t.rows) == {"input", "step_call", "read", UNMATCHED}
    assert t.rows[UNMATCHED].device_ns / 1e9 == plain.busy_s
    assert not t.has("engine.step")
    gap_paths = {p for p, _d in reduce_spans(HARNESS + DEVICE[:1], frames=1).gaps}
    assert gap_paths <= {"input", "step_call", "read", BETWEEN}


# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------

FRAME_SPANS = ("ops.spatial", "behavior", "render.animation", "ops.physics", "ops.culling",
               "engine.metrics")


def boids_engine(n=399, seed=123456):
    eng = Engine(make_config(world_width=1200.0, world_height=800.0, seed=seed,
                             spatial=dict(cell_size=50.0, max_neighbors=400, cell_capacity=32),
                             physics=dict(sub_step_count=1)), device="cpu")
    eng.register_entity_class(Boid, n)
    eng.init()
    rng = np.random.default_rng(1)
    eng.spawn_batch("Boid", n, x=rng.uniform(50, 1150, n).astype(np.float32),
                    y=rng.uniform(50, 750, n).astype(np.float32))
    return eng


def span_paths(prof):
    """Counter of the paths of a profile's ``record_function`` ranges."""
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return Counter(path for path, _self in nest(spans)[2])


def test_boids_step_opens_each_span_once_a_frame():
    from torch.profiler import ProfilerActivity, profile

    eng = boids_engine()
    eng.step(1)  # the plan
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(2)
    want = {"engine.step": 1, "engine.step>engine.prepare": 1,
            "engine.step>behavior>behavior.Boid": 2}
    want.update({f"engine.step>{name}": 2 for name in FRAME_SPANS})
    assert span_paths(prof) == want


def test_events_particles_and_dispatch_spans():
    """The predators scene with events: pair rows and recording under
    ``ops.events`` twice a frame, ``ops.decals`` inside ``ops.particles``,
    ``ops.lighting``, the hooks under ``engine.dispatch_events``."""
    from torch.profiler import ProfilerActivity, profile

    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    eng = make_predators_engine(n_prey=60, n_predators=2, n_lights=1, device="cpu",
                                world_width=800.0, world_height=600.0,
                                logic=dict(collision_events=True))
    eng.step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(1)
    paths = span_paths(prof)
    assert paths["engine.step>ops.events"] == 2
    assert paths["engine.step>ops.particles>ops.decals"] == 1
    assert paths["engine.step>ops.lighting"] == 1
    assert paths["engine.step>engine.dispatch_events"] == 1
    assert all(path.startswith("engine.step") for path in paths)


def test_no_span_entered_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = boids_engine()
    eng.step(2)
    assert calls == []
    assert profiling.span("x") is profiling.span("y")  # one shared no-op context
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        eng.step(1)
    assert calls[0] == "engine.step" and "ops.spatial" in calls


# ---------------------------------------------------------------------------
# the neighbour counter
# ---------------------------------------------------------------------------

def test_neighbors_accepted_is_the_lists_counts_summed():
    eng = boids_engine()
    eng.step(1)
    world, inputs = eng.world, eng.input.snapshot("cpu")
    w = apply_inputs(world, inputs)
    t, c = w.transform, w.collider
    lists = neighbor_lists(t.x, t.y, t.active, c.visual_range, eng._plan.cfg)
    _w, metrics = eng._one_step(world, inputs)
    assert metrics["neighbors_accepted"].dtype == torch.int32
    assert int(metrics["neighbors_accepted"]) == int(lists.count.sum()) > 0


def test_neighbors_accepted_without_lists():
    eng = make_balls_engine(n_balls=50, seed=7, device="cpu")
    m = eng.step(1)
    assert int(m["neighbors_accepted"]) == -1 == int(m["n_binned"])


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def run_of(trace=None, built=None, summary=None):
    run = Run(workload="boids_102k.interactive", cfg={}, traffic={}, built=built, setup_s=1.0,
              calls=[], trace=trace)
    if summary is not None:
        run.span_summary = summary
    return run


def test_span_readers_read_the_summary():
    s = reduce_spans(EVENTS, frames=2)
    run = run_of(trace=s.trace, summary=s)
    assert spatial_ms.read(run) == pytest.approx(0.015)
    assert tick_ms.read(run) == pytest.approx(0.010)
    assert physics_ms.read(run) == pytest.approx(0.015)
    assert step_idle_ms.read(run) == pytest.approx(0.035)


@pytest.mark.parametrize("reader", [spatial_ms, tick_ms, physics_ms, step_idle_ms,
                                    neighbor_fill_pct])
def test_readers_find_nothing_without_a_trace(reader):
    assert reader.read(run_of()) is None
    # a program without spans: the harness's rows alone
    bare = reduce_spans([e[:4] for e in HARNESS + DEVICE], frames=2)
    assert reader.read(run_of(trace=bare.trace, summary=bare)) is None


def test_span_readers_on_the_cpu_trace_nothing():
    """A CPU run has no card: the readers that profile frames return None
    and run nothing."""
    eng = boids_engine(n=40)
    eng.step(1)
    run = run_of(trace=reduce_spans(EVENTS, 2).trace, built=Built(eng, {}, np.arange(40), 41))
    before = int(eng.world.step_count)
    assert spatial_ms.read(run) is None and step_idle_ms.read(run) is None
    assert int(eng.world.step_count) == before


def test_neighbor_fill_pct_reads_the_last_frame():
    eng = boids_engine()
    eng.step(2)
    w = eng.world
    t, c = w.transform, w.collider
    width = neighbor_lists(t.x, t.y, t.active, c.visual_range, eng._plan.cfg).ids.shape[1]
    run = run_of(trace=reduce_spans(EVENTS, 2).trace, built=Built(eng, {}, np.arange(399), 400))
    want = 100.0 * int(eng.metrics["neighbors_accepted"]) / (w.n_entities * width)
    assert neighbor_fill_pct.read(run) == pytest.approx(want)
    assert 0 < want < 100


class _Record:
    """A ``kineto_results`` record as torch 2.11 gives it."""

    def __init__(self, name, device, annotation=False, corr=0, linked=0):
        self._v = (name, device, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return 10

    def end_ns(self):
        return 20

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]


def test_event_of_tells_host_records_apart():
    from torch.autograd import DeviceType

    from bench_port.spans import event_of

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kinds = [event_of(_Record(*a)).kind for a in [
        ("ops.spatial", cpu, True), ("cudaLaunchKernel", cpu, False, 9, 6),
        ("cuLaunchKernel", cpu, False, 10), ("aten::copy_", cpu, False, 6),
        ("Activity Buffer Request", cpu, False, 6)]]
    assert kinds == ["span", "launch", "launch", "op", ""]
    k = event_of(_Record("Memcpy DtoD (Device -> Device)", cuda, False, 9, 6))
    assert k.is_device and (k.corr, k.linked) == (9, 6)
    # this torch's own records
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("engine.step"):
            torch.ones(3).sum()
    got = {(e.name, e.kind) for e in map(event_of, prof.profiler.kineto_results.events())}
    assert ("engine.step", "span") in got and ("aten::sum", "op") in got
