"""The mixed ecosystem (BASELINE config 5) of the PyTorch port against the
benchmark's plain reference (``bench_port/reference/mixed.py``), on the CPU
at a tiny size: the configuration ``mixed_1m`` cut to 2,000 prey (8
predators, 5 lights, the world cut to keep the density) by the benchmark's
own ``tiny``, two calls of 10 frames.

- the port passes the configuration's limits, and each planted fault (no
  flee, no hunt, no cohesion, the state unchanged) and the bfloat16
  control fail them;
- the reference's start holds the port's per-slot draws (the prey's speeds
  and ranges from the engine's seeded stream), radii and entity types;
- each frame's predator-prey contacts in the chunked event log, and the
  pairs the predators' stay hook is handed, are the reference's;
- ``lists_fill_pct``'s candidate slots are the lists' rows x (2r + 1)^2 x
  capacity, summed;
- one chunk's profile opens ``spatial.Prey``, ``behavior.Prey`` and
  ``engine.event_log``;
- the cell's four readers find nothing in a run without those spans.
"""

from collections import Counter

import pytest
import torch

from bench_port import check
from bench_port.control import variants
from bench_port.drive import Drive
from bench_port.harness import Run
from bench_port.metrics import event_log_ms, lists_fill_pct, prey_lists_ms, prey_tick_ms
from bench_port.reference import mixed as ref
from bench_port.scenes import mixed
from bench_port.spans import nest, reduce_spans
from bench_port.tests.tiny import tiny
from bench_port.trace import WINDOW

WORKLOAD = "mixed_1m.chunk30"
N_PREY = 2000
FAULTS = ["boid.centering_factor", "prey.predator_avoid_factor", "predator.hunt_factor"]


def scene(frames=10):
    return tiny(WORKLOAD, N_PREY, frames_per_call=frames, warmup_calls=1)


@pytest.fixture(scope="module")
def checked():
    """The harness's drive and check (``harness.run_cell`` without its
    timing, which refuses a process that has loaded JAX, as this one has):
    the first call and one window call, both checked."""
    cfg, traffic = scene()
    seed = 2**31 + 19
    built = mixed.build(cfg, seed, "cpu")
    d = Drive(built=built, cfg=cfg, traffic=traffic, seed=seed, guards=cfg["guards"])
    d.call(check=True)
    d.window(0.0)
    args = (cfg, mixed.draw(cfg, seed), built.rows, built.n_rows, "cpu", d.samples)
    out = {name: check.numbers(*args, program=fn)
           for name, fn in variants(cfg, FAULTS).items() if name != "half"}
    return cfg, d, check.numbers(*args), out


def test_the_port_passes_the_limits(checked):
    cfg, d, numbers, _faults = checked
    assert not d.failures and len(d.calls) == 2 and len(d.samples) == 2
    assert set(numbers) == {"spawn_gap", "start_gap", "step_gap"}
    assert numbers["spawn_gap"] == 0.0
    assert all(v["ok"] for v in check.judge(numbers, cfg["limits"]).values()), numbers


@pytest.mark.parametrize("name", ["control", "unchanged", "no_centering_factor",
                                  "no_predator_avoid_factor", "no_hunt_factor"])
def test_each_fault_fails_the_limits(checked, name):
    cfg, _d, _numbers, faults = checked
    verdicts = check.judge(faults[name], cfg["limits"])
    assert not all(v["ok"] for v in verdicts.values()), (name, faults[name])


def test_the_event_log_and_hooks_carry_the_references_contacts(monkeypatch):
    """One overlapped chunk from spawn: each frame's Stay rows in the log
    (the one kind the predators hook) are the reference's predator-prey
    contacts of that frame and the last, and the predators' stay hook gets
    each frame's Stay pairs. A pair within ``EPS`` of touching, or of the
    lists' range, in either program may fall either way: the two float32
    programs part by ulps."""
    from multithreadedgameengine_tpu_torch.engine import Engine
    from multithreadedgameengine_tpu_torch.models.predators import Predator

    EPS = 0.01
    logs, fired = [], []
    dispatch, hook = Engine._dispatch_logged_events, Predator.on_collision_stay_batch

    def logged(self, log):
        logs.append(log.tables())
        dispatch(self, log)

    def stay_batch(ctx, me, other):
        fired.append({(int(a), int(b)) for a, b in zip(me, other)
                      if ctx.type_of(int(b)) == ref.PREY})
        hook(ctx, me, other)

    monkeypatch.setattr(Engine, "_dispatch_logged_events", logged)
    monkeypatch.setattr(Predator, "on_collision_stay_batch", staticmethod(stay_batch))
    cfg, _traffic = scene()
    k = cfg["logic"]["event_chunk"]  # the cell's chunk
    built = mixed.build(cfg, 2**31 + 23, "cpu")
    eng = built.engine
    s = ref.initial_state(cfg, built.inputs, built.rows, built.n_rows, "cpu", torch.float32)
    step0 = int(eng.world.step_count)
    eng.step(k)
    eng.sync()  # fires the held chunk's hooks
    (tables,) = logs

    def pairs(tag, f):
        ids, counts, _coords = tables[tag]
        out = set()
        for a, b in ids[f, :int(counts[f])].tolist():
            pred, prey = (a, b) if s["entity_type"][a] == ref.PREDATOR else (b, a)
            if s["entity_type"][pred] == ref.PREDATOR and s["entity_type"][prey] == ref.PREY:
                out.add((pred, prey))
        return out

    inp = dict(mouse_x=0.0, mouse_y=0.0, mouse_down=False)
    sure_prev, maybe_prev = set(), set()
    stays, n_contacts = [], 0
    for f in range(k):
        sure, maybe = ref.contacts(cfg, s, -EPS), ref.contacts(cfg, s, EPS)
        stay = pairs("event_stay", f)
        assert sure & sure_prev <= stay <= maybe & maybe_prev, (f, sure & sure_prev, stay)
        n_contacts += len(sure)
        if stay:
            stays.append(stay)
        sure_prev, maybe_prev = sure, maybe
        s = ref.run(cfg, s, [inp], step0 + f)
    assert n_contacts > 0 and stays, "the chunk held no lasting predator-prey contact"
    assert fired == stays


def test_the_reference_start_holds_the_ports_draws():
    """Prey.setup's per-slot max_vel and visual_range (the engine's stream),
    every radius and entity type, and the world before the first frame."""
    cfg, _traffic = scene()
    built = mixed.build(cfg, 2**31 + 5, "cpu")
    eng, rows = built.engine, torch.as_tensor(built.rows)
    s0 = ref.initial_state(cfg, built.inputs, built.rows, built.n_rows, "cpu", torch.float32)
    w = eng.world
    assert built.n_rows == w.n_entities == N_PREY + 8 + 5 + 1
    for mine, theirs in ((s0["max_vel"], w.rigid_body.max_vel),
                         (s0["visual_range"], w.collider.visual_range),
                         (s0["radius"], w.collider.radius),
                         (s0["entity_type"], w.transform.entity_type.long()),
                         (s0["static"], w.rigid_body.static)):
        assert torch.equal(mine[rows], theirs[rows])
    assert {name: reg.entity_type for name, reg in eng.classes.items()
            if reg.count} == {"Mouse": ref.MOUSE, "Prey": ref.PREY, "Predator": ref.PREDATOR,
                              "TallLight": ref.LIGHT}
    prey = s0["entity_type"] == ref.PREY
    assert 1.5 <= float(s0["max_vel"][prey].min()) and float(s0["max_vel"][prey].max()) < 3.5
    assert len(set(s0["visual_range"][prey].tolist())) > N_PREY // 2


def test_neighbor_slots_is_rows_times_cells_times_capacity():
    cfg, _traffic = scene()
    eng = mixed.build(cfg, 7, "cpu").engine
    eng.step(1)
    plan = eng._plan
    cap = cfg["spatial"]["cell_capacity"]
    assert [(name, count, r) for name, _s, count, r in plan.nbr_specs] == [
        ("Prey", N_PREY, 1), ("Predator", 8, 2), ("TallLight", 5, 2)]
    slots = lists_fill_pct.slots(plan)
    assert slots == (N_PREY * 9 + 8 * 25 + 5 * 25) * cap
    accepted = int(eng.metrics["neighbors_accepted"])
    assert 0 < accepted < slots


def test_one_chunk_opens_the_class_and_event_log_spans():
    from torch.profiler import ProfilerActivity, profile

    cfg, _traffic = scene()
    eng = mixed.build(cfg, 11, "cpu").engine
    eng.step(1)  # the plan
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(2)  # one chunk of 2 frames
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    paths = Counter(path for path, _self in nest(spans)[2])
    assert paths["engine.step>ops.spatial>spatial.Prey"] == 2
    assert paths["engine.step>ops.spatial>spatial.Predator"] == 2
    assert paths["engine.step>behavior>behavior.Prey"] == 2
    assert paths["engine.step>behavior>behavior.Predator"] == 2
    assert paths["engine.step>engine.event_log"] == 3  # a write a frame, the chunk's copy


def _events():
    """A window with the harness's spans and the boids scene's frame spans:
    no class span, no event log."""
    us = 1000
    return [(WINDOW, False, 0, 100 * us), ("step_call", False, 0, 90 * us),
            ("engine.step", False, 1 * us, 80 * us), ("ops.spatial", False, 2 * us, 20 * us),
            ("behavior", False, 20 * us, 40 * us), ("k1", True, 10 * us, 30 * us)]


@pytest.mark.parametrize("reader", [prey_lists_ms, prey_tick_ms, event_log_ms, lists_fill_pct])
def test_readers_find_nothing_without_the_spans(reader):
    run = Run(workload=WORKLOAD, cfg={}, traffic={}, built=None, setup_s=1.0, calls=[])
    assert reader.read(run) is None
    summary = reduce_spans(_events(), frames=1)
    run = Run(workload=WORKLOAD, cfg={}, traffic={}, built=None, setup_s=1.0, calls=[],
              trace=summary.trace)
    run.span_summary = summary
    assert reader.read(run) is None


def test_lists_fill_pct_reads_the_plans_slots():
    cfg, _traffic = scene()
    built = mixed.build(cfg, 13, "cpu")
    built.engine.step(1)
    run = Run(workload=WORKLOAD, cfg=cfg, traffic={}, built=built, setup_s=1.0, calls=[],
              trace=reduce_spans(_events(), frames=1).trace)
    eng = built.engine
    want = 100.0 * int(eng.metrics["neighbors_accepted"]) / lists_fill_pct.slots(eng._plan)
    assert lists_fill_pct.read(run) == pytest.approx(want)
    # a plan without per-class lists: nothing
    eng._plan = type("Plan", (), {})()
    assert lists_fill_pct.read(run) is None
