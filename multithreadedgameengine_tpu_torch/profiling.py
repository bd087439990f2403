"""Step timing, the init timeline, per-phase profiling and the frame's spans.

PyTorch counterpart of ``multithreadedgameengine_tpu/profiling.py:24-136``:
 - the per-worker moving-average FPS panels (AbstractWorker.js:66-104,
   gameEngine.js:1326-1381) -> :class:`StepTimer`, a 60-sample moving
   average of host wall time per simulated step;
 - the opt-in logic-phase profiler (logic_worker.js:559-608) ->
   :class:`PhaseProfiler`: each phase run alone and timed
   (``profile_phases``), and a ``torch.profiler`` trace (``trace``);
 - the init-timeline log (AbstractWorker.js:106-108) -> :class:`TimelineLog`.

Times on the card are CUDA events around the repetitions, ended by a
synchronise; on the CPU, ``time.perf_counter``.

:func:`span` names the engine's calls into each layer on the profiler's
own timeline (``record_function`` ranges, on the clock of the card's
kernel and copy records), and only while a profiler runs; otherwise it
costs one check. The engine opens, nested as listed:

- ``engine.step``: each ``Engine.step`` call (a frame stepped alone inside
  ``step(n)`` opens its own); ``engine.run_plan``: each plan chunk;
- ``engine.prepare``: the plan build, the queued writes and emissions
  landing, the input snapshot;
- in each frame: ``ops.spatial`` (the neighbour lists and the payload
  reads; per-class lists open ``spatial.<class name>`` around each class's
  gather and acceptance), ``behavior`` (the ticks, each class's inside
  ``behavior.<class name>``), ``render.animation``, ``ops.physics``
  (the move, the solver, the derived properties), ``ops.events`` (the pair
  rows, the recording and the Enter/Stay/Exit difference; events on
  only), ``ops.particles`` with ``ops.decals`` inside it, ``ops.culling``
  (visibility and screen events), ``ops.lighting`` (shadow sprites),
  ``engine.metrics``;
- ``ops.physics.lazy``: a lazy-chunk frame;
- ``engine.event_log``: the chunked event log's write after each frame,
  and its copy to the host after the chunk;
- ``engine.dispatch_events``: the hooks fired after a frame or a chunk.

The slab, homed, sharded and process-mesh steps (``parallel``) and the
render server open none.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, List

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class StepTimer:
    """60-frame moving average of per-step wall time (the FPS panel math,
    AbstractWorker.js:66-88)."""

    WINDOW = 60

    def __init__(self):
        self._samples: deque = deque(maxlen=self.WINDOW)
        self.total_steps = 0

    def record(self, seconds_per_step: float, steps: int = 1) -> None:
        self._samples.append(seconds_per_step)
        self.total_steps += steps

    @property
    def steps_per_sec(self) -> float:
        if not self._samples:
            return 0.0
        avg = sum(self._samples) / len(self._samples)
        return 1.0 / avg if avg > 0 else 0.0

    @property
    def ms_per_step(self) -> float:
        if not self._samples:
            return 0.0
        return 1000.0 * sum(self._samples) / len(self._samples)


class TimelineLog:
    """reportLog analog: messages with wall-clock offsets from engine start."""

    def __init__(self):
        self._t0 = time.time()
        self.entries: List[tuple] = []

    def log(self, message: str) -> None:
        self.entries.append((time.time() - self._t0, message))

    def format(self) -> str:
        return "\n".join(f"[{t:8.3f}s] {m}" for t, m in self.entries)


class PhaseProfiler:
    """Per-phase timing, each phase run alone on the engine's world (the
    logic worker's per-phase timers), and ``torch.profiler`` traces."""

    def __init__(self, engine):
        self._engine = engine
        self.last: Dict[str, float] = {}

    def profile_phases(self, reps: int = 10) -> Dict[str, float]:
        """ms per run of each phase of one frame, alone: ``spatial`` (the
        neighbour lists), ``logic`` (the ticks), ``verlet_move``,
        ``derived`` and ``full_step``. Phases inside a frame share work, so
        their sum bounds the frame from above; their ratios locate the hot
        spots. The engine's world is not changed."""
        import torch

        from .behavior import run_logic_phase
        from .ops.physics import update_derived, verlet_move
        from .ops.spatial import neighbor_lists

        eng = self._engine
        eng._require_init()
        if eng._plan is None:
            eng._plan = eng._build_plan()
        eng._flush_pending()
        plan = eng._plan
        cfg = plan.cfg
        world = eng.world.map_tensors(lambda a: a.clone())
        inputs = eng.input.snapshot(eng.device)
        cuda = eng.device.type == "cuda"

        def timed(name, fn):
            out = fn()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(eng.device)
                start.record()
                for _ in range(reps):
                    out = fn()
                end.record()
                end.synchronize()
                self.last[name] = start.elapsed_time(end) / reps
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = fn()
                self.last[name] = (time.perf_counter() - t0) / reps * 1000.0
            return out

        t, c = world.transform, world.collider
        nbr = timed("spatial", lambda: neighbor_lists(t.x, t.y, t.active, c.visual_range, cfg))
        timed("logic", lambda: run_logic_phase(world, nbr, inputs, cfg, plan.type_ranges)[0])
        timed("verlet_move", lambda: verlet_move(world, cfg, cfg.dt_ratio))
        timed("derived", lambda: update_derived(world, cfg))
        timed("full_step", lambda: eng._one_step(world, inputs)[0])
        return dict(self.last)

    def trace(self, path: str, steps: int = 10) -> str:
        """A ``torch.profiler`` trace of ``steps`` frames (host, and the
        card's kernels on CUDA), written as a Chrome trace to ``path``.
        The trace holds the engine's spans (:func:`span`): ``engine.step``
        around the call, ``engine.prepare``, and in each frame
        ``ops.spatial``, ``behavior``, ``render.animation``,
        ``ops.physics``, ``ops.events``, ``ops.particles``/``ops.decals``,
        ``ops.culling``, ``ops.lighting`` and ``engine.metrics``, as the
        scene runs them; ``engine.dispatch_events`` after the frames."""
        from torch.profiler import ProfilerActivity, profile

        eng = self._engine
        activities = [ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            eng.step(steps, block=True)
        prof.export_chrome_trace(path)
        return path
