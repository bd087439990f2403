"""The program's spans in a traced window. The port's engine names its calls
into each layer with ``record_function`` ranges while a profiler records
(``profiling.span``: ``engine.step``, ``ops.spatial``, ``behavior``,
``ops.physics``, ...); here they are read off the profiler's own timeline:

- each device operation (kernel, copy, set) goes to the innermost span
  open on the host when its launch was issued. The launch is the host's
  CUDA API record (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with the
  operation's correlation id, else the PyTorch operator the operation is
  linked to. An operation issued outside
  every program span goes to the harness span open then (``input``,
  ``step_call``, ``read``), one whose launch the trace lacks to
  ``unmatched``;
- a span is named by its path from the harness span down,
  ``step_call>engine.step>ops.spatial``, and has its host self time (its
  own time less its child spans'), its device time and its operations;
- the device time is the window's busy time (``trace.reduce_events``)
  split: the operations in start order, each taking the part of its
  interval no earlier one covered, so the spans' device time sums exactly
  to the busy time;
- every idle gap is named by the path open at its middle.

The window's own numbers are ``trace.reduce_events`` of the same events,
unchanged. A program without spans leaves every operation under the
harness's spans, and the readers of the program's spans find nothing.

The metrics that read the spans (``spatial_ms``, ``tick_ms``,
``physics_ms``, ``step_idle_ms``) share one traced window (:func:`of_run`):
``trace_calls`` more calls of the cell's traffic on its engine after the
harness's traced window, profiled with the harness's spans on."""

from __future__ import annotations

import sys
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from .trace import SPANS, WINDOW, TraceSummary, _union, reduce_events

SEP = ">"
UNMATCHED = "unmatched"
BETWEEN = "between_spans"


class Event(NamedTuple):
    """One profiler record. ``kind`` is a host record's: ``span`` (a
    ``record_function`` range), ``launch`` (a CUDA API call) or ``op`` (a
    PyTorch operator). ``corr`` is the record's correlation id;
    ``linked`` a device operation's operator's."""

    name: str
    is_device: bool
    start_ns: int
    end_ns: int
    kind: str = ""
    corr: int = 0
    linked: int = 0


@dataclass
class SpanRow:
    calls: int = 0
    host_self_ns: int = 0
    device_ns: int = 0
    device_ops: int = 0


@dataclass
class SpanSummary:
    trace: TraceSummary  # reduce_events of the same events
    frames: int
    rows: Dict[str, SpanRow] = field(default_factory=dict)  # by path
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # every gap, longest first

    def has(self, name: str) -> bool:
        return any(name in path.split(SEP) for path in self.rows)

    def device_s(self, name: str) -> float:
        """Device seconds of the operations issued under ``name``, its
        child spans' included."""
        return sum(r.device_ns for path, r in self.rows.items() if name in path.split(SEP)) / 1e9

    def idle_s(self, name: str) -> float:
        """Seconds of the idle gaps whose middle lies under ``name``."""
        return sum(s for path, s in self.gaps if name in path.split(SEP))

    def table(self) -> str:
        f = self.frames
        idle: Dict[str, float] = {}
        for path, s in self.gaps:
            idle[path] = idle.get(path, 0.0) + s
        lines = [f"spans over {f} traced frames, a frame: host self ms, device ms, device ops, "
                 f"calls, idle ms (gaps by the path at their middle); path"]
        for path in sorted(set(self.rows) | set(idle)):
            r = self.rows.get(path, SpanRow())
            lines.append(f"  {r.host_self_ns / 1e6 / f:9.4f} {r.device_ns / 1e6 / f:9.4f} "
                         f"{r.device_ops / f:8.2f} {r.calls / f:6.2f} "
                         f"{idle.get(path, 0.0) * 1e3 / f:8.4f}  {path}")
        dev = sum(r.device_ns for r in self.rows.values())
        lines.append(f"  device ms a frame {dev / 1e6 / f:.4f} in all, busy "
                     f"{self.trace.busy_s * 1e3 / f:.4f}; idle ms a frame "
                     f"{sum(s for _p, s in self.gaps) * 1e3 / f:.4f}")
        return "\n".join(lines)


def nest(spans):
    """Paths of nested host spans. ``spans``: (start, end, name). Returns
    (the innermost path from each boundary on: times and paths, "" where no
    span is open; each span's (path, self ns))."""
    times, paths, done = [], [], []
    stack = []  # [end, path, start, child ns]

    def pop():
        end, path, start, child = stack.pop()
        done.append((path, end - start - child))
        if stack:
            stack[-1][3] += end - start
        times.append(end)
        paths.append(stack[-1][1] if stack else "")

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            pop()
        path = stack[-1][1] + SEP + name if stack else name
        stack.append([e, path, s, 0])
        times.append(s)
        paths.append(path)
    while stack:
        pop()
    return times, paths, done


def reduce_spans(events, frames: int) -> SpanSummary:
    """``events``: :class:`Event` or (name, is_device, start_ns, end_ns)
    tuples of one profile."""
    events = [Event(*e) for e in events]
    trace = reduce_events([e[:4] for e in events], frames)
    w0, w1 = next((e.start_ns, e.end_ns) for e in events
                  if not e.is_device and e.name == WINDOW)
    spans = [(e.start_ns, e.end_ns, e.name) for e in events
             if not e.is_device and e.name != WINDOW and (e.kind == "span" or e.name in SPANS)]
    times, paths, done = nest(spans)

    def path_at(t):
        i = bisect_right(times, t) - 1
        return (paths[i] if i >= 0 else "") or BETWEEN

    rows: Dict[str, SpanRow] = {}

    def row(path):
        return rows.setdefault(path, SpanRow())

    for path, self_ns in done:
        r = row(path)
        r.calls += 1
        r.host_self_ns += self_ns
    launches = {e.corr: e.start_ns for e in events
                if not e.is_device and e.kind == "launch" and e.corr}
    ops = {e.corr: e.start_ns for e in events if not e.is_device and e.kind == "op" and e.corr}
    dev = sorted((max(e.start_ns, w0), min(e.end_ns, w1), e) for e in events
                 if e.is_device and e.end_ns > w0 and e.start_ns < w1
                 and e.name not in SPANS and e.name != WINDOW)
    covered = w0
    for s, end, e in dev:
        t = launches.get(e.corr) if e.corr else None
        if t is None and e.linked:
            t = ops.get(e.linked)
        r = row(UNMATCHED if t is None else path_at(t))
        r.device_ops += 1
        r.device_ns += max(0, end - max(s, covered))
        covered = max(covered, end)
    # the gaps of reduce_events, each named by the path at its middle
    busy = _union([(s, end) for s, end, _e in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(path_at((s + end) / 2), (end - s) / 1e9)
            for s, end in zip(edges[0::2], edges[1::2]) if end > s]
    gaps.sort(key=lambda g: -g[1])
    return SpanSummary(trace=trace, frames=frames, rows=rows, gaps=gaps)


def event_of(e) -> Event:
    """An :class:`Event` of one ``kineto_results`` record. A host record is
    told by its name (torch 2.11's records carry no activity type): the
    CUDA API's calls are ``cu...``, an operator's ``namespace::name``."""
    import torch

    name = e.name()
    kind = ("span" if e.is_user_annotation() else "op" if "::" in name
            else "launch" if name.startswith("cu") else "")
    return Event(name, e.device_type() == torch.autograd.DeviceType.CUDA, e.start_ns(),
                 e.end_ns(), kind, e.correlation_id(), e.linked_correlation_id())


def profile_events(prof) -> List[Event]:
    """The :class:`Event` records of a finished ``torch.profiler`` profile.
    A span's annotation on the device's timeline is no device operation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [event_of(e) for e in prof.profiler.kineto_results.events()
            if not (e.is_user_annotation() and e.device_type() == cuda)]


def traced_spans(run_calls: Callable[[], int]) -> SpanSummary:
    """Profile ``run_calls()`` (which returns the frames it ran) inside the
    window span, as ``trace.traced`` does, and reduce its spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            frames = run_calls()
            torch.cuda.synchronize()
    return reduce_spans(profile_events(prof), frames)


def of_run(run) -> Optional[SpanSummary]:
    """The span summary of a traced run on the card, made once and kept on
    the run (``run.span_summary``) for every reader; None without a trace or
    a card. The calls drive the cell's traffic on from the engine's frame,
    the mouse on the traffic's path for seed 0."""
    if hasattr(run, "span_summary"):
        return run.span_summary
    if run.trace is None or run.built is None or run.built.engine.device.type != "cuda":
        return None
    from .drive import Drive

    eng = run.built.engine
    d = Drive(built=run.built, cfg=run.cfg, traffic=run.traffic, seed=0,
              guards=run.cfg["guards"], frame=int(eng.world.step_count))
    run.span_summary = traced_spans(
        lambda: sum(d.call(spans=True).frames for _ in range(run.traffic["trace_calls"])))
    print(run.span_summary.table(), file=sys.stderr)
    return run.span_summary


def per_frame_ms(run, name: str) -> Optional[float]:
    """Device ms a frame of the operations issued under span ``name``; None
    where the program opens no such span."""
    s = of_run(run)
    if s is None or not s.has(name):
        return None
    return 1e3 * s.device_s(name) / s.frames
