"""The traced window: ``torch.profiler`` over a few calls of the cell's
traffic, reduced to the device's busy time (the union of its kernel, copy
and set intervals inside the window), its operations, the operations that
took most time, and the longest idle gaps named by the harness's host span
(``input``, ``step_call``, ``read``) that was open at the gap's middle.

The busy-time arithmetic is the device side of the repository's
``torch_profile.py`` (``device_us``, ``torch_profile.py:247-254``): device
time from the profiler's CUDA activity, failing rather than reporting when
there is none; here the intervals are merged, so that overlapping
operations count once."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

WINDOW = "bench_window"
SPANS = ("input", "step_call", "read")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: int
    frames: int
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, frames: int, top: int = 10) -> TraceSummary:
    """``events``: (name, is_device, start_ns, end_ns) of one profile."""
    win = [(s, e) for name, dev, s, e in events if not dev and name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events
           if d and e > w0 and s < w1 and n not in SPANS and n != WINDOW]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the window")
    busy = _union([(s, e) for _n, s, e in dev])
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e, n) for n, d, s, e in events if not d and n in SPANS)
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            label = next((n for ss, ee, n in spans if ss <= mid <= ee), "between_spans")
            gaps.append((label, (e - s) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device_ops=len(dev),
        frames=frames,
        top_ops=[(n, ns / 1e9) for n, ns in top_ops],
        idle_gaps=gaps[:top],
    )


def traced(run_calls: Callable[[], int]) -> TraceSummary:
    """Profile ``run_calls()`` (which returns the frames it ran) inside the
    window span, and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            frames = run_calls()
            torch.cuda.synchronize()
    # a host span also shows on the device's timeline, as a user annotation
    # around the operations it issued: it is no device operation
    events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA, e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if not (e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CUDA)]
    return reduce_events(events, frames)


def device_seconds(fn: Callable[[], None], reps: int) -> float:
    """Device seconds one call of ``fn`` takes: the sum of its operations'
    device time over ``reps`` calls under the profiler, over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation())
    if ns <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return ns / 1e9 / reps
