"""The one traffic generator: it reads a traffic mix (``traffic/<mix>.json``)
and drives the engine under test through ``Engine.step`` in calls of
``frames_per_call`` frames, as a viewer or a player would:

- ``frames_per_call``: frames a call steps, with the inputs of the call;
- ``read_positions``: after each call, every entity's x and y are copied
  to the host with the frame's counters (else the counters alone);
- ``mouse``: null, or ``{"held", "waypoints", "speed", "margin"}``: the
  mouse moves every call along a closed path through ``waypoints`` points
  drawn from the seed inside the world less ``margin``, ``speed`` world
  units a frame, its button held down when ``held``;
- ``warmup_calls``: calls made in set-up, the first of them the start of
  the correctness check;
- ``trace_calls``: calls profiled in a traced run, after the window;
- ``check_calls`` and ``check_span``: how many of the window's first
  ``check_span`` calls, drawn from the seed, are checked against the
  reference (only calls that start on a rebin frame of the configuration's
  ``physics.rebin_interval``).

Each call is timed from setting its input to its result read on the host.
The window ends with the first call that completes after ``seconds``."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .scenes.common import capture


@dataclass
class Call:
    frames: int
    t_input: float  # perf_counter before the input is set
    t_call: float  # before Engine.step was called
    t_step: float  # after Engine.step returned
    t_read: float  # after the result was read on the host
    ok: bool  # every guard held after the call


@dataclass
class Sample:
    """A checked call: the state before it, the state after it, and the
    inputs of its frames."""

    pre: dict
    post: dict
    inputs: list


@dataclass
class Drive:
    built: object
    cfg: dict
    traffic: dict
    seed: int
    guards: dict
    frame: int = 0  # frames stepped so far
    calls: List[Call] = field(default_factory=list)
    samples: List[Sample] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)
    _path: Optional[tuple] = None

    def __post_init__(self):
        m = self.traffic.get("mouse")
        if m:
            rng = np.random.default_rng([self.seed, 2])
            w, h, g = self.cfg["world_width"], self.cfg["world_height"], m["margin"]
            pts = np.stack([g + rng.random(m["waypoints"]) * (w - 2 * g),
                            g + rng.random(m["waypoints"]) * (h - 2 * g)], axis=1)
            seg = np.roll(pts, -1, axis=0) - pts
            lens = np.hypot(seg[:, 0], seg[:, 1])
            self._path = (pts, seg, lens, np.concatenate([[0.0], np.cumsum(lens)]))

    def frame_input(self) -> dict:
        """The input of the call that starts at frame ``self.frame``."""
        if self._path is None:
            return dict(mouse_x=0.0, mouse_y=0.0, mouse_down=False)
        pts, seg, lens, cum = self._path
        d = (self.frame * self.traffic["mouse"]["speed"]) % cum[-1]
        k = int(np.searchsorted(cum, d, side="right") - 1)
        f = (d - cum[k]) / lens[k]
        x, y = pts[k] + f * seg[k]
        return dict(mouse_x=float(np.float32(x)), mouse_y=float(np.float32(y)),
                    mouse_down=bool(self.traffic["mouse"]["held"]))

    def check_plan(self) -> set:
        """The window-relative indices of the calls to check."""
        k = self.traffic["frames_per_call"]
        rebin = max(1, self.cfg["physics"].get("rebin_interval", 1))
        eligible = [i for i in range(self.traffic["check_span"]) if (self.frame + i * k) % rebin == 0]
        rng = np.random.default_rng([self.seed, 1])
        n = min(self.traffic["check_calls"], len(eligible))
        return set(int(i) for i in rng.choice(eligible, n, replace=False))

    def call(self, spans: bool = False, check: bool = False) -> Call:
        import torch

        eng = self.built.engine
        k = self.traffic["frames_per_call"]
        span = torch.profiler.record_function if spans else (lambda _n: contextlib.nullcontext())
        t0 = time.perf_counter()
        with span("input"):
            inp = self.frame_input()
            if self._path is not None:
                eng.input.set_mouse(inp["mouse_x"], inp["mouse_y"])
                eng.input.mouse_button(0, inp["mouse_down"])
            pre = capture(eng) if check else None
        with span("step_call"):
            tc = time.perf_counter()
            metrics = eng.step(k)
            t1 = time.perf_counter()
        with span("read"):
            names = sorted(self.guards)
            counters = torch.stack([metrics[n].to(torch.int64) for n in names]).cpu()
            if self.traffic["read_positions"]:
                w = eng.world
                torch.stack([w.transform.x, w.transform.y]).cpu()
        t2 = time.perf_counter()
        if check:
            self.samples.append(Sample(pre=pre, post=capture(eng), inputs=[inp] * k))
        bad = [f"{n}={int(v)}" for n, v in zip(names, counters.tolist())
               if int(v) != self._expected(self.guards[n])]
        if bad:
            self.failures.append(f"frames {self.frame}-{self.frame + k - 1}: " + ", ".join(bad))
        self.frame += k
        c = Call(frames=k, t_input=t0, t_call=tc, t_step=t1, t_read=t2, ok=not bad)
        self.calls.append(c)
        return c

    def _expected(self, v) -> int:
        return self.built.n_rows if v == "rows" else int(v)

    def window(self, seconds: float, check: bool = True) -> List[Call]:
        """Calls until ``seconds`` have passed since the first began."""
        plan = self.check_plan() if check else set()
        first = len(self.calls)
        t0 = time.perf_counter()
        i = 0
        while True:
            self.call(check=i in plan)
            i += 1
            if self.calls[-1].t_read - t0 >= seconds:
                break
        return self.calls[first:]


def p95(values) -> float:
    """The 95th percentile, inclusive method, of all values."""
    import statistics

    return statistics.quantiles(values, n=100, method="inclusive")[94] if len(values) > 1 else values[0]


def window_seconds(calls) -> float:
    return calls[-1].t_read - calls[0].t_input


def frames_of(calls) -> int:
    return sum(c.frames for c in calls)
