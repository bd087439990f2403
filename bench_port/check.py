"""The comparison that decides ``correct``: what the timed path produced
against the configuration's plain reference (``reference/<ref>.py``), at the
timed sizes.

The reference builds its own start from the harness's draws. Checked calls
start from the program's own state (its dynamic fields, cloned before the
call; the reference's static fields are its own), because a frame of
thousands of colliding circles amplifies rounding from frame to frame and
no two float32 runs stay together for long. Numbers, each in world units:

- ``spawn_gap``: the program's world before its first frame against the
  reference's start (x, y, px, py, vx, vy), exact;
- ``start_gap``: after the first call, from the reference's own start;
- ``step_gap``: after each checked call of the window, the largest.

``start_gap`` and ``step_gap`` are taken over the spawned entities' rows:
the mouse's row is the harness's input, set before the frame.

The configuration's ``limits`` says which numbers are compared and against
what: ``{"name": {"max": v}}`` or ``{"name": {"min": v}}``."""

from __future__ import annotations

import torch

from .harness import module
from .scenes.common import DYNAMIC


def gap(a: dict, b: dict, keys=("x", "y")) -> float:
    """The largest absolute difference over ``keys``, in float64."""
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)


def from_program(s0: dict, pre: dict) -> dict:
    """The reference's state with the program's dynamic fields."""
    s = dict(s0)
    s.update({k: pre[k].to(s0[k].device, s0[k].dtype) for k in DYNAMIC})
    return s


def numbers(cfg: dict, inputs: dict, rows, n_rows: int, device, samples,
            program=None) -> dict:
    """The check's numbers over ``samples`` (``drive.Sample``; the first is
    the first call of set-up). ``program(start, sample)``, when given,
    stands in for the program's outputs after ``sample``'s call from the
    reference's state ``start`` (the control: the reference in a lower
    precision; or a planted fault)."""
    ref = module("reference", cfg["reference"])
    s0 = ref.initial_state(cfg, inputs, rows, n_rows, device, torch.float32)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=s0["x"].device)
    first, rest = samples[0], samples[1:]
    out = {"spawn_gap": gap(first.pre, s0, ("x", "y", "px", "py", "vx", "vy"))}

    def post_gap(sample, start):
        post = sample.post if program is None else program(start, sample)
        r = ref.run(cfg, start, sample.inputs, sample.pre["step"])
        return gap({k: post[k].to(r[k].device)[rows] for k in ("x", "y")},
                   {k: r[k][rows] for k in ("x", "y")})

    out["start_gap"] = post_gap(first, s0)
    if rest:
        out["step_gap"] = max(post_gap(smp, from_program(s0, smp.pre)) for smp in rest)
    return out


def judge(numbers: dict, limits: dict) -> dict:
    """Each compared number with its limit and verdict; a limit whose number
    is missing fails."""
    out = {}
    for name, lim in limits.items():
        (op, bound), = lim.items()
        v = numbers.get(name)
        ok = v is not None and (v <= bound if op == "max" else v >= bound)
        out[name] = {"value": v, "limit": bound, "op": "<=" if op == "max" else ">=", "ok": ok}
    return out
