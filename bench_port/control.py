"""The two readings a limit of the check is set from, on the card at a cell's
own size: the program's numbers (the lower reading) over many seeds, and
the control's (the upper reading): the plain reference computed in
bfloat16, the nearest precision below the float32 the configurations state,
put in the program's place on the same checked calls. With the control,
planted faults are read too: a call that returns its state unchanged, one
that leaves every other entity out, and the reference with each ``--drop``
key of the configuration set to 0 (``boid.centering_factor``: a frame
without cohesion).

    python3 bench_port/control.py --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3] \\
        [--drop boid.centering_factor,boid.turn_factor] [--seconds 3] [--out FILE]

Each seed is one run of the cell (``harness.run_cell``) with a short window
and no trace, in this process; each prints one JSON line, also appended to
``--out``. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def variants(cfg: dict, drop=()) -> dict:
    """The control and the planted faults, each a ``program(start, sample)``."""
    import torch

    from bench_port.harness import module
    from bench_port.reference.physics import cast_state

    ref = module("reference", cfg["reference"])

    def reference(c, dtype=torch.float32):
        def program(start, smp):
            r = ref.run(c, cast_state(start, dtype), smp.inputs, smp.pre["step"])
            return {k: r[k].float() for k in ("x", "y")}

        return program

    def half(start, smp):
        keep = torch.arange(smp.post["x"].numel(), device=smp.post["x"].device) % 2 == 0
        return {k: torch.where(keep, smp.post[k], smp.pre[k]) for k in ("x", "y")}

    out = {"control": reference(cfg, torch.bfloat16),
           "unchanged": lambda start, smp: smp.pre,
           "half": half}
    for key in drop:
        c = copy.deepcopy(cfg)
        group, name = key.split(".")
        c[group][name] = 0.0
        out[f"no_{name}"] = reference(c)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--drop", default="", help="configuration keys set to 0 as faults")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness import cell, load_config, load_spec, run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = load_config(cell(load_spec(), args.workload)[1])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    drop = [k for k in args.drop.split(",") if k]
    for s in [int(s) for s in args.seeds.split(",")]:
        r = run_cell(args.workload, s, args.seconds, False, time.perf_counter(),
                     variants=variants(cfg, drop) if s in ctrl else None)
        line = json.dumps({"seed": s, "correct": r["correct"], "frames": r["attempted"],
                           "program": {k: c["value"] for k, c in r["checks"].items()},
                           **r.get("variants", {})})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
