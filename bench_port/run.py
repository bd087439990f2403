"""Run one cell of ``BENCHMARK.json`` once on the card this process starts on:

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``: each number compared with
its limit, also the last lines on standard error). It exits non-zero, and
prints no result, without a CUDA card, with fewer cards than the cell asks
for, or when the process has loaded JAX or the JAX package.

Caches stay inside the checkout: the port builds its kernels into
``build/kernels/``, and Triton and PyTorch's extension builds are pointed at
``build/triton`` and ``build/torch_extensions``."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness import cell, load_spec, run_cell

    spec = load_spec()
    wl, _ = cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed % (1 << 63), args.seconds, bool(args.trace),
                      T_START)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
