"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

The sources are the ``.cu`` files under ``multithreadedgameengine_tpu_torch/
csrc``. They are compiled at first use, never at import, into
``build/kernels/`` at the checkout's root (listed in ``.gitignore``): one
library per source, named by a hash of that source, every ``csrc/*.cuh``
header and the flags, so an edited source or header rebuilds and an
unchanged one loads the cached library. The nvcc runs for all sources start
together and run in parallel; each one's ``-Xptxas -v`` report (registers,
shared memory and spills of every kernel) is kept beside its library as
``<library>.ptxas.txt``. Each library exposes plain C functions that
``ops/cuda_kernels.py`` binds with ``ctypes``; nothing here includes
PyTorch's headers, which keeps a build to seconds.

A missing ``nvcc`` or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a: Hopper. --fmad=false keeps a*b+c as two rounded operations, as the
# plain PyTorch version computes it; no --use_fast_math, so sqrtf and the
# division stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
#: the C functions of each source: (name, argument types, result type); the
#: launch comes first
ENTRY_POINTS = {
    "boid_tick.cu": (
        ("boid_tick_launch", [_P, _P, _I, _I, _F, _F, _F, _P], _I),
        ("prey_tick_launch", [_P, _P, _I, _I, _F, _F, _F, _I, _P], _I),
    ),
    "expand.cu": (
        ("expand_launch", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P], _I),
        ("expand_plan", [_I, _P], _I),
    ),
    "neighbor_build.cu": (
        ("neighbor_build_launch", [_P] * 10 + [_I] * 8 + [_P], _I),
    ),
    "pair_pass_grid.cu": (
        ("pair_pass_grid_launch", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _P], _I),
        ("pair_pass_grid_max_cap", [], _I),
        ("pair_pass_grid_tile", [_I, _I, _I, _P], _I),
    ),
    "pair_pass_resident.cu": (
        ("pair_pass_resident_launch", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _P], _I),
        ("pair_pass_resident_max_cap", [], _I),
        ("pair_pass_resident_tile", [_I, _I, _I, _P], _I),
    ),
    "pair_pass_symmetric.cu": (
        ("pair_pass_symmetric_launch",
         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _I, _F, _F, _P], _I),
        ("pair_pass_symmetric_max_cap", [], _I),
        ("pair_pass_symmetric_tile", [_I, _I, _I, _P], _I),
    ),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    """Where the library for ``src``, the headers beside it and the current
    flags lives: every ``*.cuh`` of ``src``'s directory is hashed in, since
    any source may include any of them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def ptxas_report(lib: Path) -> str:
    """The ``-Xptxas -v`` report nvcc printed when it built ``lib``."""
    return lib.with_name(lib.name + ".ptxas.txt").read_text()


def missing() -> list[Path]:
    """The sources whose library is not built yet."""
    return [s for s in _sources() if not library_path(s).is_file()]


def build() -> list[Path]:
    """Compile every source whose library does not exist yet, one nvcc per
    source, all started together. Returns the libraries of all sources."""
    todo = missing()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in todo:
            out = library_path(src)
            # compile to a private name, then rename: a concurrent build
            # never loads a half-written library
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((cmd, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, tmp, out, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                              f"{stdout}\n{stderr}")
            else:
                out.with_name(out.name + ".ptxas.txt").write_text(stdout + stderr)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return [library_path(s) for s in _sources()]


_lib = None


def load() -> types.SimpleNamespace:
    """The kernels' C entry points, built on first call and bound once per
    process, as attributes named like the C functions."""
    global _lib
    if _lib is None:
        fns = {}
        for path, src in zip(build(), _sources()):
            lib = ctypes.CDLL(str(path))
            for name, argtypes, restype in ENTRY_POINTS[src.name]:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib
