"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

The sources are the ``.cu`` files under ``multithreadedgameengine_tpu_torch/
csrc``. They are compiled at first use, never at import, into
``build/kernels/`` at the checkout's root (listed in ``.gitignore``): one
library per source, named by a hash of that source and the flags, so an
edited source rebuilds and an unchanged one loads the cached library. The
nvcc runs for all sources start together and run in parallel. Each library
exposes plain C functions that ``ops/cuda_kernels.py`` binds with
``ctypes``; nothing here includes PyTorch's headers, which keeps a build to
seconds.

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
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
#: the C entry point of each source and its argument types
ENTRY_POINTS = {
    "pair_pass_resident.cu": ("pair_pass_resident_launch", [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _P,
    ]),
    "pair_pass_symmetric.cu": ("pair_pass_symmetric_launch", [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _I, _F, _F, _P,
    ]),
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
    """Where the library for ``src`` and the current flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


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
            name, argtypes = ENTRY_POINTS[src.name]
            fn = getattr(ctypes.CDLL(str(path)), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib
