"""Run one function on every rank of a process mesh.

:func:`run_ranks` starts ``n_ranks`` processes from the ``"spawn"`` context
(never ``fork``: the caller may hold a CUDA context, or JAX with its
threads), joins them into one process group through a ``FileStore`` in a
fresh temporary directory (no fixed port, so runs in parallel never meet),
builds each rank's :class:`~.dist.ProcessMesh` and calls ``fn(mesh,
*args)`` there. Each rank's return value comes back pickled through a
queue, by value, so a rank returns host data (CPU tensors, numpy arrays,
numbers).

A rank that raises, a rank that dies, or a deadline that passes ends the
run: every rank is killed and :class:`RankError` is raised with the
failing rank's traceback. A collective that a peer never joins therefore
fails within ``deadline_s``, whatever the backend's own timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

#: seconds a rank gets to exit after it reported, before it is killed
_EXIT_GRACE_S = 10.0


class RankError(RuntimeError):
    """A rank of :func:`run_ranks` raised, died or outlived the deadline."""


def _rank_main(fn, rank: int, n_ranks: int, backend: str, device: str, store_path: str,
               args: Sequence[Any], threads: int, timeout_s: float, results) -> None:
    """One rank: join the group, run ``fn(mesh, *args)``, report. A failure
    is reported before the group is torn down, so it reaches the parent
    before the errors its peers then see."""
    try:
        import torch
        import torch.distributed as dist

        from .dist import make_process_mesh

        torch.set_num_threads(threads)
        store = dist.FileStore(store_path, n_ranks)
        mesh = make_process_mesh(rank, n_ranks, backend, device, store, timeout_s)
    except BaseException:  # reported to the parent, which kills every rank
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        out = fn(mesh, *args)
        report = (rank, True, pickle.dumps(out))
    except BaseException:
        report = (rank, False, traceback.format_exc())
        results.put(report)
    finally:
        dist.destroy_process_group()
    if report[1]:
        results.put(report)


def _failures(results, rank: int, n_ranks: int, payload: str) -> str:
    """The first failure's report, then any other rank's that arrives within
    a second (a peer's collective fails once the failing rank is gone)."""
    lines = [f"rank {rank} of {n_ranks} raised:\n{payload}"]
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end:
        try:
            other, ok, more = results.get(timeout=max(t_end - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            lines.append(f"then rank {other} raised:\n{more}")
    return "\n".join(lines)


def _kill(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(timeout=_EXIT_GRACE_S)


def run_ranks(fn: Callable, n_ranks: int, backend: str = "gloo", device: str = "cuda",
              args: Sequence[Any] = (), deadline_s: float = 600.0, threads: int = 1) -> List[Any]:
    """``fn(mesh, *args)`` on ``n_ranks`` spawned processes of one process
    mesh; returns their results in rank order.

    ``fn`` must be importable by name (a module-level function of a module
    that a fresh interpreter can import), and so must ``args``. ``backend``
    and ``device``: as :func:`~.dist.make_process_mesh` takes them (the card
    unless the caller asks for ``"cpu"``). ``threads``: each rank's
    ``torch.set_num_threads``. ``deadline_s`` bounds the whole run, start-up
    included, and every collective of it. Raises :class:`RankError` with
    the traceback of the first rank that raised, or naming the ranks that
    died or had not finished by the deadline; every rank is killed first."""
    if n_ranks < 1:
        raise ValueError(f"run_ranks needs at least one rank, got {n_ranks}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="process_mesh_")
    results = ctx.Queue()
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, n_ranks, backend, device, store_path, tuple(args), threads, deadline_s,
        results)) for rank in range(n_ranks)]
    t_end = time.monotonic() + deadline_s
    done = {}
    try:
        for p in procs:
            p.start()
        while len(done) < n_ranks:
            left = t_end - time.monotonic()
            if left <= 0:
                late = [r for r in range(n_ranks) if r not in done]
                raise RankError(f"ranks {late} of {n_ranks} did not finish within "
                                f"{deadline_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    # a rank that exits reports first: give its report a moment
                    try:
                        rank, ok, payload = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RankError(f"ranks died without a report (rank, exit code): "
                                        f"{dead}") from None
                else:
                    continue
            if not ok:
                raise RankError(_failures(results, rank, n_ranks, payload))
            done[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(t_end - time.monotonic(), _EXIT_GRACE_S))
    finally:
        _kill(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(n_ranks)]
