"""The process mesh: one world slab per process of a ``torch.distributed``
group.

The reference runs its slab steps under ``shard_map``, one slab per device,
and its collectives are ``jax.lax.all_to_all``, ``ppermute`` (through
``_edge_perms``), ``psum`` and ``all_gather`` (parallel/halo.py:202-233,
:789-799). :class:`ProcessMesh` is their ``torch.distributed`` form. It
keeps the contract of ``parallel.mesh`` (its module docstring) with
``slabs == (rank,)``, so ``parallel.halo`` and ``parallel.homed`` run on it
unchanged in what they compute:

- ``all_to_all``: ``dist.all_to_all_single`` on the ``[D, cap, L]`` send
  block; the received block is source-major, as ``SlabMesh.all_to_all``'s;
- ``shift_down``/``shift_up`` (any ``ppermute``): one
  ``dist.batch_isend_irecv`` of the pairs that name this rank, every
  request waited on; a rank that no pair sends to receives zeros. No
  blocking send or receive in a fixed order, which can deadlock;
- ``all_gather``: the ranks' parts stacked in rank order;
- ``psum``: an ``all_gather`` and the left-to-right sum of
  ``SlabMesh.psum`` (``mesh.sum_in_order``), not ``all_reduce``, whose
  order is the backend's: float sums stay bit-equal with the in-process
  mesh by construction;
- ``gather``: the parts stacked in rank order on rank 0, for ``unplace``.

Backends. ``"gloo"`` on CPU tensors hands them to gloo as they are.
``"gloo"`` on a CUDA device copies every outgoing tensor to pinned host
memory and every received one back to the card (:meth:`ProcessMesh._to_host`
and :meth:`ProcessMesh._to_card`, the mesh's only host reads); it relies on
no CUDA support in gloo, and lets several ranks share one card. ``"nccl"``
needs one card per rank (``torch.cuda.set_device(rank)``); two ranks on one
card raise ``ValueError`` before the group forms. Nothing switches backend
or device on its own.

The mesh counts what crosses it: ``bytes_sent`` and ``bytes_received`` (a
collective's payload to and from the other ranks, as the algorithm needs
it, whatever the backend's own traffic), ``bytes_staged`` (the host copies
of gloo on a card) and ``calls``. With ``timings`` set to a list, each call
is bracketed by ``torch.cuda.synchronize()`` on a card and appends
``(method, seconds)``: the mesh's share of an instrumented frame.
"""

from __future__ import annotations

import contextlib
import datetime
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import _edge_perms, sum_in_order

BACKENDS = ("gloo", "nccl")


@contextlib.contextmanager
def _staging_allowed():
    """The staging copies of gloo on a card synchronise by design: they are
    exempt from ``torch.cuda.set_sync_debug_mode`` for their own duration."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _collective(fn):
    """Count a mesh method's calls and time it when ``timings`` is set."""

    def call(self, *args, **kwargs):
        self.calls += 1
        if self.timings is None:
            return fn(self, *args, **kwargs)
        self._sync()
        t0 = time.perf_counter()
        out = fn(self, *args, **kwargs)
        self._sync()
        self.timings.append((fn.__name__, time.perf_counter() - t0))
        return out

    call.__name__ = fn.__name__
    call.__doc__ = fn.__doc__
    return call


class ProcessMesh:
    """Slab ``rank`` of an ``n_slabs``-slab world on ``device``; every rank
    of the default process group holds one. Every method takes and returns
    one entry (the list ``[x]``) for this process's slab, except
    ``all_gather``, ``psum`` and ``gather``, as ``parallel.mesh`` sets out."""

    def __init__(self, rank: int, n_slabs: int, device, backend: str):
        self.rank = int(rank)
        self.n_slabs = int(n_slabs)
        self.device = torch.device(device)
        self.backend = backend
        self.slabs: Tuple[int, ...] = (self.rank,)
        self._staged = backend == "gloo" and self.device.type == "cuda"
        self.calls = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.bytes_staged = 0
        self.timings: Optional[List[Tuple[str, float]]] = None

    # -- the wire: the tensors gloo or NCCL reads and writes ---------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """An outgoing tensor as the backend takes it: contiguous, and under
        gloo on a card a copy in pinned host memory (a synchronising copy,
        exempt from the sync check)."""
        t = t.contiguous()
        if not self._staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with _staging_allowed():
            host.copy_(t)
        self.bytes_staged += host.nbytes
        return host

    def _wire_empty(self, shape, dtype) -> torch.Tensor:
        """A receive buffer: pinned host memory under gloo on a card, else
        on the mesh's device."""
        if self._staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _to_card(self, t: torch.Tensor) -> torch.Tensor:
        """A received tensor on the mesh's device (under gloo on a card, an
        asynchronous copy from pinned memory)."""
        if not self._staged:
            return t
        self.bytes_staged += t.nbytes
        with _staging_allowed():
            return t.to(self.device, non_blocking=True)

    def _check(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"a process mesh holds one slab a process, got {len(parts)} entries")
        return parts[0]

    # -- the collectives ----------------------------------------------------

    @_collective
    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks``: ``[send]``, ``send[d]`` bound for slab d. Returns
        ``[recv]`` with ``recv[s]`` = slab s's block for this slab."""
        send = self._check(blocks)
        if send.shape[0] != self.n_slabs:
            raise ValueError(f"all_to_all needs a leading axis of {self.n_slabs}, "
                             f"got {tuple(send.shape)}")
        wire = self._to_host(send)
        recv = self._wire_empty(wire.shape, wire.dtype)
        dist.all_to_all_single(recv, wire)
        moved = wire.nbytes * (self.n_slabs - 1) // self.n_slabs
        self.bytes_sent += moved
        self.bytes_received += moved
        return [self._to_card(recv)]

    @_collective
    def ppermute(self, parts: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``out[dst] = parts[src]`` for each ``(src, dst)`` of ``perm``;
        zeros on a slab that is no pair's destination. Every send and receive
        of this rank goes into one ``batch_isend_irecv``."""
        part = self._check(parts)
        ops, recv = [], None
        wire = None
        for src, dst in perm:
            if src == dst:
                raise ValueError(f"ppermute pair ({src}, {dst}) sends a slab to itself")
            if src == self.rank:
                wire = self._to_host(part) if wire is None else wire
                ops.append(dist.P2POp(dist.isend, wire, dst))
                self.bytes_sent += wire.nbytes
            if dst == self.rank:
                if recv is not None:
                    raise ValueError(f"ppermute sends slab {dst} two parts")
                recv = self._wire_empty(part.shape, part.dtype)
                ops.append(dist.P2POp(dist.irecv, recv, src))
                self.bytes_received += recv.nbytes
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is None:
            return [torch.zeros_like(part)]
        return [self._to_card(recv)]

    def shift_down(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This slab's part to the next higher slab; slab 0 receives zeros."""
        return self.ppermute(parts, _edge_perms(self.n_slabs)[0])

    def shift_up(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This slab's part to the next lower slab; the last slab receives
        zeros."""
        return self.ppermute(parts, _edge_perms(self.n_slabs)[1])

    @_collective
    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every slab's part stacked in rank order, ``[D, ...]``, on every
        rank."""
        part = self._check(parts)
        wire = self._to_host(part.reshape(-1))
        stack = self._wire_empty((self.n_slabs, wire.numel()), wire.dtype)
        dist.all_gather(list(stack.unbind(0)), wire)
        self.bytes_sent += wire.nbytes * (self.n_slabs - 1)
        self.bytes_received += wire.nbytes * (self.n_slabs - 1)
        return self._to_card(stack).view(self.n_slabs, *part.shape)

    def psum(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over slabs, left to right in slab order, in the values'
        own dtype: the gathered parts summed as ``SlabMesh.psum`` sums
        them."""
        return sum_in_order(list(self.all_gather(values).unbind(0)))

    @_collective
    def gather(self, parts: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
        """Every slab's part stacked in rank order on rank 0; None on the
        other ranks."""
        part = self._check(parts)
        wire = self._to_host(part.reshape(-1))
        if self.rank != 0:
            self.bytes_sent += wire.nbytes
            dist.gather(wire, None, dst=0)
            return None
        stack = self._wire_empty((self.n_slabs, wire.numel()), wire.dtype)
        dist.gather(wire, list(stack.unbind(0)), dst=0)
        self.bytes_received += wire.nbytes * (self.n_slabs - 1)
        return self._to_card(stack).view(self.n_slabs, *part.shape)

    def reset_counts(self) -> None:
        """Zero the call and byte counts."""
        self.calls = self.bytes_sent = self.bytes_received = self.bytes_staged = 0


def make_process_mesh(rank: int, n_ranks: int, backend: str, device, store,
                      timeout_s: float) -> ProcessMesh:
    """Join the default process group as ``rank`` of ``n_ranks`` through
    ``store`` (a ``torch.distributed.Store``) and return this rank's
    :class:`ProcessMesh`. ``timeout_s`` bounds every collective.

    ``backend`` is ``"gloo"`` (CPU tensors, or a card's tensors staged
    through pinned host memory) or ``"nccl"`` (one card per rank: rank r
    runs on card r). Raises ``ValueError`` for an unknown backend, for NCCL
    off a card, and for NCCL with more ranks than cards, naming the card two
    ranks would share."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on cards; device {dev} is not one")
        count = torch.cuda.device_count()
        if n_ranks > count:
            card = rank % max(count, 1)
            name = torch.cuda.get_device_name(card) if count else "none"
            raise ValueError(
                f"NCCL needs one card per rank: {n_ranks} ranks on {count} card(s) would put "
                f"two ranks on card {card} ({name}); use gloo to share a card")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    # a first collective of every rank: NCCL sets up its communicator there,
    # before any point-to-point batch (which it requires)
    dist.barrier()
    return ProcessMesh(rank, n_ranks, dev, backend)
