"""World state: one dataclass of tensors on an explicit device.

PyTorch counterpart of ``multithreadedgameengine_tpu/state.py`` (World,
make_world, EntityPool, scatter_fields; state.py:42-328). The world holds the
five built-in components of the ported slice as dense ``[N]`` tensors, plus
the frame counter.

``step_count`` is a host int: the host drives every frame of an eager
PyTorch step, so it always knows the count, and the pair kernel takes it as
a launch argument (its hash salt) without a device read. The solver-cache
stamps ``solver_bin_step`` and ``solver_pos_step`` are host ints for the
same reason: where the reference picks a branch inside its program with
``jax.lax.cond`` on them, the port picks it with a host ``if``, so no frame
reads the device to choose. The reference's collision-pair and event
tables, decal canvas, shadow sprites, particle pool and device PRNG key
belong to features this port refuses so far and are not allocated.

``EntityPool`` is the reference's host-side numpy free list, copied as is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .components import (
    Collider,
    MouseComponent,
    RigidBody,
    SpriteRenderer,
    Struct,
    Transform,
)


@dataclasses.dataclass
class World(Struct):
    """All mutable simulation state of the ported slice."""

    transform: Transform
    rigid_body: RigidBody
    collider: Collider
    sprite: SpriteRenderer
    mouse: MouseComponent
    # frame counter (syncData[0] analog, gameEngine.js:718-738)
    step_count: int = 0
    # grid-solver bin cache (physics.rebin_interval > 1; None otherwise):
    # each entity's flat slot in the solver layout [cap, R+2, C+2] as of the
    # last rebin (``cap*(R+2)*(C+2)`` when not in the grid), the in-capacity
    # mask, and the step_count of that rebin (-1: never, so the next frame
    # rebins). The reference's state.py:84-91; see ops/physics_grid.py.
    solver_flat: Optional[torch.Tensor] = None  # int64[N]
    solver_in_grid: Optional[torch.Tensor] = None  # bool[N]
    solver_bin_step: Optional[int] = None
    # the radius and meta layouts of the last rebin (solver "pallas" with the
    # bin cache on): between rebins only positions change
    solver_grad: Optional[torch.Tensor] = None  # f32[cap, R+2, C+2]
    solver_meta: Optional[torch.Tensor] = None  # int32[cap, R+2, C+2]
    # layout-resident positions (physics.position_residency): x/y/px/py
    # live in the solver layout across frames, with the per-slot max_vel;
    # ``solver_pos_step`` is the step_count at which the layout is current
    # (-1: invalid, the next resident frame rebuilds it from entity order)
    solver_maxv: Optional[torch.Tensor] = None  # f32[cap, R+2, C+2]
    solver_x: Optional[torch.Tensor] = None
    solver_y: Optional[torch.Tensor] = None
    solver_px: Optional[torch.Tensor] = None
    solver_py: Optional[torch.Tensor] = None
    solver_pos_step: Optional[int] = None

    @property
    def n_entities(self) -> int:
        return self.transform.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.transform.x.device


def make_world(n_entities: int, device) -> World:
    return World(
        transform=Transform.zeros(n_entities, device),
        rigid_body=RigidBody.zeros(n_entities, device),
        collider=Collider.zeros(n_entities, device),
        sprite=SpriteRenderer.zeros(n_entities, device),
        mouse=MouseComponent.zeros(n_entities, device),
    )


class EntityPool:
    """Host-side free-list pool for one entity class's index range.

    Replicates the reference's LIFO free list with interleaveFactor=8 scatter
    (gameObject.js:794-831): indices are pushed in an interleaved order so that
    consecutive spawns land ~8 slots apart. On TPU the cache-contention motive
    is gone, but spawn-*index* parity with the reference matters for
    trajectory-matched tests, so the ordering is reproduced exactly.
    """

    INTERLEAVE = 8  # gameObject.js:806

    def __init__(self, start: int, count: int):
        self.start = start
        self.count = count
        # Build interleaved order, then push onto LIFO stack in that order.
        # Reference (gameObject.js:818-831): for offset in 0..interleave-1:
        #   for base in 0..count step interleave: push(start + base + offset)
        # then spawn pops from the END of the list (freeList[freeListTop--]).
        order = []
        for offset in range(self.INTERLEAVE):
            base = 0
            while base + offset < count:
                order.append(start + base + offset)
                base += self.INTERLEAVE
        # LIFO as a numpy stack (top = end) + dense membership mask indexed
        # by (idx - start): O(1) single ops, and bulk release/query are pure
        # vector passes — the python list+set form made despawn_all at 1M a
        # multi-hundred-ms per-element affair (VERDICT r1 next #5)
        self._free_arr = np.asarray(order, np.int64)
        self._free_top = count
        self._free_mask = np.ones(count, bool)
        self.active_count = 0

    @property
    def free(self) -> np.ndarray:
        """Current free stack, bottom-to-top (top of stack = last element)."""
        return self._free_arr[: self._free_top]

    def claim(self) -> Optional[int]:
        """Pop one index (gameObject.js:868). Returns None on exhaustion
        (pool-exhaustion warns + returns null in the reference,
        gameObject.js:860-865)."""
        if self._free_top == 0:
            return None
        self._free_top -= 1
        idx = int(self._free_arr[self._free_top])
        self._free_mask[idx - self.start] = False
        self.active_count += 1
        return idx

    def claim_many(self, count: int) -> np.ndarray:
        """Pop up to ``count`` indices in ONE vector op, in exactly the order
        ``count`` sequential :meth:`claim` calls would return them (LIFO top
        first) — the spawn_batch fast path: the per-entity Python claim loop
        cost ~1M iterations of host time at 1M-entity scene builds (VERDICT
        r3 weak #5). Returns an int64 array of claimed indices (shorter than
        ``count`` on exhaustion; empty when the pool is dry)."""
        m = min(int(count), self._free_top)
        if m <= 0:
            return np.empty((0,), np.int64)
        out = self._free_arr[self._free_top - m : self._free_top][::-1].copy()
        self._free_top -= m
        self._free_mask[out - self.start] = False
        self.active_count += m
        return out

    def release(self, idx: int) -> bool:
        """Push an index back (despawn, gameObject.js:668-691). Returns False
        without touching the list when the index is already free — the
        reference's double-despawn guard ('Prevent double-despawn which
        corrupts the free list', gameObject.js:668-670): releasing twice would
        duplicate the entry and alias two later spawns onto one slot."""
        if not (self.start <= idx < self.start + self.count):
            raise ValueError(f"index {idx} outside pool [{self.start}, {self.start + self.count})")
        if self._free_mask[idx - self.start]:
            return False
        self._free_arr[self._free_top] = idx
        self._free_top += 1
        self._free_mask[idx - self.start] = True
        self.active_count -= 1
        return True

    def release_many(self, indices) -> None:
        """Bulk release preserving CALLER order (despawnAll's per-index loop,
        gameObject.js:1001-1034, vectorized): pushing [a, b] here leaves the
        LIFO stack identical to release(a); release(b), so batch despawns and
        singles produce the same later spawn order. Skips already-free,
        duplicate (first occurrence wins) and out-of-range indices — the
        range check mirrors release()'s, since a below-start index would
        otherwise wrap via fancy indexing and corrupt an unrelated slot."""
        rel = np.asarray(indices, np.int64).reshape(-1) - self.start
        rel = rel[(rel >= 0) & (rel < self.count)]
        if rel.size > 1:
            _, first = np.unique(rel, return_index=True)
            rel = rel[np.sort(first)]
        fresh = rel[~self._free_mask[rel]]
        m = int(fresh.size)
        self._free_arr[self._free_top : self._free_top + m] = fresh + self.start
        self._free_top += m
        self._free_mask[fresh] = True
        self.active_count -= m

    def restore_free(self, free) -> None:
        """Replace the free list wholesale (checkpoint restore)."""
        arr = np.asarray(free, np.int64)
        self._free_arr = np.empty(self.count, np.int64)
        self._free_arr[: arr.size] = arr
        self._free_top = int(arr.size)
        self._free_mask = np.zeros(self.count, bool)
        if arr.size:
            self._free_mask[arr - self.start] = True

    def is_free(self, idx: int) -> bool:
        return bool(self._free_mask[idx - self.start])

    def active_indices(self) -> np.ndarray:
        """All currently-claimed indices, ascending, as one vectorized mask
        pass — the churn-rate analog of scanning ``is_free`` per slot."""
        return (np.nonzero(~self._free_mask)[0] + self.start).astype(np.int32)

    @property
    def free_count(self) -> int:
        return self._free_top



def scatter_fields(component, idx: torch.Tensor, updates: Dict[str, torch.Tensor]):
    """Scatter per-field ``updates`` at entity indices ``idx`` into a
    component and return the new component. Entries with ``idx < 0`` are
    dropped: they are sent to one spare slot past the end, which is cut off
    again, so no index mask (and no device sync) is needed. ``idx`` must not
    repeat a valid index."""
    changed = {}
    for name, value in updates.items():
        arr = getattr(component, name)
        n = arr.shape[0]
        safe = torch.where(idx < 0, n, idx).to(torch.int64)
        out = torch.cat([arr, arr[:1]])
        out.index_copy_(0, safe, value.to(arr.dtype))
        changed[name] = out[:n]
    return component.replace(**changed)
