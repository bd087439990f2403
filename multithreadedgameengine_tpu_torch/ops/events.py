"""The collision-event set difference, on the device.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/events.py``
(:35-80). The reference's logic workers diff the physics worker's pair list
against the previous frame's to fire onCollision{Enter,Stay,Exit}
(logic_worker.js:417-526). Here both frames' pair tables are concatenated,
sorted by (a, b, tag) with tag 0 for the current frame and 1 for the
previous one, and adjacency classifies every row:

    current row with its twin next  -> Stay
    current row without a twin      -> Enter
    previous row without a twin     -> Exit

Each class is compacted (``cumsum`` rank, scatter) into a ``[P, 2]`` table
padded with -1, rows ascending by (a, b): the reference's dispatch order.

Translation: the reference's three-key ``lax.sort`` is one sort of an int64
key ``(a << 32) | (b << 1) | tag``. Ids are below 2^31 and the pairs of one
table are unique, so the key orders the rows exactly as the three keys do;
rows past a table's count take the largest int64 and sort last.
"""

from __future__ import annotations

from typing import Tuple

import torch

_PAD = torch.iinfo(torch.int64).max


def compact_rows(mask: torch.Tensor, rows: torch.Tensor, cap: int, fill: int = -1) -> torch.Tensor:
    """The rows of ``rows`` (``[M, ...]``) where ``mask`` holds, in order,
    packed into a ``[cap, ...]`` table padded with ``fill``; rows past
    ``cap`` drop. The reference's ``cumsum`` rank and ``mode="drop"``
    scatter: every dropped row goes to a spare row past the end, which is
    cut off, so nothing is read back on the host."""
    rank = torch.cumsum(mask, dim=0, dtype=torch.int64) - 1
    dest = torch.where(mask & (rank < cap), rank, cap)
    out = torch.full((cap + 1, *rows.shape[1:]), fill, dtype=rows.dtype, device=rows.device)
    out.index_copy_(0, dest, rows)
    return out[:cap]


def diff_pairs(
    cur: torch.Tensor, n_cur: torch.Tensor, prev: torch.Tensor, n_prev: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Set-diff two pair tables (``[P, 2]`` int32, rows past the count
    ignored, pairs unique within a table). Returns (enter, n_enter, stay,
    n_stay, exit, n_exit): each table ``[P, 2]`` int32 padded with -1, rows
    ascending by (a, b); each count an int32 scalar tensor."""
    p = cur.shape[0]
    dev = cur.device
    ar = torch.arange(p, device=dev)
    valid = torch.cat([ar < n_cur, ar < n_prev])
    both = torch.cat([cur, prev]).to(torch.int64)
    tag = torch.cat([torch.zeros(p, dtype=torch.int64, device=dev),
                     torch.ones(p, dtype=torch.int64, device=dev)])
    key = torch.where(valid, (both[:, 0] << 32) | (both[:, 1] << 1) | tag, _PAD)
    skey = torch.sort(key).values
    sval = skey != _PAD
    pair = skey >> 1
    twin = pair[:-1] == pair[1:]
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    same_next = torch.cat([twin, false])
    same_prev = torch.cat([false, twin])
    is_cur = (skey & 1) == 0
    rows = torch.stack([skey >> 32, pair & 0x7FFFFFFF], dim=1).to(torch.int32)

    def compact(mask):
        return compact_rows(mask, rows, p), torch.sum(mask, dtype=torch.int32)

    enter, n_enter = compact(sval & is_cur & ~same_next)
    stay, n_stay = compact(sval & is_cur & same_next)  # its twin (prev) follows
    exit_, n_exit = compact(sval & ~is_cur & ~same_prev)
    return enter, n_enter, stay, n_stay, exit_, n_exit
