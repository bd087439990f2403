"""Plain PyTorch pieces of one engine frame, written from the physics the
benchmark's scenes state (the WeedJS physics worker's Verlet step,
boundary clamp and circle push; the spatial worker's clamped cell
binning and fixed-degree neighbour lists), for the benchmark's reference.

Nothing here imports the engine under test or its JAX original. State is a
dict of entity-order tensors; every float tensor is in one working dtype,
float32 for the reference and a lower precision for its control. Work over
``[rows, candidates]`` runs in blocks of rows so that a 1M-entity frame fits
beside the cloned states it is checked against.

Where a formula is taken over from the engine's own plain versions, the
comment names the file and line it was copied from; later changes to the
engine do not change it here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: rows of a ``[rows, candidates]`` block
BLOCK_ROWS = 1 << 16
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Grid:
    cell: float
    rows: int
    cols: int
    cap: int

    @property
    def cells(self) -> int:
        return self.rows * self.cols


def solver_grid(world_w: float, world_h: float, max_radius: float, mean_radius: float) -> Grid:
    """The collision grid: the smallest cell that keeps every contact within
    the 3 x 3 cells around an entity (2 r_max, widened by 1.25), and a
    capacity sized for dense packing of mean-radius circles plus half again
    (copied from ``multithreadedgameengine_tpu_torch/ops/physics_grid.py:52-77``)."""
    cell = max(2.0 * max_radius * 1.25, 1e-3)
    rows = max(1, math.ceil(world_h / cell))
    cols = max(1, math.ceil(world_w / cell))
    r_bar = mean_radius if mean_radius > 0 else max_radius
    r_bar = max(r_bar, max_radius / 3.0, 1e-3)
    cap = int((cell + 2 * r_bar) ** 2 / (math.pi * r_bar ** 2) * 0.9 * 1.5)
    return Grid(cell, rows, cols, max(8, min(64, ((cap + 3) // 4) * 4)))


def symmetric_pass(physics: dict, grid: Grid) -> bool:
    """Whether the solver pushes each pair by the Newton-symmetric pass's
    association rather than the two-sided pass's: the grid solver with
    ``solver_symmetric`` on and ``solver_predicated`` "on", or "auto" at a
    padded lane width ``ceil((cols + 2) / 128) * 128`` of 512 or more (copied
    from ``multithreadedgameengine_tpu_torch/ops/physics_grid.py:87-106``;
    solver "auto" is the grid solver)."""
    pred = physics.get("solver_predicated", "auto")
    return (physics.get("solver", "auto") in ("auto", "pallas")
            and bool(physics.get("solver_symmetric", True))
            and (pred == "on" or (pred == "auto" and -(-(grid.cols + 2) // 128) * 128 >= 512)))


def bin_cells(x, y, valid, grid: Grid):
    """Each entity's cell (clamped truncation of position / cell) and its
    rank among the cell's entities in ascending id; ``in_grid`` is valid and
    within the cell's capacity. Returns (cell id, rank, in_grid); invalid
    entities get cell id ``grid.cells``."""
    inv = 1.0 / grid.cell

    def coord(v, n):
        s = (v * inv).float()
        s = torch.where(torch.isnan(s), 0.0, s)
        return torch.clamp(s, 0.0, float(n - 1)).to(torch.int64)

    cid = torch.where(valid, coord(y, grid.rows) * grid.cols + coord(x, grid.cols), grid.cells)
    sorted_cid, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(sorted_cid, sorted_cid, right=False)
    rank = torch.empty_like(cid)
    rank[order] = torch.arange(cid.numel(), device=cid.device) - first
    return cid, rank, valid & (rank < grid.cap)


def cell_table(cid, rank, in_grid, grid: Grid):
    """``[cells + 1, cap]`` entity ids by (cell, rank), -1 where empty; the
    last row is all empty (the out-of-world neighbour)."""
    table = torch.full(((grid.cells + 1) * grid.cap,), -1, dtype=torch.int64, device=cid.device)
    ids = torch.nonzero(in_grid).flatten()
    table[cid[ids] * grid.cap + rank[ids]] = ids
    return table.view(grid.cells + 1, grid.cap)


def candidates(table, cid, rows, grid: Grid, reach: int):
    """The ids in the ``(2 reach + 1)^2`` cells around each of ``rows``'
    cells, row-major by cell offset, then by rank: ``[len(rows), M]``, -1
    where empty or outside the world."""
    c = cid[rows]
    r0, c0 = c // grid.cols, c % grid.cols
    offs = torch.arange(-reach, reach + 1, device=c.device)
    nr = r0[:, None, None] + offs[None, :, None]
    nc = c0[:, None, None] + offs[None, None, :]
    inside = (nr >= 0) & (nr < grid.rows) & (nc >= 0) & (nc < grid.cols) & (c < grid.cells)[:, None, None]
    ncell = torch.where(inside, nr * grid.cols + nc, grid.cells).flatten(1)
    return table[ncell].flatten(1)


def hash_dir(i, j, salt: int, dtype):
    """Pair-consistent unit direction for exactly coincident circles (copied
    from ``multithreadedgameengine_tpu_torch/ops/physics.py:73-82``)."""
    a = torch.minimum(i, j).to(torch.int64)
    b = torch.maximum(i, j).to(torch.int64)
    h = ((a * 0x9E3779B1) & _U32) ^ ((b * 0x85EBCA77) & _U32) ^ (int(salt) & _U32)
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _U32
    h = h ^ (h >> 12)
    hx = (h & 0xFFFF).to(dtype) - 32767.5
    hy = ((h >> 16) & 0xFFFF).to(dtype) - 32767.5
    inv = 1.0 / torch.sqrt(hx * hx + hy * hy)
    return hx * inv, hy * inv


def verlet(s: dict, gravity, damping: float, dt: float = 1.0) -> dict:
    """moveBallsVerlet (physics_worker.js:240-316): the damped displacement
    plus gravity and the frame's acceleration, clamped per axis to max_vel
    (100 where it is 0); px/py take the old position, vx/vy the
    displacement, ax/ay are spent."""
    f32 = torch.tensor(0.0).dtype  # float32 constants, as the worker computes them
    g_scale = torch.tensor(dt, dtype=f32) ** 2
    gx = float(g_scale * torch.tensor(gravity[0], dtype=f32))
    gy = float(g_scale * torch.tensor(gravity[1], dtype=f32))
    damping = float(torch.tensor(damping, dtype=f32))
    mv = s["active"] & s["rb_active"] & ~s["static"]
    lim = torch.where(s["max_vel"] > 0, s["max_vel"], 100.0)
    dx = torch.clamp((s["x"] - s["px"]) * damping + gx + s["ax"] * dt, -lim, lim)
    dy = torch.clamp((s["y"] - s["py"]) * damping + gy + s["ay"] * dt, -lim, lim)
    out = dict(s)
    out.update(
        x=torch.where(mv, s["x"] + dx, s["x"]), y=torch.where(mv, s["y"] + dy, s["y"]),
        px=torch.where(mv, s["x"], s["px"]), py=torch.where(mv, s["y"], s["py"]),
        vx=torch.where(mv, dx / dt, s["vx"]), vy=torch.where(mv, dy / dt, s["vy"]),
        ax=torch.where(mv, 0.0, s["ax"]).to(s["ax"].dtype),
        ay=torch.where(mv, 0.0, s["ay"]).to(s["ay"].dtype),
    )
    return out


def boundary(x, px, r, extent: float, moving, elasticity: float):
    """One axis of the boundary clamp and bounce (physics_worker.js:344-376):
    a moving circle is clamped into ``[r, extent - r]`` and, where that
    moved it, its previous position reflected about the clamped one."""
    cx = torch.clamp(x, r, extent - r)
    hit = moving & (cx != x)
    return torch.where(moving, cx, x), torch.where(hit, cx + (cx - px) * elasticity, px)


def pair_push(x, y, s: dict, cand, ok, strength: float, salt: int, symmetric: bool):
    """One Jacobi pass of the circle push (applyConstraintsVerlet's pair
    response, physics_worker.js:399-560) over every candidate pair of
    ``cand`` (``[N, M]`` ids, -1 empty), all from the positions at the start
    of the pass. A moving circle takes half the overlap against a moving
    one, all of it against a static one, none against a trigger. Returns
    (x, y) with each ``ok`` row's pushes summed."""
    n = x.shape[0]
    dtype = x.dtype
    trig, stat = s["trigger"], s["static"]
    acc_x = torch.zeros_like(x)
    acc_y = torch.zeros_like(y)
    for lo in range(0, n, BLOCK_ROWS):
        i = torch.arange(lo, min(n, lo + BLOCK_ROWS), device=x.device)
        j = cand[i]
        js = j.clamp(min=0)
        live = (j >= 0) & (j != i[:, None]) & ok[i][:, None] & ok[js]
        dx = x[i][:, None] - x[js]
        dy = y[i][:, None] - y[js]
        d2 = dx * dx + dy * dy
        min_d = s["radius"][i][:, None] + s["radius"][js]
        overlap = live & (d2 < min_d * min_d)
        blocked = trig[i][:, None] | trig[js] | stat[i][:, None]
        share = torch.where(blocked, 0.0, torch.where(stat[js], 1.0, 0.5)).to(dtype)
        inv = torch.where(d2 > 0, 1.0 / torch.sqrt(d2), 0.0).to(dtype)
        dist = d2 * inv
        if symmetric:  # the Newton-symmetric pass's association
            base = (min_d - dist) * strength * inv
            push_x, push_y = (dx * base) * share, (dy * base) * share
        else:  # the two-sided pass's
            corr = (min_d - dist) * strength * share
            push_x, push_y = dx * inv * corr, dy * inv * corr
        zero = d2 == 0
        if bool(zero.any()):
            ii = i[:, None].expand_as(j)
            ux, uy = hash_dir(ii, js, salt, dtype)
            sign = torch.where(ii < js, 1.0, -1.0).to(dtype)
            zs = (2.0 * share) * sign * 0.001
            push_x = torch.where(zero, ux * zs, push_x)
            push_y = torch.where(zero, uy * zs, push_y)
        acc_x[i] = torch.sum(torch.where(overlap, push_x, 0.0), dim=1, dtype=dtype)
        acc_y[i] = torch.sum(torch.where(overlap, push_y, 0.0), dim=1, dtype=dtype)
    return torch.where(ok, x + acc_x, x), torch.where(ok, y + acc_y, y)


@dataclass
class Bins:
    """One binning of the collision grid and the candidate pairs it gives."""

    in_grid: torch.Tensor
    cand: torch.Tensor


def solver_bins(s: dict, grid: Grid) -> Bins:
    valid = s["active"] & torch.isfinite(s["x"]) & torch.isfinite(s["y"])
    cid, rank, in_grid = bin_cells(s["x"], s["y"], valid, grid)
    table = cell_table(cid, rank, in_grid, grid)
    n = s["x"].shape[0]
    cand = torch.full((n, 9 * grid.cap), -1, dtype=torch.int64, device=s["x"].device)
    rows = torch.nonzero(in_grid).flatten()
    for lo in range(0, rows.numel(), BLOCK_ROWS):
        blk = rows[lo:lo + BLOCK_ROWS]
        cand[blk] = candidates(table, cid, blk, grid, 1)
    return Bins(in_grid=in_grid, cand=cand)


def constraints(s: dict, bins: Bins, world_w: float, world_h: float, substeps: int,
                strength: float, elasticity: float, salt: int, symmetric: bool) -> dict:
    """applyConstraintsVerlet (physics_worker.js:203-217): per substep, the
    boundary then one pair pass over the binned circles; a circle past its
    cell's capacity gets the boundary alone, once."""
    mv = s["active"] & s["rb_active"] & ~s["static"]
    ok = bins.in_grid & s["col_active"]
    x, y, px, py = s["x"], s["y"], s["px"], s["py"]
    r = s["radius"]
    g_mv = mv & bins.in_grid
    for _ in range(substeps):
        x, px = boundary(x, px, r, world_w, g_mv, elasticity)
        y, py = boundary(y, py, r, world_h, g_mv, elasticity)
        x, y = pair_push(x, y, s, bins.cand, ok, strength, salt, symmetric)
    over = mv & ~bins.in_grid & s["active"] & torch.isfinite(s["x"]) & torch.isfinite(s["y"])
    fx, fpx = boundary(s["x"], s["px"], r, world_w, over, elasticity)
    fy, fpy = boundary(s["y"], s["py"], r, world_h, over, elasticity)
    out = dict(s)
    out.update(x=torch.where(over, fx, x), y=torch.where(over, fy, y),
               px=torch.where(over, fpx, px), py=torch.where(over, fpy, py))
    return out


def cast_state(s: dict, dtype) -> dict:
    """The state with every float tensor in ``dtype``."""
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in s.items()}
