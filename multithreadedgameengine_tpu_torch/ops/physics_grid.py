"""The grid constraint solver, resident in the pair kernel's layout.

PyTorch counterpart of ``solver_geometry`` (physics_grid.py:43-80) and
``grid_constraints_resident`` (physics_grid.py:485-694) of the reference
package. One frame: bin the entities, scatter them into the slot-major
layout ``[cap, R+2, C+2]`` (slot plane, cell row, cell col, with a one-cell
empty border), run ``sub_step_count`` x (boundary clamp + K1 pair pass) in
that layout, and read the results back to entity order. Entities past a
cell's capacity fall back to the boundary clamp alone for the frame and are
counted as overflow.

Only ``rebin_interval=1`` is ported: the rebin cache, position residency and
the banded boundary are slice B of the port, and the engine refuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..config import EngineConfig
from ..state import World
from .cuda_kernels import pair_pass_resident
from .physics import _boundary
from .spatial import GridGeom, bin_entities


def solver_geometry(
    cfg: EngineConfig,
    max_radius: float,
    mean_radius: float = 0.0,
    reach_factor: float = 1.25,
    target_occupancy: float = 0.9,
) -> GridGeom:
    """The solver grid: the smallest cell that keeps the pair search a 3x3
    neighbourhood (cell >= 2 r_max, widened by ``reach_factor``), with a
    capacity sized for dense packing of mean-radius entities plus 50%
    headroom, or the user's ``physics.solver_capacity``. The reference's
    function, unchanged."""
    cell = max(2.0 * max_radius * reach_factor, 1e-3)
    rows = max(1, math.ceil(cfg.world_height / cell))
    cols = max(1, math.ceil(cfg.world_width / cell))
    if cfg.physics.solver_capacity > 0:
        return GridGeom(
            cell_size=cell, rows=rows, cols=cols,
            capacity=cfg.physics.solver_capacity,
        )
    r_bar = mean_radius if mean_radius > 0 else max_radius
    r_bar = max(r_bar, max_radius / 3.0, 1e-3)
    cap = int(
        (cell + 2 * r_bar) ** 2 / (math.pi * r_bar**2) * target_occupancy * 1.5
    )
    cap = max(8, min(64, ((cap + 3) // 4) * 4))
    return GridGeom(cell_size=cell, rows=rows, cols=cols, capacity=cap)


def layout_shape(geom: GridGeom) -> Tuple[int, int, int]:
    """The solver layout's shape, ``[cap, R+2, C+2]``."""
    return geom.capacity, geom.rows + 2, geom.cols + 2


def _scatter(flat: torch.Tensor, shape, values: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Per-entity values into a layout of ``shape``; entities not in the grid
    carry the spare slot index ``total`` and land past the end, which is cut
    off (the reference's ``mode="drop"``, with no index mask or device
    sync)."""
    total = shape[0] * shape[1] * shape[2]
    out = torch.full((total + 1,), fill, dtype=values.dtype, device=values.device)
    out.index_copy_(0, flat, values)
    return out[:total].view(shape)


@dataclasses.dataclass
class SolverLayout:
    """One frame's binning and the static layouts built from it."""

    flat: torch.Tensor  # int64[N] slot of each entity (spare slot if not in_grid)
    in_grid: torch.Tensor  # bool[N] binned within capacity
    valid: torch.Tensor  # bool[N] active with finite position
    radius: torch.Tensor  # f32[cap, R+2, C+2]
    meta: torch.Tensor  # int32[cap, R+2, C+2]: gid | flags << 24, 0 = empty

    def scatter(self, values: torch.Tensor, fill=0.0) -> torch.Tensor:
        return _scatter(self.flat, self.meta.shape, values, fill)

    def gather(self, layout: torch.Tensor) -> torch.Tensor:
        """Layout values back to entity order (entities not in the grid read
        slot 0; callers mask them)."""
        idx = torch.where(self.in_grid, self.flat, 0)
        return layout.reshape(-1)[idx]


def build_layout(world: World, geom: GridGeom) -> SolverLayout:
    """Bin the world and scatter the radius and meta layouts."""
    t, rb, c = world.transform, world.rigid_body, world.collider
    n = t.x.shape[0]
    if n >= (1 << 24):
        raise ValueError("the solver packs entity ids into 24 bits: N < 2^24")
    shape = layout_shape(geom)
    cap, rows, cols = shape

    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)
    bins = bin_entities(t.x, t.y, valid, geom, build_table=False)
    in_grid = valid & (bins.rank < cap)
    # rank is clamped before the product: an overflow rank can reach N
    rank = torch.where(in_grid, bins.rank, 0).to(torch.int64)
    flat = (rank * rows + (1 + bins.row.to(torch.int64))) * cols + (
        1 + bins.col.to(torch.int64)
    )
    flat = torch.where(in_grid, flat, cap * rows * cols)

    flags = (
        c.active.to(torch.int32)
        | (c.is_trigger.to(torch.int32) << 1)
        | (rb.static.to(torch.int32) << 2)
        | ((t.active & rb.active & ~rb.static).to(torch.int32) << 3)
    )
    gid = torch.arange(n, dtype=torch.int32, device=t.x.device)
    return SolverLayout(
        flat=flat, in_grid=in_grid, valid=valid,
        radius=_scatter(flat, shape, c.radius),
        meta=_scatter(flat, shape, gid | (flags << 24), fill=0),
    )


def grid_constraints_resident(
    world: World, cfg: EngineConfig, geom: GridGeom
) -> Tuple[World, torch.Tensor, torch.Tensor]:
    """Substepped boundary and pair constraints (applyConstraintsVerlet,
    physics_worker.js:203-217, :323-395) in the solver layout. Returns
    (world, n_binned, overflow) with the two counts as 0-dim int32 tensors
    (no device sync)."""
    ph = cfg.physics
    t, rb, c = world.transform, world.rigid_body, world.collider
    lay = build_layout(world, geom)
    grad, meta = lay.radius, lay.meta
    g_moving = ((meta >> 24) & 8) != 0
    gx = lay.scatter(t.x)
    gy = lay.scatter(t.y)

    strength = float(ph.collision_response_strength)
    elasticity = ph.boundary_elasticity
    salt = world.step_count & 0xFFFFFFFF
    w, h = cfg.world_width, cfg.world_height

    # px/py: the pair pass never reads them, only the boundary bounce does.
    # At elasticity 0 the bounce collapses to px' = the last clamped value,
    # so px/py start as NaN ("never hit") and the entity's own px/py are
    # kept where they stay NaN (physics_grid.py:642-677).
    carry_px = elasticity != 0.0
    if carry_px:
        gpx = lay.scatter(rb.px)
        gpy = lay.scatter(rb.py)
    else:
        gpx = torch.full_like(gx, float("nan"))
        gpy = torch.full_like(gy, float("nan"))

    g_count = torch.zeros(meta.shape, dtype=torch.int32, device=meta.device)
    for _ in range(ph.sub_step_count):
        if carry_px:
            gx, gpx = _boundary(gx, gpx, grad, w, g_moving, elasticity)
            gy, gpy = _boundary(gy, gpy, grad, h, g_moving, elasticity)
        else:
            cx = torch.clamp(gx, grad, w - grad)
            gpx = torch.where(g_moving & (cx != gx), cx, gpx)
            gx = torch.where(g_moving, cx, gx)
            cy = torch.clamp(gy, grad, h - grad)
            gpy = torch.where(g_moving & (cy != gy), cy, gpy)
            gy = torch.where(g_moving, cy, gy)
        gx, gy, cnt = pair_pass_resident(gx, gy, grad, meta, salt, strength)
        g_count = g_count + cnt

    in_grid = lay.in_grid
    new_x = torch.where(in_grid, lay.gather(gx), t.x)
    new_y = torch.where(in_grid, lay.gather(gy), t.y)
    rpx, rpy = lay.gather(gpx), lay.gather(gpy)
    if carry_px:
        new_px = torch.where(in_grid, rpx, rb.px)
        new_py = torch.where(in_grid, rpy, rb.py)
    else:
        new_px = torch.where(in_grid & torch.isfinite(rpx), rpx, rb.px)
        new_py = torch.where(in_grid & torch.isfinite(rpy), rpy, rb.py)
    new_count = torch.where(in_grid, lay.gather(g_count), 0)

    # overflow entities: boundary-only fallback (idempotent clamp once)
    moving = t.active & rb.active & ~rb.static
    over = lay.valid & ~in_grid
    fx, fpx = _boundary(t.x, rb.px, c.radius, w, moving & over, elasticity)
    fy, fpy = _boundary(t.y, rb.py, c.radius, h, moving & over, elasticity)
    world = world.replace(
        transform=t.replace(
            x=torch.where(over, fx, new_x), y=torch.where(over, fy, new_y),
        ),
        rigid_body=rb.replace(
            px=torch.where(over, fpx, new_px),
            py=torch.where(over, fpy, new_py),
            collision_count=new_count,
        ),
    )
    return (
        world,
        torch.sum(in_grid, dtype=torch.int32),
        torch.sum(over, dtype=torch.int32),
    )
