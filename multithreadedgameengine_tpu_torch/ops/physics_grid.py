"""The grid constraint solver, resident in the pair kernels' layout.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/physics_grid.py``:
``solver_geometry`` (:43-80), ``grid_constraints_resident`` (:485-694) with
the bin cache (``_cached_bins``, :350-379) and the attribute-layout cache,
the shared substep loop ``_resident_substeps`` (:382-482), the kernel gate
``_use_symmetric`` (:770-778), and the position-resident solver:
``_pin_layout_positions``, ``_layout_verlet``, ``_band_spec``,
``resident_persistent_step``, ``resident_sync_entity`` and
``resident_lazy_frame`` (:781-1307).

The layout is slot-major ``[cap, R+2, C+2]`` (slot plane, cell row, cell
col, with a one-cell empty border): cell (r, c) of the grid is layout row
1 + r, column 1 + c. The TPU's 8-row halo and 128-lane pad are not carried
over. Entities past a cell's capacity fall back to the boundary clamp alone
for the frame and are counted as overflow.

Where the reference chooses a branch inside its program with
``jax.lax.cond`` (rebin or keep the cached bins; the FAST or REBUILD
resident frame; sync or not), the port chooses with a host ``if`` on the
world's host-int stamps ``solver_bin_step`` and ``solver_pos_step``, so no
frame reads the device to choose.

The halo step's solver keeps the reference's other layout, the bordered
grid ``[R+2, C+2, cap, 8]`` of packed rows: ``pack_solver_rows`` (:106-134),
``scatter_solver_grid`` (:137-151) and ``run_solver_substeps`` (:154-302),
a one-grid loop over :func:`grid_solver_state` and :func:`solver_substep`;
the slab mesh calls those two itself, to exchange halo rows between
substeps. Its "pallas" branch
runs K3 (``cuda_kernels.pair_pass_grid``), every other solver the XLA
formulation in plain torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..components import Struct
from ..config import EngineConfig
from ..state import World
from .cuda_kernels import pair_pass_grid, pair_pass_resident, pair_pass_symmetric
from .physics import _boundary, _pair_hash_dir, _sqrt, verlet_delta, verlet_move
from .spatial import GridGeom, bin_entities

Band = Tuple[int, int, int, int]


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


def reference_lane_width(geom: GridGeom) -> int:
    """The reference layout's padded lane width ``ceil((C+2)/128)*128``,
    which its kernel gate reads (physics_grid.py:633-640)."""
    return -(-(geom.cols + 2) // 128) * 128


def use_symmetric(cfg: EngineConfig, geom: GridGeom) -> bool:
    """The kernel gate (the reference's ``_use_symmetric``): K2, the
    predicated Newton-symmetric pass, where the reference runs it -- the
    "pallas" solver with ``solver_symmetric`` and ``solver_predicated`` "on",
    or "auto" at a reference lane width of 512 or more; K1 everywhere else
    (the "grid" solver is the reference's XLA formulation, whose order K1
    keeps)."""
    ph = cfg.physics
    return (
        ph.solver == "pallas"
        and bool(ph.solver_symmetric)
        and (ph.solver_predicated == "on"
             or (ph.solver_predicated == "auto" and reference_lane_width(geom) >= 512))
    )


def _scatter(flat: torch.Tensor, shape, values: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Per-entity values into a layout of ``shape``; entities not in the grid
    carry the spare slot index ``total`` and land past the end, which is cut
    off (the reference's ``mode="drop"``, with no index mask or device
    sync)."""
    total = shape[0] * shape[1] * shape[2]
    out = torch.full((total + 1,), fill, dtype=values.dtype, device=values.device)
    out.index_copy_(0, flat, values)
    return out[:total].view(shape)


def _gather(flat: torch.Tensor, in_grid: torch.Tensor, layout: torch.Tensor) -> torch.Tensor:
    """Layout values back to entity order (entities not in the grid read
    slot 0; callers mask them)."""
    return layout.reshape(-1)[torch.where(in_grid, flat, 0)]


def _bins(x, y, valid, geom: GridGeom) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat slot, in-grid mask) of every entity; ``total`` for entities
    outside the grid or past their cell's capacity."""
    cap, rows, cols = layout_shape(geom)
    bins = bin_entities(x, y, valid, geom, build_table=False)
    in_grid = valid & (bins.rank < cap)
    # rank is clamped before the product: an overflow rank can reach N
    rank = torch.where(in_grid, bins.rank, 0).to(torch.int64)
    flat = (rank * rows + (1 + bins.row.to(torch.int64))) * cols + (
        1 + bins.col.to(torch.int64)
    )
    return torch.where(in_grid, flat, cap * rows * cols), in_grid


def _attr_layouts(world: World, flat: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radius and meta (``gid | flags << 24``, 0 = empty slot) layouts
    of a slot assignment: flag bits 1 collider active, 2 trigger, 4 static,
    8 moving."""
    t, rb, c = world.transform, world.rigid_body, world.collider
    n = t.x.shape[0]
    flags = (
        c.active.to(torch.int32)
        | (c.is_trigger.to(torch.int32) << 1)
        | (rb.static.to(torch.int32) << 2)
        | ((t.active & rb.active & ~rb.static).to(torch.int32) << 3)
    )
    gid = torch.arange(n, dtype=torch.int32, device=t.x.device)
    return _scatter(flat, shape, c.radius), _scatter(flat, shape, gid | (flags << 24), fill=0)


def _check_ids(n: int) -> None:
    if n >= (1 << 24):
        raise ValueError("the solver packs entity ids into 24 bits: N < 2^24")


@dataclass
class SolverLayout:
    """One binning and the static layouts built from it."""

    flat: torch.Tensor  # int64[N] slot of each entity (spare slot if not in_grid)
    in_grid: torch.Tensor  # bool[N] binned within capacity
    radius: torch.Tensor  # f32[cap, R+2, C+2]
    meta: torch.Tensor  # int32[cap, R+2, C+2]: gid | flags << 24, 0 = empty

    def scatter(self, values: torch.Tensor, fill=0.0) -> torch.Tensor:
        return _scatter(self.flat, self.meta.shape, values, fill)


def build_layout(world: World, geom: GridGeom) -> SolverLayout:
    """Bin the world and scatter the radius and meta layouts."""
    t = world.transform
    _check_ids(t.x.shape[0])
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)
    flat, in_grid = _bins(t.x, t.y, valid, geom)
    radius, meta = _attr_layouts(world, flat, layout_shape(geom))
    return SolverLayout(flat=flat, in_grid=in_grid, radius=radius, meta=meta)


def bins_expired(world: World, interval: int) -> bool:
    """Whether the cached bins must be recomputed this frame: never binned,
    invalidated by a host write (stamp -1), or ``interval`` frames old."""
    return (world.solver_bin_step < 0
            or world.step_count - world.solver_bin_step >= interval)


def _band_px(a, pa, grad, g_moving, slices, extent: float, elasticity: float) -> None:
    """The bounce write ``px = cx + (cx - px) * e`` on border slices only,
    IN PLACE on ``pa`` (a layout the calling frame created)."""
    for sl in slices:
        ab, pb = a[sl], pa[sl]
        cxb = torch.clamp(ab, grad[sl], extent - grad[sl])
        hit = g_moving[sl] & (cxb != ab)
        pa[sl] = torch.where(hit, cxb + (cxb - pb) * elasticity, pb)


def _resident_substeps(gx, gy, gpx, gpy, grad, meta, g_moving, cfg: EngineConfig,
                       salt: int, symmetric: bool, carry_px: bool,
                       band: Optional[Band] = None):
    """The shared substep loop of the resident solver paths: boundary +
    pair pass (K2 when ``symmetric``, else K1), in the layout.
    ``carry_px=False`` runs the NaN-carry px variant (see
    :func:`grid_constraints_resident`); ``True`` applies the full reflected
    bounce to real px/py.

    ``band=(r_lo, r_hi, c_lo, c_hi)`` runs the banded boundary (needs
    ``carry_px`` and K2): the position clamp folds into K2
    (``clamp_bounds``) for every slot, and the px/py bounce touches only the
    layout's border bands, rows ``[:r_lo]`` and ``[r_hi:]`` for y and columns
    ``[:c_lo]`` and ``[c_hi:]`` for x. Returns (gx, gy, gpx, gpy, count)."""
    ph = cfg.physics
    strength = float(ph.collision_response_strength)
    elasticity = ph.boundary_elasticity
    w, h = cfg.world_width, cfg.world_height
    if band is not None:
        assert carry_px and symmetric
        r_lo, r_hi, c_lo, c_hi = band
        x_band = ((slice(None), slice(None), slice(0, c_lo)),
                  (slice(None), slice(None), slice(c_hi, None)))
        y_band = ((slice(None), slice(0, r_lo)), (slice(None), slice(r_hi, None)))
    cnt = torch.zeros(meta.shape, dtype=torch.int32, device=meta.device)
    for _ in range(ph.sub_step_count):
        if band is not None:
            _band_px(gx, gpx, grad, g_moving, x_band, w, elasticity)
            _band_px(gy, gpy, grad, g_moving, y_band, h, elasticity)
        elif carry_px:
            gx, gpx = _boundary(gx, gpx, grad, w, g_moving, elasticity)
            gy, gpy = _boundary(gy, gpy, grad, h, g_moving, elasticity)
        else:
            cx = torch.clamp(gx, grad, w - grad)
            gpx = torch.where(g_moving & (cx != gx), cx, gpx)
            gx = torch.where(g_moving, cx, gx)
            cy = torch.clamp(gy, grad, h - grad)
            gpy = torch.where(g_moving & (cy != gy), cy, gpy)
            gy = torch.where(g_moving, cy, gy)
        if symmetric:
            gx, gy, c = pair_pass_symmetric(
                gx, gy, grad, meta, salt, strength,
                clamp_bounds=(w, h) if band is not None else None,
            )
        else:
            gx, gy, c = pair_pass_resident(gx, gy, grad, meta, salt, strength)
        cnt = cnt + c
    return gx, gy, gpx, gpy, cnt


def _overflow_fallback(x, y, px, py, radius, moving, over, cfg: EngineConfig):
    """Entities past their cell's capacity: the boundary clamp alone
    (idempotent clamp once)."""
    e = cfg.physics.boundary_elasticity
    fx, fpx = _boundary(x, px, radius, cfg.world_width, moving & over, e)
    fy, fpy = _boundary(y, py, radius, cfg.world_height, moving & over, e)
    return fx, fy, fpx, fpy


def grid_constraints_resident(
    world: World, cfg: EngineConfig, geom: GridGeom
) -> Tuple[World, torch.Tensor, torch.Tensor]:
    """Substepped boundary and pair constraints (applyConstraintsVerlet,
    physics_worker.js:203-217, :323-395) in the solver layout: bin (or reuse
    the cached bins and, for the "pallas" solver, the cached radius/meta/
    max_vel layouts), scatter x/y, run the substeps with the gated kernel,
    read back. Returns (world, n_binned, overflow) with the two counts as
    0-dim int32 tensors (no device sync)."""
    ph = cfg.physics
    t, rb, c = world.transform, world.rigid_body, world.collider
    _check_ids(t.x.shape[0])
    shape = layout_shape(geom)
    valid = t.active & torch.isfinite(t.x) & torch.isfinite(t.y)

    # The bin cache (physics.rebin_interval > 1, installed by the engine)
    # recomputes the slot assignment on the first frame and every k-th frame
    # after and reuses it in between; positions scattered into the (possibly
    # stale) slots are always current. The attribute layouts (the "pallas"
    # solver's cache) ride the rebin, and so does a residency max_vel layout,
    # or a later resident frame would clamp through a stale assignment.
    interval = max(1, ph.rebin_interval)
    bins_cached = interval > 1 and world.solver_flat is not None
    attr_cached = (
        interval > 1
        and world.solver_grad is not None
        and tuple(world.solver_grad.shape) == shape
    )
    if bins_cached and not bins_expired(world, interval):
        flat, in_grid = world.solver_flat, world.solver_in_grid
        if attr_cached:
            grad, meta = world.solver_grad, world.solver_meta
        else:
            grad, meta = _attr_layouts(world, flat, shape)
    else:
        lay = build_layout(world, geom)
        flat, in_grid, grad, meta = lay.flat, lay.in_grid, lay.radius, lay.meta
        if bins_cached:
            caches = dict(solver_flat=flat, solver_in_grid=in_grid,
                          solver_bin_step=world.step_count)
            if attr_cached:
                caches.update(solver_grad=grad, solver_meta=meta)
                if (world.solver_maxv is not None
                        and tuple(world.solver_maxv.shape) == shape):
                    caches.update(solver_maxv=lay.scatter(rb.max_vel))
            world = world.replace(**caches)

    gx = _scatter(flat, shape, t.x)
    gy = _scatter(flat, shape, t.y)
    g_moving = ((meta >> 24) & 8) != 0
    salt = world.step_count & 0xFFFFFFFF

    # px/py: the pair pass never reads them, only the boundary bounce does.
    # At elasticity 0 the bounce collapses to px' = the last clamped value,
    # so px/py start as NaN ("never hit") and the entity's own px/py are
    # kept where they stay NaN (physics_grid.py:642-677).
    carry_px = ph.boundary_elasticity != 0.0
    if carry_px:
        gpx = _scatter(flat, shape, rb.px)
        gpy = _scatter(flat, shape, rb.py)
    else:
        gpx = torch.full_like(gx, float("nan"))
        gpy = torch.full_like(gy, float("nan"))

    gx, gy, gpx, gpy, g_count = _resident_substeps(
        gx, gy, gpx, gpy, grad, meta, g_moving, cfg, salt,
        use_symmetric(cfg, geom), carry_px,
    )

    new_x = torch.where(in_grid, _gather(flat, in_grid, gx), t.x)
    new_y = torch.where(in_grid, _gather(flat, in_grid, gy), t.y)
    rpx, rpy = _gather(flat, in_grid, gpx), _gather(flat, in_grid, gpy)
    if carry_px:
        new_px = torch.where(in_grid, rpx, rb.px)
        new_py = torch.where(in_grid, rpy, rb.py)
    else:
        new_px = torch.where(in_grid & torch.isfinite(rpx), rpx, rb.px)
        new_py = torch.where(in_grid & torch.isfinite(rpy), rpy, rb.py)
    new_count = torch.where(in_grid, _gather(flat, in_grid, g_count), 0)

    moving = t.active & rb.active & ~rb.static
    over = valid & ~in_grid
    fx, fy, fpx, fpy = _overflow_fallback(t.x, t.y, rb.px, rb.py, c.radius,
                                          moving, over, cfg)
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


# ----------------------------------------------------------------------
# position residency (physics.position_residency)
# ----------------------------------------------------------------------


def _pin_layout_positions(gx0, gy0, flat0, in_grid0, xs, ys, pin_rows):
    """Refresh host-driven rows' layout positions (the mouse, written by
    apply_inputs in entity order every frame): one one-element scatter per
    pinned row into a copy of the layout, with the same "current positions
    in stale slots" semantics as the bin cache."""
    if not pin_rows:
        return gx0, gy0
    shape = gx0.shape
    total = gx0.numel()
    # one spare slot past the end takes a pinned row that is not in the grid
    out_x = torch.cat([gx0.reshape(-1), gx0.new_zeros(1)])
    out_y = torch.cat([gy0.reshape(-1), gy0.new_zeros(1)])
    for r in pin_rows:
        row = slice(r, r + 1)  # slices, not an index tensor: no host copy
        fr = torch.where(in_grid0[row], flat0[row], total)
        out_x.index_copy_(0, fr, xs[row])
        out_y.index_copy_(0, fr, ys[row])
    return out_x[:total].view(shape), out_y[:total].view(shape)


def _layout_verlet(gx0, gy0, gpx0, gpy0, meta0, maxv0, cfg: EngineConfig,
                   force_specs, inputs, dt_ratio: float):
    """The layout-space tick forces and Verlet move shared by
    :func:`resident_persistent_step`'s FAST branch and
    :func:`resident_lazy_frame`: ``behavior.eval_layout_forces`` over the
    slots, then :func:`~.physics.verlet_delta` (the entity-order formula)
    for moving slots (meta flag 8). Returns (gx1, gy1, gpx1, gpy1)."""
    from ..behavior import eval_layout_forces

    gid0 = meta0 & 0xFFFFFF
    gax, gay = eval_layout_forces(force_specs, gx0, gy0, gid0, inputs, cfg)
    mv = ((meta0 >> 24) & 8) != 0
    dx, dy = verlet_delta(gx0, gy0, gpx0, gpy0, gax, gay, maxv0, cfg, dt_ratio)
    return (
        torch.where(mv, gx0 + dx, gx0),
        torch.where(mv, gy0 + dy, gy0),
        torch.where(mv, gx0, gpx0),
        torch.where(mv, gy0, gpy0),
    )


def _band_spec(cfg: EngineConfig, geom: GridGeom, band_vel_bound: float,
               symmetric: bool) -> Tuple[Optional[Band], int]:
    """Banded-boundary sizing (the reference's ``_band_spec``, re-derived for
    the port's layout: one border cell, no row or lane padding). Drift
    between rebins is bounded by (interval - 1) Verlet-clamped frames plus
    pair-push and cell-quantisation slack (4 cells), so the bands hold
    ``band_cells`` cell rows/columns next to each world border. Returns
    ((r_lo, r_hi, c_lo, c_hi) or None, band_cells); None when banding is off
    or the bands would meet."""
    if not (band_vel_bound > 0.0 and symmetric):
        return None, 0
    interval = max(2, cfg.physics.rebin_interval)
    _cap, rows, cols = layout_shape(geom)
    band_cells = int(math.ceil((interval - 1) * float(band_vel_bound) / geom.cell_size)) + 4
    r_lo, r_hi = 1 + band_cells, rows - 1 - band_cells
    c_lo, c_hi = 1 + band_cells, cols - 1 - band_cells
    if r_lo < r_hi and c_lo < c_hi:
        return (r_lo, r_hi, c_lo, c_hi), band_cells
    return None, band_cells


def _drift_limit(geom: GridGeom, band_cells: int) -> float:
    return float(np.float32((band_cells - 1) * geom.cell_size))


def resident_persistent_step(
    world: World,
    cfg: EngineConfig,
    geom: GridGeom,
    inputs,
    force_specs,
    dt_ratio: float,
    pin_rows: Tuple[int, ...] = (),
    band_vel_bound: float = 0.0,
) -> Tuple[World, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verlet move + constraints with layout-resident positions: x/y/px/py
    live in the solver layout across frames (``world.solver_x/y/px/py``), so
    the entity-to-layout position scatters run only on layout (re)build
    frames. Replaces ``verlet_move`` + :func:`grid_constraints_resident` for
    scenes whose ticks are layout-safe (``behavior.probe_layout_safe``);
    ``update_derived`` still runs after.

    Per frame, one of two regimes, chosen on the host from the stamps:

    - FAST (layout current and bins unexpired): tick forces and the Verlet
      move evaluate over layout slots (:func:`_layout_verlet`), no scatters,
      no binning;
    - REBUILD: bins (fresh if expired, else cached) and x/y/px/py scattered
      from the entity-order post-move state.

    The entity-order Verlet runs every frame (it supplies vx/vy, the rebuild
    values and the overflow fallback), and the read-back keeps entity-order
    x/y/px/py current every frame; bit-exact with residency off.

    ``band_vel_bound > 0`` with K2 runs the banded boundary (:func:`_band_spec`):
    bit-exact with the full-layout boundary while no in-grid entity drifts
    farther from its slot's cell than the band assumes; ``band_drift``
    counts those that did (0 in healthy runs).

    Returns (world, n_binned, overflow_count, band_drift)."""
    ph = cfg.physics
    interval = max(2, ph.rebin_interval)
    shape = layout_shape(geom)
    cap, rows, cols = shape
    n = world.transform.x.shape[0]
    _check_ids(n)
    if world.solver_x is None or tuple(world.solver_x.shape) != shape:
        raise ValueError(
            "position residency requires Engine-installed solver_x/y/px/py "
            "layout leaves at the current geometry"
        )

    w_e = verlet_move(world, cfg, dt_ratio)
    te, rbe = w_e.transform, w_e.rigid_body
    c = world.collider
    moving_e = te.active & rbe.active & ~rbe.static
    valid_e = te.active & torch.isfinite(te.x) & torch.isfinite(te.y)

    pos_valid = world.solver_pos_step == world.step_count
    expired = bins_expired(world, interval)
    if pos_valid and not expired:
        flat, in_grid = world.solver_flat, world.solver_in_grid
        grad, meta, maxv = world.solver_grad, world.solver_meta, world.solver_maxv
        gx0, gy0 = _pin_layout_positions(world.solver_x, world.solver_y, flat,
                                         in_grid, te.x, te.y, pin_rows)
        gx, gy, gpx, gpy = _layout_verlet(gx0, gy0, world.solver_px, world.solver_py,
                                          meta, maxv, cfg, force_specs, inputs, dt_ratio)
    else:
        if expired:
            lay = build_layout(w_e, geom)
            flat, in_grid, grad, meta = lay.flat, lay.in_grid, lay.radius, lay.meta
            maxv = lay.scatter(rbe.max_vel)
        else:
            flat, in_grid = world.solver_flat, world.solver_in_grid
            grad, meta, maxv = world.solver_grad, world.solver_meta, world.solver_maxv
        gx, gy = _scatter(flat, shape, te.x), _scatter(flat, shape, te.y)
        gpx, gpy = _scatter(flat, shape, rbe.px), _scatter(flat, shape, rbe.py)

    g_moving = ((meta >> 24) & 8) != 0
    symmetric = use_symmetric(cfg, geom)
    band, band_cells = _band_spec(cfg, geom, band_vel_bound, symmetric)
    gx, gy, gpx, gpy, g_count = _resident_substeps(
        gx, gy, gpx, gpy, grad, meta, g_moving, cfg, world.step_count & 0xFFFFFFFF,
        symmetric, carry_px=True, band=band,
    )

    new_x = torch.where(in_grid, _gather(flat, in_grid, gx), te.x)
    new_y = torch.where(in_grid, _gather(flat, in_grid, gy), te.y)
    new_px = torch.where(in_grid, _gather(flat, in_grid, gpx), rbe.px)
    new_py = torch.where(in_grid, _gather(flat, in_grid, gpy), rbe.py)
    new_count = torch.where(in_grid, _gather(flat, in_grid, g_count), 0)

    over = valid_e & ~in_grid
    fx, fy, fpx, fpy = _overflow_fallback(te.x, te.y, rbe.px, rbe.py, c.radius,
                                          moving_e, over, cfg)
    new_x = torch.where(over, fx, new_x)
    new_y = torch.where(over, fy, new_y)
    new_px = torch.where(over, fpx, new_px)
    new_py = torch.where(over, fpy, new_py)

    if band is not None:
        # in-grid entities that drifted farther from their slot's cell than
        # the band was sized for: px/py bounces may have been missed for them
        cell = geom.cell_size
        slot_col = (flat % cols - 1).to(torch.float32)
        slot_row = ((flat // cols) % rows - 1).to(torch.float32)
        lim = _drift_limit(geom, band_cells)
        band_drift = torch.sum(
            in_grid & ((torch.abs(new_x - (slot_col + 0.5) * cell) > lim)
                       | (torch.abs(new_y - (slot_row + 0.5) * cell) > lim)),
            dtype=torch.int32,
        )
    else:
        band_drift = torch.zeros((), dtype=torch.int32, device=new_x.device)

    world = w_e.replace(
        transform=te.replace(x=new_x, y=new_y),
        rigid_body=rbe.replace(px=new_px, py=new_py, collision_count=new_count),
        solver_flat=flat, solver_in_grid=in_grid,
        solver_grad=grad, solver_meta=meta, solver_maxv=maxv,
        solver_x=gx, solver_y=gy, solver_px=gpx, solver_py=gpy,
        solver_bin_step=world.step_count if expired else world.solver_bin_step,
        solver_pos_step=world.step_count + 1,
    )
    return (world, torch.sum(in_grid, dtype=torch.int32),
            torch.sum(over, dtype=torch.int32), band_drift)


def resident_sync_entity(world: World) -> World:
    """Pull entity-order x/y/px/py current from the resident layout: the
    deferred form of :func:`resident_persistent_step`'s read-back, run by the
    lazy chunk before a frame that consumes entity order. Only when the
    layout is authoritative (position-current, and the bins not invalidated
    by a host write); otherwise the identity. Idempotent."""
    if not (world.solver_pos_step == world.step_count and world.solver_bin_step >= 0):
        return world
    flat, in_grid = world.solver_flat, world.solver_in_grid
    t, rb = world.transform, world.rigid_body
    return world.replace(
        transform=t.replace(
            x=torch.where(in_grid, _gather(flat, in_grid, world.solver_x), t.x),
            y=torch.where(in_grid, _gather(flat, in_grid, world.solver_y), t.y),
        ),
        rigid_body=rb.replace(
            px=torch.where(in_grid, _gather(flat, in_grid, world.solver_px), rb.px),
            py=torch.where(in_grid, _gather(flat, in_grid, world.solver_py), rb.py),
        ),
    )


def resident_lazy_frame(
    world: World,
    cfg: EngineConfig,
    geom: GridGeom,
    inputs,
    force_specs,
    dt_ratio: float,
    pin_rows: Tuple[int, ...] = (),
    band_vel_bound: float = 0.0,
) -> Tuple[World, torch.Tensor]:
    """One layout-only FAST frame without the entity-order read-back: the
    lazy chunk's mid-chunk body. The same layout-space forces, Verlet and
    substeps as :func:`resident_persistent_step`'s FAST branch; entity-order
    x/y/px/py of in-grid rows stay stale until :func:`resident_sync_entity`,
    and vx/vy/collision_count/speed are rewritten by the next full frame
    before anything reads them (the caller makes the chunk's last frame a
    full one).

    Rows outside the layout still evolve here, in entity order: layout-safe
    tick forces at their current positions, the Verlet move and the
    boundary-only overflow fallback, as the eager path treats them.

    Preconditions (the caller's routing): layout position-current, bins
    unexpired and not host-invalidated, every ticking class layout-safe.

    Returns (world, band_drift), the drift counted in layout space: each
    occupied moving slot's own (row, col) is its bin."""
    from ..behavior import eval_layout_forces

    ph = cfg.physics
    t, rb, c = world.transform, world.rigid_body, world.collider
    n = t.x.shape[0]
    in_grid = world.solver_in_grid
    finite = torch.isfinite(t.x) & torch.isfinite(t.y)
    moving = t.active & rb.active & ~rb.static
    out_mv = moving & ~in_grid  # every not-in-layout mover (NaN rows too)
    over = t.active & finite & ~in_grid  # the boundary-fallback set

    # entity order: rows outside the layout evolve as in the eager path
    if force_specs:
        gid = torch.arange(n, dtype=torch.int32, device=t.x.device)
        eax, eay = eval_layout_forces(force_specs, t.x, t.y, gid, inputs, cfg)
        ticked = torch.zeros((n,), dtype=torch.bool, device=t.x.device)
        for _fn, s_, c_ in force_specs:
            ticked |= (gid >= s_) & (gid < s_ + c_)
        use_t = ticked & t.active
        ax_use = torch.where(use_t, eax, rb.ax)
        ay_use = torch.where(use_t, eay, rb.ay)
    else:
        ax_use, ay_use = rb.ax, rb.ay
    dxe, dye = verlet_delta(t.x, t.y, rb.px, rb.py, ax_use, ay_use, rb.max_vel,
                            cfg, dt_ratio)
    ex = torch.where(out_mv, t.x + dxe, t.x)
    ey = torch.where(out_mv, t.y + dye, t.y)
    epx = torch.where(out_mv, t.x, rb.px)
    epy = torch.where(out_mv, t.y, rb.py)
    # ax consumed by the move: zeroed, as the eager path's Verlet does
    ax_new = torch.where(out_mv, 0.0, rb.ax)
    ay_new = torch.where(out_mv, 0.0, rb.ay)
    ex, ey, epx, epy = _overflow_fallback(ex, ey, epx, epy, c.radius, moving, over, cfg)

    # layout space: the same _layout_verlet as the FAST branch
    gx0, gy0 = _pin_layout_positions(world.solver_x, world.solver_y,
                                     world.solver_flat, in_grid, ex, ey, pin_rows)
    meta0 = world.solver_meta
    gx1, gy1, gpx1, gpy1 = _layout_verlet(gx0, gy0, world.solver_px, world.solver_py,
                                          meta0, world.solver_maxv, cfg, force_specs,
                                          inputs, dt_ratio)
    mv = ((meta0 >> 24) & 8) != 0
    symmetric = use_symmetric(cfg, geom)
    band, band_cells = _band_spec(cfg, geom, band_vel_bound, symmetric)
    gx2, gy2, gpx2, gpy2, _cnt = _resident_substeps(
        gx1, gy1, gpx1, gpy1, world.solver_grad, meta0, mv, cfg,
        world.step_count & 0xFFFFFFFF, symmetric, carry_px=True, band=band,
    )

    if band is not None:
        cell = geom.cell_size
        dev = gx2.device
        ctr_x = (torch.arange(gx2.shape[2], dtype=torch.float32, device=dev) - 0.5) * cell
        ctr_y = ((torch.arange(gx2.shape[1], dtype=torch.float32, device=dev) - 1.0)
                 + 0.5) * cell
        lim = _drift_limit(geom, band_cells)
        band_drift = torch.sum(
            mv & ((torch.abs(gx2 - ctr_x.view(1, 1, -1)) > lim)
                  | (torch.abs(gy2 - ctr_y.view(1, -1, 1)) > lim)),
            dtype=torch.int32,
        )
    else:
        band_drift = torch.zeros((), dtype=torch.int32, device=gx2.device)

    return world.replace(
        transform=t.replace(x=ex, y=ey),
        rigid_body=rb.replace(px=epx, py=epy, ax=ax_new, ay=ay_new),
        solver_x=gx2, solver_y=gy2, solver_px=gpx2, solver_py=gpy2,
        solver_pos_step=world.step_count + 1,
        step_count=world.step_count + 1,
    ), band_drift


# ----------------------------------------------------------------------
# the bordered grid layout: the halo step's solver
# ----------------------------------------------------------------------


def pack_solver_rows(world: World, gid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The solver's per-entity attributes as [N, 8] f32 rows (x, y, px, py,
    radius, flags, gid, 0): flags (1 collider, 2 trigger, 4 static, 8 moving)
    and the entity id ride as exact small floats.

    ``gid``: the GLOBAL entity ids of a chunk-local world (the halo step
    packs per-slab chunks whose ids must stay globally unique for the pair
    identity test and the coincident-pair hash); default ``arange(N)``."""
    t, rb, c = world.transform, world.rigid_body, world.collider
    n = t.x.shape[0]
    if gid is None:
        gid = torch.arange(n, dtype=torch.int32, device=t.x.device)
    if n >= (1 << 24):
        raise ValueError("grid solver packs entity ids into f32: N must be < 2^24")
    f32 = torch.float32
    flags = (
        c.active.to(f32)
        + c.is_trigger.to(f32) * 2.0
        + rb.static.to(f32) * 4.0
        + (t.active & rb.active & ~rb.static).to(f32) * 8.0
    )
    return torch.stack(
        [t.x, t.y, rb.px, rb.py, c.radius, flags, gid.to(f32), torch.zeros_like(t.x)],
        dim=1,
    )


def scatter_solver_grid(packed: torch.Tensor, flat_idx: torch.Tensor, rows: int,
                        cols: int, cap: int) -> torch.Tensor:
    """Scatter [M, 8] packed rows into a bordered grid [rows+2, cols+2, cap,
    8] at precomputed flat slots (int64; ``(rows+2)*(cols+2)*cap`` marks a
    row left out, which lands in a spare row that is cut off). Empty slots
    have gid -1."""
    flat_cells = (rows + 2) * (cols + 2) * cap
    base = torch.zeros((flat_cells + 1, 8), dtype=torch.float32, device=packed.device)
    base[:, 6] = -1.0
    base.index_copy_(0, flat_idx, packed)
    return base[:flat_cells].view(rows + 2, cols + 2, cap, 8)


@dataclass
class GridSolverState(Struct):
    """One bordered solver grid between substeps: positions and px/py change,
    the attributes do not. Every field is ``[R+2, C+2, cap]`` except
    ``attrs`` ``[R+2, C+2, cap, 3]`` (radius, flags, gid: K3's input)."""

    gx: torch.Tensor
    gy: torch.Tensor
    gpx: torch.Tensor
    gpy: torch.Tensor
    attrs: torch.Tensor
    moving: torch.Tensor  # bool: flag 8
    count: torch.Tensor  # int32 contacts summed over the substeps so far


def grid_solver_state(grid: torch.Tensor) -> GridSolverState:
    """Split a packed grid [R+2, C+2, cap, 8] into the substep state."""
    pk = grid[..., 5].to(torch.int32)
    return GridSolverState(
        gx=grid[..., 0].contiguous(), gy=grid[..., 1].contiguous(),
        gpx=grid[..., 2].contiguous(), gpy=grid[..., 3].contiguous(),
        attrs=grid[..., 4:7].contiguous(),
        moving=(pk & 8) != 0,
        count=torch.zeros(pk.shape, dtype=torch.int32, device=grid.device),
    )


def _grid_pass_xla(gx, gy, attrs, salt: int, strength: float):
    """The reference's XLA formulation of one pair pass on the bordered grid
    (physics_grid.py:213-295): full-shell 3x3 offsets, neighbour slots in
    chunks of J = 8 (or the largest of 4, 2, 1 dividing cap), each chunk's
    pushes summed over the chunk. Plain torch, not a kernel; its sums run in
    another order than K3's. Returns (disp_x, disp_y, count), 0 on the
    border."""
    rows, cols, cap = gx.shape
    flat = lambda a: a.reshape(rows * cols, cap)  # noqa: E731
    grad = flat(attrs[..., 0])
    pk = flat(attrs[..., 1].to(torch.int32))
    gid = flat(attrs[..., 2].to(torch.int32))
    xf, yf = flat(gx), flat(gy)
    g_coll, g_trig, g_static = (pk & 1) == 1, (pk & 2) != 0, (pk & 4) != 0
    # the interior cells holding a collider, as flat indices: every other
    # cell gets nothing, so only these are computed (each slot's sums run
    # as in the dense computation)
    coll = g_coll.any(1).view(rows, cols).clone()
    coll[0], coll[-1], coll[:, 0], coll[:, -1] = False, False, False, False
    cidx = torch.nonzero(coll.flatten()).flatten()

    xs, ys, rs = xf[cidx][..., None], yf[cidx][..., None], grad[cidx][..., None]
    ok_i, trig_i = g_coll[cidx][..., None], g_trig[cidx][..., None]
    st_i, id_i = g_static[cidx][..., None], gid[cidx][..., None]
    n = cidx.shape[0]
    acc_x = torch.zeros((n, cap), dtype=torch.float32, device=gx.device)
    acc_y = torch.zeros_like(acc_x)
    acc_c = torch.zeros((n, cap), dtype=torch.int32, device=gx.device)
    J = next(j for j in (8, 4, 2, 1) if cap % j == 0)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            nb = cidx + dr * cols + dc
            xn, yn, rn = xf[nb], yf[nb], grad[nb]
            okn, trign, stn, idn = g_coll[nb], g_trig[nb], g_static[nb], gid[nb]
            for c0 in range(0, cap, J):
                sl = (Ellipsis, None, slice(c0, c0 + J))  # [n, 1, J]
                ok = ok_i & okn[sl] & (id_i != idn[sl])
                dx = xs - xn[sl]
                dy = ys - yn[sl]
                d2 = dx * dx + dy * dy
                min_d = rs + rn[sl]
                overlap = ok & (d2 < min_d * min_d)

                trig = trig_i | trign[sl]
                st_j = stn[sl]
                share = torch.where(trig | st_i, 0.0, torch.where(st_j, 1.0, 0.5))
                inv_dist = torch.where(d2 > 0, 1.0 / _sqrt(d2), 0.0)
                dist = d2 * inv_dist
                corr = (min_d - dist) * strength * share
                zero = d2 == 0
                id_j = idn[sl]
                ux, uy = _pair_hash_dir(id_i, id_j, salt)
                sign = torch.where(id_i < id_j, 1.0, -1.0)
                zshare = torch.where(
                    trig | st_i, 0.0, torch.where(st_j, 2.0, 1.0)
                ) * sign * 0.001
                push_x = torch.where(zero, ux * zshare, dx * inv_dist * corr)
                push_y = torch.where(zero, uy * zshare, dy * inv_dist * corr)
                ov = overlap.to(torch.float32)
                acc_x = acc_x + torch.sum(push_x * ov, dim=-1)
                acc_y = acc_y + torch.sum(push_y * ov, dim=-1)
                acc_c = acc_c + torch.sum(overlap, dim=-1, dtype=torch.int32)
    disp_x = torch.zeros_like(gx)
    disp_y = torch.zeros_like(gy)
    count = torch.zeros(gx.shape, dtype=torch.int32, device=gx.device)
    disp_x.view(rows * cols, cap)[cidx] = acc_x
    disp_y.view(rows * cols, cap)[cidx] = acc_y
    count.view(rows * cols, cap)[cidx] = acc_c
    return disp_x, disp_y, count


def solver_substep(st: GridSolverState, cfg: EngineConfig, salt: int) -> GridSolverState:
    """One substep on one bordered grid: the boundary clamp and bounce
    (physics_worker.js:344-376), then one pair pass -- K3 for the "pallas"
    solver, else the XLA formulation -- whose displacements are added.
    Reads are against the substep's starting positions (Jacobi)."""
    ph = cfg.physics
    e = ph.boundary_elasticity
    grad = st.attrs[..., 0]
    gx, gpx = _boundary(st.gx, st.gpx, grad, cfg.world_width, st.moving, e)
    gy, gpy = _boundary(st.gy, st.gpy, grad, cfg.world_height, st.moving, e)
    strength = float(ph.collision_response_strength)
    if ph.solver == "pallas":
        dx, dy, cnt = pair_pass_grid(gx, gy, st.attrs, salt, strength)
    else:
        dx, dy, cnt = _grid_pass_xla(gx, gy, st.attrs, salt, strength)
    return st.replace(gx=gx + dx, gy=gy + dy, gpx=gpx, gpy=gpy, count=st.count + cnt)


def run_solver_substeps(grid: torch.Tensor, geom: GridGeom, cfg: EngineConfig,
                        salt: int):
    """The substep loop over one bordered solver grid [R+2, C+2, cap, 8]
    (channels per :func:`pack_solver_rows`; the reference's function,
    physics_grid.py:154-302). ``geom.rows/cols`` describe the interior; the
    one-cell border is read as it stands (empty on one device). The halo
    step does not call this loop: its border refresh needs every slab at
    the same substep, so ``parallel.halo`` runs :func:`solver_substep`
    slab by slab between its exchanges.

    Returns (gx, gy, gpx, gpy, count), each [R+2, C+2, cap]."""
    expect = (geom.rows + 2, geom.cols + 2, geom.capacity, 8)
    if tuple(grid.shape) != expect:
        raise ValueError(f"grid shape {tuple(grid.shape)} != {expect} for {geom}")
    st = grid_solver_state(grid)
    for _ in range(cfg.physics.sub_step_count):
        st = solver_substep(st, cfg, salt)
    return st.gx, st.gy, st.gpx, st.gpy, st.count
