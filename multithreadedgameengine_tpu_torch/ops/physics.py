"""Verlet physics: integrate, substepped constraints, derived properties.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/physics.py``:
``verlet_move`` (moveBallsVerlet), the one-axis ``_boundary`` clamp and
bounce, the neighbour-list solver (``PairInvariants``,
``build_pair_invariants``, ``resolve_collisions_pass``,
``apply_constraints``: ``solver="neighbors"``, the reference-faithful
oracle, and the path of a scene with no collider radius), ``update_derived``
(speed and velocity angle), ``physics_step`` with its solver choice, and the
collision-pair recording for the Enter/Stay/Exit events (``PER_ENTITY``,
``record_collision_pairs``, ``compact_pairs``). The grid solver is
``ops/physics_grid.py``. The neighbour-list solver runs no kernel of its
own: the reference computes it in XLA, and here it is plain torch ops.

Jacobi, not Gauss-Seidel, exactly as the reference package: every pair of a
substep reads the substep's starting positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..components import Struct
from ..config import EngineConfig
from ..state import World
from .events import compact_rows
from .particles import first_k_where
from .spatial import NeighborLists

_U32 = 0xFFFFFFFF

#: per-row cap of the pair-recording prefilter (physics.py:46): it also
#: bounds the pairs one entity adds to a frame, which sizes the chunked
#: event log under hook-scoped recording
PER_ENTITY = 16


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. torch's CPU
    float32 ``sqrt`` is not correctly rounded in every build (the MKL path
    is off by one ulp on ~0.7% of inputs), while CUDA's ``sqrtf`` is; a
    float64 square root of a float32 value, rounded once to float32, is the
    correctly rounded result, so the CPU, the card and the CUDA kernel agree
    bit for bit."""
    return torch.sqrt(t.double()).to(t.dtype)


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``atan2`` that depends on its inputs alone: computed in
    float64 and rounded once to float32, as :func:`_sqrt`. torch's CPU
    float32 ``atan2`` runs a vectorised approximation over the body of a
    tensor and the scalar libm over its tail, so one pair of inputs rounds
    differently by its position (one ulp), and the slab steps' chunks would
    part from the single-device step's one tensor."""
    return torch.atan2(y.double(), x.double()).to(y.dtype)


def _pair_hash_dir(
    i: torch.Tensor, j: torch.Tensor, salt: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair-consistent unit direction for exactly coincident pairs: both
    members derive the same direction and push opposite ways.

    The uint32 arithmetic of the reference (physics.py:66-76) is emulated in
    int64 with ``& 0xFFFFFFFF`` after each product; the ids are < 2^24, so no
    product overflows int64. The normalisation is ``1 / sqrt``, correctly
    rounded, where the reference calls ``jax.lax.rsqrt``."""
    a = torch.minimum(i, j).to(torch.int64)
    b = torch.maximum(i, j).to(torch.int64)
    h = ((a * 0x9E3779B1) & _U32) ^ ((b * 0x85EBCA77) & _U32) ^ (int(salt) & _U32)
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _U32
    h = h ^ (h >> 12)
    hx = (h & 0xFFFF).to(torch.float32) - 32767.5
    hy = ((h >> 16) & 0xFFFF).to(torch.float32) - 32767.5
    inv = 1.0 / _sqrt(hx * hx + hy * hy)  # never 0: the +-0.5 offset
    return hx * inv, hy * inv


def verlet_delta(
    x: torch.Tensor, y: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
    ax: torch.Tensor, ay: torch.Tensor, max_vel: torch.Tensor,
    cfg: EngineConfig, dt_ratio: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Verlet displacement of moveBallsVerlet (physics_worker.js:240-316),
    clamped per axis to maxVel (default cap 100, :284). One implementation
    for entity order (:func:`verlet_move`) and the solver layout
    (``physics_grid._layout_verlet``), so the two agree bit for bit."""
    ph = cfg.physics
    # the reference computes these constants in float32; so does this
    gravity_scale = np.float32(dt_ratio) ** 2
    gx = float(np.float32(gravity_scale * np.float32(ph.gravity[0])))
    gy = float(np.float32(gravity_scale * np.float32(ph.gravity[1])))
    damping = float(np.float32(ph.verlet_damping))

    dx = (x - px) * damping + gx + ax * dt_ratio
    dy = (y - py) * damping + gy + ay * dt_ratio
    max_speed = torch.where(max_vel > 0, max_vel, 100.0)
    return (torch.clamp(dx, -max_speed, max_speed),
            torch.clamp(dy, -max_speed, max_speed))


def verlet_move(world: World, cfg: EngineConfig, dt_ratio: float) -> World:
    """moveBallsVerlet (physics_worker.js:240-316)."""
    t, rb = world.transform, world.rigid_body
    moving = t.active & rb.active & ~rb.static
    dx, dy = verlet_delta(t.x, t.y, rb.px, rb.py, rb.ax, rb.ay, rb.max_vel,
                          cfg, dt_ratio)
    return world.replace(
        transform=t.replace(
            x=torch.where(moving, t.x + dx, t.x),
            y=torch.where(moving, t.y + dy, t.y),
        ),
        rigid_body=rb.replace(
            px=torch.where(moving, t.x, rb.px),
            py=torch.where(moving, t.y, rb.py),
            vx=torch.where(moving, dx / dt_ratio, rb.vx),
            vy=torch.where(moving, dy / dt_ratio, rb.vy),
            ax=torch.where(moving, 0.0, rb.ax),
            ay=torch.where(moving, 0.0, rb.ay),
        ),
    )


def _boundary(
    x: torch.Tensor,
    px: torch.Tensor,
    r: torch.Tensor,
    lo_extent: float,
    moving: torch.Tensor,
    elasticity: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-axis boundary clamp and bounce (physics_worker.js:344-376): the
    previous position is reflected about the clamped coordinate,
    ``px = x' + (x' - px) * e``."""
    clamped = torch.clamp(x, r, lo_extent - r)
    hit = moving & (clamped != x)
    new_px = torch.where(hit, clamped + (clamped - px) * elasticity, px)
    return torch.where(moving, clamped, x), new_px


@dataclasses.dataclass
class PairInvariants(Struct):
    """Substep-invariant data of every neighbour candidate ``[N, M]``
    (physics.py:134-150), gathered once a frame: collider attributes do not
    change within a frame, so only positions are gathered again in each
    substep."""

    j: torch.Tensor  # int32[N, M] candidate ids (-1 empty)
    j_safe: torch.Tensor  # int64[N, M], the ids clamped to >= 0 for gathers
    pair_ok: torch.Tensor  # bool[N, M] both sides active colliders
    min_dist: torch.Tensor  # f32[N, M] r_i + r_j
    respond_scale: torch.Tensor  # f32[N, M] i's response share: 0, 0.5 or 1
    zero_scale: torch.Tensor  # f32[N, M] exact-overlap share (0, 1, 2) x sign
    zero_ux: torch.Tensor  # f32[N, M] pair-hash jitter direction x
    zero_uy: torch.Tensor  # f32[N, M] pair-hash jitter direction y


def build_pair_invariants(
    nbr: NeighborLists,
    active: torch.Tensor,
    collider_active: torch.Tensor,
    radius: torch.Tensor,
    is_trigger: torch.Tensor,
    is_static: torch.Tensor,
    salt: int,
) -> PairInvariants:
    """The candidates' invariants (physics.py:153-202): one packed gather of
    the flags (bit 0 active collider, bit 1 trigger, bit 2 static), the
    radius sum, i's response share (half when both move, full against a
    static, none when i is static or either is a trigger;
    physics_worker.js:513-547), the exact-overlap share with its sign (the
    lower id pushes +, doubled against a static; :459-506) and the
    pair-hash direction."""
    n = nbr.ids.shape[0]
    j = nbr.ids
    j_safe = torch.clamp(j, min=0).to(torch.int64)
    i_idx = torch.arange(n, dtype=torch.int32, device=j.device)[:, None]

    ok = active & collider_active
    flags = (ok.to(torch.int32) | (is_trigger.to(torch.int32) << 1)
             | (is_static.to(torch.int32) << 2))
    flags_j = flags[j_safe]
    ok_j = (j >= 0) & ((flags_j & 1) == 1)
    trig_j = (flags_j & 2) != 0
    static_j = (flags_j & 4) != 0

    pair_ok = ok[:, None] & ok_j
    min_dist = radius[:, None] + radius[j_safe]
    no_push = is_trigger[:, None] | trig_j | is_static[:, None]
    respond_scale = torch.where(no_push, 0.0, torch.where(static_j, 1.0, 0.5))
    sign = torch.where(i_idx < j, 1.0, -1.0)
    zero_scale = torch.where(no_push, 0.0, torch.where(static_j, 2.0, 1.0)) * sign
    zero_ux, zero_uy = _pair_hash_dir(i_idx, j, salt)
    return PairInvariants(
        j=j, j_safe=j_safe, pair_ok=pair_ok, min_dist=min_dist,
        respond_scale=respond_scale, zero_scale=zero_scale,
        zero_ux=zero_ux, zero_uy=zero_uy,
    )


def resolve_collisions_pass(
    x: torch.Tensor, y: torch.Tensor, inv: PairInvariants, response_strength: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Jacobi separation pass (resolveCollisionsVerlet,
    physics_worker.js:405-568; physics.py:205-241). Returns (dx, dy, the
    int32 overlap count of each entity, the bool overlap mask ``[N, M]``).

    ``1 / sqrt``, correctly rounded, where the reference calls
    ``jax.lax.rsqrt`` (approximate on XLA:CPU), as the grid pair passes do;
    an exactly coincident pair pushes along the pair-hash direction."""
    dx = x[:, None] - x[inv.j_safe]
    dy = y[:, None] - y[inv.j_safe]
    d2 = dx * dx + dy * dy
    overlap = inv.pair_ok & (d2 < inv.min_dist * inv.min_dist)

    inv_dist = torch.where(d2 > 0, 1.0 / _sqrt(d2), 0.0)
    dist = d2 * inv_dist
    depth = inv.min_dist - dist
    corr = depth * response_strength * inv.respond_scale
    push_x = dx * inv_dist * corr
    push_y = dy * inv_dist * corr

    zero = d2 == 0
    sep = 0.001
    zpush_x = inv.zero_ux * sep * inv.zero_scale
    zpush_y = inv.zero_uy * sep * inv.zero_scale

    contrib_x = torch.where(overlap, torch.where(zero, zpush_x, push_x), 0.0)
    contrib_y = torch.where(overlap, torch.where(zero, zpush_y, push_y), 0.0)
    return (torch.sum(contrib_x, dim=1), torch.sum(contrib_y, dim=1),
            torch.sum(overlap, dim=1, dtype=torch.int32), overlap)


def apply_constraints(
    world: World, nbr: NeighborLists, cfg: EngineConfig
) -> Tuple[World, torch.Tensor]:
    """Substepped boundary and collision constraints over the neighbour
    lists (physics_worker.js:203-217, :323-395; physics.py:244-282):
    ``sub_step_count`` rounds of the boundary clamp and one Jacobi pass.
    Returns (world, the last substep's overlap mask ``[N, M]``)."""
    ph = cfg.physics
    t, rb, c = world.transform, world.rigid_body, world.collider
    moving = t.active & rb.active & ~rb.static
    inv = build_pair_invariants(nbr, t.active, c.active, c.radius, c.is_trigger,
                                rb.static, world.step_count)
    x, y, px, py = t.x, t.y, rb.px, rb.py
    cnt = torch.zeros_like(rb.collision_count)
    overlap = torch.zeros(nbr.ids.shape, dtype=torch.bool, device=x.device)
    for _ in range(ph.sub_step_count):
        x, px = _boundary(x, px, c.radius, cfg.world_width, moving, ph.boundary_elasticity)
        y, py = _boundary(y, py, c.radius, cfg.world_height, moving, ph.boundary_elasticity)
        dx, dy, sub_cnt, overlap = resolve_collisions_pass(
            x, y, inv, ph.collision_response_strength)
        x, y, cnt = x + dx, y + dy, cnt + sub_cnt
    world = world.replace(
        transform=t.replace(x=x, y=y),
        rigid_body=rb.replace(px=px, py=py, collision_count=cnt),
    )
    return world, overlap


def update_derived(world: World, cfg: EngineConfig) -> World:
    """speed and velocityAngle (updateDerivedProperties,
    physics_worker.js:575-604)."""
    t, rb = world.transform, world.rigid_body
    on = t.active & rb.active
    speed = _sqrt(rb.vx * rb.vx + rb.vy * rb.vy)
    angle = _atan2(rb.vy, rb.vx) + float(np.float32(math.pi / 2))
    return world.replace(
        rigid_body=rb.replace(
            speed=torch.where(on, speed, rb.speed),
            velocity_angle=torch.where(
                on & (speed > cfg.physics.min_speed_for_rotation),
                angle,
                rb.velocity_angle,
            ),
        )
    )


def record_collision_pairs(
    world: World, ids: torch.Tensor, rec: torch.Tensor,
    row_ids: "torch.Tensor | None" = None,
) -> Tuple[World, torch.Tensor]:
    """Compact a recording mask into the world's ``[max_pairs, 2]`` pair
    table (the collisionData analog, physics_worker.js:444, :501-505;
    physics.py:303-334). ``ids``/``rec`` are ``[R, S]`` neighbour ids and
    the pairs to record, with the pair-once rule already applied by the
    caller; ``row_ids`` maps rows to entity ids when the rows are a subset
    of the world (None: row r is entity r). Returns (world, dropped)."""
    pairs, count, dropped = compact_pairs(ids, rec, world.collision_pairs.shape[0], row_ids)
    return world.replace(collision_pairs=pairs, collision_pair_count=count), dropped


def compact_pairs(
    ids: torch.Tensor, rec: torch.Tensor, max_pairs: int,
    row_ids: "torch.Tensor | None" = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compaction core of :func:`record_collision_pairs`
    (physics.py:337-369): each row's first ``PER_ENTITY`` recorded slots,
    then a ``cumsum`` rank scatter into a dense ``[max_pairs, 2]`` table
    padded with -1. Returns (pairs, count, dropped); ``dropped`` counts the
    pairs lost to the per-row cap or to ``max_pairs``.

    The reference takes the per-row slots with ``lax.top_k`` on a 0/1 key,
    which returns equal values lower index first: the first recorded slots
    in order, then the first unrecorded ones. ``first_k_where`` is that
    selection as a stable sort (``torch.topk`` promises no order among
    ties)."""
    r, s = ids.shape
    total = torch.sum(rec, dtype=torch.int32)
    p = min(PER_ENTITY, s)
    sel = first_k_where(rec, p, dim=1)  # [R, p]
    flat_j = torch.gather(ids, 1, sel).reshape(-1)
    flat_rec = torch.gather(rec, 1, sel).reshape(-1)
    i_rows = (torch.arange(r, dtype=torch.int32, device=ids.device)
              if row_ids is None else row_ids.to(torch.int32))
    flat_i = i_rows[:, None].expand(r, p).reshape(-1)
    pairs = compact_rows(flat_rec, torch.stack([flat_i, flat_j], dim=1), max_pairs)
    count = torch.clamp(torch.sum(flat_rec, dtype=torch.int32), max=max_pairs)
    return pairs, count, total - count


def physics_step(
    world: World, cfg: EngineConfig, dt_ratio: float, solver_geom,
    nbr: Optional[NeighborLists] = None,
) -> Tuple[World, torch.Tensor]:
    """One physics frame (updateVerlet, physics_worker.js:145-233;
    physics.py:372-425): Verlet move, the substepped constraints, derived
    properties. Solver "auto", "grid" or "pallas" with a geometry runs the
    grid solver (``physics_grid.grid_constraints_resident``, with the bin
    and attribute caches when the world carries them); "neighbors", or no
    geometry (no collider radius), runs :func:`apply_constraints` over
    ``nbr`` and raises ``ValueError`` without it. Returns (world,
    solver_overflow), the overflow 0 on the neighbour-list path."""
    world = verlet_move(world, cfg, dt_ratio)
    if cfg.physics.solver in ("auto", "grid", "pallas") and solver_geom is not None:
        from .physics_grid import grid_constraints_resident

        world, _n_binned, overflow = grid_constraints_resident(world, cfg, solver_geom)
    else:
        if nbr is None:
            raise ValueError("neighbor-list solver requires neighbor lists "
                             "(cfg.physics.solver='neighbors')")
        world, _overlap = apply_constraints(world, nbr, cfg)
        overflow = torch.zeros((), dtype=torch.int32, device=world.device)
    return update_derived(world, cfg), overflow
