"""Verlet physics: integrate, substepped constraints, derived properties.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/physics.py``
(physics.py:49-130, 285-424): ``verlet_move`` (moveBallsVerlet), the one-axis
``_boundary`` clamp and bounce, ``update_derived`` (speed and velocity angle)
and the grid branch of ``physics_step``. The constraint pass itself is the
grid solver in ``ops/physics_grid.py``; the neighbour-list solver
(``solver="neighbors"``) is not ported yet and is refused.

Jacobi, not Gauss-Seidel, exactly as the reference package: every pair of a
substep reads the substep's starting positions.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..state import World

_U32 = 0xFFFFFFFF


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. torch's CPU
    float32 ``sqrt`` is not correctly rounded in every build (the MKL path
    is off by one ulp on ~0.7% of inputs), while CUDA's ``sqrtf`` is; a
    float64 square root of a float32 value, rounded once to float32, is the
    correctly rounded result, so the CPU, the card and the CUDA kernel agree
    bit for bit."""
    return torch.sqrt(t.double()).to(t.dtype)


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


def update_derived(world: World, cfg: EngineConfig) -> World:
    """speed and velocityAngle (updateDerivedProperties,
    physics_worker.js:575-604)."""
    t, rb = world.transform, world.rigid_body
    on = t.active & rb.active
    speed = _sqrt(rb.vx * rb.vx + rb.vy * rb.vy)
    angle = torch.atan2(rb.vy, rb.vx) + float(np.float32(math.pi / 2))
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


def physics_step(
    world: World, cfg: EngineConfig, dt_ratio: float, solver_geom
) -> Tuple[World, torch.Tensor]:
    """One physics frame on the grid solver (updateVerlet,
    physics_worker.js:145-233): Verlet move, the substepped constraints of
    ``physics_grid.grid_constraints_resident`` (with the bin and attribute
    caches when the world carries them), derived properties.
    Returns (world, solver_overflow)."""
    from .physics_grid import grid_constraints_resident

    world = verlet_move(world, cfg, dt_ratio)
    world, _n_binned, overflow = grid_constraints_resident(world, cfg, solver_geom)
    return update_derived(world, cfg), overflow
