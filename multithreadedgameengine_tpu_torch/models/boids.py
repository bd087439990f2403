"""Boid flocking — the port of ``multithreadedgameengine_tpu/models/boids.py``
(demos/predators/boid.js).

The reference's per-entity neighbour loop (boid.js:137-240) is a set of
masked reductions over the neighbour slots. Where the reference writes them
per entity under ``vmap``, the port writes them for the class slice: the
neighbour columns are ``[count, S]``, every reduction runs along dim 1, and
an entity's own fields meet them as ``[count, 1]``. :func:`flocking_forces`
returns a :class:`FlockAux` with the per-slot intermediates so subclasses
(``models.predators``' Prey and Predator) run their own reductions over the
same pass. ``Boid.tick`` keeps none: it is one ``ops.cuda_kernels.boid_tick``,
which on the card reads each live neighbour slot once.

BASELINE config 3 is this class alone: ``benchmarks/run_ladder.py:166-188``
builds the scene inline (15,000 boids in 5000 x 2000), as does
``chip_smoke.py``'s ``[boids_15k]`` phase.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..behavior import EntityClass, TickCtx
from ..components import (
    Collider,
    RigidBody,
    ShadowCaster,
    SpriteRenderer,
    define_component,
)
from ..ops.cuda_kernels import BOID_MOUSE, boid_tick

#: the Flocking component's fields, in the order ``boid_tick`` takes them
FLOCKING_FIELDS = ("protected_range", "centering_factor", "avoid_factor",
                   "matching_factor", "turn_factor", "margin")

# demos/predators/Flocking.js:353-363: a user component
Flocking = define_component("Flocking", {f: "f32" for f in FLOCKING_FIELDS})

MOUSE_ENTITY_TYPE = BOID_MOUSE  # Mouse registers first (gameEngine.js:278-281)
MOUSE_ENTITY_INDEX = BOID_MOUSE


@dataclass
class FlockAux:
    """Per-slot intermediates shared with subclass hooks (the
    ``neighborContext`` analog, boid.js:169-217), each ``[count, S]``."""

    hook_mask: Any  # bool: neighbours passed to processNeighbor (non-mouse,
    #                 outside the protected range; boid.js:192-196)
    neighbor_type: Any  # int32
    dx: Any  # f32: neighbor.x - my.x
    dy: Any
    d2: Any  # f32: the spatial pass's squared distance


def flocking_forces(ctx: TickCtx) -> tuple:
    """applyFlockingBehaviors (boid.js:137-240): returns (ax, ay, aux), the
    cohesion + alignment + separation accelerations ``[count]``. The
    per-neighbour reads are payload channels (``Boid.neighbor_fields``)."""

    def fl(name):
        return ctx.field(f"flocking.{name}")

    live = ctx.neighbor_mask
    ntype = ctx.neighbor_col("transform.entity_type").to(torch.int32)
    not_mouse = live & (ntype != MOUSE_ENTITY_TYPE)  # boid.js:180 skips the mouse

    nx = ctx.neighbor_col("transform.x")
    ny = ctx.neighbor_col("transform.y")
    nvx = ctx.neighbor_col("rigid_body.vx")
    nvy = ctx.neighbor_col("rigid_body.vy")
    x, y = ctx.x, ctx.y
    dx = nx - x[:, None]
    dy = ny - y[:, None]
    d2 = ctx.neighbor_d2  # the spatial worker's d^2 (boid.js:185)

    pr = fl("protected_range")
    prot2 = (pr * pr)[:, None]
    sep = not_mouse & (d2 < prot2) & (d2 > 0)
    # separation accumulators (all types; boid.js:192-196)
    inv_d2 = torch.where(sep, 1.0 / torch.where(d2 > 0, d2, 1.0), 0.0)
    separate_x = torch.sum(torch.where(sep, -dx * inv_d2, 0.0), dim=1)
    separate_y = torch.sum(torch.where(sep, -dy * inv_d2, 0.0), dim=1)

    # the `continue` in the separation branch keeps those neighbours out of
    # cohesion/alignment and out of the subclass hook
    rest = not_mouse & ~sep
    same = rest & (ntype == ctx.entity_type[:, None])
    same_n = torch.sum(same, dim=1, dtype=torch.int32)

    center_x = torch.sum(torch.where(same, nx, 0.0), dim=1)
    center_y = torch.sum(torch.where(same, ny, 0.0), dim=1)
    avg_vx = torch.sum(torch.where(same, nvx, 0.0), dim=1)
    avg_vy = torch.sum(torch.where(same, nvy, 0.0), dim=1)

    dt = ctx.dt_ratio
    has_same = same_n > 0
    inv_n = torch.where(has_same, 1.0 / torch.clamp(same_n, min=1).to(torch.float32), 0.0)
    # cohesion (boid.js:221-226)
    ax = torch.where(has_same, (center_x * inv_n - x) * fl("centering_factor") * dt, 0.0)
    ay = torch.where(has_same, (center_y * inv_n - y) * fl("centering_factor") * dt, 0.0)
    # alignment (boid.js:228-231)
    ax = ax + torch.where(has_same, (avg_vx * inv_n - ctx.vx) * fl("matching_factor") * dt, 0.0)
    ay = ay + torch.where(has_same, (avg_vy * inv_n - ctx.vy) * fl("matching_factor") * dt, 0.0)
    # separation (boid.js:234-236)
    ax = ax + separate_x * fl("avoid_factor") * dt
    ay = ay + separate_y * fl("avoid_factor") * dt

    return ax, ay, FlockAux(hook_mask=rest, neighbor_type=ntype, dx=dx, dy=dy, d2=d2)


def avoid_mouse_force(ctx: TickCtx) -> tuple:
    """avoidMouse (boid.js:281-316): repel from the mouse when a button is
    down and the mouse (entity 0) is in this boid's neighbour list, with the
    spatial pass's d^2. Reads the mouse's position from ``ctx.world`` row 0,
    as the reference does."""
    slot = ctx.neighbor_mask & (ctx.neighbor_ids == MOUSE_ENTITY_INDEX)
    present = torch.any(slot, dim=1)
    d2 = torch.sum(torch.where(slot, ctx.neighbor_d2, 0.0), dim=1)
    engaged = ctx.mouse_down & (ctx.inputs.mouse_x != 0) & present & (d2 > 0)

    w = ctx.world
    dx = w.transform.x[MOUSE_ENTITY_INDEX] - ctx.x
    dy = w.transform.y[MOUSE_ENTITY_INDEX] - ctx.y
    strength = 1000.0
    safe_d2 = torch.where(d2 > 0, d2, 1.0)
    ax = torch.where(engaged, -(dx / safe_d2) * strength * ctx.dt_ratio, 0.0)
    ay = torch.where(engaged, -(dy / safe_d2) * strength * ctx.dt_ratio, 0.0)
    return ax, ay


def keep_within_bounds_force(ctx: TickCtx) -> tuple:
    """keepWithinBounds (boid.js:322-341)."""
    margin = ctx.field("flocking.margin")
    turn = ctx.field("flocking.turn_factor") * ctx.dt_ratio
    ww = ctx.config.world_width
    wh = ctx.config.world_height
    x, y = ctx.x, ctx.y
    ax = torch.where(x < margin, turn, 0.0) - torch.where(x > ww - margin, turn, 0.0)
    ay = torch.where(y < margin, turn, 0.0) - torch.where(y > wh - margin, turn, 0.0)
    return ax, ay


class Boid(EntityClass):
    """boid.js — the base flocking entity."""

    components = [RigidBody, Collider, SpriteRenderer, Flocking, ShadowCaster]
    # per-neighbour fields the flocking pass reads: they ride the neighbour
    # table as payload channels (x/y are always channels 1-2)
    neighbor_fields = (
        "transform.x", "transform.y",
        "rigid_body.vx", "rigid_body.vy", "transform.entity_type",
    )

    @classmethod
    def setup(cls, ctx):
        """boid.js:41-73 (per-type constants; radius 10, visualRange 100)."""
        return {
            "rigid_body.max_vel": 10.0,
            "rigid_body.max_acc": 0.2,
            "rigid_body.min_speed": 0.0,
            "rigid_body.friction": 0.01,
            "collider.radius": 10.0,
            "collider.visual_range": 100.0,
            "sprite.scale_x": 1.0,
            "sprite.scale_y": 1.0,
            "sprite.anchor_x": 0.5,
            "sprite.anchor_y": 0.5,
            "flocking.protected_range": 20.0,  # radius * 2
            "flocking.centering_factor": 0.001,
            "flocking.avoid_factor": 0.3,
            "flocking.matching_factor": 0.1,
            "flocking.turn_factor": 0.01,
            "flocking.margin": 20.0,
            "shadow.shadow_radius": 10.0,
        }

    @classmethod
    def on_spawned(cls, ctx, spawn_config):
        """boid.js:83-101: position defaults to rng() * world extent."""
        cfg = ctx.config
        out = {
            "x": spawn_config.get("x", ctx.rng() * cfg.world_width),
            "y": spawn_config.get("y", ctx.rng() * cfg.world_height),
            "rotation": 0.0,
            "vx": spawn_config.get("vx", 0.0),
            "vy": spawn_config.get("vy", 0.0),
            "rigid_body.ax": 0.0,
            "rigid_body.ay": 0.0,
        }
        if ctx.sprites is not None and "bunny" in ctx.sprites.textures:
            # setSprite("bunny"): a static texture, spritesheet 0 with the
            # texture id in animation_state (the registry's convention)
            out["sprite.spritesheet_id"] = 0
            out["sprite.animation_state"] = ctx.sprites.texture_id("bunny")
        return out

    @staticmethod
    def tick(ctx: TickCtx):
        """boid.js:116-125: ``ax`` plus :func:`flocking_forces`,
        :func:`avoid_mouse_force` and :func:`keep_within_bounds_force`, as
        one ``ops.cuda_kernels.boid_tick`` (one kernel on the card, its
        plain version on the CPU). The neighbour columns are payload
        channels or gathers; the type column is f32 as the payload holds it."""
        cols = [ctx.neighbor_col(p) for p in Boid.neighbor_fields]
        cols[4] = cols[4].to(torch.float32)
        w = ctx.world
        ax, ay = boid_tick(
            ctx.neighbor_ids, ctx.neighbor_d2, cols,
            (ctx.x, ctx.y, ctx.vx, ctx.vy, ctx.ax, ctx.ay, ctx.entity_type),
            [ctx.field(f"flocking.{f}") for f in FLOCKING_FIELDS],
            (ctx.mouse_down, ctx.inputs.mouse_x, w.transform.x[MOUSE_ENTITY_INDEX],
             w.transform.y[MOUSE_ENTITY_INDEX]),
            ctx.dt_ratio, (ctx.config.world_width, ctx.config.world_height))
        return {"rigid_body.ax": ax, "rigid_body.ay": ay}
