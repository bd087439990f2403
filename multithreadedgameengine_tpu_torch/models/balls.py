"""The balls demo — the port of ``multithreadedgameengine_tpu/models/balls.py``.

10,000 pooled balls under gravity with Verlet circle collisions, the
reference build's headline scene (BASELINE.md config 1). The spawn order of
the seeded stream is the reference's draw for draw (x, y, radius, colour per
ball), including the vectorized ``fast_spawn`` path at >= 50k balls, so the
two packages build identical worlds from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..behavior import EntityClass
from ..components import Collider, RigidBody, SpriteRenderer
from ..config import EngineConfig, make_config
from ..engine import Engine

# ball.js:77-87 — random tint palette
BALL_COLORS = (
    0xFF6B6B, 0x4ECDC4, 0xFFE66D, 0xA29BFE,
    0x95E1D3, 0xFECA57, 0x48DBFB, 0xFF9FF3,
)

BALL_PNG_SIZE = 14.0  # ball.js:65 — source sprite width in px


class Ball(EntityClass):
    """ball.js — components RigidBody, Collider, SpriteRenderer (:15)."""

    components = [RigidBody, Collider, SpriteRenderer]
    # ball.tick reads only the mouse, never its neighbour list (ball.js:114-132)
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        """ball.js:21-35."""
        return {
            "rigid_body.max_vel": 50.0,
            "rigid_body.max_acc": 2.0,
            "rigid_body.min_speed": 0.0,
            "rigid_body.friction": 0.01,
            "sprite.anchor_x": 0.5,
            "sprite.anchor_y": 0.5,
            "collider.visual_range": ctx.config.spatial.cell_size * 1.33,
        }

    @classmethod
    def on_spawned(cls, ctx, spawn_config):
        """ball.js:46-89, radius and tint drawn from the seeded stream."""
        radius = ctx.rng() * 20.0 + 10.0
        scale = (radius * 2.0) / BALL_PNG_SIZE
        color = BALL_COLORS[int(ctx.rng() * len(BALL_COLORS))]
        return {
            "x": spawn_config.get("x", 0.0),
            "y": spawn_config.get("y", 0.0),
            "rotation": 0.0,
            "vx": spawn_config.get("vx", 0.0),
            "vy": spawn_config.get("vy", 0.0),
            "rigid_body.ax": 0.0,
            "rigid_body.ay": 0.0,
            "collider.radius": radius,
            "sprite.scale_x": scale,
            "sprite.scale_y": scale,
            "sprite.alpha": 1.0,
            "sprite.tint": color,
            "sprite.base_tint": color,
        }

    @classmethod
    def on_spawned_batch(cls, ctx, spawn_arrays):
        """Vectorized on_spawned for Engine.spawn_batch: the same draws in
        the same per-ball order (radius, then colour)."""
        n = len(ctx.indices)
        draws = ctx.rng.draw(2 * n).reshape(n, 2)
        radius64 = draws[:, 0] * 20.0 + 10.0
        tint = np.asarray(BALL_COLORS, np.int64)[
            (draws[:, 1] * len(BALL_COLORS)).astype(np.int64)
        ]
        zero = np.zeros(n, np.float32)

        def cfg(key):
            v = spawn_arrays.get(key)
            return zero if v is None else np.asarray(v, np.float32)

        return {
            "x": cfg("x"), "y": cfg("y"), "rotation": zero,
            "vx": cfg("vx"), "vy": cfg("vy"),
            "rigid_body.ax": zero, "rigid_body.ay": zero,
            "collider.radius": radius64.astype(np.float32),
            "sprite.scale_x": ((radius64 * 2.0) / BALL_PNG_SIZE).astype(np.float32),
            "sprite.scale_y": ((radius64 * 2.0) / BALL_PNG_SIZE).astype(np.float32),
            "sprite.alpha": np.ones(n, np.float32),
            "sprite.tint": tint, "sprite.base_tint": tint,
        }

    @staticmethod
    def tick(ctx):
        """ball.js:114-132 — mouse repulsion and the 'm' key nudge. The
        physics zeroes ax/ay every frame, so the reference's early return
        leaves them 0; here that is a masked select."""
        dx = ctx.x - ctx.mouse_x
        dy = ctx.y - ctx.mouse_y
        dist2 = dx * dx + dy * dy
        near = dist2 <= 20000.0
        repel = ctx.mouse_down & near
        ax = torch.where(repel, dx * 0.2, ctx.ax)
        ay = torch.where(repel, dy * 0.2, ctx.ay)
        ax = torch.where(ctx.key("m"), -3.0, ax)
        return {"rigid_body.ax": ax, "rigid_body.ay": ay}


def balls_config(**overrides) -> EngineConfig:
    """The demo's operating point (demos/balls/index.html:97-140)."""
    base = dict(
        canvas_width=1600,
        canvas_height=600,
        world_width=9000.0,
        world_height=4000.0,
        spatial=dict(cell_size=50.0, max_neighbors=900, cell_capacity=32),
        physics=dict(
            sub_step_count=2,
            max_collision_pairs=1,
            verlet_damping=0.99,
            boundary_elasticity=0.0,
            collision_response_strength=0.8,
            gravity=(0.0, 0.5),
        ),
    )
    base.update(overrides)
    return make_config(**base)


def make_balls_engine(
    n_balls: int = 10_000,
    seed: int = 12345,
    spawn: bool = True,
    fast_spawn: bool | None = None,
    *,
    device="cuda",
    **overrides,
) -> Engine:
    """Build and init the balls scene on ``device`` (the card unless the
    caller asks for ``"cpu"``); spawns like
    index.html's spawnRandomBall loop (x, y ~ rng() * world extent,
    vx = vy = 0). ``fast_spawn`` (default: at >= 50k balls) consumes the
    same stream in the same per-ball order through one spawn_batch."""
    eng = Engine(balls_config(seed=seed, **overrides), device=device)
    eng.register_entity_class(Ball, n_balls)
    eng.init()
    if not spawn:
        return eng
    if fast_spawn is None:
        fast_spawn = n_balls >= 50_000
    if not fast_spawn:
        for _ in range(n_balls):
            eng.spawn(
                "Ball",
                x=eng.rng() * eng.config.world_width,
                y=eng.rng() * eng.config.world_height,
                vx=0.0,
                vy=0.0,
            )
        return eng
    w, h = eng.config.world_width, eng.config.world_height
    # one vectorized pull of the stream, same per-ball order as spawn():
    # x, y (call site), then radius, colour (on_spawned)
    draws = eng.rng.draw(4 * n_balls).reshape(n_balls, 4)
    xs = (draws[:, 0] * w).astype(np.float32)
    ys = (draws[:, 1] * h).astype(np.float32)
    radius64 = draws[:, 2] * 20.0 + 10.0
    tint = np.asarray(BALL_COLORS, np.int64)[
        (draws[:, 3] * len(BALL_COLORS)).astype(np.int64)
    ]
    scale = ((radius64 * 2.0) / BALL_PNG_SIZE).astype(np.float32)
    eng.spawn_batch(
        "Ball", n_balls, call_on_spawned=False,
        x=xs, y=ys, vx=0.0, vy=0.0, rotation=0.0,
        **{
            "rigid_body.ax": 0.0, "rigid_body.ay": 0.0,
            "collider.radius": radius64.astype(np.float32),
            "sprite.scale_x": scale, "sprite.scale_y": scale,
            "sprite.alpha": 1.0, "sprite.tint": tint,
            "sprite.base_tint": tint,
        },
    )
    return eng
