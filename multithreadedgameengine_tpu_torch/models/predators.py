"""Predator/prey ecosystem — the port of
``multithreadedgameengine_tpu/models/predators.py`` (demos/predators/).

15,000 Prey, 8 Predators, 5 TallLights and the mouse over the spatial hash,
with the LPC character sheets' walk/run/idle x 4-direction animation state
machine: BASELINE config 4, the reference's operating point
(demos/predators/index.html:304-380: world 5000 x 2000, cell 128,
``max_neighbors`` 1500, ``cell_capacity`` 64, one substep, seed 123456, a
50,000-particle pool with decals, lighting with shadows).

Prey and Predator are the port's batched Boid (``models/boids.py``) with
their own neighbour hooks. Prey's tick is one ``ops.cuda_kernels.prey_tick``
(the boid tick kernel with the flee hook on the card, its plain version on
the CPU); Predator's reduces the ``[count, S]`` flocking intermediates of
:class:`~.boids.FlockAux` along the slots. The class attributes
``ANIM_TABLE`` hold each class's ``[3 states, 4 directions]`` animation
table (set by :func:`make_predators_engine` on the engine's device, as the
reference sets them; a tick on another device copies it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assets import LPC_ANIMATIONS
from ..behavior import EntityClass, TickCtx
from ..components import LightEmitter, define_component
from ..config import EngineConfig, make_config
from ..engine import Engine
from ..ops.cuda_kernels import prey_tick
from ..ops.physics import _sqrt
from ..utils import direction_from_angle
from .boids import (
    Boid,
    avoid_mouse_force,
    flocking_forces,
    keep_within_bounds_force,
    tick_args,
)

# demos/predators/PreyBehavior.js / PredatorBehavior.js custom components
PreyBehavior = define_component("PreyBehavior", dict(predator_avoid_factor="f32", life="f32"))
PredatorBehavior = define_component("PredatorBehavior", dict(hunt_factor="f32"))

CIVIL_SHEETS = tuple(f"civil{i}" for i in range(1, 8))

# animation state ids of the [state, direction] lookup table
STATE_IDLE, STATE_WALK, STATE_RUN = 0, 1, 2


def build_anim_table(sprites, sheet_name: str) -> torch.Tensor:
    """[3 states, 4 directions] -> the sheet's animation index, int32 on
    the host. All civil sheets share the LPC animation order, so one table
    serves every sheet."""
    sheet = sprites.sheet(sheet_name)
    return torch.tensor(
        [[sheet.animation_index(f"{prefix}_{d}") for d in ("up", "right", "down", "left")]
         for prefix in ("idle", "walk", "run")],
        dtype=torch.int32)


def _animation_updates(ctx: TickCtx, anim_table: torch.Tensor, move_thresh: float,
                       run_thresh: float, speed_factor: float):
    """The walk/run/idle x 4-direction state machine (prey.js:196-224,
    predator.js:223-255). Facing comes from velocityAngle, which the physics
    freezes below minSpeedForRotation: the reference's 'lastDirection'
    without per-entity state."""
    speed = ctx.speed
    direction = direction_from_angle(ctx.velocity_angle)
    moving = speed > move_thresh
    state = torch.where(moving, torch.where(speed > run_thresh, STATE_RUN, STATE_WALK),
                        STATE_IDLE)
    table = anim_table.to(speed.device)
    anim = table[state.to(torch.int64), direction.to(torch.int64)]
    old_anim = ctx.field("sprite.animation_state")
    old_speed = ctx.field("sprite.animation_speed")
    new_speed = torch.where(moving, speed * speed_factor, old_speed)
    dirty = ctx.field("sprite.render_dirty") | (anim != old_anim) | (new_speed != old_speed)
    return {
        "sprite.animation_state": anim,
        "sprite.animation_speed": new_speed,
        "sprite.render_dirty": dirty,
    }


class Prey(Boid):
    """prey.js: flees predators, with the LPC animation state machine."""

    components = [*Boid.components, PreyBehavior]

    # set by the scene builder after sheet registration
    ANIM_TABLE = None

    @classmethod
    def setup(cls, ctx):
        """prey.js:25-61: per-instance randomized physics and perception;
        each slot draws maxVel, maxAcc, visualRange from the seeded stream
        in instance order (the reference runs setup() once per instance):
        one ``rng.draw`` of three draws an instance, the numbers ``3 *
        count`` calls of ``rng()`` give."""
        d = ctx.rng.draw(3 * ctx.count).reshape(ctx.count, 3)
        return {
            "rigid_body.max_vel": (1.5 + d[:, 0] * 2.0).astype(np.float32),
            "rigid_body.max_acc": (0.07 + d[:, 1] * 0.1).astype(np.float32),
            "rigid_body.min_speed": 0.0,
            "rigid_body.friction": 0.05,
            "collider.radius": 10.0,
            "collider.visual_range": (60.0 + d[:, 2] * 100.0).astype(np.float32),
            "sprite.animation_speed": 0.15,
            "sprite.anchor_x": 0.5,
            "sprite.anchor_y": 1.0,
            "prey_behavior.predator_avoid_factor": 10.0,
            "prey_behavior.life": 1.0,
            "flocking.protected_range": 12.5,  # radius * 1.25
            "flocking.centering_factor": 0.0005,
            "flocking.avoid_factor": 6.0,
            "flocking.matching_factor": 0.05,
            "flocking.turn_factor": 0.001,
            "flocking.margin": 20.0,
        }

    @classmethod
    def on_spawned(cls, ctx, spawn_config):
        """prey.js:88-106: a random civil sheet, a random scale, the radius
        matched to the scaled size, the shadow matched to the collider."""
        out = Boid.on_spawned.__func__(cls, ctx, spawn_config)
        out.pop("sprite.spritesheet_id", None)
        out.pop("sprite.animation_state", None)
        if ctx.sprites is not None:
            sheet = CIVIL_SHEETS[int(ctx.rng() * len(CIVIL_SHEETS))]
            out["sprite.spritesheet_id"] = ctx.sprites.sheet_id(sheet)
            out["sprite.animation_state"] = ctx.sprites.animation_index(sheet, "idle_down")
            out["sprite.is_animated"] = True
            out["sprite.animation_speed"] = 0.15
        scale = ctx.rng() * 0.3 + 0.85
        radius = 10.0 * scale**2
        out.update({
            "sprite.scale_x": (1 + scale) * 0.5,
            "sprite.scale_y": scale,
            "collider.radius": radius,
            "shadow.shadow_radius": radius,  # prey.js:101
            "shadow.height": radius * 5.0,  # prey.js:102
            "prey_behavior.life": 1.0,
        })
        return out

    @staticmethod
    def tick(ctx: TickCtx):
        """prey.js:120-189: flocking, fleeing predators (1/d^2 panic), the
        mouse and the bounds as one ``ops.cuda_kernels.prey_tick`` (one
        kernel on the card, its plain version on the CPU), then the
        animation."""
        ax, ay = prey_tick(*tick_args(ctx), ctx.field("prey_behavior.predator_avoid_factor"),
                           Predator.entity_type)
        out = {"rigid_body.ax": ax, "rigid_body.ay": ay}
        # prey thresholds: walk > 0.1, run > 2, animation speed = speed * 0.15
        out.update(_animation_updates(ctx, Prey.ANIM_TABLE, 0.1, 2.0, 0.15))
        return out


class Predator(Boid):
    """predator.js: hunts the closest prey; blood particles on contact (the
    onCollisionStay emitter, predator.js:94-125), which fires with
    ``logic.collision_events`` on."""

    components = [*Boid.components, PredatorBehavior]

    ANIM_TABLE = None

    @classmethod
    def setup(cls, ctx):
        """predator.js:32-67."""
        return {
            "rigid_body.max_vel": 20.0,
            "rigid_body.max_acc": 1.0,
            "rigid_body.min_speed": 0.0,
            "rigid_body.friction": 0.05,
            "sprite.animation_speed": 0.15,
            "collider.visual_range": 250.0,
            "collider.radius": 10.0,
            "predator_behavior.hunt_factor": 0.2,
            "flocking.protected_range": 0.0,
            "flocking.centering_factor": 0.0,
            "flocking.avoid_factor": 0.0,
            "flocking.matching_factor": 0.0,
            "flocking.turn_factor": 0.1,
            "flocking.margin": 20.0,
            "sprite.anchor_x": 0.5,
            "sprite.anchor_y": 1.0,
        }

    @staticmethod
    def on_collision_stay_batch(ctx, me, other):
        """Every predator-prey contact of a frame as one ``emit_batch`` of
        blood (predator.js:94-125, the reference's batched hook)."""
        types = ctx.entity_type.take(other)
        sel = types == Prey.entity_type
        if not sel.any():
            return
        prey = np.asarray(other)[sel]
        ctx.emitter.emit_batch(x=ctx.x.take(prey), y=ctx.y.take(prey), **BLOOD)

    @staticmethod
    def on_collision_stay(ctx, me, other):
        """predator.js:94-125: a blood burst on sustained prey contact."""
        if ctx.type_of(other) != Prey.entity_type:
            return
        ctx.emitter.emit(x=float(ctx.x[other]), y=float(ctx.y[other]), **BLOOD)

    @classmethod
    def on_spawned(cls, ctx, spawn_config):
        """predator.js:74-92: 3x scale, radius 30, the civil3 sheet."""
        out = Boid.on_spawned.__func__(cls, ctx, spawn_config)
        out.pop("sprite.spritesheet_id", None)
        out.pop("sprite.animation_state", None)
        scale = 3.0
        radius = 10.0 * scale
        out.update({
            "sprite.scale_x": scale,
            "sprite.scale_y": scale,
            "collider.radius": radius,
            "shadow.shadow_radius": radius,  # predator.js:85
            "shadow.height": radius * 5.0,  # predator.js:86
        })
        if ctx.sprites is not None:
            out["sprite.spritesheet_id"] = ctx.sprites.sheet_id("civil3")
            out["sprite.animation_state"] = ctx.sprites.animation_index("civil3", "idle_down")
            out["sprite.is_animated"] = True
            out["sprite.animation_speed"] = 0.15
        return out

    @staticmethod
    def tick(ctx: TickCtx):
        """predator.js:139-216: flocking, hunting the closest prey, the
        mouse, the bounds and the animation."""
        fx, fy, aux = flocking_forces(ctx)
        # processNeighbor hook: the closest prey (predator.js:172-186); the
        # first slot of the smallest d^2 in scan order, as jnp.argmin takes
        is_prey = aux.hook_mask & (aux.neighbor_type == Prey.entity_type)
        d2m = torch.where(is_prey, aux.d2, torch.inf)
        closest = torch.argmin(d2m, dim=1, keepdim=True)
        found = torch.isfinite(torch.gather(d2m, 1, closest))[:, 0]
        dist = _sqrt(torch.where(found, torch.gather(aux.d2, 1, closest)[:, 0], 1.0))
        hunt = ctx.field("predator_behavior.hunt_factor") * ctx.dt_ratio
        safe = found & (dist > 0)
        inv = torch.where(dist > 0, dist, 1.0)
        fx = fx + torch.where(safe, (torch.gather(aux.dx, 1, closest)[:, 0] / inv) * hunt, 0.0)
        fy = fy + torch.where(safe, (torch.gather(aux.dy, 1, closest)[:, 0] / inv) * hunt, 0.0)

        mx, my = avoid_mouse_force(ctx)
        bx, by = keep_within_bounds_force(ctx)
        out = {
            "rigid_body.ax": ctx.ax + fx + mx + bx,
            "rigid_body.ay": ctx.ay + fy + my + by,
        }
        # predator thresholds: walk > 0.5, run > 2.5, animation speed = speed * 0.08
        out.update(_animation_updates(ctx, Predator.ANIM_TABLE, 0.5, 2.5, 0.08))
        return out


#: the blood burst of Predator's collision hooks (predator.js:94-125)
BLOOD = dict(
    count={"min": 4, "max": 8},
    texture="blood",
    z=-30.0,
    angle_xy={"min": 0.0, "max": 360.0},
    speed={"min": 0.7, "max": 1.66},
    vz={"min": -4.0, "max": 0.0},
    lifespan=6000.0,
    gravity=0.15,
    scale={"min": 0.1, "max": 0.2},
    alpha={"min": 0.4, "max": 0.9},
    tint={"min": 0xAAAAAA, "max": 0xFFFFFF},
    stay_on_the_floor=True,
)


class TallLight(EntityClass):
    """tallLight.js: a static light pole: static rigid body, radius-17
    collider, a random light colour, intensity 20000, height 110."""

    components = [*Boid.components[:3], LightEmitter]  # RigidBody, Collider, SpriteRenderer

    @classmethod
    def setup(cls, ctx):
        colors = []
        for _ in range(ctx.count):
            # randomColor({min: 0xff0000, max: 0xffffff}): a per-channel
            # lerp by one t draw (utils.js:65-93), on the seeded stream
            t = ctx.rng()
            r = round(0xFF + t * (0xFF - 0xFF))
            g = round(0x00 + t * (0xFF - 0x00))
            b = round(0x00 + t * (0xFF - 0x00))
            colors.append((r << 16) | (g << 8) | b)
        out = {
            "rigid_body.max_vel": 0.0,
            "rigid_body.max_acc": 0.0,
            "rigid_body.static": True,
            "collider.radius": 17.0,
            "collider.visual_range": 200.0,
            "light.light_color": np.asarray(colors, np.int64),
            "light.height": 110.0,
            "light.light_intensity": 20000.0,
            "light.active": True,
        }
        if ctx.sprites is not None and "tallLight" in ctx.sprites.textures:
            out["sprite.spritesheet_id"] = 0
            out["sprite.animation_state"] = ctx.sprites.texture_id("tallLight")
        return out

    @classmethod
    def on_spawned(cls, ctx, spawn_config):
        return {
            "x": spawn_config.get("x", 0.0),
            "y": spawn_config.get("y", 0.0),
        }


def predators_config(**overrides) -> EngineConfig:
    """The operating point of demos/predators/index.html:304-380."""
    base = dict(
        canvas_width=1600,
        canvas_height=900,
        world_width=5000.0,
        world_height=2000.0,
        seed=123456,
        spatial=dict(cell_size=128.0, max_neighbors=1500, cell_capacity=64),
        physics=dict(
            sub_step_count=1,
            gravity=(0.0, 0.0),
            verlet_damping=0.99,
            collision_response_strength=0.9,
            boundary_elasticity=0.0,
        ),
        particle=dict(
            max_particles=50_000, decals=True,
            decals_tile_size=256, decals_resolution=0.5,
        ),
        lighting=dict(
            enabled=True, shadows_enabled=True,
            lighting_ambient=0.0, max_lights=100,
        ),
    )
    base.update(overrides)
    return make_config(**base)


def register_demo_assets(eng: Engine) -> None:
    """The demo's imageUrls and spritesheets (index.html:381-415)."""
    for name in CIVIL_SHEETS:
        eng.sprites.register_spritesheet(name, LPC_ANIMATIONS)
    eng.sprites.register_texture("bunny")
    eng.sprites.register_texture("blood")
    eng.sprites.register_texture("tallLight")
    eng.sprites.register_texture("_lightGradient")


def make_predators_engine(
    n_prey: int = 15_000,
    n_predators: int = 8,
    n_lights: int = 5,
    spawn: bool = True,
    *,
    device="cuda",
    **overrides,
) -> Engine:
    """Build and init the predators scene on ``device`` (the card unless the
    caller asks for ``"cpu"``), spawning as index.html:452-477 does: every
    class at rng() * world extent, one ``spawn`` at a time."""
    eng = Engine(predators_config(**overrides), device=device)
    register_demo_assets(eng)
    eng.register_entity_class(Prey, n_prey)
    eng.register_entity_class(Predator, n_predators)
    eng.register_entity_class(TallLight, n_lights)
    # on the engine's device: a host table would be copied to the card, and
    # waited for, every frame
    Prey.ANIM_TABLE = build_anim_table(eng.sprites, "civil1").to(eng.device)
    Predator.ANIM_TABLE = build_anim_table(eng.sprites, "civil3").to(eng.device)
    eng.init()
    if spawn:
        w, h = eng.config.world_width, eng.config.world_height
        for name, count in (("Prey", n_prey), ("Predator", n_predators), ("TallLight", n_lights)):
            for _ in range(count):
                eng.spawn(name, x=eng.rng() * w, y=eng.rng() * h)
    return eng
