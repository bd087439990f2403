"""Component schemas: the SoA state of the world, as dataclasses of tensors.

PyTorch counterpart of ``multithreadedgameengine_tpu/components.py:59-225``.
Each component holds dense ``[N]`` tensors, one slot per entity, with the
same field names as the reference package: the built-ins Transform,
RigidBody, Collider, SpriteRenderer, MouseComponent, LightEmitter and
ShadowCaster (components.py:59-261; every world carries all seven), and
user components made by :func:`define_component` (:336-374). Two more
hold state that is not indexed by entity: the :class:`Particles` pool and
the :class:`ShadowSprites` buffer (:264-328).

dtypes are explicit: float32 for continuous state, int32 for ids and
counters, bool for flags. ``tint``/``base_tint``/``light_color`` (and a
user component's ``"u32"`` fields) are uint32 in the reference; torch's
uint32 supports few ops, so here they are **int64 holding the unsigned
32-bit value** (0 .. 2^32-1), which round-trips exactly.

Components are values: update one with ``replace(field=tensor)``, which
returns a new dataclass, as the reference's flax structs do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

F32 = torch.float32
I32 = torch.int32
B = torch.bool
#: dtype of the uint32 colour fields (see module docstring)
TINT = torch.int64


class Struct:
    """``replace`` and tensor mapping for the port's state dataclasses."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map_tensors(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with ``fn`` applied to every tensor leaf, recursively
        (through nested structs and dicts of them)."""

        def leaf(v):
            if isinstance(v, torch.Tensor):
                return fn(v)
            if isinstance(v, Struct):
                return v.map_tensors(fn)
            if isinstance(v, dict):
                return {k: leaf(c) for k, c in v.items()}
            return v

        return dataclasses.replace(
            self, **{f.name: leaf(getattr(self, f.name)) for f in dataclasses.fields(self)})


def _zeros(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=device)


def _make_zeros(cls, dtypes):
    """``cls.zeros(n, device)``: every field zero in its declared dtype."""

    def zeros(n: int, device) -> "Struct":
        return cls(**{name: _zeros(n, dt, device) for name, dt in dtypes.items()})

    cls.DTYPES = dict(dtypes)
    cls.zeros = staticmethod(zeros)
    return cls


@dataclasses.dataclass
class Transform(Struct):
    """Transform.js:8-17 — active, entityType, x, y, rotation."""

    active: torch.Tensor
    entity_type: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    rotation: torch.Tensor


_make_zeros(Transform, dict(
    active=B, entity_type=I32, x=F32, y=F32, rotation=F32,
))


@dataclasses.dataclass
class RigidBody(Struct):
    """RigidBody.js:9-47, every schema field."""

    active: torch.Tensor
    static: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    px: torch.Tensor  # Verlet previous position
    py: torch.Tensor
    angular_velocity: torch.Tensor
    angular_accel: torch.Tensor
    mass: torch.Tensor
    inv_mass: torch.Tensor
    inertia: torch.Tensor
    inv_inertia: torch.Tensor
    drag: torch.Tensor
    angular_drag: torch.Tensor
    max_vel: torch.Tensor
    max_acc: torch.Tensor
    min_speed: torch.Tensor
    friction: torch.Tensor
    velocity_angle: torch.Tensor
    speed: torch.Tensor
    collision_count: torch.Tensor


_make_zeros(RigidBody, {
    **{f.name: F32 for f in dataclasses.fields(RigidBody)},
    "active": B, "static": B, "collision_count": I32,
})


@dataclasses.dataclass
class Collider(Struct):
    """Collider.js:8-46. Only circles take part in physics."""

    active: torch.Tensor
    shape_type: torch.Tensor  # 0=circle, 1=box, 2=poly
    offset_x: torch.Tensor
    offset_y: torch.Tensor
    radius: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    is_trigger: torch.Tensor
    restitution: torch.Tensor
    collision_layer: torch.Tensor
    collision_mask: torch.Tensor
    aabb_min_x: torch.Tensor
    aabb_min_y: torch.Tensor
    aabb_max_x: torch.Tensor
    aabb_max_y: torch.Tensor
    visual_range: torch.Tensor


_make_zeros(Collider, {
    **{f.name: F32 for f in dataclasses.fields(Collider)},
    "active": B, "shape_type": I32, "is_trigger": B,
    "collision_layer": I32, "collision_mask": I32,
})


@dataclasses.dataclass
class SpriteRenderer(Struct):
    """SpriteRenderer.js:8-41 — render state written by logic."""

    active: torch.Tensor
    animation_state: torch.Tensor
    animation_frame: torch.Tensor
    animation_accum: torch.Tensor
    animation_speed: torch.Tensor
    is_animated: torch.Tensor
    spritesheet_id: torch.Tensor
    tint: torch.Tensor  # int64 holding a uint32
    base_tint: torch.Tensor  # int64 holding a uint32
    alpha: torch.Tensor
    scale_x: torch.Tensor
    scale_y: torch.Tensor
    anchor_x: torch.Tensor
    anchor_y: torch.Tensor
    z_offset: torch.Tensor
    blend_mode: torch.Tensor
    render_visible: torch.Tensor
    is_on_screen: torch.Tensor
    render_dirty: torch.Tensor
    screen_x: torch.Tensor
    screen_y: torch.Tensor


_make_zeros(SpriteRenderer, {
    **{f.name: F32 for f in dataclasses.fields(SpriteRenderer)},
    "active": B, "animation_state": I32, "animation_frame": I32,
    "is_animated": B, "spritesheet_id": I32, "tint": TINT, "base_tint": TINT,
    "blend_mode": I32, "render_visible": B, "is_on_screen": B,
    "render_dirty": B,
})


@dataclasses.dataclass
class MouseComponent(Struct):
    """MouseComponent.js:9-17 — the mouse is entity 0 (Mouse.js:30-104)."""

    button0_down: torch.Tensor
    button1_down: torch.Tensor
    button2_down: torch.Tensor
    is_present: torch.Tensor


_make_zeros(MouseComponent, {f.name: B for f in dataclasses.fields(MouseComponent)})


@dataclasses.dataclass
class LightEmitter(Struct):
    """LightEmitter.js:4-9."""

    active: torch.Tensor
    light_color: torch.Tensor  # int64 holding a uint32
    light_intensity: torch.Tensor
    height: torch.Tensor


_make_zeros(LightEmitter, dict(active=B, light_color=TINT, light_intensity=F32, height=F32))


@dataclasses.dataclass
class ShadowCaster(Struct):
    """ShadowCaster.js:12-25, the per-entity half: shadow parameters."""

    active: torch.Tensor
    shadow_radius: torch.Tensor
    height: torch.Tensor  # caster height: taller entities cast longer shadows


_make_zeros(ShadowCaster, dict(active=B, shadow_radius=F32, height=F32))


@dataclasses.dataclass
class ShadowSprites(Struct):
    """The shadow-sprite output buffer (components.py:264-287; the
    shadowSpriteData analog, gameEngine.js:618-633): ``max_shadow_casting_lights
    x max_shadows_per_light`` slots, written by ``ops.lighting`` each frame
    for the renderer (pixi_worker.js:1578-1611)."""

    active: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    rotation: torch.Tensor
    scale_x: torch.Tensor
    scale_y: torch.Tensor
    alpha: torch.Tensor
    radius: torch.Tensor


_make_zeros(ShadowSprites, {
    **{f.name: F32 for f in dataclasses.fields(ShadowSprites)}, "active": B,
})


@dataclasses.dataclass
class Particles(Struct):
    """The particle pool, ParticleComponent.js:9-51 (components.py:290-328):
    ``[max_particles]`` slots of its own, not indexed by entity
    (gameEngine.js:597-615)."""

    active: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor  # negative is up; the floor is 0
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    lifespan: torch.Tensor  # ms
    current_life: torch.Tensor  # ms
    gravity: torch.Tensor
    scale: torch.Tensor
    alpha: torch.Tensor
    tint: torch.Tensor  # int64 holding a uint32
    base_tint: torch.Tensor  # int64 holding a uint32
    texture_id: torch.Tensor
    fade_on_the_floor: torch.Tensor  # ms of fade
    time_on_floor: torch.Tensor  # ms
    initial_alpha: torch.Tensor
    stay_on_the_floor: torch.Tensor
    is_on_screen: torch.Tensor


_make_zeros(Particles, {
    **{f.name: F32 for f in dataclasses.fields(Particles)},
    "active": B, "tint": TINT, "base_tint": TINT, "texture_id": I32,
    "stay_on_the_floor": B, "is_on_screen": B,
})


#: ``define_component`` dtype names (the reference's table, components.py:
#: 336-341), with uint32 held as int64
COMPONENT_DTYPES = {"f32": F32, "i32": I32, "u32": TINT, "bool": B}


def define_component(name: str, schema: Dict[str, str]):
    """A user component type from a ``{field: dtype}`` schema, dtype one of
    ``'f32' | 'i32' | 'u32' | 'bool'`` (components.py:344-374): a dataclass
    of ``[N]`` tensors with ``zeros(n, device)``, used in an entity class's
    ``components`` like the built-ins. The engine mounts it in
    ``world.custom`` under its snake-case name."""
    for f_name, d in schema.items():
        if d not in COMPONENT_DTYPES:
            raise ValueError(f"{name}.{f_name}: unknown dtype {d!r}")
    cls = dataclasses.make_dataclass(name, [(f, torch.Tensor) for f in schema], bases=(Struct,))
    _make_zeros(cls, {f: COMPONENT_DTYPES[d] for f, d in schema.items()})
    cls.SCHEMA = dict(schema)
    cls.__doc__ = f"User component {name} ({schema})"
    return cls


# Built-in components present in every World (dense allocation), keyed by
# their World attribute name.
BUILTIN_COMPONENTS = {
    "transform": Transform,
    "rigid_body": RigidBody,
    "collider": Collider,
    "sprite": SpriteRenderer,
    "mouse": MouseComponent,
    "light": LightEmitter,
    "shadow": ShadowCaster,
}
