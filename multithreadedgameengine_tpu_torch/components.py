"""Component schemas: the SoA state of the world, as dataclasses of tensors.

PyTorch counterpart of ``multithreadedgameengine_tpu/components.py:59-225``.
Each component holds dense ``[N]`` tensors, one slot per entity, with the
same field names as the reference package. Built-in components ported so
far: Transform, RigidBody, Collider, SpriteRenderer and MouseComponent
(LightEmitter, ShadowCaster, Particles and ``define_component`` come with
the lighting and particle slices).

dtypes are explicit: float32 for continuous state, int32 for ids and
counters, bool for flags. ``tint``/``base_tint`` are uint32 in the reference;
torch's uint32 supports few ops, so here they are **int64 holding the
unsigned 32-bit value** (0 .. 2^32-1), which round-trips exactly.

Components are values: update one with ``replace(field=tensor)``, which
returns a new dataclass, as the reference's flax structs do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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
        """A copy with ``fn`` applied to every tensor leaf, recursively."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = fn(v)
            elif isinstance(v, Struct):
                v = v.map_tensors(fn)
            out[f.name] = v
        return dataclasses.replace(self, **out)


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


# Built-in components present in every World (dense allocation), keyed by
# their World attribute name.
BUILTIN_COMPONENTS = {
    "transform": Transform,
    "rigid_body": RigidBody,
    "collider": Collider,
    "sprite": SpriteRenderer,
    "mouse": MouseComponent,
}
