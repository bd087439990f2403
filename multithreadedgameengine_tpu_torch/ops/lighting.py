"""Lighting data extraction: shadow sprites, light uniforms, entity lighting.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/lighting.py``:

 - :func:`shadow_sprites`, the particle worker's updateShadowSprites
   (particle_worker.js:861-1004): for each of the first
   ``max_shadow_casting_lights`` active on-screen lights (entity-index
   order), walk its neighbour list and emit up to ``max_shadows_per_light``
   shadow sprites for on-screen shadow casters, at the caster's feet offset
   away from the light, longer with distance and caster height, alpha =
   intensity / (2 d^2); :func:`shadow_sprites_by_class` does the same over
   per-class lists;
 - :func:`light_uniforms`, the first ``max_lights`` active lights for the
   renderer's lighting shader (pixi_worker.js:1256-1312);
 - :func:`entity_light_levels`, per-entity brightness from the neighbour
   lights (utils.js:439-470).

The port's neighbour lists keep their slots in scan order with -1 gaps
where the reference compacts them; every selection here ranks in scan
order, so the kept casters and their order are the reference's. A shadow
slot that is not ``active`` holds whatever the gather put there (the
reference's slots hold other candidates than the port's): only active slots
carry meaning.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..components import ShadowSprites, Struct
from ..config import EngineConfig
from ..state import World
from ..utils import light_attenuation
from .particles import first_k_where
from .physics import _atan2, _sqrt
from .spatial import NeighborLists

_HALF_PI = float(np.float32(math.pi / 2))


@dataclasses.dataclass
class LightUniforms(Struct):
    """The first ``max_lights`` active lights, for the shader pass."""

    count: torch.Tensor  # int32 scalar
    x: torch.Tensor  # f32[max_lights]
    y: torch.Tensor
    intensity: torch.Tensor
    color: torch.Tensor  # int64 holding a uint32
    height: torch.Tensor


def _lights_ok(world: World) -> torch.Tensor:
    t, li, sp = world.transform, world.light, world.sprite
    return li.active & t.active & sp.is_on_screen & (li.light_intensity > 0)


def shadow_sprites(world: World, nbr: NeighborLists, cfg: EngineConfig) -> ShadowSprites:
    """Shadow sprites over the frame's global neighbour lists
    (lighting.py:48-60): the first L eligible lights in entity-index order;
    a world with fewer than L entities pads with inactive slots."""
    light_ok = _lights_ok(world)
    sel = first_k_where(light_ok, cfg.lighting.max_shadow_casting_lights)
    return _shadow_rows(world, cfg, sel, light_ok[sel], nbr.ids[sel], nbr.d2[sel])


def shadow_sprites_by_class(world: World, light_specs: Sequence[Tuple[int, int, NeighborLists]],
                            cfg: EngineConfig) -> ShadowSprites:
    """:func:`shadow_sprites` over per-class lists (lighting.py:63-97):
    ``light_specs`` holds ``(start, count, lists)`` of each class that
    declares LightEmitter, in slot-range order, so their rows concatenate in
    entity-index order. Candidate widths pad to the widest class."""
    lc = cfg.lighting
    if not light_specs:
        return ShadowSprites.zeros(lc.max_shadow_casting_lights * lc.max_shadows_per_light,
                                   world.device)
    s_max = max(n.ids.shape[1] for _s, _c, n in light_specs)

    def padw(a, fill):
        return torch.nn.functional.pad(a, (0, s_max - a.shape[1]), value=fill)

    dev = world.device
    g = torch.cat([torch.arange(s, s + c, dtype=torch.int64, device=dev)
                   for s, c, _n in light_specs])
    ids = torch.cat([padw(n.ids, -1) for _s, _c, n in light_specs])
    d2 = torch.cat([padw(n.d2, 0.0) for _s, _c, n in light_specs])
    light_ok = _lights_ok(world)[g]
    sel = first_k_where(light_ok, lc.max_shadow_casting_lights)
    return _shadow_rows(world, cfg, g[sel], light_ok[sel], ids[sel], d2[sel])


def _shadow_rows(world: World, cfg: EngineConfig, order: torch.Tensor, l_valid: torch.Tensor,
                 ids: torch.Tensor, d2: torch.Tensor) -> ShadowSprites:
    """The shadow-sprite math of the selected lights (lighting.py:100-165):
    ``order`` their ``[l_take]`` entity indices, ``ids``/``d2`` their
    neighbour rows. Each light keeps its first ``max_shadows_per_light``
    eligible casters in scan order (a stable compaction, like the
    sequential ``shadowIdx++`` fill); the math is elementwise, so it runs on
    the kept slots only."""
    lc = cfg.lighting
    L, M = lc.max_shadow_casting_lights, lc.max_shadows_per_light
    t, li, sh, sp = world.transform, world.light, world.shadow, world.sprite
    l_take = order.shape[0]
    j_all = torch.clamp(ids, min=0).to(torch.int64)
    caster_ok = (
        l_valid[:, None]
        & (ids >= 0)
        & sh.active[j_all]
        & t.active[j_all]
        & sp.is_on_screen[j_all]
        & (_sqrt(d2) >= 1.0)  # the division-by-zero guard takes no slot (:955)
    )
    rank = torch.cumsum(caster_ok, dim=1, dtype=torch.int32)
    keep = caster_ok & (rank <= M)
    ord2 = first_k_where(keep, M, dim=1)  # [l_take, min(S, M)]
    c2 = ord2.shape[1]

    kept = torch.gather(keep, 1, ord2)
    d2 = torch.gather(d2, 1, ord2)
    j = torch.gather(j_all, 1, ord2)
    c_rad = torch.where(sh.shadow_radius[j] > 0, sh.shadow_radius[j], 10.0)  # || 10 (:945)
    c_h = torch.where(sh.height[j] > 0, sh.height[j], c_rad)  # || radius (:946)
    fields = shadow_math(t.x[j], t.y[j], c_rad, c_h, t.x[order][:, None], t.y[order][:, None],
                         li.light_intensity[order][:, None], d2)

    def out(a: torch.Tensor) -> torch.Tensor:
        a = torch.broadcast_to(a, kept.shape)
        return torch.nn.functional.pad(a, (0, M - c2, 0, L - l_take)).reshape(-1)

    return ShadowSprites(active=out(kept), **{k: out(v) for k, v in fields.items()})


def shadow_math(cx, cy, c_rad, c_h, lx, ly, l_int, d2):
    """The sprite of each kept caster (particle_worker.js:940-1000): at the
    caster's feet, away from the light (:962-964), longer with distance and
    caster height, alpha = intensity / (2 d^2). ``c_rad`` and ``c_h`` are
    the caster's radius and height after their fallbacks; the light's
    ``lx``, ``ly``, ``l_int`` broadcast against the casters. One
    implementation for the single-device pass and the slab steps'
    (``parallel.halo``), so the two agree bit for bit."""
    dist = _sqrt(d2)
    dx = cx - lx
    dy = cy - ly
    inv_dist = 1.0 / torch.clamp(dist, min=1e-6)
    dir_x = dx * inv_dist
    dir_y = dy * inv_dist
    height_factor = c_h * 0.025
    dist_ratio = torch.clamp(dist * (1.0 / 256.0), max=1.0)
    return dict(
        x=cx - dir_x * c_rad,
        y=cy - dir_y * c_rad,
        rotation=_atan2(dy, dx) - _HALF_PI,
        scale_x=c_rad * 0.0714,
        scale_y=(0.3 + dist_ratio * 0.9) * height_factor,
        alpha=l_int / torch.clamp(d2 * 2.0, min=1e-6),
        radius=c_rad,
    )


def light_uniforms(world: World, cfg: EngineConfig) -> LightUniforms:
    """pixi_worker.js:1256-1312 (lighting.py:168-185): uniform arrays for
    the lighting shader, the first max_lights active lights, on screen or
    off (the shader handles the falloff)."""
    t, li = world.transform, world.light
    ok = li.active & t.active & (li.light_intensity > 0)
    order = first_k_where(ok, cfg.lighting.max_lights)
    valid = ok[order]
    return LightUniforms(
        count=torch.sum(valid, dtype=torch.int32),
        x=torch.where(valid, t.x[order], 0.0),
        y=torch.where(valid, t.y[order], 0.0),
        intensity=torch.where(valid, li.light_intensity[order], 0.0),
        color=torch.where(valid, li.light_color[order], 0),
        height=torch.where(valid, li.height[order], 0.0),
    )


def entity_light_levels(world: World, nbr: NeighborLists, cfg: EngineConfig) -> torch.Tensor:
    """Per-entity brightness from the neighbour lights plus the ambient,
    capped at 1.5 (calculateLightFromNeighbors, utils.js:439-470;
    lighting.py:188-200). Returns f32[N]."""
    li = world.light
    j = torch.clamp(nbr.ids, min=0).to(torch.int64)
    lit = (nbr.ids >= 0) & li.active[j] & (li.light_intensity[j] > 0)
    contrib = torch.where(lit, light_attenuation(li.light_intensity[j], nbr.d2), 0.0)
    total = cfg.lighting.lighting_ambient + torch.sum(contrib, dim=1)
    return torch.clamp(total, max=1.5)
