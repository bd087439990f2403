"""Screen-space culling: world to screen transform and viewport test.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/culling.py``
(particle_worker.js:1012-1056 for entities, :506-517 for particles):
``screen = world * zoom - camera * zoom``, visible when inside the canvas
widened by ``renderer.cull_margin``.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..inputs import InputState
from ..state import World


def camera_bounds(cfg: EngineConfig, inputs: InputState):
    zoom = inputs.camera_zoom
    off_x = inputs.camera_x * zoom
    off_y = inputs.camera_y * zoom
    mx = cfg.canvas_width * cfg.renderer.cull_margin
    my = cfg.canvas_height * cfg.renderer.cull_margin
    return zoom, off_x, off_y, (-mx, cfg.canvas_width + mx, -my, cfg.canvas_height + my)


def update_entity_visibility(world: World, cfg: EngineConfig, inputs: InputState) -> World:
    """particle_worker.js:1012-1056."""
    t, s = world.transform, world.sprite
    zoom, off_x, off_y, (min_x, max_x, min_y, max_y) = camera_bounds(cfg, inputs)
    sx = t.x * zoom - off_x
    sy = t.y * zoom - off_y
    on = (sx > min_x) & (sx < max_x) & (sy > min_y) & (sy < max_y)
    return world.replace(
        sprite=s.replace(
            screen_x=torch.where(t.active, sx, s.screen_x),
            screen_y=torch.where(t.active, sy, s.screen_y),
            is_on_screen=torch.where(t.active, on, s.is_on_screen),
        )
    )


def update_particle_visibility(world: World, cfg: EngineConfig, inputs: InputState) -> World:
    """particle_worker.js:506-517 (culling.py:49-60): the pool's live
    particles get ``is_on_screen`` by the entities' test."""
    p = world.particles
    if p is None:
        return world
    zoom, off_x, off_y, (min_x, max_x, min_y, max_y) = camera_bounds(cfg, inputs)
    sx = p.x * zoom - off_x
    sy = p.y * zoom - off_y
    on = (sx > min_x) & (sx < max_x) & (sy > min_y) & (sy < max_y)
    return world.replace(
        particles=p.replace(is_on_screen=torch.where(p.active, on, p.is_on_screen))
    )
