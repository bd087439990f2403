"""On-device animation advance.

PyTorch counterpart of ``advance_animation`` in
``multithreadedgameengine_tpu/render/extract.py:51``. Render-packet
extraction and the renderers (ROADMAP slice D) are not ported yet.
"""

from __future__ import annotations

import torch

from ..state import World


def advance_animation(
    world: World, frame_counts: torch.Tensor, dt_ratio: float
) -> World:
    """Advance the fractional frame accumulator of animated, visible
    sprites and wrap it by the animation's frame count
    (pixi_worker.js:963-984). ``frame_counts``: int32[sheets+1, anims]."""
    s = world.sprite
    run = s.active & s.is_animated & world.transform.active
    n_sheets, n_anims = frame_counts.shape
    sheet = torch.clamp(s.spritesheet_id, 0, n_sheets - 1).to(torch.int64)
    anim = torch.clamp(s.animation_state, 0, n_anims - 1).to(torch.int64)
    fcount = torch.clamp(frame_counts[sheet, anim], min=1).to(torch.float32)
    accum = torch.where(run, s.animation_accum + s.animation_speed * dt_ratio, s.animation_accum)
    accum = torch.where(accum >= fcount, accum - fcount * torch.floor(accum / fcount), accum)
    frame = torch.minimum(torch.floor(accum), fcount - 1).to(torch.int32)
    return world.replace(
        sprite=s.replace(
            animation_accum=accum,
            animation_frame=torch.where(run, frame, s.animation_frame),
        )
    )
