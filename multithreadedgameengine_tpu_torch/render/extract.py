"""On-device render-state extraction.

PyTorch counterpart of ``multithreadedgameengine_tpu/render/extract.py``:

- :func:`advance_animation`: the per-entity frame accumulator advance, with
  the wrap at the animation's frame count (pixi_worker.js:963-984);
- :func:`extract_render_packet`: the visible entities compacted on the
  device into one dense packet, Y-sorted when ``renderer.y_sorting`` (the
  renderer's sort-by-y, pixi_worker.js:937-960). Only the packet crosses
  to the host, in one copy (:func:`packet_to_host`, :func:`host_copy`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..components import Struct
from ..config import EngineConfig
from ..ops.particles import first_k_where
from ..state import World


@dataclasses.dataclass
class RenderPacket(Struct):
    """Dense visible-entity records, the device-to-host frame payload
    (extract.py:29-48). Every field is ``[max_visible]``; the first
    ``count`` rows are the visible entities."""

    count: torch.Tensor  # int32 scalar
    index: torch.Tensor  # int32 entity index (-1 pad)
    x: torch.Tensor  # f32 world position
    y: torch.Tensor
    screen_x: torch.Tensor  # f32 screen position (the culling pass's)
    screen_y: torch.Tensor
    rotation: torch.Tensor
    scale_x: torch.Tensor
    scale_y: torch.Tensor
    anchor_x: torch.Tensor
    anchor_y: torch.Tensor
    tint: torch.Tensor  # int64, the reference's uint32 (as the world holds it)
    alpha: torch.Tensor
    spritesheet_id: torch.Tensor  # int32
    animation_state: torch.Tensor  # int32
    animation_frame: torch.Tensor  # int32
    z_offset: torch.Tensor


#: the packet's per-row fields in their order, after ``count``
_ROW_FIELDS = tuple(f.name for f in dataclasses.fields(RenderPacket))[1:]


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


def extract_render_packet(world: World, cfg: EngineConfig, max_visible: int) -> RenderPacket:
    """Compact the visible entities into a dense packet (extract.py:80-110):
    a stable sort of the visible mask, or with ``renderer.y_sorting`` of
    ``y`` with +inf for the invisible, then one gather a field."""
    t, s = world.transform, world.sprite
    visible = t.active & s.active & s.render_visible & s.is_on_screen
    if cfg.renderer.y_sorting:
        order = torch.sort(torch.where(visible, t.y, float("inf")), stable=True).indices
        order = order[:max_visible]
    else:
        order = first_k_where(visible, max_visible)
    idx = torch.where(visible[order], order.to(torch.int32), -1)
    src = dict(x=t.x, y=t.y, rotation=t.rotation)
    rows = {f: (src[f] if f in src else getattr(s, f))[order]
            for f in _ROW_FIELDS if f != "index"}
    return RenderPacket(
        count=torch.clamp(torch.sum(visible, dtype=torch.int32), max=max_visible),
        index=idx, **rows)


def host_copy(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors (all on one device) as CPU tensors of the same shapes and
    dtypes, through one copy: each flattened to int32 lanes of one buffer
    (float32 by its bits; an int64 by its low 32 bits, which hold all of a
    uint32 colour, the only int64 state these copies carry)."""
    lanes = []
    for a in tensors:
        a = a.reshape(-1)
        lanes.append(a.view(torch.int32) if a.dtype == torch.float32 else a.to(torch.int32))
    host = torch.cat(lanes).cpu()
    out, at = [], 0
    for a in tensors:
        lane = host[at:at + a.numel()].reshape(a.shape)
        at += a.numel()
        if a.dtype == torch.float32:
            out.append(lane.view(torch.float32))
        elif a.dtype == torch.int64:
            out.append(lane.to(torch.int64) & 0xFFFFFFFF)
        else:
            out.append(lane.to(a.dtype))
    return out


def packet_to_host(pkt: RenderPacket) -> RenderPacket:
    """The packet as CPU tensors, through one copy."""
    names = [f.name for f in dataclasses.fields(RenderPacket)]
    return RenderPacket(**dict(zip(names, host_copy([getattr(pkt, f) for f in names]))))
