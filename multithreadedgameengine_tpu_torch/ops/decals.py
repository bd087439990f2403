"""Decal tilemap: permanent stamps blitted into a world-sized RGBA canvas.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/decals.py``. The
reference's blood decals (particle_worker.js:550-671): landed particles blit
a tinted, scaled, nearest-neighbour-sampled texture into the tile RGBA
buffer with alpha-over blending and set a per-tile dirty flag for the
renderer (pixi_worker.js:1067-1107). One uint8 canvas ``[H, W, 4]`` covers
the world at decal resolution; tiles are only the dirty-tracking unit.

Each stamp is a read-modify-write of one ``PATCH x PATCH`` patch, and
stamps overlap, so they apply one after another in batch order, as the
reference's ``fori_loop`` applies them. What does not read the canvas (the
patch origin, the texture sampling, the tint, the source alpha and the
dirty tiles) is computed for every stamp at once; only the blend runs per
stamp: a gather of the patch's 1,024 pixels, the blend in float32, the
``round(x * 255)`` back to uint8 (``torch.round`` rounds half to even, as
``jnp.round`` does) and a scatter. A stamp whose ``valid`` is False still
runs with a source alpha of 0 and rewrites its patch, as in the reference:
a pixel with alpha 0 gets rgb 0. About 16 eager ops a stamp, 64 stamps a
frame: the cost is in ``PERF.md``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from .particles import StampBatch

# patch edge in canvas pixels; stamps scale the source sampling inside it
PATCH = 32
# decal source textures are normalized to this resolution
TEX_SIZE = 16


def canvas_shape(cfg: EngineConfig) -> Tuple[int, int]:
    res = cfg.particle.decals_resolution
    h = max(1, math.ceil(cfg.world_height * res))
    w = max(1, math.ceil(cfg.world_width * res))
    return h, w


def tile_grid_shape(cfg: EngineConfig) -> Tuple[int, int]:
    ts = cfg.particle.decals_tile_size
    ty = max(1, math.ceil(cfg.world_height / ts))
    tx = max(1, math.ceil(cfg.world_width / ts))
    return ty, tx


def default_decal_textures(n_textures: int, device) -> torch.Tensor:
    """The procedural stand-ins for atlas decal textures (decals.py:50-66):
    a radial splat with soft falloff, f32 ``[n_textures + 1, TEX, TEX, 4]``.
    Texture 0 is empty, like the reference's missing-texture guard
    (particle_worker.js:563-566). Computed in numpy as the reference does,
    so the bank is bit-equal."""
    yy, xx = np.mgrid[0:TEX_SIZE, 0:TEX_SIZE]
    cx = (TEX_SIZE - 1) / 2
    d = np.hypot(xx - cx, yy - cx) / (TEX_SIZE / 2)
    alpha = np.clip(1.0 - d, 0.0, 1.0) ** 1.5
    rgb = np.ones((TEX_SIZE, TEX_SIZE, 3), np.float32)
    tex = np.concatenate([rgb, alpha[..., None].astype(np.float32)], axis=-1)
    bank = np.zeros((max(n_textures, 1) + 1, TEX_SIZE, TEX_SIZE, 4), np.float32)
    bank[1:] = tex[None]
    return torch.from_numpy(bank).to(device)


def _trunc_clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(int32(v), 0, hi)`` with XLA's conversion (truncation toward
    zero, NaN to 0), clamped in float first so the cast is always
    defined."""
    v = torch.where(torch.isnan(v), 0.0, v)
    return torch.clamp(v, 0.0, float(hi)).to(torch.int32)


def _channel(tint: torch.Tensor, shift: int) -> torch.Tensor:
    return ((tint >> shift) & 0xFF).to(torch.float32) / 255.0


def stamp_decals(
    canvas: torch.Tensor,  # uint8[H, W, 4]
    dirty: torch.Tensor,  # bool[tiles_y, tiles_x]
    stamps: Optional[StampBatch],
    textures: torch.Tensor,  # f32[T, TEX, TEX, 4]
    cfg: EngineConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blit every stamp with tint multiply and alpha-over blending
    (stampParticleToTile, particle_worker.js:550-671; decals.py:69-145) and
    mark the tiles its patch corners touch when it is valid. Returns new
    (canvas, dirty); the inputs are not modified."""
    if stamps is None or stamps.x.shape[0] == 0 or canvas.shape[0] <= 1:
        return canvas, dirty
    res = cfg.particle.decals_resolution
    h, w = canvas.shape[:2]
    ty, tx = dirty.shape
    tile_px = cfg.particle.decals_tile_size * res
    n_tex = textures.shape[0]
    n = stamps.x.shape[0]
    dev = canvas.device

    # the patch origin and source sampling of every stamp: [n, PATCH, PATCH]
    size = torch.clamp(stamps.scale * TEX_SIZE * res, min=1.0)
    cx = stamps.x * res
    cy = stamps.y * res
    x0 = _trunc_clip(cx - PATCH / 2, w - PATCH)
    y0 = _trunc_clip(cy - PATCH / 2, h - PATCH)
    p = torch.arange(PATCH, dtype=torch.float32, device=dev)
    fx = ((p[None, :] + x0.to(torch.float32)[:, None]) - (cx - size / 2)[:, None]) / size[:, None]
    fy = ((p[None, :] + y0.to(torch.float32)[:, None]) - (cy - size / 2)[:, None]) / size[:, None]
    fx, fy = fx[:, None, :], fy[:, :, None]  # columns along x, rows along y
    inside = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    sx = _trunc_clip(fx * TEX_SIZE, TEX_SIZE - 1).to(torch.int64)
    sy = _trunc_clip(fy * TEX_SIZE, TEX_SIZE - 1).to(torch.int64)
    tex_id = torch.clamp(stamps.texture_id, 0, n_tex - 1).to(torch.int64)
    src = textures[tex_id[:, None, None], sy, sx]  # [n, PATCH, PATCH, 4]
    tint = torch.stack([_channel(stamps.tint, s) for s in (16, 8, 0)], dim=-1)
    src_rgb = src[..., :3] * tint[:, None, None, :]
    src_a = src[..., 3] * stamps.alpha[:, None, None] * inside * stamps.valid[:, None, None]
    # the blend's canvas-free terms, flattened to the patch's pixel order
    src_a = src_a.reshape(n, PATCH * PATCH, 1)
    keep = 1.0 - src_a
    src_term = src_rgb.reshape(n, PATCH * PATCH, 3) * src_a
    rows = y0.to(torch.int64)[:, None] + torch.arange(PATCH, device=dev)
    cols = x0.to(torch.int64)[:, None] + torch.arange(PATCH, device=dev)
    pix = (rows[:, :, None] * w + cols[:, None, :]).reshape(n, PATCH * PATCH)

    out = canvas.clone()
    flat = out.view(h * w, 4)
    for k in range(n):  # in order: patches overlap
        old = flat.index_select(0, pix[k]).to(torch.float32) / 255.0
        old_a = old[:, 3:4]
        out_a = src_a[k] + old_a * keep[k]
        out_rgb = (src_term[k] + old[:, :3] * old_a * keep[k]) / torch.clamp(out_a, min=1e-6)
        new = torch.cat([out_rgb, out_a], dim=1)
        flat.index_copy_(0, pix[k], torch.clamp(torch.round(new * 255.0), 0, 255).to(torch.uint8))

    # the tiles under the patch corners of the valid stamps (an OR, so in
    # any order); invalid stamps go to a spare tile that is cut off
    t0x = _trunc_clip(x0 / tile_px, tx - 1)
    t1x = _trunc_clip((x0 + PATCH - 1) / tile_px, tx - 1)
    t0y = _trunc_clip(y0 / tile_px, ty - 1)
    t1y = _trunc_clip((y0 + PATCH - 1) / tile_px, ty - 1)
    corners = torch.stack([t0y * tx + t0x, t0y * tx + t1x, t1y * tx + t0x, t1y * tx + t1x], 1)
    corners = torch.where(stamps.valid[:, None], corners, ty * tx).reshape(-1).to(torch.int64)
    hit = torch.zeros(ty * tx + 1, dtype=torch.bool, device=dev).index_fill_(0, corners, True)
    return out, dirty | hit[:-1].view(ty, tx)
