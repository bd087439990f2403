"""Runtime atlas pipeline — the BigAtlas system (src/core/SpriteSheetRegistry.js
:438-902 MaxRectsPacker + createBigAtlas; src/core/BigAtlasInspector.js).

The reference loads every image and spritesheet at startup, re-cuts each
sheet frame, and MaxRects-packs everything into ONE ≤4096² canvas so the
renderer binds a single texture; per-sheet "proxy" metadata keeps independent
animation index spaces. This port does the same on the host with numpy:

 - :func:`decode_png` / the sibling headless.write_png — dependency-free
   8-bit PNG I/O;
 - :class:`MaxRectsPacker` — free-rectangle packing with best-short-side fit,
   split and prune (the classic MaxRects algorithm the reference implements);
 - :func:`create_big_atlas` — pack loose textures + sheet frames, emit a
   TexturePacker-style frames dict, register everything on a SpriteRegistry,
   and inject the procedural ``_lightGradient`` glow texture the lighting
   system expects (SpriteSheetRegistry.js:774-788; utils.js:522-564);
 - :func:`inspect_atlas` — the BigAtlasInspector analog: the atlas PNG with
   frame outlines for debugging.

The port's own copy of ``multithreadedgameengine_tpu/render/atlas.py``,
which imports no JAX (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import struct as _struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_ATLAS = 4096


# ---------------------------------------------------------------------------
# PNG decode (8-bit, non-interlaced, grayscale/RGB/RGBA — covers game assets)
# ---------------------------------------------------------------------------

def decode_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder → uint8 [H, W, 4] RGBA."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    palette = None
    while pos < len(data):
        (length,) = _struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = _struct.unpack(
                ">IIBBBBB", chunk
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNGs supported")
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for row in range(h):
        ftype = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for i in range(channels, stride):
                cur[i] = (cur[i] + cur[i - channels]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - channels] if i >= channels else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        img[row] = cur.astype(np.uint8)
        prev = cur
    px = img.reshape(h, w, channels)
    out = np.zeros((h, w, 4), np.uint8)
    if color_type == 0:  # gray
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 2:  # RGB
        out[..., :3] = px
        out[..., 3] = 255
    elif color_type == 3:  # palette
        out[..., :3] = palette[px[..., 0]]
        out[..., 3] = 255
    elif color_type == 4:  # gray+alpha
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    else:  # RGBA
        out = px
    return out


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


# ---------------------------------------------------------------------------
# MaxRects packing (SpriteSheetRegistry.js:438-602 semantics)
# ---------------------------------------------------------------------------

@dataclass
class Rect:
    x: int
    y: int
    w: int
    h: int


class MaxRectsPacker:
    """Best-short-side-fit MaxRects with split + prune."""

    def __init__(self, width: int, height: int, padding: int = 1):
        self.width = width
        self.height = height
        self.padding = padding
        self.free: List[Rect] = [Rect(0, 0, width, height)]

    def insert(self, w: int, h: int) -> Optional[Rect]:
        w_p, h_p = w + self.padding, h + self.padding
        best = None
        best_score = None
        for r in self.free:
            if r.w >= w_p and r.h >= h_p:
                score = min(r.w - w_p, r.h - h_p)
                if best_score is None or score < best_score:
                    best, best_score = r, score
        if best is None:
            return None
        placed = Rect(best.x, best.y, w, h)
        self._split(Rect(best.x, best.y, w_p, h_p))
        self._prune()
        return placed

    def _split(self, used: Rect) -> None:
        new_free: List[Rect] = []
        for r in self.free:
            if (used.x >= r.x + r.w or used.x + used.w <= r.x
                    or used.y >= r.y + r.h or used.y + used.h <= r.y):
                new_free.append(r)
                continue
            # overlap: up to 4 remainder rects
            if used.x > r.x:
                new_free.append(Rect(r.x, r.y, used.x - r.x, r.h))
            if used.x + used.w < r.x + r.w:
                new_free.append(Rect(used.x + used.w, r.y,
                                     r.x + r.w - (used.x + used.w), r.h))
            if used.y > r.y:
                new_free.append(Rect(r.x, r.y, r.w, used.y - r.y))
            if used.y + used.h < r.y + r.h:
                new_free.append(Rect(r.x, used.y + used.h, r.w,
                                     r.y + r.h - (used.y + used.h)))
        self.free = new_free

    def _prune(self) -> None:
        pruned: List[Rect] = []
        for i, a in enumerate(self.free):
            contained = False
            for j, b in enumerate(self.free):
                if i != j and (a.x >= b.x and a.y >= b.y
                               and a.x + a.w <= b.x + b.w
                               and a.y + a.h <= b.y + b.h):
                    if not (a.x == b.x and a.y == b.y and a.w == b.w
                            and a.h == b.h and i < j):
                        contained = True
                        break
            if not contained:
                pruned.append(a)
        self.free = pruned


# ---------------------------------------------------------------------------
# Big atlas
# ---------------------------------------------------------------------------

def light_gradient_texture(radius: int = 100, color: int = 0xFFFFFF) -> np.ndarray:
    """The built-in radial glow (createCircularGradientCanvas,
    utils.js:522-564: exponential 2^(1-t·50) alpha falloff)."""
    size = radius * 2
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.hypot(xx - radius + 0.5, yy - radius + 0.5) / radius
    t = np.clip(d, 0, 1)
    # the reference's 50 gradient stops of alpha 2^(1-i) (utils.js:546-551)
    # as the continuous falloff 2 * 2^(-49 t)
    alpha = np.where(d <= 1.0, np.exp2(-t * 49.0) * 2.0, 0.0).clip(0, 1)
    r = (color >> 16) & 0xFF
    g = (color >> 8) & 0xFF
    b = color & 0xFF
    out = np.zeros((size, size, 4), np.uint8)
    out[..., 0] = r
    out[..., 1] = g
    out[..., 2] = b
    out[..., 3] = (alpha * 255).astype(np.uint8)
    return out


@dataclass
class BigAtlas:
    image: np.ndarray  # uint8 [H, W, 4]
    frames: Dict[str, dict]  # TexturePacker-style {frame: {x, y, w, h}}
    json: dict = field(default_factory=dict)

    def frame_image(self, name: str) -> np.ndarray:
        fr = self.frames[name]["frame"]
        return self.image[fr["y"]:fr["y"] + fr["h"], fr["x"]:fr["x"] + fr["w"]]


def create_big_atlas(
    images: Dict[str, np.ndarray],
    sheets: Optional[Dict[str, Tuple[np.ndarray, dict]]] = None,
    size: int = 1024,
    registry=None,
) -> BigAtlas:
    """Pack loose textures + every frame of every sheet into one canvas
    (createBigAtlas, SpriteSheetRegistry.js:622-902).

    ``images``: name → RGBA array. ``sheets``: name → (sheet RGBA,
    TexturePacker-style json with "frames" and "animations"). Grows the
    canvas ×2 up to 4096 until everything fits. When ``registry`` (a
    SpriteRegistry) is given, textures and sheets register on it."""
    sheets = sheets or {}
    entries: List[Tuple[str, np.ndarray]] = []
    entries.append(("_lightGradient", light_gradient_texture()))
    for name, img in images.items():
        entries.append((name, img))
    for sheet_name, (sheet_img, meta) in sheets.items():
        for frame_name, fr in meta["frames"].items():
            f = fr["frame"]
            cut = sheet_img[f["y"]:f["y"] + f["h"], f["x"]:f["x"] + f["w"]]
            entries.append((f"{sheet_name}/{frame_name}", cut))

    # largest-first insertion, growing canvas until success
    entries.sort(key=lambda e: -(e[1].shape[0] * e[1].shape[1]))
    while True:
        packer = MaxRectsPacker(size, size)
        placed: Dict[str, Rect] = {}
        ok = True
        for name, img in entries:
            h, w = img.shape[:2]
            rect = packer.insert(w, h)
            if rect is None:
                ok = False
                break
            placed[name] = rect
        if ok:
            break
        if size >= MAX_ATLAS:
            raise ValueError(f"assets do not fit a {MAX_ATLAS}^2 atlas")
        size *= 2

    canvas = np.zeros((size, size, 4), np.uint8)
    frames: Dict[str, dict] = {}
    lookup = dict(entries)
    for name, rect in placed.items():
        img = lookup[name]
        canvas[rect.y:rect.y + rect.h, rect.x:rect.x + rect.w] = img
        frames[name] = {"frame": {"x": rect.x, "y": rect.y, "w": rect.w, "h": rect.h}}

    tp_json = {
        "frames": frames,
        "meta": {"size": {"w": size, "h": size}, "format": "RGBA8888"},
        # proxy sheets: per-sheet animation metadata with independent index
        # spaces (SpriteSheetRegistry.js:869-902)
        "sheets": {
            name: {"animations": list(meta.get("animations", {}).keys())}
            for name, (_, meta) in sheets.items()
        },
    }

    if registry is not None:
        for name in images:
            registry.register_texture(name)
        registry.register_texture("_lightGradient")
        for sheet_name, (_, meta) in sheets.items():
            anims = [
                (anim, len(frames_list))
                for anim, frames_list in meta.get("animations", {}).items()
            ]
            registry.register_spritesheet(sheet_name, anims)

    return BigAtlas(image=canvas, frames=frames, json=tp_json)


def animation_strip(
    atlas: BigAtlas, sheet_name: str, meta: dict, anim: str, path: str
) -> np.ndarray:
    """Render one animation's frames side by side — the
    spritesheet_stuff/animatedSpriteVisualizer.html analog for headless
    preview. ``meta`` is the sheet's TexturePacker json."""
    from .headless import write_png

    frame_names = meta["animations"][anim]
    cuts = [atlas.frame_image(f"{sheet_name}/{f}") for f in frame_names]
    h = max(c.shape[0] for c in cuts)
    w = sum(c.shape[1] for c in cuts)
    strip = np.zeros((h, w, 3), np.uint8)
    x = 0
    for c in cuts:
        rgb = c[..., :3].astype(np.float32)
        a = c[..., 3:4].astype(np.float32) / 255.0
        strip[: c.shape[0], x : x + c.shape[1]] = (rgb * a).astype(np.uint8)
        x += c.shape[1]
    write_png(path, strip)
    return strip


def inspect_atlas(atlas: BigAtlas, path: str) -> None:
    """BigAtlasInspector analog: dump the atlas with frame outlines."""
    from .headless import write_png

    img = atlas.image[..., :3].astype(np.float32).copy()
    for name, fr in atlas.frames.items():
        f = fr["frame"]
        x0, y0, x1, y1 = f["x"], f["y"], f["x"] + f["w"] - 1, f["y"] + f["h"] - 1
        img[y0, x0:x1 + 1] = (0, 255, 0)
        img[y1, x0:x1 + 1] = (0, 255, 0)
        img[y0:y1 + 1, x0] = (0, 255, 0)
        img[y0:y1 + 1, x1] = (0, 255, 0)
    write_png(path, img.astype(np.uint8))
