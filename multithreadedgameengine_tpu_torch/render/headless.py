"""Headless host renderer: numpy rasterizer + dependency-free PNG writer.

A debug-quality stand-in for the reference's PixiJS WebGL worker
(src/workers/pixi_worker.js) that draws the same z-layer stack —
BACKGROUND(0) / DECALS(1) / SHADOWS(2) / ENTITIES(3) / LIGHTING(4)
(pixi_worker.js:84-91) — into an RGB image:

 - decal canvas alpha-blended over the background,
 - shadow sprites as rotated dark ellipses,
 - entities as REAL atlas sprites when ``engine.atlas`` is loaded
   (Engine.load_assets): frame resolved from spritesheet_id /
   animation_state / animation_frame exactly like the browser client
   (static texture ids ride the animation lane when spritesheet_id == 0),
   blitted with anchor/scale/rotation/tint/alpha (pixi_worker.js:807-960,
   :1960-2003); tinted circles sized by collider radius remain the
   fallback for entities without an atlas frame,
 - particles as small tinted dots with z-offset,
 - lighting as the same ``intensity/(intensity + d²)`` multiply pass the
   GLSL shader applies (pixi_worker.js:1206-1249),
 - light GLOWS as additive radial-gradient splats above the lighting pass
   (the _lightGradient sprite layer, pixi_worker.js:1433-1571).

Everything renders in *world* coordinates through the camera transform used
by the culling pass.

PyTorch port of ``multithreadedgameengine_tpu/render/headless.py``: the
world and the light uniforms come to the host in one ``.cpu()`` copy each
(the reference's ``jax.device_get``), as numpy arrays, and everything after
is the reference's numpy, so the same world draws the same pixels. A world
without a particle pool, a decal canvas or shadow sprites holds None where
the reference holds empty placeholders; those layers are skipped.
"""

from __future__ import annotations

import struct as _struct
import zlib
from typing import Optional

import numpy as np


def host_arrays(tree):
    """A world (or any struct of tensors) with every tensor leaf copied to
    the host as a numpy array."""
    return tree.map_tensors(lambda a: a.cpu().numpy())


def encode_png(img: np.ndarray) -> bytes:
    """Minimal PNG encoder: 8-bit RGB ([H,W,3]) or RGBA ([H,W,4])."""
    h, w = img.shape[:2]
    color_type = 6 if img.shape[2] == 4 else 2
    raw = b"".join(
        b"\x00" + img[row].astype(np.uint8).tobytes() for row in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = _struct.pack(">I", len(data)) + tag + data
        return out + _struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = _struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _draw_line(img, x0, y0, x1, y1, color, alpha=1.0):
    """Simple DDA line for debug overlays."""
    h, w = img.shape[:2]
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    ts = np.linspace(0.0, 1.0, steps + 1)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    a = float(np.clip(alpha, 0, 1))
    img[ys[ok], xs[ok]] = img[ys[ok], xs[ok]] * (1 - a) + np.asarray(color, np.float32) * a


def _draw_circle_outline(img, cx, cy, radius, color, alpha=1.0):
    h, w = img.shape[:2]
    r = max(1.0, radius)
    n = max(12, int(r))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    xs = np.round(cx + r * np.cos(ang)).astype(int)
    ys = np.round(cy + r * np.sin(ang)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    a = float(np.clip(alpha, 0, 1))
    img[ys[ok], xs[ok]] = img[ys[ok], xs[ok]] * (1 - a) + np.asarray(color, np.float32) * a


def _blend_disc(img, cx, cy, radius, color, alpha):
    """Alpha-blend a filled disc into img (in-place)."""
    h, w = img.shape[:2]
    r = max(1, int(round(radius)))
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r + 1))
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r + 1))
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    a = float(np.clip(alpha, 0.0, 1.0))
    region = img[y0:y1, x0:x1]
    region[mask] = region[mask] * (1 - a) + np.asarray(color, np.float32) * a


def _tint_rgb(tint: int):
    return np.array([(tint >> 16) & 0xFF, (tint >> 8) & 0xFF, tint & 0xFF], np.float32)


def _blit_sprite(img, frame_rgba, cx, cy, sx, sy, rot, ax, ay, tint, alpha):
    """Alpha-over a (possibly rotated/scaled/tinted) atlas frame into img —
    the CPU analog of one PIXI.Particle draw (anchor + scale + rotation +
    tint + alpha, pixi_worker.js:807-960). Inverse-maps each destination
    pixel into the frame (nearest sample), so arbitrary rotations need no
    resampling pass."""
    h, w = img.shape[:2]
    fh, fw = frame_rgba.shape[:2]
    if fh == 0 or fw == 0 or abs(sx) < 1e-6 or abs(sy) < 1e-6:
        return
    cos, sin = float(np.cos(rot)), float(np.sin(rot))
    # dest-space corners of the scaled frame about the anchor
    us = np.array([0.0, fw, 0.0, fw]) - ax * fw
    vs = np.array([0.0, 0.0, fh, fh]) - ay * fh
    lx, ly = us * sx, vs * sy
    dx = lx * cos - ly * sin
    dy = lx * sin + ly * cos
    x0 = max(0, int(np.floor(cx + dx.min())))
    x1 = min(w, int(np.ceil(cx + dx.max())) + 1)
    y0 = max(0, int(np.floor(cy + dy.min())))
    y1 = min(h, int(np.ceil(cy + dy.max())) + 1)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    rx, ry = xx - cx, yy - cy
    # unrotate then unscale then unanchor → frame coords
    u = (rx * cos + ry * sin) / sx + ax * fw
    v = (-rx * sin + ry * cos) / sy + ay * fh
    inside = (u >= 0) & (u < fw) & (v >= 0) & (v < fh)
    ui = np.clip(u.astype(np.int32), 0, fw - 1)
    vi = np.clip(v.astype(np.int32), 0, fh - 1)
    src = frame_rgba[vi, ui].astype(np.float32)
    tint_mul = _tint_rgb(tint) / 255.0
    a = (src[..., 3] / 255.0) * float(np.clip(alpha, 0.0, 1.0)) * inside
    region = img[y0:y1, x0:x1]
    region[:] = region * (1 - a[..., None]) + (src[..., :3] * tint_mul) * a[..., None]


def _add_glow(img, cx, cy, radius_px, color_rgb, strength=0.55):
    """ADDITIVE radial-gradient splat — the light-glow sprite layer
    (pixi_worker.js:1433-1571 drives _lightGradient sprites with
    blendMode 'add'; utils.js:522-564 builds the gradient as a smooth
    radial falloff, approximated here as (1 - d/r)²)."""
    h, w = img.shape[:2]
    r = max(2.0, float(radius_px))
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r + 1))
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r + 1))
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    g = np.clip(1.0 - d / r, 0.0, 1.0) ** 2
    img[y0:y1, x0:x1] += g[..., None] * np.asarray(color_rgb, np.float32) * strength


def _atlas_frame_map(engine):
    """Numeric-id → atlas RGBA frame lookup, matching the browser client's
    resolution rule (client.html:305): spritesheet_id > 0 resolves
    sheets[sid][animation_state][animation_frame % n]; spritesheet_id == 0
    resolves static textures by the id riding the animation_state lane."""
    atlas = getattr(engine, "atlas", None)
    if atlas is None:
        return None
    # the atlas is immutable after load_assets: cache the resolver per
    # atlas identity so repeated screenshots don't re-cut every frame
    cached = getattr(engine, "_atlas_frame_cache", None)
    if cached is not None and cached[0] is atlas:
        return cached[1]
    from ..server.render_server import atlas_payload

    pay = atlas_payload(engine, atlas)

    def cut(rect):
        x, y, w, h = rect
        return atlas.image[y:y + h, x:x + w]

    sheets = {
        sid: {a: [cut(r) for r in rects] for a, rects in anims.items()}
        for sid, anims in pay["sheets"].items()
    }
    textures = {tid: cut(r) for tid, r in pay["textures"].items()}

    def resolve(sheet_id, anim, frame):
        if sheet_id == 0:
            return textures.get(anim)
        rects = sheets.get(sheet_id, {}).get(anim)
        if not rects:
            return None
        return rects[frame % len(rects)]

    engine._atlas_frame_cache = (atlas, resolve)
    return resolve


# 3×5 bitmap micro-font (rows of 3 bits, top→bottom) for the headless text
# overlays (indices / fps / info panels — pixi_worker renders these with
# PIXI.Text; a dependency-free rasterizer needs its own glyphs)
_FONT = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001010010", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", ":": "000010000010000",
    "/": "001001010100100", "-": "000000111000000", " ": "000000000000000",
    "a": "010101111101101", "c": "011100100100011", "d": "110101101101110",
    "e": "111100110100111", "f": "111100110100100", "g": "011100101101011",
    "i": "111010010010111", "l": "100100100100111", "m": "101111111101101",
    "n": "101111111111101", "o": "010101101101010", "p": "110101110100100",
    "r": "110101110110101", "s": "011100010001110", "t": "111010010010010",
    "x": "101101010101101",
}


def _draw_text(img, x, y, text, color=(255, 255, 0), scale=2):
    """Rasterize text with the 3×5 micro-font (unknown chars skipped)."""
    h, w = img.shape[:2]
    cx = int(x)
    col = np.asarray(color, np.float32)
    for ch in str(text).lower():
        bits = _FONT.get(ch)
        if bits is None:
            cx += 4 * scale
            continue
        for r in range(5):
            for c in range(3):
                if bits[r * 3 + c] == "1":
                    y0, x0 = int(y) + r * scale, cx + c * scale
                    y1, x1 = y0 + scale, x0 + scale
                    if 0 <= y0 and y1 <= h and 0 <= x0 and x1 <= w:
                        img[y0:y1, x0:x1] = col
        cx += 4 * scale


def _draw_rect_outline(img, x0, y0, x1, y1, color, alpha=1.0):
    _draw_line(img, x0, y0, x1, y0, color, alpha)
    _draw_line(img, x1, y0, x1, y1, color, alpha)
    _draw_line(img, x1, y1, x0, y1, color, alpha)
    _draw_line(img, x0, y1, x0, y0, color, alpha)


def render_frame(
    engine,
    width: Optional[int] = None,
    height: Optional[int] = None,
    path: Optional[str] = None,
    max_entities: int = 20000,
) -> np.ndarray:
    """Render the engine's current world through its camera. Returns the
    RGB uint8 image; writes a PNG when ``path`` is given."""
    cfg = engine.config
    width = width or cfg.canvas_width
    height = height or cfg.canvas_height
    w = host_arrays(engine.world)
    zoom = engine.input.camera_zoom
    off_x = engine.input.camera_x * zoom
    off_y = engine.input.camera_y * zoom

    def to_screen(x, y):
        return x * zoom - off_x, y * zoom - off_y

    img = np.full((height, width, 3), float(cfg.renderer.bg & 0xFF), np.float32)
    bg = _tint_rgb(cfg.renderer.bg)
    img[:] = bg

    # DECALS layer
    canvas = (np.asarray(w.decal_canvas, np.float32) if w.decal_canvas is not None
              else np.zeros((1, 1, 4), np.float32))
    if canvas.shape[0] > 1:
        res = cfg.particle.decals_resolution
        # decal canvas is world-aligned at `res` px per unit; sample per
        # screen pixel (nearest)
        ys = (np.arange(height) + off_y) / zoom * res
        xs = (np.arange(width) + off_x) / zoom * res
        yi = np.clip(ys.astype(int), 0, canvas.shape[0] - 1)
        xi = np.clip(xs.astype(int), 0, canvas.shape[1] - 1)
        inb = ((ys >= 0) & (ys < canvas.shape[0]))[:, None] & (
            (xs >= 0) & (xs < canvas.shape[1])
        )[None, :]
        patch = canvas[yi][:, xi]
        a = (patch[..., 3:4] / 255.0) * inb[..., None]
        img = img * (1 - a) + patch[..., :3] * a

    # SHADOWS layer (dark ellipses, simplified to discs scaled by length)
    ss = w.shadow_sprites
    if ss is not None and ss.active.shape[0]:
        for k in np.nonzero(np.asarray(ss.active))[0]:
            sx, sy = to_screen(float(ss.x[k]), float(ss.y[k]))
            _blend_disc(
                img, sx, sy, float(ss.radius[k]) * zoom,
                (0, 0, 0), min(float(ss.alpha[k]), 0.6),
            )

    # ENTITIES layer (y-sorted): real atlas sprites when assets are loaded
    # (anchor/scale/rotation/tint/alpha like the PixiJS particle sync,
    # pixi_worker.js:807-960); tinted circles otherwise
    t, s, c = w.transform, w.sprite, w.collider
    resolve_frame = _atlas_frame_map(engine)
    visible = np.asarray(t.active & s.active & s.render_visible & s.is_on_screen)
    order = np.argsort(np.where(visible, np.asarray(t.y), np.inf))[:max_entities]
    for i in order:
        if not visible[i]:
            break
        sx, sy = to_screen(float(t.x[i]), float(t.y[i]))
        frame = (
            resolve_frame(
                int(s.spritesheet_id[i]), int(s.animation_state[i]),
                int(s.animation_frame[i]),
            )
            if resolve_frame is not None else None
        )
        if frame is not None:
            _blit_sprite(
                img, frame, sx, sy,
                float(s.scale_x[i]) * zoom, float(s.scale_y[i]) * zoom,
                float(t.rotation[i]),
                float(s.anchor_x[i]), float(s.anchor_y[i]),
                int(s.tint[i]), float(s.alpha[i]),
            )
        else:
            radius = float(c.radius[i]) if c.radius[i] > 0 else 4.0
            _blend_disc(
                img, sx, sy, radius * zoom, _tint_rgb(int(s.tint[i])),
                float(s.alpha[i]),
            )

    # PARTICLES (dots at y + z offset)
    p = w.particles
    if p is not None and p.x.shape[0]:
        alive = np.nonzero(np.asarray(p.active & p.is_on_screen))[0]
        for k in alive[:50000]:
            sx, sy = to_screen(float(p.x[k]), float(p.y[k]) + float(p.z[k]))
            _blend_disc(
                img, sx, sy, max(1.0, 4.0 * float(p.scale[k])) * zoom,
                _tint_rgb(int(p.tint[k])), float(p.alpha[k]),
            )

    # LIGHTING multiply pass (intensity/(intensity+d²), pixi_worker.js:1206-1249)
    if cfg.lighting.enabled:
        from ..ops.lighting import light_uniforms

        u = host_arrays(light_uniforms(engine.world, cfg))
        count = int(u.count)
        if count:
            yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
            wx = (xx + off_x) / zoom
            wy = (yy + off_y) / zoom
            light = np.full((height, width), cfg.lighting.lighting_ambient, np.float32)
            light_rgb = np.zeros((height, width, 3), np.float32)
            for k in range(count):
                d2 = (wx - float(u.x[k])) ** 2 + (wy - float(u.y[k])) ** 2
                att = float(u.intensity[k]) / (float(u.intensity[k]) + d2)
                light += att
                light_rgb += att[..., None] * (_tint_rgb(int(u.color[k])) / 255.0)
            light = np.clip(light, 0.0, 1.5)
            norm = np.maximum(light[..., None], 1e-6)
            color = np.where(
                light[..., None] > cfg.lighting.lighting_ambient,
                light_rgb / norm, 1.0,
            )
            img = img * np.clip(light[..., None] * color, 0, 1.5)

    # GLOW layer (additive _lightGradient sprites ABOVE the lighting
    # multiply, z-layer 5 — pixi_worker.js:84-91, :1433-1571): one splat
    # per active light, radius at the light's half-attenuation distance
    # (d = sqrt(intensity) where intensity/(intensity+d²) = 1/2)
    if cfg.lighting.enabled:
        li = w.light
        glow_idx = np.nonzero(np.asarray(w.transform.active & li.active))[0]
        for k in glow_idx[: cfg.lighting.max_lights]:
            gx_, gy_ = to_screen(float(w.transform.x[k]), float(w.transform.y[k]))
            radius = float(np.sqrt(max(float(li.light_intensity[k]), 0.0))) * zoom
            _add_glow(img, gx_, gy_, radius, _tint_rgb(int(li.light_color[k])))

    # DEBUG overlays (flag-gated Graphics pass, pixi_worker.js:337-646)
    flags = getattr(engine.debug, "flags", {})
    if any(flags.get(k) for k in ("colliders", "velocity", "acceleration",
                                  "grid", "neighbors", "indices", "aabb",
                                  "trail")):
        t, c, rb = w.transform, w.collider, w.rigid_body
        active_idx = np.nonzero(np.asarray(t.active))[0][:2000]
        # trail history lives on the Debug object (the reference's renderer
        # keeps per-entity trail Graphics; here a host-side ring buffer)
        if flags.get("trail"):
            trails = getattr(engine.debug, "_trails", None)
            if trails is None:
                trails = {}
                engine.debug._trails = trails
            for i in active_idx[:200]:
                hist = trails.setdefault(int(i), [])
                pt = (float(t.x[i]), float(t.y[i]))
                if not hist or hist[-1] != pt:
                    hist.append(pt)
                    if len(hist) > 40:
                        hist.pop(0)
                pts = [to_screen(px, py) for px, py in hist]
                for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
                    _draw_line(img, x0, y0, x1, y1, (255, 255, 255), 0.35)
        if flags.get("grid"):
            cell = cfg.spatial.cell_size
            gx0 = int((off_x / zoom) // cell) * cell
            gy0 = int((off_y / zoom) // cell) * cell
            x_world = gx0
            while x_world * zoom - off_x < width:
                sx = x_world * zoom - off_x
                _draw_line(img, sx, 0, sx, height - 1, (60, 60, 60), 0.5)
                x_world += cell
            y_world = gy0
            while y_world * zoom - off_y < height:
                sy = y_world * zoom - off_y
                _draw_line(img, 0, sy, width - 1, sy, (60, 60, 60), 0.5)
                y_world += cell
        for i in active_idx:
            sx, sy = to_screen(float(t.x[i]), float(t.y[i]))
            if sx < -50 or sx > width + 50 or sy < -50 or sy > height + 50:
                continue
            if flags.get("colliders") and c.active[i]:
                col = (255, 255, 0) if not c.is_trigger[i] else (0, 255, 255)
                _draw_circle_outline(img, sx, sy, float(c.radius[i]) * zoom, col, 0.8)
            if flags.get("aabb") and c.active[i]:
                r = max(float(c.radius[i]) * zoom, 2.0)
                _draw_rect_outline(img, sx - r, sy - r, sx + r, sy + r,
                                   (0, 200, 255), 0.7)
            if flags.get("indices"):
                _draw_text(img, sx + 4, sy - 10, str(int(i)), (255, 255, 0), 1)
            if flags.get("velocity") and rb.active[i]:
                _draw_line(img, sx, sy, sx + float(rb.vx[i]) * 5 * zoom,
                           sy + float(rb.vy[i]) * 5 * zoom, (0, 255, 0), 0.9)
            if flags.get("acceleration") and rb.active[i]:
                _draw_line(img, sx, sy, sx + float(rb.ax[i]) * 50 * zoom,
                           sy + float(rb.ay[i]) * 50 * zoom, (255, 0, 255), 0.9)
        if flags.get("neighbors"):
            # mouse-nearest neighbor links (pixi_worker's neighbor overlay
            # visualizes the entity nearest the mouse)
            mx, my = engine.input.mouse_x, engine.input.mouse_y
            xs_all = np.asarray(t.x)
            ys_all = np.asarray(t.y)
            act = np.asarray(t.active)
            if act[1:].any():
                cand = np.nonzero(act)[0]
                cand = cand[cand != 0]
                d2 = (xs_all[cand] - mx) ** 2 + (ys_all[cand] - my) ** 2
                star = int(cand[np.argmin(d2)])
                vr = float(np.asarray(w.collider.visual_range)[star])
                s0x, s0y = to_screen(float(xs_all[star]), float(ys_all[star]))
                _draw_circle_outline(img, s0x, s0y, vr * zoom, (255, 128, 0), 0.9)
                near = cand[((xs_all[cand] - xs_all[star]) ** 2
                             + (ys_all[cand] - ys_all[star]) ** 2) < vr * vr]
                for j in near[:100]:
                    if j == star:
                        continue
                    s1x, s1y = to_screen(float(xs_all[j]), float(ys_all[j]))
                    _draw_line(img, s0x, s0y, s1x, s1y, (255, 128, 0), 0.5)

    # fps / info text panels (the DOM stats panel + Debug fps overlay,
    # gameEngine.js:1326-1381, Debug.js fps/info flags)
    if flags.get("fps") or flags.get("info"):
        lines = []
        if flags.get("fps"):
            lines.append(f"{engine.timer.steps_per_sec:.1f} steps/s")
        if flags.get("info"):
            active = int(np.asarray(w.transform.active).sum())
            lines.append(f"step: {int(w.step_count)}")
            lines.append(f"entities: {active}")
            if w.particles is not None and w.particles.x.shape[0]:
                lines.append(f"particles: {int(np.asarray(w.particles.active).sum())}")
        for k, line in enumerate(lines):
            _draw_text(img, 8, 8 + k * 14, line, (160, 255, 160), 2)

    img = np.clip(img, 0, 255).astype(np.uint8)
    if path:
        write_png(path, img)
    return img
