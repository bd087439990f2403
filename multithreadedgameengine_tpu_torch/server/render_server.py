"""Live browser renderer: HTTP server streaming render packets to a canvas
client — the host-side replacement for the reference's renderer worker +
dev server (src/workers/pixi_worker.js; server/node_server.js, whose COOP/
COEP headers existed only to unlock SharedArrayBuffer — no longer needed, but
set anyway for parity).

Data plane: the simulation loop calls :meth:`RenderServer.publish` after
stepping; the server snapshots the engine's on-device-compacted RenderPacket
(+ particles, shadow sprites, light uniforms) into one little-endian binary
frame that the browser parses into typed arrays — the PCIe analog of the
reference's SAB reads. Decals stream separately as PNG (the dirty-tile
texture upload analog, pixi_worker.js:1067-1107).

Control plane: the client POSTs mouse/keyboard/camera to /input
(the main-thread event listeners, gameEngine.js:1384-1500).

PyTorch port of ``multithreadedgameengine_tpu/server/render_server.py``.
A frame's bytes are the reference's, byte for byte, for the same world. Its
device reads differ: :func:`encode_frame` compacts each section on the card
(the packet, the radii and debug lanes at the packet's rows, the first
20,000 live on-screen particles, the shadow sprites, the light uniforms)
and brings them to the host in one copy (``render.extract.host_copy``),
where the reference makes five to seven ``jax.device_get`` calls, each of
which waits for the device. Only :meth:`RenderServer.publish` and
:meth:`RenderServer.apply_inputs`, called from the simulation thread, touch
the engine's tensors: HTTP threads serve the bytes of the last publish (the
frame, the decal PNG, the stats) and host-side state (the config, the
sprite overrides).

Run a demo:
``python -m multithreadedgameengine_tpu_torch.server.render_server --scene balls``
"""

from __future__ import annotations

import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops.lighting import light_uniforms
from ..ops.particles import first_k_where
from ..render.extract import extract_render_packet, host_copy

MAGIC = 0x57454544  # "WEED"


#: per-entity lanes in the frame's entity section (little-endian f32);
#: numeric ids ride as exact floats (< 2^24)
ENT_LANES = 13  # x y rot sx sy alpha tint frame anchor_x anchor_y sheet anim index


def _frame_tensors(engine, max_visible: int):
    """The device tensors a frame reads, each of a fixed shape: the packet
    (``[V]`` rows), the radius and the (vx, vy, ax, ay) lanes at its rows,
    the pool's first 20,000 live on-screen particle slots in index order
    with their count, the shadow sprites, the light uniforms. Nothing here
    waits for the card."""
    w, cfg = engine.world, engine.config
    v = max_visible or min(w.n_entities, 65536)
    pkt = extract_render_packet(w, cfg, v)
    rows = pkt.index.clamp(min=0).to(torch.int64)
    rb = w.rigid_body
    out = dict(pkt.__dict__)
    out["radius"] = w.collider.radius[rows]
    flags = engine.debug.flags
    if flags.get("velocity") or flags.get("acceleration"):
        out["dbg"] = torch.stack([rb.vx[rows], rb.vy[rows], rb.ax[rows], rb.ay[rows]], dim=1)
    p = w.particles
    if p is not None:
        live = p.active & p.is_on_screen
        sel = first_k_where(live, 20000)
        out["p_count"] = torch.clamp(torch.sum(live, dtype=torch.int32), max=20000)
        for f in ("x", "y", "z", "scale", "alpha", "tint"):
            out["p_" + f] = getattr(p, f)[sel]
    ss = w.shadow_sprites
    if ss is not None:
        for f in ("active", "x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius"):
            out["s_" + f] = getattr(ss, f)
    if cfg.lighting.enabled:
        u = light_uniforms(w, cfg)
        for f in ("count", "x", "y", "intensity", "color", "height"):
            out["l_" + f] = getattr(u, f)
    return out


def encode_frame(engine, max_visible: int = 20000) -> bytes:
    """One binary frame: [magic, step, n_entities, n_particles, n_shadows,
    n_lights, debug_mask, reserved] header + per-section typed arrays
    (little-endian). When velocity/acceleration debug flags are on, a
    [n_entities, 4] (vx, vy, ax, ay) section follows the radius section.
    The card's tensors come to the host in one copy."""
    engine._require_init()
    from ..debugging import FLAG_NAMES

    flags = engine.debug.flags
    debug_mask = sum(1 << k for k, n in enumerate(FLAG_NAMES) if flags.get(n))
    dev = _frame_tensors(engine, max_visible)
    names = list(dev)
    h = {k: t.numpy() for k, t in zip(names, host_copy([dev[k] for k in names]))}
    count = int(h["count"])

    out = io.BytesIO()
    # entities
    ent = np.stack(
        [
            np.asarray(h["x"][:count], np.float32),
            np.asarray(h["y"][:count], np.float32),
            np.asarray(h["rotation"][:count], np.float32),
            np.asarray(h["scale_x"][:count], np.float32),
            np.asarray(h["scale_y"][:count], np.float32),
            np.asarray(h["alpha"][:count], np.float32),
            np.asarray(h["tint"][:count], np.uint32).astype(np.float32),
            np.asarray(h["animation_frame"][:count], np.float32),
            np.asarray(h["anchor_x"][:count], np.float32),
            np.asarray(h["anchor_y"][:count], np.float32),
            np.asarray(h["spritesheet_id"][:count], np.float32),
            np.asarray(h["animation_state"][:count], np.float32),
            np.asarray(h["index"][:count], np.float32),
        ],
        axis=1,
    ).astype("<f4") if count else np.zeros((0, ENT_LANES), "<f4")
    # radius for colliders/debug
    radius = h["radius"][:count].astype("<f4") if count else np.zeros((0,), "<f4")
    # velocity/acceleration overlay data, only when a flag wants it
    if count and "dbg" in h:
        dbg = h["dbg"][:count].astype("<f4")
    else:
        dbg = np.zeros((0, 4), "<f4")

    n_p = int(h["p_count"]) if "p_count" in h else 0
    parts = np.stack(
        [
            h["p_x"][:n_p], h["p_y"][:n_p] + h["p_z"][:n_p],
            h["p_scale"][:n_p], h["p_alpha"][:n_p],
            h["p_tint"][:n_p].astype(np.float32),
        ],
        axis=1,
    ).astype("<f4") if n_p else np.zeros((0, 5), "<f4")

    son = np.nonzero(h["s_active"])[0] if "s_active" in h else np.zeros(0, int)
    shadows = np.stack(
        [
            h["s_x"][son], h["s_y"][son],
            h["s_rotation"][son], h["s_scale_x"][son],
            h["s_scale_y"][son], h["s_alpha"][son],
            h["s_radius"][son],
        ],
        axis=1,
    ).astype("<f4") if len(son) else np.zeros((0, 7), "<f4")

    lights = np.zeros((0, 5), "<f4")
    if "l_count" in h:
        lc = int(h["l_count"])
        lights = np.stack(
            [
                h["l_x"][:lc], h["l_y"][:lc],
                h["l_intensity"][:lc],
                h["l_color"][:lc].astype(np.float32),
                h["l_height"][:lc],
            ],
            axis=1,
        ).astype("<f4") if lc else lights

    step = int(engine.world.step_count)
    out.write(struct.pack(
        "<IIIIIIII", MAGIC, step, count, parts.shape[0], shadows.shape[0],
        lights.shape[0], debug_mask, dbg.shape[0],
    ))
    out.write(ent.tobytes())
    out.write(radius.tobytes())
    out.write(dbg.tobytes())
    out.write(parts.tobytes())
    out.write(shadows.tobytes())
    out.write(lights.tobytes())
    return out.getvalue()


def atlas_payload(engine, atlas) -> dict:
    """Numeric-id frame map for the browser client: for every registered
    sheet and animation (engine.sprites ids — the SAME ids the device stores
    in spritesheet_id/animation_state), the ordered list of atlas rects; for
    every static texture id, its rect. Mirrors the frame-texture tables the
    reference renderer builds from the atlas json (pixi_worker.js:1683-1822).
    Sheets may cover a subset of animations — renderers fall back for the
    rest."""
    frames = atlas.frames
    sheets: dict = {}
    reg = engine.sprites
    for meta in reg.sheets:
        sid = meta.sheet_id
        anims: dict = {}
        for a_idx, (anim, n) in enumerate(zip(meta.animations, meta.frame_counts)):
            rects = []
            for k in range(n):
                fr = frames.get(f"{meta.name}/{anim}_{k}")
                if fr is None:
                    break
                f = fr["frame"]
                rects.append([f["x"], f["y"], f["w"], f["h"]])
            if rects:
                anims[a_idx] = rects
        if anims:
            sheets[sid] = anims
    textures = {}
    for name, tid in reg.textures.items():
        fr = frames.get(name)
        if fr is not None:
            f = fr["frame"]
            textures[tid] = [f["x"], f["y"], f["w"], f["h"]]
    return {
        "size": list(atlas.image.shape[:2][::-1]),
        "sheets": sheets,
        "textures": textures,
    }


class RenderServer:
    """Publish/serve split: the sim thread calls publish(); HTTP threads only
    read the latest published bytes (the frame, the decal PNG, the stats)
    and host-side state (the config, the sprite overrides)."""

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 8000,
                 atlas=None):
        self.engine = engine
        if atlas is None:
            atlas = getattr(engine, "atlas", None)  # engine.load_assets()
        self._frame: bytes = b""
        self._decal_png: bytes = b""
        self._atlas_png: bytes = b""
        self._atlas_json: bytes = b"{}"
        self._stats: bytes = b"{}"
        if atlas is not None:
            from ..render.headless import encode_png

            self._atlas_png = encode_png(atlas.image)
            self._atlas_json = json.dumps(atlas_payload(engine, atlas)).encode()
        self._lock = threading.Lock()
        self._inputs: dict = {}
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "RenderServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and close the socket."""
        self.httpd.shutdown()
        self.httpd.server_close()

    def publish(self, include_decals: bool = False) -> None:
        """Encode the engine's current frame (and, with ``include_decals``,
        the decal canvas as a PNG) and the stats for the HTTP threads."""
        frame = encode_frame(self.engine)
        stats = json.dumps(self.engine.stats()).encode()
        png = b""
        canvas = self.engine.world.decal_canvas
        if include_decals and canvas is not None and canvas.shape[0] > 1:
            from ..render.headless import encode_png

            png = encode_png(canvas.cpu().numpy())  # RGBA: decals composite over the bg
        with self._lock:
            self._frame = frame
            self._stats = stats
            if png:
                self._decal_png = png

    def apply_inputs(self) -> None:
        """Apply the latest client inputs to the engine's InputController
        (call from the sim thread between steps)."""
        with self._lock:
            data, self._inputs = self._inputs, {}
        if not data:
            return
        inp = self.engine.input
        if "mouse_x" in data:
            inp.set_mouse(data["mouse_x"], data["mouse_y"], True)
        if "button0" in data:
            inp.mouse_button(0, bool(data["button0"]))
        if "camera" in data:
            inp.camera_x, inp.camera_y, inp.camera_zoom = data["camera"]
        for key in data.get("keys_down", []):
            try:
                inp.key_down(key)
            except KeyError:
                pass
        for key in data.get("keys_up", []):
            try:
                inp.key_up(key)
            except KeyError:
                pass
        for name in data.get("debug_toggle", []):
            # the demos' 1-5/0 debug shortcuts (balls index.html:192-206)
            if name == "all_off":
                self.engine.debug.disable_all()
            elif name in self.engine.debug.flags:
                self.engine.debug.flags[name] = not self.engine.debug.flags[name]

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _headers(self, code, ctype, body_len):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(body_len))
                # COOP/COEP parity with server/node_server.js:66-69
                self.send_header("Cross-Origin-Opener-Policy", "same-origin")
                self.send_header("Cross-Origin-Embedder-Policy", "require-corp")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = (Path(__file__).parent / "client.html").read_bytes()
                    self._headers(200, "text/html", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/frame"):
                    with server._lock:
                        body = server._frame
                    self._headers(200, "application/octet-stream", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/decals"):
                    with server._lock:
                        body = server._decal_png
                    self._headers(200, "image/png", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/atlas.json"):
                    body = server._atlas_json
                    self._headers(200, "application/json", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/atlas"):
                    body = server._atlas_png
                    self._headers(200, "image/png", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/config"):
                    cfg = server.engine.config
                    body = json.dumps({
                        "world_width": cfg.world_width,
                        "world_height": cfg.world_height,
                        "canvas_width": cfg.canvas_width,
                        "canvas_height": cfg.canvas_height,
                        "lighting": cfg.lighting.enabled,
                        "ambient": cfg.lighting.lighting_ambient,
                        "cell_size": cfg.spatial.cell_size,
                    }).encode()
                    self._headers(200, "application/json", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/stats"):
                    with server._lock:
                        body = server._stats
                    self._headers(200, "application/json", len(body))
                    self.wfile.write(body)
                elif self.path.startswith("/overrides"):
                    # sprite-override RPC plane (gameObject.js:546-582 →
                    # pixi_worker.js:2009-2053): persistent prop table +
                    # seq-numbered one-shot method calls
                    body = json.dumps(
                        server.engine.sprite_overrides_payload()
                    ).encode()
                    self._headers(200, "application/json", len(body))
                    self.wfile.write(body)
                else:
                    self._headers(404, "text/plain", 0)

            def do_POST(self):
                if self.path.startswith("/input"):
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length) or b"{}")
                    with server._lock:
                        server._inputs.update(data)
                    self._headers(204, "text/plain", 0)
                else:
                    self._headers(404, "text/plain", 0)

        return Handler


def build_demo_atlas(engine):
    """Pack procedurally generated character sheets + textures for every
    sheet/texture the engine registered (render/procgen.py — same frame
    layout and animation names as the reference's LPC art, no third-party
    assets), through the engine-level preload (Engine.load_assets — the
    preloadAssets flow, gameEngine.js:805-889). The atlas frames key by
    the ENGINE registry's names, so atlas_payload's numeric-id mapping
    lines up with device state."""
    from ..render.procgen import make_character_sheet, make_demo_textures

    reg = engine.sprites
    sheets = {}
    for meta in reg.sheets:
        sheets[meta.name] = make_character_sheet(seed=0xC1B1 + meta.sheet_id)
    textures = {
        name: img for name, img in make_demo_textures().items()
        if name in reg.textures
    }
    return engine.load_assets(
        images=textures, sheets=sheets, atlas_size=2048
    )


def run_scene(scene: str = "balls", n: int = 0, port: int = 8000,
              steps_per_publish: int = 2, max_steps: Optional[int] = None,
              device="cuda") -> RenderServer:
    """The demo loop: build a scene, start the server, free-run the sim loop
    (the main-thread rAF loop analog, gameEngine.js:1514-1573) until
    ``max_steps`` or Ctrl-C; returns the stopped server. The scene runs on
    ``device``: the card unless the caller asks for ``"cpu"``."""
    atlas = None
    if scene == "balls":
        from ..models.balls import make_balls_engine

        eng = make_balls_engine(n_balls=n or 10_000, seed=123456, device=device)
    elif scene == "predators":
        from ..models.predators import make_predators_engine

        eng = make_predators_engine(n_prey=n or 15_000, device=device)
        atlas = build_demo_atlas(eng)
    else:
        raise ValueError(f"unknown scene {scene!r}")

    srv = RenderServer(eng, port=port, atlas=atlas).start()
    print(f"render server on http://localhost:{srv.port}/ — Ctrl-C to stop")
    steps = 0
    try:
        while max_steps is None or steps < max_steps:
            srv.apply_inputs()
            eng.step(steps_per_publish)
            steps += steps_per_publish
            srv.publish(include_decals=(steps % 60 == 0))
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return srv


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="balls", choices=["balls", "predators"])
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args()
    run_scene(args.scene, args.n, args.port, max_steps=args.max_steps)
