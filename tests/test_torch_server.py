"""The render server of the PyTorch port (ROADMAP item 17) against the JAX
package's, on localhost with ephemeral ports.

The bar for a frame is the reference's bytes: a JAX world is carried into
the port (``interop.world_from_jax``) and both packages' ``encode_frame``
must give the same bytes, with and without the debug section, on the balls
scene and on the predators scene with particles, decals, shadows and
lights; so must the atlas payload and the decal PNG of a publish. The
reference's ``tests/test_server.py`` (the frame protocol, the HTTP and
atlas endpoints, the input round trip, the sprite overrides) runs through
the port.
"""

import json
import struct
import urllib.request

import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_predators
from multithreadedgameengine_tpu.server import render_server as ref_server
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine
from multithreadedgameengine_tpu_torch.render.atlas import decode_png
from multithreadedgameengine_tpu_torch.server import RenderServer
from multithreadedgameengine_tpu_torch.server.render_server import (
    ENT_LANES,
    MAGIC,
    atlas_payload,
    build_demo_atlas,
    encode_frame,
)

torch.set_num_threads(2)


def _balls(pkg):
    make = ref_balls if pkg == "jax" else make_balls_engine
    kw = dict(n_balls=50, spawn=False, seed=3, world_width=1000.0, world_height=700.0)
    eng = make(**kw) if pkg == "jax" else make(device="cpu", **kw)
    for _ in range(30):
        eng.spawn("Ball", x=eng.rng() * 1000.0, y=eng.rng() * 700.0)
    return eng


def _predators(pkg):
    kw = dict(n_prey=60, n_predators=2, n_lights=2, world_width=1200.0, world_height=800.0)
    eng = ref_predators(**kw) if pkg == "jax" else make_predators_engine(device="cpu", **kw)
    (ref_server.build_demo_atlas if pkg == "jax" else build_demo_atlas)(eng)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    return eng


def _pair(make, frames, blood=False):
    """A JAX engine stepped ``frames`` frames and a port engine holding its
    world."""
    ej, et = make("jax"), make("torch")
    if blood:  # particles land and stamp decals
        ej.emitter.emit(count=60, x=400.0, y=300.0, z=-20.0, lifespan=9000.0)
    ej.step(frames)
    et.step(1)
    et.restore(world_from_jax(ej.snapshot(), "cpu", et._plan.solver_geom))
    return ej, et


@pytest.fixture(scope="module")
def balls_pair():
    return _pair(_balls, 3)


@pytest.fixture(scope="module")
def predators_pair():
    return _pair(_predators, 30, blood=True)


@pytest.mark.parametrize("scene", ["balls_pair", "predators_pair"])
@pytest.mark.parametrize("flags", [(), ("velocity",), ("acceleration", "colliders")],
                         ids=["plain", "velocity", "acceleration"])
def test_encode_frame_bytes_match_reference(scene, flags, request):
    ej, et = request.getfixturevalue(scene)
    for e in (ej, et):
        e.debug.disable_all()
        for f in flags:
            e.debug._set(f, True)
    try:
        a, b = ref_server.encode_frame(ej), encode_frame(et)
    finally:
        for e in (ej, et):
            e.debug.disable_all()
    assert b == a
    _magic, _step, n_e, n_p, n_s, n_l, _mask, n_dbg = struct.unpack_from("<IIIIIIII", b, 0)
    assert n_e > 0 and n_dbg == (n_e if flags else 0)
    if scene == "predators_pair":  # every section is there
        assert n_p > 0 and n_s > 0 and n_l > 0


def test_atlas_payload_and_decals_match_reference(predators_pair):
    ej, et = predators_pair
    assert atlas_payload(et, et.atlas) == ref_server.atlas_payload(ej, ej.atlas)
    sa = ref_server.RenderServer(ej, port=0, atlas=ej.atlas)
    sb = RenderServer(et, port=0, atlas=et.atlas)
    try:
        sa.publish(include_decals=True)
        sb.publish(include_decals=True)
        assert sb._decal_png and sb._decal_png == sa._decal_png
        assert sb._atlas_png == sa._atlas_png and sb._atlas_json == sa._atlas_json
        assert sb._frame == sa._frame
    finally:
        sa.httpd.server_close()
        sb.httpd.server_close()


@pytest.fixture(scope="module")
def served():
    eng = _balls("torch")
    eng.step(3)
    srv = RenderServer(eng, port=0).start()  # ephemeral port
    srv.publish()
    yield eng, srv
    srv.stop()


def get(srv, path):
    return urllib.request.urlopen(f"http://localhost:{srv.port}{path}", timeout=10)


class TestFrameProtocol:
    """``tests/test_server.py::TestFrameProtocol`` through the port."""

    def test_encode_and_parse(self, served):
        eng, _ = served
        buf = encode_frame(eng)
        magic, step, n_e, n_p, n_s, n_l, dbg_mask, n_dbg = struct.unpack_from(
            "<IIIIIIII", buf, 0)
        assert magic == MAGIC and step == 3
        assert n_e > 0 and n_e == int(eng.render_packet().count)
        assert dbg_mask == 0 and n_dbg == 0
        ent = np.frombuffer(buf, "<f4", n_e * ENT_LANES, 32).reshape(n_e, ENT_LANES)
        assert np.isfinite(ent).all()
        assert (ent[:, 0] >= 0).all() and (ent[:, 0] <= 1000.0).all()
        assert (ent[:, 12] >= 0).all() and (ent[:, 12] < 51).all()
        rad = np.frombuffer(buf, "<f4", n_e, 32 + n_e * ENT_LANES * 4)
        assert (rad >= 0).all() and (rad <= 30.0).all()

    def test_debug_section_present_when_flagged(self, served):
        eng, _ = served
        eng.debug.show_velocity()
        buf = encode_frame(eng)
        _, _, n_e, _, _, _, dbg_mask, n_dbg = struct.unpack_from("<IIIIIIII", buf, 0)
        assert dbg_mask & (1 << 1)  # velocity bit
        assert n_dbg == n_e
        eng.debug.disable_all()

    def test_http_endpoints(self, served):
        eng, srv = served
        cfg = json.loads(get(srv, "/config").read())
        assert cfg["world_width"] == 1000.0
        stats = json.loads(get(srv, "/stats").read())
        assert stats["pools"]["Ball"]["active"] == 30
        assert stats["active_count"] == 31
        frame = get(srv, "/frame").read()
        assert struct.unpack_from("<I", frame, 0)[0] == MAGIC
        page = get(srv, "/").read()
        assert b"<canvas" in page
        assert get(srv, "/decals").read() == b""  # the balls scene has no canvas
        with pytest.raises(urllib.error.HTTPError):
            get(srv, "/nothing")

    def test_http_serves_the_last_publish(self, served):
        """HTTP threads read published bytes only: stepping changes nothing
        they serve until the next publish."""
        eng, srv = served
        before = get(srv, "/frame").read(), get(srv, "/stats").read()
        eng.step(1)
        assert (get(srv, "/frame").read(), get(srv, "/stats").read()) == before
        srv.publish()
        frame = get(srv, "/frame").read()
        assert struct.unpack_from("<II", frame, 0)[1] == eng.world.step_count
        assert json.loads(get(srv, "/stats").read())["total_steps"] == eng.timer.total_steps

    def test_atlas_endpoints(self):
        eng = make_predators_engine(n_prey=4, n_predators=1, n_lights=1, device="cpu",
                                    particle=dict(max_particles=0),
                                    lighting=dict(enabled=False))
        atlas = build_demo_atlas(eng)
        srv = RenderServer(eng, port=0, atlas=atlas).start()
        try:
            img = decode_png(get(srv, "/atlas").read())
            assert img.shape[2] == 4 and img.shape[0] >= 1024
            payload = json.loads(get(srv, "/atlas.json").read())
            sid = eng.sprites.sheet_id("civil1")
            a_idx = eng.sprites.animation_index("civil1", "walk_down")
            rects = payload["sheets"][str(sid)][str(a_idx)]
            assert len(rects) == 9
            x, y, w, h = rects[0]
            assert w == 64 and h == 64
            assert img[y:y + h, x:x + w, 3].sum() > 0
            tid = eng.sprites.texture_id("bunny")
            assert str(tid) in payload["textures"]
        finally:
            srv.stop()

    def test_input_roundtrip(self, served):
        eng, srv = served
        body = json.dumps({"mouse_x": 123.0, "mouse_y": 45.0, "button0": 1,
                           "keys_down": ["m", "no-such-key"], "camera": [5.0, 6.0, 2.0],
                           "debug_toggle": ["grid"]}).encode()
        req = urllib.request.Request(
            f"http://localhost:{srv.port}/input", data=body, method="POST")
        urllib.request.urlopen(req, timeout=10)
        srv.apply_inputs()
        assert eng.input.mouse_x == 123.0
        assert eng.input.mouse_is_down
        assert eng.input.is_down("m")
        assert eng.input.camera_zoom == 2.0
        assert eng.debug.flags["grid"]
        eng.debug.disable_all()
        eng.input.set_camera(x=500.0, y=350.0, zoom=1.0)


class TestSpriteOverrides:
    """``tests/test_server.py::TestSpriteOverrides`` through the port."""

    def test_override_through_server(self, served):
        eng, srv = served
        eng.set_sprite_prop(3, "tint", 0xFF0000)
        eng.set_sprite_prop(3, "alpha", 0.25)
        eng.call_sprite_method(7, "gotoAndStop", 2)
        o = json.loads(get(srv, "/overrides").read())
        assert o["props"]["3"] == {"tint": 0xFF0000, "alpha": 0.25}
        assert o["calls"][-1]["index"] == 7
        assert o["calls"][-1]["method"] == "gotoAndStop"
        assert o["calls"][-1]["args"] == [2]
        seq = o["calls"][-1]["seq"]
        eng.call_sprite_method(7, "setVisible", False)
        o2 = json.loads(get(srv, "/overrides").read())
        assert o2["calls"][-1]["seq"] == seq + 1
        eng.set_sprite_prop(3, "alpha", None)
        o3 = json.loads(get(srv, "/overrides").read())
        assert o3["props"]["3"] == {"tint": 0xFF0000}
        eng.set_sprite_prop(3, "tint", None)
        assert "3" not in json.loads(get(srv, "/overrides").read())["props"]
        page = get(srv, "/").read().decode()
        assert "/overrides" in page and "gotoAndStop" in page

    def test_payload_matches_reference(self):
        """The same calls give the reference's payload; the call queue keeps
        the last 512."""
        ej, et = ref_balls(n_balls=4, seed=1), make_balls_engine(n_balls=4, seed=1,
                                                                 device="cpu")
        for e in (ej, et):
            e.set_sprite_prop(1, "tint", 0x00FF00)
            e.set_sprite_prop(2, "visible", False)
            e.set_sprite_prop(2, "visible", None)
            for k in range(520):
                e.call_sprite_method(k % 5, "play", k)
        assert et.sprite_overrides_payload() == ej.sprite_overrides_payload()
        assert len(et.sprite_overrides_payload()["calls"]) == 512


def test_run_scene_drives_the_server():
    """``run_scene`` on the CPU with a step budget: it publishes every 2
    steps and stops its server."""
    from multithreadedgameengine_tpu_torch.server.render_server import run_scene

    srv = run_scene("balls", n=60, port=0, max_steps=4, device="cpu")
    assert srv.engine.world.step_count == 4
    frame = srv._frame
    assert struct.unpack_from("<II", frame, 0) == (MAGIC, 4)
