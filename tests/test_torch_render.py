"""The render path of the PyTorch port (ROADMAP item 17) against the JAX
package: the render packet, the animation advance, ``Engine.screenshot``
and every debug overlay of the headless renderer.

The bar is identity for the same world: a JAX world is carried into the
port with ``interop.world_from_jax`` and the port's engine (the same scene,
camera and debug flags) renders it. Packets must match field by field, and
images and PNG bytes byte for byte: the headless renderer is numpy over the
world's host copy in both packages. The fps overlay prints the step timer,
so both engines get one timer reading 60 steps/s. The reference's own
render tests (``tests/test_render.py``) also run through the port, on the
port's own frames.
"""

import jax
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_predators
from multithreadedgameengine_tpu.render import headless as ref_headless
from multithreadedgameengine_tpu.server.render_server import build_demo_atlas as ref_atlas
from multithreadedgameengine_tpu_torch.debugging import FLAG_NAMES
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine
from multithreadedgameengine_tpu_torch.render import headless
from multithreadedgameengine_tpu_torch.render.extract import RenderPacket
from multithreadedgameengine_tpu_torch.server.render_server import build_demo_atlas

torch.set_num_threads(2)

BALLS = dict(n_balls=80, spawn=False, seed=11, world_width=1500.0, world_height=1000.0)
PREDATORS = dict(n_prey=60, n_predators=2, n_lights=2, world_width=1200.0,
                 world_height=800.0)


def _balls(pkg, **over):
    make = ref_balls if pkg == "jax" else make_balls_engine
    kw = dict(BALLS, **over)
    eng = make(**kw) if pkg == "jax" else make(device="cpu", **kw)
    for _ in range(60):  # the reference test's spawns, from the seeded stream
        eng.spawn("Ball", x=eng.rng() * 1500.0, y=eng.rng() * 1000.0)
    eng.input.camera_x = 0.0
    eng.input.camera_y = 0.0
    return eng


def _predators(pkg):
    eng = ref_predators(**PREDATORS) if pkg == "jax" else make_predators_engine(
        device="cpu", **PREDATORS)
    (ref_atlas if pkg == "jax" else build_demo_atlas)(eng)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    return eng


class _Timer:
    steps_per_sec = 60.0


def _hand_over(ej, et):
    """The port engine takes the JAX engine's current world."""
    et.step(1)  # the port's plan, and its geometry for the solver caches
    et.restore(world_from_jax(ej.snapshot(), "cpu", et._plan.solver_geom))


@pytest.fixture(scope="module")
def balls():
    ej, et = _balls("jax"), _balls("torch")
    ej.step(3)
    _hand_over(ej, et)
    return ej, et


@pytest.fixture(scope="module")
def predators():
    ej, et = _predators("jax"), _predators("torch")
    ej.emitter.emit(count=40, x=300.0, y=300.0, z=-10.0, lifespan=9000.0)
    ej.step(4)
    _hand_over(ej, et)
    return ej, et


def _assert_packets_equal(a, b: RenderPacket):
    assert int(b.count) == int(a.count)
    for f in ("index", "x", "y", "screen_x", "screen_y", "rotation", "scale_x", "scale_y",
              "anchor_x", "anchor_y", "tint", "alpha", "spritesheet_id",
              "animation_state", "animation_frame", "z_offset"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)


@pytest.mark.parametrize("scene", ["balls", "predators"])
@pytest.mark.parametrize("max_visible", [0, 25])
def test_packet_matches_reference(scene, max_visible, request):
    ej, et = request.getfixturevalue(scene)
    a, b = ej.render_packet(max_visible), et.render_packet(max_visible)
    assert b.count.device.type == "cpu" and b.tint.dtype == torch.int64
    assert b.index.shape == ((max_visible or et.world.n_entities),)
    _assert_packets_equal(a, b)


def test_packet_unsorted_matches_reference():
    """``renderer.y_sorting`` off: the visible entities in index order."""
    ej, et = _balls("jax", renderer=dict(y_sorting=False)), _balls(
        "torch", renderer=dict(y_sorting=False))
    ej.step(2)
    _hand_over(ej, et)
    b = et.render_packet()
    count = int(b.count)
    assert np.all(np.diff(b.index[:count].numpy()) > 0)
    _assert_packets_equal(ej.render_packet(), b)


class TestRenderPacket:
    """``tests/test_render.py::TestRenderPacket`` through the port, on the
    port's own frames."""

    @pytest.fixture(scope="class")
    def scene(self):
        eng = _balls("torch")
        eng.step(3)
        return eng

    def test_packet_contains_visible_only(self, scene):
        pkt = scene.render_packet()
        count = int(pkt.count)
        assert count > 0
        w = scene.world
        vis = (w.transform.active & w.sprite.active & w.sprite.render_visible
               & w.sprite.is_on_screen).numpy()
        assert count == vis.sum()
        ids = pkt.index[:count].numpy()
        assert np.all(ids >= 0)
        assert set(ids.tolist()) == set(np.nonzero(vis)[0].tolist())
        assert np.all(pkt.index[count:].numpy() == -1)

    def test_y_sorted(self, scene):
        pkt = scene.render_packet()
        count = int(pkt.count)
        assert np.all(np.diff(pkt.y[:count].numpy()) >= 0)

    def test_fields_match_world(self, scene):
        pkt = scene.render_packet()
        w = scene.world
        i = int(pkt.index[0])
        assert pkt.x[0] == w.transform.x[i]
        assert pkt.tint[0] == w.sprite.tint[i]
        assert pkt.scale_x[0] == w.sprite.scale_x[i]


def test_animation_frames_advance_and_wrap():
    """``tests/test_render.py::TestAnimationAdvance`` through the port, and
    the frames equal the JAX engine's, frame by frame, from one world."""
    kw = dict(n_prey=5, n_predators=0, n_lights=0)
    ej, et = ref_predators(**kw), make_predators_engine(device="cpu", **kw)
    _hand_over(ej, et)
    reg = et.classes["Prey"]
    sl = slice(reg.start_index, reg.start_index + 5)
    frames = []
    for _ in range(30):
        ej.step(1)
        et.step(1)
        f = et.world.sprite.animation_frame.numpy()
        np.testing.assert_array_equal(f, np.asarray(jax.device_get(ej.world).sprite.animation_frame))
        frames.append(f[sl].copy())
    frames = np.stack(frames)
    assert len(np.unique(frames)) > 1
    assert 0 <= frames.min() and frames.max() <= 12


@pytest.mark.parametrize("scene", ["balls", "predators"])
def test_screenshot_png_identical(scene, request, tmp_path):
    ej, et = request.getfixturevalue(scene)
    pa, pb = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    a = ej.screenshot(pa, width=320, height=200)
    b = et.screenshot(pb, width=320, height=200)
    assert b.shape == (200, 320, 3) and b.dtype == np.uint8
    np.testing.assert_array_equal(b, a)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        ba, bb = fa.read(), fb.read()
    assert bb[:8] == b"\x89PNG\r\n\x1a\n" and bb == ba
    assert (b.std(axis=2) > 5).sum() > 10  # something is drawn
    if scene == "predators":
        np.testing.assert_array_equal(et.atlas.image, ej.atlas.image)


@pytest.mark.parametrize("flag", [f for f in FLAG_NAMES if f != "profiler"])
def test_debug_overlay_identical(flag, balls):
    """Every overlay the headless renderer draws, on the same world: the
    same pixels in both packages, and not the plain frame."""
    ej, et = balls
    base = headless.render_frame(et, 320, 240)
    timers = ej.timer, et.timer
    for e in (ej, et):
        e.debug.disable_all()
        e.debug._set(flag, True)
        e.debug._trails = {}
        if flag == "fps":
            e.timer = _Timer()
    if flag == "trail":  # two positions a trail point each
        ref_headless.render_frame(ej, 320, 240)
        headless.render_frame(et, 320, 240)
        ej.step(2)
        et.restore(world_from_jax(ej.snapshot(), "cpu"))
    try:
        a = ref_headless.render_frame(ej, 320, 240)
        b = headless.render_frame(et, 320, 240)
    finally:
        for e in (ej, et):
            e.debug.disable_all()
        ej.timer, et.timer = timers
    np.testing.assert_array_equal(b, a)
    assert ref_headless.encode_png(a) == headless.encode_png(b)
    if flag != "trail":
        assert (b != base).any(), f"{flag} overlay drew nothing"


def test_micro_font_digits():
    img = np.zeros((20, 80, 3), np.float32)
    headless._draw_text(img, 1, 1, "0123456789.5", (255, 255, 255), 2)
    ref = np.zeros_like(img)
    ref_headless._draw_text(ref, 1, 1, "0123456789.5", (255, 255, 255), 2)
    assert (img > 0).any()
    np.testing.assert_array_equal(img, ref)
