"""The port's asset pipeline and tools (ROADMAP item 17) against the JAX
package: its copies of ``render/atlas.py`` and ``render/procgen.py``, the
texture packer and sprite visualizer CLIs, ``Engine.load_assets`` (with the
constructor's ``images=``/``sheets=``), and the headless renderer's atlas
sprites and light glows.

The bar is the reference's output for the same input, exactly: atlas
pixels and frame tables, registry ids, PNG bytes, CLI files, rendered
images (for the engine cases, the port renders the JAX engine's world,
carried across with ``interop.world_from_jax``). The reference's own tests
(``tests/test_atlas.py``, ``tests/test_tools.py``,
``tests/test_round4.py::TestEngineAssetPreload`` and
``::TestHeadlessSpritesAndGlow``) also run through the port.
"""

import json
import os

import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref_pkg
from multithreadedgameengine_tpu.assets import SpriteRegistry as RefRegistry
from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_predators
from multithreadedgameengine_tpu.render import atlas as ref_atlas
from multithreadedgameengine_tpu.render import headless as ref_headless
from multithreadedgameengine_tpu.render import procgen as ref_procgen
from multithreadedgameengine_tpu.tools import sprite_visualizer as ref_viz
from multithreadedgameengine_tpu.tools import texture_packer as ref_packer
import multithreadedgameengine_tpu_torch as port_pkg
from multithreadedgameengine_tpu_torch.assets import SpriteRegistry
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine
from multithreadedgameengine_tpu_torch.render import atlas, headless, procgen
from multithreadedgameengine_tpu_torch.tools import sprite_visualizer as viz
from multithreadedgameengine_tpu_torch.tools import texture_packer as packer

torch.set_num_threads(2)


def _sheet():
    """tests/test_atlas.py's 2 x 2 sheet of 8 x 8 frames."""
    sheet = np.zeros((16, 16, 4), np.uint8)
    frames, anims = {}, {"walk_down": [], "idle_down": []}
    for k, (r, g, b) in enumerate([(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]):
        y, x = (k // 2) * 8, (k % 2) * 8
        sheet[y:y + 8, x:x + 8] = (r, g, b, 255)
        frames[f"f{k}"] = {"frame": {"x": x, "y": y, "w": 8, "h": 8}}
        (anims["walk_down"] if k < 2 else anims["idle_down"]).append(f"f{k}")
    return sheet, {"frames": frames, "animations": anims}


def _assert_atlases_equal(a, b):
    np.testing.assert_array_equal(b.image, a.image)
    assert b.frames == a.frames and b.json == a.json


class TestAtlas:
    """``tests/test_atlas.py`` through the port, with the reference's
    output as the bar."""

    def test_png_roundtrip(self, tmp_path):
        rgb = np.random.default_rng(0).integers(0, 255, (37, 53, 3), np.uint8)
        p = str(tmp_path / "t.png")
        headless.write_png(p, rgb)
        data = open(p, "rb").read()
        assert data == ref_headless.encode_png(rgb)
        out = atlas.decode_png(data)
        np.testing.assert_array_equal(out[..., :3], rgb)
        assert (out[..., 3] == 255).all()
        np.testing.assert_array_equal(out, ref_atlas.decode_png(data))

    def test_maxrects_places_as_reference(self):
        rng = np.random.default_rng(1)
        a, b = ref_atlas.MaxRectsPacker(256, 256), atlas.MaxRectsPacker(256, 256)
        placed = []
        for _ in range(60):
            w, h = int(rng.integers(4, 40)), int(rng.integers(4, 40))
            ra, rb = a.insert(w, h), b.insert(w, h)
            assert (rb is None) == (ra is None)
            if rb is None:
                continue
            assert (rb.x, rb.y, rb.w, rb.h) == (ra.x, ra.y, ra.w, ra.h)
            assert 0 <= rb.x and rb.x + rb.w <= 256 and 0 <= rb.y and rb.y + rb.h <= 256
            for o in placed:
                assert (rb.x >= o.x + o.w or o.x >= rb.x + rb.w
                        or rb.y >= o.y + o.h or o.y >= rb.y + rb.h), "overlap"
            placed.append(rb)
        assert len(placed) > 30
        assert atlas.MaxRectsPacker(64, 64).insert(100, 10) is None

    def test_big_atlas_matches_reference(self, tmp_path):
        ball = np.full((14, 14, 4), (255, 128, 0, 255), np.uint8)
        sheet, meta = _sheet()
        ra, rb = RefRegistry(), SpriteRegistry()
        a = ref_atlas.create_big_atlas({"ball": ball}, {"civ": (sheet, meta)}, size=128,
                                       registry=ra)
        b = atlas.create_big_atlas({"ball": ball}, {"civ": (sheet, meta)}, size=128,
                                   registry=rb)
        _assert_atlases_equal(a, b)
        np.testing.assert_array_equal(b.frame_image("ball"), ball)
        np.testing.assert_array_equal(b.frame_image("civ/f0"), sheet[0:8, 0:8])
        assert "_lightGradient" in b.frames
        assert rb.texture_id("ball") == ra.texture_id("ball") > 0
        assert rb.animation_index("civ", "idle_down") == 1
        assert b.json["sheets"]["civ"]["animations"] == ["walk_down", "idle_down"]
        pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        ref_atlas.inspect_atlas(a, pa)
        atlas.inspect_atlas(b, pb)
        assert open(pb, "rb").read() == open(pa, "rb").read()

    def test_grows_until_fit(self):
        imgs = {f"t{k}": np.zeros((60, 60, 4), np.uint8) for k in range(12)}
        b = atlas.create_big_atlas(imgs, size=64)
        assert b.image.shape[0] >= 256
        _assert_atlases_equal(ref_atlas.create_big_atlas(imgs, size=64), b)

    @pytest.mark.parametrize("radius,color", [(50, 0xFFFFFF), (13, 0x40A0FF)])
    def test_light_gradient(self, radius, color):
        g = atlas.light_gradient_texture(radius, color)
        np.testing.assert_array_equal(g, ref_atlas.light_gradient_texture(radius, color))
        if radius == 50:
            assert g.shape == (100, 100, 4) and g[50, 50, 3] > 200 and g[50, 2, 3] < 10


@pytest.mark.parametrize("seed", [0, 7, 0xC1B2])
def test_procgen_matches_reference(seed):
    img, meta = procgen.make_character_sheet(seed=seed)
    ref_img, ref_meta = ref_procgen.make_character_sheet(seed=seed)
    np.testing.assert_array_equal(img, ref_img)
    assert meta == ref_meta
    tex, ref_tex = procgen.make_demo_textures(), ref_procgen.make_demo_textures()
    assert list(tex) == list(ref_tex)
    for name in tex:
        np.testing.assert_array_equal(tex[name], ref_tex[name])


def _write_assets(tmp_path):
    sheet, meta = procgen.make_character_sheet(seed=3)
    sheet_path = str(tmp_path / "civil.png")
    with open(sheet_path, "wb") as f:
        f.write(headless.encode_png(sheet))
    tex_path = str(tmp_path / "bunny.png")
    with open(tex_path, "wb") as f:
        f.write(headless.encode_png(procgen.make_demo_textures()["bunny"]))
    fr = next(iter(meta["frames"].values()))["frame"]
    return sheet_path, tex_path, fr["w"], fr["h"]


class TestTools:
    """``tests/test_tools.py`` through the port: each CLI writes the
    reference CLI's files, byte for byte."""

    def test_pack_cli_matches_reference(self, tmp_path):
        sheet_path, tex_path, fw, fh = _write_assets(tmp_path)
        outs = {}
        for name, main in (("ref", ref_packer.main), ("port", packer.main)):
            d = tmp_path / name
            d.mkdir()
            rc = main([tex_path, "--sheet", f"civil={sheet_path}:{fw}x{fh}:idle_up,idle_right",
                       "--out", str(d / "atlas.png"), "--json", str(d / "atlas.json"),
                       "--inspect", str(d / "dbg.png")])
            assert rc == 0
            outs[name] = {f: (d / f).read_bytes() for f in ("atlas.png", "atlas.json", "dbg.png")}
        assert outs["port"] == outs["ref"]
        meta = json.loads(outs["port"]["atlas.json"])
        assert "bunny" in meta["frames"] and "_lightGradient" in meta["frames"]
        assert any(k.startswith("civil/idle_up_") for k in meta["frames"])
        assert "civil" in meta["sheets"]
        side = meta["meta"]["size"]["w"]
        for fr in meta["frames"].values():
            f = fr["frame"]
            assert 0 <= f["x"] and f["x"] + f["w"] <= side
            assert 0 <= f["y"] and f["y"] + f["h"] <= side

    def test_slice_names_and_trim(self):
        img = np.zeros((32, 64, 4), np.uint8)
        img[0:16, 0:48, 3] = 255  # row 0: 3 frames then an empty one
        img[16:32, :, 3] = 255  # row 1: all 4 frames
        meta = packer.slice_sheet(img, 16, 16, ["walk"])
        assert [len(v) for v in meta["animations"].values()] == [3, 4]
        assert list(meta["animations"]) == ["walk", "row1"]
        assert meta == ref_packer.slice_sheet(img, 16, 16, ["walk"])

    def test_visualizer_matches_reference(self, tmp_path):
        sheet_path, _tex, fw, fh = _write_assets(tmp_path)
        trees = {}
        for name, main in (("ref", ref_viz.main), ("port", viz.main)):
            out = tmp_path / name
            assert main([sheet_path, f"{fw}x{fh}", "--out", str(out)]) == 0
            trees[name] = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        assert trees["port"] == trees["ref"]
        page = trees["port"]["index.html"].decode()
        assert "@keyframes" in page and "steps(" in page
        assert sum(p.endswith(".png") for p in trees["port"]) >= 4


class TestEngineAssetPreload:
    """``tests/test_round4.py::TestEngineAssetPreload`` through the port."""

    def test_png_files_from_disk_roundtrip(self, tmp_path):
        sheet_img, sheet_meta = procgen.make_character_sheet(seed=7)
        png = tmp_path / "civil1.png"
        png.write_bytes(headless.encode_png(sheet_img))
        meta_p = tmp_path / "civil1.json"
        meta_p.write_text(json.dumps(sheet_meta))
        tex = procgen.make_demo_textures()["bunny"]
        tex_p = tmp_path / "bunny.png"
        tex_p.write_bytes(headless.encode_png(tex))
        kw = dict(n_prey=8, n_predators=1, n_lights=1)
        args = dict(images={"bunny": str(tex_p)}, sheets={"civil1": (str(png), str(meta_p))})
        ej = ref_predators(**kw)
        eng = make_predators_engine(device="cpu", **kw)
        a, b = ej.load_assets(**args), eng.load_assets(**args)
        assert eng.atlas is b
        _assert_atlases_equal(a, b)
        name0 = next(iter(sheet_meta["frames"]))
        f = sheet_meta["frames"][name0]["frame"]
        np.testing.assert_array_equal(b.frame_image(f"civil1/{name0}"),
                                      sheet_img[f["y"]:f["y"] + f["h"], f["x"]:f["x"] + f["w"]])
        np.testing.assert_array_equal(b.frame_image("bunny"), tex)
        assert "_lightGradient" in b.frames
        assert eng.sprites.sheet_id("civil1") == ej.sprites.sheet_id("civil1") >= 1
        assert eng.sprites.texture_id("bunny") == ej.sprites.texture_id("bunny") >= 1
        eng.step(2)
        assert int(eng.metrics["active_count"]) > 0

    def test_constructor_images_arg(self, tmp_path):
        img = np.zeros((8, 8, 4), np.uint8)
        img[..., 0] = 200
        img[..., 3] = 255
        p = tmp_path / "dot.png"
        p.write_bytes(headless.encode_png(img))
        eng = port_pkg.Engine(port_pkg.make_config(world_width=100.0, world_height=100.0),
                              images={"dot": str(p)}, device="cpu")
        assert eng.atlas is not None
        np.testing.assert_array_equal(eng.atlas.frame_image("dot"), img)
        assert eng.sprites.texture_id("dot") >= 1
        with pytest.raises(ValueError, match="RGBA"):
            eng.load_assets(images={"bad": np.zeros((4, 4, 3), np.uint8)})


def _glow_scene(pkg):
    """``TestHeadlessSpritesAndGlow._scene`` in either package."""
    m = ref_pkg if pkg == "jax" else port_pkg

    class Sprite(m.EntityClass):
        components = [m.RigidBody, m.Collider, m.SpriteRenderer]
        uses_neighbors = False

    class Lamp(m.EntityClass):
        components = [m.LightEmitter, m.SpriteRenderer]
        uses_neighbors = False

        @classmethod
        def setup(cls, ctx):
            return {"light.light_color": 0x00FF00, "light.light_intensity": 2500.0}

    cfg = m.make_config(canvas_width=200, canvas_height=160, world_width=200.0,
                        world_height=160.0, lighting=dict(enabled=True, lighting_ambient=1.0))
    eng = m.Engine(cfg) if pkg == "jax" else m.Engine(cfg, device="cpu")
    eng.register_entity_class(Sprite, 2)
    eng.register_entity_class(Lamp, 1)
    eng.init()
    eng.input.camera_x = 0.0
    eng.input.camera_y = 0.0
    return eng


def _both_render(setup):
    """``setup(eng)`` on a JAX and a port scene, the JAX engine stepped once
    and its world rendered by both packages. Returns (reference image, port
    image)."""
    ej, et = _glow_scene("jax"), _glow_scene("torch")
    for e in (ej, et):
        setup(e)
    ej.step(1)
    et.step(1)
    et.restore(world_from_jax(ej.snapshot(), "cpu", et._plan.solver_geom))
    a, b = ref_headless.render_frame(ej), headless.render_frame(et)
    np.testing.assert_array_equal(b, a)
    return b


class TestHeadlessSpritesAndGlow:
    """``tests/test_round4.py::TestHeadlessSpritesAndGlow`` through the
    port, with the reference's image of the same world as the bar."""

    def test_atlas_sprite_blit_and_fallback(self):
        tex = np.zeros((10, 10, 4), np.uint8)
        tex[..., 2] = 255
        tex[..., 3] = 255

        def setup(e):
            e.load_assets(images={"blue": tex})
            e.spawn("Sprite", x=50.0, y=50.0, **{
                "sprite.animation_state": float(e.sprites.texture_id("blue")),
                "sprite.anchor_x": 0.5, "sprite.anchor_y": 0.5, "sprite.tint": 0xFFFFFF})

        patch = _both_render(setup)[47:53, 47:53].astype(int)
        assert patch[..., 2].mean() > 150 and patch[..., 0].mean() < 60

    def test_sprite_scale_rotation_tint(self):
        tex = np.zeros((4, 16, 4), np.uint8)
        tex[..., :3] = 255
        tex[..., 3] = 255

        def setup(e):
            e.load_assets(images={"bar": tex})
            e.spawn("Sprite", x=100.0, y=80.0, rotation=float(np.pi / 2), **{
                "sprite.animation_state": float(e.sprites.texture_id("bar")),
                "sprite.anchor_x": 0.5, "sprite.anchor_y": 0.5,
                "sprite.scale_x": 2.0, "sprite.scale_y": 2.0, "sprite.tint": 0xFF0000})

        img = _both_render(setup).astype(int)
        assert img[80 + 12, 100, 0] > 150 and img[80 + 12, 100, 2] < 60
        assert img[80, 100 + 12, 0] < 60

    def test_glow_layer_additive(self):
        base = _both_render(lambda e: None).astype(int)
        lit = _both_render(lambda e: e.spawn("Lamp", x=100.0, y=80.0)).astype(int)
        assert lit[80, 100, 1] > base[80, 100, 1] + 20
        assert abs(int(lit[5, 5, 1]) - int(base[5, 5, 1])) < 25
