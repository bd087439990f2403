"""Slice C2's lighting module against the JAX package: ``shadow_sprites``
over the global neighbour lists and ``shadow_sprites_by_class`` over
per-class lists, ``light_uniforms`` and ``entity_light_levels``, on the
cases of ``tests/test_lighting.py`` (a caster east of a light, eight casters
round one light against the per-light cap, an off-screen light, a
coincident caster) plus six lit lights against the cap on lights. Each case
is one world built from the same numpy fields in both packages, culled by
each package's ``update_entity_visibility`` and listed by each package's
neighbour lists, at the predators operating point's grid (cell 128, scan
radius 2, capacity 64) with ``tests/test_lighting.py``'s caps (4 lights, 3
shadows a light, 8 uniform lights).

Tolerances: the shadow sprites' ``active`` (and so each light's count and
the kept casters' order), the uniforms and the light count are exact; the
active sprites' floats within 8 float32 ulps at each field's largest
magnitude (XLA:CPU approximates ``atan2`` and contracts ``a * b + c``;
measured 0-1 ulp); light levels within 4 ulps at 1.5, the cap (the port
sums its gapped slot rows, the reference its compacted lists, so the sums
may associate differently; measured 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu.ops.lighting as ref_lighting
import multithreadedgameengine_tpu.ops.spatial as ref_spatial
from multithreadedgameengine_tpu.config import make_config as ref_make_config
from multithreadedgameengine_tpu.inputs import InputController as RefInput
from multithreadedgameengine_tpu.ops.culling import update_entity_visibility as ref_visibility
from multithreadedgameengine_tpu.state import make_world as ref_make_world
from multithreadedgameengine_tpu_torch import make_config
from multithreadedgameengine_tpu_torch.inputs import InputController
from multithreadedgameengine_tpu_torch.ops import lighting, spatial
from multithreadedgameengine_tpu_torch.ops.culling import update_entity_visibility
from multithreadedgameengine_tpu_torch.state import make_world

torch.set_num_threads(2)

CONFIG = dict(
    canvas_width=1600, canvas_height=900, world_width=5000.0, world_height=2000.0,
    spatial=dict(cell_size=128.0, max_neighbors=1500, cell_capacity=64, max_cell_radius=2),
    lighting=dict(enabled=True, shadows_enabled=True, max_shadow_casting_lights=4,
                  max_shadows_per_light=3, max_lights=8, lighting_ambient=0.05),
)
SHADOW_ULPS = 8
SHADOW_FLOATS = ("x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius")
PREY_RADIUS = 10.0


def ring(cx, cy, r, k):
    return [(cx + r * np.cos(2 * np.pi * i / k), cy + r * np.sin(2 * np.pi * i / k))
            for i in range(k)]


#: name -> (lights, casters, camera); entity 0 is an inactive mouse slot,
#: then the lights, then the casters
CASES = {
    "cast_away": ([(1000.0, 1000.0)], [(1060.0, 1000.0)], (900.0, 900.0)),
    "per_light_cap": ([(1000.0, 1000.0)], ring(1000.0, 1000.0, 80.0, 8), (900.0, 900.0)),
    "offscreen": ([(4000.0, 1900.0)], [(4060.0, 1900.0)], (0.0, 0.0)),
    "coincident": ([(1000.0, 1000.0)], [(1000.3, 1000.0)], (900.0, 900.0)),
    "light_cap": ([(700.0 + 300.0 * k, 1000.0) for k in range(6)],
                  [(700.0 + 300.0 * k + dx, 1000.0 + dy) for k in range(6)
                   for dx, dy in ((50.0, 20.0), (-40.0, 60.0))], (600.0, 700.0)),
}


def columns(lights, casters):
    """Numpy fields of the world: lights (intensity 20000, height 110,
    range 200) then casters (a prey's shadow radius and 5x height, range
    100)."""
    nl, nc = len(lights), len(casters)
    n = 1 + nl + nc
    pts = np.asarray([(0.0, 0.0)] + list(lights) + list(casters), np.float32)
    is_l = np.zeros(n, bool)
    is_l[1:1 + nl] = True
    is_c = np.zeros(n, bool)
    is_c[1 + nl:] = True
    f32 = lambda v: np.asarray(v, np.float32)
    return dict(
        transform=dict(active=is_l | is_c, x=pts[:, 0], y=pts[:, 1],
                       entity_type=np.where(is_l, 1, np.where(is_c, 2, 0)).astype(np.int32)),
        collider=dict(visual_range=f32(np.where(is_l, 200.0, np.where(is_c, 100.0, 0.0)))),
        light=dict(active=is_l, light_intensity=f32(np.where(is_l, 20000.0, 0.0)),
                   height=f32(np.where(is_l, 110.0, 0.0)),
                   light_color=np.where(is_l, 0xFF8844, 0).astype(np.uint32)),
        shadow=dict(active=is_c, shadow_radius=f32(np.where(is_c, PREY_RADIUS, 0.0)),
                    height=f32(np.where(is_c, 5 * PREY_RADIUS, 0.0))),
    ), (nl, nc)


def build(pkg, cols, camera):
    """The world of ``cols`` in one package, culled by its camera."""
    lc = CONFIG["lighting"]
    n_sh = lc["max_shadow_casting_lights"] * lc["max_shadows_per_light"]
    n = cols["transform"]["x"].shape[0]
    if pkg == "port":
        cfg, w = make_config(**CONFIG), make_world(n, "cpu", n_shadow_sprites=n_sh)
        conv = lambda v: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
        inp = InputController()
    else:
        cfg, w = ref_make_config(**CONFIG), ref_make_world(n, n_shadow_sprites=n_sh)
        conv = jnp.asarray
        inp = RefInput()
    w = w.replace(**{comp: getattr(w, comp).replace(**{k: conv(v) for k, v in f.items()})
                     for comp, f in cols.items()})
    inp.camera_x, inp.camera_y = camera
    if pkg == "port":
        return update_entity_visibility(w, cfg, inp.snapshot("cpu")), cfg
    return ref_visibility(w, cfg, inp.snapshot()), cfg


def lists(pkg, w, cfg, counts):
    t, c = w.transform, w.collider
    nl, nc = counts
    specs = (("TallLight", 1, nl, 2), ("Prey", 1 + nl, nc, 2))
    mod = spatial if pkg == "port" else ref_spatial
    glob = mod.neighbor_lists(t.x, t.y, t.active, c.visual_range, cfg)
    by_class, _n = mod.neighbor_lists_by_class(t.x, t.y, t.active, c.visual_range, cfg, (),
                                               specs)
    return glob, [(1, nl, by_class["TallLight"])]


def ulp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return (a.double() - b.double()).abs().max().item() / float(np.spacing(np.float32(scale)))


EXPECTED_ACTIVE = {"cast_away": 1, "per_light_cap": 3, "offscreen": 0, "coincident": 0,
                   "light_cap": 8}


@pytest.mark.parametrize("form", ["global", "by_class"])
@pytest.mark.parametrize("case", list(CASES))
def test_shadow_sprites_match_reference(case, form):
    lights, casters, camera = CASES[case]
    cols, counts = columns(lights, casters)
    (w, cfg), (rw, rcfg) = build("port", cols, camera), build("ref", cols, camera)
    (g, per), (rg, rper) = lists("port", w, cfg, counts), lists("ref", rw, rcfg, counts)
    if form == "global":
        ss, rss = lighting.shadow_sprites(w, g, cfg), ref_lighting.shadow_sprites(rw, rg, rcfg)
    else:
        ss = lighting.shadow_sprites_by_class(w, per, cfg)
        rss = ref_lighting.shadow_sprites_by_class(rw, rper, rcfg)
    ra = np.asarray(rss.active)
    np.testing.assert_array_equal(ss.active.numpy(), ra)
    assert int(ss.active.sum()) == EXPECTED_ACTIVE[case]
    on = torch.from_numpy(ra.copy())
    for field in SHADOW_FLOATS:
        a = getattr(ss, field)[on]
        b = torch.from_numpy(np.array(getattr(rss, field)))[on]
        assert ulp_err(a, b) <= SHADOW_ULPS, (field, ulp_err(a, b))
    if case == "cast_away":  # tests/test_lighting.py's geometry
        k = int(torch.argmax(ss.active.to(torch.int32)))
        assert abs(float(ss.x[k]) - (1060.0 - PREY_RADIUS)) < 2.0
        assert abs(float(ss.rotation[k]) + np.pi / 2) < 0.15
        assert float(ss.alpha[k]) > 0 and float(ss.scale_x[k]) > 0 and float(ss.scale_y[k]) > 0
    if case == "light_cap":  # the first 4 lights cast 2 each, the last 2 none
        per_light = ss.active.view(4, 3).sum(1)
        assert per_light.tolist() == [2, 2, 2, 2]


def test_no_light_class_casts_nothing():
    cols, _counts = columns([], [(1000.0, 1000.0)])
    w, cfg = build("port", cols, (900.0, 900.0))
    ss = lighting.shadow_sprites_by_class(w, [], cfg)
    assert ss.active.shape == (12,) and not bool(ss.active.any())


@pytest.mark.parametrize("n_lights,max_lights", [(2, 8), (12, 5)], ids=["two", "capped"])
def test_light_uniforms_match_reference(n_lights, max_lights):
    """The first max_lights active lights (on screen or not), field by
    field (tests/test_lighting.py::TestLightUniforms)."""
    lights = [(100.0 * (k + 1), 200.0 + 100.0 * (k % 3)) for k in range(n_lights)]
    cols, _counts = columns(lights, [(50.0, 50.0)])
    n = cols["light"]["active"].size
    cols["light"]["light_color"] = np.arange(n, dtype=np.uint32) * 0x10101
    cfg_over = dict(CONFIG["lighting"], max_lights=max_lights)
    (w, _c), (rw, _r) = build("port", cols, (0.0, 0.0)), build("ref", cols, (0.0, 0.0))
    u = lighting.light_uniforms(w, make_config(**dict(CONFIG, lighting=cfg_over)))
    ru = ref_lighting.light_uniforms(rw, ref_make_config(**dict(CONFIG, lighting=cfg_over)))
    for field in ("count", "x", "y", "intensity", "color", "height"):
        a, b = getattr(u, field), np.asarray(getattr(ru, field))
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype), err_msg=field)
    assert int(u.count) == min(n_lights, max_lights)
    assert u.x[:2].tolist() == [100.0, 200.0]


def test_entity_light_levels_match_reference():
    """Brightness from a nearby light plus the ambient; nothing from one
    out of range (tests/test_lighting.py::TestEntityLightLevels)."""
    cols, counts = columns([(1000.0, 1000.0)], [(1050.0, 1000.0), (1600.0, 1000.0)])
    (w, cfg), (rw, rcfg) = build("port", cols, (900.0, 900.0)), build("ref", cols, (900.0, 900.0))
    (g, _p), (rg, _rp) = lists("port", w, cfg, counts), lists("ref", rw, rcfg, counts)
    lv = lighting.entity_light_levels(w, g, cfg)
    rlv = np.asarray(ref_lighting.entity_light_levels(rw, rg, rcfg))
    np.testing.assert_allclose(lv.numpy(), rlv, rtol=0, atol=4 * float(np.spacing(np.float32(1.5))))
    near, far = 2, 3
    assert abs(float(lv[near]) - (0.05 + 20000 / 22500)) < 0.01
    assert abs(float(lv[far]) - 0.05) < 1e-3
