"""Slice C2: the predators scene (BASELINE config 4) of the PyTorch port
against the JAX package, both built by ``make_predators_engine`` with 120
prey, 3 predators and 2 lights (``tests/test_boids.py:27``'s scene) in a
1200 x 800 world, so that lights see casters and prey meet predators; the
rest is the demo's operating point: cell 128, ``max_neighbors`` 1500,
``cell_capacity`` 64, one substep, a 50,000-particle pool with decals at
resolution 0.5, lighting with shadows. The camera is zoomed out so every
light and caster is on screen.

Each package builds its scene on its own (the per-instance setup and spawn
draws must agree exactly); the JAX package steps one frame, its world is
carried into the port (``world_from_jax``), both queue the same emitter
bursts (the demo's blood, in flight for many frames, and a burst of
``stay_on_the_floor`` particles that lands at once, on overlapping patches,
so the decal stamping runs), and both step 5 frames, compared after each.

Tolerances, each with its reason:
- exact: every field written at set-up and spawn; entity types, active
  flags, contact counts, ``n_binned``, ``active_particles``, animation
  state and frame, ``render_dirty``, the particle pool (every field), the
  dirty tiles and the decal canvas bytes, the shadow sprites' ``active``
  and the number of shadows each light keeps;
- positions within 4 float32 ulps at the world's extent (measured: 0 after
  5 frames; the bar of ``tests/test_torch_boids.py``);
- the active shadow sprites' floats within 8 ulps at each field's largest
  magnitude: XLA:CPU approximates ``atan2`` and contracts ``a * b + c``
  (the feet position, the length scale), which moves their last bits
  (measured: at most 1 ulp, in both assembly forms).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_make
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.predators import (
    BLOOD,
    Predator,
    Prey,
    TallLight,
    make_predators_engine,
)

torch.set_num_threads(2)

SCENE = dict(n_prey=120, n_predators=3, n_lights=2, world_width=1200.0, world_height=800.0)
PER_CLASS = dict(spatial=dict(cell_size=128.0, max_neighbors=1500, cell_capacity=64,
                              per_class_assembly=True))
POS_ULPS = 4
SHADOW_ULPS = 8
SHADOW_FLOATS = ("x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius")


def emit_bursts(eng):
    """The same bursts on either package's emitter: the demo's blood at six
    places, and a burst that lands on its first frame, on overlapping
    patches."""
    rng = np.random.default_rng(5)
    eng.emitter.emit_batch(x=rng.uniform(100, 1100, 6).astype(np.float32),
                           y=rng.uniform(100, 700, 6).astype(np.float32), **BLOOD)
    eng.emitter.emit_batch(
        x=[300.0, 310.0, 900.0], y=[300.0, 305.0, 500.0], count={"min": 6, "max": 12},
        z=-1.0, vz=5.0, angle_xy={"min": 0.0, "max": 360.0}, speed={"min": 0.5, "max": 3.0},
        lifespan=9000.0, gravity=0.0, texture="blood", scale={"min": 0.5, "max": 2.0},
        alpha={"min": 0.4, "max": 0.9}, tint={"min": 0xAA0000, "max": 0xFF4444},
        stay_on_the_floor=True)


def fields(world):
    """(name, tensor) of every entity field and user-component field."""
    for comp in ("transform", "rigid_body", "collider", "sprite", "light", "shadow"):
        for f in dataclasses.fields(getattr(world, comp)):
            yield f"{comp}.{f.name}", getattr(getattr(world, comp), f.name)
    for name, comp in world.custom.items():
        for f in dataclasses.fields(comp):
            yield f"{name}.{f.name}", getattr(comp, f.name)


def ulp_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in float32 ulps at the larger of the two's largest
    magnitude."""
    if a.numel() == 0:
        return 0.0
    scale = max(a.abs().max().item(), b.abs().max().item(), 1e-30)
    return (a.double() - b.double()).abs().max().item() / float(np.spacing(np.float32(scale)))


@pytest.fixture(scope="module", params=["global", "per_class"])
def engines(request):
    over = dict(SCENE, **(PER_CLASS if request.param == "per_class" else {}))
    ej = ref_make(**over)
    et = make_predators_engine(device="cpu", **over)
    ej._flush_pending()
    et._flush_pending()
    built = dict(fields(world_from_jax(jax.device_get(ej.world), "cpu")))
    own = dict(fields(et.world))
    assert built.keys() == own.keys()
    setup_diff = [name for name in built if not torch.equal(built[name], own[name])]
    ej.step(1)
    et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
    for e in (ej, et):
        e.input.camera_x = 0.0
        e.input.camera_y = 0.0
        e.input.camera_zoom = 0.3
        emit_bursts(e)
    frames = []
    for _ in range(5):
        mj, mt = ej.step(1), et.step(1)
        frames.append(({k: int(v) for k, v in mj.items()}, {k: int(v) for k, v in mt.items()},
                       world_from_jax(jax.device_get(ej.world), "cpu"), et.snapshot()))
    return request.param, setup_diff, et, frames


def test_setup_and_spawn_draws_match(engines):
    """Every field set-up and spawning write (the prey's per-instance
    draws, the sheets, scales and radii, the lights' colours) agrees bit
    for bit, and so do the two packages' scene layouts."""
    _form, setup_diff, et, _frames = engines
    assert setup_diff == []
    assert [c.entity_type for c in (Prey, Predator, TallLight)] == [2, 3, 4]
    assert et._plan.shadows_on and et._plan.need_neighbors and not et._plan.lazy_chunks


def test_integer_state_exact_each_frame(engines):
    form, _d, et, frames = engines
    assert bool(et._plan.nbr_specs) == (form == "per_class")
    for k, (mj, mt, a, b) in enumerate(frames):
        for key in ("n_binned", "active_particles", "active_count", "solver_overflow"):
            assert mt[key] == mj[key], (k, key)
        assert mt["n_binned"] == 126
        for name, u, v in (
            ("entity_type", a.transform.entity_type, b.transform.entity_type),
            ("active", a.transform.active, b.transform.active),
            ("contacts", a.rigid_body.collision_count, b.rigid_body.collision_count),
            ("animation_state", a.sprite.animation_state, b.sprite.animation_state),
            ("animation_frame", a.sprite.animation_frame, b.sprite.animation_frame),
            ("render_dirty", a.sprite.render_dirty, b.sprite.render_dirty),
            ("decal_dirty", a.decal_dirty, b.decal_dirty),
            ("shadow_active", a.shadow_sprites.active, b.shadow_sprites.active),
        ):
            assert torch.equal(u, v), (k, name)
    last = frames[-1][3]
    assert int(last.rigid_body.collision_count.sum()) > 0
    # animation ran on real LPC frame counts: some frame index is past 0
    assert int(last.sprite.animation_frame.max()) > 0
    assert int(last.shadow_sprites.active.sum()) > 0


def test_particles_and_canvas_exact_each_frame(engines):
    """The pool, field by field, and the canvas bytes. The landing burst
    stamps on the first compared frame; the blood stays in flight."""
    _form, _d, _et, frames = engines
    stamped = False
    for k, (mj, _mt, a, b) in enumerate(frames):
        for f in dataclasses.fields(a.particles):
            assert torch.equal(getattr(a.particles, f.name), getattr(b.particles, f.name)), \
                (k, f.name)
        assert torch.equal(a.decal_canvas, b.decal_canvas), k
        stamped |= bool(b.decal_canvas[..., 3].any())
        assert mj["active_particles"] > 0
    assert stamped and bool(frames[-1][3].decal_dirty.any())
    # particles landed and despawned: the count fell after the first frame
    assert frames[1][1]["active_particles"] < frames[0][1]["active_particles"]


def test_floats_within_ulps_each_frame(engines):
    _form, _d, et, frames = engines
    tol = POS_ULPS * float(np.spacing(np.float32(1200.0)))
    for k, (_mj, _mt, a, b) in enumerate(frames):
        for comp, field in (("transform", "x"), ("transform", "y"),
                            ("rigid_body", "px"), ("rigid_body", "py")):
            u, v = getattr(getattr(a, comp), field), getattr(getattr(b, comp), field)
            np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=0, atol=tol,
                                       err_msg=f"frame {k}: {comp}.{field}")
        on = a.shadow_sprites.active
        for field in SHADOW_FLOATS:
            u, v = getattr(a.shadow_sprites, field)[on], getattr(b.shadow_sprites, field)[on]
            assert ulp_err(u, v) <= SHADOW_ULPS, (k, field, ulp_err(u, v))
    ss = frames[-1][3].shadow_sprites
    lc = et.config.lighting
    per_light = ss.active.view(lc.max_shadow_casting_lights, lc.max_shadows_per_light).sum(1)
    assert int(per_light.max()) <= lc.max_shadows_per_light


def test_sprite_registry_matches_reference():
    """The port's own copy of the registry: the demo's sheets and textures
    give the reference's ids, indices and serialized form, which
    round-trips; typos raise with a hint."""
    from multithreadedgameengine_tpu.assets import LPC_ANIMATIONS as REF_LPC
    from multithreadedgameengine_tpu.assets import SpriteRegistry as RefRegistry
    from multithreadedgameengine_tpu_torch.assets import LPC_ANIMATIONS, SpriteRegistry

    assert LPC_ANIMATIONS == REF_LPC
    regs = []
    for cls in (SpriteRegistry, RefRegistry):
        reg = cls()
        for name in ("civil1", "civil2", "civil3"):
            reg.register_spritesheet(name, LPC_ANIMATIONS, image=f"{name}.png")
        for name in ("bunny", "blood", "tallLight"):
            reg.register_texture(name)
        regs.append(reg)
    port, ref = regs
    assert port.serialize() == ref.serialize()
    again = SpriteRegistry.deserialize(port.serialize())
    assert again.serialize() == port.serialize()
    assert [s.sheet_id for s in port.sheets] == [1, 2, 3]
    assert port.animation_index("civil3", "run_left") == ref.animation_index("civil3", "run_left")
    assert port.texture_id("blood") == 2
    with pytest.raises(KeyError, match="did you mean 'walk_up'"):
        port.animation_index("civil1", "wlak_up")
    with pytest.raises(KeyError, match="unknown texture"):
        port.texture_id("blod")


def test_direction_from_angle_matches_reference():
    """The 4-way facing on a sweep of angles and on both sides of every
    boundary (pi/4 multiples, 0 and -0, negative angles)."""
    import jax.numpy as jnp

    from multithreadedgameengine_tpu.utils import direction_from_angle as ref_direction
    from multithreadedgameengine_tpu_torch.utils import direction_from_angle

    edges = np.float32(np.pi / 4) * np.arange(-8, 9, dtype=np.float32)
    angles = np.concatenate([
        np.linspace(-2 * np.pi, 2 * np.pi, 2001, dtype=np.float32), edges,
        np.nextafter(edges, np.float32(-10)), np.nextafter(edges, np.float32(10)),
        np.asarray([0.0, -0.0], np.float32)])
    got = direction_from_angle(torch.from_numpy(angles))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_direction(jnp.asarray(angles))))


def test_anim_tables_and_frame_counts_match_reference():
    """``build_anim_table`` and the engine's per-(sheet, animation) frame
    counts from the registry, against the JAX package's."""
    from multithreadedgameengine_tpu.models.predators import build_anim_table as ref_table
    from multithreadedgameengine_tpu_torch.models.predators import build_anim_table

    ej = ref_make(n_prey=2, n_predators=1, n_lights=1, spawn=False)
    et = make_predators_engine(n_prey=2, n_predators=1, n_lights=1, spawn=False, device="cpu")
    for sheet in ("civil1", "civil3"):
        np.testing.assert_array_equal(build_anim_table(et.sprites, sheet).numpy(),
                                      np.asarray(ref_table(ej.sprites, sheet)))
    fc = et._frame_counts()
    np.testing.assert_array_equal(fc.numpy(), np.asarray(ej._frame_counts()))
    assert fc.shape == (8, 54) and int(fc[1, 8]) == 9  # civil1's walk_up
