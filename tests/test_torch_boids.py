"""Slice C1: the boids scene of the PyTorch port against the JAX package,
against a per-neighbour numpy oracle of the flocking rules, and the user
components (``define_component``, ``world.custom``) it rides on.

Tolerances, each with its reason:
- the port against the JAX package, frame by frame for 5 frames on
  ``tests/test_halo.py``'s 256-boid scene, built and stepped once by the
  JAX package and carried across with ``config_from``/``world_from_jax``:
  integer state exact (active flags,
  entity types, contact counts, ``n_binned``); positions within 4 float32
  ulps at the world's extent (2000). The port sums each boid's neighbour
  terms along the slots of ``[count, S]`` where XLA reduces a vmapped row,
  and XLA:CPU contracts multiply-adds: the last bits of an acceleration
  differ, about one position ulp a frame (measured: 7.6e-5 after 5 frames,
  0.6 ulp at 2000);
- the port's tick against the oracle: ``atol=2e-3`` on a frame's
  displacement, the bar of ``tests/test_boids.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu import Engine as RefEngine
from multithreadedgameengine_tpu import make_config as ref_make_config
from multithreadedgameengine_tpu.models.boids import Boid as RefBoid
from multithreadedgameengine_tpu_torch import Engine, EntityClass, make_config
from multithreadedgameengine_tpu_torch.behavior import read_field, write_field
from multithreadedgameengine_tpu_torch.components import (
    COMPONENT_DTYPES,
    LightEmitter,
    RigidBody,
    ShadowCaster,
    define_component,
)
from multithreadedgameengine_tpu_torch.interop import config_from, world_from_jax
from multithreadedgameengine_tpu_torch.models.boids import Boid, Flocking

torch.set_num_threads(2)

SCENE = dict(world_width=2000.0, world_height=1600.0, seed=7,
             spatial=dict(cell_size=100.0, max_neighbors=64, cell_capacity=32),
             physics=dict(sub_step_count=2, gravity=(0.0, 0.0)))


def spawn(eng, n=255, seed=3):
    """test_halo.py's boids (x, y in [50, extent - 50]); on_spawned runs
    per boid (its rng draws)."""
    rng = np.random.default_rng(seed)
    w, h = eng.config.world_width, eng.config.world_height
    eng.spawn_batch(
        "Boid", n,
        x=rng.uniform(50, w - 50, n).astype(np.float32),
        y=rng.uniform(50, h - 50, n).astype(np.float32),
        vx=rng.uniform(-3, 3, n).astype(np.float32),
        vy=rng.uniform(-3, 3, n).astype(np.float32),
    )
    eng._flush_pending()
    return eng


def port_boids(n=255, **over):
    eng = Engine(make_config(**{**SCENE, **over}), device="cpu")
    eng.register_entity_class(Boid, n)
    eng.init()
    return spawn(eng, n)


EXACT = [("transform", "active"), ("transform", "entity_type"),
         ("rigid_body", "collision_count")]
FLOAT = [("transform", "x"), ("transform", "y"), ("rigid_body", "px"), ("rigid_body", "py")]


def test_boids_match_reference_frame_by_frame():
    ej = RefEngine(ref_make_config(**SCENE))
    ej.register_entity_class(RefBoid, 255)
    ej.init()
    spawn(ej)
    ej.step(1)  # a world the JAX package built and stepped continues in the port
    et = Engine(config_from(ej.config), device="cpu")
    et.register_entity_class(Boid, 255)
    et.init()
    et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
    assert set(et.world.custom) == {"flocking"}
    tol = 4 * float(np.spacing(np.float32(2000.0)))
    for _frame in range(5):
        mj, mt = ej.step(1), et.step(1)
        assert int(mt["n_binned"]) == int(mj["n_binned"]) == 256
        assert int(mt["active_count"]) == int(mj["active_count"])
        a, b = jax.device_get(ej.world), et.world
        for comp, field in EXACT:
            np.testing.assert_array_equal(getattr(getattr(b, comp), field).numpy(),
                                          np.asarray(getattr(getattr(a, comp), field)))
        for comp, field in FLOAT:
            np.testing.assert_allclose(getattr(getattr(b, comp), field).numpy(),
                                       np.asarray(getattr(getattr(a, comp), field)),
                                       rtol=0, atol=tol, err_msg=f"{comp}.{field}")
    assert et.config.spatial.max_cell_radius == ej.config.spatial.max_cell_radius == 1


def flocking_oracle(eng, snap, i, mouse_down=False):
    """tests/test_boids.py:32-90, copied: the per-neighbour
    transliteration of applyFlockingBehaviors + bounds (boid.js:137-240,
    :322-341) for entity i, over the brute-force neighbour set. A scene of
    boids alone has no predator or prey type, so those hooks stay 0."""
    t, rb = snap.transform, snap.rigid_body
    x, y = np.asarray(t.x, np.float64), np.asarray(t.y, np.float64)
    vx, vy = np.asarray(rb.vx, np.float64), np.asarray(rb.vy, np.float64)
    et = np.asarray(t.entity_type)
    active = np.asarray(t.active)
    vr = float(np.asarray(snap.collider.visual_range)[i])

    def fl(name):
        return float(np.asarray(getattr(snap.custom["flocking"], name))[i])

    n = len(x)
    ax = ay = 0.0
    sep_x = sep_y = 0.0
    cx = cy = avx = avy = 0.0
    same_n = 0
    flee_x = flee_y = 0.0
    pred_type, prey_type = -2, -2  # no predators or prey in a boids scene
    closest_d2, closest_j = np.inf, -1
    prot2 = fl("protected_range") ** 2
    for j in range(n):
        if j == i or not active[j]:
            continue
        d2 = (x[j] - x[i]) ** 2 + (y[j] - y[i]) ** 2
        if not (0 < d2 < vr * vr):
            continue
        if et[j] == 0:  # mouse skipped (boid.js:180)
            continue
        dx, dy = x[j] - x[i], y[j] - y[i]
        if 0 < d2 < prot2:
            sep_x -= dx / d2
            sep_y -= dy / d2
            continue
        if et[j] == et[i]:
            cx += x[j]; cy += y[j]; avx += vx[j]; avy += vy[j]; same_n += 1
        if et[j] == pred_type and d2 > 0:  # prey hook (prey.js:154-169)
            flee_x -= dx / d2
            flee_y -= dy / d2
        if et[j] == prey_type and d2 < closest_d2:  # predator hook
            closest_d2, closest_j = d2, j
    if same_n:
        ax += (cx / same_n - x[i]) * fl("centering_factor")
        ay += (cy / same_n - y[i]) * fl("centering_factor")
        ax += (avx / same_n - vx[i]) * fl("matching_factor")
        ay += (avy / same_n - vy[i]) * fl("matching_factor")
    ax += sep_x * fl("avoid_factor")
    ay += sep_y * fl("avoid_factor")
    # bounds (boid.js:322-341)
    ww, wh = eng.config.world_width, eng.config.world_height
    m, turn = fl("margin"), fl("turn_factor")
    if x[i] < m: ax += turn
    if x[i] > ww - m: ax -= turn
    if y[i] < m: ay += turn
    if y[i] > wh - m: ay -= turn
    return ax, ay, (flee_x, flee_y), (closest_j, closest_d2)


def test_boid_tick_matches_numpy_oracle():
    """One step from a snapshot: the displacement the tick's acceleration
    produced, against the oracle on the same pre-step state (as
    tests/test_boids.py checks Prey), for collision-free boids. Dense
    enough that most boids have neighbours in every term."""
    eng = port_boids(n=255, world_width=700.0, world_height=560.0)
    eng.step(2)
    snap = eng.snapshot()
    eng.step(1)
    after = eng.snapshot()
    damping = eng.config.physics.verlet_damping
    checked = with_neighbors = 0
    for i in range(1, 256):
        if after.rigid_body.collision_count[i] != 0:
            continue
        ax, _ay, _flee, _closest = flocking_oracle(eng, snap, i)
        rb = snap.rigid_body
        cap = float(rb.max_vel[i])
        want_dx = np.clip((float(snap.transform.x[i]) - float(rb.px[i])) * damping + ax, -cap, cap)
        got_dx = float(after.transform.x[i] - snap.transform.x[i])
        np.testing.assert_allclose(got_dx, want_dx, atol=2e-3)
        checked += 1
        with_neighbors += abs(ax) > 1e-6
    assert checked > 100 and with_neighbors > 50


def test_define_component_and_custom_fields():
    Tagged = define_component("TaggedThing", dict(score="f32", level="i32", color="u32",
                                                  on="bool"))
    assert Tagged.SCHEMA["color"] == "u32" and Tagged.DTYPES["color"] == COMPONENT_DTYPES["u32"]
    z = Tagged.zeros(3, "cpu")
    assert z.level.dtype == torch.int32 and z.on.dtype == torch.bool and z.score.shape == (3,)
    with pytest.raises(ValueError, match="unknown dtype"):
        define_component("Bad", dict(v="f64"))

    class Scorer(EntityClass):
        components = [RigidBody, Tagged, ShadowCaster, LightEmitter]
        uses_neighbors = False

        @classmethod
        def setup(cls, ctx):
            return {"tagged_thing.level": 3, "tagged_thing.color": 0xFFFFFFFF,
                    "collider.radius": 0.0}

        @staticmethod
        def tick(ctx):
            return {"tagged_thing.score": ctx.field("tagged_thing.score") + ctx.x,
                    "shadow.height": ctx.x * 0.0 + 2.0}

    eng = Engine(make_config(world_width=400.0, world_height=300.0), device="cpu")
    eng.register_entity_class(Scorer, 5)
    eng.register_entity_class(Boid, 3)  # a radius for the solver
    eng.init()
    assert set(eng.world.custom) == {"tagged_thing", "flocking"}
    for k in range(5):
        eng.spawn("Scorer", x=10.0 * (k + 1), y=20.0)
    eng.spawn("Boid", x=200.0, y=150.0)
    eng.step(2)
    w = eng.world
    tg = w.custom["tagged_thing"]
    assert tg.level[1:6].tolist() == [3] * 5 and tg.color[1].item() == 0xFFFFFFFF
    x0 = eng.snapshot().transform.x
    assert tg.score[1:6].tolist() != [0.0] * 5 and float(tg.score[1]) > 0
    assert w.shadow.height[1:6].tolist() == [2.0] * 5 and w.shadow.active[1:6].all()
    assert w.light.active[1:6].all() and not w.light.active[6:].any()
    assert torch.equal(read_field(w, "tagged_thing.level"), tg.level)
    w2 = write_field(w, "tagged_thing.level", torch.full((9,), 7, dtype=torch.int32))
    assert w2.custom["tagged_thing"].level.tolist() == [7] * 9 and tg.level[1] == 3
    with pytest.raises(KeyError, match="unknown component"):
        read_field(w, "nothing.level")
    # despawns clear every component's active flag, user ones keep their rows
    eng.despawn(2)
    eng.step(1)
    assert not eng.world.shadow.active[2] and not eng.world.transform.active[2]
    assert x0.shape == (9,)


def test_world_from_jax_carries_custom_light_and_shadow():
    ej = RefEngine(ref_make_config(**SCENE))
    ej.register_entity_class(RefBoid, 31)
    ej.init()
    spawn(ej, 31)
    ej.step(1)
    a = jax.device_get(ej.world)
    b = world_from_jax(a, "cpu")
    fl_a, fl_b = a.custom["flocking"], b.custom["flocking"]
    assert [f.name for f in dataclasses.fields(fl_b)] == list(Flocking.SCHEMA)
    for f in Flocking.SCHEMA:
        got = getattr(fl_b, f)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(fl_a, f)))
    for comp in ("light", "shadow"):
        for f in dataclasses.fields(getattr(b, comp)):
            np.testing.assert_array_equal(
                getattr(getattr(b, comp), f.name).numpy(),
                np.asarray(getattr(getattr(a, comp), f.name)).astype(
                    getattr(getattr(b, comp), f.name).numpy().dtype), err_msg=f"{comp}.{f.name}")
    assert b.shadow.shadow_radius[1:].tolist() == [10.0] * 31
    assert b.light.light_color.dtype == torch.int64
