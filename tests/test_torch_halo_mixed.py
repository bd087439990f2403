"""Slice E2: the halo step's mixed passes (collision events, the device
emit and the particle pool, decals, shadow sprites, ``ctx.gather`` of
undeclared fields, the chunked step), the PyTorch port against the JAX
package and against itself. Every class of ``tests/test_halo_mixed.py`` has
its counterpart here, on the same scene.

Each scene goes through three witnesses from one world: the JAX halo step
on conftest's virtual CPU devices (``make_mesh(D, axis_name="slab")``, as
the reference's test runs it; its solver "auto" stays XLA's grid pass on
the CPU), the port's halo step on the CPU (K3's plain version, "auto"
resolving as "pallas"), and the port's ``Engine.step``. The JAX world is
carried across with ``interop.world_from_jax`` before the first frame.

Tolerances, each with its reason:
- The port's halo step against the port's ``Engine.step``: bit-equal,
  every entity leaf, the event tables, the pool, the canvas, and the
  shadow sprites' active slots. Binning, candidate order, arithmetic and
  summation order are the same on both paths; the shadow sprites are
  compared on static scenes only, since the halo step reads the casters'
  frame-start state (the reference's documented lag).
- The port against the JAX halo step: integer state exact (event tables,
  pair counts, the particles' active flags, the canvas bytes and dirty
  tiles, contact counts); float state within ``POS_ULPS`` float32 ulps at
  the world's extent, and the shadow sprites' values within
  ``SHADOW_ULPS`` ulps of each field's largest magnitude. XLA:CPU fuses
  multiply-adds, approximates ``atan2`` and sums the grid pass's pushes in
  chunks of 8, where the port rounds every operation and sums one slot at
  a time (``tests/test_torch_halo.py``'s bar); the gatherer's tick sums its
  neighbours over slots with gaps, in another order than the reference's
  compacted lists.
- Function level: ``_merge_emissions`` and the light selection with
  ``_slab_shadow_sprites`` against the JAX functions under ``shard_map``
  on hand-made slabs: batches, totals and active slots exact, sprite
  values within ``SHADOW_ULPS``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu_torch as port
import test_halo_mixed as ref_scene
from multithreadedgameengine_tpu.parallel import make_halo_step as ref_make_halo_step
from multithreadedgameengine_tpu.parallel import make_mesh as ref_make_mesh
from multithreadedgameengine_tpu_torch.components import (
    Collider,
    LightEmitter,
    RigidBody,
    ShadowCaster,
    SpriteRenderer,
)
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn

torch.set_num_threads(2)

D = 8
POS_ULPS = 8
SHADOW_ULPS = 4


# ---------------------------------------------------------------------------
# the scene classes of tests/test_halo_mixed.py, for the port (batched
# ticks: a per-particle emit value is [1, emit_cap])
# ---------------------------------------------------------------------------

class _Bumper(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 12.0, "collider.visual_range": 80.0,
                "rigid_body.max_vel": 50.0}

    @staticmethod
    def on_collision_stay(ctx, me, other):
        pass


class _Drifter(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 12.0, "collider.visual_range": 80.0,
                "rigid_body.max_vel": 50.0}


class _Sparker(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False
    emit_cap = 2

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 5.0, "collider.visual_range": 40.0}

    @staticmethod
    def tick(ctx):
        return {"emit": {"count": 2, "vx": torch.tensor([[1.0, -1.0]]), "vy": -2.0,
                         "z": -1.0, "lifespan": 4000.0, "tint": 0x00FF00}}


class _Caster(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer, ShadowCaster]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 8.0, "collider.visual_range": 40.0,
                "rigid_body.static": True,
                "shadow.shadow_radius": 9.0, "shadow.height": 30.0}


class _Lamp(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer, LightEmitter]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 4.0, "collider.visual_range": 190.0,
                "rigid_body.static": True, "light.light_intensity": 500.0,
                "light.light_color": 0xFFEECC, "light.height": 50.0}


class _Stamper(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False
    emit_cap = 2

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 5.0, "collider.visual_range": 40.0}

    @staticmethod
    def tick(ctx):
        return {"emit": {"count": 2, "vx": torch.tensor([[1.5, -1.5]]), "vy": 1.0,
                         "z": -2.0, "vz": 1.0, "gravity": 0.3, "lifespan": 8000.0,
                         "scale": 0.3, "tint": 0xAA2222, "texture_id": 1,
                         "stay_on_the_floor": True}}


class _Gatherer(port.EntityClass):
    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = True
    neighbor_fields = ()

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 6.0, "collider.visual_range": 90.0,
                "rigid_body.max_vel": 50.0}

    @staticmethod
    def tick(ctx):
        m = ctx.neighbor_mask
        nr = ctx.gather("collider.radius")
        nvx = ctx.gather("rigid_body.vx")
        denom = torch.clamp(torch.sum(m, dim=1, dtype=torch.float32), min=1.0)
        avg_r = torch.sum(torch.where(m, nr, 0.0), dim=1) / denom
        avg_vx = torch.sum(torch.where(m, nvx, 0.0), dim=1) / denom
        return {"rigid_body.vx": ctx.vx * 0.9 + avg_vx * 0.1 + avg_r * 0.01}


PORT_CLASSES = {c.__name__: c for c in (_Bumper, _Drifter, _Sparker, _Caster, _Lamp, _Stamper,
                                        _Gatherer)}


def cls_of(pkg, name):
    return getattr(ref_scene, name) if pkg == "jax" else PORT_CLASSES[name]


def engine(pkg, **cfg):
    if pkg == "jax":
        return ref.Engine(ref.make_config(**cfg))
    return port.Engine(port.make_config(**cfg), device="cpu")


# ---------------------------------------------------------------------------
# the scenes (tests/test_halo_mixed.py's scene functions), in either package
# ---------------------------------------------------------------------------

WORLD = dict(world_width=2000.0, world_height=1600.0)


def events_scene(pkg):
    eng = engine(pkg, **WORLD, seed=11,
                 spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0),
                              collision_response_strength=0.2),
                 logic=dict(collision_events=True))
    eng.register_entity_class(cls_of(pkg, "_Bumper"), 31)
    eng.register_entity_class(cls_of(pkg, "_Drifter"), 32)
    eng.init()
    rng = np.random.default_rng(5)
    for name in ("_Bumper",) * 31 + ("_Drifter",) * 32:
        eng.spawn(name, x=float(rng.uniform(50, 1950)), y=float(rng.uniform(50, 1550)),
                  vx=float(rng.uniform(-4, 4)), vy=float(rng.uniform(-4, 4)))
    return eng


def emit_scene(pkg, budget=64):
    eng = engine(pkg, **WORLD, seed=3,
                 spatial=dict(cell_size=100.0, max_neighbors=16, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0)),
                 particle=dict(max_particles=256, max_emit_per_step=budget))
    eng.register_entity_class(cls_of(pkg, "_Sparker"), 63)
    eng.init()
    rng = np.random.default_rng(9)
    eng.spawn_batch("_Sparker", 20, x=rng.uniform(50, 1950, 20).astype(np.float32),
                    y=rng.uniform(50, 1550, 20).astype(np.float32))
    return eng


def shadow_scene(pkg):
    eng = engine(pkg, **WORLD, seed=21, canvas_width=2000, canvas_height=1600,
                 spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0)),
                 lighting=dict(enabled=True, shadows_enabled=True,
                               max_shadow_casting_lights=4, max_shadows_per_light=6))
    eng.register_entity_class(cls_of(pkg, "_Caster"), 59)
    eng.register_entity_class(cls_of(pkg, "_Lamp"), 4)
    eng.init()
    rng = np.random.default_rng(17)
    for _ in range(59):
        eng.spawn("_Caster", x=float(rng.uniform(800, 1200)), y=float(rng.uniform(600, 1000)))
    for k in range(4):
        eng.spawn("_Lamp", x=900.0 + 100.0 * k, y=700.0 + 50.0 * k)
    eng.input.set_camera(1000.0, 800.0, 1.0)
    return eng


def mixed_scene(pkg):
    eng = engine(pkg, **WORLD, seed=33, canvas_width=2000, canvas_height=1600,
                 spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0),
                              collision_response_strength=0.2),
                 logic=dict(collision_events=True),
                 particle=dict(max_particles=128, max_emit_per_step=32),
                 lighting=dict(enabled=True, shadows_enabled=True,
                               max_shadow_casting_lights=2, max_shadows_per_light=4))
    for name, n in (("_Bumper", 29), ("_Sparker", 16), ("_Caster", 16), ("_Lamp", 2)):
        eng.register_entity_class(cls_of(pkg, name), n)
    eng.init()
    rng = np.random.default_rng(41)
    for _ in range(29):
        eng.spawn("_Bumper", x=float(rng.uniform(850, 1150)), y=float(rng.uniform(650, 950)),
                  vx=float(rng.uniform(-3, 3)), vy=float(rng.uniform(-3, 3)))
    for _ in range(8):
        eng.spawn("_Sparker", x=float(rng.uniform(850, 1150)), y=float(rng.uniform(650, 950)))
    for _ in range(12):
        eng.spawn("_Caster", x=float(rng.uniform(900, 1100)), y=float(rng.uniform(700, 900)))
    for k in range(2):
        eng.spawn("_Lamp", x=950.0 + 100.0 * k, y=800.0)
    eng.input.set_camera(1000.0, 800.0, 1.0)
    return eng


def decal_scene(pkg):
    eng = engine(pkg, world_width=1000.0, world_height=800.0, seed=21,
                 spatial=dict(cell_size=50.0, max_neighbors=8),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0)),
                 particle=dict(max_particles=64, decals=True, decals_tile_size=200.0,
                               decals_resolution=0.1))
    eng.register_entity_class(cls_of(pkg, "_Stamper"), 63)
    eng.init()
    rng = np.random.default_rng(9)
    for _ in range(20):
        eng.spawn("_Stamper", x=float(rng.uniform(50, 950)), y=float(rng.uniform(50, 750)))
    return eng


def gather_scene(pkg):
    eng = engine(pkg, **WORLD, seed=31,
                 spatial=dict(cell_size=100.0, max_neighbors=16, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.0)))
    eng.register_entity_class(cls_of(pkg, "_Gatherer"), 63)
    eng.init()
    rng = np.random.default_rng(13)
    for _ in range(48):
        eng.spawn("_Gatherer", x=float(rng.uniform(50, 1950)), y=float(rng.uniform(50, 1550)),
                  vx=float(rng.uniform(-4, 4)), vy=float(rng.uniform(-4, 4)))
    return eng


def drifter_scene(pkg):
    eng = engine(pkg, **WORLD, seed=41,
                 spatial=dict(cell_size=100.0, max_neighbors=16, cell_capacity=16),
                 physics=dict(sub_step_count=1, gravity=(0.0, 0.1)))
    eng.register_entity_class(cls_of(pkg, "_Drifter"), 63)
    eng.init()
    rng = np.random.default_rng(17)
    for _ in range(40):
        eng.spawn("_Drifter", x=float(rng.uniform(50, 1950)), y=float(rng.uniform(50, 1550)),
                  vx=float(rng.uniform(-4, 4)), vy=float(rng.uniform(-4, 4)))
    return eng


def witnesses(scene, **kw):
    """(JAX engine, port engine for the halo step, port engine for
    Engine.step), flushed, the port's two starting from the JAX world."""
    ej = scene("jax", **kw)
    ej._flush_pending()
    ports = []
    for _ in range(2):
        et = scene("torch", **kw)
        et._flush_pending()
        et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
        ports.append(et)
    return ej, *ports


# ---------------------------------------------------------------------------
# runners and comparisons
# ---------------------------------------------------------------------------

class RefHalo:
    def __init__(self, eng, n_dev=D, **kw):
        self.step, place = ref_make_halo_step(eng, ref_make_mesh(n_dev, axis_name="slab"), **kw)
        self.world = place(eng.world)

    def __call__(self, ins):
        self.world, m = self.step(self.world, ins)
        return jax.device_get(self.world), m


class PortHalo:
    def __init__(self, eng, n_dev=D, **kw):
        self.mesh = make_mesh(n_dev, "cpu")
        self.step, place = make_halo_step(eng, self.mesh, **kw)
        self.chunks = place(eng.world)

    def __call__(self, ins):
        self.chunks, m = self.step(self.chunks, ins)
        return unplace_fn(self.chunks, self.mesh), m


def event_rows(w):
    """{kind: rows} of a world of either package, cut to the counts."""
    out = {}
    for kind in ("enter", "stay", "exit"):
        n = int(np.asarray(getattr(w, f"event_{kind}_count")))
        out[kind] = np.asarray(getattr(w, f"event_{kind}"))[:n].tolist()
    return out


def ulps(extent, k):
    return k * float(np.spacing(np.float32(extent)))


def assert_close_to_ref(a, b, extent, fields=(("transform", "x"), ("transform", "y"),
                                             ("rigid_body", "vx"), ("rigid_body", "vy"))):
    """``a`` a JAX world on the host, ``b`` a port world."""
    for comp, f in (("transform", "active"), ("rigid_body", "collision_count")):
        np.testing.assert_array_equal(getattr(getattr(b, comp), f).numpy(),
                                      np.asarray(getattr(getattr(a, comp), f)), err_msg=f)
    for comp, f in fields:
        np.testing.assert_allclose(getattr(getattr(b, comp), f).numpy(),
                                   np.asarray(getattr(getattr(a, comp), f)), rtol=0,
                                   atol=ulps(extent, POS_ULPS), err_msg=f"{comp}.{f}")


def assert_entities_equal(a, b):
    from multithreadedgameengine_tpu_torch.parallel.halo import _get_comp, entity_leaf_specs

    for cname, fname, _dt in entity_leaf_specs(a):
        assert torch.equal(getattr(_get_comp(a, cname), fname),
                           getattr(_get_comp(b, cname), fname)), f"{cname}.{fname}"


def assert_pool_equal(a, b):
    for f in dataclasses.fields(a.particles):
        assert torch.equal(getattr(a.particles, f.name), getattr(b.particles, f.name)), f.name


def assert_pool_matches_ref(a, b):
    """``a`` a JAX world, ``b`` a port world: the pool exact."""
    for f in dataclasses.fields(b.particles):
        np.testing.assert_array_equal(getattr(b.particles, f.name).numpy(),
                                      np.asarray(getattr(a.particles, f.name)), err_msg=f.name)


SHADOW_FIELDS = ("x", "y", "rotation", "scale_x", "scale_y", "alpha", "radius")


def assert_shadows_equal(a, b):
    sa, sb = a.shadow_sprites, b.shadow_sprites
    assert torch.equal(sa.active, sb.active)
    for f in SHADOW_FIELDS:
        assert torch.equal(getattr(sa, f)[sa.active], getattr(sb, f)[sb.active]), f


def assert_shadows_match_ref(a, b):
    on = np.asarray(a.shadow_sprites.active)
    np.testing.assert_array_equal(b.shadow_sprites.active.numpy(), on)
    for f in SHADOW_FIELDS:
        u = getattr(b.shadow_sprites, f).numpy()[on]
        v = np.asarray(getattr(a.shadow_sprites, f))[on]
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(u, v, rtol=0, atol=ulps(scale, SHADOW_ULPS), err_msg=f)


# ---------------------------------------------------------------------------
# the classes of tests/test_halo_mixed.py
# ---------------------------------------------------------------------------

class TestHaloEvents:
    def test_event_tables_match_single_device(self):
        """Every frame's pair count and Enter/Stay/Exit tables: the port's
        halo step equals its Engine.step and the JAX halo step."""
        ej, eh, es = witnesses(events_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        step = rh.step
        assert step.plan.events and step.plan.scope_hooked and step.plan.need_neighbors
        saw = False
        for k in range(12):
            es.step(1)
            a, _mj = rj(ej.input.snapshot())
            b, mt = rh(eh.input.snapshot("cpu"))
            s = es.snapshot()
            assert int(b.collision_pair_count) == int(s.collision_pair_count) == int(
                np.asarray(a.collision_pair_count)), k
            assert int(mt["collision_pair_count"]) == int(b.collision_pair_count)
            assert event_rows(b) == event_rows(s) == event_rows(a), k
            saw = saw or any(event_rows(s).values())
            assert torch.equal(b.transform.x, s.transform.x), k
            assert_close_to_ref(a, b, 2000.0)
        assert saw
        assert_entities_equal(b, s)


class TestHaloEmit:
    def test_emitted_pool_bit_exact(self):
        """The merged emission batch (gid, slot order) fills the pool as the
        single device does; the JAX halo step's pool too."""
        ej, eh, es = witnesses(emit_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        for _ in range(4):
            a, _mj = rj(ej.input.snapshot())
            b, mt = rh(eh.input.snapshot("cpu"))
        es.step(4)
        s = es.snapshot()
        assert_pool_equal(b, s)
        assert_pool_matches_ref(a, b)
        assert int(s.particles.active.sum()) > 0
        assert int(mt["active_particles"]) == int(b.particles.active.sum())
        assert_entities_equal(b, s)

    def test_emit_budget_truncation_matches(self):
        """A budget of 7 against 40 requests a frame: the same drops."""
        ej, eh, es = witnesses(emit_scene, budget=7)
        rj, rh = RefHalo(ej), PortHalo(eh)
        for _ in range(2):
            a, _mj = rj(ej.input.snapshot())
            b, mt = rh(eh.input.snapshot("cpu"))
        es.step(2)
        s = es.snapshot()
        assert_pool_equal(b, s)
        assert_pool_matches_ref(a, b)
        assert int(mt["active_particles"]) == 14


class TestHaloShadows:
    def test_static_scene_shadows_bit_exact(self):
        ej, eh, es = witnesses(shadow_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        assert rh.step.plan.shadows_on and rh.step.plan.need_neighbors
        for _ in range(3):
            a, _mj = rj(ej.input.snapshot())
            b, _mt = rh(eh.input.snapshot("cpu"))
        es.step(3)
        s = es.snapshot()
        assert int(s.shadow_sprites.active.sum()) > 0
        assert_shadows_equal(b, s)
        assert_shadows_match_ref(a, b)
        # slots past a light's casters are zero, as the reference's sum leaves them
        off = ~b.shadow_sprites.active
        assert not b.shadow_sprites.x[off].any() and not b.shadow_sprites.alpha[off].any()


class TestHaloMixedScene:
    def test_predators_style_scene_runs_sharded(self):
        """Events, shadows, particles and the emit in one halo frame."""
        ej, eh, es = witnesses(mixed_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        for k in range(6):
            es.step(1)
            a, _mj = rj(ej.input.snapshot())
            b, mt = rh(eh.input.snapshot("cpu"))
            s = es.snapshot()
            assert event_rows(b) == event_rows(s) == event_rows(a), k
        assert_entities_equal(b, s)
        assert_pool_equal(b, s)
        assert_shadows_equal(b, s)  # the casters are static
        assert_close_to_ref(a, b, 2000.0)
        assert_pool_matches_ref(a, b)
        assert_shadows_match_ref(a, b)
        assert int(mt["route_overflow_logic"]) == 0
        assert int(mt["active_particles"]) == int(s.particles.active.sum()) > 0


class TestHaloDecals:
    def test_decal_canvas_bit_exact(self):
        """Landing stay-on-the-floor particles stamp the shared canvas as
        the single device does."""
        ej, eh, es = witnesses(decal_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        for _ in range(10):
            a, _mj = rj(ej.input.snapshot())
            b, _mt = rh(eh.input.snapshot("cpu"))
        es.step(10)
        s = es.snapshot()
        assert s.decal_canvas.any(), "scene must actually stamp decals"
        assert torch.equal(b.decal_canvas, s.decal_canvas)
        assert torch.equal(b.decal_dirty, s.decal_dirty)
        assert_pool_equal(b, s)
        np.testing.assert_array_equal(b.decal_canvas.numpy(), np.asarray(a.decal_canvas))
        np.testing.assert_array_equal(b.decal_dirty.numpy(), np.asarray(a.decal_dirty))
        assert_pool_matches_ref(a, b)
        # one canvas, shared by every chunk
        assert all(c.decal_canvas is rh.chunks[0].decal_canvas for c in rh.chunks)


class TestHaloUndeclaredGather:
    def test_gathered_tick_bit_exact(self):
        ej, eh, es = witnesses(gather_scene)
        rj, rh = RefHalo(ej), PortHalo(eh)
        for _ in range(8):
            a, _mj = rj(ej.input.snapshot())
            b, _mt = rh(eh.input.snapshot("cpu"))
        es.step(8)
        s = es.snapshot()
        assert_entities_equal(b, s)
        assert_close_to_ref(a, b, 2000.0)
        assert float(s.rigid_body.vx.abs().sum()) > 0


class TestHaloChunkedStep:
    def test_chunked_matches_per_step_with_input_timeline(self):
        """K frames in one call with a per-frame input timeline (the mouse
        sweeping) equal K single frames, and the JAX halo step's K."""
        K = 3
        ej, e1, e3 = witnesses(drifter_scene)

        def snaps(eng, dev=None):
            out = []
            for k in range(K):
                eng.input.set_mouse(200.0 + 400.0 * k, 300.0 + 100.0 * k)
                eng.input.mouse_button(0, True)
                out.append(eng.input.snapshot() if dev is None else eng.input.snapshot(dev))
            return out

        rj, r1 = RefHalo(ej), PortHalo(e1)
        for ins_j, ins_t in zip(snaps(ej), snaps(e1, "cpu")):
            a, _mj = rj(ins_j)
            b1, m1 = r1(ins_t)
        mesh = make_mesh(D, "cpu")
        step3, place3 = make_halo_step(e3, mesh, chunk_steps=K)
        c3, m3 = step3(place3(e3.world), snaps(e3, "cpu"))
        b3 = unplace_fn(c3, mesh)
        assert_entities_equal(b1, b3)
        assert c3[0].step_count == K
        assert m3["active_count"].shape == (K,)
        assert int(m3["active_count"][-1]) == int(m1["active_count"])
        assert_close_to_ref(a, b3, 2000.0)

    def test_chunked_step_with_events(self):
        """The events' difference and prev := cur swap inside a chunk of 6
        frames equal 6 single frames, and the JAX halo step's tables."""
        K = 6
        ej, e1, e6 = witnesses(events_scene)
        rj, r1 = RefHalo(ej), PortHalo(e1)
        for _ in range(K):
            a, _mj = rj(ej.input.snapshot())
            b1, _m1 = r1(e1.input.snapshot("cpu"))
        mesh = make_mesh(D, "cpu")
        step6, place6 = make_halo_step(e6, mesh, chunk_steps=K)
        c6, _m6 = step6(place6(e6.world), [e6.input.snapshot("cpu")] * K)
        b6 = unplace_fn(c6, mesh)
        assert_entities_equal(b1, b6)
        assert event_rows(b6) == event_rows(b1) == event_rows(a)
        assert torch.equal(b6.prev_collision_pairs, b6.collision_pairs)


# ---------------------------------------------------------------------------
# function level: the JAX functions under shard_map on hand-made slabs
# ---------------------------------------------------------------------------

def _ref_shard(fn, n_in, out_specs):
    mesh = ref_make_mesh(4, axis_name="slab")
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("slab"),) * n_in,
                                 out_specs=out_specs, check_vma=False))


@pytest.mark.parametrize("budget", [5, 24, 200])
def test_merge_emissions_matches_reference(budget):
    """Two classes' request blocks (emit caps 2 and 3) on 4 slabs, rows in
    a shuffled gid order with empty rows: the merged batch and its total
    exact, with the budget truncating, exact, and padding."""
    from multithreadedgameengine_tpu.parallel.halo import _merge_emissions as ref_merge
    from multithreadedgameengine_tpu_torch.parallel.halo import _merge_emissions

    rng = np.random.default_rng(budget)
    n_dev, m = 4, 12
    gids = rng.permutation(200)[:n_dev * m].astype(np.int32)
    blocks = []
    for cap in (2, 3):
        valid = rng.random((n_dev * m, cap)) < 0.45
        blocks.append(dict(valid=valid, x=rng.uniform(0, 100, (n_dev * m, cap)).astype(np.float32),
                           texture_id=rng.integers(0, 9, (n_dev * m, cap)).astype(np.int32)))

    def body(g, v0, x0, t0, v1, x1, t1):
        reqs = [{"valid": v0, "fields": {"x": x0, "texture_id": t0}},
                {"valid": v1, "fields": {"x": x1, "texture_id": t1}}]
        batch, total = ref_merge(reqs, g, budget, "slab")
        return batch, total

    args = [jnp.asarray(gids)] + [jnp.asarray(b[k]) for b in blocks
                                  for k in ("valid", "x", "texture_id")]
    rb, rtotal = _ref_shard(body, 7, P())(*args)
    mesh = make_mesh(n_dev, "cpu")
    slabs = []
    for d in range(n_dev):
        sl = slice(d * m, (d + 1) * m)
        reqs = [{"valid": torch.from_numpy(b["valid"][sl]),
                 "fields": {"x": torch.from_numpy(b["x"][sl]),
                            "texture_id": torch.from_numpy(b["texture_id"][sl])}}
                for b in blocks]
        slabs.append((reqs, torch.from_numpy(gids[sl])))
    batch, total = _merge_emissions(mesh, slabs, budget)
    assert int(total) == int(rtotal)
    n = int(total)
    assert 0 < n <= budget
    for k in ("x", "texture_id"):
        assert batch[k].shape == (budget,)
        np.testing.assert_array_equal(batch[k].numpy()[:n], np.asarray(rb[k])[:n], err_msg=k)
    assert _merge_emissions(mesh, [([], s[1]) for s in slabs], budget) == (None, None)


def test_slab_shadow_sprites_matches_reference():
    """Hand-made slabs: lights on every slab (some off screen, one of zero
    intensity, one invalid row), lists with gaps, casters off screen and at
    distance < 1. The global first-L selection and each slab's share equal
    the JAX function's: active slots exact, values within SHADOW_ULPS,
    every other slot zero."""
    from multithreadedgameengine_tpu.parallel.halo import _slab_shadow_sprites as ref_sprites
    from multithreadedgameengine_tpu.ops.spatial import NeighborLists as RefNbr
    from multithreadedgameengine_tpu.ops.spatial import NeighborPayload as RefPayload
    from multithreadedgameengine_tpu_torch.ops.spatial import NeighborLists, NeighborPayload
    from multithreadedgameengine_tpu_torch.parallel.halo import (
        _shadow_selection,
        _slab_lights,
        _slab_shadow_sprites,
    )

    rng = np.random.default_rng(7)
    n_dev, m, S, L, M = 4, 10, 12, 5, 3
    n = n_dev * m
    gid = rng.permutation(1000)[:n].astype(np.int32)
    x = rng.uniform(0, 500, n).astype(np.float32)
    y = rng.uniform(0, 500, n).astype(np.float32)
    l_act = rng.random(n) < 0.5
    intensity = np.where(rng.random(n) < 0.9, rng.uniform(10, 800, n), 0.0).astype(np.float32)
    on_screen = rng.random(n) < 0.85
    valid = rng.random(n) < 0.95
    ids = np.where(rng.random((n, S)) < 0.7, rng.integers(0, 1000, (n, S)), -1).astype(np.int32)
    d2 = np.where(ids >= 0, rng.uniform(0, 4000, (n, S)), 0.0).astype(np.float32)
    d2[:, 0] = np.where(ids[:, 0] >= 0, 0.25, 0.0)  # closer than 1: never a caster
    flat = np.zeros((n, S, 5), np.float32)
    flat[..., 0] = ids
    flat[..., 1] = rng.uniform(0, 500, (n, S))
    flat[..., 2] = rng.uniform(0, 500, (n, S))
    flat[..., 3] = np.where(rng.random((n, S)) < 0.8, rng.uniform(0, 12, (n, S)), -1.0)
    flat[..., 4] = np.where(rng.random((n, S)) < 0.5, rng.uniform(0, 50, (n, S)), 0.0)
    channels = {"transform.x": 1, "transform.y": 2, "__shadow__": 3, "shadow.height": 4}
    cfg = ref.make_config(lighting=dict(enabled=True, shadows_enabled=True,
                                        max_shadow_casting_lights=L, max_shadows_per_light=M))

    def body(g, x_, y_, la, li, os_, va, ids_, d2_, fl):
        local = types.SimpleNamespace(
            transform=types.SimpleNamespace(x=x_, y=y_, active=va),
            light=types.SimpleNamespace(active=la, light_intensity=li),
            sprite=types.SimpleNamespace(is_on_screen=os_))
        nbr = RefNbr(ids=ids_, d2=d2_, count=jnp.sum(ids_ >= 0, axis=1, dtype=jnp.int32),
                     n_binned=jnp.int32(0), payload=RefPayload(data=fl))
        return ref_sprites(local, nbr, fl, g, va, channels, cfg, "slab")

    args = [jnp.asarray(a) for a in (gid, x, y, l_act, intensity, on_screen, valid, ids, d2, flat)]
    ref_out = jax.device_get(_ref_shard(body, 10, P("slab"))(*args))

    from multithreadedgameengine_tpu_torch.interop import config_from

    plan = types.SimpleNamespace(cfg=config_from(cfg), payload_channels=channels)
    lights = []
    for d in range(n_dev):
        sl = slice(d * m, (d + 1) * m)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[sl]))  # noqa: E731
        local = types.SimpleNamespace(
            transform=types.SimpleNamespace(x=t(x), y=t(y), active=t(valid)),
            light=types.SimpleNamespace(active=t(l_act), light_intensity=t(intensity)),
            sprite=types.SimpleNamespace(is_on_screen=t(on_screen)))
        nbr = NeighborLists(ids=t(ids), d2=t(d2), count=(t(ids) >= 0).sum(1).int(),
                            n_binned=torch.tensor(0), payload=NeighborPayload(data=t(flat)))
        lights.append(_slab_lights(local, t(gid), t(valid), nbr, plan))
    sel = _shadow_selection(make_mesh(n_dev, "cpu"), [lt.key for lt in lights], L)
    assert int((sel < 2**31 - 1).sum()) == L  # enough lights to fill the selection
    total_active = 0
    for d, lt in enumerate(lights):
        share = _slab_shadow_sprites(lt, sel, plan.cfg)
        rs = slice(d * L * M, (d + 1) * L * M)
        on = np.asarray(ref_out["active"][rs])
        np.testing.assert_array_equal(share["active"].numpy() > 0, on)
        total_active += int(on.sum())
        for f in SHADOW_FIELDS:
            v = np.asarray(ref_out[f][rs])
            u = share[f].numpy()
            assert not u[~on].any() and not v[~on].any(), f
            scale = max(float(np.abs(v).max()), 1e-30)
            np.testing.assert_allclose(u[on], v[on], rtol=0, atol=ulps(scale, SHADOW_ULPS),
                                       err_msg=f)
    assert total_active > 0
