"""Slice C2's particle modules against the JAX package, function by
function, on the same numpy inputs: the emitter's host batches, first-fit
pool claims (``apply_emission``), ``update_particles`` (lifetime, gravity to
the floor, fade, the stay-on-the-floor stamp batch), ``apply_tick_emissions``
and the ``"emit"`` tick key, ``stamp_decals`` and
``update_particle_visibility``.

Tolerances: everything here is exact. The emitter is host numpy on the same
Mulberry32 stream. The particle math is elementwise with no multiply-add
that XLA:CPU could contract into a different rounding (``dt`` is a power of
two or 1 in these cases, and the fade is a product of one subtraction). The
decal canvas bytes are exact too: XLA:CPU may contract the blend's
``src_rgb * src_a + ...`` and ``src_a + old_a * (1 - src_a)`` into fused
multiply-adds, which could move a value across a ``.5`` before the
``round(x * 255)``, so the bar would allow 1 in a byte; on these inputs
(64 overlapping stamps, 52 of them valid, over a canvas with transparent
pixels of nonzero rgb) no byte differs.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu.components as ref_components
import multithreadedgameengine_tpu.ops.culling as ref_culling
import multithreadedgameengine_tpu.ops.decals as ref_decals
import multithreadedgameengine_tpu.ops.particles as ref_particles
from multithreadedgameengine_tpu.assets import SpriteRegistry as RefRegistry
from multithreadedgameengine_tpu.config import make_config as ref_make_config
from multithreadedgameengine_tpu.emitter import ParticleEmitterAPI as RefEmitter
from multithreadedgameengine_tpu.inputs import InputController as RefInput
from multithreadedgameengine_tpu.rng import Mulberry32 as RefRng
from multithreadedgameengine_tpu.state import make_world as ref_make_world
from multithreadedgameengine_tpu_torch import Engine, EntityClass, make_config
from multithreadedgameengine_tpu_torch.assets import SpriteRegistry
from multithreadedgameengine_tpu_torch.components import Collider, Particles, SpriteRenderer
from multithreadedgameengine_tpu_torch.emitter import ParticleEmitterAPI, batch_to_device
from multithreadedgameengine_tpu_torch.inputs import InputController
from multithreadedgameengine_tpu_torch.ops import culling, decals, particles
from multithreadedgameengine_tpu_torch.rng import Mulberry32
from multithreadedgameengine_tpu_torch.state import make_world

torch.set_num_threads(2)

PARTICLE = dict(max_particles=600, decals=True, decals_tile_size=64, decals_resolution=0.5)
WORLD = dict(world_width=400.0, world_height=240.0, canvas_width=300, canvas_height=200)


def configs(**particle):
    kw = dict(WORLD, particle=dict(PARTICLE, **particle))
    return make_config(**kw), ref_make_config(**kw)


def random_pool(p: int, seed: int):
    """A pool as numpy columns: live and free slots, particles in the air
    and on the floor, some expiring this frame, faders at every stage,
    stay-on-the-floor ones (more than 64 land)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    lifespan = rng.uniform(100, 3000, p)
    return dict(
        active=rng.random(p) < 0.75,
        x=f32(rng.uniform(-20, 420, p)), y=f32(rng.uniform(-20, 260, p)),
        z=f32(np.where(rng.random(p) < 0.45, 0.0, -rng.uniform(0, 30, p))),
        vx=f32(rng.uniform(-2, 2, p)), vy=f32(rng.uniform(-2, 2, p)),
        vz=f32(rng.uniform(-4, 4, p)),
        lifespan=f32(lifespan), current_life=f32(lifespan - rng.uniform(-5, 60, p)),
        gravity=f32(rng.uniform(0, 0.5, p)), scale=f32(rng.uniform(0.1, 2.0, p)),
        alpha=f32(rng.uniform(0, 1, p)),
        tint=rng.integers(0, 1 << 24, p).astype(np.uint32),
        base_tint=rng.integers(0, 1 << 24, p).astype(np.uint32),
        texture_id=rng.integers(0, 6, p).astype(np.int32),
        fade_on_the_floor=f32(np.where(rng.random(p) < 0.3, rng.uniform(20, 300, p), 0.0)),
        time_on_floor=f32(np.where(rng.random(p) < 0.5, 0.0, rng.uniform(0, 300, p))),
        initial_alpha=f32(rng.uniform(0, 1, p)),
        stay_on_the_floor=rng.random(p) < 0.45,
        is_on_screen=rng.random(p) < 0.5,
    )


def ref_pool(cols):
    return ref_components.Particles(**{k: jnp.asarray(v) for k, v in cols.items()})


def port_pool(cols):
    return Particles(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
                        for k, v in cols.items()})


def assert_same(port, ref, names, what):
    for name in names:
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype),
                                      err_msg=f"{what}.{name}")


POOL_FIELDS = [f for f in Particles.DTYPES]


@pytest.mark.parametrize("dt_ratio", [1.0, 0.5])
def test_update_particles_matches_reference(dt_ratio):
    """Lifetime, gravity to the floor, the floor clamp, the fade and the
    stamp batch (the first 64 landed in pool order, then the first others,
    invalid) on a 600-slot pool."""
    cfg, rcfg = configs()
    cols = random_pool(600, seed=3)
    pool, stamps, n = particles.update_particles(port_pool(cols), cfg, dt_ratio, True)
    rpool, rstamps, rn = ref_particles.update_particles(ref_pool(cols), rcfg, dt_ratio, True)
    assert_same(pool, rpool, POOL_FIELDS, "pool")
    assert_same(stamps, rstamps, ["x", "y", "tint", "scale", "texture_id", "alpha", "valid"],
                "stamps")
    assert int(n) == int(rn)
    assert stamps.x.shape == (64,) and bool(stamps.valid.all())  # more than 64 landed
    landed = cols["active"] & (cols["z"] >= 0) & cols["stay_on_the_floor"]
    assert not bool(pool.active[torch.from_numpy(landed)].any())
    # no stamp batch without decals
    assert particles.update_particles(port_pool(cols), cfg, dt_ratio, False)[1] is None


def fake_engine(pkg: str, max_particles=600):
    """What an emitter reads of its engine: the config, the seeded stream
    and the sprite registry."""
    cfg = (make_config if pkg == "port" else ref_make_config)(
        **WORLD, particle=dict(PARTICLE, max_particles=max_particles))
    sprites = (SpriteRegistry if pkg == "port" else RefRegistry)()
    for name in ("bunny", "blood", "spark"):
        sprites.register_texture(name)
    return types.SimpleNamespace(config=cfg, rng=(Mulberry32 if pkg == "port" else RefRng)(77),
                                 sprites=sprites)


def queue(emitter):
    emitter.emit(count=5, x=100.0, y=100.0, z=-10.0, vx=1.0, vy=0.0, lifespan=5000.0,
                 gravity=0.0)
    emitter.emit(count={"min": 3, "max": 9}, x=(10.0, 20.0), y=0.0, z=-10.0,
                 angle_xy=(0.0, 360.0), speed=(0.5, 2.0), lifespan=(500.0, 900.0),
                 scale=(0.1, 0.2), tint={"min": 0xAAAAAA, "max": 0xFFFFFF}, texture="spark",
                 fade_on_the_floor=120.0)
    emitter.emit_batch(x=[5.0, 50.0, 75.0], y=[6.0, 60.0, 70.0], count={"min": 4, "max": 8},
                       texture="blood", z=-30.0, angle_xy={"min": 0.0, "max": 360.0},
                       speed={"min": 0.7, "max": 1.66}, vz={"min": -4.0, "max": 0.0},
                       lifespan=6000.0, gravity=0.15, scale={"min": 0.1, "max": 0.2},
                       alpha={"min": 0.4, "max": 0.9}, tint={"min": 0xAAAAAA, "max": 0xFFFFFF},
                       stay_on_the_floor=True)
    emitter.emit_batch(x=[1.0, 2.0], y=[3.0, 4.0], count=3, tint=0x123456)


def test_emitter_batches_match_reference():
    """Every column of the queued batch, drawn from the same stream, and the
    stream's position after it."""
    ep, er = fake_engine("port"), fake_engine("ref")
    port, ref = ParticleEmitterAPI(ep), RefEmitter(er)
    queue(port)
    queue(ref)
    (bp, n_p), (br, n_r) = port.build_batch(), ref.build_batch()
    assert n_p == n_r and n_p > 16 and bp.keys() == br.keys()
    for k in bp:
        np.testing.assert_array_equal(bp[k], br[k], err_msg=k)
        assert bp[k].dtype == br[k].dtype, k
    assert ep.rng() == er.rng()
    assert port.build_batch() == (None, 0)


@pytest.mark.parametrize("max_particles,occupied", [(600, 0.6), (16, 0.5)],
                         ids=["first_fit", "exhausted"])
def test_apply_emission_first_fit_matches_reference(max_particles, occupied):
    """The queued batch claims the first free slots in pool order; past the
    free count the excess drops (``tests/test_particles.py``'s
    ``test_pool_exhaustion_drops_excess``)."""
    ep, er = fake_engine("port", max_particles), fake_engine("ref", max_particles)
    port, ref = ParticleEmitterAPI(ep), RefEmitter(er)
    queue(port)
    queue(ref)
    (bp, n), (br, _n) = port.build_batch(), ref.build_batch()
    cols = random_pool(max_particles, seed=11)
    cols["active"] = np.random.default_rng(4).random(max_particles) < occupied
    pool, spawned = particles.apply_emission(port_pool(cols), batch_to_device(bp, "cpu"), n)
    rpool, rspawned = ref_particles.apply_emission(ref_pool(cols), br, jnp.int32(n))
    assert_same(pool, rpool, POOL_FIELDS, "pool")
    assert int(spawned) == int(rspawned)
    free = int((~cols["active"]).sum())
    assert int(spawned) == min(free, n)
    if max_particles == 16:
        assert bool(pool.active.all())


def emit_requests(pkg: str):
    """Two classes' request blocks: [3 entities, emit_cap 4] and [5, 2]."""
    rng = np.random.default_rng(9)
    out = []
    for count, cap in ((3, 4), (5, 2)):
        valid = rng.random((count, cap)) < 0.7
        fields = {
            "x": rng.uniform(0, 400, (count, cap)), "y": rng.uniform(0, 240, (count, cap)),
            "z": -rng.uniform(0, 5, (count, cap)), "vx": rng.uniform(-1, 1, (count, cap)),
            "vy": rng.uniform(-1, 1, (count, cap)), "vz": rng.uniform(-1, 1, (count, cap)),
            "lifespan": rng.uniform(100, 900, (count, cap)),
            "gravity": rng.uniform(0, 0.3, (count, cap)),
            "scale": rng.uniform(0.1, 1, (count, cap)),
            "alpha": rng.uniform(0, 1, (count, cap)),
            "tint": rng.integers(0, 1 << 24, (count, cap)),
            "texture_id": rng.integers(0, 4, (count, cap)),
            "fade_on_the_floor": rng.uniform(0, 100, (count, cap)),
            "stay_on_the_floor": rng.random((count, cap)) < 0.5,
        }
        types_ = dict(tint=(np.uint32, torch.int64), texture_id=(np.int32, torch.int32),
                      stay_on_the_floor=(np.bool_, torch.bool))
        conv = {}
        for k, v in fields.items():
            npt, tt = types_.get(k, (np.float32, torch.float32))
            conv[k] = (torch.from_numpy(v.astype(npt)).to(tt) if pkg == "port"
                       else jnp.asarray(v.astype(npt)))
        vv = torch.from_numpy(valid) if pkg == "port" else jnp.asarray(valid)
        out.append({"fields": conv, "valid": vv})
    return out


@pytest.mark.parametrize("budget", [64, 6], ids=["all", "budget"])
def test_apply_tick_emissions_matches_reference(budget):
    cols = random_pool(32, seed=2)
    pool, spawned = particles.apply_tick_emissions(port_pool(cols), emit_requests("port"), budget)
    rpool, rspawned = ref_particles.apply_tick_emissions(ref_pool(cols), emit_requests("ref"),
                                                         budget)
    assert_same(pool, rpool, POOL_FIELDS, "pool")
    assert int(spawned) == int(rspawned) > 0


class Sparkler(EntityClass):
    """``tests/test_round2.py``'s emitter class in the port's batched form:
    three particles a frame, per-particle vx as a ``[1, emit_cap]`` row."""

    components = [Collider, SpriteRenderer]
    uses_neighbors = False
    emit_cap = 4

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 2.0}

    @staticmethod
    def tick(ctx):
        return {"emit": {
            "count": 3,
            "vx": torch.tensor([[1.0, 2.0, 3.0, 4.0]]),
            "vy": -5.0, "z": -1.0, "lifespan": 500.0, "tint": 0xFF0000,
        }}


@pytest.mark.parametrize("budget,want", [(1024, (3, 6)), (2, (2, 4))], ids=["all", "budget"])
def test_emit_tick_key_spawns_particles(budget, want):
    """The ``"emit"`` key through ``Engine.step`` (``tests/test_round2.py::
    TestDeviceEmit``): x and y default to the emitter's position, the
    per-particle row is cut at count, the budget drops the excess."""
    eng = Engine(make_config(world_width=500.0, world_height=500.0,
                             spatial=dict(cell_size=50.0, max_neighbors=8),
                             particle=dict(max_particles=64, max_emit_per_step=budget)),
                 device="cpu")
    eng.register_entity_class(Sparkler, 2)
    eng.init()
    eng.spawn("Sparkler", x=100.0, y=200.0)
    m = eng.step(1)
    pool = eng.world.particles
    live = pool.active
    assert int(live.sum()) == want[0] == int(m["active_particles"])
    assert bool((pool.x[live] == 100.0).all() and (pool.y[live] == 200.0).all())
    assert sorted(pool.vx[live].tolist()) == [1.0, 2.0, 3.0][:want[0]]
    assert bool((pool.tint[live] == 0xFF0000).all())
    eng.step(1)
    assert int(eng.world.particles.active.sum()) == want[1]


def decal_inputs(seed=6, n=64):
    """A canvas with transparent pixels of nonzero rgb, and 64 stamps, most
    clustered so that their patches overlap, a few at the edges, a third
    invalid."""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (120, 200, 4)).astype(np.uint8)
    canvas[rng.random((120, 200)) < 0.3, 3] = 0
    dirty = rng.random((4, 7)) < 0.1
    x = np.where(rng.random(n) < 0.8, rng.normal(150, 12, n), rng.uniform(-30, 430, n))
    y = np.where(rng.random(n) < 0.8, rng.normal(110, 12, n), rng.uniform(-30, 270, n))
    cols = dict(
        x=x.astype(np.float32), y=y.astype(np.float32),
        tint=rng.integers(0, 1 << 24, n).astype(np.uint32),
        scale=rng.uniform(0.05, 3.0, n).astype(np.float32),
        texture_id=rng.integers(-1, 7, n).astype(np.int32),
        alpha=rng.uniform(0, 1, n).astype(np.float32),
        valid=rng.random(n) < 0.7,
    )
    return canvas, dirty, cols


def test_stamp_decals_matches_reference():
    cfg, rcfg = configs()
    canvas, dirty, cols = decal_inputs()
    stamps = particles.StampBatch(**{k: torch.from_numpy(
        v.astype(np.int64) if v.dtype == np.uint32 else v) for k, v in cols.items()})
    rstamps = ref_particles.StampBatch(**{k: jnp.asarray(v) for k, v in cols.items()})
    out, out_dirty = decals.stamp_decals(torch.from_numpy(canvas), torch.from_numpy(dirty),
                                         stamps, decals.default_decal_textures(5, "cpu"), cfg)
    rout, rdirty = ref_decals.stamp_decals(jnp.asarray(canvas), jnp.asarray(dirty), rstamps,
                                           ref_decals.default_decal_textures(5), rcfg)
    rout = np.asarray(rout)
    diff = np.abs(out.numpy().astype(np.int16) - rout.astype(np.int16))
    assert diff.max() == 0, (diff.max(), int((diff > 0).sum()))
    np.testing.assert_array_equal(out_dirty.numpy(), np.asarray(rdirty))
    assert torch.equal(decals.default_decal_textures(5, "cpu"),
                       torch.from_numpy(ref_decals.default_decal_textures(5)))
    # the inputs stay as they were; every stamp rewrites its patch, so
    # transparent pixels that no source covers end with rgb 0
    assert np.array_equal(canvas, decal_inputs()[0])
    o = out.numpy()
    wiped = (o[..., 3] == 0) & (o[..., :3] == 0).all(-1) & (canvas[..., :3] != 0).any(-1)
    assert int(wiped.sum()) > 0
    assert decals.canvas_shape(cfg) == ref_decals.canvas_shape(rcfg) == (120, 200)
    assert decals.tile_grid_shape(cfg) == ref_decals.tile_grid_shape(rcfg) == (4, 7)
    assert int((out.numpy() != canvas).any(-1).sum()) > 2000


def test_round_half_to_even_matches_jax():
    """The canvas's uint8 round trip: torch.round and jnp.round both round
    half to even."""
    v = np.asarray([0.5, 1.5, 2.5, 3.5, 254.5, 253.5, -0.5, 127.49999, 127.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))
    assert torch.round(torch.tensor([0.5, 1.5, 2.5])).tolist() == [0.0, 2.0, 2.0]


def test_update_particle_visibility_matches_reference():
    cfg, rcfg = configs()
    cols = random_pool(600, seed=8)
    w = make_world(4, "cpu", max_particles=600).replace(particles=port_pool(cols))
    rw = ref_make_world(4, max_particles=600).replace(particles=ref_pool(cols))
    inp, rinp = InputController(), RefInput()
    for c in (inp, rinp):
        c.camera_x, c.camera_y, c.camera_zoom = 40.0, 30.0, 1.5
    out = culling.update_particle_visibility(w, cfg, inp.snapshot("cpu")).particles
    rout = ref_culling.update_particle_visibility(rw, rcfg, rinp.snapshot()).particles
    assert_same(out, rout, ["is_on_screen"], "particles")
    on = out.is_on_screen & out.active
    assert 0 < int(on.sum()) < int(out.active.sum())
    assert culling.update_particle_visibility(make_world(4, "cpu"), cfg, inp.snapshot("cpu")) \
        .particles is None
