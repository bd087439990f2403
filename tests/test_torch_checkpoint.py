"""Slice D1, checkpoints: ``checkpoint.py`` and ``Engine.save_checkpoint``/
``load_checkpoint`` of the PyTorch port against the JAX package on the CPU.

The reference's bars (``tests/test_aux.py::TestCheckpoint``, its three
cases, and ``tests/test_round4.py::TestPositionResidency::
test_checkpoint_roundtrip``) through the port, beside the same runs of the
JAX engine; the file format (``world:<leaf path>`` keys, shapes and dtypes,
the ``__host__`` record and the config fingerprint) against a file the JAX
engine writes for the same scene; and files crossing packages: written by
the JAX engine and read by the port, written by the port and read by the
JAX engine, each then stepped beside the engine that wrote it.

Tolerances: a port engine resumed from a port file is bit-equal with the
one that wrote it (every leaf, the pools, the next ``rng()``), as the
reference's bar. Across packages: the file's leaves exact (the same bytes
go in and come out), pool state, flags, contact counts, step counts and
the stream's next draw exact; positions within 2e-3 px after the frames
stepped (``tests/test_torch_plan.py``'s bar and reason).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu_torch as port
from multithreadedgameengine_tpu.checkpoint import _config_fingerprint as ref_fingerprint
from multithreadedgameengine_tpu_torch.checkpoint import _config_fingerprint
from test_torch_plan import (
    POS_ATOL,
    PKGS,
    assert_bit_equal,
    assert_matches_reference,
    balls,
    np_,
    res_engine,
    signature,
)

torch.set_num_threads(2)


def ckpt_balls(pkg, n=40, seed=9, spawned=25):
    """TestCheckpoint's scene: 25 of 40 balls spawned from the stream."""
    eng = balls(pkg, n_balls=n, seed=seed, spawn=False, world_width=1000.0,
                world_height=700.0)
    for _ in range(spawned):
        eng.spawn("Ball", x=eng.rng() * 1000.0, y=eng.rng() * 700.0)
    return eng


def resume(pkg, path, before=10, after=15):
    """Step ``before`` frames, save, step ``after``; load into a fresh
    engine and step ``after``. Returns the two signatures and next draws."""
    eng = ckpt_balls(pkg)
    eng.step(before)
    eng.save_checkpoint(path)
    eng.step(after)
    eng2 = ckpt_balls(pkg)
    eng2.load_checkpoint(path)
    assert eng2.get_pool_stats("Ball")["active"] == 25
    eng2.step(after)
    return signature(eng), signature(eng2), eng.rng(), eng2.rng()


def test_save_load_roundtrip(tmp_path):
    """A resumed port engine equals the one that wrote the file, bit for
    bit, with the stream resuming at the same draw; and the JAX engine's
    run of the same script."""
    a, b, r1, r2 = resume("torch", str(tmp_path / "port.npz"))
    assert_bit_equal(a, b)
    assert r1 == r2
    ja, _jb, jr1, _jr2 = resume("jax", str(tmp_path / "jax.npz"))
    assert r1 == jr1
    assert_matches_reference(ja, a)


def test_mismatched_config_rejected(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    eng = ckpt_balls("torch", n=10, spawned=5)
    eng.step(1)
    eng.save_checkpoint(path)
    with pytest.raises(ValueError, match="different config"):
        ckpt_balls("torch", n=12, spawned=5).load_checkpoint(path)
    with pytest.raises(ValueError, match="different config"):
        ckpt_balls("jax", n=12, spawned=5).load_checkpoint(path)


def drop_class(pkg):
    """TestCheckpoint's ``_Drop``: each emits two particles a frame that
    land and stamp the canvas."""
    mod = ref if pkg == "jax" else port
    if pkg == "jax":
        vx, count, tex = jnp.asarray([1.0, -1.0]), jnp.int32(2), jnp.int32(1)
    else:
        vx, count, tex = torch.tensor([[1.0, -1.0]]), 2, 1

    def tick(ctx):
        return {"emit": {"count": count, "vx": vx, "z": -2.0, "vz": 1.0, "gravity": 0.3,
                         "lifespan": 8000.0, "scale": 0.4, "texture_id": tex,
                         "stay_on_the_floor": True}}

    return type("_Drop", (mod.EntityClass,), {
        "components": [mod.RigidBody, mod.Collider, mod.SpriteRenderer],
        "uses_neighbors": False, "emit_cap": 2,
        "setup": classmethod(lambda c, ctx: {"collider.radius": 6.0,
                                             "collider.visual_range": 40.0}),
        "tick": staticmethod(tick)})


def drop_scene(pkg):
    mod = ref if pkg == "jax" else port
    cfg = mod.make_config(world_width=800.0, world_height=600.0, seed=5,
                          spatial=dict(cell_size=50.0, max_neighbors=8),
                          physics=dict(gravity=(0.0, 0.0)),
                          logic=dict(collision_events=True),
                          particle=dict(max_particles=64, decals=True, decals_tile_size=200.0,
                                        decals_resolution=0.25))
    eng = mod.Engine(cfg) if pkg == "jax" else mod.Engine(cfg, device="cpu")
    eng.register_entity_class(drop_class(pkg), 16)
    eng.init()
    for k in range(8):
        eng.spawn("_Drop", x=100.0 + 60.0 * k, y=200.0)
    return eng


def decal_state(eng):
    w = eng.snapshot()
    return [np_(a) for a in (w.decal_canvas, w.particles.active, w.particles.x,
                             w.prev_collision_pairs, w.transform.x)]


def test_roundtrip_preserves_decal_canvas_and_events(tmp_path):
    """Every leaf rides the file, the stamped canvas and the event tables
    included: a resumed engine continues bit-exact through them, and its
    file reads into the JAX engine with the same canvas and tables."""
    path = str(tmp_path / "decals.npz")
    eng = drop_scene("torch")
    eng.step(8)
    eng.sync()
    assert eng.snapshot().decal_canvas.any()
    eng.save_checkpoint(path)
    eng.step(6)
    eng2 = drop_scene("torch")
    eng2.load_checkpoint(path)
    eng2.step(6)
    for a, b in zip(decal_state(eng), decal_state(eng2)):
        np.testing.assert_array_equal(a, b)
    ej = drop_scene("jax")
    ej.load_checkpoint(path)
    w = jax.device_get(ej.world)
    with np.load(path) as data:
        for key in ("decal_canvas", "particles/active", "prev_collision_pairs",
                    "event_stay", "sprite/tint"):
            leaf = w
            for part in key.split("/"):
                leaf = getattr(leaf, part)
            np.testing.assert_array_equal(np.asarray(leaf), data[f"world:{key}"])


def test_resident_roundtrip_into_a_built_engine(tmp_path):
    """test_round4's residency round trip: a file loaded into an engine
    whose plan is built keeps the solver caches and their stamps (under
    ``port:`` keys), so the run continues bit for bit."""
    a = res_engine("torch", "on", 220, 3)
    a.step(7)
    path = str(tmp_path / "res.npz")
    a.save_checkpoint(path)
    twin = res_engine("torch", "on", 220, 3)
    twin.step(7)
    a.step(10)
    a.load_checkpoint(path)
    assert a.world.solver_pos_step == a.world.step_count == 7
    a.step(10)
    twin.step(10)
    assert_bit_equal(signature(a), signature(twin))


# ---------------------------------------------------------------------------
# the file format, and files crossing packages
# ---------------------------------------------------------------------------

def file_layout(path):
    with np.load(path) as data:
        layout = {k: (data[k].shape, data[k].dtype) for k in data.files
                  if k.startswith("world:")}
        host = json.loads(bytes(data["__host__"]).decode())
    return layout, host


SCENES = {"balls": lambda pkg: ckpt_balls(pkg), "decals_events": drop_scene}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_file_format_matches_reference(tmp_path, scene):
    """The same scene's files from both packages: the same ``world:`` keys
    with the same shapes and dtypes, the same host record, and the same
    values in every leaf but the floats the steps computed."""
    paths = {}
    for pkg in PKGS:
        eng = SCENES[scene](pkg)
        eng.step(2)
        eng.sync()
        paths[pkg] = str(tmp_path / f"{pkg}.npz")
        eng.save_checkpoint(paths[pkg])
    (lj, hj), (lt, ht) = file_layout(paths["jax"]), file_layout(paths["torch"])
    assert lt == lj
    assert ht == hj
    with np.load(paths["jax"]) as dj, np.load(paths["torch"]) as dt:
        for key in lj:
            if dj[key].dtype == np.float32 and key not in ("world:collider/radius",):
                np.testing.assert_allclose(dt[key], dj[key], rtol=0, atol=POS_ATOL, err_msg=key)
            else:
                np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)


def test_fingerprint_matches_reference():
    for make in (ckpt_balls, drop_scene):
        ej, et = make("jax"), make("torch")
        assert _config_fingerprint(et) == ref_fingerprint(ej)
        et.step(1)  # the plan rewrites solver "auto" and the scan radius
        assert et.config.physics.solver == "pallas"
        assert _config_fingerprint(et) == ref_fingerprint(ej)


@pytest.mark.parametrize("writer", PKGS)
def test_file_crosses_packages(tmp_path, writer):
    """A file written after 10 frames by one package and read by the other:
    both continue 15 frames, beside the writer continuing."""
    reader = "torch" if writer == "jax" else "jax"
    path = str(tmp_path / "cross.npz")
    w = ckpt_balls(writer)
    w.step(10)
    w.save_checkpoint(path)
    r = ckpt_balls(reader)
    r.load_checkpoint(path)
    assert r.get_pool_stats("Ball") == w.get_pool_stats("Ball")
    for e in (w, r):
        e.step(15)
    sw, sr = signature(w), signature(r)
    ref_sig, port_sig = (sw, sr) if writer == "jax" else (sr, sw)
    assert_matches_reference(ref_sig, port_sig)
    assert w.rng() == r.rng()
    assert (w.input.camera_x, w.input.camera_y) == (r.input.camera_x, r.input.camera_y)
