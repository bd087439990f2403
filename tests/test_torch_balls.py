"""The ported slice end to end: the balls scene through the JAX package and
through the PyTorch port (CPU, plain kernel versions), from one seed.

A reduced scene (400 balls in a 1200 x 800 world, the demo's physics) runs
5 frames with the mouse held down over the balls and the 'm' key down for
one frame. Integer and boolean state must match exactly. Positions and
velocities are held to 2e-3 (16 float32 ulps at the world's extent): the
JAX package on the CPU runs the XLA grid solver, which sums each 8-slot
chunk of pushes as a tree, contracts ``a*b + c`` into fused multiply-adds
and uses an approximate ``rsqrt``, while the port rounds every operation and
sums in K1's order; the dense pile carries those last-bit differences from
frame to frame (measured: 6.4e-4 after 5 frames).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_engine
from multithreadedgameengine_tpu_torch.components import BUILTIN_COMPONENTS
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

torch.set_num_threads(2)

SCENE = dict(n_balls=400, seed=123456, world_width=1200.0, world_height=800.0)
FRAMES, M_KEY_FRAME, HANDOFF = 5, 2, 3
POS_ATOL = 2e-3
EXACT = [("rigid_body", "collision_count"), ("sprite", "is_on_screen"),
         ("transform", "active")]
CLOSE = [("transform", "x"), ("transform", "y"), ("rigid_body", "px"),
         ("rigid_body", "py"), ("rigid_body", "vx"), ("rigid_body", "vy")]


def drive(eng, frame):
    """The inputs of one frame: mouse held over the balls, 'm' for one frame."""
    eng.input.set_mouse(600.0, 400.0)
    eng.input.mouse_button(0, True)
    (eng.input.key_down if frame == M_KEY_FRAME else eng.input.key_up)("m")


def as_np(world_field):
    return world_field.numpy() if isinstance(world_field, torch.Tensor) else np.asarray(world_field)


@pytest.fixture(scope="module")
def runs():
    """Per-frame host copies of the reference, the port, and the port
    continuing from the reference's world after frame HANDOFF."""
    ej = ref_engine(**SCENE)
    et = make_balls_engine(device="cpu", **SCENE)
    eh = make_balls_engine(device="cpu", **SCENE)
    ref, port, handoff = [], [], {}
    for frame in range(FRAMES):
        for e in (ej, et, eh):
            drive(e, frame)
        ej.step(1)
        et.step(1)
        ref.append(ej.snapshot())
        port.append(et.snapshot())
        if frame + 1 == HANDOFF:
            eh.restore(world_from_jax(ref[-1], "cpu"))
        elif frame + 1 > HANDOFF:
            eh.step(1)
            handoff[frame] = eh.snapshot()
    return ref, port, handoff


def compare(a, b, atol):
    for comp, field in EXACT:
        np.testing.assert_array_equal(
            as_np(getattr(getattr(b, comp), field)), as_np(getattr(getattr(a, comp), field)),
            err_msg=f"{comp}.{field}")
    for comp, field in CLOSE:
        np.testing.assert_allclose(
            as_np(getattr(getattr(b, comp), field)), as_np(getattr(getattr(a, comp), field)),
            rtol=0, atol=atol, err_msg=f"{comp}.{field}")
    assert b.step_count == int(a.step_count)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_slice_matches_reference(runs, frame):
    ref, port, _ = runs
    compare(ref[frame], port[frame], POS_ATOL)
    if frame == 0:
        assert int(port[0].rigid_body.collision_count.sum()) > 0


@pytest.mark.parametrize("frame", range(HANDOFF, FRAMES))
def test_handoff_from_reference_world(runs, frame):
    """The port continues a reference world handed over after frame 3."""
    ref, _, handoff = runs
    compare(ref[frame], handoff[frame], POS_ATOL)


@pytest.mark.parametrize("fast_spawn", [False, True])
def test_spawned_world_matches_reference_exactly(fast_spawn):
    """Every field of every ported component, right after the spawns land,
    in the port's declared dtypes (no float64 from numpy)."""
    kw = dict(SCENE, n_balls=300, fast_spawn=fast_spawn)
    ej = ref_engine(**kw)
    et = make_balls_engine(device="cpu", **kw)
    a, b = ej.snapshot(), et.snapshot()
    for name, cls in BUILTIN_COMPONENTS.items():
        for field, dtype in cls.DTYPES.items():
            got = getattr(getattr(b, name), field)
            assert got.dtype == dtype, f"{name}.{field}"
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(getattr(a, name), field)).astype(got.numpy().dtype),
                err_msg=f"{name}.{field}")


def test_pools_despawn_and_respawn_match_reference():
    kw = dict(SCENE, n_balls=64)
    ej = ref_engine(**kw)
    et = make_balls_engine(device="cpu", **kw)
    for e in (ej, et):
        for i in (5, 9, 9, 40):  # a double despawn is a no-op
            e.despawn(i)
        e.spawn("Ball", x=10.0, y=20.0)
        e.spawn("Ball", x=30.0, y=40.0, vx=1.0)
    for name in ("Mouse", "Ball"):
        assert et.get_pool_stats(name) == ej.get_pool_stats(name)
        np.testing.assert_array_equal(et.classes[name].pool.free, ej.classes[name].pool.free)
    a, b = ej.snapshot(), et.snapshot()
    for comp, field in [("transform", "active"), ("transform", "x"), ("rigid_body", "px"),
                        ("collider", "radius"), ("sprite", "tint")]:
        np.testing.assert_array_equal(
            as_np(getattr(getattr(b, comp), field)),
            as_np(getattr(getattr(a, comp), field)).astype(
                as_np(getattr(getattr(b, comp), field)).dtype))


def test_snapshot_restore_replays_identically():
    eng = make_balls_engine(device="cpu", **dict(SCENE, n_balls=120))
    eng.step(1)
    snap = eng.snapshot()
    eng.step(2)
    first = eng.snapshot()
    eng.restore(snap)
    eng.step(2)
    second = eng.snapshot()
    for name in BUILTIN_COMPONENTS:
        for f in dataclasses.fields(getattr(first, name)):
            assert torch.equal(getattr(getattr(first, name), f.name),
                               getattr(getattr(second, name), f.name)), f"{name}.{f.name}"
    assert first.step_count == second.step_count == 3


def test_tick_despawn_and_reconcile_match_reference():
    """A tick returning ``despawn`` clears the active flags in the step, and
    reconcile_pools hands the slots back, as in the reference."""
    import jax.numpy as jnp

    import multithreadedgameengine_tpu as ref_pkg
    import multithreadedgameengine_tpu_torch as port_pkg

    class RefDoomed(ref_pkg.EntityClass):
        components = [ref_pkg.RigidBody, ref_pkg.Collider]
        uses_neighbors = False

        @staticmethod
        def tick(ctx):
            return {"despawn": ctx.x < 300.0, "rigid_body.ax": jnp.where(ctx.y > 200.0, 1.0, ctx.ax)}

    class PortDoomed(port_pkg.EntityClass):
        components = [port_pkg.RigidBody, port_pkg.Collider]
        uses_neighbors = False

        @staticmethod
        def tick(ctx):
            return {"despawn": ctx.x < 300.0, "rigid_body.ax": torch.where(ctx.y > 200.0, 1.0, ctx.ax)}

    kw = dict(world_width=600.0, world_height=400.0, seed=3,
              physics=dict(gravity=(0.0, 0.5), sub_step_count=2))
    engines = [ref_pkg.Engine(**kw), port_pkg.Engine(device="cpu", **kw)]
    for eng, cls in zip(engines, (RefDoomed, PortDoomed)):
        eng.register_entity_class(cls, 40)
        eng.init()
        for _ in range(40):
            eng.spawn(cls.__name__, x=eng.rng() * 600.0, y=eng.rng() * 400.0,
                      radius=eng.rng() * 5.0 + 3.0)
        eng.step(1)
    a, b = engines[0].snapshot(), engines[1].snapshot()
    for comp in ("transform", "rigid_body", "collider"):
        np.testing.assert_array_equal(getattr(b, comp).active.numpy(),
                                      np.asarray(getattr(a, comp).active))
    assert 0 < int(b.transform.active.sum()) < 41
    assert engines[1].reconcile_pools() == engines[0].reconcile_pools()
    np.testing.assert_array_equal(engines[1].classes["PortDoomed"].pool.free,
                                  engines[0].classes["RefDoomed"].pool.free)
