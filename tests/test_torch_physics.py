"""ops/physics.py of the PyTorch port against the JAX package: verlet_move,
_boundary, update_derived and _pair_hash_dir on the same seeded inputs.

Tolerances: XLA:CPU contracts ``a * b + c`` into one fused multiply-add and
computes ``rsqrt`` and ``atan2`` with its own approximations, while the port
rounds every operation separately (IEEE, as its CUDA kernel does). Each
affected result can therefore differ in its last bit or two; the bounds
below are stated in float32 ulps of the values compared. Everything the
formulas only select, clamp or compare is exact.
"""

import jax
import numpy as np
import pytest
import torch

from golden_ref import GoldenState
from test_physics import world_from_golden
from test_physics_grid import make_cfg, random_scene

from multithreadedgameengine_tpu.ops import physics as ref
from multithreadedgameengine_tpu_torch.interop import config_from, world_from_jax
from multithreadedgameengine_tpu_torch.ops import physics as port

torch.set_num_threads(2)


def ulps(a, b):
    """Largest distance between a and b in float32 ulps of the larger."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / scale))


def both_worlds(s: GoldenState, cfg):
    wj = world_from_golden(s, cfg)
    return wj, world_from_jax(jax.device_get(wj), "cpu")


def moving_scene(seed):
    s = random_scene(seed, n=200)
    rng = np.random.default_rng(seed + 100)
    s.ax[:] = rng.uniform(-2, 2, 200)
    s.ay[:] = rng.uniform(-2, 2, 200)
    s.px[:] = s.x - rng.uniform(-60, 60, 200)  # some beyond max_vel
    s.max_vel[::7] = 0.0  # default cap 100
    return s


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dt_ratio", [1.0, 0.5])
def test_verlet_move_matches_reference(seed, dt_ratio):
    cfg = make_cfg("grid")
    wj, wt = both_worlds(moving_scene(seed), cfg)
    a = jax.device_get(ref.verlet_move(wj, cfg, dt_ratio))
    b = port.verlet_move(wt, config_from(cfg), dt_ratio)
    for comp, field in [("transform", "x"), ("transform", "y"), ("rigid_body", "px"),
                        ("rigid_body", "py"), ("rigid_body", "vx"),
                        ("rigid_body", "vy"), ("rigid_body", "ax"), ("rigid_body", "ay")]:
        x = np.asarray(getattr(getattr(a, comp), field))
        y = getattr(getattr(b, comp), field).numpy()
        # one fused multiply-add in the displacement: <= 1 ulp of the
        # displacement, which is <= 1 ulp of the position it is added to
        assert ulps(x, y) <= 1.0, field


@pytest.mark.parametrize("elasticity", [0.0, 0.5, 1.0])
def test_boundary_matches_reference_exactly(elasticity):
    rng = np.random.default_rng(3)
    x = rng.uniform(-20, 620, 500).astype(np.float32)
    px = x - rng.uniform(-5, 5, 500).astype(np.float32)
    r = rng.uniform(2, 12, 500).astype(np.float32)
    moving = rng.random(500) > 0.2
    a = ref._boundary(x, px, r, 600.0, moving, elasticity)
    b = port._boundary(*(torch.from_numpy(v) for v in (x, px, r)), 600.0,
                       torch.from_numpy(moving), elasticity)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))


@pytest.mark.parametrize("seed", [0, 1])
def test_update_derived_matches_reference(seed):
    cfg = make_cfg("grid")
    s = moving_scene(seed)
    rng = np.random.default_rng(seed)
    s.vx[:] = rng.uniform(-5, 5, 200)
    s.vy[:] = rng.uniform(-5, 5, 200)
    s.vx[:10] = 0.01  # below min_speed_for_rotation
    s.vy[:10] = 0.0
    wj, wt = both_worlds(s, cfg)
    a = jax.device_get(ref.update_derived(wj, cfg)).rigid_body
    b = port.update_derived(wt, config_from(cfg)).rigid_body
    # speed: sqrt of a contracted sum, within 2 ulp; angle: XLA's atan2,
    # within 2 ulp of its range (pi) before the + pi/2 shift
    assert ulps(a.speed, b.speed.numpy()) <= 2.0
    err = np.abs(np.asarray(a.velocity_angle, np.float64) - b.velocity_angle.numpy())
    assert err.max() <= 2 * np.spacing(np.float32(np.pi))
    np.testing.assert_array_equal(
        np.asarray(a.velocity_angle) == 0, b.velocity_angle.numpy() == 0
    )


@pytest.mark.parametrize("salt", [0, 7, 2**31 + 5, 2**32 - 1])
def test_pair_hash_dir_matches_reference(salt):
    rng = np.random.default_rng(salt % 1000)
    i = rng.integers(0, 1 << 24, 2000).astype(np.int32)
    j = rng.integers(0, 1 << 24, 2000).astype(np.int32)
    ux_a, uy_a = ref._pair_hash_dir(i, j, np.uint32(salt))
    ux_b, uy_b = port._pair_hash_dir(torch.from_numpy(i), torch.from_numpy(j), salt)
    # the uint32 hash is exact; the normalisation differs by XLA's rsqrt
    assert ulps(ux_a, ux_b.numpy()) <= 2.0
    assert ulps(uy_a, uy_b.numpy()) <= 2.0
    # pair-consistent: (i, j) and (j, i) give the same direction
    ux_c, uy_c = port._pair_hash_dir(torch.from_numpy(j), torch.from_numpy(i), salt)
    np.testing.assert_array_equal(ux_b.numpy(), ux_c.numpy())
    np.testing.assert_array_equal(uy_b.numpy(), uy_c.numpy())


def test_sqrt_is_correctly_rounded():
    """The plain versions' square root equals IEEE float32 sqrt (numpy's),
    which is what the CUDA kernel's sqrtf computes."""
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.uniform(0, 5000, 200_000), rng.uniform(0, 1e-3, 1000),
                        [0.0, 1.0, 2.0, np.float32(3e38)]]).astype(np.float32)
    np.testing.assert_array_equal(port._sqrt(torch.from_numpy(v)).numpy(), np.sqrt(v))
