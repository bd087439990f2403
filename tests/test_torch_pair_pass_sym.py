"""K2, the predicated Newton-symmetric pair pass: the PyTorch port's plain
version against the JAX package's kernel, against K1, and the predication.

``pair_pass_symmetric_plain`` (the plain version the CUDA kernel is held to)
runs on the port's layout ``[cap, R+2, C+2]``; the reference kernel
``pair_pass_resident(symmetric=True)`` runs in Pallas interpret mode on the
same values embedded in its own ``[cap, rows_buf, Cp]`` layout, as the
reference's tests run it on the CPU. The reference runs with 8-row tiles, so
every scene spans several tiles and the spill rows carry reciprocals across
tile boundaries.

Tolerances: contact counts exact. Positions within 2 float32 ulps at the
world's extent of the JAX kernel: the pair arithmetic is the same, but
XLA:CPU contracts ``dx*dx + dy*dy`` into a fused multiply-add and its
``rsqrt`` is not the correctly rounded ``1/sqrt`` the port uses, and the
reference adds the spilled reciprocals of a tile's first row after
everything else, where the port adds them in their place (measured: at most
1 ulp). Against K1 the bar is the reference's own for symmetric against
two-sided, 1e-3 (tests/test_pallas.py), counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pair_pass import POS_TOL, SCENES, scene_worlds

from multithreadedgameengine_tpu.ops.pallas_kernels import HALO
from multithreadedgameengine_tpu.ops.pallas_kernels import pair_pass_resident as ref_kernel
from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
    clamp_moving,
    pair_pass_resident_plain,
    pair_pass_symmetric,
    pair_pass_symmetric_plain,
)
from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout

torch.set_num_threads(2)

WORLD = (600.0, 400.0)  # make_cfg's world
TILE_ROWS = 8


def layout_args(name, salt=12345):
    _s, cfg, geom, _wj, wt = scene_worlds(name)
    lay = build_layout(wt, geom)
    return (lay.scatter(wt.transform.x), lay.scatter(wt.transform.y), lay.radius,
            lay.meta, salt, float(cfg.physics.collision_response_strength))


def reference_k2(gx, gy, radius, meta, salt, strength, clamp_bounds=None):
    """The JAX package's K2 (interpret mode, 8-row tiles) on the port's
    layout values, embedded in the reference layout; returns the full port
    layout shape with the border rows and columns of the reference's
    output."""
    cap, rows, cols = gx.shape
    R = rows - 2
    cp = -(-cols // 128) * 128
    rows_buf = -(-R // TILE_ROWS) * TILE_ROWS + 2 * HALO

    def embed(a):
        z = np.zeros((cap, rows_buf, cp), a.numpy().dtype)
        z[:, HALO - 1:HALO + R + 1, :cols] = a.numpy()
        return jnp.asarray(z)

    out = ref_kernel(embed(gx), embed(gy), embed(radius), embed(meta), jnp.uint32(salt),
                     strength, tile_rows=TILE_ROWS, interpret=True, symmetric=True,
                     clamp_bounds=clamp_bounds)
    return [np.asarray(o)[:, :R, 1:cols - 1] for o in out]


INTERIOR = (slice(None), slice(1, -1), slice(1, -1))


@pytest.mark.parametrize("clamp", [False, True], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_k2_matches_reference_kernel(name, clamp):
    args = layout_args(name)
    bounds = WORLD if clamp else None
    nx, ny, nc = pair_pass_symmetric_plain(*args, clamp_bounds=bounds)
    rx, ry, rc = reference_k2(*args, clamp_bounds=bounds)
    np.testing.assert_array_equal(nc[INTERIOR].numpy(), rc)
    assert int(nc.sum()) > 0
    np.testing.assert_allclose(nx[INTERIOR].numpy(), rx, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ny[INTERIOR].numpy(), ry, rtol=0, atol=POS_TOL)
    # the border takes part in no pair
    border = torch.ones(nx.shape, dtype=torch.bool)
    border[INTERIOR] = False
    assert torch.equal(nx[border], args[0][border]) and int(nc[border].sum()) == 0
    if clamp and name.startswith("zero_elasticity"):
        # entities parked beyond the world's edges: the folded clamp moved them
        cx, _cy = clamp_moving(args[0], args[1], args[2], args[3], WORLD)
        assert int((cx != args[0]).sum()) > 0
        assert float(nx[args[3] != 0].min()) >= 0.0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_k2_matches_k1(name):
    """The reference's bar for symmetric against two-sided: positions within
    1e-3, contact counts exact."""
    args = layout_args(name)
    sx, sy, sc = pair_pass_symmetric_plain(*args)
    kx, ky, kc = pair_pass_resident_plain(*args)
    assert torch.equal(sc, kc)
    torch.testing.assert_close(sx, kx, rtol=0, atol=1e-3)
    torch.testing.assert_close(sy, ky, rtol=0, atol=1e-3)


def test_clamp_equals_clamping_first():
    """The folded clamp is the separate clamp of moving slots followed by
    the unclamped pass, bit for bit."""
    args = layout_args("zero_elasticity1")
    cx, cy = clamp_moving(args[0], args[1], args[2], args[3], WORLD)
    a = pair_pass_symmetric_plain(*args, clamp_bounds=WORLD)
    b = pair_pass_symmetric_plain(cx, cy, *args[2:])
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_predication_changes_no_value():
    """A thread stops scanning a cell at its first empty slot: the slots
    past it contribute exactly zero. Filling empty slots with far-away
    garbage positions (meta 0, so never a collider) must change nothing,
    and planes left empty above the occupied ones must change nothing."""
    args = layout_args("over_capacity")
    gx, gy, radius, meta = args[:4]
    empty = meta == 0
    noise = torch.from_numpy(np.random.default_rng(5).uniform(-1e4, 1e4, gx.shape)
                             .astype(np.float32))
    junk = (torch.where(empty, noise, gx), torch.where(empty, -noise, gy),
            torch.where(empty, 7.0, radius), meta)
    a = pair_pass_symmetric_plain(*args)
    b = pair_pass_symmetric_plain(*junk, *args[4:])
    for u, v in zip(a, b):
        assert torch.equal(u[~empty], v[~empty])
    # cells fill slots rank-ascending: above plane 0, every occupied slot
    # has an occupied slot below it, so a scan may stop at the first empty
    occ = meta != 0
    assert not bool((occ[1:] & ~occ[:-1]).any())
    # four more empty planes on top: same values on the original planes
    pad = lambda t: torch.cat([t, torch.zeros((4,) + tuple(t.shape[1:]), dtype=t.dtype)])
    c = pair_pass_symmetric_plain(*(pad(t) for t in args[:4]), *args[4:])
    for u, v in zip(a, c):
        assert torch.equal(u, v[: u.shape[0]])


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    args = layout_args("random0")
    before = cuda_kernels.pair_pass_symmetric.launches
    for bounds in (None, WORLD):
        a = pair_pass_symmetric(*args, clamp_bounds=bounds)
        b = pair_pass_symmetric_plain(*args, clamp_bounds=bounds)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert cuda_kernels.pair_pass_symmetric.launches == before  # no kernel ran
    gx, gy, radius, meta, salt, strength = args
    with pytest.raises(ValueError, match="float32"):
        pair_pass_symmetric(gx.double(), gy, radius, meta, salt, strength)
    with pytest.raises(ValueError, match="int32"):
        pair_pass_symmetric(gx, gy, radius, meta.long(), salt, strength)
    with pytest.raises(ValueError, match="shape"):
        pair_pass_symmetric(gx, gy[:, :-1], radius, meta, salt, strength)
