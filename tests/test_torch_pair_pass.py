"""K1, the resident pair pass, and the grid solver around it: the PyTorch
port against the JAX package.

``pair_pass_resident_plain`` (the plain version the CUDA kernel is held to)
runs on the port's layout ``[cap, R+2, C+2]``; the reference kernel
``pair_pass_resident(symmetric=False)`` runs in Pallas interpret mode on the
same values embedded in its own ``[cap, rows_buf, Cp]`` layout, as the
reference's tests run it on the CPU.

Tolerances: contact counts must be exact. Positions are held to 2 float32
ulps at the world's extent: both sides sum the same pushes in the same order,
but XLA:CPU contracts ``dx*dx + dy*dy`` into a fused multiply-add and its
``rsqrt`` is not the correctly rounded ``1/sqrt`` the port uses (the CUDA
kernel uses it too, so the kernel can equal the plain version bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_ref import GoldenState
from test_physics import world_from_golden
from test_physics_grid import make_cfg, random_scene

from multithreadedgameengine_tpu.ops.pallas_kernels import HALO
from multithreadedgameengine_tpu.ops.pallas_kernels import pair_pass_resident as ref_k1
from multithreadedgameengine_tpu.ops.physics_grid import grid_constraints, resident_tile_rows
from multithreadedgameengine_tpu_torch.interop import config_from, world_from_jax
from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
    pair_pass_resident,
    pair_pass_resident_plain,
)
from multithreadedgameengine_tpu_torch.ops.physics_grid import (
    build_layout,
    grid_constraints_resident,
    solver_geometry,
)

torch.set_num_threads(2)

WORLD = 600.0  # make_cfg's world is 600 x 400
POS_TOL = 2 * float(np.spacing(np.float32(WORLD)))


def edge_scene():
    """test_pallas' statics/triggers/world-edges scene."""
    s = GoldenState.of(
        6,
        x=[8.0, 20.0, 592.0, 300.0, 308.0, 300.0],
        y=[8.0, 8.0, 392.0, 200.0, 200.0, 208.0],
        radius=[6.0, 6.0, 6.0, 6.0, 6.0, 6.0],
        static=[False, True, False, False, False, False],
        is_trigger=[False, False, False, False, True, False],
    )
    s.px[:] = s.x
    s.py[:] = s.y
    return s


def zero_elasticity_scene(seed):
    """test_pallas' zero-elasticity scene: entities parked against and
    beyond the world edges with inbound velocity."""
    s = random_scene(seed, n=70)
    s.x[:6] = [2.0, 598.0, 300.0, 1.0, 599.0, 300.0]
    s.y[:6] = [200.0, 200.0, 2.0, 398.0, 1.0, 399.0]
    s.px[:6] = s.x[:6] - 3.0
    s.py[:6] = s.y[:6] - 2.0
    return s


def coincident_scene():
    """Exactly coincident pairs (d^2 == 0): dynamic-dynamic, one against a
    static body and one with a trigger, plus an overlapping neighbour."""
    s = GoldenState.of(
        7,
        x=[100.0, 100.0, 200.0, 200.0, 300.0, 300.0, 104.0],
        y=[100.0, 100.0, 150.0, 150.0, 250.0, 250.0, 103.0],
        radius=[5.0, 7.0, 6.0, 6.0, 4.0, 4.0, 5.0],
        static=[False, False, False, True, False, False, False],
        is_trigger=[False, False, False, False, False, True, False],
    )
    s.px[:] = s.x
    s.py[:] = s.y
    return s


def crowded_scene():
    """Twenty overlapping entities in one cell of capacity 8."""
    rng = np.random.default_rng(11)
    # [91, 104]^2 lies inside one 15-unit solver cell (radius 6)
    x = np.concatenate([91.0 + rng.uniform(0, 13, 20), rng.uniform(20, 580, 30)])
    y = np.concatenate([91.0 + rng.uniform(0, 13, 20), rng.uniform(20, 380, 30)])
    s = GoldenState.of(50, x=x, y=y, radius=np.full(50, 6.0))
    s.px[:] = s.x
    s.py[:] = s.y
    return s


SCENES = {
    "random0": (lambda: random_scene(0, n=70), {}),
    "random3": (lambda: random_scene(3, n=70), {}),
    "edges": (edge_scene, {}),
    "zero_elasticity1": (lambda: zero_elasticity_scene(1), dict(boundary_elasticity=0.0)),
    "zero_elasticity4": (lambda: zero_elasticity_scene(4), dict(boundary_elasticity=0.0)),
    "coincident": (coincident_scene, {}),
    "over_capacity": (crowded_scene, dict(solver_capacity=8)),
}


def scene_worlds(name):
    make, phys = SCENES[name]
    s = make()
    cfg = make_cfg("grid", **phys)
    geom = solver_geometry(config_from(cfg), float(np.max(s.radius)))
    wj = world_from_golden(s, cfg)
    return s, cfg, geom, wj, world_from_jax(jax.device_get(wj), "cpu")


def reference_k1(gx, gy, radius, meta, salt, strength):
    """The JAX package's K1 (interpret mode) on the port's layout values,
    embedded in the reference layout; returns the interior [cap, R, C]."""
    cap, rows, cols = gx.shape
    R, C = rows - 2, cols - 2
    cp = -(-cols // 128) * 128
    tr = resident_tile_rows(cap, cp)
    rows_buf = -(-R // tr) * tr + 2 * HALO

    def embed(a):
        z = np.zeros((cap, rows_buf, cp), a.numpy().dtype)
        z[:, HALO - 1:HALO + R + 1, :cols] = a.numpy()  # border row/col included
        return jnp.asarray(z)

    out = ref_k1(embed(gx), embed(gy), embed(radius), embed(meta), jnp.uint32(salt),
                 strength, tile_rows=tr, interpret=True, symmetric=False)
    return [np.asarray(o)[:, :R, 1:C + 1] for o in out]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_k1_matches_reference_kernel(name):
    s, cfg, geom, _wj, wt = scene_worlds(name)
    lay = build_layout(wt, geom)
    args = (lay.scatter(wt.transform.x), lay.scatter(wt.transform.y),
            lay.radius, lay.meta, 12345, float(cfg.physics.collision_response_strength))
    nx, ny, nc = pair_pass_resident_plain(*args)
    rx, ry, rc = reference_k1(*args)
    interior = (slice(None), slice(1, -1), slice(1, -1))
    np.testing.assert_array_equal(nc[interior].numpy(), rc)
    assert int(nc.sum()) > 0
    np.testing.assert_allclose(nx[interior].numpy(), rx, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(ny[interior].numpy(), ry, rtol=0, atol=POS_TOL)
    # the one-cell border passes through untouched
    border = torch.ones(nx.shape, dtype=torch.bool)
    border[interior] = False
    assert torch.equal(nx[border], args[0][border]) and int(nc[border].sum()) == 0
    if name == "coincident":
        # the hash direction separated every coincident dynamic pair
        moved = (nx != args[0]) | (ny != args[1])
        assert int(moved.sum()) >= 4


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    _s, cfg, geom, _wj, wt = scene_worlds("random0")
    lay = build_layout(wt, geom)
    gx, gy = lay.scatter(wt.transform.x), lay.scatter(wt.transform.y)
    before = cuda_kernels.pair_pass_resident.launches
    a = pair_pass_resident(gx, gy, lay.radius, lay.meta, 3, 0.7)
    b = pair_pass_resident_plain(gx, gy, lay.radius, lay.meta, 3, 0.7)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert cuda_kernels.pair_pass_resident.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="float32"):
        pair_pass_resident(gx.double(), gy, lay.radius, lay.meta, 3, 0.7)
    with pytest.raises(ValueError, match="int32"):
        pair_pass_resident(gx, gy, lay.radius, lay.meta.long(), 3, 0.7)
    with pytest.raises(ValueError, match="shape"):
        pair_pass_resident(gx, gy[:, :-1], lay.radius, lay.meta, 3, 0.7)
    with pytest.raises(ValueError, match="contiguous"):
        t = gx.transpose(1, 2).contiguous().transpose(1, 2)
        pair_pass_resident(t, gy, lay.radius, lay.meta, 3, 0.7)


def test_plain_k1_passes_slots_through():
    """The contract the CUDA kernel is held to on the slots it does not
    move: an occupied slot without a collider, an empty slot and a border
    slot come back bit for bit, -0.0 and NaN kept, with count 0; a collider
    that nothing touches gets x + 0.0, so its -0.0 comes back +0.0."""
    _s, cfg, geom, _wj, wt = scene_worlds("random0")
    off = 5
    c = wt.collider
    active = c.active.clone()
    active[off] = False
    wt = wt.replace(collider=c.replace(active=active))
    lay = build_layout(wt, geom)
    x, y = lay.scatter(wt.transform.x), lay.scatter(wt.transform.y)
    meta = lay.meta
    assert bool(lay.in_grid[off])
    no_coll = tuple(int(i) for i in np.unravel_index(int(lay.flat[off]), meta.shape))
    assert meta[no_coll] != 0 and (int(meta[no_coll]) >> 24) & 1 == 0
    inner = torch.zeros(meta.shape, dtype=torch.bool)
    inner[:, 1:-1, 1:-1] = True
    empty = tuple((inner & (meta == 0)).nonzero()[0].tolist())
    border = (0, 0, 2)
    # a collider without contacts in the unchanged layout: moved to -0.0 it
    # is further still from its neighbours, unless it sits by the left edge
    _nx, _ny, count = pair_pass_resident_plain(x, y, lay.radius, meta, 3, 0.7)
    idle = (((meta >> 24) & 1) == 1) & (count == 0)
    idle[:, :, :4] = False
    lone = tuple(idle.nonzero()[0].tolist())
    for slot, vx, vy in ((no_coll, -0.0, float("nan")), (empty, float("nan"), -0.0),
                         (border, -0.0, float("nan")), (lone, -0.0, float(y[lone]))):
        x[slot], y[slot] = vx, vy
    nx, ny, nc = pair_pass_resident_plain(x, y, lay.radius, meta, 3, 0.7)
    for slot in (no_coll, empty, border):
        for out, inp in ((nx, x), (ny, y)):
            assert int(out[slot].view(torch.int32)) == int(inp[slot].view(torch.int32))
        assert int(nc[slot]) == 0
    assert int(nx[lone].view(torch.int32)) == 0 and int(nc[lone]) == 0  # +0.0
    assert int(nc.sum()) > 0


@pytest.mark.parametrize("name", ["random0", "zero_elasticity1", "zero_elasticity4",
                                  "over_capacity"])
def test_grid_constraints_matches_reference_solver(name):
    """Entity-order outputs of the port's resident solver against the JAX
    package's XLA grid solver, over 2 frames of constraints, at the scene's
    elasticity (0.5 by default, 0 for the zero_elasticity scenes)."""
    _s, cfg, geom, wj, wt = scene_worlds(name)
    pcfg = config_from(cfg)
    step = jax.jit(lambda w: grid_constraints(w, cfg, geom))
    overflow = []
    for frame in range(2):
        wj, nb_j, over_j = step(wj)
        wt, nb_t, over_t = grid_constraints_resident(wt, pcfg, geom)
        wt = wt.replace(step_count=wt.step_count + 1)
        wj = wj.replace(step_count=wj.step_count + 1)
        a = jax.device_get(wj)
        assert int(over_t) == int(over_j) and int(nb_t) == int(nb_j)
        overflow.append(int(over_t))
        np.testing.assert_array_equal(
            wt.rigid_body.collision_count.numpy(), np.asarray(a.rigid_body.collision_count)
        )
        for comp, field in [("transform", "x"), ("transform", "y"),
                            ("rigid_body", "px"), ("rigid_body", "py")]:
            np.testing.assert_allclose(
                getattr(getattr(wt, comp), field).numpy(),
                np.asarray(getattr(getattr(a, comp), field)),
                rtol=0, atol=(frame + 1) * POS_TOL, err_msg=f"{field} frame {frame}",
            )
    assert (overflow[0] > 0) == (name == "over_capacity")
