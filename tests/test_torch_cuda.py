"""K1 and K2 on the card: each CUDA kernel against its plain PyTorch
version (K2 with and without the folded clamp), the wrappers' checks and
launch counts, and the ported slices on ``cuda`` against the same slices on
``cpu``. Marked ``cuda``; each test skips without a card.
On a machine with one, run them with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q``
(``--noconftest`` because the test directory's conftest sets up JAX, which
these tests do not use).

Tolerance: contact counts exact; positions within 2 float32 ulps at the
world's extent. The kernel is built with --fmad=false and uses IEEE sqrt and
division, so it is expected to equal the plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
    pair_pass_resident,
    pair_pass_resident_plain,
    pair_pass_symmetric,
    pair_pass_symmetric_plain,
)
from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout
from multithreadedgameengine_tpu_torch.ops.spatial import GridGeom
from multithreadedgameengine_tpu_torch.state import make_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def random_layout(seed, n, cap, device, world=(600.0, 400.0)):
    rng = np.random.default_rng(seed)
    w = make_world(n, device)

    def t(v, dtype=torch.float32):
        return torch.as_tensor(v, dtype=dtype, device=device)

    x = rng.uniform(0, world[0], n)
    y = rng.uniform(0, world[1], n)
    x[1], y[1] = x[0], y[0]  # one exactly coincident pair
    x[2:6] = [-3.0, world[0] + 2.0, 1.0, world[0] - 1.0]  # outside [r, extent - r]
    w = w.replace(
        transform=w.transform.replace(active=t(rng.random(n) > 0.05, torch.bool),
                                      x=t(x), y=t(y)),
        rigid_body=w.rigid_body.replace(active=t(np.ones(n), torch.bool),
                                        static=t(rng.random(n) < 0.1, torch.bool)),
        collider=w.collider.replace(active=t(rng.random(n) > 0.05, torch.bool),
                                    is_trigger=t(rng.random(n) < 0.1, torch.bool),
                                    radius=t(rng.uniform(3, 12, n))),
    )
    geom = GridGeom(cell_size=30.0, rows=int(world[1] // 30) + 1,
                    cols=int(world[0] // 30) + 1, capacity=cap)
    lay = build_layout(w, geom)
    return (lay.scatter(w.transform.x), lay.scatter(w.transform.y), lay.radius,
            lay.meta, seed * 7919, 0.8)


@pytest.mark.parametrize("seed,n,cap", [(0, 400, 8), (1, 1500, 16), (2, 3000, 12)])
def test_k1_matches_plain_on_card(cuda, seed, n, cap):
    args = random_layout(seed, n, cap, cuda)
    before = cuda_kernels.pair_pass_resident.launches
    kx, ky, kc = pair_pass_resident(*args)
    assert cuda_kernels.pair_pass_resident.launches == before + 1
    px, py, pc = pair_pass_resident_plain(*args)
    torch.cuda.synchronize()
    tol = 2 * float(np.spacing(np.float32(600.0)))
    assert torch.equal(kc, pc) and int(kc.sum()) > 0
    assert (kx - px).abs().max().item() <= tol
    assert (ky - py).abs().max().item() <= tol


@pytest.mark.parametrize("clamp", [False, True], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("seed,n,cap", [(0, 400, 8), (1, 1500, 16), (2, 3000, 12)])
def test_k2_matches_plain_on_card(cuda, seed, n, cap, clamp):
    """K2 computes each slot's sums in the plain version's order with the
    same rounding, so it is expected to equal it bit for bit."""
    args = random_layout(seed, n, cap, cuda)
    bounds = (600.0, 400.0) if clamp else None
    before = cuda_kernels.pair_pass_symmetric.launches
    kx, ky, kc = pair_pass_symmetric(*args, clamp_bounds=bounds)
    assert cuda_kernels.pair_pass_symmetric.launches == before + 1
    px, py, pc = pair_pass_symmetric_plain(*args, clamp_bounds=bounds)
    torch.cuda.synchronize()
    tol = 2 * float(np.spacing(np.float32(600.0)))
    assert torch.equal(kc, pc) and int(kc.sum()) > 0
    assert (kx - px).abs().max().item() <= tol
    assert (ky - py).abs().max().item() <= tol


def test_wrapper_checks_inputs_on_card(cuda):
    gx, gy, r, m, salt, s = random_layout(0, 200, 8, cuda)
    with pytest.raises(ValueError, match="is on"):
        pair_pass_resident(gx, gy.cpu(), r, m, salt, s)
    with pytest.raises(ValueError, match="int32"):
        pair_pass_resident(gx, gy, r, m.long(), salt, s)
    with pytest.raises(ValueError, match="contiguous"):
        pair_pass_resident(gx[:, :, ::2], gy[:, :, ::2], r[:, :, ::2], m[:, :, ::2], salt, s)
    with pytest.raises(ValueError, match="is on"):
        pair_pass_symmetric(gx, gy, r.cpu(), m, salt, s)


def test_slice_on_card_matches_cpu(cuda):
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    snaps = []
    for device in (cuda, "cpu"):
        eng = make_balls_engine(n_balls=400, seed=123456, device=device,
                                world_width=1200.0, world_height=800.0)
        eng.input.set_mouse(600.0, 400.0)
        eng.input.mouse_button(0, True)
        eng.step(3)
        snaps.append(eng.snapshot())
    a, b = snaps
    assert torch.equal(a.rigid_body.collision_count, b.rigid_body.collision_count)
    tol = 2 * float(np.spacing(np.float32(1200.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol


def test_resident_slice_on_card_matches_cpu(cuda):
    """Slice B on the card (K2, the caches, residency, band, lazy chunk)
    against the same frames on the CPU."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    snaps = []
    for device in (cuda, "cpu"):
        eng = make_balls_engine(n_balls=400, seed=123456, device=device,
                                world_width=1200.0, world_height=800.0,
                                physics=dict(sub_step_count=2, verlet_damping=0.99,
                                             boundary_elasticity=0.0,
                                             collision_response_strength=0.8,
                                             gravity=(0.0, 0.5), rebin_interval=3,
                                             solver_predicated="on"))
        eng.input.set_mouse(600.0, 400.0)
        eng.input.mouse_button(0, True)
        eng.step(5)
        assert eng._plan.residency and eng._plan.symmetric and eng.lazy_frames > 0
        snaps.append(eng.snapshot())
    a, b = snaps
    assert torch.equal(a.rigid_body.collision_count, b.rigid_body.collision_count)
    tol = 2 * float(np.spacing(np.float32(1200.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol
