"""K1-K4 on the card: each CUDA kernel against its plain PyTorch version
(K2 with and without the folded clamp; K4 bit for bit), the edges of the
tiled passes K1, K2 and K3 (full cells, non-colliders among a cell's
occupants, grids that are ragged against the tile or narrower than it,
capacities 1 to 64, the capacity limit), K1's bit-for-bit pass-through of
the slots it does not move, a hand-made layout (a coincident pair, a
full cell, a pile against the edges, entities outside the world), K4's
placement at the probe's shapes, the wrappers' checks and launch counts (K4
raising, not falling back, without its library), no kernel spilling
registers, every case of the kernel table (``torch_scenes.CASES``) against
its plain version and its scene's launch counts, and the ported slices on
``cuda`` against the same slices on ``cpu`` (the boids scene and its halo
step included). Marked ``cuda``;
each test skips without a card. The scenes' card tests are
``tests/test_torch_cuda_scenes.py``. On a machine with one, run them with
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

import torch_scenes
from multithreadedgameengine_tpu_torch.dryrun import rung_collectives
from multithreadedgameengine_tpu_torch.ops import _build
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


def hand_made_layout(device):
    """A layout made by hand: a pile against the world's left and bottom
    edges with a static and a trigger in it, an exactly coincident pair,
    one cell holding more entities than its capacity (two left out), and
    moving entities outside ``[r, extent - r]`` on every side. Returns the
    pass's arguments and the coincident pair's slots."""
    pts = [
        # pile at the bottom-left corner (world 300 x 200)
        (6.0, 194.0, 6.0), (14.0, 194.0, 6.0), (8.0, 184.0, 6.0), (3.0, 188.0, 5.0),
        # a static body and a trigger overlapping dynamic ones
        (100.0, 100.0, 8.0), (110.0, 104.0, 6.0), (104.0, 110.0, 6.0),
        # exactly coincident pair
        (200.0, 60.0, 5.0), (200.0, 60.0, 5.0),
        # six entities in one 30-unit cell of capacity 4
        (245.0, 155.0, 4.0), (250.0, 158.0, 4.0), (255.0, 152.0, 4.0),
        (248.0, 162.0, 4.0), (252.0, 150.0, 4.0), (258.0, 160.0, 4.0),
        # moving entities past each border, two of them overlapping
        (-4.0, 80.0, 5.0), (2.0, 84.0, 5.0), (303.0, 40.0, 6.0),
        (150.0, -2.0, 4.0), (170.0, 205.0, 7.0),
    ]
    n = len(pts)
    w = make_world(n, device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    flag = lambda i: torch.arange(n, device=device) == i  # noqa: E731
    on = torch.ones(n, dtype=torch.bool, device=device)
    w = w.replace(
        transform=w.transform.replace(active=on, x=f32([p[0] for p in pts]),
                                      y=f32([p[1] for p in pts])),
        rigid_body=w.rigid_body.replace(active=on, static=flag(4)),
        collider=w.collider.replace(active=on, is_trigger=flag(5),
                                    radius=f32([p[2] for p in pts])),
    )
    lay = build_layout(w, GridGeom(cell_size=30.0, rows=7, cols=10, capacity=4))
    assert int((~lay.in_grid).sum()) == 2
    args = (lay.scatter(w.transform.x), lay.scatter(w.transform.y), lay.radius, lay.meta, 17, 0.8)
    return args, torch.stack([lay.flat[7], lay.flat[8]])


@pytest.mark.parametrize("kernel,clamp", [("resident", False), ("symmetric", False),
                                          ("symmetric", True)],
                         ids=["K1", "K2", "K2_clamp"])
def test_pair_passes_on_a_hand_made_layout_on_card(cuda, kernel, clamp):
    """K1 and K2 (with and without its folded clamp) against their plain
    versions on :func:`hand_made_layout`: the same contact counts, positions
    within 2 ulps at the world's extent, the coincident pair pushed apart,
    and with the clamp every moving entity inside the world."""
    args, pair = hand_made_layout(cuda)
    kw = {"clamp_bounds": (300.0, 200.0)} if clamp else {}
    fn = getattr(cuda_kernels, f"pair_pass_{kernel}")
    kx, ky, kc = fn(*args, **kw)
    px, py, pc = getattr(cuda_kernels, f"pair_pass_{kernel}_plain")(*args, **kw)
    torch.cuda.synchronize()
    tol = 2 * float(np.spacing(np.float32(300.0)))
    assert torch.equal(kc, pc) and int(kc.sum()) > 0
    assert (kx - px).abs().max().item() <= tol and (ky - py).abs().max().item() <= tol
    moved = ((kx.view(-1)[pair] != args[0].view(-1)[pair])
             | (ky.view(-1)[pair] != args[1].view(-1)[pair]))
    assert bool(moved.all())
    if clamp:
        occupied = args[3] != 0
        assert bool(((kx[occupied] >= 0) & (kx[occupied] <= 300.0)).all())


def random_grid(seed, n, cap, device, world=(600.0, 400.0), cell=30.0):
    """A bordered solver grid [R+2, C+2, cap] from the halo step's own
    packing and binning, with its border rows filled from entities above
    and below the interior (the halo rows a slab's neighbours write)."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import (
        pack_solver_rows,
        scatter_solver_grid,
    )
    from multithreadedgameengine_tpu_torch.ops.spatial import bin_entities

    rng = np.random.default_rng(seed)
    w = make_world(n, device)
    R, C = int(world[1] // cell), int(world[0] // cell)
    x = torch.as_tensor(rng.uniform(0, world[0], n), dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.uniform(-cell, world[1] + cell, n), dtype=torch.float32,
                        device=device)
    x[1], y[1] = x[0], y[0]  # one exactly coincident pair
    on = torch.ones(n, dtype=torch.bool, device=device)
    w = w.replace(
        transform=w.transform.replace(active=on, x=x, y=y),
        rigid_body=w.rigid_body.replace(
            active=on, static=torch.as_tensor(rng.random(n) < 0.1, device=device)),
        collider=w.collider.replace(
            active=torch.as_tensor(rng.random(n) > 0.05, device=device),
            is_trigger=torch.as_tensor(rng.random(n) < 0.1, device=device),
            radius=torch.as_tensor(rng.uniform(3, 12, n), dtype=torch.float32,
                                   device=device)),
    )
    # rows -1 .. R: the border rows are binned too, then shifted down by one
    geom = GridGeom(cell_size=cell, rows=R + 2, cols=C, capacity=cap)
    row = torch.clamp(torch.floor(y / cell).to(torch.int32) + 1, 0, R + 1)
    col = torch.clamp((x / cell).to(torch.int32), 0, C - 1)
    bins = bin_entities(x, y, on, geom, build_table=False, row=row, col=col)
    ok = bins.rank < cap
    flat = ((bins.row.long() * (C + 2) + bins.col.long() + 1) * cap + bins.rank.long())
    total = (R + 2) * (C + 2) * cap
    grid = scatter_solver_grid(pack_solver_rows(w), torch.where(ok, flat, total), R, C, cap)
    return (grid[..., 0].contiguous(), grid[..., 1].contiguous(),
            grid[..., 4:7].contiguous(), seed * 7919, 0.8)


@pytest.mark.parametrize("seed,n,cap", [(0, 400, 8), (1, 1500, 16), (2, 3000, 12)])
def test_k3_matches_plain_on_card(cuda, seed, n, cap):
    """K3 sums each slot's pushes in the plain version's order with the
    same rounding, so it is expected to equal it bit for bit; the border
    rows are occupied and must be read."""
    args = random_grid(seed, n, cap, cuda)
    before = cuda_kernels.pair_pass_grid.launches
    kx, ky, kc = cuda_kernels.pair_pass_grid(*args)
    assert cuda_kernels.pair_pass_grid.launches == before + 1
    px, py, pc = cuda_kernels.pair_pass_grid_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc) and int(kc.sum()) > 0
    assert int(kc[1].sum()) > 0 and int(kc[-2].sum()) > 0  # contacts next to the border
    # 2 ulps at the displacements' own scale (of order 1 px), not the world's
    scale = max(px.abs().max().item(), py.abs().max().item())
    tol = 2 * float(np.spacing(np.float32(scale)))
    assert (kx - px).abs().max().item() <= tol
    assert (ky - py).abs().max().item() <= tol


def assert_bit_equal(got, want):
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


#: the tiled passes' edge cases: (id, entities, capacity, world), 30-unit
#: cells; "full" ones fill every cell of the world
EDGE_CASES = [
    ("cap1", 300, 1, (600.0, 400.0)),
    ("cap4_full", 1600, 4, (240.0, 150.0)),
    ("cap12_ragged", 3000, 12, (630.0, 390.0)),
    ("cap16_narrow", 600, 16, (60.0, 450.0)),
    ("cap16_one_row", 400, 16, (1000.0, 30.0)),
    ("cap64_full", 5400, 64, (150.0, 120.0)),
]


@pytest.mark.parametrize("name,n,cap,world", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_k3_edges_bit_equal_on_card(cuda, name, n, cap, world):
    """K3 equals its plain version bit for bit on the tiled pass's edges."""
    args = random_grid(cap, n, cap, cuda, world=world)
    gid, flags = args[2][..., 2], args[2][..., 1].to(torch.int32)
    occ = gid != -1
    if "full" in name:
        assert bool((occ.sum(-1)[:, 1:-1] == cap).all())
        # an occupied slot without a collider before an occupied collider slot
        no_coll = occ & ((flags & 1) == 0)
        assert bool((no_coll[..., :-1] & ((flags[..., 1:] & 1) == 1)).any())
    got = cuda_kernels.pair_pass_grid(*args)
    want = cuda_kernels.pair_pass_grid_plain(*args)
    torch.cuda.synchronize()
    assert int(want[2].sum()) > 0
    assert_bit_equal(got, want)


def assert_full_with_non_colliders(meta, cap, world):
    """Every world cell of a "full" layout holds ``cap`` entities, and an
    occupied slot without a collider sits below an occupied collider."""
    occ = meta != 0
    world_cells = int(world[0] // 30) * int(world[1] // 30)
    assert int((occ.sum(0) == cap).sum()) >= world_cells
    no_coll = occ & (((meta >> 24) & 1) == 0)
    assert bool((no_coll[:-1] & (((meta[1:] >> 24) & 1) == 1)).any())


@pytest.mark.parametrize("name,n,cap,world", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_k1_edges_bit_equal_on_card(cuda, name, n, cap, world):
    """K1 equals its plain version bit for bit on the tiled pass's edges."""
    args = random_layout(cap, n, cap, cuda, world=world)
    if "full" in name:
        assert_full_with_non_colliders(args[3], cap, world)
    got = pair_pass_resident(*args)
    want = pair_pass_resident_plain(*args)
    torch.cuda.synchronize()
    assert int(want[2].sum()) > 0
    assert_bit_equal(got, want)


def test_k1_passes_slots_through_bit_for_bit_on_card(cuda):
    """The slots K1 does not move -- an occupied slot without a collider, an
    empty slot, a border slot -- come back bit for bit, -0.0 and NaN
    included, with count 0; a collider that nothing touches gets x + 0.0,
    so its -0.0 comes back +0.0."""
    x, y, radius, meta, salt, strength = random_layout(5, 400, 8, cuda)
    x, y = x.clone(), y.clone()
    inner = torch.zeros_like(meta, dtype=torch.bool)
    inner[:, 1:-1, 1:-1] = True
    occ = meta != 0
    coll = ((meta >> 24) & 1) == 1
    no_coll = tuple((occ & ~coll).nonzero()[0].tolist())
    empty = tuple((~occ & inner).nonzero()[0].tolist())
    border = (0, 0, 3)
    # a collider at least 3 columns from the left edge: at x = -0.0 it is
    # 60 px or more from every neighbour, beyond any contact (radius <= 12)
    far = coll.clone()
    far[:, :, :4] = False
    lone = tuple(far.nonzero()[0].tolist())
    for slot, vx, vy in ((no_coll, -0.0, float("nan")), (empty, float("nan"), -0.0),
                         (border, -0.0, float("nan")), (lone, -0.0, y[lone].item())):
        x[slot], y[slot] = vx, vy
    args = (x, y, radius, meta, salt, strength)
    got = pair_pass_resident(*args)
    want = pair_pass_resident_plain(*args)
    torch.cuda.synchronize()
    assert_bit_equal(got, want)
    for slot in (no_coll, empty, border):
        for out, inp in ((got[0], x), (got[1], y)):
            assert int(out[slot].view(torch.int32)) == int(inp[slot].view(torch.int32))
        assert int(got[2][slot]) == 0
    assert int(got[0][lone].view(torch.int32)) == 0  # +0.0
    assert int(got[2][lone]) == 0


@pytest.mark.parametrize("clamp", [False, True], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("name,n,cap,world", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_k2_edges_bit_equal_on_card(cuda, name, n, cap, world, clamp):
    """K2 equals its plain version bit for bit on the tiled pass's edges,
    with and without the folded clamp."""
    args = random_layout(cap, n, cap, cuda, world=world)
    if "full" in name:
        assert_full_with_non_colliders(args[3], cap, world)
    bounds = world if clamp else None
    got = pair_pass_symmetric(*args, clamp_bounds=bounds)
    want = pair_pass_symmetric_plain(*args, clamp_bounds=bounds)
    torch.cuda.synchronize()
    assert int(want[2].sum()) > 0
    assert_bit_equal(got, want)


@pytest.mark.parametrize("kernel", ["grid", "symmetric", "resident"])
def test_capacity_limit_on_card(cuda, kernel):
    """At its capacity limit (a 1 x 1 tile in nearly all of the block's
    shared memory) the tiled pass runs and equals its plain version; one
    slot more raises ValueError naming the limit."""
    from multithreadedgameengine_tpu_torch.ops import _build

    limit = getattr(_build.load(), f"pair_pass_{kernel}_max_cap")()
    assert limit >= 64
    for cap in (limit, limit + 1):
        if kernel == "grid":
            x = torch.zeros((3, 3, cap), device=cuda)
            x[1, 1, :2] = torch.tensor([10.0, 12.0])
            attrs = torch.zeros((3, 3, cap, 3), device=cuda)
            attrs[..., 2] = -1.0
            attrs[1, 1, :2] = torch.tensor([[5.0, 1.0, 0.0], [5.0, 1.0, 1.0]])
            args = (x, torch.zeros_like(x), attrs, 3, 0.8)
            fn, plain = cuda_kernels.pair_pass_grid, cuda_kernels.pair_pass_grid_plain
        else:
            x = torch.zeros((cap, 3, 3), device=cuda)
            x[:2, 1, 1] = torch.tensor([10.0, 12.0])
            radius = torch.zeros_like(x)
            radius[:2, 1, 1] = 5.0
            meta = torch.zeros((cap, 3, 3), dtype=torch.int32, device=cuda)
            meta[:2, 1, 1] = torch.tensor([1 << 24, 1 | (1 << 24)], dtype=torch.int32)
            args = (x, torch.zeros_like(x), radius, meta, 3, 0.8)
            fn, plain = ((pair_pass_symmetric, pair_pass_symmetric_plain) if kernel == "symmetric"
                         else (pair_pass_resident, pair_pass_resident_plain))
        if cap > limit:
            with pytest.raises(ValueError, match=f"capacity {cap} is above {limit}"):
                fn(*args)
        else:
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            assert int(want[2].sum()) == 2
            assert_bit_equal(got, want)


def test_tile_picks_on_card(cuda):
    """The tile each pass takes: sized by shared memory for grids that give
    every SM a block (K1 and K2 on the 1M ladder layout, K3 on the 1M halo
    slab grid), smaller where the grid would leave SMs idle (K1 on the 10k
    demo layout: 4 x 8 cells, 224 blocks, not 4 x 32 and 56)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cuda_kernels.tile_of("pair_pass_symmetric", (12, 536, 1203)) == (4, 32)
    assert cuda_kernels.tile_of("pair_pass_resident", (12, 536, 1203)) == (4, 32)
    assert cuda_kernels.tile_of("pair_pass_grid", (136, 1203, 16)) == (4, 16)
    tr, tc = cuda_kernels.tile_of("pair_pass_resident", (8, 56, 123))
    assert -(-54 // tr) * -(-121 // tc) >= sms
    if sms == 132:  # an H100 SXM
        assert (tr, tc) == (4, 8)


def test_halo_step_on_card_matches_cpu(cuda):
    """The halo step (K3 on 4 slabs) on the card against the same frames on
    the CPU (plain versions)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn

    out = []
    for device in (cuda, "cpu"):
        eng = make_balls_engine(n_balls=255, seed=99, device=device, world_width=1600.0,
                                world_height=1000.0)
        eng._flush_pending()
        mesh = make_mesh(4, device)
        step, place = make_halo_step(eng, mesh, oversub=4.0)
        chunks = place(eng.world)
        for _ in range(5):
            chunks, _m = step(chunks, eng.input.snapshot(device))
        out.append(unplace_fn(chunks, mesh).map_tensors(lambda a: a.cpu()))
    a, b = out
    assert torch.equal(a.rigid_body.collision_count, b.rigid_body.collision_count)
    tol = 2 * float(np.spacing(np.float32(1600.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol


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


def k4_args(device, n, chunk, n_chunks, seed, empty_chunk=None):
    """K4's inputs: ``n`` distinct random slots (none in ``empty_chunk``),
    or with ``n == "tile_edges"`` the first and last slot of every 8-slot
    group, which holds the first and last slot of every tile: a tile spans
    a multiple of 8 slots and starts on one, wherever the grid puts it."""
    rng = np.random.default_rng(seed)
    total = n_chunks * chunk
    slots = np.arange(total)
    if empty_chunk is not None:
        slots = slots[slots // chunk != empty_chunk]
    if n == "tile_edges":
        flat = rng.permutation(slots[slots % 8 % 7 == 0]).astype(np.int32)
        n = flat.size
    else:
        flat = rng.choice(slots, size=n, replace=False).astype(np.int32)
    order = np.argsort(flat).astype(np.int32)
    bounds = np.searchsorted(flat[order], np.arange(0, total + 1, chunk)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    x[:3] = [-0.0, np.inf, np.nan][:n]  # words are moved, not computed
    t = [torch.from_numpy(a).to(device) for a in (x, y, order, flat, bounds)]
    return (*t, total, chunk)


@pytest.mark.parametrize("n,chunk,n_chunks,empty", [
    (100_000, 128 * 1024, 8, None),  # the probe's chunk
    (1237, 8200, 5, 2),  # an odd count, a ragged block, an empty chunk
    (5, 8, 3, None),  # chunks smaller than a block
    (3 * 8200, 8200, 3, None),  # every slot of every chunk holds an entity
    (20_000, 3 * 4096 + 8, 4, 1),  # chunks that are no multiple of the tile
    ("tile_edges", 3 * 4096 + 8, 4, None),  # the first and last slot of every tile
    (1, 128 * 1024, 66, None),  # one entity in 66 probe-sized chunks
    (1_000_000, 128 * 1024, 66, None),  # the probe's 1M entities
])
def test_k4_matches_plain_on_card(cuda, n, chunk, n_chunks, empty):
    from multithreadedgameengine_tpu_torch.ops.cuda_kernels import expand, expand_plain

    args = k4_args(cuda, n, chunk, n_chunks, 3, empty)
    before = cuda_kernels.expand.launches
    kx, ky = expand(*args)
    assert cuda_kernels.expand.launches == before + 1
    px, py = expand_plain(*args)
    torch.cuda.synchronize()
    assert kx.shape == (n_chunks * 8, chunk // 8)
    assert torch.equal(kx.view(torch.int32), px.view(torch.int32))
    assert torch.equal(ky.view(torch.int32), py.view(torch.int32))


def test_k4_places_every_entity_and_zeros_the_rest_on_card(cuda):
    """One launch of K4 at the probe's shapes (``torch_scenes``' inputs):
    every entity's x and y at its slot, +0.0 in every other slot."""
    from multithreadedgameengine_tpu_torch.ops.cuda_kernels import expand

    x, y, order, flat, bounds, total, chunk = torch_scenes.k4_inputs(
        cuda, torch_scenes.K4_N, torch_scenes.K4_CHUNK, torch_scenes.K4_TOTAL, torch_scenes.SEED)
    before = cuda_kernels.expand.launches
    ox, oy = expand(x, y, order, flat, bounds, total, chunk)
    assert cuda_kernels.expand.launches == before + 1
    fl = flat.long()
    assert torch.equal(ox.view(-1)[fl], x) and torch.equal(oy.view(-1)[fl], y)
    empty = torch.ones(total, dtype=torch.bool, device=cuda)
    empty[fl] = False
    for out in (ox.view(-1)[empty], oy.view(-1)[empty]):
        assert bool((out == 0).all()) and not bool(torch.signbit(out).any())


@pytest.mark.parametrize("source", sorted(_build.ENTRY_POINTS))
def test_kernel_does_not_spill_on_card(cuda, source):
    """nvcc's ``-Xptxas -v`` report of each kernel source, built as the port
    builds it: no kernel spills registers to local memory."""
    _build.build()
    report = _build.ptxas_report(_build.library_path(_build.CSRC / source))
    spills = [line for line in report.splitlines() if "spill" in line]
    assert spills and all(" 0 bytes spill stores, 0 bytes spill loads" in line
                          for line in spills), report


@pytest.mark.parametrize("case", torch_scenes.CASES, ids=[c.id for c in torch_scenes.CASES])
def test_kernel_table_case_on_card(cuda, case):
    """Every case of the kernel table ``chip_smoke.py`` times: the launches
    its scene made on the way to the inputs (``case.launches``: each main
    path's pair pass once a substep, K3 once a substep a slab, a tick once
    a frame), then the kernel on the case's inputs (layouts and slab grids
    from frames of the scenes, K4 at the probe's shapes, the ticks on
    captured frames and on the mixed cell's inputs) against its plain
    version (``torch_scenes.compare``: bit for bit for the pair passes and
    K4, within the summing-order tolerance for the ticks), one launch
    through the wrapper."""
    kernel = getattr(cuda_kernels, case.kernel)
    kw = {} if case.clamp is None else {"clamp_bounds": case.clamp}
    args, _seen = torch_scenes.scene_inputs(case, cuda)
    before = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == before + 1
    want = getattr(cuda_kernels, f"{case.kernel}_plain")(*args, **kw)
    torch.cuda.synchronize()
    cmp = torch_scenes.compare(case, args, got, want)
    assert cmp["ok"], cmp


def test_k4_raises_without_its_library(cuda, monkeypatch):
    """On a CUDA tensor ``expand`` launches the kernel or raises: with the
    library unavailable it does not fall back to the plain version."""
    from multithreadedgameengine_tpu_torch.ops import _build
    from multithreadedgameengine_tpu_torch.ops.cuda_kernels import expand

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_library)
    before = cuda_kernels.expand.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        expand(*k4_args(cuda, 100, 1024, 2, 0))
    assert cuda_kernels.expand.launches == before


def boids_scene(device, n=400, world=(1200.0, 800.0)):
    from multithreadedgameengine_tpu_torch import Engine, make_config
    from multithreadedgameengine_tpu_torch.models.boids import Boid

    eng = Engine(make_config(world_width=world[0], world_height=world[1], seed=123456,
                             spatial=dict(cell_size=50.0, max_neighbors=400, cell_capacity=32),
                             physics=dict(sub_step_count=1)), device=device)
    eng.register_entity_class(Boid, n - 1)
    eng.init()
    rng = np.random.default_rng(123456)
    m = n - 1
    eng.spawn_batch("Boid", m, x=rng.uniform(50, world[0] - 50, m).astype(np.float32),
                    y=rng.uniform(50, world[1] - 50, m).astype(np.float32),
                    vx=rng.uniform(-3, 3, m).astype(np.float32),
                    vy=rng.uniform(-3, 3, m).astype(np.float32), call_on_spawned=False)
    eng._flush_pending()
    return eng


def test_boids_on_card_match_cpu(cuda):
    """BASELINE config 3's knobs, 400 boids, 5 frames on the card against
    the CPU. The ticks' neighbour sums (the boid tick kernel's on the card,
    torch.sum's on the CPU) run in another order on the card, so positions
    agree within 8 ulps at the world's extent; integer state is exact, and
    the neighbour lists of one world are the same on both. On the card the
    tick is the kernel, one launch a frame."""
    from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

    snaps = []
    for device in (cuda, "cpu"):
        eng = boids_scene(device)
        before = cuda_kernels.boid_tick.launches
        eng.step(5)
        assert cuda_kernels.boid_tick.launches == before + (5 if device == cuda else 0)
        assert int(eng.metrics["n_binned"]) == 400
        snaps.append(eng.snapshot())
    a, b = snaps
    assert torch.equal(a.rigid_body.collision_count, b.rigid_body.collision_count)
    assert torch.equal(a.transform.active, b.transform.active)
    tol = 8 * float(np.spacing(np.float32(1200.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol
    lists = []
    for device in (cuda, "cpu"):
        w = b.map_tensors(lambda v: v.to(device))
        t = w.transform
        lists.append(neighbor_lists(t.x, t.y, t.active, w.collider.visual_range, eng.config,
                                    (w.rigid_body.vx, w.rigid_body.vy, t.entity_type)))
    for name in ("ids", "count", "d2"):
        assert torch.equal(getattr(lists[0], name).cpu(), getattr(lists[1], name)), name
    assert int(lists[1].count.sum()) > 0


def test_halo_boids_on_card_bit_equal_with_engine_step(cuda):
    """The halo step with its neighbour-reading phase A on 4 slabs of the
    card against ``Engine.step`` on the card, 5 frames, every leaf."""
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn
    from multithreadedgameengine_tpu_torch.parallel.halo import _get_comp, entity_leaf_specs

    eh, es = boids_scene(cuda, 4096, (2400.0, 1200.0)), boids_scene(cuda, 4096, (2400.0, 1200.0))
    mesh = make_mesh(4, cuda)
    step, place = make_halo_step(eh, mesh, oversub=1.5)
    chunks = place(eh.world)
    for _ in range(5):
        chunks, m = step(chunks, eh.input.snapshot(cuda))
    es.step(5)
    a, b = unplace_fn(chunks, mesh), es.world
    for cname, fname, _dt in entity_leaf_specs(a):
        assert torch.equal(getattr(_get_comp(a, cname), fname),
                           getattr(_get_comp(b, cname), fname)), f"{cname}.{fname}"
    assert int(m["route_overflow_logic"]) == 0 and int(m["route_overflow_solver"]) == 0
    assert int(m["n_binned"]) == 4096


def predators_scene(device, **kw):
    """The predators scene with the camera zoomed out over the world (every
    light and caster on screen), as ``torch_scenes.predators_engine`` builds it."""
    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    eng = make_predators_engine(device=device, **kw)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    return eng


def test_predators_on_card_match_cpu(cuda):
    """400 prey, 8 predators and 5 lights, a burst that lands on overlapping
    patches and the demo's blood, 6 frames on the card against the CPU.
    Integer state (animation, dirty flags, the pool, the dirty tiles, the
    shadows kept) exact; positions within 8 ulps at the world's extent (the
    ticks' sums run in another order on the card); canvas bytes within 1."""
    from multithreadedgameengine_tpu_torch.models.predators import BLOOD

    snaps = []
    for device in (cuda, "cpu"):
        eng = predators_scene(device, n_prey=400, n_predators=8, n_lights=5,
                              world_width=1600.0, world_height=1000.0)
        eng.step(1)
        t = eng.world.transform
        eng.emitter.emit_batch(x=t.x[1:17].cpu().numpy(), y=t.y[1:17].cpu().numpy(), **BLOOD)
        eng.emitter.emit_batch(x=[300.0, 310.0], y=[300.0, 305.0], count=10, z=-1.0, vz=5.0,
                               speed={"min": 0.5, "max": 3.0}, angle_xy=(0.0, 360.0),
                               gravity=0.0, lifespan=9000.0, texture="blood",
                               scale={"min": 0.5, "max": 2.0}, stay_on_the_floor=True)
        m = eng.step(5)
        assert int(m["n_binned"]) == int(m["active_count"]) == 414
        snaps.append(eng.snapshot())
    a, b = snaps
    for u, v in ((a.transform.active, b.transform.active),
                 (a.rigid_body.collision_count, b.rigid_body.collision_count),
                 (a.sprite.animation_state, b.sprite.animation_state),
                 (a.sprite.animation_frame, b.sprite.animation_frame),
                 (a.sprite.render_dirty, b.sprite.render_dirty),
                 (a.particles.active, b.particles.active), (a.decal_dirty, b.decal_dirty),
                 (a.shadow_sprites.active, b.shadow_sprites.active)):
        assert torch.equal(u, v)
    tol = 8 * float(np.spacing(np.float32(1600.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol
    for f in ("x", "y", "z"):
        assert (getattr(a.particles, f) - getattr(b.particles, f)).abs().max().item() <= tol, f
    # the active shadow sprites' floats within 8 ulps at each field's largest
    # magnitude (atan2 is not correctly rounded on either)
    on = b.shadow_sprites.active
    for f in ("x", "y", "rotation", "scale_x", "scale_y", "alpha"):
        u, v = getattr(a.shadow_sprites, f)[on], getattr(b.shadow_sprites, f)[on]
        scale = max(v.abs().max().item(), 1e-30)
        assert (u - v).abs().max().item() <= 8 * float(np.spacing(np.float32(scale))), f
    assert (a.decal_canvas.int() - b.decal_canvas.int()).abs().max().item() <= 1
    assert bool((b.decal_canvas[..., 3] > 0).any()) and bool(b.shadow_sprites.active.any())


def test_predators_operating_point_runs_k1_once_a_frame(cuda):
    """BASELINE config 4 at full width on the card: 3 frames through
    ``Engine.step``, K1 and the prey tick once a frame and no other kernel,
    every entity binned, no overflow, finite, the shadow sprites capped."""
    eng = predators_scene(cuda)
    for fn in (cuda_kernels.pair_pass_resident, cuda_kernels.pair_pass_symmetric,
               cuda_kernels.pair_pass_grid, cuda_kernels.expand, cuda_kernels.prey_tick):
        fn.launches = 0
    m = eng.step(3, block=True)
    assert eng.world.step_count == 3
    assert cuda_kernels.pair_pass_resident.launches == cuda_kernels.prey_tick.launches == 3
    assert (cuda_kernels.pair_pass_symmetric.launches, cuda_kernels.pair_pass_grid.launches,
            cuda_kernels.expand.launches) == (0, 0, 0)
    assert int(m["n_binned"]) == int(m["active_count"]) == 15_014
    assert int(m["solver_overflow"]) == 0 and int(m["nonfinite_count"]) == 0
    assert 0 < int(eng.world.shadow_sprites.active.sum()) <= 5 * 15
    assert eng.world.decal_canvas.shape == (1000, 2500, 4)


def pair_events(device, chunk, overlap=False):
    """``tests/test_round2.py``'s ``_Pair`` scene: two overlapping statics
    with enter and stay hooks, 4 frames with collision events. Returns the
    hook calls ``(kind, me, other)``, and K1's launches a substep."""
    from multithreadedgameengine_tpu_torch import (
        Collider, Engine, EntityClass, RigidBody, SpriteRenderer, make_config)

    calls = []

    class Pair(EntityClass):
        components = [RigidBody, Collider, SpriteRenderer]
        uses_neighbors = False
        on_collision_enter = staticmethod(lambda ctx, me, o: calls.append(("enter", me, o)))
        on_collision_stay = staticmethod(lambda ctx, me, o: calls.append(("stay", me, o)))

        @classmethod
        def setup(cls, ctx):
            return {"collider.radius": 10.0, "collider.visual_range": 60.0,
                    "rigid_body.static": True}

    eng = Engine(make_config(world_width=500.0, world_height=500.0,
                             spatial=dict(cell_size=50.0, max_neighbors=8),
                             logic=dict(collision_events=True, event_chunk=chunk,
                                        event_overlap=overlap)), device=device)
    eng.register_entity_class(Pair, 2)
    eng.init()
    eng.spawn("Pair", x=100.0, y=100.0)
    eng.spawn("Pair", x=110.0, y=100.0)
    before = cuda_kernels.pair_pass_resident.launches
    eng.step(4)
    eng.sync()
    launches = cuda_kernels.pair_pass_resident.launches - before
    return [(k, int(m), int(o)) for k, m, o in calls], launches / eng.config.physics.sub_step_count


@pytest.mark.parametrize("chunk,overlap", [(1, False), (3, False), (3, True)])
def test_pair_events_on_card_match_cpu(cuda, chunk, overlap):
    """Collision events on the card, frame by frame, in chunks of 3 (the
    device log copied to pinned memory) and with the overlapped log: the
    same hook calls as the CPU's frame-by-frame run, 2 enters and 6 stays,
    and K1 once a substep of each frame."""
    base, _ = pair_events("cpu", 1)
    assert sum(k == "enter" for k, *_ in base) == 2 and sum(k == "stay" for k, *_ in base) == 6
    calls, launches = pair_events(cuda, chunk, overlap)
    assert calls == base
    assert launches == 4


def test_event_chunk_does_not_wait_for_the_card(cuda, monkeypatch):
    """BASELINE config 4 with events in chunks: every frame of a chunk and
    its log write run under ``torch.cuda.set_sync_debug_mode("error")``, so
    nothing in them waits for the card (the animation tables live on it, no
    count is read back); the chunk's log reaches the host by one copy."""
    from multithreadedgameengine_tpu_torch.engine import _EventLog

    eng = predators_scene(cuda, logic=dict(collision_events=True, event_chunk=4))
    eng.step(4)
    eng.sync()

    def no_sync(fn):
        def wrapped(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return wrapped

    monkeypatch.setattr(eng, "_one_step", no_sync(eng._one_step))
    monkeypatch.setattr(_EventLog, "write", no_sync(_EventLog.write))
    eng.step(4)
    eng.sync()
    assert eng.world.step_count == 8


def churn_scene(device, use_plan, n=400, frames=8, churn=16):
    """Pool churn (BASELINE config 2 at a small size): a plan in chunks of 4
    or the same ops issued immediately. Returns the world, the free lists
    and K1's launches."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=n, seed=123456, device=device, world_width=1200.0,
                            world_height=800.0)
    eng.step(2, block=True)
    rng = np.random.default_rng(7)
    before = cuda_kernels.pair_pass_resident.launches
    plan = eng.begin_plan() if use_plan else None
    for _ in range(frames):
        kill = rng.choice(eng.active_indices("Ball"), size=churn, replace=False)
        xs = rng.uniform(100, 1100, churn).astype(np.float32)
        ys = rng.uniform(100, 700, churn).astype(np.float32)
        if use_plan:
            plan.despawn_batch(kill)
            plan.spawn_batch("Ball", churn, x=xs, y=ys)
            plan.next_frame()
        else:
            eng.despawn_batch(kill)
            eng.spawn_batch("Ball", churn, x=xs, y=ys)
            eng.step(1)
    if use_plan:
        eng.run_plan(plan, max_chunk=4)
    free = {name: list(map(int, reg.pool.free)) for name, reg in eng.classes.items()}
    return eng.snapshot(), free, cuda_kernels.pair_pass_resident.launches - before


def test_churn_plan_on_card(cuda):
    """A churning plan on the card: bit-equal with the same ops issued
    immediately on the card, K1 twice a frame, and within 8 ulps of the CPU
    (contact counts and pools exact)."""
    plan, free_p, launches = churn_scene(cuda, True)
    imm, free_i, _ = churn_scene(cuda, False)
    cpu, free_c, _ = churn_scene("cpu", True)
    assert launches == 16
    assert free_p == free_i == free_c
    for field in ("x", "y", "active"):
        assert torch.equal(getattr(plan.transform, field), getattr(imm.transform, field))
    assert torch.equal(plan.rigid_body.collision_count, cpu.rigid_body.collision_count)
    assert torch.equal(plan.transform.active, cpu.transform.active)
    tol = 8 * float(np.spacing(np.float32(1200.0)))
    assert (plan.transform.x - cpu.transform.x).abs().max().item() <= tol
    assert (plan.transform.y - cpu.transform.y).abs().max().item() <= tol


def test_checkpoint_on_card(cuda, tmp_path):
    """A checkpoint of a card engine resumes bit for bit in a fresh card
    engine, and loads into a CPU engine with the same leaves."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    def build(device):
        return make_balls_engine(n_balls=400, seed=9, device=device, world_width=1200.0,
                                 world_height=800.0)

    path = str(tmp_path / "card.npz")
    a = build(cuda)
    a.step(10)
    a.save_checkpoint(path)
    a.step(15)
    b = build(cuda)
    b.load_checkpoint(path)
    c = build("cpu")
    c.load_checkpoint(path)
    assert torch.equal(c.world.transform.x, b.world.transform.x.cpu())
    b.step(15)
    for field in ("x", "y", "active"):
        assert torch.equal(getattr(a.world.transform, field), getattr(b.world.transform, field))
    assert torch.equal(a.world.rigid_body.vy, b.world.rigid_body.vy)
    assert a.rng() == b.rng()


def test_render_packet_on_card_matches_cpu(cuda):
    """The render packet extracted on the card equals the packet of the same
    world copied to a CPU engine, field by field, with and without the
    Y-sort."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    for y_sorting in (True, False):
        kw = dict(n_balls=400, seed=123456, world_width=1200.0, world_height=800.0,
                  renderer=dict(y_sorting=y_sorting))
        eng, host = make_balls_engine(device=cuda, **kw), make_balls_engine(device="cpu", **kw)
        eng.step(3)
        host.restore(eng.snapshot())
        a, b = eng.render_packet(), host.render_packet()
        assert int(a.count) == int(b.count) > 0 and a.index.device.type == "cpu"
        for f in ("index", "x", "y", "screen_x", "tint", "animation_frame"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_publish_on_card_matches_cpu_bytes(cuda):
    """A publish of the predators scene on the card (particles, decals,
    shadows, lights): the frame's and the decal PNG's bytes equal those of
    the same world on the CPU, and the server hands them out over HTTP."""
    import urllib.request

    from multithreadedgameengine_tpu_torch.models.predators import BLOOD
    from multithreadedgameengine_tpu_torch.server.render_server import (
        RenderServer,
        build_demo_atlas,
        encode_frame,
    )

    kw = dict(n_prey=400, n_predators=8, n_lights=5, world_width=1600.0, world_height=1000.0)
    eng = predators_scene(cuda, **kw)
    build_demo_atlas(eng)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.6
    eng.emitter.emit_batch(x=[400.0, 800.0], y=[300.0, 500.0], **BLOOD)
    eng.step(30)
    srv = RenderServer(eng, port=0).start()
    try:
        srv.publish(include_decals=True)
        body = urllib.request.urlopen(f"http://localhost:{srv.port}/frame", timeout=10).read()
        frame, png = srv._frame, srv._decal_png
    finally:
        srv.stop()
    assert body == frame
    host = predators_scene("cpu", **kw)
    host.input.camera_x, host.input.camera_y, host.input.camera_zoom = 0.0, 0.0, 0.6
    host.restore(eng.snapshot())
    assert encode_frame(host) == frame
    hsrv = RenderServer(host, port=0)
    try:
        hsrv.publish(include_decals=True)
        assert hsrv._decal_png == png
    finally:
        hsrv.httpd.server_close()
    n_e, n_p, n_s, n_l = np.frombuffer(frame[8:24], "<u4")
    assert n_e > 0 and n_p > 0 and n_s > 0 and n_l > 0


def test_neighbors_frame_on_card_matches_cpu(cuda):
    """``solver="neighbors"`` on the card against the CPU: 3 frames of 400
    balls, contact counts exact, positions within 4 ulps at the world's
    extent (the lists' sums run in another order on the card)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    snaps = []
    for device in (cuda, "cpu"):
        eng = make_balls_engine(n_balls=400, seed=123456, device=device, world_width=1200.0,
                                world_height=800.0, physics=dict(solver="neighbors"))
        eng.input.set_mouse(600.0, 400.0)
        eng.input.mouse_button(0, True)
        m = eng.step(3)
        assert eng._plan.solver_geom is None and int(m["n_binned"]) == 401
        snaps.append(eng.snapshot())
    a, b = snaps
    assert torch.equal(a.rigid_body.collision_count, b.rigid_body.collision_count)
    tol = 4 * float(np.spacing(np.float32(1200.0)))
    assert (a.transform.x - b.transform.x).abs().max().item() <= tol
    assert (a.transform.y - b.transform.y).abs().max().item() <= tol


def test_gloo_ranks_on_card_halo_bit_equal_with_slab_mesh(cuda):
    """Two gloo ranks share the card (every message staged through pinned
    host memory): the halo step on the gravity pile equals ``SlabMesh``'s
    on the card after every frame, and the mesh's collectives equal
    ``SlabMesh``'s."""
    import torch_dist_ranks as ranks

    from multithreadedgameengine_tpu_torch.parallel import run_ranks

    res = run_ranks(ranks.halo_vs_slab_mesh, 2, "gloo", "cuda", args=("pile", 3),
                    deadline_s=240.0)[0]
    assert res["dist"] == res["slab"] and res["dist_metrics"] == res["slab_metrics"]
    for (out,) in run_ranks(rung_collectives, 2, "gloo", "cuda", deadline_s=120.0):
        assert all(out["equal"].values()) and out["bytes_staged"] > 0, out


def test_nccl_mesh_of_one_rank_collectives(cuda):
    from multithreadedgameengine_tpu_torch.parallel import run_ranks

    ((out,),) = run_ranks(rung_collectives, 1, "nccl", "cuda", deadline_s=120.0)
    assert all(out["equal"].values()) and out["bytes_staged"] == 0, out


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    from multithreadedgameengine_tpu_torch.parallel import make_process_mesh

    n = torch.cuda.device_count() + 1  # some card would hold two ranks
    with pytest.raises(ValueError, match=r"two ranks on card \d+ \(.+\)"):
        make_process_mesh(n - 1, n, "nccl", "cuda", None, 10.0)


def test_python_number_emits_do_not_wait_for_the_card(cuda):
    """The dry run's mixed scene: the hunters' tick emits with Python
    numbers (count, vy, lifespan), which are filled on the card, not copied
    from the host, so a halo frame reads nothing from the host."""
    from multithreadedgameengine_tpu_torch.dryrun import mixed_scene
    from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh

    eng = mixed_scene(cuda, 256)
    step, place = make_halo_step(eng, make_mesh(4, cuda))
    chunks, ins = place(eng.world), eng.input.snapshot(cuda)
    chunks, _m = step(chunks, ins)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunks, m = step(chunks, ins)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(m["active_particles"]) > 0
