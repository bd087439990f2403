"""The neighbour build (``ops.cuda_kernels.neighbor_build``,
``csrc/neighbor_build.cu``): its plain version against each of
``ops.spatial``'s assembly forms followed by ``accept_candidates``, and the
wrapper's checks, on the CPU; the kernel against the plain version on the
card, and the boids and mixed benchmark scenes at reduced size stepped with
the kernel and with the plain version (marked ``cuda``, skipped without
one: ``python -m pytest tests/test_torch_neighbor_build.py -m cuda
--noconftest -q``).

Tolerances: none. Every side computes d2 as two rounded products and one
add in float32 (the kernel is built with ``--fmad=false``) and truncates at
the cap in scan order, so ids, d2 and count are bit-equal everywhere. The
payload is the candidates' table records: bit-equal with the cell-major
form on every row, and with the per-entity gather form on every row whose
entity is valid (for the others the gather form reads the cells around
their clamped coordinates, where every slot is masked, and the cell-major
form and the kernel the empty sentinel).

The scene covers every edge the build has: a cell past its capacity, rows
in the world's edge cells and corners and beyond the world (clamped into
them), inactive, NaN and infinite rows, a coincident pair (d2 = 0, never a
neighbour), per-entity visual ranges, and rows with more accepted slots
than ``max_neighbors`` (truncated in scan order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_scenes
from multithreadedgameengine_tpu_torch.config import make_config
from multithreadedgameengine_tpu_torch.ops import cuda_kernels, spatial
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
    neighbor_build,
    neighbor_build_plain,
)

torch.set_num_threads(2)

N = 500
WORLD = (600.0, 420.0)
#: radius, channels F, cell capacity, max_neighbors and the rows (start,
#: count) of each case; cap x F = 30 takes the kernel's 4-byte path
CASES = {
    "r1_f7": (1, 7, 8, 6, (0, N)),
    "r2_f6": (2, 6, 8, 12, (0, N)),
    "r2_f7": (2, 7, 8, 12, (0, N)),
    "r1_f7_slice": (1, 7, 8, 6, (150, 200)),
    "r2_f6_cap5": (2, 6, 5, 12, (0, N)),
}
#: rows of the scene with a fixed role
EDGE_ROWS = {10: (1.0, 200.0), 11: (599.0, 200.0), 12: (300.0, 1.0), 13: (300.0, 419.0),
             14: (0.5, 0.5), 15: (599.5, 419.5), 16: (-30.0, 100.0), 17: (650.0, 450.0)}
NOT_VALID_ROWS = (0, 1, 2, 3, 4)   # NaN and infinite x or y
COINCIDENT = (90, 91)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def scene(seed, n=N):
    """x, y, active, visual_range and four extra fields, numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20.0, WORLD[0] + 20.0, n).astype(np.float32)
    y = rng.uniform(-20.0, WORLD[1] + 20.0, n).astype(np.float32)
    x[:3] = [np.nan, np.inf, -np.inf]
    y[3:5] = [np.nan, np.inf]
    for r, (ex, ey) in EDGE_ROWS.items():
        x[r], y[r] = ex, ey
    x[20:80] = 200.0 + rng.uniform(0, 25, 60)  # a crowded cell, past capacity
    y[20:80] = 150.0 + rng.uniform(0, 25, 60)
    x[COINCIDENT[0]], y[COINCIDENT[0]] = x[COINCIDENT[1]], y[COINCIDENT[1]]
    active = rng.random(n) > 0.1
    active[list(EDGE_ROWS) + list(COINCIDENT)] = True
    vr = rng.uniform(10.0, 60.0, n).astype(np.float32)
    vr[list(COINCIDENT)] = 40.0
    extras = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    return x, y, active, vr, extras


def inputs(case, seed, device="cpu"):
    """The build's arguments for ``case`` on the scene of ``seed``, binned
    by ``ops.spatial``, with the rows' cell order as ``order``; and the
    binning and the valid mask."""
    radius, f, cap, k, (start, count) = CASES[case]
    x, y, active, vr, extras = (torch.as_tensor(v, device=device) if not isinstance(v, list)
                                else [torch.as_tensor(e, device=device) for e in v]
                                for v in scene(seed))
    cfg = make_config(spatial=dict(cell_size=30.0, max_neighbors=k, cell_capacity=cap,
                                   max_cell_radius=radius),
                      world_width=WORLD[0], world_height=WORLD[1])
    bins, valid, _ids = spatial._grid_bins(x, y, active, cfg, extras[:f - 3])
    order = torch.sort(bins.cell_id[start:start + count], stable=True).indices
    args = (bins.table, bins.cell_id, order, x, y, vr, start, cfg.grid_rows, cfg.grid_cols,
            radius, k)
    return args, bins, valid


def bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def assert_built_equal(got, want, rows=slice(None)):
    """ids, d2, count bit for bit; the payload on ``rows``."""
    for name, a, b in zip(("ids", "d2", "count"), got[:3], want[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(bits(a), bits(b)), name
    assert got[3].shape == want[3].shape
    assert torch.equal(bits(got[3][rows]), bits(want[3][rows])), "payload"


@pytest.mark.parametrize("form", ["cellmajor", "per_entity"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_each_assembly_form(case, form):
    """``neighbor_build_plain`` against ``ops.spatial``'s assembly ``form``
    then ``accept_candidates``, on the case's rows, and the scene's edges
    present in them."""
    args, bins, valid = inputs(case, 0)
    table, cell_id, _order, x, y, vr, start, rows, cols, radius, k = args
    sl = slice(start, start + args[2].shape[0])
    if form == "cellmajor":
        flat = spatial.cellmajor_table(table, rows, cols, radius)[cell_id[sl].to(torch.int64)]
        payload_rows = slice(None)
    else:
        flat = spatial.gathered_candidates(table, bins.row[sl], bins.col[sl], rows, cols, radius)
        payload_rows = valid[sl]
    ids_all = torch.arange(x.shape[0], dtype=torch.int32)
    want = spatial.accept_candidates(flat, x[sl], y[sl], ids_all[sl], vr[sl], valid[sl], k,
                                     bins.n_binned)
    got = neighbor_build_plain(*args)
    assert_built_equal(got, (want.ids, want.d2, want.count, want.payload.data), payload_rows)

    ids, _d2, count, payload = got
    s = (2 * radius + 1) ** 2 * table.shape[1]
    assert ids.shape == (sl.stop - sl.start, s) and payload.shape == (*ids.shape, table.shape[2])
    assert int(count.sum()) > 0 and int(count.max()) == k
    # rows truncated at the cap: more accepted than k without it
    uncapped = neighbor_build_plain(*args[:-1], s)[2]
    assert int((uncapped > k).sum()) > 0
    assert torch.equal(torch.clamp(uncapped, max=k), count)
    assert bool(((ids >= 0).sum(1) == count).all())
    # rows not valid keep nothing; the sentinel's payload
    dead = ~valid[sl]
    assert int(dead.sum()) > 0 and int(count[dead].sum()) == 0
    assert all(bool(dead[r - sl.start]) for r in NOT_VALID_ROWS if sl.start <= r < sl.stop)
    if form == "cellmajor":
        assert bool((payload[dead][..., 0] == -1).all()) and bool((payload[dead][..., 1:] == 0).all())
    # the coincident pair never lists the other
    for a, b in (COINCIDENT, COINCIDENT[::-1]):
        if sl.start <= a < sl.stop:
            assert b not in ids[a - sl.start].tolist()
    # the edge rows all lie in the world's edge cells
    edge = [r - sl.start for r in EDGE_ROWS if sl.start <= r < sl.stop]
    if edge:
        r_, c_ = cell_id[sl][edge] // cols, cell_id[sl][edge] % cols
        assert bool(((r_ == 0) | (r_ == rows - 1) | (c_ == 0) | (c_ == cols - 1)).all())


def test_wrapper_runs_the_plain_version_on_cpu_and_checks_its_inputs():
    """On CPU tensors the wrapper returns the plain version's lists and
    launches nothing; it refuses inputs the kernel does not take."""
    args, _bins, _valid = inputs("r2_f7", 1)
    before = cuda_kernels.neighbor_build.launches
    assert_built_equal(neighbor_build(*args), neighbor_build_plain(*args))
    assert cuda_kernels.neighbor_build.launches == before  # no kernel ran
    table, cell_id, order, x, y, vr, start, rows, cols, radius, k = args
    bad = {
        "cell_id": (table, cell_id.long(), order, x, y, vr, start, rows, cols, radius, k),
        "order": (table, cell_id, order.int(), x, y, vr, start, rows, cols, radius, k),
        "grid": (table, cell_id, order, x, y, vr, start, rows, cols + 1, radius, k),
        "rows": (table, cell_id, order, x, y, vr, 1, rows, cols, radius, k),
        "x": (table, cell_id, order, x[::2], y, vr, start, rows, cols, radius, k),
        "table": (table[..., :2], cell_id, order, x, y, vr, start, rows, cols, radius, k),
        "radius": (table, cell_id, order, x, y, vr, start, rows, cols, -1, k),
    }
    for name, a in bad.items():
        with pytest.raises(ValueError):
            neighbor_build(*a)
        with pytest.raises(ValueError):
            neighbor_build_plain(*a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_on_card(cuda, case, seed):
    """The kernel against its plain version on the card, bit for bit on
    every output and row, one launch through the wrapper; the rows in
    another order (reversed) give the same outputs."""
    args, _bins, _valid = inputs(case, seed, cuda)
    before = cuda_kernels.neighbor_build.launches
    got = neighbor_build(*args)
    assert cuda_kernels.neighbor_build.launches == before + 1
    want = neighbor_build_plain(*args)
    torch.cuda.synchronize()
    assert_built_equal(got, want)
    assert int(want[2].sum()) > 0
    again = neighbor_build(*args[:2], args[2].flip(0), *args[3:])
    assert_built_equal(again, got)


def tensor_leaves(obj, name="world"):
    """Every tensor of a world, by path."""
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name), f"{name}.{f.name}")
    elif isinstance(obj, dict):
        for key in sorted(obj):
            yield from tensor_leaves(obj[key], f"{name}.{key}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from tensor_leaves(v, f"{name}.{i}")


@pytest.mark.cuda
@pytest.mark.parametrize("config, n, lists", [("boids_102k", 8192, 1), ("mixed_1m", 20_000, 3)])
def test_cell_scene_bit_equal_with_the_plain_version_on_card(cuda, monkeypatch, config, n, lists):
    """A benchmark cell's scene at ``n`` boids (or prey) in its world
    scaled to its density, 5 frames through ``Engine.step`` with the
    kernel (one launch a list a frame: the global list, or the prey's,
    predators' and lights') and with ``neighbor_build_plain`` in its place:
    every leaf of the two worlds bit for bit."""
    worlds, made = [], []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(cuda_kernels, "neighbor_build", neighbor_build_plain)
        eng = torch_scenes.cell_engine(cuda, config, n)
        before = neighbor_build.launches
        eng.step(5, block=True)
        made.append(neighbor_build.launches - before)
        worlds.append(eng.snapshot())
    assert made == [5 * lists, 0]
    a, b = (dict(tensor_leaves(w)) for w in worlds)
    assert a.keys() == b.keys() and len(a) > 20
    differ = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
    assert differ == []
    assert bool(worlds[0].transform.active.any())
