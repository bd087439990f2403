"""Neighbour lists of the PyTorch port against the JAX package's
(``ops/spatial.py``): the grid function in both assembly forms, the per-class
function, the brute-force oracle and ``bin_entities``' f32 table rows, on the
same seeded scene (NaN, inactive, out-of-world and over-capacity entities,
per-entity visual ranges, rows past ``max_neighbors``).

Tolerances: ids, counts, ``n_binned``, the payload rows and the table are
exact. ``d2`` is exact or within 1 float32 ulp of the reference's: XLA:CPU
may contract ``dx*dx + dy*dy`` into a fused multiply-add, the port rounds
both products (the acceptance test reads the same d2 on both sides at
these seeds, so the ids agree exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.config import make_config as ref_make_config
from multithreadedgameengine_tpu.ops import spatial as ref_spatial
from multithreadedgameengine_tpu_torch.config import make_config
from multithreadedgameengine_tpu_torch.ops import spatial

torch.set_num_threads(2)

SPATIAL = dict(cell_size=30.0, max_neighbors=12, cell_capacity=8, max_cell_radius=2)
WORLD = dict(world_width=600.0, world_height=420.0)


def scene(seed, n=500):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20.0, 620.0, n).astype(np.float32)
    y = rng.uniform(-20.0, 440.0, n).astype(np.float32)
    x[:3] = [np.nan, 1e9, -np.inf]
    y[3:5] = [np.nan, 3e9]
    x[20:80] = 200.0 + rng.uniform(0, 25, 60)  # a crowded cell, past capacity
    y[20:80] = 150.0 + rng.uniform(0, 25, 60)
    x[90], y[90] = x[91], y[91]  # a coincident pair: d2 = 0, never a neighbour
    active = rng.random(n) > 0.1
    vr = rng.uniform(10.0, 60.0, n).astype(np.float32)
    extras = (rng.standard_normal(n).astype(np.float32),
              rng.integers(0, 5, n).astype(np.int32))
    return x, y, active, vr, extras


def configs(**spatial_over):
    sp = {**SPATIAL, **spatial_over}
    return make_config(spatial=sp, **WORLD), ref_make_config(spatial=sp, **WORLD)


def both(seed):
    x, y, active, vr, extras = scene(seed)
    ref = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(active), jnp.asarray(vr),
           tuple(jnp.asarray(e) for e in extras))
    port = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(active),
            torch.from_numpy(vr), tuple(torch.from_numpy(e) for e in extras))
    return ref, port


def assert_lists_match(got, want, rows=slice(None)):
    """``rows``: where the payloads are compared (all by default)."""
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids), err_msg="ids")
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count), err_msg="count")
    assert int(got.n_binned) == int(want.n_binned)
    np.testing.assert_array_equal(got.payload.data.numpy()[rows],
                                  np.asarray(want.payload.data)[rows], err_msg="payload")
    wd2 = np.asarray(want.d2)
    np.testing.assert_array_max_ulp(got.d2.numpy(), wd2, maxulp=1)
    assert got.ids.dtype == torch.int32 and got.count.dtype == torch.int32
    assert got.d2.dtype == torch.float32


@pytest.mark.parametrize("form", ["cellmajor", "per_entity"])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_lists_match_reference(seed, form, monkeypatch):
    """Both assembly forms against the reference (whose 256 MB rule picks
    the cell-major form at this size): same slots, in the same scan order.
    The forms' payloads differ only in the rows of entities outside the
    grid (inactive or not finite), whose slots are all masked: the
    cell-major form hands them the empty sentinel row, the per-entity form
    the cells around their clamped coordinates."""
    rows = slice(None)
    if form == "per_entity":
        monkeypatch.setattr(spatial, "CELLMAJOR_BUDGET_BYTES", 0)
    cfg, rcfg = configs()
    (rx, ry, ra, rv, re), (x, y, a, v, e) = both(seed)
    if form == "per_entity":
        rows = (a & torch.isfinite(x) & torch.isfinite(y)).numpy()
    want = ref_spatial.neighbor_lists_grid(rx, ry, ra, rv, rcfg, re)
    got = spatial.neighbor_lists(x, y, a, v, cfg, e)
    assert_lists_match(got, want, rows)
    # the cap bit: some rows have more valid candidates than max_neighbors
    assert int(got.count.max()) == SPATIAL["max_neighbors"]
    assert int((got.ids >= 0).sum(1).max()) == SPATIAL["max_neighbors"]
    assert got.ids.shape == (500, 25 * 8) and got.payload.data.shape == (500, 200, 5)


def test_lists_by_class_match_reference():
    cfg, rcfg = configs()
    (rx, ry, ra, rv, re), (x, y, a, v, e) = both(2)
    ranges = (("A", 0, 150, 1), ("B", 150, 200, 2), ("C", 350, 150, 1))
    want, wn = ref_spatial.neighbor_lists_by_class(rx, ry, ra, rv, rcfg, re, ranges)
    got, gn = spatial.neighbor_lists_by_class(x, y, a, v, cfg, e, ranges)
    assert int(gn) == int(wn)
    assert set(got) == set(want)
    for name in want:
        assert_lists_match(got[name], want[name])
    assert got["A"].ids.shape == (150, 9 * 8) and got["B"].ids.shape == (200, 25 * 8)


def test_bruteforce_lists_match_reference():
    cfg, rcfg = configs(method="bruteforce")
    (rx, ry, ra, rv, re), (x, y, a, v, e) = both(3)
    want = ref_spatial.neighbor_lists(rx, ry, ra, rv, rcfg, re)
    got = spatial.neighbor_lists(x, y, a, v, cfg, e)
    assert_lists_match(got, want)


def test_grid_and_bruteforce_find_the_same_sets():
    """Where no row is truncated, the grid's neighbour sets are the
    brute-force oracle's (spatial.py:434-436), in another slot order."""
    cfg, _ = configs(max_neighbors=1000, cell_capacity=64)
    bcfg, _ = configs(max_neighbors=1000, cell_capacity=64, method="bruteforce")
    _, (x, y, a, v, e) = both(4)
    g = spatial.neighbor_lists(x, y, a, v, cfg, e)
    b = spatial.neighbor_lists(x, y, a, v, bcfg, e)
    assert torch.equal(g.count, b.count)
    for i in range(0, 500, 7):
        gi = sorted(int(j) for j in g.ids[i] if j >= 0)
        bi = sorted(int(j) for j in b.ids[i] if j >= 0)
        assert gi == bi, i


@pytest.mark.parametrize("seed", [0, 5])
def test_bin_entities_table_values_match_reference(seed):
    x, y, active, _vr, (f0, f1) = scene(seed)
    rows = np.stack([np.arange(len(x), dtype=np.float32), x, y, f0, f1.astype(np.float32)], 1)
    geom = dict(cell_size=30.0, rows=14, cols=20, capacity=8)
    want = ref_spatial.bin_entities(jnp.asarray(x), jnp.asarray(y), jnp.asarray(active),
                                    ref_spatial.GridGeom(**geom), table_values=jnp.asarray(rows))
    got = spatial.bin_entities(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(active), spatial.GridGeom(**geom),
                               table_values=torch.from_numpy(rows))
    assert got.table.shape == (14 * 20 + 1, 8, 5) and got.table.dtype == torch.float32
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    for name in ("cell_id", "rank", "row", "col", "n_binned"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.n_binned) == int((got.table[..., 0] >= 0).sum()) > 0


def test_cap_first_k_and_guards():
    cand = torch.tensor([[5, 6, 7, 8, 9]], dtype=torch.int32)
    d2 = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]])
    valid = torch.tensor([[True, False, True, True, True]])
    ids, d2o, count = spatial._cap_first_k(cand, d2, valid, 2)
    assert ids.tolist() == [[5, -1, 7, -1, -1]] and d2o.tolist() == [[1.0, 0.0, 3.0, 0.0, 0.0]]
    assert count.tolist() == [2] and count.dtype == torch.int32
    cfg, _ = configs()
    big = torch.zeros(1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        spatial.neighbor_lists_grid(big, big, big > 0, big, cfg)
    empty = spatial.empty_neighbor_lists(3, "cpu")
    assert empty.ids.shape == (3, 1) and int(empty.n_binned) == -1
    row, col = spatial.cell_coords(torch.tensor([-5.0, 45.0, 1e9]),
                                   torch.tensor([float("nan"), 31.0, 500.0]), cfg)
    assert row.tolist() == [0, 1, 13] and col.tolist() == [0, 1, 19]
