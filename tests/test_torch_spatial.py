"""bin_entities of the PyTorch port against the JAX package's, exactly: the
same seeded positions (with NaN, inactive, out-of-world and over-capacity
entities) give the same cells, ranks, clamped rows/cols, table and count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.ops.spatial import GridGeom as RefGeom
from multithreadedgameengine_tpu.ops.spatial import bin_entities as ref_bin
from multithreadedgameengine_tpu_torch.ops.spatial import GridGeom, bin_entities

torch.set_num_threads(2)


def scene(seed, n=300):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-40.0, 640.0, n).astype(np.float32)  # some outside [0, 600)
    y = rng.uniform(-40.0, 440.0, n).astype(np.float32)
    x[:5] = [np.nan, 1e12, -1e12, np.inf, 599.999]
    y[5:9] = [np.nan, -np.inf, 3e9, 0.0]
    x[20:60] = 100.0 + rng.uniform(0, 5, 40)  # one crowded cell
    y[20:60] = 100.0 + rng.uniform(0, 5, 40)
    valid = rng.random(n) > 0.1
    return x, y, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("build_table", [True, False])
def test_bin_entities_matches_reference_exactly(seed, build_table):
    x, y, valid = scene(seed)
    geom = dict(cell_size=30.0, rows=14, cols=20, capacity=8)
    ref = jax.device_get(ref_bin(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), RefGeom(**geom),
        build_table=build_table,
    ))
    got = bin_entities(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid),
        GridGeom(**geom), build_table=build_table,
    )
    for name in ("cell_id", "rank", "row", "col", "table", "n_binned"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
