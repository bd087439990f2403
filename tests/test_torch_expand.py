"""K4, the expand placement: the port's plain version against the JAX
package's Pallas kernel (``benchmarks/probe_expand_kernel.py::expand``) in
interpret mode, bit for bit, and the wrapper's dispatch and checks on the
CPU. ``benchmarks/`` is not a package, so the probe is loaded from its
file. The kernel only moves words, so the contract is bit-equality."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import expand, expand_plain

PROBE = Path(__file__).resolve().parents[1] / "benchmarks" / "probe_expand_kernel.py"


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("probe_expand_kernel", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(n, chunk, n_chunks, seed, empty_chunk=None):
    """As the probe makes them (probe_expand_kernel.py:110-122): distinct
    slots, the entities sorted by slot, each chunk's range by a search."""
    rng = np.random.default_rng(seed)
    total = n_chunks * chunk
    slots = np.arange(total)
    if empty_chunk is not None:
        slots = slots[slots // chunk != empty_chunk]
    flat = rng.choice(slots, size=n, replace=False).astype(np.int32)
    order = np.argsort(flat).astype(np.int32)
    bounds = np.searchsorted(flat[order], np.arange(0, total + 1, chunk)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    x[:2] = [-0.0, np.nan]  # words are moved, not computed
    return (x, y, order, flat, bounds), total, chunk


@pytest.mark.parametrize("n,chunk,n_chunks,empty", [
    (3000, 1024, 8, None),  # 3,000 entities in 8 chunks of 1,024 slots
    (777, 1024, 3, 1),  # an odd count, an empty chunk
    (3 * 1024, 1024, 3, None),  # every slot of every chunk holds an entity
    (5, 8, 3, None),  # chunks of 8 slots, smaller than any tile
])
def test_plain_expand_matches_reference_kernel(probe, n, chunk, n_chunks, empty):
    arrays, total, chunk = inputs(n, chunk, n_chunks, 11, empty)
    gx, gy = probe.expand(*(jnp.asarray(a) for a in arrays), total, chunk, True)
    px, py = expand_plain(*(torch.from_numpy(a) for a in arrays), total, chunk)
    assert px.shape == (n_chunks * 8, chunk // 8) == tuple(gx.shape)
    np.testing.assert_array_equal(px.numpy().view(np.int32), np.asarray(gx).view(np.int32))
    np.testing.assert_array_equal(py.numpy().view(np.int32), np.asarray(gy).view(np.int32))
    # every slot no entity lands in is +0.0
    landed = np.zeros(total, bool)
    landed[arrays[3]] = True
    assert (px.numpy().reshape(-1)[~landed].view(np.int32) == 0).all()


def test_expand_wrapper_runs_plain_on_cpu_and_checks_inputs():
    arrays, total, chunk = inputs(500, 256, 4, 3)
    t = [torch.from_numpy(a) for a in arrays]
    before = cuda_kernels.expand.launches
    for u, v in zip(expand(*t, total, chunk), expand_plain(*t, total, chunk)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    assert cuda_kernels.expand.launches == before  # no kernel ran
    x, y, order, flat, bounds = t
    with pytest.raises(ValueError, match="float32"):
        expand(x.double(), y, order, flat, bounds, total, chunk)
    with pytest.raises(ValueError, match="int32"):
        expand(x, y, order.long(), flat, bounds, total, chunk)
    with pytest.raises(ValueError, match="shape"):
        expand(x, y, order, flat, bounds[:-1], total, chunk)
    with pytest.raises(ValueError, match="multiple of 8"):
        expand(x, y, order, flat, bounds, total, 100)
    with pytest.raises(ValueError, match="contiguous"):
        expand(x, y, order, flat.repeat_interleave(2)[::2], bounds, total, chunk)
