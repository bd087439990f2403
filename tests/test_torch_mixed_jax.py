"""The knobs of BASELINE config 5 (the mixed ecosystem) in the PyTorch port
against the JAX package, on the CPU: what ``tests/test_torch_predators.py``
(per-class lists at ``max_neighbors`` 1500, one frame a step) and
``tests/test_torch_events.py`` (event chunks of 1 and 3, not overlapped)
leave out.

- The predators scene at the mixed rung's knobs (``benchmarks/run_ladder.py:
  289-367``): cell 160 of capacity 64, ``max_neighbors`` 64, per-class
  lists, collision events logged in chunks of 30 with the hooks of a chunk
  fired after the next chunk is queued, across ``step`` calls; 200 prey, 8
  predators and 5 lights at the demo's density, each class spawned in one
  batch without ``on_spawned``, as the rung spawns. Both packages step two
  calls of 30 frames from the same world. After the first: the counters
  exact, no hook fired yet (the chunk is held), positions within
  ``POS_TOL``. During the second, the first chunk's hooks fire: the same
  blood bursts, their coordinates within ``POS_TOL``.
  ``POS_TOL`` is 0.25 world units, not the few ulps of the one-frame tests:
  XLA:CPU contracts ``a * b + c`` and the port does not, a few ulps a
  frame, which 30 frames of collisions grow (measured: 0.011 after 30
  frames here, 0.049 at 400 prey; 0.20 after 60 frames here and 1.3 at
  400 prey, which is why the comparison stops at the first chunk).
- ``Prey.setup``: the port's one ``rng.draw`` gives the numbers of the JAX
  package's loop of ``rng()`` calls, bit for bit, and leaves the stream
  where the loop leaves it.
"""

import math

import jax
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.behavior import SetupCtx as RefSetupCtx
from multithreadedgameengine_tpu.models.predators import Prey as RefPrey
from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_make
from multithreadedgameengine_tpu.rng import Mulberry32 as RefMulberry32
from multithreadedgameengine_tpu_torch.behavior import SetupCtx
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.predators import Prey, make_predators_engine
from multithreadedgameengine_tpu_torch.rng import Mulberry32

N_PREY, N_PRED, N_LIGHTS = 200, 8, 5
SCALE = math.sqrt(N_PREY / 15_000)
KNOBS = dict(
    world_width=5000.0 * SCALE, world_height=2000.0 * SCALE,
    spatial=dict(cell_size=160.0, max_neighbors=64, cell_capacity=64, per_class_assembly=True),
    logic=dict(collision_events=True, event_chunk=30, event_overlap=True),
    physics=dict(sub_step_count=1, gravity=(0.0, 0.0), verlet_damping=0.99,
                 collision_response_strength=0.9, boundary_elasticity=0.0,
                 max_collision_pairs=1 << 18),
)
CALLS, FRAMES = 2, 30
POS_TOL = 0.25
COUNTERS = ("active_count", "n_binned", "collision_pair_count", "collision_pairs_dropped",
            "event_rows_dropped", "active_particles")


def build(pkg):
    if pkg == "jax":
        eng = ref_make(N_PREY, N_PRED, N_LIGHTS, spawn=False, **KNOBS)
    else:
        eng = make_predators_engine(N_PREY, N_PRED, N_LIGHTS, spawn=False, device="cpu", **KNOBS)
    rng = np.random.default_rng(31)
    w, h = KNOBS["world_width"], KNOBS["world_height"]
    for name, n in (("Prey", N_PREY), ("Predator", N_PRED), ("TallLight", N_LIGHTS)):
        eng.spawn_batch(name, n, call_on_spawned=False,
                        x=(rng.random(n) * w).astype(np.float32),
                        y=(rng.random(n) * h).astype(np.float32))
    emits = []
    emit = eng.emitter.emit_batch

    def recording_emit(**kw):
        emits.append({k: (np.asarray(v).tolist() if k in ("x", "y") else v)
                      for k, v in kw.items()})
        return emit(**kw)

    eng.emitter.emit_batch = recording_emit
    return eng, emits


@pytest.fixture(scope="module")
def runs():
    (ej, emits_j), (et, emits_t) = build("jax"), build("torch")
    ej._flush_pending()
    et._flush_pending()
    start_j = world_from_jax(jax.device_get(ej.world), "cpu")
    start_equal = all(torch.equal(getattr(start_j.transform, f), getattr(et.world.transform, f))
                      for f in ("x", "y", "entity_type", "active"))
    calls = []
    for _ in range(CALLS):
        mj, mt = ej.step(FRAMES), et.step(FRAMES)
        calls.append(({k: int(mj[k]) for k in COUNTERS},
                      {k: int(mt[k]) for k in COUNTERS + ("neighbors_accepted",)},
                      list(emits_j), list(emits_t),
                      world_from_jax(jax.device_get(ej.world), "cpu").transform,
                      et.world.transform))  # no snapshot: a barrier fires the held hooks
    return start_equal, et, calls


def test_the_rungs_knobs_take_the_per_class_chunked_path(runs):
    _eq, et, _calls = runs
    plan = et._plan
    assert plan.scope_hooked and [s[0] for s in plan.nbr_specs] == ["Prey", "Predator",
                                                                    "TallLight"]
    assert plan.cfg.spatial.max_neighbors == 64 and plan.cfg.logic.event_chunk == FRAMES


def test_counters_and_emissions(runs):
    start_equal, _et, calls = runs
    assert start_equal
    (mj, mt, ej1, et1, _a, _b), (_mj2, mt2, ej2, et2, _a2, _b2) = calls
    assert {c: mt[c] for c in COUNTERS} == mj
    assert mt["event_rows_dropped"] == mt2["event_rows_dropped"] == 0
    assert mt["neighbors_accepted"] > 0
    # overlapped: the first chunk's hooks fire inside the second call
    assert ej1 == et1 == [] and ej2, "the blood hook never fired"
    assert len(et2) == len(ej2)
    for k, (a, b) in enumerate(zip(ej2, et2)):
        assert {f: v for f, v in a.items() if f not in ("x", "y")} == \
            {f: v for f, v in b.items() if f not in ("x", "y")}, k
        for f in ("x", "y"):
            np.testing.assert_allclose(b[f], a[f], rtol=0, atol=POS_TOL, err_msg=f"{k} {f}")


def test_positions_after_the_first_chunk(runs):
    _eq, _et, calls = runs
    _mj, _mt, _e, _f, a, b = calls[0]
    for u, v in ((a.x, b.x), (a.y, b.y)):
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("count", [1, 7, 1000])
def test_prey_setup_draws_once_as_the_loop_draws(count):
    seed = 123456 + count
    mine_rng, theirs_rng = Mulberry32(seed), RefMulberry32(seed)
    mine = Prey.setup(SetupCtx(None, 1, count, mine_rng))
    theirs = RefPrey.setup(RefSetupCtx(None, 1, count, theirs_rng))
    for key in ("rigid_body.max_vel", "rigid_body.max_acc", "collider.visual_range"):
        a = np.asarray(theirs[key])
        assert mine[key].dtype == np.float32 and a.dtype == np.float32
        np.testing.assert_array_equal(mine[key], a, err_msg=key)
    assert mine_rng() == theirs_rng()  # the stream continues from the same place
    assert {k for k in mine} == {k for k in theirs}
