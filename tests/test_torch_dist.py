"""The process mesh (``parallel.dist``, ``parallel.launch``) and the
entity-sharded step (``parallel.sharded``) on the CPU over gloo.

Every case spawns its ranks through ``run_ranks`` with its own deadline;
the ranks run ``tests/torch_dist_ranks.py``, which imports no JAX. The bar
is bit-equality with the in-process ``SlabMesh`` after every frame (the
halo step on the gravity pile, the 4,096-boid scene of the dry run's rung
1d and the 400-prey mixed scene, also chunked; the homed step with a live
insert and a live remove), with the port's ``Engine.step`` for the
entity-sharded step on 8 ranks, and ``tests/test_sharding.py``'s bar
(within 5e-3 of the JAX GSPMD step, 201 active) against the reference.

The mixed scene and the live homed run are also held to the JAX halo and
homed steps on conftest's virtual devices (D = 4), from the same world
(built by the JAX package and carried into the ranks with
``interop.world_from_jax``), at the bars of ``tests/test_torch_halo_mixed.py``
and ``tests/test_torch_homed.py``: integer state, event tables and the
particle pool exact, positions and velocities within 8 float32 ulps at the
world's extent, the shadow sprites within 4 ulps of each field's largest
magnitude (XLA:CPU fuses multiply-adds, approximates ``atan2`` and sums
the grid pass's pushes in chunks of 8).
"""

import time

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_predators
from multithreadedgameengine_tpu.parallel import make_halo_step as ref_make_halo_step
from multithreadedgameengine_tpu.parallel import make_homed_step as ref_make_homed_step
from multithreadedgameengine_tpu.parallel import make_mesh as ref_make_mesh
from multithreadedgameengine_tpu.parallel import make_sharded_step as ref_sharded_step
from multithreadedgameengine_tpu.parallel import shard_world as ref_shard_world
from multithreadedgameengine_tpu_torch.dryrun import dryrun_multichip, rung_collectives
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.parallel import (
    RankError,
    make_halo_step,
    make_mesh,
    make_process_mesh,
    run_ranks,
    unplace_fn,
)
from test_torch_halo_mixed import (
    assert_close_to_ref,
    assert_pool_matches_ref,
    assert_shadows_match_ref,
    event_rows,
)
from test_torch_homed import boids_scene as ref_boids_scene

D = 4
DEADLINE_S = 120.0


def first_difference(a, b):
    """The first frame whose digests differ, with the leaves that differ."""
    for f, (u, v) in enumerate(zip(a, b)):
        if u != v:
            return f, sorted(k for k in set(u) | set(v) if u.get(k) != v.get(k))
    return None


# ---------------------------------------------------------------------------
# (a) the collectives
# ---------------------------------------------------------------------------

def test_process_mesh_collectives_match_slab_mesh():
    """all_to_all's source-major layout, the shifts with their zero edges,
    a ppermute, all_gather's rank order, psum bit-equal on float inputs
    whose sum depends on its order, and the gather to rank 0."""
    out = run_ranks(rung_collectives, D, "gloo", "cpu", deadline_s=DEADLINE_S)
    for r, (res,) in enumerate(out):
        assert res["rank"] == r and all(res["equal"].values()), res
        assert res["calls"] == 8 and res["bytes_staged"] == 0, res
        assert res["bytes_sent"] > 0 and res["bytes_received"] > 0, res


def test_slab_mesh_holds_every_slab():
    mesh = make_mesh(3, "cpu")
    assert mesh.slabs == (0, 1, 2)
    parts = [torch.full((2,), float(s)) for s in range(3)]
    assert torch.equal(mesh.gather(parts), torch.stack(parts))


def test_unplace_refuses_chunks_of_another_mesh():
    """``unplace_fn`` takes the mesh that placed the chunks: chunks that are
    not one for each of its local slabs (a process's one chunk handed with
    a mesh that holds every slab) raise, where a join would return a part
    of the world as the whole."""
    eng = ranks.pile("cpu")
    mesh = make_mesh(4, "cpu")
    _step, place = make_halo_step(eng, mesh)
    chunks = place(eng.world)
    assert unplace_fn(chunks, mesh).n_entities == 256
    with pytest.raises(ValueError, match="chunks for a mesh that holds slabs"):
        unplace_fn(chunks[:1], mesh)


# ---------------------------------------------------------------------------
# (b) the halo step against SlabMesh, after every frame
# ---------------------------------------------------------------------------

def ref_prey_mixed():
    """``torch_dist_ranks.prey_mixed`` built by the JAX package: the same
    engine, camera and bursts."""
    eng = ref_predators(n_prey=400, n_predators=8, n_lights=3, world_width=1600.0,
                        world_height=1000.0, logic=dict(collision_events=True))
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    eng._flush_pending()
    s = eng.classes["Prey"].start_index
    t = jax.device_get(eng.world.transform)
    eng.emitter.emit_batch(x=np.asarray(t.x[s:s + 16]), y=np.asarray(t.y[s:s + 16]),
                           **ranks.BLOOD)
    eng.emitter.emit_batch(**ranks.LANDING)
    eng._flush_emissions()
    return eng


@pytest.mark.parametrize("scene, frames, chunk_steps", [
    ("pile", 3, 1),
    ("boids_1d", 3, 1),
    ("prey_mixed", 3, 1),
    ("prey_mixed", 2, 2),
])
def test_halo_step_bit_equal_with_slab_mesh(scene, frames, chunk_steps):
    """The mixed scene starts from the JAX package's world and is also held
    to the JAX halo step, one frame a call, over the same frames."""
    ej = ref_prey_mixed() if scene == "prey_mixed" else None
    start = None if ej is None else world_from_jax(jax.device_get(ej.world), "cpu")
    out = run_ranks(ranks.halo_vs_slab_mesh, D, "gloo", "cpu",
                    args=(scene, frames, 4.0, chunk_steps,
                          None if start is None else ranks.leaves_of(start)),
                    deadline_s=DEADLINE_S)
    res = out[0]
    assert all(o is None for o in out[1:])
    assert len(res["dist"]) == frames
    assert first_difference(res["dist"], res["slab"]) is None, \
        first_difference(res["dist"], res["slab"])
    assert res["dist_metrics"] == res["slab_metrics"]
    m = res["dist_metrics"]
    active = m["active_count"][-1] if chunk_steps > 1 else m["active_count"]
    assert active == {"pile": 256, "boids_1d": 4096, "prey_mixed": 412}[scene]
    if scene == "prey_mixed":  # the mixed passes all had work
        f = res["features"]
        assert f["stay"] + f["enter"] > 0 and f["particles"] > 0, f
        assert f["canvas_px"] > 0 and f["shadows"] > 0, f
        step, place = ref_make_halo_step(ej, ref_make_mesh(D, axis_name="slab"), oversub=4.0)
        wj = place(ej.world)
        for _ in range(frames * chunk_steps):
            wj, mj = step(wj, ej.input.snapshot())
        a, b = jax.device_get(wj), ranks.with_leaves(start, res["world"])
        assert event_rows(b) == event_rows(a)
        assert_pool_matches_ref(a, b)
        np.testing.assert_array_equal(b.decal_canvas.numpy(), np.asarray(a.decal_canvas))
        assert_shadows_match_ref(a, b)
        assert_close_to_ref(a, b, 1600.0)
        assert active == int(mj["active_count"]) and int(mj["route_overflow_logic"]) == 0


# ---------------------------------------------------------------------------
# (c) the homed step with a live insert and a live remove
# ---------------------------------------------------------------------------

def ref_live_homed(ej, frames, headroom, insert_at, remove_at, n_insert=40, n_remove=5):
    """``torch_dist_ranks.homed_vs_slab_mesh``'s run on the JAX homed step:
    the same live insert and remove before the same frames. Returns the
    control plane's counts, the per-frame metrics and the last world."""
    step, place, unplace, ctl = ref_make_homed_step(ej, ref_make_mesh(D, axis_name="slab"),
                                                    headroom=headroom)
    w, gid = place(ej.world)
    ins = ej.input.snapshot()
    plane, metrics = [], []
    for f in range(frames):
        if f == insert_at:
            new = ej.spawn_batch("Boid", n_insert, **ranks.live_spawn_args(n_insert))
            ej._flush_pending()
            w, gid, denied = ctl.insert(w, gid, ctl.pack_rows(ej.world, new), new)
            plane.append(("denied", int(denied)))
        if f == remove_at:
            victims = np.sort(ej.classes["Boid"].pool.active_indices())[:n_remove]
            w, gid, removed = ctl.remove(w, gid, victims.astype(np.int32))
            plane.append(("removed", int(removed)))
        w, gid, m = step(w, gid, ins)
        metrics.append({k: int(v) for k, v in m.items()})
    return plane, metrics, jax.device_get(unplace(w, gid))


def test_homed_step_with_live_insert_and_remove_bit_equal_with_slab_mesh():
    """From the JAX package's world; also held to the JAX homed step's live
    insert and remove: the control plane's counts and every frame's
    migration metrics exact, the last world at ``tests/test_torch_homed.py``'s
    bar."""
    ej = ref_boids_scene("jax", n_total=384, n_spawned=255)
    ej._flush_pending()
    start = world_from_jax(jax.device_get(ej.world), "cpu")
    out = run_ranks(ranks.homed_vs_slab_mesh, D, "gloo", "cpu",
                    args=("live_boids", 6, 8.0, 2, 4, 40, 5, ranks.leaves_of(start)),
                    deadline_s=DEADLINE_S)
    res = out[0]
    assert first_difference(res["dist"], res["slab"]) is None, \
        first_difference(res["dist"], res["slab"])
    assert res["dist_plane"] == res["slab_plane"]
    (_d, denied), (_r, removed) = res["dist_plane"]
    # a victim whose slot a spawn reused is held twice (the parked row)
    assert denied == 0 and removed >= 5
    assert res["dist_metrics"] == res["slab_metrics"]
    last = res["dist_metrics"][-1]
    assert last["active_count"] == 256 + 40 - 5
    assert last["home_violators"] == 0
    plane, metrics, a = ref_live_homed(ej, 6, 8.0, 2, 4)
    assert res["dist_plane"] == plane
    for k, (mt, mj) in enumerate(zip(res["dist_metrics"], metrics)):
        for key in ("migrated_rows", "home_violators", "route_overflow_solver", "active_count",
                    "n_binned", "solver_binned"):
            assert mt[key] == mj[key], (k, key)
    assert_close_to_ref(a, ranks.with_leaves(start, res["world"]), 2000.0)


# ---------------------------------------------------------------------------
# (d) the entity-sharded step on 8 ranks
# ---------------------------------------------------------------------------

def ref_sharded_world(frames):
    """tests/test_sharding.py's JAX run: the GSPMD step on conftest's 8
    virtual devices."""
    eng = ref_balls(n_balls=255, spawn=False, seed=4, world_width=2000.0, world_height=1500.0)
    for _ in range(200):
        eng.spawn("Ball", x=eng.rng() * 2000.0, y=eng.rng() * 1500.0)
    eng._flush_pending()
    eng._build_step()
    mesh = ref_make_mesh(8)
    w = ref_shard_world(eng.world, mesh)
    step = ref_sharded_step(eng.raw_step_fn(), w, mesh)
    inputs = eng.input.snapshot()
    for _ in range(frames):
        w, metrics = step(w, inputs)
    return jax.device_get(w), int(jax.device_get(metrics["active_count"]))


def test_sharded_step_on_8_ranks_matches_engine_and_reference():
    assert len(jax.devices()) >= 8, "conftest's 8 virtual devices"
    out = run_ranks(ranks.sharded_vs_engine, 8, "gloo", "cpu", args=(10,),
                    deadline_s=DEADLINE_S)
    # bit-equal with the port's Engine.step, every rank's rows
    for r, res in enumerate(out):
        assert res["digests"] == out[0]["engine_digests"][r], r
        assert res["metrics"]["active_count"] == 201
    x = np.concatenate([res["x"] for res in out])
    y = np.concatenate([res["y"] for res in out])
    ref, active = ref_sharded_world(10)
    # the reference's own bar (tests/test_sharding.py): its collectives sum
    # in another order than one device
    np.testing.assert_allclose(np.asarray(ref.transform.x), x, atol=5e-3)
    np.testing.assert_allclose(np.asarray(ref.transform.y), y, atol=5e-3)
    assert active == 201


# ---------------------------------------------------------------------------
# (e) a failing or hung rank fails the run within its deadline
# ---------------------------------------------------------------------------

def test_run_ranks_raises_with_the_failing_rank_traceback():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_ranks(ranks.raise_on, 2, "gloo", "cpu", args=(1,), deadline_s=60.0)
    assert time.monotonic() - t0 < 60.0


def test_run_ranks_kills_a_hung_collective_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="did not finish within"):
        run_ranks(ranks.hang, 2, "gloo", "cpu", args=(600.0,), deadline_s=8.0)
    assert time.monotonic() - t0 < 30.0  # the deadline, then SIGKILL and the joins


def test_make_process_mesh_refuses_nccl_off_a_card_and_unknown_backends():
    """Raised before any process group forms; nothing switches backend or
    device on its own (two NCCL ranks on one card: tests/test_torch_cuda.py)."""
    with pytest.raises(ValueError, match="NCCL"):
        make_process_mesh(1, 2, "nccl", "cpu", None, 10.0)
    with pytest.raises(ValueError, match="backend"):
        make_process_mesh(0, 1, "mpi", "cpu", None, 10.0)


def test_dryrun_multichip_runs_every_rung():
    """The reference's dry run, every rung at its own size and with its own
    asserts, on 4 ranks; each rung's replicated leaves agree on every rank."""
    reports = dryrun_multichip(D, "gloo", "cpu", deadline_s=DEADLINE_S, threads=1)
    assert [r[0]["cell"] for r in reports] == [
        "0_collectives", "1_halo_boids", "1b_halo_mixed", "1c_halo_chunked", "1d_homed_boids",
        "1e_homed_mixed", "2_sharded_balls"]
    for reps in reports:
        assert [r["rank"] for r in reps] == list(range(D))
        if "replicated" in reps[0]:
            assert all(r["replicated"] == reps[0]["replicated"] for r in reps), reps[0]["cell"]
    assert reports[1][0]["metrics"]["n_binned"] == 102_400
    assert reports[3][0]["step_count"] == 4
    # every rank's kernel launches reach rank 0 (none on the CPU)
    assert reports[1][0]["launches_by_rank"] == {
        k: [0] * D for k in ("K1", "K2", "K3", "boid_tick", "prey_tick")}
    assert reports[1][1]["launches_by_rank"] is None
