"""The multi-process dry run: every rung of the reference's
``__graft_entry__.dryrun_multichip`` on a process mesh, one slab per
process.

    python -m multithreadedgameengine_tpu_torch.dryrun --ranks 4 --backend gloo --device cuda

:func:`dryrun_multichip` starts ``n_ranks`` processes (``parallel.run_ranks``)
and runs in them, in order, the reference's rungs at the reference's sizes
with the reference's asserts (``__graft_entry__.py:68-300``), after a
check of the mesh itself:

- 0: every collective of the process mesh on seeded inputs against
  ``SlabMesh`` on the same inputs, bit for bit (:func:`rung_collectives`);
- 1: 102,400 boids (rounded to the mesh) through the halo step, one frame:
  ``active_count`` and ``n_binned`` equal N, ``route_overflow_logic`` 0,
  each rank's chunk N/D rows;
- 1b: the mixed scene (hunters that emit and carry a collision hook, poles
  that cast shadows and light), two frames: every entity active, live
  particles;
- 1c: that world on, through the chunked halo step (two frames a call);
- 1d: 4,096 boids through the homed step (headroom 4), two frames:
  ``home_violators`` 0;
- 1e: 1b's scene, as first built, through the homed step, two frames;
- 2: the entity-sharded step on the balls scene, 32 entities a rank, one
  frame.

Every rank builds every scene from its seed, as every device of the
reference traces the same program. Each rung reports, from every rank, the
frames' metrics, the mesh's bytes and calls a frame, where there are timed
frames the steps/s and the mesh's share of an instrumented frame, the
kernels' launches, and a digest of every leaf of the rank's chunk world
(:func:`leaf_digests`): the world gathered nowhere, yet comparable bit for
bit with an in-process run's chunks. ``extra`` cells (:func:`halo_cell`,
:func:`homed_cell`, :func:`sharded_cell`) run after the rungs in the same
processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import Engine, EntityClass, make_config
from .components import Collider, LightEmitter, RigidBody, ShadowCaster, SpriteRenderer, Struct
from .models.balls import make_balls_engine
from .models.boids import Boid
from .ops import cuda_kernels as ck
from .parallel import (
    make_halo_step,
    make_homed_step,
    make_sharded_step,
    run_ranks,
    shard_world,
)

SEED = 123456
#: the reference's rung sizes before rounding to the mesh
HALO_BOIDS, MIXED, HOMED_BOIDS, SHARDED_PER_RANK = 102_400, 2048, 4096, 32
KERNELS = (("K1", ck.pair_pass_resident), ("K2", ck.pair_pass_symmetric),
           ("K3", ck.pair_pass_grid), ("boid_tick", ck.boid_tick))


# ---------------------------------------------------------------------------
# the scenes, built alike on every rank
# ---------------------------------------------------------------------------

def boids_scene(device, n_total: int, rng_seed: int = SEED) -> Engine:
    """Rungs 1 and 1d: ``n_total - 1`` boids and the mouse in 12000 x 6000,
    cell 100, 48 neighbours, cell capacity 32, one substep, spawned from
    numpy's stream at ``rng_seed`` (x, y 50 px inside the edges, vx, vy in
    [-3, 3])."""
    eng = Engine(make_config(
        world_width=12_000.0, world_height=6_000.0, seed=SEED,
        spatial=dict(cell_size=100.0, max_neighbors=48, cell_capacity=32),
        physics=dict(sub_step_count=1)), device=device)
    eng.register_entity_class(Boid, n_total - 1)
    eng.init()
    rng = np.random.default_rng(rng_seed)
    m = n_total - 1
    eng.spawn_batch("Boid", m,
                    x=rng.uniform(50, 11_950, m).astype(np.float32),
                    y=rng.uniform(50, 5_950, m).astype(np.float32),
                    vx=rng.uniform(-3, 3, m).astype(np.float32),
                    vy=rng.uniform(-3, 3, m).astype(np.float32),
                    call_on_spawned=False)
    eng._flush_pending()
    return eng


class Hunter(EntityClass):
    """Rung 1b's mover: a collision hook (so pairs are recorded) and one
    particle emitted a frame."""

    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False
    emit_cap = 2

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 10.0, "collider.visual_range": 80.0}

    @staticmethod
    def on_collision_stay(ctx, me, other):
        pass

    @staticmethod
    def tick(ctx):
        return {"emit": {"count": 1, "vy": -2.0, "lifespan": 2000.0}}


class Pole(EntityClass):
    """Rung 1b's static shadow caster and light."""

    components = [RigidBody, Collider, SpriteRenderer, ShadowCaster, LightEmitter]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 6.0, "collider.visual_range": 190.0,
                "rigid_body.static": True, "shadow.shadow_radius": 8.0,
                "shadow.height": 40.0, "light.light_intensity": 400.0}


def mixed_scene(device, n_mix: int) -> Engine:
    """Rungs 1b, 1c and 1e: ``n_mix - 9`` hunters and 8 poles (and the
    mouse) in 4000 x 3200 with collision events, a 4,096-particle pool and
    shadows, the camera on the world's centre."""
    eng = Engine(make_config(
        world_width=4000.0, world_height=3200.0, seed=7,
        canvas_width=2000, canvas_height=1600,
        spatial=dict(cell_size=100.0, max_neighbors=32, cell_capacity=16),
        physics=dict(sub_step_count=1, gravity=(0.0, 0.0)),
        logic=dict(collision_events=True),
        particle=dict(max_particles=4096, max_emit_per_step=256),
        lighting=dict(enabled=True, shadows_enabled=True,
                      max_shadow_casting_lights=4, max_shadows_per_light=8)), device=device)
    eng.register_entity_class(Hunter, n_mix - 9)
    eng.register_entity_class(Pole, 8)
    eng.init()
    rng = np.random.default_rng(7)
    k = n_mix - 9
    eng.spawn_batch("Hunter", k,
                    x=rng.uniform(100, 3900, k).astype(np.float32),
                    y=rng.uniform(100, 3100, k).astype(np.float32),
                    vx=rng.uniform(-3, 3, k).astype(np.float32),
                    vy=rng.uniform(-3, 3, k).astype(np.float32))
    for j in range(8):
        eng.spawn("Pole", x=1800.0 + 60.0 * j, y=1500.0 + 40.0 * j)
    eng._flush_pending()
    eng.input.set_camera(2000.0, 1600.0, 1.0)
    return eng


def balls_scene(device, n_total: int, **overrides) -> Engine:
    """Rung 2: the balls demo with ``n_total - 1`` balls (seed 123456), its
    queued spawns flushed and its frame planned."""
    eng = make_balls_engine(n_balls=n_total - 1, seed=SEED, device=device, **overrides)
    eng._flush_pending()
    eng.raw_step_fn()
    return eng


# ---------------------------------------------------------------------------
# what a rank reports
# ---------------------------------------------------------------------------

def tensor_digest(value) -> str:
    """A tensor's dtype, shape and bytes, hashed."""
    t = value.detach().reshape(-1).cpu().contiguous()
    h = hashlib.sha256(f"{t.dtype}{tuple(value.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def leaf_digests(obj, prefix: str = "") -> Dict[str, str]:
    """A digest of every leaf of a world (or any struct, dict or tensor),
    keyed by its path: a tensor's dtype, shape and bytes; a host int as it
    is. Two worlds are bit-equal where their digests are."""
    out: Dict[str, str] = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = tensor_digest(obj)
    elif isinstance(obj, Struct):
        for f in dataclasses.fields(obj):
            out.update(leaf_digests(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(leaf_digests(v, f"{prefix}{k}."))
    elif obj is not None:
        out[prefix] = repr(obj)
    return out


def _replicated(world) -> Dict[str, str]:
    from .parallel.halo import REPLICATED

    return {k: v for k, v in leaf_digests(world).items() if k.split(".")[0] in REPLICATED}


def _host_ints(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {k: v.cpu().tolist() for k, v in metrics.items()}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _drive(mesh, frame: Callable[[], Dict[str, torch.Tensor]], frames: int,
           warmup: int) -> Dict[str, Any]:
    """Run ``frames`` calls of ``frame()``: ``warmup`` calls; then, when
    there was a warm-up, one call under ``torch.cuda.set_sync_debug_mode
    ("error")`` on a card (no host read may happen inside it, the mesh's own
    staging copies excepted); then the timed calls; then, when one is left,
    an instrumented call in which rank 0 brackets every mesh call with a
    sync. Returns the report: the last metrics, steps/s over the timed calls
    (None without), the mesh's bytes and calls a frame after the warm-up,
    the instrumented frame's mesh seconds and frame seconds (rank 0), and
    the launches of every kernel over the whole run."""
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    for _name, fn in KERNELS:
        fn.launches = 0
    m = None
    for _ in range(min(warmup, frames)):
        m = frame()
    left = frames - min(warmup, frames)
    sync()
    mesh.reset_counts()
    checked = False
    if left > 0:
        if cuda and warmup > 0:
            torch.cuda.set_sync_debug_mode("error")
            try:
                m = frame()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked = True
        else:
            m = frame()
        left -= 1
    timed = max(left - 1, 0)
    sync()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = frame()
    sync()
    dt = time.perf_counter() - t0
    mesh_s = frame_s = None
    if left > 0:
        if mesh.rank == 0:
            mesh.timings = []
        t1 = time.perf_counter()
        m = frame()
        sync()
        frame_s = time.perf_counter() - t1
        if mesh.rank == 0:
            mesh_s = sum(s for _n, s in mesh.timings)
            mesh.timings = None
    after = max(frames - min(warmup, frames), 1)
    launches = {name: fn.launches for name, fn in KERNELS}
    report = dict(
        rank=mesh.rank, ranks=mesh.n_slabs, backend=mesh.backend, device=str(mesh.device),
        frames=frames, warmup=warmup, timed_frames=timed,
        steps_per_s=timed / dt if timed else None,
        bytes_per_frame=(mesh.bytes_sent + mesh.bytes_received) / after,
        sent_per_frame=mesh.bytes_sent / after, received_per_frame=mesh.bytes_received / after,
        staged_per_frame=mesh.bytes_staged / after, mesh_calls_per_frame=mesh.calls / after,
        mesh_s=mesh_s, frame_s=frame_s, mesh_share=mesh_s / frame_s if mesh_s else None,
        host_reads_checked=checked, metrics=_host_ints(m), launches=launches)
    # every rank's launches, gathered to rank 0 (None on the others)
    every = mesh.gather([torch.tensor(list(launches.values()), device=mesh.device)])
    report["launches_by_rank"] = None if every is None else {
        name: every[:, k].tolist() for k, (name, _fn) in enumerate(KERNELS)}
    return report


def _build(scene, device, args, kwargs) -> Engine:
    eng = scene(device, *args, **(kwargs or {}))
    eng._flush_pending()
    return eng


# ---------------------------------------------------------------------------
# the cells: a scene through one step on the process mesh
# ---------------------------------------------------------------------------

def halo_cell(mesh, name: str, scene: Callable, args: Sequence = (), kwargs=None,
              frames: int = 1, warmup: int = 0, oversub: float = 4.0):
    """``scene(device, *args, **kwargs)`` through the halo step on ``mesh``
    for ``frames`` frames. Returns ([report], the rank's chunks, the step,
    the engine)."""
    eng = _build(scene, mesh.device, args, kwargs)
    step, place = make_halo_step(eng, mesh, oversub=oversub)
    state = place(eng.world)
    ins = eng.input.snapshot(mesh.device)

    def frame():
        nonlocal state
        state, m = step(state, ins)
        return m

    rep = _drive(mesh, frame, frames, warmup)
    rep.update(cell=name, step="halo", entities=eng.world.n_entities,
               substeps=step.plan.cfg.physics.sub_step_count,
               chunk_rows=[c.n_entities for c in state], route_cap=step.plan.route_cap,
               digests=[leaf_digests(c) for c in state], replicated=_replicated(state[0]),
               step_count=state[0].step_count)
    return [rep], state, step, eng


def homed_cell(mesh, name: str, scene: Callable, args: Sequence = (), kwargs=None,
               frames: int = 1, warmup: int = 0, headroom: float = 2.0):
    """``scene(...)`` through the homed step on ``mesh``. Returns
    ([report], (chunks, gids), the step, the engine)."""
    eng = _build(scene, mesh.device, args, kwargs)
    step, place, _unplace, _ctl = make_homed_step(eng, mesh, headroom=headroom)
    chunks, gids = place(eng.world)
    ins = eng.input.snapshot(mesh.device)

    def frame():
        nonlocal chunks, gids
        chunks, gids, m = step(chunks, gids, ins)
        return m

    rep = _drive(mesh, frame, frames, warmup)
    rep.update(cell=name, step="homed", entities=eng.world.n_entities, n_cap=step.plan.n_cap,
               substeps=step.plan.cfg.physics.sub_step_count,
               digests=[dict(leaf_digests(c), gids=tensor_digest(g))
                        for c, g in zip(chunks, gids)],
               replicated=_replicated(chunks[0]), step_count=chunks[0].step_count)
    return [rep], (chunks, gids), step, eng


def sharded_cell(mesh, name: str, scene: Callable, args: Sequence = (), kwargs=None,
                 frames: int = 1, warmup: int = 0):
    """``scene(...)`` through the entity-sharded step on ``mesh`` (the
    scene's engine planned: ``Engine.raw_step_fn``). Returns ([report], the
    rank's shard)."""
    eng = _build(scene, mesh.device, args, kwargs)
    fn = eng.raw_step_fn()
    shard = shard_world(eng.world, mesh)
    step = make_sharded_step(fn, shard, mesh)
    ins = eng.input.snapshot(mesh.device)

    def frame():
        nonlocal shard
        shard, m = step(shard, ins)
        return m

    rep = _drive(mesh, frame, frames, warmup)
    rep.update(cell=name, step="sharded", entities=eng.world.n_entities,
               substeps=eng.config.physics.sub_step_count,
               shard_rows=shard.n_entities, digests=[leaf_digests(shard)],
               step_count=shard.step_count)
    return [rep], shard


# ---------------------------------------------------------------------------
# the reference's rungs
# ---------------------------------------------------------------------------

def rung_collectives(mesh):
    """Rung 0: every method of the process mesh on this rank's part of
    seeded inputs on the mesh's device (integers, booleans, and floats whose
    sum depends on its order) against ``SlabMesh`` on every part, bit for
    bit. Reports {method: equal}."""
    from .parallel import make_mesh

    d, r, dev = mesh.n_slabs, mesh.rank, mesh.device
    rng = np.random.default_rng(11)
    blocks = [torch.from_numpy(rng.integers(-2**40, 2**40, (d, 5, 3))).to(dev)
              for _ in range(d)]
    floats = [torch.from_numpy((rng.standard_normal(64) * 10.0 ** rng.integers(-8, 9, 64))
                               .astype(np.float32)).to(dev) for _ in range(d)]
    rows = [torch.from_numpy(rng.random((2, 7)) < 0.5).to(dev) for _ in range(d)]
    ints = [torch.tensor(int(v), dtype=torch.int32, device=dev) for v in rng.integers(0, 100, d)]
    ref = make_mesh(d, dev)
    perm = [(d - 1, 0), (0, d - 1)] if d > 1 else []
    g = mesh.gather([blocks[r]])
    equal = dict(
        all_to_all=torch.equal(mesh.all_to_all([blocks[r]])[0], ref.all_to_all(blocks)[r]),
        shift_down=torch.equal(mesh.shift_down([rows[r]])[0], ref.shift_down(rows)[r]),
        shift_up=torch.equal(mesh.shift_up([floats[r]])[0], ref.shift_up(floats)[r]),
        ppermute=torch.equal(mesh.ppermute([floats[r]], perm)[0], ref.ppermute(floats, perm)[r]),
        all_gather=torch.equal(mesh.all_gather([rows[r]]), ref.all_gather(rows)),
        psum_float=torch.equal(mesh.psum([floats[r]]), ref.psum(floats)),
        psum_int=torch.equal(mesh.psum([ints[r]]), ref.psum(ints)),
        gather=torch.equal(g, ref.gather(blocks)) if r == 0 else g is None)
    # these floats' sum depends on its order (from three terms on: a + b is
    # b + a), so psum_float has teeth
    order_matters = d < 3 or not torch.equal(ref.psum(floats), ref.psum(floats[::-1]))
    _require(all(equal.values()) and order_matters,
             f"rung 0: the process mesh differs from SlabMesh: {equal}")
    return [dict(cell="0_collectives", rank=r, ranks=d, backend=mesh.backend,
                 device=str(dev), equal=equal, calls=mesh.calls, bytes_sent=mesh.bytes_sent,
                 bytes_received=mesh.bytes_received, bytes_staged=mesh.bytes_staged)]


def _rounded(n: int, d: int, least: int = 1) -> int:
    return max(n // d, least) * d


def rung_halo_boids(mesh):
    """Rung 1: the flocking scene through the halo step, one frame."""
    d = mesh.n_slabs
    n = _rounded(HALO_BOIDS, d)
    reps, chunks, _step, _eng = halo_cell(mesh, "1_halo_boids", boids_scene, (n,))
    m = reps[0]["metrics"]
    _require(m["active_count"] == n, f"rung 1: active_count {m['active_count']} != {n}")
    _require(m["n_binned"] == n, f"rung 1: n_binned {m['n_binned']} != {n}")
    _require(m["route_overflow_logic"] == 0, "rung 1: route_overflow_logic")
    _require(all(c.n_entities == n // d for c in chunks), "rung 1: a chunk is not N/D rows")
    return reps


def rung_mixed(mesh):
    """Rungs 1b and 1c: the mixed scene through the halo step, two frames
    (Enter, then Stay), then two more through the chunked step."""
    d = mesh.n_slabs
    n = _rounded(MIXED, d, 2)
    reps, chunks, _step, eng = halo_cell(mesh, "1b_halo_mixed", mixed_scene, (n,), frames=2,
                                         warmup=1)
    m = reps[0]["metrics"]
    _require(m["active_count"] == n, f"rung 1b: active_count {m['active_count']} != {n}")
    _require(m["active_particles"] > 0, "rung 1b: tick emits made no particles")
    step_c, _place = make_halo_step(eng, mesh, chunk_steps=2)
    ins = eng.input.snapshot(mesh.device)
    chunks, mc = step_c(chunks, [ins, ins])
    _require(mc["active_count"][-1].item() == n, "rung 1c: active_count")
    _require(chunks[0].step_count == 4, f"rung 1c: step_count {chunks[0].step_count} != 4")
    reps.append(dict(cell="1c_halo_chunked", step="halo", rank=mesh.rank, frames=2,
                     metrics=_host_ints(mc), step_count=chunks[0].step_count,
                     digests=[leaf_digests(c) for c in chunks],
                     replicated=_replicated(chunks[0])))
    return reps


def rung_homed_boids(mesh):
    """Rung 1d: 4,096 boids through the homed step (headroom 4), two
    frames."""
    n = _rounded(HOMED_BOIDS, mesh.n_slabs)
    reps, *_rest = homed_cell(mesh, "1d_homed_boids", boids_scene, (n, 5), frames=2, warmup=1,
                              headroom=4.0)
    m = reps[0]["metrics"]
    _require(m["active_count"] == n, f"rung 1d: active_count {m['active_count']} != {n}")
    _require(m["home_violators"] == 0, f"rung 1d: home_violators {m['home_violators']}")
    return reps


def rung_homed_mixed(mesh):
    """Rung 1e: the mixed scene as first built through the homed step
    (headroom 4), two frames."""
    n = _rounded(MIXED, mesh.n_slabs, 2)
    reps, *_rest = homed_cell(mesh, "1e_homed_mixed", mixed_scene, (n,), frames=2, warmup=1,
                              headroom=4.0)
    m = reps[0]["metrics"]
    _require(m["active_count"] == n, f"rung 1e: active_count {m['active_count']} != {n}")
    _require(m["active_particles"] > 0, "rung 1e: no particles")
    _require(m["home_violators"] == 0, f"rung 1e: home_violators {m['home_violators']}")
    return reps


def rung_sharded_balls(mesh):
    """Rung 2: the entity-sharded step on the balls scene, 32 entities a
    rank, one frame."""
    n = mesh.n_slabs * SHARDED_PER_RANK
    reps, _shard = sharded_cell(mesh, "2_sharded_balls", balls_scene, (n,))
    m = reps[0]["metrics"]
    _require(m["active_count"] == n, f"rung 2: active_count {m['active_count']} != {n}")
    return reps


RUNGS = (rung_collectives, rung_halo_boids, rung_mixed, rung_homed_boids, rung_homed_mixed,
         rung_sharded_balls)


def run_session(mesh, cells: Sequence[Tuple[Callable, Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """The rank's side of :func:`dryrun_multichip`: each ``fn(mesh,
    **kwargs)`` of ``cells`` in order; their reports, host data only."""
    reports: List[Dict[str, Any]] = []
    for fn, kwargs in cells:
        out = fn(mesh, **kwargs)
        reports.extend(out[0] if isinstance(out, tuple) else out)
    return reports


def dryrun_multichip(n_ranks: int, backend: str = "gloo", device: str = "cuda",
                     extra: Sequence[Tuple[Callable, Dict[str, Any]]] = (),
                     deadline_s: float = 900.0,
                     threads: Optional[int] = None) -> List[List[Dict[str, Any]]]:
    """Every rung of the reference's ``dryrun_multichip`` on ``n_ranks``
    processes of one process mesh (``backend`` and ``device`` as
    ``parallel.make_process_mesh`` takes them: gloo shares a card between
    ranks, NCCL needs one card a rank), then the ``extra`` cells
    (``(fn, kwargs)`` pairs: ``fn(mesh, **kwargs)`` returns its reports, or
    a tuple whose first item they are). A failing assert on any rank fails
    the run (``parallel.RankError``). Returns each rung's and cell's
    reports, one per rank, in order, and prints one line for each, as the
    reference does. ``threads``: each rank's CPU threads (default:
    the host's cores shared out)."""
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    cells = [(fn, {}) for fn in RUNGS] + list(extra)
    per_rank = run_ranks(run_session, n_ranks, backend, device, args=(cells,),
                         deadline_s=deadline_s, threads=threads)
    reports = [list(r) for r in zip(*per_rank)]
    for reps in reports:
        r = reps[0]
        if "metrics" not in r:
            print(f"dryrun_multichip({n_ranks}, {backend!r}, {device!r}) {r['cell']} OK: "
                  f"{r['equal']}", flush=True)
            continue
        m = r["metrics"]
        keys = [k for k in ("active_count", "n_binned", "collision_pair_count",
                            "active_particles", "migrated_rows", "home_violators",
                            "solver_binned") if k in m]
        print(f"dryrun_multichip({n_ranks}, {backend!r}, {device!r}) {r['cell']} OK: "
              + " ".join(f"{k}={m[k]}" for k in keys)
              + f" step_count={r['step_count']}", flush=True)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deadline", type=float, default=900.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.backend, a.device, deadline_s=a.deadline)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
