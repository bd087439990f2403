"""Rank functions of ``tests/test_torch_dist.py``: what each process of a
``parallel.run_ranks`` run does. This module imports the port and numpy
only (never JAX): a spawned rank imports it afresh.

Each comparison runs the process mesh and, on rank 0, the in-process
``SlabMesh`` over the same scene in the same process (the same thread
count), and returns per-frame digests of every leaf of both worlds
(``dryrun.leaf_digests``): equal digests are equal bits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from multithreadedgameengine_tpu_torch import Engine, make_config
from multithreadedgameengine_tpu_torch.components import Struct
from multithreadedgameengine_tpu_torch.dryrun import boids_scene, leaf_digests
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.models.boids import Boid
from multithreadedgameengine_tpu_torch.models.predators import BLOOD, make_predators_engine
from multithreadedgameengine_tpu_torch.parallel import (
    make_halo_step,
    make_homed_step,
    make_mesh,
    make_sharded_step,
    shard_world,
    unplace_fn,
)

# ---------------------------------------------------------------------------
# worlds across the process boundary
# ---------------------------------------------------------------------------

def leaves_of(obj, prefix: str = "") -> Dict[str, Any]:
    """Every leaf of a world (or any struct or dict) keyed by its path, as
    ``dryrun.leaf_digests`` keys them: tensors on the CPU, host ints and
    None as they are. What crosses a process boundary in place of a world,
    whose user components are classes made at run time and do not pickle."""
    if isinstance(obj, Struct):
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            out.update(leaves_of(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(leaves_of(v, f"{prefix}{k}."))
        return out
    return {prefix: obj.cpu() if isinstance(obj, torch.Tensor) else obj}


def with_leaves(obj, leaves: Dict[str, Any], prefix: str = ""):
    """``obj`` with every leaf taken from ``leaves`` (:func:`leaves_of` of
    a world of the same structure; a missing path raises ``KeyError``)."""
    if isinstance(obj, Struct):
        return obj.replace(**{f.name: with_leaves(getattr(obj, f.name), leaves,
                                                  f"{prefix}{f.name}.")
                              for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: with_leaves(v, leaves, f"{prefix}{k}.") for k, v in obj.items()}
    return leaves[prefix]


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def pile(device):
    """tests/test_torch_halo.py's gravity pile: 255 balls and the mouse in
    1600 x 1000, cell 50, the mouse held down at (800, 900)."""
    eng = make_balls_engine(n_balls=255, spawn=True, seed=99, world_width=1600.0,
                            world_height=1000.0, spatial=dict(cell_size=50.0, max_neighbors=32),
                            device=device)
    eng._flush_pending()
    eng.input.set_mouse(800.0, 900.0)
    eng.input.mouse_button(0, True)
    return eng


def boids_1d(device):
    """The dry run's rung 1d scene: 4,096 boids (rng seed 5)."""
    return boids_scene(device, 4096, 5)


def prey_mixed(device):
    """The predators scene with 400 prey, 8 predators and 3 lights (412
    entities with the mouse: four slabs of 103) in 1600 x 1000 with
    collision events, the camera over the whole world, a blood burst and a
    burst that lands at once queued into the pool: event tables, particles,
    decals and shadows all have work."""
    eng = make_predators_engine(n_prey=400, n_predators=8, n_lights=3, world_width=1600.0,
                                world_height=1000.0, logic=dict(collision_events=True),
                                device=device)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    eng._flush_pending()
    s = eng.classes["Prey"].start_index
    t = eng.world.transform
    eng.emitter.emit_batch(x=t.x[s:s + 16].cpu().numpy(), y=t.y[s:s + 16].cpu().numpy(),
                           **BLOOD)
    eng.emitter.emit_batch(**LANDING)
    eng._flush_emissions()
    return eng


#: prey_mixed's burst that lands at once (tests/test_torch_predators.py's)
LANDING = dict(
    x=[300.0, 310.0, 900.0], y=[300.0, 305.0, 500.0], count={"min": 6, "max": 12},
    z=-1.0, vz=5.0, angle_xy={"min": 0.0, "max": 360.0}, speed={"min": 0.5, "max": 3.0},
    lifespan=9000.0, gravity=0.0, texture="blood", scale={"min": 0.5, "max": 2.0},
    alpha={"min": 0.4, "max": 0.9}, tint={"min": 0xAA0000, "max": 0xFF4444},
    stay_on_the_floor=True)


def live_boids(device):
    """tests/test_torch_homed.py's live-control scene: 255 of 383 boid
    slots spawned (and the mouse) in 2000 x 1600, two substeps."""
    eng = Engine(make_config(world_width=2000.0, world_height=1600.0, seed=7,
                             spatial=dict(cell_size=100.0, max_neighbors=64, cell_capacity=32),
                             physics=dict(sub_step_count=2, gravity=(0.0, 0.0))), device=device)
    eng.register_entity_class(Boid, 383)
    eng.init()
    rng = np.random.default_rng(3)
    eng.spawn_batch("Boid", 255, x=rng.uniform(50, 1950, 255).astype(np.float32),
                    y=rng.uniform(50, 1550, 255).astype(np.float32),
                    vx=rng.uniform(-3, 3, 255).astype(np.float32),
                    vy=rng.uniform(-3, 3, 255).astype(np.float32))
    eng._flush_pending()
    return eng


def live_spawn_args(k: int):
    """The positions and velocities of the ``k`` boids a live insert
    spawns (tests/test_torch_homed.py's)."""
    rng = np.random.default_rng(77)
    return dict(x=rng.uniform(100, 1900, k).astype(np.float32),
                y=rng.uniform(100, 1500, k).astype(np.float32),
                vx=rng.uniform(-2, 2, k).astype(np.float32),
                vy=rng.uniform(-2, 2, k).astype(np.float32))


def sharded_balls(device):
    """tests/test_sharding.py's scene: 255 ball slots in 2000 x 1500, seed
    4, 200 spawned at ``rng() * extent``, its step planned."""
    eng = make_balls_engine(n_balls=255, spawn=False, seed=4, world_width=2000.0,
                            world_height=1500.0, device=device)
    for _ in range(200):
        eng.spawn("Ball", x=eng.rng() * 2000.0, y=eng.rng() * 1500.0)
    eng._flush_pending()
    eng.raw_step_fn()
    return eng


SCENES = {f.__name__: f for f in (pile, boids_1d, prey_mixed, live_boids, sharded_balls)}


# ---------------------------------------------------------------------------
# (b), (c) the slab steps against the in-process mesh
# ---------------------------------------------------------------------------

def halo_vs_slab_mesh(mesh, scene: str, frames: int, oversub: float = 4.0,
                      chunk_steps: int = 1, start=None):
    """The halo step on the process mesh, the world gathered to rank 0 after
    every call; on rank 0 the same on ``SlabMesh``. ``start``: the
    :func:`leaves_of` of a world the scene restores before it is placed
    (the reference's, carried across), or None. Returns on rank 0 the
    per-call digests of both, the last metrics of both and the
    :func:`leaves_of` of the process mesh's last world; None elsewhere."""
    build = SCENES[scene]

    def run(m):
        eng = build(m.device)
        if start is not None:
            eng.restore(with_leaves(eng.world, start))
        step, place = make_halo_step(eng, m, oversub=oversub, chunk_steps=chunk_steps)
        chunks = place(eng.world)
        ins = eng.input.snapshot(m.device)
        arg = ins if chunk_steps == 1 else [ins] * chunk_steps
        digests = []
        for _ in range(frames):
            chunks, metrics = step(chunks, arg)
            w = unplace_fn(chunks, m)
            digests.append(None if w is None else leaf_digests(w))
        return digests, {k: v.tolist() for k, v in metrics.items()}, w

    dist_digests, dist_metrics, w = run(mesh)
    if mesh.rank != 0:
        return None
    slab_digests, slab_metrics, _w = run(make_mesh(mesh.n_slabs, mesh.device))
    return dict(dist=dist_digests, slab=slab_digests, dist_metrics=dist_metrics,
                slab_metrics=slab_metrics, features=features(w),
                world=leaves_of(w))


def features(w):
    """What the mixed passes left in a world: event rows, live particles,
    stamped canvas pixels and active shadow sprites (0 without the
    feature)."""
    def count(name):
        v = getattr(w, name)
        return 0 if v is None else int(v)

    return dict(enter=count("event_enter_count"), stay=count("event_stay_count"),
                exit=count("event_exit_count"),
                particles=0 if w.particles is None else int(w.particles.active.sum()),
                canvas_px=0 if w.decal_canvas is None else int((w.decal_canvas[..., 3] > 0).sum()),
                shadows=0 if w.shadow_sprites is None else int(w.shadow_sprites.active.sum()))


def homed_vs_slab_mesh(mesh, scene: str, frames: int, headroom: float, insert_at: int,
                       remove_at: int, n_insert: int = 40, n_remove: int = 5, start=None):
    """The homed step on the process mesh with a live insert of
    ``n_insert`` spawned boids before frame ``insert_at`` and a live remove
    of ``n_remove`` boids before frame ``remove_at``, the same arguments on
    every rank; the world gathered to rank 0 after every frame; on rank 0
    the same on ``SlabMesh``. ``start`` as :func:`halo_vs_slab_mesh` takes
    it. Returns on rank 0 the per-frame digests and metrics of both, the
    control plane's counts and the :func:`leaves_of` of the process mesh's
    last world."""
    build = SCENES[scene]

    def run(m):
        eng = build(m.device)
        if start is not None:
            eng.restore(with_leaves(eng.world, start))
        step, place, unplace, ctl = make_homed_step(eng, m, headroom=headroom)
        chunks, gids = place(eng.world)
        ins = eng.input.snapshot(m.device)
        digests, plane, per_frame = [], [], []
        for f in range(frames):
            if f == insert_at:
                new = eng.spawn_batch("Boid", n_insert, **live_spawn_args(n_insert))
                eng._flush_pending()
                rows = ctl.pack_rows(eng.world, new)
                chunks, gids, denied = ctl.insert(chunks, gids, rows, new)
                plane.append(("denied", int(denied)))
            if f == remove_at:
                victims = np.sort(eng.classes["Boid"].pool.active_indices())[:n_remove]
                chunks, gids, removed = ctl.remove(chunks, gids, victims.astype(np.int32))
                plane.append(("removed", int(removed)))
            chunks, gids, metrics = step(chunks, gids, ins)
            w = unplace(chunks, gids)
            digests.append(None if w is None else leaf_digests(w))
            per_frame.append({k: v.tolist() for k, v in metrics.items()})
        return digests, plane, per_frame, w

    dist_digests, dist_plane, dist_metrics, w = run(mesh)
    if mesh.rank != 0:
        return None
    slab_digests, slab_plane, slab_metrics, _w = run(make_mesh(mesh.n_slabs, mesh.device))
    return dict(dist=dist_digests, slab=slab_digests, dist_plane=dist_plane,
                slab_plane=slab_plane, dist_metrics=dist_metrics, slab_metrics=slab_metrics,
                world=leaves_of(w))


# ---------------------------------------------------------------------------
# (d) the entity-sharded step
# ---------------------------------------------------------------------------

def sharded_vs_engine(mesh, frames: int):
    """``tests/test_sharding.py``'s scene through the entity-sharded step
    for ``frames`` frames; on rank 0 also ``Engine.step`` on the same scene.
    Returns this rank's rows of x and y, its shard's digests and the last
    metrics; rank 0 adds ``Engine.step``'s world cut to each rank's rows."""
    eng = sharded_balls(mesh.device)
    shard = shard_world(eng.world, mesh)
    step = make_sharded_step(eng.raw_step_fn(), shard, mesh)
    ins = eng.input.snapshot(mesh.device)
    for _ in range(frames):
        shard, metrics = step(shard, ins)
    out = dict(x=shard.transform.x.numpy().copy(), y=shard.transform.y.numpy().copy(),
               digests=leaf_digests(shard), metrics={k: v.tolist() for k, v in metrics.items()})
    if mesh.rank == 0:
        ref = sharded_balls(mesh.device)
        ref.step(frames)
        n_loc = shard.n_entities
        out["engine_digests"] = [
            leaf_digests(shard_world(ref.world, _Slab(r, mesh.n_slabs, mesh.device)))
            for r in range(mesh.n_slabs)]
        out["engine_rows"] = n_loc
    return out


class _Slab:
    """A one-slab view of a mesh of ``n_slabs``: what ``shard_world`` reads
    to cut rank ``r``'s rows."""

    def __init__(self, r, n_slabs, device):
        self.slabs, self.n_slabs, self.device = (r,), n_slabs, device


# ---------------------------------------------------------------------------
# (e) failures
# ---------------------------------------------------------------------------

def raise_on(mesh, bad_rank: int):
    """Rank ``bad_rank`` raises; the others wait in a collective for it."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    mesh.all_gather([torch.zeros(1)])
    return mesh.rank


def hang(mesh, seconds: float):
    """Rank 0 waits in an all_gather that rank 1 never joins (it sleeps)."""
    if mesh.rank == 1:
        time.sleep(seconds)
        return None
    mesh.all_gather([torch.zeros(1)])
    return dist.get_rank()
