"""Checkpoint and resume, in the reference's file format.

PyTorch counterpart of ``multithreadedgameengine_tpu/checkpoint.py:26-122``.
A checkpoint is one ``.npz`` file: every World leaf under
``world:<leaf path>`` (the reference's tree paths, e.g.
``world:transform/x``, ``world:custom/flocking/margin``), and ``__host__``,
the JSON of the format version, the config fingerprint, the Mulberry32
cursor, each class's free list and active count, and the camera. A file
loads only into an engine with the same config and registrations.

A file written by either package loads into the other. Where the port's
World differs from the reference's, the difference is converted at the
file's edge:

- uint32 fields (colours, a user component's ``"u32"``), which the port
  holds as int64, are written as uint32 and read back into int64;
- leaves the port does not allocate (the device PRNG key, which no step
  reads; the empty particle pool, decal canvas and shadow sprites of a
  world without those features; the pair and event tables without
  collision events) are written with the reference's placeholder shapes and
  values, and ignored on reading;
- the frame counter and the solver-cache stamps, host ints in the port,
  are written as int32 scalars;
- the solver caches (the bin cache, the attribute and position layouts,
  their stamps) are laid out differently in each package. The port writes
  its own under ``port:<leaf>``, which the reference does not read, so its
  loader installs zeros with the stamps at -1 (its rule for absent
  caches); the port reads only ``port:`` caches, and from a file without
  them installs zeros with the stamps at -1 likewise. Either way the next
  frame rebins and, under residency, rebuilds the layout from entity order.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Callable, Dict

import numpy as np
import torch

from .components import BUILTIN_COMPONENTS, Particles, ShadowSprites

if TYPE_CHECKING:
    from .engine import Engine

# v2: the collision-event tables live in the World (the reference's format)
FORMAT_VERSION = 2

#: the World's optional array leaves, by name, in both packages
_ARRAYS = ("collision_pairs", "collision_pair_count", "prev_collision_pairs",
           "prev_collision_pair_count", "event_enter", "event_enter_count",
           "event_stay", "event_stay_count", "event_exit", "event_exit_count",
           "decal_canvas", "decal_dirty", "prev_onscreen", "screen_events_packed")
#: the solver caches (port layout) and their host-int stamps
_SOLVER_ARRAYS = ("solver_flat", "solver_in_grid", "solver_grad", "solver_meta",
                  "solver_maxv", "solver_x", "solver_y", "solver_px", "solver_py")
_SOLVER_STAMPS = ("solver_bin_step", "solver_pos_step")

_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_, torch.uint8: np.uint8}


def _config_fingerprint(engine: "Engine") -> str:
    """The reference's fingerprint (checkpoint.py:42-60): the config's repr
    with the fields resolved at the first plan normalised (the scan radius,
    and solver "auto", which a plan rewrites as "pallas"), and each class's
    (name, type, start, count)."""
    cfg = dataclasses.replace(
        engine.config,
        spatial=dataclasses.replace(engine.config.spatial, max_cell_radius=0),
        physics=dataclasses.replace(engine.config.physics, solver="auto"),
    )
    regs = [(name, reg.entity_type, reg.start_index, reg.count)
            for name, reg in engine.classes.items()]
    return json.dumps([repr(cfg), regs])


def _map_world(world, fn: Callable[[str, torch.Tensor], torch.Tensor]):
    """The world with ``fn(leaf path, tensor)`` applied to every leaf the
    two packages share (the components, the particle pool and shadow
    sprites, the event and decal arrays); the solver caches and the frame
    counter are left as they are."""

    def struct(prefix, comp):
        return comp.replace(**{f.name: fn(f"{prefix}/{f.name}", getattr(comp, f.name))
                               for f in dataclasses.fields(comp)})

    changes = {name: struct(name, getattr(world, name)) for name in BUILTIN_COMPONENTS}
    changes["custom"] = {name: struct(f"custom/{name}", comp)
                         for name, comp in world.custom.items()}
    for name in ("particles", "shadow_sprites"):
        if getattr(world, name) is not None:
            changes[name] = struct(name, getattr(world, name))
    for name in _ARRAYS:
        if getattr(world, name) is not None:
            changes[name] = fn(name, getattr(world, name))
    return world.replace(**changes)


def _to_file(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    # every int64 leaf _map_world visits is a uint32 field of the reference
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def _placeholders(engine: "Engine", world) -> Dict[str, np.ndarray]:
    """The leaves the reference holds where the port holds none, as the
    reference's ``make_world`` fills them (state.py:131-188)."""
    out = {"key": np.asarray([0, engine.config.seed & 0xFFFFFFFF], np.uint32)}

    def empty(prefix, cls):
        for name, dtype in cls.DTYPES.items():
            out[f"{prefix}/{name}"] = np.zeros((0,), np.uint32 if dtype == torch.int64
                                               else _NP_DTYPE[dtype])

    if world.particles is None:
        empty("particles", Particles)
    if world.shadow_sprites is None:
        empty("shadow_sprites", ShadowSprites)
    if world.decal_canvas is None:
        out["decal_canvas"] = np.zeros((1, 1, 4), np.uint8)
        out["decal_dirty"] = np.zeros((1, 1), np.bool_)
    if world.collision_pairs is None:
        out["collision_pairs"] = np.full((engine.config.physics.max_collision_pairs, 2), -1,
                                         np.int32)
        for table in ("prev_collision_pairs", "event_enter", "event_stay", "event_exit"):
            out[table] = np.zeros((0, 2), np.int32)
        for count in ("collision_pair_count", "prev_collision_pair_count",
                      "event_enter_count", "event_stay_count", "event_exit_count"):
            out[count] = np.zeros((), np.int32)
    return out


def save_checkpoint(engine: "Engine", path: str) -> None:
    engine._require_init()
    engine._flush_pending()
    world = engine.world
    arrays: Dict[str, np.ndarray] = {}

    def collect(key, t):
        arrays[f"world:{key}"] = _to_file(t)
        return t

    _map_world(world, collect)
    for key, a in _placeholders(engine, world).items():
        arrays[f"world:{key}"] = a
    arrays["world:step_count"] = np.asarray(world.step_count, np.int32)
    for name in _SOLVER_ARRAYS:
        if getattr(world, name) is not None:
            arrays[f"port:{name}"] = getattr(world, name).cpu().numpy()
    for name in _SOLVER_STAMPS:
        if getattr(world, name) is not None:
            arrays[f"port:{name}"] = np.asarray(getattr(world, name), np.int32)
    host = {
        "version": FORMAT_VERSION,
        "fingerprint": _config_fingerprint(engine),
        "rng_t": int(engine.rng._t),
        "pools": {name: {"free": list(map(int, reg.pool.free)),
                         "active": reg.pool.active_count}
                  for name, reg in engine.classes.items()},
        "camera": [engine.input.camera_x, engine.input.camera_y, engine.input.camera_zoom],
    }
    arrays["__host__"] = np.frombuffer(json.dumps(host).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(engine: "Engine", path: str) -> None:
    """Restore into an engine with the same config and registrations.
    Queued spawns and despawns are dropped."""
    engine._require_init()
    with np.load(path, allow_pickle=False) as data:
        host = json.loads(bytes(data["__host__"]).decode())
        if host["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {host['version']}")
        if host["fingerprint"] != _config_fingerprint(engine):
            raise ValueError("checkpoint was written by an engine with a different config or "
                             "entity registration layout")
        engine._flush_event_log()
        dev = engine.device

        def load(key, old):
            arr = data[f"world:{key}"]
            if arr.shape != tuple(old.shape):
                raise ValueError(f"shape mismatch for world:{key}: {arr.shape} vs "
                                 f"{tuple(old.shape)}")
            return torch.from_numpy(arr.astype(_NP_DTYPE[old.dtype])).to(dev)

        world = _map_world(engine.world, load)
        changes = {"step_count": int(data["world:step_count"])}
        # the port's own caches, or zeros with the stamps at -1 (the
        # reference's rule for absent caches, checkpoint.py:100-115)
        for name in _SOLVER_ARRAYS:
            old = getattr(world, name)
            if old is None:
                continue
            arr = data[f"port:{name}"] if f"port:{name}" in data else None
            if arr is not None and arr.shape == tuple(old.shape):
                changes[name] = torch.from_numpy(arr.astype(_NP_DTYPE[old.dtype])).to(dev)
            else:
                changes[name] = torch.zeros_like(old)
                changes.update({s: -1 for s in _SOLVER_STAMPS if getattr(world, s) is not None})
        for name in _SOLVER_STAMPS:
            if getattr(world, name) is not None and name not in changes:
                key = f"port:{name}"
                changes[name] = int(data[key]) if key in data else -1
    engine.world = world.replace(**changes)
    engine.rng._t = np.uint32(host["rng_t"])
    for name, pool_state in host["pools"].items():
        pool = engine.classes[name].pool
        pool.restore_free(pool_state["free"])
        pool.active_count = pool_state["active"]
    engine.input.camera_x, engine.input.camera_y, engine.input.camera_zoom = host["camera"]
    engine._pending_ops.clear()
