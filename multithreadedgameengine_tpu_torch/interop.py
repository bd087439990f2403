"""Carry state and configuration across from the JAX package.

``world_from_jax`` turns the reference package's ``World``, with its leaves
already on the host as numpy arrays (``jax.device_get(world)``), into the
port's :class:`~.state.World` on a device. ``config_from`` rebuilds an
:class:`~.config.EngineConfig` of the port from the reference's config
object, whose fields are the same. Together they are the port's "weights
carried across": a scene built and stepped by one package continues in the
other. This module never imports JAX; it only reads attributes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .components import BUILTIN_COMPONENTS, Particles, ShadowSprites, define_component
from .config import EngineConfig, make_config
from .state import EVENT_TABLES, World

_NP_DTYPE = {
    torch.float32: np.float32,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.bool: np.bool_,
}
#: a reference user component's field dtype -> its define_component name
_SCHEMA_OF_NP = {np.dtype(np.float32): "f32", np.dtype(np.int32): "i32",
                 np.dtype(np.uint32): "u32", np.dtype(np.bool_): "bool"}

def config_from(cfg) -> EngineConfig:
    """The port's EngineConfig with the field values of ``cfg``."""
    return make_config(**{
        f.name: (
            dataclasses.asdict(getattr(cfg, f.name))
            if dataclasses.is_dataclass(getattr(cfg, f.name))
            else getattr(cfg, f.name)
        )
        for f in dataclasses.fields(cfg)
    })


#: the reference layout's row halo (pallas_kernels.py:35): its grid row r
#: sits at layout row REF_HALO + r, where the port's sits at row 1 + r
REF_HALO = 8

_LAYOUT_LEAVES = ("solver_grad", "solver_meta", "solver_maxv",
                  "solver_x", "solver_y", "solver_px", "solver_py")


def _layout_from_reference(a: np.ndarray, geom) -> np.ndarray:
    """A reference layout ``[cap, rows_buf, Cp]`` cut to the port's
    ``[cap, R+2, C+2]``: reference row ``REF_HALO + r`` becomes row
    ``1 + r`` and lane ``1 + c`` column ``1 + c``, with the empty border."""
    R, C = geom.rows, geom.cols
    return np.ascontiguousarray(a[:, REF_HALO - 1:REF_HALO + R + 1, :C + 2])


def _flat_from_reference(flat: np.ndarray, in_grid: np.ndarray, ref_shape, geom) -> np.ndarray:
    """The reference's flat slot indices in the port's layout; an entity
    not in the grid gets the port's spare index ``cap*(R+2)*(C+2)``.
    ``ref_shape`` is the resident layout's ``[cap, rows_buf, Cp]``, or None
    for the "grid" solver's ``[R+2, C+2, cap]`` encoding."""
    flat = flat.astype(np.int64)
    rows, cols = geom.rows + 2, geom.cols + 2
    if ref_shape is None:
        cell, rank = np.divmod(flat, geom.capacity)
        row, col = np.divmod(cell, cols)
    else:
        _cap, rows_buf, cp = ref_shape
        rank, rest = np.divmod(flat, rows_buf * cp)
        row, col = np.divmod(rest, cp)
        row = row - REF_HALO + 1
    port = (rank * rows + row) * cols + col
    return np.where(in_grid, port, geom.capacity * rows * cols)


def world_from_jax(np_world, device, geom=None) -> World:
    """The port's World from a reference World whose leaves are numpy.

    Every field of the seven built-in components is copied with the port's
    dtype (uint32 colours become int64, see ``components``), and so is every
    user component of ``World.custom``, as a port component of the same
    name and schema (``define_component``). The solver caches
    (bin cache, attribute and position layouts, their stamps) are converted
    to the port's layout when present, which needs the solver geometry
    ``geom`` of the run (a ``GridGeom``): so a reference world stepped
    partway between rebins continues in the port. A non-empty particle
    pool comes across with the decal canvas and dirty tiles (uint8 and
    bool as they are), and a non-empty shadow-sprite buffer as it is; the
    reference's empty pools and placeholder tables, of a world without
    those features, are left behind (the port holds None there), and so is
    its PRNG key, which the port has no user of. The collision-event
    tables (this frame's and the last frame's pairs, the Enter/Stay/Exit
    tables, their counts) come across when the reference allocated them
    (``logic.collision_events``), and so do the on-screen mask and the
    packed screen-event table (``logic.screen_events``): a run stopped in
    the middle of a contact goes on in the port with the same events."""

    def convert(cls, src):
        return cls(**{
            field: torch.from_numpy(
                np.ascontiguousarray(np.asarray(getattr(src, field)))
                .astype(_NP_DTYPE[dtype])
            ).to(device)
            for field, dtype in cls.DTYPES.items()
        })

    comps = {name: convert(cls, getattr(np_world, name))
             for name, cls in BUILTIN_COMPONENTS.items()}
    custom = {}
    for name, src in np_world.custom.items():
        schema = {f.name: _SCHEMA_OF_NP[np.asarray(getattr(src, f.name)).dtype]
                  for f in dataclasses.fields(src)}
        custom[name] = convert(define_component(type(src).__name__, schema), src)
    solver = {}
    if getattr(np_world, "solver_flat", None) is not None:
        if geom is None:
            raise ValueError("world_from_jax: the world carries solver caches; "
                             "pass the solver geometry (geom=)")
        in_grid = np.asarray(np_world.solver_in_grid, bool)
        # the resident layout's shape, or None: bins of the "grid" solver
        ref_shape = next((np.asarray(getattr(np_world, k)).shape for k in _LAYOUT_LEAVES
                          if getattr(np_world, k, None) is not None), None)
        solver["solver_flat"] = torch.from_numpy(_flat_from_reference(
            np.asarray(np_world.solver_flat), in_grid, ref_shape, geom)).to(device)
        solver["solver_in_grid"] = torch.from_numpy(in_grid.copy()).to(device)
        solver["solver_bin_step"] = int(np.asarray(np_world.solver_bin_step))
        for k in _LAYOUT_LEAVES:
            a = getattr(np_world, k, None)
            if a is not None:
                solver[k] = torch.from_numpy(
                    _layout_from_reference(np.asarray(a), geom)).to(device)
        if getattr(np_world, "solver_pos_step", None) is not None:
            solver["solver_pos_step"] = int(np.asarray(np_world.solver_pos_step))
    extra = {}
    if np.asarray(np_world.particles.x).size:
        extra["particles"] = convert(Particles, np_world.particles)
        extra["decal_canvas"] = torch.from_numpy(np.array(np_world.decal_canvas)).to(device)
        extra["decal_dirty"] = torch.from_numpy(np.array(np_world.decal_dirty)).to(device)
    if np.asarray(np_world.shadow_sprites.x).size:
        extra["shadow_sprites"] = convert(ShadowSprites, np_world.shadow_sprites)
    names = ([n for pair in EVENT_TABLES for n in pair]
             if np.asarray(np_world.prev_collision_pairs).size else [])
    if getattr(np_world, "prev_onscreen", None) is not None:
        names += ["prev_onscreen", "screen_events_packed"]
    for name in names:
        extra[name] = torch.from_numpy(np.array(getattr(np_world, name))).to(device)
    return World(**comps, step_count=int(np.asarray(np_world.step_count)), custom=custom,
                 **solver, **extra)
