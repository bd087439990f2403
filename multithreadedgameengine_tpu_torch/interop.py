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

from .components import BUILTIN_COMPONENTS
from .config import EngineConfig, make_config
from .state import World

_NP_DTYPE = {
    torch.float32: np.float32,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.bool: np.bool_,
}

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

    Every field of the five ported components is copied with the port's
    dtype (uint32 tints become int64, see ``components``). The solver caches
    (bin cache, attribute and position layouts, their stamps) are converted
    to the port's layout when present, which needs the solver geometry
    ``geom`` of the run (a ``GridGeom``): so a reference world stepped
    partway between rebins continues in the port. Reference state the port
    does not run yet (the screen-event tables, particles, custom components)
    must be absent; the event and decal tables of a world without those
    features are placeholders and are left behind."""
    unported = [leaf for leaf in ("prev_onscreen",)
                if getattr(np_world, leaf, None) is not None]
    if np.asarray(np_world.particles.x).size:
        unported.append("particles")
    if np_world.custom:
        unported.append("custom")
    if unported:
        raise NotImplementedError(
            f"World.{', World.'.join(unported)} set: not ported to PyTorch yet"
        )
    comps = {}
    for name, cls in BUILTIN_COMPONENTS.items():
        src = getattr(np_world, name)
        comps[name] = cls(**{
            field: torch.from_numpy(
                np.ascontiguousarray(np.asarray(getattr(src, field)))
                .astype(_NP_DTYPE[dtype])
            ).to(device)
            for field, dtype in cls.DTYPES.items()
        })
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
    return World(**comps, step_count=int(np.asarray(np_world.step_count)), **solver)
