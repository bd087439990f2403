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


def world_from_jax(np_world, device) -> World:
    """The port's World from a reference World whose leaves are numpy.

    Every field of the five ported components is copied with the port's
    dtype (uint32 tints become int64, see ``components``). Reference state
    the port does not run yet (the solver caches of ``rebin_interval > 1``,
    the screen-event tables, particles, custom components) must be absent;
    the event and decal tables of a world without those features are
    placeholders and are left behind."""
    unported = [leaf for leaf in ("solver_flat", "solver_x", "prev_onscreen")
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
    return World(**comps, step_count=int(np.asarray(np_world.step_count)))
