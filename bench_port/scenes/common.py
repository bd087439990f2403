"""What every scene builder shares: the built scene, and the clone of the
dynamic state the reference is compared on."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: the per-entity fields a frame changes, by the engine's component paths
DYNAMIC = {
    "x": ("transform", "x"), "y": ("transform", "y"),
    "px": ("rigid_body", "px"), "py": ("rigid_body", "py"),
    "vx": ("rigid_body", "vx"), "vy": ("rigid_body", "vy"),
    "ax": ("rigid_body", "ax"), "ay": ("rigid_body", "ay"),
}


@dataclass
class Built:
    engine: object
    inputs: dict  # the harness's draws, numpy arrays
    rows: np.ndarray  # the entity row of each spawned input
    n_rows: int  # entity rows in the world, the mouse's included


def capture(engine) -> dict:
    """A device-side clone of the world's dynamic fields and its frame
    number: a few copies, no host read."""
    w = engine.world
    out = {k: getattr(getattr(w, comp), f).clone() for k, (comp, f) in DYNAMIC.items()}
    out["step"] = int(w.step_count)
    return out
