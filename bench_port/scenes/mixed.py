"""The mixed ecosystem on the engine under test: BASELINE config 5, the
predators demo's scene (``models.predators.make_predators_engine``: prey,
predators, tall lights and the mouse, the demo's 50,000-particle pool with
decals, lighting with shadows) at the configuration's prey count, built as
the repo's 1M mixed rung builds it (``benchmarks/run_ladder.py:289-367``):
cell 160 of capacity 64, 64 neighbours, per-class lists, collision events
in overlapped chunks, one substep, the world scaled at the demo's density.
Prey, predators and lights are spawned in one batch each, at rest, from
the harness's draws (x and y uniform over the world), without
``on_spawned``, as the rung spawns the prey and predators (it places the
lights from the engine's stream)."""

from __future__ import annotations

import numpy as np

from ..reference.mixed import counts
from .common import Built

CLASSES = ("Prey", "Predator", "TallLight")


def draw(cfg: dict, seed: int) -> dict:
    """x and y of the prey, then the predators, then the lights; ``kind``
    0, 1, 2 by class; the engine's seed, whose stream the prey's setup
    draws their speeds and ranges from."""
    n = counts(cfg)
    total = sum(n)
    d = np.random.default_rng([seed, 0]).random((2, total))
    return {
        "x": (d[0] * cfg["world_width"]).astype(np.float32),
        "y": (d[1] * cfg["world_height"]).astype(np.float32),
        "kind": np.repeat(np.arange(3, dtype=np.int64), n),
        "engine_seed": np.int64(seed % (1 << 31)),
    }


def build(cfg: dict, seed: int, device) -> Built:
    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    inputs = draw(cfg, seed)
    n = counts(cfg)
    eng = make_predators_engine(
        n[0], n[1], n[2], spawn=False, device=device, seed=int(inputs["engine_seed"]),
        world_width=cfg["world_width"], world_height=cfg["world_height"],
        spatial=dict(cfg["spatial"]), logic=dict(cfg["logic"]),
        physics={k: tuple(v) if isinstance(v, list) else v for k, v in cfg["physics"].items()},
        particle=dict(cfg["particle"]), lighting=dict(cfg["lighting"]))
    rows = []
    for k, (name, count) in enumerate(zip(CLASSES, n)):
        sel = inputs["kind"] == k
        got = eng.spawn_batch(name, count, call_on_spawned=False,
                              x=inputs["x"][sel], y=inputs["y"][sel])
        if len(got) != count:
            raise RuntimeError(f"spawned {len(got)} of {count} {name}")
        rows.append(np.asarray(got, np.int64))
    return Built(engine=eng, inputs=inputs, rows=np.concatenate(rows), n_rows=sum(n) + 1)
