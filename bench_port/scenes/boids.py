"""The boids scene on the engine under test: BASELINE config 3's flocking
(``models.boids.Boid``) through ``Engine`` and ``make_config``, as the
repo's boids scenes are built (``chip_smoke.boids_engine``,
``chip_smoke.py:869-893``, copied): the boids and the mouse, one substep, the
boids spawned in one batch from the harness's draws (x and y uniform in
``[margin, extent - margin]``, vx and vy uniform in ``[-speed, speed]``)."""

from __future__ import annotations

import numpy as np

from .common import Built


def draw(cfg: dict, seed: int) -> dict:
    n, m, v = cfg["n_boids"], cfg["spawn_margin"], cfg["spawn_speed"]
    d = np.random.default_rng([seed, 0]).random((4, n))
    return {
        "x": (m + d[0] * (cfg["world_width"] - 2 * m)).astype(np.float32),
        "y": (m + d[1] * (cfg["world_height"] - 2 * m)).astype(np.float32),
        "vx": (-v + d[2] * 2 * v).astype(np.float32),
        "vy": (-v + d[3] * 2 * v).astype(np.float32),
    }


def build(cfg: dict, seed: int, device) -> Built:
    from multithreadedgameengine_tpu_torch import Engine, make_config
    from multithreadedgameengine_tpu_torch.models.boids import Boid

    inputs = draw(cfg, seed)
    eng = Engine(make_config(world_width=cfg["world_width"], world_height=cfg["world_height"],
                             seed=seed % (1 << 31), spatial=dict(cfg["spatial"]),
                             physics=dict(cfg["physics"])), device=device)
    eng.register_entity_class(Boid, cfg["n_boids"])
    eng.init()
    rows = eng.spawn_batch("Boid", cfg["n_boids"], call_on_spawned=False, **inputs)
    if len(rows) != cfg["n_boids"]:
        raise RuntimeError(f"spawned {len(rows)} of {cfg['n_boids']} boids")
    return Built(engine=eng, inputs=inputs, rows=np.asarray(rows, np.int64), n_rows=cfg["n_boids"] + 1)
