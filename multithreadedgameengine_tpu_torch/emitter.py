"""Host-side particle emission API — the ParticleEmitter static facade
(src/core/ParticleEmitter.js).

The port's copy of ``multithreadedgameengine_tpu/emitter.py``: host code
calls ``engine.emitter.emit(...)`` or ``emit_batch(...)``; emissions queue as
numpy columns and land in the device pool before the next frame
(``Engine._flush_emissions``, the control plane, like spawns).

Config keys mirror the reference's emit() options (ParticleEmitter.js:29-77),
snake_cased; a numeric field takes a scalar or a ``{min, max}`` dict /
``(min, max)`` tuple resolved per particle by randomRange (utils.js:49-56),
drawn from the engine's seeded Mulberry32 stream in the reference's order,
so both packages draw the same particles.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _as_range(value):
    if isinstance(value, dict):
        return float(value["min"]), float(value["max"])
    if isinstance(value, tuple) and len(value) == 2:
        return float(value[0]), float(value[1])
    return None


#: the columns of an emission batch and their host dtypes (the uint32 tint
#: becomes the port's int64 on the device)
BATCH_KEYS = (
    ("x", np.float32), ("y", np.float32), ("z", np.float32),
    ("vx", np.float32), ("vy", np.float32), ("vz", np.float32),
    ("lifespan", np.float32), ("gravity", np.float32),
    ("scale", np.float32), ("alpha", np.float32),
    ("fade_on_the_floor", np.float32),
    ("tint", np.uint32), ("texture_id", np.int32),
    ("stay_on_the_floor", bool),
)


class ParticleEmitterAPI:
    #: emission batches pad to these sizes (the reference compiles one
    #: program per bucket; here they bound one flush, as there)
    BUCKETS = (16, 64, 256, 1024, 4096)

    def __init__(self, engine):
        self._engine = engine
        self._pending: List[Dict[str, Any]] = []

    def _random_range(self, value, default) -> float:
        """randomRange (utils.js:49-56): a range draws once, a scalar is
        itself, None is ``default``."""
        if value is None:
            return float(default)
        pair = _as_range(value)
        if pair is None:
            return float(value)
        return pair[0] + self._engine.rng() * (pair[1] - pair[0])

    def emit(
        self,
        count=1,
        x=0.0,
        y=0.0,
        z=0.0,
        angle_xy=None,
        speed=None,
        vx=0.0,
        vy=0.0,
        vz=0.0,
        lifespan=1000.0,
        gravity=0.15,
        texture: str = None,
        tint=None,
        scale=1.0,
        alpha=1.0,
        fade_on_the_floor=0.0,
        stay_on_the_floor: bool = False,
    ) -> int:
        """ParticleEmitter.emit (ParticleEmitter.js:78-173). Returns the
        number of particles queued (spawns are bounded by pool space at
        flush time, like the reference's exhausted scan)."""
        if self._engine.config.particle.max_particles <= 0:
            return 0
        n = int(round(self._random_range(count, 1)))
        if n <= 0:
            return 0
        texture_id = 0 if texture is None else self._engine.sprites.texture_id(texture)
        # one rng.draw for every range field, in the per-particle order of
        # the reference's scalar loop: x, y, z, velocity pair, tint, vz,
        # lifespan, scale, alpha (plain scalars consume no draws)
        polar = angle_xy is not None and speed is not None
        order = [("x", x, 0.0), ("y", y, 0.0), ("z", z, 0.0)]
        order += ([("angle_xy", angle_xy, 0.0), ("speed", speed, 0.0)]
                  if polar else [("vx", vx, 0.0), ("vy", vy, 0.0)])
        order += [("tint", tint, None), ("vz", vz, 0.0), ("lifespan", lifespan, 1000.0),
                  ("scale", scale, 1.0), ("alpha", alpha, 1.0)]
        self._pending.append(self._draw_cols(
            n, order, polar, gravity, texture_id, fade_on_the_floor, stay_on_the_floor))
        return n

    def emit_batch(
        self,
        x,
        y,
        count=1,
        z=0.0,
        angle_xy=None,
        speed=None,
        vx=0.0,
        vy=0.0,
        vz=0.0,
        lifespan=1000.0,
        gravity=0.15,
        texture: str = None,
        tint=None,
        scale=1.0,
        alpha=1.0,
        fade_on_the_floor=0.0,
        stay_on_the_floor: bool = False,
    ) -> int:
        """Multi-burst emit: one burst at each ``(x[b], y[b])`` with a shared
        field config, the vectorized host form of B scalar :meth:`emit`
        calls (what a per-pair collision hook like predator.js:94-125 does).
        ``count`` (a scalar or a range, drawn per burst) sets each burst's
        size. Range fields draw one rng call across all bursts' particles
        (burst-major per field), as the reference's does."""
        if self._engine.config.particle.max_particles <= 0:
            return 0
        xb = np.asarray(x, np.float32).ravel()
        yb = np.asarray(y, np.float32).ravel()
        b = int(xb.size)
        if b == 0:
            return 0
        cr = _as_range(count)
        if cr is None:
            counts = np.full((b,), max(0, int(round(float(count)))), np.int64)
        else:
            t = np.asarray(self._engine.rng.draw(b))
            counts = np.maximum(0, np.round(cr[0] + t * (cr[1] - cr[0])).astype(np.int64))
        n = int(counts.sum())
        if n <= 0:
            return 0
        texture_id = 0 if texture is None else self._engine.sprites.texture_id(texture)
        polar = angle_xy is not None and speed is not None
        order = [("z", z, 0.0)]
        order += ([("angle_xy", angle_xy, 0.0), ("speed", speed, 0.0)]
                  if polar else [("vx", vx, 0.0), ("vy", vy, 0.0)])
        order += [("tint", tint, None), ("vz", vz, 0.0), ("lifespan", lifespan, 1000.0),
                  ("scale", scale, 1.0), ("alpha", alpha, 1.0)]
        cols = self._draw_cols(n, order, polar, gravity, texture_id, fade_on_the_floor,
                               stay_on_the_floor)
        cols["x"] = np.repeat(xb, counts)
        cols["y"] = np.repeat(yb, counts)
        self._pending.append(cols)
        return n

    def _draw_cols(self, n, order, polar, gravity, texture_id, fade_on_the_floor,
                   stay_on_the_floor) -> Dict[str, np.ndarray]:
        """Resolve each (key, value, default) of ``order`` to an [n] column,
        drawing the ranges from the seeded stream in field order, one draw
        for all of them (emitter.py:185-243)."""
        ranges = [(key, _as_range(val)) for key, val, _d in order
                  if val is not None and _as_range(val) is not None]
        if ranges:
            draws = self._engine.rng.draw(n * len(ranges)).reshape(n, len(ranges))
        cols: Dict[str, np.ndarray] = {}
        ci = 0
        for key, val, default in order:
            rng_pair = _as_range(val) if val is not None else None
            if rng_pair is None:
                if key == "tint":
                    cols[key] = np.full((n,), 0xFFFFFF if val is None else int(val), np.uint32)
                else:
                    cols[key] = np.full((n,), float(default if val is None else val), np.float32)
                continue
            t = draws[:, ci]
            ci += 1
            lo, hi = rng_pair
            if key == "tint":
                # randomColor (utils.js:65-93): per-channel lerp by one t
                ilo, ihi = int(lo), int(hi)
                out = np.zeros((n,), np.uint32)
                for shift in (16, 8, 0):
                    a = (ilo >> shift) & 0xFF
                    c = (ihi >> shift) & 0xFF
                    out |= np.round(a + t * (c - a)).astype(np.uint32) << shift
                cols[key] = out
            else:
                cols[key] = (lo + t * (hi - lo)).astype(np.float32)
        if polar:
            ang = np.radians(cols.pop("angle_xy"))
            spd = cols.pop("speed")
            cols["vx"] = (spd * np.cos(ang)).astype(np.float32)
            cols["vy"] = (spd * np.sin(ang)).astype(np.float32)
        cols["gravity"] = np.full((n,), float(gravity if gravity is not None else 0.15),
                                  np.float32)
        cols["texture_id"] = np.full((n,), texture_id, np.int32)
        cols["fade_on_the_floor"] = np.full((n,), float(fade_on_the_floor or 0.0), np.float32)
        cols["stay_on_the_floor"] = np.full((n,), bool(stay_on_the_floor))
        return cols

    def clear(self) -> None:
        """Drop queued emissions (``Engine.destroy``)."""
        self._pending.clear()

    def build_batch(self):
        """Drain the queue into one batch of numpy columns padded to a
        bucket size, and its real row count: (batch, n), or (None, 0) when
        nothing is queued. Rows past the largest bucket are dropped, as the
        reference drops them."""
        if not self._pending:
            return None, 0
        n = sum(int(c["x"].shape[0]) for c in self._pending)
        bucket = next((b for b in self.BUCKETS if b >= n), self.BUCKETS[-1])
        n = min(n, bucket)
        batch: Dict[str, np.ndarray] = {}
        for k, dt in BATCH_KEYS:
            arr = np.zeros((bucket,), dt)
            arr[:n] = np.concatenate([c[k] for c in self._pending])[:n]
            batch[k] = arr
        self._pending.clear()
        return batch, n


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """An emission batch's numpy columns as tensors on ``device``, the
    uint32 tint as int64."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v).to(device)
            for k, v in batch.items()}
