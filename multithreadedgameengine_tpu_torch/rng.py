"""Seeded RNG with bit-exact parity to the reference.

The reference threads one mulberry32-style generator through every worker
(src/core/utils.js:333-342 ``seededRandom``; installed as the global ``rng()``
by AbstractWorker.js:287-292). Host-side spawn logic here consumes the same
stream in the same call order, which is what makes spawn-time randomness (ball
radii, boid positions) trajectory-matchable.

Device-side randomness uses ``jax.random`` via ``World.key`` instead — the
only in-step consumer in the reference is the exact-overlap jitter, which the
physics op replaces with a pair-consistent hash (ops/physics.py).
"""

from __future__ import annotations

import numpy as np


class Mulberry32:
    """Bit-exact port of utils.js:333-342.

    JS semantics reproduced with uint32/int32 wrap-around:
        t += 0x6D2B79F5
        r = imul(t ^ (t >>> 15), 1 | t)
        r = (r + imul(r ^ (r >>> 7), 61 | r)) ^ r
        return ((r ^ (r >>> 14)) >>> 0) / 4294967296
    """

    def __init__(self, seed: float | int):
        # JS keeps `t` as a float64 accumulator but every bit-op applies
        # ToUint32(t) = trunc(t) mod 2^32 — equivalent to uint32 wraparound
        # for the integer seeds all reference demos use (e.g. 123456).
        self._t = np.uint32(int(seed) & 0xFFFFFFFF)

    @staticmethod
    def _imul(a: np.uint32, b: np.uint32) -> np.uint32:
        return np.uint32((int(a) * int(b)) & 0xFFFFFFFF)

    def __call__(self) -> float:
        with np.errstate(over="ignore"):
            self._t = np.uint32((int(self._t) + 0x6D2B79F5) & 0xFFFFFFFF)
            t = self._t
            r = self._imul(t ^ (t >> np.uint32(15)), np.uint32(1) | t)
            r = np.uint32(
                (int(r) + int(self._imul(r ^ (r >> np.uint32(7)), np.uint32(61) | r)))
                & 0xFFFFFFFF
            ) ^ r
            out = (r ^ (r >> np.uint32(14)))
        return float(out) / 4294967296.0

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + (hi - lo) * self()

    def draw(self, n: int) -> np.ndarray:
        """The next ``n`` draws as a float64 array, bit-exact to ``n`` calls.

        mulberry32's state update is a pure counter (t += 0x6D2B79F5), so the
        whole stream vectorizes: draw k = hash(t0 + k·GOLDEN mod 2^32). This
        is what makes 1M-entity scene construction O(ms) of numpy instead of
        minutes of per-call Python (used by the spawn_batch fast paths)."""
        with np.errstate(over="ignore"):
            ks = np.arange(1, n + 1, dtype=np.uint32)
            t = self._t + ks * np.uint32(0x6D2B79F5)  # wrapping uint32
            r = ((t ^ (t >> np.uint32(15))) * (np.uint32(1) | t)).astype(np.uint32)
            r = (r + ((r ^ (r >> np.uint32(7))) * (np.uint32(61) | r)).astype(np.uint32)) ^ r
            out = r ^ (r >> np.uint32(14))
            self._t = t[-1] if n else self._t
        return out.astype(np.float64) / 4294967296.0

    def random_range(self, value, default=0.0) -> float:
        """utils.js:49-56 ``randomRange``: number passes through; {min,max}
        dict draws uniformly. (The reference draws from Math.random() there;
        we intentionally use the seeded stream so runs are reproducible —
        documented deviation in favor of determinism.)"""
        if value is None:
            return float(default)
        if isinstance(value, (int, float)):
            return float(value)
        lo = float(value.get("min", default))
        hi = float(value.get("max", default))
        return lo + self() * (hi - lo)
