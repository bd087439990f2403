"""Particle pool physics and emission.

PyTorch counterpart of ``multithreadedgameengine_tpu/ops/particles.py``: the
particle worker's compute core (particle_worker.js:413-538) and the
ParticleEmitter claim loop (ParticleEmitter.js:78-173), over the ``[P]``
pool. Plain torch ops on whichever device the pool is on.

Pool semantics, as in the reference:
 - lifetime in ms, the expiry check before movement (:447-452);
 - z: negative is up; gravity integrates vz for every live particle (:455);
   in the air (z < 0) the position integrates, on the floor z clamps to 0
   and motion stops (:457-473);
 - stayOnTheFloor particles despawn on landing and are handed to the decal
   pass (:475-481): the first :data:`N_STAMPS` in pool order, by a stable
   sort on an integer key;
 - fadeOnTheFloor: alpha ramps down over the configured ms, despawn at 0
   (:484-497);
 - emission claims the first free slots in pool order (ParticleEmitter.js:117),
   ranked by a ``cumsum``; requests past the free count drop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..components import Particles, Struct
from ..config import EngineConfig

#: landed stayOnTheFloor particles handed to the decal pass a frame
#: (particles.py:95-97)
N_STAMPS = 64


@dataclasses.dataclass
class StampBatch(Struct):
    """The first :data:`N_STAMPS` particles that landed with stayOnTheFloor
    this frame, in pool order, then the first others as invalid rows (the
    particlesToStamp list analog, particle_worker.js:518-538)."""

    x: torch.Tensor  # f32[S]
    y: torch.Tensor
    tint: torch.Tensor  # int64 holding a uint32
    scale: torch.Tensor
    texture_id: torch.Tensor  # int32[S]
    alpha: torch.Tensor
    valid: torch.Tensor  # bool[S]


def _f32(v: float) -> float:
    """A Python constant rounded to float32, as the reference's
    ``jnp.float32(...)`` constants are."""
    return float(np.float32(v))


def first_k_where(mask: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """The indices of the first ``k`` True entries of ``mask`` along ``dim``
    in order, then the False ones in order: ``jnp.argsort(~mask,
    stable=True)[:k]``, sorted on an int8 key (torch sorts bool keys, but
    the key is integer state that must match exactly, so it is spelled
    out). ``k`` is cut to the length of ``dim``."""
    key = (~mask).to(torch.int8)
    order = torch.sort(key, dim=dim, stable=True).indices
    return order.narrow(dim, 0, min(k, mask.shape[dim]))


def update_particles(
    p: Particles, cfg: EngineConfig, dt_ratio: float, collect_stamps: bool
) -> Tuple[Particles, StampBatch, torch.Tensor]:
    """One particle-physics frame (particles.py:45-113). Returns (pool,
    stamps, active count); ``stamps`` is None unless ``collect_stamps``
    (the reference returns an empty batch)."""
    dt_ms = _f32(dt_ratio * (1000.0 / 60.0))
    dt = _f32(dt_ratio)

    live = p.active
    new_life = p.current_life + dt_ms
    expired = live & (new_life >= p.lifespan)
    alive = live & ~expired

    vz = torch.where(alive, p.vz + p.gravity * dt, p.vz)
    in_air = p.z < 0
    move = alive & in_air
    x = torch.where(move, p.x + p.vx * dt, p.x)
    y = torch.where(move, p.y + p.vy * dt, p.y)
    z = torch.where(move, p.z + vz * dt, p.z)

    on_floor = alive & ~in_air
    z = torch.where(on_floor, 0.0, z)
    vx = torch.where(on_floor, 0.0, p.vx)
    vy = torch.where(on_floor, 0.0, p.vy)
    vz = torch.where(on_floor, 0.0, vz)

    # stayOnTheFloor: stamp and despawn on landing
    landed = on_floor & p.stay_on_the_floor
    alive = alive & ~landed

    # fadeOnTheFloor
    fading = on_floor & ~p.stay_on_the_floor & (p.fade_on_the_floor > 0)
    first_touch = fading & (p.time_on_floor == 0)
    initial_alpha = torch.where(first_touch, p.alpha, p.initial_alpha)
    time_on_floor = torch.where(fading, p.time_on_floor + dt_ms, p.time_on_floor)
    progress = torch.clamp(time_on_floor / torch.clamp(p.fade_on_the_floor, min=1e-6), max=1.0)
    alpha = torch.where(fading, initial_alpha * (1.0 - progress), p.alpha)
    faded_out = fading & (alpha <= 0.0)
    alive = alive & ~faded_out

    pool = p.replace(
        active=alive,
        x=x, y=y, z=z, vx=vx, vy=vy, vz=vz,
        current_life=torch.where(live, new_life, p.current_life),
        alpha=alpha,
        time_on_floor=time_on_floor,
        initial_alpha=initial_alpha,
    )
    stamps = None
    if collect_stamps:
        order = first_k_where(landed, N_STAMPS)
        stamps = StampBatch(
            x=x[order], y=y[order], tint=p.tint[order], scale=p.scale[order],
            texture_id=p.texture_id[order], alpha=p.alpha[order], valid=landed[order],
        )
    return pool, stamps, torch.sum(alive, dtype=torch.int32)


def apply_tick_emissions(
    p: Particles, requests: List[Dict[str, object]], budget: int
) -> Tuple[Particles, torch.Tensor]:
    """Claim pool slots for the ticks' ``"emit"`` requests
    (particles.py:116-146): every class's ``[count, emit_cap]`` block
    flattens, in class registration order, then entity, then slot, and the
    valid rows compact by a ``cumsum`` rank into one ``[budget]`` batch;
    requests past ``budget`` drop, as host emissions past the free count
    do. Returns (pool, spawned)."""
    if not requests:
        return p, torch.zeros((), dtype=torch.int32, device=p.x.device)
    valid = torch.cat([r["valid"].reshape(-1) for r in requests])
    rank = torch.cumsum(valid, dim=0, dtype=torch.int64) - 1
    # rows past the budget, and invalid rows, go to a spare slot cut off below
    dest = torch.where(valid & (rank < budget), rank, budget)
    batch: Dict[str, torch.Tensor] = {}
    for key in requests[0]["fields"]:
        vals = torch.cat([r["fields"][key].reshape(-1) for r in requests])
        base = vals.new_zeros((budget + 1,))
        base.index_copy_(0, dest, vals)
        batch[key] = base[:budget]
    total = torch.clamp(torch.sum(valid, dtype=torch.int32), max=budget)
    return apply_emission(p, batch, total)


#: the fields an emission batch may leave out, and what a claimed slot
#: takes then (particles.py:184-195)
_EMIT_DEFAULTS = {"current_life": 0.0, "fade_on_the_floor": 0.0, "time_on_floor": 0.0,
                  "initial_alpha": 0.0, "stay_on_the_floor": False, "is_on_screen": True}


def apply_emission(
    p: Particles, batch: Dict[str, torch.Tensor], n=None
) -> Tuple[Particles, torch.Tensor]:
    """Claim the first free pool slots, in index order, for a batch of B
    resolved particles (particles.py:149-198: ParticleEmitter.js:117-169's
    first-fit scan as a ``cumsum`` rank). Particles past the free count drop.
    ``n`` (an int or a 0-dim tensor) takes only the first n rows, so a batch
    padded to a bucket size emits its real rows. The batch's ``tint`` fills
    both ``tint`` and ``base_tint``. Returns (pool, spawned)."""
    b = batch["x"].shape[0]
    if b == 0:
        return p, torch.zeros((), dtype=torch.int32, device=p.x.device)
    limit = b if n is None else torch.clamp(torch.as_tensor(n, device=p.x.device), max=b)
    inactive = ~p.active
    rank = torch.cumsum(inactive, dim=0, dtype=torch.int64) - 1
    take = inactive & (rank < limit)
    sel = torch.clamp(rank, 0, b - 1)

    def fill(cur: torch.Tensor, key: str) -> torch.Tensor:
        src = "tint" if key == "base_tint" else key
        vals = batch.get(src)
        if vals is None:
            if src not in _EMIT_DEFAULTS:
                return cur
            # filled on the card: a host copy would make the frame wait for it
            return torch.where(take, torch.full((), _EMIT_DEFAULTS[src], dtype=cur.dtype,
                                                device=cur.device), cur)
        return torch.where(take, vals.to(cur.dtype)[sel], cur)

    p = p.replace(active=p.active | take,
                  **{f.name: fill(getattr(p, f.name), f.name)
                     for f in dataclasses.fields(p) if f.name != "active"})
    spawned = torch.clamp(torch.sum(inactive, dtype=torch.int32), max=limit)
    return p, spawned.to(torch.int32)
