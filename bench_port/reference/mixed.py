"""The mixed ecosystem's frame in plain PyTorch: BASELINE config 5, the
predators demo (demos/predators/index.html:304-380) at 1M prey. Prey flock
(boid.js:137-341) and flee predators (prey.js:154-169); predators hunt the
closest prey (predator.js:172-186); lights stand still; then the physics
worker's Verlet step and circle push, as ``reference/boids.py`` and
``reference/physics.py`` write them.

A frame: the mouse row takes the input's position; each class's neighbour
lists at its own scan radius (``ceil(its largest visual range / cell)``
cells, at most the largest class's: cells of ``spatial.cell_size``,
``cell_capacity`` entities a cell by ascending id, ``0 < d^2 <
visual_range^2``, the first ``max_neighbors`` in scan order); the prey's
cohesion, alignment, separation, flee, mouse push and margin turn; the
predators' (zero) flocking, hunt, mouse push and margin turn; the Verlet
move with the ``max_vel`` clamp; one substep of boundary and pair push with
each entity's radius, the lights static.

Departures: the collision events, the particles and decals they emit,
the lights' shadows and the animation state machine move no entity and
are left out; the benchmark's guards hold the event log (no row dropped),
and :func:`contacts` gives the predator-prey contacts that the log and the
predators' hooks should carry, for the tests to hold them to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import physics as P

#: entity types by registration order (gameEngine.js:292-366): the mouse
#: first (:278-281), then Boid, the base class that Prey registers before
#: itself, with no entity, then the scene's Prey, Predator and TallLight
MOUSE, PREY, PREDATOR, LIGHT = 0, 2, 3, 4
#: the input kinds of ``scenes/mixed.draw``, each class's entity type
KIND_TYPE = (PREY, PREDATOR, LIGHT)
MOUSE_RANGE = 150.0  # Mouse.js:139-145
#: rows of a ``[rows, candidates]`` block of a class's lists
BLOCK = P.BLOCK_ROWS // 4


def counts(cfg: dict) -> tuple:
    """(prey, predators, lights): predators ``max(8, prey // 2000)``, the
    rung's rule (benchmarks/run_ladder.py:289-367)."""
    n = cfg["n_boids"]
    return n, max(8, n // 2000), cfg["n_lights"]


def mulberry32(seed: int, n: int) -> np.ndarray:
    """The first ``n`` draws of the seeded stream (utils.js:333-342
    ``seededRandom``) as float64: the state is a counter that steps by
    0x6D2B79F5, each draw a hash of it."""
    with np.errstate(over="ignore"):
        k = np.arange(1, n + 1, dtype=np.uint32)
        t = np.uint32(seed & 0xFFFFFFFF) + k * np.uint32(0x6D2B79F5)
        r = ((t ^ (t >> np.uint32(15))) * (np.uint32(1) | t)).astype(np.uint32)
        r = (r + ((r ^ (r >> np.uint32(7))) * (np.uint32(61) | r)).astype(np.uint32)) ^ r
        return (r ^ (r >> np.uint32(14))).astype(np.float64) / 4294967296.0


def prey_draws(cfg: dict, seed: int) -> tuple:
    """Each prey slot's max_vel and visual_range in slot order (prey.js:25-61:
    three draws an instance, max_vel, max_acc and visualRange, from the
    engine's stream, which the prey consume first), float32."""
    b, n = cfg["boid"], cfg["n_boids"]
    d = mulberry32(seed, 3 * n).reshape(n, 3)

    def span(lohi, col):
        lo, hi = lohi
        return (lo + d[:, col] * (hi - lo)).astype(np.float32)

    return span(b["max_vel"], 0), span(b["visual_range"], 2)


def initial_state(cfg: dict, inputs: dict, rows, n_rows: int, device, dtype) -> dict:
    """Row 0 the mouse (a radius-0 trigger that does not move); input k at
    row ``rows[k]`` with the drawn position, at rest (``px = x``); the prey
    slots' draws from ``inputs["engine_seed"]``; the lights static."""
    b, p, lt = cfg["boid"], cfg["predator"], cfg["light"]
    rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
    kind = np.asarray(inputs["kind"])
    n_prey = counts(cfg)[0]
    max_vel, vrange = prey_draws(cfg, int(inputs["engine_seed"]))
    slot = np.asarray(rows.cpu()) - 1  # the prey pool's slots start after the mouse
    prey = kind == 0
    if prey.any() and (slot[prey].min() < 0 or slot[prey].max() >= n_prey):
        raise ValueError("prey rows outside the prey pool")

    def col(per_kind, fill, dt=dtype, prey_vals=None):
        vals = np.asarray([per_kind[k] for k in range(3)], np.float64)[kind]
        if prey_vals is not None:
            vals = np.where(prey, prey_vals[np.clip(slot, 0, n_prey - 1)], vals)
        out = torch.full((n_rows,), fill, dtype=dt, device=device)
        out[rows] = torch.as_tensor(vals.astype(np.float32), device=device).to(dt)
        return out

    def put(vals, fill, dt=dtype):
        out = torch.full((n_rows,), fill, dtype=dt, device=device)
        out[rows] = torch.as_tensor(vals, device=device).to(dt)
        return out

    x = np.asarray(inputs["x"], np.float32)
    y = np.asarray(inputs["y"], np.float32)
    etype = torch.zeros(n_rows, dtype=torch.int64, device=device)
    etype[rows] = torch.as_tensor(np.asarray(KIND_TYPE)[kind], device=device)
    spawned = torch.zeros(n_rows, dtype=torch.bool, device=device)
    spawned[rows] = True
    static = put(kind == 2, False, torch.bool)
    true = torch.ones(n_rows, dtype=torch.bool, device=device)
    zero = torch.zeros(n_rows, dtype=dtype, device=device)
    return dict(
        x=put(x, 0.0), y=put(y, 0.0), px=put(x, 0.0), py=put(y, 0.0),
        vx=zero, vy=zero.clone(), ax=zero.clone(), ay=zero.clone(),
        radius=col((b["radius"], p["radius"], lt["radius"]), 0.0),
        visual_range=col((0.0, p["visual_range"], lt["visual_range"]), MOUSE_RANGE,
                         prey_vals=vrange),
        max_vel=col((0.0, p["max_vel"], 0.0), 0.0, prey_vals=max_vel),
        entity_type=etype,
        active=true, rb_active=spawned, static=static, col_active=true, trigger=~spawned,
    )


def _accept(s: dict, i, cand, cfg: dict, widen: float = 0.0):
    """Rows ``i``'s lists over their candidate ids: (dx, dy, d2, live),
    ``live`` the slots with ``0 < d^2 < (visual_range + widen)^2``, the
    first ``max_neighbors`` in scan order."""
    x, y = s["x"], s["y"]
    js = cand.clamp(min=0)
    dx = x[js] - x[i][:, None]
    dy = y[js] - y[i][:, None]
    d2 = dx * dx + dy * dy
    vr = s["visual_range"][i][:, None] + widen
    valid_i = (s["active"] & torch.isfinite(x) & torch.isfinite(y))[i][:, None]
    ok = (cand >= 0) & (cand != i[:, None]) & (d2 < vr * vr) & (d2 > 0) & valid_i
    return dx, dy, d2, ok & (torch.cumsum(ok, dim=1) <= cfg["spatial"]["max_neighbors"])


def _forces(s: dict, i, cand, inp: dict, cfg: dict, etype: int):
    """The accelerations of class ``etype``'s rows ``i`` over their
    candidate ids: Prey.tick or Predator.tick (models/predators.py of the
    port, copied), (x, y)."""
    grp = cfg["boid"] if etype == PREY else cfg["predator"]
    dtype = s["x"].dtype
    x, y = s["x"], s["y"]
    js = cand.clamp(min=0)
    nx, ny = x[js], y[js]
    dx, dy, d2, live = _accept(s, i, cand, cfg)
    d2 = torch.where(live, d2, 0.0)
    ntype = s["entity_type"][js]

    c = {k: torch.tensor(grp[k], dtype=dtype) for k in
         ("protected_range", "centering_factor", "avoid_factor", "matching_factor",
          "turn_factor", "margin")}
    not_mouse = live & (ntype != MOUSE)
    sep = not_mouse & (d2 < c["protected_range"] * c["protected_range"]) & (d2 > 0)
    inv_d2 = torch.where(sep, 1.0 / torch.where(d2 > 0, d2, 1.0), 0.0).to(dtype)
    sep_x = torch.sum(torch.where(sep, -dx * inv_d2, 0.0), dim=1, dtype=dtype)
    sep_y = torch.sum(torch.where(sep, -dy * inv_d2, 0.0), dim=1, dtype=dtype)
    rest = not_mouse & ~sep  # what processNeighbor sees (boid.js:192-196)
    same = rest & (ntype == etype)
    same_n = torch.sum(same, dim=1)
    cx = torch.sum(torch.where(same, nx, 0.0), dim=1, dtype=dtype)
    cy = torch.sum(torch.where(same, ny, 0.0), dim=1, dtype=dtype)
    avx = torch.sum(torch.where(same, s["vx"][js], 0.0), dim=1, dtype=dtype)
    avy = torch.sum(torch.where(same, s["vy"][js], 0.0), dim=1, dtype=dtype)
    has = same_n > 0
    inv_n = torch.where(has, 1.0 / torch.clamp(same_n, min=1).to(dtype), 0.0).to(dtype)
    xs, ys = x[i], y[i]
    fx = torch.where(has, (cx * inv_n - xs) * c["centering_factor"], 0.0).to(dtype)
    fy = torch.where(has, (cy * inv_n - ys) * c["centering_factor"], 0.0).to(dtype)
    fx = fx + torch.where(has, (avx * inv_n - s["vx"][i]) * c["matching_factor"], 0.0)
    fy = fy + torch.where(has, (avy * inv_n - s["vy"][i]) * c["matching_factor"], 0.0)
    fx = fx + sep_x * c["avoid_factor"]
    fy = fy + sep_y * c["avoid_factor"]

    if etype == PREY:  # the flee, 1/d^2 from each predator neighbour (prey.js:154-169)
        pred = rest & (ntype == PREDATOR) & (d2 > 0)
        inv = torch.where(pred, 1.0 / torch.where(d2 > 0, d2, 1.0), 0.0).to(dtype)
        avoid = torch.tensor(cfg["prey"]["predator_avoid_factor"], dtype=dtype)
        fx = fx + torch.sum(torch.where(pred, -dx * inv, 0.0), dim=1, dtype=dtype) * avoid
        fy = fy + torch.sum(torch.where(pred, -dy * inv, 0.0), dim=1, dtype=dtype) * avoid
    else:  # the hunt: the first slot of the smallest d^2 among prey (predator.js:172-186)
        d2m = torch.where(rest & (ntype == PREY), d2, torch.inf)
        k = torch.argmin(d2m, dim=1, keepdim=True)
        found = torch.isfinite(torch.gather(d2m, 1, k))[:, 0]
        dist = torch.sqrt(torch.where(found, torch.gather(d2, 1, k)[:, 0], 1.0).double()).to(dtype)
        hunt = torch.tensor(grp["hunt_factor"], dtype=dtype)
        safe = found & (dist > 0)
        inv = torch.where(dist > 0, dist, 1.0)
        fx = fx + torch.where(safe, (torch.gather(dx, 1, k)[:, 0] / inv) * hunt, 0.0)
        fy = fy + torch.where(safe, (torch.gather(dy, 1, k)[:, 0] / inv) * hunt, 0.0)

    # avoidMouse (boid.js:281-316): the mouse's squared distance as listed
    slot = live & (cand == 0)
    present = torch.any(slot, dim=1)
    d2m = torch.sum(torch.where(slot, d2, 0.0), dim=1, dtype=dtype)
    engaged = inp["mouse_down"] & (inp["mouse_x"] != 0) & present & (d2m > 0)
    safe = torch.where(d2m > 0, d2m, 1.0).to(dtype)
    mx = torch.where(engaged, -((x[0] - xs) / safe) * cfg["boid"]["mouse_strength"], 0.0).to(dtype)
    my = torch.where(engaged, -((y[0] - ys) / safe) * cfg["boid"]["mouse_strength"], 0.0).to(dtype)

    # keepWithinBounds (boid.js:322-341)
    turn, margin = c["turn_factor"], c["margin"]
    W, H = cfg["world_width"], cfg["world_height"]
    bx = (torch.where(xs < margin, turn, 0.0) - torch.where(xs > W - margin, turn, 0.0)).to(dtype)
    by = (torch.where(ys < margin, turn, 0.0) - torch.where(ys > H - margin, turn, 0.0)).to(dtype)
    return s["ax"][i] + fx + mx + bx, s["ay"][i] + fy + my + by


def _reach(vr_max: float, cell: float) -> int:
    return max(1, math.ceil(vr_max / cell)) if vr_max > 0 else 1


def _nb_grid(cfg: dict) -> P.Grid:
    """The neighbour lists' grid: cells of ``spatial.cell_size`` over the
    world, ``cell_capacity`` entities a cell."""
    sp, cell = cfg["spatial"], cfg["spatial"]["cell_size"]
    return P.Grid(cell, max(1, math.ceil(cfg["world_height"] / cell)),
                  max(1, math.ceil(cfg["world_width"] / cell)), sp["cell_capacity"])


def _classes(s: dict, cfg: dict) -> list:
    """(entity type, rows, scan radius in cells) of the prey and the
    predators: ``ceil(the class's largest visual range / cell)``, at most
    the largest over every class."""
    vr, cell = s["visual_range"].float(), cfg["spatial"]["cell_size"]
    top = _reach(float(vr[1:].max()), cell)
    out = []
    for etype in (PREY, PREDATOR):
        rows = torch.nonzero(s["entity_type"] == etype).flatten()
        if rows.numel():
            out.append((etype, rows, min(_reach(float(vr[rows].max()), cell), top)))
    return out


def contacts(cfg: dict, s: dict, margin: float = 0.0) -> set:
    """The predator-prey contacts that the frame starting from state ``s``
    records for the predators' collision hooks: the prey in each active
    predator's list (as the frame builds it, before the move) at a distance
    under the sum of their radii plus ``margin``. A positive ``margin`` also
    narrows the lists' range by as much (a contact then sits higher in its
    capped list), so the set grows with ``margin``. A set of (predator row,
    prey row)."""
    grid = _nb_grid(cfg)
    valid = s["active"] & torch.isfinite(s["x"]) & torch.isfinite(s["y"])
    cid, rank, in_table = P.bin_cells(s["x"], s["y"], valid, grid)
    table = P.cell_table(cid, rank, in_table, grid)
    (rows, reach), = [(r, k) for etype, r, k in _classes(s, cfg) if etype == PREDATOR]
    rows = rows[s["active"][rows] & s["col_active"][rows]]
    cand = P.candidates(table, cid, rows, grid, reach)
    _dx, _dy, d2, live = _accept(s, rows, cand, cfg, -margin)
    js = cand.clamp(min=0)
    touch = s["radius"][rows][:, None] + s["radius"][js] + margin
    hit = live & (s["entity_type"][js] == PREY) & s["col_active"][js] & (d2 < touch * touch)
    i, k = torch.nonzero(hit, as_tuple=True)
    return set(zip(rows[i].tolist(), cand[i, k].tolist()))


def run(cfg: dict, s: dict, inputs, step0: int) -> dict:
    """``len(inputs)`` frames from state ``s`` at frame number ``step0``, in
    ``s``'s float dtype (TF32 off, though no step multiplies matrices)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ph = cfg["physics"]
    W, H = cfg["world_width"], cfg["world_height"]
    nb_grid = _nb_grid(cfg)
    classes = _classes(s, cfg)
    r = s["radius"].float()
    solver = P.solver_grid(W, H, float(r.max()), float(r[r > 0].double().mean()))
    symmetric = P.symmetric_pass(ph, solver)
    for f, inp in enumerate(inputs):
        s = dict(s)
        row0 = torch.arange(s["x"].numel(), device=s["x"].device) == 0
        s["x"] = torch.where(row0, torch.tensor(inp["mouse_x"], dtype=s["x"].dtype), s["x"])
        s["y"] = torch.where(row0, torch.tensor(inp["mouse_y"], dtype=s["y"].dtype), s["y"])
        valid = s["active"] & torch.isfinite(s["x"]) & torch.isfinite(s["y"])
        cid, rank, in_table = P.bin_cells(s["x"], s["y"], valid, nb_grid)
        table = P.cell_table(cid, rank, in_table, nb_grid)
        ax, ay = s["ax"].clone(), s["ay"].clone()
        for etype, rows, reach in classes:
            rows = rows[s["active"][rows]]
            for lo in range(0, rows.numel(), BLOCK):
                i = rows[lo:lo + BLOCK]
                ax[i], ay[i] = _forces(s, i, P.candidates(table, cid, i, nb_grid, reach),
                                       inp, cfg, etype)
        s["ax"], s["ay"] = ax, ay
        s = P.verlet(s, ph["gravity"], ph["verlet_damping"])
        s = P.constraints(s, P.solver_bins(s, solver), W, H, ph["sub_step_count"],
                          ph["collision_response_strength"], ph["boundary_elasticity"],
                          salt=step0 + f, symmetric=symmetric)
    return s
