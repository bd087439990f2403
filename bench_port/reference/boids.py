"""The boids scene's frame in plain PyTorch: the predators demo's flocking
(demos/predators/boid.js:137-341) over the spatial worker's fixed-degree
neighbour lists, then the physics worker's Verlet step and circle push on a
collision grid rebinned every frame.

A frame: the mouse row takes the input's position; neighbour lists (cells of
``spatial.cell_size``, ``cell_capacity`` entities a cell by ascending id,
the ``(2R+1)^2`` cells around each entity row by row, ``0 < d^2 <
visual_range^2``, the first ``max_neighbors`` in that order); each boid's
cohesion, alignment and separation, its push away from the held mouse when
the mouse is in its list, and its turn at the margins; the Verlet move; one
substep of boundary and pair push."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import physics as P

MOUSE_RANGE = 150.0  # Mouse.js:139-145


def initial_state(cfg: dict, inputs: dict, rows, n_rows: int, device, dtype) -> dict:
    """Row 0 the mouse (a radius-0 trigger that does not move); boid k at
    row ``rows[k]`` with the drawn position and velocity, ``px = x - vx``."""
    b = cfg["boid"]
    rows = torch.as_tensor(rows, dtype=torch.int64, device=device)

    def col(vals, fill, dt=dtype):
        out = torch.full((n_rows,), fill, dtype=dt, device=device)
        out[rows] = torch.as_tensor(vals, device=device).to(dt)
        return out

    f64 = {k: np.asarray(inputs[k], np.float64) for k in ("x", "y", "vx", "vy")}
    boid = col(np.ones(rows.numel(), bool), False, torch.bool)
    true = torch.ones(n_rows, dtype=torch.bool, device=device)
    zero = torch.zeros(n_rows, dtype=dtype, device=device)
    return dict(
        x=col(inputs["x"], 0.0), y=col(inputs["y"], 0.0),
        px=col((f64["x"] - f64["vx"]).astype(np.float32), 0.0),
        py=col((f64["y"] - f64["vy"]).astype(np.float32), 0.0),
        vx=col(inputs["vx"], 0.0), vy=col(inputs["vy"], 0.0), ax=zero, ay=zero.clone(),
        radius=col(np.full(rows.numel(), b["radius"]), 0.0),
        visual_range=col(np.full(rows.numel(), b["visual_range"]), MOUSE_RANGE),
        max_vel=col(np.full(rows.numel(), b["max_vel"]), 0.0),
        entity_type=boid.to(torch.int64),
        active=true, rb_active=boid, static=~true, col_active=true, trigger=~boid,
    )


def _flock(s: dict, i, cand, inp: dict, cfg: dict):
    """The boids' accelerations for rows ``i`` over their candidate ids:
    (flocking, mouse, margin) for x and for y."""
    b, sp = cfg["boid"], cfg["spatial"]
    dtype = s["x"].dtype
    x, y = s["x"], s["y"]
    js = cand.clamp(min=0)
    xi, yi = x[i][:, None], y[i][:, None]
    nx, ny = x[js], y[js]
    dx = nx - xi
    dy = ny - yi
    d2 = dx * dx + dy * dy
    vr = s["visual_range"][i][:, None]
    valid_i = (s["active"] & torch.isfinite(x) & torch.isfinite(y))[i][:, None]
    ok = (cand >= 0) & (cand != i[:, None]) & (d2 < vr * vr) & (d2 > 0) & valid_i
    live = ok & (torch.cumsum(ok, dim=1) <= sp["max_neighbors"])
    d2 = torch.where(live, d2, 0.0)
    ntype = s["entity_type"][js]

    c = {k: torch.tensor(b[k], dtype=dtype) for k in
         ("protected_range", "centering_factor", "avoid_factor", "matching_factor",
          "turn_factor", "margin")}
    not_mouse = live & (ntype != 0)
    sep = not_mouse & (d2 < c["protected_range"] * c["protected_range"]) & (d2 > 0)
    inv_d2 = torch.where(sep, 1.0 / torch.where(d2 > 0, d2, 1.0), 0.0).to(dtype)
    sep_x = torch.sum(torch.where(sep, -dx * inv_d2, 0.0), dim=1, dtype=dtype)
    sep_y = torch.sum(torch.where(sep, -dy * inv_d2, 0.0), dim=1, dtype=dtype)
    same = not_mouse & ~sep & (ntype == s["entity_type"][i][:, None])
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

    # avoidMouse (boid.js:281-316): the mouse's squared distance as listed
    slot = live & (cand == 0)
    present = torch.any(slot, dim=1)
    d2m = torch.sum(torch.where(slot, d2, 0.0), dim=1, dtype=dtype)
    engaged = inp["mouse_down"] & (inp["mouse_x"] != 0) & present & (d2m > 0)
    safe = torch.where(d2m > 0, d2m, 1.0).to(dtype)
    strength = b["mouse_strength"]
    mx = torch.where(engaged, -((x[0] - xs) / safe) * strength, 0.0).to(dtype)
    my = torch.where(engaged, -((y[0] - ys) / safe) * strength, 0.0).to(dtype)

    # keepWithinBounds (boid.js:322-341)
    turn, margin = c["turn_factor"], c["margin"]
    bx = (torch.where(xs < margin, turn, 0.0) - torch.where(xs > cfg["world_width"] - margin, turn, 0.0)).to(dtype)
    by = (torch.where(ys < margin, turn, 0.0) - torch.where(ys > cfg["world_height"] - margin, turn, 0.0)).to(dtype)
    return (fx, mx, bx), (fy, my, by)


def run(cfg: dict, s: dict, inputs, step0: int) -> dict:
    """``len(inputs)`` frames from state ``s`` at frame number ``step0``."""
    sp, ph, b = cfg["spatial"], cfg["physics"], cfg["boid"]
    W, H = cfg["world_width"], cfg["world_height"]
    nb_grid = P.Grid(sp["cell_size"], max(1, math.ceil(H / sp["cell_size"])),
                     max(1, math.ceil(W / sp["cell_size"])), sp["cell_capacity"])
    reach = max(1, math.ceil(b["visual_range"] / sp["cell_size"]))
    solver = P.solver_grid(W, H, b["radius"], b["radius"])
    symmetric = P.symmetric_pass(ph, solver)
    for f, inp in enumerate(inputs):
        s = dict(s)
        row0 = torch.arange(s["x"].numel(), device=s["x"].device) == 0
        s["x"] = torch.where(row0, torch.tensor(inp["mouse_x"], dtype=s["x"].dtype), s["x"])
        s["y"] = torch.where(row0, torch.tensor(inp["mouse_y"], dtype=s["y"].dtype), s["y"])
        valid = s["active"] & torch.isfinite(s["x"]) & torch.isfinite(s["y"])
        cid, rank, in_table = P.bin_cells(s["x"], s["y"], valid, nb_grid)
        table = P.cell_table(cid, rank, in_table, nb_grid)
        boids = torch.nonzero(s["rb_active"] & s["active"]).flatten()
        ax, ay = s["ax"].clone(), s["ay"].clone()
        for lo in range(0, boids.numel(), P.BLOCK_ROWS // 8):
            i = boids[lo:lo + P.BLOCK_ROWS // 8]
            fx, fy = _flock(s, i, P.candidates(table, cid, i, nb_grid, reach), inp, cfg)
            ax[i] = s["ax"][i] + fx[0] + fx[1] + fx[2]
            ay[i] = s["ay"][i] + fy[0] + fy[1] + fy[2]
        s["ax"], s["ay"] = ax, ay
        s = P.verlet(s, ph["gravity"], ph["verlet_damping"])
        s = P.constraints(s, P.solver_bins(s, solver), W, H, ph["sub_step_count"],
                          ph["collision_response_strength"], ph["boundary_elasticity"],
                          salt=step0 + f, symmetric=symmetric)
    return s
