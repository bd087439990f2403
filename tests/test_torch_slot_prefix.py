"""The invariant the tiled pair passes K2 and K3 rely on: in every cell of
the solver's layouts, the occupied slots form a prefix (slots 0..n-1), so a
kernel may stop a cell's scan at its first empty slot. Checked on the halo
step's slab grids after binning and the border fill (K3's input, where an
occupied slot may hold a non-collider), and on the resident layout after a
rebin that follows a despawn (K2's input). CPU only; no JAX engine."""

import numpy as np
import torch

from multithreadedgameengine_tpu_torch.models.balls import balls_config, make_balls_engine
from multithreadedgameengine_tpu_torch.parallel import halo, make_halo_step, make_mesh

torch.set_num_threads(2)


def assert_prefix(occ: torch.Tensor, slot_dim: int) -> None:
    """``occ``: bool occupancy with the slots on ``slot_dim``; every
    occupied slot above 0 has an occupied slot below it."""
    occ = occ.movedim(slot_dim, -1)
    assert not bool((occ[..., 1:] & ~occ[..., :-1]).any()), "a cell has a hole in its slots"


def test_halo_slab_grids_fill_slots_in_order():
    """4 slabs of a 255-ball pile, one ball's collider switched off: after
    each slab's binning and the border fill, every cell's occupied slots
    (gid != -1) form a prefix, border rows included, and the ball without a
    collider sits in an occupied slot with flags lacking bit 1. K3's count
    (slots before the first gid -1) is then the cell's occupancy."""
    eng = make_balls_engine(device="cpu", n_balls=255, seed=99, world_width=1600.0,
                            world_height=1000.0, spatial=dict(cell_size=50.0, max_neighbors=32))
    eng._flush_pending()
    off = 37
    c = eng.world.collider
    active = c.active.clone()
    active[off] = False
    eng.world = eng.world.replace(collider=c.replace(active=active))
    mesh = make_mesh(4, "cpu")
    step, place = make_halo_step(eng, mesh, oversub=4.0)
    chunks = place(eng.world)
    for _ in range(3):
        chunks, _m = step(chunks, eng.input.snapshot("cpu"))

    plan = step.plan
    sent = [halo.slab_solver_rows(ch, plan, d) for d, ch in enumerate(chunks)]
    recv, _slot, _ovf = halo.route_out(mesh, *zip(*sent), plan.route_cap)
    grids = [halo.slab_grid(r, plan, d)[0] for d, r in enumerate(recv)]
    halo._fill_border(mesh, grids, plan.slab_geom.rows)

    seen_off = 0
    border_occupied = 0
    for g in grids:
        gid = g[..., 6]
        flags = g[..., 5].to(torch.int32)
        # a zero-filled border row (the world's top or bottom) reads gid 0:
        # occupied to the count, collider to none of it
        occ = gid != -1
        assert_prefix(occ, 2)
        assert not bool(((flags & 1) == 1)[~occ].any())
        border_occupied += int(occ[0].sum() + occ[-1].sum())
        hit = gid == off  # in one slab's interior, and maybe a neighbour's border row
        seen_off += int(hit[1:-1].sum())
        assert bool(((flags[hit] & 1) == 0).all())
    assert seen_off == 1
    assert border_occupied > 0


def test_resident_layout_fills_slots_in_order_after_despawn():
    """The resident path's layout (``build_layout``, cached across a rebin
    interval of 4) after a despawn and the next rebin: the occupied slots of
    every cell form a prefix, meta is 0 on an occupied slot only for entity
    0 on plane 0, and no slot at or past K2's count (the first slot above
    plane 0 with meta 0) holds an entity."""
    physics = dict(balls_config().physics.__dict__, rebin_interval=4)
    eng = make_balls_engine(n_balls=300, seed=4, device="cpu", world_width=600.0,
                            world_height=400.0, physics=physics)
    eng.step(2)
    gone = 41
    eng.despawn(gone)
    eng.step(4)
    w = eng.world
    assert eng._plan.residency and w.solver_bin_step >= 2  # rebinned after the despawn
    meta, flat, in_grid = w.solver_meta, w.solver_flat, w.solver_in_grid
    assert not bool(in_grid[gone])
    assert int(in_grid.sum()) > 250

    cap, rows, cols = meta.shape
    occ = torch.zeros(cap * rows * cols, dtype=torch.bool)
    occ[flat[in_grid]] = True
    occ = occ.view(cap, rows, cols)
    assert_prefix(occ, 0)
    owner = torch.full((cap * rows * cols,), -1, dtype=torch.int64)
    owner[flat[in_grid]] = torch.nonzero(in_grid).flatten()
    owner = owner.view(cap, rows, cols)
    zero_meta = occ & (meta == 0)
    assert bool((owner[zero_meta] == 0).all())
    assert not bool(zero_meta[1:].any())

    # K2's count: 0 when planes 0 and 1 are empty, else the first plane
    # above 0 whose meta is 0
    m = meta.numpy() != 0
    n = np.where(m[0] | m[1], cap, 0)
    for j in range(cap - 1, 0, -1):
        n = np.where((n > 0) & ~m[j], j, n)
    plane = np.arange(cap)[:, None, None]
    assert not bool((m & (plane >= n[None])).any())
