"""The invariant the tiled pair passes K1, K2 and K3 rely on: in every cell
of the solver's layouts, the occupied slots form a prefix (slots 0..n-1),
so a kernel may stop a cell's scan at its first empty slot. Checked on the
halo step's slab grids after binning and the border fill (K3's input, where
an occupied slot may hold a non-collider), on the resident layout after a
rebin that follows a despawn (K2's input, and K1's where the gate picks
it), and on a fresh binning after a despawn with a collider switched off
(K1's input on the demo path, ``rebin_interval`` 1). CPU only; no JAX
engine."""

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
    halo.fill_border(mesh, grids, [plan.slab_geom.rows] * mesh.n_slabs)

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


def assert_k2_count_covers(meta: torch.Tensor) -> None:
    """No slot at or past the count of K1 and K2 (0 when planes 0 and 1 are
    empty, else the first plane above 0 whose meta is 0) holds an entity."""
    cap = meta.shape[0]
    m = meta.numpy() != 0
    n = np.where(m[0] | m[1], cap, 0) if cap > 1 else np.where(m[0], cap, 0)
    for j in range(cap - 1, 0, -1):
        n = np.where((n > 0) & ~m[j], j, n)
    plane = np.arange(cap)[:, None, None]
    assert not bool((m & (plane >= n[None])).any())


def slot_owners(flat, in_grid, shape):
    """Occupancy and owning entity (-1 for none) of every slot."""
    total = shape[0] * shape[1] * shape[2]
    occ = torch.zeros(total, dtype=torch.bool)
    occ[flat[in_grid]] = True
    owner = torch.full((total,), -1, dtype=torch.int64)
    owner[flat[in_grid]] = torch.nonzero(in_grid).flatten()
    return occ.view(shape), owner.view(shape)


def test_fresh_layout_fills_slots_in_order_after_despawn():
    """K1's input on the demo path (``rebin_interval`` 1: ``build_layout``
    every frame) after a despawn and with one ball's collider switched off:
    the occupied slots of every cell form a prefix, the ball without a
    collider holds an occupied slot whose meta is not 0 (so it counts as an
    occupant, and the slots after it are scanned), and no entity sits at or
    past K1's count."""
    from multithreadedgameengine_tpu_torch.ops.physics_grid import build_layout

    eng = make_balls_engine(n_balls=300, seed=5, device="cpu", world_width=600.0,
                            world_height=400.0)
    assert balls_config().physics.rebin_interval == 1
    eng.step(2)
    gone, off = 41, 77
    eng.despawn(gone)
    eng.step(2)
    w = eng.world
    c = w.collider
    active = c.active.clone()
    active[off] = False
    w = w.replace(collider=c.replace(active=active))
    assert not eng._plan.residency and not eng._plan.symmetric  # K1's path
    lay = build_layout(w, eng._plan.solver_geom)
    assert not bool(lay.in_grid[gone]) and bool(lay.in_grid[off])
    assert int(lay.in_grid.sum()) > 250

    occ, owner = slot_owners(lay.flat, lay.in_grid, lay.meta.shape)
    assert_prefix(occ, 0)
    assert bool(((lay.meta != 0) == occ).all())  # no entity 0 in the grid here
    m_off = int(lay.meta.view(-1)[lay.flat[off]])
    assert m_off != 0 and (m_off >> 24) & 1 == 0
    assert int(owner.view(-1)[lay.flat[off]]) == off
    assert_k2_count_covers(lay.meta)


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

    occ, owner = slot_owners(flat, in_grid, meta.shape)
    assert_prefix(occ, 0)
    zero_meta = occ & (meta == 0)
    assert bool((owner[zero_meta] == 0).all())
    assert not bool(zero_meta[1:].any())
    assert_k2_count_covers(meta)
