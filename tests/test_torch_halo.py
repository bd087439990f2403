"""Slices E1 and C1: the spatial-domain halo step and K3, the PyTorch port
against the JAX package and against itself, and the step's
neighbour-reading phase A (the boids scene of ``tests/test_halo.py``).

The JAX side runs as ``tests/test_halo.py`` runs it: conftest's 8 virtual
CPU devices, ``make_mesh(D, axis_name="slab")``, and the Pallas kernel K3
(``pair_pass_pallas``) in interpret mode. The port runs on the CPU, where
K3's wrapper takes its plain version.

Tolerances, each with its reason:
- K3's plain version against the JAX kernel: contact counts exact,
  positions (grid position + displacement) within 2 float32 ulps at the
  world's extent. Both sum the same pushes in the same order; XLA:CPU
  contracts ``a*b + c`` into fused multiply-adds and its ``rsqrt`` is not
  the correctly rounded ``1/sqrt`` the port uses.
- The port's halo step against the JAX halo step with ``solver="grid"``:
  counts exact, positions within 8 ulps at the world's extent after 3
  frames. On top of the above, the XLA formulation sums each 8-slot chunk
  of pushes as a tree where K3 sums one slot at a time, and the pile carries
  the last-bit differences from frame to frame (measured: 1 ulp at the
  world's height per frame, 1.8e-4 after 3 frames).
- The port's halo step against the port's own single-device ``Engine``:
  bit-equal, with and without phase A. Binning, rank order, candidate
  order, arithmetic and summation order are the same on both paths (the
  reference's own bar for its halo step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multithreadedgameengine_tpu.config import make_config as ref_make_config
from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu.ops.pallas_kernels import pair_pass_pallas
from multithreadedgameengine_tpu.ops.physics_grid import (
    run_solver_substeps as ref_run_solver_substeps,
)
from multithreadedgameengine_tpu.ops.spatial import GridGeom as RefGridGeom
from multithreadedgameengine_tpu.parallel import make_halo_step as ref_make_halo_step
from multithreadedgameengine_tpu.parallel import make_mesh as ref_make_mesh
from multithreadedgameengine_tpu_torch import Engine, EntityClass, make_config
from multithreadedgameengine_tpu_torch.components import Collider, RigidBody, SpriteRenderer
from multithreadedgameengine_tpu_torch.interop import config_from
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import (
    pair_pass_grid,
    pair_pass_grid_plain,
)
from multithreadedgameengine_tpu_torch.ops.physics_grid import run_solver_substeps
from multithreadedgameengine_tpu_torch.parallel import make_halo_step, make_mesh, unplace_fn
from multithreadedgameengine_tpu_torch.parallel.halo import (
    _rank_within_dest,
    entity_leaf_specs,
    pack_world_rows,
    route_capacity,
    unpack_world_rows,
)

torch.set_num_threads(2)


def ulps(extent: float, k: int) -> float:
    return k * float(np.spacing(np.float32(extent)))


# ---------------------------------------------------------------------------
# K3 on hand-made grids
# ---------------------------------------------------------------------------

CELL = 20.0
R, C, CAP = 6, 9, 8


def grid_scene(seed, n=170):
    """A bordered grid [R+2, C+2, CAP] with an empty border (as the JAX
    kernel reads it) of random entities binned by id order: radii 4-10,
    ~10% statics, ~10% triggers, ~5% without a collider, one exactly
    coincident pair. Returns (x, y, attrs) as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, C * CELL, n)
    y = rng.uniform(0.0, R * CELL, n)
    x[1], y[1] = x[0], y[0]
    radius = rng.uniform(4.0, 10.0, n)
    static = rng.random(n) < 0.1
    flags = ((rng.random(n) > 0.05) * 1 + (rng.random(n) < 0.1) * 2
             + static * 4 + (~static) * 8)
    flags[:2] = 1 + 8  # the coincident pair: moving colliders
    gx = np.zeros((R + 2, C + 2, CAP), np.float32)
    gy = np.zeros_like(gx)
    attrs = np.zeros((R + 2, C + 2, CAP, 3), np.float32)
    attrs[..., 2] = -1.0
    fill = np.zeros((R + 2, C + 2), np.int64)
    for i in range(n):  # ascending id: ranks in id order
        r = int(np.floor(y[i] / CELL)) + 1
        c = int(np.floor(x[i] / CELL)) + 1
        k = fill[r, c]
        if k >= CAP:
            continue
        fill[r, c] += 1
        gx[r, c, k], gy[r, c, k] = x[i], y[i]
        attrs[r, c, k] = (radius[i], flags[i], i)
    return gx, gy, attrs


def ref_k3(gx, gy, attrs, salt, strength):
    geom = RefGridGeom(cell_size=CELL, rows=R, cols=C, capacity=CAP)
    out = pair_pass_pallas(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(attrs),
                           jnp.uint32(salt), geom, strength, interpret=True)
    return [np.asarray(o) for o in out]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k3_matches_reference_kernel(seed):
    gx, gy, attrs = grid_scene(seed)
    rdx, rdy, rc = ref_k3(gx, gy, attrs, 977, 0.8)
    dx, dy, c = pair_pass_grid_plain(t(gx), t(gy), t(attrs), 977, 0.8)
    np.testing.assert_array_equal(c.numpy(), rc)
    assert int(c.sum()) > 0
    tol = ulps(C * CELL, 2)
    np.testing.assert_allclose(gx + dx.numpy(), gx + rdx, rtol=0, atol=tol)
    np.testing.assert_allclose(gy + dy.numpy(), gy + rdy, rtol=0, atol=tol)
    # the border gets nothing; the coincident pair (ids 0, 1) was separated
    assert not dx[0].any() and not dx[-1].any() and not c[:, 0].any() and not c[:, -1].any()
    ids = attrs[..., 2]
    for gid in (0, 1):
        if (ids == gid).any():
            sel = t(ids == gid)
            assert float(dx[sel].abs().sum() + dy[sel].abs().sum()) > 0


def test_k3_wrapper_runs_plain_on_cpu_and_checks_inputs():
    gx, gy, attrs = (t(a) for a in grid_scene(2))
    before = cuda_kernels.pair_pass_grid.launches
    for u, v in zip(pair_pass_grid(gx, gy, attrs, 5, 0.8),
                    pair_pass_grid_plain(gx, gy, attrs, 5, 0.8)):
        assert torch.equal(u, v)
    assert cuda_kernels.pair_pass_grid.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="float32"):
        pair_pass_grid(gx.double(), gy, attrs, 5, 0.8)
    with pytest.raises(ValueError, match="shape"):
        pair_pass_grid(gx, gy, attrs[..., :2], 5, 0.8)
    with pytest.raises(ValueError, match="contiguous"):
        pair_pass_grid(gx.transpose(0, 1).contiguous().transpose(0, 1), gy, attrs, 5, 0.8)


def seam_grid():
    """Two overlapping balls split across the top border row: A (id 10) in
    interior row 1, B (id 3) in border row 0 above it -- the neighbour
    slab's edge row under the halo step -- plus the same across the bottom
    border (ids 20 and 21)."""
    gx = np.zeros((R + 2, C + 2, CAP), np.float32)
    gy = np.zeros_like(gx)
    attrs = np.zeros((R + 2, C + 2, CAP, 3), np.float32)
    attrs[..., 2] = -1.0
    for r, c, x, y, gid in ((1, 3, 70.0, 121.0, 10), (0, 3, 72.0, 114.0, 3),
                            (R, 5, 110.0, 219.0, 20), (R + 1, 5, 108.0, 226.0, 21)):
        gx[r, c, 0], gy[r, c, 0] = x, y
        attrs[r, c, 0] = (5.0, 1 + 8, gid)
    return gx, gy, attrs


def test_seam_contact_counted_where_the_reference_kernel_drops_it():
    """The reference fault this slice does not copy (ROADMAP §3): the JAX
    K3 cuts the border rows away and misses a contact across a slab seam;
    the JAX XLA formulation of the same solver counts it, and so does the
    port's K3."""
    gx, gy, attrs = seam_grid()
    inner = [(1, 3), (R, 5)]
    _dx, _dy, c = pair_pass_grid_plain(t(gx), t(gy), t(attrs), 1, 0.8)
    _rdx, _rdy, rc = ref_k3(gx, gy, attrs, 1, 0.8)
    for r, col in inner:
        assert int(c[r, col, 0]) == 1  # the port counts the seam contact
        assert int(rc[r, col, 0]) == 0  # the JAX kernel drops it
    # the JAX package's own XLA formulation counts it too, and the port's
    # run_solver_substeps agrees with it on both of its branches
    packed = np.concatenate([gx[..., None], gy[..., None], gx[..., None], gy[..., None],
                             attrs, np.zeros_like(gx)[..., None]], axis=-1)
    geom = RefGridGeom(cell_size=CELL, rows=R, cols=C, capacity=CAP)
    cfg = ref_make_config(world_width=1000.0, world_height=1000.0,
                          physics=dict(sub_step_count=1, solver="grid"))
    ref = [np.asarray(o) for o in ref_run_solver_substeps(
        jnp.asarray(packed), geom, cfg, jnp.uint32(1), shard_hints=False)]
    for r, col in inner:
        assert int(ref[4][r, col, 0]) == 1
    for solver in ("pallas", "grid"):
        pcfg = config_from(dataclasses.replace(
            cfg, physics=dataclasses.replace(cfg.physics, solver=solver)))
        out = run_solver_substeps(t(packed), geom, pcfg, 1)
        np.testing.assert_array_equal(out[4].numpy(), ref[4])
        for a, b in zip(out[:2], ref[:2]):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ulps(1000.0, 2))


# ---------------------------------------------------------------------------
# transport and routing pieces
# ---------------------------------------------------------------------------

def test_pack_unpack_rows_is_exact():
    eng = make_balls_engine(n_balls=31, seed=5, device="cpu")
    eng._flush_pending()
    w = eng.world
    w = w.replace(
        transform=w.transform.replace(x=torch.tensor([float("nan"), -0.0] + [1.5] * 30)),
        sprite=w.sprite.replace(tint=torch.full((32,), 0xFFFFFFFF, dtype=torch.int64)),
    )
    specs = entity_leaf_specs(w)
    rows = pack_world_rows(w, specs)
    assert rows.dtype == torch.int64 and rows.shape == (32, len(specs))
    back = unpack_world_rows(rows, eng.world, specs)
    for cname, fname, _dt in specs:
        a = getattr(getattr(w, cname), fname)
        b = getattr(getattr(back, cname), fname)
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), fname
        else:
            assert torch.equal(a, b), fname


def test_rank_within_dest_keeps_row_order():
    dest = torch.tensor([2, 0, 2, 1, 0, 2, 3, 0])
    valid = torch.tensor([True, True, False, True, True, True, True, True])
    rank = _rank_within_dest(dest, valid, 4)
    assert rank[valid].tolist() == [0, 0, 0, 1, 1, 0, 2]
    assert route_capacity(64, 4, 0.5) == 8 and route_capacity(64, 4, 4.0) == 64


def test_mesh_collectives():
    mesh = make_mesh(3, "cpu")
    blocks = [torch.arange(9).view(3, 3, 1) + 10 * s for s in range(3)]
    recv = mesh.all_to_all(blocks)
    for d in range(3):
        for s in range(3):
            assert torch.equal(recv[d][s], blocks[s][d])
    parts = [torch.full((2,), s + 1) for s in range(3)]
    assert [p.tolist() for p in mesh.shift_down(parts)] == [[0, 0], [1, 1], [2, 2]]
    assert [p.tolist() for p in mesh.shift_up(parts)] == [[2, 2], [3, 3], [0, 0]]
    assert [p.tolist() for p in mesh.ppermute(parts, [(2, 0)])] == [[3, 3], [0, 0], [0, 0]]
    total = mesh.psum([torch.tensor(3, dtype=torch.int32)] * 3)
    assert total.dtype == torch.int32 and int(total) == 9


# ---------------------------------------------------------------------------
# the halo step against the JAX halo step and against the port's Engine
# ---------------------------------------------------------------------------

PILE = dict(n_balls=255, spawn=True, seed=99, world_width=1600.0, world_height=1000.0,
            spatial=dict(cell_size=50.0, max_neighbors=32))
STATE = [("transform", "x"), ("transform", "y"), ("rigid_body", "px"),
         ("rigid_body", "py"), ("rigid_body", "vx"), ("rigid_body", "vy")]
EXACT = [("rigid_body", "collision_count"), ("transform", "active"),
         ("sprite", "is_on_screen")]


def _with_solver(cfg, solver):
    return dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, solver=solver))


def ref_pile(solver="grid", **over):
    ej = ref_balls(**{**PILE, **over})
    ej._flush_pending()
    ej.config = _with_solver(ej.config, solver)
    return ej


def port_pile(**over):
    et = make_balls_engine(device="cpu", **{**PILE, **over})
    et._flush_pending()
    return et


def compare(a, b, atol):
    """``a``: a JAX world on the host; ``b``: a port world."""
    for comp, field in EXACT:
        np.testing.assert_array_equal(getattr(getattr(b, comp), field).numpy(),
                                      np.asarray(getattr(getattr(a, comp), field)),
                                      err_msg=f"{comp}.{field}")
    for comp, field in STATE:
        np.testing.assert_allclose(getattr(getattr(b, comp), field).numpy(),
                                   np.asarray(getattr(getattr(a, comp), field)),
                                   rtol=0, atol=atol, err_msg=f"{comp}.{field}")


@pytest.mark.parametrize("n_slabs", [2, 4])
@pytest.mark.parametrize("solver", ["auto", "grid"])
def test_halo_step_matches_reference_halo_step(n_slabs, solver):
    """The port's halo step -- K3 ("auto" resolves to "pallas") or the XLA
    formulation ("grid") -- against the JAX halo step with the XLA solver
    on test_halo's gravity pile, oversub = D, for 3 frames."""
    ej = ref_pile()
    step_j, place_j = ref_make_halo_step(ej, ref_make_mesh(n_slabs, axis_name="slab"),
                                         oversub=float(n_slabs))
    et = port_pile()
    et.config = _with_solver(et.config, solver)
    mesh = make_mesh(n_slabs, "cpu")
    step_t, place_t = make_halo_step(et, mesh, oversub=float(n_slabs))
    assert step_t.plan.cfg.physics.solver == ("pallas" if solver == "auto" else "grid")
    wj, ct = place_j(ej.world), place_t(et.world)
    ins_j, ins_t = ej.input.snapshot(), et.input.snapshot("cpu")
    for frame in range(3):
        wj, mj = step_j(wj, ins_j)
        ct, mt = step_t(ct, ins_t)
        assert {k: int(v) for k, v in mt.items()} == {k: int(v) for k, v in mj.items()}
        compare(jax.device_get(wj), unplace_fn(ct, mesh), ulps(1600.0, 8))
    assert int(mt["route_overflow_solver"]) == 0 and int(mt["solver_binned"]) == 256


def test_halo_step_is_bit_equal_with_single_device_engine():
    """K3 (plain) on 4 slabs against the port's Engine.step (K1 plain) on
    the same flushed pile, 30 frames with the mouse held down: every field
    of every component bit-equal, and the same solver grid on both."""
    eh, es = port_pile(), port_pile()
    for e in (eh, es):
        e.input.set_mouse(800.0, 900.0)
        e.input.mouse_button(0, True)
    mesh = make_mesh(4, "cpu")
    step, place = make_halo_step(eh, mesh, oversub=4.0)
    chunks = place(eh.world)
    ins = eh.input.snapshot("cpu")
    for _ in range(30):
        chunks, metrics = step(chunks, ins)
    es.step(30)
    assert es._plan.solver_geom == step.plan.solver_geom
    assert not es._plan.symmetric  # the single-device path ran K1
    a, b = unplace_fn(chunks, mesh), es.snapshot()
    assert a.step_count == b.step_count == 30
    for cname, fname, _dt in entity_leaf_specs(a):
        u, v = getattr(getattr(a, cname), fname), getattr(getattr(b, cname), fname)
        assert torch.equal(u, v), f"{cname}.{fname}"
    assert int(b.rigid_body.collision_count.sum()) > 0
    assert int(metrics["route_overflow_solver"]) == 0
    # the world goes back into the engine whole
    es.restore(a)
    assert torch.equal(es.world.transform.x, a.transform.x)


class Fugitive(EntityClass):
    """Crosses x = 500 and despawns (test_halo's _Fugitive)."""

    components = [RigidBody, Collider, SpriteRenderer]
    uses_neighbors = False

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 4.0, "rigid_body.max_vel": 50.0}

    @staticmethod
    def tick(ctx):
        return {"rigid_body.ax": 1.0, "despawn": ctx.x > 500.0}


def test_tick_despawn_under_halo_matches_single_device():
    """run_logic_phase_masked's despawn and tick writes on slab chunks,
    against the port's Engine.step."""

    def build():
        eng = Engine(make_config(world_width=1000.0, world_height=800.0, seed=5,
                                 spatial=dict(cell_size=50.0, max_neighbors=8),
                                 physics=dict(sub_step_count=1)), device="cpu")
        eng.register_entity_class(Fugitive, 63)
        eng.init()
        rng = np.random.default_rng(11)
        eng.spawn_batch("Fugitive", 63,
                        x=rng.uniform(300, 520, 63).astype(np.float32),
                        y=rng.uniform(50, 750, 63).astype(np.float32))
        eng._flush_pending()
        return eng

    eh, es = build(), build()
    mesh = make_mesh(4, "cpu")
    step, place = make_halo_step(eh, mesh)
    chunks = place(eh.world)
    for _ in range(12):
        chunks, metrics = step(chunks, eh.input.snapshot("cpu"))
    es.step(12)
    a, b = unplace_fn(chunks, mesh), es.snapshot()
    for cname, fname, _dt in entity_leaf_specs(a):
        assert torch.equal(getattr(getattr(a, cname), fname),
                           getattr(getattr(b, cname), fname)), f"{cname}.{fname}"
    assert int(a.transform.active.sum()) < 64  # some fugitives despawned
    assert int(metrics["active_count"]) == int(a.transform.active.sum())


def test_chunked_step_matches_single_steps():
    e1, e2 = port_pile(), port_pile()
    mesh = make_mesh(2, "cpu")
    s1, p1 = make_halo_step(e1, mesh)
    s3, p3 = make_halo_step(e2, mesh, chunk_steps=3)
    c1, c3 = p1(e1.world), p3(e2.world)
    ins = e1.input.snapshot("cpu")
    for _ in range(3):
        c1, _m = s1(c1, ins)
    c3, m3 = s3(c3, [ins] * 3)
    assert m3["active_count"].shape == (3,)
    a, b = unplace_fn(c1, mesh), unplace_fn(c3, mesh)
    assert torch.equal(a.transform.x, b.transform.x) and torch.equal(a.transform.y, b.transform.y)


def test_route_overflow_matches_reference():
    """Every ball in the bottom slab with a starved route capacity
    (oversub 0.5): the overflow count equals the JAX step's, the
    overflowed balls take the boundary alone, positions stay finite."""

    def spawn(eng):
        rng = np.random.default_rng(4)
        eng.spawn_batch("Ball", 255, x=rng.uniform(50, 1550, 255).astype(np.float32),
                        y=rng.uniform(900, 980, 255).astype(np.float32))
        eng._flush_pending()
        return eng

    ej = spawn(ref_pile(spawn=False))
    et = spawn(port_pile(spawn=False))
    step_j, place_j = ref_make_halo_step(ej, ref_make_mesh(4, axis_name="slab"), oversub=0.5)
    mesh = make_mesh(4, "cpu")
    step_t, place_t = make_halo_step(et, mesh, oversub=0.5)
    wj, ct = place_j(ej.world), place_t(et.world)
    for _ in range(2):
        wj, mj = step_j(wj, ej.input.snapshot())
        ct, mt = step_t(ct, et.input.snapshot("cpu"))
        assert int(mt["route_overflow_solver"]) == int(mj["route_overflow_solver"]) > 0
        w = unplace_fn(ct, mesh)
        assert bool((w.transform.x.isfinite() & w.transform.y.isfinite()).all())
        compare(jax.device_get(wj), w, ulps(1600.0, 8))


def test_indivisible_entity_count_raises():
    eng = make_balls_engine(n_balls=250, seed=1, device="cpu", world_width=800.0,
                            world_height=600.0)
    with pytest.raises(ValueError, match="divisible"):
        make_halo_step(eng, make_mesh(4, "cpu"))


@pytest.mark.parametrize("change,error", [
    # collision events and a particle pool run under the halo step: the
    # configuration builds and runs one frame (the ids are the cases' own)
    pytest.param(dict(logic=dict(collision_events=True)), None,
                 id="change0-NotImplementedError"),
    pytest.param(dict(particle=dict(max_particles=64)), None,
                 id="change1-NotImplementedError"),
    (dict(physics=dict(solver="neighbors")), ValueError),
    (dict(spatial=dict(method="bruteforce")), ValueError),
])
def test_refused_configurations(change, error):
    eng = port_pile()
    cfg = eng.config
    for section, fields in change.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **fields)})
    if error is None:
        # the world's tables and pool are allocated at init for the config
        eng = port_pile(**change)
        step, place = make_halo_step(eng, make_mesh(2, "cpu"))
        chunks, metrics = step(place(eng.world), eng.input.snapshot("cpu"))
        assert int(metrics["active_count"]) == 256 and chunks[0].step_count == 1
        assert int(metrics["route_overflow_solver"]) == 0
        return
    eng.config = cfg
    with pytest.raises(error):
        make_halo_step(eng, make_mesh(2, "cpu"))


def test_no_radius_raises():
    eng = Engine(make_config(world_width=400.0, world_height=300.0), device="cpu")
    eng.register_entity_class(Fugitive, 3)
    eng.init()
    eng.world = eng.world.replace(
        collider=eng.world.collider.replace(radius=torch.zeros(4)))
    eng._max_radius = 0.0
    with pytest.raises(ValueError, match="geometry"):
        make_halo_step(eng, make_mesh(2, "cpu"))


# ---------------------------------------------------------------------------
# slice C1: the neighbour-reading phase A (tests/test_halo.py::TestBoidsParity)
# ---------------------------------------------------------------------------

def boids_engine(cls=None, n_total=256, y_range=(50, 1550), seed=3, **physics):
    """test_halo.py's 256-boid scene (``_boids_engine``)."""
    from multithreadedgameengine_tpu_torch.models.boids import Boid

    eng = Engine(make_config(world_width=2000.0, world_height=1600.0, seed=7,
                             spatial=dict(cell_size=100.0, max_neighbors=64, cell_capacity=32),
                             physics={"sub_step_count": 2, "gravity": (0.0, 0.0), **physics}),
                 device="cpu")
    cls = cls or Boid
    eng.register_entity_class(cls, n_total - 1)
    eng.init()
    rng = np.random.default_rng(seed)
    m = n_total - 1
    eng.spawn_batch(cls.__name__, m, x=rng.uniform(50, 1950, m).astype(np.float32),
                    y=rng.uniform(*y_range, m).astype(np.float32),
                    vx=rng.uniform(-3, 3, m).astype(np.float32),
                    vy=rng.uniform(-3, 3, m).astype(np.float32))
    eng._flush_pending()
    return eng


def assert_all_leaves_equal(a, b):
    from multithreadedgameengine_tpu_torch.parallel.halo import _get_comp

    specs = entity_leaf_specs(a)
    assert specs == entity_leaf_specs(b)
    for cname, fname, _dt in specs:
        assert torch.equal(getattr(_get_comp(a, cname), fname),
                           getattr(_get_comp(b, cname), fname)), f"{cname}.{fname}"


@pytest.mark.parametrize("n_slabs", [4, 8])
def test_halo_boids_bit_equal_with_single_device_engine(n_slabs):
    """Flocking ticks (neighbour tables built per slab with hw halo rows)
    and the grid solver: the halo trajectory is the single-device one, bit
    for bit, every leaf of every component (the user component included),
    with no routing overflow."""
    eh, es = boids_engine(), boids_engine()
    mesh = make_mesh(n_slabs, "cpu")
    step, place = make_halo_step(eh, mesh, oversub=4.0)
    assert step.plan.need_neighbors and step.plan.hw == 1
    chunks = place(eh.world)
    ins = eh.input.snapshot("cpu")
    for _ in range(4):
        chunks, metrics = step(chunks, ins)
    es.step(4)
    a = unplace_fn(chunks, mesh)
    assert set(a.custom) == {"flocking"}
    assert_all_leaves_equal(a, es.snapshot())
    assert int(metrics["route_overflow_logic"]) == 0
    assert int(metrics["route_overflow_solver"]) == 0
    assert int(metrics["active_count"]) == int(metrics["n_binned"]) == 256


class Herder(EntityClass):
    """Reads a neighbour field it does not declare: ``ctx.neighbor_col``
    falls back to ``ctx.gather``, which the halo step resolves against the
    home chunks in global-id order."""

    components = [RigidBody, Collider, SpriteRenderer]

    @classmethod
    def setup(cls, ctx):
        return {"collider.radius": 10.0, "collider.visual_range": 100.0,
                "rigid_body.max_vel": 10.0}

    @staticmethod
    def tick(ctx):
        live = ctx.neighbor_mask
        vx = torch.where(live, ctx.neighbor_col("rigid_body.vx"), 0.0).sum(1)
        vy = torch.where(live, ctx.gather("rigid_body.vy"), 0.0).sum(1)
        n = torch.clamp(ctx.neighbor_count, min=1).to(torch.float32)
        return {"rigid_body.ax": 0.05 * vx / n, "rigid_body.ay": 0.05 * vy / n}


def test_halo_gather_of_undeclared_fields_bit_equal():
    eh, es = boids_engine(Herder), boids_engine(Herder)
    mesh = make_mesh(4, "cpu")
    step, place = make_halo_step(eh, mesh, oversub=4.0)
    assert step.plan.payload_channels == {"transform.x": 1, "transform.y": 2}
    chunks = place(eh.world)
    for _ in range(3):
        chunks, _m = step(chunks, eh.input.snapshot("cpu"))
    es.step(3)
    assert_all_leaves_equal(unplace_fn(chunks, mesh), es.snapshot())
    assert float(es.world.rigid_body.vx.abs().sum()) > 0


def test_halo_boids_logic_route_overflow_degrades():
    """Every boid in the bottom slab with a starved route capacity (oversub
    0.5, test_halo.py::TestRouteOverflowDegrades): phase A's overflow is
    counted, the rows left home keep their state for the frame, positions
    stay finite."""
    eng = boids_engine(y_range=(1450, 1550), seed=4, sub_step_count=1)
    mesh = make_mesh(4, "cpu")
    step, place = make_halo_step(eng, mesh, oversub=0.5)
    chunks = place(eng.world)
    for _ in range(2):
        chunks, metrics = step(chunks, eng.input.snapshot("cpu"))
    assert int(metrics["route_overflow_logic"]) > 0
    w = unplace_fn(chunks, mesh)
    assert bool((w.transform.x.isfinite() & w.transform.y.isfinite()).all())


def test_custom_leaves_travel_exactly():
    eng = boids_engine()
    w = eng.world
    fl = w.custom["flocking"]
    w = w.replace(custom={"flocking": fl.replace(margin=torch.linspace(-1.0, 1.0, 256))})
    specs = entity_leaf_specs(w)
    assert [s[0] for s in specs][-6:] == ["custom:flocking"] * 6
    assert specs[-6][1] == "protected_range"
    back = unpack_world_rows(pack_world_rows(w, specs), eng.world, specs)
    assert torch.equal(back.custom["flocking"].margin, w.custom["flocking"].margin)
    assert torch.equal(back.shadow.shadow_radius, w.shadow.shadow_radius)
