"""Slice B end to end: the rebin and attribute caches, position residency,
the banded boundary and the lazy-readback chunk, through the JAX package and
through the PyTorch port (CPU, plain kernel versions).

The scene is 250 balls, seed 11, in a 2400 x 1600 world (dense enough for
contacts from the first frame, wide enough for the port's boundary bands)
with the physics of the reference's own
residency tests (tests/test_round4.py): the demo's, with ``rebin_interval``
3, ``solver="pallas"`` and ``solver_predicated="on"``, so both packages run
K2, the JAX package in Pallas interpret mode. Four scripts drive it: the
mouse held down and moved (the pinned mouse row), host despawns and spawns
between rebins (a REBUILD), a spawn whose ``max_vel`` exceeds the band's
bound (a re-plan), and a runtime raise of ``rebin_interval`` from 1.

Each script runs once in the JAX package and in four variants of the port:
residency off, on, on through the lazy chunk (``step(n)``), and auto with
the band off through the lazy chunk. Against the JAX package: integer and
boolean state exact, positions and velocities within 2e-3 (16 float32 ulps
at the world's 2400 extent; XLA:CPU contracts multiply-adds and approximates
``rsqrt``, and the reference sums a tile's spilled reciprocals last, while
the port rounds every operation; measured at most 3.1e-4 over these
scripts). Within the port, every variant equals residency off bit for bit:
residency on and off, the lazy chunk and single steps, the banded and the
full-layout boundary compute the same operations on the same values.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref_pkg
import multithreadedgameengine_tpu.ops.pallas_kernels as ref_kernels
import multithreadedgameengine_tpu_torch as port_pkg
from multithreadedgameengine_tpu.behavior import probe_layout_safe as ref_probe
from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
from multithreadedgameengine_tpu_torch.behavior import probe_layout_safe
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine as port_balls
from multithreadedgameengine_tpu_torch.ops import physics_grid

torch.set_num_threads(2)

RES_PHYSICS = dict(
    sub_step_count=2, max_collision_pairs=1, verlet_damping=0.99,
    boundary_elasticity=0.0, collision_response_strength=0.8,
    gravity=(0.0, 0.5), rebin_interval=3, solver="pallas",
    solver_predicated="on",
)
N_BALLS, SEED = 250, 11
SCENE = dict(n_balls=N_BALLS, seed=SEED, world_width=2400.0, world_height=1600.0)
POS_ATOL = 2e-3
EXACT = [("rigid_body", "collision_count"), ("transform", "active"),
         ("sprite", "is_on_screen")]
CLOSE = [("transform", "x"), ("transform", "y"), ("rigid_body", "px"),
         ("rigid_body", "py"), ("rigid_body", "vx"), ("rigid_body", "vy")]


def _mouse(at):
    def op(eng):
        eng.input.set_mouse(*at, present=True)
        eng.input.mouse_button(0, True)
    return op


def _mutate(eng):
    for i in range(11, 41):
        eng.despawn(i)
    eng.spawn_batch("Ball", 20, x=np.linspace(100, 2300, 20).astype(np.float32),
                    y=np.full(20, 200, np.float32))


def _fast_spawn(eng):
    eng.despawn(5)
    eng.spawn("Ball", x=1200.0, y=100.0, vx=0.0, vy=0.0, **{"rigid_body.max_vel": 300.0})


def _raise_rebin(eng):
    eng.update_physics_config(rebin_interval=3)


#: name -> (physics overrides, script of ops and frame counts)
SCRIPTS = {
    "mouse": ({}, [_mouse((500.0, 1400.0)), 3, _mouse((1900.0, 1450.0)), 3]),
    "mutation": ({}, [4, _mutate, 5]),
    "max_vel": ({}, [4, _fast_spawn, 5]),
    "rebin_raise": (dict(rebin_interval=1), [2, _raise_rebin, 6]),
}
#: port variants: (physics overrides, frames through step(n) chunks)
VARIANTS = {
    "off": (dict(position_residency="off"), False),
    "on": (dict(position_residency="on"), False),
    "on_lazy": (dict(position_residency="on"), True),
    "auto_bandoff_lazy": (dict(position_residency="auto", boundary_band="off"), True),
}


def run_script(eng, script, chunked):
    """Snapshots (and the port's band-drift metric) after every run of
    frames."""
    snaps, drift = [], []
    for op in script:
        if callable(op):
            op(eng)
            continue
        if chunked:
            eng.step(op)
        else:
            for _ in range(op):
                eng.step(1)
        snaps.append(eng.snapshot())
        drift.append(int(eng.metrics["boundary_band_drift"]))
    return snaps, drift


_RUNS = {}


def runs(script_name):
    """The JAX run and every port variant of one script, computed once."""
    if script_name not in _RUNS:
        phys, script = SCRIPTS[script_name]
        ej = ref_balls(**SCENE, physics=dict(RES_PHYSICS, position_residency="on", **phys))
        out = {"jax": run_script(ej, script, chunked=False) + (ej,)}
        for name, (vphys, chunked) in VARIANTS.items():
            et = port_balls(**SCENE, device="cpu",
                            physics=dict(RES_PHYSICS, **dict(phys, **vphys)))
            out[name] = run_script(et, script, chunked) + (et,)
        _RUNS[script_name] = out
    return _RUNS[script_name]


def as_np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compare(a, b, atol):
    for comp, field in EXACT:
        np.testing.assert_array_equal(as_np(getattr(getattr(b, comp), field)),
                                      as_np(getattr(getattr(a, comp), field)),
                                      err_msg=f"{comp}.{field}")
    for comp, field in CLOSE:
        va = as_np(getattr(getattr(a, comp), field))
        vb = as_np(getattr(getattr(b, comp), field))
        if atol == 0:
            np.testing.assert_array_equal(vb, va, err_msg=f"{comp}.{field}")
        else:
            np.testing.assert_allclose(vb, va, rtol=0, atol=atol, err_msg=f"{comp}.{field}")
    assert int(b.step_count) == int(a.step_count)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_matches_reference_engine(script, variant):
    r = runs(script)
    ref_snaps, ref_drift, ej = r["jax"]
    snaps, drift, et = r[variant]
    for a, b in zip(ref_snaps, snaps):
        compare(a, b, POS_ATOL)
    assert int(snaps[0].rigid_body.collision_count.sum()) > 0
    # the banded boundary's drift monitor stays 0, in both packages
    assert drift == [0] * len(drift) and ref_drift == drift
    plan = et._plan
    assert plan.symmetric
    assert plan.residency == (VARIANTS[variant][0]["position_residency"] != "off")
    assert plan.residency == ej._residency_on or variant == "off"
    if plan.residency:
        assert plan.pin_rows == (0,)  # the mouse, written every frame
        band_on = variant != "auto_bandoff_lazy"
        assert plan.band_vel_bound == (ej._band_vel_bound if band_on else 0.0)
        band, _cells = physics_grid._band_spec(plan.cfg, plan.solver_geom,
                                               plan.band_vel_bound, plan.symmetric)
        # after the max_vel re-plan the bands (12 cells for 300 px/frame)
        # would meet in this 22-row world, so the band switches off
        assert (band is not None) == (band_on and script != "max_vel")


@pytest.mark.parametrize("variant", ["on", "on_lazy", "auto_bandoff_lazy"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_variants_are_bit_exact(script, variant):
    """Residency on equals off, the lazy chunk equals single steps, and the
    banded boundary equals the full-layout one, bit for bit."""
    r = runs(script)
    for a, b in zip(r["off"][0], r[variant][0]):
        compare(a, b, atol=0)
    if VARIANTS[variant][1]:
        assert r[variant][2].lazy_frames > 0


def test_replans_follow_the_reference():
    """A host write of max_vel above the band's bound re-derives the band;
    a runtime raise of rebin_interval installs the caches and residency."""
    mv = runs("max_vel")
    assert mv["on"][2]._plan.band_vel_bound == 300.0 == mv["jax"][2]._band_vel_bound
    rr = runs("rebin_raise")
    et = rr["on_lazy"][2]
    assert et._plan.residency and et.world.solver_x is not None
    assert et.world.solver_bin_step >= 0 and rr["jax"][2]._residency_on


@pytest.mark.parametrize("solver", ["pallas", "grid"])
def test_world_carried_across_mid_interval(solver):
    """A JAX world stepped 4 frames into an 8-frame rebin interval moves to
    the port with its caches (bins; for the resident solver also the
    attribute and position layouts; the stamps); both engines then continue
    4 frames without a rebin. The "grid" solver's bins use the reference's
    other flat encoding, ``[R+2, C+2, cap]``."""
    phys = dict(RES_PHYSICS, rebin_interval=8, position_residency="on", solver=solver)
    ej = ref_balls(**SCENE, physics=phys)
    et = port_balls(**SCENE, device="cpu", physics=phys)
    for e in (ej, et):
        _mouse((1200.0, 1500.0))(e)
    for _ in range(4):
        ej.step(1)
    et.step(1)  # builds the plan; the restore below replaces the world
    et.restore(world_from_jax(jax.device_get(ej.world), "cpu", et._plan.solver_geom))
    w = et.world
    assert w.step_count == 4 and w.solver_bin_step == 0
    # one distinct slot of the port's layout for every binned entity
    in_grid = w.solver_in_grid
    flat = w.solver_flat[in_grid]
    n_slots = int(np.prod(physics_grid.layout_shape(et._plan.solver_geom)))
    assert flat.numel() > 0 and int(flat.max()) < n_slots
    assert flat.unique().numel() == flat.numel()
    if solver == "pallas":
        assert w.solver_pos_step == 4
        # ... where the carried meta names the entity and the carried
        # position layout holds its position
        gid = torch.nonzero(in_grid).view(-1).to(torch.int32)
        assert torch.equal(w.solver_meta.view(-1)[flat] & 0xFFFFFF, gid)
        assert torch.equal(w.solver_x.view(-1)[flat], w.transform.x[in_grid])
    for _ in range(4):
        ej.step(1)
    et.step(4)
    assert et.world.solver_bin_step == 0
    assert et.lazy_frames == (3 if solver == "pallas" else 0)
    compare(ej.snapshot(), et.snapshot(), POS_ATOL)


@pytest.mark.parametrize("world_width,symmetric", [(40_000.0, True), (9000.0, False)],
                         ids=["wide", "narrow"])
def test_kernel_gate_matches_reference(monkeypatch, world_width, symmetric):
    """solver_predicated "auto": K2 where the reference's padded lane width
    is 512 or more, K1 below, in both packages."""
    seen = []
    orig = ref_kernels.pair_pass_resident

    def spy(*args, **kwargs):
        seen.append(kwargs.get("symmetric", True))
        return orig(*args, **kwargs)

    monkeypatch.setattr(ref_kernels, "pair_pass_resident", spy)
    port_seen = []
    for name in ("pair_pass_resident", "pair_pass_symmetric"):
        fn = getattr(physics_grid, name)
        monkeypatch.setattr(physics_grid, name, lambda *a, _fn=fn, _n=name, **k: (
            port_seen.append(_n == "pair_pass_symmetric"), _fn(*a, **k))[1])
    kw = dict(n_balls=30, seed=2, world_width=world_width, world_height=400.0)
    ej = ref_balls(**kw, physics=dict(RES_PHYSICS, solver_predicated="auto"))
    et = port_balls(**kw, device="cpu", physics=dict(RES_PHYSICS, solver_predicated="auto",
                                                     solver="auto"))
    ej.step(1)
    et.step(1)
    assert set(seen) == {symmetric} and set(port_seen) == {symmetric}
    assert et._plan.symmetric == symmetric
    ref_lanes = -(-(et._plan.solver_geom.cols + 2) // 128) * 128
    assert (ref_lanes >= 512) == symmetric
    compare(ej.snapshot(), et.snapshot(), POS_ATOL)


def test_unsafe_tick_disables_auto_and_rejects_on():
    """A tick that reads beyond (id, x, y, ax, ay, inputs) is not layout
    safe in either package: "auto" runs without residency, "on" raises."""

    def make(pkg):
        class Reader(pkg.EntityClass):
            components = [pkg.RigidBody, pkg.Collider]
            uses_neighbors = False

            @classmethod
            def setup(cls, ctx):
                return {"collider.radius": 5.0}

            @staticmethod
            def tick(ctx):
                return {"rigid_body.ax": ctx.vx * 0.0}

        return Reader

    cfg = port_pkg.make_config(physics=dict(rebin_interval=2))
    assert not probe_layout_safe(make(port_pkg), cfg)
    assert not ref_probe(make(ref_pkg), ref_pkg.make_config(physics=dict(rebin_interval=2)))

    def build(residency):
        eng = port_pkg.Engine(port_pkg.make_config(
            world_width=400.0, world_height=300.0,
            physics=dict(rebin_interval=2, position_residency=residency)), device="cpu")
        eng.register_entity_class(make(port_pkg), 4)
        eng.init()
        eng.spawn("Reader", x=100.0, y=100.0)
        eng.step(1)
        return eng

    assert not build("auto")._plan.residency
    with pytest.raises(ValueError, match="not layout-safe"):
        build("on")


def test_config_after_plan_names_the_resident_solver():
    """The plan resolves solver "auto" as "pallas", as the reference does on
    its accelerator, and leaves every other knob as given."""
    et = port_balls(n_balls=20, seed=1, device="cpu", world_width=600.0, world_height=400.0)
    before = dataclasses.replace(et.config.physics, solver="pallas")
    et.step(1)
    assert et.config.physics == before


def test_first_plan_geometry_and_overflow_match_reference(monkeypatch):
    """Both packages build their first plan before the queued one-by-one
    spawns land (below 50k balls the balls model spawns one by one), so
    the plan sees their radii only as the largest radius. The solver grid
    (cell, rows, columns, capacity) must come out the same, and in a world
    dense enough to overflow, so must the first frame's overflow count."""
    import multithreadedgameengine_tpu.ops.physics_grid as ref_grid

    seen = []
    orig = ref_grid.solver_geometry

    def spy(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(ref_grid, "solver_geometry", spy)
    kw = dict(n_balls=300, seed=7, world_width=600.0, world_height=400.0)
    ej = ref_balls(**kw)
    et = port_balls(**kw, device="cpu")
    ej.step(1)
    et.step(1)
    fields = ("cell_size", "rows", "cols", "capacity")
    assert len(seen) == 1
    assert ([getattr(et._plan.solver_geom, f) for f in fields]
            == [getattr(seen[0], f) for f in fields])
    overflow = int(et.metrics["solver_overflow"])
    assert overflow == int(ej.metrics["solver_overflow"]) and overflow > 0
