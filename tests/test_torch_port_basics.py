"""The PyTorch port's package boundary: it imports and runs without JAX, its
copied pure-Python modules equal the reference's, and every configuration
outside the ported slice is refused by name."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu.config as ref_config
import multithreadedgameengine_tpu.rng as ref_rng
import multithreadedgameengine_tpu_torch.config as port_config
import multithreadedgameengine_tpu_torch.rng as port_rng
from multithreadedgameengine_tpu_torch import Engine, EntityClass, RigidBody, make_config
from multithreadedgameengine_tpu_torch.models.balls import balls_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multithreadedgameengine_tpu_torch"

_NO_JAX_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, sys.argv[1])
import pkgutil, importlib, torch
torch.set_num_threads(1)
import multithreadedgameengine_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
eng = make_balls_engine(n_balls=48, seed=5, device="cpu",
                        world_width=600.0, world_height=400.0)
eng.step(2)
w = eng.world
assert w.step_count == 2
assert bool(torch.isfinite(w.transform.x).all())
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split(".")[0] in ("jax", "jaxlib", "flax", "multithreadedgameengine_tpu")]
assert not bad, bad
print("OK")
"""


def test_port_runs_two_frames_without_jax():
    """Every port module imports, and a 2-frame CPU step runs, in a process
    where importing jax fails."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(REPO)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO) for p in PORT.rglob("*.py"))
    + [Path("chip_smoke.py"), Path("torch_profile.py"), Path("kernel_ab.py"),
       Path("mixed_drift.py")],
    ids=str,
)
def test_source_has_no_jax_import(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|multithreadedgameengine_tpu)\b",
                         text, re.M)


def test_library_path_follows_the_headers(tmp_path):
    """A kernel's cached library is named by its source, every ``csrc/*.cuh``
    header and the flags: a copy of ``csrc`` names the same libraries, and
    an edit to a header renames every source's library (so a stale one is
    never loaded). No nvcc is run."""
    import shutil

    from multithreadedgameengine_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    headers = sorted(csrc.glob("*.cuh"))
    assert sources == sorted(_build.ENTRY_POINTS) and headers
    before = {s: _build.library_path(csrc / s) for s in sources}
    assert before == {s: _build.library_path(_build.CSRC / s) for s in sources}
    (csrc / "notes.txt").write_text("not a header")
    assert before == {s: _build.library_path(csrc / s) for s in sources}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {s: _build.library_path(csrc / s) for s in sources}
    assert all(after[s] != before[s] for s in sources)
    assert all(after[s].parent == _build.BUILD_DIR for s in sources)


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", [
    "EngineConfig", "SpatialConfig", "PhysicsConfig", "LogicConfig",
    "ParticleConfig", "LightingConfig", "RendererConfig", "ShardingConfig",
])
def test_config_fields_and_defaults_match_reference(name):
    assert _fields(getattr(port_config, name)) == _fields(getattr(ref_config, name))


def test_make_config_and_validation_match_reference():
    kw = dict(world_width=1234.0, seed=9, physics=dict(
        sub_step_count=0, boundary_elasticity=1.7, gravity=(0, 2),
        collision_response_strength=-1.0, rebin_interval=0))
    a = dataclasses.asdict(port_config.make_config(**kw))
    b = dataclasses.asdict(ref_config.make_config(**kw))
    assert a == b


@pytest.mark.parametrize("seed", [0, 1, 123456, 2**32 - 1, 987654321])
def test_mulberry32_streams_match_reference(seed):
    p, r = port_rng.Mulberry32(seed), ref_rng.Mulberry32(seed)
    assert [p() for _ in range(50)] == [r() for _ in range(50)]
    np.testing.assert_array_equal(p.draw(1000), r.draw(1000))
    assert p.uniform(-3, 5) == r.uniform(-3, 5)
    assert p.random_range({"min": 2, "max": 9}) == r.random_range({"min": 2, "max": 9})


@pytest.mark.parametrize("physics,other", [
    (dict(solver="neighbors"), {}),
], ids=["neighbors"])
def test_unported_config_is_refused(physics, other):
    """Refused until the neighbour-list solver was ported (ROADMAP item
    12): the configuration builds, and a ball scene runs 2 frames on the
    lists, as the JAX Engine does (integers exact, positions within 2e-3,
    ``tests/test_torch_neighbor_solver.py``'s bar)."""
    from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    assert Engine(make_config(physics=physics, **other), device="cpu").config.physics.solver == (
        "neighbors")
    kw = dict(n_balls=60, seed=4, world_width=300.0, world_height=200.0, physics=physics)
    ej, et = ref_balls(**kw), make_balls_engine(device="cpu", **kw)
    ej.step(2)
    m = et.step(2)
    assert et._plan.solver_geom is None and int(m["n_binned"]) == 61
    a, b = ej.snapshot(), et.world
    np.testing.assert_array_equal(b.rigid_body.collision_count.numpy(),
                                  np.asarray(a.rigid_body.collision_count))
    np.testing.assert_allclose(b.transform.x.numpy(), np.asarray(a.transform.x), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(b.transform.y.numpy(), np.asarray(a.transform.y), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("logic", [
    dict(collision_events=True),
    dict(screen_events=True),
], ids=["collision_events", "screen_events"])
def test_event_config_runs(logic):
    """The event configurations slice C3 ported, refused before it: the
    engine builds, allocates the event state, and a ball scene runs 2
    frames on the CPU with its pair or screen tables written."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    assert Engine(make_config(logic=logic), device="cpu").config.logic == make_config(
        logic=logic).logic
    eng = make_balls_engine(n_balls=60, seed=4, device="cpu", world_width=300.0,
                            world_height=200.0, logic=logic)
    m = eng.step(2)
    w = eng.world
    assert w.step_count == 2
    assert bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all())
    if "collision_events" in logic:
        assert eng._plan.need_neighbors and w.prev_onscreen is None
        assert w.collision_pairs.shape == (eng.config.physics.max_collision_pairs, 2)
        # 60 balls of radius 10-30 in 300 x 200 touch
        assert int(m["collision_pair_count"]) + int(m["collision_pairs_dropped"]) > 1
        assert torch.equal(w.prev_collision_pairs, w.collision_pairs)
    else:
        assert w.collision_pairs is None and not eng._plan.need_neighbors
        assert w.screen_events_packed.shape == (2 + 2 * 1024,)
        assert int(w.screen_events_packed[0]) == 0  # every ball entered on frame 1
        assert int(w.prev_onscreen.sum()) > 0


@pytest.mark.parametrize("other", [
    dict(particle=dict(max_particles=16)),
    dict(lighting=dict(enabled=True)),
], ids=["particles", "lighting"])
def test_slice_c2_config_runs(other):
    """The configurations slice C2 ported, refused before it, build and run
    2 frames on the CPU: a particle pool (with the emitter's queue), and
    lighting with its shadow sprites (the frame then builds neighbour
    lists)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=60, seed=4, device="cpu", world_width=600.0,
                            world_height=400.0, **other)
    assert eng.emitter.emit(count=40, x=300.0, y=100.0, z=-10.0, lifespan=9000.0) == (
        40 if "particle" in other else 0)
    m = eng.step(2)
    w = eng.world
    assert w.step_count == 2
    assert bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all())
    if "particle" in other:
        assert int(m["active_particles"]) == 16 and w.shadow_sprites is None
        assert w.decal_canvas is None  # decals off
    else:
        assert int(m["active_particles"]) == -1 and w.particles is None
        assert eng._plan.shadows_on and int(m["n_binned"]) == 61
        assert w.shadow_sprites.active.shape == (20 * 15,)


@pytest.mark.parametrize("physics", [
    dict(solver_predicated="on"),
    dict(rebin_interval=2),
    dict(position_residency="on", rebin_interval=2),
], ids=["k2", "rebin", "residency"])
def test_slice_b_config_runs(physics):
    """The configurations slice B ported build and run 2 frames on the CPU:
    K2, the rebin cache, and position residency."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    eng = make_balls_engine(n_balls=60, seed=4, device="cpu", world_width=600.0,
                            world_height=400.0, physics=dict(
                                balls_config().physics.__dict__, **physics))
    eng.step(2)
    plan = eng._plan
    assert plan.symmetric == (physics.get("solver_predicated") == "on")
    # residency is "auto" by default: on wherever the bin cache is
    assert plan.residency == ("rebin_interval" in physics)
    assert (eng.world.solver_flat is not None) == ("rebin_interval" in physics)
    w = eng.world
    assert w.step_count == 2
    assert bool((torch.isfinite(w.transform.x) & torch.isfinite(w.transform.y)).all())
    assert int(w.rigid_body.collision_count.sum()) > 0


def test_unported_runtime_updates_and_apis_are_refused():
    """Refused until items 12 and 17 were ported: the solver switches at
    run time, and the render packet and the screenshot run, with the
    reference's packet and image for the same world."""
    import jax

    from multithreadedgameengine_tpu.models.balls import make_balls_engine as ref_balls
    from multithreadedgameengine_tpu_torch.interop import world_from_jax
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine

    kw = dict(n_balls=40, seed=8, world_width=400.0, world_height=300.0)
    ej, et = ref_balls(**kw), make_balls_engine(device="cpu", **kw)
    et.update_physics_config(solver="neighbors")
    et.step(1)
    assert et._plan.solver_geom is None and et._plan.need_neighbors
    ej.step(2)
    et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
    for e in (ej, et):
        e.input.camera_x = e.input.camera_y = 0.0
    a, b = ej.render_packet(), et.render_packet()
    assert int(b.count) == int(a.count) > 0
    np.testing.assert_array_equal(b.index.numpy(), np.asarray(a.index))
    np.testing.assert_array_equal(b.y.numpy(), np.asarray(a.y))
    np.testing.assert_array_equal(et.screenshot(None, 160, 120), ej.screenshot(None, 160, 120))


def test_neighbour_reading_tick_is_refused():
    """Since slice C1 a tick that reads neighbours registers and runs; the
    scene it needs the neighbour-list solver for (no collider radius) was
    refused until item 12, and now runs as the JAX Engine runs it: the
    same neighbour counts in the tick's writes, positions within 2 ulps."""
    import jax.numpy as jnp

    import multithreadedgameengine_tpu as ref
    from multithreadedgameengine_tpu.models.balls import balls_config as ref_balls_config

    class Reader(EntityClass):
        components = [RigidBody]

        @staticmethod
        def tick(ctx):
            return {"rigid_body.ax": ctx.neighbor_count.to(torch.float32)}

    class RefReader(ref.EntityClass):
        components = [ref.RigidBody]

        @staticmethod
        def tick(ctx):
            return {"rigid_body.ax": ctx.neighbor_count.astype(jnp.float32)}

    eng = Engine(balls_config(), device="cpu")
    reng = ref.Engine(ref_balls_config())
    for e, cls in ((eng, Reader), (reng, RefReader)):
        e.register_entity_class(cls, 4)
        e.init()
        for x in (10.0, 30.0, 50.0):
            e.spawn(cls.__name__, x=x, y=10.0)
        e.step(1)
    assert eng._plan.solver_geom is None and eng._plan.need_neighbors
    w, r = eng.world, reng.snapshot()
    np.testing.assert_array_equal(w.transform.active.numpy(), np.asarray(r.transform.active))
    np.testing.assert_array_equal(w.rigid_body.vx.numpy(), np.asarray(r.rigid_body.vx))
    for f in ("x", "y"):
        np.testing.assert_array_max_ulp(getattr(w.transform, f).numpy(),
                                        np.asarray(getattr(r.transform, f)), maxulp=2)


def test_device_is_required():
    """The entry points run on the card unless the caller asks for the CPU:
    ``device`` defaults to ``"cuda"``, with no probing and no fallback, so
    without a card the default raises at the first allocation instead of
    running on the CPU."""
    import inspect

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import make_mesh

    for fn in (Engine.__init__, make_balls_engine, make_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert Engine(balls_config()).device == torch.device("cuda")
    assert make_mesh(2).device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            make_balls_engine(n_balls=8)
