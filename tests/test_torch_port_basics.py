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
    + [Path("chip_smoke.py"), Path("torch_profile.py"), Path("kernel_ab.py")],
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
    ({}, dict(logic=dict(collision_events=True))),
    ({}, dict(logic=dict(screen_events=True))),
    ({}, dict(particle=dict(max_particles=16))),
    ({}, dict(lighting=dict(enabled=True))),
], ids=["neighbors", "collision_events", "screen_events", "particles", "lighting"])
def test_unported_config_is_refused(physics, other):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(make_config(physics=physics, **other), device="cpu")


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
    eng = Engine(balls_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.update_physics_config(solver="neighbors")
    for api in (eng.begin_plan, eng.save_checkpoint, eng.render_packet):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api()


def test_neighbour_reading_tick_is_refused():
    class Reader(EntityClass):
        components = [RigidBody]

        @staticmethod
        def tick(ctx):
            return {}

    eng = Engine(balls_config(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice C"):
        eng.register_entity_class(Reader, 4)


def test_device_is_required():
    with pytest.raises(TypeError):
        Engine(balls_config())
