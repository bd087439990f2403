"""multithreadedgameengine_tpu_torch — the PyTorch/CUDA port of
``multithreadedgameengine_tpu``.

The JAX package stays the reference; this package mirrors its module names
and runs the balls scene, the boids scene (neighbour lists, user
components), the predators scene (particles, decals, lighting and shadows,
sprite sheets), collision and screen events, the spatial-domain halo and
position-homed steps, and the Engine's host API (frame plans, batch
despawns, pause, destroy, checkpoints, the step timer and phase profiler,
debug flags) in PyTorch on the card unless the caller asks for the CPU. On ``device="cuda"``, the entry points'
default, the pair passes run as hand-written CUDA kernels
(``ops/cuda_kernels.py``, built from ``csrc/`` at first use); on
``device="cpu"`` every kernel runs its plain PyTorch version. This package
never imports JAX.

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    eng = make_balls_engine(n_balls=10_000, seed=123456, device="cuda")
    eng.step(60, block=True)
    plan = eng.begin_plan()           # pool churn: BASELINE config 2
    plan.despawn_batch(eng.active_indices("Ball")[:256])
    plan.spawn_batch("Ball", 256, x=xs, y=ys)
    plan.next_frame()
    eng.run_plan(plan)
"""

from .behavior import EntityClass, TickCtx, read_field, write_field
from .components import (
    Collider,
    LightEmitter,
    MouseComponent,
    Particles,
    RigidBody,
    ShadowCaster,
    SpriteRenderer,
    Transform,
    define_component,
)
from .config import (
    EngineConfig,
    LightingConfig,
    LogicConfig,
    ParticleConfig,
    PhysicsConfig,
    RendererConfig,
    SpatialConfig,
    make_config,
)
from .engine import Engine, FramePlan, Mouse
from .inputs import InputController, InputState
from .rng import Mulberry32
from .state import World, make_world

__version__ = "0.1.0"

__all__ = [
    "Engine",
    "FramePlan",
    "EntityClass",
    "TickCtx",
    "Mouse",
    "World",
    "make_world",
    "make_config",
    "EngineConfig",
    "SpatialConfig",
    "PhysicsConfig",
    "LogicConfig",
    "ParticleConfig",
    "LightingConfig",
    "RendererConfig",
    "Transform",
    "RigidBody",
    "Collider",
    "SpriteRenderer",
    "MouseComponent",
    "LightEmitter",
    "ShadowCaster",
    "Particles",
    "define_component",
    "InputController",
    "InputState",
    "Mulberry32",
    "read_field",
    "write_field",
]
