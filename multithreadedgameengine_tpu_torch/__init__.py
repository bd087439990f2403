"""multithreadedgameengine_tpu_torch — the PyTorch/CUDA port of
``multithreadedgameengine_tpu``.

The JAX package stays the reference; this package mirrors its module names
and runs the balls scene, the boids scene (neighbour lists, user
components), the predators scene (particles, decals, lighting and shadows,
sprite sheets) and the spatial-domain halo step in PyTorch on the card
unless the caller asks for the CPU. On ``device="cuda"``, the entry points'
default, the pair passes run as hand-written CUDA kernels
(``ops/cuda_kernels.py``, built from ``csrc/`` at first use); on
``device="cpu"`` every kernel runs its plain PyTorch version. This package
never imports JAX.

    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    eng = make_balls_engine(n_balls=10_000, seed=123456, device="cuda")
    eng.step(60, block=True)
"""

from .behavior import EntityClass, TickCtx, read_field, write_field
from .components import (
    Collider,
    LightEmitter,
    MouseComponent,
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
from .engine import Engine, Mouse
from .inputs import InputController, InputState
from .rng import Mulberry32
from .state import World, make_world

__version__ = "0.1.0"

__all__ = [
    "Engine",
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
    "define_component",
    "InputController",
    "InputState",
    "Mulberry32",
    "read_field",
    "write_field",
]
