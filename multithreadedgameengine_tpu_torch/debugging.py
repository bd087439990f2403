"""Debug-flag system: the Debug API (src/core/Debug.js).

The port's copy of ``multithreadedgameengine_tpu/debugging.py:20-83``. The
reference keeps 32 one-byte flags in a SAB set by a chainable main-thread
API and consumed by the renderer's overlay pass (Debug.js:254-267 flag enum;
:300-468 chainable setters and presets). Here the flags are a host-side
object, ``engine.debug.flags``, for any renderer to read;
``show_profiler`` also switches the engine's profiling on or off.
"""

from __future__ import annotations

# flag names mirror DEBUG_FLAGS (Debug.js:254-267)
FLAG_NAMES = (
    "colliders", "velocity", "acceleration", "neighbors", "grid",
    "info", "aabb", "trail", "fps", "profiler", "indices",
)


class Debug:
    """Chainable flag setters and presets (Debug.js:300-468)."""

    def __init__(self, engine=None):
        self._engine = engine
        self.flags = {name: False for name in FLAG_NAMES}

    def _set(self, name: str, value: bool) -> "Debug":
        self.flags[name] = bool(value)
        return self

    # chainable showX() setters
    def show_colliders(self, on: bool = True) -> "Debug":
        return self._set("colliders", on)

    def show_velocity(self, on: bool = True) -> "Debug":
        return self._set("velocity", on)

    def show_acceleration(self, on: bool = True) -> "Debug":
        return self._set("acceleration", on)

    def show_neighbors(self, on: bool = True) -> "Debug":
        return self._set("neighbors", on)

    def show_grid(self, on: bool = True) -> "Debug":
        return self._set("grid", on)

    def show_info(self, on: bool = True) -> "Debug":
        return self._set("info", on)

    def show_aabb(self, on: bool = True) -> "Debug":
        return self._set("aabb", on)

    def show_trail(self, on: bool = True) -> "Debug":
        return self._set("trail", on)

    def show_fps(self, on: bool = True) -> "Debug":
        return self._set("fps", on)

    def show_profiler(self, on: bool = True) -> "Debug":
        if self._engine is not None:
            self._engine.enable_profiling(on)
        return self._set("profiler", on)

    def show_indices(self, on: bool = True) -> "Debug":
        return self._set("indices", on)

    # presets (Debug.js enablePhysicsDebug / enableAIDebug / enablePerformanceDebug)
    def enable_physics_debug(self) -> "Debug":
        return self.show_colliders().show_velocity().show_acceleration()

    def enable_ai_debug(self) -> "Debug":
        return self.show_neighbors().show_grid()

    def enable_performance_debug(self) -> "Debug":
        return self.show_fps().show_profiler()

    def disable_all(self) -> "Debug":
        for name in FLAG_NAMES:
            self.flags[name] = False
        return self

    def __getitem__(self, name: str) -> bool:
        return self.flags[name]
