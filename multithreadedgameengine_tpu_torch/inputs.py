"""Host-to-device input plane: mouse, keyboard, camera.

PyTorch counterpart of ``multithreadedgameengine_tpu/inputs.py:45-182``. The
keyboard map, aliases and ``InputController`` are the reference's; the
per-frame ``InputState`` holds 0-dim and small tensors on the engine's
device, so the step reads the inputs without a host round trip. The
controller caches its snapshot until an input changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .components import Struct

# Keyboard map (gameEngine.js:212-267); index space as the reference's.
_KEY_NAMES = (
    [chr(c) for c in range(ord("a"), ord("z") + 1)]
    + [str(d) for d in range(10)]
    + [
        "space", "enter", "escape", "tab", "backspace", "delete",
        "shift", "control", "alt", "meta",
        "arrowup", "arrowdown", "arrowleft", "arrowright",
        "home", "end", "pageup", "pagedown", "insert", "capslock",
    ]
    + [f"f{i}" for i in range(1, 13)]
    + ["minus", "equal", "bracketleft", "bracketright", "backslash",
       "semicolon", "quote", "comma", "period", "slash", "backquote"]
)
KEY_INDEX: Dict[str, int] = {name: i for i, name in enumerate(_KEY_NAMES)}
NUM_KEYS = 128

# Aliases accepted by Keyboard proxy access (Keyboard.js:218-248)
KEY_ALIASES = {
    "up": "arrowup", "down": "arrowdown", "left": "arrowleft",
    "right": "arrowright", "ctrl": "control", "esc": "escape",
    " ": "space",
}


@dataclasses.dataclass
class InputState(Struct):
    """Per-frame input snapshot, as tensors on one device."""

    mouse_x: torch.Tensor  # f32 scalar, world coords
    mouse_y: torch.Tensor
    mouse_buttons: torch.Tensor  # bool[3]
    mouse_present: torch.Tensor  # bool scalar
    keys: torch.Tensor  # bool[NUM_KEYS]
    camera_x: torch.Tensor  # f32 scalar
    camera_y: torch.Tensor
    camera_zoom: torch.Tensor


class InputController:
    """Host-side mutable input front end (gameEngine.js:1384-1500);
    ``snapshot(device)`` produces the state handed to the step."""

    def __init__(self):
        self.mouse_x = 0.0
        self.mouse_y = 0.0
        self.mouse_buttons = [False, False, False]
        self.mouse_present = False
        self._keys = np.zeros((NUM_KEYS,), dtype=bool)
        self.camera_x = 0.0
        self.camera_y = 0.0
        self.camera_zoom = 1.0
        self._cache_key = None
        self._cache: Optional[InputState] = None

    # -- keyboard (Keyboard.isDown, Keyboard.js:197-248) --
    def _key_idx(self, name: str) -> int:
        name = name.lower()
        name = KEY_ALIASES.get(name, name)
        if name not in KEY_INDEX:
            raise KeyError(f"unknown key {name!r}")
        return KEY_INDEX[name]

    def key_down(self, name: str) -> None:
        self._keys[self._key_idx(name)] = True

    def key_up(self, name: str) -> None:
        self._keys[self._key_idx(name)] = False

    def is_down(self, name: str) -> bool:
        return bool(self._keys[self._key_idx(name)])

    # -- mouse --
    def set_mouse(self, x: float, y: float, present: bool = True) -> None:
        self.mouse_x, self.mouse_y, self.mouse_present = float(x), float(y), present

    def mouse_button(self, button: int, down: bool) -> None:
        self.mouse_buttons[button] = bool(down)

    def set_camera(self, x: float = None, y: float = None, zoom: float = None) -> None:
        if x is not None:
            self.camera_x = float(x)
        if y is not None:
            self.camera_y = float(y)
        if zoom is not None:
            self.camera_zoom = float(zoom)

    def zoom_at(self, screen_x: float, screen_y: float, factor: float) -> None:
        """Wheel zoom-to-cursor (gameEngine.js:1426-1450)."""
        wx = self.camera_x + screen_x / self.camera_zoom
        wy = self.camera_y + screen_y / self.camera_zoom
        self.camera_zoom *= float(factor)
        self.camera_x = wx - screen_x / self.camera_zoom
        self.camera_y = wy - screen_y / self.camera_zoom

    @property
    def mouse_is_down(self) -> bool:
        return self.mouse_buttons[0]

    def snapshot(self, device) -> InputState:
        """The per-frame input state on ``device``. Rebuilt (one small host
        to device copy per field) only when some input changed since the
        last snapshot for that device; direct attribute writes are caught by
        comparing the host values."""
        key = (
            self.mouse_x, self.mouse_y, tuple(self.mouse_buttons),
            bool(self.mouse_present), self._keys.tobytes(),
            self.camera_x, self.camera_y, self.camera_zoom, str(device),
        )
        if key != self._cache_key:

            def f32(v):
                return torch.tensor(np.float32(v), dtype=torch.float32, device=device)

            self._cache = InputState(
                mouse_x=f32(self.mouse_x),
                mouse_y=f32(self.mouse_y),
                mouse_buttons=torch.tensor(self.mouse_buttons, dtype=torch.bool, device=device),
                mouse_present=torch.tensor(bool(self.mouse_present), device=device),
                keys=torch.from_numpy(self._keys.copy()).to(device),
                camera_x=f32(self.camera_x),
                camera_y=f32(self.camera_y),
                camera_zoom=f32(self.camera_zoom),
            )
            self._cache_key = key
        return self._cache


def key_index(name: str) -> int:
    name = name.lower()
    return KEY_INDEX[KEY_ALIASES.get(name, name)]
