"""Elementwise math of src/core/utils.js.

PyTorch counterpart of ``multithreadedgameengine_tpu/utils/mathx.py:17-92``:
usable per entity inside ticks and on whole tensors. The reference's
constants are Python floats that meet float32 arrays as weak types, so it
compares and adds them as float32; here they are rounded to float32 once,
which gives the same values. The colour helpers return int64 holding the
unsigned 32-bit value, the port's dtype for the reference's uint32 colours
(``components``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# direction indices of the 4-way animation facing
DIR_UP, DIR_RIGHT, DIR_DOWN, DIR_LEFT = 0, 1, 2, 3

_TWO_PI = float(np.float32(2.0 * math.pi))
_Q = float(np.float32(math.pi / 4.0))
_Q3, _Q5, _Q7 = (float(np.float32(k * (math.pi / 4.0))) for k in (3, 5, 7))


def _t(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(value)


def clamp(value, lo, hi):
    """utils.js:28-30."""
    return torch.clamp(_t(value), lo, hi)


def clamp01(value):
    """utils.js:16-19."""
    return torch.clamp(_t(value), 0.0, 1.0)


def lerp(a, b, t):
    """utils.js:39-41."""
    return a + (b - a) * t


def distance_sq_2d(x1, y1, x2, y2):
    """utils.js:103-107."""
    dx = x2 - x1
    dy = y2 - y1
    return dx * dx + dy * dy


def direction_from_angle(angle: torch.Tensor) -> torch.Tensor:
    """4-way facing from a velocityAngle (which already carries the +pi/2
    sprite-rotation offset), utils.js:308-331. Returns int32 DIR_* values:
    [315, 45) degrees up, [45, 135) right, [135, 225) down, else left."""
    norm = torch.where(angle < 0, angle + _TWO_PI, angle)
    out = torch.where(norm < _Q5, DIR_DOWN, DIR_LEFT)
    out = torch.where(norm < _Q3, DIR_RIGHT, out)
    return torch.where((norm < _Q) | (norm >= _Q7), DIR_UP, out).to(torch.int32)


def light_attenuation(intensity, distance_sq):
    """Capped inverse-square falloff ``intensity / (intensity + d^2)``
    (utils.js:378-380): 1.0 at d = 0, half at d = sqrt(intensity)."""
    return intensity / (intensity + distance_sq)


def pack_rgb(r, g, b):
    return (_t(r).to(torch.int64) << 16) | (_t(g).to(torch.int64) << 8) | _t(b).to(torch.int64)


def unpack_rgb(color):
    c = _t(color).to(torch.int64)
    return (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF


def brightness_to_tint(brightness):
    """utils.js:479-483."""
    v = torch.round(clamp01(brightness) * 255.0).to(torch.int64)
    return (v << 16) | (v << 8) | v


def brightness_to_colored_tint(brightness, base_color=0xFFFFFF):
    """utils.js:493-507: a base colour times a clamped brightness."""
    b = clamp01(brightness)
    r, g, bl = unpack_rgb(base_color)
    return pack_rgb(torch.round(r * b), torch.round(g * b), torch.round(bl * b))


def rgb_to_bgr(color):
    """utils.js:566-571."""
    r, g, b = unpack_rgb(color)
    return (b << 16) | (g << 8) | r
