"""Elementwise math of src/core/utils.js that the ported scenes use.

PyTorch counterpart of ``direction_from_angle`` and ``light_attenuation`` in
``multithreadedgameengine_tpu/utils/mathx.py:39-56``. The reference's
constants are Python floats that meet float32 arrays as weak types, so it
compares and adds them as float32; here they are rounded to float32 once,
which gives the same values.
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
