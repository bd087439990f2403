from .mathx import (  # noqa: F401
    DIR_DOWN,
    DIR_LEFT,
    DIR_RIGHT,
    DIR_UP,
    direction_from_angle,
    light_attenuation,
)
