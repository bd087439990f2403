"""prey_lists_ms: device ms a frame of the operations the program issues
inside its ``spatial.Prey`` span (the prey's candidate gather and
acceptance in the per-class lists), over the spans' traced frames
(``spans.of_run``). Nothing where the program opens no such span."""

from ..spans import per_frame_ms

UNIT = "ms"


def read(run):
    return per_frame_ms(run, "spatial.Prey")
