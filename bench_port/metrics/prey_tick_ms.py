"""prey_tick_ms: device ms a frame of the operations the program issues
inside its ``behavior.Prey`` span (the prey's tick), over the spans' traced
frames (``spans.of_run``). Nothing where the program opens no such span."""

from ..spans import per_frame_ms

UNIT = "ms"


def read(run):
    return per_frame_ms(run, "behavior.Prey")
