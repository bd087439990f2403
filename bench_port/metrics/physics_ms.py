"""physics_ms: device ms a frame of the operations the program issues inside
its ``ops.physics`` span (the Verlet move, the rebin, the pair pass, the
boundary, the derived properties), over the spans' traced frames
(``spans.of_run``). Nothing where the program opens no such span."""

from ..spans import per_frame_ms

UNIT = "ms"


def read(run):
    return per_frame_ms(run, "ops.physics")
