"""event_log_ms: device ms a frame of the operations the program issues
inside its ``engine.event_log`` span (each frame's write of the chunked
event log, and the chunk's copy to the host), over the spans' traced frames
(``spans.of_run``). Nothing where the program opens no such span."""

from ..spans import per_frame_ms

UNIT = "ms"


def read(run):
    return per_frame_ms(run, "engine.event_log")
