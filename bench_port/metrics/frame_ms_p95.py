"""frame_ms_p95: the 95th percentile over every frame of the window, each
timed from setting its input to its result read on the host. Only where a
call steps one frame: a call of several frames is no frame's time."""

from ..drive import p95

UNIT = "ms"


def read(run):
    if any(c.frames != 1 for c in run.calls):
        return None
    return p95([(c.t_read - c.t_input) * 1e3 for c in run.calls])
