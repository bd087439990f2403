"""steps_per_s: frames completed and read on the host in the window, over
the window's seconds (the first call's input to the last call's read)."""

from ..drive import frames_of, window_seconds

UNIT = "steps/s"


def read(run):
    return frames_of(run.calls) / window_seconds(run.calls)
