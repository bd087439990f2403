"""device_ops_per_step: device operations in the traced window over its
frames; an exact count."""

UNIT = "ops/step"


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ops / run.trace.frames
