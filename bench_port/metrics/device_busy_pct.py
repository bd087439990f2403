"""device_busy_pct: the share of the traced window in which some device
operation (kernel, copy or set) ran: the union of their intervals."""

UNIT = "%"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.busy_s / run.trace.window_s
