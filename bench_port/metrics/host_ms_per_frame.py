"""host_ms_per_frame: the host's time inside ``Engine.step`` over the
window's frames, the read after it left out: what the host spends issuing a
frame."""

UNIT = "ms"


def read(run):
    return 1e3 * sum(c.t_step - c.t_call for c in run.calls) / sum(c.frames for c in run.calls)
