"""step_idle_ms: ms a frame in which the device idles while the host is
inside ``Engine.step``: the idle gaps whose middle lies under the program's
``engine.step`` span or a span inside it, over the spans' traced frames
(``spans.of_run``). Nothing where the program opens no such span."""

from ..spans import of_run

UNIT = "ms"


def read(run):
    s = of_run(run)
    if s is None or not s.has("engine.step"):
        return None
    return 1e3 * s.idle_s("engine.step") / s.frames
