"""setup_s: seconds from the process's start to the first timed frame:
imports, the kernels' build or load, the scene spawned from the seed, and
the warm-up calls."""

UNIT = "s"


def read(run):
    return run.setup_s
