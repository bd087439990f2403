"""lists_fill_pct: the share of the per-class neighbour lists' candidate
slots that hold an accepted neighbour, on the engine's last frame (the last
traced one): the program's ``neighbors_accepted`` counter over the plan's
candidate slots (:func:`slots`). Nothing where the frame builds no
per-class lists or the program has no such counter."""

UNIT = "%"


def slots(plan) -> int:
    """Each class's rows times ``(2r + 1)^2`` cells of ``cell_capacity``
    slots at its own scan radius ``r``, summed over the plan's lists; 0
    without per-class lists."""
    specs = getattr(plan, "nbr_specs", None) or ()
    cap = plan.cfg.spatial.cell_capacity if specs else 0
    return sum(count * (2 * r + 1) ** 2 * cap for _name, _start, count, r in specs)


def read(run):
    if run.trace is None or run.built is None:
        return None
    eng = run.built.engine
    accepted = eng.metrics.get("neighbors_accepted") if eng.metrics else None
    n = slots(eng._plan) if eng._plan is not None else 0
    if accepted is None or not n:
        return None
    accepted = int(accepted)
    if accepted < 0:
        return None
    return 100.0 * accepted / n
