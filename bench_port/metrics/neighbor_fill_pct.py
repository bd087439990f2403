"""neighbor_fill_pct: the share of the neighbour lists' candidate slots that
hold an accepted neighbour, on the engine's last frame (the last traced
one): the program's ``neighbors_accepted`` counter over the rows times the
candidate row width, ``(2R + 1)^2`` cells of ``cell_capacity`` slots on the
grid, N on the brute-force search. Nothing where the frame builds no lists,
the program has no such counter, or the lists are built per class."""

UNIT = "%"


def read(run):
    if run.trace is None or run.built is None:
        return None
    eng = run.built.engine
    accepted = eng.metrics.get("neighbors_accepted") if eng.metrics else None
    plan = eng._plan
    if accepted is None or plan is None or plan.nbr_specs:
        return None
    accepted = int(accepted)
    if accepted < 0:
        return None
    sp, n = plan.cfg.spatial, eng.world.n_entities
    if sp.method == "bruteforce":
        width = n
    else:
        width = (2 * max(1, sp.max_cell_radius) + 1) ** 2 * sp.cell_capacity
    return 100.0 * accepted / (n * width)
