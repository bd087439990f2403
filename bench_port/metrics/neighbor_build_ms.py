"""neighbor_build_ms: ``ops.spatial.neighbor_lists`` alone on the cell's
last world, with the payload the boids' ticks read: device ms a build, the
sum of its operations' device time over 20 builds under the profiler (as
``torch_profile.py`` profiles the build). Nothing where the frame builds no
lists."""

from ..trace import device_seconds

UNIT = "ms"


def read(run):
    if run.built is None:
        return None
    eng = run.built.engine
    if eng.device.type != "cuda" or eng._plan is None or not eng._plan.need_neighbors:
        return None
    from multithreadedgameengine_tpu_torch.ops.spatial import neighbor_lists

    w, cfg = eng.world, eng.config
    t, c, rb = w.transform, w.collider, w.rigid_body
    extras = (rb.vx, rb.vy, t.entity_type)
    return 1e3 * device_seconds(
        lambda: neighbor_lists(t.x, t.y, t.active, c.visual_range, cfg, extras), 20)
