"""Slice C3: collision and screen events of the PyTorch port against the JAX
package on the CPU.

Function by function: ``diff_pairs`` (the Enter/Stay/Exit set difference)
and ``compact_pairs`` (the per-row prefilter, with rows of more than
``PER_ENTITY`` contacts, and the global cap), outputs exact.

Engine by engine: the reference's own bars (``tests/test_round2.py``
``TestChunkedEventGranularity``, ``TestDroppedPairMetric``,
``TestHookAwareEventLog``; ``tests/test_round3.py``
``TestLateHookRegistration``, ``TestEventLogTruncationMetric``,
``TestHookScopedRecording``, ``TestBatchCollisionHooks``,
``TestCrossClassHookOrder``; ``tests/test_round4.py``
``TestDeviceScreenEvents.test_chunked_matches_per_frame``,
``TestEventOverlap``), each run through both packages on the same scene:
every hook call ``(kind, me, other)``, every ``_batch`` call's arrays, the
pair and event tables and the counts must be identical. The three
recording forms (per class, hook-scoped over the global lists, every row)
on a scene with a scan radius of 3 (the 3 x 3 contact subset), a pile of
more than 16 contacts on one row, a pair at exactly the contact distance,
movers, a despawn and a spawn: tables exact each frame.

The small predators scene of ``chip_smoke.py``'s ``[predators_reference]``
(400 prey, 8 predators, 5 lights in 1600 x 1000), with a predator placed on
a prey, events on, started from one world (``world_from_jax``) and run 6
frames at ``event_chunk`` 1 and 3: per step, the event tables, the blood
hook's ``emit_batch`` arguments, the particle pool and the canvas bytes
exact; positions within 4 float32 ulps at the world's extent, the bar of
``tests/test_torch_predators.py`` (XLA:CPU contracts multiply-adds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multithreadedgameengine_tpu as ref
import multithreadedgameengine_tpu_torch as port
from multithreadedgameengine_tpu.ops.events import diff_pairs as ref_diff_pairs
from multithreadedgameengine_tpu.ops.physics import compact_pairs as ref_compact_pairs
from multithreadedgameengine_tpu_torch.interop import world_from_jax
from multithreadedgameengine_tpu_torch.ops.events import diff_pairs
from multithreadedgameengine_tpu_torch.ops.physics import PER_ENTITY, compact_pairs

torch.set_num_threads(2)

PKGS = ("jax", "torch")
POS_ULPS = 4


# ---------------------------------------------------------------------------
# helpers: one scene in either package
# ---------------------------------------------------------------------------

def make_engine(pkg, **cfg):
    if pkg == "jax":
        return ref.Engine(ref.make_config(**cfg))
    return port.Engine(port.make_config(**cfg), device="cpu")


def entity_class(pkg, name, setup, components=("Collider",), **hooks):
    """A class of either package with a fixed ``setup`` and the given hooks
    (plain functions, made static)."""
    mod = ref if pkg == "jax" else port
    ns = {"components": [getattr(mod, c) for c in components], "uses_neighbors": False,
          "setup": classmethod(lambda cls, ctx: dict(setup))}
    ns.update({k: staticmethod(v) for k, v in hooks.items()})
    return type(name, (mod.EntityClass,), ns)


STATIC = {"collider.radius": 10.0, "rigid_body.static": True, "collider.visual_range": 60.0}


def get(eng, a):
    return np.asarray(jax.device_get(a)) if isinstance(eng, ref.Engine) else a.cpu().numpy()


def event_state(eng):
    """The pair table and the three event tables, each cut to its count,
    and the packed screen table, as numpy."""
    w, lg = eng.world, eng.config.logic
    out = {}
    if lg.collision_events:
        for table, count in (("collision_pairs", "collision_pair_count"),
                             ("event_enter", "event_enter_count"),
                             ("event_stay", "event_stay_count"),
                             ("event_exit", "event_exit_count")):
            out[table] = get(eng, getattr(w, table))[:int(get(eng, getattr(w, count)))]
    if lg.screen_events:
        out["screen"] = get(eng, w.screen_events_packed)
    return out


def assert_states_equal(a, b, tag=""):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{tag} {k}")


def metric_ints(eng):
    return {k: int(get(eng, v)) for k, v in eng.metrics.items()}


# ---------------------------------------------------------------------------
# function by function
# ---------------------------------------------------------------------------

def random_pair_table(rng, p, n_entities, count):
    """``count`` unique (a, b) pairs padded to [p, 2] with -1 (tests/test_events.py)."""
    keys = rng.choice(n_entities * n_entities, size=count, replace=False)
    table = np.full((p, 2), -1, np.int32)
    table[:count, 0] = keys // n_entities
    table[:count, 1] = keys % n_entities
    return table


@pytest.mark.parametrize("seed", range(4))
def test_diff_pairs_matches_reference(seed):
    """Random tables, some sharing most pairs: tables and counts exact."""
    rng = np.random.default_rng(seed)
    p, n = 64, 40
    for _trial in range(10):
        n_cur, n_prev = (int(v) for v in rng.integers(0, p + 1, 2))
        cur = random_pair_table(rng, p, n, n_cur)
        if rng.random() < 0.5:
            prev = random_pair_table(rng, p, n, n_prev)
        else:  # most of the current pairs, in another order
            n_prev = min(n_prev, n_cur)
            prev = np.full_like(cur, -1)
            prev[:n_prev] = np.roll(cur[:n_cur], n_cur // 2, axis=0)[:n_prev]
        want = ref_diff_pairs(jnp.asarray(cur), jnp.int32(n_cur), jnp.asarray(prev),
                              jnp.int32(n_prev))
        got = diff_pairs(torch.from_numpy(cur), torch.tensor(n_cur, dtype=torch.int32),
                         torch.from_numpy(prev), torch.tensor(n_prev, dtype=torch.int32))
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["empty", "first_frame", "all_stay", "all_exit"])
def test_diff_pairs_edge_cases(case):
    p = 8
    cur = np.full((p, 2), -1, np.int32)
    prev = np.full((p, 2), -1, np.int32)
    pairs = np.asarray([[1, 2], [1, 7], [3, 4], [0, 9]], np.int32)
    n_cur = n_prev = 0
    if case in ("first_frame", "all_stay"):
        cur[:4], n_cur = pairs, 4
    if case in ("all_stay", "all_exit"):
        prev[:4], n_prev = pairs[::-1], 4
    want = ref_diff_pairs(jnp.asarray(cur), jnp.int32(n_cur), jnp.asarray(prev),
                          jnp.int32(n_prev))
    got = diff_pairs(torch.from_numpy(cur), torch.tensor(n_cur, dtype=torch.int32),
                     torch.from_numpy(prev), torch.tensor(n_prev, dtype=torch.int32))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = {"empty": (0, 0, 0), "first_frame": (4, 0, 0), "all_stay": (0, 4, 0),
         "all_exit": (0, 0, 4)}[case]
    assert (int(got[1]), int(got[3]), int(got[5])) == n


@pytest.mark.parametrize("s,max_pairs,density,row_ids", [
    (40, 500, 0.6, False),   # most rows past PER_ENTITY contacts: the per-row cap drops
    (40, 30, 0.3, False),    # the global cap drops
    (9, 200, 0.5, True),     # fewer slots than PER_ENTITY; rows of a subset
    (576, 4000, 0.05, True),  # the predators' hooked rows after the contact subset
])
def test_compact_pairs_matches_reference(s, max_pairs, density, row_ids):
    """Rows with more than 16 recorded slots keep their first 16 in slot
    order, as ``lax.top_k`` on a 0/1 key returns them: pairs, count and
    dropped exact."""
    rng = np.random.default_rng(s + max_pairs)
    r = 24
    ids = rng.integers(-1, 5000, (r, s)).astype(np.int32)
    rec = (rng.random((r, s)) < density) & (ids >= 0)
    rec[3, :] = ids[3] >= 0  # a full row
    rec[5, :] = False  # an empty one
    rows = np.sort(rng.choice(10_000, r, replace=False)).astype(np.int32) if row_ids else None
    want = ref_compact_pairs(jnp.asarray(ids), jnp.asarray(rec), max_pairs,
                             None if rows is None else jnp.asarray(rows))
    got = compact_pairs(torch.from_numpy(ids), torch.from_numpy(rec), max_pairs,
                        None if rows is None else torch.from_numpy(rows))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 0 or s < PER_ENTITY


# ---------------------------------------------------------------------------
# the reference's engine-level bars, through both packages
# ---------------------------------------------------------------------------

def pair_scene(pkg, chunk, overlap=False, frames=4):
    """``TestChunkedEventGranularity``'s and ``TestEventOverlap``'s scene:
    two overlapping statics with scalar enter and stay hooks."""
    calls = []
    cls = entity_class(pkg, "_Pair", STATIC, ("RigidBody", "Collider", "SpriteRenderer"),
                       on_collision_enter=lambda ctx, me, o: calls.append(("enter", me, o)),
                       on_collision_stay=lambda ctx, me, o: calls.append(("stay", me, o)))
    eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                      spatial=dict(cell_size=50.0, max_neighbors=8),
                      logic=dict(collision_events=True, event_chunk=chunk,
                                 event_overlap=overlap))
    eng.register_entity_class(cls, 2)
    eng.init()
    eng.spawn("_Pair", x=100.0, y=100.0)
    eng.spawn("_Pair", x=110.0, y=100.0)
    eng.step(frames)
    eng.sync()
    return [(k, int(m), int(o)) for k, m, o in calls], eng


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunked_event_granularity(chunk):
    """2 enters and 6 stays over 4 frames at every chunk size, the same
    calls in the same order in both packages."""
    (cj, ej), (ct, et) = (pair_scene(p, chunk) for p in PKGS)
    assert ct == cj
    assert sum(k == "enter" for k, *_ in ct) == 2 and sum(k == "stay" for k, *_ in ct) == 6
    assert et.world.step_count == 4
    assert_states_equal(event_state(ej), event_state(et))


def test_event_overlap_same_events_same_order():
    """``TestEventOverlap``: with the double-buffered log every call fires,
    in the order of the run without it, in both packages."""
    runs = {(p, o): pair_scene(p, 3, overlap=o, frames=10)[0] for p in PKGS for o in (False, True)}
    assert runs[("jax", False)]
    assert len(set(map(tuple, runs.values()))) == 1


def test_dropped_pair_metric():
    """``TestDroppedPairMetric``: 8 statics in a pile, a 4-row pair table."""
    out = {}
    for pkg in PKGS:
        cls = entity_class(pkg, "_Pair", STATIC, ("RigidBody", "Collider", "SpriteRenderer"))
        eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                          spatial=dict(cell_size=50.0, max_neighbors=64),
                          physics=dict(max_collision_pairs=4),
                          logic=dict(collision_events=True))
        eng.register_entity_class(cls, 8)
        eng.init()
        for k in range(8):
            eng.spawn("_Pair", x=100.0 + k, y=100.0)
        eng.step(1)
        out[pkg] = (metric_ints(eng), event_state(eng))
    (mj, sj), (mt, st) = out["jax"], out["torch"]
    assert mt["collision_pair_count"] == mj["collision_pair_count"] == 4
    assert mt["collision_pairs_dropped"] == mj["collision_pairs_dropped"] == 24
    assert_states_equal(sj, st)


def test_hook_aware_event_log_logged_coords():
    """``TestHookAwareEventLog``: only a stay hook; Enter/Exit log one-row
    placeholders, and the stay hooks see each frame's participant
    positions from the log. Ids exact; positions within the ulp bar."""
    out = {}
    for pkg in PKGS:
        fired = []
        cls = entity_class(pkg, "Blob", {"collider.radius": 10.0, "collider.visual_range": 50.0},
                           ("RigidBody", "Collider"),
                           on_collision_stay=lambda ctx, me, o: fired.append(
                               (int(me), int(o), float(ctx.x[o]), float(ctx.y[o]))))
        eng = make_engine(pkg, world_width=500.0, world_height=500.0, seed=3,
                          spatial=dict(cell_size=25.0, max_neighbors=16, cell_capacity=8),
                          physics=dict(max_collision_pairs=64, gravity=(0.0, 0.0)),
                          logic=dict(collision_events=True, event_chunk=4))
        eng.register_entity_class(cls, 8)
        eng.init()
        for k in range(4):
            eng.spawn("Blob", x=100.0 + k * 12.0, y=100.0)
        eng.step(8)
        eng.sync()
        out[pkg] = fired
    assert out["jax"] and [f[:2] for f in out["torch"]] == [f[:2] for f in out["jax"]]
    tol = POS_ULPS * float(np.spacing(np.float32(500.0)))
    np.testing.assert_allclose(np.asarray([f[2:] for f in out["torch"]]),
                               np.asarray([f[2:] for f in out["jax"]]), rtol=0, atol=tol)


def test_late_hook_registration_fires():
    """``TestLateHookRegistration``: a stay hook added after the first chunk
    re-plans and fires 4 frames x 2 sides."""
    counts = {}
    for pkg in PKGS:
        calls = []
        cls = entity_class(pkg, "_LateHook", STATIC)
        eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                          spatial=dict(cell_size=50.0, max_neighbors=8),
                          logic=dict(collision_events=True, event_chunk=4))
        eng.register_entity_class(cls, 2)
        eng.init()
        eng.spawn("_LateHook", x=100.0, y=100.0)
        eng.spawn("_LateHook", x=110.0, y=100.0)
        eng.step(4)
        before = len(calls)
        cls.on_collision_stay = staticmethod(lambda ctx, me, o: calls.append((int(me), int(o))))
        eng.step(4)
        counts[pkg] = (before, calls)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][0] == 0 and len(counts["torch"][1]) == 8


def test_event_log_truncation_metric():
    """``TestEventLogTruncationMetric``: 28 stay pairs a frame past a log cap
    of 4 surface as ``event_rows_dropped``, the same in both packages."""
    out = {}
    for pkg in PKGS:
        calls = []
        cls = entity_class(pkg, "_Piler", STATIC,
                           on_collision_stay=lambda ctx, me, o: calls.append((int(me), int(o))))
        eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                          spatial=dict(cell_size=50.0, max_neighbors=16),
                          logic=dict(collision_events=True, event_chunk=3,
                                     max_events_per_frame=4))
        eng.register_entity_class(cls, 8)
        eng.init()
        for k in range(8):
            eng.spawn("_Piler", x=100.0 + k * 2.0, y=100.0)
        eng.step(6)
        out[pkg] = (metric_ints(eng)["event_rows_dropped"], calls)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 3 * (28 - 4)


HOOKED_CASES = {
    "hooked_side_only": (dict(), (("_HookedBlob", 100.0, 100.0), ("_PlainBlob", 110.0, 100.0),
                                  ("_PlainBlob", 110.0, 115.0))),
    "hooked_row_larger": (dict(), (("_PlainBlob", 110.0, 100.0), ("_HookedBlob", 100.0, 100.0))),
    "record_all_pairs": (dict(record_all_pairs=True), (
        ("_HookedBlob", 300.0, 300.0), ("_PlainBlob", 110.0, 100.0), ("_PlainBlob", 110.0, 115.0))),
    "no_hooks": (dict(), (("_PlainBlob", 110.0, 100.0), ("_PlainBlob", 110.0, 115.0))),
}


@pytest.mark.parametrize("case", list(HOOKED_CASES))
def test_hook_scoped_recording(case):
    """``TestHookScopedRecording``: a hooked and a plain class; recording
    from the hooked side only, or from every row with ``record_all_pairs``
    or without hooks. Pair tables and hook calls exact."""
    logic, spawns = HOOKED_CASES[case]
    out = {}
    for pkg in PKGS:
        calls = []
        hooks = ({} if case == "no_hooks" else
                 dict(on_collision_stay=lambda ctx, me, o: calls.append((int(me), int(o)))))
        hooked = entity_class(pkg, "_HookedBlob", STATIC, **hooks)
        plain = entity_class(pkg, "_PlainBlob", STATIC)
        eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                          spatial=dict(cell_size=50.0, max_neighbors=16),
                          logic=dict(collision_events=True, **logic))
        eng.register_entity_class(hooked, 4)
        eng.register_entity_class(plain, 4)
        eng.init()
        ids = [eng.spawn(name, x=x, y=y) for name, x, y in spawns]
        eng.step(2)
        out[pkg] = (ids, calls, event_state(eng))
    (ij, cj, sj), (it, ct, st) = out["jax"], out["torch"]
    assert it == ij and ct == cj
    assert_states_equal(sj, st)
    pairs = {tuple(p) for p in st["collision_pairs"]}
    if case == "hooked_side_only":
        h, p1, p2 = it
        assert (h, p1) in pairs and not any({a, b} == {p1, p2} for a, b in pairs) and ct
    elif case == "hooked_row_larger":
        assert any(set(p) == set(it) for p in pairs) and ct
    else:
        assert (min(it[-2:]), max(it[-2:])) in pairs


def batch_scene(pkg, **hooks):
    """``TestBatchCollisionHooks``' scene: one contact and a third entity
    far away, chunks of 4."""
    cls = entity_class(pkg, "_H", STATIC, **hooks)
    eng = make_engine(pkg, world_width=500.0, world_height=500.0,
                      spatial=dict(cell_size=50.0, max_neighbors=8),
                      logic=dict(collision_events=True, event_chunk=4),
                      physics=dict(gravity=(0.0, 0.0)))
    eng.register_entity_class(cls, 8)
    eng.init()
    for x, y in ((100.0, 100.0), (110.0, 100.0), (300.0, 300.0)):
        eng.spawn("_H", x=x, y=y)
    eng.step(4)
    eng.sync()
    return eng


def test_batch_hook_receives_both_orientations_in_order():
    out = {}
    for pkg in PKGS:
        calls = []
        batch_scene(pkg, on_collision_enter_batch=lambda ctx, me, o: calls.append(
            (np.asarray(me).tolist(), np.asarray(o).tolist())))
        out[pkg] = calls
    assert out["torch"] == out["jax"] and len(out["torch"]) == 1
    me, other = out["torch"][0]
    assert me == sorted(me) and other == me[::-1]


@pytest.mark.parametrize("batch", [False, True], ids=["scalar", "batch"])
def test_batch_and_scalar_hooks_see_the_same_rows(batch):
    rows = {}
    for pkg in PKGS:
        got = []
        if batch:
            hooks = dict(on_collision_stay_batch=lambda ctx, me, o: got.extend(
                zip(np.asarray(me).tolist(), np.asarray(o).tolist())))
        else:
            hooks = dict(on_collision_stay=lambda ctx, me, o: got.append((int(me), int(o))))
        batch_scene(pkg, **hooks)
        rows[pkg] = [tuple(r) for r in got]
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 6


def test_cross_class_hook_order():
    """``TestCrossClassHookOrder``: two scalar-hooked classes fire in table
    order, both orientations of a pair next to each other."""
    logs = {}
    for pkg in PKGS:
        log = []
        hook = dict(on_collision_enter=lambda ctx, me, o: log.append((int(me), int(o))))
        eng = make_engine(pkg, world_width=900.0, world_height=300.0,
                          spatial=dict(cell_size=50.0, max_neighbors=8),
                          logic=dict(collision_events=True, event_chunk=2),
                          physics=dict(gravity=(0.0, 0.0)))
        eng.register_entity_class(entity_class(pkg, "A", STATIC, **hook), 4)
        eng.register_entity_class(entity_class(pkg, "B", STATIC, **hook), 4)
        eng.init()
        for name, x in (("A", 100.0), ("B", 110.0), ("A", 500.0), ("B", 510.0)):
            eng.spawn(name, x=x, y=100.0)
        eng.step(2)
        eng.sync()
        logs[pkg] = log
    log = logs["torch"]
    assert log == logs["jax"] and len(log) == 4
    assert log[0] == log[1][::-1] and log[2] == log[3][::-1] and set(log[0]) != set(log[2])


def test_predator_batch_hook_spawns_blood():
    """``test_predator_batch_hook_spawns_blood``: a predator spawned on a
    prey; its batch hook's blood lands in the pool, the same particles in
    both packages."""
    from multithreadedgameengine_tpu.models.predators import make_predators_engine as ref_make
    from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine

    pools = {}
    for pkg, make in (("jax", ref_make), ("torch", make_predators_engine)):
        kw = {} if pkg == "jax" else dict(device="cpu")
        eng = make(n_prey=24, n_predators=2, n_lights=1, spawn=False,
                   logic=dict(collision_events=True, event_chunk=2),
                   particle=dict(max_particles=512), **kw)
        eng.spawn("Prey", x=500.0, y=500.0)
        eng.spawn("Predator", x=505.0, y=500.0)
        for _ in range(3):
            eng.step(2)
        eng.sync()
        pools[pkg] = {f.name: get(eng, getattr(eng.world.particles, f.name))
                      for f in dataclasses.fields(eng.world.particles)}
    assert pools["torch"]["active"].sum() > 0
    for name, v in pools["jax"].items():
        np.testing.assert_array_equal(pools["torch"][name], v, err_msg=name)


def screen_scene(pkg, chunk, frames=24):
    """``TestDeviceScreenEvents``' scene: a drifter enters the screen and
    leaves it; radius 20 rather than 5, so the plain pair pass on the CPU
    walks a solver grid 16 times smaller. Returns the hook calls and the
    packed table after each frame (per-frame runs only)."""
    events, packed = [], []
    cls = entity_class(pkg, "Drifter", {"collider.radius": 20.0, "rigid_body.max_vel": 500.0},
                       ("RigidBody", "Collider", "SpriteRenderer"),
                       on_screen_enter=lambda i: events.append(("enter", int(i))),
                       on_screen_exit=lambda i: events.append(("exit", int(i))))
    eng = make_engine(pkg, canvas_width=400, canvas_height=300,
                      world_width=4000.0, world_height=600.0,
                      logic=dict(screen_events=True, event_chunk=chunk),
                      physics=dict(gravity=(0.0, 0.0), max_collision_pairs=1))
    eng.register_entity_class(cls, 6)
    eng.init()
    eng.input.camera_x = 200.0
    eng.input.camera_y = 150.0
    eng.spawn("Drifter", x=100.0, y=150.0, vx=40.0)
    eng.spawn("Drifter", x=-600.0, y=150.0, vx=40.0)
    if chunk > 1:
        eng.step(frames)
    else:
        for _ in range(frames):
            eng.step(1)
            packed.append(event_state(eng)["screen"])
    eng.sync()
    return events, packed


def test_screen_events_chunked_matches_per_frame():
    """``TestDeviceScreenEvents.test_chunked_matches_per_frame`` in both
    packages, with the packed table of every frame exact."""
    (ej, pj), (et, pt) = (screen_scene(p, 1) for p in PKGS)
    assert et == ej and any(k == "enter" for k, _ in et) and any(k == "exit" for k, _ in et)
    for f, (a, b) in enumerate(zip(pj, pt)):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {f}")
    assert screen_scene("torch", 8)[0] == et


# ---------------------------------------------------------------------------
# the three recording forms on one scene
# ---------------------------------------------------------------------------

FORMS = {
    "per_class": dict(per_class=True, logic=dict()),
    "hook_scoped": dict(per_class=False, logic=dict()),
    "record_all_pairs": dict(per_class=True, logic=dict(record_all_pairs=True)),
    "no_hooks": dict(per_class=True, logic=dict(), hooks=False),
}


def forms_scene(pkg, per_class, logic, hooks=True, frames=5):
    """Scan radius 3 (a hooked class with visual range 150 in cells of 50,
    capacity 8: 392 candidate slots, 72 after the contact subset), a pile
    of 24 plain statics on one hooked static (more than PER_ENTITY
    contacts on its row), a pair at exactly the contact distance (22 = 12
    + 10, not recorded), 8 movers crossing hooked statics, a despawn after
    frame 2 (Exit) and a spawn on a hooked static (Enter)."""
    calls = []
    hk = {} if not hooks else {
        f"on_collision_{k}": (lambda k: lambda ctx, me, o: calls.append((k, int(me), int(o))))(k)
        for k in ("enter", "stay", "exit")}
    hooked = entity_class(pkg, "Hk", {"collider.radius": 12.0, "rigid_body.static": True,
                                      "collider.visual_range": 150.0}, **hk)
    plain = entity_class(pkg, "Pl", {"collider.radius": 10.0, "rigid_body.static": True,
                                     "collider.visual_range": 40.0})
    mover = entity_class(pkg, "Mv", {"collider.radius": 8.0, "collider.visual_range": 40.0},
                         ("RigidBody", "Collider"))
    eng = make_engine(pkg, world_width=600.0, world_height=400.0,
                      spatial=dict(cell_size=50.0, max_neighbors=64, cell_capacity=8,
                                   per_class_assembly=per_class),
                      physics=dict(gravity=(0.0, 0.0), max_collision_pairs=256),
                      logic=dict(collision_events=True, **logic))
    eng.register_entity_class(hooked, 8)
    eng.register_entity_class(plain, 40)
    eng.register_entity_class(mover, 8)
    eng.init()
    rng = np.random.default_rng(7)
    for x, y in ((200.0, 200.0), (400.0, 100.0), (100.0, 300.0), (500.0, 300.0)):
        eng.spawn("Hk", x=x, y=y)
    ang, rad = rng.uniform(0, 2 * np.pi, 24), rng.uniform(0, 20, 24)
    pile = [eng.spawn("Pl", x=float(200 + r * np.cos(a)), y=float(200 + r * np.sin(a)))
            for a, r in zip(ang.astype(np.float32), rad.astype(np.float32))]
    eng.spawn("Pl", x=422.0, y=100.0)  # exactly at the contact distance
    eng.spawn("Pl", x=100.0, y=318.0)  # in contact
    for k in range(8):
        eng.spawn("Mv", x=60.0 + 70.0 * k, y=300.0 if k % 2 else 100.0,
                  vx=3.0 if k % 2 else -3.0, vy=0.5)
    states = []
    for f in range(frames):
        if f == 2:
            eng.despawn(pile[0])
            eng.spawn("Pl", x=505.0, y=300.0)
        eng.step(1)
        states.append((event_state(eng), metric_ints(eng)))
    return calls, states, eng


@pytest.mark.parametrize("form", list(FORMS))
def test_recording_forms_match_reference(form):
    """Per frame: the pair table, the Enter/Stay/Exit tables, the pair
    count and the dropped count exact, and the hook calls identical."""
    (cj, sj, ej), (ct, st, et) = (forms_scene(p, **FORMS[form]) for p in PKGS)
    plan = et._plan
    assert plan.scope_hooked == (form in ("per_class", "hook_scoped"))
    assert bool(plan.nbr_specs) == (form == "per_class")
    assert ct == cj
    for f, ((a, ma), (b, mb)) in enumerate(zip(sj, st)):
        assert_states_equal(a, b, f"frame {f}")
        for key in ("collision_pair_count", "collision_pairs_dropped"):
            assert mb[key] == ma[key], (f, key)
    assert any(m["collision_pairs_dropped"] > 0 for _s, m in st)  # the pile's row
    assert sum(len(s["event_exit"]) for s, _m in st) > 0
    exact = (et.classes["Hk"].start_index + 1, et.classes["Pl"].start_index + 24)
    for s, _m in st:
        assert not any(set(p) == set(exact) for p in s["collision_pairs"].tolist())


# ---------------------------------------------------------------------------
# the small predators scene with events on
# ---------------------------------------------------------------------------

PRED_SCENE = dict(n_prey=400, n_predators=8, n_lights=5, world_width=1600.0,
                  world_height=1000.0)
PRED_FRAMES = 6


def predators_events_engine(pkg, chunk):
    """The ``[predators_reference]`` scene with events on, spawned as
    ``make_predators_engine`` spawns it but with the first predator 5 px
    from the first prey, so contacts exist from the first frame."""
    if pkg == "jax":
        from multithreadedgameengine_tpu.models.predators import make_predators_engine as make
        kw = {}
    else:
        from multithreadedgameengine_tpu_torch.models.predators import make_predators_engine as make
        kw = dict(device="cpu")
    eng = make(spawn=False, logic=dict(collision_events=True, event_chunk=chunk),
               **PRED_SCENE, **kw)
    w, h = eng.config.world_width, eng.config.world_height
    first = None
    for name in ("Prey", "Predator", "TallLight"):
        for _ in range(PRED_SCENE[{"Prey": "n_prey", "Predator": "n_predators",
                                   "TallLight": "n_lights"}[name]]):
            x, y = eng.rng() * w, eng.rng() * h
            if name == "Prey" and first is None:
                first = (x, y)
            elif name == "Predator" and first is not None:
                (x, y), first = (first[0] + 5.0, first[1]), None
            eng.spawn(name, x=x, y=y)
    eng.input.camera_x, eng.input.camera_y, eng.input.camera_zoom = 0.0, 0.0, 0.3
    emits = []
    emit = eng.emitter.emit_batch

    def recording_emit(**kw):
        emits.append({k: (np.asarray(v).tolist() if k in ("x", "y") else v)
                      for k, v in kw.items()})
        return emit(**kw)

    eng.emitter.emit_batch = recording_emit
    return eng, emits


@pytest.fixture(scope="module", params=[1, 3], ids=["chunk1", "chunk3"])
def predator_runs(request):
    chunk = request.param
    (ej, emits_j), (et, emits_t) = (predators_events_engine(p, chunk) for p in PKGS)
    ej._flush_pending()
    et.restore(world_from_jax(jax.device_get(ej.world), "cpu"))
    steps = []
    for _ in range(PRED_FRAMES // chunk):
        for e in (ej, et):
            e.step(chunk)
        a = world_from_jax(jax.device_get(ej.world), "cpu")
        steps.append((event_state(ej), event_state(et), list(emits_j), list(emits_t), a,
                      et.snapshot(), metric_ints(ej), metric_ints(et)))
    return chunk, et, steps


def test_predators_events_tables_and_emissions_exact(predator_runs):
    chunk, et, steps = predator_runs
    assert et._plan.scope_hooked
    for k, (sj, st, emj, emt, _a, _b, mj, mt) in enumerate(steps):
        assert_states_equal(sj, st, f"step {k}")
        assert emt == emj, k
        for key in ("collision_pair_count", "collision_pairs_dropped", "active_particles",
                    "n_binned", "active_count"):
            assert mt[key] == mj[key], (k, key)
    assert steps[-1][3], "the blood hook never fired"
    assert sum(len(s[1]["event_stay"]) for s in steps) > 0


def test_predators_events_pool_canvas_positions(predator_runs):
    chunk, _et, steps = predator_runs
    tol = POS_ULPS * float(np.spacing(np.float32(1600.0)))
    for k, (*_s, a, b, _mj, _mt) in enumerate(steps):
        for f in dataclasses.fields(a.particles):
            assert torch.equal(getattr(a.particles, f.name), getattr(b.particles, f.name)), \
                (k, f.name)
        assert torch.equal(a.decal_canvas, b.decal_canvas), k
        for u, v in ((a.transform.x, b.transform.x), (a.transform.y, b.transform.y)):
            np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=0, atol=tol)
    assert int(steps[-1][5].particles.active.sum()) > 0


# ---------------------------------------------------------------------------
# the refusals that stay
# ---------------------------------------------------------------------------

def test_halo_step_refuses_events_naming_item_14():
    """Collision events run under the slab steps since slice E2
    (``tests/test_torch_halo_mixed.py``); screen events stay refused by both:
    the reference's slab steps compute none, and an empty table handed back
    would lose every transition (ROADMAP §3, a kept difference)."""
    from multithreadedgameengine_tpu_torch.models.balls import make_balls_engine
    from multithreadedgameengine_tpu_torch.parallel import (
        make_halo_step,
        make_homed_step,
        make_mesh,
    )

    eng = make_balls_engine(n_balls=255, seed=1, device="cpu", world_width=800.0,
                            world_height=600.0, logic=dict(screen_events=True))
    for make in (make_halo_step, make_homed_step):
        with pytest.raises(NotImplementedError, match="screen_events under the halo and homed"):
            make(eng, make_mesh(4, "cpu"))
    eng = make_balls_engine(n_balls=255, spawn=True, seed=1, device="cpu", world_width=800.0,
                            world_height=600.0, logic=dict(collision_events=True))
    eng._flush_pending()
    step, place = make_halo_step(eng, make_mesh(4, "cpu"))
    chunks, metrics = step(place(eng.world), eng.input.snapshot("cpu"))
    assert int(metrics["active_count"]) == 256
