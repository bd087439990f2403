"""The boid tick (``ops.cuda_kernels.boid_tick``, ``csrc/boid_tick.cu``):
its plain version against ``Boid.tick``'s composition as it was before the
kernel (``flocking_forces``, ``avoid_mouse_force`` and
``keep_within_bounds_force`` over a ``TickCtx``), bit for bit, and the
wrapper's checks, on the CPU; the kernel against the plain version on the
card (marked ``cuda``, skipped without one:
``python -m pytest tests/test_torch_boid_tick.py -m cuda --noconftest -q``).

Tolerances, each with its reason:
- the plain version against the composition: bit for bit (the same
  operations in the same order);
- the kernel against the plain version on scenes whose sums are exact in
  float32 in any order (positions in eighths, velocities in sixteenths, d2
  powers of two): bit for bit, since every other operation is the plain
  version's, rounded alike (``--fmad=false``, IEEE division);
- on any other scene only the order in which each row's sums add their
  terms differs from ``torch.sum``. Each side's sum of ``n`` terms lies
  within ``(n - 1) u sum|t|`` of the exact one (``u = 2^-24``), and the
  eight or so operations after the sums round alike up to an ulp of their
  magnitudes, so a row's ``ax`` may differ by ``(S + 8) 2^-22 M``, ``M``
  the sum of the magnitudes that make it up (:func:`torch_scenes.boid_order_tolerance`).
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from torch_scenes import boid_order_tolerance, mouse_inputs

from multithreadedgameengine_tpu_torch import Engine, make_config
from multithreadedgameengine_tpu_torch.behavior import TickCtx
from multithreadedgameengine_tpu_torch.models.boids import (
    FLOCKING_FIELDS,
    Boid,
    avoid_mouse_force,
    flocking_forces,
    keep_within_bounds_force,
)
from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import boid_tick, boid_tick_plain

WORLD = (1200.0, 800.0)
#: payload channels as the engine's payload plan lays them out: id, x, y,
#: then Boid.neighbor_fields' vx, vy and entity type
CHANNELS = {"transform.x": 1, "transform.y": 2, "rigid_body.vx": 3, "rigid_body.vy": 4,
            "transform.entity_type": 5}
#: rows of :func:`scene` with a fixed role
MARGIN_ROWS = {0: (5.0, None), 1: (WORLD[0] - 5.0, None), 2: (None, 5.0),
               3: (None, WORLD[1] - 5.0), 4: (5.0, 5.0)}  # inside each margin, a corner
EMPTY_ROWS = (5, 6)            # no neighbour at all
MOUSE_ROWS = (7, 8, 9, 10)     # the mouse (id 0) in the list
MOUSE_ZERO_D2_ROW = 11         # the mouse in the list at d2 0


def scene(seed, count=96, slots=64, exact=False, device="cpu"):
    """A tick's inputs: ``count`` rows of ``slots`` slots in cells of 8
    whose live slots form a prefix (-1 after, payload junk and NaN there);
    500 entities, id 0 the mouse (type 0), the rest of types 1 and 2, so
    every row has same-type and other-type neighbours; d2 drawn apart from
    the positions, a third of it inside the protected range, some exactly
    0 and some at the range. ``exact``: values whose sums are exact in
    float32 in any order. Returns (payload, ids, d2, own, flock, world row
    0's x and y)."""
    rng = np.random.default_rng(seed)
    n_ent, W, H = 500, WORLD[0], WORLD[1]
    ex, ey = rng.uniform(0, W, n_ent), rng.uniform(0, H, n_ent)
    evx, evy = rng.uniform(-3, 3, n_ent), rng.uniform(-3, 3, n_ent)
    etype = rng.integers(1, 3, n_ent)
    etype[0] = 0
    x, y = rng.uniform(0, W, count), rng.uniform(0, H, count)
    for r, (mx, my) in MARGIN_ROWS.items():
        x[r] = x[r] if mx is None else mx
        y[r] = y[r] if my is None else my
    vx, vy = rng.uniform(-3, 3, count), rng.uniform(-3, 3, count)
    if exact:
        ex, ey, x, y = (np.round(a * 8) / 8 for a in (ex, ey, x, y))
        evx, evy, vx, vy = (np.round(a * 16) / 16 for a in (evx, evy, vx, vy))

    ids = np.full((count, slots), -1, np.int64)
    for r in range(count):
        if r in EMPTY_ROWS:
            continue
        live = [c * 8 + k for c in range(slots // 8) for k in range(rng.integers(0, 7))]
        ids[r, live] = rng.choice(np.arange(1, n_ent), len(live), replace=False)
        if r in MOUSE_ROWS + (MOUSE_ZERO_D2_ROW,) and live:
            ids[r, live[0]] = 0
    live = ids >= 0
    if exact:
        d2 = rng.choice([64.0, 256.0, 512.0, 1024.0, 4096.0, 8192.0], ids.shape)
    else:
        d2 = np.where(rng.random(ids.shape) < 0.35, rng.uniform(1, 400, ids.shape),
                      rng.uniform(400, 10000, ids.shape))
        d2[rng.random(ids.shape) < 0.03] = 400.0  # at the protected range: not separated
    d2[rng.random(ids.shape) < 0.03] = 0.0
    d2[MOUSE_ROWS[0], ids[MOUSE_ROWS[0]] >= 0] = 0.0  # a row whose every neighbour is at 0
    d2[MOUSE_ZERO_D2_ROW, ids[MOUSE_ZERO_D2_ROW] == 0] = 0.0
    d2 = np.where(live, d2, 0.0)

    safe = np.clip(ids, 0, None)
    junk = rng.uniform(-1e4, 1e4, ids.shape)
    junk[rng.random(ids.shape) < 0.1] = np.nan
    chan = [np.where(live, v[safe], junk) for v in (ex, ey, evx, evy, etype)]
    payload = np.stack([ids.astype(np.float64)] + chan, axis=-1)

    flock = {
        "protected_range": rng.choice([16.0, 20.0, 24.0], count),
        "centering_factor": rng.choice([0.001, 0.002], count),
        "avoid_factor": rng.choice([0.3, 0.25], count),
        "matching_factor": rng.choice([0.1, 0.05], count),
        "turn_factor": rng.choice([0.01, 0.02], count),
        "margin": rng.choice([20.0, 30.0], count),
    }

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    own = (f32(x), f32(y), f32(vx), f32(vy), f32(rng.uniform(-0.1, 0.1, count)),
           f32(rng.uniform(-0.1, 0.1, count)),
           torch.as_tensor(rng.integers(1, 3, count), dtype=torch.int32, device=device))
    return (f32(payload), torch.as_tensor(ids, dtype=torch.int32, device=device), f32(d2), own,
            [f32(flock[f]) for f in FLOCKING_FIELDS], (f32(ex[0] + 3.0), f32(ey[0] - 2.0)))


def tick_ctx(sc, inputs, dt_ratio):
    """The ``TickCtx`` ``run_logic_phase`` would hand the boids' tick."""
    payload, ids, d2, own, flock, (px, py) = sc
    x, y, vx, vy, ax, ay, etype = own
    view = {"transform": NS(x=x, y=y, entity_type=etype),
            "rigid_body": NS(vx=vx, vy=vy, ax=ax, ay=ay),
            "flocking": NS(**dict(zip(FLOCKING_FIELDS, flock)))}
    world = NS(transform=NS(x=px.reshape(1), y=py.reshape(1)))
    cfg = NS(world_width=WORLD[0], world_height=WORLD[1])
    cnt = (ids >= 0).sum(1, dtype=torch.int32)
    return TickCtx(torch.arange(ids.shape[0], dtype=torch.int32), world, ids, d2, cnt, inputs,
                   dt_ratio, cfg, neighbor_payload=payload, payload_channels=CHANNELS,
                   self_view=view)


def pre_kernel_tick(ctx):
    """``Boid.tick`` as it was before the kernel (boid.js:116-125)."""
    fx, fy, _aux = flocking_forces(ctx)
    mx, my = avoid_mouse_force(ctx)
    bx, by = keep_within_bounds_force(ctx)
    return {"rigid_body.ax": ctx.ax + fx + mx + bx, "rigid_body.ay": ctx.ay + fy + my + by}


def tick_args(sc, inputs, dt_ratio, gathered=False):
    """``boid_tick``'s arguments from a scene: the neighbour columns as
    payload channel views, or as gathered contiguous columns."""
    payload, ids, d2, own, flock, (px, py) = sc
    cols = [payload[..., CHANNELS[p]] for p in Boid.neighbor_fields]
    if gathered:
        cols = [c.contiguous() for c in cols]
    return (ids, d2, cols, own, flock, (inputs.mouse_buttons[0], inputs.mouse_x, px, py),
            dt_ratio, WORLD)


MOUSE_CASES = [(True, 600.0), (False, 600.0), (True, 0.0)]


@pytest.mark.parametrize("down,mouse_x", MOUSE_CASES, ids=["held", "up", "x0"])
@pytest.mark.parametrize("seed,dt,exact", [(0, 1.0, False), (1, 0.75, False), (2, 1.0, True)])
def test_boid_tick_equals_pre_kernel_composition(seed, dt, exact, down, mouse_x):
    """``Boid.tick`` (now ``boid_tick``, the plain version on the CPU) gives
    the pre-kernel composition's ax and ay bit for bit: margins, empty rows,
    gaps, same- and other-type neighbours, separated ones, d2 at 0 and at
    the range, the mouse in and out of the lists, its button up and down."""
    sc = scene(seed, exact=exact)
    ctx = tick_ctx(sc, mouse_inputs(down, mouse_x), dt)
    want = pre_kernel_tick(ctx)
    got = Boid.tick(ctx)
    for k in ("rigid_body.ax", "rigid_body.ay"):
        assert torch.equal(got[k], want[k]), k
    ax, ay = boid_tick_plain(*tick_args(sc, ctx.inputs, dt, gathered=True))
    assert torch.equal(ax, want["rigid_body.ax"]) and torch.equal(ay, want["rigid_body.ay"])
    # every force takes part somewhere in the scene
    fx, _fy, aux = flocking_forces(ctx)
    mx, _my = avoid_mouse_force(ctx)
    bx, by = keep_within_bounds_force(ctx)
    assert bool((bx != 0).any()) and bool((by != 0).any())
    assert bool(((aux.d2 > 0) & ~aux.hook_mask & (sc[1] > 0)).any())  # separated neighbours
    assert bool((mx != 0).any()) == (down and mouse_x != 0)
    assert torch.equal(want["rigid_body.ax"][list(EMPTY_ROWS)],
                       (ctx.ax + bx)[list(EMPTY_ROWS)])


def boids_engine(n=300):
    eng = Engine(make_config(world_width=WORLD[0], world_height=WORLD[1], seed=123456,
                             spatial=dict(cell_size=50.0, max_neighbors=400, cell_capacity=32),
                             physics=dict(sub_step_count=1)), device="cpu")
    eng.register_entity_class(Boid, n - 1)
    eng.init()
    rng = np.random.default_rng(5)
    m = n - 1
    # a dense flock around the held mouse and a sparse rest, some in the margins
    x = np.concatenate([rng.uniform(550, 650, m // 2), rng.uniform(5, WORLD[0] - 5, m - m // 2)])
    y = np.concatenate([rng.uniform(350, 450, m // 2), rng.uniform(5, WORLD[1] - 5, m - m // 2)])
    eng.spawn_batch("Boid", m, x=x.astype(np.float32), y=y.astype(np.float32),
                    vx=rng.uniform(-3, 3, m).astype(np.float32),
                    vy=rng.uniform(-3, 3, m).astype(np.float32), call_on_spawned=False)
    eng.input.set_mouse(600.0, 400.0)
    eng.input.mouse_button(0, True)
    return eng


def test_engine_frames_equal_pre_kernel_tick(monkeypatch):
    """Three frames of a boids scene with the mouse held inside the flock,
    through ``Engine.step``: the world after them is the pre-kernel tick's
    bit for bit (the columns, fields and mouse row ``Boid.tick`` hands
    ``boid_tick`` are the ones the composition read)."""
    worlds = []
    for tick in (None, pre_kernel_tick):
        with monkeypatch.context() as m:
            if tick is not None:
                m.setattr(Boid, "tick", staticmethod(tick))
            eng = boids_engine()
            eng.step(3)
            worlds.append(eng.snapshot())
    a, b = worlds
    for comp, field in (("transform", "x"), ("transform", "y"), ("rigid_body", "vx"),
                        ("rigid_body", "vy"), ("rigid_body", "ax"), ("rigid_body", "ay")):
        assert torch.equal(getattr(getattr(a, comp), field),
                           getattr(getattr(b, comp), field)), f"{comp}.{field}"


def bad_args(kind):
    """``boid_tick``'s arguments with one fault of ``kind``."""
    sc = scene(3, count=16, slots=16)
    args = list(tick_args(sc, mouse_inputs(True, 600.0), 1.0))
    ids, d2, cols, own, flock, mouse = args[:6]
    if kind == "ids_dtype":
        args[0] = ids.to(torch.int64)
    elif kind == "column_dtype":
        args[2] = cols[:4] + [cols[4].to(torch.int32)]
    elif kind == "d2_shape":
        args[1] = d2[:, :8]
    elif kind == "own_shape":
        args[3] = (own[0][:8],) + tuple(own[1:])
    elif kind == "flock_count":
        args[4] = flock[:5]
    elif kind == "mouse_shape":
        args[5] = (mouse[0], mouse[1], mouse[2].reshape(1), mouse[3])
    elif kind == "own_strided":
        args[3] = (torch.stack([own[0], own[0]], 1)[:, 0],) + tuple(own[1:])
    elif kind == "two_devices":
        args[4] = list(flock[:5]) + [flock[5].to("meta")]
    return args


@pytest.mark.parametrize("kind", ["ids_dtype", "column_dtype", "d2_shape", "own_shape",
                                  "flock_count", "mouse_shape", "own_strided", "two_devices"])
def test_wrapper_rejects_bad_inputs(kind):
    before = cuda_kernels.boid_tick.launches
    with pytest.raises(ValueError):
        boid_tick(*bad_args(kind))
    with pytest.raises(ValueError):
        boid_tick_plain(*bad_args(kind))
    assert cuda_kernels.boid_tick.launches == before


def test_wrapper_runs_plain_on_cpu():
    sc = scene(4)
    args = tick_args(sc, mouse_inputs(True, 600.0), 1.0)
    before = cuda_kernels.boid_tick.launches
    got = boid_tick(*args)
    want = boid_tick_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_kernels.boid_tick.launches == before  # no kernel ran


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def assert_kernel_matches(args, exact):
    before = cuda_kernels.boid_tick.launches
    kx, ky = boid_tick(*args)
    assert cuda_kernels.boid_tick.launches == before + 1
    px, py = boid_tick_plain(*args)
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(kx, px) and torch.equal(ky, py)
        return
    tx, ty = boid_order_tolerance(args)
    assert bool(((kx.double() - px.double()).abs() <= tx).all())
    assert bool(((ky.double() - py.double()).abs() <= ty).all())


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True], ids=["payload", "gathered"])
@pytest.mark.parametrize("down,mouse_x", MOUSE_CASES, ids=["held", "up", "x0"])
@pytest.mark.parametrize("seed,dt,exact", [(0, 1.0, False), (1, 0.75, False), (2, 1.0, True),
                                           (5, 0.5, True)])
def test_kernel_matches_plain_on_card(cuda, seed, dt, exact, down, mouse_x, gathered):
    """The kernel against the plain version on the card, on payload channel
    views and on gathered contiguous columns; bit for bit where the sums are
    exact in any order, else within :func:`torch_scenes.boid_order_tolerance`."""
    sc = scene(seed, exact=exact, device=cuda)
    assert_kernel_matches(tick_args(sc, mouse_inputs(down, mouse_x, cuda), dt, gathered), exact)


@pytest.mark.cuda
def test_kernel_reads_nothing_on_the_host(cuda):
    """One launch under ``set_sync_debug_mode("error")``: the wrapper and
    the kernel read the mouse inputs through device pointers, with no host
    read."""
    args = tick_args(scene(6, device=cuda), mouse_inputs(True, 600.0, cuda), 1.0)
    boid_tick(*args)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        boid_tick(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def cell_args(device, seed=7, n=102_400, cells=25, cap=32):
    """Inputs at the benchmark cell's shape: ``[102400, 800]`` slots with a
    payload of 6 channels, 0-6 live slots a cell as a prefix of its 32
    (about 9.4% of them), the mouse in every 97th row's list, two boid
    types, 35% of d2 inside the protected range."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(lo, hi, shape):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    slots = cells * cap
    k = torch.randint(0, 7, (n, cells, 1), generator=g, device=device)
    live = (torch.arange(cap, device=device).view(1, 1, cap) < k).view(n, slots)
    ids = torch.where(live, torch.randint(1, n, (n, slots), generator=g, device=device), -1)
    ids[::97, 0] = torch.where(live[::97, 0], 0, -1)
    ids = ids.to(torch.int32)
    ntype = torch.randint(1, 3, (n, slots), generator=g, device=device).float()
    ntype[ids == 0] = 0.0
    payload = torch.stack([ids.float(), u(0, 13064, (n, slots)), u(0, 5226, (n, slots)),
                           u(-10, 10, (n, slots)), u(-10, 10, (n, slots)), ntype], -1)
    d2 = torch.where(live, torch.where(u(0, 1, (n, slots)) < 0.35, u(1, 400, (n, slots)),
                                       u(400, 10000, (n, slots))), 0.0)
    zero = torch.zeros(n, device=device)
    own = (u(0, 13064, n), u(0, 5226, n), u(-10, 10, n), u(-10, 10, n), zero, zero,
           torch.randint(1, 3, (n,), generator=g, device=device).to(torch.int32))
    flock = [torch.full((n,), v, device=device) for v in (20.0, 0.001, 0.3, 0.1, 0.01, 20.0)]
    inputs = mouse_inputs(True, 6000.0, device)
    mouse = (inputs.mouse_buttons[0], inputs.mouse_x,
             torch.tensor(6000.0, device=device), torch.tensor(2600.0, device=device))
    cols = [payload[..., c] for c in range(1, 6)]
    return ids, d2, cols, own, flock, mouse, 1.0, (13064.0, 5226.0)


@pytest.mark.cuda
def test_kernel_matches_plain_at_cell_shape(cuda):
    """The benchmark cell's shape, ``[102400, 800]`` slots of 6 payload
    channels, within :func:`torch_scenes.boid_order_tolerance`."""
    args = cell_args(cuda)
    assert args[0].shape == (102_400, 800) and args[2][0].stride() == (4800, 6)
    assert_kernel_matches(args, exact=False)
