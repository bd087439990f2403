"""The prey tick (``ops.cuda_kernels.prey_tick``, the flee instantiation of
``csrc/boid_tick.cu``): its plain version against ``Prey.tick``'s force
terms as they were before the kernel (``flocking_forces``, the flee hook,
``avoid_mouse_force`` and ``keep_within_bounds_force`` over a ``TickCtx``),
bit for bit, Engine frames of the predators scene against the pre-kernel
tick, and the wrapper's checks, on the CPU; the kernel against the plain
version on the card, its launches in the predators scene, and the boid
instantiation against the boid tick as it was built before the flee
instantiation joined it (marked ``cuda``, skipped without one:
``python -m pytest tests/test_torch_prey_tick.py -m cuda --noconftest -q``).

The scenes are ``tests/test_torch_boid_tick.py``'s with a seventh payload
channel (the mixed scene's payload is 7 wide), every neighbour whose id is
a multiple of 5 made a predator, and the rows in ``PREY_ONLY_ROWS`` seeing
none. Tolerances, each with its reason:
- the plain version against the composition, and the frames: bit for bit
  (the same operations in the same order);
- the kernel against the plain version where the sums are exact in float32
  in any order: bit for bit;
- elsewhere only the order of each row's sums differs from ``torch.sum``:
  the boid tick's bound (:func:`test_torch_boid_tick.order_tolerance`) with
  the flee's terms added to the magnitudes and two more operations after
  the sums, ``(S + 10) 2^-22 M`` (:func:`order_tolerance`).
"""

import hashlib

import numpy as np
import pytest
import torch
from test_torch_boid_tick import (
    EMPTY_ROWS,
    MOUSE_CASES,
    bad_args,
    mouse_inputs,
    scene,
    tick_args,
    tick_ctx,
)
from test_torch_boid_tick import cell_args as boid_cell_args
from test_torch_boid_tick import order_tolerance as boid_order_tolerance

from multithreadedgameengine_tpu_torch.models import predators
from multithreadedgameengine_tpu_torch.models.boids import (
    avoid_mouse_force,
    flocking_forces,
    keep_within_bounds_force,
)
from multithreadedgameengine_tpu_torch.models.boids import tick_args as ctx_tick_args
from multithreadedgameengine_tpu_torch.models.predators import Prey, make_predators_engine
from multithreadedgameengine_tpu_torch.ops import cuda_kernels
from multithreadedgameengine_tpu_torch.ops.cuda_kernels import prey_tick, prey_tick_plain

PRED = 3  # the predators' entity type in the scenes (the boids' are 1 and 2, the mouse 0)
#: rows whose neighbours hold no predator
PREY_ONLY_ROWS = (12, 13, 14, 15)
#: where the predators' d2 lies: as drawn (a third inside the protected
#: range, some at 0), all inside (64, under every row's 16^2), all outside
#: (1024, over 24^2), all at 0, all at the row's protected range (not
#: separated); powers of two or squares of integers, so exact scenes stay exact
PRED_CASES = {"drawn": None, "inside": 64.0, "outside": 1024.0, "zero": 0.0,
              "at_range": "range"}


def prey_scene(seed, placement="drawn", exact=False, device="cpu"):
    """:func:`test_torch_boid_tick.scene` with a seventh payload channel of
    junk, the neighbours whose id is a multiple of 5 of the predators'
    type (none in ``PREY_ONLY_ROWS``), their d2 placed by ``placement``,
    and each row's predator_avoid_factor. Returns (scene, flee factor)."""
    payload, ids, d2, own, flock, mouse_row = scene(seed, exact=exact, device=device)
    pred = (ids > 0) & (ids % 5 == 0)
    pred[list(PREY_ONLY_ROWS)] = False
    rng = np.random.default_rng(seed + 100)
    extra = torch.as_tensor(rng.uniform(-1e4, 1e4, ids.shape), dtype=torch.float32,
                            device=device)
    payload = torch.cat([payload, extra[..., None]], dim=-1)
    payload[..., 5] = torch.where(pred, float(PRED), payload[..., 5])
    where = PRED_CASES[placement]
    if where == "range":
        d2 = torch.where(pred, (flock[0] * flock[0])[:, None], d2)
    elif where is not None:
        d2 = torch.where(pred, where, d2)
    factor = torch.as_tensor(rng.choice([10.0, 7.5], ids.shape[0]), dtype=torch.float32,
                             device=device)
    return (payload, ids, d2, own, flock, mouse_row), factor


def pre_kernel_forces(ctx, factor, predator_type=PRED):
    """``Prey.tick``'s ax and ay as they were before the kernel
    (prey.js:120-189): flocking, the flee hook, the mouse and the bounds.
    Returns them and the rows in which a flee term took part."""
    fx, fy, aux = flocking_forces(ctx)
    is_pred = aux.hook_mask & (aux.neighbor_type == predator_type) & (aux.d2 > 0)
    inv_d2 = torch.where(is_pred, 1.0 / torch.where(aux.d2 > 0, aux.d2, 1.0), 0.0)
    flee_x = torch.sum(torch.where(is_pred, -aux.dx * inv_d2, 0.0), dim=1)
    flee_y = torch.sum(torch.where(is_pred, -aux.dy * inv_d2, 0.0), dim=1)
    avoid = factor * ctx.dt_ratio
    fx = fx + flee_x * avoid
    fy = fy + flee_y * avoid
    mx, my = avoid_mouse_force(ctx)
    bx, by = keep_within_bounds_force(ctx)
    return ctx.ax + fx + mx + bx, ctx.ay + fy + my + by, is_pred.any(1)


@pytest.mark.parametrize("placement", list(PRED_CASES))
@pytest.mark.parametrize("down,mouse_x", MOUSE_CASES, ids=["held", "up", "x0"])
@pytest.mark.parametrize("seed,dt", [(0, 1.0), (1, 0.75)])
def test_prey_tick_equals_pre_kernel_composition(seed, dt, down, mouse_x, placement):
    """``prey_tick_plain`` and ``prey_tick`` on the CPU, from a scene's
    columns (payload views of stride 7 or gathered) or from a ``TickCtx`` as
    ``Prey.tick`` hands them, give the pre-kernel composition's ax and ay
    bit for bit: predators inside and outside the protected range, at d2 0
    and at the range, prey-only and empty rows, the margins, the mouse in
    and out of the lists, its button up and down, dt 1 and 0.75."""
    sc, factor = prey_scene(seed, placement)
    ctx = tick_ctx(sc, mouse_inputs(down, mouse_x), dt)
    want_x, want_y, fled = pre_kernel_forces(ctx, factor)
    args_list = (tick_args(sc, ctx.inputs, dt), tick_args(sc, ctx.inputs, dt, gathered=True),
                 ctx_tick_args(ctx))
    assert args_list[0][2][0].stride() == (64 * 7, 7)
    for args in args_list:
        for fn in (prey_tick_plain, prey_tick):
            ax, ay = fn(*args, factor, PRED)
            assert torch.equal(ax, want_x) and torch.equal(ay, want_y), fn.__name__
    # the flee takes part unless every predator is separated or at d2 0
    assert bool(fled.any()) == (placement in ("drawn", "outside", "at_range"))
    assert not bool(fled[list(PREY_ONLY_ROWS + EMPTY_ROWS)].any())
    bx, by = keep_within_bounds_force(ctx)
    assert bool((bx != 0).any()) and bool((by != 0).any())
    assert torch.equal(want_x[list(EMPTY_ROWS)], (ctx.ax + bx)[list(EMPTY_ROWS)])
    mx, _my = avoid_mouse_force(ctx)
    assert bool((mx != 0).any()) == (down and mouse_x != 0)


@pytest.mark.parametrize("placement", ["outside", "at_range"])
def test_flee_moves_the_rows_that_see_a_predator(placement):
    """Against the boid tick on the same columns, the prey tick differs
    exactly on the rows with a predator the hook sees (outside the
    protected range or at it); prey-only rows get the boid tick's forces."""
    sc, factor = prey_scene(7, placement)
    args = tick_args(sc, mouse_inputs(False, 0.0), 1.0)
    ax, ay = prey_tick(*args, factor, PRED)
    bx, by = cuda_kernels.boid_tick(*args)
    ids, _d2, cols = args[:3]
    sees = ((ids >= 0) & (cols[4].to(torch.int32) == PRED)).any(1)
    assert bool(sees.any()) and not bool(sees[list(PREY_ONLY_ROWS)].any())
    assert torch.equal((ax != bx) | (ay != by), sees)
    # no neighbour of the predators' type: the boid tick's forces
    nx, ny = prey_tick(*args, factor, PRED + 10)
    assert torch.equal(nx, bx) and torch.equal(ny, by)


def pre_kernel_prey_tick(ctx):
    """``Prey.tick`` as it was before the kernel, with the animation."""
    ax, ay, fled = pre_kernel_forces(ctx, ctx.field("prey_behavior.predator_avoid_factor"),
                                     predators.Predator.entity_type)
    pre_kernel_prey_tick.fled |= bool(fled.any())
    out = {"rigid_body.ax": ax, "rigid_body.ay": ay}
    out.update(predators._animation_updates(ctx, Prey.ANIM_TABLE, 0.1, 2.0, 0.15))
    return out


def predators_scene(device, per_class=False):
    """The predators scene of ``tests/test_torch_predators.py`` (120 prey, 3
    predators, 2 lights in 1200 x 800, the demo's cell 128 and 1500
    neighbours), optionally with per-class lists, the mouse held in it."""
    spatial = dict(cell_size=128.0, max_neighbors=1500, cell_capacity=64,
                   per_class_assembly=per_class)
    eng = make_predators_engine(120, 3, 2, device=device, world_width=1200.0,
                                world_height=800.0, spatial=spatial)
    eng.input.set_mouse(600.0, 400.0)
    eng.input.mouse_button(0, True)
    return eng


@pytest.mark.parametrize("per_class", [False, True], ids=["global", "per_class"])
def test_engine_frames_equal_pre_kernel_tick(monkeypatch, per_class):
    """Three frames of the predators scene through ``Engine.step``, on one
    list for all classes and on per-class lists: the world after them is
    the pre-kernel tick's bit for bit, and prey fled predators in them."""
    pre_kernel_prey_tick.fled = False
    worlds = []
    for tick in (None, pre_kernel_prey_tick):
        with monkeypatch.context() as m:
            if tick is not None:
                m.setattr(Prey, "tick", staticmethod(tick))
            eng = predators_scene("cpu", per_class)
            eng.step(3)
            worlds.append(eng.snapshot())
    assert pre_kernel_prey_tick.fled
    a, b = worlds
    for comp, field in (("transform", "x"), ("transform", "y"), ("rigid_body", "vx"),
                        ("rigid_body", "vy"), ("rigid_body", "ax"), ("rigid_body", "ay"),
                        ("sprite", "animation_state"), ("sprite", "animation_speed"),
                        ("sprite", "render_dirty")):
        assert torch.equal(getattr(getattr(a, comp), field),
                           getattr(getattr(b, comp), field)), f"{comp}.{field}"


def flee_bad_args(kind):
    """``prey_tick``'s arguments with one fault of ``kind``: the boid
    tick's faults, or one of the flee factor's."""
    factor = torch.full((16,), 10.0)
    if kind.startswith("flee_"):
        args = bad_args(None)
        factor = {"flee_dtype": factor.double(), "flee_shape": factor[:8],
                  "flee_strided": torch.stack([factor, factor], 1)[:, 0],
                  "flee_device": factor.to("meta"), "flee_float": 10.0}[kind]
    else:
        args = bad_args(kind)
    return (*args, factor, PRED)


@pytest.mark.parametrize("kind", ["ids_dtype", "column_dtype", "d2_shape", "own_shape",
                                  "flock_count", "mouse_shape", "own_strided", "two_devices",
                                  "flee_dtype", "flee_shape", "flee_strided", "flee_device",
                                  "flee_float"])
def test_wrapper_rejects_bad_inputs(kind):
    before = cuda_kernels.prey_tick.launches
    with pytest.raises(ValueError):
        prey_tick(*flee_bad_args(kind))
    with pytest.raises(ValueError):
        prey_tick_plain(*flee_bad_args(kind))
    assert cuda_kernels.prey_tick.launches == before


def test_wrapper_runs_plain_on_cpu():
    sc, factor = prey_scene(4)
    args = (*tick_args(sc, mouse_inputs(True, 600.0), 1.0), factor, PRED)
    before = cuda_kernels.prey_tick.launches
    got = prey_tick(*args)
    want = prey_tick_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_kernels.prey_tick.launches == before  # no kernel ran


def test_order_tolerance_covers_the_flee():
    """The bound grows with the flee's terms: rows that see a predator get
    more room than the boid tick's bound gives them."""
    sc, factor = prey_scene(8, "outside")
    args = tick_args(sc, mouse_inputs(False, 0.0), 1.0)
    tx, _ty = order_tolerance(args, factor, PRED)
    bx, _by = boid_order_tolerance(args)
    ids, _d2, cols = args[:3]
    sees = ((ids >= 0) & (cols[4].to(torch.int32) == PRED)).any(1)
    assert bool((tx[sees] > bx[sees]).all()) and bool((tx >= bx).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def order_tolerance(args, factor, predator_type, block=1 << 16):
    """Per row, how far ``ax`` and ``ay`` may differ when only the order of
    each row's sums differs: the boid tick's bound with the flee's terms
    (``predator_avoid_factor dt |d| / d2`` of each predator left to the
    hook) in the magnitudes and ``S + 10`` in place of ``S + 8``, in
    float64, ``block`` rows at a time."""
    ids, d2, cols, own, flock, mouse, dt, extent = args
    n, s = ids.shape
    tols = ([], [])
    for r0 in range(0, n, block):
        sl = slice(r0, r0 + block)
        part = (ids[sl], d2[sl], [c[sl] for c in cols], [t[sl] for t in own],
                [t[sl] for t in flock], mouse, dt, extent)
        boid = boid_order_tolerance(part)
        live = part[0] >= 0
        ntype = torch.where(live, part[2][4], 0.0).to(torch.int32)
        pd2 = part[1].double()
        prot2 = (part[4][0].double() ** 2)[:, None]
        sep = live & (ntype != 0) & (pd2 < prot2) & (pd2 > 0)
        is_pred = live & (ntype == predator_type) & ~sep & (pd2 > 0)
        inv = torch.where(is_pred, 1.0 / torch.where(is_pred, pd2, 1.0), 0.0)
        pf = factor[sl].double() * dt
        for k, (c, o) in enumerate(((part[2][0], part[3][0]), (part[2][1], part[3][1]))):
            gap = torch.where(is_pred, (c.double() - o.double()[:, None]).abs(), 0.0)
            flee = pf * (gap * inv).sum(1)
            tols[k].append(boid[k] * ((s + 10) / (s + 8)) + (s + 10) * 2.0**-22 * flee)
    return torch.cat(tols[0]), torch.cat(tols[1])


def assert_kernel_matches(args, factor, exact):
    before = cuda_kernels.prey_tick.launches
    kx, ky = prey_tick(*args, factor, PRED)
    assert cuda_kernels.prey_tick.launches == before + 1
    px, py = prey_tick_plain(*args, factor, PRED)
    torch.cuda.synchronize()
    if exact:
        assert torch.equal(kx, px) and torch.equal(ky, py)
        return
    tx, ty = order_tolerance(args, factor, PRED)
    assert bool(((kx.double() - px.double()).abs() <= tx).all())
    assert bool(((ky.double() - py.double()).abs() <= ty).all())


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True], ids=["payload", "gathered"])
@pytest.mark.parametrize("placement", list(PRED_CASES))
@pytest.mark.parametrize("down,mouse_x", MOUSE_CASES, ids=["held", "up", "x0"])
@pytest.mark.parametrize("seed,dt,exact", [(0, 1.0, False), (1, 0.75, False), (2, 1.0, True),
                                           (5, 0.5, True)])
def test_kernel_matches_plain_on_card(cuda, seed, dt, exact, down, mouse_x, placement,
                                      gathered):
    """The kernel against the plain version on the card, on payload channel
    views of stride 7 and on gathered contiguous columns; bit for bit where
    the sums are exact in any order, else within :func:`order_tolerance`."""
    sc, factor = prey_scene(seed, placement, exact=exact, device=cuda)
    args = tick_args(sc, mouse_inputs(down, mouse_x, cuda), dt, gathered)
    assert_kernel_matches(args, factor, exact)


@pytest.mark.cuda
def test_kernel_reads_nothing_on_the_host(cuda):
    """One launch under ``set_sync_debug_mode("error")``: the wrapper and
    the kernel read the mouse inputs and the flee factor through device
    pointers, with no host read."""
    sc, factor = prey_scene(6, device=cuda)
    args = (*tick_args(sc, mouse_inputs(True, 600.0, cuda), 1.0), factor, PRED)
    prey_tick(*args)  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prey_tick(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def cell_args(device, seed=7, n=1_000_000, cells=9, cap=64, channels=7):
    """Inputs at the mixed cell's shape: ``[1000000, 576]`` slots (9 cells
    of 64) with a payload of 7 channels, 0-12 live slots a cell as a prefix
    (about 9.4% of them), the mouse in every 97th row's list, prey (type 2)
    with 2% predators (type 3) and 1% lights (type 4) among the neighbours,
    20% of d2 inside the protected range of 12.5, some at 0; the payload
    filled in place, so the largest transient is one ``[n, 576]`` column."""
    g = torch.Generator(device=device).manual_seed(seed)
    slots = cells * cap

    def u(lo, hi, shape):
        return torch.empty(shape, device=device).uniform_(lo, hi, generator=g)

    k = torch.randint(0, 13, (n, cells, 1), generator=g, device=device, dtype=torch.int32)
    live = (torch.arange(cap, device=device, dtype=torch.int32).view(1, 1, cap) < k)
    live = live.view(n, slots)
    del k
    ids = torch.randint(1, n, (n, slots), generator=g, device=device, dtype=torch.int32)
    ids.masked_fill_(~live, -1)
    ids[::97, 0] = torch.where(live[::97, 0], 0, -1).to(torch.int32)
    payload = torch.empty((n, slots, channels), device=device)
    payload[..., 0] = ids
    for c, (lo, hi) in zip(range(1, 5), ((0, 40824.0), (0, 16329.0), (-3, 3), (-3, 3))):
        payload[..., c].uniform_(lo, hi, generator=g)
    kind = u(0, 1, (n, slots))
    payload[..., 5] = torch.where(kind < 0.02, 3.0, torch.where(kind < 0.03, 4.0, 2.0))
    payload[..., 5].masked_fill_(ids == 0, 0.0)
    payload[..., 6].uniform_(-1e4, 1e4, generator=g)
    inside = u(0, 1, (n, slots)) < 0.2
    d2 = torch.where(inside, u(1, 156.0, (n, slots)), u(156.25, 25600, (n, slots)))
    d2.masked_fill_(kind > 0.995, 0.0)
    d2.masked_fill_(~live, 0.0)
    del inside, kind, live
    zero = torch.zeros(n, device=device)
    own = (u(0, 40824.0, n), u(0, 16329.0, n), u(-3, 3, n), u(-3, 3, n), zero, zero,
           torch.full((n,), 2, dtype=torch.int32, device=device))
    flock = [torch.full((n,), v, device=device) for v in (12.5, 0.0005, 6.0, 0.05, 0.001, 20.0)]
    inputs = mouse_inputs(True, 20000.0, device)
    mouse = (inputs.mouse_buttons[0], inputs.mouse_x,
             torch.tensor(20000.0, device=device), torch.tensor(8000.0, device=device))
    cols = [payload[..., c] for c in range(1, 6)]
    return (ids, d2, cols, own, flock, mouse, 1.0, (40824.83, 16329.93)), torch.full(
        (n,), 10.0, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True], ids=["payload", "gathered"])
def test_kernel_matches_plain_at_cell_shape(cuda, gathered):
    """The mixed cell's shape, ``[1000000, 576]`` slots of 7 payload
    channels, as payload views and as gathered columns, within
    :func:`order_tolerance`."""
    args, factor = cell_args(cuda)
    assert args[0].shape == (1_000_000, 576) and args[2][0].stride() == (576 * 7, 7)
    if gathered:
        args = (*args[:2], [c.contiguous() for c in args[2]], *args[3:])
    assert_kernel_matches(args, factor, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("per_class", [False, True], ids=["global", "per_class"])
def test_one_launch_a_frame_in_the_predators_scene(cuda, per_class):
    """Three frames of the predators scene on the card launch the prey tick
    once a frame and the boid tick never; the world stays finite."""
    eng = predators_scene(cuda, per_class)
    eng.step(1, block=True)
    prey, boid = cuda_kernels.prey_tick.launches, cuda_kernels.boid_tick.launches
    eng.step(3, block=True)
    assert cuda_kernels.prey_tick.launches == prey + 3
    assert cuda_kernels.boid_tick.launches == boid
    t = eng.world.transform
    assert bool((torch.isfinite(t.x) & torch.isfinite(t.y)).all())


#: sha256 of the boid tick's ax then ay bytes on
#: ``test_torch_boid_tick.cell_args(cuda)`` (the boids benchmark cell's
#: ``[102400, 800]`` shape, payload channel views), as the kernel gave them
#: before the flee instantiation joined it: on an H100 with torch
#: 2.11.0+cu128, whose CUDA generator draws the inputs
BOID_CELL_DIGEST = "0f67637fe413b5840fedc0a8f940c100ce53f9e484d3c61a88fd51cc8a9b5c60"


def boid_cell_digest(device) -> str:
    """The sha256 of ``boid_tick``'s output bytes on the boids cell's inputs."""
    ax, ay = cuda_kernels.boid_tick(*boid_cell_args(device))
    h = hashlib.sha256(ax.cpu().numpy().tobytes())
    h.update(ay.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
def test_boid_instantiation_is_unchanged(cuda):
    """The Boid path, the kernel's instantiation without the flee, gives
    the boid tick's output as it was before the flee joined the source, bit
    for bit, on the boids cell's shape; and on a prey scene with no
    neighbour of the predators' type the flee instantiation gives the same
    output as the boid instantiation."""
    assert boid_cell_digest(cuda) == BOID_CELL_DIGEST
    sc, factor = prey_scene(3, device=cuda)
    args = tick_args(sc, mouse_inputs(True, 600.0, cuda), 1.0)
    bx, by = cuda_kernels.boid_tick(*args)
    px, py = prey_tick(*args, factor, PRED + 10)
    torch.cuda.synchronize()
    assert torch.equal(bx, px) and torch.equal(by, py)
