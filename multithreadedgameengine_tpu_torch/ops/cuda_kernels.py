"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

K1 and K2 replace the TPU kernel
``multithreadedgameengine_tpu/ops/pallas_kernels.py::pair_pass_resident``:

- K1, ``symmetric=False``, the two-sided pass: :func:`pair_pass_resident`,
  source ``csrc/pair_pass_resident.cu``;
- K2, ``symmetric=True``, the occupancy-predicated Newton-symmetric pass,
  optionally with the boundary position clamp folded in:
  :func:`pair_pass_symmetric`, source ``csrc/pair_pass_symmetric.cu``.

Both work on the port's layout ``[cap, R+2, C+2]``, so they share every
solver cache; ``ops/physics_grid.use_symmetric`` picks the one the reference
would pick for the same configuration.

K3 replaces ``pallas_kernels.py::pair_pass_pallas``, the legacy grid pass of
``physics_grid.run_solver_substeps`` (the halo step's solver):
:func:`pair_pass_grid`, source ``csrc/pair_pass_grid.cu``, on the
reference's bordered grid ``[R+2, C+2, cap]`` with its border rows read as
neighbours.

K1, K2 and K3 are tiled passes over occupied slots: a block stages a tile
of cells and its one-cell ring in shared memory, sized so that every cell
may be full, and hands each thread one occupied slot
(``csrc/pair_tile.cuh``). They stop a cell's scan at its occupant count, so
they rely on a cell's occupied slots forming a prefix of its slots, as the
solver's binning fills them (``tests/test_torch_slot_prefix.py``). A
capacity above what the smallest tile stages is refused with a
``ValueError``.

K4 replaces the probe kernel ``benchmarks/probe_expand_kernel.py::expand``
(its only caller in the reference is that probe): :func:`expand`, source
``csrc/expand.cu``, which places x and y at distinct flat slots of two
zeroed outputs, chunk by chunk. It only moves words: a persistent block
stages a tile of both outputs in shared memory, zeroes it, writes the
tile's entities into it and stores it once (:func:`expand_plan` gives the
tile and the grid).

The boid tick replaces no TPU kernel (the JAX package writes the tick in
XLA): :func:`boid_tick`, source ``csrc/boid_tick.cu``, gives ``Boid.tick``'s
new accelerations in one pass over each row's neighbour slots, one warp a
row, loading d2 and the payload only for live slots.

``ops/_build.py`` compiles the sources with nvcc at first use and binds them
with ctypes.

Each wrapper dispatches on the device of the tensors it is given: on CPU
tensors it runs its plain version (``*_plain``, the same computation in
plain PyTorch); on CUDA tensors it launches the kernel or raises. It never
falls back from one to the other. ``<wrapper>.launches`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .physics import _pair_hash_dir, _sqrt

Tensor = torch.Tensor


def _check_layout(x: Tensor, y: Tensor, radius: Tensor, meta: Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"layout must be [cap, rows, cols], got {tuple(x.shape)}")
    cap, rows, cols = x.shape
    if cap < 1 or rows < 3 or cols < 3:
        raise ValueError(f"layout {tuple(x.shape)} has no interior cell")
    for name, t, dtype in (
        ("x", x, torch.float32), ("y", y, torch.float32),
        ("radius", radius, torch.float32), ("meta", meta, torch.int32),
    ):
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(x.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError("layout too large for int32 kernel arguments")


_max_caps = {}


def _check_capacity(lib, kernel: str, cap: int, device: torch.device) -> None:
    """Raise ``ValueError`` when ``cap`` slots a cell exceed what the
    kernel's smallest tile (one cell and its ring) stages in the device's
    shared memory; the limit is the kernel's own, read once per device."""
    key = (kernel, device.index)
    if key not in _max_caps:
        limit = getattr(lib, f"{kernel}_max_cap")()
        if limit < 0:
            raise RuntimeError(f"{kernel}: could not read the device's shared-memory limit")
        _max_caps[key] = limit
    limit = _max_caps[key]
    if cap > limit:
        raise ValueError(
            f"{kernel}: capacity {cap} is above {limit}, the most slots a cell the "
            f"kernel's smallest tile (one cell and its ring) stages in {device}'s "
            f"shared memory")


def tile_of(kernel: str, shape) -> Tuple[int, int]:
    """The tile, (rows, cols) of cells, that one launch of ``kernel``
    (``"pair_pass_resident"``, ``"pair_pass_symmetric"`` or
    ``"pair_pass_grid"``) takes on the current CUDA device for a layout of
    ``shape``: ``[cap, R+2, C+2]``, or K3's ``[R+2, C+2, cap]``."""
    import ctypes

    from . import _build

    cap, rows, cols = (shape[2], shape[0], shape[1]) if kernel == "pair_pass_grid" else shape
    tile = (ctypes.c_int * 2)()
    err = getattr(_build.load(), f"{kernel}_tile")(int(cap), int(rows), int(cols), tile)
    if err != 0:
        raise RuntimeError(f"{kernel}: no tile for {tuple(shape)} (CUDA error {err})")
    return tile[0], tile[1]


def pair_pass_resident_plain(
    x: Tensor, y: Tensor, radius: Tensor, meta: Tensor, salt: int,
    strength: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 in plain PyTorch: the per-offset math of the reference's XLA grid
    solver (physics_grid.py:247-286) on the port's layout, accumulated in
    K1's order (offsets row-major, then neighbour slot j), one neighbour
    plane against all centre planes at a time.

    ``x``/``y``/``radius``: f32 ``[cap, R+2, C+2]`` with an empty one-cell
    border; ``meta``: int32 ``gid | flags << 24`` (0 = empty slot). Returns
    the updated x, y and the int32 contact count, all of the input's shape;
    border, empty and non-collider slots pass their x/y through bit for bit
    (-0.0 and NaN kept) with count 0, and a collider slot gets ``x + acc``
    (so a -0.0 that nothing touched becomes +0.0)."""
    _check_layout(x, y, radius, meta)
    cap, rows, cols = x.shape
    R, C = rows - 2, cols - 2
    # the centre cells holding a collider, as flat indices of the bordered
    # plane: every other slot passes through, so only these are computed
    # (each slot's sum runs in the same order, so the result is the dense
    # computation's bit for bit)
    fl = lambda a: a.reshape(cap, rows * cols)  # noqa: E731
    coll = ((meta >> 24) & 1) == 1
    coll[:, 0], coll[:, -1], coll[:, :, 0], coll[:, :, -1] = False, False, False, False
    cidx = torch.nonzero(coll.any(0).flatten()).flatten()
    xs, ys, rs, ms = fl(x)[:, cidx], fl(y)[:, cidx], fl(radius)[:, cidx], fl(meta)[:, cidx]
    fi = ms >> 24
    ok_i = (fi & 1) == 1
    trig_i = (fi & 2) != 0
    st_i = (fi & 4) != 0
    id_i = ms & 0xFFFFFF

    acc_x = torch.zeros_like(xs)
    acc_y = torch.zeros_like(xs)
    acc_c = torch.zeros(xs.shape, dtype=torch.int32, device=x.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            nb = cidx + dr * cols + dc
            xn, yn, rn, mn = fl(x)[:, nb], fl(y)[:, nb], fl(radius)[:, nb], fl(meta)[:, nb]
            for j in range(cap):
                mj = mn[j]
                fj = mj >> 24
                id_j = mj & 0xFFFFFF
                ok = ok_i & ((fj & 1) == 1) & (id_i != id_j)
                dx = xs - xn[j]
                dy = ys - yn[j]
                d2 = dx * dx + dy * dy
                min_d = rs + rn[j]
                overlap = ok & (d2 < min_d * min_d)

                blocked = trig_i | ((fj & 2) != 0) | st_i
                st_j = (fj & 4) != 0
                share = torch.where(blocked, 0.0, torch.where(st_j, 1.0, 0.5))
                inv_dist = torch.where(d2 > 0, 1.0 / _sqrt(d2), 0.0)
                dist = d2 * inv_dist
                corr = (min_d - dist) * strength * share
                # exactly coincident pairs: pair-consistent hash direction
                zero = d2 == 0
                ux, uy = _pair_hash_dir(id_i, id_j, salt)
                sign = torch.where(id_i < id_j, 1.0, -1.0)
                zshare = torch.where(
                    blocked, 0.0, torch.where(st_j, 2.0, 1.0)
                ) * sign * 0.001
                push_x = torch.where(zero, ux * zshare, dx * inv_dist * corr)
                push_y = torch.where(zero, uy * zshare, dy * inv_dist * corr)
                acc_x = acc_x + torch.where(overlap, push_x, 0.0)
                acc_y = acc_y + torch.where(overlap, push_y, 0.0)
                acc_c = acc_c + overlap.to(torch.int32)

    new_x, new_y = x.clone(), y.clone()
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    fl(new_x)[:, cidx] = torch.where(ok_i, xs + acc_x, xs)
    fl(new_y)[:, cidx] = torch.where(ok_i, ys + acc_y, ys)
    fl(count)[:, cidx] = acc_c
    return new_x, new_y, count


def pair_pass_resident(
    x: Tensor, y: Tensor, radius: Tensor, meta: Tensor, salt: int,
    strength: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One K1 pass (see :func:`pair_pass_resident_plain` for the contract).
    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise if the launch is refused, or ``ValueError``
    for a capacity above the kernel's limit."""
    _check_layout(x, y, radius, meta)
    if x.device.type == "cpu":
        return pair_pass_resident_plain(x, y, radius, meta, salt, strength)
    if x.device.type != "cuda":
        raise ValueError(f"pair_pass_resident runs on cpu or cuda, not {x.device}")
    from . import _build

    lib = _build.load()
    cap, rows, cols = x.shape
    new_x = torch.empty_like(x)
    new_y = torch.empty_like(y)
    count = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _check_capacity(lib, "pair_pass_resident", cap, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pair_pass_resident_launch(
            x.data_ptr(), y.data_ptr(), radius.data_ptr(), meta.data_ptr(),
            new_x.data_ptr(), new_y.data_ptr(), count.data_ptr(),
            cap, rows, cols, int(salt) & 0xFFFFFFFF, float(strength), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_pass_resident: CUDA launch failed with error {err}")
    pair_pass_resident.launches += 1
    return new_x, new_y, count


pair_pass_resident.launches = 0


#: K2's forward cell offsets (dr, dc), in the reference's order
#: (pallas_kernels.py:320); each neighbour pair is seen from one side
SYM_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1), (1, -1))


def clamp_moving(x: Tensor, y: Tensor, radius: Tensor, meta: Tensor,
                 clamp_bounds) -> Tuple[Tensor, Tensor]:
    """The boundary position clamp K2 folds in (pallas_kernels.py:248-260):
    moving slots (meta flag 8) clamped to ``[r, extent - r]``, every other
    slot unchanged."""
    w, h = float(clamp_bounds[0]), float(clamp_bounds[1])
    mv = ((meta >> 24) & 8) != 0
    return (torch.where(mv, torch.clamp(x, radius, w - radius), x),
            torch.where(mv, torch.clamp(y, radius, h - radius), y))


def pair_pass_symmetric_plain(
    x: Tensor, y: Tensor, radius: Tensor, meta: Tensor, salt: int,
    strength: float, clamp_bounds=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 in plain PyTorch: the reference's predicated Newton-symmetric pass
    (``_resident_body_pred``, pallas_kernels.py:185-459) on the port's
    layout, summed in the per-slot order the CUDA kernel uses.

    For every forward offset in :data:`SYM_OFFSETS` and neighbour plane
    ``j = 0..cap-1``, a slot on plane ``p`` first adds its own push from the
    pair (itself, slot j at +offset), when it takes the i side (p > j for
    the same cell, any p otherwise); then, when p == j, the back-sum: the
    reciprocal pushes of the slots at -offset (i > j for the same cell),
    summed over i in order from 0.0. Per-pair arithmetic is the reference's:
    ``base = (min_d - dist) * strength * inv_dist``, ``pxc = dx * base``,
    push ``pxc * A_i*B_j`` and reciprocal ``-(pxc * A_j*B_i``) with
    ``A = (1-trig)(1-static)``, ``B = (1-trig)(0.5+0.5 static)``; coincident
    pairs take the hash direction with ``(2 share) sign 0.001``.

    ``clamp_bounds=(world_w, world_h)`` first clamps every moving slot to
    ``[r, extent - r]`` (:func:`clamp_moving`); every read and the output
    base then see the clamped values. Returns (x + acc, y + acc, count) for
    every slot; border and non-collider slots get acc = 0 and count 0."""
    _check_layout(x, y, radius, meta)
    _cap, rows, cols = x.shape
    R, C = rows - 2, cols - 2
    if clamp_bounds is not None:
        x, y = clamp_moving(x, y, radius, meta, clamp_bounds)
    x_in, y_in = x, y
    # planes above the highest occupied one take part in no pair (cells fill
    # their slots rank-ascending): leave them out, as the kernel's scan does
    occupied = (meta != 0).flatten(1).any(1).nonzero()
    cap = int(occupied.max()) + 1 if occupied.numel() else 0
    x, y, radius, meta = x[:cap], y[:cap], radius[:cap], meta[:cap]
    f = meta >> 24
    ok = (f & 1) == 1
    not_trig = 1.0 - ((f >> 1) & 1).to(torch.float32)
    stat = ((f >> 2) & 1).to(torch.float32)
    share_a = not_trig * (1.0 - stat)
    share_b = not_trig * (0.5 + 0.5 * stat)
    gid = meta & 0xFFFFFF

    acc_x = torch.zeros((cap, R, C), dtype=torch.float32, device=x.device)
    acc_y = torch.zeros_like(acc_x)
    acc_c = torch.zeros((cap, R, C), dtype=torch.int32, device=x.device)
    for dr, dc in SYM_OFFSETS:
        same_cell = dr == 0 and dc == 0
        # i cells a whose neighbour a + (dr, dc) lies in the layout; they
        # cover the interior (i side) and the interior - offset (back-sums)
        c0, c1 = max(0, -dc), cols - max(0, dc)
        ei = (slice(None), slice(0, rows - dr), slice(c0, c1))
        xi, yi, ri, oki = x[ei], y[ei], radius[ei], ok[ei]
        ai, bi, gi = share_a[ei], share_b[ei], gid[ei]
        own = (slice(1, R + 1), slice(1 - c0, C + 1 - c0))  # a = q
        back = (slice(1 - dr, R + 1 - dr), slice(1 - dc - c0, C + 1 - dc - c0))
        ej = (slice(dr, rows), slice(c0 + dc, c1 + dc))
        for j in range(cap):
            xj, yj, rj = x[j][ej], y[j][ej], radius[j][ej]
            okj, aj, bj, gj = ok[j][ej], share_a[j][ej], share_b[j][ej], gid[j][ej]
            dx = xi - xj
            dy = yi - yj
            d2 = dx * dx + dy * dy
            min_d = ri + rj
            overlap = oki & okj & (d2 < min_d * min_d)
            inv_dist = torch.where(d2 > 0, 1.0 / _sqrt(d2), 0.0)
            dist = d2 * inv_dist
            base = (min_d - dist) * strength * inv_dist
            pxc = dx * base
            pyc = dy * base
            share = ai * bj
            share_j = aj * bi
            zero = d2 == 0
            ux, uy = _pair_hash_dir(gi, gj, salt)
            sign = torch.where(gi < gj, 1.0, -1.0)
            zs = (2.0 * share) * sign * 0.001
            zs_j = (2.0 * share_j) * (-sign) * 0.001
            push_x = torch.where(overlap, torch.where(zero, ux * zs, pxc * share), 0.0)
            push_y = torch.where(overlap, torch.where(zero, uy * zs, pyc * share), 0.0)
            rec_x = torch.where(overlap, torch.where(zero, ux * zs_j, -(pxc * share_j)), 0.0)
            rec_y = torch.where(overlap, torch.where(zero, uy * zs_j, -(pyc * share_j)), 0.0)

            lo = j + 1 if same_cell else 0  # planes taking the i side
            acc_x[lo:] += push_x[lo:][(slice(None),) + own]
            acc_y[lo:] += push_y[lo:][(slice(None),) + own]
            acc_c[lo:] += overlap[lo:][(slice(None),) + own].to(torch.int32)
            bx = torch.zeros((R, C), dtype=torch.float32, device=x.device)
            by = torch.zeros_like(bx)
            for i in range(lo, cap):
                bx = bx + rec_x[i][back]
                by = by + rec_y[i][back]
            acc_x[j] += bx
            acc_y[j] += by
            acc_c[j] += overlap[lo:][(slice(None),) + back].sum(0, dtype=torch.int32)

    full_x = torch.zeros(x_in.shape, dtype=torch.float32, device=x.device)
    full_y = torch.zeros_like(full_x)
    count = torch.zeros(x_in.shape, dtype=torch.int32, device=x.device)
    full_x[:cap, 1:R + 1, 1:C + 1] = acc_x
    full_y[:cap, 1:R + 1, 1:C + 1] = acc_y
    count[:cap, 1:R + 1, 1:C + 1] = acc_c
    return x_in + full_x, y_in + full_y, count


def pair_pass_symmetric(
    x: Tensor, y: Tensor, radius: Tensor, meta: Tensor, salt: int,
    strength: float, clamp_bounds=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One K2 pass (see :func:`pair_pass_symmetric_plain` for the contract).
    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise if the launch is refused, or ``ValueError``
    for a capacity above the kernel's limit."""
    _check_layout(x, y, radius, meta)
    if x.device.type == "cpu":
        return pair_pass_symmetric_plain(x, y, radius, meta, salt, strength,
                                         clamp_bounds)
    if x.device.type != "cuda":
        raise ValueError(f"pair_pass_symmetric runs on cpu or cuda, not {x.device}")
    from . import _build

    lib = _build.load()
    cap, rows, cols = x.shape
    new_x = torch.empty_like(x)
    new_y = torch.empty_like(y)
    count = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    clamp = clamp_bounds is not None
    w, h = (float(clamp_bounds[0]), float(clamp_bounds[1])) if clamp else (0.0, 0.0)
    with torch.cuda.device(x.device):
        _check_capacity(lib, "pair_pass_symmetric", cap, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pair_pass_symmetric_launch(
            x.data_ptr(), y.data_ptr(), radius.data_ptr(), meta.data_ptr(),
            new_x.data_ptr(), new_y.data_ptr(), count.data_ptr(),
            cap, rows, cols, int(salt) & 0xFFFFFFFF, float(strength),
            int(clamp), w, h, stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_pass_symmetric: CUDA launch failed with error {err}")
    pair_pass_symmetric.launches += 1
    return new_x, new_y, count


pair_pass_symmetric.launches = 0


def _check_grid(x: Tensor, y: Tensor, attrs: Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"grid must be [rows, cols, cap], got {tuple(x.shape)}")
    rows, cols, cap = x.shape
    if cap < 1 or rows < 3 or cols < 3:
        raise ValueError(f"grid {tuple(x.shape)} has no interior cell")
    for name, t, shape in (("x", x, x.shape), ("y", y, x.shape),
                           ("attrs", attrs, (*x.shape, 3))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if attrs.numel() >= 2**31:
        raise ValueError("grid too large for int32 kernel arguments")


def pair_pass_grid_plain(
    x: Tensor, y: Tensor, attrs: Tensor, salt: int, strength: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K3 in plain PyTorch: the reference's ``_pair_kernel``
    (pallas_kernels.py:49-139) on its bordered grid, accumulated in its
    order (offsets row-major, then neighbour slot j). Per offset, every
    (i, j) pair's push is computed at once; the sums then run over j one
    slot at a time.

    ``x``/``y``: f32 ``[R+2, C+2, cap]``; ``attrs``: f32 ``[R+2, C+2, cap,
    3]`` (radius, flags as an exact small float, gid as an exact float, -1 =
    empty). Unlike the reference's wrapper, the border rows 0 and R+1 are
    read as neighbours (they hold the neighbour slabs' edge rows under the
    halo step), as the XLA formulation reads them. Returns the displacements
    and the int32 contact count, each of ``x``'s shape, 0 on the border."""
    _check_grid(x, y, attrs)
    rows, cols, cap = x.shape
    R, C = rows - 2, cols - 2
    pk = attrs[..., 1].to(torch.int32).reshape(rows * cols, cap)
    gid = attrs[..., 2].to(torch.int32).reshape(rows * cols, cap)
    rad = attrs[..., 0].reshape(rows * cols, cap)
    xf, yf = x.reshape(rows * cols, cap), y.reshape(rows * cols, cap)
    # the interior cells holding a collider, as flat indices: every other
    # cell gets nothing, so only these are computed (each slot's sum runs
    # in the same order, so the result is the dense computation's bit for
    # bit)
    coll = ((pk & 1) == 1).any(1).view(rows, cols).clone()
    coll[0], coll[-1], coll[:, 0], coll[:, -1] = False, False, False, False
    cidx = torch.nonzero(coll.flatten()).flatten()
    # centre slots i on axis 1, neighbour slots j on axis 2
    xs, ys, rs = xf[cidx][..., None], yf[cidx][..., None], rad[cidx][..., None]
    ok_i = (pk[cidx][..., None] & 1) == 1
    trig_i = (pk[cidx][..., None] & 2) != 0
    st_i = (pk[cidx][..., None] & 4) != 0
    id_i = gid[cidx][..., None]

    acc_x = torch.zeros((cidx.shape[0], cap), dtype=torch.float32, device=x.device)
    acc_y = torch.zeros_like(acc_x)
    acc_c = torch.zeros((cidx.shape[0], cap), dtype=torch.int32, device=x.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            nb = cidx + dr * cols + dc
            pkb, idb = pk[nb][:, None], gid[nb][:, None]  # [n, 1, cap]
            ok = ok_i & ((pkb & 1) == 1) & (id_i != idb)
            dx = xs - xf[nb][:, None]
            dy = ys - yf[nb][:, None]
            d2 = dx * dx + dy * dy
            min_d = rs + rad[nb][:, None]
            overlap = ok & (d2 < min_d * min_d)

            blocked = trig_i | ((pkb & 2) != 0) | st_i
            st_j = (pkb & 4) != 0
            share = torch.where(blocked, 0.0, torch.where(st_j, 1.0, 0.5))
            inv_dist = torch.where(d2 > 0, 1.0 / _sqrt(d2), 0.0)
            dist = d2 * inv_dist
            corr = (min_d - dist) * strength * share
            zero = d2 == 0
            ux, uy = _pair_hash_dir(id_i, idb, salt)
            sign = torch.where(id_i < idb, 1.0, -1.0)
            zshare = torch.where(
                blocked, 0.0, torch.where(st_j, 2.0, 1.0)
            ) * sign * 0.001
            push_x = torch.where(overlap, torch.where(zero, ux * zshare, dx * inv_dist * corr), 0.0)
            push_y = torch.where(overlap, torch.where(zero, uy * zshare, dy * inv_dist * corr), 0.0)
            for j in range(cap):
                acc_x = acc_x + push_x[..., j]
                acc_y = acc_y + push_y[..., j]
            acc_c = acc_c + overlap.sum(-1, dtype=torch.int32)

    disp_x = torch.zeros_like(x)
    disp_y = torch.zeros_like(y)
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    disp_x.view(rows * cols, cap)[cidx] = acc_x
    disp_y.view(rows * cols, cap)[cidx] = acc_y
    count.view(rows * cols, cap)[cidx] = acc_c
    return disp_x, disp_y, count


def pair_pass_grid(
    x: Tensor, y: Tensor, attrs: Tensor, salt: int, strength: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One K3 pass (see :func:`pair_pass_grid_plain` for the contract). CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise if the launch is refused, or ``ValueError``
    for a capacity above the kernel's limit."""
    _check_grid(x, y, attrs)
    if x.device.type == "cpu":
        return pair_pass_grid_plain(x, y, attrs, salt, strength)
    if x.device.type != "cuda":
        raise ValueError(f"pair_pass_grid runs on cpu or cuda, not {x.device}")
    from . import _build

    lib = _build.load()
    rows, cols, cap = x.shape
    disp_x = torch.empty_like(x)
    disp_y = torch.empty_like(y)
    count = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _check_capacity(lib, "pair_pass_grid", cap, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pair_pass_grid_launch(
            x.data_ptr(), y.data_ptr(), attrs.data_ptr(),
            disp_x.data_ptr(), disp_y.data_ptr(), count.data_ptr(),
            rows, cols, cap, int(salt) & 0xFFFFFFFF, float(strength), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_pass_grid: CUDA launch failed with error {err}")
    pair_pass_grid.launches += 1
    return disp_x, disp_y, count


pair_pass_grid.launches = 0


def _check_expand(x: Tensor, y: Tensor, order: Tensor, flat: Tensor, bounds: Tensor,
                  total: int, chunk: int) -> int:
    """Check K4's inputs; returns the number of chunks."""
    if chunk <= 0 or chunk % 8 or total <= 0 or total % chunk:
        raise ValueError(f"total {total} must be a positive multiple of chunk {chunk}, "
                         "itself a positive multiple of 8")
    if total >= 2**31 - 1:
        raise ValueError("total too large for int32 slots")
    n_chunks = total // chunk
    n = x.shape[0] if x.dim() == 1 else -1
    for name, t, dtype, shape in (
        ("x", x, torch.float32, (n,)), ("y", y, torch.float32, (n,)),
        ("order", order, torch.int32, (n,)), ("flat", flat, torch.int32, (n,)),
        ("bounds", bounds, torch.int32, (n_chunks + 1,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n_chunks


def expand_plain(x: Tensor, y: Tensor, order: Tensor, flat: Tensor, bounds: Tensor,
                 total: int, chunk: int) -> Tuple[Tensor, Tensor]:
    """K4 in plain PyTorch: two zeroed outputs of ``total`` slots and an
    index write of x and y at ``flat`` for the entities of every chunk's
    range ``order[bounds[t]:bounds[t+1]]``.

    ``x``/``y``: f32 ``[N]``; ``order``: int32 ``[N]``, the entities sorted
    by slot; ``flat``: int32 ``[N]``, distinct slots in ``[0, total)``, and
    those of chunk t's range in ``[t * chunk, (t+1) * chunk)``; ``bounds``:
    int32 ``[total // chunk + 1]``, ascending. Returns ``(ox, oy)``, f32
    ``[total // chunk * 8, chunk // 8]`` (the reference's layout, which is
    slot order): ``ox.view(-1)[flat[g]] == x[g]``, 0.0 elsewhere."""
    n_chunks = _check_expand(x, y, order, flat, bounds, total, chunk)
    # the chunks' ranges tile [bounds[0], bounds[-1]) of the sorted order
    g = order[int(bounds[0]):int(bounds[-1])].to(torch.int64)
    dst = flat[g].to(torch.int64)
    ox = torch.zeros(total, dtype=torch.float32, device=x.device)
    oy = torch.zeros(total, dtype=torch.float32, device=x.device)
    ox.index_copy_(0, dst, x[g])
    oy.index_copy_(0, dst, y[g])
    return ox.view(n_chunks * 8, chunk // 8), oy.view(n_chunks * 8, chunk // 8)


def expand(x: Tensor, y: Tensor, order: Tensor, flat: Tensor, bounds: Tensor,
           total: int, chunk: int) -> Tuple[Tensor, Tensor]:
    """One K4 pass (see :func:`expand_plain` for the contract). CPU tensors
    run the plain version; CUDA tensors launch the kernel on the current
    stream and raise if the launch is refused."""
    n_chunks = _check_expand(x, y, order, flat, bounds, total, chunk)
    if x.device.type == "cpu":
        return expand_plain(x, y, order, flat, bounds, total, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"expand runs on cpu or cuda, not {x.device}")
    from . import _build

    lib = _build.load()
    ox = torch.empty((n_chunks * 8, chunk // 8), dtype=torch.float32, device=x.device)
    oy = torch.empty_like(ox)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.expand_launch(
            x.data_ptr(), y.data_ptr(), order.data_ptr(), flat.data_ptr(), bounds.data_ptr(),
            ox.data_ptr(), oy.data_ptr(), n_chunks, chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"expand: CUDA launch failed with error {err}")
    expand.launches += 1
    return ox, oy


expand.launches = 0


def expand_plan(total: int) -> dict:
    """The plan one launch of K4 takes on the current CUDA device for
    ``total`` slots: slots a tile, blocks, threads a block and bytes of
    shared memory a block."""
    import ctypes

    from . import _build

    plan = (ctypes.c_int * 4)()
    err = _build.load().expand_plan(int(total), plan)
    if err != 0:
        raise RuntimeError(f"expand: no plan for {total} slots (CUDA error {err})")
    return dict(tile_slots=plan[0], blocks=plan[1], threads=plan[2], smem_bytes=plan[3])


#: the mouse's entity type and its row (``models.boids``: the Mouse class
#: registers first and spawns at row 0)
BOID_MOUSE = 0


def _check_boid_tick(ids: Tensor, d2: Tensor, cols, own, flock, mouse) -> None:
    if ids.dim() != 2:
        raise ValueError(f"ids must be [count, slots], got {tuple(ids.shape)}")
    count = ids.shape[0]
    dev = ids.device
    if len(cols) != 5 or len(own) != 7 or len(flock) != 6 or len(mouse) != 4:
        raise ValueError("boid_tick takes 5 neighbour columns, 7 own fields, 6 flocking "
                         "fields and 4 mouse inputs")
    checks = [("ids", ids, torch.int32, tuple(ids.shape), True),
              ("d2", d2, torch.float32, tuple(ids.shape), True)]
    checks += [(f"column {k}", c, torch.float32, tuple(ids.shape), False)
               for k, c in enumerate(cols)]
    checks += [(f"own field {k}", t, torch.int32 if k == 6 else torch.float32, (count,), True)
               for k, t in enumerate(own)]
    checks += [(f"flocking field {k}", t, torch.float32, (count,), True)
               for k, t in enumerate(flock)]
    checks += [(name, t, dtype, (), False) for name, t, dtype in zip(
        ("mouse_down", "mouse_x", "mouse row x", "mouse row y"), mouse,
        (torch.bool, torch.float32, torch.float32, torch.float32))]
    for name, t, dtype, shape, contiguous in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ids on {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if count >= 2**31:
        raise ValueError("too many rows for int32 kernel arguments")


def boid_tick_plain(ids: Tensor, d2: Tensor, cols, own, flock, mouse, dt_ratio: float,
                    extent) -> Tuple[Tensor, Tensor]:
    """``Boid.tick`` in plain PyTorch: ``ax + flocking + mouse + margin``
    for x and y, with ``models.boids``' ``flocking_forces``,
    ``avoid_mouse_force`` and ``keep_within_bounds_force`` (boid.js:116-341)
    restated on tensors, operation for operation.

    ``ids`` int32 and ``d2`` f32 ``[count, S]`` (-1 in an empty slot);
    ``cols``: the neighbours' x, y, vx, vy and entity type, f32 ``[count,
    S]`` each, of any strides (payload channel views or gathered columns);
    ``own``: the row's x, y, vx, vy, ax, ay (f32) and entity type (int32),
    ``[count]`` each; ``flock``: its ``flocking.`` protected_range,
    centering_factor, avoid_factor, matching_factor, turn_factor and margin,
    f32 ``[count]``; ``mouse``: 0-dim tensors, mouse button 0 (bool),
    ``inputs.mouse_x`` and world row 0's x and y; ``extent``: (world width,
    world height). Returns the new ``rigid_body.ax`` and ``rigid_body.ay``."""
    _check_boid_tick(ids, d2, cols, own, flock, mouse)
    nx, ny, nvx, nvy, ntype_col = cols
    x, y, vx, vy, ax, ay, entity_type = own
    protected_range, centering, avoid, matching, turn_factor, margin = flock
    mouse_down, mouse_x, mouse_px, mouse_py = mouse
    dt = dt_ratio

    # flocking_forces (boid.js:137-240)
    live = ids >= 0
    ntype = ntype_col.to(torch.int32)
    not_mouse = live & (ntype != BOID_MOUSE)
    dx = nx - x[:, None]
    dy = ny - y[:, None]
    prot2 = (protected_range * protected_range)[:, None]
    sep = not_mouse & (d2 < prot2) & (d2 > 0)
    inv_d2 = torch.where(sep, 1.0 / torch.where(d2 > 0, d2, 1.0), 0.0)
    separate_x = torch.sum(torch.where(sep, -dx * inv_d2, 0.0), dim=1)
    separate_y = torch.sum(torch.where(sep, -dy * inv_d2, 0.0), dim=1)
    same = not_mouse & ~sep & (ntype == entity_type[:, None])
    same_n = torch.sum(same, dim=1, dtype=torch.int32)
    center_x = torch.sum(torch.where(same, nx, 0.0), dim=1)
    center_y = torch.sum(torch.where(same, ny, 0.0), dim=1)
    avg_vx = torch.sum(torch.where(same, nvx, 0.0), dim=1)
    avg_vy = torch.sum(torch.where(same, nvy, 0.0), dim=1)
    has_same = same_n > 0
    inv_n = torch.where(has_same, 1.0 / torch.clamp(same_n, min=1).to(torch.float32), 0.0)
    fx = torch.where(has_same, (center_x * inv_n - x) * centering * dt, 0.0)
    fy = torch.where(has_same, (center_y * inv_n - y) * centering * dt, 0.0)
    fx = fx + torch.where(has_same, (avg_vx * inv_n - vx) * matching * dt, 0.0)
    fy = fy + torch.where(has_same, (avg_vy * inv_n - vy) * matching * dt, 0.0)
    fx = fx + separate_x * avoid * dt
    fy = fy + separate_y * avoid * dt

    # avoid_mouse_force (boid.js:281-316)
    slot = live & (ids == BOID_MOUSE)
    present = torch.any(slot, dim=1)
    md2 = torch.sum(torch.where(slot, d2, 0.0), dim=1)
    engaged = mouse_down & (mouse_x != 0) & present & (md2 > 0)
    mdx = mouse_px - x
    mdy = mouse_py - y
    safe_d2 = torch.where(md2 > 0, md2, 1.0)
    mx = torch.where(engaged, -(mdx / safe_d2) * 1000.0 * dt, 0.0)
    my = torch.where(engaged, -(mdy / safe_d2) * 1000.0 * dt, 0.0)

    # keep_within_bounds_force (boid.js:322-341)
    turn = turn_factor * dt
    ww, wh = extent
    bx = torch.where(x < margin, turn, 0.0) - torch.where(x > ww - margin, turn, 0.0)
    by = torch.where(y < margin, turn, 0.0) - torch.where(y > wh - margin, turn, 0.0)
    return ax + fx + mx + bx, ay + fy + my + by


def boid_tick(ids: Tensor, d2: Tensor, cols, own, flock, mouse, dt_ratio: float,
              extent) -> Tuple[Tensor, Tensor]:
    """One boid tick (see :func:`boid_tick_plain` for the contract). CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, reading the mouse inputs through device pointers (no
    host read), and raise if the launch is refused. The kernel sums each
    row's terms in another order than ``torch.sum``; every other operation
    is the plain version's."""
    _check_boid_tick(ids, d2, cols, own, flock, mouse)
    if ids.device.type == "cpu":
        return boid_tick_plain(ids, d2, cols, own, flock, mouse, dt_ratio, extent)
    if ids.device.type != "cuda":
        raise ValueError(f"boid_tick runs on cpu or cuda, not {ids.device}")
    import ctypes

    from . import _build

    lib = _build.load()
    count, slots = ids.shape
    out_ax = torch.empty((count,), dtype=torch.float32, device=ids.device)
    out_ay = torch.empty_like(out_ax)
    if count == 0:
        return out_ax, out_ay
    tensors = (ids, d2, *cols, *own, *flock, *mouse, out_ax, out_ay)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 10)(*(c.stride(0) for c in cols),
                                       *(c.stride(1) for c in cols))
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.boid_tick_launch(ptrs, strides, count, slots, float(dt_ratio),
                                   float(extent[0]), float(extent[1]), stream)
    if err != 0:
        raise RuntimeError(f"boid_tick: CUDA launch failed with error {err}")
    boid_tick.launches += 1
    return out_ax, out_ay


boid_tick.launches = 0
