"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

K1, the two-sided resident pair pass, replaces the TPU kernel
``multithreadedgameengine_tpu/ops/pallas_kernels.py::pair_pass_resident``
with ``symmetric=False``. The CUDA source is ``csrc/pair_pass_resident.cu``;
``ops/_build.py`` compiles it with nvcc at first use and binds it with
ctypes.

The wrapper dispatches on the device of the tensors it is given: on CPU
tensors it runs :func:`pair_pass_resident_plain`, the same computation in
plain PyTorch; on CUDA tensors it launches the kernel or raises. It never
falls back from one to the other. ``pair_pass_resident.launches`` counts
kernel launches (never plain-version calls).

The port runs K1 at every layout width. The reference switches to its
predicated Newton-symmetric kernel (K2) on wide layouts; K2 is not ported
yet, so ``physics.solver_predicated="on"`` is refused by the engine.
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
    border and non-collider slots pass through with count 0."""
    _check_layout(x, y, radius, meta)
    cap, rows, cols = x.shape
    R, C = rows - 2, cols - 2
    ctr = (slice(None), slice(1, R + 1), slice(1, C + 1))
    xs, ys, rs, ms = x[ctr], y[ctr], radius[ctr], meta[ctr]
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
            nb = (slice(None), slice(1 + dr, R + 1 + dr), slice(1 + dc, C + 1 + dc))
            xn, yn, rn, mn = x[nb], y[nb], radius[nb], meta[nb]
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
    new_x[ctr] = torch.where(ok_i, xs + acc_x, xs)
    new_y[ctr] = torch.where(ok_i, ys + acc_y, ys)
    count[ctr] = acc_c
    return new_x, new_y, count


def pair_pass_resident(
    x: Tensor, y: Tensor, radius: Tensor, meta: Tensor, salt: int,
    strength: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One K1 pass (see :func:`pair_pass_resident_plain` for the contract).
    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise if the launch is refused."""
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
