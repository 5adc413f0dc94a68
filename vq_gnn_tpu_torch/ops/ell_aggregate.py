"""Kernel 1: the slot-ELL aggregate, and its plain PyTorch version.

``out[r] = sum over slots s of row r, sum over k of val[s,k] * x[col[s,k]]``,
f32 [num_rows, C].  Slots are sorted by row; slots whose row is >= num_rows
(padding, or the backward's ride-over dustbin) are dropped; columns clip to
the rows of x (JAX's ``mode='clip'``).  x is f32, or bf16 or f16 under
``compute_dtype='bfloat16'`` or ``'float16'``: its values are summed in f32
either way (the bf16 and f16 modes count their launches in
``ell_aggregate.launches_bf16`` and ``launches_f16``).

The CUDA kernel (``csrc/ell_aggregate.cu``) replaces
``vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel`` (gat=False) and the gather
in front of it; see the source for what bounds it on the H100.  It takes the
row offsets and the long-row list built with the batch
(``spmm.row_offsets_host``, ``spmm.long_rows_host``) and builds the offsets
itself when not given.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vq_gnn_tpu_torch.config import sum_dtype
from vq_gnn_tpu_torch.ops import _build

# Channels a warp covers in one pass (32 lanes x 16 bytes: float4, or 8
# 16-bit values): wider x is split into equal panels of at most this many
# channels, walked side by side.
PANEL_MAX = 128
PANEL_MAX_BF16 = 256  # 16-bit rows, bf16 or f16
# the dtypes of x the kernel takes, each with its code in the kernel's
# interface (csrc/ell_common.cuh RowType): f32, and bf16 or f16 rows under
# 16-bit compute
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the launch counter of each row dtype's mode
LAUNCH_COUNTERS = {torch.float32: "launches", torch.bfloat16: "launches_bf16",
                   torch.float16: "launches_f16"}
# The batch's long-row lists (spmm.long_rows_host) hold the rows of more than
# LONG_SLOTS slots: they start first, a warp each, longest first; the others
# go in index order.
LONG_SLOTS = 16


def _lane_unit(C: int, dtype) -> int:
    """Channels a lane takes in one load: 8 16-bit values or 4 floats where
    C is a multiple of that, else 1."""
    unit = 8 if dtype.itemsize == 2 else 4
    return unit if C % unit == 0 else 1


def panel_width(C: int, dtype=torch.float32) -> int:
    """Channels per panel: the widest divisor of C that is at most
    PANEL_MAX (PANEL_MAX_BF16 for 16-bit x; a multiple of the lane's load, 4
    floats or 8 16-bit values, when C is, so the kernel keeps its vector
    lanes); C itself up to that."""
    unit = _lane_unit(C, dtype)
    top = PANEL_MAX_BF16 if dtype.itemsize == 2 else PANEL_MAX
    return max(w for w in range(unit, min(C, top) + 1, unit) if C % w == 0)


def row_offsets_plain(ell_row, num_rows: int) -> torch.Tensor:
    """``ptr[r]`` = the first slot whose row, clamped to num_rows, is >= r,
    for r in [0, num_rows]: the kernel's row offsets (slots of rows >=
    num_rows fall outside every row's range)."""
    rows = torch.clamp(ell_row.long(), max=num_rows)
    want = torch.arange(num_rows + 1, device=ell_row.device)
    return torch.searchsorted(rows, want).to(torch.int32)


def ell_aggregate_plain(x, ell_row, ell_col, ell_val, num_rows: int) -> torch.Tensor:
    """Gather, weight, K-reduce, then a sorted segment sum — in plain
    PyTorch.  Elementwise products (no matmul), so TF32 never enters; bf16
    or f16 x is widened to f32 first, which is exact; float64 x sums in
    float64 (``config.sum_dtype``)."""
    S, K = ell_col.shape
    C = x.shape[1]
    wd = sum_dtype(x.dtype)
    nbrs = x.index_select(0, ell_col.reshape(-1).long().clamp(0, x.shape[0] - 1))
    part = (ell_val.to(wd)[:, :, None] * nbrs.to(wd).reshape(S, K, C)).sum(1)
    out = torch.zeros((num_rows + 1, C), dtype=wd, device=x.device)
    out.index_add_(0, ell_row.long().clamp(0, num_rows), part)
    return out[:num_rows]


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_VP, _I32, _I64, _I32, _I32, _VP, _VP, _VP, _I64, _I32, _I64, _VP, _I32, _VP, _I64,
             _VP, _VP]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ell_aggregate: {msg}")


def check_dtype(kernel: str, name: str, t: torch.Tensor) -> None:
    """The kernels of rows 1-4 take f32 rows, or bf16 or f16 rows under
    16-bit compute; any other dtype is refused by name, on every device."""
    if t.dtype not in X_DTYPES:
        raise ValueError(
            f"{kernel}: {name} must be float32, bfloat16 or float16, got {t.dtype}")


def count_launch(fn, dtype) -> None:
    """One launch of ``fn``'s kernel in the mode of its rows' dtype."""
    attr = LAUNCH_COUNTERS[dtype]
    setattr(fn, attr, getattr(fn, attr) + 1)


def ell_aggregate(x, ell_row, ell_col, ell_val, num_rows: int,
                  ptr: Optional[torch.Tensor] = None,
                  long_rows: Optional[torch.Tensor] = None,
                  panels: Optional[int] = None) -> torch.Tensor:
    """Kernel 1 for CUDA tensors, its plain version for CPU tensors.

    ``ptr`` ([num_rows + 1] int32, :func:`row_offsets_plain` of ``ell_row``)
    is built on the device when not given; the kernel clamps it to the S
    slots.  ``long_rows`` (int32 ``spmm.long_rows_host(ptr, t)``: the
    threshold t, then exactly the rows of more than t slots, longest first)
    starts those rows first, a warp each; without it every row goes in index
    order.  ``panels`` forces the number of channel panels (by default
    :func:`panel_width`).  The result depends on none of these.  x is f32,
    bf16 or f16 (the 16-bit-row modes); out is f32."""
    check_dtype("ell_aggregate", "x", x)
    if x.device.type == "cpu":
        return ell_aggregate_plain(x, ell_row, ell_col, ell_val, num_rows)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be a contiguous 2-D tensor")
    _check(x.shape[0] >= 1, "x needs at least one row")
    _check(ell_col.dim() == 2 and ell_col.shape[1] >= 1, "ell_col must be [S, K] with K >= 1")
    S, K = ell_col.shape
    checks = [
        ("ell_row", ell_row, torch.int32, (S,)),
        ("ell_col", ell_col, torch.int32, (S, K)),
        ("ell_val", ell_val, torch.float32, (S, K)),
    ]
    if ptr is not None:
        checks.append(("ptr", ptr, torch.int32, (num_rows + 1,)))
    if long_rows is not None:
        _check(ptr is not None, "long_rows need the row offsets they were taken from")
        _check(long_rows.dim() == 1 and long_rows.shape[0] >= 1,
               "long_rows must be [1 + n]: its threshold, then its rows")
        checks.append(("long_rows", long_rows, torch.int32, (long_rows.shape[0],)))
    for name, t, dt, shape in checks:
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.dtype == dt and tuple(t.shape) == shape and t.is_contiguous(),
               f"{name} must be contiguous {dt} of shape {shape}")
    C = x.shape[1]
    if panels is None:
        Cp = panel_width(C, x.dtype)
    else:
        _check(1 <= panels <= C, f"panels must be in [1, {C}], got {panels}")
        unit = _lane_unit(C, x.dtype)
        Cp = -(-C // panels)  # ceil(C / panels) ...
        Cp = -(-Cp // unit) * unit  # ... up to a multiple of the unit
    out = torch.empty((num_rows, C), dtype=torch.float32, device=x.device)
    build_ptr = ptr is None
    if build_ptr:
        ptr = torch.empty((num_rows + 1,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.function("ell_aggregate", "vq_ell_aggregate", _ARGTYPES)(
        x.data_ptr(), X_DTYPES[x.dtype], x.shape[0], C, Cp, ell_row.data_ptr(), ell_col.data_ptr(),
        ell_val.data_ptr(), S, K, num_rows, ptr.data_ptr(), int(build_ptr),
        None if long_rows is None else long_rows.data_ptr(),
        0 if long_rows is None else long_rows.shape[0] - 1, out.data_ptr(), stream,
    )
    _build.check(rc, "ell_aggregate")
    count_launch(ell_aggregate, x.dtype)
    return out


ell_aggregate.launches = ell_aggregate.launches_bf16 = ell_aggregate.launches_f16 = 0
