"""Kernels 4 and 5: the GAT attention aggregate and its transposed backward,
each with its plain PyTorch version.

Both take the per-node logits ``al = (x @ att_l[:C] + att_l[C]) / scale``
and ``ar = (x @ att_r[:C] + att_r[C]) / scale``; a cell of row r and column
c has ``a = al[c] + ar[r]`` and weight ``ev = exp(leaky_relu(a, 0.2)) * val``.

- ``gat_aggregate(x [Rx,C], ell_row, ell_col, ell_val, al [Rx], ar [R], R,
  with_neg, ptr, long_rows)`` -> (agg [R,C], rowsum [R], aggn [R,C] | None,
  rsn [R] | None):
  ``agg[r] = sum ev * x[col]``, ``rowsum[r] = sum ev``, and with ``with_neg``
  the same sums over the cells with ``a <= 0`` (``csrc/gat_aggregate.cu``,
  replacing ``vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel(gat=True)``).
- ``gat_backward(x [R,C], t_ell_row, t_ell_col, t_ell_val, g_agg [Rg,C],
  g_rowsum [Rg], al [R], ar [Rg], R, dx_rows)`` -> (dx_agg [R,C] | None,
  d_al [R]) over the transposed ELL (row = source s, column = destination d,
  ``a = al[s] + ar[d]``): ``dx_agg[s] = sum ev * g_agg[d]`` for the rows s <
  dx_rows (zeros above; None with dx_rows = 0) and ``d_al[s] = sum
  (<g_agg[d], x[s]> + g_rowsum[d]) * ev * slope'(a)`` for every row
  (``csrc/gat_backward.cu``, replacing ``pallas_ell.py:_make_bwd_kernel_merged``
  and ``_make_bwd_kernel``).

Slots are sorted by row; rows >= R are dropped; columns clip to the rows of
the gathered table (JAX's ``mode='clip'``).  On CPU tensors each wrapper runs
its plain version; on CUDA tensors it launches its kernel or raises.

Each has a bf16-row and an f16-row mode (``compute_dtype='bfloat16'`` or
``'float16'``), as the TPU kernels take 16-bit operands: ``gat_aggregate``'s
x, and ``gat_backward``'s x, g_agg, g_rowsum and ar, in bf16 or in f16; al
(and the aggregate's ar) and every output stay f32, and the values are
summed in f32.  Each wrapper counts the launches of those modes in
``launches_bf16`` and ``launches_f16``, the f32 mode's in ``launches``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.ops.ell_aggregate import X_DTYPES, check_dtype, count_launch

NEGATIVE_SLOPE = 0.2  # PyG GATConv default (reference convs.py v2:131)


def _cells(ell_row, ell_col, ell_val, row_logit, col_logit, n_rows: int, n_cols: int):
    """Per-cell (clamped cols, a, ev) of a slot-ELL, with a = row_logit at the
    slot's row + col_logit at the cell's column."""
    rows = ell_row.long().clamp(0, n_rows - 1)
    cols = ell_col.long().clamp(0, n_cols - 1)
    a = row_logit[rows][:, None] + col_logit[cols]
    ev = torch.exp(F.leaky_relu(a, NEGATIVE_SLOPE)) * ell_val
    return cols, a, ev


def _segsum(part, ell_row, num_rows: int):
    """Sorted-row segment sum; slots of rows >= num_rows are dropped."""
    out = part.new_zeros((num_rows + 1,) + tuple(part.shape[1:]))
    out.index_add_(0, ell_row.long().clamp(0, num_rows), part)
    return out[:num_rows]


def gat_aggregate_plain(x, ell_row, ell_col, ell_val, al, ar, num_rows: int,
                        with_neg: bool = True):
    """Plain version of kernel 4: the arithmetic of the XLA path of
    ``vq_gnn_tpu/ops/gat.py:_gat_conv_fwd_impl`` (gather, ev-weighted
    K-reduce, sorted segment sums).  bf16 or f16 x is widened to f32 first."""
    x = x.float()
    S, K = ell_col.shape
    C = x.shape[1]
    # the row side is ar (per output row), the column side al
    cols, a, ev = _cells(ell_row, ell_col, ell_val, ar, al, num_rows, x.shape[0])
    nbrs = x.index_select(0, cols.reshape(-1)).reshape(S, K, C)
    agg = _segsum((ev[:, :, None] * nbrs).sum(1), ell_row, num_rows)
    rowsum = _segsum(ev.sum(1), ell_row, num_rows)
    if not with_neg:
        return agg, rowsum, None, None
    evn = ev * (a <= 0)
    aggn = _segsum((evn[:, :, None] * nbrs).sum(1), ell_row, num_rows)
    rsn = _segsum(evn.sum(1), ell_row, num_rows)
    return agg, rowsum, aggn, rsn


def gat_backward_plain(x, t_ell_row, t_ell_col, t_ell_val, g_agg, g_rowsum, al, ar,
                       num_rows: int, dx_rows: Optional[int] = None):
    """Plain version of kernel 5: the arithmetic of the XLA transposed
    recompute in ``vq_gnn_tpu/ops/gat.py:_gat_conv_vjp_bwd``.  ``dx_rows``
    (default num_rows): dx_agg only for the rows below it, from the slots of
    those rows (a prefix, the rows being sorted), zeros above; None with 0.
    bf16 or f16 x, g_agg, g_rowsum and ar are widened to f32 first."""
    x, g_agg, g_rowsum, ar = (t.float() for t in (x, g_agg, g_rowsum, ar))
    dx_rows = num_rows if dx_rows is None else dx_rows
    St, K = t_ell_col.shape
    C = x.shape[1]
    dst, a, ev = _cells(t_ell_row, t_ell_col, t_ell_val, al, ar, num_rows, g_agg.shape[0])
    g3 = g_agg.index_select(0, dst.reshape(-1)).reshape(St, K, C)
    x_rows = x.index_select(0, t_ell_row.long().clamp(0, num_rows - 1))
    g_ev = (g3 * x_rows[:, None, :]).sum(-1) + g_rowsum[dst]
    d_a = g_ev * ev * torch.where(a > 0, 1.0, NEGATIVE_SLOPE)
    d_al = _segsum(d_a.sum(1), t_ell_row, num_rows)
    if dx_rows == 0:
        return None, d_al
    n = int(torch.searchsorted(t_ell_row, torch.tensor([dx_rows], dtype=t_ell_row.dtype,
                                                       device=t_ell_row.device)))
    dx_agg = x.new_zeros((num_rows, C))
    dx_agg[:dx_rows] = _segsum((ev[:n, :, None] * g3[:n]).sum(1), t_ell_row[:n], dx_rows)
    return dx_agg, d_al


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FWD_ARGTYPES = [_VP, _I32, _I64, _I32, _VP, _VP, _VP, _I64, _I32, _VP, _VP, _I64, _I32,
                 _VP, _I32, _VP, _I64, _VP, _VP, _VP, _VP, _VP]
_BWD_ARGTYPES = [_VP, _I32, _I32, _VP, _VP, _VP, _I64, _I32, _VP, _VP, _VP, _I64, _VP, _I64,
                 _I64, _VP, _I32, _VP, _I64, _VP, _VP, _VP]


def _check(cond: bool, kernel: str, msg: str):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_tensors(kernel: str, dev, specs):
    """Each (name, tensor, dtype, shape) must be a contiguous tensor of that
    type and shape on ``dev``."""
    for name, t, dt, shape in specs:
        _check(t.device == dev, kernel, f"{name} is on {t.device}, expected {dev}")
        _check(t.dtype == dt and tuple(t.shape) == tuple(shape) and t.is_contiguous(), kernel,
               f"{name} must be contiguous {dt} of shape {tuple(shape)}, got "
               f"{t.dtype} {tuple(t.shape)}")


def _ell_specs(prefix, row, col, val):
    S, K = col.shape
    return [(f"{prefix}row", row, torch.int32, (S,)), (f"{prefix}col", col, torch.int32, (S, K)),
            (f"{prefix}val", val, torch.float32, (S, K))]


def _row_list_specs(k: str, ptr, long_rows, num_rows: int):
    """Checks of the optional row offsets and long-row list a kernel takes."""
    specs = []
    if ptr is not None:
        specs.append(("ptr", ptr, torch.int32, (num_rows + 1,)))
    if long_rows is not None:
        _check(ptr is not None, k, "long_rows need the row offsets they were taken from")
        _check(long_rows.dim() == 1 and long_rows.shape[0] >= 1, k,
               "long_rows must be [1 + n]: its threshold, then its rows")
        specs.append(("long_rows", long_rows, torch.int32, (long_rows.shape[0],)))
    return specs


def gat_aggregate(x, ell_row, ell_col, ell_val, al, ar, num_rows: int, with_neg: bool = True,
                  ptr: Optional[torch.Tensor] = None,
                  long_rows: Optional[torch.Tensor] = None):
    """Kernel 4 for CUDA tensors, its plain version for CPU tensors.

    ``ptr`` ([num_rows + 1] int32 row offsets of ``ell_row``,
    ``spmm.row_offsets_host``) is built on the device when not given;
    ``long_rows`` (int32 ``spmm.long_rows_host(ptr, t)``) starts the rows of
    more than t slots first, a warp each.  The result depends on neither.
    x is f32, bf16 or f16 (the 16-bit-row modes); al, ar and the outputs
    are f32."""
    k = "gat_aggregate"
    check_dtype(k, "x", x)
    if x.device.type == "cpu":
        return gat_aggregate_plain(x, ell_row, ell_col, ell_val, al, ar, num_rows, with_neg)
    dev = x.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    _check(x.dim() == 2 and x.shape[0] >= 1, k, "x must be [rows >= 1, C]")
    _check(ell_col.dim() == 2 and ell_col.shape[1] >= 1, k,
           "ell_col must be [S, K] with K >= 1")
    Rx, C = x.shape
    S, K = ell_col.shape
    _check_tensors(k, dev, [("x", x, x.dtype, (Rx, C)),
                            *_ell_specs("ell_", ell_row, ell_col, ell_val),
                            ("al", al, torch.float32, (Rx,)),
                            ("ar", ar, torch.float32, (num_rows,)),
                            *_row_list_specs(k, ptr, long_rows, num_rows)])
    agg = torch.empty((num_rows, C), dtype=torch.float32, device=dev)
    rowsum = torch.empty((num_rows,), dtype=torch.float32, device=dev)
    aggn = torch.empty_like(agg) if with_neg else None
    rsn = torch.empty_like(rowsum) if with_neg else None
    build_ptr = ptr is None
    if build_ptr:
        ptr = torch.empty((num_rows + 1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.function("gat_aggregate", "vq_gat_aggregate", _FWD_ARGTYPES)(
        x.data_ptr(), X_DTYPES[x.dtype], Rx, C, ell_row.data_ptr(), ell_col.data_ptr(),
        ell_val.data_ptr(), S, K,
        al.data_ptr(), ar.data_ptr(), num_rows, int(with_neg), ptr.data_ptr(), int(build_ptr),
        None if long_rows is None else long_rows.data_ptr(),
        0 if long_rows is None else long_rows.shape[0] - 1, agg.data_ptr(),
        rowsum.data_ptr(), aggn.data_ptr() if with_neg else None,
        rsn.data_ptr() if with_neg else None, stream,
    )
    _build.check(rc, k)
    count_launch(gat_aggregate, x.dtype)
    return agg, rowsum, aggn, rsn


def gat_backward(x, t_ell_row, t_ell_col, t_ell_val, g_agg, g_rowsum, al, ar, num_rows: int,
                 dx_rows: Optional[int] = None, ptr: Optional[torch.Tensor] = None,
                 long_rows: Optional[torch.Tensor] = None):
    """Kernel 5 for CUDA tensors, its plain version for CPU tensors.  Counts
    its launches per width C and row dtype, ``(C, 'float32', 'bfloat16' or
    'float16')``, in ``gat_backward.by_width``.

    ``dx_rows`` (default num_rows): dx_agg for the rows below it, zeros
    above, None with 0; d_al for every row.  ``ptr`` ([num_rows + 1] int32
    row offsets of ``t_ell_row`` over every row, ``spmm.row_offsets_host``)
    is built on the device when not given; ``long_rows`` (int32
    ``spmm.long_rows_host(ptr, t)``) starts the rows of more than t slots
    first, a warp each.  The result depends on none of these three but
    dx_rows.  x, g_agg, g_rowsum and ar are all f32, or all bf16, or all f16
    (the 16-bit-row modes); al and the outputs are f32."""
    k = "gat_backward"
    check_dtype(k, "x", x)
    dx_rows = num_rows if dx_rows is None else dx_rows
    if x.device.type == "cpu":
        return gat_backward_plain(x, t_ell_row, t_ell_col, t_ell_val, g_agg, g_rowsum, al, ar,
                                  num_rows, dx_rows)
    dev = x.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    _check(x.dim() == 2 and g_agg.dim() == 2 and g_agg.shape[0] >= 1, k,
           "x [R, C] and g_agg [rows >= 1, C] expected")
    C = x.shape[1]
    Rg = g_agg.shape[0]
    _check(C >= 1, k, f"C must be >= 1, got {C}")
    _check(0 <= dx_rows <= num_rows, k, f"dx_rows must be in [0, {num_rows}], got {dx_rows}")
    _check(t_ell_col.dim() == 2 and t_ell_col.shape[1] >= 1, k,
           "t_ell_col must be [St, K] with K >= 1")
    St, K = t_ell_col.shape
    xt = x.dtype  # the rows' dtype: g_agg, g_rowsum and ar come in it too
    _check_tensors(k, dev, [("x", x, xt, (num_rows, C)),
                            *_ell_specs("t_ell_", t_ell_row, t_ell_col, t_ell_val),
                            ("g_agg", g_agg, xt, (Rg, C)),
                            ("g_rowsum", g_rowsum, xt, (Rg,)),
                            ("al", al, torch.float32, (num_rows,)),
                            ("ar", ar, xt, (Rg,)),
                            *_row_list_specs(k, ptr, long_rows, num_rows)])
    dx = torch.empty((num_rows, C), dtype=torch.float32, device=dev) if dx_rows else None
    d_al = torch.empty((num_rows,), dtype=torch.float32, device=dev)
    build_ptr = ptr is None
    if build_ptr:
        ptr = torch.empty((num_rows + 1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.function("gat_backward", "vq_gat_backward", _BWD_ARGTYPES)(
        x.data_ptr(), X_DTYPES[xt], C, t_ell_row.data_ptr(), t_ell_col.data_ptr(),
        t_ell_val.data_ptr(), St, K,
        g_agg.data_ptr(), g_rowsum.data_ptr(), ar.data_ptr(), Rg, al.data_ptr(), num_rows,
        dx_rows, ptr.data_ptr(), int(build_ptr),
        None if long_rows is None else long_rows.data_ptr(),
        0 if long_rows is None else long_rows.shape[0] - 1,
        None if dx is None else dx.data_ptr(), d_al.data_ptr(), stream,
    )
    _build.check(rc, k)
    count_launch(gat_backward, xt)
    gat_backward.by_width[(C, str(xt).removeprefix("torch."))] += 1
    return dx, d_al


gat_aggregate.launches = gat_aggregate.launches_bf16 = gat_aggregate.launches_f16 = 0
gat_backward.launches = gat_backward.launches_bf16 = gat_backward.launches_f16 = 0
gat_backward.by_width = collections.Counter()
