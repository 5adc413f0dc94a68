"""Kernel 8: the sorted segment sum, and its plain PyTorch version.

``segment_sum_sorted(partials [S, C] | None, seg [S], num_rows,
scalar_partials [S] | None, ptr, long_rows)`` -> ``out [num_rows, C]``,
``out_s [num_rows]``, or both as a pair: ``out[r] = sum of partials[s] over
the slots with seg[s] == r``, the same over ``scalar_partials`` for
``out_s``.  ``seg`` is int32 and ascending; slots with ``seg >= num_rows``
(padding) are dropped; rows without a slot get 0.  Any C, the 32-wide
per-branch scalars included.  ``ptr`` and ``long_rows`` are the batch's row
offsets and long-row list (``Edges.ell_ptr`` / ``ell_long_rows`` and their
transposed counterparts), as ``ell_aggregate`` takes them; the result does
not depend on them.

The CUDA kernel (``csrc/segment_sum.cu``) replaces
``vq_gnn_tpu/ops/pallas_segsum.py:_make_kernel``; on CPU tensors the wrapper
runs the plain version, on CUDA tensors it launches the kernel or raises.
Launches with the scalar channel (the mixed-K GAT conv's normaliser and
d_al) count in ``launches_scalar``, the others in ``launches``.

Sums in a fixed order are built on it, for the places where PyTorch's own
would add floats with atomics on CUDA, in a new order each run:
:func:`take_rows`, rows of a table whose backward sums each row's
cotangents by kernel 8 (``index_select``'s backward is ``index_add_``),
its indices sorted on the device (stable: a row's cotangents keep their
order); :func:`take_listed`, the same over an order and row offsets the
host built with the batch; and :func:`sum_at`, values summed at keys into
a vector (for ``scatter_add_``).  Each gives the same bits run to run.
"""

from __future__ import annotations

import ctypes

import torch

from vq_gnn_tpu_torch.config import sum_dtype
from vq_gnn_tpu_torch.ops import _build


def _plain(part, seg, num_rows: int):
    out = part.new_zeros((num_rows + 1,) + tuple(part.shape[1:]))
    out.index_add_(0, seg.long().clamp(0, num_rows), part)
    return out[:num_rows]


def _fail(msg: str):
    raise ValueError(f"segment_sum_sorted: {msg}")


def _check_lists(ptr, long_rows, num_rows: int):
    """The row-list contract of ``ell_aggregate``: ``ptr`` [num_rows + 1]
    int32; ``long_rows`` [1 + n] int32 (its threshold, then its rows), only
    beside the ``ptr`` it was taken from.  (Messages are formatted only on
    failure: the wrapper runs these on every launch.)"""
    if ptr is not None and not (ptr.dtype == torch.int32 and ptr.shape == (num_rows + 1,)
                                and ptr.is_contiguous()):
        _fail(f"ptr must be contiguous int32 [{num_rows + 1}]")
    if long_rows is not None:
        if ptr is None:
            _fail("long_rows need the row offsets they were taken from")
        if not (long_rows.dtype == torch.int32 and long_rows.dim() == 1
                and long_rows.shape[0] >= 1 and long_rows.is_contiguous()):
            _fail("long_rows must be contiguous int32 [1 + n]: its threshold, then its rows")


def segment_sum_sorted_plain(partials, seg, num_rows: int, scalar_partials=None, ptr=None,
                             long_rows=None):
    """Plain version: ``index_add_`` into num_rows + 1 rows, the last one
    collecting the padding slots, in f32 (float64 partials in float64).
    The row lists are checked and not used."""
    _check_lists(ptr, long_rows, num_rows)
    res = []
    if partials is not None:
        res.append(_plain(partials.to(sum_dtype(partials.dtype)), seg, num_rows))
    if scalar_partials is not None:
        res.append(_plain(scalar_partials.to(sum_dtype(scalar_partials.dtype)), seg,
                          num_rows))
    return res[0] if len(res) == 1 else tuple(res)


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_VP, _I32, _VP, _VP, _I64, _I64, _VP, _I32, _VP, _I64, _VP, _VP, _VP]


def segment_sum_sorted(partials, seg, num_rows: int, scalar_partials=None, ptr=None,
                       long_rows=None):
    """Kernel 8 for CUDA tensors, its plain version for CPU tensors.  Without
    ``ptr`` the row offsets are built on the device first; without
    ``long_rows`` every row goes in index order."""
    if partials is None and scalar_partials is None:
        _fail("no channel given")
    if seg.device.type == "cpu":
        return segment_sum_sorted_plain(partials, seg, num_rows, scalar_partials, ptr,
                                        long_rows)
    dev = seg.device
    if dev.type != "cuda":
        _fail(f"unsupported device {dev}")
    if not (seg.dtype == torch.int32 and seg.dim() == 1 and seg.is_contiguous()):
        _fail("seg must be a contiguous 1-D int32 tensor")
    _check_lists(ptr, long_rows, num_rows)
    if (ptr is not None and ptr.device != dev) or (long_rows is not None
                                                   and long_rows.device != dev):
        _fail(f"the row lists must be on {dev}")
    S = seg.shape[0]
    C = 0
    if partials is not None:
        if not (partials.device == dev and partials.dtype == torch.float32
                and partials.dim() == 2 and partials.shape[0] == S and partials.is_contiguous()):
            _fail(f"partials must be contiguous float32 [{S}, C] on {dev}")
        C = partials.shape[1]
    if scalar_partials is not None and not (
            scalar_partials.device == dev and scalar_partials.dtype == torch.float32
            and scalar_partials.shape == (S,) and scalar_partials.is_contiguous()):
        _fail(f"scalar_partials must be contiguous float32 [{S}] on {dev}")
    out = out_s = None
    if partials is not None:
        out = torch.empty((num_rows, C), dtype=torch.float32, device=dev)
    if scalar_partials is not None:
        out_s = torch.empty((num_rows,), dtype=torch.float32, device=dev)
    build_ptr = ptr is None
    if build_ptr:
        ptr = torch.empty((num_rows + 1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.function("segment_sum", "vq_segment_sum", _ARGTYPES)(
        partials.data_ptr() if C else None, C,
        scalar_partials.data_ptr() if scalar_partials is not None else None,
        seg.data_ptr(), S, num_rows, ptr.data_ptr(), int(build_ptr),
        None if long_rows is None else long_rows.data_ptr(),
        0 if long_rows is None else long_rows.shape[0] - 1,
        out.data_ptr() if C else None,
        out_s.data_ptr() if out_s is not None else None, stream,
    )
    _build.check(rc, "segment_sum_sorted")
    if scalar_partials is not None:  # the scalar channel's launches apart
        segment_sum_sorted.launches_scalar += 1
    else:
        segment_sum_sorted.launches += 1
    res = [t for t in (out, out_s) if t is not None]
    return res[0] if len(res) == 1 else tuple(res)


segment_sum_sorted.launches = 0
segment_sum_sorted.launches_scalar = 0


class _TakeRows(torch.autograd.Function):
    """``table.index_select(0, i)`` for each index tensor ``i``; the
    backward sums the cotangents of every taken row in a fixed order:
    the indices of all the calls concatenated and sorted by row (stable, so
    a row's cotangents keep their order: the first index tensor's, then the
    next one's, each in index order), summed by kernel 8 in f32 (by its
    plain version in float64 for a float64 table) and cast to the table's
    dtype."""

    @staticmethod
    def forward(ctx, table, *idx):
        ctx.save_for_backward(*idx)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return tuple(table.index_select(0, i) for i in idx)

    @staticmethod
    def backward(ctx, *grads):
        idx = ctx.saved_tensors
        like = next(g for g in grads if g is not None)
        g = torch.cat([like.new_zeros((i.shape[0],) + like.shape[1:]) if g is None else g
                       for g, i in zip(grads, idx)])
        g = g.to(sum_dtype(g.dtype))
        g = g.reshape(g.shape[0], -1)
        seg, order = torch.sort(torch.cat(idx), stable=True)
        out = segment_sum_sorted(g.index_select(0, order).contiguous(), seg.to(torch.int32),
                                 ctx.num_rows)
        return (out.reshape((ctx.num_rows,) + like.shape[1:]).to(ctx.dtype),) + (None,) * len(idx)


def take_rows(table, *idx):
    """(table[i] for i in idx), differentiable in ``table`` with
    :class:`_TakeRows`' backward: the same bits run to run."""
    return _TakeRows.apply(table, *idx)


class _TakeListed(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose backward sums each row's
    cotangents by kernel 8 in the order the host's lists give: ``seg`` the
    indices in that order (``perm`` of them, or as they are), ascending,
    with their row offsets ``ptr`` and long rows over ``rows`` rows (an
    Edges' ``row_ptr`` / ``t_row_ptr``): no sort and no offsets on the
    device.  Segments at ``rows`` or past it (padding) are dropped, and the
    table's rows past ``rows`` get 0."""

    @staticmethod
    def forward(ctx, table, idx, seg, perm, rows, ptr, long_rows):
        ctx.save_for_backward(seg, perm, ptr, long_rows)
        ctx.shape, ctx.dtype, ctx.rows = table.shape, table.dtype, rows
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        seg, perm, ptr, long_rows = ctx.saved_tensors
        g = g.to(sum_dtype(g.dtype)).reshape(g.shape[0], -1)
        if perm is not None:
            g = g.index_select(0, perm)
        out = segment_sum_sorted(g.contiguous(), seg, ctx.rows, ptr=ptr, long_rows=long_rows)
        pad = out.new_zeros((ctx.shape[0] - ctx.rows, out.shape[1]))
        d = torch.cat([out, pad]).reshape(ctx.shape).to(ctx.dtype)
        return d, None, None, None, None, None, None


def take_listed(table, idx, seg, perm, rows: int, ptr, long_rows):
    """``table[idx]`` with :class:`_TakeListed`'s backward (the arguments
    there); ``ptr`` None (lists of another row count), kernel 8 builds the
    offsets."""
    return _TakeListed.apply(table, idx, seg, perm, rows, ptr, long_rows)


def sum_at(keys, vals, size: int):
    """f32 [size] (float64 for float64 ``vals``): ``vals`` summed at ``keys``
    (int64, each in [0, size)), as ``zeros(size).scatter_add_(0, keys,
    vals)`` but in a fixed order: the keys sorted (stable), each distinct
    key's values summed by kernel 8 in their order (its row offsets the
    distinct keys' counts, summed up: no search), written once."""
    k, order = torch.sort(keys, stable=True)
    uniq, inv, counts = torch.unique_consecutive(k, return_inverse=True, return_counts=True)
    ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    wd = sum_dtype(vals.dtype)
    sums = segment_sum_sorted(vals.index_select(0, order).to(wd)[:, None].contiguous(),
                              inv.to(torch.int32), uniq.shape[0], ptr=ptr)
    out = torch.zeros(size, dtype=wd, device=vals.device)
    out[uniq] = sums[:, 0]
    return out
