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
"""

from __future__ import annotations

import ctypes

import torch

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
    collecting the padding slots.  The row lists are checked and not used."""
    _check_lists(ptr, long_rows, num_rows)
    res = []
    if partials is not None:
        res.append(_plain(partials.float(), seg, num_rows))
    if scalar_partials is not None:
        res.append(_plain(scalar_partials.float(), seg, num_rows))
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
