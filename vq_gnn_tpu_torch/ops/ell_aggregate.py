"""Kernel 1: the slot-ELL aggregate, and its plain PyTorch version.

``out[r] = sum over slots s of row r, sum over k of val[s,k] * x[col[s,k]]``,
f32 [num_rows, C].  Slots are sorted by row; slots whose row is >= num_rows
(padding, or the backward's ride-over dustbin) are dropped; columns clip to
the rows of x (JAX's ``mode='clip'``).

The CUDA kernel (``csrc/ell_aggregate.cu``) replaces
``vq_gnn_tpu/ops/pallas_ell.py:_make_fwd_kernel`` (gat=False) and the gather
in front of it; see the source for what bounds it on the H100.
"""

from __future__ import annotations

import ctypes

import torch

from vq_gnn_tpu_torch.ops import _build


def ell_aggregate_plain(x, ell_row, ell_col, ell_val, num_rows: int) -> torch.Tensor:
    """Gather, weight, K-reduce, then a sorted segment sum — in plain
    PyTorch.  Elementwise products (no matmul), so TF32 never enters."""
    S, K = ell_col.shape
    C = x.shape[1]
    nbrs = x.index_select(0, ell_col.reshape(-1).long().clamp(0, x.shape[0] - 1))
    part = (ell_val.float()[:, :, None] * nbrs.float().reshape(S, K, C)).sum(1)
    out = torch.zeros((num_rows + 1, C), dtype=torch.float32, device=x.device)
    out.index_add_(0, ell_row.long().clamp(0, num_rows), part)
    return out[:num_rows]


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_VP, _I64, _I32, _VP, _VP, _VP, _I64, _I32, _I64, _VP, _VP, _VP]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ell_aggregate: {msg}")


def ell_aggregate(x, ell_row, ell_col, ell_val, num_rows: int) -> torch.Tensor:
    """Kernel 1 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ell_aggregate_plain(x, ell_row, ell_col, ell_val, num_rows)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dtype == torch.float32 and x.dim() == 2 and x.is_contiguous(),
           "x must be a contiguous 2-D float32 tensor")
    _check(x.shape[0] >= 1, "x needs at least one row")
    S, K = ell_col.shape
    for name, t, dt, shape in (
        ("ell_row", ell_row, torch.int32, (S,)),
        ("ell_col", ell_col, torch.int32, (S, K)),
        ("ell_val", ell_val, torch.float32, (S, K)),
    ):
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.dtype == dt and tuple(t.shape) == shape and t.is_contiguous(),
               f"{name} must be contiguous {dt} of shape {shape}")
    C = x.shape[1]
    out = torch.empty((num_rows, C), dtype=torch.float32, device=x.device)
    ptr = torch.empty((num_rows + 1,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.function("ell_aggregate", "vq_ell_aggregate", _ARGTYPES)(
        x.data_ptr(), x.shape[0], C, ell_row.data_ptr(), ell_col.data_ptr(),
        ell_val.data_ptr(), S, K, num_rows, ptr.data_ptr(), out.data_ptr(), stream,
    )
    _build.check(rc, "ell_aggregate")
    ell_aggregate.launches += 1
    return out


ell_aggregate.launches = 0
