"""Kernels 9 and 10: the B + M (v1) exact-reverse recovery term over the
rev-ELL layout, forward and backward, with its plain PyTorch version.

``rev_recovery_info(c_indices [N+1, nb] int16, slot_col [S, K] int32,
slot_val [S, K] f32, slot_row [S] int32, xb [nb, B_pad, Dg], al [nb, B_pad],
arcb [nb, M], gbar [nb, M, Dg])`` -> ``info [nb]``, per branch n::

    S_n[b, m] = sum of slot_val over the cells of row b whose neighbour has
                codeword m in branch n (c_indices at slot_col)
    info[n]   = sum_{b, m} relu(S_n[b, m]) * exp(leaky_0.2(al[n, b] + arcb[n, m]))
                * <xb[n, b], gbar[n, m]>

The relu applies to the per-(row, codeword) sum, not per cell.  A
``torch.autograd.Function``: differentiable in ``xb``, ``al`` and ``arcb``;
the values, codewords and the grad table ``gbar`` carry no gradient (the
reference's stop-gradient hook payload).  On CUDA tensors the forward is
kernel 9 and the backward kernel 10 (``csrc/rev_recovery.cu``, replacing
``vq_gnn_tpu/ops/pallas_rev.py:_fwd_kernel`` and ``_bwd_kernel``); on CPU
tensors both are the plain version, whose backward is autograd through it.
The kernels read each row's slots through the batch's row offsets and its
list of long rows (``PaddedBatch.rev_row_ptr``, ``rev_long_rows``), which
they require; the plain version reads ``slot_row``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.ops.rev_ell import REV_LONG_SLOTS


def rev_recovery_info_plain(c_indices, slot_col, slot_val, slot_row, xb, al, arcb, gbar):
    """The grid path of ``vq_gnn_tpu/nn/model.py:_bm_exact_reverse_info`` over
    the rev-ELL inputs: per branch an ``index_add_`` of the cell values into a
    [M * B_pad] grid, relu, the attention surface and the <xb, gbar> dot, all
    elementwise (no TF32 product)."""
    nb, B_pad, Dg = xb.shape
    M = arcb.shape[1]
    S, K = slot_col.shape
    cols = slot_col.reshape(-1).long().clamp(0, c_indices.shape[0] - 1)
    code = c_indices.index_select(0, cols).long().t()  # [nb, S*K]
    rows = slot_row.long().repeat_interleave(K)  # pad slots: B_pad
    cell = torch.where(rows < B_pad, code * B_pad + rows, M * B_pad)  # pads -> dustbin
    grid = torch.zeros((nb, M * B_pad + 1), dtype=torch.float32, device=xb.device)
    grid.scatter_add_(1, cell, slot_val.reshape(1, -1).float().expand(nb, -1))
    s = F.relu(grid[:, : M * B_pad].reshape(nb, M, B_pad))
    att = torch.exp(F.leaky_relu(al[:, None, :] + arcb[:, :, None], 0.2))
    G = gbar[:, :, None, 0] * xb[:, None, :, 0]
    for d in range(1, Dg):
        G = G + gbar[:, :, None, d] * xb[:, None, :, d]
    return (s * att * G).sum((1, 2))


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"rev_recovery_info: {msg}")


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_COMMON = [_VP, _I64, _VP, _VP, _I64, _I32, _VP, _VP, _I32, _VP, _VP, _VP, _VP, _I32, _I64, _I32,
           _I32, _VP, _I64]
_FWD_ARGTYPES = _COMMON + [_VP, _VP]
_BWD_ARGTYPES = _COMMON + [_VP, _VP, _VP, _VP, _VP]
_SCRATCH_ARGTYPES = [_I32, _I32, _I64, _I32, _I32, _I64, _I32, ctypes.POINTER(ctypes.c_int64)]


def _checked(bwd, c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar):
    """Validate the CUDA inputs; returns (nb, B_pad, Dg, M), the C entry
    points' leading arguments and the call's scratch (sized by the C side,
    ``vq_rev_scratch_bytes``)."""
    dev = xb.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(row_ptr is not None and long_rows is not None,
           "the CUDA kernels need the batch's row offsets and long rows (PaddedBatch."
           "rev_row_ptr, rev_long_rows)")
    _check(xb.dim() == 3 and arcb.dim() == 2, "xb [nb, B_pad, Dg] and arcb [nb, M] expected")
    nb, B_pad, Dg = xb.shape
    M = arcb.shape[1]
    S, K = slot_col.shape
    _check(REV_LONG_SLOTS * K <= 32,
           f"K = {K}: a row of REV_LONG_SLOTS = {REV_LONG_SLOTS} slots exceeds a warp of cells")
    _check(long_rows.dim() == 1 and long_rows.shape[0] >= 1,
           "long_rows must be [1 + n]: the threshold, then the rows")
    for name, t, dt, shape in (
        ("c_indices", c_indices, torch.int16, (c_indices.shape[0], nb)),
        ("slot_col", slot_col, torch.int32, (S, K)),
        ("slot_val", slot_val, torch.float32, (S, K)),
        ("row_ptr", row_ptr, torch.int32, (B_pad + 1,)),
        ("long_rows", long_rows, torch.int32, (long_rows.shape[0],)),
        ("xb", xb, torch.float32, (nb, B_pad, Dg)),
        ("al", al, torch.float32, (nb, B_pad)),
        ("arcb", arcb, torch.float32, (nb, M)),
        ("gbar", gbar, torch.float32, (nb, M, Dg)),
    ):
        _check(t.device == dev and t.dtype == dt and tuple(t.shape) == shape
               and t.is_contiguous(),
               f"{name} must be contiguous {dt} of shape {shape} on {dev}, got "
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
    nbytes = ctypes.c_int64()
    rc = _build.function("rev_recovery", "vq_rev_scratch_bytes", _SCRATCH_ARGTYPES)(
        int(bwd), nb, B_pad, M, Dg, S, K, ctypes.byref(nbytes))
    _check(rc == 0, f"nb = {nb}, M = {M}, Dg = {Dg}, K = {K}: outside what the kernels take "
           "(Dg at most 15, a table row; M at most 29,024, a block's shared memory)")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    args = (c_indices.data_ptr(), c_indices.shape[0], slot_col.data_ptr(), slot_val.data_ptr(),
            S, K, row_ptr.data_ptr(), long_rows.data_ptr(), long_rows.shape[0] - 1,
            xb.data_ptr(), al.data_ptr(), arcb.data_ptr(), gbar.data_ptr(), nb, B_pad, M, Dg,
            scratch.data_ptr(), scratch.numel())
    return (nb, B_pad, Dg, M), args, scratch


def rev_forward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar):
    """Kernel 9: info [nb] (CUDA tensors only).  The kernel reads each row's
    slots through ``row_ptr`` [B_pad + 1] and ``long_rows`` (the threshold,
    then the rows of more slots), the batch's ``rev_row_ptr`` and
    ``rev_long_rows``."""
    (nb, *_), args, scratch = _checked(False, c_indices, slot_col, slot_val, row_ptr, long_rows,
                                       xb, al, arcb, gbar)  # scratch: alive over the launch
    info = torch.empty(nb, dtype=torch.float32, device=xb.device)
    rc = _build.function("rev_recovery", "vq_rev_forward", _FWD_ARGTYPES)(
        *args, info.data_ptr(), torch.cuda.current_stream(xb.device).cuda_stream)
    _build.check(rc, "rev_forward")
    rev_forward.launches += 1
    return info


def rev_backward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar, g):
    """Kernel 10: (d_xb, d_al, d_arcb) for the per-branch cotangent g [nb]
    (CUDA tensors only; the rows as for rev_forward)."""
    (nb, B_pad, Dg, M), args, scratch = _checked(True, c_indices, slot_col, slot_val, row_ptr,
                                                 long_rows, xb, al, arcb, gbar)
    _check(g.device == xb.device and g.dtype == torch.float32 and tuple(g.shape) == (nb,)
           and g.is_contiguous(), f"g must be contiguous float32 [{nb}]")
    dev = xb.device
    d_xb = torch.empty((nb, B_pad, Dg), dtype=torch.float32, device=dev)
    d_al = torch.empty((nb, B_pad), dtype=torch.float32, device=dev)
    d_arcb = torch.empty((nb, M), dtype=torch.float32, device=dev)
    rc = _build.function("rev_recovery", "vq_rev_backward", _BWD_ARGTYPES)(
        *args, g.data_ptr(), d_xb.data_ptr(), d_al.data_ptr(), d_arcb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "rev_backward")
    rev_backward.launches += 1
    return d_xb, d_al, d_arcb


rev_forward.launches = 0
rev_backward.launches = 0


class _RevInfo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr, long_rows):
        ctx.save_for_backward(xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr,
                              long_rows)
        return rev_forward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar)

    @staticmethod
    def backward(ctx, g):
        xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr, long_rows = \
            ctx.saved_tensors
        d_xb, d_al, d_arcb = rev_backward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb,
                                          al, arcb, gbar, g.contiguous())
        return d_xb, d_al, d_arcb, None, None, None, None, None, None


def rev_recovery_info(c_indices, slot_col, slot_val, slot_row, xb, al, arcb, gbar,
                      row_ptr=None, long_rows=None):
    """Kernels 9 and 10 for CUDA tensors (which need the batch's ``row_ptr``
    and ``long_rows``), the plain version for CPU tensors."""
    if xb.device.type == "cpu":
        return rev_recovery_info_plain(c_indices, slot_col, slot_val, slot_row, xb, al, arcb,
                                       gbar)
    return _RevInfo.apply(xb.contiguous(), al.contiguous(), arcb.contiguous(), c_indices,
                          slot_col, slot_val, gbar.contiguous(), row_ptr, long_rows)
