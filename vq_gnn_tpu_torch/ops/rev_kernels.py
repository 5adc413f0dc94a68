"""Kernels 9 and 10: the B + M (v1) exact-reverse recovery term over the
rev-ELL layout, forward and backward, with its plain PyTorch version.

``rev_recovery_info(c_indices [N+1, nb] int16, slot_col [S, K] int32,
slot_val [S, K] f32, slot_row [S] int32, xb [nb, B_pad, Dg], al [nb, B_pad],
arcb [nb, M], gbar [nb, M, Dg])`` -> ``info [nb]``, per branch n::

    S_n[b, m] = sum of slot_val over the cells of row b whose neighbour has
                codeword m in branch n (c_indices at slot_col)
    info[n]   = sum_{b, m} relu(S_n[b, m]) * exp(leaky_0.2(al[n, b] + arcb[n, m]))
                * <xb[n, b], gbar[n, m]>

The relu applies to the per-(row, codeword) sum, not per cell.  ``fold``
says how S is summed, as ``VQ_GNN_REV_FOLD`` does for the JAX package
(``vq_gnn_tpu/ops/pallas_rev.py:56-58, 194-270``; :func:`rev_fold_mode`):
'x2' and 'highest' sum the values in f32; 'fast' rounds each value to bf16,
sums a codeword's cells of one K-cell slot in k order in bf16 (a rounding
after every add) and those slot parts in f32.  The kernels count the 'fast'
launches apart, in ``launches_bf16``.  A
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
import os

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.ops.rev_ell import REV_LONG_SLOTS


FOLD_MODES = ("x2", "fast", "highest")


def rev_fold_mode() -> str:
    """``VQ_GNN_REV_FOLD``: 'x2' (the default; also for an unknown value),
    'fast' or 'highest' (``vq_gnn_tpu/ops/pallas_rev.py:rev_fold_mode``)."""
    m = os.environ.get("VQ_GNN_REV_FOLD", "x2")
    return m if m in FOLD_MODES else "x2"


def _slot_parts_bf16(code, val):
    """The bf16 fold's slot parts: ``code`` [nb, S, K] codewords, ``val`` [S,
    K] f32.  Each cell's value rounded to bf16 and added, in k order with a
    bf16 rounding after every add, to the running sum of the earlier cells of
    its slot with its codeword.  Returns (running sums [nb, S, K] f32, the
    mask of each codeword's last cell in its slot), so that the running sum
    at a last cell is that codeword's part of the slot."""
    nb, S, K = code.shape
    v = val.to(torch.bfloat16).expand(nb, S, K)
    run = []
    for k in range(K):
        acc = v[:, :, k]
        same = code[:, :, :k] == code[:, :, k : k + 1]  # [nb, S, k]
        if k:
            # the latest earlier cell of the same codeword, if any
            idx = torch.where(same, torch.arange(k, device=code.device), -1).amax(-1)
            prev = torch.stack(run, -1).gather(-1, idx.clamp_min(0)[..., None])[..., 0]
            acc = torch.where(idx >= 0, prev + acc, acc)  # a bf16 add: rounds
        run.append(acc)
    later = torch.zeros_like(code, dtype=torch.bool)
    for k in range(K - 1):
        later[:, :, k] = (code[:, :, k + 1 :] == code[:, :, k : k + 1]).any(-1)
    return torch.stack(run, -1).float(), ~later


def rev_grid_plain(c_indices, slot_col, slot_val, slot_row, nb: int, B_pad: int, M: int,
                   fold: str = "x2"):
    """S [nb, M, B_pad]: per branch a ``scatter_add_`` of the cell values (or
    under ``fold='fast'`` of the bf16 slot parts) into a [M * B_pad] grid,
    before the relu."""
    if fold not in FOLD_MODES:
        raise ValueError(f"fold must be one of {FOLD_MODES}, got {fold!r}")
    S, K = slot_col.shape
    cols = slot_col.reshape(-1).long().clamp(0, c_indices.shape[0] - 1)
    code = c_indices.index_select(0, cols).long().t()  # [nb, S*K]
    rows = slot_row.long().repeat_interleave(K)  # pad slots: B_pad
    cell = torch.where(rows < B_pad, code * B_pad + rows, M * B_pad)  # pads -> dustbin
    grid = torch.zeros((nb, M * B_pad + 1), dtype=torch.float32, device=slot_val.device)
    if fold == "fast":
        parts, last = _slot_parts_bf16(code.reshape(nb, S, K), slot_val.float())
        cell = torch.where(last.reshape(nb, -1), cell, M * B_pad)
        grid.scatter_add_(1, cell, parts.reshape(nb, -1))
    else:
        grid.scatter_add_(1, cell, slot_val.reshape(1, -1).float().expand(nb, -1))
    return grid[:, : M * B_pad].reshape(nb, M, B_pad)


def rev_contract_plain(grid, xb, al, arcb, gbar):
    """info [nb] = sum over (b, m) of relu(grid) * the attention surface *
    <xb, gbar>, all elementwise (no TF32 product)."""
    Dg = xb.shape[2]
    att = torch.exp(F.leaky_relu(al[:, None, :] + arcb[:, :, None], 0.2))
    G = gbar[:, :, None, 0] * xb[:, None, :, 0]
    for d in range(1, Dg):
        G = G + gbar[:, :, None, d] * xb[:, None, :, d]
    return (F.relu(grid) * att * G).sum((1, 2))


def rev_recovery_info_plain(c_indices, slot_col, slot_val, slot_row, xb, al, arcb, gbar,
                            fold: str = "x2"):
    """The grid path of ``vq_gnn_tpu/nn/model.py:_bm_exact_reverse_info`` over
    the rev-ELL inputs: :func:`rev_grid_plain`, then
    :func:`rev_contract_plain`."""
    nb, B_pad, _ = xb.shape
    grid = rev_grid_plain(c_indices, slot_col, slot_val, slot_row, nb, B_pad, arcb.shape[1],
                          fold)
    return rev_contract_plain(grid, xb, al, arcb, gbar)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"rev_recovery_info: {msg}")


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_COMMON = [_VP, _I64, _VP, _VP, _I64, _I32, _I32, _VP, _VP, _I32, _VP, _VP, _VP, _VP, _I32, _I64,
           _I32, _I32, _VP, _I64]
_FWD_ARGTYPES = _COMMON + [_VP, _VP]
_BWD_ARGTYPES = _COMMON + [_VP, _VP, _VP, _VP, _VP]
_SCRATCH_ARGTYPES = [_I32, _I32, _I64, _I32, _I32, _I64, _I32, _I32,
                     ctypes.POINTER(ctypes.c_int64)]


def _checked(bwd, c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar, fold):
    """Validate the CUDA inputs; returns (nb, B_pad, Dg, M), the C entry
    points' leading arguments and the call's scratch (sized by the C side,
    ``vq_rev_scratch_bytes``)."""
    dev = xb.device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(fold in FOLD_MODES, f"fold must be one of {FOLD_MODES}, got {fold!r}")
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
        int(bwd), nb, B_pad, M, Dg, S, K, int(fold == "fast"), ctypes.byref(nbytes))
    _check(rc == 0, f"nb = {nb}, M = {M}, Dg = {Dg}, K = {K}, fold {fold!r}: outside what the "
           "kernels take (Dg at most 15, a table row; M at most 29,024, a block's shared "
           "memory; under the fast fold K dividing 32)")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    args = (c_indices.data_ptr(), c_indices.shape[0], slot_col.data_ptr(), slot_val.data_ptr(),
            S, K, int(fold == "fast"), row_ptr.data_ptr(), long_rows.data_ptr(),
            long_rows.shape[0] - 1, xb.data_ptr(), al.data_ptr(), arcb.data_ptr(),
            gbar.data_ptr(), nb, B_pad, M, Dg, scratch.data_ptr(), scratch.numel())
    return (nb, B_pad, Dg, M), args, scratch


def _count(fn, fold):
    if fold == "fast":
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def rev_forward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar,
                fold="x2"):
    """Kernel 9: info [nb] (CUDA tensors only).  The kernel reads each row's
    slots through ``row_ptr`` [B_pad + 1] and ``long_rows`` (the threshold,
    then the rows of more slots), the batch's ``rev_row_ptr`` and
    ``rev_long_rows``."""
    (nb, *_), args, scratch = _checked(False, c_indices, slot_col, slot_val, row_ptr, long_rows,
                                       xb, al, arcb, gbar, fold)  # scratch: alive over the launch
    info = torch.empty(nb, dtype=torch.float32, device=xb.device)
    rc = _build.function("rev_recovery", "vq_rev_forward", _FWD_ARGTYPES)(
        *args, info.data_ptr(), torch.cuda.current_stream(xb.device).cuda_stream)
    _build.check(rc, "rev_forward")
    _count(rev_forward, fold)
    return info


def rev_backward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar, g,
                 fold="x2"):
    """Kernel 10: (d_xb, d_al, d_arcb) for the per-branch cotangent g [nb]
    (CUDA tensors only; the rows as for rev_forward)."""
    (nb, B_pad, Dg, M), args, scratch = _checked(True, c_indices, slot_col, slot_val, row_ptr,
                                                 long_rows, xb, al, arcb, gbar, fold)
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
    _count(rev_backward, fold)
    return d_xb, d_al, d_arcb


rev_forward.launches = rev_forward.launches_bf16 = 0
rev_backward.launches = rev_backward.launches_bf16 = 0


class _RevInfo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr, long_rows,
                fold):
        ctx.save_for_backward(xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr,
                              long_rows)
        ctx.fold = fold
        return rev_forward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb, al, arcb, gbar,
                           fold)

    @staticmethod
    def backward(ctx, g):
        xb, al, arcb, c_indices, slot_col, slot_val, gbar, row_ptr, long_rows = \
            ctx.saved_tensors
        d_xb, d_al, d_arcb = rev_backward(c_indices, slot_col, slot_val, row_ptr, long_rows, xb,
                                          al, arcb, gbar, g.contiguous(), ctx.fold)
        return d_xb, d_al, d_arcb, None, None, None, None, None, None, None


def rev_recovery_info(c_indices, slot_col, slot_val, slot_row, xb, al, arcb, gbar,
                      row_ptr=None, long_rows=None, fold="x2"):
    """Kernels 9 and 10 for CUDA tensors (which need the batch's ``row_ptr``
    and ``long_rows``), the plain version for CPU tensors."""
    if xb.device.type == "cpu":
        return rev_recovery_info_plain(c_indices, slot_col, slot_val, slot_row, xb, al, arcb,
                                       gbar, fold)
    return _RevInfo.apply(xb.contiguous(), al.contiguous(), arcb.contiguous(), c_indices,
                          slot_col, slot_val, gbar.contiguous(), row_ptr, long_rows, fold)
