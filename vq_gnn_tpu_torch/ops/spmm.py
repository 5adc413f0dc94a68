"""Sparse matrix-times-dense-matrix (SpMM) for graph aggregation (port of
``vq_gnn_tpu/ops/spmm.py``, single-K slot-ELL layout).

The hot op of every conv forward and backward (the reference bottoms out in
``torch_sparse::spmm``, ``convs.py v2:95``).  Layout, as in the JAX package:
each row's edges are split into slots of K contiguous edges; a slot is
(output row, K cols, K vals), slots sorted by row and every row owning at
least one slot.  ``t_ell_*`` is the same layout for the transposed graph, so
the backward dx is another ELL aggregate instead of a scatter.

- ``_ell_matvec`` runs the ELL aggregate: the CUDA kernel for CUDA tensors,
  its plain version for CPU tensors (``ops/ell_aggregate.py``);
- ``spmm`` is a ``torch.autograd.Function`` whose backward is the transposed
  aggregate with the ``b_rows``/``t_b_slots`` truncation, and d``val`` (an
  SDDMM) only when the caller differentiates the edge values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate


@dataclasses.dataclass
class Edges:
    """A padded slot-ELL edge list over a local node numbering."""

    ell_row: object = None  # [S_pad] int32 ascending; pad = num_rows
    ell_col: object = None  # [S_pad, K] int32; pad = num_rows
    ell_val: object = None  # [S_pad, K] f32; pad = 0
    t_ell_row: object = None  # the transposed graph, same layout
    t_ell_col: object = None
    t_ell_val: object = None
    num_rows: int = 0
    # every row in [0, num_rows) owns >= 1 slot (empty rows get a zero slot)
    dense_rows: bool = False
    # Backward truncation contract (set by the B + B' batch builder): x rows
    # >= b_rows are codebook lookups whose cotangent has no consumer, so the
    # VJP only computes dx for rows < b_rows and returns zeros above.
    # t_b_slots bounds the prefix of the row-ascending transposed ELL whose
    # rows are < b_rows.  0/0 = exact full VJP.
    b_rows: int = 0
    t_b_slots: int = 0

    def to(self, device) -> "Edges":
        def t(a, dtype):
            if a is None:
                return None
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return dataclasses.replace(
            self,
            ell_row=t(self.ell_row, torch.int32),
            ell_col=t(self.ell_col, torch.int32),
            ell_val=t(self.ell_val, torch.float32),
            t_ell_row=t(self.t_ell_row, torch.int32),
            t_ell_col=t(self.t_ell_col, torch.int32),
            t_ell_val=t(self.t_ell_val, torch.float32),
        )


def _ell_matvec(ell_row, ell_col, ell_val, x, num_rows):
    """Slot-ELL aggregate ``out[r] = sum_{slots s of r} sum_k val[s,k] *
    x[col[s,k]]`` -> f32 [num_rows, C]."""
    return ell_aggregate(x, ell_row, ell_col, ell_val, num_rows)


def _ell_sddmm(ell_row, ell_col, g, x):
    """d val[s,k] = g[row_s] . x[col_sk] (padding rows/cols clamp, as JAX's
    ``mode='clip'``)."""
    S, K = ell_col.shape
    g_rows = g.index_select(0, ell_row.long().clamp(max=g.shape[0] - 1))
    x_cols = x.index_select(
        0, ell_col.reshape(-1).long().clamp(max=x.shape[0] - 1)
    ).reshape(S, K, x.shape[1])
    return (g_rows[:, None, :] * x_cols).sum(-1)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ell_val, edges: Edges):
        ctx.edges = edges
        ctx.x_rows = x.shape[0]
        # x is only needed for d val; the GCN/SAGE path never asks for it
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)
        return _ell_matvec(edges.ell_row, edges.ell_col, ell_val, x, edges.num_rows)

    @staticmethod
    def backward(ctx, g):
        e: Edges = ctx.edges
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        num_cols = ctx.x_rows
        dx = dval = None
        if ctx.needs_input_grad[0]:
            tb = e.t_b_slots
            if e.b_rows and tb and tb < e.t_ell_row.shape[0]:
                # rows are ascending, so the < b_rows slots are a prefix; the
                # few ride-over slots inside the bound clamp to the b_rows
                # dustbin, which the aggregate drops
                t_row = torch.clamp(e.t_ell_row[:tb], max=e.b_rows)
                dx_b = _ell_matvec(
                    t_row, e.t_ell_col[:tb], e.t_ell_val[:tb], g, e.b_rows
                )
                dx = torch.cat(
                    [dx_b, dx_b.new_zeros((num_cols - e.b_rows, dx_b.shape[1]))]
                )
            else:
                dx = _ell_matvec(e.t_ell_row, e.t_ell_col, e.t_ell_val, g, num_cols)
        if ctx.needs_input_grad[1]:
            dval = _ell_sddmm(e.ell_row, e.ell_col, g, x)
        return dx, dval, None


def spmm(edges: Edges, x: torch.Tensor, ell_val: Optional[torch.Tensor] = None):
    """out[r] = sum_e 1[row_e == r] * val_e * x[col_e] -> [num_rows, D].

    ``ell_val`` overrides ``edges.ell_val`` (e.g. attention-weighted values
    that need a gradient)."""
    if edges.ell_row is None:
        raise NotImplementedError(
            "only the slot-ELL layout is ported to vq_gnn_tpu_torch; see ROADMAP.md"
        )
    if edges.t_ell_row is None:
        raise ValueError("ELL edges need t_ell_* for the backward pass")
    val = edges.ell_val if ell_val is None else ell_val
    return _SpMM.apply(x, val, edges)


def build_ell_host(row, col, val, num_rows: int, K: int, S_pad: int = 0):
    """Host-side slot-ELL construction from row-sorted COO (numpy).

    Returns (ell_row [S_pad], ell_col [S_pad, K], ell_val [S_pad, K]).
    Padding slots carry row = num_rows (dustbin), col = num_rows (clamped),
    val = 0.  Rows are **dense**: a row with no edges still gets one
    zero-valued slot, so sorted slot rows are gap-free over [0, num_rows).
    """
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    if S_pad > 0:
        from vq_gnn_tpu_torch.native import lib as native_lib

        if native_lib.available():
            return native_lib.build_ell(row, col, val, num_rows, K, S_pad)
    deg = np.bincount(row, minlength=num_rows)
    starts = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(len(row)) - starts[row]
    nslot = np.maximum((deg + K - 1) // K, 1)  # empty rows: one dustbin slot
    slot_base = np.concatenate([[0], np.cumsum(nslot)])
    S = int(slot_base[-1])
    if S_pad <= 0:
        S_pad = S
    if S > S_pad:
        raise ValueError(f"slots {S} exceed S_pad={S_pad}")
    sid = slot_base[row] + pos // K
    k = pos % K
    ell_row = np.full(S_pad, num_rows, np.int32)
    ell_row[:S] = np.repeat(np.arange(num_rows), nslot).astype(np.int32)
    ell_col = np.full((S_pad, K), num_rows, np.int32)
    ell_val = np.zeros((S_pad, K), np.float32)
    ell_col[sid, k] = col
    ell_val[sid, k] = val
    return ell_row, ell_col, ell_val
