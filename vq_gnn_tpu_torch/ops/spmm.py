"""Sparse matrix-times-dense-matrix (SpMM) for graph aggregation (port of
``vq_gnn_tpu/ops/spmm.py``: the single-K slot-ELL layout, and the COO layout's
forward).

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

x may be bf16 (``compute_dtype='bfloat16'``): the output is f32 all the
same, the backward streams the cotangent at x's dtype and returns dx in it
(``vq_gnn_tpu/ops/spmm.py:_spmm_bwd``).

The COO layout (``make_edges``: row-sorted row, col, val) serves full-graph
inference, forward only (``_segment_matvec``): each edge's message
``val * x[col]``, then the sorted segment sum of kernel 8 over the rows
(``ops/segsum.py``) with the row offsets and long rows ``make_edges`` built
on the host, the same bits on every run; the plain version on CPU tensors.
Its backward (training on ``spmm_backend='coo'``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vq_gnn_tpu_torch.config import not_ported
from vq_gnn_tpu_torch.ops.ell_aggregate import LONG_SLOTS, ell_aggregate
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted


@dataclasses.dataclass
class Edges:
    """A padded slot-ELL edge list over a local node numbering, or a COO one
    (``make_edges``)."""

    # COO: int32 [E] rows, ascending; cols; f32 values; kernel 8's row
    # offsets [num_rows + 1] and long rows of the rows
    row: object = None
    col: object = None
    val: object = None
    row_ptr: object = None
    row_long_rows: object = None
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
    # [S_pad, K]: the flat transposed-ELL cell (t_sid * K + k) of each
    # forward cell; empty cells hold St_pad * K.  Only the B + M GAT conv's
    # backward reads it (to mirror per-cell values between the layouts).
    f_from_t: object = None
    # The ELL aggregate kernel's row offsets (row_offsets_host) and long rows
    # (long_rows_host) for the forward ELL over num_rows, and for the
    # transposed slots the backward dx walks: the t_b_slots prefix with rows
    # clamped to b_rows when the truncation is on, else all of them over
    # num_rows.  Built with the batch so the kernel need not build them on
    # every call; None makes it build the offsets on the device and take
    # every row in index order.
    ell_ptr: object = None
    ell_long_rows: object = None
    t_ell_ptr: object = None
    t_ell_long_rows: object = None
    # The same two for the whole transposed ELL over num_rows, whatever the
    # truncation: the GAT backward walks every row (its d_al needs them
    # all).  Built with GAT batches; None makes the kernel build the offsets.
    t_all_ptr: object = None
    t_all_long_rows: object = None

    def to(self, device) -> "Edges":
        def t(a, dtype):
            if a is None:
                return None
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return dataclasses.replace(
            self,
            row=t(self.row, torch.int32),
            col=t(self.col, torch.int32),
            val=t(self.val, torch.float32),
            row_ptr=t(self.row_ptr, torch.int32),
            row_long_rows=t(self.row_long_rows, torch.int32),
            ell_row=t(self.ell_row, torch.int32),
            ell_col=t(self.ell_col, torch.int32),
            ell_val=t(self.ell_val, torch.float32),
            t_ell_row=t(self.t_ell_row, torch.int32),
            t_ell_col=t(self.t_ell_col, torch.int32),
            t_ell_val=t(self.t_ell_val, torch.float32),
            f_from_t=t(self.f_from_t, torch.int64),
            ell_ptr=t(self.ell_ptr, torch.int32),
            ell_long_rows=t(self.ell_long_rows, torch.int32),
            t_ell_ptr=t(self.t_ell_ptr, torch.int32),
            t_ell_long_rows=t(self.t_ell_long_rows, torch.int32),
            t_all_ptr=t(self.t_all_ptr, torch.int32),
            t_all_long_rows=t(self.t_all_long_rows, torch.int32),
        )


def _ell_matvec(ell_row, ell_col, ell_val, x, num_rows, ptr=None, long_rows=None):
    """Slot-ELL aggregate ``out[r] = sum_{slots s of r} sum_k val[s,k] *
    x[col[s,k]]`` -> f32 [num_rows, C].  ``ptr``, ``long_rows``: the batch's
    row offsets and long rows; ones built for another row count (an Edges
    whose truncation was switched off after the build) are not used."""
    if ptr is None or ptr.shape[0] != num_rows + 1:
        ptr = long_rows = None
    return ell_aggregate(x, ell_row, ell_col, ell_val, num_rows, ptr=ptr, long_rows=long_rows)


def _ell_sddmm(ell_row, ell_col, g, x):
    """d val[s,k] = g[row_s] . x[col_sk] (padding rows/cols clamp, as JAX's
    ``mode='clip'``), summed in f32 from bf16 g and x too."""
    S, K = ell_col.shape
    g_rows = g.index_select(0, ell_row.long().clamp(max=g.shape[0] - 1)).float()
    x_cols = x.index_select(
        0, ell_col.reshape(-1).long().clamp(max=x.shape[0] - 1)
    ).float().reshape(S, K, x.shape[1])
    return (g_rows[:, None, :] * x_cols).sum(-1)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ell_val, edges: Edges):
        ctx.edges = edges
        ctx.x_rows = x.shape[0]
        ctx.x_dtype = x.dtype
        # x is only needed for d val; the GCN/SAGE path never asks for it
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)
        return _ell_matvec(edges.ell_row, edges.ell_col, ell_val, x, edges.num_rows,
                           edges.ell_ptr, edges.ell_long_rows)

    @staticmethod
    def backward(ctx, g):
        e: Edges = ctx.edges
        (x,) = ctx.saved_tensors
        # stream the cotangent at the forward's dtype (bf16 halves the
        # gathered bytes); the sums stay f32, dx comes back in x's dtype
        g = g.to(ctx.x_dtype).contiguous()
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
                    t_row, e.t_ell_col[:tb], e.t_ell_val[:tb], g, e.b_rows, e.t_ell_ptr,
                    e.t_ell_long_rows,
                )
                dx = torch.cat(
                    [dx_b, dx_b.new_zeros((num_cols - e.b_rows, dx_b.shape[1]))]
                )
            else:
                dx = _ell_matvec(e.t_ell_row, e.t_ell_col, e.t_ell_val, g, num_cols,
                                 e.t_ell_ptr, e.t_ell_long_rows)
            dx = dx.to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dval = _ell_sddmm(e.ell_row, e.ell_col, g, x)
        return dx, dval, None


def _segment_matvec(edges: Edges, x):
    """The COO forward (``vq_gnn_tpu/ops/spmm.py:_segment_matvec``): the
    messages ``val * x[col]`` (in f32 for bf16 x), summed per row by kernel 8
    on CUDA tensors."""
    msgs = x.index_select(0, edges.col.long()).float() * edges.val[:, None]
    return segment_sum_sorted(msgs, edges.row, edges.num_rows, ptr=edges.row_ptr,
                              long_rows=edges.row_long_rows)


def spmm(edges: Edges, x: torch.Tensor, ell_val: Optional[torch.Tensor] = None):
    """out[r] = sum_e 1[row_e == r] * val_e * x[col_e] -> [num_rows, D].

    ``ell_val`` overrides ``edges.ell_val`` (e.g. attention-weighted values
    that need a gradient).  COO edges (no ``ell_row``) run the forward only."""
    if edges.ell_row is None:
        if edges.row is None:
            raise ValueError("spmm: the edges hold neither the slot-ELL nor the COO layout")
        if torch.is_grad_enabled() and x.requires_grad:
            raise not_ported("the COO layout's backward (spmm_backend='coo')", "queue 1 item 5")
        return _segment_matvec(edges, x)
    if edges.t_ell_row is None:
        raise ValueError("ELL edges need t_ell_* for the backward pass")
    val = edges.ell_val if ell_val is None else ell_val
    return _SpMM.apply(x, val, edges)


def make_edges(row, col, val, num_rows) -> Edges:
    """Host-side COO edges (``vq_gnn_tpu/ops/spmm.py:make_edges``), sorted by
    row (stable), with kernel 8's row offsets and long rows.  The JAX
    package's col-sorting permutation serves the COO backward only, which is
    not ported.  numpy arrays: ``Edges.to`` moves them."""
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    order = np.argsort(row, kind="stable")
    row, col, val = row[order], col[order], val[order]
    ptr = row_offsets_host(row, int(num_rows))
    return Edges(row=row, col=col, val=val, row_ptr=ptr, row_long_rows=long_rows_host(ptr),
                 num_rows=int(num_rows))


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


def row_offsets_host(ell_row, num_rows: int) -> np.ndarray:
    """[num_rows + 1] int32 row offsets of an ascending slot-row array: entry
    r is the number of slots whose row, clamped to num_rows, is < r, so the
    slots of row r are [ptr[r], ptr[r + 1]) and slots of rows >= num_rows
    (padding, the dustbin) belong to none."""
    rows = np.minimum(np.asarray(ell_row, np.int64), num_rows)
    counts = np.bincount(rows, minlength=num_rows + 1)[:num_rows]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def long_rows_host(ptr, min_slots: int = LONG_SLOTS) -> np.ndarray:
    """int32 [1 + n]: ``min_slots``, then the n rows of more than
    ``min_slots`` slots, most slots first (ties in index order).  The ELL
    aggregate kernel starts those rows first, a warp each, so that a long row
    does not finish last, and leaves them out of its index order by the
    threshold the list carries."""
    if min_slots < 0:
        raise ValueError(f"long_rows_host: min_slots must be >= 0, got {min_slots}")
    slots = np.diff(np.asarray(ptr, np.int64))
    rows = np.flatnonzero(slots > min_slots)
    rows = rows[np.argsort(-slots[rows], kind="stable")]
    return np.concatenate([[min_slots], rows]).astype(np.int32)


def ell_positions(row_sorted, K: int, num_rows: int):
    """Flat slot-ELL cell position (sid * K + k) of each edge, given the
    row-sorted row array the ELL was built from (mirrors build_ell_host's
    dense-rows slot layout)."""
    row = np.asarray(row_sorted, np.int64)
    deg = np.bincount(row, minlength=num_rows)
    starts = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(len(row)) - starts[row]
    nslot = np.maximum((deg + K - 1) // K, 1)
    slot_base = np.concatenate([[0], np.cumsum(nslot)])
    sid = slot_base[row] + pos // K
    return (sid * K + pos % K).astype(np.int64)
