"""Sparse matrix-times-dense-matrix (SpMM) for graph aggregation (port of
``vq_gnn_tpu/ops/spmm.py``: the single-K and the mixed-K slot-ELL layouts,
and the COO layout).

The hot op of every conv forward and backward (the reference bottoms out in
``torch_sparse::spmm``, ``convs.py v2:95``).  Layouts, as in the JAX package:

- **single-K slot-ELL**: each row's edges are split into slots of K
  contiguous edges; a slot is (output row, K cols, K vals), slots sorted by
  row and every row owning at least one slot.  ``t_ell_*`` is the same
  layout for the transposed graph, so the backward dx is another ELL
  aggregate instead of a scatter;
- **mixed-K slot-ELL** (``ell_Kt > 0``, :func:`build_mixed_ell_host`): each
  row's first ``floor(deg / K) * K`` edges fill K-wide *head* slots, which
  carry a compact row id (the rank among the rows with a head slot) and fold
  back to global rows through ``head_inv``; the rest fill Kt-wide *tail*
  slots over the global rows, every row owning at least one.  Both families
  again for the transposed graph;
- **COO** (``spmm_backend='coo'``, :func:`make_edges` and the batch
  builder): row-sorted ``row``, ``col``, ``val`` padded with ``row = col =
  num_rows``, ``val = 0``, and ``tperm``, the stable permutation that sorts
  the edges by column, for the backward.

Kernels: every ELL aggregate is kernel 1 on CUDA tensors (``_ell_matvec``,
``ops/ell_aggregate.py``), the mixed layout once per family; every COO sum
is kernel 8 (``ops/segsum.py``) over the messages ``val * x[col]``, forward
and transposed.  Each takes the row offsets and long rows the batch builder
made with the batch.  CPU tensors take the plain versions.

``spmm`` is a ``torch.autograd.Function`` whose backward is the transposed
aggregate: under single-K and mixed-K with the ``b_rows`` truncation, and
d``val`` (an SDDMM) only when the caller differentiates the edge values;
the mixed layout has no d``val`` (GCN and SAGE adjacency values are
constants), COO has one (the GAT fallback's attention values).

x may be bf16 or f16 (``compute_dtype='bfloat16'`` or ``'float16'``): the
output is f32 all the same, the backward streams the cotangent at x's dtype
and returns dx in it
(``vq_gnn_tpu/ops/spmm.py:_spmm_bwd``).

A row shard (``parallel/mesh.py:ShardEdges``, a batch sharded over ranks)
takes :func:`rows_aggregate` over its owned rows and :func:`shard_dx` over
its batch columns, in each layout, reading every rank's rows in the
gathered order; a family or edge list a shard leaves empty launches
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vq_gnn_tpu_torch.config import sum_dtype
from vq_gnn_tpu_torch.ops.ell_aggregate import LONG_SLOTS, ell_aggregate, ell_aggregate_plain
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted


@dataclasses.dataclass
class Edges:
    """A padded edge list over a local node numbering: single-K slot-ELL
    (``ell_*``), mixed-K slot-ELL (``head_*``/``tail_*``) or COO (``row``,
    ``col``, ``val``).  Each ``*_ptr`` / ``*_long_rows`` pair is the row
    offsets (:func:`row_offsets_host`) and long rows (:func:`long_rows_host`)
    of the slot rows beside it, which kernels 1 and 8 read instead of
    searching the rows; None makes the kernel build the offsets on the device
    and take every row in index order."""

    # COO: int32 [E_pad] rows, ascending (pad = num_rows); cols (pad =
    # num_rows); f32 values (pad = 0); the stable col-sorting permutation;
    # the lists of the rows and of the transposed rows col[tperm]
    row: object = None
    col: object = None
    val: object = None
    tperm: object = None
    row_ptr: object = None
    row_long_rows: object = None
    t_row_ptr: object = None
    t_row_long_rows: object = None
    ell_row: object = None  # [S_pad] int32 ascending; pad = num_rows
    ell_col: object = None  # [S_pad, K] int32; pad = num_rows
    ell_val: object = None  # [S_pad, K] f32; pad = 0
    t_ell_row: object = None  # the transposed graph, same layout
    t_ell_col: object = None
    t_ell_val: object = None
    # mixed-K: the HEAD family's full K-wide slots in compact rows (pad =
    # the count of head rows), their global rows (pad = num_rows) and
    # head_inv [num_rows]: global row -> compact row, num_rows for a row
    # without head slots (a gather from a table with one appended zero row);
    # the TAIL family's Kt-wide slots over the global rows, dense.  The t_*
    # families are the transposed graph's.
    head_rowc: object = None  # [Sh_pad] int32
    head_col: object = None  # [Sh_pad, K] int32
    head_val: object = None  # [Sh_pad, K] f32
    head_inv: object = None  # [num_rows] int32
    head_rowg: object = None  # [Sh_pad] int32
    tail_row: object = None  # [St2_pad] int32
    tail_col: object = None  # [St2_pad, Kt] int32
    tail_val: object = None  # [St2_pad, Kt] f32
    t_head_rowc: object = None
    t_head_col: object = None
    t_head_val: object = None
    t_head_inv: object = None
    t_head_rowg: object = None
    t_tail_row: object = None
    t_tail_col: object = None
    t_tail_val: object = None
    num_rows: int = 0
    # every row in [0, num_rows) owns >= 1 slot (empty rows get a zero slot)
    dense_rows: bool = False
    # Backward truncation contract (set by the B + B' batch builder): x rows
    # >= b_rows are codebook lookups whose cotangent has no consumer, so the
    # VJP only computes dx for rows < b_rows and returns zeros above.
    # t_b_slots bounds the prefix of the row-ascending transposed ELL whose
    # rows are < b_rows; t_head_b_slots / t_tail_b_slots the same for the
    # mixed families.  0/0 = exact full VJP.
    b_rows: int = 0
    t_b_slots: int = 0
    t_head_b_slots: int = 0
    t_tail_b_slots: int = 0
    # [S_pad, K]: the flat transposed-ELL cell (t_sid * K + k) of each
    # forward cell; empty cells hold St_pad * K.  Only the B + M GAT conv's
    # backward reads it (to mirror per-cell values between the layouts).
    f_from_t: object = None
    # Single-K: the lists of the forward ELL over num_rows, and of the
    # transposed slots the backward dx walks: the t_b_slots prefix with rows
    # clamped to b_rows when the truncation is on, else all of them.
    ell_ptr: object = None
    ell_long_rows: object = None
    t_ell_ptr: object = None
    t_ell_long_rows: object = None
    # The same two for the whole transposed ELL over num_rows, whatever the
    # truncation: the GAT backward walks every row (its d_al needs them
    # all).  Built with GAT batches.
    t_all_ptr: object = None
    t_all_long_rows: object = None
    # Mixed-K: the lists of each family, forward (head over the compact
    # rows, its padding slots in no row) and transposed as the backward dx
    # walks it (the truncated prefixes, the tail's rows clamped to b_rows
    # and counted over b_rows, when the truncation is on)
    head_ptr: object = None
    head_long_rows: object = None
    tail_ptr: object = None
    tail_long_rows: object = None
    t_head_ptr: object = None
    t_head_long_rows: object = None
    t_tail_ptr: object = None
    t_tail_long_rows: object = None
    # ... and of the whole transposed families (the GAT backward's)
    t_head_all_ptr: object = None
    t_head_all_long_rows: object = None
    t_tail_all_ptr: object = None
    t_tail_all_long_rows: object = None
    # where the rows start in the table the GAT conv reads (a row shard's
    # is every rank's rows, parallel/mesh.py:ShardEdges)
    row0 = 0

    def to(self, device) -> "Edges":
        """Every array on ``device``: indices int32 (the kernels' type; the
        ``f_from_t`` map int64, for ``index_select``), values f32."""
        moved = {}
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            if a is None or isinstance(a, (int, bool)):
                continue
            t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a)
            dtype = (torch.int64 if f.name == "f_from_t" else
                     torch.float32 if t.is_floating_point() else torch.int32)
            moved[f.name] = t.to(device=device, dtype=dtype)
        return dataclasses.replace(self, **moved)

    @property
    def mixed(self) -> bool:
        return self.tail_row is not None


def _ell_matvec(ell_row, ell_col, ell_val, x, num_rows, ptr=None, long_rows=None):
    """Slot-ELL aggregate ``out[r] = sum_{slots s of r} sum_k val[s,k] *
    x[col[s,k]]`` -> f32 [num_rows, C].  ``ptr``, ``long_rows``: the batch's
    row offsets and long rows; ones built for another row count (an Edges
    whose truncation was switched off after the build) are not used."""
    if ell_row.shape[0] == 0:  # a family a row shard leaves empty: nothing to launch
        return x.new_zeros((num_rows, x.shape[1]), dtype=sum_dtype(x.dtype))
    if x.dtype == torch.float64 and x.device.type == "cpu":
        # the float64 diagnostic (config.sum_dtype): kernel 1's wrapper takes
        # its kernel's row dtypes alone, so float64 rows reach its plain version
        return ell_aggregate_plain(x, ell_row, ell_col, ell_val, num_rows)
    if ptr is None or ptr.shape[0] != num_rows + 1:
        ptr = long_rows = None
    return ell_aggregate(x, ell_row, ell_col, ell_val, num_rows, ptr=ptr, long_rows=long_rows)


def _ell_sddmm(ell_row, ell_col, g, x):
    """d val[s,k] = g[row_s] . x[col_sk] (padding rows/cols clamp, as JAX's
    ``mode='clip'``), summed in f32 from 16-bit g and x too."""
    S, K = ell_col.shape
    wd = sum_dtype(x.dtype)
    g_rows = g.index_select(0, ell_row.long().clamp(max=g.shape[0] - 1)).to(wd)
    x_cols = x.index_select(
        0, ell_col.reshape(-1).long().clamp(max=x.shape[0] - 1)
    ).to(wd).reshape(S, K, x.shape[1])
    return (g_rows[:, None, :] * x_cols).sum(-1)


def fold_rows(compact_out, inv):
    """A compact head reduction gathered back to global rows: row r takes
    ``compact_out[inv[r]]``, and the sentinel ``inv[r] == len(compact_out)``
    takes 0 (a gather from the table with one appended zero row, JAX's
    ``mode='fill'``; nothing is clamped)."""
    pad = compact_out.new_zeros((1,) + tuple(compact_out.shape[1:]))
    return torch.cat([compact_out, pad]).index_select(0, inv.long())


def _mixed_matvec(head, tail, inv, x, num_rows, out_rows=None):
    """Mixed-K aggregate (``vq_gnn_tpu/ops/spmm.py:_mixed_matvec``): the
    tail family reduced in the global rows, plus the head family reduced in
    its compact rows and folded through ``inv``.  ``head`` and ``tail`` are
    (rows, cols, vals, ptr, long_rows).  ``out_rows`` < num_rows truncates
    the output (the backward's b_rows path); the head stays num_rows wide,
    since the compact rows of rows >= out_rows are never gathered."""
    R = num_rows if out_rows is None else out_rows
    out = _ell_matvec(*tail[:3], x, R, *tail[3:])
    h = _ell_matvec(*head[:3], x, num_rows, *head[3:])
    return out + fold_rows(h, inv if out_rows is None else inv[:out_rows])


def mixed_families(e: Edges, transposed: bool = False, whole: bool = False):
    """((head), (tail), head_inv) of the forward mixed layout, or of the
    transposed one as the backward dx walks it (``whole``: all of it, with
    the lists of the whole families).  Each family is (rows for the sum,
    global rows, cols, vals, ptr, long_rows); the tail's two row arrays are
    one."""
    if not transposed:
        return ((e.head_rowc, e.head_rowg, e.head_col, e.head_val, e.head_ptr,
                 e.head_long_rows),
                (e.tail_row, e.tail_row, e.tail_col, e.tail_val, e.tail_ptr, e.tail_long_rows),
                e.head_inv)
    lists = ((e.t_head_all_ptr, e.t_head_all_long_rows, e.t_tail_all_ptr,
              e.t_tail_all_long_rows) if whole else
             (e.t_head_ptr, e.t_head_long_rows, e.t_tail_ptr, e.t_tail_long_rows))
    return ((e.t_head_rowc, e.t_head_rowg, e.t_head_col, e.t_head_val) + lists[:2],
            (e.t_tail_row, e.t_tail_row, e.t_tail_col, e.t_tail_val) + lists[2:],
            e.t_head_inv)


def mixed_truncated(e: Edges) -> bool:
    """The mixed backward's truncation condition
    (``vq_gnn_tpu/ops/spmm.py:257``)."""
    tbt = e.t_tail_b_slots
    return bool(e.b_rows and tbt and tbt < e.t_tail_row.shape[0])


def _mixed_dx(e: Edges, g, num_cols):
    """dx of the mixed layout: the transposed families, truncated to the
    rows < b_rows (the tail's ride-over slots clamp to the b_rows dustbin)
    where the batch sets the bound, zeros above."""
    head, tail, inv = mixed_families(e, transposed=True)
    h = (head[0], head[2], head[3]) + head[4:]
    if not mixed_truncated(e):
        return _mixed_matvec(h, (tail[0], tail[2], tail[3]) + tail[4:], inv, g, num_cols)
    tbh, tbt, b = e.t_head_b_slots, e.t_tail_b_slots, e.b_rows
    dx_b = _mixed_matvec(
        (h[0][:tbh], h[1][:tbh], h[2][:tbh]) + h[3:],
        (torch.clamp(tail[0][:tbt], max=b), tail[2][:tbt], tail[3][:tbt]) + tail[4:],
        inv, g, num_cols, out_rows=b,
    )
    return torch.cat([dx_b, dx_b.new_zeros((num_cols - b, dx_b.shape[1]))])


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ell_val, edges: Edges):
        ctx.edges = edges
        ctx.x_rows = x.shape[0]
        ctx.x_dtype = x.dtype
        # x is only needed for d val; the GCN/SAGE path never asks for it
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)
        if edges.mixed:
            return rows_aggregate(edges, x)
        return _ell_matvec(edges.ell_row, edges.ell_col, ell_val, x, edges.num_rows,
                           edges.ell_ptr, edges.ell_long_rows)

    @staticmethod
    def backward(ctx, g):
        e: Edges = ctx.edges
        (x,) = ctx.saved_tensors
        # stream the cotangent at the forward's dtype (16 bits halve the
        # gathered bytes); the sums stay f32, dx comes back in x's dtype
        g = g.to(ctx.x_dtype).contiguous()
        num_cols = ctx.x_rows
        dx = dval = None
        if ctx.needs_input_grad[0]:
            tb = e.t_b_slots
            if e.mixed:
                dx = _mixed_dx(e, g, num_cols)
            elif e.b_rows and tb and tb < e.t_ell_row.shape[0]:
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


def _segment_matvec(row, col, vals, x_br, num_rows, ptr=None, long_rows=None):
    """The COO aggregate (``vq_gnn_tpu/ops/spmm.py:_segment_matvec``) of each
    branch n's values over x_br[n] -> f32 [nb, num_rows, Dc]: the messages
    ``vals[n] * x_br[n][col]`` (in f32 for 16-bit x; columns clip to the rows
    of x) of every branch side by side, [E, nb * Dc], summed per row in one
    call of kernel 8 on CUDA tensors, the plain sum on CPU tensors (each
    channel in the same order as a sum of that branch alone).  Rows >=
    num_rows (padding) are dropped; lists built for another row count are
    not used."""
    nb, R, Dc = x_br.shape
    if row.shape[0] == 0:  # a row shard without edges: nothing to launch
        return x_br.new_zeros((nb, num_rows, Dc), dtype=sum_dtype(x_br.dtype))
    if ptr is not None and ptr.shape[0] != num_rows + 1:
        ptr = long_rows = None
    cols = col.long().clamp(max=R - 1)
    msgs = (x_br.index_select(1, cols).to(sum_dtype(x_br.dtype)) * vals[:, :, None]
            ).permute(1, 0, 2)
    out = segment_sum_sorted(msgs.reshape(len(cols), nb * Dc).contiguous(), row, num_rows,
                             ptr=ptr, long_rows=long_rows)
    return out.reshape(num_rows, nb, Dc).permute(1, 0, 2)


class _SpMMCOO(torch.autograd.Function):
    """COO SpMM over branches: x_br [nb, R, Dc], vals [nb, E_pad]."""

    @staticmethod
    def forward(ctx, x_br, vals, edges: Edges):
        ctx.edges = edges
        ctx.x_dtype = x_br.dtype
        ctx.x_rows = x_br.shape[1]
        ctx.save_for_backward(x_br if ctx.needs_input_grad[1] else None, vals)
        return _segment_matvec(edges.row, edges.col, vals, x_br, edges.num_rows, edges.row_ptr,
                               edges.row_long_rows)

    @staticmethod
    def backward(ctx, g):
        e: Edges = ctx.edges
        x_br, vals = ctx.saved_tensors
        dx = dval = None
        if ctx.needs_input_grad[0]:
            # the transposed sum over the tperm-sorted edges: row = col[tperm];
            # the cotangent streams at x's dtype, dx comes back in it
            perm = e.tperm.long()
            dx = _segment_matvec(e.col.index_select(0, perm), e.row.index_select(0, perm),
                                 vals.index_select(1, perm), g.to(ctx.x_dtype).contiguous(),
                                 ctx.x_rows, e.t_row_ptr, e.t_row_long_rows).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dval = _coo_sddmm(e.row, e.col, g, x_br)
        return dx, dval, None


def _coo_sddmm(row, col, g, x_br):
    """Per branch the SDDMM d val[n, e] = g[n, row_e] . x[n, col_e] (pads
    clip; summed in f32 from x in its dtype, g unrounded)."""
    gr = g.index_select(1, row.long().clamp(max=g.shape[1] - 1))
    xc = x_br.index_select(1, col.long().clamp(max=x_br.shape[1] - 1)).to(sum_dtype(x_br.dtype))
    return (gr * xc).sum(-1)


def rows_aggregate(e: Edges, x, vals=None):
    """The aggregate of the ``e.num_rows`` rows of ``e`` -> f32 [num_rows, C]
    from the table x its columns index: kernel 1 over the single-K slots or
    once per mixed family (the head folded through ``head_inv``), kernel 8
    over the COO edges with the values ``vals`` (``e.val`` by default).  A
    row shard's edges (``parallel/mesh.py:ShardEdges``) are its owned rows'
    and x every rank's rows in the gathered order."""
    if e.mixed:
        head, tail, inv = mixed_families(e)
        return _mixed_matvec((head[0],) + head[2:], (tail[0],) + tail[2:], inv, x, e.num_rows)
    if e.ell_row is None:
        v = e.val if vals is None else vals
        return _segment_matvec(e.row, e.col, v[None], x[None], e.num_rows, e.row_ptr,
                               e.row_long_rows)[0]
    return _ell_matvec(e.ell_row, e.ell_col, e.ell_val, x, e.num_rows, e.ell_ptr,
                       e.ell_long_rows)


def shard_dx(e, g, t_vals=None):
    """The transposed aggregate of a row shard's ``b_rows`` batch columns ->
    f32 [b_rows, C] from g, every rank's cotangents in the gathered order:
    kernel 1 over its transposed slots or once per transposed mixed family,
    kernel 8 over its transposed COO edges (``ShardEdges.t_row``, sorted by
    column) with the values ``t_vals`` (``e.t_val`` by default).  The
    shard holds the slots of those columns only, so nothing is cut here."""
    if e.mixed:
        head, tail, inv = mixed_families(e, transposed=True)
        return _mixed_matvec((head[0],) + head[2:], (tail[0],) + tail[2:], inv, g, e.b_rows)
    if e.ell_row is None:
        v = e.t_val if t_vals is None else t_vals
        return _segment_matvec(e.t_row, e.t_col, v[None], g[None], e.b_rows, e.t_row_ptr,
                               e.t_row_long_rows)[0]
    return _ell_matvec(e.t_ell_row, e.t_ell_col, e.t_ell_val, g, e.b_rows, e.t_ell_ptr,
                       e.t_ell_long_rows)


def spmm(edges: Edges, x: torch.Tensor, ell_val: Optional[torch.Tensor] = None):
    """out[r] = sum_e 1[row_e == r] * val_e * x[col_e] -> [num_rows, D].

    ``ell_val`` overrides ``edges.ell_val`` (single-K; e.g. values that need
    a gradient).  COO edges differentiate ``edges.val`` when it requires a
    gradient (the GAT fallback puts its attention values there); the mixed
    layout never differentiates its values.  A row shard's edges
    (``parallel/mesh.py:ShardEdges``, bound to its group by the sharded
    step) carry their own aggregate, which exchanges rows between ranks."""
    if getattr(edges, "aggregate", None) is not None:
        return edges.aggregate(x)
    if edges.mixed:
        return _SpMM.apply(x, None, edges)
    if edges.ell_row is None:
        if edges.row is None:
            raise ValueError("spmm: the edges hold none of the slot-ELL and COO layouts")
        if edges.tperm is None and torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("COO edges need tperm for the backward pass")
        return _SpMMCOO.apply(x[None], edges.val[None], edges)[0]
    if edges.t_ell_row is None:
        raise ValueError("ELL edges need t_ell_* for the backward pass")
    val = edges.ell_val if ell_val is None else ell_val
    return _SpMM.apply(x, val, edges)


def spmm_branches(edges: Edges, vals: torch.Tensor, x_br: torch.Tensor) -> torch.Tensor:
    """Per-branch COO SpMM: ``out[n] = spmm(edges with val = vals[n],
    x_br[n])`` -> [nb, num_rows, Dc], the JAX package's ``vmap`` of ``spmm``
    over branches in the B + M GAT COO fallback
    (``vq_gnn_tpu/nn/model.py:754-757``).  Differentiable in x_br and vals;
    forward and dx are one kernel-8 sum each over all branches."""
    if edges.row is None or edges.tperm is None:
        raise ValueError("spmm_branches needs COO edges with tperm")
    return _SpMMCOO.apply(x_br, vals, edges)


def make_edges(row, col, val, num_rows) -> Edges:
    """Host-side COO edges (``vq_gnn_tpu/ops/spmm.py:make_edges``), sorted by
    row (stable), with the col-sorting permutation and kernel 8's row
    offsets and long rows in both orders.  numpy arrays: ``Edges.to`` moves
    them."""
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    order = np.argsort(row, kind="stable")
    return coo_edges(row[order], col[order], val[order], int(num_rows))


def coo_edges(row, col, val, num_rows: int) -> Edges:
    """COO edges from row-sorted arrays (padding, if any, at the end with
    ``row = col = num_rows``): ``tperm`` and the lists of both orders."""
    tperm = np.argsort(col, kind="stable").astype(np.int32)
    ptr = row_offsets_host(row, num_rows)
    t_ptr = row_offsets_host(col[tperm], num_rows)
    return Edges(row=row, col=col, val=val, tperm=tperm, row_ptr=ptr,
                 row_long_rows=long_rows_host(ptr), t_row_ptr=t_ptr,
                 t_row_long_rows=long_rows_host(t_ptr), num_rows=num_rows)


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


def sub_ell_host(ell_row, ell_col, ell_val, num_rows: int, blocks):
    """The slots of the rows in ``blocks`` ([(r0, r1), ...] row ranges) of a
    slot-ELL whose rows ascend over num_rows (numpy): since the rows ascend,
    each range's slots are one contiguous run, ``[ptr[r0], ptr[r1])`` of
    :func:`row_offsets_host`, so padding slots (row >= num_rows) fall in none.
    The rows are renumbered from 0 in block order, the columns and values
    kept.  Returns (row, col, val, ptr, long_rows), the last two the
    kernel's lists over the ``sum(r1 - r0)`` rows."""
    ell_row = np.asarray(ell_row)
    ptr = row_offsets_host(ell_row, num_rows)
    rows, cols, vals, base = [], [], [], 0
    for r0, r1 in blocks:
        s0, s1 = int(ptr[r0]), int(ptr[r1])
        rows.append(ell_row[s0:s1].astype(np.int64) - r0 + base)
        cols.append(np.asarray(ell_col)[s0:s1])
        vals.append(np.asarray(ell_val)[s0:s1])
        base += r1 - r0
    row = np.concatenate(rows).astype(np.int32)
    sub_ptr = row_offsets_host(row, base)
    return (row, np.concatenate(cols).astype(np.int32), np.concatenate(vals).astype(np.float32),
            sub_ptr, long_rows_host(sub_ptr))


def gathered_order(idx, B_pad: int, Bp_pad: int, n: int) -> np.ndarray:
    """Batch-local rows (the batch rows [0, B_pad), the boundary rows
    [B_pad, B_pad + Bp_pad), the dustbin B_pad + Bp_pad) in the order of an
    all-gather over n row shards, each its B_pad / n batch rows, then its
    Bp_pad / n boundary rows (``parallel/mesh.py``); the dustbin stays.
    The identity at n = 1."""
    idx = np.asarray(idx, np.int64)
    b, bp = B_pad // n, Bp_pad // n
    fo = idx - B_pad
    b1, bp1 = max(b, 1), max(bp, 1)  # np.where evaluates both sides
    out = np.where(idx < B_pad, (idx // b1) * (b + bp) + idx % b1,
                   (fo // bp1) * (b + bp) + b + fo % bp1)
    return np.where(idx >= B_pad + Bp_pad, idx, out).astype(np.int32)


def build_mixed_ell_host(row, col, val, num_rows: int, K: int, Kt: int, Sh_pad: int,
                         St2_pad: int):
    """Host-side mixed-K construction from row-sorted COO (numpy; a copy of
    ``vq_gnn_tpu/ops/spmm.py:build_mixed_ell_host``).

    Per row: the first ``floor(deg/K)*K`` edges fill full K-wide HEAD slots;
    the remainder goes to Kt-wide TAIL slots.  Head slots carry a COMPACT row
    id (rank among rows with >= 1 head slot; gap-free ascending); tail rows
    are global and DENSE (every one of ``num_rows`` rows owns >= 1 tail slot,
    zero-valued when empty).  Returns (head_rowc [Sh_pad], head_col/val
    [Sh_pad, K], head_inv [num_rows], tail_row [St2_pad], tail_col/val
    [St2_pad, Kt], h_base, t_base, head_rowg [Sh_pad]); h_base/t_base are
    each family's slot counts below each row (for the truncation prefixes).
    Padding: head_rowc -> the count of head rows, head_rowg -> num_rows,
    head_inv -> num_rows (a row without head slots), tail sentinels as
    :func:`build_ell_host`."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    deg = np.bincount(row, minlength=num_rows)
    starts = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(len(row)) - starts[row]

    nh = deg // K  # full head slots per row
    head_rows = np.flatnonzero(nh > 0)
    n_head_rows = len(head_rows)
    rank = np.full(num_rows, num_rows, np.int64)  # sentinel = num_rows
    rank[head_rows] = np.arange(n_head_rows)
    h_base = np.concatenate([[0], np.cumsum(nh)])
    Sh = int(h_base[-1])
    if Sh > Sh_pad:
        raise ValueError(f"head slots {Sh} exceed Sh_pad={Sh_pad}")

    in_head = pos < nh[row] * K
    hr, hp = row[in_head], pos[in_head]
    h_sid = h_base[hr] + hp // K
    head_rowc = np.full(Sh_pad, n_head_rows, np.int32)
    head_rowc[:Sh] = np.repeat(rank[head_rows], nh[head_rows]).astype(np.int32)
    head_rowg = np.full(Sh_pad, num_rows, np.int32)
    head_rowg[:Sh] = np.repeat(head_rows, nh[head_rows]).astype(np.int32)
    head_col = np.full((Sh_pad, K), num_rows, np.int32)
    head_val = np.zeros((Sh_pad, K), np.float32)
    head_col[h_sid, hp % K] = col[in_head]
    head_val[h_sid, hp % K] = val[in_head]

    rem = deg - nh * K
    nt = np.maximum((rem + Kt - 1) // Kt, 1)  # dense: >= 1 tail slot per row
    t_base = np.concatenate([[0], np.cumsum(nt)])
    St2 = int(t_base[-1])
    if St2 > St2_pad:
        raise ValueError(f"tail slots {St2} exceed St2_pad={St2_pad}")
    tr, tp = row[~in_head], pos[~in_head] - nh[row[~in_head]] * K
    t_sid = t_base[tr] + tp // Kt
    tail_row = np.full(St2_pad, num_rows, np.int32)
    tail_row[:St2] = np.repeat(np.arange(num_rows), nt).astype(np.int32)
    tail_col = np.full((St2_pad, Kt), num_rows, np.int32)
    tail_val = np.zeros((St2_pad, Kt), np.float32)
    tail_col[t_sid, tp % Kt] = col[~in_head]
    tail_val[t_sid, tp % Kt] = val[~in_head]
    return (head_rowc, head_col, head_val, rank.astype(np.int32), tail_row, tail_col, tail_val,
            h_base, t_base, head_rowg)


def lists_host(rows, num_rows: int, live: int = -1):
    """(row offsets, long rows) of an ascending slot-row array over num_rows
    (:func:`row_offsets_host`, :func:`long_rows_host`); ``live`` >= 0 puts
    the slots from index ``live`` on (padding whose row is a real one, as
    the mixed head's) in no row."""
    rows = np.asarray(rows)
    if 0 <= live < len(rows):
        rows = np.where(np.arange(len(rows)) < live, rows, num_rows)
    ptr = row_offsets_host(rows, num_rows)
    return ptr, long_rows_host(ptr)


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
