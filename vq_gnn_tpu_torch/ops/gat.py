"""GAT edge attention (port of ``vq_gnn_tpu/ops/gat.py``): the fused conv of
the B + B' formulation over the single-K slot-ELL (kernels 4 and 5) and over
the mixed-K layout (per family, its segment sums kernel 8), the per-branch
conv ``gat_conv_ell_mh`` of the B + M formulation (kernel 8), and the
per-edge values ``gat_edge_values`` of the COO fallback (:func:`gat_conv_coo`).

Reference semantics (``vq_gnn_v2/convs.py:165-266`` + ``utils/vq_softmax.py``):

- per-node logits ``alpha_l = x @ att_l``, ``alpha_r = x @ att_r`` over the
  (C+1)-wide input that carries the appended ones column, here kept as the
  bias ``att[C]`` so that the feature matrix stays C wide;
- "Trick 1": both divided by the global explosion guard
  ``scale = sqrt(max(alpha_l)^2 + 1) * sqrt(max(alpha_r)^2 + 1)``;
- per-edge weight: the unnormalised ``exp(leaky_relu(al[src] + ar[dst]))``
  times the row-normalised adjacency value ("Trick 2");
- the ones column becomes ``rowsum``, the normaliser the model divides by.

Convention: row = destination, col = source.  :func:`gat_conv_ell` is a
``torch.autograd.Function``: over the single-K ELL its forward is kernel 4
and its backward kernel 5 over the transposed ELL (``ops/gat_kernels.py``);
over the mixed-K layout each family's cells are gathered and weighted in
plain PyTorch and summed by kernel 8 with its scalar channel (the
normaliser, and d_al in the backward), as the JAX package's mixed path
reduces with its segment-sum kernel.  ``d_ar`` has a closed form over the
forward's aggregates.

Under ``compute_dtype='bfloat16'`` or ``'float16'`` both convs take 16-bit
x and round where the JAX package rounds (``vq_gnn_tpu/ops/gat.py``), to x's
own dtype: the conv's outputs and logit cotangents stay f32, the cotangents
it gathers are at x's dtype, and dx comes back in it.

A batch sharded over ranks (``parallel/sharded.py``) runs the same
kernels over each rank's rows: :func:`gat_conv_sharded` (either fused conv
over a row shard's ``ShardEdges``, single-K or mixed-K, with the
collectives it is handed), :func:`gat_conv_coo` (the COO fallback, over
the rank's edges), :func:`gat_conv_mh_sharded` (the B + M per-branch conv)
and the ``ranks`` of :func:`explosion_scale` and :func:`branch_scale` (the
Trick-1 max over every rank's rows).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.ops.gat_kernels import NEGATIVE_SLOPE, gat_aggregate, gat_backward
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, take_listed, take_rows
from vq_gnn_tpu_torch.ops.spmm import Edges, fold_rows, mixed_families, spmm

__all__ = ["NEGATIVE_SLOPE", "attention_logits", "branch_scale", "explosion_scale",
           "gat_conv_coo", "gat_conv_ell", "gat_conv_ell_mh", "gat_conv_mh_sharded",
           "gat_conv_sharded", "gat_edge_values", "node_logits", "ranks_max"]


def attention_logits(x, att_l, att_r):
    """Per-node logits for heads=1: x [n, C], att_* [C] -> ([n], [n])."""
    return x @ att_l, x @ att_r


class _RanksMax(torch.autograd.Function):
    """The max over the last axis of v [..., n] over every rank's v: this
    rank's max, then one all-reduce MAX of the [...] maxima.  The backward
    is the whole batch's full ``amax``: the cotangent (summed over the
    ranks, each holding its part of it) split evenly over the ties of every
    rank (their count summed over the ranks), as torch's ``amax`` and
    ``jnp.max`` split it; one all-reduce of both."""

    @staticmethod
    def forward(ctx, v, ranks):
        m = ranks.max(v.amax(-1))
        ties = v == m[..., None]
        ctx.ranks = ranks
        ctx.save_for_backward(ties)
        return m

    @staticmethod
    def backward(ctx, g):
        (ties,) = ctx.saved_tensors
        k = g.numel()
        both = ctx.ranks.sum(torch.cat([g.reshape(-1), ties.sum(-1).reshape(-1).to(g.dtype)]))
        share = (both[:k] / both[k:].clamp(min=1.0)).reshape(g.shape)
        return ties * share[..., None], None


def ranks_max(v, ranks):
    """The max over the last axis of v [..., n] over every rank's v
    (``ranks``: ``max(t)`` and ``sum(t)``, copies of t reduced over the
    ranks of the rows, ``parallel/sharded.py``), its gradient the whole
    batch's (:class:`_RanksMax`)."""
    return _RanksMax.apply(v, ranks)


def explosion_scale(alpha_l, alpha_r, valid=None, ranks=None):
    """Trick 1 scale.  ``valid`` masks padded rows out of the global max.
    With ``ranks`` (a row shard's: ``max(t)`` and ``sum(t)``, copies of t
    reduced over the ranks of the rows, ``parallel/sharded.py``) the max is
    over every rank's valid rows and its gradient the whole batch's
    (:class:`_RanksMax`): one scalar all-reduce each way."""
    if ranks is not None:
        v = torch.stack([alpha_l, alpha_r]).masked_fill(~valid[None, :], float("-inf"))
        ml, mr = ranks_max(v, ranks)
        return torch.sqrt(ml**2 + 1.0) * torch.sqrt(mr**2 + 1.0)
    if valid is not None:
        # masked_fill takes the -inf as a scalar: a tensor made from it on the
        # card would be a host-to-device copy, which synchronises the stream
        ml = alpha_l.masked_fill(~valid, float("-inf")).max()
        mr = alpha_r.masked_fill(~valid, float("-inf")).max()
    else:
        ml, mr = alpha_l.max(), alpha_r.max()
    return torch.sqrt(ml**2 + 1.0) * torch.sqrt(mr**2 + 1.0)


def branch_scale(al, ar, al_cb, ar_cb, valid, ranks=None):
    """The B + M GAT conv's per-branch Trick-1 scale [nb]
    (``vq_gnn_tpu/nn/model.py:680-692``): each branch's largest logit over
    the valid batch rows (al, ar [B_pad, nb]) and over its codewords (al_cb,
    ar_cb [nb, M]), both sides, the v1 conv's max over its B + M input
    (convs.py:209).  With ``ranks`` (a row shard's, as
    :func:`explosion_scale` takes it) the batch rows' max is over every
    rank's valid rows, one all-reduce of [2, nb] each way
    (:class:`_RanksMax`); the codewords' max joins it after, locally."""
    v = torch.stack([al.t(), ar.t()]).masked_fill(~valid[None, None, :], float("-inf"))
    rows = v.amax(-1) if ranks is None else ranks_max(v, ranks)
    m = torch.maximum(rows, torch.stack([al_cb.amax(1), ar_cb.amax(1)]))
    return torch.sqrt(m[0] ** 2 + 1.0) * torch.sqrt(m[1] ** 2 + 1.0)


def gat_edge_values(row, col, adj_val, alpha_l, alpha_r, negative_slope=NEGATIVE_SLOPE,
                    edges=None):
    """Per-edge unnormalised-exp attention times the normalised adjacency
    value (``vq_gnn_tpu/ops/gat.py:gat_edge_values``): exp(leaky_relu(
    alpha_l[col] + alpha_r[row])) * adj_val, the indices clipped to the
    logits (padding edges have adj_val 0).  Logits [n], or [nb, n] for one
    row of values per branch.  Plain PyTorch, differentiable in the logits:
    the backward sums each logit's edges in a fixed order by kernel 8, not
    by ``index_add_``'s float atomics: over ``edges``' own lists where the
    whole batch's COO ``Edges`` are given (``row = edges.row``, ``col =
    edges.col``: the rows in their order with ``row_ptr``, the columns in
    ``tperm``'s with ``t_row_ptr``; ``ops/segsum.py:take_listed``), else
    sorted on the device (``take_rows``)."""

    def take(t, i, lists):  # t [n] or [nb, n] at i [E] -> [E] or [nb, E]
        tab, ic = t.reshape(-1, t.shape[-1]).t(), i.long().clamp(0, t.shape[-1] - 1)
        got = (take_rows(tab, ic)[0] if lists is None else take_listed(tab, ic, *lists))
        return got.t().reshape(t.shape[:-1] + i.shape)

    lists_l = lists_r = None
    if edges is not None:
        n = alpha_l.shape[-1]
        lists_r = (edges.row, None, edges.num_rows, edges.row_ptr, edges.row_long_rows)
        t_ok = edges.t_row_ptr is not None and edges.t_row_ptr.shape[0] == n + 1
        lists_l = (edges.col.index_select(0, edges.tperm.long()), edges.tperm.long(), n,
                   *((edges.t_row_ptr, edges.t_row_long_rows) if t_ok else (None, None)))
    a = take(alpha_l, col, lists_l) + take(alpha_r, row, lists_r)
    return torch.exp(F.leaky_relu(a, negative_slope)) * adj_val


def _gat_d_ar_closed_form(g_agg, g_rowsum, agg, rowsum, aggn, rsn):
    """d_ar per node from row-local forward aggregates (no per-cell work):
    sum over the cells of r of g_ev * ev * slope'(a) = <g_agg, agg> +
    g_rs * rowsum - (1 - slope) * (<g_agg, aggn> + g_rs * rsn).

    The two terms nearly cancel where almost all of a row's logits are <= 0,
    so this is less accurate than a per-cell sum there; on random data it
    holds to rtol 2e-4 (``vq_gnn_tpu/ops/gat.py:115-133``)."""
    base = (g_agg * agg).sum(1) + g_rowsum * rowsum
    negp = (g_agg * aggn).sum(1) + g_rowsum * rsn
    return base - (1.0 - NEGATIVE_SLOPE) * negp


def node_logits(x, xf, att_l, att_r, reduce=None):
    """The Trick-1 logits (x @ att[:C] + att[C]) of both sides, ([R], [R]);
    ``xf`` is x widened to f32 (x itself when f32).  Under 16-bit x (bf16
    or f16) both are dots at x's dtype from one [C, 2] product, as the JAX
    package's ``x @ att[:C].astype(x.dtype)``: att rounded to that dtype,
    the exact products summed in f32, the sums rounded to it (here, not
    wherever a backend's 16-bit matmul would) and handed on as f32.

    ``reduce`` (the 2-D mesh's, where x holds some of the columns) sums the
    [R, 2] partial dots over the ranks of the columns, before the rounding
    and the bias."""
    C = x.shape[1]
    if x.dtype == torch.float32:  # two f32 matvecs (no TF32, whatever it allows)
        if reduce is None:
            return x @ att_l[:C] + att_l[C], x @ att_r[:C] + att_r[C]
        dots = reduce(torch.stack([x @ att_l[:C], x @ att_r[:C]], 1))
    else:
        # bf16 values are exact in TF32, and so are f16 values (TF32 has
        # f16's 10-bit mantissa and f32's range), so one [C, 2] product
        # rounds nothing
        dots = xf @ torch.stack([att_l[:C], att_r[:C]], 1).to(x.dtype).float()
        dots = (dots if reduce is None else reduce(dots)).to(x.dtype).float()
    return dots[:, 0] + att_l[C], dots[:, 1] + att_r[C]


def _table_logits(x, xf, att_l, att_r, reduce=None, al=None, ar=None):
    """(al, ar) [Rx] of every row of the table x, f32 values: al as the conv
    forms it (the f32 att on the widened rows: under 16-bit x unrounded, as
    the TPU kernel forms it from the gathered rows), ar as :func:`node_logits`
    forms it (a dot at x's dtype under 16-bit x); either the caller's where
    given.
    ``reduce`` (the 2-D mesh's) sums the partial dots of both over the ranks
    of the columns, once, before the rounding and the bias."""
    C = x.shape[1]
    half = x.dtype != torch.float32
    dots = []
    if al is None:
        dots.append(xf @ att_l[:C])
    if ar is None:  # 16-bit values are exact in f32, so the matvec rounds only its sum
        dots.append(xf @ (att_r[:C].to(x.dtype).float() if half else att_r[:C]))
    if dots:
        dots = torch.stack(dots, 1)
        dots = list((dots if reduce is None else reduce(dots)).unbind(1))
        if al is None:
            al = dots.pop(0) + att_l[C]
        if ar is None:
            ar = (dots[0].to(x.dtype).float() if half else dots[0]) + att_r[C]
    return al, ar


def _gat_forward(edges, x, att_l, att_r, scale, with_neg: bool, xf=None, ar=None, al=None,
                 gather=None, reduce=None):
    """(agg [R, C], rowsum [R], aggn, rsn, al_node [R], ar_tab [Rx]), all
    f32, for f32, bf16 or f16 x (``vq_gnn_tpu/ops/gat.py:365-385``): kernel 4 over
    the R rows of ``edges``, reading the table of x (x itself, or
    ``gather(x)``, every rank's rows, where the owned rows start at
    ``edges.row0``) with the logits of each of its rows divided by the scale
    (:func:`_table_logits`, which takes the caller's ``al`` and ``ar`` where
    given); al_node is the owned rows' al."""
    R = x.shape[0]
    if xf is None:
        xf = x.float()
    if gather is not None:  # the caller's logits are its own rows'
        x = gather(x)
        xf, al, ar = x.float(), None, None
    al_tab, ar_tab = _table_logits(x, xf, att_l, att_r, reduce, al, ar)
    al_tab, ar_tab = al_tab / scale, ar_tab / scale
    own = slice(edges.row0, edges.row0 + R)
    agg, rowsum, aggn, rsn = gat_aggregate(
        x, edges.ell_row, edges.ell_col, edges.ell_val, al_tab, ar_tab[own], R,
        with_neg=with_neg, ptr=edges.ell_ptr, long_rows=edges.ell_long_rows,
    )
    return agg, rowsum, aggn, rsn, al_tab[own], ar_tab


class _GATConv(torch.autograd.Function):
    """The fused conv over the single-K slot-ELL (:func:`gat_conv_ell`) and,
    with ``gather`` and ``model_sum``, over a row shard
    (:func:`gat_conv_sharded`)."""

    @staticmethod
    def forward(ctx, x, att_l, att_r, scale, edges, xf, ar, al, gather, model_sum):
        xf = x.float() if xf is None else xf
        agg, rowsum, aggn, rsn, al_node, ar_tab = _gat_forward(
            edges, x, att_l, att_r, scale, True, xf, ar, al, gather, model_sum
        )
        ctx.edges, ctx.gather, ctx.model_sum = edges, gather, model_sum
        # xf (x itself when f32) for d_attl and d_attr: the caller's widened
        # copy, which its own logit product holds for its backward anyway
        ctx.save_for_backward(x, xf, att_l, att_r, scale, agg, rowsum, aggn, rsn, al_node,
                              ar_tab)
        return agg, rowsum[:, None]

    @staticmethod
    def backward(ctx, g_agg, g_rowsum):
        e = ctx.edges
        x, xf, att_l, att_r, scale, agg, rowsum, aggn, rsn, al_node, ar_tab = ctx.saved_tensors
        R, C = x.shape
        gs = x.dtype  # the cotangents and ar ride the exchange and the kernel at x's dtype
        g_rs = g_rowsum[:, 0]
        if ctx.gather is None:
            g_tab, g_rs_tab = g_agg.to(gs).contiguous(), g_rs.to(gs).contiguous()
        else:  # every rank's cotangents, one buffer
            g_all = ctx.gather(torch.cat([g_agg, g_rs[:, None]], 1).to(gs))
            g_tab, g_rs_tab = g_all[:, :C].contiguous(), g_all[:, C].contiguous()
        # transposed layout: d_al for every row (B' rows carry logits), dx_agg
        # only for the rows whose cotangent has a consumer: none at layer 0
        # (x is the input features), the rows < b_rows where the batch sets
        # the truncation (Edges.b_rows)
        b = (e.b_rows or R) if ctx.needs_input_grad[0] else 0
        dx_agg, d_al = gat_backward(
            x, e.t_ell_row, e.t_ell_col, e.t_ell_val, g_tab, g_rs_tab, al_node, ar_tab.to(gs),
            R, dx_rows=b, ptr=e.t_all_ptr, long_rows=e.t_all_long_rows,
        )
        d_ar = _gat_d_ar_closed_form(g_agg, g_rs, agg, rowsum, aggn, rsn)
        if ctx.model_sum is not None:
            # both are linear in this rank's channels of g_agg and in its
            # g_rowsum, the cotangent of its own columns' normalisation: the
            # sum over the model group is the whole batch's, each term once
            d_al, d_ar = ctx.model_sum(torch.stack([d_al, d_ar], 1)).unbind(1)
        ar_node = ar_tab[e.row0 : e.row0 + R]
        # d_scale = -sum(d_a * a) / scale with a = al[col] + ar[row]: the cell
        # sum separates into the per-node reductions
        d_scale = -(al_node @ d_al + ar_node @ d_ar) / scale
        dx = None
        if b:  # dx_agg is zero in the rows >= b, and so is dx
            dx = dx_agg
            dx[:b].addcmul_(d_al[:b, None], (att_l[:C] / scale)[None, :]).addcmul_(
                d_ar[:b, None], (att_r[:C] / scale)[None, :])
            dx = dx.to(gs)
        d_attl = torch.cat([(d_al @ xf) / scale, (d_al.sum() / scale)[None]])
        d_attr = torch.cat([(d_ar @ xf) / scale, (d_ar.sum() / scale)[None]])
        return dx, d_attl, d_attr, d_scale, None, None, None, None, None, None


def gat_conv_sharded(edges, x, att_l, att_r, scale, xf, gather=None, model_sum=None, al=None,
                     ar=None):
    """:func:`gat_conv_ell` over one rank's rows of a batch sharded over
    ranks -> (agg [R, C], rowsum [R, 1]) of its R owned rows.

    ``edges`` is the rank's ``parallel/mesh.py:ShardEdges``: the forward
    slots of its rows and the transposed slots of its rows (batch and
    boundary), single-K or each mixed family, columns in the gathered
    order, its rows from ``row0`` there.  The mixed families take the mixed
    conv (kernel 8 per family, the logits as :func:`_mixed_logits` forms
    them, d_scale by the per-cell sum) with the same hooks; the rest of
    this says what the single-K conv does.

    ``gather(t)`` all-gathers every rank's rows of t (None where the rows
    have one rank).  Forward: x gathered, al and ar of every gathered row
    recomputed from it (not gathered), kernel 4 over the owned rows' slots.
    Backward: the cotangents (g_agg and g_rowsum, at x's dtype, one buffer)
    gathered, ar of every row kept from the forward, kernel 5 over the
    shard's transposed slots: dx_agg of its batch rows and d_al of every
    owned row; d_ar by the closed form.  d_att* and d_scale are this rank's
    parts of sums over the ranks (the step's gradient all-reduce,
    :func:`explosion_scale`'s ``ranks``).

    On the 2-D mesh x holds this rank's columns and att_* its columns and
    the bias: ``model_sum(t)`` sums t over the model group (the table's
    partial logits, and d_al, d_ar in the backward).  Without ``gather``
    the table is x, and the caller's ``al`` and ``ar`` of it (values, as
    :func:`_table_logits` forms them) are not formed again."""
    if x.shape[0] != edges.num_rows:
        raise ValueError(f"x has {x.shape[0]} rows, the shard {edges.num_rows}")
    if edges.mixed:
        return _GATConvMixed.apply(x, att_l, att_r, scale, edges, xf, ar, gather, model_sum)
    return _GATConv.apply(x, att_l, att_r, scale, edges, xf, ar, al, gather, model_sum)


# ---------------------------------------------------------------------------
# the fused conv over the mixed-K layout
# ---------------------------------------------------------------------------
def _mixed_logits(x, xf, att_l, att_r, ar=None, model_sum=None):
    """(dl, ar) [Rx] of every row of the table x, f32 values: dl the column
    logit's dot before its bias as the JAX package's mixed path forms it from
    the gathered rows, f32 sums of x times att_l rounded to x's dtype
    (``einsum(..., preferred_element_type=f32)``: under 16-bit x the att is
    rounded and the sum is not; the backward's row-side logit rounds it),
    and ar as :func:`node_logits` forms it, the caller's where given.
    ``model_sum`` (the 2-D mesh's) sums the partial dots over the ranks of
    the columns, once, before any rounding and the bias."""
    C = x.shape[1]
    half = x.dtype != torch.float32

    def w(att):
        return att[:C].to(x.dtype).float() if half else att[:C]

    if model_sum is None:
        if ar is None:
            _, ar = node_logits(x, xf, att_l, att_r)
        return xf @ w(att_l), ar
    dots = [xf @ w(att_l)] + ([xf @ w(att_r)] if ar is None else [])
    dots = model_sum(torch.stack(dots, 1)).unbind(1)
    if ar is None:
        ar = (dots[1].to(x.dtype).float() if half else dots[1]) + att_r[C]
    return dots[0], ar


def _family_cells(al, ar, rows_g, cols, vals):
    """(a, ev) [S, K] of one family: a = al[col] + ar[row], ev =
    exp(leaky_relu(a)) * val, indices clipped to the tables."""
    alc = al.index_select(0, cols.reshape(-1).long().clamp(0, al.shape[0] - 1)).reshape(
        cols.shape)
    arr = ar.index_select(0, rows_g.long().clamp(0, ar.shape[0] - 1))
    a = alc + arr[:, None]
    return a, torch.exp(F.leaky_relu(a, NEGATIVE_SLOPE)) * vals


def _gather_rows(tbl, cols):
    """tbl[cols] widened to f32, [S, K, C] (cols clipped)."""
    S, K = cols.shape
    rows = tbl.index_select(0, cols.reshape(-1).long().clamp(0, tbl.shape[0] - 1))
    return rows.float().reshape(S, K, tbl.shape[1])


def _family_sum(part, scal, fam, R: int, inv):
    """Kernel 8 over one family's rows with its lists (both channels where
    ``part`` is given, else the scalars alone), the head folded back to the
    global rows through ``inv``; zeros, and no launch, for a family without
    slots (a row shard's)."""
    rows_c, ptr, long_rows = fam[0], fam[4], fam[5]
    if rows_c.shape[0] == 0:
        out = scal.new_zeros((R,))
        return (None if part is None else part.new_zeros((R, part.shape[1])), out)
    out = segment_sum_sorted(part, rows_c, R, scalar_partials=scal.contiguous(), ptr=ptr,
                             long_rows=long_rows)
    if part is None:
        out = (None, out)
    if inv is not None:
        out = tuple(None if o is None else fold_rows(o, inv) for o in out)
    return out


def _gat_forward_mixed(edges: Edges, x, att_l, att_r, scale, with_neg: bool, xf=None, ar=None,
                       gather=None, model_sum=None):
    """(agg [R, C], rowsum [R], aggn, rsn, dl [R], ar_tab [Rx]) over the
    mixed families (``vq_gnn_tpu/ops/gat.py:_gat_conv_fwd_impl_mixed``):
    per family the gathered rows weighted per cell, both sums by kernel 8
    with its scalar channel, the head folded through head_inv, the families
    added.  The table of x is x itself, or ``gather(x)`` (every rank's rows,
    where the owned R rows start at ``edges.row0``), with the logits of each
    of its rows from :func:`_mixed_logits` (the caller's ``ar`` where the
    table is x); dl is the owned rows' column-logit dot."""
    C, R = x.shape[1], edges.num_rows
    if gather is not None:  # the caller's ar is its own rows'
        x, ar = gather(x), None
        xf = x.float()
    elif xf is None:
        xf = x.float()
    dl, ar_tab = _mixed_logits(x, xf, att_l, att_r, ar, model_sum)
    own = slice(edges.row0, edges.row0 + R)
    al_n, ar_n = (dl + att_l[C]) / scale, ar_tab[own] / scale
    head, tail, inv = mixed_families(edges)
    sums = None
    for fam, fold in ((head, inv), (tail, None)):
        rows_g, cols, vals = fam[1], fam[2], fam[3]
        nbrs = _gather_rows(x, cols)
        a, ev = _family_cells(al_n, ar_n, rows_g, cols, vals)
        res = _family_sum((ev[:, :, None] * nbrs).sum(1), ev.sum(1), fam, R, fold)
        if with_neg:
            evn = ev * (a <= 0)
            res += _family_sum((evn[:, :, None] * nbrs).sum(1), evn.sum(1), fam, R, fold)
        sums = res if sums is None else tuple(s + r for s, r in zip(sums, res))
    return (sums if with_neg else sums + (None, None)) + (dl[own], ar_tab)


class _GATConvMixed(torch.autograd.Function):
    """The conv over the mixed-K layout (:func:`gat_conv_ell`) and, with
    ``gather`` and ``model_sum``, over a row shard's mixed families
    (:func:`gat_conv_sharded`)."""

    @staticmethod
    def forward(ctx, x, att_l, att_r, scale, edges: Edges, xf, ar, gather, model_sum):
        xf = x.float() if xf is None else xf
        agg, rowsum, aggn, rsn, dl, ar_tab = _gat_forward_mixed(
            edges, x, att_l, att_r, scale, True, xf, ar, gather, model_sum)
        ctx.edges, ctx.gather, ctx.model_sum = edges, gather, model_sum
        ctx.save_for_backward(x, xf, att_l, att_r, scale, agg, rowsum, aggn, rsn, dl, ar_tab)
        return agg, rowsum[:, None]

    @staticmethod
    def backward(ctx, g_agg, g_rowsum):
        """``vq_gnn_tpu/ops/gat.py:_gat_conv_bwd_mixed``: per transposed
        family (all of it: this conv has no truncation) the cells recomputed
        with the cotangents gathered at x's dtype (ar too), dx and d_al
        summed by kernel 8 and the head folded through t_head_inv; d_ar by
        the closed form; d_scale by the per-cell sum.  Over a row shard the
        cotangents are every rank's (``gather``, one buffer) and the
        transposed families those of the owned columns; on the 2-D mesh
        d_al, d_ar and d_scale, linear in this rank's channels and its share
        of the row sums' cotangent, are summed over the model group."""
        e: Edges = ctx.edges
        x, xf, att_l, att_r, scale, agg, rowsum, aggn, rsn, dl, ar_tab = ctx.saved_tensors
        R, C = x.shape
        gs = x.dtype
        g_rs = g_rowsum[:, 0]
        if ctx.gather is None:
            g_s, g_rs_s = g_agg.to(gs), g_rs.to(gs).float()
        else:  # every rank's cotangents, one buffer
            g_all = ctx.gather(torch.cat([g_agg, g_rs[:, None]], 1).to(gs))
            g_s, g_rs_s = g_all[:, :C], g_all[:, C].float()
        Rt = g_s.shape[0]
        ar_s = (ar_tab / scale).to(gs).float()  # the ar lane rides the gather at x's dtype
        # the row-side logit as the JAX backward forms it: x @ att_l in x's
        # dtype (a dot rounded to it under 16-bit x)
        al_t_node = ((dl.to(gs).float() if gs != torch.float32 else dl) + att_l[C]) / scale
        want_dx = ctx.needs_input_grad[0]
        head, tail, inv = mixed_families(e, transposed=True, whole=True)
        dx = d_al = None
        d_scale = scale.new_zeros(())
        for fam, fold in ((head, inv), (tail, None)):
            rows_g, cols, vals = fam[1], fam[2], fam[3]
            # transposed cells: row = source, column = destination
            a_t, ev_t = _family_cells(ar_s, al_t_node, rows_g, cols, vals)
            g3 = _gather_rows(g_s, cols)
            x_rows = xf.index_select(0, rows_g.long().clamp(0, R - 1))
            g_ev = (g3 * x_rows[:, None, :]).sum(-1) + g_rs_s.index_select(
                0, cols.reshape(-1).long().clamp(0, Rt - 1)).reshape(cols.shape)
            d_a = g_ev * ev_t * torch.where(a_t > 0, 1.0, NEGATIVE_SLOPE)
            d_scale = d_scale - (d_a * a_t).sum() / scale
            part = (ev_t[:, :, None] * g3).sum(1) if want_dx else None
            dx_f, d_al_f = _family_sum(part, d_a.sum(1), fam, R, fold)
            d_al = d_al_f if d_al is None else d_al + d_al_f
            if want_dx:
                dx = dx_f if dx is None else dx + dx_f
        d_ar = _gat_d_ar_closed_form(g_agg, g_rs, agg, rowsum, aggn, rsn)
        if ctx.model_sum is not None:
            red = ctx.model_sum(torch.cat([d_al, d_ar, d_scale[None]]))
            d_al, d_ar, d_scale = red[:R], red[R : 2 * R], red[2 * R]
        if want_dx:
            dx = (dx + d_al[:, None] * (att_l[None, :C] / scale)
                  + d_ar[:, None] * (att_r[None, :C] / scale)).to(gs)
        d_attl = torch.cat([(d_al @ xf) / scale, (d_al.sum() / scale)[None]])
        d_attr = torch.cat([(d_ar @ xf) / scale, (d_ar.sum() / scale)[None]])
        return dx, d_attl, d_attr, d_scale, None, None, None, None, None


# ---------------------------------------------------------------------------
# the COO fallback
# ---------------------------------------------------------------------------
def gat_conv_coo(edges: Edges, x, xf, att_l, att_r, valid, ranks=None, reduce=None, table=None,
                 aggregate=None):
    """The layer's GAT conv on COO edges (``vq_gnn_tpu/nn/model.py:312-352``)
    -> (agg [R, C], rowsum [R, 1]): the Trick-1 logits over the reference's
    (C+1)-wide input (f32 dots of x, ``xf`` x widened, the ones column's
    weight att[C]), the scale over the valid rows, the per-edge values
    (:func:`gat_edge_values`), then a COO sum (kernel 8) of x with its ones
    column that differentiates them.

    Over a row shard (``parallel/sharded.py``; ``edges`` the rank's
    ``parallel/mesh.py:ShardEdges``: the COO edges of its rows and, sorted by
    column, of its batch columns, columns in the gathered order): the scale
    over every rank's valid rows (:func:`explosion_scale`'s ``ranks``),
    ``table(t)`` the scaled logits [R, 2] of every rank's rows
    (differentiable: its backward sums the cotangents over the ranks and
    keeps the owned rows'), the values of the owned rows' edges and of the
    transposed ones (values only: the backward's) from it, and
    ``aggregate(x1, ev, ev_t)`` the sum over every rank's rows of x with the
    ones column, differentiable in x1 and ev.  On the 2-D mesh x holds this
    rank's columns, att_* its columns and the bias, and ``reduce`` sums the
    partial dots over the ranks of the columns before the bias."""
    C = x.shape[1]
    if reduce is None:  # the reference's (C+1)-wide product
        x1f = torch.cat([xf, xf.new_ones((xf.shape[0], 1))], 1)
        al, ar = x1f @ att_l, x1f @ att_r
    else:
        al, ar = node_logits(xf, xf, att_l, att_r, reduce=reduce)
    scale = explosion_scale(al, ar, valid, ranks)
    logits = torch.stack([al, ar], 1) / scale
    x1 = torch.cat([x, x.new_ones((x.shape[0], 1))], 1)
    e = edges
    if table is None:  # the whole batch: spmm's backward walks tperm
        al_t, ar_t = logits.unbind(1)
        out = spmm(dataclasses.replace(e, val=gat_edge_values(e.row, e.col, e.val, al_t, ar_t,
                                                              edges=e)), x1)
    else:
        al_t, ar_t = table(logits).unbind(1)
        ev = gat_edge_values(e.row + e.row0, e.col, e.val, al_t, ar_t)
        with torch.no_grad():  # source = the owned column, destination = the gathered row
            ev_t = gat_edge_values(e.t_col, e.t_row + e.row0, e.t_val, al_t, ar_t)
        out = aggregate(x1, ev, ev_t)
    return out[:, :C], out[:, C:]


def gat_conv_ell(edges: Edges, x, att_l, att_r, scale, xf=None, ar=None):
    """Attention-weighted slot-ELL aggregation -> (agg [R, C], rowsum [R, 1]).

    Per edge ``exp(leaky_relu(al[col] + ar[row])) * val`` with the node logits
    ``al = (x @ att_l[:C] + att_l[C]) / scale`` (and ``ar`` from ``att_r``),
    summed over rows; ``rowsum`` is the ones-column normaliser.  x has one
    row per ELL row (``edges.num_rows``); scale is a 0-dim tensor.
    Differentiable in x, att_l, att_r and scale; without a gradient to take,
    the forward skips the masked channels that only the backward reads.

    A caller that formed them already (the layer, for the Trick-1 scale)
    passes ``xf``, x widened to f32, and ``ar``, :func:`node_logits`' second
    logit before the division by scale, so that neither is formed twice.
    Both are values only: the gradients come from the closed forms."""
    if x.shape[0] != edges.num_rows:
        raise ValueError(f"x has {x.shape[0]} rows, the ELL {edges.num_rows}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, att_l, att_r, scale))
    if edges.mixed:
        if grad:
            return _GATConvMixed.apply(x, att_l, att_r, scale, edges, xf, ar, None, None)
        agg, rowsum = _gat_forward_mixed(edges, x, att_l, att_r, scale, False, xf, ar)[:2]
        return agg, rowsum[:, None]
    if edges.ell_row is None:  # COO runs gat_edge_values and spmm instead
        raise ValueError("gat_conv_ell: the edges hold neither slot-ELL layout")
    if grad:
        return _GATConv.apply(x, att_l, att_r, scale, edges, xf, ar, None, None, None)
    agg, rowsum, _, _, _, _ = _gat_forward(edges, x, att_l, att_r, scale, False, xf, ar)
    return agg, rowsum[:, None]


# ---------------------------------------------------------------------------
# per-branch (multi-head) GAT conv of the B + M formulation
# ---------------------------------------------------------------------------
def _gat_mh_ev(ell_row, ell_col, ell_val, al, ar):
    """Per-cell (a, ev) [S, K, nb] in a given layout: a = al at the cell's
    column + ar at the slot's row, ev = exp(leaky_relu(a)) * val (indices
    clip to the tables, as JAX's ``mode='clip'``)."""
    S, K = ell_col.shape
    cols = ell_col.reshape(-1).long().clamp(0, al.shape[0] - 1)
    alc = al.index_select(0, cols).reshape(S, K, al.shape[1])
    arr = ar.index_select(0, ell_row.long().clamp(0, ar.shape[0] - 1))  # [S, nb]
    a = alc + arr[:, None, :]
    ev = torch.exp(F.leaky_relu(a, NEGATIVE_SLOPE)) * ell_val[:, :, None]
    return a, ev


def _weighted_rows(ev, table, idx):
    """sum over k of ev[s, k, n] * table[idx[s, k], n*D:(n+1)*D] -> [S, nb*D]
    (the per-branch weight broadcast over its D channels), f32.  A 16-bit
    table meets weights rounded to its dtype, as in JAX's einsum of the cast
    repeated weights (``vq_gnn_tpu/ops/gat.py:746, 786``); the exact
    products are summed in f32."""
    S, K, nb = ev.shape
    rows = table.index_select(0, idx.reshape(-1).long().clamp(0, table.shape[0] - 1))
    if table.dtype != torch.float32:
        ev, rows = ev.to(table.dtype).float(), rows.float()
    return (ev[..., None] * rows.reshape(S, K, nb, -1)).sum(1).reshape(S, -1)


def _gat_mh_forward(edges: Edges, x_tab, al_tab, ar):
    """(agg [R, nb*D], rowsum [R, nb]) of the R rows of the forward ELL,
    reading the table of x and al its columns index (the rows themselves,
    or every rank's rows over a row shard) and ar of the rows."""
    R = edges.num_rows
    _, ev = _gat_mh_ev(edges.ell_row, edges.ell_col, edges.ell_val, al_tab, ar)
    lists = dict(ptr=edges.ell_ptr, long_rows=edges.ell_long_rows)
    agg = segment_sum_sorted(_weighted_rows(ev, x_tab, edges.ell_col), edges.ell_row, R,
                             **lists)
    return agg, segment_sum_sorted(ev.sum(1), edges.ell_row, R, **lists)


def _gat_mh_d_a(g, g_rs, x, a, ev):
    """Per-cell logit cotangent d_a [S, K, nb]: (<g, x> over each branch's D
    channels + g_rs) * ev * leaky_relu'(a), from the cells' cotangents g [.,
    ., nb*D] and g_rs [., ., nb] and their rows of x [., ., nb*D], each
    [S, K, ...] or [S, 1, ...] (the slot's own row), widened to f32."""
    S, K, nb = ev.shape
    d_ev = (g.float().reshape(g.shape[0], g.shape[1], nb, -1)
            * x.float().reshape(x.shape[0], x.shape[1], nb, -1)).sum(-1) + g_rs.float()
    return d_ev * ev * torch.where(a > 0, 1.0, NEGATIVE_SLOPE)


def _mh_transposed_grads(e: Edges, g_tab, g_rs_tab, x_g, al, ar_tab, need_dx: bool):
    """(dx, d_al [R, nb], d_a_t [St, Kt, nb]) of the R rows of ``x_g`` over
    their transposed slots: row = the source (sorted), column = the
    destination, which indexes the cotangent tables ``g_tab`` [., nb*D] and
    ``g_rs_tab`` [., nb] (at x's dtype) and ``ar_tab``, so the logit roles
    swap: a_t = al[source] + ar[destination].  dx (None unless ``need_dx``)
    at x's dtype; kernel 8 each, with the whole transposed ELL's row lists."""
    R, nb = al.shape
    St, Kt = e.t_ell_col.shape
    a_t, ev_t = _gat_mh_ev(e.t_ell_row, e.t_ell_col, e.t_ell_val, ar_tab, al)
    t_lists = dict(ptr=e.t_all_ptr, long_rows=e.t_all_long_rows)
    dx = None
    if need_dx:
        dx = segment_sum_sorted(_weighted_rows(ev_t, g_tab, e.t_ell_col), e.t_ell_row, R,
                                **t_lists).to(x_g.dtype)
    idx_t = e.t_ell_col.reshape(-1).long().clamp(0, g_tab.shape[0] - 1)
    d_a_t = _gat_mh_d_a(g_tab.index_select(0, idx_t).reshape(St, Kt, -1),
                        g_rs_tab.index_select(0, idx_t).reshape(St, Kt, nb),
                        x_g.index_select(0, e.t_ell_row.long().clamp(0, R - 1))[:, None],
                        a_t, ev_t)
    return dx, segment_sum_sorted(d_a_t.sum(1), e.t_ell_row, R, **t_lists), d_a_t


class _GATConvMH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_g, al, ar, edges: Edges):
        ctx.edges = edges
        ctx.save_for_backward(x_g, al, ar)
        return _gat_mh_forward(edges, x_g, al, ar)

    @staticmethod
    def backward(ctx, g_agg, g_rs):
        e: Edges = ctx.edges
        x_g, al, ar = ctx.saved_tensors
        nb = al.shape[1]
        # the cotangents are gathered at x_g's dtype, as JAX streams them
        gs = x_g.dtype
        g_agg, g_rs = g_agg.to(gs).contiguous(), g_rs.to(gs).contiguous()
        dx, d_al, d_a_t = _mh_transposed_grads(e, g_agg, g_rs, x_g, al, ar,
                                               ctx.needs_input_grad[0])
        # forward layout: mirror the per-cell d_a through f_from_t (empty
        # cells point one past the end, at a zero row), then reduce by row
        S, K = e.ell_col.shape
        d_a_flat = torch.cat([d_a_t.reshape(-1, nb), d_a_t.new_zeros((1, nb))])
        d_a_f = d_a_flat.index_select(0, e.f_from_t.reshape(-1)).reshape(S, K, nb)
        d_ar = segment_sum_sorted(d_a_f.sum(1), e.ell_row, e.num_rows, ptr=e.ell_ptr,
                                  long_rows=e.ell_long_rows)
        return dx, d_al, d_ar, None


def _gather_with_logits(gather, x, logits):
    """(every rank's rows of x, of the f32 logits [R, k]) in one all-gather:
    beside 16-bit rows each logit rides as its bits, two 16-bit values."""
    C = x.shape[1]
    lg = logits.contiguous()
    lg = lg.view(x.dtype) if x.dtype != lg.dtype else lg
    both = gather(torch.cat([x, lg], 1))
    lg = both[:, C:].contiguous()
    return both[:, :C], lg.view(logits.dtype) if lg.dtype != logits.dtype else lg


class _GATConvMHSharded(torch.autograd.Function):
    """:func:`gat_conv_mh_sharded`'s conv."""

    @staticmethod
    def forward(ctx, x_g, al, ar, edges, gather):
        nb = al.shape[1]
        x_tab, al_tab, ar_tab = x_g, al, ar
        if gather is not None:
            x_tab, lg = _gather_with_logits(gather, x_g, torch.cat([al, ar], 1))
            al_tab, ar_tab = lg[:, :nb], lg[:, nb:]
        ctx.edges, ctx.gather = edges, gather
        ctx.save_for_backward(x_g, al, ar, x_tab, al_tab, ar_tab)
        return _gat_mh_forward(edges, x_tab, al_tab, ar)

    @staticmethod
    def backward(ctx, g_agg, g_rs):
        e = ctx.edges
        x_g, al, ar, x_tab, al_tab, ar_tab = ctx.saved_tensors
        R = al.shape[0]
        C = x_g.shape[1]
        gs = x_g.dtype  # the cotangents ride the exchange at x's dtype, as JAX streams them
        g_own = torch.cat([g_agg, g_rs], 1).to(gs)
        g_all = g_own if ctx.gather is None else ctx.gather(g_own)
        Rt = g_all.shape[0]
        # the transposed cells of every owned column: row = the owned
        # source, column = the gathered destination
        dx, d_al, _ = _mh_transposed_grads(e, g_all[:, :C].contiguous(),
                                           g_all[:, C:].contiguous(), x_g, al, ar_tab,
                                           ctx.needs_input_grad[0])
        # d_ar from the owned rows' forward cells: a cell's mirror lies in
        # its column's transposed slots, another rank's where the column
        # is, so its d_a is formed again here, from the rows' own
        # cotangents and the saved table (the same products, the same bits)
        S, K = e.ell_col.shape
        a_f, ev_f = _gat_mh_ev(e.ell_row, e.ell_col, e.ell_val, al_tab, ar)
        rows = e.ell_row.long().clamp(0, R - 1)
        g_rows = g_own.index_select(0, rows)[:, None]
        d_a_f = _gat_mh_d_a(
            g_rows[:, :, :C], g_rows[:, :, C:],
            x_tab.index_select(0, e.ell_col.reshape(-1).long().clamp(0, Rt - 1)).reshape(S, K, -1),
            a_f, ev_f)
        d_ar = segment_sum_sorted(d_a_f.sum(1), e.ell_row, R, ptr=e.ell_ptr,
                                  long_rows=e.ell_long_rows)
        return dx, d_al, d_ar, None, None


def gat_conv_mh_sharded(edges, x_g, al, ar, gather=None):
    """:func:`gat_conv_ell_mh` over one rank's rows of a batch sharded over
    ranks -> (agg [R, nb*D], rowsum [R, nb]) of its R owned rows.

    ``edges`` is the rank's ``parallel/mesh.py:ShardEdges``: the forward
    slots of its rows and the transposed slots of every column it owns
    (batch and boundary), columns in the gathered order, its rows from
    ``row0`` there; ``x_g`` [R, nb*D] its rows of the conv's input (at the
    compute dtype) and ``al``, ``ar`` [R, nb] their scaled f32 logits, as
    the layer forms them (before the 16-bit cast: so they ride the exchange
    and are not formed again from the gathered rows).

    ``gather(t)`` all-gathers every rank's rows of t (None where the rows
    have one rank).  Forward: x and both logits of every rank's rows
    gathered in one call, kernel 8 over the owned rows' slots.  Backward:
    the cotangents (g_agg and g_rowsum, at x's dtype, one buffer) gathered;
    dx and d_al of every owned row over its transposed slots (a boundary
    row's logit has its gradient too); d_ar of the owned rows over their
    forward cells, whose cotangents are the rows' own: kernel 8 each.  No
    ``f_from_t``: it would mirror cells across ranks.  d_al and d_ar are
    the logits' gradients of the owned rows; what they feed (att_*, the
    scale) is summed over the ranks by the step."""
    if x_g.shape[0] != edges.num_rows:
        raise ValueError(f"x has {x_g.shape[0]} rows, the shard {edges.num_rows}")
    return _GATConvMHSharded.apply(x_g, al, ar, edges, gather)


def gat_conv_ell_mh(edges: Edges, x_g, al, ar):
    """Per-branch attention-weighted slot-ELL aggregation of the B + M layer
    (``vq_gnn_tpu/ops/gat.py:gat_conv_ell_mh``; reference
    ``vq_gnn_v1/models.py:186-233``: one attention head per branch over its
    own D-wide slice).

    ``x_g [R, nb*D]`` (channel n*D + d is branch n, feature d), ``al``/``ar``
    [R, nb] per-node per-branch logits, already Trick-1 scaled.  Returns
    ``(agg [R, nb*D], rowsum [R, nb])``: per branch the aggregate of
    ``exp(leaky_relu(al[src] + ar[dst])) * val`` times x, and its ones-column
    normaliser.  Every segment sum is kernel 8 on CUDA tensors, with the
    batch's row offsets and long rows (``Edges.ell_ptr``, ``t_all_ptr``);
    the backward works in the transposed layout and mirrors the per-cell
    logit cotangent back through ``edges.f_from_t`` for ``d_ar``."""
    if edges.ell_row is None or edges.f_from_t is None:
        # B + M GAT batches keep the single-K ELL under ell_Kt > 0, and COO
        # batches take the layer's per-branch fallback
        raise ValueError("gat_conv_ell_mh needs the single-K slot-ELL with its f_from_t map")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_g, al, ar)):
        return _GATConvMH.apply(x_g, al, ar, edges)
    return _gat_mh_forward(edges, x_g, al, ar)
