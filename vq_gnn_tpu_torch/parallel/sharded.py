"""One batch sharded over ranks: the training step on each rank's
:class:`~vq_gnn_tpu_torch.parallel.mesh.RowShard` (the port of the JAX
package's ``train_step`` under ``shard_train_inputs`` and
``shard_train_inputs_2d``, where XLA inserts the collectives; here they are
written out).

**The row exchange** (:class:`_RowExchange`, the aggregate of a row shard
in its layout).  Forward: the ranks' conv inputs (each its batch rows and
its looked-up boundary rows) are all-gathered into the whole [B_pad +
Bp_pad, C], and ``ops/spmm.py:rows_aggregate`` sums the rows this rank
owns: kernel 1 (``ops/ell_aggregate.py``) over its single-K slots or once
per mixed-K family, the head folded through the shard's ``head_inv``, or
kernel 8 (``ops/segsum.py``) over its COO edges.  Backward: the
cotangents of every rank's owned rows are all-gathered, and
``ops/spmm.py:shard_dx`` sums the transposed slots or edges of this rank's
batch columns the same way, so each rank gets dx for its own rows (the
boundary rows' dx has no consumer: zeros).  All-gathers only: gloo has no
reduce-scatter, and no row is reduced twice.  The JAX docstring's design,
each rank's partial aggregate over its slots all-reduced, reads the same
gathered rows and adds an all-reduce of [B_pad + Bp_pad, C] (on a ring
about twice an all-gather's bytes) to every aggregate.  Under bf16 or f16
compute the rows ride at that dtype both ways, the values the whole batch's
step hands the kernels.

**The GAT conv** (:func:`_gat_conv`, ``ShardEdges.gat``): the logits of
the owned rows, the Trick-1 scale over every rank's valid rows
(``ops/gat.py:explosion_scale``'s ``ranks``: an all-reduce MAX, and in the
backward one all-reduce of the cotangent and the tie count, so that its
gradient is the whole batch's), then ``ops/gat.py:gat_conv_sharded``: the
same exchange of x (forward) and of the cotangents with the row sums
(backward), and on the single-K slots kernel 4 over the owned rows' slots
and kernel 5 over the transposed slots of every owned row, on the mixed-K
families kernel 8 with its scalar channel per family, forward and
transposed.  On COO the layer's fallback (``gat_conv_coo``): the
scaled logits of every rank's rows gathered as one [R, 2] table
(:class:`_LogitTable`, whose backward sums the cotangents of the whole
table in one all-reduce and keeps the owned rows': the column logit of an
edge belongs to the rank that owns the column), the per-edge values of
the owned rows' edges and of the batch columns' transposed edges from it,
and the exchange above over the (C+1)-wide x with its ones column, whose
backward also gives the edge values' gradient against the gathered rows.

**B + M** (``formulation='bm'``).  The shard carries its rows' part of
the recovery term's reverse list (``parallel/mesh.py``).  GCN and SAGE
aggregate through the row exchange as above; GCN's recovery term is its
boundary rows' ``x_out · grad_fo``, SAGE's rows 9-10 (or the grid path
beside COO) over the rank's own reverse cells, each rank's term over its
rows, their sum over the ranks the whole batch's.  The per-branch GAT conv
(``ShardEdges.gat_mh``, ``ops/gat.py:gat_conv_mh_sharded``): the
per-branch Trick-1 max over every rank's valid rows (``scale_ranks``,
``ops/gat.py:branch_scale``: one all-reduce MAX of [2, nb], its backward
one all-reduce of the cotangent and the ties), then the codebooks' max
locally; the owned rows' x with both f32 logits all-gathered in one call
(under 16-bit compute the logits' bits ride beside the 16-bit rows: the
layer forms them from the f32 rows, so they cannot be formed again from the
gathered ones), kernel 8 over the owned rows' slots; backward, the cotangents
all-gathered, dx and d_al over the transposed slots of every owned column
and d_ar over the owned rows' forward cells (no ``f_from_t``, which would
mirror cells across ranks).  The recovery term reads the owned rows'
logits and the ranks' scale; its d ``ar_cb`` reaches ``att_r`` through
the replicated codebook logits, summed by the step's gradient all-reduce.
On the 2-D mesh a model rank holds its branches' heads (rows of ``att_l``
/ ``att_r``), so its logits, scale, conv and recovery term are its
branches' alone, and the conv's output enters the layer's linears through
"g" as the other convs' does.  On COO (:func:`_gat_mh_conv`) the same
scale, then the scaled logits of every rank's rows gathered as one [R, 2
nb] table (:class:`_LogitTable`, over the data group: a model rank's
table is its branches'), the per-branch values of the owned rows' edges
and of the batch columns' transposed edges from it, and
:class:`_BranchExchange`: every rank's rows of the per-branch input [nb,
R, D + 1] gathered, one kernel-8 sum over all branches of the owned rows'
edges (``ops/spmm.py:spmm_branches``' sum); backward, the cotangents
gathered, dx of the batch columns over their transposed edges, and the
values' gradient against the gathered rows.  Its recovery term is the grid
path over the rank's raw reverse entries.

**The transformer branch** (``transformer_flag``,
``nn/model.py:transformer_branch``, ``ShardEdges.tr_ranks``): the batch
rows are the rank's, the codewords replicated.  Per layer two
all-reduces cross the ranks: c_max, the largest squared row norm of every
rank's valid rows (MAX of [nb], its backward one all-reduce of the
cotangent and the ties, [2, nb], as the Trick-1 max), and out_M's
normaliser, a sum over every rank's rows ([nb, M], its backward an
all-reduce of the cotangent); out_B's softmax over the codewords is
row-local.  Each rank's out_M, and its recovery term, is its rows' part.
The step takes the gradients of the transformer's probes too, and runs
its codebooks' VQ update through the same moments, EMA sums and
``c_indices`` merge as the layers'.  On the 2-D mesh a model rank holds
its branches' codebooks, ``transformer_k`` rows and fan-in columns of
``transformer_v`` and ``transformer_res``, whose products join the
layer's partial sum.

**The 1-D step** (:func:`make_sharded_step`, ``train_step``'s signature).
It runs ``train/step.py:step_forward`` and ``live_vq_update`` on the
shard, with hooks and no copy of the layer: ``spmm`` calls the bound
exchange, and ``model_forward``'s ``stats_reduce`` sums the inter-layer
BN's moment sums over the ranks in a differentiable all-reduce (its
backward an all-reduce), so every rank normalises by the whole batch's
moments.  Each rank's loss is its rows' CE sum over the whole batch's
count plus its boundary rows' recovery term, whose sum over the ranks is
the whole batch's loss; the backward, through the exchange and the moments,
gives each rank the gradient of that sum, the parameter gradients are
summed over the ranks, RMSprop runs on the sums alike on every rank.  The
VQ transition is the data-parallel step's (``parallel/multihost.py``): the
moments and the EMA statistics summed before any divide, each rank's
assignments gathered as uint8 and written by every rank
(``_cidx_merge``), from the whole batch's ids the shard carries (no id
gather).  Rows 1, 6 and 7 run on the shard: the aggregate of its rows, the
assignment of its batch rows, the lookup of its boundary rows.

**The 2-D step** (:func:`make_sharded_step_2d`).  The data axis as above
over the data group.  On the model axis each rank holds nb / n_model
branches: each layer takes the columns of its branches from the
replicated layer input through ``_CopyToModel`` (identity forward, the
gradient all-reduced over the model group: Megatron-LM's "f", Shoeybi et
al., 2019), looks up, aggregates (row 1 or 2 at C / n_model) and assigns
(row 6 at nb / n_model) its branches only, multiplies them by its fan-in
columns of each linear, and ``_ReduceFromModel`` sums the partial products
over the model group (all-reduce forward, identity backward: "g"); the
biases, BN and the loss then run replicated over the model group.  The
gradients (of the fan-in columns and of the replicated parameters) are
summed over the data group only: a model rank's replicated gradient is
already the whole one.  GAT keeps ``att_l`` and ``att_r`` replicated, as
the JAX package does for B + B': a rank's logit is a partial dot over its
columns, summed over the model group by "g" before the bias; the conv
aggregates the rank's columns with the whole logits; in the backward row
3's d_al and the closed-form d_ar of each rank cover its channels and its
own columns' share of the row-sum cotangent, and their sum over the model
group is the whole batch's; the attention vectors' columns pass "f", so
each rank's gradient of them is whole.  The mixed-K conv sums its per-cell
d_scale with d_al and d_ar; the COO fallback sums its table's cotangent
over every rank at once (the data and the model groups), each model rank
holding its columns' part of the edge values' gradient.

**Multilabel** (``make_sharded_step(..., multilabel=True)``, JAX
``make_step_fns(multilabel=True)``): each rank's loss is its rows' BCE
sum over the count of every rank's rows times the labels, ``train_acc``
0.

**The link step** (:func:`make_sharded_link_step`, ``_2d``;
``train/link.py:link_train_step``'s signature).  The forward as above on
the shard; then every rank's output rows gathered into the whole batch's
[B_pad, C_out] (:class:`_LogitTable` under ``link``: its backward sums the
whole table's cotangent over the data group and keeps the owned rows; on
the 2-D mesh the output is whole after "g", so a model rank's table is
too).  Each rank scores its block of the in-batch pairs (``link_src`` and
``link_dst``, the whole batch's row indices) and of the uniform negatives
(``dst_neg``, drawn at the whole batch's [L_pad] from a generator seeded
alike on every rank, or the caller's) through the replicated predictor,
one set of dropout masks for both calls; its loss is its pairs' clamped
log terms over the pairs' count summed over the data group, plus its
recovery term, so that the ranks' losses sum to the whole batch's.  The
model's and the predictor's gradients are summed over the data group in
one call; then the per-layer clip (``cfg.clip``): ``gnn_transform`` by
``clip[0]``, GAT's ``att_l`` and ``att_r`` by ``clip[1]``, the squared
norms of the tensors a model rank holds in part (the fan-in columns, B +
M GAT's heads) summed over the model group in one all-reduce, so the scale
is alike on every rank; RMSprop on both; the live VQ update of the layers'
codebooks only (the JAX link step keeps the transformer's).

``CollectiveLedger`` counts every collective: ``rows`` (the exchanges,
the B + M GAT conv's with its logits), ``partials`` (the model-axis
all-reduces), ``stats`` (the BN and VQ moments, the EMA statistics),
``grad``, ``c_indices``, ``scalars`` (with the Trick-1 max, per branch on
B + M, and its backward, and the link step's clip norms), ``logits`` (the
COO GAT conv's table and its backward sum, [R, 2] or on B + M [R, 2 nb]),
``transformer`` (c_max and out_M's normaliser, each with its backward)
and ``link`` (the link step's output rows, [B_pad, C_out] each way).

GCN, SAGE and GAT, B + B' and B + M, with or without the transformer
branch, on each adjacency layout (single-K and mixed-K slot-ELL, COO), f32,
bf16 or f16 compute, node (CE or multilabel BCE) and link batches, take a
sharded step; a B + M GAT link step with live VQ raises by name as the
whole batch's does (no JAX reference).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.distributed as dist

from vq_gnn_tpu_torch.config import Config
from vq_gnn_tpu_torch.nn.model import ModelStatic
from vq_gnn_tpu_torch.ops.gat import (
    explosion_scale,
    gat_conv_coo,
    gat_conv_mh_sharded,
    gat_conv_sharded,
    gat_edge_values,
    node_logits,
)
from vq_gnn_tpu_torch.ops.spmm import _coo_sddmm, _segment_matvec, rows_aggregate, shard_dx
from vq_gnn_tpu_torch.parallel.mesh import DataMesh, Mesh2D, RowShard
from vq_gnn_tpu_torch.parallel.multihost import CollectiveLedger, _cidx_merge, _Collectives
from vq_gnn_tpu_torch.train.link import (
    check_link_config,
    clip_groups,
    dropout_masks,
    link_loss_parts,
)
from vq_gnn_tpu_torch.train.optim import clip_scale, rmsprop_update
from vq_gnn_tpu_torch.train.state import TrainState
from vq_gnn_tpu_torch.train.step import (
    draw_branch_masks,
    live_vq_update,
    masked_bce_parts,
    masked_ce_parts,
    step_forward,
)


class _RowExchange(torch.autograd.Function):
    """The aggregate of a row shard's owned rows in its layout (the module
    docstring); on COO with the values ``vals`` of its edges (the GAT
    conv's, differentiable) and ``t_vals`` of its transposed edges (values
    only), else the adjacency's."""

    @staticmethod
    def forward(ctx, x, vals, t_vals, edges, comm):
        ctx.edges, ctx.comm, ctx.x_dtype, ctx.t_vals = edges, comm, x.dtype, t_vals
        xf = comm.gather(x, "rows") if comm.size > 1 else x
        ctx.save_for_backward(xf if ctx.needs_input_grad[1] else None)
        return rows_aggregate(edges, xf, vals)

    @staticmethod
    def backward(ctx, g):
        e, comm = ctx.edges, ctx.comm
        (xf,) = ctx.saved_tensors
        dx = dval = None
        if ctx.needs_input_grad[0]:
            # the cotangent rides at x's dtype, as the whole batch's spmm
            # streams it (ops/spmm.py); dx comes back in it
            gc = g.to(ctx.x_dtype).contiguous()
            gf = comm.gather(gc, "rows") if comm.size > 1 else gc
            dx_b = shard_dx(e, gf, ctx.t_vals)
            dx = torch.cat([dx_b, dx_b.new_zeros((e.num_rows - e.b_rows, dx_b.shape[1]))]).to(
                ctx.x_dtype)
        if ctx.needs_input_grad[1]:  # the owned rows' edges against the gathered rows
            dval = _coo_sddmm(e.row, e.col, g[None], xf[None])[0]
        return dx, dval, None, None, None


def _gather_branches(comm: _Collectives, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of a per-branch [nb, R, Dc] tensor, [nb, R_all,
    Dc], in one all-gather of its [R, nb * Dc] rows."""
    if comm.size == 1:
        return t
    nb, R, Dc = t.shape
    got = comm.gather(t.permute(1, 0, 2).reshape(R, nb * Dc), "rows")
    return got.reshape(-1, nb, Dc).permute(1, 0, 2)


class _BranchExchange(torch.autograd.Function):
    """The per-branch COO aggregate of a row shard's owned rows (the B + M
    GAT conv on COO, the module docstring): x_br [nb, R, Dc] its rows, vals
    [nb, E] the values of its edges (differentiable), t_vals [nb, Et] those
    of its batch columns' transposed edges (values only)."""

    @staticmethod
    def forward(ctx, x_br, vals, t_vals, edges, comm):
        ctx.edges, ctx.comm, ctx.t_vals = edges, comm, t_vals
        xf = _gather_branches(comm, x_br)
        ctx.save_for_backward(xf if ctx.needs_input_grad[1] else None)
        return _segment_matvec(edges.row, edges.col, vals, xf, edges.num_rows, edges.row_ptr,
                               edges.row_long_rows)

    @staticmethod
    def backward(ctx, g):
        e, comm = ctx.edges, ctx.comm
        (xf,) = ctx.saved_tensors
        dx = dval = None
        if ctx.needs_input_grad[0]:
            gf = _gather_branches(comm, g.contiguous())
            dx_b = _segment_matvec(e.t_row, e.t_col, ctx.t_vals, gf, e.b_rows, e.t_row_ptr,
                                   e.t_row_long_rows)
            dx = torch.cat([dx_b, dx_b.new_zeros((dx_b.shape[0], e.num_rows - e.b_rows,
                                                  dx_b.shape[2]))], 1)
        if ctx.needs_input_grad[1]:  # the owned rows' edges against the gathered rows
            dval = _coo_sddmm(e.row, e.col, g, xf)
        return dx, dval, None, None, None


class _LogitTable(torch.autograd.Function):
    """Every rank's rows of the [R, k] logits t, in the gathered order (one
    all-gather over the rows' ranks ``comm``).  The backward sums the
    cotangent of the whole table over ``sum_comm`` (the rows' ranks; on the
    2-D mesh every rank, whose model ranks each hold their columns' part of
    it) in one all-reduce and keeps the owned rows': gloo has no
    reduce-scatter, and [R, k] is a k / C-th of a row exchange.  The link
    step gathers its output rows the same way, under ``category`` 'link'."""

    @staticmethod
    def forward(ctx, t, comm, sum_comm, row0, category="logits"):
        ctx.sum_comm, ctx.own, ctx.category = sum_comm, (row0, t.shape[0]), category
        return comm.gather(t, category) if comm.size > 1 else t.clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_comm.size > 1:
            g = _all_reduce(ctx.sum_comm, g, ctx.category)
        r0, n = ctx.own
        return g[r0 : r0 + n], None, None, None, None


class _SumOverRanks(torch.autograd.Function):
    """Tensors summed over the ranks of ``comm`` (one all-reduce); the
    backward sums the cotangents over the same ranks."""

    @staticmethod
    def forward(ctx, comm, category, *tensors):
        ctx.comm, ctx.category = comm, category
        ctx.like = [torch.zeros_like(t) for t in tensors]
        return tuple(t.clone() for t in comm.sum([t.detach() for t in tensors], category))

    @staticmethod
    def backward(ctx, *grads):
        grads = [z if g is None else g for g, z in zip(grads, ctx.like)]
        return (None, None) + tuple(ctx.comm.sum(grads, ctx.category))


def _all_reduce(comm: _Collectives, t: torch.Tensor, category: str) -> torch.Tensor:
    """A copy of ``t`` summed over the ranks of ``comm``."""
    out = t.contiguous().clone()
    comm.ledger.add(category, "all_reduce", out, [out.shape])
    dist.all_reduce(out, group=comm.group)
    return out


def _moments_reduce(comm: _Collectives):
    """``masked_moments``'s differentiable ``stats_reduce`` over ``comm``."""

    def reduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        return list(_SumOverRanks.apply(comm, "stats", *tensors))

    return reduce


class _CopyToModel(torch.autograd.Function):
    """Megatron-LM's "f": identity forward, the gradient summed over the
    model group."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.comm, g, "partials"), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron-LM's "g": the partial products summed over the model group,
    identity backward."""

    @staticmethod
    def forward(ctx, partial, comm):
        return _all_reduce(comm, partial, "partials")

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class _ModelAxis:
    """``model_forward``'s ``model_axis`` on the 2-D mesh: each layer's
    columns of this rank's branches, and the fan-in partial sum."""

    comm: _Collectives
    m: int
    n: int

    def split(self, x):
        w = x.shape[1] // self.n
        if self.n > 1 and x.requires_grad:
            x = _CopyToModel.apply(x, self.comm)
        return x[:, self.m * w : (self.m + 1) * w]

    def reduce(self, partial):
        return _ReduceFromModel.apply(partial, self.comm) if self.n > 1 else partial

    def att(self, att_l, att_r):
        """This rank's columns of the replicated GAT attention vectors, each
        with its bias att[C]; the columns pass "f", so that each rank's
        gradient (of its own columns) is summed into the whole one."""
        C = att_l.shape[0] - 1
        w = C // self.n
        cols = torch.stack([att_l[:C], att_r[:C]])
        if self.n > 1 and cols.requires_grad:
            cols = _CopyToModel.apply(cols, self.comm)
        cols = cols[:, self.m * w : (self.m + 1) * w]
        return torch.cat([cols[0], att_l[C:]]), torch.cat([cols[1], att_r[C:]])


class _ScaleRanks:
    """The rows' ranks, as ``ops/gat.py:explosion_scale``, ``branch_scale``
    and ``nn/model.py:transformer_branch`` take them: ``max`` and ``sum``
    copies reduced over them, ``psum`` a differentiable sum (its backward
    sums the cotangent); each under ``category``."""

    def __init__(self, comm: _Collectives, category: str = "scalars"):
        self.comm, self.category = comm, category

    def max(self, t):
        return self.comm.max(t, self.category)

    def sum(self, t):
        return self.comm.sum([t], self.category)[0]

    def psum(self, t):
        return _SumOverRanks.apply(self.comm, self.category, t)[0]


def _gat_conv(edges, comm: _Collectives, axis, comm_all: _Collectives):
    """``ShardEdges.gat`` of a row shard over ``comm`` (the rows' ranks) and,
    on the 2-D mesh, ``axis`` (``comm_all`` every rank): (x_own, xf, att_l,
    att_r, valid) -> the GAT conv's (agg, rowsum) of the owned rows (the
    module docstring)."""
    many = comm.size > 1
    ranks = _ScaleRanks(comm) if many else None
    coo = not edges.mixed and edges.ell_row is None  # the layer's COO fallback
    gather = (lambda t: comm.gather(t, "rows")) if many else None
    model_sum = None if axis is None else (lambda t: _all_reduce(axis.comm, t, "partials"))

    def table(t):
        return _LogitTable.apply(t, comm, comm_all, edges.row0)

    def aggregate(x1, ev, ev_t):
        return _RowExchange.apply(x1, ev, ev_t, edges, comm)

    def conv(x, xf, att_l, att_r, valid):
        reduce = None
        if axis is not None:
            att_l, att_r = axis.att(att_l, att_r)
            reduce = axis.reduce
        if coo:
            return gat_conv_coo(edges, x, xf, att_l, att_r, valid, ranks, reduce, table,
                                aggregate)
        al, ar = node_logits(x, xf, att_l, att_r, reduce=reduce)
        scale = explosion_scale(al, ar, valid, ranks)
        # where the rows have one rank the owned rows are the conv's table:
        # their logits are not formed again (ar; the single-K conv's al only
        # where it is this one, in f32: under 16-bit x its att is not rounded)
        known = {} if many else dict(ar=ar.detach(), al=None if (
            x.dtype != torch.float32 or edges.mixed) else al.detach())
        return gat_conv_sharded(edges, x, att_l, att_r, scale, xf.detach(), gather, model_sum,
                                **known)

    return conv


def _gat_mh_conv(edges, comm: _Collectives):
    """``ShardEdges.gat_mh`` of a row shard over ``comm`` (the rows' ranks;
    on the 2-D mesh the data group): on the slot-ELL (x_own, al, ar) -> the
    B + M GAT conv's (agg, rowsum) of the owned rows
    (``ops/gat.py:gat_conv_mh_sharded``, its exchanges under ``rows``); on
    COO (x_br [nb, R, D + 1], al, ar [nb, R] scaled) -> the owned rows'
    [nb, R, D + 1] aggregate (the module docstring)."""
    if edges.ell_row is None:
        def coo(x_br, al, ar):
            nb = al.shape[0]
            tab = _LogitTable.apply(torch.cat([al, ar]).t(), comm, comm, edges.row0).t()
            al_t, ar_t = tab[:nb], tab[nb:]
            e = edges
            ev = gat_edge_values(e.row + e.row0, e.col, e.val, al_t, ar_t)
            with torch.no_grad():  # source = the owned column, destination = the gathered row
                ev_t = gat_edge_values(e.t_col, e.t_row + e.row0, e.t_val, al_t, ar_t)
            return _BranchExchange.apply(x_br, ev, ev_t, edges, comm)

        return coo
    gather = (lambda t: comm.gather(t, "rows")) if comm.size > 1 else None
    return lambda x, al, ar: gat_conv_mh_sharded(edges, x, al, ar, gather)


def _local_ms(ms: ModelStatic, n_model: int) -> ModelStatic:
    """The model as one model rank holds it: nb / n_model branches a layer
    (the probes, the VQ update and the lookups read ``channels[:-1]``)."""
    return dataclasses.replace(
        ms, channels=tuple(c // n_model for c in ms.channels[:-1]) + (ms.channels[-1],))


def _make_step(ms: ModelStatic, cfg: Config, data: DataMesh, model_group=None, m=0,
               n_model=1, world_group=None, link=False, multilabel=False):
    """The sharded step of both meshes (the module docstring): ``data`` the
    rows' ranks; on the 2-D mesh ``model_group`` the model group, m and
    n_model this rank's coordinate, ``world_group`` every rank (for the
    reported scalars).  The node step (CE, or BCE with ``multilabel``), or
    with ``link`` the link step."""
    if link:
        check_link_config(ms, cfg)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    ledger = CollectiveLedger()  # every collective of the step
    comm = _Collectives(data.group, ledger)
    comm_all = comm if n_model == 1 else _Collectives(world_group, ledger)
    axis = None if n_model == 1 else _ModelAxis(_Collectives(model_group, ledger), m, n_model)
    ms_l = _local_ms(ms, n_model)
    live = cfg.vq_update_mode == "live"
    mask_gens = {}  # per device: the dropbranch draws, alike on every rank
    moments = _moments_reduce(comm)
    first_m = float(m == 0)  # the loss terms, replicated over a model group, from its rank 0

    def own(masks, shard: RowShard, by_rows: bool):
        """This rank's part of whole-batch masks: its rows (dropout) or its
        branches (dropbranch)."""
        if masks is None:
            return None
        if by_rows:
            return [t[shard.row0 : shard.row0 + shard.B_pad] for t in masks]
        return [t[m * (t.shape[0] // n_model) : (m + 1) * (t.shape[0] // n_model)]
                for t in masks]

    def forward(state, X_dev, shard: RowShard, warm_up_rate, generator, branch_masks,
                dropout_keeps):
        """``step_forward`` on this rank's shard with its exchanges bound;
        returns (the bound shard, this rank's dropbranch masks, the
        forward's outputs)."""
        dev = X_dev.device
        if shard.ranks != comm.size:
            raise ValueError(f"the shard is one of {shard.ranks}, the mesh has {comm.size} ranks")
        if branch_masks is None and ms.dropbranch > 0:
            if dev not in mask_gens:
                mask_gens[dev] = torch.Generator(device=dev).manual_seed(cfg.seed)
            branch_masks = draw_branch_masks(ms, mask_gens[dev], dev)
        if dropout_keeps is None and ms.dropout > 0:
            dropout_keeps = [torch.rand((shard.batch_B_pad, c), generator=generator, device=dev)
                             < 1.0 - ms.dropout for c in ms.channels[1:-1]]
        masks = own(branch_masks, shard, False)
        many = comm.size > 1
        batch = dataclasses.replace(shard, edges=dataclasses.replace(
            shard.edges, aggregate=lambda x: _RowExchange.apply(x, None, None, shard.edges, comm),
            gat=_gat_conv(shard.edges, comm, axis, comm_all), gat_mh=_gat_mh_conv(
                shard.edges, comm), scale_ranks=_ScaleRanks(comm) if many else None,
            tr_ranks=_ScaleRanks(comm, "transformer") if many else None))
        return batch, masks, step_forward(
            state, ms_l, X_dev, batch, warm_up_rate, generator, masks,
            own(dropout_keeps, shard, True), stats_reduce=moments, model_axis=axis)

    def vq_transition(state, batch: RowShard, masks, layer_inputs, g_probes, g_probes_tr):
        """The live VQ update from the moments and EMA statistics summed over
        the ranks, every rank's assignments merged (the module docstring)."""
        if live:
            merge = _cidx_merge(comm, batch.batch_idx_all, batch.merge_src, ms.vq.num_M <= 256)
            live_vq_update(state, ms_l, layer_inputs, g_probes, g_probes_tr, batch, masks,
                           stats_reduce=lambda ts: comm.sum(ts, "stats"), cidx_merge_fn=merge)

    def sharded_step(state: TrainState, X_dev: torch.Tensor, shard: RowShard, warm_up_rate, lr,
                     do_opt_step, generator=None, branch_masks=None, dropout_keeps=None):
        """One step of the whole batch on this rank's shard; updates ``state``
        in place and returns (state, metrics), the metrics of ``train_step``
        for the whole batch.  ``branch_masks`` ([nb] per layer) and
        ``dropout_keeps`` ([B_pad, C] per hidden layer) are the whole
        batch's; drawn, the dropbranch masks come from a generator seeded
        with ``cfg.seed`` on every rank, the dropout masks from ``generator``
        at the whole batch's shape (give every rank one seed)."""
        dev = X_dev.device
        batch, masks, (out, info_b, layer_inputs, new_bn, probes, probes_tr) = forward(
            state, X_dev, shard, warm_up_rate, generator, branch_masks, dropout_keeps)
        params = list(state.model.parameters())
        mask = batch.train_mask & batch.valid_B
        if multilabel:  # BCE over the rows and every label (JAX train/step.py:127-129)
            cls_sum, count = masked_bce_parts(out, batch.y, mask)
        else:
            cls_sum, count = masked_ce_parts(out, batch.y, mask)
        (count_all,) = comm.sum([count.detach()], "scalars")
        loss_cls = cls_sum / torch.clamp(count_all * out.shape[1] if multilabel else count_all,
                                         min=1.0)
        loss_r = loss_cls if cfg.ce_only else loss_cls + info_b
        grads = torch.autograd.grad(loss_r, params + probes + probes_tr)
        n_p, n_pr = len(params), len(probes)
        g_params = comm.sum(list(grads[:n_p]), "grad")
        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)
        state.bn_state = new_bn  # the whole batch's moments: alike on every rank
        vq_transition(state, batch, masks, layer_inputs, grads[n_p : n_p + n_pr],
                      grads[n_p + n_pr :])

        # the whole batch's metrics: the loss terms from each model group's rank
        # 0; every rank's recovery term; the fan-in columns' squared gradients
        # from data rank 0 (they are alike over the data group); the bad
        # codebooks of every rank
        first_d = float(data.rank == 0)
        hits = (torch.zeros((), device=dev) if multilabel else
                ((out.detach().argmax(-1) == batch.y) & mask).float().sum())
        sq = [(g * g).sum() for g in g_params]
        fan_in = sum(s for p, s in zip(params, sq) if p.dim() == 2)
        info = torch.as_tensor(info_b, device=dev).detach()
        bad = torch.stack([s.bad_init for s in state.vq_states + (state.vq_states_tr or [])]
                          ).any().float()
        cls_all, info_all, hits_all, fan_in_all, bad_all = comm_all.sum(
            [first_m * loss_cls.detach(), info, first_m * hits, first_d * fan_in, bad], "scalars")
        grad_sq = fan_in_all + sum(s for p, s in zip(params, sq) if p.dim() != 2)
        state.step += 1
        ledger.steps += 1
        return state, {
            "loss": cls_all if cfg.ce_only else cls_all + info_all, "loss_cls": cls_all,
            "train_acc": hits_all / torch.clamp(count_all, min=1.0),
            "info_backward": info_all, "grad_norm": torch.sqrt(grad_sq),
            "bad_init": bad_all > 0,
        }

    def clip(state, params, g_params):
        """The link step's per-layer clip (``train/link.py:clip_groups``) of
        the gradients summed over the data group, in place: on the 2-D mesh
        the squared norms of the tensors a model rank holds in part (the
        fan-in columns, B + M GAT's heads) summed over the model group in
        one all-reduce, the replicated ones counted once."""
        groups = clip_groups(state.model, params, ms, cfg.clip)
        split = [[(g_params[i] * g_params[i]).sum() for i in idx if params[i].dim() >= 2]
                 for idx, _ in groups]
        part = torch.stack([sum(s) if s else g_params[0].new_zeros(()) for s in split])
        if axis is not None:
            (part,) = axis.comm.sum([part], "scalars")
        for k, (idx, max_norm) in enumerate(groups):
            whole = sum((g_params[i] * g_params[i]).sum() for i in idx if params[i].dim() < 2)
            scale = clip_scale(part[k] + whole, max_norm)
            for i in idx:
                g_params[i] = g_params[i] * scale

    def sharded_link_step(state: TrainState, pred, pred_opt, X_dev: torch.Tensor,
                          shard: RowShard, warm_up_rate, lr, do_opt_step, generator=None,
                          dst_neg=None, pred_keep=None, branch_masks=None, dropout_keeps=None):
        """One link step of the whole batch on this rank's shard
        (``train/link.py:link_train_step``'s signature; the module
        docstring); updates ``state``, ``pred`` and ``pred_opt`` in place
        and returns the whole batch's metrics.  ``dst_neg`` [L_pad],
        ``pred_keep`` ([L_pad, hidden] per hidden predictor layer),
        ``branch_masks`` and ``dropout_keeps`` are the whole batch's; drawn,
        the negatives, then the predictor's masks, then the model's dropout
        masks come from ``generator`` at the whole batch's shapes (give
        every rank one seed), the dropbranch masks as the node step's."""
        dev = X_dev.device
        if shard.link_src is None:
            raise ValueError("the sharded link step needs a link batch (with_link_edges)")
        lb = shard.link_src.shape[0]  # this rank's pairs, L_pad / ranks
        if dst_neg is None:  # uniform over the whole batch's rows (main_link.py v2:66-69)
            dst_neg = torch.randint(0, max(shard.batch_num_B, 1), (lb * shard.ranks,),
                                    generator=generator, device=dev)
        if pred_keep is None:
            pred_keep = dropout_masks(pred, lb * shard.ranks, cfg.dropout, generator, dev)
        blk = slice(shard.rank * lb, (shard.rank + 1) * lb)
        batch, masks, (out, info_b, layer_inputs, new_bn, probes, _) = forward(
            state, X_dev, shard, warm_up_rate, generator, branch_masks, dropout_keeps)
        params, pparams = list(state.model.parameters()), list(pred.parameters())
        # every rank's output rows, the whole batch's [B_pad, C_out]; its
        # backward sums the whole table's cotangent and keeps this rank's rows
        table = _LogitTable.apply(out, comm, comm, shard.row0, "link")
        pos_sum, neg_sum, count = link_loss_parts(
            pred, table, batch.link_src, batch.link_dst, dst_neg[blk], batch.link_mask,
            None if pred_keep is None else [k[blk] for k in pred_keep], cfg.dropout)
        (count_all,) = comm.sum([count.detach()], "scalars")
        n = torch.clamp(count_all, min=1.0)
        loss_pre = pos_sum / n + neg_sum / n
        loss_r = loss_pre if cfg.ce_only else loss_pre + info_b
        grads = torch.autograd.grad(loss_r, params + pparams + probes)
        n_p, n_pp = len(params), len(pparams)
        g_all = comm.sum(list(grads[: n_p + n_pp]), "grad")
        g_params, g_pred = g_all[:n_p], g_all[n_p:]
        if cfg.clip is not None:
            clip(state, params, g_params)
        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)
        rmsprop_update(pred_opt, pparams, g_pred, lr, do_opt_step > 0)
        state.bn_state = new_bn
        # the layers' codebooks only: the JAX link step takes no gradient of
        # the transformer's probes and keeps its codebooks (train/link.py)
        vq_transition(state, batch, masks, layer_inputs, grads[n_p + n_pp :], None)

        info = torch.as_tensor(info_b, device=dev).detach()
        bad = torch.stack([s.bad_init for s in state.vq_states]).any().float()
        pre_all, info_all, bad_all = comm_all.sum([first_m * loss_pre.detach(), info, bad],
                                                  "scalars")
        state.step += 1
        ledger.steps += 1
        return {"loss": pre_all if cfg.ce_only else pre_all + info_all, "loss_pre": pre_all,
                "bad_init": bad_all > 0}

    step = sharded_link_step if link else sharded_step
    step.ledger = ledger
    return step


def _on_1d(cfg: Config, mesh: DataMesh) -> dict:
    """``_make_step``'s mesh arguments on the 1-D mesh."""
    if cfg.mesh_data and cfg.mesh_data != mesh.size:
        raise ValueError(f"mesh_data={cfg.mesh_data}, but the mesh has {mesh.size} ranks")
    return dict(data=mesh)


def _on_2d(ms: ModelStatic, mesh: Mesh2D) -> dict:
    """``_make_step``'s mesh arguments on the 2-D mesh."""
    for l, nb in enumerate(ms.num_branches):
        if nb % mesh.n_model:
            raise ValueError(f"layer {l} has {nb} branches, which do not divide by "
                             f"n_model={mesh.n_model}")
    return dict(data=mesh.data, model_group=mesh.model_group, m=mesh.model_rank,
                n_model=mesh.n_model, world_group=mesh.group)


def make_sharded_step(ms: ModelStatic, cfg: Config, mesh: DataMesh, multilabel: bool = False):
    """The 1-D sharded step over ``mesh`` (the module docstring): called with
    the state, the feature table and this rank's ``shard_train_inputs``
    shard; with ``multilabel`` BCE over [B, C] float targets, as
    ``train/step.py:make_step_fns``.  The ledger is ``step.ledger``."""
    return _make_step(ms, cfg, multilabel=multilabel, **_on_1d(cfg, mesh))


def make_sharded_step_2d(ms: ModelStatic, cfg: Config, mesh: Mesh2D, multilabel: bool = False):
    """The 2-D sharded step over ``mesh`` (the module docstring): called with
    this model rank's state and this data rank's shard, both from
    ``shard_train_inputs_2d``."""
    return _make_step(ms, cfg, multilabel=multilabel, **_on_2d(ms, mesh))


def make_sharded_link_step(ms: ModelStatic, cfg: Config, mesh: DataMesh):
    """The 1-D sharded link step over ``mesh`` (the module docstring):
    ``train/link.py:link_train_step``'s signature, with this rank's
    ``shard_train_inputs`` shard of a link batch for the batch."""
    return _make_step(ms, cfg, link=True, **_on_1d(cfg, mesh))


def make_sharded_link_step_2d(ms: ModelStatic, cfg: Config, mesh: Mesh2D):
    """The 2-D sharded link step over ``mesh``: this model rank's state and
    this data rank's shard, both from ``shard_train_inputs_2d``; the
    predictor replicated."""
    return _make_step(ms, cfg, link=True, **_on_2d(ms, mesh))
