"""Process groups, and one batch sharded over them (port of
``vq_gnn_tpu/parallel/mesh.py``).

JAX lays one program over a mesh of devices and XLA inserts the
collectives.  The port runs one process per rank: a mesh is a
``torch.distributed`` group (or, on the 2-D mesh, two) and the device this
process drives, and the collectives are written out
(``parallel/sharded.py``).

- ``make_mesh``: the 1-D ``('data',)`` mesh, the whole group.
- ``make_mesh_2d(n_data, n_model)``: ``('data', 'model')``, rank = d *
  n_model + m as the JAX reshape (``vq_gnn_tpu/parallel/mesh.py:47``); the
  *data group* holds the ranks of one model coordinate, the *model group*
  those of one data coordinate.
- ``shard_train_inputs(mesh, state, X_dev, batch)``: this rank's
  :class:`RowShard` of a batch that every rank built alike from one seed (as
  the JAX host builds it before ``device_put``), no batch broadcast.  Rank r
  of n keeps the contiguous block r of the B_pad batch rows and of the
  Bp_pad boundary rows (``batch_idx``, ``fo_ids``, ``valid_*``, ``y``,
  ``train_mask``) and the adjacency of its rows as :class:`ShardEdges`, in
  the batch's layout: the slots (single-K, or each mixed-K family) or COO
  edges of the rows it owns (batch and boundary rows: the boundary rows'
  aggregate feeds the recovery term), and the transposed slots or edges of
  the batch columns it owns (the only columns whose dx has a consumer,
  ``ops/spmm.py:Edges.b_rows``) or, in a slot-ELL GAT batch (one that
  carries the whole transposed layout's lists, ``Edges.t_all_ptr`` or
  ``t_head_all_ptr``), of every column it owns, batch and boundary (the B'
  rows carry logits, whose d_al that backward sums over the transposed
  slots, ``ops/gat.py``), each renumbered from row 0 with its own row
  offsets and long rows (``ops/spmm.py:sub_ell_host``, ``lists_host``).  A
  mixed head family is cut by its global rows (``head_rowg``) and its
  compact rows re-ranked over the shard's rows, with a ``head_inv`` of the
  shard's own; COO edges are cut as one-wide slots, the transposed ones in
  ``tperm``'s order (the COO GAT conv's logit gradients come back through
  its table of logits instead, ``parallel/sharded.py``).  Columns are
  renumbered into the order of the all-gather of every rank's rows
  (``ops/spmm.py:gathered_order``), so the kernels read the gathered rows
  where they land.  The state and the feature table stay replicated.
- ``shard_train_inputs_2d``: the data split above over the data group, then
  the model split of ``_shard_vq_state_model`` / ``place_params``
  (``vq_gnn_tpu/parallel/mesh.py:55-111``): model rank m keeps branches [m
  nb / n_model, (m + 1) nb / n_model) of every ``VQState`` leaf, the
  transformer's codebooks (``vq_states_tr``) as the layers' (the
  ``c_indices`` columns: the table is node-major), the fan-in columns of
  ``gnn_transform``, ``linear_skip``, ``fc_sage``, ``transformer_v`` and
  ``transformer_res`` (``nn.Linear`` keeps [out, in]; JAX's ``w`` [in,
  out] is sharded on its rows) that take those branches, the rows of those
  branches of the B + M GAT's per-branch ``att_l`` / ``att_r`` [nb, D + 1]
  (``mesh.py:92``) and of the transformer's per-branch ``transformer_k``
  (``w`` [nb, D, D], ``b`` [nb, D]; JAX replicates it, and each branch
  reads its own slice, so the rank's gradient of its rows is whole), and
  the same part of their RMSprop ``nu``; the biases, the BN statistics and
  the step stay replicated.

A B + M batch (``formulation='bm'``) also carries the recovery term's
reverse list, a sum over cells (codeword, batch row) whose every entry
belongs to its batch row and whose column is a global node id that indexes
``c_indices`` (replicated, or split over the model ranks by branch): rank r
keeps the entries of its own batch rows, no exchange.  Beside a slot-ELL
adjacency the rev-ELL slots of its rows (``sub_ell_host``, rows from 0, the
global columns kept) with their row offsets and long rows over its b rows
(``ops/rev_ell.py:rev_long_rows_host``), or, where none of its rows has a
cell, the empty list's pad slot (row b, the shard's sentinel, as
``build_rev_ell`` gives the whole batch's; its cells at the batch's
largest column, the dustbin N wherever the batch pads a cell); beside COO
the raw list's entries of its rows, rows from 0 (the padding, row 0, stays
with rank 0: value 0).

A link batch's in-batch pairs (``link_src``, ``link_dst``, ``link_mask``,
[L_pad]) are cut into n blocks of L_pad / n, as the JAX package places
them over 'data' (``vq_gnn_tpu/parallel/mesh.py:157-159``): rank r keeps
block r, its endpoints still the whole batch's row indices (the link step
gathers every rank's output rows, ``parallel/sharded.py``).  A multilabel
batch's targets [B_pad, C] are cut by rows as single labels are.

Both raise a ValueError that names the padding when B_pad, Bp_pad or L_pad
does not divide by the ranks of the rows.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vq_gnn_tpu_torch.config import resolve_device
from vq_gnn_tpu_torch.nn.vq import VQState
from vq_gnn_tpu_torch.ops.rev_ell import rev_long_rows_host
from vq_gnn_tpu_torch.ops.spmm import Edges, gathered_order, lists_host, sub_ell_host
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch
from vq_gnn_tpu_torch.train.optim import make_rmsprop
from vq_gnn_tpu_torch.train.state import TrainState

# the linears whose fan-in the 2-D mesh splits over 'model' (the JAX
# package's place_params, vq_gnn_tpu/parallel/mesh.py:87)
FAN_IN_LINEARS = ("gnn_transform", "linear_skip", "fc_sage", "transformer_v", "transformer_res")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    group: Optional[object]  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The ``('data', 'model')`` mesh seen from one rank: the whole group,
    the data group (the ranks of this model coordinate) and the model group
    (the ranks of this data coordinate), its coordinates and its device."""

    group: Optional[object]
    data_group: object
    model_group: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    rank: int
    device: torch.device

    @property
    def data(self) -> DataMesh:
        """The data axis as a 1-D mesh: the rows' ranks."""
        return DataMesh(self.data_group, self.data_rank, self.n_data, self.device)


def _device_of(rank: int, device) -> torch.device:
    """``cuda:<local rank>`` unless ``device`` says otherwise, the local rank
    from ``LOCAL_RANK`` where a launcher sets it, else the rank modulo the
    GPUs of this host."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)
        device = f"cuda:{local}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device


def make_mesh(n_ranks: int = 0, group=None,
              device: Union[str, torch.device, None] = None) -> DataMesh:
    """The group (``init_distributed`` first) and this rank's device
    (:func:`_device_of`).  ``n_ranks > 0`` must equal the group's size (0 =
    every rank, as ``Config.mesh_data``)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_ranks > 0 and n_ranks != size:
        raise RuntimeError(f"need {n_ranks} ranks, the process group has {size}")
    return DataMesh(group=group, rank=rank, size=size, device=_device_of(rank, device))


def make_mesh_2d(n_data: int, n_model: int,
                 device: Union[str, torch.device, None] = None) -> Mesh2D:
    """The 2-D mesh over every rank of the default group, n_data * n_model
    of them, rank = d * n_model + m.  Every rank makes every subgroup, in
    one order (``dist.new_group`` is collective), and keeps its own two."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != size:
        raise RuntimeError(f"need {n_data} x {n_model} = {n_data * n_model} ranks, the "
                           f"process group has {size}")
    d, m = divmod(rank, n_model)
    data_groups = [dist.new_group([i * n_model + j for i in range(n_data)])
                   for j in range(n_model)]
    model_groups = [dist.new_group([i * n_model + j for j in range(n_model)])
                    for i in range(n_data)]
    return Mesh2D(group=None, data_group=data_groups[m], model_group=model_groups[d],
                  n_data=n_data, n_model=n_model, data_rank=d, model_rank=m, rank=rank,
                  device=_device_of(rank, device))


@dataclasses.dataclass
class ShardEdges(Edges):
    """The adjacency of one row shard (see the module docstring), in its
    batch's layout: the forward slots (single-K, or each mixed family) or
    COO edges of the ``num_rows`` rows it owns (its ``b_rows`` batch rows,
    then its boundary rows) and the transposed slots or edges of its
    ``b_rows`` batch columns (in a slot-ELL GAT batch, of all ``num_rows``
    owned columns, with the lists under ``t_all_ptr`` or ``t_*_all_ptr`` as
    well), rows from 0, columns in the gathered order, where the owned rows
    start at ``row0``, each with the kernels' row offsets and long rows.  A
    mixed head family keeps its compact rows, re-ranked over the shard's
    rows, and its own ``head_inv`` (the sentinel: the shard's row count).
    COO keeps its transposed edges apart (``t_row``, the owned column, then
    ``t_col`` and ``t_val``, sorted by column) in place of ``tperm``.  The
    sharded step binds it to its groups (``aggregate``, which
    ``ops/spmm.py:spmm`` calls, ``gat`` and ``gat_mh``, which
    ``nn/model.py``'s GAT layers call, ``scale_ranks``, the B + M GAT
    layer's, and ``tr_ranks``, the transformer branch's)."""

    t_row: object = None
    t_col: object = None
    t_val: object = None
    row0: int = 0  # the first owned row in the gathered order
    aggregate: object = None  # x_own -> the owned rows' aggregate (parallel/sharded.py)
    # (x_own, xf, att_l, att_r, valid) -> the GAT conv's (agg, rowsum) of the owned rows
    gat: object = None
    # the B + M GAT conv of the owned rows: on the slot-ELL (x_own, al, ar)
    # -> (agg, rowsum), on COO (x_br, al, ar) -> the [nb, R, D + 1] aggregate
    gat_mh: object = None
    # the rows' ranks of the B + M GAT's per-branch Trick-1 max
    # (ops/gat.py:branch_scale) and of the transformer branch's c_max and
    # out_M normaliser (nn/model.py:transformer_branch); None where the rows
    # have one rank
    scale_ranks: object = None
    tr_ranks: object = None


@dataclasses.dataclass
class RowShard(PaddedBatch):
    """This rank's block of a batch (a :class:`PaddedBatch` of its own rows,
    B_pad = the batch's B_pad / ranks, ``edges`` a :class:`ShardEdges`, the
    B + M reverse list cut to its batch rows, a link batch's pairs to its
    block of L_pad / ranks), with where the block lies, the whole batch's
    B_pad and valid rows and what the ``c_indices`` merge reads: every rank's batch ids
    (the whole ``batch_idx``) and, for each, the last position of its node
    among them."""

    rank: int = 0
    ranks: int = 1
    batch_B_pad: int = 0  # the whole batch's B_pad
    batch_num_B: int = 0  # the whole batch's valid rows (the link negatives' range)
    batch_idx_all: object = None  # [batch_B_pad]
    merge_src: object = None  # [batch_B_pad]

    @property
    def row0(self) -> int:
        """The first batch row of this block."""
        return self.rank * self.B_pad

    def to(self, device) -> "RowShard":
        base = PaddedBatch.to(self, device)
        return RowShard(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(PaddedBatch)},
            rank=self.rank, ranks=self.ranks, batch_B_pad=self.batch_B_pad,
            batch_num_B=self.batch_num_B,
            batch_idx_all=torch.as_tensor(self.batch_idx_all).to(device, torch.int64),
            merge_src=torch.as_tensor(self.merge_src).to(device, torch.int64))


def _host(a):
    """A host numpy array of a batch field (numpy, or a tensor on any device)."""
    if a is None or isinstance(a, np.ndarray):
        return a
    return a.detach().cpu().numpy()


def _sub_families(rowg, col, val, tail_row, tail_col, tail_val, R: int, blocks, cols,
                  pre: str = "") -> dict:
    """One direction of a mixed-K layout (``pre`` '' or 't_') cut to the rows
    in ``blocks`` (``sub_ell_host``): the head's slots taken by their global
    rows, re-ranked into compact rows over the cut's rows with its own inv
    (the sentinel: the cut's row count), and the tail's slots; each family
    with its lists, its columns through ``cols``."""
    nr = sum(r1 - r0 for r0, r1 in blocks)
    hg, hc, hv, _, _ = sub_ell_host(rowg, col, val, R, blocks)
    inv = np.full(nr, nr, np.int32)
    kept = np.unique(hg)
    inv[kept] = np.arange(len(kept))
    rowc = inv[hg]
    ptr, long_rows = lists_host(rowc, nr)
    tr, tc, tv, tptr, tlong = sub_ell_host(tail_row, tail_col, tail_val, R, blocks)
    out = dict(head_rowc=rowc, head_col=cols(hc), head_val=hv, head_inv=inv, head_rowg=hg,
               head_ptr=ptr, head_long_rows=long_rows, tail_row=tr, tail_col=cols(tc),
               tail_val=tv, tail_ptr=tptr, tail_long_rows=tlong)
    return {pre + k: v for k, v in out.items()}


def _shard_edges(e, R: int, own, own_B, gat: bool, cols) -> dict:
    """The :class:`ShardEdges` fields of the owned rows ``own`` (row ranges)
    of the batch's edges ``e`` (the module docstring)."""
    t_own = own if gat else [own_B]
    if e.mixed:
        f = _sub_families(*(_host(getattr(e, k)) for k in (
            "head_rowg", "head_col", "head_val", "tail_row", "tail_col", "tail_val")),
            R, own, cols)
        f.update(_sub_families(*(_host(getattr(e, k)) for k in (
            "t_head_rowg", "t_head_col", "t_head_val", "t_tail_row", "t_tail_col",
            "t_tail_val")), R, t_own, cols, "t_"))
        if gat:  # the GAT backward walks the whole transposed families
            for fam in ("head", "tail"):
                f[f"t_{fam}_all_ptr"] = f[f"t_{fam}_ptr"]
                f[f"t_{fam}_all_long_rows"] = f[f"t_{fam}_long_rows"]
        return f
    if e.ell_row is None:  # COO: the edges as one-wide slots
        row, col, val, perm = (_host(getattr(e, k)) for k in ("row", "col", "val", "tperm"))
        r, c, v, ptr, long_rows = sub_ell_host(row, col[:, None], val[:, None], R, own)
        tr, tc, tv, tptr, tlong = sub_ell_host(col[perm], row[perm][:, None],
                                               val[perm][:, None], R, t_own)
        return dict(row=r, col=cols(c[:, 0]), val=v[:, 0], row_ptr=ptr,
                    row_long_rows=long_rows, t_row=tr, t_col=cols(tc[:, 0]), t_val=tv[:, 0],
                    t_row_ptr=tptr, t_row_long_rows=tlong)
    f = {}
    for pre, blocks in (("", own), ("t_", t_own)):
        row, col, val, ptr, long_rows = sub_ell_host(
            *(_host(getattr(e, f"{pre}ell_{k}")) for k in ("row", "col", "val")), R, blocks)
        f.update({f"{pre}ell_row": row, f"{pre}ell_col": cols(col), f"{pre}ell_val": val,
                  f"{pre}ell_ptr": ptr, f"{pre}ell_long_rows": long_rows})
    if gat:
        f["t_all_ptr"], f["t_all_long_rows"] = f["t_ell_ptr"], f["t_ell_long_rows"]
    return f


def _shard_rev(batch: PaddedBatch, r: int, b: int) -> dict:
    """The B + M reverse list of block r's b batch rows, as the module
    docstring says: rev-ELL slots with their lists, or the raw entries."""
    lo, hi = r * b, (r + 1) * b
    if batch.rev_slot_row is not None:
        col = _host(batch.rev_slot_col)
        row, col_r, val, ptr, _ = sub_ell_host(_host(batch.rev_slot_row), col,
                                               _host(batch.rev_slot_val), batch.B_pad, [(lo, hi)])
        if not len(row):  # the empty list's pad slot
            K = col.shape[1]
            row = np.array([b], np.int32)
            col_r, val = np.full((1, K), col.max(), np.int32), np.zeros((1, K), np.float32)
        return dict(rev_slot_row=row, rev_slot_col=col_r, rev_slot_val=val, rev_row_ptr=ptr,
                    rev_long_rows=rev_long_rows_host(ptr))
    if batch.bm_rev_row is not None:
        row = _host(batch.bm_rev_row).astype(np.int64)
        keep = (row >= lo) & (row < hi)
        return dict(bm_rev_row=row[keep] - lo, bm_rev_col=_host(batch.bm_rev_col)[keep],
                    bm_rev_val=_host(batch.bm_rev_val)[keep])
    return {}


def _row_shard(batch: PaddedBatch, r: int, n: int, device) -> RowShard:
    """Block r of n of ``batch`` (a host batch or one on a device), on
    ``device``."""
    e = batch.edges
    y = _host(batch.y)
    B_pad, Bp_pad = batch.B_pad, batch.Bp_pad
    if B_pad % n or Bp_pad % n:
        raise ValueError(
            f"a batch sharded over {n} ranks needs B_pad and Bp_pad that divide by {n}, the "
            f"batch has B_pad={B_pad}, Bp_pad={Bp_pad}: set Config.fixed_B_pad and "
            f"fixed_Bp_pad (or pad_multiple_nodes) to multiples of {n}")
    L_pad = 0 if batch.link_src is None else len(batch.link_src)
    if L_pad % n:
        raise ValueError(
            f"a link batch sharded over {n} ranks needs L_pad that divides by {n}, the batch "
            f"has L_pad={L_pad}: pass build_padded_batch an L_pad that is a multiple of {n} (by "
            f"default it rounds the pairs up to a multiple of 1,024)")
    b, bp, lb = B_pad // n, Bp_pad // n, L_pad // n
    own_B, own_fo = (r * b, (r + 1) * b), (B_pad + r * bp, B_pad + (r + 1) * bp)
    # a slot-ELL GAT batch (one that carries the whole transposed layout's
    # lists): d_al of every owned column
    gat = e.t_all_ptr is not None or e.t_head_all_ptr is not None
    edges = ShardEdges(
        **_shard_edges(e, B_pad + Bp_pad, [own_B, own_fo], own_B, gat,
                       lambda c: gathered_order(c, B_pad, Bp_pad, n)),
        num_rows=b + bp, dense_rows=True, b_rows=b, row0=r * (b + bp))
    ids = _host(batch.batch_idx).astype(np.int64)
    last = np.full(int(ids.max()) + 1, -1, np.int64)
    np.maximum.at(last, ids, np.arange(len(ids)))

    def rows_of(a, lo, k):
        a = _host(a)
        return None if a is None else a[lo : lo + k]

    valid_B = rows_of(batch.valid_B, r * b, b)
    shard = RowShard(
        batch_idx=ids[r * b : (r + 1) * b], fo_ids=rows_of(batch.fo_ids, r * bp, bp),
        valid_B=valid_B, valid_fo=rows_of(batch.valid_fo, r * bp, bp), edges=edges,
        num_B=int(valid_B.sum()), y=rows_of(y, r * b, b),
        train_mask=rows_of(batch.train_mask, r * b, b), **_shard_rev(batch, r, b),
        link_src=rows_of(batch.link_src, r * lb, lb), link_dst=rows_of(batch.link_dst, r * lb, lb),
        link_mask=rows_of(batch.link_mask, r * lb, lb), rank=r, ranks=n, batch_B_pad=B_pad,
        batch_num_B=int(batch.num_B), batch_idx_all=ids, merge_src=last[ids])
    return shard.to(device)


def shard_train_inputs(mesh: DataMesh, state: TrainState, X_dev: torch.Tensor,
                       batch: PaddedBatch):
    """(state, X_dev, this rank's :class:`RowShard` of ``batch``): rows and
    edges sharded, the state and the feature table replicated, as they are."""
    return state, X_dev, _row_shard(batch, mesh.rank, mesh.size, mesh.device)


def _shard_vq_state_model(vq_state: VQState, m: int, n_model: int) -> VQState:
    """Model rank m's branches of a VQState: the leading branch axis of every
    leaf, axis 1 of the node-major ``c_indices``; scalars replicated."""

    def part(a, axis):
        if a.dim() == 0:
            return a.clone()
        w = a.shape[axis] // n_model
        return a.narrow(axis, m * w, w).contiguous()

    return VQState(**{f.name: part(getattr(vq_state, f.name), 1 if f.name == "c_indices" else 0)
                      for f in dataclasses.fields(VQState)})


def _shard_params(state: TrainState, m: int, n_model: int):
    """(model, optimizer) of model rank m: a copy of the model whose fan-in
    linears keep the input columns of this rank's branches and whose B + M
    GAT heads and transformer ``transformer_k`` keep those branches' rows,
    and an RMSprop over it holding the same part of each square average."""
    model = copy.deepcopy(state.model)
    old = list(state.model.parameters())
    for layer in model.layers:
        for name in FAN_IN_LINEARS:
            if hasattr(layer, name):
                lin = getattr(layer, name)
                w = lin.in_features // n_model
                lin.weight = nn.Parameter(lin.weight.detach()[:, m * w : (m + 1) * w].clone())
                lin.in_features = w
        heads = [(layer, name) for name in ("att_l", "att_r")
                 if getattr(layer, name, None) is not None and getattr(layer, name).dim() == 2]
        if hasattr(layer, "transformer_k"):
            heads += [(layer.transformer_k, "w"), (layer.transformer_k, "b")]
        for mod, name in heads:  # [nb, ...]: a branch's rows
            p = getattr(mod, name)
            w = p.shape[0] // n_model
            setattr(mod, name, nn.Parameter(p.detach()[m * w : (m + 1) * w].clone()))
    opt = make_rmsprop(model.parameters(), state.optimizer.defaults["lr"])
    for p_old, p in zip(old, model.parameters()):
        st = state.optimizer.state.get(p_old, {})
        if "square_avg" in st:
            nu = st["square_avg"]
            if nu.shape[0] != p.shape[0]:  # a branch's head: the same rows
                w = p.shape[0]
                nu = nu[m * w : (m + 1) * w]
            elif nu.shape != p.shape:  # a fan-in weight: the same columns
                w = p.shape[1]
                nu = nu[:, m * w : (m + 1) * w]
            opt.state[p] = {"step": st["step"].clone(), "square_avg": nu.clone()}
    return model, opt


def shard_train_inputs_2d(mesh: Mesh2D, state: TrainState, X_dev: torch.Tensor,
                          batch: PaddedBatch):
    """(this model rank's state, X_dev, this data rank's :class:`RowShard`):
    see the module docstring.  Every layer's branch count must divide by
    n_model."""
    m, n_model = mesh.model_rank, mesh.n_model
    for l, s in enumerate(state.vq_states):
        if s.embedding.shape[0] % n_model:
            raise ValueError(f"layer {l} has {s.embedding.shape[0]} branches, which do not "
                             f"divide by n_model={n_model}")
    model, opt = _shard_params(state, m, n_model)
    state_m = TrainState(
        model=model, vq_states=[_shard_vq_state_model(s, m, n_model) for s in state.vq_states],
        bn_state=copy.deepcopy(state.bn_state), optimizer=opt, step=state.step,
        vq_states_tr=None if state.vq_states_tr is None else [
            _shard_vq_state_model(s, m, n_model) for s in state.vq_states_tr])
    return state_m, X_dev, _row_shard(batch, mesh.data_rank, mesh.n_data, mesh.device)
