"""Static-shape padded mini-batches (port of ``vq_gnn_tpu/sampler/batch.py``).

Every batch is padded to bucketed sizes: batch nodes to ``B_pad``, 1-hop
boundary nodes to ``Bp_pad``, slots to ``S_pad``/``St_pad``.  Bucketed shapes
keep the allocator's reuse high and the kernels' launch shapes few.

- padded node slots carry the **dustbin id N** (features row N is zero, VQ
  scatters land in the dustbin row of ``c_indices``);
- padding ELL slots carry ``row = col = num_rows``, ``val = 0``;
- ``valid_B`` / ``valid_fo`` gate all batch statistics.

Local numbering: batch nodes occupy [0, B_pad), boundary (B') nodes
[B_pad, B_pad + Bp_pad) (the reference's ``subset = [B || B']``,
``dataloader.py v2:119-128``).

The host builder stays numpy; :meth:`PaddedBatch.to` moves a batch to a
device as tensors.  The adjacency comes in one of the three layouts of
``ops/spmm.py``: single-K slot-ELL (the default), mixed-K slot-ELL
(``ell_Kt > 0``) or COO (``spmm_backend='coo'``, edges padded to ``E_pad``
with ``row = col = num_rows``, ``val = 0``), each with the row offsets and
long rows its kernels read.  B + M (v1) training batches of non-GCN convs
also carry the recovery term's reverse list: in the rev-ELL layout
(``ops/rev_ell.py``) beside an ELL adjacency, as the raw padded list
(``bm_rev_row/col/val``) beside a COO one.  Link-prediction batches carry
their in-batch positive edges (``link_src``/``link_dst``/``link_mask``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vq_gnn_tpu_torch.ops.rev_ell import (
    REV_S_MULTIPLE,
    build_rev_ell,
    pad_rev_ell,
    rev_long_rows_host,
)
from vq_gnn_tpu_torch.ops.spmm import (
    Edges,
    build_ell_host,
    build_mixed_ell_host,
    coo_edges,
    ell_positions,
    lists_host,
    long_rows_host,
    mixed_truncated,
    row_offsets_host,
)


def _as_tensor(a, device, dtype=None):
    if a is None:
        return None
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass
class PaddedBatch:
    batch_idx: object  # [B_pad] global node ids (pad -> N)
    fo_ids: object  # [Bp_pad] global 1-hop boundary ids (pad -> N)
    valid_B: object  # [B_pad] bool
    valid_fo: object  # [Bp_pad] bool
    edges: Edges  # local numbering, num_rows = B_pad + Bp_pad
    num_B: int  # actual batch size
    y: object = None  # [B_pad] int labels or [B_pad, C] float
    train_mask: object = None  # [B_pad] bool
    # B + M non-GCN recovery: the reverse list as rev-ELL slots (pad slots:
    # row B_pad, col N, value 0); None where the batch has no reverse list
    rev_slot_col: object = None  # [S_rev, K] int32 global neighbour ids
    rev_slot_val: object = None  # [S_rev, K] f32
    rev_slot_row: object = None  # [S_rev] int32 ascending local batch rows
    # the recovery kernels' row offsets into the slots ([B_pad + 1], pad
    # slots in no row) and long rows (rev_ell.rev_long_rows_host)
    rev_row_ptr: object = None
    rev_long_rows: object = None
    # the same reverse list raw, padded to R_pad (row 0, col N, value 0),
    # beside a COO adjacency: the recovery term's grid path reads it
    bm_rev_row: object = None  # [R_pad] local batch rows
    bm_rev_col: object = None  # [R_pad] global neighbour ids
    bm_rev_val: object = None  # [R_pad] f32
    # link prediction: the in-batch positive edges, both local endpoints < B
    # (reference prepare_batch_input_link, misc.py:88-91), padded to L_pad
    link_src: object = None  # [L_pad] local batch rows (pad -> 0)
    link_dst: object = None  # [L_pad]
    link_mask: object = None  # [L_pad] bool

    @property
    def B_pad(self) -> int:
        return self.batch_idx.shape[0]

    @property
    def Bp_pad(self) -> int:
        return self.fo_ids.shape[0]

    def to(self, device) -> "PaddedBatch":
        """Tensors on ``device``: node ids and labels as int64 (indexing),
        ELL indices as int32 (the kernels' type)."""
        y = self.y
        if y is not None:
            y = _as_tensor(y, device, torch.int64 if y.ndim == 1 else torch.float32)
        return PaddedBatch(
            batch_idx=_as_tensor(self.batch_idx, device, torch.int64),
            fo_ids=_as_tensor(self.fo_ids, device, torch.int64),
            valid_B=_as_tensor(self.valid_B, device, torch.bool),
            valid_fo=_as_tensor(self.valid_fo, device, torch.bool),
            edges=self.edges.to(device),
            num_B=int(self.num_B),
            y=y,
            train_mask=_as_tensor(self.train_mask, device, torch.bool),
            rev_slot_col=_as_tensor(self.rev_slot_col, device, torch.int32),
            rev_slot_val=_as_tensor(self.rev_slot_val, device, torch.float32),
            rev_slot_row=_as_tensor(self.rev_slot_row, device, torch.int32),
            rev_row_ptr=_as_tensor(self.rev_row_ptr, device, torch.int32),
            rev_long_rows=_as_tensor(self.rev_long_rows, device, torch.int32),
            bm_rev_row=_as_tensor(self.bm_rev_row, device, torch.int64),
            bm_rev_col=_as_tensor(self.bm_rev_col, device, torch.int64),
            bm_rev_val=_as_tensor(self.bm_rev_val, device, torch.float32),
            link_src=_as_tensor(self.link_src, device, torch.int64),
            link_dst=_as_tensor(self.link_dst, device, torch.int64),
            link_mask=_as_tensor(self.link_mask, device, torch.bool),
        )


def round_up(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def build_padded_batch(
    node_idx: np.ndarray,
    fo_ids: np.ndarray,
    edge_row: np.ndarray,  # local indices: batch rows < len(node_idx),
    edge_col: np.ndarray,  # boundary ids offset by len(node_idx)
    edge_val: np.ndarray,
    num_N: int,
    B_pad: int,
    Bp_pad: int,
    ell_K: int = 0,
    S_pad: int = 0,
    St_pad: int = 0,
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    t_b_bucket: Optional[dict] = None,
    with_f_from_t: bool = False,
    bm_rev=None,
    rev_bucket: Optional[dict] = None,
    with_t_all_lists: bool = False,
    with_link_edges: bool = False,
    L_pad: int = 0,
    E_pad: int = 0,
    R_pad: int = 0,
    ell_Kt: int = 0,
    mixed_pads: Optional[tuple] = None,  # (Sh, St2, tSh, tSt2)
) -> PaddedBatch:
    """Pad a host-built subgraph batch to static shapes
    (``vq_gnn_tpu/sampler/batch.py:build_padded_batch``).

    Inputs use a compact local numbering where boundary node j is
    ``len(node_idx) + j``; boundary indices move to the static offset
    ``B_pad``.  The layout: mixed-K slot-ELL when ``ell_Kt > 0`` (its
    family pads ``mixed_pads``), single-K when ``ell_K > 0`` (``S_pad``,
    ``St_pad``), else COO padded to ``E_pad``.  ``t_b_bucket`` (a monotone
    dict) enables the backward truncation bound of :class:`Edges` under
    either ELL layout; ``with_f_from_t`` adds the single-K cross-layout map
    ``Edges.f_from_t``; ``with_t_all_lists`` the lists of the whole
    transposed ELL (or families), for the GAT backward.  A batch of more than
    ``E_pad`` edges raises under every layout (0: no bound).  ``bm_rev`` (rows,
    global cols, values) is the B + M reverse list: laid out as rev-ELL
    slots padded to the monotone ``rev_bucket["S"]``, or without a
    ``rev_bucket`` (beside COO) kept raw, padded to ``R_pad``.
    ``with_link_edges`` adds the in-batch positive edges (both endpoints
    among the batch rows) padded to ``L_pad`` (0: the next multiple of 1,024).
    """
    B, Bp, E = len(node_idx), len(fo_ids), len(edge_row)
    if B > B_pad or Bp > Bp_pad or (E_pad and E > E_pad):
        raise ValueError(
            f"batch exceeds pad sizes: B={B}/{B_pad} Bp={Bp}/{Bp_pad} E={E}/{E_pad}")
    dim_pad = B_pad + Bp_pad

    def pad_ids(ids, size):
        out = np.full(size, num_N, np.int32)
        out[: len(ids)] = ids
        return out

    def shift(a):  # boundary-local indices move from B to B_pad
        a = np.asarray(a, np.int64)
        return np.where(a >= B, a - B + B_pad, a).astype(np.int32)

    r, c = shift(edge_row), shift(edge_col)
    v = np.asarray(edge_val, np.float32)
    order = np.argsort(r, kind="stable")
    rs, cs, vs = r[order], c[order], v[order]

    if ell_Kt > 0:
        edges = _mixed_edges(rs, cs, vs, dim_pad, ell_K, ell_Kt, mixed_pads, B_pad,
                             t_b_bucket, with_t_all_lists)
    elif ell_K > 0:
        edges = _single_k_edges(rs, cs, vs, dim_pad, ell_K, S_pad, St_pad, B_pad, t_b_bucket,
                                with_f_from_t, with_t_all_lists)
    else:
        row = np.full(E_pad, dim_pad, np.int32)
        col = np.full(E_pad, dim_pad, np.int32)
        val = np.zeros(E_pad, np.float32)
        row[:E], col[:E], val[:E] = rs, cs, vs
        edges = coo_edges(row, col, val, dim_pad)

    valid_B = np.zeros(B_pad, bool)
    valid_B[:B] = True
    valid_fo = np.zeros(Bp_pad, bool)
    valid_fo[:Bp] = True

    def pad_rows(a, fill=0):
        a = np.asarray(a)
        out = np.full((B_pad,) + a.shape[1:], fill, a.dtype)
        out[:B] = a
        return out

    rev = {}
    if bm_rev is not None and rev_bucket is None:
        rev = _pad_bm_rev(bm_rev, R_pad, num_N)
    elif bm_rev is not None:
        slots = build_rev_ell(*bm_rev, B_pad, num_N)
        rev_bucket["S"] = max(rev_bucket.get("S", 0),
                              round_up(slots[0].shape[0], REV_S_MULTIPLE))
        rev = dict(zip(("rev_slot_col", "rev_slot_val", "rev_slot_row"),
                       pad_rev_ell(*slots, rev_bucket["S"], B_pad, num_N)))
        rev["rev_row_ptr"] = row_offsets_host(rev["rev_slot_row"], B_pad)
        rev["rev_long_rows"] = rev_long_rows_host(rev["rev_row_ptr"])

    link = {}
    if with_link_edges:
        # in-batch positive edges: both local endpoints < B (misc.py:88-91)
        e_row = np.asarray(edge_row, np.int64)
        e_col = np.asarray(edge_col, np.int64)
        sel = (e_row < B) & (e_col < B)
        ls, ld = e_row[sel], e_col[sel]
        if L_pad <= 0:
            L_pad = round_up(max(len(ls), 1), 1024)
        if len(ls) > L_pad:
            raise ValueError(f"link edges {len(ls)} exceed L_pad={L_pad}")
        link = dict(link_src=np.zeros(L_pad, np.int32), link_dst=np.zeros(L_pad, np.int32),
                    link_mask=np.zeros(L_pad, bool))
        link["link_src"][: len(ls)] = ls
        link["link_dst"][: len(ld)] = ld
        link["link_mask"][: len(ls)] = True

    return PaddedBatch(
        batch_idx=pad_ids(node_idx, B_pad),
        fo_ids=pad_ids(fo_ids, Bp_pad),
        valid_B=valid_B,
        valid_fo=valid_fo,
        edges=edges,
        num_B=B,
        y=None if y is None else pad_rows(y),
        train_mask=None if train_mask is None else pad_rows(train_mask, False),
        **rev,
        **link,
    )


def _single_k_edges(rs, cs, vs, dim_pad, K, S_pad, St_pad, B_pad, t_b_bucket, with_f_from_t,
                    with_t_all_lists) -> Edges:
    """The single-K slot-ELL of row-sorted edges, forward and transposed
    (``vq_gnn_tpu/sampler/batch.py:176-218``), with the kernels' lists."""
    er_, ec_, ev_ = build_ell_host(rs, cs, vs, dim_pad, K, S_pad)
    t_order = np.argsort(cs, kind="stable")
    tr_, tc_, tv_ = build_ell_host(cs[t_order], rs[t_order], vs[t_order], dim_pad, K, St_pad)
    f_from_t = None
    if with_f_from_t:
        # forward cell -> transposed cell of the same edge (empty -> St_pad*K)
        f_pos = ell_positions(rs, K, dim_pad)
        t_pos = ell_positions(cs[t_order], K, dim_pad)
        f_from_t = np.full(S_pad * K, St_pad * K, np.int32)
        f_from_t[f_pos[t_order]] = t_pos
        f_from_t = f_from_t.reshape(S_pad, K)
    b_rows = t_b_slots = 0
    if t_b_bucket is not None:
        # x rows >= B_pad are codebook lookups with dead cotangents (see
        # Edges.b_rows); the bound is a monotone bucket so shapes stay stable
        ms = max(t_b_bucket.get("multiple", 2048), 64)
        tb = int((np.asarray(tr_) < B_pad).sum())
        tb = ((tb + ms - 1) // ms) * ms
        t_b_bucket["v"] = max(t_b_bucket.get("v", 0), tb)
        tb = min(t_b_bucket["v"], St_pad)
        if tb < St_pad:
            b_rows, t_b_slots = B_pad, tb
    # the rows the backward dx walks: the truncated prefix (ride-over slots
    # clamp to the b_rows dustbin) or the whole transposed ELL
    t_ptr = (row_offsets_host(tr_[:t_b_slots], b_rows) if b_rows
             else row_offsets_host(tr_, dim_pad))
    f_ptr = row_offsets_host(er_, dim_pad)
    t_all_ptr = t_all_long = None
    if with_t_all_lists:
        t_all_ptr = row_offsets_host(tr_, dim_pad) if b_rows else t_ptr
        t_all_long = long_rows_host(t_all_ptr)
    return Edges(
        ell_row=er_, ell_col=ec_, ell_val=ev_, t_ell_row=tr_, t_ell_col=tc_, t_ell_val=tv_,
        num_rows=dim_pad,
        dense_rows=True,  # build_ell_host gives every row >= 1 slot
        b_rows=b_rows, t_b_slots=t_b_slots, f_from_t=f_from_t,
        ell_ptr=f_ptr, ell_long_rows=long_rows_host(f_ptr),
        t_ell_ptr=t_ptr, t_ell_long_rows=long_rows_host(t_ptr),
        t_all_ptr=t_all_ptr, t_all_long_rows=t_all_long,
    )


def _mixed_edges(rs, cs, vs, dim_pad, K, Kt, mixed_pads, B_pad, t_b_bucket,
                 with_t_all_lists) -> Edges:
    """The mixed-K slot-ELL of row-sorted edges, forward and transposed
    (``vq_gnn_tpu/sampler/batch.py:130-175``): full K-wide head slots in
    compact rows and a dense Kt-wide tail, with the per-family truncation
    prefixes and the kernels' lists of every family."""
    Sh_pad, St2_pad, tSh_pad, tSt2_pad = mixed_pads
    hrc, hc, hv, hinv, trow, tcol, tval, h_base, t_base, hrg = build_mixed_ell_host(
        rs, cs, vs, dim_pad, K, Kt, Sh_pad, St2_pad)
    t_order = np.argsort(cs, kind="stable")
    thrc, thc, thv, thinv, ttrow, ttcol, ttval, th_base, tt_base, thrg = build_mixed_ell_host(
        cs[t_order], rs[t_order], vs[t_order], dim_pad, K, Kt, tSh_pad, tSt2_pad)
    edges = Edges(
        head_rowc=hrc, head_col=hc, head_val=hv, head_inv=hinv, head_rowg=hrg,
        tail_row=trow, tail_col=tcol, tail_val=tval,
        t_head_rowc=thrc, t_head_col=thc, t_head_val=thv, t_head_inv=thinv, t_head_rowg=thrg,
        t_tail_row=ttrow, t_tail_col=ttcol, t_tail_val=ttval,
        num_rows=dim_pad, dense_rows=True,
    )
    if t_b_bucket is not None:
        # per-family truncation prefixes (slots with global row < B_pad);
        # monotone buckets keep the shapes stable across batches
        ms = max(t_b_bucket.get("multiple", 2048), 64)
        for key, bound in (("vh", int(th_base[B_pad])), ("vt", int(tt_base[B_pad]))):
            b = ((bound + ms - 1) // ms) * ms
            t_b_bucket[key] = max(t_b_bucket.get(key, 0), b)
        tbh = min(t_b_bucket["vh"], tSh_pad)
        tbt = min(t_b_bucket["vt"], tSt2_pad)
        if tbt < tSt2_pad or tbh < tSh_pad:
            edges.b_rows, edges.t_head_b_slots, edges.t_tail_b_slots = B_pad, tbh, tbt
    # the lists: the head's padding slots (past its live slots) in no row
    nh, nth = int(h_base[-1]), int(th_base[-1])
    edges.head_ptr, edges.head_long_rows = lists_host(hrc, dim_pad, live=nh)
    edges.tail_ptr, edges.tail_long_rows = lists_host(trow, dim_pad)
    whole = (lists_host(thrc, dim_pad, live=nth), lists_host(ttrow, dim_pad))
    if mixed_truncated(edges):
        tbh, tbt, b = edges.t_head_b_slots, edges.t_tail_b_slots, edges.b_rows
        walked = (lists_host(thrc[:tbh], dim_pad, live=nth),
                  lists_host(np.minimum(ttrow[:tbt], b), b))
    else:
        walked = whole
    (edges.t_head_ptr, edges.t_head_long_rows), (edges.t_tail_ptr, edges.t_tail_long_rows) = \
        walked
    if with_t_all_lists:
        ((edges.t_head_all_ptr, edges.t_head_all_long_rows),
         (edges.t_tail_all_ptr, edges.t_tail_all_long_rows)) = whole
    return edges


def _pad_bm_rev(bm_rev, R_pad, num_N):
    """The raw reverse list padded to R_pad: row 0, col N (the dustbin
    node), value 0 (``vq_gnn_tpu/sampler/batch.py:_pad_bm_rev``)."""
    rr, rc, rv = bm_rev
    if len(rr) > R_pad:
        raise ValueError(f"rev edges {len(rr)} exceed R_pad={R_pad}")
    row = np.zeros(R_pad, np.int32)
    colg = np.full(R_pad, num_N, np.int32)
    val = np.zeros(R_pad, np.float32)
    row[: len(rr)] = rr
    colg[: len(rc)] = rc
    val[: len(rv)] = rv
    return dict(bm_rev_row=row, bm_rev_col=colg, bm_rev_val=val)
