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
device as tensors.  Only the single-K slot-ELL layout is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vq_gnn_tpu_torch.config import not_ported
from vq_gnn_tpu_torch.ops.spmm import Edges, build_ell_host


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
    ell_K: int,
    S_pad: int,
    St_pad: int,
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    t_b_bucket: Optional[dict] = None,
) -> PaddedBatch:
    """Pad a host-built subgraph batch to static shapes, in the single-K
    slot-ELL layout (``vq_gnn_tpu/sampler/batch.py:176-218``).

    Inputs use a compact local numbering where boundary node j is
    ``len(node_idx) + j``; boundary indices move to the static offset
    ``B_pad``.  ``t_b_bucket`` (a monotone dict) enables the backward
    truncation bound ``b_rows``/``t_b_slots`` of :class:`Edges`.
    """
    if ell_K <= 0:
        raise not_ported("the COO spmm layout (spmm_backend='coo')")
    B, Bp = len(node_idx), len(fo_ids)
    if B > B_pad or Bp > Bp_pad:
        raise ValueError(f"batch exceeds pad sizes: B={B}/{B_pad} Bp={Bp}/{Bp_pad}")
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

    er_, ec_, ev_ = build_ell_host(rs, cs, vs, dim_pad, ell_K, S_pad)
    t_order = np.argsort(cs, kind="stable")
    tr_, tc_, tv_ = build_ell_host(
        cs[t_order], rs[t_order], vs[t_order], dim_pad, ell_K, St_pad
    )
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
    edges = Edges(
        ell_row=er_,
        ell_col=ec_,
        ell_val=ev_,
        t_ell_row=tr_,
        t_ell_col=tc_,
        t_ell_val=tv_,
        num_rows=dim_pad,
        dense_rows=True,  # build_ell_host gives every row >= 1 slot
        b_rows=b_rows,
        t_b_slots=t_b_slots,
    )

    valid_B = np.zeros(B_pad, bool)
    valid_B[:B] = True
    valid_fo = np.zeros(Bp_pad, bool)
    valid_fo[:Bp] = True

    def pad_rows(a, fill=0):
        a = np.asarray(a)
        out = np.full((B_pad,) + a.shape[1:], fill, a.dtype)
        out[:B] = a
        return out

    return PaddedBatch(
        batch_idx=pad_ids(node_idx, B_pad),
        fo_ids=pad_ids(fo_ids, Bp_pad),
        valid_B=valid_B,
        valid_fo=valid_fo,
        edges=edges,
        num_B=B,
        y=None if y is None else pad_rows(y),
        train_mask=None if train_mask is None else pad_rows(train_mask, False),
    )
