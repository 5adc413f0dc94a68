"""Host-side graph store (numpy/scipy copy of ``vq_gnn_tpu/graph/store.py``).

The graph lives on the host as a CSR adjacency plus node arrays.  One-time
preprocessing — symmetrization, self-loops, per-conv normalization
(reference ``vq_gnn_v2/utils/misc.py:14-34``) and feature padding
(``misc.py:212-219``) — happens here, before training.

Layout: ``adj`` is ``adj_t`` like the reference's SparseTensor — row =
target, col = source; messages flow col -> row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class HostGraph:
    """A preprocessed graph resident on the host."""

    adj: sp.csr_matrix  # [N, N] float32 values (normalized edge weights)
    x: np.ndarray  # [N, F] float32 node features
    y: Optional[np.ndarray] = None  # [N] int labels or [N, C] multilabel float
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    deg: Optional[np.ndarray] = None
    deg_inv: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.adj.nnz)

    @property
    def num_features(self) -> int:
        return self.x.shape[1]


def symmetrize(adj: sp.spmatrix) -> sp.csr_matrix:
    """A := union of A and A^T with unit values (``adj_t.to_symmetric()``)."""
    adj = adj.tocsr()
    sym = adj.maximum(adj.T).tocsr()
    sym.data = np.ones_like(sym.data, dtype=np.float32)
    sym.eliminate_zeros()
    return sym


def set_diag(adj: sp.csr_matrix, value: float = 1.0) -> sp.csr_matrix:
    """Set every diagonal entry to ``value`` (reference ``set_diag``)."""
    adj = adj.tolil(copy=True)
    adj.setdiag(value)
    return adj.tocsr()


def norm_adj(graph: HostGraph, conv_type: str) -> HostGraph:
    """Per-conv adjacency normalization (``vq_gnn_v2/utils/misc.py:14-34``):

    - GCN:  add self-loops, then D^{-1/2} A D^{-1/2}
    - SAGE: row normalization D^{-1} A (no self-loops)
    - GAT:  add self-loops, then row normalization D^{-1} A
    """
    adj = graph.adj.astype(np.float32)
    if conv_type in ("GCN", "GAT"):
        adj = set_diag(adj)
    deg = np.asarray(adj.sum(axis=1)).reshape(-1).astype(np.float32)
    with np.errstate(divide="ignore"):
        if conv_type == "GCN":
            dinv = np.power(deg, -0.5)
        else:
            dinv = np.power(deg, -1.0)
    dinv[~np.isfinite(dinv)] = 0.0

    adj = adj.tocoo()
    if conv_type == "GCN":
        data = dinv[adj.row] * adj.data * dinv[adj.col]
    else:  # SAGE / GAT: row normalization
        data = dinv[adj.row] * adj.data
    out = sp.csr_matrix((data.astype(np.float32), (adj.row, adj.col)), shape=adj.shape)

    graph.adj = out
    graph.deg = deg
    graph.deg_inv = dinv if conv_type != "GCN" else np.where(deg > 0, 1.0 / deg, 0.0)
    return graph


def pad_features(graph: HostGraph, num_D: int) -> HostGraph:
    """Zero-pad the feature dim to a multiple of num_D (``misc.py:212-219``)."""
    F = graph.x.shape[1]
    if F % num_D != 0:
        pad = num_D - F % num_D
        graph.x = np.concatenate(
            [graph.x, np.zeros((graph.x.shape[0], pad), dtype=graph.x.dtype)], axis=1
        )
    return graph
