"""Graph partitioning for the cluster sampler (copy of
``vq_gnn_tpu/graph/partition.py``).

``partition_graph`` returns (perm, ptr) with the reference's contract
(``misc.py:93-130``): ``perm`` sorts nodes by cluster id and
``ptr[k]:ptr[k+1]`` are the positions of cluster k.  Backends: the native
multilevel partitioner ('ml', the default when the shared library builds),
the native BFS-grow ('bfs'), or reverse-Cuthill-McKee + equal chunks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from vq_gnn_tpu_torch.graph.store import HostGraph


def _balanced_ptr(num_nodes: int, num_parts: int) -> np.ndarray:
    sizes = np.full(num_parts, num_nodes // num_parts, dtype=np.int64)
    sizes[: num_nodes % num_parts] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def partition_graph(
    adj: sp.csr_matrix, num_parts: int, method: str = "auto"
) -> Tuple[np.ndarray, np.ndarray]:
    num_nodes = adj.shape[0]
    if num_parts <= 1:
        return np.arange(num_nodes), np.array([0, num_nodes], dtype=np.int64)

    if method in ("auto", "native", "ml", "bfs"):
        from vq_gnn_tpu_torch.native import lib as native_lib

        if native_lib.available():
            sym = adj.maximum(adj.T).tocsr()
            cluster = native_lib.partition(
                sym, num_parts, method="bfs" if method == "bfs" else "ml"
            )
            perm = np.argsort(cluster, kind="stable")
            counts = np.bincount(cluster, minlength=num_parts)
            ptr = np.concatenate([[0], np.cumsum(counts)])
            return perm.astype(np.int64), ptr.astype(np.int64)
        if method != "auto":
            raise RuntimeError("native partitioner not available")

    sym = adj.maximum(adj.T).tocsr()
    order = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True), dtype=np.int64)
    ptr = _balanced_ptr(num_nodes, num_parts)
    return order, ptr


def permute_graph(graph: HostGraph, perm: np.ndarray) -> HostGraph:
    """Reorder node arrays and adjacency so perm[i] becomes node i
    (reference ``permute``, ``misc.py:114-130``)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    adj = graph.adj.tocoo()
    new_adj = sp.csr_matrix(
        (adj.data, (inv[adj.row], inv[adj.col])), shape=adj.shape
    )

    def _p(a):
        return None if a is None else np.asarray(a)[perm]

    return HostGraph(
        adj=new_adj,
        x=graph.x[perm],
        y=_p(graph.y),
        train_mask=_p(graph.train_mask),
        val_mask=_p(graph.val_mask),
        test_mask=_p(graph.test_mask),
        deg=_p(graph.deg),
        deg_inv=_p(graph.deg_inv),
    )


def edge_cut_stats(adj: sp.spmatrix, labels: np.ndarray) -> dict:
    """Edge-cut fraction and the reference's inter/intra cluster edge ratio
    (``dataloader.py v2:29-35``)."""
    coo = adj.tocoo()
    total = coo.nnz
    intra = int(np.count_nonzero(labels[coo.row] == labels[coo.col]))
    inter = total - intra
    return {
        "num_edges": total,
        "intra_edges": intra,
        "inter_edges": inter,
        "cut_fraction": inter / max(total, 1),
        "inter_over_intra": inter / max(intra, 1),
    }


def labels_from_cluster_indices(num_nodes: int, cluster_indices) -> np.ndarray:
    labels = np.full(num_nodes, -1, dtype=np.int64)
    for k, ids in enumerate(cluster_indices):
        labels[np.asarray(ids)] = k
    return labels


def cluster_indices_from_ptr(ptr: np.ndarray):
    """Node-index lists per cluster after permutation (``misc.py:194-199``)."""
    return [np.arange(ptr[i], ptr[i + 1], dtype=np.int64) for i in range(len(ptr) - 1)]
