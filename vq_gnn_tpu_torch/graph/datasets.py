"""Dataset zoo (copy of the transductive part of ``vq_gnn_tpu/graph/datasets.py``).

Mirrors the reference ``get_data`` (``vq_gnn_v2/utils/misc.py:144-224``):
symmetrize -> (cluster partition/permute) -> per-conv normalization ->
feature padding.  Sources: ``.npz`` archives under ``data_root`` and a
degree-skewed stochastic block model for network-isolated runs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from vq_gnn_tpu_torch.config import Config, check_ported, not_ported
from vq_gnn_tpu_torch.graph.partition import (
    cluster_indices_from_ptr,
    partition_graph,
    permute_graph,
)
from vq_gnn_tpu_torch.graph.store import (
    HostGraph,
    norm_adj,
    norm_adj_v1,
    pad_features,
    symmetrize,
)


def load_npz(path: str) -> Tuple[HostGraph, int]:
    """Load a preprocessed graph: edge_index [2,E], x [N,F], y, masks."""
    z = np.load(path, allow_pickle=False)
    n = int(z["num_nodes"])
    src, dst = z["edge_index"][0], z["edge_index"][1]
    adj = sp.csr_matrix(
        (np.ones(len(src), np.float32), (dst, src)), shape=(n, n)
    )
    g = HostGraph(
        adj=adj,
        x=z["x"].astype(np.float32),
        y=z["y"],
        train_mask=z.get("train_mask"),
        val_mask=z.get("val_mask"),
        test_mask=z.get("test_mask"),
    )
    num_classes = int(z["num_classes"]) if "num_classes" in z else int(g.y.max()) + 1
    return g, num_classes


def synthetic_sbm(
    num_nodes: int = 2000,
    num_classes: int = 8,
    num_features: int = 32,
    avg_degree: float = 10.0,
    homophily: float = 0.8,
    feature_noise: float = 1.0,
    multilabel: bool = False,
    seed: int = 0,
    informative_dims: Optional[int] = None,
    centroid_seed: Optional[int] = None,
) -> Tuple[HostGraph, int]:
    """Degree-skewed stochastic block model with class-informative features:
    homophilous edges, lognormal degrees, 60/20/20 random splits.  Draws the
    same numbers as the JAX package's generator for the same arguments."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, num_nodes)
    crng = rng if centroid_seed is None else np.random.RandomState(centroid_seed)
    centroids = crng.randn(num_classes, num_features).astype(np.float32) * 2.0
    if informative_dims is not None and informative_dims < num_features:
        centroids[:, informative_dims:] = 0.0
    x = centroids[labels] + feature_noise * rng.randn(num_nodes, num_features).astype(
        np.float32
    )

    w = rng.lognormal(0.0, 1.0, num_nodes)
    w /= w.sum()
    num_edges = int(num_nodes * avg_degree / 2)
    src = rng.choice(num_nodes, size=3 * num_edges, p=w)
    same = rng.rand(len(src)) < homophily
    partner = rng.choice(num_nodes, size=len(src), p=w)
    ok = labels[src] == labels[partner]
    keep = np.where(same, ok, ~ok)
    src, dst = src[keep][:num_edges], partner[keep][:num_edges]
    sel = src != dst
    src, dst = src[sel], dst[sel]

    adj = sp.csr_matrix(
        (np.ones(len(src), np.float32), (dst, src)), shape=(num_nodes, num_nodes)
    )

    perm = rng.permutation(num_nodes)
    train = perm[: int(0.6 * num_nodes)]
    val = perm[int(0.6 * num_nodes) : int(0.8 * num_nodes)]
    test = perm[int(0.8 * num_nodes) :]
    masks = {}
    for name, idx in [("train_mask", train), ("val_mask", val), ("test_mask", test)]:
        m = np.zeros(num_nodes, bool)
        m[idx] = True
        masks[name] = m

    if multilabel:
        y = np.zeros((num_nodes, num_classes), np.float32)
        y[np.arange(num_nodes), labels] = 1.0
        extra = rng.randint(0, num_classes, num_nodes)
        y[np.arange(num_nodes), extra] = 1.0
    else:
        y = labels.astype(np.int32)

    return HostGraph(adj=adj, x=x, y=y, **masks), num_classes


def prepare(
    graph: HostGraph, cfg: Config, num_classes: int, symmetrize_adj: bool = True
) -> Tuple[HostGraph, int, Optional[list]]:
    """Reference get_data pipeline: symmetrize, cluster-permute, normalize,
    pad features (``misc.py:183-224``)."""
    check_ported(cfg)
    if symmetrize_adj:
        graph.adj = symmetrize(graph.adj)

    cluster_indices = None
    if cfg.sampler_type == "cluster":
        perm, ptr = partition_graph(graph.adj, cfg.num_parts)
        graph = permute_graph(graph, perm)
        cluster_indices = cluster_indices_from_ptr(ptr)

    if cfg.formulation == "bm":
        graph = norm_adj_v1(graph, cfg.conv_type)
    else:
        graph = norm_adj(graph, cfg.conv_type)
    if cfg.split:
        graph = pad_features(graph, cfg.num_D)
    return graph, num_classes, cluster_indices


INDUCTIVE_DATASETS = {"ppi", "cluster"}


def is_inductive(cfg: Config) -> bool:
    return cfg.dataset in INDUCTIVE_DATASETS or cfg.dataset.startswith(
        "synthetic_inductive"
    )


def get_data(cfg: Config) -> Tuple[HostGraph, int, Optional[list]]:
    """Dataset dispatch: npz archives under data_root, else synthetic.
    Inductive datasets (train, val and test graphs apart) raise."""
    if is_inductive(cfg):
        raise not_ported(f"inductive dataset {cfg.dataset!r}", "queue 1 item 6")
    if cfg.dataset.startswith("synthetic"):
        parts = cfg.dataset.split(":")
        n = int(parts[1]) if len(parts) > 1 else 2000
        g, c = synthetic_sbm(num_nodes=n, seed=cfg.seed)
    else:
        path = os.path.join(cfg.data_root, f"{cfg.dataset}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; build it with tools/convert_dataset.py "
                f"or use dataset='synthetic[:N]'"
            )
        g, c = load_npz(path)
    return prepare(g, cfg, c)
