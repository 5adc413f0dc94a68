"""Dataset zoo (copy of ``vq_gnn_tpu/graph/datasets.py``).

Mirrors the reference ``get_data`` (``vq_gnn_v2/utils/misc.py:144-224``):
symmetrize -> (cluster partition/permute) -> per-conv normalization ->
feature padding.  Sources: ``.npz`` archives under ``data_root`` (the
inductive three-split ones too, ``load_inductive_npz``) and, for
network-isolated runs, a degree-skewed stochastic block model, its
three-graph inductive variant and a latent dot-product graph for link
prediction.  Each generator draws the same numbers as the JAX package's for
the same arguments.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from vq_gnn_tpu_torch.config import Config, check_ported
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


def load_inductive_npz(path: str):
    """Load a ppi/cluster-style inductive archive (three block-diagonal
    merged splits, written by ``tools/convert_dataset.py:convert_inductive``).
    The merged train split gets an all-ones train_mask, matching the
    reference's ``inductive_data`` (``vq_gnn_v2/utils/misc.py:133-137``)."""
    z = np.load(path, allow_pickle=False)
    graphs = []
    for split in ("train", "val", "test"):
        x = z[f"{split}_x"].astype(np.float32)
        src, dst = z[f"{split}_edge_index"][0], z[f"{split}_edge_index"][1]
        n = x.shape[0]
        adj = sp.csr_matrix(
            (np.ones(len(src), np.float32), (dst, src)), shape=(n, n)
        )
        graphs.append(HostGraph(
            adj=adj,
            x=x,
            y=z[f"{split}_y"],
            train_mask=np.ones(n, dtype=bool) if split == "train" else None,
        ))
    return graphs, int(z["num_classes"])


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
    pad features (``misc.py:183-224``).  ogbl-collab skips symmetrization
    (main_link.py v2:283-284 symmetrizes citation2 only)."""
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


def get_inductive_data(cfg: Config):
    """Inductive dispatch: (train_g, val_g, test_g, num_classes), prepared
    per split (reference get_data ppi/cluster branches, misc.py:158-177)."""
    if cfg.dataset.startswith("synthetic_inductive"):
        parts = cfg.dataset.split(":")
        n = int(parts[1]) if len(parts) > 1 else 300
        graphs, c = synthetic_inductive(num_nodes=n, seed=cfg.seed)
    else:
        path = os.path.join(cfg.data_root, f"{cfg.dataset}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found; run tools/convert_dataset.py --dataset "
                f"{cfg.dataset} on a machine with egress (see REAL_DATA.md)"
            )
        graphs, c = load_inductive_npz(path)
    return prepare_inductive(graphs, cfg, c)


def get_data(cfg: Config) -> Tuple[HostGraph, int, Optional[list]]:
    """Dataset dispatch: npz archives under data_root, else synthetic.  The
    inductive datasets have their own, :func:`get_inductive_data`."""
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


def synthetic_dot_product(
    num_nodes: int = 2000,
    num_features: int = 64,
    avg_degree: float = 10.0,
    latent_dim: int = 16,
    num_blocks: int = 16,
    feature_noise: float = 0.5,
    candidates: int = 400,
    same_block_frac: float = 0.8,
    seed: int = 0,
) -> Tuple[HostGraph, int]:
    """Latent dot-product graph, whose edges are predictable from the node
    features (the random-dot-product-graph model collab-style link
    prediction assumes; an SBM's within-block pairs are exchangeable, so no
    model can rank them).  Each node gets a latent position on the sphere
    (one of ``num_blocks`` community centres plus spread) and connects to its
    ``avg_degree / 2`` highest-dot-product neighbours in a block-biased
    candidate pool; features are ``z W + noise``; labels are the block ids.
    Symmetric, unit values, 60/20/20 node masks."""
    rng = np.random.RandomState(seed)
    blocks = rng.randint(0, num_blocks, num_nodes)
    mu = rng.randn(num_blocks, latent_dim).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=1, keepdims=True)
    z = mu[blocks] + 0.6 * rng.randn(num_nodes, latent_dim).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)

    k = max(1, int(round(avg_degree / 2)))
    by_block = [np.where(blocks == b)[0] for b in range(num_blocks)]
    n_same = int(candidates * same_block_frac)
    rows, cols = [], []
    step = 8192
    for lo in range(0, num_nodes, step):
        idx = np.arange(lo, min(lo + step, num_nodes))
        cand = np.empty((len(idx), candidates), np.int64)
        for j, i in enumerate(idx):
            pool = by_block[blocks[i]]
            cand[j, :n_same] = pool[rng.randint(0, len(pool), n_same)]
        cand[:, n_same:] = rng.randint(0, num_nodes, (len(idx), candidates - n_same))
        sims = np.einsum("nd,ncd->nc", z[idx], z[cand], optimize=True)
        sims[cand == idx[:, None]] = -np.inf  # no self loops
        # duplicate candidates masked (the first kept), so the top k are k
        # distinct neighbours
        order = np.argsort(cand, axis=1)
        sc = np.take_along_axis(cand, order, 1)
        dupm = np.zeros_like(sims, dtype=bool)
        np.put_along_axis(dupm, order[:, 1:], sc[:, 1:] == sc[:, :-1], 1)
        sims[dupm] = -np.inf
        top = np.argpartition(-sims, k, axis=1)[:, :k]
        rows.append(np.repeat(idx, k))
        cols.append(np.take_along_axis(cand, top, axis=1).reshape(-1))
    src = np.concatenate(rows)
    dst = np.concatenate(cols)
    adj = sp.csr_matrix(
        (np.ones(len(src), np.float32), (dst, src)), shape=(num_nodes, num_nodes)
    )
    adj = adj.maximum(adj.T).tocsr()
    adj.data = np.ones_like(adj.data)

    W = rng.randn(latent_dim, num_features).astype(np.float32)
    x = z @ W + feature_noise * rng.randn(num_nodes, num_features).astype(np.float32)

    perm = rng.permutation(num_nodes)
    masks = {}
    for name, sl in [
        ("train_mask", perm[: int(0.6 * num_nodes)]),
        ("val_mask", perm[int(0.6 * num_nodes) : int(0.8 * num_nodes)]),
        ("test_mask", perm[int(0.8 * num_nodes) :]),
    ]:
        m = np.zeros(num_nodes, bool)
        m[sl] = True
        masks[name] = m
    return HostGraph(adj=adj, x=x, y=blocks.astype(np.int32), **masks), num_blocks


def prepare_inductive(graphs, cfg: Config, num_classes: int):
    """Inductive pipeline (``misc.py:203-210``): symmetrize and normalize
    each split graph, features padded per split; no cluster sampler."""
    check_ported(cfg)
    if cfg.sampler_type == "cluster":
        raise NotImplementedError("cluster sampler on inductive datasets")
    out = []
    for g in graphs:
        g.adj = symmetrize(g.adj)
        if cfg.formulation == "bm":
            g = norm_adj_v1(g, cfg.conv_type)
        else:
            g = norm_adj(g, cfg.conv_type)
        if cfg.split:
            g = pad_features(g, cfg.num_D)
        out.append(g)
    return (*out, num_classes)


def synthetic_inductive(num_nodes=300, num_classes=6, num_features=32, multilabel=True, seed=0):
    """Three disjoint graphs drawn from one SBM distribution (ppi-like),
    of ``num_nodes``, half and half of it nodes; each gets an all-ones
    train_mask (``misc.py:133-137``)."""
    graphs = []
    for i, n in enumerate([num_nodes, num_nodes // 2, num_nodes // 2]):
        g, _ = synthetic_sbm(
            num_nodes=n,
            num_classes=num_classes,
            num_features=num_features,
            multilabel=multilabel,
            seed=seed + 101 * i,
        )
        g.train_mask = np.ones(n, dtype=bool)
        g.val_mask = g.test_mask = None
        graphs.append(g)
    return graphs, num_classes
