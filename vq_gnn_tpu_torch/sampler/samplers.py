"""Mini-batch samplers — host-side schedule construction (port of
``vq_gnn_tpu/sampler/samplers.py``).

Reproduces the reference ``OurDataLoader`` semantics
(``vq_gnn_v2/dataloader.py:11-148``) for the B + B' formulation:

- samplers node / edge / rw / cont / cluster, with the per-sampler
  effective-batch-size rescaling (lines 40-47); multi-window ``cont`` batches
  skip the optimizer step on window 0 (handled by the trainer);
- 1-hop subgraph extraction with the [B || B'] subset layout; train batches
  keep *all* edges among the subset, eval batches only rows of B.

Each yielded window is a static-shape :class:`PaddedBatch` moved to the
loader's device as tensors.  The per-batch host work is numpy over CSR, or
the native C++ kernels when they build.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from vq_gnn_tpu_torch.config import Config, check_ported, resolve_device
from vq_gnn_tpu_torch.graph.partition import (
    edge_cut_stats,
    labels_from_cluster_indices,
)
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch, build_padded_batch, round_up


def _native():
    from vq_gnn_tpu_torch.native import lib as native_lib

    return native_lib if native_lib.available() else None


def random_walk(rowptr, col, starts, length, rng) -> np.ndarray:
    """torch_cluster-style uniform random walk on CSR; [len(starts), length+1].
    A node with no neighbors stays put."""
    nl = _native()
    if nl is not None:
        return nl.random_walk(rowptr, col, starts, length, rng.randint(0, 2**31))
    n = len(starts)
    out = np.empty((n, length + 1), dtype=np.int64)
    out[:, 0] = starts
    cur = np.asarray(starts, dtype=np.int64)
    for step in range(length):
        deg = rowptr[cur + 1] - rowptr[cur]
        r = rng.randint(0, np.maximum(deg, 1))
        nxt = col[rowptr[cur] + r]
        cur = np.where(deg > 0, nxt, cur)
        out[:, step + 1] = cur
    return out


def k_hop_subgraph(rowptr, col, val, node_idx, num_N, train_flag: bool):
    """1-hop subgraph with [B || B'] layout (``dataloader.py v2:98-148``).

    Returns (fo_ids, e_row, e_col, e_val) in compact local numbering where
    batch node i -> i and boundary j -> B + j.
    """
    node_idx = np.asarray(node_idx, dtype=np.int64)
    B = len(node_idx)

    nl = _native()
    if nl is not None:
        return nl.khop(rowptr, col, val, num_N, node_idx, train_flag)

    starts, ends = rowptr[node_idx], rowptr[node_idx + 1]
    counts = ends - starts
    gather = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(
        counts.sum()
    )
    nbr = col[gather]

    in_batch = np.zeros(num_N, dtype=bool)
    in_batch[node_idx] = True
    fo_ids = np.unique(nbr[~in_batch[nbr]])

    pos = np.full(num_N, -1, dtype=np.int64)
    pos[node_idx] = np.arange(B)
    pos[fo_ids] = B + np.arange(len(fo_ids))

    if train_flag:
        # all edges among the subset
        subset = np.concatenate([node_idx, fo_ids])
        s_starts, s_ends = rowptr[subset], rowptr[subset + 1]
        s_counts = s_ends - s_starts
        s_gather = np.repeat(
            s_starts - np.cumsum(s_counts) + s_counts, s_counts
        ) + np.arange(s_counts.sum())
        rows_g = np.repeat(subset, s_counts)
        cols_g = col[s_gather]
        vals_g = val[s_gather]
        keep = pos[cols_g] >= 0
        e_row, e_col, e_val = pos[rows_g[keep]], pos[cols_g[keep]], vals_g[keep]
    else:
        # eval: only batch rows receive messages (dataloader.py v2:136-138)
        rows_g = np.repeat(node_idx, counts)
        e_row, e_col, e_val = pos[rows_g], pos[nbr], val[gather]

    return fo_ids, e_row, e_col, e_val


class BatchLoader:
    """Epoch iterator yielding (list of PaddedBatch windows, raw node ids)."""

    def __init__(
        self,
        graph: HostGraph,
        cfg: Config,
        batch_size: Optional[int] = None,
        train_flag: bool = True,
        sampler_type: Optional[str] = None,
        cluster_indices: Optional[Sequence[np.ndarray]] = None,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ):
        check_ported(cfg)
        self.device = resolve_device(device)
        self.graph = graph
        self.cfg = cfg
        self.train_flag = train_flag
        self.sampler_type = sampler_type or (cfg.sampler_type if train_flag else "node")
        self.cluster_indices = cluster_indices
        self.shuffle = train_flag if shuffle is None else shuffle
        self.seed = seed
        self.N = graph.num_nodes

        csr = graph.adj.tocsr()
        csr.sort_indices()
        self.rowptr = csr.indptr.astype(np.int64)
        self.col = csr.indices.astype(np.int64)
        self.val = csr.data.astype(np.float32)

        requested = batch_size if batch_size is not None else (
            cfg.batch_size if train_flag else cfg.test_batch_size
        )
        if requested <= 0:
            requested = self.N
        self.requested_batch_size = requested
        # effective batch rescaling (dataloader.py v2:40-47)
        st, wl = self.sampler_type, cfg.walk_length
        if st == "edge":
            self.batch_size = requested // 2
        elif st == "rw":
            self.batch_size = requested // (wl + 1)
        elif st == "cont":
            self.batch_size = requested // cfg.cont_sliding_window
        else:
            self.batch_size = requested

        if st == "cluster" and cluster_indices is None:
            raise ValueError("cluster sampler needs cluster_indices")
        if st == "cluster" and train_flag:
            # the reference's partition-quality print (dataloader.py v2:29-35)
            labels = labels_from_cluster_indices(self.N, cluster_indices)
            s = edge_cut_stats(graph.adj, labels)
            print(
                f"inter over intra: {s['inter_over_intra']:.4f} "
                f"(edge cut {100 * s['cut_fraction']:.2f}% of "
                f"{s['num_edges']} edges, {len(cluster_indices)} parts)",
                file=sys.stderr,
            )

        self._epoch = 0
        # pad-size high-water marks keep the set of shapes small and monotone
        self._B_bucket = 0
        self._Bp_bucket = 0
        self._S_bucket = 0
        self._St_bucket = 0
        self._tb_bucket = {"multiple": max(cfg.pad_multiple_edges // cfg.ell_K, 64)}

    # ---- batch index generation (one epoch) ----
    def _node_batches(self, rng) -> List[List[np.ndarray]]:
        st = self.sampler_type
        if st == "cluster":
            order = (
                rng.permutation(len(self.cluster_indices))
                if self.shuffle
                else np.arange(len(self.cluster_indices))
            )
            groups = [
                order[i : i + self.batch_size]
                for i in range(0, len(order), self.batch_size)
            ]
            return [
                [np.concatenate([self.cluster_indices[c] for c in g])] for g in groups
            ]

        pool = np.arange(self.N)
        ids = rng.permutation(pool) if self.shuffle else pool
        chunks = [
            ids[i : i + self.batch_size] for i in range(0, len(pool), self.batch_size)
        ]
        out = []
        for idx in chunks:
            if st == "node":
                out.append([idx])
            elif st == "edge":
                walks = random_walk(self.rowptr, self.col, idx, 1, rng)
                out.append([np.unique(walks.reshape(-1))])
            elif st == "rw":
                walks = random_walk(
                    self.rowptr, self.col, idx, self.cfg.walk_length, rng
                )
                out.append([np.unique(walks.reshape(-1))])
            elif st == "cont":
                windows = [idx]
                cur = idx
                for _ in range(self.cfg.walk_length):
                    tripled = np.concatenate([cur] * 3)
                    stepped = random_walk(self.rowptr, self.col, tripled, 1, rng)[:, 1]
                    cur = np.unique(stepped)[: self.batch_size]
                    windows.append(cur)
                w = self.cfg.cont_sliding_window
                if w > 1:
                    windows = [
                        np.unique(np.concatenate(windows[i : i + w]))
                        for i in range(len(windows) - w + 1)
                    ]
                out.append(windows)
            else:
                raise ValueError("Sampler type not supported!")
        return out

    def _pad_sizes(self, B, Bp):
        mn = self.cfg.pad_multiple_nodes
        self._B_bucket = max(self._B_bucket, round_up(B, mn))
        self._Bp_bucket = max(self._Bp_bucket, round_up(max(Bp, 1), mn))
        return self._B_bucket, self._Bp_bucket

    def _slot_pad(self, er, K, dim_pad, attr):
        ms = max(self.cfg.pad_multiple_edges // K, 64)
        # dense-rows ELL: every one of the dim_pad local rows owns >= 1 slot
        deg = np.bincount(er, minlength=dim_pad)
        nnz_rows = int((deg > 0).sum())
        S = int(((deg + K - 1) // K).sum()) + (dim_pad - nnz_rows)
        bucket = max(getattr(self, attr), round_up(max(S, 1), ms))
        setattr(self, attr, bucket)
        return bucket

    def _build(self, node_idx: np.ndarray) -> PaddedBatch:
        g = self.graph
        fo_ids, er, ec, ev = k_hop_subgraph(
            self.rowptr, self.col, self.val, node_idx, self.N, self.train_flag
        )
        B_pad, Bp_pad = self._pad_sizes(len(node_idx), len(fo_ids))
        K = self.cfg.ell_K
        dim_pad = B_pad + Bp_pad
        S_pad = self._slot_pad(er, K, dim_pad, "_S_bucket")
        St_pad = self._slot_pad(ec, K, dim_pad, "_St_bucket")
        # backward truncation: x rows >= B_pad are codebook lookups whose
        # cotangent flows only into the non-differentiated VQ state
        return build_padded_batch(
            node_idx,
            fo_ids,
            er,
            ec,
            ev,
            self.N,
            B_pad,
            Bp_pad,
            ell_K=K,
            S_pad=S_pad,
            St_pad=St_pad,
            y=None if g.y is None else g.y[node_idx],
            train_mask=None if g.train_mask is None else g.train_mask[node_idx],
            t_b_bucket=self._tb_bucket if self.train_flag else None,
        )

    def _epoch_iter(self):
        rng = np.random.RandomState((self.seed + self._epoch * 9973) % (2**31))
        self._epoch += 1
        for windows in self._node_batches(rng):
            yield [self._build(idx) for idx in windows], windows

    def _to_device(self, item):
        """Tensors on the loader's device, made in the consumer thread."""
        windows, raw = item
        return [w.to(self.device) for w in windows], raw

    def __iter__(self):
        # a background thread overlaps the host-side subgraph/ELL build with
        # the device step (the reference's DataLoader num_workers analogue)
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)
        DONE = object()
        err = []

        def producer():
            try:
                for item in self._epoch_iter():
                    q.put(item)
            except BaseException as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                q.put(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is DONE:
                break
            yield self._to_device(item)
        t.join()
        if err:
            raise err[0]
