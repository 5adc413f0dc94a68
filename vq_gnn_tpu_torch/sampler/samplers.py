"""Mini-batch samplers — host-side schedule construction (port of
``vq_gnn_tpu/sampler/samplers.py``).

Reproduces the reference ``OurDataLoader`` semantics
(``vq_gnn_v2/dataloader.py:11-148``) for the B + B' formulation, and the v1
mapper's edge sets for the B + M formulation (:func:`bm_subgraph`):

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
from typing import List, Optional, Sequence, Tuple, Union

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


def bm_subgraph(rowptr, col, val, deg, deg_inv, node_idx, num_N, conv_type: str,
                recovery_flag: bool, train_flag: bool, exact_minibatch: bool = False):
    """B + M (v1) edge sets, the per-edge equivalent of the mapper
    (``vq_gnn_v1/utils/dataloader.py:144-192``; copy of
    ``vq_gnn_tpu/sampler/samplers.py:bm_subgraph``).

    The mapper's (B+M)x(B+M) matrix sums A(i,j) over the out-of-batch
    neighbours j of a codeword into one cell; the linear convs and the GAT
    attention (whose logits depend only on the codeword row) are invariant
    to splitting a cell into its edges, so per-edge lists in the [B || B']
    local layout carry v1 values:

    - B rows: in-batch edges exact (GCN doubled by the mapper's
      to_symmetric), out-of-batch edges A(i,j) through the neighbour's
      codeword row; self-loops of value deg_inv (GCN doubled; SAGE none).
      Without recovery (and in eval batches) every neighbour routes through
      its codeword.
    - GCN training: B' rows (j <- i in B) of value A(i,j) feed the recovery
      term directly.
    - Non-GCN training with recovery: the mapper's reverse side adds
      deg*A*deg_inv on all neighbour edges but subtracts the RAW A on the
      in-batch ones, so the per-(row, codeword) positive clamp is live; the
      raw per-edge inputs come back as ``rev`` = (local row, global col,
      value) for the device to coalesce.
    - ``exact_minibatch`` (the convergence-matched control,
      ``Config.exact_minibatch``): the exact in-batch edges (GCN doubled)
      and the self-loops alone; no codeword columns, no reverse rows, no
      recovery.

    Returns (fo_ids, e_row, e_col, e_val, rev or None)."""
    node_idx = np.asarray(node_idx, dtype=np.int64)
    B = len(node_idx)
    in_batch = np.zeros(num_N, dtype=bool)
    in_batch[node_idx] = True

    starts, ends = rowptr[node_idx], rowptr[node_idx + 1]
    counts = ends - starts
    gather = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(counts.sum())
    rows_g = np.repeat(node_idx, counts)  # global batch row per edge
    cols_g = col[gather]
    vals_g = val[gather]
    nbr_out = ~in_batch[cols_g]
    gcn_mult = 2.0 if conv_type == "GCN" else 1.0

    if exact_minibatch:
        pos = np.full(num_N, -1, dtype=np.int64)
        pos[node_idx] = np.arange(B)
        sel = ~nbr_out
        er_l, ec_l, ev_l = [pos[rows_g[sel]]], [pos[cols_g[sel]]], [vals_g[sel] * gcn_mult]
        if conv_type != "SAGE":
            er_l.append(np.arange(B))
            ec_l.append(np.arange(B))
            ev_l.append(deg_inv[node_idx].astype(np.float32) * gcn_mult)
        return (np.zeros(0, np.int64), np.concatenate(er_l), np.concatenate(ec_l),
                np.concatenate(ev_l).astype(np.float32), None)

    if recovery_flag and train_flag:
        fo_ids = np.unique(cols_g[nbr_out])
    else:
        fo_ids = np.unique(cols_g)  # every neighbour routes via its codeword

    pos = np.full(num_N, -1, dtype=np.int64)
    pos[node_idx] = np.arange(B)
    fo_pos = np.full(num_N, -1, dtype=np.int64)
    fo_pos[fo_ids] = B + np.arange(len(fo_ids))

    er_list, ec_list, ev_list = [], [], []
    rev = None
    if recovery_flag and train_flag:
        sel = ~nbr_out  # exact in-batch edges
        er_list.append(pos[rows_g[sel]])
        ec_list.append(pos[cols_g[sel]])
        ev_list.append(vals_g[sel] * gcn_mult)
        er_list.append(pos[rows_g[nbr_out]])  # out-of-batch via codewords
        ec_list.append(fo_pos[cols_g[nbr_out]])
        ev_list.append(vals_g[nbr_out])
        rev_sel = nbr_out
    else:
        er_list.append(pos[rows_g])
        ec_list.append(fo_pos[cols_g])
        ev_list.append(vals_g)
        rev_sel = slice(None)

    if conv_type != "SAGE":  # self-loops (mapper lines 182-185)
        er_list.append(np.arange(B))
        ec_list.append(np.arange(B))
        ev_list.append(deg_inv[node_idx].astype(np.float32) * gcn_mult)

    if train_flag:
        if conv_type != "GCN" and recovery_flag:
            rv_all = (vals_g * deg[rows_g] * deg_inv[cols_g]).astype(np.float32)
            sel_in = ~nbr_out
            rev = (
                np.concatenate([pos[rows_g], pos[cols_g[sel_in]]]).astype(np.int64),
                np.concatenate([cols_g, rows_g[sel_in]]).astype(np.int64),
                np.concatenate([rv_all, -vals_g[sel_in]]).astype(np.float32),
            )
        else:
            rj = cols_g[rev_sel]  # B'-row reverse edges, exactly per-edge
            ri = rows_g[rev_sel]
            if conv_type == "GCN":
                rv = vals_g[rev_sel]
            else:
                rv = (vals_g[rev_sel] * deg[ri] * deg_inv[rj]).astype(np.float32)
            er_list.append(fo_pos[rj])
            ec_list.append(pos[ri])
            ev_list.append(rv)

    er = np.concatenate(er_list)
    ec = np.concatenate(ec_list)
    ev = np.concatenate(ev_list).astype(np.float32)
    return fo_ids, er, ec, ev, rev


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
        with_link_edges: bool = False,
        node_range: Optional[Tuple[int, int]] = None,
    ):
        check_ported(cfg)
        self.with_link_edges = with_link_edges
        # data parallelism: this rank draws its batch seeds from its own
        # nodes [lo, hi) (parallel/multihost.py); walks and neighbours may
        # leave the range, and those nodes enter as codebook rows
        self.node_range = node_range
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
        if st == "cluster" and node_range is not None:
            raise ValueError(
                "node_range with the cluster sampler: partition hosts by "
                "clusters instead (give each process its own cluster_indices)"
            )
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
        self._E_bucket = 0
        self._S_bucket = 0
        self._St_bucket = 0
        self._Sm_bucket = self._Stm_bucket = (0, 0)  # mixed-K (head, tail) slots
        self._R_bucket = 0  # the raw reverse list beside COO (B + M)
        self._tb_bucket = {"multiple": max(cfg.pad_multiple_edges // cfg.ell_K, 64)}
        self._rev_bucket = {}  # rev-ELL slot count high-water mark (B + M)
        self._L_bucket = 0  # in-batch link edges (with_link_edges)

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

        pool = np.arange(*self.node_range) if self.node_range is not None else np.arange(self.N)
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

    def _pad_sizes(self, B, Bp, E):
        if self.cfg.fixed_B_pad:  # data-parallel: one set of shapes on every rank
            return self.cfg.fixed_B_pad, self.cfg.fixed_Bp_pad, self.cfg.fixed_E_pad
        mn, me = self.cfg.pad_multiple_nodes, self.cfg.pad_multiple_edges
        self._B_bucket = max(self._B_bucket, round_up(B, mn))
        self._Bp_bucket = max(self._Bp_bucket, round_up(max(Bp, 1), mn))
        self._E_bucket = max(self._E_bucket, round_up(max(E, 1), me))
        return self._B_bucket, self._Bp_bucket, self._E_bucket

    def _slot_pad(self, er, K, dim_pad, attr):
        ms = max(self.cfg.pad_multiple_edges // K, 64)
        if self.cfg.fixed_B_pad:
            # fixed pads: a bound every rank computes alike (E/K full slots
            # and at most one partial or empty slot a row)
            cfg = self.cfg
            return round_up(cfg.fixed_E_pad // K + cfg.fixed_B_pad + cfg.fixed_Bp_pad + 1, ms)
        # dense-rows ELL: every one of the dim_pad local rows owns >= 1 slot
        deg = np.bincount(er, minlength=dim_pad)
        nnz_rows = int((deg > 0).sum())
        S = int(((deg + K - 1) // K).sum()) + (dim_pad - nnz_rows)
        bucket = max(getattr(self, attr), round_up(max(S, 1), ms))
        setattr(self, attr, bucket)
        return bucket

    def _mixed_slot_pads(self, er, K, Kt, dim_pad, attr):
        """(Sh_pad, St2_pad) for the mixed-K families (head full K-slots,
        dense Kt tail): monotone high-water buckets like _slot_pad
        (``vq_gnn_tpu/sampler/samplers.py:421-440``)."""
        ms = max(self.cfg.pad_multiple_edges // K, 64)
        mst = max(self.cfg.pad_multiple_edges // Kt, 64)
        if self.cfg.fixed_B_pad:  # fixed pads: bounds every rank computes alike
            cfg = self.cfg
            return (round_up(cfg.fixed_E_pad // K + 1, ms),
                    round_up(cfg.fixed_B_pad + cfg.fixed_Bp_pad + cfg.fixed_E_pad // Kt + 1, mst))
        deg = np.bincount(er, minlength=dim_pad)
        Sh = int((deg // K).sum())
        St2 = int(np.maximum((deg % K + Kt - 1) // Kt, 1).sum())
        b = getattr(self, attr)
        bucket = (max(b[0], round_up(max(Sh, 1), ms)), max(b[1], round_up(max(St2, 1), mst)))
        setattr(self, attr, bucket)
        return bucket

    def _rev_pad(self, rev):
        if rev is None:
            return 0
        self._R_bucket = max(self._R_bucket,
                             round_up(max(len(rev[0]), 1), self.cfg.pad_multiple_edges))
        return self._R_bucket

    def _build(self, node_idx: np.ndarray) -> PaddedBatch:
        g, cfg = self.graph, self.cfg
        rev = None
        if cfg.formulation == "bm":
            fo_ids, er, ec, ev, rev = bm_subgraph(
                self.rowptr, self.col, self.val, g.deg, g.deg_inv, node_idx, self.N,
                cfg.conv_type, cfg.recovery_flag, self.train_flag,
                exact_minibatch=cfg.exact_minibatch,
            )
        else:
            fo_ids, er, ec, ev = k_hop_subgraph(
                self.rowptr, self.col, self.val, node_idx, self.N, self.train_flag
            )
        B_pad, Bp_pad, E_pad = self._pad_sizes(len(node_idx), len(fo_ids), len(er))
        dim_pad = B_pad + Bp_pad
        ell = cfg.spmm_backend == "ell"
        # the layout (vq_gnn_tpu/sampler/samplers.py:479-556): mixed-K
        # serves the spmm convs and the B + B' GAT conv; the B + M GAT conv
        # mirrors per-cell values through f_from_t, a map of the single-K
        # ELL only, so it keeps single-K under ell_Kt > 0, as there
        if ell and cfg.ell_Kt > 0 and not (cfg.conv_type == "GAT" and cfg.formulation == "bm"):
            K, Kt = cfg.ell_K, cfg.ell_Kt
            layout = dict(ell_K=K, ell_Kt=Kt, mixed_pads=(
                self._mixed_slot_pads(er, K, Kt, dim_pad, "_Sm_bucket")
                + self._mixed_slot_pads(ec, K, Kt, dim_pad, "_Stm_bucket")))
        elif ell:
            K = cfg.ell_K
            layout = dict(ell_K=K, S_pad=self._slot_pad(er, K, dim_pad, "_S_bucket"),
                          St_pad=self._slot_pad(ec, K, dim_pad, "_St_bucket"))
        else:
            layout = {}
        L_pad = 0
        if self.with_link_edges:
            n_link = int(((er < len(node_idx)) & (ec < len(node_idx))).sum())
            self._L_bucket = max(self._L_bucket, round_up(max(n_link, 1), 1024))
            L_pad = self._L_bucket
        return build_padded_batch(
            node_idx,
            fo_ids,
            er,
            ec,
            ev,
            self.N,
            B_pad,
            Bp_pad,
            y=None if g.y is None else g.y[node_idx],
            train_mask=None if g.train_mask is None else g.train_mask[node_idx],
            # backward truncation (either ELL layout): x rows >= B_pad are
            # codebook lookups whose cotangent flows only into the
            # non-differentiated VQ state; fixed pads keep the full VJP, as
            # the JAX package does (its bound is a bucket, not a fixed size)
            t_b_bucket=(self._tb_bucket if ell and self.train_flag and not cfg.fixed_B_pad
                        else None),
            # the B + M GAT conv's backward mirrors per-cell values through it
            with_f_from_t=cfg.formulation == "bm" and cfg.conv_type == "GAT",
            bm_rev=rev,
            # the reverse list as rev-ELL slots beside an ELL adjacency, raw
            # beside COO (whose recovery term takes the grid path, as the
            # JAX package's tests pin it)
            rev_bucket=self._rev_bucket if ell else None,
            R_pad=self._rev_pad(rev),
            # the GAT backward walks every transposed row: kernel 5 on B + B',
            # the per-branch conv's segment sums (kernel 8) on B + M, and
            # kernel 8 per family on the mixed layout
            with_t_all_lists=cfg.conv_type == "GAT",
            with_link_edges=self.with_link_edges,
            L_pad=L_pad,
            E_pad=E_pad,
            **layout,
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
