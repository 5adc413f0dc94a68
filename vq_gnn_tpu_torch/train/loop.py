"""Node-classification trainer — the reference ``main_node.py`` loop (port of
``vq_gnn_tpu/train/loop.py``).

Layerwise codebook init sweep over the test loader (after the optional
MiniBatchKMeans seeding, ``seed_kmeans``), per-epoch training with the
warm-up rate and the linear lr ramp, stochastic batched evaluation, exact
full-graph inference (``full_graph_predict``), and ``fit``: the whole run,
logged per epoch (with the per-layer VQ health lines on request),
checkpointed every ``ckpt_every`` epochs and resumable.  Deterministic
loaders go through a device-side batch cache (``iter_cached``).
Multilabel graphs train with BCE and are scored by micro-F1; inductive
datasets (``val_graph``/``test_graph``) evaluate each split graph as one
full batch, or stochastically into a per-split codeword table
(``evaluate_split_stochastic``).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch

from vq_gnn_tpu_torch.config import Config, apply_matmul_precision, resolve_device
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.nn.model import (
    ModelStatic,
    full_graph_inference,
    model_forward,
    model_static,
)
from vq_gnn_tpu_torch.nn.vq import feature_kmeans_init
from vq_gnn_tpu_torch.ops.spmm import make_edges
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
from vq_gnn_tpu_torch.train.checkpoint import load_step, restore_checkpoint, save_checkpoint
from vq_gnn_tpu_torch.train.state import TrainState, init_train_state
from vq_gnn_tpu_torch.train.step import _branch_view, make_step_fns
from vq_gnn_tpu_torch.utils.diagnostics import codebook_stats
from vq_gnn_tpu_torch.utils.logger import Logger
from vq_gnn_tpu_torch.utils.metrics import accuracy, micro_f1
from vq_gnn_tpu_torch.utils.scheduler import linear_ramp


def device_features(x: np.ndarray, device) -> torch.Tensor:
    """[N+1, F] feature table with a zero dustbin row for padded slots."""
    return torch.as_tensor(np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)])).to(device)


def iter_cached(cache: dict, name: str, loader) -> list:
    """The batches of a DETERMINISTIC loader, built and moved to the device
    on the first pass and kept under ``name`` in ``cache``; later passes
    return the same list (``vq_gnn_tpu/train/loop.py:32-52``, without its
    host-memory switch and cap, which fence a TPU-runtime leak)."""
    if name not in cache:
        cache[name] = list(loader)
    return cache[name]


class NodeTrainer:
    def __init__(
        self,
        graph: HostGraph,
        cfg: Config,
        num_classes: int,
        cluster_indices=None,
        device: Union[str, torch.device, None] = None,
        use_ogb_acc: Optional[bool] = None,
        val_graph: Optional[HostGraph] = None,
        test_graph: Optional[HostGraph] = None,
    ):
        self.device = resolve_device(device)
        apply_matmul_precision(cfg)
        # inductive datasets (ppi/cluster): separate val/test graphs, each
        # evaluated as ONE full batch, so B' is empty and the codebooks are
        # bypassed (reference main_node.py v2:158-171, 191-200, 276-281)
        self.val_graph, self.test_graph = val_graph, test_graph
        self.inductive = val_graph is not None
        self.graph = graph
        self.cfg = cfg
        self.multilabel = graph.y is not None and graph.y.ndim > 1 and graph.y.shape[1] > 1
        self.ms: ModelStatic = model_static(cfg, graph.num_features, num_classes, self.device)
        self.X_dev = device_features(graph.x, self.device)
        self.use_ogb_acc = use_ogb_acc if use_ogb_acc is not None else not self.multilabel
        if cfg.exact_eval_train_edges and 0 < cfg.test_batch_size < graph.num_nodes:
            # only valid when eval batches cover the whole graph: partial
            # batches would route out-of-batch messages through frozen codebooks
            raise ValueError(
                "exact_eval_train_edges requires full-graph eval batches "
                f"(test_batch_size {cfg.test_batch_size} < num_nodes {graph.num_nodes})"
            )
        self.train_loader = BatchLoader(
            graph, cfg, train_flag=True, cluster_indices=cluster_indices, seed=cfg.seed,
            device=self.device,
        )
        test_sampler = "cluster" if cluster_indices is not None else "node"
        self.test_loader = BatchLoader(
            graph,
            cfg,
            # the exact control evaluates through the train-time edge
            # construction (Config.exact_eval_train_edges)
            train_flag=cfg.exact_eval_train_edges,
            sampler_type=test_sampler,
            cluster_indices=cluster_indices,
            batch_size=cfg.test_batch_size,
            shuffle=False,
            seed=cfg.seed + 1,
            device=self.device,
        )
        self.fns = make_step_fns(self.ms, cfg, self.multilabel)
        self.state: TrainState = init_train_state(
            torch.Generator().manual_seed(cfg.seed), self.ms, graph.num_nodes, cfg.lr,
            self.device,
        )
        # dropout masks are drawn on the device, from their own stream
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 17)
        self.logger = Logger(cfg.runs, cfg)
        # the eval loaders are deterministic (shuffle off), and so is the
        # train loader of the exact full-graph control (one batch, the whole
        # graph): their batches are built once (iter_cached)
        self._batch_cache = {}
        self._cache_train = cfg.sampler_type == "node" and cfg.batch_size >= graph.num_nodes
        if self.inductive:
            self._split_loaders = {
                name: (BatchLoader(gr, cfg, train_flag=False, sampler_type="node",
                                   batch_size=gr.num_nodes, shuffle=False, seed=cfg.seed + 3,
                                   device=self.device),
                       device_features(gr.x, self.device), gr)
                for name, gr in (("train", graph), ("val", val_graph), ("test", test_graph))
            }

    def test_batches(self):
        return iter_cached(self._batch_cache, "test", self.test_loader)

    def split_batches(self, name: str):
        """The inductive split's one full batch (a list of (windows, raw))."""
        return iter_cached(self._batch_cache, f"split_{name}", self._split_loaders[name][0])

    # ---- layerwise codebook bootstrap (main_node.py v2:17-37) ----
    def run_init_sweep(self, verbose: bool = False):
        for layer_idx in range(1, self.ms.num_layers + 1):
            if verbose:
                print(f"init sweep layer {layer_idx}")
            step = self.fns.init_step_for(layer_idx)
            for windows, _ in self.test_batches():
                self.state.vq_states, self.state.vq_states_tr = step(
                    self.state.vq_states, self.state.vq_states_tr, self.state.model,
                    self.X_dev, windows[0])

    def warm_up_rate(self, epoch: int) -> float:
        cfg = self.cfg
        if cfg.warm_up and epoch <= cfg.warm_up_epochs:
            return epoch / cfg.warm_up_epochs
        return 1.0

    def lr_at(self, epoch: int) -> float:
        cfg = self.cfg
        return linear_ramp(cfg.lr, epoch) if cfg.sche else cfg.lr

    # ---- one training epoch (main_node.py v2:39-122) ----
    def train_epoch(self, epoch: int, verbose: bool = False):
        wur = self.warm_up_rate(epoch)
        lr = self.lr_at(epoch)
        have_train_mask = self.graph.train_mask is not None
        losses, losses_cls = [], []
        train_iter = self.train_loader
        if self._cache_train:
            train_iter = iter_cached(self._batch_cache, "train", self.train_loader)
        for windows, raw_idx in train_iter:
            for j, batch in enumerate(windows):
                if have_train_mask:
                    n_train = int(self.graph.train_mask[raw_idx[j]].sum())
                    if n_train <= 0:  # skip unlabeled batches (v2:60-63)
                        continue
                do_opt = 0.0 if (len(windows) > 1 and j == 0) else 1.0
                self.state, metrics = self.fns.train_step(
                    self.state, self.X_dev, batch, wur, lr, do_opt, self.generator
                )
                losses.append(float(metrics["loss"]))
                losses_cls.append(float(metrics["loss_cls"]))
                if bool(metrics["bad_init"]):
                    raise ValueError("Bad Init!")
                if verbose:
                    print(
                        f"batch window {j}: loss {losses[-1]:.4f} "
                        f"acc {float(metrics['train_acc']):.4f}"
                    )
        return float(np.mean(losses)), float(np.mean(losses_cls))

    # ---- stochastic batched evaluation (main_node.py v2:125-156) ----
    def predict_all(self) -> np.ndarray:
        outs = []
        for windows, raw_idx in self.test_batches():
            out = self.fns.eval_step(self.state, self.X_dev, windows[0])
            outs.append(out[: len(raw_idx[0])].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def evaluate(self):
        """(train, valid, test): accuracy, or micro-F1 where ``use_ogb_acc``
        is off; inductive runs score each split graph's full batch."""
        if self.inductive:
            results = []
            for name in ("train", "val", "test"):
                _, X_dev, gr = self._split_loaders[name]
                outs = [self.fns.eval_step(self.state, X_dev, windows[0])[: len(raw[0])]
                        .cpu().numpy() for windows, raw in self.split_batches(name)]
                results.append(micro_f1(np.concatenate(outs, axis=0), gr.y))
            return tuple(results)
        outs = self.predict_all()
        g = self.graph
        metric = accuracy if self.use_ogb_acc else micro_f1
        y = g.y.reshape(-1) if self.use_ogb_acc and g.y.ndim > 1 else g.y
        return (
            metric(outs, y, g.train_mask),
            metric(outs, y, g.val_mask),
            metric(outs, y, g.test_mask),
        )

    # ---- inductive stochastic eval with per-split c tables ----
    def evaluate_split_stochastic(self, graph: HostGraph, batch_size: int) -> np.ndarray:
        """v1-inductive-style eval on another graph: assignments recomputed
        per batch into a fresh per-split codeword table (SURVEY §3.3);
        returns the logits of its nodes."""
        loader = BatchLoader(graph, self.cfg, train_flag=False, sampler_type="node",
                             batch_size=batch_size, shuffle=False, seed=self.cfg.seed + 7,
                             device=self.device)
        X_dev = device_features(graph.x, self.device)
        c_tables = [torch.zeros((graph.num_nodes + 1, nb), dtype=torch.int16, device=self.device)
                    for nb in self.ms.num_branches]
        outs = []
        for windows, raw in loader:
            out, c_tables = self.fns.eval_assign_step(self.state, c_tables, X_dev, windows[0])
            outs.append(out[: len(raw[0])].cpu().numpy())
        return np.concatenate(outs, axis=0)

    # ---- exact full-graph inference (codebooks bypassed) ----
    def full_graph_predict(self) -> np.ndarray:
        """v1 ``LowRankGNN.inference`` (v1/models.py:486-504): one plain conv
        stack over the whole normalized adjacency with the learned weights."""
        g = self.graph
        row, col, val = g.coo()
        edges = make_edges(row, col, val, g.num_nodes).to(self.device)
        x = torch.as_tensor(g.x).to(self.device)
        out = full_graph_inference(self.state.model, self.state.bn_state, self.ms, x, edges)
        return out.cpu().numpy()

    # ---- optional MiniBatchKMeans codebook seeding (reference --kmeans-init,
    # v1/models.py:147-159) ----
    def seed_kmeans(self):
        """Seeds each layer's feature half by k-means (``feature_kmeans_init``)
        on the first eval batch's valid rows: layer 0 on the raw features,
        layer l on the output of the first l layers, each with its
        activation and no BN (``model_forward(num_layers_to_run=l,
        with_bn_act=False)``), through the codebooks seeded so far
        (``vq_gnn_tpu/train/loop.py:280-313``).  ``kmeans_iter`` is unused, as
        there.  Needs scikit-learn (an ImportError names it otherwise)."""
        windows, _ = self.test_batches()[0]
        batch = windows[0]
        x = self.X_dev.index_select(0, batch.batch_idx)
        B = int(batch.num_B)
        for l in range(self.ms.num_layers):
            x_l = x
            if l > 0:
                with torch.no_grad():
                    x_l, _, _, _ = model_forward(
                        self.state.model, self.state.vq_states, self.state.bn_state, self.ms,
                        x, batch, num_layers_to_run=l, with_bn_act=False)
            Xb = _branch_view(x_l, self.ms.num_branches[l], self.ms.num_D)[:, :B]
            self.state.vq_states[l] = feature_kmeans_init(
                self.state.vq_states[l], Xb, batch.batch_idx[:B], self.ms.vq)

    # ---- full run (main_node.py v2:233-308) ----
    def fit(
        self,
        run: int = 0,
        verbose: bool = True,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        resume: bool = False,
        vq_diagnostics: bool = False,
    ):
        """``seed_kmeans`` with ``kmeans_init``, the init sweep, then per
        epoch ``train_epoch``, ``evaluate`` and ``logger.add_result``, with
        ``vq_diagnostics`` each logged epoch's per-layer VQ health lines
        (``print_vq_diagnostics``); returns ``logger.statistics(run)``.

        With ``ckpt_dir`` the train state is saved to
        ``<ckpt_dir>/run<run>.npz`` (``train/checkpoint.py``, the JAX
        package's archive) after each ``ckpt_every``-th epoch's evaluation,
        under that epoch's number.  With ``resume`` too, an archive found
        there is restored and the run goes on at the next epoch, without the
        k-means seeding and the init sweep.  As in the JAX package
        (``vq_gnn_tpu/train/loop.py:346-387``) only the train state is
        restored: the dropout generator, the train loader's epoch cursor
        (``BatchLoader._epoch``) and the logger's history start anew."""
        cfg = self.cfg
        ckpt_path, start_epoch = None, 1
        if ckpt_dir:
            ckpt_path = os.path.join(ckpt_dir, f"run{run}.npz")
            if resume and os.path.exists(ckpt_path):
                self.state = restore_checkpoint(ckpt_path, self.state)
                start_epoch = load_step(ckpt_path) + 1  # the stored epoch number
                if verbose:
                    print(f"resumed from {ckpt_path} at epoch {start_epoch}")
        if start_epoch == 1:
            if cfg.kmeans_init:
                self.seed_kmeans()
            self.run_init_sweep(verbose=verbose)
            if verbose:
                print("init done")
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.time()
            loss, loss_cls = self.train_epoch(epoch)
            result = self.evaluate()
            self.logger.add_result(run, result)
            if ckpt_path and epoch % ckpt_every == 0:
                save_checkpoint(ckpt_path, self.state, step=epoch)
            if verbose and epoch % cfg.log_steps == 0:
                tr, va, te = result
                print(
                    f"Run: {run + 1}, Epoch: {epoch}, Loss: {loss:.4f}, "
                    f"Loss Cls: {loss_cls:.4f}, Train: {100 * tr:.2f}%, "
                    f"Valid: {100 * va:.2f}%, Test: {100 * te:.2f}% "
                    f"[{time.time() - t0:.1f}s]"
                )
                if vq_diagnostics:
                    self.print_vq_diagnostics(epoch)
        return self.logger.statistics(run)

    def print_vq_diagnostics(self, epoch: int):
        """Per-layer VQ health (the reference's exp_log catalogue,
        utils/logger.py:89-232)."""
        for l, s in enumerate(self.state.vq_states):
            st = codebook_stats(s, self.ms.vq)
            print(
                f"  [vq L{l}] eff_codewords="
                f"{np.mean(st['effective_codewords']):.1f}/{self.ms.vq.num_M} "
                f"size_min={st['cluster_size_min'].min():.3g} "
                f"feat_std={np.mean(st['feat_std_per_dim']):.3f} "
                f"grad_std={np.mean(st['grad_std_per_dim']):.3f}"
            )
