"""Node-classification trainer — the reference ``main_node.py`` loop (port of
``vq_gnn_tpu/train/loop.py``).

Layerwise codebook init sweep over the test loader, per-epoch training with
the warm-up rate and the linear lr ramp, stochastic batched evaluation,
exact full-graph inference (``full_graph_predict``), and ``fit``: the whole
run, logged per epoch (with the per-layer VQ health lines on request).
Multilabel graphs train with BCE and are scored by micro-F1; inductive
datasets (``val_graph``/``test_graph``) evaluate each split graph as one
full batch, or stochastically into a per-split codeword table
(``evaluate_split_stochastic``).
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from vq_gnn_tpu_torch.config import (
    Config,
    apply_matmul_precision,
    not_ported,
    resolve_device,
)
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.nn.model import ModelStatic, full_graph_inference, model_static
from vq_gnn_tpu_torch.ops.spmm import make_edges
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
from vq_gnn_tpu_torch.train.state import TrainState, init_train_state
from vq_gnn_tpu_torch.train.step import make_step_fns
from vq_gnn_tpu_torch.utils.diagnostics import codebook_stats
from vq_gnn_tpu_torch.utils.logger import Logger
from vq_gnn_tpu_torch.utils.metrics import accuracy, micro_f1


def device_features(x: np.ndarray, device) -> torch.Tensor:
    """[N+1, F] feature table with a zero dustbin row for padded slots."""
    return torch.as_tensor(np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)])).to(device)


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
        self._test_batches = None  # the eval loader is deterministic: built once
        self._split_batches = {}  # the inductive splits' full batches, built once
        if self.inductive:
            self._split_loaders = {
                name: (BatchLoader(gr, cfg, train_flag=False, sampler_type="node",
                                   batch_size=gr.num_nodes, shuffle=False, seed=cfg.seed + 3,
                                   device=self.device),
                       device_features(gr.x, self.device), gr)
                for name, gr in (("train", graph), ("val", val_graph), ("test", test_graph))
            }

    def test_batches(self):
        if self._test_batches is None:
            self._test_batches = list(self.test_loader)
        return self._test_batches

    def split_batches(self, name: str):
        """The inductive split's one full batch (a list of (windows, raw))."""
        if name not in self._split_batches:
            self._split_batches[name] = list(self._split_loaders[name][0])
        return self._split_batches[name]

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
        if cfg.sche:
            return cfg.lr * epoch / 200 if epoch < 200 else cfg.lr
        return cfg.lr

    # ---- one training epoch (main_node.py v2:39-122) ----
    def train_epoch(self, epoch: int, verbose: bool = False):
        wur = self.warm_up_rate(epoch)
        lr = self.lr_at(epoch)
        have_train_mask = self.graph.train_mask is not None
        losses, losses_cls = [], []
        for windows, raw_idx in self.train_loader:
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
        """The init sweep, then per epoch ``train_epoch``, ``evaluate`` and
        ``logger.add_result``, with ``vq_diagnostics`` each logged epoch's
        per-layer VQ health lines (``print_vq_diagnostics``); returns
        ``logger.statistics(run)``.  Checkpoints are not ported and raise
        (``kmeans_init`` is refused when the trainer is built)."""
        if ckpt_dir or resume:
            raise not_ported("checkpoints (ckpt_dir, resume)", "queue 1 item 8")
        cfg = self.cfg
        self.run_init_sweep(verbose=verbose)
        if verbose:
            print("init done")
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.time()
            loss, loss_cls = self.train_epoch(epoch)
            result = self.evaluate()
            self.logger.add_result(run, result)
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
