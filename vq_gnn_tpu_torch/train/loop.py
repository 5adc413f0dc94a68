"""Node-classification trainer — the reference ``main_node.py`` loop (port of
``vq_gnn_tpu/train/loop.py``, transductive path).

Layerwise codebook init sweep over the test loader, per-epoch training with
the warm-up rate and the linear lr ramp, stochastic batched evaluation, and
``fit``: the whole run, logged per epoch.
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
from vq_gnn_tpu_torch.nn.model import ModelStatic, model_static
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
from vq_gnn_tpu_torch.train.state import TrainState, init_train_state
from vq_gnn_tpu_torch.train.step import make_step_fns
from vq_gnn_tpu_torch.utils.logger import Logger


def accuracy(logits: np.ndarray, y: np.ndarray, mask=None) -> float:
    """OGB node-property accuracy: argmax match rate (copy of
    ``vq_gnn_tpu/utils/metrics.py:accuracy``)."""
    if mask is not None:
        logits, y = logits[mask], y[mask]
    if len(y) == 0:
        return 0.0
    return float((logits.argmax(axis=-1) == y).mean())


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
    ):
        self.device = resolve_device(device)
        apply_matmul_precision(cfg)
        self.graph = graph
        self.cfg = cfg
        if graph.y is not None and graph.y.ndim > 1 and graph.y.shape[1] > 1:
            raise not_ported("multilabel training (BCE loss, micro-F1)")
        self.ms: ModelStatic = model_static(cfg, graph.num_features, num_classes, self.device)
        self.X_dev = device_features(graph.x, self.device)
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
        self.fns = make_step_fns(self.ms, cfg)
        self.state: TrainState = init_train_state(
            torch.Generator().manual_seed(cfg.seed), self.ms, graph.num_nodes, cfg.lr,
            self.device,
        )
        # dropout masks are drawn on the device, from their own stream
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 17)
        self.logger = Logger(cfg.runs, cfg)
        self._test_batches = None  # the eval loader is deterministic: built once

    def test_batches(self):
        if self._test_batches is None:
            self._test_batches = list(self.test_loader)
        return self._test_batches

    # ---- layerwise codebook bootstrap (main_node.py v2:17-37) ----
    def run_init_sweep(self, verbose: bool = False):
        for layer_idx in range(1, self.ms.num_layers + 1):
            if verbose:
                print(f"init sweep layer {layer_idx}")
            step = self.fns.init_step_for(layer_idx)
            for windows, _ in self.test_batches():
                self.state.vq_states = step(
                    self.state.vq_states, self.state.model, self.X_dev, windows[0]
                )

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
        outs = self.predict_all()
        g = self.graph
        return (
            accuracy(outs, g.y, g.train_mask),
            accuracy(outs, g.y, g.val_mask),
            accuracy(outs, g.y, g.test_mask),
        )

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
        ``logger.add_result``; returns ``logger.statistics(run)``.
        Checkpoints and the per-epoch VQ health lines are not ported and
        raise (``kmeans_init`` is refused when the trainer is built)."""
        if ckpt_dir or resume:
            raise not_ported("checkpoints (ckpt_dir, resume)", "queue 1 item 8")
        if vq_diagnostics:
            raise not_ported("vq_diagnostics (utils/diagnostics.codebook_stats)",
                             "queue 1 items 3 and 8")
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
        return self.logger.statistics(run)
