"""VQ-vs-exact convergence parity harness (port of
``vq_gnn_tpu/train/parity.py``).

The paper's central claim (arXiv:2110.14363) is that VQ-GNN mini-batch
training converges to the accuracy of exact full-graph training.  This
harness tests it offline on synthetic SBM graphs at configurable scale:

- **exact control**: the same LowRankGNN, optimizer, schedule and seed,
  trained full-graph.  One batch covering every node means B' is empty, all
  messages use exact features and the codebooks never enter the forward;
  ``ce_only`` drops the ``info_backward`` term.
- **exact mini-batch control** (``exact_mb_config``): the VQ arm's own
  sampler, batches, lr and update count, with messages on the exact in-batch
  edges alone.
- **VQ run**: the mini-batch config under test (``vq_update_mode='live'``).

Every function takes ``device`` (default: the GPU; ``'cpu'`` runs the plain
PyTorch path).  The JAX package's ``segment_path``, ``max_rss_mb`` and
``segment_dir`` are left out: they fence a host-memory leak of the TPU
runtime's transfers (``vq_gnn_tpu/train/segment.py``), which this port has
no counterpart of and does not port.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from vq_gnn_tpu_torch.config import Config
from vq_gnn_tpu_torch.graph.datasets import prepare
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.utils.diagnostics import codebook_stats


def _vq_health_record(tr: NodeTrainer, epoch: int, prev):
    """One JSONL record of per-layer codebook health (usage floor/entropy,
    assignment churn against the previous snapshot, codeword drift)."""
    layers = []
    nxt: List[Tuple[np.ndarray, np.ndarray]] = []
    for l, s in enumerate(tr.state.vq_states):
        st = codebook_stats(s, tr.ms.vq)
        c = s.c_indices.cpu().numpy()[:-1, :]  # [N, nb] (dustbin row dropped)
        emb = s.embedding.cpu().numpy()  # [nb, M, 2D]
        churn = drift = None
        if prev is not None:
            pc, pe = prev[l]
            churn = float((c != pc).mean())
            drift = float(np.linalg.norm(emb - pe) / max(np.linalg.norm(pe), 1e-12))
        layers.append(
            {
                "layer": l,
                "eff_codewords": float(np.mean(st["effective_codewords"])),
                "cluster_size_min": float(st["cluster_size_min"].min()),
                "cluster_size_max": float(st["cluster_size_max"].max()),
                "feat_std": float(np.mean(st["feat_std_per_dim"])),
                "grad_std": float(np.mean(st["grad_std_per_dim"])),
                "churn": churn,
                "codeword_drift": drift,
            }
        )
        nxt.append((c, emb))
    return {"epoch": epoch, "layers": layers}, nxt


def exact_config(cfg: Config, num_nodes: int, lr: Optional[float] = None) -> Config:
    """The exact full-graph control of a VQ config: node sampler with
    batch_size == num_nodes (one batch, B' empty), ``ce_only`` (no recovery
    term), 'reference' update mode (the unused codebooks frozen), and eval
    through the train-time edges.  ``lr`` overrides the control's learning
    rate: it takes one optimizer step per epoch."""
    return dataclasses.replace(
        cfg,
        sampler_type="node",
        batch_size=num_nodes,
        test_batch_size=num_nodes,
        num_parts=1,
        ce_only=True,
        vq_update_mode="reference",
        warm_up=False,
        lr=cfg.lr if lr is None else lr,
        exact_eval_train_edges=True,
    )


def exact_mb_config(cfg: Config, num_nodes: int) -> Config:
    """Convergence-matched mini-batch control: the VQ arm's sampler, batches,
    lr and update count, messages on the exact in-batch edges alone
    (``Config.exact_minibatch``); eval stays exact full-graph."""
    return dataclasses.replace(
        cfg,
        exact_minibatch=True,
        ce_only=True,
        vq_update_mode="reference",
        warm_up=False,
        test_batch_size=num_nodes,
        exact_eval_train_edges=True,
    )


def train_to_acc(
    graph_fn: Callable[[], Tuple[HostGraph, int]],
    cfg: Config,
    epochs: int,
    eval_every: int = 1,
    verbose: bool = False,
    diag_path: Optional[str] = None,
    device=None,
    trainers: Optional[List[NodeTrainer]] = None,
) -> Dict[str, object]:
    """Train one config from scratch; return best-by-valid statistics and the
    history of (epoch, loss_cls, train, valid, test) at each evaluation.
    ``trainers``, when given, gets the trainer appended (its trained state
    and graph).

    graph_fn must return a *fresh* (HostGraph, num_classes) each call:
    ``prepare`` normalises and permutes in place."""
    g, c = graph_fn()
    g, c, ci = prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, cluster_indices=ci, device=device)
    if trainers is not None:
        trainers.append(tr)
    history = []
    tr.run_init_sweep()
    diag_prev, diag_f = None, None
    if diag_path:
        diag_f = open(diag_path, "w")
    t0 = time.time()
    try:
        for epoch in range(1, epochs + 1):
            _, loss_cls = tr.train_epoch(epoch)
            if epoch % eval_every == 0 or epoch == epochs:
                res = tr.evaluate()
                tr.logger.add_result(0, res)
                history.append((epoch, loss_cls) + res)
                if diag_f is not None:
                    rec, diag_prev = _vq_health_record(tr, epoch, diag_prev)
                    rec["loss_cls"] = float(loss_cls)
                    rec["train"], rec["valid"], rec["test"] = map(float, res)
                    diag_f.write(json.dumps(rec) + "\n")
                    diag_f.flush()
                if verbose:
                    print(
                        f"  epoch {epoch}: loss {loss_cls:.4f} "
                        f"train {res[0]:.4f} valid {res[1]:.4f} test {res[2]:.4f} "
                        f"[{time.time() - t0:.1f}s]",
                        flush=True,
                    )
    finally:
        if diag_f is not None:
            diag_f.close()
    stats = tr.logger.statistics(0)
    return {
        "best_valid": stats["highest_valid"] / 100.0,
        "test_at_best_valid": stats["final_test"] / 100.0,
        "final_test": history[-1][4],
        "history": history,
    }


def parity_gap(
    graph_fn: Callable[[], Tuple[HostGraph, int]],
    vq_cfg: Config,
    epochs: int,
    eval_every: int = 1,
    exact_epochs: Optional[int] = None,
    verbose: bool = False,
    vq_diag_path: Optional[str] = None,
    exact_lr: Optional[float] = None,
    arms: str = "both",  # both=exact+vq | all=3 arms | mb=exact_mb+vq | single-arm values
    device=None,
    trainers: Optional[Dict[str, NodeTrainer]] = None,
) -> Dict[str, object]:
    """Train exact full-graph and live-VQ mini-batch from the same seed;
    return the arms' results and the test-accuracy gaps (exact - vq,
    exact_mb - vq).  ``arms`` picks the arms; an arm not run is None and its
    gap NaN.  ``trainers``, when given, gets each arm's trained NodeTrainer
    under the arm's key."""
    num_nodes = graph_fn()[0].num_nodes
    exact = exact_mb = vq = None

    def _arm(key, cfg_, n_epochs, diag=None):
        kept: List[NodeTrainer] = []
        res = train_to_acc(graph_fn, cfg_, n_epochs, eval_every, verbose, diag_path=diag,
                           device=device, trainers=kept)
        if trainers is not None:
            trainers[key] = kept[0]
        return res

    if arms in ("both", "all", "exact"):
        ex_cfg = exact_config(vq_cfg, num_nodes, lr=exact_lr)
        if verbose:
            print(f"[parity] exact full-graph ({vq_cfg.conv_type}, lr={ex_cfg.lr}) ...",
                  flush=True)
        exact = _arm("exact", ex_cfg, exact_epochs or epochs)
    if arms in ("all", "mb", "exact_mb"):
        if verbose:
            print(f"[parity] exact mini-batch control ({vq_cfg.conv_type}/"
                  f"{vq_cfg.sampler_type}, in-batch edges only) ...", flush=True)
        exact_mb = _arm("exact_mb", exact_mb_config(vq_cfg, num_nodes), epochs)
    if arms in ("both", "all", "mb", "vq"):
        if verbose:
            print(f"[parity] VQ mini-batch ({vq_cfg.conv_type}/{vq_cfg.sampler_type}) ...",
                  flush=True)
        vq = _arm("vq", vq_cfg, epochs, diag=vq_diag_path)
    gap = (
        exact["test_at_best_valid"] - vq["test_at_best_valid"]
        if exact is not None and vq is not None
        else float("nan")
    )
    gap_mb = (
        exact_mb["test_at_best_valid"] - vq["test_at_best_valid"]
        if exact_mb is not None and vq is not None
        else float("nan")
    )
    return {
        "exact": exact,
        "exact_mb": exact_mb,
        "vq": vq,
        "gap": float(gap),
        "gap_mb": float(gap_mb),
    }

