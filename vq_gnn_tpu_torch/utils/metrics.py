"""Host-side evaluation metrics on numpy, OGB-compatible (copy of
``vq_gnn_tpu/utils/metrics.py``).

- ``accuracy``: the ogbn-arxiv/products Evaluator, argmax match rate;
- ``micro_f1``: accuracy for single-label targets, micro-F1 with a
  logits > 0 threshold for multilabel ones (``misc.py:36-55``);
- ``hits_at_k`` (ogbl-collab) and ``mrr`` (ogbl-citation2) for link
  prediction.
"""

from __future__ import annotations

import numpy as np


def accuracy(logits: np.ndarray, y: np.ndarray, mask=None) -> float:
    if mask is not None:
        logits, y = logits[mask], y[mask]
    if len(y) == 0:
        return 0.0
    return float((logits.argmax(axis=-1) == y).mean())


def micro_f1(logits: np.ndarray, y: np.ndarray, mask=None) -> float:
    if mask is not None:
        logits, y = logits[mask], y[mask]
    if y.ndim == 1:
        return accuracy(logits, y)
    pred = logits > 0
    true = y > 0.5
    tp = int((true & pred).sum())
    fp = int((~true & pred).sum())
    fn = int((true & ~pred).sum())
    denom_p, denom_r = tp + fp, tp + fn
    if denom_p == 0 or denom_r == 0:
        return 0.0
    precision, recall = tp / denom_p, tp / denom_r
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def hits_at_k(pos_pred: np.ndarray, neg_pred: np.ndarray, k: int) -> float:
    """OGB Hits@K: the share of positives scored above the k-th best negative."""
    if len(neg_pred) < k:
        return 1.0
    kth = np.sort(neg_pred)[-k]
    return float((pos_pred > kth).mean())


def mrr(pos_pred: np.ndarray, neg_pred: np.ndarray) -> float:
    """OGB MRR: pos [n], neg [n, m]; the mean of the optimistic and the
    pessimistic rank."""
    pos = pos_pred[:, None]
    opt = (neg_pred > pos).sum(axis=1) + 1
    pes = (neg_pred >= pos).sum(axis=1) + 1
    ranks = 0.5 * (opt + pes)
    return float((1.0 / ranks).mean())
