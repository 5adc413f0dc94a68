"""VQ-health diagnostics (port of ``vq_gnn_tpu/utils/diagnostics.py``, the
reimplemented ``exp_log`` catalogue of the reference ``utils/logger.py:89-232``).

Every metric derives from a :class:`VQState`, so it can be computed on any
step without touching training; tensors are read back to the host and the
statistics are numpy, as in the JAX package:

- codeword usage: EMA cluster-size histogram, effective number of codewords
- per-dim EMA mean/std of the feature and gradient halves
- pairwise codeword distances (feature half / grad half)
- assignment churn between two states
- feature approximation errors given a batch
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vq_gnn_tpu_torch.nn.vq import VQParams, VQState


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def codebook_stats(state: VQState, p: VQParams) -> Dict[str, np.ndarray]:
    size = _np(state.ema_cluster_size)  # [nb, M]
    probs = size / np.maximum(size.sum(axis=1, keepdims=True), 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        entropy = -np.nansum(probs * np.log(np.maximum(probs, 1e-12)), axis=1)
    emb = _np(state.embedding)
    D = p.num_D
    return {
        "cluster_size_min": size.min(axis=1),
        "cluster_size_max": size.max(axis=1),
        "effective_codewords": np.exp(entropy),
        "feat_mean_per_dim": emb[:, :, :D].mean(axis=1),
        "feat_std_per_dim": emb[:, :, :D].std(axis=1),
        "grad_mean_per_dim": emb[:, :, D:].mean(axis=1),
        "grad_std_per_dim": emb[:, :, D:].std(axis=1),
    }


def pairwise_codeword_distances(state: VQState, p: VQParams):
    """Mean pairwise L2 distance between codewords, feature/grad halves
    (reference ``get_embedding_for_record``, vq.py:137-155)."""
    emb = _np(state.embedding)
    D = p.num_D

    def mean_dist(a):  # [nb, M, d]
        d2 = (
            (a**2).sum(-1)[:, :, None]
            + (a**2).sum(-1)[:, None, :]
            - 2 * np.einsum("nmd,nkd->nmk", a, a)
        )
        d = np.sqrt(np.maximum(d2, 0))
        M = d.shape[1]
        iu = np.triu_indices(M, k=1)
        return d[:, iu[0], iu[1]].mean(axis=1)

    return {
        "feat_pairwise_dist": mean_dist(emb[:, :, :D]),
        "grad_pairwise_dist": mean_dist(emb[:, :, D:]),
    }


def approximation_errors(state: VQState, p: VQParams, X_B, batch_idx):
    """||X_B - codebook[c]|| per branch, the reference's
    ``vq_backward_error`` (models.py v2:53-54)."""
    c = _np(state.c_indices)[_np(batch_idx), :].T  # [nb, B]
    table = _np(state.embedding_output)
    X = _np(X_B)  # [nb, B, D]
    feat = np.take_along_axis(table[:, :, : p.num_D], c[:, :, None].astype(np.int64), axis=1)
    err = np.linalg.norm(X - feat, axis=2).mean(axis=1)
    xn = np.linalg.norm(X, axis=2).mean(axis=1)
    return {"vq_backward_error": err, "X_B_norm": xn}


def assignment_churn(before: VQState, after: VQState) -> np.ndarray:
    """Fraction of nodes whose codeword changed, per branch."""
    a = _np(before.c_indices)[:-1, :]
    b = _np(after.c_indices)[:-1, :]
    return (a != b).mean(axis=0)
