"""VQ assignment primitives in plain PyTorch (port of
``vq_gnn_tpu/ops/vq_ops.py``): the ``xla``/``xla_fast`` backends and the
row-chunked ``scan`` backend.

All functions take a leading branch axis (the JAX package's ``vmap`` over
branches, written out): xn [nb, B, K], emb [nb, M, K].

Assignments and statistics stay exact f32 whatever ``matmul_precision`` says:
the distance dot product is a sum of elementwise products over the small
K axis, so TF32 never enters (wrong argmins corrupt ``c_indices``).
"""

from __future__ import annotations

import torch

from vq_gnn_tpu_torch.config import sum_dtype


def _dot_k(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """<x[b,i], e[b,m]> -> [nb, B, M] as a K-term elementwise sum."""
    acc = x[:, :, None, 0] * e[:, None, :, 0]
    for k in range(1, x.shape[2]):
        acc = acc + x[:, :, None, k] * e[:, None, :, k]
    return acc


def nearest_codeword(xn: torch.Tensor, emb: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """argmin_m ||xn_i - emb_m||^2 via expanded squares -> [nb, B] int64.

    ``fast`` mirrors the JAX xla_fast path: the distance matrix is rounded to
    bf16 (``preferred_element_type=bfloat16``), so near ties may flip."""
    dot = _dot_k(xn, emb)
    e2 = (emb * emb).sum(-1)[:, None, :]
    if fast:
        d = e2.to(torch.bfloat16) - 2.0 * dot.to(torch.bfloat16)
        return torch.argmin(d, dim=2)
    d = (xn * xn).sum(-1, keepdim=True) + e2 - 2.0 * dot
    return torch.argmin(d, dim=2)


def assignment_stats(xn: torch.Tensor, idx: torch.Tensor, num_M: int, valid=None,
                     fast: bool = False):
    """Per-codeword (counts [nb, M], sums [nb, M, K]) over valid rows, f32
    (float64 for float64 xn).  ``fast`` sums bf16-rounded xn (the JAX bf16
    one-hot GEMM)."""
    nb, B, K = xn.shape
    wd = sum_dtype(xn.dtype)
    v = (torch.ones(B, dtype=wd, device=xn.device) if valid is None else valid.to(wd))
    x = xn.to(torch.bfloat16).to(wd) if fast else xn
    flat = (idx + torch.arange(nb, device=xn.device)[:, None] * num_M).reshape(-1)
    counts = torch.zeros(nb * num_M, dtype=wd, device=xn.device)
    counts.index_add_(0, flat, v.expand(nb, B).reshape(-1))
    sums = torch.zeros((nb * num_M, K), dtype=wd, device=xn.device)
    sums.index_add_(0, flat, (x * v[None, :, None]).reshape(-1, K))
    return counts.reshape(nb, num_M), sums.reshape(nb, num_M, K)


def assign_stats_scan(xn: torch.Tensor, emb: torch.Tensor, valid=None, chunk: int = 8192):
    """(idx [nb, B], counts [nb, M], sums [nb, M, K]) over row chunks of
    ``chunk`` rows (``vq_gnn_tpu/ops/vq_ops.py:77-127``, the JAX ``lax.scan``
    vmapped over the branches): no [nb, B, M] distance tile is made, only one
    [nb, chunk, M] tile at a time.  Per chunk d = ||e||^2 - 2 x.e (the
    per-row ||x||^2 does not move the argmin), the first index of the
    minimum, and the chunk's valid rows added to the f32 counts and sums.
    The JAX package pads the last chunk with invalid rows; here it is the
    shorter slice, which adds the same."""
    nb, B, K = xn.shape
    M = emb.shape[1]
    if valid is None:
        valid = torch.ones(B, dtype=torch.bool, device=xn.device)
    e2 = (emb * emb).sum(-1)[:, None, :]
    counts = torch.zeros((nb, M), dtype=sum_dtype(xn.dtype), device=xn.device)
    sums = torch.zeros((nb, M, K), dtype=sum_dtype(xn.dtype), device=xn.device)
    idxs = []
    for i in range(0, B, chunk):
        x, v = xn[:, i : i + chunk], valid[i : i + chunk]
        idx = torch.argmin(e2 - 2.0 * _dot_k(x, emb), dim=2)
        c, s = assignment_stats(x, idx, M, v)
        counts += c
        sums += s
        idxs.append(idx)
    return torch.cat(idxs, dim=1), counts, sums


def masked_moments(xs, valid=None, stats_reduce=None):
    """(mean, biased var, unbiased var) over the rows (dim -2) of the valid
    entries of each tensor of ``xs`` (one dtype), torch semantics: the biased
    var normalises BatchNorm, the unbiased one updates the running stats and
    seeds them (``vq.py:208-220``).  Two passes, each run once for both
    variances: the valid count and the sums of x*v, then the squared
    deviations from the mean.  ``stats_reduce`` (a list of tensors -> their
    sums over the data-parallel ranks) adds each pass's sums over the ranks
    before any divide, so every rank gets the moments of all ranks' rows;
    it needs ``valid``."""
    if valid is None:
        assert stats_reduce is None, "the data-parallel moments need the valid mask"
        n = float(xs[0].shape[-2])
        means = [x.mean(-2) for x in xs]
        second = [((x - m.unsqueeze(-2)) ** 2).sum(-2) for x, m in zip(xs, means)]
        return [(m, s / max(n, 1.0), s / max(n - 1, 1.0)) for m, s in zip(means, second)]
    assert all(x.dtype == xs[0].dtype for x in xs), [x.dtype for x in xs]
    stats_reduce = stats_reduce or (lambda tensors: tensors)
    v = valid.to(xs[0].dtype)[:, None]
    first = stats_reduce([(x * v).sum(-2) for x in xs] + [v.sum()])
    n = torch.clamp(first[-1], min=1.0)
    means = [s / n for s in first[:-1]]
    second = stats_reduce([(((x - m.unsqueeze(-2)) ** 2) * v).sum(-2)
                           for x, m in zip(xs, means)])
    return [(m, s / n, s / torch.clamp(n - 1, min=1.0)) for m, s in zip(means, second)]
