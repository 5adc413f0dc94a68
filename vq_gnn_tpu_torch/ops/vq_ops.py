"""VQ assignment primitives in plain PyTorch (port of
``vq_gnn_tpu/ops/vq_ops.py``): the ``xla``/``xla_fast`` backends.

All functions take a leading branch axis (the JAX package's ``vmap`` over
branches, written out): xn [nb, B, K], emb [nb, M, K].

Assignments and statistics stay exact f32 whatever ``matmul_precision`` says:
the distance dot product is a sum of elementwise products over the small
K axis, so TF32 never enters (wrong argmins corrupt ``c_indices``).
"""

from __future__ import annotations

import torch


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
    """Per-codeword (counts [nb, M], sums [nb, M, K]) over valid rows.
    ``fast`` sums bf16-rounded xn (the JAX bf16 one-hot GEMM), in f32."""
    nb, B, K = xn.shape
    v = (torch.ones(B, device=xn.device) if valid is None else valid.to(torch.float32))
    x = xn.to(torch.bfloat16).to(torch.float32) if fast else xn
    flat = (idx + torch.arange(nb, device=xn.device)[:, None] * num_M).reshape(-1)
    counts = torch.zeros(nb * num_M, dtype=torch.float32, device=xn.device)
    counts.index_add_(0, flat, v.expand(nb, B).reshape(-1))
    sums = torch.zeros((nb * num_M, K), dtype=torch.float32, device=xn.device)
    sums.index_add_(0, flat, (x * v[None, :, None]).reshape(-1, K))
    return counts.reshape(nb, num_M), sums.reshape(nb, num_M, K)


def masked_mean_var(x: torch.Tensor, valid=None, ddof: int = 0):
    """Mean/variance over the rows (dim -2) of valid entries, torch
    semantics: ddof=0 (biased) for BatchNorm normalization, ddof=1 for
    running-stat updates and seeding (``vq.py:208-220``)."""
    if valid is None:
        n = float(x.shape[-2])
        mean = x.mean(-2)
        var = ((x - mean.unsqueeze(-2)) ** 2).sum(-2) / max(n - ddof, 1.0)
        return mean, var
    v = valid.to(x.dtype)[:, None]
    n = torch.clamp(v.sum(), min=1.0)
    mean = (x * v).sum(-2) / n
    var = (((x - mean.unsqueeze(-2)) ** 2) * v).sum(-2) / torch.clamp(n - ddof, min=1.0)
    return mean, var
