"""Kernels 2 and 3: the fused VQ assign + statistics and the codebook lookup,
each with its plain PyTorch version.

- ``fused_assign_branches(xn [nb,B,K], emb [nb,M,K], valid [B], fast)`` ->
  (idx [nb,B] int64, counts [nb,M] f32, sums [nb,M,K] f32): distances
  ``e2 - 2 x.e`` (no ``||x||^2`` term), first argmin, and the masked per-
  codeword counts and sums (``csrc/vq_assign.cu``, replacing
  ``vq_gnn_tpu/ops/pallas_vq.py:_assign_kernel_allb`` and, at nb = 1,
  ``_assign_kernel``).  ``fast`` rounds x and the codebook to bf16 for the
  dot product and x to bf16 in the sums; accumulation stays f32.
- ``lookup_codewords(c_indices [N+1,nb] int16, node_ids [n], emb_out
  [nb,M,K], fast)`` -> [n, nb, K]: ``emb_out[b, c_indices[node, b]]``
  (``csrc/vq_lookup.cu``, replacing ``pallas_vq.py:_lookup_kernel``).  Exact
  mode copies bits; fast mode rounds the codewords to bf16.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vq_gnn_tpu_torch.ops import _build

ASSIGN_ROWS_PER_BLOCK = 1024  # batch rows per kernel-2 block (csrc/vq_assign.cu)


def codeword_sqnorm(emb: torch.Tensor) -> torch.Tensor:
    """||e||^2 per codeword, [nb, M] f32, from the unrounded codebook.  The
    kernel takes it as an input, so kernel and plain version share it."""
    return (emb * emb).sum(-1)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fused_assign_branches_plain(xn, emb, valid, fast: bool = False, idx=None):
    """Plain version of kernel 2: the same separately rounded products and
    sums in the same order (k = 0..K-1) as the kernel, then ``argmin`` (first
    minimum) and index_add_ statistics.  A given ``idx`` skips the search and
    only sums (checks use it to sum |x| over the same assignment)."""
    nb, B, K = xn.shape
    M = emb.shape[1]
    x = _bf16(xn) if fast else xn
    if idx is None:
        e2 = codeword_sqnorm(emb)
        e = _bf16(emb) if fast else emb
        acc = x[:, :, None, 0] * e[:, None, :, 0]
        for k in range(1, K):
            acc = acc + x[:, :, None, k] * e[:, None, :, k]
        d = e2[:, None, :] - 2.0 * acc
        idx = torch.argmin(d, dim=2)
    v = valid.to(torch.float32)
    flat = (idx + torch.arange(nb, device=xn.device)[:, None] * M).reshape(-1)
    counts = torch.zeros(nb * M, dtype=torch.float32, device=xn.device)
    counts.index_add_(0, flat, v.expand(nb, B).reshape(-1))
    sums = torch.zeros((nb * M, K), dtype=torch.float32, device=xn.device)
    sums.index_add_(0, flat, (x * v[None, :, None]).reshape(-1, K))
    return idx, counts.reshape(nb, M), sums.reshape(nb, M, K)


def _check(cond: bool, kernel: str, msg: str):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ASSIGN_ARGTYPES = [_VP, _VP, _VP, _VP, _I32, _I64, _I32, _I32, _I32, _I32,
                    _VP, _VP, _VP, _VP, _VP]
_LOOKUP_ARGTYPES = [_VP, _I64, _I32, _VP, _I64, _VP, _I32, _I32, _I32, _VP, _VP]


def fused_assign_branches(xn, emb, valid, fast: bool = False):
    """Kernel 2 for CUDA tensors, its plain version for CPU tensors."""
    if xn.device.type == "cpu":
        return fused_assign_branches_plain(xn, emb, valid, fast)
    k = "fused_assign_branches"
    _check(xn.device.type == "cuda", k, f"unsupported device {xn.device}")
    _check(xn.dim() == 3 and emb.dim() == 3, k, "xn [nb,B,K] and emb [nb,M,K] expected")
    nb, B, K = xn.shape
    M = emb.shape[1]
    _check(tuple(emb.shape) == (nb, M, K), k, f"emb {tuple(emb.shape)} vs xn {tuple(xn.shape)}")
    _check(1 <= K <= 17 and 1 <= M <= 32767, k, f"needs K <= 17 and M <= 32767, got {K}, {M}")
    for name, t, dt in (("xn", xn, torch.float32), ("emb", emb, torch.float32),
                        ("valid", valid, torch.bool)):
        _check(t.device == xn.device and t.dtype == dt and t.is_contiguous(), k,
               f"{name} must be contiguous {dt} on {xn.device}")
    _check(tuple(valid.shape) == (B,), k, f"valid must be [{B}]")
    e2 = codeword_sqnorm(emb).contiguous()
    rows = ASSIGN_ROWS_PER_BLOCK
    nblk = (B + rows - 1) // rows
    part = torch.empty(nb * nblk * M * (K + 1), dtype=torch.float32, device=xn.device)
    idx = torch.empty((nb, B), dtype=torch.int32, device=xn.device)
    counts = torch.empty((nb, M), dtype=torch.float32, device=xn.device)
    sums = torch.empty((nb, M, K), dtype=torch.float32, device=xn.device)
    stream = torch.cuda.current_stream(xn.device).cuda_stream
    rc = _build.function("vq_assign", "vq_assign_stats", _ASSIGN_ARGTYPES)(
        xn.data_ptr(), emb.data_ptr(), e2.data_ptr(), valid.data_ptr(), nb, B, M, K,
        int(fast), rows, part.data_ptr(), idx.data_ptr(), counts.data_ptr(),
        sums.data_ptr(), stream,
    )
    _build.check(rc, k)
    fused_assign_branches.launches += 1
    return idx.long(), counts, sums


fused_assign_branches.launches = 0


def lookup_codewords_plain(c_indices, node_ids, emb_out, fast: bool = False):
    """Plain version of kernel 3: two gathers (advanced indexing)."""
    nb = emb_out.shape[0]
    ids = node_ids.long().clamp(0, c_indices.shape[0] - 1)
    c = c_indices.index_select(0, ids).long()  # [n, nb]
    table = emb_out[torch.arange(nb, device=emb_out.device)[None, :], c]
    return _bf16(table) if fast else table


def lookup_codewords(c_indices, node_ids, emb_out, fast: bool = False):
    """Kernel 3 for CUDA tensors, its plain version for CPU tensors."""
    if emb_out.device.type == "cpu":
        return lookup_codewords_plain(c_indices, node_ids, emb_out, fast)
    k = "lookup_codewords"
    dev = emb_out.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    _check(emb_out.dim() == 3, k, "emb_out [nb,M,K] expected")
    nb, M, K = emb_out.shape
    for name, t, dt in (("c_indices", c_indices, torch.int16),
                        ("node_ids", node_ids, torch.int64),
                        ("emb_out", emb_out, torch.float32)):
        _check(t.device == dev and t.dtype == dt and t.is_contiguous(), k,
               f"{name} must be contiguous {dt} on {dev}")
    _check(c_indices.dim() == 2 and c_indices.shape[1] == nb, k,
           f"c_indices must be [N+1, {nb}]")
    _check(node_ids.dim() == 1, k, "node_ids must be 1-D")
    n = node_ids.shape[0]
    out = torch.empty((n, nb, K), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.function("vq_lookup", "vq_lookup", _LOOKUP_ARGTYPES)(
        c_indices.data_ptr(), c_indices.shape[0], nb, node_ids.data_ptr(), n,
        emb_out.data_ptr(), M, K, int(fast), out.data_ptr(), stream,
    )
    _build.check(rc, k)
    lookup_codewords.launches += 1
    return out


lookup_codewords.launches = 0
