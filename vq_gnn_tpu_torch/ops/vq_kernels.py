"""Kernels 2 and 3: the fused VQ assign + statistics and the codebook lookup,
each with its plain PyTorch version.

- ``fused_assign_branches(xn [nb,B,K], emb [nb,M,K], valid [B], fast)`` ->
  (idx [nb,B] int64, counts [nb,M] f32, sums [nb,M,K] f32): distances
  ``e2 - 2 x.e`` (no ``||x||^2`` term), first argmin, and the masked per-
  codeword counts and sums (``csrc/vq_assign.cu``, replacing
  ``vq_gnn_tpu/ops/pallas_vq.py:_assign_kernel_allb`` and, at nb = 1,
  ``_assign_kernel``).  ``fast`` rounds x and the codebook to bf16 for the
  dot product and x to bf16 in the sums; accumulation stays f32.  The fast
  mode runs the distances on the tensor cores, which sum in their own order,
  so it is held to its plain version by ``assign_mismatch`` (near ties may
  pick another codeword); the exact mode is bit-equal to its plain version.
- ``lookup_codewords(c_indices [N+1,nb] int16, node_ids [n], emb_out
  [nb,M,K], fast, split)`` -> [n, nb, K]: ``emb_out[b, c_indices[node, b]]``
  (``csrc/vq_lookup.cu``, replacing ``pallas_vq.py:_lookup_kernel``); with
  ``split=D`` the two halves apart, ``(feats [n, nb*D], grads [n,
  nb*(K-D)])``, each contiguous and written by the kernel.  Exact mode
  copies bits; fast mode rounds the codewords to bf16.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from vq_gnn_tpu_torch.config import sum_dtype
from vq_gnn_tpu_torch.ops import _build

ASSIGN_ROWS_PER_BLOCK = 1024  # batch rows per exact kernel-2 block (csrc/vq_assign.cu)
ASSIGN_FAST_STEP = 512  # rows per step of a fast kernel-2 block (csrc/vq_assign.cu kTile)
# distances per row chunk of the plain search: a [nb, rows, M] tile of about
# 16 MB in float64 stays in cache (the whole [nb, B, M] tile ran 4x slower)
PLAIN_TILE = 1 << 21


def codeword_sqnorm(emb: torch.Tensor) -> torch.Tensor:
    """||e||^2 per codeword, [nb, M] f32, from the unrounded codebook.  The
    kernel takes it as an input, so kernel and plain version share it."""
    return (emb * emb).sum(-1)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(sum_dtype(t.dtype))


def fused_assign_branches_plain(xn, emb, valid, fast: bool = False, idx=None):
    """Plain version of kernel 2: the same separately rounded products and
    sums in the same order (k = 0..K-1) as the exact kernel, then ``argmin``
    (first minimum), a chunk of rows at a time (``PLAIN_TILE``), and
    index_add_ statistics over all rows, in f32.  float64 xn (the
    diagnostic of ``config.sum_dtype``, which no kernel matches bit for
    bit) takes a chunk's products as one batched matmul, 5x faster on a
    CPU, and sums in float64.  A given ``idx`` skips the search and only
    sums (checks use it to sum |x| over the same assignment)."""
    nb, B, K = xn.shape
    M = emb.shape[1]
    x = _bf16(xn) if fast else xn
    if idx is None:
        e2 = codeword_sqnorm(emb)[:, None, :]
        e = _bf16(emb) if fast else emb
        step = max(1, PLAIN_TILE // (nb * M))
        idx = []
        for i in range(0, max(B, 1), step):  # one empty chunk at B = 0
            xc = x[:, i : i + step]
            if xc.dtype == torch.float64:
                d = torch.baddbmm(e2, xc, e.transpose(1, 2), alpha=-2.0)
            else:
                acc = xc[:, :, None, 0] * e[:, None, :, 0]
                for k in range(1, K):
                    acc += xc[:, :, None, k] * e[:, None, :, k]
                d = e2 - 2.0 * acc
            idx.append(torch.argmin(d, dim=2))
        idx = torch.cat(idx, 1)
    wd = sum_dtype(xn.dtype)
    v = valid.to(wd)
    flat = (idx + torch.arange(nb, device=xn.device)[:, None] * M).reshape(-1)
    counts = torch.zeros(nb * M, dtype=wd, device=xn.device)
    counts.index_add_(0, flat, v.expand(nb, B).reshape(-1))
    sums = torch.zeros((nb * M, K), dtype=wd, device=xn.device)
    sums.index_add_(0, flat, (x * v[None, :, None]).reshape(-1, K))
    return idx, counts.reshape(nb, M), sums.reshape(nb, M, K)


def assign_mismatch(xn, emb, idx, idx_ref, fast: bool):
    """How far assignment ``idx`` is from ``idx_ref`` (both [nb, B]) on the
    same inputs: (rows where they differ, worst ratio).  For each such row
    both distances ``e2[m] - 2 sum_k x_k e_mk`` are recomputed in f64 from
    the operands the mode uses (bf16-rounded when ``fast``), and the ratio is
    ``(d(idx) - d(idx_ref)) / tol`` with

        tol = 4e-6 * (|e2[idx]| + |e2[ref]| + 2 sum_k |x_k e_idx,k|
                      + 2 sum_k |x_k e_ref,k|).

    bf16 x bf16 products are exact in f32, and each side adds up to 17 of
    them and e2 in f32, each addition rounded or truncated (2^-23 relative),
    so a pick within round-off of the best has ratio <= 1; a ratio <= 0
    means ``idx`` is at least as close.  A check passes with ratio <= 1 on
    fewer than 1e-3 of the rows.  Used by the tests and ``chip_smoke.py``,
    not by the training path."""
    b, i = torch.nonzero(idx != idx_ref, as_tuple=True)
    if b.numel() == 0:
        return 0, 0.0
    x = (_bf16(xn) if fast else xn)[b, i].double()
    e = _bf16(emb) if fast else emb
    e2 = codeword_sqnorm(emb).double()

    def dist(m):
        prod = x * e[b, m].double()
        return e2[b, m] - 2.0 * prod.sum(-1), e2[b, m].abs() + 2.0 * prod.abs().sum(-1)

    d_a, s_a = dist(idx[b, i])
    d_r, s_r = dist(idx_ref[b, i])
    tol = (4e-6 * (s_a + s_r)).clamp_min(torch.finfo(torch.float64).tiny)
    return int(b.numel()), float(((d_a - d_r) / tol).max())


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fast_rows_per_block(nb: int, B: int, sms: int) -> int:
    """Rows per block of the fast kernel: whole 512-row steps, with as many
    blocks per branch as keep the grid within two blocks per SM (one wave
    at nb = 32 and at nb = 1 alike)."""
    steps = max(1, -(-B // ASSIGN_FAST_STEP))
    per_branch = max(1, min(steps, 2 * sms // nb))
    return -(-steps // per_branch) * ASSIGN_FAST_STEP


def _check(cond: bool, kernel: str, msg: str):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ASSIGN_ARGTYPES = [_VP, _VP, _VP, _VP, _I32, _I64, _I32, _I32, _I32, _I32,
                    _VP, _VP, _VP, _VP, _VP]
_LOOKUP_ARGTYPES = [_VP, _I64, _I32, _VP, _I64, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _VP]


def fused_assign_branches(xn, emb, valid, fast: bool = False):
    """Kernel 2 for CUDA tensors, its plain version for CPU tensors.  Counts
    its launches, and per width K in ``fused_assign_branches.by_width``."""
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
    if fast:
        rows = fast_rows_per_block(nb, B, _sm_count(xn.device.index))
    else:
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
    fused_assign_branches.by_width[K] += 1
    return idx.long(), counts, sums


fused_assign_branches.launches = 0
fused_assign_branches.by_width = collections.Counter()


def lookup_codewords_plain(c_indices, node_ids, emb_out, fast: bool = False,
                           split: Optional[int] = None):
    """Plain version of kernel 3: two gathers (advanced indexing), node ids
    clipped to the table and codeword ids to [0, M) as the kernel clips
    them; with ``split`` the table's two halves, each made contiguous."""
    nb, M, K = emb_out.shape
    _check_split(split, K)
    ids = node_ids.long().clamp(0, c_indices.shape[0] - 1)
    c = c_indices.index_select(0, ids).long().clamp(0, M - 1)  # [n, nb]
    table = emb_out[torch.arange(nb, device=emb_out.device)[None, :], c]
    if fast:
        table = _bf16(table)
    if split is None:
        return table
    n = table.shape[0]
    return (table[:, :, :split].contiguous().reshape(n, nb * split),
            table[:, :, split:].contiguous().reshape(n, nb * (K - split)))


def _check_split(split, K: int):
    if not (split is None or 0 < split < K):
        _check(False, "lookup_codewords", f"split must be in (0, {K}), got {split}")


def lookup_codewords(c_indices, node_ids, emb_out, fast: bool = False,
                     split: Optional[int] = None):
    """Kernel 3 for CUDA tensors, its plain version for CPU tensors.
    ``split=D`` returns ``(feats [n, nb*D], grads [n, nb*(K-D)])`` in place
    of the [n, nb, K] table."""
    if emb_out.device.type == "cpu":
        return lookup_codewords_plain(c_indices, node_ids, emb_out, fast, split)
    k = "lookup_codewords"
    dev = emb_out.device
    _check(dev.type == "cuda", k, f"unsupported device {dev}")
    _check(emb_out.dim() == 3, k, "emb_out [nb,M,K] expected")
    nb, M, K = emb_out.shape
    _check_split(split, K)
    # messages formatted only on failure: this runs on every launch
    for name, t, dt in (("c_indices", c_indices, torch.int16),
                        ("node_ids", node_ids, torch.int64),
                        ("emb_out", emb_out, torch.float32)):
        if not (t.device == dev and t.dtype == dt and t.is_contiguous()):
            _check(False, k, f"{name} must be contiguous {dt} on {dev}")
    if not (c_indices.dim() == 2 and c_indices.shape[1] == nb):
        _check(False, k, f"c_indices must be [N+1, {nb}]")
    _check(node_ids.dim() == 1, k, "node_ids must be 1-D")
    n = node_ids.shape[0]
    if split is None:
        outs = (torch.empty((n, nb, K), dtype=torch.float32, device=dev),)
    else:
        outs = tuple(torch.empty((n, nb * w), dtype=torch.float32, device=dev)
                     for w in (split, K - split))
    if n:  # nothing to launch for no nodes
        rc = _build.function("vq_lookup", "vq_lookup", _LOOKUP_ARGTYPES)(
            c_indices.data_ptr(), c_indices.shape[0], nb, node_ids.data_ptr(), n,
            emb_out.data_ptr(), M, K, int(fast), split or 0, outs[0].data_ptr(),
            outs[-1].data_ptr() if split else None, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(rc, k)
        lookup_codewords.launches += 1
    return outs[0] if split is None else outs


lookup_codewords.launches = 0
