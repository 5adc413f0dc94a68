"""Host builder of the rev-ELL layout: the reverse-edge list of the B + M
(v1) exact recovery term in K-wide row slots (numpy; a copy of
``vq_gnn_tpu/ops/pallas_rev.py:build_rev_ell`` and ``pad_rev_ell``).

The v1 mapper's non-GCN recovery (reference ``vq_gnn_v1/utils/
dataloader.py:153-180``) sums, per batch row and codeword, the reverse-
normalised additions and the raw-A subtractions of the row's neighbours and
keeps the positive part.  The reverse list is static per batch, so the host
sorts it by batch row, coalesces duplicate (row, col) pairs (a subset of the
on-device (row, codeword) coalesce, so the result is unchanged for any
codeword table), drops exact zeros (relu(0) == 0) and packs the cells into
K-wide slots.  The TPU kernel's packed (tile, chunk) schedule fed its
sequential grid; the CUDA kernels (``csrc/rev_recovery.cu``) do not use it,
so it is not built.  They take the slots' row offsets
(``spmm.row_offsets_host``) and the list of long rows
(:func:`rev_long_rows_host`) instead, both built with the batch.
"""

from __future__ import annotations

import numpy as np

REV_K = 8  # cells per slot
REV_S_MULTIPLE = 2048  # slot-count bucket multiple (the JAX package's 8 * T_s)
REV_LONG_SLOTS = 32 // REV_K  # rows of more slots hold more cells than a warp has lanes


def build_rev_ell(rr, rc, rv, B_pad: int, num_N: int):
    """Sort + coalesce the reverse-edge list into REV_K-wide row slots.

    rr/rc/rv: per entry (local batch row, global neighbour id, value);
    duplicates allowed.  Returns (slot_col [S, K] int32 (pad cells ->
    num_N), slot_val [S, K] f32 (pad cells 0), slot_row [S] int32 ascending;
    rows without cells own no slot).  An empty list gives one pad slot of
    row ``B_pad``."""
    rr = np.asarray(rr, np.int64)
    rc = np.asarray(rc, np.int64)
    rv = np.asarray(rv, np.float64)
    K = REV_K
    key = rr * (num_N + 1) + rc
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.zeros(len(uniq))
    np.add.at(vals, inv, rv)
    keep = vals != 0.0
    uniq, vals = uniq[keep], vals[keep]
    rows = (uniq // (num_N + 1)).astype(np.int64)  # ascending (key-major)
    cols = (uniq % (num_N + 1)).astype(np.int64)

    deg = np.bincount(rows, minlength=B_pad) if len(rows) else np.zeros(B_pad, np.int64)
    nslot = (deg + K - 1) // K
    S = max(int(nslot.sum()), 1)
    slot_row = np.repeat(np.arange(B_pad), nslot).astype(np.int32)
    if len(slot_row) == 0:
        slot_row = np.array([B_pad], np.int32)
    slot_col = np.full((S, K), num_N, np.int32)
    slot_val = np.zeros((S, K), np.float32)
    if len(rows):
        # within each row, cells fill lanes 0..K-1 of its slots in col order
        cum = np.concatenate([[0], np.cumsum(deg)])
        within = np.arange(len(rows)) - cum[rows]
        slot_base = np.concatenate([[0], np.cumsum(nslot)])
        s_idx = slot_base[rows] + within // K
        lane = within % K
        slot_col[s_idx, lane] = cols
        slot_val[s_idx, lane] = vals.astype(np.float32)
    return slot_col, slot_val, slot_row


def pad_rev_ell(slot_col, slot_val, slot_row, S_pad: int, B_pad: int, num_N: int):
    """Pad to ``S_pad`` slots: pad slots carry row ``B_pad`` (after every
    batch row), cols ``num_N`` and values 0."""
    S, K = slot_col.shape
    if S_pad < S:
        raise ValueError(f"rev-ELL slots {S} exceed S_pad={S_pad}")
    return (
        np.concatenate([slot_col, np.full((S_pad - S, K), num_N, np.int32)]),
        np.concatenate([slot_val, np.zeros((S_pad - S, K), np.float32)]),
        np.concatenate([slot_row, np.full(S_pad - S, B_pad, np.int32)]),
    )


def rev_long_rows_host(ptr) -> np.ndarray:
    """int32 [1 + n]: REV_LONG_SLOTS, then the n rows of more slots (row
    offsets ``ptr``), in index order.  The recovery kernels give each such
    row a warp per branch, started first, and take every other row (at most
    a warp of cells) a warp each, the branches across the lanes; the list
    carries its threshold so the kernels skip exactly the rows it holds."""
    rows = np.flatnonzero(np.diff(np.asarray(ptr, np.int64)) > REV_LONG_SLOTS)
    return np.concatenate([[REV_LONG_SLOTS], rows]).astype(np.int32)
