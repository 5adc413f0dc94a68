"""Device ops: the CUDA kernels and their plain PyTorch versions.

Each kernel wrapper counts its launches in ``<wrapper>.launches``; the
wrappers of kernels 1, 4 and 5 count their bf16-row mode apart, in
``launches_bf16``, and those of kernels 9 and 10 their bf16 fold
(``VQ_GNN_REV_FOLD=fast``) there too (``BF16_MODES`` names each such mode);
kernels 1, 4 and 5 count their f16-row mode in ``launches_f16``
(``F16_MODES``);
the segment sum counts its launches with the scalar channel apart, in
``launches_scalar`` (``SCALAR_MODES``).
:func:`launch_counts` / :func:`reset_launch_counts` read and zero them all
(``gat_backward`` also counts them per width C and row dtype, in
``by_width``, and ``fused_assign_branches`` per width K); launches inside
:func:`uncounted` leave every one of them as it was.
"""

import collections
import contextlib

from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate
from vq_gnn_tpu_torch.ops.gat_kernels import gat_aggregate, gat_backward
from vq_gnn_tpu_torch.ops.rev_kernels import rev_backward, rev_forward
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted
from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches, lookup_codewords

KERNELS = {
    "ell_aggregate": ell_aggregate,
    "vq_assign": fused_assign_branches,
    "vq_lookup": lookup_codewords,
    "gat_aggregate": gat_aggregate,
    "gat_backward": gat_backward,
    "segment_sum": segment_sum_sorted,
    "rev_forward": rev_forward,
    "rev_backward": rev_backward,
}
# the bf16-row modes (compute_dtype='bfloat16') of three of those wrappers,
# and the bf16 fold of the recovery kernels (VQ_GNN_REV_FOLD=fast)
BF16_MODES = {
    "ell_aggregate_bf16": ell_aggregate,
    "gat_aggregate_bf16": gat_aggregate,
    "gat_backward_bf16": gat_backward,
    "rev_forward_fold_bf16": rev_forward,
    "rev_backward_fold_bf16": rev_backward,
}

# the f16-row modes (compute_dtype='float16') of kernels 1, 4 and 5
F16_MODES = {
    "ell_aggregate_f16": ell_aggregate,
    "gat_aggregate_f16": gat_aggregate,
    "gat_backward_f16": gat_backward,
}

# the segment sum's launches with its scalar channel
SCALAR_MODES = {"segment_sum_scalar": segment_sum_sorted}


# the wrappers that also count their launches per width
_BY_WIDTH = (gat_backward, fused_assign_branches)


def _counters():
    """(name, wrapper, attribute) of every launch counter."""
    return ([(n, fn, "launches") for n, fn in KERNELS.items()]
            + [(n, fn, "launches_bf16") for n, fn in BF16_MODES.items()]
            + [(n, fn, "launches_f16") for n, fn in F16_MODES.items()]
            + [(n, fn, "launches_scalar") for n, fn in SCALAR_MODES.items()])


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def reset_launch_counts() -> None:
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
    for fn in _BY_WIDTH:
        fn.by_width.clear()


@contextlib.contextmanager
def uncounted():
    """Launches inside leave every counter, the per-width ones included, as
    it was (the checks beside a path that are not the path)."""
    saved = [(fn, attr, getattr(fn, attr)) for _, fn, attr in _counters()]
    widths = [(fn, collections.Counter(fn.by_width)) for fn in _BY_WIDTH]
    try:
        yield
    finally:
        for fn, attr, v in saved:
            setattr(fn, attr, v)
        for fn, w in widths:
            fn.by_width.clear()
            fn.by_width.update(w)


__all__ = ["BF16_MODES", "F16_MODES", "KERNELS", "SCALAR_MODES", "launch_counts",
           "reset_launch_counts", "uncounted"]
