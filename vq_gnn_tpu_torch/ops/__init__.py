"""Device ops: the CUDA kernels and their plain PyTorch versions.

Each kernel wrapper counts its launches in ``<wrapper>.launches``; the
wrappers of kernels 1, 4 and 5 count their bf16-row mode apart, in
``launches_bf16``, and those of kernels 9 and 10 their bf16 fold
(``VQ_GNN_REV_FOLD=fast``) there too (``BF16_MODES`` names each such mode).
:func:`launch_counts` / :func:`reset_launch_counts` read and zero them all
(``gat_backward`` also counts them per width C and row dtype, in
``by_width``, and ``fused_assign_branches`` per width K).
"""

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


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts.update({name: fn.launches_bf16 for name, fn in BF16_MODES.items()})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in BF16_MODES.values():
        fn.launches_bf16 = 0
    gat_backward.by_width.clear()
    fused_assign_branches.by_width.clear()


__all__ = ["BF16_MODES", "KERNELS", "launch_counts", "reset_launch_counts"]
