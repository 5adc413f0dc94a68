"""Device ops: the CUDA kernels and their plain PyTorch versions.

Each kernel wrapper counts its launches in ``<wrapper>.launches``;
:func:`launch_counts` / :func:`reset_launch_counts` read and zero them all.
"""

from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate
from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches, lookup_codewords

KERNELS = {
    "ell_aggregate": ell_aggregate,
    "vq_assign": fused_assign_branches,
    "vq_lookup": lookup_codewords,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]
