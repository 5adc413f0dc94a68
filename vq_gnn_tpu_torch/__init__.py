"""vq_gnn_tpu_torch — the PyTorch/CUDA port of vq_gnn_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names; imports nothing of it:

- ``graph``    host-side graph store, normalization, partitioning (numpy)
- ``native``   C++ host graph kernels (k-hop, random walk, ELL, partitioner)
- ``sampler``  static-shape padded mini-batches, moved to the device as tensors
- ``ops``      the CUDA kernels (``csrc/``) and their plain PyTorch versions
- ``nn``       VQ state machine + LowRankGNN model
- ``train``    train/eval/init-sweep steps, RMSprop, the node trainer
- ``convert``  carries a JAX-package train state into the port
"""

from vq_gnn_tpu_torch.config import Config

__version__ = "0.1.0"
__all__ = ["Config", "__version__"]
