from vq_gnn_tpu_torch.sampler.batch import PaddedBatch, build_padded_batch
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader

__all__ = ["PaddedBatch", "build_padded_batch", "BatchLoader"]
