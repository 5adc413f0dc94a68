from vq_gnn_tpu_torch.native import lib

__all__ = ["lib"]
