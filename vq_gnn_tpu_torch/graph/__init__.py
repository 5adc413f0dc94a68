from vq_gnn_tpu_torch.graph.partition import partition_graph, permute_graph
from vq_gnn_tpu_torch.graph.store import HostGraph, norm_adj, symmetrize

__all__ = ["HostGraph", "norm_adj", "symmetrize", "partition_graph", "permute_graph"]
