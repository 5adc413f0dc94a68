from vq_gnn_tpu_torch.parallel.mesh import (
    DataMesh,
    Mesh2D,
    RowShard,
    ShardEdges,
    make_mesh,
    make_mesh_2d,
    shard_train_inputs,
    shard_train_inputs_2d,
)
from vq_gnn_tpu_torch.parallel.multihost import (
    CollectiveLedger,
    init_distributed,
    make_ddp_step,
    partition_hosts,
)
from vq_gnn_tpu_torch.parallel.sharded import (
    make_sharded_link_step,
    make_sharded_link_step_2d,
    make_sharded_step,
    make_sharded_step_2d,
)

__all__ = ["CollectiveLedger", "DataMesh", "Mesh2D", "RowShard", "ShardEdges",
           "init_distributed", "make_ddp_step", "make_mesh", "make_mesh_2d",
           "make_sharded_link_step", "make_sharded_link_step_2d", "make_sharded_step",
           "make_sharded_step_2d", "partition_hosts",
           "shard_train_inputs", "shard_train_inputs_2d"]
