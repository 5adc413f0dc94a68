from vq_gnn_tpu_torch.parallel.mesh import DataMesh, make_mesh
from vq_gnn_tpu_torch.parallel.multihost import (
    CollectiveLedger,
    init_distributed,
    make_ddp_step,
    partition_hosts,
)

__all__ = ["CollectiveLedger", "DataMesh", "init_distributed", "make_ddp_step", "make_mesh",
           "partition_hosts"]
