"""The data-parallel group and this rank's device (port of
``vq_gnn_tpu/parallel/mesh.py``'s ``make_mesh``).

JAX lays one program over a mesh of devices, ``('data',)``, and XLA inserts
the collectives.  The port runs one process per GPU: its mesh is the
``torch.distributed`` process group and the device this process drives.
The single-batch sharding of that file (``shard_train_inputs``: one batch's
rows and edges over the devices) and its 2-D data x model mesh
(``make_mesh_2d``, ``shard_train_inputs_2d``) have no counterpart yet
(ROADMAP.md queue 1 item 7b).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from vq_gnn_tpu_torch.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    group: Optional[object]  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device


def make_mesh(n_ranks: int = 0, group=None,
              device: Union[str, torch.device, None] = None) -> DataMesh:
    """The group (``init_distributed`` first) and this rank's device:
    ``cuda:<local rank>`` unless ``device`` says otherwise, the local rank
    from ``LOCAL_RANK`` where a launcher sets it, else the rank modulo the
    GPUs of this host.  ``n_ranks > 0`` must equal the group's size (0 =
    every rank, as ``Config.mesh_data``)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_ranks > 0 and n_ranks != size:
        raise RuntimeError(f"need {n_ranks} ranks, the process group has {size}")
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else rank % max(torch.cuda.device_count(), 1)
        device = f"cuda:{local}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return DataMesh(group=group, rank=rank, size=size, device=device)
