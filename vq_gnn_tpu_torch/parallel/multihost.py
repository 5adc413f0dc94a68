"""Data-parallel training over ``torch.distributed`` (port of
``vq_gnn_tpu/parallel/multihost.py``).

One process per GPU.  Each holds a replica of the parameters, codebooks
and BN statistics and steps its own batch, drawn from its own nodes
(``BatchLoader(node_range=...)``, the nodes of ``partition_hosts``) at the
fixed pad sizes of ``Config.fixed_*_pad``.  The step is the JAX package's
``make_ddp_step`` (``multihost.py:58-221``) with the collectives that XLA
inserts there written out:

- **loss**: the global masked CE, sum_r ce_sum_r / max(sum_r count_r, 1),
  plus every rank's info_backward.  The counts are all-reduced before the
  backward, the parameter gradients (summed) after it; RMSprop runs on the
  sums, alike on every rank.  As in the JAX step, ``cfg.ce_only`` is not
  read and only ``loss`` and ``bad_init`` are reported;
- **sync-BN**: each rank normalises by its own batch; the running
  statistics are averaged over the ranks;
- **one VQ transition a layer on all ranks' rows**, no row moved: the BN
  moments of [X_B || grad] (two rounds, the two passes of
  ``masked_moments``, feature and gradient halves in one buffer) and each
  layer's assignment counts and sums are all-reduced before any divide
  (``vq_update``'s ``stats_reduce``: the psum before the EMA divide), so the
  EMA, the codebook and its lookup table come out the same on every rank;
- **the c_indices merge** (``vq_update``'s ``cidx_merge_fn``): the batch ids
  are all-gathered once a step as int32, each layer's assignments as uint8
  (M <= 256; else the int16 as a uint8 view, since gloo gathers no int16
  and NCCL has no 16-bit integer type), and every rank writes every rank's
  rows into its table in rank-major order, the JAX step's shard-major
  concatenation.  Where two ranks' batches share a node, the later rank's
  row wins on every rank, so the replicas stay bit-identical;
- **dropbranch**: one mask set a step for all ranks, drawn from a generator
  seeded with ``cfg.seed`` on every rank (``branch_masks`` overrides it).

``CollectiveLedger`` counts the bytes of every collective by category.

``stack_local_batches``, ``shard_stacked_batch`` and
``global_batch_from_local`` have no counterpart: they assemble the hosts'
batches into one global array for one SPMD program, while here each rank
keeps its own batch and the collectives carry statistics, not rows.

What the JAX step cannot run raises by name (``config.no_reference_path``):
B + M GAT, whose [nb, B_pad, D + 1] probe gradient ``multihost.py:196``
slices as [n, B_pad, C], and ``transformer_flag``, whose codebooks it does
not pass to ``model_forward``.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import List, Optional

import torch
import torch.distributed as dist

from vq_gnn_tpu_torch.config import Config, no_reference_path
from vq_gnn_tpu_torch.nn.model import BNState, ModelStatic
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch
from vq_gnn_tpu_torch.train.optim import rmsprop_update
from vq_gnn_tpu_torch.train.state import TrainState
from vq_gnn_tpu_torch.train.step import (
    draw_branch_masks,
    live_vq_update,
    masked_ce_parts,
    step_forward,
)

# 'grad': the parameter gradients; 'stats': the VQ BN moments, the EMA
# counts and sums, the sync-BN running statistics (the sharded steps: the
# inter-layer BN's moments); 'c_indices': the batch ids and the
# assignments; 'scalars': the CE count and the loss; the sharded steps'
# (parallel/sharded.py) 'rows': the row exchange, 'partials': the 2-D
# mesh's model-axis sums, 'logits': the COO GAT conv's table of every
# rank's logits and its backward sum, 'transformer': the transformer
# branch's c_max and out_M normaliser, each with its backward, 'link': the
# link step's gather of every rank's output rows and its backward sum
CATEGORIES = ("grad", "stats", "c_indices", "scalars", "rows", "partials", "logits",
              "transformer", "link")


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0):
    """``torch.distributed.init_process_group`` for one rank; returns the
    default group.  ``backend`` None: 'nccl' with a GPU, else 'gloo'.
    ``init_method`` None: ``tcp://localhost:<a free port>``, for a group of
    one (more ranks need one address, given to all of them).  A group that
    is already up is returned as it is."""
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        if world_size > 1:
            raise ValueError("init_method is needed for more than one rank")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            init_method = f"tcp://localhost:{s.getsockname()[1]}"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD


def partition_hosts(adj, num_hosts: int):
    """A locality-preserving node partition, one part per rank: returns
    (perm, ptr) as the cluster partitioner does; permute the graph with it
    (``graph.partition.permute_graph``), then rank r owns the nodes
    [ptr[r], ptr[r+1]) and passes them as ``BatchLoader(node_range=)``."""
    from vq_gnn_tpu_torch.graph.partition import partition_graph

    return partition_graph(adj, num_hosts)


@dataclasses.dataclass
class CollectiveLedger:
    """The collectives the step issued: bytes and calls by category
    (``CATEGORIES``), and each kind of call as (category, op, dtype, the
    shapes packed into it).  An all-gather counts the bytes it returns,
    every rank's part; an all-reduce its buffer."""

    bytes: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(CATEGORIES, 0))
    calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(CATEGORIES, 0))
    kinds: set = dataclasses.field(default_factory=set)
    steps: int = 0

    def add(self, category: str, op: str, t: torch.Tensor, shapes) -> None:
        self.bytes[category] += t.numel() * t.element_size()
        self.calls[category] += 1
        self.kinds.add((category, op, str(t.dtype).replace("torch.", ""),
                        tuple(tuple(s) for s in shapes)))

    def per_step(self) -> dict:
        """{'bytes': {category: bytes a step}, 'calls': {category: calls a step}}."""
        n = max(self.steps, 1)
        return {"bytes": {k: v / n for k, v in self.bytes.items()},
                "calls": {k: v / n for k, v in self.calls.items()}}

    def reset(self) -> None:
        self.bytes = dict.fromkeys(CATEGORIES, 0)
        self.calls = dict.fromkeys(CATEGORIES, 0)
        self.kinds = set()
        self.steps = 0


# all_gather_single is the newer name of all_gather_into_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _Collectives:
    """The step's collectives over one group, each entered in the ledger."""

    def __init__(self, group, ledger: CollectiveLedger):
        self.group, self.ledger = group, ledger
        self.size = dist.get_world_size(group)

    def sum(self, tensors: List[torch.Tensor], category: str) -> List[torch.Tensor]:
        """Each tensor summed over the ranks: one all-reduce of one flat
        buffer; returns views of it in the tensors' shapes."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.ledger.add(category, "all_reduce", flat, [t.shape for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, o = [], 0
        for t in tensors:
            out.append(flat[o : o + t.numel()].view(t.shape))
            o += t.numel()
        return out

    def max(self, t: torch.Tensor, category: str) -> torch.Tensor:
        """A copy of ``t`` reduced over the ranks by max (one all-reduce)."""
        out = t.contiguous().clone()
        self.ledger.add(category, "all_reduce_max", out, [out.shape])
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, t: torch.Tensor, category: str) -> torch.Tensor:
        """Every rank's ``t`` along dim 0, in rank order."""
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather(out, t.contiguous(), group=self.group)
        self.ledger.add(category, "all_gather", out, [out.shape])
        return out


def _cidx_merge(comm: _Collectives, rows: torch.Tensor, src: torch.Tensor, small: bool):
    """``vq_update``'s ``cidx_merge_fn``: c_indices[rows] = every rank's
    [B, nb] assignments, in place.  ``rows`` are all ranks' batch ids
    (gathered once a step), ``src[i]`` the last position of ``rows[i]``'s node
    among them, so a node in two ranks' batches, and the dustbin row, take
    one row whatever order the writes land in."""

    def merge(c_indices: torch.Tensor, batch_idx: torch.Tensor, idx: torch.Tensor) -> None:
        upd = idx.t().contiguous()
        upd = upd.to(torch.uint8) if small else upd.to(torch.int16).view(torch.uint8)
        got = comm.gather(upd, "c_indices")
        got = got.to(torch.int16) if small else got.view(torch.int16)
        c_indices.index_copy_(0, rows, got.index_select(0, src))

    return merge


def make_ddp_step(ms: ModelStatic, cfg: Config, group=None):
    """The data-parallel step over ``group`` (None: the default group; see
    the module docstring).  ``ddp_step(state, X_dev, batch, warm_up_rate,
    lr, do_opt_step, generator=None, branch_masks=None, dropout_keeps=None)``
    steps this rank's batch as ``train_step`` takes it (``generator`` draws
    this rank's dropout) and returns (state, {'loss', 'bad_init'}), the
    state updated in place.  The ledger is ``ddp_step.ledger``."""
    if ms.formulation == "bm" and ms.conv_type == "GAT":
        raise no_reference_path("the data-parallel step with B + M GAT")
    if ms.transformer_flag:
        raise no_reference_path("the data-parallel step with transformer_flag")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed first")
    comm = _Collectives(group, CollectiveLedger())
    if cfg.mesh_data and cfg.mesh_data != comm.size:
        raise ValueError(f"mesh_data={cfg.mesh_data}, but the process group has {comm.size} "
                         f"ranks (0 means every rank)")
    if comm.size > 1 and not cfg.fixed_B_pad:
        raise ValueError("data-parallel ranks need one set of batch shapes: set "
                         "Config.fixed_B_pad, fixed_Bp_pad and fixed_E_pad")
    live = cfg.vq_update_mode == "live"
    mask_gens = {}  # per device: the dropbranch draws, alike on every rank

    def ddp_step(state: TrainState, X_dev: torch.Tensor, batch: PaddedBatch, warm_up_rate,
                 lr, do_opt_step, generator=None, branch_masks=None, dropout_keeps=None):
        dev = X_dev.device
        if branch_masks is None and ms.dropbranch > 0:
            if dev not in mask_gens:
                mask_gens[dev] = torch.Generator(device=dev).manual_seed(cfg.seed)
            branch_masks = draw_branch_masks(ms, mask_gens[dev], dev)
        params = list(state.model.parameters())
        out, info_b, layer_inputs, new_bn, probes, _ = step_forward(
            state, ms, X_dev, batch, warm_up_rate, generator, branch_masks, dropout_keeps)
        ce_sum, count = masked_ce_parts(out, batch.y, batch.train_mask & batch.valid_B)
        (count_all,) = comm.sum([count.detach()], "scalars")
        loss_r = ce_sum / torch.clamp(count_all, min=1.0) + info_b
        grads = torch.autograd.grad(loss_r, params + probes)
        g_params = comm.sum(list(grads[: len(params)]), "grad")
        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)
        (loss,) = comm.sum([loss_r.detach()], "scalars")
        k = len(new_bn.mean)
        if k:  # sync-BN: the ranks' running statistics averaged
            tot = comm.sum(new_bn.mean + new_bn.var, "stats")
            new_bn = BNState(mean=[t / comm.size for t in tot[:k]],
                             var=[t / comm.size for t in tot[k:]])
        state.bn_state = new_bn

        if live:
            rows = comm.gather(batch.batch_idx.to(torch.int32), "c_indices").long()
            last = torch.full((state.vq_states[0].c_indices.shape[0],), -1, dtype=torch.long,
                              device=dev)
            last.scatter_reduce_(0, rows, torch.arange(rows.numel(), device=dev), "amax")
            merge = _cidx_merge(comm, rows, last.index_select(0, rows), ms.vq.num_M <= 256)

            def stats_reduce(tensors):
                return comm.sum(tensors, "stats")

            live_vq_update(state, ms, layer_inputs, grads[len(params) :], [], batch,
                           branch_masks, stats_reduce=stats_reduce, cidx_merge_fn=merge)

        state.step += 1
        comm.ledger.steps += 1
        return state, {"loss": loss,
                       "bad_init": torch.stack([s.bad_init for s in state.vq_states]).any()}

    ddp_step.ledger = comm.ledger
    return ddp_step
