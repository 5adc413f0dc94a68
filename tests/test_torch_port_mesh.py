"""The port's single-batch sharding (``vq_gnn_tpu_torch/parallel/mesh.py``,
``parallel/sharded.py``) against the JAX package's ``train_step`` under
``shard_train_inputs`` / ``shard_train_inputs_2d``
(``vq_gnn_tpu/parallel/mesh.py``), on the CPU.

Four gloo ranks are spawned once for the module (``_torch_mesh_worker.py``,
``init_method=file://`` in a temporary directory).  Every rank builds each
case's first batch alike, keeps its shard and runs one sharded step from
the JAX package's initial state, or for a B + M case from the state one
JAX ``train_step`` on the whole batch left (``Case.warm``: from the
initial state the recovery term is zero, and the reference's
``info_backward`` is held non-zero); the pytest process holds what they
saw to the references:

(a) the shards' sub-ELLs and sub-transposed-ELLs, with their row offsets
    and long rows, reassemble the batch's exactly, at 2 and 4 ranks, the
    GAT shards' transposed slots of their boundary columns too;
(b) the 1-D step at 2 and 4 ranks, GCN, SAGE and GAT, against the JAX
    ``train_step`` on ``shard_train_inputs(make_mesh(8))`` of the same state
    and batch, with ``tests/test_multichip.py``'s tolerances: the loss to
    rtol 1e-5, the parameters to atol 1e-2 (the inter-layer BN is on: the
    biases ahead of it have a zero gradient in exact arithmetic, and
    RMSprop's first step turns its rounding noise into an lr-sized move),
    the codebooks to 2e-5, ``c_indices[:N]`` equal, and RMSprop's square
    averages (the gradients' size, which a first step's parameters do not
    show) to ``F32_TOL``;
(c) the same cases without the inter-layer BN against the port's
    ``train_step`` on the whole batch, the parameters to atol 1e-4, and one
    with dropbranch and dropout on the whole batch's masks;
(d) the 2-D step at 2 x 2 against JAX ``shard_train_inputs_2d(make_mesh_2d(4,
    2))``, GCN and GAT: the loss, ``c_indices[:N]`` and the codebooks, each
    model rank holding nb / 2 branches and its fan-in columns; without the
    BN (GCN, SAGE and GAT) against the port's ``train_step`` as in (c);
(e) the collective ledger on the 4,000-node graph of
    ``tests/test_collective_audit.py:125``: no payload as large as the
    feature table or a ``c_indices`` table, none shaped like an edge array;
(f) the padding errors (B_pad, and a link batch's L_pad);
(g) bf16 compute (GCN, SAGE and GAT at 4 ranks) against the JAX sharded
    ``train_step`` at ``tests/test_torch_port_bf16.py``'s tolerances (the
    loss to 5e-3, the codebooks to rtol 2e-2, the parameters to 1e-2,
    ``BF16_TOL``; ``c_indices[:N]`` equal), and GAT bf16 without the BN,
    1-D and 2-D (the partial logits summed before the bf16 rounding), and
    SAGE bf16 without the BN on the 2-D mesh, against the port's
    whole-batch step to the same; f16 compute (GCN at 4 ranks, GAT at
    2 x 2) against the JAX sharded ``train_step`` to the same;
(h) the Trick-1 scale over two ranks with its maximum tied across them:
    the logits' gradients are those of torch's masked max over the whole
    batch; per branch too (B + M), and the transformer branch's c_max;
(i) B + M (``formulation='bm'``, without the inter-layer BN: ``CASES``
    says why): GCN, SAGE and GAT at 2 and 4 ranks and 2 x 2, GAT at bf16,
    SAGE on the mixed-K layout and on COO, GCN on COO, GAT on COO at 2, 4
    and 2 x 2, and the transformer branch (GCN at 2, 4 and 2 x 2, SAGE and
    GAT at 4, GAT bf16 at 4: the transformer stays f32) against the JAX
    sharded ``train_step`` as in (b) and (g), GAT 1-D and 2-D (and GAT on
    COO 2-D) against the port's whole-batch step as in (c), GCN with the
    transformer and dropbranch 0.5 likewise; every codebook of the
    transformer and its ``c_indices`` beside the layers'; the shards'
    reverse lists (rev-ELL slots, raw entries) reassembling the batch's;
    (e) on B + M with the BN at an 8,000-node graph, the transformer's and
    the COO GAT conv's payloads too;
(j) the 2-D split of the transformer's state in-process: its codebooks by
    branch, ``transformer_k`` by branch rows, ``transformer_v`` and
    ``transformer_res`` by fan-in columns, each with its RMSprop square
    average, reassembling the whole;
(k) link and multilabel batches.  The sharded link step (GCN at 2, 4 and
    2 x 2, SAGE and GAT at 4, GAT at 2 x 2 with a per-layer clip whose
    scale is below 1 on some layer, GCN at bf16, GCN B + M from a state
    one JAX link step in) against the JAX ``make_link_step`` on the same
    sharded inputs, fed JAX's own negatives (``tests/test_torch_port_link.py``
    derives them the same way) and its predictor, which is held like the
    model (its parameters and RMSprop square averages); GCN with predictor
    and model dropout and dropbranch against the port's whole-batch
    ``link_train_step`` on the whole batch's masks, 1-D and 2-D; the
    multilabel step (GCN at 2, 4 and 2 x 2, SAGE at 4, GAT at 2 x 2, GCN
    at bf16) against the JAX ``train_step`` of ``make_step_fns(multilabel=
    True)``; the shards' link blocks reassembling the batch's pairs; the
    link ledger ([B_pad, C_out] each way a step) at the audit's graph; the
    B + M GAT link step refused by name, as the whole batch's;
(l) float64 (``Case.f64``: the state, features, predictor and batch cast by
    ``convert.py:state_as``, ``predictor_as``, ``batch_as``; the plain
    versions in float64, a diagnostic and not a compute dtype): the link
    step at 2 ranks and on the 2-D 1 x 2 mesh, the node step at 2 ranks,
    with the inter-layer BN, against the port's whole-batch step in float64
    at 1e-9 of each tensor's largest value (``F64_TOL``): a sum's order
    moves float64 by about 2^-29 of f32's reach, so what is left is a
    fault; the VQ inputs (the probes' gradients, the layer inputs) too.

The replicated state (parameters, codebooks, BN) agrees across the ranks
that hold it.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import model as jmodel
from vq_gnn_tpu.parallel import mesh as jmesh
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train import link as jlink
from vq_gnn_tpu.train.optim import init_rmsprop as j_init_rmsprop
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch import parallel as tpar
from vq_gnn_tpu_torch.convert import (
    batch_as,
    predictor_as,
    predictor_from_numpy,
    state_as,
    state_from_numpy,
)
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.ops import gat as tgat
from vq_gnn_tpu_torch.ops.spmm import gathered_order, long_rows_host, row_offsets_host
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import link as tlink
from vq_gnn_tpu_torch.train.loop import device_features
from vq_gnn_tpu_torch.train.optim import rmsprop_nu
from vq_gnn_tpu_torch.train.step import make_step_fns
from tests._torch_mesh_worker import vq_inputs
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
LR = 0.01
GRAPH = dict(num_nodes=400, num_features=16, seed=0)  # tests/test_multichip.py's
AUDIT_GRAPH = dict(num_nodes=4000, num_features=16, seed=0)  # test_collective_audit.py:125
# ... for B + M: its GAT conv exchanges rows C + 2 nb wide (x and both logits),
# which on the 4,000-node graph's batch (960 rows) outweigh a c_indices table
AUDIT_GRAPH_BM = dict(AUDIT_GRAPH, num_nodes=8000)
BASE = dict(dataset="synthetic", conv_type="GCN", num_layers=2, hidden_channels=16, num_D=4,
            num_M=8, batch_size=128, skip=True, pad_multiple_nodes=64, pad_multiple_edges=512,
            vq_update_mode="live", lr=LR)
NO_BN = dict(bn_flag=False)
SAGE = dict(conv_type="SAGE")
GAT = dict(conv_type="GAT")
BF16 = dict(compute_dtype="bfloat16")
F16 = dict(compute_dtype="float16")
OPTIONS = dict(bn_flag=False, dropbranch=0.5, dropout=0.5)
MIXED = dict(ell_Kt=2)  # the mixed-K layout, K = 8 + 2
COO = dict(spmm_backend="coo")
BM = dict(formulation="bm", bn_flag=False)
TR = dict(transformer_flag=True)
# the link step's per-layer clip on the 2-D mesh: bounds below the
# gradients' norms (test_sharded_link_step_matches_jax holds a scale below
# 1): on this batch the port's whole-batch step from its own initial state
# gives gnn_transform norms of about 1e-2 and att_l with att_r about 1e-4,
# so at (1.0, 0.5) no scale falls below 1
CLIP = dict(clip=(2e-3, 2e-5))
ML_GRAPH = dict(GRAPH, multilabel=True, num_classes=6)  # multilabel targets [N, 6]
REF_KEY = 3  # the PRNGKey of the JAX reference steps (a link step's negatives)


class Case(NamedTuple):
    kw: dict  # Config fields over BASE
    mesh: tuple
    ref: Optional[str]  # 'jax', 'port' or None (no reference)
    graph: dict
    # start from the state after one whole-batch JAX train_step on the
    # batch: from the initial state a B + M step's recovery term is zero
    # (the codebooks' gradient half starts at zero), so it would test nothing
    warm: bool = False
    link: bool = False  # a link batch through the link step
    f64: bool = False  # the step in float64 (the plain versions), held as (l)


CASES = {name: Case(*c) for name, c in {
    "1d-GCN-2": ({}, ("1d", 2), "jax", GRAPH),
    "1d-GCN-4": ({}, ("1d", 4), "jax", GRAPH),
    "1d-SAGE-2": (SAGE, ("1d", 2), "jax", GRAPH),
    "1d-SAGE-4": (SAGE, ("1d", 4), "jax", GRAPH),
    "1d-GCN-2-noBN": (NO_BN, ("1d", 2), "port", GRAPH),
    "1d-GCN-4-noBN": (NO_BN, ("1d", 4), "port", GRAPH),
    "1d-SAGE-2-noBN": ({**SAGE, **NO_BN}, ("1d", 2), "port", GRAPH),
    "1d-SAGE-4-noBN": ({**SAGE, **NO_BN}, ("1d", 4), "port", GRAPH),
    "1d-GCN-4-options": (OPTIONS, ("1d", 4), "port", GRAPH),
    "2d-GCN": ({}, ("2d", 2, 2), "jax", GRAPH),
    "2d-GCN-noBN": (NO_BN, ("2d", 2, 2), "port", GRAPH),
    "2d-SAGE-noBN": ({**SAGE, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    "1d-GCN-4-audit": ({}, ("1d", 4), None, AUDIT_GRAPH),
    "1d-GAT-2": (GAT, ("1d", 2), "jax", GRAPH),
    "1d-GAT-4": (GAT, ("1d", 4), "jax", GRAPH),
    "2d-GAT": (GAT, ("2d", 2, 2), "jax", GRAPH),
    "1d-GAT-4-noBN": ({**GAT, **NO_BN}, ("1d", 4), "port", GRAPH),
    "2d-GAT-noBN": ({**GAT, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    "1d-GCN-bf16-4": (BF16, ("1d", 4), "jax", GRAPH),
    "1d-GAT-bf16-4": ({**GAT, **BF16}, ("1d", 4), "jax", GRAPH),
    "1d-GAT-bf16-4-noBN": ({**GAT, **BF16, **NO_BN}, ("1d", 4), "port", GRAPH),
    "2d-GAT-bf16-noBN": ({**GAT, **BF16, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    "1d-SAGE-bf16-4": ({**SAGE, **BF16}, ("1d", 4), "jax", GRAPH),
    "2d-SAGE-bf16-noBN": ({**SAGE, **BF16, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    # f16 compute, from the initial state (its first live step is finite)
    "1d-GCN-f16-4": (F16, ("1d", 4), "jax", GRAPH),
    "2d-GAT-f16": ({**GAT, **F16}, ("2d", 2, 2), "jax", GRAPH),
    # the mixed-K and COO layouts
    "1d-GCN-mixed-2": (MIXED, ("1d", 2), "jax", GRAPH),
    "1d-GCN-mixed-4": (MIXED, ("1d", 4), "jax", GRAPH),
    "1d-SAGE-mixed-2": ({**SAGE, **MIXED}, ("1d", 2), "jax", GRAPH),
    "1d-SAGE-mixed-4": ({**SAGE, **MIXED}, ("1d", 4), "jax", GRAPH),
    "1d-GAT-mixed-2": ({**GAT, **MIXED}, ("1d", 2), "jax", GRAPH),
    "1d-GAT-mixed-4": ({**GAT, **MIXED}, ("1d", 4), "jax", GRAPH),
    "2d-GCN-mixed": (MIXED, ("2d", 2, 2), "jax", GRAPH),
    "2d-GAT-mixed": ({**GAT, **MIXED}, ("2d", 2, 2), "jax", GRAPH),
    "1d-GCN-coo-4": (COO, ("1d", 4), "jax", GRAPH),
    "1d-GAT-coo-4": ({**GAT, **COO}, ("1d", 4), "jax", GRAPH),
    "2d-GCN-coo": (COO, ("2d", 2, 2), "jax", GRAPH),
    "2d-GAT-coo": ({**GAT, **COO}, ("2d", 2, 2), "jax", GRAPH),
    "1d-GAT-mixed-bf16-4": ({**GAT, **MIXED, **BF16}, ("1d", 4), "jax", GRAPH),
    "1d-GAT-coo-bf16-4": ({**GAT, **COO, **BF16}, ("1d", 4), "jax", GRAPH),
    "2d-GAT-mixed-noBN": ({**GAT, **MIXED, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    "2d-GAT-coo-noBN": ({**GAT, **COO, **NO_BN}, ("2d", 2, 2), "port", GRAPH),
    # B + M, each from a state one step in (Case.warm), without the
    # inter-layer BN (BM) but one: from such a state, with the recovery term
    # in the loss, the gradient of the biases ahead of the BN, zero in exact
    # arithmetic, is rounding noise that RMSprop turns into moves of about
    # lr, which no summation order repeats (the JAX package's one-device
    # and 8-device steps leave layer 0's GCN biases 1.36e-2 apart); the case
    # with the BN holds every other parameter (_check)
    "1d-GCN-bm-2": (BM, ("1d", 2), "jax", GRAPH, True),
    "1d-GCN-bm-4": (BM, ("1d", 4), "jax", GRAPH, True),
    "1d-SAGE-bm-2": ({**BM, **SAGE}, ("1d", 2), "jax", GRAPH, True),
    "1d-SAGE-bm-4": ({**BM, **SAGE}, ("1d", 4), "jax", GRAPH, True),
    "1d-GAT-bm-2": ({**BM, **GAT}, ("1d", 2), "jax", GRAPH, True),
    "1d-GAT-bm-4": ({**BM, **GAT}, ("1d", 4), "jax", GRAPH, True),
    "2d-GCN-bm": (BM, ("2d", 2, 2), "jax", GRAPH, True),
    "2d-SAGE-bm": ({**BM, **SAGE}, ("2d", 2, 2), "jax", GRAPH, True),
    "2d-GAT-bm": ({**BM, **GAT}, ("2d", 2, 2), "jax", GRAPH, True),
    "1d-GAT-bm-bf16-4": ({**BM, **GAT, **BF16}, ("1d", 4), "jax", GRAPH, True),
    "1d-SAGE-bm-mixed-4": ({**BM, **SAGE, **MIXED}, ("1d", 4), "jax", GRAPH, True),
    "1d-SAGE-bm-coo-4": ({**BM, **SAGE, **COO}, ("1d", 4), "jax", GRAPH, True),
    "1d-GCN-bm-coo-4": ({**BM, **COO}, ("1d", 4), "jax", GRAPH, True),
    "1d-GCN-bm-bn-4": ({**BM, "bn_flag": True}, ("1d", 4), "jax", GRAPH, True),
    "1d-SAGE-bm-bn-4": ({**BM, **SAGE, "bn_flag": True}, ("1d", 4), "jax", GRAPH, True),
    "1d-GAT-bm-4-noBN": ({**BM, **GAT}, ("1d", 4), "port", GRAPH, True),
    "2d-GAT-bm-noBN": ({**BM, **GAT}, ("2d", 2, 2), "port", GRAPH, True),
    # the transformer branch (its codebooks' gradient half starts at zero
    # too) and the B + M GAT conv on COO
    "1d-GCN-bm-tr-2": ({**BM, **TR}, ("1d", 2), "jax", GRAPH, True),
    "1d-GCN-bm-tr-4": ({**BM, **TR}, ("1d", 4), "jax", GRAPH, True),
    "2d-GCN-bm-tr": ({**BM, **TR}, ("2d", 2, 2), "jax", GRAPH, True),
    "1d-SAGE-bm-tr-4": ({**BM, **SAGE, **TR}, ("1d", 4), "jax", GRAPH, True),
    "1d-GAT-bm-tr-4": ({**BM, **GAT, **TR}, ("1d", 4), "jax", GRAPH, True),
    "1d-GAT-bm-tr-bf16-4": ({**BM, **GAT, **BF16, **TR}, ("1d", 4), "jax", GRAPH, True),
    "1d-GCN-bm-tr-4-options": ({**BM, **TR, "dropbranch": 0.5}, ("1d", 4), "port", GRAPH, True),
    "1d-GAT-bm-coo-2": ({**BM, **GAT, **COO}, ("1d", 2), "jax", GRAPH, True),
    "1d-GAT-bm-coo-4": ({**BM, **GAT, **COO}, ("1d", 4), "jax", GRAPH, True),
    "2d-GAT-bm-coo": ({**BM, **GAT, **COO}, ("2d", 2, 2), "jax", GRAPH, True),
    "2d-GAT-bm-coo-noBN": ({**BM, **GAT, **COO}, ("2d", 2, 2), "port", GRAPH, True),
    # (e) on B + M, with the BN: the recovery term's lists ride no collective
    "1d-SAGE-bm-4-audit": ({**BM, **SAGE, "bn_flag": True}, ("1d", 4), None, AUDIT_GRAPH_BM),
    "1d-GAT-bm-4-audit": ({**BM, **GAT, "bn_flag": True}, ("1d", 4), None, AUDIT_GRAPH_BM),
    "1d-SAGE-bm-coo-4-audit": ({**BM, **SAGE, **COO, "bn_flag": True}, ("1d", 4), None,
                               AUDIT_GRAPH_BM),
    "1d-GCN-bm-tr-4-audit": ({**BM, **TR, "bn_flag": True}, ("1d", 4), None, AUDIT_GRAPH_BM),
    "1d-GAT-bm-coo-4-audit": ({**BM, **GAT, **COO, "bn_flag": True}, ("1d", 4), None,
                              AUDIT_GRAPH_BM),
    # (k) link batches through the link step (B + M from a state one JAX
    # link step in), and multilabel batches through the node step's BCE
    "1d-GCN-link-2": ({}, ("1d", 2), "jax", GRAPH, False, True),
    "1d-GCN-link-4": ({}, ("1d", 4), "jax", GRAPH, False, True),
    "2d-GCN-link": ({}, ("2d", 2, 2), "jax", GRAPH, False, True),
    "1d-SAGE-link-4": (SAGE, ("1d", 4), "jax", GRAPH, False, True),
    "1d-GAT-link-4": (GAT, ("1d", 4), "jax", GRAPH, False, True),
    "2d-GAT-link-clip": ({**GAT, **CLIP}, ("2d", 2, 2), "jax", GRAPH, False, True),
    "1d-GCN-link-bf16-4": (BF16, ("1d", 4), "jax", GRAPH, False, True),
    "1d-GCN-bm-link-4": (BM, ("1d", 4), "jax", GRAPH, True, True),
    "1d-GCN-link-4-options": (OPTIONS, ("1d", 4), "port", GRAPH, False, True),
    "2d-GCN-link-options": (OPTIONS, ("2d", 2, 2), "port", GRAPH, False, True),
    "1d-GCN-link-4-audit": ({}, ("1d", 4), None, AUDIT_GRAPH, False, True),
    # (l) float64: the link step on both meshes of the link probe
    # (tools/link_hold_probe_torch.py: 1-D at 2, 2-D at 1 x 2), the node step
    "1d-GCN-link-2-f64": ({}, ("1d", 2), "port", GRAPH, False, True, True),
    "2d-GCN-link-f64": ({}, ("2d", 1, 2), "port", GRAPH, False, True, True),
    "1d-GCN-2-f64": ({}, ("1d", 2), "port", GRAPH, False, False, True),
    "1d-GCN-ml-2": ({}, ("1d", 2), "jax", ML_GRAPH),
    "1d-GCN-ml-4": ({}, ("1d", 4), "jax", ML_GRAPH),
    "2d-GCN-ml": ({}, ("2d", 2, 2), "jax", ML_GRAPH),
    "1d-SAGE-ml-4": (SAGE, ("1d", 4), "jax", ML_GRAPH),
    "2d-GAT-ml": (GAT, ("2d", 2, 2), "jax", ML_GRAPH),
    "1d-GCN-ml-bf16-4": (BF16, ("1d", 4), "jax", ML_GRAPH),
}.items()}
# tests/test_multichip.py:50-76 (BN on), and the parameters without it
RTOL_LOSS, ATOL_PARAMS_BN, ATOL_PARAMS, TOL_CODEBOOK = 1e-5, 1e-2, 1e-4, 2e-5
# RMSprop's square averages after the first step, (1 - alpha) g^2: rtol,
# and the same times the largest of the tensor as the atol, where that is
# above NU_FLOOR (the biases ahead of the BN, whose gradient is rounding
# noise about 1e-9: nu about 1e-19).  Measured worst gap: 3e-6 of the
# largest in f32; a gradient off by a factor of 2 moves nu by 3 times it
F32_TOL = dict(loss=(RTOL_LOSS, 0.0), codebook=(TOL_CODEBOOK, TOL_CODEBOOK), nu=1e-4)
NU_FLOOR = 1e-12
# bf16 compute: the loss to tests/test_torch_port_bf16.py's LOSS_TOL; the
# codebooks, whose gradient half follows the probe gradients, to that
# file's gradient tolerance (LEAF_RTOL 2e-2, its 3e-5 floor as the atol);
# the parameters to ATOL_PARAMS_BN with or without the BN: a sum in another
# order (the 2-D mesh sums partial logits before the bf16 rounding) moves a
# bf16 logit by one unit, and RMSprop's first step turns the change of a
# small gradient into a move of up to lr (the JAX package's own 2-D bf16
# step moves layer 0's att_l 2.9e-2 from its one-device step on 2d-GAT-
# bf16-noBN's inputs); c_indices[:N] equal all the same
# bf16 compute; nu to 5e-2 (measured: 2e-2 of the largest, the 2-D GAT's
# att_r, from the logits rounded after the model sum) and to 0.25 against
# JAX (measured: 0.15 of the largest, layer 0's att_l under the BN, which
# the port's whole-batch step shows against JAX alike)
BF16_TOL = dict(loss=(5e-3, 5e-3), codebook=(2e-2, 3e-5), params=ATOL_PARAMS_BN, nu=5e-2)
BF16_JAX_NU = 0.25
# (l) float64: the loss to rtol 1e-9; every other tensor (the parameters,
# their nu, the predictor's, the codebooks, the VQ inputs) to 1e-9 of its
# largest |value|, rtol 0; nu's largest no less than NU_FLOOR (the biases
# ahead of the BN, a zero gradient in exact arithmetic: float64 noise).
# Measured worst, of the largest (-k f64 -s): the VQ inputs 3.0e-16, the
# parameters 4.2e-11 (those biases: noise that RMSprop scales by lr / eps),
# the codebooks 7.1e-18, the predictor 2.0e-16, the loss 0
F64_TOL = dict(loss=(1e-9, 0.0), rel=1e-9)
# (h): two ranks' logits; al's maximum 2.5 once on each rank, ar's 1.25
# twice on rank 0 and once on rank 1, and a larger value on an invalid row
# of each; each rank's cotangent of the scale is its part of the whole
SCALE_TIE = dict(
    name="scale-tie", kind="scale",
    al=[np.array([0.5, 2.5, -1.0, 9.0, 0.25], np.float32),
        np.array([1.0, -2.0, 7.0, 2.5, 0.0], np.float32)],
    ar=[np.array([1.25, 0.5, 1.25, 3.0, -0.5], np.float32),
        np.array([-1.0, 1.25, 0.75, 0.0, 4.0], np.float32)],
    valid=[np.array([True, True, True, False, True]),
           np.array([True, True, False, True, False])],
    g=[0.75, -0.3125])
# (h) per branch (the B + M scale): three branches, rows [B, nb] on two
# ranks, the codebooks' logits [nb, M] alike on both, a larger value on an
# invalid row of each rank.  al: branch 0's maximum 2.5 once on each rank,
# above the codebooks'; branch 1's codebooks' maximum above every row's;
# branch 2's rows' 1.5 (once on rank 0, twice on rank 1) tied with its
# codebooks'.  ar: branch 0's rows' 1.0 (twice on rank 1) tied with two
# codewords; branch 1's 1.25 on three rows of both ranks and a codeword;
# branch 2's 2.0 on three rows of both ranks, above the codebooks'.  Each
# rank's cotangent is its part of the whole
SCALE_TIE_BRANCH = dict(
    name="scale-tie-branch", kind="branch-scale",
    al=[np.array([[2.5, 0.0, 1.5], [1.0, 0.5, -1.0], [9.0, 9.0, 9.0], [-0.5, 0.25, 0.0]],
                 np.float32),
        np.array([[0.5, 0.75, 1.5], [2.5, -2.0, 1.5], [0.0, 1.0, -3.0], [7.0, 7.0, 7.0]],
                 np.float32)],
    ar=[np.array([[0.5, 1.25, 2.0], [0.75, 1.25, -1.0], [8.0, 8.0, 8.0], [0.0, 0.5, 2.0]],
                 np.float32),
        np.array([[1.0, 1.25, 0.5], [-0.5, 0.0, 2.0], [1.0, -1.0, 0.25], [6.0, 6.0, 6.0]],
                 np.float32)],
    valid=[np.array([True, True, False, True]), np.array([True, True, True, False])],
    al_cb=np.array([[1.0, -1.0], [3.0, 2.0], [1.5, 0.0]], np.float32),
    ar_cb=np.array([[1.0, 1.0], [0.5, 1.25], [-2.0, 1.0]], np.float32),
    g=[np.array([0.75, -0.5, 1.25], np.float32), np.array([-0.3125, 0.25, 0.5], np.float32)])
# (h) the transformer branch's c_max: the rows' squared norms [B, nb] on two
# ranks, the codewords' [M, nb] alike on both, a larger value on an invalid
# row of each rank.  Branch 0's rows' maximum 4.0 once on each rank, above
# the codewords'; branch 1's codewords' 9.0 twice, above every row's; branch
# 2's rows' 2.25 (once on rank 0, twice on rank 1) tied with a codeword.
# Each rank's cotangent of c_max is its part of the whole
SCALE_TIE_CMAX = dict(
    name="transformer-cmax", kind="cmax",
    al=[np.array([[4.0, 1.0, 2.25], [1.0, 3.0, 0.5], [16.0, 16.0, 16.0], [0.25, 2.0, 1.0]],
                 np.float32),
        np.array([[2.0, 0.5, 2.25], [4.0, 5.0, 2.25], [0.0, 1.0, 0.75], [25.0, 25.0, 25.0]],
                 np.float32)],
    valid=[np.array([True, True, False, True]), np.array([True, True, True, False])],
    al_cb=np.array([[3.0, 9.0, 2.25], [1.0, 9.0, 0.5]], np.float32),
    g=[np.array([0.75, -0.5, 1.25], np.float32), np.array([-0.3125, 0.25, 0.5], np.float32)])
BATCH_FIELDS = ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask")
LINK_FIELDS = ("link_src", "link_dst", "link_mask")
# the adjacency each layout's batch must carry (the worker sends every field it has)
EDGE_FIELDS = {
    "single-K": ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col", "t_ell_val"),
    "mixed-K": ("head_rowc", "head_col", "head_val", "head_inv", "head_rowg", "tail_row",
                "tail_col", "tail_val", "t_head_rowc", "t_head_col", "t_head_val", "t_head_inv",
                "t_head_rowg", "t_tail_row", "t_tail_col", "t_tail_val"),
    "COO": ("row", "col", "val", "tperm"),
}


def _plain(x):
    """A JAX state as dicts, lists and numpy arrays (the worker imports no JAX)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return None if x is None else np.asarray(x)


def _jax_setup(kw, graph, link=False):
    """(cfg, graph, the output width (the classes, or on a link case the
    hidden width), ModelStatic, a fresh initial state) of the JAX package."""
    cfg = jcfg.Config(**{**BASE, **kw})
    g, c = jdata.synthetic_sbm(**graph)
    g, c, _ = jdata.prepare(g, cfg, c)
    if link:
        c = cfg.hidden_channels
    ms = jmodel.model_static(cfg, g.num_features, c)
    return cfg, g, c, ms, j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)


def _setup(name):
    """:func:`_jax_setup` of a case."""
    case = CASES[name]
    return _jax_setup(case.kw, case.graph, case.link)


def _masks(cfg, ms, B_pad):
    """The whole batch's dropbranch and dropout masks of a case (numpy)."""
    if not cfg.dropbranch:
        return None, None
    rng = np.random.default_rng(5)
    branch = [rng.permutation(nb) < int(nb * (1 - cfg.dropbranch)) for nb in ms.num_branches]
    keeps = [rng.random((B_pad, c)) < 1 - cfg.dropout for c in ms.channels[1:-1]]
    return branch, keeps


def _port_graph(graph, cfg):
    """The port's SBM of ``graph``'s arguments, prepared for ``cfg``."""
    g, c = tdata.synthetic_sbm(**graph)
    return tdata.prepare(g, cfg, c)[0]


def _jax_batch(cfg, g, link=False):
    loader = jsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0,
                                   with_link_edges=link)
    return next(loader._epoch_iter())[0][0]


def _jax_dst_neg(batch, key):
    """The negatives JAX ``make_link_step`` draws from ``key``
    (``vq_gnn_tpu/train/link.py:67-71``), numpy."""
    _, r_neg, _ = jax.random.split(key, 3)
    return np.asarray(jax.random.randint(r_neg, np.asarray(batch.link_src).shape, 0,
                                         jnp.maximum(batch.num_B, 1)))


def _link_masks(cfg, L_pad):
    """The whole batch's predictor keep masks of a link case (numpy; None
    without dropout): one hidden predictor layer a model layer but the last."""
    if not cfg.dropout:
        return None
    rng = np.random.default_rng(6)
    return [rng.random((L_pad, cfg.hidden_channels)) < 1 - cfg.dropout
            for _ in range(cfg.num_layers - 1)]


_STARTS = {}


def _start(name):
    """A case's starting (state, predictor), a JAX state of numpy leaves and
    on a link case the JAX predictor with its RMSprop ``nu`` (else None): the
    initial ones, or for a warm case (``Case.warm``) those after one JAX
    ``train_step`` (on a link case ``make_link_step``) on the whole of its
    first batch (one per configuration)."""
    case = CASES[name]
    key = (repr(sorted(case.kw.items())), repr(sorted(case.graph.items())), case.warm,
           case.link)
    if key not in _STARTS:
        cfg, g, c, ms, state = _setup(name)
        pred = None
        if case.link:
            pp = jlink.init_predictor(jax.random.PRNGKey(1), c, c, 1, cfg.num_layers)
            pred = (pp, j_init_rmsprop(pp))
        if case.warm:
            X, batch = j_device_features(g.x), _jax_batch(cfg, g, case.link)
            args = (jnp.float32(1.0), jnp.float32(LR), jnp.float32(1.0), jax.random.PRNGKey(2))
            if case.link:
                state, pp, nu, _ = jlink.make_link_step(ms, cfg)[0](state, *pred, X, batch,
                                                                    *args)
                pred = (pp, nu)
            else:
                state, _ = j_make_step_fns(ms, cfg, multilabel=False).train_step(
                    state, X, batch, *args)
        _STARTS[key] = jax.tree.map(np.asarray, (state, pred))
    return _STARTS[key]


def _start_state(name):
    """A case's starting state (:func:`_start`)."""
    return _start(name)[0]


def _is_bm(name):
    return CASES[name].kw.get("formulation") == "bm"


class MeshRun:
    """The plan, the four spawned ranks and, once they finish, what they saw."""

    def __init__(self, tmp):
        self.ctx, self.link, cases = {}, {}, []
        for name, case in CASES.items():
            cfg, g, c, ms, _ = _setup(name)
            batch = _jax_batch(cfg, g, case.link)
            branch, keeps = _masks(cfg, ms, batch.B_pad)
            self.ctx[name] = (cfg, g, c, ms)
            state, pred = _start(name)
            link = {}
            if case.link:  # JAX's negatives at the reference's key, the predictor
                link = dict(pred=_plain(pred[0]), pred_nu=_plain(pred[1]),
                            dst_neg=_jax_dst_neg(batch, jax.random.PRNGKey(REF_KEY)),
                            pred_keep=_link_masks(cfg, len(batch.link_src)))
                self.link[name] = link
            cases.append(dict(name=name, cfg=dataclasses.asdict(cfg), graph=case.graph,
                              state=_plain(state), mesh=case.mesh, branch_masks=branch,
                              dropout_keeps=keeps, link=case.link, f64=case.f64, **link))
        plan = os.path.join(tmp, "plan.pkl")
        with open(plan, "wb") as f:
            pickle.dump(dict(cases=cases + [SCALE_TIE, SCALE_TIE_BRANCH, SCALE_TIE_CMAX]), f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OMP_NUM_THREADS"] = "1"
        self.outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_mesh_worker.py"), str(r), str(WORLD),
             os.path.join(tmp, "pg"), plan, self.outs[r]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
        self._res = None

    def results(self):
        """Every rank's pickled results, waiting for the ranks once."""
        if self._res is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
            finally:
                self.stop()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
            self._res = []
            for out in self.outs:
                with open(out, "rb") as f:
                    self._res.append(pickle.load(f))
        return self._res

    def ranks(self, name):
        """[(rank, its result)] of the ranks in the case's mesh."""
        return [(r, res[name]) for r, res in enumerate(self.results()) if res[name]]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = MeshRun(str(tmp_path_factory.mktemp("mesh")))
    yield r
    r.stop()


def _params_nu(state):
    """({name: value}, {name: its RMSprop square average}) of a port state."""
    names, params = zip(*state.model.named_parameters())
    nu = rmsprop_nu(state.optimizer, params)
    return ({k: p.detach().numpy() for k, p in zip(names, params)},
            {k: v.numpy() for k, v in zip(names, nu)})


def _port_params(jstate, case):
    """:func:`_params_nu` of a JAX state, in the port's layout."""
    cfg, g, c, _ = case
    ms_t = tmodel.model_static(tcfg.Config(**dataclasses.asdict(cfg)), g.num_features, c,
                               torch.device("cpu"))
    return _params_nu(state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu"))


def _vq_np(states, vq_states_tr):
    """{'vq': the layers' codebooks, 'vq_tr': the transformer's} as
    [{'embedding', 'c_indices'} numpy] per layer."""
    return {k: [{f: np.asarray(getattr(s, f)) for f in ("embedding", "c_indices")}
                for s in ss or []] for k, ss in (("vq", states), ("vq_tr", vq_states_tr))}


def _jax_reference(name):
    """(loss, ({param: value}, {param: nu}), :func:`_vq_np` of the new
    state, the batch, info_backward) of one JAX ``train_step`` on a case's inputs from its
    starting state, sharded as its mesh says: the 1-D cases on
    ``make_mesh(8)``, the 2-D on ``make_mesh_2d(4, 2)``."""
    mesh, graph = CASES[name].mesh, CASES[name].graph
    cfg, g, c, ms, _ = _setup(name)
    state = jax.tree.map(jnp.asarray, _start_state(name))
    batch = _jax_batch(cfg, g)
    new, m = j_make_step_fns(ms, cfg, multilabel=graph.get("multilabel", False)).train_step(
        *_jax_placed(mesh, state, g, batch), jnp.float32(1.0), jnp.float32(LR),
        jnp.float32(1.0), jax.random.PRNGKey(REF_KEY))
    return (float(m["loss"]), _port_params(new, (cfg, g, c, ms)),
            _vq_np(new.vq_states, new.vq_states_tr), batch, float(m["info_backward"]))


def _jax_placed(mesh, state, g, batch):
    """(state, X, batch) placed as a case's mesh says: the 1-D cases on
    ``make_mesh(8)``, the 2-D on ``make_mesh_2d(4, 2)``."""
    X = j_device_features(g.x)
    if mesh[0] == "1d":
        return jmesh.shard_train_inputs(jmesh.make_mesh(8), state, X, batch)
    return jmesh.shard_train_inputs_2d(jmesh.make_mesh_2d(4, 2), state, X, batch)


def _pred_np(pred_params, pred_nu):
    """({name: value}, {name: nu}) of a JAX predictor in the port's layout."""
    pred, opt = predictor_from_numpy(jax.tree.map(np.asarray, pred_params),
                                     jax.tree.map(np.asarray, pred_nu), LR, "cpu")
    names, params = zip(*pred.named_parameters())
    return ({k: p.detach().numpy() for k, p in zip(names, params)},
            {k: v.numpy() for k, v in zip(names, rmsprop_nu(opt, params))})


def _jax_link_reference(name):
    """(metrics, ({param: value}, {param: nu}), :func:`_vq_np`, the batch,
    the predictor as :func:`_pred_np`) of one JAX ``make_link_step`` step on
    a link case's sharded inputs from its starting state and predictor, at
    ``REF_KEY`` (the negatives the ranks were given)."""
    mesh = CASES[name].mesh
    cfg, g, c, ms, _ = _setup(name)
    state, pred = jax.tree.map(jnp.asarray, _start(name))
    batch = _jax_batch(cfg, g, link=True)
    state, X, batch_s = _jax_placed(mesh, state, g, batch)
    new, pp, nu, m = jlink.make_link_step(ms, cfg)[0](
        state, *pred, X, batch_s, jnp.float32(1.0), jnp.float32(LR), jnp.float32(1.0),
        jax.random.PRNGKey(REF_KEY))
    return ({k: float(v) for k, v in m.items()}, _port_params(new, (cfg, g, c, ms)),
            _vq_np(new.vq_states, new.vq_states_tr), batch, _pred_np(pp, nu))


def _port_reference(case, graph, state_np, masks, link=None, f64=False, inputs=None):
    """(metrics, ({param: value}, {param: nu}), :func:`_vq_np` of the new
    state, and with ``link`` the predictor as :func:`_pred_np`) of the
    port's ``train_step`` on the whole batch from ``state_np``, or with
    ``link`` (the worker's plan of the case: the predictor, the negatives
    and the predictor's masks) of its ``link_train_step`` on the whole link
    batch.  With ``f64`` in float64 (as the worker casts it); ``inputs``, a
    list, takes each layer's VQ inputs (``_torch_mesh_worker.vq_inputs``)."""
    cfg, g, c, _ = case
    tc = tcfg.Config(**dataclasses.asdict(cfg))
    cpu = torch.device("cpu")
    ms = tmodel.model_static(tc, g.num_features, c, cpu)
    state = state_from_numpy(state_np, ms, LR, cpu)
    tg = _port_graph(graph, tc)
    batch = next(tsamplers.BatchLoader(tg, tc, train_flag=True, shuffle=False, seed=0,
                                       device="cpu", with_link_edges=link is not None
                                       )._epoch_iter())[0][0].to(cpu)
    branch, keeps = ([None if m is None else [torch.as_tensor(t) for t in m] for m in masks])
    X = device_features(tg.x, cpu)
    if f64:
        state, X, batch = state_as(state, torch.float64), X.double(), batch_as(batch,
                                                                                torch.float64)
    if link is None:
        with vq_inputs(inputs):
            state, m = make_step_fns(ms, tc).train_step(state, X, batch, 1.0, LR, 1.0,
                                                        branch_masks=branch, dropout_keeps=keeps)
        pred = None
    else:
        pred, opt = predictor_from_numpy(link["pred"], link["pred_nu"], LR, cpu)
        if f64:
            pred, opt = predictor_as(pred, opt, torch.float64)
        with vq_inputs(inputs):
            m = tlink.make_link_step(ms, tc)[0](
                state, pred, opt, X, batch, 1.0, LR, 1.0, dst_neg=torch.tensor(link["dst_neg"]),
                pred_keep=None if link["pred_keep"] is None else [
                    torch.as_tensor(k) for k in link["pred_keep"]], branch_masks=branch,
                dropout_keeps=keeps)
        names, params = zip(*pred.named_parameters())
        pred = ({k: p.detach().numpy() for k, p in zip(names, params)},
                {k: v.numpy() for k, v in zip(names, rmsprop_nu(opt, params))})
    return ({k: float(v) for k, v in m.items()}, _params_nu(state),
            _vq_np(state.vq_states, state.vq_states_tr), pred)


def _model_part(a, m, n_model, axis):
    w = a.shape[axis] // n_model
    return np.take(a, np.arange(m * w, (m + 1) * w), axis=axis)


def _tol(name):
    """bf16 and f16 compute ("f16" is in both names) at BF16_TOL, float64
    at F64_TOL."""
    if CASES[name].f64:
        return F64_TOL
    if "f16" not in name:
        return F32_TOL
    return {**BF16_TOL, "nu": BF16_JAX_NU} if CASES[name][2] == "jax" else BF16_TOL


def _check(name, out, rank, mesh, loss, params_nu, vq, N, atol_params):
    """One rank's step against a reference; on the 2-D mesh its model
    rank's part of it, to the case's tolerances (:func:`_tol`)."""
    n_model = mesh[2] if mesh[0] == "2d" else 1
    m = rank % n_model
    tol = _tol(name)
    rel = tol.get("rel")  # float64: of each tensor's largest value
    np.testing.assert_allclose(out["metrics"]["loss"], loss, rtol=tol["loss"][0],
                               atol=tol["loss"][1], err_msg=f"{name} rank {rank} loss")
    params, nu = params_nu
    noise = _is_bm(name) and CASES[name].kw.get("bn_flag", True)
    noisy = []
    for k, v in params.items():
        mine, nu_ref = out["params"][k], nu[k]
        # a fan-in weight's columns; a B + M GAT head's or transformer_k's branch rows
        if n_model > 1 and v.ndim >= 2:
            axis = 0 if k.endswith(("att_l", "att_r")) or ".transformer_k." in k else 1
            v, nu_ref = _model_part(v, m, n_model, axis), _model_part(nu_ref, m, n_model, axis)
        assert mine.shape == v.shape, (name, k)
        if noise and np.abs(nu_ref).max() < NU_FLOOR:
            # B + M with the BN: a gradient of rounding noise (the biases
            # ahead of the BN), held by its nu alone, not by the values
            # that noise moves by about lr
            noisy.append(k)
            print(f"{name} rank {rank}: {k} held by nu alone, max|diff| "
                  f"{np.abs(mine - v).max():.3g}, nu {np.abs(nu_ref).max():.3g}")
        elif rel:
            np.testing.assert_allclose(mine, v, rtol=0, atol=rel * np.abs(v).max(),
                                       err_msg=f"{name} rank {rank} {k}")
        else:
            np.testing.assert_allclose(mine, v, atol=tol.get("params", atol_params),
                                       err_msg=f"{name} rank {rank} {k}")
        # the first step's nu is (1 - alpha) g^2: the gradient's size, which
        # the parameters (moved by about lr sign(g)) do not show
        _hold_nu(out["nu"][k], nu_ref, tol, f"{name} rank {rank} nu of {k}")
    # only biases, and never all of them
    assert all(params[k].ndim == 1 for k in noisy) and len(noisy) < sum(
        v.ndim == 1 for v in params.values()), (name, noisy)
    assert len(out["vq_tr"]) == len(vq["vq_tr"]) == (len(vq["vq"]) if "-tr" in name else 0)
    for key in ("vq", "vq_tr"):  # the layers' codebooks, the transformer's
        for l, ref in enumerate(vq[key]):
            emb, cidx = ref["embedding"], ref["c_indices"]
            if n_model > 1:
                emb, cidx = _model_part(emb, m, n_model, 0), _model_part(cidx, m, n_model, 1)
            o = out[key][l]
            rtol, atol = (0.0, rel * np.abs(emb).max()) if rel else tol["codebook"]
            np.testing.assert_allclose(o["embedding"], emb, rtol=rtol, atol=atol,
                                       err_msg=f"{name} rank {rank} layer {l} {key} codebook")
            np.testing.assert_array_equal(o["c_indices"][:N], cidx[:N],
                                          err_msg=f"{name} rank {rank} layer {l} {key} c_indices")


def _hold_nu(got, ref, tol, err):
    """RMSprop's square averages to ``tol["nu"]`` (rtol, and times the
    largest as the atol), or in float64 to ``tol["rel"]`` of the largest
    (rtol 0); the largest no less than NU_FLOOR."""
    rel = tol.get("rel")
    scale = rel or tol["nu"]
    np.testing.assert_allclose(got, ref, rtol=0.0 if rel else scale,
                               atol=scale * max(np.abs(ref).max(), NU_FLOOR), err_msg=err)


def _replicas_agree(run, name, mesh):
    """The ranks that hold one part of the state hold it bit for bit."""
    n_model = mesh[2] if mesh[0] == "2d" else 1
    by_part = {}
    for r, out in run.ranks(name):
        by_part.setdefault(r % n_model, []).append(out)
    for outs in by_part.values():
        a = outs[0]
        for b in outs[1:]:
            assert a["metrics"] == b["metrics"], name
            for k in a["params"]:
                assert np.array_equal(a["params"][k], b["params"][k]), (name, k)
            for x, y in zip(a["vq"] + a["vq_tr"], b["vq"] + b["vq_tr"]):
                for f in x:
                    assert np.array_equal(x[f][:-1] if f == "c_indices" else x[f],
                                          y[f][:-1] if f == "c_indices" else y[f]), (name, f)
            for key in ("mean", "var"):
                for x, y in zip(a["bn"][key], b["bn"][key]):
                    assert np.array_equal(x, y), name
            for k in a.get("pred", {}):  # the link step's replicated predictor
                assert np.array_equal(a["pred"][k], b["pred"][k]), (name, k)


# ---------------------------------------------------------------------------
# (b), (d) against the JAX package's sharded train_step
# ---------------------------------------------------------------------------
def _layout(name):
    return "mixed-K" if "-mixed" in name else "COO" if "-coo" in name else "single-K"


@pytest.mark.parametrize("jname", [
    "1d-GCN", "1d-SAGE", "2d-GCN", "1d-GAT", "2d-GAT", "1d-GCN-bf16", "1d-GAT-bf16",
    "1d-SAGE-bf16", "1d-GCN-f16", "2d-GAT-f16", "1d-GCN-mixed", "1d-SAGE-mixed",
    "1d-GAT-mixed", "2d-GCN-mixed", "2d-GAT-mixed", "1d-GCN-coo", "1d-GAT-coo", "2d-GCN-coo", "2d-GAT-coo", "1d-GAT-mixed-bf16",
    "1d-GAT-coo-bf16", "1d-GCN-bm", "1d-SAGE-bm", "1d-GAT-bm", "2d-GCN-bm", "2d-SAGE-bm",
    "2d-GAT-bm", "1d-GAT-bm-bf16", "1d-SAGE-bm-mixed", "1d-SAGE-bm-coo", "1d-GCN-bm-coo",
    "1d-GCN-bm-bn", "1d-SAGE-bm-bn", "1d-GCN-bm-tr", "2d-GCN-bm-tr", "1d-SAGE-bm-tr",
    "1d-GAT-bm-tr", "1d-GAT-bm-tr-bf16", "1d-GAT-bm-coo", "2d-GAT-bm-coo", "1d-GCN-ml",
    "2d-GCN-ml", "1d-SAGE-ml", "2d-GAT-ml", "1d-GCN-ml-bf16"])
def test_sharded_step_matches_jax(run, jname):
    """Each case named ``jname`` or ``jname-<ranks>`` against one JAX
    reference."""
    names = [n for n in CASES if CASES[n][2] == "jax" and (
        n == jname or (n.startswith(jname + "-") and n[len(jname) + 1 :].isdigit()))]
    case = run.ctx[names[0]]
    loss, params, vq, jbatch, info = _jax_reference(names[0])
    if _is_bm(names[0]):  # the recovery term is in the step
        assert info != 0.0, names[0]
    N = case[1].num_nodes
    for name in names:
        mesh = CASES[name][1]
        outs = run.ranks(name)
        assert len(outs) == (mesh[1] if mesh[0] == "1d" else mesh[1] * mesh[2])
        for rank, out in outs:
            for f in BATCH_FIELDS:  # the port's loader built the JAX batch
                np.testing.assert_array_equal(out["batch"][f], np.asarray(getattr(jbatch, f)))
            assert set(EDGE_FIELDS[_layout(name)]) <= set(out["edges"]), name
            for f, a in out["edges"].items():
                np.testing.assert_array_equal(a, np.asarray(getattr(jbatch.edges, f)),
                                              err_msg=f"{name} {f}")
            _check(name, out, rank, mesh, loss, params, vq, N, ATOL_PARAMS_BN)
        _replicas_agree(run, name, mesh)
    if jname.startswith("2d"):  # each model rank: nb / 2 branches, its fan-in columns
        ms = case[3]
        for rank, out in run.ranks(jname):
            for l, nb in enumerate(ms.num_branches):
                for key in ("vq", "vq_tr") if ms.transformer_flag else ("vq",):
                    assert out[key][l]["embedding"].shape[0] == nb // 2
                    assert out[key][l]["c_indices"].shape == (N + 1, nb // 2)
                if ms.transformer_flag:  # its branches' rows, its fan-in columns
                    D = ms.num_D
                    assert out["params"][f"layers.{l}.transformer_k.w"].shape == (nb // 2, D, D)
                    for lin in ("transformer_v", "transformer_res"):
                        assert out["params"][f"layers.{l}.{lin}.weight"].shape == \
                            (ms.channels[l + 1], ms.channels[l] // 2)
                w = out["params"][f"layers.{l}.gnn_transform.weight"]
                assert w.shape == (ms.channels[l + 1], ms.channels[l] // 2)
                assert out["params"][f"layers.{l}.gnn_transform.bias"].shape == \
                    (ms.channels[l + 1],)
                if ms.formulation == "bm" and ms.conv_type == "GAT":  # its branches' heads
                    assert out["params"][f"layers.{l}.att_l"].shape == (nb // 2, ms.num_D + 1)


# ---------------------------------------------------------------------------
# (c), (d) against the port's train_step on the whole batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].ref == "port"
                                  and not CASES[n].link])
def test_sharded_step_matches_whole_batch(run, name):
    case = run.ctx[name]
    cfg, g, _, ms = case
    state = _start_state(name)
    masks = _masks(cfg, ms, _jax_batch(cfg, g).B_pad)
    m, params, vq, _ = _port_reference(case, CASES[name][3], _plain(state), masks,
                                       f64=CASES[name].f64)
    loss, info = m["loss"], m["info_backward"]
    if _is_bm(name):
        assert info != 0.0, name
    mesh = CASES[name][1]
    for rank, out in run.ranks(name):
        _check(name, out, rank, mesh, loss, params, vq, g.num_nodes, ATOL_PARAMS)
        assert np.isfinite(out["metrics"]["grad_norm"]) and not out["metrics"]["bad_init"]
    _replicas_agree(run, name, mesh)
    if cfg.dropbranch:  # the dropped branches' codebooks kept their values
        for l, keep in enumerate(masks[0]):
            for _, out in run.ranks(name):
                np.testing.assert_array_equal(out["vq"][l]["embedding"][~keep],
                                              np.asarray(state.vq_states[l].embedding)[~keep])
                if cfg.transformer_flag:
                    np.testing.assert_array_equal(
                        out["vq_tr"][l]["embedding"][~keep],
                        np.asarray(state.vq_states_tr[l].embedding)[~keep])


# ---------------------------------------------------------------------------
# (k) the link step against the JAX package's and the port's whole batch
# ---------------------------------------------------------------------------
def _check_link(name, out, rank, metrics, pred, atol_params):
    """One rank's link step's ``loss_pre`` and predictor (its parameters and
    RMSprop square averages, replicated) against a reference's."""
    tol = _tol(name)
    np.testing.assert_allclose(out["metrics"]["loss_pre"], metrics["loss_pre"],
                               rtol=tol["loss"][0], atol=tol["loss"][1],
                               err_msg=f"{name} rank {rank} loss_pre")
    assert not out["metrics"]["bad_init"], name
    values, nu = pred
    rel = tol.get("rel")
    assert set(out["pred"]) == set(values), name
    for k, v in values.items():
        np.testing.assert_allclose(out["pred"][k], v, rtol=0 if rel else 1e-7,
                                   atol=rel * np.abs(v).max() if rel else
                                   tol.get("params", atol_params),
                                   err_msg=f"{name} rank {rank} predictor {k}")
        _hold_nu(out["pred_nu"][k], nu[k], tol, f"{name} rank {rank} predictor nu of {k}")


@pytest.mark.parametrize("jname", ["1d-GCN-link", "2d-GCN-link", "1d-SAGE-link", "1d-GAT-link",
                                   "2d-GAT-link-clip", "1d-GCN-link-bf16", "1d-GCN-bm-link"])
def test_sharded_link_step_matches_jax(run, jname):
    """Each link case named ``jname`` or ``jname-<ranks>`` against one JAX
    ``make_link_step`` step on the sharded inputs (the case's mesh), fed
    the same negatives: the loss and ``loss_pre``, the model and the
    predictor, the codebooks and ``c_indices[:N]``.  B + M: the recovery
    term is in the loss.  With the clip: each layer's scale alike on every
    rank, and below 1 on some layer."""
    names = [n for n in CASES if CASES[n].ref == "jax" and CASES[n].link and (
        n == jname or (n.startswith(jname + "-") and n[len(jname) + 1 :].isdigit()))]
    metrics, params, vq, jbatch, pred = _jax_link_reference(names[0])
    if _is_bm(names[0]):  # the recovery term is in the step
        assert metrics["loss"] != metrics["loss_pre"], names[0]
    N = run.ctx[names[0]][1].num_nodes
    for name in names:
        mesh = CASES[name].mesh
        outs = run.ranks(name)
        assert len(outs) == (mesh[1] if mesh[0] == "1d" else mesh[1] * mesh[2])
        for rank, out in outs:
            for f in BATCH_FIELDS + LINK_FIELDS:  # the port's loader built the JAX batch
                np.testing.assert_array_equal(out["batch"][f], np.asarray(getattr(jbatch, f)))
            _check(name, out, rank, mesh, metrics["loss"], params, vq, N, ATOL_PARAMS_BN)
            _check_link(name, out, rank, metrics, pred, ATOL_PARAMS_BN)
        _replicas_agree(run, name, mesh)
    if CASES[names[0]].kw.get("clip"):
        scales = [out["clip_scales"] for _, out in run.ranks(names[0])]
        ms = run.ctx[names[0]][3]
        assert len(scales[0]) == 2 * ms.num_layers  # gnn_transform, att_l with att_r
        assert all(s == scales[0] for s in scales), scales
        assert min(scales[0]) < 1.0 and max(scales[0]) <= 1.0, scales[0]


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].ref == "port" and CASES[n].link])
def test_sharded_link_step_matches_whole_batch(run, name):
    """The link step with predictor and model dropout and dropbranch, 1-D
    and 2-D, against the port's ``link_train_step`` on the whole batch with
    the whole batch's masks and negatives; the dropped branches' codebooks
    keep their values.  The float64 cases, (l), without the options."""
    case = run.ctx[name]
    cfg, g, _, ms = case
    state = _start_state(name)
    masks = _masks(cfg, ms, _jax_batch(cfg, g).B_pad)
    metrics, params, vq, pred = _port_reference(case, CASES[name].graph, _plain(state), masks,
                                                link=run.link[name], f64=CASES[name].f64)
    mesh = CASES[name].mesh
    n_model = mesh[2] if mesh[0] == "2d" else 1
    for rank, out in run.ranks(name):
        _check(name, out, rank, mesh, metrics["loss"], params, vq, g.num_nodes, ATOL_PARAMS)
        _check_link(name, out, rank, metrics, pred, ATOL_PARAMS)
        for l, keep in enumerate(masks[0] or []):  # a model rank's branches
            keep = _model_part(keep, rank % n_model, n_model, 0)
            ref = _model_part(np.asarray(state.vq_states[l].embedding), rank % n_model,
                              n_model, 0)
            np.testing.assert_array_equal(out["vq"][l]["embedding"][~keep], ref[~keep])
    _replicas_agree(run, name, mesh)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n].f64])
def test_sharded_f64_vq_inputs_match_whole_batch(run, name):
    """(l): each layer's VQ inputs of the sharded float64 step, the probes'
    gradients (G) and the layer inputs (X), reassembled over the ranks (the
    1-D ranks' rows, the 2-D model ranks' branches), against the whole
    batch's float64 step at 1e-9 of each tensor's largest value (the other
    tensors: ``test_sharded_step_matches_whole_batch`` and
    ``test_sharded_link_step_matches_whole_batch``).  Prints the worst
    reading of each kind of tensor (``-s``), of its largest value."""
    case = run.ctx[name]
    mesh = CASES[name].mesh
    inputs = []
    metrics, (params, nu), vq, pred = _port_reference(
        case, CASES[name].graph, _plain(_start_state(name)), (None, None),
        link=run.link.get(name), f64=True, inputs=inputs)
    outs = run.ranks(name)
    assert len(outs) == 2 and len(inputs) == case[3].num_layers
    n_model = mesh[2] if mesh[0] == "2d" else 1

    def rel(got, ref):
        return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))

    worst = {}
    for l, whole in enumerate(inputs):
        for h in ("X", "G"):
            got = np.concatenate([out["vq_in"][l][h] for _, out in outs],
                                 axis=1 if n_model == 1 else 0)
            assert got.dtype == whole[h].dtype == np.float64, (name, l, h)
            np.testing.assert_allclose(got, whole[h], rtol=0,
                                       atol=F64_TOL["rel"] * np.abs(whole[h]).max(),
                                       err_msg=f"{name} layer {l} {h}")
            worst[h] = max(worst.get(h, 0.0), rel(got, whole[h]))
    for rank, out in outs:  # the readings of what _check holds
        m = rank % n_model
        for k, v in params.items():
            if n_model > 1 and v.ndim >= 2:
                v = _model_part(v, m, n_model, 1)
            worst["params"] = max(worst.get("params", 0.0), rel(out["params"][k], v))
        for l, ref in enumerate(vq["vq"]):
            emb = _model_part(ref["embedding"], m, n_model, 0)
            worst["codebooks"] = max(worst.get("codebooks", 0.0),
                                     rel(out["vq"][l]["embedding"], emb))
        for k, v in (pred or ({}, {}))[0].items():
            worst["predictor"] = max(worst.get("predictor", 0.0), rel(out["pred"][k], v))
        worst["loss"] = rel(np.float64(out["metrics"]["loss"]), np.float64(metrics["loss"]))
    print(f"{name}: worst |sharded - whole| of the largest, float64: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


# ---------------------------------------------------------------------------
# (e) the ledger at the audit's graph
# ---------------------------------------------------------------------------
def test_sharded_ledger_moves_no_graph_sized_payload(run):
    """As ``tests/test_collective_audit.py:125`` holds the JAX step: the
    feature table, a ``c_indices`` table and the edge arrays never ride a
    collective; the row exchange is batch-row sized, [B_pad + Bp_pad, C],
    once per layer forward and once per layer backward above layer 0."""
    name = "1d-GCN-4-audit"
    cfg, g, c, ms = run.ctx[name]
    batch = _jax_batch(cfg, g)
    N, F = g.num_nodes, g.num_features
    cap = min((N + 1) * F, (N + 1) * ms.num_branches[0])
    S_pad, K = np.asarray(batch.edges.ell_col).shape
    St_pad = np.asarray(batch.edges.t_ell_col).shape[0]
    edge_shapes = {(S_pad, K), (S_pad,), (S_pad * K,), (St_pad, K), (St_pad,), (St_pad * K,)}
    R = batch.B_pad + batch.Bp_pad
    outs = run.ranks(name)
    assert len(outs) == WORLD
    for rank, out in outs:
        assert out["X_elems"] == (N + 1) * F
        kinds = out["ledger"]["kinds"]
        for cat, op, dtype, shapes in kinds:
            for s in shapes:
                assert int(np.prod(s)) < cap, (rank, cat, s, cap)
                assert tuple(s) not in edge_shapes, (rank, cat, s)
        assert {op for _, op, _, _ in kinds} == {"all_reduce", "all_gather"}
        assert ("rows", "all_gather", "float32", ((R, F),)) in kinds
        nb, M, D = ms.num_branches[0], ms.vq.num_M, ms.num_D
        assert any(cat == "stats" and (nb, M, 2 * D) in shapes for cat, _, _, shapes in kinds)
        assert ("c_indices", "all_gather", "uint8", ((batch.B_pad, nb),)) in kinds
        per = out["ledger"]["per_step"]["bytes"]
        chans = ms.channels[:-1]
        assert per["rows"] == 4 * R * (sum(chans) + sum(chans[1:])), per
        assert per["partials"] == 0 and per["grad"] == 4 * sum(
            v.size for v in out["params"].values())


def test_sharded_link_ledger_moves_the_output_rows(run):
    """(e) on the link step, at the audit's graph: the ``link`` payload is
    the whole batch's output rows [B_pad, C_out] gathered forward and its
    cotangent summed backward, once each a step; no payload as large as the
    feature table, none shaped like an edge array or the pairs."""
    name = "1d-GCN-link-4-audit"
    cfg, g, c, ms = run.ctx[name]
    batch = _jax_batch(cfg, g, link=True)
    N, F = g.num_nodes, g.num_features
    banned = _banned_shapes(batch) | {np.asarray(batch.link_src).shape}
    outs = run.ranks(name)
    assert len(outs) == WORLD
    for rank, out in outs:
        kinds = out["ledger"]["kinds"]
        assert {k for k in kinds if k[0] == "link"} == {
            ("link", op, "float32", ((batch.B_pad, c),)) for op in ("all_gather", "all_reduce")}
        per = out["ledger"]["per_step"]
        assert per["bytes"]["link"] == 2 * 4 * batch.B_pad * c and per["calls"]["link"] == 2
        for cat, op, dtype, shapes in kinds:
            for sh in shapes:
                assert int(np.prod(sh)) < (N + 1) * F, (rank, cat, sh)
                assert tuple(sh) not in banned, (rank, cat, sh)


def _banned_shapes(batch):
    """The shapes (and flat forms) of a batch's edge arrays in its layout and
    of its B + M reverse list, which no collective may carry."""
    e = batch.edges
    cols = [c for c in (e.ell_col, e.t_ell_col, e.head_col, e.tail_col, e.t_head_col,
                        e.t_tail_col, batch.rev_slot_col) if c is not None]
    out = set()
    for c in cols:
        S, K = np.asarray(c).shape
        out |= {(S, K), (S,), (S * K,)}
    for a in (e.row, batch.bm_rev_row):
        if a is not None:
            out.add(np.asarray(a).shape)
    return out


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("-audit") and _is_bm(n)])
def test_sharded_bm_ledger_moves_no_graph_sized_payload(run, name):
    """(e) on B + M, at the audit's graph: no payload as large as the
    feature table or a ``c_indices`` table, none shaped like an edge array
    or the reverse list (its rev-ELL slots or raw entries), no int16; the
    row exchange is batch-row sized, and the per-branch GAT conv gathers its
    rows' f32 logits beside x ([R, C + 2 nb]) and the cotangents back ([R, C
    + nb]) in every layer, with the per-branch Trick-1 max ([2, nb]) under
    ``scalars``; on COO it gathers the per-branch rows with their ones
    column ([R, nb (D + 1)], and their cotangents above layer 0) and its
    table of logits ([R, 2 nb], and its backward sum) under ``logits``.  The
    transformer branch moves c_max ([nb], and [2, nb] back) and out_M's
    normaliser ([nb, 1, M], each way) a layer, under ``transformer``."""
    cfg, g, c, ms = run.ctx[name]
    batch = _jax_batch(cfg, g)
    # the reverse list (and beside the ELL its slots); GCN's recovery term reads none
    assert (batch.bm_rev_row is not None) == (ms.conv_type != "GCN")
    N, F = g.num_nodes, g.num_features
    cap = min((N + 1) * F, (N + 1) * ms.num_branches[0])
    banned = _banned_shapes(batch)
    R = batch.B_pad + batch.Bp_pad
    chans, nbs = ms.channels[:-1], ms.num_branches
    gat, tr = ms.conv_type == "GAT", ms.transformer_flag
    coo = gat and batch.edges.ell_row is None
    D, M = ms.num_D, ms.vq.num_M
    outs = run.ranks(name)
    assert len(outs) == WORLD
    for rank, out in outs:
        kinds = out["ledger"]["kinds"]
        for cat, op, dtype, shapes in kinds:
            assert dtype != "int16", (rank, cat, dtype)
            for s in shapes:
                assert int(np.prod(s)) < cap, (rank, cat, s, cap)
                assert tuple(s) not in banned, (rank, cat, s)
        assert {op for _, op, _, _ in kinds} == (
            {"all_reduce", "all_gather", "all_reduce_max"} if gat or tr
            else {"all_reduce", "all_gather"})
        per = out["ledger"]["per_step"]["bytes"]
        if coo:
            for nb in nbs:
                assert ("rows", "all_gather", "float32", ((R, nb * (D + 1)),)) in kinds
                for op in ("all_gather", "all_reduce"):
                    assert ("logits", op, "float32", ((R, 2 * nb),)) in kinds
                assert ("scalars", "all_reduce_max", "float32", ((2, nb),)) in kinds
            assert per["rows"] == 4 * R * (D + 1) * (sum(nbs) + sum(nbs[1:])), per
            assert per["logits"] == 4 * R * 4 * sum(nbs), per
        elif gat:
            for c_, nb in zip(chans, nbs):
                assert ("rows", "all_gather", "float32", ((R, c_ + 2 * nb),)) in kinds
                assert ("rows", "all_gather", "float32", ((R, c_ + nb),)) in kinds
                assert ("scalars", "all_reduce_max", "float32", ((2, nb),)) in kinds
            assert per["rows"] == 4 * R * sum(2 * c_ + 3 * nb for c_, nb in zip(chans, nbs)), per
        else:
            assert ("rows", "all_gather", "float32", ((R, F),)) in kinds
            assert per["rows"] == 4 * R * (sum(chans) + sum(chans[1:])), per
        got_tr = {k for k in kinds if k[0] == "transformer"}
        assert got_tr == ({("transformer", op, "float32", (s,)) for nb in nbs for op, s in (
            ("all_reduce_max", (nb,)), ("all_reduce", (2 * nb,)), ("all_reduce", (nb, 1, M)))}
            if tr else set()), got_tr
        assert per["transformer"] == 4 * sum(3 * nb + 2 * nb * M for nb in nbs) * tr, per
        assert per["partials"] == 0 and (coo or per["logits"] == 0)


# ---------------------------------------------------------------------------
# (h) the sharded Trick-1 scale under a tie across ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["scalar", "per-branch", "transformer-cmax"])
def test_sharded_scale_gradient_under_a_tie(run, which):
    """Two ranks' ``explosion_scale(..., ranks)`` (an all-reduce MAX, then
    the cotangent and the tie count summed in the backward) give the scale
    and the logits' gradients of torch's masked max over the whole batch,
    which splits the cotangent evenly over the ties: here over two ranks
    for al and three rows on two ranks for ar.  Per branch, the B + M
    scale (``branch_scale(..., ranks)``, one all-reduce of [2, nb] each
    way, then the codebooks' max locally) likewise, with ties across ranks
    and between the rows and the codebooks; the codebook logits' gradients
    summed over the ranks (as the step sums them) are the whole batch's.
    The transformer branch's c_max (``nn/model.py:transformer_cmax``, one
    all-reduce MAX of [nb], its backward one of [2, nb]) likewise over the
    rows' squared norms and the codewords', with ties across the ranks,
    among the codewords and between a row and a codeword."""
    case = {"scalar": SCALE_TIE, "per-branch": SCALE_TIE_BRANCH,
            "transformer-cmax": SCALE_TIE_CMAX}[which]
    outs = run.ranks(case["name"])
    assert [r for r, _ in outs] == [0, 1]
    sides = ("al",) if which == "transformer-cmax" else ("al", "ar")
    whole = {k: torch.tensor(np.concatenate(case[k]), requires_grad=True) for k in sides}
    valid = torch.tensor(np.concatenate(case["valid"]))
    if which == "scalar":
        scale = tgat.explosion_scale(whole["al"], whole["ar"], valid)
        (sum(case["g"]) * scale).backward()
        ties = {"al": 2, "ar": 3}
    elif which == "transformer-cmax":
        nM = torch.tensor(case["al_cb"], requires_grad=True)
        scale = tmodel.transformer_cmax(whole["al"].t(), nM.t(), valid)
        (torch.as_tensor(sum(case["g"])) * scale).sum().backward()
        ties = {"al": 5}
        got = sum(out["d_al_cb"] for _, out in outs)
        assert (nM.grad != 0).sum() == 3  # two tied codewords, one tied with rows
        np.testing.assert_allclose(got, nM.grad.numpy(), rtol=1e-6, atol=1e-7, err_msg="nM")
    else:
        cb = {k: torch.tensor(case[k], requires_grad=True) for k in ("al_cb", "ar_cb")}
        scale = tgat.branch_scale(whole["al"], whole["ar"], cb["al_cb"], cb["ar_cb"], valid)
        (torch.as_tensor(sum(case["g"])) * scale).sum().backward()
        ties = {"al": 5, "ar": 8}
        for k in ("al_cb", "ar_cb"):
            got = sum(out[f"d_{k}"] for _, out in outs)
            np.testing.assert_allclose(got, cb[k].grad.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    for _, out in outs:
        np.testing.assert_allclose(out["scale"], scale.detach().numpy(), rtol=1e-7)
    for k in sides:
        got = np.concatenate([out[f"d_{k}"] for _, out in outs])
        ref = whole[k].grad.numpy()
        assert (ref != 0).sum() == ties[k]  # the ties, on both ranks
        assert all((out[f"d_{k}"] != 0).any() for _, out in outs)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=k)


# ---------------------------------------------------------------------------
# (a) the sub-ELLs, in-process
# ---------------------------------------------------------------------------
def _port_batch(conv="GCN"):
    cfg = tcfg.Config(**{**BASE, "conv_type": conv})
    g = _port_graph(GRAPH, cfg)
    loader = tsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0, device="cpu")
    return next(loader._epoch_iter())[0][0]


@pytest.mark.parametrize("n,conv", [(2, "GCN"), (4, "GCN"), (2, "GAT"), (4, "GAT")],
                         ids=["2", "4", "2-GAT", "4-GAT"])
def test_shards_reassemble_the_batch(n, conv):
    """Every rank's sub-ELL (its batch rows, then its boundary rows) and
    sub-transposed-ELL (its batch columns; in a GAT batch its batch, then
    its boundary columns), columns mapped back from the gathered order, laid
    end to end in the batch's row order, are the batch's live slots exactly;
    each keeps its rows' slot counts (row offsets) and the batch's long rows
    among its rows, longest first; ``row0`` is where its rows land in the
    gathered order."""
    batch = _port_batch(conv)
    gat = conv == "GAT"
    e = batch.edges
    B_pad, Bp_pad = batch.B_pad, batch.Bp_pad
    R = B_pad + Bp_pad
    b, bp = B_pad // n, Bp_pad // n
    back = np.full(R + 1, R, np.int64)
    back[gathered_order(np.arange(R + 1), B_pad, Bp_pad, n)] = np.arange(R + 1)
    ptr = row_offsets_host(e.ell_row, R)
    t_ptr = row_offsets_host(e.t_ell_row, R)
    long_all = set(long_rows_host(ptr)[1:].tolist())
    parts = {"B": [], "fo": [], "t": [], "t fo": []}

    def own_rows(r):
        return np.r_[r * b : (r + 1) * b, B_pad + r * bp : B_pad + (r + 1) * bp]

    for r in range(n):
        _, _, shard = tpar.shard_train_inputs(tpar.DataMesh(None, r, n, torch.device("cpu")),
                                              None, None, batch)
        se = shard.edges
        assert (se.num_rows, se.b_rows, shard.B_pad, shard.Bp_pad) == (b + bp, b, b, bp)
        assert se.row0 == r * (b + bp)
        np.testing.assert_array_equal(gathered_order(own_rows(r), B_pad, Bp_pad, n),
                                      np.arange(se.row0, se.row0 + b + bp))
        for f in ("batch_idx", "valid_B", "y", "train_mask"):
            np.testing.assert_array_equal(getattr(shard, f).numpy(),
                                          getattr(batch, f)[r * b : (r + 1) * b])
        for f in ("fo_ids", "valid_fo"):
            np.testing.assert_array_equal(getattr(shard, f).numpy(),
                                          getattr(batch, f)[r * bp : (r + 1) * bp])
        np.testing.assert_array_equal(shard.batch_idx_all.numpy(), batch.batch_idx)
        row, col, val = (getattr(se, f).numpy() for f in ("ell_row", "ell_col", "ell_val"))
        sptr, slong = se.ell_ptr.numpy(), se.ell_long_rows.numpy()
        # the row offsets: the batch's slot counts of the owned rows
        own = own_rows(r)
        np.testing.assert_array_equal(np.diff(sptr), np.diff(ptr)[own])
        assert set(own[slong[1:]].tolist()) == long_all & set(own.tolist())
        counts = np.diff(sptr)[slong[1:]]
        assert (np.diff(counts) <= 0).all()  # longest first
        cut = sptr[b]
        glob = np.where(row < b, row + r * b, row - b + B_pad + r * bp)
        parts["B"].append((glob[:cut], back[col[:cut]], val[:cut]))
        parts["fo"].append((glob[cut:], back[col[cut:]], val[cut:]))
        trow, tcol, tval = (getattr(se, f).numpy() for f in ("t_ell_row", "t_ell_col",
                                                             "t_ell_val"))
        t_own = own if gat else own[:b]
        tptr = se.t_ell_ptr.numpy()
        np.testing.assert_array_equal(np.diff(tptr), np.diff(t_ptr)[t_own])
        assert set(t_own[se.t_ell_long_rows.numpy()[1:]].tolist()) == \
            set(long_rows_host(t_ptr)[1:].tolist()) & set(t_own.tolist())
        tcut = tptr[b]
        tglob = np.where(trow < b, trow + r * b, trow - b + B_pad + r * bp)
        parts["t"].append((tglob[:tcut], back[tcol[:tcut]], tval[:tcut]))
        parts["t fo"].append((tglob[tcut:], back[tcol[tcut:]], tval[tcut:]))
    assert gat == bool(sum(len(p[0]) for p in parts["t fo"]))
    for key, (rows, cols, vals), (lo, hi) in (
            ("forward", (e.ell_row, e.ell_col, e.ell_val), (0, ptr[R])),
            ("transposed", (e.t_ell_row, e.t_ell_col, e.t_ell_val),
             (0, t_ptr[R if gat else B_pad]))):
        pieces = parts["B"] + parts["fo"] if key == "forward" else parts["t"] + parts["t fo"]
        for i, whole in enumerate((rows, cols, vals)):
            np.testing.assert_array_equal(np.concatenate([p[i] for p in pieces]),
                                          np.asarray(whole)[lo:hi], err_msg=key)


def _layout_batch(kw):
    cfg = tcfg.Config(**{**BASE, **kw})
    g = _port_graph(GRAPH, cfg)
    loader = tsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0, device="cpu")
    return next(loader._epoch_iter())[0][0]


def _reassembled(parts, rows, cols, vals, cover):
    """The shards' pieces of one family or edge list, each (global rows, global
    cols, vals), laid end to end in the batch's row order (every rank's batch
    rows, then every rank's boundary rows), against the batch's slots or
    edges of the rows < ``cover``, in its order, exactly."""
    rows = np.asarray(rows)
    keep = rows < cover
    for i, whole in enumerate((rows, cols, vals)):
        got = np.concatenate([p[i] for p in parts["B"] + parts["fo"]])
        np.testing.assert_array_equal(got, np.asarray(whole)[keep])


@pytest.mark.parametrize("layout,n,conv", [("mixed-K", 2, "GCN"), ("mixed-K", 4, "GCN"),
                                           ("mixed-K", 4, "GAT"), ("COO", 2, "GCN"),
                                           ("COO", 4, "GCN")],
                         ids=["mixed-2", "mixed-4", "mixed-4-GAT", "coo-2", "coo-4"])
def test_layout_shards_reassemble_the_batch(layout, n, conv):
    """(a) on the other layouts, at the tier-1 batch: every rank's mixed
    families (head and tail, forward and transposed) or COO edges (forward,
    and transposed in column order), rows and columns mapped back to the
    batch's, laid end to end in its row order, are the batch's live slots
    or edges exactly (the transposed ones of the batch columns; in a mixed
    GAT batch of every column); each rank's head and tail families are
    non-empty; a head's compact rows ascend, its ``head_inv`` takes each
    owned row to its compact row or to the sentinel (the shard's row count)
    when it has no head slot, and every family carries the row offsets and
    long rows of its rows."""
    batch = _layout_batch(dict(conv_type=conv, **(MIXED if layout == "mixed-K" else COO)))
    e = batch.edges
    assert e.mixed == (layout == "mixed-K") and (e.row is not None) == (layout == "COO")
    B_pad, Bp_pad = batch.B_pad, batch.Bp_pad
    R = B_pad + Bp_pad
    b, bp = B_pad // n, Bp_pad // n
    back = np.full(R + 1, R, np.int64)
    back[gathered_order(np.arange(R + 1), B_pad, Bp_pad, n)] = np.arange(R + 1)
    t_cover = R if conv == "GAT" and layout == "mixed-K" else B_pad
    # family: its (global) rows, cols, vals, row offsets over the rows it sums
    if layout == "mixed-K":
        keys = {f: (f + ("_rowg" if f.endswith("head") else "_row"), f + "_col", f + "_val",
                    f + "_ptr") for f in ("head", "tail", "t_head", "t_tail")}
    else:
        keys = {"": ("row", "col", "val", "row_ptr"), "t_": ("t_row", "t_col", "t_val",
                                                          "t_row_ptr")}
    parts = {k: {"B": [], "fo": []} for k in keys}
    for r in range(n):
        _, _, shard = tpar.shard_train_inputs(tpar.DataMesh(None, r, n, torch.device("cpu")),
                                              None, None, batch)
        se = shard.edges
        assert (se.num_rows, se.b_rows, se.row0, se.mixed) == (b + bp, b, r * (b + bp),
                                                                layout == "mixed-K")
        for key, (rows_f, cols_f, vals_f, ptr_f) in keys.items():
            rows, cols, vals, ptr = (getattr(se, f).numpy() for f in (rows_f, cols_f, vals_f,
                                                                      ptr_f))
            nr = b if key.startswith("t_") and t_cover == B_pad else b + bp
            assert rows.shape[0] > 0 and (rows < nr).all(), (key, r)
            seg = rows
            if key.endswith("head"):
                rowc, inv = getattr(se, key + "_rowc").numpy(), getattr(se, key + "_inv").numpy()
                assert inv.shape == (nr,) and (np.diff(rowc) >= 0).all()
                np.testing.assert_array_equal(inv[rows], rowc)
                has = np.zeros(nr, bool)
                has[rows] = True
                np.testing.assert_array_equal(inv[~has], nr)
                np.testing.assert_array_equal(np.sort(inv[has]), np.arange(has.sum()))
                seg = rowc
            np.testing.assert_array_equal(ptr, row_offsets_host(seg, nr))
            np.testing.assert_array_equal(getattr(se, ptr_f.replace("ptr", "long_rows")),
                                          long_rows_host(ptr))
            glob = np.where(rows < b, rows + r * b, rows - b + B_pad + r * bp)
            cut = int((rows < b).sum())
            parts[key]["B"].append((glob[:cut], back[cols[:cut]], vals[:cut]))
            parts[key]["fo"].append((glob[cut:], back[cols[cut:]], vals[cut:]))
    if layout == "mixed-K":
        for key, (rows_f, cols_f, vals_f, _) in keys.items():
            _reassembled(parts[key], getattr(e, rows_f), getattr(e, cols_f), getattr(e, vals_f),
                         t_cover if key.startswith("t_") else R)
    else:
        _reassembled(parts[""], e.row, e.col, e.val, R)
        perm = e.tperm
        _reassembled(parts["t_"], e.col[perm], e.row[perm], e.val[perm], B_pad)


@pytest.mark.parametrize("layout,n", [("rev-ELL", 2), ("rev-ELL", 4), ("raw", 2), ("raw", 4)],
                         ids=["rev-ell-2", "rev-ell-4", "raw-2", "raw-4"])
def test_rev_shards_reassemble_the_batch(layout, n):
    """(a) on the B + M reverse list (SAGE's, the recovery term's), at the
    tier-1 batch: every rank's rev-ELL slots (beside the slot-ELL), rows
    mapped back to the batch's, laid end to end in rank order, are the
    batch's live slots exactly, columns (global ids) and values as they
    are; each carries the row offsets of its b rows and the recovery
    kernels' long rows of them, and a rank without a cell holds the empty
    list's pad slot (row b).  Beside COO the ranks' raw entries, rows
    mapped back, are the batch's entries of their rows in the batch's
    order, the padding (row 0) with rank 0."""
    from vq_gnn_tpu_torch.ops.rev_ell import rev_long_rows_host

    batch = _layout_batch(dict(BM, conv_type="SAGE", **(COO if layout == "raw" else {})))
    B_pad = batch.B_pad
    b = B_pad // n
    pieces = []
    for r in range(n):
        _, _, shard = tpar.shard_train_inputs(tpar.DataMesh(None, r, n, torch.device("cpu")),
                                              None, None, batch)
        assert shard.B_pad == b
        if layout == "raw":
            assert shard.rev_slot_row is None
            row, col, val = (getattr(shard, f).numpy() for f in ("bm_rev_row", "bm_rev_col",
                                                                  "bm_rev_val"))
            assert ((row >= 0) & (row < b)).all()
            pieces.append((row + r * b, col, val))
            continue
        assert shard.bm_rev_row is None
        row, col, val, ptr, long_rows = (getattr(shard, f).numpy() for f in (
            "rev_slot_row", "rev_slot_col", "rev_slot_val", "rev_row_ptr", "rev_long_rows"))
        np.testing.assert_array_equal(ptr, row_offsets_host(row, b))
        np.testing.assert_array_equal(long_rows, rev_long_rows_host(ptr))
        whole_ptr = row_offsets_host(batch.rev_slot_row, B_pad)
        np.testing.assert_array_equal(np.diff(ptr), np.diff(whole_ptr)[r * b : (r + 1) * b])
        if ptr[b] == 0:  # no cell: the pad slot, in no row
            np.testing.assert_array_equal(row, [b])
            assert not val.any()
            continue
        assert (np.diff(row) >= 0).all() and (row < b).all()
        pieces.append((row + r * b, col, val))
    rows = np.asarray(batch.rev_slot_row if layout == "rev-ELL" else batch.bm_rev_row)
    whole = ((batch.rev_slot_row, batch.rev_slot_col, batch.rev_slot_val) if layout == "rev-ELL"
             else (batch.bm_rev_row, batch.bm_rev_col, batch.bm_rev_val))
    keep = rows < B_pad  # the live slots (every raw entry, the padding's rows are 0)
    order = np.argsort(rows[keep] // b, kind="stable")  # rank order, the batch's within
    assert len(pieces) > 1
    for i, w in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in pieces]),
                                      np.asarray(w)[keep][order], err_msg=f"{layout} {i}")


# ---------------------------------------------------------------------------
# (f) refusals by name
# ---------------------------------------------------------------------------
def _port_state(cfg, g, c):
    """The port's initial state for ``cfg`` on the prepared graph ``g``."""
    from vq_gnn_tpu_torch.train.state import init_train_state

    ms = tmodel.model_static(cfg, g.num_features, c, torch.device("cpu"))
    return init_train_state(torch.Generator().manual_seed(0), ms, g.num_nodes, LR, "cpu")


@pytest.mark.parametrize("maker", ["1d", "2d"])
def test_sharded_bm_gat_link_step_refuses_by_name(maker):
    """A B + M GAT link step with live VQ raises the whole batch's
    ``no_reference_path`` (the JAX link step has no such path)."""
    cfg = tcfg.Config(**{**BASE, **BM, **GAT})
    ms = tmodel.model_static(cfg, 16, cfg.hidden_channels, torch.device("cpu"))
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="the JAX package has no such path") as whole:
        tlink.make_link_step(ms, cfg)
    with pytest.raises(NotImplementedError) as sharded:
        if maker == "1d":
            tpar.make_sharded_link_step(ms, cfg, tpar.DataMesh(None, 0, 2, cpu))
        else:
            tpar.make_sharded_link_step_2d(ms, cfg,
                                           tpar.Mesh2D(None, None, None, 1, 2, 0, 0, 0, cpu))
    assert str(sharded.value) == str(whole.value)


def _link_batch():
    cfg = tcfg.Config(**BASE)
    g = _port_graph(GRAPH, cfg)
    loader = tsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0, device="cpu",
                                   with_link_edges=True)
    return next(loader._epoch_iter())[0][0]


@pytest.mark.parametrize("n", [2, 4])
def test_link_shards_reassemble_the_batch(n):
    """(k) Every rank's block of L_pad / n pairs, laid end to end in rank
    order, is the batch's ``link_src``, ``link_dst`` and ``link_mask``; the
    endpoints stay the whole batch's row indices (a block's pairs reach
    other ranks' rows); each shard carries the whole batch's valid rows."""
    batch = _link_batch()
    L = len(batch.link_src)
    assert L == 1024 and batch.link_mask.sum() > 0
    parts = []
    for r in range(n):
        _, _, shard = tpar.shard_train_inputs(tpar.DataMesh(None, r, n, torch.device("cpu")),
                                              None, None, batch)
        assert shard.batch_num_B == batch.num_B and shard.link_src.shape == (L // n,)
        assert shard.link_src.dtype == torch.int64 and shard.link_mask.dtype == torch.bool
        parts.append([getattr(shard, f).numpy() for f in LINK_FIELDS])
    for i, f in enumerate(LINK_FIELDS):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]),
                                      np.asarray(getattr(batch, f)), err_msg=f)
    b = batch.B_pad // n
    src0 = parts[0][0][parts[0][2]]
    assert (src0 < batch.num_B).all() and (src0 >= b).any()


def test_multilabel_shards_keep_their_targets():
    """(k) A multilabel batch's [B_pad, 6] targets are cut by rows and stay
    float32 on the shard."""
    cfg = tcfg.Config(**BASE)
    g = _port_graph(ML_GRAPH, cfg)
    batch = next(tsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0,
                                       device="cpu")._epoch_iter())[0][0]
    assert batch.y.shape == (batch.B_pad, 6)
    ys = [tpar.shard_train_inputs(tpar.DataMesh(None, r, 4, torch.device("cpu")), None, None,
                                  batch)[2].y for r in range(4)]
    assert all(y.dtype == torch.float32 and y.shape == (batch.B_pad // 4, 6) for y in ys)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), batch.y)


def test_link_padding_must_divide():
    """An L_pad that does not divide by the rows' ranks raises a ValueError
    naming L_pad and its fix."""
    batch = _link_batch()
    batch = dataclasses.replace(batch, **{f: np.asarray(getattr(batch, f))[:1020]
                                          for f in LINK_FIELDS})
    with pytest.raises(ValueError, match="L_pad=1020.*build_padded_batch"):
        tpar.shard_train_inputs(tpar.DataMesh(None, 0, 8, torch.device("cpu")), None, None, batch)


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_2d_split_of_the_transformer_state(conv):
    """(j) ``shard_train_inputs_2d`` on a B + M state with the transformer,
    at 1 x 2: each model rank keeps its branches of every transformer
    codebook leaf (``c_indices`` by column), its branches' rows of
    ``transformer_k`` (and on GAT of the per-branch heads), its fan-in
    columns of ``transformer_v`` and ``transformer_res``, and the same part
    of each RMSprop square average; the two ranks' parts laid side by side
    are the whole state, bit for bit."""
    cfg = tcfg.Config(**{**BASE, **BM, **TR, "conv_type": conv})
    g, c = tdata.synthetic_sbm(**GRAPH)
    g, c, _ = tdata.prepare(g, cfg, c)
    batch = next(tsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0,
                                       device="cpu")._epoch_iter())[0][0]
    state = _port_state(cfg, g, c)
    ms = tmodel.model_static(cfg, g.num_features, c, torch.device("cpu"))
    fns = make_step_fns(ms, cfg)  # one step, so that every square average is set
    state, _ = fns.train_step(state, device_features(g.x, "cpu"), batch.to("cpu"), 1.0, LR, 1.0)
    whole, whole_nu = _params_nu(state)
    cpu = torch.device("cpu")
    parts = [tpar.shard_train_inputs_2d(tpar.Mesh2D(None, None, None, 1, 2, 0, m, m, cpu),
                                        state, None, batch)[0] for m in range(2)]
    got = [_params_nu(p) for p in parts]
    for k, v in whole.items():
        if ".transformer_k." in k or k.endswith(("att_l", "att_r")):
            axis = 0  # a branch's rows
        elif k.endswith(".weight"):
            axis = 1  # the fan-in columns
        else:
            axis = None  # replicated
        for vals, ref in ((0, v), (1, whole_nu[k])):
            pieces = [gp[vals][k] for gp in got]
            if axis is None:
                for p in pieces:
                    np.testing.assert_array_equal(p, ref, err_msg=k)
            else:
                assert pieces[0].shape[axis] * 2 == ref.shape[axis], k
                np.testing.assert_array_equal(np.concatenate(pieces, axis), ref, err_msg=k)
    for l in range(ms.num_layers):
        for f in ("embedding", "embedding_output", "c_indices"):
            ref = getattr(state.vq_states_tr[l], f).numpy()
            axis = 1 if f == "c_indices" else 0
            np.testing.assert_array_equal(
                np.concatenate([getattr(p.vq_states_tr[l], f).numpy() for p in parts], axis),
                ref, err_msg=f"layer {l} {f}")


def test_padding_and_branches_must_divide():
    """B_pad or Bp_pad that does not divide by the rows' ranks raises a
    ValueError naming the padding; so do branches that do not divide by the
    model ranks."""
    batch = _port_batch()
    assert batch.B_pad == 128
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="B_pad=128.*fixed_B_pad"):
        tpar.shard_train_inputs(tpar.DataMesh(None, 0, 3, cpu), None, None, batch)
    cfg = tcfg.Config(**BASE)
    ms = tmodel.model_static(cfg, 16, 4, cpu)
    with pytest.raises(ValueError, match="do not divide by n_model=3"):
        tpar.make_sharded_step_2d(ms, cfg, tpar.Mesh2D(None, None, None, 1, 3, 0, 0, 0, cpu))
