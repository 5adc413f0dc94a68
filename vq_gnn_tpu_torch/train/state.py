"""Train state container (port of ``vq_gnn_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from vq_gnn_tpu_torch.nn.model import (
    BNState,
    LowRankGNN,
    ModelStatic,
    init_bn_state,
    init_params,
)
from vq_gnn_tpu_torch.nn.vq import VQState, init_vq_state
from vq_gnn_tpu_torch.train.optim import make_rmsprop


@dataclasses.dataclass
class TrainState:
    model: LowRankGNN  # per-layer linears
    vq_states: List[VQState]  # per-layer VQ state
    bn_state: BNState
    optimizer: torch.optim.RMSprop  # holds nu (square_avg) per parameter
    step: int = 0


def init_train_state(
    generator: torch.Generator, ms: ModelStatic, num_N: int, lr: float, device
) -> TrainState:
    """Parameters, then one VQ state per layer, all drawn from ``generator``
    (a CPU generator; the values are copied to ``device``)."""
    model = init_params(LowRankGNN(ms, device=device), generator)
    vq_states = [
        init_vq_state(generator, ms.num_branches[l], num_N, ms.vq, device)
        for l in range(ms.num_layers)
    ]
    return TrainState(
        model=model,
        vq_states=vq_states,
        bn_state=init_bn_state(ms, device),
        optimizer=make_rmsprop(model.parameters(), lr),
    )
