"""Carry a JAX-package train state into the port.

``state_from_numpy`` takes the JAX package's ``TrainState`` with every leaf
as a numpy array (``jax.tree.map(np.asarray, state)``; nested dicts with the
same keys work too) and builds the port's :class:`TrainState`: parameters,
``vq_states``, ``bn_state`` and the RMSprop square averages ``nu``.

The JAX package stores a Linear weight ``w`` as [fan_in, fan_out]
(``vq_gnn_tpu/nn/model.py:154-160``); ``nn.Linear`` keeps [out, in].  The
transpose happens here and nowhere else.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from vq_gnn_tpu_torch.nn.model import BNState, LowRankGNN, ModelStatic
from vq_gnn_tpu_torch.nn.vq import VQState
from vq_gnn_tpu_torch.train.optim import make_rmsprop
from vq_gnn_tpu_torch.train.state import TrainState

_LINEARS = ("gnn_transform", "linear_skip", "fc_sage")


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def _linear_tensors(layer_np, name, device):
    """(weight [out, in], bias [out]) of one JAX ``{"w", "b"}`` linear."""
    lin = layer_np[name]
    return _t(np.asarray(lin["w"]).T, device), _t(lin["b"], device)


def vq_state_from_numpy(s_np, device) -> VQState:
    """One JAX ``VQState`` (numpy leaves) as the port's :class:`VQState`."""
    return VQState(**{
        f.name: _t(_get(s_np, f.name), device,
                   torch.int16 if f.name == "c_indices" else None)
        for f in dataclasses.fields(VQState)
    })


def state_from_numpy(state_np, ms: ModelStatic, lr: float, device) -> TrainState:
    device = torch.device(device)
    params_np = _get(state_np, "params")
    nu_np = _get(state_np, "opt_nu")
    model = LowRankGNN(ms, device=device)
    with torch.no_grad():
        for l, layer in enumerate(model.layers):
            for name in _LINEARS:
                if hasattr(layer, name):
                    w, b = _linear_tensors(params_np[l], name, device)
                    getattr(layer, name).weight.copy_(w)
                    getattr(layer, name).bias.copy_(b)
    opt = make_rmsprop(model.parameters(), lr)
    for l, layer in enumerate(model.layers):
        for name in _LINEARS:
            if hasattr(layer, name):
                w_nu, b_nu = _linear_tensors(nu_np[l], name, device)
                lin = getattr(layer, name)
                opt.state[lin.weight] = {"step": torch.tensor(0.0), "square_avg": w_nu}
                opt.state[lin.bias] = {"step": torch.tensor(0.0), "square_avg": b_nu}

    vq_states = [vq_state_from_numpy(s, device) for s in _get(state_np, "vq_states")]
    bn_np = _get(state_np, "bn_state")
    bn = BNState(
        mean=[_t(m, device) for m in _get(bn_np, "mean")],
        var=[_t(v, device) for v in _get(bn_np, "var")],
    )
    return TrainState(
        model=model,
        vq_states=vq_states,
        bn_state=bn,
        optimizer=opt,
        step=int(np.asarray(_get(state_np, "step"))),
    )
