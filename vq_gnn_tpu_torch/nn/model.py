"""LowRankGNN — the VQ-GNN model (port of ``vq_gnn_tpu/nn/model.py``, the
B + B' formulation for GCN and SAGE).

- ``LowRankGNN``       an ``nn.Module`` holding the per-layer linears
- ``init_params``      torch-default Linear init from a ``torch.Generator``
- ``layer_forward``    one LowRankGNNLayer (``models.py v2:144-231``)
- ``model_forward``    the stack; returns per-layer inputs + info_backward

The reference's backward hook (``models.py v2:181-185``) becomes *probes*:
zero tensors with ``requires_grad=True`` added to each conv output's batch
rows.  The gradient of the loss with respect to a probe is exactly
``dL/d(x_output_B)``, what the reference hook receives; it feeds the VQ
update after the step (visible to the next batch, matching hook timing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vq_gnn_tpu_torch.config import Config, check_ported, resolve_vq_backend
from vq_gnn_tpu_torch.nn.vq import VQParams, VQState, lookup
from vq_gnn_tpu_torch.ops.spmm import spmm
from vq_gnn_tpu_torch.ops.vq_ops import masked_mean_var
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch


@dataclasses.dataclass(frozen=True)
class ModelStatic:
    """Static model structure derived from Config."""

    num_layers: int
    channels: Tuple[int, ...]  # [in, hidden, ..., out] length L+1
    conv_type: str
    skip: bool
    act: str
    bn_flag: bool
    dropout: float
    num_D: int
    vq: VQParams

    @property
    def num_branches(self) -> Tuple[int, ...]:
        return tuple(c // self.num_D for c in self.channels[:-1])


def model_static(
    cfg: Config, in_channels: int, out_channels: int, device: torch.device
) -> ModelStatic:
    check_ported(cfg)
    chans = (
        (in_channels,) + (cfg.hidden_channels,) * (cfg.num_layers - 1) + (out_channels,)
    )
    vq = VQParams(
        num_M=cfg.num_M,
        num_D=cfg.num_D,
        decay=cfg.ema_decay,
        epsilon=cfg.ema_epsilon,
        grad_scale=tuple(cfg.grad_scale),
        warm_up_flag=cfg.warm_up_flag,
        momentum=cfg.momentum,
        backend=resolve_vq_backend(cfg.vq_backend, device),
    )
    return ModelStatic(
        num_layers=cfg.num_layers,
        channels=chans,
        conv_type=cfg.conv_type,
        skip=cfg.skip,
        act=cfg.act,
        bn_flag=cfg.bn_flag,
        dropout=cfg.dropout,
        num_D=cfg.num_D,
        vq=vq,
    )


# --------------------------------------------------------------------------
# parameters (torch-default distributions)
# --------------------------------------------------------------------------
class LowRankGNN(nn.Module):
    """Per layer: ``gnn_transform`` (+ ``fc_sage`` for SAGE, ``linear_skip``
    with ``skip``).  Weights are [out, in] as in ``nn.Linear``."""

    def __init__(self, ms: ModelStatic, device=None):
        super().__init__()
        self.layers = nn.ModuleList()
        for l in range(ms.num_layers):
            c_in, c_out = ms.channels[l], ms.channels[l + 1]
            layer = nn.Module()
            layer.gnn_transform = nn.Linear(c_in, c_out, device=device)
            if ms.skip:
                layer.linear_skip = nn.Linear(c_in, c_out, device=device)
            if ms.conv_type == "SAGE":
                layer.fc_sage = nn.Linear(c_in, c_out, device=device)
            self.layers.append(layer)


def init_params(model: LowRankGNN, generator: torch.Generator) -> LowRankGNN:
    """torch.nn.Linear's default: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``generator`` (a CPU generator; values copied to the device)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    t = torch.empty(p.shape)
                    nn.init.uniform_(t, -bound, bound, generator=generator)
                    p.copy_(t)
    return model


@dataclasses.dataclass
class BNState:
    """Running stats of the affine-free inter-layer BatchNorms
    (``models.py v2:262, 319-320``)."""

    mean: List[torch.Tensor]
    var: List[torch.Tensor]


def init_bn_state(ms: ModelStatic, device) -> BNState:
    return BNState(
        mean=[torch.zeros(ms.channels[l + 1], device=device) for l in range(ms.num_layers - 1)],
        var=[torch.ones(ms.channels[l + 1], device=device) for l in range(ms.num_layers - 1)],
    )


# --------------------------------------------------------------------------
# activations / dropout / batchnorm
# --------------------------------------------------------------------------
def activation(x, act: str):
    if act == "relu":
        return F.relu(x)
    if act == "elu":
        return F.elu(x)
    if act == "leaky_gelu":  # models.py v2:296
        return 0.1 * x + 0.9 * F.gelu(x)
    raise ValueError("Activation not supported!")


def dropout(x, p: float, training: bool, generator: Optional[torch.Generator] = None):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def batchnorm_infer(x, mean, var, eps=1e-5):
    return (x - mean[None, :]) * torch.rsqrt(var[None, :] + eps)


def batchnorm_train(x, mean, var, valid, eps=1e-5, momentum=0.1):
    """Affine-free BN over valid batch rows; returns (y, new_mean, new_var)."""
    b_mean, b_var = masked_mean_var(x, valid, ddof=0)
    _, b_var_u = masked_mean_var(x, valid, ddof=1)
    y = (x - b_mean[None, :]) * torch.rsqrt(b_var[None, :] + eps)
    return (
        y,
        (1 - momentum) * mean + momentum * b_mean.detach(),
        (1 - momentum) * var + momentum * b_var_u.detach(),
    )


# --------------------------------------------------------------------------
# one layer, B+B' (v2) formulation
# --------------------------------------------------------------------------
def layer_forward(
    layer: nn.Module,
    vq_state: VQState,
    ms: ModelStatic,
    x: torch.Tensor,  # [B_pad, C_in]
    batch: PaddedBatch,
    probe: Optional[torch.Tensor],  # [B_pad, C_in] or None
    warm_up_rate,
):
    """One LowRankGNNLayer forward (``models.py v2:144-231``), GCN or SAGE.

    Returns (x_out [B_pad, C_out], info_backward scalar)."""
    B_pad = batch.B_pad
    # out-of-batch features/grads from the codebook (models.py v2:165-173)
    x_fo, grad_fo = lookup(vq_state, batch.fo_ids, ms.vq)
    fo_mask = batch.valid_fo.to(x.dtype)[:, None]
    x_fo = x_fo * fo_mask
    grad_fo = (grad_fo * fo_mask).detach()

    x_input = torch.cat([x, x_fo], dim=0).contiguous()  # [dim_pad, C_in]
    x_out = spmm(batch.edges, x_input)

    # the probe is the reference's per-branch grad hook point
    x_out_B = x_out[:B_pad]
    if probe is not None:
        x_out_B = x_out_B + probe
    x_out_fo = x_out[B_pad:]

    # gradient recovery term (models.py v2:198-200)
    info_backward = (x_out_fo * grad_fo * warm_up_rate).sum()

    out = F.linear(x_out_B, layer.gnn_transform.weight, layer.gnn_transform.bias)
    if ms.conv_type == "SAGE":  # root weight (models.py v2:203-204)
        out = out + F.linear(x, layer.fc_sage.weight, layer.fc_sage.bias)
    if ms.skip:
        out = out + F.linear(x, layer.linear_skip.weight, layer.linear_skip.bias)
    return out, info_backward


def model_forward(
    model: LowRankGNN,
    vq_states: List[VQState],
    bn_state: BNState,
    ms: ModelStatic,
    x_B: torch.Tensor,  # [B_pad, F] gathered batch features
    batch: PaddedBatch,
    probes: Optional[List[torch.Tensor]] = None,
    warm_up_rate=1.0,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Full LowRankGNN forward (``models.py v2:308-348``).

    Returns (out [B_pad, C_out], info_backward, layer_inputs, new_bn_state)."""
    x = x_B
    layer_inputs = []
    info_total = 0.0
    new_means, new_vars = list(bn_state.mean), list(bn_state.var)
    for l in range(ms.num_layers):
        layer_inputs.append(x)
        probe = probes[l] if probes is not None else None
        x, info_b = layer_forward(
            model.layers[l], vq_states[l], ms, x, batch, probe, warm_up_rate
        )
        info_total = info_total + info_b
        if l < ms.num_layers - 1:
            if ms.bn_flag:
                if training:
                    x, new_means[l], new_vars[l] = batchnorm_train(
                        x, bn_state.mean[l], bn_state.var[l], batch.valid_B
                    )
                else:
                    x = batchnorm_infer(x, bn_state.mean[l], bn_state.var[l])
            x = activation(x, ms.act)
            if ms.dropout > 0 and training:
                x = dropout(x, ms.dropout, training, generator)
    return x, info_total, layer_inputs, BNState(mean=new_means, var=new_vars)


def probe_shapes(ms: ModelStatic, B_pad: int) -> List[Tuple[int, ...]]:
    """Conv-output shapes per layer: [B_pad, C_in] (no GAT ones column)."""
    return [(B_pad, ms.channels[l]) for l in range(ms.num_layers)]


def zero_probes(ms: ModelStatic, B_pad: int, device) -> List[torch.Tensor]:
    return [
        torch.zeros(s, device=device, requires_grad=True) for s in probe_shapes(ms, B_pad)
    ]
