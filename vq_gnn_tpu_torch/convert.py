"""Carry a train state between the JAX package and the port, both ways.

``state_from_numpy`` takes the JAX package's ``TrainState`` with every leaf
as a numpy array (``jax.tree.map(np.asarray, state)``; nested dicts with the
same keys work too) and builds the port's :class:`TrainState`: parameters
(linears, the GAT attention vectors and the transformer's per-branch
``transformer_k``), ``vq_states`` (and ``vq_states_tr``), ``bn_state`` and
the RMSprop square averages ``nu``.  ``predictor_from_numpy`` does the same for
the link trainer's predictor (the JAX list of ``{w, b}`` and its ``nu``).

``state_to_numpy`` and ``predictor_to_numpy`` are their inverses: the JAX
package's tree with numpy leaves in the JAX layouts and dtypes (``c_indices``
int16, ``bn_inited``/``bad_init`` bool scalars, ``step`` an int32 scalar),
its dataclass nodes as :class:`Fields`.  ``train/checkpoint.py`` writes that
tree under the JAX package's names, so an archive of either package restores
in the other.

``state_as``, ``predictor_as`` and ``batch_as`` copy a state, a predictor
(with its RMSprop) and a batch with their floating tensors in another
dtype: float64, for the plain versions' float64 diagnostic on the CPU
(``config.sum_dtype``; ``tools/link_hold_probe_torch.py --f64``).

The JAX package stores a Linear weight ``w`` as [fan_in, fan_out]
(``vq_gnn_tpu/nn/model.py:154-160``); ``nn.Linear`` keeps [out, in].  The
transpose happens here and nowhere else.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from vq_gnn_tpu_torch.nn.model import BNState, LowRankGNN, ModelStatic
from vq_gnn_tpu_torch.nn.vq import VQState
from vq_gnn_tpu_torch.train.link import LinkPredictor
from vq_gnn_tpu_torch.train.optim import make_rmsprop
from vq_gnn_tpu_torch.train.state import TrainState

_LINEARS = ("gnn_transform", "linear_skip", "fc_sage", "transformer_v", "transformer_res")
_VECTORS = ("att_l", "att_r")  # GAT: [c_in + 1], or [nb, D + 1] in B + M


class Fields(dict):
    """A dataclass node of the JAX package's pytrees (the flax ``struct``s
    ``TrainState``, ``VQState`` and ``BNState``): its fields in declaration
    order.  A checkpoint names a field ``.name`` and keeps this order, where
    it names a plain dict's key ``['key']`` and sorts the keys."""


def _get(obj, name, *default):
    if isinstance(obj, Mapping):
        return obj.get(name, *default) if default else obj[name]
    return getattr(obj, name, *default)


def _t(a, device, dtype=None):
    """A contiguous copy of ``a`` on ``device`` (a transposed ``w`` too)."""
    return torch.as_tensor(np.array(a, order="C")).to(device=device, dtype=dtype)


def _linear_tensors(lin, device):
    """(weight [out, in], bias [out]) of one JAX ``{"w", "b"}`` linear."""
    return _t(np.asarray(lin["w"]).T, device), _t(lin["b"], device)


def vq_state_from_numpy(s_np, device) -> VQState:
    """One JAX ``VQState`` (numpy leaves) as the port's :class:`VQState`."""
    return VQState(**{
        f.name: _t(_get(s_np, f.name), device,
                   torch.int16 if f.name == "c_indices" else None)
        for f in dataclasses.fields(VQState)
    })


def _layer_tensors(layer, layer_np, device):
    """(parameter, its value from ``layer_np``) for every parameter of one
    port layer."""
    out = []
    for name in _LINEARS:
        if hasattr(layer, name):
            w, b = _linear_tensors(layer_np[name], device)
            out += [(getattr(layer, name).weight, w), (getattr(layer, name).bias, b)]
    for name in _VECTORS:
        if hasattr(layer, name):
            out.append((getattr(layer, name), _t(layer_np[name], device)))
    if hasattr(layer, "transformer_k"):  # JAX's own layout, [nb, D_in, D_out]
        tk = layer.transformer_k
        out += [(tk.w, _t(layer_np["transformer_k"]["w"], device)),
                (tk.b, _t(layer_np["transformer_k"]["b"], device))]
    return out


def state_from_numpy(state_np, ms: ModelStatic, lr: float, device) -> TrainState:
    return _state_into(state_np, LowRankGNN(ms, device=torch.device(device)), lr)


def state_like(template: TrainState, state_np) -> TrainState:
    """A new :class:`TrainState` of ``template``'s structure, device and
    learning rate, holding the values of ``state_np`` (as
    :func:`state_from_numpy` takes it)."""
    return _state_into(state_np, copy.deepcopy(template.model),
                       template.optimizer.defaults["lr"])


def _state_into(state_np, model: LowRankGNN, lr: float) -> TrainState:
    """``state_np``'s values in ``model`` (its parameters overwritten) and a
    new optimizer, codebooks and BN state on the model's device."""
    device = next(model.parameters()).device
    params_np = _get(state_np, "params")
    nu_np = _get(state_np, "opt_nu")
    with torch.no_grad():
        for l, layer in enumerate(model.layers):
            for p, v in _layer_tensors(layer, params_np[l], device):
                p.copy_(v)
    opt = make_rmsprop(model.parameters(), lr)
    for l, layer in enumerate(model.layers):
        for p, nu in _layer_tensors(layer, nu_np[l], device):
            opt.state[p] = {"step": torch.tensor(0.0), "square_avg": nu}

    vq_states = [vq_state_from_numpy(s, device) for s in _get(state_np, "vq_states")]
    tr_np = _get(state_np, "vq_states_tr", None)
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
        vq_states_tr=None if tr_np is None else [vq_state_from_numpy(s, device) for s in tr_np],
    )


def _floating_as(t, dtype):
    return t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t


def _module_as(module: torch.nn.Module, opt: torch.optim.RMSprop, dtype):
    """(a copy of ``module`` in ``dtype``, an RMSprop over it holding
    ``opt``'s square averages in ``dtype``)."""
    new = copy.deepcopy(module).to(dtype)
    new_opt = make_rmsprop(new.parameters(), opt.defaults["lr"])
    for p_old, p in zip(module.parameters(), new.parameters()):
        st = opt.state.get(p_old, {})
        if "square_avg" in st:
            new_opt.state[p] = {"step": st["step"].clone(),
                                "square_avg": st["square_avg"].to(dtype)}
    return new, new_opt


def state_as(state: TrainState, dtype) -> TrainState:
    """A copy of ``state`` whose floating tensors (parameters, their RMSprop
    square averages, codebooks, BN statistics) are ``dtype``."""
    model, opt = _module_as(state.model, state.optimizer, dtype)

    def vq(s: VQState) -> VQState:
        return VQState(**{f.name: _floating_as(getattr(s, f.name), dtype)
                          for f in dataclasses.fields(VQState)})

    return TrainState(
        model=model, vq_states=[vq(s) for s in state.vq_states],
        bn_state=BNState(mean=[m.to(dtype) for m in state.bn_state.mean],
                         var=[v.to(dtype) for v in state.bn_state.var]),
        optimizer=opt, step=state.step,
        vq_states_tr=None if state.vq_states_tr is None else [vq(s) for s in state.vq_states_tr])


def predictor_as(pred: LinkPredictor, opt: torch.optim.RMSprop, dtype):
    """(a copy of the link predictor, its RMSprop) in ``dtype``."""
    return _module_as(pred, opt, dtype)


def batch_as(batch, dtype):
    """A copy of a batch (a ``PaddedBatch`` or a row shard) whose floating
    tensors, its adjacency's values among them, are ``dtype``."""
    def cast(obj):
        return dataclasses.replace(obj, **{
            f.name: cast(v) if dataclasses.is_dataclass(v) else _floating_as(v, dtype)
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})

    return cast(batch)


def predictor_from_numpy(pred_np, nu_np, lr: float, device):
    """The JAX link predictor (a list of ``{"w", "b"}``, numpy leaves) and its
    RMSprop ``nu`` as the port's ``(LinkPredictor, RMSprop)``."""
    device = torch.device(device)
    dims = [np.asarray(lin["w"]).shape for lin in pred_np]
    pred = LinkPredictor(dims[0][0], dims[0][1], dims[-1][1], len(dims), device=device)
    pairs = []
    with torch.no_grad():
        for lin, lin_np, lin_nu in zip(pred.lins, pred_np, nu_np):
            w, b = _linear_tensors(lin_np, device)
            lin.weight.copy_(w)
            lin.bias.copy_(b)
            pairs += list(zip((lin.weight, lin.bias), _linear_tensors(lin_nu, device)))
    opt = make_rmsprop(pred.parameters(), lr)
    for p, nu in pairs:
        opt.state[p] = {"step": torch.tensor(0.0), "square_avg": nu}
    return pred, opt


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _layer_numpy(layer, value) -> dict:
    """One port layer as the JAX package's parameter dict, each entry
    ``value(parameter)`` in the JAX layout (a Linear's ``w`` [fan_in,
    fan_out])."""
    out = {}
    for name in _LINEARS:
        if hasattr(layer, name):
            lin = getattr(layer, name)
            out[name] = {"w": np.ascontiguousarray(value(lin.weight).T), "b": value(lin.bias)}
    for name in _VECTORS:
        if hasattr(layer, name):
            out[name] = value(getattr(layer, name))
    if hasattr(layer, "transformer_k"):
        out["transformer_k"] = {"w": value(layer.transformer_k.w),
                                "b": value(layer.transformer_k.b)}
    return out


def _nu(opt: torch.optim.RMSprop):
    """parameter -> its RMSprop square average (zeros before the first step),
    numpy."""
    def value(p):
        st = opt.state.get(p, {})
        return _np(st["square_avg"]) if "square_avg" in st else np.zeros(p.shape, np.float32)
    return value


def vq_state_to_numpy(s: VQState) -> Fields:
    return Fields((f.name, _np(getattr(s, f.name))) for f in dataclasses.fields(VQState))


def state_to_numpy(state: TrainState) -> Fields:
    """The JAX package's ``TrainState`` of the port's ``state``: ``params``,
    ``vq_states``, ``bn_state``, ``opt_nu``, ``step`` and ``vq_states_tr``
    (None when off), numpy leaves in the JAX layouts and dtypes."""
    layers = state.model.layers
    return Fields(
        params=[_layer_numpy(layer, _np) for layer in layers],
        vq_states=[vq_state_to_numpy(s) for s in state.vq_states],
        bn_state=Fields(mean=[_np(m) for m in state.bn_state.mean],
                        var=[_np(v) for v in state.bn_state.var]),
        opt_nu=[_layer_numpy(layer, _nu(state.optimizer)) for layer in layers],
        step=np.asarray(state.step, np.int32),
        vq_states_tr=(None if state.vq_states_tr is None
                      else [vq_state_to_numpy(s) for s in state.vq_states_tr]),
    )


def predictor_to_numpy(pred: LinkPredictor, opt: torch.optim.RMSprop):
    """(the JAX predictor, a list of ``{"w", "b"}``, and its RMSprop ``nu``),
    numpy, ``w`` [fan_in, fan_out]: the inverse of
    :func:`predictor_from_numpy`."""
    params, nu = ([{"w": np.ascontiguousarray(value(lin.weight).T), "b": value(lin.bias)}
                   for lin in pred.lins] for value in (_np, _nu(opt)))
    return params, nu
