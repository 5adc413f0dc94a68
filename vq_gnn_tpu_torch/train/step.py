"""Train / eval / init-sweep steps (port of ``vq_gnn_tpu/train/step.py``,
the B + B' path).

One training step reproduces the reference hot path (SURVEY §3.1):

1. gather the batch features from the device-resident feature table,
2. forward through the LowRankGNN stack (probes added at each conv output),
3. loss = masked CE + info_backward,
4. one ``torch.autograd.grad`` over (params, probes) — the probe gradients
   are what the reference's backward hooks receive,
5. RMSprop, gated by ``do_opt_step`` for multi-window batches
   (``main_node.py v2:113-116``),
6. in 'live' mode the VQ codebook update per layer (the hook body), visible
   to the *next* batch — matching the reference's hook timing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.config import Config
from vq_gnn_tpu_torch.nn.model import (
    ModelStatic,
    activation,
    layer_forward,
    model_forward,
    zero_probes,
)
from vq_gnn_tpu_torch.nn.vq import feature_update, vq_update
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch
from vq_gnn_tpu_torch.train.optim import rmsprop_update
from vq_gnn_tpu_torch.train.state import TrainState


def _branch_view(x: torch.Tensor, nb: int, d: int) -> torch.Tensor:
    """[B, nb*d] -> [nb, B, d] per-branch slices (branch i = cols i*d:(i+1)*d)."""
    return x.reshape(x.shape[0], nb, d).permute(1, 0, 2)


def masked_ce(logits, y, mask):
    ll = F.log_softmax(logits, dim=-1).gather(1, y[:, None].long())[:, 0]
    m = mask.to(logits.dtype)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_accuracy(logits, y, mask):
    hit = (logits.argmax(-1) == y).to(torch.float32)
    m = mask.to(torch.float32)
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


@dataclasses.dataclass
class StepFns:
    train_step: Callable
    eval_step: Callable
    init_step_for: Callable  # layer_idx -> init-sweep step


def make_step_fns(ms: ModelStatic, cfg: Config) -> StepFns:
    """Single-label node classification (multilabel BCE is not ported yet)."""
    live = cfg.vq_update_mode == "live"
    D = ms.num_D

    def train_step(
        state: TrainState,
        X_dev: torch.Tensor,
        batch: PaddedBatch,
        warm_up_rate: float,
        lr: float,
        do_opt_step: float,
        generator=None,
    ):
        """One step; updates ``state`` in place and returns (state, metrics).
        Metrics are device tensors (no host sync)."""
        probes = zero_probes(ms, batch.B_pad, X_dev.device)
        params = list(state.model.parameters())
        x_B = X_dev.index_select(0, batch.batch_idx)
        out, info_b, layer_inputs, new_bn = model_forward(
            state.model,
            state.vq_states,
            state.bn_state,
            ms,
            x_B,
            batch,
            probes=probes,
            warm_up_rate=warm_up_rate,
            training=True,
            generator=generator,
        )
        mask = batch.train_mask & batch.valid_B
        loss_cls = masked_ce(out, batch.y, mask)
        acc = masked_accuracy(out.detach(), batch.y, mask)
        loss = loss_cls if cfg.ce_only else loss_cls + info_b
        grads = torch.autograd.grad(loss, params + probes)
        g_params, g_probes = grads[: len(params)], grads[len(params) :]

        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)

        if live:
            # the reference hook body (models.py v2:39-56): X_B = layer input
            # slice (detached), grad = dL/d(output slice); runs even on
            # skipped-optimizer windows (backward always fires hooks)
            for l in range(ms.num_layers):
                nb = ms.num_branches[l]
                Xb = _branch_view(layer_inputs[l].detach(), nb, D)
                Gb = _branch_view(g_probes[l][:, : nb * D], nb, D)
                state.vq_states[l], _ = vq_update(
                    state.vq_states[l], Xb, Gb, batch.batch_idx, ms.vq, valid=batch.valid_B
                )

        grad_norm = torch.sqrt(sum((g * g).sum() for g in g_params))
        metrics = {
            "loss": loss.detach(),
            "loss_cls": loss_cls.detach(),
            "train_acc": acc,
            "info_backward": torch.as_tensor(info_b).detach(),
            "grad_norm": grad_norm,
            "bad_init": torch.stack([s.bad_init for s in state.vq_states]).any(),
        }
        state.bn_state = new_bn
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, X_dev: torch.Tensor, batch: PaddedBatch):
        x_B = X_dev.index_select(0, batch.batch_idx)
        out, _, _, _ = model_forward(
            state.model, state.vq_states, state.bn_state, ms, x_B, batch, training=False
        )
        return out

    def init_step_for(layer_idx: int) -> Callable:
        @torch.no_grad()
        def init_step(vq_states, model, X_dev, batch: PaddedBatch):
            """model.init partial forward (``models.py v2:370-374`` +
            ``main_node.py v2:17-37``): every still-uninited block runs
            feature_update on the current activations, then the layer
            forward uses the freshly updated codebook."""
            x = X_dev.index_select(0, batch.batch_idx)
            new_states = list(vq_states)
            for l in range(layer_idx):
                nb = ms.num_branches[l]
                new_states[l], _ = feature_update(
                    new_states[l], _branch_view(x, nb, D), batch.batch_idx, ms.vq,
                    valid=batch.valid_B,
                )
                x, _ = layer_forward(model.layers[l], new_states[l], ms, x, batch, None, 1.0)
                x = activation(x, ms.act)
            return new_states

        return init_step

    return StepFns(train_step=train_step, eval_step=eval_step, init_step_for=init_step_for)
