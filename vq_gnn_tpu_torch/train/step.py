"""Train / eval / init-sweep steps (port of ``vq_gnn_tpu/train/step.py``,
the B + B' and B + M paths).

One training step reproduces the reference hot path (SURVEY §3.1):

1. gather the batch features from the device-resident feature table,
2. forward through the LowRankGNN stack (probes added at each conv output),
3. loss = masked CE (BCE for multilabel targets) + info_backward,
4. one ``torch.autograd.grad`` over (params, probes, and the transformer
   branch's probes) — the probe gradients are what the reference's backward
   hooks receive,
5. RMSprop, gated by ``do_opt_step`` for multi-window batches
   (``main_node.py v2:113-116``),
6. in 'live' mode the VQ codebook update per layer (the hook body; with
   ``transformer_flag`` also of the transformer's codebooks), visible to the
   *next* batch — matching the reference's hook timing.

With ``dropbranch`` each step keeps exactly int(nb * (1 - p)) branches a
layer, chosen by a permutation (``draw_branch_masks``); the masks, and the
(alpha) dropout masks, come from the trainer's ``torch.Generator``, or from
the caller (``train_step(branch_masks=, dropout_keeps=)``).

``eval_assign_step`` is the inductive stochastic eval on another graph: each
layer assigns the batch's features to their feature-half codewords into
that graph's own ``c_indices`` table and runs the forward against it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from vq_gnn_tpu_torch.config import Config, no_reference_path, sum_dtype
from vq_gnn_tpu_torch.nn.model import (
    ModelStatic,
    activation,
    batchnorm_infer,
    layer_forward,
    model_forward,
    zero_probes,
    zero_probes_tr,
)
from vq_gnn_tpu_torch.nn.vq import feature_update, vq_update
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch
from vq_gnn_tpu_torch.train.optim import rmsprop_update
from vq_gnn_tpu_torch.train.state import TrainState


def _branch_view(x: torch.Tensor, nb: int, d: int) -> torch.Tensor:
    """[B, nb*d] -> [nb, B, d] per-branch slices (branch i = cols i*d:(i+1)*d)."""
    return x.reshape(x.shape[0], nb, d).permute(1, 0, 2)


def draw_branch_masks(ms: ModelStatic, generator=None, device=None) -> List[torch.Tensor]:
    """Per layer a [nb] bool mask keeping exactly int(nb * (1 - dropbranch))
    branches: the first of a random permutation (the reference's randperm
    subset with static shapes, ``vq_gnn_tpu/train/step.py:94-107``)."""
    masks = []
    for nb in ms.num_branches:
        perm = torch.randperm(nb, generator=generator, device=device)
        keep = torch.zeros(nb, dtype=torch.bool, device=device)
        keep[perm[: int(nb * (1.0 - ms.dropbranch))]] = True
        masks.append(keep)
    return masks


def masked_ce_parts(logits, y, mask):
    """(the summed CE over the masked rows, their count): the data-parallel
    step divides the sum by the count of every rank's rows."""
    ll = F.log_softmax(logits, dim=-1).gather(1, y[:, None].long())[:, 0]
    m = mask.to(logits.dtype)
    return -(ll * m).sum(), m.sum()


def masked_ce(logits, y, mask):
    ce_sum, count = masked_ce_parts(logits, y, mask)
    return ce_sum / torch.clamp(count, min=1.0)


def masked_bce_parts(logits, y, mask):
    """(the BCE-with-logits summed over the masked rows and every label, in
    the JAX package's stable form (``vq_gnn_tpu/train/step.py:55-58``), the
    rows' count): the sharded step divides the sum by the count of every
    rank's rows times the labels."""
    per = torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    m = mask.to(logits.dtype)[:, None]
    return (per * m).sum(), m.sum()


def masked_bce(logits, y, mask):
    """Mean over the masked rows and every label of BCE-with-logits."""
    bce_sum, count = masked_bce_parts(logits, y, mask)
    return bce_sum / torch.clamp(count * logits.shape[1], min=1.0)


def masked_accuracy(logits, y, mask):
    hit = (logits.argmax(-1) == y).to(torch.float32)
    m = mask.to(torch.float32)
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def step_forward(state: TrainState, ms: ModelStatic, X_dev: torch.Tensor, batch: PaddedBatch,
                 warm_up_rate, generator=None, branch_masks=None, dropout_keeps=None,
                 stats_reduce=None, model_axis=None):
    """A training step's forward: zero probes at each conv output (and the
    transformer's hook points), the batch rows gathered from the feature
    table, ``model_forward`` in training mode (``stats_reduce`` and
    ``model_axis`` are its hooks for a batch sharded over ranks).  Returns
    (out, info_b, layer_inputs, new_bn, probes, probes_tr)."""
    dev, pd = X_dev.device, sum_dtype(X_dev.dtype)
    probes = zero_probes(ms, batch.B_pad, dev, pd)
    probes_tr = zero_probes_tr(ms, batch.B_pad, dev, pd) if ms.transformer_flag else []
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
        vq_states_tr=state.vq_states_tr,
        probes_tr=probes_tr,
        branch_masks=branch_masks,
        dropout_keeps=dropout_keeps,
        stats_reduce=stats_reduce,
        model_axis=model_axis,
    )
    return out, info_b, layer_inputs, new_bn, probes, probes_tr


def live_vq_update(state: TrainState, ms: ModelStatic, layer_inputs, g_probes, g_probes_tr,
                   batch: PaddedBatch, branch_masks=None, stats_reduce=None,
                   cidx_merge_fn=None) -> None:
    """The reference hook body (models.py v2:39-56) per layer, in place on
    ``state``: X_B = the layer input's branch slices (detached), grad = the
    probe gradient's, i.e. dL/d(output slice); with ``transformer_flag`` also
    the transformer's codebooks, unless ``g_probes_tr`` is None (the link
    step's quirk: they keep their values).  ``stats_reduce`` and
    ``cidx_merge_fn`` are ``vq_update``'s data-parallel hooks."""
    D = ms.num_D
    for l in range(ms.num_layers):
        nb = ms.num_branches[l]
        Xb = _branch_view(layer_inputs[l].detach(), nb, D)
        gp = g_probes[l]
        # the B + M GAT probe is [nb, B_pad, D + 1]: the ones-column
        # gradient is quantized too (VQParams.add_flag)
        Gb = gp if gp.dim() == 3 else _branch_view(gp[:, : nb * D], nb, D)
        keep = None if branch_masks is None else branch_masks[l]
        state.vq_states[l], _ = vq_update(
            state.vq_states[l], Xb, Gb, batch.batch_idx, ms.vq, valid=batch.valid_B,
            branch_keep=keep, stats_reduce=stats_reduce, cidx_merge_fn=cidx_merge_fn,
        )
        if ms.transformer_flag and g_probes_tr is not None:  # its hook: [nb, B_pad, D + 1]
            state.vq_states_tr[l], _ = vq_update(
                state.vq_states_tr[l], Xb, g_probes_tr[l], batch.batch_idx, ms.vq_tr,
                valid=batch.valid_B, branch_keep=keep, stats_reduce=stats_reduce,
                cidx_merge_fn=cidx_merge_fn,
            )


@dataclasses.dataclass
class StepFns:
    train_step: Callable
    eval_step: Callable
    init_step_for: Callable  # layer_idx -> init-sweep step
    eval_assign_step: Callable = None  # inductive per-split c-table eval


def make_step_fns(ms: ModelStatic, cfg: Config, multilabel: bool = False) -> StepFns:
    """Node classification: CE, or with ``multilabel`` BCE over [B, C] float
    targets (no train accuracy then, 0)."""
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
        branch_masks: Optional[List[torch.Tensor]] = None,
        dropout_keeps: Optional[List[torch.Tensor]] = None,
    ):
        """One step; updates ``state`` in place and returns (state, metrics).
        Metrics are device tensors (no host sync).  ``branch_masks`` (a [nb]
        bool per layer) and ``dropout_keeps`` (a keep mask per hidden layer)
        override the draws from ``generator``."""
        if branch_masks is None and ms.dropbranch > 0:
            branch_masks = draw_branch_masks(ms, generator, X_dev.device)
        params = list(state.model.parameters())
        out, info_b, layer_inputs, new_bn, probes, probes_tr = step_forward(
            state, ms, X_dev, batch, warm_up_rate, generator, branch_masks, dropout_keeps)
        mask = batch.train_mask & batch.valid_B
        if multilabel:
            loss_cls = masked_bce(out, batch.y, mask)
            acc = torch.zeros((), device=out.device)
        else:
            loss_cls = masked_ce(out, batch.y, mask)
            acc = masked_accuracy(out.detach(), batch.y, mask)
        loss = loss_cls if cfg.ce_only else loss_cls + info_b
        grads = torch.autograd.grad(loss, params + probes + probes_tr)
        n_p, n_pr = len(params), len(probes)
        g_params, g_probes = grads[:n_p], grads[n_p : n_p + n_pr]
        g_probes_tr = grads[n_p + n_pr :]

        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)

        if live:  # runs even on skipped-optimizer windows (backward always fires hooks)
            live_vq_update(state, ms, layer_inputs, g_probes, g_probes_tr, batch, branch_masks)

        bad = [s.bad_init for s in state.vq_states + (state.vq_states_tr or [])]
        grad_norm = torch.sqrt(sum((g * g).sum() for g in g_params))
        metrics = {
            "loss": loss.detach(),
            "loss_cls": loss_cls.detach(),
            "train_acc": acc,
            "info_backward": torch.as_tensor(info_b).detach(),
            "grad_norm": grad_norm,
            "bad_init": torch.stack(bad).any(),
        }
        state.bn_state = new_bn
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, X_dev: torch.Tensor, batch: PaddedBatch):
        x_B = X_dev.index_select(0, batch.batch_idx)
        out, _, _, _ = model_forward(
            state.model, state.vq_states, state.bn_state, ms, x_B, batch, training=False,
            vq_states_tr=state.vq_states_tr,
        )
        return out

    @torch.no_grad()
    def eval_assign_step(state: TrainState, c_tables, X_dev: torch.Tensor, batch: PaddedBatch):
        """Stochastic eval on a *different* graph with per-split codeword
        tables (v1 ``models_inductive.py:242-292``): each layer assigns the
        batch's features to their nearest feature-half codeword, writes them
        into the split's own table ([N_split + 1, nb] int16, the padded slots
        into its dustbin row N_split) and runs the forward against it; the
        codebooks stay as they are.  Returns (out, c_tables), the tables
        updated in place.  The JAX package runs no transformer branch here
        (it passes no transformer codebook), so neither does the port."""
        if ms.transformer_flag:
            raise no_reference_path("eval_assign_step with transformer_flag")
        x = X_dev.index_select(0, batch.batch_idx)
        for l in range(ms.num_layers):
            nb = ms.num_branches[l]
            st = state.vq_states[l]
            _, idx = feature_update(st, _branch_view(x, nb, D), batch.batch_idx, ms.vq,
                                    valid=batch.valid_B, training=False)
            c_tables[l].index_copy_(0, batch.batch_idx, idx.t().to(torch.int16))
            st = dataclasses.replace(st, c_indices=c_tables[l])
            x, _ = layer_forward(state.model.layers[l], st, ms, x, batch, None, 1.0)
            if l < ms.num_layers - 1:
                if ms.bn_flag:
                    x = batchnorm_infer(x, state.bn_state.mean[l], state.bn_state.var[l])
                x = activation(x, ms.act)
        return x, c_tables

    def init_step_for(layer_idx: int) -> Callable:
        @torch.no_grad()
        def init_step(vq_states, vq_states_tr, model, X_dev, batch: PaddedBatch):
            """model.init partial forward (``models.py v2:370-374`` +
            ``main_node.py v2:17-37``): every still-uninited block runs
            feature_update on the current activations (the transformer's
            codebooks too, ``vq_states_tr``, None when off), then the layer
            forward uses the freshly updated codebooks.  Returns
            (vq_states, vq_states_tr)."""
            x = X_dev.index_select(0, batch.batch_idx)
            new_states = list(vq_states)
            new_tr = None if vq_states_tr is None else list(vq_states_tr)
            for l in range(layer_idx):
                nb = ms.num_branches[l]
                Xb = _branch_view(x, nb, D)
                new_states[l], _ = feature_update(
                    new_states[l], Xb, batch.batch_idx, ms.vq, valid=batch.valid_B,
                )
                if new_tr is not None:
                    new_tr[l], _ = feature_update(
                        new_tr[l], Xb, batch.batch_idx, ms.vq_tr, valid=batch.valid_B,
                    )
                x, _ = layer_forward(model.layers[l], new_states[l], ms, x, batch, None, 1.0,
                                     vq_tr=None if new_tr is None else new_tr[l])
                x = activation(x, ms.act)
            return new_states, new_tr

        return init_step

    return StepFns(train_step=train_step, eval_step=eval_step, init_step_for=init_step_for,
                   eval_assign_step=eval_assign_step)
