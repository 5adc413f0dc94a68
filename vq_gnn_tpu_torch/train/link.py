"""Link prediction — the reference ``main_link.py`` subsystem (port of
``vq_gnn_tpu/train/link.py``).

- :class:`LinkPredictor` / :func:`predictor_forward`: the LinkPredictor MLP
  head on ``x_i * x_j`` -> sigmoid (``main_link.py v2:18-41``);
- :func:`make_link_step`: one training step with the batch's in-batch
  positive edges, uniform in-batch negative destinations and the logistic
  loss (``main_link.py v2:43-99``), the per-layer gradient clip (84-88), the
  predictor's own RMSprop state, and the live VQ update;
- :class:`LinkTrainer`: the init sweep, epochs, Hits@K / MRR evaluation over
  the stochastic embeddings of the whole graph (126-244), and ``fit``, with
  its checkpoints (``vq_gnn_tpu/train/link.py:325-400``).

The reference's quirks are kept: the negatives are uniform over the batch's
``num_B`` rows; the positive and the negative predictor calls share their
dropout masks (one key in the JAX package); the log is clamped at 1e-15 with
``max``; train Hits are counted against the *valid* negatives.

The model options run as the JAX package runs them here: dropbranch and
alpha dropout as in the node step; with ``transformer_flag`` the forward
reads the transformer's codebooks, but the step takes no gradient of its
hook points, so those codebooks keep their init-sweep values
(``vq_gnn_tpu/train/link.py:88,151``).  A B + M GAT step with live VQ, which
the JAX package cannot run (its 3-D probe against a 2-D slice), raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vq_gnn_tpu_torch.config import (
    Config,
    apply_matmul_precision,
    no_reference_path,
    resolve_device,
)
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.nn.model import ModelStatic, model_forward, model_static, zero_probes
from vq_gnn_tpu_torch.ops.segsum import take_rows
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
from vq_gnn_tpu_torch.train.checkpoint import load_step, restore_checkpoint, save_checkpoint
from vq_gnn_tpu_torch.train.loop import device_features, iter_cached
from vq_gnn_tpu_torch.train.optim import clip_grads_by_norm, make_rmsprop, rmsprop_update
from vq_gnn_tpu_torch.train.state import TrainState, init_train_state
from vq_gnn_tpu_torch.train.step import draw_branch_masks, live_vq_update, make_step_fns
from vq_gnn_tpu_torch.utils.logger import Logger
from vq_gnn_tpu_torch.utils.metrics import hits_at_k, mrr
from vq_gnn_tpu_torch.utils.scheduler import linear_ramp


# ---------------- LinkPredictor MLP ----------------
class LinkPredictor(nn.Module):
    """in -> hidden, (num_layers - 2) x hidden -> hidden, hidden -> out
    (``main_link.py v2:18-28``); ``lins`` holds the ``nn.Linear``s."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers, device=None):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.lins = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device) for i in range(num_layers))


def init_predictor(generator: torch.Generator, in_channels, hidden_channels, out_channels,
                   num_layers, device=None) -> LinkPredictor:
    """torch.nn.Linear's default, W and b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``generator`` (a CPU generator; copied to ``device``)."""
    pred = LinkPredictor(in_channels, hidden_channels, out_channels, num_layers, device)
    with torch.no_grad():
        for lin in pred.lins:
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                t = torch.empty(p.shape)
                nn.init.uniform_(t, -bound, bound, generator=generator)
                p.copy_(t)
    return pred


def dropout_masks(pred: LinkPredictor, n: int, p: float, generator, device) -> Optional[list]:
    """Keep masks [n, hidden] of the predictor's hidden layers for dropout
    ``p`` (None at p = 0); one set serves both predictor calls of a step."""
    if p <= 0:
        return None
    return [torch.rand((n, lin.out_features), generator=generator, device=device) < 1.0 - p
            for lin in pred.lins[:-1]]


def predictor_forward(pred: LinkPredictor, x_i, x_j, keep: Optional[Sequence] = None,
                      dropout_p: float = 0.0):
    """sigmoid(MLP(x_i * x_j)), [n, out]; ``keep`` (from :func:`dropout_masks`)
    drops the hidden units where it is False and scales the rest by
    1 / (1 - dropout_p)."""
    x = x_i * x_j
    for i, lin in enumerate(pred.lins[:-1]):
        x = F.relu(F.linear(x, lin.weight, lin.bias))
        if keep is not None:
            x = torch.where(keep[i], x / (1.0 - dropout_p), torch.zeros_like(x))
    last = pred.lins[-1]
    return torch.sigmoid(F.linear(x, last.weight, last.bias))


def link_loss_parts(pred: LinkPredictor, out, src, dst, dst_neg, mask, keep, dropout_p: float):
    """(the positive pairs' summed -log p, the negatives' summed -log(1 - p),
    the pairs' count) over the pairs ``src`` -> ``dst`` and ``src`` ->
    ``dst_neg``, rows of ``out``, where ``mask`` holds; ``keep`` the
    predictor's dropout masks, one set for both calls.  The log is clamped
    at 1e-15 with ``max``, not "+ 1e-15" (reference ``main_link.py
    v2:64,69``): the same value in f32, and no log(0) at sigmoid saturation.

    The rows are gathered by ``ops/segsum.py:take_rows``, whose backward
    adds each row's contributions in a fixed order with no float atomics
    (``index_select``'s backward on CUDA is ``index_add_``, whose atomics
    sum in a new order each run): the source's, then the destination's,
    then the negative's, each in pair order, by kernel 8 (its plain version
    on CPU tensors).  The negatives are drawn on the device each step, so
    the 3 L endpoints are sorted there: one sort, glue beside the [3 L, C]
    gather and sum."""
    x_src, x_dst, x_neg = take_rows(out, src, dst, dst_neg)
    pos_out = predictor_forward(pred, x_src, x_dst, keep, dropout_p)[:, 0]
    neg_out = predictor_forward(pred, x_src, x_neg, keep, dropout_p)[:, 0]
    m = mask.to(out.dtype)
    pos = -(torch.log(torch.clamp(pos_out, min=1e-15)) * m).sum()
    neg = -(torch.log(torch.clamp(1.0 - neg_out, min=1e-15)) * m).sum()
    return pos, neg, m.sum()


def clip_groups(model: nn.Module, params: List[torch.Tensor], ms: ModelStatic, clip):
    """Per layer, the indices into ``params`` of each group the link step
    clips: ``gnn_transform`` (``clip[0]``) and, for GAT with a second value,
    ``att_l`` with ``att_r`` (``clip[1]``)."""
    pos = {id(p): i for i, p in enumerate(params)}
    groups = []
    for layer in model.layers:
        t = layer.gnn_transform
        groups.append(([pos[id(t.weight)], pos[id(t.bias)]], clip[0]))
        if ms.conv_type == "GAT" and len(clip) > 1:
            groups.append(([pos[id(layer.att_l)], pos[id(layer.att_r)]], clip[1]))
    return groups


def check_link_config(ms: ModelStatic, cfg: Config) -> None:
    """Raise by name what the JAX link step cannot run: the live VQ update of
    a B + M GAT model (its 3-D probe against a 2-D slice)."""
    if cfg.vq_update_mode == "live" and ms.formulation == "bm" and ms.conv_type == "GAT":
        raise no_reference_path("the link step's live VQ update of a B + M GAT model")


def make_link_step(ms: ModelStatic, cfg: Config):
    """(link_train_step, score_pairs) (``vq_gnn_tpu/train/link.py:58-161``)."""
    check_link_config(ms, cfg)
    live = cfg.vq_update_mode == "live"
    clip = cfg.clip

    def link_train_step(state: TrainState, pred: LinkPredictor, pred_opt, X_dev: torch.Tensor,
                        batch: PaddedBatch, warm_up_rate: float, lr: float, do_opt_step: float,
                        generator=None, dst_neg: Optional[torch.Tensor] = None,
                        pred_keep: Optional[list] = None,
                        branch_masks: Optional[List[torch.Tensor]] = None,
                        dropout_keeps: Optional[List[torch.Tensor]] = None):
        """One step; updates ``state``, ``pred`` and ``pred_opt`` in place and
        returns the metrics (device tensors).  ``dst_neg`` [L_pad], the
        predictor's dropout masks ``pred_keep``, the dropbranch masks
        ``branch_masks`` and the model's (alpha) dropout masks
        ``dropout_keeps`` override the draws from ``generator``."""
        dev = X_dev.device
        if dst_neg is None:
            # uniform in-batch negative destinations (main_link.py v2:66-69)
            dst_neg = torch.randint(0, max(batch.num_B, 1), batch.link_src.shape,
                                    generator=generator, device=dev)
        keep = pred_keep
        if keep is None:
            keep = dropout_masks(pred, batch.link_src.shape[0], cfg.dropout, generator, dev)
        if branch_masks is None and ms.dropbranch > 0:
            branch_masks = draw_branch_masks(ms, generator, dev)
        probes = zero_probes(ms, batch.B_pad, dev)
        params = list(state.model.parameters())
        pparams = list(pred.parameters())
        x_B = X_dev.index_select(0, batch.batch_idx)
        out, info_b, layer_inputs, new_bn = model_forward(
            state.model, state.vq_states, state.bn_state, ms, x_B, batch, probes=probes,
            warm_up_rate=warm_up_rate, training=True, generator=generator,
            vq_states_tr=state.vq_states_tr, branch_masks=branch_masks,
            dropout_keeps=dropout_keeps,
        )
        pos_sum, neg_sum, count = link_loss_parts(
            pred, out, batch.link_src, batch.link_dst, dst_neg, batch.link_mask, keep,
            cfg.dropout)
        n = torch.clamp(count, min=1.0)
        loss_pre = pos_sum / n + neg_sum / n
        loss = loss_pre if cfg.ce_only else loss_pre + info_b
        grads = torch.autograd.grad(loss, params + pparams + probes)
        g_params = list(grads[: len(params)])
        g_pred = grads[len(params) : len(params) + len(pparams)]
        g_probes = grads[len(params) + len(pparams) :]

        if clip is not None:
            # per-layer clip of the gnn_transform (+ GAT attention) grads
            # (main_link.py v2:84-88)
            for idx, max_norm in clip_groups(state.model, params, ms, clip):
                for i, g in zip(idx, clip_grads_by_norm([g_params[i] for i in idx], max_norm)):
                    g_params[i] = g

        rmsprop_update(state.optimizer, params, g_params, lr, do_opt_step > 0)
        rmsprop_update(pred_opt, pparams, g_pred, lr, do_opt_step > 0)

        if live:  # the layers' codebooks only (the module docstring)
            live_vq_update(state, ms, layer_inputs, g_probes, None, batch, branch_masks)
        state.bn_state = new_bn
        state.step += 1
        return {
            "loss": loss.detach(),
            "loss_pre": loss_pre.detach(),
            "bad_init": torch.stack([s.bad_init for s in state.vq_states]).any(),
        }

    @torch.no_grad()
    def score_pairs(pred: LinkPredictor, h, src, dst):
        return predictor_forward(pred, h.index_select(0, src), h.index_select(0, dst))[:, 0]

    return link_train_step, score_pairs


@dataclasses.dataclass
class SplitEdges:
    """OGB link split: arrays of [n, 2] positive edges and negatives."""

    train_pos: np.ndarray
    valid_pos: np.ndarray
    valid_neg: np.ndarray
    test_pos: np.ndarray
    test_neg: np.ndarray
    # citation2-style: per-source negative lists [n, k] (None for collab)
    neg_per_source: bool = False


class LinkTrainer:
    """collab/citation2-style trainer (``main_link.py v2:248-415``)."""

    def __init__(self, graph: HostGraph, cfg: Config, split: SplitEdges,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        apply_matmul_precision(cfg)
        self.graph, self.cfg, self.split = graph, cfg, split
        self.ms = model_static(cfg, graph.num_features, cfg.hidden_channels, self.device)
        self.X_dev = device_features(graph.x, self.device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.state = init_train_state(gen, self.ms, graph.num_nodes, cfg.lr, self.device)
        self.predictor = init_predictor(gen, cfg.hidden_channels, cfg.hidden_channels, 1,
                                        cfg.num_layers, self.device)
        self.pred_opt = make_rmsprop(self.predictor.parameters(), cfg.lr)
        if cfg.exact_eval_train_edges and 0 < cfg.test_batch_size < graph.num_nodes:
            raise ValueError(
                "exact_eval_train_edges requires full-graph eval batches "
                f"(test_batch_size {cfg.test_batch_size} < num_nodes {graph.num_nodes})"
            )
        self.train_loader = BatchLoader(graph, cfg, train_flag=True, seed=cfg.seed,
                                        with_link_edges=True, device=self.device)
        self.test_loader = BatchLoader(
            graph, cfg,
            # the exact control evaluates through the train-time edge
            # construction (Config.exact_eval_train_edges)
            train_flag=cfg.exact_eval_train_edges,
            sampler_type="node", batch_size=cfg.test_batch_size, shuffle=False,
            seed=cfg.seed + 1, with_link_edges=True, device=self.device,
        )
        self.step_fn, self.score_fn = make_link_step(self.ms, cfg)
        self.fns = make_step_fns(self.ms, cfg)
        # negatives and dropout masks are drawn on the device, from their own stream
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 29)
        self.logger = Logger(cfg.runs, cfg)
        # the eval loader and the exact control's one full-graph train batch
        # are deterministic: built once (train/loop.iter_cached)
        self._batch_cache = {}
        self._cache_train = cfg.sampler_type == "node" and cfg.batch_size >= graph.num_nodes

    def test_batches(self):
        return iter_cached(self._batch_cache, "test", self.test_loader)

    def run_init_sweep(self):
        for layer_idx in range(1, self.ms.num_layers + 1):
            step = self.fns.init_step_for(layer_idx)
            for windows, _ in self.test_batches():
                self.state.vq_states, self.state.vq_states_tr = step(
                    self.state.vq_states, self.state.vq_states_tr, self.state.model,
                    self.X_dev, windows[0])

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        wur = (epoch / cfg.warm_up_epochs
               if cfg.warm_up and epoch <= cfg.warm_up_epochs else 1.0)
        lr = linear_ramp(cfg.lr, epoch) if cfg.sche else cfg.lr
        losses = []
        train_iter = self.train_loader
        if self._cache_train:
            train_iter = iter_cached(self._batch_cache, "train", self.train_loader)
        for windows, _ in train_iter:
            for j, batch in enumerate(windows):
                do_opt = 0.0 if (len(windows) > 1 and j == 0) else 1.0
                metrics = self.step_fn(self.state, self.predictor, self.pred_opt, self.X_dev,
                                       batch, wur, lr, do_opt, self.generator)
                if bool(metrics["bad_init"]):
                    raise ValueError("Bad Init!")
                losses.append(float(metrics["loss_pre"]))
        return float(np.mean(losses)) if losses else float("nan")

    def embeddings(self) -> torch.Tensor:
        """[N, hidden] stochastic embeddings of every node, on the device."""
        return torch.cat([self.fns.eval_step(self.state, self.X_dev, windows[0])[: len(raw[0])]
                          for windows, raw in self.test_batches()])

    def _scores(self, h, edges: np.ndarray, chunk=65536) -> np.ndarray:
        out = []
        for i in range(0, len(edges), chunk):
            e = torch.as_tensor(np.asarray(edges[i : i + chunk], np.int64)).to(self.device)
            out.append(self.score_fn(self.predictor, h, e[:, 0], e[:, 1]).cpu().numpy())
        return np.concatenate(out) if out else np.empty(0, np.float32)

    def evaluate_hits(self, k: int = 50):
        """ogbl-collab protocol (``main_link.py v2:171-244``): train hits are
        computed against the VALID negatives (reference line 230-233)."""
        h = self.embeddings()
        s = self.split
        pos_train = self._scores(h, s.train_pos)
        pos_valid = self._scores(h, s.valid_pos)
        neg_valid = self._scores(h, s.valid_neg)
        pos_test = self._scores(h, s.test_pos)
        neg_test = self._scores(h, s.test_neg)
        return (
            hits_at_k(pos_train, neg_valid, k),
            hits_at_k(pos_valid, neg_valid, k),
            hits_at_k(pos_test, neg_test, k),
        )

    def evaluate_mrr(self):
        """ogbl-citation2 protocol: per-source negatives (``v2:126-169``)."""
        h = self.embeddings()
        s = self.split

        def split_mrr(pos, negs):
            p = self._scores(h, pos)
            n = self._scores(
                h, np.stack([np.repeat(pos[:, 0], negs.shape[1]), negs.reshape(-1)], axis=1)
            ).reshape(len(pos), -1)
            return mrr(p, n)

        return (
            split_mrr(s.train_pos, s.valid_neg),
            split_mrr(s.valid_pos, s.valid_neg),
            split_mrr(s.test_pos, s.test_neg),
        )

    def _ckpt_tree(self) -> dict:
        """The whole resumable state, as the JAX package's link trainer
        writes it: the GNN train state, the predictor's parameters and its
        RMSprop ``nu`` (the JAX layouts, ``convert.predictor_to_numpy``)."""
        from vq_gnn_tpu_torch.convert import predictor_to_numpy

        pred_params, pred_nu = predictor_to_numpy(self.predictor, self.pred_opt)
        return {"state": self.state, "pred_params": pred_params, "pred_nu": pred_nu}

    def fit(self, run: int = 0, verbose: bool = True, ckpt_dir: Optional[str] = None,
            ckpt_every: int = 50, resume: bool = False, eval_every: int = 1):
        """The init sweep, then per epoch ``train_epoch`` and, every
        ``eval_every`` epochs and at the last, Hits@50 (MRR for per-source
        negatives) into the logger; returns ``logger.statistics(run)``.

        With ``ckpt_dir``, ``_ckpt_tree`` is saved to
        ``<ckpt_dir>/link_run<run>.npz`` after each ``ckpt_every``-th epoch's
        training, before its evaluation; with ``resume`` too, an archive
        found there is restored and the run goes on at the next epoch,
        without the init sweep.  As in the JAX package the generator, the
        loader's epoch cursor and the logger's history are not restored
        (its leak segmentation, ``segment_path``, is not ported)."""
        from vq_gnn_tpu_torch.convert import predictor_from_numpy

        cfg = self.cfg
        ckpt_path, start_epoch = None, 1
        if ckpt_dir:
            ckpt_path = os.path.join(ckpt_dir, f"link_run{run}.npz")
            if resume and os.path.exists(ckpt_path):
                restored = restore_checkpoint(ckpt_path, self._ckpt_tree())
                self.state = restored["state"]
                self.predictor, self.pred_opt = predictor_from_numpy(
                    restored["pred_params"], restored["pred_nu"], cfg.lr, self.device)
                start_epoch = load_step(ckpt_path) + 1
                if verbose:
                    print(f"resumed from {ckpt_path} at epoch {start_epoch}")
        if start_epoch == 1:
            self.run_init_sweep()
        t0 = time.time()
        for epoch in range(start_epoch, cfg.epochs + 1):
            loss = self.train_epoch(epoch)
            if ckpt_path and epoch % ckpt_every == 0:
                save_checkpoint(ckpt_path, self._ckpt_tree(), step=epoch)
            if epoch % eval_every == 0 or epoch == cfg.epochs:
                result = (self.evaluate_mrr() if self.split.neg_per_source
                          else self.evaluate_hits())
                self.logger.add_result(run, result)
                if verbose and epoch % cfg.log_steps == 0:
                    tr, va, te = result
                    print(
                        f"Run: {run + 1}, Epoch: {epoch}, Loss: {loss:.4f}, "
                        f"Train: {100 * tr:.2f}%, Valid: {100 * va:.2f}%, "
                        f"Test: {100 * te:.2f}% [{time.time() - t0:.1f}s]",
                        flush=True,
                    )
        return self.logger.statistics(run)
