"""LowRankGNN — the VQ-GNN model (port of ``vq_gnn_tpu/nn/model.py``: the
B + B' (v2) and B + M (v1) formulations for GCN, SAGE and GAT, with the v1
transformer branch, dropbranch and alpha dropout).

- ``LowRankGNN``       an ``nn.Module`` holding the per-layer linears (and the
                       GAT attention vectors)
- ``init_params``      torch-default Linear init (PyG glorot for the attention
                       vectors) from a ``torch.Generator``
- ``layer_forward``    one LowRankGNNLayer (``models.py v2:144-231``), or with
                       ``formulation='bm'`` one v1 layer (``layer_forward_bm``,
                       ``vq_gnn_v1/models.py:143-233``)
- ``transformer_branch``  the v1 low-rank global attention between the batch
                       and a second codebook (B + M, ``transformer_flag``)
- ``model_forward``    the stack; returns per-layer inputs + info_backward
- ``full_graph_inference``  the plain conv stack over the whole graph with
                       the learned weights, codebooks bypassed

The reference's backward hook (``models.py v2:181-185``) becomes *probes*:
zero tensors with ``requires_grad=True`` added to each conv output's batch
rows.  The gradient of the loss with respect to a probe is exactly
``dL/d(x_output_B)``, what the reference hook receives; it feeds the VQ
update after the step (visible to the next batch, matching hook timing).

Every function that draws (dropout, alpha dropout) also takes its mask, and
the dropbranch keep masks ``branch_keep`` always come from the caller
(``train/step.py`` draws them), so that a test can feed the JAX package's
own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vq_gnn_tpu_torch.config import (
    Config,
    check_ported,
    resolve_vq_backend,
    stream_dtype,
    sum_dtype,
)
from vq_gnn_tpu_torch.nn.vq import VQParams, VQState, lookup
from vq_gnn_tpu_torch.ops.gat import (
    branch_scale,
    explosion_scale,
    gat_conv_coo,
    gat_conv_ell,
    gat_conv_ell_mh,
    gat_edge_values,
    node_logits,
    ranks_max,
)
from vq_gnn_tpu_torch.ops.rev_kernels import rev_fold_mode, rev_recovery_info
from vq_gnn_tpu_torch.ops.segsum import sum_at
from vq_gnn_tpu_torch.ops.spmm import spmm, spmm_branches
from vq_gnn_tpu_torch.ops.vq_ops import masked_moments
from vq_gnn_tpu_torch.sampler.batch import PaddedBatch

ALPHA_DROPOUT_ALPHA = -1.7580993408473766  # SELU alpha' (torch AlphaDropout)


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
    formulation: str = "bbprime"  # 'bbprime' (v2 B + B') or 'bm' (v1 B + M)
    # ce_only runs never read info_backward; the B + M exact-reverse term is
    # then skipped (0), as in the JAX package
    ce_only: bool = False
    # the dtype the convs stream x_input at ('float32', 'bfloat16' or
    # 'float16'); sums, outputs, parameters and probes stay f32
    compute_dtype: str = "float32"
    alpha_dropout_flag: bool = False  # torch AlphaDropout in place of dropout
    # stochastic branch dropping: each training step keeps exactly
    # int(nb * (1 - p)) branches a layer; a dropped branch contributes no
    # codebook features, no recovery term, no VQ / c_indices update and (B +
    # M) a zeroed hidden slice (vq_gnn_tpu/nn/model.py:62-69)
    dropbranch: float = 0.0
    # v1 parallel low-rank global-attention branch (B + M only)
    transformer_flag: bool = False

    @property
    def vq_tr(self) -> VQParams:
        """The transformer's codebooks always quantize the ones-column
        gradient (v1/models.py:272: add_flag=True)."""
        return dataclasses.replace(self.vq, add_flag=True)

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
        # v1 GNN blocks quantize the ones-column gradient only for GAT
        # (vq_gnn_v1/models.py:53, 278); v2 never does
        add_flag=cfg.formulation == "bm" and cfg.conv_type == "GAT",
        backend=resolve_vq_backend(cfg.vq_backend, device),
    )
    # the JAX package's checks and messages (vq_gnn_tpu/nn/model.py:121-131)
    if cfg.dropbranch > 0:
        if not 0.0 < cfg.dropbranch < 1.0:
            raise ValueError("dropbranch must be in [0, 1)")
        for c in chans[:-1]:
            if int((c // cfg.num_D) * (1.0 - cfg.dropbranch)) < 1:
                raise ValueError("dropbranch too large: a layer would keep zero branches")
    if cfg.transformer_flag and cfg.formulation != "bm":
        # the v2 transformer path is commented out (models.py v2:206-226)
        raise NotImplementedError("transformer_flag requires formulation='bm'")
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
        formulation=cfg.formulation,
        ce_only=cfg.ce_only,
        compute_dtype=cfg.compute_dtype,
        alpha_dropout_flag=cfg.alpha_dropout_flag,
        dropbranch=cfg.dropbranch,
        transformer_flag=cfg.transformer_flag,
    )


# --------------------------------------------------------------------------
# parameters (torch-default distributions)
# --------------------------------------------------------------------------
class LowRankGNN(nn.Module):
    """Per layer: ``gnn_transform`` (+ ``fc_sage`` for SAGE, ``linear_skip``
    with ``skip``, the attention vectors ``att_l``/``att_r`` for GAT: [c_in +
    1], or in the B + M formulation one per branch, [nb, D + 1]).  Weights
    are [out, in] as in ``nn.Linear``.  With ``transformer_flag``:
    ``transformer_v`` and ``transformer_res`` (linears) and ``transformer_k``,
    the per-branch [D, D] linears as JAX keeps them, ``w`` [nb, D_in,
    D_out] and ``b`` [nb, D]."""

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
            if ms.conv_type == "GAT":
                shape = ((c_in // ms.num_D, ms.num_D + 1) if ms.formulation == "bm"
                         else (c_in + 1,))
                layer.att_l = nn.Parameter(torch.empty(shape, device=device))
                layer.att_r = nn.Parameter(torch.empty(shape, device=device))
            if ms.transformer_flag:
                nb, D = c_in // ms.num_D, ms.num_D
                layer.transformer_k = nn.Module()
                layer.transformer_k.w = nn.Parameter(torch.empty((nb, D, D), device=device))
                layer.transformer_k.b = nn.Parameter(torch.empty((nb, D), device=device))
                layer.transformer_v = nn.Linear(c_in, c_out, device=device)
                layer.transformer_res = nn.Linear(c_in, c_out, device=device)
            self.layers.append(layer)


def init_params(model: LowRankGNN, generator: torch.Generator) -> LowRankGNN:
    """torch.nn.Linear's default: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (the transformer's per-branch ``transformer_k`` with fan_in D); then PyG
    glorot on each GAT attention vector of length c (the last dimension; one
    per branch in the B + M formulation): U(-a, a), a = sqrt(6 / (1 + c))
    (``vq_gnn_tpu/nn/model.py:163-206``).  Drawn from ``generator`` (a CPU
    generator; values copied to the device)."""

    def draw(p, bound):
        t = torch.empty(p.shape)
        nn.init.uniform_(t, -bound, bound, generator=generator)
        p.copy_(t)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    draw(p, bound)
        for layer in model.layers:
            for name in ("att_l", "att_r"):
                if hasattr(layer, name):
                    p = getattr(layer, name)
                    draw(p, math.sqrt(6.0 / (1.0 + p.shape[-1])))
            if hasattr(layer, "transformer_k"):
                tk = layer.transformer_k
                for p in (tk.w, tk.b):
                    draw(p, 1.0 / math.sqrt(tk.w.shape[1]))
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


def dropout_keep(x, p: float, generator: Optional[torch.Generator] = None):
    """A keep mask of x's shape, True with probability 1 - p."""
    return torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p


def dropout(x, p: float, training: bool, generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None):
    if not training or p == 0.0:
        return x
    if keep is None:
        keep = dropout_keep(x, p, generator)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def alpha_dropout(x, p: float, training: bool, generator: Optional[torch.Generator] = None,
                  keep: Optional[torch.Tensor] = None):
    """torch.nn.AlphaDropout's semantics (SELU self-normalising dropout) in
    the JAX package's form (``vq_gnn_tpu/nn/model.py:244-253``): a dropped
    unit takes alpha', then the affine a * x + b keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = ALPHA_DROPOUT_ALPHA
    q = 1.0 - p
    a = (q * (1.0 + p * alpha**2)) ** -0.5
    b = -a * alpha * p
    if keep is None:
        keep = dropout_keep(x, p, generator)
    return a * torch.where(keep, x, torch.full_like(x, alpha)) + b


def _keep_cols(keep: torch.Tensor, width: int, dtype=torch.float32):
    """A [nb] branch keep mask as a [1, nb * width] column mask of ``dtype``."""
    return keep.to(dtype).repeat_interleave(width)[None, :]


def batchnorm_infer(x, mean, var, eps=1e-5):
    return (x - mean[None, :]) * torch.rsqrt(var[None, :] + eps)


def batchnorm_train(x, mean, var, valid, eps=1e-5, momentum=0.1, stats_reduce=None):
    """Affine-free BN over valid batch rows; returns (y, new_mean, new_var).
    ``stats_reduce`` (``masked_moments``'s, differentiable) takes the moments
    over every rank's rows: a batch sharded by rows (``parallel/sharded.py``)."""
    ((b_mean, b_var, b_var_u),) = masked_moments([x], valid, stats_reduce)
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
    probe: Optional[torch.Tensor],  # [B_pad, C_in (+1 for GAT)] or None
    warm_up_rate,
    branch_keep: Optional[torch.Tensor] = None,  # [nb] bool, the dropbranch mask
    vq_tr: Optional[VQState] = None,
    probe_tr: Optional[torch.Tensor] = None,
    fan_in_reduce=None,
):
    """One LowRankGNNLayer forward (``models.py v2:144-231``), GCN, SAGE or
    GAT.  A GAT probe is [B_pad, C_in + 1]: its last column lands on the
    ones-column normaliser before the division.  With ``formulation='bm'``
    the v1 layer, :func:`layer_forward_bm` (which alone reads ``vq_tr`` and
    ``probe_tr``, the transformer branch's).  A dropped branch
    (``branch_keep`` False) contributes no codebook features and no
    recovery term; its batch-row columns stay, like the reference's
    full-width x into the conv (``vq_gnn_tpu/nn/model.py:303-311``).

    Under bf16 compute (``ms.compute_dtype``) the lookup rounds its codewords
    to bf16 and x_input is cast to bf16 after the concatenation
    (``vq_gnn_tpu/nn/model.py:294-321``); under f16 compute the lookup stays
    f32, as there (its stream is bf16's alone), and x_input is cast to f16
    after the concatenation.  The conv's output is f32 in every dtype.

    ``fan_in_reduce`` is the 2-D mesh's (``parallel/sharded.py``): x holds
    this rank's branches' columns and the linears their fan-in rows, and
    the function sums the partial products over the ranks of the branches
    (see :func:`_layer_output`); the B + M layer takes it too.  A row
    shard's edges carry their GAT conv (``ShardEdges.gat``, bound to the
    ranks by the sharded step), which takes the place of the logits, the
    Trick-1 scale and the conv here, in each layout.

    Returns (x_out [B_pad, C_out], info_backward scalar)."""
    if ms.formulation == "bm":
        return layer_forward_bm(layer, vq_state, ms, x, batch, probe, warm_up_rate,
                                branch_keep=branch_keep, vq_tr=vq_tr, probe_tr=probe_tr,
                                fan_in_reduce=fan_in_reduce)
    B_pad = batch.B_pad
    cd = stream_dtype(ms.compute_dtype, x.dtype)
    # out-of-batch features/grads from the codebook (models.py v2:165-173);
    # the lookup streams bf16 when the whole compute path does (f16 compute
    # passes no stream: vq_gnn_tpu/nn/model.py:295-298)
    x_fo, grad_fo = lookup(vq_state, batch.fo_ids, ms.vq,
                           stream=cd if cd == torch.bfloat16 else None)
    fo_mask = batch.valid_fo.to(x.dtype)[:, None]
    x_fo = x_fo * fo_mask
    grad_fo = (grad_fo * fo_mask).detach()
    if branch_keep is not None:
        x_fo = x_fo * _keep_cols(branch_keep, ms.num_D, x_fo.dtype)
        grad_fo = grad_fo * _keep_cols(branch_keep, ms.vq.grad_dim, grad_fo.dtype)

    x_input = torch.cat([x, x_fo], dim=0).contiguous()  # [dim_pad, C_in]
    if x_input.dtype != cd:
        x_input = x_input.to(cd)
    if ms.conv_type == "GAT":
        C = x_input.shape[1]
        xf = x_input.to(sum_dtype(x_input.dtype))
        valid_all = torch.cat([batch.valid_B, batch.valid_fo])
        e = batch.edges
        if getattr(e, "gat", None) is not None:
            # a row shard's conv, bound to its ranks (parallel/sharded.py)
            x_out, norm_col = e.gat(x_input, xf, layer.att_l, layer.att_r, valid_all)
        elif e.ell_row is None and not e.mixed:
            # COO: f32 logits of the (C+1)-wide rows, per-edge values, a
            # COO spmm that differentiates them (vq_gnn_tpu/nn/model.py:312-352)
            x_out, norm_col = gat_conv_coo(e, x_input, xf, layer.att_l, layer.att_r, valid_all)
        else:
            # logits of the (C+1)-wide reference input: the C-wide product
            # plus the ones-column bias att[C] (a 16-bit dot under 16-bit
            # compute, then f32 with the bias), for the Trick-1 scale; the
            # conv reuses x widened once and ar, and forms its own al (f32
            # att, unrounded)
            al, ar = node_logits(x_input, xf, layer.att_l, layer.att_r)
            scale = explosion_scale(al, ar, valid_all)  # Trick 1 (convs.py v2:209)
            x_out, norm_col = gat_conv_ell(e, x_input, layer.att_l, layer.att_r, scale,
                                           xf=xf.detach(), ar=ar.detach())
        x_out_B, norm_B = x_out[:B_pad], norm_col[:B_pad]
        if probe is not None:  # the reference hook point, (C+1) wide
            x_out_B = x_out_B + probe[:, :C]
            norm_B = norm_B + probe[:, C:]
        # ones-column normalisation of the batch rows (models.py v2:187-189)
        x_out_B = x_out_B / (norm_B + 1e-16)
    else:
        x_out = spmm(batch.edges, x_input)
        # the probe is the reference's per-branch grad hook point
        x_out_B = x_out[:B_pad]
        if probe is not None:
            x_out_B = x_out_B + probe
    x_out_fo = x_out[B_pad:]  # unnormalised, as in the reference

    # gradient recovery term (models.py v2:198-200)
    info_backward = (x_out_fo * grad_fo * warm_up_rate).sum()
    return _layer_output(layer, ms, x, x_out_B, fan_in_reduce=fan_in_reduce), info_backward


def _layer_output(layer, ms: ModelStatic, x, conv_B, x_tr=None, fan_in_reduce=None):
    """gnn_transform of the conv output, + the SAGE root weight (models.py
    v2:203-204), the transformer branch's ``transformer_v`` of its output
    ``x_tr`` and ``transformer_res`` of the layer input (v1/models.py:
    342-362), and the skip linear of the layer input.  With
    ``fan_in_reduce`` (the 2-D mesh: GCN, SAGE and GAT, with or without the
    transformer) the products without their biases are summed locally,
    ``fan_in_reduce`` adds the other ranks' partial sums, then the biases
    are added once."""
    if fan_in_reduce is not None:
        lins = [(layer.gnn_transform, conv_B)]
        lins += [(layer.fc_sage, x)] if ms.conv_type == "SAGE" else []
        if x_tr is not None:
            lins += [(layer.transformer_v, x_tr), (layer.transformer_res, x)]
        lins += [(layer.linear_skip, x)] if ms.skip else []
        out = fan_in_reduce(sum(F.linear(a, lin.weight) for lin, a in lins))
        return out + sum(lin.bias for lin, _ in lins)
    out = F.linear(conv_B, layer.gnn_transform.weight, layer.gnn_transform.bias)
    if ms.conv_type == "SAGE":
        out = out + F.linear(x, layer.fc_sage.weight, layer.fc_sage.bias)
    if x_tr is not None:
        out = (out + F.linear(x_tr, layer.transformer_v.weight, layer.transformer_v.bias)
               + F.linear(x, layer.transformer_res.weight, layer.transformer_res.bias))
    if ms.skip:
        out = out + F.linear(x, layer.linear_skip.weight, layer.linear_skip.bias)
    return out


# --------------------------------------------------------------------------
# one layer, B+M (v1 mapper) formulation
# --------------------------------------------------------------------------
def _bm_exact_reverse_info(vq_state: VQState, ms: ModelStatic, batch: PaddedBatch, x_cols,
                           warm_up_rate, al=None, ar_cb=None, branch_keep=None):
    """The v1 codeword-row recovery term for non-GCN convs
    (``vq_gnn_tpu/nn/model.py:408-500``): per branch the [M, B] cell matrix
    relu(sum of reverse values) the mapper produces after coalesce +
    keep-positive, times the GAT attention when given, contracted with the
    batch features and the codeword grad table.  Over the batch's rev-ELL
    (beside an ELL adjacency): kernels 9-10 on CUDA tensors, the plain grid
    on CPU tensors (``ops/rev_kernels.py``), folding the cells as
    ``VQ_GNN_REV_FOLD`` says (``rev_fold_mode``).  Over the raw list (beside
    COO): the JAX package's grid path, plain PyTorch on every device.

    x_cols [nb, B_pad, Dg]; al [nb, B_pad] and ar_cb [nb, M] (zeros: no
    attention, exp(leaky(0)) == 1); a dropped branch's term is zeroed."""
    if ms.ce_only:
        return x_cols.new_zeros(())
    D, M = ms.num_D, ms.vq.num_M
    nb, B_pad, _ = x_cols.shape
    grad_table = vq_state.embedding_output[:, :, D:].detach()
    if batch.rev_slot_row is None:  # the raw list beside a COO adjacency
        infos = _bm_reverse_grid(vq_state.c_indices, batch, x_cols, al, ar_cb, grad_table, M)
    else:
        if al is None:
            al = x_cols.new_zeros((nb, B_pad))
            ar_cb = x_cols.new_zeros((nb, M))
        infos = rev_recovery_info(vq_state.c_indices, batch.rev_slot_col, batch.rev_slot_val,
                                  batch.rev_slot_row, x_cols, al, ar_cb, grad_table,
                                  row_ptr=batch.rev_row_ptr, long_rows=batch.rev_long_rows,
                                  fold=rev_fold_mode())
    if branch_keep is not None:
        infos = infos * branch_keep.to(infos.dtype)
    return infos.sum() * warm_up_rate


def _bm_reverse_grid(c_indices, batch: PaddedBatch, x_cols, al, ar_cb, grad_table, M: int):
    """Per-branch recovery terms [nb] over the raw reverse list, the JAX
    package's grid path (``vq_gnn_tpu/nn/model.py:478-500``) in plain
    PyTorch: per branch the values summed into an [M * B_pad] cell grid at
    (codeword of the neighbour, batch row), relu, the attention surface when
    given, then the product with the batch features and the grad table."""
    nb, B_pad, _ = x_cols.shape
    cols = batch.bm_rev_col.clamp(0, c_indices.shape[0] - 1)
    code = c_indices.index_select(0, cols).long().t()  # [nb, R]
    cell = code * B_pad + batch.bm_rev_row[None, :]
    # the per-branch scatter-add in a fixed order (ops/segsum.py:sum_at; a
    # scatter_add_ sums with float atomics on CUDA, in a new order each run)
    keys = cell + torch.arange(nb, device=cell.device)[:, None] * (M * B_pad)
    grid = sum_at(keys.reshape(-1), batch.bm_rev_val.float().repeat(nb), nb * M * B_pad)
    S = F.relu(grid).reshape(nb, M, B_pad)
    if al is not None:
        S = S * torch.exp(F.leaky_relu(al[:, None, :] + ar_cb[:, :, None], 0.2))
    out_M = torch.bmm(S, x_cols.float())  # [nb, M, Dg]
    return (out_M * grad_table).sum((1, 2))


def _branch_logits(x, att, D: int):
    """Per-branch logits [rows, nb] of [rows, nb*D] features and att [nb,
    D + 1] (the last entry multiplies the ones column), elementwise."""
    nb = att.shape[0]
    return (x.reshape(x.shape[0], nb, D) * att[None, :, :D]).sum(-1) + att[None, :, D]


def transformer_cmax(nB, nM, valid, ranks=None):
    """The transformer branch's guard c_max [nb] (convs.py:279): each
    branch's largest squared row norm over the valid batch rows (nB [nb,
    B_pad]) and over its codewords (nM [nb, M]).  With ``ranks`` (a row
    shard's, as ``ops/gat.py:branch_scale`` takes them) the rows' max is
    over every rank's valid rows and its gradient the whole batch's, one
    all-reduce of [nb] forward and of [2, nb] backward
    (``ops/gat.py:ranks_max``); the codewords' max joins it after, locally,
    and a tie between the two splits the cotangent as ``torch.maximum``
    does."""
    v = nB.masked_fill(~valid[None, :], float("-inf"))
    rows = v.amax(1) if ranks is None else ranks_max(v, ranks)
    return torch.maximum(rows, nM.amax(1))


def transformer_branch(
    layer: nn.Module,
    vq_tr: VQState,
    ms: ModelStatic,
    x: torch.Tensor,  # [B_pad, C_in]
    batch: PaddedBatch,
    probe_tr: Optional[torch.Tensor],  # [nb, B_pad, D + 1]
    warm_up_rate,
    branch_keep: Optional[torch.Tensor] = None,  # [nb] bool, the dropbranch mask
):
    """The v1 parallel low-rank global-attention branch (v1/models.py:143-233
    with transformer_flag, convs.py:269-287; ``vq_gnn_tpu/nn/model.py:
    503-573``), plain PyTorch as the JAX package computes it outside any
    kernel.  Per branch: an affine-free LayerNorm (eps 1e-5) of the batch
    rows and the warm-up-scaled codewords, the branch's ``transformer_k``,
    a ones column appended; logits C = <x_B, x_M> / sqrt(D + 1), then
    exp(C / c_max) with c_max the largest squared row norm over the valid
    batch rows and the branch's codewords (a guard, not a softmax's max
    subtraction); the batch rows attend to the codewords (out_B, the hook
    point ``probe_tr`` added before the ones-column division) and the
    codewords to the valid batch rows (out_M, for the recovery term
    sum(out_M * gbar) * warm_up_rate).  A dropped branch has no output and
    no recovery.

    On a row shard (``parallel/sharded.py``) x and the batch are the rank's
    rows and the codewords are replicated; its edges carry ``tr_ranks``
    (None where the rows have one rank), over which c_max is the max of
    every rank's valid rows (:func:`transformer_cmax`) and out_M's
    normaliser, a sum over the rows [nb, 1, M], is summed in a
    differentiable all-reduce (its backward an all-reduce of the
    cotangent); out_B's softmax over the codewords is row-local.  Each rank's
    out_M, and so its recovery term, is its rows' part, and their sum over
    the ranks is the whole batch's.

    Returns (x_out_tr [B_pad, nb * D], info_backward)."""
    B_pad, D = batch.B_pad, ms.num_D
    nb = x.shape[1] // D
    xb = x.reshape(B_pad, nb, D).permute(1, 0, 2)  # [nb, B_pad, D]
    xbar = vq_tr.embedding_output[:, :, :D].detach() * warm_up_rate
    gbar = vq_tr.embedding_output[:, :, D:].detach()  # [nb, M, D + 1]
    x_in = torch.cat([xb, xbar], dim=1)  # [nb, B_pad + M, D]
    mu = x_in.mean(2, keepdim=True)
    var = ((x_in - mu) ** 2).mean(2, keepdim=True)
    x_in = (x_in - mu) * torch.rsqrt(var + 1e-5)
    tk = layer.transformer_k
    x_in = torch.bmm(x_in, tk.w) + tk.b[:, None, :]
    # [nb, B_pad + M, D + 1]: the ones column after transformer_k
    x_in = torch.cat([x_in, x_in.new_ones(x_in.shape[:2] + (1,))], dim=2)
    xB, xM = x_in[:, :B_pad], x_in[:, B_pad:]
    C = torch.bmm(xB, xM.transpose(1, 2)) / math.sqrt(D + 1)  # [nb, B_pad, M]
    valid = batch.valid_B
    ranks = getattr(batch.edges, "tr_ranks", None)  # a row shard's, bound to its ranks
    c_max = transformer_cmax((xB * xB).sum(2), (xM * xM).sum(2), valid, ranks)[:, None, None]
    C = torch.exp(C / c_max)
    out_B = torch.bmm(C / C.sum(2, keepdim=True), xM)  # [nb, B_pad, D + 1]
    Cm = C * valid.to(C.dtype)[None, :, None]
    norm = Cm.sum(1, keepdim=True)  # [nb, 1, M]
    if ranks is not None:
        norm = ranks.psum(norm)
    out_M = torch.bmm((Cm / norm.clamp_min(1e-30)).transpose(1, 2), xB)
    if probe_tr is not None:
        out_B = out_B + probe_tr
    if branch_keep is not None:
        out_M = out_M * branch_keep.to(out_M.dtype)[:, None, None]
    info_backward = (out_M * gbar * warm_up_rate).sum()
    # ones-column normalisation (v1/models.py:209-210)
    out_B_n = out_B[:, :, :D] / (out_B[:, :, D:] + 1e-16)
    if branch_keep is not None:
        out_B_n = out_B_n * branch_keep.to(out_B_n.dtype)[:, None, None]
    return out_B_n.permute(1, 0, 2).reshape(B_pad, nb * D), info_backward


def layer_forward_bm(
    layer: nn.Module,
    vq_state: VQState,
    ms: ModelStatic,
    x: torch.Tensor,  # [B_pad, C_in]
    batch: PaddedBatch,
    probe: Optional[torch.Tensor],  # [B_pad, C_in], or [nb, B_pad, D + 1] for GAT
    warm_up_rate,
    branch_keep: Optional[torch.Tensor] = None,  # [nb] bool, the dropbranch mask
    vq_tr: Optional[VQState] = None,
    probe_tr: Optional[torch.Tensor] = None,
    fan_in_reduce=None,
):
    """One v1 LowRankGNNLayer (``vq_gnn_v1/models.py:143-233, 307-367``;
    ``vq_gnn_tpu/nn/model.py:576-800``).

    The batch builder already lowered the mapper's (B+M)^2 matrix to per-edge
    lists (``bm_subgraph``).  The codebook features are scaled by
    warm_up_rate; GAT runs one attention head per branch with its own
    parameters (``gat_conv_ell_mh``); info_backward uses the per-codeword
    identity sum_m out_M[m] * g[m] == sum_j out_fo[j] * g[c[j]], or, for the
    non-GCN convs in training, the exact reverse term over the rev-ELL.
    Under bf16 or f16 compute only the GAT conv streams 16-bit rows: its
    x_input is cast after the branch logits
    (``vq_gnn_tpu/nn/model.py:682-684``); the lookup,
    the GCN and SAGE convs and the transformer branch stay f32.  A dropped
    branch (``branch_keep`` False) contributes no codebook features, no
    recovery term and a zeroed slice of the conv output.  With
    ``transformer_flag`` the transformer branch (over ``vq_tr``, its hook
    point ``probe_tr``) adds to the output and to info_backward.

    On a row shard (``parallel/sharded.py``) the batch is the rank's rows
    (its B_pad, Bp_pad, reverse list and ``fo_ids``), the GCN and SAGE convs
    exchange rows through ``spmm``, and the GAT conv takes the shard's
    hooks, on the slot-ELL and on COO (:func:`_gat_bm_coo`):
    ``scale_ranks`` for the per-branch Trick-1 max over every rank's rows,
    ``gat_mh`` for the conv; the transformer branch takes ``tr_ranks``
    (:func:`transformer_branch`); each recovery term covers the rank's own
    rows, and its sum over the ranks is the whole batch's.
    ``fan_in_reduce`` as :func:`layer_forward` takes it (the 2-D mesh).

    Returns (x_out [B_pad, C_out], info_backward scalar)."""
    B_pad, Bp_pad = batch.B_pad, batch.Bp_pad
    D = ms.num_D
    nb = x.shape[1] // D
    x_fo, grad_fo = lookup(vq_state, batch.fo_ids, ms.vq)
    fo_mask = batch.valid_fo.to(x.dtype)[:, None]
    x_fo = x_fo * fo_mask * warm_up_rate
    grad_fo = (grad_fo * fo_mask).detach()  # [Bp_pad, nb * Dg]
    if branch_keep is not None:
        x_fo = x_fo * _keep_cols(branch_keep, D, x_fo.dtype)
        grad_fo = grad_fo * _keep_cols(branch_keep, ms.vq.grad_dim, grad_fo.dtype)
    x_input = torch.cat([x, x_fo], dim=0).contiguous()  # [dim_pad, nb * D]
    rev = batch.rev_slot_row is not None or batch.bm_rev_row is not None
    x_tr = None
    info_tr = 0.0
    if ms.transformer_flag:
        x_tr, info_tr = transformer_branch(layer, vq_tr, ms, x, batch, probe_tr, warm_up_rate,
                                           branch_keep=branch_keep)

    if ms.conv_type != "GAT":
        # rows >= B_pad are codebook lookups: the spmm backward stops at
        # b_rows (the batch builder's truncation bound)
        x_out = spmm(batch.edges, x_input)
        out_B = x_out[:B_pad]
        if probe is not None:
            out_B = out_B + probe
        if rev:
            x_cols = x.reshape(B_pad, nb, D).permute(1, 0, 2)
            info_backward = _bm_exact_reverse_info(vq_state, ms, batch, x_cols, warm_up_rate,
                                                   branch_keep=branch_keep)
        else:
            info_backward = (x_out[B_pad:] * grad_fo * warm_up_rate).sum()
        if branch_keep is not None:
            out_B = out_B * _keep_cols(branch_keep, D, out_B.dtype)
        return (_layer_output(layer, ms, x, out_B, x_tr, fan_in_reduce=fan_in_reduce),
                info_backward + info_tr)

    # Trick-1 logits per branch over the valid batch rows and the whole
    # codebook (the v1 conv takes the max over its B + M input, convs.py:209)
    M = ms.vq.num_M
    cb = torch.cat([vq_state.embedding_output[:, :, :D] * warm_up_rate,
                    x.new_ones((nb, M, 1))], dim=2)  # [nb, M, D + 1]
    al_cb = (cb * layer.att_l[:, None, :]).sum(-1)  # [nb, M]
    ar_cb = (cb * layer.att_r[:, None, :]).sum(-1)
    if batch.edges.ell_row is None:
        x_out_B, info_backward = _gat_bm_coo(layer, vq_state, ms, x, x_fo, grad_fo, batch,
                                             probe, warm_up_rate, al_cb, ar_cb, branch_keep)
        return (_layer_output(layer, ms, x, x_out_B, x_tr, fan_in_reduce=fan_in_reduce),
                info_backward + info_tr)
    e = batch.edges
    al_n = _branch_logits(x_input, layer.att_l, D)  # [dim_pad, nb]
    ar_n = _branch_logits(x_input, layer.att_r, D)
    scale_n = branch_scale(al_n[:B_pad], ar_n[:B_pad], al_cb, ar_cb, batch.valid_B,
                           getattr(e, "scale_ranks", None))  # [nb]
    al_n, ar_n = al_n / scale_n, ar_n / scale_n
    cd = stream_dtype(ms.compute_dtype, x_input.dtype)
    if x_input.dtype != cd:  # 16-bit streaming halves the gathered bytes
        x_input = x_input.to(cd)
    if getattr(e, "gat_mh", None) is not None:  # a row shard's, bound to its ranks
        agg, rs = e.gat_mh(x_input, al_n, ar_n)
    else:
        agg, rs = gat_conv_ell_mh(e, x_input, al_n, ar_n)
    agg_B, rs_B = agg[:B_pad], rs[:B_pad]
    if probe is not None:  # [nb, B_pad, D + 1], the ones column last
        agg_B = agg_B + probe[:, :, :D].permute(1, 0, 2).reshape(B_pad, nb * D)
        rs_B = rs_B + probe[:, :, D].t()
    if rev:
        x_br = torch.cat([x.reshape(B_pad, nb, D).permute(1, 0, 2),
                          x.new_ones((nb, B_pad, 1))], dim=2)  # [nb, B_pad, D + 1]
        info_backward = _bm_exact_reverse_info(
            vq_state, ms, batch, x_br, warm_up_rate, al=al_n[:B_pad].t(),
            ar_cb=ar_cb / scale_n[:, None], branch_keep=branch_keep,
        )
    else:
        gfo = grad_fo.reshape(Bp_pad, nb, D + 1)
        info_backward = ((agg[B_pad:].reshape(Bp_pad, nb, D) * gfo[:, :, :D]).sum()
                         + (rs[B_pad:] * gfo[:, :, D]).sum()) * warm_up_rate
    # ones-column normalisation of the batch rows (v1/models.py:209-210)
    out_B = agg_B / (rs_B.repeat_interleave(D, dim=1) + 1e-16)
    if branch_keep is not None:
        out_B = out_B * _keep_cols(branch_keep, D, out_B.dtype)
    return (_layer_output(layer, ms, x, out_B, x_tr, fan_in_reduce=fan_in_reduce),
            info_backward + info_tr)


def _gat_bm_coo(layer, vq_state: VQState, ms: ModelStatic, x, x_fo, grad_fo,
                batch: PaddedBatch, probe, warm_up_rate, al_cb, ar_cb, branch_keep):
    """The B + M GAT conv over a COO adjacency, the JAX package's fallback
    (``vq_gnn_tpu/nn/model.py:728-780``), f32: per branch the input with its
    ones column [nb, dim, D + 1], the branch's logits and Trick-1 scale from
    the valid batch rows and the codebook logits (``ops/gat.py:
    branch_scale``), the per-edge values, and a COO spmm per branch (one
    kernel-8 sum over all branches, ``spmm_branches``); the probe adds to
    the batch rows before the ones-column division.

    On a row shard (``parallel/sharded.py``) the scale's max is over every
    rank's valid rows (the edges' ``scale_ranks``) and the edges' ``gat_mh``
    takes the place of the values and the sum: (x_br, al, ar) of the owned
    rows -> their [nb, R, D + 1] aggregate over every rank's rows; the
    recovery term's grid path runs over the rank's raw reverse entries.
    Returns (out_B [B_pad, nb * D], info_backward)."""
    B_pad, Bp_pad, D = batch.B_pad, batch.Bp_pad, ms.num_D
    nb = x.shape[1] // D
    xb = x.reshape(B_pad, nb, D).permute(1, 0, 2)
    xfo_b = x_fo.reshape(Bp_pad, nb, D).permute(1, 0, 2)
    x_br = torch.cat([torch.cat([xb, xfo_b], dim=1),
                      x.new_ones((nb, B_pad + Bp_pad, 1))], dim=2)  # [nb, dim, D + 1]
    al = (x_br * layer.att_l[:, None, :]).sum(-1)  # [nb, dim]
    ar = (x_br * layer.att_r[:, None, :]).sum(-1)
    e = batch.edges
    scale = branch_scale(al[:, :B_pad].t(), ar[:, :B_pad].t(), al_cb, ar_cb, batch.valid_B,
                         getattr(e, "scale_ranks", None))[:, None]  # [nb, 1]
    al, ar = al / scale, ar / scale
    if getattr(e, "gat_mh", None) is not None:  # a row shard's, bound to its ranks
        x_out = e.gat_mh(x_br, al, ar)
    else:
        ev = gat_edge_values(e.row, e.col, e.val, al, ar, edges=e)  # [nb, E_pad]
        x_out = spmm_branches(e, ev, x_br)  # [nb, dim, D + 1]
    out_B = x_out[:, :B_pad]
    if probe is not None:  # [nb, B_pad, D + 1]
        out_B = out_B + probe
    if batch.bm_rev_row is not None:  # exact non-GCN recovery reverse
        info_backward = _bm_exact_reverse_info(
            vq_state, ms, batch, x_br[:, :B_pad], warm_up_rate, al=al[:, :B_pad],
            ar_cb=ar_cb / scale, branch_keep=branch_keep)
    else:
        gfo = grad_fo.reshape(Bp_pad, nb, D + 1).permute(1, 0, 2)
        info_backward = (x_out[:, B_pad:] * gfo * warm_up_rate).sum()
    # ones-column normalisation of the batch rows (v1/models.py:209-210)
    out_B = out_B[:, :, :D] / (out_B[:, :, D:] + 1e-16)
    if branch_keep is not None:
        out_B = out_B * branch_keep.to(out_B.dtype)[:, None, None]
    return out_B.permute(1, 0, 2).reshape(B_pad, nb * D), info_backward


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
    vq_states_tr: Optional[List[VQState]] = None,
    probes_tr: Optional[List[torch.Tensor]] = None,
    branch_masks: Optional[List[torch.Tensor]] = None,
    dropout_keeps: Optional[List[torch.Tensor]] = None,
    num_layers_to_run: Optional[int] = None,
    with_bn_act: bool = True,
    stats_reduce=None,
    model_axis=None,
):
    """Full LowRankGNN forward (``models.py v2:308-348``).

    ``vq_states_tr`` and ``probes_tr``: the transformer branch's codebooks and
    hook points per layer; ``branch_masks``: the dropbranch keep mask [nb]
    per layer; ``dropout_keeps``: the (alpha) dropout keep mask per hidden
    layer, drawn from ``generator`` where not given.  ``num_layers_to_run``
    and ``with_bn_act=False`` are the init bootstrap's partial forward
    (``models.py v2:370-374``): the first layers only, each hidden layer
    followed by its activation alone (no BN, no dropout).

    A batch sharded over ranks (``parallel/sharded.py``) passes
    ``stats_reduce``, which sums the inter-layer BN's moment sums over the
    ranks of the rows, and on the 2-D mesh ``model_axis``: its ``split(x)``
    gives each layer the columns of this rank's branches (the layer inputs
    returned are those), its ``reduce`` is the layers' ``fan_in_reduce``.

    Returns (out [B_pad, C_out], info_backward, layer_inputs, new_bn_state)."""
    x = x_B
    layer_inputs = []
    info_total = 0.0
    new_means, new_vars = list(bn_state.mean), list(bn_state.var)
    drop = alpha_dropout if ms.alpha_dropout_flag else dropout
    L = ms.num_layers if num_layers_to_run is None else num_layers_to_run
    for l in range(L):
        if model_axis is not None:
            x = model_axis.split(x)
        layer_inputs.append(x)
        probe = probes[l] if probes is not None else None
        x, info_b = layer_forward(
            model.layers[l], vq_states[l], ms, x, batch, probe, warm_up_rate,
            branch_keep=None if branch_masks is None else branch_masks[l],
            vq_tr=None if vq_states_tr is None else vq_states_tr[l],
            probe_tr=probes_tr[l] if probes_tr else None,
            fan_in_reduce=None if model_axis is None else model_axis.reduce,
        )
        info_total = info_total + info_b
        if l < ms.num_layers - 1 and not with_bn_act:
            x = activation(x, ms.act)
        elif l < ms.num_layers - 1:
            if ms.bn_flag:
                if training:
                    x, new_means[l], new_vars[l] = batchnorm_train(
                        x, bn_state.mean[l], bn_state.var[l], batch.valid_B,
                        stats_reduce=stats_reduce,
                    )
                else:
                    x = batchnorm_infer(x, bn_state.mean[l], bn_state.var[l])
            x = activation(x, ms.act)
            if ms.dropout > 0 and training:
                x = drop(x, ms.dropout, training, generator,
                         keep=None if dropout_keeps is None else dropout_keeps[l])
    return x, info_total, layer_inputs, BNState(mean=new_means, var=new_vars)


def probe_shapes(ms: ModelStatic, B_pad: int) -> List[Tuple[int, ...]]:
    """Conv-output shapes per layer: [B_pad, C_in] (+1 for the GAT ones
    column); the B + M GAT runs one conv per branch: [nb, B_pad, D + 1]."""
    if ms.formulation == "bm" and ms.conv_type == "GAT":
        return [(nb, B_pad, ms.num_D + 1) for nb in ms.num_branches]
    extra = 1 if ms.conv_type == "GAT" else 0
    return [(B_pad, ms.channels[l] + extra) for l in range(ms.num_layers)]


def zero_probes(ms: ModelStatic, B_pad: int, device, dtype=torch.float32
                ) -> List[torch.Tensor]:
    """The conv outputs' hook points (:func:`probe_shapes`), f32 (float64
    where the step runs in float64: their gradients are the VQ update's)."""
    return [torch.zeros(s, device=device, dtype=dtype, requires_grad=True)
            for s in probe_shapes(ms, B_pad)]


def zero_probes_tr(ms: ModelStatic, B_pad: int, device, dtype=torch.float32
                   ) -> List[torch.Tensor]:
    """The transformer branch's hook points: [nb, B_pad, D + 1] per layer."""
    return [torch.zeros((nb, B_pad, ms.num_D + 1), device=device, dtype=dtype,
                        requires_grad=True) for nb in ms.num_branches]


# --------------------------------------------------------------------------
# exact full-graph inference (no VQ), v1 semantics (v1/models.py:486-504)
# --------------------------------------------------------------------------
@torch.no_grad()
def full_graph_inference(model: LowRankGNN, bn_state: BNState, ms: ModelStatic, x, edges):
    """Plain conv stack with the learned weights, codebooks bypassed
    (``vq_gnn_tpu/nn/model.py:909-926``).  As there: ``fc_sage`` is not
    applied, BN runs in eval mode, and GAT is the plain SpMM (the reference's
    inference() ignores attention).  ``edges``: the whole graph's COO edges
    (``ops/spmm.make_edges``), forward only."""
    for l in range(ms.num_layers):
        layer = model.layers[l]
        h = spmm(edges, x)
        h = F.linear(h, layer.gnn_transform.weight, layer.gnn_transform.bias)
        if ms.skip:
            h = h + F.linear(x, layer.linear_skip.weight, layer.linear_skip.bias)
        x = h
        if l < ms.num_layers - 1:
            if ms.bn_flag:
                x = batchnorm_infer(x, bn_state.mean[l], bn_state.var[l])
            x = activation(x, ms.act)
    return x
