"""EMA vector-quantizer state and transitions — the VQ core (port of
``vq_gnn_tpu/nn/vq.py``; reference ``VectorQuantizerEMA``,
``vq_gnn_v2/vq.py:60-279``).

Per GNN layer there are ``nb`` independent codebooks (one per ``num_D``-wide
feature slice); every per-branch tensor carries a leading branch axis (the
JAX package's ``vmap``, written out).

State layout (K = 2*D; the v1 ones-column dimension, ``add_flag``, comes
with the B + M formulation):

- ``embedding [nb, M, K]``        codebook in normalized space
- ``embedding_output [nb, M, K]`` de-normalized copy used for lookups
- ``ema_cluster_size [nb, M]``, ``ema_w [nb, M, K]``  EMA accumulators
- ``bn_feat_* [nb, D]``, ``bn_grad_* [nb, Dg]``       BatchNorm running stats
- ``c_indices [N+1, nb]`` int16, node-major; row N is the dustbin of padded
  batch slots
- ``bn_inited``, ``bad_init``     bool scalars (``bad_init`` replaces the
  reference's 'Bad Init!' raise; the trainer checks it)

The transitions return a new :class:`VQState`, except ``c_indices``, which
they update in place: it is the one large tensor ([N+1, nb] int16, 10.8 MB at
N = 169k, nb = 32) and nothing reads its old value after the update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from vq_gnn_tpu_torch.config import not_ported
from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches, lookup_codewords
from vq_gnn_tpu_torch.ops.vq_ops import assignment_stats, masked_mean_var, nearest_codeword

BN_FEAT_EPS = 1e-5  # torch BatchNorm1d default (vq.py:86)
BN_FEAT_MOMENTUM = 0.1
LAPLACE_EPS = 1e-5  # vq.py:184-186, 249-251


@dataclasses.dataclass(frozen=True)
class VQParams:
    """Static VQ hyperparameters (constructor args of VectorQuantizerEMA)."""

    num_M: int
    num_D: int
    decay: float = 0.99
    epsilon: float = 1e-24
    grad_scale: Tuple[float, float] = (1.0, 1.0)
    warm_up_flag: bool = False  # Laplace smoothing of cluster sizes
    momentum: float = 0.1  # grad-BN running-stat momentum (vq.py:87-88)
    # 'pallas'/'pallas_fast': CUDA kernels (plain versions on CPU tensors);
    # 'xla'/'xla_fast': plain PyTorch (ops/vq_ops.py)
    backend: str = "xla"

    @property
    def grad_dim(self) -> int:
        return self.num_D

    @property
    def total_dim(self) -> int:
        return 2 * self.num_D


@dataclasses.dataclass
class VQState:
    embedding: torch.Tensor
    embedding_output: torch.Tensor
    ema_cluster_size: torch.Tensor
    ema_w: torch.Tensor
    bn_feat_mean: torch.Tensor
    bn_feat_var: torch.Tensor
    bn_grad_mean: torch.Tensor
    bn_grad_var: torch.Tensor
    c_indices: torch.Tensor
    bn_inited: torch.Tensor  # bool scalar
    bad_init: torch.Tensor  # bool scalar


def init_vq_state(
    generator: torch.Generator, num_branch: int, num_N: int, p: VQParams,
    device: torch.device,
) -> VQState:
    """Mirror of the reference buffer init (``vq.py:73-99``, ``models.py
    v2:27``): normal codebook and EMA weights, uniform random ``c_indices``.
    Draws on the generator's device (the CPU), then moves to ``device``."""
    M, D, K = p.num_M, p.num_D, p.total_dim
    emb = torch.randn((num_branch, M, K), generator=generator)
    ema_w = (
        torch.randn((num_branch, M, K), generator=generator)
        if p.warm_up_flag
        else torch.zeros((num_branch, M, K))
    )
    gscale = torch.ones(K)
    gscale[D:] = p.grad_scale[0]
    c = torch.randint(0, M, (num_N + 1, num_branch), generator=generator)
    st = VQState(
        embedding=emb * gscale,
        embedding_output=torch.zeros((num_branch, M, K)),
        ema_cluster_size=torch.zeros((num_branch, M)),
        ema_w=ema_w * gscale,
        bn_feat_mean=torch.zeros((num_branch, D)),
        bn_feat_var=torch.ones((num_branch, D)),
        bn_grad_mean=torch.zeros((num_branch, p.grad_dim)),
        bn_grad_var=torch.ones((num_branch, p.grad_dim)),
        c_indices=c.to(torch.int16),
        bn_inited=torch.tensor(False),
        bad_init=torch.tensor(False),
    )
    return VQState(**{f.name: getattr(st, f.name).to(device) for f in dataclasses.fields(st)})


def _bn_train(x, r_mean, r_var, eps, momentum, valid):
    """BatchNorm1d(affine=False) in train mode over rows of [nb, B, D]:
    normalize by masked biased batch stats, EMA the running stats toward the
    unbiased batch var."""
    b_mean, b_var = masked_mean_var(x, valid, ddof=0)
    _, b_var_u = masked_mean_var(x, valid, ddof=1)
    xn = (x - b_mean[:, None, :]) * torch.rsqrt(b_var[:, None, :] + eps)
    new_mean = (1.0 - momentum) * r_mean + momentum * b_mean
    new_var = (1.0 - momentum) * r_var + momentum * b_var_u
    return xn, new_mean, new_var


def _assign_and_stats(xn, emb, valid, p: VQParams):
    """(idx [nb, B], counts [nb, M], sums [nb, M, k]) over the branch axis."""
    if valid is None:
        valid = torch.ones(xn.shape[1], dtype=torch.bool, device=xn.device)
    if p.backend in ("pallas", "pallas_fast"):
        return fused_assign_branches(
            xn.contiguous(), emb.contiguous(), valid.contiguous(),
            fast=p.backend == "pallas_fast",
        )
    if p.backend not in ("xla", "xla_fast"):
        raise not_ported(f"vq_backend={p.backend!r}")
    fast = p.backend == "xla_fast"
    idx = nearest_codeword(xn, emb, fast=fast)
    counts, sums = assignment_stats(xn, idx, p.num_M, valid, fast=fast)
    return idx, counts, sums


def _ema_counts(size, counts, p: VQParams):
    """EMA cluster-size update + optional Laplace smoothing (vq.py:242-251)."""
    size = size * p.decay + (1.0 - p.decay) * counts
    if p.warm_up_flag:
        n = size.sum(-1, keepdim=True)
        size = (size + LAPLACE_EPS) / (n + p.num_M * LAPLACE_EPS) * n
    return size


def _write_rows(c_indices: torch.Tensor, batch_idx: torch.Tensor, idx: torch.Tensor):
    """c_indices[batch_idx, :] = idx.T, in place.  Padded slots all carry the
    dustbin id N, so row N receives one of their rows (unspecified which)."""
    c_indices.index_copy_(0, batch_idx, idx.t().to(torch.int16))


def feature_update(
    state: VQState,
    X_B: torch.Tensor,  # [nb, B, D] per-branch input slices
    batch_idx: torch.Tensor,  # [B] global node ids (padding slots -> N)
    p: VQParams,
    valid: Optional[torch.Tensor] = None,  # [B] bool
) -> Tuple[VQState, torch.Tensor]:
    """Feature-half codebook update (``vq.py:160-202``): BN-normalize the
    input slice, assign to the nearest feature-half codeword, EMA the feature
    half only, and refresh the de-normalized feature half of the output
    table.  Used by the layerwise init bootstrap."""
    D = p.num_D
    xn, new_mean, new_var = _bn_train(
        X_B, state.bn_feat_mean, state.bn_feat_var, BN_FEAT_EPS, BN_FEAT_MOMENTUM, valid
    )
    idx, counts, sums = _assign_and_stats(xn, state.embedding[:, :, :D], valid, p)
    new_size = _ema_counts(state.ema_cluster_size, counts, p)
    bad = (new_size == 0).any()
    new_ema_feat = state.ema_w[:, :, :D] * p.decay + (1.0 - p.decay) * sums
    new_emb_feat = new_ema_feat / new_size[:, :, None]
    run_std = torch.sqrt(new_var + BN_FEAT_EPS)
    new_out_feat = new_emb_feat * run_std[:, None, :] + new_mean[:, None, :]
    emb = torch.cat([new_emb_feat, state.embedding[:, :, D:]], dim=2)
    ema_w = torch.cat([new_ema_feat, state.ema_w[:, :, D:]], dim=2)
    emb_out = torch.cat([new_out_feat, state.embedding_output[:, :, D:]], dim=2)
    _write_rows(state.c_indices, batch_idx, idx)
    return (
        dataclasses.replace(
            state,
            embedding=emb,
            embedding_output=emb_out,
            ema_cluster_size=new_size,
            ema_w=ema_w,
            bn_feat_mean=new_mean,
            bn_feat_var=new_var,
            bad_init=state.bad_init | bad,
        ),
        idx,
    )


def vq_update(
    state: VQState,
    X_B: torch.Tensor,  # [nb, B, D] layer-input slices (detached)
    grad: torch.Tensor,  # [nb, B, Dg] grads of the layer-output slices
    batch_idx: torch.Tensor,  # [B]
    p: VQParams,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[VQState, torch.Tensor]:
    """Joint feature+gradient codebook update (``vq.py:204-279``) — the body
    of the reference's backward hook: BN-normalize [X_B || grad] (seeding the
    running stats from the first batch, vq.py:216-221), scale the grad half,
    assign, EMA k-means, then store a de-normalized copy for lookups."""
    D = p.num_D
    gs0 = p.grad_scale[0]

    def seed(x, r_mean, r_var):
        b_mean, b_var_u = masked_mean_var(x, valid, ddof=1)
        return (
            torch.where(state.bn_inited, r_mean, b_mean),
            torch.where(state.bn_inited, r_var, b_var_u),
        )

    f_mean, f_var = seed(X_B, state.bn_feat_mean, state.bn_feat_var)
    g_mean, g_var = seed(grad, state.bn_grad_mean, state.bn_grad_var)
    xn_f, f_mean, f_var = _bn_train(X_B, f_mean, f_var, BN_FEAT_EPS, BN_FEAT_MOMENTUM, valid)
    xn_g, g_mean, g_var = _bn_train(grad, g_mean, g_var, p.epsilon, p.momentum, valid)
    scale = torch.ones(p.total_dim, device=X_B.device)
    scale[D:] = gs0
    xn = torch.cat([xn_f, xn_g], dim=2) * scale

    idx, counts, sums = _assign_and_stats(xn, state.embedding, valid, p)

    new_size = _ema_counts(state.ema_cluster_size, counts, p)
    bad = (new_size == 0).any()
    new_ema_w = state.ema_w * p.decay + (1.0 - p.decay) * sums
    new_emb = new_ema_w / new_size[:, :, None]
    # de-normalize for the lookup table (vq.py:261-272): undo grad_scale on
    # the grad half, then BN with the (post-update) running stats
    div = torch.ones(p.total_dim, device=X_B.device)
    div[D:] = gs0 + p.epsilon
    out = new_emb / div
    run_var = torch.cat([f_var + BN_FEAT_EPS, g_var + p.epsilon], dim=1)
    run_mean = torch.cat([f_mean, g_mean], dim=1)
    out = out * torch.sqrt(run_var)[:, None, :] + run_mean[:, None, :]
    if gs0 == 0:  # vq.py:274-275
        out[:, :, D:] = 0.0
    _write_rows(state.c_indices, batch_idx, idx)
    return (
        dataclasses.replace(
            state,
            embedding=new_emb,
            embedding_output=out,
            ema_cluster_size=new_size,
            ema_w=new_ema_w,
            bn_feat_mean=f_mean,
            bn_feat_var=f_var,
            bn_grad_mean=g_mean,
            bn_grad_var=g_var,
            bn_inited=torch.ones_like(state.bn_inited),
            bad_init=state.bad_init | bad,
        ),
        idx,
    )


def lookup(state: VQState, node_ids: torch.Tensor, p: VQParams):
    """Codebook lookup for out-of-batch nodes (``models.py v2:168-173``).

    node_ids [n] -> (features [n, nb*D], grads [n, nb*Dg]) in branch-slice
    order (branch i covers columns i*D:(i+1)*D)."""
    if p.backend in ("pallas", "pallas_fast"):
        table = lookup_codewords(
            state.c_indices, node_ids, state.embedding_output,
            fast=p.backend == "pallas_fast",
        )
    else:  # exact row gather == the JAX one-hot einsum at 'highest'
        ids = node_ids.clamp(0, state.c_indices.shape[0] - 1)
        c = state.c_indices.index_select(0, ids).long()
        nb = c.shape[1]
        table = state.embedding_output[torch.arange(nb, device=c.device)[None, :], c]
    n, nb, _ = table.shape
    feats = table[:, :, : p.num_D].reshape(n, nb * p.num_D)
    grads = table[:, :, p.num_D :].reshape(n, nb * p.grad_dim)
    return feats, grads
