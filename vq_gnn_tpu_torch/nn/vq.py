"""EMA vector-quantizer state and transitions — the VQ core (port of
``vq_gnn_tpu/nn/vq.py``; reference ``VectorQuantizerEMA``,
``vq_gnn_v2/vq.py:60-279``).

Per GNN layer there are ``nb`` independent codebooks (one per ``num_D``-wide
feature slice); every per-branch tensor carries a leading branch axis (the
JAX package's ``vmap``, written out).

State layout (K = 2*D, +1 with ``add_flag``: the B + M GAT layers also
quantize the gradient of the ones column, ``vq_gnn_v1/models.py:53``):

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

import numpy as np
import torch

from vq_gnn_tpu_torch.config import sum_dtype
from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches, lookup_codewords
from vq_gnn_tpu_torch.ops.vq_ops import (
    assign_stats_scan,
    assignment_stats,
    masked_moments,
    nearest_codeword,
)

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
    add_flag: bool = False  # quantize one extra (ones-column) grad dim
    # 'pallas'/'pallas_fast': CUDA kernels (plain versions on CPU tensors);
    # 'xla'/'xla_fast': plain PyTorch (ops/vq_ops.py); 'scan': the plain
    # assignment over row chunks (ops/vq_ops.assign_stats_scan)
    backend: str = "xla"

    @property
    def grad_dim(self) -> int:
        return self.num_D + (1 if self.add_flag else 0)

    @property
    def total_dim(self) -> int:
        return 2 * self.num_D + (1 if self.add_flag else 0)


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
    gscale = _grad_half(K, D, p.grad_scale[0], p.grad_scale[1], p.add_flag)
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


def _grad_half(K: int, D: int, v0: float, v1: float, add_flag: bool, device=None,
               dtype=torch.float32):
    """[K] ones with v0 on the gradient half [D, 2D) and, with add_flag, v1
    on the ones-column gradient at index 2D.  Filled on ``device``: a copy
    from the host would synchronise the stream."""
    t = torch.ones(K, device=device, dtype=dtype)
    t[D : 2 * D] = v0
    if add_flag:
        t[2 * D] = v1
    return t


def _bn_apply(x, moments, r_mean, r_var, eps, momentum):
    """BatchNorm1d(affine=False) in train mode over rows of [nb, B, D]:
    normalize by the biased batch stats, EMA the running stats toward the
    unbiased batch var."""
    b_mean, b_var, b_var_u = moments
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
    if p.backend == "scan":  # plain PyTorch, as the JAX package's XLA scan
        return assign_stats_scan(xn, emb, valid)
    if p.backend not in ("xla", "xla_fast"):
        raise ValueError(f"unknown vq_backend {p.backend!r}")
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
    training: bool = True,
) -> Tuple[VQState, torch.Tensor]:
    """Feature-half codebook update (``vq.py:160-202``): BN-normalize the
    input slice, assign to the nearest feature-half codeword, EMA the feature
    half only, and refresh the de-normalized feature half of the output
    table.  Used by the layerwise init bootstrap.  With ``training=False``
    only the assignment: the state (``c_indices`` too) is returned as it
    came, with ``idx [nb, B]`` (the inductive eval, ``eval_assign_step``)."""
    D = p.num_D
    xn, new_mean, new_var = _bn_apply(
        X_B, masked_moments([X_B], valid)[0], state.bn_feat_mean, state.bn_feat_var, BN_FEAT_EPS,
        BN_FEAT_MOMENTUM,
    )
    idx, counts, sums = _assign_and_stats(xn, state.embedding[:, :, :D], valid, p)
    if not training:
        return state, idx
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
    branch_keep: Optional[torch.Tensor] = None,  # [nb] bool, the dropbranch mask
    stats_reduce=None,  # data-parallel: sums a list of tensors over the ranks
    cidx_merge_fn=None,  # data-parallel: writes every rank's rows of c_indices
) -> Tuple[VQState, torch.Tensor]:
    """Joint feature+gradient codebook update (``vq.py:204-279``) — the body
    of the reference's backward hook: BN-normalize [X_B || grad] (seeding the
    running stats from the first batch, vq.py:216-221), scale the grad half,
    assign, EMA k-means, then store a de-normalized copy for lookups.

    ``branch_keep`` is dropbranch (``vq_gnn_tpu/nn/vq.py:322-340``): a
    dropped branch's hook never fires, so every per-branch tensor and its
    ``c_indices`` column keep their values, and its ``bad_init`` does not
    count.  The shared ``bn_inited`` still flips, as in the JAX package (a
    documented deviation there).

    The two hooks make one transition of all data-parallel ranks' rows
    (``parallel/multihost.py``): ``stats_reduce`` sums the BN moments' sums
    and the assignment counts and sums over the ranks before any divide,
    and ``cidx_merge_fn(c_indices, batch_idx, idx)`` writes the [nb, B]
    assignments of every rank in place of ``c_indices[batch_idx] = idx.T``
    (the JAX ``cidx_merge_fn``).  Unset, the update is this batch's alone."""
    D = p.num_D
    gs0 = p.grad_scale[0]
    mf, mg = masked_moments([X_B, grad], valid, stats_reduce)

    def seed(moments, r_mean, r_var):
        return (
            torch.where(state.bn_inited, r_mean, moments[0]),
            torch.where(state.bn_inited, r_var, moments[2]),
        )

    f_mean, f_var = seed(mf, state.bn_feat_mean, state.bn_feat_var)
    g_mean, g_var = seed(mg, state.bn_grad_mean, state.bn_grad_var)
    xn_f, f_mean, f_var = _bn_apply(X_B, mf, f_mean, f_var, BN_FEAT_EPS, BN_FEAT_MOMENTUM)
    xn_g, g_mean, g_var = _bn_apply(grad, mg, g_mean, g_var, p.epsilon, p.momentum)
    gs1 = p.grad_scale[1]
    xn = torch.cat([xn_f, xn_g], dim=2)
    xn = xn * _grad_half(p.total_dim, D, gs0, gs1, p.add_flag, X_B.device, xn.dtype)

    idx, counts, sums = _assign_and_stats(xn, state.embedding, valid, p)
    if stats_reduce is not None:  # the psum before the EMA divide
        counts, sums = stats_reduce([counts, sums])

    new_size = _ema_counts(state.ema_cluster_size, counts, p)
    bad = (new_size == 0).any()
    new_ema_w = state.ema_w * p.decay + (1.0 - p.decay) * sums
    new_emb = new_ema_w / new_size[:, :, None]
    # de-normalize for the lookup table (vq.py:261-272): undo grad_scale on
    # the grad half, then BN with the (post-update) running stats
    out = new_emb / _grad_half(
        p.total_dim, D, gs0 + p.epsilon, gs1 + p.epsilon, p.add_flag, X_B.device, new_emb.dtype)
    run_var = torch.cat([f_var + BN_FEAT_EPS, g_var + p.epsilon], dim=1)
    run_mean = torch.cat([f_mean, g_mean], dim=1)
    out = out * torch.sqrt(run_var)[:, None, :] + run_mean[:, None, :]
    if gs0 == 0:  # vq.py:274-275
        out[:, :, D:] = 0.0
    new = dict(embedding=new_emb, embedding_output=out, ema_cluster_size=new_size,
               ema_w=new_ema_w, bn_feat_mean=f_mean, bn_feat_var=f_var, bn_grad_mean=g_mean,
               bn_grad_var=g_var)
    idx_w = idx
    if branch_keep is not None:
        for k, v in new.items():
            old = getattr(state, k)
            new[k] = torch.where(branch_keep.reshape((-1,) + (1,) * (v.dim() - 1)), v, old)
        bad = ((new_size == 0).any(-1) & branch_keep).any()
        ids = batch_idx.clamp(0, state.c_indices.shape[0] - 1)
        idx_w = torch.where(branch_keep[:, None], idx,
                            state.c_indices.index_select(0, ids).t().to(idx.dtype))
    (cidx_merge_fn or _write_rows)(state.c_indices, batch_idx, idx_w)
    return (
        dataclasses.replace(
            state,
            **new,
            bn_inited=torch.ones_like(state.bn_inited),
            bad_init=state.bad_init | bad,
        ),
        idx,
    )


def lookup(state: VQState, node_ids: torch.Tensor, p: VQParams, stream=None):
    """Codebook lookup for out-of-batch nodes (``models.py v2:168-173``).

    node_ids [n] -> (features [n, nb*D], grads [n, nb*Dg]) in branch-slice
    order (branch i covers columns i*D:(i+1)*D), f32.

    ``stream`` (a dtype, bf16 under bf16 compute) rounds the selected
    codewords to it, as the JAX package's one-hot einsum at that dtype does
    (``vq_gnn_tpu/nn/vq.py:433-484``); on the 'pallas' backends it forces
    the kernel's fast mode even on the exact 'pallas', as there.  'scan'
    reads the table through the kernel too, in its exact mode: the same
    values as the row gather (the JAX package's one-hot einsum at 'highest'),
    which the other plain backends keep."""
    if p.backend in ("pallas", "pallas_fast", "scan"):
        # the kernel writes both halves where the step reads them
        return lookup_codewords(
            state.c_indices, node_ids, state.embedding_output,
            fast=p.backend == "pallas_fast" or stream is not None, split=p.num_D,
        )
    # exact row gather == the JAX one-hot einsum at 'highest'
    ids = node_ids.clamp(0, state.c_indices.shape[0] - 1)
    c = state.c_indices.index_select(0, ids).long()
    nb = c.shape[1]
    table = state.embedding_output[torch.arange(nb, device=c.device)[None, :], c]
    if stream is not None:
        table = table.to(stream).to(sum_dtype(table.dtype))
    n = table.shape[0]
    feats = table[:, :, : p.num_D].reshape(n, nb * p.num_D)
    grads = table[:, :, p.num_D :].reshape(n, nb * p.grad_dim)
    return feats, grads


def feature_kmeans_init(state: VQState, X_B, batch_idx, p: VQParams) -> VQState:
    """MiniBatchKMeans seeding of the feature half (reference
    ``--kmeans-init``, ``v1/models.py:147-159`` + ``vq.py:102-105``; port of
    ``vq_gnn_tpu/nn/vq.py:373-411``): per branch, k-means++ on the
    batch-normalized features [B, D] of ``X_B`` [nb, B, D]; the centroids
    seed the feature half of ``embedding``, centroids times counts that of
    ``ema_w``, the counts ``ema_cluster_size``, and the labels the rows
    ``batch_idx`` [B] of ``c_indices``.  On the host, with scikit-learn, whose
    draws come from numpy's global RNG (no ``random_state``, as in the JAX
    package).  Returns the new state on the state's device."""
    try:
        from sklearn.cluster import MiniBatchKMeans
    except ImportError as e:
        raise ImportError(
            "kmeans_init needs scikit-learn (sklearn.cluster.MiniBatchKMeans), which "
            "cannot be imported here") from e
    X, ids = X_B.detach().cpu().numpy(), batch_idx.cpu().numpy()
    emb, ema_w, size, c_idx = (getattr(state, k).cpu().numpy().copy()
                               for k in ("embedding", "ema_w", "ema_cluster_size", "c_indices"))
    for b in range(X.shape[0]):
        xb = X[b]
        xn = (xb - xb.mean(0)) / np.sqrt(xb.var(0) + 1e-5)
        km = MiniBatchKMeans(n_clusters=p.num_M, init="k-means++", batch_size=400, n_init=10,
                             init_size=4000, reassignment_ratio=0.3).fit(xn)
        cent = km.cluster_centers_.astype(np.float32)
        counts = np.bincount(km.labels_, minlength=p.num_M).astype(np.float32)
        emb[b, :, : p.num_D] = cent
        size[b] = counts
        ema_w[b, :, : p.num_D] = cent * counts[:, None]
        c_idx[ids, b] = km.labels_.astype(np.int16)
    dev = state.embedding.device
    return dataclasses.replace(
        state, embedding=torch.as_tensor(emb).to(dev), ema_w=torch.as_tensor(ema_w).to(dev),
        ema_cluster_size=torch.as_tensor(size).to(dev), c_indices=torch.as_tensor(c_idx).to(dev))


def ste_vector_quantizer(inputs: torch.Tensor, embedding: torch.Tensor,
                         commitment_cost: float = 0.5, holistic_cost: float = 0.1):
    """The legacy straight-through-estimator VQ (reference VectorQuantizer,
    ``vq.py:10-57``, constructed but unused there; port of
    ``vq_gnn_tpu/nn/vq.py:414-432``): inputs [B, K], embedding [M, K].
    Returns (loss, quantized with the straight-through gradient, the one-hot
    encodings [B, M], the indices [B])."""
    idx = nearest_codeword(inputs.detach()[None], embedding.detach()[None])[0]
    quantized = embedding.index_select(0, idx)
    e_latent = ((quantized.detach() - inputs) ** 2).mean()
    q_latent = ((quantized - inputs.detach()) ** 2).mean()
    loss = holistic_cost * (q_latent + commitment_cost * e_latent)
    st = inputs + (quantized - inputs).detach()
    onehot = torch.nn.functional.one_hot(idx, embedding.shape[0]).to(inputs.dtype)
    return loss, st, onehot, idx
