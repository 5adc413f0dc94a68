"""The port's kernel modules (plain versions, CPU) against the JAX package's
functions on the same numpy inputs.  Pallas kernels run in interpret mode,
as the JAX package's own tests run them on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.ops.pallas_ell import ell_aggregate_fused
from vq_gnn_tpu.ops.pallas_vq import fused_assign_branches as j_assign
from vq_gnn_tpu.ops.pallas_vq import lookup_branches as j_lookup
from vq_gnn_tpu.ops.spmm import build_ell_host as j_build_ell
from vq_gnn_tpu.ops.spmm import spmm as j_spmm
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate
from vq_gnn_tpu_torch.ops.spmm import build_ell_host, spmm
from vq_gnn_tpu_torch.ops.vq_kernels import (
    fused_assign_branches,
    fused_assign_branches_plain,
    lookup_codewords,
)
from vq_gnn_tpu_torch.sampler import samplers as tsamplers

# f32 sums in another order (segment sums vs index_add_): rtol/atol 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("num_rows,E,K", [(300, 2000, 8), (97, 700, 4)])
def test_ell_plain_matches_pallas(num_rows, E, K):
    rng = np.random.RandomState(0)
    C = 128
    row = np.sort(rng.randint(0, num_rows, E))
    col = rng.randint(0, num_rows, E)
    val = rng.randn(E).astype(np.float32)
    er, ec, ev = build_ell_host(row, col, val, num_rows, K)
    jer, jec, jev = j_build_ell(row, col, val, num_rows, K)
    np.testing.assert_array_equal(er, jer)
    S_pad = ((len(er) + 127) // 128) * 128
    er = np.concatenate([er, np.full(S_pad - len(er), num_rows, np.int32)])
    ec = np.concatenate([ec, np.full((S_pad - len(ec), K), num_rows, np.int32)])
    ev = np.concatenate([ev, np.zeros((S_pad - len(ev), K), np.float32)])
    x = rng.randn(num_rows, C).astype(np.float32)
    nbrs = jnp.take(jnp.asarray(x), jnp.asarray(ec).reshape(-1), axis=0, mode="clip")
    ref = ell_aggregate_fused(nbrs, jnp.asarray(er), jnp.asarray(ev), num_rows, interpret=True)
    out = ell_aggregate(_t(x), _t(er), _t(ec), _t(ev), num_rows)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _batch_pair(seed=0):
    """One cluster-sampled training batch from each package (same arrays)."""
    kw = dict(num_layers=2, hidden_channels=16, num_D=4, num_M=8, sampler_type="cluster",
              num_parts=8, batch_size=3, pad_multiple_nodes=64, pad_multiple_edges=512)
    out = []
    for cfg_mod, data, samplers, extra in (
        (jcfg, jdata, jsamplers, {}), (tcfg, tdata, tsamplers, {"device": "cpu"})
    ):
        cfg = cfg_mod.Config(**kw)
        g, c = data.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=seed)
        g, c, ci = data.prepare(g, cfg, c)
        ld = samplers.BatchLoader(g, cfg, train_flag=True, cluster_indices=ci, **extra)
        (w, _), = [next(ld._epoch_iter())]
        out.append(w[0])
    return out


@pytest.mark.parametrize("truncated", [True, False])
def test_spmm_forward_and_dx_match_jax(truncated):
    jb, tb = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    assert je.b_rows > 0 and je.t_b_slots > 0  # the truncation is live here
    if not truncated:
        je = je.replace(b_rows=0, t_b_slots=0)
        te = dataclasses.replace(te, b_rows=0, t_b_slots=0)
    rng = np.random.RandomState(1)
    R, C = je.num_rows, 16
    x = rng.randn(R, C).astype(np.float32)
    g = rng.randn(R, C).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: j_spmm(je, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    out_t = spmm(te, xt)
    (dx_t,) = torch.autograd.grad(out_t, xt, _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), **TOL)
    if truncated:
        assert not dx_t[tb.B_pad :].any()


def test_spmm_dval_matches_jax():
    jb, tb = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(je.num_rows, 16).astype(np.float32)
    g = rng.randn(je.num_rows, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_spmm(je.replace(ell_val=v), jnp.asarray(x)), je.ell_val)
    (dv_j,) = vjp(jnp.asarray(g))
    v = te.ell_val.clone().requires_grad_(True)
    out = spmm(te, _t(x), ell_val=v)
    (dv_t,) = torch.autograd.grad(out, v, _t(g))
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), **TOL)


def _near_tie_ok(xn, emb, idx_a, idx_b):
    """Where two assignments differ, their distances must tie to within
    1e-5 of the row's distance scale; such rows must be < 0.1%."""
    diff = idx_a != idx_b
    if not diff.any():
        return
    assert diff.mean() < 1e-3, diff.mean()
    b, i = np.nonzero(diff)
    x = xn[b, i].astype(np.float64)
    d = lambda m: ((x - emb[b, m].astype(np.float64)) ** 2).sum(-1)  # noqa: E731
    da, db = d(idx_a[b, i]), d(idx_b[b, i])
    scale = np.abs((x[:, None, :] - emb[b].astype(np.float64)) ** 2).sum(-1).max(-1)
    assert np.all(np.abs(da - db) < 1e-5 * scale)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("nb,B,M,K", [(4, 2048, 64, 8), (1, 1000, 16, 4)])
def test_assign_plain_matches_pallas(nb, B, M, K, fast):
    rng = np.random.RandomState(3)
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = rng.rand(B) < 0.9
    idx_j, cnt_j, sums_j = [
        np.asarray(a)
        for a in j_assign(jnp.asarray(xn), jnp.asarray(emb), jnp.asarray(valid),
                          interpret=True, fast=fast)
    ]
    idx_t, cnt_t, sums_t = [
        a.numpy() for a in fused_assign_branches(_t(xn), _t(emb), _t(valid), fast=fast)
    ]
    _near_tie_ok(xn, emb, idx_j, idx_t)
    if np.array_equal(idx_j, idx_t):
        np.testing.assert_array_equal(cnt_t, cnt_j)
        # summation order only: each sum within 1e-5 of the sum of the |x| it adds
        _, _, abs_sums = fused_assign_branches_plain(
            _t(np.abs(xn)), _t(emb), _t(valid), fast=fast, idx=torch.as_tensor(idx_t))
        assert np.all(np.abs(sums_t - sums_j) <= 1e-5 * abs_sums.numpy())
    else:
        assert np.abs(cnt_t - cnt_j).sum() <= 2 * (idx_j != idx_t).sum()


@pytest.mark.parametrize("fast", [False, True])
def test_lookup_plain_matches_pallas(fast):
    rng = np.random.RandomState(4)
    N, nb, M, K, n = 700, 4, 64, 8, 500
    c_idx = rng.randint(0, M, (N + 1, nb)).astype(np.int16)
    ids = rng.randint(0, N + 1, n).astype(np.int64)
    emb_out = rng.randn(nb, M, K).astype(np.float32)
    c = jnp.asarray(c_idx[ids].astype(np.int32).T)
    ref = np.asarray(j_lookup(c, jnp.asarray(emb_out), interpret=True, fast=fast))
    out = lookup_codewords(_t(c_idx), _t(ids), _t(emb_out), fast=fast).numpy()
    np.testing.assert_array_equal(out, ref)  # a gather: bit-equal in both modes
