"""The port's GAT path (``vq_gnn_tpu_torch/ops/gat.py``, the plain versions of
kernels 4 and 5, and the GAT ``layer_forward``) against the JAX package on the
same numpy inputs, on the CPU.  The JAX side runs its XLA path, or its Pallas
kernels in interpret mode, as its own tests run them on the CPU.

Tolerances: the forward and the kernel-level backward differ from JAX only by
f32 sums in another order (and the per-node logit dot taken once per node
instead of once per cell), so 1e-5 relative to the largest |ref|.  The
conv's gradients go through the closed-form d_ar, which JAX bounds at rtol
2e-4 on random data (``vq_gnn_tpu/ops/gat.py:120-124``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn.model import layer_forward as j_layer_forward
from vq_gnn_tpu.nn.model import model_static as j_model_static
from vq_gnn_tpu.ops import gat as jgat
from vq_gnn_tpu.ops.pallas_ell import gat_aggregate_fused, gat_bwd_fused, gat_bwd_fused_merged
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn.model import layer_forward, model_static
from vq_gnn_tpu_torch.ops import gat as tgat
from vq_gnn_tpu_torch.ops.gat_kernels import gat_aggregate, gat_backward
from vq_gnn_tpu_torch.ops.spmm import build_ell_host
from vq_gnn_tpu_torch.sampler import samplers as tsamplers

RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_GRAD = 2e-4  # the closed-form d_ar's bound on random data

CFG = dict(conv_type="GAT", num_layers=2, hidden_channels=16, num_D=4, num_M=8,
           sampler_type="cluster", num_parts=8, batch_size=3, pad_multiple_nodes=64,
           pad_multiple_edges=512, skip=True)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(out, ref, rtol, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def _batch_pair(seed=0):
    """One GAT-normalised cluster-sampled training batch from each package
    (identical arrays), with each package's config and graph."""
    out = []
    for cfg_mod, data, samplers, extra in (
        (jcfg, jdata, jsamplers, {}), (tcfg, tdata, tsamplers, {"device": "cpu"})
    ):
        cfg = cfg_mod.Config(**CFG)
        g, c = data.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=seed)
        g, c, ci = data.prepare(g, cfg, c)
        ld = samplers.BatchLoader(g, cfg, train_flag=True, cluster_indices=ci, **extra)
        (w, _), = [next(ld._epoch_iter())]
        out.append((cfg, g, c, w[0]))
    return out


def _conv_inputs(R, C, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(R, C).astype(np.float32)
    att_l = (rng.randn(C + 1) * 0.3).astype(np.float32)
    att_r = (rng.randn(C + 1) * 0.3).astype(np.float32)
    return x, att_l, att_r


@pytest.mark.parametrize("with_neg", [True, False])
@pytest.mark.parametrize("C", [16, 128])
def test_forward_matches_jax(C, with_neg):
    (_, _, _, jb), (_, _, _, tb) = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    x, att_l, att_r = _conv_inputs(je.num_rows, C, 1)
    scale = 1.7
    ref = jgat._gat_conv_fwd_impl(je, jnp.asarray(x), jnp.asarray(att_l), jnp.asarray(att_r),
                                  jnp.float32(scale), with_neg=with_neg)
    out = tgat._gat_forward(te, _t(x), _t(att_l), _t(att_r), torch.tensor(scale), with_neg)
    agg, rowsum, aggn, rsn, _, ar_node = out
    _close(agg, ref[0], RTOL_SUM, "agg")
    _close(rowsum, np.asarray(ref[1])[:, 0], RTOL_SUM, "rowsum")
    _close(ar_node, ref[4], RTOL_SUM, "ar_node")
    if with_neg:
        _close(aggn, ref[2], RTOL_SUM, "aggn")
        _close(rsn, ref[3], RTOL_SUM, "rsn")
    else:
        assert aggn is None and rsn is None and ref[2] is None


def _ell_case(num_rows, E, K, seed, tile=128):
    """A random slot-ELL padded to a multiple of the Pallas tile (padding
    slots: row = col = num_rows, val = 0)."""
    rng = np.random.RandomState(seed)
    row = np.sort(rng.randint(0, num_rows, E))
    col = rng.randint(0, num_rows, E)
    val = rng.rand(E).astype(np.float32)
    er, ec, ev = build_ell_host(row, col, val, num_rows, K)
    pad = -len(er) % tile
    er = np.concatenate([er, np.full(pad, num_rows, np.int32)])
    ec = np.concatenate([ec, np.full((pad, K), num_rows, np.int32)])
    ev = np.concatenate([ev, np.zeros((pad, K), np.float32)])
    return er, ec, ev


def _node_logit(x, att, scale):
    C = x.shape[1]
    return ((x @ att[:C] + att[C]) / scale).astype(np.float32)


@pytest.mark.parametrize("with_neg", [True, False])
def test_forward_matches_pallas_kernel(with_neg):
    R, C, K = 300, 128, 8
    er, ec, ev = _ell_case(R, 2300, K, 2)
    x, att_l, att_r = _conv_inputs(R, C, 3)
    scale = np.float32(1.7)
    al, ar = _node_logit(x, att_l, scale), _node_logit(x, att_r, scale)
    nbrs = jnp.take(jnp.asarray(x), jnp.asarray(ec).reshape(-1), axis=0, mode="clip")
    ref = gat_aggregate_fused(nbrs, jnp.asarray(er), jnp.asarray(ev), jnp.asarray(ar),
                              jnp.asarray(att_l[:C]), att_l[C], scale, R,
                              with_neg=with_neg, interpret=True)
    out = gat_aggregate(_t(x), _t(er), _t(ec), _t(ev), _t(al), _t(ar), R, with_neg=with_neg)
    names = ("agg", "rowsum", "aggn", "rsn") if with_neg else ("agg", "rowsum")
    for name, o, r in zip(names, out, ref):
        _close(o, r, RTOL_SUM, name)


@pytest.mark.parametrize("C", [128, 256])
def test_backward_matches_pallas_kernels(C):
    """C = 128 against the merged-gather kernel, C = 256 against the split
    one: the two shapes at which the JAX package takes each."""
    R, K = 260, 8
    t_row, t_col, t_val = _ell_case(R, 2000, K, 4)  # as a transposed ELL
    rng = np.random.RandomState(5)
    x = rng.randn(R, C).astype(np.float32)
    att_l = (rng.randn(C + 1) * 0.1).astype(np.float32)
    g_agg = rng.randn(R, C).astype(np.float32)
    g_rs = rng.randn(R).astype(np.float32)
    ar = (rng.randn(R) * 0.2).astype(np.float32)
    scale = np.float32(1.9)
    al = _node_logit(x, att_l, scale)
    idx = jnp.asarray(t_col).reshape(-1)
    jx, jg, jrs, jar = (jnp.asarray(a) for a in (x, g_agg, g_rs[:, None], ar[:, None]))
    args = (jnp.asarray(t_row), jnp.asarray(t_val), jnp.asarray(att_l[:C]), att_l[C], scale, R)
    if C == 128:
        gf = jnp.take(jnp.concatenate([jg, jrs, jar], axis=1), idx, axis=0, mode="clip")
        ref = gat_bwd_fused_merged(gf, jx, *args, interpret=True)
    else:
        gl = jnp.take(jg[:, :128], idx, axis=0, mode="clip")
        gh = jnp.take(jnp.concatenate([jg[:, 128:], jrs, jar], axis=1), idx, axis=0,
                      mode="clip")
        x_rows = jnp.take(jx, jnp.asarray(t_row), axis=0, mode="clip")
        ref = gat_bwd_fused(gl, gh, x_rows, *args, interpret=True)
    out = gat_backward(_t(x), _t(t_row), _t(t_col), _t(t_val), _t(g_agg), _t(g_rs), _t(al),
                       _t(ar), R)
    _close(out[0], ref[0], RTOL_SUM, "dx_agg")
    _close(out[1], ref[1], RTOL_SUM, "d_al")


@pytest.mark.parametrize("scale_from_x", [False, True])
def test_backward_matches_jax_vjp(scale_from_x):
    """Gradients of the port's autograd Function against ``jax.vjp`` of the
    JAX ``gat_conv_ell`` under random cotangents: x, att_l, att_r and the
    scale, or, with the scale taken from x (``explosion_scale``), x through
    the scale as well."""
    (_, _, _, jb), (_, _, _, tb) = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    R, C = je.num_rows, 16
    x, att_l, att_r = _conv_inputs(R, C, 6)
    rng = np.random.RandomState(7)
    g_agg = rng.randn(R, C).astype(np.float32)
    g_rs = rng.randn(R, 1).astype(np.float32)
    valid = rng.rand(R) < 0.9
    scale0 = np.float32(1.7)

    def j_fn(xx, al_, ar_, sc):
        if scale_from_x:
            sc = jgat.explosion_scale(xx @ al_[:C] + al_[C], xx @ ar_[:C] + ar_[C],
                                      jnp.asarray(valid))
        return jgat.gat_conv_ell(je, xx, al_, ar_, sc)

    prim = [jnp.asarray(a) for a in (x, att_l, att_r, scale0)]
    ref_out, vjp = jax.vjp(j_fn, *prim)
    ref_grads = vjp((jnp.asarray(g_agg), jnp.asarray(g_rs)))

    leaves = [_t(a).requires_grad_(True) for a in (x, att_l, att_r, scale0)]
    xx, al_, ar_, sc = leaves
    if scale_from_x:
        sc = tgat.explosion_scale(xx @ al_[:C] + al_[C], xx @ ar_[:C] + ar_[C], _t(valid))
    out = tgat.gat_conv_ell(te, xx, al_, ar_, sc)
    _close(out[0].detach(), ref_out[0], RTOL_SUM, "agg")
    _close(out[1].detach(), ref_out[1], RTOL_SUM, "rowsum")
    grads = torch.autograd.grad(out, leaves, (_t(g_agg), _t(g_rs)), allow_unused=True)
    for name, g, r in zip(("dx", "d_att_l", "d_att_r", "d_scale"), grads, ref_grads):
        if scale_from_x and name == "d_scale":
            assert g is None and float(r) == 0.0  # the given scale is unused
            continue
        _close(g, r, RTOL_GRAD, name)


def test_layer_forward_matches_jax():
    """One GAT layer with probes: x_out, info_backward and the gradients of
    the probe (the (C+1)-th column included), of x and of the attention
    vectors, against the JAX ``layer_forward``."""
    (jc, jg, c, jb), (tc, tg, _, tb) = _batch_pair()
    ms_j = j_model_static(jc, jg.num_features, c)
    ms_t = model_static(tc, tg.num_features, c, torch.device("cpu"))
    N = jg.num_nodes
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, N)
    rng = np.random.RandomState(8)
    vq = jstate.vq_states[0]
    nb, M, _ = vq.embedding_output.shape
    vq = vq.replace(
        embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)),
    )
    jstate = jstate.replace(vq_states=[vq] + list(jstate.vq_states[1:]))
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    jb, tb = jax.tree.map(jnp.asarray, jb), tb.to("cpu")
    B_pad, C = tb.B_pad, jg.num_features
    x = rng.randn(B_pad, C).astype(np.float32)
    w_out = rng.randn(B_pad, ms_j.channels[1]).astype(np.float32)
    probe0 = np.zeros((B_pad, C + 1), np.float32)
    warm = 0.7

    def j_loss(lp, xx, probe):
        out, info = j_layer_forward(lp, vq, ms_j, xx, jb, probe, warm, True)
        return jnp.sum(out * w_out) + info, (out, info)

    (_, (j_out, j_info)), (j_glp, j_gx, j_gp) = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True
    )(jstate.params[0], jnp.asarray(x), jnp.asarray(probe0))

    layer = state.model.layers[0]
    xx = _t(x).requires_grad_(True)
    probe = _t(probe0).requires_grad_(True)
    out, info = layer_forward(layer, state.vq_states[0], ms_t, xx, tb, probe, warm)
    loss = (out * _t(w_out)).sum() + info
    g_att_l, g_att_r, gx, gp = torch.autograd.grad(loss, [layer.att_l, layer.att_r, xx, probe])
    _close(out.detach(), j_out, RTOL_SUM, "x_out")
    _close(info.detach(), j_info, RTOL_SUM, "info_backward")
    assert np.abs(np.asarray(j_gp)[:, C]).max() > 0  # the ones column carries a gradient
    _close(gp, j_gp, RTOL_GRAD, "d_probe")
    _close(gx, j_gx, RTOL_GRAD, "dx")
    _close(g_att_l, j_glp["att_l"], RTOL_GRAD, "d_att_l")
    _close(g_att_r, j_glp["att_r"], RTOL_GRAD, "d_att_r")
