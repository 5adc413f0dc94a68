"""The port's GAT path (``vq_gnn_tpu_torch/ops/gat.py``, the plain versions of
kernels 4 and 5, and the GAT ``layer_forward``) against the JAX package on the
same numpy inputs, on the CPU.  The JAX side runs its XLA path, or its Pallas
kernels in interpret mode, as its own tests run them on the CPU.

Tolerances: the forward and the kernel-level backward differ from JAX only by
f32 sums in another order (and the per-node logit dot taken once per node
instead of once per cell), so 1e-5 relative to the largest |ref|.  The
conv's gradients go through the closed-form d_ar, which JAX bounds at rtol
2e-4 on random data (``vq_gnn_tpu/ops/gat.py:120-124``)."""

import dataclasses

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
from vq_gnn_tpu_torch.ops import gat_kernels
from vq_gnn_tpu_torch.ops.gat_kernels import gat_aggregate, gat_backward, gat_backward_plain
from vq_gnn_tpu_torch.ops.spmm import build_ell_host, long_rows_host, row_offsets_host
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_GRAD = 2e-4  # the closed-form d_ar's bound on random data

CFG = dict(conv_type="GAT", num_layers=2, hidden_channels=16, num_D=4, num_M=8,
           sampler_type="cluster", num_parts=8, batch_size=3, pad_multiple_nodes=64,
           pad_multiple_edges=512, skip=True)


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


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


def _ragged_ell_case(num_rows, K, seed, tile=128):
    """A slot-ELL with one row of 320 cells (40 slots, more than
    LONG_SLOTS), two rows without a slot, zero cells among the live ones,
    and padding slots (row = col = num_rows, val = 0) up to a multiple of
    the Pallas tile."""
    rng = np.random.RandomState(seed)
    row = np.sort(np.concatenate([rng.randint(0, num_rows, 8 * num_rows),
                                  np.full(320, num_rows // 3)]))
    col = rng.randint(0, num_rows, len(row))
    val = rng.rand(len(row)).astype(np.float32)
    val[rng.rand(len(row)) < 0.15] = 0.0
    er, ec, ev = build_ell_host(row, col, val, num_rows, K)
    keep = ~np.isin(er, [num_rows // 5, 2 * num_rows // 3])
    er, ec, ev = er[keep], ec[keep], ev[keep]
    pad = -len(er) % tile or tile
    er = np.concatenate([er, np.full(pad, num_rows, np.int32)])
    ec = np.concatenate([ec, np.full((pad, K), num_rows, np.int32)])
    ev = np.concatenate([ev, np.zeros((pad, K), np.float32)])
    return er, ec, ev


@pytest.mark.parametrize("with_neg,ell", [(True, "random"), (False, "random"),
                                          (True, "ragged"), (False, "ragged")],
                         ids=["True", "False", "ragged-True", "ragged-False"])
def test_forward_matches_pallas_kernel(with_neg, ell):
    """Kernel 4's wrapper against the Pallas kernel (interpret mode), on a
    random ELL and on a ragged one, where it takes the row offsets and the
    long-row list that build_padded_batch makes (row_offsets_host,
    long_rows_host).  Tolerance RTOL_SUM."""
    R, C, K = 300, 128, 8
    kw = {}
    if ell == "random":
        er, ec, ev = _ell_case(R, 2300, K, 2)
    else:
        er, ec, ev = _ragged_ell_case(R, K, 2)
        ptr = row_offsets_host(er, R)
        long_rows = long_rows_host(ptr)
        assert (np.diff(ptr) == 0).sum() == 2 and len(long_rows) >= 2
        assert long_rows[1] == R // 3 and (ev == 0).any() and (er == R).any()
        kw = dict(ptr=_t(ptr), long_rows=_t(long_rows))
    x, att_l, att_r = _conv_inputs(R, C, 3)
    scale = np.float32(1.7)
    al, ar = _node_logit(x, att_l, scale), _node_logit(x, att_r, scale)
    nbrs = jnp.take(jnp.asarray(x), jnp.asarray(ec).reshape(-1), axis=0, mode="clip")
    ref = gat_aggregate_fused(nbrs, jnp.asarray(er), jnp.asarray(ev), jnp.asarray(ar),
                              jnp.asarray(att_l[:C]), att_l[C], scale, R,
                              with_neg=with_neg, interpret=True)
    out = gat_aggregate(_t(x), _t(er), _t(ec), _t(ev), _t(al), _t(ar), R, with_neg=with_neg,
                        **kw)
    names = ("agg", "rowsum", "aggn", "rsn") if with_neg else ("agg", "rowsum")
    for name, o, r in zip(names, out, ref):
        _close(o, r, RTOL_SUM, name)
    if ell == "ragged":  # the rows without a slot sum nothing
        empty = np.flatnonzero(np.diff(row_offsets_host(er, R)) == 0)
        assert not out[0][empty].any() and not out[1][empty].any()


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
    the scale as well.  The training batch sets ``b_rows``: x's gradient is
    the JAX one below it and zero above (``Edges.b_rows``)."""
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
    b = te.b_rows
    assert 0 < b < R
    for name, g, r in zip(("dx", "d_att_l", "d_att_r", "d_scale"), grads, ref_grads):
        if scale_from_x and name == "d_scale":
            assert g is None and float(r) == 0.0  # the given scale is unused
            continue
        if name == "dx":
            # above b_rows only the scale's max rows get a gradient, through
            # explosion_scale, not through the conv
            rest = torch.ones(R, dtype=torch.bool)
            if scale_from_x:
                for att in (att_l, att_r):
                    rest[int(np.argmax(np.where(valid, x @ att[:C] + att[C], -np.inf)))] = False
            assert not g[b:][rest[b:]].any()
            g, r = g[:b], np.asarray(r)[:b]
        _close(g, r, RTOL_GRAD, name)


def _spy_dx_rows(monkeypatch):
    """Records the dx_rows of each kernel-5 call the conv makes."""
    seen = []

    def spy(*args, dx_rows=None, **kw):
        seen.append(dx_rows)
        return gat_backward(*args, dx_rows=dx_rows, **kw)

    monkeypatch.setattr(tgat, "gat_backward", spy)
    return seen


@pytest.mark.parametrize("cut", ["layer 0", "b_rows", "R"])
def test_backward_dx_rows_matches_jax_vjp(cut, monkeypatch):
    """The conv's backward passes kernel 5 only the dx work that has a
    consumer: none where x needs no gradient (layer 0), the rows < b_rows
    where the batch sets the truncation, every row without it.  x's
    gradient matches ``jax.vjp`` below that bound and is zero above it;
    d_att_l, d_att_r and d_scale match JAX and are the same bits at every
    cut."""
    (_, _, _, jb), (_, _, _, tb) = _batch_pair()
    je = jax.tree.map(jnp.asarray, jb.edges)
    te = tb.edges.to("cpu")
    R, C = je.num_rows, 16
    full = dataclasses.replace(te, b_rows=0, t_b_slots=0)
    x, att_l, att_r = _conv_inputs(R, C, 6)
    rng = np.random.RandomState(7)
    g_agg = rng.randn(R, C).astype(np.float32)
    g_rs = rng.randn(R, 1).astype(np.float32)
    scale0 = np.float32(1.7)
    prim = [jnp.asarray(a) for a in (x, att_l, att_r, scale0)]
    _, vjp = jax.vjp(lambda *a: jgat.gat_conv_ell(je, *a), *prim)
    ref = vjp((jnp.asarray(g_agg), jnp.asarray(g_rs)))

    seen = _spy_dx_rows(monkeypatch)

    def port_grads(edges, with_x):
        leaves = [_t(x).requires_grad_(with_x)] + [
            _t(a).requires_grad_(True) for a in (att_l, att_r, scale0)]
        out = tgat.gat_conv_ell(edges, *leaves)
        want = leaves if with_x else leaves[1:]
        grads = torch.autograd.grad(out, want, (_t(g_agg), _t(g_rs)))
        return grads if with_x else (None, *grads)

    base = port_grads(full, True)  # the uncut call
    edges, want_b = {"layer 0": (te, 0), "b_rows": (te, te.b_rows), "R": (full, R)}[cut]
    grads = port_grads(edges, cut != "layer 0")
    assert seen == [R, want_b] and 0 < te.b_rows < R
    dx = grads[0]
    if cut == "layer 0":
        assert dx is None
    else:
        assert not dx[want_b:].any()
        _close(dx[:want_b], np.asarray(ref[0])[:want_b], RTOL_GRAD, "dx")
        np.testing.assert_array_equal(dx[:want_b].numpy(), base[0][:want_b].numpy())
    for name, g, g0, r in zip(("d_att_l", "d_att_r", "d_scale"), grads[1:], base[1:], ref[1:]):
        _close(g, r, RTOL_GRAD, name)
        np.testing.assert_array_equal(g.numpy(), g0.numpy(), err_msg=name)


@pytest.mark.parametrize("dx_rows", [0, 1, 97, 130, 260])
def test_backward_plain_dx_rows(dx_rows):
    """Kernel 5's plain version at a dx_rows cut: dx_agg below the cut is
    the uncut call's (the same sums), zero above, None at 0; d_al is the
    uncut call's at every cut."""
    R, C, K = 260, 16, 8
    t_row, t_col, t_val = (_t(a) for a in _ell_case(R, 2000, K, 4))
    rng = np.random.RandomState(9)
    x, g_agg = (_t(rng.randn(R, C).astype(np.float32)) for _ in range(2))
    g_rs, al, ar = (_t(rng.randn(R).astype(np.float32)) for _ in range(3))
    args = (x, t_row, t_col, t_val, g_agg, g_rs, al, ar, R)
    dx0, d_al0 = gat_backward_plain(*args)
    dx, d_al = gat_backward_plain(*args, dx_rows=dx_rows)
    assert torch.equal(d_al, d_al0)
    if dx_rows == 0:
        assert dx is None
        return
    assert dx.shape == (R, C) and not dx[dx_rows:].any()
    assert torch.equal(dx[:dx_rows], dx0[:dx_rows])


def test_gat_batches_carry_the_whole_transposed_lists():
    """A B + B' GAT batch carries the row offsets and long rows of its whole
    transposed ELL (kernel 5 walks every row) beside the truncated ones of
    the SpMM dx; the GCN batch of the same loader configuration does not."""
    (_, _, _, _), (_, _, _, tb) = _batch_pair()
    e = tb.edges
    assert 0 < e.b_rows < e.num_rows and e.t_ell_ptr.shape[0] == e.b_rows + 1
    ptr = row_offsets_host(e.t_ell_row, e.num_rows)
    np.testing.assert_array_equal(e.t_all_ptr, ptr)
    np.testing.assert_array_equal(e.t_all_long_rows, long_rows_host(ptr))
    te = e.to("cpu")
    assert te.t_all_ptr.dtype == torch.int32 and te.t_all_long_rows.dtype == torch.int32
    cfg = tcfg.Config(**{**CFG, "conv_type": "GCN"})
    g, c = tdata.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=0)
    g, c, ci = tdata.prepare(g, cfg, c)
    ld = tsamplers.BatchLoader(g, cfg, train_flag=True, cluster_indices=ci, device="cpu")
    (w, _), = [next(ld._epoch_iter())]
    assert w[0].edges.t_all_ptr is None and w[0].edges.t_all_long_rows is None


def test_gat_batches_carry_the_forward_lists():
    """A B + B' GAT batch carries the row offsets of its forward ELL and the
    long rows taken from them, the lists kernel 4 reads."""
    (_, _, _, _), (_, _, _, tb) = _batch_pair()
    e = tb.edges
    np.testing.assert_array_equal(e.ell_ptr, row_offsets_host(e.ell_row, e.num_rows))
    np.testing.assert_array_equal(e.ell_long_rows, long_rows_host(e.ell_ptr))
    te = e.to("cpu")
    assert te.ell_ptr.dtype == torch.int32 and te.ell_long_rows.dtype == torch.int32


@pytest.mark.parametrize("grad", [True, False])
def test_conv_forward_passes_the_batch_lists(grad, monkeypatch):
    """The conv's forward hands kernel 4 the batch's own row offsets and
    long rows, with and without a gradient to take."""
    (_, _, _, _), (_, _, _, tb) = _batch_pair()
    te = tb.edges.to("cpu")
    seen = []

    def spy(*args, **kw):
        seen.append((kw["ptr"], kw["long_rows"], kw["with_neg"]))
        return gat_aggregate(*args, **kw)

    monkeypatch.setattr(tgat, "gat_aggregate", spy)
    x, att_l, att_r = (_t(a).requires_grad_(grad) for a in _conv_inputs(te.num_rows, 16, 8))
    tgat.gat_conv_ell(te, x, att_l, att_r, torch.tensor(1.3))
    (ptr, long_rows, with_neg), = seen
    assert ptr is te.ell_ptr and long_rows is te.ell_long_rows and with_neg == grad


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


def test_layer_forward_b_rows_cut_changes_no_gradient():
    """The GAT layer on a batch whose edges set ``b_rows`` (kernel 5 then
    computes dx_agg for the batch rows only): x_out, info_backward, every
    parameter gradient, x's gradient and the probe gradients that
    ``vq_update`` reads are the bits of the uncut call."""
    (_, _, _, _), (tc, tg, c, tb) = _batch_pair()
    ms_t = model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), j_model_static(
        jcfg.Config(**CFG), tg.num_features, c), tg.num_nodes)
    rng = np.random.RandomState(10)
    vq = jstate.vq_states[0]
    M = vq.embedding_output.shape[1]
    vq = vq.replace(
        embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)),
    )
    jstate = jstate.replace(vq_states=[vq] + list(jstate.vq_states[1:]))
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, 0.01, "cpu")
    cut = tb.to("cpu")
    assert 0 < cut.edges.b_rows < cut.edges.num_rows
    uncut = dataclasses.replace(cut, edges=dataclasses.replace(cut.edges, b_rows=0,
                                                               t_b_slots=0))
    B_pad, C = cut.B_pad, tg.num_features
    x = rng.randn(B_pad, C).astype(np.float32)
    w_out = _t(rng.randn(B_pad, ms_t.channels[1]).astype(np.float32))
    layer = state.model.layers[0]
    params = [p for p in layer.parameters() if p.requires_grad]
    res = []
    for batch in (cut, uncut):
        xx = _t(x).requires_grad_(True)
        probe = torch.zeros((B_pad, C + 1), requires_grad=True)
        out, info = layer_forward(layer, state.vq_states[0], ms_t, xx, batch, probe, 0.7)
        loss = (out * w_out).sum() + info
        res.append([out.detach(), info.detach(),
                    *torch.autograd.grad(loss, [*params, xx, probe])])
    assert len(params) >= 3
    for i, (a, b) in enumerate(zip(*res)):
        assert torch.equal(a, b), i
