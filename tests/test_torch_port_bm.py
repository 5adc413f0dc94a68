"""The port's B + M (v1) formulation against the JAX package, on the CPU.

Host side, exactly: ``norm_adj_v1``, ``bm_subgraph``, the rev-ELL builder
(with duplicate (row, col) pairs of opposite sign) and whole loader batches
(the rev-ELL slots and the ``f_from_t`` map included).

Device side, on the same numpy inputs: the per-branch GAT conv
``gat_conv_ell_mh`` (values and VJP), ``layer_forward_bm`` for GCN, SAGE and
GAT (output, info_backward and the gradients of the parameters, the probe
and x), and live-VQ training steps of bm GAT and bm SAGE from one state
carried over by ``convert.state_from_numpy``.  The JAX side runs its XLA
paths on the CPU (its recovery term the dense grid path).

Tolerances: the conv, the layer and the recovery term differ from JAX only
by f32 sums in another order (per-branch dots taken elementwise instead of
as a block-diagonal matmul, the recovery term as a sum over cells instead of
a grid product), so 1e-5 relative to the largest |ref| for values and
gradients of one layer; training losses to rtol 1e-4 over the steps, as the
earlier slices hold them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.graph import store as jstore
from vq_gnn_tpu.nn.model import layer_forward_bm as j_layer_forward_bm
from vq_gnn_tpu.nn.model import model_static as j_model_static
from vq_gnn_tpu.ops import gat as jgat
from vq_gnn_tpu.ops.pallas_rev import build_rev_ell as j_build_rev_ell
from vq_gnn_tpu.ops.pallas_rev import pad_rev_ell as j_pad_rev_ell
from vq_gnn_tpu.ops.pallas_rev import rev_tb
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.train.step import make_step_fns as j_make_step_fns
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.graph import store as tstore
from vq_gnn_tpu_torch.nn.model import layer_forward, model_static
from vq_gnn_tpu_torch.ops import gat as tgat
from vq_gnn_tpu_torch.ops.rev_ell import REV_LONG_SLOTS, REV_S_MULTIPLE, build_rev_ell, pad_rev_ell
from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted
from vq_gnn_tpu_torch.ops.spmm import long_rows_host, row_offsets_host
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_STEP = 1e-4  # per-step losses over a few live-VQ steps
LR = 0.005

CFG = dict(formulation="bm", num_layers=2, hidden_channels=16, num_D=4, num_M=8,
           sampler_type="cont", walk_length=2, batch_size=128, test_batch_size=256,
           pad_multiple_nodes=64, pad_multiple_edges=512, vq_update_mode="live", skip=True,
           lr=LR, seed=0)


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


def _graphs(conv, **kw):
    """(cfg, graph, num_classes) prepared by each package from one SBM."""
    out = []
    for cfg_mod, data in ((jcfg, jdata), (tcfg, tdata)):
        cfg = cfg_mod.Config(conv_type=conv, **{**CFG, **kw})
        g, c = data.synthetic_sbm(num_nodes=300, num_classes=5, num_features=16, seed=5)
        g, c, _ = data.prepare(g, cfg, c)
        out.append((cfg, g, c))
    return out


# ---------------------------------------------------------------------------
# host side: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv", ["GCN", "SAGE", "GAT"])
def test_norm_adj_v1_matches_jax(conv):
    out = []
    for data, store in ((jdata, jstore), (tdata, tstore)):
        g, _ = data.synthetic_sbm(num_nodes=400, num_classes=4, num_features=8, seed=2)
        g.adj = store.symmetrize(g.adj)
        out.append(store.norm_adj_v1(g, conv))
    jg, tg = out
    assert (jg.adj != tg.adj).nnz == 0 and jg.adj.diagonal().sum() == 0
    np.testing.assert_array_equal(jg.adj.indptr, tg.adj.indptr)
    np.testing.assert_array_equal(jg.adj.indices, tg.adj.indices)
    np.testing.assert_array_equal(jg.adj.data, tg.adj.data)
    np.testing.assert_array_equal(jg.deg, tg.deg)
    np.testing.assert_array_equal(jg.deg_inv, tg.deg_inv)


@pytest.mark.parametrize(
    "conv,recovery,train_flag",
    [("GCN", True, True), ("SAGE", True, True), ("GAT", True, True), ("GAT", False, True),
     ("GAT", True, False), ("GCN", True, False)],
)
def test_bm_subgraph_matches_jax(conv, recovery, train_flag):
    (_, jg, _), (_, tg, _) = _graphs(conv)
    res = []
    for mod, g in ((jsamplers, jg), (tsamplers, tg)):
        csr = g.adj.tocsr()
        csr.sort_indices()
        node_idx = np.random.RandomState(1).choice(g.num_nodes, 90, replace=False)
        res.append(mod.bm_subgraph(
            csr.indptr.astype(np.int64), csr.indices.astype(np.int64),
            csr.data.astype(np.float32), g.deg, g.deg_inv, node_idx, g.num_nodes, conv,
            recovery, train_flag))
    (jfo, jer, jec, jev, jrev), (tfo, ter, tec, tev, trev) = res
    for a, b in ((jfo, tfo), (jer, ter), (jec, tec), (jev, tev)):
        np.testing.assert_array_equal(a, b)
    assert (jrev is None) == (trev is None) == (conv == "GCN" or not recovery or not train_flag)
    if jrev is not None:
        for a, b in zip(jrev, trev):
            np.testing.assert_array_equal(a, b)
        assert (trev[2] < 0).any()  # the raw-A subtractions of in-batch edges


def _rand_rev(rng, rows, num_N, R, dup_frac=0.3):
    """A reverse list whose duplicate (row, col) pairs carry opposite signs
    (the mapper's reverse add + raw-A subtract), as tests/test_rev_ell.py
    makes it."""
    rr = rng.integers(0, rows, R)
    rc = rng.integers(0, num_N, R)
    rv = rng.normal(size=R).astype(np.float32)
    nd = int(R * dup_frac)
    rr = np.concatenate([rr, rr[:nd], rr[:5]])
    rc = np.concatenate([rc, rc[:nd], rc[:5]])
    # the last five cancel their first copies exactly: the builder drops them
    rv = np.concatenate([rv, -0.5 * rv[:nd], -0.5 * rv[:5]])
    return rr, rc, rv


@pytest.mark.parametrize("R", [0, 400, 3000])
def test_rev_ell_matches_jax(R):
    rng = np.random.default_rng(3)
    B_pad, num_N = 256, 500
    rr, rc, rv = _rand_rev(rng, 200, num_N, R) if R else (np.zeros(0, np.int64),) * 2 + (
        np.zeros(0, np.float32),)
    tb = rev_tb(B_pad, 256)
    jd = j_build_rev_ell(rr, rc, rv, B_pad, num_N, K=8, T_s=256, TB=tb)
    S = jd["slot_row"].shape[0]
    S_pad = -(-S // REV_S_MULTIPLE) * REV_S_MULTIPLE
    jd = j_pad_rev_ell(jd, S_pad, -(-jd["tile_of"].shape[0] // 64) * 64, B_pad, num_N,
                       T_s=256, TB=tb)
    slots = build_rev_ell(rr, rc, rv, B_pad, num_N)
    assert slots[0].shape[0] == S
    col, val, row = pad_rev_ell(*slots, S_pad, B_pad, num_N)
    np.testing.assert_array_equal(col, jd["slot_col"])
    np.testing.assert_array_equal(val, jd["slot_val"])
    np.testing.assert_array_equal(row, jd["slot_row"][:, 0])
    assert (np.diff(row) >= 0).all() and col.dtype == np.int32 and row.dtype == np.int32


@pytest.mark.parametrize("conv,train_flag", [("GAT", True), ("SAGE", True), ("GAT", False)])
def test_bm_batches_match_jax(conv, train_flag):
    (jc, jg, _), (tc, tg, _) = _graphs(conv)
    kw = dict(train_flag=train_flag, seed=3)
    if not train_flag:
        kw.update(batch_size=128, shuffle=False)
    jl = jsamplers.BatchLoader(jg, jc, **kw)
    tl = tsamplers.BatchLoader(tg, tc, device="cpu", **kw)
    n = 0
    for epoch in range(2):  # the second epoch exercises the monotone buckets
        for (jw, _), (tw, _) in zip(jl._epoch_iter(), tl._epoch_iter(), strict=True):
            for jb, tb in zip(jw, tw, strict=True):
                n += 1
                for f in ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask"):
                    np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
                je, te = jb.edges, tb.edges
                for f in ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col",
                          "t_ell_val"):
                    np.testing.assert_array_equal(getattr(je, f), getattr(te, f), err_msg=f)
                assert (je.b_rows, je.t_b_slots) == (te.b_rows, te.t_b_slots)
                if conv == "GAT":
                    np.testing.assert_array_equal(je.f_from_t, te.f_from_t)
                else:
                    assert te.f_from_t is None
                if train_flag:
                    np.testing.assert_array_equal(jb.rev_slot_col, tb.rev_slot_col)
                    np.testing.assert_array_equal(jb.rev_slot_val, tb.rev_slot_val)
                    np.testing.assert_array_equal(jb.rev_slot_row[:, 0], tb.rev_slot_row)
                    # the CUDA kernels' lists, built with the batch
                    np.testing.assert_array_equal(
                        tb.rev_row_ptr, np.searchsorted(tb.rev_slot_row, np.arange(tb.B_pad + 1)))
                    slots = np.diff(tb.rev_row_ptr)
                    assert tb.rev_long_rows.tolist() == [REV_LONG_SLOTS] + np.flatnonzero(
                        slots > REV_LONG_SLOTS).tolist()
                else:
                    assert jb.rev_slot_row is None and tb.rev_slot_row is None
    assert n > 2


@pytest.mark.parametrize("train_flag", [True, False])
def test_bm_gat_batches_carry_the_row_lists(train_flag):
    """B + M GAT batches carry the row offsets and long rows of the forward
    ELL and of the whole transposed ELL, whatever the backward truncation:
    the per-branch conv's segment sums read them."""
    _, (tc, tg, _) = _graphs("GAT")
    tl = tsamplers.BatchLoader(tg, tc, device="cpu", train_flag=train_flag, seed=3)
    n = 0
    for tw, _ in tl._epoch_iter():
        for tb in tw:
            e = tb.edges
            np.testing.assert_array_equal(e.ell_ptr, row_offsets_host(e.ell_row, e.num_rows))
            np.testing.assert_array_equal(e.ell_long_rows, long_rows_host(e.ell_ptr))
            np.testing.assert_array_equal(e.t_all_ptr,
                                          row_offsets_host(e.t_ell_row, e.num_rows))
            np.testing.assert_array_equal(e.t_all_long_rows, long_rows_host(e.t_all_ptr))
            n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# device side, on the same inputs
# ---------------------------------------------------------------------------
def _batch_pair(conv, **kw):
    (jc, jg, c), (tc, tg, _) = _graphs(conv, **kw)
    jb = next(jsamplers.BatchLoader(jg, jc, train_flag=True, seed=1)._epoch_iter())[0][0]
    tb = next(tsamplers.BatchLoader(tg, tc, train_flag=True, seed=1,
                                    device="cpu")._epoch_iter())[0][0]
    return (jc, jg, c, jax.tree.map(jnp.asarray, jb)), (tc, tg, tb.to("cpu"))


def test_gat_conv_mh_matches_jax_vjp():
    (_, _, _, jb), (_, _, tb) = _batch_pair("GAT")
    R, nb, D = tb.edges.num_rows, 4, 4
    rng = np.random.RandomState(2)
    x_g = rng.randn(R, nb * D).astype(np.float32)
    al = (rng.randn(R, nb) * 0.5).astype(np.float32)
    ar = (rng.randn(R, nb) * 0.5).astype(np.float32)
    g_agg = rng.randn(R, nb * D).astype(np.float32)
    g_rs = rng.randn(R, nb).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jgat.gat_conv_ell_mh(jb.edges, *a),
                       *(jnp.asarray(a) for a in (x_g, al, ar)))
    ref_grads = vjp((jnp.asarray(g_agg), jnp.asarray(g_rs)))
    leaves = [_t(a).requires_grad_(True) for a in (x_g, al, ar)]
    out = tgat.gat_conv_ell_mh(tb.edges, *leaves)
    _close(out[0].detach(), ref[0], RTOL_SUM, "agg")
    _close(out[1].detach(), ref[1], RTOL_SUM, "rowsum")
    grads = torch.autograd.grad(out, leaves, (_t(g_agg), _t(g_rs)))
    for name, g, r in zip(("dx", "d_al", "d_ar"), grads, ref_grads):
        _close(g, r, RTOL_SUM, name)


@pytest.mark.parametrize("grad", [False, True])
def test_conv_mh_passes_the_batch_lists(grad, monkeypatch):
    """The per-branch conv hands each of its segment sums (kernel 8) the
    batch's own row offsets and long rows: the forward ELL's for the
    aggregate, the normaliser and d_ar, the whole transposed ELL's for dx
    and d_al."""
    _, (_, _, tb) = _batch_pair("GAT")
    e = tb.edges
    seen = []

    def spy(part, seg, num_rows, **kw):
        seen.append((seg, kw["ptr"], kw["long_rows"]))
        return segment_sum_sorted(part, seg, num_rows, **kw)

    monkeypatch.setattr(tgat, "segment_sum_sorted", spy)
    R, nb, D = e.num_rows, 4, 4
    rng = np.random.RandomState(3)
    leaves = [_t(a).requires_grad_(grad) for a in (
        rng.randn(R, nb * D).astype(np.float32), (0.5 * rng.randn(R, nb)).astype(np.float32),
        (0.5 * rng.randn(R, nb)).astype(np.float32))]
    out = tgat.gat_conv_ell_mh(e, *leaves)
    fwd = (e.ell_row, e.ell_ptr, e.ell_long_rows)
    t_all = (e.t_ell_row, e.t_all_ptr, e.t_all_long_rows)
    expected = [fwd, fwd]
    if grad:
        torch.autograd.grad(out, leaves, [torch.ones_like(o) for o in out])
        expected += [t_all, t_all, fwd]
    assert e.ell_ptr is not None and e.t_all_ptr is not None
    assert len(seen) == len(expected)
    for got, want in zip(seen, expected):
        assert all(a is b for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("conv", ["GCN", "SAGE", "GAT"])
def test_layer_forward_bm_matches_jax(conv):
    """One bm layer with probes, warm-up rate 0.7, random codebooks and
    codeword table: output, info_backward (for SAGE and GAT the exact
    reverse term) and the gradients of every parameter, the probe and x."""
    (jc, jg, c, jb), (tc, tg, tb) = _batch_pair(conv)
    ms_j = j_model_static(jc, jg.num_features, c)
    ms_t = model_static(tc, tg.num_features, c, torch.device("cpu"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms_j, jg.num_nodes)
    rng = np.random.RandomState(8)
    vq = jstate.vq_states[0]
    M = vq.embedding_output.shape[1]
    vq = vq.replace(
        embedding_output=jnp.asarray(rng.randn(*vq.embedding_output.shape).astype(np.float32)),
        c_indices=jnp.asarray(rng.randint(0, M, vq.c_indices.shape).astype(np.int16)),
    )
    jstate = jstate.replace(vq_states=[vq] + list(jstate.vq_states[1:]))
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")
    assert (tb.rev_slot_row is not None) == (conv != "GCN")
    B_pad, C = tb.B_pad, jg.num_features
    x = rng.randn(B_pad, C).astype(np.float32)
    w_out = rng.randn(B_pad, ms_j.channels[1]).astype(np.float32)
    probe0 = np.zeros([s for s in ((C // 4, B_pad, 5) if conv == "GAT" else (B_pad, C))],
                      np.float32)
    warm = 0.7

    def j_loss(lp, xx, probe):
        out, info = j_layer_forward_bm(lp, vq, ms_j, xx, jb, probe, warm, True)
        return jnp.sum(out * w_out) + info, (out, info)

    (_, (j_out, j_info)), (j_glp, j_gx, j_gp) = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True
    )(jstate.params[0], jnp.asarray(x), jnp.asarray(probe0))

    layer = state.model.layers[0]
    xx = _t(x).requires_grad_(True)
    probe = _t(probe0).requires_grad_(True)
    out, info = layer_forward(layer, state.vq_states[0], ms_t, xx, tb, probe, warm)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * _t(w_out)).sum() + info,
                                [p for _, p in layer.named_parameters()] + [xx, probe])
    _close(out.detach(), j_out, RTOL_SUM, "x_out")
    _close(info.detach(), j_info, RTOL_SUM, "info_backward")
    assert abs(float(j_info)) > 0
    _close(grads[-1], j_gp, RTOL_SUM, "d_probe")
    _close(grads[-2], j_gx, RTOL_SUM, "dx")
    for name, g in zip(names, grads):
        mod, _, key = name.partition(".")
        ref = j_glp[mod] if not key else j_glp[mod][{"weight": "w", "bias": "b"}[key]]
        ref = np.asarray(ref).T if key == "weight" else ref
        _close(g, ref, RTOL_SUM, name)


@pytest.mark.parametrize("conv", ["GAT", "SAGE", "GCN"])
def test_bm_training_matches_jax(conv):
    """Init sweep, one epoch of live-VQ steps (cont sampler, three windows
    per batch, the first without an optimizer step) and eval, from one state:
    the per-step losses and info_backward to rtol 1e-4, and the codeword
    assignments after the epoch."""
    (jc, jg, c), (tc, tg, _) = _graphs(conv, bn_flag=False)
    N = jg.num_nodes
    ms = j_model_static(jc, jg.num_features, c)
    jstate = j_init_train_state(jax.random.PRNGKey(0), ms, N)
    fns = j_make_step_fns(ms, jc, multilabel=False)
    X = j_device_features(jg.x)
    j_train = jsamplers.BatchLoader(jg, jc, train_flag=True, seed=jc.seed)
    j_test = jsamplers.BatchLoader(jg, jc, train_flag=False, sampler_type="node",
                                   batch_size=jc.test_batch_size, shuffle=False,
                                   seed=jc.seed + 1)
    j_test_batches = [jax.tree.map(jnp.asarray, w[0]) for w, _ in j_test._epoch_iter()]

    tr = NodeTrainer(tg, tc, c, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jstate), tr.ms, LR, "cpu")
    for layer_idx in range(1, ms.num_layers + 1):
        step = fns.init_step_for(layer_idx)
        for b in j_test_batches:
            vq, _ = step(jstate.vq_states, [], jstate.params, X, b)
            jstate = jstate.replace(vq_states=vq)
    tr.run_init_sweep()

    steps = 0
    for (jw, _), (tw, _) in zip(j_train._epoch_iter(), tr.train_loader, strict=True):
        for j, (jb, tb) in enumerate(zip(jw, tw, strict=True)):
            do_opt = 0.0 if (len(jw) > 1 and j == 0) else 1.0
            jstate, jm = fns.train_step(
                jstate, X, jax.tree.map(jnp.asarray, jb), jnp.float32(1.0), jnp.float32(LR),
                jnp.float32(do_opt), jax.random.PRNGKey(1),
            )
            tr.state, tm = tr.fns.train_step(tr.state, tr.X_dev, tb, 1.0, LR, do_opt)
            for k in ("loss", "loss_cls", "info_backward"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_STEP,
                                           atol=1e-7, err_msg=f"step {steps} {k}")
            steps += 1
    assert steps >= 3
    for js, ts in zip(jstate.vq_states, tr.state.vq_states):
        assert ts.embedding.shape[-1] == 2 * 4 + (conv == "GAT")  # add_flag
        agree = (ts.c_indices.numpy()[:N] == np.asarray(js.c_indices)[:N]).mean()
        assert agree > 0.99, agree
    for jb, (tw, _) in zip(j_test_batches, tr.test_batches()):
        out = tr.fns.eval_step(tr.state, tr.X_dev, tw[0]).numpy()
        ref = np.asarray(fns.eval_step(jstate, X, jb))
        np.testing.assert_allclose(out, ref, atol=1e-4)
