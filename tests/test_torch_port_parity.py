"""The port's accuracy-parity slice against the JAX package, on the CPU.

- Host side, exactly: ``bm_subgraph(exact_minibatch=True)`` and the loader's
  B + M exact mini-batch batches (GCN, SAGE, GAT); ``make_edges``.
- The COO forward and ``full_graph_inference`` on converted parameters, for
  GCN, SAGE (with and without skip) and GAT, to rtol 1e-5 (f32 sums in
  another order); ``full_graph_predict`` after one trained epoch from one
  state, to 1e-4 (the epoch's steps, as the earlier slices hold them).
- The four VQ diagnostics on one converted state, to 1e-6.
- ``exact_config`` / ``exact_mb_config`` field for field; ``train_to_acc``
  from one initial state (GCN B + B' and GCN B + M exact mini-batch): the
  history's ``loss_cls`` to rtol 1e-4 and the accuracies, ``best_valid`` and
  ``test_at_best_valid`` equal; ``parity_gap``'s arms, keys and gaps.
- The bf16 fold of the recovery term (``VQ_GNN_REV_FOLD=fast``): the plain
  version against the JAX package's Pallas kernel in interpret mode, values
  and gradients, with a tolerance derived from bf16's unit roundoff
  (``test_rev_fold_fast_plain_matches_pallas`` says how).
"""

import dataclasses
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import model as jmodel
from vq_gnn_tpu.ops import pallas_rev as jrev
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train import parity as jparity
from vq_gnn_tpu.train.loop import NodeTrainer as JNodeTrainer
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu.utils import diagnostics as jdiag
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy, vq_state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.ops import rev_kernels
from vq_gnn_tpu_torch.ops import spmm as tspmm
from vq_gnn_tpu_torch.ops.rev_ell import REV_K, build_rev_ell, pad_rev_ell
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train import parity as tparity
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.utils import diagnostics as tdiag
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

jspmm = importlib.import_module("vq_gnn_tpu.ops.spmm")  # the package exports a function `spmm`
RTOL_SUM = 1e-5  # x the largest |ref|: f32 sums in another order
RTOL_STEP = 1e-4  # after a few training steps
LR = 0.005
CFG = dict(num_layers=2, hidden_channels=16, num_D=4, num_M=8, pad_multiple_nodes=64,
           pad_multiple_edges=512, lr=LR, seed=0)
BM = dict(formulation="bm", sampler_type="cont", walk_length=2, batch_size=128,
          test_batch_size=256, exact_minibatch=True)


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _close(out, ref, rtol, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def _graphs(n=300, **kw):
    """(cfg, graph, num_classes, cluster indices) prepared by each package
    from one SBM."""
    out = []
    for cfg_mod, data in ((jcfg, jdata), (tcfg, tdata)):
        cfg = cfg_mod.Config(**{**CFG, **kw})
        g, c = data.synthetic_sbm(num_nodes=n, num_classes=5, num_features=16, seed=5)
        out.append((cfg, *data.prepare(g, cfg, c)))
    return out


def _csr(g):
    csr = g.adj.tocsr()
    csr.sort_indices()
    return csr.indptr.astype(np.int64), csr.indices.astype(np.int64), csr.data.astype(np.float32)


# ---------------------------------------------------------------------------
# host side: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv", ["GCN", "SAGE", "GAT"])
def test_bm_subgraph_exact_minibatch_matches_jax(conv):
    (_, jg, _, _), (_, tg, _, _) = _graphs(conv_type=conv, **BM)
    res = []
    for mod, g in ((jsamplers, jg), (tsamplers, tg)):
        node_idx = np.random.RandomState(1).choice(g.num_nodes, 90, replace=False)
        res.append(mod.bm_subgraph(*_csr(g), g.deg, g.deg_inv, node_idx, g.num_nodes, conv,
                                   True, True, exact_minibatch=True))
    (jfo, jer, jec, jev, jrev_), (tfo, ter, tec, tev, trev) = res
    for a, b in ((jfo, tfo), (jer, ter), (jec, tec), (jev, tev)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert jrev_ is None and trev is None and len(tfo) == 0
    assert ter.max() < 90 and tec.max() < 90  # batch rows and columns only


@pytest.mark.parametrize("conv", ["GCN", "SAGE", "GAT"])
def test_bm_exact_minibatch_batches_match_jax(conv):
    """The loader's B + M exact mini-batch batches, train and full-graph eval
    (``exact_eval_train_edges``), equal the JAX package's."""
    (jc, jg, _, _), (tc, tg, _, _) = _graphs(conv_type=conv, **BM)
    n = 0
    for kw in (dict(train_flag=True, seed=3),
               dict(train_flag=True, batch_size=jg.num_nodes, shuffle=False, seed=4,
                    sampler_type="node")):
        jl = jsamplers.BatchLoader(jg, jc, **kw)
        tl = tsamplers.BatchLoader(tg, tc, device="cpu", **kw)
        for (jw, _), (tw, _) in zip(jl._epoch_iter(), tl._epoch_iter(), strict=True):
            for jb, tb in zip(jw, tw, strict=True):
                n += 1
                for f in ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask"):
                    np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
                for f in ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col",
                          "t_ell_val"):
                    np.testing.assert_array_equal(getattr(jb.edges, f), getattr(tb.edges, f),
                                                  err_msg=f)
                assert not tb.valid_fo.any()
                assert jb.rev_slot_row is None and tb.rev_slot_row is None
    assert n > 2


def test_make_edges_matches_jax():
    (_, jg, _, _), (_, tg, _, _) = _graphs(conv_type="GCN")
    rng = np.random.RandomState(0)
    row, col, val = jg.coo()
    perm = rng.permutation(len(row))  # make_edges sorts (stably) by row
    je = jspmm.make_edges(row[perm], col[perm], val[perm], jg.num_nodes)
    te = tspmm.make_edges(*(a[perm] for a in tg.coo()), tg.num_nodes)
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(np.asarray(getattr(je, f)), getattr(te, f), err_msg=f)
        assert np.asarray(getattr(je, f)).dtype == getattr(te, f).dtype
    assert je.num_rows == te.num_rows == tg.num_nodes
    np.testing.assert_array_equal(te.row_ptr,
                                  np.searchsorted(te.row, np.arange(tg.num_nodes + 1)))
    assert te.row_long_rows[0] == tspmm.LONG_SLOTS


# ---------------------------------------------------------------------------
# the COO forward and full-graph inference
# ---------------------------------------------------------------------------
def _converted_state(jc, tc, jg, tg, c, bn_seed=None):
    """The JAX package's initial state and the same as the port's; with
    ``bn_seed`` the BN running statistics are drawn at random first."""
    jms = jmodel.model_static(jc, jg.num_features, c)
    state_np = jax.tree.map(np.asarray, j_init_train_state(jax.random.PRNGKey(jc.seed), jms,
                                                           jg.num_nodes))
    if bn_seed is not None:
        rng = np.random.RandomState(bn_seed)
        bn = state_np.bn_state
        for l in range(len(bn.mean)):
            bn.mean[l] = rng.randn(*bn.mean[l].shape).astype(np.float32)
            bn.var[l] = (0.5 + rng.rand(*bn.var[l].shape)).astype(np.float32)
    tms = tmodel.model_static(tc, tg.num_features, c, torch.device("cpu"))
    return jms, jax.tree.map(jnp.asarray, state_np), tms, state_from_numpy(state_np, tms, LR,
                                                                             "cpu")


@pytest.mark.parametrize("conv,skip", [("GCN", True), ("SAGE", False), ("SAGE", True),
                                       ("GAT", True)])
def test_full_graph_inference_matches_jax(conv, skip):
    """The COO forward and the whole plain conv stack (fc_sage left out, BN in
    eval mode with random running statistics, GAT as plain SpMM) on converted
    parameters; and the COO backward's dx."""
    (jc, jg, c, _), (tc, tg, _, _) = _graphs(conv_type=conv, skip=skip, num_layers=3)
    jms, jstate, tms, tstate = _converted_state(jc, tc, jg, tg, c, bn_seed=1)
    je = jspmm.make_edges(*jg.coo(), jg.num_nodes)
    te = tspmm.make_edges(*tg.coo(), tg.num_nodes).to("cpu")
    x = np.random.RandomState(2).randn(jg.num_nodes, 16).astype(np.float32)
    _close(tspmm.spmm(te, torch.as_tensor(x)), jspmm.spmm(je, jnp.asarray(x)), RTOL_SUM, "spmm")
    ref = jmodel.full_graph_inference(jstate.params, jstate.bn_state, jms, jnp.asarray(jg.x), je)
    out = tmodel.full_graph_inference(tstate.model, tstate.bn_state, tms, torch.as_tensor(tg.x),
                                      te)
    _close(out, ref, RTOL_SUM, "full_graph_inference")
    # the COO backward (training on spmm_backend='coo'): dx against jax.grad
    g = np.random.RandomState(3).randn(jg.num_nodes, 16).astype(np.float32)
    ref_dx = jax.grad(lambda xx: jnp.sum(jspmm.spmm(je, xx) * g))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (dx,) = torch.autograd.grad((tspmm.spmm(te, xt) * torch.as_tensor(g)).sum(), xt)
    _close(dx, ref_dx, RTOL_SUM, "COO dx")


def test_full_graph_predict_matches_jax():
    """One trained epoch from one state (GCN B + B', cluster sampler), then
    the exact full-graph prediction of each trainer.  BN off, as in
    tests/test_torch_port_cli.py::test_fit_matches_jax (the bias feeding BN
    moves on round-off); test_full_graph_inference_matches_jax holds the
    eval-mode BN."""
    kw = dict(conv_type="GCN", skip=True, bn_flag=False, sampler_type="cluster", num_parts=8,
              batch_size=3, test_batch_size=4, vq_backend="xla")
    (jc, jg, c, jci), (tc, tg, _, tci) = _graphs(**kw)
    jtr = JNodeTrainer(jg, jc, c, cluster_indices=jci)
    tr = NodeTrainer(tg, tc, c, tci, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    for t in (jtr, tr):
        t.run_init_sweep()
        t.train_epoch(1)
    _close(tr.full_graph_predict(), jtr.full_graph_predict(), RTOL_STEP, "full_graph_predict")


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------
def test_diagnostics_match_jax():
    """The four functions of utils/diagnostics.py on one VQ state (the JAX
    package's after an init sweep, carried over) and, for the churn, a copy
    with a fifth of its assignments redrawn."""
    (jc, jg, c, jci), _ = _graphs(conv_type="GCN", sampler_type="cluster", num_parts=8,
                                  batch_size=3, test_batch_size=4, vq_backend="xla")
    jtr = JNodeTrainer(jg, jc, c, cluster_indices=jci)
    jtr.run_init_sweep()
    js = jax.tree.map(np.asarray, jtr.state.vq_states[1])
    rng = np.random.RandomState(3)
    c2 = js.c_indices.copy()
    redraw = rng.rand(*c2.shape) < 0.2
    c2[redraw] = rng.randint(0, jc.num_M, redraw.sum())
    js2 = js.replace(c_indices=c2)
    ts, ts2 = (vq_state_from_numpy(s, "cpu") for s in (js, js2))
    p = jtr.ms.vq
    tp = tmodel.model_static(tcfg.Config(**{**CFG, "vq_backend": "xla"}), 16, c,
                             torch.device("cpu")).vq
    nb = js.embedding.shape[0]
    X = rng.randn(nb, 40, jc.num_D).astype(np.float32)
    idx = rng.choice(jg.num_nodes, 40, replace=False)
    pairs = [
        (jdiag.codebook_stats(js, p), tdiag.codebook_stats(ts, tp)),
        (jdiag.pairwise_codeword_distances(js, p), tdiag.pairwise_codeword_distances(ts, tp)),
        (jdiag.approximation_errors(js, p, X, idx),
         tdiag.approximation_errors(ts, tp, torch.as_tensor(X), torch.as_tensor(idx))),
        ({"churn": jdiag.assignment_churn(js, js2)}, {"churn": tdiag.assignment_churn(ts, ts2)}),
    ]
    for ref, out in pairs:
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert 0.1 < float(pairs[3][1]["churn"].mean()) < 0.3


# ---------------------------------------------------------------------------
# train/parity.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(conv_type="GCN", sampler_type="cluster", num_parts=12, batch_size=3),
    dict(conv_type="GAT", formulation="bm", sampler_type="cont", walk_length=3, num_M=1024,
         batch_size=10000, ell_K=2, skip=False, lr=1e-3),
], ids=["gcn-cluster", "gat-bm"])
def test_exact_configs_match_jax(kw):
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    for lr in (None, 0.05):
        assert (dataclasses.asdict(tparity.exact_config(tc, 3000, lr=lr))
                == dataclasses.asdict(jparity.exact_config(jc, 3000, lr=lr)))
    assert (dataclasses.asdict(tparity.exact_mb_config(tc, 3000))
            == dataclasses.asdict(jparity.exact_mb_config(jc, 3000)))


def _tool(name):
    """A script of tools/ as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convergence_suite_matches_the_jax_tests(monkeypatch):
    """The suite of tests/test_parity_convergence.py in its two copies:
    tools/parity_convergence_jax.py (the JAX package's readings) and the
    port's tools/parity_experiment_torch.py (chip_smoke.py's phase 10a).
    Each of the test file's cases, run with a stand-in parity_gap, shows the
    config, epochs, evaluation period and arms it trains, and, fed results
    just inside and just outside the tool's floor and epsilon, that its
    assertions are the tool's bounds.  The port's copy has the same graph
    and the same fields."""
    import test_parity_convergence as jt

    jtool, ttool = _tool("parity_convergence_jax"), _tool("parity_experiment_torch")
    want = jtool.cases()
    seen = {}

    def run(name, ctrl, vq):
        """The test of ``name`` with the stand-in's arms at ctrl and vq:
        whether its assertions hold."""
        def parity_gap(graph_fn, cfg, epochs, eval_every, arms="both"):
            seen[name] = (cfg, epochs, eval_every, arms)
            arm = {"test_at_best_valid": ctrl}
            return {"exact": arm, "exact_mb": arm, "vq": {"test_at_best_valid": vq}}

        monkeypatch.setattr(jt, "parity_gap", parity_gap)
        try:
            if name in jt.CONFIGS:
                jt.test_vq_matches_exact_full_graph(name)
            else:
                jt.test_bm_vq_matches_exact_minibatch_control()
        except AssertionError:
            return False
        return True

    for name, (_, _, _, _, eps, floor) in want.items():
        ctrl = floor + 0.01
        assert run(name, ctrl, ctrl - eps) and not run(name, ctrl, ctrl - eps - 1e-3), name
        assert not run(name, floor, floor) and run(name, ctrl, ctrl), name
        assert seen[name] == want[name][:4], name
    assert set(seen) == set(want) == set(jt.CONFIGS) | {"GCN-bm"}
    assert set(ttool.CONVERGENCE) == set(want)
    for name, (fields, *rest) in ttool.CONVERGENCE.items():
        jc, *jrest = want[name]
        assert dataclasses.asdict(tcfg.Config(**fields)) == dataclasses.asdict(jc), name
        assert rest == jrest, name
    (jg, jn), (tg, tn) = jt.graph_fn(), ttool.convergence_graph()
    assert jn == tn and jg.num_nodes == tg.num_nodes == jt.N == ttool.CONVERGENCE_N
    assert (jg.adj != tg.adj).nnz == 0
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(jg, f), getattr(tg, f), err_msg=f)


@pytest.mark.parametrize("form", ["bbprime", "bm-exact-mb"])
def test_train_to_acc_matches_jax(form, monkeypatch):
    """Three epochs from the JAX run's initial state, carried across (each
    trainer then runs its own init sweep): the same history, loss_cls to
    rtol 1e-4 and accuracies equal, and the same best-by-valid statistics.
    BN off, as in tests/test_torch_port_cli.py::test_fit_matches_jax."""
    kw = dict(conv_type="GCN", skip=True, bn_flag=False, vq_backend="xla",
              vq_update_mode="live", test_batch_size=300)
    if form == "bbprime":
        kw.update(sampler_type="cluster", num_parts=8, batch_size=3)
    else:
        kw.update(formulation="bm", sampler_type="cont", walk_length=2, batch_size=128)
    jc, tc = jcfg.Config(**{**CFG, **kw}), tcfg.Config(**{**CFG, **kw})
    if form != "bbprime":
        jc, tc = jparity.exact_mb_config(jc, 300), tparity.exact_mb_config(tc, 300)
    initial = {}

    class JTrainer(JNodeTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            initial["state"] = jax.tree.map(np.asarray, self.state)

    class TTrainer(NodeTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.state = state_from_numpy(initial["state"], self.ms, self.cfg.lr, "cpu")

    monkeypatch.setattr(jparity, "NodeTrainer", JTrainer)
    monkeypatch.setattr(tparity, "NodeTrainer", TTrainer)

    def graph_fn(data):
        return lambda: data.synthetic_sbm(num_nodes=300, num_classes=5, num_features=16, seed=5)

    ref = jparity.train_to_acc(graph_fn(jdata), jc, 3)
    out = tparity.train_to_acc(graph_fn(tdata), tc, 3, device="cpu")
    assert set(out) == set(ref)
    assert [h[0] for h in out["history"]] == [h[0] for h in ref["history"]] == [1, 2, 3]
    np.testing.assert_allclose([h[1] for h in out["history"]], [h[1] for h in ref["history"]],
                               rtol=RTOL_STEP)
    assert [h[2:] for h in out["history"]] == [h[2:] for h in ref["history"]]
    for k in ("best_valid", "test_at_best_valid", "final_test"):
        assert out[k] == ref[k], k


@pytest.mark.parametrize("arms", ["both", "all", "mb", "exact", "exact_mb", "vq"])
def test_parity_gap_arms_match_jax(arms, monkeypatch):
    """``parity_gap`` runs the same arms with the same configs and epochs as
    the JAX package's, and forms the same keys and gaps (``train_to_acc``
    replaced by a stand-in that scores each config)."""
    calls = {"jax": [], "torch": []}

    def fake(side):
        def train_to_acc(graph_fn, cfg, epochs, eval_every=1, verbose=False, diag_path=None,
                         **_):
            calls[side].append((dataclasses.asdict(cfg), epochs, eval_every, diag_path))
            acc = 0.5 + 0.1 * cfg.exact_minibatch + 0.2 * cfg.ce_only + 0.01 * len(calls[side])
            return {"best_valid": acc, "test_at_best_valid": acc, "final_test": acc,
                    "history": [(epochs, 0.0, acc, acc, acc)]}
        return train_to_acc

    monkeypatch.setattr(jparity, "train_to_acc", fake("jax"))
    monkeypatch.setattr(tparity, "train_to_acc", fake("torch"))
    kw = dict(conv_type="GCN", sampler_type="cluster", num_parts=8, batch_size=3)

    def graph_fn(data):
        return lambda: data.synthetic_sbm(num_nodes=200, num_classes=3, num_features=8, seed=0)

    args = dict(epochs=7, eval_every=2, exact_epochs=9, exact_lr=0.02, arms=arms,
                vq_diag_path="diag.jsonl")
    ref = jparity.parity_gap(graph_fn(jdata), jcfg.Config(**kw), **args)
    out = tparity.parity_gap(graph_fn(tdata), tcfg.Config(**kw), device="cpu", **args)
    assert calls["torch"] == calls["jax"] and calls["torch"]
    assert set(out) == set(ref) == {"exact", "exact_mb", "vq", "gap", "gap_mb"}
    for k in ("exact", "exact_mb", "vq"):
        assert out[k] == ref[k], k
    for k in ("gap", "gap_mb"):
        assert (np.isnan(out[k]) and np.isnan(ref[k])) or out[k] == ref[k], k


# ---------------------------------------------------------------------------
# the bf16 fold of the recovery term (VQ_GNN_REV_FOLD=fast)
# ---------------------------------------------------------------------------
def _rev_fold_case(seed=0):
    """A reverse list over 256 rows with duplicate (row, col) pairs of
    opposite sign, few codewords (so that a slot often holds several cells
    of one codeword), and one row of 2,600 cells (325 slots)."""
    rng = np.random.default_rng(seed)
    B_pad, num_N, M, nb, Dg = 256, 6000, 16, 2, 5
    rr = np.concatenate([rng.integers(0, 190, 1500), np.full(2600, 7)])
    rc = np.concatenate([rng.integers(0, num_N, 1500), rng.choice(num_N, 2600, replace=False)])
    rv = rng.normal(size=len(rr)).astype(np.float32)
    nd = len(rr) // 4
    rr, rc = np.concatenate([rr, rr[:nd]]), np.concatenate([rc, rc[:nd]])
    rv = np.concatenate([rv, -0.5 * rv[:nd]])
    c_tab = rng.integers(0, M, (num_N + 1, nb)).astype(np.int16)
    xb = rng.normal(size=(nb, B_pad, Dg)).astype(np.float32)
    al = (0.5 * rng.normal(size=(nb, B_pad))).astype(np.float32)
    arcb = (0.5 * rng.normal(size=(nb, M))).astype(np.float32)
    gbar = rng.normal(size=(nb, M, Dg)).astype(np.float32)
    return (rr, rc, rv), c_tab, xb, al, arcb, gbar, (B_pad, num_N, M, nb, Dg)


def _jax_fast(rev, c_tab, xb, al, arcb, gbar, dims, w):
    """The JAX package's rev_recovery_info(..., 'fast', interpret=True): its
    stashed accumulator S [nb, B_pad, M], info and the gradients of
    sum(info * w) in xb, al and arcb."""
    B_pad, num_N, M, nb, Dg = dims
    T_s, TB, Dp = 128, jrev.rev_tb(B_pad), 8
    d = jrev.build_rev_ell(*rev, B_pad, num_N, K=REV_K, T_s=T_s, TB=TB)
    S, P = d["slot_row"].shape[0], d["tile_of"].shape[0]
    d = jrev.pad_rev_ell(d, -(-S // T_s) * T_s, -(-P // 128) * 128, B_pad, num_N, T_s=T_s, TB=TB)
    sched = [jnp.asarray(d[k]) for k in ("slot_val", "slot_row", "tile_of", "blk_of", "flags")]
    c_flat = jnp.take(jnp.asarray(c_tab), jnp.asarray(d["slot_col"].reshape(-1)), axis=0,
                      mode="clip").astype(jnp.int32)
    gT = jnp.pad(jnp.transpose(jnp.asarray(gbar), (0, 2, 1)), ((0, 0), (0, Dp - Dg), (0, 0)))

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, Dp - Dg)))

    def j_fn(x, a_l, a_r):
        info = jrev.rev_recovery_info(c_flat, *sched, pad(x), a_l[:, :, None], a_r, gT, T_s,
                                      TB, "fast", True)
        return jnp.sum(info * jnp.asarray(w)), info

    args = [jnp.asarray(a) for a in (xb, al, arcb)]
    (_, info), grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(*args)
    _, S_g = jrev._rev_fwd_impl(c_flat, *sched, pad(args[0]), args[1][:, :, None], args[2], gT,
                                T_s=T_s, TB=TB, mode="fast", interpret=True)
    S_g = np.asarray(S_g)
    BB = S_g.shape[2] // M
    S_j = S_g.reshape(-1, B_pad, BB, M).transpose(0, 2, 1, 3).reshape(-1, B_pad, M)[:nb]
    return S_j, np.asarray(info), [np.asarray(g) for g in grads]


def _multi_cell_parts(c_tab, col, val, row, dims):
    """[nb, M, B_pad]: per (branch, codeword, row), over its slot parts of k
    >= 2 live cells (k - 1 bf16 adds, each a rounding point of at most one
    unit roundoff of a partial sum), k - 1 times the sum of their |values|."""
    B_pad, num_N, M, nb, _ = dims
    out = np.zeros((nb, M, B_pad))
    code = c_tab[np.minimum(col, num_N)]  # [S, K, nb]
    live = val != 0
    for s in np.flatnonzero((row < B_pad) & (live.sum(1) >= 2)):
        for n in range(nb):
            cs = code[s, live[s], n]
            vs = val[s, live[s]].astype(np.float64)
            for m in np.unique(cs[np.bincount(cs, minlength=M)[cs] >= 2]):
                out[n, m, row[s]] += ((cs == m).sum() - 1) * np.abs(vs[cs == m]).sum()
    return out


def test_rev_fold_fast_plain_matches_pallas():
    """The plain 'fast' fold against the JAX package's kernel in interpret
    mode.  Both round each value to bf16 (round to nearest even), so a
    codeword whose cells of a slot are one cell has the same part on both
    sides; where two or more cells of a slot meet, each add is a bf16
    rounding point, and XLA on the CPU may keep an add's result in f32
    (excess precision) where the kernel's code rounds it.  So per (branch,
    row, codeword) S may differ by one bf16 unit roundoff, 2^-8, of a
    partial sum at each add of two or more cells of a slot (bounded by the
    sum of the |values| of that slot part's cells, ``_multi_cell_parts``),
    and otherwise only by the f32 sums of the fold (1e-6 of the sum of
    |values|).  The info and its gradients
    are held to that tolerance carried through the contraction (the plain
    contraction of the tolerance grid on |xb| and |gbar|, and its
    gradients) plus 1e-5 of the sum of |terms| for their f32 sums.  A fold
    in f32 misses it: it does not round single cells."""
    rev, c_tab, xb, al, arcb, gbar, dims = _rev_fold_case()
    B_pad, num_N, M, nb, Dg = dims
    w = np.arange(1.0, nb + 1, dtype=np.float32)
    S_j, info_j, grads_j = _jax_fast(rev, c_tab, xb, al, arcb, gbar, dims, w)
    col, val, row = pad_rev_ell(*build_rev_ell(*rev, B_pad, num_N), 700, B_pad, num_N)
    assert np.bincount(row[row < B_pad]).max() >= 325  # the row of 2,600 cells and more
    t = [torch.as_tensor(a) for a in (c_tab, col, val, row)]
    grid = rev_kernels.rev_grid_plain(*t, nb, B_pad, M, fold="fast")  # [nb, M, B_pad]
    abs_parts = rev_kernels.rev_grid_plain(t[0], t[1], t[2].abs(), t[3], nb, B_pad, M)
    tol_S = (2.0**-8 * _multi_cell_parts(c_tab, col, val, row, dims)
             + 1e-6 * abs_parts.double().numpy())
    d_S = np.abs(grid.numpy() - S_j.transpose(0, 2, 1))
    assert (d_S <= tol_S).all(), float((d_S / np.maximum(tol_S, 1e-30)).max())
    assert (d_S > 0).any() and (tol_S > 1e-6 * abs_parts.numpy()).any()

    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (xb, al, arcb)]
    info = rev_kernels.rev_recovery_info_plain(*t, *leaves, torch.as_tensor(gbar), fold="fast")
    grads = torch.autograd.grad((info * torch.as_tensor(w)).sum(), leaves)

    def carried(grid_abs):
        """info and gradients of the contraction on |xb|, |gbar| and a
        non-negative grid: the bounds of a change of the grid by grid_abs."""
        lv = [torch.as_tensor(np.abs(xb)).requires_grad_(True),
              torch.as_tensor(al).requires_grad_(True),
              torch.as_tensor(arcb).requires_grad_(True)]
        i = rev_kernels.rev_contract_plain(grid_abs, *lv, torch.as_tensor(np.abs(gbar)))
        return [i.detach().numpy(),
                *[g.numpy() for g in torch.autograd.grad((i * torch.as_tensor(w)).sum(), lv)]]

    bound_S = carried(torch.as_tensor(tol_S, dtype=torch.float32))
    bound_f32 = carried(abs_parts)
    for name, o, r, bs, bf in zip(("info", "d_xb", "d_al", "d_arcb"),
                                  (info.detach(), *grads), (info_j, *grads_j), bound_S,
                                  bound_f32):
        d = np.abs(o.numpy() - r)
        tol = bs + 1e-5 * bf + 1e-6
        print(f"fast fold {name}: max|diff| {d.max():.3g}, max|ref| {np.abs(r).max():.3g}, "
              f"{(d / tol).max():.3f} of the tolerance")
        assert (d <= tol).all(), (name, float((d / tol).max()))
