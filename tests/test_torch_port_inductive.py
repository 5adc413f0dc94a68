"""The port's inductive multilabel training (the three-split datasets,
``masked_bce``, micro-F1, ``NodeTrainer(val_graph=, test_graph=)``,
``eval_assign_step`` and ``tools/inductive_experiment_torch.py``) against the
JAX package on the CPU, at a small size (2 layers x 16, num_M = 8, a few
hundred nodes).

Tolerances: host arrays (graphs, batches) and int tables exactly; losses to
rtol 1e-4 and gradients and states to atol 1e-5 (f32 sums in another
order, one step from one carried state); eval outputs to atol 1e-5, times
the largest |output| where that exceeds 1 (the stochastic eval on another
graph reads codewords at up to ~1e4 here, where f32 resolves 1e-3); the
micro-F1 values equal.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.train import step as jstep
from vq_gnn_tpu.train.loop import NodeTrainer as JNodeTrainer
from vq_gnn_tpu.utils import metrics as jmetrics
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.train import step as tstep
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)
import inductive_experiment as jtool  # noqa: E402
import inductive_experiment_torch as ttool  # noqa: E402

LR = 0.005
RTOL_LOSS = 1e-4
ATOL_GRAD = 1e-5
ATOL_OUT = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _cfg_kw(**kw):
    base = dict(dataset="synthetic_inductive", conv_type="GCN", num_layers=2,
                hidden_channels=16, num_D=4, num_M=8, batch_size=128, test_batch_size=0,
                skip=True, pad_multiple_nodes=64, pad_multiple_edges=512, lr=LR,
                vq_backend="xla")
    base.update(kw)
    return base


def _graph_close(tg, jg):
    assert (tg.adj != jg.adj).nnz == 0 and tg.adj.dtype == jg.adj.dtype
    for name in ("x", "y", "train_mask", "val_mask", "test_mask", "deg", "deg_inv"):
        a, b = getattr(tg, name), getattr(jg, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _trainers(kw, nodes=300, seed=0):
    """The JAX NodeTrainer and the port's on the same three split graphs,
    the port starting from the JAX trainer's state."""
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    jgs, c = jdata.synthetic_inductive(num_nodes=nodes, seed=seed)
    jtr_g, jval, jtest, c = jdata.prepare_inductive(jgs, jc, c)
    tgs, _ = tdata.synthetic_inductive(num_nodes=nodes, seed=seed)
    ttr_g, tval, ttest, _ = tdata.prepare_inductive(tgs, tc, c)
    jtr = JNodeTrainer(jtr_g, jc, c, val_graph=jval, test_graph=jtest)
    tr = NodeTrainer(ttr_g, tc, c, device="cpu", val_graph=tval, test_graph=ttest)
    assert jtr.multilabel and tr.multilabel and not tr.use_ogb_acc and tr.inductive
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    return jtr, tr


# ---------------- metrics ----------------
@pytest.mark.parametrize("kind", ["multilabel", "single", "masked", "empty"])
def test_micro_f1_and_accuracy_match_jax(kind):
    rng = np.random.RandomState(2)
    logits = rng.randn(200, 7).astype(np.float32)
    y = (rng.rand(200, 7) < 0.3).astype(np.float32) if kind in ("multilabel", "empty") \
        else rng.randint(0, 7, 200)
    mask = rng.rand(200) < 0.5 if kind == "masked" else None
    if kind == "empty":
        logits = -np.abs(logits)  # no positive prediction: F1 0
    assert tmetrics.micro_f1(logits, y, mask) == jmetrics.micro_f1(logits, y, mask)
    if y.ndim == 1:
        assert tmetrics.accuracy(logits, y, mask) == jmetrics.accuracy(logits, y, mask)


# ---------------- datasets ----------------
def test_synthetic_inductive_and_prepare_match_jax():
    for kw in (dict(num_nodes=300, seed=0), dict(num_nodes=200, num_classes=4,
                                                num_features=8, multilabel=False, seed=3)):
        jgs, jc = jdata.synthetic_inductive(**kw)
        tgs, tc = tdata.synthetic_inductive(**kw)
        assert tc == jc and len(tgs) == 3
        for a, b in zip(tgs, jgs):
            _graph_close(a, b)
        for conv, form in (("GCN", "bbprime"), ("GAT", "bm")):
            cfg = dict(conv_type=conv, formulation=form, num_D=4, hidden_channels=16)
            jp = jdata.prepare_inductive(
                [dataclasses.replace(g) for g in jgs], jcfg.Config(**cfg), jc)
            tp = tdata.prepare_inductive(
                [dataclasses.replace(g) for g in tgs], tcfg.Config(**cfg), tc)
            assert tp[-1] == jp[-1]
            for a, b in zip(tp[:3], jp[:3]):
                _graph_close(a, b)
    with pytest.raises(NotImplementedError, match="cluster sampler on inductive datasets"):
        tdata.prepare_inductive(tgs, tcfg.Config(sampler_type="cluster"), tc)


def _write_ppi(path):
    """The converter's ppi format (tests/test_inductive.py): two graphs
    merged in the train split."""
    arrays = {"num_classes": 4}
    rng = np.random.RandomState(0)
    for split, sizes in [("train", (80, 60)), ("val", (50,)), ("test", (50,))]:
        eis, xs, ys, off = [], [], [], 0
        for n in sizes:
            eis.append(rng.randint(0, n, size=(2, 4 * n)) + off)
            xs.append(rng.randn(n, 8).astype(np.float32))
            y = np.zeros((n, 4), np.float32)
            y[np.arange(n), rng.randint(0, 4, n)] = 1.0
            ys.append(y)
            off += n
        arrays[f"{split}_edge_index"] = np.concatenate(eis, axis=1)
        arrays[f"{split}_x"] = np.concatenate(xs)
        arrays[f"{split}_y"] = np.concatenate(ys)
    np.savez(path, **arrays)


def test_load_inductive_npz_and_dispatch_match_jax(tmp_path):
    _write_ppi(tmp_path / "ppi.npz")
    jgs, jc = jdata.load_inductive_npz(str(tmp_path / "ppi.npz"))
    tgs, tc = tdata.load_inductive_npz(str(tmp_path / "ppi.npz"))
    assert tc == jc == 4
    for a, b in zip(tgs, jgs):
        _graph_close(a, b)
    kw = _cfg_kw(dataset="ppi", data_root=str(tmp_path))
    jp = jdata.get_inductive_data(jcfg.Config(**kw))
    tp = tdata.get_inductive_data(tcfg.Config(**kw))
    assert tp[-1] == jp[-1] and tp[0].num_nodes == 140 and tp[0].train_mask.all()
    for a, b in zip(tp[:3], jp[:3]):
        _graph_close(a, b)
    for name in ("ppi", "synthetic_inductive:120"):
        missing = _cfg_kw(dataset=name, data_root=str(tmp_path / "none"), seed=2)
        if name == "ppi":
            with pytest.raises(FileNotFoundError) as je:
                jdata.get_inductive_data(jcfg.Config(**missing))
            with pytest.raises(FileNotFoundError, match="tools/convert_dataset.py") as te:
                tdata.get_inductive_data(tcfg.Config(**missing))
            assert str(te.value) == str(je.value)
        else:
            jp = jdata.get_inductive_data(jcfg.Config(**missing))
            tp = tdata.get_inductive_data(tcfg.Config(**missing))
            assert tp[0].num_nodes == 120 and tp[1].num_nodes == 60
            for a, b in zip(tp[:3], jp[:3]):
                _graph_close(a, b)
    assert tdata.is_inductive(tcfg.Config(dataset="cluster"))
    assert not tdata.is_inductive(tcfg.Config(dataset="synthetic:300"))


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_inductive_tool_builders_match_jax(conv):
    """tools/inductive_experiment_torch.py: the three graphs and the
    configuration of the JAX tool at a small ``scale``, and at full scale."""
    for a, b in zip(ttool.build_graphs(7, 0.01), jtool.build_graphs(7, 0.01)):
        _graph_close(a, b)
    for scale in (0.01, 1.0):
        assert dataclasses.asdict(ttool.vq_cfg(conv, 5, scale)) == dataclasses.asdict(
            jtool.vq_cfg(conv, 5, scale))
    assert ttool.vq_cfg(conv, 5).num_M == 4096


# ---------------- the loss and one multilabel step ----------------
def test_masked_bce_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(100, 9) * 4).astype(np.float32)
    y = (rng.rand(100, 9) < 0.3).astype(np.float32)
    for mask in (rng.rand(100) < 0.6, np.zeros(100, bool)):
        ref = float(jstep.masked_bce(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask)))
        out = float(tstep.masked_bce(torch.as_tensor(logits), torch.as_tensor(y),
                                     torch.as_tensor(mask)))
        np.testing.assert_allclose(out, ref, rtol=RTOL_LOSS)


def test_multilabel_step_matches_jax(monkeypatch):
    """One multilabel train step from one carried state: loss_cls (BCE),
    loss, every gradient and the VQ states after the live update.  BN off
    (see tests/test_torch_port_slice.py)."""
    jtr, tr = _trainers(_cfg_kw(bn_flag=False))
    tr.run_init_sweep()
    jtr.run_init_sweep()
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    jb = jax.tree.map(jnp.asarray, next(jtr.train_loader._epoch_iter())[0][0])
    tb = next(iter(tr.train_loader))[0][0]
    np.testing.assert_array_equal(tb.batch_idx.numpy(), np.asarray(jb.batch_idx))
    assert tb.y.dtype == torch.float32 and tb.y.shape == jb.y.shape
    np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
    grads = []
    real = tstep.rmsprop_update
    # the JAX step hands its gradients out in place of the new parameters;
    # the port's records them
    monkeypatch.setattr(jstep, "rmsprop_update", lambda p, g, nu, lr, do: (g, nu))
    monkeypatch.setattr(tstep, "rmsprop_update", lambda opt, ps, gs, lr, do: (
        grads.append([g.detach().clone() for g in gs]), real(opt, ps, gs, lr, do)))
    fns = jstep.make_step_fns(jtr.ms, jtr.cfg, multilabel=True)
    jst, jm = fns.train_step(jtr.state, jtr.X_dev, jb, jnp.float32(1.0), jnp.float32(LR),
                             jnp.float32(1.0), jax.random.PRNGKey(0))
    tst, tm = tr.fns.train_step(tr.state, tr.X_dev, tb, 1.0, LR, 1.0)
    for k in ("loss", "loss_cls", "info_backward"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL_LOSS, atol=1e-7,
                                   err_msg=k)
    assert float(tm["train_acc"]) == float(jm["train_acc"]) == 0.0
    params = list(tst.model.named_parameters())
    assert len(grads) == 1 and len(grads[0]) == len(params)
    for (pname, _), g in zip(params, grads[0]):
        _, l, rest = pname.split(".", 2)
        name, _, key = rest.partition(".")
        ref = jst.params[int(l)][name]
        ref = np.asarray(ref[{"weight": "w", "bias": "b"}[key]] if key else ref)
        np.testing.assert_allclose(g.numpy(), ref.T if key == "weight" else ref,
                                   atol=ATOL_GRAD, err_msg=pname)
    N = tr.graph.num_nodes
    for js, ts in zip(jst.vq_states, tst.vq_states):
        for f in ("embedding", "embedding_output", "ema_cluster_size", "ema_w",
                  "bn_feat_mean", "bn_feat_var", "bn_grad_mean", "bn_grad_var"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=ATOL_GRAD, err_msg=f)
        np.testing.assert_array_equal(ts.c_indices.numpy()[:N], np.asarray(js.c_indices)[:N])


# ---------------- evaluation ----------------
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_eval_assign_step_matches_jax(backend):
    """``evaluate_split_stochastic``'s step on the validation graph in
    batches of 40, after the JAX init sweep and one epoch, carried over: each
    batch's output to atol 1e-5 (of its scale) and the per-split tables ([N + 1, nb] int16)
    exactly after every batch, on the exact CPU path ('xla'; 'pallas': the
    kernels' plain versions against the JAX kernels in interpret mode)."""
    jtr, tr = _trainers(_cfg_kw(vq_backend=backend))
    jtr.run_init_sweep()
    jtr.train_epoch(1)
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    from vq_gnn_tpu.sampler.samplers import BatchLoader as JLoader
    from vq_gnn_tpu.train.loop import device_features as jfeat
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
    from vq_gnn_tpu_torch.train.loop import device_features

    jg, tg = jtr.val_graph, tr.val_graph
    jl = JLoader(jg, jtr.cfg, train_flag=False, sampler_type="node", batch_size=40,
                 shuffle=False, seed=jtr.cfg.seed + 7)
    tl = BatchLoader(tg, tr.cfg, train_flag=False, sampler_type="node", batch_size=40,
                     shuffle=False, seed=tr.cfg.seed + 7, device="cpu")
    jX, tX = jfeat(jg.x), device_features(tg.x, "cpu")
    nbs = tr.ms.num_branches
    jt = [jnp.zeros((jg.num_nodes + 1, nb), jnp.int16) for nb in nbs]
    tt = [torch.zeros((tg.num_nodes + 1, nb), dtype=torch.int16) for nb in nbs]
    outs = []
    for (jw, _), (tw, raw) in zip(jl._epoch_iter(), tl):
        jout, jt = jtr.fns.eval_assign_step(jtr.state, jt, jX, jax.tree.map(jnp.asarray, jw[0]))
        tout, tt = tr.fns.eval_assign_step(tr.state, tt, tX, tw[0])
        ref = np.asarray(jout)
        np.testing.assert_allclose(tout.numpy(), ref,
                                   atol=ATOL_OUT * max(1.0, float(np.abs(ref).max())))
        for a, b in zip(tt, jt):
            assert a.dtype == torch.int16
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        outs.append(tout[: len(raw[0])].numpy())
    assert len(outs) == -(-tg.num_nodes // 40)
    # the trainer's own call walks the same batches into fresh tables
    np.testing.assert_allclose(tr.evaluate_split_stochastic(tg, 40), np.concatenate(outs))
    # the codebooks and the training tables are left as they were
    for js, ts in zip(jtr.state.vq_states, tr.state.vq_states):
        np.testing.assert_array_equal(ts.c_indices.numpy(), np.asarray(js.c_indices))


def test_inductive_evaluate_matches_jax():
    """The three micro-F1 values (each split graph one full batch), from one
    carried state after one epoch, equal; with ``use_ogb_acc`` the
    transductive path's accuracy is replaced by micro-F1 as in JAX."""
    jtr, tr = _trainers(_cfg_kw())
    jtr.run_init_sweep()
    jtr.train_epoch(1)
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    res, ref = tr.evaluate(), jtr.evaluate()
    assert len(res) == 3 and res == ref, (res, ref)
    assert all(0.0 <= r <= 1.0 for r in res)


# ---------------- a short run that learns (tests/test_inductive.py's floors) ----------------
def test_inductive_run_learns_on_the_cpu():
    kw = _cfg_kw(lr=0.01)
    tc = tcfg.Config(**kw)
    gs, c = tdata.synthetic_inductive(num_nodes=300, multilabel=True, seed=0)
    tr_g, val_g, test_g, c = tdata.prepare_inductive(gs, tc, c)
    tr = NodeTrainer(tr_g, tc, c, device="cpu", val_graph=val_g, test_graph=test_g)
    tr.run_init_sweep()
    losses = [tr.train_epoch(epoch)[1] for epoch in range(1, 6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    res = tr.evaluate()
    assert len(res) == 3 and all(0.0 <= r <= 1.0 for r in res)
    outs = tr.evaluate_split_stochastic(val_g, batch_size=40)
    assert outs.shape == (val_g.num_nodes, c) and np.isfinite(outs).all()
