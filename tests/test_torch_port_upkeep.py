"""The port's upkeep modules against the JAX package on the CPU, at the size of
tests/test_checkpoint.py (a 300-node SBM, 2 layers x 16, num_D = 4,
num_M = 8):

- checkpoints (``train/checkpoint.py``, ``convert.state_to_numpy``): the
  archive's names, order, shapes and dtypes equal the JAX package's; an
  archive of either package restores in the other bit for bit; the five
  tests of tests/test_checkpoint.py on the port; ``fit`` resumes in both
  trainers, and a JAX archive resumes in both packages alike;
- ``kmeans_init`` (``feature_kmeans_init``, ``NodeTrainer.seed_kmeans``)
  from one numpy RNG seed; the named ImportError without scikit-learn;
- ``vq_backend='scan'`` (``ops/vq_ops.assign_stats_scan``), alone, in
  ``vq_update`` and in a training epoch;
- the STE quantizer and the lr schedules;
- the batch cache (``train/loop.iter_cached``);
- ``--ckpt-dir``, ``--resume`` and ``--kmeans-init`` through
  ``main_node_torch.py``, the resumed run against ``main_node.py``'s.

Tolerances: archive leaves bit for bit; eval logits to atol 1e-4 and the
accuracies equal, as tests/test_torch_port_slice.py; per-epoch losses to
rtol 1e-4 (f32 sums in another order); VQ statistics to atol 1e-5, as
tests/test_torch_port_vq.py; the k-means of a hidden layer, whose input
differs from the JAX package's by f32 round-off, to 99 % of its labels and
its centroids to atol 1e-3.
"""

import dataclasses
import math
import os
import sys
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import vq as jvq
from vq_gnn_tpu.ops import vq_ops as jvq_ops
from vq_gnn_tpu.train import checkpoint as jckpt
from vq_gnn_tpu.train.loop import NodeTrainer as JNodeTrainer
from vq_gnn_tpu.utils import scheduler as jsched
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy, state_to_numpy, vq_state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import vq as tvq
from vq_gnn_tpu_torch.ops import vq_ops as tvq_ops
from vq_gnn_tpu_torch.train import checkpoint as tckpt
from vq_gnn_tpu_torch.train.loop import NodeTrainer, iter_cached
from vq_gnn_tpu_torch.utils import scheduler as tsched
import main_node  # noqa: E402  (the repo root is on sys.path, see conftest)
import main_node_torch  # noqa: E402
from tests import test_torch_port_link as link_tests
from tests import test_torch_port_vq as vq_tests
from tests._torch_threads import one_thread  # noqa: F401
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)
pytestmark = pytest.mark.usefixtures("one_thread")

LR = 0.01
ATOL_LOGITS = 1e-4
RTOL_STEP = 1e-4
ATOL_VQ = 1e-5
ATOL_CENTROIDS = 1e-3
SMALL = dict(dataset="synthetic", num_layers=2, hidden_channels=16, num_D=4, num_M=8,
             batch_size=128, test_batch_size=256, pad_multiple_nodes=64,
             pad_multiple_edges=512, vq_backend="xla", lr=LR)
# tests/test_torch_port_cli.py's one-epoch CLI run on the CPU
CLI_ARGS = ["--dataset", "synthetic:300", "--num-layers", "2", "--hidden-channels", "16",
            "--num-M", "8", "--batch-size", "128", "--test-batch-size", "256", "--epochs", "1",
            "--device", "cpu"]
CONFIGS = {
    "GCN": dict(conv_type="GCN"),
    "SAGE": dict(conv_type="SAGE", skip=True),
    "GAT": dict(conv_type="GAT"),
    "bm-GCN-transformer": dict(formulation="bm", transformer_flag=True, sampler_type="cont",
                               walk_length=2),
}


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


def _graphs(**kw):
    cfg = {**SMALL, **kw}
    jc, tc = jcfg.Config(**cfg), tcfg.Config(**cfg)
    jg, c = jdata.synthetic_sbm(num_nodes=300, num_features=16, seed=8)
    jg, c, jci = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=300, num_features=16, seed=8)
    tg, _, tci = tdata.prepare(tg, tc, c)
    return jc, tc, (jg, c, jci), (tg, c, tci)


def _trainers(carry=True, **kw):
    """A JAX NodeTrainer and the port's on the same graph, the port's state
    carried over from the JAX trainer's (``carry``)."""
    jc, tc, (jg, c, jci), (tg, _, tci) = _graphs(**kw)
    jtr = JNodeTrainer(jg, jc, c, cluster_indices=jci)
    tr = NodeTrainer(tg, tc, c, tci, device="cpu")
    if carry:
        tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")
    return jtr, tr


def _port_trainer(**kw):
    _, tc, _, (tg, c, tci) = _graphs(**kw)
    return NodeTrainer(tg, tc, c, tci, device="cpu")


def _assert_leaves_equal(a_named, b_named):
    """Two [(name, leaf)] lists: the same names in the same order, each leaf
    the same dtype, shape and bits."""
    assert [n for n, _ in a_named] == [n for n, _ in b_named]
    for (name, a), (_, b) in zip(a_named, b_named):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def vq_state_from_jax(s):
    return vq_state_from_numpy(jax.tree.map(np.asarray, s), "cpu")


def _port_named(tree):
    return [(n, tckpt._numpy(leaf)) for n, leaf in tckpt.named_leaves(tree)]


def _assert_evaluations_match(jtr, tr):
    np.testing.assert_allclose(tr.predict_all(), jtr.predict_all(), atol=ATOL_LOGITS)
    np.testing.assert_allclose(tr.evaluate(), jtr.evaluate())


# ---------------- the archive's names and layouts ----------------
@pytest.mark.parametrize("name", list(CONFIGS) + ["link"])
def test_archive_names_match_jax(name):
    """The port's archive names, in order, with the JAX package's shapes and
    dtypes (``_named_leaves``), for each model and the link tree; and
    ``state_from_numpy(state_to_numpy(s))`` is the identity, bit for bit."""
    if name == "link":
        jtr, tr = link_tests._trainers(link_tests._cfg_kw(), nodes=200)
        jtree, ttree = jtr._ckpt_tree(), tr._ckpt_tree()
    else:
        jtr, tr = _trainers(**CONFIGS[name])
        jtree, ttree = jtr.state, tr.state
    j_named = [(n, np.asarray(leaf)) for n, leaf in jckpt._named_leaves(jtree)]
    _assert_leaves_equal(_port_named(ttree), j_named)
    back = state_from_numpy(state_to_numpy(tr.state), tr.ms, LR, "cpu")
    _assert_leaves_equal(_port_named(back), _port_named(tr.state))
    assert back.model is not tr.state.model


# ---------------- an archive of either package restores in the other ----------------
def test_jax_archive_restores_in_the_port(tmp_path):
    """A JAX trainer's archive after one epoch: every leaf restores into the
    port bit for bit (after the layout change), and the port's evaluation
    equals the JAX trainer's."""
    jtr, tr = _trainers(carry=False)
    jtr.run_init_sweep()
    jtr.train_epoch(1)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jtr.state, step=1)
    tr.state = tckpt.restore_checkpoint(path, tr.state)
    with np.load(path) as z:
        archive = [(k[len("leaf:"):], z[k]) for k in z.files if k.startswith("leaf:")]
    _assert_leaves_equal(_port_named(tr.state), archive)
    assert tr.state.step == int(jtr.state.step) and tckpt.load_step(path) == 1
    _assert_evaluations_match(jtr, tr)


def test_port_archive_restores_in_jax(tmp_path):
    """The port trains one epoch from the carried state and saves; the JAX
    package's own restore_checkpoint loads the archive into its template bit
    for bit, and its evaluation equals the port's."""
    jtr, tr = _trainers()
    tr.run_init_sweep()
    tr.train_epoch(1)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, tr.state, step=1)
    jtr.state = jckpt.restore_checkpoint(path, jtr.state)
    _assert_leaves_equal([(n, np.asarray(leaf)) for n, leaf in jckpt._named_leaves(jtr.state)],
                         _port_named(tr.state))
    assert jckpt.load_step(path) == 1
    _assert_evaluations_match(jtr, tr)


# ---------------- tests/test_checkpoint.py on the port ----------------
def test_checkpoint_roundtrip_and_resume(tmp_path):
    tr = _port_trainer(vq_update_mode="live")
    tr.run_init_sweep()
    tr.train_epoch(1)
    path = os.path.join(tmp_path, "ckpt.npz")
    tckpt.save_checkpoint(path, tr.state, step=tr.state.step)
    tr2 = _port_trainer(vq_update_mode="live")
    restored = tckpt.restore_checkpoint(path, tr2.state)
    _assert_leaves_equal(_port_named(restored), _port_named(tr.state))
    tr2.state = restored
    np.testing.assert_allclose(tr.evaluate(), tr2.evaluate())
    # training on from the restored state matches the original trainer's
    tr2.train_loader._epoch = tr.train_loader._epoch
    assert tr.train_epoch(2) == tr2.train_epoch(2)
    _assert_leaves_equal(_port_named(tr2.state), _port_named(tr.state))


def test_named_leaves_survive_reordering(tmp_path):
    """A template that flattens in another order restores each leaf to its
    own name; the leaves land on the template's kind (tensor or array)."""
    path = os.path.join(tmp_path, "named.npz")
    a, b = np.arange(4.0), np.arange(4.0) * 10
    tckpt.save_checkpoint(path, {"alpha": a, "beta": torch.as_tensor(b)})
    out = tckpt.restore_checkpoint(
        path, OrderedDict([("beta", torch.zeros(4, dtype=torch.float64)),
                           ("alpha", np.zeros(4))]))
    assert list(out) == ["beta", "alpha"] and isinstance(out["beta"], torch.Tensor)
    np.testing.assert_array_equal(out["alpha"], a)
    np.testing.assert_array_equal(out["beta"].numpy(), b)
    # the JAX package reads the same archive
    jout = jckpt.restore_checkpoint(path, {"alpha": np.zeros(4), "beta": np.zeros(4)})
    np.testing.assert_array_equal(jout["beta"], b)


def test_named_restore_rejects_path_mismatch(tmp_path):
    path = os.path.join(tmp_path, "named.npz")
    tckpt.save_checkpoint(path, {"alpha": np.zeros(4)})
    with pytest.raises(ValueError, match="gamma") as e:
        tckpt.restore_checkpoint(path, {"gamma": np.zeros(4)})
    assert "alpha" in str(e.value)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"alpha": np.zeros(5)})


def test_legacy_order_archive_restores(tmp_path):
    path = os.path.join(tmp_path, "legacy.npz")
    leaves = [np.arange(3.0), np.ones((2, 2))]
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    out = tckpt.restore_checkpoint(path, {"b": np.zeros((2, 2)), "a": np.zeros(3)})
    np.testing.assert_array_equal(out["a"], leaves[0])
    np.testing.assert_array_equal(out["b"], leaves[1])
    assert tckpt.load_step(path) == 0


def test_fit_ckpt_resume(tmp_path, capsys):
    tr = _port_trainer(epochs=3)
    tr.fit(ckpt_dir=str(tmp_path), ckpt_every=1, verbose=False)
    assert sorted(os.listdir(tmp_path)) == ["run0.npz"]
    assert tckpt.load_step(str(tmp_path / "run0.npz")) == 3
    # a fresh trainer resumes past epoch 3: no epochs left
    tr2 = _port_trainer(epochs=3)
    tr2.fit(ckpt_dir=str(tmp_path), resume=True)
    assert f"resumed from {tmp_path / 'run0.npz'} at epoch 4" in capsys.readouterr().out
    assert tr2.logger.results == [[]]
    np.testing.assert_allclose(tr.evaluate(), tr2.evaluate())
    _assert_leaves_equal(_port_named(tr2.state), _port_named(tr.state))


def test_link_fit_ckpt_resume(tmp_path, capsys):
    """The link trainer saves before its evaluation, under the JAX tree;
    a fresh trainer resumes with its state, predictor and nu bit for bit,
    and the JAX link trainer restores the same archive."""
    kw = link_tests._cfg_kw(epochs=2)
    jtr, tr = link_tests._trainers(kw, nodes=200)
    tr.fit(verbose=False, ckpt_dir=str(tmp_path), ckpt_every=2)
    path = str(tmp_path / "link_run0.npz")
    assert tckpt.load_step(path) == 2
    _, tr2 = link_tests._trainers(kw, nodes=200)
    tr2.fit(ckpt_dir=str(tmp_path), resume=True)
    assert f"resumed from {path} at epoch 3" in capsys.readouterr().out
    _assert_leaves_equal(_port_named(tr2._ckpt_tree()), _port_named(tr._ckpt_tree()))
    assert tr2.predictor is not tr.predictor
    restored = jckpt.restore_checkpoint(path, jtr._ckpt_tree())
    _assert_leaves_equal([(n, np.asarray(x)) for n, x in jckpt._named_leaves(restored)],
                         _port_named(tr._ckpt_tree()))


def test_resume_matches_jax(tmp_path):
    """A JAX fit of 2 epochs writes its archive; a fresh JAX trainer and a
    fresh port trainer each resume it for a third epoch (dropout off, BN off
    as in test_fit_matches_jax of tests/test_torch_port_cli.py) and end with
    the same results."""
    jc, _, (jg, c, jci), _ = _graphs(epochs=2, bn_flag=False)
    JNodeTrainer(jg, jc, c, cluster_indices=jci).fit(
        ckpt_dir=str(tmp_path), ckpt_every=1, verbose=False)
    jtr, tr = _trainers(carry=False, epochs=3, bn_flag=False)
    js = jtr.fit(ckpt_dir=str(tmp_path), resume=True, verbose=False)
    ts = tr.fit(ckpt_dir=str(tmp_path), resume=True, verbose=False)
    assert len(tr.logger.results[0]) == len(jtr.logger.results[0]) == 1
    assert ts == js
    _assert_evaluations_match(jtr, tr)


# ---------------- kmeans_init ----------------
def test_feature_kmeans_init_matches_jax():
    """tests/test_diagnostics.py:test_kmeans_init_seeds_state on both
    packages from one numpy seed: bit-equal states."""
    p_j, p_t = jvq.VQParams(num_M=4, num_D=4), tvq.VQParams(num_M=4, num_D=4)
    s = jvq.init_vq_state(jax.random.PRNGKey(1), 2, 50, p_j)
    X = np.random.RandomState(0).randn(2, 40, 4).astype(np.float32)
    np.random.seed(3)
    s_j = jvq.feature_kmeans_init(s, X, np.arange(40), p_j)
    np.random.seed(3)
    s_t = tvq.feature_kmeans_init(vq_state_from_jax(s), torch.as_tensor(X),
                                  torch.arange(40), p_t)
    for f in dataclasses.fields(tvq.VQState):
        a, b = np.asarray(getattr(s_j, f.name)), getattr(s_t, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    np.testing.assert_array_equal(s_t.ema_cluster_size.numpy().sum(1), [40.0, 40.0])


def test_seed_kmeans_matches_jax():
    """``seed_kmeans`` of one carried state after ``np.random.seed``: layer 0
    (the raw features) bit for bit; layer 1 (the first layer's activations,
    f32 round-off apart) to 99 % of its labels and its centroids to atol
    1e-3."""
    jtr, tr = _trainers(kmeans_init=True)
    np.random.seed(11)
    jtr.seed_kmeans()
    np.random.seed(11)
    tr.seed_kmeans()
    ids = tr.test_batches()[0][0][0].batch_idx.numpy()
    ids = ids[ids < tr.graph.num_nodes]
    js0, ts0 = jtr.state.vq_states[0], tr.state.vq_states[0]
    for name in ("embedding", "ema_w", "ema_cluster_size", "c_indices"):
        np.testing.assert_array_equal(getattr(ts0, name).numpy(),
                                      np.asarray(getattr(js0, name)), err_msg=name)
    js1, ts1 = jtr.state.vq_states[1], tr.state.vq_states[1]
    same = (ts1.c_indices.numpy()[ids] == np.asarray(js1.c_indices)[ids]).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(ts1.embedding.numpy()[:, :, :4],
                               np.asarray(js1.embedding)[:, :, :4], atol=ATOL_CENTROIDS)


def test_kmeans_init_without_sklearn_raises(monkeypatch):
    """Where scikit-learn cannot be imported, ``fit`` with ``kmeans_init``
    raises an ImportError that names both; nothing falls back."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    tr = _port_trainer(kmeans_init=True, epochs=1)
    with pytest.raises(ImportError, match="kmeans_init needs scikit-learn"):
        tr.fit(verbose=False)
    assert tr.logger.results == [[]]


# ---------------- vq_backend='scan' ----------------
@pytest.mark.parametrize("masked", [True, False])
def test_assign_stats_scan_matches_jax(masked):
    """B = 1,000 rows in chunks of 256 (the last one short), three
    branches: idx and counts equal, sums to atol 1e-5."""
    rng = np.random.RandomState(4)
    nb, B, M, K = 3, 1000, 8, 8
    xn = rng.randn(nb, B, K).astype(np.float32)
    emb = rng.randn(nb, M, K).astype(np.float32)
    valid = rng.rand(B) < 0.8 if masked else None
    ji, jc, js = jax.vmap(lambda x, e: jvq_ops.assign_stats_scan(
        x, e, None if valid is None else jnp.asarray(valid), chunk=256))(
        jnp.asarray(xn), jnp.asarray(emb))
    ti, tc, ts = tvq_ops.assign_stats_scan(
        torch.as_tensor(xn), torch.as_tensor(emb),
        None if valid is None else torch.as_tensor(valid), chunk=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL_VQ)
    assert tc.numpy().sum() == (B if valid is None else valid.sum()) * nb


def test_vq_update_scan_matches_jax():
    """Two ``vq_update`` steps with ``backend='scan'``, as
    tests/test_torch_port_vq.py holds the other backends."""
    X, G, ids, valid = vq_tests._inputs(2)
    js = vq_tests._jax_state("scan", True)
    ts = vq_state_from_jax(js)
    for _ in range(2):
        js, jidx = jvq.vq_update(js, jnp.asarray(X), jnp.asarray(G), jnp.asarray(ids, jnp.int32),
                                 vq_tests._params(jvq, "scan"), valid=jnp.asarray(valid))
        ts, tidx = tvq.vq_update(ts, torch.as_tensor(X), torch.as_tensor(G),
                                 torch.as_tensor(ids), vq_tests._params(tvq, "scan"),
                                 valid=torch.as_tensor(valid))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        vq_tests._assert_states_match(js, ts)
        X = X[:, ::-1].copy()


def test_train_epoch_scan_matches_jax():
    """The init sweep and one epoch (three steps) with ``vq_backend='scan'``
    from one carried state: the epoch's mean losses to rtol 1e-4 and the VQ
    states as tests/test_torch_port_slice.py holds them."""
    jtr, tr = _trainers(vq_backend="scan")
    assert tr.ms.vq.backend == "scan"
    for t in (jtr, tr):
        t.run_init_sweep()
    np.testing.assert_allclose(tr.train_epoch(1), jtr.train_epoch(1), rtol=RTOL_STEP)
    N = tr.graph.num_nodes
    for js, ts in zip(jtr.state.vq_states, tr.state.vq_states):
        for name in ("embedding", "embedding_output", "ema_cluster_size", "ema_w"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=1e-5, atol=ATOL_VQ, err_msg=name)
        np.testing.assert_array_equal(ts.c_indices.numpy()[:N], np.asarray(js.c_indices)[:N])


# ---------------- the STE quantizer and the schedules ----------------
def test_ste_quantizer_matches_jax():
    """Outputs equal; the straight-through gradient of sum(q) is ones; the
    loss's gradients in x and the codebook equal jax.grad's."""
    rng = np.random.RandomState(0)
    x, emb = rng.randn(10, 4).astype(np.float32), rng.randn(6, 4).astype(np.float32)
    jout = jvq.ste_vector_quantizer(jnp.asarray(x), jnp.asarray(emb))
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(emb, requires_grad=True)
    tout = tvq.ste_vector_quantizer(tx, te)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6)
    assert tout[2].shape == (10, 6) and tout[1].shape == x.shape
    (g,) = torch.autograd.grad(tout[1].sum(), tx)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(x))
    jgx, jge = jax.grad(lambda a, e: jvq.ste_vector_quantizer(a, e)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    tgx, tge = torch.autograd.grad(tout[0], (tx, te))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("epoch", [0, 1, 100, 199, 200, 500])
def test_schedulers_match_jax(epoch):
    assert tsched.linear_ramp(0.01, epoch) == jsched.linear_ramp(0.01, epoch)
    assert tsched.linear_ramp(0.01, epoch, 50) == jsched.linear_ramp(0.01, epoch, 50)
    for mult, total in ((2.0, 10), (1.0, 5), (3.5, 300)):
        assert (tsched.gradual_warmup(0.01, epoch, mult, total)
                == jsched.gradual_warmup(0.01, epoch, mult, total))
    with pytest.raises(ValueError, match="multiplier should be >= 1"):
        tsched.gradual_warmup(0.01, epoch, 0.5, 10)


def test_trainer_lr_follows_linear_ramp():
    tr = _port_trainer(sche=True)
    assert [tr.lr_at(e) for e in (1, 150, 250)] == [
        tsched.linear_ramp(LR, e) for e in (1, 150, 250)]


# ---------------- the CLI ----------------
def _statistics_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.strip().startswith(("Highest", "Final"))]


@pytest.mark.parametrize("case", ["ckpt-dir", "resume", "kmeans-init"])
def test_cli_upkeep_options(case, tmp_path, monkeypatch, capsys):
    """The options of the upkeep slice through the CLI on the CPU.
    ``--ckpt-dir D --ckpt-every 1`` writes ``D/run0.npz`` after the epoch,
    which restores bit for bit; ``--resume`` goes on from it at epoch 2, in
    the port's CLI and in main_node.py alike, and both print the same
    statistics (BN off, as in tests/test_torch_port_cli.py's
    test_fit_matches_jax); ``--kmeans-init`` seeds the codebooks by k-means
    before the init sweep."""
    ckpt = ["--ckpt-dir", str(tmp_path), "--bn-flag"]
    path = tmp_path / "run0.npz"
    if case == "kmeans-init":
        calls = []
        seed = NodeTrainer.seed_kmeans
        monkeypatch.setattr(NodeTrainer, "seed_kmeans", lambda self: calls.append(seed(self)))
        tr = main_node_torch.main(CLI_ARGS + ["--kmeans-init"])
        assert len(calls) == 1 and "init done" in capsys.readouterr().out
        assert all(math.isfinite(v) for v in tr.logger.results[0][0])
        return
    tr = main_node_torch.main(CLI_ARGS + ckpt + ["--ckpt-every", "1"])
    assert tckpt.load_step(str(path)) == 1 and not os.path.exists(f"{path}.tmp")
    restored = tckpt.restore_checkpoint(str(path), tr.state)
    for (name, a), (_, b) in zip(tckpt.named_leaves(restored),
                                 tckpt.named_leaves(tr.state)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "ckpt-dir":
        return
    capsys.readouterr()
    argv = CLI_ARGS[:-4] + ["--epochs", "2"] + ckpt + ["--resume"]
    main_node_torch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["main_node.py"] + argv)
    main_node.main()
    j_out = capsys.readouterr().out
    for o in (out, j_out):
        assert f"resumed from {path} at epoch 2" in o and "Run: 1, Epoch: 2," in o
        assert "Run: 1, Epoch: 1," not in o
    assert _statistics_lines(out) == _statistics_lines(j_out) and _statistics_lines(out)


# ---------------- the batch cache ----------------
def test_iter_cached():
    """The first pass builds and keeps the list under its name; later passes
    return the same list; the trainer's eval batches are those batches, each
    name kept apart."""
    tr = _port_trainer()
    cache = {}
    first = iter_cached(cache, "test", tr.test_loader)
    assert cache["test"] is first and iter_cached(cache, "test", tr.test_loader) is first
    streamed = list(tr.test_loader)
    assert len(first) == len(streamed) > 0
    for (w, raw), (ws, raws) in zip(first, streamed):
        assert torch.equal(w[0].batch_idx, ws[0].batch_idx)
        np.testing.assert_array_equal(raw[0], raws[0])
    assert tr.test_batches() is tr.test_batches() is tr._batch_cache["test"]
    assert iter_cached(cache, "other", tr.test_loader) is not first


def test_exact_control_caches_its_train_batch():
    """The exact full-graph control (node sampler, batch >= N) keeps its one
    train batch; two epochs' losses are the same cached as streamed: the
    first bit for bit, the second to rtol 1e-6 (the streamed epoch takes the
    whole graph in another order, so its f32 sums round otherwise)."""
    kw = dict(sampler_type="node", batch_size=300, test_batch_size=300,
              exact_eval_train_edges=True)
    cached = _port_trainer(**kw)
    assert cached._cache_train
    losses = [cached.train_epoch(e) for e in (1, 2)]
    assert len(cached._batch_cache["train"]) == 1
    streamed = _port_trainer(**kw)
    streamed._cache_train = False
    assert streamed.train_epoch(1) == losses[0]
    np.testing.assert_allclose(streamed.train_epoch(2), losses[1], rtol=1e-6)
    assert "train" not in streamed._batch_cache
    assert not _port_trainer()._cache_train
