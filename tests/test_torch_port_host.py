"""The port's host side against the JAX package: graph build, partition and
padded batches must give the same numpy arrays, exactly.  Also: the port
imports neither JAX nor the JAX package, and its entry points default to
CUDA."""

import os
import subprocess
import sys
import time

import jax  # noqa: F401  (imported before torch, see conftest)
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.native import lib as jlib
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.native import lib as tlib
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    num_layers=2, hidden_channels=16, num_D=4, num_M=8, num_parts=8, batch_size=3,
    test_batch_size=256, walk_length=2, pad_multiple_nodes=64, pad_multiple_edges=512,
)


def _native_libs_agree():
    """Both packages must take the same path (native or numpy fallback):
    another test worker may be building the JAX package's library right now,
    so give its build time to finish before reading the answer."""
    for _ in range(30):
        if jlib.available():
            break
        jlib._tried = False
        time.sleep(2)
    assert jlib.available() == tlib.available()


def _graphs(sampler_type, seed=0):
    out = []
    for cfg_mod, data in ((jcfg, jdata), (tcfg, tdata)):
        bs = 3 if sampler_type == "cluster" else 150  # parts vs nodes
        cfg = cfg_mod.Config(sampler_type=sampler_type, seed=seed, **{**CFG, "batch_size": bs})
        g, c = data.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=seed)
        out.append((cfg, data.prepare(g, cfg, c)))
    return out


@pytest.mark.parametrize(
    "sampler_type,train_flag",
    [("cluster", True), ("cluster", False), ("node", True), ("node", False),
     ("edge", True), ("rw", True), ("cont", True)],
)
def test_batches_match_jax(sampler_type, train_flag):
    _native_libs_agree()
    (jc, (jg, jn, jci)), (tc, (tg, tn, tci)) = _graphs(sampler_type)
    assert jn == tn
    np.testing.assert_array_equal(jg.x, tg.x)
    np.testing.assert_array_equal(jg.y, tg.y)
    assert (jg.adj != tg.adj).nnz == 0
    if jci is not None:
        assert all(np.array_equal(a, b) for a, b in zip(jci, tci))
    kw = dict(train_flag=train_flag, cluster_indices=jci, seed=3)
    if not train_flag:
        kw.update(sampler_type=sampler_type, batch_size=3 if sampler_type == "cluster" else 256,
                  shuffle=False)
    jl = jsamplers.BatchLoader(jg, jc, **kw)
    kw["cluster_indices"] = tci
    tl = tsamplers.BatchLoader(tg, tc, device="cpu", **kw)
    n = 0
    for epoch in range(2):  # the second epoch exercises the monotone buckets
        for (jw, jraw), (tw, traw) in zip(jl._epoch_iter(), tl._epoch_iter(), strict=True):
            assert len(jw) == len(tw)
            for a, b in zip(jraw, traw):
                np.testing.assert_array_equal(a, b)
            for jb, tb in zip(jw, tw):
                n += 1
                for f in ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask"):
                    np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
                assert int(jb.num_B) == tb.num_B
                je, te = jb.edges, tb.edges
                for f in ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col",
                          "t_ell_val"):
                    np.testing.assert_array_equal(getattr(je, f), getattr(te, f), err_msg=f)
                for f in ("num_rows", "dense_rows", "b_rows", "t_b_slots"):
                    assert getattr(je, f) == getattr(te, f), f
    assert n > 0


def test_batches_move_to_device_as_tensors():
    (_, _), (tc, (tg, _, tci)) = _graphs("cluster")
    tl = tsamplers.BatchLoader(tg, tc, train_flag=True, cluster_indices=tci, device="cpu")
    windows, _ = next(iter(tl))
    b = windows[0]
    assert b.batch_idx.dtype == torch.int64 and b.edges.ell_col.dtype == torch.int32
    assert b.edges.ell_val.dtype == torch.float32 and b.valid_B.dtype == torch.bool
    assert b.edges.t_b_slots > 0 and b.edges.b_rows == b.B_pad


def test_port_imports_no_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import vq_gnn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vq_gnn_tpu_torch.__path__, "
        "'vq_gnn_tpu_torch.')]\n"
        "mods = [m for m in mods if importlib.util.find_spec(m).origin.endswith('.py')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'vq_gnn_tpu.')) or m == 'vq_gnn_tpu']\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print('clean', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_entry_points_default_to_cuda():
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader

    (_, _), (tc, (tg, _, tci)) = _graphs("cluster")
    if torch.cuda.is_available():
        assert tcfg.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfg.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchLoader(tg, tc, cluster_indices=tci)
    assert tcfg.resolve_device("cpu").type == "cpu"
    assert tcfg.resolve_vq_backend("auto", torch.device("cpu")) == "xla"
    assert tcfg.resolve_vq_backend("auto", torch.device("cuda")) == "pallas_fast"


@pytest.mark.parametrize("kw", [dict(compute_dtype="float64")])
def test_unported_options_raise(kw):
    """A setting the port has no path for (a compute dtype neither package
    has) raises by name, in the data preparation and in the trainer."""
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    cfg = tcfg.Config(sampler_type="node", **{**CFG, **kw})
    g, c = tdata.synthetic_sbm(num_nodes=200, num_classes=3, num_features=8, seed=0)
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        tdata.prepare(g, cfg, c)
    g, c, ci = tdata.prepare(g, tcfg.Config(sampler_type="node", **CFG), c)
    with pytest.raises(NotImplementedError, match="compute_dtype='float64'"):
        NodeTrainer(g, cfg, c, ci, device="cpu")


@pytest.mark.parametrize("kw", [dict(kmeans_init=True), dict(vq_backend="scan")],
                         ids=["kmeans_init", "scan"])
def test_upkeep_options_train(kw):
    """The options the upkeep slice ported, which the port refused before:
    the data and the trainer build, and ``fit`` trains an epoch to finite
    results (the k-means seeding, or the row-chunked assignment, on the
    way)."""
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    cfg = tcfg.Config(sampler_type="node", epochs=1, **{**CFG, **kw})
    g, c = tdata.synthetic_sbm(num_nodes=200, num_classes=3, num_features=8, seed=0)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    assert tr.ms.vq.backend == kw.get("vq_backend", "xla")
    tr.fit(verbose=False)
    assert all(np.isfinite(v) for v in tr.logger.results[0][0])


@pytest.mark.parametrize("kw", [
    dict(formulation="bm", transformer_flag=True),
    dict(dropbranch=0.5),
    dict(alpha_dropout_flag=True, dropout=0.5),
    dict(formulation="bm", conv_type="GAT", transformer_flag=True, dropbranch=0.5,
         compute_dtype="bfloat16"),
    dict(conv_type="GAT", dropbranch=0.5, alpha_dropout_flag=True, dropout=0.5,
         compute_dtype="bfloat16"),
], ids=["transformer", "dropbranch", "alpha-dropout", "bm-GAT-bf16-transformer-dropbranch",
        "GAT-bf16-dropbranch-alpha-dropout"])
def test_model_options_train_on_the_cpu(kw):
    """Each model option the port runs: the trainer's init sweep, one epoch
    with finite losses and an evaluation, on the cont sampler (the
    transformer at B + M, its only formulation), in f32 and at bf16
    compute."""
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    cfg = tcfg.Config(**{**CFG, "sampler_type": "cont", "batch_size": 64,
                         "vq_update_mode": "live", **kw})
    g, c = tdata.synthetic_sbm(num_nodes=200, num_classes=3, num_features=8, seed=0)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    assert (tr.state.vq_states_tr is not None) == cfg.transformer_flag
    tr.run_init_sweep()
    loss, loss_cls = tr.train_epoch(1)
    assert np.isfinite(loss) and np.isfinite(loss_cls)
    assert all(0.0 <= a <= 1.0 for a in tr.evaluate())


@pytest.mark.parametrize("conv", ["GCN", "GAT"])
def test_bm_exact_minibatch_trains_on_the_cpu(conv):
    """``exact_minibatch`` under B + M (the convergence-matched control) runs:
    batches of the exact in-batch edges alone (no boundary rows, no reverse
    list), an init sweep, one epoch with finite losses and an evaluation."""
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    cfg = tcfg.Config(**{**CFG, "sampler_type": "cont", "batch_size": 64, "conv_type": conv,
                         "formulation": "bm", "exact_minibatch": True})
    g, c = tdata.synthetic_sbm(num_nodes=200, num_classes=3, num_features=8, seed=0)
    g, c, ci = tdata.prepare(g, cfg, c)
    tr = NodeTrainer(g, cfg, c, ci, device="cpu")
    for windows, _ in tr.train_loader:
        for b in windows:
            assert not b.valid_fo.any() and b.rev_slot_row is None
    tr.run_init_sweep()
    loss, loss_cls = tr.train_epoch(1)
    assert np.isfinite(loss) and np.isfinite(loss_cls)
    assert all(0.0 <= a <= 1.0 for a in tr.evaluate())
