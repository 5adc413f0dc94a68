"""The port's CLI (``main_node_torch.py``), ``NodeTrainer.fit`` and ``Logger``
against ``main_node.py`` and the JAX package, on the CPU; the options the
port lacks raise; and the port's entry points import neither JAX nor the
JAX package."""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.train.loop import NodeTrainer as JNodeTrainer
from vq_gnn_tpu.utils import logger as jlogger
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.train.loop import NodeTrainer
from vq_gnn_tpu_torch.utils import logger as tlogger

import main_link_torch  # noqa: E402  (the repo root is on sys.path, see conftest)
import main_node  # noqa: E402
import main_node_torch  # noqa: E402
from tests._torch_threads import one_thread  # noqa: F401
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.005
RTOL_STEP = 1e-4  # per-epoch losses: f32 sums in another order
# the CLI's verification run: 2 layers x 16 on a 500-node SBM, 3 epochs
VERIFY_ARGS = ["--dataset", "synthetic:500", "--num-layers", "2", "--hidden-channels", "16",
              "--num-D", "4", "--num-M", "8", "--batch-size", "128", "--test-batch-size", "256",
              "--epochs", "3", "--skip", "--lr", "0.05"]
SMALL_ARGS = ["--dataset", "synthetic:300", "--num-layers", "2", "--hidden-channels", "16",
              "--num-M", "8", "--batch-size", "128", "--test-batch-size", "256", "--epochs", "1",
              "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


class _Built(Exception):
    pass


def _jax_config(argv, monkeypatch):
    """The Config main_node.py builds from ``argv``: its main() up to the
    data load, which is stopped there."""
    seen = {}

    def stop(cfg):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(sys, "argv", ["main_node.py"] + argv)
    monkeypatch.setattr(main_node, "get_data", stop)
    with pytest.raises(_Built):
        main_node.main()
    return main_node.parse_args(), seen["cfg"]


@pytest.mark.parametrize("argv", [
    [],
    VERIFY_ARGS,
    ["--sampler-type", "cluster", "--num-parts", "8", "--batch-size", "4"],
    ["--conv-type", "GAT"],
    ["--formulation", "bm", "--sampler-type", "cont", "--walk-length", "3"],
    ["--conv-type", "SAGE", "--vq-update-mode", "reference", "--vq-backend", "pallas"],
    ["--grad-scale", "1", "2", "--clip", "0.5", "--no-second-fc", "--EMA", "--split",
     "--bn-flag", "--warm-up", "--warm-up-epochs", "2", "--runs", "3", "--seed", "4",
     "--compute-dtype", "bfloat16", "--ell-K", "4", "--matmul-precision", "default"],
    ["--spmm-backend", "coo", "--ell-K", "4", "--ell-Kt", "2"],
], ids=["default", "verify", "cluster", "gat", "bm", "sage-reference", "flags", "layouts"])
def test_parse_args_config_matches_main_node(argv, monkeypatch, capsys):
    ja, jc = _jax_config(argv, monkeypatch)
    ta = main_node_torch.parse_args(argv)
    tc = main_node_torch.config_from_args(ta)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jv, tv = vars(ja), vars(ta)
    assert set(jv) == set(tv)
    assert {k: v for k, v in tv.items() if k != "device"} == {
        k: v for k, v in jv.items() if k != "device"}
    assert tv["device"] == f"cuda:{jv['device']}" == "cuda:0"
    assert main_node_torch.parse_args(argv + ["--device", "cpu"]).device == "cpu"
    assert main_node_torch.parse_args(argv + ["--device", "2"]).device == "cuda:2"


def test_fit_matches_jax():
    """Two epochs of fit from one state (carried over by convert.py): the
    per-epoch losses to rtol 1e-4, the same per-epoch (train, valid, test)
    results and the same statistics.  BN off, as in test_torch_port_slice
    (the bias feeding BN moves on round-off)."""
    kw = dict(bn_flag=False, skip=True, conv_type="GCN", num_layers=2, hidden_channels=16,
              num_D=4, num_M=8, sampler_type="cluster", num_parts=8, batch_size=3,
              test_batch_size=4, lr=LR, epochs=2, vq_backend="xla", pad_multiple_nodes=64,
              pad_multiple_edges=512, seed=0)
    jc, tc = jcfg.Config(**kw), tcfg.Config(**kw)
    jg, c = jdata.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=0)
    jg, c, jci = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=600, num_classes=5, num_features=12, seed=0)
    tg, _, tci = tdata.prepare(tg, tc, c)
    jtr = JNodeTrainer(jg, jc, c, cluster_indices=jci)
    tr = NodeTrainer(tg, tc, c, tci, device="cpu")
    tr.state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tr.ms, LR, "cpu")

    losses = {}
    for name, t in (("jax", jtr), ("torch", tr)):
        epoch = t.train_epoch

        def recorded(ep, _epoch=epoch, _name=name):
            out = _epoch(ep)
            losses.setdefault(_name, []).append(out)
            return out

        t.train_epoch = recorded
    js = jtr.fit(verbose=False)
    ts = tr.fit(verbose=False)
    assert len(losses["torch"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(np.asarray(losses["torch"]), np.asarray(losses["jax"]),
                               rtol=RTOL_STEP, atol=1e-7)
    assert tr.logger.results == jtr.logger.results
    assert ts == js and set(ts) == {"highest_train", "highest_valid", "final_train",
                                    "final_test"}


@pytest.mark.parametrize("runs", [1, 3])
def test_logger_matches_jax(runs, capsys):
    rng = np.random.RandomState(runs)
    jl, tl = jlogger.Logger(runs), tlogger.Logger(runs)
    for run in range(runs):
        for _ in range(rng.randint(1, 6)):
            res = tuple(rng.rand(3))
            jl.add_result(run, res)
            tl.add_result(run, res)
    for run in list(range(runs)) + [None]:
        assert tl.statistics(run) == jl.statistics(run)
        jl.print_statistics(run)
        j_out = capsys.readouterr().out
        tl.print_statistics(run)
        assert capsys.readouterr().out == j_out
    empty_j, empty_t = jlogger.Logger(2), tlogger.Logger(2)
    assert empty_t.statistics(0) == empty_j.statistics(0) == {}
    assert empty_t.statistics() == empty_j.statistics() == {}


def test_average_value_meter_matches_jax():
    jm, tm = jlogger.AverageValueMeter(), tlogger.AverageValueMeter()
    assert all(math.isnan(v) for v in tm.value()) and all(math.isnan(v) for v in jm.value())
    rng = np.random.RandomState(0)
    for _ in range(20):
        v, n = float(rng.randn()), int(rng.randint(1, 4))
        jm.add(v, n)
        tm.add(v, n)
        assert tm.value() == jm.value() and tm.sum == jm.sum and tm.n == jm.n
    with pytest.raises(ValueError):
        tm.add(1.0, 0)


def test_cli_trains_on_the_cpu(capsys):
    """The verification run with --device cpu: the
    plain PyTorch path to >= 0.9 test accuracy in 3 epochs, then the
    logger's summary."""
    tr = main_node_torch.main(VERIFY_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.device.type == "cpu"
    assert len(tr.logger.results[0]) == 3 and tr.logger.results[0][-1][2] >= 0.9
    assert tr.logger.statistics()["final_test"][0] >= 90.0
    assert "Run: 1, Epoch: 3," in out and "Run 01:" in out and "All runs:" in out
    assert "   Final Test: " in out


def test_cli_trains_at_bf16_on_the_cpu(capsys):
    """``--compute-dtype bfloat16 --device cpu`` trains GAT: finite epoch
    losses through the plain versions at bf16 compute."""
    tr = main_node_torch.main(SMALL_ARGS + ["--conv-type", "GAT", "--compute-dtype", "bfloat16"])
    out = capsys.readouterr().out
    assert tr.cfg.compute_dtype == "bfloat16" and tr.ms.compute_dtype == "bfloat16"
    assert len(tr.logger.results[0]) == 1 and "Run 01:" in out
    assert all(math.isfinite(v) for r in tr.logger.results[0] for v in r)


def test_cli_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_node_torch.main(SMALL_ARGS[:-2])


# the inductive datasets' own refusals: the cluster sampler (refused by the
# JAX package too) and ppi without its archive (FileNotFoundError naming the
# converter, as main_node.py)
@pytest.mark.parametrize("extra,error,match", [
    (["--dataset", "synthetic_inductive:300", "--sampler-type", "cluster"],
     NotImplementedError, "cluster sampler on inductive datasets"),
    (["--dataset", "ppi", "--data-root", "CKPT"], FileNotFoundError,
     "ppi.npz not found; run tools/convert_dataset.py --dataset ppi"),
], ids=["synthetic-inductive", "ppi"])
def test_cli_unported_options_raise(extra, error, match, tmp_path, capsys):
    argv = [str(tmp_path / a) if a == "CKPT" else a for a in SMALL_ARGS + extra]
    with pytest.raises(error, match=match):
        main_node_torch.main(argv)
    assert not os.path.exists(tmp_path / "CKPT")


@pytest.mark.parametrize("extra,mixed", [
    (["--spmm-backend", "coo"], False),
    (["--ell-Kt", "2"], True),
    (["--ell-Kt", "2", "--conv-type", "GAT", "--compute-dtype", "bfloat16"], True),
    (["--spmm-backend", "coo", "--conv-type", "GAT", "--formulation", "bm", "--sampler-type",
      "cont", "--walk-length", "2"], False),
], ids=["coo", "mixed", "mixed-GAT-bf16", "coo-bm-GAT"])
def test_cli_trains_layouts(extra, mixed, capsys):
    """``--spmm-backend coo`` and ``--ell-Kt 2`` train on the CPU: one epoch
    with finite results over batches of that layout."""
    tr = main_node_torch.main(SMALL_ARGS + extra)
    out = capsys.readouterr().out
    e = next(iter(tr.train_loader))[0][0].edges
    assert e.mixed == mixed and (e.row is not None) == (not mixed)
    assert len(tr.logger.results[0]) == 1 and "Run 01:" in out
    assert all(math.isfinite(v) for r in tr.logger.results[0] for v in r)


def test_link_cli_trains_mixed_k(tmp_path, capsys):
    """``main_link_torch.py --ell-Kt 2 --device cpu`` on its synthetic
    fallback: one epoch over mixed-K batches, Hits@50 in [0, 1]."""
    tr = main_link_torch.main([
        "--epochs", "1", "--num-layers", "2", "--hidden-channels", "16", "--num-M", "8",
        "--sampler-type", "node", "--batch-size", "1000", "--test-batch-size", "2000",
        "--lr", "0.01", "--data-root", str(tmp_path), "--ell-Kt", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.cfg.ell_Kt == 2 and next(iter(tr.train_loader))[0][0].edges.mixed
    assert "Run: 1, Epoch: 1, Loss: " in out and "Run 01:" in out
    (res,) = tr.logger.results[0]
    assert all(0.0 <= v <= 1.0 for v in res)


@pytest.mark.parametrize("extra", [
    ["--formulation", "bm", "--transformer-flag", "--sampler-type", "cont", "--walk-length", "2"],
    ["--dropbranch", "0.5", "--alpha-dropout-flag", "--dropout", "0.5"],
], ids=["transformer", "dropbranch-alpha-dropout"])
def test_cli_trains_model_options(extra, capsys):
    """``main_node.py``'s model options run on the CPU: the transformer branch
    (B + M) and dropbranch with alpha dropout, one epoch with finite
    results."""
    tr = main_node_torch.main(SMALL_ARGS + extra)
    out = capsys.readouterr().out
    assert tr.ms.transformer_flag == ("--transformer-flag" in extra)
    assert tr.ms.dropbranch == (0.5 if "--dropbranch" in extra else 0.0)
    assert tr.ms.alpha_dropout_flag == ("--alpha-dropout-flag" in extra)
    assert len(tr.logger.results[0]) == 1 and "Run 01:" in out
    assert all(math.isfinite(v) for r in tr.logger.results[0] for v in r)


def test_cli_trains_synthetic_inductive(capsys):
    """``--dataset synthetic_inductive:300`` trains on the train graph and
    prints the three micro-F1 values (train, valid and test graphs) each
    epoch, as main_node.py's inductive dispatch does."""
    tr = main_node_torch.main(SMALL_ARGS + ["--dataset", "synthetic_inductive:300"])
    out = capsys.readouterr().out
    assert tr.inductive and tr.multilabel and not tr.use_ogb_acc
    assert tr.val_graph.num_nodes == tr.test_graph.num_nodes == 150
    lines = [ln for ln in out.splitlines() if ln.startswith("Run: 1, Epoch: ")]
    assert len(lines) == 1 and all(k in lines[0] for k in ("Train: ", "Valid: ", "Test: "))
    assert len(tr.logger.results[0]) == 1 and all(
        0.0 <= v <= 1.0 for r in tr.logger.results[0] for v in r)


def test_cli_prints_vq_diagnostics(capsys):
    """``--vq-diagnostics`` prints each logged epoch's per-layer VQ health
    line, as ``main_node.py`` does (``print_vq_diagnostics``)."""
    tr = main_node_torch.main(SMALL_ARGS + ["--vq-diagnostics", "--epochs", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("  [vq L")]
    assert len(lines) == 2 * tr.ms.num_layers
    assert lines[0].startswith("  [vq L0] eff_codewords=") and f"/{tr.cfg.num_M} " in lines[0]
    assert all(k in lines[-1] for k in ("size_min=", "feat_std=", "grad_std="))


def test_cli_trains_bm_gat_bf16_fold_fast(capsys, monkeypatch):
    """B + M GAT at bf16 compute with ``VQ_GNN_REV_FOLD=fast`` (the recovery
    term's bf16 fold) trains on the CPU: finite epoch results."""
    monkeypatch.setenv("VQ_GNN_REV_FOLD", "fast")
    tr = main_node_torch.main(SMALL_ARGS + ["--compute-dtype", "bfloat16", "--formulation", "bm",
                                            "--conv-type", "GAT", "--sampler-type", "cont",
                                            "--walk-length", "2"])
    out = capsys.readouterr().out
    assert tr.ms.formulation == "bm" and tr.ms.compute_dtype == "bfloat16"
    assert len(tr.logger.results[0]) == 1 and "Run 01:" in out
    assert all(math.isfinite(v) for r in tr.logger.results[0] for v in r)


def test_entry_points_import_no_jax():
    """bench_torch.py, main_node_torch.py, main_link_torch.py, chip_smoke.py,
    tools/parity_experiment_torch.py, tools/link_experiment_torch.py,
    tools/inductive_experiment_torch.py, tools/link_hold_probe_torch.py and
    every module of the port (the
    parity harness, the diagnostics, the metrics, the link trainer, the
    data-parallel step, the checkpoints and the lr schedules among them)
    import in a process where jax and vq_gnn_tpu cannot be imported."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'vq_gnn_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in BLOCKED]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, 'tools')\n"
        "import bench_torch, chip_smoke, main_link_torch, main_node_torch\n"
        "import inductive_experiment_torch, link_experiment_torch, parity_experiment_torch\n"
        "import link_hold_probe_torch\n"
        "import vq_gnn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vq_gnn_tpu_torch.__path__, "
        "'vq_gnn_tpu_torch.')]\n"
        "mods = [m for m in mods if importlib.util.find_spec(m).origin.endswith('.py')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "link_experiment_torch.vq_config('GCN', 1)\n"
        "link_experiment_torch.build_graph_and_split(nodes=400)\n"
        "inductive_experiment_torch.make_trainer(inductive_experiment_torch.vq_cfg("
        "'GCN', 1, 0.001), inductive_experiment_torch.build_graphs(7, 0.001), 'cpu')\n"
        "want = {'vq_gnn_tpu_torch.utils.logger', 'vq_gnn_tpu_torch.utils.diagnostics',\n"
        "        'vq_gnn_tpu_torch.train.parity', 'vq_gnn_tpu_torch.utils.metrics',\n"
        "        'vq_gnn_tpu_torch.train.link', 'vq_gnn_tpu_torch.parallel.multihost',\n"
        "        'vq_gnn_tpu_torch.parallel.mesh', 'vq_gnn_tpu_torch.train.checkpoint',\n"
        "        'vq_gnn_tpu_torch.utils.scheduler'}\n"
        "assert want <= set(mods), mods\n"
        "print('clean', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
