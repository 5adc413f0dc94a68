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

import main_node  # noqa: E402  (the repo root is on sys.path, see conftest)
import main_node_torch  # noqa: E402

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
], ids=["default", "verify", "cluster", "gat", "bm", "sage-reference", "flags"])
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


def test_cli_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_node_torch.main(SMALL_ARGS[:-2])


@pytest.mark.parametrize("extra,where", [
    (["--ckpt-dir", "CKPT"], "queue 1 item 8"),
    (["--resume"], "queue 1 item 8"),
    (["--vq-diagnostics"], "queue 1 items 3 and 8"),
    (["--kmeans-init"], "queue 1 item 6"),
    (["--dataset", "synthetic_inductive:300"], "queue 1 item 6"),
    (["--dataset", "ppi"], "queue 1 item 6"),
    (["--transformer-flag"], "queue 1 item 4"),
    (["--compute-dtype", "bfloat16"], "queue 2a"),
], ids=["ckpt-dir", "resume", "vq-diagnostics", "kmeans-init", "synthetic-inductive", "ppi",
        "transformer", "bf16"])
def test_cli_unported_options_raise(extra, where, tmp_path, capsys):
    argv = [str(tmp_path / a) if a == "CKPT" else a for a in SMALL_ARGS + extra]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {where}"):
        main_node_torch.main(argv)
    assert not os.path.exists(tmp_path / "CKPT")


def test_entry_points_import_no_jax():
    """bench_torch.py, main_node_torch.py, chip_smoke.py and every module of
    the port import in a process where jax and vq_gnn_tpu cannot be
    imported."""
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
        "import bench_torch, chip_smoke, main_node_torch, vq_gnn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vq_gnn_tpu_torch.__path__, "
        "'vq_gnn_tpu_torch.')]\n"
        "mods = [m for m in mods if importlib.util.find_spec(m).origin.endswith('.py')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert 'vq_gnn_tpu_torch.utils.logger' in mods, mods\n"
        "print('clean', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
