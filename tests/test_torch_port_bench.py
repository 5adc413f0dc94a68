"""The port's bench (``bench_torch.py``) against ``bench.py``, on the CPU: the
configuration of every cell, the batch whose edges it counts, the timed
steps and the one stdout line, the refusal of bf16 GAT, the order of its
graph sources, and the sweep's record of a failing cell."""

import dataclasses
import importlib.util
import json
import os
import types

import jax  # noqa: F401  (imported before torch, see conftest)
import numpy as np
import pytest
import torch

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu_torch.graph import datasets as tdata

import bench_torch  # noqa: E402  (the repo root is on sys.path, see conftest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py:43-90, verbatim: the configuration the port's bench must build
BENCH_PY_LINES = (43, 90)
BENCH_PY_CONFIG = '''\
    formulation = os.environ.get("VQ_GNN_BENCH_FORM", "bbprime")
    # bm recovery kernel fold: the near-exact 'x2' default measured FASTER
    # than the bf16 'fast' mode (0.93M vs 0.87M edges/s bm GAT — the bf16
    # histogram's i1->bf16 converts cost more than the saved MXU pass)
    conv = os.environ.get("VQ_GNN_BENCH_CONV", "GCN")
    # VQ_GNN_BENCH_PROFILE=products: ogbn-products scale (2.45M nodes,
    # ~61M und. edges, 100 feats, 47 classes — reference misc.py:144-224
    # supports products through the same branch as arxiv).  Proves the
    # "scale up" claim past arxiv: host k-hop/ELL pipeline, [N+1, nb] int16
    # c_indices and HBM residency at 14x the node count.
    profile = os.environ.get("VQ_GNN_BENCH_PROFILE", "arxiv")
    if profile == "products":
        N_syn, deg_syn, feat_syn, cls_syn = 2_449_029, 50.0, 100, 47
        # 2 of 200 parts: B ~ 25k but E ~ 13M/step (products' degree is 4x
        # arxiv's and the 87% edge cut pulls a ~1.2M-node boundary) — the
        # [S*K, C] gathered block is the HBM limiter: 8 parts = 52M edges
        # = 29 GB f32, over the 16 GB chip; 2 parts fits at ~7 GB.
        parts_syn, batch_parts = 200, 2
    else:
        N_syn, deg_syn, feat_syn, cls_syn = 169_343, 13.7, 128, 40
        parts_syn, batch_parts = 80, 40
    # GAT defaults to bf16 streaming: halves the einsum/gather-block HBM
    # traffic and the merged cotangent gather (tools/gather_bench.py
    # one_bf16_130 27.3ms vs one_f32_130 29.7ms); accumulation stays f32.
    # GCN measured SLOWER in bf16 (26.8 vs 29.8M round 1), so it stays f32.
    default_dtype = "bfloat16" if conv == "GAT" else "float32"
    cfg = Config(
        dataset="arxiv",
        conv_type=conv,
        formulation=formulation,
        num_layers=3,
        hidden_channels=128,
        num_D=4,
        num_M=256 if formulation == "bbprime" else 1024,
        sampler_type="cluster" if formulation == "bbprime" else "cont",
        walk_length=3,
        num_parts=parts_syn,
        batch_size=batch_parts if formulation == "bbprime" else 10000,
        vq_update_mode=os.environ.get("VQ_GNN_BENCH_MODE", "live"),
        warm_up_flag=True,
        skip=True,
        matmul_precision="default",  # bench rides the MXU; VQ ops stay exact
        vq_backend=os.environ.get("VQ_GNN_BENCH_VQ_BACKEND", "pallas_fast"),
        spmm_backend=os.environ.get("VQ_GNN_BENCH_SPMM", "ell"),
        compute_dtype=os.environ.get("VQ_GNN_BENCH_DTYPE", default_dtype),
        ell_K=int(os.environ.get("VQ_GNN_BENCH_K", "8")),
        ell_Kt=int(os.environ.get("VQ_GNN_BENCH_KT", "0")),
    )
'''

KNOBS = ("VQ_GNN_BENCH_FORM", "VQ_GNN_BENCH_CONV", "VQ_GNN_BENCH_K", "VQ_GNN_BENCH_KT",
         "VQ_GNN_BENCH_DTYPE", "VQ_GNN_BENCH_MODE", "VQ_GNN_BENCH_VQ_BACKEND",
         "VQ_GNN_BENCH_SPMM", "VQ_GNN_BENCH_PROFILE", "VQ_GNN_BENCH_CACHE")
# a graph the CPU steps in seconds: (nodes, degree, features, classes, parts,
# parts a batch)
SMALL = (2000, 10.0, 16, 8, 8, 4)


@pytest.fixture(scope="module", autouse=True)
def _vml_first_call():
    """A throwaway first torch.exp of the process: the first call of MKL's
    vector exp can return a chunk at a lower accuracy
    (tests/test_torch_port_kernels.py:_vml_first_call says more)."""
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture
def bench_env(monkeypatch):
    """No bench knob from the caller's environment."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return os.environ


def _bench_py(env):
    """bench.py's configuration and profile sizes for ``env``, by running its
    lines 43-90 with the JAX package's Config."""
    lines = open(os.path.join(REPO, "bench.py")).read().splitlines(keepends=True)
    a, b = BENCH_PY_LINES
    assert "".join(lines[a - 1:b]) == BENCH_PY_CONFIG, "bench.py:43-90 moved"
    ns = {"os": types.SimpleNamespace(environ=dict(env)), "Config": jcfg.Config}
    exec("if True:\n" + BENCH_PY_CONFIG, ns)
    return ns


SWEEP_ENVS = [env for _, env in bench_torch.SWEEP] + [
    {"VQ_GNN_BENCH_PROFILE": "products"},
    {"VQ_GNN_BENCH_PROFILE": "products", "VQ_GNN_BENCH_FORM": "bm"},
    {"VQ_GNN_BENCH_MODE": "reference", "VQ_GNN_BENCH_VQ_BACKEND": "pallas",
     "VQ_GNN_BENCH_SPMM": "coo", "VQ_GNN_BENCH_KT": "4"},
]


@pytest.mark.parametrize("env", SWEEP_ENVS, ids=lambda e: ",".join(f"{k[14:]}={v}"
                                                                   for k, v in e.items()))
def test_bench_config_matches_bench_py(env):
    ns = _bench_py(env)
    port = bench_torch.bench_config(env)
    assert dataclasses.asdict(port) == dataclasses.asdict(ns["cfg"])
    sizes = (ns["N_syn"], ns["deg_syn"], ns["feat_syn"], ns["cls_syn"], ns["parts_syn"],
             ns["batch_parts"])
    assert bench_torch.profile_sizes(bench_torch.profile_of(env)) == sizes


def test_sweep_covers_bench_sweep_py_and_names_its_dtype():
    """Every cell of tools/bench_sweep.py runs, named by the dtype it really
    runs (its 'GAT bm cont f32 (K=2)' sets no dtype, so bench.py runs it
    bf16), beside the two GAT cells at f32."""
    spec = importlib.util.spec_from_file_location(
        "bench_sweep", os.path.join(REPO, "tools", "bench_sweep.py"))
    jsweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsweep)
    envs = [env for _, env in bench_torch.SWEEP]
    assert all(env in envs for _, env in jsweep.CONFIGS)
    assert len(envs) == len(jsweep.CONFIGS) + 2
    for name, env in bench_torch.SWEEP:
        dtype = bench_torch.bench_config(env).compute_dtype
        assert (" bf16" in name, " f32" in name) == (dtype == "bfloat16", dtype == "float32")
    assert bench_torch.bench_config(dict(jsweep.CONFIGS[4][1])).compute_dtype == "bfloat16"


def _small(conv, form):
    env = {"VQ_GNN_BENCH_CONV": conv, "VQ_GNN_BENCH_FORM": form,
           "VQ_GNN_BENCH_DTYPE": "float32"}
    small = dict(num_parts=SMALL[4], batch_size=SMALL[5] if form == "bbprime" else 300,
                 pad_multiple_nodes=64, pad_multiple_edges=512)
    tc = dataclasses.replace(bench_torch.bench_config(env), **small)
    jc = dataclasses.replace(_bench_py(env)["cfg"], **small)
    return tc, jc


@pytest.mark.parametrize("conv,form", [("GCN", "bbprime"), ("SAGE", "bbprime"),
                                       ("GCN", "bm"), ("GAT", "bm")])
def test_first_batch_edges_match_jax(conv, form):
    """The bench's edge count of its batch equals bench.py's count of the JAX
    package's first training batch on the same graph and seed."""
    tc, jc = _small(conv, form)
    n, deg, f, c, _, _ = SMALL
    jg, _ = jdata.synthetic_sbm(num_nodes=n, num_classes=c, num_features=f, avg_degree=deg,
                                seed=0)
    jg, _, jci = jdata.prepare(jg, jc, c)
    tg, _ = tdata.synthetic_sbm(num_nodes=n, num_classes=c, num_features=f, avg_degree=deg,
                                seed=0)
    tg, _, tci = tdata.prepare(tg, tc, c)
    windows, _ = next(jsamplers.BatchLoader(jg, jc, train_flag=True,
                                            cluster_indices=jci)._epoch_iter())
    expected = int(np.asarray(windows[0].edges.ell_val != 0).sum())  # bench.py:227-228
    batch, E_batch, line = bench_torch.first_batch(tg, tc, tci, "cpu")
    assert E_batch == expected > 0
    assert f"E={expected} " in line and batch.batch_idx.device.type == "cpu"


def _small_profile(monkeypatch, tmp_path):
    monkeypatch.setitem(bench_torch.PROFILES, "arxiv", SMALL)
    monkeypatch.setattr(bench_torch, "STEPS", 2)
    monkeypatch.chdir(tmp_path)  # data_root ./datasets: no real data here


def test_bench_main_steps_and_prints_one_record(bench_env, monkeypatch, tmp_path, capsys):
    """The whole single-cell path at the default configuration on a small
    graph, with the CPU standing in for the card: finite steps, one JSON line
    on stdout with exactly metric, value and unit, the diagnostics on
    stderr."""
    _small_profile(monkeypatch, tmp_path)
    monkeypatch.setattr(bench_torch, "resolve_device", lambda _: torch.device("cpu"))
    monkeypatch.setattr(bench_torch, "gpu_line", lambda: "no card: the CPU stands in")
    assert bench_torch.main([]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit"}
    assert rec["metric"] == "train_edges_per_sec_per_chip" and rec["unit"] == "edges/s"
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    detail = json.loads(next(ln for ln in err.splitlines()
                             if ln.startswith("bench detail "))[len("bench detail "):])
    assert np.isfinite(detail["loss"]) and detail["steps"] == 2
    for piece in ("batch: B=", "first step:", "2 steps in", "eval fwd:"):
        assert piece in err


def test_bench_refuses_to_run_without_a_gpu(bench_env, monkeypatch, tmp_path):
    _small_profile(monkeypatch, tmp_path)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


@pytest.mark.parametrize("form", ["bbprime", "bm"])
def test_gat_default_dtype_raises(bench_env, monkeypatch, tmp_path, form):
    """bench.py runs GAT in bf16 by default; the port refuses bf16 compute by
    name and does not fall back to f32."""
    _small_profile(monkeypatch, tmp_path)
    monkeypatch.setenv("VQ_GNN_BENCH_CONV", "GAT")
    monkeypatch.setenv("VQ_GNN_BENCH_FORM", form)
    with pytest.raises(NotImplementedError, match="compute_dtype='bfloat16'"):
        bench_torch.main([])


def _write_real(path, num_nodes, seed):
    g, c = tdata.synthetic_sbm(num_nodes=num_nodes, num_classes=SMALL[3],
                               num_features=SMALL[2], seed=seed)
    bench_torch._save_raw(path, g, c)


def test_real_data_wins_over_the_caches(monkeypatch, tmp_path):
    """Sources in order: real {profile}.npz, then the prepared and raw caches,
    then the synthetic graph.  A prepared cache built from synthetic data does
    not stand in for real data added later, and a raw cache of another size
    is regenerated, not read."""
    monkeypatch.setitem(bench_torch.PROFILES, "arxiv", SMALL)
    cache = str(tmp_path / "sbm.npz")
    env = {"VQ_GNN_BENCH_CACHE": cache}
    cfg = dataclasses.replace(bench_torch.bench_config(env), data_root=str(tmp_path / "data"),
                              pad_multiple_nodes=64, pad_multiple_edges=512)
    said = []
    log = said.append
    g, _, ci = bench_torch.load_graph(cfg, env, log)  # synthetic, both caches written
    assert g.num_nodes == SMALL[0] and len(ci) == SMALL[4]
    assert os.path.exists(cache) and any("cached the prepared graph" in s for s in said)
    said.clear()
    g2, _, ci2 = bench_torch.load_graph(cfg, env, log)  # the prepared cache
    assert any(s.startswith("loaded prepared cache") for s in said)
    assert (g2.adj != g.adj).nnz == 0 and np.array_equal(g2.x, g.x)
    assert all(np.array_equal(a, b) for a, b in zip(ci, ci2))

    os.makedirs(tmp_path / "data")
    _write_real(str(tmp_path / "data" / "arxiv.npz"), 1500, seed=3)
    said.clear()
    g3, _, _ = bench_torch.load_graph(cfg, env, log)
    assert g3.num_nodes == 1500 and any("data/arxiv.npz" in s for s in said)
    said.clear()
    g4, _, _ = bench_torch.load_graph(cfg, env, log)  # its own prepared cache
    assert g4.num_nodes == 1500 and any(s.startswith("loaded prepared cache") for s in said)

    # without real data: a raw cache of another size is not read
    os.remove(tmp_path / "data" / "arxiv.npz")
    for f in os.listdir(tmp_path):
        if ".prepared." in f:
            os.remove(tmp_path / f)
    _write_real(cache, 700, seed=4)
    said.clear()
    g5, _, _ = bench_torch.load_graph(cfg, env, log)
    assert g5.num_nodes == SMALL[0] and any("regenerating" in s for s in said)


def test_sweep_records_a_failing_cell(monkeypatch, tmp_path):
    """A sweep cell runs as its own process; one that raises is recorded with
    its error line, not dropped (the bf16 GAT cell fails before it needs a
    GPU or a graph)."""
    monkeypatch.setenv("VQ_GNN_BENCH_CACHE", str(tmp_path / "sbm.npz"))
    rec = bench_torch.run_cell({"VQ_GNN_BENCH_CONV": "GAT"}, timeout=300)
    assert rec["returncode"] != 0
    assert rec["error"].startswith("NotImplementedError: compute_dtype='bfloat16'"), rec
    tb = "Traceback (most recent call last):\n  File \"x\", line 1\nValueError: bad\n  note\n"
    assert bench_torch.error_line(tb) == "ValueError: bad"
    assert bench_torch.error_line("killed\n") == "killed"


def test_sweep_writes_every_run(monkeypatch, tmp_path, capsys):
    """Every run of every cell goes to the JSON file, failures too, and the
    table shows each run's number."""
    runs = iter([{"value": 7.5e7, "ms_per_step": 20.0, "busy_ms": 17.0, "idle": 0.15,
                  "peak_allocated_bytes": 1.2e9, "eval_fwd_ms": 2.0, "gpu": "card, 700 W"},
                 {"value": 6.5e7, "ms_per_step": 23.0, "busy_ms": 17.1, "idle": 0.26,
                  "peak_allocated_bytes": 1.2e9, "eval_fwd_ms": 2.2, "gpu": "card, 700 W"},
                 {"error": "NotImplementedError: compute_dtype='bfloat16' ..."},
                 {"error": "NotImplementedError: compute_dtype='bfloat16' ..."}])
    monkeypatch.setattr(bench_torch, "SWEEP", [("GCN", {}), ("GAT bf16", {"X": "1"})])
    monkeypatch.setattr(bench_torch, "run_cell", lambda env: next(runs))
    out = tmp_path / "sweep.json"
    assert bench_torch.sweep(2, str(out)) == 0
    rec = json.loads(out.read_text())
    assert [len(rec[k]["runs"]) for k in ("GCN", "GAT bf16")] == [2, 2]
    assert rec["GAT bf16"]["env"] == {"X": "1"}
    table = capsys.readouterr().out.splitlines()
    assert table[2] == ("| GCN | 75.000, 65.000 | 20.00, 23.00 | 17.00, 17.10 | 15.0, 26.0 | "
                        "1.200, 1.200 | 2.00, 2.20 | card, 700 W |")
    assert table[3].startswith("| GAT bf16 | error: NotImplementedError: compute_dtype=")
