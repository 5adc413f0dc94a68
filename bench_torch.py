#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: edges/s of the training step on one GPU.

The port's counterpart of ``bench.py``, with its contract: the same
configuration and ``VQ_GNN_BENCH_*`` knobs (the flagship GCN B + B' step by
default: ogbn-arxiv-scale graph, cluster sampler, 80 parts, 40 a batch,
num_D = 4, hidden 128, 3 layers), real data at ``{data_root}/{profile}.npz``
when it is there, else the synthetic SBM; one warm-up step, then 20
back-to-back steps on the first training batch, with edges counted as
``bench.py`` counts them (the batch's non-zero ELL values).

Prints ONE JSON line on stdout,
``{"metric": "train_edges_per_sec_per_chip", "value", "unit"}``; on stderr
the card's name and power limit, the batch, the kernel build and first-step
times, peak device memory, device busy and idle share from ``torch.profiler``
over 3 steps taken after the timed ones, and the forward-only eval time.
There is no ``vs_baseline``: ``bench_anchor.json`` holds a TPU figure.

    python3 bench_torch.py
    VQ_GNN_BENCH_CONV=GAT python3 bench_torch.py  # bf16 compute, as bench.py
    VQ_GNN_BENCH_FORM=bm VQ_GNN_BENCH_CONV=GAT VQ_GNN_BENCH_K=2 \\
        VQ_GNN_BENCH_DTYPE=float32 python3 bench_torch.py
    # f16 compute, as bench.py takes it: under live VQ updates the codebooks'
    # feature half passes f16's range after the first step and the loss goes
    # nonfinite, as in the JAX package, so the run raises;
    # VQ_GNN_BENCH_MODE=reference keeps the codebooks at their initial state
    VQ_GNN_BENCH_DTYPE=float16 python3 bench_torch.py
    python3 bench_torch.py --sweep [--reps 2] [--out bench_sweep_torch.json]

``--sweep`` runs every cell of ``SWEEP`` as a fresh process, ``--reps``
times each, and writes every run to a JSON file and a markdown table to
stdout.  A cell that fails is recorded with its error.  Runs on the GPU
only: without one it raises.
"""

import argparse
import json
import math
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

from vq_gnn_tpu_torch.config import (
    Config,
    apply_matmul_precision,
    check_ported,
    resolve_device,
)
from vq_gnn_tpu_torch.graph.datasets import load_npz, prepare, synthetic_sbm
from vq_gnn_tpu_torch.graph.partition import cluster_indices_from_ptr
from vq_gnn_tpu_torch.graph.store import HostGraph
from vq_gnn_tpu_torch.nn.model import model_static
from vq_gnn_tpu_torch import ops
from vq_gnn_tpu_torch.ops import _build
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
from vq_gnn_tpu_torch.train.loop import device_features
from vq_gnn_tpu_torch.train.state import init_train_state
from vq_gnn_tpu_torch.train.step import make_step_fns
from vq_gnn_tpu_torch.utils.profiling import gpu_line, profile_steps

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 20
PROFILE_STEPS = 3
SWEEP_TIMEOUT_S = 900  # a sweep run (an arxiv cell takes ~30 s on an H100)
# (nodes, average degree, features, classes, parts, parts per batch) of the
# synthetic graph and its partition (bench.py:49-61)
PROFILES = {
    "arxiv": (169_343, 13.7, 128, 40, 80, 40),
    "products": (2_449_029, 50.0, 100, 47, 200, 2),
}
# The cells of tools/bench_sweep.py:22-34, each named by what it runs, and the
# two GAT cells at f32.  The GAT cells that set no dtype run bf16 (bench.py:68);
# tools/bench_sweep.py:31 names its B + M one "GAT bm cont f32 (K=2)" all the
# same.
SWEEP = [
    ("GCN bbprime cluster f32", {"VQ_GNN_BENCH_CONV": "GCN"}),
    ("SAGE bbprime cluster f32", {"VQ_GNN_BENCH_CONV": "SAGE"}),
    ("GAT bbprime cluster bf16 (default dtype)", {"VQ_GNN_BENCH_CONV": "GAT"}),
    ("GCN bm cont f32", {"VQ_GNN_BENCH_FORM": "bm", "VQ_GNN_BENCH_CONV": "GCN"}),
    ("GAT bm cont bf16 (K=2, default dtype)",
     {"VQ_GNN_BENCH_FORM": "bm", "VQ_GNN_BENCH_CONV": "GAT", "VQ_GNN_BENCH_K": "2"}),
    ("GAT bbprime cluster f32", {"VQ_GNN_BENCH_CONV": "GAT", "VQ_GNN_BENCH_DTYPE": "float32"}),
    ("GAT bm cont f32 (K=2)",
     {"VQ_GNN_BENCH_FORM": "bm", "VQ_GNN_BENCH_CONV": "GAT", "VQ_GNN_BENCH_K": "2",
      "VQ_GNN_BENCH_DTYPE": "float32"}),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def profile_of(env) -> str:
    return env.get("VQ_GNN_BENCH_PROFILE", "arxiv")


def profile_sizes(profile: str):
    """The synthetic graph and partition of a profile; any name but
    'products' takes the arxiv sizes, as in bench.py."""
    return PROFILES.get(profile, PROFILES["arxiv"])


def bench_config(env):
    """The bench's ``Config`` from its knobs (bench.py:43-90)."""
    formulation = env.get("VQ_GNN_BENCH_FORM", "bbprime")
    conv = env.get("VQ_GNN_BENCH_CONV", "GCN")
    _, _, _, _, num_parts, batch_parts = profile_sizes(profile_of(env))
    bbprime = formulation == "bbprime"
    return Config(
        dataset="arxiv",
        conv_type=conv,
        formulation=formulation,
        num_layers=3,
        hidden_channels=128,
        num_D=4,
        num_M=256 if bbprime else 1024,
        sampler_type="cluster" if bbprime else "cont",
        walk_length=3,
        num_parts=num_parts,
        batch_size=batch_parts if bbprime else 10000,
        vq_update_mode=env.get("VQ_GNN_BENCH_MODE", "live"),
        warm_up_flag=True,
        skip=True,
        matmul_precision="default",
        vq_backend=env.get("VQ_GNN_BENCH_VQ_BACKEND", "pallas_fast"),
        spmm_backend=env.get("VQ_GNN_BENCH_SPMM", "ell"),
        # GAT streams bf16 by default, as bench.py:68 has it
        compute_dtype=env.get("VQ_GNN_BENCH_DTYPE", "bfloat16" if conv == "GAT" else "float32"),
        ell_K=int(env.get("VQ_GNN_BENCH_K", "8")),
        ell_Kt=int(env.get("VQ_GNN_BENCH_KT", "0")),
    )


# ---- the graph: real data, then the caches, then the synthetic SBM ----

def _save_npz(path, **arrays):
    """Write ``path`` itself (no '.npz' appended) in one rename, so a run cut
    off while writing leaves no partial cache."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _save_raw(path, g, c):
    coo = g.adj.tocoo()
    _save_npz(path, num_nodes=np.int64(g.num_nodes),
              edge_index=np.stack([coo.col.astype(np.int32), coo.row.astype(np.int32)]),
              x=g.x, y=g.y, train_mask=g.train_mask, val_mask=g.val_mask,
              test_mask=g.test_mask, num_classes=np.int64(c))


def _save_prepared(path, g, c, cluster_indices):
    arrays = {"num_nodes": np.int64(g.num_nodes), "adj_data": g.adj.data,
              "adj_indices": g.adj.indices, "adj_indptr": g.adj.indptr, "x": g.x,
              "num_classes": np.int64(c)}
    for k in ("y", "train_mask", "val_mask", "test_mask", "deg", "deg_inv"):
        if getattr(g, k) is not None:
            arrays[k] = getattr(g, k)
    if cluster_indices is not None:
        arrays["part_ptr"] = np.concatenate(
            [[0], np.cumsum([len(ci) for ci in cluster_indices])]).astype(np.int64)
    _save_npz(path, **arrays)


def _load_prepared(path):
    z = np.load(path, allow_pickle=False)
    n = int(z["num_nodes"])
    opt = lambda k: z[k] if k in z.files else None  # noqa: E731
    g = HostGraph(adj=sp.csr_matrix((z["adj_data"], z["adj_indices"], z["adj_indptr"]),
                                    shape=(n, n)),
                  x=z["x"], y=opt("y"), train_mask=opt("train_mask"),
                  val_mask=opt("val_mask"), test_mask=opt("test_mask"), deg=opt("deg"),
                  deg_inv=opt("deg_inv"))
    ci = cluster_indices_from_ptr(z["part_ptr"]) if "part_ptr" in z.files else None
    return g, int(z["num_classes"]), ci


def load_graph(cfg, env, log=log):
    """(graph, num_classes, cluster_indices), prepared for ``cfg``.

    Sources, first found first: real data at ``{data_root}/{profile}.npz``;
    with ``VQ_GNN_BENCH_CACHE`` set, the prepared graph cached beside that
    path, then the raw synthetic graph cached at it; else ``synthetic_sbm``
    at the profile's sizes, seed 0 (cached when the knob is set).  The
    prepared cache's key carries its source (synthetic, or the real file's
    size and mtime), so a graph prepared from synthetic data never stands
    in for real data."""
    profile = profile_of(env)
    n_syn, deg_syn, feat_syn, cls_syn, _, _ = profile_sizes(profile)
    real = os.path.join(cfg.data_root, f"{profile}.npz")
    if os.path.exists(real):
        st = os.stat(real)
        source = f"real{st.st_size}-{st.st_mtime_ns}"
    else:
        source = "synthetic"
    cache = env.get("VQ_GNN_BENCH_CACHE")
    prep = None
    if cache:
        prep = (f"{cache}.prepared.{profile}.{cfg.formulation}.{cfg.conv_type}.p{cfg.num_parts}"
                f".D{cfg.num_D}.s{int(cfg.split)}.{source}.npz")
        if os.path.exists(prep):
            g, c, ci = _load_prepared(prep)
            if source != "synthetic" or g.num_nodes == n_syn:
                log(f"loaded prepared cache {prep}: N={g.num_nodes} E={g.num_edges}")
                return g, c, ci
            log(f"prepared cache {prep} has N={g.num_nodes}, the profile {n_syn}: ignored")
    t0 = time.time()
    if source != "synthetic":
        g, c = load_npz(real)
        log(f"loaded {real}: N={g.num_nodes} E={g.num_edges}")
    else:
        g = None
        if cache and os.path.exists(cache):
            g, c = load_npz(cache)
            if g.num_nodes == n_syn:
                log(f"loaded cached synthetic graph {cache}: N={g.num_nodes} E={g.num_edges}")
            else:
                log(f"cache {cache} has N={g.num_nodes}, the profile {n_syn}: regenerating "
                    "(the cache is left as it is)")
                g, cache = None, None
        if g is None:
            g, c = synthetic_sbm(num_nodes=n_syn, num_classes=cls_syn, num_features=feat_syn,
                                 avg_degree=deg_syn, seed=0)
            log(f"synthetic {profile}-scale graph: N={g.num_nodes} E={g.num_edges} in "
                f"{time.time() - t0:.1f}s")
            if cache:
                _save_raw(cache, g, c)
                log(f"cached the synthetic graph at {cache}")
    t0 = time.time()
    g, c, ci = prepare(g, cfg, c)
    log(f"prepared: E(normalized)={g.num_edges}"
        + (f", {len(ci)} parts" if ci is not None else "") + f" in {time.time() - t0:.1f}s")
    if prep:
        _save_prepared(prep, g, c, ci)
        log(f"cached the prepared graph at {prep}")
    return g, c, ci


# ---- the timed step ----

def first_batch(graph, cfg, cluster_indices, device):
    """The first batch of the training loader (seed 0), on ``device``, and its
    real edges: the non-zero ELL values (bench.py:227-228)."""
    loader = BatchLoader(graph, cfg, train_flag=True, cluster_indices=cluster_indices,
                         device=device)
    # one epoch's first batch, without the loader's prefetch thread
    windows, _ = next(loader._epoch_iter())
    host = windows[0]
    E_batch, layout = batch_layout(host.edges, cfg)
    line = (f"batch: B={int(host.num_B)} B_pad={host.B_pad} Bp_pad={host.Bp_pad} E={E_batch} "
            + layout)
    return host.to(loader.device), E_batch, line


def batch_layout(e, cfg):
    """(real edges, the layout's words) of a host batch's adjacency, as
    bench.py:217-233 prints them for each layout: the non-zero values, and
    the mixed-K families' slot counts and padding share, the single-K slot
    counts, or the COO pad size."""
    if e.mixed:
        E_batch = int(np.count_nonzero(e.head_val)) + int(np.count_nonzero(e.tail_val))
        cells = e.head_col.size + e.tail_col.size
        return E_batch, (f"mixed-ELL K={cfg.ell_K}+{cfg.ell_Kt} Sh={e.head_rowc.shape[0]} "
                         f"St2={e.tail_row.shape[0]} pad={1 - E_batch / cells:.1%}")
    if e.ell_val is not None:
        return int(np.count_nonzero(e.ell_val)), (
            f"ELL K={cfg.ell_K} S_pad={e.ell_row.shape[0]} St_pad={e.t_ell_row.shape[0]}")
    return int(np.count_nonzero(e.val)), f"E_pad={e.row.shape[0]}"


def run_bench(cfg, graph, num_classes, cluster_indices, device=None, steps=STEPS, gpu="",
              log=log):
    """Time ``steps`` back-to-back training steps on the first batch, after one
    warm-up step, then (on a GPU) read peak memory and profile
    ``PROFILE_STEPS`` more steps; then time ``steps`` eval forwards.  Returns
    the record: ``E_batch``, ``dt_s``, ``eps``, ``ms_per_step``, ``loss``, the
    loss of each step (``losses``: the warm-up, then the timed steps; read
    after the timing, so no step waits for its loss) and, on a GPU, peak
    memory, device busy and idle share."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    apply_matmul_precision(cfg)
    if cuda:
        t0 = time.time()
        _build.build_all()
        log(f"kernel build (nvcc, where a library is missing or stale): {time.time() - t0:.1f}s")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    ms = model_static(cfg, graph.num_features, num_classes, dev)
    state = init_train_state(torch.Generator().manual_seed(0), ms, graph.num_nodes, cfg.lr, dev)
    fns = make_step_fns(ms, cfg)
    X = device_features(graph.x, dev)
    t0 = time.time()
    batch, E_batch, line = first_batch(graph, cfg, cluster_indices, dev)
    log(f"{line} (built in {time.time() - t0:.1f}s)")
    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []  # each step's loss, as the step returned it

    def step(_=None):
        nonlocal state
        state, metrics = fns.train_step(state, X, batch, 1.0, 0.01, 1.0, gen)
        return metrics

    t0 = time.time()
    m = step()
    losses.append(m["loss"])
    sync()
    log(f"first step: {time.time() - t0:.2f}s loss={float(m['loss']):.4f}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step()
        losses.append(m["loss"])
    sync()
    dt = time.perf_counter() - t0
    eps = E_batch * steps / dt
    rec = {"E_batch": E_batch, "steps": steps, "dt_s": dt, "eps": eps,
           "ms_per_step": 1e3 * dt / steps, "loss": float(m["loss"]),
           "losses": [float(v) for v in losses],
           "launches_per_step": {k: v / steps for k, v in ops.launch_counts().items() if v}}
    log(f"{steps} steps in {dt:.3f}s ({rec['ms_per_step']:.2f} ms/step) -> "
        f"{eps / 1e6:.2f}M edges/s/chip, loss={rec['loss']:.4f} | {gpu}")
    log(f"kernel launches per step: {rec['launches_per_step'] or 'none (plain path)'}")

    if cuda:
        total = torch.cuda.get_device_properties(dev).total_memory
        rec.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
                   device_memory_bytes=total, allocated_before_bytes=base)
        log(f"peak device memory: allocated {rec['peak_allocated_bytes'] / 1e9:.3f} GB "
            f"({100 * rec['peak_allocated_bytes'] / total:.2f}% of {total / 1e9:.1f} GB), "
            f"reserved {rec['peak_reserved_bytes'] / 1e9:.3f} GB "
            f"({100 * rec['peak_reserved_bytes'] / total:.2f}%); allocated before the bench "
            f"{base / 1e9:.3f} GB | {gpu}")
        prof = profile_steps(step, steps=PROFILE_STEPS, log=log, tag="bench", gpu=gpu)
        if prof is not None:
            rec.update(busy_ms=prof["busy_ms"], idle=1 - prof["busy_ms"] / rec["ms_per_step"])
            log(f"device busy {prof['busy_ms']:.2f} ms/step; idle {100 * rec['idle']:.1f}% of "
                f"the timed step ({rec['ms_per_step']:.2f} ms) | {gpu}")
    else:
        log("peak device memory and device busy: not measured (CPU run)")

    fns.eval_step(state, X, batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fns.eval_step(state, X, batch)
    sync()
    rec["eval_fwd_ms"] = (time.perf_counter() - t0) / steps * 1e3
    log(f"eval fwd: {rec['eval_fwd_ms']:.1f} ms")
    return rec


def record_line(eps: float) -> str:
    return json.dumps({"metric": "train_edges_per_sec_per_chip", "value": round(eps, 1),
                       "unit": "edges/s"})


# ---- the sweep ----

def default_cache() -> str:
    return os.path.join(tempfile.gettempdir(), "vq_gnn_bench_torch_sbm.npz")


def error_line(stderr: str) -> str:
    """The exception line of a failed run's traceback, else its last line."""
    lines = [ln.strip() for ln in stderr.splitlines() if ln.strip()]
    for ln in reversed(lines):
        if re.match(r"^[A-Za-z_][\w.]*(Error|Exception|Interrupt)\b", ln):
            return ln
    return lines[-1] if lines else ""


def run_cell(env_extra, timeout=SWEEP_TIMEOUT_S):
    env = dict(os.environ)
    # one generated graph shared by the cells (bench.py regenerates it otherwise)
    env.setdefault("VQ_GNN_BENCH_CACHE", default_cache())
    env.update(env_extra)
    t0 = time.time()
    try:
        p = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"timed out after {timeout}s", "wall_s": time.time() - t0}
    if p.returncode != 0:
        return {"error": error_line(p.stderr), "returncode": p.returncode,
                "wall_s": time.time() - t0, "stderr_tail": p.stderr[-2000:]}
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    detail = [ln for ln in p.stderr.splitlines() if ln.startswith("bench detail ")]
    rec.update(json.loads(detail[-1][len("bench detail "):]))
    rec["wall_s"] = time.time() - t0
    return rec


def _each(runs, key, scale=1.0, digits=2):
    return ", ".join(f"{r[key] * scale:.{digits}f}" for r in runs if r.get(key) is not None)


def sweep(reps: int, out: str) -> int:
    results = {}
    for name, env in SWEEP:
        runs = []
        for r in range(reps):
            rec = run_cell(env)
            log(f"[{name}] rep {r}: {rec}")
            runs.append(rec)
        results[name] = {"env": env, "runs": runs}
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print("| cell | edges/s per run (M) | ms/step | device busy ms/step | idle % | "
          "peak allocated GB | eval fwd ms | card |")
    print("|---|---|---|---|---|---|---|---|")
    for name, res in results.items():
        ok = [r for r in res["runs"] if "error" not in r]
        errors = sorted({r["error"] for r in res["runs"] if "error" in r})
        if not ok:
            print(f"| {name} | error: {'; '.join(errors)} | | | | | | |")
            continue
        print(f"| {name} | {_each(ok, 'value', 1e-6, 3)} | {_each(ok, 'ms_per_step')} | "
              f"{_each(ok, 'busy_ms')} | {_each(ok, 'idle', 100, 1)} | "
              f"{_each(ok, 'peak_allocated_bytes', 1e-9, 3)} | {_each(ok, 'eval_fwd_ms')} | "
              f"{ok[0].get('gpu', '')} |" + (f" errors: {'; '.join(errors)}" if errors else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="run every cell of SWEEP")
    ap.add_argument("--reps", type=int, default=2, help="runs of each sweep cell")
    ap.add_argument("--out", default=os.path.join(REPO, "bench_sweep_torch.json"),
                    help="the sweep's JSON file")
    a = ap.parse_args(argv)
    if a.sweep:
        return sweep(a.reps, a.out)

    env = os.environ
    cfg = bench_config(env)
    check_ported(cfg)
    dev = resolve_device("cuda")
    gpu = gpu_line()
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"profile {profile_of(env)}: {cfg}")
    t0 = time.time()
    graph = load_graph(cfg, env)
    log(f"graph ready in {time.time() - t0:.1f}s")
    rec = run_bench(cfg, *graph, device=dev, steps=STEPS, gpu=gpu)
    if not math.isfinite(rec["eps"]) or not math.isfinite(rec["loss"]):
        raise RuntimeError(f"non-finite result: {rec}")
    rec["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"host peak RSS {rec['host_peak_rss_bytes'] / 1e9:.2f} GB")
    log("bench detail " + json.dumps(dict(rec, gpu=gpu, profile=profile_of(env))))
    print(record_line(rec["eps"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
