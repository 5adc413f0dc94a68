"""Arxiv-scale VQ-vs-exact convergence parity experiment on the PyTorch/CUDA
port (``tools/parity_experiment.py``'s flags, defaults and configurations).

Runs the paper's central claim (mini-batch VQ training reaches the accuracy
of exact full-graph training, arXiv:2110.14363) at ogbn-arxiv scale.  The
graph is a 169,343-node synthetic SBM matched to arxiv's size and degree
profile; when ``datasets/arxiv.npz`` exists (see REAL_DATA.md) the real
graph is used instead.  The VQ config is the reference flagship (GCN,
cluster sampler, 80 parts, 40-part batches, num_D = 4, hidden 128, 3
layers), or with ``--formulation bm`` the v1 B + M formulation in the
reference reddit shape.

Usage (on a CUDA GPU; ``--device cpu`` runs the plain PyTorch path):
    python tools/parity_experiment_torch.py [--conv GCN] [--epochs 60] [--nodes 169343] \
        [--seeds 0 1 2]
    # the suite of tests/test_parity_convergence.py (chip_smoke.py phase 10a)
    python tools/parity_experiment_torch.py --suite convergence [--seeds 0 1 2]
    # the reference widths on that suite's 3,000-node graph
    python tools/parity_experiment_torch.py --graph convergence --formulation bm \
        --conv GAT --arms vq --epochs 40 --eval-every 5 --seeds 0 1 2

Differences from the JAX tool: ``--device`` in place of ``--cpu``, no
``--segment-dir`` (the port has no runtime leak to fence), and these
additions:
- ``--seeds``: the configuration's seed (parameters, codebooks, batches) of
  each run, the graph fixed, so one call measures the spread over seeds;
- ``--graph convergence``: the configuration on the 3,000-node SBM of
  ``tests/test_parity_convergence.py`` (``--nodes``, ``--noise`` and
  ``--informative-dims`` then unused);
- ``--suite convergence``: that test's four cases with their own configs,
  epochs, arms and bounds (the other options unused but ``--device`` and
  ``--seeds``);
- ``--vq-backend`` and ``--matmul-precision`` (``main_node.py``'s flags; by
  default the JAX tool's 'auto' and 'default'): 'pallas' and 'highest' run
  the card with the exact f32 assignment and matmuls a CPU run has.
Prints a result table per run, the spread of each arm over the seeds and one
JSON line.  ``VQ_GNN_REV_FOLD=fast`` selects the bf16 fold of the B + M
recovery term, as for the JAX package.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device(s: str) -> str:
    return "cpu" if s == "cpu" else f"cuda:{int(s)}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conv", default="GCN", choices=["GCN", "SAGE", "GAT"])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--exact-epochs", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=169_343)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--noise", type=float, default=4.0)
    # with all 128 dims informative the exact control saturates; 48
    # informative dims at noise 4.0 put it below the ceiling
    ap.add_argument("--informative-dims", type=int, default=48)
    # 'bm': the v1 B + M formulation in the reference reddit shape
    ap.add_argument("--formulation", default="bbprime", choices=["bbprime", "bm"])
    ap.add_argument("--device", type=_device, default="0",
                    help="n for the GPU cuda:n, or 'cpu' for the plain PyTorch path")
    ap.add_argument("--exact-lr", type=float, default=None,
                    help="tuned lr for the exact full-graph control (1 step/epoch)")
    ap.add_argument("--arms", default="both",
                    choices=["both", "all", "mb", "exact", "exact_mb", "vq"],
                    help="'both' = full-batch control + VQ; 'all' adds the exact mini-batch "
                         "control (same batches and update count, in-batch edges only)")
    ap.add_argument("--diag-log", default=None,
                    help="JSONL path for per-eval VQ codebook-health records of the VQ arm "
                         "(one file per seed: the seed is appended)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="the configuration's seed of each run (the graph is fixed)")
    ap.add_argument("--graph", default="arxiv", choices=["arxiv", "convergence"],
                    help="'convergence': the 3,000-node SBM of tests/test_parity_convergence.py")
    ap.add_argument("--suite", default=None, choices=["convergence"],
                    help="run the four cases of tests/test_parity_convergence.py")
    # the JAX tool's values by default; 'pallas' and 'highest' give the exact
    # f32 assignment and matmuls the CPU runs, to set a card run beside one
    ap.add_argument("--vq-backend", default="auto",
                    choices=["auto", "xla", "xla_fast", "pallas", "pallas_fast"])
    ap.add_argument("--matmul-precision", default="default", choices=["highest", "default"])
    return ap.parse_args(argv)


def vq_config(args, n: int):
    """The VQ arm's configuration (``tools/parity_experiment.py``)."""
    from vq_gnn_tpu_torch.config import Config

    if args.formulation == "bm":
        # the reference reddit shape on the v1 mapper formulation
        return Config(
            dataset="arxiv", conv_type=args.conv, formulation="bm", num_layers=3,
            hidden_channels=128, num_D=4, num_M=1024, sampler_type="cont", walk_length=3,
            cont_sliding_window=1, batch_size=10000, test_batch_size=n, recovery_flag=True,
            vq_update_mode="live", lr=1e-3, warm_up=True, warm_up_epochs=5, skip=False,
            matmul_precision=args.matmul_precision, vq_backend=args.vq_backend,
            # ~1.5 edges a row over B + B': K = 8 slots are mostly padding
            ell_K=2 if args.conv == "GAT" else 8,
        )
    # the reference arxiv flagship config, live VQ
    return Config(
        dataset="arxiv", conv_type=args.conv, num_layers=3, hidden_channels=128, num_D=4,
        num_M=256, sampler_type="cluster", num_parts=80, batch_size=40, test_batch_size=n,
        vq_update_mode="live", lr=0.01, warm_up=True, warm_up_epochs=5, skip=True,
        matmul_precision=args.matmul_precision, vq_backend=args.vq_backend,
    )


def _spread(vals):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    mean = sum(vals) / len(vals)
    std = (sum((v - mean) ** 2 for v in vals) / max(len(vals) - 1, 1)) ** 0.5
    return {"mean": mean, "std": std, "min": min(vals), "max": max(vals), "n": len(vals)}


# ---------------------------------------------------------------------------
# the suite of tests/test_parity_convergence.py, on the port
# ---------------------------------------------------------------------------
CONVERGENCE_N = 3000


def convergence_graph():
    """The suite's SBM: feature noise 4.0 makes the task graph-dependent and
    non-saturating, so a broken VQ path shows as a gap."""
    from vq_gnn_tpu_torch.graph.datasets import synthetic_sbm

    return synthetic_sbm(num_nodes=CONVERGENCE_N, num_classes=6, num_features=32,
                         avg_degree=10.0, homophily=0.7, feature_noise=4.0, seed=7)


_CONVERGENCE_BASE = dict(
    dataset="synthetic", num_layers=3, hidden_channels=32, num_D=4,
    test_batch_size=CONVERGENCE_N, vq_update_mode="live", lr=0.01, warm_up=True,
    warm_up_epochs=5, skip=True, pad_multiple_nodes=256, pad_multiple_edges=2048,
)
# name -> (config fields, epochs, eval_every, arms, epsilon, the control's
# floor): the full-graph cases hold vq >= exact - epsilon with exact > 0.78;
# the B + M case holds vq >= exact_mb - epsilon with exact_mb > 0.50
CONVERGENCE = {
    "GCN-cluster": (dict(_CONVERGENCE_BASE, conv_type="GCN", num_M=32, sampler_type="cluster",
                         num_parts=12, batch_size=3), 25, 3, "both", 0.025, 0.78),
    "GAT-cluster": (dict(_CONVERGENCE_BASE, conv_type="GAT", num_M=32, sampler_type="cluster",
                         num_parts=12, batch_size=3), 25, 3, "both", 0.025, 0.78),
    "SAGE-cont": (dict(_CONVERGENCE_BASE, conv_type="SAGE", num_M=64, sampler_type="cont",
                       walk_length=3, cont_sliding_window=2, batch_size=1024), 25, 3, "both",
                  0.035, 0.78),
    "GCN-bm": (dict(_CONVERGENCE_BASE, conv_type="GCN", formulation="bm", recovery_flag=True,
                    num_M=64, sampler_type="cont", walk_length=3, cont_sliding_window=1,
                    batch_size=1024, skip=False), 40, 5, "mb", 0.035, 0.50),
}


def run_convergence_case(name: str, device, seed=None):
    """One case of the suite through ``parity_gap`` (``seed`` overrides the
    config's).  Returns (result, control accuracy, VQ accuracy, whether the
    case's bounds hold)."""
    from vq_gnn_tpu_torch.config import Config
    from vq_gnn_tpu_torch.train.parity import parity_gap

    fields, epochs, eval_every, arms, eps, floor = CONVERGENCE[name]
    cfg = Config(**fields) if seed is None else Config(**{**fields, "seed": seed})
    res = parity_gap(convergence_graph, cfg, epochs=epochs, eval_every=eval_every, arms=arms,
                     device=device)
    ctrl = res["exact" if arms == "both" else "exact_mb"]["test_at_best_valid"]
    vq = res["vq"]["test_at_best_valid"]
    return res, ctrl, vq, ctrl > floor and vq >= ctrl - eps


def run_suite(args):
    """The four cases of tests/test_parity_convergence.py at each seed: the
    control's and the VQ arm's test accuracy at the best valid, and whether
    the test's bounds hold."""
    runs = []
    for name in CONVERGENCE:
        for seed in args.seeds:
            t0 = time.time()
            _, ctrl, vq, ok = run_convergence_case(name, args.device, seed=seed)
            runs.append({"case": name, "seed": seed, "control_test": ctrl, "vq_test": vq,
                         "gap": ctrl - vq, "bounds_hold": ok,
                         "seconds": round(time.time() - t0, 1)})
            print(f"[suite] {name} seed {seed}: control {ctrl:.4f} vq {vq:.4f} gap "
                  f"{ctrl - vq:+.4f} bounds {'hold' if ok else 'MISSED'} "
                  f"[{time.time() - t0:.1f}s on {args.device}]", flush=True)
    spread = {name: {k: _spread([r[k] for r in runs if r["case"] == name])
                     for k in ("control_test", "vq_test")} for name in CONVERGENCE}
    print(json.dumps({"experiment": "convergence_suite", "device": args.device, "runs": runs,
                      "spread": spread}))


REAL = os.path.join("datasets", "arxiv.npz")


def graph_source(args):
    """(graph_fn, its description): the graph ``args`` ask for, made afresh
    by each call of graph_fn."""
    from vq_gnn_tpu_torch.graph.datasets import load_npz, synthetic_sbm

    if args.graph == "convergence":
        return convergence_graph, "the SBM of tests/test_parity_convergence.py"
    if os.path.exists(REAL):
        return (lambda: load_npz(REAL)), "real ogbn-arxiv"

    def graph_fn():
        return synthetic_sbm(
            num_nodes=args.nodes, num_classes=40, num_features=128, avg_degree=13.7,
            homophily=0.7, feature_noise=args.noise, informative_dims=args.informative_dims,
            seed=7,
        )

    return graph_fn, f"synthetic SBM N={args.nodes}"


def main(argv=None):
    args = parse_args(argv)
    if args.suite:
        return run_suite(args)
    from vq_gnn_tpu_torch.train.parity import parity_gap

    graph_fn, src = graph_source(args)
    n = graph_fn()[0].num_nodes
    base = vq_config(args, n)
    runs = []
    t_all = time.time()
    for seed in args.seeds:
        t0 = time.time()
        res = parity_gap(
            graph_fn, dataclasses.replace(base, seed=seed), epochs=args.epochs,
            eval_every=args.eval_every, exact_epochs=args.exact_epochs, verbose=True,
            vq_diag_path=None if args.diag_log is None else f"{args.diag_log}.{seed}",
            exact_lr=args.exact_lr, arms=args.arms, device=args.device,
        )
        dt = time.time() - t0
        print(f"\n== parity @ {src}, {args.conv} {args.formulation}, seed {seed}, "
              f"{args.epochs} epochs, {dt:.0f}s on {args.device} ==")
        print(f"{'':16s}{'best valid':>12s}{'test@best':>12s}{'final test':>12s}")
        for k in ("exact", "exact_mb", "vq"):
            r = res[k]
            if r is not None:
                print(f"{k:16s}{r['best_valid']:>12.4f}{r['test_at_best_valid']:>12.4f}"
                      f"{r['final_test']:>12.4f}")
        print(f"gap (exact - vq): {res['gap']:+.4f}")
        if res["exact_mb"] is not None:
            print(f"gap (exact_mb - vq): {res['gap_mb']:+.4f}")
        runs.append({
            "seed": seed, "seconds": round(dt, 1),
            **{f"{k}_test": None if res[k] is None else res[k]["test_at_best_valid"]
               for k in ("exact", "exact_mb", "vq")},
            "gap": res["gap"], "gap_mb": res["gap_mb"],
        })
    spread = {k: _spread([r[k] for r in runs]) for k in ("exact_test", "exact_mb_test",
                                                         "vq_test")}
    if len(runs) > 1:
        print("\n== over seeds " + " ".join(map(str, args.seeds)) + " ==")
        for k, s in spread.items():
            if s is not None:
                print(f"{k:16s} mean {s['mean']:.4f} std {s['std']:.4f} "
                      f"min {s['min']:.4f} max {s['max']:.4f}")
    print(json.dumps({
        "experiment": "vq_vs_exact_parity", "source": src, "conv": args.conv,
        "formulation": args.formulation, "epochs": args.epochs, "device": args.device,
        "runs": runs, "spread": spread, "seconds": round(time.time() - t_all, 1),
    }))


if __name__ == "__main__":
    main()
