"""ppi-shape inductive multilabel training at M = 4,096 on the PyTorch/CUDA
port: VQ-vs-exact micro-F1 (``tools/inductive_experiment.py``'s graphs,
configurations and flags).

Shape of the reference ppi GCN command (``vq_gnn_v1/main_node_inductive.py:
242-292``): hidden 256, num-M 4,096, num-D 4, node sampler batch 30,000, lr
3e-3, skip, multilabel micro-F1, each split its own graph.  The graphs are a
three-split SBM stand-in at ppi's size (44,906 / 6,514 / 5,524 nodes, 50
features, 121 labels, degree 28) with one feature-to-label map.

    python tools/inductive_experiment_torch.py [--arms both] [--epochs 60] [--scale 1.0]
    python tools/inductive_experiment_torch.py --device cpu --scale 0.02 --arms vq --epochs 5

Differences from the JAX tool: ``--device`` (n for ``cuda:n``, or ``cpu``)
in place of ``--cpu``, no ``--segment-dir`` (the port has no runtime leak to
fence) and no ``--bench`` (``chip_smoke.py`` phase 12 times the step).
Prints a result table and one JSON line.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# real PPI: 44,906 train / 6,514 valid / 5,524 test nodes, 50 feats,
# 121 multilabel classes, avg degree ~28
N_TRAIN, N_VAL, N_TEST = 44_906, 6_514, 5_524
FEATS, CLASSES, DEG = 50, 121, 28.0


def build_graphs(seed=7, scale=1.0):
    """The three split graphs (a copy of
    ``tools/inductive_experiment.py:build_graphs``): one SBM distribution,
    a graph seed each and one centroid seed, so the feature-to-label map is
    shared."""
    from vq_gnn_tpu_torch.graph.datasets import synthetic_sbm

    graphs = []
    for i, n in enumerate([int(N_TRAIN * scale), int(N_VAL * scale), int(N_TEST * scale)]):
        g, _ = synthetic_sbm(
            num_nodes=max(n, 64), num_classes=CLASSES, num_features=FEATS, avg_degree=DEG,
            multilabel=True, seed=seed + 101 * i, centroid_seed=seed,
        )
        g.train_mask = np.ones(g.num_nodes, dtype=bool)
        g.val_mask = g.test_mask = None
        graphs.append(g)
    return graphs


def vq_cfg(conv, epochs, scale=1.0):
    from vq_gnn_tpu_torch.config import Config

    return Config(
        dataset="ppi", conv_type=conv, num_layers=3, hidden_channels=256, num_D=4,
        sampler_type="node",
        batch_size=max(256, int((30_000 if conv != "GAT" else 10_000) * scale)),
        test_batch_size=0,  # per-split full batches (reference ppi cmds)
        lr=3e-3, epochs=epochs, skip=True, warm_up=True, warm_up_epochs=5, warm_up_flag=True,
        vq_update_mode="live", matmul_precision="default", vq_backend="auto",
        # smoke-scale runs shrink the codebook too (M = 4,096 at full scale)
        num_M=4096 if scale >= 1.0 else max(64, int(4096 * scale * 4)),
    )


def make_trainer(cfg, graphs, device):
    from vq_gnn_tpu_torch.graph.datasets import prepare_inductive
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    tr_g, val_g, test_g, c = prepare_inductive(graphs, cfg, CLASSES)
    return NodeTrainer(tr_g, cfg, c, device=device, use_ogb_acc=False, val_graph=val_g,
                       test_graph=test_g)


def run_arm(name, cfg, eval_every, seed, scale, device):
    tr = make_trainer(cfg, build_graphs(seed, scale), device)
    tr.run_init_sweep()
    print(f"[{name}] {cfg.conv_type} M={cfg.num_M} batch={cfg.batch_size} "
          f"epochs={cfg.epochs}", flush=True)
    t0 = time.time()
    for epoch in range(1, cfg.epochs + 1):
        loss, loss_cls = tr.train_epoch(epoch)
        if epoch % eval_every == 0 or epoch == cfg.epochs:
            f1_tr, f1_va, f1_te = tr.evaluate()
            tr.logger.add_result(0, (f1_tr, f1_va, f1_te))
            print(f"  epoch {epoch}: loss {loss_cls:.4f} f1 train {f1_tr:.4f} "
                  f"valid {f1_va:.4f} test {f1_te:.4f} [{time.time() - t0:.1f}s]", flush=True)
    stats = tr.logger.statistics(0)
    return {"highest_valid": stats["highest_valid"] / 100.0,
            "test_at_best_valid": stats["final_test"] / 100.0}


def _device(s: str) -> str:
    return "cpu" if s == "cpu" else f"cuda:{int(s)}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conv", default="GCN", choices=["GCN", "SAGE", "GAT"])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--exact-epochs", type=int, default=200)
    ap.add_argument("--exact-lr", type=float, default=3e-3)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--arms", default="both", choices=["both", "vq", "exact"])
    ap.add_argument("--device", type=_device, default="0",
                    help="n for the GPU cuda:n, or 'cpu' for the plain PyTorch path")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="graph-size scale (CPU smoke tests)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    t0 = time.time()
    res = {}
    if args.arms in ("both", "exact"):
        n_train = max(int(N_TRAIN * args.scale), 64)
        ex = dataclasses.replace(
            vq_cfg(args.conv, args.exact_epochs, args.scale), sampler_type="node",
            batch_size=n_train, ce_only=True, vq_update_mode="reference", warm_up=False,
            lr=args.exact_lr,
        )
        res["exact"] = run_arm("exact", ex, args.eval_every, 7, args.scale, args.device)
    if args.arms in ("both", "vq"):
        res["vq"] = run_arm("vq", vq_cfg(args.conv, args.epochs, args.scale),
                            args.eval_every, 7, args.scale, args.device)
    dt = time.time() - t0
    print(f"\n== inductive (ppi-shape) micro-F1, {args.conv}, scale {args.scale}, {dt:.0f}s ==")
    for k, r in res.items():
        print(f"{k:8s} best-valid F1 {r['highest_valid']:.4f}  "
              f"test@best {r['test_at_best_valid']:.4f}")
    out = {"experiment": "inductive_parity_f1", "conv": args.conv,
           "num_M": vq_cfg(args.conv, 1, args.scale).num_M, "epochs": args.epochs,
           "seconds": round(dt, 1)}
    for k, r in res.items():
        out[f"{k}_test"] = r["test_at_best_valid"]
    if "exact" in res and "vq" in res:
        out["gap"] = res["exact"]["test_at_best_valid"] - res["vq"]["test_at_best_valid"]
        print(f"gap (exact - vq): {out['gap']:+.4f}")
    print(json.dumps(out))
    return res


if __name__ == "__main__":
    main()
