"""Collab-scale link prediction on the PyTorch/CUDA port: VQ-vs-exact
Hits@50 (``tools/link_experiment.py``'s graph, configurations and flags).

Shape of the reference ogbl-collab GCN command (``vq_gnn_v2/main_link.py:
43-244``): N = 235,868, cont sampler walk 15, batch 50,000, num-M 1,024,
num-D 4, hidden 128, lr 3e-3, skip.  The graph is a latent dot-product
stand-in at collab's size and degree with an OGB-style edge split: the
training adjacency excludes the valid and test positives, and each
evaluation split has 100,000 random negatives.

    python tools/link_experiment_torch.py [--arms both] [--epochs 60] [--nodes 235868]
    python tools/link_experiment_torch.py --device cpu --nodes 3000 --arms vq --epochs 5

Differences from the JAX tool: ``--device`` (n for ``cuda:n``, or ``cpu``)
in place of ``--cpu``, no ``--segment-dir`` (the port has no runtime leak to
fence) and no ``--bench`` (``chip_smoke.py`` phase 11 times the step).
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

N_COLLAB = 235_868
DEG_COLLAB = 10.9  # 2 * 1.285M edges / N
FEAT_COLLAB = 128


def build_graph_and_split(seed=7, nodes=N_COLLAB):
    """Collab-scale latent dot-product graph and its OGB-style split (a copy
    of ``tools/link_experiment.py:build_graph_and_split``): valid and test
    positives are held out of the training adjacency, which is symmetrized
    by hand (the collab pipeline skips ``prepare``'s symmetrize)."""
    import scipy.sparse as sp

    from vq_gnn_tpu_torch.graph.datasets import synthetic_dot_product
    from vq_gnn_tpu_torch.train.link import SplitEdges

    g, _ = synthetic_dot_product(
        num_nodes=nodes, num_features=FEAT_COLLAB, avg_degree=DEG_COLLAB, seed=seed,
    )
    scale = nodes / N_COLLAB
    rng = np.random.RandomState(seed)
    coo = g.adj.tocoo()
    upper = coo.row < coo.col
    pairs = np.stack([coo.row[upper], coo.col[upper]], 1)
    pairs = pairs[rng.permutation(len(pairs))]
    n_test, n_valid = int(46_329 * scale), int(60_084 * scale)  # collab sizes
    test_pos = pairs[:n_test]
    valid_pos = pairs[n_test : n_test + n_valid]
    train_pos = pairs[n_test + n_valid :]

    def rand(n):
        return np.stack([rng.randint(0, g.num_nodes, n), rng.randint(0, g.num_nodes, n)], 1)

    n_neg = int(100_000 * scale)
    split = SplitEdges(
        train_pos=train_pos, valid_pos=valid_pos, valid_neg=rand(n_neg),
        test_pos=test_pos, test_neg=rand(n_neg),
    )
    r = np.concatenate([train_pos[:, 0], train_pos[:, 1]])
    c = np.concatenate([train_pos[:, 1], train_pos[:, 0]])
    g.adj = sp.csr_matrix(
        (np.ones(len(r), np.float32), (r, c)), shape=(g.num_nodes, g.num_nodes)
    )
    return g, split


def vq_config(conv, epochs):
    from vq_gnn_tpu_torch.config import Config

    return Config(
        dataset="collab", conv_type=conv, num_layers=3, hidden_channels=128, num_D=4,
        num_M=1024, sampler_type="cont", walk_length=15, cont_sliding_window=1,
        batch_size=50_000 if conv != "GAT" else 20_000, test_batch_size=80_000, lr=3e-3,
        epochs=epochs, skip=True, warm_up=True, warm_up_epochs=5, warm_up_flag=True,
        vq_update_mode="live", matmul_precision="default", vq_backend="auto",
    )


def scaled_config(cfg, nodes):
    """The JAX tool's cut for a graph of ``nodes`` < N_COLLAB: batches in
    proportion, M = 64, finer padding."""
    if nodes == N_COLLAB:
        return cfg
    return dataclasses.replace(
        cfg, batch_size=max(256, int(cfg.batch_size * nodes / N_COLLAB)),
        test_batch_size=max(512, int(cfg.test_batch_size * nodes / N_COLLAB)),
        num_M=64, pad_multiple_nodes=256, pad_multiple_edges=2048,
    )


def exact_cfg_from(cfg, num_nodes, lr, epochs):
    return dataclasses.replace(
        cfg, sampler_type="node", batch_size=num_nodes, test_batch_size=num_nodes,
        ce_only=True, vq_update_mode="reference", warm_up=False, lr=lr, epochs=epochs,
        exact_eval_train_edges=True,
    )


def run_arm(name, g, split, cfg, eval_every, device):
    from vq_gnn_tpu_torch.graph.datasets import prepare
    from vq_gnn_tpu_torch.train.link import LinkTrainer

    g2, _, _ = prepare(g, cfg, 0, symmetrize_adj=False)
    tr = LinkTrainer(g2, cfg, split, device=device)
    print(f"[{name}] {cfg.conv_type}/{cfg.sampler_type} batch={cfg.batch_size} "
          f"epochs={cfg.epochs}", flush=True)
    stats = tr.fit(run=0, verbose=True, eval_every=eval_every)
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
    ap.add_argument("--nodes", type=int, default=N_COLLAB,
                    help="scale override (CPU smoke tests)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    t0 = time.time()
    g, split = build_graph_and_split(nodes=args.nodes)
    cfg = scaled_config(vq_config(args.conv, args.epochs), args.nodes)
    res = {}
    if args.arms in ("both", "exact"):
        ex = exact_cfg_from(cfg, g.num_nodes, args.exact_lr, args.exact_epochs)
        g2, split2 = build_graph_and_split(nodes=args.nodes)  # prepare() mutates
        res["exact"] = run_arm("exact", g2, split2, ex, args.eval_every, args.device)
    if args.arms in ("both", "vq"):
        res["vq"] = run_arm("vq", g, split, cfg, args.eval_every, args.device)
    dt = time.time() - t0
    print(f"\n== link parity @ collab-scale dot-product graph N={args.nodes}, {args.conv}, "
          f"{dt:.0f}s ==")
    for k, r in res.items():
        print(f"{k:8s} best-valid Hits@50 {r['highest_valid']:.4f}  "
              f"test@best {r['test_at_best_valid']:.4f}")
    out = {"experiment": "link_parity_hits50", "conv": args.conv, "epochs": args.epochs,
           "N": args.nodes, "seconds": round(dt, 1)}
    for k, r in res.items():
        out[f"{k}_test"] = r["test_at_best_valid"]
    if "exact" in res and "vq" in res:
        out["gap"] = res["exact"]["test_at_best_valid"] - res["vq"]["test_at_best_valid"]
        print(f"gap (exact - vq): {out['gap']:+.4f}")
    print(json.dumps(out))
    return res


if __name__ == "__main__":
    main()
