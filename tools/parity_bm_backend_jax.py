"""The B + M VQ arm on the JAX package with the exact codeword assignment
(``vq_backend='xla'``) and with the fast one (``'xla_fast'``, bf16 distances,
the assignment the TPU default ``pallas_fast`` makes), on the CPU: the
reference widths of ``tools/parity_experiment.py --formulation bm`` (3 x 128,
num_D = 4, M = 1,024, cont sampler, batch 10,000, walk 3, lr 1e-3) on the
3,000-node SBM of ``tests/test_parity_convergence.py``, test accuracy at the
best valid epoch for each seed, and the mean, min and max over the seeds.
The JAX-side reading of the port's
``tools/parity_experiment_torch.py --graph convergence --formulation bm
--arms vq --vq-backend {xla,pallas_fast}``.

Usage (on the CPU):
    JAX_PLATFORMS=cpu python tools/parity_bm_backend_jax.py [--conv GCN GAT] \\
        [--backends xla xla_fast] [--seeds 0 1 2] [--epochs 20] [--eval-every 5]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax  # noqa: E402  (jax before torch)


def bm_config(conv: str, backend: str, n: int):
    """``tools/parity_experiment.py``'s B + M configuration, with ``backend``."""
    from vq_gnn_tpu.config import Config

    return Config(
        dataset="arxiv", conv_type=conv, formulation="bm", num_layers=3, hidden_channels=128,
        num_D=4, num_M=1024, sampler_type="cont", walk_length=3, cont_sliding_window=1,
        batch_size=10000, test_batch_size=n, recovery_flag=True, vq_update_mode="live",
        lr=1e-3, warm_up=True, warm_up_epochs=5, skip=False, matmul_precision="default",
        vq_backend=backend, ell_K=2 if conv == "GAT" else 8,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conv", nargs="+", default=["GCN", "GAT"], choices=["GCN", "GAT"])
    ap.add_argument("--backends", nargs="+", default=["xla", "xla_fast"],
                    choices=["xla", "xla_fast"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")

    import test_parity_convergence as t
    from vq_gnn_tpu.train.parity import parity_gap

    n = t.graph_fn()[0].num_nodes
    runs = []
    for conv in args.conv:
        for backend in args.backends:
            accs = []
            for seed in args.seeds:
                t0 = time.time()
                cfg = dataclasses.replace(bm_config(conv, backend, n), seed=seed)
                res = parity_gap(t.graph_fn, cfg, epochs=args.epochs,
                                 eval_every=args.eval_every, arms="vq")
                acc = res["vq"]["test_at_best_valid"]
                accs.append(acc)
                runs.append({"conv": conv, "backend": backend, "seed": seed, "vq_test": acc,
                             "seconds": round(time.time() - t0, 1)})
                print(f"[bm backend jax] {conv} {backend} seed {seed}: vq test at best valid "
                      f"{acc:.4f} [{time.time() - t0:.1f}s]", flush=True)
            print(f"[bm backend jax] {conv} {backend}: mean {sum(accs) / len(accs):.4f} "
                  f"(min {min(accs):.4f}, max {max(accs):.4f}) over seeds {args.seeds}",
                  flush=True)
    print(json.dumps({"experiment": "bm_vq_backend", "package": "vq_gnn_tpu", "device": "cpu",
                      "epochs": args.epochs, "eval_every": args.eval_every, "runs": runs}))


if __name__ == "__main__":
    main()
