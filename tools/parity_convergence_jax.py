"""The suite of ``tests/test_parity_convergence.py`` on the JAX package, with
the accuracies printed: each case's control and VQ arm (test accuracy at the
best valid) at each seed, and whether the test's bounds hold.  The readings
the port's ``tools/parity_experiment_torch.py --suite convergence`` is set
beside.

Usage (on the CPU):
    JAX_PLATFORMS=cpu python tools/parity_convergence_jax.py [--seeds 0 1 2]
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


def cases():
    """name -> (config, epochs, eval_every, arms, epsilon, the control's
    floor), as tests/test_parity_convergence.py runs and bounds them: its
    CONFIGS and EPSILON, and the Config of its B + M test."""
    import test_parity_convergence as t
    from vq_gnn_tpu.config import Config

    bm = Config(conv_type="GCN", formulation="bm", recovery_flag=True, num_M=64,
                sampler_type="cont", walk_length=3, cont_sliding_window=1, batch_size=1024,
                **{**t.BASE, "skip": False})
    return {**{k: (c, 25, 3, "both", t.EPSILON[k], 0.78) for k, c in t.CONFIGS.items()},
            "GCN-bm": (bm, 40, 5, "mb", 0.035, 0.50)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

    import test_parity_convergence as t
    from vq_gnn_tpu.train.parity import parity_gap

    runs = []
    for name, (cfg, epochs, every, arms, eps, floor) in cases().items():
        for seed in args.seeds:
            t0 = time.time()
            res = parity_gap(t.graph_fn, dataclasses.replace(cfg, seed=seed), epochs=epochs,
                             eval_every=every, arms=arms)
            ctrl = res["exact" if arms == "both" else "exact_mb"]["test_at_best_valid"]
            vq = res["vq"]["test_at_best_valid"]
            ok = ctrl > floor and vq >= ctrl - eps
            runs.append({"case": name, "seed": seed, "control_test": ctrl, "vq_test": vq,
                         "gap": ctrl - vq, "bounds_hold": ok,
                         "seconds": round(time.time() - t0, 1)})
            print(f"[suite jax] {name} seed {seed}: control {ctrl:.4f} vq {vq:.4f} gap "
                  f"{ctrl - vq:+.4f} bounds {'hold' if ok else 'MISSED'} "
                  f"[{time.time() - t0:.1f}s]", flush=True)
    print(json.dumps({"experiment": "convergence_suite", "package": "vq_gnn_tpu",
                      "device": "cpu", "runs": runs}))


if __name__ == "__main__":
    main()
