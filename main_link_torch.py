"""Link-prediction CLI of the PyTorch/CUDA port: ``main_link.py``'s flags (the
reference ``vq_gnn_v2/main_link.py`` surface: collab Hits@50, citation2 MRR),
each under the same name, default and choices, mapped onto the port's
``Config`` as ``main_link.py`` maps them.  Runs on the GPU (``--device n``
for ``cuda:n``) unless ``--device cpu`` asks for the plain PyTorch path;
settings the port lacks raise ``NotImplementedError``.

    python3 main_link_torch.py --epochs 3 --num-layers 2 --hidden-channels 16 \
        --num-M 8 --batch-size 256 --test-batch-size 512 --lr 0.01 --device cpu

Without ``<data-root>/<dataset>.npz`` it trains on a synthetic graph, as
``main_link.py`` does.
"""

import argparse
import os

import numpy as np
import torch

from vq_gnn_tpu_torch.config import Config, check_ported, resolve_device
from vq_gnn_tpu_torch.graph.datasets import load_npz, prepare, synthetic_sbm
from vq_gnn_tpu_torch.train.link import LinkTrainer, SplitEdges


def _device(s: str) -> str:
    return "cpu" if s == "cpu" else f"cuda:{int(s)}"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VQ-GNN on PyTorch/CUDA (link prediction)")
    p.add_argument("--dataset", type=str, default="collab")
    p.add_argument("--data-root", type=str, default="./datasets")
    p.add_argument("--conv-type", type=str, default="GCN", choices=["GCN", "SAGE", "GAT"])
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--hidden-channels", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--test-batch-size", type=int, default=60000)
    p.add_argument("--num-M", type=int, default=1024)
    p.add_argument("--num-D", type=int, default=4)
    p.add_argument("--grad-scale", nargs="+", type=float, default=[1, 1])
    p.add_argument("--act", type=str, default="leaky_gelu")
    p.add_argument("--skip", action="store_true")
    p.add_argument("--warm-up", action="store_false", default=True)
    p.add_argument("--warm-up-epochs", type=float, default=0)
    p.add_argument("--momentum", type=float, default=0.1)
    p.add_argument("--sampler-type", type=str, default="cont",
                   choices=["node", "edge", "rw", "cont"])
    p.add_argument("--walk-length", type=int, default=15)
    p.add_argument("--cont-sliding-window", type=int, default=1)
    p.add_argument("--clip", nargs="+", type=float, default=None)
    p.add_argument("--ce-only", action="store_true")
    p.add_argument("--sche", action="store_true")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--log-steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vq-update-mode", type=str, default="live",
                   choices=["live", "reference"])
    p.add_argument("--vq-backend", type=str, default="auto",
                   choices=["auto", "xla", "xla_fast", "scan", "pallas",
                            "pallas_fast"])
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--ell-K", type=int, default=8)
    p.add_argument("--ell-Kt", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=_device, default="0",
                   help="n for the GPU cuda:n, or 'cpu' for the plain PyTorch path")
    return p.parse_args(argv)


def config_from_args(a) -> Config:
    return Config(
        dataset=a.dataset,
        data_root=a.data_root,
        conv_type=a.conv_type,
        num_layers=a.num_layers,
        hidden_channels=a.hidden_channels,
        dropout=a.dropout,
        lr=a.lr,
        epochs=a.epochs,
        batch_size=a.batch_size,
        test_batch_size=a.test_batch_size,
        num_M=a.num_M,
        num_D=a.num_D,
        grad_scale=tuple(a.grad_scale),
        act=a.act,
        skip=a.skip,
        warm_up=a.warm_up,
        warm_up_epochs=a.warm_up_epochs,
        warm_up_flag=a.warm_up,
        momentum=a.momentum,
        sampler_type=a.sampler_type,
        walk_length=a.walk_length,
        cont_sliding_window=a.cont_sliding_window,
        clip=a.clip,
        ce_only=a.ce_only,
        sche=a.sche,
        runs=a.runs,
        log_steps=a.log_steps,
        seed=a.seed,
        vq_update_mode=a.vq_update_mode,
        vq_backend=a.vq_backend,
        compute_dtype=a.compute_dtype,
        ell_K=a.ell_K,
        ell_Kt=a.ell_Kt,
    )


def load_link_data(cfg: Config):
    """collab-style npz with split edges, or a synthetic fallback."""
    path = os.path.join(cfg.data_root, f"{cfg.dataset}.npz")
    if os.path.exists(path):
        g, _ = load_npz(path)
        z = np.load(path)
        split = SplitEdges(
            train_pos=z["train_pos"],
            valid_pos=z["valid_pos"],
            valid_neg=z["valid_neg"],
            test_pos=z["test_pos"],
            test_neg=z["test_neg"],
            neg_per_source=cfg.dataset == "citation2",
        )
    else:
        print(f"{path} not found; using a synthetic graph")
        rng = np.random.RandomState(cfg.seed)
        g, _ = synthetic_sbm(num_nodes=2000, num_features=cfg.num_D * 8, seed=cfg.seed)
        coo = g.adj.tocoo()
        edges = np.stack([coo.row, coo.col], 1)
        edges = edges[edges[:, 0] != edges[:, 1]]
        e = edges[rng.permutation(len(edges))]

        def rand(n):
            return np.stack([rng.randint(0, g.num_nodes, n), rng.randint(0, g.num_nodes, n)], 1)

        split = SplitEdges(
            train_pos=e[:-2000], valid_pos=e[-2000:-1000], valid_neg=rand(5000),
            test_pos=e[-1000:], test_neg=rand(5000),
        )
    # reference quirk: collab is NOT symmetrized (main_link.py v2:283-284
    # symmetrizes citation2 only)
    g, _, _ = prepare(g, cfg, 0, symmetrize_adj=cfg.dataset != "collab")
    return g, split


def main(argv=None):
    """Train ``cfg.runs`` runs and print the logger's statistics; returns the
    trainer."""
    a = parse_args(argv)
    cfg = config_from_args(a)
    print(cfg)
    check_ported(cfg)
    device = resolve_device(a.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    g, split = load_link_data(cfg)
    trainer = LinkTrainer(g, cfg, split, device=device)
    for run in range(cfg.runs):
        trainer.fit(run=run, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every, resume=a.resume)
        trainer.logger.print_statistics(run)
    trainer.logger.print_statistics()
    return trainer


if __name__ == "__main__":
    main()
