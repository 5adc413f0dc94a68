"""Node-classification CLI of the PyTorch/CUDA port: ``main_node.py``'s flags
(the reference ``vq_gnn_v2/main_node.py`` surface), each under the same name,
default and choices, mapped onto the port's ``Config`` as ``main_node.py``
maps them.  Runs on the GPU (``--device n`` for ``cuda:n``) unless
``--device cpu`` asks for the plain PyTorch path; settings the port lacks
raise ``NotImplementedError``.

    python3 main_node_torch.py --dataset synthetic:500 --num-layers 2 \
        --hidden-channels 16 --num-D 4 --num-M 8 --batch-size 128 \
        --test-batch-size 256 --epochs 3 --skip --lr 0.05
"""

import argparse

import torch

from vq_gnn_tpu_torch.config import Config, check_ported, resolve_device
from vq_gnn_tpu_torch.graph.datasets import get_data
from vq_gnn_tpu_torch.train.loop import NodeTrainer


def _device(s: str) -> str:
    return "cpu" if s == "cpu" else f"cuda:{int(s)}"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VQ-GNN on PyTorch/CUDA (node classification)")
    p.add_argument("--dataset", type=str, default="arxiv")
    p.add_argument("--data-root", type=str, default="./datasets")
    p.add_argument("--conv-type", type=str, default="GCN", choices=["GCN", "SAGE", "GAT"])
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--hidden-channels", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--test-batch-size", type=int, default=60000)
    p.add_argument("--num-M", type=int, default=256)
    p.add_argument("--num-D", type=int, default=4)
    p.add_argument("--grad-scale", nargs="+", type=float, default=[1, 1])
    p.add_argument("--act", type=str, default="leaky_gelu")
    p.add_argument("--bn-flag", action="store_false", default=True)
    p.add_argument("--warm-up", action="store_false", default=True)
    p.add_argument("--warm-up-epochs", type=float, default=0)
    p.add_argument("--momentum", type=float, default=0.1)
    p.add_argument("--skip", action="store_true")
    p.add_argument("--commitment-cost", type=float, default=0.0)
    p.add_argument("--ce-only", action="store_true")
    p.add_argument("--sche", action="store_true")
    p.add_argument("--alpha-dropout-flag", action="store_true")
    p.add_argument("--dropbranch", type=float, default=0.0)
    p.add_argument("--sampler-type", type=str, default="node",
                   choices=["node", "edge", "rw", "cont", "cluster"])
    # accepted-for-surface-parity flags (vestigial in the reference too:
    # --use-gcn "not used" per its parser, --num-branch/--cluster/--ln-para/
    # --no-second-fc/--weight-ahead gate dead or single-path code)
    p.add_argument("--EMA", action="store_false", default=True)
    p.add_argument("--split", action="store_false", default=True)
    p.add_argument("--no-second-fc", action="store_false", default=True)
    p.add_argument("--ln-para", action="store_true")
    p.add_argument("--kmeans-init", action="store_true")
    p.add_argument("--kmeans-iter", type=int, default=100)
    p.add_argument("--weight-ahead", action="store_true")
    p.add_argument("--use-gcn", action="store_true")
    p.add_argument("--num-branch", type=int, default=0)
    p.add_argument("--cluster", type=str, default="vq")
    p.add_argument("--clip", nargs="+", type=float, default=None)
    p.add_argument("--device", type=_device, default="0",
                   help="n for the GPU cuda:n, or 'cpu' for the plain PyTorch path")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--exp-name", type=str, default="test")
    p.add_argument("--exp", action="store_true")
    p.add_argument("--exp-tag", type=str, default="exp")
    p.add_argument("--run-idx", type=int)
    p.add_argument("--num-parts", type=int, default=1)
    p.add_argument("--walk-length", type=int, default=5)
    p.add_argument("--cont-sliding-window", type=int, default=1)
    p.add_argument("--recovery-flag", action="store_false", default=True)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--log-steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--transformer-flag", action="store_true")
    # the JAX package's extras
    p.add_argument("--formulation", type=str, default="bbprime",
                   choices=["bbprime", "bm"],
                   help="bbprime = v2 B+B' (arxiv/ppi/collab); bm = v1 B+M "
                        "mapper (reddit/flickr)")
    p.add_argument("--vq-update-mode", type=str, default="live",
                   choices=["live", "reference"])
    p.add_argument("--spmm-backend", type=str, default="ell",
                   choices=["ell", "coo"])
    p.add_argument("--vq-backend", type=str, default="auto",
                   choices=["auto", "xla", "xla_fast", "scan", "pallas",
                            "pallas_fast"],
                   help="auto = pallas_fast (the CUDA kernels) on a GPU / xla "
                        "(plain PyTorch) on the CPU; xla & pallas = exact-f32 "
                        "assignment; *_fast = bf16 distances (fastest)")
    p.add_argument("--matmul-precision", type=str, default="highest",
                   choices=["highest", "default"])
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="streaming dtype for the aggregate path "
                        "(accumulation stays f32)")
    p.add_argument("--ell-K", type=int, default=8,
                   help="edges per slot-ELL row (K)")
    p.add_argument("--ell-Kt", type=int, default=0,
                   help="mixed-K tail slot width (0 = single-K layout); "
                        "Kt>0 splits rows into full K-slots + a Kt-wide "
                        "tail, cutting slot-padding waste")
    p.add_argument("--vq-diagnostics", action="store_true")
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    return p.parse_args(argv)


def config_from_args(a) -> Config:
    cfg = Config(
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
        bn_flag=a.bn_flag,
        warm_up=a.warm_up,
        warm_up_epochs=a.warm_up_epochs,
        warm_up_flag=a.warm_up,
        momentum=a.momentum,
        skip=a.skip,
        commitment_cost=a.commitment_cost,
        ce_only=a.ce_only,
        sche=a.sche,
        alpha_dropout_flag=a.alpha_dropout_flag,
        dropbranch=a.dropbranch,
        sampler_type=a.sampler_type,
        num_parts=a.num_parts,
        walk_length=a.walk_length,
        cont_sliding_window=a.cont_sliding_window,
        recovery_flag=a.recovery_flag,
        runs=a.runs,
        log_steps=a.log_steps,
        seed=a.seed,
        split=a.split,
        ema_flag=a.EMA,
        kmeans_init=a.kmeans_init,
        kmeans_iter=a.kmeans_iter,
        clip=a.clip,
        transformer_flag=a.transformer_flag,
        formulation=a.formulation,
        vq_update_mode=a.vq_update_mode,
        spmm_backend=a.spmm_backend,
        vq_backend=a.vq_backend,
        matmul_precision=a.matmul_precision,
        compute_dtype=a.compute_dtype,
        ell_K=a.ell_K,
        ell_Kt=a.ell_Kt,
    )
    return cfg


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
    graph, num_classes, cluster_indices = get_data(cfg)
    trainer = NodeTrainer(graph, cfg, num_classes, cluster_indices=cluster_indices,
                          device=device)
    for run in range(cfg.runs):
        trainer.fit(run=run, ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every, resume=a.resume,
                    vq_diagnostics=a.vq_diagnostics)
        trainer.logger.print_statistics(run)
    trainer.logger.print_statistics()
    return trainer


if __name__ == "__main__":
    main()
