"""The port's collective ledger at the bench flagship's widths, on the CPU:
the data-parallel step (``parallel/multihost.py:make_ddp_step``) and the
1-D sharded step (``parallel/sharded.py:make_sharded_step``) of the bench's
GCN cell, and the 1-D sharded step of its GAT cell (bf16 compute, as the
bench runs it), and the 1-D sharded step of the bench's B + M cells (cont
sampler, M = 1,024): GCN with ``transformer_flag`` and GAT (f32, K = 2) on
COO, and the GCN cell's 1-D sharded link step
(``make_sharded_link_step``: a link batch's in-batch pairs, a predictor of
the hidden width) and multilabel step (``make_sharded_step(...,
multilabel=True)``, on an SBM of the same size with multilabel targets),
on two gloo ranks, one step each, and their bytes and calls a step by
category.  The counterpart of ``tools/collective_ledger_at_scale.py``, which compiles the
JAX package's DDP step and reads its HLO; the port runs its steps.

    python tools/collective_ledger_at_scale_torch.py [--nodes 169343] \
        [--ell-Kt 2 | --spmm-backend coo]

The graph is the bench's arxiv-scale SBM (``--nodes`` cuts it; the widths
stay: 3 layers x 128, num_D = 4, M = 256, 80 cluster parts), normalised
for each conv.  The sharded steps take one batch of 40 parts, split over
the two ranks; the DDP step
gives each rank a batch of half as many nodes from its own half of the
graph (``partition_hosts``), at fixed pads both ranks share.  Row 6 runs
as ``vq_backend='scan'`` (the plain assignment in row chunks), which moves
the same collectives as the kernels.  ``--ell-Kt`` and ``--spmm-backend``
put every step on that adjacency layout (``Config.ell_Kt``, the mixed-K
slot-ELL, or ``spmm_backend='coo'``), as the CLI's flags do (not the
B + M steps, whose layouts are their own).  The B + M batches hold up to
10,000 roots and their walks: their transformer's [nb, B, M] products
peak at ~20 GB a rank at ``--nodes 12000`` (~2 min on 8 cores); a smaller
``--nodes`` cuts them.  Prints one JSON line on stdout.
"""

import argparse
import copy
import dataclasses
import json
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RANKS = 2


def ledger_of(step) -> dict:
    """A step's ledger: bytes and calls a step by category, the MB a step
    in all, the largest single payload's bytes and the row exchanges'
    dtypes."""
    import torch

    per = step.ledger.per_step()
    size = {dt: torch.empty(0, dtype=getattr(torch, dt)).element_size()
            for _, _, dt, _ in step.ledger.kinds}
    return {"bytes": per["bytes"], "calls": per["calls"],
            "MB": round(sum(per["bytes"].values()) / 1e6, 4),
            "largest_B": max(sum(math.prod(s) for s in shapes) * size[dt]
                             for _, _, dt, shapes in step.ledger.kinds),
            "rows_dtypes": sorted({dt for cat, _, dt, _ in step.ledger.kinds if cat == "rows"})}


def rank_main(rank: int, tmp: str, nodes: int, layout: dict) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from bench_torch import PROFILES, bench_config
    from vq_gnn_tpu_torch.graph.datasets import prepare, synthetic_sbm
    from vq_gnn_tpu_torch.graph.partition import permute_graph
    from vq_gnn_tpu_torch.nn.model import model_static
    from vq_gnn_tpu_torch.parallel import (
        init_distributed,
        make_ddp_step,
        make_mesh,
        make_sharded_link_step,
        make_sharded_step,
        partition_hosts,
        shard_train_inputs,
    )
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
    from vq_gnn_tpu_torch.train.link import init_predictor
    from vq_gnn_tpu_torch.train.loop import device_features
    from vq_gnn_tpu_torch.train.optim import make_rmsprop
    from vq_gnn_tpu_torch.train.state import init_train_state

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // RANKS))
    init_distributed("gloo", f"file://{tmp}/pg", RANKS, rank)
    cpu = torch.device("cpu")
    # the bench's default cell, with row 6 as the plain assignment in row chunks
    cfg = dataclasses.replace(bench_config({}), vq_backend="scan", **layout)
    _, degree, features, classes, _, _ = PROFILES["arxiv"]
    g0, c0 = synthetic_sbm(num_nodes=nodes, num_classes=classes, num_features=features,
                           avg_degree=degree, seed=0)
    g, c, ci = prepare(copy.deepcopy(g0), cfg, c0)  # prepare normalises in place
    ms = model_static(cfg, g.num_features, c, cpu)

    def state():
        return init_train_state(torch.Generator().manual_seed(0), ms, g.num_nodes, cfg.lr, cpu)

    out = {}
    mesh = make_mesh(RANKS, device="cpu")

    def sharded(cf, gr, ci_, ms_, init, link=False, multilabel=False):
        """One step of the 1-D sharded step (the link step with ``link``) on
        one batch of 40 parts, each rank its half of the rows (and of the
        link pairs): (the batch, its ledger)."""
        b = next(BatchLoader(gr, cf, train_flag=True, cluster_indices=ci_, seed=0, device="cpu",
                             with_link_edges=link)._epoch_iter())[0][0]
        st, X_, shard = shard_train_inputs(mesh, init(), device_features(gr.x, cpu), b)
        if link:
            step = make_sharded_link_step(ms_, cf, mesh)
            pred = init_predictor(torch.Generator().manual_seed(1), cf.hidden_channels,
                                  cf.hidden_channels, 1, cf.num_layers)
            step(st, pred, make_rmsprop(pred.parameters(), cf.lr), X_, shard, 1.0, cf.lr, 1.0,
                 torch.Generator().manual_seed(2))
            extra = dict(L_pad=len(b.link_src), pairs=int(b.link_mask.sum()))
        else:
            step = make_sharded_step(ms_, cf, mesh, multilabel=multilabel)
            step(st, X_, shard, 1.0, cf.lr, 1.0)
            extra = {}
        return b, dict(B=int(b.num_B), B_pad=b.B_pad, Bp_pad=b.Bp_pad, **extra,
                       **ledger_of(step))

    batch, out["sharded"] = sharded(cfg, g, ci, ms, state)
    # the GCN cell's link step (the model's output the hidden width, as the
    # link trainer's) and its multilabel step (the same SBM, 40 labels)
    ms_link = model_static(cfg, g.num_features, cfg.hidden_channels, cpu)
    _, out["sharded_link"] = sharded(cfg, g, ci, ms_link, lambda: init_train_state(
        torch.Generator().manual_seed(0), ms_link, g.num_nodes, cfg.lr, cpu), link=True)
    g_ml, c_ml = synthetic_sbm(num_nodes=nodes, num_classes=classes, num_features=features,
                               avg_degree=degree, multilabel=True, seed=0)
    g_ml, c_ml, ci_ml = prepare(g_ml, cfg, c_ml)
    ms_ml = model_static(cfg, g_ml.num_features, c_ml, cpu)
    _, out["sharded_multilabel"] = sharded(cfg, g_ml, ci_ml, ms_ml, lambda: init_train_state(
        torch.Generator().manual_seed(0), ms_ml, g_ml.num_nodes, cfg.lr, cpu), multilabel=True)
    del g_ml
    X = device_features(g.x, cpu)
    # the bench's GAT cell (bf16 compute), on the graph normalised for GAT
    gat_cfg = dataclasses.replace(bench_config({"VQ_GNN_BENCH_CONV": "GAT"}), vq_backend="scan",
                                  **layout)
    g_gat, c_gat, ci_gat = prepare(copy.deepcopy(g0), gat_cfg, c0)
    ms_gat = model_static(gat_cfg, g_gat.num_features, c_gat, cpu)
    _, out["sharded_gat_bf16"] = sharded(
        gat_cfg, g_gat, ci_gat, ms_gat, lambda: init_train_state(
            torch.Generator().manual_seed(0), ms_gat, g_gat.num_nodes, gat_cfg.lr, cpu))
    del g_gat
    # the bench's B + M cells: GCN with the transformer, GAT on COO
    for key, env, extra in (
            ("sharded_bm_gcn_transformer", {"VQ_GNN_BENCH_FORM": "bm", "VQ_GNN_BENCH_CONV": "GCN"},
             dict(transformer_flag=True)),
            ("sharded_bm_gat_coo", {"VQ_GNN_BENCH_FORM": "bm", "VQ_GNN_BENCH_CONV": "GAT",
                                    "VQ_GNN_BENCH_K": "2", "VQ_GNN_BENCH_DTYPE": "float32"},
             dict(spmm_backend="coo"))):
        bm_cfg = dataclasses.replace(bench_config(env), vq_backend="scan", **extra)
        g_bm, c_bm, ci_bm = prepare(copy.deepcopy(g0), bm_cfg, c0)
        ms_bm = model_static(bm_cfg, g_bm.num_features, c_bm, cpu)
        _, out[key] = sharded(
            bm_cfg, g_bm, ci_bm, ms_bm, lambda: init_train_state(
                torch.Generator().manual_seed(0), ms_bm, g_bm.num_nodes, bm_cfg.lr, cpu))
        del g_bm

    # the DDP step: each rank half as many nodes from its half of the graph
    perm, ptr = partition_hosts(g.adj, RANKS)
    gp = permute_graph(g, perm)
    half = int(batch.num_B) // RANKS
    node_cfg = dataclasses.replace(cfg, sampler_type="node")
    loaders = [BatchLoader(gp, node_cfg, train_flag=True, shuffle=False, seed=h, device="cpu")
               for h in range(RANKS)]
    for h, ld in enumerate(loaders):  # every rank builds both: the shared pads
        ld._build(np.arange(ptr[h], ptr[h] + half))
    pads = {k: max(getattr(ld, a) for ld in loaders) for k, a in
            (("fixed_B_pad", "_B_bucket"), ("fixed_Bp_pad", "_Bp_bucket"),
             ("fixed_E_pad", "_E_bucket"))}
    ddp_cfg = dataclasses.replace(node_cfg, **pads)
    b = BatchLoader(gp, ddp_cfg, train_flag=True, shuffle=False, seed=rank,
                    device="cpu")._build(np.arange(ptr[rank], ptr[rank] + half)).to(cpu)
    step = make_ddp_step(ms, ddp_cfg)
    step(state(), device_features(gp.x, cpu), b, 1.0, cfg.lr, 1.0)
    out["ddp"] = dict(B=half, B_pad=b.B_pad, Bp_pad=b.Bp_pad, **ledger_of(step))
    if rank == 0:
        print(json.dumps({"experiment": "collective_ledger_at_scale_torch", "nodes": nodes,
                          "ranks": RANKS, "layout": layout or "single-K", "num_M": cfg.num_M, "nb": ms.num_branches[0],
                          "feature_table_B": X.numel() * 4,
                          "c_indices_table_B": (g.num_nodes + 1) * ms.num_branches[0] * 2,
                          **out}), flush=True)
    dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=169_343, help="the graph's nodes (the bench's "
                   "arxiv profile: 169,343)")
    p.add_argument("--ell-Kt", type=int, default=0, help="the mixed-K layout's tail width "
                   "(Config.ell_Kt; 0: single-K)")
    p.add_argument("--spmm-backend", choices=("ell", "coo"), default="ell",
                   help="'coo': the COO layout")
    args = p.parse_args()
    layout = {k: v for k, v in (("ell_Kt", args.ell_Kt), ("spmm_backend", args.spmm_backend))
              if v not in (0, "ell")}
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(tmp, args.nodes, layout), nprocs=RANKS, join=True)


if __name__ == "__main__":
    main()
