"""One rank of the gloo group that ``tests/test_torch_port_mesh.py`` spawns.

    python tests/_torch_mesh_worker.py RANK WORLD INIT_FILE PLAN OUT

Reads the plan (a pickle the test writes: per case a ``Config``'s fields,
the graph's generator arguments, the initial train state as numpy, the
mesh, ``(1d, n)`` or ``(2d, n_data, n_model)``, and the whole batch's
dropbranch and dropout masks), builds the case's first batch with the
port's ``BatchLoader`` on every rank alike (in the case's layout), takes
this rank's shard, runs one sharded step and pickles the metrics, the state
(with the RMSprop square averages), the collective ledger and the batch's
arrays.  A multilabel case (its graph's ``multilabel``) runs the step with
BCE; a link case (``link``) builds a link batch and runs the sharded link
step with the plan's predictor (numpy, the JAX layout), negatives and
predictor masks, and pickles the predictor and its square averages too,
with the per-layer clip's scales where ``cfg.clip`` is set.  A float64
case (``f64``) casts the state, the features, the predictor and the shard
to float64 (``convert.py:state_as``, ``predictor_as``, ``batch_as``) and
pickles each layer's VQ inputs too (``vq_in``: the layer input's and the
probe gradient's branch slices).  The meshes: the whole group of four
(1-D), ranks 0 and 1 (1-D, and 2-D at 1 x 2: one data rank, two model
ranks) and 2 x 2.  Ranks outside a case's mesh (a mesh of two in a group
of four) make its groups and sit it out.  The plan's ``scale`` cases (ranks 0 and 1) run the
sharded Trick-1 scale on each rank's logits and pickle its value and the
logits' gradients: the B + B' scalar scale, or with ``kind`` 'branch-scale'
the B + M per-branch one (with the codebooks' logits and their
gradients), or with ``kind`` 'cmax' the transformer branch's c_max (the
rows' squared norms [B, nb] and the codewords' [M, nb], and their
gradients).  Imports the port and torch only, never JAX.
"""

import contextlib
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vq_gnn_tpu_torch.config import Config  # noqa: E402
from vq_gnn_tpu_torch.convert import (  # noqa: E402
    batch_as,
    predictor_as,
    predictor_from_numpy,
    state_as,
    state_from_numpy,
)
from vq_gnn_tpu_torch.graph.datasets import prepare, synthetic_sbm  # noqa: E402
from vq_gnn_tpu_torch.nn.model import model_static, transformer_cmax  # noqa: E402
from vq_gnn_tpu_torch.nn.vq import VQState  # noqa: E402
from vq_gnn_tpu_torch.ops.gat import branch_scale, explosion_scale  # noqa: E402
from vq_gnn_tpu_torch.parallel import (  # noqa: E402
    CollectiveLedger,
    DataMesh,
    Mesh2D,
    init_distributed,
    make_mesh_2d,
    make_sharded_link_step,
    make_sharded_link_step_2d,
    make_sharded_step,
    make_sharded_step_2d,
    shard_train_inputs,
    shard_train_inputs_2d,
)
from vq_gnn_tpu_torch.parallel import sharded  # noqa: E402
from vq_gnn_tpu_torch.parallel.multihost import _Collectives  # noqa: E402
from vq_gnn_tpu_torch.parallel.sharded import _ScaleRanks  # noqa: E402
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader  # noqa: E402
from vq_gnn_tpu_torch.train.loop import device_features  # noqa: E402
from vq_gnn_tpu_torch.train import step as step_mod  # noqa: E402
from vq_gnn_tpu_torch.train.optim import rmsprop_nu  # noqa: E402

VQ_FIELDS = [f.name for f in dataclasses.fields(VQState)]
BATCH_FIELDS = ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask", "link_src",
                "link_dst", "link_mask")
# the batch's adjacency in each layout: single-K, mixed-K, COO
EDGE_FIELDS = ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col", "t_ell_val",
               "head_rowc", "head_col", "head_val", "head_inv", "head_rowg", "tail_row",
               "tail_col", "tail_val", "t_head_rowc", "t_head_col", "t_head_val", "t_head_inv",
               "t_head_rowg", "t_tail_row", "t_tail_col", "t_tail_val", "row", "col", "val",
               "tperm")


def run_scale(case: dict, rank: int, meshes: dict) -> dict:
    """This rank's logits (or squared norms), valid rows and cotangent of
    the scale (or c_max), through ``explosion_scale``, ``branch_scale`` or
    ``transformer_cmax`` with the ranks of the pair's group."""
    mesh = meshes[2]
    if mesh is None:
        return {}
    ranks = _ScaleRanks(_Collectives(mesh.group, CollectiveLedger()))
    valid = torch.tensor(case["valid"][rank])
    g = torch.as_tensor(case["g"][rank])
    al = torch.tensor(case["al"][rank], requires_grad=True)
    if case["kind"] == "cmax":  # al: the rows' squared norms, al_cb: the codewords'
        nM = torch.tensor(case["al_cb"], requires_grad=True)
        cmax = transformer_cmax(al.t(), nM.t(), valid, ranks)
        (g * cmax).sum().backward()
        return {"scale": cmax.detach().numpy(), "d_al": al.grad.numpy(),
                "d_al_cb": nM.grad.numpy()}
    ar = torch.tensor(case["ar"][rank], requires_grad=True)
    if case["kind"] == "scale":
        scale = explosion_scale(al, ar, valid, ranks)
        (g * scale).backward()
        return {"scale": float(scale), "d_al": al.grad.numpy(), "d_ar": ar.grad.numpy()}
    cb = [torch.tensor(case[k], requires_grad=True) for k in ("al_cb", "ar_cb")]
    scale = branch_scale(al, ar, *cb, valid, ranks)
    (g * scale).sum().backward()
    return {"scale": scale.detach().numpy(), "d_al": al.grad.numpy(), "d_ar": ar.grad.numpy(),
            "d_al_cb": cb[0].grad.numpy(), "d_ar_cb": cb[1].grad.numpy()}


@contextlib.contextmanager
def vq_inputs(into):
    """A context in which ``train/step.py``'s ``vq_update`` appends each
    call's branch slices of the layer input and of the probe gradient
    (numpy, at their dtype) to the list ``into``, one call a layer; where
    ``into`` is None, none."""
    orig = step_mod.vq_update

    def wrapped(state, X_B, grad, *a, **kw):
        into.append({"X": X_B.detach().numpy().copy(), "G": grad.detach().numpy().copy()})
        return orig(state, X_B, grad, *a, **kw)

    if into is not None:
        step_mod.vq_update = wrapped
    try:
        yield
    finally:
        step_mod.vq_update = orig


def run_case(case: dict, rank: int, meshes: dict) -> dict:
    if case.get("kind") in ("scale", "branch-scale", "cmax"):
        return run_scale(case, rank, meshes)
    kind = case["mesh"]
    key = kind[1] if kind[0] == "1d" else tuple(kind)
    if meshes[key] is None:
        return {}  # a rank outside the case's mesh
    cfg = Config(**case["cfg"])
    link, multilabel = case["link"], case["graph"].get("multilabel", False)
    g, c = synthetic_sbm(**case["graph"])
    g, c, _ = prepare(g, cfg, c)
    ms = model_static(cfg, g.num_features, cfg.hidden_channels if link else c,
                      torch.device("cpu"))
    state = state_from_numpy(case["state"], ms, cfg.lr, "cpu")
    X = device_features(g.x, "cpu")
    dtype = torch.float64 if case["f64"] else torch.float32
    if case["f64"]:
        state, X = state_as(state, dtype), X.to(dtype)
    loader = BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=0, device="cpu",
                         with_link_edges=link)
    batch = next(loader._epoch_iter())[0][0]  # the host batch, alike on every rank
    masks = {k: None if case[k] is None else [torch.as_tensor(m) for m in case[k]]
             for k in ("branch_masks", "dropout_keeps")}
    mesh = meshes[key]
    if kind[0] == "1d":
        state, X, shard = shard_train_inputs(mesh, state, X, batch)
        make = make_sharded_link_step if link else make_sharded_step
    else:
        state, X, shard = shard_train_inputs_2d(mesh, state, X, batch)
        make = make_sharded_link_step_2d if link else make_sharded_step_2d
    shard = batch_as(shard, dtype) if case["f64"] else shard
    res, vq_in = {}, [] if case["f64"] else None
    if link:
        step = make(ms, cfg, mesh)
        pred, pred_opt = predictor_from_numpy(case["pred"], case["pred_nu"], cfg.lr, "cpu")
        if case["f64"]:
            pred, pred_opt = predictor_as(pred, pred_opt, dtype)
        keep = None if case["pred_keep"] is None else [torch.as_tensor(k)
                                                        for k in case["pred_keep"]]
        scales, real = [], sharded.clip_scale

        def recorded(sq, max_norm):  # the clip's scale of each group, as the step takes it
            scales.append(real(sq, max_norm))
            return scales[-1]

        sharded.clip_scale = recorded
        try:
            with vq_inputs(vq_in):
                m = step(state, pred, pred_opt, X, shard, 1.0, cfg.lr, 1.0,
                         dst_neg=torch.as_tensor(case["dst_neg"]), pred_keep=keep, **masks)
        finally:
            sharded.clip_scale = real
        names, pparams = zip(*pred.named_parameters())
        res.update(pred={k: p.detach().numpy().copy() for k, p in zip(names, pparams)},
                   pred_nu={k: v.numpy().copy() for k, v in zip(
                       names, rmsprop_nu(pred_opt, pparams))},
                   clip_scales=[float(s) for s in scales])
    else:
        step = make(ms, cfg, mesh, multilabel=multilabel)
        with vq_inputs(vq_in):
            state, m = step(state, X, shard, 1.0, cfg.lr, 1.0, **masks)
    return {
        **res,
        "vq_in": vq_in,
        "metrics": {k: float(v) for k, v in m.items()},
        "params": {k: v.detach().numpy().copy() for k, v in state.model.named_parameters()},
        "nu": _nu(state),
        "vq": [{f: getattr(s, f).numpy().copy() for f in VQ_FIELDS} for s in state.vq_states],
        "vq_tr": [{f: getattr(s, f).numpy().copy() for f in VQ_FIELDS}
                  for s in state.vq_states_tr or []],
        "bn": {"mean": [t.numpy().copy() for t in state.bn_state.mean],
               "var": [t.numpy().copy() for t in state.bn_state.var]},
        "ledger": {"per_step": step.ledger.per_step(), "kinds": sorted(step.ledger.kinds)},
        "batch": {f: np.asarray(getattr(batch, f)) for f in BATCH_FIELDS
                  if getattr(batch, f) is not None},
        "edges": {f: np.asarray(getattr(batch.edges, f)) for f in EDGE_FIELDS
                  if getattr(batch.edges, f) is not None},
        "X_elems": X.numel(),
    }


def _nu(state) -> dict:
    """{parameter name: its RMSprop square average} (numpy) of a state."""
    names, params = zip(*state.model.named_parameters())
    return {k: v.numpy().copy() for k, v in zip(names, rmsprop_nu(state.optimizer, params))}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, plan_path, out_path = sys.argv[3:6]
    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{init_file}", world, rank)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    # every rank makes every group, in one order
    pair = dist.new_group([0, 1])
    dev = torch.device("cpu")
    singles = [dist.new_group([r]) for r in range(2)]  # the 1 x 2 mesh's data groups
    meshes = {world: DataMesh(None, rank, world, dev),
              2: DataMesh(pair, rank, 2, dev) if rank < 2 else None,
              ("2d", 2, world // 2): make_mesh_2d(2, world // 2, device="cpu"),
              ("2d", 1, 2): Mesh2D(group=pair, data_group=singles[rank], model_group=pair,
                                   n_data=1, n_model=2, data_rank=0, model_rank=rank, rank=rank,
                                   device=dev) if rank < 2 else None}
    res = {case["name"]: run_case(case, rank, meshes) for case in plan["cases"]}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
