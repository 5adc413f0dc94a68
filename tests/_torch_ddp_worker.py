"""One rank of the gloo group that ``tests/test_torch_port_ddp.py`` spawns.

    python tests/_torch_ddp_worker.py RANK WORLD INIT_FILE PLAN OUT

Reads the plan (a pickle the test writes: the graph's generator arguments
and, per case, a ``Config``'s fields, the JAX package's initial train state
as numpy, the dropbranch masks, each rank's ``node_range``, the number of
steps), runs each case's data-parallel steps on this rank's batches from
the port's ``BatchLoader``, and pickles per case the losses, a digest of the
replicated state after every step, the final state and the collective
ledger.  Imports the port and torch only, never JAX.
"""

import dataclasses
import hashlib
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vq_gnn_tpu_torch.config import Config  # noqa: E402
from vq_gnn_tpu_torch.convert import state_from_numpy  # noqa: E402
from vq_gnn_tpu_torch.graph.datasets import prepare, synthetic_sbm  # noqa: E402
from vq_gnn_tpu_torch.nn.model import model_static  # noqa: E402
from vq_gnn_tpu_torch.nn.vq import VQState  # noqa: E402
from vq_gnn_tpu_torch.parallel import init_distributed, make_ddp_step  # noqa: E402
from vq_gnn_tpu_torch.sampler.samplers import BatchLoader  # noqa: E402
from vq_gnn_tpu_torch.train.loop import device_features  # noqa: E402

VQ_FIELDS = [f.name for f in dataclasses.fields(VQState)]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def digests(state) -> dict:
    """sha256 of the parameters, the codebooks and the c_indices tables."""
    return {
        "params": _digest(state.model.parameters()),
        "embedding": _digest(s.embedding for s in state.vq_states),
        "c_indices": _digest(s.c_indices for s in state.vq_states),
        "vq": _digest(getattr(s, f) for s in state.vq_states for f in VQ_FIELDS),
        "bn": _digest(state.bn_state.mean + state.bn_state.var),
    }


def run_case(plan: dict, case: dict, rank: int) -> dict:
    cfg = Config(**case["cfg"])
    g, c = synthetic_sbm(**plan["graph"])
    g, c, _ = prepare(g, cfg, c)
    ms = model_static(cfg, g.num_features, c, torch.device("cpu"))
    state = state_from_numpy(case["state"], ms, plan["lr"], "cpu")
    X = device_features(g.x, "cpu")
    step = make_ddp_step(ms, cfg)
    masks = None if case["masks"] is None else [torch.as_tensor(m) for m in case["masks"]]
    loader = BatchLoader(g, cfg, train_flag=True, shuffle=case["shuffle"], seed=rank,
                         node_range=case["node_range"][rank], device="cpu")
    out = {"loss": [], "digests": [], "B_pad": [], "num_N": g.num_nodes}
    n = 0
    for windows, _ in loader:
        for wi, b in enumerate(windows):
            # multi-window batches skip the optimizer on window 0 (the trainer's rule)
            do_opt = 0.0 if (len(windows) > 1 and wi == 0) else 1.0
            state, m = step(state, X, b, 1.0, plan["lr"], do_opt, branch_masks=masks)
            out["loss"].append(float(m["loss"]))
            assert not bool(m["bad_init"])
            out["digests"].append(digests(state))
            out["B_pad"].append(b.B_pad)
            n += 1
            if n >= case["steps"]:
                break
        if n >= case["steps"]:
            break
    out["params"] = {k: v.detach().numpy().copy() for k, v in state.model.named_parameters()}
    out["vq"] = [{f: getattr(s, f).numpy().copy() for f in VQ_FIELDS} for s in state.vq_states]
    out["bn"] = {"mean": [t.numpy().copy() for t in state.bn_state.mean],
                 "var": [t.numpy().copy() for t in state.bn_state.var]}
    out["ledger"] = {"per_step": step.ledger.per_step(), "kinds": sorted(step.ledger.kinds),
                     "steps": step.ledger.steps}
    out["X_elems"] = X.numel()
    return out


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, plan_path, out_path = sys.argv[3:6]
    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{init_file}", world, rank)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    res = {case["name"]: run_case(plan, case, rank) for case in plan["cases"]}
    # a group of two ranks without fixed pads: refused by name
    cfg = Config(num_layers=2, hidden_channels=16, num_M=8)
    try:
        make_ddp_step(model_static(cfg, 16, 4, torch.device("cpu")), cfg)
        res["no_fixed_pads"] = "accepted"
    except ValueError as e:
        res["no_fixed_pads"] = str(e)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
