"""The ``GCN-link`` codebook hold of ``chip_smoke.py`` phase 17a, from many
states, on the card.

Phase 17a holds the sharded link step (``parallel/sharded.py:
make_sharded_link_step(_2d)``, two gloo ranks on one GPU) against the whole
batch's ``train/link.py:link_train_step`` from one state, through
``chip_smoke.compare_step``: the codebooks to 2e-5 + 2e-5 |ref| but for the
codewords of the assignments that differ.  This probe runs that comparison
from many states: phase 11's ``LinkTrainer`` at the collab widths (the
graph and configuration of ``tools/link_experiment_torch.py``), at each seed
of ``--seeds``, after every ``--every`` of its first ``--steps`` steps, each
state on the first batch of its epoch with the negatives phase 17 draws, in
exact f32 on the 1-D and on the 2-D 1 x 2 mesh.  For every state it prints
the codewords set aside, how far ``c_indices`` agree and the codebooks'
largest excess over 2e-5 + 2e-5 |ref| with where it lies (layer, branch,
codeword, column); whether the whole-batch step gives the same bits twice
from the state, and the sharded step on each mesh too for the first
``--twice`` states.  As a control it runs the whole-batch step once more
with its pairs (and their negatives) in another order: the same sums in
another order, whose gap to the step is the reach of f32 rounding alone,
held by the same rule.  For every codeword beyond the hold on the 1-D mesh
it recomputes the codeword in float64 from each side's inputs to the VQ
update (the member rows' layer inputs and gradient halves, the moments,
the EMA state; eps sum|terms| of its EMA sum, the BN std of its half, its
EMA size and members) and tells its cause apart:

- (a) its members differ between the sides, yet it is not set aside (a
  member row that moved in another branch or layer is logged, but this
  step's assignments come after its gradients);
- (b) the order of a sum: the float64 codewords of the two sides agree
  within the hold, or the sharded inputs of its member rows differ from
  the whole batch's by no more than ``KAPPA`` times the largest difference
  in that column of the reordered whole batch or of the whole batch on the
  CPU (the plain versions, every sum in another order; run for the states
  with a miss);
- (c) a candidate fault of the sharded step: the pair counts differ, or the
  column's inputs differ past ``KAPPA`` times that reach.  Neither control
  reorders the transposed aggregation that the sharded step splits over
  its ranks (the CPU's plain sum takes each row's slots in the kernel's
  order), so a (c) is a lead to follow, not a fault shown;
- (d) anything else.

**The float64 control** (``--f64``) tells a sum's order from a fault
without knowing where the sums split.  For every state it casts the state,
the predictor, the features and the batch's values to float64
(``convert.py:state_as``, ``predictor_as``, ``batch_as``) and runs, on the
CPU through the plain versions, the whole batch's link step and the sharded
link step on two gloo ranks on the 1-D and on the 2-D 1 x 2 mesh, with the
same negatives, each step's VQ inputs kept at their dtype.  float64 rounds
2^29 times finer than f32: a gap from the order of a sum shrinks by about
that factor, one from computing something else (a dropped or doubled
cotangent, a mask, a count, a term one side lacks) does not.  For every
codeword beyond the hold **on either mesh** it prints the f32 gap of its
column's inputs over its member rows (the card's sharded step against the
card's whole batch), the float64 gap of the same (the CPU's), their ratio,
the same three of the codeword itself, and its class:

- order: both ratios at most ``ORDER_RATIO`` (1e-4; order alone predicts
  about 2e-9);
- fault: either ratio at least ``FAULT_RATIO`` (1e-1);
- (d): anything between.

Where the f32 inputs agree over the member rows the codeword's gap is the
VQ update's own (its sums over the ranks), and its ratio alone decides.

For every state it also prints, per mesh and layer, the largest float64
difference of the X and G halves, each column's relative to that column's
largest value: a fault that stays under the hold shows there.  The f32
columns beside it are the card's.  The control runs the plain versions:
a kernel that disagrees with its plain version at a shard's shapes is
outside its view (``chip_smoke.py`` phase 17b holds each kernel there).

It also times the whole-batch link step at the collab widths (``--time-steps``
steps after the first seed's, then 5 profiled ones: device busy a step) and
lists the device kernels of one profiled step whose names are those of
``index_add_`` or ``scatter_add_``; ``--time-only`` stops there.

    python3 tools/link_hold_probe_torch.py [--seeds 0 1 2] [--steps 80] [--every 10]
        [--twice 4] [--time-steps 20] [--time-only] [--f64] [--out probe.json]
        [--device cpu --nodes 3000]

It needs a GPU (it exits 1 without one) unless ``--device cpu``, which runs
every step on the CPU (the plain versions, no timing) at ``--nodes`` nodes
(``tools/link_experiment_torch.py:scaled_config``'s cut): a dry run of the
probe itself.  It imports no JAX.  To run it on another tree (a parent
commit unpacked beside this one), copy it into that tree's ``tools/`` and
run it from there: it imports the package and ``chip_smoke.py`` of the tree
it lies in.
"""

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import pickle
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402

RANKS = 2
EPS32 = 2.0 ** -24  # f32's unit roundoff
KAPPA = 8  # the reach of an f32 sum, in eps sum|terms|: (b) within it
HOLD = 2e-5  # chip_smoke.compare_step's codebook hold, rtol and atol
ORDER_RATIO, FAULT_RATIO = 1e-4, 1e-1  # the float64 control's classes
MESHES = ("1-D", "2-D 1x2")


def load_chip_smoke():
    """``chip_smoke.py`` of this tree, as a module (its functions only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# the VQ update's inputs, captured
# ---------------------------------------------------------------------------
CAPTURE = {"on": False, "calls": []}


def capture_vq_inputs():
    """Wrap ``train/step.py``'s ``vq_update`` so that, while ``CAPTURE['on']``,
    each call's inputs and assignments are kept (numpy, the inputs at their
    dtype): one call a layer, in order."""
    from vq_gnn_tpu_torch.train import step as step_mod

    orig = step_mod.vq_update

    def wrapped(state, X_B, grad, batch_idx, p, valid=None, **kw):
        new, idx = orig(state, X_B, grad, batch_idx, p, valid=valid, **kw)
        if CAPTURE["on"]:
            CAPTURE["calls"].append(dict(
                X=X_B.detach().cpu().numpy(), G=grad.detach().cpu().numpy(),
                valid=valid.cpu().numpy(), idx=idx.cpu().numpy()))
        return new, idx

    step_mod.vq_update = wrapped


def run_captured(fn):
    CAPTURE["on"], CAPTURE["calls"] = True, []
    try:
        out = fn()
    finally:
        CAPTURE["on"] = False
    return out, CAPTURE["calls"]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def rank_main(rank, tmp, twice, device, f64=False):
    """One of the two gloo ranks on ``device`` (the card: both on cuda:0):
    for every state, one sharded link step on each mesh, its VQ inputs kept
    (the first ``twice`` states twice on each mesh); pickles
    ``out<rank>_<k>.pkl``.  With ``f64`` on the CPU, from the state cast to
    float64 (the float64 control): ``f64_out<rank>_<k>.pkl``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from vq_gnn_tpu_torch.config import Config, apply_matmul_precision
    from vq_gnn_tpu_torch.convert import (
        batch_as,
        predictor_as,
        predictor_from_numpy,
        state_as,
        state_from_numpy,
    )
    from vq_gnn_tpu_torch.nn.model import model_static
    from vq_gnn_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        make_sharded_link_step,
        make_sharded_link_step_2d,
        shard_train_inputs,
        shard_train_inputs_2d,
    )

    cs = load_chip_smoke()
    capture_vq_inputs()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // RANKS))
    tag = "f64_" if f64 else ""
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg{tag}", world_size=RANKS,
                            rank=rank, timeout=timedelta(seconds=1800))
    with open(os.path.join(tmp, "plan.pkl"), "rb") as f:
        plan = pickle.load(f)
    dtype = torch.float64 if f64 else torch.float32
    X = torch.as_tensor(plan["X"]).to(dev, dtype)
    meshes = ((MESHES[0], make_mesh(RANKS, device=dev), shard_train_inputs,
               make_sharded_link_step),
              (MESHES[1], make_mesh_2d(1, RANKS, device=dev), shard_train_inputs_2d,
               make_sharded_link_step_2d))
    for k, (seed, path) in enumerate(plan["states"]):
        with open(path, "rb") as f:
            snap = pickle.load(f)
        sd = plan["seeds"][seed]
        cfg = Config(**sd["cfg"])
        apply_matmul_precision(cfg)
        dst_neg = torch.as_tensor(sd["dst_neg"], device=dev)
        out = {}
        for mname, mesh, place, make in meshes:
            digests = []
            for rep in range(2 if k < twice else 1):
                ms = model_static(cfg, plan["F"], plan["C"], dev)
                state = state_from_numpy(snap["state"], ms, cfg.lr, dev)
                pred = predictor_from_numpy(*snap["pred"], cfg.lr, dev)
                if f64:
                    state, pred = state_as(state, dtype), predictor_as(*pred, dtype)
                state, _, shard = place(mesh, state, X, sd["b0"])
                if f64:
                    shard = batch_as(shard, dtype)
                step = make(ms, cfg, mesh)

                def one():
                    return step(state, *pred, X, shard, 1.0, cfg.lr, 1.0, dst_neg=dst_neg)

                if rep == 0:
                    m, out["calls", mname] = run_captured(one)
                    if mname == MESHES[0]:  # the 1-D ranks' pair blocks
                        out["count"] = float(shard.link_mask.sum())
                else:
                    m = one()
                rec = cs._step_record(torch, state, m, pred[0])
                digests.append(cs._state_digest(list(rec["params"].values()) + rec["emb"]
                                                + [c[:-1] for c in rec["cidx"]]))
                if rep == 0:
                    out[mname] = rec
            out[mname, "digests"] = digests
        with open(os.path.join(tmp, f"{tag}out{rank}_{k}.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the comparison, and the codewords beyond the hold
# ---------------------------------------------------------------------------
def summary(got, ref, N, m=0, n_model=1):
    """What compare_step holds of the codebooks, per state: the lowest
    ``c_indices`` agreement, the codewords set aside (of the differing
    assignments), and every codeword beyond the hold (layer, branch,
    codeword, its largest excess, the column)."""
    agree, moved, worst, misses = 1.0, 0, -math.inf, []
    for i, (e_got, e_ref, c_got, c_ref) in enumerate(zip(got["emb"], ref["emb"], got["cidx"],
                                                         ref["cidx"])):
        nb = e_got.shape[0]
        e_ref, c_ref = e_ref[m * nb:(m + 1) * nb], c_ref[:N, m * nb:(m + 1) * nb]
        c_got = c_got[:N]
        agree = min(agree, float((c_got == c_ref).mean()))
        keep = np.ones(e_got.shape[:2], bool)
        rows, br = np.nonzero(c_got != c_ref)
        keep[br, c_got[rows, br]] = keep[br, c_ref[rows, br]] = False
        moved += int((~keep).sum())
        diff = np.where(keep[:, :, None], np.abs(e_got - e_ref) - HOLD * np.abs(e_ref), -np.inf)
        worst = max(worst, float(diff.max()))
        for b, c in zip(*np.nonzero(diff.max(2) > HOLD)):
            j = int(np.argmax(diff[b, c]))
            misses.append(dict(layer=i, branch=int(b) + m * nb, codeword=int(c), column=j,
                               excess=float(diff[b, c, j]), ref=float(e_ref[b, c, j]),
                               got=float(e_got[b, c, j])))
    return dict(agree=agree, moved=moved, excess=worst, misses=misses)


def codeword_f64(torch, vq_prev, call, p, b, c, j):
    """Codeword (b, c)'s column j after the update, in float64 from one
    side's captured inputs (``call``: X, G, valid, idx over the whole
    batch's rows) and the state before it (``vq_prev``, numpy): (value, its
    reach in f32: eps sum|terms| of the EMA sum over the size, the member
    rows, the size, the BN std of the column's half)."""
    from vq_gnn_tpu_torch.nn import vq as vqm
    from vq_gnn_tpu_torch.ops.vq_ops import masked_moments

    D = p.num_D
    X, G = (torch.as_tensor(call[k], dtype=torch.float64) for k in ("X", "G"))
    valid = torch.as_tensor(call["valid"])
    idx = torch.as_tensor(call["idx"]).long()
    mf, mg = masked_moments([X, G], valid)
    # normalised by the batch's moments (the running stats move the lookup
    # copy, embedding_output, which the hold does not read)
    xn_f = vqm._bn_apply(X, mf, mf[0], mf[2], vqm.BN_FEAT_EPS, vqm.BN_FEAT_MOMENTUM)[0]
    xn_g = vqm._bn_apply(G, mg, mg[0], mg[2], p.epsilon, p.momentum)[0]
    xn = torch.cat([xn_f, xn_g], 2) * vqm._grad_half(
        p.total_dim, D, p.grad_scale[0], p.grad_scale[1], p.add_flag).double()
    live = valid[None, :] & (idx >= 0)
    counts = torch.zeros(idx.shape[0], p.num_M, dtype=torch.float64)
    counts.scatter_add_(1, idx.clamp(min=0), live.double())
    mem = (live[b] & (idx[b] == c)).nonzero()[:, 0]
    terms = xn[b, mem, j]
    size = vqm._ema_counts(torch.as_tensor(vq_prev["ema_cluster_size"], dtype=torch.float64),
                           counts, p)[b, c]
    w_prev = float(vq_prev["ema_w"][b, c, j])
    val = (w_prev * p.decay + (1.0 - p.decay) * float(terms.sum())) / float(size)
    reach = EPS32 * (abs(w_prev) * p.decay + (1.0 - p.decay) * float(terms.abs().sum())) / float(
        size)
    var = (mf if j < D else mg)[1][b, j % D] + (vqm.BN_FEAT_EPS if j < D else p.epsilon)
    return dict(value=val, reach=reach, members=mem.tolist(), size=float(size),
                std=float(var.sqrt()), terms_sum=float(terms.sum()),
                terms_abs=float(terms.abs().sum()))


def classify(torch, miss, snap, p, ref_calls, got_calls, perm_calls, cpu_calls, ref, got, N,
             count_ok):
    """The cause of one 1-D codeword beyond the hold, (a)-(d), with its
    float64 numbers.  ``got_calls``: the 1-D sharded step's VQ inputs as
    the whole batch's (:func:`assemble`); ``perm_calls``: those of the
    whole-batch step once more with its pairs in another order (the same
    sums, in another order); ``cpu_calls``, where given, those of the
    whole-batch step on the CPU (plain versions: every sum in another
    order).  Their largest difference from the card's whole-batch inputs in
    the column is the reach of f32 rounding there, measured."""
    i, b, c, j = miss["layer"], miss["branch"], miss["codeword"], miss["column"]
    prev = snap["state"]["vq_states"][i]
    r_call, q_call, g_call = ref_calls[i], perm_calls[i], got_calls[i]
    r = codeword_f64(torch, prev, r_call, p, b, c, j)
    g = codeword_f64(torch, prev, g_call, p, b, c, j)
    q = codeword_f64(torch, prev, q_call, p, b, c, j)
    D = p.num_D
    # a member row moved in another branch or layer (not causal: this
    # step's assignments come after its gradients)
    moved_rows = set()
    for c_got, c_ref in zip(got["cidx"], ref["cidx"]):
        moved_rows |= set(np.nonzero((c_got[:N] != c_ref[:N]).any(1))[0].tolist())
    bidx = r_call.get("batch_idx")
    ids = set() if bidx is None else {int(bidx[m]) for m in r["members"]}
    shares = bool(ids & moved_rows)
    same_members = r["members"] == g["members"]
    # the inputs of the column: the gradient half (or the features) of its
    # member rows and of every row, against the reordered whole-batch step's
    half = "G" if j >= D else "X"
    col = (j - D) if j >= D else j
    rows = np.asarray(r["members"], dtype=np.int64)

    def column(call):
        return call[half][b, :, col].astype(np.float64)

    a_ref, a_got, a_perm = column(r_call), column(g_call), column(q_call)
    d_in = float(np.abs(a_got[rows] - a_ref[rows]).max()) if len(rows) else 0.0
    d_perm_in = float(np.abs(a_perm[rows] - a_ref[rows]).max()) if len(rows) else 0.0
    d_all = float(np.abs(a_got - a_ref).max())
    d_perm_all = float(np.abs(a_perm - a_ref).max())
    d_cpu_in = d_cpu_all = None
    if cpu_calls is not None:
        a_cpu = column(cpu_calls[i])
        d_cpu_in = float(np.abs(a_cpu[rows] - a_ref[rows]).max()) if len(rows) else 0.0
        d_cpu_all = float(np.abs(a_cpu - a_ref).max())
    reach_in = max(d_perm_all, d_cpu_all or 0.0, EPS32 * float(np.abs(a_ref).max()))
    gap64 = abs(g["value"] - r["value"])
    gap32 = abs(miss["got"] - miss["ref"])
    gap_perm = abs(q["value"] - r["value"])
    hold = HOLD + HOLD * abs(miss["ref"])
    if not same_members:
        cls = "a"
    elif not count_ok or d_all > KAPPA * reach_in:
        cls = "c"
    elif gap64 <= hold or d_in <= KAPPA * reach_in:
        cls = "b"
    else:
        cls = "d"
    return dict(miss, cls=cls, f64_ref=r["value"], f64_got=g["value"], f64_perm=q["value"],
                gap64=gap64, gap32=gap32, gap_perm=gap_perm, hold=hold, reach=r["reach"],
                size=r["size"], std=r["std"], members=len(r["members"]),
                same_members=same_members, shares_moved=shares, terms_sum=r["terms_sum"],
                terms_abs=r["terms_abs"], d_members_in=d_in, d_perm_members_in=d_perm_in,
                max_members_in=float(np.abs(a_ref[rows]).max()) if len(rows) else 0.0,
                d_half_all_rows=d_all, d_perm_all_rows=d_perm_all, d_cpu_members_in=d_cpu_in,
                d_cpu_all_rows=d_cpu_all,
                max_half_all_rows=float(np.abs(a_ref).max()))


def assemble(rank_calls, mname):
    """The sharded step's VQ inputs on mesh ``mname`` as the whole batch's,
    layer by layer: the 1-D ranks' rows side by side, the 2-D model ranks'
    branches."""
    rows = mname == MESHES[0]
    out = []
    for parts in zip(*rank_calls):
        call = {k: np.concatenate([c[k] for c in parts], axis=1 if rows else 0)
                for k in ("X", "G", "idx")}
        call["valid"] = (np.concatenate([c["valid"] for c in parts]) if rows
                         else parts[0]["valid"])
        out.append(call)
    return out


def half_diffs(ref, got):
    """Per layer, the largest difference of the X and of the G half over the
    valid rows, each column's relative to that column's largest |value| in
    ``ref``."""
    out = []
    for r, g in zip(ref, got):
        v = r["valid"]
        row = {}
        for h in ("X", "G"):
            e, a = r[h][:, v].astype(np.float64), g[h][:, v].astype(np.float64)
            den, num = np.abs(e).max(1), np.abs(a - e).max(1)
            row[h] = float(np.where(den > 0, num / np.where(den > 0, den, 1.0),
                                    np.where(num > 0, np.inf, 0.0)).max())
        out.append(row)
    return out


def halves_text(halves) -> str:
    """:func:`half_diffs` as "[X / G, ...]" a layer."""
    return "[" + ", ".join(f"{h['X']:.3g} / {h['G']:.3g}" for h in halves) + "]"


def f64_control(miss, ref32, got32, ref64, got64, emb64_ref, emb64_got, D):
    """The float64 control of one codeword beyond the hold (the module
    docstring): over its member rows (the card's whole batch's) the f32 and
    float64 gaps of its column's inputs, sharded against whole, and the
    same of the codeword itself; their ratios (the inputs' none where their
    f32 gap is 0: the codeword's gap is then the VQ update's own sums') and
    the class."""
    i, b, c, j = miss["layer"], miss["branch"], miss["codeword"], miss["column"]
    r = ref32[i]
    rows = np.nonzero(r["valid"] & (r["idx"][b] == c))[0]
    half, col = ("G", j - D) if j >= D else ("X", j)

    def gap(got, ref):
        if not len(rows):
            return 0.0
        a, e = got[i][half][b, rows, col], ref[i][half][b, rows, col]
        return float(np.abs(a.astype(np.float64) - e).max())

    in32, in64 = gap(got32, ref32), gap(got64, ref64)
    cw32 = abs(miss["got"] - miss["ref"])
    cw64 = abs(float(emb64_got[i][b, c, j]) - float(emb64_ref[i][b, c, j]))
    ratio_in = in64 / in32 if in32 else math.nan
    ratio_cw = cw64 / cw32 if cw32 else math.nan
    # where the f32 inputs agree, the codeword's gap is the update's own
    ratios = [x for x in (ratio_in, ratio_cw) if not math.isnan(x)]
    worst = max(ratios, default=math.nan)
    if not ratios:
        cls = "d"
    elif worst >= FAULT_RATIO:
        cls = "fault"
    elif worst <= ORDER_RATIO:
        cls = "order"
    else:
        cls = "d"
    return dict(layer=i, branch=b, codeword=c, column=j, half=half, members=len(rows),
                excess=miss["excess"], in_gap32=in32, in_gap64=in64, in_ratio=ratio_in,
                cw_gap32=cw32, cw_gap64=cw64, cw_ratio=ratio_cw, f64_cls=cls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=80, help="steps of each seed's epoch")
    ap.add_argument("--every", type=int, default=10, help="a state every this many steps")
    ap.add_argument("--twice", type=int, default=4,
                    help="the first this many states: the sharded step twice on each mesh")
    ap.add_argument("--time-steps", type=int, default=20)
    ap.add_argument("--time-only", action="store_true",
                    help="only the timing: the first seed's --steps steps, then the timed and "
                         "5 profiled steps; no states, no ranks")
    ap.add_argument("--f64", action="store_true",
                    help="the float64 control on the CPU, on both meshes (the module docstring)")
    ap.add_argument("--out", help="also write every state's record there, as JSON")
    ap.add_argument("--device", default="cuda",
                    help="'cpu': every step on the CPU, no timing (a dry run of the probe)")
    ap.add_argument("--nodes", type=int, default=None,
                    help="the graph's nodes (default: collab's); fewer cut the configuration "
                         "as tools/link_experiment_torch.py does")
    args = ap.parse_args(argv)

    import torch

    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        print("link_hold_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    import link_experiment_torch as tool
    from vq_gnn_tpu_torch import ops
    from vq_gnn_tpu_torch.config import apply_matmul_precision
    from vq_gnn_tpu_torch.convert import (
        batch_as,
        predictor_as,
        predictor_from_numpy,
        predictor_to_numpy,
        state_as,
        state_from_numpy,
        state_to_numpy,
    )
    from vq_gnn_tpu_torch.graph.datasets import prepare
    from vq_gnn_tpu_torch.nn.model import model_static
    from vq_gnn_tpu_torch.train.link import LinkTrainer, make_link_step
    from vq_gnn_tpu_torch.utils.profiling import device_rows, gpu_line, profile_steps
    from vq_gnn_tpu_torch.utils.scheduler import linear_ramp

    cs = load_chip_smoke()
    capture_vq_inputs()
    gpu = gpu_line() if card else "cpu"
    dev = torch.device(args.device)
    nodes = args.nodes or tool.N_COLLAB
    log(f"[probe] tree {ROOT} | {gpu} | torch {torch.__version__}")
    t0 = time.time()
    g, split = tool.build_graph_and_split(nodes=nodes)
    cfg0 = tool.scaled_config(tool.vq_config("GCN", 1), nodes)
    g, _, _ = prepare(g, cfg0, 0, symmetrize_adj=False)
    log(f"[probe graph] collab widths{'' if nodes == tool.N_COLLAB else ' cut'} N={g.num_nodes} "
        f"E={g.num_edges} in {time.time() - t0:.1f}s")

    tmp = tempfile.mkdtemp(prefix="link_hold_probe_")
    plan = {"seeds": {}, "states": []}
    result = {"gpu": gpu, "tree": ROOT, "states": [], "time": None}
    for seed in args.seeds:
        t0 = time.time()
        cfg = dataclasses.replace(cfg0, seed=seed)
        tr = LinkTrainer(g, cfg, split, device=args.device)
        tr.run_init_sweep()
        loader = tr.train_loader
        wur = 1.0 / cfg.warm_up_epochs if cfg.warm_up and 1 <= cfg.warm_up_epochs else 1.0
        lr = linear_ramp(cfg.lr, 1) if cfg.sche else cfg.lr
        kept = []
        for item in loader._epoch_iter():  # train_epoch(1), its first --steps steps
            windows, _ = loader._to_device(item)
            for j, batch in enumerate(windows):
                if len(kept) < 3:
                    kept.append(batch)
                do_opt = 0.0 if (len(windows) > 1 and j == 0) else 1.0
                tr.step_fn(tr.state, tr.predictor, tr.pred_opt, tr.X_dev, batch, wur, lr, do_opt,
                           tr.generator)
                if tr.state.step % args.every == 0 and not args.time_only:
                    path = os.path.join(tmp, f"state_{seed}_{tr.state.step}.pkl")
                    with open(path, "wb") as f:
                        pickle.dump(dict(state=state_to_numpy(tr.state), step=tr.state.step,
                                         pred=predictor_to_numpy(tr.predictor, tr.pred_opt)), f)
                    plan["states"].append((seed, path))
                if tr.state.step == args.steps:
                    break
            if tr.state.step == args.steps:
                break
        b0 = kept[0]
        pads = dict(fixed_B_pad=loader._B_bucket, fixed_Bp_pad=loader._Bp_bucket,
                    fixed_E_pad=loader._E_bucket)
        exact = dataclasses.replace(cfg, matmul_precision="highest", vq_backend="pallas", **pads)
        plan["seeds"][seed] = dict(
            cfg=dataclasses.asdict(exact), b0=cs.host_batch(b0),
            dst_neg=np.random.default_rng(cs.LINK_NEG_SEED).integers(
                0, max(int(b0.num_B), 1), len(b0.link_src)))
        if "X" not in plan:
            plan.update(X=tr.X_dev.cpu().numpy(), F=tr.ms.channels[0], C=tr.ms.channels[-1])
        log(f"[probe seed {seed}] init sweep and {tr.state.step} steps in {time.time() - t0:.1f}s; "
            f"states at steps {[s for s in range(args.every, tr.state.step + 1, args.every)]}; "
            f"first batch B_pad {b0.B_pad}, L_pad {len(b0.link_src)} "
            f"({int(b0.link_mask.sum())} live)")
        if seed == args.seeds[0] and card:
            # the whole-batch link step at the collab widths: ms/step, and the
            # device kernels of one profiled step
            apply_matmul_precision(cfg)
            ops.reset_launch_counts()

            def one(b):
                return tr.step_fn(tr.state, tr.predictor, tr.pred_opt, tr.X_dev, b, 1.0, cfg.lr,
                                  1.0, tr.generator)

            times, _ = cs.timed_steps(torch, one, kept, args.time_steps)
            launches = {k: v / args.time_steps for k, v in ops.launch_counts().items() if v}
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                one(kept[0])
                torch.cuda.synchronize()
            names = sorted({k for _, _, k in device_rows(prof)})
            busy = profile_steps(lambda i: one(kept[i % len(kept)]), 5, log=log,
                                 tag="probe time", gpu=gpu)
            atomic = [k for k in names if "index_add" in k or "scatter_add" in k
                      or ("indexFunc" in k and "Add" in k) or "ReduceAdd" in k]
            srt = sorted(times)
            result["time"] = dict(ms=sum(times) / len(times), median=srt[len(srt) // 2],
                                  min=srt[0], max=srt[-1], steps=len(times), launches=launches,
                                  atomic_kernels=atomic,
                                  busy_ms=None if busy is None else busy["busy_ms"],
                                  wall_ms=None if busy is None else busy["wall_ms"])
            log(f"[probe time] whole-batch link step at the collab widths, {len(times)} steps: "
                f"{result['time']['ms']:.2f} ms/step (median {srt[len(srt) // 2]:.2f}, min "
                f"{srt[0]:.2f}, max {srt[-1]:.2f}); launches a step {launches} | {gpu}")
            log(f"[probe time] device kernels of one step ({len(names)}); index_add_ / "
                f"scatter_add_ kernels among them: {atomic or 'none'}")
        del tr, kept, b0, loader
        if card:
            torch.cuda.empty_cache()
        if args.time_only:
            print(json.dumps({"time": result["time"], "tree": ROOT}, default=str))
            return 0
    with open(os.path.join(tmp, "plan.pkl"), "wb") as f:
        pickle.dump(plan, f)

    t0 = time.time()
    mp.spawn(rank_main, args=(tmp, args.twice, args.device), nprocs=RANKS, join=True)
    log(f"[probe ranks] {len(plan['states'])} states on {RANKS} gloo ranks in "
        f"{time.time() - t0:.1f}s")
    if args.f64:
        t0 = time.time()
        mp.spawn(rank_main, args=(tmp, 0, "cpu", True), nprocs=RANKS, join=True)
        log(f"[probe f64 ranks] {len(plan['states'])} states in float64 on {RANKS} CPU gloo "
            f"ranks, both meshes, in {time.time() - t0:.1f}s")

    X = torch.as_tensor(plan["X"]).to(dev)
    N = plan["X"].shape[0] - 1
    n_fail = 0
    for k, (seed, path) in enumerate(plan["states"]):
        with open(path, "rb") as f:
            snap = pickle.load(f)
        sd = plan["seeds"][seed]
        cf = type(cfg0)(**sd["cfg"])
        apply_matmul_precision(cf)
        b0 = sd["b0"].to(dev)
        dst_neg = torch.as_tensor(sd["dst_neg"], device=dev)
        # the whole-batch step twice, then once more with its pairs in
        # another order (a permutation of the pairs and their negatives: the
        # same sums, in another order)
        perm = torch.as_tensor(np.random.default_rng(k).permutation(len(sd["dst_neg"])),
                               device=dev)
        b_perm = dataclasses.replace(b0, link_src=b0.link_src[perm], link_dst=b0.link_dst[perm],
                                     link_mask=b0.link_mask[perm])
        recs, digests, calls = [], [], []
        for rep, (batch, neg) in enumerate(((b0, dst_neg), (b0, dst_neg),
                                            (b_perm, dst_neg[perm]))):
            ms = model_static(cf, plan["F"], plan["C"], dev)
            st = state_from_numpy(snap["state"], ms, cf.lr, dev)
            pred = predictor_from_numpy(*snap["pred"], cf.lr, dev)

            def one():
                return make_link_step(ms, cf)[0](st, *pred, X, batch, 1.0, cf.lr, 1.0,
                                                 dst_neg=neg)

            if rep != 1:
                m, c = run_captured(one)
                calls.append(c)
            else:
                m = one()
            rec = cs._step_record(torch, st, m, pred[0])
            recs.append(rec)
            digests.append(cs._state_digest(list(rec["params"].values()) + rec["emb"]
                                            + [c[:-1] for c in rec["cidx"]]))
        ref, ref_calls, perm_calls = recs[0], calls[0], calls[1]
        outs = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"out{r}_{k}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        for call in ref_calls:  # the whole batch's ids, for (a)
            call["batch_idx"] = sd["b0"].batch_idx
        p = ms.vq
        count_ok = abs(sum(o["count"] for o in outs) - float(sd["b0"].link_mask.sum())) < 0.5
        row = dict(seed=seed, step=snap["step"], whole_same_bits=digests[0] == digests[1],
                   pair_count_ok=count_ok)
        tag = f"seed {seed} step {snap['step']}"
        row["whole_permuted"] = summary(recs[2], ref, N)
        row["1-D"] = summary(outs[0]["1-D"], ref, N)
        atol = 1e-2 if cf.bn_flag else 1e-4  # phase 17's
        fails = cs.compare_step(f"probe {tag} 1-D", outs[0]["1-D"], ref, N, atol, gpu)
        row["2-D"] = []
        for r in range(RANKS):
            row["2-D"].append(summary(outs[r]["2-D 1x2"], ref, N, m=r, n_model=RANKS))
            fails += cs.compare_step(f"probe {tag} 2-D model rank {r}", outs[r]["2-D 1x2"], ref,
                                     N, atol, gpu, m=r, n_model=RANKS)
        row["sharded_same_bits"] = {
            mname: [len(set(o[mname, "digests"])) == 1 for o in outs] if
            len(outs[0][mname, "digests"]) > 1 else None for mname in ("1-D", "2-D 1x2")}
        cpu_calls = None
        if row["1-D"]["misses"] or any(s2["misses"] for s2 in row["2-D"]):
            # the whole batch on the CPU (plain versions), from the same state
            t1 = time.time()
            ms_c = model_static(cf, plan["F"], plan["C"], torch.device("cpu"))
            st = state_from_numpy(snap["state"], ms_c, cf.lr, "cpu")
            pred = predictor_from_numpy(*snap["pred"], cf.lr, "cpu")
            m, cpu_calls = run_captured(lambda: make_link_step(ms_c, cf)[0](
                st, *pred, torch.as_tensor(plan["X"]), sd["b0"].to("cpu"), 1.0, cf.lr, 1.0,
                dst_neg=dst_neg.cpu()))
            row["whole_cpu"] = summary(cs._step_record(torch, st, m, pred[0]), ref, N)
            log(f"[probe {tag}] the whole-batch step on the CPU against the card's "
                f"({time.time() - t1:.1f}s): set aside {row['whole_cpu']['moved']}, excess "
                f"{row['whole_cpu']['excess']:.3g}, {len(row['whole_cpu']['misses'])} codewords "
                f"beyond the hold")
            row["whole_cpu"]["misses"] = row["whole_cpu"]["misses"][:20]
        got32 = {mname: assemble([o["calls", mname] for o in outs], mname) for mname in MESHES}
        row["classified"] = [classify(torch, ms_, snap, p, ref_calls, got32[MESHES[0]],
                                      perm_calls, cpu_calls, ref, outs[0]["1-D"], N, count_ok)
                             for ms_ in row["1-D"]["misses"]]
        row["f32_halves"] = {mname: half_diffs(ref_calls, got32[mname]) for mname in MESHES}
        if args.f64:
            # the float64 control: the whole batch on the CPU from the state
            # cast to float64, against the f64 ranks' sharded steps
            t1 = time.time()
            ms_c = model_static(cf, plan["F"], plan["C"], torch.device("cpu"))
            st = state_as(state_from_numpy(snap["state"], ms_c, cf.lr, "cpu"), torch.float64)
            pred = predictor_as(*predictor_from_numpy(*snap["pred"], cf.lr, "cpu"),
                                torch.float64)
            _, ref64 = run_captured(lambda: make_link_step(ms_c, cf)[0](
                st, *pred, torch.as_tensor(plan["X"]).double(),
                batch_as(sd["b0"].to("cpu"), torch.float64), 1.0, cf.lr, 1.0,
                dst_neg=dst_neg.cpu()))
            emb64_ref = [s.embedding.numpy() for s in st.vq_states]
            outs64 = []
            for r in range(RANKS):
                with open(os.path.join(tmp, f"f64_out{r}_{k}.pkl"), "rb") as f:
                    outs64.append(pickle.load(f))
            got64 = {mname: assemble([o["calls", mname] for o in outs64], mname)
                     for mname in MESHES}
            emb64 = {MESHES[0]: outs64[0][MESHES[0]]["emb"],
                     MESHES[1]: [np.concatenate(e) for e in zip(*(o[MESHES[1]]["emb"]
                                                                  for o in outs64))]}
            row["f64_halves"] = {mname: half_diffs(ref64, got64[mname]) for mname in MESHES}
            misses_by_mesh = {MESHES[0]: row["1-D"]["misses"],
                              MESHES[1]: [ms_ for s2 in row["2-D"] for ms_ in s2["misses"]]}
            row["f64"] = {mname: [f64_control(ms_, ref_calls, got32[mname], ref64, got64[mname],
                                              emb64_ref, emb64[mname], p.num_D)
                                  for ms_ in misses_by_mesh[mname]] for mname in MESHES}
            for mname in MESHES:
                hd, h32 = row["f64_halves"][mname], row["f32_halves"][mname]
                log(f"[probe {tag} f64 {mname}] largest difference of each layer's X / G "
                    f"half, of the column's max: float64 {halves_text(hd)}; f32 (the card) "
                    f"{halves_text(h32)} ({time.time() - t1:.1f}s)")
                for fc in row["f64"][mname]:
                    log(f"[probe {tag} f64 {mname} miss] ({fc['f64_cls']}) layer {fc['layer']} "
                        f"branch {fc['branch']} codeword {fc['codeword']} column {fc['column']} "
                        f"({fc['half']} half, {fc['members']} members; excess "
                        f"{fc['excess']:.3g}): inputs f32 gap {fc['in_gap32']:.3g}, float64 gap "
                        f"{fc['in_gap64']:.3g}, ratio {fc['in_ratio']:.3g}; codeword f32 gap "
                        f"{fc['cw_gap32']:.3g}, float64 gap {fc['cw_gap64']:.3g}, ratio "
                        f"{fc['cw_ratio']:.3g} | {gpu}")
            del outs64, got64, ref64
        n_fail += bool(fails)
        s1 = row["1-D"]
        log(f"[probe {tag}] 1-D: set aside {s1['moved']} codewords, c_indices agree "
            f"{s1['agree']:.6f}, codebooks max excess {s1['excess']:.3g} (hold {HOLD:g}), "
            f"{len(s1['misses'])} codewords beyond it; 2-D: set aside "
            f"{[s['moved'] for s in row['2-D']]}, excess "
            f"{[round(s['excess'], 9) for s in row['2-D']]}; whole-batch step twice the "
            f"same bits: {row['whole_same_bits']}; sharded twice: {row['sharded_same_bits']}; "
            f"pair count {'equal' if count_ok else 'DIFFERS'}; the whole-batch step with its "
            f"pairs reordered against it: set aside {row['whole_permuted']['moved']}, excess "
            f"{row['whole_permuted']['excess']:.3g}, {len(row['whole_permuted']['misses'])} "
            f"codewords beyond the hold | {gpu}")
        for cl in row["classified"]:
            log(f"[probe {tag} miss] ({cl['cls']}) layer {cl['layer']} branch {cl['branch']} "
                f"codeword {cl['codeword']} column {cl['column']}: ref {cl['ref']:.7g} got "
                f"{cl['got']:.7g} (f32 gap {cl['gap32']:.3g}, hold {cl['hold']:.3g}); float64 "
                f"from each side's inputs {cl['f64_ref']:.9g} / {cl['f64_got']:.9g} (gap "
                f"{cl['gap64']:.3g}); reach eps sum|terms| / size {cl['reach']:.3g} (x{KAPPA} "
                f"{KAPPA * cl['reach']:.3g}); {cl['members']} members (same on both sides: "
                f"{cl['same_members']}; a row moved elsewhere: {cl['shares_moved']}), EMA size "
                f"{cl['size']:.4g}, BN std {cl['std']:.3g}, terms sum {cl['terms_sum']:.4g} "
                f"sum|.| {cl['terms_abs']:.4g}; the column's inputs max|diff|, sharded / "
                f"reordered whole batch: members {cl['d_members_in']:.3g} / "
                f"{cl['d_perm_members_in']:.3g} of max {cl['max_members_in']:.3g}, all rows "
                f"{cl['d_half_all_rows']:.3g} / {cl['d_perm_all_rows']:.3g} of "
                f"{cl['max_half_all_rows']:.3g}; the CPU's: members {cl['d_cpu_members_in']}, "
                f"all rows {cl['d_cpu_all_rows']}; the reordered step's codeword (float64) "
                f"{cl['f64_perm']:.9g}, gap {cl['gap_perm']:.3g}")
        for s in row["2-D"]:
            s["misses"] = s["misses"][:20]
        result["states"].append(row)
        del outs, calls, recs, got32
    n = len(result["states"])
    misses = sum(bool(r["classified"]) or any(s["misses"] for s in r["2-D"])
                 for r in result["states"])
    by_cls = {}
    for r in result["states"]:
        for cl in r["classified"]:
            by_cls[cl["cls"]] = by_cls.get(cl["cls"], 0) + 1
    by_f64 = {}
    for r in result["states"]:
        for mname in MESHES:
            for fc in r.get("f64", {}).get(mname, []):
                key = f"{mname} {fc['f64_cls']}"
                by_f64[key] = by_f64.get(key, 0) + 1
    if args.f64:
        worst = max(h[x] for r in result["states"] for mname in MESHES
                    for h in r["f64_halves"][mname] for x in ("X", "G"))
        log(f"[probe summary f64] the codewords beyond the hold by the float64 control's class: "
            f"{by_f64}; largest float64 difference of a half, of its column's max, over every "
            f"state, layer and mesh: {worst:.3g} | {gpu}")
    same = all(r["whole_same_bits"] for r in result["states"])
    sh_same = [v for r in result["states"] for v in r["sharded_same_bits"].values() if v]
    perm_miss = sum(bool(r["whole_permuted"]["misses"]) for r in result["states"])
    cpu_rows = [r for r in result["states"] if "whole_cpu" in r]
    cpu_miss = sum(bool(r["whole_cpu"]["misses"]) for r in cpu_rows)
    log(f"[probe summary] the whole-batch step with its pairs reordered misses the hold against "
        f"itself in {perm_miss} of {n} states; on the CPU, against the card's, in {cpu_miss} of "
        f"the {len(cpu_rows)} states with a miss")
    log(f"[probe summary] {n} states: {misses} miss the hold on a mesh ({n_fail} fail "
        f"compare_step); 1-D misses by cause {by_cls}; set aside 1-D "
        f"{[r['1-D']['moved'] for r in result['states']]}; whole-batch step the same bits twice "
        f"from every state: {same}; sharded step the same bits twice: "
        f"{all(all(v) for v in sh_same) if sh_same else 'not run'} ({len(sh_same)} checks) | {gpu}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    print(json.dumps({"states": n, "missed": misses, "by_cause": by_cls, "by_f64": by_f64,
                      "whole_same_bits": same, "time": result["time"]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
