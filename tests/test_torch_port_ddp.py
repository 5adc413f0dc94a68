"""The port's data-parallel training (``vq_gnn_tpu_torch/parallel/``) against
the JAX package's ``make_ddp_step`` (``vq_gnn_tpu/parallel/multihost.py``),
on the CPU.

Two gloo ranks are spawned once for the module (``_torch_ddp_worker.py``,
``init_method=file://`` in a temporary directory, so that parallel test
workers never race for a port).  Each rank runs every case on its own
batches, drawn by the port's ``BatchLoader(node_range=...)`` at fixed pad
sizes, from the JAX package's initial state, and pickles what it saw.  The
pytest process runs the JAX step on ``stack_local_batches`` of the same two
ranks' batches and holds the ranks to it:

(a) host batches: the port's loader with ``node_range`` and fixed pads
    gives the JAX loader's arrays exactly (single-K, mixed-K, COO, B + M);
(b) one step of each case the JAX step runs (GCN, SAGE, GAT, mixed-K, COO,
    B + M GCN, dropbranch on JAX's masks, GCN with sync-BN): the loss to
    rtol 1e-5, the parameters and codebooks to atol 1e-4 (rtol 1e-5),
    ``c_indices[:N]`` equal;
(c) six steps through the multi-window cont loader of
    ``tests/_multistep_common.py`` with ``node_range``: losses to rtol 1e-4;
(d) the replicated state (parameters, codebooks, ``c_indices``, BN) has one
    sha256 on both ranks after every step;
(e) each rank's collective ledger stays within the budget that
    ``tests/test_collective_audit.py:95-112`` computes for the JAX step,
    with the u8 ``c_indices`` gather and the [nb, M, 2D] statistics
    all-reduce in it and nothing graph-sized;
(f) at one rank (an in-process gloo group) the data-parallel step equals
    ``train_step`` bit for bit, f32 and bf16;
(g) what the JAX step cannot run raises by name.

Tolerances: f32 sums in another order (the ranks' sums added by the
all-reduce, JAX's over the concatenated shards).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vq_gnn_tpu import config as jcfg
from vq_gnn_tpu.graph import datasets as jdata
from vq_gnn_tpu.nn import model as jmodel
from vq_gnn_tpu.parallel import multihost as jmh
from vq_gnn_tpu.sampler import samplers as jsamplers
from vq_gnn_tpu.train.loop import device_features as j_device_features
from vq_gnn_tpu.train.state import init_train_state as j_init_train_state
from vq_gnn_tpu_torch import config as tcfg
from vq_gnn_tpu_torch import parallel as tpar
from vq_gnn_tpu_torch.convert import state_from_numpy
from vq_gnn_tpu_torch.graph import datasets as tdata
from vq_gnn_tpu_torch.nn import model as tmodel
from vq_gnn_tpu_torch.nn.vq import VQState
from vq_gnn_tpu_torch.sampler import samplers as tsamplers
from vq_gnn_tpu_torch.train.loop import device_features
from vq_gnn_tpu_torch.train.state import init_train_state
from vq_gnn_tpu_torch.train.step import make_step_fns
from tests._multistep_common import multistep_cfg_graph
from tests.test_torch_port_native import steady_native

steady_native()  # one native host library on both sides (that file says why)

HERE = os.path.dirname(os.path.abspath(__file__))
GRAPH = dict(num_nodes=400, num_features=16, num_classes=4, seed=0)
LR = 0.01
BASE = dict(dataset="synthetic", num_layers=2, hidden_channels=16, num_D=4, num_M=8,
            batch_size=100, skip=True, vq_update_mode="live", pad_multiple_nodes=64,
            pad_multiple_edges=512, lr=LR, fixed_B_pad=128, fixed_Bp_pad=256, fixed_E_pad=4096)
NODE_RANGES = [(0, 200), (200, 400)]  # each rank's seeds
# one step of each: without the inter-layer BN (a bias ahead of a BN has a
# zero gradient in exact arithmetic, and RMSprop's first step turns its
# ~1e-9 rounding noise into an lr-sized move either way, so the training
# tests of the earlier slices turn the BN off too), and GCN with it, whose
# sync-BN statistics are compared and its pre-BN biases are not
STEP_CASES = {
    "GCN": dict(bn_flag=False), "SAGE": dict(conv_type="SAGE", bn_flag=False),
    "GAT": dict(conv_type="GAT", bn_flag=False), "mixed-K": dict(ell_Kt=2, bn_flag=False),
    "COO": dict(spmm_backend="coo", bn_flag=False),
    "bm-GCN": dict(formulation="bm", bn_flag=False),
    "dropbranch": dict(dropbranch=0.5, bn_flag=False), "GCN-syncBN": {},
}
MULTI = "multistep"
MULTI_STEPS = 6
# states: atol 1e-4 and, as tests/test_torch_port_vq.py holds VQ states,
# rtol 1e-5 (the de-normalised codewords of a fresh codebook reach ~1e5)
RTOL_LOSS, ATOL_STATE, RTOL_STATE, RTOL_MULTI = 1e-5, 1e-4, 1e-5, 1e-4
VQ_FIELDS = [f.name for f in dataclasses.fields(VQState)]


def _plain(x):
    """A JAX state as dicts, lists and numpy arrays (the worker imports no JAX)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return None if x is None else np.asarray(x)


def _jax_masks(ms, rng, p):
    """The dropbranch masks the JAX step draws from ``rng``
    (``vq_gnn_tpu/parallel/multihost.py:99-107``)."""
    kd = jax.random.fold_in(rng, 7)
    masks = []
    for nb in ms.num_branches:
        kd, sub = jax.random.split(kd)
        perm = np.asarray(jax.random.permutation(sub, nb))
        keep = np.zeros(nb, bool)
        keep[perm[: int(nb * (1.0 - p))]] = True
        masks.append(keep)
    return masks


def _prepared(data, cfg):
    """(graph, classes, cluster indices) of the module's SBM, prepared by
    ``data`` (either package's ``graph.datasets``) for ``cfg``."""
    g, c = data.synthetic_sbm(**GRAPH)
    return data.prepare(g, cfg, c)


def _jax_case(cfg_kw):
    """(cfg, graph, classes, ModelStatic, initial state) of the JAX package."""
    cfg = jcfg.Config(**cfg_kw)
    g, c, _ = _prepared(jdata, cfg)
    ms = jmodel.model_static(cfg, g.num_features, c)
    return cfg, g, c, ms, j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)


class DDPRun:
    """The plan, the two spawned ranks and, once they finish, what they saw."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.ctx, cases = {}, []
        for name, kw in STEP_CASES.items():
            cfg, g, c, ms, st = _jax_case({**BASE, **kw})
            masks = (_jax_masks(ms, jax.random.PRNGKey(2), cfg.dropbranch) if cfg.dropbranch
                     else None)
            self.ctx[name] = (cfg, g, c, ms)
            cases.append(dict(name=name, cfg=dataclasses.asdict(cfg), state=_plain(st),
                              masks=masks, node_range=NODE_RANGES, shuffle=False, steps=1))
        cfg, (g, c) = multistep_cfg_graph()
        assert np.array_equal(g.x, jdata.synthetic_sbm(**GRAPH)[0].x)
        g, c, _ = jdata.prepare(g, cfg, c)
        ms = jmodel.model_static(cfg, g.num_features, c)
        half = g.num_nodes // 2
        self.ctx[MULTI] = (cfg, g, c, ms)
        cases.append(dict(name=MULTI, cfg=dataclasses.asdict(cfg),
                          state=_plain(j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)),
                          masks=None, node_range=[(0, half), (half, 2 * half)], shuffle=True,
                          steps=MULTI_STEPS))
        plan = os.path.join(tmp, "plan.pkl")
        with open(plan, "wb") as f:
            pickle.dump(dict(graph=GRAPH, lr=LR, cases=cases), f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OMP_NUM_THREADS"] = "1"
        self.outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(2)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_ddp_worker.py"), str(r), "2",
             os.path.join(tmp, "pg"), plan, self.outs[r]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
        self._res = None

    def results(self):
        """[rank 0's, rank 1's] pickled results, waiting for the ranks once."""
        if self._res is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
            finally:
                self.stop()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
            self._res = []
            for out in self.outs:
                with open(out, "rb") as f:
                    self._res.append(pickle.load(f))
        return self._res

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    run = DDPRun(str(tmp_path_factory.mktemp("ddp")))
    yield run
    run.stop()


def _port_state(jstate, case):
    """The port's TrainState of a JAX state, for comparing named parameters."""
    cfg, g, c, _ = case
    ms_t = tmodel.model_static(tcfg.Config(**dataclasses.asdict(cfg)), g.num_features, c,
                               torch.device("cpu"))
    return state_from_numpy(jax.tree.map(np.asarray, jstate), ms_t, LR, "cpu")


def _close(out, ref, name):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL_STATE,
                               atol=ATOL_STATE, err_msg=name)


# ---------------------------------------------------------------------------
# (b) one step of each case, and (c) six steps through the cont loader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_ddp_step_matches_jax(ddp, name):
    """One step of each case on the two ranks' first batches against the
    JAX step on their stack: loss, parameters, VQ states, BN statistics."""
    cfg, g, c, ms = ddp.ctx[name]
    state = j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)
    batches = []
    for r in range(2):
        loader = jsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=False, seed=r,
                                       node_range=NODE_RANGES[r])
        batches.append(next(loader._epoch_iter())[0][0])
    step = jmh.make_ddp_step(ms, cfg)
    new, m = step(state, j_device_features(g.x),
                  jax.tree.map(jnp.asarray, jmh.stack_local_batches(batches)), jnp.float32(1.0),
                  jnp.float32(LR), jnp.float32(1.0), jax.random.PRNGKey(2))
    ref = _port_state(new, ddp.ctx[name])
    N = g.num_nodes
    for rank, res in enumerate(ddp.results()):
        out = res[name]
        assert out["B_pad"] == [cfg.fixed_B_pad]
        np.testing.assert_allclose(out["loss"][0], float(m["loss"]), rtol=RTOL_LOSS,
                                   err_msg=f"rank {rank} loss")
        for k, v in ref.model.named_parameters():
            layer = int(k.split(".")[1])
            if cfg.bn_flag and layer < ms.num_layers - 1 and k.endswith(".bias"):
                continue  # ahead of a BN: noise, see STEP_CASES
            _close(out["params"][k], v.detach().numpy(), f"rank {rank} {k}")
        for l, (o, s) in enumerate(zip(out["vq"], new.vq_states)):
            for f in ("embedding", "embedding_output", "ema_w", "ema_cluster_size",
                      "bn_feat_mean", "bn_feat_var", "bn_grad_mean", "bn_grad_var"):
                _close(o[f], getattr(s, f), f"rank {rank} layer {l} {f}")
            np.testing.assert_array_equal(o["c_indices"][:N], np.asarray(s.c_indices)[:N],
                                          err_msg=f"rank {rank} layer {l} c_indices")
        for key in ("mean", "var"):
            for o, s in zip(out["bn"][key], getattr(new.bn_state, key)):
                _close(o, s, f"rank {rank} BN {key}")
    if cfg.dropbranch:  # the dropped branches' codebooks kept their values
        out0 = ddp.results()[0][name]
        state0 = j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)
        for l, mask in enumerate(_jax_masks(ms, jax.random.PRNGKey(2), cfg.dropbranch)):
            np.testing.assert_array_equal(out0["vq"][l]["embedding"][~mask],
                                          np.asarray(state0.vq_states[l].embedding)[~mask])


def test_ddp_multistep_loader_matches_jax(ddp):
    """Six steps through the multi-window cont loader with ``node_range``
    (``tests/test_multiprocess.py:test_two_process_multistep_loader``), the
    JAX step on the stacked batches of the same two loaders."""
    cfg, g, c, ms = ddp.ctx[MULTI]
    state = j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)
    X = j_device_features(g.x)
    half = g.num_nodes // 2
    loaders = [jsamplers.BatchLoader(g, cfg, train_flag=True, shuffle=True, seed=r,
                                     node_range=(r * half, (r + 1) * half)) for r in range(2)]
    step = jmh.make_ddp_step(ms, cfg)
    losses, windows_seen = [], set()
    for items in zip(*[ld._epoch_iter() for ld in loaders]):
        wins = [w for w, _ in items]
        assert len({len(w) for w in wins}) == 1
        windows_seen.add(len(wins[0]))
        for wi in range(len(wins[0])):
            stacked = jmh.stack_local_batches([w[wi] for w in wins])
            do_opt = 0.0 if (len(wins[0]) > 1 and wi == 0) else 1.0
            state, m = step(state, X, jax.tree.map(jnp.asarray, stacked), jnp.float32(1.0),
                            jnp.float32(LR), jnp.float32(do_opt),
                            jax.random.fold_in(jax.random.PRNGKey(2), len(losses)))
            losses.append(float(m["loss"]))
            if len(losses) == MULTI_STEPS:
                break
        if len(losses) == MULTI_STEPS:
            break
    assert windows_seen == {2}  # multi-window batches, the optimizer skipped on window 0
    for rank, res in enumerate(ddp.results()):
        np.testing.assert_allclose(res[MULTI]["loss"], losses, rtol=RTOL_MULTI,
                                   err_msg=f"rank {rank}")


# ---------------------------------------------------------------------------
# (d) replicas, (e) the collective budget
# ---------------------------------------------------------------------------
def test_replicas_bit_identical(ddp):
    """After every step of every case, both ranks hold one replicated state
    (``tests/test_multiprocess.py`` asserts the same of the JAX ranks) and
    report one loss; a group of two ranks without fixed pads is refused."""
    r0, r1 = ddp.results()
    for name in list(STEP_CASES) + [MULTI]:
        a, b = r0[name], r1[name]
        assert len(a["digests"]) == len(b["digests"]) == (MULTI_STEPS if name == MULTI else 1)
        assert a["digests"] == b["digests"], name
        assert a["loss"] == b["loss"], name
        assert all(np.isfinite(a["loss"]))
    for r in (r0, r1):
        assert "fixed_B_pad" in r["no_fixed_pads"], r["no_fixed_pads"]


def test_collective_budget(ddp):
    """The JAX DDP step's analytic per-category budget
    (``tests/test_collective_audit.py:95-112``) at the GCN case's widths;
    the u8 assignment gather ([2 B_pad, nb]) and the EMA statistics
    all-reduce ([nb, M, 2D] beside the counts) issued; no payload as large
    as the feature table, the ``c_indices`` table or the batch's edges."""
    cfg, g, c, ms = ddp.ctx["GCN"]
    n_shards, B_pad = 2, cfg.fixed_B_pad
    nb, M, D = ms.num_branches[0], ms.vq.num_M, ms.num_D
    state = j_init_train_state(jax.random.PRNGKey(0), ms, g.num_nodes)
    grad_budget = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(state.params))
    ema_budget = ms.num_layers * 4 * (nb * M * 2 * D + nb * M) * 2
    assign_bytes = nb * (1 if M <= 256 else 2)
    cidx_budget = ms.num_layers * n_shards * B_pad * assign_bytes + n_shards * B_pad * (4 + 1)
    budget = grad_budget + ema_budget + cidx_budget + 8192
    cap = min((g.num_nodes + 1) * g.num_features, (g.num_nodes + 1) * nb, 3000 * 8)
    for rank, res in enumerate(ddp.results()):
        led = res["GCN"]["ledger"]
        assert led["steps"] == 1
        per = led["per_step"]["bytes"]
        assert sum(per.values()) <= budget, (rank, per, budget)
        assert per["grad"] <= grad_budget and per["c_indices"] <= cidx_budget, per
        kinds = led["kinds"]
        assert {op for _, op, _, _ in kinds} == {"all_reduce", "all_gather"}
        assert ("c_indices", "all_gather", "uint8", ((n_shards * B_pad, nb),)) in kinds
        assert any(cat == "stats" and op == "all_reduce" and (nb, M, 2 * D) in shapes
                   for cat, op, _, shapes in kinds)
        for _, _, _, shapes in kinds:
            for s in shapes:
                assert int(np.prod(s)) < cap, (s, cap)


# ---------------------------------------------------------------------------
# (a) host batches, and the partition
# ---------------------------------------------------------------------------
CONT = dict(sampler_type="cont", walk_length=2, cont_sliding_window=2, fixed_Bp_pad=384,
            fixed_E_pad=8192)
BATCH_CASES = {
    "single-K-cont": dict(CONT),
    "mixed-K": dict(ell_Kt=2),
    "COO-GAT": dict(spmm_backend="coo", conv_type="GAT"),
    "bm-SAGE-cont": dict(CONT, formulation="bm", conv_type="SAGE"),
}
SINGLE_K = ("ell_row", "ell_col", "ell_val", "t_ell_row", "t_ell_col", "t_ell_val")
MIXED = ("head_rowc", "head_col", "head_val", "head_inv", "head_rowg", "tail_row", "tail_col",
         "tail_val", "t_head_rowc", "t_head_col", "t_head_val", "t_head_inv", "t_head_rowg",
         "t_tail_row", "t_tail_col", "t_tail_val")
COO_FIELDS = ("row", "col", "val", "tperm")


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_node_range_fixed_pad_batches_match_jax(name):
    """Two epochs of each rank's batches: the fixed shapes, the layout's
    arrays, the full transposed VJP (no truncation bound) and the B + M
    reverse list, exactly as the JAX loader builds them."""
    kw = {**BASE, **BATCH_CASES[name]}
    cfgs = jcfg.Config(**kw), tcfg.Config(**kw)
    (jg, _, _), (tg, _, _) = [_prepared(d, cfg) for d, cfg in zip((jdata, tdata), cfgs)]
    n = 0
    for r in range(2):
        jl = jsamplers.BatchLoader(jg, cfgs[0], train_flag=True, seed=r,
                                   node_range=NODE_RANGES[r])
        tl = tsamplers.BatchLoader(tg, cfgs[1], train_flag=True, seed=r, device="cpu",
                                   node_range=NODE_RANGES[r])
        for _ in range(2):
            for (jw, jraw), (tw, traw) in zip(jl._epoch_iter(), tl._epoch_iter(), strict=True):
                for a, b in zip(jraw, traw, strict=True):
                    np.testing.assert_array_equal(a, b)
                if "sampler_type" not in BATCH_CASES[name]:  # node sampler: the seeds
                    lo, hi = NODE_RANGES[r]
                    assert ((traw[0] >= lo) & (traw[0] < hi)).all()
                for jb, tb in zip(jw, tw, strict=True):
                    n += 1
                    assert (tb.B_pad, tb.Bp_pad) == (kw["fixed_B_pad"], kw["fixed_Bp_pad"])
                    for f in ("batch_idx", "fo_ids", "valid_B", "valid_fo", "y", "train_mask"):
                        np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f), err_msg=f)
                    je, te = jb.edges, tb.edges
                    fields = (MIXED if te.mixed else COO_FIELDS if te.ell_row is None
                              else SINGLE_K)
                    for f in fields:
                        np.testing.assert_array_equal(getattr(je, f), getattr(te, f),
                                                      err_msg=f)
                    assert te.b_rows == 0 and je.t_b_slots == 0  # the full VJP
                    has_rev = kw.get("formulation") == "bm"
                    assert (jb.rev_slot_val is not None) == (tb.rev_slot_val is not None) \
                        == has_rev
                    if has_rev:
                        np.testing.assert_array_equal(jb.rev_slot_val, tb.rev_slot_val)
    assert n >= 4


def test_partition_hosts_matches_jax():
    """One locality partition per rank: the JAX package's (perm, ptr)."""
    g = jdata.synthetic_sbm(**GRAPH)[0]
    for hosts in (2, 3):
        jp, jptr = jmh.partition_hosts(g.adj, hosts)
        tp, tptr = tpar.partition_hosts(g.adj, hosts)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jptr, tptr)


def test_fixed_pads_refuse_an_oversized_batch():
    """A batch of more edges than ``fixed_E_pad`` raises, on every layout,
    as ``vq_gnn_tpu/sampler/batch.py`` does."""
    for kw in (dict(), dict(ell_Kt=2), dict(spmm_backend="coo")):
        cfg = tcfg.Config(**{**BASE, "fixed_E_pad": 1024, **kw})
        g, _, _ = _prepared(tdata, cfg)
        loader = tsamplers.BatchLoader(g, cfg, seed=0, device="cpu", node_range=(0, 200))
        with pytest.raises(ValueError, match="exceeds pad sizes"):
            next(loader._epoch_iter())


# ---------------------------------------------------------------------------
# (f) one rank equals train_step, (g) refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """An in-process gloo group of one rank."""
    assert not dist.is_initialized()
    tpar.init_distributed("gloo", f"file://{tmp_path_factory.mktemp('pg1')}/pg", 1, 0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_one_rank_equals_train_step(one_rank, dtype):
    """Four steps (two batches of two cont windows, the optimizer skipped on
    each first window) of the data-parallel step and of ``train_step``
    from one state, with dropbranch on one set of masks: the same losses,
    parameters, codebooks, BN statistics and ``c_indices[:N]``, bit for bit.
    float16 runs with the codebooks frozen ('reference'): live updates take
    their feature half past f16's range after the first step, and the loss
    goes nonfinite, as in the JAX package (tests/test_torch_port_f16.py)."""
    mode = "reference" if dtype == "float16" else BASE["vq_update_mode"]
    cfg = tcfg.Config(**{**BASE, **CONT, "dropbranch": 0.5, "compute_dtype": dtype,
                         "bn_flag": True, "vq_update_mode": mode})
    g, c, _ = _prepared(tdata, cfg)
    cpu = torch.device("cpu")
    ms = tmodel.model_static(cfg, g.num_features, c, cpu)
    states = [init_train_state(torch.Generator().manual_seed(1), ms, g.num_nodes, LR, cpu)
              for _ in range(2)]
    X = device_features(g.x, cpu)
    ddp = tpar.make_ddp_step(ms, cfg)
    train_step = make_step_fns(ms, cfg).train_step
    loader = tsamplers.BatchLoader(g, cfg, seed=0, device="cpu", node_range=(0, 200))
    masks = [torch.tensor([True, False] * (nb // 2)) for nb in ms.num_branches]
    n = 0
    for windows, _ in loader:
        for wi, b in enumerate(windows):
            do_opt = 0.0 if wi == 0 else 1.0
            states[0], m0 = train_step(states[0], X, b, 1.0, LR, do_opt, branch_masks=masks)
            states[1], m1 = ddp(states[1], X, b, 1.0, LR, do_opt, branch_masks=masks)
            assert torch.equal(m0["loss"], m1["loss"]) and torch.isfinite(m1["loss"])
            assert bool(m0["bad_init"]) == bool(m1["bad_init"])
            n += 1
        if n >= 3:
            break
    a, b = states
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    for s, t in zip(a.vq_states, b.vq_states):
        for f in VQ_FIELDS:
            x, y = getattr(s, f), getattr(t, f)
            if f == "c_indices":  # row N is the padding dustbin, in no fixed order
                x, y = x[:-1], y[:-1]
            assert torch.equal(x, y), f
    for x, y in zip(a.bn_state.mean + a.bn_state.var, b.bn_state.mean + b.bn_state.var):
        assert torch.equal(x, y)
    led = ddp.ledger
    assert led.steps == n and led.calls["grad"] == n
    # per layer: two BN rounds and the EMA statistics; the sync-BN once; the
    # assignments each step and each layer; under 'reference' only the
    # sync-BN (the codebooks, and so their statistics and assignments, stay)
    live = mode == "live"
    assert led.calls["stats"] == n * (3 * ms.num_layers * live + 1)
    assert led.calls["c_indices"] == n * (1 + ms.num_layers) * live


@pytest.mark.parametrize("kw,err", [
    (dict(formulation="bm", conv_type="GAT"), NotImplementedError),
    (dict(formulation="bm", transformer_flag=True), NotImplementedError),
    (dict(mesh_data=2), ValueError),
], ids=["bm-GAT", "transformer", "mesh_data"])
def test_ddp_refuses_by_name(one_rank, kw, err):
    """B + M GAT and the transformer: the JAX step cannot run them
    (``config.no_reference_path``); a ``mesh_data`` other than the group's
    size (0 = every rank)."""
    cfg = tcfg.Config(**{**BASE, **kw})
    ms = tmodel.model_static(cfg, 16, 4, torch.device("cpu"))
    match = "JAX package has no such path" if err is NotImplementedError else "mesh_data=2"
    with pytest.raises(err, match=match):
        tpar.make_ddp_step(ms, cfg)
    mesh = tpar.make_mesh(0, device="cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        tpar.make_mesh(2, device="cpu")


def test_cluster_sampler_refuses_node_range():
    """As the JAX loader does (``vq_gnn_tpu/sampler/samplers.py:323-327``)."""
    for cfg_mod, data, samplers, extra in ((jcfg, jdata, jsamplers, {}),
                                           (tcfg, tdata, tsamplers, dict(device="cpu"))):
        cfg = cfg_mod.Config(**{**BASE, "sampler_type": "cluster", "num_parts": 4,
                                "batch_size": 2})
        g, _, ci = _prepared(data, cfg)
        with pytest.raises(ValueError, match="node_range with the cluster sampler"):
            samplers.BatchLoader(g, cfg, cluster_indices=ci, node_range=(0, 200), **extra)
