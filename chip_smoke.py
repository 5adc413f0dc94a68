#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vq_gnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc.  Phases:

1. build the seven CUDA kernel libraries from ``vq_gnn_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, all at once);
2. build the bench's arxiv-scale synthetic graph (N = 169,343, degree 13.7,
   128 features, 40 classes) and its 80-part partition, normalised once per
   conv (GCN, SAGE and GAT normalise differently) and once with the v1
   normalisation for the B + M GAT path;
3. drive the training paths through the trainer, one after the other, each
   with the launch counters zeroed just before it and read just after —
   3 layers x 128, num_D = 4, live VQ updates, f32, vq_backend =
   'pallas_fast':
   - GCN B + B' (M = 256, ELL K = 8, 40 of 80 parts per batch): layerwise
     init sweep, one epoch of ``train_step``, ten more timed steps, three
     profiled steps, one ``evaluate``;
   - SAGE: init sweep, one epoch, three timed steps;
   - GAT: as GCN;
   - GAT with hidden 256 and 2 layers (layer 1 runs the GAT kernels at
     C = 256): init sweep, one epoch, two more steps;
   - GAT B + M (``bench.py`` with VQ_GNN_BENCH_FORM=bm, K = 2, f32: M =
     1,024, cont sampler of 10,000 nodes, walk length 3, recovery on):
     as GCN;
   each profile also counts the copy kernels and checks, on the B + M
   path, that no row offsets were built on the device;
4. check that each path launched each of its kernels;
5. hold each kernel against its plain PyTorch version on the card at the
   shapes of the real batch (kernel 1 with the batch's row offsets and long
   rows, and bit-identical run to run, at 1, 2 and 4 channel panels, with a
   long-row list of another threshold and without the host's lists; kernel
   2 also at nb = 1 and, with kernel 3, at the B + M widths K = 9, M =
   1,024; kernel 2's exact mode bit-equal, its
   fast mode, whose distances run on the tensor cores, by the near-tie rule
   of ``assign_mismatch`` and run-to-run identical; kernel 4 at C = 128 and
   256, with and without the masked channels, with the batch's row offsets
   and long rows and without them, and bit-identical run to run and across
   them; kernel 5 at C = 128 and 256, each at dx_rows = 0, b_rows and R
   with the batch's row lists, and bit-identical run to run; kernel 3
   bit-equal in both modes, as the [n, nb, K] table and split at num_D as
   the step calls it; the segment sum at C = 128 and 32 over the B + M
   batch's forward and transposed ELL with the batch's row offsets and long
   rows, with and without its scalar channel, and bit-identical run to run
   and with the offsets alone or built on the device; the recovery
   kernels at nb = 32, M = 1,024 over the batch's own reverse list, row
   offsets and long rows, and bit-identical run to run);
6. time each kernel, its plain version and a PyTorch library yardstick where
   one call computes the same function (kernel 1 also at 2 and 4 panels,
   without the long-row list, on narrower copies of x and with x's rows
   relabelled at random, beside the no-reuse line, and at C = 256 in one
   panel and in panel_width's; kernel 2 also as the device time of a
   CUDA-graph replay, free of the host's launch gaps; the recovery kernels
   also split by device kernel: table pack, row pass, codeword pass and
   reductions, from ``torch.profiler``; kernel 4 at C = 128 with and without
   the masked channels and at C = 256, with its device time and the rate of
   its gathered bytes; kernel 5 at each call shape of the GAT step, with its
   device time; kernel 3 split as the step calls it, against advanced
   indexing and the two slices the step ran before, and whole, with device
   times; the segment sum at each width and layout of the B + M conv, with
   device time and its bound over the live slots beside the one over every
   slot);
7. run a small graph through the same paths (GCN, SAGE, GAT, and B + M GCN,
   SAGE and GAT) on the GPU and on the CPU (plain versions) from one state,
   count the codeword assignments that come to differ, and compare each
   step's loss terms up to the first such difference, and the predictions;
8. run the bench's timing function (``bench_torch.run_bench``) on phase 2's
   GCN graph with the bench's default configuration: its batch must be the
   first batch phase 3's GCN epoch trains on, and its record (edges/s,
   loss, peak memory, device busy, eval forward) finite and printed;
9. run the CLI (``main_node_torch.main``) in-process on the card with its
   verification command (``main_node.py``'s quick check, ``CLI_ARGS``): 3
   epochs on a 500-node SBM must reach test accuracy 0.9.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and, as
the last line, ``{"ok": true, "device": {...}}``.  Any failed phase raises
and the script exits non-zero without that line.  Without a CUDA device, or
without the package beside it, it exits non-zero at once.
"""

import copy
import json
import math
import sys
import time
import warnings

from vq_gnn_tpu_torch.utils.profiling import device_rows, gpu_line, profile_steps

# ---- flagship configuration (bench.py:62-90) ----
N_NODES, AVG_DEG, N_FEAT, N_CLASSES = 169_343, 13.7, 128, 40
NUM_PARTS, PARTS_PER_BATCH = 80, 40
TIMED_STEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
# the CLI's verification run: 2 layers x 16 on a 500-node SBM, 3 epochs
CLI_ARGS = ["--dataset", "synthetic:500", "--num-layers", "2", "--hidden-channels", "16",
            "--num-D", "4", "--num-M", "8", "--batch-size", "128", "--test-batch-size", "256",
            "--epochs", "3", "--skip", "--lr", "0.05"]
PATH_KERNELS = {  # kernels each training path must launch
    "GCN": ("ell_aggregate", "vq_assign", "vq_lookup"),
    "SAGE": ("ell_aggregate", "vq_assign", "vq_lookup"),
    "GAT": ("gat_aggregate", "gat_backward", "vq_assign", "vq_lookup"),
    "GAT-bm": ("segment_sum", "rev_forward", "rev_backward", "vq_assign", "vq_lookup"),
}



def log(*a):
    print(*a, flush=True)


def bm_cfg(Config, **kw):
    """The bench's B + M configuration (bench.py:69-90 with
    VQ_GNN_BENCH_FORM=bm, VQ_GNN_BENCH_CONV=GAT, VQ_GNN_BENCH_K=2,
    VQ_GNN_BENCH_DTYPE=float32)."""
    base = dict(formulation="bm", conv_type="GAT", num_M=1024, sampler_type="cont",
                walk_length=3, batch_size=10000, ell_K=2, recovery_flag=True)
    base.update(kw)
    return flagship_cfg(Config, **base)


def flagship_cfg(Config, **kw):
    base = dict(
        dataset="arxiv", conv_type="GCN", formulation="bbprime", num_layers=3,
        hidden_channels=128, num_D=4, num_M=256, sampler_type="cluster",
        num_parts=NUM_PARTS, batch_size=PARTS_PER_BATCH, vq_update_mode="live",
        warm_up_flag=True, skip=True, matmul_precision="default",
        vq_backend="pallas_fast", spmm_backend="ell", compute_dtype="float32", ell_K=8,
    )
    base.update(kw)
    return Config(**base)


def cuda_time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_time_ms(torch, fn, reps=20) -> float:
    """Mean device time of ``fn()`` replayed from a CUDA graph: the kernels'
    time without the host's launch gaps between back-to-back calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_time_ms(torch, graph.replay, reps=reps)


def cold_time_ms(torch, fn, flush, reps=10) -> float:
    """Mean device time of single calls of ``fn()``, each after ``flush()``
    overwrote the L2 cache."""
    fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def live_cells(row, val, num_rows) -> int:
    """Non-zero ELL cells of the slots whose row is < num_rows."""
    return int(((val != 0) & (row[:, None] < num_rows)).sum())


def csr_of(torch, row, col, val, num_rows, x_rows):
    """The slot-ELL's live cells as a [num_rows, x_rows] CSR matrix."""
    K = col.shape[1]
    live = (val != 0) & (row[:, None] < num_rows)
    rows = torch.repeat_interleave(row.long(), K).reshape(-1, K)[live]
    with warnings.catch_warnings():  # beta-state notices of the sparse API
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(torch.stack([rows, col[live].long()]), val[live],
                                       (num_rows, x_rows)).coalesce().to_sparse_csr()


def ell_l2_probes(torch, agg, x, row, col, val, num_rows, flush, gpu, label):
    """Kernel 1 on contiguous copies x[:, :C] (C = 32, 64, 128; an x of 32
    channels fits in L2), and at full width with x's rows relabelled at
    random (col -> perm[col], padding columns kept: the same sums without
    locality), each warm and cold, beside the gathered bytes' rate and the
    line where every gathered row comes from device memory."""
    live = live_cells(row, val, num_rows)
    for C in (32, 64, 128):
        xc = x[:, :C].contiguous()
        run = lambda: agg(xc, row, col, val, num_rows)  # noqa: E731
        w, c = cuda_time_ms(torch, run), cold_time_ms(torch, run, flush)
        gathered = live * C * 4
        log(f"[6 ell_aggregate {label} C={C}] x {xc.numel() * 4 / 1e6:.1f} MB, gathered "
            f"{gathered / 1e6:.1f} MB: warm {w:.4f} ms ({gathered / w / 1e9:.3f} TB/s), cold "
            f"{c:.4f} ms ({gathered / c / 1e9:.3f} TB/s); no-reuse line "
            f"{gathered / HBM_BYTES_PER_S * 1e3:.4f} ms | {gpu}")
    gen = torch.Generator(device=x.device).manual_seed(0)
    perm = torch.randperm(x.shape[0], generator=gen, device=x.device).int()
    pcol = torch.where(col < x.shape[0], perm[col.clamp(max=x.shape[0] - 1).long()], col)
    xp = torch.empty_like(x)
    xp[perm.long()] = x
    run = lambda: agg(xp, row, pcol.contiguous(), val, num_rows)  # noqa: E731
    log(f"[6 ell_aggregate {label} C={x.shape[1]} rows relabelled at random] warm "
        f"{cuda_time_ms(torch, run):.4f} ms, cold {cold_time_ms(torch, run, flush):.4f} ms "
        f"| {gpu}")


def bound(bytes_moved: float, flops: float, flop_rate: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_split(torch, fn, calls=20):
    """Device us per call of each kernel ``fn`` launches (torch.profiler);
    empty where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {key: round(us / calls, 2) for us, _, key in device_rows(prof)}


def drive_path(torch, ops, NodeTrainer, tag, graph, cfg, gpu, timed_steps, profile, evaluate,
               kernels):
    """One training path through the trainer, launch counters zeroed just
    before it and read just after.  Returns what the later phases need."""
    g, c, ci = graph
    t0 = time.time()
    tr = NodeTrainer(g, cfg, c, ci, device="cuda")
    test_batches = tr.test_batches()  # host build of the eval batches (set-up)
    log(f"[{tag} setup] trainer + eval batches in {time.time() - t0:.1f}s; channels "
        f"{tr.ms.channels}")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    tr.run_init_sweep()
    torch.cuda.synchronize()
    log(f"[{tag} init sweep] {time.time() - t0:.2f}s over {len(test_batches)} eval batch(es) "
        f"B_pad={test_batches[0][0][0].B_pad}; launches {ops.launch_counts()}")
    bad = [bool(s.bad_init) for s in tr.state.vq_states]
    assert not any(bad), f"bad_init after the init sweep: {bad}"

    # the epoch's first batch is the bench's batch (phase 8): keep its edges
    first_E = []
    train_step = tr.fns.train_step

    def first_batch_step(state, X, batch, *a):
        if not first_E:
            first_E.append(int((batch.edges.ell_val != 0).sum()))
        return train_step(state, X, batch, *a)

    tr.fns.train_step = first_batch_step
    t0 = time.time()
    loss, loss_cls = tr.train_epoch(1)
    torch.cuda.synchronize()
    tr.fns.train_step = train_step
    log(f"[{tag} epoch 1] loss={loss:.4f} loss_cls={loss_cls:.4f} in {time.time() - t0:.2f}s; "
        f"its first batch E={first_E[0]}")
    assert math.isfinite(loss) and math.isfinite(loss_cls)

    batches = [w[0] for w, _ in tr.train_loader]  # one epoch of batches
    b0 = batches[0]
    e0 = b0.edges
    E_batch = int((e0.ell_val != 0).sum())
    log(f"[{tag} batch] B={b0.num_B} B_pad={b0.B_pad} B'={int(b0.valid_fo.sum())} "
        f"Bp_pad={b0.Bp_pad} E={E_batch} S_pad={e0.ell_row.shape[0]} "
        f"St_pad={e0.t_ell_row.shape[0]} t_b_slots={e0.t_b_slots} b_rows={e0.b_rows}")
    before = ops.launch_counts()
    times, losses = [], []
    for i in range(timed_steps):
        b = batches[i % len(batches)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.state, m = tr.fns.train_step(tr.state, tr.X_dev, b, 1.0, cfg.lr, 1.0, tr.generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        assert not bool(m["bad_init"]), "Bad Init!"
    per_step = {k: (v - before[k]) / timed_steps for k, v in ops.launch_counts().items()}
    if profile:
        def step(i):
            tr.state, _ = tr.fns.train_step(tr.state, tr.X_dev, batches[i % len(batches)], 1.0,
                                            cfg.lr, 1.0, tr.generator)

        prof = profile_steps(step, log=log, tag=tag, gpu=gpu)
        if prof is not None:
            rows = prof["rows"]
            # every kernel that takes row offsets got the batch's own
            built = sorted({k for _, _, k in rows if "row_offsets_kernel" in k})
            log(f"[{tag} profile] row offsets built on the device: {built or 'none'}")
            assert not (built and tag.endswith("GAT-bm")), "the B + M step built row offsets"
    mean = sum(times) / len(times)
    std = (sum((t - mean) ** 2 for t in times) / max(len(times) - 1, 1)) ** 0.5
    median = sorted(times)[len(times) // 2]
    log(f"[{tag} train] {timed_steps} steps: {mean:.2f} ms/step (std {std:.2f}, median "
        f"{median:.2f}, min {min(times):.2f}, max {max(times):.2f}) | {gpu}")
    log(f"[{tag} train] edges/s at this batch: {E_batch / (mean / 1e3):.4g}; launches per step "
        f"{per_step}; losses {[round(x, 4) for x in losses]}")
    assert all(math.isfinite(x) for x in losses)
    if evaluate:
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        acc = tr.evaluate()
        torch.cuda.synchronize()
        per_eval = {k: v - before[k] for k, v in ops.launch_counts().items()}
        log(f"[{tag} eval] train/val/test acc {acc} in {time.time() - t0:.2f}s; launches "
            f"{per_eval}")
        assert all(0.0 <= a <= 1.0 for a in acc)
    launches = ops.launch_counts()
    by_width = dict(ops.KERNELS["gat_backward"].by_width)

    # ---- 4. the path went through every one of its kernels ----
    log(f"[4 launches] {tag} path: {launches}; gat_backward by width {by_width}")
    for name in kernels:
        assert launches[name] > 0, f"kernel {name} was not launched on the {tag} path"
    return dict(tr=tr, batch0=b0, test_batches=test_batches, launches=launches,
                by_width=by_width, ms=mean, std=std, E_first=first_E[0])


def small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv, form, device):
    """The init sweep and two epochs of a 3,000-node graph through the trainer
    (exact f32: no TF32, the exact VQ distances).  Records each step's
    loss_cls and info_backward and every layer's codeword assignments after
    the init sweep and after each step."""
    exact = dict(conv_type=conv, matmul_precision="highest", vq_backend="pallas")
    if form == "bm":  # the B + M path at 1/10 of its batch and M = 64
        cfg_s = bm_cfg(Config, num_M=64, batch_size=1000, test_batch_size=1500, walk_length=2,
                       **exact)
    else:
        cfg_s = flagship_cfg(Config, num_parts=8, batch_size=4, test_batch_size=4, **exact)
    gs, cs = synthetic_sbm(num_nodes=3000, num_classes=N_CLASSES, num_features=N_FEAT,
                           avg_degree=AVG_DEG, seed=1)
    gs, cs, cis = prepare(gs, cfg_s, cs)
    ts = NodeTrainer(gs, cfg_s, cs, cis, device=device)
    ts.run_init_sweep()

    def codes(state):
        return [s.c_indices.cpu().clone() for s in state.vq_states]

    rec = dict(codes=[codes(ts.state)], steps=[])
    step = ts.fns.train_step

    def recording_step(*args):
        state, m = step(*args)
        rec["steps"].append((float(m["loss_cls"]), float(m["info_backward"])))
        rec["codes"].append(codes(state))
        return state, m

    ts.fns.train_step = recording_step
    rec["losses"] = [ts.train_epoch(ep)[0] for ep in (1, 2)]
    rec["pred"] = ts.predict_all()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vq_gnn_tpu_torch import ops
    from vq_gnn_tpu_torch.config import Config
    from vq_gnn_tpu_torch.graph.datasets import prepare, synthetic_sbm
    from vq_gnn_tpu_torch.ops import _build
    from vq_gnn_tpu_torch.ops.ell_aggregate import (
        ell_aggregate,
        ell_aggregate_plain,
        panel_width,
    )
    from vq_gnn_tpu_torch.ops.spmm import long_rows_host
    from vq_gnn_tpu_torch.ops.gat_kernels import (
        gat_aggregate,
        gat_aggregate_plain,
        gat_backward,
        gat_backward_plain,
    )
    from vq_gnn_tpu_torch.ops.rev_kernels import (
        rev_backward,
        rev_forward,
        rev_recovery_info_plain,
    )
    from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, segment_sum_sorted_plain
    from vq_gnn_tpu_torch.ops.vq_kernels import (
        assign_mismatch,
        codeword_sqnorm,
        fused_assign_branches,
        fused_assign_branches_plain,
        lookup_codewords,
        lookup_codewords_plain,
    )
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    import bench_torch
    import main_node_torch

    gpu = gpu_line()
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} | {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.time()

    # ---- 1. build the kernels ----
    t0 = time.time()
    reports = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    regs = sorted({ln.split("Used ")[1].split(",")[0] for rep in reports.values()
                   for ln in rep.splitlines() if "Used " in ln})
    spills = [ln for rep in reports.values() for ln in rep.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    log(f"[1 build] {time.time() - t0:.1f}s  registers per thread: {', '.join(regs)}  "
        f"spilling entries: {len(spills)}")

    # ---- 2. graph, normalised per conv ----
    t0 = time.time()
    raw = synthetic_sbm(num_nodes=N_NODES, num_classes=N_CLASSES, num_features=N_FEAT,
                        avg_degree=AVG_DEG, seed=0)
    graphs = {}
    for conv in ("GCN", "SAGE", "GAT"):
        g, c = copy.deepcopy(raw)
        graphs[conv] = prepare(g, flagship_cfg(Config, conv_type=conv), c)
    g, c = raw
    graphs["GAT-bm"] = prepare(g, bm_cfg(Config), c)  # v1 normalisation, no partition
    del raw
    g = graphs["GCN"][0]
    log(f"[2 graph] N={g.num_nodes} E(GCN-normalized, with self-loops)={g.num_edges} "
        f"parts={len(graphs['GCN'][2])} in {time.time() - t0:.1f}s")

    # ---- 3-4. the training paths, through the trainer ----
    runs = {}
    for tag, kind, cfg_p, steps, full in (
        ("3 GCN", "GCN", flagship_cfg(Config), TIMED_STEPS, True),
        ("3 SAGE", "SAGE", flagship_cfg(Config, conv_type="SAGE"), 3, False),
        ("3 GAT", "GAT", flagship_cfg(Config, conv_type="GAT"), TIMED_STEPS, True),
        ("3 GAT-256", "GAT",
         flagship_cfg(Config, conv_type="GAT", num_layers=2, hidden_channels=256), 2, False),
        ("3 GAT-bm", "GAT-bm", bm_cfg(Config), TIMED_STEPS, True),
    ):
        graph = graphs["GAT-bm" if kind == "GAT-bm" else cfg_p.conv_type]
        runs[tag] = drive_path(torch, ops, NodeTrainer, tag, graph, cfg_p, gpu, steps,
                               profile=full, evaluate=full, kernels=PATH_KERNELS[kind])
        if tag not in ("3 GCN", "3 GAT-bm"):
            runs[tag].pop("tr")  # only these trainers' states are read later
    assert runs["3 GAT-256"]["by_width"].get(256, 0) > 0, "gat_backward never ran at C = 256"
    log("[3 summary] ms/step " + ", ".join(
        f"{tag[2:]} {r['ms']:.2f} (std {r['std']:.2f})" for tag, r in runs.items()) + f" | {gpu}")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in ops.KERNELS}
    log(f"[4 launches] all paths: {launches}")
    tr, b0, test_batches = (runs["3 GCN"][k] for k in ("tr", "batch0", "test_batches"))
    cfg = tr.cfg
    e0 = b0.edges

    # ---- 5. kernels against their plain versions at the real shapes ----
    gen = torch.Generator(device=dev).manual_seed(0)
    R, C = e0.num_rows, cfg.hidden_channels
    x = torch.randn((R, C), generator=gen, device=dev)
    gx = torch.randn((R, C), generator=gen, device=dev)
    tb = e0.t_b_slots
    t_row = torch.clamp(e0.t_ell_row[:tb], max=e0.b_rows)
    t_col, t_val = e0.t_ell_col[:tb].contiguous(), e0.t_ell_val[:tb].contiguous()
    fwd_args = (x, e0.ell_row, e0.ell_col, e0.ell_val, R)
    dx_args = (gx, t_row, t_col, t_val, e0.b_rows)
    # the batch's own row offsets and long rows, as spmm passes them
    ell_kw = {"forward": dict(ptr=e0.ell_ptr, long_rows=e0.ell_long_rows),
              "dx": dict(ptr=e0.t_ell_ptr, long_rows=e0.t_ell_long_rows)}
    err = {}
    for label, args in (("forward", fwd_args), ("dx", dx_args)):
        kw = ell_kw[label]
        out, ref = ell_aggregate(*args, **kw), ell_aggregate_plain(*args)
        torch.cuda.synchronize()
        d = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        log(f"[5 ell_aggregate {label}] out {tuple(out.shape)} max|err| {d:.3g} (tol {tol:.3g}); "
            f"{kw['long_rows'].shape[0] - 1} long rows")
        assert torch.isfinite(out).all() and d <= tol
        err["ell_aggregate"] = max(err.get("ell_aggregate", 0.0), d)
        # no atomics, one group per (row, panel) summing in slot order: the
        # same bits run to run, at every panel count, with or without the
        # host's offsets and long rows, whatever the list's threshold
        lr4 = torch.as_tensor(long_rows_host(kw["ptr"].cpu().numpy(), 4)).to(dev)
        same = {"again": ell_aggregate(*args, **kw),
                **{f"P={P}": ell_aggregate(*args, panels=P, **kw) for P in (1, 2, 4)},
                "rows of more than 4 slots first": ell_aggregate(*args, ptr=kw["ptr"],
                                                                 long_rows=lr4),
                "offsets built on the device, rows in index order": ell_aggregate(*args)}
        torch.cuda.synchronize()
        same = {k: torch.equal(v, out) for k, v in same.items()}
        log(f"[5 ell_aggregate {label}] bit-identical to the first call: {same}")
        assert all(same.values())

    vq1 = tr.state.vq_states[1]
    nb, M, Kq = vq1.embedding.shape
    B_pad = b0.B_pad
    valid = b0.valid_B.contiguous()
    xn = torch.randn((nb, B_pad, Kq), generator=gen, device=dev)
    xn4 = torch.randn((nb, test_batches[0][0][0].B_pad, Kq // 2), generator=gen, device=dev)
    valid4 = test_batches[0][0][0].valid_B.contiguous()
    cases = [
        ("vq_update", xn, vq1.embedding.contiguous(), valid),
        ("feature_update", xn4, vq1.embedding[:, :, : Kq // 2].contiguous(), valid4),
        ("nb=1", xn[:1].contiguous(), vq1.embedding[:1].contiguous(), valid),
    ]
    def hold_assign(label, xx, emb, vv):
        """Kernel 2 against its plain version in both modes.  Exact: idx and
        counts equal.  Fast (tensor cores, their own summation order): idx
        may differ at near ties only (worst ratio <= 1 on < 1e-3 of the
        rows), counts and sums held at the kernel's own idx.  Sums: summation
        order only, each within 1e-5 of the sum of the |x| it adds up."""
        for fast in (False, True):
            idx, cnt, sums = fused_assign_branches(xx, emb, vv, fast=fast)
            idx_r, cnt_r, sums_r = fused_assign_branches_plain(xx, emb, vv, fast=fast)
            torch.cuda.synchronize()
            if fast:
                n_diff, worst = assign_mismatch(xx, emb, idx, idx_r, fast=True)
                rule = (f"rows whose idx differs {n_diff} of {idx.numel()}, worst ratio "
                        f"{worst:.4g} of the near-tie tolerance")
                ok_idx = worst <= 1.0 and n_diff < 1e-3 * idx.numel()
                _, cnt_r, sums_r = fused_assign_branches_plain(xx, emb, vv, fast=True, idx=idx)
            else:
                ok_idx = torch.equal(idx, idx_r)
                rule = f"idx equal {ok_idx}"
            _, _, abs_sums = fused_assign_branches_plain(xx.abs(), emb, vv, fast=fast, idx=idx)
            diff = (sums - sums_r).abs()
            ratio = float((diff / (1e-5 * abs_sums).clamp_min(1e-30)).max())
            log(f"[5 vq_assign {label} fast={fast}] xn {tuple(xx.shape)} M={emb.shape[1]} "
                f"{rule}; counts equal {torch.equal(cnt, cnt_r)} at "
                f"{'its own' if fast else 'the same'} idx; sums max|err| {float(diff.max()):.3g} "
                f"({ratio:.3f} of the 1e-5 * sum|x| tolerance)")
            assert ok_idx and torch.equal(cnt, cnt_r) and ratio <= 1.0
            err["vq_assign"] = max(err.get("vq_assign", 0.0), float(diff.max()))

    for label, xx, emb, vv in cases:
        hold_assign(label, xx, emb, vv)
    # no float atomics: two calls give the same bits in fast mode too
    first, second = (fused_assign_branches(xn, vq1.embedding.contiguous(), valid, fast=True)
                     for _ in range(2))
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[5 vq_assign vq_update fast=True] two calls bit-identical (idx, counts, sums): {same}")
    assert same

    def hold_lookup(label, vq, ids, D):
        """Kernel 3 bit-equal to its plain version (a gather), in both
        modes, as the [n, nb, K] table and split at D as the step calls it."""
        for fast in (False, True):
            for split in (None, D):
                out, ref = (fn(vq.c_indices, ids, vq.embedding_output, fast=fast, split=split)
                            for fn in (lookup_codewords, lookup_codewords_plain))
                outs, refs = ((out,), (ref,)) if split is None else (out, ref)
                torch.cuda.synchronize()
                same = all(torch.equal(o, r) for o, r in zip(outs, refs, strict=True))
                log(f"[5 vq_lookup {label} fast={fast} split={split}] out "
                    f"{[tuple(o.shape) for o in outs]} bit-equal {same}")
                assert same

    vq0 = tr.state.vq_states[0]
    hold_lookup("B + B'", vq0, b0.fo_ids, cfg.num_D)
    err["vq_lookup"] = 0.0

    # GAT kernels on the GAT batch's edges, random inputs at the real widths.
    # Tolerance: f32 sums in another order (exp of the same logits on both
    # sides), so 1e-5 relative to the largest |ref| of each output.
    ge = runs["3 GAT"]["batch0"].edges
    Rg = ge.num_rows

    def gat_inputs(width):
        return (torch.randn((Rg, width), generator=gen, device=dev),
                torch.randn(Rg, generator=gen, device=dev),  # al (already / scale)
                torch.randn(Rg, generator=gen, device=dev))  # ar

    def hold(label, name, outs, refs):
        torch.cuda.synchronize()
        for i, (o, r) in enumerate(zip(outs, refs)):
            if r is None:
                assert o is None
                continue
            d = float((o - r).abs().max())
            tol = 1e-5 * max(1.0, float(r.abs().max()))
            log(f"[5 {name} {label}] output {i} {tuple(o.shape)} max|err| {d:.3g} (tol {tol:.3g})")
            assert torch.isfinite(o).all() and d <= tol
            err[name] = max(err.get(name, 0.0), d)

    # kernel 4 at C = 128 and 256 (layer 1 of GAT hidden 256), with and
    # without the masked channels, with the batch's row offsets and long rows
    # (as the conv passes them) and without them; the same bits in two calls
    # and across the lists
    fwd_lists = dict(ptr=ge.ell_ptr, long_rows=ge.ell_long_rows)
    gat_fwd = {}
    for width in (C, 256):
        xw, alw, arw = gat_inputs(width)
        gat_fwd[width] = (xw, ge.ell_row, ge.ell_col, ge.ell_val, alw, arw, Rg)
        for with_neg in (True, False):
            ref = gat_aggregate_plain(*gat_fwd[width], with_neg=with_neg)
            outs = {lbl: gat_aggregate(*gat_fwd[width], with_neg=with_neg, **kw)
                    for lbl, kw in (("lists", fwd_lists), ("again", fwd_lists),
                                    ("offsets built on the device", {}))}
            for lbl in ("lists", "offsets built on the device"):
                hold(f"C={width} with_neg={with_neg} {lbl}", "gat_aggregate", outs[lbl], ref)
            same = {lbl: all(a is b or torch.equal(a, b) for a, b in zip(o, outs["lists"]))
                    for lbl, o in outs.items() if lbl != "lists"}
            log(f"[5 gat_aggregate C={width} with_neg={with_neg}] bit-identical to the first "
                f"call: {same}; {ge.ell_long_rows.shape[0] - 1} long rows")
            assert all(same.values())
    # kernel 5 at each call shape of the GAT step: dx_rows = 0 (layer 0),
    # b_rows (the later layers) and R (every row), with the batch's row
    # offsets and long rows over the whole transposed ELL, as the conv
    # passes them; the same bits in two calls
    assert 0 < ge.b_rows < Rg and ge.t_all_ptr is not None
    gat_dx_rows = (0, ge.b_rows, Rg)
    gat_lists = dict(ptr=ge.t_all_ptr, long_rows=ge.t_all_long_rows)
    gat_bwd = {}
    for width in (C, 256):
        xw, alw, arw = gat_inputs(width)
        g_agg = torch.randn((Rg, width), generator=gen, device=dev)
        g_rs = torch.randn(Rg, generator=gen, device=dev)
        gat_bwd[width] = (xw, ge.t_ell_row, ge.t_ell_col, ge.t_ell_val, g_agg, g_rs, alw, arw, Rg)
        for dxr in gat_dx_rows:
            out = gat_backward(*gat_bwd[width], dx_rows=dxr, **gat_lists)
            hold(f"C={width} dx_rows={dxr}", "gat_backward", out,
                 gat_backward_plain(*gat_bwd[width], dx_rows=dxr))
            again = gat_backward(*gat_bwd[width], dx_rows=dxr, **gat_lists)
            torch.cuda.synchronize()
            same = all(a is b or torch.equal(a, b) for a, b in zip(out, again))
            zero = out[0] is None or not out[0][dxr:].any()
            log(f"[5 gat_backward C={width} dx_rows={dxr}] bit-identical over two calls: {same}; "
                f"zeros above dx_rows: {zero}; {ge.t_all_long_rows.shape[0] - 1} long rows")
            assert same and zero

    # B + M GAT: the segment sum at the conv's widths (C = nb * D = 128 for
    # the aggregate and dx, nb = 32 for the normaliser and the logit
    # cotangents) over the batch's forward ELL and its transposed ELL, with
    # the batch's row offsets and long rows as the conv passes them, with and
    # without the scalar channel; tolerance as above (f32 sums in another
    # order).  The same bits over two calls, with the offsets alone and with
    # them built on the device
    bm = runs["3 GAT-bm"]
    tr_bm, bmb = bm["tr"], bm["batch0"]
    be = bmb.edges
    Rb = be.num_rows
    nb_bm = tr_bm.ms.num_branches[1]
    seg_layouts = {
        "forward": (be.ell_row, dict(ptr=be.ell_ptr, long_rows=be.ell_long_rows)),
        "transposed": (be.t_ell_row, dict(ptr=be.t_all_ptr, long_rows=be.t_all_long_rows)),
    }
    seg_args = {}
    for lay, (sg, lists) in seg_layouts.items():
        live = (sg < Rb).float()
        for width in (C, nb_bm):
            part = torch.randn((sg.shape[0], width), generator=gen, device=dev) * live[:, None]
            scal = torch.randn(sg.shape[0], generator=gen, device=dev) * live
            args = seg_args[lay, width] = (part, sg, Rb)
            out = segment_sum_sorted(*args, **lists)
            hold(f"{lay} C={width}", "segment_sum", (out,), (segment_sum_sorted_plain(*args),))
            hold(f"{lay} C={width} with the scalar channel", "segment_sum",
                 segment_sum_sorted(*args, scalar_partials=scal, **lists),
                 segment_sum_sorted_plain(*args, scalar_partials=scal))
            same = {"again": segment_sum_sorted(*args, **lists),
                    "offsets alone": segment_sum_sorted(*args, ptr=lists["ptr"]),
                    "offsets built on the device": segment_sum_sorted(*args)}
            torch.cuda.synchronize()
            same = {k: torch.equal(v, out) for k, v in same.items()}
            log(f"[5 segment_sum {lay} C={width}] bit-identical to the first call: {same}; "
                f"{lists['long_rows'].shape[0] - 1} long rows (more than "
                f"{int(lists['long_rows'][0])} slots)")
            assert all(same.values())

    # the recovery kernels at nb = 32, M = 1,024 over the batch's own reverse
    # list and layer 1's codes, with random O(1) xb, al, arcb and gbar (the
    # live gradient codebook is at gradient scale, so small that a wrong term
    # would hide under any absolute floor).  Each value to 1e-5 of the sum of
    # the |terms| it adds up (f32 sums in another order), that sum computed by
    # the plain version on |xb| and |gbar|, plus 1e-6 of the largest such sum
    vq_bm = tr_bm.state.vq_states[1]
    Dq = tr_bm.ms.num_D
    M_bm = vq_bm.embedding.shape[1]
    Bb = bmb.B_pad
    rev_in = dict(
        c_indices=vq_bm.c_indices, slot_col=bmb.rev_slot_col, slot_val=bmb.rev_slot_val,
        slot_row=bmb.rev_slot_row,
        xb=torch.randn((nb_bm, Bb, Dq + 1), generator=gen, device=dev),
        al=0.5 * torch.randn((nb_bm, Bb), generator=gen, device=dev),
        arcb=0.5 * torch.randn((nb_bm, M_bm), generator=gen, device=dev),
        gbar=torch.randn((nb_bm, M_bm, Dq + 1), generator=gen, device=dev),
    )
    # the kernels' inputs: the batch's row offsets and long rows, as the model
    # passes them, in place of slot_row (the plain version's)
    rev_k = {k: v for k, v in rev_in.items() if k != "slot_row"}
    rev_k.update(row_ptr=bmb.rev_row_ptr, long_rows=bmb.rev_long_rows)
    g_rev = torch.linspace(-1.0, 2.0, nb_bm, device=dev)

    def rev_plain(xb, al, arcb, gbar, g):
        leaves = [t.clone().requires_grad_(True) for t in (xb, al, arcb)]
        info = rev_recovery_info_plain(rev_in["c_indices"], rev_in["slot_col"],
                                       rev_in["slot_val"], rev_in["slot_row"], *leaves, gbar)
        return (info.detach(), *torch.autograd.grad((info * g).sum(), leaves))

    ref = rev_plain(rev_in["xb"], rev_in["al"], rev_in["arcb"], rev_in["gbar"], g_rev)
    absb = rev_plain(rev_in["xb"].abs(), rev_in["al"], rev_in["arcb"], rev_in["gbar"].abs(),
                     g_rev.abs())
    outs = (rev_forward(**rev_k), *rev_backward(**rev_k, g=g_rev))
    again = (rev_forward(**rev_k), *rev_backward(**rev_k, g=g_rev))
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(outs, again))
    log(f"[5 rev] info, d_xb, d_al, d_arcb bit-identical over two calls: {same_bits}; "
        f"{rev_k['long_rows'].shape[0] - 1} long rows (more than "
        f"{int(rev_k['long_rows'][0])} slots)")
    assert same_bits
    for i, (name, o, r, b) in enumerate(zip(("info", "d_xb", "d_al", "d_arcb"), outs, ref, absb)):
        d = (o - r).abs()
        tol = 1e-5 * b + 1e-6 * float(b.max())
        ratio = float((d / tol).max())
        log(f"[5 rev {name}] {tuple(o.shape)} max|err| {float(d.max()):.3g} max|ref| "
            f"{float(r.abs().max()):.3g} max sum|terms| {float(b.max()):.3g} ({ratio:.4g} of the "
            f"1e-5 * sum|terms| + 1e-6 * max sum|terms| tolerance); S_rev="
            f"{bmb.rev_slot_row.shape[0]} live cells {int((bmb.rev_slot_val != 0).sum())}")
        assert torch.isfinite(o).all() and ratio <= 1.0
        key = "rev_forward" if i == 0 else "rev_backward"
        err[key] = max(err.get(key, 0.0), float(d.max()))

    # kernels 2 and 3 at the B + M widths: K = 2 * D + 1 = 9, M = 1,024
    emb_bm = vq_bm.embedding.contiguous()
    Kb = emb_bm.shape[2]
    xn_bm = torch.randn((nb_bm, Bb, Kb), generator=gen, device=dev)
    valid_bm = bmb.valid_B.contiguous()
    hold_assign("B + M", xn_bm, emb_bm, valid_bm)
    hold_lookup("B + M", vq_bm, bmb.fo_ids, Dq)

    # ---- 6. times: kernel, plain version, library yardstick ----
    scratch = torch.empty(64 << 20, device=dev)  # 256 MB, 5x the L2
    flush = lambda: scratch.fill_(1.0)  # noqa: E731
    kern = {}
    for label, args, n_out in (("forward", fwd_args, R), ("dx", dx_args, e0.b_rows)):
        xx, row, col, val, _ = args
        kw = ell_kw[label]
        S_, K = col.shape
        nnz_ = live_cells(row, val, n_out)
        csr_ = csr_of(torch, row, col, val, n_out, R)
        t = {
            "ms": cuda_time_ms(torch, lambda: ell_aggregate(*args, **kw)),
            "plain_ms": cuda_time_ms(torch, lambda: ell_aggregate_plain(*args), reps=5),
            "library_ms": cuda_time_ms(torch, lambda: torch.sparse.mm(csr_, xx)),
        }
        # x, the slots it reads (rows, cols, values) and the output, once each
        b_ms, b_by = bound(R * C * 4 + S_ * 4 + 2 * S_ * K * 4 + n_out * C * 4, 2 * nnz_ * C,
                           F32_FLOPS)
        no_reuse = nnz_ * C * 4 / HBM_BYTES_PER_S * 1e3  # every gathered row from memory
        by_p = {P: cuda_time_ms(torch, lambda: ell_aggregate(*args, panels=P, **kw))
                for P in (1, 2, 4)}
        index_order = cuda_time_ms(torch, lambda: ell_aggregate(*args, ptr=kw["ptr"]))
        log(f"[6 ell_aggregate {label}] rows={n_out} slots={S_} nnz={nnz_}: {t} bound "
            f"{b_ms:.4f} ms ({b_by}); no-reuse line (live cells x C x 4 B at 3.35 TB/s) "
            f"{no_reuse:.4f} ms; by panel count (P = 1 is the default) {by_p}; without the "
            f"long-row list {index_order:.4f} ms | {gpu}")
        ell_l2_probes(torch, lambda *a: ell_aggregate(*a, **kw), xx, row, col, val, n_out,
                      flush, gpu, label)
        if label == "forward":
            kern["ell_aggregate"] = dict(
                source="vq_gnn_tpu_torch/csrc/ell_aggregate.cu",
                replaces="vq_gnn_tpu/ops/pallas_ell.py:111", **t, bound_ms=b_ms, bound_by=b_by)
    del scratch
    # why panel_width splits x above 128 channels: the forward at C = 256 in
    # one panel (each row group walks two 128-channel passes) and in two
    x256 = torch.randn((R, 256), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    by_p = {P: cuda_time_ms(torch, lambda: ell_aggregate(x256, *fwd_args[1:], panels=P,
                                                         **ell_kw["forward"]))
            for P in (1, 256 // panel_width(256))}
    log(f"[6 ell_aggregate forward C=256] by panel count (panel_width gives "
        f"{256 // panel_width(256)}) {by_p} | {gpu}")
    del x256

    emb1 = vq1.embedding.contiguous()

    def assign_times(label, xn_, emb_, valid=valid):
        """Logs kernel 2's fast and exact times on these inputs, against its
        plain version and the library sequence (TF32 baddbmm + argmin + 2 x
        index_add_); returns (fast times, bound, its kind)."""
        nb_, B_, K_ = xn_.shape
        M = emb_.shape[1]
        e2 = codeword_sqnorm(emb_)

        def library():
            d = torch.baddbmm(e2[:, None, :], xn_, emb_.transpose(1, 2), alpha=-2.0)
            idx = d.argmin(2)
            flat = (idx + torch.arange(nb_, device=dev)[:, None] * M).reshape(-1)
            v = valid.float().expand(nb_, B_).reshape(-1)
            cnt = torch.zeros(nb_ * M, device=dev).index_add_(0, flat, v)
            sums = torch.zeros((nb_ * M, K_), device=dev).index_add_(
                0, flat, (xn_ * valid.float()[None, :, None]).reshape(-1, K_))
            return idx, cnt, sums

        def fast():
            return fused_assign_branches(xn_, emb_, valid, fast=True)

        tt = {
            "ms": cuda_time_ms(torch, fast),
            "plain_ms": cuda_time_ms(
                torch, lambda: fused_assign_branches_plain(xn_, emb_, valid, fast=True), reps=5),
            "library_ms": cuda_time_ms(torch, library, reps=5),
        }
        ex = cuda_time_ms(torch, lambda: fused_assign_branches(xn_, emb_, valid, fast=False))
        graph_ms = graph_time_ms(torch, fast)
        byts = nb_ * B_ * K_ * 4 + nb_ * M * K_ * 4 + B_ + nb_ * B_ * 4 + nb_ * M * (K_ + 1) * 4
        b_f, by_f = bound(byts, 2 * nb_ * B_ * M * K_, BF16_FLOPS)
        b_x, by_x = bound(byts, 2 * nb_ * B_ * M * K_, F32_FLOPS)
        log(f"[6 vq_assign {label}] fast nb={nb_} B={B_} M={M} K={K_}: {tt}, device time in a "
            f"CUDA-graph replay {graph_ms:.4f} ms; bound {b_f:.4f} ms ({by_f}, bf16); exact "
            f"{ex:.4f} ms, bound {b_x:.4f} ms ({by_x}, f32) | {gpu}")
        return tt, b_f, by_f

    t, b_ms, b_by = assign_times("B + B'", xn, emb1)
    kern["vq_assign"] = dict(
        source="vq_gnn_tpu_torch/csrc/vq_assign.cu",
        replaces="vq_gnn_tpu/ops/pallas_vq.py:140", **t, bound_ms=b_ms, bound_by=b_by)
    # the single-branch TPU kernel (pallas_vq.py:33) is kernel 2 at nb = 1
    assign_times("nb=1 (replaces vq_gnn_tpu/ops/pallas_vq.py:33)", xn[:1].contiguous(),
                 emb1[:1].contiguous())

    def lookup_times(label, vq, ids, D):
        """Kernel 3 in fast mode as the step calls it (split at D), its plain
        version and the library yardstick the step ran before (advanced
        indexing and the two slices); the whole [n, nb, K] table beside it.
        Returns the split call's times and bound."""
        c_idx, eo = vq.c_indices, vq.embedding_output
        nb_, M_, K_ = eo.shape
        n_ = ids.shape[0]
        ar = torch.arange(nb_, device=dev)[None, :]

        def run(split=D):
            return lookup_codewords(c_idx, ids, eo, fast=True, split=split)

        def library(split=True):
            t = eo[ar, c_idx[ids].long()]
            return (t[:, :, :D].reshape(n_, -1), t[:, :, D:].reshape(n_, -1)) if split else t

        tt = {"ms": cuda_time_ms(torch, run),
              "plain_ms": cuda_time_ms(
                  torch, lambda: lookup_codewords_plain(c_idx, ids, eo, fast=True, split=D)),
              "library_ms": cuda_time_ms(torch, library)}
        whole = {"ms": cuda_time_ms(torch, lambda: run(None)),
                 "library_ms": cuda_time_ms(torch, lambda: library(False))}
        # node ids, one c_indices row per node and the table read once, the
        # n * nb * K output floats written once
        bb, bb_by = bound(n_ * 8 + n_ * nb_ * 2 + eo.numel() * 4 + n_ * nb_ * K_ * 4, 0,
                          F32_FLOPS)
        log(f"[6 vq_lookup {label}] fast n={n_} nb={nb_} M={M_} K={K_} split at D={D}: {tt} "
            f"bound {bb:.4f} ms ({bb_by}); device us per call {kernel_split(torch, run)}; the "
            f"whole [n, nb, K] table {whole}, device us per call "
            f"{kernel_split(torch, lambda: run(None))}; library_ms: advanced indexing (and the "
            f"two slices, split) | {gpu}")
        return dict(**tt, bound_ms=bb, bound_by=bb_by)

    kern["vq_lookup"] = dict(
        source="vq_gnn_tpu_torch/csrc/vq_lookup.cu", replaces="vq_gnn_tpu/ops/pallas_vq.py:276",
        **lookup_times("B + B'", vq0, b0.fo_ids, cfg.num_D))

    # GAT: no single PyTorch call computes an attention-weighted aggregate or
    # its transposed backward, so there is no library yardstick
    Sg, Kg = ge.ell_col.shape
    Stg = ge.t_ell_col.shape[0]
    nnz_g = int((ge.ell_val != 0).sum())
    nnz_gt = int((ge.t_ell_val != 0).sum())
    # the ELL's columns and values, and the row offsets and long rows the
    # kernel reads in place of its rows
    fell_bytes = 2 * Sg * Kg * 4 + (Rg + 1) * 4 + ge.ell_long_rows.numel() * 4
    fwd_t = {}
    for width, with_neg in ((C, True), (C, False), (256, True)):
        def run():
            return gat_aggregate(*gat_fwd[width], with_neg=with_neg, **fwd_lists)

        tt = {"ms": cuda_time_ms(torch, run), "plain_ms": None, "library_ms": None}
        if width == C and with_neg:
            tt["plain_ms"] = cuda_time_ms(
                torch, lambda: gat_aggregate_plain(*gat_fwd[width], with_neg=True), reps=5)
        # x, al, ar and the ELL in; agg, rowsum (and aggn, rsn) out; per live
        # cell one FMA over C for agg (and one for aggn)
        outs_n = 2 if with_neg else 1
        bb, bb_by = bound(Rg * width * 4 + 2 * Rg * 4 + fell_bytes
                          + outs_n * (Rg * width * 4 + Rg * 4), 2 * outs_n * nnz_g * width,
                          F32_FLOPS)
        fwd_t[width, with_neg] = dict(**tt, bound_ms=bb, bound_by=bb_by)
        log(f"[6 gat_aggregate] C={width} with_neg={with_neg} R={Rg} S={Sg} nnz={nnz_g}: {tt} "
            f"bound {bb:.4f} ms ({bb_by}); device us per call {kernel_split(torch, run)}; "
            f"gathered {nnz_g * width * 4 / 1e6:.1f} MB at "
            f"{nnz_g * width * 4 / tt['ms'] / 1e9:.3f} TB/s | {gpu}")
    no_lists = cuda_time_ms(torch, lambda: gat_aggregate(*gat_fwd[C], with_neg=True))
    log(f"[6 gat_aggregate] C={C} with_neg=True with the offsets built on the device and no "
        f"long-row list {no_lists:.4f} ms; library_ms null: no single PyTorch call computes "
        f"it | {gpu}")
    kern["gat_aggregate"] = dict(  # the conv's training call
        source="vq_gnn_tpu_torch/csrc/gat_aggregate.cu",
        replaces="vq_gnn_tpu/ops/pallas_ell.py:111", **fwd_t[C, True])
    tell_bytes = 2 * Stg * Kg * 4 + (Rg + 1) * 4 + ge.t_all_long_rows.numel() * 4
    t_live = (ge.t_ell_val != 0) & (ge.t_ell_row[:, None] < Rg)
    bwd_t = {}
    for width, args in gat_bwd.items():
        for dxr in gat_dx_rows:
            def run():
                return gat_backward(*args, dx_rows=dxr, **gat_lists)

            tt = {
                "ms": cuda_time_ms(torch, run),
                "plain_ms": cuda_time_ms(
                    torch, lambda: gat_backward_plain(*args, dx_rows=dxr), reps=5),
                "library_ms": None,
            }
            # x, g_agg, g_rowsum, al, ar and the ELL in, d_al and (with
            # dx_rows > 0) dx_agg out; per live cell a dot over C, and an FMA
            # over C where its row is < dx_rows
            nnz_dx = int((t_live & (ge.t_ell_row[:, None] < dxr)).sum())
            bb, bb_by = bound((2 + (dxr > 0)) * Rg * width * 4 + 4 * Rg * 4 + tell_bytes,
                              2 * (nnz_gt + nnz_dx) * width, F32_FLOPS)
            dev_us = kernel_split(torch, run)
            bwd_t[width, dxr] = dict(**tt, bound_ms=bb, bound_by=bb_by)
            log(f"[6 gat_backward] C={width} dx_rows={dxr} R={Rg} St={Stg} nnz={nnz_gt} "
                f"(rows < dx_rows: {nnz_dx}): {tt} bound {bb:.4f} ms ({bb_by}); device us per "
                f"call {dev_us}; library_ms null: no single PyTorch call computes it | {gpu}")
    kern["gat_backward"] = dict(  # every row, the call PERF.md row 3 has always timed
        source="vq_gnn_tpu_torch/csrc/gat_backward.cu",
        replaces="vq_gnn_tpu/ops/pallas_ell.py:342 and vq_gnn_tpu/ops/pallas_ell.py:273",
        **bwd_t[C, Rg])

    # B + M: the segment sum at each of its widths and layouts, as the conv
    # calls it (the batch's row offsets and long rows); library yardstick one
    # index_add_ into a kept [R + 1, C] buffer (int64 rows made beforehand)
    seg_t = {}
    for (lay, width), (part, sg, _) in seg_args.items():
        lists = seg_layouts[lay][1]
        Ss = sg.shape[0]
        buf = torch.zeros((Rb + 1, width), device=dev)
        sg64 = sg.long()
        scal = torch.randn(Ss, generator=gen, device=dev) * (sg < Rb).float()

        def run():
            return segment_sum_sorted(part, sg, Rb, **lists)

        tt = {
            "ms": cuda_time_ms(torch, run),
            "plain_ms": cuda_time_ms(torch, lambda: segment_sum_sorted_plain(part, sg, Rb)),
            "library_ms": cuda_time_ms(torch, lambda: buf.index_add_(0, sg64, part)),
        }
        built = cuda_time_ms(torch, lambda: segment_sum_sorted(part, sg, Rb))
        with_s = cuda_time_ms(torch, lambda: segment_sum_sorted(part, sg, Rb,
                                                                 scalar_partials=scal, **lists))
        # the live slots' rows (slots past ptr[R] are padding, never read),
        # the row offsets and long rows read once, out written once; one add
        # per value.  Beside it the bound over every slot and seg, as the
        # kernel that searched seg had it
        n_live = int(lists["ptr"][-1])
        bb_ms, bb_by = bound(n_live * width * 4 + (Rb + 1) * 4 + lists["long_rows"].numel() * 4
                             + Rb * width * 4, n_live * width, F32_FLOPS)
        b_all, _ = bound(Ss * width * 4 + Ss * 4 + Rb * width * 4, Ss * width, F32_FLOPS)
        seg_t[lay, width] = dict(**tt, bound_ms=bb_ms, bound_by=bb_by)
        log(f"[6 segment_sum {lay}] C={width} S={Ss} live slots ptr[R]={n_live} R={Rb}: {tt} "
            f"bound {bb_ms:.4f} ms ({bb_by}, live slots; over all S slots and seg "
            f"{b_all:.4f}); device us per call {kernel_split(torch, run)}; with the offsets "
            f"built on the device {built:.4f} ms; with the scalar channel {with_s:.4f} ms "
            f"| {gpu}")
    kern["segment_sum"] = dict(source="vq_gnn_tpu_torch/csrc/segment_sum.cu",
                               replaces="vq_gnn_tpu/ops/pallas_segsum.py:107",
                               **seg_t["forward", C])

    # the recovery kernels; no PyTorch call computes the per-(row, codeword)
    # coalesce + relu + attention contraction, so no library yardstick.  The
    # least traffic: the slots, the row offsets and long rows, the c_indices
    # rows of the distinct neighbours, xb, al, arcb, gbar (and g) read once,
    # the outputs written once
    val_nz = rev_in["slot_val"] != 0
    cells = int(val_nz.sum())
    nbrs = int(torch.unique(rev_in["slot_col"][val_nz]).numel())
    S_rev, K_rev = rev_in["slot_col"].shape
    Dg = Dq + 1
    in_bytes = (S_rev * K_rev * 8 + (Bb + 1) * 4 + rev_k["long_rows"].numel() * 4
                + nbrs * nb_bm * 2 + nb_bm * Bb * (Dg + 1) * 4 + nb_bm * M_bm * (Dg + 1) * 4)
    # per live cell and branch: a merge add, and per distinct (row, codeword)
    # at most the attention (~10 flops) and the Dg-wide dot
    fwd_ops = nb_bm * cells * (2 * Dg + 11)
    for name, fn, plain, out_bytes, ops_n in (
        ("rev_forward", lambda: rev_forward(**rev_k),
         lambda: rev_recovery_info_plain(**rev_in), nb_bm * 4, fwd_ops),
        ("rev_backward", lambda: rev_backward(**rev_k, g=g_rev),
         lambda: rev_plain(rev_in["xb"], rev_in["al"], rev_in["arcb"], rev_in["gbar"], g_rev),
         nb_bm * 4 + nb_bm * Bb * (Dg + 1) * 4 + nb_bm * M_bm * 4, 2 * fwd_ops),
    ):
        tt = {"ms": cuda_time_ms(torch, fn), "plain_ms": cuda_time_ms(torch, plain, reps=3),
              "library_ms": None}
        bb_ms, bb_by = bound(in_bytes + out_bytes, ops_n, F32_FLOPS)
        kern[name] = dict(source="vq_gnn_tpu_torch/csrc/rev_recovery.cu",
                          replaces=("vq_gnn_tpu/ops/pallas_rev.py:280" if name == "rev_forward"
                                    else "vq_gnn_tpu/ops/pallas_rev.py:311"),
                          **tt, bound_ms=bb_ms, bound_by=bb_by)
        names = {"rev_rows": "row pass", "codeword_pass": "codeword pass",
                 "pack_table": "table pack", "sum_rows": "row sums", "reduce_chunks": "chunk sums"}
        split = {next((v for k_, v in names.items() if k_ in k), k): us
                 for k, us in kernel_split(torch, fn).items()}
        log(f"[6 {name}] nb={nb_bm} B_pad={Bb} M={M_bm} Dg={Dg} S_rev={S_rev} cells={cells} "
            f"distinct neighbours={nbrs}: {tt} bound {bb_ms:.4f} ms ({bb_by}); device us per "
            f"call {split}; library_ms null: no PyTorch call computes the coalesced "
            f"relu-attention contraction | {gpu}")

    # kernels 2 and 3 at the B + M widths (PERF.md rows 6-7)
    assign_times("B + M", xn_bm, emb_bm, valid_bm)
    lookup_times("B + M", vq_bm, bmb.fo_ids, Dq)

    # ---- 7. small graph: GPU kernels vs CPU plain versions from one state ----
    for conv, form in (("GCN", "bbprime"), ("SAGE", "bbprime"), ("GAT", "bbprime"),
                       ("GCN", "bm"), ("SAGE", "bm"), ("GAT", "bm")):
        t0 = time.time()
        res = {device: small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv, form,
                                       device) for device in ("cuda", "cpu")}
        rg, rc = res["cuda"], res["cpu"]
        pg, pc = rg["pred"], rc["pred"]
        agree = float((pg.argmax(1) == pc.argmax(1)).mean())
        dl = max(abs(a - b) / abs(b) for a, b in zip(rg["losses"], rc["losses"]))
        # codeword assignments (all layers) that differ between the two runs
        # after the init sweep (entry 0) and after each step
        flips = [sum(int((a != b).sum()) for a, b in zip(cg, cc))
                 for cg, cc in zip(rg["codes"], rc["codes"])]
        # f32 sums in another order can flip a near-tied codeword argmin; from
        # then on the runs take different paths.  Until then they are one
        # state up to round-off: each step's loss_cls and info_backward apart
        # (the B + M loss is their sum, and they nearly cancel), each to 1e-4
        # of the largest |value| it takes over the run
        same = next((i for i, f in enumerate(flips) if f), len(flips) - 1)  # steps from one state
        dq = {}
        for i, q in enumerate(("loss_cls", "info_backward")):
            a = [s[i] for s in rg["steps"]]
            b = [s[i] for s in rc["steps"]]
            scale = max(abs(v) for v in b)
            dq[q] = max(abs(x - y) for x, y in zip(a[:same], b[:same])) / scale
            log(f"[7 small graph {conv} {form}] {q} per step cuda {a} cpu {b} (max diff over "
                f"the first {same} steps / max|value| {dq[q]:.2e})")
        log(f"[7 small graph {conv} {form}] codeword assignments that differ, cuda vs cpu, of "
            f"{sum(a.numel() for a in rc['codes'][0])}: after the init sweep {flips[0]}, after "
            f"each step {flips[1:]}")
        log(f"[7 small graph {conv} {form}] epoch losses cuda {rg['losses']} cpu {rc['losses']} "
            f"(max rel diff {dl:.2e}); logits max|diff| {float(abs(pg - pc).max()):.3g}, argmax "
            f"agreement {agree:.4f} in {time.time() - t0:.1f}s")
        assert same >= 3 and max(dq.values()) < 1e-4 and agree >= 0.99
        if form == "bbprime":  # four steps: they end before flips spread
            assert dl < 1e-3

    # ---- 8. the bench (bench_torch.py) on phase 2's GCN graph ----
    cfg_b = bench_torch.bench_config({})
    # the bench sets walk_length 3, which the cluster sampler does not read
    assert cfg_b == flagship_cfg(Config, walk_length=3), "the bench's cell is not phase 3's GCN"
    bench_lines = []

    def bench_log(*a):
        bench_lines.append(" ".join(str(v) for v in a))
        log(f"[8 bench] {bench_lines[-1]}")

    t0 = time.time()
    rec = bench_torch.run_bench(cfg_b, *graphs["GCN"], device="cuda", gpu=gpu, log=bench_log)
    log(f"[8 bench] {bench_torch.record_line(rec['eps'])} in {time.time() - t0:.1f}s")
    assert all(math.isfinite(rec[k]) for k in ("eps", "loss", "eval_fwd_ms")) and rec["eps"] > 0
    E3 = runs["3 GCN"]["E_first"]
    assert rec["E_batch"] == E3, f"bench batch E={rec['E_batch']}, phase 3's first batch E={E3}"
    assert any(ln.startswith("peak device memory: allocated") for ln in bench_lines)

    # ---- 9. the CLI (main_node_torch.py), in-process on the card ----
    t0 = time.time()
    cli = main_node_torch.main(CLI_ARGS + ["--device", "0"])
    final_test = cli.logger.results[0][-1][2]
    stats = cli.logger.statistics()
    log(f"[9 cli] {' '.join(CLI_ARGS)}: test acc by epoch "
        f"{[round(r[2], 4) for r in cli.logger.results[0]]}; statistics {stats} in "
        f"{time.time() - t0:.1f}s")
    assert stats and final_test >= 0.9, (final_test, stats)

    out = []
    for name in ops.KERNELS:
        k = kern[name]
        out.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launches[name], "max_abs_err": err[name], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(f"total {time.time() - t_all:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
