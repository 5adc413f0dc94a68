#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vq_gnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc.  Phases:

1. build the seven CUDA kernel libraries from ``vq_gnn_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, all at once);
2. build the bench's arxiv-scale synthetic graph (N = 169,343, degree 13.7,
   128 features, 40 classes) and its 80-part partition, normalised once per
   conv (GCN, SAGE and GAT normalise differently) and once with the v1
   normalisation for the B + M GAT path, for phase 13's B + M GCN path and
   for phase 17's B + M SAGE path;
3. drive the training paths through the trainer, one after the other, each
   with the launch counters zeroed just before it and read just after —
   3 layers x 128, num_D = 4, live VQ updates, f32, vq_backend =
   'pallas_fast':
   - GCN B + B' (M = 256, ELL K = 8, 40 of 80 parts per batch): layerwise
     init sweep, one epoch of ``train_step``, ten more timed steps and three
     profiled ones on the epoch's own batches, one step twice from the
     state they leave (the same bits: no float atomics on the path), one
     ``evaluate``;
   - SAGE: init sweep, one epoch, three timed steps, one step twice from
     one state (the same bits);
   - GAT: as GCN;
   - GAT with hidden 256 and 2 layers (layer 1 runs the GAT kernels at
     C = 256): init sweep, one epoch, two more steps;
   - GAT B + M (``bench.py`` with VQ_GNN_BENCH_FORM=bm, K = 2, f32: M =
     1,024, cont sampler of 10,000 nodes, walk length 3, recovery on):
     as GCN;
   - under bf16 compute (``compute_dtype='bfloat16'``, the bench's default
     for GAT): GAT B + B' and GAT B + M as their f32 runs, GCN B + B'
     (the bf16-row mode of kernel 1) with an init sweep, one epoch and three
     timed steps, and GAT with hidden 256 as its f32 run (kernel 5's bf16
     mode at C = 256);
   - under f16 compute (``compute_dtype='float16'``) with the codebooks
     frozen after the init sweep (``vq_update_mode='reference'``: live
     updates overflow f16 from the second step, as in the JAX package):
     GCN B + B' (kernel 1's f16-row mode), GAT B + B' (kernels 4 and 5)
     and GAT with hidden 256 (kernel 5's f16 mode at C = 256), each an init
     sweep, one epoch and three timed steps, every loss finite;
   each profile also counts the copy kernels and checks, on the B + M
   paths, that no row offsets were built on the device;
4. check that each path launched each of its kernels, that the bf16
   paths launched the bf16-row modes of kernels 1, 4 and 5 and never their
   f32 modes, the f16 paths their f16-row modes and never their f32 or
   bf16 modes, and that the three GAT hidden-256 paths ran kernel 5 at C =
   256 in their own dtype (phase 10's runs are checked the same way, each B + M
   GAT run launching the recovery kernels in its own fold only);
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
   offsets and long rows, in both folds (f32, and bf16 against the plain
   'fast' fold), and bit-identical run to run; the bf16-row and the
   f16-row modes of kernels 1, 4 and 5 on the same batches with 16-bit x,
   cotangents, ar and g_rowsum, against their plain versions on the same
   16-bit values, and bit-identical run to run);
6. time each kernel, its plain version and a PyTorch library yardstick where
   one call computes the same function (kernel 1 also at 2 and 4 panels,
   without the long-row list, on narrower copies of x and with x's rows
   relabelled at random, beside the no-reuse line, and at C = 256 in one
   panel and in panel_width's; kernel 2 also as the device time of a
   CUDA-graph replay, free of the host's launch gaps; the recovery kernels
   also split by device kernel: table pack, row pass, codeword pass and
   reductions, from ``torch.profiler``, the bf16 fold beside the f32 one; kernel 4 at C = 128 with and without
   the masked channels and at C = 256, with its device time and the rate of
   its gathered bytes; kernel 5 at each call shape of the GAT step, with its
   device time; kernel 3 split as the step calls it, against advanced
   indexing and the two slices the step ran before, and whole, with device
   times; the segment sum at each width and layout of the B + M conv, with
   device time and its bound over the live slots beside the one over every
   slot; each bf16-row and f16-row mode beside its f32 mode at the same
   shapes, with device times and its bound at 2 bytes a value);
7. run a small graph through the same paths (GCN, SAGE, GAT, and B + M GCN,
   SAGE and GAT, and GAT at bf16) on the GPU and on the CPU (plain versions)
   from one state, two epochs (B + M one, of nine steps; the f32 runs'
   CPU halves in two processes of their own beside phase 10, and compared
   after it),
   count the codeword assignments that come to differ, and compare each
   step's loss terms up to the first such difference, and the predictions;
   at bf16 also the GPU's own init sweep against the CPU's, layer by layer;
8. run the bench's timing function (``bench_torch.run_bench``) on phase 2's
   GCN graph with the bench's default configuration: its batch must be the
   first batch phase 3's GCN epoch trains on, and its record (edges/s,
   loss, peak memory, device busy, eval forward) finite and printed; then
   the bench's f16 cell (``VQ_GNN_BENCH_DTYPE=float16``, live VQ) once:
   the step at which its loss first goes nonfinite, if one does, logged,
   and kernel 1's f16-row mode, and no other mode of rows 1-4, launched;
9. run the CLI (``main_node_torch.main``) in-process on the card with its
   verification command (``main_node.py``'s quick check, ``CLI_ARGS``): 3
   epochs on a 500-node SBM must reach test accuracy 0.9;
10. accuracy, through the parity harness (``train/parity.py``), each run
   with the launch counters zeroed just before it and read just after:
   a. the suite of ``tests/test_parity_convergence.py`` (GCN and GAT on the
      cluster sampler and SAGE on cont against the exact full-graph control,
      B + M GCN against the exact mini-batch control), held to that test's
      bounds;
   b. ``parity_gap`` of the flagship GCN B + B' (3 x 128, M = 256, cluster
      sampler) as ``tools/parity_experiment_torch.py`` runs it by default,
      uncut: the arxiv generator's SBM (169,343 nodes, 128 features, 48 of
      them informative, noise 4.0, 40 classes, degree 13.7, seed 7),
      ``EPOCHS_10B`` epochs (the tool's default is 60), evaluated every 5;
      then the exact arm's full-graph forward (the COO layout through
      kernel 8) against its batched prediction, and
      kernel 8 at that shape (one layer's messages over the whole graph)
      against its plain sum in float64, bit-identical run to run;
   c. the B + M GAT VQ arm at the reference widths (M = 1,024, batch 10,000,
      K = 2) on 10a's graph, with the recovery term folded in f32 (x2) and in
      bf16 (``VQ_GNN_REV_FOLD=fast``), each fold launching its own mode;
11. link prediction at the collab widths (``tools/link_experiment_torch.py``,
   uncut): the latent dot-product graph of N = 235,868, 128 features,
   degree 10.9, with its OGB-style split (valid and test positives held out
   of the training adjacency, 100,000 random negatives per evaluation
   split), through ``LinkTrainer``: GCN B + B', 3 x 128, num_D = 4, M =
   1,024, cont sampler (batch 50,000, walk length 15), test batch 80,000,
   'auto' VQ (the fast CUDA kernels), TF32; the init sweep, one epoch, five
   timed steps on the epoch's first windows, ``evaluate_hits(50)``, one
   step twice from one state
   (the same bits: the pair gathers' gradient is summed by kernel 8, which
   must launch), and a sha256 of the state phase 17 starts from; then
   kernels 1 (forward and dx at C = 128), 2 (the step's nb = 32, M = 1,024,
   and the init sweep's feature half, K = 4) and 3 (M = 1,024) against
   their plain versions at the path's shapes, and timed;
12. inductive multilabel training at the ppi widths
   (``tools/inductive_experiment_torch.py``, uncut): three SBM graphs of
   44,906 / 6,514 / 5,524 nodes, 50 features, 121 labels, degree 28, one
   feature-to-label map, through ``NodeTrainer(val_graph=, test_graph=)``:
   GCN B + B', 3 x 256 (nb = 64 branches a hidden layer), M = 4,096, node
   sampler of 30,000, BCE; the init sweep, one epoch, five timed steps,
   ``evaluate()`` (micro-F1 on each split graph as one full batch), one
   step twice from one state (the same bits), then
   ``evaluate_split_stochastic`` on the validation graph at batch 3,000
   (``eval_assign_step``: kernel 2 on the feature half, K = 4, kernel 3
   over the split's own table); then kernels 1 (forward at C = 52 and 256,
   dx at 256), 2 (nb = 13 and 64, M = 4,096, at K = 8 on the training batch
   and K = 4 on the evaluation batch; the plain version a few branches at a
   time, as its distances would take 34 GB whole) and 3 (M = 4,096) against
   their plain versions at the path's shapes, and timed.
   Each of phases 11-12 zeroes the launch counters just before its path and
   reads them after, checks that kernels 1, 2 and 3 ran, and logs the batch
   shapes, ms/step, edges/s, the path's peak device memory and its seconds;
13. the model options through the trainer on phase 2's graphs, each path
   with the launch counters zeroed just before it and read just after, its
   ms/step, edges/s, row 6's device time per step and its peak device
   memory logged:
   a. GCN B + M at the bench's cell (M = 1,024, cont 10,000, walk 3, ELL K
      = 8) without and with ``transformer_flag`` (a second codebook per
      layer, K = 9): init sweep, one epoch, five timed steps, a profile (and
      ``evaluate`` with the transformer); row 6 runs 3 and 6 times a step,
      rows 1 and 7 run, and every transformer codebook moves; then row 6 at
      the transformer codebook's shape on its batch against its plain
      version, and timed;
   b. GAT B + M (K = 2) at bf16 compute with the transformer and
      ``dropbranch=0.5``, as 13a (rows 6-10; row 6 six times a step),
      beside phase 3's GAT B + M bf16;
   c. the flagship GCN B + B' with ``dropbranch=0.5`` and alpha dropout
      0.5: init sweep, one epoch, five timed steps, beside phase 3's GCN;
      then one step with masks drawn on the card: each layer keeps exactly
      nb / 2 branches, a dropped branch's codebook, EMA accumulators, BN
      statistics and ``c_indices`` column stay bit-identical, every kept
      branch's codebook moves;
   d. a 3,000-node graph through the B + M GAT path with all three options
      on the card and on the CPU (plain versions) from one state and one
      set of masks: one forward + loss and its gradients, then one
      ``train_step``; each to 1e-4 of max(1, max|cpu|), the assignments
      after the step to >= 99 %, the dropped branches unchanged on both.

14. the adjacency layouts through the trainer on phase 2's graphs, each
   path with the launch counters zeroed just before it and read just after,
   an init sweep, one epoch and five timed steps, its ms/step, edges/s,
   device busy ms per step, idle share and peak device memory logged:
   a. the flagship GCN B + B' on the mixed-K slot-ELL (``ell_Kt=2``: K = 8
      + 2), row 1 once per family forward and dx; from the state after the
      init sweep, the first step's loss within 1e-5 relative of the same
      step on the single-K layout; then row 1 on each family (head and tail,
      forward and the truncated dx) against its plain version at the
      batch's shapes, and the mixed forward timed;
   b. GAT B + B' at bf16 on the mixed-K layout: row 8 with its scalar
      channel per family (no GAT kernel), the first step against single-K
      as 14a; then row 8's scalar channel against its plain version on each
      forward and transposed family, and the forward pair timed;
   c. the flagship GCN B + B' on COO: row 8 forward and transposed, the
      first step against single-K as 14a;
   d. GAT B + M f32 at the bench's cell (M = 1,024, cont 10,000, walk 3)
      on COO: the per-branch fallback (row 8 over all branches at once) and
      the recovery term's grid path (plain PyTorch, as XLA's in JAX);
   e. a 3,000-node graph through GCN and GAT on the mixed layout, GCN on
      COO and GAT B + M on COO, on the card and on the CPU from one state:
      the loss and every gradient within 1e-6 of max(1, max|cpu|), the
      assignments after one step >= 99 % equal.

15. data-parallel training (``parallel/multihost.py``) on an NCCL process
   group of one rank (the card's machine has one GPU), the flagship GCN B +
   B' on phase 2's graph, from the state of phase 3's GCN trainer; fixed
   pads at that trainer's high-water buckets, one epoch of batches built
   at the fixed pads and one of the same node sets in the trainer's
   buckets:
   a. one step of the data-parallel step and one of ``train_step`` from one
      state on the same fixed-pad batch: the loss within 1e-6 relative, the
      codebooks and the parameters bit-identical, ``c_indices[:N]``
      agreeing on >= 0.9999 (row N is the padding dustbin);
   a'. rows 1, 6 and 7 against their plain versions at the fixed pads'
      shapes: kernel 1's forward over the padded slots and its dx over the
      whole transposed ELL (fixed pads keep no truncation), kernel 2 and
      kernel 3 at the fixed B_pad;
   b. 20 timed steps and 3 profiled ones each of ``train_step`` on the
      bucketed batches, ``train_step`` on the fixed-pad batches and the
      data-parallel step on them, from copies of one state: ms/step, device
      busy, idle share and peak memory, so that the fixed pads' cost and the
      collectives' are told apart; the launch counters zeroed just before
      the data-parallel steps and read just after;
   c. rows 1, 6 and 7 launched on that path, by the counters and by the
      profile's device kernels;
   d. the collective ledger: bytes and calls per step by category, and no
      collective as large as the feature table, a ``c_indices`` table or
      the batch's ELL columns.

16. the upkeep modules, each run with the launch counters zeroed just before
   it and read just after:
   a. node checkpoints at the flagship widths on phase 2's GCN graph: a
      trainer fits 2 epochs with ``ckpt_dir`` (a temporary directory) and
      ``ckpt_every=1``; the archive restores into a fresh trainer with every
      leaf bit-identical to the first trainer's state, and its evaluation
      equals the first trainer's; that trainer's ``fit(resume=True)`` goes
      on at epoch 3 through rows 1, 6 and 7; the archive restores into a
      CPU trainer bit-identical too; its size and the seconds to save and
      to restore are logged;
   b. link checkpoints on a 3,000-node dot-product graph (the collab
      configuration cut as ``tools/link_experiment_torch.py`` cuts it): 2
      epochs with a checkpoint, then a fresh trainer resumes to 3; the
      state, the predictor and its ``nu`` restore bit-identical and the
      final Hits@50 are finite;
   c. ``vq_backend='scan'``: one step each under 'scan', 'xla' and 'pallas'
      (exact) from one state on phase 3's first GCN batch, the assignments
      agreeing on >= 0.9999 and the peak memory of each logged, 'scan''s
      below 'xla''s; then the init sweep, one epoch and five timed steps
      under 'scan' beside phase 3's 'pallas_fast', rows 1 and 7 launched
      and row 6 not;
   d. ``kmeans_init``: where scikit-learn cannot be imported, ``fit``
      raises the ImportError that names it; where it can, ``seed_kmeans``
      on the flagship trainer, each layer's feature half equal to its
      centroids (``ema_w / ema_cluster_size``), rows 1 and 7 launched.

17. one batch sharded over two ranks (``parallel/mesh.py``,
   ``parallel/sharded.py``): two processes on the one card, a gloo group
   (the card's machine has one GPU, and NCCL takes one rank a device; gloo
   carries CUDA tensors through host memory; a probe logs whether it takes
   bf16 tensors and an all-reduce MAX), two families from the states of
   phase 3's trainers, each on phase 2's graph normalised for it, at its
   trainer's high-water pads (phase 15's fixed pads for GCN), one epoch of
   two batches: the flagship GCN B + B' and GAT B + B' on the single-K
   slot-ELL, and phase 14's layouts: GCN on the mixed-K layout (14a) and
   on COO (14c) and GAT on COO, in exact f32, and GAT on the mixed-K layout
   at bf16 compute (14b); and B + M on the epoch's first batch: GAT from
   phase 3's B + M GAT states, in exact f32 and at bf16 compute (trained
   codebooks: the recovery term reads a gradient table that is not zero),
   and SAGE (the bench's B + M cell at ELL K = 8, zero attention) from a
   trainer's init sweep and three whole-batch steps on phase 2's graph in
   SAGE's v1 normalisation; GCN B + M with the transformer from phase 13a's
   trainer (the bench's B + M cell at ELL K = 8; its codebooks and the
   transformer's trained, so that both recovery terms are not zero) and
   B + M GAT on COO from phase 14d's, each in exact f32; and the link and
   multilabel batches, each on the first batch its phase built, in exact
   f32: ``GCN-link``, phase 11's trainer at the collab widths through the
   sharded link step (every rank's output rows gathered, its block of the
   in-batch pairs and of the negatives, the same negatives on both sides
   of the compare), and ``GCN-ppi``, phase 12's at the ppi widths through
   the sharded step with ``multilabel=True``, on the 1-D mesh only (its
   input's 52 features make 13 branches at layer 0, which the 2-D 1 x 2
   mesh cannot split: there its refusal by name is checked); and
   ``GCN-f16``, phase 3's GCN-f16 trainer (f16 compute, the codebooks
   frozen after its init sweep) on its epoch's first batch at the
   flagship's settings.  The parent frees
   its cached blocks after the whole-batch references (the transformer's
   step peaks there) and logs what it holds as the ranks start.  For each
   mesh and each family, the launch
   counters zeroed just before its steps and read just after, in each
   rank:
   a. one step of the 1-D sharded step and one of ``train_step`` on the
      whole batch from one state: GCN in exact f32 (TF32 off, row 6's exact
      mode) with the inter-layer BN and without, at the flagship's own
      settings (TF32, row 6's fast mode) and at bf16 compute; GAT in exact
      f32 and at bf16 compute (the bench's GAT cell); each layout family
      and each B + M, link and multilabel family in its one configuration
      (the link step against ``link_train_step``, the multilabel one
      against the trainer's BCE ``train_step``, GCN-f16 at f16): the loss
      within 1e-5 relative, the parameters (the link predictor's too) within 1e-2
      (1e-4 without the BN),
      ``c_indices[:N]`` agreeing on >= 0.9999, in exact f32 the codebooks
      within 2e-5 but for the codewords of the assignments that differ (at
      the flagship's settings their difference is logged: ``compare_step``
      says why); both ranks' states one sha256; with the transformer the
      codebooks' gradient halves are held on the same step once more, on
      both sides, with c_max's gradient cut (``cmax_cut``), and the ranks'
      parts of c_max's cotangent summed within 1e-5 of the whole batch's;
      the first configuration of the flagship GCN, GAT on COO, B + M GAT on
      COO and the link step runs its step twice from one state on the 1-D
      mesh (the link step on both meshes): the same bits on each rank;
   b. the family's kernels launched on each rank, and logged a step (both
      modes together): rows 1, 6 and 7 (GCN), rows 2, 3, 6 and 7 (GAT);
      against their plain versions at each rank's shard shapes: row 1's
      forward over its rows' slots and dx over its batch columns'
      transposed slots, row 6 at its batch rows and row 7 at its boundary
      rows; rows 2 and 3 in the f32 and bf16 modes as the sharded GAT conv
      calls them, row 2 over its rows' slots from the gathered x with ar of
      its rows, row 3 over the transposed slots of every row it owns from
      the gathered cotangents and ar; on the other layouts row 1 once per
      mixed family (GCN) and no row 2, row 8 with its scalar channel per
      mixed family (GAT) and no row 1, 2 or 3, row 8 over the COO edges
      (GCN, GAT) and no row 1, 2 or 3, each held at the shard's shapes: the
      mixed families' forward over the owned rows (the head over its
      compact rows) and dx over the batch columns, or the COO forward over
      the owned rows' edges and the transposed sum over the batch columns'
      edges; B + M GAT: row 8 (no row 1, 2 or 3) over the owned rows'
      forward slots and the owned columns' transposed slots at the conv's
      widths (nb * D and nb), rows 9 and 10 over the rank's own reverse
      cells in both folds (as phase 5 holds the whole batch), rows 6 and 7;
      B + M SAGE: row 1 (no row 2, 3 or 8), rows 9, 10, 6 and 7; GCN with
      the transformer: rows 1, 6 and 7 (no row 2, 3, 8, 9 or 10), row 6
      six times a step on each rank (three layers' codebooks and three of
      the transformer's), and held at the transformer codebook's shape
      too; B + M GAT on COO: row 8 (no row 1, 2, 3, 9 or 10: its recovery
      term is the grid path) over the owned rows' edges and the batch
      columns' transposed edges at nb (D + 1), rows 6 and 7; the link and
      multilabel families: rows 1, 6 and 7 as GCN's, row 6 at nb = 64, M =
      4,096 on ``GCN-ppi`` (phase 12's row); GCN-f16: row 1's f16-row mode
      (no other mode of rows 1-4) and row 7 launched, no row 6 (the
      codebooks are frozen), rows 1 (f16), 6 and 7 held at the shard's
      shapes;
   c. the same step checks of the 2-D step at 1 x 2 (each rank half the
      branches and the fan-in columns, on B + M GAT half the heads), rows
      1, 2, 3 and 8 at C = 64 and rows 6, 9 and 10 at nb = 16 against
      their plain versions;
   d. timed steps and one profiled one (2 each of the flagship GCN and of
      GCN and GAT at bf16 compute, 1 of each layout, B + M, link,
      multilabel and f16 family: on one card over gloo they time gloo's
      host copies; the link steps draw their negatives from a
      generator seeded alike on both ranks) of each sharded step: ms/step,
      device busy and idle share of rank 0, each rank's peak memory, the
      collective ledger of each rank by category (on the transformer's, the
      COO GAT's, the link and the multilabel paths the rows, ``logits``,
      ``transformer`` and ``link`` bytes to the byte of ``ledger_formula``:
      the link step's [B_pad, C_out] f32 each way), the row exchanges of
      the bf16 steps at bf16 and of the f16 steps at f16, and no payload as large as the family's
      feature table (but, on ppi, the rows, which the formula holds: that
      batch holds most of its graph, 50 features wide, and the exchange
      carries it 256 wide; and the codebooks' EMA sums, [nb, M] and [nb, M,
      K] at M = 4,096), nor one shaped like a ``c_indices`` table, an edge
      array, the link pairs or the B + M reverse list (at these widths the batch
      holds half the graph's nodes, so the exchanged rows outweigh a
      ``c_indices`` table: the sizes are logged).

Logs the seconds each phase took.  Prints the card's name and power limit, a
``{"kernels": [...]}`` line (with rows for kernel 2 at nb = 64, M = 4,096
and at K = 4, M = 4,096, and kernel 3 at M = 4,096, from phase 12, and
kernel 2 at the transformer codebook's shape, K = 9, from phase 13, and
kernel 1 on 14a's mixed families and kernel 8's scalar channel on 14b's,
from phase 14) and, as
the last line, ``{"ok": true, "device": {...}}``.  Any failed phase raises
and the script exits non-zero without that line.  Without a CUDA device, or
without the package beside it, it exits non-zero at once.
"""

import contextlib
import copy
import dataclasses
import itertools
import json
import math
import os
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
    # bf16 compute: rows 1-4 in their bf16-row modes; the B + M GAT conv is
    # glue around kernel 8, whose partials stay f32 (vq_gnn_tpu/ops/gat.py:747)
    "GCN-bf16": ("ell_aggregate_bf16", "vq_assign", "vq_lookup"),
    "GAT-bf16": ("gat_aggregate_bf16", "gat_backward_bf16", "vq_assign", "vq_lookup"),
    "GAT-bm-bf16": ("segment_sum", "rev_forward", "rev_backward", "vq_assign", "vq_lookup"),
    # f16 compute: rows 1-4 in their f16-row modes
    "GCN-f16": ("ell_aggregate_f16", "vq_assign", "vq_lookup"),
    "GAT-f16": ("gat_aggregate_f16", "gat_backward_f16", "vq_assign", "vq_lookup"),
}
# kernels a bf16 path must not launch: the f32 modes of rows 1-4 (no cast of
# the bf16 rows to f32 ahead of an f32 kernel)
BF16_PATH_NOT = ("ell_aggregate", "gat_aggregate", "gat_backward")
# ... and an f16 path: the f32 and the bf16 modes of rows 1-4
F16_PATH_NOT = BF16_PATH_NOT + ("ell_aggregate_bf16", "gat_aggregate_bf16", "gat_backward_bf16")
# the f16 paths freeze the codebooks after the init sweep: live updates
# take their feature half past f16's range (in the JAX package too)
F16_PATH = dict(compute_dtype="float16", vq_update_mode="reference")
# phase 10: the convergence suite's kernels by case, the recovery kernels' by fold
SUITE_KERNELS = {
    "GCN-cluster": PATH_KERNELS["GCN"], "SAGE-cont": PATH_KERNELS["SAGE"],
    "GAT-cluster": PATH_KERNELS["GAT"], "GCN-bm": PATH_KERNELS["GCN"],
}
FOLD_KERNELS = {"x2": ("rev_forward", "rev_backward"),
                "fast": ("rev_forward_fold_bf16", "rev_backward_fold_bf16")}
# 10b: the tool's default run cut from its 60 epochs (the script's time
# limit), evaluated every 5
EPOCHS_10B = 10
# 10c: the B + M GAT VQ arm (the suite's B + M epochs and evaluation period)
EPOCHS_BM, EVAL_EVERY_BM = 40, 5
# phases 11-12: the kernels of the link and inductive paths (rows 1, 6, 7)
NEW_PATH_KERNELS = ("ell_aggregate", "vq_assign", "vq_lookup")
# ... and the link path's: row 8 sums the pair gathers' gradient
LINK_PATH_KERNELS = NEW_PATH_KERNELS + ("segment_sum",)
# phase 13's B + M paths whose trainers no later phase reads (13a without
# the transformer, 13b): their epochs cut to this many of their ~17 windows
# (the host's batch builds, ~0.6-0.8 s a window, set their time)
OPTIONS_WINDOWS = 8
# phase 3's paths whose step is checked to give the same bits twice from
# one state (phases 11 and 12 check theirs, phase 17 the sharded steps')
SAME_BITS_PATHS = ("3 GCN", "3 SAGE", "3 GAT", "3 GAT-bm")
NEW_TIMED_STEPS = 5
IND_EVAL_BATCH = 3000  # evaluate_split_stochastic's batch on the ppi validation graph
PLAIN_CHUNK_BYTES = 2.5e9  # the plain assign's distances per piece of branches
# phase 14: the kernels each layout path must launch (kernel 8 alone carries
# the COO paths and the mixed GAT conv, the latter with its scalar channel)
LAYOUT_KERNELS = {
    "14a": ("ell_aggregate", "vq_assign", "vq_lookup"),
    "14b": ("segment_sum_scalar", "vq_assign", "vq_lookup"),
    "14c": ("segment_sum", "vq_assign", "vq_lookup"),
    "14d": ("segment_sum", "vq_assign", "vq_lookup"),
}
MIXED_ROW = "ell_aggregate (mixed K = 8 + 2, 14a)"  # kernel 1's sub-row on the mixed families
DDP_STEPS = 20  # timed steps of each variant in phase 15
SCAN_KERNELS = ("ell_aggregate", "vq_lookup")  # 16c: 'scan' launches these, and not vq_assign
DDP_KERNELS = {"ell_aggregate": "ell_aggregate_kernel", "vq_assign": "assign_fast_kernel",
               "vq_lookup": "lookup_kernel"}  # rows 1, 6, 7: launch counter -> device kernel



def log(*a):
    print(*a, flush=True)


def spilling(reports) -> list:
    """(function, its spill line) of each function whose ptxas report
    (``nvcc -Xptxas -v``) has spill stores."""
    out, fn = [], None
    for rep in reports.values():
        for ln in rep.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for", 1)[1].strip()
            elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
                out.append((fn, ln.strip()))
    return out


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


def kernel_split(torch, fn, calls=20, sessions=3):
    """Device us per call of each kernel ``fn`` launches (torch.profiler);
    empty where the profiler saw no device time.  On the H100 a profiler
    session late in the script has come back without a device row (the
    first split of phases 11, 12, 14a and 14b in one run), and the next
    session had them: up to ``sessions`` sessions, until one sees the
    device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            if i:
                log(f"[kernel_split] device rows in profiler session {i + 1} of {sessions}")
            return {key: round(us / calls, 2) for us, _, key in rows}
    log(f"[kernel_split] no device rows in {sessions} profiler sessions")
    return {}


def branch_chunk(B: int, M: int) -> int:
    """Branches per piece of the plain assign whose [piece, B, M] f32
    distances take at most PLAIN_CHUNK_BYTES (at nb = 64, B = 32,768, M =
    4,096 the whole tensor would take 34 GB, and the plain loop holds three)."""
    return max(1, int(PLAIN_CHUNK_BYTES // (B * M * 4)))


def assign_plain(torch, xx, emb, vv, fast, idx=None, chunk=None):
    """Kernel 2's plain version, ``chunk`` branches at a time (branches are
    independent, so the pieces concatenate to the whole)."""
    from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches_plain

    c = chunk or xx.shape[0]
    parts = [fused_assign_branches_plain(xx[i : i + c], emb[i : i + c], vv, fast=fast,
                                         idx=None if idx is None else idx[i : i + c])
             for i in range(0, xx.shape[0], c)]
    return tuple(torch.cat(p) for p in zip(*parts))


def hold_assign(torch, tag, label, xx, emb, vv, err, key="vq_assign", chunk=None):
    """Kernel 2 against its plain version in both modes (the plain version
    ``chunk`` branches at a time).  Exact: idx and counts equal.  Fast
    (tensor cores, their own summation order): idx may differ at near ties
    only (worst ratio <= 1 on < 1e-3 of the rows), counts and sums held at
    the kernel's own idx.  Sums: summation order only, each within 1e-5 of
    the sum of the |x| it adds up."""
    from vq_gnn_tpu_torch.ops.vq_kernels import assign_mismatch, fused_assign_branches

    for fast in (False, True):
        idx, cnt, sums = fused_assign_branches(xx, emb, vv, fast=fast)
        idx_r, cnt_r, sums_r = assign_plain(torch, xx, emb, vv, fast, chunk=chunk)
        torch.cuda.synchronize()
        if fast:
            n_diff, worst = assign_mismatch(xx, emb, idx, idx_r, fast=True)
            rule = (f"rows whose idx differs {n_diff} of {idx.numel()}, worst ratio "
                    f"{worst:.4g} of the near-tie tolerance")
            ok_idx = worst <= 1.0 and n_diff < 1e-3 * idx.numel()
            _, cnt_r, sums_r = assign_plain(torch, xx, emb, vv, True, idx=idx)
        else:
            ok_idx = torch.equal(idx, idx_r)
            rule = f"idx equal {ok_idx}"
        _, _, abs_sums = assign_plain(torch, xx.abs(), emb, vv, fast, idx=idx)
        diff = (sums - sums_r).abs()
        ratio = float((diff / (1e-5 * abs_sums).clamp_min(1e-30)).max())
        log(f"[{tag} vq_assign {label} fast={fast}] xn {tuple(xx.shape)} M={emb.shape[1]} "
            f"{rule}; counts equal {torch.equal(cnt, cnt_r)} at "
            f"{'its own' if fast else 'the same'} idx; sums max|err| {float(diff.max()):.3g} "
            f"({ratio:.3f} of the 1e-5 * sum|x| tolerance)"
            + (f"; plain version {chunk} branches at a time" if chunk else ""))
        assert ok_idx and torch.equal(cnt, cnt_r) and ratio <= 1.0
        err[key] = max(err.get(key, 0.0), float(diff.max()))


def hold_lookup(torch, tag, label, vq, ids, D):
    """Kernel 3 bit-equal to its plain version (a gather), in both modes, as
    the [n, nb, K] table and split at D as the step calls it."""
    from vq_gnn_tpu_torch.ops.vq_kernels import lookup_codewords, lookup_codewords_plain

    for fast in (False, True):
        for split in (None, D):
            out, ref = (fn(vq.c_indices, ids, vq.embedding_output, fast=fast, split=split)
                        for fn in (lookup_codewords, lookup_codewords_plain))
            outs, refs = ((out,), (ref,)) if split is None else (out, ref)
            torch.cuda.synchronize()
            same = all(torch.equal(o, r) for o, r in zip(outs, refs, strict=True))
            log(f"[{tag} vq_lookup {label} fast={fast} split={split}] out "
                f"{[tuple(o.shape) for o in outs]} bit-equal {same}")
            assert same


def assign_times(torch, tag, label, xn_, emb_, valid, gpu, chunk=None):
    """Logs kernel 2's fast and exact times on these inputs, against its
    plain version and the library sequence (TF32 baddbmm + argmin + 2 x
    index_add_), each of those two ``chunk`` branches at a time and summed
    where the whole would not fit; returns (fast times, bound, its kind,
    device time of a CUDA-graph replay)."""
    from vq_gnn_tpu_torch.ops.vq_kernels import codeword_sqnorm, fused_assign_branches

    nb_, B_, K_ = xn_.shape
    M = emb_.shape[1]
    dev = xn_.device
    e2 = codeword_sqnorm(emb_)
    c = chunk or nb_

    def library(s):
        nbs = xn_[s].shape[0]
        d = torch.baddbmm(e2[s, None, :], xn_[s], emb_[s].transpose(1, 2), alpha=-2.0)
        idx = d.argmin(2)
        flat = (idx + torch.arange(nbs, device=dev)[:, None] * M).reshape(-1)
        v = valid.float().expand(nbs, B_).reshape(-1)
        cnt = torch.zeros(nbs * M, device=dev).index_add_(0, flat, v)
        sums = torch.zeros((nbs * M, K_), device=dev).index_add_(
            0, flat, (xn_[s] * valid.float()[None, :, None]).reshape(-1, K_))
        return idx, cnt, sums

    def by_piece(fn):
        return sum(cuda_time_ms(torch, lambda i=i: fn(slice(i, i + c)), reps=5)
                   for i in range(0, nb_, c))

    def fast():
        return fused_assign_branches(xn_, emb_, valid, fast=True)

    tt = {
        "ms": cuda_time_ms(torch, fast),
        "plain_ms": by_piece(lambda s: assign_plain(torch, xn_[s], emb_[s], valid, True)),
        "library_ms": by_piece(library),
    }
    ex = cuda_time_ms(torch, lambda: fused_assign_branches(xn_, emb_, valid, fast=False))
    graph_ms = graph_time_ms(torch, fast)
    byts = nb_ * B_ * K_ * 4 + nb_ * M * K_ * 4 + B_ + nb_ * B_ * 4 + nb_ * M * (K_ + 1) * 4
    b_f, by_f = bound(byts, 2 * nb_ * B_ * M * K_, BF16_FLOPS)
    b_x, by_x = bound(byts, 2 * nb_ * B_ * M * K_, F32_FLOPS)
    log(f"[{tag} vq_assign {label}] fast nb={nb_} B={B_} M={M} K={K_}: {tt}, device time in a "
        f"CUDA-graph replay {graph_ms:.4f} ms; bound {b_f:.4f} ms ({by_f}, bf16); exact "
        f"{ex:.4f} ms, bound {b_x:.4f} ms ({by_x}, f32)"
        + (f"; plain and library {c} branches at a time, summed" if c < nb_ else "")
        + f" | {gpu}")
    return tt, b_f, by_f, graph_ms


def lookup_times(torch, tag, label, vq, ids, D, gpu):
    """Kernel 3 in fast mode as the step calls it (split at D), its plain
    version and the library yardstick the step ran before (advanced
    indexing and the two slices); the whole [n, nb, K] table beside it.
    Returns the split call's times and bound, and its device us per call."""
    from vq_gnn_tpu_torch.ops.vq_kernels import lookup_codewords, lookup_codewords_plain

    c_idx, eo = vq.c_indices, vq.embedding_output
    nb_, M_, K_ = eo.shape
    n_ = ids.shape[0]
    ar = torch.arange(nb_, device=eo.device)[None, :]

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
    bb, bb_by = bound(n_ * 8 + n_ * nb_ * 2 + eo.numel() * 4 + n_ * nb_ * K_ * 4, 0, F32_FLOPS)
    split_us = kernel_split(torch, run)
    log(f"[{tag} vq_lookup {label}] fast n={n_} nb={nb_} M={M_} K={K_} split at D={D}: {tt} "
        f"bound {bb:.4f} ms ({bb_by}); device us per call {split_us}; the "
        f"whole [n, nb, K] table {whole}, device us per call "
        f"{kernel_split(torch, lambda: run(None))}; library_ms: advanced indexing (and the "
        f"two slices, split) | {gpu}")
    return dict(**tt, bound_ms=bb, bound_by=bb_by), split_us


def drive_path(torch, ops, NodeTrainer, tag, graph, cfg, gpu, timed_steps, profile, evaluate,
               kernels, on_init=None, same_bits=False, windows=None):
    """One training path through the trainer, launch counters zeroed just
    before it and read just after; ``on_init(tr)`` is called after its init
    sweep; with ``same_bits``, one step twice from its state after the timed
    steps must give the same bits (:func:`same_bits_twice`); with
    ``windows``, its epoch cut to its first ``windows`` loader items (a path
    whose state no later phase reads, at a smaller depth).  Returns what
    the later phases need, with the path's launches per timed step, its
    profile and its peak device memory above what the earlier phases
    hold."""
    g, c, ci = graph
    base = new_path_start(torch, ops)
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
    bad = [bool(s.bad_init) for s in tr.state.vq_states + (tr.state.vq_states_tr or [])]
    assert not any(bad), f"bad_init after the init sweep: {bad}"
    if on_init is not None:
        on_init(tr)

    # the epoch's batches, kept for the timed steps (the host builds an
    # epoch once); the first is the bench's batch (phase 8)
    batches = []
    train_step = tr.fns.train_step

    def keeping_step(state, X, batch, *a):
        batches.append(batch)
        return train_step(state, X, batch, *a)

    tr.fns.train_step = keeping_step
    loader = tr.train_loader
    if windows:
        tr.train_loader = FirstWindows(loader, windows)
    t0 = time.time()
    loss, loss_cls = tr.train_epoch(1)
    torch.cuda.synchronize()
    tr.fns.train_step, tr.train_loader = train_step, loader
    b0 = batches[0]
    e0 = b0.edges
    E_batch = edge_count(e0)
    log(f"[{tag} epoch 1] loss={loss:.4f} loss_cls={loss_cls:.4f}, {len(batches)} steps in "
        f"{time.time() - t0:.2f}s; its first batch E={E_batch}")
    assert math.isfinite(loss) and math.isfinite(loss_cls)

    log(f"[{tag} batch] B={b0.num_B} B_pad={b0.B_pad} B'={int(b0.valid_fo.sum())} "
        f"Bp_pad={b0.Bp_pad} E={E_batch} {layout_line(e0)}")
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
    prof = None
    if profile:
        def step(i):
            tr.state, _ = tr.fns.train_step(tr.state, tr.X_dev, batches[i % len(batches)], 1.0,
                                            cfg.lr, 1.0, tr.generator)

        prof = profile_steps(step, log=log, tag=tag, gpu=gpu)
        if prof is not None:
            rows = prof["rows"]
            # every kernel that takes row offsets got the batch's own (the
            # B + M grid path's fixed-order scatter, ops/segsum.py:sum_at,
            # its distinct keys' counts summed up: no search either)
            built = sorted({k for _, _, k in rows if "row_offsets_kernel" in k})
            log(f"[{tag} profile] row offsets built on the device: {built or 'none'}")
            assert not (built and "GAT-bm" in tag), "the B + M step built row offsets"
    mean = sum(times) / len(times)
    std = (sum((t - mean) ** 2 for t in times) / max(len(times) - 1, 1)) ** 0.5
    median = sorted(times)[len(times) // 2]
    log(f"[{tag} train] {timed_steps} steps: {mean:.2f} ms/step (std {std:.2f}, median "
        f"{median:.2f}, min {min(times):.2f}, max {max(times):.2f}) | {gpu}")
    log(f"[{tag} train] edges/s at this batch: {E_batch / (mean / 1e3):.4g}; launches per step "
        f"{per_step}; losses {[round(x, 4) for x in losses]}")
    assert all(math.isfinite(x) for x in losses)
    if same_bits:
        same_bits_twice(torch, ops, tag, tr.state, lambda st, _, gen: tr.fns.train_step(
            st, tr.X_dev, b0, 1.0, cfg.lr, 1.0, gen), gpu)
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
    assign_by_k = dict(ops.KERNELS["vq_assign"].by_width)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[{tag} memory] the path's peak device memory above the earlier phases' "
        f"{peak / 1e9:.3f} GB (held before it {base / 1e9:.3f} GB) | {gpu}")

    # ---- 4. the path went through every one of its kernels ----
    log(f"[4 launches] {tag} path: {launches}; gat_backward by width {by_width}")
    for name in kernels:
        assert launches[name] > 0, f"kernel {name} was not launched on the {tag} path"
    if cfg.compute_dtype == "bfloat16":
        for name in BF16_PATH_NOT:
            assert launches[name] == 0, f"the f32 mode of {name} ran on the {tag} path"
    if cfg.compute_dtype == "float16":
        for name in F16_PATH_NOT:
            assert launches[name] == 0, f"{name} ran on the f16 {tag} path"
    return dict(tr=tr, batch0=b0, test_batches=test_batches, launches=launches,
                by_width=by_width, ms=mean, std=std, per_step=per_step,
                prof=prof, peak=peak, E_batch=E_batch, assign_by_k=assign_by_k)


def edge_count(e) -> int:
    """A batch's real edges: the non-zero values of its layout."""
    if e.mixed:
        return int((e.head_val != 0).sum()) + int((e.tail_val != 0).sum())
    return int(((e.val if e.ell_val is None else e.ell_val) != 0).sum())


def layout_line(e) -> str:
    """The shapes of a batch's adjacency in its layout."""
    if e.mixed:
        return (f"mixed-K head S={e.head_col.shape[0]} K={e.head_col.shape[1]} tail "
                f"S={e.tail_col.shape[0]} Kt={e.tail_col.shape[1]}; transposed head "
                f"{e.t_head_col.shape[0]} tail {e.t_tail_col.shape[0]}; t_head_b_slots="
                f"{e.t_head_b_slots} t_tail_b_slots={e.t_tail_b_slots} b_rows={e.b_rows}")
    if e.ell_row is not None:
        return (f"S_pad={e.ell_row.shape[0]} St_pad={e.t_ell_row.shape[0]} "
                f"t_b_slots={e.t_b_slots} b_rows={e.b_rows}")
    return f"COO E_pad={e.row.shape[0]}"


def hold_ell(torch, tag, label, edges, calls, gen, err):
    """Kernel 1 against its plain version on a batch's ELL, with the
    batch's row offsets and long rows as spmm passes them, at each (width C,
    'forward', 'dx' or 'dx full') of ``calls``: dx over the transposed ELL's
    slots of the rows < b_rows (the step's truncated backward), 'dx full'
    over all of it (the backward of a batch without the truncation).
    Tolerance: f32 sums in another order, 1e-5 of the largest |ref|; the
    same bits twice."""
    from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate, ell_aggregate_plain

    R = edges.num_rows
    tb = edges.t_b_slots
    for C, which in calls:
        x = torch.randn((R, C), generator=gen, device=edges.ell_col.device)
        if which == "forward":
            args = (x, edges.ell_row, edges.ell_col, edges.ell_val, R)
            kw = dict(ptr=edges.ell_ptr, long_rows=edges.ell_long_rows)
        elif which == "dx full":
            assert not edges.b_rows, "the batch truncates its backward"
            args = (x, edges.t_ell_row, edges.t_ell_col, edges.t_ell_val, R)
            kw = dict(ptr=edges.t_ell_ptr, long_rows=edges.t_ell_long_rows)
        else:
            assert edges.b_rows and tb, "the training batch has no truncated backward"
            args = (x, torch.clamp(edges.t_ell_row[:tb], max=edges.b_rows),
                    edges.t_ell_col[:tb].contiguous(), edges.t_ell_val[:tb].contiguous(),
                    edges.b_rows)
            kw = dict(ptr=edges.t_ell_ptr, long_rows=edges.t_ell_long_rows)
        out, again, ref = ell_aggregate(*args, **kw), ell_aggregate(*args, **kw), \
            ell_aggregate_plain(*args)
        torch.cuda.synchronize()
        d = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        same = torch.equal(out, again)
        log(f"[{tag} ell_aggregate {label} {which} C={C}] out {tuple(out.shape)} max|err| "
            f"{d:.3g} (tol {tol:.3g}); {kw['long_rows'].shape[0] - 1} long rows; two calls "
            f"bit-identical: {same}")
        assert torch.isfinite(out).all() and d <= tol and same
        err["ell_aggregate"] = max(err.get("ell_aggregate", 0.0), d)


def keep_batches(obj, name, pos, kept, n=3):
    """Wrap ``obj.<name>``, a step taking the batch as its argument ``pos``,
    to keep the first ``n`` batches it is given; returns the original to put
    back."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        if len(kept) < n:
            kept.append(args[pos])
        return fn(*args, **kw)

    setattr(obj, name, wrapped)
    return fn


def host_batch(b):
    """A copy of a batch (or its edges) with every tensor a host numpy
    array, as the loaders build them (``PaddedBatch.to`` and the shards
    take host arrays)."""
    out = copy.copy(b)
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if hasattr(v, "detach"):
            setattr(out, f.name, v.detach().cpu().numpy())
        elif dataclasses.is_dataclass(v):
            setattr(out, f.name, host_batch(v))
    return out


def state_digest(state, pred=None) -> str:
    """sha256 over a train state's archive leaves (the parameters, the
    codebooks and c_indices but its padding dustbin row N, which one of the
    padded slots writes, unspecified which; RMSprop's square averages, the
    BN state) and a link predictor's parameters: two runs' states compared
    by one line."""
    arrays = [x[:-1] if name.endswith("c_indices") else x for name, x in state_leaves(state)]
    if pred is not None:
        arrays += [p.detach().cpu().numpy() for p in pred.parameters()]
    return _state_digest(arrays)


def same_bits_twice(torch, ops, tag, state, step, gpu, pred=None):
    """One step twice from one state (``step(state, pred, generator)``, on a
    copy of ``state`` and ``pred`` each time, the generator seeded alike):
    the two states must have the same bits (no float atomics on the path;
    not counted).  Returns the digest."""
    from vq_gnn_tpu_torch.convert import state_like, state_to_numpy

    snap = state_to_numpy(state)
    digests = []
    with ops.uncounted():
        for _ in range(2):
            st, pr = state_like(state, snap), copy.deepcopy(pred)
            step(st, pr, torch.Generator(device="cuda").manual_seed(5))
            torch.cuda.synchronize()
            digests.append(state_digest(st, None if pr is None else pr[0]))
    log(f"[{tag} same bits] one step twice from one state: "
        f"{'the same bits' if digests[0] == digests[1] else 'DIFFERENT bits'} "
        f"({digests[0][:16]} / {digests[1][:16]}) | {gpu}")
    assert digests[0] == digests[1], f"{tag}: one step from one state differs run to run"
    return digests[0]


class FirstWindows:
    """A loader's next epoch cut to its first ``n`` items, built in the
    caller's thread (a trainer's ``train_epoch`` iterates it as its loader);
    every other attribute is the loader's."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __iter__(self):
        for item in itertools.islice(self.loader._epoch_iter(), self.n):
            yield self.loader._to_device(item)

    def __getattr__(self, name):
        return getattr(self.loader, name)


def timed_steps(torch, step, batches, steps):
    """ms of ``steps`` synchronised calls ``step(batch)``, cycling through
    ``batches``; returns (times, losses)."""
    times, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = step(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        assert not bool(m["bad_init"]), "Bad Init!"
    return times, losses


def new_path_start(torch, ops):
    """Zero the launch counters and the peak-memory mark; returns the bytes
    the earlier phases still hold (the path's peak is read above them)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def batch_line(b, E):
    e = b.edges
    return (f"B={b.num_B} B_pad={b.B_pad} B'={int(b.valid_fo.sum())} Bp_pad={b.Bp_pad} E={E} "
            f"{layout_line(e)}")


def link_phase(torch, ops, gpu, err, keep):
    """Phase 11: link prediction at the collab widths through LinkTrainer
    (the module docstring says what it runs).  Hands its trainer and its
    epoch's first batch to ``keep`` (phase 17's ``GCN-link``); returns its
    launch counts."""
    import link_experiment_torch as tool
    from vq_gnn_tpu_torch.graph.datasets import prepare
    from vq_gnn_tpu_torch.train.link import LinkTrainer

    t0 = time.time()
    g, split = tool.build_graph_and_split()
    t_graph = time.time() - t0
    cfg = tool.vq_config("GCN", 1)
    g, _, _ = prepare(g, cfg, 0, symmetrize_adj=False)
    log(f"[11 graph] collab-scale dot-product graph N={g.num_nodes} (uncut), {g.num_features} "
        f"features, training adjacency E={g.num_edges} (normalised, with self-loops); "
        f"positives train/valid/test {len(split.train_pos)}/{len(split.valid_pos)}/"
        f"{len(split.test_pos)}, negatives {len(split.valid_neg)}/{len(split.test_neg)}; "
        f"synthetic_dot_product and the split in {t_graph:.1f}s, prepared in "
        f"{time.time() - t0 - t_graph:.1f}s")
    t0 = time.time()
    tr = LinkTrainer(g, cfg, split, device="cuda")
    test_batches = tr.test_batches()
    log(f"[11 setup] trainer + {len(test_batches)} eval batches in {time.time() - t0:.1f}s; "
        f"channels {tr.ms.channels}, M={cfg.num_M}, vq backend {tr.ms.vq.backend}, batch "
        f"{cfg.batch_size}, walk length {cfg.walk_length}, test batch {cfg.test_batch_size}")
    base = new_path_start(torch, ops)
    t0 = time.time()
    tr.run_init_sweep()
    torch.cuda.synchronize()
    log(f"[11 init sweep] {time.time() - t0:.2f}s over {len(test_batches)} eval batches "
        f"B_pad={test_batches[0][0][0].B_pad}; launches {ops.launch_counts()}")
    kept = []
    step = keep_batches(tr, "step_fn", 4, kept)
    t0 = time.time()
    loss = tr.train_epoch(1)
    torch.cuda.synchronize()
    tr.step_fn = step
    log(f"[11 epoch 1] loss_pre={loss:.4f}, {tr.state.step} steps in {time.time() - t0:.2f}s")
    assert math.isfinite(loss)
    b0 = kept[0]
    Es = [int((b.edges.ell_val != 0).sum()) for b in kept]
    log(f"[11 batch] {batch_line(b0, Es[0])} link edges {int(b0.link_mask.sum())} "
        f"L_pad={b0.link_src.shape[0]}")
    before = ops.launch_counts()
    times, losses = timed_steps(torch, lambda b: tr.step_fn(
        tr.state, tr.predictor, tr.pred_opt, tr.X_dev, b, 1.0, cfg.lr, 1.0, tr.generator),
        kept, NEW_TIMED_STEPS)
    per_step = {k: (v - before[k]) / NEW_TIMED_STEPS for k, v in ops.launch_counts().items()}
    mean = sum(times) / len(times)
    E_mean = sum(Es[i % len(kept)] for i in range(NEW_TIMED_STEPS)) / NEW_TIMED_STEPS
    log(f"[11 train] {NEW_TIMED_STEPS} steps on the epoch's first {len(kept)} windows: "
        f"{mean:.2f} ms/step (median {sorted(times)[len(times) // 2]:.2f}, min "
        f"{min(times):.2f}, max {max(times):.2f}); edges/s {E_mean / (mean / 1e3):.4g}; "
        f"launches per step {per_step}; losses {[round(x, 4) for x in losses]} | {gpu}")
    assert all(math.isfinite(x) for x in losses)
    t0 = time.time()
    hits = tr.evaluate_hits(50)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = ops.launch_counts()
    log(f"[11 eval] Hits@50 train/valid/test {tuple(round(h, 4) for h in hits)} in "
        f"{time.time() - t0:.2f}s | {gpu}")
    log(f"[11 memory] the path's peak device memory above the earlier phases' "
        f"{peak / 1e9:.3f} GB (held before it {base / 1e9:.3f} GB) | {gpu}")
    assert all(0.0 <= h <= 1.0 for h in hits)
    log(f"[4 launches] 11 link path: {counts}")
    for name in LINK_PATH_KERNELS:
        assert counts[name] > 0, f"kernel {name} was not launched on the link path"
    same_bits_twice(torch, ops, "11 link", tr.state, lambda st, pr, gen: tr.step_fn(
        st, *pr, tr.X_dev, b0, 1.0, cfg.lr, 1.0, gen), gpu, pred=(tr.predictor, tr.pred_opt))

    # the kernels at this path's shapes, from its trained state
    gen = torch.Generator(device="cuda").manual_seed(11)
    hold_ell(torch, 11, "link", b0.edges, ((cfg.hidden_channels, "forward"),
                                          (cfg.hidden_channels, "dx")), gen, err)
    vq1 = tr.state.vq_states[1]
    nb, M, K = vq1.embedding.shape
    emb = vq1.embedding.contiguous()
    xn = torch.randn((nb, b0.B_pad, K), generator=gen, device="cuda")
    hold_assign(torch, 11, "link vq_update", xn, emb, b0.valid_B.contiguous(), err,
                chunk=branch_chunk(b0.B_pad, M))
    tb0 = test_batches[0][0][0]
    xn4 = torch.randn((nb, tb0.B_pad, K // 2), generator=gen, device="cuda")
    hold_assign(torch, 11, "link feature_update (init sweep)", xn4,
                emb[:, :, : K // 2].contiguous(), tb0.valid_B.contiguous(), err,
                chunk=branch_chunk(tb0.B_pad, M))
    hold_lookup(torch, 11, "link", vq1, b0.fo_ids, cfg.num_D)
    assign_times(torch, 11, "link vq_update", xn, emb, b0.valid_B.contiguous(), gpu,
                 chunk=branch_chunk(b0.B_pad, M))
    lookup_times(torch, 11, "link", vq1, b0.fo_ids, cfg.num_D, gpu)
    tr._batch_cache.clear()  # the eval batches: phase 17 reads the state and b0 only
    log(f"[11 digest] the state phase 17 starts from (parameters, codebooks, c_indices, "
        f"RMSprop's averages, BN; the predictor): sha256 "
        f"{state_digest(tr.state, tr.predictor)}")
    keep["GCN-link"], keep["batches"]["GCN-link"] = tr, [host_batch(b0)]
    return counts


def inductive_phase(torch, ops, gpu, err, kern, keep):
    """Phase 12: inductive multilabel training at the ppi widths through
    NodeTrainer(val_graph=, test_graph=), then evaluate_split_stochastic
    (the module docstring says what it runs).  Adds the timed rows of the
    new shapes to ``kern``, its trainer and its epoch's first batch to
    ``keep`` (phase 17's ``GCN-ppi``); returns its launch counts: the path's with
    evaluate_split_stochastic's, and under the new rows' names the path's
    (row 6 at nb = 64 and row 7) and evaluate_split_stochastic's (row 6 at K
    = 4)."""
    import inductive_experiment_torch as tool
    from vq_gnn_tpu_torch.utils.metrics import micro_f1

    t0 = time.time()
    graphs = tool.build_graphs(7, 1.0)
    t_graph = time.time() - t0
    cfg = tool.vq_cfg("GCN", 1)
    tr = tool.make_trainer(cfg, graphs, "cuda")
    splits = {name: tr.split_batches(name) for name in ("train", "val", "test")}
    test_batches = tr.test_batches()
    log(f"[12 graph] ppi-scale SBM splits (uncut) "
        f"{[g.num_nodes for g in (tr.graph, tr.val_graph, tr.test_graph)]} nodes, "
        f"{[g.num_edges for g in (tr.graph, tr.val_graph, tr.test_graph)]} edges (normalised, "
        f"with self-loops), {tr.graph.num_features} features (padded), {tr.graph.y.shape[1]} "
        f"labels; graphs in {t_graph:.1f}s, trainer + eval batches in "
        f"{time.time() - t0 - t_graph:.1f}s; channels {tr.ms.channels}, M={cfg.num_M}, vq "
        f"backend {tr.ms.vq.backend}, batch {cfg.batch_size}")
    base = new_path_start(torch, ops)
    t0 = time.time()
    tr.run_init_sweep()
    torch.cuda.synchronize()
    log(f"[12 init sweep] {time.time() - t0:.2f}s over the train graph's full batch "
        f"B_pad={test_batches[0][0][0].B_pad}; launches {ops.launch_counts()}")
    kept = []
    step = keep_batches(tr.fns, "train_step", 2, kept)
    t0 = time.time()
    loss, loss_cls = tr.train_epoch(1)
    torch.cuda.synchronize()
    tr.fns.train_step = step
    log(f"[12 epoch 1] loss={loss:.4f} loss_cls (BCE)={loss_cls:.4f}, {tr.state.step} steps in "
        f"{time.time() - t0:.2f}s")
    assert math.isfinite(loss) and math.isfinite(loss_cls)
    b0 = kept[0]
    assert b0.y.dtype == torch.float32 and tuple(b0.y.shape) == (b0.B_pad, tr.graph.y.shape[1])
    assert not b0.y[b0.num_B :].any()
    Es = [int((b.edges.ell_val != 0).sum()) for b in kept]
    log(f"[12 batch] {batch_line(b0, Es[0])}; y {tuple(b0.y.shape)} {b0.y.dtype}, padded rows "
        f"zero")
    before = ops.launch_counts()
    times, losses = timed_steps(torch, lambda b: tr.fns.train_step(
        tr.state, tr.X_dev, b, 1.0, cfg.lr, 1.0, tr.generator)[1], kept, NEW_TIMED_STEPS)
    per_step = {k: (v - before[k]) / NEW_TIMED_STEPS for k, v in ops.launch_counts().items()}
    mean = sum(times) / len(times)
    E_mean = sum(Es[i % len(kept)] for i in range(NEW_TIMED_STEPS)) / NEW_TIMED_STEPS
    log(f"[12 train] {NEW_TIMED_STEPS} steps on the epoch's {len(kept)} batches: {mean:.2f} "
        f"ms/step (median {sorted(times)[len(times) // 2]:.2f}, min {min(times):.2f}, max "
        f"{max(times):.2f}); edges/s {E_mean / (mean / 1e3):.4g}; launches per step "
        f"{per_step}; losses {[round(x, 4) for x in losses]} | {gpu}")
    assert all(math.isfinite(x) for x in losses)
    t0 = time.time()
    f1 = tr.evaluate()
    torch.cuda.synchronize()
    log(f"[12 eval] micro-F1 train/valid/test graphs {tuple(round(v, 4) for v in f1)} (each "
        f"one full batch, B_pad {[splits[n][0][0][0].B_pad for n in splits]}) in "
        f"{time.time() - t0:.2f}s | {gpu}")
    assert len(f1) == 3 and all(0.0 <= v <= 1.0 for v in f1)
    counts = ops.launch_counts()
    log(f"[4 launches] 12 inductive path: {counts}")
    for name in NEW_PATH_KERNELS:
        assert counts[name] > 0, f"kernel {name} was not launched on the inductive path"
    same_bits_twice(torch, ops, "12 multilabel", tr.state, lambda st, _, gen: tr.fns.train_step(
        st, tr.X_dev, b0, 1.0, cfg.lr, 1.0, gen), gpu)
    # the stochastic eval into the validation graph's own table: row 6 on
    # the feature half (K = 4), row 7 over that table
    eval_kept = []
    fn = keep_batches(tr.fns, "eval_assign_step", 3, eval_kept, n=1)
    before = ops.launch_counts()
    t0 = time.time()
    outs = tr.evaluate_split_stochastic(tr.val_graph, IND_EVAL_BATCH)
    torch.cuda.synchronize()
    tr.fns.eval_assign_step = fn
    peak = torch.cuda.max_memory_allocated() - base
    d = {k: v - before[k] for k, v in ops.launch_counts().items()}
    log(f"[12 evaluate_split_stochastic] validation graph at batch {IND_EVAL_BATCH} "
        f"(B_pad {eval_kept[0].B_pad}): out {outs.shape}, micro-F1 "
        f"{micro_f1(outs, tr.val_graph.y):.4f} in {time.time() - t0:.2f}s; launches {d} | {gpu}")
    log(f"[12 memory] the path's peak device memory above the earlier phases' "
        f"{peak / 1e9:.3f} GB (held before it {base / 1e9:.3f} GB) | {gpu}")
    assert outs.shape == (tr.val_graph.num_nodes, tr.graph.y.shape[1]) and math.isfinite(
        float(abs(outs).max()))
    assert d["vq_assign"] > 0 and d["vq_lookup"] > 0, d
    path_counts = dict(counts)
    for k, v in d.items():
        counts[k] += v

    # the kernels at this path's shapes, from its trained state: kernel 1 at
    # layer 0's width and the hidden width, kernel 2 per layer's nb in both
    # halves (K = 8 in the step, K = 4 in eval_assign_step), kernel 3 at M =
    # 4,096
    gen = torch.Generator(device="cuda").manual_seed(12)
    C0, C1 = tr.ms.channels[0], tr.ms.channels[1]
    hold_ell(torch, 12, "ppi", b0.edges, ((C0, "forward"), (C1, "forward"), (C1, "dx")), gen,
             err)
    eb = eval_kept[0]
    rows = {}
    for l in (0, 1):
        vq = tr.state.vq_states[l]
        nb, M, K = vq.embedding.shape
        emb = vq.embedding.contiguous()
        emb4 = vq.embedding[:, :, : K // 2].contiguous()
        xn = torch.randn((nb, b0.B_pad, K), generator=gen, device="cuda")
        xn4 = torch.randn((nb, eb.B_pad, K // 2), generator=gen, device="cuda")
        key = f"vq_assign (nb={nb}, M={M})" if l else "vq_assign"
        key4 = f"vq_assign (K=4, M={M}, eval_assign_step)" if l else "vq_assign"
        hold_assign(torch, 12, f"ppi vq_update layer {l}", xn, emb, b0.valid_B.contiguous(),
                    err, key=key, chunk=branch_chunk(b0.B_pad, M))
        hold_assign(torch, 12, f"ppi eval_assign_step layer {l}", xn4, emb4,
                    eb.valid_B.contiguous(), err, key=key4, chunk=branch_chunk(eb.B_pad, M))
        hold_lookup(torch, 12, f"ppi layer {l}", vq, b0.fo_ids, cfg.num_D)
        if l:
            rows[key] = (xn, emb, b0.valid_B.contiguous(), b0.B_pad)
            rows[key4] = (xn4, emb4, eb.valid_B.contiguous(), eb.B_pad)
    vq1 = tr.state.vq_states[1]
    lkey = f"vq_lookup (nb={vq1.embedding.shape[0]}, M={vq1.embedding.shape[1]})"
    err[lkey] = 0.0  # bit-equal above
    # times at the new shapes (PERF.md section 6 sub-rows)
    for key, (xn, emb, vv, B) in rows.items():
        t, b_ms, b_by, graph_ms = assign_times(torch, 12, key, xn, emb, vv, gpu,
                                               chunk=branch_chunk(B, emb.shape[1]))
        kern[key] = dict(source="vq_gnn_tpu_torch/csrc/vq_assign.cu",
                         replaces="vq_gnn_tpu/ops/pallas_vq.py:140", **t, bound_ms=b_ms,
                         bound_by=b_by)
    t, _ = lookup_times(torch, 12, lkey, vq1, b0.fo_ids, cfg.num_D, gpu)
    kern[lkey] = dict(source="vq_gnn_tpu_torch/csrc/vq_lookup.cu",
                      replaces="vq_gnn_tpu/ops/pallas_vq.py:276", **t)
    key, key4 = rows
    counts.update({key: path_counts["vq_assign"], key4: d["vq_assign"],
                   lkey: path_counts["vq_lookup"]})
    keep["GCN-ppi"], keep["batches"]["GCN-ppi"] = tr, [host_batch(b0)]
    return counts


def compare_small(rg, rc, conv, form, dtype, t0):
    """Phase 7's comparison of one small-graph case: the card's run ``rg``
    against the CPU's ``rc`` from one state (the module docstring)."""
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
    # of the largest |value| it takes over the run.  At bf16 the rounded
    # gradients that feed the codebook update flip a near tie sooner, so
    # two steps from one state are asked for, not three
    min_same = 3 if dtype == "float32" else 2
    tag7 = f"{conv} {form}" + ("" if dtype == "float32" else f" {dtype}")
    same = next((i for i, f in enumerate(flips) if f), len(flips) - 1)  # steps from one state
    dq = {}
    for i, q in enumerate(("loss_cls", "info_backward")):
        a = [s[i] for s in rg["steps"]]
        b = [s[i] for s in rc["steps"]]
        scale = max(abs(v) for v in b)
        dq[q] = max(abs(x - y) for x, y in zip(a[:same], b[:same])) / scale
        log(f"[7 small graph {tag7}] {q} per step cuda {a} cpu {b} (max diff over "
            f"the first {same} steps / max|value| {dq[q]:.2e})")
    log(f"[7 small graph {tag7}] codeword assignments that differ, cuda vs cpu, of "
        f"{sum(a.numel() for a in rc['codes'][0])}: after the init sweep {flips[0]}, after "
        f"each step {flips[1:]}")
    log(f"[7 small graph {tag7}] epoch losses cuda {rg['losses']} cpu {rc['losses']} "
        f"(max rel diff {dl:.2e}); logits max|diff| {float(abs(pg - pc).max()):.3g}, argmax "
        f"agreement {agree:.4f} in {time.time() - t0:.1f}s")
    assert same >= min_same and max(dq.values()) < 1e-4 and agree >= 0.99
    if form == "bbprime":  # four steps: they end before flips spread
        assert dl < 1e-3


def cpu_small_runs(cases, threads, dtype, path):
    """Phase 7's CPU halves of ``cases`` ((conv, form, epochs) each) at
    ``dtype``, in a process of their own with ``threads`` torch threads:
    their records pickled to ``path``, keyed by (conv, form)."""
    import pickle

    import torch

    from vq_gnn_tpu_torch.config import Config
    from vq_gnn_tpu_torch.graph.datasets import prepare, synthetic_sbm
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    torch.set_num_threads(threads)
    recs = {(conv, form): small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv,
                                          form, "cpu", dtype, epochs=epochs)
            for conv, form, epochs in cases}
    with open(path, "wb") as f:
        pickle.dump(recs, f)


class Background:
    """``fn(*args, path)`` in a spawned process (the card untouched), its
    result read back from the pickle it writes at ``path``; ``result()``
    waits for it and raises if it failed.  Daemonic: it ends with the
    script."""

    def __init__(self, fn, *args):
        import multiprocessing as mp
        import tempfile

        fd, self.path = tempfile.mkstemp(prefix="chip_smoke_bg_", suffix=".pkl")
        os.close(fd)
        self.proc = mp.get_context("spawn").Process(target=fn, args=args + (self.path,),
                                                    daemon=True)
        self.proc.start()

    def result(self):
        import pickle

        self.proc.join()
        assert self.proc.exitcode == 0, f"a background process failed ({self.proc.exitcode})"
        with open(self.path, "rb") as f:
            out = pickle.load(f)
        os.remove(self.path)
        return out


def small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv, form, device,
                    dtype="float32", vq_states=None, epochs=(1, 2)):
    """The init sweep and the ``epochs`` (two by default) of a 3,000-node
    graph through the trainer (exact f32 matmuls: no TF32, the exact VQ
    distances; compute at ``dtype``).  Records each step's loss_cls and
    info_backward and every layer's codeword assignments after the init
    sweep and after each step, and the codebooks the init sweep left
    (``init_vq``).  Given ``vq_states`` (another run's ``init_vq``), it
    starts from those in place of its own init sweep."""
    exact = dict(conv_type=conv, matmul_precision="highest", vq_backend="pallas",
                 compute_dtype=dtype)
    if form == "bm":  # the B + M path at 1/10 of its batch and M = 64
        cfg_s = bm_cfg(Config, num_M=64, batch_size=1000, test_batch_size=1500, walk_length=2,
                       **exact)
    else:
        cfg_s = flagship_cfg(Config, num_parts=8, batch_size=4, test_batch_size=4, **exact)
    gs, cs = synthetic_sbm(num_nodes=3000, num_classes=N_CLASSES, num_features=N_FEAT,
                           avg_degree=AVG_DEG, seed=1)
    gs, cs, cis = prepare(gs, cfg_s, cs)
    ts = NodeTrainer(gs, cfg_s, cs, cis, device=device)
    if vq_states is None:
        ts.run_init_sweep()
    else:  # the parameters are the same already: one seed
        ts.state.vq_states = [
            dataclasses.replace(s, **{f.name: getattr(s, f.name).to(device)
                                      for f in dataclasses.fields(s)})
            for s in vq_states]

    def codes(state):
        return [s.c_indices.cpu().clone() for s in state.vq_states]

    rec = dict(codes=[codes(ts.state)], steps=[], init_vq=[
        dataclasses.replace(s, **{f.name: getattr(s, f.name).cpu().clone()
                                  for f in dataclasses.fields(s)})
        for s in ts.state.vq_states])
    step = ts.fns.train_step

    def recording_step(*args):
        state, m = step(*args)
        rec["steps"].append((float(m["loss_cls"]), float(m["info_backward"])))
        rec["codes"].append(codes(state))
        return state, m

    ts.fns.train_step = recording_step
    rec["losses"] = [ts.train_epoch(ep)[0] for ep in epochs]
    rec["pred"] = ts.predict_all()
    return rec


def accuracy_phase(torch, ops, gpu, launches, err, device="cuda"):
    """Phase 10 (the module docstring says what it runs) on ``device``.  Adds
    10c's launches of the bf16 fold to ``launches`` and kernel 8's error at
    the full-graph shape to ``err``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import parity_experiment_torch as tool
    from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted
    from vq_gnn_tpu_torch.ops.spmm import make_edges
    from vq_gnn_tpu_torch.train import parity

    def counted(tag, fn, kernels, not_kernels=()):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"[4 launches] {tag}: {counts} ({time.time() - t0:.1f}s)")
        for name in kernels:
            assert counts[name] > 0, f"kernel {name} was not launched in {tag}"
        for name in not_kernels:
            assert counts[name] == 0, f"{name} was launched in {tag}"
        return res, counts

    # 10a: the suite of tests/test_parity_convergence.py, its bounds
    for name in tool.CONVERGENCE:
        (_, ctrl, vq, ok), _ = counted(
            f"10a {name}", lambda: tool.run_convergence_case(name, device),
            SUITE_KERNELS[name])
        arm = "exact" if tool.CONVERGENCE[name][3] == "both" else "exact_mb"
        log(f"[10a {name}] {arm} {ctrl:.4f} vq {vq:.4f} gap {ctrl - vq:+.4f}: the bounds of "
            f"tests/test_parity_convergence.py {'hold' if ok else 'MISSED'} | {gpu}")
        assert ok, (name, ctrl, vq)

    # 10b: the flagship GCN B + B' as the tool runs it by default but for its
    # epochs, both arms; the trainers are kept for the full-graph forward
    args = tool.parse_args(["--epochs", str(EPOCHS_10B)])
    graph_fn, src = tool.graph_source(args)
    cfg = tool.vq_config(args, args.nodes)
    trainers = {}
    res, _ = counted("10b GCN B + B' parity", lambda: parity.parity_gap(
        graph_fn, cfg, epochs=args.epochs, eval_every=args.eval_every, device=device,
        trainers=trainers), PATH_KERNELS["GCN"])
    for arm in ("exact", "vq"):
        r = res[arm]
        log(f"[10b {arm}] best valid {r['best_valid']:.4f} test at best valid "
            f"{r['test_at_best_valid']:.4f} final test {r['final_test']:.4f}; history "
            f"{[tuple(round(v, 4) for v in h) for h in r['history']]}")
        assert 0.0 < r["test_at_best_valid"] <= 1.0
    log(f"[10b] {src}, {args.epochs} epochs: gap (exact - vq) {res['gap']:+.4f} | {gpu}")
    # the exact arm's full-graph forward: COO edges, kernel 8, the same model
    # function as its full-graph batch (GCN with skip, BN in eval mode)
    ex = trainers["exact"]
    full, counts = counted("10b full-graph forward", ex.full_graph_predict, ("segment_sum",),
                           ("ell_aggregate",))
    batched = ex.predict_all()
    agree = float((full.argmax(1) == batched.argmax(1)).mean())
    d = float(abs(full - batched).max())
    scale = float(abs(batched).max())
    acc_full = float((full.argmax(1) == ex.graph.y)[ex.graph.test_mask].mean())
    log(f"[10b full-graph forward] {full.shape}: max|full - batched| {d:.3g} (max|batched| "
        f"{scale:.3g}), argmax agreement {agree:.5f}; test accuracy {acc_full:.4f}; kernel 8 "
        f"launches {counts['segment_sum']}")
    assert math.isfinite(d) and d <= 1e-3 * max(1.0, scale) and agree >= 0.999
    # kernel 8 at that shape: one layer's messages val * x[col] over the
    # whole graph, held against the plain sum in float64 (index_add_'s float
    # atomics sum in another order each run), then cast; the same bits twice
    g = ex.graph
    edges = make_edges(*g.coo(), g.num_nodes).to(device)
    x = torch.as_tensor(g.x).to(device)
    msgs = x.index_select(0, edges.col.long()) * edges.val[:, None]
    lists = dict(ptr=edges.row_ptr, long_rows=edges.row_long_rows)
    out = segment_sum_sorted(msgs, edges.row, g.num_nodes, **lists)
    again = segment_sum_sorted(msgs, edges.row, g.num_nodes, **lists)
    ref = (msgs.new_zeros((g.num_nodes, msgs.shape[1]), dtype=torch.float64)
           .index_add_(0, edges.row.long(), msgs.double()).float())
    d = float((out - ref).abs().max())
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    same = torch.equal(out, again)
    log(f"[10b segment_sum full graph] R={g.num_nodes} E={edges.row.shape[0]} "
        f"C={msgs.shape[1]} long rows {edges.row_long_rows.shape[0] - 1}: max|err| {d:.3g} "
        f"(tol {tol:.3g}); two calls bit-identical: {same}")
    assert torch.isfinite(out).all() and d <= tol and same
    err["segment_sum"] = max(err.get("segment_sum", 0.0), d)
    del trainers, ex, edges, x, msgs, out, again, ref

    # 10c: the B + M GAT VQ arm under each fold of the recovery term
    cfg_c = tool.vq_config(tool.parse_args(["--formulation", "bm", "--conv", "GAT"]),
                           tool.CONVERGENCE_N)
    prev = os.environ.get("VQ_GNN_REV_FOLD")
    accs = {}
    try:
        for fold in ("x2", "fast"):
            os.environ["VQ_GNN_REV_FOLD"] = fold
            other = FOLD_KERNELS["fast" if fold == "x2" else "x2"]
            r, counts = counted(f"10c GAT B + M fold={fold}", lambda: parity.train_to_acc(
                tool.convergence_graph, cfg_c, EPOCHS_BM, EVAL_EVERY_BM, device=device),
                ("segment_sum", "vq_assign", "vq_lookup") + FOLD_KERNELS[fold], other)
            accs[fold] = r["test_at_best_valid"]
            log(f"[10c fold={fold}] best valid {r['best_valid']:.4f} test at best valid "
                f"{r['test_at_best_valid']:.4f} final test {r['final_test']:.4f} | {gpu}")
            if fold == "fast":
                for name in FOLD_KERNELS["fast"]:
                    launches[name] = counts[name]
    finally:
        if prev is None:
            os.environ.pop("VQ_GNN_REV_FOLD", None)
        else:
            os.environ["VQ_GNN_REV_FOLD"] = prev
    log(f"[10c] test accuracy x2 {accs['x2']:.4f} fast {accs['fast']:.4f} (fast - x2 "
        f"{accs['fast'] - accs['x2']:+.4f}) | {gpu}")
    assert all(0.0 < a <= 1.0 for a in accs.values())


def row6_device_ms(prof, steps=3):
    """Row 6's device ms per step in a profile (its two device kernels:
    the assign pass and the reduction of its partials), or None."""
    if prof is None:
        return None
    return sum(us for us, _, k in prof["rows"]
               if "assign_fast_kernel" in k or "assign_kernel" in k
               or "reduce_partials_kernel" in k) / steps / 1e3


def snapshot_vq(torch, states):
    """Copies of every tensor of each VQState (for a before/after check)."""
    return [{f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)} for s in states]


def small_options_compare(Config, NodeTrainer, prepare, synthetic_sbm, gpu, device="cuda"):
    """13d: the B + M GAT path with the transformer, dropbranch 0.5 and alpha
    dropout 0.5 on a 3,000-node graph, on the card and on the CPU (plain
    versions) from one state (the CPU's init sweep carried to the card) and
    with one set of masks: one forward + loss with its gradients, then one
    train_step.  Exact f32 (no TF32, the exact VQ distances).  ``device`` is
    the card's side."""
    import torch
    from vq_gnn_tpu_torch.nn.model import model_forward, zero_probes, zero_probes_tr
    from vq_gnn_tpu_torch.train.step import draw_branch_masks, masked_ce

    cfg = bm_cfg(Config, num_M=64, batch_size=1000, test_batch_size=1500, walk_length=2,
                 matmul_precision="highest", vq_backend="pallas", transformer_flag=True,
                 dropbranch=0.5, alpha_dropout_flag=True, dropout=0.5)
    gs, cs = synthetic_sbm(num_nodes=3000, num_classes=N_CLASSES, num_features=N_FEAT,
                           avg_degree=AVG_DEG, seed=1)
    gs, cs, cis = prepare(gs, cfg, cs)
    trs = {"cuda": NodeTrainer(gs, cfg, cs, cis, device=device),
           "cpu": NodeTrainer(gs, cfg, cs, cis, device="cpu")}
    trs["cpu"].run_init_sweep()
    cpu_state, gpu_state = trs["cpu"].state, trs["cuda"].state
    for name in ("vq_states", "vq_states_tr"):
        setattr(gpu_state, name, [dataclasses.replace(s, **{
            f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)})
            for s in getattr(cpu_state, name)])
    batches = {key: next(iter(tr.train_loader))[0][0] for key, tr in trs.items()}
    bc = batches["cpu"]
    gen = torch.Generator().manual_seed(13)
    masks = draw_branch_masks(trs["cpu"].ms, gen)
    keeps = [torch.rand((bc.B_pad, c), generator=gen) < 1.0 - cfg.dropout
             for c in trs["cpu"].ms.channels[1:-1]]

    def on(dev, ts):
        return [t.to(dev) for t in ts]

    res = {}
    for key, tr in trs.items():
        b, ms, dev = batches[key], tr.ms, tr.device
        probes = zero_probes(ms, b.B_pad, dev)
        probes_tr = zero_probes_tr(ms, b.B_pad, dev)
        params = list(tr.state.model.parameters())
        out, info, _, _ = model_forward(
            tr.state.model, tr.state.vq_states, tr.state.bn_state, ms,
            tr.X_dev.index_select(0, b.batch_idx), b, probes=probes, warm_up_rate=1.0,
            training=True, vq_states_tr=tr.state.vq_states_tr, probes_tr=probes_tr,
            branch_masks=on(dev, masks), dropout_keeps=on(dev, keeps))
        loss = masked_ce(out, b.y, b.train_mask & b.valid_B) + info
        grads = torch.autograd.grad(loss, params + probes + probes_tr)
        before = snapshot_vq(torch, tr.state.vq_states + tr.state.vq_states_tr)
        _, m = tr.fns.train_step(tr.state, tr.X_dev, b, 1.0, cfg.lr, 1.0,
                                 branch_masks=on(dev, masks), dropout_keeps=on(dev, keeps))
        res[key] = dict(loss=float(loss.detach()), grads=[g.cpu() for g in grads], m=m,
                        before=before,
                        after=snapshot_vq(torch, tr.state.vq_states + tr.state.vq_states_tr))
    rg, rc = res["cuda"], res["cpu"]
    d_loss = abs(rg["loss"] - rc["loss"]) / max(1.0, abs(rc["loss"]))
    d_grad = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(rg["grads"], rc["grads"], strict=True))
    d_m = {k: abs(float(rg["m"][k]) - float(rc["m"][k])) / max(1.0, abs(float(rc["m"][k])))
           for k in ("loss", "loss_cls", "info_backward", "grad_norm")}
    n_lists = cfg.num_layers
    agree, untouched = [], True
    for i, (ag, ac) in enumerate(zip(rg["after"], rc["after"], strict=True)):
        agree.append(float((ag["c_indices"].cpu() == ac["c_indices"]).float().mean()))
        keep = masks[i % n_lists]
        for key in ("cuda", "cpu"):
            b4, af = res[key]["before"][i], res[key]["after"][i]
            for f, v in af.items():
                if v.dim() >= 1 and f != "c_indices":
                    untouched &= all(torch.equal(v[k], b4[f][k])
                                     for k in torch.nonzero(~keep).flatten().tolist())
            untouched &= all(torch.equal(af["c_indices"][:, k], b4["c_indices"][:, k])
                             for k in torch.nonzero(~keep).flatten().tolist())
    log(f"[13d small graph] B + M GAT, transformer, dropbranch 0.5, alpha dropout 0.5, B_pad "
        f"{bc.B_pad}, masks kept per layer {[int(k.sum()) for k in masks]} of "
        f"{[k.numel() for k in masks]}: forward + loss cuda {rg['loss']:.6f} cpu "
        f"{rc['loss']:.6f} (rel diff {d_loss:.2e}); every gradient (parameters, probes, the "
        f"transformer's probes) max|diff| / max(1, max|cpu|) {d_grad:.2e}; train_step metrics "
        f"rel diff {({k: f'{v:.2e}' for k, v in d_m.items()})}; codeword assignments that agree "
        f"after the step, per codebook list {[round(a, 4) for a in agree]}; dropped branches "
        f"bit-identical on both devices {untouched}; tolerance 1e-4 | {gpu}")
    assert d_loss < 1e-4 and d_grad < 1e-4 and max(d_m.values()) < 1e-4
    assert min(agree) >= 0.99 and untouched


def options_phase(torch, ops, NodeTrainer, Config, graphs, gpu, err, kern, runs, prepare,
                  synthetic_sbm, keep):
    """Phase 13: the model options through the trainer on phase 2's graphs
    (the module docstring says what it runs).  Adds the row of kernel 2 at
    the transformer codebook's shape to ``kern`` and ``err``, and 13a's
    transformer trainer to ``keep`` (phase 17's ``GCN-bm-tr``); returns the
    launch counts of its paths, with that row's under its name."""
    from vq_gnn_tpu_torch.train.step import draw_branch_masks

    out = {}
    # 13a: GCN B + M at the bench's cell, without and with the transformer
    tr_emb = {}

    def keep_tr_init(tr):
        tr_emb["init"] = [s.embedding_output.clone() for s in tr.state.vq_states_tr]

    cfg_a = bm_cfg(Config, conv_type="GCN", ell_K=8)
    r0 = drive_path(torch, ops, NodeTrainer, "13a GCN-bm", graphs["GCN-bm"], cfg_a, gpu,
                    NEW_TIMED_STEPS, profile=True, evaluate=False, kernels=PATH_KERNELS["GCN"],
                    windows=OPTIONS_WINDOWS)
    ra = drive_path(torch, ops, NodeTrainer, "13a GCN-bm transformer", graphs["GCN-bm"],
                    dataclasses.replace(cfg_a, transformer_flag=True), gpu, NEW_TIMED_STEPS,
                    profile=True, evaluate=True, kernels=PATH_KERNELS["GCN"],
                    on_init=keep_tr_init)
    tr = ra["tr"]
    moved = [not torch.equal(s.embedding_output, e0)
             for s, e0 in zip(tr.state.vq_states_tr, tr_emb["init"], strict=True)]
    assign_steps = (r0["per_step"]["vq_assign"], ra["per_step"]["vq_assign"])
    log(f"[13a] row 6 launches per step without / with the transformer {assign_steps}, by width "
        f"K on the transformer path {ra['assign_by_k']}; transformer codebooks moved in the "
        f"epoch and the timed steps: {moved}")
    assert assign_steps == (3, 6) and all(moved)
    for tag, r in (("without", r0), ("with", ra)):
        log(f"[13a summary] GCN B + M {tag} the transformer: {r['ms']:.2f} ms/step (std "
            f"{r['std']:.2f}), edges/s {r['E_batch'] / (r['ms'] / 1e3):.4g}, row 6 device "
            f"{row6_device_ms(r['prof'])} ms/step, device busy "
            f"{None if r['prof'] is None else round(r['prof']['busy_ms'], 3)} ms/step, peak "
            f"{r['peak'] / 1e9:.3f} GB | {gpu}")
    # row 6 at the transformer codebook's shape on this batch
    vq = tr.state.vq_states_tr[1]
    nb, M, K = vq.embedding.shape
    key = f"vq_assign (transformer, nb={nb}, M={M}, K={K})"
    gen = torch.Generator(device="cuda").manual_seed(13)
    b0 = ra["batch0"]
    xn = torch.randn((nb, b0.B_pad, K), generator=gen, device="cuda")
    emb = vq.embedding.contiguous()
    hold_assign(torch, 13, "transformer vq_update", xn, emb, b0.valid_B.contiguous(), err,
                key=key, chunk=branch_chunk(b0.B_pad, M))
    t, b_ms, b_by, _ = assign_times(torch, 13, key, xn, emb, b0.valid_B.contiguous(), gpu,
                                    chunk=branch_chunk(b0.B_pad, M))
    kern[key] = dict(source="vq_gnn_tpu_torch/csrc/vq_assign.cu",
                     replaces="vq_gnn_tpu/ops/pallas_vq.py:140", **t, bound_ms=b_ms,
                     bound_by=b_by)
    for r in (r0, ra):
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    out[key] = ra["assign_by_k"].get(K, 0)
    keep["GCN-bm-tr"] = tr
    del r0, ra, tr

    # 13b: GAT B + M, K = 2, bf16, with the transformer and dropbranch 0.5
    rb = drive_path(torch, ops, NodeTrainer, "13b GAT-bm-bf16 transformer dropbranch",
                    graphs["GAT-bm"], bm_cfg(Config, compute_dtype="bfloat16",
                                             transformer_flag=True, dropbranch=0.5), gpu,
                    NEW_TIMED_STEPS, profile=True, evaluate=True,
                    kernels=PATH_KERNELS["GAT-bm-bf16"], windows=OPTIONS_WINDOWS)
    r3 = runs["3 GAT-bm-bf16"]
    log(f"[13b summary] GAT B + M bf16: phase 3 (no options) {r3['ms']:.2f} ms/step, peak "
        f"{r3['peak'] / 1e9:.3f} GB; with the transformer and dropbranch 0.5 {rb['ms']:.2f} "
        f"ms/step, edges/s {rb['E_batch'] / (rb['ms'] / 1e3):.4g}, row 6 device "
        f"{row6_device_ms(rb['prof'])} ms/step at {rb['per_step']['vq_assign']} launches, peak "
        f"{rb['peak'] / 1e9:.3f} GB | {gpu}")
    assert rb["per_step"]["vq_assign"] == 6
    for k, v in rb["launches"].items():
        out[k] = out.get(k, 0) + v
    del rb

    # 13c: the flagship GCN B + B' with dropbranch 0.5 and alpha dropout 0.5
    rc = drive_path(torch, ops, NodeTrainer, "13c GCN dropbranch alpha-dropout", graphs["GCN"],
                    flagship_cfg(Config, dropbranch=0.5, alpha_dropout_flag=True, dropout=0.5),
                    gpu, NEW_TIMED_STEPS, profile=False, evaluate=False,
                    kernels=PATH_KERNELS["GCN"])
    tr, b0 = rc["tr"], rc["batch0"]
    r3 = runs["3 GCN"]
    log(f"[13c summary] GCN B + B': phase 3 (no options) {r3['ms']:.2f} ms/step, peak "
        f"{r3['peak'] / 1e9:.3f} GB; with dropbranch 0.5 and alpha dropout 0.5 {rc['ms']:.2f} "
        f"ms/step, edges/s {rc['E_batch'] / (rc['ms'] / 1e3):.4g}, peak "
        f"{rc['peak'] / 1e9:.3f} GB | {gpu}")
    masks = draw_branch_masks(tr.ms, tr.generator, torch.device("cuda"))
    kept = [int(m.sum()) for m in masks]
    before = snapshot_vq(torch, tr.state.vq_states)
    ops.reset_launch_counts()
    tr.state, m = tr.fns.train_step(tr.state, tr.X_dev, b0, 1.0, tr.cfg.lr, 1.0, tr.generator,
                                    branch_masks=masks)
    torch.cuda.synchronize()
    after = snapshot_vq(torch, tr.state.vq_states)
    same, moved = [], []
    for keep, b4, af in zip(masks, before, after, strict=True):
        drop = torch.nonzero(~keep).flatten().tolist()
        kept_b = torch.nonzero(keep).flatten().tolist()
        same.append(all(torch.equal(af[f][k], b4[f][k]) for f in af if af[f].dim() >= 1
                        and f != "c_indices" for k in drop)
                    and all(torch.equal(af["c_indices"][:, k], b4["c_indices"][:, k])
                            for k in drop))
        moved.append(all(not torch.equal(af["embedding"][k], b4["embedding"][k])
                         for k in kept_b))
    log(f"[13c dropbranch] one step on the card, branches kept per layer {kept} of "
        f"{list(tr.ms.num_branches)}: dropped branches' codebook, EMA accumulators, BN "
        f"statistics and c_indices column bit-identical {same}; every kept branch's codebook "
        f"moved {moved}; loss {float(m['loss']):.4f}")
    assert kept == [nb // 2 for nb in tr.ms.num_branches] and all(same) and all(moved)
    for k, v in rc["launches"].items():
        out[k] = out.get(k, 0) + v
    counts = ops.launch_counts()
    for k, v in counts.items():
        out[k] = out.get(k, 0) + v
    del rc, tr

    # 13d: the card against the CPU on a small graph, masks fixed
    t0 = time.time()
    small_options_compare(Config, NodeTrainer, prepare, synthetic_sbm, gpu)
    log(f"[13d] {time.time() - t0:.1f}s")
    return out


def first_step_vs_single_k(torch, ops, tag, tr, graph, gpu):
    """From the trainer's state after its init sweep, one train_step on the
    first batch of a fresh loader of its layout and one on the same nodes in
    the single-K layout, each from a copy of that state: the losses within
    1e-5 relative (only the order of the f32 sums differs)."""
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader

    g, _, ci = graph
    cfg_single = dataclasses.replace(tr.cfg, spmm_backend="ell", ell_Kt=0)
    losses = {}
    with ops.uncounted():
        for name, cfg_l in (("layout", tr.cfg), ("single-K", cfg_single)):
            loader = BatchLoader(g, cfg_l, train_flag=True, cluster_indices=ci, seed=cfg_l.seed,
                                 device="cuda")
            b = loader._to_device(next(loader._epoch_iter()))[0][0]
            state = copy.deepcopy(tr.state)
            _, m = tr.fns.train_step(state, tr.X_dev, b, 1.0, cfg_l.lr, 1.0,
                                     torch.Generator(device="cuda").manual_seed(5))
            losses[name] = (float(m["loss"]), int(b.num_B))
            del state, b
    (la, na), (ls, ns) = losses["layout"], losses["single-K"]
    rel = abs(la - ls) / abs(ls)
    log(f"[{tag} vs single-K] first step from one state on the same {na} nodes: loss {la:.7f}, "
        f"single-K {ls:.7f}, rel diff {rel:.2e} (tolerance 1e-5) | {gpu}")
    assert na == ns and rel <= 1e-5, (la, ls)


def path_summary(tag, r, gpu):
    prof = r["prof"]
    busy = "not measured" if prof is None else f"{prof['busy_ms']:.3f}"
    idle = ("not measured" if prof is None
            else f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} %")
    log(f"[{tag} summary] {r['ms']:.2f} ms/step (std {r['std']:.2f}), edges/s "
        f"{r['E_batch'] / (r['ms'] / 1e3):.4g} at E={r['E_batch']}, device busy {busy} ms/step, "
        f"idle {idle}, peak {r['peak'] / 1e9:.3f} GB above the earlier phases' | {gpu}")


def mixed_family_calls(torch, e, C, gen):
    """Kernel 1's calls on a mixed batch, as ``spmm`` makes them: (label,
    args, kwargs) of the head and tail forward and, under the batch's
    truncation, the head and tail dx prefixes (the tail's rows clamped to
    b_rows)."""
    from vq_gnn_tpu_torch.ops.spmm import mixed_truncated

    R = e.num_rows
    x = torch.randn((R, C), generator=gen, device="cuda")
    g = torch.randn((R, C), generator=gen, device="cuda")
    calls = [("head forward", (x, e.head_rowc, e.head_col, e.head_val, R),
              dict(ptr=e.head_ptr, long_rows=e.head_long_rows)),
             ("tail forward", (x, e.tail_row, e.tail_col, e.tail_val, R),
              dict(ptr=e.tail_ptr, long_rows=e.tail_long_rows))]
    assert mixed_truncated(e), "the training batch has no truncated backward"
    tbh, tbt, b = e.t_head_b_slots, e.t_tail_b_slots, e.b_rows
    calls += [("head dx", (g, e.t_head_rowc[:tbh], e.t_head_col[:tbh], e.t_head_val[:tbh], R),
               dict(ptr=e.t_head_ptr, long_rows=e.t_head_long_rows)),
              ("tail dx", (g, torch.clamp(e.t_tail_row[:tbt], max=b), e.t_tail_col[:tbt],
                           e.t_tail_val[:tbt], b),
               dict(ptr=e.t_tail_ptr, long_rows=e.t_tail_long_rows))]
    return calls


def scalar_family_calls(torch, e, C, gen):
    """Kernel 8's calls with the scalar channel on a mixed batch, as the
    mixed GAT conv makes them: (label, (partials, seg, R), scalar partials,
    lists) of each forward family and each whole transposed family.  The
    padding slots' partials are 0, as the conv's are (their values are 0):
    the head's carry a real compact row, which its lists leave out."""
    R = e.num_rows
    out = []
    for label, rows, ptr, lr in (
            ("head forward", e.head_rowc, e.head_ptr, e.head_long_rows),
            ("tail forward", e.tail_row, e.tail_ptr, e.tail_long_rows),
            ("head transposed", e.t_head_rowc, e.t_head_all_ptr, e.t_head_all_long_rows),
            ("tail transposed", e.t_tail_row, e.t_tail_all_ptr, e.t_tail_all_long_rows)):
        S = rows.shape[0]
        live = (torch.arange(S, device="cuda") < ptr[-1]).float()
        out.append((label, (torch.randn((S, C), generator=gen, device="cuda") * live[:, None],
                            rows, R),
                    torch.randn((S,), generator=gen, device="cuda") * live,
                    dict(ptr=ptr, long_rows=lr)))
    return out


def coo_sum_calls(torch, e, C, gen):
    """Kernel 8's calls on a COO batch, as ``spmm`` makes them: (label,
    (messages, rows, R), None, lists) of the forward over the row-sorted
    edges and of the dx over the tperm-sorted ones (rows ``col[tperm]``; a
    row shard's transposed edges, over its batch columns),
    with random messages C wide (nb * (D + 1) for the B + M branch sum),
    zero on the padding edges (row = col = num_rows, val = 0) as the path's
    are."""
    R = e.num_rows
    # a row shard's (parallel/mesh.py:ShardEdges) transposed edges are kept
    # apart, over its batch columns
    t_rows, Rt = ((e.col.index_select(0, e.tperm.long()), R) if e.tperm is not None
                  else (e.t_row, e.b_rows))
    out = []
    for label, rows, n, ptr, lr in (
            ("forward", e.row, R, e.row_ptr, e.row_long_rows),
            ("transposed", t_rows, Rt, e.t_row_ptr, e.t_row_long_rows)):
        live = (rows < n).float()
        msgs = torch.randn((rows.shape[0], C), generator=gen, device="cuda") * live[:, None]
        out.append((label, (msgs, rows.contiguous(), n), None, dict(ptr=ptr, long_rows=lr)))
    return out


def hold_segment_sums(torch, tag, calls, err, key):
    """Kernel 8 against its plain version on each (label, args, scalar
    partials or None, lists) call: every output within 1e-5 of max(1,
    max|ref|) (f32 sums in another order), two calls bit-identical; the
    largest error into ``err[key]``."""
    from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, segment_sum_sorted_plain

    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    for label, args, scal, kw in calls:
        sc = {} if scal is None else dict(scalar_partials=scal)
        o, again = (outs(segment_sum_sorted(*args, **sc, **kw)) for _ in range(2))
        ref = outs(segment_sum_sorted_plain(*args, **sc))
        torch.cuda.synchronize()
        d = max(float((a - b).abs().max()) for a, b in zip(o, ref, strict=True))
        tol = 1e-5 * max(1.0, *(float(b.abs().max()) for b in ref))
        same = all(torch.equal(a, b) for a, b in zip(o, again, strict=True))
        log(f"[{tag} {label}] S={args[1].shape[0]} rows {args[2]} C={args[0].shape[1]}"
            f"{' + the scalar' if sc else ''}: live slots ptr[R]={int(kw['ptr'][-1])}, "
            f"{kw['long_rows'].shape[0] - 1} long rows; max|err| {d:.3g} (tol {tol:.3g}); two "
            f"calls bit-identical: {same}")
        assert all(bool(torch.isfinite(a).all()) for a in o) and d <= tol and same
        err[key] = max(err.get(key, 0.0), d)


def small_layout_compare(Config, NodeTrainer, prepare, synthetic_sbm, gpu, tag, cfg):
    """14e: a 3,000-node graph through one layout's path on the card and on
    the CPU (plain versions) from one state (the CPU's init sweep carried to
    the card): one forward + loss with its gradients, then one train_step.
    Exact f32 (no TF32, the exact VQ distances).  The loss and every
    gradient within 1e-6 of max(1, max|cpu|), the assignments after the
    step >= 99 % equal."""
    import torch
    from vq_gnn_tpu_torch.nn.model import model_forward, zero_probes
    from vq_gnn_tpu_torch.train.step import masked_ce

    gs, cs = synthetic_sbm(num_nodes=3000, num_classes=N_CLASSES, num_features=N_FEAT,
                           avg_degree=AVG_DEG, seed=1)
    gs, cs, cis = prepare(gs, cfg, cs)
    trs = {"cuda": NodeTrainer(gs, cfg, cs, cis, device="cuda"),
           "cpu": NodeTrainer(gs, cfg, cs, cis, device="cpu")}
    trs["cpu"].run_init_sweep()
    trs["cuda"].state.vq_states = [dataclasses.replace(s, **{
        f.name: getattr(s, f.name).to("cuda") for f in dataclasses.fields(s)})
        for s in trs["cpu"].state.vq_states]
    res = {}
    for key, tr in trs.items():
        b = next(iter(tr.train_loader))[0][0]
        probes = zero_probes(tr.ms, b.B_pad, tr.device)
        params = list(tr.state.model.parameters())
        out, info, _, _ = model_forward(
            tr.state.model, tr.state.vq_states, tr.state.bn_state, tr.ms,
            tr.X_dev.index_select(0, b.batch_idx), b, probes=probes, warm_up_rate=1.0,
            training=True)
        loss = masked_ce(out, b.y, b.train_mask & b.valid_B) + info
        grads = torch.autograd.grad(loss, params + probes)
        _, m = tr.fns.train_step(tr.state, tr.X_dev, b, 1.0, cfg.lr, 1.0)
        res[key] = dict(loss=float(loss.detach()), grads=[g.cpu() for g in grads], m=m,
                        codes=[s.c_indices.cpu() for s in tr.state.vq_states], B_pad=b.B_pad)
    rg, rc = res["cuda"], res["cpu"]
    d_loss = abs(rg["loss"] - rc["loss"]) / max(1.0, abs(rc["loss"]))
    d_grad = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(rg["grads"], rc["grads"], strict=True))
    d_m = {k: abs(float(rg["m"][k]) - float(rc["m"][k])) / max(1.0, abs(float(rc["m"][k])))
           for k in ("loss", "loss_cls", "info_backward")}
    agree = [float((a == b).float().mean()) for a, b in zip(rg["codes"], rc["codes"])]
    log(f"[14e small graph {tag}] B_pad {rc['B_pad']}: forward + loss cuda {rg['loss']:.7f} cpu "
        f"{rc['loss']:.7f} (rel diff {d_loss:.2e}); every gradient (parameters, probes) "
        f"max|diff| / max(1, max|cpu|) {d_grad:.2e}; train_step metrics rel diff "
        f"{({k: f'{v:.2e}' for k, v in d_m.items()})}; codeword assignments that agree after "
        f"the step {[round(a, 4) for a in agree]}; tolerance 1e-6 | {gpu}")
    assert d_loss < 1e-6 and d_grad < 1e-6 and max(d_m.values()) < 1e-6 and min(agree) >= 0.99


def layouts_phase(torch, ops, NodeTrainer, Config, graphs, gpu, err, kern, runs, prepare,
                  synthetic_sbm, keep):
    """Phase 14: the two other adjacency layouts through the trainer on
    phase 2's graphs (the module docstring says what it runs).  Adds the
    sub-rows of kernel 1 on the mixed families and kernel 8's scalar channel
    to ``kern`` and ``err``, and 14d's trainer to ``keep`` (phase 17's
    ``GAT-bm-coo``); returns the launch counts of its paths, with the mixed
    sub-row's under its name."""
    from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate, ell_aggregate_plain
    from vq_gnn_tpu_torch.ops.segsum import segment_sum_sorted, segment_sum_sorted_plain

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(14)

    def add(launches):
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v

    def check_first_step(tag, graph):
        return lambda tr: first_step_vs_single_k(torch, ops, tag, tr, graph, gpu)

    # 14a: the flagship GCN B + B' on the mixed-K layout, K = 8 + 2
    ra = drive_path(torch, ops, NodeTrainer, "14a GCN mixed", graphs["GCN"],
                    flagship_cfg(Config, ell_Kt=2), gpu, NEW_TIMED_STEPS, profile=True,
                    evaluate=False, kernels=LAYOUT_KERNELS["14a"],
                    on_init=check_first_step("14a", graphs["GCN"]))
    path_summary("14a GCN mixed", ra, gpu)
    e = ra["batch0"].edges
    C = ra["tr"].cfg.hidden_channels
    calls = mixed_family_calls(torch, e, C, gen)
    for label, args, kw in calls:
        o, again, ref = ell_aggregate(*args, **kw), ell_aggregate(*args, **kw), \
            ell_aggregate_plain(*args)
        torch.cuda.synchronize()
        d = float((o - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        same = torch.equal(o, again)
        log(f"[14a ell_aggregate {label}] S={args[2].shape[0]} K={args[2].shape[1]} rows "
            f"{args[4]} C={C}: max|err| {d:.3g} (tol {tol:.3g}); {kw['long_rows'].shape[0] - 1} "
            f"long rows; two calls bit-identical: {same}")
        assert torch.isfinite(o).all() and d <= tol and same
        err[MIXED_ROW] = max(err.get(MIXED_ROW, 0.0), d)
    # the row: the forward's two family calls; the library the same product
    # as one CSR torch.sparse.mm
    (_, fh, kh), (_, ft, kt) = calls[:2]
    R = e.num_rows
    x = fh[0]
    cells = [live_cells(f[1], f[3], R) for f in (fh, ft)]
    rows_g = torch.cat([torch.repeat_interleave(e.head_rowg.long(), fh[2].shape[1]),
                        torch.repeat_interleave(e.tail_row.long(), ft[2].shape[1])])
    cols_g = torch.cat([fh[2].reshape(-1), ft[2].reshape(-1)]).long()
    vals_g = torch.cat([fh[3].reshape(-1), ft[3].reshape(-1)])
    live = (vals_g != 0) & (rows_g < R)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(torch.stack([rows_g[live], cols_g[live]]), vals_g[live],
                                      (R, R)).coalesce().to_sparse_csr()

    def fwd():
        return ell_aggregate(*fh, **kh), ell_aggregate(*ft, **kt)

    t = {"ms": cuda_time_ms(torch, fwd),
         "plain_ms": cuda_time_ms(torch, lambda: (ell_aggregate_plain(*fh),
                                                  ell_aggregate_plain(*ft)), reps=5),
         "library_ms": cuda_time_ms(torch, lambda: torch.sparse.mm(csr, x))}
    n_head = int((torch.diff(e.head_ptr) > 0).sum())  # the compact rows with a head slot
    in_bytes = R * C * 4 + sum(f[1].shape[0] * 4 + 2 * f[2].numel() * 4 for f in (fh, ft))
    b_ms, b_by = bound(in_bytes + (n_head + R) * C * 4, 2 * sum(cells) * C, F32_FLOPS)
    split = kernel_split(torch, fwd)
    fold_ms = cuda_time_ms(torch, lambda: ell_aggregate(*ft, **kt).add_(
        torch.cat([ell_aggregate(*fh, **kh), x.new_zeros((1, C))]).index_select(
            0, e.head_inv.long())))
    log(f"[14a ell_aggregate mixed forward] head S={fh[2].shape[0]} x K={fh[2].shape[1]}, tail "
        f"S={ft[2].shape[0]} x Kt={ft[2].shape[1]}, live cells {cells}, C={C}: {t}; bound "
        f"{b_ms:.4f} ms ({b_by}); device us per call {split}; with the head's fold and the add "
        f"(spmm's forward) {fold_ms:.4f} ms | {gpu}")
    kern[MIXED_ROW] = dict(source="vq_gnn_tpu_torch/csrc/ell_aggregate.cu",
                           replaces="vq_gnn_tpu/ops/pallas_ell.py:111", **t, bound_ms=b_ms,
                           bound_by=b_by)
    add(ra["launches"])
    out[MIXED_ROW] = ra["launches"]["ell_aggregate"]
    del ra, calls, csr, x, fh, ft

    # 14b: GAT B + B' at bf16 on the mixed-K layout: kernel 8 per family,
    # with its scalar channel
    rb = drive_path(torch, ops, NodeTrainer, "14b GAT-bf16 mixed", graphs["GAT"],
                    flagship_cfg(Config, conv_type="GAT", compute_dtype="bfloat16", ell_Kt=2),
                    gpu, NEW_TIMED_STEPS, profile=True, evaluate=False,
                    kernels=LAYOUT_KERNELS["14b"], on_init=check_first_step("14b", graphs["GAT"]))
    path_summary("14b GAT-bf16 mixed", rb, gpu)
    for name in ("gat_aggregate", "gat_backward", "gat_aggregate_bf16", "gat_backward_bf16"):
        assert rb["launches"][name] == 0, f"{name} ran on the mixed GAT path"
    e = rb["batch0"].edges
    C = rb["tr"].cfg.hidden_channels
    scal_calls = scalar_family_calls(torch, e, C, gen)
    hold_segment_sums(torch, "14b segment_sum scalar", scal_calls, err, "segment_sum_scalar")
    fams = scal_calls[:2]  # the forward's two family sums

    def seg_fwd():
        return [segment_sum_sorted(*a, scalar_partials=sc, **kw) for _, a, sc, kw in fams]

    bufs = [(torch.zeros((a[2] + 1, C + 1), device="cuda"),
             torch.cat([a[0], sc[:, None]], 1), a[1].long()) for _, a, sc, _ in fams]
    t = {"ms": cuda_time_ms(torch, seg_fwd),
         "plain_ms": cuda_time_ms(torch, lambda: [segment_sum_sorted_plain(
             *a, scalar_partials=sc) for _, a, sc, _ in fams]),
         "library_ms": cuda_time_ms(torch, lambda: [buf.index_add_(0, sg, ps)
                                                    for buf, ps, sg in bufs])}
    # per family: the live slots' partials and scalars, the offsets and long
    # rows read once, both outputs written once; one add a value
    n_live = [int(kw["ptr"][-1]) for _, _, _, kw in fams]
    lists_b = sum((kw["ptr"].numel() + kw["long_rows"].numel()) * 4 for _, _, _, kw in fams)
    b_ms, b_by = bound(sum(n * (C + 1) * 4 for n in n_live) + lists_b
                       + sum(a[2] * (C + 1) * 4 for _, a, _, _ in fams),
                       sum(n * (C + 1) for n in n_live), F32_FLOPS)
    log(f"[14b segment_sum scalar forward] head and tail families, live slots {n_live}, C={C} "
        f"+ the scalar: {t}; bound {b_ms:.4f} ms ({b_by}); device us per call "
        f"{kernel_split(torch, seg_fwd)}; the library two index_add_ calls on [S, C + 1] | {gpu}")
    kern["segment_sum_scalar"] = dict(source="vq_gnn_tpu_torch/csrc/segment_sum.cu",
                                      replaces="vq_gnn_tpu/ops/pallas_segsum.py:107", **t,
                                      bound_ms=b_ms, bound_by=b_by)
    add(rb["launches"])
    del rb, scal_calls, fams, bufs

    # 14c: the flagship GCN B + B' on COO: kernel 8, forward and transposed
    rc = drive_path(torch, ops, NodeTrainer, "14c GCN coo", graphs["GCN"],
                    flagship_cfg(Config, spmm_backend="coo"), gpu, NEW_TIMED_STEPS,
                    profile=True, evaluate=False, kernels=LAYOUT_KERNELS["14c"],
                    on_init=check_first_step("14c", graphs["GCN"]))
    path_summary("14c GCN coo", rc, gpu)
    assert rc["launches"]["ell_aggregate"] == 0, "kernel 1 ran on the COO path"
    # kernel 8 at the batch's shapes: the forward over the padded edges, the
    # dx over the tperm-sorted ones, both at the layers' width
    hold_segment_sums(torch, "14c segment_sum coo", coo_sum_calls(
        torch, rc["batch0"].edges, rc["tr"].cfg.hidden_channels, gen), err, "segment_sum")
    add(rc["launches"])
    del rc

    # 14d: GAT B + M f32 at the bench's cell on COO: the per-branch fallback
    # and the recovery term's grid path
    rd = drive_path(torch, ops, NodeTrainer, "14d GAT-bm coo", graphs["GAT-bm"],
                    bm_cfg(Config, spmm_backend="coo"), gpu, NEW_TIMED_STEPS, profile=True,
                    evaluate=False, kernels=LAYOUT_KERNELS["14d"])
    path_summary("14d GAT-bm coo", rd, gpu)
    for name in ("rev_forward", "rev_backward", "ell_aggregate"):
        assert rd["launches"][name] == 0, f"{name} ran on the B + M COO path"
    # kernel 8 at the branch sum's shapes: every branch's D + 1 columns side
    # by side, forward and transposed
    cfg_d = rd["tr"].cfg
    hold_segment_sums(torch, "14d segment_sum coo branches", coo_sum_calls(
        torch, rd["batch0"].edges, cfg_d.hidden_channels // cfg_d.num_D * (cfg_d.num_D + 1),
        gen), err, "segment_sum")
    r3 = runs.get("3 GAT-bm")
    if r3 is not None:
        log(f"[14d beside phase 3] GAT B + M f32 on the single-K ELL {r3['ms']:.2f} ms/step, "
            f"peak {r3['peak'] / 1e9:.3f} GB | {gpu}")
    add(rd["launches"])
    keep["GAT-bm-coo"] = rd["tr"]
    del rd

    # 14e: the card against the CPU on a small graph, each layout's path
    small = dict(num_M=64, matmul_precision="highest", vq_backend="pallas")
    for tag, cfg in (
            ("GCN mixed", flagship_cfg(Config, num_parts=8, batch_size=4, test_batch_size=4,
                                       ell_Kt=2, **small)),
            ("GAT mixed", flagship_cfg(Config, conv_type="GAT", num_parts=8, batch_size=4,
                                       test_batch_size=4, ell_Kt=2, **small)),
            ("GCN coo", flagship_cfg(Config, num_parts=8, batch_size=4, test_batch_size=4,
                                     spmm_backend="coo", **small)),
            ("GAT-bm coo", bm_cfg(Config, batch_size=1000, test_batch_size=1500,
                                  walk_length=2, spmm_backend="coo", **small))):
        t0 = time.time()
        small_layout_compare(Config, NodeTrainer, prepare, synthetic_sbm, gpu, tag, cfg)
        log(f"[14e {tag}] {time.time() - t0:.1f}s")
    return out


def ddp_phase(torch, ops, runs, graphs, gpu, err):
    """Phase 15: the data-parallel step (``parallel/multihost.py``) on an
    NCCL group of one rank at the flagship widths, against ``train_step``
    (the module docstring says what it runs).  Returns its launch counts."""
    import torch.distributed as dist

    from vq_gnn_tpu_torch.parallel import init_distributed, make_ddp_step, make_mesh
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader
    from vq_gnn_tpu_torch.train.step import make_step_fns

    t0 = time.time()
    init_distributed("nccl")  # one rank, tcp://localhost:<a free port>
    mesh = make_mesh(1)
    tr = runs["3 GCN"]["tr"]
    g, _, ci = graphs["GCN"]
    N = g.num_nodes
    hw = tr.train_loader  # its high-water buckets over phase 3's batches
    cfg_b = tr.cfg
    cfg = dataclasses.replace(cfg_b, fixed_B_pad=hw._B_bucket, fixed_Bp_pad=hw._Bp_bucket,
                              fixed_E_pad=hw._E_bucket)
    # one epoch of the same node sets (seed and epoch of phase 3's first),
    # at the fixed pads and in the trainer's buckets
    fixed, bucketed = ([w[0] for w, _ in BatchLoader(g, c, train_flag=True, cluster_indices=ci,
                                                      seed=c.seed, device=mesh.device)]
                       for c in (cfg, cfg_b))
    log(f"[15 setup] NCCL group of {mesh.size} rank(s) on {mesh.device}; fixed pads B_pad "
        f"{cfg.fixed_B_pad} Bp_pad {cfg.fixed_Bp_pad} E_pad {cfg.fixed_E_pad}; an epoch of "
        f"{len(fixed)} batches in each padding built in {time.time() - t0:.1f}s")
    for tag, b in (("fixed", fixed[0]), ("bucketed", bucketed[0])):
        log(f"[15 batch {tag}] {batch_line(b, edge_count(b.edges))}")
    assert [b.num_B for b in fixed] == [b.num_B for b in bucketed]
    assert fixed[0].edges.b_rows == 0, "fixed pads keep the full transposed VJP"
    train_step = make_step_fns(tr.ms, cfg).train_step
    ddp = make_ddp_step(tr.ms, cfg, group=mesh.group)
    X, lr = tr.X_dev, cfg.lr

    # 15a: one step from one state on the same fixed-pad batch
    with ops.uncounted():
        sa, sb = copy.deepcopy(tr.state), copy.deepcopy(tr.state)
        _, ma = train_step(sa, X, fixed[0], 1.0, lr, 1.0)
        _, mb = ddp(sb, X, fixed[0], 1.0, lr, 1.0)
        torch.cuda.synchronize()
    la, lb = float(ma["loss"]), float(mb["loss"])
    rel = abs(la - lb) / max(abs(la), 1e-30)
    d_emb = max(float((a.embedding - b.embedding).abs().max())
                for a, b in zip(sa.vq_states, sb.vq_states))
    d_par = max(float((p.detach() - q.detach()).abs().max())
                for p, q in zip(sa.model.parameters(), sb.model.parameters()))
    agree = min(float((a.c_indices[:N] == b.c_indices[:N]).float().mean())
                for a, b in zip(sa.vq_states, sb.vq_states))
    log(f"[15a ddp vs train_step] one step from one state on the fixed-pad batch: loss "
        f"{lb:.7f} vs {la:.7f}, rel diff {rel:.3g} (tol 1e-6); codebooks max|diff| {d_emb:.3g} "
        f"(tol 0); parameters max|diff| {d_par:.3g} (tol 0); c_indices[:N] agree {agree:.6f} "
        f"(>= 0.9999) | {gpu}")
    assert rel <= 1e-6 and d_emb == 0 and d_par == 0 and agree >= 0.9999, \
        (rel, d_emb, d_par, agree)
    del sa, sb
    ddp.ledger.reset()

    # 15a': rows 1, 6 and 7 at the fixed pads' shapes, which no other phase
    # gives them: kernel 1's forward over S_pad slots (padding past the real
    # rows) and its dx over the whole transposed ELL, kernels 2 and 3 at B_pad
    b0 = fixed[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    C = cfg.hidden_channels
    vq1 = tr.state.vq_states[1]
    nb, M, K = vq1.embedding.shape
    with ops.uncounted():
        hold_ell(torch, 15, "ddp fixed pads", b0.edges, ((C, "forward"), (C, "dx full")), gen,
                 err)
        xn = torch.randn((nb, b0.B_pad, K), generator=gen, device="cuda")
        hold_assign(torch, 15, "ddp fixed pads vq_update", xn, vq1.embedding.contiguous(),
                    b0.valid_B.contiguous(), err, chunk=branch_chunk(b0.B_pad, M))
        hold_lookup(torch, 15, "ddp fixed pads", vq1, b0.fo_ids, cfg.num_D)
    del xn

    # 15b: 20 steps of each, from copies of one state
    def variant(tag, step, batches, counted):
        state = copy.deepcopy(tr.state)

        def one(b):
            nonlocal state
            state, m = step(state, X, b, 1.0, lr, 1.0)
            return m

        with ops.uncounted():  # warm-up
            for b in batches[:2]:
                one(b)
        base = new_path_start(torch, ops)
        ctx = contextlib.nullcontext() if counted else ops.uncounted()
        with ctx:
            times, losses = timed_steps(torch, one, batches, DDP_STEPS)
            prof = profile_steps(lambda i: one(batches[i % len(batches)]), log=log,
                                 tag=f"15 {tag}", gpu=gpu)
        peak = torch.cuda.max_memory_allocated() - base
        mean = sum(times) / len(times)
        std = (sum((t - mean) ** 2 for t in times) / max(len(times) - 1, 1)) ** 0.5
        busy = "not measured" if prof is None else f"{prof['busy_ms']:.3f}"
        idle = ("not measured" if prof is None
                else f"{100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f} %")
        log(f"[15b {tag}] {DDP_STEPS} steps: {mean:.2f} ms/step (std {std:.2f}, median "
            f"{sorted(times)[len(times) // 2]:.2f}), device busy {busy} ms/step, idle {idle}, "
            f"peak {peak / 1e9:.3f} GB above the earlier phases'; losses "
            f"{[round(x, 4) for x in losses[:4]]}... | {gpu}")
        assert all(math.isfinite(x) for x in losses)
        return dict(ms=mean, prof=prof, peak=peak)

    res = {"train_step bucketed": variant("train_step bucketed", train_step, bucketed, False),
           "train_step fixed": variant("train_step fixed", train_step, fixed, False)}
    res["ddp fixed"] = variant("ddp fixed", ddp, fixed, True)
    launches = ops.launch_counts()  # the data-parallel path's alone
    steps = DDP_STEPS + 3
    log("[15b summary] ms/step: " + ", ".join(f"{k} {v['ms']:.2f}" for k, v in res.items())
        + f"; phase 3's GCN {runs['3 GCN']['ms']:.2f}; launches per ddp step "
        f"{ {k: v / steps for k, v in launches.items() if v} } | {gpu}")

    # 15c: the path went through rows 1, 6 and 7 (counters, and the profile)
    prof = res["ddp fixed"]["prof"]
    for name, kernel in DDP_KERNELS.items():
        assert launches[name] > 0, f"kernel {name} was not launched on the data-parallel path"
        if prof is not None:
            assert any(kernel in k for _, _, k in prof["rows"]), f"{kernel} not in the profile"
    if prof is None:
        log("[15c] the profiler saw no device rows: the launch counters alone hold rows 1, 6, 7")

    # 15d: the collective ledger at these widths; no collective as large as
    # the feature table, a c_indices table or the batch's ELL columns
    led = ddp.ledger
    per = led.per_step()
    log(f"[15d ledger] {led.steps} steps; bytes per step {per['bytes']}; calls per step "
        f"{per['calls']}; {sum(per['bytes'].values()) / 1e6:.4f} MB a step in all")
    cidx = tr.state.vq_states[0].c_indices
    col = fixed[0].edges.ell_col
    cap = min(X.numel() * X.element_size(), cidx.numel() * cidx.element_size(),
              col.numel() * col.element_size())
    for kind in sorted(led.kinds):
        nbytes = sum(math.prod(s) for s in kind[3]) * torch.empty(0, dtype=getattr(
            torch, kind[2])).element_size()
        log(f"[15d ledger]   {kind}: {nbytes} B a call")
        assert nbytes < cap, f"a graph-sized collective payload {kind} ({nbytes} B, cap {cap} B)"
    dist.destroy_process_group()
    return launches


SHARDED_RANKS = 2  # phase 17: two ranks on the one card, over gloo
# phase 17's timed steps of each sharded step: on one card over gloo they
# time gloo's host copies, not the step, so a few suffice after the warm-up
SHARDED_STEPS = 2  # the flagship GCN
SHARDED_STEPS_BF16 = 2  # the bf16 sharded steps (GCN and GAT)
SHARDED_PROFILED = 1  # profiled steps after the timed ones (busy, the kernels' names)
# 17b: the kernels each family's sharded path launches on every rank (its
# f32 and bf16 cases together: rows 1 or 2-3 in both modes), launch counter
# -> device kernel, the name the profile of its timed steps must show
SHARDED_KERNELS = {
    "GCN": {"ell_aggregate": "ell_aggregate_kernel", "ell_aggregate_bf16": "ell_aggregate_kernel",
            "vq_assign": "assign_fast_kernel", "vq_lookup": "lookup_kernel"},
    # GCN at f16 compute (phase 3's trainer, its codebooks frozen: no row 6
    # on its steps): row 1's f16 mode
    "GCN-f16": {"ell_aggregate_f16": "ell_aggregate_kernel", "vq_lookup": "lookup_kernel"},
    "GAT": {"gat_aggregate": "gat_aggregate_kernel", "gat_aggregate_bf16": "gat_aggregate_kernel",
            "gat_backward": "gat_backward_kernel", "gat_backward_bf16": "gat_backward_kernel",
            "vq_assign": "assign_fast_kernel", "vq_lookup": "lookup_kernel"},
    # the other layouts: row 1 per mixed family (GCN), row 8 with its scalar
    # channel per mixed family (GAT at bf16), row 8 over the COO edges; the
    # exact-f32 families time row 6 in its exact mode
    "GCN-mixed": {"ell_aggregate": "ell_aggregate_kernel", "vq_assign": "assign_kernel",
                  "vq_lookup": "lookup_kernel"},
    "GAT-mixed": {"segment_sum_scalar": "segment_sum_kernel", "vq_assign": "assign_fast_kernel",
                  "vq_lookup": "lookup_kernel"},
    "GCN-coo": {"segment_sum": "segment_sum_kernel", "vq_assign": "assign_kernel",
                "vq_lookup": "lookup_kernel"},
    "GAT-coo": {"segment_sum": "segment_sum_kernel", "vq_assign": "assign_kernel",
                "vq_lookup": "lookup_kernel"},
    # B + M: the per-branch GAT conv's row 8 and rows 9-10 (GAT, f32 and
    # bf16), row 1 and rows 9-10 with zero attention (SAGE)
    "GAT-bm": {"segment_sum": "segment_sum_kernel", "rev_forward": "rev_rows_kernel",
               "rev_backward": "rev_rows_kernel", "vq_assign": "assign_kernel",
               "vq_lookup": "lookup_kernel"},
    "GAT-bm-bf16": {"segment_sum": "segment_sum_kernel", "rev_forward": "rev_rows_kernel",
                    "rev_backward": "rev_rows_kernel", "vq_assign": "assign_fast_kernel",
                    "vq_lookup": "lookup_kernel"},
    "SAGE-bm": {"ell_aggregate": "ell_aggregate_kernel", "rev_forward": "rev_rows_kernel",
                "rev_backward": "rev_rows_kernel", "vq_assign": "assign_kernel",
                "vq_lookup": "lookup_kernel"},
    # GCN B + M with the transformer (row 6 for the layers' codebooks and
    # the transformer's), and B + M GAT on COO (the per-branch row 8 sum;
    # its recovery term is the grid path, plain PyTorch)
    "GCN-bm-tr": {"ell_aggregate": "ell_aggregate_kernel", "vq_assign": "assign_kernel",
                  "vq_lookup": "lookup_kernel"},
    "GAT-bm-coo": {"segment_sum": "segment_sum_kernel", "vq_assign": "assign_kernel",
                   "vq_lookup": "lookup_kernel"},
    # phase 11's link step at the collab widths and phase 12's multilabel
    # step at the ppi widths (row 6 at nb = 64, M = 4,096), in exact f32
    "GCN-link": {"ell_aggregate": "ell_aggregate_kernel", "vq_assign": "assign_kernel",
                 "vq_lookup": "lookup_kernel", "segment_sum": "segment_sum_kernel"},
    "GCN-ppi": {"ell_aggregate": "ell_aggregate_kernel", "vq_assign": "assign_kernel",
                "vq_lookup": "lookup_kernel"},
}
# ... and the rows each of those must not launch: no row 2 or 3 off the
# single-K layout, no row 1 on COO or under the mixed or per-branch GAT
# conv
SHARDED_NOT = {
    "GCN-f16": ("ell_aggregate", "ell_aggregate_bf16", "gat_aggregate", "gat_aggregate_bf16",
                "gat_aggregate_f16", "gat_backward", "gat_backward_bf16", "gat_backward_f16",
                "segment_sum", "segment_sum_scalar", "rev_forward", "rev_backward",
                "vq_assign"),
    "GCN-mixed": ("gat_aggregate", "gat_aggregate_bf16", "segment_sum", "segment_sum_scalar"),
    "GAT-mixed": ("gat_aggregate", "gat_aggregate_bf16", "gat_backward", "gat_backward_bf16",
                  "ell_aggregate", "ell_aggregate_bf16"),
    "GCN-coo": ("ell_aggregate", "gat_aggregate", "segment_sum_scalar"),
    "GAT-coo": ("ell_aggregate", "gat_aggregate", "gat_backward", "segment_sum_scalar"),
    "GAT-bm": ("ell_aggregate", "ell_aggregate_bf16", "gat_aggregate", "gat_aggregate_bf16",
               "gat_backward", "gat_backward_bf16", "segment_sum_scalar"),
    "GAT-bm-bf16": ("ell_aggregate", "ell_aggregate_bf16", "gat_aggregate", "gat_aggregate_bf16",
                    "gat_backward", "gat_backward_bf16", "segment_sum_scalar"),
    "SAGE-bm": ("gat_aggregate", "gat_aggregate_bf16", "gat_backward", "gat_backward_bf16",
                "segment_sum", "segment_sum_scalar"),
    "GCN-bm-tr": ("gat_aggregate", "gat_aggregate_bf16", "gat_backward", "gat_backward_bf16",
                  "segment_sum", "segment_sum_scalar", "rev_forward", "rev_backward"),
    "GAT-bm-coo": ("ell_aggregate", "ell_aggregate_bf16", "gat_aggregate", "gat_aggregate_bf16",
                   "gat_backward", "gat_backward_bf16", "segment_sum_scalar", "rev_forward",
                   "rev_backward"),
    "GCN-link": ("gat_aggregate", "gat_aggregate_bf16", "gat_backward", "gat_backward_bf16",
                 "segment_sum_scalar", "rev_forward", "rev_backward"),
    "GCN-ppi": ("gat_aggregate", "gat_aggregate_bf16", "gat_backward", "gat_backward_bf16",
                "segment_sum", "segment_sum_scalar", "rev_forward", "rev_backward"),
}
# 17a: the families whose step runs twice from one state (the same bits):
# the flagship, each path through a fixed-order sum of its own (the COO GAT
# logits' gathers, the B + M grid path's scatter, the link pairs' gathers)
SAME_BITS_SHARDED = ("GCN", "GAT-coo", "GAT-bm-coo", "GCN-link")
LINK_NEG_SEED = 24  # phase 17's link negatives: the compare step's (numpy), the timed steps'
# the families whose ledger phase 17 holds to the byte (ledger_formula)
LEDGER_FORMULA_FAMILIES = ("GCN-bm-tr", "GAT-bm-coo", "GCN-link", "GCN-ppi")
# row 6 a step on the transformer's path: the layers' codebooks and the
# transformer's, three layers each
TR_ASSIGNS = 6
SAGE_BM_STEPS = 3  # whole-batch steps of the SAGE B + M state before phase 17
SHARDED_STEPS_LAYOUT = 1  # timed steps of each sharded step on the other layouts


def _state_digest(arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _step_record(torch, state, m, pred=None):
    """What phase 17 compares of a state after one step: the loss and its
    two terms (the step's metrics ``m``; a link step's ``loss_pre`` and the
    rest), the named parameters (with a link step's predictor, ``pred.``),
    each layer's codebook and c_indices, and the transformer's beside them
    (numpy)."""
    tr = state.vq_states_tr or []
    params = {k: v.detach().cpu().numpy() for k, v in state.model.named_parameters()}
    if pred is not None:
        params.update({f"pred.{k}": v.detach().cpu().numpy()
                       for k, v in pred.named_parameters()})
    cls = float(m["loss_pre"] if "loss_pre" in m else m["loss_cls"])
    return dict(loss=float(m["loss"]), loss_cls=cls,
                info=float(m["info_backward"]) if "info_backward" in m else float(m["loss"]) - cls,
                params=params, emb=[s.embedding.cpu().numpy() for s in state.vq_states + tr],
                cidx=[s.c_indices.cpu().numpy() for s in state.vq_states + tr])


@contextlib.contextmanager
def cmax_decisions(store, row0=0, m=0):
    """Records, for each call of ``nn/model.py:transformer_cmax`` (one a
    layer, in order), {"branches": {branch: (c_max, its second-largest valid
    row norm, the rows whose valid squared norm reaches c_max)}, "grad":
    c_max's cotangent [nb] (on a shard this rank's part of it), "m": the
    model rank}, rows and branches numbered as in the whole batch
    (``row0``: this rank's first batch row; ``m``: its model rank, whose
    branches come m-th).  Those rows take c_max's cotangent; where two rows
    lie within the rounding of a reordered sum, which of them reaches it is
    not the data's to decide (``compare_step``)."""
    import torch
    import vq_gnn_tpu_torch.nn.model as model_mod

    orig = model_mod.transformer_cmax

    def recording(nB, nM, valid, ranks=None):
        out = orig(nB, nM, valid, ranks)
        with torch.no_grad():
            v = nB.masked_fill(~valid[None, :], float("-inf"))
            at = v == out[:, None]
            second = v.topk(min(2, v.shape[1]), dim=1).values[:, -1]
            nb = nB.shape[0]
            rec = {"m": m, "grad": None, "branches": {
                m * nb + b: (float(out[b]), float(second[b]), sorted(
                    (torch.nonzero(at[b]).flatten() + row0).tolist())) for b in range(nb)}}
        if out.requires_grad:
            out.register_hook(lambda g: rec.update(grad=g.detach().cpu().numpy().copy()))
        store.append(rec)
        return out

    model_mod.transformer_cmax = recording
    try:
        yield store
    finally:
        model_mod.transformer_cmax = orig


@contextlib.contextmanager
def cmax_cut():
    """``nn/model.py:transformer_cmax`` with its gradient cut, on the whole
    batch and on each rank alike: c_max is then a constant of the step, and
    no gradient depends on which rows reach it (``compare_step``)."""
    import vq_gnn_tpu_torch.nn.model as model_mod

    orig = model_mod.transformer_cmax
    model_mod.transformer_cmax = lambda *a: orig(*a).detach()
    try:
        yield
    finally:
        model_mod.transformer_cmax = orig


CMAX_CUT = "c_max cut"  # the suffix of a configuration's tag run under cmax_cut()


def cmax_flips(whole, ranks):
    """[(layer, branch, the whole batch's rows at c_max, the shards' rows,
    the whole batch's top two norms, each rank's c_max and the second-largest
    norm of its own rows)] wherever the rows that reach c_max differ between
    ``train_step`` on the whole batch and the sharded step (``ranks``: every
    rank's :func:`cmax_decisions` records)."""
    flips = []
    for l, w in enumerate(whole or []):
        merged = {}
        for rec in ranks:
            for b, (_, _, rows) in rec[l]["branches"].items():
                merged.setdefault(b, set()).update(rows)
        for b, (top, second, rows) in w["branches"].items():
            if set(rows) != merged.get(b, set()):
                flips.append((l, b, rows, sorted(merged.get(b, ())), (top, second),
                              [rec[l]["branches"][b][:2] for rec in ranks
                               if b in rec[l]["branches"]]))
    return flips


def cmax_grads(whole, ranks):
    """[(layer, max over branches of |the ranks' parts of c_max's cotangent,
    summed, - the whole batch's|, max |the whole batch's|)]: the backward of
    ``ops/gat.py:ranks_max`` sums the parts, which each rank's rows give."""
    import numpy as np

    out = []
    for l, w in enumerate(whole or []):
        acc = np.zeros_like(w["grad"])
        for rec in ranks:
            g = rec[l]["grad"]
            acc[rec[l]["m"] * g.shape[0] : (rec[l]["m"] + 1) * g.shape[0]] += g
        out.append((l, float(np.abs(acc - w["grad"]).max()), float(np.abs(w["grad"]).max())))
    return out


def hold_sub_ell(torch, tag, label, edges, rows_all, C, gen, err, dtype=None):
    """Kernel 1 against its plain version on a row shard's adjacency
    (``parallel/mesh.py:ShardEdges``), with its own row offsets and long
    rows: the forward over the owned rows' slots and the dx over the owned
    batch columns' transposed slots, each reading the gathered [rows_all,
    C] rows as the exchange hands them over, in f32 or in ``dtype`` (f16:
    the f16-row mode).  Tolerance as ``hold_ell``."""
    from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate, ell_aggregate_plain

    name = "ell_aggregate" + ("_f16" if dtype == torch.float16 else "")

    for which, args, kw in (
            ("forward", (edges.ell_row, edges.ell_col, edges.ell_val, edges.num_rows),
             dict(ptr=edges.ell_ptr, long_rows=edges.ell_long_rows)),
            ("dx", (edges.t_ell_row, edges.t_ell_col, edges.t_ell_val, edges.b_rows),
             dict(ptr=edges.t_ell_ptr, long_rows=edges.t_ell_long_rows))):
        x = torch.randn((rows_all, C), generator=gen, device=edges.ell_col.device)
        x = x if dtype is None else x.to(dtype)
        out, again = ell_aggregate(x, *args, **kw), ell_aggregate(x, *args, **kw)
        ref = ell_aggregate_plain(x, *args)
        torch.cuda.synchronize()
        d = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        same = torch.equal(out, again)
        log(f"[{tag} {name} {label} {which} C={C}] slots {args[0].shape[0]}, out "
            f"{tuple(out.shape)} from {rows_all} gathered rows, max|err| {d:.3g} (tol "
            f"{tol:.3g}); {kw['long_rows'].shape[0] - 1} long rows; two calls bit-identical: "
            f"{same}")
        assert torch.isfinite(out).all() and d <= tol and same
        err[name] = max(err.get(name, 0.0), d)


def hold_sub_mixed(torch, tag, label, edges, rows_all, C, gen, err):
    """Kernel 1 against its plain version on a row shard's mixed families,
    as its exchange calls it: the head (over its compact rows) and the tail
    forward over the owned rows, and both dx families over the owned batch
    columns, each reading the gathered [rows_all, C] rows with the family's
    own row offsets and long rows.  Tolerance as ``hold_ell``."""
    from vq_gnn_tpu_torch.ops.ell_aggregate import ell_aggregate, ell_aggregate_plain

    R, b = edges.num_rows, edges.b_rows
    for fam, rows, n in (("head", "head_rowc", R), ("tail", "tail_row", R),
                         ("t_head", "t_head_rowc", b), ("t_tail", "t_tail_row", b)):
        args = (getattr(edges, rows), getattr(edges, fam + "_col"), getattr(edges, fam + "_val"),
                n)
        kw = dict(ptr=getattr(edges, fam + "_ptr"), long_rows=getattr(edges, fam + "_long_rows"))
        x = torch.randn((rows_all, C), generator=gen, device=args[0].device)
        out, again = ell_aggregate(x, *args, **kw), ell_aggregate(x, *args, **kw)
        ref = ell_aggregate_plain(x, *args)
        torch.cuda.synchronize()
        d = float((out - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        same = torch.equal(out, again)
        log(f"[{tag} ell_aggregate {label} {fam} C={C}] slots {args[0].shape[0]} x "
            f"K={args[1].shape[1]}, out {tuple(out.shape)} from {rows_all} gathered rows, "
            f"max|err| {d:.3g} (tol {tol:.3g}); {kw['long_rows'].shape[0] - 1} long rows; two "
            f"calls bit-identical: {same}")
        assert torch.isfinite(out).all() and d <= tol and same
        err["ell_aggregate"] = max(err.get("ell_aggregate", 0.0), d)


def shard_line(e) -> str:
    """The slots or edges a row shard holds, forward and transposed."""
    if e.mixed:
        return (f"head {e.head_col.shape[0]} x {e.head_col.shape[1]} slots over "
                f"{int((e.head_ptr[1:] > e.head_ptr[:-1]).sum())} compact rows, tail "
                f"{e.tail_col.shape[0]} x {e.tail_col.shape[1]}; transposed head "
                f"{e.t_head_col.shape[0]}, tail {e.t_tail_col.shape[0]}")
    if e.ell_row is None:
        return f"COO edges {e.row.shape[0]}, transposed {e.t_row.shape[0]}"
    return f"slots {e.ell_row.shape[0]}, transposed slots {e.t_ell_row.shape[0]}"


def edge_shapes(e) -> set:
    """The shapes of a batch's edge arrays in its layout (and their flat
    forms), which no collective may carry."""
    if e.mixed:
        cols = [e.head_col, e.tail_col, e.t_head_col, e.t_tail_col]
    elif e.ell_row is None:
        return {tuple(e.row.shape)}
    else:
        cols = [e.ell_col, e.t_ell_col]
    out = set()
    for c in cols:
        S, K = c.shape
        out |= {(S, K), (S,), (S * K,)}
    return out


def hold_gat_shard(torch, tag, label, edges, rows_all, C, gen, err):
    """Kernels 4 and 5 (rows 2 and 3) against their plain versions on a GAT
    row shard's adjacency as ``ops/gat.py:gat_conv_sharded`` calls them, in
    the f32 and the bf16-row modes: row 2 over the owned rows' slots,
    reading the gathered [rows_all, C] x with al of every gathered row and
    ar of the owned rows; row 3 over the transposed slots of every owned
    row, reading the gathered g_agg, g_rowsum and ar with al of the owned
    rows, dx for its batch rows (``b_rows``).  Tolerance as phase 5's: 1e-5
    of the largest |ref| of each output; the same bits twice."""
    from vq_gnn_tpu_torch.ops.gat_kernels import (
        gat_aggregate,
        gat_aggregate_plain,
        gat_backward,
        gat_backward_plain,
    )

    dev, R, b = edges.ell_col.device, edges.num_rows, edges.b_rows
    own = slice(edges.row0, edges.row0 + R)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        x = torch.randn((rows_all, C), generator=gen, device=dev).to(dt)
        al, ar = (torch.randn(rows_all, generator=gen, device=dev) for _ in range(2))
        g_agg = torch.randn((rows_all, C), generator=gen, device=dev).to(dt)
        g_rs = torch.randn(rows_all, generator=gen, device=dev).to(dt)
        fwd = (x, edges.ell_row, edges.ell_col, edges.ell_val, al, ar[own].contiguous(), R)
        bwd = (x[own].contiguous(), edges.t_ell_row, edges.t_ell_col, edges.t_ell_val, g_agg,
               g_rs, al[own].contiguous(), ar.to(dt), R)
        for name, args, kw, plain in (
                ("gat_aggregate", fwd, dict(with_neg=True, ptr=edges.ell_ptr,
                                            long_rows=edges.ell_long_rows), gat_aggregate_plain),
                ("gat_backward", bwd, dict(dx_rows=b, ptr=edges.t_ell_ptr,
                                           long_rows=edges.t_ell_long_rows), gat_backward_plain)):
            fn = gat_aggregate if name == "gat_aggregate" else gat_backward
            out, again = fn(*args, **kw), fn(*args, **kw)
            ref = plain(*args, **{k: v for k, v in kw.items() if k in ("with_neg", "dx_rows")})
            torch.cuda.synchronize()
            same = all(torch.equal(o, a) for o, a in zip(out, again))
            d = 0.0
            for o, r in zip(out, ref):
                tol = 1e-5 * max(1.0, float(r.abs().max()))
                dd = float((o - r).abs().max())
                assert torch.isfinite(o).all() and dd <= tol, (tag, name + sfx, dd, tol)
                d = max(d, dd)
            log(f"[{tag} {name}{sfx} {label} C={C}] slots {args[1].shape[0]} over {R} owned "
                f"rows from {rows_all} gathered, max|err| {d:.3g} (1e-5 of each output's "
                f"largest |ref|); {kw['long_rows'].shape[0] - 1} long rows; two calls "
                f"bit-identical: {same}")
            assert same
            err[name + sfx] = max(err.get(name + sfx, 0.0), d)


def mh_sum_calls(torch, e, widths, gen):
    """Kernel 8's calls in the B + M GAT conv over a row shard, as
    ``ops/gat.py:gat_conv_mh_sharded`` makes them: (label, (partials, seg,
    R), None, lists) over the owned rows' forward slots (the aggregate and
    the row sums forward, d_ar backward) and over the owned columns'
    transposed slots (dx and d_al), each at the conv's widths (nb * D and
    nb), random partials, with the shard's row offsets and long rows."""
    R = e.num_rows
    out = []
    for label, rows, ptr, lr in (("forward", e.ell_row, e.ell_ptr, e.ell_long_rows),
                                 ("transposed", e.t_ell_row, e.t_all_ptr, e.t_all_long_rows)):
        for C in widths:
            part = torch.randn((rows.shape[0], C), generator=gen, device="cuda")
            out.append((f"{label} C={C}", (part, rows, R), None, dict(ptr=ptr, long_rows=lr)))
    return out


def hold_rev_shard(torch, tag, label, c_indices, sh, Dg, M, gen, err):
    """Kernels 9 and 10 (rows 9 and 10) against their plain version over a
    row shard's own reverse cells (``RowShard.rev_slot_*``, its row offsets
    and long rows), as the recovery term calls them, in both folds, with
    random O(1) xb [nb, b, Dg], al, arcb and gbar and the shard's codes of
    ``c_indices``: each value to 1e-5 of the sum of the |terms| it adds up
    plus 1e-6 of the largest such sum, as phase 5 holds the whole batch;
    the same bits twice."""
    from vq_gnn_tpu_torch.ops.rev_kernels import (
        rev_backward,
        rev_forward,
        rev_recovery_info_plain,
    )

    nb, b = c_indices.shape[1], sh.B_pad
    dev = c_indices.device
    xb = torch.randn((nb, b, Dg), generator=gen, device=dev)
    al = 0.5 * torch.randn((nb, b), generator=gen, device=dev)
    arcb = 0.5 * torch.randn((nb, M), generator=gen, device=dev)
    gbar = torch.randn((nb, M, Dg), generator=gen, device=dev)
    g = torch.linspace(-1.0, 2.0, nb, device=dev)
    kw = dict(c_indices=c_indices, slot_col=sh.rev_slot_col, slot_val=sh.rev_slot_val,
              row_ptr=sh.rev_row_ptr, long_rows=sh.rev_long_rows)

    def plain(xb_, gbar_, g_, fold):
        leaves = [t.clone().requires_grad_(True) for t in (xb_, al, arcb)]
        info = rev_recovery_info_plain(c_indices, sh.rev_slot_col, sh.rev_slot_val,
                                       sh.rev_slot_row, *leaves, gbar_, fold=fold)
        return (info.detach(), *torch.autograd.grad((info * g_).sum(), leaves))

    absb = plain(xb.abs(), gbar.abs(), g.abs(), "x2")
    for fold, keys in (("x2", ("rev_forward", "rev_backward")),
                       ("fast", ("rev_forward_fold_bf16", "rev_backward_fold_bf16"))):
        ref = plain(xb, gbar, g, fold)
        outs, again = ((rev_forward(xb=xb, al=al, arcb=arcb, gbar=gbar, fold=fold, **kw),
                        *rev_backward(xb=xb, al=al, arcb=arcb, gbar=gbar, g=g, fold=fold, **kw))
                       for _ in range(2))
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(outs, again))
        worst = 0.0
        for i, (o, r, bb) in enumerate(zip(outs, ref, absb)):
            d = (o - r).abs()
            ratio = float((d / (1e-5 * bb + 1e-6 * float(bb.max()))).max())
            assert torch.isfinite(o).all() and ratio <= 1.0, (tag, fold, i, ratio)
            worst = max(worst, ratio)
            key = keys[0] if i == 0 else keys[1]
            err[key] = max(err.get(key, 0.0), float(d.max()))
        log(f"[{tag} rev fold={fold} {label}] nb {nb}, b {b}, M {M}, Dg {Dg}: slots "
            f"{sh.rev_slot_row.shape[0]}, live cells {int((sh.rev_slot_val != 0).sum())}, "
            f"{sh.rev_long_rows.shape[0] - 1} long rows; info, d_xb, d_al, d_arcb at most "
            f"{worst:.4g} of the tolerance; two calls bit-identical: {same}")
        assert same


def rev_shapes(batch) -> set:
    """The shapes of a B + M batch's reverse list (its rev-ELL slots and
    their flat forms, or its raw entries), which no collective may carry."""
    if batch.rev_slot_col is not None:
        S, K = batch.rev_slot_col.shape
        return {(S, K), (S,), (S * K,)}
    return set() if batch.bm_rev_row is None else {tuple(batch.bm_rev_row.shape)}


def gloo_probe(torch, dist, rank):
    """Whether gloo carries a bf16 CUDA tensor through an all-gather and an
    all-reduce (sum), and an f32 one through an all-reduce MAX, with the
    values right; {'bf16 all_gather': bool, ...}."""
    from vq_gnn_tpu_torch.parallel.multihost import _all_gather

    res = {}
    for label, dt, op in (("bf16 all_gather", torch.bfloat16, None),
                          ("bf16 all_reduce", torch.bfloat16, dist.ReduceOp.SUM),
                          ("f32 all_reduce MAX", torch.float32, dist.ReduceOp.MAX)):
        t = torch.full((4, 3), rank + 1.5, dtype=dt, device="cuda")
        try:
            if op is None:
                out = t.new_empty((SHARDED_RANKS * 4, 3))
                _all_gather(out, t)
                want = torch.arange(SHARDED_RANKS, device="cuda").repeat_interleave(4) + 1.5
                ok = torch.equal(out[:, 0].float(), want)
            else:
                dist.all_reduce(t, op=op)
                want = (SHARDED_RANKS * (SHARDED_RANKS + 2) / 2 if op == dist.ReduceOp.SUM
                        else SHARDED_RANKS + 0.5)
                ok = bool((t.float() == want).all())
            res[label] = ok
        except RuntimeError as e:
            res[label] = f"refused: {str(e).splitlines()[0][:120]}"
    return res


def sharded_rank(rank, tmp):
    """One of phase 17's ranks, on cuda:0 over gloo (the module docstring
    says what it runs); pickles its results to ``tmp``/out<rank>.pkl."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from vq_gnn_tpu_torch import ops
    from vq_gnn_tpu_torch.config import Config, apply_matmul_precision
    from vq_gnn_tpu_torch.convert import predictor_from_numpy, state_from_numpy
    from vq_gnn_tpu_torch.nn.model import model_static
    from vq_gnn_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        make_sharded_link_step,
        make_sharded_link_step_2d,
        make_sharded_step,
        make_sharded_step_2d,
        shard_train_inputs,
        shard_train_inputs_2d,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", world_size=SHARDED_RANKS,
                            rank=rank, timeout=timedelta(seconds=300))
    with open(os.path.join(tmp, "plan.pkl"), "rb") as f:
        plan = pickle.load(f)
    gpu = plan["gpu"]
    gen = torch.Generator(device="cuda").manual_seed(17 + rank)
    res = {"err": {}, "launches": {}, "path_steps": {}, "steps": {}, "ledger": {}, "digest": {},
           "same_bits": {}, "cmax": {}, "probe": gloo_probe(torch, dist, rank)}
    err = {}
    rlog = log if rank == 0 else (lambda *a: None)
    fams, xs = {}, {}  # one copy on the card of each trainer's feature table
    for fname, fam in plan["families"].items():
        if id(fam["X"]) not in xs:
            xs[id(fam["X"])] = torch.as_tensor(fam["X"]).cuda()
        fams[fname] = dict(fam, X=xs[id(fam["X"])],
                           cfgs={k: Config(**v) for k, v in fam["cfgs"].items()})

    def fresh(fam, tag):
        """(ModelStatic, the family's state, on a link family its predictor
        and RMSprop, else None) on the card."""
        cfg = fam["cfgs"][tag]
        apply_matmul_precision(cfg)  # TF32 for the flagship's settings ('default'), else off
        ms = model_static(cfg, fam["F"], fam["C"], torch.device("cuda"))
        pred = None if fam["pred"] is None else predictor_from_numpy(*fam["pred"], cfg.lr, "cuda")
        return ms, state_from_numpy(fam["state"], ms, cfg.lr, "cuda"), pred

    def call(step, state, X, sh, cfg, pred, **kw):
        """One step of the family's kind, (state, metrics): the node step,
        or with a predictor the link step."""
        if pred is None:
            return step(state, X, sh, 1.0, cfg.lr, 1.0, **kw)
        return state, step(state, *pred, X, sh, 1.0, cfg.lr, 1.0, **kw)

    def timed(name, step, state, X, shards, cfg, n_steps, pred):
        """Timed and 3 profiled steps on this rank's shards, the ledger and
        the peak memory over them; a link step draws its negatives from a
        generator seeded alike on both ranks."""
        kw = {} if pred is None else dict(generator=torch.Generator(
            device="cuda").manual_seed(LINK_NEG_SEED))

        def one(sh):
            nonlocal state
            state, m = call(step, state, X, sh, cfg, pred, **kw)
            return m

        for sh in shards:  # warm-up
            one(sh)
        step.ledger.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, losses = timed_steps(torch, one, shards, n_steps)
        prof = profile_steps(lambda i: one(shards[i % len(shards)]), SHARDED_PROFILED,
                             log=rlog, tag=f"17d {name}", gpu=gpu)
        mean = sum(times) / len(times)
        std = (sum((t - mean) ** 2 for t in times) / max(len(times) - 1, 1)) ** 0.5
        res["steps"][name] = dict(
            ms=mean, std=std, median=sorted(times)[len(times) // 2], losses=losses,
            n=n_steps, busy=None if prof is None else prof["busy_ms"],
            wall=None if prof is None else prof["wall_ms"],
            kernels=None if prof is None else sorted({k for _, _, k in prof["rows"]}),
            peak=torch.cuda.max_memory_allocated() - base, held=base)
        res["ledger"][name] = dict(per_step=step.ledger.per_step(),
                                   kinds=sorted(step.ledger.kinds), steps=step.ledger.steps)
        return state

    # each mesh, each family: the step checks and the timed steps with the
    # launch counters zeroed just before and read just after, then (not
    # counted) the family's kernels against their plain versions at this
    # rank's shard shapes
    mesh1 = make_mesh(SHARDED_RANKS, device="cuda:0")
    mesh2 = make_mesh_2d(1, SHARDED_RANKS, device="cuda:0")
    for mname, mesh, place, make, make_link, n_model in (
            ("1-D", mesh1, shard_train_inputs, make_sharded_step, make_sharded_link_step, 1),
            ("2-D 1x2", mesh2, shard_train_inputs_2d, make_sharded_step_2d,
             make_sharded_link_step_2d, SHARDED_RANKS)):
        for fname, fam in fams.items():
            X, batches, cfgs = fam["X"], fam["batches"], fam["cfgs"]
            if mname not in fam["meshes"]:  # its branches do not split over the model ranks
                cfg = next(iter(cfgs.values()))
                ms = model_static(cfg, fam["F"], fam["C"], torch.device("cuda"))
                try:
                    make(ms, cfg, mesh)
                except ValueError as e:
                    rlog(f"[17c {fname} {mname}] refused by name, as it must be: {e}")
                else:
                    raise AssertionError(f"the {mname} step took {fname}'s "
                                         f"{ms.num_branches} branches")
                continue
            R_all = batches[0].B_pad + batches[0].Bp_pad
            path = f"{fname} {mname}"
            t_fam = time.time()
            ops.reset_launch_counts()
            n_steps, stepped = 0, {}
            for ti, (tag, cfg) in enumerate(cfgs.items()):
                # the compare step's negatives: the reference's
                kw = {} if fam["pred"] is None else dict(dst_neg=torch.as_tensor(
                    fam["dst_neg"], device="cuda"))
                # the first configuration of SAME_BITS_SHARDED's families
                # runs its compare step twice from one state (the second not
                # counted): the same bits, on the 1-D mesh and the link
                # step's on both
                recs = []
                for again in range(1 + (ti == 0 and fname in SAME_BITS_SHARDED
                                        and (n_model == 1 or fam["pred"] is not None))):
                    ms, state, pred = fresh(fam, tag)
                    state, _, shard = place(mesh, state, X, batches[0])
                    step = (make_link(ms, cfg, mesh) if pred is not None
                            else make(ms, cfg, mesh, multilabel=fam["multilabel"]))
                    decisions = ([] if again else
                                 res["cmax"].setdefault((mname, fname, tag), []))
                    if tag.endswith(CMAX_CUT) or again:  # checks beside the path: not counted
                        with ops.uncounted(), (cmax_cut() if tag.endswith(CMAX_CUT) else
                                               cmax_decisions(decisions, shard.row0, rank
                                                              if n_model > 1 else 0)
                                               if ms.transformer_flag else
                                               contextlib.nullcontext()):
                            state, m = call(step, state, X, shard, cfg, pred, **kw)
                    else:
                        with (cmax_decisions(decisions, shard.row0, rank if n_model > 1 else 0)
                              if ms.transformer_flag else contextlib.nullcontext()):
                            state, m = call(step, state, X, shard, cfg, pred, **kw)
                        n_steps += 1
                        if tag in fam["timed"]:  # its timed steps go on from here
                            stepped[tag] = (state, shard, step, pred)
                    recs.append(_step_record(torch, state, m, None if pred is None else pred[0]))
                rec = recs[0]
                digests = [_state_digest(list(r["params"].values()) + r["emb"]
                                         + [c[:-1] for c in r["cidx"]]) for r in recs]
                if len(recs) > 1:
                    res["same_bits"][mname, fname, tag] = digests[0] == digests[1]
                if n_model == 1:
                    res["digest"][mname, fname, tag] = digests[0]
                if rank == 0 or n_model > 1:
                    res[mname, fname, tag] = rec
            for tag, n in fam["timed"].items():
                state, shard, step, pred = stepped.pop(tag)
                shards = [shard] + [place(mesh, state, X, b)[2] for b in batches[1:]]
                apply_matmul_precision(cfgs[tag])
                state = timed(f"{fname} {tag} {mname}", step, state, X, shards, cfgs[tag], n,
                              pred)
                n_steps += len(shards) + n + SHARDED_PROFILED
            res["launches"][path] = ops.launch_counts()
            res["path_steps"][path] = n_steps
            rlog(f"[17 time] {path}: {n_steps} steps with their placing in "
                 f"{time.time() - t_fam:.1f}s")
            sh = shards[0]
            if mname == "1-D":
                own_t = fname.startswith("GAT") and fname != "GAT-coo"
                rev = ("" if sh.rev_slot_row is None else
                       f", reverse list {sh.rev_slot_row.shape[0]} slots over its batch rows")
                if sh.link_src is not None:
                    rev += (f", {sh.link_src.shape[0]} of the batch's "
                            f"{len(batches[0].link_src)} link pairs ({int(sh.link_mask.sum())} "
                            f"live)")
                rlog(f"[17 shard] {fname} rank {rank} of {SHARDED_RANKS}: B_pad {sh.B_pad} of "
                     f"{sh.batch_B_pad}, Bp_pad {sh.Bp_pad}, owned {shard_line(sh.edges)} "
                     f"(transposed: of its {'owned' if own_t else 'batch'} columns){rev}, "
                     f"gathered rows {R_all}")
            # 17b / 17c: the family's kernels at this rank's shapes
            tag17 = "17b" if n_model == 1 else "17c"
            label = f"rank {rank} {mname} shard"
            C = fam["C_hidden"] // n_model
            with ops.uncounted():
                if fname == "GAT":
                    hold_gat_shard(torch, tag17, label, sh.edges, R_all, C, gen, err)
                elif fname == "GCN-mixed":
                    hold_sub_mixed(torch, tag17, label, sh.edges, R_all, C, gen, err)
                elif fname == "GAT-mixed":  # the partials C wide, the scalar beside them
                    hold_segment_sums(torch, f"{tag17} segment_sum scalar {label}",
                                      scalar_family_calls(torch, sh.edges, C, gen), err,
                                      "segment_sum_scalar")
                elif fname in ("GCN-coo", "GAT-coo"):  # GAT's messages carry the ones column
                    hold_segment_sums(torch, f"{tag17} segment_sum coo {label}", coo_sum_calls(
                        torch, sh.edges, C + (fname == "GAT-coo"), gen), err, "segment_sum")
                else:  # row 1 or row 8 (the per-branch conv's, the COO branch sum), rows
                    # 9-10 over a reverse list, rows 6, 7
                    vq1 = state.vq_states[1]
                    nb, M, K = vq1.embedding.shape
                    D = next(iter(cfgs.values())).num_D
                    if fname == "GAT-bm-coo":  # every branch's D + 1 columns side by side
                        hold_segment_sums(torch, f"{tag17} segment_sum coo branches {label}",
                                          coo_sum_calls(torch, sh.edges, nb * (D + 1), gen), err,
                                          "segment_sum")
                    elif fname.startswith("GAT-bm"):
                        hold_segment_sums(torch, f"{tag17} segment_sum {label}", mh_sum_calls(
                            torch, sh.edges, (C, nb), gen), err, "segment_sum")
                    else:
                        hold_sub_ell(torch, tag17, label, sh.edges, R_all, C, gen, err,
                                     torch.float16 if fname == "GCN-f16" else None)
                    if sh.rev_slot_row is not None:  # GAT's table rows carry the ones column
                        hold_rev_shard(torch, tag17, label, vq1.c_indices, sh,
                                       D + fname.startswith("GAT"), M, gen, err)
                    xn = torch.randn((nb, sh.B_pad, K), generator=gen, device="cuda")
                    # the ppi widths: phase 12's row (nb = 64, M = 4,096)
                    hold_assign(torch, tag17, f"{label}, {nb} branches", xn,
                                vq1.embedding.contiguous(), sh.valid_B.contiguous(), err,
                                key=(f"vq_assign (nb={nb}, M={M})" if fname == "GCN-ppi"
                                     and n_model == 1 else "vq_assign"),
                                chunk=branch_chunk(sh.B_pad, M))
                    if state.vq_states_tr is not None:  # at the transformer codebook's shape
                        emb_tr = state.vq_states_tr[1].embedding.contiguous()
                        xn = torch.randn((nb, sh.B_pad, emb_tr.shape[2]), generator=gen,
                                         device="cuda")
                        hold_assign(torch, tag17, f"{label}, the transformer's {nb} branches",
                                    xn, emb_tr, sh.valid_B.contiguous(), err,
                                    chunk=branch_chunk(sh.B_pad, M))
                    hold_lookup(torch, tag17, f"{label}, {nb} branches", vq1, sh.fo_ids, D)
                    del xn
            del state, shards, step, pred
    res["err"] = err
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def compare_step(tag, got, ref, N, atol, gpu, m=0, n_model=1, codebooks=True, terms=False,
                 D=0, grads_held=True):
    """One sharded step (``got``, model rank m's part on the 2-D mesh)
    against ``train_step`` on the whole batch from one state: the loss to
    1e-5 relative (with ``terms``, the B + M families', each of its two
    terms, the CE and the recovery term, to 1e-5 relative, and the loss to
    1e-5 of the sum of their sizes, which those two checks imply: the
    recovery term can nearly cancel the CE, to a loss of 2.8e-4 from terms
    of 2.5e-3 and -2.2e-3 on phase 3's B + M bf16 state, and a check
    relative to that difference magnifies each term's reordering error,
    2.4e-6 of the CE there, 17 times), the parameters to ``atol``,
    ``c_indices[:N]`` agreeing
    on >= 0.9999 (the transformer's beside the layers'), and with
    ``codebooks`` the codebooks to rtol and atol 2e-5
    (the tolerances of tests/test_multichip.py) except the codewords of the
    assignments that differ: a near tie that the moments' sums in another
    order moved, counted by the agreement.  Without it the codebooks'
    difference is logged: under TF32 and row 6's fast mode a sum in another
    order (1e-7) moves the odd value across a rounding step (1e-3 of it), and
    a codeword of one or two members carries that whole.

    ``D`` (the transformer's family): each codebook's largest excess over
    2e-5 |ref| is logged apart for its features (the first ``D`` columns)
    and its gradients past them, with where it lies.  ``grads_held`` False
    (that family's step with c_max's gradient whole): all of c_max's
    cotangent lands on the rows that reach it (other rows where a near-tie
    falls the other way, :func:`cmax_flips`) as 2 g x_B, a cotangent along
    the row that the layer norm's backward then nearly cancels, and the
    small rest, which the row's inputs summed in another order move, feeds
    the gradient half of the row's codeword in the layers below: those
    halves are logged here, and held to 2e-5 with everything else by the
    same step once more on both sides with c_max's gradient cut
    (:func:`cmax_cut`, the tag ending in ``CMAX_CUT``); the cotangent itself
    is held by the caller (:func:`cmax_grads`).  Returns what failed: the
    caller raises once every comparison is logged."""
    import numpy as np

    fails = []

    size = abs(ref["loss_cls"]) + abs(ref["info"]) if terms else abs(ref["loss"])
    rel = abs(got["loss"] - ref["loss"]) / max(size, 1e-30)
    if terms:
        for k in ("loss_cls", "info"):
            rel_k = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
            log(f"[{tag}] {k} {got[k]:.7f} vs train_step {ref[k]:.7f}, rel diff {rel_k:.3g} "
                f"(tol 1e-5)")
            if rel_k > 1e-5:
                fails.append((tag, k, rel_k))
    d_par = 0.0
    for k, v in ref["params"].items():
        if k.startswith("pred."):  # the link predictor: replicated
            pass
        # B + M GAT heads, the transformer's transformer_k: this rank's branches' rows
        elif n_model > 1 and v.ndim >= 2 and (k.endswith(("att_l", "att_r"))
                                            or ".transformer_k." in k):
            h = v.shape[0] // n_model
            v = v[m * h : (m + 1) * h]
        elif n_model > 1 and v.ndim == 2:  # the fan-in columns of this rank's branches
            w = v.shape[1] // n_model
            v = v[:, m * w : (m + 1) * w]
        d_par = max(d_par, float(np.abs(got["params"][k] - v).max()))
    agree, d_emb, moved, d_grad = 1.0, 0.0, 0, 0.0
    for i, (e_got, e_ref, c_got, c_ref) in enumerate(zip(got["emb"], ref["emb"], got["cidx"],
                                                         ref["cidx"])):
        nb = e_got.shape[0]
        e_ref, c_ref = e_ref[m * nb : (m + 1) * nb], c_ref[:N, m * nb : (m + 1) * nb]
        c_got = c_got[:N]
        agree = min(agree, float((c_got == c_ref).mean()))
        keep = np.ones(e_got.shape[:2], bool)
        rows, br = np.nonzero(c_got != c_ref)
        keep[br, c_got[rows, br]] = keep[br, c_ref[rows, br]] = False
        moved += int((~keep).sum())
        diff = np.where(keep[:, :, None], np.abs(e_got - e_ref) - 2e-5 * np.abs(e_ref), -np.inf)
        for half, cols in ((("features", slice(0, D)), ("gradients", slice(D, None)))
                           if D else ()):
            d = diff[:, :, cols]
            at = np.unravel_index(np.argmax(d), d.shape)
            log(f"[{tag}] codebook {i} {e_got.shape} {half}: max(|diff| - 2e-5 |ref|) "
                f"{d[at]:.3g} at (branch, codeword, column) {tuple(int(a) for a in at)}, ref "
                f"{e_ref[:, :, cols][at]:.7g} got {e_got[:, :, cols][at]:.7g}; max|ref| "
                f"{np.abs(e_ref[:, :, cols]).max():.4g}")
        if not grads_held:
            d_grad = max(d_grad, float(diff[:, :, D:].max()))
            diff = diff[:, :, :D]
        if codebooks and diff.max() > 2e-5:  # where a held codebook misses, for the record
            at = np.unravel_index(np.argmax(diff), diff.shape)
            log(f"[{tag}] codebook {i} {e_got.shape}: {int((diff > 2e-5).sum())} values of "
                f"{int(((diff > 2e-5).any(2)).sum())} codewords beyond 2e-5 + 2e-5 |ref|, the "
                f"largest at (branch, codeword, column) {tuple(int(a) for a in at)}: ref "
                f"{e_ref[at]:.7g} got {e_got[at]:.7g}; max|ref| {np.abs(e_ref).max():.4g}")
        d_emb = max(d_emb, float(diff.max()))
    log(f"[{tag}] one step from one state on the fixed-pad batch: loss {got['loss']:.7f} vs "
        f"train_step {ref['loss']:.7f}, rel diff {rel:.3g}{' of the terms' if terms else ''} "
        f"(tol 1e-5); parameters max|diff| "
        f"{d_par:.3g} (tol {atol:g}); c_indices[:N] agree {agree:.6f} (>= 0.9999); codebooks "
        f"max(|diff| - 2e-5 |ref|) {d_emb:.3g} (tol 2e-5)"
        f"{'' if codebooks else ' (logged, not held)'}; set aside: {moved} codewords, those of "
        f"the differing assignments"
        f"{'' if grads_held else ', their gradient halves apart'} | {gpu}")
    if not grads_held:
        log(f"[{tag}] the codebooks' gradient halves max(|diff| - 2e-5 |ref|) {d_grad:.3g} "
            f"(logged; held with c_max's gradient cut)")
    if not (rel <= 1e-5 and d_par <= atol and agree >= 0.9999):
        fails.append((tag, rel, d_par, agree))
    if codebooks and d_emb > 2e-5:
        fails.append((tag, d_emb))
    return fails


def _family_plan(tr, graph, cfgs, timed, host, n_batches=None, batches=None):
    """Phase 17's plan for one family (a trainer's state): its
    configurations at the trainer's high-water pads (phase 15's fixed pads),
    one epoch of host batches in their layout (its first ``n_batches``; or
    ``batches``, those its phase built, and then ``graph`` None), the
    feature table and the state (numpy, one copy a graph and a trainer in
    ``host``, which the plan's pickle stores once), the model's input and
    output widths, the meshes it runs on; a link trainer's predictor with
    its RMSprop (numpy) and the compare step's negatives, uniform over the
    first batch's rows (seeded), or a multilabel trainer's flag."""
    import numpy as np

    from vq_gnn_tpu_torch.convert import predictor_to_numpy, state_to_numpy
    from vq_gnn_tpu_torch.sampler.samplers import BatchLoader

    xkey = id(tr.X_dev) if graph is None else id(graph[0])
    if xkey not in host:
        host[xkey] = tr.X_dev.cpu().numpy()
    if id(tr) not in host:
        host[id(tr)] = state_to_numpy(tr.state)
    hw = tr.train_loader
    pads = dict(fixed_B_pad=hw._B_bucket, fixed_Bp_pad=hw._Bp_bucket, fixed_E_pad=hw._E_bucket)
    cfgs = {k: dataclasses.replace(v, **pads) for k, v in cfgs.items()}
    base = next(iter(cfgs.values()))
    if batches is None:
        g, c, ci = graph
        loader = BatchLoader(g, base, train_flag=True, cluster_indices=ci, seed=base.seed,
                             device="cuda")
        batches = [w[0] for w, _ in itertools.islice(loader._epoch_iter(), n_batches)]
    link = hasattr(tr, "predictor")
    b0 = batches[0]
    # the 2-D 1 x 2 mesh splits every layer's branches over the model ranks
    # (the ppi input's 52 features make 13 branches: the 1-D mesh alone)
    split = all(nb % SHARDED_RANKS == 0 for nb in tr.ms.num_branches)
    return dict(cfgs=cfgs, timed=timed, batches=batches, X=host[xkey], state=host[id(tr)],
                meshes=("1-D", "2-D 1x2") if split else ("1-D",),
                C_hidden=base.hidden_channels, F=tr.ms.channels[0], C=tr.ms.channels[-1],
                pred=predictor_to_numpy(tr.predictor, tr.pred_opt) if link else None,
                dst_neg=np.random.default_rng(LINK_NEG_SEED).integers(
                    0, max(int(b0.num_B), 1), len(b0.link_src)) if link else None,
                multilabel=getattr(tr, "multilabel", False))


def sage_bm_trainer(torch, ops, graph):
    """The SAGE B + M trainer of phase 17 (the bench's B + M cell, ELL K =
    8) on phase 2's graph in SAGE's v1 normalisation: its init sweep and
    ``SAGE_BM_STEPS`` whole-batch steps on the epoch's first batches, so
    that its codebooks' gradient half, which the recovery term reads, is
    not zero; none counted."""
    from vq_gnn_tpu_torch.config import Config
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    t0 = time.time()
    cfg = bm_cfg(Config, conv_type="SAGE", ell_K=8)
    g, c, ci = graph
    tr = NodeTrainer(g, cfg, c, ci, device="cuda")
    losses = []
    with ops.uncounted():
        tr.run_init_sweep()
        for w, _ in itertools.islice(tr.train_loader._epoch_iter(), SAGE_BM_STEPS):
            tr.state, m = tr.fns.train_step(tr.state, tr.X_dev, w[0].to("cuda"), 1.0, cfg.lr,
                                            1.0, tr.generator)
            losses.append((round(float(m["loss"]), 4), round(float(m["info_backward"]), 4)))
    log(f"[17 setup] SAGE B + M: init sweep and {SAGE_BM_STEPS} steps (loss, info_backward) "
        f"{losses} in {time.time() - t0:.1f}s")
    assert all(math.isfinite(a) and math.isfinite(b) for a, b in losses)
    return tr


def ledger_formula(fname, cf, F, C_out, b0, n_data) -> dict:
    """The bytes a step each rank's ledger must show, by category, on the
    sharded paths of ``LEDGER_FORMULA_FAMILIES`` over ``n_data`` ranks of
    the rows (the 2-D 1 x 2 mesh's data group has one, and moves none of
    these), R = B_pad + Bp_pad of the batch ``b0``: GCN's row exchange, [R,
    C] forward and above layer 0 backward; the transformer's c_max ([nb]
    forward, [2, nb] backward) and out_M normaliser ([nb, M] each way) a
    layer; the link step's output rows [B_pad, C_out] gathered and their
    cotangent summed; the COO GAT conv's per-branch rows [R, nb (D + 1)]
    forward and above layer 0 backward, and its table [R, 2 nb] gathered
    and its cotangent summed a layer."""
    chans = (F,) + (cf.hidden_channels,) * (cf.num_layers - 1)
    nbs = [c // cf.num_D for c in chans]
    many = n_data > 1
    R = b0.B_pad + b0.Bp_pad
    rows = 4 * R * (sum(chans) + sum(chans[1:])) * many
    if fname == "GCN-bm-tr":
        return {"rows": rows,
                "transformer": 4 * sum(3 * nb + 2 * nb * cf.num_M for nb in nbs) * many}
    if fname in ("GCN-link", "GCN-ppi"):
        return {"rows": rows, "link": 2 * 4 * b0.B_pad * C_out * many * (fname == "GCN-link"),
                "transformer": 0, "logits": 0}
    return {"rows": 4 * R * (cf.num_D + 1) * (sum(nbs) + sum(nbs[1:])) * many,
            "logits": 4 * R * 4 * sum(nbs) * many, "transformer": 0}


def sharded_phase(torch, ops, trainers, graphs, gpu, err):
    """Phase 17: one batch sharded over two ranks on the card
    (``parallel/mesh.py``, ``parallel/sharded.py``), the flagship GCN and GAT
    B + B' and the B + M GAT from the states of phase 3's trainers, SAGE
    B + M from :func:`sage_bm_trainer`'s, GCN B + M with the transformer
    from phase 13a's, B + M GAT on COO from phase 14d's, the link step from
    phase 11's and the multilabel step from phase 12's, each on its phase's
    first batch (``trainers['batches']``) (the module docstring says what
    it runs).  Returns the two ranks' launches on the sharded paths."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from vq_gnn_tpu_torch.config import apply_matmul_precision
    from vq_gnn_tpu_torch.convert import predictor_from_numpy, state_from_numpy
    from vq_gnn_tpu_torch.nn.model import model_static
    from vq_gnn_tpu_torch.train.link import make_link_step
    from vq_gnn_tpu_torch.train.step import make_step_fns

    t0 = time.time()
    tr = trainers["GCN"]
    # the step checks in exact f32 (TF32 off, row 6's exact mode), whose sums
    # differ in order only, and at the flagship's own settings, which the
    # timed steps run, in f32 and at bf16 compute
    def exact(cf):
        return dataclasses.replace(cf, matmul_precision="highest", vq_backend="pallas")

    bf16 = dict(compute_dtype="bfloat16")
    mixed, coo = dict(ell_Kt=2), dict(spmm_backend="coo")
    gcn, gat = tr.cfg, trainers["GAT"].cfg
    sage_bm = sage_bm_trainer(torch, ops, graphs["SAGE-bm"])
    tr_of = {"GCN": tr, "GCN-f16": trainers["GCN-f16"], "GAT": trainers["GAT"], "GCN-mixed": tr, "GAT-mixed": trainers["GAT"],
             "GCN-coo": tr, "GAT-coo": trainers["GAT"], "GAT-bm": trainers["GAT-bm"],
             "GAT-bm-bf16": trainers["GAT-bm-bf16"], "SAGE-bm": sage_bm,
             "GCN-bm-tr": trainers["GCN-bm-tr"], "GAT-bm-coo": trainers["GAT-bm-coo"],
             "GCN-link": trainers["GCN-link"], "GCN-ppi": trainers["GCN-ppi"]}
    host = {}
    n3 = SHARDED_STEPS_LAYOUT
    fams = {
        "GCN": _family_plan(tr, graphs["GCN"], {
            "bn": exact(gcn), "no bn": dataclasses.replace(exact(gcn), bn_flag=False),
            "flagship": gcn, "bf16": dataclasses.replace(gcn, **bf16)},
            {"flagship": SHARDED_STEPS, "bf16": SHARDED_STEPS_BF16}, host),
        # f16 compute from phase 3's GCN-f16 trainer (the codebooks frozen
        # after its init sweep, as its path ran), on the epoch's first batch
        "GCN-f16": _family_plan(trainers["GCN-f16"], graphs["GCN"], {
            "f16": trainers["GCN-f16"].cfg}, {"f16": n3}, host, 1),
        "GAT": _family_plan(trainers["GAT"], graphs["GAT"], {
            "exact": exact(gat), "bf16": dataclasses.replace(gat, **bf16)},
            {"bf16": SHARDED_STEPS_BF16}, host),
        # the other layouts, on phase 14's paths (the epoch's first batch):
        # 14a's GCN mixed-K and 14c's GCN COO in exact f32, 14b's GAT
        # mixed-K at bf16 compute, and GAT B + B' on COO in exact f32
        "GCN-mixed": _family_plan(tr, graphs["GCN"], {"exact": exact(
            dataclasses.replace(gcn, **mixed))}, {"exact": n3}, host, 1),
        "GAT-mixed": _family_plan(trainers["GAT"], graphs["GAT"], {
            "bf16": dataclasses.replace(gat, **bf16, **mixed)}, {"bf16": n3}, host, 1),
        "GCN-coo": _family_plan(tr, graphs["GCN"], {"exact": exact(
            dataclasses.replace(gcn, **coo))}, {"exact": n3}, host, 1),
        "GAT-coo": _family_plan(trainers["GAT"], graphs["GAT"], {"exact": exact(
            dataclasses.replace(gat, **coo))}, {"exact": n3}, host, 1),
        # B + M on the epoch's first batch: phase 3's GAT states in exact f32
        # and at bf16 compute (their codebooks trained, so that rows 9-10 read
        # a gradient table that is not zero), SAGE's in exact f32
        "GAT-bm": _family_plan(trainers["GAT-bm"], graphs["GAT-bm"], {
            "exact": exact(trainers["GAT-bm"].cfg)}, {"exact": n3}, host, 1),
        "GAT-bm-bf16": _family_plan(trainers["GAT-bm-bf16"], graphs["GAT-bm"], {
            "bf16": trainers["GAT-bm-bf16"].cfg}, {"bf16": n3}, host, 1),
        "SAGE-bm": _family_plan(sage_bm, graphs["SAGE-bm"], {
            "exact": exact(sage_bm.cfg)}, {"exact": n3}, host, 1),
        # phase 13a's GCN B + M with the transformer (its codebooks and the
        # transformer's trained by an epoch) and phase 14d's B + M GAT on COO,
        # each in exact f32 on the epoch's first batch; the transformer's step
        # once more with c_max's gradient cut on both sides (compare_step)
        "GCN-bm-tr": _family_plan(trainers["GCN-bm-tr"], graphs["GCN-bm"], {
            "exact": exact(trainers["GCN-bm-tr"].cfg),
            f"exact, {CMAX_CUT}": exact(trainers["GCN-bm-tr"].cfg)}, {"exact": n3}, host, 1),
        "GAT-bm-coo": _family_plan(trainers["GAT-bm-coo"], graphs["GAT-bm"], {
            "exact": exact(trainers["GAT-bm-coo"].cfg)}, {"exact": n3}, host, 1),
        # phase 11's link trainer at the collab widths (the link step: the
        # whole batch's output rows gathered) and phase 12's multilabel
        # trainer at the ppi widths (BCE; row 6 at nb = 64, M = 4,096), each
        # on the batch its phase built first, in exact f32
        **{k: _family_plan(trainers[k], None, {"exact": exact(trainers[k].cfg)}, {"exact": n3},
                           host, batches=trainers["batches"][k]) for k in ("GCN-link", "GCN-ppi")},
    }
    del host, sage_bm
    tmp = tempfile.mkdtemp(prefix="chip_smoke_17_")
    with open(os.path.join(tmp, "plan.pkl"), "wb") as f:
        pickle.dump(dict(gpu=gpu, families={
            k: dict(fam, cfgs={t: dataclasses.asdict(v) for t, v in fam["cfgs"].items()})
            for k, fam in fams.items()}), f)
    for fname, fam in fams.items():
        b0, cf = fam["batches"][0], next(iter(fam["cfgs"].values()))
        link = "" if fam["pred"] is None else f", L_pad {len(b0.link_src)}"
        log(f"[17 setup] {fname}: fixed pads B_pad {cf.fixed_B_pad} Bp_pad {cf.fixed_Bp_pad} "
            f"E_pad {cf.fixed_E_pad}; {len(fam['batches'])} batches, the first "
            f"{batch_line(b0, edge_count(b0.edges))}{link}; model {fam['F']} -> {fam['C']}")
    log(f"[17 setup] plan written in {time.time() - t0:.1f}s")

    # the references: train_step (or link_train_step, with the same
    # negatives) on the whole batch from the same state
    refs = {}
    for fname, fam in fams.items():
        X = tr_of[fname].X_dev
        for tag, cf in fam["cfgs"].items():
            apply_matmul_precision(cf)
            ms = model_static(cf, fam["F"], fam["C"], torch.device("cuda"))
            st = state_from_numpy(fam["state"], ms, cf.lr, "cuda")
            b0, decisions, pred = fam["batches"][0].to("cuda"), [], None
            with ops.uncounted(), (cmax_cut() if tag.endswith(CMAX_CUT) else cmax_decisions(
                    decisions) if ms.transformer_flag else contextlib.nullcontext()):
                if fam["pred"] is None:
                    st, m = make_step_fns(ms, cf, fam["multilabel"]).train_step(
                        st, X, b0, 1.0, cf.lr, 1.0)
                else:
                    pred = predictor_from_numpy(*fam["pred"], cf.lr, "cuda")
                    m = make_link_step(ms, cf)[0](st, *pred, X, b0, 1.0, cf.lr, 1.0,
                                                  dst_neg=torch.as_tensor(fam["dst_neg"],
                                                                          device="cuda"))
            refs[fname, tag] = dict(_step_record(torch, st, m, None if pred is None else pred[0]),
                                    cmax=decisions)
            del st, m, b0, pred
    # the whole-batch transformer step's peak is the largest of the phase:
    # hand the two ranks the card with the references' blocks freed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[17 setup] the references in {time.time() - t0:.1f}s; the parent holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB ({torch.cuda.memory_reserved() / 1e9:.3f} "
        f"GB reserved) as the ranks start | {gpu}")

    t1 = time.time()
    mp.spawn(sharded_rank, args=(tmp,), nprocs=SHARDED_RANKS, join=True)
    outs = []
    for r in range(SHARDED_RANKS):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    log(f"[17 ranks] {SHARDED_RANKS} gloo ranks on cuda:0 ran in {time.time() - t1:.1f}s; "
        f"gloo on CUDA tensors: {outs[0]['probe']} | {gpu}")
    assert all(v is True for out in outs for v in out["probe"].values()), outs[0]["probe"]

    apply_matmul_precision(tr.cfg)

    # 17a: one sharded step twice from one state, each rank: the same bits
    for key in outs[0]["same_bits"]:
        same = [out["same_bits"][key] for out in outs]
        log(f"[17a same bits] {key[1]} {key[0]}, {key[2]}: one step twice from one state on "
            f"each rank: {'the same bits' if all(same) else f'DIFFERENT bits {same}'} | {gpu}")
        assert all(same), f"the sharded step differs run to run: {key}"

    # 17a / 17c: each step against train_step on the whole batch
    fails = []
    for fname, fam in fams.items():
        N = fam["X"].shape[0] - 1  # the family's graph (the feature table's dustbin row)
        for tag, cf in fam["cfgs"].items():
            atol = 1e-2 if cf.bn_flag else 1e-4
            held = cf.matmul_precision == "highest"  # exact f32: the codebooks held
            assert outs[0]["digest"]["1-D", fname, tag] == outs[1]["digest"]["1-D", fname, tag], \
                f"the 1-D ranks' states differ ({fname} {tag})"
            ref = refs[fname, tag]
            bm = "-bm" in fname
            # the transformer's family: its step with c_max's gradient whole
            # holds the codebooks' gradient halves on its run with it cut
            tr_fam = f"exact, {CMAX_CUT}" in fam["cfgs"]
            kw = dict(codebooks=held, terms=bm, D=cf.num_D if tr_fam else 0,
                      grads_held=not tr_fam or tag.endswith(CMAX_CUT))
            for mname in fam["meshes"]:
                recs = [out["cmax"][mname, fname, tag] for out in outs]
                if ref["cmax"]:  # the backward of ranks_max: the parts sum to the whole
                    grads = cmax_grads(ref["cmax"], recs)
                    log(f"[17a {fname} {mname}, {tag}] c_max: where the rows that reach it "
                        f"differ (layer, branch, the whole batch's, the shards', its top two "
                        f"squared norms, each rank's c_max and second-largest): "
                        f"{cmax_flips(ref['cmax'], recs)}; the ranks' parts of its cotangent, "
                        f"summed, against the whole batch's (layer, max|diff|, max|whole|; tol "
                        f"1e-5 of max|whole|): {grads}")
                    fails += [(fname, mname, tag, "c_max cotangent", g) for g in grads
                              if g[1] > 1e-5 * g[2]]
            fails += compare_step(f"17a {fname} 1-D vs train_step, {tag}",
                                  outs[0]["1-D", fname, tag], ref, N, atol, gpu, **kw)
            for r in range(SHARDED_RANKS * ("2-D 1x2" in fam["meshes"])):
                fails += compare_step(
                    f"17c {fname} 2-D 1x2 model rank {r} vs train_step, {tag}",
                    outs[r]["2-D 1x2", fname, tag], ref, N, atol, gpu, m=r,
                    n_model=SHARDED_RANKS, **kw)
    assert not fails, fails

    # 17b: the launch counters of each rank, on each path, a step
    launches = {}
    for r, out in enumerate(outs):
        for path, counts in out["launches"].items():
            n = out["path_steps"][path]
            per = {}  # a step, each kernel's f32 and 16-bit modes together
            for k, v in counts.items():
                if v:
                    base = k.removesuffix("_bf16").removesuffix("_f16")
                    per[base] = per.get(base, 0) + v / n
            log(f"[17b launches] rank {r} {path}: {counts} over {n} steps; a step, both modes: "
                f"{ {k: round(v, 3) for k, v in per.items()} }")
            for name in SHARDED_KERNELS[path.split()[0]]:
                assert counts[name] > 0, f"kernel {name} was not launched on rank {r}'s {path}"
            if path.startswith("GCN-bm-tr"):
                assert counts["vq_assign"] == TR_ASSIGNS * n, (path, r, counts["vq_assign"], n)
            for name in SHARDED_NOT.get(path.split()[0], ()):
                assert counts[name] == 0, f"kernel {name} ran on rank {r}'s {path}"
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        for k, v in out["err"].items():
            err[k] = max(err.get(k, 0.0), v)

    # 17d: timing and the ledger; nothing table- or edge-shaped rides a collective
    for path, st in outs[0]["steps"].items():
        fname = path.split()[0]
        fam = fams[fname]
        b0 = fam["batches"][0]
        X = fam["X"]  # the family's feature table, [N + 1, F]
        N, x_bytes = X.shape[0] - 1, X.nbytes
        cidx_bytes = (N + 1) * tr_of[fname].state.vq_states[0].c_indices.shape[1] * 2
        nb_M = {(nb, next(iter(fam["cfgs"].values())).num_M)
                for nb in tr_of[fname].ms.num_branches}  # a codebook's leading dims
        banned = edge_shapes(b0.edges) | rev_shapes(b0)
        col_bytes = max(math.prod(sh) for sh in banned) * 4  # the largest edge array
        if b0.link_src is not None:  # the pairs ride no collective either
            banned.add((len(b0.link_src),))
        busy = "not measured" if st["busy"] is None else f"{st['busy']:.3f}"
        idle = ("not measured" if st["busy"] is None
                else f"{100 * (1 - st['busy'] / st['wall']):.1f} %")
        log(f"[17d {path}] {st['n']} steps on rank 0: {st['ms']:.2f} ms/step (std "
            f"{st['std']:.2f}, median {st['median']:.2f}), device busy {busy} ms/step, idle "
            f"{idle}, peak {st['peak'] / 1e9:.3f} GB above the {st['held'] / 1e9:.3f} GB the "
            f"rank held; losses {[round(x, 4) for x in st['losses'][:4]]}... | {gpu}")
        assert all(math.isfinite(x) for x in st["losses"])
        if st["kernels"] is not None:
            bf = "bf16" in path
            for name, kernel in SHARDED_KERNELS[fname].items():
                if name.endswith("_bf16") == bf or not name.startswith(("ell", "gat")):
                    assert any(kernel in k for k in st["kernels"]), \
                        f"{kernel} not in the profile of {path}"
        for r, out in enumerate(outs):
            sr = out["steps"][path]
            log(f"[17d memory] {path} rank {r}: peak {sr['peak'] / 1e9:.3f} GB above the "
                f"{sr['held'] / 1e9:.3f} GB the rank held | {gpu}")
            led = out["ledger"][path]
            per = led["per_step"]
            log(f"[17d ledger] {path} rank {r}: {led['steps']} steps; bytes a step "
                f"{per['bytes']}; calls a step {per['calls']}; "
                f"{sum(per['bytes'].values()) / 1e6:.4f} MB a step in all")
            if fname in LEDGER_FORMULA_FAMILIES:  # to the byte
                cf = next(iter(fam["cfgs"].values()))
                want = ledger_formula(fname, cf, fam["F"], fam["C"], b0,
                                      1 if "2-D" in path else SHARDED_RANKS)
                got = {k: per["bytes"][k] for k in want}
                log(f"[17d ledger] {path} rank {r}: {got} bytes a step, the formula {want}")
                assert got == want, (path, r, got, want)
            biggest = 0
            for kind in led["kinds"]:
                nbytes = sum(math.prod(s) for s in kind[3]) * torch.empty(
                    0, dtype=getattr(torch, kind[2])).element_size()
                biggest = max(biggest, nbytes)
                if r == 0:
                    log(f"[17d ledger]   {kind}: {nbytes} B a call")
                # at the ppi widths the batch holds most of its small graph
                # (50 features), so two payloads outweigh its feature table by
                # nature: the row exchange, 256 wide, which the formula holds
                # to the byte, and the codebooks' EMA sums, [nb, M] and [nb,
                # M, K] at M = 4,096, which grow with the codebooks, not the
                # graph
                codebook = kind[0] == "stats" and all(
                    tuple(s[:2]) in nb_M for s in kind[3] if len(s) >= 2)
                if not (fname == "GCN-ppi" and (kind[0] == "rows" or codebook)):
                    assert nbytes < x_bytes, f"a payload as large as the feature table: {kind}"
                for s in kind[3]:
                    assert not (len(s) and s[0] == N + 1) and tuple(s) not in banned, \
                        f"a table- or edge-shaped payload: {kind}"
                if "bf16" in path and kind[0] == "rows":  # the exchange rides at bf16
                    assert kind[2] == "bfloat16", f"a widened row payload: {kind}"
                if "-f16" in path and kind[0] == "rows":  # ... and at f16
                    assert kind[2] == "float16", f"a widened row payload: {kind}"
            if r == 0:
                log(f"[17d ledger] {path}: the largest payload {biggest / 1e6:.2f} MB against "
                    f"the feature table {x_bytes / 1e6:.2f} MB, a c_indices table "
                    f"{cidx_bytes / 1e6:.2f} MB and the largest edge array "
                    f"{col_bytes / 1e6:.2f} MB")
    return launches


def state_leaves(state):
    """[(archive name, numpy leaf)] of a port train state or link tree."""
    from vq_gnn_tpu_torch.train.checkpoint import _numpy, named_leaves

    return [(n, _numpy(leaf)) for n, leaf in named_leaves(state)]


def assert_same_leaves(tag, a, b):
    """Two [(name, leaf)] lists: the same names, dtypes, shapes and bits."""
    assert [n for n, _ in a] == [n for n, _ in b], f"[{tag}] the archive names differ"
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all(), (
            f"[{tag}] leaf {name} differs")


def upkeep_phase(torch, ops, NodeTrainer, Config, graphs, gpu, runs):
    """Phase 16: checkpoints, 'scan' and k-means (the module docstring says
    what it runs).  Returns its launch counts."""
    import tempfile

    import link_experiment_torch as tool
    from vq_gnn_tpu_torch.convert import state_like, state_to_numpy
    from vq_gnn_tpu_torch.graph.datasets import prepare
    from vq_gnn_tpu_torch.train.checkpoint import load_step, restore_checkpoint, save_checkpoint
    from vq_gnn_tpu_torch.train.link import LinkTrainer
    from vq_gnn_tpu_torch.train.step import make_step_fns

    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    g, c, ci = graphs["GCN"]
    with tempfile.TemporaryDirectory() as d:
        # ---- a. node checkpoints at the flagship widths ----
        cfg = flagship_cfg(Config, epochs=2)
        tr = NodeTrainer(g, cfg, c, ci, device="cuda")
        new_path_start(torch, ops)
        t0 = time.time()
        tr.fit(ckpt_dir=d, ckpt_every=1, verbose=False)
        torch.cuda.synchronize()
        add(ops.launch_counts())
        path = os.path.join(d, "run0.npz")
        log(f"[16a fit] 2 epochs with ckpt_dir in {time.time() - t0:.1f}s; results "
            f"{tr.logger.results[0]}; archive step {load_step(path)}")
        assert load_step(path) == 2
        want = state_leaves(tr.state)
        t0 = time.time()
        save_checkpoint(os.path.join(d, "again.npz"), tr.state, step=2)
        t_save = time.time() - t0
        tr2 = NodeTrainer(g, dataclasses.replace(cfg, epochs=3), c, ci, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        tr2.state = restore_checkpoint(path, tr2.state)
        torch.cuda.synchronize()
        t_restore = time.time() - t0
        assert_same_leaves("16a restore", state_leaves(tr2.state), want)
        acc, acc2 = tr.evaluate(), tr2.evaluate()
        mb = os.path.getsize(path) / 1e6
        cidx = sum(x.nbytes for n, x in want if n.endswith(".c_indices")) / 1e6
        log(f"[16a archive] {mb:.2f} MB ({cidx:.2f} MB of it c_indices, int16), {len(want)} "
            f"leaves; save {t_save:.2f}s, restore onto the card {t_restore:.2f}s; evaluation "
            f"of the restored trainer {acc2}, of the original {acc} | {gpu}")
        assert acc2 == acc, (acc2, acc)
        new_path_start(torch, ops)
        t0 = time.time()
        tr2.fit(ckpt_dir=d, resume=True)
        torch.cuda.synchronize()
        launched = ops.launch_counts()
        add(launched)
        log(f"[16a resume] epoch 3 in {time.time() - t0:.1f}s: results {tr2.logger.results[0]}; "
            f"launches {launched}")
        assert len(tr2.logger.results[0]) == 1 and tr2.state.step > tr.state.step
        for name in NEW_PATH_KERNELS:
            assert launched[name] > 0, f"kernel {name} was not launched in the resumed epoch"
        tr_cpu = NodeTrainer(g, cfg, c, ci, device="cpu")
        t0 = time.time()
        cpu_state = restore_checkpoint(path, tr_cpu.state)
        assert next(cpu_state.model.parameters()).device.type == "cpu"
        assert cpu_state.vq_states[0].c_indices.device.type == "cpu"
        assert_same_leaves("16a cpu", state_leaves(cpu_state), want)
        log(f"[16a cpu] the archive restores into a CPU trainer bit-identical in "
            f"{time.time() - t0:.2f}s")
        del tr, tr2, tr_cpu, cpu_state

        # ---- b. link checkpoints on a 3,000-node graph ----
        lg, split = tool.build_graph_and_split(nodes=3000)
        lcfg = tool.scaled_config(tool.vq_config("GCN", 2), 3000)
        lg, _, _ = prepare(lg, lcfg, 0, symmetrize_adj=False)
        ltr = LinkTrainer(lg, lcfg, split, device="cuda")
        new_path_start(torch, ops)
        ltr.fit(ckpt_dir=d, ckpt_every=1, verbose=False)
        add(ops.launch_counts())
        lpath = os.path.join(d, "link_run0.npz")
        lwant = state_leaves(ltr._ckpt_tree())
        ltr2 = LinkTrainer(lg, dataclasses.replace(lcfg, epochs=3), split, device="cuda")
        restored = restore_checkpoint(lpath, ltr2._ckpt_tree())
        assert_same_leaves("16b restore", state_leaves(restored), lwant)
        new_path_start(torch, ops)
        ltr2.fit(ckpt_dir=d, resume=True)
        torch.cuda.synchronize()
        add(ops.launch_counts())
        hits = ltr2.logger.results[0]
        log(f"[16b link] {len(lwant)} leaves (predictor and nu among them) bit-identical; "
            f"resumed at epoch {load_step(lpath) + 1}: Hits@50 {hits}")
        assert len(hits) == 1 and all(math.isfinite(h) for h in hits[0])

    # ---- c. 'scan' against 'xla' and 'pallas' from one state ----
    tr3, b0 = runs["3 GCN"]["tr"], runs["3 GCN"]["batch0"]
    B, idx = b0.num_B, b0.batch_idx[: b0.num_B]
    assigned, peaks = {}, {}
    for backend in ("scan", "xla", "pallas"):
        ms = dataclasses.replace(tr3.ms, vq=dataclasses.replace(tr3.ms.vq, backend=backend))
        fns = make_step_fns(ms, tr3.cfg)
        st = state_like(tr3.state, state_to_numpy(tr3.state))
        base = new_path_start(torch, ops)
        st, m = fns.train_step(st, tr3.X_dev, b0, 1.0, tr3.cfg.lr, 1.0, tr3.generator)
        torch.cuda.synchronize()
        peaks[backend] = torch.cuda.max_memory_allocated() - base
        add(ops.launch_counts())
        assert math.isfinite(float(m["loss"])) and not bool(m["bad_init"])
        assigned[backend] = torch.stack([s.c_indices[idx] for s in st.vq_states])
        del st
    n = assigned["scan"].numel()
    agree = {b: float((assigned[b] == assigned["scan"]).sum()) / n for b in ("xla", "pallas")}
    log(f"[16c one step] B={B}: 'scan' agrees with 'xla' on {agree['xla']:.6f} and with "
        f"'pallas' (exact) on {agree['pallas']:.6f} of {n} assignments; peak above the state: "
        + ", ".join(f"{b} {p / 1e9:.3f} GB" for b, p in peaks.items()) + f" | {gpu}")
    assert min(agree.values()) >= 0.9999, agree
    assert peaks["scan"] < peaks["xla"], peaks
    r = drive_path(torch, ops, NodeTrainer, "16c scan", graphs["GCN"],
                   flagship_cfg(Config, vq_backend="scan"), gpu, NEW_TIMED_STEPS, profile=False,
                   evaluate=False, kernels=SCAN_KERNELS)
    add(r["launches"])
    r3 = runs["3 GCN"]
    log(f"[16c summary] GCN B + B' under 'scan' {r['ms']:.2f} ms/step, peak {r['peak'] / 1e9:.3f} "
        f"GB; phase 3 ('pallas_fast') {r3['ms']:.2f} ms/step, peak {r3['peak'] / 1e9:.3f} GB "
        f"| {gpu}")
    assert r["launches"]["vq_assign"] == 0, "row 6 ran under vq_backend='scan'"
    del r

    # ---- d. kmeans_init ----
    cfg = flagship_cfg(Config, kmeans_init=True, epochs=1)
    trk = NodeTrainer(g, cfg, c, ci, device="cuda")
    try:
        import sklearn.cluster  # noqa: F401
    except ImportError:
        try:
            trk.fit(verbose=False)
        except ImportError as e:
            log(f"[16d kmeans_init] scikit-learn cannot be imported here; fit raised: {e}")
            assert "kmeans_init" in str(e) and "scikit-learn" in str(e)
            return counts
        raise AssertionError("kmeans_init trained without scikit-learn")
    new_path_start(torch, ops)
    t0 = time.time()
    trk.seed_kmeans()
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    add(launched)
    D = cfg.num_D
    for l, s in enumerate(trk.state.vq_states):
        size = s.ema_cluster_size
        cent = s.ema_w[:, :, :D] / size.clamp(min=1.0)[:, :, None]
        used = (size > 0)[:, :, None].expand_as(cent)
        assert torch.allclose(s.embedding[:, :, :D][used], cent[used], rtol=1e-5, atol=1e-6), l
    log(f"[16d kmeans_init] seed_kmeans in {time.time() - t0:.1f}s; each layer's feature half "
        f"equals its centroids; launches {launched}")
    for name in SCAN_KERNELS:
        assert launched[name] > 0, f"kernel {name} was not launched by seed_kmeans"
    return counts


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
    from vq_gnn_tpu_torch.ops.vq_kernels import fused_assign_branches
    from vq_gnn_tpu_torch.train.loop import NodeTrainer

    import bench_torch
    import main_node_torch

    gpu = gpu_line()
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} | {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.time()
    starts = []  # (phase, its start): the breakdown logged at the end

    def phase(name):
        starts.append((name, time.time()))

    # ---- 1. build the kernels ----
    phase("1 build")
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
    log(f"[1 build] kernels that spill registers: {spilling(reports) or 'none'}")

    # ---- 2. graph, normalised per conv ----
    phase("2 graph")
    t0 = time.time()
    raw = synthetic_sbm(num_nodes=N_NODES, num_classes=N_CLASSES, num_features=N_FEAT,
                        avg_degree=AVG_DEG, seed=0)
    graphs = {}
    for conv in ("GCN", "SAGE", "GAT"):
        g, c = copy.deepcopy(raw)
        graphs[conv] = prepare(g, flagship_cfg(Config, conv_type=conv), c)
    g, c = copy.deepcopy(raw)
    graphs["GCN-bm"] = prepare(g, bm_cfg(Config, conv_type="GCN"), c)  # for phase 13a
    g, c = copy.deepcopy(raw)
    graphs["SAGE-bm"] = prepare(g, bm_cfg(Config, conv_type="SAGE"), c)  # for phase 17
    g, c = raw
    graphs["GAT-bm"] = prepare(g, bm_cfg(Config), c)  # v1 normalisation, no partition
    del raw
    g = graphs["GCN"][0]
    log(f"[2 graph] N={g.num_nodes} E(GCN-normalized, with self-loops)={g.num_edges} "
        f"parts={len(graphs['GCN'][2])} in {time.time() - t0:.1f}s")

    # ---- 3-4. the training paths, through the trainer ----
    phase("3-4 paths")
    runs = {}
    for tag, kind, cfg_p, steps, full in (
        ("3 GCN", "GCN", flagship_cfg(Config), TIMED_STEPS, True),
        ("3 SAGE", "SAGE", flagship_cfg(Config, conv_type="SAGE"), 3, False),
        ("3 GAT", "GAT", flagship_cfg(Config, conv_type="GAT"), TIMED_STEPS, True),
        ("3 GAT-256", "GAT",
         flagship_cfg(Config, conv_type="GAT", num_layers=2, hidden_channels=256), 2, False),
        ("3 GAT-bm", "GAT-bm", bm_cfg(Config), TIMED_STEPS, True),
        ("3 GAT-bf16", "GAT-bf16", flagship_cfg(Config, conv_type="GAT",
                                                compute_dtype="bfloat16"), TIMED_STEPS, True),
        ("3 GAT-bm-bf16", "GAT-bm-bf16", bm_cfg(Config, compute_dtype="bfloat16"), TIMED_STEPS,
         True),
        ("3 GCN-bf16", "GCN-bf16", flagship_cfg(Config, compute_dtype="bfloat16"), 3, False),
        ("3 GAT-256-bf16", "GAT-bf16",
         flagship_cfg(Config, conv_type="GAT", num_layers=2, hidden_channels=256,
                      compute_dtype="bfloat16"), 2, False),
        ("3 GCN-f16", "GCN-f16", flagship_cfg(Config, **F16_PATH), 3, False),
        ("3 GAT-f16", "GAT-f16", flagship_cfg(Config, conv_type="GAT", **F16_PATH), 3, False),
        ("3 GAT-256-f16", "GAT-f16",
         flagship_cfg(Config, conv_type="GAT", num_layers=2, hidden_channels=256, **F16_PATH),
         3, False),
    ):
        graph = graphs["GAT-bm" if cfg_p.formulation == "bm" else cfg_p.conv_type]
        runs[tag] = drive_path(torch, ops, NodeTrainer, tag, graph, cfg_p, gpu, steps,
                               profile=full, evaluate=full, kernels=PATH_KERNELS[kind],
                               same_bits=tag in SAME_BITS_PATHS)
        if tag not in ("3 GCN", "3 GAT", "3 GAT-bm", "3 GAT-bm-bf16", "3 GCN-f16"):
            runs[tag].pop("tr")  # only these trainers' states are read later
    for tag, dtype in (("3 GAT-256", "float32"), ("3 GAT-256-bf16", "bfloat16"),
                       ("3 GAT-256-f16", "float16")):
        assert runs[tag]["by_width"].get((256, dtype), 0) > 0, (
            f"gat_backward never ran at C = 256 in {dtype} on the {tag} path")
    log("[3 summary] ms/step " + ", ".join(
        f"{tag[2:]} {r['ms']:.2f} (std {r['std']:.2f})" for tag, r in runs.items()) + f" | {gpu}")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in ops.launch_counts()}
    log(f"[4 launches] all paths: {launches}")
    tr, b0, test_batches = (runs["3 GCN"][k] for k in ("tr", "batch0", "test_batches"))
    cfg = tr.cfg
    e0 = b0.edges

    # ---- 5. kernels against their plain versions at the real shapes ----
    phase("5 kernels vs plain")
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

    # kernel 1's 16-bit-row modes (GCN and SAGE under bf16 or f16 compute)
    # on the same batch, x and the cotangent in bf16 or f16: against the
    # plain version on the same 16-bit values (f32 sums in another order, the
    # tolerance above), and the same bits run to run, at every panel count
    # and without the lists
    rows16 = {"_bf16": torch.bfloat16, "_f16": torch.float16}  # the modes' suffixes
    ell16 = {sfx: {"forward": (x.to(dt), *fwd_args[1:]), "dx": (gx.to(dt), *dx_args[1:])}
             for sfx, dt in rows16.items()}
    for sfx, by_label in ell16.items():
        name = "ell_aggregate" + sfx
        for label, args in by_label.items():
            kw = ell_kw[label]
            out, ref = ell_aggregate(*args, **kw), ell_aggregate_plain(*args)
            torch.cuda.synchronize()
            d = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            log(f"[5 {name} {label}] out {tuple(out.shape)} {out.dtype} max|err| {d:.3g} (tol "
                f"{tol:.3g})")
            assert out.dtype == torch.float32 and torch.isfinite(out).all() and d <= tol
            err[name] = max(err.get(name, 0.0), d)
            same = {"again": ell_aggregate(*args, **kw),
                    **{f"P={P}": ell_aggregate(*args, panels=P, **kw) for P in (1, 2, 4)},
                    "offsets built on the device, rows in index order": ell_aggregate(*args)}
            torch.cuda.synchronize()
            same = {k: torch.equal(v, out) for k, v in same.items()}
            log(f"[5 {name} {label}] bit-identical to the first call: {same}")
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
    for label, xx, emb, vv in cases:
        hold_assign(torch, 5, label, xx, emb, vv, err)
    # no float atomics: two calls give the same bits in fast mode too
    first, second = (fused_assign_branches(xn, vq1.embedding.contiguous(), valid, fast=True)
                     for _ in range(2))
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[5 vq_assign vq_update fast=True] two calls bit-identical (idx, counts, sums): {same}")
    assert same

    vq0 = tr.state.vq_states[0]
    hold_lookup(torch, 5, "B + B'", vq0, b0.fo_ids, cfg.num_D)
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

    # the bf16-row and f16-row modes of kernels 4 and 5 (GAT under bf16 or
    # f16 compute) on the same inputs rounded where the conv passes 16-bit
    # values: x, and g_agg, g_rowsum and ar in the backward (al and the
    # aggregate's ar stay f32); against the plain versions on the same
    # 16-bit values, tolerance as above
    gat_fwd16, gat_bwd16 = {}, {}  # by (suffix, width)
    for sfx, dt in rows16.items():
        for width in (C, 256):
            xw, *rest = gat_fwd[width]
            args = gat_fwd16[sfx, width] = (xw.to(dt), *rest)
            for with_neg in (True, False):
                ref = gat_aggregate_plain(*args, with_neg=with_neg)
                out = gat_aggregate(*args, with_neg=with_neg, **fwd_lists)
                hold(f"C={width} with_neg={with_neg}", "gat_aggregate" + sfx, out, ref)
                again = gat_aggregate(*args, with_neg=with_neg)
                torch.cuda.synchronize()
                same = all(a is b or torch.equal(a, b) for a, b in zip(out, again))
                log(f"[5 gat_aggregate{sfx} C={width} with_neg={with_neg}] bit-identical with "
                    f"the offsets built on the device and no long-row list: {same}")
                assert same
            xw, t_r, t_c, t_v, g_agg, g_rs, alw, arw, _ = gat_bwd[width]
            args = gat_bwd16[sfx, width] = (xw.to(dt), t_r, t_c, t_v, g_agg.to(dt), g_rs.to(dt),
                                            alw, arw.to(dt), Rg)
            for dxr in gat_dx_rows:
                out = gat_backward(*args, dx_rows=dxr, **gat_lists)
                hold(f"C={width} dx_rows={dxr}", "gat_backward" + sfx, out,
                     gat_backward_plain(*args, dx_rows=dxr))
                again = gat_backward(*args, dx_rows=dxr, **gat_lists)
                torch.cuda.synchronize()
                same = all(a is b or torch.equal(a, b) for a, b in zip(out, again))
                zero = out[0] is None or not out[0][dxr:].any()
                log(f"[5 gat_backward{sfx} C={width} dx_rows={dxr}] bit-identical over two "
                    f"calls: {same}; zeros above dx_rows: {zero}")
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

    def rev_plain(xb, al, arcb, gbar, g, fold="x2"):
        leaves = [t.clone().requires_grad_(True) for t in (xb, al, arcb)]
        info = rev_recovery_info_plain(rev_in["c_indices"], rev_in["slot_col"],
                                       rev_in["slot_val"], rev_in["slot_row"], *leaves, gbar,
                                       fold=fold)
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

    # the bf16 fold (VQ_GNN_REV_FOLD=fast) on the same batch and inputs,
    # against the plain 'fast' version: both round each value to bf16 and
    # each add of a codeword's cells within a slot, so what differs is the
    # f32 sums of the slot parts and of the contraction: the tolerance above
    ref16 = rev_plain(rev_in["xb"], rev_in["al"], rev_in["arcb"], rev_in["gbar"], g_rev, "fast")
    outs16 = (rev_forward(**rev_k, fold="fast"), *rev_backward(**rev_k, g=g_rev, fold="fast"))
    again16 = (rev_forward(**rev_k, fold="fast"), *rev_backward(**rev_k, g=g_rev, fold="fast"))
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(outs16, again16))
    log(f"[5 rev fold=fast] info, d_xb, d_al, d_arcb bit-identical over two calls: {same_bits}; "
        f"info apart from the f32 fold's: {not torch.equal(outs16[0], outs[0])}")
    assert same_bits and not torch.equal(outs16[0], outs[0])
    for i, (name, o, r, b) in enumerate(zip(("info", "d_xb", "d_al", "d_arcb"), outs16, ref16,
                                            absb)):
        d = (o - r).abs()
        tol = 1e-5 * b + 1e-6 * float(b.max())
        ratio = float((d / tol).max())
        log(f"[5 rev fold=fast {name}] {tuple(o.shape)} max|err| {float(d.max()):.3g} max|ref| "
            f"{float(r.abs().max()):.3g} ({ratio:.4g} of the tolerance); max|fast - f32 fold| "
            f"{float((r - ref[i]).abs().max()):.3g}")
        assert torch.isfinite(o).all() and ratio <= 1.0
        key = "rev_forward_fold_bf16" if i == 0 else "rev_backward_fold_bf16"
        err[key] = max(err.get(key, 0.0), float(d.max()))

    # kernels 2 and 3 at the B + M widths: K = 2 * D + 1 = 9, M = 1,024
    emb_bm = vq_bm.embedding.contiguous()
    Kb = emb_bm.shape[2]
    xn_bm = torch.randn((nb_bm, Bb, Kb), generator=gen, device=dev)
    valid_bm = bmb.valid_B.contiguous()
    hold_assign(torch, 5, "B + M", xn_bm, emb_bm, valid_bm, err)
    hold_lookup(torch, 5, "B + M", vq_bm, bmb.fo_ids, Dq)

    # ---- 6. times: kernel, plain version, library yardstick ----
    phase("6 times")
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

    # kernel 1's bf16-row and f16-row modes beside its f32 mode at the same
    # shapes, in this call: 16-bit rows halve the gathered bytes, so a time
    # that falls towards half of the f32 one says the gathers' bytes (L2)
    # held the f32 kernel back, one that hardly moves says its chains of
    # dependent loads did; the f16 mode moves the bf16 mode's bytes, so the
    # two should take about the same time.  Library yardstick:
    # torch.sparse.mm on the same values widened to f32 (no PyTorch call
    # takes 16-bit rows into f32 sums)
    ell16_ms = {}
    for sfx, by_label in ell16.items():
        name = "ell_aggregate" + sfx
        for label, n_out in (("forward", R), ("dx", e0.b_rows)):
            args = by_label[label]
            xx, row, col, val, _ = args
            kw = ell_kw[label]
            S_, K = col.shape
            nnz_ = live_cells(row, val, n_out)
            xf = xx.float()
            csr_ = csr_of(torch, row, col, val, n_out, R)
            t = {
                "ms": cuda_time_ms(torch, lambda: ell_aggregate(*args, **kw)),
                "plain_ms": cuda_time_ms(torch, lambda: ell_aggregate_plain(*args), reps=5),
                "library_ms": cuda_time_ms(torch, lambda: torch.sparse.mm(csr_, xf)),
            }
            ell16_ms[sfx, label] = t["ms"]
            f32_ms = cuda_time_ms(torch, lambda: ell_aggregate(xf, *args[1:], **kw))
            # x at 2 bytes a value, the slots, the f32 output
            b_ms, b_by = bound(R * C * 2 + S_ * 4 + 2 * S_ * K * 4 + n_out * C * 4,
                               2 * nnz_ * C, F32_FLOPS)
            dev16 = kernel_split(torch, lambda: ell_aggregate(*args, **kw))
            dev32 = kernel_split(torch, lambda: ell_aggregate(xf, *args[1:], **kw))
            vs_bf16 = ("" if sfx == "_bf16" else f"; the bf16 mode at these shapes "
                       f"{ell16_ms['_bf16', label]:.4f} ms ({sfx[1:]} / bf16 "
                       f"{t['ms'] / ell16_ms['_bf16', label]:.3f})")
            log(f"[6 {name} {label}] rows={n_out} slots={S_} nnz={nnz_}: {t} bound "
                f"{b_ms:.4f} ms ({b_by}); the f32 mode on the same values {f32_ms:.4f} ms "
                f"({sfx[1:]} / f32 {t['ms'] / f32_ms:.3f}){vs_bf16}; device us per call "
                f"{sfx[1:]} {dev16}, f32 {dev32}; gathered {nnz_ * C * 2 / 1e6:.1f} MB at "
                f"{nnz_ * C * 2 / t['ms'] / 1e9:.3f} TB/s; library_ms: torch.sparse.mm on x "
                f"widened to f32 | {gpu}")
            if label == "forward":
                kern[name] = dict(
                    source="vq_gnn_tpu_torch/csrc/ell_aggregate.cu",
                    replaces="vq_gnn_tpu/ops/pallas_ell.py:111", **t, bound_ms=b_ms,
                    bound_by=b_by)

    emb1 = vq1.embedding.contiguous()

    t, b_ms, b_by, _ = assign_times(torch, 6, "B + B'", xn, emb1, valid, gpu)
    kern["vq_assign"] = dict(
        source="vq_gnn_tpu_torch/csrc/vq_assign.cu",
        replaces="vq_gnn_tpu/ops/pallas_vq.py:140", **t, bound_ms=b_ms, bound_by=b_by)
    # the single-branch TPU kernel (pallas_vq.py:33) is kernel 2 at nb = 1
    assign_times(torch, 6, "nb=1 (replaces vq_gnn_tpu/ops/pallas_vq.py:33)",
                 xn[:1].contiguous(), emb1[:1].contiguous(), valid, gpu)

    kern["vq_lookup"] = dict(
        source="vq_gnn_tpu_torch/csrc/vq_lookup.cu", replaces="vq_gnn_tpu/ops/pallas_vq.py:276",
        **lookup_times(torch, 6, "B + B'", vq0, b0.fo_ids, cfg.num_D, gpu)[0])

    # GAT: no single PyTorch call computes an attention-weighted aggregate or
    # its transposed backward, so there is no library yardstick
    Sg, Kg = ge.ell_col.shape
    Stg = ge.t_ell_col.shape[0]
    nnz_g = int((ge.ell_val != 0).sum())
    nnz_gt = int((ge.t_ell_val != 0).sum())
    # the ELL's columns and values, and the row offsets and long rows the
    # kernel reads in place of its rows
    fell_bytes = 2 * Sg * Kg * 4 + (Rg + 1) * 4 + ge.ell_long_rows.numel() * 4
    # each kernel beside its bf16-row and f16-row modes at the same shapes,
    # in this call: 16-bit rows halve the gathered bytes, so a mode that
    # falls towards half of the f32 time says the gathered bytes (L2) held
    # the f32 kernel back, one that hardly moves says its chains of
    # dependent loads did; the f16 mode moves the bf16 mode's bytes.  The
    # f16 mode's plain version is timed at the calls its rows report only
    def modes(base, f32_args, args16):
        """(name, {width: args}, bytes a row value) of a kernel's modes."""
        return [(base, f32_args, 4)] + [
            (base + sfx, {w: args16[sfx, w] for w in (C, 256)}, 2) for sfx in rows16]

    def versus(times, name, key, ms):
        """The f32 mode's time (and the bf16 mode's for an f16 mode) at key."""
        if not name.endswith("16"):
            return ""
        base = name.rsplit("_", 1)[0]
        f32 = times[(base,) + key]["ms"]
        vs = f"; the f32 mode {f32:.4f} ms ({name.rsplit('_', 1)[1]} / f32 {ms / f32:.3f})"
        if name.endswith("_f16"):
            bf = times[(base + "_bf16",) + key]["ms"]
            vs += f", the bf16 mode {bf:.4f} ms (f16 / bf16 {ms / bf:.3f})"
        return vs

    fwd_t = {}
    for name, args_by_width, xb in modes("gat_aggregate", gat_fwd, gat_fwd16):
        for width, with_neg in ((C, True), (C, False), (256, True)):
            def run():
                return gat_aggregate(*args_by_width[width], with_neg=with_neg, **fwd_lists)

            tt = {"ms": cuda_time_ms(torch, run), "plain_ms": None, "library_ms": None}
            if width == C and with_neg:
                tt["plain_ms"] = cuda_time_ms(
                    torch, lambda: gat_aggregate_plain(*args_by_width[width], with_neg=True),
                    reps=5)
            # x (xb bytes a value), al, ar and the ELL in; agg, rowsum (and
            # aggn, rsn) out; per live cell one FMA over C for agg (and aggn)
            outs_n = 2 if with_neg else 1
            bb, bb_by = bound(Rg * width * xb + 2 * Rg * 4 + fell_bytes
                              + outs_n * (Rg * width * 4 + Rg * 4), 2 * outs_n * nnz_g * width,
                              F32_FLOPS)
            fwd_t[name, width, with_neg] = dict(**tt, bound_ms=bb, bound_by=bb_by)
            vs = versus(fwd_t, name, (width, with_neg), tt["ms"])
            gathered = nnz_g * width * xb
            log(f"[6 {name}] C={width} with_neg={with_neg} R={Rg} S={Sg} nnz={nnz_g}: {tt} "
                f"bound {bb:.4f} ms ({bb_by}){vs}; device us per call "
                f"{kernel_split(torch, run)}; gathered {gathered / 1e6:.1f} MB at "
                f"{gathered / tt['ms'] / 1e9:.3f} TB/s | {gpu}")
        kern[name] = dict(  # the conv's training call
            source="vq_gnn_tpu_torch/csrc/gat_aggregate.cu",
            replaces="vq_gnn_tpu/ops/pallas_ell.py:111", **fwd_t[name, C, True])
    no_lists = cuda_time_ms(torch, lambda: gat_aggregate(*gat_fwd[C], with_neg=True))
    log(f"[6 gat_aggregate] C={C} with_neg=True with the offsets built on the device and no "
        f"long-row list {no_lists:.4f} ms; library_ms null: no single PyTorch call computes "
        f"it | {gpu}")
    tell_bytes = 2 * Stg * Kg * 4 + (Rg + 1) * 4 + ge.t_all_long_rows.numel() * 4
    t_live = (ge.t_ell_val != 0) & (ge.t_ell_row[:, None] < Rg)
    bwd_t = {}
    for name, args_by_width, xb in modes("gat_backward", gat_bwd, gat_bwd16):
        for width, args in args_by_width.items():
            for dxr in gat_dx_rows:
                def run():
                    return gat_backward(*args, dx_rows=dxr, **gat_lists)

                tt = {"ms": cuda_time_ms(torch, run), "plain_ms": None, "library_ms": None}
                if not name.endswith("_f16") or dxr == Rg:
                    tt["plain_ms"] = cuda_time_ms(
                        torch, lambda: gat_backward_plain(*args, dx_rows=dxr), reps=5)
                # x, g_agg, g_rowsum and ar (xb bytes a value), al and the
                # ELL in, d_al and (with dx_rows > 0) dx_agg out; per live
                # cell a dot over C, and an FMA over C where its row is <
                # dx_rows
                nnz_dx = int((t_live & (ge.t_ell_row[:, None] < dxr)).sum())
                bb, bb_by = bound(2 * Rg * width * xb + (dxr > 0) * Rg * width * 4
                                  + Rg * (2 * xb + 4 + 4) + tell_bytes,
                                  2 * (nnz_gt + nnz_dx) * width, F32_FLOPS)
                bwd_t[name, width, dxr] = dict(**tt, bound_ms=bb, bound_by=bb_by)
                vs = versus(bwd_t, name, (width, dxr), tt["ms"])
                log(f"[6 {name}] C={width} dx_rows={dxr} R={Rg} St={Stg} nnz={nnz_gt} (rows < "
                    f"dx_rows: {nnz_dx}): {tt} bound {bb:.4f} ms ({bb_by}){vs}; device us per "
                    f"call {kernel_split(torch, run)}; library_ms null: no single PyTorch call "
                    f"computes it | {gpu}")
        kern[name] = dict(  # every row, the call PERF.md row 3 has always timed
            source="vq_gnn_tpu_torch/csrc/gat_backward.cu",
            replaces="vq_gnn_tpu/ops/pallas_ell.py:342 and vq_gnn_tpu/ops/pallas_ell.py:273",
            **bwd_t[name, C, Rg])

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
    # each mode beside the other (the bf16 fold, VQ_GNN_REV_FOLD=fast, after
    # the f32 one), the same bound: the fold changes no byte read or written
    bwd_bytes = nb_bm * 4 + nb_bm * Bb * (Dg + 1) * 4 + nb_bm * M_bm * 4
    for name, fn, plain, out_bytes, ops_n in (
        ("rev_forward", lambda: rev_forward(**rev_k),
         lambda: rev_recovery_info_plain(**rev_in), nb_bm * 4, fwd_ops),
        ("rev_backward", lambda: rev_backward(**rev_k, g=g_rev),
         lambda: rev_plain(rev_in["xb"], rev_in["al"], rev_in["arcb"], rev_in["gbar"], g_rev),
         bwd_bytes, 2 * fwd_ops),
        ("rev_forward_fold_bf16", lambda: rev_forward(**rev_k, fold="fast"),
         lambda: rev_recovery_info_plain(**rev_in, fold="fast"), nb_bm * 4, fwd_ops),
        ("rev_backward_fold_bf16", lambda: rev_backward(**rev_k, g=g_rev, fold="fast"),
         lambda: rev_plain(rev_in["xb"], rev_in["al"], rev_in["arcb"], rev_in["gbar"], g_rev,
                           "fast"),
         bwd_bytes, 2 * fwd_ops),
    ):
        tt = {"ms": cuda_time_ms(torch, fn), "plain_ms": cuda_time_ms(torch, plain, reps=3),
              "library_ms": None}
        bb_ms, bb_by = bound(in_bytes + out_bytes, ops_n, F32_FLOPS)
        kern[name] = dict(source="vq_gnn_tpu_torch/csrc/rev_recovery.cu",
                          replaces=("vq_gnn_tpu/ops/pallas_rev.py:280"
                                    if name.startswith("rev_forward")
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
    assign_times(torch, 6, "B + M", xn_bm, emb_bm, valid_bm, gpu)
    lookup_times(torch, 6, "B + M", vq_bm, bmb.fo_ids, Dq, gpu)

    # ---- 7. small graph: GPU kernels vs CPU plain versions from one state ----
    phase("7 small graph")
    cases = (("GCN", "bbprime", "float32"), ("SAGE", "bbprime", "float32"),
             ("GAT", "bbprime", "float32"), ("GCN", "bm", "float32"),
             ("SAGE", "bm", "float32"), ("GAT", "bm", "float32"),
             ("GAT", "bbprime", "bfloat16"))
    # B + M: one epoch of nine steps, past the first flipped assignment
    epochs_of = {"bm": (1,), "bbprime": (1, 2)}
    card_runs = {}  # the f32 cases' card runs: their CPU halves run beside phase 10
    # the bf16 case's CPU half (whose codebooks both of its runs start from)
    # in a process of its own beside the f32 cases' card runs
    cpu_bf16 = Background(cpu_small_runs, [("GAT", "bbprime", epochs_of["bbprime"])], 4,
                          "bfloat16")
    for conv, form, dtype in cases:
        t0 = time.time()
        epochs = epochs_of[form]
        if dtype == "float32":  # the two init sweeps agree exactly
            card_runs[conv, form] = small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm,
                                                    conv, form, "cuda", epochs=epochs)
            continue
        # at bf16 a sum in another order can move a bf16 rounding (a
        # logit dot, dx) by one unit, and the init sweep's near-tied
        # codewords then flip: both runs start from the CPU's codebooks
        rc = cpu_bf16.result()[conv, form]
        rg = small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv, form, "cuda",
                             dtype, vq_states=rc["init_vq"])
        # the GPU's own init sweep beside the CPU's, layer by layer:
        # layer 0 assigns the input features, which no bf16 sum has
        # touched, so it agrees exactly; the later layers assign outputs
        # of the bf16 convs, and a near tie flips there, in under 1e-3
        # of the assignments
        own = small_graph_run(Config, NodeTrainer, prepare, synthetic_sbm, conv, form,
                              "cuda", dtype, epochs=())
        by_layer = [int((a != b).sum()) for a, b in zip(own["codes"][0], rc["codes"][0])]
        n_codes = sum(a.numel() for a in rc["codes"][0])
        log(f"[7 small graph {conv} {form} {dtype}] the GPU's own init sweep against the "
            f"CPU's: assignments that differ by layer {by_layer} of "
            f"{[a.numel() for a in rc['codes'][0]]} ({sum(by_layer) / n_codes:.2e})")
        assert by_layer[0] == 0 and sum(by_layer) < 1e-3 * n_codes, by_layer
        compare_small(rg, rc, conv, form, dtype, t0)

    # ---- 8. the bench (bench_torch.py) on phase 2's GCN graph ----
    phase("8 bench")
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
    E3 = runs["3 GCN"]["E_batch"]
    assert rec["E_batch"] == E3, f"bench batch E={rec['E_batch']}, phase 3's first batch E={E3}"
    assert any(ln.startswith("peak device memory: allocated") for ln in bench_lines)

    # 8b: the bench's own f16 cell (VQ_GNN_BENCH_DTYPE=float16, live VQ), as
    # bench.py takes it.  Its loss may go nonfinite, as the JAX package's
    # does (live updates take the codebooks' feature half past f16's range):
    # the step at which it first does is logged; what must hold is that its
    # timed steps ran kernel 1's f16-row mode and no other mode of rows 1-4
    cfg_h = bench_torch.bench_config({"VQ_GNN_BENCH_DTYPE": "float16"})
    assert cfg_h == dataclasses.replace(cfg_b, compute_dtype="float16")
    t0 = time.time()
    rec = bench_torch.run_bench(cfg_h, *graphs["GCN"], device="cuda", gpu=gpu,
                                log=lambda *a: log("[8b bench f16]", *a))
    bad = next((i for i, v in enumerate(rec["losses"]) if not math.isfinite(v)), None)
    per = rec["launches_per_step"]
    log(f"[8b bench f16] live VQ: losses by step (the warm-up first) {rec['losses']}: "
        + ("every one finite" if bad is None else
           f"the first nonfinite at step {bad + 1} of {len(rec['losses'])}")
        + f"; launches per timed step {per}; in {time.time() - t0:.1f}s | {gpu}")
    assert rec["E_batch"] == E3 and per.get("ell_aggregate_f16", 0) > 0, per
    for name in F16_PATH_NOT:
        assert per.get(name, 0) == 0, f"{name} ran in the bench's f16 cell"

    # ---- 9. the CLI (main_node_torch.py), in-process on the card ----
    phase("9 cli")
    t0 = time.time()
    cli = main_node_torch.main(CLI_ARGS + ["--device", "0"])
    final_test = cli.logger.results[0][-1][2]
    stats = cli.logger.statistics()
    log(f"[9 cli] {' '.join(CLI_ARGS)}: test acc by epoch "
        f"{[round(r[2], 4) for r in cli.logger.results[0]]}; statistics {stats} in "
        f"{time.time() - t0:.1f}s")
    assert stats and final_test >= 0.9, (final_test, stats)

    # ---- 10. accuracy through the parity harness ----
    phase("10 accuracy")
    # beside it, phase 7's f32 CPU halves in two processes of their own
    # (three torch threads each; the card untouched): the same runs, off
    # the script's clock where phase 10 hides them
    f32 = [(conv, form, epochs_of[form]) for conv, form in card_runs]
    cpu_bg = [Background(cpu_small_runs, f32[i::2], 3, "float32") for i in range(2)]
    accuracy_phase(torch, ops, gpu, launches, err)
    phase("7 small graph, the CPU halves")
    t0 = time.time()
    cpu_runs = {}
    for bg in cpu_bg:
        cpu_runs.update(bg.result())
    log(f"[7 small graph] the CPU halves, run beside phase 10, done {time.time() - t0:.1f}s "
        f"after it")
    for (conv, form), rg in card_runs.items():
        compare_small(rg, cpu_runs[conv, form], conv, form, "float32", t0)
    del card_runs, cpu_runs

    # ---- 11-12. link prediction at the collab widths, inductive at ppi ----
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    counts = []
    # phase 17's trainers from phases 11-14, and phase 11's and 12's batches
    keep = {"batches": {}}
    for name, run in (("11 link", lambda: link_phase(torch, ops, gpu, err, keep)),
                      ("12 inductive", lambda: inductive_phase(torch, ops, gpu, err, kern,
                                                               keep))):
        phase(name)
        t0 = time.time()
        counts.append(run())
        log(f"[{name}] the phase took {time.time() - t0:.1f}s")

    # ---- 13. the model options: transformer, dropbranch, alpha dropout ----
    phase("13 options")
    t0 = time.time()
    counts.append(options_phase(torch, ops, NodeTrainer, Config, graphs, gpu, err, kern, runs,
                                prepare, synthetic_sbm, keep))
    log(f"[13 options] the phase took {time.time() - t0:.1f}s")

    # ---- 14. the adjacency layouts: mixed-K slot-ELL and COO ----
    phase("14 layouts")
    t0 = time.time()
    counts.append(layouts_phase(torch, ops, NodeTrainer, Config, graphs, gpu, err, kern, runs,
                                prepare, synthetic_sbm, keep))
    log(f"[14 layouts] the phase took {time.time() - t0:.1f}s")

    # ---- 15. data-parallel training: the DDP step on an NCCL group of one ----
    phase("15 ddp")
    t0 = time.time()
    counts.append(ddp_phase(torch, ops, runs, graphs, gpu, err))
    log(f"[15 ddp] the phase took {time.time() - t0:.1f}s")

    # ---- 16. the upkeep modules: checkpoints, 'scan', kmeans_init ----
    phase("16 upkeep")
    t0 = time.time()
    counts.append(upkeep_phase(torch, ops, NodeTrainer, Config, graphs, gpu, runs))
    log(f"[16 upkeep] the phase took {time.time() - t0:.1f}s")

    # ---- 17. one batch sharded over two ranks: the 1-D and 2-D meshes ----
    phase("17 sharded")
    t0 = time.time()
    counts.append(sharded_phase(torch, ops, {
        "GCN": runs["3 GCN"]["tr"], "GCN-f16": runs["3 GCN-f16"]["tr"],
        "GAT": runs["3 GAT"]["tr"], "GAT-bm": runs["3 GAT-bm"]["tr"],
        "GAT-bm-bf16": runs["3 GAT-bm-bf16"]["tr"], **keep}, graphs, gpu, err))
    del keep
    log(f"[17 sharded] the phase took {time.time() - t0:.1f}s")
    for c in counts:
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v

    out = []
    for name in launches:  # the kernels, then the bf16-row modes
        k = kern[name]
        out.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launches[name], "max_abs_err": err[name], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    phase("end")
    log("seconds by phase: " + json.dumps(
        {a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}))
    log(f"total {time.time() - t_all:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
