#!/usr/bin/env python3
"""Drive the PyTorch port (lirec_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds every CUDA kernel from csrc/ with nvcc, one process per source,
   all started together.
3. Holds each kernel against its plain PyTorch version on the card, at the
   serve path's shapes (M = 64 x 20 pooled rows, R = 18, clip 12,288 x 1024
   and track 24,576 x 256 embedded rows) and at 4x the rows, in float32 and
   bfloat16 tables, with and without the zero-divider guard; prints the
   differences and the median kernel and plain times.
4. Serves the int_rel_ch preset at its published widths (text 768, visual
   and track 2048, joint 512, 101 interaction classes, 15 relationship
   heads) with seeded random weights on 12,288 / 24,576-row tables, in
   bfloat16 and in float32 compute, through the HTTP server; posts
   /predict at B = 1, 7 and 64, checks every answer, checks that each
   forward launched the pool kernel exactly once, and holds the logits
   against the same forward with the plain pool.
5. Builds a server through the CLI's own ``build_engine_from_args`` on a
   synthetic MovieGraphs fixture and answers one /predict.
6. Holds the scatter-accumulate kernel (the train step's gather_h1
   backward) against its plain version on the card and against the
   in-order sum on the CPU, at the train step's shapes (idx [1280, 18, 3],
   updates 1024 / 512 wide) into the Localizer's batch-local tables (the
   train path's own case) and into split-scale tables (12,288 / 24,576
   rows), with structured indices and with every update sent to 8 rows,
   f32 and bf16 updates, three tables, flattened and single-table, the
   train step's scatter at B = 1,024 into split-scale tables (368,640
   updates of three tables: the sort by digits), then at
   the int_rels score table's shapes (INT_RELS_SHAPES: one table, few
   narrow updates, the one-launch path where ``scatter_path`` picks it);
   checks that two launches are bit-identical and that the op launched
   only the port's kernels; holds the counting sort's perm and offsets
   bitwise against ``sort_by_row``; prints median times (L2 flushed) of
   the whole op, the sort (beside ``sort_by_row`` and ``torch.sort``), the
   kernel alone and ``index_add_``, each launch's device time inside the
   op (``torch.profiler``), and at the int_rels shapes the op forced down
   each path; then the counting sort alone past one pass (SORT_CASES:
   2**17 to 2**22 rows in three passes of 8 bits, and split-scale tables
   at B = 256 and 1,024 in two), bitwise ``sort_by_row`` and timed beside
   it and ``torch.sort``.
7. Trains int_rel_ch at its published widths on split-scale tables, B = 64
   structured batches through the port's Localizer, in bf16 and f32
   compute: holds one step's gradients against the same step with the
   plain scatter, then runs 10 steps, checks every loss finite, every
   parameter moved and one sort and one scatter launch per step (and
   nothing else), and prints the median ms/step and clips/s.
8. Runs the port's train() on a synthetic MovieGraphs fixture on the card:
   2 epochs at batch 8 (the last batch of 6 is padded with loss_weight 0).
9. Evaluates int_rel_ch at its published widths over a split of 168
   structured B = 64 batches and a 37-sample tail (10,789 samples) on
   split-scale tables with the packed eval sweep, in bf16 and f32 compute,
   in each ctx localisation tier (off, per-table, triple): checks that the
   three tiers' carries are bitwise equal, that a triple sweep launches the
   triple kernel once per full batch and the 3-table kernel once for the
   tail, every loss finite, and a sweep with the plain pools close; prints
   eval clips/s per tier and dtype (the slope over two batch counts), the
   embed time and the host localisation time.
10. Runs the int_rel_ch eval CLI (``cli.int_rel_ch.main``) on a synthetic
   fixture on the card: both splits' metrics finite.
11. Runs the two probes' entry points on the card (counted run):
   ``tools.probe_hbm_dma.main`` (the per-row pool, kernel 1, on random rows
   and on the explicit run indices, beside the run pool, kernel 9, and the
   plain pool, at the serve path's shapes) and ``tools.probe_bf16_pack.
   main`` (the packed-bf16 gather-sum, kernel 10, beside the masked
   gather-sum, kernel 5, on the native bf16 table, at the TPU probe's own
   shapes and the clip table's). Then (``probe_checks``) holds kernel 9
   against its plain version and bit for bit against kernel 1 on the
   explicit run indices, kernel 10 against its plain version and bit for
   bit against an r-ordered loop, and kernel 5 bit for bit against an
   r-ordered loop and against its plain version on the same inputs as
   kernel 10, and times each (L2 flushed) beside its plain version, its
   bound and its library yardstick: three ``embedding_bag`` sums and tanh
   on run indices built inside the timed call (kernel 9; kernel 1 on the
   same run indices is timed too), ``embedding_bag`` on the unpacked f32
   table (kernel 10) and on the native bf16 table (kernel 5).
12. Trains int_rel_ch from the training CLI (``cli.train.main``) at its
   published widths on a synthetic fixture of published feature widths
   (text 768 x 12 layers, visual 2048): 3 epochs with cadence evaluation at
   epochs 0 and 2 and a train state every epoch (counted run: the scatter
   and pool kernels launched); checks the losses, the best-n files,
   index.json, latest.pth.tar and 2.pth.tar; resumes from latest.pth.tar
   for a 4th epoch; trains one epoch with the --host-eval cadence, checks
   that its cadence took the host loop (``evaluation/runner.evaluate``) and
   not the packed sweep, and holds its recorded val metrics against the packed sweep's on the same weights
   (the eval CLI on that run's final checkpoint); and evaluates the first
   run's best checkpoint with the eval CLI.
13. The Modalities model at its published widths (text 768, visual and
   track 2048, joint 512, 101 classes), bf16 and f32, on the split-scale
   tables: /predict at B = 1 and 64 (scores held to the forward over the
   raw tables), 10 hybrid train steps at B = 64 with dropout 0.5 (losses
   finite, every parameter moved), the eval sweep over the 10,789-sample
   split in the modalities layout with its counters equal to the
   --host-eval loop's, and the modalities CLI (eval of a seeded
   checkpoint, 2 training epochs) on a fixture of published feature
   widths. No kernel is on this path: every launch count must stay 0.
14. The rels-only eval (``evaluation/runner.evaluate_rels_only``) on
   kernels 1-2 (counted runs): on the int_rels fixture of published
   feature widths and on a split-scale stand-in whose pairs fill every
   bucket from 2 to 64 clips (a full flush of 64 pairs and a last one of
   13 each), bf16 and f32, one launch per flush and metrics equal to the
   plain pool's; then (``rels_only_pool_checks``) kernels 1-2 at each
   bucket's shape (M = 64, R = 2 .. 64), full and last flushes with
   all-masked rows, against the plain pool (1e-5 f32, 2e-3 bf16), timed
   beside it, three ``embedding_bag`` sums and the bound.
15. The text-only CLI on that fixture: 2 training epochs, then the eval of
   its own checkpoint; no kernel launches.
16. Data parallelism (parallel/, counted runs), after printing the card's
   compute mode (a mode that forbids two processes on the card fails the
   phase): (a) a process group of one over NCCL in this process sweeps
   phase 9's split over a data mesh of one (its carry bitwise phase 9's,
   169 pool launches per dtype) and takes phase 7's 10 steps through the
   mesh step (parallel/step.py: losses and parameters bitwise phase 7's,
   one scatter launch per step), printing its ms/step beside phase 7's,
   then the same 10 steps through the epoch sweep over that NCCL mesh
   (``EpochSweep(mesh=..., require_graph=True)``, counted: the step
   captured as a CUDA graph, its all-reduce inside, "graph" recorded for
   "cuda: nccl mesh"; losses bitwise the eager mesh steps', parameters
   bitwise phase 7's, one scatter per replay), and epochs of graph
   replays and of the eager mesh step in turns (``SWEEP_TURNS``), ms/step
   each;
   (b) two ranks share the card over gloo (``parallel/dist.spawn`` of
   ``tools/dist_check.rank_run``, under a time limit; NCCL refuses two
   ranks on one device): each sweeps its block of the split in bf16 and
   f32, the all-reduced counters equal phase 9's exactly and the loss sums
   agree within rtol 2e-6, then 3 deterministic f32 steps on its half of
   each batch agree with one process within rtol 1e-5: each step's loss
   and gradient (against its scale) with one process's at the parameters
   the step started from, and the losses with one process's own 3 steps
   (the parameters' difference after Adam is printed), Adam capturable on
   both sides. The gradients are held without the rows of the batch
   where a relu, argmax or amax of the forward sits on a tie and the
   ranks' halves and the whole batch took different branches; those
   decisions are printed with their distance from the tie, which must be
   within 1e-5 of their input's scale, and none may belong to no row;
   each rank's launches of kernels 1-2 and 6 come back with its result
   and must be non-zero. A failed group, rank or time limit fails the
   run; nothing falls back to one process or to the CPU.
17. The rest of training: (a) the dense forwards (reference-layout rows
   gathered on the card) of int_rel_ch, int_ch and modalities at published
   widths against the packed eval forward on phase 9's first batch
   (int_rel_ch's through kernel 1 / 2), f32 within 1e-5 and bf16 within
   2e-3; (b) three dense int_rel_ch train steps at B = 64 from batches
   that ``InteractionDataset.to_dense`` gathers on the host ([64, 20, 19,
   6912] f32), staged by ``data/pipeline.prefetch_to_device``: finite
   losses, the host, copy and step times; (c) the training CLI on the
   published-widths fixture without the assembly plan
   (``LIREC_TPU_NO_PLAN=1``), in process and with ``--assembly-workers
   2``: bitwise the same losses, every epoch from the worker pool (not
   its fallback, by ``dispatch``); (d) phase 7's 10 steps in turns with
   host batches and with batches staged by ``prefetch_to_device``
   (``PREFETCH_TURNS``, three runs of each): each run's losses and
   parameters bitwise phase 7's, each run's median ms/step; (e) the
   workers' run
   also had ``--profile``: its trace names
   the pool kernel and the scatter kernel; (f) the assembly plan's disk
   cache on the fixture: a miss, then a hit on a second dataset, with the
   build and load times.
18. The remaining CLIs on that fixture, at the published widths: (a)
   ``cli.ingest.main`` writes the int_rel_ch and int_rels ingest artifacts
   (seconds, MB); (b) the int_rel_ch eval CLI on a seeded ``.pth.tar``, in
   bf16 and f32, without ``--ingest-cache``, writing the artifact and
   loading it (counted runs, kernels 1-2): the three metric dicts equal
   (counters exactly, floats bitwise); the f32 artifact through the plain
   versions on the CPU, the same counters and the loss within 1e-5;
   kernels 1-2 held against the plain version and timed on the loading
   run's first pool call, beside ``embedding_bag`` and the bound; and the
   datasets' start-up built against loaded; (c) the int_rels eval CLI from its artifact on the card
   (counted run: kernel 8, the single-table scatter of the relationship
   score table, at least once per batch, on its one-launch path) and on
   the CPU (the plain
   versions), the same counters; then the test split's sweep carry on the
   card, its ``rels_table`` bitwise the CPU's in-order sum of the same
   update rows, its integer counters equal to the CPU sweep's; kernel 8
   held and timed on that sweep's first batch beside ``index_add_`` and
   the bound; (d) ``cli.convert_checkpoint.main`` of the int_rel_ch
   ``.pth.tar`` (18.4M parameters) and the eval CLI on the ``.ckpt``, with
   (b)'s metrics; (e) ``extract-text --backend fake`` over the fixture's
   dialogs, ``verify-features check`` of its output and ``graphs-demo``
   on the fixture's graphs (host checks).
19. The one-dispatch sweeps as CUDA graphs (utils/graphs.StepGraph), the
   default on the card everywhere above (phases 8, 9, 10, 12-18 run them):
   (a) phase 7's 10 batches through the epoch sweep (train/sweep.
   EpochSweep), bf16 and f32, counted: one replay per step after the
   first step's warm-up, losses and parameters bitwise phase 7's per-batch
   steps, a chunked run (3 steps a chunk) bitwise too, then epochs of
   the graph sweep and of the per-batch eager steps in turns
   (``SWEEP_TURNS``), ms/step each, and the capture's time; (b) phase 9's
   split as a graph and as eager steps in every tier: carries bitwise
   each other's and phase 9's, launch counts equal (counted: 169 of the
   3-table pool per off-tier sweep), ms/batch as slopes over 84 and 168
   batches in turns, the captures' times; (c) the training CLI on the
   published-widths fixture, one epoch with and without
   ``--per-batch-train``: ``epoch_sweep_used`` True and False, the
   ``train_loop`` path taken, the same loss; (d) phase 18's int_rels eval
   CLI from its artifact at B = 64 (its splits are one partial batch: the
   tail's eager step, kernel 8 twice) and at B = 8 (full batches as
   replays; kernel 8 once per batch), then the test split's sweep at B =
   8 as a graph and eagerly: ``rels_table`` and counters bitwise, launches
   equal, the table bitwise the CPU's in-order sum of the eager sweep's
   recorded update rows, and kernel 8 held and timed on its first call's
   tensors. In (b) a key's first graph sweep captures; the timed sweeps
   replay the graph that their key's warm-up sweep captured.
20. The model and context mesh axes (parallel/mesh.py), ranks sharing the
   one card over gloo: (a) a 1x2 mesh of two ranks, int_rel_ch at
   published widths, bf16 and f32 (``tools/dist_check.rank_run`` with a
   2-D mesh): the cadence sweep of phase 9's split on each rank's full
   replica filled from the shards (``gather_state``), its counters equal
   to phase 9's; phase 7's 10 batches with dropout, each step's loss and
   gathered gradient against one process's forward and backward on the
   replica at the same parameters (the rows of decisions that sit on a
   tie and went the other way taken out of both sides and counted), the
   parameters the plan replicates bitwise across the two ranks, each
   rank's ms/step beside phase 7's; kernel 6 at the shard widths (clip
   512, tracks 256) bitwise the CPU's in-order sum, timed beside
   ``index_add_`` with its bound; (b) the same as a 2x2 mesh of four
   ranks, deterministic steps (``MESH_STEPS_2X2``); (c) the
   context-parallel eval forward over two ranks (R = 18 as 9 + 9, kernel
   5 pooling each rank's block: its first product launches), its logits
   against one process's on phase 9's first batch within the parity
   contract, and kernel 5 held against its plain version and the
   r-ordered loop on each rank's block of each table, timed on rank 0's
   clip block; (d) a world of one over NCCL through parallel/mesh
   (``make_mesh((1, 1))``, ``shard_model`` and ``gather_state`` the
   identity): phase 9's f32 sweep and phase 7's f32 steps bitwise. Gloo
   ranks sharing one card check correctness, not tensor-parallel scaling.
21. The triple pool's matmul tier (``fused_ctx_pool_triple(...,
   force="matmul")``: S @ the local table through ``torch.mm``, no kernel)
   on phase 3's eval batch and local table, f32 and bf16: within 1e-5 of
   scale of kernel 4 with and without the zero guard; the tier, the tier
   with the local-table build, kernel 4 and kernel 4 with the build timed
   (CUDA events, L2 flushed) and printed as ``matmul_tier``.
22. The JAX package's Orbax checkpoints (checkpoint/orbax_backend.py,
   its zstd decoder g++-built from native/zstd.cpp): (a) the training CLI
   at published widths on phase 12's fixture under
   ``--checkpoint-backend orbax --checkpoint-every 1`` writes latest.ckpt
   and 0.ckpt as Orbax directories and the best-n files as msgpack; (b)
   ``--auto-resume`` from that latest.ckpt trains one more epoch, starting
   from the parameters and Adam state written, bitwise; (c) the
   int_rel_ch eval CLI on the final directory, bf16 and f32 (counted:
   kernels 1-2, ``name@orbax``, held and timed on its first pool call),
   equal to its run on a msgpack .ckpt of the same weights; (d) a
   published-width int_rel_ch train state after 3 of phase 7's steps
   (kernel 6) written and read back through the msgpack and Orbax
   backends, bitwise, printing the seconds, the MB on disk, the decoder's
   MB/s on the largest chunk and on a committed level-1 frame, beside the
   card's name and power limit; printed as ``orbax``.
23. The grounding configurations at published widths (counted runs):
   (a) GT int_rel_ch (``tr_correct=True``) on phase 7's 10 localized
   batches, bf16 and f32: the first step's gradients with kernel 6
   against the plain scatter, the epoch sweep's CUDA graph (kernel 6 once
   a step) bitwise the per-batch path, ms/step graph and eager in turns,
   and the GT model's cadence sweep of phase 9's split (kernels 1-2,
   ``name@gt``); (b) int_ch, weak and GT: /predict at B = 1, 7 and 64
   from engines built by the serve CLI's ``build_engine_from_args`` on
   seeded checkpoints (best tracks equal to the plain dense forward's),
   phase 9's split in int_ch's layout through the eval sweep as a graph
   and eagerly in turns (every counter equal), phase 7's batches in
   int_ch's layout through the epoch sweep's graph bitwise the per-batch
   path, bf16 and f32, with no kernel launched anywhere; (c) the int_ch
   eval CLI without and with ``--tr-correct`` on seeded msgpack
   checkpoints, its metrics equal to the in-process sweep's, and the
   training CLI for int_ch and int_rel_ch under ``--tr-correct``: 2
   epochs, one cadence eval, a train state, one resumed epoch; (d)
   kernels 1-2, 4 and 5 at M = 64 and R = 2,048, 2,049 and 4,096 (past
   the 2,048-entry chunk) against their plain versions, kernel 4 bitwise
   kernel 1 and kernel 5 bitwise the r-ordered loop, each timed beside
   ``embedding_bag`` and its bound (``long_context``), and phase 14's
   stand-in with two more pairs of 2,100 and 4,096 clips: the rels-only
   eval runs its 4,096 bucket on kernels 1-2 (``name@ctx4096``), its
   metrics equal to the plain pool's. Printed as ``grounding``.

Phase 3 also holds the triple-tier pool (kernel 4) against its plain
version and bit for bit against the 3-table kernel on a structured
batch's local table, and the masked gather-sum (kernel 5, no product
caller) bit for bit against an r-ordered loop of separate multiplies and
adds and against its plain version, and times each beside the
``embedding_bag`` library call that computes the same function, with the
triple tier's local-table build and one batch's ctx pool in each tier;
and it
times the 3-table kernel on that batch's own indices, as the eval sweep
launches it, beside its plain version and three ``embedding_bag`` sums
(``bag_pool``, the library yardstick of the serve path's random rows and
the giant tables too).

Every failure raises. There is no CPU path: without a CUDA device the
script exits 2. Its last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel with its launch count, error, times
and bound (the larger of the bytes this run's inputs need over 3.35 TB/s
and the operations over 67 TFLOP/s of f32 arithmetic), at the shapes of
the path that launches it: the 3-table pool on the eval sweep's batch
(launches: one off-tier sweep, what ``auto`` runs), the scatter and its
counting sort (``scatter_sort``) at the Localizer's tables (launches:
phase 7's steps); the serve path's random
rows, the giant tables and the split-scale scatter are entries of their
own (``name@case``); ``name@dist`` entries give phase 16's launches (the
world of one's and each rank's), ``name@model_axis`` phase 20's (the
ranks' sweeps and steps; the scatter at the shard widths), and
``gather_masked_sum_f32@context`` kernel 5's from phase 20(c), ``name@ingest`` kernels 1-2 at phase
18(b)'s first pool call (its ``shapes``), and ``scatter_small_f32@int_rels``
kernel 8 at phase 18(c)'s sweep (its one-launch path; the sorted kernel
on the same inputs is ``scatter_accum_f32@int_rels``, no launches);
``name@graph`` entries give phase 19's launches from graph replays
(kernels 1-2 and 6 and the sort, with their main entries' numbers), and
``scatter_small_f32@int_rels_graph`` kernel 8's at phase 19(d)'s B = 8
(held and timed on that sweep's first scatter call);
``@mesh_graph`` entries give the scatter's launches from phase 16(a)'s
graph replays of the mesh step, ``@orbax`` kernels 1-2's from phase
22(c)'s eval CLI on an Orbax directory, ``@gt`` kernels 1-2's and 6's
from phase 23(a)'s GT int_rel_ch runs, and ``@ctx4096`` the pools at
M = 64, R = 4,096 (kernels 1-2: the launches of the 4,096 bucket of
phase 23(d)'s rels-only eval; kernels 4-5: none).

Every synthetic fixture is written in a child process under a fixed
string-hash seed (``write_fixture``), so that two runs train on the same
files.
"""

import dataclasses
import functools
import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import ThreadingHTTPServer

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

B_SIZES = (1, 7, 64)
N_CLIPS, N_TRACKS = 12288, 24576  # split-scale tables (ROADMAP.md)
GIANT = 4  # giant tables: 4x the rows, past the TPU's VMEM-resident tier
TOPK = 5
CU = "lirec_tpu_torch/csrc/fused_ctx_pool.cu"
TRIPLE_CU = "lirec_tpu_torch/csrc/fused_ctx_pool_triple.cu"
TPU_SRC = "lirec_tpu/ops/gather_pool.py"
SCATTER_CU = "lirec_tpu_torch/csrc/scatter_accum.cu"
SCATTER_TPU_SRC = "lirec_tpu/ops/scatter_accum.py"
DMA_CU = "lirec_tpu_torch/csrc/probe_hbm_dma.cu"
PACK_CU = "lirec_tpu_torch/csrc/probe_bf16_pack.cu"
TRAIN_B, TRAIN_STEPS = 64, 10
EVAL_B, EVAL_FULL, EVAL_TAIL = 64, 168, 37  # a split of 10,789 samples
EVAL_ROUNDS = 5
RELS_BUCKETS = (2, 4, 8, 16, 32, 64)  # the rels-only eval's clip buckets
RELS_TAIL = 13  # rows of each bucket's last flush
PUBLISHED_FIXTURE = dict(text_dim=768, visual_dim=2048, text_layers=12)
PUBLISHED_DIMS = dict(PUBLISHED_FIXTURE, joint_dim=512)  # the CLIs' widths
DEV = "cuda"  # the device of phases 13-15 and 18
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HOLD_CYCLES = 1 << 21  # about 1 ms of spinning at the H100's clock
DIST_TIMEOUT = 300  # seconds for phase 16(b)'s two ranks, start to join
DIST_STEPS = 3  # phase 16(b)'s deterministic data-parallel steps
MESH_STEPS_2X2 = 3  # phase 20(b)'s deterministic steps on the 2x2 mesh
# phase 20: the parity contract of a loss against one process's, and of a
# gradient (relative to the tensor's largest element); under bf16 compute
# every weight's gradient is rounded to bf16 (the cast of the weight in
# models/layers.linear), so a sum taken in another order can move an
# element by one bf16 step: up to 2^-7 of the tensor's largest element
MESH_TOL = {"float32": 1e-5, "bfloat16": 4.1e-3}
MESH_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# how near its tie a differing decision may sit (of its input's scale):
# in bf16 the GEMMs' inputs are rounded to bf16, so a sum taken in
# another order can move an input by one bf16 rounding (2^-8 of itself)
TIE_RTOL = 1e-5  # phase 16(b): a decision this near its tie may differ
MESH_TIE = {"float32": TIE_RTOL, "bfloat16": 2.0 ** -8}
FIXTURE_HASH_SEED = "7"  # the string-hash seed of every synthetic fixture
# phase 17(d)'s runs of phase 7's steps, host batches against prefetched
# ones in alternating pairs
PREFETCH_TURNS = ("plain", "prefetch", "prefetch", "plain", "plain",
                  "prefetch")
# phase 19(a): epochs of the graph sweep and of the per-batch eager steps in
# turns, and the steps of a chunk in the chunked run (10 steps: 3, 3, 3, 1)
SWEEP_TURNS = ("eager", "graph", "graph", "eager")
SWEEP_CHUNK = 3
INT_RELS_GRAPH_B = 8  # phase 19(d)'s batch: full batches, graph replays
# phase 6's cases at the int_rels sweep's score table (evaluation/packed.py:
# the table's rows, then a batch's hashed score rows): (hashes + 1 rows,
# batch, width). The fixture's 43 and phase 19(d)'s 17 updates into 9 rows
# of 6, then a synthetic B = 64 into 1,024 to 8,192 hashes at the
# published 15 relationship heads (sizes chosen about the one-launch
# path's threshold, not a real split's pair count)
INT_RELS_SHAPES = ((9, 34, 6), (9, 8, 6), (1025, 64, 15), (2049, 64, 15),
                   (2561, 64, 15), (3073, 64, 15), (4097, 64, 15),
                   (5121, 64, 15), (6145, 64, 15), (8193, 64, 15))
# phase 6's counting sort alone past one pass: (updates a table, rows),
# a quarter of the updates on row 0; 23,040 updates into 2**17 and 2**20
# rows and 2**21 into 2**20 and 2**22 rows (three passes of 8 bits), then
# the train step's scatter at split-scale tables for B = 256 and 1,024
# (92,160 and 368,640 updates of three tables, two passes)
SPLIT_TABLES = (N_CLIPS, N_TRACKS, N_TRACKS)
SORT_CASES = ((23040, (1 << 17,)), (23040, (1 << 20,)),
              (1 << 21, (1 << 20,)), (1 << 21, (1 << 22,)),
              (92160, SPLIT_TABLES), (368640, SPLIT_TABLES))
# phase 6's whole op at split-scale tables for the train step at B = 1,024
# (the sort by digits, then kernel 6), f32 and bf16, against index_add_
BIG_SCATTER_M = 368640
# every kernel a scatter op may launch: the port's own (no library sort,
# searchsorted or index_add_); sort_offsets_kernel is an earlier
# checkout's (tools/kernel_phases.py runs this phase on a parent)
SCATTER_OP_KERNELS = ("sort_count_kernel", "sort_prefix_kernel",
                      "sort_place_kernel", "sort_zero_kernel",
                      "sort_digits_kernel", "sort_tile_kernel",
                      "sort_bounds_kernel", "sort_offsets_kernel",
                      "scatter_hot_kernel", "scatter_short_kernel",
                      "scatter_small_kernel")


def log(*args):
    print(*args, flush=True)


class Failure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def kernel_launches():
    """ops/dispatch's launch counts of the hand-written kernels: the bf16
    GEMMs' (models/layers.GEMM_NAME, cuBLAS under bf16 compute) are left
    out, so that a phase's counts name its kernels alone."""
    from lirec_tpu_torch.models.layers import GEMM_NAME
    from lirec_tpu_torch.ops import dispatch

    counts = dispatch.launches()
    counts.pop(GEMM_NAME, None)
    return counts


# ------------------------------------------------------------------ card


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def write_fixture(root, **spec):
    """``synthetic.generate(root, SyntheticSpec(**spec))`` in a child
    process under PYTHONHASHSEED=7: the generator orders some rows by set
    iteration, so its files change with the string-hash seed, and with
    them the losses of the phases that train on the fixture."""
    code = ("import json, sys; from lirec_tpu_torch.data import synthetic; "
            "synthetic.generate(sys.argv[1], "
            "synthetic.SyntheticSpec(**json.loads(sys.argv[2])))")
    subprocess.run([sys.executable, "-c", code, root, json.dumps(spec)],
                   cwd=ROOT, check=True, timeout=600,
                   env=dict(os.environ, PYTHONHASHSEED=FIXTURE_HASH_SEED))


# --------------------------------------------------------------- kernels


def median_ms(torch, fn, reps=15):
    """Median of CUDA-event times of single launches, the L2 cache flushed
    (a 64 MiB write) before each one, so rows are read from HBM as a new
    request would. A spin kernel of about a millisecond follows the flush:
    the host enqueues the timed call while the card spins, so the time is
    the card's alone. Without it the card would reach the start event
    before a slow host had enqueued the call, and the wrapper's host time
    would count."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextmanager
def host_clock(torch):
    """Times its block on the host clock between two
    torch.cuda.synchronize() calls, so that the block's work on the card
    is inside and no work queued before it is; yields a namespace whose
    ``s`` holds the block's seconds once the block has ended. With torch
    None it times host work alone, unbracketed: there a synchronize's
    own microseconds would be a share of the time."""
    clock = types.SimpleNamespace(s=None)
    if torch is not None:
        torch.cuda.synchronize()
    t = time.perf_counter()
    yield clock
    if torch is not None:
        torch.cuda.synchronize()
    clock.s = time.perf_counter() - t


def host_ms(torch, fn, reps=1):
    """fn(0), fn(1), ..., fn(reps - 1), each timed by host_clock: the list
    of their ms."""
    times = []
    for i in range(reps):
        with host_clock(torch) as clock:
            fn(i)
        times.append(clock.s * 1e3)
    return times


def in_turns(order, runs):
    """A against B in turns: runs[name](turn) for each (turn, name) of
    enumerate(order), so that each side meets the card's state (clocks,
    caches, allocator) as the other does. Each run returns the list of ms
    it timed (host_ms's); returns {name: [ms, ...]} in the order taken."""
    times = {name: [] for name in runs}
    for turn, name in enumerate(order):
        times[name] += runs[name](turn)
    return times


def bound(n_bytes, flops):
    """The least time the card could take: bytes over the memory rate or
    f32 operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def gathered_bytes(table, ids):
    """Bytes of the table rows `ids` reference, each read once."""
    return int(ids.unique().numel()) * table.shape[1] * table.element_size()


def pool_inputs(torch, n_clips, n_tracks, dtype, seed, M=64 * 20, R=18,
                d_clip=1024, d_tr=256):
    from lirec_tpu_torch.models.tabular import EmbeddedTables

    g = torch.Generator(device="cuda").manual_seed(seed)

    def table(n, d):
        return torch.randn(n, d, device="cuda", generator=g).to(dtype)

    emb = EmbeddedTables(table(n_clips, d_clip), table(n_tracks, d_tr),
                         table(n_tracks, d_tr))
    idx = torch.stack(
        [torch.randint(0, n, (M, R), device="cuda", generator=g)
         for n in (n_clips, n_tracks, n_tracks)], dim=-1,
    ).to(torch.int32).contiguous()
    mask = (torch.rand(M, R, device="cuda", generator=g) < 0.5).float()
    mask[5:, 0] = 1.0
    mask[:5] = 0.0  # only these rows lack context: the zero-divider guard
    return emb, idx, mask


def pool_case(torch, label, emb, idx, mask, guard, atol):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )

    got = fused_ctx_pool(emb, idx, mask, guard)
    torch.cuda.synchronize()
    want = fused_ctx_pool_reference(emb, idx, mask, guard)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32,
          "%s: kernel output %s %s" % (label, tuple(got.shape), got.dtype))
    nan = want.isnan()
    check(torch.equal(got.isnan(), nan), "%s: NaN positions differ" % label)
    # rows without context: 0 under the guard, NaN (0/0) without it
    if guard:
        check(bool((got[:5] == 0).all()), "%s: guarded empty rows" % label)
    else:
        check(bool(nan[:5].all()) and not bool(nan[5:].any()),
              "%s: unguarded empty rows must be NaN, and only they" % label)
    err = float((got - want).abs()[~nan].max())
    log("  %-34s max|diff| %.3e (atol %.0e)" % (label, err, atol))
    check(err <= atol, "%s: kernel disagrees with the plain version" % label)
    return err


def emb_width(emb):
    return emb.clip.shape[1] + 2 * emb.tr1.shape[1]


def index_cols(idx):
    """The three contiguous [M, R] index columns of idx [M, R, 3]."""
    return [idx[..., k].contiguous() for k in range(3)]


def guarded_div(torch, mask):
    """The pool's divider under the zero guard: sum_r mask, 0 -> 1."""
    div = mask.sum(-1, keepdim=True)
    return torch.where(div == 0, torch.ones_like(div), div)


def bag_pool(torch, emb, cols, w, div):
    """The library yardstick of the 3-table pool, timed only (the port
    never calls it): three ``embedding_bag`` sums over the index columns
    `cols` with weights `w` (in the tables' dtype), their concatenation,
    the divide by `div` and tanh."""
    import torch.nn.functional as F

    return torch.tanh(torch.cat([
        F.embedding_bag(c, t, per_sample_weights=w, mode="sum")
        for c, t in zip(cols, emb)], dim=-1).float() / div)


def kernel_checks(torch):
    """Phase 3. Returns {entry: {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}}."""
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )

    # f32 tables: one-ulp differences from 1/div vs divide and sum order;
    # bf16 tables: the same bf16 values on both sides, f32 sums
    atol = {torch.float32: 2e-6, torch.bfloat16: 1e-5}
    results = {}
    for key, rows, dtypes in (
        ("random_f32", 1, (torch.float32,)),
        ("random_bf16", 1, (torch.bfloat16,)),
        ("giant", GIANT, (torch.float32, torch.bfloat16)),
    ):
        errs = []
        timed = None
        for dtype in dtypes:
            emb, idx, mask = pool_inputs(torch, N_CLIPS * rows,
                                         N_TRACKS * rows, dtype, seed=rows)
            name = "%s %dx%d rows %s" % (key, N_CLIPS * rows,
                                         N_TRACKS * rows,
                                         str(dtype).split(".")[1])
            for guard in (True, False):
                errs.append(pool_case(
                    torch, "%s guard=%s" % (name, guard), emb, idx, mask,
                    guard, atol[dtype],
                ))
            if timed is None:
                ms = median_ms(torch, lambda: fused_ctx_pool(
                    emb, idx, mask, True))
                plain = median_ms(torch, lambda: fused_ctx_pool_reference(
                    emb, idx, mask, True))
                cols, w = index_cols(idx), mask.to(dtype)
                div = guarded_div(torch, mask)
                lib_err = float((bag_pool(torch, emb, cols, w, div)
                                 - fused_ctx_pool(emb, idx, mask, True))
                                .abs().max())
                lib = median_ms(torch, lambda: bag_pool(torch, emb, cols, w,
                                                        div))
                M, R = idx.shape[:2]
                moved = (gathered_bytes(emb.clip, idx[..., 0])
                         + gathered_bytes(emb.tr1, idx[..., 1])
                         + gathered_bytes(emb.tr2, idx[..., 2])
                         + nbytes(idx, mask) + M * emb_width(emb) * 4)
                b = bound(moved, 2 * M * R * emb_width(emb))
                log("  %-34s kernel %.4f ms, plain %.4f ms, 3 x "
                    "embedding_bag + tanh %.4f ms (max|diff| %.1e) (median, "
                    "M=%d); bound %.4f ms (%s, %.1f MB)" % (
                        name, ms, plain, lib, lib_err, M, b["bound_ms"],
                        b["bound_by"], moved / 1e6))
                timed = dict(ms=ms, plain_ms=plain, library_ms=lib, **b)
                del cols, w, div
            del emb, idx, mask
        results[key] = dict(max_abs_err=max(errs), **timed)
    torch.cuda.empty_cache()
    return results


def local_table_inputs(torch, dtype, spec, seed):
    """A structured B = 64 batch's ctx entries (M = 1280, R = 18) over
    split-scale embedded tables, and the batch's triple-tier local table
    built as the eval sweep builds it: (emb, idx [M, R, 3], mask [M, R],
    fused [U, 1536], tidx [M, R])."""
    from lirec_tpu_torch.data.localize import localize_eval_ctx_triples
    from lirec_tpu_torch.utils.fake_batch import make_structured_batch

    emb, _, _ = pool_inputs(torch, N_CLIPS, N_TRACKS, dtype, seed=seed)
    batch = make_structured_batch(spec, EVAL_B, N_CLIPS, N_TRACKS,
                                  seed=500 + seed)
    fi = batch["feat_idx"]
    tidx, triples = localize_eval_ctx_triples(fi, EVAL_B, 1, N_TRACKS)
    M, R = EVAL_B * fi.shape[1], fi.shape[2] - 1
    idx = torch.from_numpy(fi[:, :, 1:, :].reshape(M, R, 3).copy()).cuda()
    mask = torch.from_numpy(batch["rels_mask"].reshape(M, R).astype(
        "float32")).cuda()
    tri = torch.from_numpy(triples[0]).cuda().long()
    fused = fuse(torch, emb, tri)
    tidx = torch.from_numpy(tidx.reshape(M, R)).cuda()
    return emb, idx, mask, fused, tri, tidx


def fuse(torch, emb, tri):
    """The local table: each unique triple's [clip | tr1 | tr2] row."""
    return torch.cat([emb.clip[tri[:, 0]], emb.tr1[tri[:, 1]],
                      emb.tr2[tri[:, 2]]], dim=-1)


def eval_pool_entry(torch, tag, emb, idx, mask, w, div, ms, atol,
                    guard=True):
    """The 3-table pool (kernels 1-3) on an eval sweep's own inputs (phase
    9: a structured batch over split-scale tables, as the off-tier sweep
    launches it): error against the plain version, its time (`ms`, timed
    by the caller), plain and library times, and the bound on these
    indices. The library yardstick is ``bag_pool``. Without the zero
    guard, rows with no context are NaN in both versions and the error
    is taken over the others."""
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference,
    )

    got = fused_ctx_pool(emb, idx, mask, guard)
    torch.cuda.synchronize()
    want = fused_ctx_pool_reference(emb, idx, mask, guard)
    nan = want.isnan()
    check(torch.equal(got.isnan(), nan), "3-table pool %s: NaN positions "
          "differ from the plain version's" % tag)
    err = float((got - want).abs()[~nan].max())
    check(err <= atol, "3-table pool %s on the eval batch disagrees with "
          "the plain version: %.3e" % (tag, err))
    cols = index_cols(idx)

    def library():
        return bag_pool(torch, emb, cols, w, div)

    lib_err = float((library() - got).abs()[~nan].max())
    plain = median_ms(torch, lambda: fused_ctx_pool_reference(
        emb, idx, mask, guard))
    lib = median_ms(torch, library)
    M, R = idx.shape[:2]
    moved = (sum(gathered_bytes(t, idx[..., k]) for k, t in enumerate(emb))
             + nbytes(idx, mask) + M * emb_width(emb) * 4)
    b = bound(moved, 2 * M * R * emb_width(emb))
    log("  3-table pool %-4s on the eval batch: max|diff| vs plain %.3e "
        "(atol %.0e); kernel %.4f ms, plain %.4f ms, 3 x embedding_bag + "
        "tanh %.4f ms (max|diff| %.1e); bound %.4f ms (%s, %.2f MB)" % (
            tag, err, atol, ms, plain, lib, lib_err, b["bound_ms"],
            b["bound_by"], moved / 1e6))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **b)


def triple_checks(torch, spec):
    """Phase 3, kernels 4 and 5. Returns {entry: {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by}}."""
    import torch.nn.functional as F

    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_triple,
        fused_ctx_pool_triple_reference, gather_masked_sum,
        gather_masked_sum_reference,
    )

    atol = {torch.float32: 2e-6, torch.bfloat16: 1e-5}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        emb, idx, mask, fused, tri, tidx = local_table_inputs(
            torch, dtype, spec, seed=7)
        M, R = tidx.shape
        U, width = fused.shape
        errs = []
        for guard in (True, False):
            got = fused_ctx_pool_triple(fused, tidx, mask, guard)
            three = fused_ctx_pool(emb, idx, mask, guard)
            torch.cuda.synchronize()
            want = fused_ctx_pool_triple_reference(fused, tidx, mask, guard)
            check(got.shape == (M, width) and got.dtype == torch.float32,
                  "triple %s: output %s %s" % (tag, tuple(got.shape),
                                               got.dtype))
            check(torch.equal(got.isnan(), three.isnan())
                  and torch.equal(torch.nan_to_num(got),
                                  torch.nan_to_num(three)),
                  "triple %s guard=%s: not bitwise the 3-table kernel"
                  % (tag, guard))
            check(torch.equal(got.isnan(), want.isnan()),
                  "triple %s: NaN positions differ from plain" % tag)
            nan = got.isnan()
            err = float((got - want).abs()[~nan].max())
            errs.append(err)
            log("  triple %-4s guard=%-5s U=%d: bitwise the 3-table kernel; "
                "max|diff| vs plain %.3e (atol %.0e)"
                % (tag, guard, U, err, atol[dtype]))
            check(err <= atol[dtype], "triple %s disagrees with plain" % tag)
        div = guarded_div(torch, mask)
        w = mask.to(dtype)
        lib_out = torch.tanh(F.embedding_bag(
            tidx, fused, per_sample_weights=w, mode="sum").float() / div)
        lib_err = float((lib_out - fused_ctx_pool_triple(
            fused, tidx, mask, True)).abs().max())
        ms = median_ms(torch, lambda: fused_ctx_pool_triple(
            fused, tidx, mask, True))
        plain = median_ms(torch, lambda: fused_ctx_pool_triple_reference(
            fused, tidx, mask, True))
        lib = median_ms(torch, lambda: torch.tanh(F.embedding_bag(
            tidx, fused, per_sample_weights=w, mode="sum").float() / div))
        build = median_ms(torch, lambda: fuse(torch, emb, tri))
        # one batch's ctx pool in each tier, as the sweep runs it: the
        # triple tier builds its local table, then pools it
        tier_triple = median_ms(torch, lambda: fused_ctx_pool_triple(
            fuse(torch, emb, tri), tidx, mask, True))
        tier_off = median_ms(torch, lambda: fused_ctx_pool(
            emb, idx, mask, True))
        moved = nbytes(fused, tidx, mask) + M * width * 4
        b = bound(moved, 2 * M * R * width)
        log("  triple %-4s kernel %.4f ms, plain %.4f ms, embedding_bag + "
            "tanh %.4f ms (max|diff| %.1e); local-table build (U = %d rows) "
            "%.4f ms; bound %.4f ms (%s, %.2f MB)" % (
                tag, ms, plain, lib, lib_err, U, build, b["bound_ms"],
                b["bound_by"], moved / 1e6))
        log("  one batch's ctx pool, %s: triple tier (build + kernel) %.4f "
            "ms, unlocalised (3-table kernel) %.4f ms" % (
                tag, tier_triple, tier_off))
        results["triple_" + tag] = dict(
            max_abs_err=max(errs), ms=ms, plain_ms=plain, library_ms=lib,
            build_ms=build, tier_triple_ms=tier_triple, tier_off_ms=tier_off,
            **b)
        results["pool_eval_" + tag] = eval_pool_entry(
            torch, tag, emb, idx, mask, w, div, tier_off, atol[dtype])

        # kernel 5: the clip table's masked sum, no epilogue
        table, one = emb.clip, idx[..., 0].contiguous()
        got = gather_masked_sum(table, one, mask)
        torch.cuda.synchronize()
        check(got.dtype == dtype, "gather_masked_sum %s dtype" % tag)
        check(torch.equal(got, masked_sum_loop(torch, table, one, mask)),
              "gather_masked_sum %s: not bitwise the r-ordered loop" % tag)
        want = gather_masked_sum_reference(table, one, mask)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        # f32: sums in another order; bf16: one bf16 rounding of the sum
        tol = 1e-5 * scale if dtype == torch.float32 else 2 ** -8 * scale
        log("  gather_masked_sum %-4s bitwise the r-ordered loop; max|diff| "
            "vs plain %.3e (bound %.1e)" % (tag, err, tol))
        check(err <= tol, "gather_masked_sum %s disagrees" % tag)
        ms = median_ms(torch, lambda: gather_masked_sum(table, one, mask))
        plain = median_ms(torch, lambda: gather_masked_sum_reference(
            table, one, mask))
        lib = median_ms(torch, lambda: F.embedding_bag(
            one, table, per_sample_weights=w, mode="sum"))
        moved = (gathered_bytes(table, one) + nbytes(one, mask)
                 + M * table.shape[1] * table.element_size())
        b = bound(moved, 2 * M * R * table.shape[1])
        log("  gather_masked_sum %-4s kernel %.4f ms, plain %.4f ms, "
            "embedding_bag %.4f ms; bound %.4f ms (%s)"
            % (tag, ms, plain, lib, b["bound_ms"], b["bound_by"]))
        results["gms_" + tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                     library_ms=lib, **b)
        del emb, idx, mask, fused, tidx, table
    torch.cuda.empty_cache()
    return results


def matmul_tier_phase(torch, spec):
    """Phase 21: the triple pool's matmul tier (fused_ctx_pool_triple's
    force="matmul": the count matrix S [M, U] built in f32, S @ the local
    table, the divide and tanh; torch.mm, no kernel) on phase 3's eval
    batch and local table (B = 64, M = 1280, R = 18, U at the Localizer's
    cap, rows 1536 wide), held against kernel 4 within 1e-5 of scale with
    and without the zero guard; times (CUDA events, L2 flushed): the tier
    (S built inside), the tier with the local-table build, kernel 4, and
    kernel 4 with the build. Returns {dtype tag: numbers}."""
    from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool_triple

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        emb, _, mask, fused, tri, tidx = local_table_inputs(
            torch, dtype, spec, seed=7)
        M, R = tidx.shape
        U, width = fused.shape
        err = 0.0
        for guard in (True, False):
            want = fused_ctx_pool_triple(fused, tidx, mask, guard)
            got = fused_ctx_pool_triple(fused, tidx, mask, guard,
                                        force="matmul")
            torch.cuda.synchronize()
            nan = want.isnan()
            check(got.dtype == torch.float32 and got.shape == want.shape
                  and torch.equal(got.isnan(), nan),
                  "matmul tier %s guard=%s: output %s %s, NaN positions"
                  % (tag, guard, got.dtype, tuple(got.shape)))
            scale = float(want[~nan].abs().max())
            e = float((got - want).abs()[~nan].max()) / scale
            check(e <= 1e-5, "matmul tier %s guard=%s differs from kernel "
                  "4 by %.3e of scale" % (tag, guard, e))
            err = max(err, e)
        times = dict(
            tier_ms=median_ms(torch, lambda: fused_ctx_pool_triple(
                fused, tidx, mask, True, force="matmul")),
            tier_build_ms=median_ms(torch, lambda: fused_ctx_pool_triple(
                fuse(torch, emb, tri), tidx, mask, True, force="matmul")),
            kernel4_ms=median_ms(torch, lambda: fused_ctx_pool_triple(
                fused, tidx, mask, True)),
            kernel4_build_ms=median_ms(torch, lambda: fused_ctx_pool_triple(
                fuse(torch, emb, tri), tidx, mask, True)))
        log("  matmul tier %-4s M=%d R=%d U=%d width %d: %.3e of scale from "
            "kernel 4; tier (S built inside) %.4f ms, with the local-table "
            "build %.4f ms; kernel 4 %.4f ms, with the build %.4f ms; the "
            "product's %.2f GFLOP" % (
                tag, M, R, U, width, err, times["tier_ms"],
                times["tier_build_ms"], times["kernel4_ms"],
                times["kernel4_build_ms"], 2 * M * U * width / 1e9))
        out[tag] = dict(max_rel_err=err, M=M, R=R, U=U, width=width, **times)
        del emb, mask, fused, tri, tidx
    torch.cuda.empty_cache()
    return out


def masked_sum_loop(torch, table, idx, mask):
    """Kernel 5's function as an r-ordered eager loop of separate
    multiplies and adds (one rounding each, no fused multiply-add) from
    zeros, rounded to the table's dtype once: the kernel's operations in
    its order, so the two agree bit for bit."""
    acc = torch.zeros(idx.shape[0], table.shape[1], device=table.device)
    rows = idx.long()
    for r in range(idx.shape[1]):
        acc = acc + mask[:, r, None] * table[rows[:, r]].float()
    return acc.to(table.dtype)


def masked_sum_probe_checks(torch):
    """Kernel 5 at the bf16 probe's shapes (``tools/probe_bf16_pack.SHAPES``:
    its own [512, 1024] table with M = 64, and the clip table's), on the
    native bf16 table of the probe's values: bitwise the r-ordered loop,
    within one bf16 rounding of the plain version; its time (L2 flushed)
    beside the plain version's and ``embedding_bag``'s on the same bf16
    table, and its bound. Returns {"gms_<shape>": {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by}}."""
    import torch.nn.functional as F

    from lirec_tpu_torch.ops.gather_pool import (
        gather_masked_sum, gather_masked_sum_reference,
    )
    from lirec_tpu_torch.tools import probe_bf16_pack

    results = {}
    for name, (n, d, m, r) in probe_bf16_pack.SHAPES.items():
        table, idx, mask = probe_bf16_pack.make_inputs(torch, "cuda", n, d,
                                                       m, r)
        native = table.to(torch.bfloat16)
        got = gather_masked_sum(native, idx, mask)
        torch.cuda.synchronize()
        check(got.shape == (m, d) and got.dtype == torch.bfloat16,
              "gather_masked_sum bf16 %s output %s %s"
              % (name, tuple(got.shape), got.dtype))
        check(torch.equal(got, masked_sum_loop(torch, native, idx, mask)),
              "gather_masked_sum bf16 %s: not bitwise the r-ordered loop"
              % name)
        want = gather_masked_sum_reference(native, idx, mask)
        err = float((got.float() - want.float()).abs().max())
        tol = 2 ** -8 * float(want.float().abs().max())
        check(err <= tol, "gather_masked_sum bf16 %s disagrees" % name)
        w = mask.to(torch.bfloat16)
        ms = median_ms(torch, lambda: gather_masked_sum(native, idx, mask))
        plain = median_ms(torch, lambda: gather_masked_sum_reference(
            native, idx, mask))
        lib = median_ms(torch, lambda: F.embedding_bag(
            idx, native, per_sample_weights=w, mode="sum"))
        moved = gathered_bytes(native, idx) + nbytes(idx, mask) + m * d * 2
        b = bound(moved, 2 * m * r * d)
        log("  gather_masked_sum bf16 (kernel 5) %s [%d, %d] M=%d: bitwise "
            "the r-ordered loop, max|diff| vs plain %.3e (bound %.1e); "
            "kernel %.4f ms, plain %.4f ms, embedding_bag (bf16 table) %.4f "
            "ms; bound %.4f ms (%s, %.2f MB)"
            % (name, n, d, m, err, tol, ms, plain, lib, b["bound_ms"],
               b["bound_by"], moved / 1e6))
        results["gms_" + name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      library_ms=lib, **b)
        del table, idx, mask, native, got, want, w
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ main path


@contextmanager
def serving(engine):
    from lirec_tpu_torch.cli.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % httpd.server_port
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def samples_of(batch):
    return [
        {"feat_idx": batch["feat_idx"][i].tolist(),
         "rels_mask": batch["rels_mask"][i].tolist()}
        for i in range(batch["feat_idx"].shape[0])
    ]


def check_predictions(preds, B, spec, label):
    import math

    check(len(preds) == B, "%s: %d predictions for %d samples"
          % (label, len(preds), B))
    for p in preds:
        check(len(p["track_scores"]) == 20, "%s: track_scores" % label)
        check(0 <= p["best_track"] < 20, "%s: best_track" % label)
        for key, n_labels in (("interactions", spec.n_classes),
                              ("relationships", spec.n_rels)):
            items = p[key]
            check(len(items) == TOPK, "%s: %s top-k" % (label, key))
            for it in items:
                check(0 <= it["label"] < n_labels, "%s: %s label"
                      % (label, key))
                check(math.isfinite(it["score"]) and 0 <= it["score"] <= 1,
                      "%s: %s score %r" % (label, key, it["score"]))
        check(all(math.isfinite(s) and 0 <= s <= 1
                  for s in p["track_scores"]), "%s: track score" % label)


def main_path(torch):
    """Phase 4. Returns {kernel name: launches} and the latencies."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.utils.fake_batch import make_structured_batch, make_tables
    from lirec_tpu_torch.cli.serve import InferenceEngine
    from lirec_tpu_torch.evaluation.metrics import _sigmoid
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    cfg = config_lib.preset("int_rel_ch")
    engines = {}
    with host_clock(torch) as clock:
        tables = None
        for compute in ("bfloat16", "float32"):
            bundle = create_model(cfg.with_runtime(compute_dtype=compute),
                                  101, n_rels=15, seed=0, device="cuda")
            if tables is None:
                tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
            engines[compute] = InferenceEngine(bundle, tables, device="cuda",
                                               topk=TOPK, max_batch=64)
    spec = engines["float32"].bundle.spec
    check((spec.text_dim, spec.visual_dim, spec.track_dim, spec.joint_dim,
           spec.mid_m_ints, spec.n_classes, spec.n_rels)
          == (768, 2048, 2048, 512, 6, 101, 15), "published widths: %s" % (
              spec,))
    log("  engines built (tables embedded once each) in %.1f s" % clock.s)
    batches = {B: make_structured_batch(spec, B, N_CLIPS, N_TRACKS,
                                        seed=100 + B) for B in B_SIZES}
    reps = {1: 10, 64: 5}  # timed requests per size (3 for the others)

    # ---- the counted run: only the served requests launch kernels here
    dispatch.reset_launches()
    forwards = {}
    latency = {}
    served = {}
    for compute, engine in engines.items():
        n = 0
        with serving(engine) as base:
            status, health = http(base + "/healthz")
            check(status == 200 and health["status"] == "ok"
                  and health["n_classes"] == 101 and health["n_rels"] == 15,
                  "healthz: %s %s" % (status, health))
            for B in B_SIZES:
                payload = {"samples": samples_of(batches[B])}
                answers = []  # the first is a warm-up
                times = host_ms(torch, lambda _: answers.append(
                    http(base + "/predict", payload)), 1 + reps.get(B, 3))
                for status, out in answers:
                    n += 1
                    check(status == 200, "%s B=%d: status %s %s"
                          % (compute, B, status, out))
                    check_predictions(out["predictions"], B, spec,
                                      "%s B=%d" % (compute, B))
                served[(compute, B)] = out["predictions"]
                latency[(compute, B)] = statistics.median(times[1:])
                log("  %s /predict B=%-2d median %.2f ms over %d requests"
                    % (compute, B, latency[(compute, B)], len(times) - 1))
        forwards[compute] = n
    counts = kernel_launches()
    # ---- end of the counted run

    names = {"bfloat16": KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)],
             "float32": KERNEL_NAMES[("fused_ctx_pool", torch.float32)]}
    for compute, name in names.items():
        log("  %s: %d forwards, %d launches of %s"
            % (compute, forwards[compute], counts.get(name, 0), name))
        check(counts.get(name, 0) == forwards[compute],
              "%s: launches %d != forwards %d"
              % (name, counts.get(name, 0), forwards[compute]))

    # the logits against the same forward with the plain pool on the card;
    # f32: one-ulp pool differences through f32 matmuls; bf16: a pooled
    # value can round to the neighbouring bf16 before the gate
    atol = {"float32": 1e-5, "bfloat16": 2e-3}
    for compute, engine in engines.items():
        for B in B_SIZES[1:]:
            batch = {k: batches[B][k] for k in ("feat_idx", "rels_mask")}
            with torch.inference_mode():
                outs = [engine.bundle.apply(engine.bundle.model, batch,
                                            embedded=engine.embedded,
                                            use_kernel=use)
                        for use in (True, False)]
            torch.cuda.synchronize()
            for key, width in (("inters", 101), ("rels", 15)):
                got, want = outs[0][key], outs[1][key]
                check(tuple(got.shape) == (B, 20, width),
                      "%s %s shape %s" % (compute, key, tuple(got.shape)))
                check(bool(torch.isfinite(got).all()),
                      "%s %s: non-finite logits" % (compute, key))
                err = float((got - want).abs().max())
                log("  %s B=%d %s: kernel vs plain pool max|diff| %.3e "
                    "(atol %.0e)" % (compute, B, key, err, atol[compute]))
                check(err <= atol[compute], "%s %s: kernel path disagrees"
                      % (compute, key))
            # the served scores are the sigmoid of these logits
            s = _sigmoid(outs[0]["inters"].cpu().numpy().astype(np.float64))
            got = np.array([p["track_scores"] for p in served[(compute, B)]])
            check(np.abs(got - s.max(axis=-1)).max() < 1e-5,
                  "%s B=%d: served scores differ from the logits"
                  % (compute, B))
    del engines
    torch.cuda.empty_cache()
    return counts, latency


def entry_point(torch):
    """Phase 5: the CLI's own engine builder on a synthetic fixture."""
    from lirec_tpu_torch.utils.fake_batch import make_batch
    from lirec_tpu_torch.cli.serve import build_engine_from_args, make_parser

    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        args = make_parser().parse_args([
            "--data-root", root, "--text-dim", "16", "--visual-dim", "32",
            "--text-layers", "4", "--joint-dim", "16", "--device", "cuda",
        ])
        engine = build_engine_from_args(args)
        check(engine.device.type == "cuda", "engine not on cuda")
        batch = make_batch(engine.bundle.spec, 2, engine.n_clip_rows,
                           engine.n_track_rows, seed=3)
        with serving(engine) as base:
            status, out = http(base + "/predict",
                               {"samples": samples_of(batch)})
        check(status == 200, "entry point: %s %s" % (status, out))
        check_predictions(out["predictions"], 2, engine.bundle.spec,
                          "entry point")
        log("  build_engine_from_args on %s: %d classes, %d rels, "
            "/predict ok" % (engine.device, engine.bundle.spec.n_classes,
                             engine.bundle.spec.n_rels))


# ------------------------------------------------------- scatter kernel


def train_batches(spec):
    """TRAIN_STEPS structured B = 64 host batches (the real loader's index
    locality: heavy duplicate rows), and the same batches localized
    together by the port's Localizer, as the train loop localizes an
    epoch. Returns (raw, localized, (cap_clip, cap_track))."""
    from lirec_tpu_torch.utils.fake_batch import make_structured_batch
    from lirec_tpu_torch.data.localize import Localizer

    raw = [make_structured_batch(spec, TRAIN_B, N_CLIPS, N_TRACKS,
                                 seed=400 + i) for i in range(TRAIN_STEPS)]
    localizer = Localizer(spec, N_CLIPS, N_TRACKS)
    local = localizer.maybe_localize(raw)
    check(localizer.applied, "the Localizer did not localize")
    return raw, local, (localizer.cap_clip, localizer.cap_track)


def ctx_idx(torch, batch):
    """A batch's ctx index triples as a contiguous int32 [B*T, R, 3] on the
    card: the idx of the train step's gather_h1."""
    fi = batch["feat_idx"]
    return torch.from_numpy(fi[:, :, 1:, :].reshape(
        -1, fi.shape[2] - 1, 3).copy()).cuda()


def scatter_case(torch, label, idx, gs, rows, single):
    """The op (``scatter_accum3`` / ``scatter_accum1``) vs its plain
    version on the card (index_add_, f32 atomics) and vs the in-order sum
    on the CPU; two launches must be bitwise equal. Returns the entry: max
    |diff| vs the card's plain version; the path the op takes (`op_path`:
    "sorted" or "small", ``scatter_path``); the op's ms (everything it
    launches: `op_ms`, and each launch's device ms inside it,
    `op_split_ms`, all of them the port's own kernels); the kernel's ms
    (`ms`: the sorted kernel alone on sorted updates, `sorted_ms`, or the
    one-launch kernel where the op takes it); the counting sort's ms
    (`sort_ms`, its perm and offsets bitwise sort_by_row's) and
    sort_by_row's (`plain_sort_ms`); the plain version's (``index_add_``,
    also the library call); the sorted kernel's device ms per launch
    inside it; the bound; and `sort`, the counting sort's own entry. On a
    single table narrow enough for the one-launch path, also the op
    forced down each path (`path_ms`: allocation and ``launch_small``, or
    allocation, ``sort_updates`` and ``launch_sorted``). Against a
    checkout without the counting sort (a parent,
    ``tools/kernel_phases.py``) it times what that checkout has:
    sort_by_row as the sort."""
    from lirec_tpu_torch.ops import scatter_accum as sa

    new = hasattr(sa, "count_sort")
    if single:
        one = idx[..., 0].contiguous()
        run = lambda: (sa.scatter_accum1(one, gs[0], rows[0]),)  # noqa: E731
        plain = lambda: (sa.scatter_accum1_reference(  # noqa: E731
            one, gs[0], rows[0]),)
        flat = one.reshape(-1, 1)
        gflat, rows_k = [gs[0].reshape(-1, gs[0].shape[-1])], rows[:1]
    else:
        run = lambda: sa.scatter_accum3(idx, *gs, *rows[:2])  # noqa: E731
        plain = lambda: sa.scatter_accum3_reference(  # noqa: E731
            idx, *gs, *rows[:2])
        flat = idx.reshape(-1, 3)
        gflat = [g.reshape(-1, g.shape[-1]) for g in gs]
        rows_k = rows
    widths = [g.shape[-1] for g in gflat]
    path = sa.scatter_path(flat.shape[0], rows_k, widths) if new \
        else "sorted"
    got, again = run(), run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "%s: two launches differ" % label)
    want_gpu = plain()
    if single:
        want_cpu = (sa.scatter_accum1_reference(one.cpu(), gs[0].cpu(),
                                                rows[0]),)
    else:
        want_cpu = sa.scatter_accum3_reference(
            idx.cpu(), *(g.cpu() for g in gs), *rows[:2])
    torch.cuda.synchronize()
    err_gpu = max(float((a - b).abs().max()) for a, b in zip(got, want_gpu))
    err_cpu = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(got, want_cpu))
    scale = max(float(b.abs().max()) for b in want_cpu)
    log("  %-44s max|diff| vs card plain %.3e, vs CPU in-order %.3e "
        "(scale %.1f); path %s" % (label, err_gpu, err_cpu, scale, path))
    # the kernel sums each row in update order with f32 adds, as index_add_
    # does on the CPU: bitwise equal; the card's plain version sums with
    # atomics in another order: 1e-5 of the largest sum
    check(err_cpu == 0.0, "%s: differs from the in-order sum" % label)
    check(err_gpu <= 1e-5 * scale, "%s: differs from the plain version"
          % label)
    op_ms = median_ms(torch, run)
    op_split = launch_split_ms(torch, run)
    if new:
        others = [k for k in op_split
                  if k.split("<")[0] not in SCATTER_OP_KERNELS]
        check(not others, "%s: the op launched %s beside the port's "
              "kernels" % (label, others))
    perm, offsets = sa.sort_by_row(flat, rows_k)
    plain_sort_ms = median_ms(torch, lambda: sa.sort_by_row(flat, rows_k))
    starts = torch.tensor([sum(rows_k[:t]) for t in range(len(rows_k))],
                          dtype=torch.int32, device="cuda")
    keys = (flat + starts).reshape(-1)
    library_sort_ms = median_ms(torch, lambda: torch.sort(keys, stable=True))
    if new:
        mine = sa.count_sort(flat, rows_k)
        torch.cuda.synchronize()
        check(torch.equal(mine[0], perm) and torch.equal(mine[1], offsets),
              "%s: the counting sort differs from sort_by_row" % label)
        sort_ms = median_ms(torch, lambda: sa.count_sort(flat, rows_k))
        sort_split = launch_split_ms(torch, lambda: sa.count_sort(
            flat, rows_k))
    else:
        sort_ms, sort_split = plain_sort_ms, {}
    outs = [torch.empty_like(o) for o in got]
    if new:  # the sort lists the hot tiles: a workspace of its own
        ordered = sa.sort_updates(flat, gflat, rows_k)
        launch = lambda: sa.launch_sorted(gflat, outs, *ordered)  # noqa: E731
    else:
        launch = lambda: sa.launch_sorted(  # noqa: E731
            gflat, outs, perm, offsets)
    sorted_ms = median_ms(torch, launch)
    split = launch_split_ms(torch, launch)
    plain_ms = median_ms(torch, plain)
    check(all(torch.equal(a, b) for a, b in zip(outs, got)),
          "%s: timed launches differ" % label)
    ms = sorted_ms
    path_ms = {}
    if new and single and widths[0] <= sa.SMALL_MAX_WIDTH \
            and flat.shape[0] <= sa.SMALL_MAX_UPDATES:
        small_out = torch.empty_like(got[0])
        small = lambda: sa.launch_small(  # noqa: E731
            flat.reshape(-1), gflat[0], small_out)
        small_ms = median_ms(torch, small)
        check(torch.equal(small_out, got[0]), "%s: the one-launch kernel "
              "differs from the op" % label)
        if path == "small":
            ms = small_ms

        def forced_small():  # what the op does on each path
            out = torch.empty_like(got[0])
            sa.launch_small(flat.reshape(-1), gflat[0], out)

        def forced_sorted():
            out = torch.empty_like(got[0])
            sa.launch_sorted(gflat, [out], *sa.sort_updates(flat, gflat,
                                                            rows_k))

        path_ms = {"small": median_ms(torch, forced_small),
                   "sorted": median_ms(torch, forced_sorted)}
    upd, out = nbytes(*gflat), nbytes(*got)
    adds = sum(g.numel() for g in gflat)
    b = bound(upd + out + nbytes(flat), adds)
    sort_bound = bound(nbytes(flat, perm, offsets), 0)
    log("  %-44s op %.4f ms (%s); kernel %.4f ms (sorted kernel %.4f); "
        "sort %.4f ms, sort_by_row %.4f, torch.sort %.4f; plain %.4f ms; "
        "bound %.4f ms (%s, %.1f MB), sort's %.5f ms; device ms per launch "
        "inside the op %s%s" % (
            "", op_ms, path, ms, sorted_ms, sort_ms, plain_sort_ms,
            library_sort_ms, plain_ms, b["bound_ms"], b["bound_by"],
            (upd + out) / 1e6, sort_bound["bound_ms"], json.dumps(op_split),
            "; forced paths %s" % json.dumps(path_ms) if path_ms else ""))
    return dict(max_abs_err=err_gpu, op_path=path, ms=ms, op_ms=op_ms,
                sorted_ms=sorted_ms, sort_ms=sort_ms,
                plain_sort_ms=plain_sort_ms, plain_ms=plain_ms,
                library_ms=plain_ms, launch_split_ms=split,
                op_split_ms=op_split, path_ms=path_ms,
                sort=dict(max_abs_err=0.0, ms=sort_ms, plain_ms=plain_sort_ms,
                          library_ms=library_sort_ms,
                          launch_split_ms=sort_split, **sort_bound), **b)


def launch_split_ms(torch, fn, reps=10):
    """Device ms of each launch (kernel or memset) that `fn` makes, by
    ``torch.profiler``: the mean over `reps` calls, each after the L2
    flush and the spin of ``median_ms``."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
            fn()
        torch.cuda.synchronize()
    total = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        if "spin_kernel" in name or "FillFunctor" in name:
            continue  # the flush and the spin
        span = (evt.time_range.end - evt.time_range.start) / 1e3
        total[name] = total.get(name, 0.0) + span
    check(total, "the profiler recorded no launch of the op")
    return {k: v / reps for k, v in sorted(total.items())}


def scatter_checks(torch, spec, raw, local, caps):
    """Phase 6, on the ctx indices of one structured batch (`raw`) and of
    the same batch localized (`local`, tables of `caps` rows, what the
    train step scatters into), then the int_rels score table's shapes
    (INT_RELS_SHAPES). Returns {entry: scatter_case's entry}: the
    localized case under the dtype's name (the train path's shapes), the
    split-scale, flattened, single-table and B = 1,024 cases under
    suffixes, the
    int_rels cases as int_rels_<updates>x<rows>, and with the counting
    sort ``sort_checks``'s cases."""
    from lirec_tpu_torch.ops import scatter_accum as sa

    idx_full, idx_loc = ctx_idx(torch, raw), ctx_idx(torch, local)
    idx_dup = idx_full % 8  # every update into 8 rows of each table
    g = torch.Generator(device="cuda").manual_seed(6)
    d_clip, d_tr = 2 * spec.joint_dim, spec.joint_dim
    base = [torch.randn(*idx_full.shape[:2], d, device="cuda", generator=g)
            for d in (d_clip, d_tr, d_tr)]
    full = (N_CLIPS, N_TRACKS, N_TRACKS)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        gs = [t.to(dtype) for t in base]
        # the plain version is index_add_, the library call itself
        results[tag] = scatter_case(
            torch, "3 tables at caps %dx%d %s" % (caps[0], caps[1], tag),
            idx_loc, gs, (caps[0], caps[1], caps[1]), single=False)
        results[tag + "@split_tables"] = scatter_case(
            torch, "3 tables %dx%d rows %s" % (N_CLIPS, N_TRACKS, tag),
            idx_full, gs, full, single=False)
        scatter_case(torch, "3 tables, all updates into 8 rows, %s" % tag,
                     idx_dup, gs, full, single=False)
        results[tag + "@flat"] = scatter_case(
            torch, "flattened [23040, d] %s" % tag, idx_full.reshape(-1, 3),
            [t.reshape(-1, t.shape[-1]) for t in gs], full, single=False)
        results[tag + "@single_table"] = scatter_case(
            torch, "single table (clip) %s" % tag, idx_full, gs, full,
            single=True)
    del base, gs
    # the train step's scatter at B = 1,024 into split-scale tables: the
    # sort by digits in front of kernel 6
    M = BIG_SCATTER_M
    idx_big = torch.stack([torch.randint(0, n, (M,), device="cuda",
                                         generator=g) for n in full], 1)
    idx_big[torch.rand(M, device="cuda", generator=g) < 0.25] = 0
    idx_big = idx_big.to(torch.int32).contiguous()
    base = [torch.randn(M, d, device="cuda", generator=g)
            for d in (d_clip, d_tr, d_tr)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        results[tag + "@B1024"] = scatter_case(
            torch, "3 tables, B = 1,024, %dx%d rows %s" % (
                N_CLIPS, N_TRACKS, tag), idx_big,
            [t.to(dtype) for t in base], full, single=False)
    del base, idx_big
    # the int_rels sweep's score table: one table, few narrow updates
    for n_rows, batch, width in INT_RELS_SHAPES:
        hashes = torch.randint(0, n_rows, (batch,), device="cuda",
                               generator=g)
        ids = torch.cat([torch.arange(n_rows, device="cuda"), hashes])
        upd = torch.rand(n_rows + batch, width, device="cuda", generator=g)
        results["int_rels_%dx%d" % (n_rows + batch, n_rows)] = scatter_case(
            torch, "int_rels table: %d updates of %d into %d" % (
                n_rows + batch, width, n_rows),
            ids[:, None].expand(-1, 3).to(torch.int32).contiguous(), [upd],
            [n_rows], single=True)
    if hasattr(sa, "count_sort"):
        results.update(sort_checks(torch, g))
    torch.cuda.empty_cache()
    return results


def sort_checks(torch, g):
    """The counting sort alone at SORT_CASES: perm and offsets bitwise
    sort_by_row's; median ms of count_sort, sort_by_row and torch.sort of
    the keys, and each launch's device ms. Returns {sort_<P>x<rows>:
    entry}."""
    from lirec_tpu_torch.ops import scatter_accum as sa

    results = {}
    for M, rows in SORT_CASES:
        idx = torch.stack([torch.randint(0, n, (M,), device="cuda",
                                         generator=g) for n in rows], 1)
        idx[torch.rand(M, device="cuda", generator=g) < 0.25] = 0
        idx = idx.to(torch.int32).contiguous()
        sp = sa.sort_plan(idx.numel(), rows)
        want = sa.sort_by_row(idx, rows)
        got = sa.count_sort(idx, rows)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "counting sort of %d into %s rows differs from sort_by_row"
              % (idx.numel(), rows))
        ms = median_ms(torch, lambda: sa.count_sort(idx, rows))
        plain_ms = median_ms(torch, lambda: sa.sort_by_row(idx, rows))
        keys = idx.reshape(-1)
        library_ms = median_ms(torch, lambda: torch.sort(keys, stable=True))
        split = launch_split_ms(torch, lambda: sa.count_sort(idx, rows))
        b = bound(nbytes(idx, *want), 0)
        log("  counting sort, %d positions into %d rows: bitwise "
            "sort_by_row; %d pass(es) of %s bits, %d units, %s tiles; %.4f "
            "ms, sort_by_row %.4f, torch.sort %.4f; bound %.5f ms; device "
            "ms per launch %s" % (idx.numel(), sum(rows), sp["passes"],
                                  sp["digit_bits"] or "all", sp["units"],
                                  sp.get("tiles", "no"), ms, plain_ms,
                                  library_ms, b["bound_ms"],
                                  json.dumps(split)))
        results["sort_%dx%d" % (idx.numel(), sum(rows))] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            passes=sp["passes"], launch_split_ms=split, **b)
    return results


# ------------------------------------------------------------ train path


def timed_steps(torch, step, batches, tables, device="cuda"):
    """One step a batch, each seeded as train() seeds it: (the losses,
    each step's ms by host_ms; the first holds the warm-up)."""
    from lirec_tpu_torch.train.loop import step_generators

    losses = []
    times = host_ms(torch, lambda i: losses.append(float(step(
        batches[i], tables, step_generators(0, i, device)))), len(batches))
    return losses, times


def epochs_in_turns(torch, turns, sweep, step, batches, tables, label):
    """Epochs of `batches` after the counted one, as the epoch sweep's
    graph replays and as `step` run eagerly, in `turns` on one model
    (epoch turn + 1, seeded as train() seeds it); every epoch's losses
    finite. Returns {"graph": [ms/step], "eager": [ms/step]}."""
    import math

    from lirec_tpu_torch.train.loop import step_generators
    from lirec_tpu_torch.train.sweep import SEED_STRIDE

    def epoch(kind, turn):
        got = []

        def run(_):
            if kind == "graph":
                got.extend(sweep.fetch(sweep.run(batches, turn + 1)))
            else:
                got.extend(float(step(b, tables, step_generators(
                    0, (turn + 1) * SEED_STRIDE + i, "cuda")))
                    for i, b in enumerate(batches))

        times = host_ms(torch, run)
        check(all(math.isfinite(x) for x in got), "%s %s losses %s"
              % (label, kind, got))
        return [ms / len(batches) for ms in times]

    return in_turns(turns, {kind: functools.partial(epoch, kind)
                            for kind in ("graph", "eager")})


def step_grads(torch, bundle, batch, tables, use_kernel):
    """Gradients of one training forward + loss (dropout on, the step's
    generators reseeded identically each call)."""
    from lirec_tpu_torch.train.loop import MODEL_KEYS, _to_device, \
        step_generators

    model = bundle.model
    model.zero_grad(set_to_none=True)
    b = _to_device(batch, "cuda")
    gen_drop, gen_loss = step_generators(0, 7, "cuda")
    out = bundle.apply(model, {k: b[k] for k in MODEL_KEYS if k in b},
                       tables=tables, deterministic=False, rng=gen_drop,
                       use_kernel=use_kernel)
    bundle.loss(out, b, rng=gen_loss).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def train_path(torch, batches):
    """Phase 7 on localized host batches. Returns ({kernel name:
    launches}, {compute: ms/step}, {compute: (losses, final parameters on
    the host)}; phase 16 holds its data-parallel steps to the last)."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.utils.fake_batch import make_tables
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES, SORT_NAME
    from lirec_tpu_torch.train.loop import make_train_step
    from lirec_tpu_torch.train.optim import make_optimizer

    cfg = config_lib.preset("int_rel_ch")
    counts, step_ms, finals = {}, {}, {}
    tables = None
    for compute in ("bfloat16", "float32"):
        bundle = create_model(cfg.with_runtime(compute_dtype=compute), 101,
                              n_rels=15, seed=0, device="cuda")
        check((bundle.spec.text_dim, bundle.spec.visual_dim,
               bundle.spec.track_dim, bundle.spec.joint_dim)
              == (768, 2048, 2048, 512), "published widths")
        if tables is None:
            tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
                bundle.spec, N_CLIPS, N_TRACKS, seed=0).items()}
        name = KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                            else torch.float32]

        # one step's gradients, kernel against the plain scatter (not counted)
        with_kernel = step_grads(torch, bundle, batches[0], tables, True)
        plain = step_grads(torch, bundle, batches[0], tables, False)
        torch.cuda.synchronize()
        # f32: the plain scatter's atomics sum the table grads in another
        # order (1e-5 of each tensor's scale); bf16: the table grads are
        # then rounded to bf16, where such a difference can flip a rounding
        # (the bf16 contract, 4.1e-3 of scale)
        rel = 4.1e-3 if compute == "bfloat16" else 1e-5
        worst = 0.0
        for n, g in with_kernel.items():
            p = plain[n]
            check(bool(torch.isfinite(g).all()), "%s: non-finite grad %s"
                  % (compute, n))
            scale = float(p.abs().max())
            err = float((g - p).abs().max())
            worst = max(worst, err / scale if scale else err)
            check(err <= rel * scale, "%s: grad %s differs from the plain "
                  "scatter's by %.3e (scale %.3e)" % (compute, n, err, scale))
        log("  %s: step grads with the kernel vs the plain scatter: worst "
            "|diff| / scale %.3e (bound %.1e)" % (compute, worst, rel))

        before = {n: p.detach().clone()
                  for n, p in bundle.model.named_parameters()}
        opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                             cfg.optim.weight_decay)
        step = make_train_step(bundle, opt)
        # ---- the counted run: only the training steps launch kernels here
        dispatch.reset_launches()
        losses, times = timed_steps(torch, step, batches, tables)
        counted = kernel_launches()
        # ---- end of the counted run
        check(all(np.isfinite(losses)), "%s: losses %s" % (compute, losses))
        check(counted == {name: len(batches), SORT_NAME: len(batches)},
              "%s: launches %s for %d steps (the sort, then the scatter, "
              "once a step)" % (compute, counted, len(batches)))
        for n, p in bundle.model.named_parameters():
            check(not torch.equal(p.detach(), before[n]),
                  "%s: parameter %s did not move" % (compute, n))
        counts[name] = counted[name]
        counts[SORT_NAME] = counts.get(SORT_NAME, 0) + counted[SORT_NAME]
        step_ms[compute] = statistics.median(times[1:])
        finals[compute] = (losses, {n: p.detach().cpu() for n, p in
                                    bundle.model.named_parameters()})
        log("  %s: %d steps, losses %.4f .. %.4f, %d launches of %s; "
            "median %.2f ms/step (first %.1f ms), %.0f clips/s"
            % (compute, len(batches), losses[0], losses[-1], counted[name],
               name, step_ms[compute], times[0],
               TRAIN_B / step_ms[compute] * 1e3))
        del bundle, opt, step, before, with_kernel, plain
        torch.cuda.empty_cache()
    return counts, step_ms, finals


def train_entry(torch):
    """Phase 8: train() on a synthetic fixture, on the card."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data import synthetic
    from lirec_tpu_torch.data.dataset import InteractionDataset
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES
    from lirec_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        base = synthetic.make_config(root)
        cfg = config_lib.preset("int_rel_ch", data_root=root)
        cfg = cfg.replace(dims=base.dims, paths=base.paths).with_optim(
            batch_size=8, epochs=2, save_model=False)
        ds = InteractionDataset(cfg, mode="train")
        ds.cache()
        ds.init_relships()
        bundle = create_model(cfg, ds.n_classes,
                              n_rels=max(len(ds.rels_list) - 1, 0),
                              device="cuda")
        dispatch.reset_launches()
        out = train(cfg, bundle, ds, verbose=False)
        torch.cuda.synchronize()
        counted = kernel_launches()
    name = KERNEL_NAMES[torch.bfloat16]  # the preset computes in bf16
    steps = 2 * -(-len(ds) // 8)
    check(len(out["losses"]) == 2 and all(np.isfinite(out["losses"])),
          "train() losses %s" % out["losses"])
    check(counted.get(name, 0) == steps, "train(): %d launches of %s for "
          "%d steps" % (counted.get(name, 0), name, steps))
    log("  train() on %d synthetic samples, batch 8, 2 epochs: losses %s, "
        "%d launches of %s" % (len(ds), out["losses"], counted[name], name))


# ------------------------------------------------------------- eval sweep


def eval_split(spec):
    """EVAL_FULL structured B = 64 batches and an EVAL_TAIL-sample tail,
    as one materialized split."""
    import numpy as np

    from lirec_tpu_torch.utils.fake_batch import make_structured_batch

    parts = [make_structured_batch(spec, EVAL_B, N_CLIPS, N_TRACKS,
                                   seed=900 + i) for i in range(EVAL_FULL)]
    parts.append(make_structured_batch(spec, EVAL_TAIL, N_CLIPS, N_TRACKS,
                                       seed=900 + EVAL_FULL))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def split_stand_in():
    """What evaluate_packed reads of a dataset: 101 interaction classes
    and 16 relationship labels (15 heads and 'None', as dataset.n_rels
    counts them), no relationship hashes."""
    import types

    return types.SimpleNamespace(n_classes=101, n_rels=16, hashidx_rels=None)


# a plain pool differs from the kernel by ulps; through f32 (or bf16-rounded)
# GEMMs that can flip an argmax tie between two hypotheses or classes
MAX_COUNTER_FLIPS = 8


def eval_sweep(torch, spec):
    """Phase 9. Returns ({kernel name: launches of one counted sweep: the
    3-table kernel's of the off tier (what ``auto`` runs), the triple
    kernel's of the triple tier}, {(compute, tier): clips/s}, {"split":
    the split, "carries": {compute: the off tier's carry}}; phase 16 holds
    its sharded sweeps to the last)."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.localize import (
        localize_eval_ctx, localize_eval_ctx_triples,
    )
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.utils.fake_batch import make_tables

    with host_clock(torch) as clock:
        data = eval_split(spec)
    n_samples = len(data["labels"])
    log("  split: %d structured B=%d batches + a %d-sample tail (%d "
        "samples), made in %.1f s" % (EVAL_FULL, EVAL_B, EVAL_TAIL,
                                      n_samples, clock.s))
    fi = data["feat_idx"]
    for name, fn in (
        ("triple", lambda: localize_eval_ctx_triples(
            fi, EVAL_B, EVAL_FULL, N_TRACKS)),
        ("tables", lambda: localize_eval_ctx(
            fi, EVAL_B, EVAL_FULL, N_CLIPS, N_TRACKS)),
    ):
        with host_clock(torch) as clock:
            loc = fn()
        caps = loc[1].shape[1] if name == "triple" else (
            loc[1].shape[1], loc[2].shape[1])
        log("  host localisation (%s tier) of the split: %.3f s, caps %s"
            % (name, clock.s, caps))
    n_half = EVAL_FULL // 2
    halves = {n: {k: v[: n * EVAL_B] for k, v in data.items()}
              for n in (n_half, EVAL_FULL)}

    captured = {}
    finish = packed.finish_from_carry

    def capture(carry, *args, **kw):
        captured["carry"] = carry
        return finish(carry, *args, **kw)

    packed.finish_from_carry = capture
    tables, counts, rates, off_carries = None, {}, {}, {}
    try:
        for compute in ("bfloat16", "float32"):
            dtype = torch.bfloat16 if compute == "bfloat16" else \
                torch.float32
            cfg = config_lib.preset("int_rel_ch").with_optim(
                batch_size=EVAL_B).with_runtime(compute_dtype=compute)
            bundle = create_model(cfg, 101, n_rels=15, seed=0,
                                  device="cuda")
            check((bundle.spec.text_dim, bundle.spec.visual_dim,
                   bundle.spec.track_dim, bundle.spec.joint_dim)
                  == (768, 2048, 2048, 512), "published widths")
            if tables is None:
                tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
            dev_tables = {k: torch.from_numpy(v).cuda()
                          for k, v in tables.items()}
            with torch.inference_mode():
                times = host_ms(torch, lambda _: embed_all(
                    bundle.model, bundle.spec, dev_tables), 4)
            del dev_tables
            log("  %s: embed_all over %d / %d rows: median %.2f ms"
                % (compute, N_CLIPS, N_TRACKS, statistics.median(times[1:])))

            def sweep(tier, split=data, ds=None, use_kernel=True):
                return packed.evaluate_packed(
                    ds or split_stand_in(), bundle, bundle.model, cfg,
                    mode="test", verbose=False, data=split, tables=tables,
                    use_kernel=use_kernel, localize_ctx=tier)

            three = KERNEL_NAMES[("fused_ctx_pool", dtype)]
            tri = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
            carries = {}
            for tier in (False, "tables", "triple"):
                # ---- the counted run: one sweep of the split
                dispatch.reset_launches()
                metrics = sweep(tier)
                torch.cuda.synchronize()
                launched = kernel_launches()
                # ---- end of the counted run
                carries[tier] = captured["carry"]
                want = ({tri: EVAL_FULL, three: 1} if tier == "triple"
                        else {three: EVAL_FULL + 1})
                check({k: launched.get(k, 0) for k in (three, tri)}
                      == dict({three: 0, tri: 0}, **want),
                      "%s %s sweep launched %s" % (compute, tier, launched))
                check(all(np.isfinite(v) for v in metrics.values()),
                      "%s %s metrics %s" % (compute, tier, metrics))
                if tier == "triple":
                    counts[tri] = launched[tri]
                elif not tier:  # auto localisation: the full tables
                    counts[three] = launched[three]
                log("  %s localize=%-6s loss %.6f, %d batches, launches %s; "
                    "metrics %s" % (
                        compute, tier, metrics["loss"],
                        int(carries[tier]["n_batches"]),
                        {k: v for k, v in launched.items() if "pool" in k},
                        {k: round(v, 6) for k, v in metrics.items()}))
            for tier in ("tables", "triple"):
                for key, val in carries[False].items():
                    check(np.array_equal(carries[tier][key], val),
                          "%s: %s carry %s differs from the unlocalised "
                          "sweep's" % (compute, tier, key))
            log("  %s: the three tiers' carries are bitwise equal"
                % compute)
            off_carries[compute] = carries[False]
            sweep(None, use_kernel=False)
            plain = captured["carry"]
            base = carries[False]
            rel = abs(float(plain["loss_sum"]) - float(base["loss_sum"])) / \
                abs(float(base["loss_sum"]))
            flips = {k: int(abs(int(plain[k]) - int(v)))
                     for k, v in base.items() if k != "loss_sum"}
            log("  %s: plain pools vs kernel: loss rel diff %.2e (bound "
                "1e-5), counter diffs %s (bound %d each)"
                % (compute, rel, flips, MAX_COUNTER_FLIPS))
            check(rel <= 1e-5, "%s: plain-pool loss differs" % compute)
            check(max(flips.values()) <= MAX_COUNTER_FLIPS,
                  "%s: plain-pool counters differ" % compute)

            # clips/s: the slope of the sweep time over two batch counts,
            # the tiers taken in turn, EVAL_ROUNDS rounds
            tiers = (False, "tables", "triple")
            stand_ins = {(tier, n): split_stand_in()
                         for tier in tiers for n in halves}
            for tier in tiers:
                for n in halves:  # warm-up; computes the localisation
                    sweep(tier, halves[n], stand_ins[(tier, n)])

            def timed_sweep(key, turn):
                return host_ms(torch, lambda _: sweep(
                    key[0], halves[key[1]], stand_ins[key]))

            order = [(tier, n) for r in range(EVAL_ROUNDS)
                     for tier in tiers[r % 3:] + tiers[:r % 3]
                     for n in (n_half, EVAL_FULL)]
            secs = {key: [ms / 1e3 for ms in times] for key, times in
                    in_turns(order, {key: functools.partial(timed_sweep, key)
                                     for key in stand_ins}).items()}
            for tier in tiers:
                t1 = statistics.median(secs[(tier, n_half)])
                t2 = statistics.median(secs[(tier, EVAL_FULL)])
                per_batch = (t2 - t1) / (EVAL_FULL - n_half)
                rounds = sorted(
                    EVAL_B * (EVAL_FULL - n_half) / (b - a) for a, b in zip(
                        secs[(tier, n_half)], secs[(tier, EVAL_FULL)]))
                rates[(compute, tier)] = EVAL_B / per_batch
                log("  %s localize=%-6s sweep %d batches %.4f s, %d batches "
                    "%.4f s (medians of %d): %.4f ms/batch, %.0f clips/s; "
                    "per round %s" % (
                        compute, tier, n_half, t1, EVAL_FULL, t2, EVAL_ROUNDS,
                        per_batch * 1e3, rates[(compute, tier)],
                        [round(x) for x in rounds]))
            del bundle
            torch.cuda.empty_cache()
    finally:
        packed.finish_from_carry = finish
    return counts, rates, {"split": data, "carries": off_carries}


def eval_cli(torch):
    """Phase 10: the int_rel_ch eval CLI on a synthetic fixture, on the
    card, with a reference-format checkpoint of seeded weights."""
    import math

    from lirec_tpu_torch.cli import common, int_rel_ch
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch

    with tempfile.TemporaryDirectory() as root:
        write_fixture(root)
        ckpt = os.path.join(root, "weights.pth.tar")
        args = ["--data-root", root, "--resume-path", ckpt,
                "--batch-size", "8", "--device", "cuda", "--quiet",
                "--sanity-check", "--text-dim", "16", "--visual-dim", "32",
                "--text-layers", "4", "--joint-dim", "16"]
        cfg = common.config_from_args(
            "int_rel_ch", common.build_parser("int_rel_ch").parse_args(args))
        train_ds, _, _ = common.build_datasets(cfg, "int_rel_ch")
        model = create_model(cfg, train_ds.n_classes,
                             n_rels=max(len(train_ds.rels_list) - 1, 0),
                             seed=0, device="cpu").model
        torch.save({"state_dict": model.state_dict()}, ckpt)
        dispatch.reset_launches()
        out = int_rel_ch.main(args)
        torch.cuda.synchronize()
        launched = kernel_launches()
    for split in ("val", "test"):
        check(all(math.isfinite(v) for v in out[split].values()),
              "CLI %s metrics %s" % (split, out[split]))
    log("  cli.int_rel_ch.main on the card: val %s, test %s; launches %s; "
        "localisation %s" % (out["val"], out["test"], launched,
                             dispatch.last_dispatch("eval_ctx_localize")))


# ------------------------------------------------------------ the probes


def probe_phase(torch):
    """Phase 11. Returns ({kernel name: launches of the probes' run},
    ``probe_checks``' entries)."""
    import math

    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.tools import probe_bf16_pack, probe_hbm_dma

    # ---- the counted run: the two probes' entry points
    dispatch.reset_launches()
    dma = probe_hbm_dma.main([])
    pack = probe_bf16_pack.main([])
    torch.cuda.synchronize()
    counts = kernel_launches()
    # ---- end of the counted run
    check(all(math.isfinite(dma[k + "_ms"]) and dma[k + "_ms"] > 0
              for k in ("per_row", "per_row_runs", "per_run", "plain")),
          "probe_hbm_dma %s" % dma)
    log("  probe_hbm_dma (slopes, 20..120 calls): per-row %.4f ms, per-row "
        "on the run indices %.4f ms, per-run %.4f ms, plain %.4f ms"
        % (dma["per_row_ms"], dma["per_row_runs_ms"], dma["per_run_ms"],
           dma["plain_ms"]))
    for name in probe_bf16_pack.SHAPES:
        r = pack[name]
        log("  probe_bf16_pack %s %s (slopes): packed i32 %.4f ms, native "
            "bf16 %.4f ms, max|diff| %.3e" % (name, r["shape"],
                                               r["packed_ms"],
                                               r["native_bf16_ms"],
                                               r["max_abs_err"]))
    log("  launches in the probes' run: %s" % counts)
    return counts, probe_checks(torch)


def probe_checks(torch):
    """Phase 11's holds and times, outside the counted run: kernel 9 at
    the pool probe's inputs and kernel 10 at the bf16 probe's shapes, each
    against its plain version and bit for bit against its reference
    arithmetic (kernel 1 on the run indices; the r-ordered loop), timed (L2
    flushed) beside its plain version, its library yardstick and its
    bound; kernel 5 on the native bf16 table beside kernel 10. Only the
    wrappers of ``ops/probes.py`` are called, so ``tools/kernel_phases.py``
    runs this on a parent tree too. Returns {entry: {max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by, ...}}."""
    import torch.nn.functional as F

    from lirec_tpu_torch.ops import probes
    from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool
    from lirec_tpu_torch.tools import probe_bf16_pack, probe_hbm_dma

    results = {}
    # kernel 9 at the probe's inputs: against its plain version, and bit
    # for bit against kernel 1 on the explicit rows of each run
    emb, idx, mask = probe_hbm_dma.make_inputs(torch, "cuda")
    run = probe_hbm_dma.run_indices(torch, idx)
    got = probes.run_pool(emb, idx, mask)
    again = probes.run_pool(emb, idx, mask)
    rows = fused_ctx_pool(emb, run, mask, True)
    torch.cuda.synchronize()
    want = probes.run_pool_reference(emb, idx, mask)
    check(got.shape == want.shape and got.dtype == torch.float32,
          "run pool output %s %s" % (tuple(got.shape), got.dtype))
    check(torch.equal(got, rows),
          "run pool: not bitwise kernel 1 on the run indices")
    check(torch.equal(got, again), "run pool: two launches differ")
    err = float((got - want).abs().max())
    check(err <= 1e-5, "run pool disagrees with the plain version")
    # the library yardstick builds the run indices itself: the kernel
    # reads idx[:, 0, :] only
    div = mask.sum(-1, keepdim=True).clamp_min(1.0)

    def library():
        return bag_pool(torch, emb, index_cols(
            probe_hbm_dma.run_indices(torch, idx)), mask, div)

    lib_err = float((library() - got).abs().max())
    log("  run pool (kernel 9): bitwise kernel 1 on the run indices, two "
        "launches equal; max|diff| vs plain %.3e (atol 1e-05), vs 3 x "
        "embedding_bag + tanh %.1e" % (err, lib_err))
    M, R = idx.shape[:2]
    width = emb_width(emb)
    ms = median_ms(torch, lambda: probes.run_pool(emb, idx, mask))
    per_row = median_ms(torch, lambda: fused_ctx_pool(emb, idx, mask, True))
    per_row_runs = median_ms(torch, lambda: fused_ctx_pool(emb, run, mask,
                                                           True))
    plain = median_ms(torch, lambda: probes.run_pool_reference(emb, idx,
                                                                mask))
    lib = median_ms(torch, library)
    # the runs' rows, each read once; the kernel reads idx[:, 0, :] only
    moved = (sum(gathered_bytes(t, run[..., k]) for k, t in enumerate(emb))
             + M * 3 * 4 + nbytes(mask) + M * width * 4)
    b = bound(moved, 2 * M * R * width)
    row_moved = (sum(gathered_bytes(t, idx[..., k])
                     for k, t in enumerate(emb))
                 + nbytes(idx, mask) + M * width * 4)
    row_b = bound(row_moved, 2 * M * R * width)
    log("  run pool kernel %.4f ms, plain %.4f ms, 3 x embedding_bag + tanh "
        "(run indices built inside) %.4f ms; bound %.4f ms (%s, %.1f MB). "
        "Per-row kernel 1 on the run indices %.4f ms, on the random rows "
        "%.4f ms (bound %.4f ms, %.1f MB)"
        % (ms, plain, lib, b["bound_ms"], b["bound_by"], moved / 1e6,
           per_row_runs, per_row, row_b["bound_ms"], row_moved / 1e6))
    results["run_pool"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               library_ms=lib, per_row_ms=per_row,
                               per_row_on_runs_ms=per_row_runs,
                               per_row_bound_ms=row_b["bound_ms"], **b)
    del emb, idx, mask, run, got, again, rows, want

    # kernel 10 at the TPU probe's shapes and the clip table's
    for name, (n, d, m, r) in probe_bf16_pack.SHAPES.items():
        table, pidx, pmask = probe_bf16_pack.make_inputs(torch, "cuda", n, d,
                                                         m, r)
        packed = probes.pack_bf16(table)
        native = table.to(torch.bfloat16)
        unpacked = native.float()
        check(torch.equal(probes.unpack_bf16(packed), native),
              "pack_bf16 %s: does not unpack to the bf16 table" % name)
        got = probes.packed_gather_sum(packed, pidx, pmask)
        torch.cuda.synchronize()
        want = probes.packed_gather_sum_reference(packed, pidx, pmask)
        check(got.shape == (m, d) and got.dtype == torch.float32,
              "packed gather-sum %s output %s" % (name, tuple(got.shape)))
        check(torch.equal(got, masked_sum_loop(torch, unpacked, pidx, pmask)),
              "packed gather-sum %s: not bitwise the r-ordered loop" % name)
        err = float((got - want).abs().max())
        lib_out = F.embedding_bag(pidx, unpacked, per_sample_weights=pmask,
                                  mode="sum")
        lib_err = float((lib_out - got).abs().max())
        log("  packed gather-sum (kernel 10) %s [%d, %d] M=%d: bitwise the "
            "r-ordered loop; max|diff| vs plain %.3e (bound 1e-05), "
            "embedding_bag %.3e" % (name, n, d, m, err, lib_err))
        check(err < 1e-5, "packed gather-sum %s disagrees" % name)
        ms = median_ms(torch, lambda: probes.packed_gather_sum(packed, pidx,
                                                               pmask))
        plain = median_ms(torch, lambda: probes.packed_gather_sum_reference(
            packed, pidx, pmask))
        lib = median_ms(torch, lambda: F.embedding_bag(
            pidx, unpacked, per_sample_weights=pmask, mode="sum"))
        moved = gathered_bytes(packed, pidx) + nbytes(pidx, pmask) + m * d * 4
        b = bound(moved, 2 * m * r * d)
        log("  packed gather-sum %s kernel %.4f ms, plain %.4f ms, "
            "embedding_bag (f32 table) %.4f ms; bound %.4f ms (%s, %.2f MB)"
            % (name, ms, plain, lib, b["bound_ms"], b["bound_by"],
               moved / 1e6))
        results["pack_" + name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       library_ms=lib, **b)
        del table, pidx, pmask, packed, native, unpacked
    # kernel 5 on the native bf16 table of the same values, the other side
    # of the probe's comparison
    gms = masked_sum_probe_checks(torch)
    for name in probe_bf16_pack.SHAPES:
        results["pack_" + name]["native_bf16_ms"] = gms["gms_" + name]["ms"]
    results.update(gms)
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ the training CLI


def train_cli_phase(torch):
    """Phase 12. Returns {kernel name: launches of the training run}."""
    import glob
    import math

    from lirec_tpu_torch.cli import int_rel_ch
    from lirec_tpu_torch.cli import train as train_cli
    from lirec_tpu_torch.checkpoint.saver import load_train_state
    from lirec_tpu_torch.ops import dispatch, scatter_accum
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    def finite(metrics):
        return all(math.isfinite(v) for v in metrics.values())

    with tempfile.TemporaryDirectory() as root:
        with host_clock(torch) as clock:
            write_fixture(root, **PUBLISHED_FIXTURE)
        log("  fixture of published feature widths written in %.1f s"
            % clock.s)
        store = os.path.join(root, "store")
        dims = ["--data-root", root, "--device", "cuda", "--quiet",
                "--text-dim", "768", "--visual-dim", "2048",
                "--text-layers", "12", "--joint-dim", "512"]
        base = dims + ["--store-root", store]

        # ---- the counted run: 3 epochs from the training CLI
        dispatch.reset_launches()
        with host_clock(torch) as clock:
            out = train_cli.main(base + ["--epochs", "3",
                                         "--checkpoint-every", "1"])
        counts = kernel_launches()
        # ---- end of the counted run
        secs = clock.s
        losses = out["train"]["losses"]
        check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
              "training CLI losses %s" % losses)
        scatter = scatter_accum.KERNEL_NAMES[torch.bfloat16]
        pool = KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)]
        check(counts.get(scatter, 0) > 0 and counts.get(pool, 0) > 0,
              "training CLI launches %s: the scatter (steps) and the pool "
              "(cadence eval) must both run" % counts)
        for name in ("index.json", "latest.pth.tar", "2.pth.tar"):
            check(os.path.exists(os.path.join(store, name)),
                  "training CLI wrote no %s" % name)
        with open(os.path.join(store, "index.json")) as f:
            index = json.load(f)
        kept = sorted(glob.glob(os.path.join(store, "*", "*.pth.tar")))
        check(index.get("total") and kept, "no best-n checkpoints: %s"
              % index)
        _, _, epoch = load_train_state(os.path.join(store, "latest.pth.tar"))
        check(epoch == 2, "latest.pth.tar holds epoch %d" % epoch)
        log("  cli.train.main, 3 epochs: losses %s in %.1f s; launches %s; "
            "index.json %s; %d best-n files" % (losses, secs, counts, index,
                                                len(kept)))

        resumed = train_cli.main(base + [
            "--epochs", "4", "--resume-train", "--resume-path",
            os.path.join(store, "latest.pth.tar")])
        r_losses = resumed["train"]["losses"]
        check(resumed["train"]["start_epoch"] == 3 and len(r_losses) == 1
              and math.isfinite(r_losses[0]),
              "resumed training %s" % resumed)
        check(os.path.exists(os.path.join(store, "3.pth.tar")),
              "resumed training wrote no 3.pth.tar")
        log("  --resume-train from latest.pth.tar: epoch 3, loss %s"
            % r_losses)

        # one epoch with the host-loop cadence; its recorded val metrics
        # against the packed sweep's on the same weights (the final state
        # of epoch 0 is what the cadence evaluated)
        host_store = os.path.join(root, "host")
        before = dispatch.decisions("eval_loop")
        host = train_cli.main(dims + ["--store-root", host_store, "--epochs",
                                      "1", "--host-eval"])
        after = dispatch.decisions("eval_loop")
        loops = {p: after.get(p, 0) - before.get(p, 0)
                 for p in ("host", "packed")}
        # one cadence (epoch 0) over train, val and test, all host loops
        check(loops == {"host": 3, "packed": 0},
              "--host-eval cadence ran eval loops %s" % loops)
        check(math.isfinite(host["train"]["losses"][0]),
              "--host-eval training %s" % host)
        with open(os.path.join(host_store, "index.json")) as f:
            host_index = json.load(f)
        swept = int_rel_ch.main(dims + [
            "--store-root", host_store, "--resume-path",
            os.path.join(host_store, "0.pth.tar")])
        check(finite(swept["val"]) and finite(swept["test"]),
              "eval CLI on the host run's checkpoint %s" % swept)
        for key, per_epoch in host_index.items():
            check(abs(per_epoch["0"] - swept["val"][key]) <= 1e-6,
                  "--host-eval cadence %s %r != the packed sweep's %r"
                  % (key, per_epoch["0"], swept["val"][key]))
        log("  --host-eval cadence at epoch 0 (eval loops %s): val %s, equal "
            "to the packed sweep's on the same weights"
            % (loops, {k: v["0"] for k, v in host_index.items()}))

        best = max(glob.glob(os.path.join(store, "total", "*.pth.tar")))
        metrics = int_rel_ch.main(base + ["--resume-path", best])
        check(finite(metrics["val"]) and finite(metrics["test"]),
              "eval CLI on the best checkpoint %s" % metrics)
        log("  cli.int_rel_ch.main on %s: val %s, test %s"
            % (os.path.relpath(best, store), metrics["val"],
               metrics["test"]))
    return counts


# ------------------------------------------------------ the modalities model


class SplitStandIn:
    """What the eval loops read of a dataset, over a materialized split:
    the class counts, a non-train mode, its length and ``materialize``
    (the host loop slices the split as the packed sweep stages it)."""

    def __init__(self, data, n_classes=101, n_rels=16):
        self.data, self.n_classes, self.n_rels = data, n_classes, n_rels
        self.hashidx_rels = None
        self.mode = "test"

    def __len__(self):
        return len(self.data["labels"])

    def materialize(self):
        return self.data


def modalities_split(spec):
    """The eval split's size (EVAL_FULL structured B = 64 batches and an
    EVAL_TAIL-sample tail) in the modalities layout: each sample's GT index triple
    (feat_idx [N, 1, 3], the clip and two track rows of a structured
    sample), its label, multi-label weights, and a soft-label set of the
    label and, for half the samples, one more class (-1 padded)."""
    import numpy as np

    from lirec_tpu_torch.utils.fake_batch import make_structured_batch

    parts = [make_structured_batch(spec, n, N_CLIPS, N_TRACKS,
                                   rels_n_clips=1, seed=1300 + i)
             for i, n in enumerate([EVAL_B] * EVAL_FULL + [EVAL_TAIL])]
    fi = np.concatenate([p["feat_idx"][:, 0, :1, :] for p in parts])
    labels = np.concatenate([p["labels"] for p in parts])
    rng = np.random.default_rng(13)
    soft = np.full((len(labels), spec.n_classes), -1, np.int32)
    soft[:, 0] = labels
    more = rng.random(len(labels)) < 0.5
    soft[more, 1] = rng.integers(0, spec.n_classes, int(more.sum()))
    return {
        "feat_idx": np.ascontiguousarray(fi),
        "labels": labels,
        "multilab_weights": np.concatenate(
            [p["multilab_weights"] for p in parts]),
        "soft_labels": soft,
    }


def check_modalities_predictions(preds, B, label):
    import math

    check(len(preds) == B, "%s: %d predictions for %d samples"
          % (label, len(preds), B))
    for p in preds:
        check(p["best_track"] == 0 and len(p["track_scores"]) == 1,
              "%s: one hypothesis" % label)
        check("relationships" not in p, "%s: relationships" % label)
        check(len(p["interactions"]) == TOPK, "%s: top-k" % label)
        for it in p["interactions"]:
            check(0 <= it["label"] < 101 and math.isfinite(it["score"])
                  and 0 <= it["score"] <= 1, "%s: %r" % (label, it))


@contextmanager
def counted_none(torch, label):
    """A run that must launch no kernel: the counts are set to 0 before
    it and must all still be 0 after it."""
    from lirec_tpu_torch.ops import dispatch

    dispatch.reset_launches()
    yield
    torch.cuda.synchronize()
    counts = kernel_launches()
    check(not any(counts.values()), "%s launched kernels: %s"
          % (label, counts))


def modalities_phase(torch, root, card):
    """Phase 13. Returns {"latency_ms": {compute_B: ms}, "step_ms":
    {compute: ms}, "eval_clips_per_s": {compute: clips/s}}."""
    import math

    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.cli import common
    from lirec_tpu_torch.cli import modalities as modalities_cli
    from lirec_tpu_torch.cli.serve import InferenceEngine
    from lirec_tpu_torch.data.localize import Localizer
    from lirec_tpu_torch.evaluation import packed, runner
    from lirec_tpu_torch.evaluation.metrics import _sigmoid
    from lirec_tpu_torch.models import tabular
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.train.loop import make_train_step
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    out = {"latency_ms": {}, "step_ms": {}, "eval_clips_per_s": {}}
    tables = data = None
    for compute in ("bfloat16", "float32"):
        cfg = config_lib.preset("modalities").with_runtime(
            compute_dtype=compute).with_optim(batch_size=EVAL_B,
                                              dropout=0.5)
        bundle = create_model(cfg, 101, seed=0, device=DEV)
        spec = bundle.spec
        check((spec.text_dim, spec.visual_dim, spec.track_dim,
               spec.joint_dim, spec.n_classes, spec.modality, spec.tracks)
              == (768, 2048, 2048, 512, 101, "m", True),
              "modalities published widths: %s" % (spec,))
        if tables is None:
            tables = make_tables(spec, N_CLIPS, N_TRACKS, seed=0)
            data = modalities_split(spec)
        dev_tables = {k: torch.from_numpy(v).to(DEV)
                      for k, v in tables.items()}

        # serving: /predict at B = 1 and 64
        engine = InferenceEngine(bundle, tables, device=DEV, topk=TOPK,
                                 max_batch=64)
        with counted_none(torch, "modalities /predict"):
            with serving(engine) as base:
                for B, reps in ((1, 10), (64, 5)):
                    fi = data["feat_idx"][:B]
                    payload = {"samples": [{"feat_idx": f.tolist()}
                                           for f in fi]}
                    answers = []
                    times = host_ms(torch, lambda _: answers.append(
                        http(base + "/predict", payload)), 1 + reps)
                    for status, res in answers:
                        check(status == 200, "modalities %s B=%d: %s %s"
                              % (compute, B, status, res))
                        check_modalities_predictions(
                            res["predictions"], B,
                            "modalities %s B=%d" % (compute, B))
                    with torch.inference_mode():
                        logits = tabular.modalities_tabular(
                            bundle.model, spec, dev_tables,
                            torch.from_numpy(fi).to(DEV))["inters"]
                    s = _sigmoid(logits.cpu().numpy().astype(np.float64))
                    got = np.array([p["track_scores"][0]
                                    for p in res["predictions"]])
                    check(np.abs(got - s.max(axis=-1)).max() < 1e-5,
                          "modalities %s B=%d: served scores differ from "
                          "the forward over the raw tables" % (compute, B))
                    key = "%s_B%d" % (compute, B)
                    out["latency_ms"][key] = statistics.median(times[1:])
                    log("  modalities %s /predict B=%-2d median %.2f ms over "
                        "%d requests (%s)" % (compute, B,
                                              out["latency_ms"][key], reps,
                                              card))
        del engine

        # 10 hybrid train steps, B = 64, dropout 0.5, localized batches
        raw = [{k: v[i * TRAIN_B:(i + 1) * TRAIN_B]
                for k, v in data.items() if k != "soft_labels"}
               for i in range(TRAIN_STEPS)]
        batches = Localizer(spec, N_CLIPS, N_TRACKS).maybe_localize(raw)
        before = {n: p.detach().clone()
                  for n, p in bundle.model.named_parameters()}
        opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                             cfg.optim.weight_decay)
        step = make_train_step(bundle, opt)
        with counted_none(torch, "modalities training"):
            losses, times = timed_steps(torch, step, batches, dev_tables, DEV)
        check(all(math.isfinite(x) for x in losses),
              "modalities %s losses %s" % (compute, losses))
        for n, p in bundle.model.named_parameters():
            check(not torch.equal(p.detach(), before[n]),
                  "modalities %s: parameter %s did not move" % (compute, n))
        out["step_ms"][compute] = statistics.median(times[1:])
        log("  modalities %s: %d train steps (B=%d, dropout 0.5, localized "
            "%s), losses %.4f .. %.4f; median %.2f ms/step, %.0f clips/s "
            "(%s)" % (compute, len(batches), TRAIN_B,
                      "uniq_clip" in batches[0], losses[0], losses[-1],
                      out["step_ms"][compute],
                      TRAIN_B / out["step_ms"][compute] * 1e3, card))
        del opt, step, before

        # the eval sweep over the split and the --host-eval loop (of the
        # trained weights): the same counters
        counters = {}

        def capture(module, key):
            orig = module.summarize_metrics

            def wrapped(t, prec, prec_rels, avg_loss, *args, **kw):
                counters[key] = ({k: v for k, v in vars(prec).items()
                                  if isinstance(v, (int, np.integer))},
                                 avg_loss)
                return orig(t, prec, prec_rels, avg_loss, *args, **kw)
            return orig, wrapped

        saved = {}
        for module, key in ((packed, "packed"), (runner, "host")):
            saved[module], wrapped = capture(module, key)
            module.summarize_metrics = wrapped
        try:
            stand_in = SplitStandIn(data)
            with counted_none(torch, "modalities eval"):
                swept = packed.evaluate_packed(
                    stand_in, bundle, bundle.model, cfg, mode="test",
                    verbose=False, data=data, tables=tables)
                with host_clock(torch) as clock:
                    host = runner.evaluate(stand_in, bundle, bundle.model,
                                           cfg, mode="test", tables=tables,
                                           verbose=False)
                host_s = clock.s
                secs = [ms / 1e3 for ms in host_ms(
                    torch, lambda _: packed.evaluate_packed(
                        stand_in, bundle, bundle.model, cfg, mode="test",
                        verbose=False, data=data, tables=tables), 3)]
        finally:
            for module, orig in saved.items():
                module.summarize_metrics = orig
        (c_packed, l_packed), (c_host, l_host) = (counters["packed"],
                                                  counters["host"])
        check(c_packed == c_host and c_packed["total"] == len(stand_in),
              "modalities %s: sweep counters %s != --host-eval's %s"
              % (compute, c_packed, c_host))
        check(abs(l_packed - l_host) <= 1e-5 * abs(l_host),
              "modalities %s: sweep loss %r, host %r" % (compute, l_packed,
                                                         l_host))
        check(all(math.isfinite(v) for v in swept.values()),
              "modalities %s metrics %s" % (compute, swept))
        rate = len(stand_in) / statistics.median(secs)
        out["eval_clips_per_s"][compute] = rate
        log("  modalities %s eval sweep over %d samples: counters %s equal "
            "to --host-eval's, loss %.6f / %.6f; median %.4f s (%.0f "
            "clips/s; host loop %.3f s) (%s)" % (
                compute, len(stand_in), c_packed, l_packed, l_host,
                statistics.median(secs), rate, host_s, card))
        del bundle, dev_tables
        torch.cuda.empty_cache()

    # the CLI on the fixture: eval of a seeded .pth.tar, then --train
    dims = ["--data-root", root, "--device", DEV, "--quiet",
            "--text-dim", "768", "--visual-dim", "2048",
            "--text-layers", "12", "--joint-dim", "512", "--batch-size", "8"]
    ckpt = os.path.join(root, "modalities.pth.tar")
    cfg = common.config_from_args(
        "modalities", common.build_parser("modalities").parse_args(dims))
    train_ds, _, _ = common.build_datasets(cfg, "modalities")
    torch.save({"state_dict": create_model(
        cfg, train_ds.n_classes, seed=0, device="cpu").model.state_dict()},
        ckpt)
    with counted_none(torch, "the modalities CLI"):
        metrics = modalities_cli.main(dims + ["--resume-path", ckpt])
        trained = modalities_cli.main(dims + [
            "--train", "--epochs", "2", "--store-root",
            os.path.join(root, "mod_store")])
    for split in ("val", "test"):
        check(all(math.isfinite(v) for v in metrics[split].values()),
              "modalities CLI %s metrics %s" % (split, metrics[split]))
    losses = trained["train"]["losses"]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          "modalities CLI --train losses %s" % losses)
    log("  cli.modalities.main: val %s, test %s; --train 2 epochs losses %s"
        % (metrics["val"], metrics["test"], losses))
    return out


# ------------------------------------------------------- the rels-only eval


class RelsStandIn:
    """A split of (pair, relationship) items at split scale, as
    ``evaluate_rels_only`` reads a dataset in ``test_rels_multi_clip``
    mode: for every bucket (2 .. 64 clips), B + RELS_TAIL items with L in
    (bucket / 2, bucket] clips of random rows, so that each bucket
    flushes once full and once with fewer rows, and one more item for
    each clip count in `extra` (phase 23(d)'s pairs past 2,048 clips);
    shuffled."""

    def __init__(self, spec, tables, seed=14, extra=()):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.n_rels = 16
        self.test_rels_multi_clip = False
        self.tables = types.SimpleNamespace(as_dict=lambda: tables)
        self.items = []

        def item(L):
            fi = np.stack([rng.integers(0, N_CLIPS, L + 1),
                           rng.integers(0, N_TRACKS, L + 1),
                           rng.integers(0, N_TRACKS, L + 1)],
                          axis=-1).astype(np.int32)
            mask = (rng.random((L, 1)) < 0.9).astype(np.int32)
            mask[0] = 1
            return {"feat_idx": fi, "rels_mask": mask,
                    "rels_label": int(rng.integers(0, 15))}

        for p in RELS_BUCKETS:
            for L in rng.integers(max(1, p // 2 + 1), p + 1,
                                  EVAL_B + RELS_TAIL):
                self.items.append(item(L))
        self.items += [item(L) for L in extra]
        rng.shuffle(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        check(self.test_rels_multi_clip, "rels-only item outside the mode")
        return self.items[i]


def rels_flushes(lengths, B):
    """How many flushes evaluate_rels_only makes for items of these clip
    counts: per bucket, one per B items and one for the rest."""
    per = {}
    for L in lengths:
        p = 1 << max(1, L - 1).bit_length()
        per[p] = per.get(p, 0) + 1
    return sum(-(-n // B) for n in per.values()), sorted(per)


def rels_only_phase(torch, root, card):
    """Phase 14. Returns ({kernel name: launches of the stand-in's
    counted runs}, {kernel name: entry of the per-bucket holds and
    times})."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.dataset import InteractionDataset, first_choice
    from lirec_tpu_torch.data import synthetic
    from lirec_tpu_torch.evaluation.runner import evaluate_rels_only
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.utils.fake_batch import make_tables

    base = synthetic.make_config(root, synthetic.SyntheticSpec(
        **PUBLISHED_FIXTURE))
    dims = dataclasses.replace(base.dims, joint_dim=512)
    counts = {}
    tables = None
    for compute in ("bfloat16", "float32"):
        dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        # the int_rels fixture at published feature widths
        cfg = config_lib.preset("int_rels", data_root=root).replace(
            dims=dims, paths=base.paths).with_runtime(compute_dtype=compute)
        ds = InteractionDataset(cfg, mode="val", label_chooser=first_choice)
        ds.cache()
        ds.init_relships()
        bundle = create_model(cfg, ds.n_classes, n_rels=ds.n_rels - 1,
                              seed=0, device=DEV)
        check((bundle.spec.text_dim, bundle.spec.visual_dim,
               bundle.spec.joint_dim) == (768, 2048, 512),
              "int_rels fixture widths %s" % (bundle.spec,))
        ds.test_rels_multi_clip = True
        lengths = [ds[i]["feat_idx"].shape[0] - 1 for i in range(len(ds))]
        ds.test_rels_multi_clip = False
        flushes, pads = rels_flushes(lengths, EVAL_B)
        dispatch.reset_launches()
        got = evaluate_rels_only(ds, bundle, bundle.model, cfg,
                                 verbose=False, batch_size=EVAL_B)
        torch.cuda.synchronize()
        launched = kernel_launches()
        plain = evaluate_rels_only(ds, bundle, bundle.model, cfg,
                                   verbose=False, batch_size=EVAL_B,
                                   use_kernel=False)
        check(launched == {name: flushes}, "fixture rels-only %s launched "
              "%s, want %d of %s" % (compute, launched, flushes, name))
        check(got == plain, "fixture rels-only %s: kernel %s != plain %s"
              % (compute, got, plain))
        check(ds.test_rels_multi_clip is False, "mode not restored")
        log("  int_rels fixture (%d pairs, L up to %d, buckets %s), %s: %s, "
            "equal to the plain pool's; %d launches of %s"
            % (len(ds), max(lengths), pads, compute, got, flushes, name))

        # the split-scale stand-in at published widths: every bucket
        cfg = config_lib.preset("int_rels").with_runtime(
            compute_dtype=compute)
        bundle = create_model(cfg, 101, n_rels=15, seed=0, device=DEV)
        if tables is None:
            tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
            stand_in = RelsStandIn(bundle.spec, tables)
            s_lengths = [it["feat_idx"].shape[0] - 1
                         for it in stand_in.items]
            s_flushes, s_pads = rels_flushes(s_lengths, EVAL_B)
        # ---- the counted run: the rels-only eval of the stand-in
        dispatch.reset_launches()
        with host_clock(torch) as clock:
            got = evaluate_rels_only(stand_in, bundle, bundle.model, cfg,
                                     verbose=False, batch_size=EVAL_B)
        secs = clock.s
        launched = kernel_launches()
        # ---- end of the counted run
        plain = evaluate_rels_only(stand_in, bundle, bundle.model, cfg,
                                   verbose=False, batch_size=EVAL_B,
                                   use_kernel=False)
        check(launched == {name: s_flushes}, "stand-in rels-only %s "
              "launched %s, want %d of %s" % (compute, launched, s_flushes,
                                              name))
        check(got == plain, "stand-in rels-only %s: kernel %s != plain %s"
              % (compute, got, plain))
        counts[name] = launched.get(name, 0)
        log("  stand-in (%d pairs, L up to %d, buckets %s, %dx%d tables), "
            "%s: %s, equal to the plain pool's; %d launches of %s; %.3f s "
            "(%.0f pairs/s, embed included) (%s)"
            % (len(stand_in), max(s_lengths), s_pads, N_CLIPS, N_TRACKS,
               compute, got, counts[name], name, secs,
               len(stand_in) / secs, card))
        del bundle
        torch.cuda.empty_cache()
    return counts, rels_only_pool_checks(torch)


def rels_only_pool_checks(torch):
    """Phase 14's holds and times of kernels 1-2 at the rels-only
    buckets' shapes: M = 64 pair rows, R = the bucket, split-scale
    embedded tables (1024 / 256 wide), clip counts in (R / 2, R] padded
    with weight 0, the eval's unguarded divide; once full and once as a
    last flush of RELS_TAIL rows (the rest all-masked, NaN in both
    versions). Timed (L2 flushed) beside the plain version, three
    ``embedding_bag`` sums and the bound. Returns {kernel name: entry
    with the sums over the buckets and a "buckets" table}."""
    import numpy as np

    from lirec_tpu_torch.models.tabular import EmbeddedTables
    from lirec_tpu_torch.ops.gather_pool import (
        KERNEL_NAMES, fused_ctx_pool, fused_ctx_pool_reference,
    )

    atol = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=DEV).manual_seed(21)
        emb = EmbeddedTables(*(
            torch.randn(n, d, device=DEV, generator=g).to(dtype)
            for n, d in ((N_CLIPS, 1024), (N_TRACKS, 256), (N_TRACKS, 256))))
        buckets = {}
        for R in RELS_BUCKETS:
            idx = torch.stack(
                [torch.randint(0, n, (EVAL_B, R), device=DEV, generator=g)
                 for n in (N_CLIPS, N_TRACKS, N_TRACKS)], dim=-1
            ).to(torch.int32)
            lengths = np.random.default_rng(R).integers(
                max(1, R // 2 + 1), R + 1, EVAL_B)
            mask = torch.zeros(EVAL_B, R, device=DEV)
            for m, L in enumerate(lengths):
                mask[m, :L] = 1.0
            idx[mask == 0] = 0  # pad clips are row 0, weight 0
            idx = idx.contiguous()
            errs = []
            for n in (EVAL_B, RELS_TAIL):
                m = mask.clone()
                m[n:] = 0.0  # the rows past a last flush: all-masked
                got = fused_ctx_pool(emb, idx, m, False)
                torch.cuda.synchronize()
                want = fused_ctx_pool_reference(emb, idx, m, False)
                nan = want.isnan()
                check(torch.equal(got.isnan(), nan)
                      and bool(nan[n:].all()) and not bool(nan[:n].any()),
                      "rels-only pool R=%d n=%d: NaN rows" % (R, n))
                errs.append(float((got - want).abs()[~nan].max()))
            err = max(errs)
            check(err <= atol[dtype], "rels-only pool %s R=%d disagrees "
                  "with the plain version: %.3e" % (dtype, R, err))
            ms = median_ms(torch, lambda: fused_ctx_pool(emb, idx, mask,
                                                         False))
            plain = median_ms(torch, lambda: fused_ctx_pool_reference(
                emb, idx, mask, False))
            cols, w = index_cols(idx), mask.to(dtype)
            div = mask.sum(-1, keepdim=True)
            lib = median_ms(torch, lambda: bag_pool(torch, emb, cols, w, div))
            moved = (sum(gathered_bytes(t, idx[..., k])
                         for k, t in enumerate(emb))
                     + nbytes(idx, mask) + EVAL_B * emb_width(emb) * 4)
            flops = 2 * EVAL_B * R * emb_width(emb)
            b = bound(moved, flops)
            buckets[R] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              library_ms=lib, moved=moved, flops=flops, **b)
            log("  rels-only pool %-4s M=%d R=%-2d: max|diff| vs plain "
                "%.3e (atol %.0e, full and n=%d flushes); kernel %.4f ms, "
                "plain %.4f ms, 3 x embedding_bag + tanh %.4f ms; bound "
                "%.4f ms (%s, %.2f MB)" % (
                    str(dtype).split(".")[1], EVAL_B, R, err, atol[dtype],
                    RELS_TAIL, ms, plain, lib, b["bound_ms"], b["bound_by"],
                    moved / 1e6))
            del idx, mask, cols, w, div
        total = bound(sum(v.pop("moved") for v in buckets.values()),
                      sum(v.pop("flops") for v in buckets.values()))
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        results[name] = dict(
            max_abs_err=max(v["max_abs_err"] for v in buckets.values()),
            **{k: sum(v[k] for v in buckets.values())
               for k in ("ms", "plain_ms", "library_ms")},
            **total, buckets=buckets)
        del emb
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ the text-only CLI


def text_only_phase(torch, root):
    """Phase 15: the text-only CLI on the fixture, on the card: 2 epochs
    of training, then the eval of its own checkpoint; no kernel runs."""
    import math

    from lirec_tpu_torch.cli import text_only

    store = os.path.join(root, "store_text")
    args = ["--data-root", root, "--store-root", store, "--device", DEV,
            "--quiet", "--text-dim", "768", "--text-layers", "12",
            "--joint-dim", "512", "--batch-size", "8"]
    with counted_none(torch, "the text-only CLI"):
        with host_clock(torch) as clock:
            trained = text_only.main(args + ["--train", "--epochs", "2"])
        train_s = clock.s
        metrics = text_only.main(args + ["--resume-path",
                                         os.path.join(store, "1.pth.tar")])
    losses = trained["train"]["losses"]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          "text-only CLI losses %s" % losses)
    for split in ("val", "test"):
        check(all(math.isfinite(v) for v in metrics[split].values()),
              "text-only CLI %s metrics %s" % (split, metrics[split]))
    log("  cli.text_only.main --train 2 epochs: losses %s (%.1f s); eval of "
        "its 1.pth.tar: val %s, test %s" % (losses, train_s, metrics["val"],
                                            metrics["test"]))



# ------------------------------------------------------ data parallelism


def compute_mode():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no compute mode")
    return out[0]


def dist_phase(torch, local, train_finals, step_ms, eval_ref):
    """Phase 16: (a) a world of one over NCCL in this process: the sweep
    of phase 9's split and phase 7's 10 steps through the data-parallel
    paths, bitwise phase 9's carries and phase 7's losses and parameters,
    ms/step beside phase 7's; (b) two ranks sharing the one card over
    gloo (parallel/dist.spawn, tools/dist_check.rank_run): the sweep split
    between them, its all-reduced counters equal to phase 9's and its float
    sums within rtol 2e-6, and DIST_STEPS deterministic f32 steps whose
    losses and gradients are within rtol 1e-5 of one process's at the
    same parameters (the gradients without the rows where a decision of
    the forward sits on a tie and the two sides took different branches:
    those are counted and shown), and whose losses are within rtol 1e-5
    of one process's own steps (the parameters after Adam are reported).
    Both sides take the product's Adam, capturable. Returns ({kernel name:
    launches in (a)'s counted runs}, [each rank's launch counts])."""
    import numpy as np

    import torch.distributed

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.data.pipeline import local_batch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES as SCATTER
    from lirec_tpu_torch.ops.scatter_accum import SORT_NAME
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.mesh import Mesh2D
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.tools import dist_check
    from lirec_tpu_torch.train.loop import (
        _to_device, make_train_step, step_generators, train_loss,
    )
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    mode = compute_mode()
    log("  compute mode: %s; %d card(s) visible" % (
        mode, torch.cuda.device_count()))
    check(mode not in ("Exclusive_Process", "Prohibited"),
          "compute mode %s: two processes cannot share the card" % mode)
    cfg = config_lib.preset("int_rel_ch")
    split = eval_ref["split"]
    host_tables = dev_tables = None
    counts, graph = {}, {"launches": {}}
    with tempfile.TemporaryDirectory() as work:
        dist.initialize_distributed("file://" + os.path.join(work, "nccl1"),
                                    1, 0, "cuda")
        try:
            check(torch.distributed.get_backend() == "nccl", "backend %s"
                  % torch.distributed.get_backend())
            mesh = dist.make_mesh((1, 1))
            for compute in ("bfloat16", "float32"):
                dtype = torch.bfloat16 if compute == "bfloat16" else \
                    torch.float32
                ccfg = cfg.with_runtime(compute_dtype=compute)
                bundle = create_model(ccfg, 101, n_rels=15, seed=0,
                                      device="cuda")
                if host_tables is None:
                    host_tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS,
                                              seed=0)
                    dev_tables = {k: torch.from_numpy(v).cuda()
                                  for k, v in host_tables.items()}
                pool = KERNEL_NAMES[("fused_ctx_pool", dtype)]
                # ---- counted run: the sweep over a world of one
                dispatch.reset_launches()
                carry = packed.sweep_carry(
                    split_stand_in(), bundle, bundle.model,
                    ccfg.with_optim(batch_size=EVAL_B), mode="test",
                    data=split, tables=host_tables, localize_ctx=False,
                    mesh=mesh)
                torch.cuda.synchronize()
                swept = kernel_launches()
                # ---- end of the counted run
                want = eval_ref["carries"][compute]
                check(set(carry) == set(want), "carry keys")
                for key, v in want.items():
                    check(np.array_equal(carry[key], v), "%s: the world-of-"
                          "one sweep's %s differs from phase 9's"
                          % (compute, key))
                counts[pool] = swept.get(pool, 0)
                check(counts[pool] == EVAL_FULL + 1,
                      "%s: world-of-one sweep launched %s" % (compute, swept))
                opt = make_optimizer(bundle.model.parameters(),
                                     cfg.optim.lr, cfg.optim.weight_decay)
                step = make_dp_train_step(bundle, opt, mesh, TRAIN_B)
                scatter = SCATTER[dtype]
                # ---- counted run: phase 7's steps over a world of one
                dispatch.reset_launches()
                losses, times = timed_steps(torch, step, local, dev_tables)
                stepped = kernel_launches()
                # ---- end of the counted run
                want_losses, want_params = train_finals[compute]
                check(losses == want_losses, "%s: world-of-one losses %s, "
                      "phase 7's %s" % (compute, losses, want_losses))
                for n, p in bundle.model.named_parameters():
                    check(torch.equal(p.detach().cpu(), want_params[n]),
                          "%s: world-of-one parameter %s differs from "
                          "phase 7's" % (compute, n))
                counts[scatter] = stepped.get(scatter, 0)
                counts[SORT_NAME] = (counts.get(SORT_NAME, 0)
                                     + stepped.get(SORT_NAME, 0))
                check(counts[scatter] == len(local)
                      and stepped.get(SORT_NAME, 0) == len(local),
                      "%s: world-of-one steps launched %s" % (compute,
                                                              stepped))
                ms = statistics.median(times[1:])
                log("  (a) NCCL world of one, %s: sweep carry bitwise phase "
                    "9's (%d launches of %s); %d eager mesh steps bitwise "
                    "phase 7's (%d launches of %s): median %.2f ms/step "
                    "against phase 7's %.2f ms (the mesh step's overhead "
                    "%+.2f ms)" % (
                        compute, counts[pool], pool, len(local),
                        counts[scatter], scatter, ms, step_ms[compute],
                        ms - step_ms[compute]))
                del bundle, opt, step
                graph[compute] = mesh_graph_steps(
                    torch, ccfg, mesh, local, dev_tables, losses,
                    want_params, scatter, graph["launches"])
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()

        # (b) two ranks on the one card over gloo
        job = {"split": os.path.join(work, "split.pt"),
               "batches": os.path.join(work, "batches.pt"),
               "device": "cuda", "preset": "int_rel_ch", "n_classes": 101,
               "n_rels": 15,
               "seed": 0, "n_clips": N_CLIPS, "n_tracks": N_TRACKS,
               "eval_b": EVAL_B, "train_b": TRAIN_B}
        torch.save(split, job["split"])
        torch.save(local[:DIST_STEPS], job["batches"])
        with host_clock(torch) as clock:
            ranks = dist.spawn(dist_check.rank_run, 2, devices="cuda",
                               backend="gloo", timeout=DIST_TIMEOUT,
                               args=(job,), workdir=work)
        wall = clock.s
    fcfg = cfg.with_runtime(compute_dtype="float32")
    bundle = create_model(fcfg, 101, n_rels=15, seed=0, device="cuda")
    opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                         cfg.optim.weight_decay)
    step = make_train_step(bundle, opt, deterministic=True)
    want_losses = [float(step(batch, dev_tables,
                              step_generators(0, i, "cuda")))
                   for i, batch in enumerate(local[:DIST_STEPS])]
    want_params = {n: p.detach().to("cpu", copy=True)
                   for n, p in bundle.model.named_parameters()}
    lead = ranks[0].value
    check(all(r.value["params_sum"] == lead["params_sum"] for r in ranks),
          "the ranks' parameters differ: sums %s"
          % [r.value["params_sum"] for r in ranks])
    # each step: its all-reduced gradient against the one-process
    # gradient at the same parameters (the ones that step started from),
    # within rtol 1e-5 of each tensor's scale, and its loss. The rows of
    # the batch where one of the forward's decisions (a relu, an argmax,
    # an amax) differs between the whole batch's forward and the ranks'
    # halves' are taken out of both gradients and counted; every such
    # decision must sit within TIE_RTOL of its tie, and none may be one
    # that no row owns (tools/dist_check.py)
    grad_raw = grad_worst = 0.0
    for i, batch in enumerate(local[:DIST_STEPS]):
        with torch.no_grad():
            for n, p in bundle.model.named_parameters():
                p.copy_(lead["before"][i][n])
        bundle.model.zero_grad(set_to_none=True)
        whole = _to_device(batch, "cuda")
        gens = lambda: step_generators(0, i, "cuda")  # noqa: E731
        with dist_check.DecisionRecorder() as rec:
            loss = train_loss(bundle, whole, dev_tables, gens(),
                              deterministic=True)
        loss.backward()
        loss = float(loss.detach())
        check(abs(loss - lead["losses"][i]) <= 1e-5 * abs(loss),
              "step %d: loss %s, one process at the same parameters %s"
              % (i, lead["losses"][i], loss))
        grads = {n: p.grad.detach().cpu()
                 for n, p in bundle.model.named_parameters()}
        halves, blocks = [], []
        for r in range(2):
            half = _to_device(local_batch(batch, Mesh2D(2, r)),
                              "cuda")
            with torch.no_grad(), dist_check.DecisionRecorder() as hrec:
                train_loss(bundle, half, dev_tables, gens(),
                           deterministic=True)
            halves.append(half)
            blocks.append(hrec.calls)
        n = len(batch["labels"])
        tied = dist_check.tied_rows(rec.calls, blocks, n)
        del rec, blocks
        check(tied["shared"] == 0, "step %d: %d differing decisions belong "
              "to no row of the batch: %s" % (i, tied["shared"],
                                              tied["ties"]))
        check(tied["worst_gap"] <= TIE_RTOL, "step %d: a decision of the "
              "ranks' forward and one process's differs %.3e of its "
              "input's scale from a tie: %s" % (i, tied["worst_gap"],
                                                tied["ties"]))
        held = {k: lead["grads"][i][k] - g for k, g in grads.items()}
        for row in tied["rows"]:
            r, local_row = divmod(row, n // 2)
            mine = dist_check.row_gradient(bundle, whole, dev_tables,
                                           gens(), row)
            theirs = dist_check.row_gradient(bundle, halves[r], dev_tables,
                                             gens(), local_row, count=n)
            for k in held:
                held[k] += mine[k] - theirs[k]
        step_raw = step_held = 0.0
        for k, g in grads.items():
            scale = float(g.abs().max()) or 1.0
            step_raw = max(step_raw, float(
                (lead["grads"][i][k] - g).abs().max()) / scale)
            err = float(held[k].abs().max()) / scale
            step_held = max(step_held, err)
            check(err <= 1e-5, "step %d: gradient %s differs from one "
                  "process's at the same parameters by %.3e of its scale, "
                  "without the %d rows of differing decisions %s"
                  % (i, k, err, len(tied["rows"]), tied["rows"]))
        grad_raw, grad_worst = max(grad_raw, step_raw), max(grad_worst,
                                                            step_held)
        log("  (b) step %d: %d decisions of the whole batch's forward differ "
            "from the halves' (worst %.3e of its input's scale from its "
            "tie; %s), in rows %s; the gradient %.3e of scale from the "
            "ranks', %.3e without those rows" % (
                i, tied["differing"], tied["worst_gap"], tied["ties"],
                tied["rows"], step_raw, step_held))
    # the parameters after Adam: reported (see tools/dist_check.py)
    param_worst, param_beyond, n_elems = 0.0, 0, 0
    for n, p in want_params.items():
        d = (lead["params"][n] - p).abs().double()
        scale = float(p.abs().max()) or 1.0
        param_worst = max(param_worst, float(d.max()) / scale)
        param_beyond += int((d > 1e-5 * (p.abs().double() + scale)).sum())
        n_elems += p.numel()
    rank_launches = []
    for r, result in enumerate(ranks):
        out = result.value
        for compute, carry in out["carries"].items():
            want = eval_ref["carries"][compute]
            for key, v in want.items():
                if v.dtype.kind == "f":
                    check(np.allclose(carry[key], v, rtol=2e-6, atol=0),
                          "rank %d %s: %s %s against phase 9's %s"
                          % (r, compute, key, carry[key], v))
                else:
                    check(np.array_equal(carry[key], v), "rank %d %s: "
                          "counter %s %s against phase 9's %s"
                          % (r, compute, key, carry[key], v))
        check(np.allclose(out["losses"], want_losses, rtol=1e-5, atol=0),
              "rank %d: losses %s, one process %s" % (r, out["losses"],
                                                      want_losses))
        launched = dict(result.launches)
        for dtype in (torch.float32, torch.bfloat16):
            name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
            check(launched.get(name, 0) > 0, "rank %d launched no %s"
                  % (r, name))
        check(launched.get(SCATTER[torch.float32], 0) == DIST_STEPS,
              "rank %d: %d steps, launches %s" % (r, DIST_STEPS, launched))
        rank_launches.append(launched)
        log("  (b) gloo rank %d of 2 on the one card: sweep %.3f s (bf16) / "
            "%.3f s (f32) for its block, all-reduced counters equal phase "
            "9's, loss sums %.6e / %.6e against %.6e / %.6e (rtol 2e-6); "
            "%d deterministic f32 steps: losses %s (one process %s); "
            "launches %s" % (
                r, out["sweep_s"]["bfloat16"], out["sweep_s"]["float32"],
                float(out["carries"]["bfloat16"]["loss_sum"]),
                float(out["carries"]["float32"]["loss_sum"]),
                float(eval_ref["carries"]["bfloat16"]["loss_sum"]),
                float(eval_ref["carries"]["float32"]["loss_sum"]),
                DIST_STEPS, out["losses"], want_losses, launched))
    log("  (b) each step's gradient against one process's at the same "
        "parameters: worst |diff| / scale %.3e over all rows, %.3e without "
        "the rows of differing decisions (bound 1e-5); the parameters "
        "after %d Adam steps against one process's: worst |diff| / scale "
        "%.3e, %d of %d elements beyond rtol 1e-5 (reported, not held)"
        % (grad_raw, grad_worst, DIST_STEPS, param_worst, param_beyond,
           n_elems))
    log("  (b) two ranks: %.1f s from spawn to join" % wall)
    del bundle, opt, step
    torch.cuda.empty_cache()
    return counts, rank_launches, graph


def mesh_graph_steps(torch, ccfg, mesh, batches, tables, eager_losses,
                     want_params, scatter, launches):
    """Phase 16(a)'s graph: phase 7's steps through the epoch sweep over
    the world of one's NCCL mesh (the counted run: the step captured once,
    then replayed), bitwise the eager mesh steps' losses and phase 7's
    parameters, "graph" recorded for "cuda: nccl mesh", one sort and one
    scatter a replay (added to `launches`); then epochs of graph replays and of the
    same step run eagerly in turns on its model. Returns {ms/step lists,
    capture ms}."""
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import SORT_NAME
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.train.sweep import EpochSweep

    compute = ccfg.runtime.compute_dtype
    bundle = create_model(ccfg, 101, n_rels=15, seed=0, device="cuda")
    opt = make_optimizer(bundle.model.parameters(), ccfg.optim.lr,
                         ccfg.optim.weight_decay)
    sweep = EpochSweep(bundle, opt, tables, 0, TRAIN_B, mesh=mesh,
                       require_graph=True)
    torch.cuda.synchronize()
    # ---- counted run: phase 7's steps as graph replays over the mesh
    dispatch.reset_launches()
    losses = sweep.fetch(sweep.run(batches, 0))
    torch.cuda.synchronize()
    replayed = kernel_launches()
    # ---- end of the counted run
    last = dispatch.last_dispatch("train_loop")
    check((last["path"], last["reason"]) == ("graph", "cuda: nccl mesh"),
          "%s: the mesh sweep recorded %s" % (compute, last))
    check(losses == eager_losses, "%s: the mesh graph's losses %s, the "
          "eager mesh steps' %s" % (compute, losses, eager_losses))
    for n, p in bundle.model.named_parameters():
        check(torch.equal(p.detach().cpu(), want_params[n]),
              "%s: the mesh graph's parameter %s differs from phase 7's"
              % (compute, n))
    check(replayed == {scatter: len(batches), SORT_NAME: len(batches)},
          "%s: the mesh graph launched %s for %d steps" % (
              compute, replayed, len(batches)))
    launches[scatter] = replayed[scatter]
    launches[SORT_NAME] = launches.get(SORT_NAME, 0) + replayed[SORT_NAME]
    times = epochs_in_turns(torch, SWEEP_TURNS, sweep, sweep.step, batches,
                            tables, "%s mesh" % compute)
    check(len(sweep.capture_s) == 1, "%s: %d mesh captures for one batch "
          "shape" % (compute, len(sweep.capture_s)))
    log("  (a) NCCL world of one, %s: %d steps as graph replays of the mesh "
        "step (\"graph\", \"cuda: nccl mesh\"), bitwise the eager mesh "
        "steps' losses and phase 7's parameters; %d launches of %s; "
        "ms/step graph %s, eager %s (turns %s); capture %.1f ms" % (
            compute, len(batches), replayed[scatter], scatter,
            ["%.3f" % x for x in times["graph"]],
            ["%.3f" % x for x in times["eager"]], ",".join(SWEEP_TURNS),
            sweep.capture_s[0] * 1e3))
    out = dict(graph_ms_per_step=times["graph"],
               eager_ms_per_step=times["eager"],
               capture_ms=sweep.capture_s[0] * 1e3)
    del bundle, opt, sweep
    return out


# ------------------------------------------ phase 20: the model and context axes


def mesh_rank_checks(torch, label, ranks, shape, eval_ref, step_ms,
                     train_finals):
    """Phase 20(a)/(b): hold each rank's result of tools/dist_check.rank_run
    on a `shape` mesh. Returns {"launches": {kernel: sum over the ranks
    of the sweeps' and steps' launches}, "ms": {compute: median ms/step
    of rank 0}}."""
    import numpy as np

    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES as SCATTER

    D, M = shape
    check(sorted(r.value["place"] for r in ranks)
          == [(d, m) for d in range(D) for m in range(M)],
          "%s: places %s" % (label, [r.value["place"] for r in ranks]))
    launches, ms = {}, {}
    for r in ranks:
        out = r.value
        for part in ("sweep", "steps"):
            for k, v in out["launches"][part].items():
                launches[k] = launches.get(k, 0) + v
        for compute, carry in out["carries"].items():
            want = eval_ref["carries"][compute]
            same = all(np.array_equal(carry[k], v) for k, v in want.items())
            for key, v in want.items():
                if v.dtype.kind == "f":
                    check(np.allclose(carry[key], v, rtol=2e-6, atol=0),
                          "%s rank %s %s: %s %s against phase 9's %s" % (
                              label, out["place"], compute, key, carry[key],
                              v))
                else:
                    check(np.array_equal(carry[key], v), "%s rank %s %s: "
                          "counter %s %s against phase 9's %s" % (
                              label, out["place"], compute, key, carry[key],
                              v))
            if out["place"] == (0, 0):
                log("  %s %s: the cadence sweep on the gathered replica, "
                    "%.3f s for its block: counters equal phase 9's (%s)"
                    % (label, compute, out["sweep_s"][compute],
                       "the carry bitwise" if same else
                       "float sums within rtol 2e-6"))
        for compute, steps in out["steps"].items():
            tol, grad_tol = MESH_TOL[compute], MESH_GRAD_TOL[compute]
            for i, st in enumerate(steps):
                where = "%s rank %s %s step %d" % (label, out["place"],
                                                   compute, i)
                check(abs(st["loss"] - st["loss_one"])
                      <= tol * abs(st["loss_one"]),
                      "%s: loss %r, one process at the same parameters %r"
                      % (where, st["loss"], st["loss_one"]))
                check(st["shared"] == 0, "%s: %d differing decisions no "
                      "row owns: %s" % (where, st["shared"], st["ties"]))
                check(st["worst_gap"] <= MESH_TIE[compute], "%s: a "
                      "differing decision %.3e of its input's scale from "
                      "its tie (bound %.1e): %s" % (
                          where, st["worst_gap"], MESH_TIE[compute],
                          st["ties"]))
                check(st["held"] <= grad_tol, "%s: the gathered gradient "
                      "%s differs from one process's by %.3e of its scale "
                      "without the %d rows of differing decisions %s "
                      "(bound %.1e; %.3e with them)" % (
                          where, st["worst"], st["held"], len(st["rows"]),
                          st["rows"], grad_tol, st["raw"]))
            if out["place"] == (0, 0):
                ms[compute] = statistics.median(s["ms"] for s in steps[1:])
                for i, st in enumerate(steps):
                    log("  %s %s step %d: loss %.7f (one process %.7f); "
                        "gradient %.3e of scale from one process's, %.3e "
                        "(%s) without the %d rows of %d differing "
                        "decisions (worst %.3e from its tie; %s); %.2f ms"
                        % (label, compute, i, st["loss"], st["loss_one"],
                           st["raw"], st["held"], st["worst"],
                           len(st["rows"]), st["differing"],
                           st["worst_gap"], st["ties"][:2], st["ms"]))
                if compute in train_finals and D == 1:
                    log("  %s %s: the losses %s, phase 7's one-process "
                        "trajectory %s" % (
                            label, compute,
                            [round(s["loss"], 6) for s in steps],
                            [round(x, 6) for x in
                             train_finals[compute][0][:len(steps)]]))
                log("  %s %s: rank (0, 0) median %.2f ms/step (the step "
                    "alone, synchronized) against phase 7's %.2f ms" % (
                        label, compute, ms[compute], step_ms[compute]))
    for d in range(D):
        row = [r.value for r in ranks if r.value["place"][0] == d]
        for compute, hashes in row[0]["replicated"].items():
            check(hashes, "%s: no replicated parameter" % label)
            for peer in row[1:]:
                check(peer["replicated"][compute] == hashes,
                      "%s row %d %s: the replicated parameters differ "
                      "between the model peers" % (label, d, compute))
    check(len(row[0]["replicated"]["float32"])
          < len(train_finals["float32"][1]),
          "%s: every parameter is whole on the ranks" % label)
    for dtype in (torch.float32, torch.bfloat16):
        for name in (SCATTER[dtype], KERNEL_NAMES[("fused_ctx_pool",
                                                    dtype)]):
            check(launches.get(name, 0) > 0, "%s: the ranks launched no %s "
                  "(%s)" % (label, name, launches))
    log("  %s: replicated parameters bitwise across the model peers (%d "
        "tensors); launches in the ranks' sweeps and steps %s"
        % (label, len(row[0]["replicated"]["float32"]), launches))
    return {"launches": launches, "ms": ms}


def context_checks(torch, eval_ref, work):
    """Phase 20(c). Returns (the entry of gather_masked_sum_f32@context,
    the ranks' launches)."""
    import numpy as np
    import torch.nn.functional as F

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.ops.gather_pool import (
        KERNEL_NAMES, gather_masked_sum, gather_masked_sum_reference,
    )
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.tools import dist_check
    from lirec_tpu_torch.utils.fake_batch import make_tables

    split = eval_ref["split"]
    batch = {k: np.ascontiguousarray(split[k][:EVAL_B])
             for k in ("feat_idx", "rels_mask")}
    job = {"batch": os.path.join(work, "context_batch.pt"), "device": "cuda",
           "preset": "int_rel_ch", "n_classes": 101, "n_rels": 15,
           "seed": 0, "n_clips": N_CLIPS, "n_tracks": N_TRACKS}
    torch.save(batch, job["batch"])
    with host_clock(torch) as clock:
        ranks = dist.spawn(dist_check.context_run, 2, devices="cuda",
                           backend="gloo", timeout=DIST_TIMEOUT, args=(job,),
                           workdir=work)
    wall = clock.s
    name = KERNEL_NAMES[("gather_masked_sum", torch.float32)]
    tol = {"float32": dict(rtol=1e-5, atol=1e-6),
           "bfloat16": dict(rtol=4.1e-3, atol=4.1e-3)}
    cfg = config_lib.preset("int_rel_ch")
    fi = batch["feat_idx"]
    B, T, R = fi.shape[0], fi.shape[1], fi.shape[2] - 1
    idx = torch.from_numpy(fi[:, :, 1:, :].reshape(B * T, R, 3).copy()).to(
        "cuda", torch.int32)
    mask = torch.from_numpy(batch["rels_mask"].reshape(B * T, R).astype(
        np.float32)).cuda()
    errs, entry = [], None
    for compute in ("bfloat16", "float32"):
        bundle = create_model(cfg.with_runtime(compute_dtype=compute), 101,
                              n_rels=15, seed=0, device="cuda")
        tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
            bundle.spec, N_CLIPS, N_TRACKS, seed=0).items()}
        with torch.no_grad():
            emb = embed_all(bundle.model, bundle.spec, tables)
            want = bundle.apply(bundle.model, batch, embedded=emb)
        for r, result in enumerate(ranks):
            for key in ("inters", "rels"):
                got = result.value[compute][key]
                ref = want[key].cpu()
                check(tuple(got.shape) == tuple(ref.shape)
                      and bool(torch.isfinite(got).all()),
                      "context rank %d %s %s: %s" % (r, compute, key,
                                                     tuple(got.shape)))
                err = float((got - ref).abs().max())
                check(torch.allclose(got, ref, **tol[compute]),
                      "context rank %d %s %s: max|diff| %.3e against one "
                      "process beyond %s" % (r, compute, key, err,
                                             tol[compute]))
                if r == 0:
                    log("  (c) %s %s: the two ranks' logits against one "
                        "process's max|diff| %.3e (%s)" % (
                            compute, key, err, tol[compute]))
        # kernel 5 on each rank's block of each table, as the forward
        # calls it (a bf16 table read as f32)
        for c in range(2):
            lo, hi = R * c // 2, R * (c + 1) // 2
            m_blk = mask[:, lo:hi].contiguous()
            for k, table in enumerate(emb["ctx"]):
                table = table.float().contiguous()
                ids = idx[:, lo:hi, k].contiguous()
                got = gather_masked_sum(table, ids, m_blk)
                torch.cuda.synchronize()
                check(torch.equal(got, masked_sum_loop(torch, table, ids,
                                                       m_blk)),
                      "context block %d table %d %s: kernel 5 is not the "
                      "r-ordered loop" % (c, k, compute))
                ref = gather_masked_sum_reference(table, ids, m_blk)
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                check(err <= 1e-5 * scale, "context block %d table %d %s: "
                      "kernel 5 %.3e from its plain version" % (
                          c, k, compute, err))
                errs.append(err)
                if c == 0 and k == 0 and compute == "float32":
                    ms = median_ms(torch, lambda: gather_masked_sum(
                        table, ids, m_blk))
                    plain = median_ms(torch, lambda: (
                        gather_masked_sum_reference(table, ids, m_blk)))
                    lib = median_ms(torch, lambda: F.embedding_bag(
                        ids, table, per_sample_weights=m_blk, mode="sum"))
                    M_, R_ = ids.shape
                    moved = (gathered_bytes(table, ids) + nbytes(ids, m_blk)
                             + M_ * table.shape[1] * 4)
                    b = bound(moved, 2 * M_ * R_ * table.shape[1])
                    entry = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 shapes=dict(idx=[M_, R_],
                                             table=list(table.shape)), **b)
                    log("  (c) kernel 5 on rank 0's clip block [%d, %d] of "
                        "a %s table: %.4f ms, plain %.4f ms, embedding_bag "
                        "%.4f ms; bound %.4f ms (%s)" % (
                            M_, R_, list(table.shape), ms, plain, lib,
                            b["bound_ms"], b["bound_by"]))
        del bundle, emb, tables
    launched = [dict(r.launches) for r in ranks]
    for r, got in enumerate(launched):
        # three tables per forward, bf16 and f32 (a bf16 table read as f32)
        check(got.get(name, 0) == 6, "context rank %d: launches %s"
              % (r, got))
    log("  (c) kernel 5 bitwise the r-ordered loop on every block, worst "
        "%.3e from its plain version; launches per rank %s; %.1f s from "
        "spawn to join" % (max(errs), [g.get(name, 0) for g in launched],
                           wall))
    entry["max_abs_err"] = max(errs)
    return entry, sum(g.get(name, 0) for g in launched)


def world_of_one_mesh(torch, local, train_finals, eval_ref, work):
    """Phase 20(d): a process group of one over NCCL through parallel/mesh:
    phase 9's f32 sweep and phase 7's f32 steps bitwise."""
    import numpy as np

    import torch.distributed

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.parallel.mesh import (
        Mesh2D, gather_state, make_mesh, shard_model,
    )
    from lirec_tpu_torch.parallel.step import make_dp_train_step
    from lirec_tpu_torch.train.loop import step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    dist.initialize_distributed("file://" + os.path.join(work, "nccl20"), 1,
                                0, "cuda")
    try:
        check(torch.distributed.get_backend() == "nccl", "backend")
        mesh = make_mesh((1, 1))
        check(isinstance(mesh, Mesh2D) and mesh.model == 1 and mesh.lead,
              "mesh %s" % (mesh,))
        cfg = config_lib.preset("int_rel_ch").with_runtime(
            compute_dtype="float32")
        bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
        host_tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
        dev_tables = {k: torch.from_numpy(v).cuda()
                      for k, v in host_tables.items()}
        opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                             cfg.optim.weight_decay)
        before = {k: v.clone() for k, v in bundle.model.state_dict().items()}
        shard_model(bundle.model, mesh, bundle.spec, opt)
        state, _ = gather_state(bundle.model, mesh)
        check(all(torch.equal(state[k], v) for k, v in before.items()),
              "a model axis of 1 changed the model")
        carry = packed.sweep_carry(
            split_stand_in(), bundle, bundle.model,
            cfg.with_optim(batch_size=EVAL_B), mode="test",
            data=eval_ref["split"], tables=host_tables, localize_ctx=False,
            mesh=mesh)
        for key, v in eval_ref["carries"]["float32"].items():
            check(np.array_equal(carry[key], v), "(d) sweep %s differs "
                  "from phase 9's" % key)
        step = make_dp_train_step(bundle, opt, mesh, TRAIN_B)
        losses = [float(step(batch, dev_tables,
                             step_generators(0, i, "cuda")))
                  for i, batch in enumerate(local)]
        want_losses, want_params = train_finals["float32"]
        check(losses == want_losses, "(d) losses %s, phase 7's %s"
              % (losses, want_losses))
        for n, p in bundle.model.named_parameters():
            check(torch.equal(p.detach().cpu(), want_params[n]),
                  "(d) parameter %s differs from phase 7's" % n)
        log("  (d) NCCL world of one through parallel/mesh: %s; the f32 "
            "sweep carry bitwise phase 9's, %d f32 steps bitwise phase "
            "7's" % (mesh, len(local)))
        del bundle, opt, step
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()


def model_axis_phase(torch, spec, local, caps, train_finals, step_ms,
                     eval_ref):
    """Phase 20. Returns {"tp_scatter": {tag: scatter_case entry},
    "launches": {kernel: launches of (a) and (b)}, "context": kernel 5's
    entry, "context_launches": its launches in (c), "ms": {mesh: {compute:
    ms/step}}}."""
    from lirec_tpu_torch.parallel import dist
    from lirec_tpu_torch.tools import dist_check

    out = {"launches": {}, "ms": {}, "tp_scatter": {}}
    # kernel 6 at the shard widths of M = 2, on phase 7's first batch
    idx_loc = ctx_idx(torch, local[0])
    g = torch.Generator(device="cuda").manual_seed(20)
    widths = (spec.joint_dim, spec.joint_dim // 2, spec.joint_dim // 2)
    base = [torch.randn(*idx_loc.shape[:2], d, device="cuda", generator=g)
            for d in widths]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        out["tp_scatter"][tag] = scatter_case(
            torch, "3 tables at caps, M = 2 shard widths %s %s"
            % (list(widths), tag), idx_loc, [t.to(dtype) for t in base],
            (caps[0], caps[1], caps[1]), single=False)
    del base
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        job = {"split": os.path.join(work, "split.pt"),
               "batches": os.path.join(work, "batches.pt"),
               "device": "cuda", "preset": "int_rel_ch", "n_classes": 101,
               "n_rels": 15, "seed": 0, "n_clips": N_CLIPS,
               "n_tracks": N_TRACKS, "eval_b": EVAL_B, "train_b": TRAIN_B}
        torch.save(eval_ref["split"], job["split"])
        torch.save(local, job["batches"])
        for label, shape, extra in (
                ("(a) 1x2", (1, 2), dict(steps=len(local), dropout=True)),
                ("(b) 2x2", (2, 2), dict(steps=MESH_STEPS_2X2,
                                         dropout=False))):
            with host_clock(torch) as clock:
                ranks = dist.spawn(dist_check.rank_run, shape[0] * shape[1],
                                   devices="cuda", backend="gloo",
                                   timeout=DIST_TIMEOUT,
                                   args=(dict(job, mesh=shape, **extra),),
                                   workdir=work)
            wall = clock.s
            got = mesh_rank_checks(torch, label, ranks, shape, eval_ref,
                                   step_ms, train_finals)
            for k, v in got["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            out["ms"]["%dx%d" % shape] = got["ms"]
            log("  %s: %d ranks, %.1f s from spawn to join" % (
                label, len(ranks), wall))
        out["context"], out["context_launches"] = context_checks(
            torch, eval_ref, work)
        world_of_one_mesh(torch, local, train_finals, eval_ref, work)
    return out


# ------------------------------------------------------ the rest of training


def dense_of(torch, tables, feat_idx):
    """Reference-layout rows [..., text | visual | track1 | track2] of
    `feat_idx` gathered from the tables on the card."""
    idx = feat_idx.long()
    return torch.cat([tables["text"][idx[..., 0]],
                      tables["visual"][idx[..., 0]],
                      tables["track"][idx[..., 1]],
                      tables["track"][idx[..., 2]]], dim=-1)


def dense_forward_checks(torch, spec):
    """Phase 17(a): the dense forwards of int_rel_ch, int_ch and modalities
    at published widths against the packed eval forward on the same
    samples (phase 9's first structured batch; int_rel_ch's packed forward
    pools through kernel 1 / 2), f32 and bf16. Returns {case: max|diff|}."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.utils.fake_batch import (
        make_structured_batch, make_tables,
    )

    host = make_structured_batch(spec, EVAL_B, N_CLIPS, N_TRACKS, seed=900)
    fi = torch.from_numpy(host["feat_idx"]).cuda()
    mask = torch.from_numpy(host["rels_mask"]).cuda()
    layouts = {
        "int_rel_ch": ({"feat_idx": fi, "rels_mask": mask}, 15),
        "int_ch": ({"feat_idx": fi[:, :, :1].contiguous()}, 0),
        "modalities": ({"feat_idx": fi[:, 0, :1].contiguous()}, 0),
    }
    atol = {"float32": 1e-5, "bfloat16": 2e-3}
    tables = None
    errs = {}
    for preset, (packed, n_rels) in layouts.items():
        for compute in ("float32", "bfloat16"):
            cfg = config_lib.preset(preset).with_runtime(
                compute_dtype=compute)
            bundle = create_model(cfg, 101, n_rels=n_rels, seed=0,
                                  device="cuda")
            if tables is None:
                tables = {k: torch.from_numpy(v).cuda() for k, v in
                          make_tables(bundle.spec, N_CLIPS, N_TRACKS,
                                      seed=0).items()}
            feats = dense_of(torch, tables, packed["feat_idx"])
            if preset == "int_ch":
                feats = feats[:, :, 0]  # the dataset's ctx-off [B, T, D]
            dense = dict(packed, features=feats)
            del dense["feat_idx"]
            dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
            pool = KERNEL_NAMES[("fused_ctx_pool", dtype)]
            with torch.inference_mode():
                embedded = embed_all(bundle.model, bundle.spec, tables)
                dispatch.reset_launches()
                want = bundle.apply(bundle.model, packed, tables=tables,
                                    embedded=embedded)
                torch.cuda.synchronize()
                launched = dispatch.launches(pool)
                got = bundle.apply(bundle.model, dense)
                torch.cuda.synchronize()
            check(launched == (1 if preset == "int_rel_ch" else 0),
                  "%s %s packed forward: %d launches of %s"
                  % (preset, compute, launched, pool))
            for key, w in want.items():
                if w is None:
                    check(got[key] is None, "%s %s" % (preset, key))
                    continue
                check(tuple(got[key].shape) == tuple(w.shape)
                      and bool(torch.isfinite(got[key]).all()),
                      "%s %s %s: shape %s, finite %s" % (
                          preset, compute, key, tuple(got[key].shape),
                          bool(torch.isfinite(got[key]).all())))
                err = float((got[key] - w).abs().max())
                errs["%s_%s_%s" % (preset, compute, key)] = err
                log("  (a) %s %s %s %s: dense vs packed max|diff| %.3e "
                    "(atol %.0e)" % (preset, compute, key,
                                     tuple(w.shape), err, atol[compute]))
                check(err <= atol[compute], "%s %s %s: the dense forward "
                      "disagrees with the packed one" % (preset, compute,
                                                         key))
            del bundle, embedded, want, got, dense, feats
            torch.cuda.empty_cache()
    return errs


def dense_train_steps(torch, raw):
    """Phase 17(b): three dense int_rel_ch train steps at B = 64 and
    published widths (bf16, the preset's compute, dropout 0.5), from
    batches that InteractionDataset.to_dense gathers per sample on the
    host, staged by prefetch_to_device. Returns the times."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.dataset import InteractionDataset
    from lirec_tpu_torch.data.pipeline import collate, prefetch_to_device
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg = config_lib.preset("int_rel_ch")
    bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
    tb = types.SimpleNamespace(**make_tables(bundle.spec, N_CLIPS, N_TRACKS,
                                             seed=0))
    ds = types.SimpleNamespace(tables=tb, cfg=cfg)  # what to_dense reads
    step = make_train_step(bundle, make_optimizer(
        bundle.model.parameters(), cfg.optim.lr, cfg.optim.weight_decay))
    out = {"host_to_dense_ms": [], "h2d_ms": [], "step_ms": [],
           "batch_bytes": 0}
    losses = []
    dispatch.reset_launches()
    for i, batch in enumerate(raw[:3]):
        with host_clock(torch) as clock:
            dense = collate([InteractionDataset.to_dense(
                ds, {k: v[j] for k, v in batch.items()})
                for j in range(len(batch["labels"]))])
        out["host_to_dense_ms"].append(clock.s * 1e3)
        check(dense["features"].shape == (TRAIN_B, 20, 19, 6912),
              "dense batch %s" % (dense["features"].shape,))
        out["batch_bytes"] = sum(v.nbytes for v in dense.values())
        with host_clock(torch) as clock:
            staged = next(prefetch_to_device(iter([dense]), "cuda"))
        out["h2d_ms"].append(clock.s * 1e3)
        with host_clock(torch) as clock:
            losses.append(float(step(staged, None,
                                     step_generators(0, i, "cuda"))))
        out["step_ms"].append(clock.s * 1e3)
        del dense, staged
    check(all(np.isfinite(losses)), "dense train losses %s" % losses)
    check(kernel_launches() == {}, "dense steps launched %s"
          % kernel_launches())
    out["losses"] = losses
    log("  (b) 3 dense int_rel_ch steps at B=%d (features [%d, 20, 19, "
        "6912] f32, %.1f MB a batch): losses %s; host to_dense %s ms, "
        "pinned + H2D copy %s ms, step %s ms (the first with warm-up)"
        % (TRAIN_B, TRAIN_B, out["batch_bytes"] / 1e6, losses,
           ["%.1f" % x for x in out["host_to_dense_ms"]],
           ["%.1f" % x for x in out["h2d_ms"]],
           ["%.1f" % x for x in out["step_ms"]]))
    del bundle, step
    torch.cuda.empty_cache()
    return out


def prefetched_train_path(torch, local, train_finals, step_ms):
    """Phase 17(d): phase 7's 10 steps again, in turns with the batches as
    phase 7 passes them (host arrays, copied inside the step) and staged
    by prefetch_to_device (pinned memory, a side copy stream), PREFETCH_
    TURNS, each run from phase 7's seed; every run's losses and parameters
    bitwise phase 7's. Returns {compute: {"plain", "prefetch": median
    ms/step over all runs of each, and each run's median}}."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.pipeline import prefetch_to_device
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg = config_lib.preset("int_rel_ch")
    tables = None
    ms = {}
    for compute in ("bfloat16", "float32"):
        want_losses, want_params = train_finals[compute]
        runs = {"plain": [], "prefetch": []}

        def run(mode, turn):
            """A turn: phase 7's steps from a fresh model, each step's
            ms after the first (its warm-up)."""
            nonlocal tables
            bundle = create_model(cfg.with_runtime(compute_dtype=compute),
                                  101, n_rels=15, seed=0, device="cuda")
            if tables is None:
                tables = {k: torch.from_numpy(v).cuda() for k, v in
                          make_tables(bundle.spec, N_CLIPS, N_TRACKS,
                                      seed=0).items()}
            opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                                 cfg.optim.weight_decay)
            step = make_train_step(bundle, opt)
            source = enumerate(prefetch_to_device(iter(local), "cuda")
                               if mode == "prefetch" else local)
            losses = []

            def one_step(_):
                i, batch = next(source)
                if mode == "prefetch":
                    check(all(v.is_cuda for v in batch.values()),
                          "not staged")
                losses.append(float(step(batch, tables,
                                         step_generators(0, i, "cuda"))))

            times = host_ms(torch, one_step, len(local))[1:]
            check(losses == want_losses, "%s %s: losses %s != phase 7's %s"
                  % (compute, mode, losses, want_losses))
            for n, p in bundle.model.named_parameters():
                check(torch.equal(p.detach().cpu(), want_params[n]),
                      "%s %s: parameter %s differs from phase 7's"
                      % (compute, mode, n))
            runs[mode].append(statistics.median(times))
            del bundle, opt, step
            torch.cuda.empty_cache()
            return times

        times = in_turns(PREFETCH_TURNS, {mode: functools.partial(run, mode)
                                          for mode in runs})
        ms[compute] = {k: statistics.median(v) for k, v in times.items()}
        ms[compute]["runs"] = runs
        log("  (d) %s: phase 7's 10 steps in turns %s, each bitwise phase "
            "7's (losses and parameters); median %.2f ms/step plain, %.2f "
            "prefetched (phase 7: %.2f); each run's median: plain %s, "
            "prefetched %s" % (
                compute, "/".join(PREFETCH_TURNS), ms[compute]["plain"],
                ms[compute]["prefetch"], step_ms[compute],
                ["%.2f" % x for x in runs["plain"]],
                ["%.2f" % x for x in runs["prefetch"]]))
    return ms


def plan_cache_checks(torch, root):
    """Phase 17(f): on the published-widths fixture, the assembly plan's
    disk cache: a miss (build and save) on one dataset, then a hit (load
    and spot check) on a second dataset over the same data. Returns the
    times."""
    import shutil

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data import synthetic
    from lirec_tpu_torch.data.dataset import InteractionDataset
    from lirec_tpu_torch.ops import dispatch

    base = synthetic.make_config(root, synthetic.SyntheticSpec(
        **PUBLISHED_FIXTURE))
    cfg = config_lib.preset("int_rel_ch", data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths)
    shutil.rmtree(os.path.join(cfg.paths.visual_features, "cached",
                               "plans"), ignore_errors=True)
    out = {}
    for case, reason in (("build_s", "built+saved"),
                         ("load_s", "hit+verified")):
        ds = InteractionDataset(cfg, mode="train")
        ds.cache()
        ds.init_relships()
        with host_clock(torch) as clock:
            plan = ds.assembly_plan()
        out[case] = clock.s
        rec = dispatch.last_dispatch("assembly_plan_cache")
        check(plan is not None and rec["reason"] == reason,
              "plan cache: %s, expected %s" % (rec, reason))
    out["samples"] = len(ds)
    log("  (f) assembly plan of %d samples: built and saved in %.3f s "
        "(miss), loaded and spot-checked in %.3f s on a second dataset "
        "(hit)" % (out["samples"], out["build_s"], out["load_s"]))
    return out


def pool_and_profile_cli(torch, root):
    """Phase 17(c) and (e): the training CLI on the published-widths
    fixture with no assembly plan (LIREC_TPU_NO_PLAN=1), 2 epochs, once in
    process and once with --assembly-workers 2 and --profile: the losses
    bitwise equal, every epoch assembled by the pool (dispatch), and the
    trace naming the pool kernel (kernel 1/2, the cadence sweep) and the
    scatter (kernel 6, the steps). Returns the times."""
    import glob

    from lirec_tpu_torch.cli import train as train_cli
    from lirec_tpu_torch.data.pipeline import ASSEMBLY
    from lirec_tpu_torch.ops import dispatch

    prof = os.path.join(root, "profile")
    args = ["--data-root", root, "--device", "cuda", "--quiet",
            "--text-dim", "768", "--visual-dim", "2048", "--text-layers",
            "12", "--joint-dim", "512", "--epochs", "2"]
    runs = {}
    saved = os.environ.get("LIREC_TPU_NO_PLAN")
    os.environ["LIREC_TPU_NO_PLAN"] = "1"
    try:
        for workers in (0, 2):
            extra = ["--store-root", os.path.join(root, "store_pool%d"
                                                  % workers)]
            if workers:
                extra += ["--assembly-workers", str(workers), "--profile",
                          prof]
            before = dispatch.decisions(ASSEMBLY)
            with host_clock(torch) as clock:
                out = train_cli.main(args + extra)
            secs = clock.s
            after = dispatch.decisions(ASSEMBLY)
            runs[workers] = (out["train"]["losses"], secs, {
                p: after.get(p, 0) - before.get(p, 0) for p in after})
    finally:
        if saved is None:
            os.environ.pop("LIREC_TPU_NO_PLAN", None)
        else:
            os.environ["LIREC_TPU_NO_PLAN"] = saved
    (l0, s0, d0), (l2, s2, d2) = runs[0], runs[2]
    check(d0.get("per-sample", 0) == 2 and not d0.get("pool"),
          "in-process run's assembly %s" % d0)
    check(d2.get("pool", 0) == 2 and not d2.get("fallback"),
          "--assembly-workers 2 run's assembly %s: the pool must run" % d2)
    check(l2 == l0, "--assembly-workers 2 losses %s != in-process %s"
          % (l2, l0))
    log("  (c) training CLI, no plan, 2 epochs: in process %.1f s, losses "
        "%s; --assembly-workers 2 (+ --profile) %.1f s, losses bitwise "
        "equal; assembly decisions %s / %s" % (s0, l0, s2, d0, d2))
    path = os.path.join(prof, "train.json")
    check(os.path.exists(path), "--profile wrote no %s: %s"
          % (path, glob.glob(os.path.join(prof, "*"))))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    named = {key: sorted(k for k in kernels if key in k)[:2]
             for key in ("fused_ctx_pool_kernel", "scatter_short_kernel")}
    check(all(named.values()), "the trace names no pool or scatter "
          "kernel: %s" % named)
    log("  (e) --profile wrote %s (%.1f MB, %d events, %d kernel names); "
        "the pool and scatter kernels in it: %s"
        % (os.path.relpath(path, root), os.path.getsize(path) / 1e6,
           len(events), len(kernels), json.dumps(named)))
    return {"in_process_s": s0, "workers_profiled_s": s2}


def rest_of_training_phase(torch, spec, root, raw, local, train_finals,
                           step_ms):
    """Phase 17: the dense path, the prefetch, the assembly workers,
    --profile and the plan cache, on the card."""
    out = {"dense_errs": dense_forward_checks(torch, spec)}
    out["dense_train"] = dense_train_steps(torch, raw)
    out["prefetch_ms"] = prefetched_train_path(torch, local, train_finals,
                                               step_ms)
    out["pool_cli"] = pool_and_profile_cli(torch, root)
    out["plan_cache"] = plan_cache_checks(torch, root)
    return out


def dim_args(dims):
    return [a for k, v in dims.items()
            for a in ("--" + k.replace("_", "-"), str(v))]


def seeded_checkpoint(torch, root, preset, artifact, path, dims):
    """A reference-format .pth.tar of seeded weights for `preset` on the
    fixture, sized by the class counts in its ingest `artifact`. Returns
    the eval CLI's config of the fixture."""
    from lirec_tpu_torch.cli import common
    from lirec_tpu_torch.data.artifact import load_ingest
    from lirec_tpu_torch.models.factory import create_model

    cfg = common.config_from_args(preset, common.build_parser(
        preset).parse_args(["--data-root", root] + dim_args(dims)))
    train = load_ingest(artifact, cfg)["train"]
    model = create_model(cfg, train.n_classes,
                         n_rels=max(len(train.rels_list) - 1, 0), seed=0,
                         device="cpu").model
    torch.save({"state_dict": model.state_dict(), "epoch": 0}, path)
    return cfg


def same_metrics(card, plain, label, device):
    """An eval CLI's metrics on `device` against the CPU's plain versions:
    every counter-derived value exactly, the loss within 1e-5."""
    for split in ("val", "test"):
        for key, v in plain[split].items():
            if key == "loss":
                check(abs(card[split][key] - v) <= 1e-5 * abs(v),
                      "%s %s loss %r on %s, %r on the CPU"
                      % (label, split, card[split][key], device, v))
            else:
                check(card[split][key] == v, "%s %s %s %r on %s, %r on "
                      "the CPU" % (label, split, key, card[split][key],
                                   device, v))


def ingest_and_eval_clis(torch, root, device, dims):
    """Phase 18 (a), (b) and (d). Returns (ingest artifacts, launches of
    (b), kernels 1-2's entries at (b)'s own inputs, the numbers
    logged)."""
    from lirec_tpu_torch.cli import common, convert_checkpoint, ingest
    from lirec_tpu_torch.cli import int_rel_ch
    from lirec_tpu_torch.data.artifact import load_ingest
    from lirec_tpu_torch.models import tabular
    from lirec_tpu_torch.models.tabular import EmbeddedTables
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool

    work = os.path.join(root, "phase18")
    os.makedirs(work, exist_ok=True)
    out, arts = {}, {}
    # (a) the ingest CLI: one artifact per preset
    for preset in ("int_rel_ch", "int_rels"):
        arts[preset] = os.path.join(work, "ingest_%s.npz" % preset)
        with host_clock(torch) as clock:
            ingest.main(["--data-root", root, "--preset", preset, "--out",
                         arts[preset]] + dim_args(dims))
        out["ingest_" + preset] = dict(
            s=clock.s, MB=os.path.getsize(arts[preset]) / 1e6)
        log("  (a) cli.ingest.main --preset %s: %.2f s, %.2f MB"
            % (preset, out["ingest_" + preset]["s"],
               out["ingest_" + preset]["MB"]))

    # (b) the int_rel_ch eval CLI without an artifact, writing one, and
    # loading it (counted runs: kernels 1-2); the loading run records the
    # pool's first call (the val split's first batch), held and timed below
    ckpt = os.path.join(work, "int_rel_ch.pth.tar")
    cfg = seeded_checkpoint(torch, root, "int_rel_ch", arts["int_rel_ch"],
                            ckpt, dims)
    base = ["--data-root", root, "--device", device, "--quiet"] + \
        dim_args(dims)
    metrics, first = {}, {}
    real = tabular.fused_ctx_pool

    def recording(emb, idx, mask, guard):
        first.setdefault(emb.clip.dtype, (
            EmbeddedTables(*(t.clone() for t in emb)), idx.clone(),
            mask.clone(), guard))
        return real(emb, idx, mask, guard)

    dispatch.reset_launches()
    for compute in ("bfloat16", "float32"):
        cache = os.path.join(work, "cli_%s.npz" % compute)
        args = base + ["--resume-path", ckpt, "--compute-dtype", compute]
        runs = [int_rel_ch.main(args)]
        runs.append(int_rel_ch.main(args + ["--ingest-cache", cache]))
        check(os.path.exists(cache), "--ingest-cache wrote no %s" % cache)
        written = os.stat(cache).st_mtime_ns
        tabular.fused_ctx_pool = recording
        try:
            runs.append(int_rel_ch.main(args + ["--ingest-cache", cache]))
        finally:
            tabular.fused_ctx_pool = real
        check(os.stat(cache).st_mtime_ns == written,
              "--ingest-cache rewrote the artifact it should have loaded")
        # counters exactly and floats bitwise: the same dicts
        check(runs[0] == runs[1] == runs[2], "%s: the eval CLI's metrics "
              "without / writing / loading the artifact differ: %s"
              % (compute, runs))
        metrics[compute] = runs[0]
        log("  (b) cli.int_rel_ch.main %s, without / writing / loading "
            "--ingest-cache: val %s, test %s, all three equal"
            % (compute, runs[0]["val"], runs[0]["test"]))
    torch.cuda.synchronize()
    launched = kernel_launches()
    # the f32 artifact through the plain versions on the CPU
    plain = int_rel_ch.main(
        ["--data-root", root, "--device", "cpu", "--quiet"] + dim_args(dims)
        + ["--resume-path", ckpt, "--compute-dtype", "float32",
           "--ingest-cache", os.path.join(work, "cli_float32.npz")])
    same_metrics(metrics["float32"], plain, "int_rel_ch", device)
    log("  (b) cli.int_rel_ch.main float32 from the artifact on the CPU "
        "(plain versions): the same counters, loss within 1e-5")
    # kernels 1-2 held against the plain version and timed on the loading
    # run's first pool call
    pool = {}
    for dtype, tag, atol in ((torch.float32, "f32", 2e-6),
                             (torch.bfloat16, "bf16", 1e-5)):
        check(dtype in first, "the eval CLI from an artifact made no %s "
              "pool call" % tag)
        emb, idx, mask, guard = first[dtype]
        ms = median_ms(torch, lambda: fused_ctx_pool(emb, idx, mask, guard))
        div = (guarded_div(torch, mask) if guard
               else mask.sum(-1, keepdim=True))
        pool[tag] = eval_pool_entry(torch, tag + "@ingest", emb, idx, mask,
                                    mask.to(dtype), div, ms, atol, guard)
        pool[tag]["shapes"] = dict(
            M=idx.shape[0], R=idx.shape[1], guard=guard,
            clip=list(emb.clip.shape), tracks=list(emb.tr1.shape))
        log("  (b) the %s pool's inputs: %s" % (tag, pool[tag]["shapes"]))
    # the datasets' start-up: built from the fixture against loaded
    with host_clock(torch) as clock:
        common.build_datasets(cfg, "int_rel_ch")
    out["build_datasets_s"] = clock.s
    with host_clock(torch) as clock:
        load_ingest(arts["int_rel_ch"], cfg)
    out["load_ingest_s"] = clock.s
    log("  (b) start-up of the three datasets: build_datasets %.3f s, "
        "load_ingest %.3f s" % (out["build_datasets_s"],
                                out["load_ingest_s"]))

    # (d) convert-checkpoint, then the eval CLI on the .ckpt
    converted = os.path.join(work, "int_rel_ch.ckpt")
    with host_clock(torch) as clock:
        convert_checkpoint.main(["--src", ckpt, "--dst", converted])
    out["convert_s"] = clock.s
    got = int_rel_ch.main(base + ["--resume-path", converted,
                                  "--compute-dtype", "bfloat16"])
    check(got == metrics["bfloat16"], "the eval CLI on the converted .ckpt "
          "%s != on the .pth.tar %s" % (got, metrics["bfloat16"]))
    log("  (d) cli.convert_checkpoint.main of %.1f MB: %.2f s; the eval "
        "CLI on the .ckpt gives (b)'s metrics" % (
            os.path.getsize(ckpt) / 1e6, out["convert_s"]))
    return arts, launched, pool, out


def int_rels_sweep_checks(torch, root, arts, device, dims):
    """Phase 18 (c): the int_rels eval CLI from its artifact on `device`
    (the counted run: kernel 8 once per batch) and on the CPU (the plain
    versions), then the sweep's rels_table against the CPU's in-order sum
    of the same update rows. Returns (launches, the test split's recorded
    scatter calls, the numbers logged)."""
    import numpy as np

    from lirec_tpu_torch.cli import int_rels
    from lirec_tpu_torch.data.artifact import load_ingest
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch, scatter_accum

    ckpt = os.path.join(root, "phase18", "int_rels.pth.tar")
    cfg = seeded_checkpoint(torch, root, "int_rels", arts["int_rels"], ckpt,
                            dims)
    args = ["--data-root", root, "--resume-path", ckpt, "--quiet",
            "--compute-dtype", "float32", "--ingest-cache",
            arts["int_rels"]] + dim_args(dims)
    dispatch.reset_launches()
    card = int_rels.main(args + ["--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    launched = kernel_launches()
    plain = int_rels.main(args + ["--device", "cpu"])
    same_metrics(card, plain, "int_rels", device)
    splits = load_ingest(arts["int_rels"], cfg)
    B = cfg.optim.batch_size
    batches = 0
    for split in ("val", "test"):
        n_full, tail = divmod(len(splits[split]), B)
        batches += n_full + (tail > 1)
    log("  (c) cli.int_rels.main from its artifact on %s and on the CPU: "
        "val %s, test %s (the same counters); %d batches; launches %s" % (
            device, card["val"], card["test"], batches, launched))

    # the test split's carry on the device, every scatter call recorded
    # (its ids and rows: the running table, then the batch's updates),
    # and on the CPU
    ds = splits["test"]
    state = torch.load(ckpt, map_location="cpu")["state_dict"]
    carries, calls = {}, []
    real = scatter_accum.scatter_accum1  # the sweep's step imports it

    def recording(ids, rows, n_rows):
        calls.append((ids.clone(), rows.clone(), n_rows))
        return real(ids, rows, n_rows)

    for side, dev in (("device", device), ("cpu", "cpu")):
        bundle = create_model(cfg, ds.n_classes,
                              n_rels=max(len(ds.rels_list) - 1, 0),
                              device=dev)
        bundle.model.load_state_dict(state)
        scatter_accum.scatter_accum1 = recording if side == "device" \
            else real
        try:
            carries[side] = packed.sweep_carry(ds, bundle, bundle.model,
                                               cfg, mode="test")
        finally:
            scatter_accum.scatter_accum1 = real
    check(calls, "the int_rels sweep made no scatter call")
    table = None
    for ids, rows, n_rows in calls:
        rows = rows.cpu()
        if table is not None:
            rows = torch.cat([table, rows[n_rows:]])
        table = scatter_accum.scatter_accum1_reference(ids.cpu(), rows,
                                                       n_rows)
    got = carries["device"]
    check(np.array_equal(table.numpy(), got["rels_table"]),
          "the sweep's rels_table is not the in-order sum of its updates")
    for key, v in carries["cpu"].items():
        if key == "rels_table":
            check(np.allclose(got[key], v, rtol=1e-5, atol=1e-6),
                  "rels_table on %s against the CPU sweep's" % device)
        elif np.issubdtype(v.dtype, np.integer):
            check(np.array_equal(got[key], v), "carry %s on %s %s, on the "
                  "CPU %s" % (key, device, got[key], v))
    diff = float(np.abs(got["rels_table"] - carries["cpu"]["rels_table"])
                 .max())
    log("  (c) the test split's rels_table [%d, %d] over %d scatter calls: "
        "bitwise the CPU's in-order sum of the same update rows; %.3e from "
        "the CPU sweep's own (other GEMMs), integer counters equal"
        % (*got["rels_table"].shape, len(calls), diff))
    return launched, calls, dict(batches=batches, rels_table_vs_cpu=diff)


def host_tools_checks(torch, root, dims):
    """Phase 18 (e): extract-text (fake backend), verify-features check on
    its output, graphs-demo on the fixture's graphs."""
    import contextlib
    import io

    from lirec_tpu_torch.cli import extract_text, graphs_demo
    from lirec_tpu_torch.cli import verify_features
    from lirec_tpu_torch.data import synthetic

    text_out = os.path.join(root, "phase18", "bert")
    with host_clock(torch) as clock:
        n = extract_text.main(["--data-root", root, "--out-dir", text_out,
                               "--backend", "fake", "--quiet", "--text-dim",
                               str(dims["text_dim"]), "--text-layers",
                               str(dims["text_layers"])])
    secs = clock.s
    bad = verify_features.main(["check", "--text-root", text_out])
    check(n > 0 and bad == [], "extract-text wrote %d scenes, verify-"
          "features found %s" % (n, bad))
    graphs = synthetic.make_config(root, synthetic.SyntheticSpec(
        **PUBLISHED_FIXTURE)).paths.annotations
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = graphs_demo.main([graphs])
    check(rc == 0, "graphs-demo returned %s" % rc)
    log("  (e) extract-text --backend fake: %d scenes in %.2f s, verify-"
        "features check: no mismatch; graphs-demo: exit 0, %d lines"
        % (n, secs, len(printed.getvalue().splitlines())))


def remaining_clis_phase(torch, root, device, dims):
    """Phase 18 on the published-widths fixture, the CLIs at `dims` on
    `device`. Returns (launches of (b), kernels 1-2's entries at (b)'s
    inputs, launches of (c), kernel 8's entry at the int_rels sweep's
    shapes, the numbers logged)."""
    arts, ingest_counts, ingest_pool, out = ingest_and_eval_clis(
        torch, root, device, dims)
    rels_counts, calls, out["int_rels"] = int_rels_sweep_checks(
        torch, root, arts, device, dims)
    host_tools_checks(torch, root, dims)
    ids, rows, n_rows = calls[0]  # the first batch: table rows + updates
    idx = ids[:, None].expand(-1, 3).contiguous()
    entry = scatter_case(torch, "kernel 8 at the int_rels sweep", idx,
                         [rows], [n_rows], single=True)
    entry["shapes"] = dict(updates=list(rows.shape), rows=n_rows)
    return ingest_counts, ingest_pool, rels_counts, entry, out

# ------------------------------------------------- phase 19: the sweeps


def train_sweep_checks(torch, batches, finals):
    """Phase 19 (a): phase 7's batches through the epoch sweep's CUDA
    graph (the counted run), bitwise phase 7's per-batch losses and
    parameters, and a chunked sweep bitwise too; then epochs of the graph
    sweep and of the per-batch eager steps in turns on one model, ms/step
    each."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES, SORT_NAME
    from lirec_tpu_torch.train.loop import make_train_step
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.train.sweep import EpochSweep
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg = config_lib.preset("int_rel_ch")
    tables, out, counts = None, {}, {}
    for compute in ("bfloat16", "float32"):
        name = KERNEL_NAMES[torch.bfloat16 if compute == "bfloat16"
                            else torch.float32]
        want_losses, want_params = finals[compute]

        def fresh(max_steps=512):
            bundle = create_model(cfg.with_runtime(compute_dtype=compute),
                                  101, n_rels=15, seed=0, device="cuda")
            opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                                 cfg.optim.weight_decay)
            return bundle, opt, EpochSweep(bundle, opt, tables, 0, TRAIN_B,
                                           sweep_max_steps=max_steps,
                                           require_graph=True)

        def held(bundle, losses, label):
            check(losses == want_losses, "%s %s losses %s, phase 7's %s"
                  % (compute, label, losses, want_losses))
            for n, p in bundle.model.named_parameters():
                check(torch.equal(p.detach().cpu(), want_params[n]),
                      "%s %s: parameter %s differs from phase 7's"
                      % (compute, label, n))

        if tables is None:
            spec = create_model(cfg, 101, n_rels=15, seed=0,
                                device="cpu").spec
            tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
                spec, N_CLIPS, N_TRACKS, seed=0).items()}
        bundle, opt, sweep = fresh()
        # ---- the counted run: one epoch of the sweep
        dispatch.reset_launches()
        with host_clock(torch) as clock:
            losses = sweep.fetch(sweep.run(batches, 0))
        first_ms = clock.s * 1e3
        counted = kernel_launches()
        # ---- end of the counted run
        check(counted == {name: len(batches), SORT_NAME: len(batches)},
              "%s sweep launched %s for %d steps" % (compute, counted,
                                                     len(batches)))
        check(dispatch.last_dispatch("train_loop")["path"] == "graph",
              "%s: the sweep did not run as a graph" % compute)
        held(bundle, losses, "graph sweep")
        counts[name] = counted[name]
        counts[SORT_NAME] = counts.get(SORT_NAME, 0) + counted[SORT_NAME]
        chunked_bundle, _, chunked = fresh(SWEEP_CHUNK)
        held(chunked_bundle, chunked.fetch(chunked.run(batches, 0)),
             "chunked sweep (%d steps a chunk)" % SWEEP_CHUNK)
        del chunked_bundle, chunked
        # ms/step: further epochs on the counted run's model, in turns
        step = make_train_step(bundle, opt)
        times = epochs_in_turns(torch, SWEEP_TURNS, sweep, step, batches,
                                tables, compute)
        check(len(sweep.capture_s) == 1, "%s: %d captures for one batch "
              "shape" % (compute, len(sweep.capture_s)))
        out[compute] = dict(
            graph_ms_per_step=times["graph"], eager_ms_per_step=times["eager"],
            first_epoch_ms=first_ms, capture_ms=sweep.capture_s[0] * 1e3)
        log("  (a) %s: %d steps as graph replays bitwise phase 7's losses "
            "and parameters, and chunks of %d too; %d launches of %s; "
            "ms/step graph %s, eager %s (turns %s); the first epoch %.1f ms "
            "with its warm-up and a capture of %.1f ms"
            % (compute, len(batches), SWEEP_CHUNK, counted[name], name,
               ["%.3f" % x for x in times["graph"]],
               ["%.3f" % x for x in times["eager"]], ",".join(SWEEP_TURNS),
               first_ms, sweep.capture_s[0] * 1e3))
        del bundle, opt, sweep, step
        torch.cuda.empty_cache()
    return counts, out


def eval_graph_checks(torch, eval_ref):
    """Phase 19 (b): phase 9's split and configuration, the sweep as a
    CUDA graph against eager steps: carries bitwise in every tier and
    equal to phase 9's, the launch counts equal (the counted runs: the
    off tier's graph sweep, 169 launches of the 3-table pool), the wall
    time per batch as slopes over 84 and 168 batches, graph and eager in
    turns, and the capture's host time."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.utils import graphs
    from lirec_tpu_torch.utils.fake_batch import make_tables

    data = eval_ref["split"]
    n_half = EVAL_FULL // 2
    halves = {n: {k: v[: n * EVAL_B] for k, v in data.items()}
              for n in (n_half, EVAL_FULL)}
    tables, out, counts = None, {}, {}
    for compute in ("bfloat16", "float32"):
        dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
        cfg = config_lib.preset("int_rel_ch").with_optim(
            batch_size=EVAL_B).with_runtime(compute_dtype=compute)
        bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
        if tables is None:
            tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
        three = KERNEL_NAMES[("fused_ctx_pool", dtype)]

        def sweep(tier, graph, split=data, ds=None):
            return packed.sweep_carry(
                ds or split_stand_in(), bundle, bundle.model, cfg,
                mode="test", data=split, tables=tables, localize_ctx=tier,
                graph=graph)

        captures, whole = [], {}
        for tier in (False, "tables", "triple"):
            launched = {}
            carries = {}
            for graph in (True, False):
                # ---- a counted run: one sweep of the split
                dispatch.reset_launches()
                with host_clock(torch) as clock:
                    carries[graph] = sweep(tier, graph)
                if not tier:
                    whole["first graph" if graph else "eager"] = clock.s
                launched[graph] = kernel_launches()
                # ---- end of the counted run
                check(dispatch.last_dispatch("eval_sweep")["path"]
                      == ("graph" if graph else "eager"),
                      "%s %s: the sweep's loop" % (compute, tier))
                if graph:
                    captures.append(graphs.CAPTURE_SECONDS[-1] * 1e3)
            for key, v in carries[False].items():
                check(np.array_equal(carries[True][key], v),
                      "%s %s: graph carry %s differs from the eager sweep's"
                      % (compute, tier, key))
                check(np.array_equal(eval_ref["carries"][compute][key], v),
                      "%s %s: carry %s differs from phase 9's"
                      % (compute, tier, key))
            check(launched[True] == launched[False], "%s %s launches: graph "
                  "%s, eager %s" % (compute, tier, launched[True],
                                    launched[False]))
            if not tier:
                check(launched[True] == {three: EVAL_FULL + 1},
                      "%s off-tier graph sweep launched %s"
                      % (compute, launched[True]))
                counts[three] = launched[True][three]
        # wall per batch: slopes over 84 and 168 batches, off tier
        stand_ins = {(g, n): split_stand_in() for g in (True, False)
                     for n in halves}
        for key in stand_ins:
            sweep(False, key[0], halves[key[1]], stand_ins[key])  # warm-up

        def timed_sweep(key, turn):
            return host_ms(torch, lambda _: sweep(
                False, key[0], halves[key[1]], stand_ins[key]))

        order = [(graph, n) for r in range(EVAL_ROUNDS)
                 for graph in ((True, False) if r % 2 == 0
                               else (False, True))
                 for n in (n_half, EVAL_FULL)]
        secs = {key: [ms / 1e3 for ms in times] for key, times in
                in_turns(order, {key: functools.partial(timed_sweep, key)
                                 for key in stand_ins}).items()}
        slopes = {}
        for graph in (True, False):
            t1 = statistics.median(secs[(graph, n_half)])
            t2 = statistics.median(secs[(graph, EVAL_FULL)])
            slopes["graph" if graph else "eager"] = \
                (t2 - t1) / (EVAL_FULL - n_half) * 1e3
        # the whole split again (a cadence eval's second sweep): the graph
        # its first sweep captured
        with host_clock(torch) as clock:
            sweep(False, True)
        whole["later graph"] = clock.s
        check(dispatch.last_dispatch("eval_sweep")["reason"]
              == "cuda: the graph of this key",
              "%s: the split's second graph sweep captured again" % compute)
        out[compute] = dict(ms_per_batch=slopes, capture_ms=captures,
                            whole_split_s=whole,
                            clips_per_s={k: EVAL_B / v * 1e3
                                         for k, v in slopes.items()})
        log("  (b) %s: graph carries bitwise the eager sweep's and phase "
            "9's in every tier, launches equal (%d of %s off-tier); "
            "ms/batch graph %.4f, eager %.4f (slopes over %d and %d "
            "batches, medians of %d rounds; the graphs their warm-ups "
            "captured); captures %s ms; the whole split (%d batches and "
            "the tail): first graph sweep %.4f s (its capture included), a "
            "later one %.4f s, eager %.4f s"
            % (compute, counts[three], three, slopes["graph"],
               slopes["eager"], n_half, EVAL_FULL, EVAL_ROUNDS,
               ["%.1f" % c for c in captures], EVAL_FULL,
               whole["first graph"], whole["later graph"], whole["eager"]))
        del bundle
        torch.cuda.empty_cache()
    return counts, out


def train_cli_sweep_checks(torch, root):
    """Phase 19 (c): the training CLI on the published-widths fixture, one
    epoch with and without --per-batch-train: epoch_sweep_used True and
    False, the train_loop decisions "graph" and "per_batch", the same
    losses."""
    from lirec_tpu_torch.cli import train as train_cli
    from lirec_tpu_torch.ops import dispatch

    got = {}
    for extra, used, path in (([], True, "graph"),
                              (["--per-batch-train"], False, "per_batch")):
        before = dispatch.decisions("train_loop").get(path, 0)
        store = os.path.join(root, "phase19_store%d" % len(extra))
        with host_clock(torch) as clock:
            out = train_cli.main(["--data-root", root, "--device", "cuda",
                                  "--quiet", "--epochs", "1", "--store-root",
                                  store] + dim_args(PUBLISHED_DIMS) + extra)
        secs = clock.s
        train = out["train"]
        check(train["epoch_sweep_used"] is used, "training CLI %s: "
              "epoch_sweep_used %r" % (extra, train["epoch_sweep_used"]))
        check(dispatch.decisions("train_loop").get(path, 0) > before,
              "training CLI %s did not take the %s path" % (extra, path))
        got[path] = dict(losses=train["losses"], s=secs)
    check(got["graph"]["losses"] == got["per_batch"]["losses"],
          "training CLI losses: sweep %s, per batch %s"
          % (got["graph"]["losses"], got["per_batch"]["losses"]))
    log("  (c) cli.train.main, 1 epoch: epoch_sweep_used True (graph, %.1f "
        "s) and False with --per-batch-train (%.1f s), the same loss %r"
        % (got["graph"]["s"], got["per_batch"]["s"],
           got["graph"]["losses"][0]))
    return got


def int_rels_graph_checks(torch, root):
    """Phase 19 (d): phase 18's int_rels eval from its artifact and
    checkpoint. The CLI at its batch of 64 (counted: kernel 8 once per
    split, each split one partial batch, so its tail step) and at a batch
    of INT_RELS_GRAPH_B (counted: kernel 8 once per batch, the full ones
    as graph replays); then the test split's sweep at that batch as a
    graph and eagerly: the rels_table and every counter bit for bit, the
    launches equal."""
    import numpy as np

    from lirec_tpu_torch.cli import common, int_rels
    from lirec_tpu_torch.data.artifact import load_ingest
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch, scatter_accum

    art = os.path.join(root, "phase18", "ingest_int_rels.npz")
    ckpt = os.path.join(root, "phase18", "int_rels.pth.tar")
    # kernel 8 at the score table's shapes: the one-launch path
    name = scatter_accum.SMALL_NAMES[torch.float32]
    fixture = ["--data-root", root, "--compute-dtype", "float32"] + \
        dim_args(PUBLISHED_DIMS)
    args = fixture + ["--resume-path", ckpt, "--quiet", "--ingest-cache",
                      art, "--device", "cuda"]
    cfg = common.config_from_args("int_rels", common.build_parser(
        "int_rels").parse_args(fixture))
    splits = load_ingest(art, cfg)
    out = {}
    for B in (64, INT_RELS_GRAPH_B):
        before = dispatch.decisions("eval_sweep")
        # ---- a counted run: the eval CLI, val and test
        dispatch.reset_launches()
        metrics = int_rels.main(args + ["--batch-size", str(B)])
        torch.cuda.synchronize()
        launched = kernel_launches()
        # ---- end of the counted run
        full = batches = graphed = 0
        for split in ("val", "test"):
            n_full, tail = divmod(len(splits[split]), B)
            full += n_full
            batches += n_full + (tail > 1)
            graphed += n_full > 0
        check(launched.get(name, 0) == batches, "int_rels CLI at B = %d: "
              "%d launches of %s for %d batches" % (
                  B, launched.get(name, 0), name, batches))
        # a split with a full batch sweeps as a graph; one without, as
        # its tail's eager step ("no full batch")
        took = {path: n - before.get(path, 0) for path, n in
                dispatch.decisions("eval_sweep").items()}
        check(took.get("graph", 0) == graphed
              and took.get("eager", 0) == 2 - graphed,
              "int_rels CLI at B = %d: sweeps %s, %d splits with a full "
              "batch" % (B, took, graphed))
        out["B%d" % B] = dict(launches=launched.get(name, 0),
                              full_batches=full, metrics=metrics)
    check(out["B%d" % INT_RELS_GRAPH_B]["full_batches"] > 1,
          "no replay at B = %d" % INT_RELS_GRAPH_B)
    ds = splits["test"]
    bundle = create_model(cfg, ds.n_classes,
                          n_rels=max(len(ds.rels_list) - 1, 0),
                          device="cuda")
    bundle.model.load_state_dict(torch.load(ckpt,
                                            map_location="cpu")["state_dict"])
    # the graph sweep, then the eager one with every scatter call recorded
    # (its ids and rows: the running table, then the batch's updates)
    carries, launches, calls = {}, {}, []
    real = scatter_accum.scatter_accum1  # the sweep's step imports it

    def recording(ids, rows, n_rows):
        calls.append((ids.clone(), rows.clone(), n_rows))
        return real(ids, rows, n_rows)

    for graph in (True, False):
        dispatch.reset_launches()
        scatter_accum.scatter_accum1 = real if graph else recording
        try:
            carries[graph] = packed.sweep_carry(
                ds, bundle, bundle.model, cfg, mode="test",
                batch_size=INT_RELS_GRAPH_B, graph=graph)
        finally:
            scatter_accum.scatter_accum1 = real
        torch.cuda.synchronize()
        launches[graph] = kernel_launches()
    for key, v in carries[False].items():
        check(np.array_equal(carries[True][key], v), "int_rels test "
              "split: graph carry %s differs from the eager sweep's" % key)
    check(launches[True] == launches[False], "int_rels launches: graph %s, "
          "eager %s" % (launches[True], launches[False]))
    check(len(calls) == launches[False].get(name, 0), "%d scatter calls "
          "recorded, %s launched" % (len(calls), launches[False]))
    table = None
    for ids, rows, n_rows in calls:
        rows = rows.cpu()
        if table is not None:
            rows = torch.cat([table, rows[n_rows:]])
        table = scatter_accum.scatter_accum1_reference(ids.cpu(), rows,
                                                       n_rows)
    check(np.array_equal(table.numpy(), carries[True]["rels_table"]),
          "the B = %d graph sweep's rels_table is not the in-order sum of "
          "its updates" % INT_RELS_GRAPH_B)
    # kernel 8 held and timed on the first call's own tensors
    ids, rows, n_rows = calls[0]
    idx = ids[:, None].expand(-1, 3).contiguous()
    entry = scatter_case(torch, "kernel 8 at the B = %d int_rels sweep"
                         % INT_RELS_GRAPH_B, idx, [rows], [n_rows],
                         single=True)
    entry["shapes"] = dict(updates=list(rows.shape), rows=n_rows)
    out["kernel"] = entry
    log("  (d) cli.int_rels.main from its artifact: %d launches of %s at B "
        "= 64 (tails only), %d at B = %d (%d full batches as graph "
        "replays after their warm-ups); the test split's rels_table [%d, "
        "%d] and counters bitwise the eager sweep's, launches equal (%s), "
        "and the table bitwise the CPU's in-order sum of the %d recorded "
        "calls' update rows"
        % (out["B64"]["launches"], name,
           out["B%d" % INT_RELS_GRAPH_B]["launches"], INT_RELS_GRAPH_B,
           out["B%d" % INT_RELS_GRAPH_B]["full_batches"],
           *carries[True]["rels_table"].shape, launches[True], len(calls)))
    return out


def sweeps_phase(torch, local, train_finals, eval_ref, root):
    """Phase 19. Returns ({kernel name: launches of the counted runs of
    (a) and (b)}, the numbers logged, kernel 8's entry at (d)'s inputs)."""
    train_counts, train = train_sweep_checks(torch, local, train_finals)
    eval_counts, evals = eval_graph_checks(torch, eval_ref)
    cli = train_cli_sweep_checks(torch, root)
    rels = int_rels_graph_checks(torch, root)
    k8 = rels.pop("kernel")
    return dict(train_counts, **eval_counts), dict(
        train=train, eval=evals, cli=cli, int_rels={
            k: {kk: vv for kk, vv in v.items() if kk != "metrics"}
            for k, v in rels.items()}), k8


# ------------------------------------------- phase 22: Orbax checkpoints


ORBAX_STEPS = 3  # phase 7's batches behind (d)'s train state
# a zstd frame of level-1 compressed blocks (Huffman literals, 4 streams),
# as tensorstore writes an Orbax chunk in zarr: 40,960 f32 values
# of np.random.default_rng(0).standard_normal, the card host having no
# zstd compressor
LEVEL1_FRAME = "lirec_tpu_torch/native/normal_f32_level1.zst"


def host_state(model, optimizer):
    """(parameters, {name: Adam state}) copied to the host."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    adam = {names[id(p)]: {k: v.detach().cpu().clone()
                           for k, v in st.items()}
            for p, st in optimizer.state.items()}
    return params, adam


def same_state(torch, got, want, label):
    """Parameters and Adam moments bitwise, the step counts equal."""
    (gp, ga), (wp, wa) = got, want
    check(set(gp) == set(wp) and set(ga) == set(wa),
          "%s: other parameters or Adam states" % label)
    for k, v in wp.items():
        check(torch.equal(gp[k], v), "%s: parameter %s differs" % (label, k))
    for n, st in wa.items():
        for k in ("exp_avg", "exp_avg_sq"):
            check(torch.equal(ga[n][k], st[k]), "%s: %s of %s differs"
                  % (label, k, n))
        check(float(ga[n]["step"]) == float(st["step"]),
              "%s: step of %s %s, written %s" % (label, n, ga[n]["step"],
                                                 st["step"]))


def decode_rate(frame, size, reps=9):
    """The zstd decoder's MB/s (decoded bytes) on one frame: the median of
    `reps` decodes into one buffer."""
    import numpy as np

    from lirec_tpu_torch.native import bindings

    out = np.empty(size, np.uint8)
    sizes = []
    times = host_ms(None, lambda _: sizes.append(
        bindings.zstd_decompress(frame, out=out).size), reps)
    for n in sizes:
        check(n == size, "the frame decoded to %d bytes, not %d" % (n, size))
    return size / (statistics.median(times) / 1e3) / 1e6


def disk_mb(path):
    if os.path.isfile(path):
        return os.path.getsize(path) / 1e6
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e6


def orbax_phase(torch, local):
    """Phase 22: the JAX package's Orbax checkpoints on the card host.
    (a) the training CLI at published widths under --checkpoint-backend
    orbax --checkpoint-every 1 (latest.ckpt and 0.ckpt Orbax directories,
    best-n msgpack files); (b) --auto-resume from that latest.ckpt for one
    more epoch, starting from the parameters and Adam state written,
    bitwise; (c) the int_rel_ch eval CLI on the final Orbax directory, bf16
    and f32 (counted: kernels 1-2), equal to its run on a msgpack .ckpt
    of the same weights, kernels 1-2 held and timed on its first pool
    call; (d) a published-width int_rel_ch train state after ORBAX_STEPS
    of phase 7's steps written and read back through both backends,
    bitwise, with the seconds, MB on disk and the decoder's MB/s. Returns
    (launches of (c), kernels 1-2's entries, the numbers logged)."""
    import math

    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.checkpoint import load_jax_checkpoint, ocdbt
    from lirec_tpu_torch.checkpoint.saver import (
        save_params, save_train_state_any,
    )
    from lirec_tpu_torch.cli import int_rel_ch
    from lirec_tpu_torch.cli import train as train_cli
    from lirec_tpu_torch.models import tabular
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.models.tabular import EmbeddedTables
    from lirec_tpu_torch.native import bindings
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.ops.gather_pool import fused_ctx_pool
    from lirec_tpu_torch.ops.scatter_accum import KERNEL_NAMES
    from lirec_tpu_torch.train import loop
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    out = {"card": card_line()}
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root, **PUBLISHED_FIXTURE)
        store = os.path.join(root, "store")
        dims = ["--data-root", root, "--device", "cuda", "--quiet"] + \
            dim_args(PUBLISHED_DIMS)
        base = dims + ["--store-root", store, "--checkpoint-backend",
                       "orbax"]

        # (a) one epoch, a train state every epoch; the state written as
        # latest.ckpt kept on the host
        written = {}
        real_save = loop.save_train_state_any

        def saving(path, model, optimizer, epoch, backend):
            if os.path.basename(path) == "latest.ckpt":
                written["state"] = host_state(model, optimizer)
            return real_save(path, model, optimizer, epoch, backend)

        loop.save_train_state_any = saving
        try:
            first = train_cli.main(base + ["--epochs", "1",
                                           "--checkpoint-every", "1"])
        finally:
            loop.save_train_state_any = real_save
        check(math.isfinite(first["train"]["losses"][0]),
              "(a) losses %s" % first["train"]["losses"])
        for name in ("latest.ckpt", "0.ckpt"):
            path = os.path.join(store, name)
            check(os.path.isfile(os.path.join(path, "_METADATA")),
                  "(a) %s is not an Orbax directory" % name)
        best = [os.path.join(d, f) for d, _, files in os.walk(store)
                for f in files if f.startswith("v") and f.endswith(".ckpt")]
        check(best and all(os.path.isfile(f) for f in best),
              "(a) no best-n msgpack files: %s" % best)
        out["a_latest_MB"] = disk_mb(os.path.join(store, "latest.ckpt"))
        log("  (a) cli.train.main --checkpoint-backend orbax, 1 epoch: loss "
            "%s; latest.ckpt and 0.ckpt Orbax directories (%.1f MB each), "
            "%d best-n msgpack files" % (first["train"]["losses"],
                                         out["a_latest_MB"], len(best)))

        # (b) --auto-resume from that latest.ckpt
        seen = {}
        real_train = loop.train

        def starting(cfg, bundle, *args, optimizer=None, **kw):
            seen["state"] = host_state(bundle.model, optimizer)
            return real_train(cfg, bundle, *args, optimizer=optimizer, **kw)

        loop.train = starting
        try:
            resumed = train_cli.main(base + ["--epochs", "2",
                                             "--auto-resume"])
        finally:
            loop.train = real_train
        check(resumed["train"]["start_epoch"] == 1
              and len(resumed["train"]["losses"]) == 1
              and math.isfinite(resumed["train"]["losses"][0]),
              "(b) resumed run %s" % resumed["train"])
        same_state(torch, seen["state"], written["state"], "(b) resumed")
        log("  (b) --auto-resume from the Orbax latest.ckpt: epoch 1, loss "
            "%s; the %d parameters and their Adam state bitwise those "
            "written" % (resumed["train"]["losses"],
                         len(written["state"][0])))

        # (c) the eval CLI on the final Orbax directory (counted), and on a
        # msgpack .ckpt of the same weights
        final = os.path.join(store, "1.ckpt")
        first_call = {}
        real_pool = tabular.fused_ctx_pool

        def recording(emb, idx, mask, guard):
            first_call.setdefault(emb.clip.dtype, (
                EmbeddedTables(*(t.clone() for t in emb)), idx.clone(),
                mask.clone(), guard))
            return real_pool(emb, idx, mask, guard)

        metrics = {}
        dispatch.reset_launches()
        tabular.fused_ctx_pool = recording
        try:
            for compute in ("bfloat16", "float32"):
                metrics[compute] = int_rel_ch.main(dims + [
                    "--resume-path", final, "--compute-dtype", compute])
        finally:
            tabular.fused_ctx_pool = real_pool
        torch.cuda.synchronize()
        launched = kernel_launches()
        msgpack_file = os.path.join(root, "same_weights.ckpt")
        state, _, _ = load_jax_checkpoint(final)
        save_params(msgpack_file, state)
        for compute, got in metrics.items():
            want = int_rel_ch.main(dims + ["--resume-path", msgpack_file,
                                           "--compute-dtype", compute])
            check(got == want, "(c) %s: the eval CLI's metrics from the "
                  "Orbax directory %s, from msgpack %s" % (compute, got,
                                                          want))
            log("  (c) cli.int_rel_ch.main %s on the Orbax 1.ckpt: val %s, "
                "test %s, equal to the msgpack .ckpt's" % (
                    compute, got["val"], got["test"]))
        pool = {}
        for dtype, tag, atol in ((torch.float32, "f32", 2e-6),
                                 (torch.bfloat16, "bf16", 1e-5)):
            check(dtype in first_call, "(c) the eval CLI on the Orbax "
                  "directory made no %s pool call" % tag)
            emb, idx, mask, guard = first_call[dtype]
            ms = median_ms(torch, lambda: fused_ctx_pool(emb, idx, mask,
                                                         guard))
            div = (guarded_div(torch, mask) if guard
                   else mask.sum(-1, keepdim=True))
            pool[tag] = eval_pool_entry(torch, tag + "@orbax", emb, idx,
                                        mask, mask.to(dtype), div, ms, atol,
                                        guard)
            pool[tag]["shapes"] = dict(
                M=idx.shape[0], R=idx.shape[1], guard=guard,
                clip=list(emb.clip.shape), tracks=list(emb.tr1.shape))
            log("  (c) the %s pool's inputs: %s" % (tag, pool[tag]["shapes"]))
    del first_call

    # (d) a published-width train state through both backends
    cfg = config_lib.preset("int_rel_ch").with_runtime(
        compute_dtype="bfloat16")
    bundle = create_model(cfg, 101, n_rels=15, seed=0, device="cuda")
    tables = {k: torch.from_numpy(v).cuda() for k, v in make_tables(
        bundle.spec, N_CLIPS, N_TRACKS, seed=0).items()}
    opt = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                         cfg.optim.weight_decay)
    step = make_train_step(bundle, opt)
    dispatch.reset_launches()
    for i, batch in enumerate(local[:ORBAX_STEPS]):
        step(batch, tables, step_generators(0, i, "cuda"))
    torch.cuda.synchronize()
    steps = kernel_launches()
    name = KERNEL_NAMES[torch.bfloat16]
    check(steps.get(name, 0) == ORBAX_STEPS, "(d) %d launches of %s for %d "
          "steps" % (steps.get(name, 0), name, ORBAX_STEPS))
    want = host_state(bundle.model, opt)
    moved = sum(bool(st["exp_avg"].abs().sum()) for st in want[1].values())
    check(moved > 0, "(d) every Adam moment is zero after %d steps"
          % ORBAX_STEPS)
    state_mb = sum(v.numel() * 4 for v in want[0].values()) / 1e6
    log("  (d) %d steps (%d launches of %s): %d of %d parameters' Adam "
        "moments non-zero" % (ORBAX_STEPS, steps.get(name, 0), name, moved,
                              len(want[1])))
    with tempfile.TemporaryDirectory() as work:
        for backend in ("msgpack", "orbax"):
            path = os.path.join(work, "%s.ckpt" % backend)
            with host_clock(torch) as clock:
                save_train_state_any(path, bundle.model, opt, ORBAX_STEPS,
                                     backend)
            write_s = clock.s
            with host_clock(torch) as clock:
                params, adam, epoch = load_jax_checkpoint(
                    path, bundle.model, opt)
            read_s = clock.s
            check(epoch == ORBAX_STEPS, "(d) %s: epoch %d" % (backend,
                                                            epoch))
            names = {i: n for i, (n, _) in enumerate(
                bundle.model.named_parameters())}
            same_state(torch, (params, {names[i]: st for i, st in
                                        adam["state"].items()}),
                       want, "(d) %s round trip" % backend)
            out["d_" + backend] = dict(write_s=write_s, read_s=read_s,
                                       MB=disk_mb(path))
            log("  (d) %s: train state of %.1f MB of parameters (and Adam's "
                "two moments): write %.3f s, read %.3f s, %.1f MB on disk; "
                "bitwise" % (backend, state_mb, write_s, read_s,
                             out["d_" + backend]["MB"]))
            if backend == "orbax":
                reader = ocdbt.Reader(path)
                chunks = [k for k in reader.keys()
                          if not k.endswith(b".zarray")]
                frames = {k: reader.read(k) for k in chunks}
                largest = max(frames, key=lambda k: len(frames[k]))
                size = bindings.zstd_content_size(frames[largest])
                out["d_decode_MB_per_s_largest"] = decode_rate(
                    frames[largest], size)
                out["d_largest_chunk"] = largest.decode()
                log("  (d) the decoder on the largest chunk (%s, %.1f MB, "
                    "raw blocks as the port writes them): %.0f MB/s" % (
                        largest.decode(), size / 1e6,
                        out["d_decode_MB_per_s_largest"]))
    with open(os.path.join(ROOT, LEVEL1_FRAME), "rb") as f:
        frame = f.read()
    values = np.random.default_rng(0).standard_normal(40960).astype(
        np.float32)
    check(bindings.zstd_decompress(frame, values.nbytes).tobytes()
          == values.tobytes(), "(d) the level-1 frame decodes to other "
          "values")
    out["d_decode_MB_per_s_level1"] = decode_rate(frame, values.nbytes,
                                                  reps=51)
    log("  (d) the decoder on a level-1 frame of normal f32 (%s, %d -> %d "
        "bytes): %.0f MB/s; card %s" % (
            LEVEL1_FRAME, len(frame), values.nbytes,
            out["d_decode_MB_per_s_level1"], out["card"]))
    del bundle, opt, step, tables
    torch.cuda.empty_cache()
    return launched, pool, out


# ------------------------------------- phase 23: the grounding configurations


# (a)-(b): epochs of the graph sweep and of the per-batch eager steps in turns
GROUNDING_TURNS = ("eager", "graph", "graph", "eager")
LONG_CONTEXT = (2048, 2049, 4096)  # (d): R around and past the chunk
LONG_PAIRS = (2100, 4096)  # (d): the rels-only stand-in's two long pairs
# (b): how far apart the plain forward's two best track scores must be for
# the served best track to equal its own (bf16 compute: the served and the
# plain forward round their GEMMs' inputs at other points, 2e-3 of a logit)
TRACK_TIE = 4e-3


def int_ch_layout(batch):
    """A structured batch in int_rel_ch's layout cut to int_ch's: no
    context (feat_idx [B, T, 1, 3]) and no relationship mask."""
    import numpy as np

    out = {k: v for k, v in batch.items() if k != "rels_mask"}
    out["feat_idx"] = np.ascontiguousarray(batch["feat_idx"][:, :, :1])
    return out


def params_equal(torch, a, b):
    return all(torch.equal(p.detach(), q.detach()) for p, q in
               zip(a.model.parameters(), b.model.parameters()))


def sweep_and_steps(torch, label, fresh, batches, tables, expect):
    """The epoch sweep's CUDA graph (the counted run, from a fresh seeded
    model) against the per-batch path (from another): losses finite and
    equal, parameters bitwise; then epochs of each in GROUNDING_TURNS on
    the graph's model. `expect`: the launches the graph's epoch must
    count. Returns (the graph's model, {"graph_ms_per_step", "eager_ms_per
    _step", "capture_ms", "losses"})."""
    import math

    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.train.loop import make_train_step, step_generators
    from lirec_tpu_torch.train.sweep import EpochSweep

    bundle, opt = fresh()
    sweep = EpochSweep(bundle, opt, tables, 0, TRAIN_B, require_graph=True)
    torch.cuda.synchronize()
    # ---- a counted run: one epoch of the sweep's graph
    dispatch.reset_launches()
    losses = sweep.fetch(sweep.run(batches, 0))
    counted = kernel_launches()
    # ---- end of the counted run
    check(counted == expect, "%s: the graph's epoch launched %s, want %s"
          % (label, counted, expect))
    check(dispatch.last_dispatch("train_loop")["path"] == "graph",
          "%s: the sweep did not run as a graph" % label)
    check(all(math.isfinite(x) for x in losses), "%s: losses %s"
          % (label, losses))
    eager_bundle, eager_opt = fresh()
    step = make_train_step(eager_bundle, eager_opt)
    eager = [float(step(b, tables, step_generators(0, i, "cuda")))
             for i, b in enumerate(batches)]
    check(eager == losses, "%s: per-batch losses %s, graph %s"
          % (label, eager, losses))
    check(params_equal(torch, bundle, eager_bundle),
          "%s: the graph's parameters differ from the per-batch path's"
          % label)
    del eager_bundle, eager_opt
    step = make_train_step(bundle, opt)
    times = epochs_in_turns(torch, GROUNDING_TURNS, sweep, step, batches,
                            tables, label)
    return bundle, dict(graph_ms_per_step=times["graph"],
                        eager_ms_per_step=times["eager"],
                        capture_ms=sweep.capture_s[0] * 1e3, losses=losses)


def gt_int_rel_ch_checks(torch, local, eval_ref, card):
    """Phase 23 (a): GT int_rel_ch (tr_correct=True) at published widths
    on phase 7's 10 localized batches, bf16 and f32: the first step's
    gradients with kernel 6 against the plain scatter, the epoch sweep's
    graph (counted: kernel 6 once a step) bitwise the per-batch path,
    ms/step in turns, and the GT model's cadence eval, phase 9's split
    through the eval sweep's graph (counted: kernels 1-2). Returns
    ({kernel name: launches}, {compute: numbers})."""
    import math

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch, scatter_accum
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    cfg = config_lib.preset("int_rel_ch", tr_correct=True)
    check(cfg.tasks.tr_correct, "the GT preset is not tr_correct")
    counts, out = {}, {}
    np_tables = tables = None
    for compute in ("bfloat16", "float32"):
        dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
        ccfg = cfg.with_runtime(compute_dtype=compute)
        scatter = scatter_accum.KERNEL_NAMES[dtype]
        pool = KERNEL_NAMES[("fused_ctx_pool", dtype)]

        def fresh():
            bundle = create_model(ccfg, 101, n_rels=15, seed=0,
                                  device="cuda")
            return bundle, make_optimizer(bundle.model.parameters(),
                                          ccfg.optim.lr,
                                          ccfg.optim.weight_decay)

        bundle, _ = fresh()
        if tables is None:
            np_tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
            tables = {k: torch.from_numpy(v).cuda()
                      for k, v in np_tables.items()}
        with_kernel = step_grads(torch, bundle, local[0], tables, True)
        plain = step_grads(torch, bundle, local[0], tables, False)
        torch.cuda.synchronize()
        rel = 4.1e-3 if compute == "bfloat16" else 1e-5  # as phase 7
        worst = 0.0
        for n, g in with_kernel.items():
            scale = float(plain[n].abs().max())
            err = float((g - plain[n]).abs().max())
            check(bool(torch.isfinite(g).all()) and err <= rel * scale,
                  "GT int_rel_ch %s: grad %s differs from the plain "
                  "scatter's by %.3e (scale %.3e)" % (compute, n, err, scale))
            worst = max(worst, err / scale if scale else err)
        del bundle, with_kernel, plain

        bundle, numbers = sweep_and_steps(
            torch, "GT int_rel_ch %s" % compute, fresh, local, tables,
            {scatter: len(local), scatter_accum.SORT_NAME: len(local)})
        counts[scatter] = len(local)
        counts[scatter_accum.SORT_NAME] = (
            counts.get(scatter_accum.SORT_NAME, 0) + len(local))
        ecfg = ccfg.with_optim(batch_size=EVAL_B)
        # ---- a counted run: the GT model's cadence sweep of the split
        dispatch.reset_launches()
        with host_clock(torch) as clock:
            carry = packed.sweep_carry(
                split_stand_in(), bundle, bundle.model, ecfg, mode="test",
                data=eval_ref["split"], tables=np_tables)
        eval_s = clock.s
        launched = kernel_launches()
        # ---- end of the counted run
        check(launched == {pool: EVAL_FULL + 1}, "GT int_rel_ch %s cadence "
              "sweep launched %s" % (compute, launched))
        check(dispatch.last_dispatch("eval_sweep")["path"] == "graph",
              "GT int_rel_ch %s: the cadence sweep was not a graph"
              % compute)
        check(math.isfinite(float(carry["loss_sum"]))
              and int(carry["total_cl"]) == len(eval_ref["split"]["labels"]),
              "GT int_rel_ch %s carry %s" % (compute, carry))
        counts[pool] = launched[pool]
        numbers.update(grad_worst=worst, eval_s=eval_s)
        out[compute] = numbers
        log("  (a) GT int_rel_ch %s: step grads with kernel 6 vs the plain "
            "scatter: worst |diff| / scale %.3e (bound %.1e); %d steps as "
            "graph replays (%d launches of %s) bitwise the per-batch path, "
            "losses %.4f .. %.4f; ms/step graph %s, eager %s (turns %s); "
            "capture %.1f ms; the cadence sweep of %d samples %.3f s (%d "
            "launches of %s) (%s)" % (
                compute, worst, rel, len(local), counts[scatter], scatter,
                numbers["losses"][0], numbers["losses"][-1],
                ["%.3f" % x for x in numbers["graph_ms_per_step"]],
                ["%.3f" % x for x in numbers["eager_ms_per_step"]],
                ",".join(GROUNDING_TURNS), numbers["capture_ms"],
                len(eval_ref["split"]["labels"]), eval_s, counts[pool], pool,
                card))
        del bundle
        torch.cuda.empty_cache()
    return counts, out


def check_int_ch_predictions(preds, B, label):
    import math

    check(len(preds) == B, "%s: %d predictions for %d samples"
          % (label, len(preds), B))
    for p in preds:
        check(len(p["track_scores"]) == 20 and 0 <= p["best_track"] < 20,
              "%s: the track hypotheses" % label)
        check("relationships" not in p, "%s: relationships" % label)
        check(len(p["interactions"]) == TOPK, "%s: top-k" % label)
        for it in p["interactions"] + [{"label": 0, "score": s}
                                       for s in p["track_scores"]]:
            check(0 <= it["label"] < 101 and math.isfinite(it["score"])
                  and 0 <= it["score"] <= 1, "%s: %r" % (label, it))


def int_ch_serving(torch, root, card):
    """Phase 23 (b), serving: weak and GT int_ch engines built by the
    serve CLI's own ``build_engine_from_args`` on seeded checkpoints of
    the published-width fixture (bf16, the preset's compute), /predict at
    B = 1, 7 and 64 over HTTP; every prediction checked, and its best
    track equal to the plain forward's (the dense forward over the raw
    tables, ``features`` [B, T, D]) wherever that forward's two best
    track scores are TRACK_TIE apart. No kernel launches. Returns
    {variant_B: median ms}."""
    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.cli.serve import build_engine_from_args, make_parser
    from lirec_tpu_torch.data.dataset import InteractionDataset
    from lirec_tpu_torch.evaluation.metrics import _sigmoid
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.utils.fake_batch import make_batch

    cfg = config_lib.preset("int_ch", data_root=root).with_dims(
        text_dim=768, visual_dim=2048, text_layers=12, joint_dim=512)
    ds = InteractionDataset(cfg, mode="test")  # what the builder sizes by
    ds.cache()
    raw = {k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
           for k, v in ds.tables.as_dict().items()
           if k in ("text", "visual", "track")}
    latency, ties = {}, 0
    for variant, seed in (("weak", 0), ("gt", 1)):
        ckpt = os.path.join(root, "%s_int_ch_sum_max.pth.tar" % variant)
        torch.save({"state_dict": create_model(
            cfg, ds.n_classes, n_rels=0, seed=seed,
            device="cpu").model.state_dict()}, ckpt)
        engine = build_engine_from_args(make_parser().parse_args([
            "--data-root", root, "--preset", "int_ch", "--resume-path",
            ckpt, "--device", "cuda", "--topk", str(TOPK)]
            + dim_args(PUBLISHED_DIMS)))
        spec = engine.bundle.spec
        check((spec.ctx, spec.tr_maximize, spec.joint_dim, engine.n_ctx)
              == (False, True, 512, 1), "int_ch engine %s" % (spec,))
        with counted_none(torch, "int_ch /predict"):
            with serving(engine) as base:
                for B in B_SIZES:
                    batch = int_ch_layout(make_batch(
                        spec, B, engine.n_clip_rows, engine.n_track_rows,
                        seed=2300 + B))
                    payload = {"samples": [{"feat_idx": f.tolist()}
                                           for f in batch["feat_idx"]]}
                    answers = []
                    times = host_ms(torch, lambda _: answers.append(
                        http(base + "/predict", payload)),
                        1 + {1: 10, 64: 5}.get(B, 3))
                    for status, res in answers:
                        check(status == 200, "int_ch %s B=%d: %s %s"
                              % (variant, B, status, res))
                        check_int_ch_predictions(
                            res["predictions"], B,
                            "int_ch %s B=%d" % (variant, B))
                    fi = torch.from_numpy(batch["feat_idx"]).cuda()
                    with torch.inference_mode():
                        logits = engine.bundle.apply(engine.bundle.model, {
                            "features": dense_of(torch, raw, fi)[:, :, 0]
                        })["inters"]
                    s = _sigmoid(logits.float().cpu().numpy().astype(
                        np.float64)).max(axis=-1)  # [B, T]
                    for b, p in enumerate(res["predictions"]):
                        top = np.sort(s[b])[::-1]
                        if top[0] - top[1] > TRACK_TIE:
                            check(p["best_track"] == int(s[b].argmax()),
                                  "int_ch %s B=%d sample %d: best track %d, "
                                  "the plain forward's %d" % (
                                      variant, B, b, p["best_track"],
                                      int(s[b].argmax())))
                        else:
                            ties += 1
                    key = "%s_B%d" % (variant, B)
                    latency[key] = statistics.median(times[1:])
                    log("  (b) int_ch %s /predict B=%-2d median %.2f ms over "
                        "%d requests, %.0f clips/s (%s)" % (
                            variant, B, latency[key], len(times) - 1,
                            B / latency[key] * 1e3, card))
        del engine
    log("  (b) every best track equal to the plain dense forward's (%d "
        "samples within %.0e of a tie left out)" % (ties, TRACK_TIE))
    torch.cuda.empty_cache()
    return latency


def int_ch_checks(torch, raw, eval_ref, root, card):
    """Phase 23 (b): int_ch, weak and GT (tr_correct), at published widths:
    serving (``int_ch_serving``); phase 9's split in int_ch's layout
    through the eval sweep as a graph and eagerly in GROUNDING_TURNS, every
    counter equal; phase 7's 10 batches in int_ch's layout through the
    epoch sweep's graph bitwise the per-batch path, bf16 and f32. No
    kernel launches anywhere. Returns the numbers."""
    import math

    import numpy as np

    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.localize import Localizer
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch
    from lirec_tpu_torch.train.optim import make_optimizer
    from lirec_tpu_torch.utils.fake_batch import make_tables

    out = {"latency_ms": int_ch_serving(torch, root, card),
           "eval": {}, "train": {}}
    data = int_ch_layout(eval_ref["split"])
    n = len(data["labels"])
    np_tables = tables = None
    for variant, tr_correct in (("weak", False), ("gt", True)):
        cfg = config_lib.preset("int_ch", tr_correct=tr_correct)
        for compute in ("bfloat16", "float32"):
            ccfg = cfg.with_runtime(compute_dtype=compute)
            label = "int_ch %s %s" % (variant, compute)

            def fresh():
                bundle = create_model(ccfg, 101, n_rels=0, seed=0,
                                      device="cuda")
                return bundle, make_optimizer(bundle.model.parameters(),
                                              ccfg.optim.lr,
                                              ccfg.optim.weight_decay)

            bundle, _ = fresh()
            spec = bundle.spec
            if tables is None:
                check((spec.text_dim, spec.visual_dim, spec.track_dim,
                       spec.joint_dim, spec.ctx, spec.gates)
                      == (768, 2048, 2048, 512, False, False),
                      "int_ch published widths: %s" % (spec,))
                np_tables = make_tables(spec, N_CLIPS, N_TRACKS, seed=0)
                tables = {k: torch.from_numpy(v).cuda()
                          for k, v in np_tables.items()}
                localizer = Localizer(spec, N_CLIPS, N_TRACKS)
                batches = localizer.maybe_localize(
                    [int_ch_layout(b) for b in raw])
            ecfg = ccfg.with_optim(batch_size=EVAL_B)
            carries = {}

            def eval_turn(kind, turn):
                got = []
                times = host_ms(torch, lambda _: got.append(
                    packed.sweep_carry(
                        split_stand_in(), bundle, bundle.model, ecfg,
                        mode="test", data=data, tables=np_tables,
                        graph=kind == "graph")))
                check(dispatch.last_dispatch("eval_sweep")["path"]
                      == kind, "%s: the sweep's loop" % label)
                carries.setdefault(kind, got[0])
                return times

            with counted_none(torch, label + " eval sweep"):
                secs = {kind: [ms / 1e3 for ms in times] for kind, times in
                        in_turns(GROUNDING_TURNS, {
                            kind: functools.partial(eval_turn, kind)
                            for kind in ("graph", "eager")}).items()}
            for key, v in carries["eager"].items():
                check(np.array_equal(carries["graph"][key], v),
                      "%s: graph carry %s %s, eager %s"
                      % (label, key, carries["graph"][key], v))
            check(int(carries["graph"]["total_cl"]) == n
                  and math.isfinite(float(carries["graph"]["loss_sum"])),
                  "%s carry %s" % (label, carries["graph"]))
            rate = {k: n / statistics.median(v) for k, v in secs.items()}
            out["eval"]["%s_%s" % (variant, compute)] = dict(
                split_s={k: v for k, v in secs.items()}, clips_per_s=rate)
            del bundle
            with counted_none(torch, label + " training"):
                _, numbers = sweep_and_steps(torch, label, fresh, batches,
                                             tables, {})
            out["train"]["%s_%s" % (variant, compute)] = numbers
            log("  (b) %s: the split's %d samples, graph carries equal to "
                "the eager sweep's (top1 %d, trks_top1 %d of %d); whole "
                "split graph %s s, eager %s s (%.0f / %.0f clips/s); %d "
                "steps (Localizer %s) as graph replays bitwise the "
                "per-batch path, losses %.4f .. %.4f; ms/step graph %s, "
                "eager %s; no kernel launched (%s)" % (
                    label, n, int(carries["graph"]["top1"]),
                    int(carries["graph"]["trks_top1"]), n,
                    ["%.4f" % x for x in secs["graph"]],
                    ["%.4f" % x for x in secs["eager"]], rate["graph"],
                    rate["eager"], len(batches),
                    "applied" if localizer.applied else "not applied: no "
                    "ctx tables", numbers["losses"][0],
                    numbers["losses"][-1],
                    ["%.3f" % x for x in numbers["graph_ms_per_step"]],
                    ["%.3f" % x for x in numbers["eager_ms_per_step"]],
                    card))
            torch.cuda.empty_cache()
    return out


def grounding_clis(torch, root):
    """Phase 23 (c), on the published-width fixture: the int_ch eval CLI
    without and with --tr-correct on seeded msgpack checkpoints (weak,
    GT), each split's metrics equal to the in-process eval sweep's on the
    same weights (no kernel launches); the training CLI for int_ch and for
    int_rel_ch under --tr-correct: 2 epochs (one cadence eval, at epoch
    0), a train state written, then one more epoch resumed from it
    (int_rel_ch's counted: kernels 1-2 and 6 must launch, int_ch's
    nothing). Returns the numbers."""
    import math

    from lirec_tpu_torch.checkpoint.saver import load_train_state, save_params
    from lirec_tpu_torch.cli import common
    from lirec_tpu_torch.cli import int_ch as int_ch_cli
    from lirec_tpu_torch.cli import train as train_cli
    from lirec_tpu_torch.cli.serve import load_checkpoint_state
    from lirec_tpu_torch.evaluation import packed
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch, scatter_accum
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    dims = (["--data-root", root, "--device", DEV, "--quiet"]
            + dim_args(PUBLISHED_DIMS))
    out = {}
    for variant, flag, seed in (("weak", [], 0), ("gt", ["--tr-correct"], 1)):
        cfg = common.config_from_args("int_ch", common.build_parser(
            "int_ch").parse_args(dims + flag))
        check(cfg.tasks.tr_correct == bool(flag), "--tr-correct")
        splits = dict(zip(("train", "val", "test"),
                          common.build_datasets(cfg, "int_ch")))
        ckpt = os.path.join(root, "%s_int_ch.ckpt" % variant)
        save_params(ckpt, create_model(
            cfg, splits["train"].n_classes, n_rels=0, seed=seed,
            device="cpu").model.state_dict())
        with counted_none(torch, "the int_ch eval CLI"):
            with host_clock(torch) as clock:
                got = int_ch_cli.main(dims + flag + ["--resume-path", ckpt])
            secs = clock.s
            bundle = create_model(cfg, splits["train"].n_classes, n_rels=0,
                                  seed=seed + 7, device=DEV)
            bundle.model.load_state_dict(load_checkpoint_state(ckpt))
            want = {split: packed.evaluate_packed(
                splits[split], bundle, bundle.model, cfg, mode=split,
                verbose=False) for split in ("val", "test")}
        same_metrics(got, want, "int_ch eval CLI %s" % variant,
                     "the in-process sweep")
        out["eval_cli_" + variant] = dict(metrics=got, s=secs)
        log("  (c) cli.int_ch.main %s (%s checkpoint): val %s, test %s "
            "(%.1f s), equal to the in-process sweep's" % (
                " ".join(flag) or "(weak)", variant, got["val"],
                got["test"], secs))
        del bundle

    for preset in ("int_ch", "int_rel_ch"):
        store = os.path.join(root, "gt_%s_store" % preset)
        base = [preset] + dims + ["--tr-correct", "--store-root", store]
        dispatch.reset_launches()
        with host_clock(torch) as clock:
            trained = train_cli.main(base + ["--epochs", "2",
                                             "--checkpoint-every", "2"])
        secs = clock.s
        launched = kernel_launches()
        losses = trained["train"]["losses"]
        check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
              "%s --tr-correct training CLI losses %s" % (preset, losses))
        for name in ("index.json", "latest.pth.tar", "1.pth.tar"):
            check(os.path.exists(os.path.join(store, name)),
                  "%s --tr-correct training CLI wrote no %s" % (preset,
                                                                 name))
        with open(os.path.join(store, "index.json")) as f:
            index = json.load(f)
        check(index and all(list(v) == ["0"] for v in index.values()),
              "%s: one cadence eval (epoch 0) wanted: %s" % (preset, index))
        _, _, epoch = load_train_state(os.path.join(store, "latest.pth.tar"))
        check(epoch == 1, "%s latest.pth.tar holds epoch %d" % (preset,
                                                                epoch))
        if preset == "int_ch":
            check(not any(launched.values()), "the int_ch training CLI "
                  "launched kernels: %s" % launched)
        else:
            scatter = scatter_accum.KERNEL_NAMES[torch.bfloat16]
            pool = KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)]
            check(launched.get(scatter, 0) > 0 and launched.get(pool, 0) > 0,
                  "GT int_rel_ch training CLI launches %s: the scatter "
                  "(steps) and the pool (cadence) must both run" % launched)
        resumed = train_cli.main(base + [
            "--epochs", "3", "--resume-train", "--resume-path",
            os.path.join(store, "latest.pth.tar")])
        r_losses = resumed["train"]["losses"]
        check(resumed["train"]["start_epoch"] == 2 and len(r_losses) == 1
              and math.isfinite(r_losses[0]),
              "%s --tr-correct resumed %s" % (preset, resumed["train"]))
        out["train_cli_" + preset] = dict(losses=losses, s=secs,
                                          resumed_losses=r_losses)
        log("  (c) cli.train.main %s --tr-correct: 2 epochs, losses %s in "
            "%.1f s, launches %s, index.json %s; resumed from latest.pth.tar"
            " for epoch 2: loss %s" % (preset, losses, secs, launched,
                                       index, r_losses))
    return out


def long_context_checks(torch, card):
    """Phase 23 (d), kernels past the 2,048-entry chunk: kernels 1-2, 4
    and 5 at M = 64 and R = 2,048, 2,049 and 4,096 on split-scale tables
    (1024 / 256 wide), clip counts in (R / 2, R] padded with weight 0 and
    one all-pad row; each against its plain version (the pools 2e-6 f32,
    1e-5 bf16; kernel 5 bitwise the r-ordered loop), kernel 4 (on the
    rows' unique triples) bitwise kernel 1; each timed (L2 flushed) beside
    its plain version, ``embedding_bag`` and the bound. Returns {entry
    tag: {R: numbers}}."""
    import numpy as np
    import torch.nn.functional as F

    from lirec_tpu_torch.models.tabular import EmbeddedTables
    from lirec_tpu_torch.ops.gather_pool import (
        fused_ctx_pool, fused_ctx_pool_reference, fused_ctx_pool_triple,
        fused_ctx_pool_triple_reference, gather_masked_sum,
        gather_masked_sum_reference,
    )

    atol = {torch.float32: 2e-6, torch.bfloat16: 1e-5}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
        g = torch.Generator(device=DEV).manual_seed(23)
        emb = EmbeddedTables(*(
            torch.randn(n, d, device=DEV, generator=g).to(dtype)
            for n, d in ((N_CLIPS, 1024), (N_TRACKS, 256), (N_TRACKS, 256))))
        for R in LONG_CONTEXT:
            idx = torch.stack(
                [torch.randint(0, n, (EVAL_B, R), device=DEV, generator=g)
                 for n in (N_CLIPS, N_TRACKS, N_TRACKS)], dim=-1
            ).to(torch.int32)
            lengths = np.random.default_rng(R).integers(R // 2 + 1, R + 1,
                                                        EVAL_B)
            mask = (torch.arange(R, device=DEV)[None, :]
                    < torch.from_numpy(lengths).to(DEV)[:, None]).float()
            mask[-1] = 0.0  # a row past a last flush: all pad
            idx[mask == 0] = 0
            idx = idx.contiguous()
            tri, tidx = torch.unique(idx.reshape(-1, 3), dim=0,
                                     return_inverse=True)
            fused = fuse(torch, emb, tri.long()).contiguous()
            tidx = tidx.reshape(EVAL_B, R).to(torch.int32).contiguous()
            one = idx[..., 0].contiguous()
            errs = {"pool": [], "triple": []}
            for guard in (True, False):
                got = fused_ctx_pool(emb, idx, mask, guard)
                tri_out = fused_ctx_pool_triple(fused, tidx, mask, guard)
                torch.cuda.synchronize()
                check(torch.equal(got.isnan(), tri_out.isnan())
                      and torch.equal(torch.nan_to_num(got),
                                      torch.nan_to_num(tri_out)),
                      "R=%d %s guard=%s: kernel 4 not bitwise kernel 1"
                      % (R, tag, guard))
                check(bool(got[-1].isnan().all()) != guard
                      and not bool(got[:-1].isnan().any()),
                      "R=%d %s guard=%s: empty rows" % (R, tag, guard))
                for key, want in (
                        ("pool", fused_ctx_pool_reference(emb, idx, mask,
                                                          guard)),
                        ("triple", fused_ctx_pool_triple_reference(
                            fused, tidx, mask, guard))):
                    nan = want.isnan()
                    check(torch.equal(nan, got.isnan()),
                          "R=%d %s %s: NaN rows" % (R, tag, key))
                    errs[key].append(float((got - want).abs()[~nan].max()))
            for key, e in errs.items():
                check(max(e) <= atol[dtype], "R=%d %s %s: %.3e from the "
                      "plain version" % (R, tag, key, max(e)))
            got = gather_masked_sum(emb.clip, one, mask)
            torch.cuda.synchronize()
            check(torch.equal(got, masked_sum_loop(torch, emb.clip, one,
                                                   mask)),
                  "R=%d %s: kernel 5 not bitwise the r-ordered loop"
                  % (R, tag))
            want = gather_masked_sum_reference(emb.clip, one, mask).float()
            err5 = float((got.float() - want).abs().max())
            scale = float(want.abs().max())
            tol = 1e-5 * scale if dtype == torch.float32 else 2 ** -8 * scale
            check(err5 <= tol, "R=%d %s kernel 5: %.3e from the plain "
                  "version (bound %.1e)" % (R, tag, err5, tol))

            w = mask.to(dtype)
            div = guarded_div(torch, mask)
            cols = index_cols(idx)
            width = emb_width(emb)
            pool_bytes = (sum(gathered_bytes(t, idx[..., k])
                              for k, t in enumerate(emb))
                          + nbytes(idx, mask) + EVAL_B * width * 4)
            ops = 2 * EVAL_B * R * width
            entries = {
                "pool": (errs["pool"], lambda: fused_ctx_pool(
                    emb, idx, mask, True), lambda: fused_ctx_pool_reference(
                    emb, idx, mask, True), lambda: bag_pool(
                    torch, emb, cols, w, div), bound(pool_bytes, ops)),
                "triple": (errs["triple"], lambda: fused_ctx_pool_triple(
                    fused, tidx, mask, True),
                    lambda: fused_ctx_pool_triple_reference(
                        fused, tidx, mask, True),
                    lambda: torch.tanh(F.embedding_bag(
                        tidx, fused, per_sample_weights=w,
                        mode="sum").float() / div),
                    bound(nbytes(fused, tidx, mask) + EVAL_B * width * 4,
                          ops)),
                "gms": ([err5], lambda: gather_masked_sum(
                    emb.clip, one, mask), lambda: gather_masked_sum_reference(
                    emb.clip, one, mask), lambda: F.embedding_bag(
                    one, emb.clip, per_sample_weights=w, mode="sum"),
                    bound(gathered_bytes(emb.clip, one) + nbytes(one, mask)
                          + EVAL_B * 1024 * emb.clip.element_size(),
                          2 * EVAL_B * R * 1024)),
            }
            for key, (e, kernel, plain, library, b) in entries.items():
                ms = median_ms(torch, kernel)
                plain_ms = median_ms(torch, plain)
                lib_ms = median_ms(torch, library)
                results.setdefault("%s_%s" % (key, tag), {})[R] = dict(
                    max_abs_err=max(e), ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, **b)
                log("  (d) %-6s %-4s M=%d R=%-4d: max|diff| vs plain %.3e; "
                    "kernel %.4f ms, plain %.4f ms, embedding_bag %.4f ms; "
                    "bound %.4f ms (%s) (%s)" % (
                        key, tag, EVAL_B, R, max(e), ms, plain_ms, lib_ms,
                        b["bound_ms"], b["bound_by"], card))
            del idx, mask, tri, tidx, fused, one, w, div, cols, entries
            torch.cuda.empty_cache()
        del emb
    return results


def long_rels_only(torch, card):
    """Phase 23 (d), the rels-only eval past 2,048 clips: phase 14's
    stand-in with two more pairs, of LONG_PAIRS clips (both in the 4,096
    bucket), bf16 and f32, one launch per flush (counted), its 4,096
    bucket's launches apart, and metrics equal to the plain pool's.
    Returns {kernel name: launches of the 4,096 bucket}."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.evaluation.runner import evaluate_rels_only
    from lirec_tpu_torch.models.factory import create_model
    from lirec_tpu_torch.ops import dispatch, gather_pool
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES
    from lirec_tpu_torch.utils.fake_batch import make_tables

    counts = {}
    stand_in = tables = None
    launch = gather_pool._launch
    for compute in ("bfloat16", "float32"):
        dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        cfg = config_lib.preset("int_rels").with_runtime(
            compute_dtype=compute)
        bundle = create_model(cfg, 101, n_rels=15, seed=0, device=DEV)
        if stand_in is None:
            tables = make_tables(bundle.spec, N_CLIPS, N_TRACKS, seed=0)
            stand_in = RelsStandIn(bundle.spec, tables, extra=LONG_PAIRS)
            lengths = [it["feat_idx"].shape[0] - 1 for it in stand_in.items]
            flushes, pads = rels_flushes(lengths, EVAL_B)
            check(pads[-1] == 4096 and pads.count(4096) == 1,
                  "long pairs' buckets %s" % pads)
        per_r = {}

        def by_r(op, table, n_ptrs, args):
            per_r[args[7]] = per_r.get(args[7], 0) + 1
            launch(op, table, n_ptrs, args)

        gather_pool._launch = by_r
        try:
            # ---- the counted run: the rels-only eval of the stand-in
            dispatch.reset_launches()
            with host_clock(torch) as clock:
                got = evaluate_rels_only(stand_in, bundle, bundle.model,
                                         cfg, verbose=False,
                                         batch_size=EVAL_B)
            secs = clock.s
            launched = kernel_launches()
            # ---- end of the counted run
        finally:
            gather_pool._launch = launch
        plain = evaluate_rels_only(stand_in, bundle, bundle.model, cfg,
                                   verbose=False, batch_size=EVAL_B,
                                   use_kernel=False)
        check(launched == {name: flushes} and sum(per_r.values()) == flushes,
              "long rels-only %s launched %s (%s by R), want %d of %s"
              % (compute, launched, per_r, flushes, name))
        check(per_r.get(4096, 0) == 1, "the 4,096 bucket's launches: %s"
              % per_r)
        check(got == plain, "long rels-only %s: kernel %s != plain %s"
              % (compute, got, plain))
        counts[name] = per_r[4096]
        log("  (d) rels-only stand-in with pairs of %s clips (%d pairs, "
            "buckets %s), %s: %s, equal to the plain pool's; %d launches of "
            "%s (by R: %s); %.3f s (%s)" % (
                list(LONG_PAIRS), len(stand_in), pads, compute, got,
                launched[name], name, dict(sorted(per_r.items())), secs,
                card))
        del bundle
        torch.cuda.empty_cache()
    return counts


def grounding_phase(torch, raw, local, eval_ref):
    """Phase 23. Returns ({"gt": {kernel name: launches}, "ctx4096":
    {kernel name: launches}}, {"long_context": (d)'s numbers}, the
    numbers logged)."""
    card = card_line()
    with host_clock(torch) as clock:
        gt_counts, gt = gt_int_rel_ch_checks(torch, local, eval_ref, card)
        with tempfile.TemporaryDirectory() as root:
            write_fixture(root, **PUBLISHED_FIXTURE)
            int_ch = int_ch_checks(torch, raw, eval_ref, root, card)
            clis = grounding_clis(torch, root)
        long_ctx = long_context_checks(torch, card)
        ctx_counts = long_rels_only(torch, card)
    secs = clock.s
    log("  phase 23 took %.1f s" % secs)
    return ({"gt": gt_counts, "ctx4096": ctx_counts},
            long_ctx, {"gt_int_rel_ch": gt, "int_ch": int_ch, "clis": clis,
                       "seconds": secs})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from lirec_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card")
    log(card_line())
    log("torch %s, CUDA %s, python %s, %d device(s), using %s"
        % (torch.__version__, torch.version.cuda, sys.version.split()[0],
           torch.cuda.device_count(), torch.cuda.get_device_name(0)))

    log("== 2. build")
    sources = ("fused_ctx_pool", "scatter_accum", "fused_ctx_pool_triple",
               "probe_hbm_dma", "probe_bf16_pack")
    with host_clock(torch) as clock:
        with ThreadPoolExecutor(len(sources)) as pool:
            paths = list(pool.map(build.build, sources))
    log("  built in %.2f s (one nvcc per source, in parallel)" % clock.s)
    for name, path in zip(sources, paths):
        info = build.BUILD_LOGS.get(name)
        log("  %s: %s" % (name, "built in %.2f s" % info["seconds"]
                          if info else "reused"))
        if info:
            log("  " + info["cmd"])
            for line in info["log"].splitlines():
                log("  " + line)
        log("  -> %s" % os.path.relpath(path, ROOT))

    log("== 3. kernels vs plain PyTorch on the card")
    from lirec_tpu_torch.models.spec import ModelSpec

    spec = ModelSpec(n_classes=101, n_rels=15)  # the published widths
    perf = kernel_checks(torch)
    triple = triple_checks(torch, spec)

    log("== 4. int_rel_ch served at published widths")
    counts, latency = main_path(torch)

    log("== 5. CLI entry point")
    entry_point(torch)

    log("== 6. scatter kernel vs plain PyTorch on the card")
    with host_clock(torch) as clock:
        raw, local, caps = train_batches(spec)
    log("  %d structured B=%d batches, localized in %.1f s: caps %d clip / "
        "%d track rows" % (len(raw), TRAIN_B, clock.s, *caps))
    scatter = scatter_checks(torch, spec, raw[0], local[0], caps)

    log("== 7. int_rel_ch training at published widths (counted run)")
    train_counts, step_ms, train_finals = train_path(torch, local)

    log("== 8. train() on a synthetic fixture")
    train_entry(torch)

    log("== 9. int_rel_ch eval sweep at published widths (counted runs)")
    eval_counts, eval_rates, eval_ref = eval_sweep(torch, spec)

    log("== 10. eval CLI entry point")
    eval_cli(torch)

    log("== 11. the probes, kernels 9-10 (counted run)")
    probe_counts, probe = probe_phase(torch)

    log("== 12. the training CLI at published widths (counted run)")
    train_cli_phase(torch)

    card = card_line()
    with tempfile.TemporaryDirectory() as root:
        with host_clock(torch) as clock:
            write_fixture(root, **PUBLISHED_FIXTURE)
        log("  (phases 13-17) fixture of published feature widths written "
            "in %.1f s" % clock.s)
        log("== 13. modalities at published widths: serve, train, eval "
            "sweep, CLI (no kernel)")
        mod = modalities_phase(torch, root, card)

        log("== 14. rels-only eval on kernels 1-2 (counted runs)")
        rels_counts, rels_pool = rels_only_phase(torch, root, card)

        log("== 15. the text-only CLI (no kernel)")
        text_only_phase(torch, root)

        log("== 16. data parallelism: a world of one over NCCL, two ranks "
            "on the card over gloo (counted runs)")
        dist_counts, rank_launches, mesh_graph = dist_phase(
            torch, local, train_finals, step_ms, eval_ref)

        log("== 17. the rest of training: dense forwards and steps, the "
            "prefetch, the assembly workers, --profile, the plan cache")
        rest = rest_of_training_phase(torch, spec, root, raw, local,
                                      train_finals, step_ms)

        log("== 18. the remaining CLIs: ingest artifacts, the eval CLIs "
            "from them, convert-checkpoint, extract-text, verify-features, "
            "graphs-demo (counted runs)")
        ingest_counts, ingest_pool, int_rels_counts, k8, clis = \
            remaining_clis_phase(torch, root, DEV, PUBLISHED_DIMS)

        log("== 19. the one-dispatch sweeps as CUDA graphs: the epoch "
            "sweep, the eval sweep, --per-batch-train, the int_rels eval "
            "(counted runs)")
        graph_counts, sweeps, k8_graph = sweeps_phase(
            torch, local, train_finals, eval_ref, root)

    log("== 20. the model and context mesh axes: 1x2 and 2x2 meshes and a "
        "context group of gloo ranks on the card, a world of one over NCCL "
        "(counted runs)")
    mesh_axes = model_axis_phase(torch, spec, local, caps, train_finals,
                                 step_ms, eval_ref)

    log("== 21. the triple pool's matmul tier against kernel 4")
    matmul_tier = matmul_tier_phase(torch, spec)

    log("== 22. the JAX package's Orbax checkpoints: the training CLI "
        "writes and resumes them, the eval CLI from one, a published-width "
        "train state through both backends (counted runs)")
    orbax_counts, orbax_pool, orbax = orbax_phase(torch, local)

    log("== 23. the grounding configurations: GT int_rel_ch, int_ch weak and "
        "GT (serve, eval sweep, steps, CLIs; no kernel), kernels 1-2, 4 "
        "and 5 past 2,048 context clips (counted runs)")
    grounding_counts, long_ctx, grounding = grounding_phase(
        torch, raw, local, eval_ref)

    from lirec_tpu_torch.ops import scatter_accum
    from lirec_tpu_torch.ops.gather_pool import KERNEL_NAMES

    kernels = []
    # the 3-table pool: the main path is the eval sweep (auto localisation
    # keeps the full tables), on its own structured batch; the serve path's
    # random rows and the giant tables are entries of their own
    for dtype, tag, line in ((torch.float32, "f32", 178),
                             (torch.bfloat16, "bf16", 218)):
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        check(eval_counts.get(name, 0) > 0 and counts.get(name, 0) > 0,
              "%s was not launched by the eval sweep and the server" % name)
        src = dict(route="cuda", source=CU,
                   replaces="%s:%d" % (TPU_SRC, line))
        kernels.append(dict(name=name, launches=eval_counts[name],
                            path="eval", **src, **triple["pool_eval_" + tag]))
        kernels.append(dict(name=name + "@random_rows", launches=counts[name],
                            path="serve", **src, **perf["random_" + tag]))
    f32 = KERNEL_NAMES[("fused_ctx_pool", torch.float32)]
    kernels.append(dict(name=f32 + "@giant_tables", route="cuda", source=CU,
                        replaces="%s:334" % TPU_SRC, launches=counts[f32],
                        path="serve", **perf["giant"]))
    def numbers(r):  # a scatter_case entry without its sort's own
        return {k: v for k, v in r.items() if k != "sort"}

    # scatter: one entry per instantiation at the train path's shapes (three
    # tables at the Localizer's caps); the split-scale, flattened (kernel 7)
    # and single-table (kernel 8) cases of phase 6 are the same kernel on
    # entries of their own, which no counted path launches
    for dtype, tag in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        name = scatter_accum.KERNEL_NAMES[dtype]
        launches = train_counts.get(name, 0)
        check(launches > 0, "%s was not launched by the train path" % name)
        r = scatter[tag]
        kernels.append(dict(name=name, route="cuda", source=SCATTER_CU,
                            replaces="%s:91" % SCATTER_TPU_SRC,
                            launches=launches, path="train", **numbers(r)))
        for suffix, line in (("@split_tables", 91), ("@flat", 49),
                             ("@single_table", 282), ("@B1024", 91)):
            kernels.append(dict(
                name=name + suffix, route="cuda", source=SCATTER_CU,
                replaces="%s:%d" % (SCATTER_TPU_SRC, line), launches=0,
                path="none", **numbers(scatter[tag + suffix])))
        log("scatter %s at caps: the op %.4f ms = the counting sort %.4f ms "
            "(sort_by_row %.4f) + the kernel %.4f ms; launches inside the op "
            "%s" % (tag, r["op_ms"], r["sort_ms"], r["plain_sort_ms"],
                    r["ms"], json.dumps(r["op_split_ms"])))
    # the counting sort in front of kernels 6-8 (one launch count per op):
    # the train path's, at the caps' ids (the same for both dtypes); the
    # split-scale, flattened and single-table ids of phase 6 on entries of
    # their own
    sort_launches = train_counts.get(scatter_accum.SORT_NAME, 0)
    check(sort_launches > 0, "%s was not launched by the train path"
          % scatter_accum.SORT_NAME)
    kernels.append(dict(name=scatter_accum.SORT_NAME, route="cuda",
                        source=SCATTER_CU,
                        replaces="%s:91" % SCATTER_TPU_SRC,
                        launches=sort_launches, path="train",
                        **scatter["float32"]["sort"]))
    for suffix, line in (("@split_tables", 91), ("@flat", 49),
                         ("@single_table", 282), ("@B1024", 91)):
        kernels.append(dict(
            name=scatter_accum.SORT_NAME + suffix, route="cuda",
            source=SCATTER_CU, replaces="%s:%d" % (SCATTER_TPU_SRC, line),
            launches=0, path="none", **scatter["float32" + suffix]["sort"]))
    # and alone past one pass (phase 6's SORT_CASES: passes by digit)
    for key, entry in scatter.items():
        if key.startswith("sort_"):
            kernels.append(dict(
                name="%s@%s" % (scatter_accum.SORT_NAME, key), route="cuda",
                source=SCATTER_CU, replaces="%s:91" % SCATTER_TPU_SRC,
                launches=0, path="none", **entry))
    log("scatter_ops: " + json.dumps({
        k: {key: v[key] for key in ("op_path", "op_ms", "ms", "sorted_ms",
                                     "sort_ms", "plain_sort_ms", "plain_ms",
                                     "path_ms")}
        for k, v in scatter.items() if "op_path" in v}))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        name = KERNEL_NAMES[("fused_ctx_pool_triple", dtype)]
        check(eval_counts.get(name, 0) > 0,
              "%s was not launched by the eval sweep" % name)
        kernels.append({
            "name": name, "route": "cuda", "source": TRIPLE_CU,
            "replaces": "%s:719" % TPU_SRC, "launches": eval_counts[name],
            **triple["triple_" + tag],
        })
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        # no product path calls it: held in phase 3 at the eval batch's
        # shapes, no launches there
        kernels.append({
            "name": KERNEL_NAMES[("gather_masked_sum", dtype)],
            "route": "cuda", "source": TRIPLE_CU,
            "replaces": "%s:106" % TPU_SRC, "launches": 0, "path": "none",
            **triple["gms_" + tag],
        })
    # the bf16 probe (phase 11) runs kernel 5 on the native bf16 table
    # beside kernel 10: held and timed there, one entry per probe shape
    gms_bf16 = KERNEL_NAMES[("gather_masked_sum", torch.bfloat16)]
    for suffix, key in (("@bf16_probe", "gms_probe"),
                        ("@clip_table", "gms_clip")):
        launches = probe_counts.get(gms_bf16, 0)
        check(launches > 0, "%s was not launched by the probes" % gms_bf16)
        kernels.append({
            "name": gms_bf16 + suffix, "route": "cuda", "source": TRIPLE_CU,
            "replaces": "%s:106" % TPU_SRC, "launches": launches,
            "path": "probe", **probe[key],
        })
    from lirec_tpu_torch.ops.probes import KERNEL_NAMES as PROBE_NAMES

    for name, src, replaces, key in (
        (PROBE_NAMES["run_pool"], DMA_CU, "tools/probe_hbm_dma.py:40",
         "run_pool"),
        (PROBE_NAMES["packed_gather_sum"], PACK_CU,
         "tools/probe_bf16_pack.py:30", "pack_probe"),
        (PROBE_NAMES["packed_gather_sum"] + "@clip_table", PACK_CU,
         "tools/probe_bf16_pack.py:30", "pack_clip"),
    ):
        launches = probe_counts.get(name.split("@")[0], 0)
        check(launches > 0, "%s was not launched by the probes" % name)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "path": "probe",
            **probe[key],
        })
    for dtype, line in ((torch.float32, 178), (torch.bfloat16, 218)):
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        check(rels_counts.get(name, 0) > 0,
              "%s was not launched by the rels-only eval" % name)
        kernels.append(dict(name=name + "@rels_only", route="cuda", source=CU,
                            replaces="%s:%d" % (TPU_SRC, line),
                            launches=rels_counts[name], path="rels_only",
                            **rels_pool[name]))
    # phase 16: the same kernels through the data-parallel paths, at the
    # same shapes as their main entries (whose numbers they repeat):
    # launches of the world of one's counted runs and of each rank's run
    for name, entry_of in (
            (KERNEL_NAMES[("fused_ctx_pool", torch.float32)], "eval"),
            (KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)], "eval"),
            (scatter_accum.KERNEL_NAMES[torch.float32], "train"),
            (scatter_accum.KERNEL_NAMES[torch.bfloat16], "train"),
            (scatter_accum.SORT_NAME, "train")):
        main_entry = next(k for k in kernels if k["name"] == name
                          and k.get("path") == entry_of)
        per_rank = [launched.get(name, 0) for launched in rank_launches]
        kernels.append(dict(main_entry, name=name + "@dist", path="dist",
                            launches=dist_counts[name] + sum(per_rank),
                            world_of_one_launches=dist_counts[name],
                            rank_launches=per_rank))
    # phase 16(a): kernel 6 and its sort launched from the mesh step's
    # graph replays over the NCCL world of one, at the train path's shapes
    # (the main entries' numbers)
    for name in (scatter_accum.KERNEL_NAMES[torch.float32],
                 scatter_accum.KERNEL_NAMES[torch.bfloat16],
                 scatter_accum.SORT_NAME):
        main_entry = next(k for k in kernels if k["name"] == name
                          and k.get("path") == "train")
        check(mesh_graph["launches"].get(name, 0) > 0,
              "%s was not launched by the mesh step's graph" % name)
        kernels.append(dict(main_entry, name=name + "@mesh_graph",
                            path="mesh_graph",
                            launches=mesh_graph["launches"][name]))
    # phase 18: kernels 1-2 through the eval CLI from an ingest artifact,
    # held and timed on that run's first pool call, and kernel 8 on the
    # int_rels sweep's own inputs
    for dtype, tag, line in ((torch.float32, "f32", 178),
                             (torch.bfloat16, "bf16", 218)):
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        check(ingest_counts.get(name, 0) > 0,
              "%s was not launched by the eval CLI from an artifact" % name)
        kernels.append(dict(name=name + "@ingest", route="cuda", source=CU,
                            replaces="%s:%d" % (TPU_SRC, line),
                            launches=ingest_counts[name], path="ingest",
                            **ingest_pool[tag]))
    # kernel 8 at the int_rels score table: the one-launch path (the size
    # rule's pick there), and the sorted kernel on the same inputs, which
    # no counted path launches there
    name = scatter_accum.SMALL_NAMES[torch.float32]
    check(int_rels_counts.get(name, 0) >= clis["int_rels"]["batches"],
          "%s launched %d times by the int_rels sweep of %d batches"
          % (name, int_rels_counts.get(name, 0), clis["int_rels"]["batches"]))
    check(k8["op_path"] == "small", "kernel 8 at the int_rels sweep took "
          "the %s path" % k8["op_path"])
    kernels.append(dict(name=name + "@int_rels", route="cuda",
                        source=SCATTER_CU,
                        replaces="%s:282" % SCATTER_TPU_SRC,
                        launches=int_rels_counts[name], path="int_rels",
                        **numbers(k8)))
    kernels.append(dict(numbers(k8),
                        name=scatter_accum.KERNEL_NAMES[torch.float32]
                        + "@int_rels", route="cuda", source=SCATTER_CU,
                        replaces="%s:282" % SCATTER_TPU_SRC,
                        launches=int_rels_counts.get(
                            scatter_accum.KERNEL_NAMES[torch.float32], 0),
                        path="none", ms=k8["sorted_ms"]))
    # phase 19: kernels 1-2 and 6 launched from the sweeps' graph replays,
    # at the shapes of their main entries (whose numbers they repeat), and
    # kernel 8 from the int_rels eval's at a batch of INT_RELS_GRAPH_B,
    # held and timed on that sweep's first scatter call
    for name, entry_of in (
            (KERNEL_NAMES[("fused_ctx_pool", torch.float32)], "eval"),
            (KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)], "eval"),
            (scatter_accum.KERNEL_NAMES[torch.float32], "train"),
            (scatter_accum.KERNEL_NAMES[torch.bfloat16], "train"),
            (scatter_accum.SORT_NAME, "train")):
        main_entry = next(k for k in kernels if k["name"] == name
                          and k.get("path") == entry_of)
        check(graph_counts.get(name, 0) > 0,
              "%s was not launched by phase 19's graphs" % name)
        kernels.append(dict(main_entry, name=name + "@graph", path="graph",
                            launches=graph_counts[name]))
    name = scatter_accum.SMALL_NAMES[torch.float32]
    check(k8_graph["op_path"] == "small", "kernel 8 at the B = %d int_rels "
          "sweep took the %s path" % (INT_RELS_GRAPH_B, k8_graph["op_path"]))
    kernels.append(dict(name=name + "@int_rels_graph", route="cuda",
                        source=SCATTER_CU,
                        replaces="%s:282" % SCATTER_TPU_SRC,
                        launches=sweeps["int_rels"][
                            "B%d" % INT_RELS_GRAPH_B]["launches"],
                        path="int_rels_graph", **numbers(k8_graph)))
    # phase 20: kernels 1-2 in the ranks' cadence sweeps (the main eval
    # entries' shapes and numbers), kernel 6 at the M = 2 shard widths in
    # their steps, kernel 5 in the context-parallel pool
    for name in (KERNEL_NAMES[("fused_ctx_pool", torch.float32)],
                 KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)]):
        main_entry = next(k for k in kernels if k["name"] == name
                          and k.get("path") == "eval")
        kernels.append(dict(main_entry, name=name + "@model_axis",
                            path="model_axis",
                            launches=mesh_axes["launches"][name]))
    for dtype, tag in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        name = scatter_accum.KERNEL_NAMES[dtype]
        kernels.append(dict(name=name + "@model_axis", route="cuda",
                            source=SCATTER_CU,
                            replaces="%s:91" % SCATTER_TPU_SRC,
                            launches=mesh_axes["launches"][name],
                            path="model_axis",
                            **numbers(mesh_axes["tp_scatter"][tag])))
    name = scatter_accum.SORT_NAME
    check(mesh_axes["launches"].get(name, 0) > 0,
          "%s was not launched by the model axis's steps" % name)
    kernels.append(dict(name=name + "@model_axis", route="cuda",
                        source=SCATTER_CU, replaces="%s:91" % SCATTER_TPU_SRC,
                        launches=mesh_axes["launches"][name],
                        path="model_axis",
                        **mesh_axes["tp_scatter"]["float32"]["sort"]))
    name = KERNEL_NAMES[("gather_masked_sum", torch.float32)]
    check(mesh_axes["context_launches"] > 0,
          "%s was not launched by the context-parallel pool" % name)
    kernels.append(dict(name=name + "@context", route="cuda",
                        source=TRIPLE_CU, replaces="%s:106" % TPU_SRC,
                        launches=mesh_axes["context_launches"],
                        path="context", **mesh_axes["context"]))
    # phase 22: kernels 1-2 through the eval CLI on an Orbax directory,
    # held and timed on that run's first pool call
    for dtype, tag, line in ((torch.float32, "f32", 178),
                             (torch.bfloat16, "bf16", 218)):
        name = KERNEL_NAMES[("fused_ctx_pool", dtype)]
        check(orbax_counts.get(name, 0) > 0,
              "%s was not launched by the eval CLI on an Orbax directory"
              % name)
        kernels.append(dict(name=name + "@orbax", route="cuda", source=CU,
                            replaces="%s:%d" % (TPU_SRC, line),
                            launches=orbax_counts[name], path="orbax",
                            **orbax_pool[tag]))
    # phase 23: kernels 1-2 in the GT int_rel_ch model's cadence sweep and
    # kernel 6 in its steps (the main entries' shapes and numbers); kernels
    # 1-2 at the rels-only stand-in's 4,096 bucket, held and timed at
    # M = 64, R = 4,096 (launches: that bucket's flush), and kernels 4-5 at
    # the same shape (no product path launches them there)
    for name, entry_of in (
            (KERNEL_NAMES[("fused_ctx_pool", torch.float32)], "eval"),
            (KERNEL_NAMES[("fused_ctx_pool", torch.bfloat16)], "eval"),
            (scatter_accum.KERNEL_NAMES[torch.float32], "train"),
            (scatter_accum.KERNEL_NAMES[torch.bfloat16], "train"),
            (scatter_accum.SORT_NAME, "train")):
        main_entry = next(k for k in kernels if k["name"] == name
                          and k.get("path") == entry_of)
        check(grounding_counts["gt"].get(name, 0) > 0,
              "%s was not launched by the GT int_rel_ch runs" % name)
        kernels.append(dict(main_entry, name=name + "@gt", path="gt",
                            launches=grounding_counts["gt"][name]))
    for op, src, line in (("fused_ctx_pool", CU, None),
                          ("fused_ctx_pool_triple", TRIPLE_CU, 719),
                          ("gather_masked_sum", TRIPLE_CU, 106)):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            name = KERNEL_NAMES[(op, dtype)]
            key = {"fused_ctx_pool": "pool", "fused_ctx_pool_triple":
                   "triple", "gather_masked_sum": "gms"}[op] + "_" + tag
            if op == "fused_ctx_pool":
                launches = grounding_counts["ctx4096"].get(name, 0)
                check(launches > 0, "%s was not launched by the 4,096 "
                      "bucket" % name)
                line = 178 if dtype == torch.float32 else 218
            else:
                launches = 0
            kernels.append(dict(
                name=name + "@ctx4096", route="cuda", source=src,
                replaces="%s:%d" % (TPU_SRC, line), launches=launches,
                path="rels_only" if launches else "none",
                shapes={"M": EVAL_B, "R": 4096},
                **long_ctx[key][4096]))
    log("long_context: " + json.dumps(long_ctx))
    log("grounding: " + json.dumps(grounding))
    log("orbax: " + json.dumps(orbax))
    log("matmul_tier: " + json.dumps(matmul_tier))
    log("mesh_graph_ms_per_step: " + json.dumps(
        {k: v for k, v in mesh_graph.items() if k != "launches"}))
    log("mesh_ms_per_step: " + json.dumps(mesh_axes["ms"]))
    log("sweeps: " + json.dumps(sweeps))
    log("modalities: " + json.dumps(mod))
    log("eval_clips_per_s: " + json.dumps(
        {"%s_%s" % (c, t if t else "off"): v
         for (c, t), v in eval_rates.items()}))
    log("train_ms_per_step: " + json.dumps(step_ms))
    log("rest_of_training: " + json.dumps(rest))
    log("remaining_clis: " + json.dumps(clis))
    log("latency_ms: " + json.dumps(
        {"%s_B%d" % k: v for k, v in latency.items()}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
