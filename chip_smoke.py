#!/usr/bin/env python3
"""On-card smoke test of vcf2prot_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc;
builds the kernels from ``vcf2prot_tpu_torch/csrc`` itself. Phases, each
failing the run with a non-zero exit:

1. device: the card's name and power limit, the peaks every bound is
   computed from (``vcf2prot_tpu_torch/utils/roofline.py``), torch / CUDA /
   nvcc / Triton;
2. build: K1 (executor), K2 (validator), K3 (window scorer), K4 (its
   gradient), K5 (adam), K6 (the head's tail), K7 (the hidden layers
   after the first), K8 (the fold and its gradient) and K9 (the training
   step's prologue) through
   ``runtime/build.py``, one nvcc per source, all started together;
3. kernel vs plain twin on the card: K1 byte-equal on a cohort pack and
   the executor and output-tile edge packs of ``tests/k1_edges.py``, int32
   and int64, with combined aligned and at an odd address; K2 count-equal
   on valid and corrupted packs (corruptions where its lanes hand over the
   next dst among them), int32 and int64, the arrays aligned, one element
   past alignment and at differing alignments; each timed by its C entry
   point's launches alone on an output or count allocated once, by its
   wrapper and by its plain version, K1 on the first 256 MiB and 128 MiB
   chunks beside a device-to-device ``copy_`` of the tape (its practical
   floor), K2 on the first 256 MiB chunk, beside their bounds; K3 bit-equal to its plain version (the same fp32 sums in the
   same order) over H 8/100/128/512 x k 8/9/11/30 x M
   1/127/2,048/4,095/4,096/4,097/524,287 and the last M on the batch plan
   and the next, and H 100/128 x k 692/3,121 (its table read from device
   memory) x M 127/4,096, x int32/int64 positions at odd byte offsets and
   misaligned views (the positions one element in, the table and biases
   past alignment), each launch's batch-plan count checked against the
   switch (found by bisection over launches), and on the candidate
   windows of a 128 MiB chunk for a 128x1 and a 512x3 head (a full block
   on the persistent plan, no batch-plan launch), timed at the chain's
   block size (its launch alone, its wrapper with the
   bounds check, ``F.embedding_bag`` over the same rows as the
   yardstick, the plain version) beside its bound; the chain's stages
   timed on that chunk, and its products through a random 512x3 head (K7
   and the ``[H, 1]`` output product, block by block);
4. main path: the port's CLI ``-g gpu -s -v`` on a 1,536-sample x
   2,000-transcript cohort (>= 2 chunks), byte-compared with the port's
   own host engine ``-g mt -s``;
5. ``DEBUG_GPU=1 -a -c -w`` on a 128 x 1,200 cohort, record-compared with
   ``-g mt``, with the validator launched;
6. neoantigen path: ``-g gpu --neoantigen_only --neoantigen_k 9
   --neoantigen_top 200`` on the main cohort (>= 5 chunks of 128 MiB),
   with K1 and K3 launched at least once a chunk, against ``-g gpu`` and
   ``-g mt --neoantigen_k 9 --neoantigen_device`` (FASTAs + the cohort
   batch, the same scorer): rows equal, scores within rtol 1e-5 + atol
   1e-6 (TSVs print 6 decimals), rows swapped only within that; the
   cohort batch's scoring stage of ``-g gpu --neoantigen_device`` split
   (``cohort_split``): ``score_cohort`` on the host clock and by CUDA
   events around its ``score_windows`` beside its bound, ``np.lexsort``
   (``rank_candidates``) and the TSV writer (``write_ranked_reports``) on
   the host clock;
7. wide head: ``--neoantigen_only`` with a 512x3 head written to an .npz,
   on the 128 x 1,200 cohort, against ``-g mt --neoantigen_k 9`` (fp32
   host math) within 5e-3 (bf16 rounding; up to 2.5e-3 measured on the
   CPU over 100 k random 9-mers);
8. K4 (the gradient of K3; run with phase 3's checks) against its plain
   versions on the card: 128x1 and 512x3 heads, k 8, 9, 11, then 30, 600,
   2,765 and 3,121 (the positions split over the grid; k * 21 past 65,535
   at 3,121), and 100x1 and 6x1 heads at k 11 (h1, g and the partials
   moved element by element), int32 and int64 positions, windows at odd
   byte offsets of a tape, 4,096 rows (a training batch) and 524,288 (the
   chain's block); bit-equal to ``window_layer1_backward_tiled_reference`` (K4's summation
   order), fp32 within rtol 1e-4 + atol 1e-5 * max|ref| of the
   ``index_add_`` version, two launches bit-equal; at k = 9 its launches
   alone and its wrapper timed at the four sizes beside the bound, the
   previous kernel's time and the yardstick (``torch.autograd.grad`` of
   ``F.embedding_bag`` w.r.t. an fp32 table), which neither may be slower
   than;
8b. K5 (adam, run after phase 8) against its plain version on the card:
   the flat parameters of a 128x1 and a 512x3 head, 1,000,003 parameters
   and the 128x1 size 4 bytes past 16-byte alignment, 3 steps each from a
   fresh cache of bias corrections (the first step misses it, the later
   ones hit it): p, mu and nu bit-equal, the count advanced; at the heads'
   sizes K5's first
   design (``chip_archive/adam_first.cu``) and the current one, each built
   into a library of its own, bit-equal and their launches timed alone
   back to back and in a CUDA graph (as the captured step runs them) in
   the order A B B A (``utils/kernel_ab.py``'s ``ab_k5``; the kernels
   line's ``ms`` and ``graph_ms`` are the current one's there), then its
   wrapper and its plain version timed beside its bound and
   ``torch.optim.Adam(fused=True).step()`` on the same parameters (in a
   graph with ``capturable=True``, and eager);
8c. K6 (the head's tail: the output product, the loss and its gradient,
   forward and backward) against its plain version on the card: the 8x1,
   128x1, 512x1 and 512x3 heads (the 512x3 head's tail takes its last
   hidden layer, 512 wide) and a 12x1 head (not a multiple of K6's 8-element
   chunk: its scalar path), 4,096, 4,095 (odd) and 2,048 rows (a dp
   shard's, with the whole batch's count), binary and squared-error labels,
   37 rows masked, and 128x1 at 4,095 rows 2 bytes past 16-byte alignment
   (the scalar path again): s, the loss, the count, dh and the gradients
   added into the output layer's views bit-equal, two launches bit-equal,
   and within rtol 1e-5 (loss), 1e-4 of the largest element (b2) and one
   bf16 ulp of the largest element (w2 and dh, both rounded to bf16) of
   dense autograd through ``later_layers`` and ``batch_loss``; then K6's
   first design (``chip_archive/head_tail_first.cu``) and the current one,
   each built into a library of its own, on the 128x1 and 512x3 tails at
   4,096 binary rows, A B B A (``utils/kernel_ab.py``'s ``ab_k6``: the
   current one bit-equal to its plain version, the first within its
   tolerance of float64), each way launched alone and in a CUDA graph (the
   kernels line's ``ms``, ``graph_ms``, ``earlier_ms`` and
   ``earlier_graph_ms``, the 512x3 tail's as ``wide_*``); the wrappers and
   the plain versions beside the bound, and both wrappers in a graph
   against the torch ops they replace (the output product, ``batch_loss``
   and their autograd) captured in a graph;
8d. K7 (the hidden layers after the first: forward, input gradient,
   weight gradient on the bf16 tensor cores) against its plain versions on
   the card over ``K7_SHAPES`` (4,096 and 4,095 rows x 512 -> 512 and 128
   -> 256, a 131,072-row serving block, 1,000 x 384 -> 640, 100 x 24 -> 40,
   300 x 12 -> 20) and 4,095 x 128 -> 256 in views 2 bytes past alignment:
   each kernel twice, bit-equal; the bf16 outputs within ``K7_TOL`` (the
   share that differs printed), db bit-equal; each case's launches counted
   on the path ``dense.tma_path`` picks (the Hopper kernels, TMA and
   ``wgmma``, for all but the odd width and the misaligned views, which
   take the first design's), and for 4,096 x 512 -> 512 and the misaligned
   views the path's kernels named by ``torch.profiler`` (none of the
   other's); a probe of subnormal sums; at 4,096 x 512 ->
   512 and the serving block its first design
   (``chip_archive/dense_first.cu``) and the current one, each built into
   a library of its own, A B B A (``utils/kernel_ab.py``'s ``ab_k7``):
   each kernel launched alone (``ms``, ``earlier_ms``) and in a CUDA graph
   (``graph_ms``, ``earlier_graph_ms``), beside its bound, its TFLOP/s,
   its plain version and ``torch.matmul`` of the bf16 operands
   (``library_ms``);
8e. K8 (the fold of the embedding into the first layer, and its gradient
   added into the head's gradient views) against its plain versions on the
   card over ``K8_SHAPES`` (k 8/9/11 x E 16/32 x H 8/100/128/512, then k
   692 and 3,121, past 65,535 table rows, at E 32 x H 100/512) and the
   128x1 head's fold with every array in a view 4 bytes past alignment:
   both directions bit-equal (the table, and the sinks, which start from
   random values), two launches bit-equal; at the 128x1 and 512x3 heads'
   folds each direction launched alone back to back and its wrapper in a
   CUDA graph, beside its bound, the launch floor (an empty kernel that
   only waits for the kernel before it, on the direction's grid with its
   cluster and launch attributes: ``v2p_fold_launch_floor``, in a CUDA
   graph), its plain version, ``torch.matmul`` of embed and w1 (the fold
   in fp32, no cast: ``library_ms``) and the torch ops it replaces
   captured in a graph (the forward: the ``einsum`` and its cast; both
   ways: the forward, K4's table gradient cast to bf16 and autograd's cast
   back, the ``einsum``'s gradient and the AccumulateGrads of embed, w1
   and b1), K8 both ways in a graph beside them; the backward-then-forward
   pair captured in a CUDA graph (each kernel a programmatic dependent of
   the one before it) bit-equal to the same pair run eagerly; its first
   design (``chip_archive/fold_first.cu``) and the current one, each built
   into a library of its own, A B B A (``utils/kernel_ab.py``'s
   ``ab_k8``): each direction launched alone (``earlier_ms``) and in a
   CUDA graph (``earlier_graph_ms``), and the pair in a graph;
8f. K9 (the training step's prologue: the batch copied out of the epoch
   buffers at the device's step count, the gradient buffer zeroed, the
   hidden weights cast to bf16) against its plain version on the card over
   ``K9_CASES`` (the 128x1 and 512x3 fits' steps, the dp fit's shards with
   the batches' mask counts, odd shapes, views 1-3 elements past alignment)
   at ``K9_STEPS``: bit-equal, nothing written outside its outputs; K5 with
   its step tail (the loss stored at ``steps % L``, the count advanced) and
   without, bit-equal in p, mu, nu and the count, its block ticket 0 after
   every launch, the tail as its plain version's; K5 with the step's jobs
   (the gradient zeroed, the updated hidden weights cast, batch (steps + 1)
   % n_batches staged) over ``K5_JOB_CASES`` at ``K9_STEPS`` bit-equal to
   its plain version, two launches bit-equal, its ticket 0 after every
   launch, guard elements around every output unchanged; at the 128x1 and
   512x3 steps K9 launched alone, in a CUDA graph, its wrapper, its plain
   version and the torch ops it replaced in a graph, beside its bound, and
   K5 in a graph with the step's jobs and with its tail alone, A B B A,
   beside its bound with the jobs;
9. training: the synthetic MHC task of
   ``automation_scripts/train_synth_mhc.py`` (100,000 9-mers, 80/20, 20
   epochs, batch 4,096, seed 0) for the 8x1, 128x1, 512x1 and 512x3 heads
   through its twin's functions (``vcf2prot_tpu_torch.tools.
   train_synth_mhc``, on ``downstream.train.fit``, each step a replay of
   its captured graph, every epoch loop under
   ``torch.cuda.set_sync_debug_mode("error")``): holdout AUC within
   [artifact - 0.01, ceiling + 0.02] of ``automation_scripts/artifacts/
   synth_mhc_training.tsv``, 128x1 above 8x1, K3, K4 and K5 launched
   once a step (replays counted), K9 once an epoch, K6 and K8 once forward
   and once backward a step on every head, K7's three kernels once a step for each of the
   512x3 head's two hidden layers after the first; fit walls;
9b. step times: each head's captured step against its eager one
   (``capture=False``) by CUDA events, beside the step's bound, with the
   shares of K4, K6 and K7; for the 128x1 and 512x3 heads the host
   calls, device kernels and device busy time a step of the epoch loop
   (``torch.profiler``), whose kernel names show K7's Hopper kernels and
   none of its edge path's in the 512x3 loop and no K7 kernel in the
   128x1 one; the device kernels a step by name beside the parent's
   count (``PARENT_STEP_KERNELS``, K9 in the step), fewer now, with no
   cuBLAS product (``gemm``/``bmm``) among them, every kernel run once a
   step one of the port's own (``csrc/*.cu``), K9's kernel once an epoch
   and K5's with the step's jobs once a step (by name, captured and
   eager), none of the torch kernels K9 and K5's tail replaced
   (``REPLACED_BY_K9``), and in the eager loop no ``aten::bmm`` or
   ``aten::einsum``, no torch op run by an AccumulateGrad and no cast
   (``aten::_to_copy``); K3's launches on its batch plan beside the step's
   kernels: every K3 launch of a profiled fit, one a step (and a captured
   fit's warm-up steps); the captured step with K5's jobs against the
   same step with K9 at its head, bit-equal, A B B A
   (``utils/kernel_ab.py``'s ``ab_k9``); then phase 9's fits captured and
   eager, A B B A, with bit-equal weights;
10. the trained 512x3 head saved with ``save_params`` and served by
   ``--neoantigen_only --neoantigen_params`` on the 128 x 1,200 cohort
   against ``-g mt``'s fp32 host report, the training forward against
   ``ScoringHead`` on the card, and K8's fold of the trained weights on the
   card bit-equal to ``ScoringHead``'s, made on the CPU;
11. a 512x3 fit of 1,000,000 9-mers for 2 epochs (windows/s), two 128x1
   fits bit-equal, and 4 steps on the card against the same 4 steps on
   the CPU (plain K3/K4) within 5e-3;
12. sharded FASTA path: ``-g gpu -s`` on the main cohort with
   ``parallel.mesh.make_mesh`` replaced by a mesh of the one card named
   twice (``repeated_card_mesh``), byte-compared with ``-g mt``; K1
   launched once per non-empty shard of every chunk;
13. ``DEBUG_GPU=1 -a -c -w`` on that mesh and the 128 x 1,200 cohort: K2
   launched once per non-empty shard of every chunk;
14. sharded neoantigen chain: ``--neoantigen_only`` on that mesh and the
   main cohort, rows equal to phase 6's single-device chain within rtol
   1e-5 + atol 1e-6; K1 and K3 launched on every shard;
15. data-parallel fit: the 128x1 and 512x3 heads of phase 9 over that mesh
   with a global batch of 4,096: holdout AUC within [artifact - 0.01,
   ceiling + 0.02], weights after 1 epoch within 5e-3 (128x1) and 1e-2
   (512x3; ``DP_TOL``) of the single-device fit on the card for seeds 0-4,
   and above them with one shard's gradient dropped (a planted fault,
   ``dp_gaps``), two dp fits bit-equal, fit walls and the eager dp step
   beside the captured single-device one;
16. multi-host: two processes of this script (``--multihost-child``) join
   one gloo group on localhost through ``initialize_distributed`` and run
   ``run_multihost_pipeline -g gpu`` on the main cohort, both on the card;
   the union of ``shard_0/`` and ``shard_1/`` is byte-equal to the FASTAs
   of ``-g mt``, and each child's K1 count is above 0;
17. default engine, FASTA path (run right after phase 4): the CLI with no
   ``-g`` on the main cohort, in a fresh process (``--cold-child``) as a
   user runs it, must resolve ``auto`` to the card through its D2H probe
   (its ``-v`` line on stderr), launch K1 at least once a chunk and write
   phase 4's ``-g mt`` bytes; prints that cold probe, then the D2H (8 MiB)
   and H2D (16 MiB) probes' rates in this process, a 256 MiB tape's
   pageable and pinned D2H rates, and a fresh process's start-up
   (``--startup-child``: ``import torch``, the context, the first kernel);
18. default engine, ``--neoantigen_only --neoantigen_k 9`` in a fresh
   process (run right after phase 6): ``auto`` must resolve to the card
   through the round-trip probe, K1 and K3 must run once a chunk at least,
   and the rows must equal phase 6's chain within rtol 1e-5 + atol 1e-6;
19. the batch twin (run right after phase 17): ``python -m
   vcf2prot_tpu_torch.tools.batch_over_bcf`` with no ``-g`` over a
   directory holding the main cohort's VCF, in a fresh process: ``auto``
   must resolve to the card, K1 must run once a chunk at least, and the
   file's directory must equal phase 4's ``-g mt -s``.

A mesh of one card named twice runs the sharded code paths and their
kernels; it says nothing of multi-GPU scaling, and real multi-GPU and
multi-node runs stay unverified.

Each path's launch counts are set to 0 just before it and read just after
(K7 on the serving path: phase 7's random 512x3 head and phase 10's trained
one). K7's counts are its Hopper path's; its edge path (the first design)
must have run nowhere on a path: the head's layers always take the Hopper
one (``tests/test_torch_dense.py`` holds each wrapper's count to the
pointers and extents its C entry picks the path from; phases 8d and 9b
also read the kernels' names from the profiler).
The line before the last is the kernels' JSON summary, K1-K9 (launches
summed over the paths, a captured step's counted at each replay; ``ms``
each kernel's launches alone and ``wrapper_ms`` its wrapper's, back to
back; each kernel's bound from
``vcf2prot_tpu_torch/utils/roofline.py``, and its yardstick's time as
``library_ms`` and ``one_call_ms``, null where no one call computes the
same; K5 and K6 also in a CUDA graph, ``graph_ms``, K5 beside
``library_graph_ms``, torch's fused adam captured, both beside their first
designs' ``earlier_ms`` / ``earlier_graph_ms``, K6 beside
``replaced_graph_ms``, the torch ops it replaces captured, and its 512x3
tail's numbers as ``wide_*``, K7's forward on a serving block as
``block_*``, K7 beside its first design's ``earlier_ms`` /
``earlier_graph_ms`` too, K8 in a graph beside the torch ops it replaces,
``replaced_graph_ms``, and both ways as ``pair_graph_ms``, K9 at the
128x1 step beside the torch ops it replaced in a graph
(``replaced_graph_ms``) and at the 512x3 step as ``wide_*``, K5 at those
steps in a graph with the step's jobs (``jobs_graph_ms``, beside
``jobs_bound_ms``) and with its tail alone (``tail_graph_ms``) in its own
row, null where they do not apply); the last line is
``{"ok": true, "device": {...}}``. Imports neither JAX nor the JAX package
``vcf2prot_tpu``.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK_BYTES = 256 * 1024 * 1024
NEO_CHUNK_BYTES = 128 * 1024 * 1024  # the device-resident chain's default
NEO_K, NEO_TOP = 9, 200
# the scaffold head of init_params and a wide one
HEADS = {"128x1": dict(hidden=128, depth=1),
         "512x3": dict(hidden=512, depth=3)}
# bf16 on the card against fp32 host math (see the module docstring)
HOST_ORACLE_TOL = 5e-3
# a trained head's scores reach ~28, and a bf16 scorer's error grows with
# them: the JAX package's own bf16 scorer differs from the fp32 host math
# by 0.099 (3.8e-3 of the largest score) on a 512x3 head trained on the
# synthetic MHC task (CPU). A trained head is held to 1e-2 of its largest
# score (at least 1), which is HOST_ORACLE_TOL's 5e-3 and more at a random
# head's scale.
TRAINED_TOL = 1e-2
# the main-path cohort: chromosome scale in transcripts (2,000), 1,536
# samples -> ~0.7 GB of result tape, three 256 MiB chunks
MAIN_SAMPLES, MAIN_TRANSCRIPTS, MAIN_SEED = 1536, 2000, 1
# the debug cohort: the round-5 benchmark's size and seed
DEBUG_SAMPLES, DEBUG_TRANSCRIPTS, DEBUG_SEED = 128, 1200, 20260817
# K4's row counts: a training batch and the chain's block
K4_ROWS = (4096, 524288)
# K4's long windows at a training batch: positions split over the grid,
# then k past the caps K3 and K4 once had (691, 2,764) and past 16-bit
# global row ids
K4_LONG_KS = (600, 2765, 3121)
# K4's previous design (a thread walking its rows through dependent loads),
# timed by its wrapper on an H100 80GB HBM3 at 700 W (PERF.md, section 6),
# ms, k = 9
K4_PREV_MS = {("128x1", 4096): 0.0661, ("512x3", 4096): 0.1023,
             ("128x1", 524288): 2.8153, ("512x3", 524288): 10.9354}
# K3's long windows: a table read from device memory (k >= 692), and
# 32-bit row ids
K3_LONG_KS, K3_LONG_ROWS = (692, 3121), (127, 4096)
# training: automation_scripts/train_synth_mhc.py's task and heads, run
# through its twin, vcf2prot_tpu_torch/tools/train_synth_mhc.py
MHC_N, MHC_EPOCHS, MHC_BATCH = 100_000, 20, 4096
TRAIN_HEADS = {"8x1": dict(hidden=8, depth=1),
               "128x1": dict(hidden=128, depth=1),
               "512x1": dict(hidden=512, depth=1),
               "512x3": dict(hidden=512, depth=3)}
MHC_ARTIFACT = os.path.join(ROOT, "automation_scripts", "artifacts",
                            "synth_mhc_training.tsv")
# the scale public MHC-I predictors train on: about a million peptides
BIG_N, BIG_EPOCHS = 1_000_000, 2
# residues, an 'other' byte and the '.' filler
WINDOW_BYTES = b"ACDEFGHIKLMNPQRSTVWYX."
# the card the K4 and training phases run on
DEV = "cuda"
# calls a kernel timing spans back to back (phases 3 and 8)
BACK_TO_BACK = 10
# K3's shape coverage (phase 3): widths, window lengths and row counts (a
# dp replica's batch, a training batch and the rows beside it, a serving
# block); each width and length also runs the last row count that takes
# the batch plan and the first that does not
K3_WIDTHS, K3_KS, K3_ROWS = (8, 100, 128, 512), (8, 9, 11, 30), (
    1, 127, 2048, 4095, 4096, 4097, 524287)
# the sharded phases' mesh: the one card, named MESH_SHARDS times
MESH_SHARDS = 2
SCALING_NOTE = ("one card named twice: this checks the sharded code path "
                "and its kernels, and says nothing of multi-GPU scaling")
# the dp fit's heads (phase 15), the seeds of its 1-epoch fits, and how
# far their weights may lie from the single-device fits'. Adam turns a
# gradient element whose shards nearly cancel (each rounded to bf16 apart,
# hazard 11) into lr-sized steps of either sign, so the largest gap over a
# head's weights grows with their count: at 512x3 the JAX package's own dp
# fit lies 7.7e-3 from its single-device fit on this task
# (tests/test_torch_dp_train.py, CPU backend). Each limit lies between the
# largest sound gap read on an H100 over DP_SEEDS and the smallest with one
# shard's gradient dropped, a planted fault that phase 15 runs each time
# and must find above the limit: 128x1 3.06e-3 and 1.57e-2, 512x3 6.84e-3
# and 2.03e-2
DP_HEADS = ("128x1", "512x3")
DP_SEEDS = (0, 1, 2, 3, 4)
DP_TOL = {"128x1": 5e-3, "512x3": 1e-2}
# K5's odd size (not a multiple of 4) and its steps a case (phase 8b)
K5_ODD, K5_STEPS = 1_000_003, 3
# K5's first design, timed beside the current one (phase 8b)
K5_EARLIER = os.path.join(ROOT, "chip_archive", "adam_first.cu")
# K6's heads (phase 9's, the 512x3 head's tail its last hidden layer, and
# a 12-wide one, not a multiple of K6's 8-element chunk), its row counts (a
# batch, an odd one, a dp shard's of two), its masked rows, the head also
# checked 2 bytes past alignment and the heads of its A/B (phase 8c)
K6_HEADS = {**TRAIN_HEADS, "12x1": dict(hidden=12, depth=1)}
K6_ROWS = (4096, 4095, 2048)
K6_PAD = 37
K6_MISALIGNED = "128x1"
K6_AB_HEADS = ("128x1", "512x3")
# K6's first design, timed beside the current one (phase 8c)
K6_EARLIER = os.path.join(ROOT, "chip_archive", "head_tail_first.cu")
# K7's layers (phase 8d), rows x inputs -> outputs: a training batch and an
# odd one at the 512x3 head's hidden layers and at a 128 -> 256 layer, a
# serving block of a 512-wide head (``dense_blk``'s 131,072 rows), a
# non-square layer (M, K and N all apart, so that a transposed operand
# cannot hide), a layer narrower than a TMA box in every extent (zeros
# read past its edges), and an odd width (the first design's edge path);
# the layer also run in views 2 bytes past alignment (the edge path
# again); the layers timed. K7_TOL, its
# tolerance against its plain versions (``dense.bf16_within``): a bf16
# output equal or one ulp apart (the tensor cores' fp32 sums are not the
# plain version's rounded adds, so the two may round apart), or, where a
# sum cancels, within twice the fp32 reassociation bound of its terms plus
# an ulp; db bit-equal (summed in the plain version's order)
K7_SHAPES = ((4096, 512, 512), (4095, 512, 512), (4096, 128, 256),
             (4095, 128, 256), (131072, 512, 512), (1000, 384, 640),
             (100, 24, 40), (300, 12, 20))
K7_MISALIGNED = (4095, 128, 256)
K7_TIMED = ((4096, 512, 512), (131072, 512, 512))
# K7's first design, timed beside the current one (phase 8d)
K7_EARLIER = os.path.join(ROOT, "chip_archive", "dense_first.cu")
K7_TOL = "bf16 equal or 1 ulp, or 2x the fp32 reassociation bound + 1 ulp"
# K8's folds (phase 8e), k x E x H: the CPU tests' grid, then windows past
# 691 and k * 21 past 65,535 table rows; the 128x1 head's fold also in
# views 4 bytes past alignment; the 128x1 and 512x3 heads' folds timed
K8_SHAPES = tuple((k, e, h) for k in (8, 9, 11) for e in (16, 32)
                  for h in (8, 100, 128, 512)) + tuple(
    (k, 32, h) for k in (692, 3121) for h in (100, 512))
K8_MISALIGNED = (9, 32, 128)
K8_TIMED = {"128x1": (9, 32, 128), "512x3": (9, 32, 512)}
K8_EARLIER = os.path.join(ROOT, "chip_archive", "fold_first.cu")
# K9's cases (phase 8f), (hidden, depth), rows, epoch batches, whether the
# dp fit's fourth epoch buffer (the batches' mask counts) is copied too,
# and the elements (bytes for the windows) past 16-byte alignment of the
# parameters, the bf16 casts and the epoch and batch buffers: the fit's
# 128x1 and 512x3 steps, the dp fit's shards (MESH_SHARDS of a batch),
# then odd shapes and views past alignment (casts whose source and
# destination lie at one place in a group of 4 elements, and at two)
K9_CASES = (((128, 1), 4096, 20, False, (0, 0, 0)),
            ((512, 3), 4096, 20, False, (0, 0, 0)),
            ((128, 1), 2048, 20, True, (0, 0, 0)),
            ((512, 3), 2048, 20, True, (0, 0, 0)),
            ((512, 3), 4095, 7, True, (1, 1, 1)),
            ((512, 3), 4096, 5, False, (3, 1, 2)),
            ((24, 3), 100, 4, True, (1, 2, 3)))
# the step counts each K9 case runs at: the first batches, the last of
# 20, a wrap, and one past 2**32
K9_STEPS = (0, 1, 19, 22, 2 ** 40 + 3)
# K5's tail (phase 8f): its losses buffer and the counts it starts from
K5_TAIL_LOSSES = 7
# K5 with the step's jobs (phase 8f): K9's cases, then the parameters
# aligned and the casts' bf16 views 1 element off 8 bytes (the groups'
# casts element by element), and a head whose last hidden weight starts 2
# elements into a group of 4 of the parameters (groups across its edges)
K5_JOB_CASES = K9_CASES + (((512, 3), 4096, 20, False, (0, 1, 0)),
                           (((12, 10, 6), 0), 100, 4, False, (0, 0, 0)),
                           (((12, 10, 6), 0), 100, 4, True, (0, 3, 1)))
# the heads whose captured fits are held to eager ones (phase 9b)
CAPTURE_HEADS = ("128x1", "512x3")
# device kernels a captured step took with K9 at its head, at commit
# b19e873, counted as phase 9b counts them, after the profiler's warm-up
# (chip_archive/fit_ab.py --step-kernels; PERF.md, section 5; an NVIDIA
# H100 80GB HBM3 at 700 W)
PARENT_STEP_KERNELS = {"128x1": 10.05, "512x3": 18.05}
# the torch kernels the step ran before K9 and K5's tail (the batch's
# index_selects, the zero fill and the loss's seed, the loss's store, the
# count's remainders and advance, the hidden weights' casts), as the
# profiler names them
REPLACED_BY_K9 = re.compile(
    r"indexSelectSmallIndex|FillFunctor|index_copy_kernel_impl|"
    r"BUnaryFunctor<long|CUDAFunctorOnSelf_add<long|"
    r"bfloat16_copy_kernel_cuda")
# the profiler's warm-up before an epoch loop: spin kernels of SPIN_CYCLES
# cycles each (~25 us), left out of its counts (SPIN_KERNEL)
PROFILER_WARMUP, SPIN_CYCLES = 32, 50_000
SPIN_KERNEL = re.compile(r"\bspin_kernel\b")
# K5's kernel with the step's jobs, as the profiler names it
K5_WITH_JOBS = re.compile(r"adam_kernel<(?:true|\(bool\)1)>")
# seconds a multi-host child may take (phase 16)
MULTIHOST_TIMEOUT = 300
# seconds a default-engine child may take (phases 17-19)
COLD_TIMEOUT = 300


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)

    from vcf2prot_tpu_torch.runtime import build
    from vcf2prot_tpu_torch.utils import roofline

    print(f"bounds from vcf2prot_tpu_torch/utils/roofline.py: device memory "
          f"{roofline.PEAK_HBM_BPS:.4g} B/s, fp32 "
          f"{roofline.PEAK_FP32_FLOPS:.4g} FLOP/s, bf16 "
          f"{roofline.PEAK_BF16_FLOPS:.4g} FLOP/s (H100 SXM5 datasheet, "
          f"700 W), on {smi}")

    ver = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    release = next((ln.split("release", 1)[1].split(",")[0].strip()
                    for ln in ver.splitlines() if "release" in ln), "?")
    try:
        import triton

        tri = triton.__version__
    except ImportError as err:
        tri = f"not importable ({err})"
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, nvcc release "
          f"{release}, triton {tri}, python {sys.version.split()[0]}")
    return smi


def phase_build():
    from vcf2prot_tpu_torch.runtime import build

    cached = os.path.exists(build.library_path())
    t0 = time.perf_counter()
    build.load_kernels()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.3f} s for {len(build.sources())} sources "
          f"(library {'cached' if cached else 'built'}: "
          f"{os.path.relpath(build.library_path(), ROOT)})")
    for ln in build.build_log().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas: {ln.strip()}")


def _tests_module(name):
    """A data generator of tests/ (plain numpy, no JAX)."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    return importlib.import_module(name)


def write_cohort(workdir, gen, n_samples, n_transcripts, seed):
    genvcf = _tests_module("genvcf")
    t0 = time.perf_counter()
    ref, samples = getattr(genvcf, gen)(
        seed=seed, n_samples=n_samples, n_transcripts=n_transcripts
    )
    vcf = os.path.join(workdir, f"{gen}_{n_samples}.vcf")
    fa = os.path.join(workdir, f"{gen}_{n_samples}.fasta")
    genvcf.write_synthetic_vcf(vcf, ref, samples)
    genvcf.write_fasta(fa, ref)
    print(f"cohort: {gen} {n_samples} x {n_transcripts} seed {seed}: "
          f"{os.path.getsize(vcf) / 1e6:.1f} MB VCF in "
          f"{time.perf_counter() - t0:.1f} s")
    return vcf, fa


def _cuda_ms(fn, reps=10, inner=1):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after one warm-up,
    and the last call's result. With ``inner`` > 1 each timing spans that
    many calls back to back and is divided by it: a kernel shorter than
    its wrapper's host work is then timed by the card, not by the host."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), out



def _graph_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of one replay of a CUDA graph
    holding BACK_TO_BACK calls of ``fn``, divided by BACK_TO_BACK: the
    device's time a call, without the host's launch work (as a captured
    training step runs its kernels). ``fn`` runs 3 times first on a side
    stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BACK_TO_BACK):
            fn()
    ms, _ = _cuda_ms(graph.replay, reps=reps)
    return ms / BACK_TO_BACK


def _edge_packs():
    """K1's edge packs, name -> (pack, blob): the executor edge cases of
    tests/test_executor_edges.py and the output-tile edges of
    tests/k1_edges.py (a task over 128 tiles, tile boundaries inside a task,
    at a task start and on runs of zero-length tasks sharing it, source
    offsets at every residue mod 16, spans at both ends of combined, and
    total_res 1, 15, 16, 17 and one tile +- 1)."""
    import numpy as np

    from vcf2prot_tpu_torch.compiler.haplotype import HaplotypeProgram, RefBlob
    from vcf2prot_tpu_torch.runtime.gpu_engine import K1_TILE_BYTES
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort

    def mk(tasks, alt, res_len):
        cols = list(zip(*tasks)) if tasks else [(), (), (), ()]
        return HaplotypeProgram(
            np.array(cols[0], np.uint8), np.array(cols[1], np.int64),
            np.array(cols[2], np.int64), np.array(cols[3], np.int64),
            alt, res_len, [],
        )

    small = RefBlob.from_ref_seqs({"T": "ABCDEFGHIJKLMNOP"})
    interleaved = [(0, 0, 0, 0), (1, 0, 2, 0), (0, 2, 3, 2), (1, 2, 0, 5)]
    interleaved += [(i % 2, i, 1, 5 + i) for i in range(8)]
    progs = {
        "empty": (mk([], b"", 0), small),
        "zero_len_and_single_bytes": (mk(interleaved, b"xyzzzzzzzz", 13),
                                      small),
        # the last task's span ends at the last byte of combined
        "span_to_last_byte": (mk([(0, 14, 2, 0), (1, 0, 8, 2),
                                  (1, 8, 2, 10)], b"0123456789", 12), small),
    }
    edges = _tests_module("k1_edges")
    big = RefBlob.from_ref_seqs({"T": edges.blob_seq()})
    for name, (tasks, alt, res_len) in edges.tile_edge_cases(
            K1_TILE_BYTES).items():
        progs[name] = (mk(tasks, alt, res_len), big)
    return {k: (pack_cohort([p], b), b) for k, (p, b) in progs.items()}


def _device_pack(packed, blob, dtype=None):
    import numpy as np

    from vcf2prot_tpu_torch.runtime.gpu_engine import to_device

    dst, srcb = packed.dst, packed.src_biased
    if dtype is not None:
        dst, srcb = dst.astype(dtype), srcb.astype(dtype)
    combined = np.concatenate([blob.data, np.asarray(packed.alt, np.uint8)])
    return (to_device(combined, "cuda"), to_device(dst, "cuda"),
            to_device(srcb, "cuda"))


def _shifted(t, elements):
    """A copy of ``t`` in a view that starts ``elements`` elements past the
    start of its buffer (at an odd byte address for a u8 tensor and 1)."""
    import torch

    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:]
    view.copy_(t)
    return view


def _k1_err(combined, dst, srcb, total):
    import torch

    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        segmented_copy,
        segmented_copy_reference,
    )

    got = segmented_copy(combined, dst, srcb, total)
    want = segmented_copy_reference(combined, dst, srcb, total)
    torch.cuda.synchronize()
    check(got.shape == want.shape, "K1 output shape differs from its twin")
    if total == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


def _k2_pair(dst, length, srcb, combined_len, res_len):
    from vcf2prot_tpu_torch.runtime.kernels import (
        validate_on_device,
        validate_reference,
    )

    return (validate_on_device(dst, length, srcb, combined_len, res_len),
            validate_reference(dst, length, srcb, combined_len, res_len))


def _entry(kernel, idx):
    """The C entry point ``v2p_<kernel>_i32`` or ``_i64`` for the index
    tensor ``idx``."""
    from vcf2prot_tpu_torch.runtime.build import load_kernels

    return getattr(load_kernels(), f"v2p_{kernel}_i{8 * idx.element_size()}")


def _launch_ms(entry, args, what):
    """A C entry point's launches alone, BACK_TO_BACK of them between two
    CUDA events (median of 10), on buffers the caller allocated once
    (``args`` without the stream)."""
    import torch

    from vcf2prot_tpu_torch.runtime.build import check_launch

    stream = torch.cuda.current_stream().cuda_stream
    ms, _ = _cuda_ms(lambda: check_launch(entry(*args, stream), what),
                     inner=BACK_TO_BACK)
    return ms


def compile_main(big_vcf, big_fa):
    """The main cohort's proteome blob and haplotype programs (native)."""
    from vcf2prot_tpu_torch.compiler.haplotype import RefBlob
    from vcf2prot_tpu_torch.compiler.qc import default_qc
    from vcf2prot_tpu_torch.frontend.fasta import read_fasta
    from vcf2prot_tpu_torch.native_bridge import (
        compile_cohort_native,
        load_native,
    )

    check(load_native() is not None, "the native host tier did not load")
    ref_seqs = read_fasta(big_fa)
    blob = RefBlob.from_ref_seqs(ref_seqs)
    _p, flat, _w = compile_cohort_native(big_vcf, ref_seqs, blob,
                                         default_qc(), alt_pool="auto")
    return blob, flat


def k1_k2_checks(blob, flat):
    """K1 byte-equal to its plain version on every pack, int32 and int64,
    with combined aligned and at an odd address; K2's count equal to its
    plain version's on a valid pack and corrupted copies, int32 and int64,
    with the three arrays aligned, one element past alignment and at
    differing alignments (phase 3). Returns the largest differences."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.gpu_engine import to_device
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort

    chunks = _chunk_indices(flat, CHUNK_BYTES, pair_aligned=True)
    small = pack_cohort([flat[i] for i in chunks[0][:64]], blob)
    cases = {"cohort": (small, blob)}
    cases.update(_edge_packs())
    k1_err = k2_err = 0
    for name, (packed, b) in cases.items():
        for dtype in (np.int32, np.int64):
            combined, dst, srcb = _device_pack(packed, b, dtype)
            for odd in (False, True):
                comb = _shifted(combined, 1) if odd else combined
                err = _k1_err(comb, dst, srcb, packed.total_res)
                check(err == 0, f"K1 differs from its plain version on "
                                f"{name} ({dtype.__name__}, combined at "
                                f"{comb.data_ptr() % 16} mod 16; max {err})")
                k1_err = max(k1_err, err)
    torch.cuda.empty_cache()
    print(f"K1 vs plain: byte-equal on {len(cases)} packs ({', '.join(cases)})"
          f" x int32/int64 x combined at an aligned and an odd address")

    combined_len = len(blob.data) + len(small.alt)
    lengths = np.diff(np.append(small.dst, small.total_res)).astype(np.int32)
    rng = np.random.default_rng(7)
    corrupt = {"valid": (small.dst, small.src_biased)}
    d = small.dst.copy()
    d[len(d) // 2] += 3
    corrupt["dst_mid_plus_3"] = (d, small.src_biased)
    s = small.src_biased.copy()
    s[0] = combined_len + 100
    corrupt["srcb0_past_end"] = (small.dst, s)
    d = small.dst.copy()
    d[-1] = small.total_res + 5
    corrupt["dst_last_past_res"] = (d, small.src_biased)
    # where a group of 4 tasks takes its neighbour's dst from the next lane
    # (3, 4), from the next set of 32 groups (127, 128), by a load (255,
    # 256), and the last task
    for i in (3, 4, 127, 128, 255, 256, len(small.dst) - 1):
        d = small.dst.copy()
        d[i] += 3
        corrupt[f"dst_{i}_plus_3"] = (d, small.src_biased)
    for r in range(20):
        d, s = small.dst.copy(), small.src_biased.copy()
        i = int(rng.integers(len(d)))
        if rng.random() < 0.5:
            d[i] += int(rng.integers(-50, 50))
        else:
            s[i] += int(rng.integers(-combined_len, combined_len))
        corrupt[f"random_{r}"] = (d, s)
    # aligned; each array one element past its buffer's start; the three
    # at different offsets (every task scalar)
    layouts = {"aligned": (0, 0, 0), "offset_1": (1, 1, 1),
               "mixed": (1, 2, 3)}
    for name, (d, s) in corrupt.items():
        for dtype in (np.int32, np.int64):
            arrays = [to_device(a.astype(dtype), "cuda")
                      for a in (d, lengths, s)]
            for layout, shifts in layouts.items():
                got, want = _k2_pair(
                    *(_shifted(a, k) if k else a
                      for a, k in zip(arrays, shifts)),
                    combined_len, small.total_res,
                )
                check(got == want, f"K2 count {got} != plain {want} on "
                                   f"{name} ({dtype.__name__}, {layout})")
                if not name.startswith("random"):
                    check((want == 0) == (name == "valid"),
                          f"K2 plain count {want} is wrong on {name}")
                k2_err = max(k2_err, abs(got - want))
    print(f"K2 vs plain: equal counts on {len(corrupt)} packs x int32/int64 "
          f"x {len(layouts)} layouts ({', '.join(layouts)})")
    return k1_err, k2_err


def phase_kernels(card, blob, flat):
    """K1 and K2 against their plain versions on the card (k1_k2_checks),
    then timed on the main cohort's first 256 MiB chunk and K1 also on its
    first 128 MiB chain chunk: each C entry point's launches alone on an
    output or count allocated once, the wrapper, the plain version, and for
    K1 a device-to-device ``copy_`` of the tape's bytes (its practical
    floor; another function, so no yardstick). Returns the kernels'
    measured numbers and the main cohort's chunk count."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort
    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        segmented_copy,
        segmented_copy_reference,
        to_device,
    )
    from vcf2prot_tpu_torch.runtime.kernels import (
        validate_on_device,
        validate_reference,
    )
    from vcf2prot_tpu_torch.utils import roofline

    k1_err, k2_err = k1_k2_checks(blob, flat)
    measured = {}
    for budget in (CHUNK_BYTES, NEO_CHUNK_BYTES):
        chunks = _chunk_indices(flat, budget, pair_aligned=True)
        if budget == CHUNK_BYTES:
            n_chunks = len(chunks)
        packed = pack_cohort([flat[i] for i in chunks[0]], blob)
        combined, dst, srcb = _device_pack(packed, blob)
        total, n = packed.total_res, dst.numel()
        err = _k1_err(combined, dst, srcb, total)
        check(err == 0, f"K1 differs from its plain version on the first "
                        f"{budget >> 20} MiB chunk ({err})")
        out = torch.empty(total, dtype=torch.uint8, device="cuda")
        launch = _launch_ms(_entry("segmented_copy", dst), (
            combined.data_ptr(), dst.data_ptr(), srcb.data_ptr(), n, total,
            out.data_ptr()), "K1")
        check(torch.equal(out, segmented_copy(combined, dst, srcb, total)),
              "K1's timed launches wrote another tape than its wrapper")
        wrapper, _ = _cuda_ms(
            lambda: segmented_copy(combined, dst, srcb, total),
            inner=BACK_TO_BACK)
        plain, _ = _cuda_ms(
            lambda: segmented_copy_reference(combined, dst, srcb, total),
            inner=BACK_TO_BACK)
        tape = torch.empty_like(out)
        floor, _ = _cuda_ms(lambda: tape.copy_(out), inner=BACK_TO_BACK)
        del out, tape
        moved = roofline.executor_bytes(total, n, dst.element_size())
        bound, by = roofline.bound_ms(moved)
        print(f"K1 on the first {budget >> 20} MiB chunk on {card}: {total} "
              f"bytes, {n} tasks ({dst.dtype}): launches alone {launch:.4f} "
              f"ms ({moved / launch / 1e6:.1f} GB/s of {moved} bytes moved; "
              f"{100 * bound / launch:.1f}% of the {bound:.4f} ms bound), "
              f"wrapper {wrapper:.4f} ms, plain {plain:.4f} ms")
        print(f"K1 floor on the first {budget >> 20} MiB chunk: a "
              f"device-to-device copy_ of its {total} tape bytes "
              f"{floor:.4f} ms ({2 * total / floor / 1e6:.1f} GB/s)")
        if budget == CHUNK_BYTES:
            measured["segmented_copy"] = dict(
                max_abs_err=k1_err, ms=launch, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                wrapper_ms=wrapper, floor_ms=floor)
            length = to_device(
                np.diff(np.append(packed.dst, total)).astype(
                    packed.dst.dtype), "cuda")
            got, want = _k2_pair(dst, length, srcb, combined.numel(), total)
            check(got == want == 0, f"K2 {got} / plain {want} on the chunk")
            count = torch.zeros(1, dtype=torch.int64, device="cuda")
            k2_launch = _launch_ms(_entry("validate", dst), (
                dst.data_ptr(), length.data_ptr(), srcb.data_ptr(), n,
                combined.numel(), total, count.data_ptr()), "K2")
            check(int(count.item()) == 0, "K2's timed launches counted "
                                          "violations on a valid chunk")
            k2_wrapper, _ = _cuda_ms(lambda: validate_on_device(
                dst, length, srcb, combined.numel(), total),
                inner=BACK_TO_BACK)
            k2_plain, _ = _cuda_ms(lambda: validate_reference(
                dst, length, srcb, combined.numel(), total),
                inner=BACK_TO_BACK)
            read = roofline.validator_bytes(n, dst.element_size())
            k2_bound, k2_by = roofline.bound_ms(read)
            print(f"K2 on the first {budget >> 20} MiB chunk on {card}: {n} "
                  f"tasks: launches alone {k2_launch:.4f} ms "
                  f"({read / k2_launch / 1e6:.1f} GB/s of {read} bytes "
                  f"read; {100 * k2_bound / k2_launch:.1f}% of the "
                  f"{k2_bound:.4f} ms bound), wrapper with its zeroed count "
                  f"and host wait {k2_wrapper:.4f} ms, plain "
                  f"{k2_plain:.4f} ms")
            measured["validate_on_device"] = dict(
                max_abs_err=k2_err, ms=k2_launch, plain_ms=k2_plain,
                bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
                wrapper_ms=k2_wrapper)
            del length, count
        del combined, dst, srcb
        torch.cuda.empty_cache()
    print(f"chunks: {n_chunks} of <= {CHUNK_BYTES} bytes in the main cohort")
    return n_chunks, measured


def _bits_equal(a, b):
    """Two bf16 tensors hold the same bit patterns (NaNs included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def k3_last_batch_rows(tape, k, table, b1, dtype):
    """The most windows K3 launches on its batch plan at k, the table's
    width and positions of ``dtype``, found by bisection over launches
    counted on ``window_layer1_batch`` (the plan does not depend on the
    positions' values); 0 where none does (phase 3)."""
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc

    def batch(m):
        pos = torch.zeros(m, dtype=dtype, device=DEV)
        before = launches(sc.window_layer1_batch)
        sc._launch_layer1(tape, pos, k, table, b1)
        return launches(sc.window_layer1_batch) > before

    lo, hi = 0, max(K3_ROWS)
    check(not batch(hi), f"K3 k={k} H={table.shape[1]} {dtype}: {hi} "
                         f"windows on the batch plan")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if batch(mid) else (lo, mid)
    return lo


def k3_shapes(card):
    """K3 bit-equal to its plain version over K3_WIDTHS x K3_KS x K3_ROWS
    and the rows at each width and length where the batch plan gives way
    to the persistent one, and H 100/128 x K3_LONG_KS x K3_LONG_ROWS, int32
    and int64 positions and misaligned views (the positions one element
    in, the table and biases 2 bytes past 16-byte alignment), windows at
    odd byte offsets of a tape of residues, 'X' and '.'; each launch
    counted on the batch plan up to the switch's row count and not past
    it, and never for the long windows, whose table K3 reads from device
    memory (phase 3)."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc

    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(WINDOW_BYTES, np.uint8)
    tape_len = 1 << 23
    tape = torch.from_numpy(
        alphabet[rng.integers(0, len(alphabet), tape_len)]).to(DEV)
    shapes = [(h, k, K3_ROWS, True) for h in K3_WIDTHS for k in K3_KS]
    shapes += [(h, k, K3_LONG_ROWS, False) for h in (100, 128)
               for k in K3_LONG_KS]
    cases = ((torch.int32, False), (torch.int64, False), (torch.int64, True))
    n, switches = 0, []
    for h, k, rows, switch in shapes:
        head = sc.ScoringHead.from_params(
            sc.init_params(k, seed=h + k, hidden=h)).to(DEV)
        # the last row count on the batch plan, by the positions' width
        last = {size: k3_last_batch_rows(tape, k, head.table, head.b1, dt)
                if switch else 0
                for size, dt in ((4, torch.int32), (8, torch.int64))}
        if switch:
            rows = rows + tuple(sorted({m for size in (4, 8)
                                        for m in (last[size],
                                                  last[size] + 1) if m}))
            switches.append(f"H {h} k {k}: {last[4]} / {last[8]}")
        # the misaligned views: 2 bytes past the table's and the biases'
        # alignment (K3 stages such a table element by element)
        flat = torch.empty(head.table.numel() + 1, dtype=torch.bfloat16,
                           device=DEV)
        flat[1:] = head.table.flatten()
        table = flat[1:].view(head.table.shape)
        flat_b = torch.empty(h + 1, dtype=torch.float32, device=DEV)
        flat_b[1:] = head.b1
        b1 = flat_b[1:]
        check(table.data_ptr() % 16 == 2 and b1.data_ptr() % 16 == 4,
              f"K3 H={h} k={k}: the views are not misaligned")
        for m in rows:
            odd = rng.integers(0, (tape_len - k) // 2, m + 1) * 2 + 1
            for dt, view in cases:
                pos = torch.from_numpy(odd).to(dt).to(DEV)
                pos = pos[1:] if view else pos[:m]
                batch = m <= last[pos.element_size()]
                args = (tape, pos, k) + ((table, b1) if view else
                                         (head.table, head.b1))
                before = launch_counts(
                    kernels=(sc.window_layer1, sc.window_layer1_batch))
                got = sc.window_layer1(*args)
                ran = launch_counts(before, (sc.window_layer1,
                                             sc.window_layer1_batch))
                what = f"K3 H={h} k={k} M={m} {dt}{' views' if view else ''}"
                check(ran[sc.window_layer1] == 1,
                      f"{what}: K3 was not launched")
                check(ran[sc.window_layer1_batch] == batch,
                      f"{what}: {ran[sc.window_layer1_batch]} batch-plan "
                      f"launches, its batch plan ending at "
                      f"{last[pos.element_size()]} rows")
                want = sc.window_layer1_reference(*args)
                torch.cuda.synchronize()
                check(_bits_equal(got, want),
                      f"{what} differs from its plain version (max |d| "
                      f"{float((got.float() - want.float()).abs().max())})")
                n += 1
        del head, got, want, table, b1, flat, flat_b
    torch.cuda.empty_cache()
    print(f"K3 vs plain on {card}: bit-equal at {n} shapes (H {K3_WIDTHS} x "
          f"k {K3_KS} x M {K3_ROWS} and the last M on the batch plan and "
          f"the next, and H 100/128 x k {K3_LONG_KS} x M {K3_LONG_ROWS}, x "
          f"int32/int64 positions at odd byte offsets and misaligned views); "
          f"the last M on the batch plan, int32 / int64 positions: "
          + ", ".join(switches))


def chain_wide_products(card, tape, pos):
    """The chunk's candidates through a random 512x3 head, as
    ``ScoringHead.score_positions`` scores them: each block's K3, then its
    hidden layers after the first (K7) and its ``[H, 1]`` output product,
    each timed by CUDA events around it and summed over the blocks (the
    second of two passes), beside K7's bound; K7 on its Hopper path."""
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.utils import roofline

    head = sc.ScoringHead.from_params(
        sc.init_params(NEO_K, seed=5, **HEADS["512x3"])).cuda()
    layers = [(getattr(head, f"w{i}"), getattr(head, f"b{i}"))
              for i in head.layers]
    m = pos.numel()
    blk = head.block_rows(m)
    with dense_counts() as counts:
        for _ in range(2):
            events = []
            for s in range(0, m, blk):
                h1 = sc._launch_layer1(tape, pos[s:s + blk], NEO_K,
                                       head.table, head.b1)
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)]
                marks[0].record()
                h = sc.hidden_layers(h1, layers[:-1])
                marks[1].record()
                sc.later_layers(h, layers[-1:])
                marks[2].record()
                events.append(marks)
                del h1, h
            torch.cuda.synchronize()
    # K7 on its Hopper path, once a block and layer in each pass
    want = 2 * (len(layers) - 1) * -(-m // blk)
    check(counts["dense_forward"] == want,
          f"chain products: K7's Hopper forward launched "
          f"{counts['dense_forward']} times, not {want}")
    k7 = sum(a.elapsed_time(b) for a, b, _c in events)
    out = sum(b.elapsed_time(c) for _a, b, c in events)
    bounds = [roofline.dense_bound_ms(min(blk, m - s), *w.shape, "forward")
              for s in range(0, m, blk) for w, _b in layers[:-1]]
    bound = sum(ms for ms, _by in bounds)
    by = " and ".join(sorted({by for _ms, by in bounds}))
    print(f"chain products per 128 MiB chunk on {card}, random 512x3 head "
          f"({m} candidates, {-(-m // blk)} blocks of <= {blk}; CUDA events "
          f"around each block's layers, summed): K7 ({len(layers) - 1} "
          f"layers) {k7:.4f} ms ({100 * bound / k7:.1f}% of its {bound:.4f} "
          f"ms bound by {by}), the [H, 1] output product {out:.4f} ms, "
          f"both {k7 + out:.4f} ms")
    del head
    torch.cuda.empty_cache()


def phase_k3(card, blob, flat):
    """K3 against its plain version on the candidate windows of the main
    cohort's first 128 MiB chunk and over K3_WIDTHS x K3_KS x K3_ROWS, its
    launch, wrapper and ``F.embedding_bag`` yardstick timed at the chain's
    block size, and the chain's stages timed on that chunk; returns K3's
    numbers and the cohort's 128 MiB chunk count."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vcf2prot_tpu_torch.downstream import device_resident as dr
    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.pipeline import _chunk_indices
    from vcf2prot_tpu_torch.runtime.gpu_engine import (
        GpuEngine,
        segmented_copy,
        to_device,
    )
    from vcf2prot_tpu_torch.runtime.pack import pack_cohort
    from vcf2prot_tpu_torch.utils import roofline

    k3_shapes(card)
    chunks = _chunk_indices(flat, NEO_CHUNK_BYTES, pair_aligned=True)
    progs = [flat[i] for i in chunks[0]]
    t0 = time.perf_counter()
    packed = pack_cohort(progs, blob)
    pack_s = time.perf_counter() - t0
    ann = dr._chunk_annotation_spans(progs, packed.spans)
    check(packed.contiguous and ann is not None,
          "the first 128 MiB chunk cannot run on the card")
    executor = GpuEngine(blob, "cuda")
    tape, dst, srcb = executor.launch(packed)
    ann_s, ann_e = (to_device(a, "cuda") for a in ann)
    cand = dr.candidate_mask(tape, dst, srcb, len(blob.data), ann_s, ann_e,
                             NEO_K)
    pos = torch.nonzero(cand).squeeze(1)
    m, total = pos.numel(), packed.total_res
    print(f"K3 input: chunk 1 of {len(chunks)} of <= {NEO_CHUNK_BYTES} "
          f"bytes: {total} bytes, {m} candidate {NEO_K}-windows")
    measured = {}
    for name, shape in HEADS.items():
        head = sc.ScoringHead.from_params(
            sc.init_params(NEO_K, seed=3, **shape)
        ).cuda()
        blk = head.block_rows(m)
        p = pos[:blk]
        h_dim = head.table.shape[1]
        got = sc.window_layer1(tape, p, NEO_K, head.table, head.b1)
        want = sc.window_layer1_reference(tape, p, NEO_K, head.table,
                                          head.b1)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(torch.isfinite(got.float()).all(), f"K3 {name}: not finite")
        check(_bits_equal(got, want), f"K3 {name} differs from its plain "
                                      f"version on the cohort's windows "
                                      f"(max |d| {err})")
        del got, want
        args = (tape, p, NEO_K, head.table, head.b1)
        counted = (sc.window_layer1, sc.window_layer1_batch)
        before = launch_counts(kernels=counted)
        ms, _ = _cuda_ms(lambda: sc._launch_layer1(*args),
                         inner=BACK_TO_BACK)
        # one launch between two events, as earlier runs timed K3
        single, _ = _cuda_ms(lambda: sc._launch_layer1(*args))
        ran = launch_counts(before, counted)
        batch = ran[sc.window_layer1_batch]
        check(batch == 0 or p.numel() < blk,
              f"K3 {name}: {batch} of {ran[sc.window_layer1]} launches of "
              f"a full block of {blk} windows on the batch plan")
        wrapper, _ = _cuda_ms(lambda: sc.window_layer1(*args),
                              inner=BACK_TO_BACK)
        plain, _ = _cuda_ms(lambda: sc.window_layer1_reference(*args),
                            inner=BACK_TO_BACK)
        # the yardstick: one call summing the same bf16 rows, without the
        # bias and ReLU; its [M, k] row ids are made outside the timing
        rows = sc._window_rows(tape, p, NEO_K)
        library, bag = _cuda_ms(
            lambda: F.embedding_bag(rows, head.table, mode="sum"),
            inner=BACK_TO_BACK)
        check(bag.shape == (p.numel(), h_dim)
              and bool(torch.isfinite(bag.float()).all()),
              f"F.embedding_bag {name}: shape {tuple(bag.shape)} or values")
        del rows, bag
        # the stores alone: a fill of an output of the same size
        fill = torch.empty((p.numel(), h_dim), dtype=torch.bfloat16,
                           device=p.device)
        fill_ms, _ = _cuda_ms(lambda: fill.fill_(1.0), inner=BACK_TO_BACK)
        del fill
        out_bytes = p.numel() * h_dim * 2
        n_bytes = roofline.scorer_bytes(
            p.numel(), h_dim, p.element_size(),
            roofline.covered_bytes(p, NEO_K), head.table.numel())
        bound, by = roofline.bound_ms(
            n_bytes, roofline.scorer_ops(p.numel(), NEO_K, h_dim))
        print(f"K3 {name} on {card}: {p.numel()} windows (block of {blk}, "
              f"{batch} of {ran[sc.window_layer1]} launches on the batch "
              f"plan): bit-equal to its plain version; launch {ms:.4f} ms "
              f"back to back, {single:.4f} ms alone "
              f"({out_bytes / ms / 1e6:.1f} GB/s of {out_bytes} output "
              f"bytes; {100 * bound / ms:.1f}% of the {bound:.4f} ms bound "
              f"by {by}, {n_bytes} compulsory bytes), wrapper with its "
              f"bounds check {wrapper:.4f} ms, F.embedding_bag "
              f"{library:.4f} ms, plain {plain:.4f} ms; a fill_ of the "
              f"output {fill_ms:.4f} ms")
        measured[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=library,
                              wrapper_ms=wrapper)
    torch.cuda.empty_cache()
    # where the time goes in one chunk, default head, stage by stage
    head = sc.ScoringHead.from_params(sc.init_params(NEO_K)).cuda()
    blk = head.block_rows(m)
    combined = executor._combined(packed)
    stages = {"host pack (host clock)": pack_s * 1e3}
    stages["upload dst, srcb, annotations"], _ = _cuda_ms(lambda: [
        to_device(a, "cuda") for a in (packed.dst, packed.src_biased, *ann)
    ])
    stages["K1 execute"], _ = _cuda_ms(
        lambda: segmented_copy(combined, dst, srcb, total))
    stages["candidate mask"], _ = _cuda_ms(lambda: dr.candidate_mask(
        tape, dst, srcb, len(blob.data), ann_s, ann_e, NEO_K))
    stages["compaction (nonzero)"], _ = _cuda_ms(
        lambda: torch.nonzero(cand).squeeze(1))
    def k3_blocks():
        # as score_positions runs it: one bounds check, then the blocks
        sc._check_layer1_args(tape, pos, NEO_K, head.table, head.b1)
        sc._check_window_bounds(tape, pos, NEO_K)
        return [sc._launch_layer1(tape, pos[s:s + blk], NEO_K, head.table,
                                  head.b1) for s in range(0, m, blk)]

    stages["K3 layer 1"], h1 = _cuda_ms(k3_blocks)
    # the launches alone (not a stage of its own: the line above holds
    # them), and the old form, a bounds check in every block's wrapper
    k3_alone, _ = _cuda_ms(lambda: [
        sc._launch_layer1(tape, pos[s:s + blk], NEO_K, head.table, head.b1)
        for s in range(0, m, blk)])
    k3_checked, _ = _cuda_ms(lambda: [
        head.layer1(tape, pos[s:s + blk]) for s in range(0, m, blk)])
    check_ms, _ = _cuda_ms(lambda: sc._check_window_bounds(tape, pos, NEO_K))
    stages["fp32 products, layers 2..N"], parts = _cuda_ms(
        lambda: [head.rest(h) for h in h1])
    del h1
    scores = torch.cat(parts)
    sample_starts = to_device(np.asarray(
        [packed.spans[2 * i][1] for i in range(len(progs) // 2)], np.int64
    ), "cuda")
    stages["rank: 2 stable sorts + select + pack"], rows = _cuda_ms(
        lambda: dr.pack_rows(*dr.rank_rows(tape, pos, scores, sample_starts,
                                           NEO_K, NEO_TOP)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fetched = rows.cpu()
    stages["row fetch (host clock)"] = (time.perf_counter() - t0) * 1e3
    device = sum(v for k, v in stages.items() if "host" not in k)
    print(f"chain stages per 128 MiB chunk on {card} (ms; CUDA events, "
          f"median of 10, default 128x1 head, {m} candidates, "
          f"{len(progs) // 2} samples, rows {tuple(fetched.shape)}): "
          + "; ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; device stages total {device:.4f}; K3's "
          f"{-(-m // blk)} launches alone {k3_alone:.4f}, with a bounds "
          f"check in each {k3_checked:.4f}; the chunk's one bounds check "
          f"{check_ms:.4f}")
    bounds = {stage: roofline.bound_ms(*work)
              for stage, work in roofline.chain_stage_bytes(
                  total, dst.numel(), dst.element_size(), ann_s.numel(),
                  ann_s.element_size(), m, head.table.shape[1],
                  fetched.numel()).items()}
    print("chain stage bounds (ms): " + "; ".join(
        f"{k} {b:.4f} by {by}" for k, (b, by) in bounds.items()))
    chain_wide_products(card, tape, pos)
    t_run = []
    eng = dr.DeviceNeoantigenEngine(blob, NEO_K, top=NEO_TOP)
    for _ in range(3):
        t0 = time.perf_counter()
        eng.run_chunk(progs)
        t_run.append(time.perf_counter() - t0)
    print(f"run_chunk of that chunk (host clock, pack to decoded rows): "
          f"{', '.join(f'{t:.4f}' for t in t_run)} s")
    names = [f"S{i}" for i in range(len(progs) // 2)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tsv_") as out:
        t0 = time.perf_counter()
        dr.write_device_neoantigen_reports(out, names, progs, blob, NEO_K,
                                           top=NEO_TOP)
        write_s = time.perf_counter() - t0
    print(f"write_device_neoantigen_reports of that chunk (host clock, "
          f"engine set-up, run_chunk and {len(names)} TSVs): {write_s:.4f} s")
    del tape, dst, srcb, cand, pos, scores, combined, executor, eng
    torch.cuda.empty_cache()
    return len(chunks), measured


def _run_cli(vcf, fa, out, engine, *flags):
    from vcf2prot_tpu_torch.cli import main

    os.makedirs(out)
    t0 = time.perf_counter()
    rc = main(["-f", vcf, "-r", fa, "-o", out, "-g", engine, *flags])
    check(rc == 0, f"-g {engine} exited {rc}")
    return time.perf_counter() - t0


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _same_outputs(a, b, what):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    check(fa == fb, f"{what}: file sets differ ({len(fa)} vs {len(fb)})")
    for f in fa:
        check(_read(os.path.join(a, f)) == _read(os.path.join(b, f)),
              f"{what}: {f} differs")
    return len(fa)


def phase_main(card, workdir, vcf, fa, n_chunks):
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    gpu_s = _run_cli(vcf, fa, os.path.join(workdir, "gpu"), "gpu", "-s", "-v")
    k1 = segmented_copy.launches
    mt_s = _run_cli(vcf, fa, os.path.join(workdir, "mt"), "mt", "-s")
    n = _same_outputs(os.path.join(workdir, "gpu"),
                      os.path.join(workdir, "mt"), "main path")
    out_bytes = sum(os.path.getsize(os.path.join(workdir, "gpu", f))
                    for f in os.listdir(os.path.join(workdir, "gpu")))
    check(n_chunks >= 2, f"main cohort has {n_chunks} chunk(s), not >= 2")
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    print(f"main path on {card}: {n} files ({out_bytes} bytes) "
          f"byte-identical; "
          f"-g gpu {gpu_s:.3f} s wall, -g mt {mt_s:.3f} s wall; "
          f"K1 launches {k1} for {n_chunks} chunks")
    return gpu_s


def _tape_d2h_rates(nbytes):
    """Device-to-host rates (bytes/s, host clock, median of 3) of one tape
    of ``nbytes`` on the card: into fresh pageable memory, as the FASTA
    path's ``collect`` copies, and into a pinned buffer allocated once."""
    import torch

    tape = torch.randint(0, 255, (nbytes,), dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def rate(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return nbytes / statistics.median(times)

    rates = rate(lambda: tape.cpu()), rate(lambda: pinned.copy_(tape))
    del tape, pinned
    return rates


def _cold_run(what, module, *argv):
    """``module``'s ``main(argv)`` in a fresh process of this script
    (``--cold-child``), as ``python -m module`` runs it for a user: nothing
    on the card yet, no VCF2PROT_PREFER_DEVICE. ``auto`` must resolve to
    the card, on every ``-g auto`` line of the child's stderr. Returns the
    child's stdout lines, those ``-g auto`` lines, its launches and main's
    wall."""
    env = dict(os.environ)
    env.pop("VCF2PROT_PREFER_DEVICE", None)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold-child",
             module, *argv],
            capture_output=True, text=True, env=env, timeout=COLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"{what}: the child outlasted {COLD_TIMEOUT} s")
    check(proc.returncode == 0, f"{what}: the child exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    child = json.loads(next(ln for ln in reversed(lines)
                            if ln.startswith('{"rc"')))
    check(child["rc"] == 0, f"{what}: main returned {child['rc']}: "
                            f"{proc.stderr[-2000:]}")
    auto = [ln for ln in proc.stderr.splitlines() if "-g auto for the" in ln]
    check(auto and all(ln.endswith("; engine gpu") for ln in auto),
          f"{what}: -g auto did not resolve to gpu: "
          f"{auto or 'no -g auto line on stderr'}")
    return lines, auto, child, child.pop("wall_s")


def cold_child(module, *argv):
    """One run of phases 17-19 in this fresh process: ``module``'s main on
    ``argv``; the last line holds its return code, the kernels' launches
    and main's wall."""
    import importlib

    main_fn = importlib.import_module(module).main
    t0 = time.perf_counter()
    rc = main_fn(list(argv))
    wall = time.perf_counter() - t0
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    print(json.dumps({"rc": rc, "segmented_copy": launches(segmented_copy),
                      "window_layer1": launches(window_layer1),
                      "wall_s": round(wall, 3)}), flush=True)


def startup_child():
    """Phase 17's start-up timing in this fresh process, seconds on the
    host clock as the last line: ``import torch``, the CUDA check, the
    first upload of 8 MiB (the context), the first ``(x + 1).cpu()`` (its
    kernel's load and the copy) and a second one (the copy alone)."""
    t = [time.perf_counter()]
    import numpy as np
    import torch

    t.append(time.perf_counter())
    check(torch.cuda.is_available(), "no CUDA device in the child")
    t.append(time.perf_counter())
    x = torch.from_numpy(
        np.random.randint(0, 255, 1 << 23, dtype=np.uint8)).to("cuda")
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    for _ in range(2):
        (x + 1).cpu()
        t.append(time.perf_counter())
    names = ("import torch", "is_available", "first upload",
             "first (x + 1).cpu()", "second (x + 1).cpu()")
    print(json.dumps({name: round(b - a, 6)
                      for name, a, b in zip(names, t, t[1:])}))


def _startup_seconds():
    """:func:`startup_child` in a fresh process of this script."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--startup-child"],
        capture_output=True, text=True, timeout=COLD_TIMEOUT)
    check(proc.returncode == 0, f"start-up child exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_default_fasta(card, workdir, vcf, fa, n_chunks):
    """17: the CLI with no -g on the main cohort in a fresh process, after
    phase 4: ``auto`` must pick the card by its D2H probe, K1 must run on
    every chunk, and the FASTAs must equal phase 4's ``-g mt``. Prints the
    cold process's probe, then this process's probes at their default
    sizes, the pageable and pinned D2H rates of a 256 MiB tape and a fresh
    process's start-up. Returns the path's launches."""
    from vcf2prot_tpu_torch.runtime import engine as engine_mod

    out = os.path.join(workdir, "auto")
    os.makedirs(out)
    _lines, auto, child, wall = _cold_run(
        "default engine, FASTA path", "vcf2prot_tpu_torch.cli",
        "-f", vcf, "-r", fa, "-o", out, "-s", "-v")
    k1 = child["segmented_copy"]
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    n = _same_outputs(out, os.path.join(workdir, "mt"),
                      "default engine, FASTA path")
    engine_mod._PROBE_CACHE.pop(("h2d", 1 << 24), None)
    d2h = engine_mod._probe_d2h_rate(1 << 23)
    h2d = engine_mod.h2d_rate(1 << 24)
    pageable, pinned = _tape_d2h_rates(CHUNK_BYTES)
    startup = _startup_seconds()
    print(f"default engine, FASTA path on {card}, a fresh process: "
          f"{auto[0]}; {n} files byte-identical to -g mt; {wall:.3f} s "
          f"wall of main; K1 launches {k1} for {n_chunks} chunks")
    print(f"probes on {card} (host clock), in this process after phases "
          f"1-4: D2H {d2h:.6g} B/s of 8 MiB, H2D {h2d:.6g} B/s of 16 MiB "
          f"(marginal); one {CHUNK_BYTES}-byte tape to the host: pageable "
          f"{pageable:.6g} B/s, pinned {pinned:.6g} B/s")
    print(f"a fresh process's start-up on {card} (host clock, s): "
          f"{json.dumps(startup)}")
    shutil.rmtree(out)
    return {"segmented_copy": k1}


def phase_batch(card, workdir, vcf, fa, n_chunks):
    """19: the batch twin, ``tools/batch_over_bcf.py`` with no -g, over a
    directory holding the main cohort's VCF, in a fresh process after
    phase 4: ``auto`` must pick the card, K1 must run on every chunk, and
    the file's directory must equal phase 4's ``-g mt -s``. Returns the
    path's launches."""
    indir = os.path.join(workdir, "batch_in")
    out = os.path.join(workdir, "batch_out")
    os.makedirs(indir)
    os.symlink(vcf, os.path.join(indir, "cohort.vcf"))
    lines, auto, child, wall = _cold_run(
        "batch twin", "vcf2prot_tpu_torch.tools.batch_over_bcf",
        "-d", indir, "-r", fa, "-o", out, "-s")
    check("processed 1/1 files" in lines,
          f"batch twin printed {lines[-3:]}, not processed 1/1 files")
    k1 = child["segmented_copy"]
    check(k1 >= n_chunks, f"K1 launched {k1} times for {n_chunks} chunks")
    n = _same_outputs(os.path.join(out, "cohort"),
                      os.path.join(workdir, "mt"), "batch twin")
    print(f"batch twin on {card}, a fresh process: {auto[0]}; {n} files "
          f"byte-identical to -g mt; {wall:.3f} s wall of main; K1 "
          f"launches {k1} for {n_chunks} chunks")
    shutil.rmtree(out)
    shutil.rmtree(indir)
    return {"segmented_copy": k1}


def phase_debug(workdir, vcf, fa):
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    k2_before = validate_on_device.launches
    os.environ["DEBUG_GPU"] = "1"
    try:
        gpu_s = _run_cli(vcf, fa, os.path.join(workdir, "dbg_gpu"), "gpu",
                         "-a", "-c", "-w")
        mt_s = _run_cli(vcf, fa, os.path.join(workdir, "dbg_mt"), "mt",
                        "-a", "-c", "-w")
    finally:
        del os.environ["DEBUG_GPU"]
    n = _same_outputs(os.path.join(workdir, "dbg_gpu"),
                      os.path.join(workdir, "dbg_mt"), "DEBUG_GPU -a -c -w")
    k2 = validate_on_device.launches - k2_before
    check(k2 > 0, "the validator was not launched under DEBUG_GPU")
    print(f"debug path: {n} gzip files identical after decompression; "
          f"-g gpu {gpu_s:.3f} s, -g mt {mt_s:.3f} s; K2 launches {k2}")


@contextlib.contextmanager
def cohort_split():
    """The cohort batch's stage (``cohort.write_reports_from_candidates``)
    split for the body: yields a dict that gets the host seconds of the
    port's own ``score_cohort``, ``rank_candidates`` (``np.lexsort``) and
    ``write_ranked_reports`` (the TSV writer), summed over the body's
    calls, and ``device_ms`` and ``windows``, CUDA events around each
    ``score_windows`` that ``score_cohort`` calls (its upload, K3 and the
    products) and the windows it scored. Each wrapper calls the function
    it wraps, unchanged."""
    import torch

    from vcf2prot_tpu_torch.downstream import cohort

    split = dict(score_cohort=0.0, rank_candidates=0.0,
                 write_ranked_reports=0.0, device_ms=0.0, windows=0)
    names = ("score_cohort", "rank_candidates", "write_ranked_reports",
             "score_windows")
    real = {name: getattr(cohort, name) for name in names}

    def scored(windows, head):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores = real["score_windows"](windows, head)
        end.record()
        end.synchronize()
        split["device_ms"] += start.elapsed_time(end)
        split["windows"] += len(windows)
        return scores

    def timed(name):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return real[name](*args)
            finally:
                split[name] += time.perf_counter() - t0
        return call

    for name in names:
        setattr(cohort, name, scored if name == "score_windows"
                else timed(name))
    try:
        yield split
    finally:
        for name, fn in real.items():
            setattr(cohort, name, fn)


def phase_neo(card, workdir, vcf, fa, n_neo_chunks):
    """The device-resident chain through the CLI, against the cohort batch
    of -g gpu and -g mt (the same scorer); returns the path's launches and
    wall, and leaves its reports in ``workdir/neo_chain``."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    flags = ("--neoantigen_k", str(NEO_K), "--neoantigen_top", str(NEO_TOP))
    chain = os.path.join(workdir, "neo_chain")
    kernels = (segmented_copy, window_layer1)
    start, waited = launch_counts(kernels=kernels), candidates_s()
    chain_s = _run_cli(vcf, fa, chain, "gpu", "--neoantigen_only", "-v",
                       *flags)
    launches = {f.__name__: n
                for f, n in launch_counts(start, kernels).items()}
    wait_s = candidates_s() - waited
    check(n_neo_chunks >= 5,
          f"main cohort has {n_neo_chunks} neo chunk(s), not >= 5")
    for name, n in launches.items():
        check(n >= n_neo_chunks,
              f"{name} launched {n} times for {n_neo_chunks} chunks")
    files = os.listdir(chain)
    check(not any(f.endswith(".fasta") for f in files),
          "--neoantigen_only wrote FASTAs")
    check(len(files) == MAIN_SAMPLES, f"{len(files)} TSVs, not {MAIN_SAMPLES}")
    batch = os.path.join(workdir, "neo_batch")
    with cohort_split() as split:
        batch_s = _run_cli(vcf, fa, batch, "gpu", "--neoantigen_device",
                           "-v", *flags)
    host = os.path.join(workdir, "neo_mt")
    mt_s = _run_cli(vcf, fa, host, "mt", "--neoantigen_device", "-v",
                    *flags)
    for other, what in ((batch, "-g gpu"), (host, "-g mt")):
        msg = reports_disagree(chain, other, atol=1e-6, rtol=1e-5)
        check(msg is None, f"chain against {what} --neoantigen_device: {msg}")
    n_rows = sum(len(open(os.path.join(chain, f)).read().splitlines()) - 1
                 for f in files)
    print(f"neoantigen path on {card}: {len(files)} TSVs, {n_rows} rows, "
          f"equal to the cohort batch of -g gpu and -g mt (rtol 1e-5); "
          f"-g gpu --neoantigen_only {chain_s:.3f} s wall "
          f"({wait_s:.3f} s of it waiting on the per-chunk candidate "
          f"count), -g gpu --neoantigen_device {batch_s:.3f} s, "
          f"-g mt --neoantigen_device {mt_s:.3f} s; launches {launches} "
          f"for {n_neo_chunks} chunks")
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.utils import roofline

    check(split["windows"] > 0 and split["score_cohort"] > 0,
          f"the cohort batch scored nothing through score_cohort: {split}")
    bound, by = roofline.bound_ms(*roofline.cohort_score_costs(
        split["windows"], init_params(NEO_K)))
    print(f"-g gpu --neoantigen_device's candidate scoring on {card} "
          f"({split['windows']} windows, the default 128x1 head): "
          f"score_cohort {split['score_cohort']:.3f} s on the host clock, "
          f"of it {split['device_ms']:.3f} ms between CUDA events around "
          f"score_windows (the windows' upload, K3 and the output product; "
          f"bound {bound:.4f} ms by {by}) and the scores' fetch after; "
          f"np.lexsort (rank_candidates) {split['rank_candidates']:.3f} s; "
          f"the TSV writer (write_ranked_reports) "
          f"{split['write_ranked_reports']:.3f} s")
    for d in (batch, host):
        shutil.rmtree(d)
    return launches, chain_s


def phase_default_neo(card, workdir, vcf, fa, n_neo_chunks):
    """18: ``--neoantigen_only --neoantigen_k 9`` with no -g on the main
    cohort in a fresh process, after phase 6: ``auto`` must pick the card
    by its round-trip probe, K1 and K3 must run on every chunk, and the
    rows must equal phase 6's chain within rtol 1e-5 + atol 1e-6. Returns
    the path's launches."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree

    out = os.path.join(workdir, "neo_auto")
    os.makedirs(out)
    _lines, auto, child, wall = _cold_run(
        "default engine, --neoantigen_only", "vcf2prot_tpu_torch.cli",
        "-f", vcf, "-r", fa, "-o", out, "--neoantigen_only", "-v",
        "--neoantigen_k", str(NEO_K), "--neoantigen_top", str(NEO_TOP))
    launches = {"segmented_copy": child["segmented_copy"],
                "window_layer1": child["window_layer1"]}
    for name, n in launches.items():
        check(n >= n_neo_chunks,
              f"{name} launched {n} times for {n_neo_chunks} chunks")
    msg = reports_disagree(out, os.path.join(workdir, "neo_chain"),
                           atol=1e-6, rtol=1e-5)
    check(msg is None, f"default engine chain against phase 6's: {msg}")
    print(f"default engine, --neoantigen_only on {card}, a fresh process: "
          f"{auto[0]}; {len(os.listdir(out))} TSVs equal to phase 6's -g "
          f"gpu chain (rtol 1e-5 + atol 1e-6); {wall:.3f} s wall of main; "
          f"launches {launches} for {n_neo_chunks} chunks")
    shutil.rmtree(out)
    return launches


def _reports(d):
    from vcf2prot_tpu_torch.downstream.compare import read_report

    return {f: dict(read_report(os.path.join(d, f))) for f in os.listdir(d)}


def _largest_score(d):
    return max((abs(v) for rows in _reports(d).values()
                for v in rows.values()), default=0.0)


def _largest_gap(a, b):
    """Largest |score difference| of the rows two report directories
    share."""
    ra, rb = _reports(a), _reports(b)
    return max((abs(v - rb[f][key]) for f, rows in ra.items()
                for key, v in rows.items() if key in rb.get(f, {})),
               default=0.0)


def phase_wide(workdir, vcf, fa, npz, what, atol=None):
    """A head from an .npz through the chain, against the host's fp32
    per-sample report within ``atol`` (default: TRAINED_TOL of the largest
    score)."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree

    flags = ("--neoantigen_only", "--neoantigen_k", str(NEO_K),
             "--neoantigen_params", npz)
    chain = os.path.join(workdir, "wide_chain")
    host = os.path.join(workdir, "wide_mt")
    chain_s = _run_cli(vcf, fa, chain, "gpu", *flags)
    mt_s = _run_cli(vcf, fa, host, "mt", *flags)
    if atol is None:
        atol = TRAINED_TOL * max(1.0, _largest_score(host))
    msg = reports_disagree(chain, host, atol=atol)
    check(msg is None, f"{what} chain against fp32 host math: {msg}")
    print(f"{what} head: --neoantigen_only agrees with -g mt fp32 host "
          f"math within {atol} (rows in common: max |d| "
          f"{_largest_gap(chain, host)}); -g gpu {chain_s:.3f} s, "
          f"-g mt {mt_s:.3f} s")
    shutil.rmtree(chain)
    shutil.rmtree(host)


def _k4_yardstick(tape, pos, k, head, h1, g):
    """K4's yardstick: ``torch.autograd.grad`` of ``F.embedding_bag(rows,
    table, mode="sum")`` w.r.t. an fp32 table, given the ReLU-masked
    gradient, on a graph built once (``retain_graph``); the row ids, the
    graph and the mask are made outside the timing. Returns its median ms
    and its dtable."""
    import torch
    import torch.nn.functional as F

    from vcf2prot_tpu_torch.downstream import scoring as sc

    rows = sc._window_rows(tape, pos, k)
    table = head.table.float().requires_grad_()
    bag = F.embedding_bag(rows, table, mode="sum")
    gm = torch.where(h1 > 0, g.float(), 0.0)
    ms, (dtable,) = _cuda_ms(lambda: torch.autograd.grad(
        bag, table, gm, retain_graph=True), inner=BACK_TO_BACK)
    return ms, dtable


def _k4_launch_ms(tape, pos, k, h1, g):
    """K4's two launches alone, back to back: its C entry point on output
    and scratch allocated once (the wrapper allocates both on every call,
    and at a training batch its host work outlasts the launches). Returns
    their ms (CUDA events) and each pass's device ms a call
    (``torch.profiler`` over BACK_TO_BACK calls; empty where it records no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.runtime.build import check_launch

    m, h_dim = h1.shape
    tiles, _rows = sc._k4_tiles(m)
    out = torch.empty((k * sc.VOCAB + 1, h_dim), dtype=torch.float32,
                      device=h1.device)
    partial = torch.empty(tiles * out.numel(), dtype=torch.float32,
                          device=h1.device)
    fn = _entry("window_layer1_grad", pos)
    args = (tape.data_ptr(), pos.data_ptr(), m, k, h1.data_ptr(),
            g.data_ptr(), h_dim, tiles, partial.data_ptr(), out.data_ptr())
    ms = _launch_ms(fn, args, "K4")
    stream = torch.cuda.current_stream().cuda_stream
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BACK_TO_BACK):
            check_launch(fn(*args, stream), "K4")
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        for name, key in (("pass 1", "grad_partial"), ("pass 2",
                                                      "grad_reduce")):
            total = getattr(ev, "device_time_total", 0)
            if key in ev.key and total:
                passes[name] = total / 1e3 / BACK_TO_BACK
    return ms, passes


def phase_k4(card):
    """K4 against its plain version on the card; returns its numbers by
    (head, rows) at k = 9 with int64 positions."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import scoring as sc
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.utils import roofline

    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(WINDOW_BYTES, np.uint8)
    tape_len = 1 << 23
    tape = torch.from_numpy(
        alphabet[rng.integers(0, len(alphabet), tape_len)]).to(DEV)
    dtypes = (torch.int32, torch.int64)
    cases = [(h, k, dt, K4_ROWS[0]) for h in HEADS for k in (8, 9, 11, 30)
             for dt in dtypes]
    cases += [(h, 9, dt, K4_ROWS[1]) for h in HEADS for dt in dtypes]
    # a split of the positions over the grid; then k past the old caps
    # (2,764) and past 16-bit global row ids (k * 21 > 65,535)
    cases += [("128x1", k, torch.int64, K4_ROWS[0]) for k in K4_LONG_KS]
    # widths that stage h1 and g (H % 8 != 0) and store the partials (H % 4
    # != 0) element by element
    odd = {f"{h}x1": dict(hidden=h, depth=1) for h in (100, 6)}
    heads = dict(HEADS, **odd)
    cases += [(name, 11, dt, K4_ROWS[0]) for name in odd for dt in dtypes]
    measured = {}
    worst = 0.0
    for name, k, dt, m in cases:
        what = f"K4 {name} k={k} {str(dt)[6:]} M={m}"
        head = sc.ScoringHead.from_params(
            init_params(k, seed=k, **heads[name])).to(DEV)
        # windows at odd byte offsets of the tape
        pos = torch.from_numpy(
            rng.integers(0, (tape_len - k) // 2, m) * 2 + 1).to(dt).to(DEV)
        h1 = sc.window_layer1(tape, pos, k, head.table, head.b1)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(k * 1000 + m)
        g = torch.randn(h1.shape, generator=gen,
                        device=DEV).to(torch.bfloat16)
        before = launches(sc.window_layer1_backward)
        got = sc.window_layer1_backward(tape, pos, k, h1, g)
        again = sc.window_layer1_backward(tape, pos, k, h1, g)
        check(launches(sc.window_layer1_backward) == before + 2,
              f"{what}: K4 was not launched")
        tiled = sc.window_layer1_backward_tiled_reference(tape, pos, k, h1, g)
        want = sc.window_layer1_backward_reference(tape, pos, k, h1, g)
        torch.cuda.synchronize()
        err = 0.0
        for a, b, t, c in zip(got, again, tiled, want):
            check(torch.equal(a, b), f"{what}: two launches differ")
            check(torch.equal(a, t), f"{what}: differs from the plain "
                  f"version in K4's order (max |d| "
                  f"{float((a - t).abs().max())})")
            check(bool(torch.isfinite(a).all()), f"{what}: not finite")
            bad = (a - c).abs() > 1e-4 * c.abs() + 1e-5 * float(c.abs().max())
            err = max(err, float((a - c).abs().max()))
            check(not bool(bad.any()), f"{what} differs from its plain "
                                       f"version (max |d| {err})")
        worst = max(worst, err)
        if k == 9 and dt == torch.int64:
            ms, passes = _k4_launch_ms(tape, pos, k, h1, g)
            # the wrapper as autograd calls it (the forward checked the
            # windows' bounds), as the previous kernel was timed
            wrapper, _ = _cuda_ms(
                lambda: sc._layer1_backward(tape, pos, k, h1, g),
                inner=BACK_TO_BACK)
            plain, _ = _cuda_ms(lambda: sc.window_layer1_backward_reference(
                tape, pos, k, h1, g), inner=BACK_TO_BACK)
            library, lib_d = _k4_yardstick(tape, pos, k, head, h1, g)
            lib_err = float((lib_d - want[0]).abs().max())
            h_dim = h1.shape[1]
            n_bytes = roofline.scorer_grad_bytes(
                m, k, h_dim, pos.element_size(),
                roofline.covered_bytes(pos, k))
            bound, by = roofline.bound_ms(
                n_bytes, roofline.scorer_ops(m, k, h_dim))
            measured[(name, m)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       bound_ms=bound, bound_by=by,
                                       library_ms=library, wrapper_ms=wrapper)
            print(f"{what} on {card}: max |d| {err}; launches {ms:.4f} ms "
                  f"({4 * h1.numel() / ms / 1e6:.1f} GB/s of h1 and g; "
                  f"{100 * bound / ms:.1f}% of the {bound:.4f} ms bound by "
                  f"{by}; by torch.profiler "
                  + (", ".join(f"{n} {v:.4f} ms" for n, v in passes.items())
                     or "not measured")
                  + f"), wrapper {wrapper:.4f} ms (the previous "
                  f"kernel {K4_PREV_MS[(name, m)]} ms, so timed), plain "
                  f"{plain:.4f} ms, yardstick autograd.grad of "
                  f"F.embedding_bag {library:.4f} ms (its dtable within "
                  f"{lib_err} of the plain version's)")
        del h1, g, got, again, tiled, want
    torch.cuda.empty_cache()
    print(f"K4 vs plain: {len(cases)} cases bit-equal to the plain version "
          f"in K4's order and within rtol 1e-4 + atol 1e-5 * max|ref| of the "
          f"index_add_ one (max |d| {worst}), two launches bit-equal in each")
    print("K4 at k = 9, int64 (launches / bound / share of bound / wrapper "
          "/ yardstick / the previous kernel by its wrapper, ms): "
          + "; ".join(
              f"{n} x {m}: {v['ms']:.4f} / {v['bound_ms']:.4f} / "
              f"{100 * v['bound_ms'] / v['ms']:.1f}% / "
              f"{v['wrapper_ms']:.4f} / {v['library_ms']:.4f} / "
              f"{K4_PREV_MS[(n, m)]}"
              for (n, m), v in measured.items()))
    for key, v in measured.items():
        check(max(v["ms"], v["wrapper_ms"]) <= v["library_ms"],
              f"K4 {key} {v['ms']:.4f} ms ({v['wrapper_ms']:.4f} ms by its "
              f"wrapper) is slower than its yardstick {v['library_ms']:.4f} "
              f"ms")
    return measured


def phase_k5(card):
    """8b: K5 against its plain version on the card: the flat parameters
    of a 128x1 and a 512x3 head, K5_ODD parameters and the 128x1 size one
    element past 16-byte alignment, K5_STEPS steps each from count 5:
    bit-equal, the count advanced by each. At the heads' sizes, K5's first
    design and the current one, A B B A in one call (``utils/kernel_ab.py``):
    their launches alone back to back (``ms`` and ``earlier_ms``, as K1-K4
    are timed) and in a CUDA graph (``graph_ms`` and ``earlier_graph_ms``,
    the device's time as the captured step runs it); then its wrapper and
    its plain version, beside its bound and
    ``torch.optim.Adam(fused=True).step()`` on the same parameters
    (optax's update up to its rounding order), eager (``library_ms``) and,
    with ``capturable=True``, in a graph (``library_graph_ms``). Returns
    its numbers by head."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import adam as ad
    from vcf2prot_tpu_torch.downstream.scoring import (
        TrainableHead,
        init_params,
    )
    from vcf2prot_tpu_torch.utils import roofline

    rng = np.random.default_rng(17)
    heads = {name: TrainableHead.from_params(
        init_params(NEO_K, seed=0, **HEADS[name])).to(DEV) for name in HEADS}
    sizes = {name: h.flat.numel() for name, h in heads.items()}
    cases = [(name, n, 0) for name, n in sizes.items()]
    cases += [(f"{K5_ODD} parameters", K5_ODD, 0),
              ("128x1, 4 bytes past alignment", sizes["128x1"], 1)]
    lr = 1e-3

    def arrays(n, off):
        """p, mu, nu (nu >= 0) on the card, ``off`` elements in."""
        p, mu, nu = (rng.standard_normal(n + off) * s
                     for s in (0.1, 1e-2, 1e-2))
        return [torch.from_numpy(a.astype(np.float32)).to(DEV)[off:]
                for a in (p, mu, np.abs(nu))]

    for what, n, off in cases:
        got = arrays(n, off)
        want = [t.clone() for t in got]
        counts = [torch.tensor([5, 0], dtype=torch.int32, device=DEV)
                  for _ in range(2)]
        # a fresh cache: the first step misses it, the later ones hit it
        powers = torch.zeros(ad.POWERS, dtype=torch.int32, device=DEV)
        before = launches(ad.adam_update)
        for _ in range(K5_STEPS):
            g = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(
                -6, 1, n)).astype(np.float32)).to(DEV)
            p, mu, nu = got
            ad.adam_update(p, g, mu, nu, counts[0], lr, powers)
            p, mu, nu = want
            ad.adam_update_reference(p, g, mu, nu, counts[1], lr)
        torch.cuda.synchronize()
        check(launches(ad.adam_update) == before + K5_STEPS,
              f"K5 {what}: not launched")
        for name, a, b in zip(("p", "mu", "nu"), got, want):
            check(torch.equal(a, b), f"K5 {what}: {name} differs from the "
                  f"plain version (max |d| {float((a - b).abs().max())})")
        check(counts[0].tolist() == counts[1].tolist() == [5 + K5_STEPS, 0],
              f"K5 {what}: count {counts[0].tolist()}, plain "
              f"{counts[1].tolist()}")
    print(f"K5 vs plain on {card}: {len(cases)} cases ({', '.join(c[0] for c in cases)}; "
          f"{K5_STEPS} steps each, the first missing K5's cache of bias "
          f"corrections, the later hitting it): p, mu and nu bit-equal, the "
          f"count advanced {K5_STEPS} times")

    # the first design against the current one, in one call: both sides'
    # launches timed alike, alone and in a CUDA graph
    from vcf2prot_tpu_torch.utils import kernel_ab

    paths = [K5_EARLIER, os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                                      "adam.cu")]
    names = [os.path.relpath(path, ROOT) for path in paths]
    with tempfile.TemporaryDirectory(prefix="k5_ab_") as outdir:
        fns = kernel_ab.build_all(paths, "v2p_adam", outdir)
        bad, ab = kernel_ab.ab_k5(names, fns, lr)
    check(bad == 0, "K5: a version of the A/B differs from the plain "
                    "version")
    check(sorted(ab) == sorted(heads), f"K5: the A/B timed {sorted(ab)}")

    measured = {}
    for name, head in heads.items():
        n = sizes[name]
        old, new = (ab[name][path] for path in names)
        ms, graph = (statistics.median(new[key]) for key in ("ms", "graph_ms"))
        p, mu, nu = arrays(n, 0)
        g = torch.randn(n, device=DEV) * 1e-3
        count = torch.zeros(2, dtype=torch.int32, device=DEV)
        powers = torch.zeros(ad.POWERS, dtype=torch.int32, device=DEV)
        wrapper, _ = _cuda_ms(lambda: ad.adam_update(p, g, mu, nu, count, lr,
                                                     powers),
                              inner=BACK_TO_BACK)
        plain, _ = _cuda_ms(lambda: ad.adam_update_reference(
            p, g, mu, nu, count, lr), inner=BACK_TO_BACK)
        head.flat_grad.copy_(g)
        fused = torch.optim.Adam(head.parameters(), lr=lr, fused=True)
        library, _ = _cuda_ms(fused.step, inner=BACK_TO_BACK)
        fused = torch.optim.Adam(head.parameters(), lr=lr, fused=True,
                                 capturable=True)
        library_graph = _graph_ms(fused.step)
        bound, by = roofline.bound_ms(roofline.adam_bytes(n),
                                      roofline.adam_ops(n))
        measured[name] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=library, wrapper_ms=wrapper,
            graph_ms=graph, library_graph_ms=library_graph,
            earlier_ms=statistics.median(old["ms"]),
            earlier_graph_ms=statistics.median(old["graph_ms"]))
        print(f"K5 {name} ({n} parameters) on {card}, A B B A in one call "
              f"(median of each version's two): launched alone back to back "
              f"{ms:.4f} ms ({roofline.adam_bytes(n) / ms / 1e6:.1f} GB/s; "
              f"{100 * bound / ms:.1f}% of the {bound:.6f} ms bound by {by}), "
              f"in a CUDA graph {graph:.4f} ms a launch "
              f"({100 * bound / graph:.1f}%); first design "
              f"{measured[name]['earlier_ms']:.4f} / "
              f"{measured[name]['earlier_graph_ms']:.4f} ms; wrapper "
              f"{wrapper:.4f} ms, plain {plain:.4f} ms; "
              f"torch.optim.Adam(fused=True).step() {library:.4f} ms, with "
              f"capturable=True in a CUDA graph {library_graph:.4f} ms")
        del p, mu, nu, g, count, powers, fused
    del heads
    torch.cuda.empty_cache()
    return measured


def _k6_tail(head, win):
    """The activations K6 takes for ``head`` on the windows ``win`` (K3's
    h1, or bf16 of its last hidden layer) and its output layer's ``w`` and
    ``b``, detached."""
    import torch

    from vcf2prot_tpu_torch.downstream.scoring import hidden_layers

    with torch.no_grad():
        h = hidden_layers(head._layer1(win), head._later(
            head.names[1:-1])).to(torch.bfloat16).contiguous()
    out = head.names[-1]
    return (h, getattr(head, out).detach(),
            getattr(head, "b" + out[1:]).detach())


def _k6_case(h, w2, b2, binary, rows, count, rng):
    """One K6 case on the card: labels, a mask with K6_PAD rows at the end
    and an incoming loss gradient, the kernel's forward and backward twice
    and the plain versions once on the same inputs; returns the inputs and
    the kernel's results."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import head_tail as ht

    h_dim = h.shape[1]
    if binary:
        y = (rng.random(rows) < 0.3).astype(np.float32)
    else:
        y = rng.normal(0.5, 1.0, rows).astype(np.float32)
    m = np.ones(rows, np.float32)
    m[rows - K6_PAD:] = 0.0
    y, m = (torch.from_numpy(a).to(DEV) for a in (y, m))
    g_loss = torch.tensor(0.75, device=DEV)
    runs = []
    for _ in range(2):
        s, loss, cnt = ht.head_tail_forward(h, w2, b2, y, m, count, binary)
        gw2 = torch.zeros(h_dim, device=DEV)
        gb2 = torch.zeros(1, device=DEV)
        dh = ht.head_tail_backward(h, w2, y, m, s, cnt, g_loss, binary,
                                   gw2, gb2)
        runs.append((s, loss, cnt, dh, gw2, gb2))
    s, loss, cnt = ht.head_tail_forward_reference(h, w2, b2, y, m, count,
                                                  binary)
    gw2, gb2 = torch.zeros(h_dim, device=DEV), torch.zeros(1, device=DEV)
    dh = ht.head_tail_backward_reference(h, w2, y, m, s, cnt, g_loss,
                                         binary, gw2, gb2)
    torch.cuda.synchronize()
    return (y, m, g_loss), runs, (s, loss, cnt, dh, gw2, gb2)


def _k6_misaligned(h):
    """``h``'s values in a view that starts 2 bytes past 16-byte alignment
    (K6's scalar path)."""
    import torch

    flat = torch.empty(h.numel() + 1, dtype=h.dtype, device=h.device)
    view = flat[1:].view(h.shape)
    view.copy_(h)
    return view


def phase_k6(card):
    """8c: K6 against its plain version on the card (module docstring);
    returns its numbers, forward and backward, at 128x1 and 4,096 binary
    rows, with the 512x3 tail's beside them."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import head_tail as ht
    from vcf2prot_tpu_torch.downstream.scoring import (
        TrainableHead,
        init_params,
        later_layers,
    )
    from vcf2prot_tpu_torch.utils import kernel_ab, roofline

    rng = np.random.default_rng(23)
    alphabet = np.frombuffer(WINDOW_BYTES, np.uint8)
    outputs = ("s", "loss", "cnt", "dh", "gw2", "gb2")
    worst = {}
    n_cases = 0
    for name, shape in K6_HEADS.items():
        head = TrainableHead.from_params(
            init_params(NEO_K, seed=1, **shape)).to(DEV)
        for rows in K6_ROWS:
            win = torch.from_numpy(
                alphabet[rng.integers(0, len(alphabet), (rows, NEO_K))]
            ).to(DEV)
            h, w2, b2 = _k6_tail(head, win)
            # a dp shard's rows divide by the whole batch's count
            count = (torch.tensor(2.0 * rows - K6_PAD, device=DEV)
                     if rows == K6_ROWS[2] else None)
            layouts = [("", h)]
            if name == K6_MISALIGNED and rows == K6_ROWS[1]:
                layouts.append((" 2 bytes past alignment", _k6_misaligned(h)))
            for where, hx in layouts:
                for binary in (True, False):
                    what = (f"K6 {name} {rows} rows{where} "
                            f"{'binary' if binary else 'squared error'}"
                            + (" (whole-batch count)" if count is not None
                               else ""))
                    inputs, runs, plain = _k6_case(hx, w2, b2, binary, rows,
                                                   count, rng)
                    n_cases += 1
                    for key, a, b, c in zip(outputs, *runs, plain):
                        check(torch.equal(a, b), f"{what}: two launches "
                                                 f"differ in {key}")
                        check(torch.equal(a, c), f"{what}: {key} differs "
                              f"from the plain version (max |d| "
                              f"{float((a.float() - c.float()).abs().max())})")
                        check(bool(torch.isfinite(a.float()).all()),
                              f"{what}: {key} not finite")
                    # the arithmetic against dense autograd of the torch ops
                    y, m, g_loss = inputs
                    hl = hx.clone().requires_grad_()
                    w2l = w2.clone().requires_grad_()
                    b2l = b2.clone().requires_grad_()
                    loss = ht.batch_loss(later_layers(hl, [(
                        w2l.to(torch.bfloat16).float(), b2l)]), y, m, binary,
                        count)
                    dh, dw2, db2 = torch.autograd.grad(loss, (hl, w2l, b2l),
                                                       g_loss)
                    got = runs[0]
                    errs = {
                        "loss": (float((got[1] - loss.detach()).abs()),
                                 1e-5 * float(loss.detach().abs())),
                        "dh": (float((got[3].float() - dh.float()).abs()
                                     .max()),
                               2.0 ** -7 * float(dh.float().abs().max())),
                        # both rounded to bf16: a sum an ulp apart may round
                        # one bf16 ulp apart
                        "w2": (float((got[4] - dw2.view(-1)).abs().max()),
                               2.0 ** -8 * float(dw2.abs().max())),
                        "b2": (float((got[5] - db2).abs().max()),
                               1e-4 * float(db2.abs().max())),
                    }
                    for key, (err, tol) in errs.items():
                        check(err <= tol, f"{what}: {key} lies {err} from "
                              f"dense autograd, over {tol}")
                        worst[key] = max(worst.get(key, 0.0),
                                         err / max(tol, 1e-30))
        del head
    print(f"K6 vs plain on {card}: {n_cases} cases (heads "
          f"{', '.join(K6_HEADS)}, the 512x3 head's tail its last hidden "
          f"layer, x rows {K6_ROWS} x binary / squared error, {K6_PAD} rows "
          f"masked; {K6_MISALIGNED} also 2 bytes past alignment): s, loss, "
          f"count, dh and the output layer's gradients bit-equal to the "
          f"plain version, two launches bit-equal; against dense autograd "
          f"of later_layers + batch_loss at most "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + " of its tolerance")

    # the first design against the current one, in one call: both sides'
    # launches timed alike, alone and in a CUDA graph
    paths = [K6_EARLIER, os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                                      "head_tail.cu")]
    names = [os.path.relpath(path, ROOT) for path in paths]
    with tempfile.TemporaryDirectory(prefix="k6_ab_") as outdir:
        fns = kernel_ab.build_all(paths, kernel_ab.ENTRIES["k6"], outdir)
        bad, ab = kernel_ab.ab_k6(names, fns)
    check(bad == 0, "K6: a version of the A/B differs from its check")
    check(sorted(ab) == sorted(K6_AB_HEADS), f"K6: the A/B timed {sorted(ab)}")

    def ab_ms(head, path, key):
        return statistics.median(ab[head][path][key])

    # wrappers, plain versions and the torch ops K6 replaces, at the A/B's
    # heads and a training batch of binary rows
    rows = K6_ROWS[0]
    measured = {"forward": {}, "backward": {}}
    for head_name in K6_AB_HEADS:
        head = TrainableHead.from_params(init_params(
            NEO_K, seed=1, **TRAIN_HEADS[head_name])).to(DEV)
        win = torch.from_numpy(
            alphabet[rng.integers(0, len(alphabet), (rows, NEO_K))]).to(DEV)
        h, w2, b2 = _k6_tail(head, win)
        h_dim = h.shape[1]
        (y, m, g_loss), runs, _plain = _k6_case(h, w2, b2, True, rows, None,
                                                rng)
        s, loss, cnt, dh, gw2, gb2 = runs[0]
        wrappers = {
            "forward": lambda: ht.head_tail_forward(h, w2, b2, y, m, None,
                                                    True),
            "backward": lambda: ht.head_tail_backward(
                h, w2, y, m, s, cnt, g_loss, True, gw2, gb2)}
        plains = {
            "forward": lambda: ht.head_tail_forward_reference(
                h, w2, b2, y, m, None, True),
            "backward": lambda: ht.head_tail_backward_reference(
                h, w2, y, m, s, cnt, g_loss, True, gw2, gb2)}
        hl = h.clone().requires_grad_()
        w2l = w2.clone().requires_grad_()
        b2l = b2.clone().requires_grad_()

        def replaced():
            """The torch ops K6 replaces: the output product, the loss and
            their autograd back to h, w2 and b2."""
            out = ht.batch_loss(later_layers(hl, [(
                w2l.to(torch.bfloat16).float(), b2l)]), y, m, True)
            return torch.autograd.grad(out, (hl, w2l, b2l))

        def pair():
            ht.head_tail_backward(h, w2, y, m, *ht.head_tail_forward(
                h, w2, b2, y, m, None, True)[::2], g_loss, True, gw2, gb2)

        replaced_ms, _ = _cuda_ms(replaced, inner=BACK_TO_BACK)
        replaced_graph = _graph_ms(replaced)
        pair_graph = _graph_ms(pair)
        # the kernels line's K6 numbers are 128x1's; the 512x3 tail's
        # beside them, as wide_*
        prefix = "" if head_name == "128x1" else "wide_"
        for part, key in (("forward", "fwd"), ("backward", "bwd")):
            ms = ab_ms(head_name, names[1], f"{key}_ms")
            graph = ab_ms(head_name, names[1], f"{key}_graph_ms")
            earlier = ab_ms(head_name, names[0], f"{key}_ms")
            earlier_graph = ab_ms(head_name, names[0], f"{key}_graph_ms")
            wrapper, _ = _cuda_ms(wrappers[part], inner=BACK_TO_BACK)
            plain, _ = _cuda_ms(plains[part], inner=BACK_TO_BACK)
            bound, by = roofline.head_tail_bound_ms(rows, h_dim, part)
            numbers = dict(
                ms=ms, graph_ms=graph, earlier_ms=earlier,
                earlier_graph_ms=earlier_graph, plain_ms=plain,
                bound_ms=bound, bound_by=by, wrapper_ms=wrapper,
                replaced_ms=replaced_ms, replaced_graph_ms=replaced_graph,
                pair_graph_ms=pair_graph)
            if not prefix:
                measured[part].update(max_abs_err=0.0, library_ms=None,
                                      **numbers)
            else:
                measured[part].update({prefix + k: v
                                       for k, v in numbers.items()
                                       if k not in ("bound_by",)})
            print(f"K6 {part}, {head_name} tail ({h_dim} wide), {rows} "
                  f"binary rows on {card}, A B B A against its first design "
                  f"(median of each version's two): launched alone back to "
                  f"back {ms:.4f} ms (first design {earlier:.4f}), in a CUDA "
                  f"graph {graph:.4f} ms (first design {earlier_graph:.4f}; "
                  f"{100 * bound / graph:.1f}% of the {bound:.6f} ms bound by "
                  f"{by}), wrapper {wrapper:.4f} ms, plain {plain:.4f} ms")
        bound, by = roofline.head_tail_bound_ms(rows, h_dim)
        print(f"K6 forward + backward, {head_name} tail, {rows} binary rows "
              f"on {card}: their wrappers in a CUDA graph {pair_graph:.4f} "
              f"ms ({100 * bound / pair_graph:.1f}% of the {bound:.6f} ms "
              f"bound by {by}); the torch ops they replace (the output "
              f"product, batch_loss, their autograd) {replaced_graph:.4f} ms "
              f"in a CUDA graph, {replaced_ms:.4f} ms eager")
        del head, h, hl
    torch.cuda.empty_cache()
    return measured


def _k7_inputs(rows, k, n, gen, misaligned=False):
    """A K7 layer's inputs on the card, from ``gen``: x (bf16 ``[rows,
    k]``), w (bf16 ``[k, n]``, He-scaled), b (fp32 ``[n]``) and an
    incoming gradient dy (bf16 ``[rows, n]``); with ``misaligned``, each
    bf16 array in a view 2 bytes past 16-byte alignment (the kernels'
    element-by-element path)."""
    import torch

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=DEV) * scale

    x = normal(rows, k).to(torch.bfloat16)
    w = normal(k, n, scale=(2.0 / max(k, 1)) ** 0.5).to(torch.bfloat16)
    b = normal(n, scale=0.1)
    dy = normal(rows, n, scale=1e-2).to(torch.bfloat16)
    if misaligned:
        x, w, dy = (_k6_misaligned(t) for t in (x, w, dy))
    return x, w, b, dy


def _k7_stats(got, want, slack):
    """``(all within K7_TOL, share of elements that differ, largest ulps,
    elements more than an ulp apart, max |d|)`` of a K7 output (bf16)
    against its plain version's."""
    from vcf2prot_tpu_torch.downstream.dense import bf16_ulps, bf16_within

    ulps = bf16_ulps(got, want)
    return (bool(bf16_within(got, want, slack).all()),
            float((ulps != 0).float().mean()), int(ulps.max()),
            int((ulps > 1).sum()),
            float((got.float() - want.float()).abs().max()))


def _k7_case(what, x, w, b, dy):
    """K7's three kernels against their plain versions on one layer's
    inputs: each launched twice (bit-equal), its bf16 outputs within
    K7_TOL, db bit-equal; returns y and the stats by kernel."""
    import torch

    from vcf2prot_tpu_torch.downstream import dense as dn

    rows, k = x.shape
    n = w.shape[1]
    eps = 2.0 ** -24
    xa, wa = x.float().abs(), w.float().abs()
    y, y2 = (dn.dense_forward(x, w, b) for _ in range(2))
    want = dn.dense_forward_reference(x, w, b)
    check(torch.equal(y, y2), f"{what}: two forward launches differ")
    stats = {"forward": _k7_stats(
        y, want, 2 * (k + 1) * eps * (xa @ wa + b.abs()))}
    # the gradients from the kernel's y, which both sides take
    dz = torch.where(y > 0, dy.float(), 0.0).abs()
    dx, dx2 = (dn.dense_backward_input(w, y, dy) for _ in range(2))
    check(torch.equal(dx, dx2), f"{what}: two input-gradient launches differ")
    stats["input"] = _k7_stats(dx, dn.dense_backward_input_reference(
        w, y, dy), 2 * n * eps * (dz @ wa.t()))
    sums = []
    for fn in (dn.dense_backward_weight, dn.dense_backward_weight,
               dn.dense_backward_weight_reference):
        gw = torch.zeros((k, n), device=DEV)
        gb = torch.zeros(n, device=DEV)
        fn(x, y, dy, gw, gb)
        sums.append((gw, gb))
    check(torch.equal(sums[0][0], sums[1][0])
          and torch.equal(sums[0][1], sums[1][1]),
          f"{what}: two weight-gradient launches differ")
    check(torch.equal(sums[0][1], sums[2][1]),
          f"{what}: db differs from the plain version's (max |d| "
          f"{float((sums[0][1] - sums[2][1]).abs().max())})")
    stats["weight"] = _k7_stats(
        sums[0][0].to(torch.bfloat16), sums[2][0].to(torch.bfloat16),
        2 * rows * eps * (xa.t() @ dz))
    torch.cuda.synchronize()
    for part, (ok, share, most, over, err) in stats.items():
        check(ok, f"{what}: K7 {part} outside its tolerance of the plain "
                  f"version ({over} elements more than an ulp apart, up to "
                  f"{most} ulps, max |d| {err})")
    for t in (y, dx, sums[0][0], sums[0][1]):
        check(bool(torch.isfinite(t.float()).all()), f"{what}: not finite")
    return y, stats


def _k7_subnormal_probe():
    """What K7 and its plain version give for sums that are fp32
    subnormals: 2**-132 (a bf16 subnormal) and 2**-140 (below half of
    bf16's smallest, 2**-133): whether the card's tensor cores keep them,
    and where the bf16 output's ReLU mask (y > 0) leaves the fp32 one (z
    > 0)."""
    import torch

    from vcf2prot_tpu_torch.downstream import dense as dn

    out = []
    for e in (-66, -70):
        x = torch.zeros((16, 16), device=DEV)
        w = torch.zeros((16, 8), device=DEV)
        x[0, 0], w[0, 0] = 2.0 ** e, 2.0 ** e
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        b = torch.zeros(8, device=DEV)
        got = float(dn.dense_forward(x, w, b)[0, 0])
        plain = float(dn.dense_forward_reference(x, w, b)[0, 0])
        z = float((x.float() @ w.float())[0, 0])
        out.append(f"a sum of 2**{2 * e}: K7 y {got!r}, plain y {plain!r} "
                   f"(fp32 z {z!r}; mask y > 0 {got > 0}, z > 0 {z > 0})")
    return "; ".join(out)


def phase_k7(card):
    """8d: K7 (the hidden layers after the first, ``csrc/dense.cu``)
    against its plain versions on the card over K7_SHAPES, and K7_MISALIGNED
    again in views 2 bytes past alignment: each kernel launched twice,
    bit-equal; the forward's and the two gradients' bf16 outputs within
    K7_TOL of the plain versions (the share that differs printed), db
    bit-equal; each case's launches counted on the path ``dense.tma_path``
    picks (the Hopper kernels for every case TMA can address, the first
    design's for the odd width and the misaligned views); a probe of
    subnormal sums. For K7_TIMED[0] and the misaligned view, the path's
    kernels by the names ``torch.profiler`` records, and none of the other
    path's. At K7_TIMED each kernel's first design
    (``chip_archive/dense_first.cu``) and the current one, each built into
    a library of its own, A B B A (``utils/kernel_ab.py``'s ``ab_k7``):
    launched alone back to back (``ms``, ``earlier_ms``) and in a CUDA graph
    (``graph_ms``, ``earlier_graph_ms``), beside its bound, its plain
    version and ``torch.matmul`` of the bf16 operands (``library_ms``, the
    yardstick, which the port never calls); the serving block's forward as
    ``block_*``. Returns the three kernels' numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcf2prot_tpu_torch.downstream import dense as dn
    from vcf2prot_tpu_torch.utils import kernel_ab, roofline

    gen = torch.Generator(device=DEV)
    gen.manual_seed(41)
    worst = {part: [0.0, 0, 0] for part in roofline.DENSE_PARTS}
    cases = [(shape, False) for shape in K7_SHAPES] + [(K7_MISALIGNED, True)]
    paths = {"hopper": 0, "edge": 0}
    for (rows, k, n), misaligned in cases:
        what = (f"K7 {rows} x {k} -> {n}"
                + (", 2 bytes past alignment" if misaligned else ""))
        x, w, b, dy = _k7_inputs(rows, k, n, gen, misaligned)
        tma = dn.tma_path(rows, k, n, x.data_ptr(), w.data_ptr(),
                          dy.data_ptr())
        check(tma == (not misaligned and k % 8 == 0 and n % 8 == 0),
              f"{what}: tma_path says {tma}")
        # the training layer and the misaligned view under the profiler
        # too: the kernels the card ran, by name, on the path counted
        profiled = (rows, k, n) == K7_TIMED[0] or misaligned
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with dense_counts(edge=True) as counts, (
                prof if profiled else contextlib.nullcontext()):
            _y, stats = _k7_case(what, x, w, b, dy)
        if profiled:
            ran = k7_paths(device_kernels(prof))
            check(ran == {"hopper" if tma else "edge"},
                  f"{what}: the profiler saw K7's {sorted(ran)} kernels")
        # each kernel twice (_k7_case), all on the path the rule picks
        want = {"launches": 2 if tma else 0, "edge_launches": 0 if tma else 2}
        check(all(counts[f.__name__] == want["launches"]
                  and counts["edge"][f.__name__] == want["edge_launches"]
                  for f in dn.KERNELS),
              f"{what}: launches {counts}, not {want} each")
        paths["hopper" if tma else "edge"] += 1
        for part, (_ok, share, most, over, _err) in stats.items():
            w_ = worst[part]
            worst[part] = [max(w_[0], share), max(w_[1], most), w_[2] + over]
        print(f"{what} on {card}: " + "; ".join(
            f"{part} {100 * share:.3f}% differ, up to {most} ulp"
            for part, (_ok, share, most, _o, _e) in stats.items())
            + f"; db bit-equal; two launches bit-equal; "
            f"{'Hopper' if tma else 'edge (first design)'} path"
            + (" (launch counts and the profiler's kernel names)" if profiled
               else " (launch counts)"))
        del x, w, b, dy, _y
    print(f"K7 vs plain on {card}: {len(cases)} cases ({paths['hopper']} on "
          f"the Hopper path, {paths['edge']} on the edge path, by the launch "
          f"counts), within {K7_TOL} (at most share differing / largest ulps "
          f"/ elements past an ulp): "
          + "; ".join(f"{p} {100 * s:.3f}% / {u} / {o}"
                      for p, (s, u, o) in worst.items()))
    print(f"K7 subnormal sums on {card}: {_k7_subnormal_probe()}")

    # the first design against the current one, in one call (A B B A):
    # both sides' launches timed alike, alone and in a CUDA graph
    srcs = [K7_EARLIER, os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                                     "dense.cu")]
    names = [os.path.relpath(path, ROOT) for path in srcs]
    with tempfile.TemporaryDirectory(prefix="k7_ab_") as outdir:
        fns = kernel_ab.build_all(srcs, kernel_ab.ENTRIES["k7"], outdir)
        bad, ab = kernel_ab.ab_k7(names, fns)
    check(bad == 0, "K7: a version of the A/B disagrees with the plain "
                    "versions")
    check(tuple(ab) == K7_TIMED, f"K7: the A/B timed {tuple(ab)}")

    def ab_ms(layer, path, key):
        return statistics.median(ab[layer][path][key])

    measured = {"dense_forward": {}, "dense_backward_input": {},
                "dense_backward_weight": {}}
    for rows, k, n in K7_TIMED:
        layer = (rows, k, n)
        x, w, b, dy = _k7_inputs(rows, k, n, gen)
        y = dn.dense_forward(x, w, b)
        want = dn.dense_forward_reference(x, w, b)
        dzb = torch.where(y > 0, dy, torch.zeros_like(dy))
        parts = {
            "dense_forward": dict(
                part="forward", key="fwd",
                plain=lambda: dn.dense_forward_reference(x, w, b),
                library=lambda: x @ w,
                err=float((y.float() - want.float()).abs().max()))}
        if rows == K7_TIMED[0][0]:
            gw = torch.zeros((k, n), device=DEV)
            gb = torch.zeros(n, device=DEV)
            dx = dn.dense_backward_input(w, y, dy)
            gws = []
            for fn in (dn.dense_backward_weight,
                       dn.dense_backward_weight_reference):
                gws.append(torch.zeros((k, n), device=DEV))
                fn(x, y, dy, gws[-1], torch.zeros(n, device=DEV))
            parts["dense_backward_input"] = dict(
                part="input", key="input",
                plain=lambda: dn.dense_backward_input_reference(w, y, dy),
                library=lambda: dzb @ w.t(),
                err=float((dx.float() - dn.dense_backward_input_reference(
                    w, y, dy).float()).abs().max()))
            parts["dense_backward_weight"] = dict(
                part="weight", key="weight",
                plain=lambda: dn.dense_backward_weight_reference(
                    x, y, dy, gw, gb),
                library=lambda: x.t() @ dzb,
                err=float((gws[0] - gws[1]).abs().max()))
        for name, p in parts.items():
            ms = ab_ms(layer, names[1], f"{p['key']}_ms")
            graph = ab_ms(layer, names[1], f"{p['key']}_graph_ms")
            earlier = ab_ms(layer, names[0], f"{p['key']}_ms")
            earlier_graph = ab_ms(layer, names[0], f"{p['key']}_graph_ms")
            plain, _ = _cuda_ms(p["plain"], reps=3)
            library, _ = _cuda_ms(p["library"], inner=BACK_TO_BACK)
            bound, by = roofline.dense_bound_ms(rows, k, n, p["part"])
            print(f"K7 {p['part']} {rows} x {k} -> {n} on {card}, A B B A "
                  f"against its first design (median of each version's "
                  f"two): launched alone back to back {ms:.4f} ms (first "
                  f"design {earlier:.4f}), in a CUDA graph {graph:.4f} ms "
                  f"(first design {earlier_graph:.4f}; "
                  f"{100 * bound / graph:.1f}% of the {bound:.6f} ms bound by "
                  f"{by}; {2 * rows * k * n / graph / 1e9:.1f} TFLOP/s); "
                  f"torch.matmul of the bf16 operands {library:.4f} ms; "
                  f"plain {plain:.4f} ms; max |d| from plain {p['err']}")
            numbers = dict(ms=ms, graph_ms=graph, earlier_ms=earlier,
                           earlier_graph_ms=earlier_graph, plain_ms=plain,
                           bound_ms=bound, bound_by=by, library_ms=library,
                           max_abs_err=p["err"])
            if rows == K7_TIMED[0][0]:
                measured[name].update(numbers)
            else:
                measured[name].update({
                    "block_" + key: v for key, v in numbers.items()
                    if key not in ("bound_by", "max_abs_err")})
        del x, w, b, dy, y, want, dzb, parts
    torch.cuda.empty_cache()
    return measured


def _k8_inputs(k, e_dim, h_dim, gen, misaligned=False):
    """K8's inputs on the card, from ``gen``: embed (fp32 ``[21, E]``), w1
    (fp32 ``[k*E, H]``, He-scaled), K4's output rows (fp32 ``[k*21 + 1,
    H]``) and sinks for the gradients of embed, w1 and b1 holding random
    values; with ``misaligned``, each in a view 4 bytes past its
    allocation."""
    import torch

    def normal(*shape, scale=1.0):
        t = torch.randn(*shape, generator=gen, device=DEV) * scale
        return _shifted(t.view(-1), 1).view(t.shape) if misaligned else t

    embed = normal(21, e_dim, scale=0.1)
    w1 = normal(k * e_dim, h_dim, scale=(2.0 / (k * e_dim)) ** 0.5)
    rows = normal(k * 21 + 1, h_dim, scale=1e-2)
    sinks = [normal(21, e_dim, scale=1e-3),
             normal(k * e_dim, h_dim, scale=1e-3), normal(h_dim, scale=1e-3)]
    return embed, w1, rows, sinks


def phase_k8(card):
    """8e: K8 (the fold and its gradient, ``csrc/fold.cu``) against its
    plain versions on the card over K8_SHAPES, and K8_MISALIGNED again in
    views 4 bytes past alignment: each direction launched twice, bit-equal
    to each other and to the plain version; then at the K8_TIMED folds
    each direction timed beside its launch floor, the captured
    backward-then-forward pair held bit-equal to the eager one, and the
    first design against the current one A B B A (module docstring).
    Returns the numbers by head, then by direction (``"forward"``,
    ``"backward"``)."""
    import torch

    from vcf2prot_tpu_torch.downstream import fold as fd
    from vcf2prot_tpu_torch.runtime.build import check_launch, load_kernels
    from vcf2prot_tpu_torch.utils import kernel_ab, roofline

    gen = torch.Generator(device=DEV)
    gen.manual_seed(29)
    cases = [(shape, False) for shape in K8_SHAPES] + [(K8_MISALIGNED, True)]
    for (k, e_dim, h_dim), misaligned in cases:
        what = (f"K8 k {k} E {e_dim} H {h_dim}"
                + (" 4 bytes past alignment" if misaligned else ""))
        embed, w1, rows, sinks = _k8_inputs(k, e_dim, h_dim, gen, misaligned)
        tables = [fd.fold_forward(embed, w1) for _ in range(2)]
        plain = fd.fold_forward_reference(embed, w1)
        check(torch.equal(tables[0], tables[1]),
              f"{what}: two forward launches differ")
        check(torch.equal(tables[0], plain), f"{what}: the table differs "
              f"from the plain version's in "
              f"{int((tables[0] != plain).sum())} entries")
        sums = []
        for fn in (fd.fold_backward, fd.fold_backward,
                   fd.fold_backward_reference):
            out = [s.clone() for s in sinks]
            fn(rows, embed, w1, *out)
            sums.append(out)
        for key, a, b, c in zip(("embed", "w1", "b1"), *sums):
            check(torch.equal(a, b), f"{what}: two backward launches differ "
                                     f"in {key}'s gradient")
            check(torch.equal(a, c), f"{what}: {key}'s gradient differs from "
                  f"the plain version's (max |d| "
                  f"{float((a - c).abs().max())})")
            check(bool(torch.isfinite(a).all()), f"{what}: {key} not finite")
        check(bool(torch.isfinite(tables[0].float()).all()),
              f"{what}: the table is not finite")
    torch.cuda.synchronize()
    print(f"K8 vs plain on {card}: {len(cases)} cases (k x E x H "
          f"{', '.join('x'.join(map(str, c)) for c in K8_SHAPES)}; "
          f"{'x'.join(map(str, K8_MISALIGNED))} also 4 bytes past "
          f"alignment): the table and the gradients added into sinks "
          f"holding random values bit-equal to the plain versions, two "
          f"launches bit-equal")

    # the first design against the current one, in one call (A B B A)
    names = [K8_EARLIER, os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                                      "fold.cu")]
    with tempfile.TemporaryDirectory(prefix="k8_ab_") as outdir:
        fns = kernel_ab.build_all(names, kernel_ab.ENTRIES["k8"], outdir)
        bad, ab = kernel_ab.ab_k8(names, fns)
    check(bad == 0, "K8: a version of the A/B differs from the plain "
                    "versions")
    check(tuple(ab) == tuple(K8_TIMED), f"K8: the A/B timed {tuple(ab)}")

    def ab_ms(head, path, key):
        return statistics.median(ab[head][path][key])

    lib = load_kernels()
    timed = {}
    for head, (k, e_dim, h_dim) in K8_TIMED.items():
        embed, w1, rows, sinks = _k8_inputs(k, e_dim, h_dim, gen)
        # the pair a step runs, captured (each kernel a programmatic
        # dependent of the one before it) against the same pair eagerly
        eager = [s.clone() for s in sinks]
        fd.fold_backward(rows, embed, w1, *eager)
        eager_table = fd.fold_forward(embed, w1)
        captured = [s.clone() for s in sinks]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fd.fold_backward(rows, embed, w1, *captured)
            graph_table = fd.fold_forward(embed, w1)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(graph_table, eager_table) and all(
            torch.equal(a, b) for a, b in zip(captured, eager)),
            f"K8 {head}: the captured backward-then-forward pair differs "
            f"from the eager one")
        del graph, graph_table, captured, eager, eager_table
        print(f"K8 {head}: the backward-then-forward pair captured in a "
              f"CUDA graph, each launch a programmatic dependent of the one "
              f"before it, bit-equal to the same pair run eagerly")
        floor = {part: _graph_ms(
            lambda b=int(part == "backward"): check_launch(
                lib.v2p_fold_launch_floor(
                    k, e_dim, h_dim, b,
                    torch.cuda.current_stream().cuda_stream),
                "fold launch floor")) for part in roofline.FOLD_PARTS}
        table = torch.empty((k * 21, h_dim), dtype=torch.bfloat16,
                            device=DEV)
        alone = {
            "forward": _launch_ms(lib.v2p_fold_forward, (
                embed.data_ptr(), w1.data_ptr(), k, e_dim, h_dim,
                table.data_ptr()), "fold"),
            "backward": _launch_ms(lib.v2p_fold_backward, (
                rows.data_ptr(), embed.data_ptr(), w1.data_ptr(), k, e_dim,
                h_dim, *(s.data_ptr() for s in sinks)), "fold gradient")}
        wrappers = {
            "forward": lambda: fd.fold_forward(embed, w1),
            "backward": lambda: fd.fold_backward(rows, embed, w1, *sinks)}
        plains = {
            "forward": lambda: fd.fold_forward_reference(embed, w1),
            "backward": lambda: fd.fold_backward_reference(rows, embed, w1,
                                                           *sinks)}
        w3 = w1.view(k, e_dim, h_dim)
        library, _ = _cuda_ms(lambda: torch.matmul(embed, w3),
                              inner=BACK_TO_BACK)
        class Layer1Rows(torch.autograd.Function):
            """Stands where the parent's WindowLayer1 stood behind the
            fold: its backward hands on K4's output rows as that layer's
            did (the table's gradient cast to bf16, b1's in fp32); its
            forward gives an empty tensor (no kernel)."""

            @staticmethod
            def forward(ctx, table, b1, rows):
                ctx.rows = rows
                return rows.new_empty(0)

            @staticmethod
            def backward(ctx, _g):
                return ctx.rows[:-1].to(torch.bfloat16), ctx.rows[-1], None

        # the torch ops K8 replaces: the fold and its cast; both ways, with
        # autograd of them into leaves whose gradients accumulate in place
        leaves = [t.clone().requires_grad_() for t in (embed, w1, sinks[2])]
        for leaf in leaves:
            leaf.grad = torch.zeros_like(leaf)

        def torch_fold(e, w):
            return torch.einsum("ve,keh->kvh", e, w.reshape(
                k, e_dim, h_dim)).reshape(k * 21, h_dim).to(
                    torch.bfloat16).contiguous()

        def replaced_both():
            out = Layer1Rows.apply(torch_fold(*leaves[:2]), leaves[2], rows)
            out.backward(out)

        def pair():
            fd.fold_backward(rows, embed, w1, *sinks)
            return fd.fold_forward(embed, w1)

        replaced_fwd = _graph_ms(lambda: torch_fold(embed, w1))
        replaced_pair = _graph_ms(replaced_both)
        pair_graph = _graph_ms(pair)
        numbers = {}
        for part in roofline.FOLD_PARTS:
            wrapper, _ = _cuda_ms(wrappers[part], inner=BACK_TO_BACK)
            plain, _ = _cuda_ms(plains[part])
            graph = _graph_ms(wrappers[part])
            bound, by = roofline.fold_bound_ms(k, e_dim, h_dim, part)
            key = "fwd" if part == "forward" else "bwd"
            numbers[part] = dict(
                max_abs_err=0.0, ms=alone[part], graph_ms=graph,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                wrapper_ms=wrapper, floor_ms=floor[part],
                library_ms=library if part == "forward" else None,
                earlier_ms=ab_ms(head, names[0], f"{key}_ms"),
                earlier_graph_ms=ab_ms(head, names[0], f"{key}_graph_ms"),
                replaced_graph_ms=(replaced_fwd if part == "forward"
                                   else replaced_pair),
                pair_graph_ms=pair_graph)
            print(f"K8 {part}, the {head} head's fold (k {k}, E {e_dim}, H "
                  f"{h_dim}) on {card}: launched alone back to back "
                  f"{alone[part]:.4f} ms, in a CUDA graph {graph:.4f} ms "
                  f"({100 * bound / graph:.1f}% of the {bound:.6f} ms bound "
                  f"by {by}; the launch floor on its grid "
                  f"{floor[part]:.4f} ms in a CUDA graph), wrapper "
                  f"{wrapper:.4f} ms, plain {plain:.4f} ms; the first "
                  f"design in the A/B {numbers[part]['earlier_ms']:.4f} ms "
                  f"alone, {numbers[part]['earlier_graph_ms']:.4f} in a "
                  f"graph (this design "
                  f"{ab_ms(head, names[1], key + '_ms'):.4f} / "
                  f"{ab_ms(head, names[1], key + '_graph_ms'):.4f})"
                  + (f"; torch.matmul of embed and w1 (fp32, no cast) "
                     f"{library:.4f} ms; the einsum and cast it replaces "
                     f"{replaced_fwd:.4f} ms in a CUDA graph"
                     if part == "forward" else ""))
        print(f"K8 both ways, the {head} head's fold, on {card}: in a CUDA "
              f"graph {pair_graph:.4f} ms (the A/B's pair: first design "
              f"{ab_ms(head, names[0], 'pair_graph_ms'):.4f}, this one "
              f"{ab_ms(head, names[1], 'pair_graph_ms'):.4f}); the torch ops "
              f"they replace (the "
              f"einsum and its cast, the table gradient's casts, the "
              f"einsum's gradient, the AccumulateGrads of embed, w1 and b1) "
              f"{replaced_pair:.4f} ms in a CUDA graph")
        timed[head] = numbers
    torch.cuda.empty_cache()
    return timed


def _k9_outputs(hidden, depth, rows, n_batches, dp, offs, gen):
    """Phase 8f's arguments of a K9 case (K9_CASES) on the card, each a
    view ``offs`` elements (bytes for u8) into a buffer of random values
    with 16 elements on either side: ``(params, epoch, batch, grad, casts,
    guards)``, the parameters in a buffer ``offs[0]`` in (the hidden
    weights' views of it, the gradient buffer), the casts' bf16 buffers
    ``offs[1]`` in, the epoch and batch buffers ``offs[2]`` in, then K5's
    moments ``offs[0]`` in (nu >= 0); ``guards`` the buffers with their
    elements outside the views, to hold unchanged. A dict of those, the
    parameter buffer as ``flat``."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream.scoring import (
        TrainableHead,
        init_params,
    )

    guards = []

    def at(n, dtype, off, shape):
        base = (torch.randint(0, 256, (n + 32,), dtype=torch.uint8,
                              generator=gen, device=DEV)
                if dtype == torch.uint8 else
                torch.randn(n + 32, generator=gen, device=DEV).to(dtype))
        lo = 16 - off
        guards.append((base, lo, lo + n, torch.cat([base[:lo],
                                                   base[lo + n:]])))
        return base[lo:lo + n].view(shape)

    params = init_params(NEO_K, seed=3, hidden=hidden, depth=depth)
    head = TrainableHead.from_params(params)
    n = head.flat.numel()
    flat = at(n, torch.float32, offs[0], (n,))
    flat.copy_(head.flat.to(DEV))
    grad = at(n, torch.float32, offs[0], (n,))
    casts, off = [], 0
    for name, p in head.named_parameters():
        if name in head.names[1:-1]:
            w = flat[off:off + p.numel()].view(p.shape)
            casts.append((w, at(p.numel(), torch.bfloat16, offs[1],
                                p.shape)))
        off += p.numel()
    shapes = [(torch.uint8, (rows, NEO_K)), (torch.float32, (rows,)),
              (torch.float32, (rows,))] + ([(torch.float32, ())] if dp
                                           else [])
    epoch, batch = [], []
    for dtype, shape in shapes:
        size = int(np.prod(shape, dtype=np.int64))
        epoch.append(at(n_batches * size, dtype, offs[2],
                        (n_batches, *shape)))
        batch.append(at(size, dtype, offs[2], shape))
    mu = at(n, torch.float32, offs[0], (n,)).mul_(1e-2)
    nu = at(n, torch.float32, offs[0], (n,)).abs_().mul_(1e-2)
    return dict(params=params, flat=flat, epoch=epoch, batch=batch,
                grad=grad, casts=casts, guards=guards, mu=mu, nu=nu)


def _guards_hold(guards) -> bool:
    import torch

    return all(torch.equal(torch.cat([base[:lo], base[hi:]]), saved)
               for base, lo, hi, saved in guards)


def phase_k9(card):
    """8f: K9 (``csrc/step.cu``, the training step's prologue) against its
    plain version on the card over K9_CASES at K9_STEPS, bit-equal and
    writing nothing outside its outputs; K5 with and without its step
    tail, bit-equal, its block ticket 0 after each launch; K5 with the
    step's jobs against its plain version over K5_JOB_CASES; K9, and K5
    with its jobs and with its tail alone, timed at the 128x1 and 512x3
    steps (module docstring). Returns K9's numbers by head and, apart,
    K5's with the jobs and with its tail alone by head."""
    import ctypes

    import torch

    from vcf2prot_tpu_torch.downstream import adam as ad
    from vcf2prot_tpu_torch.downstream import step as st
    from vcf2prot_tpu_torch.runtime.build import load_kernels
    from vcf2prot_tpu_torch.utils import roofline

    gen = torch.Generator(device=DEV)
    gen.manual_seed(31)
    timed = {}
    for (hidden, depth), rows, n_batches, dp, offs in K9_CASES:
        what = (f"K9 {hidden}x{depth}, {rows} rows x {n_batches} batches"
                + (", with the batches' mask counts" if dp else "")
                + (f", {offs} past alignment" if any(offs) else ""))
        for steps_v in K9_STEPS:
            steps = torch.tensor(steps_v, dtype=torch.int64, device=DEV)
            outs = []
            for fn in (st.step_prologue, st.step_prologue,
                       st.step_prologue_reference):
                gen.manual_seed(steps_v % 1000 + 7 * len(timed))
                o = _k9_outputs(hidden, depth, rows, n_batches, dp, offs,
                                gen)
                params, epoch, batch, grad, casts, guards = (o[key] for key in (
                    "params", "epoch", "batch", "grad", "casts", "guards"))
                before = launches(st.step_prologue)
                fn(steps, epoch, batch, grad, casts)
                torch.cuda.synchronize()
                check(launches(st.step_prologue)
                      == before + (fn is st.step_prologue),
                      f"{what}: K9's launches not counted")
                check(_guards_hold(guards), f"{what}, step {steps_v}: "
                      f"{fn.__name__} wrote outside its outputs")
                outs.append([*batch, grad,
                             *(c.view(torch.int16) for _w, c in casts)])
            check(int(steps) == steps_v, f"{what}: the step count moved")
            for a, b, c in zip(*outs):
                check(torch.equal(a, b), f"{what}, step {steps_v}: two "
                      f"launches differ")
                check(torch.equal(a, c), f"{what}, step {steps_v}: K9 "
                      f"differs from its plain version")
            check(not outs[0][len(batch)].signbit().any(),
                  f"{what}: the gradient holds -0.0")
        timed.setdefault(f"{hidden}x{depth}", (params, rows, n_batches)
                         if not any(offs) and not dp else None)
    print(f"K9 vs plain on {card}: {len(K9_CASES)} cases (" + "; ".join(
        f"{h}x{d} {r} rows x {nb} batches" + (" +counts" if dp else "")
        + (f" {offs} past alignment" if any(offs) else "")
        for (h, d), r, nb, dp, offs in K9_CASES) + f") at step counts "
        f"{K9_STEPS}: the batch, the zeroed gradient and the bf16 casts "
        f"bit-equal to the plain version, two launches bit-equal, nothing "
        f"written outside the outputs")

    # K5 with its step tail against K5 without it
    for what, n, off in (("128x1", 37_793, 0), ("512x3", 674_465, 0),
                         ("128x1 1 element past alignment", 37_793, 1)):
        sets = []
        for _ in range(3):
            gen.manual_seed(41)
            arrays = []
            for scale in (0.1, 1e-2, 1e-2):
                base = torch.randn(n + 4, generator=gen, device=DEV) * scale
                arrays.append(base[off:off + n])
            arrays[2].abs_()
            sets.append(arrays + [torch.tensor([5, 0], dtype=torch.int32,
                                               device=DEV),
                                  torch.zeros(ad.POWERS, dtype=torch.int32,
                                              device=DEV)])
        losses = [torch.full((K5_TAIL_LOSSES,), -1.0, device=DEV)
                  for _ in range(2)]
        steps = [torch.tensor(K5_TAIL_LOSSES - 2, dtype=torch.int64,
                              device=DEV) for _ in range(2)]
        for i in range(K5_STEPS):
            g = torch.randn(n, generator=gen, device=DEV) * 1e-3
            loss = torch.tensor(0.5 + i, device=DEV)
            for j, (p, mu, nu, count, powers) in enumerate(sets):
                tail = (dict(loss=loss, losses=losses[0], steps=steps[0])
                        if j == 0 else {})
                if j < 2:
                    ad.adam_update(p, g, mu, nu, count, 1e-3, powers, **tail)
                    torch.cuda.synchronize()
                    check(int(count[1]) == 0, f"K5 {what}: the block ticket "
                          f"is {int(count[1])} after a launch"
                          + (" with the tail" if tail else ""))
                else:
                    ad.adam_update_reference(p, g, mu, nu, count, 1e-3,
                                             loss, losses[1], steps[1])
        for key, a, b, c in zip(("p", "mu", "nu", "count"), *(
                sets_i[:4] for sets_i in sets)):
            check(torch.equal(a, b), f"K5 {what}: {key} with the tail "
                  f"differs from {key} without it")
            check(torch.equal(a, c), f"K5 {what}: {key} differs from the "
                  f"plain version's")
        check(torch.equal(losses[0], losses[1])
              and torch.equal(steps[0], steps[1])
              and int(steps[0]) == K5_TAIL_LOSSES - 2 + K5_STEPS,
              f"K5 {what}: the tail's losses {losses[0].tolist()} / steps "
              f"{int(steps[0])}, plain {losses[1].tolist()} / "
              f"{int(steps[1])}")
    print(f"K5 with its step tail on {card} (128x1, 512x3, 128x1 1 element "
          f"past alignment; {K5_STEPS} steps from a fresh cache, the losses "
          f"wrapping {K5_TAIL_LOSSES} slots): p, mu, nu and the count "
          f"bit-equal to K5 without the tail and to the plain version, the "
          f"block ticket 0 after every launch, the losses and the step "
          f"count the plain version's")

    # K5 with the step's jobs against its plain version
    for (hidden, depth), rows, n_batches, dp, offs in K5_JOB_CASES:
        what = (f"K5 with the step's jobs, {hidden}x{depth}, {rows} rows x "
                f"{n_batches} batches"
                + (", with the batches' mask counts" if dp else "")
                + (f", {offs} past alignment" if any(offs) else ""))
        for steps_v in K9_STEPS:
            outs = []
            for kernel in (True, True, False):
                gen.manual_seed(steps_v % 1000 + 11)
                o = _k9_outputs(hidden, depth, rows, n_batches, dp, offs,
                                gen)
                o["grad"].mul_(1e-3)
                count = torch.tensor([5, 0], dtype=torch.int32, device=DEV)
                powers = torch.zeros(ad.POWERS, dtype=torch.int32,
                                     device=DEV)
                losses = torch.full((K5_TAIL_LOSSES,), -1.0, device=DEV)
                steps = torch.tensor(steps_v, dtype=torch.int64, device=DEV)
                args = (o["flat"], o["grad"], o["mu"], o["nu"], count, 1e-3)
                tail = (torch.tensor(0.75, device=DEV), losses, steps)
                jobs = dict(epoch=o["epoch"], batch=o["batch"],
                            casts=o["casts"])
                if kernel:
                    before = launches(ad.adam_update)
                    ad.adam_update(*args, powers, *tail, **jobs)
                    torch.cuda.synchronize()
                    check(launches(ad.adam_update) == before + 1,
                          f"{what}: K5's launch not counted")
                    check(int(count[1]) == 0, f"{what}, step {steps_v}: the "
                          f"block ticket is {int(count[1])} after a launch")
                else:
                    ad.adam_update_reference(*args, *tail, **jobs)
                check(_guards_hold(o["guards"]), f"{what}, step {steps_v}: "
                      f"{'K5' if kernel else 'the plain version'} wrote "
                      f"outside its outputs")
                outs.append([*args[:5], losses, steps, *o["batch"],
                             *(c.view(torch.int16) for _w, c in o["casts"])])
            for a, b, c in zip(*outs):
                check(torch.equal(a, b), f"{what}, step {steps_v}: two "
                      f"launches differ")
                check(torch.equal(a, c), f"{what}, step {steps_v}: K5 "
                      f"differs from its plain version")
            check(not outs[0][1].any() and not outs[0][1].signbit().any(),
                  f"{what}: the gradient is not +0.0 after K5")
            check(int(outs[0][6]) == steps_v + 1, f"{what}: steps "
                  f"{int(outs[0][6])}")
    print(f"K5 with the step's jobs vs plain on {card}: "
          f"{len(K5_JOB_CASES)} cases (K9's, then " + "; ".join(
              f"{h}x{d} {r} rows x {nb} batches" + (" +counts" if dp else "")
              + f" {offs} past alignment"
              for (h, d), r, nb, dp, offs in K5_JOB_CASES[len(K9_CASES):])
          + f") at step counts {K9_STEPS}: p, mu, nu, the count, the "
          f"zeroed gradient, the loss and step count, batch (steps + 1) % "
          f"n_batches and the bf16 casts of the updated hidden weights "
          f"bit-equal to the plain version, two launches bit-equal, the "
          f"block ticket 0 after every launch, nothing written outside the "
          f"outputs")

    lib = load_kernels()
    numbers, k5_numbers = {}, {}
    for head in ("128x1", "512x3"):
        params, rows, n_batches = timed[head]
        hidden, depth = HEADS[head]["hidden"], HEADS[head]["depth"]
        o = _k9_outputs(hidden, depth, rows, n_batches, False, (0, 0, 0),
                        gen)
        epoch, batch, grad, casts = (o[key] for key in (
            "epoch", "batch", "grad", "casts"))
        steps = torch.tensor(3, dtype=torch.int64, device=DEV)
        copies = (ctypes.c_int64 * 9)(*(
            v for src, dst in zip(epoch, batch)
            for v in (src.data_ptr(), dst.data_ptr(),
                      dst.numel() * dst.element_size())))
        cast_rows = (ctypes.c_int64 * (3 * max(len(casts), 1)))(*(
            v for w, out in casts
            for v in (w.data_ptr(), out.data_ptr(), w.numel())))
        alone = _launch_ms(lib.v2p_step_prologue, (
            steps.data_ptr(), n_batches, ctypes.addressof(copies), 3,
            grad.data_ptr(), grad.numel() * 4,
            ctypes.addressof(cast_rows) if casts else None, len(casts)),
            "step prologue")
        wrapper, _ = _cuda_ms(lambda: st.step_prologue(
            steps, epoch, batch, grad, casts), inner=BACK_TO_BACK)
        graph = _graph_ms(lambda: st.step_prologue(steps, epoch, batch,
                                                   grad, casts))
        plain, _ = _cuda_ms(lambda: st.step_prologue_reference(
            steps, epoch, batch, grad, casts))
        replaced = _graph_ms(lambda: st.step_prologue_reference(
            steps, epoch, batch, grad, casts))
        n_bytes = roofline.step_prologue_bytes(params, rows)
        bound, by = roofline.bound_ms(n_bytes)
        # K5 in a CUDA graph with the step's jobs (the step's share of K9)
        # and with its tail alone (as before them), A B B A, each side from
        # the same parameters, moments and gradient (K9 above zeroed it)
        flat, mu, nu = o["flat"], o["mu"], o["nu"]
        grad.copy_(torch.randn(grad.shape, generator=gen, device=DEV) * 1e-3)
        state = [flat, grad, mu, nu]
        saved = [t.clone() for t in state]
        count = torch.zeros(2, dtype=torch.int32, device=DEV)
        powers = torch.zeros(ad.POWERS, dtype=torch.int32, device=DEV)
        tail = (torch.tensor(0.5, device=DEV),
                torch.zeros(K5_TAIL_LOSSES, device=DEV), steps)
        jobs = dict(epoch=epoch, batch=batch, casts=casts)
        k5 = {"jobs": [], "tail": []}
        for side in ("jobs", "tail", "tail", "jobs"):
            for t, t0 in zip(state, saved):
                t.copy_(t0)
            count.zero_()
            powers.zero_()
            k5[side].append(_graph_ms(lambda: ad.adam_update(
                flat, grad, mu, nu, count, 1e-3, powers, *tail,
                **(jobs if side == "jobs" else {}))))
        job_bytes = roofline.adam_step_bytes(params, rows)
        job_bound, job_by = roofline.bound_ms(job_bytes,
                                              roofline.adam_ops(flat.numel()))
        numbers[head] = dict(
            max_abs_err=0.0, ms=alone, graph_ms=graph, plain_ms=plain,
            bound_ms=bound, bound_by=by, wrapper_ms=wrapper,
            library_ms=None, replaced_graph_ms=replaced)
        k5_numbers[head] = dict(
            jobs_graph_ms=statistics.median(k5["jobs"]),
            tail_graph_ms=statistics.median(k5["tail"]),
            jobs_bound_ms=job_bound)
        print(f"K5 at the {head} step on {card}, in a CUDA graph, A B B A: "
              f"with the step's jobs (the gradient zeroed, "
              f"{len(casts)} hidden weights cast, the next batch staged) "
              + " / ".join(f"{t:.4f}" for t in k5["jobs"])
              + " ms, with its tail alone "
              + " / ".join(f"{t:.4f}" for t in k5["tail"])
              + f" ms; bound with the jobs {job_bound:.6f} ms by {job_by} "
              f"({job_bytes} bytes), "
              f"{100 * job_bound / k5_numbers[head]['jobs_graph_ms']:.1f}% of "
              f"it")
        print(f"K9 at the {head} step ({rows} rows x {n_batches} batches, "
              f"{grad.numel()} gradients zeroed, {len(casts)} hidden "
              f"weights cast) on {card}: launched alone back to back "
              f"{alone:.4f} ms, in a CUDA graph {graph:.4f} ms "
              f"({100 * bound / graph:.1f}% of the {bound:.6f} ms bound by "
              f"{by}, {n_bytes} bytes), wrapper {wrapper:.4f} ms, plain "
              f"{plain:.4f} ms; the torch ops it replaced in a CUDA graph "
              f"{replaced:.4f} ms")
        del epoch, batch, grad, casts, o, flat, mu, nu, state, saved
    torch.cuda.empty_cache()
    return numbers, k5_numbers


def launches(kernel) -> int:
    """``kernel``'s launches in this process, the one count of them
    (``train.launches``: a wrapper's own launches plus, for a kernel of
    ``train.STEP_KERNELS``, each captured step's launches times its
    replays). Counts are read as differences and never reset."""
    from vcf2prot_tpu_torch.downstream import train

    return train.launches(kernel)


def launch_counts(since=None, kernels=None) -> dict:
    """``{wrapper: launches}`` by :func:`launches`; with ``since`` (an
    earlier result), the launches made after it; of ``kernels``, by
    default the kernels a training step launches (``train.STEP_KERNELS``)."""
    from vcf2prot_tpu_torch.downstream import train

    now = {f: launches(f) for f in kernels or train.STEP_KERNELS}
    return now if since is None else {f: n - since[f] for f, n in now.items()}


def candidates_s() -> float:
    """The host seconds the device-resident chain has waited for its
    candidate counts in this process (the tracer's
    ``v2p.chain.candidates`` spans, whether or not a profiler recorded)."""
    from vcf2prot_tpu_torch.utils.timers import TRACER

    return sum(TRACER.spans("v2p.chain.candidates", traced)[1]
               for traced in (False, True))


@contextlib.contextmanager
def dense_counts(edge=False):
    """K7's launches on its Hopper path in the body (:func:`launches`),
    read into the dict it yields when the body ends; with ``edge``, its
    edge path's too (under ``"edge"``), else none may have run there: the
    head's layers always take the Hopper path."""
    from vcf2prot_tpu_torch.downstream.dense import KERNELS

    counts = {}
    start = launch_counts(kernels=KERNELS)
    edge_start = {f: f.edge_launches for f in KERNELS}
    yield counts
    counts.update({f.__name__: n
                   for f, n in launch_counts(start, KERNELS).items()})
    edges = {f.__name__: f.edge_launches - edge_start[f] for f in KERNELS}
    if edge:
        counts["edge"] = edges
    else:
        check(not any(edges.values()),
              f"K7 took its edge path on a head's layers: {edges}")


@contextlib.contextmanager
def epoch_loop_watch(sync_error=True, profiler=None):
    """``downstream.train._epoch_loop`` (a single-device fit's epochs: the
    permutations, the gathers and every step) run under
    ``torch.cuda.set_sync_debug_mode("error")``, so that a wait for the
    device there raises, and, given a ``torch.profiler.profile`` object,
    inside it, after PROFILER_WARMUP spin kernels (``torch.cuda._sleep``,
    named ``spin_kernel``) and a wait for them: the profiler records no
    device activity in the first tens of microseconds after it starts (a
    fit's first K9 and the first kernels of its first replay went missing
    without them), and :func:`_fit_profile` leaves the spin kernels out."""
    import torch

    from vcf2prot_tpu_torch.downstream import train

    real = train._epoch_loop

    def watched(*args):
        with profiler if profiler is not None else contextlib.nullcontext():
            if profiler is not None:
                for _ in range(PROFILER_WARMUP):
                    torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
            if sync_error:
                torch.cuda.set_sync_debug_mode("error")
            try:
                real(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if profiler is not None:
                torch.cuda.synchronize()

    train._epoch_loop = watched
    try:
        yield
    finally:
        train._epoch_loop = real


def phase_train(card):
    """The port's fit on the synthetic MHC task for the four heads (the
    training path), through the functions of tools/train_synth_mhc.py,
    each step a replay of its captured graph and every epoch loop under
    ``set_sync_debug_mode("error")``; returns the trained weights by head
    and the path's K3-K9 launches (replays counted)."""
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.adam import adam_update
    from vcf2prot_tpu_torch.downstream.dense import KERNELS as DENSE_KERNELS
    from vcf2prot_tpu_torch.downstream.fold import fold_backward, fold_forward
    from vcf2prot_tpu_torch.downstream.head_tail import (
        head_tail_backward,
        head_tail_forward,
    )
    from vcf2prot_tpu_torch.downstream.synth_mhc import oracle_auc
    from vcf2prot_tpu_torch.downstream.scoring import (
        window_layer1,
        window_layer1_backward,
    )
    from vcf2prot_tpu_torch.downstream.step import step_prologue
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, truth, n_tr = mhc.split_task(MHC_N)
    ceiling = oracle_auc(truth[n_tr:], labels[n_tr:])
    artifact = mhc.read_aucs(MHC_ARTIFACT)
    steps = MHC_EPOCHS * -(-n_tr // MHC_BATCH)
    # one step first, so that no fit wall holds cuBLAS's and the
    # allocator's start-up
    train.fit(win[:MHC_BATCH], labels[:MHC_BATCH], epochs=1,
              batch_size=MHC_BATCH, device=DEV)
    start = launch_counts()
    for f in DENSE_KERNELS:
        f.edge_launches = 0
    aucs, trained, k6, k8 = {}, {}, {}, {}
    for name, shape in TRAIN_HEADS.items():
        before = launch_counts()
        with epoch_loop_watch():
            trained[name], aucs[name], wall = mhc.train_config(
                win, labels, n_tr, epochs=MHC_EPOCHS, device=DEV, **shape)
        ran = launch_counts(before)
        k6[name] = (ran[head_tail_forward], ran[head_tail_backward])
        k8[name] = (ran[fold_forward], ran[fold_backward])
        # K6 and K8 once each way a step, on every head
        want = (steps + train.CAPTURE_WARMUP,) * 2
        check(k6[name] == want, f"{name}: K6 launched {k6[name]} times "
              f"(forward, backward), not {want}")
        check(k8[name] == want, f"{name}: K8 launched {k8[name]} times "
              f"(forward, backward), not {want}")
        print(f"train {name} on {card}: holdout AUC {aucs[name]:.4f} "
              f"(JAX package's artifact {artifact[name]:.4f}, oracle "
              f"ceiling {ceiling:.4f}); fit wall {wall:.3f} s for {steps} "
              f"steps of {MHC_BATCH}, captured ({wall / steps * 1e3:.3f} ms "
              f"a step, host clock); its epochs waited for the device "
              f"nowhere (set_sync_debug_mode('error'))")
        check(artifact[name] - 0.01 <= aucs[name] <= ceiling + 0.02,
              f"{name} holdout AUC {aucs[name]:.4f} outside "
              f"[{artifact[name] - 0.01:.4f}, {ceiling + 0.02:.4f}]")
    ran = launch_counts(start)
    launches = {f.__name__: ran[f] for f in (
        window_layer1, window_layer1_backward, adam_update, step_prologue,
        head_tail_forward, head_tail_backward, *DENSE_KERNELS, fold_forward,
        fold_backward)}
    print(f"K6 and K8 launches by head (forward, backward; {steps} steps "
          f"and {train.CAPTURE_WARMUP} warm-up steps a fit): K6 {k6}, K8 "
          f"{k8}")
    # each fit: CAPTURE_WARMUP steps, then one replay a step (K3 also
    # scores each holdout)
    want = len(TRAIN_HEADS) * (steps + train.CAPTURE_WARMUP)
    check(launches["window_layer1_backward"] == launches["adam_update"]
          == want <= launches["window_layer1"],
          f"training path launches {launches}: K4 and K5 not {want}, or K3 "
          f"fewer")
    # K9 once an epoch, after each epoch's gather: none in a step (K5's
    # jobs take its per-step work)
    check(launches["step_prologue"] == len(TRAIN_HEADS) * MHC_EPOCHS,
          f"training path launches {launches}: K9 not once an epoch "
          f"({len(TRAIN_HEADS) * MHC_EPOCHS})")
    # K7 both ways once a step for each hidden layer after the first (the
    # 512x3 head's two), its forward also in the holdouts' scoring
    want = sum(shape["depth"] - 1 for shape in TRAIN_HEADS.values()) * (
        steps + train.CAPTURE_WARMUP)
    check(launches["dense_backward_input"]
          == launches["dense_backward_weight"] == want
          <= launches["dense_forward"],
          f"training path launches {launches}: K7's gradients not {want}, "
          f"or its forward fewer")
    check(not any(f.edge_launches for f in DENSE_KERNELS),
          "K7 took its edge path on the training path: "
          + str({f.__name__: f.edge_launches for f in DENSE_KERNELS}))
    check(aucs["128x1"] > aucs["8x1"],
          f"128x1 AUC {aucs['128x1']} not above 8x1 {aucs['8x1']}")
    print(f"training path launches (replays counted): {launches}")
    return trained, launches


def _step_runner(params, devices=(DEV,), capture=True):
    """One training step of MHC_BATCH rows of the MHC task over
    ``devices`` (one replica each, an equal slice of the batch each), as a
    callable: the fit's own set-up and step (``train._trainer``) on a
    one-batch epoch, captured on one device unless ``capture`` is False,
    eager on several, as the dp fit runs it."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, _truth, _n = mhc.split_task(MHC_BATCH)
    devices = tuple(map(torch.device, devices))
    _replicas, _losses, fill, run = train._trainer(
        (win, labels, np.ones_like(labels)), params, devices, MHC_BATCH,
        1e-3, True, 0.0, 1, capture)
    fill(torch.arange(MHC_BATCH, device=devices[0]))
    return run


def _step_ms(params, devices=(DEV,), capture=True, reps=20):
    """Median time of one training step (:func:`_step_runner`): steps back
    to back after 3 more, a CUDA event at each step's end."""
    import torch

    run = _step_runner(params, devices, capture)
    for _ in range(3):
        run()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        run()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


# CUDA API calls (cuda* and cu*) that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")


# K7's kernels as the profiler names them (csrc/dense.cu): the Hopper
# path's dense_kernel<kind>, the edge path's first-design kernels
K7_KERNEL = re.compile(
    r"\b(hopper)::dense_kernel\b|\b(edge)::dense_\w+_kernel\b")


def device_kernels(prof):
    """The names of the device kernels and copies that ``prof`` (a
    ``torch.profiler.profile`` that has ended) recorded."""
    import torch

    return {ev.key for ev in prof.key_averages()
            if (getattr(ev, "device_time_total", 0) or 0)
            and getattr(ev, "device_type", None)
            == torch.autograd.DeviceType.CUDA}


def k7_paths(names):
    """The K7 paths (``"hopper"``, ``"edge"``) whose kernels are among
    the kernel ``names``: what the card ran, not what a counter says."""
    return {m.group(1) or m.group(2) for m in map(K7_KERNEL.search, names)
            if m}


# cuBLAS's and CUTLASS's product kernels, as the profiler names them: none
# may run in a training step (K7 takes the hidden layers, K8 the fold)
LIBRARY_PRODUCT = re.compile(r"gemm|bmm", re.IGNORECASE)


def port_kernels():
    """A pattern that finds the port's own kernels (every ``__global__``
    function of ``vcf2prot_tpu_torch/csrc/*.cu``) in the profiler's kernel
    names."""
    import glob

    names = set()
    for path in glob.glob(os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as fh:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", fh.read()))
    return re.compile(r"\b(?:" + "|".join(sorted(names)) + r")\b\s*[<(]")


def _fit_profile(win, labels, n_tr, shape, capture):
    """One 2-epoch fit of the MHC task, its epoch loop alone under
    ``torch.profiler``: a dict of the host calls that put work on a stream
    a step (``calls``, and ``by_call`` by name), the device kernels and
    copies a step (``kernels``, and ``names`` by name), the device busy ms
    a step (``busy``; zeros where the profiler records no such event), the
    host's ``aten::`` events a step by name (``ops``: the eager step's
    torch ops; a replay records none), the ``aten::`` ops run inside an
    AccumulateGrad a step (``accumulated``: autograd adding a gradient
    into place; one whose gradient went to a sink runs none), and the K7
    paths whose kernels ran (``k7``, :func:`k7_paths`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import init_params

    epochs = 2
    steps = epochs * -(-n_tr // MHC_BATCH)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with epoch_loop_watch(sync_error=False, profiler=prof):
        train.fit(win[:n_tr], labels[:n_tr], epochs=epochs,
                  batch_size=MHC_BATCH, seed=0, device=DEV, capture=capture,
                  params=init_params(NEO_K, seed=0, **shape))
    calls, names, ops, busy = {}, {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.key in LAUNCH_CALLS:
            calls[ev.key] = ev.count / steps
        if SPIN_KERNEL.search(ev.key) or ev.key == "aten::_sleep":
            continue
        total = getattr(ev, "device_time_total", 0) or 0
        if total and getattr(ev, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            names[ev.key] = ev.count / steps
            busy += total / 1e3
        elif ev.key.startswith("aten::"):
            ops[ev.key] = ev.count / steps
    # the warm-up's spin kernels were launched by cudaLaunchKernel
    calls["cudaLaunchKernel"] = (calls.get("cudaLaunchKernel", 0.0)
                                 - PROFILER_WARMUP / steps)
    accumulated = 0
    for ev in prof.events():
        parent = ev.cpu_parent
        while parent is not None and "AccumulateGrad" not in parent.name:
            parent = parent.cpu_parent
        accumulated += ev.name.startswith("aten::") and parent is not None
    return {"calls": sum(calls.values()), "by_call": calls,
            "kernels": sum(names.values()), "names": names,
            "busy": busy / steps, "ops": ops,
            "accumulated": accumulated / steps,
            "k7": k7_paths(device_kernels(prof)), "epochs": epochs,
            "steps": steps}


def phase_step_times(card, k4, k6, k7, k8):
    """9b: the captured step against the eager one (``capture=False``):
    device time a step, host calls and device kernels a step, the shares of
    K4, K6, K8 and (512x3) K7, K7's kernels by the profiler's names (the
    Hopper path's alone at 512x3, none at 128x1), the device kernels a
    step by name against the parent's count, no library product, every
    kernel run once a step the port's own and none of the torch kernels K9
    and K5's tail replaced, no torch op run by an AccumulateGrad and no
    cast in the eager step, then
    phase 9's fits captured against eager, A B B A, with their weights
    bit-equal; beside each head's bound from ``utils/roofline.py``."""
    import numpy as np

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc
    from vcf2prot_tpu_torch.utils import roofline

    step = {}
    for name, shape in TRAIN_HEADS.items():
        params = init_params(NEO_K, seed=0, **shape)
        step[name] = {mode: _step_ms(params, capture=mode == "captured")
                      for mode in ("captured", "eager")}
    print(f"median step on {card} ({MHC_BATCH} rows, CUDA events, 20 steps "
          f"back to back; captured / eager ms): " + "; ".join(
              f"{n} {v['captured']:.4f} / {v['eager']:.4f}"
              for n, v in step.items()))
    k6_ms = {"128x1": k6["forward"]["pair_graph_ms"],
             "512x3": k6["forward"]["wide_pair_graph_ms"]}
    k8_ms = {name: k8[name]["forward"]["pair_graph_ms"] for name in HEADS}
    for name in HEADS:
        params = init_params(NEO_K, seed=0, **HEADS[name])
        bound, by = roofline.train_step_bound_ms(params, MHC_BATCH)
        k4_ms = k4[(name, K4_ROWS[0])]["ms"]
        print(f"{name} step bound {bound:.6f} ms by {by} "
              f"(utils/roofline.py: K8, K3, the products, their "
              f"gradients, K4, K8's gradient, K5 with the step's jobs); "
              f"captured step "
              f"{100 * bound / step[name]['captured']:.1f}% of it; K4 "
              f"{k4_ms:.4f} ms, "
              f"{100 * k4_ms / step[name]['captured']:.1f}% of the captured "
              f"step; K6 both ways in a graph {k6_ms[name]:.4f} ms, "
              f"{100 * k6_ms[name] / step[name]['captured']:.1f}%; K8 both "
              f"ways in a graph {k8_ms[name]:.4f} ms, "
              f"{100 * k8_ms[name] / step[name]['captured']:.1f}%")
    # K7 a 512x3 step: its three kernels in a graph, for each of the two
    # hidden layers after the first (all 512 -> 512 at MHC_BATCH rows)
    layers = HEADS["512x3"]["depth"] - 1
    k7_ms = layers * sum(v["graph_ms"] for v in k7.values())
    k7_first = layers * sum(v["earlier_graph_ms"] for v in k7.values())
    print(f"512x3 step: K7 on its Hopper path ({layers} layers x forward, "
          f"input and weight gradients, each in a graph at {K7_TIMED[0]}, "
          f"phase 8d's A/B) {k7_ms:.4f} ms, "
          f"{100 * k7_ms / step['512x3']['captured']:.1f}% of the captured "
          f"step (its first design {k7_first:.4f} ms in the same A/B)")
    # the captured step with the step's jobs in K5 against the same step
    # with K9 at its head (commit b19e873's arrangement), A B B A
    from vcf2prot_tpu_torch.utils import kernel_ab

    bad, ab = kernel_ab.ab_k9()
    check(bad == 0, "the captured step with K5's jobs differs from the "
                    "step with K9 at its head")
    for name, times in ab.items():
        print(f"{name} captured step, A B B A in one call on {card}: "
              f"median {statistics.median(times['k5']):.4f} ms with the "
              f"step's jobs in K5, {statistics.median(times['k9']):.4f} ms "
              f"with K9 at its head")
    from vcf2prot_tpu_torch.downstream.scoring import (
        window_layer1,
        window_layer1_batch,
    )

    win, labels, _truth, n_tr = mhc.split_task(MHC_N)
    own = port_kernels()
    counted = (window_layer1, window_layer1_batch)
    for name in CAPTURE_HEADS:
        shape = TRAIN_HEADS[name]
        per, k3 = {}, {}
        for mode in ("captured", "eager"):
            before = launch_counts(kernels=counted)
            per[mode] = _fit_profile(win, labels, n_tr, shape,
                                     mode == "captured")
            k3[mode] = launch_counts(before, counted)
        print(f"{name} epoch loop on {card} (torch.profiler, 2 epochs, a "
              f"step: host calls that put work on a stream / device kernels "
              f"and copies / device busy ms): " + "; ".join(
                  f"{mode} {v['calls']:.2f} / {v['kernels']:.2f} / "
                  f"{v['busy']:.4f} (" + ", ".join(
                      f"{c} {n:.2f}" for c, n in v["by_call"].items()) + ")"
                  for mode, v in per.items())
              + "; K7 kernels the profiler saw: " + "; ".join(
                  f"{mode} {sorted(v['k7']) or 'none'}"
                  for mode, v in per.items()))
        # what the card ran: the 512x3 head's layers on the Hopper path
        # alone, the 1-deep head with no layer for K7
        want = {"hopper"} if TRAIN_HEADS[name]["depth"] > 1 else set()
        for mode, v in per.items():
            check(v["k7"] == want, f"{name} {mode} epoch loop: the profiler "
                  f"saw K7's {sorted(v['k7'])} kernels, not {sorted(want)}")
        # the step's bookkeeping: K9 and K5's tail, and none of the torch
        # kernels they replaced; every kernel a step runs is the port's
        # own (the epoch's permutation and gathers, once an epoch, show
        # below one a step)
        got = per["captured"]["kernels"]
        print(f"{name} captured step on {card}: {got:.2f} device kernels "
              f"and copies a step, against {PARENT_STEP_KERNELS[name]:.2f} "
              f"with K9 in the step (commit b19e873, PERF.md section 5), by "
              f"name: " + "; ".join(f"{n:.2f} {key[:100]}" for key, n in
                                    sorted(per["captured"]["names"].items(),
                                           key=lambda kv: -kv[1]))
              + "; K3 on its batch plan a step (launches of the fit, "
              "captured / eager): " + " / ".join(
                  f"{k3[mode][window_layer1_batch] / v['steps']:.2f} "
                  f"({k3[mode][window_layer1_batch]} of "
                  f"{k3[mode][window_layer1]})" for mode, v in per.items()))
        # every K3 launch of a fit on the batch plan: one a step, and a
        # captured fit's warm-up steps
        for mode, v in per.items():
            want = v["steps"] + (train.CAPTURE_WARMUP
                                 if mode == "captured" else 0)
            check(k3[mode][window_layer1_batch] == k3[mode][window_layer1]
                  == want, f"{name} {mode} fit: K3 launched "
                  f"{k3[mode][window_layer1]} times, "
                  f"{k3[mode][window_layer1_batch]} on the batch plan, not "
                  f"{want} ({v['steps']} steps)")
        check(got < PARENT_STEP_KERNELS[name], f"{name}: {got:.2f} device "
              f"kernels a captured step, not fewer than "
              f"{PARENT_STEP_KERNELS[name]:.2f} with K9 in the step")
        # K9 once an epoch (the fills), K5 with the step's jobs once a step
        for mode, v in per.items():
            by_name = {key: n * v["steps"] for key, n in v["names"].items()}
            k9 = sum(n for key, n in by_name.items()
                     if "step_prologue_kernel" in key)
            k5 = sum(n for key, n in by_name.items()
                     if K5_WITH_JOBS.search(key))
            check(round(k9) == v["epochs"] and round(k5) == v["steps"],
                  f"{name} {mode} epoch loop: K9 ran {k9:.0f} times and K5 "
                  f"with the step's jobs {k5:.0f} in {v['epochs']} epochs of "
                  f"{v['steps'] // v['epochs']} steps")
        stepwise = {key: n for key, n in per["captured"]["names"].items()
                    if n >= 0.5}
        replaced = [key for key in stepwise if REPLACED_BY_K9.search(key)]
        check(not replaced, f"{name} captured step: the torch kernels K9 "
              f"and K5's tail replaced still run: {replaced}")
        foreign = [key for key in stepwise if not own.search(key)]
        check(not foreign, f"{name} captured step: kernels a step that are "
              f"not the port's own: {foreign}")
        for mode, v in per.items():
            products = [key for key in v["names"]
                        if LIBRARY_PRODUCT.search(key)]
            check(not products, f"{name} {mode} step: library products "
                  f"{products}")
        ops = per["eager"]["ops"]
        accumulated = per["eager"]["accumulated"]
        casts = ops.get("aten::_to_copy", 0.0)
        print(f"{name} eager step on {card}, host-side torch ops a step: "
              + ", ".join(f"{key} {n:.2f}" for key, n in sorted(
                  ops.items(), key=lambda kv: -kv[1])))
        check(not ops.get("aten::bmm") and not ops.get("aten::einsum"),
              f"{name} eager step: the fold's einsum or bmm ran")
        check(accumulated == 0, f"{name} eager step: {accumulated:.2f} "
              f"torch ops a step inside AccumulateGrads (every gradient "
              f"goes to a sink)")
        # no cast: K9 writes the hidden weights' bf16 casts
        check(casts == 0, f"{name} eager step: {casts:.2f} casts a step")
        kw = dict(epochs=MHC_EPOCHS, batch_size=MHC_BATCH, seed=0,
                  device=DEV, params=init_params(NEO_K, seed=0, **shape))
        walls, fits = {"captured": [], "eager": []}, {}
        for mode in ("captured", "eager", "eager", "captured"):
            t0 = time.perf_counter()
            fits[mode] = train.fit(win[:n_tr], labels[:n_tr],
                                   capture=mode == "captured", **kw)
            walls[mode].append(time.perf_counter() - t0)
        for key in fits["captured"]:
            check(np.array_equal(fits["captured"][key], fits["eager"][key]),
                  f"{name}: the captured fit differs from the eager one in "
                  f"{key} (max |d| "
                  f"{np.abs(fits['captured'][key] - fits['eager'][key]).max()})")
        print(f"{name} fit walls on {card} ({MHC_EPOCHS} epochs of "
              f"{-(-n_tr // MHC_BATCH)} steps, host clock, A B B A): "
              f"captured {', '.join(f'{w:.3f}' for w in walls['captured'])} "
              f"s, eager {', '.join(f'{w:.3f}' for w in walls['eager'])} s; "
              f"weights bit-equal")


def phase_serve_trained(card, workdir, vcf, fa, params):
    """The trained 512x3 head through the serving chain, and the training
    forward against the serving head on the card."""
    import torch

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        TrainableHead,
        fold_table,
        score_windows,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    npz = os.path.join(workdir, "trained_512x3.npz")
    train.save_params(npz, params)
    phase_wide(workdir, vcf, fa, npz, "trained 512x3")
    win, _labels, _truth, n_tr = mhc.split_task(MHC_N)
    trainable = TrainableHead.from_params(params).to(DEV)
    serving = ScoringHead.from_params(params).to(DEV)
    with torch.no_grad():
        got = trainable(torch.from_numpy(win[n_tr:]).to(DEV))
        table = fold_table(trainable.embed, trainable.w1)
    want = score_windows(win[n_tr:], serving)
    d = float((got - want).abs().max())
    differ = int((table != serving.table).sum())
    print(f"trained 512x3 on {card}: training forward against ScoringHead "
          f"(fold on the CPU) max |d| {d} over {want.numel()} windows "
          f"(max |score| {float(want.abs().max())}); K8's folded table on "
          f"the card differs from the CPU's plain fold in {differ} of "
          f"{table.numel()} entries")
    check(differ == 0 and torch.equal(table, serving.table),
          "K8's fold on the card is not bit-equal to the CPU's")
    tol = TRAINED_TOL * max(1.0, float(want.abs().max()))
    check(d <= tol, f"training and serving forwards differ by {d} > {tol}")


def phase_train_checks(card):
    """A fit at a million peptides, reproducibility on the card, and 4
    steps on the card against the same 4 on the CPU."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        score_windows,
    )
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    win, labels, _truth, n_tr = mhc.split_task(BIG_N)
    t0 = time.perf_counter()
    big = train.fit(win[:n_tr], labels[:n_tr], epochs=BIG_EPOCHS,
                    batch_size=MHC_BATCH, seed=0,
                    params=init_params(NEO_K, seed=0, **HEADS["512x3"]),
                    device=DEV)
    wall = time.perf_counter() - t0
    scores = score_windows(win[n_tr:], ScoringHead.from_params(big).to(DEV))
    big_auc = train.auc(scores.cpu().numpy(), labels[n_tr:])
    print(f"train 512x3 on {card}: {n_tr} 9-mers x {BIG_EPOCHS} epochs in "
          f"{wall:.3f} s ({n_tr * BIG_EPOCHS / wall:.0f} windows/s, host "
          f"clock, upload included); holdout AUC {big_auc:.4f}")
    check(big_auc > 0.85, f"the 1 M fit's holdout AUC is {big_auc}")

    win, labels, _truth, n_tr = mhc.split_task(MHC_N)
    a, b = (train.fit(win[:n_tr], labels[:n_tr], epochs=2,
                      batch_size=MHC_BATCH, seed=0, device=DEV)
            for _ in range(2))
    for key in a:
        check(np.array_equal(a[key], b[key]),
              f"two 128x1 fits with one seed differ in {key}")
    print(f"reproducible on {card}: two 128x1 fits (2 epochs, seed 0) "
          f"bit-equal")

    # one order of the rows for both devices: the card's generator and
    # the CPU's give different permutations
    n = 4 * MHC_BATCH
    order = np.random.default_rng(1).permutation(n)
    real = train._epoch_orders
    train._epoch_orders = lambda seed, padded, epochs, device: iter(
        [torch.from_numpy(order).to(device)] * epochs)
    try:
        for name in HEADS:
            params = init_params(NEO_K, seed=1, **HEADS[name])
            card_p, cpu_p = (
                train.fit(win[:n], labels[:n], epochs=1, batch_size=MHC_BATCH,
                          seed=1, params=params, device=dev)
                for dev in (DEV, "cpu"))
            d = max(float(np.abs(card_p[k] - cpu_p[k]).max())
                    for k in card_p)
            print(f"4 steps of {name} on {card} against the CPU (plain "
                  f"K3/K4): params max |d| {d}")
            check(d <= 5e-3, f"{name}: card and CPU params differ by {d}")
    finally:
        train._epoch_orders = real


@contextlib.contextmanager
def repeated_card_mesh():
    """``parallel.mesh.make_mesh`` replaced by the one card named
    MESH_SHARDS times, so that the pipeline takes its multi-device
    branches on it (the CPU tests replace it the same way)."""
    import torch

    from vcf2prot_tpu_torch.parallel import mesh as mesh_mod

    mesh = (torch.device("cuda", 0),) * MESH_SHARDS
    real = mesh_mod.make_mesh
    mesh_mod.make_mesh = lambda n_devices=0: mesh
    try:
        yield mesh
    finally:
        mesh_mod.make_mesh = real


def shard_launches(flat, budget, pairs):
    """``(chunks, shards)`` of a sharded run over MESH_SHARDS devices in
    pair-aligned chunks of ``budget`` result bytes: K1 launches once per
    shard that holds any residue. ``pairs``: shards of samples (the chain),
    else of programs (the FASTA executor)."""
    from vcf2prot_tpu_torch.parallel.sharded import partition_programs
    from vcf2prot_tpu_torch.parallel.sharded_neoantigen import partition_pairs
    from vcf2prot_tpu_torch.pipeline import _chunk_indices

    chunks = _chunk_indices(flat, budget, pair_aligned=True)
    n = 0
    for chunk in chunks:
        progs = [flat[i] for i in chunk]
        if pairs:
            shards = [[q for i in s for q in (progs[2 * i], progs[2 * i + 1])]
                      for s in partition_pairs(progs, MESH_SHARDS)]
        else:
            shards = [[progs[i] for i in s]
                      for s in partition_programs(progs, MESH_SHARDS)]
        n += sum(any(p.res_len for p in s) for s in shards)
    return len(chunks), n


def phase_sharded_fasta(card, workdir, vcf, fa, n_chunks, shards, single_s):
    """12: -g gpu -s over the repeated-card mesh against -g mt."""
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    out = os.path.join(workdir, "gpu_mesh")
    segmented_copy.launches = 0
    with repeated_card_mesh():
        wall = _run_cli(vcf, fa, out, "gpu", "-s", "-v")
    k1 = segmented_copy.launches
    n = _same_outputs(out, os.path.join(workdir, "mt"), "sharded FASTA path")
    check(k1 == shards >= MESH_SHARDS * n_chunks,
          f"K1 launched {k1} times for {shards} non-empty shards in "
          f"{n_chunks} chunks")
    print(f"sharded FASTA path on {card} ({SCALING_NOTE}): {n} files "
          f"byte-identical to -g mt; -g gpu over {MESH_SHARDS} shards "
          f"{wall:.3f} s wall against {single_s:.3f} s on one device; K1 "
          f"launches {k1} for {n_chunks} chunks of <= "
          f"{CHUNK_BYTES * MESH_SHARDS} bytes")
    shutil.rmtree(out)
    return {"segmented_copy": k1}


def phase_sharded_debug(workdir, vcf, fa):
    """13: DEBUG_GPU=1 -a -c -w over the repeated-card mesh against -g mt
    (phase 5's output): K2 on every non-empty shard of every chunk."""
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    _blob, flat = compile_main(vcf, fa)
    n_chunks, shards = shard_launches(flat, CHUNK_BYTES * MESH_SHARDS,
                                      pairs=False)
    out = os.path.join(workdir, "dbg_gpu_mesh")
    validate_on_device.launches = segmented_copy.launches = 0
    os.environ["DEBUG_GPU"] = "1"
    try:
        with repeated_card_mesh():
            wall = _run_cli(vcf, fa, out, "gpu", "-a", "-c", "-w")
    finally:
        del os.environ["DEBUG_GPU"]
    launches = {"validate_on_device": validate_on_device.launches,
                "segmented_copy": segmented_copy.launches}
    n = _same_outputs(out, os.path.join(workdir, "dbg_mt"),
                      "sharded DEBUG_GPU -a -c -w")
    check(launches["validate_on_device"] == launches["segmented_copy"]
          == shards >= n_chunks,
          f"launches {launches} for {shards} non-empty shards in "
          f"{n_chunks} chunk(s)")
    print(f"sharded debug path ({SCALING_NOTE}): {n} gzip files identical "
          f"after decompression; -g gpu {wall:.3f} s; launches {launches} "
          f"for {shards} non-empty shards in {n_chunks} chunk(s)")
    shutil.rmtree(out)
    return launches


def phase_sharded_neo(card, workdir, vcf, fa, n_chunks, shards, single_s):
    """14: --neoantigen_only over the repeated-card mesh against phase 6's
    single-device chain."""
    from vcf2prot_tpu_torch.downstream.compare import reports_disagree
    from vcf2prot_tpu_torch.downstream.scoring import window_layer1
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    out = os.path.join(workdir, "neo_mesh")
    chain = os.path.join(workdir, "neo_chain")
    kernels = (segmented_copy, window_layer1)
    start, waited = launch_counts(kernels=kernels), candidates_s()
    with repeated_card_mesh():
        wall = _run_cli(vcf, fa, out, "gpu", "--neoantigen_only", "-v",
                        "--neoantigen_k", str(NEO_K), "--neoantigen_top",
                        str(NEO_TOP))
    launches = {f.__name__: n
                for f, n in launch_counts(start, kernels).items()}
    check(launches["segmented_copy"] == shards > n_chunks,
          f"K1 launched {launches['segmented_copy']} times for {shards} "
          f"non-empty shards in {n_chunks} chunks")
    check(launches["window_layer1"] >= shards,
          f"K3 launched {launches['window_layer1']} times for {shards} "
          f"shards")
    msg = reports_disagree(out, chain, atol=1e-6, rtol=1e-5)
    check(msg is None, f"sharded chain against the single-device chain: "
                       f"{msg}")
    print(f"sharded neoantigen chain on {card} ({SCALING_NOTE}): "
          f"{len(os.listdir(out))} TSVs equal to the single-device chain "
          f"(rtol 1e-5 + atol 1e-6); --neoantigen_only over {MESH_SHARDS} "
          f"shards {wall:.3f} s wall ({candidates_s() - waited:.3f} s of "
          f"it waiting on candidate counts) against {single_s:.3f} s on one "
          f"device; launches {launches} for {shards} shards in {n_chunks} "
          f"chunks")
    shutil.rmtree(out)
    return launches


def dp_gaps(name, seeds, fault=False):
    """The largest gap between the weights of a 1-epoch dp fit over the
    repeated-card mesh and those of the single-device fit of the same seed
    on the card, for the ``name`` head of the MHC task and each seed. With
    ``fault``, the dp fit drops the second shard's gradient (its mask set
    to 0, the global count kept): a planted fault that the limit must
    see."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    mesh = (torch.device("cuda", 0),) * MESH_SHARDS
    win, labels, _truth, n_tr = mhc.split_task(MHC_N)
    real = train.train_step

    def dropped(replicas, opt, shards, *args, **kw):
        w, y, m, count = shards[1]
        return real(replicas, opt, [shards[0], (w, y, m * 0, count),
                                    *shards[2:]], *args, **kw)

    gaps = []
    for seed in seeds:
        kw = dict(epochs=1, batch_size=MHC_BATCH, seed=seed, params=init_params(
            NEO_K, seed=seed, **TRAIN_HEADS[name]))
        one = train.fit(win[:n_tr], labels[:n_tr], device=DEV, **kw)
        train.train_step = dropped if fault else real
        try:
            dp = train.fit(win[:n_tr], labels[:n_tr], mesh=mesh, **kw)
        finally:
            train.train_step = real
        gaps.append(max(float(np.abs(dp[k] - one[k]).max()) for k in dp))
    return gaps


def phase_dp_train(card):
    """15: the data-parallel fit over the repeated-card mesh (the fit's
    step function and epoch loop, eager); returns the path's K3, K4, K5, K6,
    K8 and K9 launches."""
    import numpy as np
    import torch

    from vcf2prot_tpu_torch.downstream.adam import adam_update
    from vcf2prot_tpu_torch.downstream.fold import fold_backward, fold_forward
    from vcf2prot_tpu_torch.downstream.head_tail import (
        head_tail_backward,
        head_tail_forward,
    )
    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.downstream.synth_mhc import oracle_auc
    from vcf2prot_tpu_torch.downstream import train
    from vcf2prot_tpu_torch.downstream.scoring import (
        ScoringHead,
        score_windows,
        window_layer1,
        window_layer1_backward,
    )
    from vcf2prot_tpu_torch.downstream.step import step_prologue
    from vcf2prot_tpu_torch.tools import train_synth_mhc as mhc

    mesh = (torch.device("cuda", 0),) * MESH_SHARDS
    win, labels, truth, n_tr = mhc.split_task(MHC_N)
    ceiling = oracle_auc(truth[n_tr:], labels[n_tr:])
    artifact = mhc.read_aucs(MHC_ARTIFACT)
    steps = MHC_EPOCHS * -(-n_tr // MHC_BATCH)
    start = launch_counts()
    for name in DP_HEADS:
        t0 = time.perf_counter()
        params = train.fit(
            win[:n_tr], labels[:n_tr], epochs=MHC_EPOCHS,
            batch_size=MHC_BATCH, seed=0,
            params=init_params(NEO_K, seed=0, **TRAIN_HEADS[name]),
            mesh=mesh)
        wall = time.perf_counter() - t0
        head = ScoringHead.from_params(params).to(DEV)
        auc = train.auc(score_windows(win[n_tr:], head).cpu().numpy(),
                        labels[n_tr:])
        print(f"dp train {name} on {card} ({SCALING_NOTE}): holdout AUC "
              f"{auc:.4f} (artifact {artifact[name]:.4f}, ceiling "
              f"{ceiling:.4f}); fit wall {wall:.3f} s for {steps} steps of "
              f"{MHC_BATCH} over {MESH_SHARDS} replicas "
              f"({wall / steps * 1e3:.3f} ms a step, host clock)")
        check(artifact[name] - 0.01 <= auc <= ceiling + 0.02,
              f"dp {name} holdout AUC {auc:.4f} outside "
              f"[{artifact[name] - 0.01:.4f}, {ceiling + 0.02:.4f}]")
    ran = launch_counts(start)
    launches = {f.__name__: ran[f] for f in (
        window_layer1, window_layer1_backward, adam_update,
        head_tail_forward, head_tail_backward, fold_forward, fold_backward,
        step_prologue)}
    check(all(launches.values()), f"a kernel of the dp fit never ran: "
                                  f"{launches}")
    # K9 on every replica a step, K5 on the first
    check(launches["step_prologue"] == MESH_SHARDS * launches["adam_update"]
          == MESH_SHARDS * len(DP_HEADS) * steps,
          f"dp fit launches {launches}: K9 not once a replica and step")
    for name in DP_HEADS:
        gaps = dp_gaps(name, DP_SEEDS)
        faults = dp_gaps(name, DP_SEEDS, fault=True)
        for seed, gap, bad in zip(DP_SEEDS, gaps, faults):
            check(gap <= DP_TOL[name], f"dp {name}, seed {seed}: 1 epoch "
                  f"differs from one device by {gap} > {DP_TOL[name]}")
            check(bad > DP_TOL[name], f"dp {name}, seed {seed}: with one "
                  f"shard's gradient dropped, 1 epoch differs from one device "
                  f"by {bad}, not above {DP_TOL[name]}: the check cannot see "
                  f"that fault")
        kw = dict(batch_size=MHC_BATCH, seed=0,
                  params=init_params(NEO_K, seed=0, **TRAIN_HEADS[name]))
        a, b = (train.fit(win[:n_tr], labels[:n_tr], epochs=2, mesh=mesh,
                          **kw) for _ in range(2))
        for key in a:
            check(np.array_equal(a[key], b[key]),
                  f"two dp {name} fits with one seed differ in {key}")
        step = _step_ms(kw["params"])
        dp_step = _step_ms(kw["params"], mesh)
        print(f"dp {name} on {card}: weights after 1 epoch within "
              f"{', '.join(map(str, gaps))} of the single-device fit (seeds "
              f"{DP_SEEDS}; limit {DP_TOL[name]}), and "
              f"{', '.join(map(str, faults))} with one shard's gradient "
              f"dropped (a planted fault); two dp fits (2 epochs) bit-equal; "
              f"median step of {MHC_BATCH} rows {dp_step:.4f} ms over "
              f"{MESH_SHARDS} replicas (eager) against {step:.4f} ms on one "
              f"(captured; CUDA events)")
    return launches


def _fastas(d):
    return {f: _read(os.path.join(d, f)) for f in os.listdir(d)
            if f.endswith(".fasta")}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multihost(card, workdir, vcf, fa):
    """16: two processes in one gloo group, each on its sample block of the
    main cohort on the card; their union against -g mt's FASTAs (phase
    4's output). Returns the children's K1 launches."""
    out = os.path.join(workdir, "multihost")
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-child",
         str(rank), str(port), vcf, fa, out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for rank in (0, 1)]
    try:
        children = []
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=MULTIHOST_TIMEOUT)
            check(proc.returncode == 0, f"multi-host child {rank} exited "
                                        f"{proc.returncode}: {stderr[-2000:]}")
            children.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    shards = [os.path.join(out, f"shard_{r}") for r in (0, 1)]
    check(sorted(os.listdir(out)) == ["shard_0", "shard_1"],
          f"multi-host output holds {sorted(os.listdir(out))}")
    union = {}
    for d in shards:
        check(all(f.endswith(".fasta") for f in os.listdir(d)),
              f"{d} holds more than FASTAs")
        got = _fastas(d)
        check(not set(got) & set(union), "a sample written by two hosts")
        union.update(got)
    check(union == _fastas(os.path.join(workdir, "mt")),
          "the union of the hosts' FASTAs differs from -g mt")
    for child in children:
        check(child["segmented_copy"] > 0,
              f"K1 never ran in multi-host child {child['rank']}")
    print(f"multi-host on {card} (2 processes, gloo on localhost, both on "
          f"the one card): {len(union)} FASTAs, union byte-identical to "
          f"-g mt; children {children}; {wall:.3f} s wall for both")
    shutil.rmtree(out)
    return {"segmented_copy": sum(c["segmented_copy"] for c in children)}


def multihost_child(rank, port, vcf, fa, out):
    """One host of phase 16: joins the group, runs its block on the card,
    prints its K1 launches as the last line."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    os.environ["RUN_SELECTED_TEST"] = "1"
    import torch.distributed as dist

    from vcf2prot_tpu_torch.parallel.multihost import (
        initialize_distributed,
        run_multihost_pipeline,
    )
    from vcf2prot_tpu_torch.pipeline import PipelineConfig
    from vcf2prot_tpu_torch.runtime.engine import Engine
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy

    initialize_distributed(f"localhost:{port}", num_processes=2,
                           process_id=int(rank))
    segmented_copy.launches = 0
    t0 = time.perf_counter()
    res = run_multihost_pipeline(PipelineConfig(
        vcf_path=vcf, fasta_path=fa, outdir=out, engine=Engine.GPU))
    print(json.dumps({
        "rank": dist.get_rank(), "samples": res.n_samples,
        "segmented_copy": segmented_copy.launches,
        "wall_s": round(time.perf_counter() - t0, 3),
    }))
    dist.destroy_process_group()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    # before anything is printed: outside a checkout this import fails
    import vcf2prot_tpu_torch  # noqa: F401

    # the synthetic cohorts trip the default QC's deletion-range overlap
    # check; select no QC test (DEBUG_GPU stays honoured, unlike NO_TEST)
    os.environ["RUN_SELECTED_TEST"] = "1"
    card = phase_device()
    phase_build()
    import numpy as np

    from vcf2prot_tpu_torch.downstream.scoring import init_params
    from vcf2prot_tpu_torch.runtime.gpu_engine import segmented_copy
    from vcf2prot_tpu_torch.runtime.kernels import validate_on_device

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # random_cohort's VCF grows with samples^2 (a record per
        # sample-haplotype bundle, a column per sample: ~18 GB here);
        # shared_cohort draws from per-transcript bundle pools, as real
        # cohorts share variants, and stays ~60 MB
        big = write_cohort(workdir, "shared_cohort", MAIN_SAMPLES,
                           MAIN_TRANSCRIPTS, MAIN_SEED)
        blob, flat = compile_main(*big)
        n_chunks, measured = phase_kernels(card, blob, flat)
        n_neo_chunks, k3 = phase_k3(card, blob, flat)
        measured["window_layer1"] = k3["128x1"]
        k4 = phase_k4(card)
        measured["window_layer1_backward"] = k4[("128x1", K4_ROWS[0])]
        measured["adam_update"] = phase_k5(card)["128x1"]
        k6 = phase_k6(card)
        measured["head_tail_forward"] = k6["forward"]
        measured["head_tail_backward"] = k6["backward"]
        k7 = phase_k7(card)
        measured.update(k7)
        k8 = phase_k8(card)
        measured["fold_forward"] = k8["128x1"]["forward"]
        measured["fold_backward"] = k8["128x1"]["backward"]
        k9, k5_jobs = phase_k9(card)
        measured["step_prologue"] = dict(k9["128x1"], **{
            "wide_" + key: k9["512x3"][key] for key in (
                "ms", "graph_ms", "bound_ms", "plain_ms", "wrapper_ms",
                "replaced_graph_ms")})
        # K5 with the step's jobs and with its tail alone, in a graph
        measured["adam_update"].update(
            k5_jobs["128x1"],
            **{"wide_" + key: v for key, v in k5_jobs["512x3"].items()})
        fasta_shards = shard_launches(flat, CHUNK_BYTES * MESH_SHARDS,
                                      pairs=False)
        neo_shards = shard_launches(flat, NEO_CHUNK_BYTES, pairs=True)
        del blob, flat
        # each path: its launch counters from zero, read just after
        segmented_copy.launches = 0
        single_s = phase_main(card, workdir, *big, n_chunks)
        paths = {"main": {"segmented_copy": segmented_copy.launches}}
        paths["default engine FASTA"] = phase_default_fasta(
            card, workdir, *big, n_chunks)
        paths["batch twin"] = phase_batch(card, workdir, *big, n_chunks)
        paths["sharded FASTA"] = phase_sharded_fasta(
            card, workdir, *big, *fasta_shards, single_s)
        paths["multi-host"] = phase_multihost(card, workdir, *big)
        shutil.rmtree(os.path.join(workdir, "gpu"))
        shutil.rmtree(os.path.join(workdir, "mt"))
        paths["neoantigen chain"], chain_s = phase_neo(
            card, workdir, *big, n_neo_chunks)
        paths["default engine chain"] = phase_default_neo(
            card, workdir, *big, n_neo_chunks)
        paths["sharded chain"] = phase_sharded_neo(
            card, workdir, *big, *neo_shards, chain_s)
        shutil.rmtree(os.path.join(workdir, "neo_chain"))
        small = write_cohort(workdir, "random_cohort", DEBUG_SAMPLES,
                             DEBUG_TRANSCRIPTS, DEBUG_SEED)
        validate_on_device.launches = segmented_copy.launches = 0
        phase_debug(workdir, *small)
        paths["debug"] = {"validate_on_device": validate_on_device.launches,
                          "segmented_copy": segmented_copy.launches}
        paths["sharded debug"] = phase_sharded_debug(workdir, *small)
        npz = os.path.join(workdir, "head_512x3.npz")
        np.savez(npz, **init_params(NEO_K, seed=5, **HEADS["512x3"]))
        # the serving path of a deeper head: K7 once a block and layer
        with dense_counts() as counts:
            phase_wide(workdir, *small, npz, "random 512x3", HOST_ORACLE_TOL)
        paths["wide head"] = counts
        # the training path: K3 forward, K4 backward, K5, K6, K7, a
        # captured step
        trained, paths["training"] = phase_train(card)
        check(all(paths["training"].values()),
              f"a kernel of the training path never ran: {paths['training']}")
        phase_step_times(card, k4, k6, k7, k8)
        with dense_counts() as counts:
            phase_serve_trained(card, workdir, *small, trained["512x3"])
        paths["trained head served"] = counts
        phase_train_checks(card)
        with dense_counts() as counts:
            paths["dp training"] = phase_dp_train(card)
        paths["dp training"].update(counts)
    meta = {
        "segmented_copy": ("vcf2prot_tpu_torch/csrc/executor.cu",
                           "vcf2prot_tpu/runtime/tpu_engine.py:119"),
        "validate_on_device": ("vcf2prot_tpu_torch/csrc/validator.cu",
                               "vcf2prot_tpu/runtime/kernels.py:38"),
        "window_layer1": ("vcf2prot_tpu_torch/csrc/scorer.cu",
                          "vcf2prot_tpu/downstream/scoring.py:147"),
        "window_layer1_backward": ("vcf2prot_tpu_torch/csrc/scorer_grad.cu",
                                   "vcf2prot_tpu/downstream/train.py:157"),
        "adam_update": ("vcf2prot_tpu_torch/csrc/adam.cu",
                        "vcf2prot_tpu/downstream/train.py:164"),
        "head_tail_forward": ("vcf2prot_tpu_torch/csrc/head_tail.cu",
                              "vcf2prot_tpu/downstream/train.py:109"),
        "head_tail_backward": ("vcf2prot_tpu_torch/csrc/head_tail.cu",
                               "vcf2prot_tpu/downstream/train.py:157"),
        "dense_forward": ("vcf2prot_tpu_torch/csrc/dense.cu",
                          "vcf2prot_tpu/downstream/scoring.py:152"),
        "dense_backward_input": ("vcf2prot_tpu_torch/csrc/dense.cu",
                                 "vcf2prot_tpu/downstream/train.py:157"),
        "dense_backward_weight": ("vcf2prot_tpu_torch/csrc/dense.cu",
                                  "vcf2prot_tpu/downstream/train.py:157"),
        "fold_forward": ("vcf2prot_tpu_torch/csrc/fold.cu",
                         "vcf2prot_tpu/downstream/scoring.py:144"),
        "fold_backward": ("vcf2prot_tpu_torch/csrc/fold.cu",
                          "vcf2prot_tpu/downstream/train.py:157"),
        "step_prologue": ("vcf2prot_tpu_torch/csrc/step.cu",
                          "vcf2prot_tpu/downstream/train.py:167"),
    }
    launches = dict.fromkeys(meta, 0)
    for counts in paths.values():
        for name, n in counts.items():
            launches[name] += n
    print(f"launches by path: {json.dumps(paths)}")
    check(all(launches.values()), f"a kernel of the paths never ran: "
          f"{launches}")
    check("jax" not in sys.modules, "jax was imported")
    print("jax imported: False")
    check("vcf2prot_tpu" not in sys.modules,
          "the JAX package vcf2prot_tpu was imported")
    print("vcf2prot_tpu imported: False")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "wrapper_ms", "graph_ms", "library_graph_ms",
            "earlier_ms", "earlier_graph_ms", "replaced_ms",
            "replaced_graph_ms", "pair_graph_ms", "wide_ms", "wide_graph_ms",
            "wide_earlier_ms", "wide_earlier_graph_ms", "wide_bound_ms",
            "wide_plain_ms", "wide_wrapper_ms", "wide_replaced_ms",
            "wide_replaced_graph_ms", "wide_pair_graph_ms", "block_ms",
            "block_graph_ms", "block_plain_ms", "block_bound_ms",
            "block_library_ms", "block_earlier_ms", "block_earlier_graph_ms",
            "floor_ms", "jobs_graph_ms", "jobs_bound_ms", "tail_graph_ms",
            "wide_jobs_graph_ms", "wide_jobs_bound_ms",
            "wide_tail_graph_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{key: measured[name].get(key) for key in keys},
         "one_call_ms": measured[name]["library_ms"]}
        for name, (src, rep) in meta.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        multihost_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--cold-child"]:
        cold_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--startup-child"]:
        startup_child()
    elif sys.argv[1:2] == ["--main-cohort"]:
        # the main cohort's VCF and FASTA into a directory, for
        # vcf2prot_tpu_torch.utils.kernel_ab
        os.makedirs(sys.argv[2], exist_ok=True)
        print(*write_cohort(sys.argv[2], "shared_cohort", MAIN_SAMPLES,
                            MAIN_TRANSCRIPTS, MAIN_SEED))
    else:
        main()
