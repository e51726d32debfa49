#!/usr/bin/env python3
"""Drive the PyTorch port (``simplex_tpu_torch``) once on one NVIDIA H100.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the build of the CUDA kernels from ``csrc`` (timed);
2. the example goldens through ``solve(..., device="cuda")`` with the
   default options (f64 tableau, the sequential reference loop), then
   with the production options;
3. the f64 reference path (the default options: the sequential loop as
   one CUDA graph a chunk of 32 pivots): random_1024_1024 three ways in
   turns -- graphed, ``graph=False`` and the old eager
   ``iteration_body`` -- each loop call ending with the graph run's state
   bit for bit, then random_8192_8192 twice graphed (the sequential
   kernels' counters set to 0 just before the first and read just
   after), objectives within 1e-9 of the certified goldens, the walks
   the recorded 1,871 + 64 and 21,697 + 1,123, each run's loop ms/pivot,
   capture ms and nodes a pivot (2 + 1/32 by the captured launch counts)
   printed beside the JAX package's TPU record and the reference CUDA
   program's;
4. K6's path: random_2048_2048 through ``solve(dtype="float32",
   vector_dtype="float32", use_pallas=True)`` -- K6's and the
   sequential kernels' launch counters reset just before and read just
   after -- graphed, then with ``graph=False`` (the recorded walk 4,594 +
   342 both times, every loop call's state bit for bit, 2 + 1/32 kernels
   a pivot), then the 10,000 x 100,000 phase-1 tableau for 256 pivots
   through ``solve_loop_pallas`` graphed and with ``graph=False`` (the
   same state bit for bit);
5. the plain blocked loop (``dtype=float64, block_pivots=128``, the full
   f64 re-solve's loop, one CUDA graph a window): random_2048_2048 three
   ways in turns -- graphed (the ``kernels.eta`` launch counters set to 0
   just before and read just after), ``graph=False`` (every loop call's
   final state the graph run's bit for bit) and the old body
   (``solve_loop_blocked_reference``) -- each within 1e-9 of the golden,
   walking the recorded 4,379 + 258, no K1-K4 launch, graphed and with
   ``graph=False`` the recorded objective bit for bit; random_8192_8192
   graphed within 1e-9, walking the recorded 22,070 + 1,191 to the
   recorded objective bit for bit, beside phase 3's sequential loop; the pure-f32
   tableau with ``use_pallas=False`` (its graph holding the window's
   re-pricing) on random_2048_2048 within 1e-3; each run's ms/pivot,
   capture ms and 2 + 1/L kernels a pivot by the captured launch counts;
6. the CLI (``python -m simplex_tpu_torch.cli``): a problem file, the
   ``-t --limit 1024 --timer`` sweep (the reference's CSV schema; its 9
   CSVs through ``simplex_tpu_torch.sweep_table`` against the
   reference's, every row with the reference's pivots and seconds and
   the pivots the CLI printed), a
   ``--per-iteration`` seed-file solve, ``--equilibrate`` on the problem
   file and ``--batch 4`` with the default dtype (the batched fallback),
   each in the reference's output format;
7. random_1024_1024 -> OPTIMAL, certified, objective 4.000455470573328,
   production options;
8. the flagship random_8192_8192 -> OPTIMAL, certified, objective
   2.701733460335518, walking 9,206 + 409 pivots (the walk recorded on
   the card since the port began) -- the production path, with the K1-K4 launch
   counters reset just before the first solve and read just after it;
   then solved again, for the wall-time spread of warm solves (each
   solve must walk the same pivots); every counter of the path above 0:
   K1-K4, ``step_pre`` and the steps that run as K1's and K2's tails,
   which a CUDA graph's replay counts;
8a. the flagship's kernel loop two ways, in turns (eager, graph, graph,
   eager; ``phase_window_graph``): enqueued eagerly
   (``solve_loop_blocked_kernel(graph=False)``) and as one CUDA graph a
   window, each run walking 9,206 + 409 and each loop call ending with
   the first run's Tt, b, costs, z, base and devex weights bit for bit,
   each captured window holding 2 + 1/L kernels a pivot by its launch
   counts (``CapturedLaunches``: K1 and K2 with their tails a pivot,
   ``step_pre`` once); each run's loop ms/pivot and capture ms;
8b. the checkpointed solves (``phase_resumable``): the flagship through
   ``solve_resumable`` in windows of 2,048 pivots, certified within 1e-9,
   K1-K4 and the step kernels launched (counters reset just before,
   read just after), each write timed; the CLI with ``--checkpoint``
   killed (SIGKILL) as soon as its first file exists, then rerun: it
   resumes to the same walk, objective and ``solution.txt``;
   ``solve_resumable_sharded`` at one NCCL rank on random_2048_2048, K5
   launched and K1 not, walking as ``solve_resumable``, and a MAXITER
   run resumed to the same result;
   random_2048_2048 resumable on K6's path; and
   ``generate_random_problem_device`` at 8192^2 in f64, bit for bit on a
   second call;
9. the 10,000 x 100,000 phase-1 tableau built on the card, run for 256
   pivots (2 windows);
9a. the sharded path (``solve_sharded``) at world size 1 over NCCL, in
   this process: random_1024_1024 with the default options (the
   sequential sharded loop) three ways in turns -- one CUDA graph a chunk
   of 32 pivots with its NCCL collectives inside, ``graph=False`` and the
   old eager ``iteration_body_sharded`` -- each walking as ``solve``
   (1,871 + 64) with every loop call's final state the graph run's bit
   for bit; random_8192_8192 with the default options graphed walking as
   ``solve`` (21,697 + 1,123), the sequential kernels' launch counters
   set to 0 just before it and read just after (``seq_fold_column``,
   ``seq_ratio_colk_sharded`` and ``seq_rank1`` launched); each run's
   loop ms/pivot, capture ms and kernels a pivot (3 by the captured
   launch counts, beside 2 ``all_gather``s and 1 ``all_reduce``) beside
   the card's name and power limit; random_2048_2048 and the flagship with the production
   options -- the flagship certified within 1e-9, walking as ``solve``
   did, with the launch counters reset just before it and read just
   after (K5, K2-K4 and the sharded step kernels, K5's head and K2's
   sharded tails launched, K1 not); its kernel loop replays one CUDA graph
   a window with the per-pivot all_reduce and two all_gathers inside --
   then the flagship's sharded loop eager (``graph=False``) and graphed
   in turns (eager, graph, graph, eager: the walk, every loop call's
   final state bit for bit, ms/pivot, capture ms, the same collectives
   counted, 5 + 2/L nodes a pivot by the captured launch counts), then the
   north-star phase-1 slice for 256 pivots, ending with phase 9's z and
   basis;
9b. the plain blocked sharded loop (``solve_sharded`` with the f64
   tableau at L=128) at world size 1 over NCCL: random_2048_2048 three
   ways in turns -- one CUDA graph a window with its collectives inside
   (the slice kernels' launch counters set to 0 just before and read just
   after), ``graph=False`` and the old body
   (``solve_loop_blocked_sharded_reference``) -- each walking the recorded
   4,379 + 258, every loop call of ``graph=False`` ending in the graph
   run's state bit for bit, graph and ``graph=False`` at the recorded
   objective bit for bit; random_8192_8192 graphed, walking 22,070 +
   1,191 to the recorded objective bit for bit; the f64 north-star
   phase-1 tableau (10,000 x 100,000, 9.7 GB) for 256 pivots through the
   single-card loop and as the rank's slice, z and the basis equal; the
   pure-f32 tableau with the kernels off on random_2048_2048 within 1e-3;
   each run's ms/pivot, capture ms and 3 kernels a pivot by the captured
   launch counts, beside 2 ``all_gather``s and 1 ``all_reduce`` a pivot
   (and the re-pricing's 1 of each a window on the f32 tableau) by the
   captured collective counts;
10. the batched path (``solve_batch(..., device="cuda")``, BASELINE.json
   config 3's options: f32 tableau, f64 vectors, eps 1e-5, L=32, devex):
   the status spread (OPTIMAL 13, UNBOUNDED, INFEASIBLE); config 3 at
   full size, 256 x (m=500, n=2,000) from seeds 1000..1255, every lane
   OPTIMAL and certified, lanes 0, 127 and 255 equal to a batch of that
   lane alone and within 1e-9 of the single-LP ``solve`` -- the batched
   path, with the K7-K10 launch counters reset just before its first
   call and read just after; then a warm call; then 32 x (m=500,
   n=14,000) lanes from seeds 2000..2031 (the TPU's HBM-tier shape);
   each batch's walks printed as one digest (``walk_digest``; the same
   as ``tools/batch_walks.py`` prints for any checkout); between the two,
   config 3's lanes with ``DEFAULT_OPTIONS`` (f64, sequential: the
   batched fallback's lane-batched loop, ``batch_rank1``'s counter set
   to 0 just before and read just after), every lane's status printed
   and equal to the kernel batch's, every objective within 1e-9 of the
   kernel batch's certified one, four lanes solved alone by ``solve``
   walking the same, the steps, ms per step, wall and peak memory; and
   route (b) of the fallback at full width, config 3's 256 lanes with
   ``kernel=False`` at its options and as an f64 blocked batch (L=32),
   each one lane-batched plain blocked loop a phase with no kernel
   launched, every lane certified within 1e-9 of the kernel batch, four
   lanes held to their single-LP ``solve(use_pallas=False)``, the
   windows, steps, ms per window, wall, device and refinement seconds and
   peak memory, then the first 16 lanes of each timed alone;
10c. the f64 tier chain: ``fallback_solve`` warm from the production
   flagship's final (drifted) basis (the host finish, certified within
   1e-9 of the golden, its finishing pivots printed), ``fallback_solve``
   with no basis on random_2048_2048 (the full f64 re-solve on the card,
   certified, the plain blocked loop's kernels launched and K1-K4 not),
   and a production random_2048_2048 whose mixed-tier
   certificates are made to fail (``two_phase.refine_result`` wrapped),
   which reaches ``fallback_solve`` through ``certify`` after two restart
   rounds and ends certified with ``refine.fallback``; then
   ``equilibrate=True`` in production on the flagship and on a 2000 x 500
   instance with rows and columns scaled by 10^[-15, 15], each certified
   within 1e-9 (the latter of its base instance's f64 solve);
10a. two spawned ranks on the one card over gloo: random_2048_2048 in
   production, the walk and certified objective of phase 9a's one rank;
   random_1024_1024 with the default options (the sequential sharded
   loop's kernels on each rank's slice, its collectives eager over gloo)
   walking as ``solve`` to the golden within 1e-9, the loop's kernels
   launched on each rank;
   the fleet of config 3's first 64 lanes, 32 a rank, bit for bit as
   ``solve_batch`` on one device, K7-K10's counters set to 0 on each rank
   just before the fleet's call and read just after (each launched);
10b. where the host shows N > 1 cards: N ranks over NCCL, one card a
   rank -- random_2048_2048 and the flagship in production, twice each,
   certified; random_1024_1024 with the default options walking as
   ``solve``; config 3's 256 lanes as a fleet, checked as in 10a;
10e. the measurement entry points in this process, each with K1-K4's
   and the step kernels' counters set to 0 just before and read just
   after (each launched):
   ``validate_refine_sweep`` on 256x8192, 8192x256 and 4096x4096, every
   row OPTIMAL, certified at 1e-9 and within 1e-9 of
   ``data/measures/refine_sweep_r5.json``'s objective for its seed; and
   ``measure_refine_flagship`` at its default 50,000 x 10,000,
   ``REFINE_FLAGSHIP_OK`` last and its answer certified at 1e-9 (the
   refinement's, or where the drifted basis fails, the warm f64
   finish's);
10d. the benchmark entry points, each a process as a user starts it
   (``phase_bench``): ``python -m simplex_tpu_torch.bench`` at the
   north-star defaults with ``--repeats 5`` (devex, then Dantzig), again
   on K6's path (``--block 0 --vector-dtype float32 --iters 256``) and on
   the f64 plain blocked loop (``--dtype float64 --repeats 3``),
   each printing one JSON line with the key set of ``bench.py``, a
   positive value and a floor below its marginal; ``bench_batch`` at
   config 3 with ``--repeats 1``, ending in ``BENCH_BATCH_OK``; and
   ``bench_sharded`` at one NCCL rank with ``--repeats 2``, its one line
   well formed; each line and the diagnostics printed;
11. each kernel against its plain PyTorch version on the card: K1-K4 at
   the flagship shapes (M=8192, R=24576, L=128, t in {0, 37, 127}; K1
   and K2 one kernel a call, each on one workspace, their wrappers' host
   time; K2 under devex and Dantzig, its pivot row at h K1's p bit for
   bit) with K4's Tt K3's bit for bit and K3's mv K11's on K3's output
   bit for bit (there and at M=256, R=384, L=8), K3 and K4 timed in
   turns with cuBLAS ``addmm_``, the SM clock before and after, K5 (its
   column K1's bit for bit) and K11 (K3's mv with zero etas bit for
   bit), ``step_pre`` and K1 and K2 with the steps as their tails
   against ``step_pre_plain``, K1, ``step_mid_plain``, K2 and
   ``step_post_plain`` under 192 seeded states, bit for bit, K1 and K2
   timed with and without their tails in turns, the sharded step kernels
   (``sharded_ratio`` one thread-block cluster) on K1's column under 192
   seeded states at P = 1, 2 and 4 with a NaN b, a tie across the
   cluster's blocks and no eligible row among them, K2 with its sharded
   tail and pack against K2 and the plain step and pack on each state's
   slices (NaN weights, no eligible column, h as both candidates, a tie
   across K2's blocks among them), bit for bit, K5 with its head and K2
   with its sharded tail and pack against their plain chains over six
   pivots at P = 1, 2 and 4, bit for bit, K5 and K2 timed with and
   without their head and tails in turns, K5 with its owner flag and K2
   with a column offset and a given weight at h (offset 0: the
   single-card call bit for bit; a second slice at t = 0: its plain
   version bit for bit), K6 at the 8192^2 and the north-star f32
   shapes, then the batched kernels at config 3's shapes (B=256, M=512, R=3072, L=32) and
   the wide ones (B=32, R=15104), under devex and Dantzig, with a frozen
   lane and a lane that hits its fuse mid-window (``batch_window``: one
   kernel a call, one thread-block cluster a lane, its plan printed),
   and K12 at config 3's shapes (``batch_apply_reprice``'s fold with no
   live eta bit for bit), and ``batch_rank1`` at config 3's f64 phase-1
   tableau (256 x 512 x 3,000) bit for bit against its plain version
   (``addr_`` a lane), with a lane left out untouched, rows of whole
   16-byte vectors and not (R = 63, 64 and 2,999), how many elements
   ``addcmul_`` and ``baddbmm_`` give otherwise, its plan printed, and
   its time with a quarter of the lanes live and at R = 2,999; the
   sequential loops' kernels (``seq_step_pre``, ``seq_ratio_colk``,
   ``seq_ratio`` and ``seq_rank1`` at the 8192^2 f64 tableau,
   ``seq_ratio_snapshot`` and K6 with its tail at 2048^2 f32,
   ``seq_colk`` and ``seq_snapshot`` timed as ``seq_ratio_colk`` and
   ``seq_ratio_snapshot`` less ``seq_ratio``, K6's tail as K6's tiles
   with it less without) against their
   plain versions from 24 seeded states each (a NaN in b, a tie, no
   eligible row, Bland, the fuse), bit for bit, ``seq_rank1`` in turns
   with ``batch_rank1`` at one lane and ``addr_``; the sequential
   sharded loop's kernels (``seq_fold_column``, ``seq_ratio_colk_sharded``
   with ``seq_rank1``) against their plain versions at the 8192^2 f64
   tableau on two slices from 24 seeded states (a rank that does not own
   h, a tie of the smallest cost across the slices) and on one from 8,
   bit for bit, then timed on one; the plain blocked loop's kernels
   (``eta_ratio``, ``eta_colk``) against their plain versions at the f64
   phase-1 tableau of random_2048_2048 under devex, pivot by pivot
   through a window's first 64 pivots from edge states (Bland, the fuse,
   a NaN in b, no eligible row, a devex re-anchor), and at a mixed-pair
   2,047 x 6,143 state whose slab rows start off 16-byte boundaries, bit
   for bit, then timed at t = 64 at 2048^2 and 8192^2 beside ``addmv``
   forming the live column; the sharded plain blocked loop's kernels
   (``eta_fold_column``, ``eta_ratio_summed``, ``eta_colk_slice``)
   against their plain versions at the same tableau as two slices of the
   card and as one, pivot by pivot through a window's first 64 pivots from
   edge states (Bland, the fuse, a NaN in b, a weight past the re-anchor's
   bound on the last slice), bit for bit, then at t = 64 on one slice
   ``eta_fold_column`` and ``eta_ratio_summed`` held bit for bit to, and
   timed in turns with, the forms before their redesign (``slice_prior``
   of ``tools/eta_variants.cu``, built by nvcc as a library), and each
   timed beside ``addmv`` forming the live column or row; the latency
   floor of a one-thread
   kernel (``tools/latency_floor.cu``: an empty kernel, one load, two
   dependent loads) by the same clocks;
   each timed on the device by two clocks -- torch.profiler, and CUDA
   events (over a CUDA graph of 50 calls for K1, K2 and K5, over
   back-to-back calls for the rest) -- beside its bound and, where one
   PyTorch call computes the same function, that call's time; then one
   config-3 batch traced (device time by kernel, the device's busy
   share), and the flagship's phase-1 loop traced, single-card and
   sharded at one NCCL rank (the kernels -- and the NCCL nodes, 5 + 2/L
   of them -- a pivot of a replayed window, the device's busy share
   inside a window and over its period), and the sequential loops'
   phase-1 loop calls (random_1024_1024 f64, K6's random_2048_2048, and
   the f64 random_1024_1024 through ``solve_sharded`` at one NCCL rank:
   the kernels -- and the sharded chunk's NCCL nodes -- a pivot of each
   replayed chunk, the device's busy share inside a chunk and over its
   period), and the plain blocked loop's (f64 L=128 random_2048_2048:
   every node of a replayed window, the apply's cuBLAS kernels among
   them, the busy share inside a window and over its period), and the
   plain blocked sharded loop's (the same at one NCCL rank: 3 kernels and
   2 copies a pivot of a replayed window, the busy shares). These run
   last so that no profiler run precedes the timed solves.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over HBM's 3.35 TB/s and its
operations over the peak rate of their type: 67 TFLOP/s for f32 outside
the tensor cores, 34 TFLOP/s for f64 (NVIDIA's H100 SXM data sheet).

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' records (K1-K12, ``batch_rank1``, ``step_pre`` and the tails
``step_mid_tail`` and ``step_post_tail`` -- each tail's own cost, K1's
or K2's time with it less their time without -- and the sharded step
kernels with K2's sharded tails, the step after K2 and the pack, and
K5's head, and the sequential loops' kernels with K6's tail, the
sequential sharded loop's two, the plain blocked loop's two and the
plain blocked sharded loop's three, which replace XLA-fused glue, no
Pallas kernel;
K11 and K12 are on no
path, in the port as in the JAX package, so their launches are 0), and
``{"ok": true, "device":
{...}}``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "data" / "examples"
PROD = dict(dtype="float32", vector_dtype="float64", block_pivots=128)

#: Certified f64 objectives (data/measures/refine_sweep_r5.json).
OBJ_1024 = 4.000455470573328
OBJ_2048 = 3.3087010624810915
OBJ_8192 = 2.701733460335518
#: Flagship solves in one process: the first, then the warm ones.
FLAGSHIP_SOLVES = 5
#: The production flagship's walk (phase 1, phase 2) on one card.
FLAGSHIP_WALK = (9206, 409)
#: Pivots between checkpoints in the resumable phase: about four phase-1
#: windows of the flagship, each followed by a file.
CHECKPOINT_EVERY = 2048

#: Each kernel's record: (id, the JAX kernel it replaces -- the function
#: reaching pl.pallas_call --, its source).
SOURCE = "simplex_tpu_torch/kernels/csrc/blocked.cu"
KERNELS = {
    "ah_ratio": ("K1", "simplex_tpu/kernels/blocked.py:1201", SOURCE),
    "colk_costs": ("K2", "simplex_tpu/kernels/blocked.py:410", SOURCE),
    "apply_reprice": ("K3", "simplex_tpu/kernels/blocked.py:832", SOURCE),
    "apply_window": ("K4", "simplex_tpu/kernels/blocked.py:694", SOURCE),
    "ah": ("K5", "simplex_tpu/kernels/blocked.py:1300", SOURCE),
    "reprice": ("K11", "simplex_tpu/kernels/blocked.py:976", SOURCE),
}
#: The per-pivot steps: the JAX loop's XLA-fused scalar glue (no Pallas
#: kernel), each replacing the lines it ports -- ``step_pre`` a kernel of
#: its own (csrc/step.cu, once a window), the other two tails of K1 and
#: K2 (their bodies csrc/step.cuh, run in csrc/blocked.cu's last blocks).
STEP_KERNELS = {
    "step_pre": ("glue", "simplex_tpu/solver.py:731",
                 "simplex_tpu_torch/kernels/csrc/step.cu"),
    "step_mid_tail": ("glue", "simplex_tpu/solver.py:751",
                      "simplex_tpu_torch/kernels/csrc/step.cuh"),
    "step_post_tail": ("glue", "simplex_tpu/solver.py:777",
                       "simplex_tpu_torch/kernels/csrc/step.cuh"),
}
STEPS = tuple(STEP_KERNELS)
#: Bytes each step moves on a taken pivot outside Bland mode (the timed
#: state), each 0-dim input read once and each output written once
#: (csrc/step.cuh): step_pre reads status, iterations, bland, h_b, h_d and
#: v_d (25) and writes active, h, minc and optimal (14); K1's tail reads
#: active, optimal and minc (10; K1's p and flag are in registers) and
#: writes do, p and u (13); K2's tail reads z, u, bk, active, optimal,
#: unb, stall and iterations (38; do and the candidates are in registers),
#: writes status, stall, bland, iterations and z (21), and as the next
#: pivot's step before K1 writes 14.
STEP_BYTES = {"step_pre": 39, "step_mid_tail": 23, "step_post_tail": 73}
#: The sharded loop's per-pivot step: the JAX sharded loop's XLA-fused
#: glue around its passes and collectives (no Pallas kernel), each
#: replacing the lines it ports -- sharded_step_pre (once a window),
#: sharded_ratio (one thread-block cluster), sharded_pack (the window
#: boundary's) and sharded_fold (the window's last fold) kernels of their
#: own (csrc/sharded_step.cu), the step after K2 as K2's tail (its body
#: csrc/step.cuh's step::post) and the pack after it as the same tail's
#: end (csrc/blocked.cu), and the fold with the next step before K5 as
#: K5's head (its body csrc/sharded_step.cuh, run in csrc/blocked.cu).
SHARDED_STEP_SOURCE = "simplex_tpu_torch/kernels/csrc/sharded_step.cu"
SHARDED_STEP_KERNELS = {
    "sharded_step_pre": ("glue", "simplex_tpu/parallel/sharded.py:668",
                         SHARDED_STEP_SOURCE),
    "sharded_ratio": ("glue", "simplex_tpu/parallel/sharded.py:687",
                      SHARDED_STEP_SOURCE),
    "sharded_pack": ("glue", "simplex_tpu/parallel/sharded.py:741",
                     SHARDED_STEP_SOURCE),
    "sharded_fold": ("glue", "simplex_tpu/parallel/sharded.py:738",
                     SHARDED_STEP_SOURCE),
    "sharded_post_tail": ("glue", "simplex_tpu/parallel/sharded.py:743",
                          "simplex_tpu_torch/kernels/csrc/step.cuh"),
    "sharded_pack_tail": ("glue", "simplex_tpu/parallel/sharded.py:741",
                          SOURCE),
    "sharded_fold_head": ("glue", "simplex_tpu/parallel/sharded.py:738; "
                          "simplex_tpu/parallel/sharded.py:668",
                          "simplex_tpu_torch/kernels/csrc/sharded_step.cuh"),
}
SHARDED_STEPS = tuple(SHARDED_STEP_KERNELS)
#: Bytes each sharded step moves on a taken pivot outside Bland mode under
#: devex at one rank, each input read once and each output written once:
#: sharded_step_pre reads status, iterations, bland, h_b, h_d, v_d and w_d
#: (29) and writes active, h, minc, optimal, wh, own and hl (23);
#: sharded_ratio reads the column and b (12 bytes a constraint, added
#: where it is timed), active, optimal and minc (10) and writes k, unb,
#: do, p, bk and u (29); sharded_pack reads K2's four candidates and two
#: weights (32) and writes the five values and two indices (48);
#: sharded_fold reads the gathered (1, 5) and (1, 2) buffers (48) and
#: writes the six folded values (32); K2's tail reads z, u, bk, active,
#: optimal, unb, stall and iterations (38; do is in registers) and writes
#: status, stall, bland, iterations and z (21); the pack at its end reads
#: the two weights (8; the candidates are in registers) and writes the
#: five values and two indices (48); K5's head reads the gathered buffers
#: (48) and status, iterations and bland (9), writes the six folded
#: values (32) and, as the step before K5, 23.
SHARDED_STEP_BYTES = {"sharded_step_pre": 52, "sharded_ratio": 39,
                      "sharded_pack": 80, "sharded_fold": 80,
                      "sharded_post_tail": 59, "sharded_pack_tail": 56,
                      "sharded_fold_head": 112}
#: The kernels of the single-card production path, and of the sharded one.
SINGLE_PATH = ("ah_ratio", "colk_costs", "apply_reprice", "apply_window",
               *STEPS)
SHARDED_PATH = ("ah", "colk_costs", "apply_reprice", "apply_window",
                *SHARDED_STEPS)
PIVOT_KERNELS = {
    "fused_pivot": ("K6", "simplex_tpu/kernels/pivot.py:126",
                    "simplex_tpu_torch/kernels/csrc/pivot.cu"),
}
#: K6's check shapes (M, R): the 8192^2 f32 tableau and the north-star
#: phase 1, both with the variable axis padded to 8 (use_pallas=True).
PIVOT_SHAPES = (("8192^2", (8192, 24576)), ("north-star", (10112, 120000)))

#: Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and
#: FLOP/s outside the tensor cores in f32 and f64.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12

#: BASELINE.json config 3's options (tools/bench_batch.py:43-75).
BATCH = dict(dtype="float32", vector_dtype="float64", eps=1e-5,
             block_pivots=32)
#: (n, m, seeds): config 3, and the lanes the TPU served from HBM.
CONFIG3 = (2000, 500, range(1000, 1256))
WIDE = (14000, 500, range(2000, 2032))
BATCH_SOURCE = "simplex_tpu_torch/kernels/csrc/batched.cu"
#: The batched kernels, the JAX kernels each replaces (K7 is
#: batch_window's pivot loop followed by batch_apply_reprice's fused
#: apply and fold), and their source.
BATCH_KERNELS = {
    "batch_window": ("K7/K8", "simplex_tpu/kernels/batched.py:521; "
                     "simplex_tpu/kernels/batched_hbm.py:330", BATCH_SOURCE),
    "batch_apply_reprice": ("K7/K9", "simplex_tpu/kernels/batched.py:521; "
                            "simplex_tpu/kernels/batched_hbm.py:214",
                            BATCH_SOURCE),
    "batch_apply": ("K10", "simplex_tpu/kernels/batched_hbm.py:281",
                    BATCH_SOURCE),
    "batch_reprice": ("K12", "simplex_tpu/kernels/batched.py:669",
                      BATCH_SOURCE),
}
#: The kernels of the batched path (K12 is on none, as in the JAX package).
BATCH_PATH = ("batch_window", "batch_apply_reprice", "batch_apply")
#: The batched fallback's kernel: the rank-1 update of the lane-batched
#: sequential loop. The JAX package has no Pallas kernel there: its
#: vmapped fallback updates each lane in XLA (solver.py:51 pivot_update).
FALLBACK_KERNELS = {
    "batch_rank1": ("fallback", "simplex_tpu/solver.py:51",
                    "simplex_tpu_torch/kernels/csrc/pivot.cu"),
}
#: The sequential loops' per-pivot kernels (kernels/seq.py): the JAX
#: loops' XLA-fused pivot (no Pallas kernel but K6), each replacing the
#: lines it ports -- seq_step_pre once a chunk, seq_ratio_colk (seq_ratio,
#: then seq_colk as its tail) and seq_rank1 a pivot of the default loop,
#: seq_ratio_snapshot (seq_ratio, then seq_snapshot as its tail) and K6
#: with its fold and the step after as its last tile block's tail
#: (seq_k6_tail) a pivot of the K6 loop.
SEQ_SOURCE = "simplex_tpu_torch/kernels/csrc/seq.cu"
SEQ_KERNELS = {
    "seq_step_pre": ("glue", "simplex_tpu/solver.py:79", SEQ_SOURCE),
    "seq_ratio": ("glue", "simplex_tpu/solver.py:99; "
                  "simplex_tpu/solver.py:127", SEQ_SOURCE),
    "seq_colk": ("glue", "simplex_tpu/solver.py:72; "
                 "simplex_tpu/solver.py:79", SEQ_SOURCE),
    "seq_rank1": ("glue", "simplex_tpu/solver.py:70",
                  "simplex_tpu_torch/kernels/csrc/pivot.cu"),
    "seq_snapshot": ("glue", "simplex_tpu/solver.py:253", SEQ_SOURCE),
    "seq_k6_tail": ("glue", "simplex_tpu/solver.py:258",
                    "simplex_tpu_torch/kernels/csrc/pivot.cu"),
    "seq_fold_column": ("glue", "simplex_tpu/parallel/sharded.py:116; "
                        "simplex_tpu/parallel/sharded.py:166", SEQ_SOURCE),
    "seq_ratio_colk_sharded": ("glue", "simplex_tpu/parallel/sharded.py:253",
                               SEQ_SOURCE),
}
SEQS = tuple(SEQ_KERNELS)
#: The sequential sharded loop's kernels (a pivot: seq_fold_column,
#: seq_ratio_colk_sharded, seq_rank1 on the slice).
SHARDED_SEQ_PATH = ("seq_fold_column", "seq_ratio_colk_sharded", "seq_rank1")
#: Bytes the one-thread steps move on a taken pivot outside Bland mode,
#: each input read once and each output written once (csrc/seq_step.cuh):
#: seq_step_pre reads status, iterations, bland, h_d, v_d, h_b and v_b (33
#: in f64) and writes active, h, minc and optimal (14); K6's tail (pure
#: f32) reads z, u, bk, status, iterations, stall, bland, active,
#: optimal, unb, do and the carried candidates (45; the new ones are in
#: registers), writes the candidates, status, stall, bland, iterations and
#: z (33) and as the next pivot's step before 10.
SEQ_STEP_BYTES = {"seq_step_pre": 47, "seq_k6_tail": 88}
#: The sequential loops' recorded walks (phase 1, phase 2) on the card:
#: the default options at 1024^2 and 8192^2 (data/measures/h100_f64's
#: CSVs), K6's path at 2048^2 (data/measures/h100_logs/'s chip_smoke
#: logs).
F64_WALKS = {1024: (1871, 64), 8192: (21697, 1123)}
K6_WALK = (4594, 342)
#: K6's path: a pure-f32 tableau (without vector_dtype the vectors stay
#: f64, the mixed mode, as in the JAX package).
K6_OPTS = dict(dtype="float32", vector_dtype="float32", use_pallas=True)
#: (K6 loop, M, R, tableau dtype, vector dtype, eps) of the sequential
#: kernels' check: the default loop at the 8192^2 f64 tableau, the K6 loop
#: at 2048^2 pure f32.
SEQ_KERNEL_SHAPES = ((False, 8192, 24576, "float64", "float64", 1e-9),
                     (True, 2048, 6144, "float32", "float32", 1e-4))
#: The plain blocked loop's per-pivot kernels (kernels/eta.py): the JAX
#: loop's XLA-fused pivot (no Pallas kernel), each replacing the lines it
#: ports -- eta_ratio (the live column, the ratio test, the step between)
#: and eta_colk (the live row, the vectors, the devex weights, the next
#: candidates, the step after and the next step before) a pivot; the
#: window's seq_step_pre is the sequential loops'.
ETA_SOURCE = "simplex_tpu_torch/kernels/csrc/eta.cu"
ETA_KERNELS = {
    "eta_ratio": ("glue", "simplex_tpu/solver.py:534", ETA_SOURCE),
    "eta_colk": ("glue", "simplex_tpu/solver.py:549", ETA_SOURCE),
}
ETAS = tuple(ETA_KERNELS)
#: The sharded plain blocked loop's kernels (kernels.eta's slice forms):
#: the JAX loop's pivot under shard_map is XLA-fused glue, no Pallas kernel
#: (simplex_tpu/parallel/sharded.py:418 the entering fold and the live
#: column, :425 the ratio test, :429 the live row and the updates).
SLICE_KERNELS = {
    "eta_fold_column": ("glue", "simplex_tpu/parallel/sharded.py:418",
                        ETA_SOURCE),
    "eta_ratio_summed": ("glue", "simplex_tpu/parallel/sharded.py:425",
                         ETA_SOURCE),
    "eta_colk_slice": ("glue", "simplex_tpu/parallel/sharded.py:429",
                       ETA_SOURCE),
}
SLICES = tuple(SLICE_KERNELS)
#: The plain blocked loop's configurations: the f64 tableau at L=128 (the
#: full f64 re-solve's), and the pure-f32 one with the kernels off.
BLOCKED_F64 = dict(dtype="float64", block_pivots=128)
BLOCKED_F32 = dict(dtype="float32", vector_dtype="float32",
                   use_pallas=False, block_pivots=128)
#: The f64 L=128 walk of random_2048_2048 on the card
#: (data/measures/h100_logs/pr22_chip_smoke.log, the plain blocked loop's
#: line), and the window depth of the kernels' check and timing.
BLOCKED_WALK = (4379, 258)
ETA_T = 64
#: The f64 L=128 loop's objectives, graphed and with ``graph=False``, bit
#: for bit, and its random_8192_8192 walk, as the card first recorded them
#: (data/measures/h100_logs/): the kernels sum every eta correction in one
#: order, whatever their grid.
BLOCKED_OBJ = {2048: 3.308701062479446, 8192: 2.701733460334003}
BLOCKED_WALK_8192 = (22070, 1191)
#: The second shape of the eta kernels' edge states: rows of F and C off
#: 16-byte boundaries (f32 rows of 4 bytes), the mixed pair, L=128.
ETA_ODD = (2047, 6143)
#: The kernels line's order.
ORDER = ("ah_ratio", "colk_costs", "apply_reprice", "apply_window", "ah",
         "fused_pivot", "batch_window", "batch_apply_reprice", "batch_apply",
         "reprice", "batch_reprice", "batch_rank1", *STEPS, *SHARDED_STEPS,
         *SEQS, *ETAS, *SLICES)
#: The default-option batch's lanes solved alone by solve() (config 3's
#: first, last and two between).
DEFAULT_BATCH_LANES = (0, 85, 170, 255)
#: Route (b)'s f64 blocked configuration at config 3.
FALLBACK_F64 = dict(dtype="float64", block_pivots=32)
#: Route (b)'s lanes timed apart as well: the 16 of config 3 that route
#: ran until it was batched (then lane by lane, a cut for time).
FALLBACK_LANES = 16
#: (n, m, seed, exponent) of the extreme-magnitude instance: a config-3
#: lane's shape, rows and columns scaled by 10^[-15, 15]
#: (tests/test_scaling.py's _extreme_problem).
EXTREME = (2000, 500, 1, 15)
#: The batched rank-1 update's check shape: config 3's phase-1 tableau of
#: the default options (B, M, R), f64.
RANK1_SHAPE = (256, 512, 3000)
#: Config 3's lanes of the two-rank fleet.
FLEET_LANES = 64
#: (label, (B, M, R, L)) of the batched kernels' check.
BATCH_KERNEL_SHAPES = (("config-3", (256, 512, 3072, 32)),
                       ("wide", (32, 512, 15104, 32)))


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: Sessions of torch.profiler that one trace may take (see ``traced``).
TRACE_TRIES = 3


def saw_device(prof) -> bool:
    """Whether a finished torch.profiler session recorded any event on the
    card (a kernel or a copy)."""
    from torch.autograd import DeviceType

    return any(e.device_type == DeviceType.CUDA for e in prof.key_averages())


def until_traced(run, what: str):
    """``run()``, which traces work on the card with torch.profiler and
    returns its finished profiler (or a tuple led by it), run again while
    the session recorded no event on the card at all. CUPTI now and then
    hands back such an empty session for work that launched kernels
    (``tools/profiler_probe.py`` counts them); a second session then sees
    them. Fails after ``TRACE_TRIES`` sessions, each empty one logged."""
    for attempt in range(1, TRACE_TRIES + 1):
        out = run()
        if saw_device(out[0] if isinstance(out, tuple) else out):
            return out
        log(f"{what}: the profiler recorded no event on the card "
            f"(session {attempt} of {TRACE_TRIES})")
    raise SmokeFailure(f"{what}: the profiler recorded no event on the card "
                       f"in {TRACE_TRIES} sessions")


def traced(fn, reps: int, what: str):
    """The torch.profiler session (CUDA activity) of ``reps`` back-to-back
    calls of ``fn()`` ended by a synchronize, after one warm-up call; an
    empty session is traced again (``until_traced``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()

    def run():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return prof

    return until_traced(run, what)


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device ms per call of ``fn()``: the summed durations of the kernels
    it launches, traced by torch.profiler (CUPTI) over ``reps`` calls
    after one warm-up call; with ``match``, only the kernels whose name
    holds it (leaving out the copies that reset a state between calls).
    The host's launch rate is left out: at these shapes one call of a
    per-pivot pass runs for microseconds, less than the host takes to
    enqueue it."""
    from torch.autograd import DeviceType

    prof = traced(fn, reps, f"device_ms({match or 'all'})")
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and (match is None or match in e.key))
    require(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / reps


def kernels_launched(fn, match: str | None = None) -> int:
    """The number of kernels one call of ``fn()`` launches on the card,
    counted by torch.profiler after one warm-up call; with ``match``, only
    those whose name holds it. Where CUPTI hands back ``TRACE_TRIES``
    empty sessions for the one call (seen on the card at single calls of
    K2 and of K5 with its head while every other session of the run saw
    its kernels), the count without ``match`` is the device operations a
    CUDA graph of one call holds (``graph_nodes``), logged."""
    from torch.autograd import DeviceType

    try:
        prof = traced(fn, 1, f"kernels_launched({match or 'all'})")
    except SmokeFailure:
        if match is not None:
            raise
        n = graph_nodes(fn)
        log(f"kernels_launched: the profiler missed the call; a CUDA graph "
            f"of one call holds {n} device operations")
        return n
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and (match is None or match in e.key))


def graph_nodes(fn) -> int:
    """The device operations (kernel, memset and copy nodes) that one call
    of ``fn()`` puts into a CUDA graph captured around it, after one
    warm-up call, read with the driver's ``cuGraphGetNodes``: what a
    torch.profiler session of the call counts, without CUPTI. The capture
    runs nothing."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = driver.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                 None, ctypes.byref(n))
    require(err == 0, f"cuGraphGetNodes: CUDA error {err}")
    return n.value


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn()`` over ``reps`` back-to-back
    calls, ending in one synchronize: the wrapper's cost when its kernel
    is shorter than the host's work for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def sm_clock() -> str:
    """The card's SM clock and its maximum, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """ms per call of ``fn()`` between two CUDA events around ``reps``
    back-to-back calls after one warm-up call: the device's time when
    the calls keep it busy (a cross-check of ``device_ms``)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 50, replays: int = 4) -> float:
    """ms per call of ``fn()`` between CUDA events around ``replays``
    replays of a CUDA graph that captured ``calls`` calls back to back:
    the device's time per call with no host enqueue in it (the per-pivot
    kernels run for microseconds, less than the host takes to launch
    them; a cross-check of ``device_ms``)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound(nbytes: float, f32_flops: float = 0.0,
          f64_flops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves ``nbytes`` and does the given operations."""
    t_bytes = nbytes / HBM_BPS
    t_ops = f32_flops / F32_FLOPS + f64_flops / F64_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(name: str, got, want, tol) -> float:
    """Max |got - want|, required to stay within the elementwise ``tol``
    (a tensor or float). Returns the max abs error."""
    import torch

    got = got.double()
    want = want.double()
    err = (got - want).abs()
    ok = bool(torch.all(err <= tol)) and bool(torch.isfinite(got).all())
    worst = float(err.max()) if err.numel() else 0.0
    require(ok, f"{name}: max abs err {worst:.3e} beyond tolerance")
    return worst


def equal(name: str, got, want) -> None:
    """Bit for bit, a NaN equal to a NaN (a NaN b gives a NaN bk)."""
    import torch

    bad = got != want
    if got.is_floating_point():
        bad &= ~(torch.isnan(got) & torch.isnan(want))
    if bool(bad.any()):
        first = tuple(torch.nonzero(bad)[0].tolist())
        raise SmokeFailure(
            f"{name}: {int(bad.sum())} of {bad.numel()} differ; first at "
            f"{first}: kernel {got[first].tolist()} != plain "
            f"{want[first].tolist()}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the flagship shapes.

def phase_kernels(records: dict, prior: PriorLib) -> None:
    """f32 outputs are held against the plain version at 1e-5 * (1 + |x|)
    (another summation order of up to L products). The f64 vectors are
    held, at 1e-12 relative, against the f64 formula applied to the
    kernel's own f32 operands: the kernel must round as that formula
    does, so one that carried a vector in f32 would miss by ~1e-7
    relative and fail."""
    import torch

    from simplex_tpu_torch.bench import pivot_work
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.tableau import tt_matvec

    dev = torch.device("cuda")
    M, R, L = 8192, 24576, 128
    eps = 1e-4
    g = torch.Generator(device=dev).manual_seed(20261016)
    ws = kb.colk_workspace(R, dev)
    ws1 = kb.ah_ratio_workspace(M, dev)
    log(f"kernel phase: SM clock before {sm_clock()}")

    def uni(shape, lo, hi, dtype=torch.float32):
        x = torch.rand(shape, generator=g, device=dev, dtype=dtype)
        return x * (hi - lo) + lo

    Tt = uni((M, R), -1.0, 1.0)
    b = uni((M,), 0.0, 100.0, torch.float64)
    costs0 = uni((R,), -1.0, 1.0, torch.float64)
    w0 = uni((R,), 1.0, 2.0)
    base0 = torch.randint(0, R, (M,), generator=g, device=dev,
                          dtype=torch.int32)
    h = torch.tensor(12345, dtype=torch.int32, device=dev)
    errs = {name: 0.0 for name in KERNELS}
    times = {name: [] for name in KERNELS}
    # The other clock for each kernel: CUDA events over a CUDA graph of 50
    # calls (K1, K2, K5), torch.profiler for K3/K4 (timed by events), CUDA
    # events over back-to-back calls for K11.
    check = {}
    for t in (0, 37, 127):
        C = uni((L, R), -1.0, 1.0)
        F = uni((L, M), -0.1, 0.1)
        C[t:] = 0.0
        F[t:] = 0.0
        # ---- K1, on one workspace throughout ----
        def k1(t=t):
            return kb.ah_ratio(Tt, F, C, b, h, t, eps, ws=ws1)

        got = k1()
        want = kb.ah_ratio_plain(Tt, F, C, b, h, t, eps)
        # f32 a_h: the eta correction sums t products in another order.
        errs["ah_ratio"] = max(errs["ah_ratio"], close(
            f"K1 a_h t={t}", got[0], want[0], 1e-5 * (1 + want[0].abs())))
        equal(f"K1 k t={t}", got[1], want[1])
        equal(f"K1 unbounded t={t}", got[4], want[4])
        require(int(got[4]) == 0, "K1 found no eligible row")
        # p and bk are the kernel's own a_h[k] and b[k], exactly.
        equal(f"K1 p t={t}", got[2], got[0][got[1].long()])
        equal(f"K1 bk t={t}", got[3], b[got[1].long()])
        # ---- K5: K1's column code, so K1's column bit for bit ----
        got5 = kb.ah(Tt, F, C, h, t)
        equal(f"K5 a_h t={t} vs K1's", got5, got[0])
        want5 = kb.ah_plain(Tt, F, C, h, t)
        errs["ah"] = max(errs["ah"], close(
            f"K5 a_h t={t}", got5, want5, 1e-5 * (1 + want5.abs())))
        k1_us = 1e3 * device_ms(k1, 50)
        log(f"K1 t={t}: {k1_us:.2f} us a call on the device")
        k5 = functools.partial(kb.ah, Tt, F, C, h, t)
        log(f"K5 t={t}: {1e3 * device_ms(k5, 50):.2f} us a call by "
            f"torch.profiler, {1e3 * graph_ms(k5):.2f} us by CUDA events "
            "over a CUDA graph")
        if t == 37:
            step_kernels(records, Tt, F, C, b, costs0, w0, base0, t)
            sharded_step_kernels(records, Tt, F, C, b, costs0, w0, base0, t,
                                 got[0], prior)
            # K5 with its owner flag (the sharded loop's call): its column
            # where the rank owns h, zeros where not, bit for bit.
            buf = torch.empty(M, dtype=torch.float32, device=dev)
            for own in (True, False):
                kb.ah(Tt, F, C, h, t, own=torch.tensor(own, device=dev),
                      out=buf)
                equal(f"K5 own={own} t={t}", buf,
                      got5 if own else torch.zeros_like(got5))
            n = kernels_launched(k1)
            require(n == 1, f"one ah_ratio call launched {n} kernels")
            host = host_us(k1, 500)
            # The two-launch kernel's wrapper made four more allocations a
            # call (the partials' keys and indices, k, p and the flag
            # apart).
            f64, i32 = torch.float64, torch.int32
            more = host_us(lambda: (
                k1(), torch.empty(M // 256, dtype=f64, device=dev),
                torch.empty(M // 256, dtype=i32, device=dev),
                torch.empty((), dtype=i32, device=dev),
                torch.empty((), dtype=torch.float32, device=dev)), 500)
            log(f"K1: one call launches {n} kernel (torch.profiler); "
                f"{host:.1f} us of host time a call (wrapper and enqueue, "
                f"host clock over 500 calls); {more:.1f} us with four "
                "more allocations, as the two-launch kernel's wrapper "
                "made")
            times["ah_ratio"] = [
                k1_us / 1e3,
                device_ms(lambda: kb.ah_ratio_plain(Tt, F, C, b, h, t, eps),
                          50)]
            times["ah"] = [device_ms(lambda: kb.ah(Tt, F, C, h, t), 50),
                           device_ms(lambda: kb.ah_plain(Tt, F, C, h, t), 50)]
            check["ah_ratio"] = graph_ms(k1)
            check["ah"] = graph_ms(lambda: kb.ah(Tt, F, C, h, t))
            # K5's library call: one addmv on views of the column and of
            # the live eta rows.
            hi = int(h)
            lib5 = functools.partial(torch.addmv, Tt[:, hi], F[:t].t(),
                                     C[:t, hi], alpha=-1.0)
            close("K5 a_h vs addmv", got5, lib5(),
                  1e-5 * (1 + want5.abs()))
            library_ah = device_ms(lib5, 50)
        # ---- K2 (devex and Dantzig), on one workspace throughout ----
        ah, k, p, bk = got[0], got[1], got[2], got[3]
        u = torch.tensor(-0.5, dtype=torch.float64, device=dev) / p.double()
        do = torch.tensor(True, device=dev)
        for rule, w in (("devex", w0), ("dantzig", None)):
            outs = []
            for fn in (functools.partial(kb.colk_costs, ws=ws),
                       kb.colk_costs_plain):
                st = dict(C=C.clone(), F=F.clone(), costs=costs0.clone(),
                          b=b.clone(), base=base0.clone(),
                          w=None if w is None else w.clone())
                cand = fn(Tt, st["C"], st["F"], st["costs"], k, t, u, do,
                          R - 100, eps, ah, st["b"], st["base"], h, p, bk,
                          st["w"])
                outs.append((st, cand))
            (sk, ck), (sp, cp) = outs
            tag = f"K2 {rule} t={t}"
            # The sharded loop's arguments at offset 0 with w_h = w[h]:
            # the single-card call bit for bit.
            st = dict(C=C.clone(), F=F.clone(), costs=costs0.clone(),
                      b=b.clone(), base=base0.clone(),
                      w=None if w is None else w.clone())
            c0 = kb.colk_costs(
                Tt, st["C"], st["F"], st["costs"], k, t, u, do, R - 100, eps,
                ah, st["b"], st["base"], h, p, bk, st["w"], ws=ws, offset=0,
                w_h=None if w is None else w[h.long()].clone())
            for name in st:
                if st[name] is not None:
                    equal(f"{tag} offset 0 {name}", st[name], sk[name])
            for a, b2 in zip(c0, ck):
                equal(f"{tag} offset 0 candidates", a, b2)
            if t == 0:
                k2_slice(tag, Tt, C, F, costs0, k, u, do, eps, ah, b, base0,
                         h, p, bk, w, ws)
            # The pivot row at h and K1's p are both Tt[k, h] - the FFMA
            # chain over s < t of C[s, h] F[s, k], in s order: bit for bit.
            equal(f"{tag} C[t][h] vs K1's p", sk["C"][t][h.long()], p)
            # f32 pivot row: another summation order of t products.
            e = close(f"{tag} C[t]", sk["C"][t], sp["C"][t],
                      1e-5 * (1 + sp["C"][t].abs()))
            equal(f"{tag} C rows < t", sk["C"][:t], sp["C"][:t])
            # costs -= u * colk in f64, on the kernel's own pivot row.
            costs_x = costs0 - u * sk["C"][t].double()
            e = max(e, close(f"{tag} costs", sk["costs"], costs_x,
                             1e-12 * (1 + costs_x.abs())))
            # b and the eta row: the same f64 / f32 operations on the
            # same inputs as the plain version.
            e = max(e, close(f"{tag} b", sk["b"], sp["b"],
                             1e-12 * (1 + sp["b"].abs())))
            e = max(e, close(f"{tag} F[t]", sk["F"][t], sp["F"][t],
                             1e-6 * (1 + sp["F"][t].abs())))
            equal(f"{tag} base", sk["base"], sp["base"])
            if w is not None:
                # f32 weights from alpha = colk / p: the C[t] bound, squared.
                e = max(e, close(f"{tag} w", sk["w"], sp["w"],
                                 1e-4 * (1 + sp["w"].abs())))
            # Candidates: the same columns as the plain version, and the
            # exact fold of the kernel's own costs and weights.
            own = kb.entering_candidates(sk["costs"], sk["w"], R - 100, eps)
            for i, nm in enumerate(("h_d", "v_d", "h_b", "v_b")):
                equal(f"{tag} {nm}", ck[i], own[i])
                if i % 2 == 0:
                    equal(f"{tag} {nm} vs plain", ck[i], cp[i])
            errs["colk_costs"] = max(errs["colk_costs"], e)
            st = dict(C=C.clone(), F=F.clone(), costs=costs0.clone(),
                      b=b.clone(), base=base0.clone(),
                      w=None if w is None else w.clone())
            args = (Tt, st["C"], st["F"], st["costs"], k, t, u, do,
                    R - 100, eps, ah, st["b"], st["base"], h, p, bk, st["w"])
            k2_us = 1e3 * device_ms(lambda: kb.colk_costs(*args, ws=ws), 50)
            log(f"{tag}: {k2_us:.2f} us a call on the device")
            if t == 37 and rule == "devex":
                n = kernels_launched(lambda: kb.colk_costs(*args, ws=ws))
                require(n == 1, f"one colk_costs call launched {n} kernels")
                host = host_us(lambda: kb.colk_costs(*args, ws=ws), 500)
                log(f"K2: one call launches {n} kernel (torch.profiler); "
                    f"{host:.1f} us of host time a call (wrapper and "
                    "enqueue, host clock over 500 calls)")
                times["colk_costs"] = [
                    k2_us / 1e3,
                    device_ms(lambda: kb.colk_costs_plain(*args), 50)]
                check["colk_costs"] = graph_ms(
                    lambda: kb.colk_costs(*args, ws=ws))
        # ---- K3 / K4 (full window: every eta row live) ----
        if t == 127:
            C = uni((L, R), -1.0, 1.0)
            F = uni((L, M), -0.1, 0.1)
            coeffs = uni((M,), -1.0, 1.0, torch.float64)
            Tk, Tp = Tt.clone(), Tt.clone()
            mv_k = kb.apply_reprice(Tk, C, F, coeffs)
            kb.apply_reprice_plain(Tp, C, F, coeffs)
            # f32 apply: L products summed in another order.
            tol_T = 1e-5 * (1 + Tp.abs())
            e = close("K3 Tt", Tk, Tp, tol_T)
            # mv = coeffs @ Tt_new in f64 over the kernel's own Tt: only
            # the f64 summation order differs, whose error stays below
            # M * 2^-53 = 9e-13 of sum |coeffs * Tt|.
            scale = tt_matvec(Tk.abs(), coeffs.abs())
            e = max(e, close("K3 mv", mv_k, tt_matvec(Tk, coeffs),
                             1e-12 * scale))
            # The same row groups summed in the same orders as K11's fold.
            equal("K3 mv vs K11 on K3's output", mv_k, kb.reprice(Tk, coeffs))
            errs["apply_reprice"] = e
            T3 = Tk
            Tk, Tp = Tt.clone(), Tt.clone()
            kb.apply_window(Tk, C, F)
            kb.apply_window_plain(Tp, C, F)
            errs["apply_window"] = close("K4 Tt", Tk, Tp, tol_T)
            # K4 rounds every element as K3's tile does: the same Tt.
            equal("K4 Tt vs K3's apply", Tk, T3)
            del Tk, Tp, T3
            k4_vs_k3_small(g)
            # ---- K11: coeffs @ Tt in f64, K3's fold without the apply --
            mv11 = kb.reprice(Tt, coeffs)
            errs["reprice"] = close(
                "K11 mv", mv11, kb.reprice_plain(Tt, coeffs),
                1e-12 * tt_matvec(Tt.abs(), coeffs.abs()))
            zero = (torch.zeros((8, R), device=dev),
                    torch.zeros((8, M), device=dev))
            T0 = Tt.clone()
            equal("K11 mv vs K3's with zero etas", mv11,
                  kb.apply_reprice(T0, *zero, coeffs))
            del T0
            times["reprice"] = [
                device_ms(lambda: kb.reprice(Tt, coeffs), 10),
                device_ms(lambda: kb.reprice_plain(Tt, coeffs), 5)]
            check["reprice"] = event_ms(lambda: kb.reprice(Tt, coeffs), 10)
            library_reprice = device_ms(lambda: coeffs @ Tt.double(), 5)
            # The window applies: CUDA events over back-to-back calls (each
            # call keeps the device busy for over a millisecond), the
            # profiler's sum printed beside (it has dropped launches of
            # these long kernels). K3, K4 and K4's plain version (cuBLAS
            # addmm_) in turns: K3, K4, addmm_, addmm_, K4, K3.
            T2 = Tt.clone()
            fns = {"K3": lambda: kb.apply_reprice(T2, C, F, coeffs),
                   "K3 plain": lambda: kb.apply_reprice_plain(T2, C, F,
                                                              coeffs),
                   "K4": lambda: kb.apply_window(T2, C, F),
                   "addmm_": lambda: kb.apply_window_plain(T2, C, F)}
            ev = {}
            for name in ("K3", "K4", "addmm_", "addmm_", "K4", "K3",
                         "K3 plain"):
                ev.setdefault(name, []).append(event_ms(fns[name], 10))
            prof = {name: device_ms(fns[name], 5) for name in fns}
            times["apply_reprice"] = [statistics.mean(ev["K3"]),
                                      ev["K3 plain"][0]]
            times["apply_window"] = [statistics.mean(ev["K4"]),
                                     statistics.mean(ev["addmm_"])]
            check["apply_reprice"] = prof["K3"]
            check["apply_window"] = prof["K4"]
            k3, k4, mm = (times["apply_reprice"][0],
                          *times["apply_window"])
            log(f"K3 apply_reprice {ev['K3'][0]:.4f} / {ev['K3'][1]:.4f} "
                f"ms, K4 apply_window {ev['K4'][0]:.4f} / "
                f"{ev['K4'][1]:.4f} ms, addmm_ {ev['addmm_'][0]:.4f} / "
                f"{ev['addmm_'][1]:.4f} ms (CUDA events in turns: K3, K4, "
                f"addmm_, addmm_, K4, K3; M={M} R={R} L={L}); K4/addmm_ "
                f"{k4 / mm:.3f}, K3/K4 {k3 / k4:.3f}; profiler: "
                + ", ".join(f"{k} {v:.4f}" for k, v in prof.items()))
            del T2
    # Bounds at the timed inputs (K1/K2 at t = 37, K2 under devex; K3/K4
    # a full window): bytes each input read once and each output written
    # once, and the operations -- the counts of the bench's floor.
    t = 37
    work = pivot_work(M, R, L, t, True, 4)
    bounds = {
        **{name: bound(*cost) for name, cost in work.items()},
        # K5: the column h, t live F rows and t values of C, the output.
        "ah": bound(4 * M + 4 * t * M + 4 * t + 4 + 4 * M, 2 * t * M),
        "reprice": bound(4 * M * R + 8 * M + 8 * R, 0, 2 * M * R),
    }
    # K4's plain version is one PyTorch call (cuBLAS addmm_): its time is
    # also the library's. K5's is ``torch.addmv`` (above), K11's
    # ``coeffs @ Tt.double()``, the cast included. K1-K3 have no single
    # call that computes them.
    library = {"apply_window": times["apply_window"][1],
               "ah": library_ah, "reprice": library_reprice}
    for name, (kid, _, _) in KERNELS.items():
        ms, plain_ms = times[name]
        bound_ms, by = bounds[name]
        records[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "library_ms": library.get(name),
                         "check_ms": check[name]}
        log(f"{kid} {name}: matches plain (max abs err {errs[name]:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({by})")
    log(f"kernel phase: SM clock after {sm_clock()}")


def step_kernels(records: dict, Tt, F, C, b, costs, w, base, t: int
                 ) -> None:
    """``step_pre`` and K1 and K2 with the steps as their tails against
    ``step_pre_plain``, K1, ``step_mid_plain``, K2 and ``step_post_plain``
    on the card, at the flagship shapes (the phase's tableau, t = 37 live
    eta rows), under 64 seeded states for each anti-cycling policy --
    taken and skipped pivots, the fuse, optimal, K1 unbounded (an eps no
    row reaches), Bland on and off, z moving by less than eps and by
    more, devex and Dantzig, with and without the next pivot's step:
    every scalar, K1's column and every vector K2 updates bit for bit.
    Then, on a taken pivot outside Bland mode, K1 and K2 timed with and
    without their tails in turns, by torch.profiler and by CUDA events
    over a CUDA graph of 50 calls: a tail's own cost is the kernel's time
    with it less its time without, beside the plain step's time and the
    step's bound (``STEP_BYTES``: latency binds one thread's scalars,
    whose bytes take picoseconds)."""
    import numpy as np
    import torch

    from simplex_tpu_torch.kernels import blocked as kb

    dev = torch.device("cuda")
    M, R = Tt.shape
    r = R - 100
    eps, max_iter = 1e-4, 10
    rng = np.random.default_rng(20261017)
    running = int(kb.RUNNING)
    ws1 = [kb.ah_ratio_workspace(M, dev) for _ in range(2)]
    ws2 = [kb.colk_workspace(R, dev) for _ in range(2)]
    ahs = [torch.empty(M, dtype=torch.float32, device=dev) for _ in range(2)]

    def state(bland: bool, fills: dict):
        z = torch.tensor(rng.uniform(-5, 5), dtype=torch.float64, device=dev)
        s = kb.pivot_scalars(z, bland)
        for name, v in fills.items():
            getattr(s, name).fill_(v)
        return s

    def vectors(devex: bool) -> dict:
        return dict(C=C.clone(), F=F.clone(), costs=costs.clone(),
                    b=b.clone(), base=base.clone(),
                    w=w.clone() if devex else None)

    seen = collections.Counter()
    for policy in ((False, 50), (False, None), (True, 50)):
        for i in range(64):
            fills = dict(
                status=running if rng.random() < 0.8 else int(kb.OPTIMAL),
                iterations=int(rng.integers(8, 11)),
                stall=int(rng.integers(47, 51)),
                h_d=int(rng.integers(0, r)),
                v_d=-1e-4 * rng.uniform(0.5, 3),
                h_b=int(rng.choice([3, kb.BIG_INDEX])),
                v_b=-rng.uniform(0, 1))
            if i % 4 == 1:
                fills["v_d"] = -rng.uniform(0.01, 3)
            k1_eps = 1e30 if i % 4 == 0 else eps
            then_pre = bool(i % 2)
            devex = i % 8 < 4
            sk = state(bool(rng.integers(2)), fills)
            sp = kb.PivotScalars(**{n: x.clone()
                                    for n, x in sk.tensors().items()})
            vk, vp = vectors(devex), vectors(devex)
            kb.step_pre(sk, max_iter, eps)
            kb.ah_ratio_tail(Tt, vk["F"], vk["C"], vk["b"], t, k1_eps, sk,
                             ahs[0], ws1[0])
            kb.colk_costs_tail(Tt, vk["C"], vk["F"], vk["costs"], t, r, eps,
                               ahs[0], vk["b"], vk["base"], vk["w"], sk,
                               max_iter, ws2[0], bland_static=policy[0],
                               threshold=policy[1], then_pre=then_pre)
            kb.step_pre_plain(sp, max_iter, eps)
            kb.ah_ratio(Tt, vp["F"], vp["C"], vp["b"], sp.h, t, k1_eps,
                        ws1[1], out=(ahs[1], sp.k, sp.p_k1, sp.bk, sp.unb))
            kb.step_mid_plain(sp)
            kb.colk_costs(Tt, vp["C"], vp["F"], vp["costs"], sp.k, t, sp.u,
                          sp.do, r, eps, ahs[1], vp["b"], vp["base"], sp.h,
                          sp.p, sp.bk, vp["w"], ws2[1],
                          out=(sp.h_d, sp.v_d, sp.h_b, sp.v_b))
            kb.step_post_plain(sp, max_iter, eps, *policy, then_pre)
            tag = f"tails {policy} state {i}"
            for name, x in sk.tensors().items():
                equal(f"{tag} {name}", x, getattr(sp, name))
            equal(f"{tag} a_h", ahs[0], ahs[1])
            for name, x in vk.items():
                if x is not None:
                    equal(f"{tag} {name}", x, vp[name])
            seen["taken" if bool(sk.do) else "skipped"] += 1
            seen["unbounded"] += bool(sk.unb)
            seen["bland"] += bool(sk.bland)
    require(min(seen["taken"], seen["skipped"], seen["unbounded"]) > 0,
            f"the tails' states miss a kind of pivot: {dict(seen)}")
    log(f"step_pre and K1 and K2 with their tails: every scalar, a_h and "
        f"vector equals the plain chain's on 192 states ({dict(seen)})")

    # A taken pivot outside Bland mode, far from the fuse, under devex.
    big = 2 ** 30
    s = state(False, dict(h_b=kb.BIG_INDEX, v_d=-1.0))
    v = vectors(True)
    kb.step_pre(s, big, eps)
    kb.ah_ratio_tail(Tt, F, C, b, t, eps, s, ahs[0], ws1[0])
    require(bool(s.do), "the timed pivot is not taken")
    k2_args = (Tt, v["C"], v["F"], v["costs"], s.k, t, s.u, s.do, r, eps,
               ahs[0], v["b"], v["base"], s.h, s.p, s.bk, v["w"], ws2[0])
    timed = {
        "K1": (lambda: kb.ah_ratio(Tt, F, C, b, s.h, t, eps, ws1[0], out=(
            ahs[0], s.k, s.p_k1, s.bk, s.unb)), "ah_ratio_fused"),
        "K1+tail": (lambda: kb.ah_ratio_tail(Tt, F, C, b, t, eps, s, ahs[0],
                                             ws1[0]), "ah_ratio_fused"),
        "K2": (lambda: kb.colk_costs(*k2_args,
                                     out=(s.h_d, s.v_d, s.h_b, s.v_b)),
               "colk_costs_fused"),
        "K2+tail": (lambda: kb.colk_costs_tail(
            Tt, v["C"], v["F"], v["costs"], t, r, eps, ahs[0], v["b"],
            v["base"], v["w"], s, big, ws2[0], bland_static=False,
            threshold=50, then_pre=True), "colk_costs_fused"),
    }
    for name in ("K1+tail", "K2+tail"):
        n = kernels_launched(timed[name][0])
        require(n == 1, f"one {name} call launched {n} kernels")
    prof = {name: [] for name in timed}
    graph = {name: [] for name in timed}
    for name in ("K1", "K1+tail", "K2", "K2+tail", "K2+tail", "K2",
                 "K1+tail", "K1"):
        fn, match = timed[name]
        prof[name].append(device_ms(fn, 50, match=match))
        graph[name].append(graph_ms(fn))
    mean = statistics.mean
    log("K1 and K2 with and without their tails, ms a call in turns (K1, "
        "K1+tail, K2, K2+tail, then back): " + "; ".join(
            f"{name} " + ", ".join(f"{x:.5f}" for x in prof[name])
            + " (torch.profiler), " + ", ".join(f"{x:.5f}"
                                                 for x in graph[name])
            + " (CUDA graph of 50 calls)" for name in timed))
    plain = {
        "step_pre": (lambda: kb.step_pre(s, big, eps),
                     lambda: kb.step_pre_plain(s, big, eps)),
        "step_mid_tail": (None, lambda: kb.step_mid_plain(s)),
        "step_post_tail": (None, lambda: kb.step_post_plain(
            s, big, eps, False, 50, True)),
    }
    carrier = {"step_mid_tail": "K1", "step_post_tail": "K2"}
    for name, (kernel, plain_fn) in plain.items():
        if kernel is not None:
            ms = device_ms(kernel, 50, match=name)
            check_ms = graph_ms(kernel)
        else:
            k = carrier[name]
            ms = mean(prof[k + "+tail"]) - mean(prof[k])
            check_ms = mean(graph[k + "+tail"]) - mean(graph[k])
        bound_ms, by = bound(STEP_BYTES[name])
        records[name] = {"max_abs_err": 0.0, "ms": ms,
                         "plain_ms": device_ms(plain_fn, 50),
                         "bound_ms": bound_ms, "bound_by": by,
                         "library_ms": None, "check_ms": check_ms}
        log(f"{name}: {ms:.5f} ms a call"
            + ("" if kernel is not None else
               f" (its carrier {carrier[name]} with it less without, "
               "torch.profiler)")
            + f", {check_ms:.5f} ms by CUDA events over a CUDA graph of 50 "
            f"calls, plain {records[name]['plain_ms']:.4f} ms, bound "
            f"{bound_ms:.2e} ms ({by})")


def sharded_step_kernels(records: dict, Tt, F, C, b, costs, w, base,
                         t: int, ah, prior: PriorLib) -> None:
    """The sharded loop's step on the card at the flagship shapes (M =
    8192, R = 24,576 columns cut into P slices, t = 37 live eta rows, K1's
    column ``ah`` as the summed column, its b, a basis drawn over the
    columns, the slice weights). First the one-launch kernels against
    their plain versions under 192 seeded states -- P = 1, 2 and 4 slices,
    devex and Dantzig, each anti-cycling policy, taken and skipped pivots,
    the fuse, optimal and unbounded, Bland on and off, ranks with no
    eligible column and ties across ranks, and in every fourth state a
    NaN b, equal quotients on three rows 2,048 apart (other blocks of the
    ratio test's cluster) or no eligible row: every output bit for bit (each
    rank's pre and ratio; on each rank's slice K2 with its sharded tail
    and the pack into the send buffers against K2, ``step_post_plain``
    and ``sharded_pack_plain``, its costs and weights in turn seeded, NaN
    on a third of the columns and at column 0, all positive, h the most
    negative and first eligible, or tied across K2's blocks; each rank's
    boundary pack on drawn candidates, each rank's fold, with and without
    the next pivot's pre). Then six pivots of the window at P = 1, 2 and
    4 under devex and Dantzig two ways on the same tensors: K5 with its
    head and K2 with its sharded tail and pack, and their plain chains
    (``sharded_fold_plain`` and ``sharded_step_pre_plain`` then K5
    without its head; K2 without its tail then ``step_post_plain`` and
    ``sharded_pack_plain``), every scalar, column, vector and gathered
    buffer bit for bit after each pivot, and ``sharded_fold`` against its
    plain version at the end. Then each timed at one rank under devex on
    a taken pivot outside Bland mode: the kernels and their plain
    versions by torch.profiler, the kernels also over a CUDA graph of 50
    calls, K5 and K2 with and without their head and tails in turns (a
    head's or a tail's own cost is the carrier's time with it less
    without), beside the bounds (``SHARDED_STEP_BYTES``; sharded_ratio's
    column and b added). K5 with its head is also held and timed against
    its form before the redesign (``prior``, ``k5_head_edges`` and
    ``prior_turns``)."""
    import ctypes

    import numpy as np
    import torch

    from simplex_tpu_torch.kernels import blocked as kb

    dev = torch.device("cuda")
    M, R = Tt.shape
    eps, max_iter = 1e-4, 10
    rng = np.random.default_rng(20261017)
    unb_ah = -ah.abs()

    def clone(s):
        return kb.ShardedScalars(**{n: x.clone()
                                    for n, x in s.tensors().items()})

    # K2 with its sharded tail and pack against its plain chain on each
    # state's slices: Tt's slices, two copies of C's and of F (rows < t
    # the phase's; each K2 writes row t only), a workspace a way.
    tt_slices = {P: [Tt[:, r * (R // P):(r + 1) * (R // P)].contiguous()
                     for r in range(P)] for P in (1, 2, 4)}
    k2_C = {P: [[C[:, r * (R // P):(r + 1) * (R // P)].contiguous()
                 for r in range(P)] for _ in range(2)] for P in (1, 2, 4)}
    k2_F = [F.clone() for _ in range(2)]
    k2_ws = {P: [kb.colk_workspace(R // P, dev) for _ in range(2)]
             for P in (1, 2, 4)}
    k2_kinds = collections.Counter()

    def k2_pack(i, P, rank, s0, col, bb, devex, policy):
        R_loc = R // P
        off = rank * R_loc
        r_loc = R_loc - (100 if rank == P - 1 else 0)
        kind = ("seeded", "nan_weights", "no_eligible", "h_candidate",
                "tie")[i % 5]
        cs = costs[off:off + R_loc].clone()
        ww = w[off:off + R_loc].clone()
        hl = int(s0.h) - off
        if kind == "nan_weights":
            ww[torch.from_numpy(rng.random(R_loc) < 1 / 3).to(dev)] = (
                float("nan"))
            ww[0] = float("nan")
        elif kind == "no_eligible":
            cs = cs.abs() + 1e6
        elif kind == "h_candidate" and 0 <= hl < r_loc:
            cs[:hl] = cs[:hl].abs() + 1e6
            cs[hl] = -1e6
        elif kind == "tie":
            cs[[10, 3210]] = -1e5
            ww[[10, 3210]] = 2.0
        outs = []
        for chain in (0, 1):
            sc = clone(s0)
            v = dict(C=k2_C[P][chain][rank], F=k2_F[chain],
                     costs=cs.clone(), b=bb.clone(), base=base.clone(),
                     w=ww.clone() if devex else None)
            V = torch.full((5 if devex else 2,), -7.0, dtype=torch.float64,
                           device=dev)
            I = torch.full((2,), -7, dtype=torch.int32, device=dev)
            args = (tt_slices[P][rank], v["C"], v["F"], v["costs"])
            if chain == 0:
                kb.colk_costs_sharded_tail(
                    *args, t, r_loc, eps, col, v["b"], v["base"], v["w"], sc,
                    max_iter, k2_ws[P][0], offset=off,
                    bland_static=policy[0], threshold=policy[1], send_v=V,
                    send_i=I)
            else:
                kb.colk_costs(*args, sc.k, t, sc.u, sc.do, r_loc, eps, col,
                              v["b"], v["base"], sc.h, sc.p, sc.bk, v["w"],
                              k2_ws[P][1], out=(sc.h_d, sc.v_d, sc.h_b,
                                                sc.v_b),
                              offset=off, w_h=sc.wh if devex else None)
                kb.step_post_plain(sc, max_iter, eps, *policy, False)
                kb.sharded_pack_plain(sc, v["w"], off, V, I)
            outs.append((sc, v, V, I))
        (sa, va, Va, Ia), (sb, vb, Vb, Ib) = outs
        tag = f"K2 pack tail {policy} state {i} ({kind}) rank {rank}/{P}"
        equal(f"{tag} send_v", Va, Vb)
        equal(f"{tag} send_i", Ia, Ib)
        for name, x in sa.tensors().items():
            equal(f"{tag} {name}", x, getattr(sb, name))
        for name in ("costs", "w", "b", "base"):
            if va[name] is not None:
                equal(f"{tag} {name}", va[name], vb[name])
        equal(f"{tag} C[t]", va["C"][t], vb["C"][t])
        equal(f"{tag} F[t]", va["F"][t], vb["F"][t])
        if kind == "h_candidate" and 0 <= hl < r_loc:
            require(int(sa.h_d) == int(sa.h_b) == hl,
                    f"{tag}: candidates {int(sa.h_d)}, {int(sa.h_b)}, not "
                    f"h's column {hl}")
        k2_kinds[kind] += 1

    def edge_column(kind):
        col, bb = ah.clone(), b.clone()
        if kind == "nan":
            j = torch.from_numpy(rng.integers(0, M, 2)).to(dev)
            col[j], bb[j] = 0.5, float("nan")
        elif kind == "tie":
            j = int(rng.integers(0, M - 4096)) + torch.tensor(
                [0, 2048, 4096], device=dev)
            col[j], bb[j] = 4.0, 1e-9
        elif kind == "none":
            col = unb_ah
        return col, bb

    i, edges = 0, collections.Counter()
    for policy in ((False, 50), (False, None), (True, 50)):
        for devex in (True, False):
            for _ in range(32):
                P = (1, 2, 4)[i % 3]
                R_loc = R // P
                s0 = kb.sharded_scalars(torch.tensor(
                    rng.uniform(-5, 5), dtype=torch.float64, device=dev),
                    bool(rng.integers(2)))
                fills = dict(
                    status=int(kb.RUNNING) if rng.random() < 0.8
                    else int(kb.OPTIMAL),
                    iterations=int(rng.integers(8, 11)),
                    stall=int(rng.integers(47, 51)),
                    h_d=int(rng.integers(0, R)),
                    v_d=-1e-4 * rng.uniform(0.5, 3),
                    h_b=int(rng.choice([int(rng.integers(0, R)),
                                        kb.BIG_INDEX])),
                    v_b=-rng.uniform(0, 1), w_d=rng.uniform(1, 3),
                    w_b=rng.uniform(1, 3))
                for name, v in fills.items():
                    getattr(s0, name).fill_(v)
                kind = (("nan", "tie", "none")[i // 4 % 3] if i % 4 == 3
                        else None)
                col, bb = edge_column(kind) if kind else (
                    unb_ah if i % 5 == 0 else ah, b)
                edges[kind or "seeded"] += 1
                kv = 5 if devex else 2
                Vs = [torch.empty((P, kv), dtype=torch.float64, device=dev)
                      for _ in range(2)]
                Is = [torch.empty((P, 2), dtype=torch.int32, device=dev)
                      for _ in range(2)]
                ranks = []
                for rank in range(P):
                    where = dict(offset=rank * R_loc, R_loc=R_loc)
                    sk, sp = clone(s0), clone(s0)
                    kb.sharded_step_pre(sk, max_iter, eps, **where)
                    kb.sharded_step_pre_plain(sp, max_iter, eps, **where)
                    kb.sharded_ratio(sk, col, bb, eps)
                    kb.sharded_ratio_plain(sp, col, bb, eps)
                    for name, x in sk.tensors().items():
                        equal(f"sharded pre and ratio {policy} state {i} "
                              f"({kind}) rank {rank} {name}", x,
                              getattr(sp, name))
                    k2_pack(i, P, rank, sk, col, bb, devex, policy)
                    cand = (int(rng.integers(0, R_loc)),
                            -rng.uniform(0.1, 3),
                            int(rng.integers(0, R_loc)),
                            -rng.uniform(0.1, 3))
                    if rng.random() < 0.2:
                        cand = (0, float("inf"), kb.BIG_INDEX, float("inf"))
                    elif rng.random() < 0.2:
                        cand = (2, -1.5) + cand[2:]
                    for x in (sk, sp):
                        for name, v in zip(("h_d", "v_d", "h_b", "v_b"),
                                           cand):
                            getattr(x, name).fill_(v)
                    wr = w[rank * R_loc:(rank + 1) * R_loc] if devex else None
                    kb.sharded_pack(sk, wr, rank * R_loc, Vs[0][rank],
                                    Is[0][rank])
                    kb.sharded_pack_plain(sp, wr, rank * R_loc, Vs[1][rank],
                                          Is[1][rank])
                    ranks.append((sk, sp))
                equal(f"sharded_pack state {i} values", Vs[0], Vs[1])
                equal(f"sharded_pack state {i} indices", Is[0], Is[1])
                for rank, (sk, sp) in enumerate(ranks):
                    where = dict(offset=rank * R_loc, R_loc=R_loc)
                    kb.sharded_fold(sk, Vs[0], Is[0])
                    kb.sharded_fold_plain(sp, Vs[1], Is[1])
                    if i % 2:
                        kb.sharded_step_pre(sk, max_iter, eps, **where)
                        kb.sharded_step_pre_plain(sp, max_iter, eps,
                                                  **where)
                    for name, x in sk.tensors().items():
                        equal(f"sharded step kernels {policy} state {i} "
                              f"rank {rank} {name}", x, getattr(sp, name))
                i += 1
    log(f"sharded_step_pre, sharded_ratio (one cluster), K2 with its "
        f"sharded tail and pack, sharded_pack and sharded_fold: every output "
        f"equals its plain version's or chain's on {i} states at P = 1, 2 "
        f"and 4 ({dict(edges)}; K2's costs and weights {dict(k2_kinds)})")
    del tt_slices, k2_C, k2_F, k2_ws

    # Six pivots of the window, kernels with their head and tail against
    # the plain chains, on the same tensors.
    pivots = 6
    for devex in (True, False):
        for P in (1, 2, 4):
            R_loc = R // P
            slices = [Tt[:, r * R_loc:(r + 1) * R_loc].contiguous()
                      for r in range(P)]
            s0 = kb.sharded_scalars(torch.tensor(
                rng.uniform(-5, 5), dtype=torch.float64, device=dev),
                False)
            for name, v in dict(h_d=int(rng.integers(0, R)), v_d=-1.0,
                                h_b=kb.BIG_INDEX, iterations=3,
                                w_d=1.5).items():
                getattr(s0, name).fill_(v)
            runs = []
            for _ in range(2):
                ranks = []
                for r in range(P):
                    cols = slice(r * R_loc, (r + 1) * R_loc)
                    x = dict(s=clone(s0), Tt=slices[r],
                             C=C[:, cols].contiguous(), F=F.clone(),
                             costs=costs[cols].clone(), b=b.clone(),
                             base=base.clone(),
                             w=w[cols].clone() if devex else None,
                             ah=torch.empty(M, device=dev),
                             ws=kb.colk_workspace(R_loc, dev),
                             where=dict(offset=r * R_loc, R_loc=R_loc))
                    kb.sharded_step_pre_plain(x["s"], max_iter, eps,
                                              **x["where"])
                    ranks.append(x)
                kv = 5 if devex else 2
                runs.append((ranks, torch.empty((P, kv), dtype=torch.float64,
                                                device=dev),
                             torch.empty((P, 2), dtype=torch.int32,
                                         device=dev)))
            for tp in range(t, t + pivots):
                for chain, (ranks, V, I) in enumerate(runs):
                    for x in ranks:
                        s = x["s"]
                        if tp > t and chain == 0:
                            kb.ah_fold_head(x["Tt"], x["F"], x["C"], tp, s,
                                            V, I, max_iter, eps,
                                            x["where"]["offset"],
                                            out=x["ah"])
                            continue
                        if tp > t:
                            kb.sharded_fold_plain(s, V, I)
                            kb.sharded_step_pre_plain(s, max_iter, eps,
                                                      **x["where"])
                        kb.ah(x["Tt"], x["F"], x["C"], s.hl, tp, own=s.own,
                              out=x["ah"])
                    col = sum(x["ah"] for x in ranks)
                    for r, x in enumerate(ranks):
                        s = x["s"]
                        x["ah"].copy_(col)
                        kb.sharded_ratio_plain(s, x["ah"], x["b"], eps)
                        args = (x["Tt"], x["C"], x["F"], x["costs"])
                        r_loc = R_loc - (100 if r == P - 1 else 0)
                        if chain == 0:
                            kb.colk_costs_sharded_tail(
                                *args, tp, r_loc, eps, x["ah"], x["b"],
                                x["base"], x["w"], s, max_iter, x["ws"],
                                offset=x["where"]["offset"],
                                bland_static=False, threshold=50,
                                send_v=V[r], send_i=I[r])
                        else:
                            kb.colk_costs(
                                *args, s.k, tp, s.u, s.do, r_loc, eps,
                                x["ah"], x["b"], x["base"], s.h, s.p, s.bk,
                                x["w"], x["ws"],
                                out=(s.h_d, s.v_d, s.h_b, s.v_b),
                                offset=x["where"]["offset"],
                                w_h=None if x["w"] is None else s.wh)
                            kb.step_post_plain(s, max_iter, eps, False, 50,
                                               False)
                            kb.sharded_pack_plain(
                                s, x["w"], x["where"]["offset"], V[r], I[r])
                tag = f"sharded window devex={devex} P={P} t={tp}"
                equal(f"{tag} gathered values", runs[0][1], runs[1][1])
                equal(f"{tag} gathered indices", runs[0][2], runs[1][2])
                for r, (a, b2) in enumerate(zip(runs[0][0], runs[1][0])):
                    for name, x in a["s"].tensors().items():
                        equal(f"{tag} rank {r} {name}", x,
                              getattr(b2["s"], name))
                    for name in ("ah", "C", "F", "costs", "w", "b", "base"):
                        if a[name] is not None:
                            equal(f"{tag} rank {r} {name}", a[name],
                                  b2[name])
            require(int(runs[0][0][0]["s"].iterations) > 3,
                    f"the sharded window devex={devex} P={P} took no pivot")
            for chain, (ranks, V, I) in enumerate(runs):
                for x in ranks:
                    (kb.sharded_fold if chain == 0 else
                     kb.sharded_fold_plain)(x["s"], V, I)
            for r, (a, b2) in enumerate(zip(runs[0][0], runs[1][0])):
                for name, x in a["s"].tensors().items():
                    equal(f"sharded_fold devex={devex} P={P} rank {r} "
                          f"{name}", x, getattr(b2["s"], name))
            del runs, slices
    log(f"K5 with its head and K2 with its sharded tail and pack: every "
        f"scalar, column, vector and gathered buffer equals the plain "
        f"chains' after each of {pivots} pivots at P = 1, 2 and 4, devex "
        "and Dantzig; sharded_fold equals its plain version after them")

    # A taken pivot outside Bland mode under devex at one rank.
    s = kb.sharded_scalars(torch.zeros((), dtype=torch.float64,
                                       device=dev), False)
    s.h_b.fill_(kb.BIG_INDEX)
    s.v_d.fill_(-1.0)
    s.h_d.fill_(12345)
    vals = torch.empty(5, dtype=torch.float64, device=dev)
    idx = torch.empty(2, dtype=torch.int32, device=dev)
    big = 2 ** 30
    v = dict(C=C.clone(), F=F.clone(), costs=costs.clone(), b=b.clone(),
             base=base.clone(), w=w.clone())
    col = torch.empty(M, device=dev)
    ws2 = kb.colk_workspace(R, dev)
    kb.sharded_step_pre(s, big, eps, 0, R)
    kb.ah(Tt, v["F"], v["C"], s.hl, t, own=s.own, out=col)
    kb.sharded_ratio(s, col, v["b"], eps)
    require(bool(s.do), "the timed sharded pivot is not taken")
    kb.sharded_pack(s, w, 0, vals, idx)
    V, I = vals.view(1, 5), idx.view(1, 2)
    k2 = (Tt, v["C"], v["F"], v["costs"])
    n = k5_head_edges(prior, Tt, v["F"], v["C"], eps)
    log(f"K5 with its head: every scalar and the column equal the plain "
        f"chain's and the form's before its redesign on {n} states (P = 1, "
        f"3, 8 and 33; {', '.join(FOLD_EDGES)}; kv 2 and 5, the Bland flag "
        "off and on, t = 0 and 37)")
    lib = prior.load()

    def head_before():
        err = lib.prior_ah_head_launch(
            Tt.data_ptr(), v["F"].data_ptr(), v["C"].data_ptr(), t, M, R,
            col.data_ptr(), ctypes.byref(kb._shard_step_ptrs(s)),
            V.data_ptr(), I.data_ptr(), *V.shape, big, eps, 0,
            torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the earlier K5 with its head failed ({err})")

    def head():
        kb.ah_fold_head(Tt, v["F"], v["C"], t, s, V, I, big, eps, 0,
                        out=col)

    head_turn = prior_turns(
        f"f32 M={M} R={R} t={t} (one rank)",
        lambda: {**s.tensors(), "ah": col},
        {"K5 with its head": (head_before, head, K5_HEAD_WRITES)},
        {"K5 with its head": (head_before, head)})["K5 with its head"]
    timed = {
        "K5": (lambda: kb.ah(Tt, v["F"], v["C"], s.hl, t, own=s.own,
                             out=col), "ah_ratio_fused"),
        "K5+head": (head, "ah_ratio_fused"),
        "K5+head before": (head_before, "ah_ratio_fused"),
        "K2": (lambda: kb.colk_costs(
            *k2, s.k, t, s.u, s.do, R - 100, eps, col, v["b"], v["base"],
            s.h, s.p, s.bk, v["w"], ws2, out=(s.h_d, s.v_d, s.h_b, s.v_b),
            offset=0, w_h=s.wh), "colk_costs_fused"),
        "K2+tail": (lambda: kb.colk_costs_sharded_tail(
            *k2, t, R - 100, eps, col, v["b"], v["base"], v["w"], s, big,
            ws2, offset=0, bland_static=False, threshold=50),
            "colk_costs_fused"),
        "K2+tail+pack": (lambda: kb.colk_costs_sharded_tail(
            *k2, t, R - 100, eps, col, v["b"], v["base"], v["w"], s, big,
            ws2, offset=0, bland_static=False, threshold=50, send_v=vals,
            send_i=idx), "colk_costs_fused"),
    }
    for name in ("K5+head", "K2+tail", "K2+tail+pack"):
        n = kernels_launched(timed[name][0])
        require(n == 1, f"one {name} call launched {n} kernels")
    prof = {name: [] for name in timed}
    graph = {name: [] for name in timed}
    for name in ("K5", "K5+head before", "K5+head", "K2", "K2+tail",
                 "K2+tail+pack", "K2+tail+pack", "K2+tail", "K2", "K5+head",
                 "K5+head before", "K5"):
        fn, match = timed[name]
        prof[name].append(device_ms(fn, 50, match=match))
        graph[name].append(graph_ms(fn))
    mean = statistics.mean
    log("sharded K5 and K2 with and without their head and tails, ms a "
        "call in turns (K5, K5+head before its redesign, K5+head, K2, "
        "K2+tail, K2+tail+pack, then back): "
        + "; ".join(
            f"{name} " + ", ".join(f"{x:.5f}" for x in prof[name])
            + " (torch.profiler), " + ", ".join(f"{x:.5f}"
                                                 for x in graph[name])
            + " (CUDA graph of 50 calls)" for name in timed))
    # The timed calls moved the state: one clean pivot again for the rest.
    kb.sharded_pack(s, w, 0, vals, idx)
    calls = {
        "sharded_step_pre": (
            lambda: kb.sharded_step_pre(s, big, eps, 0, R),
            lambda: kb.sharded_step_pre_plain(s, big, eps, 0, R)),
        "sharded_ratio": (
            lambda: kb.sharded_ratio(s, ah, b, eps),
            lambda: kb.sharded_ratio_plain(s, ah, b, eps)),
        "sharded_pack": (
            lambda: kb.sharded_pack(s, w, 0, vals, idx),
            lambda: kb.sharded_pack_plain(s, w, 0, vals, idx)),
        "sharded_fold": (
            lambda: kb.sharded_fold(s, V, I),
            lambda: kb.sharded_fold_plain(s, V, I)),
        "sharded_post_tail": (None, lambda: kb.step_post_plain(
            s, big, eps, False, 50, False)),
        "sharded_pack_tail": (None, lambda: kb.sharded_pack_plain(
            s, w, 0, vals, idx)),
        "sharded_fold_head": (None, lambda: (
            kb.sharded_fold_plain(s, V, I),
            kb.sharded_step_pre_plain(s, big, eps, 0, R))),
    }
    # Each head or tail: its carrier with it, and without.
    carrier = {"sharded_post_tail": ("K2+tail", "K2"),
               "sharded_pack_tail": ("K2+tail+pack", "K2+tail"),
               "sharded_fold_head": ("K5+head", "K5")}
    for name, (kernel, plain) in calls.items():
        if kernel is not None:
            ms = device_ms(kernel, 50, match=name)
            check_ms = graph_ms(kernel)
        else:
            with_it, without = carrier[name]
            ms = mean(prof[with_it]) - mean(prof[without])
            check_ms = mean(graph[with_it]) - mean(graph[without])
        nbytes = SHARDED_STEP_BYTES[name] + (12 * M if name ==
                                             "sharded_ratio" else 0)
        bound_ms, by = bound(nbytes, 0.0, M if name == "sharded_ratio"
                             else 0.0)
        records[name] = {"max_abs_err": 0.0, "ms": ms,
                         "plain_ms": device_ms(plain, 50),
                         "bound_ms": bound_ms, "bound_by": by,
                         "library_ms": None, "check_ms": check_ms}
        log(f"{name}: {ms:.5f} ms a call"
            + ("" if kernel is not None else
               f" ({carrier[name][0]} less {carrier[name][1]}, "
               "torch.profiler)")
            + f", {check_ms:.5f} ms by CUDA events over a CUDA graph of 50 "
            f"calls, plain {records[name]['plain_ms']:.4f} ms, bound "
            f"{bound_ms:.2e} ms ({by})")
    # The head's own cost before its redesign, from the same turns.
    rec = records["sharded_fold_head"]
    rec.update(own_before_ms=mean(prof["K5+head before"]) - mean(prof["K5"]),
               own_before_check_ms=(mean(graph["K5+head before"])
                                    - mean(graph["K5"])), **head_turn)
    log(f"sharded_fold_head before its redesign: {rec['own_before_ms']:.5f} "
        f"ms a call (K5+head before less K5, torch.profiler), "
        f"{rec['own_before_check_ms']:.5f} ms by CUDA events over CUDA "
        "graphs; "
        f"K5 with its head {1e3 * head_turn['turn_ms']:.3f} us against "
        f"{1e3 * head_turn['before_ms']:.3f} before, in turns")


def k2_slice(tag, Tt, C, F, costs, k, u, do, eps, ah, b, base, h, p, bk, w,
             ws) -> None:
    """K2 on the second of two slices of the flagship's columns (offset
    R / 2, h = 12,345 on it, the weight at h given as the fold carries
    it) against its plain version with the same arguments at t = 0, where
    no eta row sums: every output bit for bit."""
    import torch

    from simplex_tpu_torch.kernels import blocked as kb

    R = Tt.shape[1]
    half = slice(R // 2, R)
    w_h = None if w is None else w[h.long()].clone()
    Ts = Tt[:, half].contiguous()
    outs = []
    for fn in (functools.partial(kb.colk_costs, ws=ws), kb.colk_costs_plain):
        st = dict(C=C[:, half].contiguous(), F=F.clone(),
                  costs=costs[half].clone(), b=b.clone(), base=base.clone(),
                  w=None if w is None else w[half].clone())
        cand = fn(Ts, st["C"], st["F"], st["costs"], k, 0, u, do,
                  R // 2 - 100, eps, ah, st["b"], st["base"], h, p, bk,
                  st["w"], offset=R // 2, w_h=w_h)
        outs.append((st, cand))
    (sk, ck), (sp, cp) = outs
    for name in sk:
        if sk[name] is not None:
            equal(f"{tag} slice {name}", sk[name], sp[name])
    for a, b2 in zip(ck, cp):
        equal(f"{tag} slice candidates", a, b2)
    del Ts


def k4_vs_k3_small(g) -> None:
    """K4 against K3's apply bit for bit, and K3's mv against K11 on K3's
    output bit for bit, at a shape with an odd number of R tiles and the
    shortest window (M=256, R=384, L=8)."""
    import torch

    from simplex_tpu_torch.kernels import blocked as kb

    M, R, L = 256, 384, 8
    dev = torch.device("cuda")
    Tt = torch.rand((M, R), generator=g, device=dev) * 2 - 1
    C = torch.rand((L, R), generator=g, device=dev) * 2 - 1
    F = torch.rand((L, M), generator=g, device=dev) * 0.2 - 0.1
    coeffs = torch.rand((M,), generator=g, device=dev, dtype=torch.float64)
    T3, T4 = Tt.clone(), Tt.clone()
    mv = kb.apply_reprice(T3, C, F, coeffs)
    kb.apply_window(T4, C, F)
    equal(f"K4 Tt vs K3's apply (M={M} R={R} L={L})", T4, T3)
    equal(f"K3 mv vs K11 on K3's output (M={M} R={R} L={L})", mv,
          kb.reprice(T3, coeffs))
    require(not torch.equal(T4, Tt), "K4 left Tt as it was")


WINDOW_ARGS = ("costs", "b", "z", "base", "w", "sci", "c0", "cf", "C", "F",
               "AH", "piv", "nlive")


def window_state(B: int, M: int, R: int, L: int, devex: bool, g):
    """A seeded window state on the card: Tt (B*M, R) uniform in (-1, 1),
    costs uniform in (-1, 0.5) (many eligible columns), b in (0.1, 1),
    distinct basic columns; lane 1 frozen (OPTIMAL), lane 2 with its fuse
    5 pivots away, every other lane RUNNING with room for L pivots."""
    import torch

    from simplex_tpu_torch.config import Status

    dev = torch.device("cuda")

    def uni(shape, lo, hi, dtype=torch.float64):
        x = torch.rand(shape, generator=g, device=dev, dtype=dtype)
        return x * (hi - lo) + lo

    r = R - 5
    Tt = uni((B * M, R), -1.0, 1.0, torch.float32)
    base = torch.argsort(torch.rand((B, R), generator=g, device=dev),
                         dim=1)[:, :M].to(torch.int32)
    c0 = uni((B, R), -1.0, 1.0)
    picked = c0.gather(1, base.long())
    sci = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    sci[:, 0] = int(Status.RUNNING)
    sci[1, 0] = int(Status.OPTIMAL)
    sci[:, 5] = 10 ** 6
    sci[2, 5] = 5
    sci[:, 4] = (sci[:, 0] == int(Status.RUNNING)).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    st = dict(costs=uni((B, R), -1.0, 0.5), b=uni((B, M), 0.1, 1.0),
              z=uni((B,), -1.0, 1.0), base=base,
              w=uni((B, R), 1.0, 2.0, torch.float32) if devex else None,
              sci=sci, c0=c0,
              cf=torch.where(base < r, picked, torch.zeros_like(picked)),
              C=torch.empty((B * L, R), **f32),
              F=torch.empty((B * L, M), **f32),
              AH=torch.empty((B * L, M), **f32),
              piv=torch.empty((B * L, 2), dtype=torch.int32, device=dev),
              nlive=torch.empty(B, dtype=torch.int32, device=dev))
    return Tt, st, r


def window_against_replay(tag: str, Tt, st0: dict, sk: dict, B: int,
                          L: int) -> float:
    """A window's outputs against its formulas on its own f32 operands
    (``window_replay``): the pivot rows C and entering columns AH to
    1e-5 of their terms' summed magnitudes (the f32 eta correction, t
    products, in another order than the f64 replay); the eta rows F and
    the devex weights to 1e-6 * (1 + |x|) (the same f32 operations on
    the same operands); the f64 vectors to 1e-12 * (1 + |x|); base and
    cf equal. Returns the max abs error."""
    from simplex_tpu_torch.kernels import batched as kbt

    rep = kbt.window_replay(Tt, st0, sk["C"], sk["F"], sk["AH"], sk["piv"],
                            sk["nlive"])
    e = 0.0
    for name in ("C", "AH"):
        got = sk[name].view(B, L, -1)
        e = max(e, close(f"{tag} {name}", got, rep[name],
                         1e-5 * (1 + rep[name + "_terms"])))
    e = max(e, close(f"{tag} F", sk["F"].view(B, L, -1), rep["F"],
                     1e-6 * (1 + rep["F"].abs())))
    names = ("costs", "b", "z") + (("w",) if sk["w"] is not None else ())
    for name in names:
        tol = (1e-6 if name == "w" else 1e-12) * (1 + rep[name].abs())
        e = max(e, close(f"{tag} {name}", sk[name], rep[name], tol))
    equal(f"{tag} replayed base", sk["base"], rep["base"])
    equal(f"{tag} replayed cf", sk["cf"], rep["cf"])
    return e


def phase_batch_kernels(records: dict) -> None:
    """The batched kernels against their plain versions on the card, on
    the same state: the integer outputs (the walk piv, base, sci, nlive)
    equal, and each output against its formula on the kernel's own
    operands (window_against_replay) -- the plain version's f32 rows
    drift from the kernel's along the walk, since each row builds on the
    earlier ones. The apply: Tt to 1e-5 * (1 + |x| + |F|^T |C|) of the
    plain version on the same etas (another summation order of L
    products), the reprice mv to 1e-12 relative of cf @ Tt_new in f64
    on the kernel's own tableau -- an f32 accumulation would miss by
    ~1e-7 -- and a frozen lane's tableau bit-identical. Times at config
    3's shapes go into the kernels' records; the wide shape's are
    printed."""
    import torch

    from simplex_tpu_torch.kernels import batched as kbt
    from simplex_tpu_torch.tableau import batch_tt_matvec

    g = torch.Generator(device="cuda").manual_seed(20261017)
    errs = {name: 0.0 for name in BATCH_PATH}
    for label, (B, M, R, L) in BATCH_KERNEL_SHAPES:
        times = {}
        for devex in (True, False):
            rule = "devex" if devex else "dantzig"
            tag = f"{label} {rule}"
            Tt, st0, r = window_state(B, M, R, L, devex, g)
            kw = dict(r=r, eps=1e-5, bland_static=False, threshold=50)
            runs = []
            for fn in (kbt.batch_window, kbt.batch_window_plain):
                st = {k: None if v is None else v.clone()
                      for k, v in st0.items()}
                fn(Tt, *(st[k] for k in WINDOW_ARGS), **kw)
                runs.append(st)
            sk, sp = runs
            for name in ("piv", "base", "sci", "nlive"):
                equal(f"batch_window {tag} {name}", sk[name], sp[name])
            nlive = sk["nlive"].tolist()
            require(nlive[1] == 0 and nlive[2] == 5 and nlive[0] == L,
                    f"batch_window {tag}: nlive {nlive[:3]}")
            e = window_against_replay(f"batch_window {tag}", Tt, st0, sk,
                                      B, L)
            errs["batch_window"] = max(errs["batch_window"], e)

            # K9 / K10 on the kernel's etas; lane 3 does not re-price.
            do_r = torch.ones(B, dtype=torch.int32, device="cuda")
            do_r[3] = 0
            frozen = slice(M, 2 * M)
            Tk, Tp = Tt.clone(), Tt.clone()
            mv = kbt.batch_apply_reprice(Tk, sk["C"], sk["F"], sk["cf"],
                                         do_r, sk["nlive"])
            kbt.batch_apply_reprice_plain(Tp, sk["C"], sk["F"], sk["cf"],
                                          do_r, sk["nlive"])
            terms = torch.bmm(sk["F"].view(B, L, M).abs().transpose(1, 2),
                              sk["C"].view(B, L, R).abs()).view(B * M, R)
            e = close(f"batch_apply_reprice {tag} Tt", Tk, Tp,
                      1e-5 * (1 + Tp.abs() + terms))
            require(torch.equal(Tk[frozen], Tt[frozen]),
                    f"batch_apply_reprice {tag}: the frozen lane changed")
            T3 = Tk.view(B, M, R)
            scale = batch_tt_matvec(T3.abs(), sk["cf"].abs())
            want_mv = torch.where(do_r[:, None] != 0,
                                  batch_tt_matvec(T3, sk["cf"]), 0.0)
            e = max(e, close(f"batch_apply_reprice {tag} mv", mv, want_mv,
                             1e-12 * scale))
            require(not mv[3].any(), "batch_apply_reprice: do_r=0 lane")
            errs["batch_apply_reprice"] = max(errs["batch_apply_reprice"], e)
            del Tp
            Tk.copy_(Tt)
            Tp = Tt.clone()
            kbt.batch_apply(Tk, sk["C"], sk["F"], sk["nlive"])
            kbt.batch_apply_plain(Tp, sk["C"], sk["F"], sk["nlive"])
            errs["batch_apply"] = max(errs["batch_apply"], close(
                f"batch_apply {tag} Tt", Tk, Tp,
                1e-5 * (1 + Tp.abs() + terms)))
            require(torch.equal(Tk[frozen], Tt[frozen]),
                    f"batch_apply {tag}: the frozen lane changed")
            del Tp, terms
            if devex:
                # Each timed call starts from the same state (the copies
                # that reset it are left out of the kernel's time).
                st = {k: None if v is None else v.clone()
                      for k, v in st0.items()}

                def window(fn, st=st):
                    for k in ("costs", "b", "z", "base", "w", "sci", "cf"):
                        st[k].copy_(st0[k])
                    fn(Tt, *(st[k] for k in WINDOW_ARGS), **kw)

                # One kernel a call: one launch of B clusters.
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                plan = kbt.window_plan(B, M, R, L, True, sms)
                n = kernels_launched(lambda: window(kbt.batch_window),
                                     "batch_window")
                require(n == 1, f"one batch_window call launched {n} "
                        "kernels")
                log(f"batch_window {label}: one kernel a call, {plan}")
                C, F, cf, nl = sk["C"], sk["F"], sk["cf"], sk["nlive"]
                times = {
                    "batch_window": [
                        device_ms(lambda: window(kbt.batch_window), 5,
                                  "batch_window"),
                        device_ms(lambda: window(kbt.batch_window_plain),
                                  2)],
                    "batch_apply_reprice": [
                        device_ms(lambda: kbt.batch_apply_reprice(
                            Tk, C, F, cf, do_r, nl), 5),
                        device_ms(lambda: kbt.batch_apply_reprice_plain(
                            Tk, C, F, cf, do_r, nl), 5)],
                    "batch_apply": [
                        device_ms(lambda: kbt.batch_apply(Tk, C, F, nl), 5),
                        device_ms(lambda: kbt.batch_apply_plain(Tk, C, F,
                                                                nl), 5)]}
                # CUDA events over back-to-back calls (batch_window's
                # with the copies that reset its state).
                checks = {
                    "batch_window": event_ms(
                        lambda: window(kbt.batch_window), 5),
                    "batch_apply_reprice": event_ms(
                        lambda: kbt.batch_apply_reprice(Tk, C, F, cf, do_r,
                                                        nl), 5),
                    "batch_apply": event_ms(
                        lambda: kbt.batch_apply(Tk, C, F, nl), 5)}
                # Bounds on this state: each lane reads a column and a row
                # of its tableau per live pivot and writes its eta rows;
                # the applies move the tableaus of the lanes with live
                # rows; the operations are the eta corrections (f32), the
                # vector updates and the re-pricing fold (f64).
                nls = [int(v) for v in nl.tolist()]
                live = sum(1 for v in nls if v)
                reprice = sum(1 for v, d in zip(nls, do_r.tolist()) if d)
                vec = B * (16 * R + 16 * M + 8 * M + 8 * R + 8 * R + 16 * M)
                etas = 4 * B * L * (M + R)
                bnds = {
                    "batch_window": bound(
                        sum(4 * v * (M + R) for v in nls) + etas
                        + 4 * B * L * M + vec,
                        sum(v * (v - 1) * (M + R) for v in nls),
                        sum(v * (4 * R + 3 * M) for v in nls)),
                    "batch_apply_reprice": bound(
                        live * 8 * M * R + etas + 8 * B * (M + R),
                        sum(2 * v * M * R for v in nls),
                        reprice * 2 * M * R),
                    "batch_apply": bound(live * 8 * M * R + etas,
                                         sum(2 * v * M * R for v in nls))}
            del Tk, Tt, st0, sk, sp
            torch.cuda.empty_cache()
        for name in BATCH_PATH:
            kid = BATCH_KERNELS[name][0]
            ms, plain_ms = times[name]
            bound_ms, by = bnds[name]
            if label == BATCH_KERNEL_SHAPES[0][0]:
                # batch_apply's plain version is one PyTorch call (cuBLAS
                # baddbmm_): its time is also the library's.
                records[name] = {
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by,
                    "library_ms": plain_ms if name == "batch_apply"
                    else None, "check_ms": checks[name]}
            log(f"{kid} {name} {label} B={B} M={M} R={R} L={L}: matches "
                f"plain (max abs err so far {errs[name]:.3e}); kernel "
                f"{ms:.4f} ms (CUDA events {checks[name]:.4f}), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    for name in BATCH_PATH:
        records[name]["max_abs_err"] = errs[name]


def phase_batch_reprice(records: dict) -> None:
    """K12 against its plain version at config 3's shapes (B=256, M=512,
    R=3072), lane 3 unflagged: mv to 1e-12 of sum |cf * Tt| of the f64
    formula on the same f32 tableau (an f32 accumulation would miss by
    ~1e-7), lane 3 zero, and equal bit for bit to ``batch_apply_reprice``
    with no live eta row (the same fold); timed beside its bound, its
    plain version and ``torch.bmm`` in f64 (the cast included)."""
    import torch

    from simplex_tpu_torch.kernels import batched as kbt
    from simplex_tpu_torch.tableau import batch_tt_matvec

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261019)
    B, M, R = 256, 512, 3072
    Tt = torch.rand((B * M, R), generator=g, device=dev) * 2.0 - 1.0
    cf = torch.rand((B, M), generator=g, device=dev, dtype=torch.float64)
    flags = torch.ones(B, dtype=torch.int32, device=dev)
    flags[3] = 0
    T3 = Tt.view(B, M, R)
    mv = kbt.batch_reprice(Tt, cf, flags)
    want = torch.where(flags[:, None] != 0, batch_tt_matvec(T3, cf), 0.0)
    err = close("K12 mv", mv, want, 1e-12 * batch_tt_matvec(T3.abs(),
                                                            cf.abs()))
    require(not mv[3].any(), "K12: the unflagged lane is not zero")
    zC = torch.zeros((B * 32, R), device=dev)
    zF = torch.zeros((B * 32, M), device=dev)
    nlive = torch.zeros(B, dtype=torch.int32, device=dev)
    T0 = Tt.clone()
    equal("K12 mv vs batch_apply_reprice's fold", mv,
          kbt.batch_apply_reprice(T0, zC, zF, cf, flags, nlive))
    del T0, zC, zF
    ms = device_ms(lambda: kbt.batch_reprice(Tt, cf, flags), 10)
    ev_ms = event_ms(lambda: kbt.batch_reprice(Tt, cf, flags), 10)
    plain_ms = device_ms(lambda: kbt.batch_reprice_plain(Tt, cf, flags), 5)
    library_ms = device_ms(lambda: torch.bmm(cf[:, None, :], T3.double()),
                           5)
    live = int(flags.sum())
    bound_ms, by = bound(4 * live * M * R + 8 * B * M + 4 * B + 8 * B * R,
                         0, 2 * live * M * R)
    records["batch_reprice"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
        "check_ms": ev_ms}
    log(f"K12 batch_reprice B={B} M={M} R={R}: matches plain (max abs err "
        f"{err:.3e}), equals batch_apply_reprice's fold; kernel {ms:.4f} "
        f"ms (CUDA events {ev_ms:.4f}), plain {plain_ms:.4f} ms, bmm f64 "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    del Tt, T3
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 3-5: solves through the public entry point.

def phase_batch_trace() -> None:
    """One config-3 ``solve_batch`` under torch.profiler (CUDA activity):
    the device time by kernel, and the device's busy share of the traced
    device solve (stats ``device_s``) and of the whole call. Runs after
    every timed solve."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import simplex_tpu_torch as st

    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    stats: dict = {}

    def run():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = timed_batch(problems, stats)
        return prof, out

    prof, (_, wall) = until_traced(run, "config 3's trace")
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    copy_s = sum(r[0] for r in rows if r[2].startswith("Memcpy")) / 1e6
    kernel_s = sum(r[0] for r in rows) / 1e6 - copy_s
    require(kernel_s > 0, "the trace saw no kernel time")
    log(f"config 3 traced: wall {wall:.3f} s (data to the card "
        f"{stats['prepare_s']:.3f} s, device solve {stats['device_s']:.3f}"
        f" s, host refinement {stats['refine_s']:.3f} s); kernels busy "
        f"{kernel_s:.3f} s = {100 * kernel_s / stats['device_s']:.1f}% of "
        f"the device solve ({sum(r[1] for r in rows)} launches and "
        f"copies); copies {copy_s:.3f} s")
    for us, count, key in rows[:8]:
        log(f"  {us / 1e3:10.3f} ms {count:6d} x {key[:90]}")


def timed_solve(problem, opts: dict = PROD):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve(problem, device="cuda", **opts)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_goldens(opts: dict, label: str) -> None:
    import numpy as np

    import simplex_tpu_torch as st

    res, _ = timed_solve(st.read_problem(DATA / "smallProblem.txt"), opts)
    require(res.status == st.Status.OPTIMAL
            and abs(res.objective - 64.0) < 1e-9
            and np.allclose(res.x, [8.0, 0.0, 0.0], atol=1e-9),
            f"{label} smallProblem: {res.status!r} {res.objective} {res.x}")
    res, _ = timed_solve(st.read_problem(DATA / "infeasibleProblem.txt"),
                         opts)
    require(res.status == st.Status.INFEASIBLE,
            f"{label} infeasibleProblem: {res.status!r}")
    res, _ = timed_solve(st.read_problem(DATA / "unboundedProblem.txt"),
                         opts)
    require(res.status == st.Status.UNBOUNDED,
            f"{label} unboundedProblem: {res.status!r}")
    log(f"goldens ({label}): smallProblem OPTIMAL 64 at (8,0,0), "
        "infeasibleProblem INFEASIBLE, unboundedProblem UNBOUNDED")


def check_objective(label: str, res, want: float, rel_tol: float) -> None:
    import numpy as np

    import simplex_tpu_torch as st

    require(res.status == st.Status.OPTIMAL, f"{label}: {res.status!r}")
    rel = abs(res.objective - want) / abs(want)
    require(rel <= rel_tol, f"{label}: objective {res.objective!r} vs "
            f"{want!r} (rel {rel:.2e} > {rel_tol:g})")
    require(np.isfinite(res.x).all() and res.x.shape[0] > 0,
            f"{label}: bad x")


def check_certified(label: str, res, want: float) -> None:
    check_objective(label, res, want, 1e-9)
    require(res.refine is not None and res.refine.certified,
            f"{label}: not certified ({res.refine})")


@functools.lru_cache(maxsize=None)
def benchmark_problem(n: int):
    """random_n_n, regenerated from its seed file once per run."""
    import simplex_tpu_torch as st

    t0 = time.perf_counter()
    p = st.read_random_problem(DATA / "benchmark_problems"
                               / f"random_{n}_{n}.txt")
    log(f"random_{n}_{n} regenerated in {time.perf_counter() - t0:.1f} s")
    return p


def recorded_walks(n: int) -> tuple[str, str]:
    """The pivot counts of random_n_n as recorded by the JAX package on a
    TPU (data/measures/v5e_f64, its solveIterations rows) and by the
    reference CUDA program (data/reference_measures, one solve row per
    step, each phase's exit step included)."""
    def rows(path):
        return [line.split(",") for line in
                path.read_text().splitlines()[1:] if line.strip()]

    tpu = rows(ROOT / "data" / "measures" / "v5e_f64"
               / f"benchmark_{n}_{n}.txt")
    ref = rows(ROOT / "data" / "reference_measures"
               / f"benchmark_{n}_{n}.txt")
    ref_walk = [sum(r[2] == "solve" and int(r[0]) == v for r in ref) - 1
                for v in (3 * n + 1, 2 * n + 1)]
    return ("+".join(str(int(float(r[3]))) for r in tpu
                     if r[2] == "solveIterations"),
            "+".join(str(v) for v in ref_walk))


def seq_nodes() -> int:
    """The nodes of a chunk's graph: ``seq_step_pre``, then per pivot
    ``seq_ratio_colk`` (``seq_ratio`` with ``seq_colk`` as its tail) and
    ``seq_rank1`` -- or ``seq_ratio_snapshot`` (``seq_ratio`` with
    ``seq_snapshot`` as its tail) and K6 (its fold and the step after,
    ``seq_k6_tail``, the tail of its last tile block)."""
    from simplex_tpu_torch.solver import SEQ_CHUNK

    return 2 * SEQ_CHUNK + 1


def drive(body, state, max_iter: int):
    """Run ``body`` (a ``solver.LoopState`` pivot) until the loop exits,
    reading status and iterations once a chunk of at most ``SEQ_CHUNK``
    pivots (never past the fuse): the old eager loops' driver. Returns
    (state, status, iterations)."""
    import torch

    from simplex_tpu_torch import solver

    st, it = solver.RUNNING, 0
    while st == solver.RUNNING and it < max_iter:
        for _ in range(min(solver.SEQ_CHUNK, max_iter - it)):
            state = body(state)
        st, it = (int(v) for v in
                  torch.stack([state.status, state.iterations]).tolist())
    return state, st, it


def old_solve_loop(tab, options, max_iter):
    """The f64 sequential loop as it ran before its chunk's graph:
    ``iteration_body`` (about 40 torch calls a pivot) driven by
    ``drive``, one host read a chunk."""
    from simplex_tpu_torch import solver

    state, st, it = drive(
        lambda s: solver.iteration_body(s, options, max_iter),
        solver.initial_state(tab, options), max_iter)
    return state.tab, st, it


def old_solve_loop_sharded(tab, shard, options, max_iter):
    """The sequential sharded loop as it ran before its chunk's graph:
    ``iteration_body_sharded`` (about 40 torch calls and three allocating
    collectives a pivot) driven by ``drive``."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.parallel import sharded as ps

    state, st, it = drive(
        lambda s: ps.iteration_body_sharded(s, shard, options, max_iter),
        solver.initial_state(tab, options), max_iter)
    return state.tab, st, it


def seq_loops(p, opts: dict, way: str, pallas: bool = False,
              keep: list | None = None, against: list | None = None) -> dict:
    """One ``solve(p, **opts)`` with its sequential loop (``solve_loop``,
    or ``solve_loop_pallas`` with ``pallas``) run ``way``: "graph" (one
    CUDA graph a chunk, the default), "eager" (``graph=False``: the same
    kernels enqueued eagerly) or "old" (``old_solve_loop``); each
    captured chunk must hold ``seq_nodes`` nodes by its launch counts
    (``loop_runs``)."""
    from simplex_tpu_torch import solver

    return loop_runs(p, opts, way,
                     "solve_loop_pallas" if pallas else "solve_loop",
                     "capture_chunk", old_solve_loop, seq_nodes(),
                     solver.SEQ_CHUNK, keep, against)


def loop_runs(p, opts: dict, way: str, name: str, capture_name: str, old,
              nodes: int, per: int, keep: list | None = None,
              against: list | None = None) -> dict:
    """One ``solve(p, **opts)`` with its loop ``solver.<name>`` run
    ``way``: "graph" (one CUDA graph a chunk or a window, the default),
    "eager" (``graph=False``: the same kernels enqueued eagerly) or "old"
    (``old(tab, options, max_iter, *rest)``, the loop as it ran before).
    Returns the result, the solve's wall, each loop call's wall (host
    clock between two synchronizes) and pivots, each capture's ms
    (``solver.<capture_name>``: the capture and the graph's
    instantiation) and the kernels a pivot of each captured graph by its
    launch counts, ``nodes`` a replay of ``per`` pivots. Each loop call's
    final state (Tt, b, costs, z, base, status, iterations) is appended to
    ``keep`` as copies, or held to ``against``'s bit for bit."""
    import torch

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import seq as ks

    real, real_capture = getattr(solver, name), getattr(solver, capture_name)
    calls, captures, per_pivot = [], [], []

    def capture(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_capture(*args)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - t0))
        counts = out[1].per_replay
        # A tail launches nothing.
        got = sum(n for k, n in counts.items() if k not in ks.TAILS)
        require(got == nodes, f"the captured graph holds {counts}, not "
                f"{nodes} kernels")
        per_pivot.append(got / per)
        return out

    def loop(tab, options, max_iter, *rest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "old":
            out, st, it = old(tab, options, max_iter, *rest)
        else:
            out, st, it = real(tab, options, max_iter, *rest,
                               graph=way == "graph")
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, it))
        final = {"Tt": out.Tt, "b": out.b, "costs": out.costs, "z": out.z,
                 "base": out.base, "status": torch.tensor(st),
                 "iterations": torch.tensor(it)}
        if keep is not None:
            keep.append({k: v.clone() for k, v in final.items()})
        if against is not None:
            for k, want in against[len(calls) - 1].items():
                equal(f"{way} loop call {len(calls)} {k}", final[k], want)
        return out, st, it

    setattr(solver, name, loop)
    setattr(solver, capture_name, capture)
    try:
        res, wall = timed_solve(p, opts)
    finally:
        setattr(solver, name, real)
        setattr(solver, capture_name, real_capture)
    require(len(captures) == (len(calls) if way == "graph" else 0),
            f"{len(captures)} captures in {len(calls)} loop calls")
    pivots = sum(c[1] for c in calls)
    loop_s = sum(c[0] for c in calls)
    return dict(res=res, wall=wall, calls=calls, captures=captures,
                per_pivot=per_pivot, pivots=pivots,
                ms_pivot=1e3 * loop_s / pivots)


def seq_line(label: str, r: dict, unit: str = "chunk") -> str:
    return (f"{label}: {r['ms_pivot']:.4f} ms/pivot over {r['pivots']} "
            "pivots (loop calls " + ", ".join(
                f"{1e3 * c[0]:.1f} ms / {c[1]}" for c in r["calls"])
            + f"); solve wall {r['wall']:.3f} s; captures "
            + (", ".join(f"{c:.2f}" for c in r["captures"]) or "none")
            + f" ms" + (f"; kernels a pivot of each captured {unit} (launch "
                        "counts) " + ", ".join(f"{x:.5f}"
                                               for x in r["per_pivot"])
                        if r["per_pivot"] else ""))


def phase_reference_f64(launches: dict, seq_ms: dict) -> dict:
    """The default options (f64 tableau, eps 1e-9, Dantzig, the sequential
    loop; no refinement) on the reference's benchmarks, held to the
    certified goldens at 1e-9 and to the recorded walks (``F64_WALKS``).
    random_1024_1024 three ways in turns: the loop as one CUDA graph a
    chunk (the default), ``graph=False`` and the old eager
    ``iteration_body``, each loop call ending with the graph run's state
    bit for bit; then random_8192_8192 twice graphed, with the sequential
    kernels' launch counters set to 0 just before the first and read just
    after it. Prints each run's loop ms/pivot (kept in ``seq_ms`` by n),
    capture ms and nodes a pivot beside the JAX package's TPU record and
    the reference's."""
    import torch

    from simplex_tpu_torch.kernels import seq as ks

    walks = {}
    for n, want, ways in ((1024, OBJ_1024, ("graph", "eager", "old")),
                          (8192, OBJ_8192, ("graph", "graph"))):
        p = benchmark_problem(n)
        tpu, ref = recorded_walks(n)
        keep: list = []
        for i, way in enumerate(ways):
            torch.cuda.reset_peak_memory_stats()
            if n == 8192 and i == 0:
                ks.reset_launches()
            r = seq_loops(p, {}, way,
                          keep=keep if i == 0 and n == 1024 else None,
                          against=keep if i and n == 1024 else None)
            if n == 8192 and i == 0:
                for name in ("seq_step_pre", "seq_ratio", "seq_colk",
                             "seq_rank1"):
                    launches[name] = ks.LAUNCHES[name]
                    require(launches[name] > 0, f"{name} never launched")
            label = f"f64 random_{n}_{n} {way} solve {i + 1}"
            res = r["res"]
            check_objective(label, res, want, 1e-9)
            w = (res.iterations_phase1, res.iterations_phase2)
            require(w == F64_WALKS[n], f"{label} walked {w}, recorded "
                    f"{F64_WALKS[n]}")
            walks[n] = w
            seq_ms.setdefault(n, []).append(r["ms_pivot"])
            log(seq_line(label, r) + f"; OPTIMAL objective "
                f"{res.objective!r} (golden {want!r}); pivots {w[0]}+{w[1]}"
                f" (JAX package on a TPU {tpu}, reference CUDA program "
                f"{ref}); max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                + ("" if i or n != 1024 else "; the final state kept"))
        if n == 1024:
            log("f64 random_1024_1024: graph, graph=False and the old eager "
                "body walked the recorded pivots, every loop call's final "
                "state bit for bit the graph run's")
    return walks


def northstar_tableau(opts):
    """The eliminated 10,000 x 100,000 phase-1 tableau, A and b uniform in
    [1, 100] from a seeded generator on the card, and its pre-elimination
    costs: the tableau of ``python -m simplex_tpu_torch.bench``."""
    import torch

    from simplex_tpu_torch.bench import build_bench_state

    return build_bench_state(100_000, 10_000, torch.float32, opts, {},
                             "cuda")


def phase_pallas_seq(launches: dict) -> None:
    """K6's path: ``solve(random_2048_2048, **K6_OPTS)`` with its loop as
    one CUDA graph a chunk, the launch counters of K6 and the sequential
    kernels set to 0 just before and read just after, then with
    ``graph=False``: the recorded walk (``K6_WALK``) both times, every loop
    call's final state bit for bit the graph run's. Then the north-star
    phase-1 tableau (pure f32, the variable axis padded to 8) for 256
    pivots through ``solve_loop_pallas`` graphed and with ``graph=False``:
    the same pivots, the same tableau, costs, b, z and basis bit for bit.
    (K6 against its plain version at these shapes: the kernel phase.)"""
    import dataclasses

    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.solver import solve_loop_pallas

    p = benchmark_problem(2048)
    keep: list = []
    for i, way in enumerate(("graph", "eager")):
        if i == 0:
            kp.reset_launches()
            ks.reset_launches()
        r = seq_loops(p, K6_OPTS, way, pallas=True,
                      keep=None if i else keep, against=keep if i else None)
        if i == 0:
            for name in ("fused_pivot",):
                launches[name] = kp.LAUNCHES[name]
            for name in ("seq_snapshot", "seq_k6_tail"):
                launches[name] = ks.LAUNCHES[name]
            require(min(launches["fused_pivot"], launches["seq_snapshot"],
                        launches["seq_k6_tail"]) > 0,
                    f"K6's path launched {launches}")
        res = r["res"]
        label = f"f32 K6 random_2048_2048 {way}"
        check_objective(label, res, OBJ_2048, 1e-3)
        w = (res.iterations_phase1, res.iterations_phase2)
        require(w == K6_WALK, f"{label} walked {w}, recorded {K6_WALK}")
        log(seq_line(label, r) + f"; OPTIMAL objective {res.objective!r} "
            f"(golden {OBJ_2048!r}, rel "
            f"{abs(res.objective - OBJ_2048) / OBJ_2048:.2e}); pivots "
            f"{w[0]}+{w[1]}" + ("" if i else f"; launches {launches}"))

    torch.cuda.reset_peak_memory_stats()
    sopts = SolverOptions(**K6_OPTS)
    tab0, _ = northstar_tableau(sopts)
    cap = 256
    runs = {}
    for way in ("graph", "eager"):
        tab = (dataclasses.replace(tab0, Tt=tab0.Tt.clone())
               if way == "graph" else tab0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, iters = solve_loop_pallas(tab, sopts, cap,
                                          graph=way == "graph")
        torch.cuda.synchronize()
        runs[way] = (out, iters, time.perf_counter() - t0)
    (tg, ig, wg), (te, ie, we) = runs["graph"], runs["eager"]
    require(ig == ie == cap, f"north-star K6 loop: {ig} / {ie} pivots")
    for name in ("b", "costs", "z", "base"):
        equal(f"north-star K6 loop {name}", getattr(tg, name),
              getattr(te, name))
    for i in range(0, tg.Tt.shape[0], 1024):
        equal(f"north-star K6 loop Tt rows {i}..", tg.Tt[i:i + 1024],
              te.Tt[i:i + 1024])
    log(f"north-star 10000x100000 f32 K6 loop: tableau "
        f"{tuple(tg.Tt.shape)}; {cap} pivots graphed in {wg:.3f} s = "
        f"{1e3 * wg / cap:.4f} ms/pivot (the capture included), with "
        f"graph=False {we:.3f} s = {1e3 * we / cap:.4f} ms/pivot; the "
        f"same state bit for bit; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def blocked_nodes(L: int) -> int:
    """The kernels of the plain blocked loop's window graph by its launch
    counts: ``seq_step_pre``, then per pivot ``eta_ratio`` and
    ``eta_colk`` (the apply's ``addmm_`` and the re-pricing are library
    calls, which no counter sees)."""
    return 2 * L + 1


def blocked_loops(p, opts: dict, way: str, keep: list | None = None,
                  against: list | None = None) -> dict:
    """One ``solve(p, **opts)`` with its plain blocked loop
    (``solve_loop_blocked``) run ``way``: "graph" (one CUDA graph a
    window), "eager" (``graph=False``) or "old" (the old body,
    ``solve_loop_blocked_reference``), by ``loop_runs``."""
    from simplex_tpu_torch import solver

    L = int(opts["block_pivots"])
    return loop_runs(p, opts, way, "solve_loop_blocked",
                     "capture_blocked_window",
                     solver.solve_loop_blocked_reference, blocked_nodes(L),
                     L, keep, against)


def phase_blocked_plain(launches: dict, seq_ms: dict) -> None:
    """The plain blocked loop (f64 tableau, L=128; the full f64 re-solve's
    loop) on random_2048_2048 three ways in turns: one CUDA graph a window
    (its kernels' launch counters set to 0 just before and read just
    after), ``graph=False`` (every loop call's final state the graph
    run's bit for bit) and the old body (``solve_loop_blocked_reference``,
    its eta corrections ``@`` products); each within 1e-9 of the golden
    and walking the recorded ``BLOCKED_WALK``, none of K1-K4 launched.
    Then random_8192_8192 graphed, within 1e-9 of its golden, beside the
    default options' sequential loop on the same problem (``seq_ms``,
    phase 3); then the pure-f32 tableau with the kernels off (L=128, the
    window's re-pricing and reopening in its graph) on random_2048_2048,
    within 1e-3. Each run's ms/pivot, capture ms and kernels a pivot by
    the captured launch counts."""
    import torch

    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    p = benchmark_problem(2048)
    keep: list = []
    for i, way in enumerate(("graph", "eager", "old")):
        kb.reset_launches()
        if i == 0:
            ke.reset_launches()
            ks.reset_launches()
        r = blocked_loops(p, BLOCKED_F64, way, keep=keep if i == 0 else None,
                          against=keep if way == "eager" else None)
        if i == 0:
            for name in ETAS:
                launches[name] = ke.LAUNCHES[name]
            require(min(launches[n] for n in ETAS) > 0
                    and ks.LAUNCHES["seq_step_pre"] > 0,
                    f"the plain blocked loop launched {ke.LAUNCHES}, "
                    f"seq_step_pre {ks.LAUNCHES['seq_step_pre']}")
        require(not any(kb.LAUNCHES.values()), f"K1-K4 launched: "
                f"{kb.LAUNCHES}")
        res = r["res"]
        label = f"f64 L=128 random_2048_2048 {way}"
        check_objective(label, res, OBJ_2048, 1e-9)
        w = (res.iterations_phase1, res.iterations_phase2)
        require(w == BLOCKED_WALK, f"{label} walked {w}, recorded "
                f"{BLOCKED_WALK}")
        require(way == "old" or res.objective == BLOCKED_OBJ[2048],
                f"{label} reached {res.objective!r}, recorded "
                f"{BLOCKED_OBJ[2048]!r} bit for bit")
        log(seq_line(label, r, "window") + f"; OPTIMAL objective "
            f"{res.objective!r} (golden {OBJ_2048!r}); pivots {w[0]}+{w[1]}"
            + (f"; launches {dict(ke.LAUNCHES)}" if i == 0 else ""))
    log("f64 L=128 random_2048_2048: graph, graph=False and the old body "
        "walked the recorded pivots, every loop call of graph=False ending "
        "in the graph run's state bit for bit, graph and graph=False at "
        "the recorded objective bit for bit")

    p = benchmark_problem(8192)
    torch.cuda.reset_peak_memory_stats()
    r = blocked_loops(p, BLOCKED_F64, "graph")
    res = r["res"]
    check_objective("f64 L=128 random_8192_8192", res, OBJ_8192, 1e-9)
    w = (res.iterations_phase1, res.iterations_phase2)
    require(w == BLOCKED_WALK_8192 and res.objective == BLOCKED_OBJ[8192],
            f"f64 L=128 random_8192_8192 walked {w} to {res.objective!r}, "
            f"recorded {BLOCKED_WALK_8192} to {BLOCKED_OBJ[8192]!r}")
    log(seq_line("f64 L=128 random_8192_8192 graph", r, "window")
        + f"; OPTIMAL objective {res.objective!r} (golden {OBJ_8192!r}); "
        f"pivots {w[0]}+{w[1]}; the default options' sequential loop on "
        f"the same problem in this run: " + ", ".join(
            f"{x:.4f}" for x in seq_ms.get(8192, [])) + " ms/pivot; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    del res, r
    torch.cuda.empty_cache()

    ke.reset_launches()
    r = blocked_loops(benchmark_problem(2048), BLOCKED_F32, "graph")
    res = r["res"]
    check_objective("f32 kernels-off random_2048_2048", res, OBJ_2048, 1e-3)
    require(min(ke.LAUNCHES.values()) > 0, f"the f32 plain blocked loop "
            f"launched {ke.LAUNCHES}")
    w = (res.iterations_phase1, res.iterations_phase2)
    log(seq_line("f32 (f32 vectors, use_pallas=False) L=128 "
                 "random_2048_2048 graph", r, "window")
        + f"; OPTIMAL objective {res.objective!r} (golden {OBJ_2048!r}, rel "
        f"{abs(res.objective - OBJ_2048) / OBJ_2048:.2e}); pivots "
        f"{w[0]}+{w[1]}")


TIMED_OPS = ["fillTableau", "gauss1", "solve", "solveIterations",
             "checkDegeneracy", "costsVector", "gauss2", "solve",
             "solveIterations", "solution"]


def run_cli(args: list, timeout: int = 600) -> str:
    proc = subprocess.run([sys.executable, "-m", "simplex_tpu_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    require(proc.returncode == 0, f"cli {args}: exit {proc.returncode}\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def csv_rows(path: pathlib.Path) -> list:
    lines = path.read_text().splitlines()
    require(lines[0] == "vars,contraints,operation,elapsed_time",
            f"{path.name}: header {lines[0]!r}")
    return [line.split(",") for line in lines[1:]]


#: The certified record of the JAX package's 36-size sweep.
R5_SWEEP = ROOT / "data" / "measures" / "refine_sweep_r5.json"
#: Phase 10e's sweep sizes: the tallest and the widest of the grid and
#: 4096^2, none solved by an earlier phase (1024^2, 2048^2 and 8192^2 are).
SWEEP_SIZES = "256x8192,8192x256,4096x4096"

#: The benchmark entry points of phase 10d: (module, arguments).
#: ``bench``'s marginal is the difference of the best of its repeats at
#: two caps, each run timed on the host with its graph's capture: two
#: repeats once left a slow spell of the host in both cap-256 runs and a
#: marginal under the floor (efficiency 208%); five give the best of each
#: cap room to be a quiet run. K6's pass runs at 96-98% of its floor, and
#: its runs at one cap spread by 3 ms: between the caps 32 and 64 that is
#: 3% of the marginal, so it runs to 256 pivots (128 between the caps).
#: ``--dtype float64`` is the plain blocked loop on the f64 north-star
#: tableau (9.7 GB), one CUDA graph a window.
BENCH_RUNS = (
    ("bench", ["--repeats", "5"]),
    ("bench", ["--block", "0", "--vector-dtype", "float32", "--iters", "256",
               "--repeats", "5"]),
    ("bench", ["--dtype", "float64", "--repeats", "3"]),
    ("bench_batch", ["--repeats", "1"]),
    ("bench_sharded", ["--repeats", "2"]),
)
#: The key set of bench.py's line (tests/test_bench.py:43-49).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ceiling_gbs",
              "floor_ms_per_pivot", "efficiency_pct", "pivot_rule",
              "dantzig_ms_per_pivot", "build_trace_s", "build_compile_s",
              "build_exec_s", "loop_trace_s", "loop_compile_s"}


def phase_bench() -> None:
    """Each of ``BENCH_RUNS`` as ``python -m simplex_tpu_torch.<module>``
    on the card: exit 0 and the module's stdout contract (one JSON line
    with bench.py's keys, a positive value, a floor no higher than the
    marginal and Dantzig's marginal beside a devex one; ``BENCH_BATCH_OK``
    last; one ``sharded_ms_per_pivot_mesh1`` line). Its lines and
    diagnostics are printed."""
    import torch

    torch.cuda.empty_cache()
    for module, args in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"simplex_tpu_torch.{module}", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        label = " ".join([module, *args])
        for line in proc.stderr.splitlines():
            log(f"  [{module}] {line}")
        require(proc.returncode == 0, f"{label}: exit {proc.returncode}\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        lines = [l for l in proc.stdout.splitlines() if l.strip()]
        if module == "bench_batch":
            require(lines and lines[-1] == "BENCH_BATCH_OK",
                    f"{label}: stdout ends {lines[-1:]}")
        else:
            require(len(lines) == 1, f"{label}: {len(lines)} lines on stdout")
            rec = json.loads(lines[0])
            if module == "bench":
                require(set(rec) == BENCH_KEYS, f"{label}: keys {set(rec)}")
                require(rec["value"] > 0 and rec["ceiling_gbs"] > 0
                        and 0 < rec["efficiency_pct"] <= 100,
                        f"{label}: {rec}")
                require((rec["dantzig_ms_per_pivot"] is None)
                        == (rec["pivot_rule"] == "dantzig"),
                        f"{label}: pivot rule {rec['pivot_rule']}, Dantzig "
                        f"{rec['dantzig_ms_per_pivot']}")
            else:
                require(set(rec) == {"sharded_ms_per_pivot_mesh1", "lo",
                                     "hi"}
                        and rec["sharded_ms_per_pivot_mesh1"] > 0,
                        f"{label}: {rec}")
        log(f"bench {label} ({wall:.1f} s): {lines[0]}")


def run_module(main, argv: list) -> tuple[int, str, str]:
    """``main(argv)`` of an entry point in this process (so that the
    launch counters can be read), its stdout and stderr captured."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def phase_refine_sweep() -> None:
    """``python -m simplex_tpu_torch.validate_refine_sweep`` on
    ``SWEEP_SIZES``, in this process: every row OPTIMAL, certified at
    1e-9 and within 1e-9 of ``refine_sweep_r5.json``'s objective for its
    seed; K1-K4 and the step kernels launched (counters set to 0 just
    before, read just after). Its file goes to a temporary directory."""
    import tempfile

    import torch

    from simplex_tpu_torch import validate_refine_sweep
    from simplex_tpu_torch.kernels import blocked as kb

    record = {r["seed"]: r for r in json.loads(R5_SWEEP.read_text())["rows"]}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / "sweep.json"
        t0 = time.perf_counter()
        kb.reset_launches()
        rc, _, err = run_module(validate_refine_sweep.main,
                                ["--sizes", SWEEP_SIZES, "--out", str(out)])
        counts = {k: kb.LAUNCHES[k] for k in SINGLE_PATH}
        wall = time.perf_counter() - t0
        for line in err.splitlines():
            log(f"  [validate_refine_sweep] {line}")
        require(rc == 0, f"validate_refine_sweep: exit {rc}")
        doc = json.loads(out.read_text())
    rows = doc["rows"]
    require(len(rows) == len(SWEEP_SIZES.split(","))
            and doc["summary"]["device"].startswith(
                torch.cuda.get_device_name(0)),
            f"validate_refine_sweep: {doc['summary']}")
    for row in rows:
        want = record[row["seed"]]["objective"]
        rel = abs(row["objective"] - want) / abs(want)
        require(row["status"] == "OPTIMAL" and row["certified_1e9"]
                and rel <= 1e-9,
                f"sweep {row['vars']}x{row['constraints']}: "
                f"{row['status']} certified_1e9={row.get('certified_1e9')} "
                f"objective {row['objective']!r} vs {want!r}")
    for name in SINGLE_PATH:
        require(counts[name] > 0, f"{name} never launched in the sweep")
    log(f"validate_refine_sweep {SWEEP_SIZES}: every row OPTIMAL, certified"
        f" at 1e-9, within 1e-9 of refine_sweep_r5.json; launches {counts};"
        f" {wall:.1f} s")


def phase_refine_flagship() -> None:
    """``python -m simplex_tpu_torch.measure_refine_flagship`` at its
    default 50,000 x 10,000, in this process: ``REFINE_FLAGSHIP_OK``
    last and K1-K4 and the step kernels launched (counters set to 0
    just before, read just after); its answer certified at 1e-9: the
    refinement of the mixed solve's basis, or where that fails (the
    basis drifted, as the JAX
    package's own run at this shape recorded:
    data/measures/logs_r5/refine_flagship_50k.log), the warm f64 finish
    from it, OPTIMAL with its certificates at 1e-9."""
    import torch

    from simplex_tpu_torch import finish, measure_refine_flagship
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.validate_refine_sweep import strong_certified

    finished = []
    real = finish.finish_from_basis

    def spy(problem, base, options, *a, **kw):
        res = real(problem, base, options, *a, **kw)
        finished.append((problem, res))
        return res

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kb.reset_launches()
    finish.finish_from_basis = spy
    try:
        rc, out, err = run_module(measure_refine_flagship.main, [])
    finally:
        finish.finish_from_basis = real
    counts = {k: kb.LAUNCHES[k] for k in SINGLE_PATH}
    wall = time.perf_counter() - t0
    for line in err.splitlines():
        log(f"  [measure_refine_flagship] {line}")
    lines = out.splitlines()
    require(rc == 0 and lines and lines[-1].startswith("REFINE_FLAGSHIP_OK "),
            f"measure_refine_flagship: exit {rc}, stdout {lines[-1:]}")
    for name in SINGLE_PATH:
        require(counts[name] > 0,
                f"{name} never launched in measure_refine_flagship")
    if "certificates: pass@1e-6=True pass@1e-9=True" in err:
        how = "the refinement passes at 1e-9"
    else:
        require(len(finished) == 1 and finished[0][1] is not None,
                "measure_refine_flagship: the certificates failed and the "
                "warm finish did not apply")
        problem, res = finished[0]
        require(res.status.name == "OPTIMAL"
                and strong_certified(res.refine, problem.b, problem.c),
                f"measure_refine_flagship: warm finish {res.status!r} "
                f"{res.refine}")
        how = (f"the refinement fails, the warm finish certifies at 1e-9 "
               f"(objective {res.objective!r}, "
               f"{res.iterations_phase2} finishing pivots)")
    log(f"measure_refine_flagship 50000x10000: {lines[-1]}; {how}; "
        f"launches {counts}; {wall:.1f} s")


def sweep_table_rows(measures: pathlib.Path) -> list:
    """``python -m simplex_tpu_torch.sweep_table`` on ``measures``
    against data/reference_measures: its table's rows, as cells."""
    from simplex_tpu_torch import sweep_table

    rc, out, err = run_module(sweep_table.main, [
        "--ours", str(measures), "--ref",
        str(ROOT / "data" / "reference_measures")])
    require(rc == 0, f"sweep_table: exit {rc}")
    lines = out.splitlines()
    require(lines[1] == "|---|---|---|---|---|---|",
            f"sweep_table: {lines[:2]}")
    for line in lines:
        log(f"  [sweep_table] {line}")
    return [[cell.strip() for cell in line.strip("|").split("|")]
            for line in lines[2:]]


def phase_cli() -> None:
    """``python -m simplex_tpu_torch.cli`` on the card: a problem file
    (the reference's stdout lines and solution.txt), the ``-t --limit
    1024 --timer`` sweep (every CSV in the reference's schema, each
    solveIterations row equal to the pivots printed), and a seed file
    with ``--per-iteration`` (pivots + 1 solve rows per phase)."""
    import re
    import tempfile

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        t0 = time.perf_counter()
        out = run_cli(["-f", str(DATA / "smallProblem.txt"),
                       "--data-dir", str(tmp)])
        want = ["Starting...", "Reading problem from file...",
                "Resolving....", "", "Problem solved!",
                "Optimal value: 64.000000",
                f"Solution written to {tmp / 'solution.txt'}",
                "(phase-1 pivots: 2, phase-2 pivots: 2)"]
        require(out.splitlines() == want, f"cli -f stdout: {out!r}")
        sol = (tmp / "solution.txt").read_text()
        require(sol == "8.000000\n0.000000\n0.000000\n\n"
                "Optimal value: 64.000000\n", f"solution.txt: {sol!r}")
        log(f"cli -f smallProblem: the reference's stdout lines and "
            f"solution.txt ({time.perf_counter() - t0:.1f} s)")

        t0 = time.perf_counter()
        out = run_cli(["-t", "--limit", "1024", "--timer", "--data-dir",
                       str(tmp)])
        sizes = re.findall(r"Current matrix: (\d+)\*(\d+)", out)
        walks = re.findall(
            r"status=(\w+) objective=\S+ pivots=(\d+)\+(\d+)", out)
        require(len(sizes) == len(walks) == 9, f"cli -t: {out[-2000:]}")
        done = []
        for (n, m), (status, p1, p2) in zip(sizes, walks):
            rows = csv_rows(tmp / "measures" / f"benchmark_{n}_{m}.txt")
            ops = [r[2] for r in rows]
            require(status == "OPTIMAL" and ops == TIMED_OPS,
                    f"benchmark_{n}_{m}: {status} {ops}")
            n, m = int(n), int(m)
            cols = [(int(r[0]), int(r[1])) for r in rows]
            require(cols == [(n + 2 * m + 1, m)] * 5 + [(n + m + 1, m)] * 5,
                    f"benchmark_{n}_{m}: vars/constraints {cols}")
            its = [float(r[3]) for r in rows if r[2] == "solveIterations"]
            require(its == [float(p1), float(p2)],
                    f"benchmark_{n}_{m}: solveIterations {its} vs the "
                    f"printed {p1}+{p2}")
            require(all(float(r[3]) > 0 for r in rows),
                    f"benchmark_{n}_{m}: a time that is not positive")
            done.append(f"{n}x{m}:{p1}+{p2}")
        log(f"cli -t --limit 1024 --timer: 9 sizes OPTIMAL, every CSV in "
            f"the reference's schema, solveIterations equal to the printed "
            f"pivots ({', '.join(done)}); "
            f"{time.perf_counter() - t0:.1f} s")
        rows = sweep_table_rows(tmp / "measures")
        got = [f"{r[0].replace('×', 'x')}:{r[1]}" for r in rows]
        require(sorted(got) == sorted(done)
                and all("—" not in r[2:5] for r in rows),
                f"sweep_table: {rows} against the CLI's {done}")
        log("sweep_table on the sweep's CSVs: 9 rows, each with the "
            "reference's pivots and seconds, pivots as the CLI printed")

        t0 = time.perf_counter()
        out = run_cli(["-rf", str(DATA / "benchmark_problems"
                                  / "random_256_256.txt"),
                       "--timer", "--per-iteration", "--data-dir", str(tmp)])
        p1, p2 = (int(v) for v in re.search(
            r"phase-1 pivots: (\d+), phase-2 pivots: (\d+)", out).groups())
        (csv,) = (tmp / "measures").glob("times_*.txt")
        solve = [int(r[0]) for r in csv_rows(csv) if r[2] == "solve"]
        got = (solve.count(256 + 2 * 256 + 1), solve.count(256 + 256 + 1))
        require(got == (p1 + 1, p2 + 1),
                f"cli --per-iteration: solve rows {got} for {p1}+{p2}")
        log(f"cli -rf random_256_256 --timer --per-iteration: {p1}+{p2} "
            f"pivots, solve rows {got[0]}+{got[1]} (pivots + 1 per phase);"
            f" {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        out = run_cli(["-f", str(DATA / "smallProblem.txt"), "--equilibrate",
                       "--data-dir", str(tmp)])
        require(out.splitlines() == want, f"cli --equilibrate: {out!r}")
        seeds = DATA / "benchmark_problems" / "random_256_256.txt"
        out = run_cli(["-rf", str(seeds), "--batch", "4", "--data-dir",
                       str(tmp)])
        lines = out.splitlines()
        first = int(seeds.read_text().split()[2])
        require(lines[:3] == ["Starting...", "Reading seed from file",
                              f"Solving 4 instances (seeds {first}.."
                              f"{first + 3}) batched..."]
                and len(lines) == 8
                and lines[3] == f"seed {first}: OPTIMAL objective=5.535474 "
                                "pivots=473+17"
                and all(re.fullmatch(rf"seed {first + i}: OPTIMAL "
                                     r"objective=\d+\.\d{6} pivots=\d+\+\d+",
                                     lines[3 + i]) for i in range(4))
                and re.fullmatch(r"Batch solved in \d+\.\d{3}s \(\d+\.\d "
                                 r"ms/instance\)", lines[7]),
                f"cli --batch 4: {out!r}")
        log(f"cli --equilibrate -f smallProblem: the reference's stdout lines"
            f"; cli -rf random_256_256 --batch 4 with the default dtype (the "
            f"batched fallback): {' | '.join(lines[3:7])}; "
            f"{time.perf_counter() - t0:.1f} s")


def phase_pivot_kernel(records: dict) -> None:
    """K6 against its plain version on the card at the main path's shapes
    (random_2048_2048 and the north-star phase 1, pure f32) and at the
    8192^2 f32 tableau: the candidates equal, the tableau and the costs
    within 2^-22 of their magnitude (the same two roundings per element
    on both sides: expected bit-equal); device ms per call against the
    plain version and against ``Tt.addr_(factor, colk, alpha=-1)``, the
    one PyTorch call that does the update alone (without the fold). The
    north-star shape's numbers go into the kernel's record."""
    import torch

    from simplex_tpu_torch.kernels import pivot as kp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261018)
    eps = 1e-4
    for label, (M, R) in (("2048^2", (2048, 6144)),) + PIVOT_SHAPES:
        Tt = torch.rand((M, R), generator=g, device=dev) * 2.0 - 1.0
        costs = torch.rand((R,), generator=g, device=dev) * 2.0 - 1.0
        h = 12345 % R
        a_h = Tt[:, h].clone()
        k = torch.argmax(a_h.abs()).to(torch.int32)
        colk = Tt[int(k)].clone()
        p, minc = a_h[int(k)].clone(), costs[h].clone()
        r = R - 100
        Tk = Tt.clone()
        ck, cp = costs.clone(), costs.clone()
        cand_k = kp.fused_pivot(Tk, ck, colk, a_h, p, minc, k, r, eps)
        cand_p = kp.fused_pivot_plain(Tt, cp, colk, a_h, p, minc, k, r, eps)
        for name, a, b in zip(("h_d", "v_d", "h_b", "v_b"), cand_k, cand_p):
            equal(f"K6 {label} {name}", a, b)
        err = 0.0
        for i in range(0, M, 1024):
            d = (Tk[i:i + 1024] - Tt[i:i + 1024]).abs()
            require(bool((d <= 2.0 ** -22 * (1.0 + Tt[i:i + 1024].abs()))
                         .all()), f"K6 {label}: Tt rows {i}.. differ")
            err = max(err, float(d.max()))
        err = max(err, close(f"K6 {label} costs", ck, cp,
                             2.0 ** -22 * (1.0 + cp.abs())))
        factor = a_h * (1.0 / p)
        ms = device_ms(lambda: kp.fused_pivot(Tk, ck, colk, a_h, p, minc, k,
                                              r, eps), 10)
        plain_ms = device_ms(lambda: kp.fused_pivot_plain(
            Tt, cp, colk, a_h, p, minc, k, r, eps), 5)
        library_ms = device_ms(lambda: Tt.addr_(factor, colk, alpha=-1.0),
                               10)
        ev = [event_ms(lambda: kp.fused_pivot(Tk, ck, colk, a_h, p, minc,
                                              k, r, eps), 10),
              event_ms(lambda: Tt.addr_(factor, colk, alpha=-1.0), 10)]
        bound_ms, by = bound(8 * M * R + 12 * R + 4 * M, 2 * M * R + 2 * R)
        log(f"K6 fused_pivot {label} M={M} R={R}: matches plain (max abs "
            f"err {err:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"addr_ {library_ms:.4f} ms (torch.profiler; CUDA events: "
            f"kernel {ev[0]:.4f} ms, addr_ {ev[1]:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({by}); the kernel moves the tableau at "
            f"{8 * M * R / ms / 1e9:.3f} TB/s")
        if label == "north-star":
            records["fused_pivot"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by,
                "library_ms": library_ms, "check_ms": ev[0]}
        del Tt, Tk, factor
        torch.cuda.empty_cache()


def seq_kernel_loop(M: int, R: int, dtype, vdtype, pallas: bool, g,
                    eps: float):
    """A ``solver.SeqLoop`` over a seeded random tableau on the card (Tt
    uniform in [-1, 1], b in [0, 100], the costs in [-1, 1], the last 100
    columns dead) and its options, with a copy of its every tensor: the
    kernels run on one, the plain versions on the other."""
    import dataclasses

    import torch

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.tableau import Tableau

    dev = torch.device("cuda")

    def uni(shape, lo, hi, dt):
        return torch.rand(shape, generator=g, device=dev, dtype=dt) * (
            hi - lo) + lo

    tab = Tableau(uni((M, R), -1.0, 1.0, dtype), uni((M,), 0.0, 100.0, vdtype),
                  uni((R,), -1.0, 1.0, vdtype),
                  torch.zeros((), dtype=vdtype, device=dev),
                  torch.randint(0, R, (M,), generator=g, device=dev,
                                dtype=torch.int32), n=R - M - 100, m=M,
                  r=R - 100)
    opts = SolverOptions(dtype=str(dtype).split(".")[1],
                         vector_dtype=str(vdtype).split(".")[1],
                         use_pallas=pallas, eps=eps)
    loop = solver.seq_loop(tab, opts, pallas=pallas)
    twin = dataclasses.replace(
        loop, **{f.name: getattr(loop, f.name).clone()
                 for f in dataclasses.fields(loop)
                 if isinstance(getattr(loop, f.name), torch.Tensor)},
        s=ks.SeqScalars(**{k: x.clone()
                           for k, x in loop.s.tensors().items()}))
    return loop, twin, opts


def seq_pivot(lp, kernel: bool, pallas: bool, max_iter: int,
              eps: float) -> None:
    """One pivot of a chunk from its step before, on the kernels or on
    their plain versions (the K6 loop's kernels with ``pallas``)."""
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import seq as ks

    s = lp.s
    policy = dict(bland_static=False, threshold=50)
    if kernel:
        ks.seq_step_pre(s, max_iter, eps)
        if pallas:
            ks.seq_ratio_snapshot(lp.Tt, lp.b, lp.base, lp.ah, lp.colk, s,
                                  eps)
            ks.fused_pivot_tail(lp.Tt, lp.costs, lp.colk, lp.ah, s, lp.r,
                                eps, max_iter, lp.ws_pass, then_pre=False,
                                **policy)
        else:
            ks.seq_ratio_colk(lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk,
                              lp.fac, s, lp.r, eps, max_iter, then_pre=False,
                              **policy)
            ks.seq_rank1(lp.Tt, lp.fac, lp.colk, s)
        return
    kb.step_pre_plain(s, max_iter, eps)
    ks.seq_ratio_plain(lp.Tt, lp.b, s, lp.ah, eps)
    if pallas:
        ks.seq_snapshot_plain(lp.Tt, lp.b, lp.base, lp.ah, lp.colk, s)
        ks.fused_pivot_tail_plain(lp.Tt, lp.costs, lp.colk, lp.ah, s, lp.r,
                                  eps, max_iter, then_pre=False, **policy)
    else:
        ks.seq_colk_plain(lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk,
                          lp.fac, s, lp.r, eps, max_iter, then_pre=False,
                          **policy)
        ks.seq_rank1_plain(lp.Tt, lp.fac, lp.colk, s)


def phase_seq_kernels(records: dict) -> None:
    """The sequential loops' kernels against their plain versions on the
    card, at the main paths' shapes: the default loop's at the 8192^2 f64
    tableau (M 8,192 x R 24,576), the K6 loop's at 2048^2 pure f32 (M
    2,048 x R 6,144). From 24 seeded states each -- taken and skipped
    pivots, the fuse, Bland on, a NaN in b on an eligible row, a tie of
    the smallest quotient on two rows far apart, no eligible row (the
    entering column bent to <= 0) -- one pivot (the step before, the
    ratio test, the pass, the update) on the kernels and on their plain
    versions from the same state: every scalar, vector and the tableau bit
    for bit. Then, on a taken pivot, each kernel timed by torch.profiler
    and by CUDA events over a CUDA graph of 50 calls (``seq_ratio`` the
    one-cluster kernel alone, ``seq_colk`` as ``seq_ratio_colk`` and
    ``seq_snapshot`` as ``seq_ratio_snapshot`` less ``seq_ratio`` in
    turns, ``cluster_tail_record``; ``seq_rank1`` over back-to-back calls,
    in turns with ``batch_rank1`` at one lane -- the update without row k
    -- and with ``Tt.addr_``, its library call; K6's tail as K6's tiles
    with it less without, in turns, ``k6_tail_record``), beside its plain
    version and its bound."""
    import numpy as np
    import torch

    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.kernels import seq as ks

    g = torch.Generator(device="cuda").manual_seed(20261019)
    rng = np.random.default_rng(20261019)
    max_iter = 10
    for pallas, M, R, dt, vdt, eps in SEQ_KERNEL_SHAPES:
        dt, vdt = getattr(torch, dt), getattr(torch, vdt)
        a, b, _ = seq_kernel_loop(M, R, dt, vdt, pallas, g, eps)
        seen = collections.Counter()
        for i in range(24):
            edge = i % 6
            stall = int(rng.integers(0, 60))
            for lp in (a, b):
                s = lp.s
                s.status.fill_(kb.RUNNING)
                s.iterations.fill_(max_iter if edge == 1 else 3)
                s.bland.fill_(edge == 2)
                s.stall.fill_(stall)
            if edge in (3, 4, 5):
                # The next column (the Dantzig candidate's), bent alike.
                h = int(a.s.h_d)
                rows = torch.nonzero(a.Tt[:, h] >= eps).view(-1)
                for lp in (a, b):
                    if edge == 3:
                        lp.b[rows[1]] = float("nan")
                    elif edge == 4:
                        lp.Tt[rows[-1], h] = lp.Tt[rows[0], h]
                        lp.b[rows[-1]] = lp.b[rows[0]]
                    else:
                        col = lp.Tt[:, h].clone()
                        lp.Tt[:, h] = -col.abs()
            seq_pivot(a, True, pallas, max_iter, eps)
            seq_pivot(b, False, pallas, max_iter, eps)
            tag = f"{'K6' if pallas else 'f64'} seq state {i}"
            for name, x in a.s.tensors().items():
                equal(f"{tag} {name}", x, getattr(b.s, name))
            for name in ("b", "costs", "base", "ah", "colk", "fac"):
                if getattr(a, name) is not None:
                    equal(f"{tag} {name}", getattr(a, name), getattr(b, name))
            for j in range(0, M, 1024):
                equal(f"{tag} Tt rows {j}..", a.Tt[j:j + 1024],
                      b.Tt[j:j + 1024])
            seen["taken" if bool(a.s.do) else "skipped"] += 1
            seen["unbounded"] += bool(a.s.unb)
            for lp in (a, b):
                lp.b.nan_to_num_(nan=1.0)
                lp.s.z.nan_to_num_(nan=0.0)
                if edge == 5:
                    lp.Tt[:, h] = col            # the skipped pivot's column
        require(min(seen["taken"], seen["skipped"], seen["unbounded"]) > 0,
                f"the states miss a kind of pivot: {dict(seen)}")
        log(f"sequential kernels ({'K6 loop, f32' if pallas else 'f64'}, "
            f"M={M} R={R}): every scalar, vector and the tableau equal the "
            f"plain versions' on 24 states ({dict(seen)})")

        # A taken pivot far from the fuse, for the timings.
        big = 2 ** 30
        s = a.s
        s.status.fill_(kb.RUNNING)
        s.iterations.fill_(0)
        s.bland.fill_(False)
        ks.seq_step_pre(s, big, eps)
        ks.seq_ratio(a.Tt, a.b, s, a.ah, eps)
        require(bool(s.do), "the timed pivot is not taken")
        item = a.Tt.element_size()
        pol = dict(bland_static=False, threshold=50, then_pre=True)
        timed = {
            "seq_step_pre": (lambda: ks.seq_step_pre(s, big, eps),
                             lambda: kb.step_pre_plain(s, big, eps),
                             "seq_step_pre", bound(SEQ_STEP_BYTES[
                                 "seq_step_pre"])),
            "seq_ratio": (lambda: ks.seq_ratio(a.Tt, a.b, s, a.ah, eps),
                          lambda: ks.seq_ratio_plain(a.Tt, a.b, s, a.ah,
                                                     eps),
                          "seq_ratio_kernel", bound(M * (2 * item + 8) + 44,
                                                    f64_flops=M)),
        }
        for name, (fn, plain_fn, match, (bound_ms, by)) in timed.items():
            require(kernels_launched(fn) == 1, f"one {name} call launched "
                    "more than one kernel")
            ms = device_ms(fn, 50, match=match)
            rec = {"max_abs_err": 0.0, "ms": ms,
                   "plain_ms": device_ms(plain_fn, 20), "bound_ms": bound_ms,
                   "bound_by": by, "library_ms": None, "check_ms": graph_ms(fn)}
            # The record is the first loop's (the default loop's shapes).
            records.setdefault(name, rec)
            log(f"{name} M={M} R={R}: {ms:.5f} ms a call (torch.profiler), "
                f"{rec['check_ms']:.5f} ms by CUDA events over a CUDA graph "
                f"of 50 calls, plain {rec['plain_ms']:.4f} ms, bound "
                f"{bound_ms:.2e} ms ({by})")
        if pallas:
            cluster_tail_record(
                records, "seq_snapshot", "seq_ratio_snapshot",
                lambda: ks.seq_ratio_snapshot(a.Tt, a.b, a.base, a.ah,
                                              a.colk, s, eps),
                lambda: ks.seq_ratio(a.Tt, a.b, s, a.ah, eps),
                lambda: ks.seq_snapshot_plain(a.Tt, a.b, a.base, a.ah,
                                              a.colk, s),
                bound(8 * R + 12 * M + 30, 3 * M), M, R)
            k6_tail_record(records, a, s, eps, big, pol)
            del a, b
            torch.cuda.empty_cache()
            continue

        cluster_tail_record(
            records, "seq_colk", "seq_ratio_colk",
            lambda: ks.seq_ratio_colk(a.Tt, a.costs, a.b, a.base, a.ah,
                                      a.colk, a.fac, s, a.r, eps, big, **pol),
            lambda: ks.seq_ratio(a.Tt, a.b, s, a.ah, eps),
            lambda: ks.seq_colk_plain(a.Tt, a.costs, a.b, a.base, a.ah,
                                      a.colk, a.fac, s, a.r, eps, big,
                                      **pol),
            bound(32 * R + 32 * M + 130, f64_flops=2 * R + 3 * M), M, R)
        # The update: seq_rank1 (row k written), batch_rank1 at one lane
        # (without row k), Tt.addr_ -- in turns.
        do1 = s.do.view(1)
        rank1 = {
            "seq_rank1": lambda: ks.seq_rank1(a.Tt, a.fac, a.colk, s),
            "batch_rank1 B=1": lambda: kp.batch_rank1(
                a.Tt[None], a.fac[None], a.colk[None], do1),
            "addr_": lambda: a.Tt.addr_(a.fac, a.colk, alpha=-1.0)}
        prof = {name: [] for name in rank1}
        ev = {name: [] for name in rank1}
        for name in ("seq_rank1", "batch_rank1 B=1", "addr_", "addr_",
                     "batch_rank1 B=1", "seq_rank1"):
            prof[name].append(device_ms(rank1[name], 10))
            ev[name].append(event_ms(rank1[name], 10))
        mean = statistics.mean
        bound_ms, by = bound(2 * M * R * item + (M + R) * item,
                             f64_flops=2 * M * R)
        records["seq_rank1"] = {
            "max_abs_err": 0.0, "ms": mean(prof["seq_rank1"]),
            "plain_ms": device_ms(lambda: ks.seq_rank1_plain(
                a.Tt, a.fac, a.colk, s), 5),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": mean(prof["addr_"]),
            "check_ms": mean(ev["seq_rank1"])}
        log(f"the rank-1 update M={M} R={R} f64, ms a call in turns: "
            + "; ".join(f"{name} " + ", ".join(f"{x:.4f}" for x in prof[name])
                        + " (torch.profiler), " + ", ".join(
                            f"{x:.4f}" for x in ev[name]) + " (CUDA events)"
                        for name in rank1)
            + f"; bound {bound_ms:.4f} ms ({by}); seq_rank1 moves the "
            f"tableau at {2 * M * R * item / records['seq_rank1']['ms'] / 1e9:.3f}"
            " TB/s")
        del a, b
        torch.cuda.empty_cache()


def cluster_tail_record(records: dict, tail: str, carrier: str, fn,
                        ratio_fn, plain_fn, bound_by: tuple, M: int,
                        R: int) -> None:
    """The record of ``tail``, the part of the one-cluster kernel
    ``carrier`` (``fn``) after the ratio test: ``carrier`` less
    ``seq_ratio`` alone (``ratio_fn``, the same cluster's ratio test and
    step between), in turns, by torch.profiler and by CUDA events over a
    CUDA graph of 50 calls; beside ``plain_fn``'s time and the tail's
    bound ``bound_by`` (ms, what bounds it)."""
    import torch

    fns = {carrier: fn, "seq_ratio": ratio_fn}
    require(kernels_launched(fn) == 1,
            f"one {carrier} call launched more than one kernel")
    prof = {name: [] for name in fns}
    graph = {name: [] for name in fns}
    for name in ("seq_ratio", carrier, carrier, "seq_ratio"):
        prof[name].append(device_ms(fns[name], 50, match=name + "_kernel"))
        graph[name].append(graph_ms(fns[name]))
    mean = statistics.mean
    bound_ms, by = bound_by
    rec = records[tail] = {
        "max_abs_err": 0.0,
        "ms": mean(prof[carrier]) - mean(prof["seq_ratio"]),
        "plain_ms": device_ms(plain_fn, 20), "bound_ms": bound_ms,
        "bound_by": by, "library_ms": None,
        "check_ms": mean(graph[carrier]) - mean(graph["seq_ratio"])}
    torch.cuda.synchronize()
    log(f"{carrier} and seq_ratio alone M={M} R={R}, ms a call in "
        "turns: " + "; ".join(
            f"{name} " + ", ".join(f"{x:.5f}" for x in prof[name])
            + " (torch.profiler), " + ", ".join(
                f"{x:.5f}" for x in graph[name])
            + " (CUDA graph of 50 calls)" for name in fns)
        + f"; {tail}, the part inside {carrier}: {rec['ms']:.5f} ms "
        f"(torch.profiler), {rec['check_ms']:.5f} ms (CUDA graphs), plain "
        f"{rec['plain_ms']:.4f} ms, bound {bound_ms:.2e} ms ({by})")


def k6_tail_record(records: dict, a, s, eps: float, big: int,
                   pol: dict) -> None:
    """``seq_k6_tail``'s record at K6's loop shape: K6's fold and the step
    after the pass run as the tail of the first row band's last tile
    block, so its own cost is K6's tiles with it (``fused_pivot_tail``,
    one kernel) less the standalone K6's tiles (``fused_pivot``, whose
    fold is a second kernel), in turns, by torch.profiler; the second
    clock is CUDA events over a CUDA graph of 20 calls of each, the
    loop's K6 less the standalone's two nodes (the fold's node and its
    launch gap that went). Beside the standalone fold's own time and the
    step's plain version and bound."""
    import torch

    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.kernels import seq as ks

    cand = tuple(torch.empty((), dtype=dt, device=a.Tt.device)
                 for dt in (torch.int32, torch.float32) * 2)
    k6 = {"K6": lambda: kp.fused_pivot(
              a.Tt, a.costs, a.colk, a.ah, s.p, s.minc, s.k, a.r, eps, s.do,
              a.ws_pass[:4], cand),
          "K6+tail": lambda: ks.fused_pivot_tail(
              a.Tt, a.costs, a.colk, a.ah, s, a.r, eps, big, a.ws_pass,
              **pol)}
    require(kernels_launched(k6["K6+tail"]) == 1,
            "one fused_pivot_tail call launched more than one kernel")
    tiles = {name: [] for name in k6}
    graph = {name: [] for name in k6}
    fold = []
    for name in ("K6", "K6+tail", "K6+tail", "K6"):
        tiles[name].append(device_ms(k6[name], 20,
                                     match="fused_pivot_tiles"))
        graph[name].append(graph_ms(k6[name], 20))
        if name == "K6":
            fold.append(device_ms(k6[name], 20, match="fused_pivot_finish"))
    mean = statistics.mean
    ms = mean(tiles["K6+tail"]) - mean(tiles["K6"])
    bound_ms, by = bound(SEQ_STEP_BYTES["seq_k6_tail"])
    records["seq_k6_tail"] = {
        "max_abs_err": 0.0, "ms": ms,
        "plain_ms": device_ms(lambda: kb.step_post_plain(
            s, big, eps, False, 50, True), 20),
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "check_ms": mean(graph["K6+tail"]) - mean(graph["K6"])}
    log("K6's tiles with and without the fold and the step after as their "
        "tail, ms a call in turns: " + "; ".join(
            f"{name} " + ", ".join(f"{x:.5f}" for x in tiles[name])
            + " (torch.profiler, the tiles), " + ", ".join(
                f"{x:.5f}" for x in graph[name])
            + " (CUDA graph of 20 calls)" for name in k6)
        + "; the standalone K6's fold, its own kernel, " + ", ".join(
            f"{x:.5f}" for x in fold) + f" ms; the tail's own cost {ms:.5f}"
        f" ms; the loop's K6 less the standalone K6 by the graphs "
        f"{records['seq_k6_tail']['check_ms']:.5f} ms")


def sharded_seq_sets(M: int, R: int, P: int, g, eps: float):
    """P ``ShardedSeqLoop`` slices of a seeded random f64 tableau on the
    card (as ``seq_kernel_loop``'s: Tt in [-1, 1], b in [0, 100], the
    costs in [-1, 1], the last 100 columns dead), twice: the kernels run
    on one set, the plain versions on the other; and the options."""
    import dataclasses

    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.tableau import Tableau

    dev = torch.device("cuda")
    f64 = torch.float64

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev, dtype=f64) * (
            hi - lo) + lo

    tab = Tableau(uni((M, R), -1.0, 1.0), uni((M,), 0.0, 100.0),
                  uni((R,), -1.0, 1.0), torch.zeros((), dtype=f64,
                                                    device=dev),
                  torch.randint(0, R, (M,), generator=g, device=dev,
                                dtype=torch.int32), n=R - M - 100, m=M,
                  r=R - 100)
    opts = SolverOptions(eps=eps)
    sets = []
    for _ in range(2):
        slices = [ps.shard_tableau(tab, rank, P) for rank in range(P)]
        # A slice of every column is the tableau itself: each set its own.
        sets.append([ps.sharded_seq_loop(
            dataclasses.replace(sl, Tt=sl.Tt.clone()),
            pg.Shard(None, rank, P, R // P), opts)
            for rank, sl in enumerate(slices)])
        del slices
    del tab
    return sets, opts


def fold_h(loops) -> int:
    """The global h the next pivot's ``seq_fold_column`` folds from the
    slices' send buffers (their ``all_gather``s, stacked here), by its
    plain version on copies of rank 0's scalars."""
    import torch

    from simplex_tpu_torch.kernels import seq as ks

    a = loops[0]
    s = ks.SeqScalars(**{k: x.clone() for k, x in a.s.tensors().items()})
    V = torch.stack([lp.send_v for lp in loops])
    I = torch.stack([lp.send_i for lp in loops])
    ks.seq_fold_column_plain(a.Tt, V, I, a.ah.clone(), s, 2 ** 30, 1e-9, 0)
    return int(s.h)


def sharded_seq_pivot(loops, kernel: bool, max_iter: int, eps: float,
                      policy: dict) -> None:
    """One pivot of ``run_chunk_sharded`` on P slices in this process:
    the collectives by torch ops (the gathers stacked, the columns summed
    in rank order), each rank's kernels (or their plain versions)
    between them."""
    import torch

    from simplex_tpu_torch.kernels import seq as ks

    V = torch.stack([lp.send_v for lp in loops])
    I = torch.stack([lp.send_i for lp in loops])
    for lp in loops:
        lp.recv_v.copy_(V)
        lp.recv_i.copy_(I)
        (ks.seq_fold_column if kernel else ks.seq_fold_column_plain)(
            lp.Tt, lp.recv_v, lp.recv_i, lp.ah, lp.s, max_iter, eps,
            lp.shard.offset)
    total = loops[0].ah.clone()
    for lp in loops[1:]:
        total += lp.ah
    for lp in loops:
        lp.ah.copy_(total)
        if kernel:
            ks.seq_ratio_colk_sharded(
                lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk, lp.fac, lp.s,
                lp.r_loc, eps, max_iter, offset=lp.shard.offset,
                send_v=lp.send_v, send_i=lp.send_i, **policy)
            ks.seq_rank1(lp.Tt, lp.fac, lp.colk, lp.s)
        else:
            ks.seq_ratio_colk_sharded_plain(
                lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk, lp.fac, lp.s,
                lp.r_loc, eps, max_iter, lp.shard.offset, lp.send_v,
                lp.send_i, **policy)
            ks.seq_rank1_plain(lp.Tt, lp.fac, lp.colk, lp.s)


#: What each of the sequential sharded loop's kernels writes and does not
#: read: the fold's scalars and column, the pass's step between, row,
#: factors and send buffers.
SEQ_SHARDED_WRITES = {
    "seq_fold_column": ("h_d", "v_d", "h_b", "v_b", "active", "h", "minc",
                        "optimal", "ah"),
    "seq_ratio_colk_sharded": ("k", "unb", "do", "p", "bk", "u", "colk",
                               "fac", "send_v", "send_i"),
}


def seq_sharded_turns(prior: PriorLib, a, max_iter: int, eps: float,
                      policy: dict, fold, ratio) -> dict:
    """``seq_fold_column`` and ``seq_ratio_colk_sharded`` (``fold``,
    ``ratio``: their wrappers' calls on the one slice ``a``, a
    ``ShardedSeqLoop``, under ``policy``) against the forms before their
    redesign (``prior``: the fold in each block's thread 0 behind a
    barrier, the pass of 16 x 256 threads without programmatic dependent
    launch), bit for bit and timed in turns, each alone and the column
    then the pass (as a chunk runs them at one rank) (``prior_turns``)."""
    import ctypes

    import torch

    from simplex_tpu_torch.kernels import seq as ks

    lib = prior.load()
    s = a.s
    M, R = a.Tt.shape
    pair = ks._pair(s)

    def ptr(x):
        return x.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def prior_fold():
        err = lib.prior_seq_fold_column_launch(
            ptr(a.Tt), ptr(a.recv_v), ptr(a.recv_i), a.recv_v.shape[0], M,
            R, 0, ptr(a.ah), ctypes.byref(ks._seq_ptrs(s)), max_iter, eps,
            pair, stream())
        require(err == 0, f"the earlier seq_fold_column failed ({err})")

    def prior_ratio():
        err = lib.prior_seq_ratio_colk_sharded_launch(
            ptr(a.Tt), ptr(a.costs), ptr(a.b), ptr(a.base), ptr(a.ah),
            ptr(a.colk), ptr(a.fac), M, R, a.r_loc, eps,
            ctypes.byref(ks._seq_ptrs(s)), max_iter,
            *ks._policy(policy["bland_static"], policy["threshold"]), 0,
            ptr(a.send_v), ptr(a.send_i), pair, stream())
        require(err == 0,
                f"the earlier seq_ratio_colk_sharded failed ({err})")

    def tensors():
        return {**s.tensors(), **{n: getattr(a, n) for n in (
            "ah", "colk", "fac", "costs", "b", "base", "send_v", "send_i")}}

    return prior_turns(
        f"f64 M={M} R={R} (one slice)", tensors,
        {name: (old, new, SEQ_SHARDED_WRITES[name]) for name, old, new in (
            ("seq_fold_column", prior_fold, fold),
            ("seq_ratio_colk_sharded", prior_ratio, ratio))},
        {"seq_fold_column": (prior_fold, fold),
         "seq_ratio_colk_sharded": (prior_ratio, ratio),
         "seq_fold_column+seq_ratio_colk_sharded": (
             lambda: (prior_fold(), prior_ratio()),
             lambda: (fold(), ratio()))})


def phase_sharded_seq_kernels(records: dict, prior: PriorLib) -> None:
    """The sequential sharded loop's kernels against their plain versions
    on the card at the main path's shapes (f64 random_8192_8192's phase 1:
    M 8,192 x R 24,576, one slice at one rank): ``seq_fold_column`` and
    ``seq_ratio_colk_sharded`` (with ``seq_rank1``), first on two slices
    of that tableau (a rank that does not own h, a column offset) from 24
    seeded states, then on one from 8 -- taken and skipped pivots, the
    fuse, Bland on, a NaN in b on an eligible row, a tie of the smallest
    quotient on two rows far apart, no eligible row, a tie of the
    smallest cost across the slices -- every scalar, vector, buffer and
    the slices bit for bit after each pivot. Then, on a taken pivot at
    one slice, each against the form before its redesign
    (``tools/seq_variants.cu`` built as a library, ``seq_prior``), bit
    for bit and timed in turns, each alone and the pass after the column
    (``seq_sharded_turns``), then each timed by torch.profiler and by CUDA
    events over a CUDA graph of 50 calls, beside its plain version and
    its bound, and ``seq_ratio_colk_sharded`` beside ``seq_ratio_colk``'s
    record at the same shape; the same turns on a slice of a 1,024 x
    3,072 tableau; then ``seq_fold_column`` from the ranks' edge states at
    P = 1, 3, 8 and 33 (``seq_fold_edges``); then the latency floor
    (``latency_floor``)."""
    import numpy as np
    import torch

    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import seq as ks

    M, R, eps, max_iter = 8192, 24576, 1e-9, 10
    g = torch.Generator(device="cuda").manual_seed(20261022)
    rng = np.random.default_rng(20261022)
    policy = dict(bland_static=False, threshold=50)
    for P, states in ((2, 24), (1, 8)):
        (a_set, b_set), _ = sharded_seq_sets(M, R, P, g, eps)
        R_loc = R // P
        seen = collections.Counter()
        for i in range(states):
            edge = i % 7
            stall = int(rng.integers(0, 60))
            for loops in (a_set, b_set):
                for lp in loops:
                    s = lp.s
                    s.status.fill_(kb.RUNNING)
                    s.iterations.fill_(max_iter if edge == 1 else 3)
                    s.bland.fill_(edge == 2)
                    s.stall.fill_(stall)
                if edge == 6:
                    # The smallest cost twice, in the first slice's and
                    # the last slice's first live column.
                    v = min(float(lp.costs.min()) for lp in loops) - 1.0
                    loops[0].costs[0] = v
                    loops[-1].costs[1 if P == 1 else 0] = v
                    for lp in (loops[0], loops[-1]):
                        ks.pack_candidates(kb.entering_candidates(
                            lp.costs, None, lp.r_loc, eps), lp.shard.offset,
                            lp.send_v, lp.send_i)
            if edge in (3, 4, 5):
                h = fold_h(a_set)
                own, loc = h // R_loc, h % R_loc
                col = a_set[own].Tt[:, loc]
                rows = torch.nonzero(col >= eps).view(-1)
                for loops in (a_set, b_set):
                    lp = loops[own]
                    if edge == 3:
                        for x in loops:
                            x.b[rows[1]] = float("nan")
                    elif edge == 4:
                        lp.Tt[rows[-1], loc] = lp.Tt[rows[0], loc]
                        for x in loops:
                            x.b[rows[-1]] = x.b[rows[0]]
                    else:
                        saved = lp.Tt[:, loc].clone()
                        lp.Tt[:, loc] = -saved.abs()
            sharded_seq_pivot(a_set, True, max_iter, eps, policy)
            sharded_seq_pivot(b_set, False, max_iter, eps, policy)
            tag = f"sharded seq P={P} state {i}"
            for rank, (a, b) in enumerate(zip(a_set, b_set)):
                for name, x in a.s.tensors().items():
                    equal(f"{tag} rank {rank} {name}", x, getattr(b.s, name))
                for name in ("b", "costs", "base", "ah", "colk", "fac",
                             "send_v", "send_i", "recv_v", "recv_i"):
                    equal(f"{tag} rank {rank} {name}", getattr(a, name),
                          getattr(b, name))
                for j in range(0, M, 1024):
                    equal(f"{tag} rank {rank} Tt rows {j}..",
                          a.Tt[j:j + 1024], b.Tt[j:j + 1024])
            s = a_set[0].s
            seen["taken" if bool(s.do) else "skipped"] += 1
            seen["unbounded"] += bool(s.unb)
            for loops in (a_set, b_set):
                for lp in loops:
                    lp.b.nan_to_num_(nan=1.0)
                    lp.s.z.nan_to_num_(nan=0.0)
                if edge == 5:
                    loops[own].Tt[:, loc] = saved
        require(min(seen["taken"], seen["skipped"], seen["unbounded"]) > 0,
                f"the sharded states miss a kind of pivot: {dict(seen)}")
        log(f"sequential sharded kernels (f64, M={M} R={R} in {P} "
            f"slice(s)): every scalar, vector, buffer and slice equal the "
            f"plain versions' on {states} states ({dict(seen)})")
        if P == 2:
            del a_set, b_set
            torch.cuda.empty_cache()

    # A taken pivot far from the fuse, for the timings, at one slice.
    (a,), big = a_set, 2 ** 30
    s = a.s
    s.status.fill_(kb.RUNNING)
    s.iterations.fill_(0)
    s.bland.fill_(False)
    a.recv_v.copy_(a.send_v.view(1, 2))
    a.recv_i.copy_(a.send_i.view(1, 2))
    fold = (lambda: ks.seq_fold_column(a.Tt, a.recv_v, a.recv_i, a.ah, s,
                                       big, eps, 0),
            lambda: ks.seq_fold_column_plain(a.Tt, a.recv_v, a.recv_i,
                                             a.ah, s, big, eps, 0))
    fold[0]()
    ratio = (lambda: ks.seq_ratio_colk_sharded(
                 a.Tt, a.costs, a.b, a.base, a.ah, a.colk, a.fac, s, a.r_loc,
                 eps, big, offset=0, send_v=a.send_v, send_i=a.send_i,
                 **policy),
             lambda: ks.seq_ratio_colk_sharded_plain(
                 a.Tt, a.costs, a.b, a.base, a.ah, a.colk, a.fac, s, a.r_loc,
                 eps, big, 0, a.send_v, a.send_i, **policy))
    ratio[0]()
    require(bool(s.do), "the timed sharded pivot is not taken")
    before = seq_sharded_turns(prior, a, big, eps, policy, fold[0],
                               ratio[0])
    timed = {
        "seq_fold_column": (fold, "seq_fold_column_kernel",
                            bound(2 * M * 8 + 24 + 47)),
        "seq_ratio_colk_sharded": (ratio, "seq_ratio_colk_kernel",
                                   bound(32 * M + 32 * R + 130,
                                         f64_flops=2 * R + 4 * M)),
    }
    for name, ((fn, plain_fn), match, (bound_ms, by)) in timed.items():
        require(kernels_launched(fn) == 1, f"one {name} call launched more "
                "than one kernel")
        prof = [device_ms(fn, 50, match=match) for _ in range(2)]
        rec = records[name] = {
            "max_abs_err": 0.0, "ms": statistics.mean(prof),
            "plain_ms": device_ms(plain_fn, 20), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None, "check_ms": graph_ms(fn),
            **before.get(name, {})}
        log(f"{name} M={M} R={R} f64: " + ", ".join(f"{x:.5f}" for x in prof)
            + f" ms a call (torch.profiler), {rec['check_ms']:.5f} ms by "
            f"CUDA events over a CUDA graph of 50 calls, plain "
            f"{rec['plain_ms']:.4f} ms, bound {bound_ms:.2e} ms ({by})")
    single = records["seq_ratio"]["ms"] + records["seq_colk"]["ms"]
    log(f"seq_ratio_colk_sharded {records['seq_ratio_colk_sharded']['ms']:.5f}"
        f" ms against seq_ratio_colk {single:.5f} ms at the same shape "
        "(seq_ratio's record and seq_colk's, phase_seq_kernels)")
    del a, a_set, b_set
    torch.cuda.empty_cache()
    # The same turns at the 1,024^2 chunk's slice.
    (small, _), _ = sharded_seq_sets(1024, 3072, 1, g, eps)
    (a,) = small
    a.recv_v.copy_(a.send_v.view(1, 2))
    a.recv_i.copy_(a.send_i.view(1, 2))
    s = a.s
    s.iterations.fill_(0)
    fold1 = functools.partial(ks.seq_fold_column, a.Tt, a.recv_v, a.recv_i,
                              a.ah, s, big, eps, 0)
    ratio1 = functools.partial(
        ks.seq_ratio_colk_sharded, a.Tt, a.costs, a.b, a.base, a.ah,
        a.colk, a.fac, s, a.r_loc, eps, big, offset=0, send_v=a.send_v,
        send_i=a.send_i, **policy)
    fold1()
    ratio1()
    require(bool(s.do), "the timed 1,024^2 sharded pivot is not taken")
    seq_sharded_turns(prior, a, big, eps, policy, fold1, ratio1)
    del a, small
    torch.cuda.empty_cache()
    n = seq_fold_edges(prior, M, R, big)
    log(f"seq_fold_column (M={M}, one slice of R={R}): every scalar and the "
        f"column equal the plain version's and the form's before its "
        f"redesign on {n} states (P = 1, 3, 8 and 33; "
        f"{', '.join(FOLD_EDGES)}; the Bland flag off and on; f64, f32/f64 "
        "and f32)")
    latency_floor()


def latency_floor() -> None:
    """The latency floor of a one-thread kernel, by the clocks of the
    other kernels (torch.profiler; CUDA events over a CUDA graph of 50
    calls): ``tools/latency_floor.cu``'s empty kernel, its one-element
    copy (a store that waits on one global load) and its two dependent
    loads (an index, then the element it names), built here by nvcc and
    launched through ctypes on the current stream, each timed twice."""
    import ctypes
    import tempfile

    import torch

    from simplex_tpu_torch.kernels import _build

    with tempfile.TemporaryDirectory() as td:
        lib_path = pathlib.Path(td) / "liblatency.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                        "-o", str(lib_path),
                        str(ROOT / "tools" / "latency_floor.cu")],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.latency_empty_launch.argtypes = [P]
    lib.latency_load_launch.argtypes = [P, P, P]
    lib.latency_chain_launch.argtypes = [P, P, P, P]
    buf = torch.zeros(64, dtype=torch.int32, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(err):
        require(err == 0, f"the latency probe's launch failed ({err})")

    fns = {
        "empty": (lambda: checked(lib.latency_empty_launch(stream())),
                  "latency_empty_kernel"),
        "one load": (lambda: checked(lib.latency_load_launch(
            buf.data_ptr(), buf.data_ptr() + 128, stream())),
            "latency_load_kernel"),
        "two dependent loads": (lambda: checked(lib.latency_chain_launch(
            buf.data_ptr(), buf.data_ptr() + 64, buf.data_ptr() + 192,
            stream())), "latency_chain_kernel"),
    }
    out = []
    for name, (fn, match) in fns.items():
        prof = [device_ms(fn, 50, match=match) for _ in range(2)]
        graph = [graph_ms(fn) for _ in range(2)]
        out.append(f"{name} " + ", ".join(f"{1e3 * x:.3f}" for x in prof)
                   + " us (torch.profiler), " + ", ".join(
                       f"{1e3 * x:.3f}" for x in graph)
                   + " us (CUDA graph of 50 calls)")
    torch.cuda.synchronize()
    log("latency floor of a one-thread kernel (tools/latency_floor.cu): "
        + "; ".join(out))


#: The nodes of a chunk's graph by name (torch.profiler's kernel names).
SEQ_GRAPH_KERNELS = ("seq_step_pre_kernel", "seq_ratio_colk_kernel",
                     "seq_ratio_snapshot_kernel", "batch_rank1_tiles",
                     "fused_pivot_tiles")


def chunk_stats(events: list, chunk: int,
                names: tuple | None = SEQ_GRAPH_KERNELS) -> dict:
    """From a chrome trace's kernel events, the replayed chunks of a
    traced sequential loop: a chunk runs from one ``seq_step_pre`` to the
    kernel before the next. Returns the chunks' count, the (min, max)
    kernels a pivot, the (min, median, max) busy share inside a chunk
    (the time some kernel of it runs over the span from its first
    kernel's start to its last one's end) and over a chunk's period
    (step_pre to step_pre, the host read included), and the middle
    chunk's kernels by name, their us a pivot by name and in all (a
    kernel's time from its start: under a programmatic dependent launch
    it includes its wait for the kernel before), and its span. The last
    chunk (no period)
    counts inside only. ``names`` None takes every kernel of the trace
    (those of no name in ``SEQ_GRAPH_KERNELS`` or ``BLOCKED_GRAPH_KERNELS``
    by their own names, cut to 40 characters), else those whose name
    holds one of ``names``."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and (names is None
                           or any(n in e["name"] for n in names))),
                     key=lambda e: e["ts"])
    chunks: list = []
    for e in kernels:
        if "seq_step_pre" in e["name"]:
            chunks.append([])
        if chunks:
            chunks[-1].append(e)
    require(len(chunks) >= 3, f"the trace holds {len(chunks)} chunks")
    per_pivot = [len(c) / chunk for c in chunks]

    def busy(c):
        # The time some kernel of the chunk runs: the union of their
        # intervals (kernels launched as programmatic dependent launches
        # overlap the one before).
        total, end = 0.0, float("-inf")
        for e in c:
            lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
        return total

    inside, period = [], []
    for i, c in enumerate(chunks):
        span = max(e["ts"] + e["dur"] for e in c) - c[0]["ts"]
        inside.append(busy(c) / span)
        if i + 1 < len(chunks):
            period.append(busy(c) / (chunks[i + 1][0]["ts"] - c[0]["ts"]))
    mid = chunks[len(chunks) // 2]

    def spread(x):
        return min(x), statistics.median(x), max(x)

    def kind(e):
        return next((n for n in (*SEQ_GRAPH_KERNELS, *BLOCKED_GRAPH_KERNELS)
                     if n in e["name"]), e["name"][:40])

    by_name: dict = collections.defaultdict(float)
    for e in mid:
        by_name[kind(e)] += e["dur"] / chunk

    return dict(
        chunks=len(chunks), per_pivot=(min(per_pivot), max(per_pivot)),
        inside=spread(inside), period=spread(period),
        names=dict(collections.Counter(kind(e) for e in mid)),
        us_by_name=dict(by_name),
        us_pivot=sum(e["dur"] for e in mid) / chunk,
        span_us=max(e["ts"] + e["dur"] for e in mid) - mid[0]["ts"])


def phase_chunk_trace() -> None:
    """The default-option random_1024_1024 and K6's random_2048_2048, each
    solve's phase-1 loop call traced by torch.profiler (CUDA activity):
    the kernels each replayed chunk holds a pivot (``seq_nodes``), the
    device's busy share inside a chunk and over a chunk's period (its
    kernels' time from its ``seq_step_pre`` to the next's: the host's read
    of status and the next replay included). Runs after every timed
    solve."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import solver

    for label, n, opts, pallas in (("f64", 1024, {}, False),
                                   ("f32 K6", 2048, K6_OPTS, True)):
        name = "solve_loop_pallas" if pallas else "solve_loop"
        real = getattr(solver, name)
        first = []

        def loop(*args, real=real, first=first, **kw):
            if first:
                return real(*args, **kw)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = real(*args, **kw)
                torch.cuda.synchronize()
            first.append((prof, out[2]))
            return out

        def run(name=name, real=real, loop=loop, first=first, n=n,
                opts=opts):
            first.clear()
            setattr(solver, name, loop)
            try:
                timed_solve(benchmark_problem(n), opts)
            finally:
                setattr(solver, name, real)
            return first[0]

        prof, pivots = until_traced(run, f"{label} chunk trace")
        with tempfile.TemporaryDirectory() as td:
            path = pathlib.Path(td) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        w = chunk_stats(events, solver.SEQ_CHUNK)
        want = seq_nodes() / solver.SEQ_CHUNK
        require(w["per_pivot"] == (want, want), f"{w['per_pivot']} kernels "
                f"a pivot in the traced chunks, not {want}")
        log(f"{label} random_{n}_{n} phase-1 loop traced ({pivots} pivots, "
            f"{w['chunks']} chunks): {w['per_pivot'][0]:.5f} kernels a "
            f"pivot in every replayed chunk (the middle one: {w['names']}); "
            f"device busy inside a chunk {100 * w['inside'][0]:.1f}-"
            f"{100 * w['inside'][2]:.1f}% (median "
            f"{100 * w['inside'][1]:.1f}%), over a chunk's period with the "
            f"host read {100 * w['period'][0]:.1f}-"
            f"{100 * w['period'][2]:.1f}% (median "
            f"{100 * w['period'][1]:.1f}%); the middle chunk's kernels "
            f"{w['us_pivot']:.2f} us a pivot ("
            + ", ".join(f"{n} {us:.3f}" for n, us in w["us_by_name"].items())
            + f"), its span {w['span_us']:.1f} us")


#: The plain blocked loop's kernels in its window graph by name (the
#: apply's cuBLAS kernels go by their own names).
BLOCKED_GRAPH_KERNELS = ("eta_ratio_kernel", "eta_colk_kernel")


def phase_blocked_trace() -> None:
    """random_2048_2048 with ``BLOCKED_F64``, its phase-1 loop call traced
    by torch.profiler (CUDA activity): every kernel of each replayed window
    (``seq_step_pre``, L of ``eta_ratio`` and of ``eta_colk``, and the
    apply's cuBLAS kernels), the nodes a pivot, the device's busy share
    inside a window and over a window's period (its kernels' time from its
    ``seq_step_pre`` to the next's: the host's read of status and the next
    replay included). Runs after every timed solve."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import solver

    L = BLOCKED_F64["block_pivots"]
    real = solver.solve_loop_blocked
    first: list = []

    def loop(*args, **kw):
        if first:
            return real(*args, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kw)
            torch.cuda.synchronize()
        first.append((prof, out[2]))
        return out

    def run():
        first.clear()
        solver.solve_loop_blocked = loop
        try:
            timed_solve(benchmark_problem(2048), BLOCKED_F64)
        finally:
            solver.solve_loop_blocked = real
        return first[0]

    prof, pivots = until_traced(run, "plain blocked window trace")
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    w = chunk_stats(events, L, names=None)
    names = w["names"]
    require(names.get("seq_step_pre_kernel") == 1
            and names.get("eta_ratio_kernel") == L
            and names.get("eta_colk_kernel") == L,
            f"the middle window holds {names}, not 1 seq_step_pre and "
            f"{L} of eta_ratio and of eta_colk")
    log(f"f64 L={L} random_2048_2048 phase-1 loop traced ({pivots} pivots, "
        f"{w['chunks']} windows): {w['per_pivot'][0]:.5f}-"
        f"{w['per_pivot'][1]:.5f} nodes a pivot in the replayed windows "
        f"(the middle one: {names}); device busy inside a window "
        f"{100 * w['inside'][0]:.1f}-{100 * w['inside'][2]:.1f}% (median "
        f"{100 * w['inside'][1]:.1f}%), over a window's period with the "
        f"host read {100 * w['period'][0]:.1f}-{100 * w['period'][2]:.1f}%"
        f" (median {100 * w['period'][1]:.1f}%); the middle window's "
        f"kernels {w['us_pivot']:.2f} us a pivot ("
        + ", ".join(f"{n} {us:.3f}" for n, us in w["us_by_name"].items())
        + f"), its span {w['span_us']:.1f} us = {w['span_us'] / L:.2f} us "
        "a pivot")

    # Which call launches the window's kernels of PyTorch's own: the
    # apply, alone, traced eagerly at the window's shapes.
    native = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                     and "at::native" in e["name"]})
    M, R = 2048, 6144
    f64 = dict(dtype=torch.float64, device="cuda")
    Tt, F, C = (torch.zeros(shape, **f64) for shape in ((M, R), (L, M),
                                                         (L, R)))
    apply = functools.partial(Tt.addmm_, F.t(), C, alpha=-1.0)
    try:
        prof = traced(apply, 5, "the window's apply")
        launched = sorted({e.key for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA})
    except SmokeFailure:
        launched = ["not traced: every profiler trace came back empty"]
    log(f"the window's at::native kernels: {native}; Tt.addmm_(F.t(), C, "
        f"alpha=-1) alone at M={M} R={R} L={L} f64 launches {launched}")


def eta_edge_walk(a, b, ts, cap: int, eps: float, policy: dict,
                  tag: str) -> collections.Counter:
    """Two ``solver.BlockedLoop``s of one state, the kernels on ``a`` and
    the plain versions on ``b``, pivot by pivot over the window depths
    ``ts`` from edge states by the pivot's index (Bland on, the fuse, a
    NaN in b, no eligible row, a weight past the re-anchor's bound, taken
    pivots): every scalar, vector and factor required bit for bit after
    each pivot. Returns the kinds of pivot seen, each required once."""
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import eta as ke

    M = a.Tt.shape[0]
    seen = collections.Counter()
    for t in ts:
        edge = t % 7
        saved = None
        for lp in (a, b):
            s = lp.s
            if edge == 1:
                s.bland.fill_(True)
            elif edge == 2:
                s.iterations.fill_(cap)
            elif edge == 3:
                lp.b[(t * 37) % M] = float("nan")
            elif edge == 4:
                h = int(s.h)
                saved = (h, lp.Tt[:, h].clone())
                lp.Tt[:, h] = -1e6
            elif edge == 5:
                lp.w[lp.r - 1] = 3e8
            kb.step_pre_plain(s, cap, eps)
        for lp, kernel in ((a, True), (b, False)):
            s = lp.s
            if kernel:
                ke.eta_ratio(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t, eps,
                             lp.ws)
                ke.eta_colk(lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base,
                            lp.w, lp.ah, s, t, lp.r, eps, cap, lp.ws,
                            then_pre=True, **policy)
            else:
                ke.eta_ratio_plain(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t, eps)
                ke.eta_colk_plain(lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base,
                                  lp.w, lp.ah, s, t, lp.r, eps, cap,
                                  then_pre=True, **policy)
        where = f"{tag} pivot t={t} (edge {edge})"
        for name, x in a.s.tensors().items():
            equal(f"{where} {name}", x, getattr(b.s, name))
        for name in ("b", "costs", "base", "w", "ah", "C", "F"):
            equal(f"{where} {name}", getattr(a, name), getattr(b, name))
        seen["taken" if bool(a.s.do) else "skipped"] += 1
        seen["unbounded"] += bool(a.s.unb)
        seen["re-anchored"] += bool((a.w == 1).all())
        for lp in (a, b):
            if saved is not None:
                lp.Tt[:, saved[0]] = saved[1]
            lp.s.status.fill_(kb.RUNNING)
            lp.s.iterations.fill_(0)
            lp.b.nan_to_num_(nan=1.0)
            lp.s.z.nan_to_num_(nan=0.0)
    require(min(seen["taken"], seen["skipped"], seen["unbounded"],
                seen["re-anchored"]) > 0,
            f"{tag}: the states miss a kind of pivot: {dict(seen)}")
    return seen


def eta_odd_loops(M: int, R: int, L: int, eps: float, seed: int):
    """Two ``solver.BlockedLoop``s of one seeded random state of the mixed
    pair (f32 tableau, f64 vectors) at M x R, devex: Tt, every factor row,
    b > 0, the costs, the weights at 1, a basis, the candidates folded."""
    import numpy as np
    import torch

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    rng = np.random.default_rng(seed)

    def uni(shape, lo, hi, dt):
        return torch.from_numpy(rng.uniform(lo, hi, shape)).to("cuda", dt)

    f32, f64 = torch.float32, torch.float64
    state = dict(Tt=uni((M, R), -1, 1, f32), C=uni((L, R), -0.1, 0.1, f32),
                 F=uni((L, M), -0.1, 0.1, f32), b=uni(M, 0, 1, f64),
                 costs=uni(R, -1, 1, f64),
                 base=torch.from_numpy(rng.integers(0, R, M)).to(
                     "cuda", torch.int32))
    loops = []
    for _ in range(2):
        lp = solver.BlockedLoop(
            **{n: x.clone() for n, x in state.items()},
            w=torch.ones(R, dtype=f64, device="cuda"),
            ah=torch.zeros(M, dtype=f32, device="cuda"),
            ws=ke.eta_workspace(M, R, "cuda"),
            s=ks.seq_scalars(torch.zeros((), dtype=f64, device="cuda"),
                             False, f32),
            r=R - 1, costs0=None)
        ks.set_candidates(lp.s, ke.eta_candidates(lp.costs, lp.w, lp.r, eps))
        loops.append(lp)
    return loops


def eta_timings(records: dict | None, lp, t: int, eps: float, cap: int,
                policy: dict, label: str) -> None:
    """Each eta kernel at window depth t on ``lp`` (a taken pivot: the step
    before, then ``eta_ratio``, is run first) timed by torch.profiler and
    by CUDA events over a CUDA graph of 50 calls, beside its plain
    version, ``torch.addmv`` forming the live column (or row) alone in
    f64, and its bound (``bench.pivot_work``'s K1 and K2 entries at this
    shape and depth, f64); logged, and with ``records`` the kernels
    line's rows."""
    import torch

    from simplex_tpu_torch.bench import pivot_work
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    a, s = lp, lp.s
    M, R = a.Tt.shape
    L = a.C.shape[0]
    s.bland.fill_(False)
    ks.seq_step_pre(s, cap, eps)
    ke.eta_ratio(a.Tt, a.C, a.F, a.b, a.ah, s, t, eps, a.ws)
    require(bool(s.do), f"{label}: the timed pivot is not taken")
    h, k = int(s.h), int(s.k)
    work = pivot_work(M, R, L, t, True, 8)
    live = {
        "eta_ratio": functools.partial(torch.addmv, a.Tt[:, h], a.F[:t].t(),
                                       a.C[:t, h], alpha=-1.0),
        "eta_colk": functools.partial(torch.addmv, a.Tt[k], a.C[:t].t(),
                                      a.F[:t, k], alpha=-1.0)}
    close(f"{label} eta_ratio's column vs addmv", live["eta_ratio"](), a.ah,
          1e-9 * (1 + a.ah.abs()))
    timed = {
        "eta_ratio": (lambda: ke.eta_ratio(a.Tt, a.C, a.F, a.b, a.ah, s,
                                           t, eps, a.ws),
                      lambda: ke.eta_ratio_plain(a.Tt, a.C, a.F, a.b, a.ah,
                                                 s, t, eps),
                      "eta_ratio_kernel", bound(*work["ah_ratio"])),
        "eta_colk": (lambda: ke.eta_colk(a.Tt, a.C, a.F, a.costs, a.b,
                                         a.base, a.w, a.ah, s, t, a.r,
                                         eps, cap, a.ws, then_pre=False,
                                         **policy),
                     lambda: ke.eta_colk_plain(a.Tt, a.C, a.F, a.costs, a.b,
                                               a.base, a.w, a.ah, s, t,
                                               a.r, eps, cap, then_pre=False,
                                               **policy),
                     "eta_colk_kernel", bound(*work["colk_costs"])),
    }
    for name, (fn, plain_fn, match, (bound_ms, by)) in timed.items():
        require(kernels_launched(fn) == 1, f"one {name} call launched "
                "more than one kernel")
        ms = device_ms(fn, 50, match=match)
        rec = {"max_abs_err": 0.0, "ms": ms,
               "plain_ms": device_ms(plain_fn, 5),
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": device_ms(live[name], 50),
               "check_ms": graph_ms(fn)}
        if records is not None:
            records[name] = rec
        log(f"{name} {label} M={M} R={R} t={t}: {ms:.5f} ms a call "
            f"(torch.profiler), {rec['check_ms']:.5f} ms by CUDA events "
            f"over a CUDA graph of 50 calls, plain {rec['plain_ms']:.4f} "
            f"ms, addmv forming the live {'column' if name == 'eta_ratio' else 'row'} "
            f"{rec['library_ms']:.5f} ms, bound {bound_ms:.5f} ms ({by}), "
            f"{100 * bound_ms / ms:.1f}% of it; {nvidia_smi_line()}")


def phase_eta_kernels(records: dict) -> None:
    """The plain blocked loop's kernels against their plain versions on the
    card at the main path's shape: the f64 phase-1 tableau of
    random_2048_2048 (M 2,048 x R 6,144), L=128, under devex (the full f64
    re-solve's rule), two ``BlockedLoop``s, the kernels on one and the
    plain versions on the other, pivot by pivot through the window's first
    ``ETA_T`` pivots from edge states (``eta_edge_walk``): every scalar,
    vector and factor bit for bit. The same through a whole window of 128
    pivots at the mixed pair's ``ETA_ODD`` shape from a seeded random
    state, whose slab rows start off 16-byte boundaries. Then at t =
    ``ETA_T``, the window's mean live depth, on a taken pivot, each kernel
    timed (``eta_timings``) at 2048^2 -- the kernels line's rows -- and on
    the f64 phase-1 tableau of random_8192_8192 (M 8,192 x R 24,576)."""
    import dataclasses

    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    opts = st.SolverOptions(**BLOCKED_F64, pivot_rule="devex")
    eps = float(opts.eps_resolved)
    policy = dict(bland_static=False, threshold=opts.bland_threshold)
    cap = 10_000

    def phase1_loops(n: int, copies: int):
        p = benchmark_problem(n)
        tab = gaussian_eliminate(build_phase1(
            torch.as_tensor(p.A, device="cuda"),
            torch.as_tensor(p.b, device="cuda"), p.vars, p.constraints,
            opts))
        return [solver.blocked_loop(
            dataclasses.replace(tab, Tt=tab.Tt.clone()), opts)
            for _ in range(copies)]

    a, b = phase1_loops(2048, 2)
    M, R = a.Tt.shape
    L = a.C.shape[0]
    for lp, kernel in ((a, True), (b, False)):
        (ks.seq_step_pre if kernel else kb.step_pre_plain)(lp.s, cap, eps)
    seen = eta_edge_walk(a, b, range(ETA_T), cap, eps, policy, "eta")
    log(f"eta kernels (f64, devex, M={M} R={R} L={L}): every scalar, "
        f"vector and factor equal the plain versions' over pivots t = 0.."
        f"{ETA_T - 1} ({dict(seen)})")

    odd = eta_odd_loops(*ETA_ODD, L, eps, seed=24)
    for lp, kernel in zip(odd, (True, False)):
        (ks.seq_step_pre if kernel else kb.step_pre_plain)(lp.s, cap, eps)
    seen = eta_edge_walk(*odd, range(L), cap, eps, policy, "eta odd")
    log(f"eta kernels (f32/f64, devex, M={ETA_ODD[0]} R={ETA_ODD[1]} "
        f"L={L}, slab rows off 16-byte boundaries): every scalar, vector "
        f"and factor equal the plain versions' over pivots t = 0..{L - 1} "
        f"({dict(seen)})")
    del odd, b
    torch.cuda.empty_cache()

    eta_timings(records, a, ETA_T, eps, cap, policy, "f64")
    del a
    torch.cuda.empty_cache()
    (big,) = phase1_loops(8192, 1)
    eta_timings(None, big, ETA_T, eps, cap, policy, "f64")
    del big
    torch.cuda.empty_cache()


#: The nodes of the sequential sharded loop's chunk graph by name: its
#: kernels, and NCCL's collectives, kernels or device-to-device copies
#: (at one rank an all_gather is a copy, the all_reduce no node).
SHARDED_SEQ_KERNELS = ("seq_fold_column_kernel", "seq_ratio_colk_kernel",
                       "batch_rank1_tiles")
SHARDED_SEQ_NODES = (*SHARDED_SEQ_KERNELS, "nccl", "Memcpy DtoD")


def sharded_chunk_stats(events: list, chunk: int) -> dict:
    """From a chrome trace's events (kernels and copies), the replayed
    chunks of a traced sequential sharded loop: a chunk runs from the
    collectives before its first ``seq_fold_column`` to its ``chunk``-th
    ``seq_rank1`` (the loop's first pack, before its first chunk, and the
    host read's copies fall outside). Returns the chunks' count, the (min,
    max) kernels and collective nodes a pivot, the (min, median, max) busy
    share inside a chunk (its nodes' time over the span from its first
    node's start to its last one's end) and over a chunk's period (to the
    next chunk's first node: the host read included), and the middle
    chunk's nodes by name, their us a pivot and its span."""
    def kind(e):
        return next(n for n in SHARDED_SEQ_NODES if n in e["name"])

    nodes = sorted((e for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy")
                    and any(n in e["name"] for n in SHARDED_SEQ_NODES)),
                   key=lambda e: e["ts"])
    first = next(i for i, e in enumerate(nodes)
                 if kind(e) == "seq_fold_column_kernel")
    start = first
    while (start > 0 and first - start < 2
           and kind(nodes[start - 1]) not in SHARDED_SEQ_KERNELS):
        start -= 1
    chunks, cur, rank1 = [], [], 0
    for e in nodes[start:]:
        cur.append(e)
        if kind(e) == "batch_rank1_tiles":
            rank1 += 1
            if rank1 == chunk:
                chunks.append(cur)
                cur, rank1 = [], 0
    require(len(chunks) >= 3 and not cur, f"the trace holds {len(chunks)} "
            f"whole chunks and {len(cur)} nodes past them")
    kernels = [sum(kind(e) in SHARDED_SEQ_KERNELS for e in c) / chunk
               for c in chunks]
    colls = [sum(kind(e) not in SHARDED_SEQ_KERNELS for e in c) / chunk
             for c in chunks]
    inside, period = [], []
    for i, c in enumerate(chunks):
        span = max(e["ts"] + e["dur"] for e in c) - c[0]["ts"]
        inside.append(sum(e["dur"] for e in c) / span)
        if i + 1 < len(chunks):
            period.append(sum(e["dur"] for e in c)
                          / (chunks[i + 1][0]["ts"] - c[0]["ts"]))
    mid = chunks[len(chunks) // 2]

    def spread(x):
        return min(x), statistics.median(x), max(x)

    by_name: dict = collections.defaultdict(float)
    for e in mid:
        by_name[kind(e)] += e["dur"] / chunk
    return dict(
        chunks=len(chunks), kernels=(min(kernels), max(kernels)),
        colls=(min(colls), max(colls)), inside=spread(inside),
        period=spread(period),
        names=dict(collections.Counter(kind(e) for e in mid)),
        us_by_name=dict(by_name),
        us_pivot=sum(e["dur"] for e in mid) / chunk,
        span_us=max(e["ts"] + e["dur"] for e in mid) - mid[0]["ts"])


def phase_sharded_seq_trace() -> None:
    """The default-option random_1024_1024 through ``solve_sharded`` at one
    NCCL rank, its phase-1 sequential sharded loop call traced by
    torch.profiler (CUDA activity): the kernels a pivot of each replayed
    chunk (3: ``SHARDED_SEQ_KERNELS``) and NCCL's nodes a pivot, the
    device's busy share inside a chunk and over its period (the host's
    read of status included). Runs after every timed solve."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    real = ps.solve_loop_sharded
    first = []

    def loop(*args, **kw):
        if first:
            return real(*args, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kw)
            torch.cuda.synchronize()
        first.append((prof, out[2]))
        return out

    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        def run():
            first.clear()
            ps.solve_loop_sharded = loop
            try:
                timed_sharded(benchmark_problem(1024), group, {})
            finally:
                ps.solve_loop_sharded = real
            return first[0]

        prof, pivots = until_traced(run, "the sharded chunk trace")
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    w = sharded_chunk_stats(events, solver.SEQ_CHUNK)
    require(w["kernels"] == (3.0, 3.0), f"{w['kernels']} kernels a pivot in "
            "the traced sharded chunks, not 3")
    log(f"sharded 1-rank f64 random_1024_1024 phase-1 loop traced ({pivots}"
        f" pivots, {w['chunks']} chunks): {w['kernels'][0]:.5f} kernels and "
        f"{w['colls'][0]:.5f}-{w['colls'][1]:.5f} NCCL nodes a pivot in "
        f"every replayed chunk (the middle one: {w['names']}); device busy "
        f"inside a chunk {100 * w['inside'][0]:.1f}-"
        f"{100 * w['inside'][2]:.1f}% (median {100 * w['inside'][1]:.1f}%), "
        f"over a chunk's period with the host read "
        f"{100 * w['period'][0]:.1f}-{100 * w['period'][2]:.1f}% (median "
        f"{100 * w['period'][1]:.1f}%); the middle chunk's nodes "
        f"{w['us_pivot']:.2f} us a pivot ("
        + ", ".join(f"{n} {us:.3f}" for n, us in w["us_by_name"].items())
        + f"), its span {w['span_us']:.1f} us; {nvidia_smi_line()}")


def phase_r1024() -> None:
    res, wall = timed_solve(benchmark_problem(1024))
    check_certified("random_1024_1024", res, OBJ_1024)
    log(f"random_1024_1024: OPTIMAL certified objective {res.objective!r} "
        f"pivots {res.iterations_phase1}+{res.iterations_phase2} "
        f"refine {res.refine.method} wall {wall:.3f} s")


def phase_flagship(launches: dict) -> tuple:
    """The production flagship; returns its walk and the warm solves'
    median wall."""
    from simplex_tpu_torch.kernels import blocked as kb

    p = benchmark_problem(8192)
    kb.reset_launches()
    res, wall = timed_solve(p)
    launches.update(kb.LAUNCHES)
    check_certified("random_8192_8192", res, OBJ_8192)
    walk = (res.iterations_phase1, res.iterations_phase2)
    require(walk == FLAGSHIP_WALK, f"flagship walked {walk}, recorded "
            f"{FLAGSHIP_WALK}")
    pivots = sum(walk)
    log(f"flagship random_8192_8192: OPTIMAL certified objective "
        f"{res.objective!r} (golden {OBJ_8192!r}); pivots "
        f"{walk[0]}+{walk[1]}; refine {res.refine.method}; wall "
        f"{wall:.3f} s; {1e3 * wall / pivots:.4f} ms/pivot; launches "
        f"{launches}")
    # K4 takes the off-cadence windows (reprice_every=2), so all four run.
    for name in SINGLE_PATH:
        require(launches[name] > 0, f"{name} never launched on the path")
    warm = []
    for i in range(1, FLAGSHIP_SOLVES):
        res, wall = timed_solve(p)
        check_certified("random_8192_8192", res, OBJ_8192)
        again = (res.iterations_phase1, res.iterations_phase2)
        require(again == walk, f"flagship solve {i + 1} walked {again}, "
                f"the first {walk}")
        warm.append(wall)
        log(f"flagship warm solve {i}: wall {wall:.3f} s")
    median = statistics.median(warm)
    log(f"flagship warm solves: {len(warm)}, wall min {min(warm):.3f} "
        f"median {median:.3f} max {max(warm):.3f} s; median "
        f"{1e3 * median / pivots:.4f} ms/pivot")
    return walk, median


#: The kernels a replayed window holds (K1 and K2, each with its tail, and
#: step_pre).
GRAPH_KERNELS = ("ah_ratio_fused", "colk_costs_fused", "step_pre_kernel")
#: The nodes of the sharded loop's window graph by name: K5 (K1's kernel
#: without its ratio test, with its head), K2 (with its tails), the
#: sharded step kernels (sharded_pack, the boundary's, counted should one
#: appear), and NCCL's collectives, kernels or device-to-device copies.
#: The graph's first and last nodes bound a replayed window: the
#: boundary's own collectives, pack and fold fall outside.
SHARDED_GRAPH_KERNELS = ("ah_ratio_fused", "colk_costs_fused",
                         "sharded_step_pre", "sharded_ratio", "sharded_pack",
                         "sharded_fold", "nccl", "Memcpy DtoD")
SHARDED_GRAPH_SPAN = ("sharded_step_pre", "sharded_fold")


def flagship_loops(p, graph: bool, keep: list | None = None,
                   against: list | None = None, group=None,
                   tails: bool = True) -> dict:
    """One production ``solve`` of the flagship ``p`` with its kernel loop
    replaying one CUDA graph a window (``graph``) or enqueuing the same
    kernels eagerly (``graph=False``): the walk (``FLAGSHIP_WALK``), the
    solve's wall, each loop call's wall (host clock between two
    synchronizes) and pivots, each capture's ms (``capture_window``: the
    capture and the graph's instantiation) and the collectives counted.
    Each loop call's final state -- Tt, b, costs, z, base, the devex
    weights, status and iterations -- is appended to ``keep`` as copies,
    or held to ``against``'s bit for bit. With ``group`` the same for
    ``solve_sharded`` on that group and its sharded kernel loop
    (``solve_loop_blocked_kernel_sharded``). Single-card with ``tails``
    (the production window), each captured window must hold 2L + 1
    kernels by its launch counts: K1 and K2 with their tails a pivot and
    ``step_pre`` once."""
    import torch

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    mod, names = (solver, ("solve_loop_blocked_kernel", "kernel_loop",
                           "capture_window"))
    if group is not None:
        mod, names = (ps, ("solve_loop_blocked_kernel_sharded",
                           "sharded_kernel_loop", "capture_window_sharded"))
    real = tuple(getattr(mod, name) for name in names)
    loops, calls, captures, per_pivot = [], [], [], []

    def kernel_loop(*args, **kw):
        loops.append(real[1](*args, **kw))
        return loops[-1]

    def capture(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[2](*args, **kw)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - t0))
        L = PROD["block_pivots"]
        if group is not None:
            # The window's collectives are inside its graph, and its nodes
            # at one rank are its kernels -- K5, sharded_ratio and K2 a
            # pivot, sharded_step_pre and sharded_fold once, K5's head and
            # K2's tails (the step after K2, the pack) none of their own,
            # sharded_pack none -- and a copy an all_gather: 5L + 2.
            want = {"all_reduce": L, "all_gather": 2 * L}
            require(dict(out[2].counts) == want, f"the sharded window graph "
                    f"holds {dict(out[2].counts)}, not {want}")
            per = out[1].per_replay
            nodes = sum(n for name, n in per.items()
                        if name not in kb.TAILS) + want["all_gather"]
            require(nodes == 5 * L + 2
                    and per["sharded_post_tail"] == L
                    and per["sharded_pack_tail"] == L
                    and per["sharded_pack"] == 0
                    and per["sharded_fold_head"] == L - 1,
                    f"the sharded window graph holds {per}, not 5L + 2 "
                    "nodes")
            per_pivot.append(nodes / L)
        elif tails:
            # K1 and K2, each with its tail, a pivot and step_pre once: a
            # tail launches nothing of its own.
            per = out[1].per_replay
            nodes = sum(n for name, n in per.items() if name not in kb.TAILS)
            require(nodes == 2 * L + 1
                    and all(per[tail] == L for tail in STEPS[1:]),
                    f"the window graph holds {per}, not 2L + 1 kernels")
            per_pivot.append(nodes / L)
        return out

    def loop(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st, it = real[0](*args, graph=graph)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, it))
        final = {"Tt": out.Tt, "b": out.b, "costs": out.costs, "z": out.z,
                 "base": out.base, "w": loops[-1].w,
                 "status": torch.tensor(st), "iterations": torch.tensor(it)}
        if keep is not None:
            keep.append({k: v.clone() for k, v in final.items()})
        if against is not None:
            for name, want in against[len(calls) - 1].items():
                equal(f"flagship loop call {len(calls)} {name}, graph "
                      f"{graph}", final[name], want)
        return out, st, it

    for name, fn in zip(names, (loop, kernel_loop, capture)):
        setattr(mod, name, fn)
    pg.reset_counts()
    try:
        if group is None:
            res, wall = timed_solve(p)
        else:
            res, wall = timed_sharded(p, group, PROD)
    finally:
        for name, fn in zip(names, real):
            setattr(mod, name, fn)
    check_certified("random_8192_8192", res, OBJ_8192)
    walk = (res.iterations_phase1, res.iterations_phase2)
    require(walk == FLAGSHIP_WALK, f"flagship (graph {graph}) walked {walk}, "
            f"recorded {FLAGSHIP_WALK}")
    require(len(captures) == (len(calls) if graph else 0),
            f"{len(captures)} captures in {len(calls)} loop calls")
    loop_s = sum(c[0] for c in calls)
    pivots = sum(c[1] for c in calls)
    return dict(wall=wall, loop_s=loop_s, pivots=pivots, calls=calls,
                captures=captures, ms_pivot=1e3 * loop_s / pivots,
                collectives=dict(pg.COUNTS), per_pivot=per_pivot)


def phase_window_graph(group=None) -> None:
    """The production flagship through ``solve`` two ways, in turns --
    eager, graph, graph, eager: the kernel loop enqueuing its kernels
    eagerly (``solve_loop_blocked_kernel(graph=False)``) and replaying
    one CUDA graph a window. Every run walks ``FLAGSHIP_WALK`` and every
    loop call (phase 1 and phase 2) ends with the first eager run's Tt,
    b, costs, z, base and devex weights bit for bit. Prints each run's
    loop ms/pivot, solve wall and capture ms. With ``group`` the same
    through ``solve_sharded`` on it (the sharded kernel loop, its NCCL
    collectives inside the graph), each run also counting the same
    collectives."""
    import statistics as stats

    p = benchmark_problem(8192)
    keep: list = []
    ms = {False: [], True: []}
    colls = []
    what = "flagship" if group is None else "sharded flagship, 1 NCCL rank"
    for i, graph in enumerate((False, True, True, False)):
        r = flagship_loops(p, graph, keep=None if i else keep,
                           against=keep if i else None, group=group)
        ms[graph].append(r["ms_pivot"])
        colls.append(r["collectives"])
        log(f"{what}, loop {'graph' if graph else 'eager'}: "
            f"{r['ms_pivot']:.4f} ms/pivot over {r['pivots']} pivots "
            f"(loop calls " + ", ".join(f"{1e3 * c[0]:.1f} ms / {c[1]}"
                                        for c in r["calls"])
            + f"); solve wall {r['wall']:.3f} s; captures "
            + (", ".join(f"{c:.2f}" for c in r["captures"]) or "none")
            + " ms" + (f"; collectives {r['collectives']}" if group
                       is not None else "")
            + ("; nodes a pivot of each captured window (launch counts"
               + (", a copy an all_gather" if group is not None else "")
               + ") "
               + ", ".join(f"{x:.4f}" for x in r["per_pivot"])
               if r["per_pivot"] else "")
            + ("" if i else "; the final state kept"))
    del keep
    require(all(c == colls[0] for c in colls),
            f"{what}: the runs counted other collectives: {colls}")
    log(f"{what} loop: eager {ms[False][0]:.4f} / {ms[False][1]:.4f}, "
        f"graph {ms[True][0]:.4f} / {ms[True][1]:.4f} ms/pivot; eager / "
        f"graph {stats.mean(ms[False]) / stats.mean(ms[True]):.2f}x; every "
        "run walked the recorded pivots, every loop call's final state "
        "bit for bit the first eager run's")


def phase_window_trace(group=None) -> None:
    """One production flagship ``solve`` with its phase-1 loop call traced
    by torch.profiler (CUDA activity): the kernels each replayed window
    holds a pivot (``GRAPH_KERNELS``), the device's busy share inside a
    replayed window (its kernels' time over the span from its first
    kernel's start to its last one's end), and over the window's whole
    period, boundary included (window apply to window apply). Runs after
    every timed solve. With ``group`` the same for ``solve_sharded`` on
    it, whose window graph also holds the NCCL collectives
    (``SHARDED_GRAPH_KERNELS``; copies counted as kernels)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.parallel import sharded as ps

    mod, name = ((solver, "solve_loop_blocked_kernel") if group is None
                 else (ps, "solve_loop_blocked_kernel_sharded"))
    real = getattr(mod, name)
    first = []

    def loop(*args, **kw):
        if first:
            return real(*args, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kw)
            torch.cuda.synchronize()
        first.append((prof, out[2]))
        return out

    p = benchmark_problem(8192)

    def run():
        first.clear()
        setattr(mod, name, loop)
        try:
            if group is None:
                timed_solve(p)
            else:
                timed_sharded(p, group, PROD)
        finally:
            setattr(mod, name, real)
        return first[0]

    prof, pivots = until_traced(run, "the window trace")
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    if group is None:
        L = PROD["block_pivots"]
        w = window_stats(events, L)
        want = (2 * L + 1) / L
        require(w["per_pivot"] == (want, want), f"{w['per_pivot']} kernels "
                f"a pivot in the traced windows, not {want}")
    else:
        L = PROD["block_pivots"]
        w = window_stats(events, L, SHARDED_GRAPH_KERNELS,
                         ("kernel", "gpu_memcpy"), 10, SHARDED_GRAPH_SPAN)
        want = (5 * L + 2) / L
        require(w["per_pivot"] == (want, want), f"{w['per_pivot']} nodes a "
                f"pivot in the traced sharded windows, not {want}")
    log(f"{'' if group is None else 'sharded 1-rank '}"
        f"phase-1 loop traced ({pivots} pivots, {w['windows']} windows): "
        f"{w['per_pivot'][0]:.4f}-{w['per_pivot'][1]:.4f} kernels a pivot "
        f"in a replayed window (the middle one: {w['names']}); device busy "
        f"inside a replayed window {100 * w['inside'][0]:.1f}-"
        f"{100 * w['inside'][2]:.1f}% (median {100 * w['inside'][1]:.1f}%),"
        f" over a window's period with its boundary "
        f"{100 * w['period'][0]:.1f}-{100 * w['period'][2]:.1f}% (median "
        f"{100 * w['period'][1]:.1f}%); the middle window's kernels "
        f"{w['us_pivot']:.2f} us a pivot, its span {w['span_us']:.1f} us")


def phase_sharded_trace() -> None:
    """``phase_window_trace`` of ``solve_sharded`` at one NCCL rank in this
    process: the nodes a pivot of a replayed window, NCCL's included, and
    the device's busy share inside a window and over its period."""
    import tempfile

    from simplex_tpu_torch.parallel import group as pg

    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        phase_window_trace(group)


def window_stats(events: list, L: int, graph_kernels=GRAPH_KERNELS,
                 cats=("kernel",), most: int = 5, bounds=None) -> dict:
    """From a chrome trace's events, the windows of a traced kernel loop:
    a window is the graph's kernels (``graph_kernels``, events of the
    categories ``cats``) before a window apply (K3 or K4), with ``bounds``
    = (first, last) from the graph's first node to its last. Returns the
    windows' count, the (min, max) kernels a pivot (at most ``most``), the
    (min, median, max) busy share inside a window (its kernels' time over
    the span from its first kernel's start to its last one's end) and over
    a window's period (apply to apply, the boundary included), and the
    middle window's kernels by name, kernel us a pivot and span."""
    kernels = sorted((e for e in events if e.get("cat") in cats),
                     key=lambda e: e["ts"])
    windows, applies = [[]], []
    for e in kernels:
        if "window_apply" in e["name"]:
            applies.append(e)
            windows.append([])
        elif any(name in e["name"] for name in graph_kernels):
            windows[-1].append(e)
    windows = windows[:len(applies)]
    if bounds is not None:
        for i, w in enumerate(windows):
            first = [j for j, e in enumerate(w) if bounds[0] in e["name"]]
            last = [j for j, e in enumerate(w) if bounds[1] in e["name"]]
            windows[i] = w[first[0]:last[-1] + 1] if first and last else []
    require(len(applies) >= 3 and all(windows),
            f"the trace holds {len(applies)} window applies and "
            f"{sum(map(len, windows))} graph kernels")
    per_pivot = [len(w) / L for w in windows]
    inside, period = [], []
    for i, w in enumerate(windows):
        span = max(e["ts"] + e["dur"] for e in w) - w[0]["ts"]
        inside.append(sum(e["dur"] for e in w) / span)
        if i:
            t0, t1 = applies[i - 1]["ts"], applies[i]["ts"]
            busy = sum(min(e["ts"] + e["dur"], t1) - e["ts"]
                       for e in kernels if t0 <= e["ts"] < t1)
            period.append(busy / (t1 - t0))
    require(max(per_pivot) <= most, f"{max(per_pivot)} kernels a pivot")
    mid = windows[len(windows) // 2]

    def spread(x):
        return min(x), statistics.median(x), max(x)

    return dict(
        windows=len(windows), per_pivot=(min(per_pivot), max(per_pivot)),
        inside=spread(inside), period=spread(period),
        names=dict(collections.Counter(
            next(n for n in graph_kernels if n in e["name"]) for e in mid)),
        us_pivot=sum(e["dur"] for e in mid) / L,
        span_us=max(e["ts"] + e["dur"] for e in mid) - mid[0]["ts"])


class SaveTimes:
    """Times each single-card checkpoint write while active (the
    device-to-host copy and the file, ``checkpoint._Card.save``): a list
    of (seconds, bytes on disk)."""

    def __enter__(self):
        from simplex_tpu_torch import checkpoint as ck

        self.saves, self.orig = [], ck._Card.save
        orig, saves = self.orig, self.saves

        def save(stages, *args, **kw):
            t0 = time.perf_counter()
            orig(stages, *args, **kw)
            saves.append((time.perf_counter() - t0,
                          pathlib.Path(stages.path).stat().st_size))

        ck._Card.save = save
        return self.saves

    def __exit__(self, *exc):
        from simplex_tpu_torch import checkpoint as ck

        ck._Card.save = self.orig


def timed_resumable(problem, path, opts: dict, every: int = CHECKPOINT_EVERY,
                    **kw):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve_resumable(problem, str(path), every, device="cuda",
                             **opts, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def cli_result(stdout: str) -> tuple:
    """(objective as printed, (phase-1, phase-2 pivots)) of a CLI run."""
    value = walk = None
    for line in stdout.splitlines():
        if line.startswith("Optimal value: "):
            value = line.split(": ", 1)[1]
        if line.startswith("(phase-1 pivots: "):
            walk = tuple(int(v.split(": ")[1]) for v in
                         line.strip("()").split(", "))
    return value, walk


def phase_resumable(flagship_wall: float) -> None:
    """The checkpointed solves (``solve_resumable``,
    ``solve_resumable_sharded``, ``--checkpoint``), each file in a
    temporary directory:

    1. the production flagship in windows of ``CHECKPOINT_EVERY`` pivots,
       K1-K4's counters reset just before and read just after, certified
       within 1e-9 (each window restarts the devex weights and the
       re-pricing cadence, so the walk is not FLAGSHIP_WALK); the wall
       against ``solve``'s warm median, each write's seconds, GB and
       GB/s, the peak device memory;
    2. the same through the CLI in a child process, killed (SIGKILL) as
       soon as the first file exists, then run again: it resumes, prints
       1.'s objective and walk and writes 1.'s ``solution.txt`` (the
       CLI prints six decimals), and the file is gone;
    3. ``solve_resumable_sharded`` on one NCCL rank in this process:
       random_2048_2048 in production, K5 launched and K1 not, certified,
       walking as ``solve_resumable`` on one card; a MAXITER run that
       keeps its file, and its resume to the same walk and objective;
    4. K6's path: random_2048_2048 in pure f32 with ``use_pallas=True``,
       K6 launched, within 1e-3 of the golden;
    5. ``generate_random_problem_device`` at 8192 x 8192 in f64 on the
       card twice, bit for bit, in [1, 100), the 'glibc' sub-seeds
       giving another instance."""
    import signal
    import tempfile

    import numpy as np
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.checkpoint import solve_resumable_sharded
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.parallel import group as pg

    p = benchmark_problem(8192)
    with tempfile.TemporaryDirectory() as tdir:
        td = pathlib.Path(tdir)
        # 1. The flagship, uninterrupted.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kb.reset_launches()
        with SaveTimes() as saves:
            res, wall = timed_resumable(p, td / "flagship.npz", PROD)
        launches = dict(kb.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_certified("resumable flagship", res, OBJ_8192)
        for name in SINGLE_PATH:
            require(launches[name] > 0, f"{name} never launched on the "
                    "resumable path")
        require(not (td / "flagship.npz").exists(),
                "resumable flagship: the file outlived the solve")
        walk = (res.iterations_phase1, res.iterations_phase2)
        log(f"resumable flagship random_8192_8192 (checkpoint_every "
            f"{CHECKPOINT_EVERY}): OPTIMAL certified objective "
            f"{res.objective!r} (golden {OBJ_8192!r}); pivots "
            f"{walk[0]}+{walk[1]} (solve: {FLAGSHIP_WALK[0]}+"
            f"{FLAGSHIP_WALK[1]}); refine {res.refine.method}; wall "
            f"{wall:.3f} s against solve's warm median {flagship_wall:.3f} "
            f"s; {len(saves)} writes, {sum(t for t, _ in saves):.3f} s in "
            f"all; max_memory_allocated {peak:.2f} GB; launches {launches}")
        for i, (secs, size) in enumerate(saves):
            log(f"  checkpoint write {i + 1}: {secs:.3f} s, {size / 1e9:.3f}"
                f" GB, {size / 1e9 / secs:.3f} GB/s")

        # 2. Killed and resumed through the CLI.
        ck = td / "cli.npz"
        args = ["-rf", str(DATA / "benchmark_problems"
                           / "random_8192_8192.txt"),
                "--dtype", "float32", "--vector-dtype", "float64",
                "--block", "128", "--checkpoint", str(ck),
                "--checkpoint-every", str(CHECKPOINT_EVERY),
                "--data-dir", str(td / "cli")]
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "simplex_tpu_torch.cli", *args],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        try:
            while (not ck.exists() and child.poll() is None
                   and time.perf_counter() - t0 < 600):
                time.sleep(0.01)
        finally:
            child.send_signal(signal.SIGKILL)
            _, err = child.communicate(timeout=120)
        killed = time.perf_counter() - t0
        require(child.returncode == -signal.SIGKILL,
                f"the CLI child was not killed mid-solve (exit "
                f"{child.returncode}): {err[-2000:]}")
        require(ck.exists(), "no checkpoint when the CLI child was killed")
        with np.load(ck) as z:
            meta = [int(v) for v in z["__meta__"]]
        t1 = time.perf_counter()
        out = run_cli(args)
        resumed = time.perf_counter() - t1
        value, cli_walk = cli_result(out)
        require("Resuming from checkpoint" in out
                and "Problem solved!" in out,
                f"the CLI rerun did not resume to OPTIMAL:\n{out[-2000:]}")
        require(value == f"{res.objective:f}" and cli_walk == walk,
                f"the resumed CLI printed {value} in {cli_walk}; the "
                f"uninterrupted solve {res.objective:f} in {walk}")
        want = "".join(f"{v:f}\n" for v in res.x) + \
            f"\nOptimal value: {res.objective:f}\n"
        require((td / "cli" / "solution.txt").read_text() == want,
                "the resumed CLI's solution.txt differs from the "
                "uninterrupted solve's")
        require(not ck.exists(), "the CLI's checkpoint outlived the solve")
        log(f"CLI --checkpoint: the child killed {killed:.3f} s after its "
            f"start, its file at phase {meta[3]}, {meta[4]} pivots; the "
            f"rerun resumed to objective {value} and pivots "
            f"{cli_walk[0]}+{cli_walk[1]}, solution.txt as the uninterrupted"
            f" solve's, in {resumed:.3f} s; killed + resumed "
            f"{killed + resumed:.3f} s against the in-process solve's "
            f"{wall:.3f} s "
            f"(both CLI runs start a process and regenerate the problem)")

        # 3. Sharded, one NCCL rank, in this process.
        p2 = benchmark_problem(2048)
        every2 = 512
        single, wall1 = timed_resumable(p2, td / "single.npz", PROD, every2)
        w1 = (single.iterations_phase1, single.iterations_phase2)
        with tempfile.TemporaryDirectory() as gd, \
                pg.world(0, 1, "nccl", gd) as group:
            def sharded(path, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = solve_resumable_sharded(p2, group, str(path), every2,
                                            device="cuda", **PROD, **kw)
                torch.cuda.synchronize()
                return r, time.perf_counter() - t

            kb.reset_launches()
            rs, wall_s = sharded(td / "sharded.npz")
            counts = {k: kb.LAUNCHES[k] for k in SHARDED_PATH + ("ah_ratio",)}
            cut, _ = sharded(td / "cut.npz", max_iter=2 * every2)
            kept = (td / "cut.npz").exists()
            back, _ = sharded(td / "cut.npz")
        check_certified("resumable sharded random_2048_2048", rs, OBJ_2048)
        for name in SHARDED_PATH:
            require(counts[name] > 0, f"{name} never launched on the "
                    "resumable sharded path")
        require(counts["ah_ratio"] == 0, f"K1 launched {counts['ah_ratio']}"
                " times on the resumable sharded path")
        ws = (rs.iterations_phase1, rs.iterations_phase2)
        require(ws == w1, f"resumable sharded walked {ws}, solve_resumable "
                f"{w1}")
        require(cut.status == st.Status.MAXITER and kept,
                f"capped sharded run: {cut.status!r}, file kept {kept}")
        check_certified("resumed sharded random_2048_2048", back, OBJ_2048)
        wb = (back.iterations_phase1, back.iterations_phase2)
        require(wb == ws and back.objective == rs.objective,
                f"resumed sharded run: {wb} {back.objective!r}, the full "
                f"run {ws} {rs.objective!r}")
        log(f"resumable sharded, 1 NCCL rank, random_2048_2048 "
            f"(checkpoint_every {every2}): certified objective "
            f"{rs.objective!r}, pivots {ws[0]}+{ws[1]} as solve_resumable "
            f"({wall1:.3f} s there), refine {rs.refine.method}; wall "
            f"{wall_s:.3f} s; launches {counts}; a run capped at "
            f"{2 * every2} pivots kept its file and resumed to the same "
            f"walk and objective")

        # 4. K6's path.
        kp.reset_launches()
        r6, wall6 = timed_resumable(
            p2, td / "k6.npz", dict(dtype="float32", vector_dtype="float32",
                                    use_pallas=True))
        k6 = kp.LAUNCHES["fused_pivot"]
        check_objective("resumable f32 K6 random_2048_2048", r6, OBJ_2048,
                        1e-3)
        require(k6 > 0, "fused_pivot never launched on the resumable path")
        log(f"resumable f32 use_pallas random_2048_2048: objective "
            f"{r6.objective!r}, pivots {r6.iterations_phase1}+"
            f"{r6.iterations_phase2}; wall {wall6:.3f} s; fused_pivot "
            f"launches {k6}")

    # 5. The device generator.
    n = 8192
    seed = n * 100 + n
    gen = functools.partial(st.generate_random_problem_device, n, n, seed,
                            1.0, 100.0, np.float64, device="cuda")
    times, draws = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws.append(gen())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for a, b in zip(*draws):
        require(torch.equal(a, b), "generate_random_problem_device drew "
                "other bits on a second call")
        require(bool(((a >= 1.0) & (a < 100.0)).all()),
                "generate_random_problem_device left [1, 100)")
    glibc = gen(rand_flavor="glibc")
    require(not torch.equal(glibc[0], draws[0][0]),
            "the glibc sub-seeds drew the msvc instance")
    log(f"generate_random_problem_device {n}x{n} f64 on the card: "
        f"{1e3 * times[0]:.3f} ms, then {1e3 * times[1]:.3f} ms a call "
        f"(host clock, synchronized); bit for bit across calls, in [1, "
        f"100), another instance under glibc")
    del draws, glibc
    torch.cuda.empty_cache()


def phase_northstar() -> tuple:
    """The production north-star tableau for 256 pivots; returns (z,
    base) after them."""
    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.solver import run_solve_loop

    cap = 256
    opts = SolverOptions(**PROD)
    torch.cuda.reset_peak_memory_stats()
    tab, costs0 = northstar_tableau(opts)
    gb = tab.Tt.numel() * 4 / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab, status, iters = run_solve_loop(tab, opts, cap, costs0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(iters == cap, f"north-star: {iters} pivots, want {cap}")
    require(bool(torch.isfinite(tab.z)), "north-star: z not finite")
    log(f"north-star 10000x100000: tableau {tuple(tab.Tt.shape)} "
        f"({gb:.2f} GB f32); {iters} pivots in {wall:.3f} s = "
        f"{1e3 * wall / iters:.4f} ms/pivot; status {status}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    return float(tab.z), tab.base.cpu()


def timed_batch(problems, stats: dict, opts: dict = BATCH, **kw):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve_batch(problems, device="cuda", stats=stats, **opts, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_batch_spread() -> None:
    import numpy as np

    import simplex_tpu_torch as st

    spread = [st.Problem(A=np.array(A), b=np.array(b), c=np.array(c))
              for A, b, c in (
                  ([[1.0, 0.0], [0.0, 1.0]], [1.0, 2.0], [3.0, 5.0]),
                  ([[1.0, 0.0], [1.0, 0.0]], [1.0, 2.0], [1.0, 1.0]),
                  ([[-1.0, 0.0], [1.0, 0.0]], [-1.0, 0.5], [1.0, 0.0]))]
    res, _ = timed_batch(spread, {})
    got = [r.status for r in res]
    require(got == [st.Status.OPTIMAL, st.Status.UNBOUNDED,
                    st.Status.INFEASIBLE], f"batch spread: {got}")
    require(abs(res[0].objective - 13.0) <= 1e-12 and res[0].refine.certified,
            f"batch spread: objective {res[0].objective!r}")
    log("batch spread: OPTIMAL 13 (certified), UNBOUNDED, INFEASIBLE")


def walk_digest(results) -> str:
    """sha256 over each lane's (status, phase-1 pivots, phase-2 pivots,
    objective.hex()): a batch's walks in one line (tools/batch_walks.py
    prints the same digest for any checkout)."""
    h = hashlib.sha256()
    for r in results:
        obj = "none" if r.objective is None else float(r.objective).hex()
        h.update(f"{int(r.status)} {r.iterations_phase1} "
                 f"{r.iterations_phase2} {obj};".encode())
    return h.hexdigest()


def phase_batch(label: str, shape, launches: dict | None = None,
                lanes=()) -> tuple:
    """One batch through ``solve_batch`` twice (first and warm call): every
    lane OPTIMAL and certified, the same walks both times, printed as one
    digest (``walk_digest``); ``lanes`` checked against a batch of that
    lane alone (walk, basis, objective bit for bit) and against the
    single-LP ``solve`` (1e-9). With ``launches``, the K7-K10 counters of
    the first call. Returns (problems, the first call's results)."""
    import numpy as np
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import batched as kbt

    n, m, seeds = shape
    t0 = time.perf_counter()
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    log(f"{label}: {len(problems)} x (m={m}, n={n}) generated in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    kbt.reset_launches()
    first_stats = {}
    res, first = timed_batch(problems, first_stats)
    counts = dict(kbt.LAUNCHES)
    if launches is not None:
        launches.update(counts)
    warm_stats = {}
    again, warm = timed_batch(problems, warm_stats)
    for i, r in enumerate(res):
        require(r.status == st.Status.OPTIMAL and r.refine is not None
                and r.refine.certified,
                f"{label} lane {i}: {r.status!r} refine {r.refine}")
        require(np.isfinite(r.x).all() and r.x.shape == (n,),
                f"{label} lane {i}: bad x")
    walks = [(r.iterations_phase1, r.iterations_phase2) for r in res]
    require(walks == [(r.iterations_phase1, r.iterations_phase2)
                      for r in again]
            and [r.objective for r in res] == [r.objective for r in again],
            f"{label}: the warm call walked otherwise")
    pivots = sorted(a + b for a, b in walks)
    methods = sorted(collections.Counter(r.refine.method for r in res)
                     .items())
    log(f"{label}: {len(res)}/{len(res)} OPTIMAL and certified "
        f"(refinement {methods}); wall first "
        f"{first:.3f} s, warm {warm:.3f} s = {1e3 * warm / len(res):.3f} "
        f"ms/instance (data to the card {warm_stats['prepare_s']:.3f} s, "
        f"device solve {warm_stats['device_s']:.3f} s, host refinement "
        f"{warm_stats['refine_s']:.3f} s); windows per phase "
        f"{first_stats['windows']}; pivots per lane min {pivots[0]} median "
        f"{statistics.median(pivots)} max {pivots[-1]}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB; launches {counts}")
    log(f"{label}: walk digest {walk_digest(res)}")
    for i in lanes:
        alone_stats = {}
        (alone,), _ = timed_batch([problems[i]], alone_stats)
        r = res[i]
        require((alone.iterations_phase1, alone.iterations_phase2)
                == walks[i] and alone.objective == r.objective
                and np.array_equal(alone_stats["bases"][0],
                                   first_stats["bases"][i]),
                f"{label} lane {i}: the batch of one walked "
                f"{(alone.iterations_phase1, alone.iterations_phase2)} to "
                f"{alone.objective!r}, the batch {walks[i]} to "
                f"{r.objective!r}")
        single, wall = timed_solve(problems[i], BATCH)
        rel = abs(single.objective - r.objective) / abs(r.objective)
        require(single.status == st.Status.OPTIMAL and rel <= 1e-9,
                f"{label} lane {i}: solve() {single.status!r} "
                f"{single.objective!r} vs batch {r.objective!r}")
        log(f"{label} lane {i}: equals its batch of one ({walks[i]} pivots,"
            f" objective {r.objective!r}); single-LP solve "
            f"{single.objective!r} (rel {rel:.1e}, "
            f"{single.iterations_phase1}+{single.iterations_phase2} pivots,"
            f" {wall:.3f} s)")
    return problems, res


def phase_default_batch(problems, kernel_res, launches: dict) -> None:
    """Config 3's 256 lanes with ``DEFAULT_OPTIONS`` (f64 tableau,
    sequential): the batched fallback's lane-batched sequential loop on
    the card, ``batch_rank1``'s counter set to 0 just before the call and
    read just after (launched; K6 not). Every lane's status equal to the
    kernel batch's on the same LPs (all OPTIMAL), each OPTIMAL objective
    within 1e-9 of the kernel batch's certified one; lanes
    ``DEFAULT_BATCH_LANES`` solved alone by ``solve`` walk the same
    (pivot counts equal, objective within 1e-12)."""
    import numpy as np
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import pivot as kp

    label = "default-option batch (config 3, f64 sequential)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    kp.reset_launches()
    res, wall = timed_batch(problems, stats, {})
    counts = dict(kp.LAUNCHES)
    launches["batch_rank1"] = counts["batch_rank1"]
    require(counts["batch_rank1"] > 0 and counts["fused_pivot"] == 0,
            f"{label}: launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = stats["windows"]
    log(f"{label}: lane statuses "
        + " ".join(str(int(r.status)) for r in res))
    for i, (r, k) in enumerate(zip(res, kernel_res)):
        require(r.status == k.status,
                f"{label} lane {i}: {r.status!r}, the kernel batch "
                f"{k.status!r}")
        if r.status == st.Status.OPTIMAL:
            rel = abs(r.objective - k.objective) / abs(k.objective)
            require(rel <= 1e-9 and np.isfinite(r.x).all()
                    and r.x.shape == k.x.shape,
                    f"{label} lane {i}: objective {r.objective!r} vs the "
                    f"kernel batch's certified {k.objective!r}")
        require(r.refine is None, f"{label} lane {i}: refined")
    pivots = sorted(r.iterations_phase1 + r.iterations_phase2 for r in res)
    worst = max(abs(r.objective - k.objective) / abs(k.objective)
                for r, k in zip(res, kernel_res))
    log(f"{label}: {collections.Counter(r.status.name for r in res)}; "
        f"every objective within {worst:.2e} of the kernel batch's "
        f"certified one; steps per phase {steps} (SEQ_CHUNK a host read); "
        f"wall {wall:.3f} s (data to the card {stats['prepare_s']:.3f} s, "
        f"device solve {stats['device_s']:.3f} s = "
        f"{1e3 * stats['device_s'] / sum(steps):.4f} ms per batched step)"
        f"; pivots per lane min {pivots[0]} median "
        f"{statistics.median(pivots)} max {pivots[-1]}; "
        f"max_memory_allocated {peak:.2f} GB; launches {counts}")
    log(f"{label}: walk digest {walk_digest(res)}")
    for i in DEFAULT_BATCH_LANES:
        single, wall1 = timed_solve(problems[i], {})
        r = res[i]
        walk = (r.iterations_phase1, r.iterations_phase2)
        rel = abs(single.objective - r.objective) / abs(r.objective)
        require(single.status == r.status
                and (single.iterations_phase1,
                     single.iterations_phase2) == walk and rel <= 1e-12,
                f"{label} lane {i}: solve() walked "
                f"{single.iterations_phase1}+{single.iterations_phase2} to "
                f"{single.objective!r}, the batch {walk} to "
                f"{r.objective!r}")
        log(f"{label} lane {i}: solve() walks the same ({walk[0]}+"
            f"{walk[1]} pivots; objective {r.objective!r}, solve() "
            f"{single.objective!r}, rel {rel:.1e}; {wall1:.3f} s)")


def phase_fallback_blocked(problems, kernel_res) -> None:
    """Route (b) of the batched fallback at full width: config 3's 256
    lanes with ``kernel=False`` at its options, then as an f64 blocked
    batch (``FALLBACK_F64``, ``kernel="auto"``), each one lane-batched
    plain blocked loop a phase with no kernel launched (every launch
    counter set to 0 just before the call and read just after). Every
    lane's status equal to the kernel batch's; every OPTIMAL lane
    certified (the mixed lanes by the batch's own refinement, the f64
    lanes, which the batch does not refine, by ``refine_solution_host``
    and ``certificates_pass`` on their final bases) and within 1e-9 of the
    kernel batch's certified objective; lanes ``DEFAULT_BATCH_LANES``
    against their own single-LP ``solve(..., use_pallas=False)``: f64
    pivot counts equal and objectives within 1e-12, mixed status equal,
    certified, within 1e-9 and pivot counts within max(3, 10%). Then the
    first ``FALLBACK_LANES`` lanes of each, timed alone."""
    for label, opts, kernel in (
            ("kernel=False batch (config 3's options)", BATCH, False),
            ("f64 blocked batch (config 3, L=32)", FALLBACK_F64, "auto")):
        fallback_batch(label, problems, kernel_res, opts, kernel)


def fallback_batch(label: str, problems, kernel_res, opts: dict,
                   kernel) -> None:
    import numpy as np
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import batched as kbt
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.refine import (certificates_pass,
                                          refine_solution_host)

    options = st.SolverOptions(**opts)
    f64 = options.dtype == np.float64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in (kb, kbt, kp):
        mod.reset_launches()
    stats: dict = {}
    res, wall = timed_batch(problems, stats, opts, kernel=kernel)
    counts = {**kb.LAUNCHES, **kbt.LAUNCHES, **kp.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(not any(counts.values()), f"{label}: kernels launched {counts}")
    t0 = time.perf_counter()
    worst = 0.0
    for i, (r, k, p) in enumerate(zip(res, kernel_res, problems)):
        require(r.status == k.status, f"{label} lane {i}: {r.status!r}, "
                f"the kernel batch {k.status!r}")
        if r.status != st.Status.OPTIMAL:
            continue
        if f64:
            ro = refine_solution_host(p.A, p.b, p.c, stats["bases"][i],
                                      p.vars, p.constraints)
            certified = ro is not None and certificates_pass(
                ro, p.b, p.c, float(options.refine_tol))
        else:
            certified = r.refine is not None and r.refine.certified
        rel = abs(r.objective - k.objective) / abs(k.objective)
        require(certified and rel <= 1e-9 and np.isfinite(r.x).all()
                and r.x.shape == k.x.shape,
                f"{label} lane {i}: certified {certified}, objective "
                f"{r.objective!r} vs the kernel batch's {k.objective!r}")
        worst = max(worst, rel)
    check_s = time.perf_counter() - t0
    windows = stats["windows"]
    L = int(options.block_pivots)
    pivots = sorted(r.iterations_phase1 + r.iterations_phase2 for r in res)
    how = ("certified on the host (refine_solution_host, "
           f"{check_s:.3f} s)" if f64 else "certified by the batch")
    log(f"{label}: {len(res)} lanes, "
        f"{collections.Counter(r.status.name for r in res)}, every OPTIMAL "
        f"lane {how}, objectives within {worst:.2e} of the kernel batch's; "
        f"windows per phase {windows}, steps {L * sum(windows)}; wall "
        f"{wall:.3f} s (data to the card {stats['prepare_s']:.3f} s, device "
        f"solve {stats['device_s']:.3f} s = "
        f"{1e3 * stats['device_s'] / sum(windows):.3f} ms per window, host "
        f"refinement {stats['refine_s']:.3f} s); pivots per lane min "
        f"{pivots[0]} median {statistics.median(pivots)} max {pivots[-1]}; "
        f"max_memory_allocated {peak:.2f} GB; no kernel launched")
    log(f"{label}: walk digest {walk_digest(res)}")
    for i in DEFAULT_BATCH_LANES:
        single, wall1 = timed_solve(problems[i], dict(opts, use_pallas=False))
        r = res[i]
        got = (r.iterations_phase1, r.iterations_phase2)
        want = (single.iterations_phase1, single.iterations_phase2)
        rel = abs(single.objective - r.objective) / abs(r.objective)
        if f64:
            ok = got == want and rel <= 1e-12
        else:
            ok = (single.refine.certified and rel <= 1e-9
                  and all(abs(a - b) <= max(3, 0.1 * b)
                          for a, b in zip(got, want)))
        require(single.status == r.status and ok,
                f"{label} lane {i}: solve() {single.status!r} walked "
                f"{want} to {single.objective!r}, the batch {got} to "
                f"{r.objective!r}")
        log(f"{label} lane {i}: the batch {got[0]}+{got[1]} pivots, solve() "
            f"{want[0]}+{want[1]}; objective {r.objective!r}, solve() "
            f"{single.objective!r}, rel {rel:.1e}; {wall1:.3f} s")
    stats16: dict = {}
    _, wall16 = timed_batch(problems[:FALLBACK_LANES], stats16, opts,
                            kernel=kernel)
    log(f"{label}: its first {FALLBACK_LANES} lanes alone: wall "
        f"{wall16:.3f} s, device solve {stats16['device_s']:.3f} s, windows "
        f"per phase {stats16['windows']}")


def phase_tiers() -> None:
    """The f64 certification tier chain on the card: ``fallback_solve``
    warm from the flagship production solve's final (drifted) basis, the
    host finish (``finish_from_basis``); ``fallback_solve`` with no basis,
    the full f64 re-solve on the card, at random_2048_2048; and one
    production ``solve`` at random_2048_2048 whose mixed-tier certificates
    are made to fail, so that it reaches ``fallback_solve`` through
    ``certify`` after both restart rounds. Each certified within 1e-9 of
    its golden."""
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch import reinvert, two_phase
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import eta as ke

    opts = st.SolverOptions(**PROD)
    p = benchmark_problem(8192)
    data = [torch.as_tensor(v, device="cuda") for v in (p.A, p.b, p.c)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = two_phase.solve_device_with_binv(*data, p.vars, p.constraints,
                                              opts)
    base = out.base.cpu().numpy()
    t_dev = time.perf_counter() - t0
    require(out.status == st.Status.OPTIMAL, f"flagship: {out.status!r}")
    del data, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = two_phase.fallback_solve(p, opts, base=base)
    wall = time.perf_counter() - t0
    check_certified("warm finish of the flagship", res, OBJ_8192)
    require(res.refine.method == "finish",
            f"warm finish of the flagship: took {res.refine.method!r}")
    log(f"tier chain, warm finish: fallback_solve from the flagship "
        f"production solve's final basis (device solve {t_dev:.3f} s, "
        f"before refinement) -> OPTIMAL certified {res.objective!r} "
        f"(golden {OBJ_8192!r}); finishing pivots "
        f"{res.iterations_phase2}; host wall {wall:.3f} s (the (n + m) x "
        f"m = 16,384 x 8,192 f64 tableau built and walked on the host)")

    p = benchmark_problem(2048)
    kb.reset_launches()
    ke.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = two_phase.fallback_solve(p, opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_certified("full f64 re-solve of random_2048_2048", res, OBJ_2048)
    require(res.refine.method == "tableau" and not any(kb.LAUNCHES.values())
            and min(ke.LAUNCHES.values()) > 0,
            f"full f64 re-solve: {res.refine.method!r} {kb.LAUNCHES} "
            f"{ke.LAUNCHES}")
    log(f"tier chain, full f64 re-solve: fallback_solve(random_2048_2048, "
        f"no basis) -> OPTIMAL certified {res.objective!r} (golden "
        f"{OBJ_2048!r}); {res.iterations_phase1}+{res.iterations_phase2} "
        f"pivots (f64 tableau, L=128, the plain blocked loop as one CUDA "
        f"graph a window: launches {dict(ke.LAUNCHES)}); wall {wall:.3f} s")

    refine_result = two_phase.refine_result
    restart_device = reinvert.restart_device
    rounds = []

    def failing(*args, **kw):
        rx, robj, info, ro = refine_result(*args, **kw)
        return None, None, info._replace(certified=False), ro

    def counted(*args, **kw):
        rounds.append(1)
        return restart_device(*args, **kw)

    two_phase.refine_result = failing
    reinvert.restart_device = counted
    try:
        res, wall = timed_solve(p)
    finally:
        two_phase.refine_result = refine_result
        reinvert.restart_device = restart_device
    check_certified("production solve through certify's tiers", res,
                    OBJ_2048)
    require(res.refine.fallback and len(rounds) == 2,
            f"production solve through certify's tiers: fallback "
            f"{res.refine.fallback}, {len(rounds)} restart rounds")
    log(f"tier chain, through certify: production random_2048_2048 with "
        f"two_phase.refine_result wrapped to report every mixed-tier "
        f"refinement as failed (its certificates made to fail) -> "
        f"{len(rounds)} restart rounds, then fallback_solve "
        f"({res.refine.method}): OPTIMAL certified {res.objective!r}, "
        f"refine.fallback {res.refine.fallback}; wall {wall:.3f} s")


def extreme_problem(n: int, m: int, seed: int, exp: int):
    """(base, extreme): a seeded instance and its counterpart with rows
    and columns scaled by 10^[-exp, exp] (``tests/test_scaling.py``'s
    ``_extreme_problem``). Row scaling keeps the feasible set and column
    scaling substitutes x = s x', so both have one optimum value."""
    import numpy as np

    import simplex_tpu_torch as st

    p = st.generate_random_problem(n, m, seed, 1, 100)
    rng = np.random.default_rng(seed)
    rexp = rng.integers(-exp, exp + 1, size=m)
    cexp = rng.integers(-exp, exp + 1, size=n)
    A = p.A * (10.0 ** rexp)[:, None] * (10.0 ** cexp)[None, :]
    return p, st.Problem(A=A, b=p.b * 10.0 ** rexp, c=p.c * 10.0 ** cexp)


def phase_equilibrate() -> None:
    """``equilibrate=True`` with the production options on the card: the
    flagship certified within 1e-9 of its golden, and the
    extreme-magnitude instance ``EXTREME`` certified within 1e-9 of the
    f64 solve (default options, no scaling) of its base instance, whose
    optimum value it shares."""
    import numpy as np

    import simplex_tpu_torch as st

    res, wall = timed_solve(benchmark_problem(8192),
                            dict(PROD, equilibrate=True))
    check_certified("equilibrated flagship", res, OBJ_8192)
    log(f"equilibrate: flagship production -> OPTIMAL certified "
        f"{res.objective!r} (golden {OBJ_8192!r}); pivots "
        f"{res.iterations_phase1}+{res.iterations_phase2}; refine "
        f"{res.refine.method} (fallback {res.refine.fallback}); wall "
        f"{wall:.3f} s")
    n, m, seed, exp = EXTREME
    base, p = extreme_problem(n, m, seed, exp)
    want, _ = timed_solve(base, {})
    res, wall = timed_solve(p, dict(PROD, equilibrate=True))
    check_certified("equilibrated extreme instance", res, want.objective)
    mags = np.abs(p.A[p.A != 0])
    log(f"equilibrate: {n} x {m} seed {seed}, rows and columns scaled by "
        f"10^[-{exp}, {exp}] (|A| in [{mags.min():.1e}, {mags.max():.1e}])"
        f" -> OPTIMAL certified {res.objective!r}, its base instance's f64"
        f" solve {want.objective!r}; refine {res.refine.method} (fallback "
        f"{res.refine.fallback}); wall {wall:.3f} s")


def phase_rank1_kernel(records: dict) -> None:
    """``batch_rank1`` against its plain version (the single-LP loop's
    ``addr_`` on each live lane) at config 3's phase-1 f64 tableau of the
    default options (``RANK1_SHAPE``), every lane live, bit for bit, and
    at R = 2,999 (rows that are not whole 16-byte vectors); a lane whose
    do flag is clear keeps every bit; f32 and f64 at R = 63 and 64 bit for
    bit; how many elements ``addcmul_`` and ``baddbmm_`` over all lanes
    give otherwise; its plan (``kernels.pivot.rank1_plan``) printed;
    device ms per call against the plain version, ``addcmul_`` (the
    library call: every lane live, the same function) and the bound; by
    CUDA events in turns, every lane live, a quarter live (every fourth
    lane) and ``addcmul_``; and at R = 2,999."""
    import torch

    from simplex_tpu_torch.kernels import pivot as kp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261017)
    B, M, R = RANK1_SHAPE
    T0 = torch.rand((B, M, R), generator=g, device=dev,
                    dtype=torch.float64) * 200.0 - 100.0
    factor = torch.rand((B, M), generator=g, device=dev,
                        dtype=torch.float64) * 2.0 - 1.0
    colk = torch.rand((B, R), generator=g, device=dev,
                      dtype=torch.float64) * 200.0 - 100.0
    live = torch.ones(B, dtype=torch.bool, device=dev)
    plan = kp.rank1_plan(B, M, R, 8)
    log(f"batch_rank1 plan at B={B} M={M} R={R} f64: {plan} (one block of "
        f"{kp.RANK1_THREADS} threads a tile, a grid of {plan.tiles} x {B})")
    Tk = T0.clone()
    kp.batch_rank1(Tk, factor, colk, live)
    Tp = T0.clone()
    kp.batch_rank1_plain(Tp, factor, colk, live)
    equal("batch_rank1 f64 vs plain (addr_ a lane)", Tk, Tp)
    found = {}
    for name, fn in (
            ("addcmul_", lambda T: T.addcmul_(factor[:, :, None],
                                              colk[:, None, :], value=-1.0)),
            ("baddbmm_", lambda T: T.baddbmm_(factor[:, :, None],
                                              colk[:, None, :], alpha=-1.0))):
        Tp.copy_(T0)
        fn(Tp)
        found[name] = int((Tp != Tk).sum())
    del Tp
    some = live.clone()
    some[B // 3] = False
    Tk.copy_(T0)
    kp.batch_rank1(Tk, factor, colk, some)
    equal("batch_rank1: the lane left out", Tk[B // 3], T0[B // 3])
    equal("batch_rank1: a live lane beside it", Tk[B // 3 + 1],
          T0[B // 3 + 1].addr(factor[B // 3 + 1], colk[B // 3 + 1],
                              alpha=-1.0))
    three = torch.tensor([True, False, True, True], device=dev)
    for dt, r in ((torch.float32, 64), (torch.float32, 63),
                  (torch.float64, 63)):
        # Rows of whole 16-byte vectors and rows that are not.
        t = T0[:4, :, :r].to(dt).contiguous()
        f = factor[:4].to(dt).contiguous()
        c = colk[:4, :r].to(dt).contiguous()
        want = t.clone()
        kp.batch_rank1_plain(want, f, c, three)
        kp.batch_rank1(t, f, c, three)
        equal(f"batch_rank1 {dt} R={r} vs plain", t, want)
    ms = device_ms(lambda: kp.batch_rank1(Tk, factor, colk, live), 10)
    plain_ms = device_ms(lambda: kp.batch_rank1_plain(Tk, factor, colk,
                                                       live), 3)
    library_ms = device_ms(lambda: Tk.addcmul_(
        factor[:, :, None], colk[:, None, :], value=-1.0), 10)
    check_ms = event_ms(lambda: kp.batch_rank1(Tk, factor, colk, live), 10)
    quarter = torch.arange(B, device=dev) % 4 == 0
    turns = {
        "every lane live": lambda: kp.batch_rank1(Tk, factor, colk, live),
        "a quarter live": lambda: kp.batch_rank1(Tk, factor, colk,
                                                 quarter),
        "addcmul_": lambda: Tk.addcmul_(factor[:, :, None],
                                        colk[:, None, :], value=-1.0)}
    in_turns: dict = {name: [] for name in turns}
    for name in [*turns, *reversed(turns)]:
        in_turns[name].append(event_ms(turns[name], 10))
    bound_ms, by = bound(16 * B * M * R + 8 * B * (M + R) + B,
                         f64_flops=2 * B * M * R)
    log(f"batch_rank1 B={B} M={M} R={R} f64, every lane live: bit for bit "
        f"the plain version (addr_ a lane; and f32 / f64 at R = 63, 64; a "
        f"lane left out untouched); elements differing from the kernel "
        f"over all lanes in one call: {found}; kernel {ms:.4f} ms (CUDA "
        f"events {check_ms:.4f}), plain {plain_ms:.4f} ms, addcmul_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}); the kernel "
        f"moves {16 * B * M * R / ms / 1e9:.3f} TB/s")
    share = min(in_turns["a quarter live"]) / min(in_turns["every lane live"])
    log("batch_rank1 by CUDA events over 10 calls, in turns (ms): "
        + "; ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                    for name, ts in in_turns.items())
        + f"; a quarter live takes {share:.3f} of every lane live's time")
    records["batch_rank1"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
        "check_ms": check_ms}
    del T0, Tk
    torch.cuda.empty_cache()
    r = R - 1
    T0 = torch.rand((B, M, r), generator=g, device=dev,
                    dtype=torch.float64) * 200.0 - 100.0
    colk = torch.rand((B, r), generator=g, device=dev,
                      dtype=torch.float64) * 200.0 - 100.0
    Tp = T0.clone()
    kp.batch_rank1(T0, factor, colk, live)
    kp.batch_rank1_plain(Tp, factor, colk, live)
    equal(f"batch_rank1 f64 R={r} vs plain", T0, Tp)
    del Tp
    odd_ms = event_ms(lambda: kp.batch_rank1(T0, factor, colk, live), 10)
    log(f"batch_rank1 B={B} M={M} R={r} f64, every lane live: bit for bit "
        f"the plain version; {odd_ms:.4f} ms by CUDA events (R={R}: "
        f"{check_ms:.4f})")
    del T0
    torch.cuda.empty_cache()


def timed_sharded(problem, group, opts: dict):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve_sharded(problem, group, device="cuda", **opts)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def time_sharded_rank(group, device, cases):
    """A spawned rank (``parallel.group.spawn``): ``solve_sharded`` of each
    (problem, options) in ``cases`` in turn, each with its wall seconds on
    the host clock, the card synchronized before and after: [(result,
    seconds)]."""
    import torch

    import simplex_tpu_torch as st

    out = []
    for p, o in cases:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = st.solve_sharded(p, group, o, device=device)
        torch.cuda.synchronize(device)
        out.append((res, time.perf_counter() - t0))
    return out


def fleet_rank(group, device, problems, options):
    """A spawned rank of the fleet: K7-K10's launch counters set to 0 just
    before ``solve_batched(mesh=group)`` and read just after. Returns (the
    results, every rank's counts in rank order)."""
    import torch.distributed as dist

    from simplex_tpu_torch.batch import solve_batched
    from simplex_tpu_torch.kernels import batched as kbt

    kbt.reset_launches()
    res = solve_batched(problems, options, device=device, mesh=group)
    counts = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, {k: kbt.LAUNCHES[k] for k in BATCH_PATH},
                           group=group)
    return res, counts


def check_fleet(label: str, nranks: int, backend: str, problems) -> float:
    """``problems`` through the fleet on ``nranks`` spawned ranks: every
    lane OPTIMAL, certified and bit for bit as ``solve_batch`` gives it on
    one card, every batched-path kernel launched on every rank. Returns
    the fleet's wall seconds, the processes' start included."""
    import numpy as np

    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel.group import spawn

    t0 = time.perf_counter()
    fleet, counts = spawn(fleet_rank, nranks, backend, "cuda", problems,
                          st.SolverOptions(**BATCH))
    wall = time.perf_counter() - t0
    one, wall1 = timed_batch(problems, {})
    for i, (a, b) in enumerate(zip(fleet, one)):
        require(a.status == b.status == st.Status.OPTIMAL
                and a.refine.certified
                and (a.iterations_phase1, a.iterations_phase2)
                == (b.iterations_phase1, b.iterations_phase2)
                and a.objective == b.objective and np.array_equal(a.x, b.x),
                f"{label} lane {i}: {a.status!r} {a.objective!r} vs one "
                f"card's {b.status!r} {b.objective!r}")
    for rank, c in enumerate(counts):
        for name in BATCH_PATH:
            require(c[name] > 0, f"{label}: {name} never launched on rank "
                    f"{rank}")
    log(f"{label}: {len(problems)} config-3 lanes OPTIMAL and certified, "
        f"each bit for bit as solve_batch on one card ({wall1:.3f} s "
        f"there); {wall:.3f} s with the processes' start; launches per "
        f"rank {counts}")
    return wall


def sharded_seq_loops(p, group, way: str, keep: list | None = None,
                      against: list | None = None) -> dict:
    """One ``solve_sharded(p)`` with the default options (f64, Dantzig,
    L = 1) on ``group``, its sequential sharded loop
    (``solve_loop_sharded``) run ``way``: "graph" (one CUDA graph a
    chunk of 32 pivots, its NCCL collectives inside), "eager"
    (``graph=False``: the same kernels and collectives enqueued eagerly)
    or "old" (``old_solve_loop_sharded``). Returns, as ``seq_loops``, the
    result, the solve's wall, each loop call's wall and pivots, each
    capture's ms and kernels a pivot by the captured launch counts, which
    must be 3 (``SHARDED_SEQ_PATH``), beside 2 ``all_gather``s and 1
    ``all_reduce`` a pivot by the captured collective counts. Each loop
    call's final state is appended to ``keep`` as copies, or held to
    ``against``'s bit for bit."""
    import torch

    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.parallel import sharded as ps

    chunk = solver.SEQ_CHUNK
    real, real_capture = ps.solve_loop_sharded, ps.capture_chunk_sharded
    calls, captures, per_pivot = [], [], []

    def capture(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_capture(*args)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - t0))
        per = out[1].per_replay
        kernels = sum(n for k, n in per.items() if k not in ks.TAILS)
        colls = dict(out[2].counts)
        require(kernels == 3 * chunk and all(
            per[k] == chunk for k in SHARDED_SEQ_PATH), f"the sharded "
            f"chunk graph holds {per}, not {len(SHARDED_SEQ_PATH)} kernels"
            " a pivot")
        require(colls == {"all_gather": 2 * chunk, "all_reduce": chunk},
                f"the sharded chunk graph holds the collectives {colls}")
        per_pivot.append(kernels / chunk)
        return out

    def loop(tab, shard, options, max_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "old":
            out, st, it = old_solve_loop_sharded(tab, shard, options,
                                                 max_iter)
        else:
            out, st, it = real(tab, shard, options, max_iter,
                               graph=way == "graph")
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, it))
        final = {"Tt": out.Tt, "b": out.b, "costs": out.costs, "z": out.z,
                 "base": out.base, "status": torch.tensor(st),
                 "iterations": torch.tensor(it)}
        if keep is not None:
            keep.append({k: v.clone() for k, v in final.items()})
        if against is not None:
            for k, want in against[len(calls) - 1].items():
                equal(f"sharded {way} loop call {len(calls)} {k}", final[k],
                      want)
        return out, st, it

    ps.solve_loop_sharded = loop
    ps.capture_chunk_sharded = capture
    try:
        res, wall = timed_sharded(p, group, {})
    finally:
        ps.solve_loop_sharded = real
        ps.capture_chunk_sharded = real_capture
    require(len(captures) == (len(calls) if way == "graph" else 0),
            f"{len(captures)} captures in {len(calls)} sharded loop calls")
    pivots = sum(c[1] for c in calls)
    loop_s = sum(c[0] for c in calls)
    return dict(res=res, wall=wall, calls=calls, captures=captures,
                per_pivot=per_pivot, pivots=pivots,
                ms_pivot=1e3 * loop_s / pivots)


def phase_sharded_one_rank(launches: dict, walks: dict,
                           northstar: tuple) -> dict:
    """The sharded path at world size 1 over NCCL, in this process:
    random_1024_1024 with the default options (the sequential sharded
    loop) three ways in turns -- one CUDA graph a chunk, ``graph=False``
    and the old eager ``iteration_body_sharded`` -- each walking as
    ``solve`` with every loop call's final state the graph run's bit for
    bit; random_8192_8192 with the default options graphed, walking as
    ``solve`` (21,697 + 1,123), the sequential kernels' launch counters
    set to 0 just before it and read just after (``SHARDED_SEQ_PATH``
    launched); each run's ms/pivot, capture ms and kernels a pivot beside
    the card's name and power limit; random_2048_2048 and the flagship with
    the production options (the kernel loop over K5, K2, K3/K4, and the
    restart tier on the slices), the flagship certified within 1e-9 and
    walking as ``solve`` did in this process, with the launch counters
    reset just before it and read just after (K5 launched, K1 not); then
    the north-star phase-1 slice for 256 pivots, its z and basis equal to
    the single-card loop's. Returns the 2048 result, for the two-rank
    phase."""
    import tempfile

    import torch

    from simplex_tpu_torch.bench import bench_problem
    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel.sharded import (
        build_phase1_sharded, gaussian_eliminate_sharded,
        run_solve_loop_sharded, sharded_padded_dims)

    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        keep: list = []
        for n, ways in ((1024, ("graph", "eager", "old")), (8192, ("graph",))):
            p = benchmark_problem(n)
            for i, way in enumerate(ways):
                if n == 8192:
                    ks.reset_launches()
                r = sharded_seq_loops(p, group, way,
                                      keep=keep if n == 1024 and i == 0
                                      else None,
                                      against=keep if n == 1024 and i
                                      else None)
                if n == 8192:
                    for name in SHARDED_SEQ_PATH:
                        require(ks.LAUNCHES[name] > 0, f"{name} never "
                                "launched on the sequential sharded path")
                    launches.update({k: ks.LAUNCHES[k]
                                     for k in SHARDED_SEQ_PATH[:2]})
                res = r["res"]
                label = f"sharded, 1 rank, f64 random_{n}_{n} {way}"
                check_objective(label, res, OBJ_1024 if n == 1024
                                else OBJ_8192, 1e-9)
                w = (res.iterations_phase1, res.iterations_phase2)
                require(w == F64_WALKS[n], f"{label} walked {w}, solve "
                        f"{F64_WALKS[n]}")
                log(seq_line(label, r).replace("nodes a pivot", "kernels a "
                                               "pivot")
                    + f"; objective {res.objective!r}, pivots "
                    f"{w[0]}+{w[1]} as solve; {smi}"
                    + (f"; launches {dict(ks.LAUNCHES)}" if n == 8192
                       else ""))
        log("sharded, 1 rank, f64 random_1024_1024: graph, graph=False and "
            "the old eager body walked as solve, every loop call's final "
            "state bit for bit the graph run's")
        del keep

        r2048, wall = timed_sharded(benchmark_problem(2048), group, PROD)
        check_certified("sharded random_2048_2048", r2048, OBJ_2048)
        w = (r2048.iterations_phase1, r2048.iterations_phase2)
        log(f"sharded, 1 rank, random_2048_2048: certified objective "
            f"{r2048.objective!r}, pivots {w[0]}+{w[1]}, refine "
            f"{r2048.refine.method}; wall {wall:.3f} s = "
            f"{1e3 * wall / sum(w):.4f} ms/pivot")

        # The host's cost of one collective at one rank: the kernel loop
        # issues 2 all_gathers of a few scalars and 1 (M_pad,) all_reduce
        # a pivot.
        vals = torch.zeros(5, dtype=torch.float64, device="cuda")
        col = torch.zeros(8192, dtype=torch.float32, device="cuda")
        into = torch.zeros((1, 5), dtype=torch.float64, device="cuda")
        per = {}
        for name, fn in (
                ("all_gather", lambda: pg.all_gather(vals, group)),
                ("all_reduce", lambda: pg.all_reduce(col, group)),
                ("all_gather_into", lambda: pg.all_gather_into(into, vals,
                                                               group)),
                ("all_reduce_", lambda: pg.all_reduce_(col, group))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            torch.cuda.synchronize()
            per[name] = 1e6 * (time.perf_counter() - t0) / 500
        log(f"NCCL at 1 rank: {per['all_gather']:.1f} us per all_gather of "
            f"5 scalars, {per['all_reduce']:.1f} us per (8192,) all_reduce; "
            f"in place {per['all_gather_into']:.1f} and "
            f"{per['all_reduce_']:.1f} us (host clock over 500 back-to-back "
            "calls)")

        kb.reset_launches()
        pg.reset_counts()
        res, wall = timed_sharded(benchmark_problem(8192), group, PROD)
        counts = {k: kb.LAUNCHES[k] for k in ("ah", "ah_ratio")}
        launches.update({k: kb.LAUNCHES[k] for k in SHARDED_PATH})
        colls = dict(pg.COUNTS)
        check_certified("sharded random_8192_8192", res, OBJ_8192)
        w = (res.iterations_phase1, res.iterations_phase2)
        for name in SHARDED_PATH:
            require(launches[name] > 0, f"{name} never launched on the "
                    "sharded path")
        require(counts["ah_ratio"] == 0, f"K1 launched {counts['ah_ratio']}"
                " times on the sharded path")
        require(w == walks[8192], f"sharded flagship walked {w}, solve "
                f"{walks[8192]} in this process")
        log(f"sharded, 1 rank, flagship random_8192_8192: certified "
            f"objective {res.objective!r} (golden {OBJ_8192!r}), pivots "
            f"{w[0]}+{w[1]} as solve, refine {res.refine.method}; wall "
            f"{wall:.3f} s = {1e3 * wall / sum(w):.4f} ms/pivot; launches "
            f"{dict(kb.LAUNCHES)}; collectives {colls}")
        phase_window_graph(group)

        opts = SolverOptions(**PROD)
        n, m = 100_000, 10_000
        R_pad, M_pad = sharded_padded_dims(n, m, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        dev = torch.device("cuda")
        A, b = bench_problem(n, m, dev)
        torch.cuda.reset_peak_memory_stats()
        tab = build_phase1_sharded(A, b, n, m, shard, opts, M_pad, dev)
        del A
        costs0 = tab.costs
        tab = gaussian_eliminate_sharded(tab, shard)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab, status, iters = run_solve_loop_sharded(tab, shard, opts, 256,
                                                    costs0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(iters == 256, f"sharded north-star: {iters} pivots")
        z, base = northstar
        require(float(tab.z) == z and torch.equal(tab.base.cpu(), base),
                f"sharded north-star: z {float(tab.z)!r} vs the single-card"
                f" loop's {z!r}, or another basis")
        log(f"sharded, 1 rank, north-star 10000x100000 phase-1 slice "
            f"{tuple(tab.Tt.shape)}: 256 pivots in {wall:.3f} s = "
            f"{1e3 * wall / 256:.4f} ms/pivot, z and basis equal to the "
            f"single-card loop's; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del tab, costs0
    torch.cuda.empty_cache()
    return r2048


def blocked_sharded_loops(p, group, opts: dict, way: str,
                          keep: list | None = None,
                          against: list | None = None) -> dict:
    """One ``solve_sharded(p, **opts)`` on ``group`` with its plain blocked
    sharded loop (``solve_loop_blocked_sharded``) run ``way``: "graph"
    (one CUDA graph a window, its NCCL collectives inside), "eager"
    (``graph=False``: the same kernels and collectives enqueued eagerly) or
    "old" (the old body, ``solve_loop_blocked_sharded_reference``: its
    eta corrections ``@`` products and its collectives allocating).
    Returns, as ``loop_runs``, the result, the solve's wall, each loop
    call's wall and pivots, each capture's ms and kernels a pivot by the
    captured launch counts, which must be 3 (``SLICES``, L of each a
    window), beside 2 ``all_gather``s (3 under devex) and 1 ``all_reduce``
    a pivot and, on an f32 tableau, 1 of each a window by the captured
    collective counts. Each loop call's final state is appended to
    ``keep`` as copies, or held to ``against``'s bit for bit."""
    import torch

    from simplex_tpu_torch.parallel import sharded as ps

    L = int(opts["block_pivots"])
    real = ps.solve_loop_blocked_sharded
    real_capture = ps.capture_blocked_window_sharded
    calls, captures, per_pivot = [], [], []

    def capture(loop, options, max_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_capture(loop, options, max_iter)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - t0))
        per = dict(out[1].per_replay)
        colls = dict(out[2].counts)
        devex = int(loop.w is not None)
        reprice = int(loop.costs0 is not None)
        require(per == {n: L for n in SLICES}, f"the sharded window graph "
                f"holds {per}, not {L} of each of {SLICES}")
        require(colls == {"all_gather": (2 + devex) * L + reprice,
                          "all_reduce": L + reprice},
                f"the sharded window graph holds the collectives {colls}")
        per_pivot.append(sum(per.values()) / L)
        return out

    def loop(tab, shard, options, max_iter, costs0=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "old":
            out, st, it = ps.solve_loop_blocked_sharded_reference(
                tab, shard, options, max_iter, costs0)
        else:
            out, st, it = real(tab, shard, options, max_iter, costs0,
                               graph=way == "graph")
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, it))
        final = {"Tt": out.Tt, "b": out.b, "costs": out.costs, "z": out.z,
                 "base": out.base, "status": torch.tensor(st),
                 "iterations": torch.tensor(it)}
        if keep is not None:
            keep.append({k: v.clone() for k, v in final.items()})
        if against is not None:
            for k, want in against[len(calls) - 1].items():
                equal(f"sharded blocked {way} loop call {len(calls)} {k}",
                      final[k], want)
        return out, st, it

    ps.solve_loop_blocked_sharded = loop
    ps.capture_blocked_window_sharded = capture
    try:
        res, wall = timed_sharded(p, group, opts)
    finally:
        ps.solve_loop_blocked_sharded = real
        ps.capture_blocked_window_sharded = real_capture
    require(len(captures) == (len(calls) if way == "graph" else 0),
            f"{len(captures)} captures in {len(calls)} sharded blocked loop "
            "calls")
    pivots = sum(c[1] for c in calls)
    loop_s = sum(c[0] for c in calls)
    return dict(res=res, wall=wall, calls=calls, captures=captures,
                per_pivot=per_pivot, pivots=pivots,
                ms_pivot=1e3 * loop_s / pivots)


def phase_blocked_sharded(launches: dict) -> None:
    """The plain blocked sharded loop (``solve_sharded`` with the f64
    tableau at L=128, the full f64 re-solve's options) at one NCCL rank,
    in this process: random_2048_2048 three ways in turns -- one CUDA
    graph a window with its collectives inside (the slice kernels' launch
    counters set to 0 just before and read just after), ``graph=False``
    (every loop call's final state the graph run's bit for bit) and the
    old body -- each within 1e-9 of the golden and walking the recorded
    ``BLOCKED_WALK``, graph and ``graph=False`` at the recorded objective
    bit for bit; random_8192_8192 graphed, walking ``BLOCKED_WALK_8192``
    to its recorded objective bit for bit; the f64 north-star phase-1
    tableau (10,000 x 100,000) for 256 pivots through the single-card
    ``run_solve_loop`` and then as the rank's slice through
    ``run_solve_loop_sharded``, z and the basis equal; the pure-f32
    tableau with the kernels off (its window's graph holding the
    re-pricing's collectives) on random_2048_2048 within 1e-3. Each run's
    ms/pivot, capture ms and kernels a pivot by the captured launch
    counts, beside the card's name and power limit."""
    import tempfile

    import torch

    from simplex_tpu_torch.bench import bench_problem, build_bench_state
    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel.sharded import (
        build_phase1_sharded, gaussian_eliminate_sharded,
        run_solve_loop_sharded, sharded_padded_dims)
    from simplex_tpu_torch.solver import run_solve_loop

    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        keep: list = []
        p = benchmark_problem(2048)
        for i, way in enumerate(("graph", "eager", "old")):
            kb.reset_launches()
            ke.reset_launches()
            r = blocked_sharded_loops(p, group, BLOCKED_F64, way,
                                      keep=keep if i == 0 else None,
                                      against=keep if way == "eager"
                                      else None)
            if i == 0:
                for name in SLICES:
                    launches[name] = ke.SLICE_LAUNCHES[name]
                require(min(launches[n] for n in SLICES) > 0,
                        f"the sharded plain blocked loop launched "
                        f"{ke.SLICE_LAUNCHES}")
            require(not any(kb.LAUNCHES.values()), f"K1-K5 launched: "
                    f"{kb.LAUNCHES}")
            res = r["res"]
            label = f"sharded, 1 rank, f64 L=128 random_2048_2048 {way}"
            check_objective(label, res, OBJ_2048, 1e-9)
            w = (res.iterations_phase1, res.iterations_phase2)
            require(w == BLOCKED_WALK, f"{label} walked {w}, recorded "
                    f"{BLOCKED_WALK}")
            require(way == "old" or res.objective == BLOCKED_OBJ[2048],
                    f"{label} reached {res.objective!r}, recorded "
                    f"{BLOCKED_OBJ[2048]!r} bit for bit")
            log(seq_line(label, r, "window") + f"; OPTIMAL objective "
                f"{res.objective!r} (golden {OBJ_2048!r}); pivots "
                f"{w[0]}+{w[1]}" + (f"; launches {dict(ke.SLICE_LAUNCHES)}"
                                    if i == 0 else "") + f"; {smi}")
        log("sharded, 1 rank, f64 L=128 random_2048_2048: graph, "
            "graph=False and the old body walked the recorded pivots, every "
            "loop call of graph=False ending in the graph run's state bit "
            "for bit, graph and graph=False at the recorded objective bit "
            "for bit")
        del keep

        torch.cuda.reset_peak_memory_stats()
        r = blocked_sharded_loops(benchmark_problem(8192), group,
                                  BLOCKED_F64, "graph")
        res = r["res"]
        label = "sharded, 1 rank, f64 L=128 random_8192_8192 graph"
        check_objective(label, res, OBJ_8192, 1e-9)
        w = (res.iterations_phase1, res.iterations_phase2)
        require(w == BLOCKED_WALK_8192 and res.objective == BLOCKED_OBJ[8192],
                f"{label} walked {w} to {res.objective!r}, recorded "
                f"{BLOCKED_WALK_8192} to {BLOCKED_OBJ[8192]!r}")
        log(seq_line(label, r, "window") + f"; OPTIMAL objective "
            f"{res.objective!r}; pivots {w[0]}+{w[1]}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {smi}")
        del res, r
        torch.cuda.empty_cache()

        # The f64 north-star phase-1 tableau for 256 pivots (2 windows):
        # single-card, then as the one rank's slice.
        opts = SolverOptions(**BLOCKED_F64)
        n, m, cap = 100_000, 10_000, 256
        walls = {}
        tab, costs0 = build_bench_state(n, m, torch.float64, opts, {},
                                        "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab, st1, it1 = run_solve_loop(tab, opts, cap, costs0)
        torch.cuda.synchronize()
        walls["single-card"] = time.perf_counter() - t0
        z1, base1 = float(tab.z), tab.base.cpu()
        gb = tab.Tt.numel() * 8 / 1e9
        del tab, costs0
        torch.cuda.empty_cache()
        R_pad, M_pad = sharded_padded_dims(n, m, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        A, b = bench_problem(n, m, torch.device("cuda"))
        tab = build_phase1_sharded(A, b, n, m, shard, opts, M_pad, "cuda")
        del A
        costs0 = tab.costs
        tab = gaussian_eliminate_sharded(tab, shard)
        ke.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab, st2, it2 = run_solve_loop_sharded(tab, shard, opts, cap, costs0)
        torch.cuda.synchronize()
        walls["sharded"] = time.perf_counter() - t0
        require(it1 == it2 == cap, f"f64 north-star: {it1} / {it2} pivots")
        require(float(tab.z) == z1 and torch.equal(tab.base.cpu(), base1),
                f"sharded f64 north-star: z {float(tab.z)!r} vs the "
                f"single-card loop's {z1!r}, or another basis")
        require(min(ke.SLICE_LAUNCHES[k] for k in SLICES) == cap,
                f"sharded f64 north-star launched {ke.SLICE_LAUNCHES}")
        log(f"f64 north-star 10000x100000 phase-1 tableau "
            f"{tuple(tab.Tt.shape)} ({gb:.2f} GB), L=128, {cap} pivots: "
            f"single-card {1e3 * walls['single-card'] / cap:.4f} ms/pivot, "
            f"sharded at 1 rank {1e3 * walls['sharded'] / cap:.4f} ms/pivot "
            f"(each with its capture), z {z1!r} and the basis equal; {smi}")
        del tab, costs0
        torch.cuda.empty_cache()

        ke.reset_launches()
        r = blocked_sharded_loops(benchmark_problem(2048), group,
                                  BLOCKED_F32, "graph")
        res = r["res"]
        label = ("sharded, 1 rank, f32 (f32 vectors, use_pallas=False) L=128 "
                 "random_2048_2048 graph")
        check_objective(label, res, OBJ_2048, 1e-3)
        require(min(ke.SLICE_LAUNCHES[k] for k in SLICES) > 0,
                f"{label} launched {ke.SLICE_LAUNCHES}")
        w = (res.iterations_phase1, res.iterations_phase2)
        log(seq_line(label, r, "window") + f"; OPTIMAL objective "
            f"{res.objective!r} (golden {OBJ_2048!r}, rel "
            f"{abs(res.objective - OBJ_2048) / OBJ_2048:.2e}); pivots "
            f"{w[0]}+{w[1]}; {smi}")
    torch.cuda.empty_cache()


def slice_pivot(loops, t: int, opts, kernel: bool, cap: int) -> None:
    """Pivot t of ``run_blocked_pivot_sharded`` on the slices ``loops`` of
    one card in this process: the collectives as torch ops in rank order
    (gathers stacked, the columns summed), each slice's kernels -- or their
    plain versions -- between them."""
    import torch

    from simplex_tpu_torch.kernels import eta as ke

    eps = float(opts.eps_resolved)
    policy = dict(bland_static=opts.pivot_rule_resolved == "bland",
                  threshold=opts.bland_threshold)
    devex = loops[0].w is not None
    V = torch.stack([lp.send_v for lp in loops])
    I = torch.stack([lp.send_i for lp in loops])
    for lp in loops:
        lp.recv_v.copy_(V)
        lp.recv_i.copy_(I)
        args = (lp.Tt, lp.C, lp.F, lp.recv_v, lp.recv_i, lp.recv_w, lp.ah,
                lp.w, lp.wh, lp.s, t, cap, eps, lp.shard.offset)
        if kernel:
            ke.eta_fold_column(*args)
        else:
            ke.eta_fold_column_plain(*args)
    total = loops[0].ah.clone()
    for lp in loops[1:]:
        total += lp.ah
    for lp in loops:
        lp.ah.copy_(total)
        args = (lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base, lp.w, lp.ah,
                lp.s, t, lp.r_loc, eps, cap)
        out = dict(offset=lp.shard.offset, wh=lp.wh, send_v=lp.send_v,
                   send_i=lp.send_i, send_w=lp.send_w)
        if kernel:
            ke.eta_ratio_summed(lp.b, lp.ah, lp.s, eps)
            ke.eta_colk_slice(*args, lp.ws, **out, **policy)
        else:
            ke.eta_ratio_summed_plain(lp.b, lp.ah, lp.s, eps)
            ke.eta_colk_slice_plain(*args, *out.values(), **policy)
    if devex:
        W = torch.stack([lp.send_w for lp in loops])
        for lp in loops:
            lp.recv_w.copy_(W)


class PriorLib:
    """A tool of ``tools/`` built as a library (``-D<define> -shared``) by
    nvcc in the background, into ``td``: kernels as the port launched them
    before a redesign, with C entry points -- ``tools/eta_variants.cu``'s
    ``slice_prior`` (``eta_fold_column``, ``eta_ratio_summed``) and
    ``colk_prior`` (``eta_colk``, ``eta_colk_slice``),
    ``tools/seq_variants.cu``'s ``seq_prior`` (``seq_fold_column``,
    ``seq_ratio_colk_sharded``) and ``k5_prior`` (K5 with its head).
    ``load`` waits for the build and gives the entry points their argument
    types; ``stop`` ends it if it still runs."""

    def __init__(self, td: str, tool: str, define: str,
                 argtypes: dict) -> None:
        from simplex_tpu_torch.kernels import _build

        self.tool, self.argtypes, self.lib = tool, argtypes, None
        self.path = pathlib.Path(td) / f"lib{define.lower()}.so"
        self.proc = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
             f"-D{define}", "-o", str(self.path),
             str(ROOT / "tools" / tool)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def load(self):
        import ctypes

        if self.lib is None:
            _, err = self.proc.communicate(timeout=600)
            require(self.proc.returncode == 0, f"nvcc of tools/{self.tool} "
                    f"as a library failed: {err[-2000:]}")
            self.lib = ctypes.CDLL(str(self.path))
            for name, types in self.argtypes.items():
                getattr(self.lib, name).argtypes = types
        return self.lib

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def prior_eta_lib(td: str) -> PriorLib:
    """``tools/eta_variants.cu`` as a library (``PriorLib``)."""
    import ctypes

    from simplex_tpu_torch.kernels import _build

    P, I, D, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                   ctypes.c_longlong)
    sig = _build.SIGNATURES
    return PriorLib(td, "eta_variants.cu", "ETA_VARIANTS_LIB", {
        "prior_eta_fold_column_launch":
            [P] * 4 + [I] * 5 + [P, P, P, I, I, P, P, P, LL, D, I, I, I, P],
        "prior_eta_ratio_summed_launch": [P, P, I, D, P, LL, P, I, I, P],
        "prior_eta_colk_slice_launch": sig["eta_colk_slice_launch"],
        "prior_eta_colk_launch": sig["eta_colk_launch"]})


def prior_seq_lib(td: str) -> PriorLib:
    """``tools/seq_variants.cu`` as a library (``PriorLib``): the earlier
    ``seq_ratio_colk_sharded`` takes no threads argument; the earlier K5
    with its head takes ``ah_head_launch``'s."""
    from simplex_tpu_torch.kernels import _build

    sig = _build.SIGNATURES
    pass_sig = list(sig["seq_ratio_colk_sharded_launch"])
    del pass_sig[18]                             # the cluster's threads
    return PriorLib(td, "seq_variants.cu", "SEQ_VARIANTS_LIB", {
        "prior_seq_fold_column_launch": sig["seq_fold_column_launch"],
        "prior_seq_ratio_colk_sharded_launch": pass_sig,
        "prior_ah_head_launch": sig["ah_head_launch"]})


def unlike(x):
    """Every element other than x's."""
    import torch

    if x.dtype == torch.bool:
        return ~x
    if x.is_floating_point():
        return torch.where(torch.isnan(x), torch.ones_like(x),
                           torch.full_like(x, float("nan")))
    return x + 1


def prior_turns(label: str, tensors, checks: dict, timed: dict) -> dict:
    """Kernels against the forms before their redesign. ``checks``: name
    -> (the earlier form's call, the new one's, the names in
    ``tensors()`` -- name -> tensor, the state they read and write --
    that the kernel writes and does not read): each form runs from one
    saved state, the new one after each of those was set to a value other
    than the one the earlier form wrote (``unlike``), so a kernel that
    skipped a store fails; then every tensor bit for bit. ``timed``: name
    -> (earlier, new) calls, each timed in turns by ``graph_ms`` (before,
    after, after, before) from that state. Returns each timed name's
    ``before_ms`` and ``turn_ms`` (the mean of its two turns)."""
    import torch

    def state():
        torch.cuda.synchronize()
        return {n: x.clone() for n, x in tensors().items()}

    def put(saved):
        live = tensors()
        for key, x in saved.items():
            live[key].copy_(x)

    start = state()
    for name, (old, new, writes) in checks.items():
        put(start)
        old()
        want = state()
        put(start)
        put({key: unlike(want[key]) for key in writes})
        new()
        got = state()
        for key, x in got.items():
            equal(f"{name} against the form before its redesign: {key}", x,
                  want[key])
    put(start)
    out: dict = {}
    for name, (old, new) in timed.items():
        times: dict = {"before": [], "after": []}
        for which in ("before", "after", "after", "before"):
            times[which].append(graph_ms(old if which == "before" else new))
        put(start)
        out[name] = {"before_ms": statistics.mean(times["before"]),
                     "turn_ms": statistics.mean(times["after"])}
        log(f"{name} {label} in turns with the form before its redesign "
            f"(CUDA graphs of 50 calls): before "
            f"{', '.join(f'{1e3 * x:.3f}' for x in times['before'])} us, "
            f"after {', '.join(f'{1e3 * x:.3f}' for x in times['after'])}"
            f" us; bit for bit; {nvidia_smi_line()}")
    return out


#: The gathered candidates' edge states of the ranks' fold checks
#: (``fold_gathered``; tests/test_torch_rank_fold.py's).
FOLD_EDGES = ("own", "other", "tie", "tie-late", "signed-zero", "nan-first",
              "nan-mid", "nan-last", "bland-own", "bland-other", "inf-none",
              "inf-mid")

#: What the K5 head writes and does not read: the folded candidates and
#: the step before K5, and the column.
K5_HEAD_WRITES = ("h_d", "v_d", "w_d", "h_b", "v_b", "w_b", "active", "h",
                  "minc", "optimal", "wh", "own", "hl", "ah")


def fold_gathered(P: int, kv: int, edge: str, R: int, dev):
    """V (P, kv) f64 and I (P, 2) int32 on ``dev``, the candidates P ranks
    of ``R`` columns each packed, in state ``edge``: rank q's main
    candidate in its own columns with value 0.5 q - 0.75 (rank 0 best:
    own), or rank P - 1 best (other), every rank equal (tie), every rank
    but 0 equal and best (tie-late), +0.0 and -0.0 alternating
    (signed-zero), a NaN at rank 0, P // 2 or P - 1 with rank P - 1 best
    otherwise, Bland candidates at rank 0 and the odd ranks (bland-own)
    or at every rank but 0 (bland-other), else none (BIG_INDEX), every
    value +inf (inf-none) or rank P // 2's -inf (inf-mid). Under devex (kv
    5) the key is -v_d and the weights differ from rank to rank."""
    import numpy as np
    import torch

    big = 2 ** 31 - 1
    q = np.arange(P)
    vd = 0.5 * q - 0.75
    hb = np.full(P, big, dtype=np.int64)
    vb = np.full(P, np.inf)
    if edge == "other":
        vd[P - 1] = -2.0
    elif edge == "tie":
        vd[:] = -0.75
    elif edge == "tie-late":
        vd[1:] = -2.0
    elif edge == "signed-zero":
        vd = np.where(q % 2 == 0, 0.0, -0.0)
    elif edge.startswith("nan"):
        if P > 1:
            vd[P - 1] = -2.0
        vd[{"nan-first": 0, "nan-mid": P // 2, "nan-last": P - 1}[edge]] = \
            np.nan
    elif edge == "bland-own":
        on = (q % 2 == 1) | (q == 0)
        hb = np.where(on, q * R + 1, big)
        vb = np.where(on, -0.25 * q - 0.5, np.inf)
    elif edge == "bland-other":
        hb = np.where(q > 0, q * R + 2, big)
        vb = np.where(q > 0, -0.25 * q, np.inf)
    elif edge == "inf-none":
        vd[:] = np.inf
    elif edge == "inf-mid":
        vd[P // 2] = -np.inf
    V = np.zeros((P, kv))
    V[:, 0], V[:, 1] = vd, vb
    if kv == 5:
        V[:, 2] = 1.0 / 3.0 + 0.37 * q
        V[:, 3] = 2.0 + 0.11 * q
        V[:, 4] = -vd
    I = np.stack([q * R + 12345 % R, hb], axis=1).astype(np.int32)
    return (torch.from_numpy(V).to(dev), torch.from_numpy(I).to(dev))


def same_bits(name: str, got, want) -> None:
    """``equal``, and the sign of every zero kept."""
    import torch

    equal(name, got, want)
    if got.is_floating_point():
        equal(f"{name} (signs)", torch.signbit(got) & ~torch.isnan(got),
              torch.signbit(want) & ~torch.isnan(want))


def compare_ways(label: str, tensors, reset, writes, ways: dict) -> None:
    """``ways``: name -> call, the first the plain chain. Each runs after
    ``reset()``, the others with each name in ``writes`` first set to a
    value other than the one the first wrote (``unlike``), so a kernel
    that skipped a store fails; then every tensor of ``tensors()`` (name
    -> tensor) bit for bit with the first's (``same_bits``)."""
    import torch

    want = None
    for name, fn in ways.items():
        reset()
        if want is not None:
            live = tensors()
            for key in writes:
                live[key].copy_(unlike(want[key]))
        fn()
        torch.cuda.synchronize()
        got = {key: x.clone() for key, x in tensors().items()}
        if want is None:
            want = got
            continue
        for key, x in got.items():
            same_bits(f"{label}, {name}: {key}", x, want[key])


def seq_fold_edges(prior: PriorLib, M: int, R: int, max_iter: int) -> int:
    """``seq_fold_column`` against its plain version and its form before
    the redesign (``prior``) on one slice of R columns (rank 0's) of a
    seeded M x R tableau, from every ``fold_gathered`` state at P = 1, 3,
    8 and 33, the Bland flag off and on, in the three dtype pairs: every
    scalar and the column bit for bit (``compare_ways``). Returns the
    states checked."""
    import ctypes

    import torch

    from simplex_tpu_torch.kernels import seq as ks

    lib = prior.load()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261028)
    f64, f32 = torch.float64, torch.float32
    n = 0
    for pair, (T, Vd) in (("f64", (f64, f64)), ("mixed", (f32, f64)),
                          ("f32", (f32, f32))):
        eps = 1e-9 if Vd == f64 else 1e-4
        Tt = torch.rand((M, R), generator=g, device=dev, dtype=T) * 2 - 1
        ah = torch.empty(M, dtype=T, device=dev)
        for bland in (False, True):
            s = ks.seq_scalars(torch.tensor(1.5, dtype=Vd, device=dev),
                               bland, T)
            s.iterations.fill_(3)
            init = {key: x.clone() for key, x in s.tensors().items()}

            def tensors():
                return {**s.tensors(), "ah": ah}

            def reset():
                for key, x in init.items():
                    getattr(s, key).copy_(x)
                ah.fill_(float("nan"))

            for P in (1, 3, 8, 33):
                for edge in FOLD_EDGES:
                    V, I = fold_gathered(P, 2, edge, R, dev)

                    def before():
                        err = lib.prior_seq_fold_column_launch(
                            Tt.data_ptr(), V.data_ptr(), I.data_ptr(), P, M,
                            R, 0, ah.data_ptr(),
                            ctypes.byref(ks._seq_ptrs(s)), max_iter, eps,
                            ks._pair(s),
                            torch.cuda.current_stream().cuda_stream)
                        require(err == 0, "the earlier seq_fold_column "
                                f"failed ({err})")

                    compare_ways(
                        f"seq_fold_column {pair} P={P} {edge} bland={bland}",
                        tensors, reset, SEQ_SHARDED_WRITES["seq_fold_column"],
                        {"plain": functools.partial(
                            ks.seq_fold_column_plain, Tt, V, I, ah, s,
                            max_iter, eps, 0),
                         "kernel": functools.partial(
                             ks.seq_fold_column, Tt, V, I, ah, s, max_iter,
                             eps, 0),
                         "before": before})
                    n += 1
        del Tt, ah
        torch.cuda.empty_cache()
    return n


def k5_head_edges(prior: PriorLib, Tt, F, C, eps: float) -> int:
    """K5 with its head (``ah_fold_head``) against its plain chain
    (``sharded_fold_plain``, ``sharded_step_pre_plain``, then K5 without
    its head on the folded column and owner flag, which the kernel phase
    holds against K1's column) and its form before the redesign
    (``prior``) on rank 0's slice (``Tt``'s columns), from every
    ``fold_gathered`` state at P = 1, 3, 8 and 33, kv 2 and 5, the Bland
    flag off and on, at t = 0 and 37: every scalar and the column bit for
    bit (``compare_ways``). Returns the states checked."""
    import ctypes

    import torch

    from simplex_tpu_torch.kernels import blocked as kb

    lib = prior.load()
    dev = Tt.device
    M, R = Tt.shape
    big = 2 ** 30
    col = torch.empty(M, device=dev)
    n = 0
    for bland in (False, True):
        s = kb.sharded_scalars(torch.tensor(1.5, dtype=torch.float64,
                                            device=dev), bland)
        s.iterations.fill_(3)
        init = {key: x.clone() for key, x in s.tensors().items()}

        def tensors():
            return {**s.tensors(), "ah": col}

        def reset():
            for key, x in init.items():
                getattr(s, key).copy_(x)
            col.fill_(float("nan"))

        for t in (0, 37):
            for kv in (2, 5):
                for P in (1, 3, 8, 33):
                    for edge in FOLD_EDGES:
                        V, I = fold_gathered(P, kv, edge, R, dev)

                        def plain():
                            kb.sharded_fold_plain(s, V, I)
                            kb.sharded_step_pre_plain(s, big, eps, 0, R)
                            kb.ah(Tt, F, C, s.hl, t, own=s.own, out=col)

                        def before():
                            err = lib.prior_ah_head_launch(
                                Tt.data_ptr(), F.data_ptr(), C.data_ptr(), t,
                                M, R, col.data_ptr(),
                                ctypes.byref(kb._shard_step_ptrs(s)),
                                V.data_ptr(), I.data_ptr(), P, kv, big, eps,
                                0, torch.cuda.current_stream().cuda_stream)
                            require(err == 0, "the earlier K5 with its head "
                                    f"failed ({err})")

                        compare_ways(
                            f"K5 with its head t={t} kv={kv} P={P} {edge} "
                            f"bland={bland}", tensors, reset, K5_HEAD_WRITES,
                            {"plain": plain,
                             "kernel": functools.partial(
                                 kb.ah_fold_head, Tt, F, C, t, s, V, I, big,
                                 eps, 0, out=col),
                             "before": before})
                        n += 1
    return n


#: What each slice kernel writes and does not read (on a pivot without a
#: re-anchor): its scalars, the fold's live column and weight at h, the
#: pass's send buffers.
SLICE_WRITES = {
    "eta_fold_column": ("h_d", "v_d", "h_b", "v_b", "active", "h", "minc",
                        "optimal", "ah", "wh"),
    "eta_ratio_summed": ("k", "unb", "do", "p", "bk", "u"),
    "eta_colk_slice": ("send_v", "send_i", "send_w"),
}


def slice_turns(prior: PriorLib, lp, t: int, cap: int, eps: float,
                policy: dict, fold, ratio, colk) -> dict:
    """``eta_fold_column``, ``eta_ratio_summed`` and ``eta_colk_slice``
    (``fold``, ``ratio``, ``colk``: their wrappers' calls on the slice
    ``lp`` at pivot t, the pass under ``policy``) against the forms before
    their redesign (``prior``: the head's before its cluster, the pass's
    before its candidates carried their weights), bit for bit and timed in
    turns, with the head (the fold then the ratio test) (``prior_turns``).
    """
    import ctypes

    import torch

    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    lib = prior.load()
    s = lp.s
    M, R = lp.Tt.shape
    L = lp.C.shape[0]
    plan = ke.eta_plan(M, R, L, lp.Tt.element_size())
    pair = ks._pair(s)

    def ptr(x):
        return x.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def prior_fold():
        err = lib.prior_eta_fold_column_launch(
            ptr(lp.Tt), ptr(lp.C), ptr(lp.F), ptr(lp.ah), M, R, L, t, 0,
            ptr(lp.recv_v), ptr(lp.recv_i), ptr(lp.recv_w),
            lp.recv_v.shape[0], lp.recv_v.shape[1], ptr(lp.w), ptr(lp.wh),
            ctypes.byref(ks._seq_ptrs(s)), cap, eps, pair, plan.rows,
            plan.stage_ratio, stream())
        require(err == 0, f"the earlier eta_fold_column failed ({err})")

    def prior_ratio():
        err = lib.prior_eta_ratio_summed_launch(
            ptr(lp.b), ptr(lp.ah), M, eps, ptr(lp.ws), lp.ws.numel(),
            ctypes.byref(ks._seq_ptrs(s)), pair, plan.rows, stream())
        require(err == 0, f"the earlier eta_ratio_summed failed ({err})")

    def prior_colk():
        err = lib.prior_eta_colk_slice_launch(
            ptr(lp.Tt), ptr(lp.C), ptr(lp.F), ptr(lp.costs), ptr(lp.b),
            ptr(lp.base), ptr(lp.w), ptr(lp.ah), M, R, L, lp.r_loc, t, eps,
            ptr(lp.ws), lp.ws.numel(), ctypes.byref(ks._seq_ptrs(s)), cap,
            *ks._policy(policy["bland_static"], policy["threshold"]), pair,
            plan.rows, plan.cols, plan.stage_colk, 0, ptr(lp.wh),
            ptr(lp.send_v), ptr(lp.send_i), ptr(lp.send_w), stream())
        require(err == 0, f"the earlier eta_colk_slice failed ({err})")

    def tensors():
        return {**s.tensors(), **{n: getattr(lp, n) for n in (
            "ah", "wh", "w", "C", "F", "costs", "b", "base", "send_v",
            "send_i", "send_w")}}

    return prior_turns(
        f"f64 devex M={M} R={R} t={t} (one slice)", tensors,
        {"eta_fold_column": (prior_fold, fold,
                             SLICE_WRITES["eta_fold_column"]),
         "eta_ratio_summed": (prior_ratio, ratio,
                              SLICE_WRITES["eta_ratio_summed"]),
         "eta_colk_slice": (prior_colk, colk,
                            SLICE_WRITES["eta_colk_slice"])},
        {"eta_fold_column": (prior_fold, fold),
         "eta_ratio_summed": (prior_ratio, ratio),
         "head": (lambda: (prior_fold(), prior_ratio()),
                  lambda: (fold(), ratio())),
         "eta_colk_slice": (prior_colk, colk)})


def phase_slice_kernels(records: dict) -> None:
    """``_slice_kernels`` with the library of the earlier slice kernels
    built by nvcc in the background meanwhile (``prior_eta_lib``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        prior = prior_eta_lib(td)
        try:
            _slice_kernels(records, prior)
        finally:
            prior.stop()


def _slice_kernels(records: dict, prior: PriorLib) -> None:
    """The sharded plain blocked loop's kernels (``eta_fold_column``,
    ``eta_ratio_summed``, ``eta_colk_slice``) against their plain versions
    on the card at the main path's shape: the f64 phase-1 tableau of
    random_2048_2048 (M 2,048 x R 6,144), L=128, under devex, as two
    slices of the one card and as one slice, two sets of
    ``ShardedBlockedLoop``s -- the kernels on one, the plain versions on
    the other, the collectives torch ops between them (``slice_pivot``) --
    pivot by pivot through the window's first ``ETA_T`` pivots from edge
    states drawn by the pivot's index (Bland on, the fuse, a NaN in b, a
    weight past the re-anchor's bound on the last slice): every scalar,
    slice, factor, vector, weight and send buffer bit for bit. Then at t
    = ``ETA_T``, on a taken pivot at one slice: the three kernels against
    the forms before their redesign (``tools/eta_variants.cu`` built here
    as a library, ``slice_prior`` and ``colk_prior``; built by nvcc while
    the walk runs), bit for bit, and each, and the head (the fold then the
    ratio test, as a pivot runs them), timed in turns with them by CUDA
    events over CUDA graphs of 50 calls (before, after, after, before)
    (``slice_turns``); then each kernel timed by torch.profiler and by
    CUDA events over a CUDA graph of 50 calls beside its plain version,
    its bound and ``torch.addmv`` forming the live column (the fold's) or
    row (the pass's) alone: the kernels line's rows."""
    import dataclasses

    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.bench import pivot_work
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.tableau import gaussian_eliminate

    opts = st.SolverOptions(**BLOCKED_F64, pivot_rule="devex")
    eps = float(opts.eps_resolved)
    cap = 10_000
    p = benchmark_problem(2048)
    n, m = p.vars, p.constraints
    seen: collections.Counter = collections.Counter()
    for P in (2, 1):
        R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
        whole = gaussian_eliminate(ps.build_phase1_sharded(
            torch.as_tensor(p.A), torch.as_tensor(p.b, device="cuda"), n, m,
            pg.Shard(None, 0, 1, R_pad), opts, M_pad, "cuda"))
        sets = [[ps.sharded_blocked_loop(
            dataclasses.replace(sl, Tt=sl.Tt.clone()),
            pg.Shard(None, r, P, R_pad // P), opts)
            for r, sl in ((r, ps.shard_tableau(whole, r, P))
                          for r in range(P))] for _ in range(2)]
        del whole
        for t in range(ETA_T):
            edge = t % 6
            for loops in sets:
                for lp in loops:
                    lp.s.bland.fill_(edge == 1)
                    lp.s.iterations.fill_(cap if edge == 2 else 3)
                    lp.s.status.fill_(int(st.Status.RUNNING))
                if edge == 3:
                    for lp in loops:
                        lp.b[(t * 37) % M_pad] = float("nan")
                elif edge == 4:
                    loops[-1].w[t] = 3e8
            slice_pivot(sets[0], t, opts, True, cap)
            slice_pivot(sets[1], t, opts, False, cap)
            for r, (a, b) in enumerate(zip(*sets)):
                for name, x in a.s.tensors().items():
                    equal(f"slice kernels P={P} t={t} rank {r} {name}", x,
                          getattr(b.s, name))
                for name in ("Tt", "C", "F", "b", "costs", "base", "w", "ah",
                             "wh", "send_v", "send_i", "send_w"):
                    equal(f"slice kernels P={P} t={t} rank {r} {name}",
                          getattr(a, name), getattr(b, name))
            seen[(P, edge, bool(sets[0][0].s.do))] += 1
            for loops in sets:
                for lp in loops:
                    lp.b.nan_to_num_(nan=1.0)
                    lp.s.z.nan_to_num_(nan=0.0)
        if P == 2:
            del sets
            torch.cuda.empty_cache()
    require(seen[(1, 0, True)] > 0 and seen[(2, 0, True)] > 0
            and seen[(1, 2, False)] > 0, f"the walks saw {dict(seen)}")
    log(f"slice kernels (f64, devex, M={M_pad} R={R_pad}, L=128) at 2 slices"
        f" of the card and at 1: every scalar, vector, factor, weight and "
        f"send buffer equal the plain versions' over pivots t = 0.."
        f"{ETA_T - 1} ({dict(seen)})")

    # Each timed at t = ETA_T on a taken pivot at one slice.
    lp = sets[0][0]
    del sets
    t = ETA_T
    s = lp.s
    s.status.fill_(int(st.Status.RUNNING))
    s.iterations.fill_(3)
    s.bland.fill_(False)
    M, R = lp.Tt.shape
    L = lp.C.shape[0]
    policy = dict(bland_static=False, threshold=opts.bland_threshold)
    lp.recv_v.copy_(lp.send_v.view(1, -1))
    lp.recv_i.copy_(lp.send_i.view(1, -1))
    lp.recv_w.copy_(lp.send_w.view(1))
    W = lp.recv_w
    fold = functools.partial(ke.eta_fold_column, lp.Tt, lp.C, lp.F,
                             lp.recv_v, lp.recv_i, W, lp.ah, lp.w, lp.wh, s,
                             t, cap, eps, 0)
    fold()
    ratio = functools.partial(ke.eta_ratio_summed, lp.b, lp.ah, s, eps)
    ratio()
    require(bool(s.do), "slice kernels: the timed pivot is not taken")
    h, k = int(s.h), int(s.k)
    colk = functools.partial(ke.eta_colk_slice, lp.Tt, lp.C, lp.F, lp.costs,
                             lp.b, lp.base, lp.w, lp.ah, s, t, lp.r_loc, eps,
                             cap, lp.ws, offset=0, wh=lp.wh,
                             send_v=lp.send_v, send_i=lp.send_i,
                             send_w=lp.send_w, **policy)
    before = slice_turns(prior, lp, t, cap, eps, policy, fold, ratio, colk)
    timed = {
        "eta_fold_column": (
            fold, functools.partial(
                ke.eta_fold_column_plain, lp.Tt, lp.C, lp.F, lp.recv_v,
                lp.recv_i, W, lp.ah, lp.w, lp.wh, s, t, cap, eps, 0),
            "eta_fold_column_kernel",
            bound(8 * (t * M + 2 * M + t), f64_flops=2 * t * M),
            functools.partial(torch.addmv, lp.Tt[:, h], lp.F[:t].t(),
                              lp.C[:t, h], alpha=-1.0)),
        "eta_ratio_summed": (
            ratio, functools.partial(ke.eta_ratio_summed_plain, lp.b, lp.ah,
                                     s, eps),
            "eta_ratio_summed_kernel", bound(8 * 2 * M, f64_flops=M),
            None),
        "eta_colk_slice": (
            colk, functools.partial(
                ke.eta_colk_slice_plain, lp.Tt, lp.C, lp.F, lp.costs, lp.b,
                lp.base, lp.w, lp.ah, s, t, lp.r_loc, eps, cap, 0, lp.wh,
                lp.send_v, lp.send_i, lp.send_w, **policy),
            "eta_colk_kernel",
            bound(*pivot_work(M, R, L, t, True, 8)["colk_costs"]),
            functools.partial(torch.addmv, lp.Tt[k], lp.C[:t].t(),
                              lp.F[:t, k], alpha=-1.0)),
    }
    for name, (fn, plain_fn, match, (bound_ms, by), lib) in timed.items():
        require(kernels_launched(fn) == 1, f"one {name} call launched "
                "more than one kernel")
        ms = device_ms(fn, 50, match=match)
        rec = {"max_abs_err": 0.0, "ms": ms,
               "plain_ms": device_ms(plain_fn, 5),
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": None if lib is None else device_ms(lib, 50),
               "check_ms": graph_ms(fn), **before.get(name, {})}
        records[name] = rec
        log(f"{name} f64 devex M={M} R={R} t={t} (one slice): {ms:.5f} ms a "
            f"call (torch.profiler), {rec['check_ms']:.5f} ms by CUDA "
            f"events over a CUDA graph of 50 calls, plain "
            f"{rec['plain_ms']:.4f} ms, "
            + ("no one library call" if lib is None else
               f"addmv forming the live "
               f"{'column' if name == 'eta_fold_column' else 'row'} "
               f"{rec['library_ms']:.5f} ms")
            + f", bound {bound_ms:.5f} ms ({by}), "
            f"{100 * bound_ms / ms:.1f}% of it; {nvidia_smi_line()}")
    del lp
    torch.cuda.empty_cache()


#: The sharded plain blocked loop's kernels in a trace of its window.
SLICE_GRAPH_KERNELS = ("eta_fold_column_kernel", "eta_ratio_summed_kernel",
                       "eta_colk_kernel")


def phase_blocked_sharded_trace() -> None:
    """random_2048_2048 with ``BLOCKED_F64`` through ``solve_sharded`` at
    one NCCL rank, its phase-1 loop call traced by torch.profiler (CUDA
    activity): each replayed window's nodes (from the two copies before
    its first ``eta_fold_column`` to those before the next window's --
    the kernels, NCCL's nodes or copies, the apply's cuBLAS kernels): the
    slice kernels a pivot (3), the copies a pivot; the device's busy share
    inside a window and over its period (the host's read of status and
    the next replay included); the middle window's nodes by name and
    their us a pivot. Runs after every timed solve."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    L = BLOCKED_F64["block_pivots"]
    real = ps.solve_loop_blocked_sharded
    first: list = []

    def loop(*args, **kw):
        if first:
            return real(*args, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kw)
            torch.cuda.synchronize()
        first.append((prof, out[2]))
        return out

    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        def run():
            first.clear()
            ps.solve_loop_blocked_sharded = loop
            try:
                timed_sharded(benchmark_problem(2048), group, BLOCKED_F64)
            finally:
                ps.solve_loop_blocked_sharded = real
            return first[0]

        prof, pivots = until_traced(run, "the sharded blocked window trace")
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]

    def kind(e):
        if "nccl" in e["name"] or "DtoD" in e["name"]:
            return "copy/nccl"
        return next((n for n in SLICE_GRAPH_KERNELS if n in e["name"]),
                    e["name"][:40])

    nodes = sorted((e for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy")),
                   key=lambda e: e["ts"])
    folds = [i for i, e in enumerate(nodes)
             if kind(e) == "eta_fold_column_kernel"]
    starts = [max(folds[i] - 2, 0) for i in range(0, len(folds), L)]
    windows = [nodes[a:b] for a, b in zip(starts, starts[1:])]
    require(len(windows) >= 3, f"the trace holds {len(windows)} whole "
            "windows")

    def busy(c):
        total, end = 0.0, float("-inf")
        for e in c:
            lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
        return total

    inside, period, kernels, copies = [], [], [], []
    for i, c in enumerate(windows):
        span = max(e["ts"] + e["dur"] for e in c) - c[0]["ts"]
        inside.append(busy(c) / span)
        period.append(busy(c) / (nodes[starts[i + 1]]["ts"] - c[0]["ts"]))
        kernels.append(sum(kind(e) in SLICE_GRAPH_KERNELS for e in c) / L)
        copies.append(sum(kind(e) == "copy/nccl" for e in c) / L)
    require(all(k == 3.0 for k in kernels), f"{kernels} slice kernels a "
            "pivot in the traced windows, not 3")
    mid = windows[len(windows) // 2]
    names = dict(collections.Counter(kind(e) for e in mid))
    by_name: dict = collections.defaultdict(float)
    for e in mid:
        by_name[kind(e)] += e["dur"] / L
    span = max(e["ts"] + e["dur"] for e in mid) - mid[0]["ts"]

    def spread(x):
        return min(x), statistics.median(x), max(x)

    ins, per = spread(inside), spread(period)
    log(f"sharded 1-rank f64 L={L} random_2048_2048 phase-1 loop traced "
        f"({pivots} pivots, {len(windows)} whole windows): 3 slice kernels "
        f"and {min(copies):.5f}-{max(copies):.5f} copy/NCCL nodes a pivot "
        f"(the middle window: {names}); device busy inside a window "
        f"{100 * ins[0]:.1f}-{100 * ins[2]:.1f}% (median {100 * ins[1]:.1f}"
        f"%), over a window's period with the host read {100 * per[0]:.1f}-"
        f"{100 * per[2]:.1f}% (median {100 * per[1]:.1f}%); the middle "
        f"window's nodes {sum(by_name.values()):.2f} us a pivot ("
        + ", ".join(f"{n} {us:.3f}" for n, us in by_name.items())
        + f"), its span {span:.1f} us = {span / L:.2f} us a pivot; "
        f"{nvidia_smi_line()}")


def seq_sharded_rank(group, device, cases):
    """A spawned rank: the sequential kernels' launch counters set to 0
    just before ``solve_sharded`` of each (problem, options) in ``cases``
    and read just after. Returns (the results, every rank's counts of
    ``SHARDED_SEQ_PATH`` in rank order)."""
    import torch.distributed as dist

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import seq as ks

    ks.reset_launches()
    res = [st.solve_sharded(p, group, o, device=device) for p, o in cases]
    counts = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, {k: ks.LAUNCHES[k]
                                    for k in SHARDED_SEQ_PATH}, group=group)
    return res, counts


def phase_sharded_two_ranks(r2048) -> None:
    """Two ranks on the one card over gloo (spawned processes; gloo moves
    the CUDA tensors through host memory, so these times say nothing of
    sharded speed): random_2048_2048 in production walking as at one rank
    to the same certified objective (1e-12); random_1024_1024 with the
    default options (the sequential sharded loop, eager over gloo, its
    kernels on each rank's slice) walking as ``solve`` (1,871 + 64) to the
    golden within 1e-9, ``SHARDED_SEQ_PATH`` launched on each rank; then
    the fleet of config 3's first 64 lanes, 32 a rank, every lane bit for
    bit as ``solve_batch`` gives it on one device, K7-K10 launched on each
    rank."""
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel.group import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (two, f64), counts = spawn(
        seq_sharded_rank, 2, "gloo", "cuda",
        [(benchmark_problem(2048), st.SolverOptions(**PROD)),
         (benchmark_problem(1024), st.SolverOptions())])
    wall = time.perf_counter() - t0
    label = "sharded, 2 gloo ranks on one card, f64 random_1024_1024"
    check_objective(label, f64, OBJ_1024, 1e-9)
    w = (f64.iterations_phase1, f64.iterations_phase2)
    require(w == F64_WALKS[1024], f"{label} walked {w}, solve "
            f"{F64_WALKS[1024]}")
    for rank, c in enumerate(counts):
        for name in SHARDED_SEQ_PATH:
            require(c[name] > 0, f"{label}: {name} never launched on rank "
                    f"{rank}")
    log(f"{label}: objective {f64.objective!r}, pivots {w[0]}+{w[1]} as "
        f"solve; launches per rank {counts}")
    w1 = (r2048.iterations_phase1, r2048.iterations_phase2)
    w2 = (two.iterations_phase1, two.iterations_phase2)
    check_certified("two-rank random_2048_2048", two, OBJ_2048)
    require(w2 == w1, f"two ranks walked {w2}, one rank {w1}")
    rel = abs(two.objective - r2048.objective) / abs(r2048.objective)
    require(rel <= 1e-12, f"two ranks: objective {two.objective!r} vs one "
            f"rank's {r2048.objective!r}")
    log(f"sharded, 2 gloo ranks on one card, random_2048_2048: pivots "
        f"{w2[0]}+{w2[1]} as at one rank, certified objective "
        f"{two.objective!r} (rel {rel:.1e}); {wall:.3f} s for it and the "
        f"f64 random_1024_1024 with the two processes' start")

    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100)
                for s in list(seeds)[:FLEET_LANES]]
    check_fleet("fleet, 2 gloo ranks on one card", 2, "gloo", problems)


def phase_sharded_cards(cards: int) -> None:
    """The sharded path and the fleet across ``cards`` cards of one host
    over NCCL, one card a rank (run when the host shows more than one
    card): random_2048_2048 and the flagship in production, each solved
    twice by the ranks (the second warm), certified within 1e-9 of the
    golden, their walks beside ``solve``'s on one card; random_1024_1024
    with the default options (the sequential sharded loop) walking as
    ``solve``; then config 3's 256 lanes split across the ranks
    (``check_fleet``)."""
    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel.group import spawn

    opts = st.SolverOptions(**PROD)
    cases = []
    for n, gold in ((2048, OBJ_2048), (8192, OBJ_8192)):
        single, wall = timed_solve(benchmark_problem(n))
        check_certified(f"random_{n}_{n} on one card", single, gold)
        cases.append((n, gold, single, wall))
    t0 = time.perf_counter()
    runs = spawn(time_sharded_rank, cards, "nccl", "cuda",
                 [(benchmark_problem(n), opts) for n, _, _, _ in cases
                  for _ in range(2)]
                 + [(benchmark_problem(1024), st.SolverOptions())])
    log(f"{cards} NCCL ranks: {len(runs)} sharded solves in "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
    f64, wall = runs.pop()
    label = f"f64 random_1024_1024 on {cards} NCCL ranks"
    check_objective(label, f64, OBJ_1024, 1e-9)
    w = (f64.iterations_phase1, f64.iterations_phase2)
    require(w == F64_WALKS[1024], f"{label} walked {w}, solve "
            f"{F64_WALKS[1024]}")
    log(f"{label} (the sequential sharded loop, one CUDA graph a chunk): "
        f"objective {f64.objective!r}, pivots {w[0]}+{w[1]} as solve; "
        f"wall {wall:.3f} s = {1e3 * wall / sum(w):.4f} ms/pivot")
    for i, (n, gold, single, wall1) in enumerate(cases):
        w1 = (single.iterations_phase1, single.iterations_phase2)
        for j, (res, wall) in enumerate(runs[2 * i:2 * i + 2]):
            label = f"random_{n}_{n} on {cards} NCCL ranks, solve {j + 1}"
            check_certified(label, res, gold)
            w = (res.iterations_phase1, res.iterations_phase2)
            log(f"{label}: certified objective {res.objective!r}, pivots "
                f"{w[0]}+{w[1]} (one card, solve(): {w1[0]}+{w1[1]} in "
                f"{wall1:.3f} s), refine {res.refine.method}; wall "
                f"{wall:.3f} s = {1e3 * wall / sum(w):.4f} ms/pivot")

    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    check_fleet(f"fleet of config 3 on {cards} NCCL ranks", cards, "nccl",
                problems)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    try:
        import simplex_tpu_torch  # noqa: F401
        from simplex_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{lib_path.name}")

    cards = torch.cuda.device_count()
    records: dict = {}
    # Launches on each kernel's path: K1-K4 the single-card flagship, K5
    # (and K2-K4 again) the sharded flagship, the sequential sharded
    # kernels the default-option sharded 8192^2, K6 the pure-f32 solve,
    # K7-K10 config 3's first call, batch_rank1 config 3 with the default
    # options; K11 and K12 are on no path.
    launches = {name: 0 for name in ORDER}
    sharded_launches: dict = {}
    t_start = time.perf_counter()
    # The earlier forms of the sequential sharded loop's kernels and of
    # K5's head, built by nvcc in the background while the phases run.
    prior_dir = tempfile.TemporaryDirectory()
    prior_seq = prior_seq_lib(prior_dir.name)
    try:
        phase_goldens({}, "default options, f64")
        phase_goldens(PROD, "production options")
        seq_ms: dict = {}
        walks = phase_reference_f64(launches, seq_ms)
        phase_pallas_seq(launches)
        phase_blocked_plain(launches, seq_ms)
        phase_cli()
        phase_r1024()
        walks[8192], flagship_wall = phase_flagship(launches)
        phase_window_graph()
        phase_resumable(flagship_wall)
        northstar = phase_northstar()
        r2048 = phase_sharded_one_rank(sharded_launches, walks, northstar)
        phase_blocked_sharded(launches)
        for name in ("ah", *SHARDED_STEPS, *SHARDED_SEQ_PATH[:2]):
            launches[name] = sharded_launches[name]
        phase_batch_spread()
        batch_launches: dict = {}
        problems3, res3 = phase_batch("config 3", CONFIG3, batch_launches,
                                      lanes=(0, 127, 255))
        # Every kernel of the batched path ran in config 3's first call
        # (batch_apply takes the off-cadence windows where no lane ends).
        for name in BATCH_PATH:
            require(batch_launches[name] > 0,
                    f"{name} never launched on the batched path")
            launches[name] = batch_launches[name]
        phase_default_batch(problems3, res3, launches)
        phase_fallback_blocked(problems3, res3)
        del problems3, res3
        phase_batch("wide lanes", WIDE)
        phase_tiers()
        phase_equilibrate()
        phase_sharded_two_ranks(r2048)
        if cards > 1:
            phase_sharded_cards(cards)
        phase_refine_sweep()
        phase_refine_flagship()
        t_bench = time.perf_counter()
        phase_bench()
        log(f"benchmark entry points in {time.perf_counter() - t_bench:.1f}"
            " s")
        phase_kernels(records, prior_seq)
        phase_pivot_kernel(records)
        phase_batch_kernels(records)
        phase_batch_reprice(records)
        phase_rank1_kernel(records)
        phase_seq_kernels(records)
        phase_sharded_seq_kernels(records, prior_seq)
        phase_eta_kernels(records)
        phase_slice_kernels(records)
        phase_batch_trace()
        phase_window_trace()
        phase_chunk_trace()
        phase_blocked_trace()
        phase_sharded_seq_trace()
        phase_blocked_sharded_trace()
        phase_sharded_trace()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        prior_seq.stop()
        prior_dir.cleanup()
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    # Each kernel's time by a second clock: K1, K2, K5 CUDA events over a
    # CUDA graph of 50 calls; K3/K4 torch.profiler (their record is CUDA
    # events); the rest CUDA events over back-to-back calls.
    log("cross-check, ms a call (record / second clock): " + ", ".join(
        f"{name} {records[name]['ms']:.4f} / {records[name]['check_ms']:.4f}"
        for name in ORDER))

    tables = {**KERNELS, **PIVOT_KERNELS, **BATCH_KERNELS,
              **FALLBACK_KERNELS, **STEP_KERNELS, **SHARDED_STEP_KERNELS,
              **SEQ_KERNELS, **ETA_KERNELS, **SLICE_KERNELS}
    kernels = []
    for name in ORDER:
        kid, replaces, source = tables[name]
        rec = records[name]
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
