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
3. the f64 reference path: random_1024_1024 and random_8192_8192 with
   the default options (the 8192^2 solve twice, the same walk both
   times), objectives within 1e-9 of the certified goldens, the pivot
   counts printed beside the JAX package's TPU record and the reference
   CUDA program's;
4. K6's path: random_2048_2048 through ``solve(dtype="float32",
   vector_dtype="float32", use_pallas=True)`` -- K6's launch counter
   reset just before and read just after -- then the 10,000 x 100,000 phase-1 tableau for 256
   pivots through ``solve_loop_pallas`` on the kernel and again on its
   plain version (the same choices, the same tableau);
5. the plain blocked loop: random_2048_2048 with ``dtype=float64,
   block_pivots=128``, no K1-K4 launch;
6. the CLI (``python -m simplex_tpu_torch.cli``): a problem file, the
   ``-t --limit 1024 --timer`` sweep (the reference's CSV schema), a
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
   solve must walk the same pivots);
9. the 10,000 x 100,000 phase-1 tableau built on the card, run for 256
   pivots (2 windows);
9a. the sharded path (``solve_sharded``) at world size 1 over NCCL, in
   this process: random_1024_1024 with the default options (the walk of
   ``solve``), random_2048_2048 and the flagship with the production
   options -- the flagship certified within 1e-9, walking as ``solve``
   did, with the launch counters reset just before it and read just
   after (K5, K2-K4 launched, K1 not) -- then the north-star phase-1
   slice for 256 pivots, ending with phase 9's z and basis;
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
   ``kernel=False`` at config 3's options on its first 16 lanes (a cut
   for time), every lane certified within 1e-9 of the kernel batch;
10c. the f64 tier chain: ``fallback_solve`` warm from the production
   flagship's final (drifted) basis (the host finish, certified within
   1e-9 of the golden, its finishing pivots printed), ``fallback_solve``
   with no basis on random_2048_2048 (the full f64 re-solve on the card,
   certified), and a production random_2048_2048 whose mixed-tier
   certificates are made to fail (``two_phase.refine_result`` wrapped),
   which reaches ``fallback_solve`` through ``certify`` after two restart
   rounds and ends certified with ``refine.fallback``; then
   ``equilibrate=True`` in production on the flagship and on a 2000 x 500
   instance with rows and columns scaled by 10^[-15, 15], each certified
   within 1e-9 (the latter of its base instance's f64 solve);
10a. two spawned ranks on the one card over gloo: random_2048_2048 in
   production, the walk and certified objective of phase 9a's one rank;
   the fleet of config 3's first 64 lanes, 32 a rank, bit for bit as
   ``solve_batch`` on one device, K7-K10's counters set to 0 on each rank
   just before the fleet's call and read just after (each launched);
10b. where the host shows N > 1 cards: N ranks over NCCL, one card a
   rank -- random_2048_2048 and the flagship in production, twice each,
   certified; config 3's 256 lanes as a fleet, checked as in 10a;
11. each kernel against its plain PyTorch version on the card: K1-K4 at
   the flagship shapes (M=8192, R=24576, L=128, t in {0, 37, 127}; K1
   and K2 one kernel a call, each on one workspace, their wrappers' host
   time; K2 under devex and Dantzig, its pivot row at h K1's p bit for
   bit) with K4's Tt K3's bit for bit and K3's mv K11's on K3's output
   bit for bit (there and at M=256, R=384, L=8), K3 and K4 timed in
   turns with cuBLAS ``addmm_``, the SM clock before and after, K5 (its
   column K1's bit for bit) and K11 (K3's mv with zero etas bit for
   bit), K6 at the 8192^2 and the north-star f32 shapes, then the
   batched kernels at config 3's shapes (B=256, M=512, R=3072, L=32) and
   the wide ones (B=32, R=15104), under devex and Dantzig, with a frozen
   lane and a lane that hits its fuse mid-window (``batch_window``: one
   kernel a call, one thread-block cluster a lane, its plan printed),
   and K12 at config 3's shapes (``batch_apply_reprice``'s fold with no
   live eta bit for bit), and ``batch_rank1`` at config 3's f64 phase-1
   tableau (256 x 512 x 3,000) bit for bit against its plain version
   (``addr_`` a lane), with a lane left out untouched, the scalar and the
   vector tile, and how many elements ``addcmul_`` and ``baddbmm_`` give
   otherwise;
   each timed on the device by two clocks -- torch.profiler, and CUDA
   events (over a CUDA graph of 50 calls for K1, K2 and K5, over
   back-to-back calls for the rest) -- beside its bound and, where one
   PyTorch call computes the same function, that call's time; then one
   config-3 batch traced (device time by kernel, the device's busy
   share). These run last so that no profiler run precedes the timed
   solves.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over HBM's 3.35 TB/s and its
operations over the peak rate of their type: 67 TFLOP/s for f32 outside
the tensor cores, 34 TFLOP/s for f64 (NVIDIA's H100 SXM data sheet).

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' records (K1-K12 and ``batch_rank1``; K11 and K12 are on no
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
#: The kernels of the single-card production path, and of the sharded one.
SINGLE_PATH = ("ah_ratio", "colk_costs", "apply_reprice", "apply_window")
SHARDED_PATH = ("ah", "colk_costs", "apply_reprice", "apply_window")
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
#: The kernels line's order.
ORDER = ("ah_ratio", "colk_costs", "apply_reprice", "apply_window", "ah",
         "fused_pivot", "batch_window", "batch_apply_reprice", "batch_apply",
         "reprice", "batch_reprice", "batch_rank1")
#: The default-option batch's lanes solved alone by solve() (config 3's
#: first, last and two between).
DEFAULT_BATCH_LANES = (0, 85, 170, 255)
#: Config 3's lanes in the kernel=False batch: a cut for time (each lane
#: runs the plain blocked loop alone).
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


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device ms per call of ``fn()``: the summed durations of the kernels
    it launches, traced by torch.profiler (CUPTI) over ``reps`` calls
    after one warm-up call; with ``match``, only the kernels whose name
    holds it (leaving out the copies that reset a state between calls).
    The host's launch rate is left out: at these shapes one call of a
    per-pivot pass runs for microseconds, less than the host takes to
    enqueue it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and (match is None or match in e.key))
    require(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / reps


def kernels_launched(fn, match: str | None = None) -> int:
    """The number of kernels one call of ``fn()`` launches on the card,
    counted by torch.profiler after one warm-up call; with ``match``, only
    those whose name holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and (match is None or match in e.key))


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
    import torch

    bad = got != want
    if bool(bad.any()):
        first = tuple(torch.nonzero(bad)[0].tolist())
        raise SmokeFailure(
            f"{name}: {int(bad.sum())} of {bad.numel()} differ; first at "
            f"{first}: kernel {got[first].tolist()} != plain "
            f"{want[first].tolist()}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the flagship shapes.

def phase_kernels(records: dict) -> None:
    """f32 outputs are held against the plain version at 1e-5 * (1 + |x|)
    (another summation order of up to L products). The f64 vectors are
    held, at 1e-12 relative, against the f64 formula applied to the
    kernel's own f32 operands: the kernel must round as that formula
    does, so one that carried a vector in f32 would miss by ~1e-7
    relative and fail."""
    import torch

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
    # once, and the operations.
    t = 37
    bounds = {
        "ah_ratio": bound(4 * M + 4 * t * M + 4 * t + 8 * M + 4 * M,
                          2 * t * M, M),
        "colk_costs": bound(4 * R + 4 * t * R + 4 * t + 4 * R + 16 * R
                            + 8 * R + 4 * M + 16 * M + 8 * M + 4 * M,
                            2 * t * R + 4 * R, 4 * R + 3 * M),
        "apply_reprice": bound(8 * M * R + 4 * L * (M + R) + 8 * (M + R),
                               2 * L * M * R, 2 * M * R),
        "apply_window": bound(8 * M * R + 4 * L * (M + R), 2 * L * M * R),
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed_batch(problems, stats)
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


def phase_reference_f64() -> dict:
    """The default options (f64 tableau, eps 1e-9, Dantzig, the sequential
    loop; no refinement) on the reference's benchmarks, held to the
    certified goldens at 1e-9; random_8192_8192 twice, with the same
    walk. The pivot counts are printed beside the JAX package's and the
    reference's records, not held to them: near-ties fall otherwise on
    each machine."""
    import torch

    from simplex_tpu_torch.solver import SEQ_CHUNK

    walks = {}
    for n, want, runs in ((1024, OBJ_1024, 1), (8192, OBJ_8192, 2)):
        p = benchmark_problem(n)
        tpu, ref = recorded_walks(n)
        walk = None
        for i in range(runs):
            torch.cuda.reset_peak_memory_stats()
            res, wall = timed_solve(p, {})
            label = f"f64 random_{n}_{n} solve {i + 1}"
            check_objective(label, res, want, 1e-9)
            w = (res.iterations_phase1, res.iterations_phase2)
            require(walk is None or w == walk,
                    f"{label} walked {w}, the first {walk}")
            walk = w
            reads = "+".join(str(v // SEQ_CHUNK + 1) for v in w)
            log(f"{label}: OPTIMAL objective {res.objective!r} (golden "
                f"{want!r}); pivots {w[0]}+{w[1]} (JAX package on a TPU "
                f"{tpu}, reference CUDA program {ref}); wall {wall:.3f} s;"
                f" {1e3 * wall / sum(w):.4f} ms/pivot; max_memory_allocated"
                f" {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the "
                f"loop's host reads per phase {reads} (one per {SEQ_CHUNK} "
                "pivots)")
        walks[n] = walk
    return walks


def northstar_tableau(opts):
    """The eliminated 10,000 x 100,000 phase-1 tableau, A and b uniform in
    [1, 100] from a seeded generator on the card, and its pre-elimination
    costs."""
    import torch

    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    n, m = 100_000, 10_000
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n * 100 + m)
    A = torch.rand((m, n), generator=g, device=dev) * 99.0 + 1.0
    b = torch.rand((m,), generator=g, device=dev) * 99.0 + 1.0
    tab = build_phase1(A, b, n, m, opts)
    del A
    costs0 = tab.costs
    return gaussian_eliminate(tab), costs0


def phase_pallas_seq(launches: dict) -> None:
    """K6's path: ``solve(random_2048_2048, dtype="float32",
    vector_dtype="float32", use_pallas=True)`` (a pure-f32 tableau;
    without ``vector_dtype`` the vectors stay f64, the mixed mode, as in
    the JAX package) with K6's counter reset just before and read just
    after; then the north-star phase-1 tableau (pure f32, the variable
    axis padded to 8) for 256 pivots through ``solve_loop_pallas``, on
    K6 and again on its plain version: the same k and the same folded
    candidates (h_d, h_b) at every pivot, so the same choices, the same
    basis, and tableaus equal within 2^-22 of their magnitude (the same
    two roundings per element on both sides; expected bit-equal)."""
    import dataclasses

    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import pivot as kp
    from simplex_tpu_torch.solver import solve_loop_pallas

    opts = dict(dtype="float32", vector_dtype="float32", use_pallas=True)
    kp.reset_launches()
    res, wall = timed_solve(benchmark_problem(2048), opts)
    launches.update(kp.LAUNCHES)
    check_objective("f32 K6 random_2048_2048", res, OBJ_2048, 1e-3)
    require(launches["fused_pivot"] > 0, "fused_pivot never launched")
    w = (res.iterations_phase1, res.iterations_phase2)
    log(f"f32 use_pallas random_2048_2048: OPTIMAL objective "
        f"{res.objective!r} (golden {OBJ_2048!r}, rel "
        f"{abs(res.objective - OBJ_2048) / OBJ_2048:.2e}); pivots "
        f"{w[0]}+{w[1]}; wall {wall:.3f} s; {1e3 * wall / sum(w):.4f} "
        f"ms/pivot; launches {launches}")

    torch.cuda.reset_peak_memory_stats()
    sopts = SolverOptions(**opts)
    tab0, _ = northstar_tableau(sopts)
    cap = 256
    kernel = kp.fused_pivot
    runs = {}
    try:
        for label, fn in (("kernel", kernel),
                          ("plain", kp.fused_pivot_plain)):
            tab = (dataclasses.replace(tab0, Tt=tab0.Tt.clone())
                   if label == "kernel" else tab0)
            trace = []

            def recorded(*a, fn=fn, trace=trace):
                out = fn(*a)
                trace.append(torch.stack([a[6].long(), out[0].long(),
                                          out[2].long()]))
                return out

            kp.fused_pivot = recorded
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _, iters = solve_loop_pallas(tab, sopts, cap)
            torch.cuda.synchronize()
            runs[label] = (out, iters, torch.stack(trace),
                           time.perf_counter() - t0)
    finally:
        kp.fused_pivot = kernel
    (tk, ik, trk, wk), (tp, ip, trp, wp) = runs["kernel"], runs["plain"]
    require(ik == ip == cap, f"north-star K6 loop: {ik} / {ip} pivots")
    equal("north-star K6 loop (k, h_d, h_b) per pivot", trk, trp)
    equal("north-star K6 loop base", tk.base, tp.base)
    err = 0.0
    for i in range(0, tk.Tt.shape[0], 1024):
        a, b = tk.Tt[i:i + 1024], tp.Tt[i:i + 1024]
        d = (a - b).abs()
        require(bool((d <= 2.0 ** -22 * (1.0 + b.abs())).all()),
                f"north-star K6 loop: Tt rows {i}.. beyond tolerance")
        err = max(err, float(d.max()))
    err = max(err, close("north-star K6 loop costs", tk.costs, tp.costs,
                         2.0 ** -22 * (1.0 + tp.costs.abs())))
    err = max(err, close("north-star K6 loop b", tk.b, tp.b,
                         2.0 ** -22 * (1.0 + tp.b.abs())))
    log(f"north-star 10000x100000 f32 K6 loop: tableau "
        f"{tuple(tk.Tt.shape)}; {cap} pivots on K6 in {wk:.3f} s = "
        f"{1e3 * wk / cap:.4f} ms/pivot, on the plain version {wp:.3f} s "
        f"= {1e3 * wp / cap:.4f} ms/pivot; the same choices at every "
        f"pivot, max abs err {err:.3e}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def phase_blocked_plain() -> None:
    """The plain blocked loop: random_2048_2048 with an f64 tableau and
    L=128, within 1e-9 of the golden; none of K1-K4 launched."""
    from simplex_tpu_torch.kernels import blocked as kb

    kb.reset_launches()
    res, wall = timed_solve(benchmark_problem(2048),
                            dict(dtype="float64", block_pivots=128))
    counts = dict(kb.LAUNCHES)
    check_objective("f64 blocked random_2048_2048", res, OBJ_2048, 1e-9)
    require(not any(counts.values()), f"K1-K4 launched: {counts}")
    w = (res.iterations_phase1, res.iterations_phase2)
    log(f"f64 L=128 random_2048_2048: OPTIMAL objective {res.objective!r}"
        f" (golden {OBJ_2048!r}); pivots {w[0]}+{w[1]}; wall {wall:.3f} "
        f"s; {1e3 * wall / sum(w):.4f} ms/pivot; K1-K4 launches {counts}")


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


def phase_r1024() -> None:
    res, wall = timed_solve(benchmark_problem(1024))
    check_certified("random_1024_1024", res, OBJ_1024)
    log(f"random_1024_1024: OPTIMAL certified objective {res.objective!r} "
        f"pivots {res.iterations_phase1}+{res.iterations_phase2} "
        f"refine {res.refine.method} wall {wall:.3f} s")


def phase_flagship(launches: dict) -> tuple:
    """The production flagship; returns its walk."""
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
    return walk


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
    """``kernel=False`` at config 3's options on its first
    ``FALLBACK_LANES`` lanes (a cut for time): the fallback's lane-by-lane
    route, each lane the plain blocked loop (no kernel launched); every
    lane certified, its objective within 1e-9 of the kernel batch's."""
    import torch

    from simplex_tpu_torch.kernels import batched as kbt
    from simplex_tpu_torch.kernels import blocked as kb

    label = (f"kernel=False batch (config 3's options, its first "
             f"{FALLBACK_LANES} of 256 lanes: a cut for time)")
    torch.cuda.empty_cache()
    kb.reset_launches()
    kbt.reset_launches()
    stats: dict = {}
    res, wall = timed_batch(problems[:FALLBACK_LANES], stats, kernel=False)
    counts = {**kb.LAUNCHES, **kbt.LAUNCHES}
    require(not any(counts.values()), f"{label}: kernels launched {counts}")
    worst = 0.0
    for i, r in enumerate(res):
        k = kernel_res[i]
        require(r.refine is not None and r.refine.certified,
                f"{label} lane {i}: {r.status!r} refine {r.refine}")
        rel = abs(r.objective - k.objective) / abs(k.objective)
        require(rel <= 1e-9, f"{label} lane {i}: objective "
                f"{r.objective!r} vs the kernel batch's {k.objective!r}")
        worst = max(worst, rel)
    methods = sorted(collections.Counter(r.refine.method for r in res)
                     .items())
    pivots = sorted(r.iterations_phase1 + r.iterations_phase2 for r in res)
    log(f"{label}: {len(res)}/{len(res)} certified (refinement {methods})"
        f", objectives within {worst:.2e} of the kernel batch's; pivots per"
        f" lane min {pivots[0]} max {pivots[-1]}; wall {wall:.3f} s (device"
        f" {stats['device_s']:.3f} s, host refinement "
        f"{stats['refine_s']:.3f} s); no kernel launched")


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = two_phase.fallback_solve(p, opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_certified("full f64 re-solve of random_2048_2048", res, OBJ_2048)
    require(res.refine.method == "tableau" and not any(kb.LAUNCHES.values()),
            f"full f64 re-solve: {res.refine.method!r} {kb.LAUNCHES}")
    log(f"tier chain, full f64 re-solve: fallback_solve(random_2048_2048, "
        f"no basis) -> OPTIMAL certified {res.objective!r} (golden "
        f"{OBJ_2048!r}); {res.iterations_phase1}+{res.iterations_phase2} "
        f"pivots (f64 tableau, L=128, the plain blocked loop); wall "
        f"{wall:.3f} s")

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
    default options (``RANK1_SHAPE``), every lane live, bit for bit; a
    lane whose do flag is clear keeps every bit; f32 and f64 at R = 63
    and 64 (the scalar and the vector tile) bit for bit; how many
    elements ``addcmul_`` and ``baddbmm_`` over all lanes give otherwise;
    device ms per call against the plain version, ``addcmul_`` (the
    library call: every lane live, the same function) and the bound."""
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
        # Rows of whole 16-byte vectors take the vector tile, the others
        # the scalar one.
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
    bound_ms, by = bound(16 * B * M * R + 8 * B * (M + R) + B,
                         f64_flops=2 * B * M * R)
    log(f"batch_rank1 B={B} M={M} R={R} f64, every lane live: bit for bit "
        f"the plain version (addr_ a lane; and f32 / f64 at R = 63, 64; a "
        f"lane left out untouched); elements differing from the kernel "
        f"over all lanes in one call: {found}; kernel {ms:.4f} ms (CUDA "
        f"events {check_ms:.4f}), plain {plain_ms:.4f} ms, addcmul_ "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}); the kernel "
        f"moves {16 * B * M * R / ms / 1e9:.3f} TB/s")
    records["batch_rank1"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
        "check_ms": check_ms}
    del T0, Tk
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


def phase_sharded_one_rank(launches: dict, walks: dict,
                           northstar: tuple) -> dict:
    """The sharded path at world size 1 over NCCL, in this process:
    random_1024_1024 with the default options (the sequential sharded
    loop; the walk of ``solve``), random_2048_2048 and the flagship with
    the production options (the kernel loop over K5, K2, K3/K4, and the
    restart tier on the slices), the flagship certified within 1e-9 and
    walking as ``solve`` did in this process, with the launch counters
    reset just before it and read just after (K5 launched, K1 not); then
    the north-star phase-1 slice for 256 pivots, its z and basis equal to
    the single-card loop's. Returns the 2048 result, for the two-rank
    phase."""
    import tempfile

    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel.sharded import (
        build_phase1_sharded, gaussian_eliminate_sharded,
        run_solve_loop_sharded, sharded_padded_dims)

    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as group:
        res, wall = timed_sharded(benchmark_problem(1024), group, {})
        w = (res.iterations_phase1, res.iterations_phase2)
        check_objective("sharded f64 random_1024_1024", res, OBJ_1024, 1e-9)
        require(w == walks[1024], f"sharded f64 random_1024_1024 walked "
                f"{w}, solve {walks[1024]}")
        log(f"sharded, 1 rank, f64 random_1024_1024: objective "
            f"{res.objective!r}, pivots {w[0]}+{w[1]} as solve; wall "
            f"{wall:.3f} s = {1e3 * wall / sum(w):.4f} ms/pivot")

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
        per = {}
        for name, fn in (("all_gather", lambda: pg.all_gather(vals, group)),
                         ("all_reduce", lambda: pg.all_reduce(col, group))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            torch.cuda.synchronize()
            per[name] = 1e6 * (time.perf_counter() - t0) / 500
        log(f"NCCL at 1 rank: {per['all_gather']:.1f} us per all_gather of "
            f"5 scalars, {per['all_reduce']:.1f} us per (8192,) all_reduce "
            "(host clock over 500 back-to-back calls)")

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

        opts = SolverOptions(**PROD)
        n, m = 100_000, 10_000
        R_pad, M_pad = sharded_padded_dims(n, m, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(n * 100 + m)
        A = torch.rand((m, n), generator=g, device=dev) * 99.0 + 1.0
        b = torch.rand((m,), generator=g, device=dev) * 99.0 + 1.0
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


def phase_sharded_two_ranks(r2048) -> None:
    """Two ranks on the one card over gloo (spawned processes; gloo moves
    the CUDA tensors through host memory, so these times say nothing of
    sharded speed): random_2048_2048 in production walking as at one rank
    to the same certified objective (1e-12); then the fleet of config 3's
    first 64 lanes, 32 a rank, every lane bit for bit as ``solve_batch``
    gives it on one device, K7-K10 launched on each rank."""
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel.group import spawn
    from simplex_tpu_torch.parallel.sharded import solve_sharded_rank

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (two,) = spawn(solve_sharded_rank, 2, "gloo", "cuda",
                   [(benchmark_problem(2048), st.SolverOptions(**PROD))])
    wall = time.perf_counter() - t0
    w1 = (r2048.iterations_phase1, r2048.iterations_phase2)
    w2 = (two.iterations_phase1, two.iterations_phase2)
    check_certified("two-rank random_2048_2048", two, OBJ_2048)
    require(w2 == w1, f"two ranks walked {w2}, one rank {w1}")
    rel = abs(two.objective - r2048.objective) / abs(r2048.objective)
    require(rel <= 1e-12, f"two ranks: objective {two.objective!r} vs one "
            f"rank's {r2048.objective!r}")
    log(f"sharded, 2 gloo ranks on one card, random_2048_2048: pivots "
        f"{w2[0]}+{w2[1]} as at one rank, certified objective "
        f"{two.objective!r} (rel {rel:.1e}); {wall:.3f} s with the two "
        f"processes' start")

    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100)
                for s in list(seeds)[:FLEET_LANES]]
    check_fleet("fleet, 2 gloo ranks on one card", 2, "gloo", problems)


def phase_sharded_cards(cards: int) -> None:
    """The sharded path and the fleet across ``cards`` cards of one host
    over NCCL, one card a rank (run when the host shows more than one
    card): random_2048_2048 and the flagship in production, each solved
    twice by the ranks (the second warm), certified within 1e-9 of the
    golden, their walks beside ``solve``'s on one card; then config 3's
    256 lanes split across the ranks (``check_fleet``)."""
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
                  for _ in range(2)])
    log(f"{cards} NCCL ranks: {len(runs)} sharded solves in "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
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
    # (and K2-K4 again) the sharded flagship, K6 the pure-f32 solve,
    # K7-K10 config 3's first call, batch_rank1 config 3 with the default
    # options; K11 and K12 are on no path.
    launches = {name: 0 for name in ORDER}
    sharded_launches: dict = {}
    t_start = time.perf_counter()
    try:
        phase_goldens({}, "default options, f64")
        phase_goldens(PROD, "production options")
        walks = phase_reference_f64()
        phase_pallas_seq(launches)
        phase_blocked_plain()
        phase_cli()
        phase_r1024()
        walks[8192] = phase_flagship(launches)
        northstar = phase_northstar()
        r2048 = phase_sharded_one_rank(sharded_launches, walks, northstar)
        launches["ah"] = sharded_launches["ah"]
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
        phase_kernels(records)
        phase_pivot_kernel(records)
        phase_batch_kernels(records)
        phase_batch_reprice(records)
        phase_rank1_kernel(records)
        phase_batch_trace()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    # Each kernel's time by a second clock: K1, K2, K5 CUDA events over a
    # CUDA graph of 50 calls; K3/K4 torch.profiler (their record is CUDA
    # events); the rest CUDA events over back-to-back calls.
    log("cross-check, ms a call (record / second clock): " + ", ".join(
        f"{name} {records[name]['ms']:.4f} / {records[name]['check_ms']:.4f}"
        for name in ORDER))

    tables = {**KERNELS, **PIVOT_KERNELS, **BATCH_KERNELS,
              **FALLBACK_KERNELS}
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
