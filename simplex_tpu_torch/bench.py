"""Benchmark: the marginal cost of a pivot on the north-star dense LP.

Port of the JAX package's ``bench.py``, with its command line and its
stdout contract, run as::

    python -m simplex_tpu_torch.bench                  # on the card
    python -m simplex_tpu_torch.bench --device cpu --vars 1200 \\
        --constraints 250 --iters 16 --repeats 1       # plain versions

It builds the eliminated phase-1 tableau of the BASELINE.json headline
shape (m = 10,000 constraints x n = 100,000 variables, A and b uniform in
[1, 100) from a seeded generator on the device), runs the production
loop (``solver.run_solve_loop``: an f32 tableau, f64 vectors, deferred
block pivoting with L = 128 over K1-K4, devex, exact re-pricing) to two
iteration caps, and reports the marginal seconds a pivot, ``(t(K) -
t(K/2)) / (pivots(K) - pivots(K/2))``, which cancels the fixed costs of a
call. The device is the card unless ``--device cpu`` is given; without
a card that raises (there is no fallback).

Prints ONE JSON line on stdout, with the keys of ``bench.py``;
diagnostics (the first-run walls, ``bench.py``'s bytes-only floor for
the same shape, the peak device memory) go to stderr:

* ``value``: effective GB/s, ``2 R_pad M_pad itemsize`` (a read and a
  write of the whole tableau, what one sequential rank-1 update moves)
  over the marginal seconds a pivot; ``unit`` ``"GB/s/chip"``;
* ``vs_baseline``: ``value`` over ``REFERENCE_GBPS``;
* ``ceiling_gbs``: the device's read-modify-write rate, measured in this
  run (``measure_rmw_ceiling``);
* ``floor_ms_per_pivot``: the least time the card could take for one
  pivot's work (``pivot_work`` and ``floor_seconds``), and
  ``efficiency_pct`` = floor / marginal;
* ``pivot_rule`` (the options' resolved rule) and
  ``dantzig_ms_per_pivot`` (the marginal under Dantzig when the rule is
  not Dantzig, else null);
* the set-up stages. PyTorch has no trace step, and the kernel loop's
  counterpart of the JAX loop's compile -- one CUDA graph of a window,
  captured by each loop call on the card -- runs inside each timed run,
  so ``build_trace_s``, ``loop_trace_s`` and ``loop_compile_s`` are
  0.0. ``build_compile_s`` is the wall of ``kernels._build.build()``
  and ``load_library()`` at first use (on the card, when the options
  take a kernel; near 0 when ``_build/`` is warm, 0.0 elsewhere).
  ``build_exec_s`` is the wall of generating A and b, building the
  tableau and eliminating the objective row, ending in
  ``torch.cuda.synchronize()``.

The loops update the tableau in place, where the JAX package's loop
reused its immutable input. So every run starts from a working copy
refilled from the pristine tableau outside the timed window, and each
repeat at a cap must walk bit for bit as the first run did (the same
iterations and z): a walk that changes between repeats is an error,
not noise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .config import SolverOptions, kernel_blocked_enabled
from .solver import run_solve_loop, use_pallas
from .tableau import Tableau, build_phase1, gaussian_eliminate
from .two_phase import resolve_device

#: The reference CUDA solver's best pivot-update throughput: ~166 GB/s
#: on an RTX 2070 Super at 8192 x 8192 f64 (BASELINE.md:23, the 19.4 ms
#: mean solve cycle over a 1.61 GB tableau). A GPU figure of the program
#: this repository was modelled on, not a TPU one.
REFERENCE_GBPS = 166.0

#: Peak rates of one H100 SXM outside the tensor cores (NVIDIA's data
#: sheet), FLOP/s: the floor's operation terms.
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the name alone
    where nvidia-smi cannot be run), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)
    return out.stdout.strip().splitlines()[0]


def bench_problem(n: int, m: int, device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A (m, n) and b (m,), f32 uniform in [1, 100), drawn on ``device``
    from ``torch.Generator(device).manual_seed(n * 100 + m)``: the seed
    of ``bench.py:46``, not its stream (threefry there, the device's
    Philox here)."""
    g = torch.Generator(device=device).manual_seed(n * 100 + m)
    A = torch.rand((m, n), generator=g, device=device) * 99.0 + 1.0
    b = torch.rand((m,), generator=g, device=device) * 99.0 + 1.0
    return A, b


def bench_tableau(A: torch.Tensor, b: torch.Tensor, n: int, m: int,
                  options: SolverOptions) -> tuple[Tableau, torch.Tensor]:
    """The eliminated phase-1 tableau of ``A``, ``b`` and its
    pre-elimination costs (``costs0``, which enables the blocked loops'
    exact re-pricing)."""
    tab = build_phase1(A, b, n, m, options)
    costs0 = tab.costs
    return gaussian_eliminate(tab), costs0


def uses_kernels(options: SolverOptions) -> bool:
    """Whether ``run_solve_loop`` takes a kernel under ``options``: the
    blocked-kernel loop (K1-K4) or the sequential loop over K6."""
    blocked = int(options.block_pivots or 1) > 1
    return kernel_blocked_enabled(options) if blocked else use_pallas(options)


def build_bench_state(n: int, m: int, dtype, options: SolverOptions,
                      stages: dict, device) -> tuple[Tableau, torch.Tensor]:
    """The bench tableau and its ``costs0`` on ``device`` (``bench.py:
    34-70``); ``stages`` gains ``build_trace_s`` (0.0), ``build_compile_s``
    and ``build_exec_s`` (see the module's docstring)."""
    dev = torch.device(device)
    stages["build_trace_s"] = stages["build_compile_s"] = 0.0
    if dev.type == "cuda" and uses_kernels(options):
        from .kernels import _build

        t0 = time.perf_counter()
        _build.build()
        _build.load_library()
        stages["build_compile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A, b = bench_problem(n, m, dev)
    tab, costs0 = bench_tableau(A.to(dtype), b.to(dtype), n, m, options)
    del A
    synchronize(dev)
    stages["build_exec_s"] = time.perf_counter() - t0
    return tab, costs0


def working_copy(tab: Tableau) -> Tableau:
    return dataclasses.replace(
        tab, Tt=tab.Tt.clone(), b=tab.b.clone(), costs=tab.costs.clone(),
        z=tab.z.clone(), base=tab.base.clone())


def restore(work: Tableau, tab0: Tableau) -> None:
    """Refill the working copy from the pristine tableau, in place."""
    for f in ("Tt", "b", "costs", "z", "base"):
        getattr(work, f).copy_(getattr(tab0, f))


def measure_rmw_ceiling(x: torch.Tensor, iters: int = 8,
                        repeats: int = 3) -> float:
    """The device's read-modify-write rate in GB/s, measured in this run
    (``bench.py:73-106``): ``iters`` in-place ``add_(1e-9)`` passes over
    ``x``, the best of ``repeats``, timed with CUDA events on the card
    (the host clock on the CPU), after one warm pass.

    ``x`` is changed: pass the working copy, never the pristine tableau
    (1e-9 is lost on the values in [1, 100], not on the zeros of the
    identity columns)."""
    nbytes = x.numel() * x.element_size()
    x.add_(1e-9)
    best = float("inf")
    for _ in range(repeats):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                x.add_(1e-9)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                x.add_(1e-9)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return iters * 2 * nbytes / best / 1e9


@dataclasses.dataclass(frozen=True)
class Run:
    """One capped run: wall seconds, and the walk it took."""

    seconds: float
    status: int
    iterations: int
    z: str             # float.hex of z: compared bit for bit
    base: torch.Tensor


def run_capped(work: Tableau, tab0: Tableau, costs0: torch.Tensor,
               options: SolverOptions, cap: int) -> Run:
    """Refill ``work`` from ``tab0`` (untimed), then time
    ``run_solve_loop`` to ``cap`` pivots on the host clock, ending in
    ``torch.cuda.synchronize()``."""
    dev = work.Tt.device
    restore(work, tab0)
    synchronize(dev)
    t0 = time.perf_counter()
    out, status, iters = run_solve_loop(work, options, cap, costs0)
    synchronize(dev)
    secs = time.perf_counter() - t0
    return Run(secs, status, iters, float(out.z).hex(), out.base.cpu())


def marginal_seconds(results: dict) -> float:
    """Seconds a pivot from ``{cap: (best seconds, pivots)}`` at two caps:
    the two-point difference, or the amortised average at the higher cap
    when both ended at the same pivot count or the times do not rise
    (``bench.py:231-242``)."""
    (t_lo, p_lo), (t_hi, p_hi) = (results[c] for c in sorted(results))
    if p_hi == p_lo or t_hi <= t_lo:
        log("WARNING: marginal estimate unavailable "
            f"(pivots {p_lo}->{p_hi}, time {t_lo:.6f}->{t_hi:.6f}s); "
            "reporting the amortised average instead")
        return t_hi / max(p_hi, 1)
    return (t_hi - t_lo) / (p_hi - p_lo)


def measure_marginal(work: Tableau, tab0: Tableau, costs0: torch.Tensor,
                     options: SolverOptions, K: int, repeats: int,
                     label: str) -> float:
    """Marginal seconds a pivot between the caps K/2 and K
    (``bench.py:181-253``): at each cap a first run, then the best of
    ``repeats``, each from the restored tableau and each required to
    walk as the first run did."""
    results = {}
    for cap in (max(K // 2, 1), K):
        first = run_capped(work, tab0, costs0, options, cap)
        log(f"first run (cap={cap}, {label}): {first.seconds:.3f}s, "
            f"status={first.status}, iters={first.iterations}")
        if first.iterations < cap:
            log(f"WARNING: loop ended after {first.iterations} < {cap} "
                "pivots")
        times = []
        for rep in range(repeats):
            got = run_capped(work, tab0, costs0, options, cap)
            if (got.iterations, got.z) != (first.iterations, first.z):
                raise RuntimeError(
                    f"repeat {rep} at cap {cap} ({label}) walked otherwise: "
                    f"{got.iterations} pivots, z {got.z}, against "
                    f"{first.iterations}, z {first.z}")
            times.append(got.seconds)
            log(f"repeat {rep}: {got.seconds:.3f}s ("
                f"{got.seconds / max(got.iterations, 1) * 1e3:.4f} ms/pivot "
                "avg)")
        results[cap] = (min(times) if times else first.seconds,
                        first.iterations)
    return marginal_seconds(results)


# ---------------------------------------------------------------------------
# The floor.

def pivot_work(M: int, R: int, L: int, t: float, devex: bool,
               itemsize: int) -> dict[str, tuple[float, float, float]]:
    """What one pivot of the blocked algorithm must move and compute, per
    kernel of ``kernels/csrc/blocked.cu``, as ``{name: (bytes, f32
    operations, f64 operations)}``: each input read once, each output
    written once, the operations on these inputs. ``M`` x ``R`` is the
    padded tableau ``Tt`` of ``itemsize`` bytes (its factors C (L, R) and F
    (L, M) and the column ``a_h`` the same; their operations count as f32
    or f64 by ``itemsize``); b, the costs and the re-pricing vectors are
    f64, ``base`` int32, the devex weights of the tableau's type; ``t`` is
    the window's live eta rows.

    * ``ah_ratio`` (K1, ``ah_ratio_fused``): reads the column ``Tt[:, h]``
      (M), the t live rows of F (tM), ``C[:t, h]`` (t) and b (f64), and
      writes ``a_h`` (M); 2tM operations for the eta correction and M f64
      quotients for the ratio test.
    * ``colk_costs`` (K2, ``colk_costs_fused``): reads the row ``Tt[k]``
      (R), the t live rows of C (tR), ``F[:t, k]`` (t) and ``a_h`` (M);
      writes ``C[t]`` (R) and ``F[t]`` (M); reads and writes the costs and
      b (f64), base (int32) and, under devex, the weights (R); 2tR
      operations for the row's correction (4R more for the devex update),
      4R f64 for the cost update and 3M for b's.
    * ``apply_reprice`` (K3, ``window_apply<true>``): reads and writes Tt
      (2MR), reads F and C (L(M + R)) and the re-pricing coefficients (M,
      f64), writes ``mv`` (R, f64); 2LMR operations for ``Tt -= F^T C`` and
      2MR f64 for ``mv = coeffs @ Tt``. Once a window.
    * ``apply_window`` (K4, ``window_apply<false>``): the apply alone.
      Once a window.

    With L <= 1 (the sequential loops) the one entry ``pivot_update`` is a
    read and a write of the whole tableau and its rank-1 update's 2MR
    operations (``bench.py:274-275``).

    ``bench.py``'s floor (``bench.py:262-276``) counted bytes alone, and
    a 128-lane column slab of ``Tt`` for the entering column: a slab is the
    TPU's (8, 128) tile, which its DMA had to move whole. That is the
    TPU's granularity, not the algorithm's work, and the column here is M
    elements, one a constraint. Counting bytes alone leaves out what
    bounds the window apply on the card: at M = 10,112, R = 120,064, L =
    128 its 2LMR = 311 GFLOP take 4.6 ms at 67 TFLOP/s, where its 8MR
    bytes take 2.9 ms at 3.35 TB/s."""
    e = itemsize
    tab32, tab64 = (1.0, 0.0) if e == 4 else (0.0, 1.0)

    def work(nbytes, tab_ops, f64_ops=0.0):
        return (float(nbytes), tab32 * tab_ops, tab64 * tab_ops + f64_ops)

    if L <= 1:
        return {"pivot_update": work(2 * R * M * e, 2 * M * R)}
    w = 2 * e * R if devex else 0
    return {
        "ah_ratio": work(e * M + e * t * M + e * t + 8 * M + e * M,
                         2 * t * M, M),
        "colk_costs": work(e * R + e * t * R + e * t + e * R + 16 * R + w
                           + e * M + 16 * M + 8 * M + e * M,
                           2 * t * R + (4 * R if devex else 0),
                           4 * R + 3 * M),
        "apply_reprice": work(2 * e * M * R + e * L * (M + R) + 8 * (M + R),
                              2 * L * M * R, 2 * M * R),
        "apply_window": work(2 * e * M * R + e * L * (M + R),
                             2 * L * M * R),
    }


def kernel_seconds(work: tuple[float, float, float],
                   bytes_per_s: float) -> float:
    """The least time for ``(bytes, f32 ops, f64 ops)``: the larger of the
    bytes over ``bytes_per_s`` and the operations over the peak rates."""
    nbytes, f32, f64 = work
    return max(nbytes / bytes_per_s, f32 / F32_FLOPS + f64 / F64_FLOPS)


def floor_seconds(M: int, R: int, options: SolverOptions,
                  bytes_per_s: float) -> float:
    """The least time one pivot's work can take: K1 and K2 at the
    window's mean live depth t = L/2, plus one window's apply over L --
    K3's share the re-priced windows (one in ``reprice_every``; none for
    an f64 tableau, which the loops never re-price), K4's the rest --
    each kernel bounded by its bytes at ``bytes_per_s`` or its
    operations, whichever takes longer. L <= 1: one read and one write of
    the tableau."""
    L = int(options.block_pivots or 1)
    devex = options.pivot_rule_resolved == "devex"
    itemsize = np.dtype(options.dtype).itemsize
    work = pivot_work(M, R, L, L / 2, devex, itemsize)
    secs = {name: kernel_seconds(w, bytes_per_s) for name, w in work.items()}
    if L <= 1:
        return secs["pivot_update"]
    repriced = 0.0 if itemsize == 8 else 1.0 / int(options.reprice_every)
    window = (repriced * secs["apply_reprice"]
              + (1.0 - repriced) * secs["apply_window"])
    return secs["ah_ratio"] + secs["colk_costs"] + window / L


def bytes_only_floor_seconds(M: int, R: int, L: int, itemsize: int,
                             bytes_per_s: float) -> float:
    """``bench.py``'s floor (``bench.py:262-276``) for the same shape: the
    1/L window sweep, the R-side pass and the M-side pass with its
    128-lane slab, bytes alone."""
    if L >= 2:
        nbytes = itemsize * (2 * R * M / L + (L / 2 + 20) * R
                             + (128 + L / 2 + 4) * M)
    else:
        nbytes = 2 * R * M * itemsize
    return nbytes / bytes_per_s


# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.bench",
        description="marginal ms/pivot of the solve loop on the north-star "
                    "dense LP (one JSON line on stdout)")
    p.add_argument("--vars", type=int, default=100_000)
    p.add_argument("--constraints", type=int, default=10_000)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--vector-dtype", default="float64",
                   choices=["float32", "float64"],
                   help="dtype of b/costs/z (mixed precision: f32 tableau "
                        "+ f64 vectors is the production mode)")
    p.add_argument("--iters", type=int, default=512,
                   help="timed pivot iterations")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--no-pallas", action="store_true",
                   help="kernels off (use_pallas=False): the plain loops")
    p.add_argument("--block", type=int, default=128,
                   help="deferred block-pivot window L (0/1 = off)")
    p.add_argument("--reprice-every", type=int, default=None,
                   help="exact re-pricing cadence in windows (default: "
                        "SolverOptions default)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    log(f"device: {dev} ({name}), torch {torch.__version__}")

    n, m, K = args.vars, args.constraints, args.iters
    dtype = getattr(torch, args.dtype)
    extra = ({"reprice_every": args.reprice_every}
             if args.reprice_every is not None else {})
    options = SolverOptions(dtype=np.dtype(args.dtype),
                            vector_dtype=np.dtype(args.vector_dtype),
                            use_pallas=not args.no_pallas,
                            block_pivots=args.block or None, **extra)

    log(f"building phase-1 tableau n={n} m={m} dtype={args.dtype} ...")
    stages: dict = {}
    tab0, costs0 = build_bench_state(n, m, dtype, options, stages, dev)
    M_pad, R_pad = tab0.Tt.shape
    itemsize = tab0.Tt.element_size()
    log(f"tableau {R_pad} x {M_pad} = {R_pad * M_pad * itemsize / 1e9:.2f} "
        f"GB (kernel build {stages['build_compile_s']:.3f}s, build "
        f"{stages['build_exec_s']:.3f}s)")
    work = working_copy(tab0)

    log("measuring the read-modify-write ceiling (bare in-place passes) ...")
    ceiling_gbs = measure_rmw_ceiling(work.Tt)
    log(f"ceiling: {ceiling_gbs:.1f} GB/s sustained RMW")

    stages["loop_trace_s"] = 0.0
    stages["loop_compile_s"] = 0.0
    rule = options.pivot_rule_resolved
    per_iter_s = measure_marginal(work, tab0, costs0, options, K,
                                  args.repeats, rule)
    dantzig_ms = None
    if rule != "dantzig":
        alt = dataclasses.replace(options, pivot_rule="dantzig")
        dantzig_ms = 1e3 * measure_marginal(work, tab0, costs0, alt, K,
                                            args.repeats, "dantzig")

    gbps = 2 * R_pad * M_pad * itemsize / per_iter_s / 1e9
    floor_ms = 1e3 * floor_seconds(M_pad, R_pad, options, ceiling_gbs * 1e9)
    efficiency = floor_ms / (per_iter_s * 1e3)
    old_floor_ms = 1e3 * bytes_only_floor_seconds(
        M_pad, R_pad, int(options.block_pivots or 1), itemsize,
        ceiling_gbs * 1e9)
    log(f"marginal: {per_iter_s * 1e3:.4f} ms/pivot, "
        f"{1 / per_iter_s:.1f} pivots/s, {gbps:.1f} GB/s effective; floor "
        f"{floor_ms:.6f} ms (bench.py's bytes-only floor {old_floor_ms:.6f} "
        f"ms) at the {ceiling_gbs:.1f} GB/s ceiling -> "
        f"{efficiency * 100:.2f}% of floor")
    if dev.type == "cuda":
        log(f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")

    print(json.dumps({
        "metric": (f"effective pivot-update throughput, dense LP m={m} "
                   f"n={n} {args.dtype}, block={args.block} on {name} "
                   f"(marginal solve-cycle {per_iter_s * 1e3:.4f} ms, "
                   f"{1 / per_iter_s:.1f} pivots/s)"),
        "value": gbps,
        "unit": "GB/s/chip",
        "vs_baseline": gbps / REFERENCE_GBPS,
        "ceiling_gbs": ceiling_gbs,
        "floor_ms_per_pivot": floor_ms,
        "efficiency_pct": efficiency * 100,
        "dantzig_ms_per_pivot": dantzig_ms,
        "pivot_rule": rule,
        **stages,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
