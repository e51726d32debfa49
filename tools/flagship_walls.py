#!/usr/bin/env python3
"""Wall time of the production flagship solve on the card, for comparing
two versions of the PyTorch port in turns inside one run.

The flagship is random_8192_8192 (``data/examples/benchmark_problems``)
with the production options (f32 tableau, f64 vectors,
``block_pivots=128``). Each ``--root`` is a checkout of the repository
(this one by default, or another commit unpacked with ``git archive``).
The script runs one process per root, in the order given; each process
builds that checkout's kernels, solves the flagship once cold and
``--solves`` times warm, and prints every wall with the walk and the
certified objective::

    python3 tools/flagship_walls.py --solves 3 \\
        --root _checkout/parent --root . --root . --root _checkout/parent

With ``--sharded`` each process solves through ``solve_sharded`` at one
NCCL rank instead (the sharded kernel loop, one CUDA graph a window),
and prints beside each wall the phase-1 loop call's ms/pivot with its
graph's capture taken out: the replayed windows and their boundaries.
With ``--seq N`` each process solves random_N_N with the default
options (f64, the sequential loop, one CUDA graph a chunk) and prints
beside each wall the loop calls' ms/pivot with their captures taken
out: the replayed chunks and the host read between them; with
``--trace`` as well one more solve whose phase-1 loop call torch.profiler
traces, and the kernels of its middle replayed chunk, by name, in
microseconds a pivot. ``--k6`` with ``--seq N`` takes K6's loop instead
(``solve_loop_pallas``: ``dtype`` and ``vector_dtype`` float32,
``use_pallas=True``)::

    python3 tools/flagship_walls.py --seq 2048 --k6 --trace \
        --root _checkout/parent --root . --root . --root _checkout/parent

``--blocked`` with ``--seq N`` takes the plain blocked loop instead
(``solve_loop_blocked``: ``dtype`` float64, ``block_pivots`` 128, one
CUDA graph a window; ``--trace`` traces a replayed window, of 128
pivots), and after the solves times the full f64 re-solve of random_N_N
(``two_phase.fallback_solve`` with no basis, the certification tier that
runs this loop)::

    python3 tools/flagship_walls.py --seq 2048 --blocked --trace \
        --root _checkout/parent --root . --root . --root _checkout/parent

``--sharded --blocked`` with ``--seq N`` solves random_N_N with those
options through ``solve_sharded`` at one NCCL rank (the plain blocked
sharded loop, one CUDA graph a window with its collectives inside), each
wall beside the phase-1 loop call's ms/pivot with its capture taken out
and with it::

    python3 tools/flagship_walls.py --seq 2048 --sharded --blocked \
        --root _checkout/parent --root . --root . --root _checkout/parent

``--sharded --sequential`` with ``--seq N`` solves random_N_N with the
default options (f64) through ``solve_sharded`` at one NCCL rank (the
sequential sharded loop, one CUDA graph a chunk with its collectives
inside), each wall beside the phase-1 loop call's ms/pivot with its
captures taken out and with them::

    python3 tools/flagship_walls.py --seq 1024 --sharded --sequential \
        --root _checkout/parent --root . --root . --root _checkout/parent

Needs a CUDA card: a process that finds none exits non-zero.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
PROBLEM = pathlib.Path("data/examples/benchmark_problems/random_8192_8192.txt")
PROD = dict(dtype="float32", vector_dtype="float64", block_pivots=128)
K6 = dict(dtype="float32", vector_dtype="float32", use_pallas=True)
BLOCKED = dict(dtype="float64", block_pivots=128)


def sharded_solver(stack, blocked: bool = False, sequential: bool = False):
    """``solve`` through ``solve_sharded`` at one NCCL rank (opened on
    ``stack``), and a list that each solve's phase-1 loop call appends
    (seconds, pivots, capture seconds) to: the sharded kernel loop's, with
    ``blocked`` the plain blocked sharded loop's, with ``sequential`` the
    sequential sharded loop's."""
    import tempfile

    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    group = stack.enter_context(pg.world(
        0, 1, "nccl", stack.enter_context(tempfile.TemporaryDirectory())))
    names = (("solve_loop_blocked_sharded", "capture_blocked_window_sharded")
             if blocked else
             ("solve_loop_sharded", "capture_chunk_sharded") if sequential
             else ("solve_loop_blocked_kernel_sharded",
                   "capture_window_sharded"))
    loop, capture = (getattr(ps, n) for n in names)
    calls, captures = [], []

    def timed_capture(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = capture(*args, **kw)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)
        return out

    def timed_loop(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(captures)
        out = loop(*args, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out[2],
                      sum(captures[n:])))
        return out

    setattr(ps, names[1], timed_capture)
    setattr(ps, names[0], timed_loop)
    phase1 = []

    def solve(problem, **opts):
        del calls[:]
        res = st.solve_sharded(problem, group, device="cuda", **opts)
        phase1.append(calls[0])
        return res
    return solve, phase1


def loop_names(k6: bool, blocked: bool) -> tuple[str, str, dict]:
    """The loop ``--seq`` times, its capture and the options that run it."""
    if blocked:
        return "solve_loop_blocked", "capture_blocked_window", BLOCKED
    if k6:
        return "solve_loop_pallas", "capture_chunk", K6
    return "solve_loop", "capture_chunk", {}


def seq_solver(k6: bool, blocked: bool):
    """``solve`` with the default options (with ``k6``: K6's loop's; with
    ``blocked``: the plain blocked loop's), and a list that each solve
    appends its loop calls' (seconds, pivots, capture seconds) to."""
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch import solver

    name, cname, opts = loop_names(k6, blocked)
    loop, capture = getattr(solver, name), getattr(solver, cname)
    calls, captures = [], []

    def timed_capture(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = capture(*args, **kw)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)
        return out

    def timed_loop(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(captures)
        out = loop(*args, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out[2],
                      sum(captures[n:])))
        return out

    setattr(solver, cname, timed_capture)
    setattr(solver, name, timed_loop)
    loops = []

    def solve(problem, **_):
        del calls[:]
        res = st.solve(problem, device="cuda", **opts)
        loops.append(tuple(map(sum, zip(*calls))))
        return res
    return solve, loops


def trace_chunk(solve, problem, k6: bool, blocked: bool) -> None:
    """One more solve with its first loop call traced by torch.profiler:
    the kernels of the middle replayed chunk (or window: from one
    ``seq_step_pre`` to the kernel before the next) by name, in us a pivot
    (a kernel's time from its start: a programmatic dependent launch's
    includes its wait for the kernel before), the nodes a pivot and the
    span a pivot. Names are read from the trace, so any version's kernels
    show."""
    import collections
    import json
    import re
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from simplex_tpu_torch import solver

    name = loop_names(k6, blocked)[0]
    real, traced = getattr(solver, name), []

    def loop(*args, **kw):
        if traced:
            return real(*args, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(*args, **kw)
            torch.cuda.synchronize()
        traced.append(prof)
        return out

    setattr(solver, name, loop)
    try:
        solve(problem)
    finally:
        setattr(solver, name, real)
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "trace.json"
        traced[0].export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    chunks: list = []
    for e in kernels:
        if "seq_step_pre" in e["name"]:
            chunks.append([])
        if chunks:
            chunks[-1].append(e)
    mid = chunks[len(chunks) // 2]
    chunk = BLOCKED["block_pivots"] if blocked else solver.SEQ_CHUNK
    us = collections.defaultdict(float)
    for e in mid:
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e["name"])
        us[re.match(r"[\w:]*", name).group(0).split("::")[-1]] += (
            e["dur"] / chunk)
    print(f"traced chunk {len(chunks) // 2} of {len(chunks)}: "
          f"{len(mid) / chunk:.5f} nodes a pivot, kernels "
          f"{sum(us.values()):.2f} us a pivot ("
          + ", ".join(f"{n} {v:.3f}" for n, v in us.items()) + "), span "
          f"{(mid[-1]['ts'] + mid[-1]['dur'] - mid[0]['ts']) / chunk:.2f} "
          "us a pivot", flush=True)


def measure(root: pathlib.Path, solves: int, sharded: bool,
            seq: int, trace: bool, k6: bool, blocked: bool,
            sequential: bool = False) -> int:
    """Solve the flagship from ``root``'s package once cold and ``solves``
    times warm on the card, printing each wall."""
    sys.path.insert(0, str(root))
    import contextlib

    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("flagship_walls: torch.cuda is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    print(f"{root}: kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    problem = st.read_random_problem(
        root / (PROBLEM.with_name(f"random_{seq}_{seq}.txt") if seq
                else PROBLEM))
    stack = contextlib.ExitStack()
    solve, phase1 = ((lambda p, **o: st.solve(p, device="cuda", **o)), None)
    opts = (BLOCKED if sharded and blocked else {} if sequential
            else PROD)
    if sharded:
        solve, phase1 = sharded_solver(stack, blocked, sequential)
    elif seq:
        solve, phase1 = seq_solver(k6, blocked)
    walls = []
    for i in range(solves + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(problem, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pivots = res.iterations_phase1 + res.iterations_phase2
        loop = ""
        if phase1:
            sec, n, cap = phase1[-1]
            per_loop = seq and not sharded
            loop = (f"; {'loops' if per_loop else 'phase-1 loop'} "
                    f"{1e3 * (sec - cap) / n:.4f} ms/pivot without "
                    f"{'their captures' if per_loop else 'its capture'} "
                    f"({1e3 * cap:.1f} ms; {1e3 * sec / n:.4f} with it)")
        print(f"{root}: solve {i} ({'cold' if i == 0 else 'warm'}) wall "
              f"{wall:.3f} s, pivots {res.iterations_phase1}+"
              f"{res.iterations_phase2}, objective {res.objective!r}, "
              f"certified {getattr(res.refine, 'certified', None)}{loop}",
              flush=True)
        if i:
            walls.append(wall)
    if seq and trace and not sharded:
        trace_chunk(solve, problem, k6, blocked)
    if seq and blocked and not sharded:
        from simplex_tpu_torch import two_phase

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = two_phase.fallback_solve(problem, st.SolverOptions(**PROD),
                                       device="cuda")
        torch.cuda.synchronize()
        print(f"{root}: full f64 re-solve (fallback_solve, no basis) wall "
              f"{time.perf_counter() - t0:.3f} s, pivots "
              f"{res.iterations_phase1}+{res.iterations_phase2}, objective "
              f"{res.objective!r}, certified "
              f"{getattr(res.refine, 'certified', None)}", flush=True)
    if walls:
        med = statistics.median(walls)
        print(f"{root}: warm wall min {min(walls):.3f} median {med:.3f} max "
              f"{max(walls):.3f} s; median {1e3 * med / pivots:.4f} "
              "ms/pivot", flush=True)
    stack.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=pathlib.Path,
                    help="a checkout to time (repeatable; default: this "
                         "one)")
    ap.add_argument("--solves", type=int, default=3,
                    help="warm solves after the cold one (default 3)")
    ap.add_argument("--sharded", action="store_true",
                    help="solve_sharded at one NCCL rank (with --blocked "
                         "and --seq N: the plain blocked sharded loop)")
    ap.add_argument("--seq", type=int, default=0, metavar="N",
                    help="random_N_N with the default options (the "
                         "sequential loop)")
    ap.add_argument("--trace", action="store_true",
                    help="with --seq: trace a replayed chunk's kernels")
    ap.add_argument("--k6", action="store_true",
                    help="with --seq: K6's loop (pure f32, use_pallas)")
    ap.add_argument("--blocked", action="store_true",
                    help="with --seq: the plain blocked loop (f64, L=128) "
                         "and the full f64 re-solve")
    ap.add_argument("--sequential", action="store_true",
                    help="with --sharded and --seq N: the sequential "
                         "sharded loop (the default options)")
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return measure(args.child.resolve(), args.solves, args.sharded,
                       args.seq, args.trace, args.k6, args.blocked,
                       args.sequential)
    for root in args.root or [HERE.parents[1]]:
        rc = subprocess.run([sys.executable, str(HERE), "--child", str(root),
                             "--solves", str(args.solves),
                             "--seq", str(args.seq)]
                            + (["--sharded"] if args.sharded else [])
                            + (["--trace"] if args.trace else [])
                            + (["--k6"] if args.k6 else [])
                            + (["--blocked"] if args.blocked else [])
                            + (["--sequential"] if args.sequential else [])
                            ).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
