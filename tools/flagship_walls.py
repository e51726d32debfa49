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


def sharded_solver(stack):
    """``solve`` through ``solve_sharded`` at one NCCL rank (opened on
    ``stack``), and a list that each solve's phase-1 loop call appends
    (seconds, pivots, capture seconds) to."""
    import tempfile

    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    group = stack.enter_context(pg.world(
        0, 1, "nccl", stack.enter_context(tempfile.TemporaryDirectory())))
    loop, capture = (ps.solve_loop_blocked_kernel_sharded,
                     ps.capture_window_sharded)
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

    ps.capture_window_sharded = timed_capture
    ps.solve_loop_blocked_kernel_sharded = timed_loop
    phase1 = []

    def solve(problem, **opts):
        del calls[:]
        res = st.solve_sharded(problem, group, device="cuda", **opts)
        phase1.append(calls[0])
        return res
    return solve, phase1


def measure(root: pathlib.Path, solves: int, sharded: bool) -> int:
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
    problem = st.read_random_problem(root / PROBLEM)
    stack = contextlib.ExitStack()
    solve, phase1 = ((lambda p, **o: st.solve(p, device="cuda", **o)), None)
    if sharded:
        solve, phase1 = sharded_solver(stack)
    walls = []
    for i in range(solves + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(problem, **PROD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pivots = res.iterations_phase1 + res.iterations_phase2
        loop = ""
        if phase1:
            sec, n, cap = phase1[-1]
            loop = (f"; phase-1 loop {1e3 * (sec - cap) / n:.4f} ms/pivot "
                    f"without its capture ({1e3 * cap:.1f} ms)")
        print(f"{root}: solve {i} ({'cold' if i == 0 else 'warm'}) wall "
              f"{wall:.3f} s, pivots {res.iterations_phase1}+"
              f"{res.iterations_phase2}, objective {res.objective!r}, "
              f"certified {res.refine.certified}{loop}", flush=True)
        if i:
            walls.append(wall)
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
                    help="solve_sharded at one NCCL rank")
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return measure(args.child.resolve(), args.solves, args.sharded)
    for root in args.root or [HERE.parents[1]]:
        rc = subprocess.run([sys.executable, str(HERE), "--child", str(root),
                             "--solves", str(args.solves)]
                            + (["--sharded"] if args.sharded else [])
                            ).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
