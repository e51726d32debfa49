"""Command-line interface with the reference's flag contract, on PyTorch.

Port of ``simplex_tpu.cli``, run as ``python -m simplex_tpu_torch.cli``:

* ``-f <file>`` -- solve a dense-format problem file;
* ``-r <vars> <constraints> [seed]`` -- random problem, uniform
  [-100, 100], seed defaulting to the current time;
* ``-rs <vars> <constraints> [seed]`` -- like -r, and save a seed file
  ``<data-dir>/examples/random_<timestamp>.txt``;
* ``-rf <file>`` -- regenerate and solve from a seed file;
* ``-t`` -- benchmark sweep: vars, constraints in {256, 512, ...,
  --limit}, seed = vars*100 + constraints (+1 at 1024x8192), range
  [1, 100], one timing CSV per size with ``--timer``.

On success the solution vector and optimal value go to
``<data-dir>/solution.txt`` in the reference's format, and the status
lines match the reference's stdout. The options beyond the reference are
the JAX package's: ``--dtype``, ``--vector-dtype``, ``--timer`` /
``--per-iteration``, ``--reference-degeneracy``, ``--max-iter``,
``--eps``, ``--block``, ``--pivot-rule``, ``--limit``,
``--resume-sweep``, ``--debug`` / ``--pause``, ``--profile DIR`` (a
``torch.profiler`` chrome trace), ``--batch``, and ``--sharded NDEV`` /
``--fleet NDEV``, which start NDEV ranks (``parallel.group.spawn``):
NCCL with ``--device cuda``, one card per rank, gloo with ``--device
cpu``. ``--device`` takes the place of ``--platform`` (default
``cuda``). ``--equilibrate`` sets the option as the JAX CLI does (only
``solve`` reads it there, so the CLI's solves do not). ``--checkpoint``
(alone or with ``--sharded``) is not ported yet: it exits non-zero
naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from .chrono import Chrono, NullChrono
from .config import SolverOptions, Status
from .generator import (benchmark_seed, benchmark_sizes,
                        generate_random_problem)
from .problem import (Problem, format_problem, read_problem,
                      read_random_problem, read_seed_file, write_seed_file)
from .result import SolveResult
from .timed import solve_timed

#: Reference CLI generation range.
MIN, MAX = -100.0, 100.0

#: Flags of the JAX CLI that the port does not run yet, and the ROADMAP
#: item that ports each.
UNPORTED = {
    "checkpoint": "--checkpoint: the resumable solve (and its sharded "
                  "variant) is ROADMAP queue 1 item 9",
}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simplex-tpu-torch",
        description="dense two-phase simplex LP solver (PyTorch, CUDA)")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-f", metavar="FILE", help="problem file")
    mode.add_argument("-r", nargs="+", metavar="N",
                      help="vars constraints [seed]")
    mode.add_argument("-rs", nargs="+", metavar="N",
                      help="vars constraints [seed]; saves a seed file")
    mode.add_argument("-rf", metavar="FILE", help="seed file")
    mode.add_argument("-t", action="store_true", help="benchmark sweep")

    p.add_argument("--data-dir", default="data",
                   help="output root (solution.txt, examples/, measures/)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the solve runs (default: cuda)")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"])
    p.add_argument("--vector-dtype", default="float64",
                   choices=["float32", "float64"],
                   help="dtype of b/costs/z; float64 over a float32 "
                        "tableau is the mixed-precision mode (default)")
    p.add_argument("--timer", action="store_true",
                   help="write per-operation timing CSV (reference -D TIMER)")
    p.add_argument("--per-iteration", action="store_true",
                   help="one CSV row per pivot (reference solve timing)")
    p.add_argument("--reference-degeneracy", action="store_true",
                   help="abort DEGENERATE like the reference instead of "
                        "pivoting the artificials out")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--eps", type=float, default=None,
                   help="comparison epsilon (default: 1e-9 for float64, "
                        "1e-4 for float32)")
    p.add_argument("--block", type=int, default=None, metavar="L",
                   help="deferred block-pivot window; default: the "
                        "sequential reference loop")
    p.add_argument("--pivot-rule", default="auto",
                   choices=["auto", "dantzig", "devex", "bland"],
                   help="entering-variable pricing: auto (devex for f32 "
                        "--block runs, dantzig elsewhere), dantzig, devex "
                        "or bland")
    p.add_argument("--equilibrate", action="store_true",
                   help="power-of-two row/column equilibration (the "
                        "option; only solve() reads it)")
    p.add_argument("--limit", type=int, default=8192,
                   help="benchmark sweep upper size")
    p.add_argument("--resume-sweep", action="store_true",
                   help="with -t --timer: skip sizes whose measures CSV "
                        "is already complete")
    p.add_argument("--debug", action="store_true",
                   help="print the problem and the tableau after every "
                        "stage (reference -D DEBUG)")
    p.add_argument("--pause", action="store_true",
                   help="with --debug: wait for Enter after each dump")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler chrome trace of the solve "
                        "to DIR/trace.json")
    p.add_argument("--batch", type=int, default=1, metavar="B",
                   help="with -r/-rs/-rf: solve B instances (seeds "
                        "seed..seed+B-1) in one batched call")
    p.add_argument("--fleet", type=int, default=None, metavar="NDEV",
                   help="with --batch: split the B instances across NDEV "
                        "ranks (B must divide by NDEV)")
    p.add_argument("--checkpoint", metavar="PATH", default=None,
                   help="not ported yet (ROADMAP queue 1 item 9)")
    p.add_argument("--checkpoint-every", type=int, default=1000,
                   metavar="N", help="pivots per checkpoint window")
    p.add_argument("--sharded", type=int, default=None, metavar="NDEV",
                   help="solve on NDEV ranks, the tableau's variable axis "
                        "split across them (torch.distributed)")
    return p


def _options(args) -> SolverOptions:
    return SolverOptions(
        dtype=np.dtype(args.dtype),
        vector_dtype=np.dtype(args.vector_dtype),
        eps=args.eps,
        max_iter=args.max_iter,
        block_pivots=args.block,
        pivot_rule=None if args.pivot_rule == "auto" else args.pivot_rule,
        degeneracy="reference" if args.reference_degeneracy else "continue",
        equilibrate=args.equilibrate,
    )


def _int3(values, what: str) -> tuple[int, int, int]:
    if len(values) < 2:
        raise SystemExit(f"{what} needs: vars constraints [seed]")
    n, m = int(values[0]), int(values[1])
    seed = int(values[2]) if len(values) > 2 else int(time.time())
    return n, m, seed


def _report(result: SolveResult, problem: Problem, data_dir: str) -> None:
    """Reference status lines + solution file."""
    print()
    print(result.status.message)
    if result.status == Status.OPTIMAL:
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, "solution.txt")
        with open(path, "w") as fh:
            for v in result.x:
                fh.write(f"{v:f}\n")
            fh.write(f"\nOptimal value: {result.objective:f}\n")
        print(f"Optimal value: {result.objective:f}")
        print(f"Solution written to {path}")
    print(f"(phase-1 pivots: {result.iterations_phase1}, "
          f"phase-2 pivots: {result.iterations_phase2})")


def _sweep_manifest(measures: str) -> str:
    return os.path.join(measures, ".sweep_done")


def _sweep_csv_complete(measures: str, n_vars: int,
                        n_constraints: int) -> bool:
    """True when the size finished: its chrono CSV ends with the
    ``solution`` row (OPTIMAL solves), or the sweep manifest records the
    size (sizes that ended INFEASIBLE/UNBOUNDED/MAXITER, whose CSVs end
    like a crash after a phase). A crashed sweep leaves a dangling
    partial row and no manifest entry, so the size is run again."""
    key = f"{n_vars}_{n_constraints}"
    try:
        with open(_sweep_manifest(measures)) as fh:
            if any(line.split()[:1] == [key] for line in fh):
                return True
    except OSError:
        pass
    path = os.path.join(measures, f"benchmark_{n_vars}_{n_constraints}.txt")
    try:
        with open(path, "rb") as fh:
            tail = fh.read()[-256:].decode("utf-8", "replace")
    except OSError:
        return False
    lines = [line for line in tail.splitlines() if line.strip()]
    return bool(lines) and lines[-1].split(",")[2:3] == ["solution"]


def _sweep(args, options: SolverOptions) -> None:
    """Benchmark sweep (the reference's -t)."""
    measures = os.path.join(args.data_dir, "measures")
    print(f"Running a benchmark (max {args.limit}*{args.limit})...",
          file=sys.stderr)
    sweep_start = time.time()
    for n_vars, n_constraints in benchmark_sizes(args.limit):
        print(f"\nCurrent matrix: {n_vars}*{n_constraints}\n")
        if args.resume_sweep and args.timer and _sweep_csv_complete(
                measures, n_vars, n_constraints):
            print("already measured (complete CSV); skipping")
            continue
        problem = generate_random_problem(
            n_vars, n_constraints, benchmark_seed(n_vars, n_constraints),
            1.0, 100.0)
        chrono = (Chrono.open_benchmark(measures, n_vars, n_constraints)
                  if args.timer else NullChrono())
        with chrono:
            result = solve_timed(problem, options, chrono,
                                 per_iteration=args.per_iteration,
                                 device=args.device)
        print(f"status={result.status.name} objective={result.objective:f} "
              f"pivots={result.iterations_phase1}+"
              f"{result.iterations_phase2}")
        if args.timer:
            with open(_sweep_manifest(measures), "a") as fh:
                fh.write(f"{n_vars}_{n_constraints} "
                         f"{result.status.name}\n")
    print(f"Benchmark finished in {time.time() - sweep_start:.3f}s")


def _profiler(directory: str | None, device: str):
    """A torch.profiler context that writes ``directory/trace.json`` on
    exit, or a null context."""
    if not directory:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def traced():
        os.makedirs(directory, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(directory, "trace.json"))

    return traced()


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    print("Starting...")
    for flag, message in UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(message)
    options = _options(args)

    if args.t:
        _sweep(args, options)
        return 0

    if args.f:
        print("Reading problem from file...")
        problem = read_problem(args.f)
    elif args.rf:
        print("Reading seed from file")
        problem = read_random_problem(args.rf)
    else:
        n, m, seed = _int3(args.r or args.rs, "-r/-rs")
        print(f"Generating random problem with {n} variables, "
              f"{m} constraints with seed: {seed}")
        problem = generate_random_problem(n, m, seed, MIN, MAX)
        if args.rs:
            stamp = time.strftime("%Y%m%d%H%M")
            path = os.path.join(args.data_dir, "examples",
                                f"random_{stamp}.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_seed_file(path, n, m, seed, MIN, MAX)
            print(f"Seed file saved to {path}")

    if args.sharded:
        if args.timer or args.per_iteration or args.batch > 1 or args.fleet:
            raise SystemExit(
                "--sharded runs one solve across ranks and is "
                "incompatible with --timer/--per-iteration/--batch/--fleet")
        from .parallel.group import backend_for, spawn
        from .parallel.sharded import solve_sharded_rank

        print(f"Resolving on a {args.sharded}-device 'vars' mesh....")
        t0 = time.time()
        (result,) = spawn(solve_sharded_rank, args.sharded,
                          backend_for(args.device), args.device,
                          [(problem, options)])
        print(f"Sharded solve finished in {time.time() - t0:.3f}s")
        _report(result, problem, args.data_dir)
        return 0

    if args.fleet and args.batch <= 1:
        raise SystemExit("--fleet requires --batch B > 1 (it splits the "
                         "batch across ranks)")
    if args.batch > 1:
        if args.f:
            raise SystemExit("--batch requires a seeded mode (-r/-rs/-rf)")
        from .batch import solve_batched

        if args.rf:
            n, m, seed, lo, hi = read_seed_file(args.rf)
        else:
            lo, hi = MIN, MAX
        problems = [generate_random_problem(n, m, seed + i, lo, hi)
                    for i in range(args.batch)]
        where = (f"across a {args.fleet}-device fleet" if args.fleet
                 else "batched")
        print(f"Solving {args.batch} instances "
              f"(seeds {seed}..{seed + args.batch - 1}) {where}...")
        t0 = time.time()
        if args.fleet:
            from .batch import solve_batched_rank
            from .parallel.group import backend_for, spawn

            results = spawn(solve_batched_rank, args.fleet,
                            backend_for(args.device), args.device, problems,
                            options)
        else:
            results = solve_batched(problems, options, device=args.device)
        dt = time.time() - t0
        for i, r in enumerate(results):
            obj = f"{r.objective:f}" if r.status == Status.OPTIMAL else "-"
            print(f"seed {seed + i}: {r.status.name} objective={obj} "
                  f"pivots={r.iterations_phase1}+{r.iterations_phase2}")
        print(f"Batch solved in {dt:.3f}s "
              f"({dt / args.batch * 1e3:.1f} ms/instance)")
        return 0

    if args.debug:
        print(format_problem(problem))

    chrono = (Chrono.open_timestamped(os.path.join(args.data_dir,
                                                   "measures"))
              if args.timer else NullChrono())
    print("Resolving....")
    with _profiler(args.profile, args.device), chrono:
        result = solve_timed(problem, options, chrono,
                             per_iteration=args.per_iteration,
                             debug=args.debug, pause=args.pause,
                             device=args.device)
    _report(result, problem, args.data_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
