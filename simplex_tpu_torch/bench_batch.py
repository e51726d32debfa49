"""Batched scenario solving benchmark (BASELINE.json config 3).

Port of the JAX package's ``tools/bench_batch.py``, with its command line
and its stdout contract, run as::

    python -m simplex_tpu_torch.bench_batch                # on the card
    python -m simplex_tpu_torch.bench_batch --device cpu --batch 4 \\
        --vars 60 --constraints 20 --repeats 1             # plain versions

256 independent seeded LPs (m = 500 constraints x n = 2,000 variables,
seeds 1000..1255, uniform [1, 100]) in one device call
(``batch.solve_device_batched``), across six solver configurations. The
host-to-device transfer of the stacked instances is timed on its own,
once. Per configuration: a first call, then the best of ``--repeats`` - 1
more, in seconds and ms per instance, every lane required OPTIMAL; then
one call through the host surface (``solve_batch`` with ``stats``), whose
split -- moving the data (``prepare_s``), the device solve
(``device_s``) and the host refinement (``refine_s``) -- goes to stderr.
The last configuration's lanes 0, B/2 and B-1 are held to the NumPy
oracle: within 1e-9 relative, 1e-6 on a lane the f64 finishing tier
settled. The device is the card unless ``--device cpu`` is given;
without a card that raises.

The last configuration (``kernel=False``, L = 128, devex) is the batched
fallback's route (b), the lane-batched plain blocked loop
(``batch_fallback.solve_loop_blocked_batched``); the others take the
batched kernels. As in the JAX script the lane-batched sequential loop is
left out (``tools/bench_batch.py:77-80``).

Diagnostics go to stderr; stdout's last line is ``BENCH_BATCH_OK``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .batch import solve_batched, solve_device_batched
from .bench import log, synchronize
from .config import SolverOptions, Status
from .generator import generate_random_problem
from .oracle import solve_oracle
from .two_phase import resolve_device

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5)

#: (name, options, kernel) as ``tools/bench_batch.py:52-76`` lists them.
CONFIGS = (
    ("kernel L=32 dantzig (r4 baseline)",
     SolverOptions(**MIXED, block_pivots=32, pivot_rule="dantzig"), "auto"),
    ("kernel L=32 devex (r5 default)",
     SolverOptions(**MIXED, block_pivots=32), "auto"),
    ("kernel L=64 devex",
     SolverOptions(**MIXED, block_pivots=128, batch_block_pivots=64),
     "auto"),
    ("kernel L=128 devex",
     SolverOptions(**MIXED, block_pivots=128, batch_block_pivots=128),
     "auto"),
    ("kernel L=128 dantzig",
     SolverOptions(**MIXED, block_pivots=128, batch_block_pivots=128,
                   pivot_rule="dantzig"), "auto"),
    ("fallback route (b) L=128 devex",
     SolverOptions(**MIXED, block_pivots=128), False),
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.bench_batch",
        description="config 3 (a batch of seeded LPs in one device call) "
                    "across six solver configurations")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--vars", type=int, default=2000)
    p.add_argument("--constraints", type=int, default=500)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--config", default=None,
                   help="run only the configurations whose name contains "
                        "this substring")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {dev} ({name})")
    n, m, B = args.vars, args.constraints, args.batch
    log(f"generating {B} instances ({n} x {m}, seeds 1000..{1000 + B - 1})")
    problems = [generate_random_problem(n, m, 1000 + i, 1, 100)
                for i in range(B)]
    configs = list(CONFIGS)
    if args.config:
        configs = [c for c in configs if args.config in c[0]]
        if not configs:
            raise SystemExit(f"no config matches {args.config!r}")

    # Host -> device transfer, timed on its own: a fleet moves its
    # instances once; the per-call metric is the device solve.
    t0 = time.perf_counter()
    A_host = np.stack([p.A for p in problems]).astype(np.float32)
    A = torch.from_numpy(A_host).to(dev)
    bb = torch.from_numpy(np.stack([p.b for p in problems])).to(dev)
    cc = torch.from_numpy(np.stack([p.c for p in problems])).to(dev)
    synchronize(dev)
    log(f"[batch] host stack + device transfer "
        f"({A_host.nbytes / 1e6:.0f} MB f32): "
        f"{time.perf_counter() - t0:.3f} s (once per fleet)")
    del A_host

    def run(opt, kern):
        out = solve_device_batched(A, bb, cc, n, m, opt, kernel=kern)
        return out.status.cpu().numpy()

    results = None
    for label, opt, kern in configs:
        t0 = time.perf_counter()
        status = run(opt, kern)
        cold = time.perf_counter() - t0
        times = []
        for _ in range(args.repeats - 1):
            t0 = time.perf_counter()
            status = run(opt, kern)
            times.append(time.perf_counter() - t0)
        best = min(times) if times else cold
        n_opt = int((status == int(Status.OPTIMAL)).sum())
        log(f"[batch] {label:40s} {best:8.3f} s "
            f"({best / B * 1e3:8.3f} ms/instance), {n_opt}/{B} OPTIMAL "
            f"(cold {cold:.3f} s)")
        if n_opt != B:
            raise RuntimeError(f"{label}: {B - n_opt} lanes not OPTIMAL")
        stats: dict = {}
        results = solve_batched(problems, opt, device=dev, kernel=kern,
                                stats=stats)
        log(f"[batch] {label:40s} solve_batch: prepare_s "
            f"{stats['prepare_s']:.3f}, device_s {stats['device_s']:.3f}, "
            f"refine_s {stats['refine_s']:.3f}, windows {stats['windows']}")

    # The last configuration's lanes against the oracle, through the
    # host surface (every OPTIMAL lane refined in f64 and certified).
    for i in sorted({0, B // 2, B - 1}):
        want = solve_oracle(problems[i])
        rel = abs(results[i].objective - want.objective) / (
            1 + abs(want.objective))
        ri = results[i].refine
        log(f"lane {i}: objective rel err {rel:.1e} "
            f"(pivots {results[i].iterations_phase1}"
            f"+{results[i].iterations_phase2}, "
            f"refine={None if ri is None else (ri.certified, ri.fallback)})")
        # A certified lane lands at 1e-9; a lane the finishing tier
        # settled, at its refine_tol certificate (1e-6 scale-relative).
        bound = 1e-6 if (ri is not None and ri.fallback) else 1e-9
        if not rel < bound:
            raise RuntimeError(f"lane {i}: objective {results[i].objective!r}"
                               f" against the oracle's {want.objective!r}")
    print("BENCH_BATCH_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
