#!/usr/bin/env python3
"""The walks of config 3's batch and of the wide batch on the card, as one
digest each, for holding two versions of the PyTorch port to the same
walks inside one run.

Config 3 is 256 x (m=500, n=2,000) random LPs from seeds 1000..1255, the
wide batch 32 x (m=500, n=14,000) from seeds 2000..2031, both through
``solve_batch`` with BASELINE.json config 3's options (f32 tableau, f64
vectors, eps 1e-5, L=32, devex); then config 3 again with the default
options (f64 tableau, the batched fallback's lane-batched sequential loop
over ``batch_rank1``), with its device ms per batched step. A batch's
digest is a sha256 over each lane's (status, phase-1 pivots, phase-2
pivots, objective.hex()), the digest ``chip_smoke.py`` prints. Each
``--root`` is a checkout of the repository (this one by default, or
another commit unpacked with ``git archive``); the script runs one
process per root, in the order given::

    python3 tools/batch_walks.py --root _checkout/parent --root .

Needs a CUDA card: a process that finds none exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
BATCH = dict(dtype="float32", vector_dtype="float64", eps=1e-5,
             block_pivots=32)
#: (label, n, m, seeds, options)
BATCHES = (("config 3", 2000, 500, range(1000, 1256), BATCH),
           ("wide lanes", 14000, 500, range(2000, 2032), BATCH),
           ("config 3 default options", 2000, 500, range(1000, 1256), {}))


def walk_digest(results) -> str:
    """sha256 over each lane's (status, phase-1 pivots, phase-2 pivots,
    objective.hex())."""
    h = hashlib.sha256()
    for r in results:
        obj = "none" if r.objective is None else float(r.objective).hex()
        h.update(f"{int(r.status)} {r.iterations_phase1} "
                 f"{r.iterations_phase2} {obj};".encode())
    return h.hexdigest()


def measure(root: pathlib.Path) -> int:
    """Solve both batches from ``root``'s package on the card and print
    each one's digest, wall and device time."""
    sys.path.insert(0, str(root))
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("batch_walks: torch.cuda is not available", file=sys.stderr)
        return 2
    _build.build()
    _build.load_library()
    for label, n, m, seeds, options in BATCHES:
        problems = [st.generate_random_problem(n, m, s, 1, 100)
                    for s in seeds]
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = st.solve_batch(problems, device="cuda", stats=stats, **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = sum(stats["windows"])
        print(f"{root}: {label} walk digest {walk_digest(res)}; wall "
              f"{wall:.3f} s, device solve {stats['device_s']:.3f} s "
              f"({1e3 * stats['device_s'] / steps:.4f} ms a step of "
              f"{steps}: a window on the kernel path, a pivot on the "
              "fallback's)", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=pathlib.Path,
                    help="a checkout to run (repeatable; default: this one)")
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return measure(args.child.resolve())
    for root in args.root or [HERE.parents[1]]:
        rc = subprocess.run([sys.executable, str(HERE), "--child",
                             str(root)]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
