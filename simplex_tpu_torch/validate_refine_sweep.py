"""Qualify the production mode across the reference's 36-size sweep.

Port of the JAX package's ``tools/validate_refine_sweep.py``, with its
command line, its rows and its stderr lines, run as::

    python -m simplex_tpu_torch.validate_refine_sweep      # on the card
    python -m simplex_tpu_torch.validate_refine_sweep --device cpu \\
        --limit 256 --out /tmp/sweep.json                  # plain versions

For every size of the reference's ``-t`` grid (vars, constraints in
{256..``--limit``}, seed ``vars*100 + constraints``; main.cu:49-77),
optionally cut to the ``--sizes`` pairs, it draws the seeded instance
from the host XORWOW stream (the JAX tool's instance, bit for bit),
solves it in the production configuration (f32 tableau, f64 vectors,
block ``--block``, devex, refinement on) and records:

* status, the pivots of each phase and the solve wall;
* the f64 refinement's certificates (primal residual, dual
  infeasibility, artificial mass) and whether they pass at the strong
  1e-9 scale-relative threshold as well as at the options' ``refine_tol``;
* the objective shift the refinement applied, the refine stage's wall,
  its method and whether the f64 finishing tier settled it
  (``fallback``).

The JSON file (``--out``) is rewritten after every size, so a run cut
short keeps its rows; the last write adds the summary, with the JAX
tool's keys and ``device`` (the card's name and power limit as
nvidia-smi prints them, or ``"cpu"``). The default ``--out`` is the
port's own record: the JAX package's ``refine_sweep_r5.json`` is never
written. The device is the card unless ``--device cpu`` is given;
without a card that raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .bench import card_label, log, synchronize
from .config import SolverOptions
from .generator import (benchmark_seed, benchmark_sizes,
                        generate_random_problem)
from .refine import STRONG_TOL, dual_strong
from .two_phase import resolve_device, solve

DEFAULT_OUT = "data/measures/h100_refine_sweep.json"


def strong_certified(refine, b, c) -> bool:
    """A RefineInfo's certificates at 1e-9 relative: the primal ones
    against ``1 + max|b|``, the dual infeasibility against ``1 + max|c|``
    (``tools/validate_refine_sweep.py:82-88``; the dual bound is
    ``refine.dual_strong``, the one ``two_phase.certify`` holds a basis
    to)."""
    b_scale = 1.0 + float(np.max(np.abs(b)))
    return (max(refine.primal_residual, refine.primal_negativity,
                refine.artificial_mass) <= STRONG_TOL * b_scale
            and dual_strong(refine.dual_infeasibility, c))


def sweep_row(n: int, m: int, seed: int, r, wall: float, b, c) -> dict:
    """One size's record, with the JAX tool's keys."""
    row = {"vars": n, "constraints": m, "seed": seed,
           "status": r.status.name,
           "pivots": [r.iterations_phase1, r.iterations_phase2],
           "objective": r.objective, "wall_s": round(wall, 3)}
    if r.refine is not None:
        row.update(certified=r.refine.certified,
                   certified_1e9=bool(strong_certified(r.refine, b, c)),
                   fallback=r.refine.fallback,
                   primal_residual=r.refine.primal_residual,
                   dual_infeasibility=r.refine.dual_infeasibility,
                   artificial_mass=r.refine.artificial_mass,
                   objective_shift=r.refine.objective_shift,
                   refine_wall_s=r.refine.wall_s,
                   refine_method=r.refine.method)
    return row


def row_line(row: dict, wall: float) -> str:
    """The JAX tool's per-size stderr line."""
    n, m = row["vars"], row["constraints"]
    return (f"{n:5d}x{m:5d}: {row['status']:9s} "
            f"pivots={row['pivots'][0]}+{row['pivots'][1]} "
            f"wall={wall:6.2f}s "
            + (f"cert1e9={row.get('certified_1e9')} "
               f"dual_inf={row.get('dual_infeasibility', 0):.2e} "
               f"shift={row.get('objective_shift', 0):+.2e} "
               f"refine={row.get('refine_wall_s', 0):.2f}s "
               f"fb={row.get('fallback')}"
               if "certified" in row else "no-refine"))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.validate_refine_sweep",
        description="the production mode across the -t grid, each solve "
                    "certified at 1e-9")
    ap.add_argument("--limit", type=int, default=8192)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated n_x_m pairs (e.g. "
                         "'8192x4096,8192x8192') to run instead of the "
                         "full grid")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    label = card_label(dev)
    options = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                            block_pivots=args.block)
    log(f"device={dev} ({label}) rule={options.pivot_rule_resolved} "
        f"block={args.block}")

    sizes = list(benchmark_sizes(args.limit))
    if args.sizes:
        want = {tuple(map(int, s.split("x"))) for s in
                args.sizes.split(",")}
        sizes = [nm for nm in sizes if nm in want]

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    t_sweep = time.time()
    for n, m in sizes:
        seed = benchmark_seed(n, m)
        p = generate_random_problem(n, m, seed, 1.0, 100.0)
        synchronize(dev)
        t0 = time.time()
        r = solve(p, options, device=dev)
        synchronize(dev)
        wall = time.time() - t0
        row = sweep_row(n, m, seed, r, wall, p.b, p.c)
        rows.append(row)
        log(row_line(row, wall))
        # Rewritten after every size: a run cut short keeps its rows.
        out.write_text(json.dumps({"rows": rows}, indent=1))

    summary = {"sizes": len(rows),
               "optimal": sum(r["status"] == "OPTIMAL" for r in rows),
               "certified_1e9": sum(bool(r.get("certified_1e9"))
                                    for r in rows),
               "fallbacks": sum(bool(r.get("fallback")) for r in rows),
               "wall_s": round(time.time() - t_sweep, 1),
               "pivot_rule": options.pivot_rule_resolved,
               "block": args.block, "device": label}
    log(f"summary: {summary}")
    out.write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
    log(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
