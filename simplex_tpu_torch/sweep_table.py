"""Tabulate the 36-size ``-t`` sweep against the reference's CSVs.

Port of the JAX package's ``tools/sweep_table.py``, with its command line
and its output, run as::

    python -m simplex_tpu_torch.sweep_table [--ours data/measures]
        [--ref data/reference_measures] [--label "f64 exact"]

It reads the aggregate chrono CSVs that ``python -m simplex_tpu_torch.cli
-t --timer`` writes (``<data-dir>/measures/benchmark_V_C.txt``, the
reference's schema) and the reference's per-pivot CSVs
(``data/reference_measures/benchmark_V_C.txt``, one ``solve`` row a pivot;
the reference's main.cu:59-73), and prints a markdown table: per size,
the phase pivots and solve seconds of both and the reference's solve
seconds over ours. Phases are told apart by the CSV's ``vars`` column
(n+2m+1 rows in phase 1, n+m+1 in phase 2). The number of sizes goes to
stderr. It runs on the host only and touches no device.
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys


def read_ours(path: pathlib.Path):
    """(p1_pivots, p2_pivots, solve_s, total_s) from an aggregate CSV, or
    None for an empty (in-progress) file."""
    per_phase: dict = {}     # vars -> {operation: summed value}
    total = 0.0
    with path.open() as f:
        for row in csv.DictReader(f):
            v = int(row["vars"])
            op = row["operation"]
            el = float(row["elapsed_time"])
            per_phase.setdefault(v, {}).setdefault(op, 0.0)
            per_phase[v][op] += el
            if op != "solveIterations":     # a count, not a time
                total += el
    phases = sorted(per_phase, reverse=True)     # phase 1 has more rows
    if not phases:
        return None
    p1 = per_phase[phases[0]]
    p2 = per_phase[phases[1]] if len(phases) > 1 else {}
    return (int(p1.get("solveIterations", 0)),
            int(p2.get("solveIterations", 0)),
            (p1.get("solve", 0.0) + p2.get("solve", 0.0)) / 1e6,
            total / 1e6)


def read_reference(path: pathlib.Path):
    """(p1_pivots, p2_pivots, solve_s, total_s) from a per-pivot CSV."""
    counts: dict = {}
    solve_us = 0.0
    total_us = 0.0
    with path.open() as f:
        for row in csv.DictReader(f):
            v = int(row["vars"])
            el = float(row["elapsed_time"])
            total_us += el
            if row["operation"] == "solve":
                counts[v] = counts.get(v, 0) + 1
                solve_us += el
    phases = sorted(counts, reverse=True)
    p1 = counts[phases[0]] if phases else 0
    p2 = counts[phases[1]] if len(phases) > 1 else 0
    return p1, p2, solve_us / 1e6, total_us / 1e6


def table_rows(ours_dir: pathlib.Path, ref_dir: pathlib.Path) -> list:
    """(vars, constraints, ours, reference or None) for every non-empty
    ``benchmark_V_C.txt`` of ``ours_dir``, by size."""
    rows = []
    for ours in sorted(ours_dir.glob("benchmark_*.txt"),
                       key=lambda p: tuple(map(int, p.stem.split("_")[1:]))):
        v, c = map(int, ours.stem.split("_")[1:])
        ref = ref_dir / ours.name
        o = read_ours(ours)
        if o is None:
            continue
        r = read_reference(ref) if ref.exists() else None
        rows.append((v, c, o, r))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.sweep_table",
        description="the -t sweep's CSVs against the reference's, as a "
                    "markdown table")
    ap.add_argument("--ours", default="data/measures")
    ap.add_argument("--ref", default="data/reference_measures")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    rows = table_rows(pathlib.Path(args.ours), pathlib.Path(args.ref))
    label = f" ({args.label})" if args.label else ""
    print(f"| n × m | pivots{label} p1+p2 | ref pivots p1+p2 "
          f"| solve s{label} | ref solve s | speedup |")
    print("|---|---|---|---|---|---|")
    for v, c, o, r in rows:
        op1, op2, osolve, _ = o
        if r:
            rp1, rp2, rsolve, _ = r
            sp = f"{rsolve / osolve:.1f}×" if osolve > 0 else "—"
            print(f"| {v}×{c} | {op1}+{op2} | {rp1}+{rp2} "
                  f"| {osolve:.2f} | {rsolve:.2f} | {sp} |")
        else:
            print(f"| {v}×{c} | {op1}+{op2} | — | {osolve:.2f} | — | — |")
    print(f"\n{len(rows)} sizes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
