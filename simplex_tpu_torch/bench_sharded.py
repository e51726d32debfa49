"""The sharded loop's marginal ms/pivot on the north-star dense LP.

Port of the JAX package's ``tools/bench_sharded.py``, with its command
line and its stdout line, run as::

    python -m simplex_tpu_torch.bench_sharded             # one NCCL rank
    python -m simplex_tpu_torch.bench_sharded --devices 2 --device cpu \\
        --vars 300 --constraints 80 --lo 16 --hi 48        # two gloo ranks

``--devices`` ranks are processes (``parallel.group.spawn``): NCCL with
one card a rank, gloo on the CPU with ``--device cpu``. Each rank draws A
and b from the bench's seeded generator (``bench.bench_problem``, the
tableau of ``python -m simplex_tpu_torch.bench``), builds only its own
slice of the phase-1 tableau (``build_phase1_sharded``), eliminates it
(``gaussian_eliminate_sharded``), and runs the production loop on the
slices (``run_solve_loop_sharded`` with the pre-elimination costs, so the
windows are re-priced) to two iteration caps. The loop updates the slice
in place, so each run starts from a copy refilled from the rank's
pristine slice outside the timed window, and each repeat must walk as
the first run at its cap did (the same pivots and z). The time is rank
0's host clock from a barrier to the end of the loop, ending in
``torch.cuda.synchronize()``::

    ms/pivot = (t(hi) - t(lo)) / (pivots(hi) - pivots(lo))

The collectives of a run (``group.COUNTS``) per pivot go to stderr.
Rank 0's line on stdout, in the JAX script's format and under its key:
``{"sharded_ms_per_pivot_mesh{N}": ..., "lo": [t, pivots], "hi": [t,
pivots]}``. Exits 1 when both caps end at the same pivot count.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .bench import (bench_problem, log, restore, synchronize,
                    working_copy)
from .config import SolverOptions
from .parallel import group as pg
from .parallel.sharded import (build_phase1_sharded,
                               gaussian_eliminate_sharded,
                               run_solve_loop_sharded, sharded_padded_dims)
from .two_phase import resolve_device


def marginal_rank(group, device, n: int, m: int, options: SolverOptions,
                  caps: tuple, repeats: int) -> dict:
    """One rank's part (for ``parallel.group.spawn``): build the slice,
    then at each cap a first run and ``repeats`` timed ones. Returns
    ``{cap: (best seconds, pivots)}`` and logs from rank 0."""
    R_pad, M_pad = sharded_padded_dims(n, m, dist.get_world_size(group),
                                       options)
    shard = pg.Shard.of(group, R_pad)
    say = log if shard.rank == 0 else (lambda msg: None)
    t0 = time.perf_counter()
    A, b = bench_problem(n, m, device)
    tab = build_phase1_sharded(A, b, n, m, shard, options, M_pad, device)
    del A
    costs0 = tab.costs
    tab0 = gaussian_eliminate_sharded(tab, shard)
    synchronize(device)
    say(f"slice {tuple(tab0.Tt.shape)} of ({M_pad}, {R_pad}) built and "
        f"eliminated in {time.perf_counter() - t0:.3f}s")
    work = working_copy(tab0)

    def run(cap):
        restore(work, tab0)
        pg.barrier(group, device)
        pg.reset_counts()
        t0 = time.perf_counter()
        out, status, iters = run_solve_loop_sharded(work, shard, options,
                                                    cap, costs0)
        synchronize(device)
        return (time.perf_counter() - t0, status, iters,
                float(out.z).hex(), dict(pg.COUNTS))

    results = {}
    for cap in caps:
        secs, status, pivots, z, counts = run(cap)
        say(f"max_iter={cap}: first run {secs:.3f}s, status={status} "
            f"pivots={pivots} z={float.fromhex(z):.6f}; collectives a "
            "pivot: " + ", ".join(f"{k} {v / max(pivots, 1):.3f}"
                                  for k, v in sorted(counts.items())))
        best = np.inf
        for i in range(repeats):
            dt, _, got, gz, _ = run(cap)
            if (got, gz) != (pivots, z):
                raise RuntimeError(
                    f"repeat {i} at cap {cap} walked otherwise: {got} "
                    f"pivots, z {gz}, against {pivots}, z {z}")
            best = min(best, dt)
            say(f"  repeat {i}: {dt:.3f}s, {got} pivots")
        results[cap] = (best if repeats else secs, pivots)
    return results


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.bench_sharded",
        description="marginal ms/pivot of the sharded solve loop")
    p.add_argument("--vars", type=int, default=100_000)
    p.add_argument("--constraints", type=int, default=10_000)
    p.add_argument("--block", type=int, default=128)
    p.add_argument("--lo", type=int, default=256)
    p.add_argument("--hi", type=int, default=768)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--pivot-rule", default="dantzig",
                   choices=["dantzig", "bland", "devex"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    backend = pg.backend_for(dev)
    n_shards = args.devices
    log(f"device: {dev} ({name}), {n_shards} rank(s) over {backend}")
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        block_pivots=args.block or None,
                        pivot_rule=args.pivot_rule)
    results = pg.spawn(marginal_rank, n_shards, backend, args.device,
                       args.vars, args.constraints, opt,
                       (args.lo, args.hi), args.repeats)
    (t_lo, p_lo), (t_hi, p_hi) = results[args.lo], results[args.hi]
    if p_hi == p_lo:
        log("ERROR: same pivot count at both caps (solve finished early)")
        return 1
    ms = (t_hi - t_lo) / (p_hi - p_lo) * 1e3
    log(f"marginal sharded ms/pivot (mesh={n_shards}): {ms:.4f} "
        f"({p_hi - p_lo} marginal pivots)")
    print(f'{{"sharded_ms_per_pivot_mesh{n_shards}": {ms:.4f}, '
          f'"lo": [{t_lo:.3f}, {p_lo}], "hi": [{t_hi:.3f}, {p_hi}]}}',
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
