#!/usr/bin/env python3
"""The plain blocked sharded loop at one NCCL rank on the card, four ways.

Builds the kernels, then for small LPs under Dantzig, devex and Bland
(f64, and the f32 tableau with the kernels off) and for random 2048 x
2048 at L = 128, runs the eliminated phase-1 slice through
``parallel.sharded.solve_loop_blocked_sharded`` graphed and with
``graph=False``, through the single-card ``solver.solve_loop_blocked``
and through the old body (``solve_loop_blocked_sharded_reference``, the
small LPs only), and prints for each way the status and pivots, its
ms/pivot on the host clock (the capture included), z and the eta
kernels' launch counts; then whether the final slice, b, costs, z and
base of each way equal the graphed run's bit for bit. A first check of
a build on the card; ``chip_smoke.py`` holds the loop at full size.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/blocked_sharded_probe.py
"""

import dataclasses
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from simplex_tpu_torch import solver  # noqa: E402
from simplex_tpu_torch.config import SolverOptions  # noqa: E402
from simplex_tpu_torch.generator import generate_random_problem  # noqa: E402
from simplex_tpu_torch.kernels import _build  # noqa: E402
from simplex_tpu_torch.kernels import eta as ke  # noqa: E402
from simplex_tpu_torch.parallel import group as pg  # noqa: E402
from simplex_tpu_torch.parallel import sharded as ps  # noqa: E402


def run(g, opts, n, m, seed=3, ways=("graph", "eager", "single", "ref")):
    p = generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, 1, opts)
    sh = pg.Shard.of(g, R_pad)
    tab = ps.build_phase1_sharded(
        torch.as_tensor(p.A), torch.as_tensor(p.b, device="cuda"), n, m, sh,
        opts, M_pad, "cuda")
    costs0 = tab.costs
    tab = ps.gaussian_eliminate_sharded(tab, sh)
    outs = {}
    for way in ways:
        t = dataclasses.replace(tab, Tt=tab.Tt.clone())
        ke.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "graph":
            o = ps.solve_loop_blocked_sharded(t, sh, opts, 100000, costs0)
        elif way == "eager":
            o = ps.solve_loop_blocked_sharded(t, sh, opts, 100000, costs0,
                                              graph=False)
        elif way == "single":
            o = solver.solve_loop_blocked(t, opts, 100000, costs0)
        else:
            o = ps.solve_loop_blocked_sharded_reference(t, sh, opts, 100000,
                                                        costs0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outs[way] = o
        print(way, n, m, opts.pivot_rule, opts.dtype, o[1:],
              f"{1e3 * dt / max(o[2], 1):.4f} ms/pivot", float(o[0].z),
              {**ke.LAUNCHES, **ke.SLICE_LAUNCHES}, flush=True)
    a = outs["graph"]
    for way in ways[1:]:
        b = outs[way]
        print("  graph vs", way, [(k, torch.equal(getattr(a[0], k),
                                                  getattr(b[0], k)))
                                  for k in ("Tt", "b", "costs", "z", "base")],
              a[1:] == b[1:], flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("blocked_sharded_probe: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.build()
    _build.load_library()
    print("built", time.time() - t0, flush=True)
    f32 = dict(dtype=np.float32, use_pallas=False, block_pivots=8)
    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "nccl", td) as g:
        run(g, SolverOptions(block_pivots=8), 60, 24)
        run(g, SolverOptions(block_pivots=8, pivot_rule="devex"), 60, 24)
        run(g, SolverOptions(block_pivots=13, pivot_rule="bland"), 61, 23)
        run(g, SolverOptions(vector_dtype=np.float64, eps=1e-5, **f32), 60,
            24)
        run(g, SolverOptions(vector_dtype=np.float32, eps=1e-4,
                             pivot_rule="devex", **f32), 60, 24)
        run(g, SolverOptions(block_pivots=128), 2048, 2048, seed=2048,
            ways=("graph", "eager", "single"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
