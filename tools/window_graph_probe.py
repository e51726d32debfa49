#!/usr/bin/env python3
"""The production single-LP kernel loop on the card, four ways in turns.

The flagship random_8192_8192 through ``solve`` with the production
options, its loop (``solver.solve_loop_blocked_kernel``) run as:

* ``eager-glue``: K1 and K2 without their tails enqueued eagerly, with
  the per-pivot glue as plain PyTorch (``kernels.blocked.step_*_plain``),
  the loop as it ran before any step kernel;
* ``graph-glue``: one CUDA graph a window of that;
* ``graph``: one CUDA graph a window of ``step_pre`` and K1 and K2 with
  the steps as their tails (the production path);
* ``eager``: the same enqueued eagerly (``graph=False``).

Each run must walk the recorded pivots, and each loop call must end with
the first run's state bit for bit (the plain glue and the tails compute
the same bits). Prints each run's loop ms/pivot, solve wall and
capture ms, the medians, then the same for two small sizes (``--small``)
as solve walls, then ``chip_smoke.phase_window_trace``'s trace of a
replayed window. Run from the root of a checkout on a CUDA card::

    python3 tools/window_graph_probe.py [--rounds 2] [--small 256,1024]
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: variant: (graph, plain glue)
VARIANTS = {"eager-glue": (False, True), "graph-glue": (True, True),
            "graph": (True, False), "eager": (False, False)}


def _k1_then_plain(Tt, F, C, b, t, eps, s, ah, ws=None):
    """K1 without its tail, then the step between K1 and K2 in PyTorch."""
    from simplex_tpu_torch.kernels import blocked as kb

    kb.ah_ratio(Tt, F, C, b, s.h, t, eps, ws,
                out=(ah, s.k, s.p_k1, s.bk, s.unb))
    kb.step_mid_plain(s)


def _k2_then_plain(Tt, C, F, costs, t, r, eps, ah, b, base, w, s, max_iter,
                   ws=None, *, bland_static, threshold, then_pre):
    """K2 without its tail, then the step after K2 in PyTorch."""
    from simplex_tpu_torch.kernels import blocked as kb

    kb.colk_costs(Tt, C, F, costs, s.k, t, s.u, s.do, r, eps, ah, b, base,
                  s.h, s.p, s.bk, w, ws, out=(s.h_d, s.v_d, s.h_b, s.v_b))
    kb.step_post_plain(s, max_iter, eps, bland_static, threshold, then_pre)


@contextlib.contextmanager
def plain_glue(on: bool):
    """The loop's step kernel and K1 and K2 with their tails replaced by
    K1 and K2 alone and the plain steps."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import blocked as kb

    names = ("step_pre", "ah_ratio_tail", "colk_costs_tail")
    saved = tuple(getattr(solver, name) for name in names)
    if on:
        for name, fn in zip(names, (kb.step_pre_plain, _k1_then_plain,
                                    _k2_then_plain)):
            setattr(solver, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(solver, name, fn)


def small_walls(n: int, rounds: int) -> None:
    """random n x n (the host generator, seed n) solved with the loop
    eager and graphed in turns: each solve's wall and walk."""
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch import solver

    p = st.generate_random_problem(n, n, n, 1, 100)
    real = solver.solve_loop_blocked_kernel
    walls = {False: [], True: []}
    walks = set()
    for graph in (False, True) * rounds + (True, False) * rounds:
        solver.solve_loop_blocked_kernel = (
            lambda *a, graph=graph, **kw: real(*a, graph=graph, **kw))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = st.solve(p, device="cuda", **cs.PROD)
            torch.cuda.synchronize()
        finally:
            solver.solve_loop_blocked_kernel = real
        walls[graph].append(time.perf_counter() - t0)
        walks.add((res.status.name, res.iterations_phase1,
                   res.iterations_phase2))
    cs.require(len(walks) == 1, f"{n}x{n}: walks {walks}")
    log = ", ".join(
        f"{'graph' if g else 'eager'} median {statistics.median(w):.4f} s "
        f"(min {min(w):.4f})" for g, w in walls.items())
    cs.log(f"random {n}x{n} production solve, walk {walks.pop()}: {log}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of the four variants, in turns (default 2)")
    ap.add_argument("--small", default="256,1024",
                    help="sizes n of the small n x n solves (default "
                         "256,1024; empty for none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_graph_probe: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from simplex_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {cs.nvidia_smi_line()}")
    _build.build()
    _build.load_library()
    p = cs.benchmark_problem(8192)
    keep: list = []
    ms = {name: [] for name in VARIANTS}
    order = list(VARIANTS) * args.rounds
    order = order[:len(VARIANTS)] + order[len(VARIANTS):][::-1]
    try:
        for i, name in enumerate(order):
            graph, glue = VARIANTS[name]
            with plain_glue(glue):
                r = cs.flagship_loops(p, graph, keep=None if i else keep,
                                      against=keep if i else None,
                                      tails=not glue)
            ms[name].append(r["ms_pivot"])
            cs.log(f"{name}: {r['ms_pivot']:.4f} ms/pivot over "
                   f"{r['pivots']} pivots (loop calls "
                   + ", ".join(f"{1e3 * c[0]:.1f} ms / {c[1]}"
                               for c in r["calls"])
                   + f"); solve wall {r['wall']:.3f} s; captures "
                   + (", ".join(f"{c:.2f}" for c in r["captures"])
                      or "none") + " ms")
        del keep
        cs.log("loop ms/pivot, median (all): " + "; ".join(
            f"{name} {statistics.median(v):.4f} ("
            + ", ".join(f"{x:.4f}" for x in v) + ")"
            for name, v in ms.items()))
        for n in filter(None, args.small.split(",")):
            small_walls(int(n), args.rounds)
        cs.phase_window_trace()
    except cs.SmokeFailure as e:
        print(f"window_graph_probe: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
