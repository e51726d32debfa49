#!/usr/bin/env python3
"""Route (b) of the PyTorch port's batched fallback on one CUDA card, the
lane-batched plain blocked loop against the lane-by-lane route it
replaced, and how the card rounds the two routes' products.

Config 3's first N lanes (256 x (m=500, n=2,000) from seeds 1000..1255;
N from ``--lanes``, 16 and 256 by default) go through ``solve_batch``
with ``kernel=False`` at config 3's options (f32 tableau, f64 vectors,
eps 1e-5, L=32, devex) and as an f64 blocked batch (L=32): first on the
lane-batched loop (``batch_fallback.solve_loop_blocked_batched``, the
dispatch), then, for each N in ``--reference``, on the lane-by-lane
reference (``batch_fallback.solve_device_lanes``, each lane through the
single-LP device core in turn). Each run prints its wall (host clock
ending in ``torch.cuda.synchronize``), the device and refinement seconds
of ``solve_batch``'s ``stats``, the windows per phase, the walk digest
(``chip_smoke.walk_digest``) and the peak device memory. With
``--trace``, the 256-lane (largest N) lane-batched runs once more under
torch.profiler (CUDA activity): the kernels' busy share of the device
solve, the copies apart, and the device time by kernel.

Last, at config 3's phase-1 shapes (B=256, M=512, R=3,000, L=32) in f32
and f64: how many elements the batched products (``baddbmm_`` for the
window apply, ``bmm`` for the eta corrections, ``reprice_lanes``) give
otherwise than the single-LP loop's per-lane ones (``addmm_``, a vector
times a matrix, ``tableau.tt_matvec``)::

    python3 tools/fallback_walls.py [--lanes 16 256] [--reference 16]
        [--trace]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = dict(dtype="float32", vector_dtype="float64", eps=1e-5,
             block_pivots=32)
F64 = dict(dtype="float64", block_pivots=32)
CONFIG3 = (2000, 500, range(1000, 1256))


def walk_digest(results) -> str:
    """sha256 over each lane's (status, phase-1 pivots, phase-2 pivots,
    objective.hex()), as ``chip_smoke.walk_digest``."""
    h = hashlib.sha256()
    for r in results:
        obj = "none" if r.objective is None else float(r.objective).hex()
        h.update(f"{int(r.status)} {r.iterations_phase1} "
                 f"{r.iterations_phase2} {obj};".encode())
    return h.hexdigest()


def run(label: str, problems, opts: dict, reference: bool,
        trace: bool = False) -> None:
    """One ``solve_batch(kernel=False)`` of ``problems`` on the card,
    through the lane-by-lane reference when ``reference``, under
    torch.profiler when ``trace``."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import simplex_tpu_torch as st
    from simplex_tpu_torch import batch, batch_fallback

    dispatch = batch.solve_device_batched
    if reference:
        def lanes(A, b, c, n, m, options, kernel="auto"):
            return batch_fallback.solve_device_lanes(A, b, c, n, m, options)
        batch.solve_device_batched = lanes
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats: dict = {}
        prof = (profile(activities=[ProfilerActivity.CUDA]) if trace
                else contextlib.nullcontext())
        with prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = st.solve_batch(problems, device="cuda", stats=stats,
                                 kernel=False, **opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        batch.solve_device_batched = dispatch
    route = "lane by lane" if reference else "lane-batched"
    if trace:
        route += ", traced"
    print(f"{label}, {len(problems)} lanes, {route}: wall {wall:.3f} s "
          f"(data to the card {stats['prepare_s']:.3f} s, device solve "
          f"{stats['device_s']:.3f} s, host refinement "
          f"{stats['refine_s']:.3f} s); windows per phase "
          f"{stats['windows']}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; walk digest "
          f"{walk_digest(res)}", flush=True)
    if trace:
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        copy_s = sum(r[0] for r in rows if r[2].startswith("Memcpy")) / 1e6
        kernel_s = sum(r[0] for r in rows) / 1e6 - copy_s
        print(f"  kernels busy {kernel_s:.3f} s = "
              f"{100 * kernel_s / stats['device_s']:.1f}% of the device "
              f"solve ({sum(r[1] for r in rows)} launches and copies); "
              f"copies {copy_s:.3f} s", flush=True)
        for us, count, key in rows[:10]:
            print(f"  {us / 1e3:10.3f} ms {count:7d} x {key[:80]}",
                  flush=True)


def rounding(dtype) -> None:
    """Elements where the batched products differ from the per-lane ones
    of the single-LP loop, at config 3's phase-1 shapes."""
    import torch

    from simplex_tpu_torch.batch_fallback import reprice_lanes
    from simplex_tpu_torch.tableau import tt_matvec

    B, M, R, L = 256, 512, 3000, 32
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, dt=dtype):
        return torch.rand(shape, generator=g, device="cuda",
                          dtype=dt) - 0.5

    T3, F, C = rand(B, M, R), rand(B, L, M), rand(B, L, R)
    batched = T3.clone().baddbmm_(F.transpose(1, 2), C, alpha=-1.0)
    apply_diff = sum(int((batched[i] != T3[i].clone().addmm_(
        F[i].t(), C[i], alpha=-1.0)).sum()) for i in range(B))
    eta = {}
    for t in (1, 17, 31):
        h = torch.randint(0, R, (B,), generator=g, device="cuda")
        ch = C[:, :t].gather(2, h.view(B, 1, 1).expand(B, t, 1))
        got = torch.bmm(ch.transpose(1, 2), F[:, :t])[:, 0]
        eta[t] = sum(int((got[i] != C[i, :t, h[i]] @ F[i, :t]).sum())
                     for i in range(B))
    v = rand(B, M, dt=torch.float64)
    got = reprice_lanes(T3, v)
    reprice_diff = sum(int((got[i] != tt_matvec(T3[i], v[i])).sum())
                       for i in range(B))
    print(f"rounding, {str(dtype).split('.')[-1]} at B={B}, M={M}, R={R}, "
          f"L={L}: baddbmm_ against addmm_ a lane {apply_diff} of "
          f"{B * M * R} elements; eta bmm against a lane's product "
          + ", ".join(f"t={t}: {n} of {B * M}" for t, n in eta.items())
          + f"; reprice_lanes against tt_matvec {reprice_diff} of {B * R}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="*", default=[16, 256])
    ap.add_argument("--reference", type=int, nargs="*", default=[16],
                    help="lane counts to run lane by lane as well")
    ap.add_argument("--trace", action="store_true",
                    help="trace the largest lane-batched run once more")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("fallback_walls: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _build.build()
    _build.load_library()
    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    for label, opts in (("kernel=False, config 3's options", BATCH),
                        ("f64 blocked, L=32", F64)):
        for lanes in args.lanes:
            run(label, problems[:lanes], opts, reference=False)
        for lanes in args.reference:
            run(label, problems[:lanes], opts, reference=True)
        if args.trace:
            run(label, problems[:max(args.lanes)], opts, reference=False,
                trace=True)
    for dtype in (torch.float32, torch.float64):
        rounding(dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
