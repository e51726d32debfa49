#!/usr/bin/env python3
"""Drive the PyTorch port (``simplex_tpu_torch``) once on one NVIDIA H100.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and the build of the CUDA kernels from ``csrc`` (timed);
2. the example goldens through ``solve(..., device="cuda")``;
3. random_1024_1024 -> OPTIMAL, certified, objective 4.000455470573328;
4. the flagship random_8192_8192 -> OPTIMAL, certified, objective
   2.701733460335518 -- the main path, with the launch counters reset
   just before the first solve and read just after it; then solved
   again, for the wall-time spread of warm solves (each solve must walk
   the same pivots);
5. the 10,000 x 100,000 phase-1 tableau built on the card, run for 256
   pivots (2 windows);
6. each kernel K1-K4 against its plain PyTorch version on the card at
   the flagship shapes (M=8192, R=24576, L=128, t in {0, 37, 127}; K2
   under devex and Dantzig), both timed on the device by torch.profiler.
   It runs last so that no profiler session precedes the timed solves.

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' records, and ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "data" / "examples"
PROD = dict(dtype="float32", vector_dtype="float64", block_pivots=128)

#: Certified f64 objectives (data/measures/refine_sweep_r5.json).
OBJ_1024 = 4.000455470573328
OBJ_8192 = 2.701733460335518
#: Flagship solves in one process: the first, then the warm ones.
FLAGSHIP_SOLVES = 5

#: The JAX kernels each CUDA kernel replaces (function reaching
#: pl.pallas_call).
KERNELS = {
    "ah_ratio": ("K1", "simplex_tpu/kernels/blocked.py:1201"),
    "colk_costs": ("K2", "simplex_tpu/kernels/blocked.py:410"),
    "apply_reprice": ("K3", "simplex_tpu/kernels/blocked.py:832"),
    "apply_window": ("K4", "simplex_tpu/kernels/blocked.py:694"),
}
SOURCE = "simplex_tpu_torch/kernels/csrc/blocked.cu"


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn()``: the summed durations of the kernels
    it launches, traced by torch.profiler (CUPTI) over ``reps`` calls
    after one warm-up call. The host's launch rate is left out: at these
    shapes one call of a per-pivot pass runs for microseconds, less than
    the host takes to enqueue it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    require(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / reps


def close(name: str, got, want, tol) -> float:
    """Max |got - want|, required to stay within the elementwise ``tol``
    (a tensor or float). Returns the max abs error."""
    import torch

    got = got.double()
    want = want.double()
    err = (got - want).abs()
    ok = bool(torch.all(err <= tol)) and bool(torch.isfinite(got).all())
    worst = float(err.max()) if err.numel() else 0.0
    require(ok, f"{name}: max abs err {worst:.3e} beyond tolerance")
    return worst


def equal(name: str, got, want) -> None:
    require(bool((got == want).all()),
            f"{name}: kernel {got.tolist()} != plain {want.tolist()}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the flagship shapes.

def phase_kernels(records: dict) -> None:
    """f32 outputs are held against the plain version at 1e-5 * (1 + |x|)
    (another summation order of up to L products). The f64 vectors are
    held, at 1e-12 relative, against the f64 formula applied to the
    kernel's own f32 operands: the kernel must round as that formula
    does, so one that carried a vector in f32 would miss by ~1e-7
    relative and fail."""
    import torch

    from simplex_tpu_torch.kernels import blocked as kb
    from simplex_tpu_torch.tableau import tt_matvec

    dev = torch.device("cuda")
    M, R, L = 8192, 24576, 128
    eps = 1e-4
    g = torch.Generator(device=dev).manual_seed(20261016)

    def uni(shape, lo, hi, dtype=torch.float32):
        x = torch.rand(shape, generator=g, device=dev, dtype=dtype)
        return x * (hi - lo) + lo

    Tt = uni((M, R), -1.0, 1.0)
    b = uni((M,), 0.0, 100.0, torch.float64)
    costs0 = uni((R,), -1.0, 1.0, torch.float64)
    w0 = uni((R,), 1.0, 2.0)
    base0 = torch.randint(0, R, (M,), generator=g, device=dev,
                          dtype=torch.int32)
    h = torch.tensor(12345, dtype=torch.int32, device=dev)
    errs = {name: 0.0 for name in KERNELS}
    times = {name: [] for name in KERNELS}
    for t in (0, 37, 127):
        C = uni((L, R), -1.0, 1.0)
        F = uni((L, M), -0.1, 0.1)
        C[t:] = 0.0
        F[t:] = 0.0
        # ---- K1 ----
        got = kb.ah_ratio(Tt, F, C, b, h, t, eps)
        want = kb.ah_ratio_plain(Tt, F, C, b, h, t, eps)
        # f32 a_h: the eta correction sums t products in another order.
        errs["ah_ratio"] = max(errs["ah_ratio"], close(
            f"K1 a_h t={t}", got[0], want[0], 1e-5 * (1 + want[0].abs())))
        equal(f"K1 k t={t}", got[1], want[1])
        equal(f"K1 unbounded t={t}", got[4], want[4])
        require(int(got[4]) == 0, "K1 found no eligible row")
        # p and bk are the kernel's own a_h[k] and b[k], exactly.
        equal(f"K1 p t={t}", got[2], got[0][got[1].long()])
        equal(f"K1 bk t={t}", got[3], b[got[1].long()])
        if t == 37:
            times["ah_ratio"] = [
                device_ms(lambda: kb.ah_ratio(Tt, F, C, b, h, t, eps), 50),
                device_ms(lambda: kb.ah_ratio_plain(Tt, F, C, b, h, t, eps),
                        50)]
        # ---- K2 (devex and Dantzig) ----
        ah, k, p, bk = got[0], got[1], got[2], got[3]
        u = torch.tensor(-0.5, dtype=torch.float64, device=dev) / p.double()
        do = torch.tensor(True, device=dev)
        for rule, w in (("devex", w0), ("dantzig", None)):
            outs = []
            for fn in (kb.colk_costs, kb.colk_costs_plain):
                st = dict(C=C.clone(), F=F.clone(), costs=costs0.clone(),
                          b=b.clone(), base=base0.clone(),
                          w=None if w is None else w.clone())
                cand = fn(Tt, st["C"], st["F"], st["costs"], k, t, u, do,
                          R - 100, eps, ah, st["b"], st["base"], h, p, bk,
                          st["w"])
                outs.append((st, cand))
            (sk, ck), (sp, cp) = outs
            tag = f"K2 {rule} t={t}"
            # f32 pivot row: another summation order of t products.
            e = close(f"{tag} C[t]", sk["C"][t], sp["C"][t],
                      1e-5 * (1 + sp["C"][t].abs()))
            equal(f"{tag} C rows < t", sk["C"][:t], sp["C"][:t])
            # costs -= u * colk in f64, on the kernel's own pivot row.
            costs_x = costs0 - u * sk["C"][t].double()
            e = max(e, close(f"{tag} costs", sk["costs"], costs_x,
                             1e-12 * (1 + costs_x.abs())))
            # b and the eta row: the same f64 / f32 operations on the
            # same inputs as the plain version.
            e = max(e, close(f"{tag} b", sk["b"], sp["b"],
                             1e-12 * (1 + sp["b"].abs())))
            e = max(e, close(f"{tag} F[t]", sk["F"][t], sp["F"][t],
                             1e-6 * (1 + sp["F"][t].abs())))
            equal(f"{tag} base", sk["base"], sp["base"])
            if w is not None:
                # f32 weights from alpha = colk / p: the C[t] bound, squared.
                e = max(e, close(f"{tag} w", sk["w"], sp["w"],
                                 1e-4 * (1 + sp["w"].abs())))
            # Candidates: the same columns as the plain version, and the
            # exact fold of the kernel's own costs and weights.
            own = kb.entering_candidates(sk["costs"], sk["w"], R - 100, eps)
            for i, nm in enumerate(("h_d", "v_d", "h_b", "v_b")):
                equal(f"{tag} {nm}", ck[i], own[i])
                if i % 2 == 0:
                    equal(f"{tag} {nm} vs plain", ck[i], cp[i])
            errs["colk_costs"] = max(errs["colk_costs"], e)
            if t == 37 and rule == "devex":
                st = dict(C=C.clone(), F=F.clone(), costs=costs0.clone(),
                          b=b.clone(), base=base0.clone(), w=w0.clone())
                args = (Tt, st["C"], st["F"], st["costs"], k, t, u, do,
                        R - 100, eps, ah, st["b"], st["base"], h, p, bk,
                        st["w"])
                times["colk_costs"] = [
                    device_ms(lambda: kb.colk_costs(*args), 50),
                    device_ms(lambda: kb.colk_costs_plain(*args), 50)]
        # ---- K3 / K4 (full window: every eta row live) ----
        if t == 127:
            C = uni((L, R), -1.0, 1.0)
            F = uni((L, M), -0.1, 0.1)
            coeffs = uni((M,), -1.0, 1.0, torch.float64)
            Tk, Tp = Tt.clone(), Tt.clone()
            mv_k = kb.apply_reprice(Tk, C, F, coeffs)
            kb.apply_reprice_plain(Tp, C, F, coeffs)
            # f32 apply: L products summed in another order.
            tol_T = 1e-5 * (1 + Tp.abs())
            e = close("K3 Tt", Tk, Tp, tol_T)
            # mv = coeffs @ Tt_new in f64 over the kernel's own Tt: only
            # the f64 summation order differs, whose error stays below
            # M * 2^-53 = 9e-13 of sum |coeffs * Tt|.
            scale = tt_matvec(Tk.abs(), coeffs.abs())
            e = max(e, close("K3 mv", mv_k, tt_matvec(Tk, coeffs),
                             1e-12 * scale))
            errs["apply_reprice"] = e
            Tk, Tp = Tt.clone(), Tt.clone()
            kb.apply_window(Tk, C, F)
            kb.apply_window_plain(Tp, C, F)
            errs["apply_window"] = close("K4 Tt", Tk, Tp, tol_T)
            del Tk, Tp
            T2 = Tt.clone()
            times["apply_reprice"] = [
                device_ms(lambda: kb.apply_reprice(T2, C, F, coeffs), 5),
                device_ms(lambda: kb.apply_reprice_plain(T2, C, F, coeffs),
                          5)]
            times["apply_window"] = [
                device_ms(lambda: kb.apply_window(T2, C, F), 5),
                device_ms(lambda: kb.apply_window_plain(T2, C, F), 5)]
            del T2
    for name, (kid, _) in KERNELS.items():
        ms, plain_ms = times[name]
        records[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms}
        log(f"{kid} {name}: matches plain (max abs err {errs[name]:.3e}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


# ---------------------------------------------------------------------------
# Phases 3-5: solves through the public entry point.

def timed_solve(problem):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve(problem, device="cuda", **PROD)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_goldens() -> None:
    import numpy as np

    import simplex_tpu_torch as st

    res, _ = timed_solve(st.read_problem(DATA / "smallProblem.txt"))
    require(res.status == st.Status.OPTIMAL
            and abs(res.objective - 64.0) < 1e-9
            and np.allclose(res.x, [8.0, 0.0, 0.0], atol=1e-9),
            f"smallProblem: {res.status!r} {res.objective} {res.x}")
    res, _ = timed_solve(st.read_problem(DATA / "infeasibleProblem.txt"))
    require(res.status == st.Status.INFEASIBLE,
            f"infeasibleProblem: {res.status!r}")
    res, _ = timed_solve(st.read_problem(DATA / "unboundedProblem.txt"))
    require(res.status == st.Status.UNBOUNDED,
            f"unboundedProblem: {res.status!r}")
    log("goldens: smallProblem OPTIMAL 64 at (8,0,0), infeasibleProblem "
        "INFEASIBLE, unboundedProblem UNBOUNDED")


def check_certified(label: str, res, want: float) -> None:
    import numpy as np

    import simplex_tpu_torch as st

    require(res.status == st.Status.OPTIMAL, f"{label}: {res.status!r}")
    require(res.refine is not None and res.refine.certified,
            f"{label}: not certified ({res.refine})")
    rel = abs(res.objective - want) / abs(want)
    require(rel <= 1e-9, f"{label}: objective {res.objective!r} vs "
            f"{want!r} (rel {rel:.2e})")
    require(np.isfinite(res.x).all() and res.x.shape[0] > 0,
            f"{label}: bad x")


def phase_r1024() -> None:
    import simplex_tpu_torch as st

    p = st.read_random_problem(DATA / "benchmark_problems"
                               / "random_1024_1024.txt")
    res, wall = timed_solve(p)
    check_certified("random_1024_1024", res, OBJ_1024)
    log(f"random_1024_1024: OPTIMAL certified objective {res.objective!r} "
        f"pivots {res.iterations_phase1}+{res.iterations_phase2} "
        f"refine {res.refine.method} wall {wall:.3f} s")


def phase_flagship(launches: dict) -> None:
    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import blocked as kb

    t0 = time.perf_counter()
    p = st.read_random_problem(DATA / "benchmark_problems"
                               / "random_8192_8192.txt")
    log(f"flagship 8192x8192 regenerated in "
        f"{time.perf_counter() - t0:.1f} s")
    kb.reset_launches()
    res, wall = timed_solve(p)
    launches.update(kb.LAUNCHES)
    check_certified("random_8192_8192", res, OBJ_8192)
    walk = (res.iterations_phase1, res.iterations_phase2)
    pivots = sum(walk)
    log(f"flagship random_8192_8192: OPTIMAL certified objective "
        f"{res.objective!r} (golden {OBJ_8192!r}); pivots "
        f"{walk[0]}+{walk[1]}; refine {res.refine.method}; wall "
        f"{wall:.3f} s; {1e3 * wall / pivots:.4f} ms/pivot; launches "
        f"{launches}")
    # K4 takes the off-cadence windows (reprice_every=2), so all four run.
    for name in KERNELS:
        require(launches[name] > 0, f"{name} never launched on the path")
    warm = []
    for i in range(1, FLAGSHIP_SOLVES):
        res, wall = timed_solve(p)
        check_certified("random_8192_8192", res, OBJ_8192)
        again = (res.iterations_phase1, res.iterations_phase2)
        require(again == walk, f"flagship solve {i + 1} walked {again}, "
                f"the first {walk}")
        warm.append(wall)
        log(f"flagship warm solve {i}: wall {wall:.3f} s")
    median = statistics.median(warm)
    log(f"flagship warm solves: {len(warm)}, wall min {min(warm):.3f} "
        f"median {median:.3f} max {max(warm):.3f} s; median "
        f"{1e3 * median / pivots:.4f} ms/pivot")


def phase_northstar() -> None:
    import torch

    from simplex_tpu_torch.config import SolverOptions
    from simplex_tpu_torch.solver import run_solve_loop
    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    n, m, cap = 100_000, 10_000, 256
    dev = torch.device("cuda")
    opts = SolverOptions(**PROD)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(n * 100 + m)
    A = torch.rand((m, n), generator=g, device=dev) * 99.0 + 1.0
    b = torch.rand((m,), generator=g, device=dev) * 99.0 + 1.0
    tab = build_phase1(A, b, n, m, opts)
    del A
    costs0 = tab.costs
    tab = gaussian_eliminate(tab)
    gb = tab.Tt.numel() * 4 / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab, status, iters = run_solve_loop(tab, opts, cap, costs0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(iters == cap, f"north-star: {iters} pivots, want {cap}")
    require(bool(torch.isfinite(tab.z)), "north-star: z not finite")
    log(f"north-star 10000x100000: tableau {tuple(tab.Tt.shape)} "
        f"({gb:.2f} GB f32); {iters} pivots in {wall:.3f} s = "
        f"{1e3 * wall / iters:.4f} ms/pivot; status {status}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    try:
        import simplex_tpu_torch  # noqa: F401
        from simplex_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{lib_path.name}")

    records: dict = {}
    launches = {name: 0 for name in KERNELS}
    try:
        phase_goldens()
        phase_r1024()
        phase_flagship(launches)
        phase_northstar()
        phase_kernels(records)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (kid, replaces) in KERNELS.items():
        rec = records.get(name, {})
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": SOURCE, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": rec.get("max_abs_err"),
                        "ms": rec.get("ms"),
                        "plain_ms": rec.get("plain_ms")})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
