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
6. the batched path (``solve_batch(..., device="cuda")``, BASELINE.json
   config 3's options: f32 tableau, f64 vectors, eps 1e-5, L=32, devex):
   the status spread (OPTIMAL 13, UNBOUNDED, INFEASIBLE); config 3 at
   full size, 256 x (m=500, n=2,000) from seeds 1000..1255, every lane
   OPTIMAL and certified, lanes 0, 127 and 255 equal to a batch of that
   lane alone and within 1e-9 of the single-LP ``solve`` -- the batched
   main path, with the K7-K10 launch counters reset just before its
   first call and read just after; then a warm call; then 32 x (m=500,
   n=14,000) lanes from seeds 2000..2031 (the TPU's HBM-tier shape);
7. each kernel K1-K4 against its plain PyTorch version on the card at
   the flagship shapes (M=8192, R=24576, L=128, t in {0, 37, 127}; K2
   under devex and Dantzig), then the batched kernels at config 3's
   shapes (B=256, M=512, R=3072, L=32) and the wide ones (B=32, R=15104),
   under devex and Dantzig, with a frozen lane and a lane that hits its
   fuse mid-window; all timed on the device by torch.profiler; then one
   config-3 batch traced (device time by kernel, the device's busy
   share). These run last so that no profiler session precedes the
   timed solves.

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' records, and ``{"ok": true, "device": {...}}``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
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

#: BASELINE.json config 3's options (tools/bench_batch.py:43-75).
BATCH = dict(dtype="float32", vector_dtype="float64", eps=1e-5,
             block_pivots=32)
#: (n, m, seeds): config 3, and the lanes the TPU served from HBM.
CONFIG3 = (2000, 500, range(1000, 1256))
WIDE = (14000, 500, range(2000, 2032))
#: The batched kernels, the JAX kernels each replaces (K7 is
#: batch_window's pivot loop followed by batch_apply_reprice's fused
#: apply and fold), and their source.
BATCH_KERNELS = {
    "batch_window": ("K7/K8", "simplex_tpu/kernels/batched.py:521; "
                     "simplex_tpu/kernels/batched_hbm.py:330"),
    "batch_apply_reprice": ("K7/K9", "simplex_tpu/kernels/batched.py:521; "
                            "simplex_tpu/kernels/batched_hbm.py:214"),
    "batch_apply": ("K10", "simplex_tpu/kernels/batched_hbm.py:281"),
}
BATCH_SOURCE = "simplex_tpu_torch/kernels/csrc/batched.cu"
#: (label, (B, M, R, L)) of the batched kernels' check.
BATCH_KERNEL_SHAPES = (("config-3", (256, 512, 3072, 32)),
                       ("wide", (32, 512, 15104, 32)))


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


def device_ms(fn, reps: int, match: str | None = None) -> float:
    """Device ms per call of ``fn()``: the summed durations of the kernels
    it launches, traced by torch.profiler (CUPTI) over ``reps`` calls
    after one warm-up call; with ``match``, only the kernels whose name
    holds it (leaving out the copies that reset a state between calls).
    The host's launch rate is left out: at these shapes one call of a
    per-pivot pass runs for microseconds, less than the host takes to
    enqueue it."""
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
                   if e.device_type == DeviceType.CUDA
                   and (match is None or match in e.key))
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
    import torch

    bad = got != want
    if bool(bad.any()):
        first = tuple(torch.nonzero(bad)[0].tolist())
        raise SmokeFailure(
            f"{name}: {int(bad.sum())} of {bad.numel()} differ; first at "
            f"{first}: kernel {got[first].tolist()} != plain "
            f"{want[first].tolist()}")


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


WINDOW_ARGS = ("costs", "b", "z", "base", "w", "sci", "c0", "cf", "C", "F",
               "AH", "piv", "nlive")


def window_state(B: int, M: int, R: int, L: int, devex: bool, g):
    """A seeded window state on the card: Tt (B*M, R) uniform in (-1, 1),
    costs uniform in (-1, 0.5) (many eligible columns), b in (0.1, 1),
    distinct basic columns; lane 1 frozen (OPTIMAL), lane 2 with its fuse
    5 pivots away, every other lane RUNNING with room for L pivots."""
    import torch

    from simplex_tpu_torch.config import Status

    dev = torch.device("cuda")

    def uni(shape, lo, hi, dtype=torch.float64):
        x = torch.rand(shape, generator=g, device=dev, dtype=dtype)
        return x * (hi - lo) + lo

    r = R - 5
    Tt = uni((B * M, R), -1.0, 1.0, torch.float32)
    base = torch.argsort(torch.rand((B, R), generator=g, device=dev),
                         dim=1)[:, :M].to(torch.int32)
    c0 = uni((B, R), -1.0, 1.0)
    picked = c0.gather(1, base.long())
    sci = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    sci[:, 0] = int(Status.RUNNING)
    sci[1, 0] = int(Status.OPTIMAL)
    sci[:, 5] = 10 ** 6
    sci[2, 5] = 5
    sci[:, 4] = (sci[:, 0] == int(Status.RUNNING)).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    st = dict(costs=uni((B, R), -1.0, 0.5), b=uni((B, M), 0.1, 1.0),
              z=uni((B,), -1.0, 1.0), base=base,
              w=uni((B, R), 1.0, 2.0, torch.float32) if devex else None,
              sci=sci, c0=c0,
              cf=torch.where(base < r, picked, torch.zeros_like(picked)),
              C=torch.empty((B * L, R), **f32),
              F=torch.empty((B * L, M), **f32),
              AH=torch.empty((B * L, M), **f32),
              piv=torch.empty((B * L, 2), dtype=torch.int32, device=dev),
              nlive=torch.empty(B, dtype=torch.int32, device=dev))
    return Tt, st, r


def window_against_replay(tag: str, Tt, st0: dict, sk: dict, B: int,
                          L: int) -> float:
    """A window's outputs against its formulas on its own f32 operands
    (``window_replay``): the pivot rows C and entering columns AH to
    1e-5 of their terms' summed magnitudes (the f32 eta correction, t
    products, in another order than the f64 replay); the eta rows F and
    the devex weights to 1e-6 * (1 + |x|) (the same f32 operations on
    the same operands); the f64 vectors to 1e-12 * (1 + |x|); base and
    cf equal. Returns the max abs error."""
    from simplex_tpu_torch.kernels import batched as kbt

    rep = kbt.window_replay(Tt, st0, sk["C"], sk["F"], sk["AH"], sk["piv"],
                            sk["nlive"])
    e = 0.0
    for name in ("C", "AH"):
        got = sk[name].view(B, L, -1)
        e = max(e, close(f"{tag} {name}", got, rep[name],
                         1e-5 * (1 + rep[name + "_terms"])))
    e = max(e, close(f"{tag} F", sk["F"].view(B, L, -1), rep["F"],
                     1e-6 * (1 + rep["F"].abs())))
    names = ("costs", "b", "z") + (("w",) if sk["w"] is not None else ())
    for name in names:
        tol = (1e-6 if name == "w" else 1e-12) * (1 + rep[name].abs())
        e = max(e, close(f"{tag} {name}", sk[name], rep[name], tol))
    equal(f"{tag} replayed base", sk["base"], rep["base"])
    equal(f"{tag} replayed cf", sk["cf"], rep["cf"])
    return e


def phase_batch_kernels(records: dict) -> None:
    """The batched kernels against their plain versions on the card, on
    the same state: the integer outputs (the walk piv, base, sci, nlive)
    equal, and each output against its formula on the kernel's own
    operands (window_against_replay) -- the plain version's f32 rows
    drift from the kernel's along the walk, since each row builds on the
    earlier ones. The apply: Tt to 1e-5 * (1 + |x| + |F|^T |C|) of the
    plain version on the same etas (another summation order of L
    products), the reprice mv to 1e-12 relative of cf @ Tt_new in f64
    on the kernel's own tableau -- an f32 accumulation would miss by
    ~1e-7 -- and a frozen lane's tableau bit-identical. Times at config
    3's shapes go into the kernels' records; the wide shape's are
    printed."""
    import torch

    from simplex_tpu_torch.kernels import batched as kbt
    from simplex_tpu_torch.tableau import batch_tt_matvec

    g = torch.Generator(device="cuda").manual_seed(20261017)
    errs = {name: 0.0 for name in BATCH_KERNELS}
    for label, (B, M, R, L) in BATCH_KERNEL_SHAPES:
        times = {}
        for devex in (True, False):
            rule = "devex" if devex else "dantzig"
            tag = f"{label} {rule}"
            Tt, st0, r = window_state(B, M, R, L, devex, g)
            kw = dict(r=r, eps=1e-5, bland_static=False, threshold=50)
            runs = []
            for fn in (kbt.batch_window, kbt.batch_window_plain):
                st = {k: None if v is None else v.clone()
                      for k, v in st0.items()}
                fn(Tt, *(st[k] for k in WINDOW_ARGS), **kw)
                runs.append(st)
            sk, sp = runs
            for name in ("piv", "base", "sci", "nlive"):
                equal(f"batch_window {tag} {name}", sk[name], sp[name])
            nlive = sk["nlive"].tolist()
            require(nlive[1] == 0 and nlive[2] == 5 and nlive[0] == L,
                    f"batch_window {tag}: nlive {nlive[:3]}")
            e = window_against_replay(f"batch_window {tag}", Tt, st0, sk,
                                      B, L)
            errs["batch_window"] = max(errs["batch_window"], e)

            # K9 / K10 on the kernel's etas; lane 3 does not re-price.
            do_r = torch.ones(B, dtype=torch.int32, device="cuda")
            do_r[3] = 0
            frozen = slice(M, 2 * M)
            Tk, Tp = Tt.clone(), Tt.clone()
            mv = kbt.batch_apply_reprice(Tk, sk["C"], sk["F"], sk["cf"],
                                         do_r, sk["nlive"])
            kbt.batch_apply_reprice_plain(Tp, sk["C"], sk["F"], sk["cf"],
                                          do_r, sk["nlive"])
            terms = torch.bmm(sk["F"].view(B, L, M).abs().transpose(1, 2),
                              sk["C"].view(B, L, R).abs()).view(B * M, R)
            e = close(f"batch_apply_reprice {tag} Tt", Tk, Tp,
                      1e-5 * (1 + Tp.abs() + terms))
            require(torch.equal(Tk[frozen], Tt[frozen]),
                    f"batch_apply_reprice {tag}: the frozen lane changed")
            T3 = Tk.view(B, M, R)
            scale = batch_tt_matvec(T3.abs(), sk["cf"].abs())
            want_mv = torch.where(do_r[:, None] != 0,
                                  batch_tt_matvec(T3, sk["cf"]), 0.0)
            e = max(e, close(f"batch_apply_reprice {tag} mv", mv, want_mv,
                             1e-12 * scale))
            require(not mv[3].any(), "batch_apply_reprice: do_r=0 lane")
            errs["batch_apply_reprice"] = max(errs["batch_apply_reprice"], e)
            del Tp
            Tk.copy_(Tt)
            Tp = Tt.clone()
            kbt.batch_apply(Tk, sk["C"], sk["F"], sk["nlive"])
            kbt.batch_apply_plain(Tp, sk["C"], sk["F"], sk["nlive"])
            errs["batch_apply"] = max(errs["batch_apply"], close(
                f"batch_apply {tag} Tt", Tk, Tp,
                1e-5 * (1 + Tp.abs() + terms)))
            require(torch.equal(Tk[frozen], Tt[frozen]),
                    f"batch_apply {tag}: the frozen lane changed")
            del Tp, terms
            if devex:
                # Each timed call starts from the same state (the copies
                # that reset it are left out of the kernel's time).
                st = {k: None if v is None else v.clone()
                      for k, v in st0.items()}

                def window(fn, st=st):
                    for k in ("costs", "b", "z", "base", "w", "sci", "cf"):
                        st[k].copy_(st0[k])
                    fn(Tt, *(st[k] for k in WINDOW_ARGS), **kw)

                C, F, cf, nl = sk["C"], sk["F"], sk["cf"], sk["nlive"]
                times = {
                    "batch_window": [
                        device_ms(lambda: window(kbt.batch_window), 5,
                                  "batch_window"),
                        device_ms(lambda: window(kbt.batch_window_plain),
                                  2)],
                    "batch_apply_reprice": [
                        device_ms(lambda: kbt.batch_apply_reprice(
                            Tk, C, F, cf, do_r, nl), 5),
                        device_ms(lambda: kbt.batch_apply_reprice_plain(
                            Tk, C, F, cf, do_r, nl), 5)],
                    "batch_apply": [
                        device_ms(lambda: kbt.batch_apply(Tk, C, F, nl), 5),
                        device_ms(lambda: kbt.batch_apply_plain(Tk, C, F,
                                                                nl), 5)]}
            del Tk, Tt, st0, sk, sp
            torch.cuda.empty_cache()
        for name, (kid, _) in BATCH_KERNELS.items():
            ms, plain_ms = times[name]
            if label == BATCH_KERNEL_SHAPES[0][0]:
                records[name] = {"max_abs_err": errs[name], "ms": ms,
                                 "plain_ms": plain_ms}
            log(f"{kid} {name} {label} B={B} M={M} R={R} L={L}: matches "
                f"plain (max abs err so far {errs[name]:.3e}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    for name in BATCH_KERNELS:
        records[name]["max_abs_err"] = errs[name]


# ---------------------------------------------------------------------------
# Phases 3-5: solves through the public entry point.

def phase_batch_trace() -> None:
    """One config-3 ``solve_batch`` under torch.profiler (CUDA activity):
    the device time by kernel, and the device's busy share of the traced
    device solve (stats ``device_s``) and of the whole call. Runs after
    every timed solve."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import simplex_tpu_torch as st

    n, m, seeds = CONFIG3
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    stats: dict = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed_batch(problems, stats)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    copy_s = sum(r[0] for r in rows if r[2].startswith("Memcpy")) / 1e6
    kernel_s = sum(r[0] for r in rows) / 1e6 - copy_s
    require(kernel_s > 0, "the trace saw no kernel time")
    log(f"config 3 traced: wall {wall:.3f} s (data to the card "
        f"{stats['prepare_s']:.3f} s, device solve {stats['device_s']:.3f}"
        f" s, host refinement {stats['refine_s']:.3f} s); kernels busy "
        f"{kernel_s:.3f} s = {100 * kernel_s / stats['device_s']:.1f}% of "
        f"the device solve ({sum(r[1] for r in rows)} launches and "
        f"copies); copies {copy_s:.3f} s")
    for us, count, key in rows[:8]:
        log(f"  {us / 1e3:10.3f} ms {count:6d} x {key[:90]}")


def timed_solve(problem, opts: dict = PROD):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve(problem, device="cuda", **opts)
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


def timed_batch(problems, stats: dict):
    import torch

    import simplex_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = st.solve_batch(problems, device="cuda", stats=stats, **BATCH)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_batch_spread() -> None:
    import numpy as np

    import simplex_tpu_torch as st

    spread = [st.Problem(A=np.array(A), b=np.array(b), c=np.array(c))
              for A, b, c in (
                  ([[1.0, 0.0], [0.0, 1.0]], [1.0, 2.0], [3.0, 5.0]),
                  ([[1.0, 0.0], [1.0, 0.0]], [1.0, 2.0], [1.0, 1.0]),
                  ([[-1.0, 0.0], [1.0, 0.0]], [-1.0, 0.5], [1.0, 0.0]))]
    res, _ = timed_batch(spread, {})
    got = [r.status for r in res]
    require(got == [st.Status.OPTIMAL, st.Status.UNBOUNDED,
                    st.Status.INFEASIBLE], f"batch spread: {got}")
    require(abs(res[0].objective - 13.0) <= 1e-12 and res[0].refine.certified,
            f"batch spread: objective {res[0].objective!r}")
    log("batch spread: OPTIMAL 13 (certified), UNBOUNDED, INFEASIBLE")


def phase_batch(label: str, shape, launches: dict | None = None,
                lanes=()) -> None:
    """One batch through ``solve_batch`` twice (first and warm call): every
    lane OPTIMAL and certified, the same walks both times; ``lanes``
    checked against a batch of that lane alone (walk, basis, objective
    bit for bit) and against the single-LP ``solve`` (1e-9). With
    ``launches``, the K7-K10 counters of the first call."""
    import numpy as np
    import torch

    import simplex_tpu_torch as st
    from simplex_tpu_torch.kernels import batched as kbt

    n, m, seeds = shape
    t0 = time.perf_counter()
    problems = [st.generate_random_problem(n, m, s, 1, 100) for s in seeds]
    log(f"{label}: {len(problems)} x (m={m}, n={n}) generated in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    kbt.reset_launches()
    first_stats = {}
    res, first = timed_batch(problems, first_stats)
    counts = dict(kbt.LAUNCHES)
    if launches is not None:
        launches.update(counts)
    warm_stats = {}
    again, warm = timed_batch(problems, warm_stats)
    for i, r in enumerate(res):
        require(r.status == st.Status.OPTIMAL and r.refine is not None
                and r.refine.certified,
                f"{label} lane {i}: {r.status!r} refine {r.refine}")
        require(np.isfinite(r.x).all() and r.x.shape == (n,),
                f"{label} lane {i}: bad x")
    walks = [(r.iterations_phase1, r.iterations_phase2) for r in res]
    require(walks == [(r.iterations_phase1, r.iterations_phase2)
                      for r in again]
            and [r.objective for r in res] == [r.objective for r in again],
            f"{label}: the warm call walked otherwise")
    pivots = sorted(a + b for a, b in walks)
    methods = sorted(collections.Counter(r.refine.method for r in res)
                     .items())
    log(f"{label}: {len(res)}/{len(res)} OPTIMAL and certified "
        f"(refinement {methods}); wall first "
        f"{first:.3f} s, warm {warm:.3f} s = {1e3 * warm / len(res):.3f} "
        f"ms/instance (data to the card {warm_stats['prepare_s']:.3f} s, "
        f"device solve {warm_stats['device_s']:.3f} s, host refinement "
        f"{warm_stats['refine_s']:.3f} s); windows per phase "
        f"{first_stats['windows']}; pivots per lane min {pivots[0]} median "
        f"{statistics.median(pivots)} max {pivots[-1]}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB; launches {counts}")
    for i in lanes:
        alone_stats = {}
        (alone,), _ = timed_batch([problems[i]], alone_stats)
        r = res[i]
        require((alone.iterations_phase1, alone.iterations_phase2)
                == walks[i] and alone.objective == r.objective
                and np.array_equal(alone_stats["bases"][0],
                                   first_stats["bases"][i]),
                f"{label} lane {i}: the batch of one walked "
                f"{(alone.iterations_phase1, alone.iterations_phase2)} to "
                f"{alone.objective!r}, the batch {walks[i]} to "
                f"{r.objective!r}")
        single, wall = timed_solve(problems[i], BATCH)
        rel = abs(single.objective - r.objective) / abs(r.objective)
        require(single.status == st.Status.OPTIMAL and rel <= 1e-9,
                f"{label} lane {i}: solve() {single.status!r} "
                f"{single.objective!r} vs batch {r.objective!r}")
        log(f"{label} lane {i}: equals its batch of one ({walks[i]} pivots,"
            f" objective {r.objective!r}); single-LP solve "
            f"{single.objective!r} (rel {rel:.1e}, "
            f"{single.iterations_phase1}+{single.iterations_phase2} pivots,"
            f" {wall:.3f} s)")


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
    batch_launches = {name: 0 for name in BATCH_KERNELS}
    try:
        phase_goldens()
        phase_r1024()
        phase_flagship(launches)
        phase_northstar()
        phase_batch_spread()
        phase_batch("config 3", CONFIG3, batch_launches, lanes=(0, 127, 255))
        # Every kernel of the batched path ran in config 3's first call
        # (batch_apply takes the off-cadence windows where no lane ends).
        for name in BATCH_KERNELS:
            require(batch_launches[name] > 0,
                    f"{name} never launched on the batched path")
        phase_batch("wide lanes", WIDE)
        phase_kernels(records)
        phase_batch_kernels(records)
        phase_batch_trace()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for table, source, counts in ((KERNELS, SOURCE, launches),
                                  (BATCH_KERNELS, BATCH_SOURCE,
                                   batch_launches)):
        for name, (kid, replaces) in table.items():
            rec = records.get(name, {})
            kernels.append({"name": f"{kid} {name}", "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": counts[name],
                            "max_abs_err": rec.get("max_abs_err"),
                            "ms": rec.get("ms"),
                            "plain_ms": rec.get("plain_ms")})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    # count: the one card this script drives.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
