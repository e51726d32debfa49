"""Measure the f64 refinement stage of a flagship-class mixed solve.

Port of the JAX package's ``tools/measure_refine_flagship.py``, with its
command line and its output, run as::

    python -m simplex_tpu_torch.measure_refine_flagship    # on the card
    python -m simplex_tpu_torch.measure_refine_flagship --vars 100000
    python -m simplex_tpu_torch.measure_refine_flagship --device cpu \\
        --vars 1024 --constraints 256                      # plain versions

What does certifying a mixed-precision flagship-class solve to f64 cost
on top of the solve itself? The instance is drawn on the device in f32,
uniform in [1, 100), from ``torch.Generator(device).manual_seed(n*100 +
m)``: A and b as ``bench.bench_problem`` draws them, then c. That is the
seed of the JAX tool, not its stream (threefry there, the device's
Philox here). b and c are cast to f64; the refinement casts A to f64
itself, so it certifies against the f32-representable problem that is
solved. At ``--vars 100000`` the instance is the whole north-star LP.

Reported on stderr, each on its own line: the mixed solve
(``two_phase.solve_device_with_binv``: status, pivots, wall), which must
end OPTIMAL; the tableau-preconditioned refinement
(``refine.refine_solution_tableau``) timed cold and warm; its
certificates at 1e-6 (``certificates_pass``) and at 1e-9 with the dual
infeasibility against ``1 + max|c| + max|y|``; the raw and refined
objectives; and the peak device memory (``torch.cuda.
max_memory_allocated``). When the certificates fail at 1e-6, the
production finishing tier is measured at this scale: the device-to-host
copy of A on its own, then ``finish.finish_from_basis`` from the final
basis (the warm f64 finish on the host). The last line on stdout is
``REFINE_FLAGSHIP_OK <warm seconds>``. The device is the card unless
``--device cpu`` is given; without a card that raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .bench import card_label, log, synchronize
from .config import SolverOptions, Status
from .refine import certificates_pass, refine_solution_tableau
from .two_phase import resolve_device, solve_device_with_binv


def flagship_instance(n: int, m: int, device):
    """A (m, n), b (m,) and c (n,), f32 uniform in [1, 100) on
    ``device``, drawn in that order from one generator seeded ``n * 100 +
    m``."""
    g = torch.Generator(device=device).manual_seed(n * 100 + m)

    def uniform(shape):
        return torch.rand(shape, generator=g, device=device) * 99.0 + 1.0

    return uniform((m, n)), uniform((m,)), uniform((n,))


def strong_certified(ro, b, c) -> bool:
    """Every certificate at 1e-9 relative, the dual infeasibility against
    ``1 + max|c| + max|y|`` (``tools/measure_refine_flagship.py:90-96``)."""
    b_scale = 1.0 + float(np.max(np.abs(b)))
    d_scale = (1.0 + float(np.max(np.abs(c)))
               + float(ro.y.abs().max()))
    return (float(ro.primal_residual) <= 1e-9 * b_scale
            and float(ro.dual_infeasibility) <= 1e-9 * d_scale
            and float(ro.primal_negativity) <= 1e-9 * b_scale
            and float(ro.artificial_mass) <= 1e-9 * b_scale)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m simplex_tpu_torch.measure_refine_flagship",
        description="the f64 refinement's cost on a flagship-class mixed "
                    "solve, with its certificates")
    ap.add_argument("--vars", type=int, default=50_000)
    ap.add_argument("--constraints", type=int, default=10_000)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    n, m = args.vars, args.constraints
    options = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                            block_pivots=args.block)
    log(f"device: {dev} ({card_label(dev)})  "
        f"rule={options.pivot_rule_resolved}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    A, b, c = flagship_instance(n, m, dev)
    b64 = b.double()
    c64 = c.double()
    del b, c
    synchronize(dev)
    log(f"on-device instance {m} x {n} built")

    t0 = time.perf_counter()
    out, binv = solve_device_with_binv(A, b64, c64, n, m, options)
    synchronize(dev)
    solve_s = time.perf_counter() - t0
    p1, p2 = out.iterations_phase1, out.iterations_phase2
    log(f"mixed solve: status={int(out.status)} pivots={p1}+{p2} "
        f"wall={solve_s:.2f}s (includes the kernels' first use)")
    if out.status != Status.OPTIMAL:
        raise RuntimeError(f"mixed solve ended {out.status!r}, not OPTIMAL")

    raw_obj = out.objective
    t0 = time.perf_counter()
    ro = refine_solution_tableau(A, b64, c64, out.base, binv, n=n, m=m)
    synchronize(dev)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ro = refine_solution_tableau(A, b64, c64, out.base, binv, n=n, m=m)
    synchronize(dev)
    warm_s = time.perf_counter() - t0

    b_host = b64.cpu().numpy()
    c_host = c64.cpu().numpy()
    ok = certificates_pass(ro, b_host, c_host, 1e-6)
    strong = strong_certified(ro, b_host, c_host)
    log(f"refine(tableau): cold={cold_s:.2f}s warm={warm_s:.2f}s "
        f"({warm_s / solve_s * 100:.1f}% of the solve wall)")
    log(f"certificates: pass@1e-6={ok} pass@1e-9={strong} "
        f"primal_res={float(ro.primal_residual):.2e} "
        f"dual_inf={float(ro.dual_infeasibility):.2e} "
        f"neg={float(ro.primal_negativity):.2e} "
        f"art={float(ro.artificial_mass):.2e}")
    log(f"objective: raw={raw_obj:.9f} refined={float(ro.objective):.9f} "
        f"shift={float(ro.objective) - raw_obj:+.2e}")
    if dev.type == "cuda":
        log(f"peak device memory: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")

    if not ok:
        # The production finishing tier at this scale: the copy of A to
        # the host, then the warm f64 finish from the drifted basis.
        from .finish import finish_from_basis
        from .problem import Problem

        t0 = time.perf_counter()
        problem = Problem(A=A.cpu().numpy(), b=b_host, c=c_host)
        xfer_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fin = finish_from_basis(problem, out.base.cpu().numpy(), options)
        fin_s = time.perf_counter() - t0
        if fin is None:
            log(f"warm finish: not applicable (transfer {xfer_s:.1f}s)")
        else:
            gap = fin.objective - float(ro.objective)
            log(f"warm finish: {fin.status.name} in "
                f"{fin.iterations_phase2} finishing pivots, "
                f"{fin_s:.1f}s (+{xfer_s:.1f}s A device->host); "
                f"objective {fin.objective:.9f} "
                f"(drifted basis was {gap:+.2e} below optimum)")
    print("REFINE_FLAGSHIP_OK", warm_s, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
