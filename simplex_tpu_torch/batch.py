"""Batched scenario solving: many independent LPs of one shape per call.

Port of ``simplex_tpu.batch`` (BASELINE.json config 3: 256 scenario LPs of
m = 500 x n = 2,000). The lanes' tableaus sit stacked in one
``(B*M_pad, R_pad)`` f32 tensor on the card, and each window of up to L
pivots takes two kernels for the whole batch: ``batch_window`` (one
block per lane runs its L pivots, kernels/batched.py), then
``batch_apply_reprice`` (the apply fused with the window-boundary
reprice, for the lanes on cadence or whose window ended non-RUNNING) or,
when no lane re-prices, ``batch_apply``. The exact-cost merge and the
premature-optimal reopen are torch glue on (B, R) f64 tensors. The host
reads each lane's status, iterations and active flag once per window,
between the window and the apply, and nothing per pivot.

The JAX package has two kernel tiers (VMEM-resident lanes and HBM lanes,
``batch_kernel_tier``) and a vmapped-XLA fallback for the rest. On the
card one kernel design serves both tiers, so every eligible
configuration takes it whatever the lane size; the others take the
batched fallback (``batch_fallback.py``), as ``solve_device_batched``'s
``kernel`` argument dispatches.

The scenario fleet (``mesh=``, a ``torch.distributed`` ProcessGroup)
gives each rank a contiguous block of lanes, solved as above with no
collective at all; the results are gathered once at the end
(``simplex_tpu/batch.py:388-422``).

Every OPTIMAL lane is refined in f64 on the host (NumPy/LAPACK against
the lane's own f64 problem data), as ``simplex_tpu.batch._refine_lane``
does, with the restart rounds and the f64 finishing tier behind it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import (DEFAULT_OPTIONS, EPS_REL_F32, SolverOptions, Status,
                     normalize_enabled, refine_enabled)
from .kernels.batched import batch_apply, batch_apply_reprice, batch_window
from .result import SolveResult
from .tableau import (BatchTableau, batch_basic_costs, batch_build_phase1,
                      batch_count_basic_artificials, batch_extract_solution,
                      batch_gaussian_eliminate, batch_phase1_objective,
                      batch_phase2_reset, padded_dims, round_up)
from .two_phase import pivot_out_artificials, resolve_device

RUNNING = int(Status.RUNNING)


def batch_kernel_dims(n: int, m: int,
                      options: SolverOptions) -> tuple[int, int, int]:
    """(R1_pad, R2_pad, M_pad) of the batched path: the variable axis pads
    to 128 whatever the device."""
    return (round_up(n + 2 * m, 128), round_up(n + m, 128),
            round_up(m, options.lane_pad))


def batch_window_len(options: SolverOptions) -> int:
    """The window length L: ``batch_block_pivots`` when set, else
    ``block_pivots`` clamped to 32 (the f32 eta-correction noise grows
    ~sqrt(L); ``simplex_tpu/batch.py:148-157``)."""
    if options.batch_block_pivots is not None:
        return int(options.batch_block_pivots)
    return min(int(options.block_pivots or 1), 32)


def batch_kernel_eligible(options: SolverOptions) -> bool:
    """Whether the batched kernels take ``options`` (``simplex_tpu.batch.
    batch_kernel_tier`` without its VMEM/HBM fit, one kernel design serving
    both tiers here): an f32 blocked configuration with the kernels not
    switched off, and a window length the kernel takes (a multiple of 8,
    unless ``batch_block_pivots`` sets it)."""
    L = int(options.block_pivots or 1)
    if L <= 1 or np.dtype(options.dtype).itemsize != 4 or not (
            options.use_pallas == "auto" or bool(options.use_pallas)):
        return False
    return options.batch_block_pivots is not None or L % 8 == 0


def check_batch_supported(options: SolverOptions, kernel, mesh) -> None:
    """Raise for arguments the batched solve does not take: a ``kernel``
    other than "auto", True or False (the JAX package's CPU mode
    "interpret" included), ``kernel=True`` for options the kernels refuse,
    and a ``mesh`` that is not a ProcessGroup."""
    if kernel == "interpret":
        raise ValueError("kernel='interpret' is the JAX package's CPU mode; "
                         "the port runs the plain PyTorch versions of its "
                         "kernels with device='cpu'")
    if kernel not in ("auto", True, False):
        raise ValueError(f"kernel must be 'auto', True or False, "
                         f"got {kernel!r}")
    if kernel is True and not batch_kernel_eligible(options):
        raise ValueError(
            "kernel=True forces the batched kernels, which take f32 "
            "blocked configurations with the kernels on and a window that "
            "is a multiple of 8; kernel='auto' sends these options to the "
            "batched fallback")
    if mesh is not None:
        import torch.distributed as dist

        if not isinstance(mesh, dist.ProcessGroup):
            raise TypeError(f"mesh must be a torch.distributed "
                            f"ProcessGroup, got {type(mesh).__name__}")


# ---------------------------------------------------------------------------
# The loop.

@dataclasses.dataclass
class LoopState:
    """The batched loop's state on the device, in the layout of
    ``kernels/batched.py``: the tableau (updated in place), the f64
    vectors, devex weights (None under Dantzig/Bland), the packed
    per-lane integers ``sci``, the original costs ``c0`` and their basic
    column ``cf``, and the window's etas."""

    Tt: torch.Tensor
    costs: torch.Tensor
    b: torch.Tensor
    z: torch.Tensor
    base: torch.Tensor
    w: torch.Tensor | None
    sci: torch.Tensor
    c0: torch.Tensor
    cf: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    AH: torch.Tensor
    piv: torch.Tensor
    nlive: torch.Tensor

    @classmethod
    def start(cls, tabs: BatchTableau, L: int, c0: torch.Tensor,
              devex: bool, max_iter: int, bland_static: bool,
              live: torch.Tensor | None = None) -> "LoopState":
        """The state at the loop's start. Lanes where ``live`` is False
        start INFEASIBLE and never pivot. The etas need no clearing: each
        window writes every row."""
        f64 = torch.float64
        Tt = tabs.Tt
        B, M = tabs.b.shape
        R = Tt.shape[1]
        dev = Tt.device
        c0 = c0.to(f64).contiguous()
        base = tabs.base.to(torch.int32).clone()
        sci = torch.zeros((B, 8), dtype=torch.int32, device=dev)
        sci[:, 0] = RUNNING
        if live is not None:
            sci[:, 0] = torch.where(live, RUNNING, int(Status.INFEASIBLE))
        sci[:, 3] = int(bland_static)
        sci[:, 5] = max_iter
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(
            Tt=Tt, costs=tabs.costs.to(f64).clone(), b=tabs.b.to(f64).clone(),
            z=tabs.z.to(f64).clone(), base=base,
            w=torch.ones((B, R), **f32) if devex else None, sci=sci, c0=c0,
            cf=batch_basic_costs(base, c0, tabs.r).contiguous(),
            C=torch.empty((B * L, R), **f32),
            F=torch.empty((B * L, M), **f32),
            AH=torch.empty((B * L, M), **f32),
            piv=torch.empty((B * L, 2), dtype=torch.int32, device=dev),
            nlive=torch.empty(B, dtype=torch.int32, device=dev))


def window_step(st: LoopState, *, r: int, eps: float, bland_static: bool,
                threshold: int | None, cadence: bool):
    """One window for every lane (the body of
    ``simplex_tpu.batch.solve_loop_batched_kernel``): the lanes RUNNING
    and under their fuse pivot (``batch_window``), the others stay
    frozen; then the host reads each lane's status, iterations and
    whether it was active -- the window's one host read -- and the apply
    follows. An active lane re-prices exactly when ``cadence`` is set or
    its window ended non-RUNNING (``do_r``): ``costs = c0 - cf @ Tt_new``
    (``batch_apply_reprice``), and a lane declared OPTIMAL on in-window
    costs reopens when the exact costs still show an eligible column.
    The same f64 value drives the kernel's optimality test and the reopen
    test. A window in which no lane re-prices takes ``batch_apply``
    alone, as the JAX kernel's fold does nothing when every ``do_r`` is
    0. Devex weights re-anchor to 1 when their max passes 1e8. Updates
    ``st`` in place; returns the host's (status, iterations, active)
    read, taken before any reopen, and whether the window re-priced."""
    sci = st.sci
    sci[:, 4] = ((sci[:, 0] == RUNNING)
                 & (sci[:, 1] < sci[:, 5])).to(torch.int32)
    batch_window(st.Tt, st.costs, st.b, st.z, st.base, st.w, sci, st.c0,
                 st.cf, st.C, st.F, st.AH, st.piv, st.nlive, r=r, eps=eps,
                 bland_static=bland_static, threshold=threshold)
    status, iters, active = sci[:, [0, 1, 4]].cpu().numpy().T
    active = active != 0
    repriced = cadence or bool((active & (status != RUNNING)).any())
    if repriced:
        do_r = (sci[:, 4] != 0) & ((sci[:, 0] != RUNNING) | cadence)
        mv = batch_apply_reprice(st.Tt, st.C, st.F, st.cf,
                                 do_r.to(torch.int32), st.nlive)
        exact = st.c0 - mv
        cols = torch.arange(exact.shape[1], device=exact.device)
        eligible = (exact <= -eps) & (cols < r)
        premature = (do_r & (sci[:, 0] == int(Status.OPTIMAL))
                     & eligible.any(dim=1))
        sci[:, 0] = torch.where(premature, RUNNING, sci[:, 0])
        st.costs.copy_(torch.where(do_r[:, None], exact, st.costs))
    else:
        batch_apply(st.Tt, st.C, st.F, st.nlive)
    if st.w is not None:
        st.w.copy_(torch.where(st.w.amax(dim=1, keepdim=True) > 1e8, 1.0,
                               st.w))
    return status, iters, active, repriced


def solve_loop_batched_kernel(tabs: BatchTableau, options: SolverOptions,
                              max_iter: int, costs0: torch.Tensor,
                              live: torch.Tensor | None = None):
    """The batched deferred-window loop (port of
    ``simplex_tpu.batch.solve_loop_batched_kernel``): windows until no
    lane is RUNNING under its fuse, or ``max_iter`` windows, re-pricing
    against the original costs ``costs0``. A lane that ended OPTIMAL in a
    re-priced window may have been reopened on the device after the
    host's read, so the loop runs one more window while such a lane
    exists; that window tells. The tableau is updated in place. Returns (tableau, status (B,), iterations (B,), windows):
    statuses stay RUNNING for lanes that hit the fuse."""
    eps = float(options.eps_resolved)
    rule = options.pivot_rule_resolved
    bland_static = rule == "bland"
    L = batch_window_len(options)
    every = max(1, int(options.reprice_every))
    if tabs.Tt.dtype != torch.float32 or tabs.Tt.shape[1] % 128:
        raise ValueError(f"the batched loop needs an f32 tableau padded to "
                         f"128 variables, got {tabs.Tt.dtype} "
                         f"R={tabs.Tt.shape[1]}")
    st = LoopState.start(tabs, L, costs0, rule == "devex", max_iter,
                         bland_static, live)
    kw = dict(r=tabs.r, eps=eps, bland_static=bland_static,
              threshold=options.bland_threshold)
    status, iters = st.sci[:, :2].cpu().numpy().T
    pending = (status == RUNNING) & (iters < max_iter)
    windows = 0
    while windows < max_iter and pending.any():
        status, iters, active, repriced = window_step(
            st, cadence=(windows + 1) % every == 0, **kw)
        windows += 1
        reopenable = repriced & active & (status == int(Status.OPTIMAL))
        pending = ((status == RUNNING) | reopenable) & (iters < max_iter)
    vdtype = tabs.costs.dtype
    out = dataclasses.replace(tabs, b=st.b.to(vdtype),
                              costs=st.costs.to(vdtype), z=st.z.to(vdtype),
                              base=st.base)
    return out, st.sci[:, 0], st.sci[:, 1], windows


def run_solve_loop_batched(tabs: BatchTableau, options: SolverOptions,
                           max_iter: int, costs0: torch.Tensor, live=None):
    """``solve_loop_batched_kernel`` with the per-lane ``normalize_costs``
    scaling (``simplex_tpu.batch.run_solve_loop_batched``): each lane's
    working costs, z and costs0 are divided by ``max(1, EPS_REL_F32 / eps
    * (1 + max|costs|))`` for the loop; a positive scale changes no
    argmin, only the pricing discipline."""
    scale = None
    if normalize_enabled(options):
        cmax = tabs.costs.abs().amax(dim=1)
        scale = torch.clamp((EPS_REL_F32 / float(options.eps_resolved))
                            * (1.0 + cmax), min=1.0).to(tabs.costs.dtype)
        tabs = dataclasses.replace(tabs, costs=tabs.costs / scale[:, None],
                                   z=tabs.z / scale)
        costs0 = costs0 / scale[:, None]
    out, status, iters, windows = solve_loop_batched_kernel(
        tabs, options, max_iter, costs0, live)
    if scale is not None:
        out = dataclasses.replace(out, costs=out.costs * scale[:, None],
                                  z=out.z * scale)
    return out, status, iters, windows


# ---------------------------------------------------------------------------
# Two phases.

class BatchSolveOutput(NamedTuple):
    """Outcome of a batched two-phase solve (tensors on the device, a
    leading lane axis on each) and the loop's steps per phase."""

    status: torch.Tensor             # (B,) int32 Status codes
    x: torch.Tensor                  # (B, n), zeros unless OPTIMAL
    objective: torch.Tensor          # (B,)
    iterations_phase1: torch.Tensor  # (B,)
    iterations_phase2: torch.Tensor  # (B,)
    n_artificial_in_base: torch.Tensor  # (B,)
    base: torch.Tensor               # (B, M_pad) final bases
    #: Per phase: the kernel path's windows, or the batched sequential
    #: loop's steps; (0, 0) for the fallback's lane-by-lane route.
    windows: tuple[int, int]
    #: The lanes' slack blocks (m, m), views of Tt (a list on the
    #: lane-by-lane route, None where phase 2 did not run).
    binv: object


def solve_device_batched(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         n: int, m: int, options: SolverOptions,
                         kernel="auto") -> BatchSolveOutput:
    """Two-phase solve of every lane (``A (B, m, n)`` in the tableau
    dtype, ``b (B, m)``, ``c (B, n)`` on the solve's device), dispatched
    as ``simplex_tpu.batch.solve_device_batched``: ``kernel="auto"`` takes
    the batched kernels where ``batch_kernel_eligible`` and the batched
    fallback elsewhere, True the kernels, False the fallback. The
    fallback's sequential configurations run the lane-batched sequential
    loop, its blocked ones lane by lane (``batch_fallback.py``)."""
    use_kernel = (batch_kernel_eligible(options) if kernel == "auto"
                  else bool(kernel))
    if use_kernel:
        return _two_phase_batched(A, b, c, n, m, options,
                                  batch_kernel_dims(n, m, options),
                                  run_solve_loop_batched)
    from .batch_fallback import solve_device_lanes, solve_loop_seq_batched

    if int(options.block_pivots or 1) > 1:
        return solve_device_lanes(A, b, c, n, m, options)
    # The single-LP tableau's padding: each lane is solve()'s.
    return _two_phase_batched(A, b, c, n, m, options,
                              padded_dims(n, m, options),
                              solve_loop_seq_batched)


def _two_phase_batched(A, b, c, n: int, m: int, options: SolverOptions,
                       dims: tuple[int, int, int],
                       loop) -> BatchSolveOutput:
    """The stages, statuses and NUMERIC guards of
    ``simplex_tpu.batch._solve_device_batched_kernel``, lane by lane, on
    tableaus padded to ``dims`` (R1_pad, R2_pad, M_pad), with ``loop``
    (``run_solve_loop_batched`` or ``batch_fallback.
    solve_loop_seq_batched``) running both phases. The artificials are
    pivoted out only in the lanes that need it, one lane at a time; lanes
    whose phase 1 decided the outcome stay frozen through phase 2 (their
    phase-2 result would be discarded)."""
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    R1, R2, M = dims
    inputs_finite = (torch.isfinite(A).all(dim=2).all(dim=1)
                     & torch.isfinite(b).all(dim=1)
                     & torch.isfinite(c).all(dim=1))

    # ---- Phase 1 ----
    tabs = batch_build_phase1(A, b, n, m, options, dims=(R1, M))
    costs0 = tabs.costs
    tabs = batch_gaussian_eliminate(tabs)
    tabs, status1, iters1, windows1 = loop(tabs, options, max_iter, costs0)

    z_phase1 = batch_phase1_objective(tabs)
    infeasible = z_phase1 <= -eps * (1.0 + b.abs().amax(dim=1))
    n_art = batch_count_basic_artificials(tabs)
    degenerate = n_art > 0
    fuse1 = status1 == RUNNING
    if options.degeneracy == "continue":
        repair = degenerate & ~infeasible & ~fuse1
        for i in torch.nonzero(repair)[:, 0].tolist():
            lane = pivot_out_artificials(tabs.lane(i), options)
            tabs.b[i] = lane.b
            tabs.costs[i] = lane.costs
            tabs.z[i] = lane.z
            tabs.base[i] = lane.base
    phase1_failed = infeasible | fuse1
    if options.degeneracy == "reference":
        phase1_failed = phase1_failed | degenerate

    # ---- Phase 2 ----
    tab2 = batch_phase2_reset(tabs, c, R2)
    del tabs
    costs0 = tab2.costs
    tab2 = batch_gaussian_eliminate(tab2)
    tab2, status2, iters2, windows2 = loop(tab2, options, max_iter, costs0,
                                           live=~phase1_failed)
    x = batch_extract_solution(tab2)

    # Status resolution, per lane as in two_phase.solve_device.
    def pick(cond, code, other):
        return torch.where(cond, int(code), other)

    status = pick(status2 == RUNNING, Status.MAXITER, status2)
    if options.degeneracy == "reference":
        status = pick(degenerate, Status.DEGENERATE, status)
    status = pick(infeasible, Status.INFEASIBLE, status)
    status = pick(fuse1, Status.MAXITER, status)
    finite = torch.isfinite(tab2.z) & torch.isfinite(x).all(dim=1)
    status = pick(~(finite | phase1_failed), Status.NUMERIC, status)
    status = pick(~torch.isfinite(z_phase1), Status.NUMERIC, status)
    status = pick(~inputs_finite, Status.NUMERIC, status)

    objective_opt = (c.to(x.dtype) * x).sum(dim=1)
    objective = torch.where(
        phase1_failed, z_phase1,
        torch.where(status2 == int(Status.OPTIMAL), objective_opt, tab2.z))
    x = torch.where((status == int(Status.OPTIMAL))[:, None], x, 0.0)
    return BatchSolveOutput(
        status.to(torch.int32), x, objective, iters1,
        torch.where(phase1_failed, 0, iters2), n_art, tab2.base,
        (windows1, windows2), tab2.T3[:, :m, n:n + m])


def solve_batched(problems, options: SolverOptions | None = None, *,
                  device="cuda", mesh=None, kernel="auto", stats=None,
                  **replacements) -> list[SolveResult]:
    """Solve a homogeneous batch of Problems in one device call
    (``simplex_tpu.solve_batch``). All problems must share (vars,
    constraints). ``device="cuda"`` (the default) raises where CUDA is
    absent; ``device="cpu"`` runs the kernels' plain versions.
    ``kernel`` dispatches as in ``solve_device_batched``: "auto" (the
    default) takes the batched kernels where the options allow and the
    batched fallback elsewhere -- ``DEFAULT_OPTIONS``, an f64 sequential
    tableau, takes the fallback's lane-batched sequential loop --, True
    the kernels, False the fallback.

    ``mesh``, a ``torch.distributed`` ProcessGroup of P ranks, makes this
    the scenario fleet: every rank calls it with the same problems, rank
    i solves the lanes ``[i B/P, (i+1) B/P)`` on its ``device`` with no
    collective, and every rank returns the whole list, gathered once at
    the end. B must divide by P.

    ``stats``, a dict when given, receives the windows (the kernel path)
    or batched steps (the sequential fallback) per phase (``windows``),
    the final bases (``bases``, (B, M_pad)) and wall
    seconds: of casting and moving the data to the device
    (``prepare_s``), of the device solve up to the host's copy of its
    results (``device_s``) and of the host refinement (``refine_s``); in
    the fleet, of the rank's own lanes."""
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    check_batch_supported(options, kernel, mesh)
    dev = resolve_device(device)
    if not problems:
        return []
    n, m = problems[0].vars, problems[0].constraints
    for p in problems:
        if (p.vars, p.constraints) != (n, m):
            raise ValueError(
                f"batch must be homogeneous: got {(p.vars, p.constraints)} "
                f"vs {(n, m)}")
    if mesh is None:
        return _solve_lanes(problems, n, m, options, dev, stats, kernel)

    import torch.distributed as dist

    ranks = dist.get_world_size(mesh)
    if len(problems) % ranks:
        raise ValueError(f"batch size {len(problems)} must divide across "
                         f"{ranks} devices")
    per = len(problems) // ranks
    rank = dist.get_rank(mesh)
    mine = _solve_lanes(problems[rank * per:(rank + 1) * per], n, m,
                        options, dev, stats, kernel)
    parts = [None] * ranks
    dist.all_gather_object(parts, mine, group=mesh)
    return [r for part in parts for r in part]


def solve_batched_rank(group, device, problems, options):
    """The fleet (``solve_batched`` with ``mesh=group``) for
    ``parallel.group.spawn``."""
    return solve_batched(problems, options, device=device, mesh=group)


def _solve_lanes(problems, n: int, m: int, options: SolverOptions, dev,
                 stats, kernel="auto") -> list[SolveResult]:
    """``solve_batched``'s body for one device: the lanes' data to the
    device, the device solve, the host refinement of each OPTIMAL lane."""
    t0 = time.perf_counter()
    # A is cast to the tableau dtype on the host, lane by lane into one
    # buffer, before the transfer: the build converts it anyway, and f32
    # halves the bytes (1.0 GB at 256 lanes of 500 x 2,000).
    A_host = np.empty((len(problems), m, n), dtype=options.dtype)
    for i, p in enumerate(problems):
        A_host[i] = p.A
    A = torch.from_numpy(A_host).to(dev)
    del A_host
    b = torch.from_numpy(np.stack([p.b for p in problems])).to(dev)
    c = torch.from_numpy(np.stack([p.c for p in problems])).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prep = time.perf_counter()
    out = solve_device_batched(A, b, c, n, m, options, kernel)
    del A
    status = out.status.cpu().numpy()
    objective = out.objective.cpu().numpy()
    iters1 = out.iterations_phase1.cpu().numpy()
    iters2 = out.iterations_phase2.cpu().numpy()
    n_art = out.n_artificial_in_base.cpu().numpy()
    x = out.x.cpu().numpy()
    base = out.base.cpu().numpy()
    t1 = time.perf_counter()

    refine = refine_enabled(options)
    results = []
    for i, p in enumerate(problems):
        st = Status(int(status[i]))
        result = SolveResult(
            status=st, x=x[i] if st == Status.OPTIMAL else None,
            objective=float(objective[i]),
            iterations_phase1=int(iters1[i]),
            iterations_phase2=int(iters2[i]),
            degenerate=bool(n_art[i] > 0))
        if refine and st == Status.OPTIMAL:
            result = _refine_lane(p, base[i], options, result,
                                  out.binv[i])
        results.append(result)
    if stats is not None:
        stats.update(windows=out.windows, bases=base,
                     prepare_s=t_prep - t0, device_s=t1 - t_prep,
                     refine_s=time.perf_counter() - t1)
    return results


def _refine_lane(problem, base, options: SolverOptions, result: SolveResult,
                 binv: torch.Tensor) -> SolveResult:
    """f64 refinement of one OPTIMAL lane on the host
    (``simplex_tpu.batch._refine_lane``): NumPy/LAPACK against the lane's
    own f64 problem data. A lane whose certificates fail gets up to two
    reinversion-restart rounds on the device first (``reinvert.
    restart_device``, from the lane's final slack block ``binv``; a
    RuntimeError in a round ends them), which the JAX package does not
    run. A lane that still does not certify goes to the f64 finishing
    tier (``two_phase.fallback_solve`` from its last basis, on the lane's
    device), whose result it takes, its RefineInfo marked ``fallback``."""
    from .refine import RefineInfo, certificates_pass, refine_solution_host
    from .reinvert import restart_device
    from .two_phase import fallback_solve

    t0 = time.perf_counter()
    tol = float(options.refine_tol)
    n, m = problem.vars, problem.constraints

    def refined(base):
        ro = refine_solution_host(problem.A, problem.b, problem.c, base,
                                  n, m)
        ok = ro is not None and certificates_pass(ro, problem.b, problem.c,
                                                  tol)
        return ro, ok

    ro, ok = refined(base)
    method, extra = "lu", 0
    if not ok and ro is not None:
        dev = binv.device
        data = [torch.from_numpy(np.asarray(v)).to(dev)
                for v in (problem.A, problem.b, problem.c)]
        base_cur = torch.from_numpy(np.asarray(base)).to(dev)
        for _ in range(2):
            try:
                out2, binv, _ = restart_device(*data, base_cur, binv,
                                               ro.xB.to(dev), n, m, options)
            except RuntimeError:   # out of memory and the like: hand
                break              # over to the finishing tier
            if out2.status != Status.OPTIMAL:
                break
            extra += out2.iterations_phase2
            base_cur = out2.base
            base = base_cur.cpu().numpy()
            ro, ok = refined(base)
            if ok:
                method = "restart"
            if ok or ro is None:
                break
    if not ok:
        inf = float("inf")
        info = RefineInfo(
            certified=False,
            primal_residual=float(ro.primal_residual) if ro else inf,
            primal_negativity=float(ro.primal_negativity) if ro else inf,
            artificial_mass=float(ro.artificial_mass) if ro else inf,
            dual_infeasibility=float(ro.dual_infeasibility) if ro else inf,
            tol=tol, fallback=True)
        result64 = fallback_solve(problem, options, base=np.asarray(base),
                                  device=binv.device)
        # The finishing tier's own RefineInfo when it has one.
        info = (result64.refine or info)._replace(fallback=True)
        return dataclasses.replace(result64, refine=info)
    info = RefineInfo(
        certified=True, primal_residual=float(ro.primal_residual),
        primal_negativity=float(ro.primal_negativity),
        artificial_mass=float(ro.artificial_mass),
        dual_infeasibility=float(ro.dual_infeasibility), tol=tol,
        method=method,
        objective_shift=float(ro.objective) - result.objective,
        wall_s=time.perf_counter() - t0)
    return dataclasses.replace(
        result, x=ro.x.numpy(), objective=float(ro.objective), refine=info,
        iterations_phase2=result.iterations_phase2 + extra)
