"""The pivot loops and their dispatch.

Port of ``simplex_tpu.solver``: the sequential reference loop
(``choose_entering``, ``ratio_test``, ``iteration_body``,
``solve_loop``), its fused variant over K6 (``solve_loop_pallas``), the
plain deferred block-pivot loop (``solve_loop_blocked``), the
blocked-kernel loop over K1-K4 (``solve_loop_blocked_kernel``), and
``run_solve_loop``, which picks one of the four in the JAX package's
order and applies the ``normalize_costs`` scaling.

Every loop keeps its per-pivot decisions on the device: the candidates,
``do``, ``status``, ``stall``, ``bland`` and the iteration count are
0-dim tensors, and no pivot waits for the host. The host reads status
and iterations once per chunk of ``SEQ_CHUNK`` pivots (the sequential
loops) or once per window (the blocked loops): a pivot body is
idempotent once its loop has finished, and every pivot is gated on
``status == RUNNING and iterations < max_iter``, so a MAXITER exit
reports exactly ``max_iter`` pivots whatever the chunk.

The tableau is updated in place (the JAX package's loops return a new
one); b, the costs, z and base are new tensors each pivot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (EPS_REL_F32, SolverOptions, Status,
                     kernel_blocked_enabled, normalize_enabled)
from .kernels.blocked import (BIG_INDEX, ah_ratio, ah_ratio_workspace,
                              apply_reprice, apply_window, colk_costs,
                              colk_workspace, entering_candidates)
from .tableau import Tableau, basic_costs, tt_matvec

RUNNING = int(Status.RUNNING)
OPTIMAL = int(Status.OPTIMAL)
UNBOUNDED = int(Status.UNBOUNDED)

#: Pivots the sequential loops enqueue between two host reads of the
#: status. After the exit the rest of a chunk are skipped pivots: each
#: is a full pass of ``solve_loop``'s update (K6 skips the tableau).
SEQ_CHUNK = 32


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, as a 0-dim tensor, without a
    host sync."""
    return x.index_select(0, i.long().view(1)).view(())


def _exit_status(active, optimal, unbounded, status):
    """The status after one pivot: OPTIMAL / UNBOUNDED / RUNNING where the
    pivot was active, else the status as it was."""
    return torch.where(
        active, torch.where(optimal, OPTIMAL,
                            torch.where(unbounded, UNBOUNDED, RUNNING)),
        status).to(torch.int32)


def anticycling_update(do, improved, prev_stall, prev_bland, *,
                       bland_static: bool, threshold):
    """The stall/Bland anti-cycling policy (``simplex_tpu.solver``): an
    applied pivot that improves z by >= eps resets the stall counter and
    leaves Bland mode; a non-improving one increments it and enters Bland
    once it reaches ``threshold``. Returns (stall, bland) tensors."""
    stall = torch.where(do, torch.where(improved, 0, prev_stall + 1),
                        prev_stall).to(torch.int32)
    if bland_static:
        bland = torch.ones_like(prev_bland)
    elif threshold is None:
        bland = torch.zeros_like(prev_bland)
    else:
        bland = torch.where(do, ~improved & (stall >= threshold), prev_bland)
    return stall, bland


# ---------------------------------------------------------------------------
# The sequential reference loop.

def choose_entering(tab: Tableau, bland: torch.Tensor, eps: float):
    """Entering variable (``simplex_tpu.solver.choose_entering``): the
    Dantzig argmin of the active reduced costs, or -- when the Bland
    fallback is on and some column is eligible -- the lowest index with
    cost <= -eps; ties to the lowest index. Returns 0-dim (h int32,
    minc); the loop is optimal iff ``minc > -eps``."""
    R = tab.rows_padded
    iota = torch.arange(R, device=tab.costs.device)
    masked = torch.where(iota < tab.r, tab.costs, torch.inf)
    eligible = masked <= -eps
    h_bland = torch.argmin(torch.where(eligible, iota, R))
    h = torch.where(bland & eligible.any(), h_bland, torch.argmin(masked))
    return h.to(torch.int32), _at(masked, h)


def ratio_test(tab: Tableau, a_h: torch.Tensor, eps: float):
    """Leaving constraint (``simplex_tpu.solver.ratio_test``): the argmin
    of ``b / a_h`` over ``a_h >= eps`` (in the wider of the two dtypes),
    ties to the lowest index. Returns 0-dim (k int32, unbounded bool);
    unbounded iff no row is eligible (then k is 0)."""
    mask = a_h >= eps
    ratios = torch.where(mask, tab.b / torch.where(mask, a_h, 1.0),
                         torch.inf)
    return torch.argmin(ratios).to(torch.int32), ~mask.any()


def pivot_update(tab: Tableau, h, k, minc, p=None, do=None,
                 a_h=None) -> Tableau:
    """One rank-1 pivot (``simplex_tpu.solver.pivot_update``), entering
    variable h, leaving constraint k, both ints or 0-dim tensors: with
    ``a_h = Tt[:, h]``, ``p = a_h[k]`` (unless given) and ``colk =
    Tt[k]``, every row j of ``Tt`` loses ``(a_h[j] / p) * colk`` and row k
    becomes ``colk / p``; b, the costs, z and base follow, the vectors in
    their own dtype (``minc / p`` and the f32 tableau factors widen to it,
    as in the JAX package). With ``do`` (a 0-dim bool) false nothing
    changes. ``a_h``, when given, is the caller's copy of ``Tt[:, h]``.

    The tableau is updated in place by one ``Tt.addr_(factor, colk,
    alpha=-1)``: no tableau-sized temporary (1.6 GB at the 8192^2 f64
    tableau). It rounds as PyTorch's ``addr`` kernel does for the
    device: on an H100 (torch 2.11) the product and the difference apart,
    as the JAX package does, where the reference CUDA program rounds once
    (an FMA, ``solver.cu:43``); ``batch_fallback.seq_step``'s batched
    update rounds the same way. The CPU tests hold the f64 walks equal to
    the JAX package's."""
    Tt = tab.Tt
    M, R = Tt.shape
    dev = Tt.device
    h = torch.as_tensor(h, device=dev).long().view(1)
    k = torch.as_tensor(k, device=dev).long().view(1)
    if a_h is None:
        a_h = Tt.index_select(1, h).view(M)
    if p is None:
        p = a_h.index_select(0, k).view(())
    colk = Tt.index_select(0, k).view(R)
    bk = tab.b.index_select(0, k).view(())
    factor = a_h / p
    row_k = colk / p
    if do is not None:
        factor = torch.where(do, factor, 0.0)
        row_k = torch.where(do, row_k, colk)
    Tt.addr_(factor, colk, alpha=-1.0)
    Tt.index_copy_(0, k, row_k[None])

    vd = tab.b.dtype
    pv = p.to(vd)
    u = minc.to(vd) / pv
    b = tab.b - bk * factor.to(vd)
    b.index_copy_(0, k, (bk / pv).view(1))
    costs = tab.costs - u * colk.to(vd)
    z = tab.z - u * bk
    base = tab.base.index_copy(0, k, h.to(tab.base.dtype))
    if do is not None:
        b = torch.where(do, b, tab.b)
        costs = torch.where(do, costs, tab.costs)
        z = torch.where(do, z, tab.z)
        base = torch.where(do, base, tab.base)
    return dataclasses.replace(tab, b=b, costs=costs, z=z, base=base)


@dataclasses.dataclass
class LoopState:
    """The sequential loops' carry (``simplex_tpu.solver.LoopState``;
    with ``cand``, ``PallasLoopState``): the tableau, and 0-dim status,
    iterations and stall (int32) and bland (bool). ``cand`` holds the K6
    loop's entering candidates over the current costs, (h_d, v_d, h_b,
    v_b), which the previous pivot's pass folded."""

    tab: Tableau
    status: torch.Tensor
    iterations: torch.Tensor
    stall: torch.Tensor
    bland: torch.Tensor
    cand: tuple | None = None


def initial_state(tab: Tableau, options: SolverOptions) -> LoopState:
    dev = tab.Tt.device
    return LoopState(
        tab, torch.tensor(RUNNING, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.tensor(options.pivot_rule_resolved == "bland", device=dev))


def iteration_body(state: LoopState, options: SolverOptions,
                   max_iter: int) -> LoopState:
    """One pivot of the sequential loop (``simplex_tpu.solver.
    iteration_body``): entering argmin, unboundedness and min-ratio tests,
    the rank-1 update, the status and the anti-cycling policy, with no
    host sync. A skipped pivot (the loop finished, or the fuse reached)
    changes nothing, so the body is idempotent once the loop has
    finished."""
    eps = float(options.eps_resolved)
    tab = state.tab
    active = (state.status == RUNNING) & (state.iterations < max_iter)
    h, minc = choose_entering(tab, state.bland, eps)
    optimal = minc > -eps
    a_h = tab.Tt.index_select(1, h.long().view(1)).view(-1)
    k, unbounded = ratio_test(tab, a_h, eps)
    do = active & ~(optimal | unbounded)
    # Guard the division of a skipped pivot (p could be ~0 garbage).
    p = torch.where(do, _at(a_h, k), 1.0)
    tab2 = pivot_update(tab, h, k, minc, p=p, do=do, a_h=a_h)
    stall, bland = anticycling_update(
        do, (tab2.z - tab.z).abs() >= eps, state.stall, state.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    return LoopState(tab2, _exit_status(active, optimal, unbounded,
                                        state.status),
                     state.iterations + do.to(torch.int32), stall, bland)


def _drive(body, state: LoopState, max_iter: int):
    """Run ``body`` until the loop exits, reading status and iterations
    once per ``SEQ_CHUNK`` pivots. Returns (state, status, iterations);
    status stays RUNNING when the fuse tripped."""
    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for _ in range(min(SEQ_CHUNK, max_iter - it)):
            state = body(state)
        st, it = (int(v) for v in
                  torch.stack([state.status, state.iterations]).tolist())
    return state, st, it


def solve_loop(tab: Tableau, options: SolverOptions,
               max_iter: int) -> tuple[Tableau, int, int]:
    """Pivots until OPTIMAL / UNBOUNDED / the iteration fuse
    (``simplex_tpu.solver.solve_loop``). Returns (tableau, status,
    iterations); status stays RUNNING if the fuse tripped."""
    state, st, it = _drive(lambda s: iteration_body(s, options, max_iter),
                           initial_state(tab, options), max_iter)
    return state.tab, st, it


def use_pallas(options: SolverOptions) -> bool:
    """Whether the sequential loop takes the fused pivot pass K6
    (``simplex_tpu.solver.use_pallas``): explicit ``use_pallas=True`` on
    a pure-f32 tableau (the pass is single-dtype). The JAX package also
    asks for a TPU backend; here K6's wrapper launches the kernel for
    CUDA tensors and takes its plain version for CPU ones."""
    if np.dtype(options.dtype).itemsize != 4:
        return False
    if np.dtype(options.vector_dtype) != np.dtype(options.dtype):
        return False
    return options.use_pallas is not False and options.use_pallas != "auto"


def solve_loop_pallas(tab: Tableau, options: SolverOptions,
                      max_iter: int) -> tuple[Tableau, int, int]:
    """The sequential loop over K6 (``simplex_tpu.solver.
    solve_loop_pallas``): per pivot one fused pass updates the tableau and
    the costs and folds the next candidates, so the body never re-reads
    the cost vector; only the O(M) glue is torch. The same pivot
    sequence as ``solve_loop`` in exact arithmetic; in f32 K6 scales by
    ``1/p`` and the two part where rounding decides a tie."""
    from .kernels.pivot import (BIG_INDEX as BIG, entering_candidates,
                                fused_pivot)

    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    Tt = tab.Tt
    M, R = Tt.shape
    M_iota = torch.arange(M, device=Tt.device)
    tab = dataclasses.replace(tab, costs=tab.costs.clone())   # K6: in place

    def body(s: LoopState) -> LoopState:
        tab = s.tab
        h_d, v_d, h_b, v_b = s.cand
        active = (s.status == RUNNING) & (s.iterations < max_iter)
        use_bland = s.bland & (h_b < BIG)
        h = torch.where(use_bland, h_b, h_d)
        minc = torch.where(use_bland, v_b, v_d)
        optimal = minc > -eps
        a_h = Tt.index_select(1, h.long().clamp(max=R - 1).view(1)).view(M)
        k, unbounded = ratio_test(tab, a_h, eps)
        do = active & ~(optimal | unbounded)
        colk = Tt.index_select(0, k.long().view(1)).view(R)
        p = _at(a_h, k)
        new = fused_pivot(Tt, tab.costs, colk, a_h, p, minc, k, tab.r, eps,
                          do)
        cand = tuple(torch.where(do, a, b) for a, b in zip(new, s.cand))

        p_safe = torch.where(do, p, 1.0)
        bk = _at(tab.b, k)
        b = torch.where(M_iota == k, bk / p_safe, tab.b - bk * (a_h / p_safe))
        z = tab.z - (minc / p_safe) * bk
        tab2 = dataclasses.replace(
            tab, b=torch.where(do, b, tab.b), z=torch.where(do, z, tab.z),
            base=torch.where(do & (M_iota == k), h, tab.base))
        stall, bland = anticycling_update(
            do, (tab2.z - tab.z).abs() >= eps, s.stall, s.bland,
            bland_static=bland_static, threshold=options.bland_threshold)
        return LoopState(tab2, _exit_status(active, optimal, unbounded,
                                            s.status),
                         s.iterations + do.to(torch.int32), stall, bland,
                         cand)

    init = initial_state(tab, options)
    init.cand = entering_candidates(tab.costs, tab.r, eps)
    state, st, it = _drive(body, init, max_iter)
    return state.tab, st, it


# ---------------------------------------------------------------------------
# The plain deferred block-pivot loop.

def _entering_blocked(costs, w, bland, r: int, eps: float, devex: bool):
    """``choose_entering`` on the bare cost vector, with the devex score
    (cost^2 / weight over eligible columns) in place of the Dantzig
    argmin when configured (``simplex_tpu.solver.solve_loop_blocked``'s
    ``entering``)."""
    R = costs.shape[0]
    iota = torch.arange(R, device=costs.device)
    masked = torch.where(iota < r, costs, torch.inf)
    eligible = masked <= -eps
    if devex:
        h_main = torch.argmax(torch.where(eligible, masked * masked / w,
                                          -torch.inf))
    else:
        h_main = torch.argmin(masked)
    h_bland = torch.argmin(torch.where(eligible, iota, R))
    h = torch.where(bland & eligible.any(), h_bland, h_main)
    return h.to(torch.int32), _at(masked, h)


def _devex_update(w, do, colk, p, h, old_base_k):
    """Forrest-Goldfarb reference-framework weights (``simplex_tpu.solver.
    solve_loop_blocked``'s ``devex_update``): alpha is the leaving row
    over all variables (colk / p); the leaving variable gets max(w_h /
    p^2, 1); capped at 1e12 with NaN reset to 1, and re-anchored to all
    ones when the framework drifts beyond 1e8."""
    R = w.shape[0]
    wh = _at(w, h)
    alpha = (colk / p).to(w.dtype)
    w2 = torch.maximum(w, alpha * alpha * wh)
    lv = old_base_k.clamp(max=R - 1).long().view(1)
    leaving = torch.maximum(wh / (p * p).to(w.dtype), torch.ones_like(wh))
    w2 = w2.index_copy(0, lv, torch.where(old_base_k < R, leaving,
                                          _at(w2, lv)).view(1))
    w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
    w2 = torch.where(torch.isnan(w2), 1.0, w2)
    w2 = torch.where(w2.max() > 1e8, 1.0, w2)
    return torch.where(do, w2, w)


def solve_loop_blocked(tab: Tableau, options: SolverOptions, max_iter: int,
                       costs0: torch.Tensor | None = None
                       ) -> tuple[Tableau, int, int]:
    """Deferred block pivoting in plain torch (``simplex_tpu.solver.
    solve_loop_blocked``): the loop for f64 tableaus, and for f32 ones when
    the kernels are off (``use_pallas=False``) or L is not a multiple of 8.

    The tableau stays stale for a window of L pivots. Pivot t reads the
    live entering column ``Tt[:, h] - C[:t, h] @ F[:t]`` and leaving row
    ``Tt[k] - F[:t, k] @ C[:t]``, updates b, the costs, z, base and the
    devex weights exactly, and stores its eta pair in ``C[t]``, ``F[t]``;
    the window ends in ``Tt -= F^T C`` (one ``addmm_``, in place). With
    ``costs0`` and an f32 tableau the costs are re-priced exactly at every
    window boundary (``reprice_every`` is not read, as in the JAX loop),
    and an OPTIMAL declared on drifted costs while exact pricing still
    shows an improving column is reopened. f64 tableaus are not re-priced
    (incremental f64 updates drift ~1e-13).

    The JAX package emulates f64 on the TPU, so it forms the f64 eta
    corrections elementwise and the f64 window apply as a Dekker split
    (``_split_dot``); here both are native f64 products. An f32 apply on
    the card needs TF32 off (IEEE products, the JAX loop's HIGHEST
    precision). The host reads status and iterations once per window."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots or 1)
    Tt = tab.Tt
    M, R = Tt.shape
    dev = Tt.device
    dtype, vd = Tt.dtype, tab.costs.dtype
    if dtype == torch.float64:
        costs0 = None
    elif dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the f32 window apply needs IEEE products: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    iota_m = torch.arange(M, device=dev)
    row_mask = torch.arange(R, device=dev) < tab.r

    b, costs, z, base = tab.b, tab.costs, tab.z, tab.base
    w = torch.ones(R, dtype=vd, device=dev)
    status = torch.tensor(RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    bland = torch.tensor(bland_static, device=dev)
    # Pivot t writes C[t] and F[t] (zeros when skipped) and reads rows
    # < t only, so the factors are never cleared.
    C = torch.zeros((L, R), dtype=dtype, device=dev)
    F = torch.zeros((L, M), dtype=dtype, device=dev)

    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            h, minc = _entering_blocked(costs, w, bland, tab.r, eps, devex)
            optimal = minc > -eps
            hl = h.long().view(1)
            a_h = Tt.index_select(1, hl).view(M)
            if t:
                a_h = a_h - C[:t].index_select(1, hl).view(t) @ F[:t]
            mask = a_h >= eps
            unbounded = ~mask.any()
            k = torch.argmin(torch.where(
                mask, b / torch.where(mask, a_h, 1.0), torch.inf))
            do = active & ~(optimal | unbounded)
            p = torch.where(do, _at(a_h, k), 1.0)
            kl = k.view(1)
            colk = Tt.index_select(0, kl).view(R)
            if t:
                colk = colk - F[:t].index_select(1, kl).view(t) @ C[:t]
            bk = _at(b, k)
            u = minc / p.to(vd)
            costs2 = torch.where(do, costs - u * colk.to(vd), costs)
            z2 = torch.where(do, z - u * bk, z)
            is_k = iota_m == k
            b = torch.where(do, torch.where(is_k, bk / p.to(vd),
                                            b - bk * (a_h / p).to(vd)), b)
            if devex:
                w = _devex_update(w, do, colk, p, h, _at(base, k))
            base = torch.where(do & is_k, h, base)
            C[t] = torch.where(do, colk, 0.0)
            F[t] = torch.where(do, torch.where(is_k, 1.0 - 1.0 / p,
                                               a_h / p), 0.0)
            status = _exit_status(active, optimal, unbounded, status)
            stall, bland = anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=threshold)
            iterations = iterations + do.to(torch.int32)
            costs, z = costs2, z2
        Tt.addmm_(F.t(), C, alpha=-1.0)
        if costs0 is not None:
            costs = costs0 - tt_matvec(Tt, basic_costs(base, costs0, tab.r))
            vmin = torch.where(row_mask, costs, torch.inf).min()
            status = torch.where((status == OPTIMAL) & (vmin <= -eps),
                                 RUNNING, status).to(torch.int32)
        # The window's one host read.
        st, it = (int(v) for v in torch.stack([status, iterations]).tolist())

    out = dataclasses.replace(tab, b=b, costs=costs, z=z, base=base)
    return out, st, it


# ---------------------------------------------------------------------------
# The blocked-kernel loop (K1-K4).

def solve_loop_blocked_kernel(tab: Tableau, options: SolverOptions,
                              max_iter: int,
                              costs0: torch.Tensor | None = None
                              ) -> tuple[Tableau, int, int]:
    """Deferred block pivoting over K1-K4 (port of
    ``simplex_tpu.solver.solve_loop_blocked_kernel``).

    Per pivot: K1 builds the live entering column and runs the ratio
    test; K2 builds the pivot row into ``C[t]``, updates costs, b, base,
    the eta row ``F[t]`` and the devex weights, and folds the next
    candidates. Per window of L pivots: ``Tt -= F^T C`` in place, fused
    with the exact re-pricing ``costs0 - coeffs @ Tt`` every
    ``reprice_every`` windows and on every window that ends non-RUNNING
    (K3), else the apply alone (K4; always when ``costs0`` is None). The
    tableau is updated in place. Returns (tableau, status, iterations);
    status stays RUNNING when the iteration fuse tripped.

    b, the reduced costs and z are native f64 inside the loop, so the
    in-window optimality test, the candidate fold and the window-boundary
    premature test all read one representation (the JAX loop's
    double-f32 pairs needed the round-trip discipline of
    ``simplex_tpu/solver.py:813-823``; the ``windows < max_iter`` bound
    stays all the same). The host reads status and iterations once per
    window (plus once more on a window that ends optimal, for the
    premature-optimal test)."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots)
    every = max(1, int(options.reprice_every))
    Tt = tab.Tt
    M, R = Tt.shape
    if Tt.dtype != torch.float32 or R % 128:
        raise ValueError(f"the kernel loop needs an f32 tableau padded to "
                         f"128 variables, got {Tt.dtype} R={R}")
    dev = Tt.device
    f64 = torch.float64
    r = tab.r
    row_mask = torch.arange(R, device=dev) < r

    b = tab.b.to(f64).clone()
    costs = tab.costs.to(f64).clone()
    z = tab.z.to(f64).clone()
    base = tab.base.to(torch.int32).clone()
    if costs0 is not None:
        costs0 = costs0.to(f64)
    w = torch.ones(R, dtype=torch.float32, device=dev) if devex else None
    status = torch.tensor(RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    bland = torch.tensor(bland_static, device=dev)
    h_d, v_d, h_b, v_b = entering_candidates(costs, w, r, eps)
    # Every row of C and F is rewritten each window before any pass reads
    # it (a skipped pivot writes zeros), so the factors are never cleared.
    C = torch.zeros((L, R), dtype=torch.float32, device=dev)
    F = torch.zeros((L, M), dtype=torch.float32, device=dev)
    ws_k1 = ah_ratio_workspace(M, dev)
    ws = colk_workspace(R, dev)

    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            use_bland = bland & (h_b < BIG_INDEX)
            h = torch.where(use_bland, h_b, h_d)
            minc = torch.where(use_bland, v_b, v_d)
            optimal = minc > -eps
            a_h, k, p, bk, unb = ah_ratio(Tt, F, C, b, h, t, eps, ws_k1)
            unbounded = unb != 0
            do = active & ~(optimal | unbounded)
            p = torch.where(do, p, 1.0)
            u = torch.where(do, minc / p.to(f64), 0.0)
            h_d, v_d, h_b, v_b = colk_costs(
                Tt, C, F, costs, k, t, u, do, r, eps, a_h, b, base, h, p,
                bk, w, ws)
            z2 = torch.where(do, z - u * bk, z)
            status = _exit_status(active, optimal, unbounded, status)
            stall, bland = anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=threshold)
            iterations = iterations + do.to(torch.int32)
            z = z2
        if devex:
            # Re-anchor the reference framework once per window when the
            # weights drift too far.
            w = torch.where(w.max() > 1e8, 1.0, w)
        # The window's one host sync.
        st, it = (int(v) for v in torch.stack([status, iterations]).tolist())
        # Exact re-pricing every ``reprice_every`` windows and on every
        # window that ends non-RUNNING (K3); otherwise the apply alone
        # (K4), the in-window costs and candidates being current.
        if costs0 is not None and (st != RUNNING
                                   or (windows + 1) % every == 0):
            coeffs = basic_costs(base, costs0, r)
            costs = costs0 - apply_reprice(Tt, C, F, coeffs)
            h_d, v_d, h_b, v_b = entering_candidates(costs, w, r, eps)
            if st == OPTIMAL and float(
                    torch.where(row_mask, costs, torch.inf).min()) <= -eps:
                # Declared optimal on in-window costs while exact pricing
                # still shows an improving column: keep running.
                status.fill_(RUNNING)
                st = RUNNING
        else:
            apply_window(Tt, C, F)
        windows += 1

    vdtype = tab.costs.dtype
    out = dataclasses.replace(tab, Tt=Tt, b=b.to(vdtype),
                              costs=costs.to(vdtype), z=z.to(vdtype),
                              base=base)
    return out, st, it


def run_solve_loop(tab: Tableau, options: SolverOptions, max_iter: int,
                   costs0: torch.Tensor | None = None
                   ) -> tuple[Tableau, int, int]:
    """Dispatch (``simplex_tpu.solver.run_solve_loop``): the deferred
    block-pivot loops when ``block_pivots`` > 1 (the kernel loop when
    ``kernel_blocked_enabled``, else the plain one), else the sequential
    loop, over K6 when ``use_pallas`` selects it. ``costs0`` (the phase's
    pre-elimination costs) enables the blocked loops' exact re-pricing;
    the sequential loops ignore it.

    With ``normalize_costs`` on (f32 tableaus by default) the working
    costs, z and costs0 are divided by ``max(1, EPS_REL_F32 / eps * (1 +
    max|costs|))`` for the call and restored on exit, which floors the
    pricing eps at the f32 data-precision threshold."""
    L = int(options.block_pivots or 1)
    if options.pivot_rule_resolved == "devex" and L <= 1:
        raise ValueError(
            "pivot_rule='devex' requires block_pivots > 1 (the deferred "
            "block-pivot loops carry the devex weights); the sequential "
            "reference loop prices with Dantzig/Bland only")
    scale = None
    if normalize_enabled(options):
        live = torch.arange(tab.rows_padded, device=tab.costs.device) < tab.r
        cmax = torch.where(live, tab.costs, 0.0).abs().max()
        scale = torch.clamp(
            (EPS_REL_F32 / float(options.eps_resolved)) * (1.0 + cmax),
            min=1.0).to(tab.costs.dtype)
        tab = dataclasses.replace(tab, costs=tab.costs / scale,
                                  z=tab.z / scale)
        if costs0 is not None:
            costs0 = costs0 / scale

    if L > 1:
        if kernel_blocked_enabled(options) and tab.rows_padded % 128 == 0:
            out = solve_loop_blocked_kernel(tab, options, max_iter, costs0)
        else:
            out = solve_loop_blocked(tab, options, max_iter, costs0)
    elif use_pallas(options):
        out = solve_loop_pallas(tab, options, max_iter)
    else:
        out = solve_loop(tab, options, max_iter)

    tab_out, status, iters = out
    if scale is not None:
        tab_out = dataclasses.replace(tab_out, costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
    return tab_out, status, iters
