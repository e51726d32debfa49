"""The batched fallback: the lanes the batched kernels do not take.

Port of the vmapped-XLA fallback of ``simplex_tpu.batch.
solve_device_batched`` (``simplex_tpu/batch.py:446-450``): with the
kernels off (``use_pallas=False``), every lane is the single-LP two-phase
solve, with its own status, pivot counts, NUMERIC guards, frozen lanes
and basic artificials. Two routes:

* **(a) Sequential configurations** (``block_pivots <= 1``: the default
  f64 options, and the pure-f32 and mixed sequential ones) run one
  lane-batched sequential loop, ``solve_loop_seq_batched``: the lanes sit
  on a leading axis, and each step makes one pivot in every live lane --
  ``solver.choose_entering``, ``solver.ratio_test``, the anticycling
  state and the rank-1 update as batched tensor operations, the update
  itself the CUDA kernel ``kernels.pivot.batch_rank1`` (which rounds as
  the single-LP ``Tt.addr_`` does on the card, and does not touch a
  decided lane). Each lane walks as ``two_phase.solve`` walks it on
  the same device. The host reads the live-lane count once per
  ``solver.SEQ_CHUNK`` steps.
* **(b) Blocked configurations the kernels refuse** (``kernel=False``
  with ``block_pivots > 1``, an f64 blocked tableau, an unaligned L) run
  one lane-batched plain blocked loop, ``solve_loop_blocked_batched``
  (``solver.solve_loop_blocked``, the plain loop the JAX vmap runs, with
  a lane axis): each pivot of a window is one batched pass over the
  lanes, the live column and row read through each lane's own eta rows
  (``bmm`` in f64, rounded once, as the single-LP loop's kernels form
  them), and the window ends in one ``baddbmm_`` apply and, on an f32
  tableau, the exact re-pricing of the lanes that ran it. The host reads
  the running-lane count once per window. ``solve_device_lanes``, the
  lanes one after another through the single-LP device core, stays as
  the reference the tests and ``chip_smoke.py`` hold route (b) to.

Both return ``batch.BatchSolveOutput``; ``batch.solve_batched`` refines
OPTIMAL lanes on the host as for the kernel path.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import EPS_REL_F32, SolverOptions, Status, normalize_enabled
from .kernels.blocked import anticycling_update, exit_status
from .kernels.pivot import batch_rank1
from .solver import SEQ_CHUNK
from .tableau import MATVEC_CHUNK_BYTES, BatchTableau, batch_basic_costs

RUNNING = int(Status.RUNNING)
OPTIMAL = int(Status.OPTIMAL)

#: Rows of a lane that one product of route (b)'s re-pricing takes. The
#: sums run over the rows in this fixed order whatever the lane count; a
#: one-lane product over all 512 rows of config 3 splits its sum across
#: threads on the CPU where a batched one does not, so a lane's costs
#: would depend on B.
REPRICE_ROWS = 128


@dataclasses.dataclass
class SeqState:
    """The lane-batched sequential loop's carry: the lanes' tableaus
    (updated in place) and vectors, and per lane the status, iterations,
    stall counter and Bland flag (``solver.LoopState`` with a lane
    axis)."""

    tabs: BatchTableau
    status: torch.Tensor
    iterations: torch.Tensor
    stall: torch.Tensor
    bland: torch.Tensor


def seq_step(st: SeqState, options: SolverOptions, max_iter: int) -> None:
    """One pivot in every lane RUNNING under its fuse (``solver.
    iteration_body`` per lane): the entering argmin (Bland's lowest
    eligible index in the lanes in Bland mode), the ratio test, the rank-1
    update, the status and the anticycling policy; ties go to the lowest
    index, as in the single-LP loop. Lanes that are not pivoting keep
    every bit of their state. Updates ``st`` in place, with no host
    sync."""
    eps = float(options.eps_resolved)
    tabs = st.tabs
    T3 = tabs.T3
    B, M, R = T3.shape
    dev = T3.device
    lanes = torch.arange(B, device=dev)
    active = (st.status == RUNNING) & (st.iterations < max_iter)

    iota = torch.arange(R, device=dev)
    masked = torch.where(iota < tabs.r, tabs.costs, torch.inf)
    eligible = masked <= -eps
    h_bland = torch.argmin(torch.where(eligible, iota, R), dim=1)
    h = torch.where(st.bland & eligible.any(dim=1), h_bland,
                    torch.argmin(masked, dim=1))
    minc = masked.gather(1, h[:, None])[:, 0]
    optimal = minc > -eps

    a_h = T3.gather(2, h.view(B, 1, 1).expand(B, M, 1))[:, :, 0]
    mask = a_h >= eps
    ratios = torch.where(mask, tabs.b / torch.where(mask, a_h, 1.0),
                         torch.inf)
    k = torch.argmin(ratios, dim=1)
    unbounded = ~mask.any(dim=1)
    do = active & ~(optimal | unbounded)
    p = torch.where(do, a_h.gather(1, k[:, None])[:, 0], 1.0)

    # solver.pivot_update, lane by lane in one pass.
    colk = T3[lanes, k]
    bk = tabs.b.gather(1, k[:, None])[:, 0]
    factor = torch.where(do[:, None], a_h / p[:, None], 0.0)
    row_k = torch.where(do[:, None], colk / p[:, None], colk)
    batch_rank1(T3, factor, colk, do)
    T3[lanes, k] = row_k
    vd = tabs.b.dtype
    pv = p.to(vd)
    u = minc.to(vd) / pv
    b = tabs.b - bk[:, None] * factor.to(vd)
    b[lanes, k] = bk / pv
    costs = tabs.costs - u[:, None] * colk.to(vd)
    z = tabs.z - u * bk
    base = tabs.base.clone()
    base[lanes, k] = h.to(base.dtype)
    z2 = torch.where(do, z, tabs.z)
    tabs.b = torch.where(do[:, None], b, tabs.b)
    tabs.costs = torch.where(do[:, None], costs, tabs.costs)
    tabs.base = torch.where(do[:, None], base, tabs.base)

    st.stall, st.bland = anticycling_update(
        do, (z2 - tabs.z).abs() >= eps, st.stall, st.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    tabs.z = z2
    st.status = exit_status(active, optimal, unbounded, st.status)
    st.iterations = st.iterations + do.to(torch.int32)


def solve_loop_seq_batched(tabs: BatchTableau, options: SolverOptions,
                           max_iter: int, costs0=None, live=None):
    """The sequential loop for every lane (``solver.solve_loop`` with a
    lane axis): steps until no lane is RUNNING under its fuse, reading the
    live-lane count once per ``SEQ_CHUNK`` steps. Lanes where ``live`` is
    False start INFEASIBLE and never pivot. ``costs0`` is not read (the
    sequential loop does not re-price). The ``normalize_costs`` scaling
    is ``solver.run_solve_loop``'s, per lane: each lane's costs and z are
    divided by ``max(1, EPS_REL_F32 / eps * (1 + max |costs[:r]|))`` for
    the loop. Returns (tableau, status (B,), iterations (B,), steps);
    statuses stay RUNNING for lanes that hit the fuse."""
    if options.pivot_rule_resolved == "devex":
        raise ValueError(
            "pivot_rule='devex' requires block_pivots > 1 (the deferred "
            "block-pivot loops carry the devex weights); the sequential "
            "reference loop prices with Dantzig/Bland only")
    tabs, scale, _ = _scaled(tabs, options)
    st = SeqState(*_start(tabs, options, live))
    steps = 0

    def running() -> int:
        return int(((st.status == RUNNING)
                    & (st.iterations < max_iter)).sum())

    while running():
        for _ in range(SEQ_CHUNK):
            seq_step(st, options, max_iter)
        steps += SEQ_CHUNK
    return _unscaled(st.tabs, scale), st.status, st.iterations, steps


def _scaled(tabs: BatchTableau, options: SolverOptions, costs0=None):
    """``solver.run_solve_loop``'s ``normalize_costs`` scaling, per lane:
    each lane's costs, z and ``costs0`` divided by ``max(1, EPS_REL_F32 /
    eps * (1 + max |costs[:r]|))`` for the loop. Returns (a shallow copy
    of ``tabs`` that the loop may rebind, the scale (B,) or None,
    costs0)."""
    tabs = dataclasses.replace(tabs)
    if not normalize_enabled(options):
        return tabs, None, costs0
    cols = torch.arange(tabs.costs.shape[1], device=tabs.costs.device)
    cmax = torch.where(cols < tabs.r, tabs.costs, 0.0).abs().amax(dim=1)
    scale = torch.clamp(
        (EPS_REL_F32 / float(options.eps_resolved)) * (1.0 + cmax),
        min=1.0).to(tabs.costs.dtype)
    tabs.costs = tabs.costs / scale[:, None]
    tabs.z = tabs.z / scale
    if costs0 is not None:
        costs0 = costs0 / scale[:, None]
    return tabs, scale, costs0


def _unscaled(tabs: BatchTableau, scale) -> BatchTableau:
    if scale is None:
        return tabs
    return dataclasses.replace(tabs, costs=tabs.costs * scale[:, None],
                               z=tabs.z * scale)


def _start(tabs: BatchTableau, options: SolverOptions, live):
    """The loops' first (tabs, status, iterations, stall, bland): every
    lane RUNNING, or INFEASIBLE where ``live`` is False."""
    B = tabs.b.shape[0]
    dev = tabs.b.device
    status = torch.full((B,), RUNNING, dtype=torch.int32, device=dev)
    if live is not None:
        status = torch.where(live, status, int(Status.INFEASIBLE)).to(
            torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    return (tabs, status, zeros, zeros,
            torch.full((B,), options.pivot_rule_resolved == "bland",
                       device=dev))


@dataclasses.dataclass
class BlockedState(SeqState):
    """The lane-batched plain blocked loop's carry: ``SeqState``'s, the
    devex weights ``w (B, R)`` (None under Dantzig/Bland), and the
    window's eta rows ``C (B, L, R)`` and ``F (B, L, M)`` in the tableau
    dtype. Pivot t writes ``C[:, t]`` and ``F[:, t]`` in every lane (zeros
    where the lane does not pivot) and reads rows < t only, so the etas
    are never cleared."""

    w: torch.Tensor | None
    C: torch.Tensor
    F: torch.Tensor


def _devex_lanes(w, do, colk, p, h, old_base_k):
    """``solver._devex_update`` in every lane: the leaving variable's
    weight is one scatter a lane; the cap, the NaN reset and the re-anchor
    (a lane's weights to 1 when its max passes 1e8) are the lane's own."""
    R = w.shape[1]
    wh = w.gather(1, h[:, None])
    alpha = (colk / p[:, None]).to(w.dtype)
    w2 = torch.maximum(w, alpha * alpha * wh)
    lv = old_base_k.clamp(max=R - 1).long()[:, None]
    leaving = torch.maximum(wh / (p * p).to(w.dtype)[:, None],
                            torch.ones_like(wh))
    w2 = w2.scatter(1, lv, torch.where(old_base_k[:, None] < R, leaving,
                                       w2.gather(1, lv)))
    w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
    w2 = torch.where(torch.isnan(w2), 1.0, w2)
    w2 = torch.where(w2.amax(dim=1, keepdim=True) > 1e8, 1.0, w2)
    return torch.where(do[:, None], w2, w)


def blocked_pivot(st: BlockedState, t: int, options: SolverOptions,
                  max_iter: int) -> None:
    """Pivot t of a window in every lane RUNNING under its fuse (the body
    of ``solver.solve_loop_blocked``'s window, lane by lane in one pass):
    the entering choice (Dantzig, Bland or devex), the live entering
    column ``T3[i, :, h_i] - C[i, :t, h_i] @ F[i, :t]``, the ratio test,
    the live leaving row ``T3[i, k_i] - F[i, :t, k_i] @ C[i, :t]``, the
    exact b, costs, z, base and devex updates, the eta pair, the status
    and the anticycling state. The eta corrections are products within a
    lane (``bmm``), never sums across lanes, formed in f64 and rounded
    once to the tableau's dtype, as the single-LP loop's kernels form them
    (``kernels.eta.eta_live``): an f32 ``bmm`` rounds as cuBLAS splits the
    batch, so a lane's walk hung on the batch's width, and parted from the
    single-LP loop's. A lane that does not pivot keeps every bit of its
    state. In place, with no host sync."""
    eps = float(options.eps_resolved)
    tabs = st.tabs
    T3 = tabs.T3
    B, M, R = T3.shape
    dev = T3.device
    vd = tabs.costs.dtype
    active = (st.status == RUNNING) & (st.iterations < max_iter)

    iota = torch.arange(R, device=dev)
    masked = torch.where(iota < tabs.r, tabs.costs, torch.inf)
    eligible = masked <= -eps
    if st.w is not None:
        h_main = torch.argmax(torch.where(eligible, masked * masked / st.w,
                                          -torch.inf), dim=1)
    else:
        h_main = torch.argmin(masked, dim=1)
    h_bland = torch.argmin(torch.where(eligible, iota, R), dim=1)
    h = torch.where(st.bland & eligible.any(dim=1), h_bland, h_main)
    minc = masked.gather(1, h[:, None])[:, 0]
    optimal = minc > -eps

    a_h = T3.gather(2, h.view(B, 1, 1).expand(B, M, 1))[:, :, 0]
    if t:
        ch = st.C[:, :t].gather(2, h.view(B, 1, 1).expand(B, t, 1))
        a_h = (a_h.double() - torch.bmm(ch.transpose(1, 2).double(),
                                        st.F[:, :t].double())[:, 0]
               ).to(T3.dtype)
    mask = a_h >= eps
    unbounded = ~mask.any(dim=1)
    k = torch.argmin(torch.where(
        mask, tabs.b / torch.where(mask, a_h, 1.0), torch.inf), dim=1)
    do = active & ~(optimal | unbounded)
    p = torch.where(do, a_h.gather(1, k[:, None])[:, 0], 1.0)
    colk = T3[torch.arange(B, device=dev), k]
    if t:
        fk = st.F[:, :t].gather(2, k.view(B, 1, 1).expand(B, t, 1))
        colk = (colk.double() - torch.bmm(fk.transpose(1, 2).double(),
                                          st.C[:, :t].double())[:, 0]
                ).to(T3.dtype)

    bk = tabs.b.gather(1, k[:, None])[:, 0]
    pv = p.to(vd)
    u = minc / pv
    costs = torch.where(do[:, None], tabs.costs - u[:, None] * colk.to(vd),
                        tabs.costs)
    z = torch.where(do, tabs.z - u * bk, tabs.z)
    is_k = torch.arange(M, device=dev) == k[:, None]
    b = torch.where(do[:, None], torch.where(
        is_k, (bk / pv)[:, None],
        tabs.b - bk[:, None] * (a_h / p[:, None]).to(vd)), tabs.b)
    if st.w is not None:
        st.w = _devex_lanes(st.w, do, colk, p, h,
                            tabs.base.gather(1, k[:, None])[:, 0])
    tabs.base = torch.where(do[:, None] & is_k,
                            h[:, None].to(tabs.base.dtype), tabs.base)
    st.C[:, t] = torch.where(do[:, None], colk, 0.0)
    st.F[:, t] = torch.where(do[:, None], torch.where(
        is_k, (1.0 - 1.0 / p)[:, None], a_h / p[:, None]), 0.0)

    st.stall, st.bland = anticycling_update(
        do, (z - tabs.z).abs() >= eps, st.stall, st.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    st.status = exit_status(active, optimal, unbounded, st.status)
    st.iterations = st.iterations + do.to(torch.int32)
    tabs.b, tabs.costs, tabs.z = b, costs, z


def reprice_lanes(T3: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per lane ``T3[i]^T @ v[i]`` (B, R), accumulated in v's dtype over
    ``REPRICE_ROWS`` rows a product, in row order, the lanes in groups so
    that each widened piece of the tableau stays under
    ``MATVEC_CHUNK_BYTES`` (no widened copy of the whole batch)."""
    B, M, R = T3.shape
    group = max(1, MATVEC_CHUNK_BYTES
                // (REPRICE_ROWS * R * v.element_size()))
    out = torch.zeros((B, R), dtype=v.dtype, device=T3.device)
    for i in range(0, B, group):
        for j in range(0, M, REPRICE_ROWS):
            rows = slice(j, j + REPRICE_ROWS)
            out[i:i + group] += torch.bmm(
                v[i:i + group, None, rows],
                T3[i:i + group, rows].to(v.dtype))[:, 0]
    return out


def blocked_window(st: BlockedState, run: torch.Tensor,
                   options: SolverOptions, max_iter: int, costs0) -> None:
    """One window in every lane: L pivots (``blocked_pivot``), the apply
    ``T3 -= F^T C`` (one ``baddbmm_``; a lane that did not pivot has zero
    etas, so its tableau keeps every bit) and, with ``costs0``, the exact
    re-pricing ``costs0 - cf @ T3`` of the lanes in ``run`` (those RUNNING
    under their fuse when the window began), reopening a lane declared
    OPTIMAL on in-window costs while exact pricing still shows an
    eligible column. A lane outside ``run`` keeps its costs and status."""
    for t in range(st.C.shape[1]):
        blocked_pivot(st, t, options, max_iter)
    tabs = st.tabs
    tabs.T3.baddbmm_(st.F.transpose(1, 2), st.C, alpha=-1.0)
    if costs0 is None:
        return
    exact = costs0 - reprice_lanes(
        tabs.T3, batch_basic_costs(tabs.base, costs0, tabs.r))
    cols = torch.arange(exact.shape[1], device=exact.device)
    vmin = torch.where(cols < tabs.r, exact, torch.inf).amin(dim=1)
    reopen = (run & (st.status == OPTIMAL)
              & (vmin <= -float(options.eps_resolved)))
    st.status = torch.where(reopen, RUNNING, st.status).to(torch.int32)
    tabs.costs = torch.where(run[:, None], exact, tabs.costs)


def solve_loop_blocked_batched(tabs: BatchTableau, options: SolverOptions,
                               max_iter: int, costs0=None, live=None):
    """The plain deferred block-pivot loop for every lane
    (``solver.solve_loop_blocked`` with a lane axis, as ``jax.vmap`` runs
    it in ``simplex_tpu/batch.py:446-450``): windows of L =
    ``block_pivots`` pivots (``blocked_window``) until no lane is RUNNING
    under its fuse. The host reads that count once per window. A lane
    whose loop condition is false when a window begins keeps every bit of
    its state through it; a lane that decides during a window still gets
    that window's apply and re-pricing, as when it runs alone. ``costs0``
    (the phase's pre-elimination costs) re-prices f32 tableaus at every
    window's end, as the single-LP loop does; f64 tableaus are not
    re-priced. Lanes where ``live`` is False start INFEASIBLE and never
    pivot. The ``normalize_costs`` scaling is per lane (``_scaled``). An
    f32 apply on the card needs TF32 off. The tableau is updated in place.
    Returns (tableau, status (B,), iterations (B,), windows); statuses stay
    RUNNING for lanes that hit the fuse."""
    T3 = tabs.T3
    B, M, R = T3.shape
    dev = T3.device
    if T3.dtype == torch.float64:
        costs0 = None
    elif dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the f32 window apply needs IEEE products: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    L = int(options.block_pivots or 1)
    tabs, scale, costs0 = _scaled(tabs, options, costs0)
    devex = options.pivot_rule_resolved == "devex"
    st = BlockedState(
        *_start(tabs, options, live),
        w=torch.ones((B, R), dtype=tabs.costs.dtype, device=dev)
        if devex else None,
        C=torch.zeros((B, L, R), dtype=T3.dtype, device=dev),
        F=torch.zeros((B, L, M), dtype=T3.dtype, device=dev))

    def running() -> torch.Tensor:
        return (st.status == RUNNING) & (st.iterations < max_iter)

    run = running()
    windows = 0
    while bool(run.any()):               # the window's one host read
        blocked_window(st, run, options, max_iter, costs0)
        windows += 1
        run = running()
    return _unscaled(st.tabs, scale), st.status, st.iterations, windows


def solve_device_lanes(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       n: int, m: int, options: SolverOptions):
    """Route (b)'s reference, on no dispatch path: each lane in turn
    through ``two_phase.solve_device_with_binv`` with ``use_pallas=False``
    (``A (B, m, n)``, ``b (B, m)``, ``c (B, n)`` on the solve's device),
    the route until route (b) was batched. Returns
    ``batch.BatchSolveOutput`` with ``windows`` (0, 0) and ``binv`` a list
    of the lanes' slack blocks (None where phase 2 did not run)."""
    from .batch import BatchSolveOutput
    from .two_phase import solve_device_with_binv

    options = dataclasses.replace(options, use_pallas=False)
    outs, binvs = [], []
    for i in range(A.shape[0]):
        out, binv = solve_device_with_binv(A[i], b[i], c[i], n, m, options)
        outs.append(out)
        binvs.append(binv)
    dev = A.device

    def ints(name):
        return torch.tensor([int(getattr(o, name)) for o in outs],
                            dtype=torch.int32, device=dev)

    return BatchSolveOutput(
        status=ints("status"),
        x=torch.stack([o.x for o in outs]),
        objective=torch.tensor([o.objective for o in outs],
                               dtype=torch.float64, device=dev),
        iterations_phase1=ints("iterations_phase1"),
        iterations_phase2=ints("iterations_phase2"),
        n_artificial_in_base=ints("n_artificial_in_base"),
        base=torch.stack([o.base for o in outs]),
        windows=(0, 0), binv=binvs)
