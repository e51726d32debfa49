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
  lane by lane through the single-LP device core with ``use_pallas=False``
  (``two_phase.solve_device_with_binv``, whose loop is
  ``solver.solve_loop_blocked``, the plain loop the JAX vmap runs).

Both return ``batch.BatchSolveOutput``; ``batch.solve_batched`` refines
OPTIMAL lanes on the host as for the kernel path.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import EPS_REL_F32, SolverOptions, Status, normalize_enabled
from .kernels.pivot import batch_rank1
from .solver import SEQ_CHUNK, _exit_status, anticycling_update
from .tableau import BatchTableau

RUNNING = int(Status.RUNNING)


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
    st.status = _exit_status(active, optimal, unbounded, st.status)
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
    B = tabs.b.shape[0]
    dev = tabs.Tt.device
    tabs = dataclasses.replace(tabs)     # the steps rebind its vectors
    scale = None
    if normalize_enabled(options):
        cols = torch.arange(tabs.costs.shape[1], device=dev) < tabs.r
        cmax = torch.where(cols, tabs.costs, 0.0).abs().amax(dim=1)
        scale = torch.clamp(
            (EPS_REL_F32 / float(options.eps_resolved)) * (1.0 + cmax),
            min=1.0).to(tabs.costs.dtype)
        tabs = dataclasses.replace(tabs, costs=tabs.costs / scale[:, None],
                                   z=tabs.z / scale)
    status = torch.full((B,), RUNNING, dtype=torch.int32, device=dev)
    if live is not None:
        status = torch.where(live, status, int(Status.INFEASIBLE)).to(
            torch.int32)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    st = SeqState(tabs, status, zeros, zeros,
                  torch.full((B,), options.pivot_rule_resolved == "bland",
                             device=dev))
    steps = 0

    def running() -> int:
        return int(((st.status == RUNNING)
                    & (st.iterations < max_iter)).sum())

    while running():
        for _ in range(SEQ_CHUNK):
            seq_step(st, options, max_iter)
        steps += SEQ_CHUNK
    out = st.tabs
    if scale is not None:
        out = dataclasses.replace(out, costs=out.costs * scale[:, None],
                                  z=out.z * scale)
    return out, st.status, st.iterations, steps


def solve_device_lanes(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       n: int, m: int, options: SolverOptions):
    """Route (b): each lane through ``two_phase.solve_device_with_binv``
    with ``use_pallas=False`` (``A (B, m, n)``, ``b (B, m)``, ``c (B, n)``
    on the solve's device). Returns ``batch.BatchSolveOutput`` with
    ``windows`` (0, 0) and ``binv`` a list of the lanes' slack blocks
    (None where phase 2 did not run)."""
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
