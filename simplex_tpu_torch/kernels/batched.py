"""Per-lane window and apply passes of the batched solve.

The PyTorch port of ``simplex_tpu/kernels/batched.py`` and
``simplex_tpu/kernels/batched_hbm.py``. The TPU split its lanes between a
VMEM-resident tier and an HBM tier; on the card one design serves both
(``csrc/batched.cu``): ``batch_window`` runs a window of up to L pivots
per lane against the stale tableau in global memory and leaves the eta
factors, and ``batch_apply`` / ``batch_apply_reprice`` fold them into the
tableau, the latter with the window-boundary reprice ``cf @ Tt_new``.

Each pass has, as in ``kernels/blocked.py``:

* a hand-written CUDA kernel (``csrc/batched.cu``, built for sm_90a at
  first use by ``_build``), launched for tensors on the card;
* a plain PyTorch version, vectorised over the lanes, taken for tensors
  on the CPU (the CPU tests) and used by ``chip_smoke.py`` as the
  kernel's reference on the card -- never on the CUDA main path;
* a launch counter in ``LAUNCHES``, raised by one where the wrapper
  launches its kernel and nowhere else.

A wrapper given CUDA tensors launches its kernel or raises.

Layout (B lanes stacked on the leading axis): ``Tt (B*M, R)`` f32;
``costs``, ``c0`` (B, R), ``b``, ``cf`` (B, M) and ``z`` (B,) native f64
(the JAX package's double-f32 pairs existed only because Mosaic has no
f64); ``base (B, M)`` i32; devex weights ``w (B, R)`` f32 or None;
``sci (B, 8)`` i32 [status, iters, stall, bland, active, max_iter,
unused, unused]. The window writes ``C (B*L, R)``, ``F (B*L, M)`` (the
JAX ``Ft`` transposed per lane, the F layout of ``kernels/blocked.py``),
``AH (B*L, M)`` (the live entering columns), ``piv (B*L, 2)`` [h, k] (-1
past the lane's last pivot) and ``nlive (B,)``, the pivots each lane
applied; rows past a lane's ``nlive`` are zero.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import Status
from ..tableau import batch_tt_matvec
from .blocked import (BIG_INDEX, _expect, _on_card, _ptr, _stream,
                      anticycling_update, batch_candidates)

#: The largest window the kernel takes (csrc/batched.cu LMAX).
LMAX = 128

RUNNING = int(Status.RUNNING)

#: Launches of each kernel since the last ``reset_launches``.
LAUNCHES = {"batch_window": 0, "batch_apply": 0, "batch_apply_reprice": 0,
            "batch_reprice": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _dims(Tt, C, F, B: int) -> tuple[int, int, int]:
    """(M, R, L) of a batch of B lanes, with the factors' shapes checked."""
    BM, R = Tt.shape
    if B < 1 or BM % B or C.shape[0] % B:
        raise ValueError(f"Tt {tuple(Tt.shape)} / C {tuple(C.shape)} do "
                         f"not split into {B} lanes")
    M, L = BM // B, C.shape[0] // B
    _expect(Tt, "Tt", torch.float32, (B * M, R))
    _expect(C, "C", torch.float32, (B * L, R))
    _expect(F, "F", torch.float32, (B * L, M))
    if M % 128 or R % 128 or L % 8 or not 8 <= L <= LMAX or B > 65535:
        raise ValueError(f"need M, R multiples of 128, L a multiple of 8 in "
                         f"[8, {LMAX}] and B <= 65535, got M={M} R={R} L={L} "
                         f"B={B}")
    return M, R, L


# ---------------------------------------------------------------------------
# K7 / K8 pivot loop: one window of up to L pivots per lane.

#: Shared memory on sm_90: a block's most (227 KB); the window kernel's
#: fixed header (csrc/batched.cu WIN_SMEM_LIMIT, WIN_HEADER).
BLOCK_SMEM = 232448
WINDOW_HEADER = 2048
#: The cluster sizes the window kernel takes (past 8 a cluster is not
#: portable; the kernel allows it), and its threads a block
#: (csrc/batched.cu WIN_THREADS): at its 128 registers a thread they fill
#: an SM's register file, so one block runs on an SM.
CLUSTERS = (1, 2, 4, 8, 16)
WINDOW_THREADS = 512


class WindowPlan(NamedTuple):
    """How ``batch_window`` spreads a lane: ``cs`` blocks (one
    thread-block cluster), each holding in shared memory its vectors
    (``vec``) and the first ``res_c`` rows of its columns of C and
    ``res_f`` of its columns of F, ``smem`` bytes in all."""
    cs: int
    vec: bool
    res_c: int
    res_f: int
    smem: int


def window_smem_bytes(M: int, R: int, cs: int, devex: bool, vec: bool,
                      res_c: int, res_f: int) -> int:
    """Shared memory of one block of ``batch_window`` (csrc/batched.cu
    ``window_smem_bytes``, which refuses a plan whose count differs): the
    header, then with ``vec`` the block's R / cs columns of costs (f64),
    devex weights and the pivot row (f32) and its M / cs rows of b (f64),
    base, a_h and the entering column (4 bytes each), then its resident
    eta rows."""
    rc, mc = R // cs, M // cs
    n = WINDOW_HEADER + 4 * (rc * res_c + mc * res_f)
    if vec:
        n += rc * (8 + (4 if devex else 0) + 4) + mc * (8 + 4 + 4 + 4)
    return n


def window_plan(B: int, M: int, R: int, L: int, devex: bool,
                sms: int = 132) -> WindowPlan:
    """The one place that decides how ``batch_window`` runs B lanes of M x
    R on a card of ``sms`` SMs (chosen on the card, tools/k7_variants.cu
    and PERF.md). A lane's pivots are a chain of dependent steps, so the
    window takes its waves of lanes times L pivots: the lanes in flight
    should fill the card, and each pivot should be short. One cluster of
    cs blocks runs a lane, one block an SM, so cs is the smallest size
    with B x cs at least 90% of the SMs -- more blocks a lane would only
    add waves -- but no larger than leaves a block WINDOW_THREADS of the
    lane's columns (past that the cluster's folds cost more than the
    block's work saves). A block's 227 KB hold first its vectors, then
    its columns of F's rows, then of C's rows, as many as fit."""
    if M % 128 or R % 128 or not 1 <= L <= LMAX or B < 1 or sms < 1:
        raise ValueError(f"no window plan for B={B} M={M} R={R} L={L}")
    cs = 1
    while (cs < CLUSTERS[-1] and B * cs < 0.9 * sms
           and R // (2 * cs) >= WINDOW_THREADS):
        cs *= 2
    rc, mc = R // cs, M // cs
    vec = window_smem_bytes(M, R, cs, devex, True, 0, 0) <= BLOCK_SMEM
    rem = BLOCK_SMEM - window_smem_bytes(M, R, cs, devex, vec, 0, 0)
    res_f = min(L, rem // (4 * mc))
    res_c = min(L, (rem - 4 * mc * res_f) // (4 * rc))
    return WindowPlan(cs, vec, res_c, res_f,
                      window_smem_bytes(M, R, cs, devex, vec, res_c, res_f))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def batch_window_plain(Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv,
                       nlive, *, r: int, eps: float, bland_static: bool,
                       threshold: int | None) -> None:
    """Plain version of ``batch_window`` (same in-place contract): the L
    pivots in order, each vectorised over the lanes."""
    B, R = costs.shape
    M = b.shape[1]
    L = C.shape[0] // B
    dev = Tt.device
    T3 = Tt.view(B, M, R)
    C3, F3, AH3 = C.view(B, L, R), F.view(B, L, M), AH.view(B, L, M)
    piv3 = piv.view(B, L, 2)
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(M, device=dev)
    cols = torch.arange(R, device=dev)
    status, iters, stall, bland = (sci[:, i].clone() for i in range(4))
    active0 = sci[:, 4] != 0
    max_iter = sci[:, 5]
    applied = torch.zeros(B, dtype=torch.int32, device=dev)
    h_d, v_d, h_b, v_b = batch_candidates(costs, w, r, eps)
    for t in range(L):
        active = active0 & (status == RUNNING) & (iters < max_iter)
        use_b = (bland != 0) & (h_b < BIG_INDEX)
        h = torch.where(use_b, h_b, h_d)
        minc = torch.where(use_b, v_b, v_d)
        optimal = minc > -eps
        ah = T3[lanes, :, h]
        if t:
            ah = ah - torch.einsum("bs,bsm->bm", C3[lanes, :t, h], F3[:, :t])
        mask = ah >= eps
        q = torch.where(mask, b / torch.where(mask, ah, 1.0).double(),
                        torch.inf)
        k = torch.argmin(q, dim=1)
        unbounded = ~mask.any(dim=1)
        do = active & ~(optimal | unbounded)
        p = torch.where(do, ah[lanes, k], 1.0)
        p64 = p.double()
        bk = b[lanes, k]
        u = torch.where(do, minc / p64, 0.0)
        colk = T3[lanes, k]
        if t:
            colk = colk - torch.einsum("bs,bsr->br", F3[lanes, :t, k],
                                       C3[:, :t])
        d1 = do[:, None]
        C3[:, t] = torch.where(d1, colk, 0.0)
        AH3[:, t] = torch.where(d1, ah, 0.0)
        costs.copy_(torch.where(d1, costs - u[:, None] * colk.double(),
                                costs))
        if w is not None:
            wh = w[lanes, h]
            lvar = base[lanes, k]                # before base changes
            alpha = colk / p[:, None]
            w2 = torch.maximum(w, alpha * alpha * wh[:, None])
            lead = torch.maximum(wh / (p * p), torch.ones_like(wh))
            w2 = torch.where(cols == lvar[:, None], lead[:, None], w2)
            w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
            w2 = torch.where(torch.isnan(w2), 1.0, w2)
            w.copy_(torch.where(d1, w2, w))
        is_k = rows == k[:, None]
        F3[:, t] = torch.where(
            d1, torch.where(is_k, 1.0 - 1.0 / p[:, None], ah / p[:, None]),
            0.0)
        b.copy_(torch.where(d1, torch.where(
            is_k, (bk / p64)[:, None],
            b - bk[:, None] * (ah.double() / p64[:, None])), b))
        base.copy_(torch.where(d1 & is_k, h[:, None].to(torch.int32), base))
        cf.copy_(torch.where(d1 & is_k, c0[lanes, h][:, None], cf))
        ub = u * bk
        z.copy_(torch.where(do, z - ub, z))
        status = torch.where(active, torch.where(
            optimal, int(Status.OPTIMAL),
            torch.where(unbounded, int(Status.UNBOUNDED), RUNNING)),
            status).to(torch.int32)
        stall, bl = anticycling_update(do, ub.abs() >= eps, stall, bland,
                                       bland_static=bland_static,
                                       threshold=threshold)
        bland = bl.to(torch.int32)
        iters = iters + do.to(torch.int32)
        applied = applied + do.to(torch.int32)
        piv3[:, t] = torch.where(d1, torch.stack([h, k], dim=1), -1)
        h_d, v_d, h_b, v_b = batch_candidates(costs, w, r, eps)
    for i, v in enumerate((status, iters, stall, bland)):
        sci[:, i] = v
    nlive.copy_(applied)


def batch_window(Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv, nlive,
                 *, r: int, eps: float, bland_static: bool,
                 threshold: int | None) -> None:
    """K7's pivot loop and K8, the port of the window of
    ``simplex_tpu.kernels.batched.batch_window_pass`` and of
    ``simplex_tpu.kernels.batched_hbm.hbm_window_pass``.

    Per lane with ``sci`` active, up to L pivots in order, each stopped
    by the lane's fuse (``iters < max_iter``): the entering column h (the
    Bland candidate while the lane is in Bland mode, else the Dantzig or,
    with ``w``, the devex candidate; optimal when its cost > -eps); the
    live column ``a_h = Tt[:, h] - C[:t, h] @ F[:t]`` and the ratio test
    over ``a_h >= eps`` (f64 quotient, ties to the lowest row; unbounded
    when none); the pivot row ``colk = Tt[k] - F[:t, k] @ C[:t]``; then,
    in f64, ``costs -= (cost_h / p) colk``, ``b -= b_k a_h / p`` with
    ``b_k / p`` at k, ``z -= (cost_h / p) b_k``; the devex weights,
    ``base[k] = h``, ``cf[k] = c0[h]`` and the stall / Bland policy.
    Updates ``costs b z base w sci[:, :4] cf`` in place and writes ``C F
    AH piv nlive``. ``Tt`` is only read. ``threshold`` None never enters
    Bland mode. On the card one thread-block cluster runs each lane, as
    ``window_plan`` decides; every plan gives the same bits."""
    B = costs.shape[0]
    M, R, L = _dims(Tt, C, F, B)
    _expect(costs, "costs", torch.float64, (B, R))
    for name, x in (("b", b), ("cf", cf)):
        _expect(x, name, torch.float64, (B, M))
    _expect(c0, "c0", torch.float64, (B, R))
    _expect(z, "z", torch.float64, (B,))
    _expect(base, "base", torch.int32, (B, M))
    _expect(sci, "sci", torch.int32, (B, 8))
    _expect(AH, "AH", torch.float32, (B * L, M))
    _expect(piv, "piv", torch.int32, (B * L, 2))
    _expect(nlive, "nlive", torch.int32, (B,))
    if w is not None:
        _expect(w, "w", torch.float32, (B, R))
    kw = dict(r=r, eps=eps, bland_static=bland_static, threshold=threshold)
    args = (Tt, costs, b, z, base, w, sci, c0, cf, C, F, AH, piv, nlive)
    if not _on_card(*args):
        batch_window_plain(*args, **kw)
        return

    from ._build import check, load_library

    lib = load_library()
    plan = window_plan(B, M, R, L, w is not None,
                       _sm_count(Tt.device.index))
    err = lib.batch_window_launch(
        *(_ptr(x) for x in args), B, M, R, L, r, float(eps),
        int(bland_static), -1 if threshold is None else int(threshold),
        plan.cs, int(plan.vec), plan.res_c, plan.res_f, plan.smem,
        _stream(Tt))
    check(lib, err, "batch_window")
    LAUNCHES["batch_window"] += 1


def window_replay(Tt, state: dict, C, F, AH, piv, nlive) -> dict:
    """The formulas of a window on its own f32 operands, for checks.

    ``state`` holds the window's inputs (``costs b z base w c0 cf``, as
    ``batch_window`` takes them; ``w`` may be None); ``C F AH piv nlive``
    are the window's outputs. Each lane's walk ``piv`` is replayed pivot
    by pivot from the inputs, every value recomputed from the window's own
    earlier rows: in f64, ``colk = Tt[k] - F[:t, k] @ C[:t]`` and ``a_h =
    Tt[:, h] - C[:t, h] @ F[:t]`` (which ``C[t]`` and ``AH[t]`` must match
    to f32 round-off of their terms, returned as ``C_terms`` and
    ``AH_terms``, the summed magnitudes); in f32, the eta row ``F[t]``
    from ``AH[t]`` and ``p = AH[t, k]`` and the devex weights from
    ``C[t]``; in f64, ``u = costs[h] / p``, ``costs -= u C[t]``, ``b -=
    b[k] AH[t] / p`` with ``b[k] / p`` at k, ``z -= u b[k]``; and ``base[k]
    = h``, ``cf[k] = c0[h]``. Returns a dict of those arrays; the inputs
    are not changed. Rows past a lane's ``nlive`` are left zero."""
    out = {k: None if state.get(k) is None else state[k].clone()
           for k in ("costs", "b", "z", "base", "w", "cf")}
    costs, b, z, base, w, cf = (out[k] for k in
                                ("costs", "b", "z", "base", "w", "cf"))
    c0 = state["c0"]
    B, M = b.shape
    R = costs.shape[1]
    L = C.shape[0] // B
    f64 = torch.float64
    T3 = Tt.view(B, M, R)
    C3, F3, AH3 = C.view(B, L, R), F.view(B, L, M), AH.view(B, L, M)
    piv3 = piv.view(B, L, 2).long()
    lanes = torch.arange(B, device=b.device)
    rows = torch.arange(M, device=b.device)
    cols = torch.arange(R, device=b.device)
    for name, width in (("C", R), ("AH", M)):
        out[name] = torch.zeros((B, L, width), dtype=f64, device=b.device)
        out[name + "_terms"] = torch.zeros_like(out[name])
    out["F"] = torch.zeros_like(F3)
    for t in range(L):
        do = (t < nlive)[:, None]
        h, k = piv3[:, t, 0].clamp(min=0), piv3[:, t, 1].clamp(min=0)
        colk = T3[lanes, k].double()
        ah = T3[lanes, :, h].double()
        colk_t, ah_t = colk.abs(), ah.abs()
        if t:
            fk, ch = F3[lanes, :t, k].double(), C3[lanes, :t, h].double()
            Ct, Ft = C3[:, :t].double(), F3[:, :t].double()
            colk = colk - torch.einsum("bs,bsr->br", fk, Ct)
            ah = ah - torch.einsum("bs,bsm->bm", ch, Ft)
            colk_t = colk_t + torch.einsum("bs,bsr->br", fk.abs(), Ct.abs())
            ah_t = ah_t + torch.einsum("bs,bsm->bm", ch.abs(), Ft.abs())
        for name, x in (("C", colk), ("C_terms", colk_t), ("AH", ah),
                        ("AH_terms", ah_t)):
            out[name][:, t] = torch.where(do, x, 0.0)
        p32 = AH3[lanes, t, k]
        p = p32.double()
        is_k = rows == k[:, None]
        out["F"][:, t] = torch.where(do, torch.where(
            is_k, 1.0 - 1.0 / p32[:, None], AH3[:, t] / p32[:, None]), 0.0)
        if w is not None:
            wh = w[lanes, h]
            alpha = C3[:, t] / p32[:, None]
            w2 = torch.maximum(w, alpha * alpha * wh[:, None])
            lead = torch.maximum(wh / (p32 * p32), torch.ones_like(wh))
            w2 = torch.where(cols == base[lanes, k][:, None], lead[:, None],
                             w2)
            w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
            w.copy_(torch.where(do, torch.where(torch.isnan(w2), 1.0, w2),
                                w))
        u = costs[lanes, h] / p
        bk = b[lanes, k]
        costs.copy_(torch.where(do, costs - u[:, None] * C3[:, t].double(),
                                costs))
        b.copy_(torch.where(do, torch.where(
            is_k, (bk / p)[:, None],
            b - bk[:, None] * (AH3[:, t].double() / p[:, None])), b))
        z.copy_(torch.where(do[:, 0], z - u * bk, z))
        base.copy_(torch.where(do & is_k, h[:, None].to(base.dtype), base))
        cf.copy_(torch.where(do & is_k, c0[lanes, h][:, None], cf))
    return out


# ---------------------------------------------------------------------------
# K9 / K10: per-lane window apply, with or without the fused reprice.

def _lanes(Tt, F) -> int:
    """B from Tt (B*M, R) and F (B*L, M)."""
    M = F.shape[1]
    if M == 0 or Tt.shape[0] % M:
        raise ValueError(f"Tt {tuple(Tt.shape)} does not stack lanes of "
                         f"M={M} rows")
    return Tt.shape[0] // M


def batch_apply_plain(Tt, C, F, nlive) -> None:
    """Plain version of ``batch_apply``. ``nlive`` only bounds the
    kernel's work (the eta rows past it are zero), so it is not read."""
    B = _lanes(Tt, F)
    M, R = F.shape[1], Tt.shape[1]
    L = C.shape[0] // B
    Tt.view(B, M, R).baddbmm_(F.view(B, L, M).transpose(1, 2),
                              C.view(B, L, R), alpha=-1.0)


def batch_apply(Tt, C, F, nlive) -> None:
    """K10, the port of ``simplex_tpu.kernels.batched_hbm.hbm_apply_pass``
    (and of the apply of ``batch_window_pass`` without fuse_reprice):
    ``Tt -= F^T @ C`` per lane, in place, IEEE f32. ``nlive (B,)`` i32 is
    the count of each lane's live eta rows (the rows past it must be
    zero): the kernel runs only those, and a lane with none keeps its
    tableau untouched."""
    B = _lanes(Tt, F)
    _dims(Tt, C, F, B)
    _expect(nlive, "nlive", torch.int32, (B,))
    if not _on_card(Tt, C, F, nlive):
        batch_apply_plain(Tt, C, F, nlive)
        return

    from ._build import check, load_library

    lib = load_library()
    M, R = F.shape[1], Tt.shape[1]
    err = lib.batch_apply_launch(_ptr(Tt), _ptr(F), _ptr(C), B, M, R,
                                 C.shape[0] // B, _ptr(nlive), _stream(Tt))
    check(lib, err, "batch_apply")
    LAUNCHES["batch_apply"] += 1


def batch_apply_reprice_plain(Tt, C, F, cf, do_r, nlive):
    """Plain version of ``batch_apply_reprice``."""
    batch_apply_plain(Tt, C, F, nlive)
    B, M = cf.shape
    mv = batch_tt_matvec(Tt.view(B, M, Tt.shape[1]), cf)
    return torch.where(do_r[:, None] != 0, mv, 0.0)


def batch_apply_reprice(Tt, C, F, cf, do_r, nlive):
    """K9, the port of
    ``simplex_tpu.kernels.batched_hbm.hbm_apply_reprice_pass`` (and of
    the fused apply and reprice fold of ``batch_window_pass``):
    ``batch_apply``, then per lane with ``do_r`` set the reprice ``mv =
    cf @ Tt_new`` accumulated in f64 (``cf (B, M)`` f64). Returns mv (B,
    R) f64, zero for the lanes whose ``do_r (B,)`` i32 is 0."""
    B = _lanes(Tt, F)
    M, R, L = _dims(Tt, C, F, B)
    _expect(cf, "cf", torch.float64, (B, M))
    _expect(do_r, "do_r", torch.int32, (B,))
    _expect(nlive, "nlive", torch.int32, (B,))
    if not _on_card(Tt, C, F, cf, do_r, nlive):
        return batch_apply_reprice_plain(Tt, C, F, cf, do_r, nlive)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    part = torch.empty((B, M // 128, R), dtype=torch.float64, device=dev)
    mv = torch.empty((B, R), dtype=torch.float64, device=dev)
    err = lib.batch_apply_reprice_launch(
        _ptr(Tt), _ptr(F), _ptr(C), B, M, R, L, _ptr(nlive), _ptr(do_r),
        _ptr(cf), _ptr(part), _ptr(mv), _stream(Tt))
    check(lib, err, "batch_apply_reprice")
    LAUNCHES["batch_apply_reprice"] += 1
    return mv


# ---------------------------------------------------------------------------
# K12: the standalone per-lane reprice.

def batch_reprice_plain(Tt, cf, flags):
    """Plain version of ``batch_reprice``."""
    B, M = cf.shape
    mv = batch_tt_matvec(Tt.view(B, M, Tt.shape[1]), cf)
    return torch.where(flags[:, None] != 0, mv, 0.0)


def batch_reprice(Tt, cf, flags):
    """K12, the port of ``simplex_tpu.kernels.batched.
    batch_reprice_pass``: per lane with ``flags (B,)`` i32 set, ``mv =
    cf @ Tt`` accumulated in f64 over the lane's tableau, Tt (B*M, R) f32
    with M and R multiples of 128, cf (B, M) f64 (the JAX pass took and
    returned double-f32 pairs). Returns mv (B, R) f64, zero for the lanes
    whose flag is 0. No solve path launches it, as in the JAX package:
    ``batch_apply_reprice`` with no live eta row gives the same mv bit for
    bit."""
    B, M = cf.shape
    R = Tt.shape[1]
    _expect(Tt, "Tt", torch.float32, (B * M, R))
    _expect(cf, "cf", torch.float64, (B, M))
    _expect(flags, "flags", torch.int32, (B,))
    if M % 128 or R % 128 or not 1 <= B <= 65535:
        raise ValueError(f"need M, R multiples of 128 and 1 <= B <= 65535, "
                         f"got M={M} R={R} B={B}")
    if not _on_card(Tt, cf, flags):
        return batch_reprice_plain(Tt, cf, flags)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    part = torch.empty((B, M // 128, R), dtype=torch.float64, device=dev)
    mv = torch.empty((B, R), dtype=torch.float64, device=dev)
    err = lib.batch_reprice_launch(_ptr(Tt), B, M, R, _ptr(flags), _ptr(cf),
                                   _ptr(part), _ptr(mv), _stream(Tt))
    check(lib, err, "batch_reprice")
    LAUNCHES["batch_reprice"] += 1
    return mv
