"""Per-pivot and per-window passes of the deferred block-pivot loop.

The PyTorch port of ``simplex_tpu/kernels/blocked.py``. Each pass has

* a hand-written CUDA kernel (``csrc/blocked.cu``, built for sm_90a at
  first use by ``_build``), launched for tensors on the card;
* a plain PyTorch version of the same function, taken for tensors on the
  CPU (the CPU tests) and used by ``chip_smoke.py`` as the kernel's
  reference on the card -- never on the CUDA main path;
* a launch counter in ``LAUNCHES``, raised by one where the wrapper
  launches its kernel and nowhere else.

A wrapper given a CUDA tensor launches its kernel or raises: there is no
fallback to the plain version. Kernels run on PyTorch's current stream,
so the scratch a wrapper allocates may be freed when it returns: the
caching allocator hands a freed block only to work enqueued later on
that stream.

Layout: ``Tt (M, R)`` is the stale transposed tableau (f32, M = padded
constraints, R = padded variables, both multiples of 128); ``C (L, R)``
and ``F (L, M)`` are the window's eta factors (f32; row s belongs to
pivot s; only rows ``s < t`` are live at window fill ``t``). The vectors
b, costs and the reprice coefficients are native f64: the JAX package
carried them as double-f32 (hi, lo) pairs only because Mosaic has no
f64. Scalars that the loop keeps on the device (h, k, p, bk, u, the do
flag) are 0-dim tensors; ``t``, ``r`` and ``eps`` are host values.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import Status
from ..tableau import tt_matvec

#: Sentinel index: no eligible row / column.
BIG_INDEX = 2 ** 31 - 1

#: Constraints per block of K1 (csrc/blocked.cu AHR_COLS).
AHR_COLS = 64
#: Columns per R block of K2 (csrc/blocked.cu COLK_COLS).
COLK_COLS = 64
#: Tile edge of the window apply (csrc/blocked.cu AT).
APPLY_TILE = 128

#: Launches of each kernel since the last ``reset_launches``. A step run
#: as the tail (or head) of another kernel (``TAILS``) counts the launches
#: of the kernel that carries it: no node of its own.
LAUNCHES = {"ah_ratio": 0, "colk_costs": 0, "apply_reprice": 0,
            "apply_window": 0, "ah": 0, "reprice": 0, "step_pre": 0,
            "step_mid_tail": 0, "step_post_tail": 0, "sharded_step_pre": 0,
            "sharded_ratio": 0, "sharded_pack": 0, "sharded_fold": 0,
            "sharded_post_tail": 0, "sharded_pack_tail": 0,
            "sharded_fold_head": 0}
#: The tails (and K5's head) and the kernel each rides in.
TAILS = {"step_mid_tail": "ah_ratio", "step_post_tail": "colk_costs",
         "sharded_post_tail": "colk_costs", "sharded_pack_tail": "colk_costs",
         "sharded_fold_head": "ah"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CapturedLaunches:
    """Launch counts for a CUDA graph, in the counter tables given (this
    module's ``LAUNCHES`` when none). Around a capture it takes back what
    the wrappers counted while capturing (a capture runs nothing) and keeps
    it as the graph's own launches, ``per_replay`` by kernel name;
    ``replayed`` adds those once a replay."""

    def __init__(self, *tables: dict) -> None:
        self.tables = tables or (LAUNCHES,)

    def __enter__(self) -> "CapturedLaunches":
        self._before = [dict(t) for t in self.tables]
        return self

    def __exit__(self, *exc) -> None:
        self._per = [{name: t[name] - before[name] for name in t}
                     for t, before in zip(self.tables, self._before)]
        for t, before in zip(self.tables, self._before):
            t.update(before)
        self.per_replay = {name: n for per in self._per
                           for name, n in per.items()}

    def replayed(self) -> None:
        for t, per in zip(self.tables, self._per):
            for name, n in per.items():
                t[name] += n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ptr(x: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type."""
    kinds = {x.device.type for x in tensors if x is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(kinds)}: the passes take all-CPU "
                     "or all-CUDA operands")


def _expect(x: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def _check_factors(Tt, C, F) -> tuple[int, int, int]:
    M, R = Tt.shape
    L = C.shape[0]
    _expect(Tt, "Tt", torch.float32, (M, R))
    _expect(C, "C", torch.float32, (L, R))
    _expect(F, "F", torch.float32, (L, M))
    if M % APPLY_TILE or R % APPLY_TILE or L % 8:
        raise ValueError(f"need M, R multiples of {APPLY_TILE} and L of 8, "
                         f"got M={M} R={R} L={L}")
    return M, R, L


def _check_workspace(ws: torch.Tensor, nbytes: int, dev,
                     what: str) -> None:
    if (ws.dtype != torch.uint8 or not ws.is_contiguous()
            or ws.device != dev or ws.numel() < nbytes):
        raise ValueError(f"ws: want a {what} on {dev}, got {ws.dtype} "
                         f"({ws.numel()},) on {ws.device}")


def _index(x: torch.Tensor, i: torch.Tensor, hi: int) -> torch.Tensor:
    """x[min(i, hi)] as a 0-dim tensor, without a host sync."""
    return x.index_select(0, i.long().clamp(max=hi).view(1)).view(())


# ---------------------------------------------------------------------------
# Entering candidates over cost vectors (shared by K2's and batch_window's
# plain versions and the loops' window-boundary re-pricing).

def batch_candidates(costs: torch.Tensor, w: torch.Tensor | None, r: int,
                     eps: float):
    """(h_d, v_d, h_b, v_b), each (B,), over the f64 ``costs (B, R)`` of
    the active columns ``j < r``, lane by lane: the main candidate is the
    Dantzig argmin (``w`` None) or the devex argmax of cost^2 / w over
    eligible columns (cost <= -eps); the Bland candidate is the lowest
    eligible index (``BIG_INDEX`` when none). Ties go to the lowest
    index. With no eligible column the devex candidate is (0, inf) and
    the Bland value inf."""
    R = costs.shape[1]
    iota = torch.arange(R, device=costs.device)
    masked = torch.where(iota < r, costs, torch.inf)
    eligible = masked <= -eps
    if w is not None:
        score = torch.where(eligible, masked * masked / w.double(),
                            -torch.inf)
        h_d = torch.argmax(score, dim=1)
        v_d = torch.where(eligible.any(dim=1),
                          costs.gather(1, h_d[:, None])[:, 0], torch.inf)
    else:
        h_d = torch.argmin(masked, dim=1)
        v_d = masked.gather(1, h_d[:, None])[:, 0]
    h_b = torch.where(eligible, iota, BIG_INDEX).min(dim=1).values
    v_b = torch.where(h_b < BIG_INDEX,
                      costs.gather(1, h_b.clamp(max=R - 1)[:, None])[:, 0],
                      torch.inf)
    return h_d, v_d, h_b, v_b


def entering_candidates(costs: torch.Tensor, w: torch.Tensor | None,
                        r: int, eps: float):
    """``batch_candidates`` of one cost vector: (h_d, v_d, h_b, v_b) as
    0-dim tensors, the indices int32."""
    h_d, v_d, h_b, v_b = batch_candidates(
        costs[None], None if w is None else w[None], r, eps)
    return (h_d[0].to(torch.int32), v_d[0], h_b[0].to(torch.int32), v_b[0])


# ---------------------------------------------------------------------------
# K1: live entering column + min-ratio test.

def ah_ratio_plain(Tt, F, C, b, h, t: int, eps: float):
    """Plain version of ``ah_ratio``."""
    M = Tt.shape[0]
    ah = ah_plain(Tt, F, C, h, t)
    mask = ah >= eps
    q = torch.where(mask, b / torch.where(mask, ah, 1.0).double(),
                    torch.inf)
    k = torch.argmin(q)
    unb = ~mask.any()
    return (ah,
            torch.where(unb, BIG_INDEX, k).to(torch.int32),
            torch.where(unb, 0.0, _index(ah, k, M - 1)),
            torch.where(unb, 0.0, _index(b, k, M - 1)),
            unb.to(torch.int32))


def ah_ratio_workspace_bytes(M: int) -> int:
    """Bytes of K1's workspace for ``M`` constraints (csrc/blocked.cu
    ``ahr_ws_bytes``): the arrival counter (8 bytes), then per block of
    ``AHR_COLS`` constraints one partial of three f64 and one int32."""
    return 8 + 28 * _cdiv(M, AHR_COLS)


def ah_ratio_workspace(M: int, device) -> torch.Tensor:
    """A zeroed workspace for ``ah_ratio`` over ``M`` constraints on
    ``device``: the partials of its blocks and the arrival counter that
    finds the last block. Each call leaves the counter at 0 again, so a
    loop allocates one and passes it to every call; calls that share one
    must run in order on one stream. The plain path leaves it untouched."""
    return torch.zeros(ah_ratio_workspace_bytes(M), dtype=torch.uint8,
                       device=device)


def _into(out, got):
    """Copy each of ``got`` into its buffer in ``out``; returns ``out``."""
    for dst, src in zip(out, got):
        dst.copy_(src)
    return out


def ah_ratio(Tt, F, C, b, h, t: int, eps: float, ws=None, out=None):
    """K1, the port of ``simplex_tpu.kernels.blocked.ah_ratio_pass``.

    Live entering column ``a_h = Tt[:, h] - C[:t, h] @ F[:t]`` and the
    min-ratio test over ``a_h >= eps``: the smallest ``b / a_h`` (f64),
    ties to the lowest index. Returns ``(a_h (M,) f32, k i32, p = a_h[k]
    f32, bk = b[k] f64, unbounded i32)``; with no eligible row k is
    ``BIG_INDEX``, p and bk are 0 and unbounded is 1. ``ws`` is an
    ``ah_ratio_workspace``; on the card a call without one allocates
    one. ``out``, when given, holds five tensors of those dtypes and
    shapes that the results are written into and returned: a call that
    allocates nothing, as a CUDA graph needs."""
    return _ah_ratio(Tt, F, C, b, h, t, eps, ws, out, None)


def _ah_ratio(Tt, F, C, b, h, t, eps, ws, out, s):
    """K1, with the step between K1 and K2 as its tail on the scalars
    ``s`` unless None."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(b, "b", torch.float64, (M,))
    _expect(h, "h", torch.int32, ())
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if ws is not None:
        _check_workspace(ws, ah_ratio_workspace_bytes(M), Tt.device,
                         f"ah_ratio_workspace({M})")
    if out is not None:
        for x, name, dt, shape in zip(
                out, ("a_h", "k", "p", "bk", "unbounded"),
                (torch.float32, torch.int32, torch.float32, torch.float64,
                 torch.int32), ((M,), (), (), (), ())):
            _expect(x, f"out {name}", dt, shape)
    if not _on_card(Tt, F, C, b, h):
        got = ah_ratio_plain(Tt, F, C, b, h, t, eps)
        out = got if out is None else _into(out, got)
        if s is not None:
            step_mid_plain(s)
        return out

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    if ws is None:
        ws = ah_ratio_workspace(M, dev)
    if out is None:
        # Three allocations: a_h, (k, p's bits, unbounded) int32, and bk.
        ints = torch.empty(3, dtype=torch.int32, device=dev)
        k, p_bits, unb = ints.unbind()
        out = (torch.empty(M, dtype=torch.float32, device=dev), k,
               p_bits.view(torch.float32),
               torch.empty((), dtype=torch.float64, device=dev), unb)
    ah, k, p, bk, unb = out
    err = lib.ah_ratio_launch(
        _ptr(Tt), _ptr(F), _ptr(C), _ptr(b), _ptr(h), t, M, R, float(eps),
        _ptr(ah), _ptr(ws), ws.numel(), _ptr(k), _ptr(p), _ptr(bk),
        _ptr(unb), None if s is None else ctypes.byref(_step_ptrs(s)),
        _stream(Tt))
    check(lib, err, "ah_ratio")
    LAUNCHES["ah_ratio"] += 1
    if s is not None:
        LAUNCHES["step_mid_tail"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: the live entering column alone (the sharded loop's M side).

def ah_plain(Tt, F, C, h, t: int):
    """Plain version of ``ah`` (and the column of ``ah_ratio_plain``)."""
    M, R = Tt.shape
    hc = h.long().clamp(max=R - 1).view(1)
    ah = Tt.index_select(1, hc).view(M)
    if t:
        ah = ah - C[:t].index_select(1, hc).view(t) @ F[:t]
    return ah


def ah(Tt, F, C, h, t: int, own=None, out=None):
    """K5, the port of ``simplex_tpu.kernels.blocked.ah_pass``.

    The live entering column ``a_h = Tt[:, h] - C[:t, h] @ F[:t]`` (M,)
    f32, h a 0-dim int32 column of ``Tt`` (clamped into range), ``t`` the
    live eta rows. On the card it runs K1's kernel without its ratio test,
    so K1 and K5 give the same column bit for bit. The sharded loop
    calls it on each rank's slice and sums the owner's column across the
    ranks before its ratio test: ``own``, a 0-dim bool, says whether this
    rank owns h, and where it does not the column is zeros (its share of
    the sum). ``out``, an (M,) f32 tensor, receives the column and is
    returned: a call that allocates nothing, as a CUDA graph needs."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(h, "h", torch.int32, ())
    if own is not None:
        _expect(own, "own", torch.bool, ())
    if out is not None:
        _expect(out, "out", torch.float32, (M,))
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if not _on_card(Tt, F, C, h, own, out):
        got = ah_plain(Tt, F, C, h, t)
        if own is not None:
            got = torch.where(own, got, 0.0)
        return got if out is None else out.copy_(got)

    from ._build import check, load_library

    lib = load_library()
    if out is None:
        out = torch.empty(M, dtype=torch.float32, device=Tt.device)
    err = lib.ah_launch(_ptr(Tt), _ptr(F), _ptr(C), _ptr(h), _ptr(own), t,
                        M, R, _ptr(out), _stream(Tt))
    check(lib, err, "ah")
    LAUNCHES["ah"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: pivot row, cost / b / base / eta-row / devex updates, next candidates.

def colk_costs_plain(Tt, C, F, costs, k, t: int, u, do, r: int, eps: float,
                     ah, b, base, h, p, bk, w=None, offset: int = 0,
                     w_h=None):
    """Plain version of ``colk_costs`` (same in-place contract)."""
    M, R = Tt.shape
    kc = k.long().clamp(max=M - 1).view(1)
    lvar = base.index_select(0, kc)             # read before base changes
    colk = Tt.index_select(0, kc).view(R)
    if t:
        colk = colk - F[:t].index_select(1, kc).view(t) @ C[:t]
    C[t] = torch.where(do, colk, 0.0)
    costs.copy_(torch.where(do, costs - u * colk.double(), costs))

    is_k = torch.arange(M, device=Tt.device) == kc
    v = torch.where(is_k, 1.0 - 1.0 / p, ah / p)
    F[t] = torch.where(do, v, 0.0)
    p64 = p.double()
    b.copy_(torch.where(do, torch.where(is_k, bk / p64,
                                        b - bk * (ah.double() / p64)), b))
    base.copy_(torch.where(do & is_k, h, base))

    if w is not None:
        wh = _index(w, h, R - 1) if w_h is None else w_h
        alpha = colk / p
        w2 = torch.maximum(w, alpha * alpha * wh)
        is_l = torch.arange(R, device=Tt.device) + offset == lvar
        w2 = torch.where(is_l, torch.maximum(wh / (p * p),
                                             torch.ones_like(wh)), w2)
        w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
        w2 = torch.where(torch.isnan(w2), 1.0, w2)
        w.copy_(torch.where(do, w2, w))
    return entering_candidates(costs, w, r, eps)


def colk_workspace_bytes(R: int) -> int:
    """Bytes of K2's workspace for ``R`` columns (csrc/blocked.cu
    ``colk_ws_bytes``): the arrival counter and a stashed weight (16
    bytes), then per R block of ``COLK_COLS`` columns one partial of
    three f64 and two int32."""
    return 16 + 32 * _cdiv(R, COLK_COLS)


def colk_workspace(R: int, device) -> torch.Tensor:
    """A zeroed workspace for ``colk_costs`` over ``R`` columns on
    ``device``: the partials of its blocks and the arrival counter that
    finds the last block. Each call leaves the counter at 0 again, so a
    loop allocates one and passes it to every call; calls that share one
    must run in order on one stream. The plain path ignores it."""
    return torch.zeros(colk_workspace_bytes(R), dtype=torch.uint8,
                       device=device)


def colk_costs(Tt, C, F, costs, k, t: int, u, do, r: int, eps: float,
               ah, b, base, h, p, bk, w=None, ws=None, out=None,
               offset: int = 0, w_h=None):
    """K2, the port of ``simplex_tpu.kernels.blocked.colk_costs_pass``
    with ``bf`` and optionally ``devex``.

    With ``do`` true: ``colk = Tt[k] - F[:t, k] @ C[:t]`` is written into
    ``C[t]``; ``costs -= u * colk`` (f64); ``b -= bk * (a_h / p)`` with
    ``b[k] = bk / p`` (f64); ``base[k] = h``; the eta row ``a_h / p``
    with ``1 - 1/p`` at k is written into ``F[t]``; under devex (``w``
    given) the weights are updated with ``alpha = colk / p`` and the
    leaving variable ``base[k]`` gets ``max(w[h] / p^2, 1)``, capped at
    1e12 with NaN reset to 1. With ``do`` false, ``C[t]`` and ``F[t]``
    become zero and nothing else changes. Updates in place and returns
    the next candidates over the (updated) costs, as
    ``entering_candidates``. ``k`` may be ``BIG_INDEX`` (unbounded; then
    ``do`` is false) and is clamped into range. ``ws`` is a
    ``colk_workspace``; on the card a call without one allocates one.
    ``out``, when given, holds the four candidates' 0-dim tensors (int32,
    f64, int32, f64) that they are written into and returned.

    On a slice of the sharded loop the columns of ``Tt``, C, the costs
    and ``w`` are the global columns ``offset .. offset + R - 1``: h and
    ``base`` hold global columns, the devex stage updates the leaving
    variable's and h's weights only where the slice holds them, and
    ``w_h`` (0-dim f32), the weight at h that the candidate fold carries,
    stands for ``w[h]``. The candidates are the slice's, as local
    columns below ``r``. With offset 0 and no ``w_h`` it is the
    single-card pass."""
    return _colk_costs(Tt, C, F, costs, k, t, u, do, r, eps, ah, b, base, h,
                       p, bk, w, ws, out, offset, w_h)


def _colk_costs(Tt, C, F, costs, k, t, u, do, r, eps, ah, b, base, h, p, bk,
                w, ws, out, offset, w_h, s=None, max_iter=0,
                bland_static=False, threshold=None, then_pre=False,
                tail="step_post_tail", send=None):
    """K2, with the step after K2 as its tail on the scalars ``s`` under
    that policy unless ``s`` is None; the tail counts under ``tail``. With
    ``send`` = (send_v, send_i) and ``s`` the sharded pack follows the
    tail, counted under ``sharded_pack_tail``."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(costs, "costs", torch.float64, (R,))
    _expect(ah, "ah", torch.float32, (M,))
    _expect(b, "b", torch.float64, (M,))
    _expect(base, "base", torch.int32, (M,))
    for name, x, dt in (("k", k, torch.int32), ("h", h, torch.int32),
                        ("u", u, torch.float64), ("do", do, torch.bool),
                        ("p", p, torch.float32), ("bk", bk, torch.float64)):
        _expect(x, name, dt, ())
    if w is not None:
        _expect(w, "w", torch.float32, (R,))
    if w_h is not None:
        _expect(w_h, "w_h", torch.float32, ())
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if out is not None:
        for x, name, dt in zip(out, ("h_d", "v_d", "h_b", "v_b"),
                               (torch.int32, torch.float64) * 2):
            _expect(x, f"out {name}", dt, ())
    send_v, send_i = (None, None) if send is None else send
    if send is not None:
        _expect(send_v, "send_v", torch.float64, (2 if w is None else 5,))
        _expect(send_i, "send_i", torch.int32, (2,))
    if not _on_card(Tt, C, F, costs, k, u, do, ah, b, base, h, p, bk, w,
                    w_h, send_v, send_i):
        got = colk_costs_plain(Tt, C, F, costs, k, t, u, do, r, eps, ah, b,
                               base, h, p, bk, w, offset, w_h)
        out = got if out is None else _into(out, got)
        if s is not None:
            step_post_plain(s, max_iter, eps, bland_static, threshold,
                            then_pre)
            if send is not None:
                sharded_pack_plain(s, w, offset, send_v, send_i)
        return out

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    if ws is None:
        ws = colk_workspace(R, dev)
    _check_workspace(ws, colk_workspace_bytes(R), dev, f"colk_workspace({R})")
    if out is None:
        # (h_d, h_b) int32 and (v_d, v_b) f64: two allocations.
        h_d, h_b = torch.empty(2, dtype=torch.int32, device=dev).unbind()
        v_d, v_b = torch.empty(2, dtype=torch.float64, device=dev).unbind()
        out = (h_d, v_d, h_b, v_b)
    h_d, v_d, h_b, v_b = out
    err = lib.colk_costs_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(costs), _ptr(k), t, _ptr(u),
        _ptr(do), r, float(eps), M, R, _ptr(ah), _ptr(b), _ptr(base),
        _ptr(h), _ptr(p), _ptr(bk), _ptr(w), offset, _ptr(w_h), _ptr(ws),
        ws.numel(), _ptr(h_d), _ptr(v_d), _ptr(h_b), _ptr(v_b),
        _ptr(send_v), _ptr(send_i),
        None if s is None else ctypes.byref(_step_ptrs(s)), max_iter,
        _bland_mode(bland_static, threshold),
        0 if threshold is None else int(threshold), int(then_pre),
        _stream(Tt))
    check(lib, err, "colk_costs")
    LAUNCHES["colk_costs"] += 1
    if s is not None:
        LAUNCHES[tail] += 1
        if send is not None:
            LAUNCHES["sharded_pack_tail"] += 1
    return out


# ---------------------------------------------------------------------------
# The per-pivot step: the blocked-kernel loop's scalar glue around K1 and K2.
# On the card the step before K1 of a window's first pivot is a kernel of
# its own (``step_pre``); the step between K1 and K2 runs as K1's tail
# (``ah_ratio_tail``) and the step after K2, with the next pivot's step
# before K1, as K2's (``colk_costs_tail``).

RUNNING = int(Status.RUNNING)
OPTIMAL = int(Status.OPTIMAL)
UNBOUNDED = int(Status.UNBOUNDED)

#: Bland policies of the step kernels (csrc/step.cu ``BlandMode``).
BLAND_THRESHOLD, BLAND_STATIC, BLAND_NEVER = 0, 1, 2


def _bland_mode(bland_static: bool, threshold) -> int:
    return (BLAND_STATIC if bland_static else
            BLAND_NEVER if threshold is None else BLAND_THRESHOLD)


def exit_status(active, optimal, unbounded, status):
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


_I32, _F32, _F64, _BOOL = torch.int32, torch.float32, torch.float64, torch.bool


@dataclasses.dataclass
class PivotScalars:
    """The 0-dim tensors that the per-pivot step reads and writes, each
    only ever updated in place. The first nine are the loop's carry; the
    rest one pivot's intermediates: the step before K1 writes active, h,
    minc and optimal; K1 writes k, p_k1 (its p), bk and unb; the step
    between K1 and K2 writes do, p and u, which K2 reads. The field order
    is ``csrc/step.cu``'s ``Step``."""

    status: torch.Tensor
    iterations: torch.Tensor
    stall: torch.Tensor
    bland: torch.Tensor
    z: torch.Tensor
    h_d: torch.Tensor
    v_d: torch.Tensor
    h_b: torch.Tensor
    v_b: torch.Tensor
    active: torch.Tensor
    h: torch.Tensor
    minc: torch.Tensor
    optimal: torch.Tensor
    k: torch.Tensor
    p_k1: torch.Tensor
    bk: torch.Tensor
    unb: torch.Tensor
    do: torch.Tensor
    p: torch.Tensor
    u: torch.Tensor

    DTYPES = (_I32, _I32, _I32, _BOOL, _F64, _I32, _F64, _I32, _F64, _BOOL,
              _I32, _F64, _BOOL, _I32, _F32, _F64, _I32, _BOOL, _F32, _F64)

    def __post_init__(self):
        dev = self.status.device
        for (name, x), dt in zip(self.tensors().items(), self.DTYPES):
            _expect(x, name, dt, ())
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, status on {dev}")

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def pivot_scalars(z: torch.Tensor, bland: bool) -> PivotScalars:
    """A loop's scalars at its start: status RUNNING, no iterations, no
    stall, ``bland`` as given, a copy of ``z`` in f64, the rest zero."""
    dev = z.device
    vals = {"status": RUNNING, "bland": bland}
    fields = [f.name for f in dataclasses.fields(PivotScalars)]
    x = {name: torch.full((), vals.get(name, 0), dtype=dt, device=dev)
         for name, dt in zip(fields, PivotScalars.DTYPES)}
    x["z"] = z.to(_F64).reshape(()).clone()
    return PivotScalars(**x)


def step_pre_plain(s: PivotScalars, max_iter: int, eps: float) -> None:
    """Plain version of ``step_pre``."""
    s.active.copy_((s.status == RUNNING) & (s.iterations < max_iter))
    use_bland = s.bland & (s.h_b < BIG_INDEX)
    s.h.copy_(torch.where(use_bland, s.h_b, s.h_d))
    s.minc.copy_(torch.where(use_bland, s.v_b, s.v_d))
    s.optimal.copy_(s.minc > -eps)


def step_mid_plain(s: PivotScalars) -> None:
    """The step between K1 and K2 (``simplex_tpu/solver.py:751-761``):
    ``do = active and not (optimal or unb)``; ``p`` is K1's p where the
    pivot is done, else 1; ``u = minc / p`` in f64 where it is done, else
    0. The plain version of ``ah_ratio_tail``'s tail."""
    do = s.active & ~(s.optimal | (s.unb != 0))
    s.do.copy_(do)
    s.p.copy_(torch.where(do, s.p_k1, 1.0))
    s.u.copy_(torch.where(do, s.minc / s.p.to(_F64), 0.0))


def step_post_plain(s: PivotScalars, max_iter: int, eps: float,
                    bland_static: bool, threshold, then_pre: bool) -> None:
    """The step after K2 (``simplex_tpu/solver.py:777-794``): ``z -= u *
    bk`` where the pivot is done (two f64 roundings); the status
    (``exit_status``); the stall counter and Bland flag
    (``anticycling_update``, improved when z moved by >= eps);
    ``iterations += do``. With ``then_pre`` the next pivot's
    ``step_pre_plain`` follows. The plain version of
    ``colk_costs_tail``'s tail."""
    z2 = torch.where(s.do, s.z - s.u * s.bk, s.z)
    s.status.copy_(exit_status(s.active, s.optimal, s.unb != 0, s.status))
    stall, bland = anticycling_update(
        s.do, (z2 - s.z).abs() >= eps, s.stall, s.bland,
        bland_static=bland_static, threshold=threshold)
    s.stall.copy_(stall)
    s.bland.copy_(bland)
    s.iterations.add_(s.do.to(_I32))
    s.z.copy_(z2)
    if then_pre:
        step_pre_plain(s, max_iter, eps)


class _StepPtrs(ctypes.Structure):
    """``PivotScalars``' device pointers, in its field order: csrc/step.cuh's
    ``Step``, passed by value to ``step_pre``'s kernel and to K1 and K2
    with their tails."""

    _fields_ = [(f.name, ctypes.c_void_p)
                for f in dataclasses.fields(PivotScalars)]


def _step_ptrs(s: PivotScalars) -> _StepPtrs:
    """The pointers of ``PivotScalars``' fields: of a ``ShardedScalars``
    its first twenty, which are a ``Step``."""
    return _StepPtrs(*(getattr(s, name).data_ptr()
                       for name, _ in _StepPtrs._fields_))


def step_pre(s: PivotScalars, max_iter: int, eps: float) -> None:
    """The step before K1 (the XLA-fused glue of ``simplex_tpu/solver.py:
    731-742``): ``active = status == RUNNING and iterations < max_iter``;
    the Bland candidate where ``bland`` is on and one is eligible
    (``h_b < BIG_INDEX``), else the main one, gives ``h`` and ``minc``;
    ``optimal = minc > -eps``. One thread on the card."""
    if not _on_card(s.status):
        step_pre_plain(s, max_iter, eps)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.step_pre_launch(ctypes.byref(_step_ptrs(s)), max_iter,
                              float(eps), _stream(s.status))
    check(lib, err, "step_pre")
    LAUNCHES["step_pre"] += 1


def ah_ratio_tail(Tt, F, C, b, t: int, eps: float, s: PivotScalars, ah,
                  ws=None) -> None:
    """K1 with the step between K1 and K2 as its tail: ``ah_ratio`` of the
    column ``s.h`` into ``ah`` and ``s``'s k, p_k1, bk and unb, then
    ``step_mid_plain``'s do, p and u. On the card one launch, whose last
    block runs the step on K1's p and flag in one thread; it counts a
    launch of ``ah_ratio`` and one of ``step_mid_tail``."""
    _ah_ratio(Tt, F, C, b, s.h, t, eps, ws, (ah, s.k, s.p_k1, s.bk, s.unb), s)


def colk_costs_tail(Tt, C, F, costs, t: int, r: int, eps: float, ah, b,
                    base, w, s: PivotScalars, max_iter: int, ws=None, *,
                    bland_static: bool, threshold, then_pre: bool) -> None:
    """K2 with the step after K2 as its tail: ``colk_costs`` of the pivot
    ``s`` holds (k, u, do, h, p, bk) with its candidates into ``s``'s h_d,
    v_d, h_b and v_b, then ``step_post_plain``'s z, status, stall, bland
    and iterations and, with ``then_pre``, the next pivot's
    ``step_pre_plain`` -- which rewrites h, after K2 has read it. On the
    card one launch, whose last block runs the step in one thread once
    every block has arrived; it counts a launch of ``colk_costs`` and one
    of ``step_post_tail``."""
    _colk_costs(Tt, C, F, costs, s.k, t, s.u, s.do, r, eps, ah, b, base, s.h,
                s.p, s.bk, w, ws, (s.h_d, s.v_d, s.h_b, s.v_b), 0, None, s,
                max_iter, bland_static, threshold, then_pre)


# ---------------------------------------------------------------------------
# The sharded loop's per-pivot step: the glue around K5, the column's
# all_reduce, K2 on the slice and the candidates' all_gathers. On the card
# the step before K5 of a window's first pivot is a kernel of its own
# (``sharded_step_pre``), the ratio test one thread-block cluster
# (``sharded_ratio``), the step after K2 and the pack of the slice's
# candidates K2's tail (``colk_costs_sharded_tail``), and the fold of the
# gathered candidates with the next pivot's step before K5 the head of
# that pivot's K5 (``ah_fold_head``); the window's last fold is
# ``sharded_fold``, and the window boundary packs with ``sharded_pack``.

@dataclasses.dataclass
class ShardedScalars(PivotScalars):
    """``PivotScalars`` with what the sharded loop's step carries besides:
    the devex weights at the folded main and Bland candidates (``w_d``,
    ``w_b``; 1 under the other rules), and one pivot's intermediates --
    the weight at h (``wh``), h's local column in the slice (``hl``,
    clamped into it) and whether this rank owns h (``own``), which the
    step before K5 writes. ``sharded_ratio`` writes k, unb, do, p, bk and
    u; ``p_k1`` is unused. The field order is ``csrc/sharded_step.cuh``'s
    ``ShardStep``, whose first twenty fields are a ``Step``."""

    w_d: torch.Tensor
    w_b: torch.Tensor
    wh: torch.Tensor
    hl: torch.Tensor
    own: torch.Tensor

    DTYPES = PivotScalars.DTYPES + (_F32, _F32, _F32, _I32, _BOOL)


def sharded_scalars(z: torch.Tensor, bland: bool) -> ShardedScalars:
    """``pivot_scalars`` with the sharded fields: the weights 1, the rest
    zero."""
    base = pivot_scalars(z, bland).tensors()
    dev = z.device
    return ShardedScalars(
        **base, w_d=torch.ones((), device=dev), w_b=torch.ones((), device=dev),
        wh=torch.ones((), device=dev),
        hl=torch.zeros((), dtype=_I32, device=dev),
        own=torch.zeros((), dtype=_BOOL, device=dev))


def sharded_step_pre_plain(s: ShardedScalars, max_iter: int, eps: float,
                           offset: int, R_loc: int) -> None:
    """Plain version of ``sharded_step_pre``."""
    step_pre_plain(s, max_iter, eps)
    use_bland = s.bland & (s.h_b < BIG_INDEX)
    s.wh.copy_(torch.where(use_bland, s.w_b, s.w_d))
    loc = s.h.long() - offset
    s.own.copy_((loc >= 0) & (loc < R_loc))
    s.hl.copy_(loc.clamp(0, R_loc - 1))


def sharded_ratio_plain(s: ShardedScalars, ah, b, eps: float) -> None:
    """Plain version of ``sharded_ratio``."""
    M = ah.shape[0]
    mask = ah >= eps
    q = torch.where(mask, b / torch.where(mask, ah, 1.0).double(), torch.inf)
    k = torch.argmin(q)
    unb = ~mask.any()
    do = s.active & ~(s.optimal | unb)
    p = torch.where(do, _index(ah, k, M - 1), 1.0)
    s.k.copy_(k)
    s.unb.copy_(unb)
    s.do.copy_(do)
    s.p.copy_(p)
    s.bk.copy_(_index(b, k, M - 1))
    s.u.copy_(torch.where(do, s.minc / p.to(_F64), 0.0))


def sharded_pack_plain(s: ShardedScalars, w, offset: int, vals,
                       idx) -> None:
    """Plain version of ``sharded_pack``."""
    parts = [s.v_d, s.v_b]
    if w is not None:
        R_loc = w.shape[0]
        has = s.h_b < BIG_INDEX
        w_d = _index(w, s.h_d, R_loc - 1).double()
        parts += [w_d, torch.where(has, _index(w, s.h_b, R_loc - 1).double(),
                                   1.0),
                  torch.where(has, s.v_d * s.v_d / w_d, -torch.inf)]
    vals.copy_(torch.stack(parts))
    for i, x in enumerate((s.h_d, s.h_b)):
        idx[i].copy_(torch.where(x >= BIG_INDEX, BIG_INDEX, offset + x))


def fold_owners(V, I):
    """The ranks whose gathered candidates win the fold (``V`` (P, 5 or
    2) f64, ``I`` (P, 2) int32): the main candidate's, the first rank with
    the largest key (the devex key, else ``-v_d``; a NaN key anywhere
    makes the max NaN, which no key equals: rank 0), and the Bland one's,
    the first rank with the lowest global index. 0-dim int64 tensors."""
    key = V[:, 4] if V.shape[1] == 5 else -V[:, 0]
    return (torch.argmax((key == key.max()).to(torch.int8)),
            torch.argmin(I[:, 1]))


def sharded_fold_plain(s: ShardedScalars, V, I) -> None:
    """Plain version of ``sharded_fold``: the main candidate from the
    first rank with the largest key, the Bland one from the first rank
    with the lowest global index."""
    devex = V.shape[1] == 5
    od, ob = fold_owners(V, I)
    s.h_d.copy_(I[od, 0])
    s.v_d.copy_(V[od, 0])
    s.h_b.copy_(I[ob, 1])
    s.v_b.copy_(V[ob, 1])
    if devex:
        s.w_d.copy_(V[od, 2])
        s.w_b.copy_(V[ob, 3])
    else:
        s.w_d.fill_(1.0)
        s.w_b.fill_(1.0)


def sharded_step_post_plain(s: ShardedScalars, V, I, max_iter: int,
                            eps: float, bland_static: bool, threshold,
                            then_pre: bool, offset: int, R_loc: int) -> None:
    """The step after the candidates' ``all_gather``s as one step, in the
    order the sharded loop first ran it (``sharded.py:738-768``): the fold
    (``sharded_fold_plain``), then the step after K2 (``step_post_plain``)
    and, with ``then_pre``, the next pivot's ``sharded_step_pre_plain``.
    The loop now runs the step after K2 as K2's tail and the fold with the
    next step before K5 as K5's head: the fold and the step after K2 touch
    disjoint fields, so the two orders agree (the tests' reference)."""
    sharded_fold_plain(s, V, I)
    step_post_plain(s, max_iter, eps, bland_static, threshold, False)
    if then_pre:
        sharded_step_pre_plain(s, max_iter, eps, offset, R_loc)


class _ShardStepPtrs(ctypes.Structure):
    """``ShardedScalars``' device pointers, in its field order:
    csrc/sharded_step.cuh's ``ShardStep``."""

    _fields_ = [(f.name, ctypes.c_void_p)
                for f in dataclasses.fields(ShardedScalars)]


def _shard_step_ptrs(s: ShardedScalars) -> _ShardStepPtrs:
    return _ShardStepPtrs(*(x.data_ptr() for x in s.tensors().values()))


def _check_gathered(V, I) -> None:
    P, kv = V.shape
    if kv not in (2, 5):
        raise ValueError(f"V: want (P, 2) or (P, 5), got {tuple(V.shape)}")
    _expect(V, "V", torch.float64, (P, kv))
    _expect(I, "I", torch.int32, (P, 2))


def sharded_step_pre(s: ShardedScalars, max_iter: int, eps: float,
                     offset: int, R_loc: int) -> None:
    """The step before K5 (``simplex_tpu/parallel/sharded.py:668-685``):
    ``step_pre``'s active, h, minc and optimal over the folded
    candidates, then the weight at h, whether this rank's slice
    ``[offset, offset + R_loc)`` owns h, and h's local column clamped into
    the slice. One thread on the card, launched once a window: within it
    the step runs as K5's head (``ah_fold_head``)."""
    if not _on_card(s.status):
        sharded_step_pre_plain(s, max_iter, eps, offset, R_loc)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.sharded_step_pre_launch(ctypes.byref(_shard_step_ptrs(s)),
                                      max_iter, float(eps), offset, R_loc,
                                      _stream(s.status))
    check(lib, err, "sharded_step_pre")
    LAUNCHES["sharded_step_pre"] += 1


def sharded_ratio(s: ShardedScalars, ah, b, eps: float) -> None:
    """The ratio test on the summed column (``sharded.py:687-699``): k,
    the first index of the smallest ``b / a_h`` (f64) over ``a_h >= eps``
    (a NaN quotient first, as ``torch.argmin``; 0 with no eligible row);
    ``unb`` where no row is eligible; ``do = active and not (optimal or
    unb)``; ``p = a_h[k]`` where the pivot is done, else 1; ``bk =
    b[k]``; ``u = minc / p`` where done, else 0. ``ah`` (M,) f32, ``b``
    (M,) f64. One thread-block cluster on the card."""
    M = ah.shape[0]
    _expect(ah, "ah", torch.float32, (M,))
    _expect(b, "b", torch.float64, (M,))
    if not _on_card(s.status, ah, b):
        sharded_ratio_plain(s, ah, b, eps)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.sharded_ratio_launch(ctypes.byref(_shard_step_ptrs(s)),
                                   _ptr(ah), _ptr(b), M, float(eps),
                                   _stream(ah))
    check(lib, err, "sharded_ratio")
    LAUNCHES["sharded_ratio"] += 1


def colk_costs_sharded_tail(Tt, C, F, costs, t: int, r: int, eps: float,
                            ah, b, base, w, s: ShardedScalars,
                            max_iter: int, ws=None, *, offset: int,
                            bland_static: bool, threshold, send_v=None,
                            send_i=None) -> None:
    """K2 on a slice with the step after K2 and the pack as its tail
    (``sharded.py:741-768``): ``colk_costs`` of the pivot ``s`` holds (k,
    u, do, h, p, bk) at the slice's ``offset``, with the weight at h
    ``s.wh`` under devex (``w`` given), its candidates into ``s``'s h_d,
    v_d, h_b and v_b; then ``step_post_plain``'s z, status, stall, bland
    and iterations without the next pivot's step before K5, which needs
    the candidates folded across the ranks first; then, with the send
    buffers, ``sharded_pack_plain`` of the slice's candidates into
    ``send_v`` and ``send_i``. On the card one launch, K2 with the
    single-card tail (``s``'s first twenty fields are a ``Step``) and the
    pack from the candidates its last block holds in registers and the
    weights at them, loaded after its store of w[h]; it counts a launch
    of ``colk_costs``, one of ``sharded_post_tail`` and, with the buffers,
    one of ``sharded_pack_tail``. Without them (a comparison on the card)
    the pack is left to ``sharded_pack``."""
    if (send_v is None) != (send_i is None):
        raise ValueError("send_v and send_i: both or neither")
    _colk_costs(Tt, C, F, costs, s.k, t, s.u, s.do, r, eps, ah, b, base, s.h,
                s.p, s.bk, w, ws, (s.h_d, s.v_d, s.h_b, s.v_b), offset,
                None if w is None else s.wh, s, max_iter, bland_static,
                threshold, False, "sharded_post_tail",
                None if send_v is None else (send_v, send_i))


def sharded_pack(s: ShardedScalars, w, offset: int, vals, idx) -> None:
    """The slice's candidates (K2's ``h_d, v_d, h_b, v_b``, local
    columns) into the ``all_gather`` send buffers (``sharded.py:741-
    743``, the fold's operands): ``vals`` (5,) f64 ``[v_d, v_b, w[h_d],
    w[h_b], key]`` under devex (``w`` given; ``w[h_b]`` 1 and key ``-inf``
    with no eligible column, else ``key = v_d^2 / w[h_d]``), (2,) ``[v_d,
    v_b]`` otherwise; ``idx`` (2,) int32 the global indices (``BIG_INDEX``
    stays). One thread on the card: the window boundary's pack; within a
    window K2's tail packs (``colk_costs_sharded_tail``)."""
    _expect(vals, "vals", torch.float64, (2 if w is None else 5,))
    _expect(idx, "idx", torch.int32, (2,))
    if w is not None:
        _expect(w, "w", torch.float32, (w.shape[0],))
    if not _on_card(s.status, w, vals, idx):
        sharded_pack_plain(s, w, offset, vals, idx)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.sharded_pack_launch(
        ctypes.byref(_shard_step_ptrs(s)), _ptr(w), offset,
        0 if w is None else w.shape[0], _ptr(vals), _ptr(idx),
        _stream(vals))
    check(lib, err, "sharded_pack")
    LAUNCHES["sharded_pack"] += 1


def sharded_fold(s: ShardedScalars, V, I) -> None:
    """The fold of every rank's ``sharded_pack`` output (``sharded.py:
    738-740``), ``V`` (P, 5 or 2) f64 and ``I`` (P, 2) int32: the main
    candidate (``h_d, v_d``, ``w_d`` under devex) from the first rank with
    the largest key (the devex key, else ``-v_d``), the Bland one (``h_b,
    v_b, w_b``) from the first rank with the lowest global index -- ties
    go to the lowest rank, and the slices are contiguous, so to the
    lowest global index as on one card. A window's last node and the
    window boundary's fold; within a window K5's head folds. One thread
    on the card."""
    _check_gathered(V, I)
    if not _on_card(s.status, V, I):
        sharded_fold_plain(s, V, I)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.sharded_fold_launch(ctypes.byref(_shard_step_ptrs(s)),
                                  _ptr(V), _ptr(I), *V.shape, _stream(V))
    check(lib, err, "sharded_fold")
    LAUNCHES["sharded_fold"] += 1


def ah_fold_head(Tt, F, C, t: int, s: ShardedScalars, V, I, max_iter: int,
                 eps: float, offset: int, out) -> None:
    """K5 with the sharded loop's head, for every pivot of a window but
    the first: ``sharded_fold_plain`` of the candidates gathered after the
    pivot before (``V``, ``I``), then ``sharded_step_pre_plain`` on this
    rank's slice (``Tt``'s columns, from global column ``offset``), then
    ``ah`` of the column ``s.hl`` with the owner flag ``s.own`` into
    ``out``. On the card one launch, K5 with the fold (by shuffles) and
    the step in every warp, h and the owner flag in registers, and block
    0 storing the scalars; it counts a launch of ``ah`` and one of
    ``sharded_fold_head``."""
    M, R, L = _check_factors(Tt, C, F)
    _check_gathered(V, I)
    _expect(out, "out", torch.float32, (M,))
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if not _on_card(Tt, F, C, s.status, V, I, out):
        sharded_fold_plain(s, V, I)
        sharded_step_pre_plain(s, max_iter, eps, offset, R)
        out.copy_(torch.where(s.own, ah_plain(Tt, F, C, s.hl, t), 0.0))
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.ah_head_launch(
        _ptr(Tt), _ptr(F), _ptr(C), t, M, R, _ptr(out),
        ctypes.byref(_shard_step_ptrs(s)), _ptr(V), _ptr(I), *V.shape,
        max_iter, float(eps), offset, _stream(Tt))
    check(lib, err, "ah")
    LAUNCHES["ah"] += 1
    LAUNCHES["sharded_fold_head"] += 1


# ---------------------------------------------------------------------------
# K3 / K4: window apply, with or without the fused reprice.

def apply_reprice_plain(Tt, C, F, coeffs):
    """Plain version of ``apply_reprice``."""
    apply_window_plain(Tt, C, F)
    return tt_matvec(Tt, coeffs)


def apply_reprice(Tt, C, F, coeffs):
    """K3, the port of ``simplex_tpu.kernels.blocked.apply_reprice_pass``.

    ``Tt -= F^T @ C`` in place (IEEE f32), fused with the reprice
    ``mv = coeffs @ Tt_new`` accumulated in f64 (coeffs (M,) f64).
    Returns mv (R,) f64. The TPU pass's ``do_reprice`` flag has no
    counterpart: the loop picks K3 or K4 (the apply alone) on the host."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(coeffs, "coeffs", torch.float64, (M,))
    if not _on_card(Tt, C, F, coeffs):
        return apply_reprice_plain(Tt, C, F, coeffs)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    part = torch.empty((M // APPLY_TILE, R), dtype=torch.float64, device=dev)
    mv = torch.empty(R, dtype=torch.float64, device=dev)
    err = lib.apply_reprice_launch(_ptr(Tt), _ptr(F), _ptr(C), M, R, L,
                                   _ptr(coeffs), _ptr(part), _ptr(mv),
                                   _stream(Tt))
    check(lib, err, "apply_reprice")
    LAUNCHES["apply_reprice"] += 1
    return mv


def apply_window_plain(Tt, C, F):
    """Plain version of ``apply_window``."""
    Tt.addmm_(F.t(), C, alpha=-1.0)


def apply_window(Tt, C, F) -> None:
    """K4, the port of ``simplex_tpu.kernels.blocked.apply_window_pass``:
    ``Tt -= F^T @ C`` in place (IEEE f32). On the card a persistent
    kernel whose every element rounds as K3's apply does, so the two leave
    the same Tt bit for bit."""
    M, R, L = _check_factors(Tt, C, F)
    if not _on_card(Tt, C, F):
        apply_window_plain(Tt, C, F)
        return

    from ._build import check, load_library

    lib = load_library()
    err = lib.apply_window_launch(_ptr(Tt), _ptr(F), _ptr(C), M, R, L,
                                  _stream(Tt))
    check(lib, err, "apply_window")
    LAUNCHES["apply_window"] += 1


# ---------------------------------------------------------------------------
# K11: the standalone reprice.

def reprice_plain(Tt, coeffs):
    """Plain version of ``reprice``."""
    return tt_matvec(Tt, coeffs)


def reprice(Tt, coeffs):
    """K11, the port of ``simplex_tpu.kernels.blocked.reprice_pass``:
    ``mv = coeffs @ Tt`` accumulated in f64, Tt (M, R) f32 with M and R
    multiples of 128, coeffs (M,) f64 (the JAX pass took and returned
    double-f32 pairs). Returns mv (R,) f64. No solve path launches it, as
    in the JAX package: the loops re-price through K3, whose mv it equals
    bit for bit when the window's etas are zero."""
    M, R = Tt.shape
    _expect(Tt, "Tt", torch.float32, (M, R))
    _expect(coeffs, "coeffs", torch.float64, (M,))
    if M % APPLY_TILE or R % APPLY_TILE:
        raise ValueError(f"need M, R multiples of {APPLY_TILE}, got M={M} "
                         f"R={R}")
    if not _on_card(Tt, coeffs):
        return reprice_plain(Tt, coeffs)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    part = torch.empty((M // APPLY_TILE, R), dtype=torch.float64, device=dev)
    mv = torch.empty(R, dtype=torch.float64, device=dev)
    err = lib.reprice_launch(_ptr(Tt), M, R, _ptr(coeffs), _ptr(part),
                             _ptr(mv), _stream(Tt))
    check(lib, err, "reprice")
    LAUNCHES["reprice"] += 1
    return mv
