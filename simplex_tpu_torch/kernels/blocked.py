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

import torch

from ..tableau import tt_matvec

#: Sentinel index: no eligible row / column.
BIG_INDEX = 2 ** 31 - 1

#: Constraints per block of K1 (csrc/blocked.cu AHR_COLS).
AHR_COLS = 64
#: Columns per R block of K2 (csrc/blocked.cu COLK_COLS).
COLK_COLS = 64
#: Tile edge of the window apply (csrc/blocked.cu AT).
APPLY_TILE = 128

#: Launches of each kernel since the last ``reset_launches``.
LAUNCHES = {"ah_ratio": 0, "colk_costs": 0, "apply_reprice": 0,
            "apply_window": 0, "ah": 0, "reprice": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def ah_ratio(Tt, F, C, b, h, t: int, eps: float, ws=None):
    """K1, the port of ``simplex_tpu.kernels.blocked.ah_ratio_pass``.

    Live entering column ``a_h = Tt[:, h] - C[:t, h] @ F[:t]`` and the
    min-ratio test over ``a_h >= eps``: the smallest ``b / a_h`` (f64),
    ties to the lowest index. Returns ``(a_h (M,) f32, k i32, p = a_h[k]
    f32, bk = b[k] f64, unbounded i32)``; with no eligible row k is
    ``BIG_INDEX``, p and bk are 0 and unbounded is 1. ``ws`` is an
    ``ah_ratio_workspace``; on the card a call without one allocates
    one."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(b, "b", torch.float64, (M,))
    _expect(h, "h", torch.int32, ())
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if ws is not None:
        _check_workspace(ws, ah_ratio_workspace_bytes(M), Tt.device,
                         f"ah_ratio_workspace({M})")
    if not _on_card(Tt, F, C, b, h):
        return ah_ratio_plain(Tt, F, C, b, h, t, eps)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    if ws is None:
        ws = ah_ratio_workspace(M, dev)
    # Three allocations: a_h, (k, p's bits, unbounded) int32, and bk.
    ah = torch.empty(M, dtype=torch.float32, device=dev)
    ints = torch.empty(3, dtype=torch.int32, device=dev)
    bk = torch.empty((), dtype=torch.float64, device=dev)
    ip = ints.data_ptr()
    err = lib.ah_ratio_launch(
        _ptr(Tt), _ptr(F), _ptr(C), _ptr(b), _ptr(h), t, M, R, float(eps),
        _ptr(ah), _ptr(ws), ws.numel(), ctypes.c_void_p(ip),
        ctypes.c_void_p(ip + 4), _ptr(bk), ctypes.c_void_p(ip + 8),
        _stream(Tt))
    check(lib, err, "ah_ratio")
    LAUNCHES["ah_ratio"] += 1
    k, p_bits, unb = ints.unbind()
    return ah, k, p_bits.view(torch.float32), bk, unb


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


def ah(Tt, F, C, h, t: int):
    """K5, the port of ``simplex_tpu.kernels.blocked.ah_pass``.

    The live entering column ``a_h = Tt[:, h] - C[:t, h] @ F[:t]`` (M,)
    f32, h a 0-dim int32 column of ``Tt`` (clamped into range), ``t`` the
    live eta rows. On the card it runs K1's column code without the ratio
    fold, so K1 and K5 give the same column bit for bit. The sharded loop
    calls it on each rank's slice and sums the owner's column across the
    ranks before its ratio test."""
    M, R, L = _check_factors(Tt, C, F)
    _expect(h, "h", torch.int32, ())
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if not _on_card(Tt, F, C, h):
        return ah_plain(Tt, F, C, h, t)

    from ._build import check, load_library

    lib = load_library()
    out = torch.empty(M, dtype=torch.float32, device=Tt.device)
    err = lib.ah_launch(_ptr(Tt), _ptr(F), _ptr(C), _ptr(h), t, M, R,
                        _ptr(out), _stream(Tt))
    check(lib, err, "ah")
    LAUNCHES["ah"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: pivot row, cost / b / base / eta-row / devex updates, next candidates.

def colk_costs_plain(Tt, C, F, costs, k, t: int, u, do, r: int, eps: float,
                     ah, b, base, h, p, bk, w=None):
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
        wh = _index(w, h, R - 1)
        alpha = colk / p
        w2 = torch.maximum(w, alpha * alpha * wh)
        is_l = torch.arange(R, device=Tt.device) == lvar
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
               ah, b, base, h, p, bk, w=None, ws=None):
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
    ``colk_workspace``; on the card a call without one allocates one."""
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
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    if not _on_card(Tt, C, F, costs, k, u, do, ah, b, base, h, p, bk, w):
        return colk_costs_plain(Tt, C, F, costs, k, t, u, do, r, eps, ah, b,
                                base, h, p, bk, w)

    from ._build import check, load_library

    lib = load_library()
    dev = Tt.device
    if ws is None:
        ws = colk_workspace(R, dev)
    _check_workspace(ws, colk_workspace_bytes(R), dev, f"colk_workspace({R})")
    # The candidates: (h_d, h_b) int32 and (v_d, v_b) f64, two allocations.
    hidx = torch.empty(2, dtype=torch.int32, device=dev)
    vals = torch.empty(2, dtype=torch.float64, device=dev)
    hp, vp = hidx.data_ptr(), vals.data_ptr()
    err = lib.colk_costs_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(costs), _ptr(k), t, _ptr(u),
        _ptr(do), r, float(eps), M, R, _ptr(ah), _ptr(b), _ptr(base),
        _ptr(h), _ptr(p), _ptr(bk), _ptr(w), _ptr(ws), ws.numel(),
        ctypes.c_void_p(hp), ctypes.c_void_p(vp), ctypes.c_void_p(hp + 4),
        ctypes.c_void_p(vp + 8), _stream(Tt))
    check(lib, err, "colk_costs")
    LAUNCHES["colk_costs"] += 1
    h_d, h_b = hidx.unbind()
    v_d, v_b = vals.unbind()
    return h_d, v_d, h_b, v_b


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
