"""The plain blocked loop's per-pivot kernels: ``solver.solve_loop_blocked``
as one CUDA graph a window of L pivots.

No Pallas kernel stands behind these: in the JAX package the plain
deferred block-pivot loop is a ``lax.while_loop`` around a
``lax.fori_loop`` whose pivot XLA fuses (``simplex_tpu/solver.py:528-582``
``inner``). The port's eager loop ran a pivot as about 30 torch calls;
here a pivot is two kernels (``csrc/eta.cu``), each on a grid sized to
the card (``eta_plan``) whose blocks first send for their share of the eta
slab into shared memory, before the pivot's index is read, and whose last
block folds the blocks' partials by an arrival ticket --

* ``eta_ratio``: the live entering column ``a_h = Tt[:, h] - sum_{s<t}
  C[s, h] F[s]`` into the loop's fixed ``ah``, the ratio test and the step
  between (k, unb, do, p, bk, u);
* ``eta_colk``: the live leaving row ``colk = Tt[k] - sum_{s<t} F[s, k]
  C[s]`` into ``C[t]``, the costs and the devex weights (re-anchored every
  pivot), ``F[t]``, b and ``base[k] = h``, the next pivot's candidates,
  the step after and the next pivot's step before.

The window begins with ``kernels.seq.seq_step_pre`` and ends in
``Tt.addmm_(F.t(), C, alpha=-1)`` (cuBLAS: the JAX loop's XLA dot).

The sharded plain blocked loop (``parallel.sharded.solve_loop_blocked_
sharded``; the JAX loop under ``shard_map``,
``simplex_tpu/parallel/sharded.py:386-510``) runs the same pivot on each
rank's slice of the columns, after the ``all_gather``s of the candidates
every rank packed, as three kernels on the same plan:

* ``eta_fold_column``: the fold of the gathered candidates and the step
  before as its head (under devex the re-anchor the pivot before left to
  it: the slice's weights reset where the largest of every rank's passed
  1e8), then ``eta_ratio``'s live column from the rank that owns h (zeros
  on the others), which an ``all_reduce`` sums in place;
* ``eta_ratio_summed``: ``eta_ratio``'s ratio test and step between on
  the summed column, as one thread-block cluster launched behind the
  fold;
* ``eta_colk_slice``: ``eta_colk`` on the slice, h global, its candidates
  packed into the send buffers (``pack_slice``: under devex on the new
  weights and on weights of 1, and the slice's largest weight) in place
  of the re-anchor and the next step before, which need every rank's.

As in the other kernel modules each kernel is built at first use, has a
plain PyTorch version taken for CPU tensors (and by ``chip_smoke.py`` as
the kernel's reference on the card), and a launch counter in
``LAUNCHES``; a wrapper given CUDA tensors launches its kernel or raises.
The eta corrections sum in f64 in one order in both (``eta_live``), so a
kernel and its plain version agree bit for bit.

Dtypes: the tableau ``Tt (M, R)``, ``C (L, R)``, ``F (L, M)`` and ``ah``
of T; b, the costs, z and the devex weights of V: (f64, f64), (f32, f64)
and (f32, f32) have kernels; the plain versions take any pair. The
scalars are ``kernels.seq.SeqScalars``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .blocked import (BIG_INDEX, _bland_mode, _cdiv, _expect, _index,
                      _on_card, _ptr, _stream, step_post_plain,
                      step_pre_plain)
from .seq import (SeqScalars, _lib, _pair, _ratio_plain, _seq_ptrs,
                  _update_b, set_candidates)

#: Launches of each kernel since the last ``reset_launches``. The steps
#: run inside their carriers: the step between in ``eta_ratio``, the step
#: after (and the next step before) in ``eta_colk``.
LAUNCHES = {"eta_ratio": 0, "eta_colk": 0}
#: The same for the sharded plain blocked loop's kernels on a slice.
SLICE_LAUNCHES = {"eta_fold_column": 0, "eta_ratio_summed": 0,
                  "eta_colk_slice": 0}

#: Threads a block of ``eta_ratio`` (csrc/eta.cu RATIO_THREADS), one a
#: row, and at least a block of ``eta_colk`` (COLK_THREADS), one a column
#: (or a row of F[t] and b in the blocks past the columns): 256 where it
#: takes 256 columns.
ETA_RATIO_THREADS = 128
ETA_COLK_THREADS = 128
#: The rows a block of ``eta_ratio``, and the columns a block of
#: ``eta_colk``, that ``eta_plan`` chooses from.
ETA_ROWS = (16, 32, 64, 128)
ETA_COLS = (32, 64, 128, 256)
#: The SMs the grid is sized to (an H100 SXM's).
ETA_SMS = 132
#: A block's shared memory on the card, less room for the kernels' static
#: arrays (csrc/eta.cu BLOCK_SMEM, SMEM_RESERVE: a launch whose slab does
#: not fit is refused there); the most slab rows a round; and the rows a
#: round of ``eta_colk`` where its grid takes more than one wave.
ETA_SLAB_SMEM = 232448 - 1024
ETA_STAGE_MAX = 128
ETA_STAGE_WAVES = 16


def reset_launches() -> None:
    for table in (LAUNCHES, SLICE_LAUNCHES):
        for name in table:
            table[name] = 0


class EtaPlan(NamedTuple):
    """How a pivot's two kernels cut the tableau: the rows a block of
    ``eta_ratio``, the columns a block of ``eta_colk``, and each one's slab
    rows a round."""
    rows: int
    cols: int
    stage_ratio: int
    stage_colk: int


def eta_colk_threads(cols: int) -> int:
    """Threads a block of ``eta_colk`` taking ``cols`` columns."""
    return max(ETA_COLK_THREADS, cols)


def eta_colk_blocks(M: int, R: int, cols: int) -> int:
    """Blocks of ``eta_colk``: its column blocks, then its blocks of F[t]
    and b, one thread a row."""
    return _cdiv(R, cols) + _cdiv(M, eta_colk_threads(cols))


def eta_grid(M: int, R: int) -> tuple[int, int]:
    """The rows a block of ``eta_ratio`` and the columns a block of
    ``eta_colk`` for an ``M`` x ``R`` tableau: the fewest rows whose grid
    stays within half the SMs, and the fewest columns whose whole grid
    (``eta_colk_blocks``) takes one wave of one block an SM; the widest
    where none does. A wider grid loads each block's slab sooner but gives
    the last block more partials to fold; tools/eta_variants.cu timed
    every choice (PERF.md). So the 2048^2 f64 tableau (M 2,048, R 6,144)
    runs 64 blocks of ``eta_ratio`` and 96 + 16 of ``eta_colk``, the
    8192^2 one 64 and 96 + 32, the north star's (M 10,112, R 120,064) 79
    and 469 + 40."""
    rows = next((w for w in ETA_ROWS if _cdiv(M, w) <= ETA_SMS // 2),
                ETA_ROWS[-1])
    cols = next((w for w in ETA_COLS if eta_colk_blocks(M, R, w) <= ETA_SMS),
                ETA_COLS[-1])
    return rows, cols


def _slab_row_bytes(width: int, item: int) -> int:
    """A slab row's bytes in shared memory: ``width`` elements of ``item``
    bytes and one 16-byte chunk more, for the row's misalignment."""
    return (width + 16 // item) * item


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def eta_stage(width: int, L: int, item: int, most: int = ETA_STAGE_MAX) -> int:
    """Slab rows a round for a block ``width`` elements wide of
    ``item``-byte elements in a window of L: as many as two rounds hold
    beside the window's coefficients, at most ``most``; 0 where none fits
    (the kernel refuses the launch)."""
    room = ETA_SLAB_SMEM - _round16(L * item)
    return max(0, min(room // (2 * _slab_row_bytes(width, item)), most))


@functools.lru_cache(maxsize=None)
def eta_plan(M: int, R: int, L: int, item: int) -> EtaPlan:
    """The plan of both kernels for an ``M`` x ``R`` tableau of
    ``item``-byte elements in a window of L: ``eta_grid``'s widths;
    ``eta_ratio`` (one wave) and ``eta_colk`` where its grid takes one wave
    with as many slab rows a round as fit, ``eta_colk`` past one wave
    ``ETA_STAGE_WAVES`` rows, so that several of its blocks share an SM
    and one block's loads overlap another's sums (at the north star, 256
    columns a block: 36.7 and 60.7 us at t = 64 and 127 with 16 rows a
    round, 49.5 and 70.3 with the most that fit, on NVIDIA H100 80GB HBM3,
    700.00 W; tools/eta_variants.cu, PERF.md)."""
    rows, cols = eta_grid(M, R)
    waves = eta_colk_blocks(M, R, cols) > ETA_SMS
    return EtaPlan(rows, cols, eta_stage(rows, L, item),
                   eta_stage(cols, L, item,
                             ETA_STAGE_WAVES if waves else ETA_STAGE_MAX))


def eta_workspace_bytes(M: int, R: int) -> int:
    """Bytes of the two kernels' workspace for an ``M`` x ``R`` tableau
    (csrc/eta.cu ``ws_bytes``): the two arrival counters and a stashed
    weight (16 bytes), 32 bytes of partial for each block of
    ``eta_ratio`` and 80 for each column block of ``eta_colk`` (16 of
    them the weights at the candidates, which ``eta_colk_slice`` carries
    through its fold) (``eta_grid``)."""
    rows, cols = eta_grid(M, R)
    return 16 + 32 * _cdiv(M, rows) + 80 * _cdiv(R, cols)


def eta_workspace(M: int, R: int, device) -> torch.Tensor:
    """A zeroed workspace for ``eta_ratio`` and ``eta_colk`` on ``device``.
    Each call leaves its counter at 0 again, so a loop allocates one and
    passes it to every call, in order on one stream. The plain versions
    leave it untouched."""
    return torch.zeros(eta_workspace_bytes(M, R), dtype=torch.uint8,
                       device=device)


def eta_sum(coef: torch.Tensor, rows: torch.Tensor, t: int) -> torch.Tensor:
    """``sum_{s<t} coef[s] * rows[s]`` in the kernels' order, in f64: s =
    0 .. t-1 from zeros, each product (exact for f32 operands) and each
    sum rounded apart."""
    acc = torch.zeros(rows.shape[1], dtype=torch.float64, device=rows.device)
    if t:
        prods = coef[:t, None].double() * rows[:t].double()
        for q in range(t):
            acc.add_(prods[q])
    return acc


def eta_live(head: torch.Tensor, coef: torch.Tensor, rows: torch.Tensor,
             t: int) -> torch.Tensor:
    """The live vector ``head - sum_{s<t} coef[s] * rows[s]`` as the
    kernels form it: ``eta_sum``, one f64 subtraction, one rounding to
    ``head``'s dtype."""
    return (head.double() - eta_sum(coef, rows, t)).to(head.dtype)


def eta_candidates(costs: torch.Tensor, w: torch.Tensor | None, r: int,
                   eps: float):
    """The entering candidates (h_d, v_d, h_b, v_b), 0-dim, the indices
    int32, that ``solver._entering_blocked`` chooses between: over the
    costs of the live columns ``i < r``, the main one the Dantzig argmin
    (``w`` None) or the devex argmax of cost^2 / w over the eligible
    columns (cost <= -eps; with none, column 0), its value the masked
    cost there; the Bland one the lowest eligible index (``BIG_INDEX``
    and inf with none). Every product and quotient in the costs' dtype."""
    R = costs.shape[0]
    iota = torch.arange(R, device=costs.device)
    masked = torch.where(iota < r, costs, torch.inf)
    eligible = masked <= -eps
    if w is None:
        h_d = torch.argmin(masked)
    else:
        h_d = torch.argmax(torch.where(eligible, masked * masked / w,
                                       -torch.inf))
    h_b = torch.where(eligible, iota, BIG_INDEX).min()
    v_b = torch.where(h_b < BIG_INDEX, _index(masked, h_b, R - 1),
                      torch.inf)
    return (h_d.to(torch.int32), _index(masked, h_d, R - 1),
            h_b.to(torch.int32), v_b)


def _check(Tt, C, F, s: SeqScalars, t: int, **vecs) -> tuple[int, int, int]:
    """Raises unless the operands have the scalars' dtypes and the
    tableau's shapes and ``t`` lies in the window; returns (M, R, L)."""
    M, R = Tt.shape
    L = C.shape[0]
    T, V = s.p.dtype, s.z.dtype
    _expect(Tt, "Tt", T, (M, R))
    _expect(C, "C", T, (L, R))
    _expect(F, "F", T, (L, M))
    n = {"ah": (T, M), "b": (V, M), "costs": (V, R), "w": (V, R),
         "base": (torch.int32, M)}
    for name, x in vecs.items():
        if x is not None:
            dt, size = n[name]
            _expect(x, name, dt, (size,))
    if not 0 <= t < L:
        raise ValueError(f"t={t} outside the window [0, {L})")
    return M, R, L


def _check_ws(ws: torch.Tensor, M: int, R: int, dev) -> None:
    nbytes = eta_workspace_bytes(M, R)
    if (ws.dtype != torch.uint8 or not ws.is_contiguous()
            or ws.device != dev or ws.numel() < nbytes):
        raise ValueError(f"ws: want an eta_workspace({M}, {R}) on {dev}, "
                         f"got {ws.dtype} ({ws.numel()},) on {ws.device}")


# ---------------------------------------------------------------------------
# eta_ratio: the live entering column, the ratio test and the step between.

def eta_ratio_plain(Tt, C, F, b, ah, s: SeqScalars, t: int,
                    eps: float) -> None:
    """Plain version of ``eta_ratio``."""
    M, R = Tt.shape
    h = s.h.long().clamp(max=R - 1).view(1)
    ah.copy_(eta_live(Tt.index_select(1, h).view(M),
                      C.index_select(1, h).view(-1), F, t))
    _ratio_plain(b, s, ah, eps)


def eta_ratio(Tt, C, F, b, ah, s: SeqScalars, t: int, eps: float,
              ws=None) -> None:
    """Pivot t's entering column and ratio test with the step between
    (``simplex_tpu/solver.py:534-548``): ``ah = Tt[:, h] - sum_{s<t} C[s,
    h] F[s]`` (h clamped into the columns; ``eta_live``'s order and
    precision); k the first index of the smallest ``b / a_h`` over ``a_h
    >= eps`` (the quotient in V, a NaN
    first as ``torch.argmin`` orders it, the other rows +inf: with no
    eligible row k is 0); ``unb`` where no row is eligible; ``do = active
    and not (optimal or unb)``; ``p = a_h[k]`` where done, else 1; ``bk =
    b[k]``; ``u = minc / p`` where done, else 0 -- into ``s``. ``ws`` is an
    ``eta_workspace``; on the card a call without one allocates one. One
    launch on the card (``eta_plan``): one thread a row, each block's F
    slab sent for before h is read, the last block (an arrival ticket)
    folding the blocks' candidates and running the step."""
    M, R, L = _check(Tt, C, F, s, t, ah=ah, b=b)
    if not _on_card(Tt, C, F, b, ah, s.status):
        eta_ratio_plain(Tt, C, F, b, ah, s, t, eps)
        return
    pair = _pair(s)
    lib, check = _lib()
    if ws is None:
        ws = eta_workspace(M, R, Tt.device)
    _check_ws(ws, M, R, Tt.device)
    plan = eta_plan(M, R, L, Tt.element_size())
    err = lib.eta_ratio_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(b), _ptr(ah), M, R, L, t,
        float(eps), _ptr(ws), ws.numel(), ctypes.byref(_seq_ptrs(s)), pair,
        plan.rows, plan.cols, plan.stage_ratio, _stream(Tt))
    check(lib, err, "eta_ratio")
    LAUNCHES["eta_ratio"] += 1


# ---------------------------------------------------------------------------
# eta_colk: the live leaving row, C[t], the costs and weights, F[t], b and
# base, the next candidates and the step after.

def slice_weights(w, colk, p, wh, lvar) -> torch.Tensor:
    """The Forrest-Goldfarb weights after a done pivot before the
    re-anchor (``parallel.sharded.devex_update_sharded``'s): ``alpha =
    colk / p`` (T, widened); ``max(w, alpha^2 w_h)``; the leaving variable
    ``lvar`` (w's index, where it is one of its columns) ``max(w_h / p^2,
    1)``; capped at 1e12, NaN to 1."""
    R = w.shape[0]
    V = w.dtype
    alpha = (colk / p).to(V)
    w2 = torch.maximum(w, alpha * alpha * wh)
    is_l = torch.arange(R, device=w.device) == lvar
    w2 = torch.where(is_l, torch.maximum(wh / (p * p).to(V),
                                         torch.ones_like(wh)), w2)
    w2 = torch.minimum(w2, torch.full_like(w2, 1e12))
    return torch.where(torch.isnan(w2), 1.0, w2)


def devex_weights(w, colk, s: SeqScalars, lvar) -> torch.Tensor:
    """The Forrest-Goldfarb weights after a done pivot
    (``solver._devex_update``'s, on the loop's scalars):
    ``slice_weights`` with w_h the weight at h, then all ones when the
    largest passes 1e8 (the re-anchor)."""
    w2 = slice_weights(w, colk, s.p, _index(w, s.h, w.shape[0] - 1), lvar)
    return torch.where(w2.max() > 1e8, 1.0, w2)


def eta_colk_plain(Tt, C, F, costs, b, base, w, ah, s: SeqScalars, t: int,
                   r: int, eps: float, max_iter: int, bland_static: bool,
                   threshold, then_pre: bool) -> None:
    """Plain version of ``eta_colk``."""
    M, R = Tt.shape
    k = s.k.long().clamp(max=M - 1).view(1)
    lvar = base.index_select(0, k)              # before base changes
    colk = eta_live(Tt.index_select(0, k).view(R),
                    F.index_select(1, k).view(-1), C, t)
    C[t] = torch.where(s.do, colk, 0.0)
    costs.copy_(torch.where(s.do, costs - s.u * colk.to(costs.dtype), costs))
    if w is not None:
        w.copy_(torch.where(s.do, devex_weights(w, colk, s, lvar), w))
    f = _update_b(b, base, ah, s)
    is_k = torch.arange(M, device=Tt.device) == k
    F[t] = torch.where(s.do, torch.where(is_k, 1.0 - 1.0 / s.p, f), 0.0)
    set_candidates(s, eta_candidates(costs, w, r, eps))
    step_post_plain(s, max_iter, eps, bland_static, threshold, then_pre)


def eta_colk(Tt, C, F, costs, b, base, w, ah, s: SeqScalars, t: int, r: int,
             eps: float, max_iter: int, ws=None, *, bland_static: bool,
             threshold, then_pre: bool) -> None:
    """The rest of pivot t (``simplex_tpu/solver.py:549-582``, with the
    next pivot's entering choice ``:491-505`` and ``devex_update``
    ``:507-526``): ``colk =
    Tt[k] - sum_{s<t} F[s, k] C[s]`` (``eta_live``'s order and precision)
    into ``C[t]``
    (zeros where the pivot is skipped); where it is done ``costs -= u *
    colk`` (V), the devex weights (``w`` given; ``devex_weights``), ``b
    -= bk * (a_h / p)`` with ``b[k] = bk / p``, ``base[k] = h`` and ``F[t]
    = a_h / p`` with ``1 - 1/p`` at k (zeros where skipped); the next
    candidates over the costs of the live columns ``i < r``
    (``eta_candidates``) into ``s``; then ``step_post_plain``'s z, status,
    stall, bland and iterations and, with ``then_pre``, the next pivot's
    step before the ratio test. ``ws`` is an ``eta_workspace``. One launch
    on the card (``eta_plan``): one thread a column, each block's C slab
    sent for before k is read, blocks past the columns one thread a row of
    F[t] and b, the last column block (an arrival ticket) folding
    the candidates -- on the new weights and on weights of 1, keeping the
    latter on a re-anchor -- and running the step."""
    M, R, L = _check(Tt, C, F, s, t, costs=costs, b=b, base=base, w=w,
                     ah=ah)
    if not _on_card(Tt, C, F, costs, b, base, w, ah, s.status):
        eta_colk_plain(Tt, C, F, costs, b, base, w, ah, s, t, r, eps,
                       max_iter, bland_static, threshold, then_pre)
        return
    pair = _pair(s)
    lib, check = _lib()
    if ws is None:
        ws = eta_workspace(M, R, Tt.device)
    _check_ws(ws, M, R, Tt.device)
    plan = eta_plan(M, R, L, Tt.element_size())
    err = lib.eta_colk_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(costs), _ptr(b), _ptr(base),
        _ptr(w), _ptr(ah), M, R, L, r, t, float(eps), _ptr(ws), ws.numel(),
        ctypes.byref(_seq_ptrs(s)), max_iter,
        _bland_mode(bland_static, threshold),
        0 if threshold is None else int(threshold), int(then_pre), pair,
        plan.rows, plan.cols, plan.stage_colk, _stream(Tt))
    check(lib, err, "eta_colk")
    LAUNCHES["eta_colk"] += 1


# ---------------------------------------------------------------------------
# The sharded plain blocked loop's kernels on a rank's slice of the columns.

#: Entries of a slice's candidate send buffers (values f64, global indices
#: int32) by devex: [v_d, v_b] and [h_d, h_b]; under devex [v_d, v_b,
#: w[h_d], w[h_b], key, v_d1, key1] and [h_d, h_b, h_d1], the last of each
#: on weights of 1 (csrc/eta.cu SLICE_KV, SLICE_KI).
SLICE_PACK = {False: (2, 2), True: (7, 3)}


def pack_slice(costs, w, r: int, eps: float, offset: int, send_v, send_i,
               send_w=None) -> None:
    """A slice's entering candidates into the ``all_gather`` send buffers
    (``parallel.sharded.entering_sharded``'s ``vals``, ``idxs`` and
    riders): over the costs of the slice's ``r`` live columns, the Dantzig
    argmin (``w`` None) or the devex argmax of cost^2 / w over the eligible
    columns, its masked cost and global index; Bland's lowest eligible
    column (``BIG_INDEX`` and inf with none). Under devex also the weights
    at the two (1 for no Bland one), the devex key, the devex candidate on
    weights of 1 (key cost^2), and into ``send_w`` the slice's largest
    weight, which the re-anchor reads. Values widen exactly to f64."""
    R = costs.shape[0]
    iota = torch.arange(R, device=costs.device)
    masked = torch.where(iota < r, costs, torch.inf)
    eligible = masked <= -eps
    h_b = torch.where(eligible, iota, BIG_INDEX).min()
    has = h_b < BIG_INDEX
    vals = [None, torch.where(has, _index(masked, h_b, R - 1), torch.inf)]
    idx = [None, torch.where(has, offset + h_b, BIG_INDEX)]
    if w is None:
        h_d = torch.argmin(masked)
    else:
        c2 = masked * masked
        score = torch.where(eligible, c2 / w, -torch.inf)
        score1 = torch.where(eligible, c2, -torch.inf)
        h_d, h_d1 = torch.argmax(score), torch.argmax(score1)
        vals += [_index(w, h_d, R - 1),
                 torch.where(has, _index(w, h_b, R - 1), 1.0),
                 _index(score, h_d, R - 1), _index(masked, h_d1, R - 1),
                 _index(score1, h_d1, R - 1)]
        idx.append(offset + h_d1)
        send_w.copy_(w.max())
    vals[0], idx[0] = _index(masked, h_d, R - 1), offset + h_d
    send_v.copy_(torch.stack([v.to(send_v.dtype) for v in vals]))
    send_i.copy_(torch.stack([i.to(send_i.dtype) for i in idx]))


def slice_fold(V, I, W=None):
    """The fold of the candidates every rank packed (``pack_slice``'s
    layout, gathered: ``V`` (P, kv) f64, ``I`` (P, ki) int32, under devex
    ``W`` (P,) f64 every rank's largest weight): the re-anchor, where the
    largest weight passed 1e8; the main candidate from the first rank with
    the largest key (the devex key -- on weights of 1 where re-anchored --
    else -v_d; a NaN key anywhere: rank 0), the Bland one from the first
    rank with the lowest global index. Returns (h_d, v_d, w_d, h_b, v_b,
    w_b, reset), 0-dim, the weights 1 without devex or on a re-anchor."""
    devex = V.shape[1] == SLICE_PACK[True][0]
    one = torch.ones((), dtype=V.dtype, device=V.device)
    if not devex:
        key, vd, hd = -V[:, 0], V[:, 0], I[:, 0]
        reset = torch.zeros((), dtype=torch.bool, device=V.device)
    else:
        reset = W.max() > 1e8
        key = torch.where(reset, V[:, 6], V[:, 4])
        vd = torch.where(reset, V[:, 5], V[:, 0])
        hd = torch.where(reset, I[:, 2], I[:, 0])
    od = torch.argmax((key == key.max()).to(torch.int8))
    ob = torch.argmin(I[:, 1])
    w_d = w_b = one
    if devex:
        w_d = torch.where(reset, one, V[od, 2])
        w_b = torch.where(reset, one, V[ob, 3])
    return hd[od], vd[od], w_d, I[ob, 1], V[ob, 1], w_b, reset


def _check_slice_fold(V, I, W, w, wh, s: SeqScalars, R: int) -> None:
    """Raises unless the gathered buffers have ``pack_slice``'s layout and
    under devex (kv 7) W, w and wh are given (none of them else)."""
    P, kv = V.shape
    devex = kv == SLICE_PACK[True][0]
    if kv not in (2, SLICE_PACK[True][0]):
        raise ValueError(f"V: want (P, 2) or (P, 7), got {tuple(V.shape)}")
    _expect(V, "V", torch.float64, (P, kv))
    _expect(I, "I", torch.int32, (P, SLICE_PACK[devex][1]))
    if devex != (W is not None) or devex != (w is not None) \
            or devex != (wh is not None):
        raise ValueError("the devex fold takes W, w and wh, the others none")
    if devex:
        _expect(W, "W", torch.float64, (P,))
        _expect(w, "w", s.z.dtype, (R,))
        _expect(wh, "wh", s.z.dtype, ())


def eta_fold_column_plain(Tt, C, F, V, I, W, ah, w, wh, s: SeqScalars,
                          t: int, max_iter: int, eps: float,
                          offset: int) -> None:
    """Plain version of ``eta_fold_column``."""
    h_d, v_d, w_d, h_b, v_b, w_b, reset = slice_fold(V, I, W)
    vd = s.z.dtype
    set_candidates(s, (h_d, v_d.to(vd), h_b, v_b.to(vd)))
    step_pre_plain(s, max_iter, eps)
    if w is not None:
        use_b = s.bland & (s.h_b < BIG_INDEX)
        wh.copy_(torch.where(use_b, w_b, w_d))
        w.copy_(torch.where(reset, 1.0, w))
    M, R = Tt.shape
    loc = s.h.long() - offset
    own = (loc >= 0) & (loc < R)
    hl = loc.clamp(0, R - 1).view(1)
    col = eta_live(Tt.index_select(1, hl).view(M),
                   C.index_select(1, hl).view(-1), F, t)
    ah.copy_(torch.where(own, col, 0.0))


def eta_fold_column(Tt, C, F, V, I, W, ah, w, wh, s: SeqScalars, t: int,
                    max_iter: int, eps: float, offset: int) -> None:
    """Pivot t's head on a rank's slice ``Tt`` (M, R_loc) from global
    column ``offset`` (``simplex_tpu/parallel/sharded.py:411-440``: the
    entering fold and the owner's half of ``broadcast_live_row``): the fold
    of the gathered candidates (``slice_fold``) into ``s``'s h_d, v_d, h_b
    and v_b; the step before the ratio test (``seq_step_pre``'s active, h,
    minc and optimal; h global); under devex the weight at h into ``wh``
    and the slice's weights ``w`` reset to 1 where the largest of ``W``
    passed 1e8; then ``ah`` the live column ``Tt[:, hl] - sum_{s<t} C[s,
    hl] F[s]`` (hl = h - offset; ``eta_live``'s order and precision) where
    the slice owns h, else zeros. One launch on the card, on ``eta_plan``'s
    rows: one thread a row, each block's F slab sent for before the fold,
    one warp of each block folding the ranks (at most 32; block 0 storing
    the scalars)."""
    M, R, L = _check(Tt, C, F, s, t, ah=ah)
    _check_slice_fold(V, I, W, w, wh, s, R)
    if not _on_card(Tt, C, F, V, I, W, ah, w, wh, s.status):
        eta_fold_column_plain(Tt, C, F, V, I, W, ah, w, wh, s, t, max_iter,
                              eps, offset)
        return
    pair = _pair(s)
    lib, check = _lib()
    plan = eta_plan(M, R, L, Tt.element_size())
    err = lib.eta_fold_column_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(ah), M, R, L, t, offset, _ptr(V),
        _ptr(I), _ptr(W), V.shape[0], V.shape[1], _ptr(w), _ptr(wh),
        ctypes.byref(_seq_ptrs(s)), max_iter, float(eps), pair, plan.rows,
        plan.stage_ratio, _stream(Tt))
    check(lib, err, "eta_fold_column")
    SLICE_LAUNCHES["eta_fold_column"] += 1


def eta_ratio_summed_plain(b, ah, s: SeqScalars, eps: float) -> None:
    """Plain version of ``eta_ratio_summed``."""
    _ratio_plain(b, s, ah, eps)


def eta_ratio_summed(b, ah, s: SeqScalars, eps: float) -> None:
    """``eta_ratio``'s ratio test and step between on the column the
    ``all_reduce`` summed into ``ah`` (``simplex_tpu/parallel/sharded.py:
    441-447``): k, unb, do, p, bk and u into ``s``. One launch on the card:
    one thread-block cluster whose blocks fold over distributed shared
    memory (the sequential sharded loop's ratio test), launched as a
    programmatic dependent launch behind ``eta_fold_column``; no
    workspace."""
    M = ah.shape[0]
    _expect(ah, "ah", s.p.dtype, (M,))
    _expect(b, "b", s.z.dtype, (M,))
    if not _on_card(b, ah, s.status):
        eta_ratio_summed_plain(b, ah, s, eps)
        return
    pair = _pair(s)
    lib, check = _lib()
    err = lib.eta_ratio_summed_launch(
        _ptr(b), _ptr(ah), M, float(eps), ctypes.byref(_seq_ptrs(s)), pair,
        _stream(ah))
    check(lib, err, "eta_ratio_summed")
    SLICE_LAUNCHES["eta_ratio_summed"] += 1


def eta_colk_slice_plain(Tt, C, F, costs, b, base, w, ah, s: SeqScalars,
                         t: int, r: int, eps: float, max_iter: int,
                         offset: int, wh, send_v, send_i, send_w,
                         bland_static: bool, threshold) -> None:
    """Plain version of ``eta_colk_slice``."""
    M, R = Tt.shape
    k = s.k.long().clamp(max=M - 1).view(1)
    lvar = base.index_select(0, k) - offset     # before base changes
    colk = eta_live(Tt.index_select(0, k).view(R),
                    F.index_select(1, k).view(-1), C, t)
    C[t] = torch.where(s.do, colk, 0.0)
    costs.copy_(torch.where(s.do, costs - s.u * colk.to(costs.dtype), costs))
    if w is not None:
        w.copy_(torch.where(s.do, slice_weights(w, colk, s.p, wh, lvar), w))
    f = _update_b(b, base, ah, s)
    is_k = torch.arange(M, device=Tt.device) == k
    F[t] = torch.where(s.do, torch.where(is_k, 1.0 - 1.0 / s.p, f), 0.0)
    pack_slice(costs, w, r, eps, offset, send_v, send_i, send_w)
    step_post_plain(s, max_iter, eps, bland_static, threshold, False)


def eta_colk_slice(Tt, C, F, costs, b, base, w, ah, s: SeqScalars, t: int,
                   r: int, eps: float, max_iter: int, ws=None, *,
                   offset: int, wh, send_v, send_i, send_w,
                   bland_static: bool, threshold) -> None:
    """``eta_colk`` on a rank's slice ``Tt`` (M, R_loc) from global column
    ``offset`` (``simplex_tpu/parallel/sharded.py:448-466``): the live
    leaving row into ``C[t]``, the slice's costs and, under devex, its
    weights (``slice_weights`` with the fold's ``wh``, the leaving variable
    by its global column), F[t], b and ``base[k] = h`` (h global) where the
    pivot is done; the candidates over the slice's ``r`` live columns
    packed into the send buffers (``pack_slice``; ``send_w`` the slice's
    largest weight under devex); then the step after without the next step
    before. No re-anchor: the next ``eta_fold_column`` applies it from
    every rank's largest weight. One launch on the card: ``eta_colk``'s
    grid and plan, the last column block packing in place of the
    re-anchor, the weights at the candidates carried with them through
    the folds."""
    M, R, L = _check(Tt, C, F, s, t, costs=costs, b=b, base=base, w=w,
                     ah=ah)
    devex = w is not None
    kv, ki = SLICE_PACK[devex]
    _expect(send_v, "send_v", torch.float64, (kv,))
    _expect(send_i, "send_i", torch.int32, (ki,))
    if devex:
        _expect(wh, "wh", s.z.dtype, ())
        _expect(send_w, "send_w", torch.float64, ())
    elif wh is not None or send_w is not None:
        raise ValueError("wh and send_w go with the devex weights")
    if not _on_card(Tt, C, F, costs, b, base, w, ah, wh, send_v, send_i,
                    send_w, s.status):
        eta_colk_slice_plain(Tt, C, F, costs, b, base, w, ah, s, t, r, eps,
                             max_iter, offset, wh, send_v, send_i, send_w,
                             bland_static, threshold)
        return
    pair = _pair(s)
    lib, check = _lib()
    if ws is None:
        ws = eta_workspace(M, R, Tt.device)
    _check_ws(ws, M, R, Tt.device)
    plan = eta_plan(M, R, L, Tt.element_size())
    err = lib.eta_colk_slice_launch(
        _ptr(Tt), _ptr(C), _ptr(F), _ptr(costs), _ptr(b), _ptr(base),
        _ptr(w), _ptr(ah), M, R, L, r, t, float(eps), _ptr(ws), ws.numel(),
        ctypes.byref(_seq_ptrs(s)), max_iter,
        _bland_mode(bland_static, threshold),
        0 if threshold is None else int(threshold), pair, plan.rows,
        plan.cols, plan.stage_colk, offset, _ptr(wh), _ptr(send_v),
        _ptr(send_i), _ptr(send_w), _stream(Tt))
    check(lib, err, "eta_colk_slice")
    SLICE_LAUNCHES["eta_colk_slice"] += 1
