"""The sequential loops' per-pivot kernels: ``solver.solve_loop`` and
``solve_loop_pallas`` as one CUDA graph a chunk of ``SEQ_CHUNK`` pivots.

No Pallas kernel stands behind these: in the JAX package the sequential
loops are ``lax.while_loop``s whose pivot XLA fuses
(``simplex_tpu/solver.py:116-157`` ``iteration_body``, ``:239-294`` the
K6 loop's body). The port's eager loop ran a pivot as about 40 torch
calls; here a pivot of the default loop is two kernels --

* ``seq_ratio_colk`` (one thread-block cluster): the entering column
  ``a_h = Tt[:, h]`` gathered into a fixed buffer, the ratio test and the
  step between (k, bk, unbounded, do, p, u) -- ``seq_ratio`` -- then the
  leaving row ``colk = Tt[k]`` copied into a fixed buffer, the costs
  updated and the next candidates folded, ``factor = a_h / p`` and b
  updated, ``base[k] = h``, the step after the pivot and the next pivot's
  step before the ratio test -- ``seq_colk``;
* ``seq_rank1``: ``Tt -= factor colk^T`` with row k written as ``colk /
  p`` (``csrc/pivot.cu``, ``batch_rank1``'s tiles at one lane);

and of the K6 loop two as well --

* ``seq_ratio_snapshot`` (one cluster, pure f32): ``seq_ratio``, then
  the snapshot K6 reads -- the copy of row k, b and base -- as its tail
  ``seq_snapshot``;
* K6 (``fused_pivot``'s pass) with its fold and the step after it as
  the tail of its last tile block (``fused_pivot_tail``).

``seq_step_pre`` runs once a chunk, before the chunk's first pivot.
``seq_ratio`` alone (one cluster) stays, the baseline of its tails'
own cost.

The sequential sharded loop (``parallel.sharded.solve_loop_sharded``, the
JAX loop under ``shard_map``, ``simplex_tpu/parallel/sharded.py:240-286``)
runs on each rank's slice, after the two ``all_gather``s of the
candidates every rank packed --

* ``seq_fold_column``: the fold of the gathered candidates and the step
  before the ratio test as its head, then the owner's column (zeros on
  the other ranks) into ``ah``, which an ``all_reduce`` sums in place;
* ``seq_ratio_colk_sharded`` (one cluster): ``seq_ratio_colk``'s form
  with the ratio test on the summed ``ah``, the slice's candidates packed
  into the send buffers and no next step before;
* ``seq_rank1`` on the slice.

As in the other kernel modules each has a hand-written CUDA kernel
(``csrc/seq.cu``, ``csrc/pivot.cu``; the step's body ``csrc/seq_step.cuh``)
built at first use, a plain PyTorch version taken for CPU tensors (and by
``chip_smoke.py`` as the kernel's reference on the card), and a launch
counter in ``LAUNCHES``. A wrapper given CUDA tensors launches its kernel
or raises: a cluster the card cannot launch raises too.

Dtypes: the tableau ``Tt (M, R)`` of T, b, the costs and z of V: (f64,
f64), (f32, f64) and (f32, f32) have kernels; the plain versions take any
pair. The loop's scalars are ``SeqScalars``, each a 0-dim tensor only
ever updated in place, since a CUDA graph bakes in every pointer.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .blocked import (BIG_INDEX, RUNNING, _bland_mode, _cdiv, _expect,
                      _index, _on_card, _ptr, _stream, entering_candidates,
                      fold_owners, step_post_plain, step_pre_plain)
from .pivot import LAUNCHES as PIVOT_LAUNCHES
from .pivot import COLS, fused_pivot_plain, rank1_plan

#: Launches of each kernel since the last ``reset_launches``. A tail runs
#: inside its carrier's launch (``TAILS``) and counts beside it: the pass
#: ``seq_colk`` inside ``seq_ratio_colk`` and the snapshot
#: ``seq_snapshot`` inside ``seq_ratio_snapshot``, both counted as
#: ``seq_ratio``, and K6's fold with the step after it (``seq_k6_tail``)
#: in K6's last tile block, counted in ``kernels.pivot.LAUNCHES``.
LAUNCHES = {"seq_step_pre": 0, "seq_ratio": 0, "seq_colk": 0,
            "seq_rank1": 0, "seq_snapshot": 0, "seq_k6_tail": 0,
            "seq_fold_column": 0, "seq_ratio_colk_sharded": 0}
TAILS = {"seq_colk": "seq_ratio", "seq_snapshot": "seq_ratio",
         "seq_k6_tail": "fused_pivot"}

_F64, _F32, _I32, _BOOL = torch.float64, torch.float32, torch.int32, \
    torch.bool

#: The (tableau, vector) dtype pairs the kernels take (csrc/seq.cu Pair).
PAIRS = {(_F64, _F64): 0, (_F32, _F64): 1, (_F32, _F32): 2}

#: The clusters' shape (csrc/seq.cu): blocks, threads a block, and the
#: rows or columns a thread loads at a time; ``seq_ratio_colk_sharded``
#: takes ``SHARDED_THREADS_WIDE`` threads a block on wider slices.
CLUSTER_BLOCKS, CLUSTER_THREADS, CLUSTER_PER = 16, 256, 4
SHARDED_THREADS_WIDE = 512


def seq_sharded_threads(R: int) -> int:
    """Threads a block of ``seq_ratio_colk_sharded``'s cluster on a slice
    of ``R`` columns: ``CLUSTER_THREADS`` where one pass of the cluster's
    loads (blocks x threads x ``CLUSTER_PER``) covers the slice's columns,
    so each thread's loads of row k go out together; else
    ``SHARDED_THREADS_WIDE``, which covers twice as many."""
    one_pass = CLUSTER_BLOCKS * CLUSTER_THREADS * CLUSTER_PER
    return CLUSTER_THREADS if R <= one_pass else SHARDED_THREADS_WIDE


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_INT = ("status", "iterations", "stall", "h_d", "h_b", "h", "k")
_FLAG = ("bland", "active", "optimal", "unb", "do")
_VEC = ("z", "v_d", "v_b", "minc", "bk", "u")


@dataclasses.dataclass
class SeqScalars:
    """The 0-dim tensors of the sequential loops' step, each only ever
    updated in place. The first nine are the carry (z and the candidates'
    values in the vectors' dtype V); the rest one pivot's intermediates:
    the step before ``seq_ratio`` writes active, h, minc and optimal;
    ``seq_ratio`` writes k, bk, unb, do, p (the tableau's dtype T) and u.
    The field order is ``csrc/seq_step.cuh``'s ``SeqStep``."""

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
    bk: torch.Tensor
    unb: torch.Tensor
    do: torch.Tensor
    p: torch.Tensor
    u: torch.Tensor

    def __post_init__(self):
        dev, vd = self.status.device, self.z.dtype
        for name, x in self.tensors().items():
            dt = (_I32 if name in _INT else _BOOL if name in _FLAG
                  else vd if name in _VEC else self.p.dtype)
            _expect(x, name, dt, ())
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, status on {dev}")
        if not (vd.is_floating_point and self.p.dtype.is_floating_point):
            raise ValueError(f"z {vd}, p {self.p.dtype}: want float dtypes")

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def seq_scalars(z: torch.Tensor, bland: bool,
                tdtype: torch.dtype) -> SeqScalars:
    """A loop's scalars at its start: status RUNNING, no iterations, no
    stall, ``bland`` as given, a copy of ``z`` (its dtype is the vectors'),
    p of the tableau's dtype ``tdtype``, the rest zero."""
    dev, vd = z.device, z.dtype
    vals = {"status": RUNNING, "bland": bland}
    x = {}
    for f in dataclasses.fields(SeqScalars):
        dt = (_I32 if f.name in _INT else _BOOL if f.name in _FLAG
              else vd if f.name in _VEC else tdtype)
        x[f.name] = torch.full((), vals.get(f.name, 0), dtype=dt, device=dev)
    x["z"] = z.reshape(()).clone()
    return SeqScalars(**x)


def set_candidates(s: SeqScalars, cands) -> None:
    """Copy (h_d, v_d, h_b, v_b) into ``s``."""
    for dst, src in zip((s.h_d, s.v_d, s.h_b, s.v_b), cands):
        dst.copy_(src)


class _SeqPtrs(ctypes.Structure):
    """``SeqScalars``' device pointers in its field order: the host's copy
    of csrc/seq_step.cuh's ``SeqStep``."""

    _fields_ = [(f.name, ctypes.c_void_p)
                for f in dataclasses.fields(SeqScalars)]


def _seq_ptrs(s: SeqScalars) -> _SeqPtrs:
    return _SeqPtrs(*(x.data_ptr() for x in s.tensors().values()))


def _pair(s: SeqScalars) -> int:
    """The kernels' code of the scalars' (T, V) pair; raises for a pair
    with no kernel."""
    pair = PAIRS.get((s.p.dtype, s.z.dtype))
    if pair is None:
        raise ValueError(f"no sequential kernel for a {s.p.dtype} tableau "
                         f"with {s.z.dtype} vectors")
    return pair


def _lib():
    from ._build import check, load_library

    return load_library(), check


def _policy(bland_static: bool, threshold) -> tuple[int, int]:
    return (_bland_mode(bland_static, threshold),
            0 if threshold is None else int(threshold))


# ---------------------------------------------------------------------------
# The step before the chunk's first pivot.

def seq_step_pre(s: SeqScalars, max_iter: int, eps: float) -> None:
    """The step before ``seq_ratio`` (``solver.choose_entering`` on the
    folded candidates): ``active = status == RUNNING and iterations <
    max_iter``; the Bland candidate where ``bland`` is on and one is
    eligible, else the Dantzig one, gives ``h`` and ``minc``; ``optimal =
    minc > -eps``. Plain version: ``kernels.blocked.step_pre_plain``. One
    thread on the card, once a chunk: within it the step runs as the tail
    of ``seq_ratio_colk`` or of K6's last tile block."""
    if not _on_card(s.status):
        step_pre_plain(s, max_iter, eps)
        return
    lib, check = _lib()
    err = lib.seq_step_pre_launch(ctypes.byref(_seq_ptrs(s)), max_iter,
                                  float(eps), _pair(s), _stream(s.status))
    check(lib, err, "seq_step_pre")
    LAUNCHES["seq_step_pre"] += 1


# ---------------------------------------------------------------------------
# seq_ratio: the entering column, the ratio test and the step between.

def seq_ratio_plain(Tt, b, s: SeqScalars, ah, eps: float) -> None:
    """Plain version of ``seq_ratio``: ``solver.ratio_test`` on the
    column ``Tt[:, h]`` and ``iteration_body``'s do and p, as they ran
    eagerly."""
    M, R = Tt.shape
    ah.copy_(Tt.index_select(1, s.h.long().clamp(max=R - 1).view(1))
             .view(M))
    _ratio_plain(b, s, ah, eps)


def _ratio_plain(b, s: SeqScalars, ah, eps: float) -> None:
    """The ratio test on the column ``ah`` and the step between."""
    M = ah.shape[0]
    mask = ah >= eps
    k = torch.argmin(torch.where(mask, b / torch.where(mask, ah, 1.0),
                                 torch.inf))
    unb = ~mask.any()
    do = s.active & ~(s.optimal | unb)
    p = torch.where(do, _index(ah, k, M - 1), 1.0)
    s.k.copy_(k)
    s.unb.copy_(unb)
    s.do.copy_(do)
    s.p.copy_(p)
    s.bk.copy_(_index(b, k, M - 1))
    s.u.copy_(torch.where(do, s.minc / p.to(s.u.dtype), 0.0))


def seq_ratio(Tt, b, s: SeqScalars, ah, eps: float) -> None:
    """The entering column and the ratio test (``simplex_tpu/solver.py:
    99-113`` with ``iteration_body``'s step between, ``:127-137``):
    ``ah = Tt[:, h]`` (h clamped into the columns); k the first index of
    the smallest ``b / a_h`` over ``a_h >= eps`` (the quotient in V, a
    NaN first as ``torch.argmin`` orders it, the other rows +inf: with no
    eligible row k is 0); ``unb`` where no row is eligible; ``do = active
    and not (optimal or unb)``; ``p = a_h[k]`` where done, else 1; ``bk =
    b[k]``; ``u = minc / p`` where done, else 0. One cluster on the card
    (the K6 loop's; the default loop's runs inside ``seq_ratio_colk``)."""
    M, R = Tt.shape
    _expect(Tt, "Tt", s.p.dtype, (M, R))
    _expect(b, "b", s.z.dtype, (M,))
    _expect(ah, "ah", s.p.dtype, (M,))
    if not _on_card(Tt, b, ah, s.status):
        seq_ratio_plain(Tt, b, s, ah, eps)
        return
    pair = _pair(s)
    lib, check = _lib()
    err = lib.seq_ratio_launch(_ptr(Tt), _ptr(b), M, R, float(eps), _ptr(ah),
                               ctypes.byref(_seq_ptrs(s)), pair, _stream(Tt))
    check(lib, err, "seq_ratio")
    LAUNCHES["seq_ratio"] += 1


# ---------------------------------------------------------------------------
# seq_colk: the leaving row, costs, candidates, b and base, the step after;
# on the card the second half of seq_ratio_colk.

def _update_b(b, base, ah, s: SeqScalars):
    """b and base of a done pivot (``solver.pivot_update``'s vector half
    without the costs): ``factor = a_h / p``, ``b -= bk * factor``, ``b[k]
    = bk / p``, ``base[k] = h``. Returns factor."""
    M = b.shape[0]
    f = ah / s.p
    is_k = torch.arange(M, device=b.device) == s.k.long()
    b.copy_(torch.where(s.do, torch.where(is_k, s.bk / s.p.to(b.dtype),
                                          b - s.bk * f.to(b.dtype)), b))
    base.copy_(torch.where(s.do & is_k, s.h, base))
    return f


def seq_colk_plain(Tt, costs, b, base, ah, colk, fac, s: SeqScalars, r: int,
                   eps: float, max_iter: int, bland_static: bool, threshold,
                   then_pre: bool) -> None:
    """The pivot row's pass and the step after (``solver.pivot_update``'s
    vector half, ``choose_entering`` of the next pivot, ``iteration_body``'s
    status and anti-cycling, ``simplex_tpu/solver.py:51-96, 139-157``):
    ``colk = Tt[k]`` (always: the rank-1 update reads it); where the pivot
    is done, ``costs -= u * colk`` (V), ``fac = a_h / p`` (T), ``b -= bk *
    fac`` with ``b[k] = bk / p`` (V) and ``base[k] = h``; the next
    candidates over the costs of the live columns ``i < r`` into ``s``
    (``entering_candidates``: the Dantzig argmin in ``torch.argmin``'s
    order, Bland's lowest eligible index); then
    ``kernels.blocked.step_post_plain``'s z, status, stall, bland and
    iterations and, with ``then_pre``, the next pivot's step before the
    ratio test. On the card it runs as the second half of
    ``seq_ratio_colk``."""
    _colk_plain(Tt, costs, b, base, ah, colk, fac, s)
    set_candidates(s, entering_candidates(costs, None, r, eps))
    step_post_plain(s, max_iter, eps, bland_static, threshold, then_pre)


def _colk_plain(Tt, costs, b, base, ah, colk, fac, s: SeqScalars) -> None:
    """The pivot row's pass: colk, and the costs, the factors, b and base
    of a done pivot."""
    R = Tt.shape[1]
    colk.copy_(Tt.index_select(0, s.k.long().view(1)).view(R))
    costs.copy_(torch.where(s.do, costs - s.u * colk.to(costs.dtype), costs))
    f = _update_b(b, base, ah, s)
    fac.copy_(torch.where(s.do, f, fac))


def seq_ratio_colk(Tt, costs, b, base, ah, colk, fac, s: SeqScalars, r: int,
                   eps: float, max_iter: int, *, bland_static: bool,
                   threshold, then_pre: bool) -> None:
    """A pivot of the default loop but its rank-1 update: ``seq_ratio``
    (the ratio test and the step between) then ``seq_colk_plain``'s pass
    and step after, with one ``eps``. One launch on the card: one
    thread-block cluster (``csrc/seq.cu`` ``seq_ratio_colk_kernel``) whose
    blocks fold the ratio test over distributed shared memory, each run
    the step between, then the pass, block 0 folding the candidates and
    running the step after; it counts a launch of ``seq_ratio`` and one
    of ``seq_colk`` (``TAILS``)."""
    M, R = Tt.shape
    T, V = s.p.dtype, s.z.dtype
    _expect(Tt, "Tt", T, (M, R))
    for name, x, dt, n in (("costs", costs, V, R), ("b", b, V, M),
                           ("base", base, _I32, M), ("ah", ah, T, M),
                           ("colk", colk, T, R), ("fac", fac, T, M)):
        _expect(x, name, dt, (n,))
    if not _on_card(Tt, costs, b, base, ah, colk, fac, s.status):
        seq_ratio_plain(Tt, b, s, ah, eps)
        seq_colk_plain(Tt, costs, b, base, ah, colk, fac, s, r, eps,
                       max_iter, bland_static, threshold, then_pre)
        return
    pair = _pair(s)
    lib, check = _lib()
    err = lib.seq_ratio_colk_launch(
        _ptr(Tt), _ptr(costs), _ptr(b), _ptr(base), _ptr(ah), _ptr(colk),
        _ptr(fac), M, R, r, float(eps), ctypes.byref(_seq_ptrs(s)), max_iter,
        *_policy(bland_static, threshold), int(then_pre), pair, _stream(Tt))
    check(lib, err, "seq_ratio_colk")
    LAUNCHES["seq_ratio"] += 1
    LAUNCHES["seq_colk"] += 1


# ---------------------------------------------------------------------------
# The sequential sharded loop's kernels: seq_fold_column, and
# seq_ratio_colk's sharded form.

def pack_candidates(cands, offset: int, send_v, send_i) -> None:
    """A slice's candidates ``(h_d, v_d, h_b, v_b)`` (local columns, as
    ``entering_candidates`` gives them) into the ``all_gather`` send
    buffers (``entering_sharded``'s ``vals`` and ``idxs``,
    ``parallel/sharded.py``): ``send_v`` (2,) f64 ``[v_d, v_b]``,
    ``send_i`` (2,) int32 the global indices, ``BIG_INDEX`` kept. The
    values widen exactly to f64, and the fold orders them as in their own
    dtype."""
    h_d, v_d, h_b, v_b = cands
    send_v.copy_(torch.stack([v_d.to(send_v.dtype), v_b.to(send_v.dtype)]))
    send_i.copy_(torch.stack([
        (offset + h_d.long()),
        torch.where(h_b >= BIG_INDEX, BIG_INDEX, offset + h_b.long())])
        .to(send_i.dtype))


def _check_gathered(V, I) -> None:
    P = V.shape[0]
    _expect(V, "V", _F64, (P, 2))
    _expect(I, "I", _I32, (P, 2))


def seq_fold_column_plain(Tt, V, I, ah, s: SeqScalars, max_iter: int,
                          eps: float, offset: int) -> None:
    """Plain version of ``seq_fold_column``: ``fold_candidates``' fold and
    ``entering_sharded``'s choice (``parallel/sharded.py``), then
    ``gather_column``'s owner column before its ``all_reduce``."""
    od, ob = fold_owners(V, I)
    set_candidates(s, (I[od, 0], V[od, 0], I[ob, 1], V[ob, 1]))
    step_pre_plain(s, max_iter, eps)
    M, R = Tt.shape
    loc = s.h.long() - offset
    own = (loc >= 0) & (loc < R)
    col = Tt.index_select(1, loc.clamp(0, R - 1).view(1)).view(M)
    ah.copy_(torch.where(own, col, 0.0))


def seq_fold_column(Tt, V, I, ah, s: SeqScalars, max_iter: int, eps: float,
                    offset: int) -> None:
    """The sequential sharded loop's first kernel a pivot
    (``simplex_tpu/parallel/sharded.py:118-178``, ``entering_sharded`` and
    the owner's half of ``broadcast_entering_column``): the fold of the
    candidates every rank packed, ``V`` (P, 2) f64 and ``I`` (P, 2)
    int32 -- the main one from the first rank with the smallest value (a
    NaN anywhere: rank 0), the Bland one from the first rank with the
    lowest global index -- into ``s``'s h_d, v_d, h_b and v_b; the step
    before the ratio test (``seq_step_pre``'s active, h, minc and
    optimal; h global); then ``ah`` the slice's column ``h - offset``
    where this rank's slice of ``Tt``'s columns owns h, else zeros. On the
    card one grid, one thread a row, every warp folding by shuffles (block
    0's first thread storing the scalars)."""
    M, R = Tt.shape
    _expect(Tt, "Tt", s.p.dtype, (M, R))
    _expect(ah, "ah", s.p.dtype, (M,))
    _check_gathered(V, I)
    if not _on_card(Tt, V, I, ah, s.status):
        seq_fold_column_plain(Tt, V, I, ah, s, max_iter, eps, offset)
        return
    pair = _pair(s)
    lib, check = _lib()
    err = lib.seq_fold_column_launch(
        _ptr(Tt), _ptr(V), _ptr(I), V.shape[0], M, R, offset, _ptr(ah),
        ctypes.byref(_seq_ptrs(s)), max_iter, float(eps), pair, _stream(Tt))
    check(lib, err, "seq_fold_column")
    LAUNCHES["seq_fold_column"] += 1


def seq_ratio_colk_sharded_plain(Tt, costs, b, base, ah, colk, fac,
                                 s: SeqScalars, r: int, eps: float,
                                 max_iter: int, offset: int, send_v, send_i,
                                 bland_static: bool, threshold) -> None:
    """Plain version of ``seq_ratio_colk_sharded``: ``iteration_body_
    sharded``'s ratio test on the summed column and ``pivot_update``'s
    vector half on the slice, as they ran eagerly; the candidates packed
    as ``entering_sharded`` packed them; ``step_post_plain`` without the
    next step before."""
    _ratio_plain(b, s, ah, eps)
    _colk_plain(Tt, costs, b, base, ah, colk, fac, s)
    pack_candidates(entering_candidates(costs, None, r, eps), offset,
                    send_v, send_i)
    step_post_plain(s, max_iter, eps, bland_static, threshold, False)


def seq_ratio_colk_sharded(Tt, costs, b, base, ah, colk, fac, s: SeqScalars,
                           r: int, eps: float, max_iter: int, *,
                           offset: int, send_v, send_i, bland_static: bool,
                           threshold) -> None:
    """A pivot of the sequential sharded loop but its rank-1 update, on a
    rank's slice ``Tt`` (M, R_loc) from global column ``offset``
    (``simplex_tpu/parallel/sharded.py:253-279``): ``seq_ratio``'s test
    and step between on ``ah``, the column the ``all_reduce`` summed;
    ``seq_colk_plain``'s pass on the slice (colk, the costs, the factors,
    b and ``base[k] = h``, h global); the candidates over the slice's
    ``r`` live columns packed into ``send_v`` and ``send_i``
    (``pack_candidates``) for the next pivot's ``all_gather``s; then the
    step after without the next step before, which needs them folded.
    One launch on the card: ``seq_ratio_colk``'s cluster with the test
    reading ``ah`` and the pack in block 0's tail, of
    ``seq_sharded_threads(R)`` threads a block, a programmatic dependent
    launch behind ``seq_fold_column``."""
    M, R = Tt.shape
    T, V = s.p.dtype, s.z.dtype
    _expect(Tt, "Tt", T, (M, R))
    for name, x, dt, n in (("costs", costs, V, R), ("b", b, V, M),
                           ("base", base, _I32, M), ("ah", ah, T, M),
                           ("colk", colk, T, R), ("fac", fac, T, M),
                           ("send_v", send_v, _F64, 2),
                           ("send_i", send_i, _I32, 2)):
        _expect(x, name, dt, (n,))
    if not _on_card(Tt, costs, b, base, ah, colk, fac, send_v, send_i,
                    s.status):
        seq_ratio_colk_sharded_plain(Tt, costs, b, base, ah, colk, fac, s, r,
                                     eps, max_iter, offset, send_v, send_i,
                                     bland_static, threshold)
        return
    pair = _pair(s)
    lib, check = _lib()
    err = lib.seq_ratio_colk_sharded_launch(
        _ptr(Tt), _ptr(costs), _ptr(b), _ptr(base), _ptr(ah), _ptr(colk),
        _ptr(fac), M, R, r, float(eps), ctypes.byref(_seq_ptrs(s)), max_iter,
        *_policy(bland_static, threshold), offset, _ptr(send_v),
        _ptr(send_i), seq_sharded_threads(R), pair, _stream(Tt))
    check(lib, err, "seq_ratio_colk_sharded")
    LAUNCHES["seq_ratio_colk_sharded"] += 1


def seq_snapshot_plain(Tt, b, base, ah, colk, s: SeqScalars) -> None:
    """The K6 loop's snapshot after the ratio test (``simplex_tpu/
    solver.py:253-283`` without K6 and the step after it): ``colk =
    Tt[k]``, the row K6 reads while it overwrites row k; where the pivot
    is done ``b -= bk * (a_h / p)`` with ``b[k] = bk / p`` and ``base[k] =
    h``. On the card the tail of ``seq_ratio_snapshot``."""
    R = Tt.shape[1]
    colk.copy_(Tt.index_select(0, s.k.long().view(1)).view(R))
    _update_b(b, base, ah, s)


def _check_rows16(R: int, **xs: torch.Tensor) -> None:
    """Raises unless the f32 rows of ``xs`` go 16 bytes a load: R a
    multiple of 4, each tensor 16-byte aligned."""
    if R % 4:
        raise ValueError(f"R={R}: the K6 loop's kernels take whole 16-byte "
                         "rows (R a multiple of 4)")
    for name, x in xs.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def seq_ratio_snapshot_plain(Tt, b, base, ah, colk, s: SeqScalars,
                             eps: float) -> None:
    """Plain version of ``seq_ratio_snapshot``: ``seq_ratio_plain``, then
    ``seq_snapshot_plain``."""
    seq_ratio_plain(Tt, b, s, ah, eps)
    seq_snapshot_plain(Tt, b, base, ah, colk, s)


def seq_ratio_snapshot(Tt, b, base, ah, colk, s: SeqScalars,
                       eps: float) -> None:
    """The K6 loop's pivot before K6: ``seq_ratio`` (the entering column,
    the ratio test and the step between), then ``seq_snapshot_plain``'s
    copy of row k and, where the pivot is done, b and base. Pure f32, R a
    multiple of 4, Tt and colk 16-byte aligned (the row goes 16 bytes a
    load). One launch on the card: one thread-block cluster
    (``csrc/seq.cu`` ``seq_ratio_snapshot_kernel``) whose blocks each fold
    the ratio test over distributed shared memory, run the step between
    and take their share of the row and of b; it counts a launch of
    ``seq_ratio`` and one of ``seq_snapshot`` (``TAILS``)."""
    M, R = Tt.shape
    _expect(Tt, "Tt", _F32, (M, R))
    for name, x, dt, n in (("b", b, _F32, M), ("base", base, _I32, M),
                           ("ah", ah, _F32, M), ("colk", colk, _F32, R)):
        _expect(x, name, dt, (n,))
    if not _on_card(Tt, b, base, ah, colk, s.status):
        seq_ratio_snapshot_plain(Tt, b, base, ah, colk, s, eps)
        return
    _check_rows16(R, Tt=Tt, colk=colk)
    pair = _pair(s)
    lib, check = _lib()
    err = lib.seq_ratio_snapshot_launch(
        _ptr(Tt), _ptr(b), _ptr(base), _ptr(ah), _ptr(colk), M, R,
        float(eps), ctypes.byref(_seq_ptrs(s)), pair, _stream(Tt))
    check(lib, err, "seq_ratio_snapshot")
    LAUNCHES["seq_ratio"] += 1
    LAUNCHES["seq_snapshot"] += 1


# ---------------------------------------------------------------------------
# seq_rank1: the tableau's update.

def seq_rank1_plain(Tt, fac, colk, s: SeqScalars) -> None:
    """Plain version of ``seq_rank1``: the eager loop's ``Tt.addr_(factor,
    colk, alpha=-1)`` and ``Tt[k] = colk / p``, on a done pivot only (one
    host read of ``do``)."""
    if bool(s.do):
        Tt.addr_(fac, colk, alpha=-1.0)
        Tt.index_copy_(0, s.k.long().view(1), (colk / s.p)[None])


def seq_rank1(Tt, fac, colk, s: SeqScalars) -> None:
    """The rank-1 update of a done pivot (``simplex_tpu/solver.py:51-76``
    ``pivot_update``'s tableau half): ``Tt[j] -= fac[j] * colk`` for every
    row j but k, the product and the difference rounded apart as
    ``Tt.addr_`` rounds on the card, and ``Tt[k] = colk / p``. A skipped
    pivot leaves Tt untouched (the eager loop's ``addr_`` with factor 0
    turned a ±inf or NaN of colk into NaN rows; the JAX ``while_loop``
    runs no such pivot). On the card ``batch_rank1``'s tiles at one lane
    (``kernels.pivot.rank1_plan``), returning at once when ``do`` is
    false."""
    M, R = Tt.shape
    T = s.p.dtype
    _expect(Tt, "Tt", T, (M, R))
    _expect(fac, "fac", T, (M,))
    _expect(colk, "colk", T, (R,))
    if not _on_card(Tt, fac, colk, s.status):
        seq_rank1_plain(Tt, fac, colk, s)
        return
    lib, check = _lib()
    plan = rank1_plan(1, M, R, Tt.element_size())
    err = lib.seq_rank1_launch(_ptr(Tt), _ptr(fac), _ptr(colk), _ptr(s.do),
                               _ptr(s.k), _ptr(s.p), M, R, Tt.element_size(),
                               plan.vecs, plan.tiles, _stream(Tt))
    check(lib, err, "seq_rank1")
    LAUNCHES["seq_rank1"] += 1


# ---------------------------------------------------------------------------
# K6 with its fold and the step after it as the tail of its last tile block.

def fused_pivot_tail_workspace(R: int, device) -> torch.Tensor:
    """K6's workspace in the K6 loop for ``R`` columns on ``device``: (5,
    blocks) int32, zeroed -- rows 0-3 the tile blocks' partials as in
    ``kernels.pivot.fused_pivot_workspace``, ``[4, 0]`` the tail's arrival
    counter, which every call leaves zero. A loop allocates one and
    passes it to every call, in order on one stream."""
    return torch.zeros((5, _cdiv(R, COLS)), dtype=_I32, device=device)


def fused_pivot_tail_plain(Tt, costs, colk, ah, s: SeqScalars, r: int,
                           eps: float, max_iter: int, bland_static: bool,
                           threshold, then_pre: bool) -> None:
    """Plain version of ``fused_pivot_tail``."""
    new = fused_pivot_plain(Tt, costs, colk, ah, s.p, s.minc, s.k, r, eps,
                            s.do)
    set_candidates(s, (torch.where(s.do, a, b) for a, b in zip(
        new, (s.h_d, s.v_d, s.h_b, s.v_b))))
    step_post_plain(s, max_iter, eps, bland_static, threshold, then_pre)


def fused_pivot_tail(Tt, costs, colk, ah, s: SeqScalars, r: int, eps: float,
                     max_iter: int, ws=None, *, bland_static: bool,
                     threshold, then_pre: bool) -> None:
    """K6 in the K6 loop (``simplex_tpu/solver.py:253-294``): the fused
    pass on the pivot ``s`` holds (p, minc, k, do) over the snapshots
    ``colk`` and ``ah``; the candidates it folds where the pivot is done,
    else the carried ones, into ``s``; then ``step_post_plain``'s z,
    status, stall, bland and iterations and, with ``then_pre``, the next
    pivot's step before ``seq_ratio_snapshot``. Pure f32. ``ws`` is a
    ``fused_pivot_tail_workspace``. On the card one kernel, K6's tiles,
    whose first row band's last block (an arrival ticket) folds the
    partials in one warp and runs the step: it counts a launch of
    ``fused_pivot`` (``kernels.pivot.LAUNCHES``) and one of
    ``seq_k6_tail``."""
    M, R = Tt.shape
    _expect(Tt, "Tt", _F32, (M, R))
    for name, x, n in (("costs", costs, R), ("colk", colk, R),
                       ("ah", ah, M)):
        _expect(x, name, _F32, (n,))
    if not _on_card(Tt, costs, colk, ah, s.status):
        fused_pivot_tail_plain(Tt, costs, colk, ah, s, r, eps, max_iter,
                               bland_static, threshold, then_pre)
        return
    if _pair(s) != PAIRS[(_F32, _F32)]:
        raise ValueError(f"K6 takes a pure-f32 tableau, got {s.p.dtype} / "
                         f"{s.z.dtype}")
    _check_rows16(R, Tt=Tt, costs=costs, colk=colk)
    lib, check = _lib()
    if ws is None:
        ws = fused_pivot_tail_workspace(R, Tt.device)
    _expect(ws, "ws", _I32, (5, _cdiv(R, COLS)))
    if ws.device != Tt.device:
        raise ValueError(f"ws on {ws.device}, Tt on {Tt.device}")
    err = lib.fused_pivot_seq_launch(
        _ptr(Tt), _ptr(costs), _ptr(colk), _ptr(ah), M, R, r, float(eps),
        *(_ptr(x) for x in ws), ctypes.byref(_seq_ptrs(s)), max_iter,
        *_policy(bland_static, threshold), int(then_pre), _stream(Tt))
    check(lib, err, "fused_pivot")
    PIVOT_LAUNCHES["fused_pivot"] += 1
    LAUNCHES["seq_k6_tail"] += 1
