"""The fused pivot pass of the sequential loop (K6), and the batched
rank-1 update of the batched sequential loop (``batch_rank1``).

The PyTorch port of ``simplex_tpu/kernels/pivot.py``: one pass over the
tableau applies the rank-1 pivot update, updates the reduced costs and
folds the next entering candidates over the updated costs. As in
``kernels/blocked.py`` it has

* a hand-written CUDA kernel (``csrc/pivot.cu``, built for sm_90a at
  first use by ``_build``), launched for tensors on the card;
* a plain PyTorch version, taken for tensors on the CPU (the CPU tests)
  and used by ``chip_smoke.py`` as the kernel's reference on the card;
* a launch counter in ``LAUNCHES``, raised by one where the wrapper
  launches its kernel and nowhere else.

Layout: the port's transposed tableau ``Tt (M, R)`` f32, so the leaving
row ``colk = Tt[k]`` is contiguous and the entering column ``a_h =
Tt[:, h]`` is strided; the caller passes both as snapshots (copies), as
the JAX loop passes them, so that overwriting row k cannot race its
readers. The pass is single-dtype, like the TPU kernel: costs, p and
minc are f32 too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .blocked import (BIG_INDEX, _cdiv, _expect, _on_card, _ptr,  # noqa: F401
                      _stream)
from .blocked import entering_candidates as _candidates

#: Columns per block of the tiles (csrc/pivot.cu COLS).
COLS = 1024

#: ``batch_rank1``'s threads a block and 16-byte vectors a thread a tile
#: (csrc/pivot.cu R1_THREADS, R1_VECS; other widths ran as fast on the
#: card: tools/rank1_probe.py, PERF.md).
RANK1_THREADS = 256
RANK1_VECS = 4

#: Launches of each kernel since the last ``reset_launches``.
LAUNCHES = {"fused_pivot": 0, "batch_rank1": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def entering_candidates(costs: torch.Tensor, r: int, eps: float):
    """The candidates before the first pivot (``simplex_tpu.kernels.pivot.
    entering_candidates``): (h_d, v_d, h_b, v_b) over the active columns
    ``i < r``, the Dantzig (min value, lowest index) pair and the Bland
    pair (lowest index with cost <= -eps; ``BIG_INDEX`` and inf when
    none). The same tie rules as the kernel's fold."""
    return _candidates(costs, None, r, eps)


def fused_pivot_plain(Tt, costs, colk, a_h, p, minc, k, r: int, eps: float,
                      do=None):
    """Plain version of ``fused_pivot`` (same in-place contract and the
    same two roundings per element; with ``do`` false, one host read of
    it, Tt and the costs untouched, as the kernel leaves them)."""
    if do is None or bool(do):
        inv_p = 1.0 / p
        Tt.sub_((a_h * inv_p)[:, None] * colk[None, :])
        Tt.index_copy_(0, k.long().view(1), (colk * inv_p)[None])
        costs.sub_((minc / p) * colk)
    return entering_candidates(costs, r, eps)


def fused_pivot_workspace(R: int, device) -> torch.Tensor:
    """K6's partials for ``R`` columns on ``device``: (4, blocks) int32,
    one row each of the blocks' Dantzig values (f32 bits) and indices and
    Bland values and indices, which its fold reads; every call writes
    them all before its fold, so they need no clearing. A loop allocates
    one and passes it to every call, in order on one stream."""
    return torch.empty((4, _cdiv(R, COLS)), dtype=torch.int32, device=device)


def check_fused_pivot_workspace(ws: torch.Tensor, R: int, device) -> None:
    want = (4, _cdiv(R, COLS))
    if (ws.dtype != torch.int32 or tuple(ws.shape) != want
            or not ws.is_contiguous() or ws.device != device):
        raise ValueError(f"ws: want fused_pivot_workspace({R}) on {device}, "
                         f"got {ws.dtype} {tuple(ws.shape)} on {ws.device}")


def fused_pivot(Tt, costs, colk, a_h, p, minc, k, r: int, eps: float,
                do=None, ws=None, out=None):
    """K6, the port of ``simplex_tpu.kernels.pivot.fused_pivot``.

    With ``do`` true (the default): ``Tt[j] -= (a_h[j] / p) * colk`` for
    every row j but k, ``Tt[k] = colk / p``, and ``costs -= (minc / p) *
    colk``, in place, the factors formed as ``a_h * (1/p)`` and ``minc /
    p`` in f32. With ``do`` false nothing changes. Either way returns the
    entering candidates over the (updated) costs, as
    ``entering_candidates``: ``(h_d, v_d, h_b, v_b)`` 0-dim tensors, the
    indices int32. ``Tt (M, R)``, ``costs`` and ``colk (R,)``, ``a_h
    (M,)``, ``p`` and ``minc`` are f32, ``k`` int32 and ``do`` bool 0-dim
    tensors; R must be a multiple of 4 (16-byte rows). ``ws`` is a
    ``fused_pivot_workspace``; ``out``, four 0-dim tensors of the
    candidates' dtypes that they are written into and returned. With both,
    a call on the card allocates nothing, as a CUDA graph needs."""
    M, R = Tt.shape
    dev = Tt.device
    if do is None:
        do = torch.ones((), dtype=torch.bool, device=dev)
    _expect(Tt, "Tt", torch.float32, (M, R))
    _expect(costs, "costs", torch.float32, (R,))
    _expect(colk, "colk", torch.float32, (R,))
    _expect(a_h, "a_h", torch.float32, (M,))
    for name, x, dt in (("p", p, torch.float32), ("minc", minc, torch.float32),
                        ("k", k, torch.int32), ("do", do, torch.bool)):
        _expect(x, name, dt, ())
    if R % 4:
        raise ValueError(f"R={R}: the pass takes rows of whole 16-byte "
                         "vectors (R a multiple of 4)")
    if not _on_card(Tt, costs, colk, a_h, p, minc, k, do):
        return fused_pivot_plain(Tt, costs, colk, a_h, p, minc, k, r, eps, do)
    for name, x in (("Tt", Tt), ("costs", costs), ("colk", colk)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")

    from ._build import check, load_library

    lib = load_library()
    if ws is None:
        ws = fused_pivot_workspace(R, dev)
    check_fused_pivot_workspace(ws, R, dev)
    if out is None:
        out = tuple(torch.empty((), dtype=dt, device=dev)
                    for dt in (torch.int32, torch.float32) * 2)
    for x, name, dt in zip(out, ("h_d", "v_d", "h_b", "v_b"),
                           (torch.int32, torch.float32) * 2):
        _expect(x, f"out {name}", dt, ())
    err = lib.fused_pivot_launch(
        _ptr(Tt), _ptr(costs), _ptr(colk), _ptr(a_h), _ptr(p), _ptr(minc),
        _ptr(k), _ptr(do), M, R, r, float(eps), *(_ptr(x) for x in ws),
        *(_ptr(x) for x in out), _stream(Tt))
    check(lib, err, "fused_pivot")
    LAUNCHES["fused_pivot"] += 1
    return tuple(out)


class Rank1Plan(NamedTuple):
    """How ``batch_rank1`` runs: one block of ``RANK1_THREADS`` threads a
    tile of ``RANK1_THREADS * vecs`` 16-byte vectors of a lane, on a grid
    of ``tiles`` (a lane) x B."""
    vecs: int
    tiles: int


def rank1_lane_tiles(M: int, R: int, itemsize: int, vecs: int) -> int:
    """Tiles of one lane (csrc/pivot.cu ``rank1_lane_tiles``, which
    refuses a plan whose count differs): its M R elements as 16-byte
    vectors, ``RANK1_THREADS * vecs`` a tile, at least one tile (the first
    also takes the elements before the first aligned vector and after
    the last)."""
    return max(1, _cdiv(M * R * itemsize // 16, RANK1_THREADS * vecs))


def rank1_plan(B: int, M: int, R: int, itemsize: int) -> Rank1Plan:
    """The one place that decides how ``batch_rank1`` runs B lanes of M x R
    elements of ``itemsize`` bytes: tiles of ``RANK1_VECS`` vectors a
    thread, one block a tile. Raises for a shape past the grid's limits
    (65,535 lanes, 2^31 - 1 tiles a lane)."""
    if not 1 <= B <= 65535 or M < 1 or R < 1 or itemsize not in (4, 8):
        raise ValueError(f"no batch_rank1 plan for B={B} M={M} R={R} "
                         f"itemsize={itemsize}")
    tiles = rank1_lane_tiles(M, R, itemsize, RANK1_VECS)
    if tiles > 2**31 - 1:
        raise ValueError(f"batch_rank1: {tiles} tiles a lane at M={M} R={R}")
    return Rank1Plan(RANK1_VECS, tiles)


def rank1_cover(plan: Rank1Plan, M: int, R: int, itemsize: int,
                do: list, offset: int = 0) -> torch.Tensor:
    """The kernel's walk under ``plan``, on the host: how many times each
    element of each lane is updated, (B, M R) int64, for lanes whose flags
    are ``do`` and a tableau whose first element lies ``offset`` bytes past
    a 16-byte boundary. Tile c of a live lane is its aligned vectors [c,
    c + 1) x ``RANK1_THREADS * vecs``; tile 0 also takes the elements
    before the first aligned vector and after the last."""
    B, n, per = len(do), M * R, 16 // itemsize
    tv = RANK1_THREADS * plan.vecs
    counts = torch.zeros((B, n), dtype=torch.int64)
    for lane in (i for i in range(B) if do[i]):
        mis = (offset + lane * n * itemsize) % 16
        h = min(n, (16 - mis) // itemsize if mis else 0)
        nv = (n - h) // per
        for c in range(plan.tiles):
            v0, v1 = c * tv, min(nv, (c + 1) * tv)
            if v1 > v0:
                counts[lane, h + v0 * per:h + v1 * per] += 1
        counts[lane, :h] += 1
        counts[lane, h + nv * per:] += 1
    return counts


def batch_rank1_plain(T3: torch.Tensor, factor: torch.Tensor,
                      colk: torch.Tensor, do: torch.Tensor) -> None:
    """Plain version of ``batch_rank1``: the single-LP loop's own update,
    ``T3[i].addr_(factor[i], colk[i], alpha=-1)``, on each lane whose
    ``do`` is set (one host read of ``do``)."""
    for i in torch.nonzero(do).view(-1).tolist():
        T3[i].addr_(factor[i], colk[i], alpha=-1.0)


def batch_rank1(T3: torch.Tensor, factor: torch.Tensor, colk: torch.Tensor,
                do: torch.Tensor) -> None:
    """The batched rank-1 update, in place: for every lane i with
    ``do[i]``, ``T3[i, j, :] -= factor[i, j] * colk[i, :]``, the product
    and the difference rounded apart, as the single-LP loop's ``Tt.addr_``
    rounds on the card; a lane with ``do[i]`` false is not touched.
    ``T3 (B, M, R)``, ``factor (B, M)`` and ``colk (B, R)`` contiguous,
    all f64 or all f32; ``do (B,)`` bool. CPU tensors take
    ``batch_rank1_plain``; on the card ``rank1_plan`` decides the
    launch."""
    B, M, R = T3.shape
    if T3.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"T3: want float32 or float64, got {T3.dtype}")
    _expect(T3, "T3", T3.dtype, (B, M, R))
    _expect(factor, "factor", T3.dtype, (B, M))
    _expect(colk, "colk", T3.dtype, (B, R))
    _expect(do, "do", torch.bool, (B,))
    if not _on_card(T3, factor, colk, do):
        return batch_rank1_plain(T3, factor, colk, do)

    from ._build import check, load_library

    lib = load_library()
    launch = (lib.batch_rank1_f64_launch if T3.dtype == torch.float64
              else lib.batch_rank1_f32_launch)
    plan = rank1_plan(B, M, R, T3.element_size())
    err = launch(_ptr(T3), _ptr(factor), _ptr(colk), _ptr(do), B, M, R,
                 plan.vecs, plan.tiles, _stream(T3))
    check(lib, err, "batch_rank1")
    LAUNCHES["batch_rank1"] += 1
