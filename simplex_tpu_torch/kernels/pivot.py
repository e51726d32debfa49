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

import torch

from .blocked import (BIG_INDEX, _cdiv, _expect, _on_card, _ptr,  # noqa: F401
                      _stream)
from .blocked import entering_candidates as _candidates

#: Columns per block of the tiles (csrc/pivot.cu COLS).
COLS = 1024

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
    same two roundings per element)."""
    if do is None:
        do = torch.ones((), dtype=torch.bool, device=Tt.device)
    one = torch.ones((), dtype=Tt.dtype, device=Tt.device)
    p_safe = torch.where(do, p, one)
    inv_p = torch.where(do, 1.0 / p_safe, one)
    mop = torch.where(do, minc / p_safe, torch.zeros_like(one))
    factor = torch.where(do, a_h * inv_p, 0.0)
    Tt.sub_(factor[:, None] * colk[None, :])
    Tt.index_copy_(0, k.long().view(1), (colk * inv_p)[None])
    costs.sub_(mop * colk)
    return entering_candidates(costs, r, eps)


def fused_pivot(Tt, costs, colk, a_h, p, minc, k, r: int, eps: float,
                do=None):
    """K6, the port of ``simplex_tpu.kernels.pivot.fused_pivot``.

    With ``do`` true (the default): ``Tt[j] -= (a_h[j] / p) * colk`` for
    every row j but k, ``Tt[k] = colk / p``, and ``costs -= (minc / p) *
    colk``, in place, the factors formed as ``a_h * (1/p)`` and ``minc /
    p`` in f32. With ``do`` false nothing changes. Either way returns the
    entering candidates over the (updated) costs, as
    ``entering_candidates``: ``(h_d, v_d, h_b, v_b)`` 0-dim tensors, the
    indices int32. ``Tt (M, R)``, ``costs`` and ``colk (R,)``, ``a_h
    (M,)``, ``p`` and ``minc`` are f32, ``k`` int32 and ``do`` bool 0-dim
    tensors; R must be a multiple of 4 (16-byte rows)."""
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
    nx = _cdiv(R, COLS)
    part_val = torch.empty(nx, dtype=torch.float32, device=dev)
    part_idx = torch.empty(nx, dtype=torch.int32, device=dev)
    part_bval = torch.empty(nx, dtype=torch.float32, device=dev)
    part_bidx = torch.empty(nx, dtype=torch.int32, device=dev)
    h_d = torch.empty((), dtype=torch.int32, device=dev)
    v_d = torch.empty((), dtype=torch.float32, device=dev)
    h_b = torch.empty((), dtype=torch.int32, device=dev)
    v_b = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.fused_pivot_launch(
        _ptr(Tt), _ptr(costs), _ptr(colk), _ptr(a_h), _ptr(p), _ptr(minc),
        _ptr(k), _ptr(do), M, R, r, float(eps), _ptr(part_val),
        _ptr(part_idx), _ptr(part_bval), _ptr(part_bidx), _ptr(h_d),
        _ptr(v_d), _ptr(h_b), _ptr(v_b), _stream(Tt))
    check(lib, err, "fused_pivot")
    LAUNCHES["fused_pivot"] += 1
    return h_d, v_d, h_b, v_b


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
    ``batch_rank1_plain``."""
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
    err = launch(_ptr(T3), _ptr(factor), _ptr(colk), _ptr(do), B, M, R,
                 _stream(T3))
    check(lib, err, "batch_rank1")
    LAUNCHES["batch_rank1"] += 1
