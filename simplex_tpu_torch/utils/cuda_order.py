"""Exact simulation of the reference GPU's argmin reduction order.

The port's own copy of ``simplex_tpu.utils.cuda_order`` (NumPy only; the
port never imports the JAX package).

The reference's ``minElement`` (reference src/reduction.cu:10-140) is a
two-pass grid reduction whose comparisons go through the epsilon
three-way ``compare`` (macro.h:28-42, eps=1e-9): a candidate replaces the
current minimum only when it is smaller *by more than eps*. Values within
eps of each other therefore tie, and the winner is decided purely by the
traversal order of the reduction:

1. thread-local grid-stride scan (ascending indices, first-seen wins),
2. warp tournament via ``__shfl_down_sync`` offsets 16,8,4,2,1 (the
   current lane keeps its pair on a tie),
3. block combine: warp leaders' results re-reduced by warp 0,
4. one per-block result, then a second single-block pass over them.

The launch shape depends only on N (THREADS=512, blocks =
min(ceil(N/512), 1024), reduction.cu:6-7), so the order — and hence every
tie — is deterministic and GPU-independent (the reference's measured
pivot counts are identical on both its GPUs, BASELINE.md). This module
reproduces that order bit-for-bit so the oracle can replay the
reference's exact pivot sequence on regenerated instances
(``solve_oracle(..., tie_rule='cuda')``).
"""

from __future__ import annotations

import numpy as np

THREADS = 512
WARP = 32
MAX_BLOCKS = 1024
DBL_MAX = np.finfo(np.float64).max


def _blocks(n: int) -> int:
    return min((n + THREADS - 1) // THREADS, MAX_BLOCKS)


def _eps_less(a_val, b_val, eps: float):
    """compare(a, b) < 0: a smaller than b by more than eps."""
    return (np.abs(a_val - b_val) >= eps) & (a_val < b_val)


def _warp_reduce(vals: np.ndarray, idxs: np.ndarray, eps: float):
    """Vectorised warpReduceMin (reduction.cu:10-22) over the last axis
    (length WARP). ``__shfl_down_sync`` with out-of-range source lanes
    returns the caller's own value (no-op for the tail lanes)."""
    offset = WARP >> 1
    while offset > 0:
        shifted_v = np.concatenate(
            [vals[..., offset:], vals[..., -offset:]], axis=-1)
        shifted_i = np.concatenate(
            [idxs[..., offset:], idxs[..., -offset:]], axis=-1)
        take = _eps_less(shifted_v, vals, eps)
        vals = np.where(take, shifted_v, vals)
        idxs = np.where(take, shifted_i, idxs)
        offset >>= 1
    return vals, idxs


def _block_pass(vals: np.ndarray, idxs: np.ndarray, n_blocks: int,
                eps: float):
    """One deviceReduceKernel launch (reduction.cu:51-80) given each
    thread's scan result: vals/idxs shaped (n_blocks * THREADS,).
    Returns per-block (val, idx) arrays."""
    vals = vals.reshape(n_blocks, THREADS // WARP, WARP)
    idxs = idxs.reshape(n_blocks, THREADS // WARP, WARP)
    vals, idxs = _warp_reduce(vals, idxs, eps)
    # Warp leaders (lane 0) -> shared; warp 0 re-reduces them from lanes
    # 0..n_warps-1, upper lanes DBL_MAX (reduction.cu:24-49).
    n_warps = THREADS // WARP
    lead_v = np.full((n_blocks, WARP), DBL_MAX)
    lead_i = np.full((n_blocks, WARP), -1, dtype=np.int64)
    lead_v[:, :n_warps] = vals[:, :, 0]
    lead_i[:, :n_warps] = idxs[:, :, 0]
    lead_v, lead_i = _warp_reduce(lead_v[:, None, :], lead_i[:, None, :],
                                  eps)
    return lead_v[:, 0, 0], lead_i[:, 0, 0]


def _scan_phase(values: np.ndarray, n_blocks: int, eps: float):
    """Thread-local grid-stride scan (reduction.cu:55-66): thread t covers
    t, t+S, t+2S, ... ascending; first-seen wins eps-ties."""
    n = values.shape[0]
    stride = n_blocks * THREADS
    cols = (n + stride - 1) // stride
    padded = np.full(stride * cols, DBL_MAX)
    padded[:n] = values
    mat = padded.reshape(cols, stride)       # row j = indices j*S .. j*S+S-1
    best_v = mat[0].copy()
    best_i = np.arange(stride, dtype=np.int64)
    best_i[best_v == DBL_MAX] = -1
    for j in range(1, cols):
        cand_v = mat[j]
        cand_i = j * stride + np.arange(stride, dtype=np.int64)
        take = _eps_less(cand_v, best_v, eps)
        best_v = np.where(take, cand_v, best_v)
        best_i = np.where(take, cand_i, best_i)
    return best_v, best_i


def _scan_pairs(vals: np.ndarray, idxs: np.ndarray, eps: float):
    """Thread-local grid-stride scan of a single 512-thread block over
    (value, original-index) pairs — the second deviceReduceKernel launch
    (isFirstExecution=false, reduction.cu:55-66 with g_index carried):
    thread t covers t, t+512, ... ascending; strict eps-less replaces."""
    n = vals.shape[0]
    cols = (n + THREADS - 1) // THREADS
    pv = np.full(THREADS * cols, DBL_MAX)
    pi = np.full(THREADS * cols, -1, dtype=np.int64)
    pv[:n] = vals
    pi[:n] = idxs
    pv = pv.reshape(cols, THREADS)
    pi = pi.reshape(cols, THREADS)
    best_v, best_i = pv[0].copy(), pi[0].copy()
    for j in range(1, cols):
        take = _eps_less(pv[j], best_v, eps)
        best_v = np.where(take, pv[j], best_v)
        best_i = np.where(take, pi[j], best_i)
    return best_v, best_i


def cuda_argmin(values: np.ndarray, eps: float = 1e-9) -> tuple[int, float]:
    """minElement (reduction.cu:82-104): two passes of
    deviceReduceKernel, returning (index, value) with the reference GPU's
    exact eps-tie traversal order."""
    values = np.asarray(values, dtype=np.float64)
    n = values.shape[0]
    nb = _blocks(n)
    sv, si = _scan_phase(values, nb, eps)
    bv, bi = _block_pass(sv, si, nb, eps)

    # Second pass: <<<1, THREADS>>> over the nb block results (nb can be
    # up to 1024 -> each thread may scan two), original indices carried.
    sv2, si2 = _scan_pairs(bv, bi, eps)
    fv, fi = _block_pass(sv2, si2, 1, eps)
    return int(fi[0]), float(fv[0])


def cuda_ratio_argmin(b: np.ndarray, a_h: np.ndarray,
                      eps: float = 1e-9) -> tuple[int, float]:
    """minElement ratio-test variant (reduction.cu:106-140):
    indicators[i] = b[i]/a_h[i] where compare(a_h[i]) > 0 else DBL_MAX,
    then the same two-pass argmin."""
    pos = (np.abs(a_h) >= eps) & (a_h > 0)
    ind = np.where(pos, b / np.where(pos, a_h, 1.0), DBL_MAX)
    return cuda_argmin(ind, eps)
