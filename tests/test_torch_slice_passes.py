"""The sharded loops' slice passes as their kernels lay them out, on the CPU.

* ``eta_colk_slice``'s candidates as its blocks fold them: a column a
  thread, each warp by xor shuffles, the block's warps, then the blocks'
  partials in order, the new weights at the main and the Bland candidates
  riding with them through every fold (``csrc/eta.cu`` ``RowCands`` with
  CARRY), then the pack -- against ``kernels.eta.pack_slice`` on the same
  costs and weights, bit for bit, from edge states: a NaN weight, no
  eligible column, equal scores in the first and the last block, a weight
  past the re-anchor's 1e8, a slice of another rank (global indices), dead
  columns, Dantzig with a NaN cost; at three block widths and the three
  dtype pairs.
* ``seq_ratio_colk_sharded``'s cluster shape chosen by the slice's width
  (``kernels.seq.seq_sharded_threads``), pinned at the main path's slices
  and at the boundary, and against ``csrc/seq.cu``'s constants.
* The eta workspace's layout (the partials and the carried weights)
  against ``csrc/eta.cu``.

The kernels themselves run on the card only (tests/test_torch_cuda.py,
against their plain versions and their earlier forms).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from simplex_tpu_torch.kernels import eta as ke
from simplex_tpu_torch.kernels import seq as ks

CSRC = pathlib.Path(ke.__file__).resolve().parent / "csrc"
PAIRS = {"f64": np.float64, "f32/f64": np.float64, "f32": np.float32}
BIG = ke.BIG_INDEX
EPS = 1e-9


def _first_max(k, i, k2, i2) -> bool:
    """(k, i) before (k2, i2): NaN first, then the larger, ties to the
    lower index (csrc/eta.cu ``first_max``)."""
    nan, nan2 = k != k, k2 != k2
    if nan != nan2:
        return nan
    if not nan and k != k2:
        return k > k2
    return i < i2


def _take_first(x: dict, o: dict) -> dict:
    """csrc/eta.cu ``take_first`` with the weights carried: the main and
    the Bland candidates keep their weights ``wv`` and ``bw``."""
    x = dict(x)
    if _first_max(o["key"], o["idx"], x["key"], x["idx"]):
        x.update(key=o["key"], idx=o["idx"], val=o["val"], wv=o["wv"])
    if _first_max(o["key1"], o["idx1"], x["key1"], x["idx1"]):
        x.update(key1=o["key1"], idx1=o["idx1"], val1=o["val1"])
    if o["bidx"] < x["bidx"]:
        x.update(bidx=o["bidx"], bval=o["bval"], bw=o["bw"])
    if o["wmax"] > x["wmax"] or o["wmax"] != o["wmax"]:
        x["wmax"] = o["wmax"]
    return x


def _none(V) -> dict:
    inf = V(np.inf)
    return dict(key=-inf, idx=BIG, val=inf, key1=-inf, idx1=BIG, val1=inf,
                bval=inf, bidx=BIG, wmax=V(0), wv=V(0), bw=V(0))


def _warp_fold(lanes: list) -> list:
    """The xor butterfly of ``seq::warp_fold``: every lane gets the
    warp's result."""
    for off in (16, 8, 4, 2, 1):
        lanes = [_take_first(lanes[q], lanes[q ^ off]) for q in range(32)]
    return lanes


def _block_fold(xs: list, V) -> dict:
    """``seq::block_fold``: each warp, then warp 0 over the warps'
    results (lane q takes warp q's, the rest ``none``)."""
    warps = [_warp_fold(xs[w:w + 32])[0] for w in range(0, len(xs), 32)]
    lanes = warps + [_none(V)] * (32 - len(warps))
    return _warp_fold(lanes)[0]


def kernel_pack(costs, w, r: int, eps: float, offset: int, cols: int):
    """``eta_colk_slice``'s send buffers as its blocks form them on the
    costs and (new) weights ``w`` (None: Dantzig): ``cols`` columns a
    block of ``max(128, cols)`` threads, each thread's candidates from its
    column, the block's fold, then the blocks' partials folded in block
    order (the last block's loop, then its block fold); returns (send_v,
    send_i, send_w) as numpy arrays."""
    V = costs.dtype.type
    R = costs.shape[0]
    nt = max(128, cols)
    devex = w is not None
    parts = []
    for i0 in range(0, R, cols):
        xs = []
        for tid in range(nt):
            i = i0 + tid
            x = _none(V)
            if tid < cols and i < R:
                c = costs[i]
                cm = c if i < r else V(np.inf)
                elig = bool(cm <= -V(eps))
                if devex:
                    wi = w[i]
                    c2 = V(cm * cm)
                    x.update(wmax=wi, wv=wi,
                             key=V(c2 / wi) if elig else -V(np.inf),
                             key1=c2 if elig else -V(np.inf))
                else:
                    wi = V(0)
                    x["key"] = V(-cm)
                x.update(idx=i, idx1=i, val=cm, val1=cm)
                if elig:
                    x.update(bidx=i, bval=cm, bw=wi)
            xs.append(x)
        parts.append(_block_fold(xs, V))
    lanes = [_none(V)] * nt
    for q, part in enumerate(parts):
        lanes[q % nt] = _take_first(lanes[q % nt], part)
    x = _block_fold(lanes, V)
    has = x["bidx"] != BIG
    send_v = [x["val"], x["bval"] if has else np.inf]
    send_i = [offset + x["idx"], offset + x["bidx"] if has else BIG]
    send_w = None
    if devex:
        send_v += [x["wv"], x["bw"] if has else 1.0, x["key"], x["val1"],
                   x["key1"]]
        send_i.append(offset + x["idx1"])
        send_w = np.float64(x["wmax"])
    return (np.array(send_v, dtype=np.float64),
            np.array(send_i, dtype=np.int32), send_w)


EDGES = ("taken", "nan-weight", "no-eligible", "tie-across-blocks",
         "re-anchor", "other-rank", "dead-columns", "dantzig",
         "dantzig-nan-cost")


def _state(edge: str, V, R: int, seed: int):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(-1.0, 1.0, R).astype(V)
    w = rng.uniform(1.0, 2.0, R).astype(V)
    r, offset = R, 0
    if edge == "nan-weight":
        costs[R // 3] = V(-0.5)
        w[R // 3] = V(np.nan)
    elif edge == "no-eligible":
        costs = np.abs(costs)
    elif edge == "tie-across-blocks":
        costs[3], w[3] = V(-40.0), V(400.0)      # score 4, the lower index
        costs[R - 4], w[R - 4] = V(-20.0), V(100.0)
    elif edge == "re-anchor":
        w[R // 2] = V(3e8)
    elif edge == "other-rank":
        offset = 2 * R
    elif edge == "dead-columns":
        r = R - 37
        costs[R - 5] = V(-30.0)                  # dead: never a candidate
    elif edge == "dantzig-nan-cost":
        costs[R // 4] = V(np.nan)
    if edge.startswith("dantzig"):
        w = None
    return costs, w, r, offset


def _same(a, b) -> bool:
    """Bit for bit, but a NaN equals a NaN of any payload (torch's max
    and numpy's make NaNs of different bits on the CPU)."""
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = np.isnan(a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
    if a.dtype.kind == "f" and not np.array_equal(nan, np.isnan(b)):
        return False
    return a[~nan].tobytes() == b[~nan].tobytes()


@pytest.mark.parametrize("cols", [32, 64, 256])
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("edge", EDGES)
def test_carried_fold_matches_pack_slice(edge, pair, cols):
    """The blocks' fold with the weights carried, then the pack, equal
    ``pack_slice``'s send buffers bit for bit (the weights at the
    candidates are the new weights at their columns, NaN kept)."""
    V = PAIRS[pair]
    R = 300
    costs, w, r, offset = _state(edge, V, R, 7 + len(edge) + cols)
    got_v, got_i, got_w = kernel_pack(costs, w, r, EPS, offset, cols)
    devex = w is not None
    kv, ki = ke.SLICE_PACK[devex]
    send_v = torch.zeros(kv, dtype=torch.float64)
    send_i = torch.zeros(ki, dtype=torch.int32)
    send_w = torch.zeros((), dtype=torch.float64) if devex else None
    ke.pack_slice(torch.from_numpy(costs),
                  None if w is None else torch.from_numpy(w), r, EPS, offset,
                  send_v, send_i, send_w)
    assert _same(got_v, send_v.numpy()), (got_v, send_v)
    assert _same(got_i, send_i.numpy()), (got_i, send_i)
    if devex:
        assert _same(got_w, send_w.numpy()), (got_w, send_w)
    if edge == "tie-across-blocks":
        assert got_i[0] == offset + 3 and got_v[2] == 400.0
    if edge == "nan-weight":
        assert got_i[0] == R // 3 and np.isnan(got_v[2])
    if edge == "no-eligible":
        assert got_i[1] == BIG and got_v[1] == np.inf
        assert not devex or got_v[3] == 1.0


@pytest.mark.parametrize("R,want", [
    (1, 256), (3072, 256), (6144, 256), (12288, 256), (16384, 256),
    (16385, 512), (24576, 512), (32768, 512), (120064, 512)])
def test_sharded_threads_by_width(R, want):
    """16 x 256 x 4 covers a slice of up to 16,384 columns in one pass of
    loads (the 1,024^2, 2,048^2 and 4,096^2 slices); wider ones (the
    8,192^2 tableau's 24,576 columns) take 512 threads a block."""
    assert ks.seq_sharded_threads(R) == want


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_sharded_threads_match_csrc():
    """The shape the host chooses from is csrc/seq.cu's, and the kernel's
    entry point takes the two widths the host gives."""
    src = (CSRC / "seq.cu").read_text()
    assert _constant(src, "CLUSTER_BLOCKS") == ks.CLUSTER_BLOCKS
    assert _constant(src, "CLUSTER_THREADS") == ks.CLUSTER_THREADS
    assert _constant(src, "PER") == ks.CLUSTER_PER
    assert _constant(src, "SHARDED_THREADS_WIDE") == ks.SHARDED_THREADS_WIDE
    assert {ks.seq_sharded_threads(R) for R in (1, 10 ** 6)} == {
        ks.CLUSTER_THREADS, ks.SHARDED_THREADS_WIDE}


def test_workspace_layout_matches_csrc():
    """csrc/eta.cu's workspace: 80 bytes a column block, the carried
    weights' two arrays after the partial's 64 (60 and padding), inside
    it; ``eta_workspace_bytes`` counts the same."""
    src = (CSRC / "eta.cu").read_text()
    assert "return 16 + 32 * (size_t)nbA + 80 * (size_t)nbB;" in src
    assert "wv(key + 8 * (size_t)nbB), bw(wv + nbB)" in src
    for M, R in ((64, 128), (2048, 6144), (8192, 24576)):
        rows, cols = ke.eta_grid(M, R)
        nbA, nbB = -(-M // rows), -(-R // cols)
        key = 16 + 32 * nbA
        partial_end = key + 6 * 8 * nbB + 3 * 4 * nbB
        wv, bw_end = key + 64 * nbB, key + 80 * nbB
        assert partial_end <= wv and bw_end == ke.eta_workspace_bytes(M, R)
