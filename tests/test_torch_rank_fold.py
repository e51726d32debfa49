"""The ranks' candidate fold as ``sharded::fold_warp`` lays it out, on the CPU.

``seq_fold_column`` and K5's sharded head fold the candidates every rank
packed (V (P, kv) f64, I (P, 2) int32) in every warp of every block
(``csrc/sharded_step.cuh`` ``fold_warp``): the ranks in rounds of up to
``FOLD_LANES`` lanes, each round's W lanes (the least power of two that
holds it; every group of W lanes holds the same ranks) a rank each, xor
butterflies of the largest key and the lowest Bland index, a ballot for
the first lane holding each, the winners' values from those lanes, the
weights cast to f32 before they move; a round's winner replaces the
carried one only where it is strictly better; a NaN key anywhere makes
rank 0 the main candidate. Modelled here lane by lane in numpy and held
bit for bit against ``fold_owners``, ``sharded_fold_plain`` and
``seq_fold_column_plain`` (which the other tests hold against the JAX
package), from edge states: equal keys across ranks (signed zeros among
them), a NaN key in the first, a middle and the last rank, no Bland
candidate (``BIG_INDEX``), ``+-inf`` values, the devex weights riding (kv
5) and not (kv 2), at P = 1, 2, 3, 8, 31, 32, 33 and 40.

The kernels themselves run on the card only (tests/test_torch_cuda.py,
against their plain versions and their earlier forms).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import seq as ks

CSRC = pathlib.Path(kb.__file__).resolve().parent / "csrc"
BIG = kb.BIG_INDEX
FOLD_LANES = 32
RANKS = (1, 2, 3, 8, 31, 32, 33, 40)
EDGES = ("random", "own", "other", "tie", "tie-late", "signed-zero",
         "nan-first", "nan-mid", "nan-last", "bland-own", "bland-other",
         "bland-none", "inf-none", "inf-mid")
PAIRS = {"f64": (torch.float64, torch.float64),
         "f32/f64": (torch.float32, torch.float64),
         "f32": (torch.float32, torch.float32)}
R_LOC = 5                                        # each rank's columns


def gathered(P: int, kv: int, edge: str, R: int = R_LOC):
    """V (P, kv) and I (P, 2) of P ranks in state ``edge``: rank q's
    columns are [q R, (q + 1) R); its main candidate there with
    value 0.5 q - 0.75 (rank 0 best: own), or rank P - 1 best (other), every rank
    equal (tie), every rank but 0 equal and best (tie-late), +0.0 and -0.0
    alternating (signed-zero), a NaN at rank 0, P // 2 or P - 1 with rank
    P - 1 best otherwise, Bland candidates at rank 0 and the odd ranks,
    at every rank but 0 or at none, every value +inf, or rank P // 2's
    -inf; seeded values (random). Under devex (kv 5) the key is -v_d and
    the weights differ from rank to rank (none exact in f32)."""
    rng = np.random.default_rng(P * 1000 + kv * 100 + EDGES.index(edge))
    q = np.arange(P)
    vd = 0.5 * q - 0.75
    hd = q * R + (q % R)
    hb = np.full(P, BIG, dtype=np.int64)
    vb = np.full(P, np.inf)
    if edge == "random":
        vd = rng.uniform(-2.0, 1.0, P)
        has = rng.uniform(size=P) < 0.5
        hb = np.where(has, q * R + rng.integers(0, R, P), BIG)
        vb = np.where(has, rng.uniform(-1.0, 0.0, P), np.inf)
    elif edge == "other":
        vd[P - 1] = -2.0
    elif edge == "tie":
        vd[:] = -0.75
    elif edge == "tie-late":
        vd[1:] = -2.0
    elif edge == "signed-zero":
        vd = np.where(q % 2 == 0, 0.0, -0.0)
    elif edge.startswith("nan"):
        if P > 1:
            vd[P - 1] = -2.0
        vd[{"nan-first": 0, "nan-mid": P // 2, "nan-last": P - 1}[edge]] = \
            np.nan
    elif edge == "bland-own":
        odd = q % 2 == 1
        hb = np.where(odd | (q == 0), q * R + 1, BIG)
        vb = np.where(odd | (q == 0), -0.25 * q - 0.5, np.inf)
    elif edge == "bland-other":
        hb = np.where(q > 0, q * R + 2, BIG)
        vb = np.where(q > 0, -0.25 * q, np.inf)
    elif edge == "inf-none":
        vd[:] = np.inf
    elif edge == "inf-mid":
        vd[P // 2] = -np.inf
    V = np.zeros((P, kv))
    V[:, 0], V[:, 1] = vd, vb
    if kv == 5:
        V[:, 2] = 1.0 / 3.0 + 0.37 * q
        V[:, 3] = 2.0 + 0.11 * q
        V[:, 4] = rng.uniform(0.0, 3.0, P) if edge == "random" else -vd
    I = np.stack([hd, hb], axis=1).astype(np.int32)
    return V, I


def fold_warp(V: np.ndarray, I: np.ndarray) -> dict:
    """``sharded::fold_warp`` lane by lane: the folded candidates (the
    weights as f32) and the ranks that won them."""
    P, kv = V.shape
    devex = kv == 5
    W = 1
    while W < P and W < FOLD_LANES:
        W *= 2
    f, mx, nan = {}, 0.0, False
    for r0 in range(0, P, W):
        lane = []
        for t in range(FOLD_LANES):
            r = r0 + (t & (W - 1))
            inn = r < P
            vd = V[r, 0] if inn else 0.0
            lane.append(dict(
                r=r, inn=inn, vd=vd, vb=V[r, 1] if inn else 0.0,
                wd=np.float32(V[r, 2]) if inn and devex else np.float32(1),
                wb=np.float32(V[r, 3]) if inn and devex else np.float32(1),
                key=(-np.inf if not inn else V[r, 4] if devex else -vd),
                hd=int(I[r, 0]) if inn else 0,
                hb=int(I[r, 1]) if inn else BIG))
        if any(x["key"] != x["key"] for x in lane):
            nan = True
        k = [x["key"] for x in lane]
        b = [x["hb"] for x in lane]
        off = W // 2
        while off:
            k = [k[t ^ off] if k[t ^ off] > k[t] else k[t]
                 for t in range(FOLD_LANES)]
            b = [min(b[t ^ off], b[t]) for t in range(FOLD_LANES)]
            off //= 2
        # Every lane ends with the same b; the ballot's predicate uses
        # each lane's own k (equal unless a NaN hides the maximum).
        kd = [t for t, x in enumerate(lane) if x["inn"] and x["key"] == k[t]]
        kb_ = [t for t, x in enumerate(lane) if x["inn"] and x["hb"] == b[t]]
        od = kd[0] if kd else 0
        ob = kb_[0]
        win, bwin = lane[od], lane[ob]
        if r0 == 0 or k[0] > mx:
            mx = k[0]
            f.update(h_d=win["hd"], v_d=win["vd"], w_d=win["wd"],
                     rank_d=win["r"])
        if r0 == 0 or b[0] < f["h_b"]:
            f.update(h_b=b[0], v_b=bwin["vb"], w_b=bwin["wb"],
                     rank_b=bwin["r"])
    if nan:
        f.update(h_d=int(I[0, 0]), v_d=V[0, 0],
                 w_d=np.float32(V[0, 2]) if devex else np.float32(1),
                 rank_d=0)
    return f


def bits(x) -> bytes:
    return np.asarray(x).tobytes()


def same(a, b) -> bool:
    """Bit for bit: a scalar tensor or number against a numpy value of the
    same dtype."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return bits(a) == bits(np.asarray(b, dtype=np.asarray(a).dtype))


def test_round_width_pinned():
    """The model's round is csrc/sharded_step.cuh's, and its mask covers
    the round's lanes."""
    src = (CSRC / "sharded_step.cuh").read_text()
    m = re.search(r"constexpr int FOLD_LANES = (\d+);", src)
    assert m and int(m.group(1)) == FOLD_LANES
    assert "constexpr unsigned FOLD_MASK = 0xffffffffu;" in src
    assert "while (W < P && W < FOLD_LANES) W <<= 1;" in src


@pytest.mark.parametrize("kv", [2, 5])
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("P", RANKS)
def test_warp_fold_matches_sharded_fold_plain(P, edge, kv):
    """The model's winners are ``fold_owners``' and its values
    ``sharded_fold_plain``'s, bit for bit (the weights in f32)."""
    V, I = gathered(P, kv, edge)
    f = fold_warp(V, I)
    Vt, It = torch.from_numpy(V), torch.from_numpy(I)
    od, ob = kb.fold_owners(Vt, It)
    assert (f["rank_d"], f["rank_b"]) == (int(od), int(ob))
    s = kb.sharded_scalars(torch.zeros((), dtype=torch.float64), False)
    kb.sharded_fold_plain(s, Vt, It)
    for name in ("h_d", "v_d", "w_d", "h_b", "v_b", "w_b"):
        assert same(getattr(s, name), f[name]), name


@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("P", RANKS)
def test_warp_fold_matches_seq_fold_column_plain(P, edge, pair, bland):
    """``seq_fold_column``'s every-warp fold, h, owner test and column, as
    the kernel forms them from the model's fold, equal
    ``seq_fold_column_plain``'s scalars and column bit for bit, on the
    slice of rank P // 2 (its own candidate wins or another's: zeros)."""
    T, Vd = PAIRS[pair]
    V, I = gathered(P, 2, edge)
    f = fold_warp(V, I)
    M, eps, max_iter = 7, 1e-9 if Vd == torch.float64 else 1e-4, 10
    offset = (P // 2) * R_LOC
    rng = np.random.default_rng(P + EDGES.index(edge))
    Tt = torch.from_numpy(rng.uniform(-1, 1, (M, R_LOC))).to(T)
    s = ks.seq_scalars(torch.tensor(1.5, dtype=Vd), bland, T)
    s.iterations.fill_(3)
    ah = torch.full((M,), float("nan"), dtype=T)
    ks.seq_fold_column_plain(Tt, torch.from_numpy(V), torch.from_numpy(I),
                             ah, s, max_iter, eps, offset)
    vnp = np.float64 if Vd == torch.float64 else np.float32
    v_d, v_b = vnp(f["v_d"]), vnp(f["v_b"])
    use_b = bland and f["h_b"] < BIG
    h = f["h_b"] if use_b else f["h_d"]
    minc = v_b if use_b else v_d
    want = dict(h_d=np.int32(f["h_d"]), v_d=v_d, h_b=np.int32(f["h_b"]),
                v_b=v_b, active=True, h=np.int32(h), minc=minc,
                optimal=bool(minc > -vnp(eps)))
    for name, x in want.items():
        assert same(getattr(s, name), x), name
    loc = h - offset
    col = (Tt[:, loc] if 0 <= loc < R_LOC
           else torch.zeros(M, dtype=T))
    assert bits(ah.numpy()) == bits(col.numpy())
