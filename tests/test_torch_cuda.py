"""The CUDA kernels on the card, at small shapes: each against its plain
PyTorch version on the same tensors, and a solve on the card against
the same solve on the CPU. Marked ``gpu``; skipped where torch.cuda is
not available. The card's own check at full shapes is chip_smoke.py.

This file imports neither JAX nor tests/conftest.py, so on a machine
with a card and no JAX it runs as::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import simplex_tpu_torch as pst
from simplex_tpu_torch.kernels import batched as kbt
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import pivot as kp
from simplex_tpu_torch.tableau import batch_tt_matvec, tt_matvec

pytestmark = pytest.mark.gpu

DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "examples"
PROD = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, lo=-1.0, hi=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(dtype))


def test_kernels_match_plain_on_card(cuda):
    """f32 outputs to 1e-5 * (1 + |x|) (another summation order);
    integer outputs equal; the f64 vectors (costs, mv) to 1e-12 relative
    of the f64 formula on the kernel's own f32 operands, which an f32
    accumulation would miss."""

    M, R, L, t, eps = 256, 384, 16, 7, 1e-4
    Tt = _rand((M, R), 1).to(cuda)
    C = _rand((L, R), 2).to(cuda)
    F = _rand((L, M), 3, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 4, 0, 100, np.float64).to(cuda)
    h = torch.tensor(33, dtype=torch.int32, device=cuda)
    got = kb.ah_ratio(Tt, F, C, b, h, t, eps)
    want = kb.ah_ratio_plain(Tt, F, C, b, h, t, eps)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert int(got[1]) == int(want[1]) and int(got[4]) == int(want[4]) == 0

    ah, k, p, bk = got[:4]
    u = -0.5 / p.double()
    do = torch.tensor(True, device=cuda)
    costs = _rand((R,), 5, dtype=np.float64).to(cuda)
    base = torch.arange(M, dtype=torch.int32, device=cuda)
    w = _rand((R,), 6, 1, 2).to(cuda)
    outs = []
    for fn in (kb.colk_costs, kb.colk_costs_plain):
        st = [C.clone(), F.clone(), costs.clone(), b.clone(), base.clone(),
              w.clone()]
        cand = fn(Tt, st[0], st[1], st[2], k, t, u, do, R - 5, eps, ah,
                  st[3], st[4], h, p, bk, st[5])
        outs.append((st, cand))
    (sk, ck), (sp, cp) = outs
    torch.testing.assert_close(sk[0], sp[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sk[1], sp[1], rtol=1e-6, atol=1e-7)
    costs_x = costs - u * sk[0][t].double()
    assert ((sk[2] - costs_x).abs() <= 1e-12 * (1 + costs_x.abs())).all()
    assert torch.equal(sk[4], sp[4])
    assert int(ck[0]) == int(cp[0]) and int(ck[2]) == int(cp[2])

    coeffs = _rand((M,), 7, dtype=np.float64).to(cuda)
    Tk, Tp = Tt.clone(), Tt.clone()
    mv_k = kb.apply_reprice(Tk, C, F, coeffs)
    kb.apply_reprice_plain(Tp, C, F, coeffs)
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)
    mv_x = tt_matvec(Tk, coeffs)
    scale = tt_matvec(Tk.abs(), coeffs.abs())
    assert ((mv_k - mv_x).abs() <= 1e-12 * scale).all()
    kb.apply_window(Tk, C, F)
    kb.apply_window_plain(Tp, C, F)
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,R,L", [(256, 384, 16), (128, 128, 8),
                                   (1024, 2944, 136)])
def test_apply_window_equals_k3_apply_on_card(cuda, M, R, L):
    """K4 leaves Tt bit for bit as K3 does (one kernel template: each
    element the same FFMA chain over s in order, then one subtraction),
    at an odd R-tile count, the shortest window, and a shape where each
    persistent block walks several tiles across M tiles; and within
    1e-5 * (1 + |x|) of cuBLAS addmm_ (another summation order). K3's mv
    equals K11 run on K3's output bit for bit (the same row groups summed
    in the same orders) and the f64 formula within 1e-12 of its terms'
    magnitude."""
    Tt = _rand((M, R), 41).to(cuda)
    C = _rand((L, R), 42).to(cuda)
    F = _rand((L, M), 43, -0.1, 0.1).to(cuda)
    coeffs = _rand((M,), 44, dtype=np.float64).to(cuda)
    T3, T4, Tp = Tt.clone(), Tt.clone(), Tt.clone()
    mv = kb.apply_reprice(T3, C, F, coeffs)
    kb.apply_window(T4, C, F)
    kb.apply_window_plain(Tp, C, F)
    assert torch.equal(T4, T3)
    torch.testing.assert_close(T4, Tp, rtol=1e-5, atol=1e-5)
    assert torch.equal(mv, kb.reprice(T3, coeffs))
    scale = tt_matvec(T3.abs(), coeffs.abs())
    assert ((mv - tt_matvec(T3, coeffs)).abs() <= 1e-12 * scale).all()


@pytest.mark.parametrize("t", [0, 1, 15])
def test_ah_ratio_on_card(cuda, t):
    """K1 twice back to back on one workspace: both calls equal bit for
    bit and the arrival counter back at 0; k and the flag equal to the
    plain version's; p == a_h[k] and bk == b[k] exactly; a_h equal to
    K5's column bit for bit. M = 384 spreads the constraints over six
    blocks."""
    M, R, L, eps = 384, 256, 16, 1e-4
    Tt = _rand((M, R), 61).to(cuda)
    C = _rand((L, R), 62).to(cuda)
    F = _rand((L, M), 63, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 64, 0, 100, np.float64).to(cuda)
    h = torch.tensor(77, dtype=torch.int32, device=cuda)
    ws = kb.ah_ratio_workspace(M, cuda)
    got = kb.ah_ratio(Tt, F, C, b, h, t, eps, ws=ws)
    again = kb.ah_ratio(Tt, F, C, b, h, t, eps, ws=ws)
    assert int(ws[:4].view(torch.int32)) == 0
    for a, b2 in zip(got, again):
        assert torch.equal(a, b2)
    want = kb.ah_ratio_plain(Tt, F, C, b, h, t, eps)
    ah, k, p, bk, unb = got
    assert int(k) == int(want[1]) and int(unb) == int(want[4]) == 0
    assert torch.equal(p, ah[k.long()]) and torch.equal(bk, b[k.long()])
    assert torch.equal(ah, kb.ah(Tt, F, C, h, t))
    torch.testing.assert_close(ah, want[0], rtol=1e-5, atol=1e-5)


def test_ah_ratio_unbounded_on_card(cuda):
    """No eligible row: k = BIG_INDEX, p = 0, bk = 0, unbounded = 1."""
    M, R, L, eps = 384, 256, 16, 1e-4
    Tt = _rand((M, R), 65).to(cuda)
    Tt[:, 9] = -Tt[:, 9].abs()
    C = torch.zeros((L, R), device=cuda)
    F = torch.zeros((L, M), device=cuda)
    b = _rand((M,), 66, 0, 100, np.float64).to(cuda)
    h = torch.tensor(9, dtype=torch.int32, device=cuda)
    ws = kb.ah_ratio_workspace(M, cuda)
    ah, k, p, bk, unb = kb.ah_ratio(Tt, F, C, b, h, 0, eps, ws=ws)
    assert int(k) == kb.BIG_INDEX and int(unb) == 1
    assert float(p) == 0.0 and float(bk) == 0.0
    assert int(ws[:4].view(torch.int32)) == 0


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
@pytest.mark.parametrize("do", [True, False], ids=["pivot", "skipped"])
@pytest.mark.parametrize("t", [0, 1, 15])
def test_colk_costs_on_card(cuda, t, do, devex):
    """K2 twice back to back on one workspace, each call on a fresh copy
    of the same state: both equal bit for bit (the last block reset the
    arrival counter, which is 0 after each call) and match the plain
    version -- C[t] to 1e-5 * (1 + |x|), costs to 1e-12 of the f64
    formula on the kernel's own pivot row, F[t] to 1e-6 relative, base
    and the candidates' indices equal; C[t][h] equal to K1's p bit for
    bit when the pivot is taken; with do false C[t] and F[t] zero and the
    vectors unchanged."""
    M, R, L, eps = 256, 384, 16, 1e-4
    Tt = _rand((M, R), 51).to(cuda)
    C = _rand((L, R), 52).to(cuda)
    F = _rand((L, M), 53, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 54, 0, 100, np.float64).to(cuda)
    h = torch.tensor(129, dtype=torch.int32, device=cuda)
    ah, k, p, bk, unb = kb.ah_ratio(Tt, F, C, b, h, t, eps)
    assert int(unb) == 0
    u = -0.5 / p.double()
    flag = torch.tensor(do, device=cuda)
    costs = _rand((R,), 55, dtype=np.float64).to(cuda)
    base = torch.randperm(R, generator=torch.Generator().manual_seed(56))[
        :M].to(torch.int32).to(cuda)
    w = _rand((R,), 57, 1, 2).to(cuda) if devex else None
    ws = kb.colk_workspace(R, cuda)

    def run(fn, **kw):
        st = dict(C=C.clone(), F=F.clone(), costs=costs.clone(),
                  b=b.clone(), base=base.clone(),
                  w=None if w is None else w.clone())
        cand = fn(Tt, st["C"], st["F"], st["costs"], k, t, u, flag, R - 5,
                  eps, ah, st["b"], st["base"], h, p, bk, st["w"], **kw)
        return st, cand

    (s1, c1), (s2, c2) = run(kb.colk_costs, ws=ws), run(kb.colk_costs, ws=ws)
    sp, cp = run(kb.colk_costs_plain)
    assert int(ws[:4].view(torch.int32)) == 0
    for name in s1:
        if s1[name] is not None:
            assert torch.equal(s1[name], s2[name]), name
    for a, b2 in zip(c1, c2):
        assert torch.equal(a, b2)
    assert torch.equal(s1["C"][:t], C[:t])
    assert torch.equal(s1["base"], sp["base"])
    assert int(c1[0]) == int(cp[0]) and int(c1[2]) == int(cp[2])
    if not do:
        assert not s1["C"][t].any() and not s1["F"][t].any()
        for name, x in (("costs", costs), ("b", b), ("base", base), ("w", w)):
            if x is not None:
                assert torch.equal(s1[name], x), name
        return
    assert torch.equal(s1["C"][t][h.long()], p)
    torch.testing.assert_close(s1["C"][t], sp["C"][t], rtol=1e-5, atol=1e-5)
    costs_x = costs - u * s1["C"][t].double()
    assert ((s1["costs"] - costs_x).abs() <= 1e-12 * (1 + costs_x.abs())).all()
    assert ((s1["b"] - sp["b"]).abs() <= 1e-12 * (1 + sp["b"].abs())).all()
    torch.testing.assert_close(s1["F"][t], sp["F"][t], rtol=1e-6, atol=1e-7)
    if devex:
        torch.testing.assert_close(s1["w"], sp["w"], rtol=1e-4, atol=1e-4)


def _window_state(B, M, R, L, seed, devex, dev):
    """A window's inputs: lane 1 frozen, lane 2 with a fuse at 5 pivots
    (mid-window), the others free to run L pivots."""
    rng = np.random.default_rng(seed)
    f = dict(device=dev)
    sci = np.zeros((B, 8), np.int32)
    sci[:, 0] = int(pst.Status.RUNNING)
    sci[:, 4] = 1
    sci[:, 5] = 1000
    sci[1, 4] = 0
    sci[2, 5] = 5
    st = dict(
        costs=torch.from_numpy(rng.uniform(-1, 1, (B, R))).to(**f),
        b=torch.from_numpy(rng.uniform(1, 100, (B, M))).to(**f),
        z=torch.from_numpy(rng.uniform(-5, 5, B)).to(**f),
        base=torch.from_numpy(rng.integers(0, R, (B, M)).astype(
            np.int32)).to(**f),
        w=(torch.from_numpy(rng.uniform(1, 2, (B, R)).astype(np.float32))
           .to(**f) if devex else None),
        sci=torch.from_numpy(sci).to(**f),
        c0=torch.from_numpy(rng.uniform(-1, 1, (B, R))).to(**f),
        cf=torch.from_numpy(rng.uniform(-1, 1, (B, M))).to(**f),
        C=torch.empty((B * L, R), dtype=torch.float32, **f),
        F=torch.empty((B * L, M), dtype=torch.float32, **f),
        AH=torch.empty((B * L, M), dtype=torch.float32, **f),
        piv=torch.empty((B * L, 2), dtype=torch.int32, **f),
        nlive=torch.empty(B, dtype=torch.int32, **f))
    Tt = torch.from_numpy(rng.uniform(-1, 1, (B * M, R)).astype(
        np.float32)).to(**f)
    return Tt, st


_WINDOW_ARGS = ("costs", "b", "z", "base", "w", "sci", "c0", "cf", "C", "F",
                "AH", "piv", "nlive")


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
def test_batch_kernels_match_plain_on_card(cuda, devex):
    """Integer outputs (walk, base, sci, nlive) equal to the plain
    version's; each output against its formula on the kernel's own
    operands (window_replay): the f32 pivot rows and entering columns to
    1e-5 of their terms' magnitudes, the eta rows and devex weights to
    1e-6 relative (the same f32 operations), the f64 vectors to 1e-12
    relative (an f32 accumulation would miss by ~1e-7); the apply against
    the plain version to 1e-5 * (1 + |x|); a frozen lane's tableau
    bit-identical after the apply."""
    B, M, R, L, eps = 4, 128, 384, 16, 1e-5
    Tt, st0 = _window_state(B, M, R, L, 11, devex, cuda)
    kw = dict(r=R - 7, eps=eps, bland_static=False, threshold=50)
    runs = []
    for fn in (kbt.batch_window, kbt.batch_window_plain):
        st = {k: (None if v is None else v.clone()) for k, v in st0.items()}
        fn(Tt, *(st[k] for k in _WINDOW_ARGS), **kw)
        runs.append(st)
    sk, sp = runs
    for name in ("sci", "base", "piv", "nlive"):
        assert torch.equal(sk[name], sp[name]), name
    assert sk["nlive"].tolist()[1:3] == [0, 5]
    assert int(sk["nlive"][0]) == L
    rep = kbt.window_replay(Tt, st0, sk["C"], sk["F"], sk["AH"], sk["piv"],
                            sk["nlive"])
    for name in ("C", "AH"):
        err = (sk[name].view(B, L, -1).double() - rep[name]).abs()
        assert (err <= 1e-5 * (1 + rep[name + "_terms"])).all(), name
    names = ("F", "w") if devex else ("F",)
    for name in names + ("costs", "b", "z"):
        x = rep[name].double()
        tol = (1e-6 if name in ("F", "w") else 1e-12) * (1 + x.abs())
        got = sk[name].view(x.shape).double()
        assert ((got - x).abs() <= tol).all(), name
    assert torch.equal(sk["base"], rep["base"])
    assert torch.equal(sk["cf"], rep["cf"])

    do_r = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=cuda)
    Tk, Tp = Tt.clone(), Tt.clone()
    mv = kbt.batch_apply_reprice(Tk, sk["C"], sk["F"], sk["cf"], do_r,
                                 sk["nlive"])
    kbt.batch_apply_reprice_plain(Tp, sk["C"], sk["F"], sk["cf"], do_r,
                                  sk["nlive"])
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)
    assert torch.equal(Tk[M:2 * M], Tt[M:2 * M])      # the frozen lane
    mv_x = batch_tt_matvec(Tk.view(B, M, R), sk["cf"])
    scale = batch_tt_matvec(Tk.abs().view(B, M, R), sk["cf"].abs())
    live = do_r.bool()
    assert ((mv - mv_x).abs()[live] <= 1e-12 * scale[live]).all()
    assert not mv[2].any()
    Tk, Tp = Tt.clone(), Tt.clone()
    kbt.batch_apply(Tk, sk["C"], sk["F"], sk["nlive"])
    kbt.batch_apply_plain(Tp, sk["C"], sk["F"], sk["nlive"])
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)
    assert torch.equal(Tk[M:2 * M], Tt[M:2 * M])


#: (B, M, R, L) where window_plan picks a cluster of 1, 2, 8 and 16 blocks,
#: the last with L=128 and only a prefix of C's rows in shared memory.
_WINDOW_CASES = {"cs1": (4, 256, 384, 16), "cs2": (4, 128, 1024, 32),
                 "cs8": (4, 128, 4096, 32), "cs16-L128": (4, 128, 15104, 128)}


@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
@pytest.mark.parametrize("rule", ["devex", "dantzig", "bland"])
def test_batch_window_plans_on_card(cuda, case, rule):
    """batch_window at shapes where window_plan spreads a lane over 1 to
    16 blocks: every output bit for bit as the same lanes give inside a
    batch of 32 (where the plan picks another cluster size); the integer
    outputs equal to the plain version's, the rest against the window's
    formulas on its own operands (window_replay), with the tolerances of
    test_batch_kernels_match_plain_on_card. Lane 3 is unbounded at its
    first pivot (its entering column all negative); under "bland" every
    pivot takes the Bland candidate, the lowest index with cost <= -eps:
    the plain version's f32 rows sum in another order and drift from the
    kernel's, so over a long Bland walk a cost at -eps can tip, and at
    L=128 its walk is compared over the first 64 pivots (past the
    resident rows). tools/k7_variants.cu holds every plan to the
    one-block kernel bit for bit."""
    B, M, R, L = _WINDOW_CASES[case]
    devex = rule == "devex"
    plan = kbt.window_plan(B, M, R, L, devex)
    assert plan.cs == int(case[2:].split("-")[0])
    assert plan.res_c < L if L == 128 else plan.res_c == L
    Tt, st0 = _window_state(B, M, R, L, 71, devex, cuda)
    st0["costs"][3, :5] = 0.5                    # column 5 enters lane 3
    st0["costs"][3, 5] = -10.0
    Tt.view(B, M, R)[3, :, 5] = -Tt.view(B, M, R)[3, :, 5].abs()
    if rule == "bland":
        st0["sci"][:, 3] = 1
    kw = dict(r=R - 7, eps=1e-5, bland_static=rule == "bland",
              threshold=50)
    runs = []
    for fn in (kbt.batch_window, kbt.batch_window_plain):
        st = {k: (None if v is None else v.clone()) for k, v in st0.items()}
        fn(Tt, *(st[k] for k in _WINDOW_ARGS), **kw)
        runs.append(st)
    sk, sp = runs
    # The same lanes inside a batch of 32, the others frozen copies.
    B2 = 32
    lanes = torch.tensor([0, 1, 2, 3] + [1] * (B2 - 4), device=cuda)
    assert kbt.window_plan(B2, M, R, L, devex).cs != plan.cs or R < 2048
    T2 = Tt.view(B, M, R)[lanes].reshape(B2 * M, R)
    st2 = {k: None if v is None else (
        v.view(B, -1, *v.shape[1:])[lanes].reshape(B2 * v.shape[0] // B,
                                                   *v.shape[1:]).clone())
        for k, v in st0.items()}
    kbt.batch_window(T2, *(st2[k] for k in _WINDOW_ARGS), **kw)
    for name in _WINDOW_ARGS:
        if sk[name] is not None:
            got = st2[name].view(B2, -1)[:B]
            assert torch.equal(got, sk[name].view(B, -1)), name
    long_bland = rule == "bland" and L > 64
    for name in ("sci", "base", "piv", "nlive"):
        got, want = sk[name], sp[name]
        if long_bland and name == "piv":
            got, want = got.view(B, L, 2)[:, :64], want.view(B, L, 2)[:, :64]
        elif long_bland:
            got, want = got[1:], want[1:]
        assert torch.equal(got, want), name
    nlive = sk["nlive"].tolist()
    assert nlive[1:4] == [0, 5, 0]
    assert nlive[0] == L if L <= 32 else nlive[0] > plan.res_c
    assert int(sk["sci"][3, 0]) == int(pst.Status.UNBOUNDED)
    rep = kbt.window_replay(Tt, st0, sk["C"], sk["F"], sk["AH"], sk["piv"],
                            sk["nlive"])
    for name in ("C", "AH"):
        err = (sk[name].view(B, L, -1).double() - rep[name]).abs()
        assert (err <= 1e-5 * (1 + rep[name + "_terms"])).all(), name
    names = ("F", "w") if devex else ("F",)
    for name in names + ("costs", "b", "z"):
        x = rep[name].double()
        tol = (1e-6 if name in ("F", "w") else 1e-12) * (1 + x.abs())
        got = sk[name].view(x.shape).double()
        assert ((got - x).abs() <= tol).all(), name
    assert torch.equal(sk["base"], rep["base"])
    assert torch.equal(sk["cf"], rep["cf"])


def test_window_smem_bytes_match_c_on_card(cuda):
    """kernels/batched.py's count of a block's shared memory equals the
    kernel's own (csrc/batched.cu window_smem_bytes) for window_plan's
    plan at every shape of the CPU plan tests, for few and many lanes,
    and with the vectors in global memory."""
    from simplex_tpu_torch.kernels._build import load_library

    lib = load_library()
    for M in (128, 512, 4096):
        for R in (384, 3072, 15104, 24576):
            for L in (8, 16, 32, 64, 128):
                for B, devex in ((4, True), (256, False)):
                    p = kbt.window_plan(B, M, R, L, devex)
                    for vec in {p.vec, False}:
                        assert lib.batch_window_smem_bytes(
                            M, R, p.cs, int(devex), int(vec), p.res_c,
                            p.res_f) == kbt.window_smem_bytes(
                                M, R, p.cs, devex, vec, p.res_c, p.res_f)


def test_solve_batch_on_card_matches_cpu(cuda):
    """Statuses equal; objectives within 1e-9 (both refined in f64)."""
    probs = [pst.generate_random_problem(96, 40, s, 1, 100)
             for s in (1, 2, 3)]
    opts = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
                block_pivots=32)
    kbt.reset_launches()
    got = pst.solve_batch(probs, device="cuda", **opts)
    assert kbt.LAUNCHES["batch_window"] > 0
    assert kbt.LAUNCHES["batch_apply_reprice"] > 0
    want = pst.solve_batch(probs, device="cpu", **opts)
    for g, w in zip(got, want):
        assert g.status == w.status == pst.Status.OPTIMAL
        assert g.refine.certified
        assert g.objective == pytest.approx(w.objective, rel=1e-9)


def test_solve_on_card_matches_cpu(cuda, monkeypatch):
    """The production solve on the card: K1 and K2 launched (with their
    tails), each run of the kernel loop allocating one K1 workspace and
    handing it to every K1 call of that run; status equal to the CPU's,
    the objective certified and within 1e-9."""
    from simplex_tpu_torch import solver

    runs, allocs, calls = [], [], []
    loop_kernel = solver.solve_loop_blocked_kernel

    def loop(*args, **kw):
        runs.append(1)
        return loop_kernel(*args, **kw)

    def workspace(M, device):
        ws = kb.ah_ratio_workspace(M, device)
        allocs.append(ws.data_ptr())
        return ws

    def k1(*args, **kw):
        ws = args[8] if len(args) > 8 else kw.get("ws")
        calls.append(ws is not None and ws.data_ptr() == allocs[-1])
        return kb.ah_ratio_tail(*args, **kw)

    monkeypatch.setattr(solver, "solve_loop_blocked_kernel", loop)
    monkeypatch.setattr(solver, "ah_ratio_workspace", workspace)
    monkeypatch.setattr(solver, "ah_ratio_tail", k1)
    p = pst.generate_random_problem(128, 64, 2, 1, 100)
    kb.reset_launches()
    got = pst.solve(p, device="cuda", **PROD)
    assert kb.LAUNCHES["ah_ratio"] > 0 and kb.LAUNCHES["colk_costs"] > 0
    assert kb.LAUNCHES["step_mid_tail"] == kb.LAUNCHES["ah_ratio"]
    assert kb.LAUNCHES["step_post_tail"] == kb.LAUNCHES["colk_costs"]
    assert runs and len(allocs) == len(runs)
    assert calls and all(calls)
    want = pst.solve(p, device="cpu", **PROD)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


@pytest.mark.parametrize("do", [True, False], ids=["pivot", "identity"])
def test_fused_pivot_matches_plain_on_card(cuda, do):
    """K6 at a mid shape (R not a multiple of the 1,024-column tile): the
    tableau and costs equal to the plain version's bit for bit (the same
    two roundings per element, pinned with _rn), the candidates equal;
    with do false nothing changes."""
    M, R, r, eps = 384, 2056, 2000, 1e-4
    Tt = _rand((M, R), 21).to(cuda)
    costs = _rand((R,), 22).to(cuda)
    k = torch.tensor(77, dtype=torch.int32, device=cuda)
    h = 1234
    colk, a_h = Tt[77].clone(), Tt[:, h].clone()
    p, minc = a_h[77].clone(), costs[h].clone()
    flag = torch.tensor(do, device=cuda)
    outs = []
    for fn in (kp.fused_pivot, kp.fused_pivot_plain):
        T2, c2 = Tt.clone(), costs.clone()
        cand = fn(T2, c2, colk, a_h, p, minc, k, r, eps, flag)
        outs.append((T2, c2, cand))
    (Tk, ck, cand_k), (Tp, cp, cand_p) = outs
    assert torch.equal(Tk, Tp) and torch.equal(ck, cp)
    for a, b in zip(cand_k, cand_p):
        assert torch.equal(a, b)
    if not do:
        assert torch.equal(Tk, Tt) and torch.equal(ck, costs)


def test_default_solve_on_card_matches_cpu(cuda):
    """f64, the sequential loop: random_256_256 walks 473 + 17 pivots on
    the card as on the CPU (and in the JAX package); objectives within
    1e-12 (the card's reductions sum in another order)."""
    p = pst.read_random_problem(DATA / "benchmark_problems"
                                / "random_256_256.txt")
    got = pst.solve(p, device="cuda")
    want = pst.solve(p, device="cpu")
    assert got.status == want.status == pst.Status.OPTIMAL
    assert (got.iterations_phase1, got.iterations_phase2) == (473, 17)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)


def test_resumable_walk_on_card_matches_cpu(cuda, tmp_path):
    """f64, the sequential loop in windows of 100 pivots (the Bland clamp
    off): random_256_256's resumable solve walks on the card as on the
    CPU (473 + 17, the walk of ``solve``), objectives within 1e-12; the
    file gone at the end."""
    p = pst.read_random_problem(DATA / "benchmark_problems"
                                / "random_256_256.txt")
    got = pst.solve_resumable(p, str(tmp_path / "card.npz"), 100,
                              bland_threshold=None)
    want = pst.solve_resumable(p, str(tmp_path / "host.npz"), 100,
                               bland_threshold=None, device="cpu")
    assert got.status == want.status == pst.Status.OPTIMAL
    assert (got.iterations_phase1, got.iterations_phase2) == (473, 17)
    assert (want.iterations_phase1, want.iterations_phase2) == (473, 17)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert not list(tmp_path.iterdir())


def test_resume_on_card_from_cpu_file(cuda, tmp_path):
    """A checkpoint written on the CPU (a MAXITER run keeps it) finishes
    on the card as the card's uninterrupted run does: f64 in windows of
    100, the same walk, objectives within 1e-12; the production options
    (the kernel loop, K1-K3 launched) in windows of 128, refined and
    certified within 1e-9 (the CPU's f32 windows round apart from the
    card's, so their walks are not pinned)."""
    p = pst.read_random_problem(DATA / "benchmark_problems"
                                / "random_256_256.txt")
    for opts, every, cap in ((dict(bland_threshold=None), 100, 250),
                             (PROD, 128, 256)):
        path = str(tmp_path / "state.npz")
        cut = pst.solve_resumable(p, path, every, device="cpu",
                                  **dict(opts, max_iter=cap))
        assert cut.status == pst.Status.MAXITER
        kb.reset_launches()
        got = pst.solve_resumable(p, path, every, **opts)
        want = pst.solve_resumable(p, str(tmp_path / "fresh.npz"), every,
                                   **opts)
        assert got.status == want.status == pst.Status.OPTIMAL
        if "block_pivots" in opts:
            assert got.refine.certified and want.refine.certified
            assert got.objective == pytest.approx(want.objective, rel=1e-9)
            assert all(kb.LAUNCHES[k] > 0 for k in (
                "ah_ratio", "colk_costs", "apply_reprice"))
        else:
            assert (got.iterations_phase1, got.iterations_phase2) == (
                want.iterations_phase1, want.iterations_phase2)
            assert got.objective == pytest.approx(want.objective, rel=1e-12)
        assert not list(tmp_path.iterdir())


def test_pallas_solve_on_card_launches_k6(cuda):
    p = pst.generate_random_problem(128, 64, 2, 1, 100)
    kp.reset_launches()
    got = pst.solve(p, device="cuda", dtype=np.float32,
                    vector_dtype=np.float32, use_pallas=True)
    assert kp.LAUNCHES["fused_pivot"] > 0
    want = pst.solve(p, device="cpu", dtype=np.float64)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-3)


def test_k5_k11_k12_match_plain_on_card(cuda):
    """K5's column equal to K1's bit for bit (the same device code) and to
    its plain version at 1e-5 * (1 + |x|) (another summation order of t
    products); K11 and K12 to 1e-12 of the f64 formula's magnitude, and
    bit for bit to K3 / batch_apply_reprice run with zero etas (the same
    fold); K12's unflagged lane zero."""
    M, R, L, eps = 256, 384, 16, 1e-4
    Tt = _rand((M, R), 31).to(cuda)
    C = _rand((L, R), 32).to(cuda)
    F = _rand((L, M), 33, -0.1, 0.1).to(cuda)
    b = _rand((M,), 34, 0, 100, np.float64).to(cuda)
    for t, h in ((0, 127), (7, 128), (L - 1, 255)):
        C[t:] = 0
        F[t:] = 0
        hh = torch.tensor(h, dtype=torch.int32, device=cuda)
        got = kb.ah(Tt, F, C, hh, t)
        assert torch.equal(got, kb.ah_ratio(Tt, F, C, b, hh, t, eps)[0])
        torch.testing.assert_close(got, kb.ah_plain(Tt, F, C, hh, t),
                                   rtol=1e-5, atol=1e-5)
    coeffs = _rand((M,), 35, dtype=np.float64).to(cuda)
    mv = kb.reprice(Tt, coeffs)
    scale = tt_matvec(Tt.abs(), coeffs.abs())
    assert ((mv - kb.reprice_plain(Tt, coeffs)).abs() <= 1e-12 * scale).all()
    zero = torch.zeros((8, R), device=cuda), torch.zeros((8, M), device=cuda)
    assert torch.equal(mv, kb.apply_reprice(Tt.clone(), *zero, coeffs))

    B = 3
    T3 = _rand((B * M, R), 36).to(cuda)
    cf = _rand((B, M), 37, dtype=np.float64).to(cuda)
    flags = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    mv = kbt.batch_reprice(T3, cf, flags)
    scale = batch_tt_matvec(T3.abs().view(B, M, R), cf.abs())
    assert ((mv - kbt.batch_reprice_plain(T3, cf, flags)).abs()
            <= 1e-12 * scale).all()
    assert not mv[1].any()
    zC = torch.zeros((B * 8, R), device=cuda)
    zF = torch.zeros((B * 8, M), device=cuda)
    nlive = torch.zeros(B, dtype=torch.int32, device=cuda)
    assert torch.equal(mv, kbt.batch_apply_reprice(T3.clone(), zC, zF, cf,
                                                   flags, nlive))


@pytest.mark.parametrize("t", [0, 1, 127, 129])
def test_ah_equals_k1_column_on_card(cuda, t):
    """K5 runs K1's kernel without its ratio test: its column equals K1's
    bit for bit, across a second pass of the chain at t = 129 (past
    AHR_ROWS = 128 staged rows), and the plain version's to 1e-5 * (1 +
    |x|) (another summation order of t products)."""
    M, R, L, eps = 384, 256, 136, 1e-4
    Tt = _rand((M, R), 81).to(cuda)
    C = _rand((L, R), 82).to(cuda)
    F = _rand((L, M), 83, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 84, 0, 100, np.float64).to(cuda)
    h = torch.tensor(200, dtype=torch.int32, device=cuda)
    got = kb.ah(Tt, F, C, h, t)
    assert torch.equal(got, kb.ah_ratio(Tt, F, C, b, h, t, eps)[0])
    torch.testing.assert_close(got, kb.ah_plain(Tt, F, C, h, t), rtol=1e-5,
                               atol=1e-5)


def test_solve_sharded_world_size_one_on_card(cuda, tmp_path):
    """solve_sharded on one NCCL rank: K5 launched, K1 not; the walk and
    the certified objective of solve() on the card."""
    from simplex_tpu_torch.parallel.group import world

    p = pst.generate_random_problem(128, 64, 2, 1, 100)
    want = pst.solve(p, device="cuda", **PROD)
    with world(0, 1, "nccl", str(tmp_path)) as group:
        kb.reset_launches()
        got = pst.solve_sharded(p, group, device="cuda", **PROD)
        assert kb.LAUNCHES["ah"] > 0 and kb.LAUNCHES["ah_ratio"] == 0
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified
    assert (got.iterations_phase1, got.iterations_phase2) == (
        want.iterations_phase1, want.iterations_phase2)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def _rank1_case(cuda, dtype, B, M, R, do, offset=0, seed=0):
    """batch_rank1 on random lanes (a dead lane's first element -0.0)
    against its plain version, bit for bit; ``offset`` elements of a
    buffer before T3 put its first element off a 16-byte boundary. Returns
    the launches."""
    g = torch.Generator().manual_seed(seed)
    buf = (torch.rand(offset + B * M * R, generator=g, dtype=torch.float64)
           * 200 - 100).to(dtype).to(cuda)
    T3 = buf[offset:].view(B, M, R)
    dead = [i for i in range(B) if not do[i]]
    if dead:
        T3[dead[0], 0, 0] = -0.0
    factor = (torch.rand((B, M), generator=g, dtype=torch.float64) * 2
              - 1).to(dtype).to(cuda)
    colk = (torch.rand((B, R), generator=g, dtype=torch.float64) * 200
            - 100).to(dtype).to(cuda)
    flags = torch.tensor(do, device=cuda)
    want = T3.clone()
    kp.batch_rank1_plain(want, factor, colk, flags)
    kp.reset_launches()
    kp.batch_rank1(T3, factor, colk, flags)
    torch.cuda.synchronize()
    assert torch.equal(T3, want)
    if dead:
        assert torch.signbit(T3[dead[0], 0, 0])
    return kp.LAUNCHES["batch_rank1"]


@pytest.mark.parametrize("dtype,R", [(torch.float64, 64), (torch.float64, 63),
                                     (torch.float32, 64), (torch.float32, 63),
                                     (torch.float64, 1), (torch.float32, 1),
                                     (torch.float64, 2), (torch.float32, 2),
                                     (torch.float64, 2999),
                                     (torch.float32, 2999)])
def test_batch_rank1_matches_plain_on_card(cuda, dtype, R):
    """The batched fallback's rank-1 update against its plain version
    (the single-LP loop's ``addr_`` on each live lane), bit for bit, with
    rows of whole 16-byte vectors and not (R = 1, 2, 63, 64, 2,999; M =
    37, so a tile ends inside a row); a lane whose flag is clear keeps
    every bit, a -0.0 included."""
    assert _rank1_case(cuda, dtype, 5, 37, R,
                       [True, True, False, True, True], seed=R) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,M,R,which,offset", [
    (6, 1, 63, "some", 0),          # one row a lane
    (3, 700, 63, "all", 0),         # many tiles a lane, rows cut by tiles
    (1100, 2, 3, "some", 0),        # many lanes of one tile each
    (9, 37, 63, "one", 0),
    (9, 37, 63, "none", 0),
    (5, 37, 64, "some", 1),         # T3 off a 16-byte boundary
    (5, 37, 63, "some", 3)])
def test_batch_rank1_shapes_on_card(cuda, dtype, B, M, R, which, offset):
    """batch_rank1 bit for bit its plain version at one row a lane, at
    lanes of many tiles, with many lanes of one tile each, with one live
    lane and none (nothing written), and on a T3 whose first element lies
    off a 16-byte boundary (which the wrapper lets through)."""
    do = {"all": [True] * B, "none": [False] * B,
          "one": [i == B // 2 for i in range(B)],
          "some": [i % 3 != 1 for i in range(B)]}[which]
    assert _rank1_case(cuda, dtype, B, M, R, do, offset, seed=B + M) == 1


def test_batch_rank1_refuses_a_foreign_plan_on_card(cuda):
    """The kernel's tile count is the plan's, and a plan with another
    count or tile width is refused with an error, nothing run."""
    from simplex_tpu_torch.kernels._build import load_library

    lib = load_library()
    for M, R, item in ((512, 3000, 8), (512, 2999, 8), (37, 63, 4),
                       (1, 1, 8)):
        for vecs in (2, 4, 8):
            assert lib.batch_rank1_lane_tiles(M, R, item, vecs) == (
                kp.rank1_lane_tiles(M, R, item, vecs))
    M, R = 300, 40
    T3 = torch.ones((2, M, R), dtype=torch.float64, device=cuda)
    f = torch.ones((2, M), dtype=torch.float64, device=cuda)
    c = torch.ones((2, R), dtype=torch.float64, device=cuda)
    do = torch.ones(2, dtype=torch.bool, device=cuda)
    stream = kb._stream(T3)
    ptrs = [kb._ptr(x) for x in (T3, f, c, do)]
    tiles = kp.rank1_lane_tiles(M, R, 8, 4)
    for vecs, n in ((4, tiles - 1), (4, tiles + 1),
                    (8, kp.rank1_lane_tiles(M, R, 8, 8))):
        assert lib.batch_rank1_f64_launch(*ptrs, 2, M, R, vecs, n,
                                          stream) != 0
    torch.cuda.synchronize()
    assert torch.equal(T3, torch.ones_like(T3))


def test_default_batch_walks_as_solve_on_card(cuda):
    """Route (a) of the batched fallback on the card (the default f64
    options: the lane-batched sequential loop over ``batch_rank1``): each
    lane walks as the single-LP ``solve`` does on the card (pivot counts
    equal, objective within 1e-12)."""
    problems = [pst.generate_random_problem(60, 30, s, 1, 100)
                for s in range(4)]
    kp.reset_launches()
    got = pst.solve_batch(problems, device="cuda")
    assert kp.LAUNCHES["batch_rank1"] > 0
    for p, r in zip(problems, got):
        want = pst.solve(p, device="cuda")
        assert r.status == want.status == pst.Status.OPTIMAL
        assert (r.iterations_phase1, r.iterations_phase2) == (
            want.iterations_phase1, want.iterations_phase2)
        assert r.objective == pytest.approx(want.objective, rel=1e-12)


@pytest.mark.parametrize("opts,kernel", [
    (dict(dtype=np.float64, block_pivots=8), "auto"),
    (dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
          block_pivots=8), False)], ids=["f64-blocked", "kernel-false"])
def test_blocked_fallback_walks_as_solve_on_card(cuda, opts, kernel):
    """Route (b) of the batched fallback on the card (the lane-batched
    plain blocked loop): no kernel launched; each lane against the
    single-LP ``solve(use_pallas=False)`` on the card -- f64 pivot counts
    equal and objectives within 1e-12, mixed lanes certified within 1e-9
    with pivot counts within max(3, 10%)."""
    problems = [pst.generate_random_problem(60, 30, s, 1, 100)
                for s in range(4)]
    for mod in (kb, kbt, kp):
        mod.reset_launches()
    got = pst.solve_batch(problems, device="cuda", kernel=kernel, **opts)
    assert not any({**kb.LAUNCHES, **kbt.LAUNCHES, **kp.LAUNCHES}.values())
    f64 = opts["dtype"] == np.float64
    for p, r in zip(problems, got):
        want = pst.solve(p, device="cuda", use_pallas=False, **opts)
        assert r.status == want.status == pst.Status.OPTIMAL
        walk = (r.iterations_phase1, r.iterations_phase2)
        if f64:
            assert walk == (want.iterations_phase1, want.iterations_phase2)
            assert r.objective == pytest.approx(want.objective, rel=1e-12)
        else:
            assert r.refine.certified and want.refine.certified
            assert r.objective == pytest.approx(want.objective, rel=1e-9)
            for a, b in zip(walk, (want.iterations_phase1,
                                   want.iterations_phase2)):
                assert abs(a - b) <= max(3, 0.1 * b)

@pytest.mark.parametrize("opts", [
    dict(dtype=np.float32, vector_dtype=np.float32, eps=1e-4),
    dict(dtype=np.float32, vector_dtype=np.float64)])
def test_f32_sequential_batch_walks_as_solve_on_card(cuda, opts):
    """Route (a) on an f32 tableau (pure f32, and f32 with f64 vectors):
    ``batch_rank1``'s f32 entry point on the card, each lane walking as
    the single-LP ``solve`` does on the card (pivot counts equal,
    objective within 1e-6 of it)."""
    problems = [pst.generate_random_problem(60, 30, s, 1, 100)
                for s in range(4)]
    kp.reset_launches()
    got = pst.solve_batch(problems, device="cuda", **opts)
    assert kp.LAUNCHES["batch_rank1"] > 0
    for p, r in zip(problems, got):
        want = pst.solve(p, device="cuda", **opts)
        assert r.status == want.status == pst.Status.OPTIMAL
        assert (r.iterations_phase1, r.iterations_phase2) == (
            want.iterations_phase1, want.iterations_phase2)
        assert r.objective == pytest.approx(want.objective, rel=1e-6)


def test_fallback_solve_on_card(cuda):
    """The finishing tier's full f64 re-solve on the card, refined on the
    host: certified at the CPU re-solve's objective."""
    from simplex_tpu_torch import two_phase

    p = pst.generate_random_problem(120, 48, 5, 1, 100)
    opts = pst.SolverOptions(**PROD)
    got = two_phase.fallback_solve(p, opts, device="cuda")
    want = two_phase.fallback_solve(p, opts, device="cpu")
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified and got.refine.method == "tableau"
    assert got.objective == pytest.approx(want.objective, rel=1e-12)


def _card_scalars(rng, dev):
    """Random per-pivot scalars: status RUNNING or not, iterations at or
    near the fuse, Bland on or off with or without an eligible column,
    the main value around -eps, unbounded or not, p of either sign, and
    the stall near its threshold."""
    s = kb.pivot_scalars(torch.tensor(rng.uniform(-5, 5), device=dev),
                         bool(rng.integers(2)))
    vals = dict(
        status=int(rng.choice([int(pst.Status.RUNNING),
                               int(pst.Status.OPTIMAL)], p=[0.8, 0.2])),
        iterations=int(rng.integers(8, 11)), stall=int(rng.integers(47, 51)),
        h_d=int(rng.integers(0, 500)), v_d=-1e-4 * rng.uniform(0.5, 3),
        h_b=int(rng.choice([3, kb.BIG_INDEX])), v_b=-rng.uniform(0, 1),
        k=int(rng.integers(0, 200)), p_k1=rng.uniform(-2, 2),
        bk=rng.uniform(0, 1e-3) * rng.choice([1, 1e4]),
        unb=int(rng.random() < 0.2))
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    return s


@pytest.mark.parametrize("policy", [(False, 50), (False, None), (True, 50)],
                         ids=["threshold", "never", "static"])
def test_step_tails_match_plain_on_card(cuda, policy):
    """``step_pre``, then K1 and K2 with the steps as their tails, against
    ``step_pre_plain``, K1, ``step_mid_plain``, K2 and ``step_post_plain``
    from the same card scalars and tableau, 256 random states under devex
    and Dantzig, with and without the next pivot's step: every scalar,
    K1's column and every vector K2 updates bit for bit (the f64
    division, product and differences rounded apart, as torch does). A
    state drawn unbounded gets K1 an eps no row reaches."""
    bland_static, threshold = policy
    rng = np.random.default_rng(31)
    M, R, L, t, eps = 256, 512, 8, 3, 1e-4
    g = torch.Generator(device=cuda).manual_seed(31)

    def uni(shape, lo, hi, dtype=torch.float32):
        x = torch.rand(shape, generator=g, device=cuda, dtype=dtype)
        return x * (hi - lo) + lo

    Tt = uni((M, R), -1.0, 1.0)
    C = torch.zeros((L, R), device=cuda)
    F = torch.zeros((L, M), device=cuda)
    C[:t] = uni((t, R), -1.0, 1.0)
    F[:t] = uni((t, M), -0.01, 0.01)
    tab = dict(C=C, F=F, b=uni((M,), 0.0, 1.0, torch.float64),
               costs=uni((R,), -1.0, 1.0, torch.float64),
               base=torch.randint(0, R, (M,), generator=g, device=cuda,
                                  dtype=torch.int32),
               w=uni((R,), 1.0, 2.0))
    seen = set()
    kb.reset_launches()
    for i in range(256):
        s = _card_scalars(rng, cuda)
        sp = kb.PivotScalars(**{k: x.clone() for k, x in s.tensors().items()})
        k1_eps = 1e30 if bool(s.unb) else eps
        then_pre = i % 4 < 2
        runs = []
        for sc, tails in ((s, True), (sp, False)):
            st = {k: v.clone() for k, v in tab.items()}
            if i % 2:
                st["w"] = None
            ah = torch.empty(M, device=cuda)
            if tails:
                kb.step_pre(sc, 10, eps)
                kb.ah_ratio_tail(Tt, st["F"], st["C"], st["b"], t, k1_eps,
                                 sc, ah)
                kb.colk_costs_tail(Tt, st["C"], st["F"], st["costs"], t,
                                   R - 16, eps, ah, st["b"], st["base"],
                                   st["w"], sc, 10,
                                   bland_static=bland_static,
                                   threshold=threshold, then_pre=then_pre)
            else:
                kb.step_pre_plain(sc, 10, eps)
                kb.ah_ratio(Tt, st["F"], st["C"], st["b"], sc.h, t, k1_eps,
                            out=(ah, sc.k, sc.p_k1, sc.bk, sc.unb))
                kb.step_mid_plain(sc)
                kb.colk_costs(Tt, st["C"], st["F"], st["costs"], sc.k, t,
                              sc.u, sc.do, R - 16, eps, ah, st["b"],
                              st["base"], sc.h, sc.p, sc.bk, st["w"],
                              out=(sc.h_d, sc.v_d, sc.h_b, sc.v_b))
                kb.step_post_plain(sc, 10, eps, bland_static, threshold,
                                   then_pre)
            runs.append((st, ah))
        for name, x in s.tensors().items():
            assert torch.equal(x, getattr(sp, name)), (i, name, x)
        assert torch.equal(runs[0][1], runs[1][1]), i
        for name, x in runs[0][0].items():
            if x is not None:
                assert torch.equal(x, runs[1][0][name]), (i, name)
        seen.add((bool(s.do), bool(s.unb)))
    assert {(True, False), (False, False), (False, True)} <= seen
    assert (kb.LAUNCHES["step_pre"], kb.LAUNCHES["ah_ratio"],
            kb.LAUNCHES["step_mid_tail"], kb.LAUNCHES["colk_costs"],
            kb.LAUNCHES["step_post_tail"]) == (256, 512, 256, 512, 256)


@pytest.mark.parametrize("with_costs0", [True, False],
                         ids=["costs0", "no_costs0"])
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_window_graph_matches_eager_on_card(cuda, monkeypatch, rule,
                                            with_costs0):
    """The loop as one CUDA graph a window against ``graph=False`` (the
    same kernels enqueued eagerly) from one phase-1 tableau: the same
    status and iterations, the final Tt, b, costs, z, base and devex
    weights bit for bit, and the same launch counts (a replay adds the
    graph's launches, the capture none)."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    n, m = 600, 200
    opts = pst.SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                             block_pivots=16, pivot_rule=rule)
    p = pst.generate_random_problem(n, m, 5, 1, 100)
    tab0 = build_phase1(torch.as_tensor(p.A, device=cuda),
                        torch.as_tensor(p.b, device=cuda), n, m, opts)
    costs0 = tab0.costs if with_costs0 else None
    tab0 = gaussian_eliminate(tab0)
    loops = []
    make = solver.kernel_loop
    monkeypatch.setattr(solver, "kernel_loop",
                        lambda *a, **kw: loops.append(make(*a, **kw))
                        or loops[-1])
    runs = {}
    for graph in (False, True):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        kb.reset_launches()
        out, status, iters = solver.solve_loop_blocked_kernel(
            tab, opts, 5000, costs0, graph=graph)
        torch.cuda.synchronize()
        runs[graph] = (out, status, iters, dict(kb.LAUNCHES), loops[-1].w)
    (eo, est, eit, el, ew), (go, gst, git, gl, gw) = runs[False], runs[True]
    assert est == gst == int(pst.Status.OPTIMAL) and eit == git > 16
    for name in ("Tt", "b", "costs", "z", "base"):
        assert torch.equal(getattr(go, name), getattr(eo, name)), name
    assert (ew is None) == (rule != "devex")
    if ew is not None:
        assert torch.equal(gw, ew)
    assert gl == el
    for name in ("ah_ratio", "colk_costs", "step_pre", "step_mid_tail",
                 "step_post_tail"):
        assert gl[name] > 0, name
    assert gl["ah_ratio"] == gl["step_mid_tail"] == gl["step_post_tail"] == (
        gl["colk_costs"]) == 16 * gl["step_pre"]


def _same(a, b) -> bool:
    """Equal values, a NaN equal to a NaN (a NaN b gives a NaN bk)."""
    return a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
        if a.is_floating_point() else torch.equal(a, b))


def _card_sharded_state(rng, P, R_loc, M, dev, edge=None):
    """Random sharded step scalars (as ``_card_scalars``, plus the folded
    weights), a summed column with ties and unbounded draws, b, base, the
    slice weights and each rank's K2 candidates, some ranks empty. With
    ``edge`` the column is one of the ratio test's edge cases: "nan" (a
    NaN b on two eligible rows), "tie" (the smallest quotient on three
    rows 2,048 apart: in other blocks of the card's cluster, and two in
    one thread), "none" (no
    eligible row)."""
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5), device=dev),
                           bool(rng.integers(2)))
    for name, x in _card_scalars(rng, dev).tensors().items():
        getattr(s, name).copy_(x)
    s.h_d.fill_(int(rng.integers(0, P * R_loc)))
    s.h_b.fill_(int(rng.choice([int(rng.integers(0, P * R_loc)),
                                kb.BIG_INDEX])))
    s.w_d.fill_(rng.uniform(1, 3))
    s.w_b.fill_(rng.uniform(1, 3))
    ah = rng.uniform(-1, 1, M).astype(np.float32)
    if rng.random() < 0.2:
        ah = -np.abs(ah)
    b = rng.uniform(0, 10, M)
    j = rng.integers(0, M, 2)
    ah[j], b[j] = 0.5, 1.25                      # a tie in b / a_h
    if edge == "nan":
        j = rng.integers(0, M, 2)
        ah[j], b[j] = 0.5, np.nan
    elif edge == "tie":
        j = int(rng.integers(0, M - 4096)) + np.array([0, 2048, 4096])
        ah[j], b[j] = 4.0, 1e-4
    elif edge == "none":
        ah = -np.abs(ah)
    cands = []
    for _ in range(P):
        c = (int(rng.integers(0, R_loc)), -rng.uniform(0.1, 3),
             int(rng.integers(0, R_loc)), -rng.uniform(0.1, 3))
        if rng.random() < 0.2:
            c = (0, float("inf"), kb.BIG_INDEX, float("inf"))
        elif rng.random() < 0.2:
            c = (2, -1.5, c[2], c[3])            # ties across ranks
        cands.append(c)
    w = torch.from_numpy(rng.uniform(1, 4, (P, R_loc)).astype(np.float32))
    w[:, 2] = 2.0
    return (s, torch.from_numpy(ah).to(dev), torch.from_numpy(b).to(dev),
            torch.from_numpy(rng.integers(0, P * R_loc, M).astype(np.int32))
            .to(dev), w.to(dev), cands)


@pytest.mark.parametrize("policy", [(False, 50), (False, None), (True, 50)],
                         ids=["threshold", "never", "static"])
@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
def test_sharded_step_kernels_match_plain_on_card(cuda, devex, policy):
    """Each sharded step kernel against its plain version on the same card
    tensors, 128 random states at P = 1, 2 and 4, a NaN b, a tie across
    the cluster's blocks or no eligible row in every fourth: every output
    bit for bit (each rank's pre and ratio at M = 8192, its pack, and each
    rank's fold, with and without the next pivot's pre after it)."""
    rng = np.random.default_rng(41)
    M, R_loc, eps = 8192, 128, 1e-4
    kb.reset_launches()
    for i in range(128):
        P = (1, 2, 4)[i % 3]
        edge = (None, "nan", "tie", "none")[i % 4] if i % 2 else None
        s0, ah, b, base, w, cands = _card_sharded_state(rng, P, R_loc, M,
                                                        cuda, edge)
        kv = 5 if devex else 2
        Vs = [torch.empty((P, kv), dtype=torch.float64, device=cuda)
              for _ in range(2)]
        Is = [torch.empty((P, 2), dtype=torch.int32, device=cuda)
              for _ in range(2)]
        ranks = []
        for rank in range(P):
            where = dict(offset=rank * R_loc, R_loc=R_loc)
            sk, sp = (kb.ShardedScalars(**{n: x.clone() for n, x in
                                           s0.tensors().items()})
                      for _ in range(2))
            kb.sharded_step_pre(sk, 10, eps, **where)
            kb.sharded_step_pre_plain(sp, 10, eps, **where)
            kb.sharded_ratio(sk, ah, b, eps)
            kb.sharded_ratio_plain(sp, ah, b, eps)
            for name, x in sk.tensors().items():
                assert _same(x, getattr(sp, name)), (i, edge, name)
            for x in (sk, sp):
                for name, v in zip(("h_d", "v_d", "h_b", "v_b"),
                                   cands[rank]):
                    getattr(x, name).fill_(v)
            wr = w[rank] if devex else None
            kb.sharded_pack(sk, wr, rank * R_loc, Vs[0][rank], Is[0][rank])
            kb.sharded_pack_plain(sp, wr, rank * R_loc, Vs[1][rank],
                                  Is[1][rank])
            ranks.append((sk, sp))
        assert torch.equal(Vs[0], Vs[1]) and torch.equal(Is[0], Is[1]), i
        for rank, (sk, sp) in enumerate(ranks):
            where = dict(offset=rank * R_loc, R_loc=R_loc)
            kb.sharded_fold(sk, Vs[0], Is[0])
            kb.sharded_fold_plain(sp, Vs[1], Is[1])
            if i % 2:
                kb.sharded_step_pre(sk, 10, eps, **where)
                kb.sharded_step_pre_plain(sp, 10, eps, **where)
            for name, x in sk.tensors().items():
                assert _same(x, getattr(sp, name)), (i, rank, name, x)
    n = sum((1, 2, 4)[i % 3] for i in range(128))
    n_odd = sum((1, 2, 4)[i % 3] for i in range(1, 128, 2))
    assert (kb.LAUNCHES["sharded_step_pre"], kb.LAUNCHES["sharded_ratio"],
            kb.LAUNCHES["sharded_pack"],
            kb.LAUNCHES["sharded_fold"]) == (n + n_odd, n, n, n)


def test_sharded_ratio_cluster_edges_on_card(cuda):
    """The cluster ``sharded_ratio`` against its plain version at M =
    8,192 (two constraints a thread), 10,112 (three) and 40,064 (three
    passes of four), bit for bit: a NaN b on eligible rows (the first NaN
    wins), equal quotients in different blocks of the cluster and in one
    thread (the lowest row wins), no eligible row (k = 0, unbounded)."""
    rng = np.random.default_rng(43)
    kb.reset_launches()
    for M in (8192, 10112, 40064):
        for edge in ("nan", "tie", "none"):
            for _ in range(4):
                s0, ah, b, *_ = _card_sharded_state(rng, 1, 128, M, cuda,
                                                    edge)
                s0.status.fill_(int(pst.Status.RUNNING))
                s0.iterations.fill_(0)
                s0.minc.fill_(-0.5)
                s0.active.fill_(True)
                s0.optimal.fill_(False)
                sk, sp = (kb.ShardedScalars(**{n: x.clone() for n, x in
                                               s0.tensors().items()})
                          for _ in range(2))
                kb.sharded_ratio(sk, ah, b, 1e-4)
                kb.sharded_ratio_plain(sp, ah, b, 1e-4)
                for name, x in sk.tensors().items():
                    assert _same(x, getattr(sp, name)), (M, edge, name)
                assert bool(sk.unb) == (edge == "none")
                if edge == "nan":
                    assert torch.isnan(sk.bk)
    assert kb.LAUNCHES["sharded_ratio"] == 36


def _card_window(P, devex, seed, dev):
    """P slices of 128 columns (M = 256, L = 8) for a few pivots: the
    scalars, each slice's Tt, costs and weights, the replicated b, base
    and factors."""
    rng = np.random.default_rng(seed)
    M, R = 256, 128 * P
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5), device=dev),
                           bool(rng.integers(2)))
    w = rng.uniform(1, 3, R).astype(np.float32)
    h_d, h_b = int(rng.integers(0, R)), int(rng.integers(0, R))
    for name, v in dict(h_d=h_d, v_d=-rng.uniform(0.5, 3), h_b=h_b,
                        v_b=-rng.uniform(0.1, 1), iterations=3,
                        stall=int(rng.integers(47, 51)),
                        w_d=float(w[h_d]) if devex else 1.0,
                        w_b=float(w[h_b]) if devex else 1.0).items():
        getattr(s, name).fill_(v)
    Tt = _rand((M, R), seed + 1)
    costs = _rand((R,), seed + 2, dtype=np.float64)
    ranks = []
    for rank in range(P):
        cols = slice(128 * rank, 128 * (rank + 1))
        ranks.append(dict(
            s=kb.ShardedScalars(**{n: x.clone()
                                   for n, x in s.tensors().items()}),
            Tt=Tt[:, cols].contiguous().to(dev),
            costs=costs[cols].clone().to(dev),
            w=torch.from_numpy(w[cols].copy()).to(dev) if devex else None,
            C=torch.zeros((8, 128), device=dev),
            F=torch.zeros((8, M), device=dev),
            b=_rand((M,), seed + 3, 0, 10, np.float64).to(dev),
            base=torch.from_numpy(rng.integers(0, R, M).astype(np.int32))
            .to(dev), ah=torch.empty(M, device=dev),
            ws=kb.colk_workspace(128, dev),
            where=dict(offset=128 * rank, R_loc=128)))
    return ranks


@pytest.mark.parametrize("policy", [(False, 50), (False, None), (True, 50)],
                         ids=["threshold", "never", "static"])
@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
def test_sharded_tail_and_head_match_plain_chains_on_card(cuda, devex,
                                                          policy):
    """Six pivots of the sharded window at P = 1, 2 and 4 two ways on the
    same card tensors: K5 with its head and K2 with its sharded tail (the
    step after K2 and the pack into the gathered buffers), and their
    plain chains -- ``sharded_fold_plain`` and ``sharded_step_pre_plain``
    then K5 without its head, K2 without its tail then ``step_post_plain``
    and ``sharded_pack_plain`` -- every scalar, column, vector and
    gathered buffer bit for bit after each pivot; the head and the tails
    count a launch beside their carriers'."""
    bland_static, threshold = policy
    eps, pivots = 1e-4, 6
    for P in (1, 2, 4):
        kb.reset_launches()
        runs = [_card_window(P, devex, 50 + P, cuda) for _ in range(2)]
        kv = 5 if devex else 2
        gathered = [(torch.empty((P, kv), dtype=torch.float64, device=cuda),
                     torch.empty((P, 2), dtype=torch.int32, device=cuda))
                    for _ in range(2)]
        for ranks in runs:
            for x in ranks:
                kb.sharded_step_pre_plain(x["s"], 10, eps, **x["where"])
        for t in range(pivots):
            for chain, (ranks, (V, I)) in enumerate(zip(runs, gathered)):
                for x in ranks:
                    s = x["s"]
                    if t and chain == 0:
                        kb.ah_fold_head(x["Tt"], x["F"], x["C"], t, s, V, I,
                                        10, eps, x["where"]["offset"],
                                        out=x["ah"])
                        continue
                    if t:
                        kb.sharded_fold_plain(s, V, I)
                        kb.sharded_step_pre_plain(s, 10, eps, **x["where"])
                    kb.ah(x["Tt"], x["F"], x["C"], s.hl, t, own=s.own,
                          out=x["ah"])
                col = sum(x["ah"] for x in ranks)
                for rank, x in enumerate(ranks):
                    s = x["s"]
                    x["ah"].copy_(col)
                    kb.sharded_ratio_plain(s, x["ah"], x["b"], eps)
                    args = (x["Tt"], x["C"], x["F"], x["costs"])
                    if chain == 0:
                        kb.colk_costs_sharded_tail(
                            *args, t, 128, eps, x["ah"], x["b"], x["base"],
                            x["w"], s, 10, x["ws"],
                            offset=x["where"]["offset"],
                            bland_static=bland_static, threshold=threshold,
                            send_v=V[rank], send_i=I[rank])
                    else:
                        kb.colk_costs(
                            *args, s.k, t, s.u, s.do, 128, eps, x["ah"],
                            x["b"], x["base"], s.h, s.p, s.bk, x["w"],
                            x["ws"], out=(s.h_d, s.v_d, s.h_b, s.v_b),
                            offset=x["where"]["offset"],
                            w_h=None if x["w"] is None else s.wh)
                        kb.step_post_plain(s, 10, eps, bland_static,
                                           threshold, False)
                        kb.sharded_pack_plain(s, x["w"],
                                              x["where"]["offset"], V[rank],
                                              I[rank])
            (V0, I0), (V1, I1) = gathered
            assert torch.equal(V0, V1) and torch.equal(I0, I1), (P, t)
            for rank, (a, b_) in enumerate(zip(*runs)):
                for name, x in a["s"].tensors().items():
                    assert torch.equal(x, getattr(b_["s"], name)), (
                        P, t, rank, name)
                for name in ("ah", "C", "F", "costs", "w", "b", "base"):
                    if a[name] is not None:
                        assert torch.equal(a[name], b_[name]), (
                            P, t, rank, name)
        assert (kb.LAUNCHES["sharded_fold_head"],
                kb.LAUNCHES["sharded_post_tail"],
                kb.LAUNCHES["sharded_pack_tail"]) == (
                    P * (pivots - 1), P * pivots, P * pivots)
        assert kb.LAUNCHES["sharded_pack"] == 0
        assert kb.LAUNCHES["ah"] == 2 * P * pivots
        assert kb.LAUNCHES["colk_costs"] == 2 * P * pivots


def _card_pack_slices(case, P, devex, seed, dev):
    """K2's operands on P slices of 384 columns (six of K2's blocks; M =
    256, L = 8, t = 3) and a pivot it takes or skips: "seeded" taken,
    random; "nan_weights" skipped, NaN weights on a third of the columns
    and at each slice's column 0; "no_eligible" skipped, every cost
    positive; "h_candidate" taken, h (on the last slice, its column 5)
    the most negative cost and the first eligible one there;
    "cross_block_tie" skipped, equal costs and weights at columns 10 and
    330 (blocks 0 and 5) of every slice."""
    rng = np.random.default_rng(seed)
    M, R_loc, L, t = 256, 384, 8, 3
    R = P * R_loc
    Tt = rng.uniform(-1, 1, (M, R)).astype(np.float32)
    C = rng.uniform(-1, 1, (L, R)).astype(np.float32)
    F = rng.uniform(-0.1, 0.1, (L, M)).astype(np.float32)
    C[t:] = 0
    F[t:] = 0
    costs = rng.uniform(-1, 1, R)
    w = rng.uniform(1, 3, R).astype(np.float32)
    ah = rng.uniform(-1, 1, M).astype(np.float32)
    k = int(rng.integers(0, M))
    ah[k] = 0.9
    h = int(rng.integers(0, R))
    do = case in ("seeded", "h_candidate")
    if case == "nan_weights":
        w[rng.random(R) < 1 / 3] = np.nan
        w[::R_loc] = np.nan
    elif case == "no_eligible":
        costs = np.abs(costs) + 0.1
    elif case == "h_candidate":
        h = (P - 1) * R_loc + 5
        costs[h - 5:h] = 20.0
        costs[h] = -50.0
    elif case == "cross_block_tie":
        for c0 in range(0, R, R_loc):
            costs[c0 + 10] = costs[c0 + 330] = -3.0
            w[c0 + 10] = w[c0 + 330] = 2.0
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5), device=dev),
                           False)
    for name, v in dict(status=int(pst.Status.RUNNING), iterations=3,
                        stall=4, active=True, optimal=False, unb=0, do=do,
                        k=k, h=h, p=float(ah[k]) if do else 1.0,
                        u=-0.7 / float(ah[k]) if do else 0.0,
                        bk=rng.uniform(0, 1),
                        wh=float(w[h]) if devex else 1.0).items():
        getattr(s, name).fill_(v)
    b = rng.uniform(0, 10, M)
    base = rng.integers(0, R, M).astype(np.int32)
    out = []
    for rank in range(P):
        cols = slice(rank * R_loc, (rank + 1) * R_loc)
        x = dict(Tt=Tt[:, cols], C=C[:, cols], F=F, costs=costs[cols],
                 w=w[cols] if devex else None, ah=ah, b=b, base=base)
        x = {n: None if v is None else torch.from_numpy(
            np.ascontiguousarray(v)).to(dev) for n, v in x.items()}
        x.update(s=kb.ShardedScalars(**{n: v.clone() for n, v in
                                        s.tensors().items()}),
                 r=R_loc - (5 if rank == P - 1 and case == "seeded" else 0),
                 offset=rank * R_loc, ws=kb.colk_workspace(R_loc, dev))
        out.append(x)
    return out


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
def test_pack_tail_matches_plain_chain_on_card(cuda, devex):
    """K2 with the step after K2 and the pack as its tail against K2 with
    the step alone and then the pack -- the boundary's ``sharded_pack``
    kernel and ``sharded_pack_plain`` -- on the same card tensors, at P =
    1, 2 and 4 under the five cases of ``_card_pack_slices``: the send
    buffers, every scalar and every vector bit for bit, a NaN equal to a
    NaN; one launch of ``sharded_pack_tail`` a tail."""
    kv = 5 if devex else 2
    n = 0
    for case in ("seeded", "nan_weights", "no_eligible", "h_candidate",
                 "cross_block_tie"):
        for P in (1, 2, 4):
            slices = _card_pack_slices(case, P, devex, 60 + P, cuda)
            runs = []
            kb.reset_launches()
            for way in ("tail", "kernel", "plain"):
                V = torch.full((P, kv), -7.0, dtype=torch.float64,
                               device=cuda)
                I = torch.full((P, 2), -7, dtype=torch.int32, device=cuda)
                states = []
                for rank, x0 in enumerate(slices):
                    x = {n_: v.clone() if isinstance(v, torch.Tensor)
                         else v for n_, v in x0.items() if n_ != "s"}
                    sc = kb.ShardedScalars(**{n_: v.clone() for n_, v in
                                              x0["s"].tensors().items()})
                    send = (dict(send_v=V[rank], send_i=I[rank])
                            if way == "tail" else {})
                    kb.colk_costs_sharded_tail(
                        x["Tt"], x["C"], x["F"], x["costs"], 3, x["r"],
                        1e-4, x["ah"], x["b"], x["base"], x["w"], sc, 10,
                        x["ws"], offset=x["offset"], bland_static=False,
                        threshold=50, **send)
                    if way != "tail":
                        (kb.sharded_pack if way == "kernel" else
                         kb.sharded_pack_plain)(sc, x["w"], x["offset"],
                                                V[rank], I[rank])
                    states.append((sc, x))
                runs.append((V, I, states))
            assert (kb.LAUNCHES["sharded_pack_tail"],
                    kb.LAUNCHES["sharded_pack"],
                    kb.LAUNCHES["sharded_post_tail"]) == (P, P, 3 * P)
            (V, I, st), *others = runs
            for V2, I2, st2 in others:
                assert _same(V, V2) and torch.equal(I, I2), (case, P, V, V2)
                for (sa, xa), (sb, xb) in zip(st, st2):
                    for name, x in sa.tensors().items():
                        assert _same(x, getattr(sb, name)), (case, P, name)
                    for name in ("C", "F", "costs", "w", "b", "base"):
                        if xa[name] is not None:
                            assert _same(xa[name], xb[name]), (case, P, name)
            last = st[-1][0]
            if case == "h_candidate":
                assert int(last.h_d) == int(last.h_b) == 5
            elif case == "cross_block_tie":
                assert (I[:, 0] == torch.arange(P, device=cuda) * 384
                        + 10).all()
            elif case == "no_eligible":
                assert (I[:, 1] == kb.BIG_INDEX).all()
            n += 1
    assert n == 15


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
@pytest.mark.parametrize("t", [0, 5])
def test_colk_offset_and_ah_owner_on_card(cuda, t, devex):
    """K5 with its owner flag: its column where the rank owns h, zeros
    where not, bit for bit. K2 with offset 0 and ``w_h = w[h]`` is its
    single-card call bit for bit. On the second of two slices (offset R;
    h and the leaving variable on it or on the first) K2 matches its
    plain version with the same arguments: bit for bit at t = 0, where no
    eta row sums; at t = 5 C[t] to 1e-5 and the weights to 1e-4 (another
    summation order of the pivot row), the costs to 1e-12 of the f64
    formula on the kernel's own pivot row, the candidates' values the
    kernel's own costs at the same indices, the rest bit for bit."""
    M, R, L, eps = 256, 384, 16, 1e-4
    Tt = _rand((M, R), 1).to(cuda)
    C = _rand((L, R), 2).to(cuda)
    F = _rand((L, M), 3, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 4, 0, 100, np.float64).to(cuda)
    costs = _rand((R,), 5, dtype=np.float64).to(cuda)
    w = _rand((R,), 6, 1, 2).to(cuda) if devex else None
    h33 = torch.tensor(33, dtype=torch.int32, device=cuda)
    ah = kb.ah(Tt, F, C, h33, t)
    for own in (True, False):
        out = torch.empty_like(ah)
        kb.ah(Tt, F, C, h33, t, own=torch.tensor(own, device=cuda), out=out)
        assert torch.equal(out, ah if own else torch.zeros_like(ah))
    k = torch.tensor(7, dtype=torch.int32, device=cuda)
    p = ah[7].clone()
    u = -0.5 / p.double()
    do = torch.tensor(True, device=cuda)
    base0 = torch.arange(M, dtype=torch.int32, device=cuda)
    ws = kb.colk_workspace(R, cuda)

    def run(fn, h, lvar, **kw):
        base = base0.clone()
        base[7] = lvar
        st = dict(C=C.clone(), F=F.clone(), costs=costs.clone(),
                  b=b.clone(), base=base,
                  w=None if w is None else w.clone())
        cand = fn(Tt, st["C"], st["F"], st["costs"], k, t, u, do, R - 5,
                  eps, ah, st["b"], st["base"],
                  torch.tensor(h, dtype=torch.int32, device=cuda), p,
                  b[7].clone(), st["w"], **kw)
        return [x for x in st.values() if x is not None] + list(cand)

    w_h = None if w is None else w[40].clone()
    for a, b_ in zip(run(kb.colk_costs, 40, 9, ws=ws),
                     run(kb.colk_costs, 40, 9, ws=ws, offset=0, w_h=w_h)):
        assert torch.equal(a, b_)
    for h, lvar in ((R + 40, R + 9), (40, 9), (R + 40, 9), (40, R + 9)):
        w_h = None if w is None else w[h % R].clone()
        got = run(kb.colk_costs, h, lvar, ws=ws, offset=R, w_h=w_h)
        want = run(kb.colk_costs_plain, h, lvar, offset=R, w_h=w_h)
        names = ["C", "F", "costs", "b", "base"] + (["w"] if devex else [])
        got_costs = got[2]
        for name, a, b_ in zip(names + ["h_d", "v_d", "h_b", "v_b"], got,
                               want):
            if t and name == "C":
                torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
            elif t and name == "w":
                torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-4)
            elif t and name == "costs":
                x = costs - u * got[0][t].double()
                assert ((a - x).abs() <= 1e-12 * (1 + x.abs())).all()
            elif t and name in ("v_d", "v_b"):
                j = int(got[len(names) + (2 if name == "v_b" else 0)])
                assert (float(a) == float("inf") if j == kb.BIG_INDEX
                        else torch.equal(a, got_costs[j])), name
            else:
                assert torch.equal(a, b_), (name, h, lvar)


def test_sharded_loop_graph_matches_eager_on_card(cuda, monkeypatch,
                                                  tmp_path):
    """The sharded kernel loop at one NCCL rank as one CUDA graph a window
    against ``graph=False`` from one phase-1 slice, under devex and
    Dantzig: the same status and iterations, the final Tt, b, costs, z,
    base and weights bit for bit, the same launches and collectives (a
    replay adds the graph's, the capture none), and K5, the step kernels
    and K2 launched with K1 not."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    n, m = 600, 200
    p = pst.generate_random_problem(n, m, 5, 1, 100)
    loops = []
    make = ps.sharded_kernel_loop
    monkeypatch.setattr(ps, "sharded_kernel_loop",
                        lambda *a: loops.append(make(*a)) or loops[-1])
    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        for rule in ("devex", "dantzig"):
            opts = pst.SolverOptions(dtype=np.float32,
                                     vector_dtype=np.float64,
                                     block_pivots=16, pivot_rule=rule)
            R_pad, M_pad = ps.sharded_padded_dims(n, m, 1, opts)
            shard = pg.Shard.of(group, R_pad)
            tab0 = ps.build_phase1_sharded(
                torch.as_tensor(p.A), torch.as_tensor(p.b, device=cuda), n,
                m, shard, opts, M_pad, cuda)
            costs0 = tab0.costs
            tab0 = ps.gaussian_eliminate_sharded(tab0, shard)
            runs = {}
            for graph in (False, True):
                tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
                kb.reset_launches()
                pg.reset_counts()
                out, status, iters = ps.solve_loop_blocked_kernel_sharded(
                    tab, shard, opts, 5000, costs0, graph=graph)
                torch.cuda.synchronize()
                runs[graph] = (out, status, iters, dict(kb.LAUNCHES),
                               dict(pg.COUNTS), loops[-1].w)
            (eo, est, eit, el, ec, ew), (go, gst, git, gl, gc, gw) = (
                runs[False], runs[True])
            assert est == gst == int(pst.Status.OPTIMAL) and eit == git > 16
            for name in ("Tt", "b", "costs", "z", "base"):
                assert torch.equal(getattr(go, name), getattr(eo, name)), (
                    rule, name)
            assert (ew is None) == (rule != "devex")
            if ew is not None:
                assert torch.equal(gw, ew)
            assert gl == el and gc == ec, rule
            for name in ("ah", "colk_costs", "sharded_step_pre",
                         "sharded_ratio", "sharded_pack", "sharded_fold",
                         "sharded_post_tail", "sharded_pack_tail",
                         "sharded_fold_head"):
                assert gl[name] > 0, name
            assert gl["ah_ratio"] == 0
            # K2 packs every pivot; sharded_pack only at the boundaries.
            assert gl["sharded_pack_tail"] == gl["sharded_post_tail"]
            assert gl["sharded_pack"] < gl["sharded_pack_tail"]


# ---------------------------------------------------------------------------
# The sequential loops as one CUDA graph a chunk (kernels/seq.py).

SEQ_PAIRS = {"f64": (np.float64, np.float64),
             "mixed": (np.float32, np.float64),
             "f32": (np.float32, np.float32)}


def _seq_phase1(dev, pair, n=300, m=100, seed=5, **kw):
    """An eliminated phase-1 tableau on ``dev`` of the dtype pair, and its
    options (Dantzig unless ``kw`` says otherwise)."""
    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    T, V = SEQ_PAIRS[pair]
    opts = pst.SolverOptions(dtype=T, vector_dtype=V, **kw)
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    tab = build_phase1(torch.as_tensor(p.A, device=dev),
                       torch.as_tensor(p.b, device=dev), n, m, opts)
    return gaussian_eliminate(tab), opts


def _bits_equal(a, b) -> bool:
    """Bit for bit, a NaN equal to a NaN and the sign of a zero kept."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool((nan | ((a == b) & (torch.signbit(a) == torch.signbit(b))))
                .all())


class PriorLibs:
    """The sharded loops' slice passes and K5's sharded head as the port
    launched them before their redesign, from ``tools/eta_variants.cu``
    (``colk_prior``) and ``tools/seq_variants.cu`` (``seq_prior``,
    ``k5_prior``) built as libraries by nvcc (``-DETA_VARIANTS_LIB``,
    ``-DSEQ_VARIANTS_LIB``): each launched on a slice's loop state, or on
    the shipped wrapper's operands, as the shipped wrappers launch the
    shipped forms."""

    def __init__(self, td: pathlib.Path) -> None:
        import ctypes
        import subprocess

        from simplex_tpu_torch.kernels import _build

        root = pathlib.Path(__file__).resolve().parent.parent
        builds = {}
        for tool, define in (("eta_variants.cu", "ETA_VARIANTS_LIB"),
                             ("seq_variants.cu", "SEQ_VARIANTS_LIB")):
            path = td / f"lib{define.lower()}.so"
            builds[define] = (path, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                 f"-D{define}", "-o", str(path), str(root / "tools" / tool)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        libs = {}
        for define, (path, proc) in builds.items():
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-2000:]
            libs[define] = ctypes.CDLL(str(path))
        sig = _build.SIGNATURES
        self.eta, self.seq = libs["ETA_VARIANTS_LIB"], libs["SEQ_VARIANTS_LIB"]
        self.eta.prior_eta_colk_slice_launch.argtypes = \
            sig["eta_colk_slice_launch"]
        self.seq.prior_seq_fold_column_launch.argtypes = \
            sig["seq_fold_column_launch"]
        pass_sig = list(sig["seq_ratio_colk_sharded_launch"])
        del pass_sig[18]                         # the cluster's threads
        self.seq.prior_seq_ratio_colk_sharded_launch.argtypes = pass_sig
        self.seq.prior_ah_head_launch.argtypes = sig["ah_head_launch"]

    @staticmethod
    def _ptr(x):
        return None if x is None else x.data_ptr()

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def eta_colk_slice(self, lp, t, eps, cap, bland_static, threshold):
        import ctypes

        from simplex_tpu_torch.kernels import eta as ke
        from simplex_tpu_torch.kernels import seq as ks

        M, R = lp.Tt.shape
        L = lp.C.shape[0]
        plan = ke.eta_plan(M, R, L, lp.Tt.element_size())
        p = self._ptr
        err = self.eta.prior_eta_colk_slice_launch(
            p(lp.Tt), p(lp.C), p(lp.F), p(lp.costs), p(lp.b), p(lp.base),
            p(lp.w), p(lp.ah), M, R, L, lp.r_loc, t, eps, p(lp.ws),
            lp.ws.numel(), ctypes.byref(ks._seq_ptrs(lp.s)), cap,
            *ks._policy(bland_static, threshold), ks._pair(lp.s), plan.rows,
            plan.cols, plan.stage_colk, lp.shard.offset, p(lp.wh),
            p(lp.send_v), p(lp.send_i), p(lp.send_w), self._stream())
        assert err == 0, err

    def seq_fold_column(self, lp, max_iter, eps):
        self.fold_column(lp.Tt, lp.recv_v, lp.recv_i, lp.ah, lp.s, max_iter,
                         eps, lp.shard.offset)

    def fold_column(self, Tt, V, I, ah, s, max_iter, eps, offset):
        """``kernels.seq.seq_fold_column``'s operands."""
        import ctypes

        from simplex_tpu_torch.kernels import seq as ks

        M, R = Tt.shape
        p = self._ptr
        err = self.seq.prior_seq_fold_column_launch(
            p(Tt), p(V), p(I), V.shape[0], M, R, offset, p(ah),
            ctypes.byref(ks._seq_ptrs(s)), max_iter, eps, ks._pair(s),
            self._stream())
        assert err == 0, err

    def ah_fold_head(self, Tt, F, C, t, s, V, I, max_iter, eps, offset,
                     out):
        """``kernels.blocked.ah_fold_head``'s operands."""
        import ctypes

        M, R = Tt.shape
        p = self._ptr
        err = self.seq.prior_ah_head_launch(
            p(Tt), p(F), p(C), t, M, R, p(out),
            ctypes.byref(kb._shard_step_ptrs(s)), p(V), p(I), *V.shape,
            max_iter, eps, offset, self._stream())
        assert err == 0, err

    def seq_ratio_colk_sharded(self, lp, max_iter, eps, bland_static,
                               threshold):
        import ctypes

        from simplex_tpu_torch.kernels import seq as ks

        M, R = lp.Tt.shape
        p = self._ptr
        err = self.seq.prior_seq_ratio_colk_sharded_launch(
            p(lp.Tt), p(lp.costs), p(lp.b), p(lp.base), p(lp.ah),
            p(lp.colk), p(lp.fac), M, R, lp.r_loc, eps,
            ctypes.byref(ks._seq_ptrs(lp.s)), max_iter,
            *ks._policy(bland_static, threshold), lp.shard.offset,
            p(lp.send_v), p(lp.send_i), ks._pair(lp.s), self._stream())
        assert err == 0, err


@pytest.fixture(scope="module")
def prior_libs(tmp_path_factory):
    """``PriorLibs``, built once a module (skipped without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return PriorLibs(tmp_path_factory.mktemp("prior"))


#: (dtype pair, K6 loop) of the loops: solve_loop at each pair, K6's pure f32.
SEQ_LOOPS = [("f64", False), ("mixed", False), ("f32", False), ("f32", True)]


@pytest.mark.parametrize("pair,pallas", SEQ_LOOPS,
                         ids=["f64", "mixed", "f32", "k6"])
def test_seq_kernels_match_plain_on_card(cuda, pair, pallas):
    """Each pivot kernel of the sequential loops against its plain version
    on the same card tensors, pivot by pivot along a whole walk (taken,
    then skipped pivots) and from edge states drawn at every fourth pivot
    (a NaN in b on an eligible row, a tie of the smallest quotient, no
    eligible row, Bland on with a Bland candidate, the fuse reached):
    ``seq_step_pre``, ``seq_ratio_colk`` against ``seq_ratio``'s and
    ``seq_colk``'s plain versions (K6 loop: ``seq_ratio_snapshot`` against
    ``seq_ratio``'s and ``seq_snapshot``'s, ``fused_pivot_tail``) and
    ``seq_rank1``; every
    scalar and vector, the gathered column, the row and the factors bit
    for bit, the tableau too."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import seq as ks

    tab, opts = _seq_phase1(cuda, pair, use_pallas=pallas)
    eps = float(opts.eps_resolved)
    rng = np.random.default_rng(19)
    loops = [solver.seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                             opts, pallas=pallas) for _ in range(2)]
    M = tab.Tt.shape[0]
    kinds = set()
    for i in range(160):
        if i % 4 == 3:
            edge = rng.integers(5)
            for lp in loops:
                s = lp.s
                kb.step_pre_plain(s, 100, eps)      # the next pivot's h
                if edge == 0:
                    s.bland.fill_(True)
                elif edge == 1:
                    s.iterations.fill_(100)         # the fuse
                else:
                    # The next pivot's column, bent as the edge says.
                    h = int(s.h)
                    col = lp.Tt[:, h]
                    rows = torch.nonzero(col >= eps).view(-1)
                    if edge == 2 and rows.numel() > 1:
                        lp.b[rows[1]] = float("nan")
                    elif edge == 3 and rows.numel() > 1:
                        j1, j2 = int(rows[0]), int(rows[-1])
                        col[j2] = col[j1]
                        lp.b[j2] = lp.b[j1]
                    elif edge == 4:
                        col.copy_(-col.abs())
        for lp, kernel in zip(loops, (True, False)):
            s = lp.s
            policy = dict(bland_static=False, threshold=50)
            if kernel:
                ks.seq_step_pre(s, 100, eps)
            else:
                kb.step_pre_plain(s, 100, eps)
            if pallas:
                if kernel:
                    ks.seq_ratio_snapshot(lp.Tt, lp.b, lp.base, lp.ah,
                                          lp.colk, s, eps)
                    ks.fused_pivot_tail(lp.Tt, lp.costs, lp.colk, lp.ah, s,
                                        lp.r, eps, 100, lp.ws_pass,
                                        then_pre=False, **policy)
                else:
                    ks.seq_ratio_plain(lp.Tt, lp.b, s, lp.ah, eps)
                    ks.seq_snapshot_plain(lp.Tt, lp.b, lp.base, lp.ah,
                                          lp.colk, s)
                    ks.fused_pivot_tail_plain(lp.Tt, lp.costs, lp.colk,
                                              lp.ah, s, lp.r, eps, 100,
                                              then_pre=False, **policy)
            elif kernel:
                ks.seq_ratio_colk(lp.Tt, lp.costs, lp.b, lp.base, lp.ah,
                                  lp.colk, lp.fac, s, lp.r, eps, 100,
                                  then_pre=True, **policy)
                ks.seq_rank1(lp.Tt, lp.fac, lp.colk, s)
            else:
                ks.seq_ratio_plain(lp.Tt, lp.b, s, lp.ah, eps)
                ks.seq_colk_plain(lp.Tt, lp.costs, lp.b, lp.base, lp.ah,
                                  lp.colk, lp.fac, s, lp.r, eps, 100,
                                  then_pre=True, **policy)
                ks.seq_rank1_plain(lp.Tt, lp.fac, lp.colk, s)
        (a, b) = loops
        for name, x in a.s.tensors().items():
            assert _bits_equal(x, getattr(b.s, name)), (i, name)
        for name in ("Tt", "b", "costs", "base", "ah", "colk", "fac"):
            x, y = getattr(a, name), getattr(b, name)
            assert x is None or _bits_equal(x, y), (i, name)
        kinds.add((bool(a.s.do), bool(a.s.unb)))
        for lp in loops:
            # Go on walking from the state the pivot left: running again,
            # below the fuse, b and z without the NaN.
            lp.s.status.fill_(int(pst.Status.RUNNING))
            lp.s.iterations.fill_(0)
            lp.b.nan_to_num_(nan=1.0)
            lp.s.z.nan_to_num_(nan=0.0)
    assert {(True, False), (False, True)} <= kinds, kinds
    assert M % 128 == 0


def _old_eager_seq(tab, opts, cap):
    """The sequential loop as it ran eagerly before the chunk's graph:
    ``iteration_body`` driven a chunk a host read
    (tests/test_torch_sharded_seq.py ``drive``)."""
    from simplex_tpu_torch import solver
    from test_torch_sharded_seq import drive

    state, st, it = drive(lambda s: solver.iteration_body(s, opts, cap),
                          solver.initial_state(tab, opts), cap)
    return state.tab, st, it


@pytest.mark.parametrize("pair,pallas", SEQ_LOOPS,
                         ids=["f64", "mixed", "f32", "k6"])
def test_seq_graph_matches_eager_on_card(cuda, monkeypatch, pair, pallas):
    """``solve_loop`` (``solve_loop_pallas``) as one CUDA graph a chunk
    against ``graph=False`` and against the loop as it ran before: the
    old eager ``iteration_body`` on the card (the K6 loop: its plain
    versions on the CPU, whose arithmetic K6 keeps bit for bit). The
    same status and iterations, the final Tt, b, costs, z and base bit for
    bit (Tt against the old body by value: its skipped pivots' addr_ with
    factor 0 may turn a -0.0 into +0.0), the same launches -- 2 a pivot
    (``seq_ratio_colk`` counting ``seq_ratio`` and its tail ``seq_colk``)
    and ``seq_step_pre`` once a chunk (the K6 loop: 2 a pivot as well,
    ``seq_ratio_snapshot`` counting ``seq_ratio`` and its tail
    ``seq_snapshot``, K6 one kernel counting ``fused_pivot`` and its tail
    ``seq_k6_tail``) -- a replay adding the graph's, the capture none."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import seq as ks

    tab0, opts = _seq_phase1(cuda, pair, use_pallas=pallas)
    loop_fn = solver.solve_loop_pallas if pallas else solver.solve_loop
    captures = []
    real = solver.capture_chunk
    monkeypatch.setattr(solver, "capture_chunk",
                        lambda *a: captures.append(real(*a)) or captures[-1])
    runs = {}
    for graph in (False, True):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        ks.reset_launches()
        kp.reset_launches()
        out, st, it = loop_fn(tab, opts, 5000, graph=graph)
        torch.cuda.synchronize()
        runs[graph] = (out, st, it, {**ks.LAUNCHES, **kp.LAUNCHES})
    if pallas:
        cpu = dataclasses.replace(tab0, **{
            f: getattr(tab0, f).cpu() for f in ("Tt", "b", "costs", "z",
                                                "base")})
        out, st, it = solver.solve_loop_pallas(cpu, opts, 5000)
        runs["old"] = (dataclasses.replace(out, **{
            f: getattr(out, f).to(cuda) for f in ("Tt", "b", "costs", "z",
                                                  "base")}), st, it)
    else:
        runs["old"] = _old_eager_seq(
            dataclasses.replace(tab0, Tt=tab0.Tt.clone()), opts, 5000)
    (eo, est, eit, el), (go, gst, git, gl) = runs[False], runs[True]
    oo, ost, oit = runs["old"]
    assert est == gst == ost == int(pst.Status.OPTIMAL)
    assert eit == git == oit > 2 * 32
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name), getattr(eo, name)), name
        if name == "Tt" and not pallas:
            assert torch.equal(go.Tt, oo.Tt)
        else:
            assert _bits_equal(getattr(go, name), getattr(oo, name)), name
    assert gl == el and len(captures) == 1
    chunks = gl["seq_step_pre"]
    assert chunks == -(-git // 32) or chunks == -(-git // 32) + 1
    body = (("seq_ratio", "seq_snapshot", "fused_pivot", "seq_k6_tail")
            if pallas else ("seq_ratio", "seq_colk", "seq_rank1"))
    for name in body:
        assert gl[name] == 32 * chunks, (name, gl)
    per = captures[0][1].per_replay
    assert sum(n for name, n in per.items() if name not in ks.TAILS) == (
        2 * 32 + 1)


@pytest.mark.parametrize("cap", [1, 31, 32, 33])
@pytest.mark.parametrize("pallas", [False, True], ids=["seq", "k6"])
def test_seq_graph_fuse_is_exact_on_card(cuda, cap, pallas):
    """A capped graphed loop stops at the cap whatever the chunk: status
    RUNNING, exactly ``cap`` pivots, the state of ``graph=False``."""
    from simplex_tpu_torch import solver

    tab0, opts = _seq_phase1(cuda, "f32" if pallas else "f64",
                             use_pallas=pallas)
    loop_fn = solver.solve_loop_pallas if pallas else solver.solve_loop
    outs = []
    for graph in (True, False):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        out, st, it = loop_fn(tab, opts, cap, graph=graph)
        assert st == int(pst.Status.RUNNING) and it == cap
        outs.append(out)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(outs[0], name), getattr(outs[1], name))


def test_seq_kernels_refuse_on_card(cuda):
    """A launch the kernel refuses raises (an empty shape through the C
    entry points; a dtype pair ``seq_ratio_snapshot`` does not take, or a
    row not of whole 16-byte vectors), a buffer of another shape raises in
    the wrapper, and a dtype pair with no kernel raises: no fallback."""
    from simplex_tpu_torch.kernels import _build
    from simplex_tpu_torch.kernels import seq as ks

    lib = _build.load_library()
    M, R = 512, 1024
    Tt = torch.rand((M, R), dtype=torch.float64, device=cuda)
    b = torch.rand(M, dtype=torch.float64, device=cuda)
    ah = torch.empty(M, dtype=torch.float64, device=cuda)
    s = ks.seq_scalars(torch.zeros((), dtype=torch.float64, device=cuda),
                       False, torch.float64)
    stream = torch.cuda.current_stream().cuda_stream
    step = ks.ctypes.byref(ks._seq_ptrs(s))
    err = lib.seq_ratio_launch(Tt.data_ptr(), b.data_ptr(), 0, R, 1e-9,
                               ah.data_ptr(), step, 0, stream)
    with pytest.raises(RuntimeError, match="seq_ratio: CUDA error"):
        _build.check(lib, err, "seq_ratio")
    base = torch.zeros(M, dtype=torch.int32, device=cuda)
    colk = torch.empty(R, dtype=torch.float64, device=cuda)
    for pair, rows in ((0, R), (2, R - 2)):
        err = lib.seq_ratio_snapshot_launch(
            Tt.data_ptr(), b.data_ptr(), base.data_ptr(), ah.data_ptr(),
            colk.data_ptr(), M, rows, 1e-9, step, pair, stream)
        with pytest.raises(RuntimeError,
                           match="seq_ratio_snapshot: CUDA error"):
            _build.check(lib, err, "seq_ratio_snapshot")
    with pytest.raises(ValueError, match="ah"):
        ks.seq_ratio(Tt, b, s, ah[:-1], 1e-9)
    odd = ks.seq_scalars(torch.zeros((), device=cuda), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ks.seq_ratio(Tt, b.float(), odd, ah, 1e-9)


#: (M, R) of the cluster kernels' edge shapes: one row, a few, M and R not
#: multiples of the cluster's 4,096 threads, past 16,384 rows (a thread
#: walks its rows more than PER at a time), R as the north star's.
SEQ_EDGE_SHAPES = [(1, 3), (7, 21), (4095, 12285), (4097, 257),
                   (40064, 2048), (2048, 120064)]
#: The edge states: a taken pivot, a NaN in b on an eligible row, equal
#: smallest quotients on the first and last eligible rows, no eligible row,
#: Bland static, Bland by its threshold, no eligible column (a skipped
#: pivot over non-negative costs), a skipped pivot (optimal) over equal
#: most negative costs in the first and last live columns.
SEQ_EDGES = ("taken", "nan_b", "tie", "no_row", "bland_static",
             "bland_threshold", "no_column", "skipped")


def _seq_edge_loops(dev, pair, M, R, seed, pallas=False):
    """Two ``SeqLoop``s (K6's with ``pallas``) over one seeded random
    tableau (Tt uniform in [-1, 1], b in [1, 100], the costs in [-1, 1],
    the last quarter of the columns up to 100 dead): the kernels run on
    one, the plain versions on the other."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.tableau import Tableau

    T, V = SEQ_PAIRS[pair]
    rng = np.random.default_rng(seed)
    dead = min(100, R // 4)
    tab = Tableau(torch.from_numpy(rng.uniform(-1, 1, (M, R)).astype(T)),
                  torch.from_numpy(rng.uniform(1, 100, M).astype(V)),
                  torch.from_numpy(rng.uniform(-1, 1, R).astype(V)),
                  torch.zeros((), dtype=torch.float64 if V == np.float64
                              else torch.float32),
                  torch.from_numpy(rng.integers(0, R, M).astype(np.int32)),
                  n=max(0, R - M - dead), m=M, r=R - dead)
    tab = dataclasses.replace(tab, **{f: getattr(tab, f).to(dev) for f in
                                      ("Tt", "b", "costs", "z", "base")})
    opts = pst.SolverOptions(dtype=T, vector_dtype=V)
    return [solver.seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                            opts, pallas=pallas) for _ in range(2)], opts


def _seq_edge(lp, edge, eps, M):
    """Bend ``lp`` into ``edge``'s state before a pivot: running, below
    the fuse, the candidates folded over the costs, the step before."""
    s = lp.s
    s.status.fill_(int(pst.Status.RUNNING))
    s.iterations.fill_(3)
    s.stall.fill_(49 if edge == "bland_threshold" else 0)
    s.bland.fill_(False)
    if edge == "no_column":
        lp.costs.copy_(lp.costs.abs())
    elif edge == "skipped" and lp.r > 1:
        lp.costs[0] = lp.costs[lp.r - 1] = -7.0
    else:
        lp.costs[lp.r - 1] = -5.0                # an entering column
    from simplex_tpu_torch.kernels.seq import set_candidates

    set_candidates(s, kb.entering_candidates(lp.costs, None, lp.r, eps))
    kb.step_pre_plain(s, 100, eps)
    col = lp.Tt[:, int(s.h)]
    if edge == "no_row":
        col.copy_(-col.abs())
        return
    rows = torch.nonzero(col >= eps).view(-1)
    if rows.numel() == 0:
        col[M // 2] = 0.5
        rows = torch.nonzero(col >= eps).view(-1)
    if edge == "nan_b":
        lp.b[rows[rows.numel() // 2]] = float("nan")
    elif edge == "tie" and rows.numel() > 1:
        j1, j2 = int(rows[0]), int(rows[-1])
        col[j2] = col[j1]
        lp.b[j1] = lp.b[j2] = 0.001
    elif edge == "bland_threshold":
        lp.b[rows[0]] = 0.0                      # z does not move
    elif edge == "no_column":
        s.active.fill_(False)
    elif edge == "skipped":
        s.optimal.fill_(True)


@pytest.mark.parametrize("M,R", SEQ_EDGE_SHAPES,
                         ids=[f"{m}x{r}" for m, r in SEQ_EDGE_SHAPES])
@pytest.mark.parametrize("pair", ["f64", "mixed", "f32"])
def test_seq_cluster_edges_match_plain_on_card(cuda, pair, M, R):
    """``seq_ratio_colk`` and ``seq_ratio`` (one cluster each) against
    ``seq_ratio_plain`` and ``seq_colk_plain`` on the card, from every
    state of ``SEQ_EDGES`` at shapes the cluster's walk splits unevenly
    (``SEQ_EDGE_SHAPES``), with ties across blocks in both folds: every
    scalar and vector bit for bit, and ``seq_ratio``'s column and step
    between the plain version's."""
    from simplex_tpu_torch.kernels import seq as ks

    if pair == "f64" and M * R > 2 ** 27:
        R = 2 ** 27 // M                        # 1 GiB of f64 tableau
    loops, opts = _seq_edge_loops(cuda, pair, M, R, seed=M + R)
    eps = float(opts.eps_resolved)
    kinds = set()
    for edge in SEQ_EDGES:
        policy = dict(bland_static=edge == "bland_static", threshold=50)
        for lp in loops:
            _seq_edge(lp, edge, eps, M)
        (a, b) = loops
        ks.seq_ratio_colk(a.Tt, a.costs, a.b, a.base, a.ah, a.colk, a.fac,
                          a.s, a.r, eps, 100, then_pre=True, **policy)
        ks.seq_ratio_plain(b.Tt, b.b, b.s, b.ah, eps)
        ks.seq_colk_plain(b.Tt, b.costs, b.b, b.base, b.ah, b.colk, b.fac,
                          b.s, b.r, eps, 100, then_pre=True, **policy)
        for name, x in a.s.tensors().items():
            assert _bits_equal(x, getattr(b.s, name)), (edge, name)
        for name in ("b", "costs", "base", "ah", "colk", "fac"):
            assert _bits_equal(getattr(a, name), getattr(b, name)), (edge,
                                                                    name)
        kinds.add((edge, bool(a.s.do), bool(a.s.unb)))
        # seq_ratio alone on the next pivot's column.
        for lp in loops:
            lp.s.status.fill_(int(pst.Status.RUNNING))
            kb.step_pre_plain(lp.s, 100, eps)
            lp.b.nan_to_num_(nan=1.0)
            lp.s.z.nan_to_num_(nan=0.0)
        ks.seq_ratio(a.Tt, a.b, a.s, a.ah, eps)
        ks.seq_ratio_plain(b.Tt, b.b, b.s, b.ah, eps)
        for name, x in a.s.tensors().items():
            assert _bits_equal(x, getattr(b.s, name)), ("ratio", edge, name)
        assert _bits_equal(a.ah, b.ah), edge
    done = {e for e, d, _ in kinds if d}
    assert {"taken", "nan_b", "bland_static"} <= done, kinds
    assert ("no_row", False, True) in kinds, kinds
    assert not {"no_column", "skipped"} & done, kinds


#: (M, R) of the K6 loop's edge shapes: rows of whole 16-byte vectors, R
#: not a multiple of K6's 1,024-column blocks, M not of its 32-row bands,
#: one row, past 16,384 rows, R as the north star's.
K6_EDGE_SHAPES = [(1, 4), (7, 20), (4095, 12284), (4097, 260),
                  (40064, 2048), (2048, 120064)]
#: The K6 loop's edge states past ``SEQ_EDGES``: the leaving row the first
#: or the last, and no Bland candidate after a taken pivot.
K6_EDGES = SEQ_EDGES + ("k_first", "k_last", "no_bland")


@pytest.mark.parametrize("M,R", K6_EDGE_SHAPES,
                         ids=[f"{m}x{r}" for m, r in K6_EDGE_SHAPES])
def test_k6_loop_edges_match_plain_on_card(cuda, M, R):
    """The K6 loop's pivot -- ``seq_ratio_snapshot`` (one cluster) and K6
    with its fold and the step after as its last tile block's tail --
    against ``seq_ratio_plain``, ``seq_snapshot_plain`` and
    ``fused_pivot_tail_plain`` on the card, from every state of
    ``K6_EDGES`` at ``K6_EDGE_SHAPES``, with and without the next step
    before: every scalar, vector and the tableau bit for bit; the tail's
    counter back at zero after each call."""
    from simplex_tpu_torch.kernels import seq as ks

    loops, opts = _seq_edge_loops(cuda, "f32", M, R, seed=M + R,
                                  pallas=True)
    eps = float(opts.eps_resolved)
    kinds = set()
    for n, edge in enumerate(K6_EDGES):
        policy = dict(bland_static=edge == "bland_static", threshold=50,
                      then_pre=n % 2 == 0)
        for lp in loops:
            _seq_edge(lp, edge if edge in SEQ_EDGES else "taken", eps, M)
            col = lp.Tt[:, int(lp.s.h)]
            if edge in ("k_first", "k_last"):
                # The one zero quotient: b positive elsewhere.
                j = 0 if edge == "k_first" else M - 1
                lp.b.clamp_(min=1.0)
                col[j] = 0.5
                lp.b[j] = 0.0
            elif edge == "no_bland":
                h = int(lp.s.h)
                lp.costs.copy_(lp.costs.abs() + 3.0)
                lp.costs[h] = -2 * eps
                ks.set_candidates(lp.s, kb.entering_candidates(
                    lp.costs, None, lp.r, eps))
                kb.step_pre_plain(lp.s, 100, eps)
                assert int(lp.s.h) == h
        (a, b) = loops
        ks.seq_ratio_snapshot(a.Tt, a.b, a.base, a.ah, a.colk, a.s, eps)
        ks.fused_pivot_tail(a.Tt, a.costs, a.colk, a.ah, a.s, a.r, eps, 100,
                            a.ws_pass, **policy)
        ks.seq_ratio_plain(b.Tt, b.b, b.s, b.ah, eps)
        ks.seq_snapshot_plain(b.Tt, b.b, b.base, b.ah, b.colk, b.s)
        ks.fused_pivot_tail_plain(b.Tt, b.costs, b.colk, b.ah, b.s, b.r, eps,
                                  100, **policy)
        for name, x in a.s.tensors().items():
            assert _bits_equal(x, getattr(b.s, name)), (edge, name)
        for name in ("Tt", "b", "costs", "base", "ah", "colk"):
            assert _bits_equal(getattr(a, name), getattr(b, name)), (edge,
                                                                    name)
        assert int(a.ws_pass[4, 0]) == 0, edge
        kinds.add((edge, bool(a.s.do), bool(a.s.unb), int(a.s.k),
                   int(a.s.h_b)))
        for lp in loops:
            lp.b.nan_to_num_(nan=1.0)
            lp.s.z.nan_to_num_(nan=0.0)
    done = {e for e, d, *_ in kinds if d}
    assert {"taken", "nan_b", "k_first", "k_last", "no_bland"} <= done, kinds
    assert not {"no_column", "skipped", "no_row"} & done, kinds
    ks_of = {e: k for e, _, _, k, _ in kinds}
    assert ks_of["k_first"] == 0 and ks_of["k_last"] == M - 1, kinds
    assert [hb for e, *_, hb in kinds if e == "no_bland"] == [kb.BIG_INDEX]


# ---------------------------------------------------------------------------
# The sequential sharded loop as one CUDA graph a chunk (kernels/seq.py
# seq_fold_column, seq_ratio_colk_sharded; parallel/sharded.py).

def _sharded_seq_slices(dev, pair, P, n=300, m=100, seed=5):
    """P ``ShardedSeqLoop``s over the slices of one eliminated phase-1
    tableau on ``dev`` (the whole tableau built at one slice, then cut),
    twice: the kernels run on one set, the plain versions on the other;
    and the options."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.tableau import gaussian_eliminate

    T, V = SEQ_PAIRS[pair]
    opts = pst.SolverOptions(dtype=T, vector_dtype=V)
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
    whole = gaussian_eliminate(ps.build_phase1_sharded(
        torch.as_tensor(p.A), torch.as_tensor(p.b, device=dev), n, m,
        pg.Shard(None, 0, 1, R_pad), opts, M_pad, dev))
    sets = []
    for _ in range(2):
        # A slice of every column is the tableau itself: clone it.
        sets.append([ps.sharded_seq_loop(
            dataclasses.replace(sl, Tt=sl.Tt.clone()),
            pg.Shard(None, rank, P, R_pad // P), opts) for rank, sl in (
                (r, ps.shard_tableau(whole, r, P)) for r in range(P))])
    return sets, opts


def _sharded_seq_pivot(loops, opts, kernel, max_iter: int) -> None:
    """One pivot of ``run_chunk_sharded`` on P slices in this process: the
    gathers and the sum of the columns in rank order by torch ops, each
    rank's kernels (``kernel`` true), their plain versions (false) or the
    forms of the column and the pass before their redesign (``kernel`` a
    ``PriorLibs``, then ``seq_rank1``) between them."""
    from simplex_tpu_torch.kernels import seq as ks

    eps = float(opts.eps_resolved)
    policy = dict(bland_static=False, threshold=50)
    prior = kernel if isinstance(kernel, PriorLibs) else None
    V = torch.stack([lp.send_v for lp in loops])
    I = torch.stack([lp.send_i for lp in loops])
    for lp in loops:
        lp.recv_v.copy_(V)
        lp.recv_i.copy_(I)
        if prior:
            prior.seq_fold_column(lp, max_iter, eps)
            continue
        fold = ks.seq_fold_column if kernel else ks.seq_fold_column_plain
        fold(lp.Tt, lp.recv_v, lp.recv_i, lp.ah, lp.s, max_iter, eps,
             lp.shard.offset)
    total = loops[0].ah.clone()
    for lp in loops[1:]:
        total += lp.ah
    for lp in loops:
        lp.ah.copy_(total)
        if prior:
            prior.seq_ratio_colk_sharded(lp, max_iter, eps, **policy)
            ks.seq_rank1(lp.Tt, lp.fac, lp.colk, lp.s)
        elif kernel:
            ks.seq_ratio_colk_sharded(
                lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk, lp.fac, lp.s,
                lp.r_loc, eps, max_iter, offset=lp.shard.offset,
                send_v=lp.send_v, send_i=lp.send_i, **policy)
            ks.seq_rank1(lp.Tt, lp.fac, lp.colk, lp.s)
        else:
            ks.seq_ratio_colk_sharded_plain(
                lp.Tt, lp.costs, lp.b, lp.base, lp.ah, lp.colk, lp.fac, lp.s,
                lp.r_loc, eps, max_iter, lp.shard.offset, lp.send_v,
                lp.send_i, **policy)
            ks.seq_rank1_plain(lp.Tt, lp.fac, lp.colk, lp.s)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair", ["f64", "mixed", "f32"])
def test_sharded_seq_kernels_match_plain_on_card(cuda, pair, P):
    """``seq_fold_column`` and ``seq_ratio_colk_sharded`` (with
    ``seq_rank1``) against their plain versions on P slices of one card's
    phase-1 tableau, pivot by pivot along a walk and from edge states
    drawn at every eighth pivot (a NaN in b on an eligible row, Bland on,
    a tie of the smallest cost across the first and last slices, the fuse
    reached): every scalar, vector, send buffer and slice bit for bit;
    taken, skipped and Bland pivots seen."""
    _sharded_seq_walk(cuda, pair, P, False)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair", ["f64", "mixed", "f32"])
def test_sharded_seq_kernels_match_earlier_forms_on_card(cuda, prior_libs,
                                                        pair, P):
    """The shipped ``seq_fold_column`` and ``seq_ratio_colk_sharded`` (the
    pass a programmatic dependent launch behind the column) against their
    forms before (``tools/seq_variants.cu``'s ``seq_prior``) along the
    same walk and edge states: every scalar, vector, send buffer and slice
    bit for bit."""
    _sharded_seq_walk(cuda, pair, P, prior_libs)


def _sharded_seq_walk(dev, pair, P, other) -> None:
    """The kernels on one set of P slices, ``other`` (False: the plain
    versions; a ``PriorLibs``: the earlier forms) on the other, 48 pivots
    from edge states; every state bit for bit after each."""
    from simplex_tpu_torch.kernels import seq as ks

    (a_set, b_set), opts = _sharded_seq_slices(dev, pair, P)
    eps = float(opts.eps_resolved)
    seen = set()
    for i in range(48):
        edge = (i // 8) % 4 if i % 8 == 7 else None
        for loops in (a_set, b_set):
            for lp in loops:
                s = lp.s
                s.status.fill_(int(pst.Status.RUNNING))
                s.iterations.fill_(100 if edge == 3 else 3)
                s.bland.fill_(edge == 1)
            if edge == 0:
                col = loops[0].ah
                rows = torch.nonzero(col >= eps).view(-1)
                if rows.numel():
                    for lp in loops:
                        lp.b[rows[0]] = float("nan")
            elif edge == 2:
                first, last = loops[0], loops[-1]
                v = torch.minimum(first.costs.min(), last.costs.min()) - 1
                first.costs[0] = v
                last.costs[0 if P > 1 else 1] = v
                for lp in (first, last):
                    ks.pack_candidates(kb.entering_candidates(
                        lp.costs, None, lp.r_loc, eps), lp.shard.offset,
                        lp.send_v, lp.send_i)
        _sharded_seq_pivot(a_set, opts, True, 100)
        _sharded_seq_pivot(b_set, opts, other, 100)
        for rank, (a, b) in enumerate(zip(a_set, b_set)):
            for name, x in a.s.tensors().items():
                assert _bits_equal(x, getattr(b.s, name)), (i, rank, name)
            for name in ("Tt", "b", "costs", "base", "ah", "colk", "fac",
                         "send_v", "send_i", "recv_v", "recv_i"):
                assert _bits_equal(getattr(a, name), getattr(b, name)), (
                    i, rank, name)
        seen.add((edge, bool(a_set[0].s.do)))
        for loops in (a_set, b_set):
            for lp in loops:
                lp.b.nan_to_num_(nan=1.0)
                lp.s.z.nan_to_num_(nan=0.0)
    assert {(None, True), (1, True), (3, False)} <= seen, seen


@pytest.mark.parametrize("pair", ["f64", "mixed", "f32"])
def test_sharded_seq_wide_slice_on_card(cuda, prior_libs, pair):
    """A slice wider than one pass of 16 x 256 x 4 columns (R_loc 20,480,
    so ``seq_sharded_threads`` gives 512 threads a block): 24 pivots of
    the kernels against the plain versions and against the forms before
    (16 x 256), from a seeded random state with every eighth pivot under
    Bland: every scalar, vector, send buffer and the slice bit for bit."""
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.tableau import Tableau

    T, V = (getattr(torch, np.dtype(x).name) for x in SEQ_PAIRS[pair])
    M, R = 96, 20480
    assert ks.seq_sharded_threads(R) == 512
    rng = np.random.default_rng(31)

    def uni(shape, lo, hi, dt):
        return torch.from_numpy(rng.uniform(lo, hi, shape)).to(cuda, dt)

    tab = Tableau(uni((M, R), -1.0, 1.0, T), uni((M,), 0.0, 100.0, V),
                  uni((R,), -1.0, 1.0, V),
                  torch.zeros((), dtype=V, device=cuda),
                  torch.from_numpy(rng.integers(0, R, M)).to(cuda,
                                                             torch.int32),
                  n=R - M - 100, m=M, r=R - 100)
    opts = pst.SolverOptions(dtype=SEQ_PAIRS[pair][0],
                             vector_dtype=SEQ_PAIRS[pair][1])
    sets = [[ps.sharded_seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                                 pg.Shard(None, 0, 1, R), opts)]
            for _ in range(3)]
    taken = 0
    for i in range(24):
        for loops in sets:
            loops[0].s.bland.fill_(i % 8 == 7)
            loops[0].s.status.fill_(int(pst.Status.RUNNING))
        for loops, how in zip(sets, (True, False, prior_libs)):
            _sharded_seq_pivot(loops, opts, how, 1000)
        (a,), (b,), (c,) = sets
        for other in (b, c):
            for name, x in a.s.tensors().items():
                assert _bits_equal(x, getattr(other.s, name)), (i, name)
            for name in ("Tt", "b", "costs", "base", "ah", "colk", "fac",
                         "send_v", "send_i"):
                assert _bits_equal(getattr(a, name), getattr(other, name)), (
                    i, name)
        taken += bool(a.s.do)
    assert taken > 0


def _sharded_seq_tab(dev, group, n=300, m=100, seed=5):
    """One NCCL rank's f64 phase-1 slice (the whole tableau) and the
    default options."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    opts = pst.SolverOptions()
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, 1, opts)
    shard = pg.Shard.of(group, R_pad)
    tab = ps.build_phase1_sharded(torch.as_tensor(p.A),
                                  torch.as_tensor(p.b, device=dev), n, m,
                                  shard, opts, M_pad, dev)
    return ps.gaussian_eliminate_sharded(tab, shard), shard, opts


def test_sharded_seq_graph_matches_eager_on_card(cuda, monkeypatch,
                                                 tmp_path):
    """``solve_loop_sharded`` at one NCCL rank as one CUDA graph a chunk,
    its collectives inside, against ``graph=False`` and against the loop
    as it ran before (``iteration_body_sharded`` driven a chunk a host
    read): the same status and iterations, the final slice, b, costs, z
    and base bit for bit (the slice against the old body by value), the
    same launches and collectives -- a pivot ``seq_fold_column``,
    ``seq_ratio_colk_sharded`` and ``seq_rank1``, 2 ``all_gather``s and 1
    ``all_reduce`` -- a replay adding the graph's, the capture none; the
    captured chunk 3 launches a pivot."""
    from simplex_tpu_torch.kernels import seq as ks
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from test_torch_sharded_seq import old_loop_sharded

    captures = []
    real = ps.capture_chunk_sharded
    monkeypatch.setattr(ps, "capture_chunk_sharded",
                        lambda *a: captures.append(real(*a)) or captures[-1])
    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        tab0, shard, opts = _sharded_seq_tab(cuda, group)
        runs = {}
        for graph in (False, True):
            tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
            ks.reset_launches()
            kp.reset_launches()
            pg.reset_counts()
            out, st, it = ps.solve_loop_sharded(tab, shard, opts, 5000,
                                                graph=graph)
            torch.cuda.synchronize()
            runs[graph] = (out, st, it, {**ks.LAUNCHES, **kp.LAUNCHES},
                           dict(pg.COUNTS))
        oo, ost, oit = old_loop_sharded(
            dataclasses.replace(tab0, Tt=tab0.Tt.clone()), shard, opts, 5000)
    (eo, est, eit, el, ec), (go, gst, git, gl, gc) = runs[False], runs[True]
    assert est == gst == ost == int(pst.Status.OPTIMAL)
    assert eit == git == oit > 2 * 32
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name), getattr(eo, name)), name
        if name == "Tt":
            assert torch.equal(go.Tt, oo.Tt)
        else:
            assert _bits_equal(getattr(go, name), getattr(oo, name)), name
    assert gl == el and gc == ec and len(captures) == 1
    chunks = gl["seq_fold_column"] // 32
    assert chunks in (-(-git // 32), -(-git // 32) + 1)
    for name in ("seq_fold_column", "seq_ratio_colk_sharded", "seq_rank1"):
        assert gl[name] == 32 * chunks, (name, gl)
    assert gl["seq_step_pre"] == gl["seq_ratio"] == 0
    assert gc == {"all_gather": 64 * chunks, "all_reduce": 32 * chunks}
    per = captures[0][1].per_replay
    assert sum(n for name, n in per.items() if name not in ks.TAILS) == 96
    assert dict(captures[0][2].counts) == {"all_gather": 64,
                                           "all_reduce": 32}


@pytest.mark.parametrize("cap", [1, 31, 32, 33])
def test_sharded_seq_graph_fuse_is_exact_on_card(cuda, tmp_path, cap):
    """A capped graphed sharded loop at one NCCL rank stops at the cap
    whatever the chunk: status RUNNING, exactly ``cap`` pivots, the state
    of ``graph=False``."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        tab0, shard, opts = _sharded_seq_tab(cuda, group)
        outs = []
        for graph in (True, False):
            tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
            out, st, it = ps.solve_loop_sharded(tab, shard, opts, cap,
                                                graph=graph)
            assert st == int(pst.Status.RUNNING) and it == cap
            outs.append(out)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(outs[0], name), getattr(outs[1], name))


def _unlike(x):
    """Every element other than x's."""
    if x.dtype == torch.bool:
        return ~x
    if x.is_floating_point():
        return torch.where(torch.isnan(x), torch.ones_like(x),
                           torch.full_like(x, float("nan")))
    return x + 1


def _three_ways(tensors, reset, writes, ways):
    """``ways`` (name -> call), the first the plain chain, each after
    ``reset()``; the others with each name in ``writes`` first set to a
    value other than the first's (a skipped store shows). Every tensor of
    ``tensors()`` bit for bit with the first's."""
    want = None
    for name, fn in ways.items():
        reset()
        if want is not None:
            live = tensors()
            for key in writes:
                live[key].copy_(_unlike(want[key]))
        fn()
        torch.cuda.synchronize()
        got = {key: x.clone() for key, x in tensors().items()}
        if want is None:
            want = got
            continue
        for key, x in got.items():
            assert _bits_equal(x, want[key]), (name, key)


#: What the ranks' folds write and do not read.
FOLD_COLUMN_WRITES = ("h_d", "v_d", "h_b", "v_b", "active", "h", "minc",
                      "optimal", "ah")
K5_HEAD_WRITES = ("h_d", "v_d", "w_d", "h_b", "v_b", "w_b", "active", "h",
                  "minc", "optimal", "wh", "own", "hl", "ah")


@pytest.mark.parametrize("P", [1, 3, 8, 33])
@pytest.mark.parametrize("pair", ["f64", "mixed", "f32"])
def test_rank_fold_column_matches_plain_and_earlier_on_card(
        cuda, prior_libs, pair, P):
    """``seq_fold_column`` (every warp folding the ranks by shuffles)
    against ``seq_fold_column_plain`` and its form before (each block's
    thread 0 folding behind a barrier), from every edge state of
    tests/test_torch_rank_fold.py, the Bland flag off and on, on the
    slice of rank 0 and of rank P // 2 (its candidate winning, or
    another's: zeros), at M 1,000 x R 300: every scalar and the column
    bit for bit."""
    from simplex_tpu_torch.kernels import seq as ks
    from test_torch_rank_fold import EDGES, gathered

    T, Vd = {"f64": (torch.float64, torch.float64),
             "mixed": (torch.float32, torch.float64),
             "f32": (torch.float32, torch.float32)}[pair]
    M, R, max_iter = 1000, 300, 10
    eps = 1e-9 if Vd == torch.float64 else 1e-4
    Tt = _rand((M, R), 7 + P, dtype=np.float64).to(T).to(cuda)
    ah = torch.empty(M, dtype=T, device=cuda)
    for bland in (False, True):
        s = ks.seq_scalars(torch.tensor(1.5, dtype=Vd, device=cuda), bland,
                           T)
        s.iterations.fill_(3)
        init = {key: x.clone() for key, x in s.tensors().items()}

        def tensors():
            return {**s.tensors(), "ah": ah}

        def reset():
            for key, x in init.items():
                getattr(s, key).copy_(x)
            ah.fill_(float("nan"))

        for edge in EDGES:
            V, I = (torch.from_numpy(x).to(cuda)
                    for x in gathered(P, 2, edge, R))
            for offset in sorted({0, (P // 2) * R}):
                args = (Tt, V, I, ah, s, max_iter, eps, offset)
                _three_ways(tensors, reset, FOLD_COLUMN_WRITES, {
                    "plain": lambda: ks.seq_fold_column_plain(*args),
                    "kernel": lambda: ks.seq_fold_column(*args),
                    "before": lambda: prior_libs.fold_column(*args)})


@pytest.mark.parametrize("P", [1, 3, 8, 33])
@pytest.mark.parametrize("kv", [2, 5])
@pytest.mark.parametrize("t", [0, 5, 37])
def test_k5_head_matches_plain_and_earlier_on_card(cuda, prior_libs, t, kv,
                                                   P):
    """K5 with its head (``ah_fold_head``: every warp folding the ranks by
    shuffles, no barrier before the column's loads) against its plain
    chain (``sharded_fold_plain``, ``sharded_step_pre_plain``, then K5
    without its head) and against its form before (each block's thread 0
    folding behind a barrier), from every edge state of
    tests/test_torch_rank_fold.py, the Bland flag off and on, on the slice
    of rank 0 and of rank P // 2 (its candidate winning, or another's:
    zeros), at t = 0 and t > 0: every scalar and the column bit for
    bit."""
    from test_torch_rank_fold import EDGES, gathered

    M, R, L, big, eps = 256, 384, 64, 2 ** 30, 1e-4
    Tt = _rand((M, R), 11).to(cuda)
    C = _rand((L, R), 12).to(cuda)
    F = _rand((L, M), 13, -0.1, 0.1).to(cuda)
    col = torch.empty(M, device=cuda)
    for bland in (False, True):
        s = kb.sharded_scalars(torch.tensor(1.5, dtype=torch.float64,
                                            device=cuda), bland)
        s.iterations.fill_(3)
        init = {key: x.clone() for key, x in s.tensors().items()}

        def tensors():
            return {**s.tensors(), "ah": col}

        def reset():
            for key, x in init.items():
                getattr(s, key).copy_(x)
            col.fill_(float("nan"))

        for edge in EDGES:
            V, I = (torch.from_numpy(x).to(cuda)
                    for x in gathered(P, kv, edge, R))
            for offset in sorted({0, (P // 2) * R}):

                def plain():
                    kb.sharded_fold_plain(s, V, I)
                    kb.sharded_step_pre_plain(s, big, eps, offset, R)
                    kb.ah(Tt, F, C, s.hl, t, own=s.own, out=col)

                args = (Tt, F, C, t, s, V, I, big, eps, offset)
                _three_ways(tensors, reset, K5_HEAD_WRITES, {
                    "plain": plain,
                    "kernel": lambda: kb.ah_fold_head(*args, out=col),
                    "before": lambda: prior_libs.ah_fold_head(*args, col)})


@pytest.mark.parametrize("loop", ["sequential", "kernel"])
def test_sharded_loops_walk_unchanged_at_1024_on_card(cuda, monkeypatch,
                                                      tmp_path, loop):
    """``solve_sharded`` of random_1024_1024 at one NCCL rank with its
    loop graphed and with ``graph=False``: the sequential sharded loop
    (the default options) walks the recorded 1,871 + 64 pivots, the
    sharded kernel loop (the production options) as the single-card
    ``solve``; the two ways' results bit for bit."""
    import functools

    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    p = pst.read_random_problem(DATA / "benchmark_problems"
                                / "random_1024_1024.txt")
    opts = {} if loop == "sequential" else PROD
    name = ("solve_loop_sharded" if loop == "sequential"
            else "solve_loop_blocked_kernel_sharded")
    real = getattr(ps, name)
    res = {}
    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        for graph in (True, False):
            monkeypatch.setattr(ps, name, functools.partial(real,
                                                            graph=graph))
            res[graph] = pst.solve_sharded(p, group, device="cuda", **opts)
    g, e = res[True], res[False]
    walk = (g.iterations_phase1, g.iterations_phase2)
    if loop == "sequential":
        assert walk == (1871, 64)
    else:
        one = pst.solve(p, device="cuda", **opts)
        assert walk == (one.iterations_phase1, one.iterations_phase2)
    assert g.status == e.status == pst.Status.OPTIMAL
    assert walk == (e.iterations_phase1, e.iterations_phase2)
    assert repr(g.objective) == repr(e.objective)
    assert np.array_equal(g.x, e.x)


def test_sharded_seq_kernels_refuse_on_card(cuda):
    """A launch the kernels refuse raises through the C entry points: an
    empty shape, no ranks, a pair with no kernel, the sharded pass with
    the next step before, without its send buffers or on a cluster width
    it has no kernel for."""
    from simplex_tpu_torch.kernels import _build
    from simplex_tpu_torch.kernels import seq as ks

    lib = _build.load_library()
    M, R = 64, 96
    f64 = dict(dtype=torch.float64, device=cuda)
    Tt, ah, b = (torch.zeros((M, R), **f64), torch.zeros(M, **f64),
                 torch.zeros(M, **f64))
    V = torch.zeros((1, 2), **f64)
    I = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    s = ks.seq_scalars(torch.zeros((), **f64), False, torch.float64)
    step = ks.ctypes.byref(ks._seq_ptrs(s))
    stream = torch.cuda.current_stream().cuda_stream
    for shape in ((0, R, 1), (M, 0, 1), (M, R, 0)):
        m_, r_, p_ = shape
        err = lib.seq_fold_column_launch(
            Tt.data_ptr(), V.data_ptr(), I.data_ptr(), p_, m_, r_, 0,
            ah.data_ptr(), step, 10, 1e-9, 0, stream)
        with pytest.raises(RuntimeError, match="seq_fold_column: CUDA"):
            _build.check(lib, err, "seq_fold_column")
    err = lib.seq_fold_column_launch(
        Tt.data_ptr(), V.data_ptr(), I.data_ptr(), 1, M, R, 0,
        ah.data_ptr(), step, 10, 1e-9, 7, stream)
    with pytest.raises(RuntimeError, match="seq_fold_column: CUDA"):
        _build.check(lib, err, "seq_fold_column")
    costs, colk = torch.zeros(R, **f64), torch.zeros(R, **f64)
    base = torch.zeros(M, dtype=torch.int32, device=cuda)
    send_v = torch.zeros(2, **f64)
    send_i = torch.zeros(2, dtype=torch.int32, device=cuda)
    for sv, m_, nt in ((send_v.data_ptr(), 0, 256), (0, M, 256),
                       (send_v.data_ptr(), M, 384)):
        err = lib.seq_ratio_colk_sharded_launch(
            Tt.data_ptr(), costs.data_ptr(), b.data_ptr(), base.data_ptr(),
            ah.data_ptr(), colk.data_ptr(), ah.data_ptr(), m_, R, R, 1e-9,
            step, 10, 0, 50, 0, sv, send_i.data_ptr(), nt, 0, stream)
        with pytest.raises(RuntimeError,
                           match="seq_ratio_colk_sharded: CUDA"):
            _build.check(lib, err, "seq_ratio_colk_sharded")
    odd = ks.seq_scalars(torch.zeros((), device=cuda), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ks.seq_fold_column(Tt, V, I, ah, odd, 10, 1e-9, 0)


# ---------------------------------------------------------------------------
# The plain blocked loop's kernels (kernels.eta) and its window's graph.

#: (dtype pair, pricing rule) of the plain blocked loop's card checks.
ETA_CASES = [("f64", "dantzig"), ("f64", "devex"), ("mixed", "devex"),
             ("mixed", "bland"), ("f32", "dantzig"), ("f32", "devex")]


def _eta_phase1(dev, pair, rule, L=8, n=300, m=100, seed=5):
    """An eliminated phase-1 tableau on the card, its pre-elimination costs
    (None on an f64 tableau, which the loop never re-prices) and the plain
    blocked loop's options."""
    from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

    T, V = SEQ_PAIRS[pair]
    opts = pst.SolverOptions(dtype=T, vector_dtype=V, block_pivots=L,
                             pivot_rule=rule, bland_threshold=3,
                             use_pallas=False)
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    tab = build_phase1(torch.as_tensor(p.A, device=dev),
                       torch.as_tensor(p.b, device=dev), n, m, opts)
    costs0 = None if T == np.float64 else tab.costs.clone()
    return gaussian_eliminate(tab), costs0, opts


@pytest.mark.parametrize("pair,rule", ETA_CASES,
                         ids=[f"{p}-{r}" for p, r in ETA_CASES])
def test_eta_kernels_match_plain_on_card(cuda, pair, rule):
    """``eta_ratio`` and ``eta_colk`` against their plain versions on the
    same card tensors, pivot by pivot over five windows of 8 (the apply
    between, the same ``addmm_`` on both), from edge states drawn by the
    pivot's index: Bland on, the fuse reached (a skipped pivot), a NaN in
    b, no eligible row (the live column made negative for one pivot), a
    weight past the devex re-anchor's bound, and plain taken pivots.
    Every scalar, the column, C, F, b, the costs, base, the weights and
    the tableau bit for bit."""
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    from simplex_tpu_torch import solver

    tab, costs0, opts = _eta_phase1(cuda, pair, rule)
    loops = [solver.blocked_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                                 opts, costs0) for _ in range(2)]
    eps = float(opts.eps_resolved)
    policy = dict(bland_static=opts.pivot_rule_resolved == "bland",
                  threshold=opts.bland_threshold)
    L, cap = 8, 1000
    M = loops[0].Tt.shape[0]
    kinds = set()
    for win in range(5):
        for lp, kernel in zip(loops, (True, False)):
            (ks.seq_step_pre if kernel else kb.step_pre_plain)(lp.s, cap,
                                                              eps)
        for t in range(L):
            edge = (win * L + t) % 7
            saved = []
            for lp in loops:
                s = lp.s
                if edge == 1:
                    s.bland.fill_(True)
                elif edge == 2:
                    s.iterations.fill_(cap)
                elif edge == 3:
                    lp.b[(win * 37 + t * 11) % M] = float("nan")
                elif edge == 4:
                    h = int(s.h)
                    saved.append((h, lp.Tt[:, h].clone()))
                    lp.Tt[:, h] = -1e6
                elif edge == 5 and lp.w is not None:
                    lp.w[lp.r - 1] = 3e8
                kb.step_pre_plain(s, cap, eps)
            for lp, kernel in zip(loops, (True, False)):
                s = lp.s
                then_pre = t + 1 < L
                if kernel:
                    ke.eta_ratio(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t, eps,
                                 lp.ws)
                    ke.eta_colk(lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base,
                                lp.w, lp.ah, s, t, lp.r, eps, cap, lp.ws,
                                then_pre=then_pre, **policy)
                else:
                    ke.eta_ratio_plain(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t,
                                       eps)
                    ke.eta_colk_plain(lp.Tt, lp.C, lp.F, lp.costs, lp.b,
                                      lp.base, lp.w, lp.ah, s, t, lp.r, eps,
                                      cap, then_pre=then_pre, **policy)
            a, b = loops
            for name, x in a.s.tensors().items():
                assert _bits_equal(x, getattr(b.s, name)), (win, t, name)
            for name in ("Tt", "C", "F", "b", "costs", "base", "w", "ah"):
                x, y = getattr(a, name), getattr(b, name)
                assert x is None or _bits_equal(x, y), (win, t, name)
            kinds.add((bool(a.s.do), bool(a.s.unb), edge))
            for lp in loops:
                if edge == 4:
                    h, col = saved.pop(0)
                    lp.Tt[:, h] = col
                # Go on walking: running again, below the fuse, b and z
                # without a NaN.
                lp.s.status.fill_(int(pst.Status.RUNNING))
                lp.s.iterations.fill_(0)
                lp.b.nan_to_num_(nan=1.0)
                lp.s.z.nan_to_num_(nan=0.0)
        for lp in loops:
            lp.Tt.addmm_(lp.F.t(), lp.C, alpha=-1.0)
        assert _bits_equal(loops[0].Tt, loops[1].Tt), win
    assert (True, False, 0) in kinds and (False, True, 4) in kinds, kinds
    assert (False, False, 2) in kinds, kinds


@pytest.mark.parametrize("pair,rule", ETA_CASES,
                         ids=[f"{p}-{r}" for p, r in ETA_CASES])
def test_blocked_graph_matches_eager_on_card(cuda, monkeypatch, pair, rule):
    """``solve_loop_blocked`` as one CUDA graph a window against
    ``graph=False`` and against the old body on the card: graph and
    ``graph=False`` the same status and iterations and the final Tt, b,
    costs, z and base bit for bit (the window's ``addmm_`` and re-pricing
    captured are the same calls as eager), one capture, the same
    launches -- ``eta_ratio`` and ``eta_colk`` L a window and
    ``seq_step_pre`` once, 2L + 1 kernels a replay; against the old body
    with its live column and row formed as the kernels form them
    (``eta_live``) bit for bit as well, and
    against the old body as it ran (``@``) on an f64 tableau the same
    walk, status and basis, b within 1e-9."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    tab0, costs0, opts = _eta_phase1(cuda, pair, rule)
    captures = []
    real = solver.capture_blocked_window
    monkeypatch.setattr(solver, "capture_blocked_window",
                        lambda *a: captures.append(real(*a)) or captures[-1])
    runs = {}
    for graph in (False, True):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        ke.reset_launches()
        ks.reset_launches()
        out, st, it = solver.solve_loop_blocked(tab, opts, 5000, costs0,
                                                graph=graph)
        torch.cuda.synchronize()
        runs[graph] = (out, st, it, {**ke.LAUNCHES, **ks.LAUNCHES})
    (eo, est, eit, el), (go, gst, git, gl) = runs[False], runs[True]
    assert est == gst == int(pst.Status.OPTIMAL) and eit == git > 16
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name), getattr(eo, name)), name
    assert gl == el and len(captures) == 1
    windows = gl["seq_step_pre"]
    assert windows >= -(-git // 8)
    assert gl["eta_ratio"] == gl["eta_colk"] == 8 * windows
    per = captures[0][1].per_replay
    assert per["eta_ratio"] == per["eta_colk"] == 8
    assert per["seq_step_pre"] == 1 and sum(per.values()) == 17
    order = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
    oo, ost, oit = solver.solve_loop_blocked_reference(order, opts, 5000,
                                                       costs0, ke.eta_live)
    assert (ost, oit) == (gst, git)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name),
                           getattr(oo, name).to(getattr(go, name).dtype)), \
            name
    if pair == "f64":
        old = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        wo, wst, wit = solver.solve_loop_blocked_reference(old, opts, 5000,
                                                       costs0)
        assert (wst, wit) == (gst, git)
        assert torch.equal(wo.base.to(torch.int32), go.base)
        torch.testing.assert_close(go.b, wo.b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("cap", [1, 7, 8, 9, 20])
def test_blocked_graph_fuse_is_exact_on_card(cuda, cap):
    """A capped graphed plain blocked loop stops at the cap whatever the
    window: status RUNNING, exactly ``cap`` pivots, the state of
    ``graph=False`` bit for bit."""
    from simplex_tpu_torch import solver

    tab0, costs0, opts = _eta_phase1(cuda, "f64", "devex")
    outs = []
    for graph in (True, False):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        out, st, it = solver.solve_loop_blocked(tab, opts, cap, costs0,
                                                graph=graph)
        assert st == int(pst.Status.RUNNING) and it == cap
        outs.append(out)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(outs[0], name), getattr(outs[1], name))


def test_eta_kernels_refuse_on_card(cuda):
    """A launch the kernels refuse raises (an empty shape, t outside the
    window, a short workspace, an unknown pair, a stage of no rows or one
    whose two rounds do not fit, through the C entry points), a buffer of
    another shape raises in the wrapper, and a dtype pair with no kernel
    raises: no fallback."""
    from simplex_tpu_torch.kernels import _build
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    lib = _build.load_library()
    M, R, L = 256, 512, 8
    f64 = dict(dtype=torch.float64, device=cuda)
    Tt, C, F = (torch.rand(shape, **f64) for shape in ((M, R), (L, R),
                                                       (L, M)))
    b, ah = torch.rand(M, **f64), torch.zeros(M, **f64)
    ws = ke.eta_workspace(M, R, cuda)
    s = ks.seq_scalars(torch.zeros((), **f64), False, torch.float64)
    step = ks.ctypes.byref(ks._seq_ptrs(s))
    stream = torch.cuda.current_stream().cuda_stream
    plan = ke.eta_plan(M, R, L, 8)
    for m_, t, nbytes, pair, stage in (
            (0, 0, ws.numel(), 0, plan.stage_ratio),
            (M, L, ws.numel(), 0, plan.stage_ratio),
            (M, 0, 16, 0, plan.stage_ratio),
            (M, 0, ws.numel(), 9, plan.stage_ratio),
            (M, 0, ws.numel(), 0, 0),
            (M, 0, ws.numel(), 0, ke.ETA_SLAB_SMEM)):
        err = lib.eta_ratio_launch(
            Tt.data_ptr(), C.data_ptr(), F.data_ptr(), b.data_ptr(),
            ah.data_ptr(), m_, R, L, t, 1e-9, ws.data_ptr(), nbytes, step,
            pair, plan.rows, plan.cols, stage, stream)
        with pytest.raises(RuntimeError, match="eta_ratio: CUDA error"):
            _build.check(lib, err, "eta_ratio")
    costs = torch.rand(R, **f64)
    base = torch.zeros(M, dtype=torch.int32, device=cuda)
    err = lib.eta_colk_launch(
        Tt.data_ptr(), C.data_ptr(), F.data_ptr(), costs.data_ptr(),
        b.data_ptr(), base.data_ptr(), 0, ah.data_ptr(), M, R, L, R, L,
        1e-9, ws.data_ptr(), ws.numel(), step, 10, 0, 3, 1, 0,
        plan.rows, plan.cols, plan.stage_colk, stream)
    with pytest.raises(RuntimeError, match="eta_colk: CUDA error"):
        _build.check(lib, err, "eta_colk")
    with pytest.raises(ValueError, match="ah"):
        ke.eta_ratio(Tt, C, F, b, ah[:-1], s, 0, 1e-9, ws)
    odd = ks.seq_scalars(torch.zeros((), device=cuda), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ke.eta_ratio(Tt, C, F, b.float(), ah, odd, 0, 1e-9, ws)


#: Shapes whose rows of F and C start off 16-byte boundaries: f64 rows on
#: 8 bytes where M or R is odd, f32 rows on 4 bytes. ``eta_plan`` gives
#: the last two 256 columns a block of ``eta_colk``: at 2,047 x 30,001 in
#: one wave, with as many slab rows a round as fit; at 40 x 40,001 past one
#: wave, with 16.
ETA_ODD_SHAPES = [(1, 3), (37, 6143), (2047, 6143), (2047, 3), (2047, 30001),
                  (40, 40001)]


def _eta_random_state(dev, pair, M, R, L, seed):
    """A random state of the plain blocked loop's kernels on the card: Tt,
    the window's factors (every row < L filled), b > 0, the costs, devex
    weights in [1, 2), a basis and the scalars of a running pivot."""
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    T, V = (getattr(torch, np.dtype(x).name) for x in SEQ_PAIRS[pair])
    rng = np.random.default_rng(seed)

    def uni(shape, lo, hi, dt):
        return torch.from_numpy(rng.uniform(lo, hi, shape)).to(dev, dt)

    st = dict(Tt=uni((M, R), -1, 1, T), C=uni((L, R), -0.1, 0.1, T),
              F=uni((L, M), -0.1, 0.1, T), b=uni(M, 0, 1, V),
              costs=uni(R, -1, 1, V), w=uni(R, 1, 2, V),
              base=torch.from_numpy(rng.integers(0, R, M)).to(dev,
                                                              torch.int32),
              ah=torch.zeros(M, dtype=T, device=dev),
              ws=ke.eta_workspace(M, R, dev))
    st["s"] = ks.seq_scalars(torch.zeros((), dtype=V, device=dev), False, T)
    return st


@pytest.mark.parametrize("L", [128, 13])
@pytest.mark.parametrize("M,R", ETA_ODD_SHAPES,
                         ids=[f"{m}x{r}" for m, r in ETA_ODD_SHAPES])
@pytest.mark.parametrize("pair", sorted(SEQ_PAIRS))
def test_eta_kernels_unaligned_rows_on_card(cuda, pair, M, R, L):
    """``eta_ratio`` and ``eta_colk`` against their plain versions on
    shapes whose slab rows start off 16-byte boundaries (the copies'
    heads and tails element by element), at t = 0, 1 and L - 1, from edge
    states -- a taken pivot, a NaN in b, no eligible row, Bland on, the
    fuse, a weight past the re-anchor's bound, Bland static with the next
    step before -- under devex and Dantzig: every scalar, the column,
    C[t], F[t], b, the costs, base and the weights bit for bit."""
    from simplex_tpu_torch.kernels import eta as ke

    st0 = _eta_random_state(cuda, pair, M, R, L, 11 + M + L)
    for t in (0, 1, L - 1):
        for edge in range(7):
            devex = edge not in (1, 3)
            eps = 1e30 if edge == 2 else 1e-9
            policy = dict(bland_static=edge == 6, threshold=3,
                          then_pre=edge == 6)
            outs = []
            for kernel in (True, False):
                x = {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                     for n, v in st0.items() if n != "s"}
                s = type(st0["s"])(**{n: v.clone() for n, v in
                                      st0["s"].tensors().items()})
                s.h.fill_((R * 5) // 7)
                s.active.fill_(edge != 4)
                s.minc.fill_(-0.5)
                s.bland.fill_(edge == 3)
                if edge == 1:
                    x["b"][(M * 3) // 5] = float("nan")
                if edge == 5:
                    x["w"][R - 1] = 3e8
                w = x["w"] if devex else None
                args = (x["Tt"], x["C"], x["F"])
                if kernel:
                    ke.eta_ratio(*args, x["b"], x["ah"], s, t, eps, x["ws"])
                    ke.eta_colk(*args, x["costs"], x["b"], x["base"], w,
                                x["ah"], s, t, R - 1, eps, 1000, x["ws"],
                                **policy)
                else:
                    ke.eta_ratio_plain(*args, x["b"], x["ah"], s, t, eps)
                    ke.eta_colk_plain(*args, x["costs"], x["b"], x["base"],
                                      w, x["ah"], s, t, R - 1, eps, 1000,
                                      **policy)
                outs.append((x, s))
            (a, sa), (b, sb) = outs
            for name, v in sa.tensors().items():
                assert _bits_equal(v, getattr(sb, name)), (t, edge, name)
            for name in ("ah", "C", "F", "b", "costs", "base", "w"):
                assert _bits_equal(a[name], b[name]), (t, edge, name)


@pytest.mark.parametrize("L", [13, 128])
@pytest.mark.parametrize("pair", ["f64", "mixed"])
def test_blocked_graph_window_lengths_on_card(cuda, monkeypatch, pair, L):
    """The graphed plain blocked loop at a window that is not a multiple of
    8 and at L = 128: ``graph=False`` and the old body with its live
    column and row formed as the kernels form them walk the same pivots
    to the same state bit for bit, ``eta_ratio`` and ``eta_colk``
    launched L times a replay; on an f64 tableau the old body as it ran
    (``@``) walks the same pivots."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import eta as ke

    tab0, costs0, opts = _eta_phase1(cuda, pair, "devex", L=L)
    captures = []
    real = solver.capture_blocked_window
    monkeypatch.setattr(solver, "capture_blocked_window",
                        lambda *a: captures.append(real(*a)) or captures[-1])
    runs = {}
    for graph in (False, True):
        tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        runs[graph] = solver.solve_loop_blocked(tab, opts, 5000, costs0,
                                                graph=graph)
        torch.cuda.synchronize()
    (eo, est, eit), (go, gst, git) = runs[False], runs[True]
    assert est == gst == int(pst.Status.OPTIMAL) and eit == git
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name), getattr(eo, name)), name
    per = captures[0][1].per_replay
    assert per["eta_ratio"] == per["eta_colk"] == L
    order = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
    oo, ost, oit = solver.solve_loop_blocked_reference(order, opts, 5000,
                                                       costs0, ke.eta_live)
    assert (ost, oit) == (gst, git)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(go, name),
                           getattr(oo, name).to(getattr(go, name).dtype)), \
            name
    if pair == "f64":
        old = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
        _, wst, wit = solver.solve_loop_blocked_reference(old, opts, 5000,
                                                          costs0)
        assert (wst, wit) == (gst, git)


# ---------------------------------------------------------------------------
# The plain blocked sharded loop's kernels (kernels.eta's slice forms) and
# its window's graph with the collectives inside.

#: (dtype pair, pricing rule) of the sharded plain blocked loop's checks.
SLICE_CASES = [("f64", "dantzig"), ("f64", "devex"), ("mixed", "devex"),
               ("mixed", "bland"), ("f32", "devex")]


def _slice_sets(dev, pair, rule, P, L=8, n=300, m=100, seed=5):
    """P ``ShardedBlockedLoop``s over the slices of one eliminated phase-1
    tableau on ``dev`` (built at one slice, then cut), twice: the kernels
    run on one set, the plain versions on the other; and the options."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps
    from simplex_tpu_torch.tableau import gaussian_eliminate

    T, V = SEQ_PAIRS[pair]
    opts = pst.SolverOptions(dtype=T, vector_dtype=V, block_pivots=L,
                             pivot_rule=rule, bland_threshold=3,
                             use_pallas=False)
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
    whole = gaussian_eliminate(ps.build_phase1_sharded(
        torch.as_tensor(p.A), torch.as_tensor(p.b, device=dev), n, m,
        pg.Shard(None, 0, 1, R_pad), opts, M_pad, dev))
    sets = []
    for _ in range(2):
        sets.append([ps.sharded_blocked_loop(
            dataclasses.replace(sl, Tt=sl.Tt.clone()),
            pg.Shard(None, rank, P, R_pad // P), opts) for rank, sl in (
                (r, ps.shard_tableau(whole, r, P)) for r in range(P))])
    return sets, opts


def _slice_pivot(loops, t, opts, kernel, cap: int) -> None:
    """Pivot t of ``run_blocked_pivot_sharded`` on P slices in this
    process: the gathers and the sum of the columns in rank order by
    torch ops, each rank's kernels (``kernel`` true), their plain versions
    (false) or the kernels with the pass's form before its redesign
    (``kernel`` a ``PriorLibs``) between them."""
    from simplex_tpu_torch.kernels import eta as ke

    prior = kernel if isinstance(kernel, PriorLibs) else None
    eps = float(opts.eps_resolved)
    policy = dict(bland_static=opts.pivot_rule_resolved == "bland",
                  threshold=opts.bland_threshold)
    devex = loops[0].w is not None
    V = torch.stack([lp.send_v for lp in loops])
    I = torch.stack([lp.send_i for lp in loops])
    for lp in loops:
        lp.recv_v.copy_(V)
        lp.recv_i.copy_(I)
        args = (lp.Tt, lp.C, lp.F, lp.recv_v, lp.recv_i, lp.recv_w, lp.ah,
                lp.w, lp.wh, lp.s, t, cap, eps, lp.shard.offset)
        if kernel:
            ke.eta_fold_column(*args)
        else:
            ke.eta_fold_column_plain(*args)
    total = loops[0].ah.clone()
    for lp in loops[1:]:
        total += lp.ah
    for lp in loops:
        lp.ah.copy_(total)
        args = (lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base, lp.w, lp.ah,
                lp.s, t, lp.r_loc, eps, cap)
        out = dict(offset=lp.shard.offset, wh=lp.wh, send_v=lp.send_v,
                   send_i=lp.send_i, send_w=lp.send_w)
        if prior:
            ke.eta_ratio_summed(lp.b, lp.ah, lp.s, eps)
            prior.eta_colk_slice(lp, t, eps, cap, **policy)
        elif kernel:
            ke.eta_ratio_summed(lp.b, lp.ah, lp.s, eps)
            ke.eta_colk_slice(*args, lp.ws, **out, **policy)
        else:
            ke.eta_ratio_summed_plain(lp.b, lp.ah, lp.s, eps)
            ke.eta_colk_slice_plain(*args, *out.values(), **policy)
    if devex:
        W = torch.stack([lp.send_w for lp in loops])
        for lp in loops:
            lp.recv_w.copy_(W)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair,rule", SLICE_CASES,
                         ids=[f"{p}-{r}" for p, r in SLICE_CASES])
def test_slice_kernels_match_plain_on_card(cuda, pair, rule, P):
    """``eta_fold_column``, ``eta_ratio_summed`` and ``eta_colk_slice``
    against their plain versions on P slices of one card's phase-1
    tableau, pivot by pivot over four windows of 8 (the apply between),
    from edge states drawn by the pivot's index: Bland on, the fuse (a
    skipped pivot), a NaN in b, no eligible row (the entering column made
    negative on its owner), a weight past the devex re-anchor's bound on
    the last rank only, a tie of the smallest cost across the first and
    last slices, a NaN cost on the last slice (the fold's NaN key), under
    devex a NaN weight at an eligible column of the last slice (a NaN key
    and a NaN largest weight) alone and beside a weight past 1e8 on the
    first slice (no re-anchor), and plain taken pivots. Every scalar,
    slice, factor, vector, weight and send buffer bit for bit."""
    _slice_walk(cuda, pair, rule, P, False)


#: (pair, rule, R) of the window sweep: 64 columns a block of eta_colk at
#: R 6,144 and 128 at 12,288, so that the slab passes 48 KB less the
#: static arrays' reserve at t = 90-91 (f64, 64), 46 (f64, 128) and 91-92
#: (f32, 128) of a window of 128.
WINDOW_SWEEP = [("f64", "dantzig", 6144), ("f64", "devex", 12288),
                ("f32", "devex", 12288)]


@pytest.mark.parametrize("pair,rule,R", WINDOW_SWEEP,
                         ids=[f"{p}-{r}-{n}" for p, r, n in WINDOW_SWEEP])
def test_eta_passes_launch_at_every_t_of_a_window_on_card(cuda, pair, rule,
                                                          R):
    """``eta_colk`` and ``eta_colk_slice`` (one slice) at every t of a
    window of 128 against their plain versions, the slab's shared memory
    growing with t past the default 48 KB limit, which holds the static
    arrays too: every launch taken and every state bit for bit after each
    pivot."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    L, cap, m = 128, 10 ** 6, 100
    n = R - 2 * m
    (a_set, b_set), opts = _slice_sets(cuda, pair, rule, 1, L=L, n=n, m=m)
    M = a_set[0].Tt.shape[0]
    T = a_set[0].Tt
    assert T.shape[1] == R
    assert ke.eta_plan(M, R, L, T.element_size()).cols == {6144: 64,
                                                            12288: 128}[R]
    tab, costs0, _ = _eta_phase1(cuda, pair, rule, L=L, n=n, m=m)
    loops = [solver.blocked_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                                 opts, costs0) for _ in range(2)]
    eps = float(opts.eps_resolved)
    policy = dict(bland_static=False, threshold=opts.bland_threshold)
    ks.seq_step_pre(loops[0].s, cap, eps)
    kb.step_pre_plain(loops[1].s, cap, eps)
    for t in range(L):
        _slice_pivot(a_set, t, opts, True, cap)
        _slice_pivot(b_set, t, opts, False, cap)
        (a,), (b,) = a_set, b_set
        for name, x in a.s.tensors().items():
            assert _bits_equal(x, getattr(b.s, name)), (t, name)
        for name in ("Tt", "C", "F", "b", "costs", "base", "w", "ah", "wh",
                     "send_v", "send_i", "send_w"):
            x, y = getattr(a, name), getattr(b, name)
            assert x is None or _bits_equal(x, y), (t, name)
        for lp, kernel in zip(loops, (True, False)):
            s = lp.s
            if kernel:
                ke.eta_ratio(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t, eps,
                             lp.ws)
                ke.eta_colk(lp.Tt, lp.C, lp.F, lp.costs, lp.b, lp.base,
                            lp.w, lp.ah, s, t, lp.r, eps, cap, lp.ws,
                            then_pre=t + 1 < L, **policy)
            else:
                ke.eta_ratio_plain(lp.Tt, lp.C, lp.F, lp.b, lp.ah, s, t,
                                   eps)
                ke.eta_colk_plain(lp.Tt, lp.C, lp.F, lp.costs, lp.b,
                                  lp.base, lp.w, lp.ah, s, t, lp.r, eps, cap,
                                  then_pre=t + 1 < L, **policy)
        for name, x in loops[0].s.tensors().items():
            assert _bits_equal(x, getattr(loops[1].s, name)), (t, name)
        for name in ("C", "F", "b", "costs", "base", "w", "ah"):
            x, y = getattr(loops[0], name), getattr(loops[1], name)
            assert x is None or _bits_equal(x, y), (t, name)
    assert int(a_set[0].s.iterations) > 0


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair,rule", SLICE_CASES,
                         ids=[f"{p}-{r}" for p, r in SLICE_CASES])
def test_slice_pass_matches_its_earlier_form_on_card(cuda, prior_libs, pair,
                                                     rule, P):
    """The shipped ``eta_colk_slice`` (its candidates carrying the weights
    at them through the folds) against its form before
    (``tools/eta_variants.cu``'s ``colk_prior``: the weights read back
    after the fold) along the same windows and edge states, t = 0 .. L -
    1, the head the shipped kernels on both: every scalar, slice, factor,
    vector, weight and send buffer bit for bit."""
    _slice_walk(cuda, pair, rule, P, prior_libs)


def _slice_walk(dev, pair, rule, P, other) -> None:
    """The kernels on one set of P slices, ``other`` (False: the plain
    versions; a ``PriorLibs``: the pass's earlier form) on the other, four
    windows of 8 from edge states; every state bit for bit after each
    pivot."""
    from simplex_tpu_torch.kernels import eta as ke

    (a_set, b_set), opts = _slice_sets(dev, pair, rule, P)
    eps = float(opts.eps_resolved)
    L, cap = 8, 1000
    kinds = set()
    for win in range(4):
        for t in range(L):
            edge = (win * L + t) % 10
            saved, fixes = [], []
            for loops in (a_set, b_set):
                first, last = loops[0], loops[-1]
                for lp in loops:
                    lp.s.bland.fill_(edge == 1)
                    lp.s.iterations.fill_(cap if edge == 2 else 3)
                if edge == 3:
                    rows = torch.nonzero(first.b > 0).view(-1)
                    for lp in loops:
                        lp.b[rows[(win * 7 + t) % rows.numel()]] = \
                            float("nan")
                elif edge == 4:
                    h = int(ke.slice_fold(
                        torch.stack([lp.send_v for lp in loops]),
                        torch.stack([lp.send_i for lp in loops]),
                        first.recv_w)[0])
                    for lp in loops:
                        loc = h - lp.shard.offset
                        if 0 <= loc < lp.shard.R_loc:
                            saved.append((lp, loc, lp.Tt[:, loc].clone()))
                            lp.Tt[:, loc] = -1e6
                elif edge == 5 and last.w is not None:
                    last.w[0] = 3e8
                elif edge == 6:
                    v = torch.minimum(first.costs.min(), last.costs.min()) - 1
                    first.costs[0] = v
                    last.costs[0 if P > 1 else 1] = v
                    for lp in (first, last):
                        lp.pack(eps)
                elif edge == 7 or (edge in (8, 9) and last.w is not None):
                    live = last.costs[:last.r_loc]
                    cols = torch.nonzero(live <= -eps).view(-1)
                    j = int(cols[(win * 7 + t) % cols.numel()]) \
                        if cols.numel() else 0
                    put = [(last, "costs" if edge == 7 else "w", j,
                            float("nan"))]
                    if edge == 9:
                        put.append((first, "w", 0 if P > 1 or j else 1, 3e8))
                    for lp, name, k, v in put:
                        x = getattr(lp, name)
                        fixes.append((loops, lp, x, k, x[k].clone()))
                        x[k] = v
                        lp.pack(eps)
                    if first.w is not None:
                        W = torch.stack([lp.send_w for lp in loops])
                        for lp in loops:
                            lp.recv_w.copy_(W)
            _slice_pivot(a_set, t, opts, True, cap)
            _slice_pivot(b_set, t, opts, other, cap)
            for rank, (a, b) in enumerate(zip(a_set, b_set)):
                for name, x in a.s.tensors().items():
                    assert _bits_equal(x, getattr(b.s, name)), (win, t, rank,
                                                                name)
                for name in ("Tt", "C", "F", "b", "costs", "base", "w", "ah",
                             "wh", "send_v", "send_i", "send_w"):
                    x, y = getattr(a, name), getattr(b, name)
                    assert x is None or _bits_equal(x, y), (win, t, rank,
                                                            name)
            kinds.add((bool(a_set[0].s.do), bool(a_set[0].s.unb), edge))
            for lp, loc, col in saved:
                lp.Tt[:, loc] = col
            for loops, lp, x, k, v in fixes:     # the NaN and 3e8 undone
                x[k] = v
                lp.pack(eps)
                if lp.w is not None:
                    W = torch.stack([q.send_w for q in loops])
                    for q in loops:
                        q.recv_w.copy_(W)
            for loops in (a_set, b_set):
                for lp in loops:
                    lp.s.status.fill_(int(pst.Status.RUNNING))
                    lp.b.nan_to_num_(nan=1.0)
                    lp.s.z.nan_to_num_(nan=0.0)
        for loops in (a_set, b_set):
            for lp in loops:
                lp.Tt.addmm_(lp.F.t(), lp.C, alpha=-1.0)
    assert (True, False, 0) in kinds and (False, False, 2) in kinds, kinds
    assert (False, True, 4) in kinds, kinds


#: Slices whose rows start off 16-byte boundaries, at a global offset:
#: (M, R_loc).
SLICE_ODD_SHAPES = [(37, 6143), (2047, 3), (40, 40001)]


@pytest.mark.parametrize("M,R", SLICE_ODD_SHAPES,
                         ids=[f"{m}x{r}" for m, r in SLICE_ODD_SHAPES])
@pytest.mark.parametrize("pair", sorted(SEQ_PAIRS))
def test_slice_kernels_unaligned_on_card(cuda, pair, M, R):
    """The three slice kernels against their plain versions on a random
    slice at global offset 1,000 whose rows start off 16-byte boundaries,
    at t = 0, 1 and L - 1 (L = 13), with two ranks' gathered candidates
    whose fold lands on this slice or on the other, under devex (with and
    without the re-anchor) and Dantzig; the fold picking this slice's
    Bland candidate (its own send_i[1]) and, on a re-anchor, its candidate
    on weights of 1 (send_i[2]) apart from its main one; a pick on the
    slice's last column; and a NaN on the other rank -- its Dantzig cost,
    its largest weight beside this rank's past 1e8 (no re-anchor), its
    devex key -- which leaves the pick to this rank: every scalar, the
    column, C[t], F[t], b, the costs, base, the weights and the send
    buffers bit for bit."""
    from simplex_tpu_torch.kernels import eta as ke

    L, off = 13, 1000
    st0 = _eta_random_state(cuda, pair, M, R, L, 29 + M)
    f64 = dict(dtype=torch.float64, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    V = st0["costs"].dtype
    for t in (0, 1, L - 1):
        for edge in range(10):
            devex = edge not in (3, 7)
            mine = edge != 1
            h = off + (R * 5) // 7 if mine else off + R + 3
            if edge == 6:                        # the slice's last column
                h = off + R - 1
            key = 4.0 if mine else 9.0
            Vg = torch.tensor([[-0.5, -0.25, 1.5, 1.0, key, -0.5, key],
                               [-0.4, -0.2, 1.0, 1.0, 2.0, -0.4, 2.0]], **f64)
            Ig = torch.tensor([[h, off + 1, h], [off + R + 3, off + R + 5,
                                                 off + R + 3]], **i32)
            if mine:
                Ig[:, 0] = Ig[:, 2] = torch.tensor([h, off + R + 3])
            if edge == 5:                        # on weights of 1: another
                Ig[0, 2] = off + R // 3
            Wg = torch.tensor([1.0, 3e8 if edge in (2, 5) else 5.0], **f64)
            if edge == 7:                        # NaN: rank 0's main one
                Vg[1, 0] = float("nan")
            elif edge == 8:
                Wg = torch.tensor([3e8, float("nan")], **f64)
            elif edge == 9:
                Vg[1, 4] = Vg[1, 6] = float("nan")
            want = {4: off + 1, 5: off + R // 3}.get(edge, h)
            if not devex:
                Vg, Ig, Wg = Vg[:, :2].contiguous(), Ig[:, :2].contiguous(), \
                    None
            outs = []
            for kernel in (True, False):
                x = {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                     for n, v in st0.items() if n != "s"}
                s = type(st0["s"])(**{n: v.clone() for n, v in
                                      st0["s"].tensors().items()})
                s.bland.fill_(edge == 4)
                x["base"][(M * 2) // 3] = off + R // 2
                kv, ki = ke.SLICE_PACK[devex]
                w = x["w"] if devex else None
                wh = torch.ones((), dtype=V, device=cuda) if devex else None
                send = (torch.zeros(kv, **f64), torch.zeros(ki, **i32),
                        torch.zeros((), **f64) if devex else None)
                args = (x["Tt"], x["C"], x["F"])
                fold = (Vg, Ig, Wg, x["ah"], w, wh, s, t, 1000, 1e-9, off)
                if kernel:
                    ke.eta_fold_column(*args, *fold)
                else:
                    ke.eta_fold_column_plain(*args, *fold)
                if not mine:
                    x["ah"].copy_(x["Tt"][:, 0])
                if kernel:
                    ke.eta_ratio_summed(x["b"], x["ah"], s, 1e-9)
                    ke.eta_colk_slice(*args, x["costs"], x["b"], x["base"],
                                      w, x["ah"], s, t, R - 1, 1e-9, 1000,
                                      x["ws"], offset=off, wh=wh,
                                      send_v=send[0], send_i=send[1],
                                      send_w=send[2], bland_static=False,
                                      threshold=3)
                else:
                    ke.eta_ratio_summed_plain(x["b"], x["ah"], s, 1e-9)
                    ke.eta_colk_slice_plain(*args, x["costs"], x["b"],
                                            x["base"], w, x["ah"], s, t,
                                            R - 1, 1e-9, 1000, off, wh,
                                            *send, False, 3)
                outs.append((x, s, wh, send))
            (a, sa, wa, na), (b, sb, wb, nb) = outs
            assert int(sa.h) == want, (t, edge)
            assert bool(sa.do) or edge >= 4, (t, edge)
            for name, v in sa.tensors().items():
                assert _bits_equal(v, getattr(sb, name)), (t, edge, name)
            for name in ("ah", "C", "F", "b", "costs", "base", "w"):
                assert _bits_equal(a[name], b[name]), (t, edge, name)
            for u, v in [(wa, wb), *zip(na, nb)]:
                assert u is None or _bits_equal(u, v), (t, edge)


#: Rows of the summed column past one pass of eta_ratio_summed's cluster
#: (its threads times SUMMED_PER: 8,192 rows at 8 x 256, 16,384 at 16 x
#: 256): the north star's 10,112 and 20,000.
RATIO_PASS_ROWS = [10112, 20000]


@pytest.mark.parametrize("M", RATIO_PASS_ROWS)
@pytest.mark.parametrize("pair", sorted(SEQ_PAIRS))
def test_ratio_summed_past_one_pass_on_card(cuda, pair, M):
    """``eta_ratio_summed`` against its plain version on a summed column
    longer than one pass of its cluster: a taken pivot, the smallest ratio
    tied on a row of the first pass and one of the last, a NaN in b on
    the last pass, no eligible row, and the fuse: every scalar bit for
    bit."""
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    T, V = (getattr(torch, np.dtype(x).name) for x in SEQ_PAIRS[pair])
    rng = np.random.default_rng(M)
    ah0 = torch.from_numpy(rng.uniform(-1, 1, M)).to(cuda, T)
    b0 = torch.from_numpy(rng.uniform(0, 1, M)).to(cuda, V)
    for edge in range(5):
        ah, b = ah0.clone(), b0.clone()
        if edge == 1:                            # a tie across the passes
            for j in (5, M - 3):
                ah[j], b[j] = 1.0, 1e-6
        elif edge == 2:
            b[M - 7] = float("nan")
        elif edge == 3:
            ah.copy_(-ah.abs())
        runs = []
        for kernel in (True, False):
            s = ks.seq_scalars(torch.zeros((), dtype=V, device=cuda), False,
                               T)
            s.active.fill_(edge != 4)
            s.minc.fill_(-0.5)
            s.h.fill_(3)
            if kernel:
                ke.eta_ratio_summed(b, ah, s, 1e-9)
            else:
                ke.eta_ratio_summed_plain(b, ah, s, 1e-9)
            runs.append(s)
        torch.cuda.synchronize()
        if edge == 1:
            assert int(runs[0].k) == 5
        for name, v in runs[0].tensors().items():
            assert _bits_equal(v, getattr(runs[1], name)), (edge, name)


def _slice_tab(dev, group, pair, rule, L, n=300, m=100, seed=5):
    """One NCCL rank's phase-1 slice (the whole tableau), its
    pre-elimination costs and the plain blocked loop's options."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    T, V = SEQ_PAIRS[pair]
    opts = pst.SolverOptions(dtype=T, vector_dtype=V, block_pivots=L,
                             pivot_rule=rule, bland_threshold=3,
                             use_pallas=False,
                             eps=1e-9 if T == np.float64 else 1e-5)
    p = pst.generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, 1, opts)
    shard = pg.Shard.of(group, R_pad)
    tab = ps.build_phase1_sharded(torch.as_tensor(p.A),
                                  torch.as_tensor(p.b, device=dev), n, m,
                                  shard, opts, M_pad, dev)
    costs0 = tab.costs
    return ps.gaussian_eliminate_sharded(tab, shard), costs0, shard, opts


#: (pair, rule, L) of the graphed sharded plain blocked loop's checks.
SLICE_LOOPS = [("f64", "dantzig", 8), ("f64", "devex", 13),
               ("f64", "dantzig", 128), ("mixed", "devex", 8),
               ("mixed", "bland", 13), ("f32", "devex", 8)]


@pytest.mark.parametrize("pair,rule,L", SLICE_LOOPS,
                         ids=[f"{p}-{r}-L{n}" for p, r, n in SLICE_LOOPS])
def test_blocked_sharded_graph_matches_eager_on_card(cuda, monkeypatch,
                                                     tmp_path, pair, rule, L):
    """``solve_loop_blocked_sharded`` at one NCCL rank as one CUDA graph a
    window, its collectives inside, against ``graph=False``, against the
    single-card ``solver.solve_loop_blocked`` and against the old body
    with its live column and row formed as the kernels form them
    (``eta_live``): the same status and iterations and the final slice,
    b, costs, z and base bit for bit; graph and ``graph=False`` the same
    launches and collectives -- a pivot ``eta_fold_column``,
    ``eta_ratio_summed`` and ``eta_colk_slice``, 2 ``all_gather``s (3 under
    devex) and 1 ``all_reduce``, on the f32 tableau 1 of each more a
    window -- one capture, a replay adding the graph's."""
    from simplex_tpu_torch import solver
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    captures = []
    real = ps.capture_blocked_window_sharded
    monkeypatch.setattr(ps, "capture_blocked_window_sharded",
                        lambda *a: captures.append(real(*a)) or captures[-1])
    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        tab0, costs0, shard, opts = _slice_tab(cuda, group, pair, rule, L)
        runs = {}
        for graph in (False, True):
            tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
            ke.reset_launches()
            pg.reset_counts()
            out, st, it = ps.solve_loop_blocked_sharded(
                tab, shard, opts, 5000, costs0, graph=graph)
            torch.cuda.synchronize()
            runs[graph] = (out, st, it, dict(ke.SLICE_LAUNCHES),
                           dict(pg.COUNTS))
        ref = ps.solve_loop_blocked_sharded_reference(
            dataclasses.replace(tab0, Tt=tab0.Tt.clone()), shard, opts,
            5000, costs0, ke.eta_live)
    single = solver.solve_loop_blocked(
        dataclasses.replace(tab0, Tt=tab0.Tt.clone()), opts, 5000, costs0)
    (eo, est, eit, el, ec), (go, gst, git, gl, gc) = runs[False], runs[True]
    assert est == gst == int(pst.Status.OPTIMAL) and eit == git > L
    for other in (ref, single):
        assert other[1:] == (gst, git)
    for name in ("Tt", "b", "costs", "z", "base"):
        g = getattr(go, name)
        for other in (eo, ref[0], single[0]):
            assert _bits_equal(g, getattr(other, name).to(g.dtype)), name
    assert gl == el and gc == ec and len(captures) == 1
    windows = gl["eta_fold_column"] // L
    assert windows == -(-git // L) or windows == -(-git // L) + 1
    devex = int(rule == "devex")
    reprice = int(costs0 is not None and pair != "f64")
    assert gc == {"all_gather": windows * ((2 + devex) * L + reprice),
                  "all_reduce": windows * (L + reprice)}, gc
    per = captures[0][1].per_replay
    assert per == {"eta_fold_column": L, "eta_ratio_summed": L,
                   "eta_colk_slice": L}, per
    assert dict(captures[0][2].counts) == {
        "all_gather": (2 + devex) * L + reprice, "all_reduce": L + reprice}


def test_blocked_sharded_resumable_on_card(cuda, tmp_path):
    """``solve_resumable_sharded`` with the f64 blocked options (L = 8,
    devex) at one NCCL rank, in windows of 25 pivots -- each window a call
    of the plain blocked sharded loop, one CUDA graph a window -- walks as
    the single-card ``solve_resumable`` in the same windows to its
    objective within 1e-12 and within 1e-9 of ``solve_sharded``; the slice
    kernels launched, the file removed."""
    from simplex_tpu_torch.checkpoint import (solve_resumable,
                                              solve_resumable_sharded)
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    problem = pst.generate_random_problem(300, 100, 5, 1, 100)
    opts = pst.SolverOptions(block_pivots=8, pivot_rule="devex")
    path = tmp_path / "run.npz"
    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        ke.reset_launches()
        got = solve_resumable_sharded(problem, group, str(path), 25, opts,
                                      device="cuda")
        launched = dict(ke.SLICE_LAUNCHES)
        whole = ps.solve_sharded(problem, group, opts, device="cuda")
    want = solve_resumable(problem, str(tmp_path / "one.npz"), 25, opts,
                           device="cuda")
    walk = (got.iterations_phase1, got.iterations_phase2)
    assert got.status == want.status == whole.status == pst.Status.OPTIMAL
    assert walk == (want.iterations_phase1, want.iterations_phase2)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.objective == pytest.approx(whole.objective, rel=1e-9)
    assert min(launched.values()) >= sum(walk) and not path.exists()


@pytest.mark.parametrize("cap", [1, 7, 8, 9, 20])
def test_blocked_sharded_graph_fuse_is_exact_on_card(cuda, tmp_path, cap):
    """A capped graphed plain blocked sharded loop at one NCCL rank stops at
    the cap whatever the window: status RUNNING, exactly ``cap`` pivots,
    the state of ``graph=False`` bit for bit."""
    from simplex_tpu_torch.parallel import group as pg
    from simplex_tpu_torch.parallel import sharded as ps

    with pg.world(0, 1, "nccl", str(tmp_path)) as group:
        tab0, costs0, shard, opts = _slice_tab(cuda, group, "f64", "devex",
                                               8)
        outs = []
        for graph in (True, False):
            tab = dataclasses.replace(tab0, Tt=tab0.Tt.clone())
            out, st, it = ps.solve_loop_blocked_sharded(
                tab, shard, opts, cap, costs0, graph=graph)
            assert st == int(pst.Status.RUNNING) and it == cap
            outs.append(out)
    for name in ("Tt", "b", "costs", "z", "base"):
        assert _bits_equal(getattr(outs[0], name), getattr(outs[1], name))


def test_slice_kernels_refuse_on_card(cuda):
    """A launch the slice kernels refuse raises through the C entry
    points: an empty shape, no ranks or more than a warp folds, a fold of
    another width, a devex fold without its weights, t outside the window;
    the ratio test on no rows; the
    slice's pass without its send buffers or, under devex, without the
    weight at h; and a dtype pair with no kernel raises in the wrapper: no
    fallback."""
    from simplex_tpu_torch.kernels import _build
    from simplex_tpu_torch.kernels import eta as ke
    from simplex_tpu_torch.kernels import seq as ks

    lib = _build.load_library()
    M, R, L = 256, 512, 8
    f64 = dict(dtype=torch.float64, device=cuda)
    Tt, C, F = (torch.rand(shape, **f64) for shape in ((M, R), (L, R),
                                                       (L, M)))
    b, ah, costs, w = (torch.rand(M, **f64), torch.zeros(M, **f64),
                       torch.rand(R, **f64), torch.ones(R, **f64))
    base = torch.zeros(M, dtype=torch.int32, device=cuda)
    wh = torch.ones((), **f64)
    V, W = torch.zeros((1, 7), **f64), torch.zeros(1, **f64)
    I = torch.zeros((1, 3), dtype=torch.int32, device=cuda)
    ws = ke.eta_workspace(M, R, cuda)
    s = ks.seq_scalars(torch.zeros((), **f64), False, torch.float64)
    step = ks.ctypes.byref(ks._seq_ptrs(s))
    stream = torch.cuda.current_stream().cuda_stream
    plan = ke.eta_plan(M, R, L, 8)
    p = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    for m_, t, P, kv, Wp in ((0, 0, 1, 7, W), (M, L, 1, 7, W),
                             (M, 0, 0, 7, W), (M, 0, 33, 7, W),
                             (M, 0, 1, 5, W), (M, 0, 1, 7, None)):
        err = lib.eta_fold_column_launch(
            p(Tt), p(C), p(F), p(ah), m_, R, L, t, 0, p(V), p(I), p(Wp), P,
            kv, p(w), p(wh), step, 10, 1e-9, 0, plan.rows, plan.stage_ratio,
            stream)
        with pytest.raises(RuntimeError, match="eta_fold_column: CUDA"):
            _build.check(lib, err, "eta_fold_column")
    err = lib.eta_ratio_summed_launch(p(b), p(ah), 0, 1e-9, step, 0, stream)
    with pytest.raises(RuntimeError, match="eta_ratio_summed: CUDA"):
        _build.check(lib, err, "eta_ratio_summed")
    send_v, send_w = torch.zeros(7, **f64), torch.zeros(1, **f64)
    send_i = torch.zeros(3, dtype=torch.int32, device=cuda)
    for sv, whp in ((None, wh), (send_v, None)):
        err = lib.eta_colk_slice_launch(
            p(Tt), p(C), p(F), p(costs), p(b), p(base), p(w), p(ah), M, R, L,
            R, 0, 1e-9, p(ws), ws.numel(), step, 10, 0, 3, 0, plan.rows,
            plan.cols, plan.stage_colk, 0, p(whp), p(sv), p(send_i),
            p(send_w), stream)
        with pytest.raises(RuntimeError, match="eta_colk_slice: CUDA"):
            _build.check(lib, err, "eta_colk_slice")
    odd = ks.seq_scalars(torch.zeros((), device=cuda), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ke.eta_ratio_summed(b.float(), ah, odd, 1e-9)
