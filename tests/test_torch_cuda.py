"""The CUDA kernels on the card, at small shapes: each against its plain
PyTorch version on the same tensors, and a solve on the card against
the same solve on the CPU. Marked ``gpu``; skipped where torch.cuda is
not available. The card's own check at full shapes is chip_smoke.py.

This file imports neither JAX nor tests/conftest.py, so on a machine
with a card and no JAX it runs as::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

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
    """The production solve on the card: K1 and K2 launched, each run of
    the kernel loop allocating one K1 workspace and handing it to every
    K1 call of that run; status equal to the CPU's, the objective
    certified and within 1e-9."""
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
        ws = args[7] if len(args) > 7 else kw.get("ws")
        calls.append(ws is not None and ws.data_ptr() == allocs[-1])
        return kb.ah_ratio(*args, **kw)

    monkeypatch.setattr(solver, "solve_loop_blocked_kernel", loop)
    monkeypatch.setattr(solver, "ah_ratio_workspace", workspace)
    monkeypatch.setattr(solver, "ah_ratio", k1)
    p = pst.generate_random_problem(128, 64, 2, 1, 100)
    kb.reset_launches()
    got = pst.solve(p, device="cuda", **PROD)
    assert kb.LAUNCHES["ah_ratio"] > 0 and kb.LAUNCHES["colk_costs"] > 0
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


@pytest.mark.parametrize("dtype,R", [(torch.float64, 64), (torch.float64, 63),
                                     (torch.float32, 64), (torch.float32, 63)])
def test_batch_rank1_matches_plain_on_card(cuda, dtype, R):
    """The batched fallback's rank-1 update against its plain version
    (the single-LP loop's ``addr_`` on each live lane), bit for bit, on
    the vector tile (rows of whole 16-byte vectors) and the scalar one; a
    lane whose flag is clear keeps every bit, a -0.0 included."""
    g = torch.Generator().manual_seed(R)
    B, M = 5, 37
    T3 = (torch.rand((B, M, R), generator=g, dtype=torch.float64) * 200
          - 100).to(dtype).to(cuda)
    T3[2, 0, 0] = -0.0
    factor = (torch.rand((B, M), generator=g, dtype=torch.float64) * 2
              - 1).to(dtype).to(cuda)
    colk = (torch.rand((B, R), generator=g, dtype=torch.float64) * 200
            - 100).to(dtype).to(cuda)
    do = torch.tensor([True, True, False, True, True], device=cuda)
    want = T3.clone()
    kp.batch_rank1_plain(want, factor, colk, do)
    kp.reset_launches()
    kp.batch_rank1(T3, factor, colk, do)
    torch.cuda.synchronize()
    assert kp.LAUNCHES["batch_rank1"] == 1
    assert torch.equal(T3, want)
    assert torch.signbit(T3[2, 0, 0])


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
