"""The plain PyTorch versions of K1-K4 (simplex_tpu_torch.kernels.blocked,
taken for CPU tensors) against the JAX package's Pallas kernels run in
interpret mode, on the same seeded numpy inputs.

Tolerances and why:

* integer outputs (k, unbounded, h_d, h_b, base) must be equal. The
  inputs keep eligible ratios and candidate scores more than 1e-6
  relative apart (asserted), so the JAX fold's f32 compare and the
  port's f64 compare pick the same index;
* f32 outputs (a_h, the pivot row C[t], the eta row, Tt after the apply)
  to 1e-5 * (1 + |x|): the eta corrections sum up to L products in
  another order;
* f64 vectors: the port against the exact f64 formula on its own f32
  operands to 1e-12 relative of the operand scale; the port against
  the JAX pairs to 1e-7 relative, plus the exact propagation of the f32
  pivot-row difference where the vector is updated with it
  (costs -= u * colk). Interpret mode runs the JAX double-f32 pair
  arithmetic under XLA:CPU, which contracts products into FMAs and
  leaves ~one f32 rounding of the product (2^-25 relative; the Dekker
  split needs uncontracted arithmetic, see tests/test_blocked_kernel.py
  TestRepricePass); the same envelope bounds the reprice mv.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.kernels.blocked import (BIG_INDEX, ah_ratio_pass,
                                         apply_reprice_pass,
                                         apply_window_pass, colk_costs_pass,
                                         ff32_from_f64, ff32_to_f64)
from simplex_tpu_torch.kernels import blocked as kb

M_PAD, R_PAD = 256, 384
EPS = 1e-4
WINDOWS = [(16, 0), (16, 7), (16, 15), (32, 0), (32, 13), (32, 31)]


def _inputs(L, t, seed):
    rng = np.random.default_rng(seed)
    Tt = rng.uniform(-1, 1, (M_PAD, R_PAD)).astype(np.float32)
    C = rng.uniform(-1, 1, (L, R_PAD)).astype(np.float32)
    F = rng.uniform(-0.1, 0.1, (L, M_PAD)).astype(np.float32)
    C[t:] = 0.0                      # rows >= t are dead by contract
    F[t:] = 0.0
    b = rng.uniform(0, 100, M_PAD)
    return rng, Tt, C, F, b


def _t(x):
    return torch.from_numpy(np.array(x))


def _i32(v):
    return torch.tensor(int(v), dtype=torch.int32)


def _assert_separated(keys, what):
    """The two best keys differ by more than 1e-6 relative."""
    best = np.sort(np.asarray(keys, np.float64))[:2]
    if best.size == 2 and np.isfinite(best[1]):
        assert best[1] - best[0] > 1e-6 * max(abs(best[0]), 1e-30), what


def _close32(got, want):
    """f32 tolerance: 1e-5 * (1 + |want|) elementwise."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= 1e-5 * (1 + np.abs(want))).all(), err.max()


def _close64(got, want, rel, extra=0.0):
    """f64 tolerance: rel * (1 + |want|) + extra, elementwise."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= rel * (1 + np.abs(want)) + extra).all(), err.max()


@pytest.mark.parametrize("L,t", WINDOWS)
def test_ah_ratio_matches_pallas(L, t):
    _, Tt, C, F, b = _inputs(L, t, 100 + L + t)
    h = 101
    want = ah_ratio_pass(jnp.asarray(Tt), jnp.asarray(F), jnp.asarray(C),
                         *ff32_from_f64(jnp.asarray(b)), jnp.int32(h),
                         jnp.int32(t), eps=EPS, interpret=True)
    got = kb.ah_ratio(_t(Tt), _t(F), _t(C), _t(b), _i32(h), t, EPS)
    ah = got[0].numpy()
    _close32(ah, want[0])
    q = np.where(ah >= EPS, b / np.where(ah >= EPS, ah, 1.0), np.inf)
    _assert_separated(q, "ratio near-tie in the test input")
    assert int(got[1]) == int(want[1]) != BIG_INDEX
    assert int(got[4]) == int(want[5]) == 0
    _close32(got[2].numpy(), want[2])
    assert float(got[3]) == b[int(got[1])]
    _close64(got[3].numpy(), ff32_to_f64(want[3], want[4]), 1e-12)


def test_ah_ratio_unbounded_matches_pallas():
    _, Tt, C, F, b = _inputs(16, 0, 7)
    h = 5
    Tt[:, h] = -np.abs(Tt[:, h])     # no eligible row
    want = ah_ratio_pass(jnp.asarray(Tt), jnp.asarray(F), jnp.asarray(C),
                         *ff32_from_f64(jnp.asarray(b)), jnp.int32(h),
                         jnp.int32(0), eps=EPS, interpret=True)
    got = kb.ah_ratio(_t(Tt), _t(F), _t(C), _t(b), _i32(h), 0, EPS)
    assert int(got[1]) == int(want[1]) == BIG_INDEX
    assert int(got[4]) == int(want[5]) == 1


def _colk_case(L, t, seed, devex, do=True):
    rng, Tt, C, F, b = _inputs(L, t, seed)
    costs = rng.uniform(-1, 1, R_PAD)
    ah = rng.uniform(-1, 1, M_PAD).astype(np.float32)
    base = rng.integers(0, R_PAD, M_PAD).astype(np.int32)
    w = rng.uniform(1, 2, R_PAD).astype(np.float32)
    k, h, r = 17, 29, R_PAD - 9
    ah[k] = 0.75
    p = np.float32(ah[k])
    bk = b[k]
    u = -0.625

    chi, clo = ff32_from_f64(jnp.asarray(costs))
    u_hi, u_lo = ff32_from_f64(jnp.asarray(u))
    bhi, blo = ff32_from_f64(jnp.asarray(b))
    bkh, bkl = ff32_from_f64(jnp.asarray(bk))
    want = colk_costs_pass(
        jnp.asarray(Tt), jnp.asarray(C), jnp.asarray(F), chi, clo,
        jnp.int32(k), jnp.int32(t), u_hi, u_lo, r=r, eps=EPS,
        do=jnp.asarray(do),
        bf=(jnp.asarray(ah), bhi, blo, jnp.asarray(base), jnp.int32(h),
            jnp.float32(p), bkh, bkl),
        devex=((jnp.asarray(w), jnp.float32(w[h]), jnp.int32(base[k]))
               if devex else None),
        interpret=True)

    port = dict(C=_t(C), F=_t(F), costs=_t(costs), b=_t(b), base=_t(base),
                w=_t(w) if devex else None)
    cands = kb.colk_costs(
        _t(Tt), port["C"], port["F"], port["costs"], _i32(k), t,
        torch.tensor(float(ff32_to_f64(u_hi, u_lo)), dtype=torch.float64),
        torch.tensor(do), r, EPS, _t(ah), port["b"], port["base"], _i32(h),
        torch.tensor(p), torch.tensor(float(bk), dtype=torch.float64),
        port["w"])
    return dict(costs=costs, b=b, base=base, w=w, u=u, r=r, k=k, h=h,
                t=t, ah=ah, p=p), want, port, cands


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
@pytest.mark.parametrize("L,t", WINDOWS)
def test_colk_costs_matches_pallas(L, t, devex):
    inp, want, port, cands = _colk_case(L, t, 200 + L + t, devex)
    (C2, chi2, clo2, h_d, vd_hi, vd_lo, h_b, vb_hi, vb_lo,
     bhi2, blo2, base2, v) = want[:13]
    C2 = np.asarray(C2)
    colk_port = port["C"][t].numpy()
    _close32(colk_port, C2[t])
    np.testing.assert_array_equal(port["C"][:t].numpy(), C2[:t])
    costs_got = port["costs"].numpy()
    _close64(costs_got, inp["costs"] - inp["u"] * colk_port.astype(
        np.float64), 1e-12)
    # Against the pairs: their interpret-mode envelope plus |u| times the
    # f32 pivot-row difference.
    prop = abs(inp["u"]) * np.abs(colk_port.astype(np.float64)
                                  - C2[t].astype(np.float64))
    _close64(costs_got, ff32_to_f64(chi2, clo2), 1e-7, 2 * prop)
    k, b, ah, p = inp["k"], inp["b"], inp["ah"], np.float64(inp["p"])
    b_exact = b - b[k] * (ah.astype(np.float64) / p)
    b_exact[k] = b[k] / p
    _close64(port["b"].numpy(), b_exact, 1e-12)
    _close64(port["b"].numpy(), ff32_to_f64(bhi2, blo2), 1e-7)
    np.testing.assert_array_equal(port["base"].numpy(), np.asarray(base2))
    np.testing.assert_allclose(port["F"][t].numpy(), np.asarray(v),
                               rtol=1e-6)
    if devex:
        _close32(port["w"].numpy(), want[13])
    # Candidates over the updated costs.
    r = inp["r"]
    live = np.where(np.arange(R_PAD) < r, costs_got, np.inf)
    elig = live <= -EPS
    if devex:
        _assert_separated(-np.where(elig, live ** 2 / port["w"].numpy(),
                                    -np.inf), "devex near-tie")
    else:
        _assert_separated(live, "Dantzig near-tie")
    assert int(cands[0]) == int(h_d)
    assert int(cands[2]) == int(h_b)
    _close64(cands[1].numpy(), ff32_to_f64(vd_hi, vd_lo), 1e-7,
             2 * prop.max())
    if int(h_b) != BIG_INDEX:
        _close64(cands[3].numpy(), ff32_to_f64(vb_hi, vb_lo), 1e-7,
                 2 * prop.max())


@pytest.mark.parametrize("M", [128, 384, 8192])
def test_ah_ratio_workspace_sizes(M):
    """8 bytes (the arrival counter), then one partial of three f64 and
    one int32 per block of AHR_COLS constraints; zeroed."""
    ws = kb.ah_ratio_workspace(M, "cpu")
    assert ws.dtype == torch.uint8 and ws.is_contiguous()
    assert ws.numel() == kb.ah_ratio_workspace_bytes(M) == 8 + 28 * (M // 64)
    assert not ws.any()


@pytest.mark.parametrize("case", ["t0", "t7", "unbounded"])
def test_ah_ratio_plain_ignores_workspace(case):
    """On the CPU the plain version runs with or without a workspace and
    gives the same outputs bit for bit; the workspace stays untouched."""
    t = 7 if case == "t7" else 0
    _, Tt, C, F, b = _inputs(16, t, 23)
    if case == "unbounded":
        Tt[:, 5] = -np.abs(Tt[:, 5])
    runs = []
    for ws in (None, kb.ah_ratio_workspace(M_PAD, "cpu")):
        runs.append((kb.ah_ratio(_t(Tt), _t(F), _t(C), _t(b), _i32(5), t,
                                 EPS, ws=ws), ws))
    (out0, _), (out1, ws) = runs
    for a, b2 in zip(out0, out1):
        assert a.dtype == b2.dtype and a.shape == b2.shape
        assert torch.equal(a, b2)
    assert int(out0[4]) == (case == "unbounded")
    assert not ws.any()


@pytest.mark.parametrize("R", [128, 384, 24576])
def test_colk_workspace_sizes(R):
    """16 bytes (counter and stashed weight), then one partial of three
    f64 and two int32 per block of COLK_COLS columns; zeroed."""
    ws = kb.colk_workspace(R, "cpu")
    assert ws.dtype == torch.uint8 and ws.is_contiguous()
    assert ws.numel() == kb.colk_workspace_bytes(R) == 16 + 32 * (R // 64)
    assert not ws.any()


@pytest.mark.parametrize("devex", [True, False], ids=["devex", "dantzig"])
@pytest.mark.parametrize("do", [True, False], ids=["pivot", "skipped"])
def test_colk_costs_plain_ignores_workspace(devex, do):
    """On the CPU the plain version runs with or without a workspace and
    gives the same outputs bit for bit; the workspace stays untouched."""
    _, Tt, C, F, b = _inputs(16, 7, 21)
    rng = np.random.default_rng(22)
    costs = rng.uniform(-1, 1, R_PAD)
    ah = rng.uniform(-1, 1, M_PAD).astype(np.float32)
    base = rng.integers(0, R_PAD, M_PAD).astype(np.int32)
    w = rng.uniform(1, 2, R_PAD).astype(np.float32)
    ah[17] = 0.75
    runs = []
    for ws in (None, kb.colk_workspace(R_PAD, "cpu")):
        st = dict(C=_t(C), F=_t(F), costs=_t(costs), b=_t(b),
                  base=_t(base), w=_t(w) if devex else None)
        cands = kb.colk_costs(
            _t(Tt), st["C"], st["F"], st["costs"], _i32(17), 7,
            torch.tensor(-0.625, dtype=torch.float64), torch.tensor(do),
            R_PAD - 9, EPS, _t(ah), st["b"], st["base"], _i32(29),
            torch.tensor(np.float32(0.75)),
            torch.tensor(float(b[17]), dtype=torch.float64), st["w"], ws=ws)
        runs.append((st, cands, ws))
    (s0, c0, _), (s1, c1, ws) = runs
    for name in s0:
        if s0[name] is not None:
            assert torch.equal(s0[name], s1[name]), name
    for a, b2 in zip(c0, c1):
        assert torch.equal(a, b2)
    assert not ws.any()


def test_colk_costs_skipped_pivot_matches_pallas():
    """do=False: C[t] and the eta row are zero, the vectors untouched."""
    inp, want, port, _ = _colk_case(16, 7, 5, devex=True, do=False)
    t = inp["t"]
    assert not port["C"][t].any() and not np.asarray(want[0])[t].any()
    assert not port["F"][t].any() and not np.asarray(want[12]).any()
    np.testing.assert_array_equal(port["costs"].numpy(), inp["costs"])
    np.testing.assert_array_equal(port["b"].numpy(), inp["b"])
    np.testing.assert_array_equal(port["base"].numpy(), inp["base"])
    np.testing.assert_array_equal(port["w"].numpy(), inp["w"])
    np.testing.assert_array_equal(np.asarray(want[13]), inp["w"])


def _apply_inputs(L, seed):
    rng = np.random.default_rng(seed)
    Tt = rng.uniform(-1, 1, (M_PAD, R_PAD)).astype(np.float32)
    C = rng.uniform(-1, 1, (L, R_PAD)).astype(np.float32)
    F = rng.uniform(-1, 1, (L, M_PAD)).astype(np.float32)
    coeffs = rng.uniform(-10, 10, M_PAD)
    return Tt, C, F, coeffs


@pytest.mark.parametrize("L", [16, 32])
def test_apply_reprice_matches_pallas(L):
    Tt, C, F, coeffs = _apply_inputs(L, 300 + L)
    T_want, hi, lo = apply_reprice_pass(
        jnp.asarray(Tt), jnp.asarray(C), jnp.asarray(F),
        *ff32_from_f64(jnp.asarray(coeffs)), do_reprice=jnp.asarray(True),
        interpret=True)
    T_got = _t(Tt)
    mv = kb.apply_reprice(T_got, _t(C), _t(F), _t(coeffs))
    T_want = np.asarray(T_want)
    _close32(T_got.numpy(), T_want)
    mv_want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    scale = np.abs(mv_want).max() + 1.0
    prop = np.abs(coeffs) @ np.abs(T_got.numpy().astype(np.float64)
                                   - T_want.astype(np.float64))
    assert (np.abs(mv.numpy() - mv_want) <= 1e-7 * scale + prop).all()


@pytest.mark.parametrize("L", [16, 32])
def test_apply_window_matches_pallas(L):
    Tt, C, F, _ = _apply_inputs(L, 400 + L)
    want = apply_window_pass(jnp.asarray(Tt), jnp.asarray(C),
                             jnp.asarray(F), interpret=True)
    got = _t(Tt)
    kb.apply_window(got, _t(C), _t(F))
    _close32(got.numpy(), want)


def test_cpu_path_leaves_launch_counters_at_zero():
    kb.reset_launches()
    Tt, C, F, coeffs = _apply_inputs(16, 11)
    kb.apply_window(_t(Tt), _t(C), _t(F))
    kb.apply_reprice(_t(Tt), _t(C), _t(F), _t(coeffs))
    _, Tt, C, F, b = _inputs(16, 3, 12)
    kb.ah_ratio(_t(Tt), _t(F), _t(C), _t(b), _i32(3), 3, EPS)
    assert kb.LAUNCHES == {name: 0 for name in kb.LAUNCHES}


@pytest.mark.parametrize("bad", ["dtype", "shape", "window", "ws_dtype",
                                 "ws_size", "ws_device"])
def test_wrappers_reject_bad_operands(bad):
    _, Tt, C, F, b = _inputs(16, 3, 13)
    Tt, C, F, b = _t(Tt), _t(C), _t(F), _t(b)
    ws = None
    if bad == "dtype":
        b = b.float()
    elif bad == "shape":
        F = F[:, :128].contiguous()
    elif bad == "ws_dtype":
        ws = kb.ah_ratio_workspace(M_PAD, "cpu").view(torch.int32)
    elif bad == "ws_size":
        ws = kb.ah_ratio_workspace(M_PAD, "cpu")[:-1]
    elif bad == "ws_device":
        ws = torch.zeros(kb.ah_ratio_workspace_bytes(M_PAD),
                         dtype=torch.uint8, device="meta")
    t = 16 if bad == "window" else 3
    with pytest.raises(ValueError):
        kb.ah_ratio(Tt, F, C, b, _i32(3), t, EPS, ws=ws)
