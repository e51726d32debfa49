"""The plain PyTorch versions of K7-K10 (simplex_tpu_torch.kernels.batched,
taken for CPU tensors) and the batched loop's window step against the
JAX package's Pallas kernels run in interpret mode, from one state.

The window state is B=3 seeded random lanes in the style of the JAX
package's own window tests (tests/test_batched_hbm.py): lane 0 runs
freely, lane 1 is frozen (not RUNNING), lane 2 hits its iteration fuse
mid-window. Real LP states go through the whole solve in
tests/test_torch_batch.py.

Tolerances and why:

* integer outputs (base, status, iters, stall, bland) must be equal: on
  these inputs the eligible costs and ratios stay more than 1e-6
  relative apart, so the JAX pair folds and the port's f64 folds pick
  the same columns and rows;
* f32 arrays to 1e-5 * (1 + |x|) (the devex weights), or to 1e-5 of
  the summed magnitudes where the result cancels (Tt after the apply,
  1 + |x| + |F|^T |C|; the pivot rows and entering columns against
  their formulas): the eta corrections sum up to L products, each
  rounded, in another order;
* f64 vectors against the JAX double-f32 pairs to 1e-6 relative of the
  operand scale (1 + the lane's max |x|): interpret mode runs the pair
  arithmetic under XLA:CPU, which contracts the Dekker products into
  FMAs and leaves ~2^-25 relative per update, and the f32 pivot rows
  differ in their last bits;
* f64 vectors against the exact f64 formula on the port's own f32
  operands (window_replay, or c0 - cf @ Tt_new where the window
  re-priced) to 1e-12 relative: a version that carried them in f32
  would miss by ~1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.kernels.batched import batch_window_pass
from simplex_tpu.kernels.batched_hbm import (hbm_apply_pass,
                                             hbm_apply_reprice_pass,
                                             hbm_window_pass)
from simplex_tpu.kernels.blocked import ff32_from_f64, ff32_to_f64
from simplex_tpu_torch.batch import LoopState, window_step
from simplex_tpu_torch.config import Status
from simplex_tpu_torch.kernels import batched as kbt
from simplex_tpu_torch.tableau import batch_from_numpy, batch_tt_matvec

B, M, EPS = 3, 128, 1e-5
RUNNING = int(Status.RUNNING)
#: (R_pad, L)
SHAPES = [(384, 8), (640, 16)]
JAX_WINDOWS = {"vmem": batch_window_pass, "hbm": hbm_window_pass}


def _np(x):
    return np.asarray(x)


def _f64(rng, lo, hi, shape):
    """A double-f32 pair of seeded uniform values, and its f64 value."""
    hi_, lo_ = ff32_from_f64(jnp.asarray(rng.uniform(lo, hi, shape)))
    return hi_, lo_, _np(ff32_to_f64(hi_, lo_))


def _cases(R, L, seed, devex, cadence):
    """(JAX window args, the port's LoopState, r) from one random state."""
    rng = np.random.default_rng(seed)
    r = R - 5
    Tt = rng.uniform(-1, 1, (B * M, R)).astype(np.float32)
    chi, clo, costs = _f64(rng, -1, 0.5, (B, R))
    bh, bl, b = _f64(rng, 0.1, 1, (B, M))
    zh, zl, z = _f64(rng, -1, 1, B)
    c0h, c0l, c0 = _f64(rng, -1, 1, (B, R))
    base = np.stack([rng.permutation(R)[:M] for _ in range(B)]).astype(
        np.int32)
    cf = np.where(base < r, np.take_along_axis(c0, base, axis=1), 0.0)
    cfh, cfl = ff32_from_f64(jnp.asarray(cf))
    sci = np.zeros((B, 8), np.int32)
    sci[:, 0] = RUNNING
    sci[1, 0] = int(Status.OPTIMAL)                 # frozen lane
    sci[:, 5] = [1000, 1000, 5]                     # lane 2: fuse at 5
    sci_jax = sci.copy()
    sci_jax[:, 4] = sci[:, 0] == RUNNING
    sci_jax[:, 6] = int(cadence)
    scf = jnp.zeros((B, 8), jnp.float32).at[:, 0].set(zh).at[:, 1].set(zl)
    jax_args = (jnp.asarray(Tt), chi, clo, bh, bl, jnp.asarray(base),
                jnp.ones((B, R), jnp.float32), scf, jnp.asarray(sci_jax),
                c0h, c0l, cfh, cfl)
    # n and m are not read by the window.
    tab = batch_from_numpy(Tt, b, costs, z, base, n=r, m=0, r=r)
    st = LoopState.start(tab, L, torch.from_numpy(c0), devex, 1000, False)
    st.sci.copy_(torch.from_numpy(sci))
    st.cf.copy_(torch.from_numpy(cf))
    return jax_args, st, r


def _close32(got, want, terms=0.0):
    """f32 tolerance: 1e-5 * (1 + |want| + terms) elementwise; ``terms``
    is the summed magnitude of the products where the result cancels."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= 1e-5 * (1 + np.abs(want) + terms)).all(), err.max()


def _apply_terms(st):
    """|F|^T |C| per lane, (B*M, R): the magnitudes the apply sums."""
    R = st.Tt.shape[1]
    L = st.C.shape[0] // B
    return torch.bmm(st.F.view(B, L, M).abs().transpose(1, 2),
                     st.C.view(B, L, R).abs()).view(B * M, R).numpy()


def _close_lanes(got, want, rel):
    """rel * (1 + the lane's max |want|), elementwise, per lane."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = 1 + np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(got - want).reshape(want.shape[0], -1)
    assert (err <= rel * scale[:, None]).all(), (err / scale[:, None]).max()


def _close_rel(got, want, rel):
    got, want = got.double(), want.double()
    assert ((got - want).abs() <= rel * (1 + want.abs())).all(), \
        ((got - want).abs() / (1 + want.abs())).max()


def _separated(st0, r, devex):
    """The lanes' first candidates are no near-ties: the two best keys
    differ by more than 1e-6 relative."""
    costs = st0.costs[:, :r].numpy()
    for i in range(B):
        c = costs[i][costs[i] <= -EPS]
        keys = np.sort(-(c * c) if devex else c)[:2]
        if keys.size == 2:
            assert keys[1] - keys[0] > 1e-6 * abs(keys[0])


@pytest.mark.parametrize("tier", sorted(JAX_WINDOWS))
@pytest.mark.parametrize("fuse", [False, True], ids=["apply", "reprice"])
@pytest.mark.parametrize("rule", ["devex", "dantzig", "bland"])
@pytest.mark.parametrize("R,L", SHAPES, ids=["R384-L8", "R640-L16"])
def test_window_step_matches_pallas(tier, fuse, rule, R, L):
    devex, bland = rule == "devex", rule == "bland"
    cadence = L == 8          # the fused fold on cadence, and off it
    jax_args, st, r = _cases(R, L, 40 + R, devex, cadence)
    if bland:                 # the loop starts a static-Bland lane in Bland
        jax_args = (*jax_args[:8], jax_args[8].at[:, 3].set(1),
                    *jax_args[9:])
        st.sci[:, 3] = 1
    before = {k: v.clone() for k, v in vars(st).items()
              if isinstance(v, torch.Tensor)}
    _separated(st, r, devex)
    want = JAX_WINDOWS[tier](*jax_args, L=L, r=r, eps=EPS,
                             bland_static=bland, threshold=50, devex=devex,
                             fuse_reprice=fuse, interpret=True)
    (Tt2, chi2, clo2, bh2, bl2, base2, w2, scf2, sci2, cfh2, cfl2) = want
    if fuse:
        window_step(st, r=r, eps=EPS, bland_static=bland, threshold=50,
                    cadence=cadence)
    else:                     # the window, then the apply without the fold
        st.sci[:, 4] = ((st.sci[:, 0] == RUNNING)
                        & (st.sci[:, 1] < st.sci[:, 5])).to(torch.int32)
        kbt.batch_window(st.Tt, st.costs, st.b, st.z, st.base, st.w, st.sci,
                         st.c0, st.cf, st.C, st.F, st.AH, st.piv, st.nlive,
                         r=r, eps=EPS, bland_static=bland, threshold=50)
        kbt.batch_apply(st.Tt, st.C, st.F, st.nlive)

    np.testing.assert_array_equal(st.base.numpy(), _np(base2))
    np.testing.assert_array_equal(st.sci[:, :4].numpy(), _np(sci2)[:, :4])
    assert st.nlive.tolist() == [L, 0, 5]
    np.testing.assert_array_equal(st.cf.numpy(), _np(ff32_to_f64(cfh2, cfl2)))
    _close32(st.Tt.numpy(), Tt2, _apply_terms(st))
    if devex:
        _close32(st.w.numpy(), w2)
    _close_lanes(st.costs.numpy(), ff32_to_f64(chi2, clo2), 1e-6)
    _close_lanes(st.b.numpy(), ff32_to_f64(bh2, bl2), 1e-6)
    _close_lanes(st.z.numpy()[:, None],
                 _np(ff32_to_f64(scf2[:, 0], scf2[:, 1]))[:, None], 1e-6)

    # The exact f64 formula on the port's own f32 operands.
    rep = kbt.window_replay(before["Tt"], before, st.C, st.F, st.AH,
                            st.piv, st.nlive)
    for name in ("C", "AH"):
        err = (getattr(st, name).view(B, L, -1).double() - rep[name]).abs()
        assert (err <= 1e-5 * (1 + rep[name + "_terms"])).all(), name
    _close_rel(st.F.view(B, L, M), rep["F"], 1e-6)
    if devex:
        _close_rel(st.w, rep["w"], 1e-6)
    _close_rel(st.b, rep["b"], 1e-12)
    _close_rel(st.z, rep["z"], 1e-12)
    assert torch.equal(st.base, rep["base"]) and torch.equal(st.cf, rep["cf"])
    costs = rep["costs"]
    repriced = fuse & (cadence | (st.sci[:, 0] != RUNNING)) \
        & (before["sci"][:, 0] == RUNNING)
    exact = before["c0"] - batch_tt_matvec(st.Tt.view(B, M, R), st.cf)
    _close_rel(st.costs, torch.where(repriced[:, None], exact, costs),
               1e-12)
    if fuse and not cadence:
        assert repriced.tolist() == [False, False, False]


@pytest.mark.parametrize("fuse", [False, True])
def test_window_alone_matches_hbm_window(fuse):
    """The window kernel's own outputs: the pivot rows C[t] agree with the
    rows the JAX pivots would write, and every eta row past a lane's
    nlive is zero (the liveness contract), the walk -1 there."""
    R, L = SHAPES[0]
    jax_args, st, r = _cases(R, L, 7, True, True)
    st.sci[:, 4] = (st.sci[:, 0] == RUNNING).to(torch.int32)   # active
    before = {k: v.clone() for k, v in vars(st).items()
              if isinstance(v, torch.Tensor)}
    kbt.batch_window(st.Tt, st.costs, st.b, st.z, st.base, st.w, st.sci,
                     st.c0, st.cf, st.C, st.F, st.AH, st.piv, st.nlive, r=r,
                     eps=EPS, bland_static=False, threshold=50)
    want = hbm_window_pass(*jax_args, L=L, r=r, eps=EPS, bland_static=False,
                           threshold=50, devex=True, fuse_reprice=fuse,
                           interpret=True)
    np.testing.assert_array_equal(st.base.numpy(), _np(want[5]))
    np.testing.assert_array_equal(st.sci[:, :4].numpy(), _np(want[8])[:, :4])
    assert torch.equal(st.Tt, before["Tt"])          # the window only reads
    C3, F3 = st.C.view(B, L, R), st.F.view(B, L, M)
    piv3 = st.piv.view(B, L, 2)
    for i, live in enumerate(st.nlive.tolist()):
        assert not C3[i, live:].any() and not F3[i, live:].any()
        assert (piv3[i, live:] == -1).all() and (piv3[i, :live] >= 0).all()
    # After the last pivot of lane 0 (leaving at k), row k of the applied
    # tableau is its pivot row over p: the JAX tableau's row.
    t = L - 1
    k = int(piv3[0, t, 1])
    p = st.AH.view(B, L, M)[0, t, k]
    _close32((C3[0, t] / p).numpy(), _np(want[0]).reshape(B, M, R)[0, k])


def _all_live(L):
    """nlive for etas whose every row is live."""
    return torch.full((B,), L, dtype=torch.int32)


def _apply_inputs(R, L, seed):
    rng = np.random.default_rng(seed)
    Tt = rng.uniform(-1, 1, (B * M, R)).astype(np.float32)
    C = rng.uniform(-1, 1, (B * L, R)).astype(np.float32)
    Ft = rng.uniform(-1, 1, (B * M, L)).astype(np.float32)
    cf = rng.uniform(-10, 10, (B, M))
    F = np.ascontiguousarray(Ft.reshape(B, M, L).transpose(0, 2, 1)
                             .reshape(B * L, M))
    return Tt, C, Ft, F, cf


@pytest.mark.parametrize("R,L", [(384, 8), (640, 16), (15104, 8)])
def test_apply_reprice_matches_pallas(R, L):
    """do_r skips lane 1: both return zeros there. mv against the pairs at
    their interpret-mode envelope (1e-7 of the lane scale) plus the exact
    propagation of the f32 tableau difference."""
    Tt, C, Ft, F, cf = _apply_inputs(R, L, 300 + R + L)
    do_r = np.array([1, 0, 1], np.int32)
    T_want, hi, lo = hbm_apply_reprice_pass(
        jnp.asarray(Tt), jnp.asarray(C), jnp.asarray(Ft),
        *ff32_from_f64(jnp.asarray(cf)), jnp.asarray(do_r), interpret=True)
    T_got = torch.from_numpy(Tt.copy())
    mv = kbt.batch_apply_reprice(T_got, torch.from_numpy(C),
                                 torch.from_numpy(F), torch.from_numpy(cf),
                                 torch.from_numpy(do_r), _all_live(L))
    _close32(T_got.numpy(), T_want)
    mv_want = _np(hi).astype(np.float64) + _np(lo).astype(np.float64)
    assert not mv[1].any() and not mv_want[1].any()
    diff = np.abs(T_got.numpy().astype(np.float64)
                  - _np(T_want).astype(np.float64)).reshape(B, M, R)
    prop = np.einsum("bm,bmr->br", np.abs(cf), diff)
    scale = np.abs(mv_want).max(axis=1, keepdims=True) + 1.0
    assert (np.abs(mv.numpy() - mv_want) <= 1e-7 * scale + prop).all()
    exact = batch_tt_matvec(T_got.view(B, M, R), torch.from_numpy(cf))
    _close_rel(mv[do_r == 1], exact[do_r == 1], 1e-12)


@pytest.mark.parametrize("R,L", [(384, 8), (15104, 8)])
def test_apply_matches_pallas(R, L):
    Tt, C, Ft, F, _ = _apply_inputs(R, L, 400 + R + L)
    want = hbm_apply_pass(jnp.asarray(Tt), jnp.asarray(C), jnp.asarray(Ft),
                          interpret=True)
    got = torch.from_numpy(Tt.copy())
    kbt.batch_apply(got, torch.from_numpy(C), torch.from_numpy(F),
                    _all_live(L))
    _close32(got.numpy(), want)


def test_batch_candidates_match_numpy():
    """The candidate fold per lane against NumPy: the Dantzig argmin over
    the active columns, the devex argmax of cost^2 / w over the eligible
    ones (cost <= -eps), the lowest eligible index; ties go to the lower
    column (equal costs at 17 and 40), and a lane with no eligible column
    gives the devex candidate (0, inf) and the Bland (BIG_INDEX, inf)."""
    from simplex_tpu_torch.kernels.blocked import BIG_INDEX

    rng = np.random.default_rng(3)
    r = 250
    costs = rng.uniform(-1, 1, (4, 256))
    costs[:, 17] = costs[:, 40] = -2.0
    costs[3] = 1.0
    w = rng.uniform(1, 2, (4, 256)).astype(np.float32)
    w[:, 17] = w[:, 40] = 1.0
    live = np.arange(256) < r
    for devex in (True, False):
        got = kbt.batch_candidates(torch.from_numpy(costs),
                                   torch.from_numpy(w) if devex else None,
                                   r, EPS)
        for i in range(4):
            c = np.where(live, costs[i], np.inf)
            elig = c <= -EPS
            if devex:
                key = np.where(elig, c * c / w[i].astype(np.float64),
                               -np.inf)
                h = int(np.argmax(key))
                v = costs[i, h] if elig.any() else np.inf
            else:
                h = int(np.argmin(c))
                v = c[h]
            hb = int(np.flatnonzero(elig)[0]) if elig.any() else BIG_INDEX
            vb = costs[i, hb] if elig.any() else np.inf
            assert [int(got[0][i]), float(got[1][i]), int(got[2][i]),
                    float(got[3][i])] == [h, v, hb, vb]
        assert int(got[0][0]) == 17 or devex
