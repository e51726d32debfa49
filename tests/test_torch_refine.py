"""The port's refinement tiers (simplex_tpu_torch.refine and .reinvert)
against the JAX package's on the same bases, on the CPU.

Tolerances and why:

* refined x, y and the objective: 1e-9 relative of the operand scale.
  Both sides run f64 iterative refinement from the same basis and the
  same slack block (the port reads it as ``B^{-1}``, the JAX package as
  its transpose) or the same f32 LU; they differ only in summation order.
* certificates: the same verdict on both sides.
* a restart round: both sides end OPTIMAL and their refinements certify,
  with objectives within 1e-9 relative (each is the f64 refinement of an
  optimal basis; the mixed walks in between are not pinned).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu_torch as pst
from simplex_tpu import SolverOptions as JaxOptions
from simplex_tpu import generate_random_problem
from simplex_tpu import solve as jst_solve
from simplex_tpu import refine as jref
from simplex_tpu.reinvert import restart_device as jax_restart_device
from simplex_tpu.two_phase import solve_device_with_binv
from simplex_tpu_torch import refine as pref
from simplex_tpu_torch.reinvert import restart_device

from test_reinvert import MIXED, _drifted_restart_inputs

REL = 1e-9


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(p):
    return (jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c)), \
        (_t(p.A), _t(p.b), _t(p.c))


def _assert_same_refinement(got, want, p, tol=1e-6):
    scale = 1.0 + np.abs(np.asarray(want.x)).max()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=REL,
                               atol=REL * scale)
    yscale = 1.0 + np.abs(np.asarray(want.y)).max()
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=REL,
                               atol=REL * yscale)
    assert float(got.objective) == pytest.approx(float(want.objective),
                                                 rel=REL)
    assert (pref.certificates_pass(got, p.b, p.c, tol)
            == jref.certificates_pass(want, p.b, p.c, tol))


@pytest.fixture(scope="module")
def final_basis():
    """A mixed JAX solve's final basis and slack block (128x64, seed 2)."""
    p = generate_random_problem(128, 64, 2, 1, 100)
    (A, b, c), _ = _data(p)
    out, binv_t = solve_device_with_binv(
        A, b, c, p.vars, p.constraints, JaxOptions(**MIXED, refine=False))
    return p, np.asarray(out.base), np.asarray(binv_t)


def test_tableau_refinement_matches_jax(final_basis):
    p, base, binv_t = final_basis
    (A, b, c), (At, bt, ct) = _data(p)
    want = jax.device_get(jref.refine_solution_tableau(
        A, b, c, jnp.asarray(base), jnp.asarray(binv_t), n=p.vars,
        m=p.constraints))
    got = pref.refine_solution_tableau(At, bt, ct, _t(base), _t(binv_t.T),
                                       p.vars, p.constraints)
    _assert_same_refinement(got, want, p)
    assert pref.certificates_pass(got, p.b, p.c, 1e-6)


def test_lu_refinement_matches_jax(final_basis):
    p, base, _ = final_basis
    (A, b, c), (At, bt, ct) = _data(p)
    want = jax.device_get(jref.refine_solution(
        A, b, c, jnp.asarray(base), n=p.vars, m=p.constraints))
    got = pref.refine_solution(At, bt, ct, _t(base), p.vars, p.constraints)
    _assert_same_refinement(got, want, p)
    assert pref.certificates_pass(got, p.b, p.c, 1e-6)


def test_suboptimal_basis_fails_certificates_like_jax():
    """A feasible basis capped short of optimal: both sides refuse it on
    dual infeasibility."""
    p = generate_random_problem(200, 80, 9, 1, 100)
    base, binv_t, _ = _drifted_restart_inputs(p, stop_short=6, drift=1e-3)
    (A, b, c), (At, bt, ct) = _data(p)
    want = jax.device_get(jref.refine_solution_tableau(
        A, b, c, base, binv_t, n=p.vars, m=p.constraints))
    got = pref.refine_solution_tableau(At, bt, ct, _t(base),
                                       _t(np.asarray(binv_t).T), p.vars,
                                       p.constraints)
    _assert_same_refinement(got, want, p)
    assert float(got.dual_infeasibility) > 1e-3


def test_restart_round_matches_jax():
    """One reinversion restart from a drifted, suboptimal basis: both
    walk on to an optimum that certifies at the same objective."""
    p = generate_random_problem(200, 80, 9, 1, 100)
    base, binv_t, xB = _drifted_restart_inputs(p, stop_short=6, drift=1e-3)
    (A, b, c), (At, bt, ct) = _data(p)
    jout, jbinv, _ = jax_restart_device(A, b, c, base, binv_t, xB, p.vars,
                                        p.constraints, JaxOptions(**MIXED))
    want = jax.device_get(jref.refine_solution_tableau(
        A, b, c, jout.base, jbinv, n=p.vars, m=p.constraints))
    out, binv, ns_res = restart_device(
        At, bt, ct, _t(base), _t(np.asarray(binv_t).T), _t(xB), p.vars,
        p.constraints, pst.SolverOptions(**MIXED))
    assert out.status == pst.Status.OPTIMAL == int(jout.status)
    assert out.iterations_phase2 > 0
    assert ns_res < 1e-3
    got = pref.refine_solution_tableau(At, bt, ct, out.base, binv, p.vars,
                                       p.constraints)
    assert pref.certificates_pass(got, p.b, p.c, 1e-6)
    assert jref.certificates_pass(want, p.b, p.c, 1e-6)
    assert float(got.objective) == pytest.approx(float(want.objective),
                                                 rel=REL)


def test_restart_junk_basis_reports_numeric_like_jax(final_basis):
    p, base, binv_t = final_basis
    (A, b, c), (At, bt, ct) = _data(p)
    bad = np.full(p.constraints, -1.0)
    jout, _, _ = jax_restart_device(
        A, b, c, jnp.asarray(base), jnp.asarray(binv_t), jnp.asarray(bad),
        p.vars, p.constraints, JaxOptions(**MIXED, refine=False))
    out, _, _ = restart_device(At, bt, ct, _t(base), _t(binv_t.T), _t(bad),
                               p.vars, p.constraints,
                               pst.SolverOptions(**MIXED, refine=False))
    assert out.status == pst.Status.NUMERIC == int(jout.status)


def test_uncertifiable_solve_raises_after_two_restarts(monkeypatch):
    """With every certificate failing, the port runs both restart rounds
    and then the f64 finishing tier (``two_phase.fallback_solve``): the
    warm finish and the full re-solve's refinement fail the certificates
    too, so the result is the full f64 re-solve's, OPTIMAL, its
    RefineInfo uncertified and marked ``fallback``, at the JAX package's
    objective within 1e-9 (it raised until the finishing tier landed; a
    tiny refine_tol cannot force this: small instances refine to exact
    zeros)."""
    import simplex_tpu_torch.reinvert as reinvert

    rounds = []

    def counted(*args, **kw):
        rounds.append(1)
        return restart_device(*args, **kw)

    monkeypatch.setattr(pref, "certificates_pass", lambda *a: False)
    monkeypatch.setattr(reinvert, "restart_device", counted)
    p = pst.generate_random_problem(96, 40, 6, 1, 100)
    r = pst.solve(p, device="cpu", **MIXED)
    assert len(rounds) == 2
    assert r.status == pst.Status.OPTIMAL
    assert r.refine.fallback and not r.refine.certified
    assert r.refine.method == "tableau"
    want = jst_solve(p, JaxOptions(**MIXED))
    assert r.objective == pytest.approx(want.objective, rel=REL)
