"""The port's power-of-two equilibration (``simplex_tpu_torch.scaling``)
against ``simplex_tpu.scaling``, and ``solve(equilibrate=True)`` against
the JAX ``solve`` on the cases of tests/test_scaling.py, on the CPU.

* ``equilibrate`` and ``unwind_result``: bit for bit (powers of two are
  exact, and the port runs the same NumPy code).
* ``solve(equilibrate=True)``: the same status; in the mixed mode both
  refined and certified (no fallback), the objective within 1e-9 of the
  JAX one and of the base instance's oracle optimum; in f64 the same walk
  and the objective within 1e-12; a non-OPTIMAL objective in scaled
  units, as the JAX package reports it.
"""

import numpy as np
import pytest

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu import scaling as jscaling
from simplex_tpu_torch import scaling as pscaling

from conftest import DATA

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=16)


def _extreme_problem(seed: int, exp=15):
    """tests/test_scaling.py's (base, extreme) pair: a seeded OPTIMAL
    instance and its row/column 10^+-15-scaled counterpart, which shares
    its optimum value."""
    p = jst.generate_random_problem(60, 24, seed, 1, 100)
    rng = np.random.default_rng(seed)
    rexp = rng.integers(-exp, exp + 1, size=p.constraints)
    cexp = rng.integers(-exp, exp + 1, size=p.vars)
    A = p.A * (10.0 ** rexp)[:, None] * (10.0 ** cexp)[None, :]
    return p, jst.Problem(A=A, b=p.b * (10.0 ** rexp), c=p.c * (10.0 ** cexp))


def _beyond_f32():
    """Entries past f32's range (tests/test_scaling.py)."""
    base, _ = _extreme_problem(2)
    rexp = np.linspace(-20, 20, base.constraints)
    cexp = np.linspace(20, -20, base.vars)
    A = base.A * (10.0 ** rexp)[:, None] * (10.0 ** cexp)[None, :]
    assert np.abs(A).max() > 1e38
    return base, jst.Problem(A=A, b=base.b * (10.0 ** rexp),
                             c=base.c * (10.0 ** cexp))


def _pair(name):
    if name.startswith("extreme-"):
        return _extreme_problem(int(name[8:]))
    if name == "beyond-f32":
        return _beyond_f32()
    if name == "random":
        p = jst.generate_random_problem(40, 16, 9, 1, 100)
        return p, p
    raise KeyError(name)


def _port(p):
    return pst.Problem(A=p.A, b=p.b, c=p.c)


@pytest.mark.parametrize("name", ["extreme-1", "extreme-3", "extreme-5",
                                  "beyond-f32", "random"])
def test_equilibrate_matches_jax_bit_for_bit(name):
    _, p = _pair(name)
    want_p, want_s = jscaling.equilibrate(p)
    got_p, got_s = pscaling.equilibrate(_port(p))
    for a, b in ((got_p.A, want_p.A), (got_p.b, want_p.b),
                 (got_p.c, want_p.c), (got_s.row, want_s.row),
                 (got_s.col, want_s.col)):
        assert np.array_equal(a, b)
    for f in (got_s.row, got_s.col):
        assert np.all(np.frexp(f)[0] == 0.5), "not a power of two"
    back = got_p.A / got_s.row[:, None] / got_s.col[None, :]
    assert np.array_equal(back, p.A)


def test_unwind_result_matches_jax():
    p = jst.generate_random_problem(40, 16, 9, 1, 100)
    sp, sc = pscaling.equilibrate(_port(p))
    r = pst.solve(sp, device="cpu")
    got = pscaling.unwind_result(r, sc, _port(p))
    want = jscaling.unwind_result(r, jscaling.Scaling(sc.row, sc.col), p)
    assert np.array_equal(got.x, want.x) and got.objective == want.objective
    assert got.objective == pytest.approx(jst.solve_oracle(p).objective,
                                          rel=1e-9)
    missing = pst.SolveResult(pst.Status.INFEASIBLE, None, -1.5)
    assert pscaling.unwind_result(missing, sc, _port(p)) is missing


@pytest.mark.parametrize("name", ["extreme-1", "extreme-2", "extreme-7",
                                  "beyond-f32"])
def test_mixed_equilibrated_solve_matches_jax(name):
    """Extreme coefficient ranges (1e+-30; past f32's range for
    "beyond-f32", where only refining in scaled space works): OPTIMAL,
    certified by refinement in scaled space without the fallback, at the
    base instance's optimum."""
    base, p = _pair(name)
    want = jst.solve(p, jst.SolverOptions(**MIXED, equilibrate=True))
    got = pst.solve(_port(p), device="cpu", **MIXED, equilibrate=True)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified and not got.refine.fallback
    assert want.refine.certified and not want.refine.fallback
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert got.objective == pytest.approx(jst.solve_oracle(base).objective,
                                          rel=1e-9)
    assert got.x.shape == (p.vars,) and np.isfinite(got.x).all()


def test_f64_equilibrated_matches_jax_and_plain():
    """In f64 the scaled walk may differ from the unscaled one, but the
    port and the JAX package walk the scaled problem alike."""
    p = jst.generate_random_problem(80, 32, 11, 1, 100)
    want = jst.solve(p, equilibrate=True)
    got = pst.solve(_port(p), device="cpu", equilibrate=True)
    plain = pst.solve(_port(p), device="cpu")
    assert got.status == want.status == plain.status == pst.Status.OPTIMAL
    assert (got.iterations_phase1, got.iterations_phase2) == (
        want.iterations_phase1, want.iterations_phase2)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.objective == pytest.approx(plain.objective, rel=1e-9)
    assert got.refine is None


@pytest.mark.parametrize("name", ["infeasible", "knife-edge", "unbounded"])
def test_statuses_survive_scaling_like_jax(name):
    """Infeasibility (the reference contract, in scaled units; the
    knife-edge x <= 1e20, -x <= -2e20) and unboundedness survive the
    scaling; a non-OPTIMAL objective stays in scaled units on both
    sides."""
    if name == "infeasible":
        p = jst.read_problem(DATA / "infeasibleProblem.txt")
        status = pst.Status.INFEASIBLE
    elif name == "knife-edge":
        p = jst.Problem(A=np.array([[1.0], [-1.0]]),
                        b=np.array([1e20, -2e20]), c=np.array([1.0]))
        status = pst.Status.INFEASIBLE
    else:
        p = jst.Problem(A=np.array([[1e25, -1e25]]), b=np.array([1e20]),
                        c=np.array([1e-20, 1.0]))
        status = pst.Status.UNBOUNDED
    want = jst.solve(p, jst.SolverOptions(**MIXED, equilibrate=True))
    got = pst.solve(_port(p), device="cpu", **MIXED, equilibrate=True)
    assert got.status == want.status == status
    assert got.x is None
    assert got.objective == pytest.approx(want.objective, rel=1e-9,
                                          abs=1e-12)


def test_equilibrated_fallback_unwinds(monkeypatch):
    """When the mixed tiers do not certify, the finishing tier runs on
    the scaled problem and its result is unwound to original units."""
    from simplex_tpu_torch import two_phase

    refine_result = two_phase.refine_result

    def failing(*a, **k):
        rx, robj, info, ro = refine_result(*a, **k)
        return None, None, info._replace(certified=False), ro

    monkeypatch.setattr(two_phase, "refine_result", failing)
    base, p = _extreme_problem(1)
    got = pst.solve(_port(p), device="cpu", **MIXED, equilibrate=True)
    assert got.status == pst.Status.OPTIMAL
    assert got.refine.fallback and got.refine.certified
    assert got.objective == pytest.approx(jst.solve_oracle(base).objective,
                                          rel=1e-9)
    assert got.objective == pytest.approx(float(p.c @ got.x), rel=1e-12)
