"""The port's host oracle (``simplex_tpu_torch.solve_oracle``) against
``simplex_tpu.solve_oracle`` on the cases of tests/test_oracle.py, under
both tie rules ("lowest", and "cuda", the reference GPU's reduction
order) and both update rules ("blas", and "fma", the native helper that
rounds as the GPU does): status, both pivot counts and the objective
exactly equal (the port carries its own copy of the NumPy code, so the
same arithmetic in the same order). And the port's ``cuda_argmin`` /
``cuda_ratio_argmin`` against the JAX copies on the cases of
tests/test_cuda_order.py, exactly."""

import numpy as np
import pytest

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu.utils import cuda_order as jorder
from simplex_tpu_torch.utils import cuda_order as porder

from conftest import DATA


def _mixed_sign(i):
    """tests/test_oracle.py's mixed-sign instances (feasible through a
    known x0 >= 0, bounded by a sum(x) <= M row): the i-th of the ten."""
    rng = np.random.default_rng(3)
    for _ in range(i + 1):
        m, n = int(rng.integers(3, 12)), int(rng.integers(3, 12))
        A = rng.normal(size=(m, n))
        x0 = rng.uniform(0, 2, size=n)
        b = A @ x0 + rng.uniform(0.1, 1.0, size=m)
        A = np.vstack([A, np.ones(n)])
        b = np.append(b, x0.sum() + 10.0)
        c = rng.normal(size=n)
    return A, b, c


def _case(name):
    """(A, b, c, options) of a tests/test_oracle.py case."""
    if name == "small":
        p = jst.read_problem(DATA / "smallProblem.txt")
        return p.A, p.b, p.c, {}
    if name == "infeasible":
        p = jst.read_problem(DATA / "infeasibleProblem.txt")
        return p.A, p.b, p.c, {}
    if name == "unbounded":
        return [[1.0, -1.0]], [1.0], [1.0, 0.0], {}
    if name == "negative-rhs":
        return [[-1.0, 0.0], [1.0, 1.0]], [-2.0, 5.0], [1.0, 1.0], {}
    if name.startswith("degenerate-"):
        return ([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], [0.0, 0.0, 4.0],
                [1.0, 1.0], {"degeneracy": name.split("-")[1]})
    if name.startswith("random-"):
        p = jst.generate_random_problem(60, 40, int(name[7:]), 1, 100)
        return p.A, p.b, p.c, {}
    if name.startswith("mixed-sign-"):
        return (*_mixed_sign(int(name[11:])), {})
    if name.startswith("rule-"):
        p = jst.generate_random_problem(30, 20, 11, 1, 100)
        return p.A, p.b, p.c, {"pivot_rule": name[5:]}
    if name == "beale":
        return ([[0.25, -8.0, -1.0, 9.0], [0.5, -12.0, -0.5, 3.0],
                 [0.0, 0.0, 1.0, 0.0]], [0.0, 0.0, 1.0],
                [0.75, -20.0, 0.5, -6.0], {"bland_threshold": 10})
    if name == "maxiter":
        p = jst.generate_random_problem(40, 30, 5, 1, 100)
        return p.A, p.b, p.c, {"max_iter": 1}
    raise KeyError(name)


CASES = (["small", "infeasible", "unbounded", "negative-rhs",
          "degenerate-reference", "degenerate-continue"]
         + [f"random-{s}" for s in (1, 7, 42)]
         + [f"mixed-sign-{i}" for i in (0, 4, 9)]
         + ["rule-dantzig", "rule-bland", "beale", "maxiter"])


@pytest.mark.parametrize("update_rule", ["blas", "fma"])
@pytest.mark.parametrize("tie_rule", ["lowest", "cuda"])
@pytest.mark.parametrize("case", CASES)
def test_oracle_matches_jax(case, tie_rule, update_rule):
    A, b, c, opts = _case(case)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    want = jst.solve_oracle(jst.Problem(A=A, b=b, c=c),
                            jst.SolverOptions(**opts), tie_rule=tie_rule,
                            update_rule=update_rule)
    got = pst.solve_oracle(pst.Problem(A=A, b=b, c=c),
                           pst.SolverOptions(**opts), tie_rule=tie_rule,
                           update_rule=update_rule)
    assert got.status == want.status
    assert (got.iterations_phase1, got.iterations_phase2) == (
        want.iterations_phase1, want.iterations_phase2)
    assert got.objective == want.objective
    assert got.degenerate == want.degenerate
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)


def test_oracle_goldens():
    """tests/test_oracle.py's goldens through the port: smallProblem 64
    at (8, 0, 0), Beale's cycling instance 1.25 under the Bland
    fallback, the fuse at one pivot."""
    r = pst.solve_oracle(pst.read_problem(DATA / "smallProblem.txt"))
    assert r.status == pst.Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-9)
    np.testing.assert_allclose(r.x, [8.0, 0.0, 0.0], atol=1e-9)
    A, b, c, opts = _case("beale")
    r = pst.solve_oracle(pst.Problem(A=np.array(A), b=np.array(b),
                                     c=np.array(c)),
                         pst.SolverOptions(**opts))
    assert r.status == pst.Status.OPTIMAL
    assert r.objective == pytest.approx(1.25, abs=1e-8)
    A, b, c, opts = _case("maxiter")
    r = pst.solve_oracle(pst.Problem(A=A, b=b, c=c),
                         pst.SolverOptions(**opts))
    assert r.status == pst.Status.MAXITER


def test_update_rule_is_validated():
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(AssertionError):
        pst.solve_oracle(p, update_rule="dger")


# ---------------------------------------------------------------------------
# utils.cuda_order, on tests/test_cuda_order.py's cases.

def _uniform(n):
    rng = np.random.Generator(np.random.Philox(key=n))
    return rng.uniform(-1e4, 1e4, n)


def _tied(n):
    rng = np.random.Generator(np.random.Philox(key=7 * n))
    values = rng.uniform(10.0, 1e4, n)
    winners = rng.choice(n, size=5, replace=False)
    values[winners] = 1.0 + rng.uniform(0, 0.5e-9, 5)
    return values


def _three_way():
    rng = np.random.Generator(np.random.Philox(key=3))
    values = rng.uniform(-10, 10, 4097)
    values[[5, 1000, 4000]] = values.min() - 1.0
    return values


@pytest.mark.parametrize("values", [
    *(_uniform(n) for n in (5, 100, 511, 512, 513, 5000, 300_000)),
    *(_tied(n) for n in (100, 2048, 100_000)),
    _three_way(),
], ids=[f"untied-{n}" for n in (5, 100, 511, 512, 513, 5000, 300_000)]
    + [f"tied-{n}" for n in (100, 2048, 100_000)] + ["three-way"])
def test_cuda_argmin_matches_jax(values):
    assert porder.cuda_argmin(values) == jorder.cuda_argmin(values)
    assert porder.cuda_argmin(values, 1e-3) == jorder.cuda_argmin(values,
                                                                   1e-3)


@pytest.mark.parametrize("b,a_h", [
    ([10.0, 1.0, 5.0, 4.0], [1.0, -2.0, 0.0, 2.0]),
    ([1.0, 2.0], [-1.0, 0.0]),
    (list(_uniform(1025) + 1e4), list(_uniform(1026)[1:])),
], ids=["masked", "all-masked", "1025"])
def test_cuda_ratio_argmin_matches_jax(b, a_h):
    b, a_h = np.array(b), np.array(a_h)
    got = porder.cuda_ratio_argmin(b, a_h)
    assert got == jorder.cuda_ratio_argmin(b, a_h)
    if (a_h <= 0).all():
        assert got == (-1, porder.DBL_MAX)
