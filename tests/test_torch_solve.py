"""simplex_tpu_torch.solve(device="cpu") against simplex_tpu.solve with the
production options (f32 tableau, f64 vectors, L=128 deferred blocks,
devex by default), plus the host layer and the tableau steps it runs
through.

Contract: equal statuses; where OPTIMAL, both results certified at the
refinement tolerance and objectives within 1e-9 relative (both are
refined in f64 from the same basis class, whatever the mixed walks did
on the way). Parsers, the XORWOW generator and the tableau build are
exact copies and are held to equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu.tableau import build_phase1 as jax_build_phase1
from simplex_tpu.tableau import gaussian_eliminate as jax_eliminate
from simplex_tpu.two_phase import \
    pivot_out_artificials as jax_pivot_out_artificials
from simplex_tpu_torch.tableau import (build_phase1, extract_solution,
                                       gaussian_eliminate, phase2_reset,
                                       tableau_from_numpy)
from simplex_tpu_torch.two_phase import pivot_out_artificials

from conftest import DATA

PROD = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=128)


def _pair(problem):
    return (pst.solve(problem, device="cpu", **PROD),
            jst.solve(problem, **PROD))


def _assert_same(got, want):
    assert got.status == want.status
    if want.status == jst.Status.OPTIMAL:
        assert got.refine.certified and want.refine.certified
        assert got.objective == pytest.approx(want.objective, rel=1e-9)
        np.testing.assert_allclose(got.x, want.x, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("name", ["smallProblem", "infeasibleProblem",
                                  "unboundedProblem"])
def test_example_files_match_jax(name):
    got, want = _pair(pst.read_problem(DATA / f"{name}.txt"))
    _assert_same(got, want)


def test_small_problem_golden():
    got = pst.solve(pst.read_problem(DATA / "smallProblem.txt"),
                    device="cpu", **PROD)
    assert got.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(64.0, rel=1e-12)
    np.testing.assert_allclose(got.x, [8.0, 0.0, 0.0], atol=1e-12)


@pytest.mark.parametrize("n,m,seed", [(64, 16, 1), (128, 64, 2)])
def test_seeded_instances_match_jax(n, m, seed):
    got, want = _pair(pst.generate_random_problem(n, m, seed, 1, 100))
    _assert_same(got, want)


def test_degenerate_instance_matches_jax():
    """An instance whose phase 1 ends with an artificial basic at zero
    (the b = 0 row): both solvers pivot it out and agree on the optimum."""
    A = np.array([[3.0, 1.0, 1.0, 2.0], [-2.0, -1.0, -2.0, -3.0],
                  [0.0, 1.0, 3.0, -2.0], [3.0, 2.0, 0.0, -1.0]])
    b = np.array([1.0, 0.0, -1.0, 2.0])
    c = np.array([1.0, 3.0, 1.0, 3.0])
    got, want = _pair(pst.Problem(A=A, b=b, c=c))
    _assert_same(got, want)
    assert got.degenerate and want.degenerate
    assert got.objective == pytest.approx(1.5, rel=1e-12)


def test_pivot_out_artificials_matches_jax():
    """From the initial phase-1 basis (every constraint's artificial
    basic), with one constraint made redundant (its structural and slack
    entries zeroed): each artificial is pivoted out in the same order,
    and the redundant row is dropped to the R_pad sentinel."""
    n, m = 12, 6
    p = jst.generate_random_problem(n, m, 4, 1, 100)
    opt = jst.SolverOptions(**PROD)
    jtab = jax_build_phase1(jnp.asarray(p.A), jnp.asarray(p.b), n, m, opt,
                            dims=(128, 128))
    T = np.array(jtab.T)
    T[:n + m, 2] = 0.0                    # constraint 2: redundant
    jtab = jtab.__class__(T=jnp.asarray(T), b=jtab.b, costs=jtab.costs,
                          z=jtab.z, base=jtab.base, n=n, m=m, r=jtab.r)
    want = jax_pivot_out_artificials(jtab, opt)
    got = pivot_out_artificials(
        tableau_from_numpy(T, jtab.b, jtab.costs, jtab.z, jtab.base, n, m,
                           jtab.r), pst.SolverOptions(**PROD))
    np.testing.assert_array_equal(got.base.numpy(), np.asarray(want.base))
    assert int(got.base[2]) == 128
    # Every update is scaled by an f32 row of the tableau (a_h / p, the
    # pivot row), rounded in another order after the first pivot: f32
    # tolerances, also for the f64 b and costs.
    np.testing.assert_allclose(got.Tt.numpy().T, np.asarray(want.T),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs),
                               rtol=1e-5, atol=1e-5)


def test_generator_is_bit_exact_with_jax():
    got = pst.generate_random_problem(40, 24, 777, 1, 100)
    want = jst.generate_random_problem(40, 24, 777, 1, 100)
    for a, b in ((got.A, want.A), (got.b, want.b), (got.c, want.c)):
        np.testing.assert_array_equal(a, b)


def test_seed_file_regenerates_the_jax_instance():
    path = DATA / "benchmark_problems" / "random_256_256.txt"
    got, want = pst.read_random_problem(path), jst.read_random_problem(path)
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.b, want.b)


def test_tableau_build_and_elimination_match_jax():
    """Tt is the JAX tableau transposed, bit for bit; the eliminated costs
    agree to f64 round-off (the port multiplies f64 coefficients, the JAX
    matvec f32-cast ones, exact here: phase-1 costs are 0/1)."""
    n, m = 20, 9
    p = jst.generate_random_problem(n, m, 8, -50, 50)    # b < 0 rows flip
    opt = jst.SolverOptions(**PROD)
    jtab = jax_build_phase1(jnp.asarray(p.A), jnp.asarray(p.b), n, m, opt,
                            dims=(128, 128))
    tab = build_phase1(torch.from_numpy(p.A), torch.from_numpy(p.b), n, m,
                       pst.SolverOptions(**PROD))
    np.testing.assert_array_equal(tab.Tt.numpy(), np.asarray(jtab.T).T)
    np.testing.assert_array_equal(tab.b.numpy(), np.asarray(jtab.b))
    np.testing.assert_array_equal(tab.base.numpy(), np.asarray(jtab.base))
    jel, el = jax_eliminate(jtab), gaussian_eliminate(tab)
    np.testing.assert_allclose(el.costs.numpy(), np.asarray(jel.costs),
                               rtol=1e-12, atol=1e-12)
    assert float(el.z) == pytest.approx(float(jel.z), rel=1e-12)


def test_phase2_reset_and_extraction():
    n, m = 5, 3
    p = jst.generate_random_problem(n, m, 2, 1, 10)
    tab = build_phase1(torch.from_numpy(p.A), torch.from_numpy(p.b), n, m,
                       pst.SolverOptions(**PROD))
    tab2 = phase2_reset(tab, torch.from_numpy(p.c))
    assert tab2.r == n + m and tab2.Tt is tab.Tt
    np.testing.assert_array_equal(tab2.costs[:n].numpy(), -p.c)
    assert not tab2.costs[n:].any()
    # Initial basis: every constraint's artificial -> x = 0.
    assert not extract_solution(tab2).any()
