"""The port's blocked-kernel loop (simplex_tpu_torch.solver, plain kernel
versions on the CPU) against the JAX package's fused loop
(``solve_loop_blocked_kernel(..., interpret=True)``), both started from
one phase-1 tableau built by the JAX package and carried across with
``tableau_from_numpy``.

Mixed-precision walks are never pinned across implementations (they
differ at reduced-cost near-ties: the JAX fold compares f32 hi parts,
the port f64 values), so the contract is the pattern of
tests/test_blocked_kernel.py:389-408: equal status, a phase-1 optimum
(objective > -1e-4) on both sides, and iteration counts within
max(3, 10%). A capped run is exact: both stop at the cap.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.generator import generate_random_problem
from simplex_tpu.solver import run_solve_loop as jax_run_solve_loop
from simplex_tpu.solver import solve_loop_blocked_kernel as jax_loop
from simplex_tpu.tableau import build_phase1, gaussian_eliminate
from simplex_tpu.tableau import phase1_objective as jax_phase1_objective
from simplex_tpu.tableau import round_up
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.solver import run_solve_loop, solve_loop_blocked_kernel
from simplex_tpu_torch.tableau import phase1_objective, tableau_from_numpy

N, M, L = 64, 16, 16


def _start(seed, **kw):
    """One phase-1 tableau (JAX layout) and its pre-elimination costs,
    plus the JAX and port options for the same configuration."""
    opts = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=L,
                **kw)
    jopt = JaxOptions(**opts)
    p = generate_random_problem(N, M, seed, 1, 100)
    dims = (round_up(N + 2 * M, 128), round_up(M, 128))
    tab = build_phase1(jnp.asarray(p.A), jnp.asarray(p.b), N, M, jopt,
                       dims=dims)
    costs0 = tab.costs
    return gaussian_eliminate(tab), costs0, jopt, SolverOptions(**opts)


def _port(tab):
    return tableau_from_numpy(tab.T, tab.b, tab.costs, tab.z, tab.base,
                              tab.n, tab.m, tab.r)


def _assert_same_outcome(got, want):
    (gtab, gst, git), (wtab, wst, wit) = got, want
    assert gst == int(wst) == int(Status.OPTIMAL)
    assert float(phase1_objective(gtab)) > -1e-4
    assert float(jax_phase1_objective(wtab)) > -1e-4
    assert abs(git - int(wit)) <= max(3, int(wit) // 10), (git, int(wit))


@pytest.mark.parametrize("rule", [None, "dantzig", "bland"],
                         ids=["devex", "dantzig", "bland"])
def test_phase1_matches_jax_kernel_loop(rule):
    tab, costs0, jopt, popt = _start(3, pivot_rule=rule)
    want = jax_loop(tab, jopt, 2000, costs0, interpret=True)
    got = solve_loop_blocked_kernel(_port(tab), popt, 2000,
                                    torch.from_numpy(np.array(costs0)))
    _assert_same_outcome(got, want)


@pytest.mark.parametrize("every", [1, 3])
def test_reprice_cadence_matches_jax_kernel_loop(every):
    tab, costs0, jopt, popt = _start(5, reprice_every=every)
    want = jax_loop(tab, jopt, 2000, costs0, interpret=True)
    got = solve_loop_blocked_kernel(_port(tab), popt, 2000,
                                    torch.from_numpy(np.array(costs0)))
    _assert_same_outcome(got, want)


def test_without_costs0_matches_jax_kernel_loop():
    """No re-pricing: every window ends in the bare apply (K4)."""
    tab, _, jopt, popt = _start(7)
    want = jax_loop(tab, jopt, 2000, None, interpret=True)
    got = solve_loop_blocked_kernel(_port(tab), popt, 2000, None)
    _assert_same_outcome(got, want)


def test_iteration_cap_is_exact():
    """A capped run stops at the cap on both sides, mid-window."""
    tab, costs0, jopt, popt = _start(3)
    _, wst, wit = jax_loop(tab, jopt, 21, costs0, interpret=True)
    _, gst, git = solve_loop_blocked_kernel(
        _port(tab), popt, 21, torch.from_numpy(np.array(costs0)))
    assert gst == int(wst) == int(Status.RUNNING)
    assert git == int(wit) == 21


def test_run_solve_loop_matches_jax_dispatch():
    """run_solve_loop with the normalize_costs scaling (large costs make
    the scale > 1) against the JAX dispatch, which on the CPU takes the
    XLA blocked loop: same status and phase-1 optimum."""
    tab, costs0, jopt, popt = _start(9)
    big = 1e4
    tab = dataclasses.replace(tab, costs=tab.costs * big, z=tab.z * big)
    costs0 = costs0 * big
    wtab, wst, wit = jax_run_solve_loop(tab, jopt, 2000, costs0)
    gtab, gst, git = run_solve_loop(_port(tab), popt, 2000,
                                    torch.from_numpy(np.array(costs0)))
    assert gst == int(wst) == int(Status.OPTIMAL)
    assert float(phase1_objective(gtab)) > -1e-4
    assert abs(git - int(wit)) <= max(3, int(wit) // 10), (git, int(wit))


def test_run_solve_loop_restores_cost_units():
    """After a few pivots (one walk on both sides) z and the costs come
    back in the caller's units, not the normalized ones."""
    tab, costs0, jopt, popt = _start(9)
    big = 1e4
    tab = dataclasses.replace(tab, costs=tab.costs * big, z=tab.z * big)
    costs0 = costs0 * big
    wtab, _, wit = jax_run_solve_loop(tab, jopt, 4, costs0)
    gtab, _, git = run_solve_loop(_port(tab), popt, 4,
                                  torch.from_numpy(np.array(costs0)))
    assert git == int(wit) == 4
    np.testing.assert_allclose(float(gtab.z), float(wtab.z), rtol=1e-6)
    # The basic columns' costs are ~0: f32 tableau noise of the scale.
    want = np.asarray(wtab.costs)
    np.testing.assert_allclose(gtab.costs.numpy(), want, rtol=1e-6,
                               atol=1e-7 * np.abs(want).max())
