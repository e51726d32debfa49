"""The port's sequential loops, K6 and the plain blocked loop on the CPU,
against the JAX package.

* K6: ``fused_pivot`` (its plain version, on CPU tensors) against the
  Pallas ``fused_pivot(..., interpret=True)`` on the same f32 tableau,
  transposed into the port's layout: the update, the identity pass and
  the candidates' sentinel. Integer outputs equal; the f32 tableau and
  costs within 2^-22 of the magnitudes they are formed from (one or two
  roundings of the product and the difference, which XLA:CPU may
  contract into one FMA).
* The f64 walks are held to the JAX package's: status and pivot counts
  equal, objective within 1e-12 relative (``solve`` with default
  options; the sequential loop from one tableau; the plain blocked loop
  under Dantzig, whose f64 eta corrections and window apply are native
  products here and emulated ones there).
* The K6 loop against the JAX ``solve_loop``, both f32: the same walk
  until phase 1's degenerate tail, where f32 rounding breaks the ties.
* ``solve_timed``'s CSV rows against the JAX ``solve_timed``'s.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu.chrono import Chrono as JaxChrono
from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.kernels.pivot import entering_candidates as jax_candidates
from simplex_tpu.kernels.pivot import fused_pivot as jax_fused_pivot
from simplex_tpu.solver import choose_entering as jax_choose_entering
from simplex_tpu.solver import ratio_test as jax_ratio_test
from simplex_tpu.solver import solve_loop as jax_solve_loop
from simplex_tpu.solver import solve_loop_blocked as jax_solve_loop_blocked
from simplex_tpu.tableau import build_phase1, gaussian_eliminate
from simplex_tpu.timed import solve_timed as jax_solve_timed
from simplex_tpu_torch.chrono import Chrono
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.kernels import pivot as kp
from simplex_tpu_torch.solver import (run_solve_loop, solve_loop,
                                      solve_loop_blocked, solve_loop_pallas)
from simplex_tpu_torch.tableau import phase1_objective, tableau_from_numpy

from conftest import DATA

BENCH = DATA / "benchmark_problems"


def _tableau(n=60, m=20, seed=5, **opts):
    """One eliminated phase-1 tableau built by the JAX package from a
    seeded uniform [1, 100] instance, and the JAX / port options."""
    jopt = JaxOptions(**opts)
    rng = np.random.Generator(np.random.Philox(key=seed))
    A = jnp.asarray(rng.uniform(1, 100, (m, n)), jopt.dtype)
    b = jnp.asarray(rng.uniform(1, 100, (m,)), jopt.dtype)
    return gaussian_eliminate(build_phase1(A, b, n, m, jopt)), jopt, \
        SolverOptions(**opts)


def _port(tab):
    return tableau_from_numpy(tab.T, tab.b, tab.costs, tab.z, tab.base,
                              tab.n, tab.m, tab.r)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)) if dtype is None else \
        torch.tensor(np.array(x), dtype=dtype)


def _f32_close(got, want, scale):
    """f32 results formed from terms of magnitude ``scale``: equal up to
    2^-22 of it (a few roundings)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 2.0 ** -22 * (1.0 + scale)).all(), err.max()


# ---------------------------------------------------------------------------
# K6

def test_fused_pivot_matches_pallas():
    tab, _, _ = _tableau(dtype=np.float32)
    eps = 1e-4
    h, minc = jax_choose_entering(tab, jnp.asarray(False), eps)
    a_h = tab.T[h]
    k, unbounded = jax_ratio_test(tab, a_h, eps)
    assert not bool(unbounded)
    want = jax_fused_pivot(tab.T, tab.costs, tab.T[:, k], a_h, a_h[k],
                           minc, k, tab.r, eps, interpret=True)

    Tt = _t(np.asarray(tab.T).T.copy())
    costs = _t(tab.costs)
    colk = Tt[int(k)].clone()
    ah = _t(a_h)
    got = kp.fused_pivot(Tt, costs, colk, ah, _t(a_h[k]), _t(minc),
                         _t(k, torch.int32), tab.r, eps)
    T0 = np.abs(np.asarray(tab.T, np.float64))
    terms = T0 + np.abs(np.asarray(tab.T[:, k], np.float64))[:, None] * \
        np.abs(np.asarray(a_h, np.float64) / float(a_h[k]))[None, :]
    _f32_close(Tt.numpy().T, want[0], terms)
    _f32_close(costs.numpy(), want[1],
               np.abs(np.asarray(tab.costs)) + abs(float(minc) / float(
                   a_h[k])) * np.abs(np.asarray(tab.T[:, k])))
    assert int(got[0]) == int(want[2]) and int(got[2]) == int(want[4])
    _f32_close(got[1].numpy(), want[3], abs(float(want[3])))
    _f32_close(got[3].numpy(), want[5], abs(float(want[5])))
    assert kp.LAUNCHES["fused_pivot"] == 0          # CPU: the plain version


def test_fused_pivot_identity_when_do_is_false():
    tab, _, _ = _tableau(dtype=np.float32)
    want = jax_fused_pivot(tab.T, tab.costs, tab.T[:, 3], tab.T[7],
                           tab.T[7, 3], jnp.asarray(-1.0, jnp.float32),
                           jnp.asarray(3), tab.r, 1e-4,
                           do_pivot=jnp.asarray(False), interpret=True)
    Tt = _t(np.asarray(tab.T).T.copy())
    costs = _t(tab.costs)
    T_before, c_before = Tt.clone(), costs.clone()
    got = kp.fused_pivot(Tt, costs, Tt[3].clone(), Tt[:, 7].clone(),
                         Tt[3, 7].clone(), torch.tensor(-1.0),
                         torch.tensor(3, dtype=torch.int32), tab.r, 1e-4,
                         torch.tensor(False))
    assert torch.equal(Tt, T_before) and torch.equal(costs, c_before)
    np.testing.assert_array_equal(Tt.numpy().T, np.asarray(want[0]))
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[2 + i]))


def test_entering_candidates_sentinel():
    costs = np.array([1.0, 2.0, 3.0, 0.0], np.float32)
    got = kp.entering_candidates(torch.from_numpy(costs), 3, 1e-4)
    want = jax_candidates(jnp.asarray(costs), 3, 1e-4)
    assert int(got[0]) == int(want[0]) == 0 and float(got[1]) == 1.0
    assert int(got[2]) == int(want[2]) == kp.BIG_INDEX
    assert float(got[3]) == float(want[3]) == np.inf


def test_fused_pivot_rejects_misaligned_rows():
    Tt = torch.zeros((8, 6))
    with pytest.raises(ValueError, match="multiple of 4"):
        kp.fused_pivot(Tt, torch.zeros(6), torch.zeros(6), torch.zeros(8),
                       torch.tensor(1.0), torch.tensor(-1.0),
                       torch.tensor(0, dtype=torch.int32), 6, 1e-4)


# ---------------------------------------------------------------------------
# The f64 walks

def _same_result(got, want, rel=1e-12):
    assert got.status == want.status
    assert (got.iterations_phase1, got.iterations_phase2) == \
        (want.iterations_phase1, want.iterations_phase2)
    assert got.objective == pytest.approx(want.objective, rel=rel)
    if want.status == jst.Status.OPTIMAL:
        np.testing.assert_allclose(got.x, want.x, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["smallProblem", "infeasibleProblem",
                                  "unboundedProblem"])
def test_default_solve_matches_jax_on_the_examples(name):
    p = pst.read_problem(DATA / f"{name}.txt")
    _same_result(pst.solve(p, device="cpu"), jst.solve(p))


def test_default_solve_matches_jax_on_random_256_256():
    """The reference's smallest benchmark: 473 + 17 pivots on both."""
    p = pst.read_random_problem(BENCH / "random_256_256.txt")
    got = pst.solve(p, device="cpu")
    _same_result(got, jst.solve(p))
    assert (got.iterations_phase1, got.iterations_phase2) == (473, 17)


def test_degenerate_instance_matches_jax_in_f64():
    A = np.array([[3.0, 1.0, 1.0, 2.0], [-2.0, -1.0, -2.0, -3.0],
                  [0.0, 1.0, 3.0, -2.0], [3.0, 2.0, 0.0, -1.0]])
    p = pst.Problem(A=A, b=np.array([1.0, 0.0, -1.0, 2.0]),
                    c=np.array([1.0, 3.0, 1.0, 3.0]))
    got = pst.solve(p, device="cpu")
    _same_result(got, jst.solve(p))
    assert got.degenerate and got.objective == pytest.approx(1.5, rel=1e-12)
    ref = pst.solve(p, device="cpu", degeneracy="reference")
    assert ref.status == jst.solve(p, degeneracy="reference").status


@pytest.mark.parametrize("rule", ["dantzig", "bland"])
def test_solve_loop_matches_jax(rule):
    tab, jopt, popt = _tableau(n=80, m=25, seed=11, pivot_rule=rule)
    wt, ws, wi = jax_solve_loop(tab, jopt, 2000)
    gt, gs, gi = solve_loop(_port(tab), popt, 2000)
    assert gs == int(ws) == int(Status.OPTIMAL) and gi == int(wi)
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gt.Tt.numpy().T, np.asarray(wt.T),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("cap", [1, 7, 33])
def test_iteration_fuse_is_exact(cap):
    """A capped run stops at the cap even mid-chunk, as the JAX loop
    does; status stays RUNNING."""
    tab, jopt, popt = _tableau(n=80, m=25, seed=11)
    _, ws, wi = jax_solve_loop(tab, jopt, cap)
    _, gs, gi = solve_loop(_port(tab), popt, cap)
    assert gs == int(ws) == int(Status.RUNNING) and gi == int(wi) == cap


@pytest.mark.parametrize("L", [2, 8, 12, 32])
def test_blocked_loop_f64_matches_jax(L):
    tab, jopt, popt = _tableau(n=80, m=25, seed=11, block_pivots=L,
                               pivot_rule="dantzig")
    wt, ws, wi = jax_solve_loop_blocked(tab, jopt, 2000)
    gt, gs, gi = solve_loop_blocked(_port(tab), popt, 2000)
    assert gs == int(ws) == int(Status.OPTIMAL) and gi == int(wi)
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gt.Tt.numpy().T, np.asarray(wt.T),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("rule", [None, "dantzig"], ids=["devex",
                                                         "dantzig"])
def test_blocked_loop_mixed_matches_jax(rule):
    """f32 tableau, f64 vectors, exact re-pricing at every window: the
    mixed walks are held as tests/test_torch_loop.py holds them (equal
    status, a phase-1 optimum, pivots within max(3, 10%))."""
    tab, jopt, popt = _tableau(dtype=np.float32, vector_dtype=np.float64,
                               block_pivots=12, pivot_rule=rule)
    costs0 = np.zeros(tab.rows_padded)
    costs0[tab.n + tab.m:tab.r] = 1.0
    wt, ws, wi = jax_solve_loop_blocked(tab, jopt, 2000, jnp.asarray(costs0))
    gt, gs, gi = solve_loop_blocked(_port(tab), popt, 2000,
                                    torch.from_numpy(costs0))
    assert gs == int(ws) == int(Status.OPTIMAL)
    assert float(phase1_objective(gt)) > -1e-4
    assert abs(gi - int(wi)) <= max(3, int(wi) // 10), (gi, int(wi))


def test_devex_needs_blocks():
    tab, _, popt = _tableau(pivot_rule="devex")
    with pytest.raises(ValueError, match="block_pivots > 1"):
        run_solve_loop(_port(tab), popt, 10)


# ---------------------------------------------------------------------------
# The K6 loop

@pytest.mark.parametrize("rule", ["dantzig", "bland"])
def test_pallas_loop_matches_jax_solve_loop(rule):
    """The JAX package's solve_loop_pallas is solve_loop with the update
    fused, the same walk in exact arithmetic (on the CPU its dispatch
    takes solve_loop). In f32 the two round differently (K6 scales by
    1/p); the walks agree until phase 1's degenerate tail, where z is
    within eps of 0 and the ties fall by rounding (at pivot 45 here
    under Dantzig; the two JAX loops part there too). So: the first 40
    pivots equal, basis and b; the whole walk OPTIMAL on both sides at a
    phase-1 optimum, pivot counts within max(3, 10%)."""
    tab, jopt, popt = _tableau(dtype=np.float32, pivot_rule=rule,
                               use_pallas=True)
    wt, ws, wi = jax_solve_loop(tab, jopt, 40)
    gt, gs, gi = solve_loop_pallas(_port(tab), popt, 40)
    assert gs == int(ws) == int(Status.RUNNING) and gi == int(wi) == 40
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b), rtol=1e-4,
                               atol=1e-4)
    wt, ws, wi = jax_solve_loop(tab, jopt, 2000)
    gt, gs, gi = solve_loop_pallas(_port(tab), popt, 2000)
    assert gs == int(ws) == int(Status.OPTIMAL)
    assert float(phase1_objective(gt)) > -1e-2
    assert abs(gi - int(wi)) <= max(3, int(wi) // 10), (gi, int(wi))
    assert kp.LAUNCHES["fused_pivot"] == 0


# ---------------------------------------------------------------------------
# solve_timed

TIMED_OPS = ["fillTableau", "gauss1", "solve", "solveIterations",
             "checkDegeneracy", "costsVector", "gauss2", "solve",
             "solveIterations", "solution"]


def _csv(directory):
    path = sorted(glob.glob(os.path.join(directory, "times_*.txt")))[-1]
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "vars,contraints,operation,elapsed_time"
    return [line.split(",") for line in lines[1:]]


@pytest.mark.parametrize("per_iteration", [False, True],
                         ids=["aggregate", "per-iteration"])
def test_solve_timed_rows_match_jax(tmp_path, per_iteration):
    p = pst.generate_random_problem(40, 16, 3, 1, 100)
    rows = {}
    for name, fn, chrono, kw in (
            ("port", pst.solve_timed, Chrono, dict(device="cpu")),
            ("jax", jax_solve_timed, JaxChrono, {})):
        d = tmp_path / name
        ch = chrono.open_timestamped(str(d))
        with ch:
            res = fn(p, chrono=ch, per_iteration=per_iteration, **kw)
        rows[name] = (res, _csv(str(d)))
    (got, grows), (want, wrows) = rows["port"], rows["jax"]
    _same_result(got, want)
    # Same operations with the same vars/constraints columns; the pivot
    # counts in the solveIterations rows are equal too.
    assert [r[:3] for r in grows] == [r[:3] for r in wrows]
    assert [r[3] for r in grows if r[2] == "solveIterations"] == \
        [r[3] for r in wrows if r[2] == "solveIterations"]
    solve_rows = [r for r in grows if r[2] == "solve"]
    if per_iteration:
        # One row per step, each phase's exit-detecting step included.
        n1 = sum(r[0] == str(40 + 2 * 16 + 1) for r in solve_rows)
        n2 = sum(r[0] == str(40 + 16 + 1) for r in solve_rows)
        assert (n1, n2) == (got.iterations_phase1 + 1,
                            got.iterations_phase2 + 1)
    else:
        assert [r[2] for r in grows] == TIMED_OPS
        assert [float(r[3]) for r in grows if r[2] == "solveIterations"] \
            == [got.iterations_phase1, got.iterations_phase2]
    assert all(float(r[3]) >= 0 for r in grows)


def test_solve_timed_early_returns_match_jax():
    for name, kw in (("infeasibleProblem", {}),
                     ("unboundedProblem", {}),
                     ("smallProblem", dict(degeneracy="reference"))):
        p = pst.read_problem(DATA / f"{name}.txt")
        got = pst.solve_timed(p, device="cpu", **kw)
        want = jax_solve_timed(p, **kw)
        assert got.status == want.status, name
        assert got.x is None or want.x is not None


def test_solve_timed_mixed_mode_certifies():
    p = pst.generate_random_problem(64, 16, 1, 1, 100)
    opts = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=8)
    got = pst.solve_timed(p, device="cpu", **opts)
    want = jst.solve(p, **opts)
    assert got.status == want.status == Status.OPTIMAL
    assert got.refine.certified
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def test_per_iteration_debug_dumps_every_pivot(capsys, monkeypatch):
    prompts = []
    monkeypatch.setattr("builtins.input",
                        lambda prompt="": prompts.append(prompt) or "")
    p = pst.read_problem(DATA / "smallProblem.txt")
    r = pst.solve_timed(p, per_iteration=True, debug=True, pause=True,
                        device="cpu")
    assert r.status == Status.OPTIMAL
    out = capsys.readouterr().out
    dumps = [line for line in out.splitlines() if line.startswith("--- ")]
    pivots = [d for d in dumps if d.startswith("--- pivot ")]
    assert len(pivots) == r.iterations_phase1 + r.iterations_phase2
    assert len(prompts) == len(dumps)
    assert "Tableau 7 vars x 2 constraints" in out


def test_per_iteration_warns_when_block_pivots_ignored():
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.warns(RuntimeWarning, match="block_pivots=16 is ignored"):
        r = pst.solve_timed(p, per_iteration=True, block_pivots=16,
                            device="cpu")
    assert r.objective == pytest.approx(64.0, abs=1e-9)
