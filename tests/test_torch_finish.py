"""The port's f64 finishing tiers against the JAX package's, on the CPU.

* ``finish.finish_from_basis`` from both packages on the same bases
  (tests/test_finish.py: optimal and suboptimal primal-feasible bases, a
  singular one, negative right-hand sides, a mixed solve's final basis):
  the same status, finishing pivots and objective, exactly (the port
  carries its own copy of the host code: the same arithmetic in the same
  order).
* ``two_phase.fallback_solve`` without a basis (the full f64 re-solve on
  the device, refined against the host data): certified, at the oracle's
  objective within 1e-12 and the JAX fallback's.
* A mixed ``solve`` whose certificates fail goes through ``certify``'s
  tiers to the finishing tier, with the restart tier raising as an
  out-of-memory would; so do ``solve_sharded`` and ``solve_timed``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu import two_phase as jtp
from simplex_tpu.finish import finish_from_basis as jax_finish
from simplex_tpu.oracle import _build_phase1, _gaussian_eliminate, \
    _solve_loop, _Tableau
from simplex_tpu_torch import two_phase
from simplex_tpu_torch.finish import WARM_TABLEAU_BYTE_CAP, \
    finish_from_basis

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=16)


def _suboptimal_feasible_basis(p, stop_short: int):
    """tests/test_finish.py's primal-feasible, suboptimal basis: the
    oracle's own f64 walk with phase 2 capped ``stop_short`` pivots
    early."""
    n, m = p.vars, p.constraints
    opts = jst.SolverOptions()
    t = _build_phase1(p, 1e-9)
    _gaussian_eliminate(t)
    st, _ = _solve_loop(t, np.ones(n + 2 * m, bool), opts, 100000)
    assert st == jst.Status.OPTIMAL
    t2 = _Tableau(t.T[:n + m], t.b,
                  np.concatenate([-p.c.astype(np.float64), np.zeros(m)]),
                  t.z, t.base)
    _gaussian_eliminate(t2)
    full = jst.solve_oracle(p)
    _solve_loop(t2, np.ones(n + m, bool), opts,
                max(full.iterations_phase2 - stop_short, 0))
    return t2.base.copy()


def _mixed_basis(p):
    """A mixed solve's final basis (the JAX device core's, so that both
    finishers start from one basis: mixed walks are not pinned across
    the packages)."""
    opts = jst.SolverOptions(**MIXED, refine=False)
    out = jtp.solve_device(jnp.asarray(p.A), jnp.asarray(p.b),
                           jnp.asarray(p.c), p.vars, p.constraints, opts)
    assert int(out.status) == int(jst.Status.OPTIMAL)
    return np.asarray(out.base), MIXED


def _case(name):
    """(problem, base, options) of a tests/test_finish.py case."""
    if name.startswith("short-"):
        p = jst.generate_random_problem(120, 48, 11, 1, 100)
        return p, _suboptimal_feasible_basis(p, int(name[6:])), {}
    if name == "optimal":
        p = jst.generate_random_problem(80, 32, 7, 1, 100)
        return p, _suboptimal_feasible_basis(p, 0), {}
    if name == "singular":
        p = jst.generate_random_problem(40, 16, 5, 1, 100)
        return p, np.zeros(16, np.int64), {}
    if name == "negative-rhs":
        p = jst.Problem(A=np.array([[-1.0, -1.0], [1.0, 2.0]]),
                        b=np.array([-1.0, 10.0]), c=np.array([1.0, 1.0]))
        return p, _suboptimal_feasible_basis(p, 1), {}
    if name == "mixed":
        p = jst.generate_random_problem(150, 60, 21, 1, 100)
        return (p, *_mixed_basis(p))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["optimal", "short-1", "short-3",
                                  "short-8", "singular", "negative-rhs",
                                  "mixed"])
def test_finish_from_basis_matches_jax(name):
    p, base, opts = _case(name)
    want = jax_finish(p, base, jst.SolverOptions(**opts))
    got = finish_from_basis(pst.Problem(A=p.A, b=p.b, c=p.c), base.copy(),
                            pst.SolverOptions(**opts))
    if want is None:
        assert got is None
        assert name == "singular"
        return
    assert got.status == want.status == pst.Status.OPTIMAL
    assert (got.iterations_phase1, got.iterations_phase2) == (
        want.iterations_phase1, want.iterations_phase2)
    assert got.objective == want.objective
    np.testing.assert_array_equal(got.x, want.x)
    assert got.refine.certified and got.refine.method == "finish"
    oracle = jst.solve_oracle(p)
    assert got.objective == pytest.approx(oracle.objective, rel=1e-12)
    if name.startswith("short-"):
        assert 0 < got.iterations_phase2 <= 3 * int(name[6:]) + 5


def test_finish_refuses_a_tableau_past_the_cap():
    """The flagship-scale escape hatch: a warm tableau of more than
    ``WARM_TABLEAU_BYTE_CAP`` bytes is not built (the JAX constant)."""
    from simplex_tpu.finish import WARM_TABLEAU_BYTE_CAP as jax_cap

    assert WARM_TABLEAU_BYTE_CAP == jax_cap
    m = 4
    n = WARM_TABLEAU_BYTE_CAP // (8 * m)       # (n + m) m 8 > the cap
    p = pst.Problem(A=np.ones((m, 1)), b=np.ones(m), c=np.ones(1))
    p.A = np.broadcast_to(np.ones((m, 1)), (m, n))    # no memory
    p.c = np.broadcast_to(np.ones(1), (n,))
    assert finish_from_basis(p, np.arange(n, n + m), pst.SolverOptions()) \
        is None


@pytest.mark.parametrize("opts", [MIXED, dict(MIXED, block_pivots=1)],
                         ids=["mixed-blocked", "mixed-sequential"])
def test_fallback_solve_without_basis_is_certified(opts):
    """The full f64 re-solve (``fallback_options``: an f64 tableau, eps
    re-resolved to 1e-9, refinement off) refined against the host data:
    certified (method "tableau"), at the oracle's objective and the JAX
    fallback's."""
    p = pst.generate_random_problem(100, 40, 5, 1, 100)
    got = two_phase.fallback_solve(p, pst.SolverOptions(**opts),
                                   device="cpu")
    want = jtp.fallback_solve(p, jst.SolverOptions(**opts))
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified and want.refine.certified
    assert got.refine.method == want.refine.method == "tableau"
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.objective == pytest.approx(jst.solve_oracle(p).objective,
                                          rel=1e-12)
    fo = two_phase.fallback_options(pst.SolverOptions(**opts))
    assert fo.dtype == fo.vector_dtype == np.float64
    assert fo.eps_resolved == 1e-9 and fo.refine is False


def test_forced_fallback_lands_on_oracle(monkeypatch):
    """tests/test_finish.py's forced fallback through the port's
    ``solve``: the restart tier raises (as an out-of-memory would) and
    every mixed-tier refinement reports failure, so ``certify`` hands the
    last basis to ``fallback_solve``; the warm finish lands on the
    oracle's objective, certified and marked ``fallback``."""
    import simplex_tpu_torch.reinvert as reinvert

    refine_result = two_phase.refine_result
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("simulated out of memory")

    def failing(*a, **k):
        rx, robj, info, ro = refine_result(*a, **k)
        return None, None, info._replace(certified=False), ro

    monkeypatch.setattr(reinvert, "restart_device", boom)
    monkeypatch.setattr(two_phase, "refine_result", failing)
    p = pst.generate_random_problem(100, 40, 5, 1, 100)
    r = pst.solve(p, device="cpu", **MIXED)
    assert calls == [1]
    assert r.status == pst.Status.OPTIMAL
    assert r.refine.fallback and r.refine.certified
    assert r.refine.method == "finish"
    assert r.objective == pytest.approx(jst.solve_oracle(p).objective,
                                        rel=1e-12)


@pytest.mark.parametrize("entry", ["solve_sharded", "solve_timed",
                                   "solve_resumable",
                                   "solve_resumable_sharded"])
def test_other_entry_points_reach_the_finishing_tier(entry, monkeypatch,
                                                     tmp_path):
    """``solve_sharded`` (one gloo rank in this process), ``solve_timed``
    and the checkpointed solves ``solve_resumable`` and
    ``solve_resumable_sharded`` (one gloo rank) reach ``fallback_solve``
    through ``certify`` when the mixed tiers do not certify: the
    finishing tier's certified result, marked ``fallback``, at the
    oracle's objective; the sharded and checkpointed solves return it
    whole (``simplex_tpu/parallel/sharded.py:1213-1228``; the JAX
    package's checkpointed solves stop uncertified there, the port's
    certify as ``solve`` does), the timed one with its own walk's pivot
    counts (``simplex_tpu/timed.py:309-321``)."""
    from simplex_tpu_torch.checkpoint import solve_resumable_sharded
    from simplex_tpu_torch.parallel.group import world

    refine_result = two_phase.refine_result

    def failing(*a, **k):
        rx, robj, info, ro = refine_result(*a, **k)
        return None, None, info._replace(certified=False), ro

    p = pst.generate_random_problem(100, 40, 5, 1, 100)
    opts = pst.SolverOptions(**MIXED)
    if entry == "solve_timed":
        walk = pst.solve_timed(p, opts, device="cpu")
    monkeypatch.setattr(two_phase, "refine_result", failing)
    ckpt = str(tmp_path / "state.npz")
    if entry in ("solve_sharded", "solve_resumable_sharded"):
        with world(0, 1, "gloo", str(tmp_path)) as group:
            if entry == "solve_sharded":
                r = pst.solve_sharded(p, group, opts, device="cpu")
            else:
                r = solve_resumable_sharded(p, group, ckpt, 50, opts,
                                            device="cpu")
    elif entry == "solve_resumable":
        r = pst.solve_resumable(p, ckpt, 50, opts, device="cpu")
    if entry != "solve_timed":
        assert r.refine.method == "finish"
        assert r.iterations_phase1 == 0
    else:
        r = pst.solve_timed(p, opts, device="cpu")
        assert (r.iterations_phase1, r.iterations_phase2) == (
            walk.iterations_phase1, walk.iterations_phase2)
    assert r.status == pst.Status.OPTIMAL
    assert r.refine.fallback and r.refine.certified
    assert r.objective == pytest.approx(jst.solve_oracle(p).objective,
                                        rel=1e-12)


@pytest.mark.parametrize("dual,finished", [(0.0, False), (0.5, False),
                                           (100.0, True)],
                         ids=["exact", "inside", "eps-short"])
def test_certify_holds_the_dual_to_the_strong_bound(dual, finished,
                                                    monkeypatch):
    """A basis whose refinement certifies at ``refine_tol`` but whose
    dual infeasibility exceeds ``dual`` x 1e-9 (1 + max|c|) with ``dual``
    > 1 -- the walk stopped within the pricing eps of a better vertex --
    goes straight to the finishing tier (no restart round: the loop
    would stop at the same eps) and comes back at the oracle's
    objective, marked ``fallback``; one within the bound is returned as
    refined."""
    import simplex_tpu_torch.reinvert as reinvert
    from simplex_tpu_torch.refine import STRONG_TOL

    p = pst.generate_random_problem(100, 40, 5, 1, 100)
    bound = STRONG_TOL * (1.0 + float(np.max(np.abs(p.c))))
    refine_result = two_phase.refine_result
    seen = []

    def short(*a, **k):
        rx, robj, info, ro = refine_result(*a, **k)
        assert rx is not None and info.dual_infeasibility == 0.0
        seen.append(info)
        return rx, robj, info._replace(dual_infeasibility=dual * bound), ro

    def no_restart(*a, **k):
        raise AssertionError("a restart round ran")

    monkeypatch.setattr(two_phase, "refine_result", short)
    monkeypatch.setattr(reinvert, "restart_device", no_restart)
    r = pst.solve(p, device="cpu", **MIXED)
    assert len(seen) == 1
    assert r.status == pst.Status.OPTIMAL and r.refine.certified
    assert r.refine.fallback == finished
    assert r.refine.method == ("finish" if finished else "tableau")
    assert r.objective == pytest.approx(jst.solve_oracle(p).objective,
                                        rel=1e-12)


def test_batch_lane_holds_the_dual_to_the_strong_bound(monkeypatch):
    """``solve_batch``'s lanes keep the same rule: a lane whose host
    refinement certifies at ``refine_tol`` short of the strong dual bound
    takes the finishing tier, the others keep their refinement."""
    import torch

    import simplex_tpu_torch.refine as refine
    from simplex_tpu_torch.refine import STRONG_TOL

    problems = [pst.generate_random_problem(60, 20, s, 1, 100)
                for s in (3, 4)]
    host = refine.refine_solution_host
    short_c = problems[1].c

    def short(A, b, c, base, n, m):
        ro = host(A, b, c, base, n, m)
        if np.array_equal(c, short_c):
            bound = STRONG_TOL * (1.0 + float(np.max(np.abs(c))))
            ro = ro._replace(dual_infeasibility=torch.tensor(
                100.0 * bound, dtype=torch.float64))
        return ro

    monkeypatch.setattr(refine, "refine_solution_host", short)
    got = pst.solve_batch(problems, device="cpu", dtype=np.float32,
                          vector_dtype=np.float64, eps=1e-5,
                          block_pivots=8)
    assert [r.refine.fallback for r in got] == [False, True]
    for r, p in zip(got, problems):
        assert r.status == pst.Status.OPTIMAL and r.refine.certified
        assert r.objective == pytest.approx(jst.solve_oracle(p).objective,
                                            rel=1e-12)
