"""The port's batched solve, ``simplex_tpu_torch.solve_batch(device="cpu")``
(the plain versions of the batched kernels), against
``simplex_tpu.solve_batch(kernel="interpret")`` on the same seeded
problems, with the JAX batch tests' options (mixed precision, L=8,
eps=1e-5, devex).

Held per lane:

* statuses equal;
* where OPTIMAL, both refined and certified, and the objectives within
  1e-9 relative: the f64 refinement makes the objective a property of
  the final basis, not of the walk;
* pivot counts within max(3, 10%): mixed walks are not pinned across
  implementations (the JAX loop folds f32 hi parts, the port f64
  values, so near-ties may go either way), ROADMAP's holding rules;
* lane independence: each lane of a batch equals, exactly, a batch of
  that lane alone.

Also the batched tableau functions against the JAX package's own, vmapped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
import simplex_tpu_torch.batch as pbatch
from simplex_tpu import tableau as jtab
from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.problem import Problem
from simplex_tpu_torch import tableau as ptab

OPT = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=8,
           eps=1e-5)


def _random(n, m, seeds):
    return [jst.generate_random_problem(n, m, s, 1, 100) for s in seeds]


def _spread():
    """The JAX batch tests' status spread (n=2, m=2)."""
    return [
        Problem(A=np.array([[1.0, 0.0], [0.0, 1.0]]),
                b=np.array([1.0, 2.0]), c=np.array([3.0, 5.0])),
        Problem(A=np.array([[1.0, 0.0], [1.0, 0.0]]),
                b=np.array([1.0, 2.0]), c=np.array([1.0, 1.0])),
        Problem(A=np.array([[-1.0, 0.0], [1.0, 0.0]]),
                b=np.array([-1.0, 0.5]), c=np.array([1.0, 0.0])),
    ]


def _degenerate():
    """Redundant duplicate row + zero right-hand side; an equality as a
    <= / >= pair (tests/test_batched_kernel.py)."""
    return [
        Problem(A=np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
                            [1.0, -1.0, 0.0]]),
                b=np.array([4.0, 4.0, 0.0]), c=np.array([2.0, 3.0, 1.0])),
        Problem(A=np.array([[1.0, 1.0, 0.0], [-1.0, -1.0, 0.0],
                            [1.0, 0.0, 0.0]]),
                b=np.array([3.0, -3.0, 2.0]), c=np.array([1.0, 2.0, 0.0])),
    ]


def _compare(problems, stats=None, **extra):
    got = pst.solve_batch(problems, device="cpu", stats=stats, **OPT, **extra)
    want = jst.solve_batch(problems, JaxOptions(**OPT, **extra),
                           kernel="interpret")
    assert len(got) == len(want) == len(problems)
    for g, w in zip(got, want):
        assert g.status == w.status, (g.status, w.status)
        if g.status == pst.Status.OPTIMAL:
            assert g.refine.certified and w.refine.certified
            assert g.objective == pytest.approx(w.objective, rel=1e-9)
            assert np.isfinite(g.x).all() and g.x.shape == w.x.shape
        for a, b in ((g.iterations_phase1, w.iterations_phase1),
                     (g.iterations_phase2, w.iterations_phase2)):
            assert abs(a - b) <= max(3, 0.1 * b), (a, b)
    return got, want


def test_status_spread_matches_jax():
    got, _ = _compare(_spread())
    assert [g.status for g in got] == [pst.Status.OPTIMAL,
                                       pst.Status.UNBOUNDED,
                                       pst.Status.INFEASIBLE]
    assert got[0].objective == pytest.approx(13.0, rel=1e-12)


def test_random_lanes_match_jax():
    got, _ = _compare(_random(24, 10, (1, 2, 3, 4)))
    assert all(g.status == pst.Status.OPTIMAL for g in got)


def test_several_windows_match_jax():
    stats = {}
    got, _ = _compare(_random(60, 12, (7, 8)), stats=stats)
    assert stats["windows"][0] >= 3          # phase 1 spans windows
    assert all(g.status == pst.Status.OPTIMAL for g in got)


def test_fuse_lane_matches_jax():
    """max_iter=14: the lane that needs 14 phase-1 pivots stops at the fuse
    (MAXITER, exactly 14 pivots, as the reference's per-pivot fuse), the
    others finish."""
    got, want = _compare(_random(24, 10, (1, 2, 3, 4)), max_iter=14)
    statuses = [g.status for g in got]
    assert pst.Status.MAXITER in statuses and pst.Status.OPTIMAL in statuses
    for g, w in zip(got, want):
        if g.status == pst.Status.MAXITER:
            assert g.iterations_phase1 == w.iterations_phase1 == 14
            assert g.x is None


def test_degenerate_lane_is_repaired(monkeypatch):
    """pivot_out_artificials runs on the lane that needs it, and only
    there; the repaired lane solves as the JAX package solves it."""
    repaired = []
    real = pbatch.pivot_out_artificials

    def spy(tab, options):
        repaired.append(tab.base.clone())
        return real(tab, options)

    monkeypatch.setattr(pbatch, "pivot_out_artificials", spy)
    got, want = _compare(_degenerate())
    assert [g.degenerate for g in got] == [w.degenerate for w in want] \
        == [False, True]
    assert len(repaired) == 1


def test_lanes_are_independent():
    """Each lane of a B=4 batch equals a B=1 batch of that lane: the same
    walk, basis-derived objective and x, bit for bit."""
    problems = _random(24, 10, (11, 12, 13, 14))
    together = pst.solve_batch(problems, device="cpu", **OPT)
    for p, g in zip(problems, together):
        (alone,) = pst.solve_batch([p], device="cpu", **OPT)
        assert g.status == alone.status == pst.Status.OPTIMAL
        assert (g.iterations_phase1, g.iterations_phase2) == (
            alone.iterations_phase1, alone.iterations_phase2)
        assert g.objective == alone.objective
        np.testing.assert_array_equal(g.x, alone.x)


def test_batch_tableau_matches_jax():
    """The batched build (dims override), elimination, phase-2 reset (cut
    to R2), extraction, phase-1 objective and artificial count against
    the JAX functions vmapped, on one state: f32 tableau and the
    elimination's f64 costs to 1e-12 relative (only the summation order
    differs), the rest exact."""
    n, m, R1, R2, M = 24, 10, 128, 128, 128
    opts = JaxOptions(**OPT)
    problems = _random(n, m, (5, 6, 7))
    problems[1].b[3] = -5.0                            # a flipped row
    A = np.stack([p.A for p in problems])
    b = np.stack([p.b for p in problems])
    c = np.stack([p.c for p in problems])
    jt = jax.vmap(lambda Ai, bi: jtab.build_phase1(
        Ai, bi, n, m, opts, dims=(R1, M)))(jnp.asarray(A, jnp.float32),
                                           jnp.asarray(b))
    pt = ptab.batch_build_phase1(torch.from_numpy(A.astype(np.float32)),
                                 torch.from_numpy(b), n, m,
                                 pst.SolverOptions(**OPT), dims=(R1, M))
    np.testing.assert_array_equal(
        pt.Tt.numpy(),
        np.asarray(jt.T).transpose(0, 2, 1).reshape(3 * M, R1))
    for name in ("b", "costs", "z", "base"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))

    je = jax.vmap(jtab.gaussian_eliminate)(jt)
    pe = ptab.batch_gaussian_eliminate(pt)
    np.testing.assert_allclose(pe.costs.numpy(), np.asarray(je.costs),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pe.z.numpy(), np.asarray(je.z), rtol=1e-12)
    np.testing.assert_array_equal(
        ptab.batch_phase1_objective(pe).numpy(),
        np.asarray(jax.vmap(jtab.phase1_objective)(je)))
    np.testing.assert_array_equal(
        ptab.batch_count_basic_artificials(pe).numpy(),
        np.asarray(jax.vmap(jtab.count_basic_artificials)(je)))

    j2 = jax.vmap(lambda t, ci: jtab.phase2_reset(t, ci, opts, r2_pad=R2))(
        je, jnp.asarray(c))
    p2 = ptab.batch_phase2_reset(pe, torch.from_numpy(c), R2)
    assert p2.Tt.shape == (3 * M, R2) and p2.r == j2.r == n + m
    np.testing.assert_array_equal(
        p2.Tt.numpy(), np.asarray(j2.T).transpose(0, 2, 1).reshape(3 * M, R2))
    np.testing.assert_array_equal(p2.costs.numpy(), np.asarray(j2.costs))
    np.testing.assert_array_equal(
        ptab.batch_extract_solution(p2).numpy(),
        np.asarray(jax.vmap(jtab.extract_solution)(j2)))


def test_batch_from_numpy_takes_both_layouts():
    """A batched JAX ``T (B, R, M)`` and the kernels' ``Tt (B*M, R)`` give
    one state."""
    rng = np.random.default_rng(0)
    T = rng.uniform(-1, 1, (2, 256, 128)).astype(np.float32)
    vecs = (rng.uniform(size=(2, 128)), rng.uniform(size=(2, 256)),
            rng.uniform(size=2), rng.integers(0, 256, (2, 128)))
    a = ptab.batch_from_numpy(T, *vecs, n=100, m=50, r=200)
    b = ptab.batch_from_numpy(T.transpose(0, 2, 1).reshape(256, 256), *vecs,
                              n=100, m=50, r=200)
    assert torch.equal(a.Tt, b.Tt) and a.Tt.shape == (256, 256)
    assert torch.equal(a.T3[1], torch.from_numpy(T[1].T.copy()))
    assert a.base.dtype == torch.int32 and a.lane(1).Tt.data_ptr() \
        == a.Tt[128:].data_ptr()


def test_drifted_lane_certifies_through_restart():
    """Config 3's seed 1122 (lane 122): the mixed walk stops at a basis
    whose f64 dual infeasibility is 7e-5 of the scale; the lane's
    refinement fails, and a reinversion restart from its slack block
    certifies it, as solve() certifies the same instance."""
    p = pst.generate_random_problem(2000, 500, 1122, 1, 100)
    opts = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
                block_pivots=32)
    (got,) = pst.solve_batch([p], device="cpu", **opts)
    assert got.status == pst.Status.OPTIMAL
    assert got.refine.certified and got.refine.method == "restart"
    want = pst.solve(p, device="cpu", **opts)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
