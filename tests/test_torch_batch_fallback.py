"""The batched fallback (``simplex_tpu_torch.batch_fallback``) on the CPU,
against ``simplex_tpu.solve_batch(kernel=False)`` (the JAX package's
vmapped-XLA lanes) and against the port's own single-LP ``solve``.

Held per lane:

* the default options (f64, sequential; the lane-batched sequential
  loop): statuses equal, pivot counts equal, objectives within 1e-12
  relative, against the JAX fallback and against ``solve`` (each lane
  walks as ``solve`` walks it);
* the blocked configurations the kernels refuse (``kernel=False`` mixed,
  f64 blocked, L=12; lane by lane through the plain blocked loop):
  statuses equal, the objective within 1e-9 after refinement (1e-12 in
  f64), pivot counts within max(3, 10%) (mixed walks are not pinned
  across implementations, ROADMAP "The reference");
* a decided lane's tableau keeps every bit while the other lanes pivot;
* the fleet on two gloo ranks equals one device.
"""

import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu_torch import batch as pbatch
from simplex_tpu_torch import batch_fallback as fb
from simplex_tpu_torch.kernels import pivot as kp
from simplex_tpu_torch.tableau import (batch_build_phase1,
                                       batch_gaussian_eliminate, padded_dims)

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
             block_pivots=8)


def _random(n, m, seeds):
    return [jst.generate_random_problem(n, m, s, 1, 100) for s in seeds]


def _spread():
    """Lanes that end OPTIMAL, INFEASIBLE, UNBOUNDED and OPTIMAL."""
    return [jst.Problem(A=np.array(A), b=np.array(b), c=np.array(c))
            for A, b, c in (
                ([[1.0, 0.0], [0.0, 1.0]], [1.0, 2.0], [3.0, 5.0]),
                ([[-1.0, 0.0], [1.0, 0.0]], [-1.0, 0.5], [1.0, 0.0]),
                ([[1.0, 0.0], [1.0, 0.0]], [1.0, 2.0], [1.0, 1.0]),
                ([[1.0, 1.0], [1.0, -1.0]], [4.0, 1.0], [1.0, 2.0]))]


def _same_walks(got, want, rel):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status == w.status, (g.status, w.status)
        assert (g.iterations_phase1, g.iterations_phase2) == (
            w.iterations_phase1, w.iterations_phase2)
        assert g.objective == pytest.approx(w.objective, rel=rel, abs=1e-300)
        if g.status == pst.Status.OPTIMAL:
            np.testing.assert_allclose(g.x, w.x, rtol=1e-9, atol=1e-9)
        else:
            assert g.x is None and w.x is None


@pytest.mark.parametrize("n,m", [(12, 6), (40, 20), (30, 40)])
def test_default_options_match_jax_and_solve(n, m):
    problems = _random(n, m, range(1, 5))
    got = pst.solve_batch(problems, device="cpu")
    _same_walks(got, jst.solve_batch(problems, kernel=False), 1e-12)
    _same_walks(got, [pst.solve(p, device="cpu") for p in problems], 1e-12)
    assert all(r.refine is None for r in got)


def test_status_spread_matches_jax():
    problems = _spread()
    got = pst.solve_batch(problems, device="cpu")
    assert [r.status for r in got] == [
        pst.Status.OPTIMAL, pst.Status.INFEASIBLE, pst.Status.UNBOUNDED,
        pst.Status.OPTIMAL]
    _same_walks(got, jst.solve_batch(problems, kernel=False), 1e-12)
    assert got[0].objective == 13.0


@pytest.mark.parametrize("opts", [
    dict(dtype=np.float32, vector_dtype=np.float64),
    dict(dtype=np.float32, vector_dtype=np.float32, eps=1e-4),
    dict(pivot_rule="bland"),
    dict(degeneracy="reference"),
], ids=["mixed-sequential", "f32-sequential", "bland", "reference"])
def test_sequential_options_match_jax(opts):
    """The other sequential configurations of route (a): the same
    statuses as the JAX fallback and the port's ``solve`` lane by lane,
    the same walks as ``solve`` (objectives at 1e-9 after the mixed
    mode's refinement, 1e-6 for a pure-f32 tableau) and, against JAX,
    pivot counts within max(3, 10%) where the tableau is f32."""
    problems = _random(24, 10, range(3, 7))
    got = pst.solve_batch(problems, device="cpu", **opts)
    single = [pst.solve(p, device="cpu", **opts) for p in problems]
    want = jst.solve_batch(problems, jst.SolverOptions(**opts), kernel=False)
    rel = 1e-6 if opts.get("vector_dtype") == np.float32 else 1e-9
    for g, s, w in zip(got, single, want):
        assert g.status == s.status == w.status
        assert (g.iterations_phase1, g.iterations_phase2) == (
            s.iterations_phase1, s.iterations_phase2)
        assert g.objective == pytest.approx(s.objective, rel=rel)
        assert g.objective == pytest.approx(w.objective, rel=rel)
        for a, b in ((g.iterations_phase1, w.iterations_phase1),
                     (g.iterations_phase2, w.iterations_phase2)):
            assert abs(a - b) <= max(3, 0.1 * b)
        if g.status == pst.Status.OPTIMAL and opts.get(
                "vector_dtype") == np.float64:
            assert g.refine.certified


def test_devex_sequential_raises_like_solve():
    with pytest.raises(ValueError, match="devex"):
        pst.solve_batch(_random(8, 4, [1]), device="cpu", pivot_rule="devex")


@pytest.mark.parametrize("opts,kernel", [
    (MIXED, False),
    (dict(dtype=np.float64, block_pivots=8), "auto"),
    (dict(MIXED, block_pivots=12), "auto"),
], ids=["kernel-false-mixed", "f64-blocked", "L=12"])
def test_blocked_fallback_matches_jax(opts, kernel, monkeypatch):
    """Route (b), lane by lane through the plain blocked loop (asserted
    by counting the lanes it took)."""
    taken = []
    lanes = fb.solve_device_lanes

    def counted(A, *args):
        taken.append(A.shape[0])
        return lanes(A, *args)

    monkeypatch.setattr(fb, "solve_device_lanes", counted)
    problems = _random(30, 12, range(1, 5)) + _spread()[1:3]
    problems = problems[:4] + [jst.generate_random_problem(30, 12, 9, -10,
                                                           10)]
    got = pst.solve_batch(problems, device="cpu", kernel=kernel, **opts)
    want = jst.solve_batch(problems, jst.SolverOptions(**opts), kernel=False)
    assert taken == [len(problems)]
    f64 = np.dtype(opts["dtype"]) == np.float64
    for g, w in zip(got, want):
        assert g.status == w.status
        if g.status == pst.Status.OPTIMAL:
            assert g.objective == pytest.approx(
                w.objective, rel=1e-12 if f64 else 1e-9)
            if not f64:
                assert g.refine.certified and w.refine.certified
        for a, b in ((g.iterations_phase1, w.iterations_phase1),
                     (g.iterations_phase2, w.iterations_phase2)):
            if f64:
                assert a == b
            else:
                assert abs(a - b) <= max(3, 0.1 * b)


def test_kernel_dispatch():
    """``kernel="auto"`` takes the kernels where the options allow and the
    fallback elsewhere; True forces the kernels (and refuses options they
    do not take); False forces the fallback."""
    assert pbatch.batch_kernel_eligible(pst.SolverOptions(**MIXED))
    for opts in ({}, dict(MIXED, block_pivots=12),
                 dict(MIXED, dtype=np.float64), dict(MIXED, use_pallas=False),
                 dict(MIXED, block_pivots=1)):
        assert not pbatch.batch_kernel_eligible(pst.SolverOptions(**opts))
    assert pbatch.batch_kernel_eligible(pst.SolverOptions(
        **dict(MIXED, block_pivots=12, batch_block_pivots=16)))
    with pytest.raises(ValueError, match="kernel=True"):
        pst.solve_batch(_random(8, 4, [1]), device="cpu", kernel=True)
    problems = _random(16, 8, range(2))
    a = pst.solve_batch(problems, device="cpu", kernel=False, **MIXED)
    b = pst.solve_batch(problems, device="cpu", kernel=True, **MIXED)
    assert [r.status for r in a] == [r.status for r in b]


def test_decided_lane_keeps_every_bit():
    """Lane 1 starts decided (not live) and lane 0 decides early: while
    the others pivot, lane 1's tableau and vectors keep every bit, and
    lane 0 ends with exactly the state it reaches alone."""
    problems = [jst.generate_random_problem(20, 10, 5, 1, 100),
                jst.generate_random_problem(20, 10, 6, 1, 100),
                jst.generate_random_problem(20, 10, 7, 1, 100)]
    opts = pst.SolverOptions()
    n, m = 20, 10
    R1, _, M = padded_dims(n, m, opts)

    def build(ps):
        A = torch.from_numpy(np.stack([p.A for p in ps]))
        b = torch.from_numpy(np.stack([p.b for p in ps]))
        return batch_gaussian_eliminate(batch_build_phase1(
            A, b, n, m, opts, dims=(R1, M)))

    tabs = build(problems)
    before = {k: getattr(tabs, k).clone()
              for k in ("b", "costs", "z", "base")}
    T1 = tabs.T3[1].clone()
    live = torch.tensor([True, False, True])
    out, status, iters, steps = fb.solve_loop_seq_batched(
        tabs, opts, 10_000, live=live)
    assert torch.equal(out.T3[1], T1)
    for k, v in before.items():
        assert torch.equal(getattr(out, k)[1], v[1])
    assert int(status[1]) == int(pst.Status.INFEASIBLE)
    assert int(iters[1]) == 0 and int(iters[0]) > 0 and int(iters[2]) > 0
    assert steps % 32 == 0 and steps >= int(iters.max())
    for i in (0, 2):
        alone, st1, it1, _ = fb.solve_loop_seq_batched(build([problems[i]]),
                                                       opts, 10_000)
        assert int(st1[0]) == int(status[i]) == int(pst.Status.OPTIMAL)
        assert int(it1[0]) == int(iters[i])
        assert torch.equal(alone.T3[0], out.T3[i])
        for k in ("b", "costs", "z", "base"):
            assert torch.equal(getattr(alone, k)[0], getattr(out, k)[i])


def test_batch_rank1_plain_is_the_single_lp_update():
    """The batched update's plain version: bit for bit the single-LP
    ``solver.pivot_update``'s update of its tableau, ``Tt.addr_(factor,
    colk, alpha=-1)`` (on the CPU one FMA an element), on each lane whose
    flag is set; a lane whose flag is clear is not touched (a -0.0 stays
    -0.0, where a masked update would make it +0.0)."""
    g = torch.Generator().manual_seed(3)
    T3 = torch.rand((3, 8, 12), generator=g, dtype=torch.float64) - 0.5
    T3[1, 0, 0] = -0.0
    factor = torch.rand((3, 8), generator=g, dtype=torch.float64)
    colk = torch.rand((3, 12), generator=g, dtype=torch.float64)
    do = torch.tensor([True, False, True])
    want = T3.clone()
    for i in (0, 2):
        want[i].addr_(factor[i], colk[i], alpha=-1.0)
    kp.batch_rank1(T3, factor, colk, do)
    assert torch.equal(T3, want)
    assert torch.signbit(T3[1, 0, 0])
    with pytest.raises(ValueError, match="factor"):
        kp.batch_rank1(T3, factor.float(), colk, do)
    assert kp.LAUNCHES["batch_rank1"] == 0


def test_fleet_with_the_fallback_equals_one_device():
    from simplex_tpu_torch.batch import solve_batched_rank
    from simplex_tpu_torch.parallel.group import spawn

    problems = [pst.generate_random_problem(24, 10, s, 1, 100)
                for s in range(4)]
    got = spawn(solve_batched_rank, 2, "gloo", "cpu", problems,
                pst.SolverOptions())
    want = pst.solve_batch(problems, device="cpu")
    for g, w in zip(got, want):
        assert g.status == w.status
        assert (g.iterations_phase1, g.iterations_phase2) == (
            w.iterations_phase1, w.iterations_phase2)
        assert g.objective == w.objective
        np.testing.assert_array_equal(g.x, w.x)


def test_stats_count_the_steps():
    stats = {}
    problems = _random(12, 6, range(2))
    res = pst.solve_batch(problems, device="cpu", stats=stats)
    s1, s2 = stats["windows"]
    assert s1 % 32 == 0 and s2 % 32 == 0
    assert s1 >= max(r.iterations_phase1 for r in res)
    assert s2 >= max(r.iterations_phase2 for r in res)
    assert stats["bases"].shape == (2, padded_dims(12, 6,
                                                   pst.SolverOptions())[2])
