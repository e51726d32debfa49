"""The batched fallback (``simplex_tpu_torch.batch_fallback``) on the CPU,
against ``simplex_tpu.solve_batch(kernel=False)`` (the JAX package's
vmapped-XLA lanes) and against the port's own single-LP ``solve``.

Held per lane:

* the default options (f64, sequential; the lane-batched sequential
  loop): statuses equal, pivot counts equal, objectives within 1e-12
  relative, against the JAX fallback and against ``solve`` (each lane
  walks as ``solve`` walks it);
* the blocked configurations the kernels refuse (``kernel=False`` mixed
  under devex, its default, and Dantzig, f64 blocked, L=12; route (b),
  one lane-batched plain blocked loop a phase): statuses equal, the
  objective within 1e-9 after refinement (1e-12 in f64), pivot counts
  equal in f64 and within max(3, 10%) mixed (mixed walks are not pinned
  across implementations, ROADMAP "The reference"), against the JAX
  fallback and against the lane-by-lane reference
  ``solve_device_lanes``; the loop's lanes against the single-LP
  ``solver.solve_loop_blocked`` (f64: pivot counts equal, vectors within
  1e-12 of their scale);
* a decided lane keeps every bit while the other lanes pivot, in both
  loops, and each lane ends in the state it reaches alone; a premature
  OPTIMAL reopens at the window's re-pricing, a lane decided before the
  window is not re-priced;
* the fleet on two gloo ranks equals one device.
"""

import dataclasses

import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu_torch import batch as pbatch
from simplex_tpu_torch import batch_fallback as fb
from simplex_tpu_torch import solver
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


def _blocked_problems():
    """Four OPTIMAL lanes and an UNBOUNDED one, 30 x 12."""
    return _random(30, 12, range(1, 5)) + [
        jst.generate_random_problem(30, 12, 9, -10, 10)]


def _hold_walks(got, want, f64):
    """Route (b)'s rule: statuses equal; OPTIMAL objectives within 1e-12
    (f64) or 1e-9 and certified (mixed); pivot counts equal (f64) or
    within max(3, 10%) (mixed)."""
    assert len(got) == len(want)
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


BLOCKED_CASES = [
    (MIXED, False),
    (dict(dtype=np.float64, block_pivots=8), "auto"),
    (dict(MIXED, block_pivots=12), "auto"),
    (dict(MIXED, pivot_rule="devex"), False),
    (dict(MIXED, pivot_rule="dantzig"), False),
]
BLOCKED_IDS = ["kernel-false-mixed", "f64-blocked", "L=12",
               "kernel-false-devex", "kernel-false-dantzig"]


@pytest.mark.parametrize("opts,kernel", BLOCKED_CASES, ids=BLOCKED_IDS)
def test_blocked_fallback_matches_jax(opts, kernel, monkeypatch):
    """Route (b): one call of the lane-batched plain blocked loop a phase,
    each over every lane (counted), and never the lane-by-lane
    reference; the walks held to the JAX fallback's."""
    taken = []
    loop = fb.solve_loop_blocked_batched

    def counted(tabs, *args, **kw):
        taken.append(tabs.b.shape[0])
        return loop(tabs, *args, **kw)

    def refused(*args):
        raise AssertionError("solve_device_lanes is on no dispatch path")

    monkeypatch.setattr(fb, "solve_loop_blocked_batched", counted)
    monkeypatch.setattr(fb, "solve_device_lanes", refused)
    problems = _blocked_problems()
    got = pst.solve_batch(problems, device="cpu", kernel=kernel, **opts)
    want = jst.solve_batch(problems, jst.SolverOptions(**opts), kernel=False)
    assert taken == [len(problems)] * 2
    _hold_walks(got, want, np.dtype(opts["dtype"]) == np.float64)


@pytest.mark.parametrize("opts,kernel", BLOCKED_CASES, ids=BLOCKED_IDS)
def test_blocked_route_matches_the_lane_by_lane_reference(opts, kernel):
    """Route (b) against ``solve_device_lanes`` (each lane alone through
    the single-LP device core's plain blocked loop) on the same data:
    statuses, objectives and pivot counts by the same rule, and the
    phase-2 slack blocks within 1e-9 (f64; the mixed walks may part, and
    their objectives are held after refinement, above)."""
    problems = _blocked_problems()
    options = pst.SolverOptions(**opts)
    n, m = 30, 12
    A = torch.from_numpy(np.stack([p.A for p in problems]).astype(
        options.dtype))
    b = torch.from_numpy(np.stack([p.b for p in problems]))
    c = torch.from_numpy(np.stack([p.c for p in problems]))
    got = pbatch.solve_device_batched(A, b, c, n, m, options, kernel)
    want = fb.solve_device_lanes(A, b, c, n, m, options)
    f64 = options.dtype == np.float64
    assert got.binv.shape == (len(problems), m, m)
    for i in range(len(problems)):
        assert int(got.status[i]) == int(want.status[i])
        for a, w in ((got.iterations_phase1[i], want.iterations_phase1[i]),
                     (got.iterations_phase2[i], want.iterations_phase2[i])):
            a, w = int(a), int(w)
            assert a == w if f64 else abs(a - w) <= max(3, 0.1 * w)
        if f64 and int(got.status[i]) == int(pst.Status.OPTIMAL):
            assert float(got.objective[i]) == pytest.approx(
                float(want.objective[i]), rel=1e-12)
            torch.testing.assert_close(got.binv[i], want.binv[i],
                                       rtol=0, atol=1e-9)


@pytest.mark.parametrize("kernel,use_pallas", [(False, False),
                                               (True, "auto")])
def test_kernel_false_restarts_with_the_kernels_off(kernel, use_pallas,
                                                    monkeypatch):
    """``kernel=False`` launches no kernel, the restart rounds of a lane
    that does not certify at once included: they get the options with
    ``use_pallas=False``; with the kernels on they keep the caller's.
    Each lane's first certificate check is made to fail, its restart
    round to raise (as an out-of-memory would), so the finishing tier
    certifies it."""
    import simplex_tpu_torch.refine as prefine
    import simplex_tpu_torch.reinvert as reinvert

    seen, checks = [], []
    certificates_pass = prefine.certificates_pass

    def first_fails(*a, **k):
        checks.append(1)
        return len(checks) % 2 == 0 and certificates_pass(*a, **k)

    def restart(*a, **k):
        seen.append(a[-1].use_pallas)
        raise RuntimeError("simulated out of memory")

    monkeypatch.setattr(prefine, "certificates_pass", first_fails)
    monkeypatch.setattr(reinvert, "restart_device", restart)
    problems = _random(16, 8, range(2))
    res = pst.solve_batch(problems, device="cpu", kernel=kernel, **MIXED)
    assert seen == [use_pallas] * len(problems)
    assert all(r.refine.fallback and r.refine.certified for r in res)


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


BLOCKED_MIXED = dict(MIXED, block_pivots=4, use_pallas=False)


def _phase1(problems, opts):
    """The lanes' eliminated phase-1 tableau and its pre-elimination
    costs, at the single-LP padding."""
    n, m = problems[0].vars, problems[0].constraints
    R1, _, M = padded_dims(n, m, opts)
    A = torch.from_numpy(np.stack([p.A for p in problems]).astype(
        opts.dtype))
    b = torch.from_numpy(np.stack([p.b for p in problems]))
    tabs = batch_build_phase1(A, b, n, m, opts, dims=(R1, M))
    return batch_gaussian_eliminate(tabs), tabs.costs


@pytest.mark.parametrize("opts", [
    BLOCKED_MIXED, dict(dtype=np.float64, block_pivots=4),
    dict(BLOCKED_MIXED, pivot_rule="bland")], ids=["mixed-devex", "f64",
                                                    "mixed-bland"])
def test_blocked_decided_lane_keeps_every_bit(opts):
    """Route (b)'s twin of ``test_decided_lane_keeps_every_bit``: lane 1
    is not live and keeps every bit of its tableau and vectors (its costs
    are not re-priced); some live lane decides a window or more before
    the last one; each live lane ends, bit for bit, in the state
    (tableau, vectors, status, pivots) the loop reaches with that lane
    alone (B = 1)."""
    opts = pst.SolverOptions(**opts)
    problems = [pst.generate_random_problem(20, 10, s, 1, 100)
                for s in (5, 1, 6, 2)]
    tabs, costs0 = _phase1(problems, opts)
    before = {k: getattr(tabs, k).clone()
              for k in ("b", "costs", "z", "base")}
    T1 = tabs.T3[1].clone()
    live = torch.tensor([True, False, True, True])
    out, status, iters, windows = fb.solve_loop_blocked_batched(
        tabs, opts, 10_000, costs0, live=live)
    assert torch.equal(out.T3[1], T1)
    for k, v in before.items():
        assert torch.equal(getattr(out, k)[1], v[1])
    assert int(status[1]) == int(pst.Status.INFEASIBLE) and int(iters[1]) == 0
    alone_windows = []
    for i in (0, 2, 3):
        tab1, c1 = _phase1([problems[i]], opts)
        alone, st1, it1, w1 = fb.solve_loop_blocked_batched(tab1, opts,
                                                            10_000, c1)
        alone_windows.append(w1)
        assert int(st1[0]) == int(status[i]) == int(pst.Status.OPTIMAL)
        assert int(it1[0]) == int(iters[i])
        assert torch.equal(alone.T3[0], out.T3[i])
        for k in ("b", "costs", "z", "base"):
            assert torch.equal(getattr(alone, k)[0], getattr(out, k)[i])
    assert min(alone_windows) < max(alone_windows) == windows


@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex"])
def test_blocked_lanes_walk_as_the_single_lp_loop(rule):
    """Each lane of the lane-batched loop against ``solver.
    solve_loop_blocked`` on the same f64 phase-1 tableau: status and
    pivot count equal, base equal; b, the costs, z and the tableau within
    1e-12 of the largest magnitude each held at the start or the end (or
    of 1): their updates sum the same terms in another order."""
    opts = pst.SolverOptions(dtype=np.float64, block_pivots=4,
                             pivot_rule=rule)
    problems = [pst.generate_random_problem(24, 10, s, 1, 100)
                for s in range(3, 7)]
    tabs, _ = _phase1(problems, opts)
    single = [dataclasses.replace(tabs.lane(i), Tt=tabs.T3[i].clone())
              for i in range(len(problems))]
    start = [(lane.b, lane.costs, lane.z, lane.Tt.clone())
             for lane in single]
    out, status, iters, _ = fb.solve_loop_blocked_batched(tabs, opts,
                                                          10_000)
    for i, lane in enumerate(single):
        want, st1, it1 = solver.solve_loop_blocked(lane, opts, 10_000)
        assert (int(status[i]), int(iters[i])) == (st1, it1)
        assert st1 == int(pst.Status.OPTIMAL) and it1 > 4
        assert torch.equal(out.base[i], want.base)
        for got, ref, first in zip(
                (out.b[i], out.costs[i], out.z[i], out.T3[i]),
                (want.b, want.costs, want.z, want.Tt), start[i]):
            scale = max(1.0, float(ref.abs().max()),
                        float(first.abs().max()))
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-12 * scale)


def test_blocked_window_reopens_a_premature_optimal():
    """One window of two copies of a phase-1 tableau whose working costs
    were zeroed, so that pivot 0 declares OPTIMAL: lane 0, RUNNING when
    the window begins, is re-priced from ``costs0``, which still shows an
    eligible column, and returns to RUNNING; lane 1, OPTIMAL before the
    window, keeps its tableau, zero costs and status bit for bit."""
    opts = pst.SolverOptions(**BLOCKED_MIXED)
    p = pst.generate_random_problem(20, 10, 5, 1, 100)
    tabs, costs0 = _phase1([p, p], opts)
    exact = tabs.costs.clone()
    assert bool((exact[:, :tabs.r] <= -opts.eps_resolved).any())
    tabs.costs = torch.zeros_like(tabs.costs)
    T = tabs.T3.clone()
    B, M, R = tabs.T3.shape
    st = fb.BlockedState(
        tabs, torch.tensor([fb.RUNNING, fb.OPTIMAL], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        torch.zeros(2, dtype=torch.bool),
        w=torch.ones((B, R), dtype=torch.float64),
        C=torch.zeros((B, 4, R), dtype=torch.float32),
        F=torch.zeros((B, 4, M), dtype=torch.float32))
    run = (st.status == fb.RUNNING) & (st.iterations < 100)
    fb.blocked_window(st, run, opts, 100, costs0)
    assert st.status.tolist() == [fb.RUNNING, fb.OPTIMAL]
    assert st.iterations.tolist() == [0, 0]
    assert torch.equal(st.tabs.T3, T)
    assert torch.equal(st.tabs.costs[1], torch.zeros(R, dtype=torch.float64))
    torch.testing.assert_close(st.tabs.costs[0], exact[0], rtol=0,
                               atol=1e-9)


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
