"""The blocked-kernel loop's per-pivot step and its fixed state, on the CPU.

* The step's plain versions (``kernels.blocked.step_pre`` on CPU tensors,
  ``step_mid_plain``, ``step_post_plain``) against the eager glue they
  replace, written out here as the loop ran it: every output equal, over
  a grid of pivots (done, skipped, at the fuse, optimal, unbounded, Bland
  on and off, the stall reaching the threshold) under each anti-cycling
  policy.
* K1 and K2 with the steps as their tails (``ah_ratio_tail``,
  ``colk_costs_tail`` on CPU tensors) against the four calls they fold --
  K1, ``step_mid_plain``, K2, ``step_post_plain`` -- on a small seeded
  tableau over the same grid: every scalar and vector equal; K2's
  ``base[k]`` and weights take the h its tail then rewrites; and
  ``run_window`` enqueues ``step_pre`` and two launches a pivot.
* ``CapturedLaunches``: a capture counts nothing, a replay the graph's
  launches.
* ``solve_loop_blocked_kernel`` keeps every carried tensor in one storage
  from its first window to its last, under devex and Dantzig, with
  ``costs0`` and without: on the card a CUDA graph of the window bakes in
  those pointers.

The loop's walks against the JAX kernel loop are tests/test_torch_loop.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simplex_tpu_torch import solver
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

BIG = kb.BIG_INDEX
RUNNING, OPTIMAL, UNBOUNDED = (int(Status.RUNNING), int(Status.OPTIMAL),
                               int(Status.UNBOUNDED))
EPS = 1e-4
MAX_ITER = 10

# (status, iterations, stall, bland, h_b eligible, v_d, unb, p_k1, bk): the
# pivot each case makes; v_d, p_k1 and bk are scaled by seeded draws.
CASES = {
    "pivot": (RUNNING, 3, 4, False, False, -2.5, 0, 0.37, 1.9),
    "inactive": (OPTIMAL, 3, 4, False, False, -2.5, 0, 0.37, 1.9),
    "fuse": (RUNNING, MAX_ITER, 4, False, False, -2.5, 0, 0.37, 1.9),
    "optimal": (RUNNING, 3, 4, False, True, -1e-5, 0, 0.37, 1.9),
    "unbounded": (RUNNING, 3, 4, False, False, -2.5, 1, 0.0, 0.0),
    "bland": (RUNNING, 3, 4, True, True, -2.5, 0, 0.37, 1.9),
    "bland_none_eligible": (RUNNING, 3, 4, True, False, -2.5, 0, 0.37, 1.9),
    "stall_to_bland": (RUNNING, 3, 49, False, False, -2e-4, 0, 10.0, 1e-3),
}
POLICIES = {"threshold": (False, 50), "never": (False, None),
            "static": (True, 50)}


def _scalars(case, seed):
    status, iters, stall, bland, hb_ok, v_d, unb, p_k1, bk = CASES[case]
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.9, 1.1, 4)
    s = kb.pivot_scalars(torch.tensor(rng.uniform(-5, 5)), bland)
    vals = dict(status=status, iterations=iters, stall=stall, h_d=17,
                v_d=v_d * jitter[0], h_b=2 if hb_ok else BIG,
                v_b=-0.5 * jitter[1] if hb_ok else float("inf"),
                k=BIG if unb else 7, p_k1=p_k1 * jitter[2],
                bk=bk * jitter[3], unb=unb)
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    return s


def _eager_glue(s, then_pre, bland_static, threshold):
    """The loop's per-pivot glue as it ran eagerly before the step
    kernels, on a copy of the scalars: the part before K1, the part
    between K1 and K2 on K1's outputs (k, p, bk, unb), the part after K2,
    and with ``then_pre`` the next pivot's part before K1."""
    status, iterations = s.status.clone(), s.iterations.clone()
    stall, bland, z = s.stall.clone(), s.bland.clone(), s.z.clone()
    h_d, v_d, h_b, v_b = s.h_d, s.v_d, s.h_b, s.v_b

    def before_k1():
        active = (status == RUNNING) & (iterations < MAX_ITER)
        use_bland = bland & (h_b < BIG)
        h = torch.where(use_bland, h_b, h_d)
        minc = torch.where(use_bland, v_b, v_d)
        return active, h, minc, minc > -EPS

    active, h, minc, optimal = before_k1()
    p, bk, unb = s.p_k1, s.bk, s.unb
    unbounded = unb != 0
    do = active & ~(optimal | unbounded)
    p = torch.where(do, p, 1.0)
    u = torch.where(do, minc / p.to(torch.float64), 0.0)
    z2 = torch.where(do, z - u * bk, z)
    status = torch.where(
        active, torch.where(optimal, OPTIMAL,
                            torch.where(unbounded, UNBOUNDED, RUNNING)),
        status).to(torch.int32)
    improved = (z2 - z).abs() >= EPS
    new_stall = torch.where(do, torch.where(improved, 0, stall + 1),
                            stall).to(torch.int32)
    if bland_static:
        bland = torch.ones_like(bland)
    elif threshold is None:
        bland = torch.zeros_like(bland)
    else:
        bland = torch.where(do, ~improved & (new_stall >= threshold), bland)
    stall = new_stall
    iterations = iterations + do.to(torch.int32)
    z = z2
    out = dict(status=status, iterations=iterations, stall=stall,
               bland=bland, z=z, do=do, p=p, u=u)
    if then_pre:
        active, h, minc, optimal = before_k1()
    out.update(active=active, h=h, minc=minc, optimal=optimal)
    return out


@pytest.mark.parametrize("then_pre", [False, True], ids=["post", "post+pre"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_plain_matches_eager_glue(case, policy, then_pre):
    bland_static, threshold = POLICIES[policy]
    s = _scalars(case, seed=len(case))
    kb.step_pre(s, MAX_ITER, EPS)
    want = _eager_glue(s, then_pre, bland_static, threshold)
    kb.step_mid_plain(s)
    kb.step_post_plain(s, MAX_ITER, EPS, bland_static, threshold, then_pre)
    for name, w in want.items():
        got = getattr(s, name)
        assert got.dtype == w.dtype and torch.equal(got, w), (name, got, w)
    # The case makes the pivot it is named for.
    do = bool(s.do)
    assert do == (case in ("pivot", "bland", "bland_none_eligible",
                           "stall_to_bland")), case
    if case == "stall_to_bland" and policy == "threshold":
        assert bool(s.bland) and int(s.stall) == 50


def test_captured_launches_counts_replays_only():
    kb.reset_launches()
    kb.LAUNCHES["ah_ratio"] = 5
    with kb.CapturedLaunches() as launches:
        for _ in range(8):
            kb.LAUNCHES["ah_ratio"] += 1
            kb.LAUNCHES["step_mid_tail"] += 1
        kb.LAUNCHES["step_pre"] += 1
    assert kb.LAUNCHES["ah_ratio"] == 5 and kb.LAUNCHES["step_mid_tail"] == 0
    launches.replayed()
    launches.replayed()
    assert (kb.LAUNCHES["ah_ratio"], kb.LAUNCHES["step_mid_tail"],
            kb.LAUNCHES["step_pre"], kb.LAUNCHES["colk_costs"]) == (21, 16,
                                                                   2, 0)
    kb.reset_launches()


# The small tableau of the tails' tests: M constraints, R columns (the
# first R_LIVE active), a window of L pivots at fill T.
M, R, L, T = 128, 256, 8, 3
R_LIVE = R - 16


def _tableau(seed, devex=True, unbounded_col=None):
    """Tt, C and F (rows >= T zero), b, costs, base and the devex weights
    (None without devex), seeded; with ``unbounded_col`` that column of
    Tt is negative enough that K1 finds no eligible row there."""
    rng = np.random.default_rng(seed)
    Tt = rng.uniform(-1, 1, (M, R)).astype(np.float32)
    if unbounded_col is not None:
        Tt[:, unbounded_col] = -0.5 - np.abs(Tt[:, unbounded_col])
    C = np.zeros((L, R), np.float32)
    F = np.zeros((L, M), np.float32)
    C[:T] = rng.uniform(-1, 1, (T, R))
    F[:T] = rng.uniform(-0.01, 0.01, (T, M))
    st = dict(Tt=Tt, C=C, F=F, b=rng.uniform(0, 1, M),
              costs=rng.uniform(-1, 1, R),
              base=rng.integers(0, R, M).astype(np.int32),
              w=rng.uniform(1, 2, R).astype(np.float32) if devex else None)
    return {k: None if v is None else torch.as_tensor(v)
            for k, v in st.items()}


def _clone(st):
    return {k: None if v is None else v.clone() for k, v in st.items()}


def _one_pivot(s, st, tails, policy, then_pre):
    """The step before K1, then K1 and K2 with their tails (``tails``) or
    the four calls they fold, on ``s`` and the tableau ``st`` in place;
    returns K1's column."""
    bland_static, threshold = POLICIES[policy]
    ah = torch.empty(M, dtype=torch.float32)
    kb.step_pre(s, MAX_ITER, EPS)
    if tails:
        kb.ah_ratio_tail(st["Tt"], st["F"], st["C"], st["b"], T, EPS, s, ah)
        kb.colk_costs_tail(st["Tt"], st["C"], st["F"], st["costs"], T,
                           R_LIVE, EPS, ah, st["b"], st["base"], st["w"], s,
                           MAX_ITER, bland_static=bland_static,
                           threshold=threshold, then_pre=then_pre)
    else:
        kb.ah_ratio(st["Tt"], st["F"], st["C"], st["b"], s.h, T, EPS,
                    out=(ah, s.k, s.p_k1, s.bk, s.unb))
        kb.step_mid_plain(s)
        kb.colk_costs(st["Tt"], st["C"], st["F"], st["costs"], s.k, T, s.u,
                      s.do, R_LIVE, EPS, ah, st["b"], st["base"], s.h, s.p,
                      s.bk, st["w"], out=(s.h_d, s.v_d, s.h_b, s.v_b))
        kb.step_post_plain(s, MAX_ITER, EPS, bland_static, threshold,
                           then_pre)
    return ah


def _assert_same(a, b):
    (sa, sta, aha), (sb, stb, ahb) = a, b
    assert torch.equal(aha, ahb)
    for name, x in sa.tensors().items():
        y = getattr(sb, name)
        assert x.dtype == y.dtype and torch.equal(x, y), (name, x, y)
    for name, x in sta.items():
        assert (x is None) == (stb[name] is None), name
        if x is not None:
            assert torch.equal(x, stb[name]), name


@pytest.mark.parametrize("then_pre", [False, True], ids=["post", "post+pre"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tails_match_the_four_call_chain(case, policy, then_pre):
    """K1 and K2 with their tails against K1, ``step_mid_plain``, K2 and
    ``step_post_plain`` from the same scalars and tableau: every scalar,
    K1's column and every vector K2 updates equal. K1 decides k, p, bk
    and unbounded (case ``unbounded``: column h has no eligible row)."""
    tab = _tableau(len(case), devex=policy != "never",
                   unbounded_col=17 if case == "unbounded" else None)
    runs = []
    for tails in (True, False):
        s = _scalars(case, seed=len(case))
        st = _clone(tab)
        runs.append((s, st, _one_pivot(s, st, tails, policy, then_pre)))
    _assert_same(*runs)
    s = runs[0][0]
    assert bool(s.unb) == (case == "unbounded")
    assert bool(s.do) == (case in ("pivot", "bland", "bland_none_eligible",
                                   "stall_to_bland")), case
    if case == "stall_to_bland" and policy == "threshold":
        assert bool(s.bland) and int(s.stall) == 50


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_k2_tail_takes_the_old_h(rule):
    """The step K2's tail runs before the next pivot's K1 rewrites h: K2's
    ``base[k]`` and the leaving variable's devex weight take the h of the
    pivot just made, and the tail leaves the next pivot's h in ``s.h``."""
    tab = _tableau(5, devex=rule == "devex")
    s = _scalars("pivot", seed=5)
    st = _clone(tab)
    kb.step_pre(s, MAX_ITER, EPS)
    h_old = int(s.h)
    ah = torch.empty(M, dtype=torch.float32)
    kb.ah_ratio_tail(st["Tt"], st["F"], st["C"], st["b"], T, EPS, s, ah)
    k, p = int(s.k), s.p.clone()
    lvar = int(tab["base"][k])
    kb.colk_costs_tail(st["Tt"], st["C"], st["F"], st["costs"], T, R_LIVE,
                       EPS, ah, st["b"], st["base"], st["w"], s, MAX_ITER,
                       bland_static=False, threshold=50, then_pre=True)
    h_new = int(s.h)
    assert bool(s.do) and h_new != h_old
    assert int(st["base"][k]) == h_old
    if rule == "devex":
        def leaving(wh):
            w = torch.maximum(wh / (p * p), torch.ones_like(wh))
            return torch.minimum(w, torch.full_like(w, 1e12))

        want = leaving(tab["w"][h_old])
        assert torch.equal(st["w"][lvar], want)
        assert not torch.equal(leaving(tab["w"][h_new]), want)
    # And as the four calls leave them.
    s2 = _scalars("pivot", seed=5)
    st2 = _clone(tab)
    ah2 = _one_pivot(s2, st2, False, "threshold", True)
    _assert_same((s, st, ah), (s2, st2, ah2))


def test_run_window_launches_two_kernels_a_pivot(monkeypatch):
    """``run_window`` enqueues the step before K1 once, then K1 and K2
    with their tails once a pivot -- the last without the next pivot's
    step -- and no standalone step between K1 and K2 or after K2: the
    port has none left to call."""
    tab, _, opts = _phase1(96, 40, 11)
    loop = solver.kernel_loop(tab, opts)
    calls = []

    def record(name):
        real = getattr(solver, name)

        def call(*args, **kw):
            calls.append((name, kw.get("then_pre")))
            return real(*args, **kw)
        return call

    for name in ("step_pre", "ah_ratio_tail", "colk_costs_tail"):
        monkeypatch.setattr(solver, name, record(name))
    solver.run_window(loop, opts, 5000)
    n = int(opts.block_pivots)
    assert [c[0] for c in calls] == (
        ["step_pre"] + ["ah_ratio_tail", "colk_costs_tail"] * n)
    assert [c[1] for c in calls if c[0] == "colk_costs_tail"] == (
        [True] * (n - 1) + [False])
    for name in ("step_mid", "step_post"):
        assert not hasattr(kb, name) and not hasattr(solver, name)
        assert name not in kb.LAUNCHES
    assert kb.TAILS == {"step_mid_tail": "ah_ratio",
                        "step_post_tail": "colk_costs",
                        "sharded_post_tail": "colk_costs",
                        "sharded_pack_tail": "colk_costs",
                        "sharded_fold_head": "ah"}


def _phase1(n, m, seed, **kw):
    opts = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                         block_pivots=8, **kw)
    p = generate_random_problem(n, m, seed, 1, 100)
    tab = build_phase1(torch.as_tensor(p.A), torch.as_tensor(p.b), n, m,
                       opts)
    return gaussian_eliminate(tab), tab.costs, opts


def _pointers(loop):
    """``data_ptr()`` of every tensor of a ``solver.KernelLoop`` by name,
    its scalars' included (``w`` left out when None)."""
    out = {f.name: getattr(loop, f.name) for f in dataclasses.fields(loop)
           if f.name not in ("s", "r")}
    out.update(loop.s.tensors())
    return {name: x.data_ptr() for name, x in out.items() if x is not None}


@pytest.mark.parametrize("with_costs0", [True, False],
                         ids=["costs0", "no_costs0"])
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_carried_tensors_keep_their_storage(monkeypatch, rule, with_costs0):
    """Every tensor of the loop's state keeps its ``data_ptr()`` from the
    first window boundary to the last (read where the loop calls K3 or
    K4), and they are the tensors the loop started with."""
    tab, costs0, opts = _phase1(96, 40, 11, pivot_rule=rule)
    loops, seen = [], []
    make = solver.kernel_loop

    def kernel_loop(*args, **kw):
        loops.append(make(*args, **kw))
        seen.append(_pointers(loops[-1]))
        return loops[-1]

    def boundary(real):
        def call(*args, **kw):
            seen.append(_pointers(loops[-1]))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(solver, "kernel_loop", kernel_loop)
    monkeypatch.setattr(solver, "apply_window",
                        boundary(solver.apply_window))
    monkeypatch.setattr(solver, "apply_reprice",
                        boundary(solver.apply_reprice))
    _, status, iters = solver.solve_loop_blocked_kernel(
        tab, opts, 5000, costs0 if with_costs0 else None)
    assert status == int(Status.OPTIMAL)
    assert len(seen) >= 4, (len(seen), iters)     # three windows or more
    names = {"Tt", "C", "F", "b", "costs", "z", "base", "status",
             "iterations", "stall", "bland", "h_d", "v_d", "h_b", "v_b",
             "ws_k1", "ws_k2"} | ({"w"} if rule == "devex" else set())
    assert names <= set(seen[0])
    assert all(ptrs == seen[0] for ptrs in seen[1:])
    assert loops[0].Tt is tab.Tt


def test_kernel_loop_state_is_checked():
    """The scalars refuse a tensor of another dtype or shape."""
    s = kb.pivot_scalars(torch.tensor(0.0, dtype=torch.float64), False)
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    with pytest.raises(ValueError, match="p_k1"):
        kb.PivotScalars(**{**fields, "p_k1": torch.zeros((),
                                                         dtype=torch.float64)})
    with pytest.raises(ValueError, match="status"):
        kb.PivotScalars(**{**fields, "status": torch.zeros(1,
                                                           dtype=torch.int32)})
