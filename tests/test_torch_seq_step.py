"""The sequential loops as one device program a chunk, on the CPU.

* The plain versions of a chunk's kernels (``kernels.seq``:
  ``seq_step_pre``, ``seq_ratio_colk``, ``seq_rank1``; in the K6 loop
  ``seq_ratio_snapshot`` and ``fused_pivot_tail``), applied in
  the graph's order, against the eager pivot they replace --
  ``solver.iteration_body``, and the K6 loop's body as it ran eagerly
  (written out here) -- from
  seeded states in f64, f32 with f64 vectors and pure f32: a NaN in b,
  tied quotients, no eligible row, no improving column, Bland static, by
  its threshold and never, a skipped pivot and the fuse reached. Every
  field of the state bit for bit (a NaN equal to a NaN, the sign of a zero
  kept), and the next pivot's entering choice ``choose_entering``'s.
* A skipped pivot leaves the tableau untouched, where the eager body's
  ``addr_`` with factor 0 turned an inf of the leaving row into NaN rows.
* ``solver.solve_loop`` and ``solve_loop_pallas`` (``SeqLoop`` on the plain
  versions) against the JAX package's ``solve_loop`` and
  ``solve_loop_pallas`` (K6 in interpret mode), Dantzig and Bland:
  statuses and pivot counts; the fuse gives exactly ``max_iter`` pivots.
* ``seq_ratio_snapshot``'s plain version against ``seq_ratio``'s and
  ``seq_snapshot``'s run in turn, from every edge state.
* ``run_chunk``'s launches in order; the loop's fixed storage from its
  first chunk to its last; the scalars' checks; the card's launches
  (``seq_ratio_colk``, ``seq_ratio``, ``seq_ratio_snapshot``, K6 with
  its tail) with the kernel library stubbed: their arguments against the
  ctypes signatures and their launch counts.
"""

import ctypes
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu.kernels.pivot as jax_pivot
from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.solver import solve_loop as jax_solve_loop
from simplex_tpu.solver import solve_loop_pallas as jax_solve_loop_pallas
from simplex_tpu.tableau import build_phase1 as jax_build_phase1
from simplex_tpu.tableau import gaussian_eliminate as jax_eliminate
from simplex_tpu_torch import solver
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import pivot as kp
from simplex_tpu_torch.kernels import seq as ks
from simplex_tpu_torch.tableau import (build_phase1, gaussian_eliminate,
                                       tableau_from_numpy)

RUNNING, OPTIMAL = int(Status.RUNNING), int(Status.OPTIMAL)
MAX_ITER = 40
#: (tableau, vectors) dtype pairs: the default options, the mixed mode at
#: L = 1, pure f32 (use_pallas off: solve_loop; on: the K6 loop).
PAIRS = {"f64": (np.float64, np.float64), "mixed": (np.float32, np.float64),
         "f32": (np.float32, np.float32)}
#: The states each case starts from (applied by ``_edge``).
CASES = ("walk", "nan_b", "tie", "unbounded", "optimal", "bland_static",
         "bland_threshold", "bland_never", "skipped", "fuse")


def _options(pair, case, **kw):
    T, V = PAIRS[pair]
    rule = "bland" if case == "bland_static" else "dantzig"
    thr = None if case == "bland_never" else 3
    return SolverOptions(dtype=T, vector_dtype=V, pivot_rule=rule,
                         bland_threshold=thr, **kw)


def _phase1(opts, n=30, m=12, seed=7):
    p = generate_random_problem(n, m, seed, 1, 100)
    return gaussian_eliminate(build_phase1(
        torch.as_tensor(p.A), torch.as_tensor(p.b), n, m, opts))


def _edge(tab, case, opts):
    """The phase-1 tableau bent into ``case``'s state, and the carry
    (status, iterations, stall, bland)."""
    eps = float(opts.eps_resolved)
    tab = dataclasses.replace(tab, Tt=tab.Tt.clone(), b=tab.b.clone(),
                              costs=tab.costs.clone())
    h, _ = solver.choose_entering(tab, torch.tensor(False), eps)
    col = tab.Tt[:, int(h)]
    rows = torch.nonzero(col >= eps).view(-1)
    status, iters, stall = RUNNING, 3, 0
    bland = opts.pivot_rule_resolved == "bland"
    if case == "nan_b":
        tab.b[rows[1]] = float("nan")
    elif case == "tie":
        # Two eligible rows with the smallest quotient, the same bits.
        j1, j2 = int(rows[0]), int(rows[-1])
        tab.Tt[j2, int(h)] = tab.Tt[j1, int(h)]
        tab.b[j1] = tab.b[j2] = 1e-3 * tab.Tt[j1, int(h)].to(tab.b.dtype)
    elif case == "unbounded":
        tab.Tt[:, int(h)] = -col.abs()
    elif case == "optimal":
        tab.costs.copy_(tab.costs.abs())
    elif case == "bland_threshold":
        # A degenerate pivot (the smallest quotient 0: z does not move)
        # with the stall one short of the threshold.
        tab.b[rows[0]] = 0.0
        stall = int(opts.bland_threshold) - 1
    elif case == "bland_never":
        tab.b[rows[0]] = 0.0
        stall = 7
    elif case == "skipped":
        status = OPTIMAL
    elif case == "fuse":
        iters = MAX_ITER
    carry = (torch.tensor(status, dtype=torch.int32),
             torch.tensor(iters, dtype=torch.int32),
             torch.tensor(stall, dtype=torch.int32), torch.tensor(bland))
    return tab, carry


def _same(a, b) -> bool:
    """Bit for bit up to a NaN's payload: equal dtypes and shapes, equal
    values with the sign of a zero kept, a NaN where the other has one."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool((nan | ((a == b) & (torch.signbit(a) == torch.signbit(b))))
                .all())


def _eager_pallas_body(s, options, max_iter):
    """The K6 loop's pivot as it ran eagerly before the chunk's kernels
    (a ``solver.LoopState`` with ``cand`` the folded candidates)."""
    eps = float(options.eps_resolved)
    tab = s.tab
    Tt = tab.Tt
    M, R = Tt.shape
    M_iota = torch.arange(M)
    h_d, v_d, h_b, v_b = s.cand
    active = (s.status == RUNNING) & (s.iterations < max_iter)
    use_bland = s.bland & (h_b < kb.BIG_INDEX)
    h = torch.where(use_bland, h_b, h_d)
    minc = torch.where(use_bland, v_b, v_d)
    optimal = minc > -eps
    a_h = Tt.index_select(1, h.long().clamp(max=R - 1).view(1)).view(M)
    k, unbounded = solver.ratio_test(tab, a_h, eps)
    do = active & ~(optimal | unbounded)
    colk = Tt.index_select(0, k.long().view(1)).view(R)
    p = solver._at(a_h, k)
    new = kp.fused_pivot(Tt, tab.costs, colk, a_h, p, minc, k, tab.r, eps,
                         do)
    cand = tuple(torch.where(do, a, b) for a, b in zip(new, s.cand))
    p_safe = torch.where(do, p, 1.0)
    bk = solver._at(tab.b, k)
    b = torch.where(M_iota == k, bk / p_safe, tab.b - bk * (a_h / p_safe))
    z = tab.z - (minc / p_safe) * bk
    tab2 = dataclasses.replace(
        tab, b=torch.where(do, b, tab.b), z=torch.where(do, z, tab.z),
        base=torch.where(do & (M_iota == k), h, tab.base))
    stall, bland = kb.anticycling_update(
        do, (tab2.z - tab.z).abs() >= eps, s.stall, s.bland,
        bland_static=options.pivot_rule_resolved == "bland",
        threshold=options.bland_threshold)
    out = solver.LoopState(tab2, kb.exit_status(active, optimal, unbounded,
                                                s.status),
                           s.iterations + do.to(torch.int32), stall, bland)
    out.cand = cand
    return out


def _graph_order(loop, opts, pallas, then_pre):
    """One pivot of ``run_chunk``'s body on ``loop`` (its first pivot
    after ``seq_step_pre``)."""
    eps = float(opts.eps_resolved)
    policy = dict(bland_static=opts.pivot_rule_resolved == "bland",
                  threshold=opts.bland_threshold)
    s = loop.s
    if pallas:
        ks.seq_ratio_snapshot(loop.Tt, loop.b, loop.base, loop.ah, loop.colk,
                              s, eps)
        ks.fused_pivot_tail(loop.Tt, loop.costs, loop.colk, loop.ah, s,
                            loop.r, eps, MAX_ITER, loop.ws_pass,
                            then_pre=then_pre, **policy)
    else:
        ks.seq_ratio_colk(loop.Tt, loop.costs, loop.b, loop.base, loop.ah,
                          loop.colk, loop.fac, s, loop.r, eps, MAX_ITER,
                          then_pre=then_pre, **policy)
        ks.seq_rank1(loop.Tt, loop.fac, loop.colk, s)


def _run_both(tab, carry, opts, pallas, pivots):
    """``pivots`` pivots eagerly and in the graph's order from one state;
    after each, every field of the two states equal bit for bit and the
    next pivot's h and minc ``choose_entering``'s. Returns the kinds of
    pivot seen (do, unbounded)."""
    eps = float(opts.eps_resolved)
    ref = solver.LoopState(dataclasses.replace(
        tab, Tt=tab.Tt.clone(), b=tab.b.clone(), costs=tab.costs.clone(),
        base=tab.base.clone()), *(x.clone() for x in carry))
    loop = solver.seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()), opts,
                           pallas=pallas)
    s = loop.s
    for dst, src in zip((s.status, s.iterations, s.stall, s.bland), carry):
        dst.copy_(src)
    if pallas:
        ref.cand = kp.entering_candidates(ref.tab.costs, tab.r, eps)
    ks.seq_step_pre(s, MAX_ITER, eps)
    seen = set()
    for i in range(pivots):
        before = loop.Tt.clone()
        _graph_order(loop, opts, pallas, then_pre=True)
        ref = (_eager_pallas_body(ref, opts, MAX_ITER) if pallas
               else solver.iteration_body(ref, opts, MAX_ITER))
        seen.add((bool(s.do), bool(s.unb)))
        if not bool(s.do):
            # The one place the bits may part: a skipped pivot leaves Tt
            # untouched, where the eager addr_ with factor 0 may turn a
            # -0.0 into +0.0 (and an inf of colk into NaN rows, below).
            assert _same(loop.Tt, before) and torch.equal(loop.Tt,
                                                          ref.tab.Tt), i
            ref.tab.Tt.copy_(loop.Tt)
        got = dict(Tt=loop.Tt, b=loop.b, costs=loop.costs, z=s.z,
                   base=loop.base, status=s.status, iterations=s.iterations,
                   stall=s.stall, bland=s.bland)
        want = dict(Tt=ref.tab.Tt, b=ref.tab.b, costs=ref.tab.costs,
                    z=ref.tab.z, base=ref.tab.base, status=ref.status,
                    iterations=ref.iterations, stall=ref.stall,
                    bland=ref.bland)
        for name in got:
            assert _same(got[name], want[name]), (i, name)
        if pallas:
            want_cand = ref.cand
            for name, x, w in zip(("h_d", "v_d", "h_b", "v_b"),
                                  (s.h_d, s.v_d, s.h_b, s.v_b), want_cand):
                assert _same(x, w.to(x.dtype)), (i, name)
        else:
            h, minc = solver.choose_entering(ref.tab, ref.bland, eps)
            assert int(s.h) == int(h) and _same(s.minc, minc), i
    return seen


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plain_chunk_matches_iteration_body(pair, case):
    """``seq_step_pre``, then ``seq_ratio_colk`` (``seq_ratio``'s and
    ``seq_colk``'s plain versions) and ``seq_rank1`` (CPU tensors)
    against ``iteration_body`` from one
    edge state, three pivots: the same state bit for bit after each."""
    opts = _options(pair, case)
    tab, carry = _edge(_phase1(opts), case, opts)
    seen = _run_both(tab, carry, opts, False, 3)
    want = {"walk": (True, False), "nan_b": (True, False),
            "tie": (True, False), "unbounded": (False, True),
            "optimal": (False, False), "skipped": (False, False),
            "fuse": (False, False)}.get(case, (True, False))
    assert want in seen, seen


@pytest.mark.parametrize("case", CASES)
def test_plain_k6_chunk_matches_the_eager_k6_body(case):
    """``seq_step_pre``, then ``seq_ratio_snapshot`` and
    ``fused_pivot_tail`` against the K6 loop's eager body (pure f32), from
    one edge state, three pivots: the same state and candidates."""
    opts = _options("f32", case, use_pallas=True)
    tab, carry = _edge(_phase1(opts), case, opts)
    _run_both(tab, carry, opts, True, 3)


@pytest.mark.parametrize("case", CASES)
def test_ratio_snapshot_plain_is_ratio_then_snapshot(case):
    """``seq_ratio_snapshot`` on CPU tensors (its plain version) against
    ``seq_ratio_plain`` followed by ``seq_snapshot_plain`` from the same
    edge state (pure f32, the step before run first): every scalar, b,
    base, the gathered column and the row bit for bit."""
    opts = _options("f32", case, use_pallas=True)
    tab, carry = _edge(_phase1(opts), case, opts)
    eps = float(opts.eps_resolved)
    loops = [solver.seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()),
                             opts, pallas=True) for _ in range(2)]
    for lp in loops:
        for dst, src in zip((lp.s.status, lp.s.iterations, lp.s.stall,
                             lp.s.bland), carry):
            dst.copy_(src)
        ks.seq_step_pre(lp.s, MAX_ITER, eps)
    a, b = loops
    ks.seq_ratio_snapshot(a.Tt, a.b, a.base, a.ah, a.colk, a.s, eps)
    ks.seq_ratio_plain(b.Tt, b.b, b.s, b.ah, eps)
    ks.seq_snapshot_plain(b.Tt, b.b, b.base, b.ah, b.colk, b.s)
    for name, x in a.s.tensors().items():
        assert _same(x, getattr(b.s, name)), name
    for name in ("Tt", "b", "base", "ah", "colk"):
        assert _same(getattr(a, name), getattr(b, name)), name
    assert _same(a.colk, a.Tt[int(a.s.k)])
    assert ks.LAUNCHES["seq_snapshot"] == 0


def test_walk_matches_iteration_body_through_the_exit():
    """A whole phase-1 walk in f64, 60 pivots past its exit in the
    graph's order against ``iteration_body``: every state bit for bit,
    the skipped pivots after the exit included."""
    opts = _options("f64", "walk")
    tab = _phase1(opts, n=16, m=6, seed=2)
    carry = (torch.tensor(RUNNING, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32), torch.tensor(False))
    seen = _run_both(tab, carry, opts, False, 60)
    assert {(True, False), (False, False)} <= seen


def test_skipped_pivot_leaves_the_tableau_untouched():
    """With do false and an inf in the leaving row, the eager body's
    ``addr_`` with factor 0 turns the tableau's column of that inf into
    NaN; ``seq_rank1`` does not touch it, as the JAX ``while_loop`` runs no
    skipped pivot. Every other field equal."""
    opts = _options("f64", "skipped")
    tab, carry = _edge(_phase1(opts), "skipped", opts)
    eps = float(opts.eps_resolved)
    h, _ = solver.choose_entering(tab, torch.tensor(False), eps)
    k, _ = solver.ratio_test(tab, tab.Tt[:, int(h)], eps)
    tab.Tt[int(k), tab.r - 1] = float("inf")
    before = tab.Tt.clone()
    loop = solver.seq_loop(dataclasses.replace(tab, Tt=tab.Tt.clone()), opts)
    for dst, src in zip((loop.s.status, loop.s.iterations, loop.s.stall,
                         loop.s.bland), carry):
        dst.copy_(src)
    ks.seq_step_pre(loop.s, MAX_ITER, eps)
    _graph_order(loop, opts, False, then_pre=True)
    assert not bool(loop.s.do) and int(loop.s.k) == int(k)
    assert _same(loop.Tt, before)
    ref = solver.iteration_body(solver.LoopState(
        dataclasses.replace(tab, Tt=tab.Tt.clone()),
        *(x.clone() for x in carry)), opts, MAX_ITER)
    others = torch.arange(tab.Tt.shape[0]) != int(k)
    assert torch.isnan(ref.tab.Tt[others, tab.r - 1]).all()
    assert not torch.isnan(loop.Tt[:, tab.r - 1]).any()
    for name in ("b", "costs", "z", "base"):
        assert _same(getattr(loop, name) if name != "z" else loop.s.z,
                     getattr(ref.tab, name)), name


# ---------------------------------------------------------------------------
# SeqLoop against the JAX package's loops.

def _jax_tableau(n, m, seed, **opts):
    jopt = JaxOptions(**opts)
    rng = np.random.Generator(np.random.Philox(key=seed))
    A = jnp.asarray(rng.uniform(1, 100, (m, n)), jopt.dtype)
    b = jnp.asarray(rng.uniform(1, 100, (m,)), jopt.dtype)
    return jax_eliminate(jax_build_phase1(A, b, n, m, jopt)), jopt, \
        SolverOptions(**opts)


def _port(tab):
    return tableau_from_numpy(tab.T, tab.b, tab.costs, tab.z, tab.base,
                              tab.n, tab.m, tab.r)


@pytest.mark.parametrize("cap", [2000, 1, 31, 32, 33])
@pytest.mark.parametrize("rule", ["dantzig", "bland"])
def test_seq_loop_walks_as_jax_solve_loop(rule, cap):
    """f64: the port's ``solve_loop`` (``SeqLoop``, one chunk a host read)
    walks as the JAX ``solve_loop`` from one tableau: the same status and
    pivot count, the same basis; capped runs stop at the cap, status
    RUNNING, whatever the chunk."""
    tab, jopt, popt = _jax_tableau(70, 22, 13, pivot_rule=rule)
    wt, ws, wi = jax_solve_loop(tab, jopt, cap)
    gt, gs, gi = solver.solve_loop(_port(tab), popt, cap)
    assert gs == int(ws) and gi == int(wi)
    assert gs == (int(Status.OPTIMAL) if cap == 2000 else RUNNING)
    assert gi == cap or cap == 2000
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("rule", ["dantzig", "bland"])
def test_seq_loop_walks_as_jax_solve_loop_pallas(monkeypatch, rule):
    """Pure f32: the port's ``solve_loop_pallas`` (the plain K6 and the
    chunk's plain steps) against the JAX ``solve_loop_pallas`` with K6 in
    interpret mode, from one tableau. Capped inside phase 1, the same
    status (RUNNING), pivot count and basis, b within 2^-18 relative. The
    whole walk: OPTIMAL on both sides, pivot counts within max(3, 10%),
    as the f32 walks are held (tests/test_torch_sequential.py): in f32 the
    two part in phase 1's degenerate tail, where z is within eps of 0 and
    rounding breaks the ties (at pivot 29 of 29 under Dantzig, 32 of 33
    under Bland here; the port's walk is its eager K6 loop's, bit for bit,
    above)."""
    monkeypatch.setattr(jax_pivot, "fused_pivot", functools.partial(
        jax_pivot.fused_pivot, interpret=True))
    tab, jopt, popt = _jax_tableau(40, 14, 5, dtype=np.float32,
                                   pivot_rule=rule, use_pallas=True)
    wt, ws, wi = jax_solve_loop_pallas(tab, jopt, 24)
    gt, gs, gi = solver.solve_loop_pallas(_port(tab), popt, 24)
    assert gs == int(ws) == RUNNING and gi == int(wi) == 24
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b),
                               rtol=2.0 ** -18, atol=2.0 ** -18)
    wt, ws, wi = jax_solve_loop_pallas(tab, jopt, 2000)
    gt, gs, gi = solver.solve_loop_pallas(_port(tab), popt, 2000)
    assert gs == int(ws) == int(Status.OPTIMAL)
    assert abs(gi - int(wi)) <= max(3, int(wi) // 10), (gi, int(wi))
    assert kp.LAUNCHES["fused_pivot"] == 0          # CPU: the plain version


# ---------------------------------------------------------------------------
# The chunk's structure and the loop's storage.

@pytest.mark.parametrize("pallas", [False, True], ids=["seq", "k6"])
def test_run_chunk_enqueues_in_the_graphs_order(monkeypatch, pallas):
    """``run_chunk`` enqueues ``seq_step_pre`` once, then per pivot
    ``seq_ratio_colk`` and ``seq_rank1`` (the K6 loop:
    ``seq_ratio_snapshot``, ``fused_pivot_tail``), the last pivot's step
    after without the next pivot's step before: SEQ_CHUNK pivots whatever
    the fuse."""
    opts = _options("f32", "walk", use_pallas=pallas)
    loop = solver.seq_loop(_phase1(opts), opts, pallas=pallas)
    calls = []

    def record(name):
        real = getattr(solver, name)

        def call(*args, **kw):
            calls.append((name, kw.get("then_pre")))
            return real(*args, **kw)
        return call

    names = ("seq_step_pre", "seq_ratio_snapshot", "seq_ratio_colk",
             "seq_rank1", "fused_pivot_tail")
    for name in names:
        monkeypatch.setattr(solver, name, record(name))
    solver.run_chunk(loop, opts, 5)
    body = (["seq_ratio_snapshot", "fused_pivot_tail"] if pallas
            else ["seq_ratio_colk", "seq_rank1"])
    assert [c[0] for c in calls] == ["seq_step_pre"] + body * solver.SEQ_CHUNK
    tails = [c[1] for c in calls if c[0] == body[int(pallas)]]
    assert tails == [True] * (solver.SEQ_CHUNK - 1) + [False]
    assert int(loop.s.iterations) == 5


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_seq_loop_keeps_its_storage(monkeypatch, pair):
    """Every tensor of the loop's state keeps its ``data_ptr()`` from the
    first chunk to the last, and ``solve_loop`` returns the loop's b,
    costs, z and base and updates the caller's Tt in place."""
    opts = _options(pair, "walk")
    tab = _phase1(opts, n=160, m=64, seed=4)
    loops, seen = [], []
    make, chunk = solver.seq_loop, solver.run_chunk

    def ptrs(loop):
        out = {f.name: getattr(loop, f.name) for f in dataclasses.fields(loop)
               if f.name not in ("s", "r", "pallas")}
        out.update(loop.s.tensors())
        return {n: x.data_ptr() for n, x in out.items() if x is not None}

    def seq_loop(*a, **kw):
        loops.append(make(*a, **kw))
        return loops[-1]

    def run_chunk(loop, *a, **kw):
        seen.append(ptrs(loop))
        return chunk(loop, *a, **kw)

    monkeypatch.setattr(solver, "seq_loop", seq_loop)
    monkeypatch.setattr(solver, "run_chunk", run_chunk)
    out, status, iters = solver.solve_loop(tab, opts, 5000)
    assert status == OPTIMAL and len(seen) >= 2, (status, iters)
    assert all(p == seen[0] for p in seen[1:])
    loop = loops[0]
    assert loop.Tt is tab.Tt and out.Tt is tab.Tt
    assert out.b is loop.b and out.costs is loop.costs
    assert out.z is loop.s.z and out.base is loop.base


def test_seq_scalars_are_checked():
    """The scalars take the tableau's dtype for p and the vectors' for z,
    the candidates' values, minc, bk and u; another dtype or a shape
    raises, and the kernels refuse a pair with no kernel."""
    s = ks.seq_scalars(torch.tensor(0.0, dtype=torch.float64), False,
                       torch.float32)
    assert s.p.dtype == torch.float32 and s.u.dtype == torch.float64
    assert int(s.status) == RUNNING and s.h_b.dtype == torch.int32
    fields = s.tensors()
    with pytest.raises(ValueError, match="minc"):
        ks.SeqScalars(**{**fields, "minc": torch.zeros(())})
    with pytest.raises(ValueError, match="status"):
        ks.SeqScalars(**{**fields, "status": torch.zeros(1,
                                                         dtype=torch.int32)})
    odd = ks.seq_scalars(torch.tensor(0.0), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ks._pair(odd)
    assert ks.TAILS == {"seq_colk": "seq_ratio", "seq_snapshot": "seq_ratio",
                        "seq_k6_tail": "fused_pivot"}
    assert set(ks.TAILS) <= set(ks.LAUNCHES)


# ---------------------------------------------------------------------------
# The card's launches, the library stubbed.

def _stub_card(monkeypatch, name):
    """The wrappers' card path with ``load_library`` stubbed by a library
    whose entry point ``name`` records its arguments and returns 0."""
    from simplex_tpu_torch.kernels import _build

    got = []

    class Lib:
        pass

    setattr(Lib, name, lambda self, *args: got.append(args) or 0)
    monkeypatch.setattr(ks, "_on_card", lambda *a: True)
    monkeypatch.setattr(ks, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    return got, _build.SIGNATURES[name]


def _values(args):
    return [a.value or 0 if isinstance(a, ctypes.c_void_p) else a
            for a in args]


@pytest.mark.parametrize("policy", [
    dict(bland_static=False, threshold=5, then_pre=True),
    dict(bland_static=True, threshold=5, then_pre=False),
    dict(bland_static=False, threshold=None, then_pre=True)],
    ids=["threshold", "static", "never"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_ratio_colk_launch_is_wired(monkeypatch, pair, policy):
    """The default loop's pivot on the card, its library stubbed: one
    ``seq_ratio_colk_launch`` with as many arguments as its ctypes
    signature -- the loop's seven tensors' pointers in order, M, R, r,
    eps, the scalars by reference (their pointers in ``SeqScalars``'
    order), max_iter, the Bland mode, threshold (0 for none), then_pre and
    the pair's code -- counting one launch of ``seq_ratio`` and one of
    ``seq_colk``, its tail; nothing else launched, no state moved."""
    opts = _options(pair, "walk")
    loop = solver.seq_loop(_phase1(opts), opts)
    got, sig = _stub_card(monkeypatch, "seq_ratio_colk_launch")
    state = {n: x.clone() for n, x in loop.s.tensors().items()}
    ks.reset_launches()
    M, R = loop.Tt.shape
    ks.seq_ratio_colk(loop.Tt, loop.costs, loop.b, loop.base, loop.ah,
                      loop.colk, loop.fac, loop.s, loop.r, 1e-9, 77,
                      **policy)
    (args,) = got
    assert len(args) == len(sig) == 18
    vals = _values(args)
    assert vals[:7] == [x.data_ptr() for x in (
        loop.Tt, loop.costs, loop.b, loop.base, loop.ah, loop.colk,
        loop.fac)]
    assert vals[7:11] == [M, R, loop.r, 1e-9]
    ptrs = ctypes.cast(args[11], ctypes.POINTER(ks._SeqPtrs)).contents
    assert [getattr(ptrs, n) for n, _ in ks._SeqPtrs._fields_] == [
        x.data_ptr() for x in loop.s.tensors().values()]
    mode = (kb.BLAND_STATIC if policy["bland_static"] else kb.BLAND_NEVER
            if policy["threshold"] is None else kb.BLAND_THRESHOLD)
    assert vals[12:17] == [77, mode, policy["threshold"] or 0,
                           int(policy["then_pre"]), ks.PAIRS[
                               (loop.Tt.dtype, loop.b.dtype)]]
    assert ks.LAUNCHES == {**{n: 0 for n in ks.LAUNCHES}, "seq_ratio": 1,
                           "seq_colk": 1}
    for n, x in loop.s.tensors().items():
        assert _same(x, state[n]), n


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_ratio_and_snapshot_launches_are_wired(monkeypatch, pair):
    """The K6 loop's ``seq_ratio_snapshot`` and ``seq_ratio`` alone on the
    card, the library stubbed: one launch each with as many arguments as
    its ctypes signature, no workspace, the pair's code passed on;
    ``seq_ratio_snapshot`` counts a launch of ``seq_ratio`` and one of
    its tail ``seq_snapshot``, and takes a pure-f32 pair only (the C entry
    point refuses another)."""
    opts = _options(pair, "walk")
    loop = solver.seq_loop(_phase1(opts), opts)
    M, R = loop.Tt.shape
    code = ks.PAIRS[(loop.Tt.dtype, loop.b.dtype)]
    got, sig = _stub_card(monkeypatch, "seq_ratio_launch")
    ks.reset_launches()
    ks.seq_ratio(loop.Tt, loop.b, loop.s, loop.ah, 1e-9)
    (args,) = got
    assert len(args) == len(sig) == 9
    vals = _values(args)
    assert vals[:6] == [loop.Tt.data_ptr(), loop.b.data_ptr(), M, R, 1e-9,
                        loop.ah.data_ptr()]
    assert vals[7] == code
    assert ks.LAUNCHES["seq_ratio"] == 1 and ks.LAUNCHES["seq_colk"] == 0
    ks.reset_launches()
    if pair != "f32":
        with pytest.raises(ValueError, match="want contiguous torch.float32"):
            ks.seq_ratio_snapshot(loop.Tt, loop.b, loop.base, loop.ah,
                                  loop.colk, loop.s, 1e-9)
        assert ks.LAUNCHES["seq_ratio"] == 0
        return
    got, sig = _stub_card(monkeypatch, "seq_ratio_snapshot_launch")
    state = {n: x.clone() for n, x in loop.s.tensors().items()}
    ks.seq_ratio_snapshot(loop.Tt, loop.b, loop.base, loop.ah, loop.colk,
                          loop.s, 1e-4)
    (args,) = got
    assert len(args) == len(sig) == 11
    vals = _values(args)
    assert vals[:8] == [x.data_ptr() for x in (
        loop.Tt, loop.b, loop.base, loop.ah, loop.colk)] + [M, R, 1e-4]
    ptrs = ctypes.cast(args[8], ctypes.POINTER(ks._SeqPtrs)).contents
    assert [getattr(ptrs, n) for n, _ in ks._SeqPtrs._fields_] == [
        x.data_ptr() for x in loop.s.tensors().values()]
    assert vals[9] == code
    assert ks.LAUNCHES == {**{n: 0 for n in ks.LAUNCHES}, "seq_ratio": 1,
                           "seq_snapshot": 1}
    for n, x in loop.s.tensors().items():
        assert _same(x, state[n]), n


@pytest.mark.parametrize("policy", [
    dict(bland_static=False, threshold=5, then_pre=True),
    dict(bland_static=True, threshold=5, then_pre=False),
    dict(bland_static=False, threshold=None, then_pre=True)],
    ids=["threshold", "static", "never"])
def test_k6_tail_launch_is_wired(monkeypatch, policy):
    """K6 in the K6 loop on the card, the library stubbed: one
    ``fused_pivot_seq_launch`` -- one kernel, its fold and the step after
    the tail of its last tile block -- with as many arguments as its
    ctypes signature: the four tensors' pointers, M, R, r, eps, the
    workspace's five rows (four of partials, then the tail's counter,
    zero), the scalars by reference, max_iter, the Bland mode, threshold
    and then_pre; counting one launch of ``fused_pivot`` and one of its
    tail ``seq_k6_tail``. A workspace without the counter's row, a row
    not of whole 16-byte vectors, or another dtype pair raises."""
    opts = _options("f32", "walk", use_pallas=True)
    loop = solver.seq_loop(_phase1(opts), opts, pallas=True)
    M, R = loop.Tt.shape
    ws = loop.ws_pass
    assert ws.shape == (5, -(-R // kp.COLS)) and not ws.any()
    got, sig = _stub_card(monkeypatch, "fused_pivot_seq_launch")
    ks.reset_launches()
    kp.reset_launches()
    ks.fused_pivot_tail(loop.Tt, loop.costs, loop.colk, loop.ah, loop.s,
                        loop.r, 1e-4, 77, ws, **policy)
    (args,) = got
    assert len(args) == len(sig) == 19
    vals = _values(args)
    assert vals[:8] == [x.data_ptr() for x in (
        loop.Tt, loop.costs, loop.colk, loop.ah)] + [M, R, loop.r, 1e-4]
    assert vals[8:13] == [x.data_ptr() for x in ws]
    assert vals[12] == ws[4, 0].data_ptr()
    ptrs = ctypes.cast(args[13], ctypes.POINTER(ks._SeqPtrs)).contents
    assert [getattr(ptrs, n) for n, _ in ks._SeqPtrs._fields_] == [
        x.data_ptr() for x in loop.s.tensors().values()]
    mode = (kb.BLAND_STATIC if policy["bland_static"] else kb.BLAND_NEVER
            if policy["threshold"] is None else kb.BLAND_THRESHOLD)
    assert vals[14:18] == [77, mode, policy["threshold"] or 0,
                           int(policy["then_pre"])]
    assert kp.LAUNCHES["fused_pivot"] == 1
    assert ks.LAUNCHES == {**{n: 0 for n in ks.LAUNCHES}, "seq_k6_tail": 1}
    with pytest.raises(ValueError, match="ws"):
        ks.fused_pivot_tail(loop.Tt, loop.costs, loop.colk, loop.ah, loop.s,
                            loop.r, 1e-4, 77, ws[:4], **policy)
    with pytest.raises(ValueError, match="16-byte"):
        ks.fused_pivot_tail(loop.Tt[:, :-2].contiguous(), loop.costs[:-2],
                            loop.colk[:-2], loop.ah, loop.s, loop.r, 1e-4,
                            77, **policy)
    mixed = ks.seq_scalars(torch.zeros((), dtype=torch.float64), False,
                           torch.float32)
    with pytest.raises(ValueError, match="pure-f32"):
        ks.fused_pivot_tail(loop.Tt, loop.costs, loop.colk, loop.ah, mixed,
                            loop.r, 1e-4, 77, ws, **policy)
    assert len(got) == 1
