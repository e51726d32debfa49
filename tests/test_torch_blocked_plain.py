"""The plain blocked loop as one device program a window, on the CPU.

* The plain versions of a pivot's kernels (``kernels.eta``:
  ``seq_step_pre``, ``eta_ratio``, ``eta_colk``), in the window's order,
  against the old body's pivot (``solver.blocked_reference_pivot``) from
  edge states in f64, f32 with f64 vectors and pure f32: t = 0 and t = L -
  1, a skipped pivot, optimal, unbounded, Bland static and by its
  threshold, devex with and without a re-anchor inside the window, the
  fuse reached. Against the old body with its live column and row formed
  as the kernels form them (``eta_live``) every value bit for bit; against
  it as it ran, integers equal and floats within the stated tolerance (it
  sums the corrections with ``@`` in the tableau's dtype, the kernels in
  order in f64), bit for bit at t = 0.
* ``solve_loop_blocked``'s eager path (``BlockedLoop`` and
  ``run_blocked_window`` on the plain versions) against the old body at
  every window's end (``blocked_reference_windows``), f64, mixed and
  pure f32 (the last two re-priced from ``costs0`` every window), L in
  {2, 8, 12}, Dantzig, devex and Bland: integers equal, floats within the
  stated tolerance; the fuse tripping mid-window.
* ``solve_loop_blocked`` against the JAX package's under devex and Bland
  (f64 pivot counts equal; Dantzig at L in {2, 8, 12, 32} is
  tests/test_torch_sequential.py's).
* ``eta_live``'s order; ``run_blocked_window``'s launches in order; the
  loop's fixed storage; the card's launches with the kernel library
  stubbed: their arguments against the ctypes signatures, their counts.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.solver import solve_loop_blocked as jax_solve_loop_blocked
from simplex_tpu.tableau import build_phase1 as jax_build_phase1
from simplex_tpu.tableau import gaussian_eliminate as jax_eliminate
from simplex_tpu_torch import solver
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import eta as ke
from simplex_tpu_torch.kernels import seq as ks
from simplex_tpu_torch.tableau import (build_phase1, gaussian_eliminate,
                                       tableau_from_numpy)

RUNNING, OPTIMAL = int(Status.RUNNING), int(Status.OPTIMAL)
MAX_ITER = 60
#: (tableau, vectors) dtype pairs.
PAIRS = {"f64": (np.float64, np.float64), "mixed": (np.float32, np.float64),
         "f32": (np.float32, np.float32)}
#: The pivot-level cases (``_edge``).
CASES = ("t0", "last", "skipped", "optimal", "unbounded", "bland_static",
         "bland_threshold", "devex", "devex_reanchor", "fuse")
CARRY = ("b", "costs", "z", "base", "w", "status", "iterations", "stall",
         "bland")
INTS = ("base", "status", "iterations", "stall", "bland")


def _options(pair, rule="dantzig", L=8, threshold=3):
    T, V = PAIRS[pair]
    return SolverOptions(dtype=T, vector_dtype=V, block_pivots=L,
                         pivot_rule=rule, bland_threshold=threshold,
                         use_pallas=False)


def _phase1(opts, n=40, m=16, seed=7):
    """The eliminated phase-1 tableau and its pre-elimination costs (None
    for an f64 tableau, which the loop never re-prices)."""
    p = generate_random_problem(n, m, seed, 1, 100)
    tab = build_phase1(torch.as_tensor(p.A), torch.as_tensor(p.b), n, m,
                       opts)
    costs0 = None if tab.Tt.dtype == torch.float64 else tab.costs.clone()
    return gaussian_eliminate(tab), costs0


def _carry(tab, opts):
    R = tab.Tt.shape[1]
    return dict(b=tab.b.clone(), costs=tab.costs.clone(),
                z=tab.z.clone(), base=tab.base.to(torch.int32).clone(),
                w=torch.ones(R, dtype=tab.costs.dtype),
                status=torch.tensor(RUNNING, dtype=torch.int32),
                iterations=torch.zeros((), dtype=torch.int32),
                stall=torch.zeros((), dtype=torch.int32),
                bland=torch.tensor(opts.pivot_rule_resolved == "bland"))


def _same(a, b) -> bool:
    """Bit for bit up to a NaN's payload, the sign of a zero kept."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool((nan | ((a == b) & (torch.signbit(a) == torch.signbit(b))))
                .all())


def _close(got, want, T, name, scale=1.0):
    """Floats formed from eta corrections summed in another order: within
    1e-12 (an f64 tableau) or 1e-5 (an f32 one: a few f32 roundings of the
    t-term sums) of the largest magnitude involved -- ``scale``, the
    tableau's largest entry, or the values' own."""
    tol = 1e-12 if T == np.float64 else 1e-5
    got, want = got.double(), want.double()
    scale = max(scale, float(want.abs().max()), float(got.abs().max()))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= tol * scale, (name, err, scale)


def _edge(case, pair, L=8):
    """The options, tableau, factors, carry and t of ``case``: at t = 0
    from the phase-1 tableau, else after L - 1 pivots of the old body
    (``blocked_reference_pivot``) that fill ``C[:t]`` and ``F[:t]``; then
    the state bent as the case says."""
    rule = {"bland_static": "bland", "devex": "devex",
            "devex_reanchor": "devex"}.get(case, "dantzig")
    opts = _options(pair, rule, L)
    tab, _ = _phase1(opts)
    eps = float(opts.eps_resolved)
    Tt = tab.Tt.clone()
    M, R = Tt.shape
    C = torch.zeros((L, R), dtype=Tt.dtype)
    F = torch.zeros((L, M), dtype=Tt.dtype)
    x = _carry(tab, opts)
    t = 0 if case in ("t0", "unbounded") else L - 1
    for s in range(t):
        x = solver.blocked_reference_pivot(Tt, C, F, s, x, tab.r, opts,
                                           MAX_ITER)
    assert int(x["iterations"]) == t and int(x["status"]) == RUNNING
    if case == "skipped":
        x["status"] = torch.tensor(OPTIMAL, dtype=torch.int32)
    elif case == "fuse":
        x["iterations"] = torch.tensor(MAX_ITER, dtype=torch.int32)
    elif case == "optimal":
        x["costs"] = x["costs"].abs()
    elif case == "unbounded":
        h, _ = solver._entering_blocked(x["costs"], x["w"], x["bland"],
                                        tab.r, eps, False)
        Tt[:, int(h)] = -Tt[:, int(h)].abs()
    elif case == "bland_threshold":
        # A degenerate pivot (the smallest quotient 0: z does not move)
        # with the stall one short of the threshold.
        h, _ = solver._entering_blocked(x["costs"], x["w"], x["bland"],
                                        tab.r, eps, False)
        a_h = Tt[:, int(h)] - C[:t, int(h)] @ F[:t]
        rows = torch.nonzero(a_h >= eps).view(-1)
        x["b"] = x["b"].clone()
        x["b"][rows[0]] = 0.0
        x["stall"] = torch.tensor(opts.bland_threshold - 1,
                                  dtype=torch.int32)
    elif case == "devex_reanchor":
        # A weight past 1e8 on a column that is no candidate: the pivot's
        # new weights pass the re-anchor's bound, so every weight becomes 1
        # and the next pivot prices on ones.
        x["w"] = x["w"].clone()
        x["w"][tab.r - 1] = 3e8
    return opts, tab.r, Tt, C, F, x, t


def _new_pivot(opts, r, Tt, C, F, x, t):
    """Pivot t through the plain versions in the window's order, from the
    carry ``x``: the candidates folded over its costs and weights, then
    ``seq_step_pre``, ``eta_ratio``, ``eta_colk`` (with the next step
    before). Returns the new carry, the scalars and C, F."""
    eps = float(opts.eps_resolved)
    devex = opts.pivot_rule_resolved == "devex"
    C, F = C.clone(), F.clone()
    b, costs, base = (x[n].clone() for n in ("b", "costs", "base"))
    w = x["w"].clone() if devex else None
    s = ks.seq_scalars(x["z"], False, Tt.dtype)
    for n in ("status", "iterations", "stall", "bland"):
        getattr(s, n).copy_(x[n])
    ks.set_candidates(s, ke.eta_candidates(costs, w, r, eps))
    ah = torch.zeros(Tt.shape[0], dtype=Tt.dtype)
    ks.seq_step_pre(s, MAX_ITER, eps)
    ke.eta_ratio(Tt, C, F, b, ah, s, t, eps)
    ke.eta_colk(Tt, C, F, costs, b, base, w, ah, s, t, r, eps, MAX_ITER,
                bland_static=opts.pivot_rule_resolved == "bland",
                threshold=opts.bland_threshold, then_pre=True)
    new = dict(b=b, costs=costs, z=s.z, base=base,
               w=x["w"] if w is None else w, status=s.status,
               iterations=s.iterations, stall=s.stall, bland=s.bland)
    return new, s, C, F


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plain_pivot_matches_the_old_body(pair, case):
    """One pivot through ``seq_step_pre``, ``eta_ratio`` and ``eta_colk``
    (plain versions) against ``blocked_reference_pivot`` on the same
    state: the carry, ``C[t]`` and ``F[t]``, and the next pivot's entering
    choice. Against the old body with its live column and row formed as
    the kernels form them (``eta_live``) every value bit for bit; against
    the old body as it ran (``@``) the integers equal and the floats
    within ``_close``'s tolerance of the tableau's largest entry (bit for
    bit at t = 0, where there is no correction)."""
    opts, r, Tt, C, F, x, t = _edge(case, pair)
    eps = float(opts.eps_resolved)
    devex = opts.pivot_rule_resolved == "devex"
    T = PAIRS[pair][0]
    scale = float(Tt.abs().max())
    got, s, Cn, Fn = _new_pivot(opts, r, Tt, C, F, x, t)
    assert _same(Cn[:t], C[:t]) and _same(Fn[:t], F[:t])
    for live in (ke.eta_live, None):
        Cr, Fr = C.clone(), F.clone()
        want = solver.blocked_reference_pivot(Tt, Cr, Fr, t, x, r, opts,
                                              MAX_ITER, live)
        exact = live is not None or t == 0
        for n, g, w in [(n, got[n], want[n]) for n in CARRY] + [
                ("C[t]", Cn[t], Cr[t]), ("F[t]", Fn[t], Fr[t])]:
            if n in INTS or exact:
                assert _same(g, w.to(g.dtype)), (n, live)
            else:
                _close(g, w, T, n, scale)
        h, minc = solver._entering_blocked(want["costs"], want["w"],
                                           want["bland"], r, eps, devex)
        assert int(s.h) == int(h)
        if exact:
            assert _same(s.minc, minc)
        else:
            _close(s.minc, minc, T, "minc", scale)
    done = int(got["iterations"]) > int(x["iterations"])
    assert done == (case not in ("skipped", "fuse", "optimal", "unbounded"))
    if case == "unbounded":
        assert int(got["status"]) == int(Status.UNBOUNDED)
    if case == "optimal":
        assert int(got["status"]) == OPTIMAL
    if case == "bland_threshold":
        assert bool(got["bland"]) and int(got["stall"]) == \
            opts.bland_threshold
    if case == "devex_reanchor":
        assert bool((got["w"] == 1).all())
    if case == "devex":
        assert float(got["w"].max()) > 1.0


def _tables(tab):
    return dataclasses.replace(tab, Tt=tab.Tt.clone())


def _state(loop):
    s = loop.s
    got = dict(b=loop.b, costs=loop.costs, z=s.z, base=loop.base,
               status=s.status, iterations=s.iterations, stall=s.stall,
               bland=s.bland, Tt=loop.Tt)
    if loop.w is not None:
        got["w"] = loop.w
    return got


@pytest.mark.parametrize("rule", ["dantzig", "devex", "bland"])
@pytest.mark.parametrize("L", [2, 8, 12])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_loop_matches_the_old_body_every_window(pair, L, rule):
    """``BlockedLoop`` driven a window at a time (``run_blocked_window``,
    the plain versions) against ``blocked_reference_windows`` on the same
    tableau, re-priced from ``costs0`` every window on an f32 one. Against
    the old body with its live column and row formed as the kernels form
    them (``eta_live``) every value bit for bit at every window's end.
    Against the old body as it ran (``@``): on an f64 tableau at every
    window's end status, iterations, stall, Bland and the basis equal, b,
    the costs, z, the weights and the tableau within 1e-12 of the
    tableau's largest entry; on an f32 one, whose degenerate tail the two
    orders' roundings walk apart, both OPTIMAL within max(3, 10%) of each
    other's pivots."""
    opts = _options(pair, rule, L)
    tab, costs0 = _phase1(opts)
    T = PAIRS[pair][0]
    scale = float(tab.Tt.abs().max())
    for live in (ke.eta_live, None):
        if live is None and T != np.float64:
            _, gs, gi = solver.solve_loop_blocked(_tables(tab), opts, 5000,
                                                  costs0)
            _, ws, wi = solver.solve_loop_blocked_reference(
                _tables(tab), opts, 5000, costs0)
            assert gs == ws == OPTIMAL and abs(gi - wi) <= max(3, wi // 10)
            continue
        ref_tab = _tables(tab)
        loop = solver.blocked_loop(_tables(tab), opts, costs0)
        windows = 0
        for want in solver.blocked_reference_windows(ref_tab, opts, 5000,
                                                     costs0, live):
            solver.run_blocked_window(loop, opts, 5000)
            windows += 1
            want = dict(want, Tt=ref_tab.Tt)
            for n, g in _state(loop).items():
                w = want[n].to(g.dtype)
                if live is not None or n in INTS:
                    assert _same(g, w), (windows, n)
                else:
                    _close(g, w, T, f"window {windows} {n}", scale)
        assert int(want["status"]) == OPTIMAL
        wi = int(want["iterations"])
        assert wi > L and windows >= 2


@pytest.mark.parametrize("cap", [5, 13])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_fuse_stops_mid_window(pair, cap):
    """A capped run stops at exactly ``cap`` pivots inside a window of 8,
    status RUNNING, the old body's state; ``solve_loop_blocked`` returns
    the loop's b, costs, z and base and updates the caller's Tt."""
    opts = _options(pair, "dantzig", 8)
    tab, costs0 = _phase1(opts)
    T = PAIRS[pair][0]
    ref_tab, new_tab = _tables(tab), _tables(tab)
    want, st, it = solver.solve_loop_blocked_reference(ref_tab, opts, cap,
                                                       costs0)
    got, gst, git = solver.solve_loop_blocked(new_tab, opts, cap, costs0)
    assert st == gst == RUNNING and it == git == cap
    assert torch.equal(got.base, want.base.to(torch.int32))
    for n in ("b", "costs", "z"):
        _close(getattr(got, n), getattr(want, n), T, n)
    assert got.Tt is new_tab.Tt
    _close(got.Tt, want.Tt, T, "Tt")


@pytest.mark.parametrize("rule", ["devex", "bland"])
@pytest.mark.parametrize("L", [8, 12])
def test_loop_walks_as_jax_solve_loop_blocked(rule, L):
    """f64: the JAX package's ``solve_loop_blocked`` and the port's on the
    same eliminated phase-1 tableau (built by the JAX package) walk the
    same pivots to the same basis, b within 1e-9."""
    jopt = JaxOptions(block_pivots=L, pivot_rule=rule)
    popt = SolverOptions(block_pivots=L, pivot_rule=rule)
    rng = np.random.Generator(np.random.Philox(key=11))
    n, m = 80, 25
    A = jnp.asarray(rng.uniform(1, 100, (m, n)), jopt.dtype)
    b = jnp.asarray(rng.uniform(1, 100, (m,)), jopt.dtype)
    jtab = jax_eliminate(jax_build_phase1(A, b, n, m, jopt))
    wt, ws, wi = jax_solve_loop_blocked(jtab, jopt, 2000)
    gt, gs, gi = solver.solve_loop_blocked(tableau_from_numpy(
        jtab.T, jtab.b, jtab.costs, jtab.z, jtab.base, jtab.n, jtab.m,
        jtab.r), popt, 2000)
    assert gs == int(ws) == OPTIMAL and gi == int(wi)
    np.testing.assert_array_equal(gt.base.numpy(), np.asarray(wt.base))
    np.testing.assert_allclose(gt.b.numpy(), np.asarray(wt.b), rtol=1e-9,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# The sums' order, the window's structure and the loop's storage.

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eta_live_runs_in_order(dtype):
    """``eta_live`` is ``head - (((0 + c0 r0) + c1 r1) + ...)`` in f64, each
    product and sum rounded apart, then rounded to the head's dtype once;
    t = 0 gives the head."""
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((6, 50), generator=g, dtype=dtype)
    coef = torch.randn(6, generator=g, dtype=dtype)
    head = torch.randn(50, generator=g, dtype=dtype)
    acc = torch.zeros(50, dtype=torch.float64)
    for q in range(4):
        acc = acc + coef[q].double() * rows[q].double()
    assert _same(ke.eta_sum(coef, rows, 4), acc)
    assert _same(ke.eta_live(head, coef, rows, 4),
                 (head.double() - acc).to(dtype))
    assert _same(ke.eta_live(head, coef, rows, 0), head)


def test_run_window_enqueues_in_the_graphs_order(monkeypatch):
    """``run_blocked_window`` enqueues ``seq_step_pre`` once, then per
    pivot ``eta_ratio`` and ``eta_colk``, the last pivot's without the
    next pivot's step before: L pivots whatever the fuse; then the
    apply."""
    opts = _options("mixed", "devex", 8)
    tab, costs0 = _phase1(opts)
    loop = solver.blocked_loop(tab, opts, costs0)
    calls = []

    def record(name):
        real = getattr(solver, name)

        def call(*args, **kw):
            calls.append((name, kw.get("then_pre")))
            return real(*args, **kw)
        return call

    for name in ("seq_step_pre", "eta_ratio", "eta_colk"):
        monkeypatch.setattr(solver, name, record(name))
    solver.run_blocked_window(loop, opts, 3)
    assert [c[0] for c in calls] == ["seq_step_pre"] + [
        "eta_ratio", "eta_colk"] * 8
    tails = [c[1] for c in calls if c[0] == "eta_colk"]
    assert tails == [True] * 7 + [False]
    assert int(loop.s.iterations) == 3


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_blocked_loop_keeps_its_storage(monkeypatch, pair):
    """Every tensor of the loop's state keeps its ``data_ptr()`` from the
    first window to the last, and ``solve_loop_blocked`` returns the
    loop's b, costs, z and base and updates the caller's Tt in place."""
    opts = _options(pair, "devex", 8)
    tab, costs0 = _phase1(opts)
    loops, seen = [], []
    make, window = solver.blocked_loop, solver.run_blocked_window

    def ptrs(loop):
        out = {f.name: getattr(loop, f.name) for f in dataclasses.fields(loop)
               if f.name not in ("s", "r")}
        out.update(loop.s.tensors())
        return {n: x.data_ptr() for n, x in out.items() if x is not None}

    def blocked_loop(*a, **kw):
        loops.append(make(*a, **kw))
        return loops[-1]

    def run_blocked_window(loop, *a, **kw):
        seen.append(ptrs(loop))
        return window(loop, *a, **kw)

    monkeypatch.setattr(solver, "blocked_loop", blocked_loop)
    monkeypatch.setattr(solver, "run_blocked_window", run_blocked_window)
    out, status, iters = solver.solve_loop_blocked(tab, opts, 5000, costs0)
    assert status == OPTIMAL and len(seen) >= 2, (status, iters)
    assert all(p == seen[0] for p in seen[1:])
    loop = loops[0]
    assert loop.Tt is tab.Tt and out.Tt is tab.Tt
    assert out.b is loop.b and out.costs is loop.costs
    assert out.base is loop.base and out.z is loop.s.z
    assert loop.w is not None and (loop.costs0 is None) == (pair == "f64")


def test_eta_workspace_size():
    """The workspace's bytes follow csrc/eta.cu: 16, then 32 a block of
    ``eta_ratio`` and 80 a column block of ``eta_colk`` (its partial and
    the weights ``eta_colk_slice`` carries), on ``eta_grid``'s grid."""
    assert ke.eta_grid(64, 128) == (16, 32)
    assert ke.eta_workspace_bytes(64, 128) == 16 + 32 * 4 + 80 * 4
    assert ke.eta_workspace_bytes(65, 129) == 16 + 32 * 5 + 80 * 5
    assert ke.eta_grid(2048, 6144) == (32, 64)
    assert ke.eta_workspace(2048, 6144, "cpu").numel() == \
        16 + 32 * 64 + 80 * 96
    assert ke.eta_grid(8192, 24576) == (128, 256)
    assert ke.eta_workspace_bytes(8192, 24576) == 16 + 32 * 64 + 80 * 96
    assert ke.eta_grid(10112, 120064) == (128, 256)
    assert ke.eta_workspace_bytes(10112, 120064) == 16 + 32 * 79 + 80 * 469


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
    monkeypatch.setattr(ke, "_on_card", lambda *a: True)
    monkeypatch.setattr(ke, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    return got, _build.SIGNATURES[name]


def _values(args):
    return [a.value or 0 if isinstance(a, ctypes.c_void_p) else a
            for a in args]


def _seq_ptrs_of(arg, s):
    ptrs = ctypes.cast(arg, ctypes.POINTER(ks._SeqPtrs)).contents
    return [getattr(ptrs, n) for n, _ in ks._SeqPtrs._fields_] == [
        x.data_ptr() for x in s.tensors().values()]


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_eta_ratio_launch_is_wired(monkeypatch, pair):
    """``eta_ratio`` on the card, its library stubbed: one launch with as
    many arguments as its ctypes signature -- Tt, C, F, b and ah's
    pointers, M, R, L, t, eps, the workspace and its bytes, the scalars
    by reference, the pair's code, ``eta_plan``'s rows and columns a
    block and ``eta_ratio``'s slab rows a round -- counting one launch; no
    state moved."""
    opts = _options(pair, "dantzig", 8)
    tab, costs0 = _phase1(opts)
    loop = solver.blocked_loop(tab, opts, costs0)
    got, sig = _stub_card(monkeypatch, "eta_ratio_launch")
    state = {n: x.clone() for n, x in loop.s.tensors().items()}
    ke.reset_launches()
    M, R = loop.Tt.shape
    ke.eta_ratio(loop.Tt, loop.C, loop.F, loop.b, loop.ah, loop.s, 5, 1e-9,
                 loop.ws)
    (args,) = got
    assert len(args) == len(sig) == 18
    vals = _values(args)
    assert vals[:5] == [x.data_ptr() for x in (loop.Tt, loop.C, loop.F,
                                               loop.b, loop.ah)]
    assert vals[5:12] == [M, R, 8, 5, 1e-9, loop.ws.data_ptr(),
                          loop.ws.numel()]
    assert _seq_ptrs_of(args[12], loop.s)
    assert vals[13] == ks.PAIRS[(loop.Tt.dtype, loop.b.dtype)]
    plan = ke.eta_plan(M, R, 8, loop.Tt.element_size())
    assert vals[14:17] == [plan.rows, plan.cols, plan.stage_ratio]
    assert ke.LAUNCHES == {"eta_ratio": 1, "eta_colk": 0}
    for n, x in loop.s.tensors().items():
        assert _same(x, state[n]), n


@pytest.mark.parametrize("policy", [
    dict(bland_static=False, threshold=5, then_pre=True),
    dict(bland_static=True, threshold=5, then_pre=False),
    dict(bland_static=False, threshold=None, then_pre=True)],
    ids=["threshold", "static", "never"])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_eta_colk_launch_is_wired(monkeypatch, rule, policy):
    """``eta_colk`` on the card, its library stubbed: one launch with as
    many arguments as its ctypes signature -- the loop's eight tensors'
    pointers in order (w null but under devex), M, R, L, r, t, eps, the
    workspace and its bytes, the scalars by reference, max_iter, the
    Bland mode, threshold (0 for none), then_pre, the pair's code,
    ``eta_plan``'s rows and columns a block and ``eta_colk``'s slab rows a
    round -- counting one launch."""
    opts = _options("mixed", rule, 8)
    tab, costs0 = _phase1(opts)
    loop = solver.blocked_loop(tab, opts, costs0)
    got, sig = _stub_card(monkeypatch, "eta_colk_launch")
    ke.reset_launches()
    M, R = loop.Tt.shape
    ke.eta_colk(loop.Tt, loop.C, loop.F, loop.costs, loop.b, loop.base,
                loop.w, loop.ah, loop.s, 3, loop.r, 1e-9, 77, loop.ws,
                **policy)
    (args,) = got
    assert len(args) == len(sig) == 26
    vals = _values(args)
    assert vals[:8] == [0 if x is None else x.data_ptr() for x in (
        loop.Tt, loop.C, loop.F, loop.costs, loop.b, loop.base, loop.w,
        loop.ah)]
    assert (vals[6] != 0) == (rule == "devex")
    assert vals[8:16] == [M, R, 8, loop.r, 3, 1e-9, loop.ws.data_ptr(),
                          loop.ws.numel()]
    assert _seq_ptrs_of(args[16], loop.s)
    mode = (kb.BLAND_STATIC if policy["bland_static"] else kb.BLAND_NEVER
            if policy["threshold"] is None else kb.BLAND_THRESHOLD)
    plan = ke.eta_plan(M, R, 8, loop.Tt.element_size())
    assert vals[17:] == [77, mode, policy["threshold"] or 0,
                         int(policy["then_pre"]),
                         ks.PAIRS[(torch.float32, torch.float64)],
                         plan.rows, plan.cols, plan.stage_colk, 0]
    assert ke.LAUNCHES == {"eta_ratio": 0, "eta_colk": 1}


def test_eta_wrappers_check_their_operands():
    """A wrong dtype, shape or t raises before any launch."""
    opts = _options("f64", "dantzig", 8)
    tab, _ = _phase1(opts)
    loop = solver.blocked_loop(tab, opts)
    with pytest.raises(ValueError, match="outside the window"):
        ke.eta_ratio(loop.Tt, loop.C, loop.F, loop.b, loop.ah, loop.s, 8,
                     1e-9)
    with pytest.raises(ValueError, match="ah"):
        ke.eta_ratio(loop.Tt, loop.C, loop.F, loop.b, loop.ah.float(),
                     loop.s, 0, 1e-9)
    with pytest.raises(ValueError, match="costs"):
        ke.eta_colk(loop.Tt, loop.C, loop.F, loop.costs[1:], loop.b,
                    loop.base, None, loop.ah, loop.s, 0, loop.r, 1e-9, 10,
                    bland_static=False, threshold=3, then_pre=True)
