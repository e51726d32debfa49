"""The plain blocked sharded loop as one device program a window, on the CPU.

* Each pivot of the new loop (``parallel.sharded.run_blocked_pivot_
  sharded``: the candidates' ``all_gather``s, ``eta_fold_column``, the
  column's ``all_reduce``, ``eta_ratio_summed``, ``eta_colk_slice`` and,
  under devex, the re-anchor's ``all_gather``; their plain versions on CPU
  tensors) against the old body's pivot (``blocked_sharded_reference_
  pivot`` with its live column and row formed as the kernels form them,
  ``kernels.eta.eta_live``), rank by rank at P = 1, 2 and 3, through a
  whole window (t = 0 to L - 1) from edge states in f64, f32 with f64
  vectors and pure f32: a rank that owns h and ranks that do not, a tie of
  the smallest cost across two ranks, a rank with no eligible column,
  devex, a re-anchor crossing 1e8 on one rank only, Bland, a skipped
  pivot. Every field of every rank's state bit for bit after each pivot.
  The ranks are threads here, their collectives a rendezvous that stacks
  or sums their operands in rank order.
* ``solve_loop_blocked_sharded`` on P = 1, 2 and 3 gloo ranks (spawned
  processes; the eager path) against the single-card
  ``solver.solve_loop_blocked`` on the whole tableau, L = 8 and 13,
  Dantzig, devex and Bland, f64 and the f32 tableau re-priced from
  ``costs0``, whole walks and capped mid-window: at P = 1 every value bit
  for bit; at P = 2 and 3 the same walk and the states within the stated
  tolerance, b, z, the costs and the basis bit for bit.
* ``solve_resumable_sharded`` with the f64 blocked options on two gloo
  ranks against the single-card ``solve_resumable`` in the same windows
  and against ``solve_sharded``.
* The fold against ``fold_candidates``; the window's order; the loop's
  fixed storage; the operand checks; the card's launches with the kernel
  library stubbed (their arguments against the ctypes signatures, their
  launch counts).

The walks against the JAX package's ``solve_sharded`` are
tests/test_torch_sharded.py's, the collectives a pivot
tests/test_torch_guards.py's pinned counts. This file imports no JAX: a
spawned rank imports it by name.
"""

import ctypes
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from simplex_tpu_torch import solver
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import eta as ke
from simplex_tpu_torch.kernels import seq as ks
from simplex_tpu_torch.parallel import group as pg
from simplex_tpu_torch.parallel import sharded as ps
from simplex_tpu_torch.tableau import gaussian_eliminate

from test_torch_sharded_seq import (_on_threads, _same, _stub_card,
                                    _thread_collectives, _values)

RUNNING, OPTIMAL = int(Status.RUNNING), int(Status.OPTIMAL)
MAX_ITER = 60
L = 8
PAIRS = {"f64": (np.float64, np.float64), "mixed": (np.float32, np.float64),
         "f32": (np.float32, np.float32)}
#: The states each pivot-level case starts from (``_edge``).
CASES = ("walk", "cost_tie", "empty_rank", "devex", "devex_reanchor",
         "bland", "skipped")


# ---------------------------------------------------------------------------
# Each pivot against the old body's, from edge states.

def _options(pair, rule, L=L):
    T, V = PAIRS[pair]
    return SolverOptions(dtype=T, vector_dtype=V, block_pivots=L,
                         pivot_rule=rule,
                         eps=1e-9 if T == np.float64 else 1e-5)


def _whole(opts, P, n=30, m=12, seed=7):
    """The eliminated phase-1 tableau over all the columns, padded to P
    slices as the sharded loop pads them, and its pre-elimination
    costs."""
    p = generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
    tab = ps.build_phase1_sharded(
        torch.as_tensor(p.A), torch.as_tensor(p.b), n, m,
        pg.Shard(None, 0, 1, R_pad), opts, M_pad, "cpu")
    return gaussian_eliminate(tab), tab.costs


def _edge(case, pair, P):
    """The options, the whole tableau bent into ``case``'s state, the
    carry (status, iterations, stall, bland) and the global column whose
    devex weight starts at 3e8 (or None)."""
    rule = {"devex": "devex", "devex_reanchor": "devex",
            "bland": "bland"}.get(case, "dantzig")
    opts = _options(pair, rule)
    tab, _ = _whole(opts, P)
    tab = dataclasses.replace(tab, Tt=tab.Tt.clone(), costs=tab.costs.clone())
    R_loc = tab.Tt.shape[1] // P
    status, heavy = RUNNING, None
    if case == "cost_tie":
        # The smallest cost twice, on the last slice (or the same one at
        # P = 1) and on the first: the lower global index wins.
        h = int(torch.argmin(tab.costs[:tab.r]))
        other = R_loc * (P - 1) + 1 if P > 1 else min(h + 1, tab.r - 1)
        lo, hi = sorted((h, other))
        if lo == hi or hi >= tab.r:
            lo, hi = 0, tab.r - 1
        tab.Tt[:, hi] = tab.Tt[:, lo]
        tab.costs[hi] = tab.costs[lo] = tab.costs.min() - 1.0
    elif case == "empty_rank":
        # The middle slice (the last at P = 2; at P = 1 the first third of
        # the live columns) holds no eligible column.
        r0, width = ((P // 2) * R_loc, R_loc) if P > 1 else (0, tab.r // 3)
        tab.costs[r0:r0 + width] = tab.costs[r0:r0 + width].abs() + 1.0
    elif case == "devex_reanchor":
        # A weight past 1e8 on the last rank's first column: the first
        # pivot's largest weight passes the re-anchor's bound on that rank
        # only, and every rank's weights become 1.
        heavy = R_loc * (P - 1)
    elif case == "skipped":
        status = OPTIMAL
    carry = (torch.tensor(status, dtype=torch.int32),
             torch.tensor(2, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32),
             torch.tensor(rule == "bland"))
    return opts, tab, carry, heavy


def _both_ways(opts, tab, carry, heavy, P):
    """A window of L pivots on each of P thread ranks, one at a time, by
    the new loop (``run_blocked_pivot_sharded`` on the plain versions) and
    by ``blocked_sharded_reference_pivot`` (``eta_live``) from the same
    slices. Returns, a rank, [(new, old, (h, do))] a pivot."""
    R_loc = tab.Tt.shape[1] // P
    eps = float(opts.eps_resolved)

    def rank_fn(rank, group):
        shard = pg.Shard(group, rank, P, R_loc)
        mine = ps.shard_tableau(tab, rank, P)
        loop = ps.sharded_blocked_loop(dataclasses.replace(
            mine, Tt=mine.Tt.clone()), shard, opts)
        x = dict(b=mine.b, costs=mine.costs, z=mine.z,
                 base=mine.base.to(torch.int32), w=None, status=carry[0],
                 iterations=carry[1], stall=carry[2], bland=carry[3])
        if loop.w is not None:
            x["w"] = torch.ones_like(loop.w)
            if heavy is not None and heavy // R_loc == rank:
                x["w"][heavy - shard.offset] = 3e8
                loop.w.copy_(x["w"])
                loop.pack(eps)
        for dst, src in zip((loop.s.status, loop.s.iterations, loop.s.stall,
                             loop.s.bland), carry):
            dst.copy_(src)
        Tr = loop.Tt.clone()
        C = torch.zeros_like(loop.C)
        F = torch.zeros_like(loop.F)
        out = []
        for t in range(L):
            ps.run_blocked_pivot_sharded(loop, t, opts, MAX_ITER)
            x = ps.blocked_sharded_reference_pivot(
                Tr, C, F, t, x, shard, tab.r, opts, MAX_ITER, ke.eta_live)
            s = loop.s
            new = dict(b=loop.b, costs=loop.costs, z=s.z, base=loop.base,
                       status=s.status, iterations=s.iterations,
                       stall=s.stall, bland=s.bland, C=loop.C[t],
                       F=loop.F[t])
            if loop.w is not None:
                # The re-anchor the next fold applies.
                new["w"] = torch.where(loop.recv_w.max() > 1e8, 1.0, loop.w)
            old = dict(x, C=C[t], F=F[t])
            out.append(({k: v.clone() for k, v in new.items()},
                        {k: v.clone() for k, v in old.items()
                         if v is not None},
                        (int(s.h), bool(s.do))))
        assert torch.equal(loop.Tt, Tr)
        return out

    return _on_threads(P, rank_fn)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plain_pivots_match_the_old_body(monkeypatch, pair, P, case):
    """A window of L = 8 pivots of ``run_blocked_pivot_sharded`` (the plain
    versions of ``eta_fold_column``, ``eta_ratio_summed`` and
    ``eta_colk_slice``) against ``blocked_sharded_reference_pivot`` with
    ``eta_live`` from one edge state on P thread ranks: every rank's b,
    costs, z, base, devex weights (the new loop's with the re-anchor its
    next fold applies), status, iterations, stall, Bland flag, C[t] and
    F[t] bit for bit after every pivot, t = 0 to L - 1, and every rank's
    entering h alike."""
    _thread_collectives(monkeypatch)
    opts, tab, carry, heavy = _edge(case, pair, P)
    ranks = _both_ways(opts, tab, carry, heavy, P)
    for rank, pivots in enumerate(ranks):
        for t, (new, old, (h, do)) in enumerate(pivots):
            assert (h, do) == ranks[0][t][2], (rank, t)
            assert new.keys() == old.keys()
            for name in new:
                assert _same(new[name], old[name].to(new[name].dtype)), \
                    (rank, t, name)
    done = [do for _, _, (_, do) in ranks[0]]
    assert any(done) == (case != "skipped"), done
    if case == "walk":
        assert all(done), done
    if case == "devex_reanchor":
        # The first pivot's weights re-anchored on every rank.
        assert all(bool((r[0][0]["w"] == 1).all()) for r in ranks)
    if case == "devex":
        assert float(ranks[0][-1][0]["w"].max()) > 1.0


def test_the_fold_is_fold_candidates_s():
    """``kernels.eta.slice_fold`` on gathered candidates against
    ``fold_candidates``' fold: a tie of the smallest value on two ranks
    (the lower rank), a rank with no Bland candidate, a NaN value (rank
    0's), no eligible column anywhere; under devex the key's tie and a
    NaN key, the weights riding along, and the re-anchor (the largest
    weight past 1e8 on one rank) switching to the candidates on weights of
    1 with weights 1."""
    BIG = kb.BIG_INDEX
    inf, nan = np.inf, np.nan
    dantzig = {"tie": ([[-2.0, -1.0], [-3.0, -0.5], [-3.0, -2.0]],
                       [[1, 3], [12, 14], [23, 21]]),
               "no_bland": ([[-2.0, inf], [-1.0, -0.5], [-0.5, inf]],
                            [[2, BIG], [13, 13], [20, BIG]]),
               "nan": ([[-2.0, -1.0], [nan, -0.5], [-4.0, -2.0]],
                       [[2, 2], [13, 13], [20, 21]]),
               "none": ([[0.5, inf], [0.25, inf], [1.0, inf]],
                        [[2, BIG], [13, BIG], [20, BIG]])}
    for name, (vals, idxs) in dantzig.items():
        V = torch.tensor(vals, dtype=torch.float64)
        I = torch.tensor(idxs, dtype=torch.int32)
        h_d, v_d, w_d, h_b, v_b, w_b, reset = ke.slice_fold(V, I)
        key = -V[:, 0]
        od = int(torch.argmax((key == key.max()).to(torch.int8)))
        ob = int(torch.argmin(I[:, 1]))
        assert (int(h_d), int(h_b)) == (int(I[od, 0]), int(I[ob, 1])), name
        assert _same(v_d, V[od, 0]) and _same(v_b, V[ob, 1]), name
        assert float(w_d) == float(w_b) == 1.0 and not bool(reset)
    # Devex: [v_d, v_b, w_d, w_b, key, v_d1, key1], [h_d, h_b, h_d1].
    V = torch.tensor([[-2.0, -1.0, 4.0, 2.0, 1.0, -2.0, 4.0],
                      [-3.0, -0.5, 9.0, 3.0, 1.0, -3.0, 9.0],
                      [-1.0, -2.0, 1.0, 5.0, 1.0, -1.0, 1.0]],
                     dtype=torch.float64)
    I = torch.tensor([[1, 3, 1], [12, 14, 12], [23, 21, 23]],
                     dtype=torch.int32)
    for big, want in ((1e8, (0, 1, 4.0, 3, -1.0, 2.0)),
                      (3e8, (1, 12, 1.0, 3, -1.0, 1.0))):
        W = torch.tensor([1.0, 2.0, big], dtype=torch.float64)
        h_d, v_d, w_d, h_b, v_b, w_b, reset = ke.slice_fold(V, I, W)
        od = want[0]
        assert bool(reset) == (big > 1e8)
        assert int(h_d) == want[1] and float(w_d) == want[2]
        assert _same(v_d, V[od, 5 if big > 1e8 else 0])
        assert (int(h_b), float(v_b), float(w_b)) == want[3:]
    Vn = V.clone()
    Vn[2, 4] = nan
    h_d, *_ = ke.slice_fold(Vn, I, torch.ones(3, dtype=torch.float64))
    assert int(h_d) == 1


#: (rule, case) of the fold's owner invariant: a plain draw, a re-anchor (a
#: weight past 1e8 on the last slice only), a NaN key on the last slice (a
#: NaN cost, or under devex a NaN weight at an eligible column: rank 0's
#: candidate wins), a slice with no eligible column (no Bland candidate,
#: ``BIG_INDEX``).
OWNER_CASES = [("dantzig", "plain"), ("dantzig", "nan"), ("dantzig", "empty"),
               ("devex", "plain"), ("devex", "reanchor"), ("devex", "nan"),
               ("devex", "empty")]


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("rule,case", OWNER_CASES,
                         ids=[f"{r}-{c}" for r, c in OWNER_CASES])
def test_fold_picks_one_of_its_owners_candidates(rule, case, P):
    """Over seeded packs (``pack_slice``) of P slices, the h that
    ``slice_fold`` and ``step_pre_plain`` pick, Bland on and off, lies on
    exactly one slice and is one of that slice's own ``send_i`` entries:
    so exactly one rank writes the live column, and the columns a rank's
    own candidates select hold the one it picks (what sending for them
    before the fold would rest on)."""
    rng = np.random.default_rng(1000 * P + OWNER_CASES.index((rule, case)))
    devex = rule == "devex"
    kv, ki = ke.SLICE_PACK[devex]
    R_loc, r_loc, eps = 9, 7, 1e-9
    f64 = torch.float64
    seen = set()
    for trial in range(12):
        packs = []
        for rank in range(P):
            costs = torch.tensor(rng.normal(size=R_loc))
            w = torch.tensor(rng.uniform(1.0, 5.0, R_loc)) if devex else None
            if case == "empty" and rank == P // 2:
                costs = costs.abs() + 1.0
            elif case == "nan" and rank == P - 1:
                # Dantzig's key is the cost, devex's cost^2 / w.
                col = int(rng.integers(r_loc))
                if devex:
                    costs[col], w[col] = -1.0, float("nan")
                else:
                    costs[col] = float("nan")
            elif case == "reanchor" and rank == P - 1:
                w[int(rng.integers(R_loc))] = 3e8
            v, i = torch.empty(kv, dtype=f64), torch.empty(ki,
                                                          dtype=torch.int32)
            mx = torch.empty((), dtype=f64) if devex else None
            ke.pack_slice(costs, w, r_loc, eps, rank * R_loc, v, i, mx)
            packs.append((v, i, mx))
        V = torch.stack([v for v, _, _ in packs])
        I = torch.stack([i for _, i, _ in packs])
        W = torch.stack([mx for _, _, mx in packs]) if devex else None
        h_d, v_d, _, h_b, v_b, _, reset = ke.slice_fold(V, I, W)
        assert bool(reset) == (case == "reanchor")
        if case == "reanchor":                  # on weights of 1
            assert int(h_d) in I[:, 2].tolist()
        elif case == "nan":                     # a NaN key: rank 0's
            assert int(h_d) == int(I[0, 0])
        for bland in (False, True):
            s = ks.seq_scalars(torch.tensor(0.0, dtype=f64), bland, f64)
            ks.set_candidates(s, (h_d, v_d, h_b, v_b))
            kb.step_pre_plain(s, MAX_ITER, eps)
            h = int(s.h)
            owners = [r for r in range(P) if 0 <= h - r * R_loc < R_loc]
            assert len(owners) == 1, (trial, bland, h)
            slot = I[owners[0]].tolist().index(h)
            seen.add((bland, slot))
    # Bland's candidate was picked too, not the main one alone.
    assert (True, 1) in seen or case == "empty" and P == 1, seen


def test_pack_is_entering_sharded_s(monkeypatch):
    """``pack_slice`` holds what ``entering_sharded`` gathered (values,
    riders and key, then global indices), with and without eligible
    columns, under Dantzig and devex; the candidates on weights of 1 are
    ``entering_sharded``'s on weights reset to 1."""
    _thread_collectives(monkeypatch)
    eps = 1e-9
    costs = torch.tensor([0.5, -2.0, 3.0, -2.0, -1.0, 7.0],
                         dtype=torch.float64)
    w = torch.tensor([1.0, 9.0, 2.0, 1.5, 1.0, 4.0], dtype=torch.float64)
    got = {}

    def rank_fn(rank, group):
        sh = pg.Shard(group, 0, 1, 6)
        for c, r in ((costs, 5), (costs.abs(), 6), (costs, 0)):
            for ww in (None, w):
                kv, ki = ke.SLICE_PACK[ww is not None]
                v = torch.empty(kv, dtype=torch.float64)
                i = torch.empty(ki, dtype=torch.int32)
                mx = torch.empty((), dtype=torch.float64)
                ke.pack_slice(c, ww, r, eps, 0, v, i, mx)
                h, minc, wh = ps.entering_sharded(c, torch.tensor(False), r,
                                                  eps, sh, ww)
                assert int(h) == int(i[0]) and _same(minc, v[0])
                if ww is not None:
                    assert _same(wh, v[2]) and float(mx) == 9.0
                    h1, m1, w1 = ps.entering_sharded(
                        c, torch.tensor(False), r, eps, sh,
                        torch.ones_like(ww))
                    assert int(h1) == int(i[2]) and _same(m1, v[5])
                hb, mb, _ = ps.entering_sharded(c, torch.tensor(True), r,
                                                eps, sh, ww)
                if int(i[1]) < kb.BIG_INDEX:
                    assert int(hb) == int(i[1]) and _same(mb, v[1])
                else:
                    assert float(v[1]) == np.inf
                got[(r, ww is not None)] = v.clone()
        return True

    assert _on_threads(1, rank_fn) == [True]
    assert got[(0, True)][3] == 1.0


# ---------------------------------------------------------------------------
# solve_loop_blocked_sharded against the single-card loop on gloo ranks.

#: (options, cap) the gloo runs take: f64 Dantzig L = 13 whole and capped
#: mid-window, f64 devex, f64 Bland, the mixed f32 tableau re-priced from
#: costs0, pure f32 devex.
LOOP_CASES = [
    (dict(block_pivots=13), 5000), (dict(block_pivots=13), 20),
    (dict(block_pivots=8, pivot_rule="devex"), 5000),
    (dict(block_pivots=8, pivot_rule="bland"), 5000),
    (dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
          block_pivots=8, use_pallas=False), 5000),
    (dict(dtype=np.float32, vector_dtype=np.float32, eps=1e-4,
          block_pivots=13, use_pallas=False, pivot_rule="devex"), 5000),
]


def loops_rank(group, device, problem, cases):
    """For ``group.spawn``: each case's phase-1 slice through
    ``solve_loop_blocked_sharded`` (the eager path over gloo) and the
    whole phase-1 tableau through ``solver.solve_loop_blocked``. Returns
    rank 0's [(the sharded (status, iterations), b, z, base, costs and Tt
    gathered (P, ...), the single-card (status, iterations) and its
    state)] a case."""
    n, m = problem.vars, problem.constraints
    P = pg.dist.get_world_size(group)
    out = []
    for fields, cap in cases:
        opts = SolverOptions(**fields)
        R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
        shard = pg.Shard.of(group, R_pad)
        tab = ps.build_phase1_sharded(
            torch.as_tensor(problem.A),
            torch.as_tensor(problem.b, device=device), n, m, shard, opts,
            M_pad, device)
        costs0 = tab.costs
        tab = ps.gaussian_eliminate_sharded(tab, shard)
        got, st, it = ps.solve_loop_blocked_sharded(tab, shard, opts, cap,
                                                    costs0)
        costs = pg.gather(got.costs, group)
        Tt = pg.gather(got.Tt, group)
        whole = pg.Shard(None, 0, 1, R_pad)
        wtab = ps.build_phase1_sharded(
            torch.as_tensor(problem.A), torch.as_tensor(problem.b), n, m,
            whole, opts, M_pad, "cpu")
        wcosts0 = wtab.costs
        wtab = gaussian_eliminate(wtab)
        want, wst, wit = solver.solve_loop_blocked(wtab, opts, cap, wcosts0)
        out.append(((st, it), dict(b=got.b, z=got.z, base=got.base,
                                   costs=costs, Tt=Tt),
                    (wst, wit), dict(b=want.b, z=want.z, base=want.base,
                                     costs=want.costs, Tt=want.Tt)))
    return out


def _loop_runs(P, problem):
    if P == 1:
        with tempfile.TemporaryDirectory() as td, \
                pg.world(0, 1, "gloo", td) as group:
            return loops_rank(group, torch.device("cpu"), problem,
                              LOOP_CASES)
    return pg.spawn(loops_rank, P, "gloo", "cpu", problem, LOOP_CASES)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_eager_loop_matches_the_single_card_loop(P):
    """Each ``LOOP_CASES`` entry through ``solve_loop_blocked_sharded`` on
    P gloo ranks (the eager path, the plain versions) and through the
    single-card ``solve_loop_blocked`` on the whole tableau: the same
    status and iterations (a cap mid-window trips the fuse there); at P = 1
    b, z, the basis, the costs and the tableau bit for bit; at P = 2 and 3
    b, z, the basis and the costs bit for bit too (the same arithmetic on
    each slice and on replicated values) and the tableau, whose apply
    sums over each slice apart, within 1e-12 of its largest entry (f64) or
    1e-5 (f32)."""
    problem = generate_random_problem(72, 28, 11, 1, 100)
    runs = _loop_runs(P, problem)
    for (fields, cap), (got, gs, want, ws) in zip(LOOP_CASES, runs):
        assert got == want, (fields, cap, got, want)
        assert got[0] == (OPTIMAL if cap == 5000 else RUNNING)
        assert cap == 5000 or got[1] == cap
        R_pad = ws["Tt"].shape[1]
        whole = {"costs": gs["costs"].reshape(-1),
                 "Tt": torch.cat(list(gs["Tt"].unbind(0)), dim=1)}
        assert whole["costs"].shape == (R_pad,)
        for name in ("b", "z", "base", "costs"):
            g = whole.get(name, gs[name])
            assert _same(g, ws[name]), (fields, P, name)
        if P == 1:
            assert _same(whole["Tt"], ws["Tt"]), fields
        else:
            tol = 1e-12 if gs["Tt"].dtype == torch.float64 else 1e-5
            scale = float(ws["Tt"].abs().max())
            err = float((whole["Tt"] - ws["Tt"]).abs().max())
            assert err <= tol * scale, (fields, err)


def resumable_rank(group, device, problem, path, every, opts):
    """For ``group.spawn``: ``solve_resumable_sharded`` of ``problem`` in
    windows of ``every`` pivots, then ``solve_sharded``: the two
    results."""
    from simplex_tpu_torch.checkpoint import solve_resumable_sharded

    got = solve_resumable_sharded(problem, group, path, every, opts,
                                  device=device)
    return got, ps.solve_sharded(problem, group, opts, device=device)


def test_resumable_sharded_runs_the_new_loop(tmp_path):
    """``solve_resumable_sharded`` with the f64 blocked options (L = 8,
    devex) on two gloo ranks, in windows of 25 pivots, each window a call
    of the plain blocked sharded loop: OPTIMAL, the walk and the objective
    of the single-card ``solve_resumable`` in the same windows (the same
    arithmetic on each slice), and within 1e-9 of ``solve_sharded`` in one
    call; the file removed."""
    from simplex_tpu_torch.checkpoint import solve_resumable

    problem = generate_random_problem(96, 40, 5, 1, 100)
    opts = SolverOptions(block_pivots=8, pivot_rule="devex")
    path = str(tmp_path / "run.npz")
    got, whole = pg.spawn(resumable_rank, 2, "gloo", "cpu", problem, path,
                          25, opts)
    want = solve_resumable(problem, str(tmp_path / "one.npz"), 25, opts,
                           device="cpu")
    walk = (got.iterations_phase1, got.iterations_phase2)
    assert got.status == want.status == whole.status == Status.OPTIMAL
    assert walk == (want.iterations_phase1, want.iterations_phase2)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.objective == pytest.approx(whole.objective, rel=1e-9)
    assert sum(walk) > 25
    assert not (tmp_path / "run.npz").exists()


# ---------------------------------------------------------------------------
# The window's structure, the loop's storage and the card's launches.

def _phase1_slice(problem, shard, opts):
    n, m = problem.vars, problem.constraints
    _, M_pad = ps.sharded_padded_dims(n, m, shard.size, opts)
    tab = ps.build_phase1_sharded(torch.as_tensor(problem.A),
                                  torch.as_tensor(problem.b), n, m, shard,
                                  opts, M_pad, "cpu")
    costs0 = tab.costs
    return ps.gaussian_eliminate_sharded(tab, shard), costs0


@pytest.mark.parametrize("fields", [
    dict(block_pivots=8), dict(block_pivots=8, pivot_rule="devex"),
    dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5, block_pivots=8,
         use_pallas=False)], ids=["f64", "devex", "f32-reprice"])
def test_window_enqueues_in_the_graphs_order(monkeypatch, tmp_path, fields):
    """``run_blocked_window_sharded`` enqueues per pivot the two candidate
    ``all_gather``s, ``eta_fold_column``, the ``all_reduce``,
    ``eta_ratio_summed``, ``eta_colk_slice`` and under devex the
    re-anchor's ``all_gather``; then on an f32 tableau the re-pricing's
    ``all_reduce`` and ``all_gather``: L pivots whatever the fuse, the
    ones past it skipped."""
    opts = SolverOptions(**fields)
    problem = generate_random_problem(40, 16, 2, 1, 100)
    calls = []
    names = ("all_gather_into", "eta_fold_column", "all_reduce_",
             "eta_ratio_summed", "eta_colk_slice")

    def record(name):
        real = getattr(ps, name)

        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        R_pad, _ = ps.sharded_padded_dims(40, 16, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        tab, costs0 = _phase1_slice(problem, shard, opts)
        loop = ps.sharded_blocked_loop(tab, shard, opts, costs0)
        for name in names:
            monkeypatch.setattr(ps, name, record(name))
        pg.reset_counts()
        ps.run_blocked_window_sharded(loop, opts, 5)
    devex = opts.pivot_rule_resolved == "devex"
    reprice = loop.costs0 is not None
    body = ["all_gather_into", "all_gather_into", "eta_fold_column",
            "all_reduce_", "eta_ratio_summed", "eta_colk_slice"]
    body += ["all_gather_into"] * devex
    assert calls == body * 8 + ["all_reduce_", "all_gather_into"] * reprice
    assert int(loop.s.iterations) == 5
    assert pg.COUNTS == {"all_gather": (2 + devex) * 8 + reprice,
                         "all_reduce": 8 + reprice}


@pytest.mark.parametrize("fields", [
    dict(block_pivots=8, pivot_rule="devex"),
    dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5, block_pivots=8,
         use_pallas=False)], ids=["f64-devex", "f32-reprice"])
def test_sharded_blocked_loop_keeps_its_storage(monkeypatch, tmp_path,
                                                fields):
    """Every tensor of the loop's state, its collectives' buffers included,
    keeps its ``data_ptr()`` from the first window to the last;
    ``solve_loop_blocked_sharded`` returns the loop's b, costs, z and base
    and updates the caller's slice in place; the buffers have the shapes
    the collectives need."""
    opts = SolverOptions(**fields)
    problem = generate_random_problem(96, 40, 4, 1, 100)
    loops, seen = [], []
    make, window = ps.sharded_blocked_loop, ps.run_blocked_window_sharded

    def ptrs(loop):
        out = {f.name: getattr(loop, f.name)
               for f in dataclasses.fields(loop)
               if isinstance(getattr(loop, f.name), torch.Tensor)}
        out.update(loop.s.tensors())
        return {n: x.data_ptr() for n, x in out.items()}

    def sharded_blocked_loop(*a, **kw):
        loops.append(make(*a, **kw))
        return loops[-1]

    def run_window(loop, *a, **kw):
        seen.append(ptrs(loop))
        return window(loop, *a, **kw)

    monkeypatch.setattr(ps, "sharded_blocked_loop", sharded_blocked_loop)
    monkeypatch.setattr(ps, "run_blocked_window_sharded", run_window)
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        R_pad, _ = ps.sharded_padded_dims(96, 40, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        tab, costs0 = _phase1_slice(problem, shard, opts)
        out, status, iters = ps.solve_loop_blocked_sharded(tab, shard, opts,
                                                           5000, costs0)
    assert status == OPTIMAL and len(seen) >= 2, (status, iters)
    assert all(p == seen[0] for p in seen[1:])
    loop = loops[0]
    assert loop.Tt is tab.Tt and out.Tt is tab.Tt
    assert out.b is loop.b and out.costs is loop.costs
    assert out.z is loop.s.z and out.base is loop.base
    kv, ki = ke.SLICE_PACK[loop.w is not None]
    assert loop.send_v.shape == (kv,) and loop.recv_v.shape == (1, kv)
    assert loop.send_i.shape == (ki,) and loop.recv_i.shape == (1, ki)
    assert loop.recv_i.dtype == torch.int32
    if loop.w is not None:
        assert loop.recv_w.shape == (1,) and loop.wh.shape == ()
    if loop.costs0 is not None:
        assert loop.recv_min.shape == (1,)
        assert loop.coef.shape == loop.b.shape


def test_slice_kernels_check_their_operands():
    """The wrappers refuse buffers of another dtype or shape, a devex
    fold without its weights, and weights' buffers without devex, before
    any launch."""
    T = torch.float64
    s = ks.seq_scalars(torch.tensor(0.0, dtype=T), False, T)
    M, R = 8, 6
    Tt = torch.zeros((M, R), dtype=T)
    C = torch.zeros((L, R), dtype=T)
    F = torch.zeros((L, M), dtype=T)
    ah = torch.zeros(M, dtype=T)
    V = torch.zeros((2, 2), dtype=torch.float64)
    I = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="V"):
        ke.eta_fold_column(Tt, C, F, V.float(), I, None, ah, None, None, s,
                           0, 10, 1e-9, 0)
    with pytest.raises(ValueError, match="I"):
        ke.eta_fold_column(Tt, C, F, V, I[:, :1].contiguous(), None, ah,
                           None, None, s, 0, 10, 1e-9, 0)
    Vd = torch.zeros((2, 7), dtype=torch.float64)
    Id = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="devex"):
        ke.eta_fold_column(Tt, C, F, Vd, Id, None, ah, None, None, s, 0, 10,
                           1e-9, 0)
    with pytest.raises(ValueError, match="t="):
        ke.eta_fold_column(Tt, C, F, V, I, None, ah, None, None, s, L, 10,
                           1e-9, 0)
    with pytest.raises(ValueError, match="ah"):
        ke.eta_ratio_summed(torch.zeros(M, dtype=T), ah.float(), s, 1e-9)
    vec = dict(costs=torch.zeros(R, dtype=T), b=torch.zeros(M, dtype=T),
               base=torch.zeros(M, dtype=torch.int32), w=None, ah=ah)
    send = dict(send_v=torch.zeros(2, dtype=torch.float64),
                send_i=torch.zeros(2, dtype=torch.int32), send_w=None)
    kw = dict(offset=0, wh=None, bland_static=False, threshold=50)
    with pytest.raises(ValueError, match="send_v"):
        ke.eta_colk_slice(Tt, C, F, *vec.values(), s, 0, R, 1e-9, 10,
                          **dict(send, send_v=torch.zeros(7, dtype=T)), **kw)
    with pytest.raises(ValueError, match="send_w"):
        ke.eta_colk_slice(Tt, C, F, *vec.values(), s, 0, R, 1e-9, 10,
                          **dict(send, send_w=torch.zeros((), dtype=T)),
                          **kw)
    with pytest.raises(ValueError, match="send_i"):
        ke.eta_colk_slice(Tt, C, F, *dict(vec, w=torch.ones(R, dtype=T))
                          .values(), s, 0, R, 1e-9, 10,
                          **dict(send, send_v=torch.zeros(7, dtype=T),
                                 send_w=torch.zeros((), dtype=T)),
                          **dict(kw, wh=torch.ones((), dtype=T)))


def _slice_set(T, V, M, R, P, devex):
    """Operands of the three kernels at (M, R) with P ranks' buffers."""
    s = ks.seq_scalars(torch.tensor(0.0, dtype=V), False, T)
    kv, ki = ke.SLICE_PACK[devex]
    return dict(
        s=s, Tt=torch.zeros((M, R), dtype=T), C=torch.zeros((L, R), dtype=T),
        F=torch.zeros((L, M), dtype=T), ah=torch.zeros(M, dtype=T),
        b=torch.zeros(M, dtype=V), costs=torch.zeros(R, dtype=V),
        base=torch.zeros(M, dtype=torch.int32),
        w=torch.ones(R, dtype=V) if devex else None,
        wh=torch.ones((), dtype=V) if devex else None,
        V=torch.zeros((P, kv), dtype=torch.float64),
        I=torch.zeros((P, ki), dtype=torch.int32),
        W=torch.zeros(P, dtype=torch.float64) if devex else None,
        send_v=torch.zeros(kv, dtype=torch.float64),
        send_i=torch.zeros(ki, dtype=torch.int32),
        send_w=torch.zeros((), dtype=torch.float64) if devex else None,
        ws=ke.eta_workspace(M, R, "cpu"))


def _stub(monkeypatch, name):
    got, sig = _stub_card(monkeypatch, name)
    monkeypatch.setattr(ke, "_on_card", lambda *a: True)
    monkeypatch.setattr(ke, "_stream", lambda x: ctypes.c_void_p(0))
    return got, sig


@pytest.mark.parametrize("devex", [False, True], ids=["dantzig", "devex"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_slice_launches_are_wired(monkeypatch, pair, devex):
    """The three kernels on the card: one call of each entry point with as
    many arguments as its ctypes signature -- the buffers, the shape, the
    window's place, the offset, the gathered buffers and their ranks, the
    weights' buffers (null without devex), the scalars, the fuse, eps,
    the Bland policy, the dtype pair and ``eta_plan``'s grid -- and one
    launch counted each."""
    T, V = (getattr(torch, np.dtype(d).name) for d in PAIRS[pair])
    M, R, P, t, off = 40, 24, 3, 5, 48
    x = _slice_set(T, V, M, R, P, devex)
    s = x["s"]
    plan = ke.eta_plan(M, R, L, x["Tt"].element_size())
    pair_code = ks.PAIRS[(T, V)]
    ptr = lambda k: 0 if x[k] is None else x[k].data_ptr()  # noqa: E731
    ke.reset_launches()

    got, sig = _stub(monkeypatch, "eta_fold_column_launch")
    ke.eta_fold_column(x["Tt"], x["C"], x["F"], x["V"], x["I"], x["W"],
                       x["ah"], x["w"], x["wh"], s, t, 77, 1e-9, off)
    (args,) = got
    assert len(args) == len(sig)
    vals = _values(args)
    assert vals[:4] == [ptr(k) for k in ("Tt", "C", "F", "ah")]
    assert vals[4:9] == [M, R, L, t, off]
    assert vals[9:14] == [ptr("V"), ptr("I"), ptr("W"), P,
                          ke.SLICE_PACK[devex][0]]
    assert vals[14:16] == [ptr("w"), ptr("wh")]
    assert vals[17:22] == [77, 1e-9, pair_code, plan.rows, plan.stage_ratio]

    got, sig = _stub(monkeypatch, "eta_ratio_summed_launch")
    ke.eta_ratio_summed(x["b"], x["ah"], s, 1e-9)
    (args,) = got
    assert len(args) == len(sig)
    vals = _values(args)
    assert vals[:4] == [ptr("b"), ptr("ah"), M, 1e-9]
    assert vals[5] == pair_code

    got, sig = _stub(monkeypatch, "eta_colk_slice_launch")
    ke.eta_colk_slice(x["Tt"], x["C"], x["F"], x["costs"], x["b"],
                      x["base"], x["w"], x["ah"], s, t, 17, 1e-9, 77,
                      x["ws"], offset=off, wh=x["wh"], send_v=x["send_v"],
                      send_i=x["send_i"], send_w=x["send_w"],
                      bland_static=False, threshold=3)
    (args,) = got
    assert len(args) == len(sig)
    vals = _values(args)
    assert vals[:8] == [ptr(k) for k in ("Tt", "C", "F", "costs", "b",
                                         "base", "w", "ah")]
    assert vals[8:14] == [M, R, L, 17, t, 1e-9]
    assert vals[17:19] == [77, kb._bland_mode(False, 3)]
    assert vals[20:24] == [pair_code, plan.rows, plan.cols, plan.stage_colk]
    assert vals[24:29] == [off, ptr("wh"), ptr("send_v"), ptr("send_i"),
                           ptr("send_w")]
    assert ke.SLICE_LAUNCHES == {"eta_fold_column": 1, "eta_ratio_summed": 1,
                                 "eta_colk_slice": 1}
