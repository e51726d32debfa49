"""The sequential sharded loop as one device program a chunk, on the CPU.

* Each pivot of the new loop (``parallel.sharded.run_chunk_sharded``:
  the two candidate ``all_gather``s, ``seq_fold_column``, the column's
  ``all_reduce``, ``seq_ratio_colk_sharded`` and ``seq_rank1``, their
  plain versions on CPU tensors) against the eager body it replaces
  (``iteration_body_sharded``), rank by rank at P = 1, 2 and 3, from edge
  states in f64, f32 with f64 vectors and pure f32: a NaN in b, a tie of
  the smallest cost across two ranks, a rank with no eligible column,
  no eligible row (unbounded), no improving column (optimal), Bland
  static, by its threshold and never, a skipped pivot and the fuse.
  Every field of every rank's state bit for bit after each pivot. The
  ranks are threads here, their collectives a rendezvous that stacks or
  sums their operands in rank order.
* ``solve_loop_sharded`` on P = 1, 2 and 3 gloo ranks (spawned
  processes; the eager path) against the old body driven as it was, one
  host read a chunk of ``SEQ_CHUNK``: the state bit for bit at every
  chunk's end, whole walks and capped ones.
* ``run_chunk_sharded``'s order; the loop's fixed storage from its first
  chunk to its last; the collectives a pivot; the card's launches with
  the kernel library stubbed (their arguments against the ctypes
  signatures, their launch counts).

The walks against the JAX package's ``solve_sharded`` and the port's
``solve`` at P = 1, 2 and 3 are tests/test_torch_sharded.py's, the
collectives a pivot tests/test_torch_guards.py's pinned counts. This file
imports no JAX: a spawned rank imports it by name.
"""

import ctypes
import dataclasses
import tempfile
import threading

import numpy as np
import pytest
import torch

from simplex_tpu_torch import solver
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.kernels import seq as ks
from simplex_tpu_torch.parallel import group as pg
from simplex_tpu_torch.parallel import sharded as ps
from simplex_tpu_torch.tableau import gaussian_eliminate

RUNNING, OPTIMAL = int(Status.RUNNING), int(Status.OPTIMAL)
MAX_ITER = 40
PAIRS = {"f64": (np.float64, np.float64), "mixed": (np.float32, np.float64),
         "f32": (np.float32, np.float32)}
#: The states each case starts from (applied by ``_edge``).
CASES = ("walk", "nan_b", "tie", "cost_tie", "empty_rank", "unbounded",
         "optimal", "bland_static", "bland_threshold", "bland_never",
         "skipped", "fuse")


# ---------------------------------------------------------------------------
# The old loop: the eager body driven as it was.

def drive(body, state, max_iter: int, states: list | None = None):
    """Run ``body`` (a ``solver.LoopState`` pivot) until the loop exits,
    reading status and iterations once a chunk of at most ``SEQ_CHUNK``
    pivots (never past the fuse), as the eager loops ran. Appends each
    chunk's end state to ``states``. Returns (state, status,
    iterations); status stays RUNNING when the fuse tripped."""
    st, it = RUNNING, 0
    while st == RUNNING and it < max_iter:
        for _ in range(min(solver.SEQ_CHUNK, max_iter - it)):
            state = body(state)
        st, it = (int(v) for v in
                  torch.stack([state.status, state.iterations]).tolist())
        if states is not None:
            states.append(_fields(state.tab, state))
    return state, st, it


def old_loop_sharded(tab, shard, options, max_iter: int,
                     states: list | None = None):
    """The sequential sharded loop as it ran before its chunk's graph:
    ``iteration_body_sharded`` (about 40 torch calls and three
    allocating collectives a pivot) driven by ``drive``."""
    state, st, it = drive(
        lambda s: ps.iteration_body_sharded(s, shard, options, max_iter),
        solver.initial_state(tab, options), max_iter, states)
    return state.tab, st, it


def _fields(tab, s):
    """The carried state as copies: the slice, the vectors and the
    scalars."""
    out = dict(Tt=tab.Tt, b=tab.b, costs=tab.costs, z=tab.z, base=tab.base,
               status=s.status, iterations=s.iterations, stall=s.stall,
               bland=s.bland)
    return {k: v.clone() for k, v in out.items()}


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


def _phase1_slice(problem, shard, options, device):
    """The rank's slice of the eliminated phase-1 tableau."""
    n, m = problem.vars, problem.constraints
    _, M_pad = ps.sharded_padded_dims(n, m, shard.size, options)
    tab = ps.build_phase1_sharded(
        torch.as_tensor(problem.A), torch.as_tensor(problem.b, device=device),
        n, m, shard, options, M_pad, device)
    return ps.gaussian_eliminate_sharded(tab, shard)


def chunk_states_rank(group, device, problem, options, caps):
    """For ``group.spawn``: for each cap, the rank's phase-1 slice through
    ``solve_loop_sharded`` (its eager path over gloo) and through the old
    loop, each chunk's end state recorded. Returns rank 0's [(new
    states, old states, new (status, iterations), old's)] a cap."""
    n, m = problem.vars, problem.constraints
    R_pad, _ = ps.sharded_padded_dims(n, m, pg.dist.get_world_size(group),
                                      options)
    shard = pg.Shard.of(group, R_pad)
    tab0 = _phase1_slice(problem, shard, options, device)
    real = ps.run_chunk_sharded
    out = []
    for cap in caps:
        new: list = []

        def run_chunk(loop, *a, **kw):
            real(loop, *a, **kw)
            tab = dataclasses.replace(tab0, Tt=loop.Tt, b=loop.b,
                                      costs=loop.costs, z=loop.s.z,
                                      base=loop.base)
            new.append(_fields(tab, loop.s))

        ps.run_chunk_sharded = run_chunk
        try:
            _, st, it = ps.solve_loop_sharded(
                dataclasses.replace(tab0, Tt=tab0.Tt.clone()), shard,
                options, cap)
        finally:
            ps.run_chunk_sharded = real
        old: list = []
        _, ost, oit = old_loop_sharded(
            dataclasses.replace(tab0, Tt=tab0.Tt.clone()), shard, options,
            cap, old)
        out.append((new, old, (st, it), (ost, oit)))
    return out


# ---------------------------------------------------------------------------
# Ranks as threads: collectives as a rendezvous.

class _Hub:
    """The rendezvous of P threads: each collective stacks every rank's
    operand in rank order."""

    def __init__(self, P: int):
        self.P = P
        self.barrier = threading.Barrier(P, timeout=120)
        self.slots = [None] * P

    def exchange(self, rank: int, x: torch.Tensor) -> list:
        self.slots[rank] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


@dataclasses.dataclass(frozen=True)
class _Group:
    hub: _Hub
    rank: int


def _gathered(x, group):
    got = group.hub.exchange(group.rank, x)
    return torch.stack([t.reshape(-1) for t in got]).view(len(got), *x.shape)


def _summed(x, group):
    got = group.hub.exchange(group.rank, x)
    out = got[0].clone()
    for t in got[1:]:
        out += t
    return out


def _thread_collectives(monkeypatch):
    """``parallel.sharded``'s collectives over ``_Group``s, counted as
    ``parallel.group`` counts them."""
    lock = threading.Lock()

    def count(kind):
        with lock:
            pg.COUNTS[kind] += 1

    def all_gather(x, group):
        count("all_gather")
        return _gathered(x, group)

    def all_reduce(x, group):
        count("all_reduce")
        return _summed(x, group)

    def all_reduce_(buf, group):
        count("all_reduce")
        return buf.copy_(_summed(buf, group))

    def all_gather_into(out, src, group):
        count("all_gather")
        return out.copy_(_gathered(src, group))

    for name, fn in (("all_gather", all_gather), ("all_reduce", all_reduce),
                     ("all_reduce_", all_reduce_),
                     ("all_gather_into", all_gather_into)):
        monkeypatch.setattr(ps, name, fn)


def _on_threads(P: int, fn) -> list:
    """``fn(rank, group)`` on P threads; their results in rank order. A
    rank that raises breaks the rendezvous and the call re-raises."""
    hub = _Hub(P)
    out, errs = [None] * P, []

    def run(rank):
        try:
            out[rank] = fn(rank, _Group(hub, rank))
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errs.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


# ---------------------------------------------------------------------------
# Each pivot against the eager body, from edge states.

def _options(pair, case):
    T, V = PAIRS[pair]
    rule = "bland" if case == "bland_static" else "dantzig"
    thr = None if case == "bland_never" else 3
    return SolverOptions(dtype=T, vector_dtype=V, pivot_rule=rule,
                         bland_threshold=thr)


def _whole(opts, P, n=30, m=12, seed=7):
    """The eliminated phase-1 tableau over all the columns, padded to P
    slices as the sharded loop pads them."""
    p = generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, P, opts)
    whole = pg.Shard(None, 0, 1, R_pad)
    return gaussian_eliminate(ps.build_phase1_sharded(
        torch.as_tensor(p.A), torch.as_tensor(p.b), n, m, whole, opts,
        M_pad, "cpu"))


def _edge(tab, case, opts, P):
    """The tableau bent into ``case``'s state, and the carry (status,
    iterations, stall, bland)."""
    eps = float(opts.eps_resolved)
    R = tab.Tt.shape[1]
    R_loc = R // P
    tab = dataclasses.replace(tab, Tt=tab.Tt.clone(), b=tab.b.clone(),
                              costs=tab.costs.clone())
    h, _ = solver.choose_entering(tab, torch.tensor(False), eps)
    h = int(h)
    col = tab.Tt[:, h]
    rows = torch.nonzero(col >= eps).view(-1)
    status, iters, stall = RUNNING, 3, 0
    bland = opts.pivot_rule_resolved == "bland"
    if case == "nan_b":
        tab.b[rows[1]] = float("nan")
    elif case == "tie":
        j1, j2 = int(rows[0]), int(rows[-1])
        tab.Tt[j2, h] = tab.Tt[j1, h]
        tab.b[j1] = tab.b[j2] = 1e-3 * tab.Tt[j1, h].to(tab.b.dtype)
    elif case == "cost_tie":
        # The smallest cost twice, on the last slice (or the same one at
        # P = 1) and on the first: the lower global index wins.
        other = (R_loc * (P - 1) + 1) if P > 1 else min(h + 1, tab.r - 1)
        lo, hi = sorted((h, other))
        if lo == hi or hi >= tab.r:
            lo, hi = 0, tab.r - 1
        tab.Tt[:, hi] = tab.Tt[:, lo]
        tab.costs[hi] = tab.costs[lo] = tab.costs.min() - 1.0
    elif case == "empty_rank":
        # The middle slice (the last at P = 2; at P = 1 the slice's first
        # half) holds no eligible column.
        r0, width = ((P // 2) * R_loc, R_loc) if P > 1 else (0, R_loc // 2)
        tab.costs[r0:r0 + width] = tab.costs[r0:r0 + width].abs() + 1.0
    elif case == "unbounded":
        tab.Tt[:, h] = -col.abs()
    elif case == "optimal":
        tab.costs.copy_(tab.costs.abs())
    elif case == "bland_threshold":
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


def _both_ways(tab, carry, opts, P, pivots):
    """``pivots`` pivots on each of P thread ranks, one at a time, by the
    new loop's chunk body (``run_chunk_sharded`` of one pivot) and by
    ``iteration_body_sharded`` from the same slices. Returns, a rank,
    [(new, old, (do, unb))] a pivot."""
    R_loc = tab.Tt.shape[1] // P

    def rank_fn(rank, group):
        shard = pg.Shard(group, rank, P, R_loc)
        mine = ps.shard_tableau(tab, rank, P)
        ref = solver.LoopState(dataclasses.replace(
            mine, Tt=mine.Tt.clone(), base=mine.base.to(torch.int32)),
            *(x.clone() for x in carry))
        loop = ps.sharded_seq_loop(dataclasses.replace(
            mine, Tt=mine.Tt.clone()), shard, opts)
        for dst, src in zip((loop.s.status, loop.s.iterations, loop.s.stall,
                             loop.s.bland), carry):
            dst.copy_(src)
        out = []
        for _ in range(pivots):
            before = loop.Tt.clone()
            ps.run_chunk_sharded(loop, opts, MAX_ITER, 1)
            ref = ps.iteration_body_sharded(ref, shard, opts, MAX_ITER)
            kind = (bool(loop.s.do), bool(loop.s.unb))
            if not kind[0]:
                # A skipped pivot leaves the slice untouched; the eager
                # addr_ with factor 0 may turn a -0.0 into +0.0.
                assert _same(loop.Tt, before)
                assert torch.equal(loop.Tt, ref.tab.Tt)
                ref.tab.Tt.copy_(loop.Tt)
            new = _fields(dataclasses.replace(
                mine, Tt=loop.Tt, b=loop.b, costs=loop.costs, z=loop.s.z,
                base=loop.base), loop.s)
            new["h"] = loop.s.h.clone()
            out.append((new, _fields(ref.tab, ref), kind))
        return out

    return _on_threads(P, rank_fn)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plain_pivots_match_the_eager_body(monkeypatch, pair, P, case):
    """Four pivots of ``run_chunk_sharded``'s body (the plain versions of
    ``seq_fold_column`` and ``seq_ratio_colk_sharded``, then
    ``seq_rank1``'s) against ``iteration_body_sharded`` from one edge
    state on P thread ranks: every rank's slice, b, costs, z, base,
    status, iterations, stall and Bland flag bit for bit after every
    pivot, and every rank's entering h alike."""
    _thread_collectives(monkeypatch)
    opts = _options(pair, case)
    tab, carry = _edge(_whole(opts, P), case, opts, P)
    ranks = _both_ways(tab, carry, opts, P, 4)
    seen = set()
    hs = [int(new["h"]) for new, _, _ in ranks[0]]
    for rank, pivots in enumerate(ranks):
        for i, (new, old, kind) in enumerate(pivots):
            seen.add(kind)
            assert int(new.pop("h")) == hs[i], (rank, i)
            for name in new:
                assert _same(new[name], old[name]), (rank, i, name)
    want = {"unbounded": (False, True), "optimal": (False, False),
            "skipped": (False, False), "fuse": (False, False)}.get(
                case, (True, False))
    assert want in seen, seen


def test_the_fold_takes_ties_and_empty_ranks_as_the_eager_fold():
    """``seq_fold_column``'s plain version against ``fold_candidates``'
    fold on gathered candidates: a tie of the smallest value on two ranks
    (the lower rank), a rank with no Bland candidate, a NaN value (rank
    0's), Bland on with no eligible column anywhere (the Dantzig one)."""
    BIG = kb.BIG_INDEX
    rows = {"tie": ([[-2.0, -1.0], [-3.0, -0.5], [-3.0, -2.0]],
                    [[1, 3], [12, 14], [23, 21]]),
            "no_bland": ([[-2.0, np.inf], [-1.0, -0.5], [-0.5, np.inf]],
                         [[2, BIG], [13, 13], [20, BIG]]),
            "nan": ([[-2.0, -1.0], [np.nan, -0.5], [-4.0, -2.0]],
                    [[2, 2], [13, 13], [20, 21]]),
            "none": ([[0.5, np.inf], [0.25, np.inf], [1.0, np.inf]],
                     [[2, BIG], [13, BIG], [20, BIG]])}
    eps = 1e-9
    for name, (vals, idxs) in rows.items():
        for bland in (False, True):
            V = torch.tensor(vals, dtype=torch.float64)
            I = torch.tensor(idxs, dtype=torch.int32)
            s = ks.seq_scalars(torch.tensor(0.0, dtype=torch.float64), bland,
                               torch.float64)
            Tt = torch.arange(8 * 10, dtype=torch.float64).view(8, 10)
            ah = torch.empty(8, dtype=torch.float64)
            ks.seq_fold_column_plain(Tt, V, I, ah, s, MAX_ITER, eps, 10)
            key = -V[:, 0]
            od = int(torch.argmax((key == key.max()).to(torch.int8)))
            ob = int(torch.argmin(I[:, 1]))
            use_b = bland and int(I[ob, 1]) < BIG
            h = int(I[ob, 1]) if use_b else int(I[od, 0])
            minc = V[ob, 1] if use_b else V[od, 0]
            assert int(s.h) == h and _same(s.minc, minc), (name, bland)
            assert bool(s.optimal) == bool(minc > -eps), (name, bland)
            own = 10 <= h < 20
            want = Tt[:, h - 10] if own else torch.zeros(8, dtype=Tt.dtype)
            assert _same(ah, want), (name, bland)
            assert (int(s.h_d), int(s.h_b)) == (int(I[od, 0]),
                                                int(I[ob, 1]))


def test_pack_is_entering_sharded_s():
    """``pack_candidates`` of a slice's ``entering_candidates`` holds what
    ``entering_sharded`` gathered (values, then global indices), with no
    eligible column too."""
    eps = 1e-9
    costs = torch.tensor([0.5, -2.0, 3.0, -2.0, -1.0, 7.0], dtype=torch.float64)
    for c, r in ((costs, 5), (costs.abs(), 6), (costs, 0)):
        v = torch.empty(2, dtype=torch.float64)
        i = torch.empty(2, dtype=torch.int32)
        ks.pack_candidates(kb.entering_candidates(c, None, r, eps), 12, v, i)
        masked = torch.where(torch.arange(6) < r, c, torch.inf)
        elig = masked <= -eps
        ld = int(torch.argmin(masked))
        lb = int(torch.argmin(torch.where(elig, torch.arange(6), 6)))
        has = bool(elig.any())
        assert _same(v, torch.stack([masked[ld], masked[lb] if has
                                     else torch.tensor(torch.inf,
                                                       dtype=c.dtype)]))
        assert i.tolist() == [12 + ld, 12 + lb if has else kb.BIG_INDEX]


def test_skipped_pivot_leaves_the_slices_untouched(monkeypatch):
    """With the loop finished and an inf in the leaving row of each
    slice, a pivot still issues its collectives on every rank and leaves
    every slice untouched, where the eager body's ``addr_`` with factor
    0 turned that inf's column into NaN rows."""
    _thread_collectives(monkeypatch)
    opts = _options("f64", "skipped")
    P = 2
    tab, carry = _edge(_whole(opts, P), "skipped", opts, P)
    eps = float(opts.eps_resolved)
    h, _ = solver.choose_entering(tab, torch.tensor(False), eps)
    k, _ = solver.ratio_test(tab, tab.Tt[:, int(h)], eps)
    R_loc = tab.Tt.shape[1] // P
    for rank in range(P):
        tab.Tt[int(k), rank * R_loc + 1] = float("inf")
    pg.reset_counts()
    R_loc = tab.Tt.shape[1] // P

    def rank_fn(rank, group):
        shard = pg.Shard(group, rank, P, R_loc)
        mine = ps.shard_tableau(tab, rank, P)
        loop = ps.sharded_seq_loop(dataclasses.replace(
            mine, Tt=mine.Tt.clone()), shard, opts)
        for dst, src in zip((loop.s.status, loop.s.iterations, loop.s.stall,
                             loop.s.bland), carry):
            dst.copy_(src)
        before = loop.Tt.clone()
        ps.run_chunk_sharded(loop, opts, MAX_ITER, 1)
        ref = ps.iteration_body_sharded(solver.LoopState(
            dataclasses.replace(mine, Tt=mine.Tt.clone()),
            *(x.clone() for x in carry)), shard, opts, MAX_ITER)
        return before, loop, ref

    for before, loop, ref in _on_threads(P, rank_fn):
        assert not bool(loop.s.do) and int(loop.s.k) == int(k)
        assert _same(loop.Tt, before) and not torch.isnan(loop.Tt).any()
        assert torch.isnan(ref.tab.Tt).any()
        for name in ("b", "costs", "base"):
            assert _same(getattr(loop, name), getattr(ref.tab, name)
                         .to(getattr(loop, name).dtype)), name
        assert _same(loop.s.z, ref.tab.z)
    # Per rank: the new pivot's 2 + 1, the eager body's 2 + 1.
    assert pg.COUNTS == {"all_gather": 4 * P, "all_reduce": 2 * P}


# ---------------------------------------------------------------------------
# solve_loop_sharded against the old loop on gloo ranks.

def _chunk_run(P, problem, options, caps):
    if P == 1:
        with tempfile.TemporaryDirectory() as td, \
                pg.world(0, 1, "gloo", td) as group:
            return chunk_states_rank(group, torch.device("cpu"), problem,
                                     options, caps)
    return pg.spawn(chunk_states_rank, P, "gloo", "cpu", problem, options,
                    caps)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_eager_loop_matches_the_old_loop_on_gloo(P):
    """The rank's phase-1 slice through ``solve_loop_sharded`` (gloo:
    the eager path, the plain versions) and through the old loop
    (``iteration_body_sharded`` driven a chunk a host read), whole and
    capped at 8, 33 and 64 pivots: the same status and iterations, the
    same chunks, and every chunk's end state bit for bit (the slice by
    value: a skipped pivot of the old body may flip a zero's sign), rank
    0's."""
    problem = generate_random_problem(160, 64, 4, 1, 100)
    caps = [5000, 8, 33, 64]
    runs = _chunk_run(P, problem, SolverOptions(), caps)
    for cap, (new, old, got, want) in zip(caps, runs):
        assert got == want, (cap, got, want)
        assert got[0] == (OPTIMAL if cap == 5000 else RUNNING), (cap, got)
        assert got[1] == cap or cap == 5000
        chunks = -(-got[1] // solver.SEQ_CHUNK)
        assert len(new) == len(old) in (chunks, chunks + 1), cap
        for i, (a, b) in enumerate(zip(new, old)):
            assert torch.equal(a.pop("Tt"), b.pop("Tt")), (cap, i)
            for name in a:
                assert _same(a[name], b[name]), (cap, i, name)
    assert runs[0][2][1] > 2 * solver.SEQ_CHUNK


# ---------------------------------------------------------------------------
# The chunk's structure, the loop's storage and the card's launches.

def test_run_chunk_sharded_enqueues_in_the_graphs_order(monkeypatch,
                                                        tmp_path):
    """``run_chunk_sharded`` enqueues per pivot the two ``all_gather``s,
    ``seq_fold_column``, the ``all_reduce``, ``seq_ratio_colk_sharded``
    and ``seq_rank1``: SEQ_CHUNK pivots whatever the fuse, the ones past
    it skipped."""
    opts = SolverOptions()
    problem = generate_random_problem(40, 16, 2, 1, 100)
    calls = []
    names = ("all_gather_into", "seq_fold_column", "all_reduce_",
             "seq_ratio_colk_sharded", "seq_rank1")

    def record(name):
        real = getattr(ps, name)

        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        R_pad, _ = ps.sharded_padded_dims(40, 16, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        loop = ps.sharded_seq_loop(_phase1_slice(problem, shard, opts,
                                                 "cpu"), shard, opts)
        for name in names:
            monkeypatch.setattr(ps, name, record(name))
        pg.reset_counts()
        ps.run_chunk_sharded(loop, opts, 5)
    body = ["all_gather_into", "all_gather_into", "seq_fold_column",
            "all_reduce_", "seq_ratio_colk_sharded", "seq_rank1"]
    assert calls == body * solver.SEQ_CHUNK
    assert int(loop.s.iterations) == 5
    assert pg.COUNTS == {"all_gather": 2 * solver.SEQ_CHUNK,
                         "all_reduce": solver.SEQ_CHUNK}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_sharded_seq_loop_keeps_its_storage(monkeypatch, tmp_path, pair):
    """Every tensor of the loop's state, its collectives' buffers
    included, keeps its ``data_ptr()`` from the first chunk to the last;
    ``solve_loop_sharded`` returns the loop's b, costs, z and base and
    updates the caller's slice in place; the buffers have the shapes the
    collectives need."""
    opts = SolverOptions(dtype=PAIRS[pair][0], vector_dtype=PAIRS[pair][1])
    problem = generate_random_problem(160, 64, 4, 1, 100)
    loops, seen = [], []
    make, chunk = ps.sharded_seq_loop, ps.run_chunk_sharded

    def ptrs(loop):
        out = {f.name: getattr(loop, f.name)
               for f in dataclasses.fields(loop)
               if isinstance(getattr(loop, f.name), torch.Tensor)}
        out.update(loop.s.tensors())
        return {n: x.data_ptr() for n, x in out.items()}

    def sharded_seq_loop(*a, **kw):
        loops.append(make(*a, **kw))
        return loops[-1]

    def run_chunk(loop, *a, **kw):
        seen.append(ptrs(loop))
        return chunk(loop, *a, **kw)

    monkeypatch.setattr(ps, "sharded_seq_loop", sharded_seq_loop)
    monkeypatch.setattr(ps, "run_chunk_sharded", run_chunk)
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        R_pad, _ = ps.sharded_padded_dims(160, 64, 1, opts)
        shard = pg.Shard.of(group, R_pad)
        tab = _phase1_slice(problem, shard, opts, "cpu")
        out, status, iters = ps.solve_loop_sharded(tab, shard, opts, 5000)
    assert status == OPTIMAL and len(seen) >= 2, (status, iters)
    assert all(p == seen[0] for p in seen[1:])
    loop = loops[0]
    assert loop.Tt is tab.Tt and out.Tt is tab.Tt
    assert out.b is loop.b and out.costs is loop.costs
    assert out.z is loop.s.z and out.base is loop.base
    assert loop.send_v.shape == (2,) and loop.recv_v.shape == (1, 2)
    assert loop.send_i.dtype == loop.recv_i.dtype == torch.int32
    assert loop.ah.dtype == loop.Tt.dtype == getattr(torch, opts.dtype.name)


def test_sharded_seq_kernels_check_their_operands():
    """The wrappers refuse buffers of another dtype or shape, and a
    dtype pair with no kernel, before any launch."""
    s = ks.seq_scalars(torch.tensor(0.0, dtype=torch.float64), False,
                       torch.float64)
    M, R = 8, 6
    Tt = torch.zeros((M, R), dtype=torch.float64)
    V = torch.zeros((2, 2), dtype=torch.float64)
    I = torch.zeros((2, 2), dtype=torch.int32)
    ah = torch.zeros(M, dtype=torch.float64)
    with pytest.raises(ValueError, match="V"):
        ks.seq_fold_column(Tt, V.float(), I, ah, s, 10, 1e-9, 0)
    with pytest.raises(ValueError, match="ah"):
        ks.seq_fold_column(Tt, V, I, ah.float(), s, 10, 1e-9, 0)
    vec = dict(costs=torch.zeros(R, dtype=torch.float64),
               b=torch.zeros(M, dtype=torch.float64),
               base=torch.zeros(M, dtype=torch.int32), ah=ah,
               colk=torch.zeros(R, dtype=torch.float64),
               fac=torch.zeros(M, dtype=torch.float64))
    with pytest.raises(ValueError, match="send_v"):
        ks.seq_ratio_colk_sharded(Tt, *vec.values(), s, R, 1e-9, 10,
                                  offset=0, send_v=torch.zeros(5, dtype=
                                                               torch.float64),
                                  send_i=torch.zeros(2, dtype=torch.int32),
                                  bland_static=False, threshold=50)
    odd = ks.seq_scalars(torch.tensor(0.0), False, torch.float64)
    with pytest.raises(ValueError, match="no sequential kernel"):
        ks._pair(odd)


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


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_fold_column_launch_is_wired(monkeypatch, pair):
    """``seq_fold_column`` on the card: one call of its entry point with
    as many arguments as its ctypes signature -- the slice, the gathered
    buffers and their ranks, the shape, the offset, the column, the
    scalars, the fuse, eps and the dtype pair -- and one launch counted."""
    T, V = (getattr(torch, np.dtype(d).name) for d in PAIRS[pair])
    got, sig = _stub_card(monkeypatch, "seq_fold_column_launch")
    s = ks.seq_scalars(torch.tensor(0.0, dtype=V), False, T)
    M, R, P = 8, 6, 3
    Tt = torch.zeros((M, R), dtype=T)
    Vg = torch.zeros((P, 2), dtype=torch.float64)
    Ig = torch.zeros((P, 2), dtype=torch.int32)
    ah = torch.zeros(M, dtype=T)
    ks.reset_launches()
    ks.seq_fold_column(Tt, Vg, Ig, ah, s, 77, 1e-9, 12)
    (args,) = got
    assert len(args) == len(sig)
    vals = _values(args)
    assert vals[0] == Tt.data_ptr() and vals[1] == Vg.data_ptr()
    assert vals[2] == Ig.data_ptr() and vals[3:7] == [P, M, R, 12]
    assert vals[7] == ah.data_ptr() and vals[9:12] == [77, 1e-9,
                                                       ks.PAIRS[(T, V)]]
    assert ks.LAUNCHES == {**{n: 0 for n in ks.LAUNCHES},
                           "seq_fold_column": 1}


@pytest.mark.parametrize("policy", [(False, 3), (True, 3), (False, None)],
                         ids=["threshold", "static", "never"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_ratio_colk_sharded_launch_is_wired(monkeypatch, pair, policy):
    """``seq_ratio_colk_sharded`` on the card: one call of its entry point
    with as many arguments as its ctypes signature -- the buffers, the
    shape, the slice's live columns, eps, the scalars, the fuse, the Bland
    mode and threshold, the offset, the send buffers, the cluster's threads
    a block (``seq_sharded_threads``) and the dtype pair -- and one launch
    counted."""
    T, V = (getattr(torch, np.dtype(d).name) for d in PAIRS[pair])
    got, sig = _stub_card(monkeypatch, "seq_ratio_colk_sharded_launch")
    s = ks.seq_scalars(torch.tensor(0.0, dtype=V), False, T)
    M, R = 8, 6
    bufs = [torch.zeros((M, R), dtype=T), torch.zeros(R, dtype=V),
            torch.zeros(M, dtype=V), torch.zeros(M, dtype=torch.int32),
            torch.zeros(M, dtype=T), torch.zeros(R, dtype=T),
            torch.zeros(M, dtype=T)]
    send_v = torch.zeros(2, dtype=torch.float64)
    send_i = torch.zeros(2, dtype=torch.int32)
    ks.reset_launches()
    ks.seq_ratio_colk_sharded(*bufs, s, 5, 1e-9, 77, offset=18,
                              send_v=send_v, send_i=send_i,
                              bland_static=policy[0], threshold=policy[1])
    (args,) = got
    assert len(args) == len(sig)
    vals = _values(args)
    assert vals[:7] == [x.data_ptr() for x in bufs]
    assert vals[7:11] == [M, R, 5, 1e-9]
    assert vals[12:16] == [77, *ks._policy(*policy), 18]
    assert vals[16:20] == [send_v.data_ptr(), send_i.data_ptr(),
                           ks.seq_sharded_threads(R), ks.PAIRS[(T, V)]]
    assert ks.LAUNCHES == {**{n: 0 for n in ks.LAUNCHES},
                           "seq_ratio_colk_sharded": 1}
