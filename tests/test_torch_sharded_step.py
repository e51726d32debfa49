"""The sharded kernel loop's per-pivot step and its fixed state, on the CPU.

* The sharded step's plain versions (``kernels.blocked.sharded_step_pre``
  / ``sharded_ratio`` / ``sharded_pack`` / ``sharded_fold`` on CPU
  tensors, and the step after K2 that K2's sharded tail runs) against the
  eager glue they replace, written out here as the sharded loop ran it
  (the fold as ``parallel.sharded.fold_candidates`` runs it on the
  gathered candidates): every output equal, over a grid of pivots (done,
  skipped, at the fuse, optimal, unbounded, Bland on and off, a rank with
  no eligible column, ties across ranks) at P = 1, 2 and 4, under devex
  and Dantzig and each anti-cycling policy.
* The window's new order (K2 with the step after K2 and the pack as its
  tail, K5 with the fold and the next step before K5 as its head,
  ``sharded_fold`` last) against the order it replaced
  (``sharded_pack_plain`` after K2, ``sharded_step_post_plain`` after
  the gathers) on the same grid, every scalar and vector equal; the
  ratio test's edge cases; the window's launches in order, with
  ``sharded_pack`` left only to the window boundary's fold.
* K2's pack tail (``colk_costs_sharded_tail`` with the send buffers):
  against the chain it replaced (the tail without them, then
  ``sharded_pack_plain``) on two slices under devex and Dantzig, both
  buffers or neither, and its launch's arguments and counts with the
  library stubbed.
* K2's plain version with a column offset and a given weight at h: at
  offset 0 bit for bit its single-card call, and on a two-slice cut the
  one-card result. K5's owner flag.
* ``group.CapturedCollectives``: a capture counts nothing, a replay the
  graph's collectives.
* ``ShardedKernelLoop`` keeps every carried tensor in one storage from
  its first window to its last, under devex and Dantzig, with ``costs0``
  and without; and the loop ends bit for bit where the eager loop it
  replaces (written out here) ends.
* ``solve_sharded`` against the JAX package's on a CPU mesh (its kernels
  in interpret mode), at the ROADMAP's holding rules.
"""

import ctypes
import dataclasses
import itertools
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu.parallel.sharded import solve_sharded as jax_sharded
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.generator import generate_random_problem
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.parallel import group as pg
from simplex_tpu_torch.parallel import sharded as ps

BIG = kb.BIG_INDEX
RUNNING, OPTIMAL, UNBOUNDED = (int(Status.RUNNING), int(Status.OPTIMAL),
                               int(Status.UNBOUNDED))
EPS = 1e-4
MAX_ITER = 10
M, R_LOC = 16, 8
POLICIES = {"threshold": (False, 50), "never": (False, None),
            "static": (True, 50)}

# (status, iterations, stall, bland, Bland candidate, v_d, unbounded,
# local candidates): the pivot each case makes. "ties" gives every rank
# the same main value and key; "empty_rank" leaves rank 1 with no
# eligible column.
CASES = {
    "pivot": (RUNNING, 3, 4, False, True, -2.5, False, "spread"),
    "inactive": (OPTIMAL, 3, 4, False, True, -2.5, False, "spread"),
    "fuse": (RUNNING, MAX_ITER, 4, False, True, -2.5, False, "spread"),
    "optimal": (RUNNING, 3, 4, False, True, -1e-5, False, "spread"),
    "unbounded": (RUNNING, 3, 4, False, True, -2.5, True, "spread"),
    "bland": (RUNNING, 3, 4, True, True, -2.5, False, "spread"),
    "bland_none_eligible": (RUNNING, 3, 4, True, False, -2.5, False,
                            "spread"),
    "stall_to_bland": (RUNNING, 3, 49, False, True, -2e-4, False,
                       "spread"),
    "ties": (RUNNING, 3, 4, False, True, -2.5, False, "ties"),
    "empty_rank": (RUNNING, 3, 4, False, True, -2.5, False, "empty_rank"),
}


def _state(case, P, devex, seed):
    """Every rank's scalars (identical: the loop's replicated carry), the
    summed column, b and base, and each rank's slice weights and K2
    candidates (local columns)."""
    status, iters, stall, bland, hb_ok, v_d, unb, local = CASES[case]
    rng = np.random.default_rng(seed)
    R = P * R_LOC
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5)), bland)
    h_d = int(rng.integers(0, R))
    vals = dict(status=status, iterations=iters, stall=stall, h_d=h_d,
                v_d=v_d * rng.uniform(0.9, 1.1),
                h_b=int(rng.integers(0, R)) if hb_ok else BIG,
                v_b=-0.5 * rng.uniform(0.9, 1.1) if hb_ok else float("inf"),
                w_d=rng.uniform(1, 3) if devex else 1.0,
                w_b=rng.uniform(1, 3) if devex else 1.0)
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    ah = torch.from_numpy(rng.uniform(-1, 1, M).astype(np.float32))
    if unb:
        ah = -ah.abs()
    else:
        ah[3] = ah[9] = 0.5                     # a tie in b / a_h
    b = torch.from_numpy(rng.uniform(0, 10, M))
    b[3] = b[9] = 1.25
    base = torch.from_numpy(rng.integers(0, R, M).astype(np.int32))
    ws = [torch.from_numpy(rng.uniform(1, 4, R_LOC).astype(np.float32))
          for _ in range(P)]
    cands = []
    for rank in range(P):
        hd, hb = int(rng.integers(0, R_LOC)), int(rng.integers(0, R_LOC))
        vd, vb = -rng.uniform(0.1, 3), -rng.uniform(0.1, 3)
        if local == "ties":
            hd, vd = 2, -1.5
            ws[rank][2] = 2.0
        if local == "empty_rank" and rank == 1 % P:
            hd, vd, hb, vb = 0, float("inf"), BIG, float("inf")
        cands.append((hd, vd, hb, vb))
    return s, ah, b, base, ws, cands


def _clone(s):
    return kb.ShardedScalars(**{n: x.clone() for n, x in s.tensors().items()})


def _eager_glue(s, ah, b, base, ws, cands, P, devex, then_pre, policy):
    """The sharded kernel loop's per-pivot glue as it ran eagerly before
    the step kernels, for every rank: before K5, between the column's
    all_reduce and K2, the candidates' pack (``_pack``), the fold
    (``fold_candidates`` and ``_fold`` on the stacked packs) and the part
    after; with ``then_pre`` the next pivot's part before K5."""
    bland_static, threshold = policy
    status, iterations = s.status.clone(), s.iterations.clone()
    stall, bland, z = s.stall.clone(), s.bland.clone(), s.z.clone()
    h_d, v_d, h_b, v_b = s.h_d, s.v_d, s.h_b, s.v_b
    w_d, w_b = s.w_d, s.w_b

    def before_k5(offset):
        active = (status == RUNNING) & (iterations < MAX_ITER)
        use_bland = bland & (h_b < BIG)
        h = torch.where(use_bland, h_b, h_d)
        minc = torch.where(use_bland, v_b, v_d)
        loc = h.long() - offset
        own = (loc >= 0) & (loc < R_LOC)
        return dict(active=active, h=h, minc=minc, optimal=minc > -EPS,
                    hl=loc.clamp(0, R_LOC - 1), own=own,
                    wh=torch.where(use_bland, w_b, w_d))

    pre = [before_k5(rank * R_LOC) for rank in range(P)]
    active, minc, optimal = pre[0]["active"], pre[0]["minc"], \
        pre[0]["optimal"]
    mask = ah >= EPS
    unbounded = ~mask.any()
    k = torch.argmin(torch.where(
        mask, b / torch.where(mask, ah, 1.0).double(), torch.inf))
    do = active & ~(optimal | unbounded)
    p = torch.where(do, ah[k], 1.0)
    bk = b[k]
    u = torch.where(do, minc / p.to(torch.float64), 0.0)
    mid = dict(k=k, unb=unbounded, do=do, p=p, bk=bk, u=u)

    packs = []
    for rank, ((hd, vd, hb, vb), w) in enumerate(zip(cands, ws)):
        hd, hb = torch.tensor(hd, dtype=torch.int32), torch.tensor(
            hb, dtype=torch.int32)
        vd, vb = torch.tensor(vd, dtype=torch.float64), torch.tensor(
            vb, dtype=torch.float64)
        vals, key = [vd, vb], None
        if devex:
            wd = w[hd.long().clamp(max=R_LOC - 1)].double()
            wb = torch.where(hb < BIG, w[hb.long().clamp(max=R_LOC - 1)]
                             .double(), 1.0)
            key = torch.where(hb < BIG, vd * vd / wd, -torch.inf)
            vals += [wd, wb]
        idxs = torch.stack([torch.where(x.long() >= BIG, BIG,
                                        rank * R_LOC + x.long())
                            for x in (hd, hb)])
        if key is not None:
            vals.append(key)
        packs.append((torch.stack(vals), idxs))
    V = torch.stack([v for v, _ in packs])
    Ix = torch.stack([i for _, i in packs])
    key = V[:, -1] if devex else -V[:, 0]
    od = torch.argmax((key == key.max()).to(torch.int8)).view(1)
    ob = torch.argmin(Ix[:, 1]).view(1)
    vd, vb = V.index_select(0, od)[0], V.index_select(0, ob)[0]
    h_d = Ix.index_select(0, od)[0, 0].to(torch.int32)
    h_b = Ix.index_select(0, ob)[0, 1].to(torch.int32)
    v_d, v_b = vd[0], vb[1]
    one = torch.ones((), dtype=torch.float32)
    w_d = vd[2].float() if devex else one
    w_b = vb[3].float() if devex else one

    z2 = torch.where(do, z - u * bk, z)
    status = kb.exit_status(active, optimal, unbounded, status)
    stall, bland = kb.anticycling_update(
        do, (z2 - z).abs() >= EPS, stall, bland, bland_static=bland_static,
        threshold=threshold)
    iterations = iterations + do.to(torch.int32)
    z = z2
    post = dict(h_d=h_d, v_d=v_d, h_b=h_b, v_b=v_b, w_d=w_d, w_b=w_b,
                status=status, stall=stall, bland=bland,
                iterations=iterations, z=z)
    nxt = ([before_k5(rank * R_LOC) for rank in range(P)] if then_pre
           else None)
    return pre, mid, packs, post, nxt


def _equal(got, want, what):
    """Equal values; floating values of one dtype (the eager glue kept
    indices in int64 and flags in bool where the scalars hold int32)."""
    assert not want.is_floating_point() or got.dtype == want.dtype, what
    assert torch.equal(got, want.to(got.dtype)), (what, got, want)


@pytest.mark.parametrize("then_pre", [False, True], ids=["post", "post+pre"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_plain_matches_eager_glue(case, P, rule, policy,
                                               then_pre):
    devex = rule == "devex"
    s0, ah, b, base, ws, cands = _state(case, P, devex, seed=len(case) + P)
    pre, mid, packs, post, nxt = _eager_glue(
        s0, ah, b, base, ws, cands, P, devex, then_pre, POLICIES[policy])
    ranks = [_clone(s0) for _ in range(P)]
    kv = 5 if devex else 2
    V = torch.empty((P, kv), dtype=torch.float64)
    Ix = torch.empty((P, 2), dtype=torch.int32)
    for rank, s in enumerate(ranks):
        where = dict(offset=rank * R_LOC, R_loc=R_LOC)
        kb.sharded_step_pre(s, MAX_ITER, EPS, **where)
        for name, want in pre[rank].items():
            _equal(getattr(s, name), want, (rank, "pre", name))
        kb.sharded_ratio(s, ah, b, EPS)
        for name, want in mid.items():
            _equal(getattr(s, name), want, (rank, "ratio", name))
        # K2 leaves the slice's candidates in the scalars.
        for name, v in zip(("h_d", "v_d", "h_b", "v_b"), cands[rank]):
            getattr(s, name).fill_(v)
        kb.sharded_pack(s, ws[rank] if devex else None, rank * R_LOC,
                        V[rank], Ix[rank])
        _equal(V[rank], packs[rank][0], (rank, "pack values"))
        _equal(Ix[rank], packs[rank][1], (rank, "pack indices"))
    for rank, s in enumerate(ranks):
        # The step after K2 (K2's sharded tail), the fold, and the next
        # pivot's step before K5 (with the fold, K5's head).
        kb.step_post_plain(s, MAX_ITER, EPS, *POLICIES[policy], False)
        kb.sharded_fold(s, V, Ix)
        if then_pre:
            kb.sharded_step_pre(s, MAX_ITER, EPS, offset=rank * R_LOC,
                                R_loc=R_LOC)
        for name, want in post.items():
            _equal(getattr(s, name), want, (rank, "post", name))
        if then_pre:
            for name, want in nxt[rank].items():
                _equal(getattr(s, name), want, (rank, "next pre", name))
    # The case makes the pivot it is named for; h has one owner.
    assert bool(ranks[0].do) == (case in ("pivot", "bland",
                                          "bland_none_eligible",
                                          "stall_to_bland", "ties",
                                          "empty_rank")), case
    assert sum(bool(s.own) for s in ranks) == 1


def test_sharded_fold_only_folds():
    """``sharded_fold``: the candidates change, the carry does not."""
    s, *_ = _state("pivot", 2, True, seed=3)
    V = torch.tensor([[-1.0, -2.0, 1.0, 1.0, 1.0], [-3.0, -4.0, 2.0, 1.5,
                                                     4.5]],
                     dtype=torch.float64)
    Ix = torch.tensor([[5, 1], [9, 8]], dtype=torch.int32)
    before = _clone(s)
    kb.sharded_fold(s, V, Ix)
    assert (int(s.h_d), float(s.v_d), int(s.h_b), float(s.v_b),
            float(s.w_d), float(s.w_b)) == (9, -3.0, 1, -2.0, 2.0, 1.0)
    for name in ("status", "iterations", "stall", "bland", "z", "h",
                 "active", "own", "hl"):
        assert torch.equal(getattr(s, name), getattr(before, name)), name


def _k2_state(R, seed, devex):
    """A K2 call's operands at M = 128, L = 8, t = 3 over R columns."""
    rng = np.random.default_rng(seed)
    M, L, t = 128, 8, 3
    f32 = np.float32
    Tt = torch.from_numpy(rng.uniform(-1, 1, (M, R)).astype(f32))
    C = torch.from_numpy(rng.uniform(-1, 1, (L, R)).astype(f32))
    F = torch.from_numpy(rng.uniform(-0.1, 0.1, (L, M)).astype(f32))
    C[t:] = 0
    F[t:] = 0
    costs = torch.from_numpy(rng.uniform(-1, 1, R))
    ah = torch.from_numpy(rng.uniform(-1, 1, M).astype(f32))
    b = torch.from_numpy(rng.uniform(0, 10, M))
    base = torch.from_numpy(rng.permutation(R)[:M].astype(np.int32))
    w = (torch.from_numpy(rng.uniform(1, 3, R).astype(f32)) if devex
         else None)
    return dict(Tt=Tt, C=C, F=F, costs=costs, ah=ah, b=b, base=base, w=w,
                t=t)


def _k2(st, k, h, offset=0, w_h=None, sl=slice(None)):
    """K2's plain version on a copy of ``st`` cut to columns ``sl``."""
    x = {n: (v[..., sl] if n in ("Tt", "C", "costs", "w") else v)
         for n, v in st.items() if n != "t" and v is not None}
    x = {n: v.clone() for n, v in x.items()}
    x.setdefault("w", None)
    p = x["ah"][k].clone()
    do = torch.tensor(True)
    u = -0.7 / p.double()
    cands = kb.colk_costs(
        x["Tt"], x["C"], x["F"], x["costs"],
        torch.tensor(k, dtype=torch.int32), st["t"], u, do, x["Tt"].shape[1],
        EPS, x["ah"], x["b"], x["base"], torch.tensor(h, dtype=torch.int32),
        p, x["b"][k].clone(), x["w"],
        offset=offset, w_h=w_h)
    return x, cands


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_colk_offset_zero_is_single_card(rule):
    st = _k2_state(128, 7, rule == "devex")
    k, h = 5, 40
    want, wc = _k2(st, k, h)
    w_h = None if st["w"] is None else st["w"][h].clone()
    got, gc = _k2(st, k, h, offset=0, w_h=w_h)
    for name in want:
        if want[name] is not None:
            assert torch.equal(got[name], want[name]), name
    for a, b_ in zip(gc, wc):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("leaving", ["slice0", "slice1"])
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_colk_two_slices_equal_one_card(rule, leaving):
    """K2 on two slices of 128 columns, each with its offset and the
    weight at h, against K2 on the 256 columns: the same pivot row,
    costs and weights by slice, the same replicated b, base and eta row,
    and the slices' candidates folded (``sharded_pack``,
    ``sharded_fold``) are the one-card candidates."""
    devex = rule == "devex"
    st = _k2_state(256, 11, devex)
    k, h = 4, 200                                # h on slice 1
    # The leaving variable base[k] on one slice or the other.
    st["base"][k] = 60 if leaving == "slice0" else 150
    want, wc = _k2(st, k, h)
    w_h = None if st["w"] is None else st["w"][h].clone()
    V = torch.empty((2, 5 if devex else 2), dtype=torch.float64)
    Ix = torch.empty((2, 2), dtype=torch.int32)
    s = kb.sharded_scalars(torch.tensor(0.0), False)
    for rank in range(2):
        cols = slice(128 * rank, 128 * (rank + 1))
        got, gc = _k2(st, k, h, offset=128 * rank, w_h=w_h, sl=cols)
        for name in ("C", "costs", "w"):
            if want[name] is not None:
                assert torch.equal(got[name], want[name][..., cols]), name
        for name in ("F", "b", "base"):
            assert torch.equal(got[name], want[name]), name
        for name, v in zip(("h_d", "v_d", "h_b", "v_b"), gc):
            getattr(s, name).copy_(v)
        kb.sharded_pack(s, got["w"], 128 * rank, V[rank], Ix[rank])
    kb.sharded_fold(s, V, Ix)
    assert (int(s.h_d), int(s.h_b)) == (int(wc[0]), int(wc[2]))
    assert torch.equal(s.v_d, wc[1]) and torch.equal(s.v_b, wc[3])
    if devex:
        assert float(s.w_d) == float(want["w"][int(wc[0])])


def test_ah_owner_flag():
    rng = np.random.default_rng(2)
    Tt = torch.from_numpy(rng.uniform(-1, 1, (128, 128)).astype(np.float32))
    C = torch.from_numpy(rng.uniform(-1, 1, (8, 128)).astype(np.float32))
    F = torch.from_numpy(rng.uniform(-1, 1, (8, 128)).astype(np.float32))
    h = torch.tensor(17, dtype=torch.int32)
    out = torch.full((128,), 9.0)
    want = kb.ah_plain(Tt, F, C, h, 5)
    got = kb.ah(Tt, F, C, h, 5, own=torch.tensor(True), out=out)
    assert got is out and torch.equal(out, want)
    kb.ah(Tt, F, C, h, 5, own=torch.tensor(False), out=out)
    assert torch.equal(out, torch.zeros(128))
    assert torch.equal(kb.ah(Tt, F, C, h, 5), want)
    with pytest.raises(ValueError, match="own"):
        kb.ah(Tt, F, C, h, 5, own=torch.tensor(1))


def test_captured_collectives_counts_replays_only():
    pg.reset_counts()
    pg.COUNTS["all_gather"] = 3
    with pg.CapturedCollectives() as colls:
        for _ in range(8):
            pg.COUNTS["all_gather"] += 2
            pg.COUNTS["all_reduce"] += 1
            pg.SHAPES[("all_reduce", (16,))] += 1
    assert dict(pg.COUNTS) == {"all_gather": 3} and not pg.SHAPES
    colls.replayed()
    colls.replayed()
    assert dict(pg.COUNTS) == {"all_gather": 35, "all_reduce": 16}
    assert dict(pg.SHAPES) == {("all_reduce", (16,)): 16}
    pg.reset_counts()


def test_in_place_collectives_count_as_allocating(tmp_path):
    """``all_reduce_`` and ``all_gather_into`` give what the allocating
    forms give, into their buffers, counted under the same kinds and
    shapes."""
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        pg.reset_counts()
        x = torch.arange(4.0)
        assert pg.all_reduce_(x, group) is x
        assert torch.equal(x, pg.all_reduce(torch.arange(4.0), group))
        src = torch.tensor([3, 4], dtype=torch.int32)
        out = torch.empty((1, 2), dtype=torch.int32)
        assert pg.all_gather_into(out, src, group) is out
        assert torch.equal(out, pg.all_gather(src, group))
        one = torch.empty(1)
        pg.all_gather_into(one, torch.tensor(2.5), group)
        assert float(one) == 2.5
        assert dict(pg.COUNTS) == {"all_reduce": 2, "all_gather": 3}
        assert pg.SHAPES[("all_gather", (2,))] == 2
        assert pg.SHAPES[("all_gather", ())] == 1
        assert not pg.capturable(group, x)
        with pytest.raises(ValueError, match="output"):
            pg.all_gather_into(torch.empty((2, 2)), torch.zeros(2), group)
        pg.reset_counts()


def _phase1_slice(n, m, seed, group, **kw):
    opts = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                         block_pivots=8, **kw)
    p = generate_random_problem(n, m, seed, 1, 100)
    R_pad, M_pad = ps.sharded_padded_dims(n, m, 1, opts)
    shard = pg.Shard.of(group, R_pad)
    tab = ps.build_phase1_sharded(torch.as_tensor(p.A), torch.as_tensor(p.b),
                                  n, m, shard, opts, M_pad, "cpu")
    return ps.gaussian_eliminate_sharded(tab, shard), tab.costs, shard, opts


def _pointers(loop):
    """``data_ptr()`` of every tensor of a ``ShardedKernelLoop`` by name,
    its scalars' included (``w`` left out when None)."""
    out = {f.name: getattr(loop, f.name) for f in dataclasses.fields(loop)
           if f.name not in ("s", "shard", "r_loc")}
    out.update(loop.s.tensors())
    return {name: x.data_ptr() for name, x in out.items() if x is not None}


@pytest.mark.parametrize("with_costs0", [True, False],
                         ids=["costs0", "no_costs0"])
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_sharded_loop_keeps_its_storage(monkeypatch, tmp_path, rule,
                                        with_costs0):
    """Every tensor of the loop's state keeps its ``data_ptr()`` from the
    first window boundary to the last (read where the loop calls K3 or
    K4), and they are the tensors the loop started with."""
    loops, seen = [], []
    make = ps.sharded_kernel_loop

    def kernel_loop(*args, **kw):
        loops.append(make(*args, **kw))
        seen.append(_pointers(loops[-1]))
        return loops[-1]

    def boundary(real):
        def call(*args, **kw):
            seen.append(_pointers(loops[-1]))
            return real(*args, **kw)
        return call

    monkeypatch.setattr(ps, "sharded_kernel_loop", kernel_loop)
    monkeypatch.setattr(ps, "apply_window", boundary(ps.apply_window))
    monkeypatch.setattr(ps, "apply_reprice", boundary(ps.apply_reprice))
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        tab, costs0, shard, opts = _phase1_slice(96, 40, 11, group,
                                                 pivot_rule=rule)
        _, status, iters = ps.solve_loop_blocked_kernel_sharded(
            tab, shard, opts, 5000, costs0 if with_costs0 else None)
    assert status == OPTIMAL
    assert len(seen) >= 4, (len(seen), iters)     # three windows or more
    names = {"Tt", "C", "F", "b", "costs", "base", "ah", "send_v",
             "send_i", "recv_v", "recv_i", "ws_k2", "z", "status",
             "iterations", "stall", "bland", "h_d", "v_d", "h_b", "v_b",
             "w_d", "w_b", "wh", "own", "hl"} | (
                 {"w"} if rule == "devex" else set())
    assert names <= set(seen[0])
    assert all(ptrs == seen[0] for ptrs in seen[1:])
    assert loops[0].Tt is tab.Tt


def _eager_loop(tab, shard, options, max_iter, costs0):
    """The sharded kernel loop as it ran before its step kernels: the
    per-pivot glue in torch ops around K5 and K2, the devex update and the
    candidates re-derived in torch ops, the collectives allocating."""
    from simplex_tpu_torch.solver import _at

    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    L, every = int(options.block_pivots), max(1, int(options.reprice_every))
    Tt = tab.Tt
    M, R_loc = Tt.shape
    f64 = torch.float64
    r, r_loc = tab.r, shard.local_r(tab.r)
    b, costs = tab.b.to(f64).clone(), tab.costs.to(f64).clone()
    z, base = tab.z.to(f64).clone(), tab.base.to(torch.int32).clone()
    costs0 = costs0.to(f64)
    w = torch.ones(R_loc) if devex else None
    status = torch.tensor(RUNNING, dtype=torch.int32)
    iterations = torch.zeros((), dtype=torch.int32)
    stall = torch.zeros((), dtype=torch.int32)
    bland = torch.tensor(bland_static)

    def fold():
        h_d, v_d, h_b, v_b = kb.entering_candidates(costs, w, r_loc, eps)
        vals, key = [v_d, v_b], None
        if w is not None:
            w_d = _at(w, h_d.long().clamp(max=R_loc - 1)).double()
            w_b = torch.where(h_b < BIG, _at(w, h_b.long().clamp(
                max=R_loc - 1)).double(), 1.0)
            key = torch.where(h_b < BIG, v_d * v_d / w_d, -torch.inf)
            vals += [w_d, w_b]
        idxs = torch.stack([torch.where(x.long() >= BIG, BIG,
                                        shard.offset + x.long())
                            for x in (h_d, h_b)])
        hd, hb, vd, vb = ps.fold_candidates(torch.stack(vals), idxs, shard,
                                            key)
        one = torch.ones(())
        return (hd.to(torch.int32), vd[0], hb.to(torch.int32), vb[1],
                vd[2].float() if devex else one,
                vb[3].float() if devex else one)

    h_d, v_d, h_b, v_b, w_d, w_b = fold()
    C = torch.zeros((L, R_loc))
    F = torch.zeros((L, M))
    st, it, windows = RUNNING, 0, 0
    while st == RUNNING and it < max_iter and windows < max_iter:
        for t in range(L):
            active = (status == RUNNING) & (iterations < max_iter)
            use_bland = bland & (h_b < BIG)
            h = torch.where(use_bland, h_b, h_d)
            minc = torch.where(use_bland, v_b, v_d)
            optimal = minc > -eps
            loc = h.long() - shard.offset
            own = (loc >= 0) & (loc < R_loc)
            hl = loc.clamp(0, R_loc - 1)
            a_h = pg.all_reduce(torch.where(
                own, kb.ah(Tt, F, C, hl.to(torch.int32), t), 0.0),
                shard.group)
            mask = a_h >= eps
            unbounded = ~mask.any()
            k = torch.argmin(torch.where(
                mask, b / torch.where(mask, a_h, 1.0).double(), torch.inf))
            do = active & ~(optimal | unbounded)
            p = torch.where(do, _at(a_h, k), 1.0)
            bk = _at(b, k)
            u = torch.where(do, minc / p.to(f64), 0.0)
            lvar = _at(base, k)
            kb.colk_costs(Tt, C, F, costs, k.to(torch.int32), t, u, do,
                          r_loc, eps, a_h, b, base, h, p, bk)
            if devex:
                w = ps.devex_update_sharded(w, do, C[t], p, torch.where(
                    use_bland, w_b, w_d), lvar, shard)
            h_d, v_d, h_b, v_b, w_d, w_b = fold()
            z2 = torch.where(do, z - u * bk, z)
            status = kb.exit_status(active, optimal, unbounded, status)
            stall, bland = kb.anticycling_update(
                do, (z2 - z).abs() >= eps, stall, bland,
                bland_static=bland_static, threshold=options.bland_threshold)
            iterations = iterations + do.to(torch.int32)
            z = z2
        if devex:
            w, reset = ps.reanchor(w, shard)
            w_d = torch.where(reset, 1.0, w_d)
            w_b = torch.where(reset, 1.0, w_b)
        st, it = int(status), int(iterations)
        if st != RUNNING or (windows + 1) % every == 0:
            coeffs = ps.gather_basic_coeffs(base, costs0, r, shard)
            costs = costs0 - kb.apply_reprice(Tt, C, F, coeffs)
            h_d, v_d, h_b, v_b, w_d, w_b = fold()
            vmin = ps.global_min(torch.where(shard.row_mask(r, "cpu"),
                                             costs, torch.inf).min(), shard)
            if st == OPTIMAL and float(vmin) <= -eps:
                status.fill_(RUNNING)
                st = RUNNING
        else:
            kb.apply_window(Tt, C, F)
        windows += 1
    return dict(Tt=Tt, b=b, costs=costs, z=z, base=base, w=w), st, it


@pytest.mark.parametrize("rule,seed", [("devex", 4), ("dantzig", 8),
                                       ("bland", 6)])
def test_sharded_loop_matches_the_eager_loop(monkeypatch, tmp_path, rule,
                                             seed):
    """From one phase-1 slice at one rank, the loop of step kernels
    (their plain versions here) ends where the eager loop it replaces
    ends, bit for bit: status, iterations, Tt, b, costs, z, base and the
    devex weights."""
    loops = []
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        tab, costs0, shard, opts = _phase1_slice(120, 48, seed, group,
                                                 pivot_rule=rule)
        ref = dataclasses.replace(tab, Tt=tab.Tt.clone())
        want, wst, wit = _eager_loop(ref, shard, opts, 5000, costs0)
        make = ps.sharded_kernel_loop
        monkeypatch.setattr(ps, "sharded_kernel_loop",
                            lambda *a: loops.append(make(*a)) or loops[-1])
        got, gst, git = ps.solve_loop_blocked_kernel_sharded(
            tab, shard, opts, 5000, costs0)
    assert (gst, git) == (wst, wit) and gst == OPTIMAL and git > 8
    for name in ("Tt", "b", "costs", "z", "base"):
        assert torch.equal(getattr(got, name), want[name]), name
    if rule == "devex":
        assert torch.equal(loops[0].w, want["w"])


MIXED = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
             block_pivots=8)
JAX_CASES = [
    ("devex-reprice1-88x36", 88, 36, 21, dict(MIXED, reprice_every=1)),
    ("dantzig-L16-80x32", 80, 32, 17, dict(MIXED, pivot_rule="dantzig",
                                           block_pivots=16)),
]


@pytest.mark.parametrize("cid,n,m,seed,opts", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_matches_jax_sharded_at_one_rank(cid, n, m, seed, opts):
    """The port's ``solve_sharded`` at one gloo rank against the JAX
    package's on a one-device CPU mesh: status, the refined objective at
    1e-9, both certified, pivot counts within max(3, 10%); and the walk of
    the port's ``solve``."""
    problem = pst.generate_random_problem(n, m, seed, 1.0, 100.0)
    with tempfile.TemporaryDirectory() as td, \
            pg.world(0, 1, "gloo", td) as group:
        got = pst.solve_sharded(problem, group, device="cpu", **opts)
    mesh = Mesh(np.array(jax.devices()[:1]), ("vars",))
    want = jax_sharded(problem, mesh, jst.SolverOptions(**opts),
                       interpret=True)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified and want.refine.certified
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    walk = (got.iterations_phase1, got.iterations_phase2)
    for a, b in zip(walk, (want.iterations_phase1, want.iterations_phase2)):
        assert abs(a - b) <= max(3, 0.1 * b), cid
    one = pst.solve(problem, device="cpu", **opts)
    assert walk == (one.iterations_phase1, one.iterations_phase2)


def test_cases_cover_the_grid():
    """Every case at every P makes a state the step kernels accept."""
    for case, P in itertools.product(CASES, (1, 2, 4)):
        s, ah, b, base, ws, cands = _state(case, P, True, seed=1)
        assert len(ws) == len(cands) == P and ah.shape == (M,)
        kb.ShardedScalars(**s.tensors())


# ---------------------------------------------------------------------------
# The window's new order against the order it replaced.

K2_M, K2_R, K2_L, PIVOTS = 128, 128, 8, 3


def _window_state(case, P, devex, seed):
    """The state of P slices of 128 columns for a few pivots of a window:
    the scalars as ``_state`` fills them for ``case``, the slices' Tt,
    costs and weights, the replicated b, base and factors. "unbounded"
    makes both candidates' columns non-positive, "ties" gives every slice
    the same columns, costs and weights, and "empty_rank" leaves only the
    first slice live (none at P = 1)."""
    status, iters, stall, bland, hb_ok, v_d, unb, local = CASES[case]
    rng = np.random.default_rng(seed)
    R = P * K2_R
    f32 = np.float32
    Tt = rng.uniform(-1, 1, (K2_M, R)).astype(f32)
    costs = rng.uniform(-1, 1, R)
    w = rng.uniform(1, 3, R).astype(f32)
    if local == "ties":
        Tt = np.tile(Tt[:, :K2_R], (1, P))
        costs, w = np.tile(costs[:K2_R], P), np.tile(w[:K2_R], P)
    h_d = int(rng.integers(0, R))
    h_b = int(rng.integers(0, R)) if hb_ok else BIG
    if unb:
        for h in (h_d, h_b % R):
            Tt[:, h] = -np.abs(Tt[:, h])
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5)), bland)
    vals = dict(status=status, iterations=iters, stall=stall, h_d=h_d,
                v_d=v_d * rng.uniform(0.9, 1.1), h_b=h_b,
                v_b=-0.5 * rng.uniform(0.9, 1.1) if hb_ok else float("inf"),
                w_d=float(w[h_d]) if devex else 1.0,
                w_b=float(w[h_b]) if devex and hb_ok else 1.0)
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    r = (0 if P == 1 else K2_R) if local == "empty_rank" else R - 5
    return dict(
        s=s, Tt=torch.from_numpy(Tt), costs=torch.from_numpy(costs),
        w=torch.from_numpy(w) if devex else None, r=r,
        b=torch.from_numpy(rng.uniform(0, 10, K2_M)),
        base=torch.from_numpy(rng.integers(0, R, K2_M).astype(np.int32)))


def _ranks(st, P):
    """Each rank's loop state: its slice and its copies of the replicated
    vectors, factors and scalars."""
    out = []
    for rank in range(P):
        cols = slice(rank * K2_R, (rank + 1) * K2_R)
        out.append(dict(
            s=_clone(st["s"]), Tt=st["Tt"][:, cols].contiguous(),
            costs=st["costs"][cols].clone(),
            w=None if st["w"] is None else st["w"][cols].clone(),
            r=min(max(st["r"] - rank * K2_R, 0), K2_R),
            C=torch.zeros((K2_L, K2_R)), F=torch.zeros((K2_L, K2_M)),
            b=st["b"].clone(), base=st["base"].clone(),
            ah=torch.empty(K2_M), where=dict(offset=rank * K2_R,
                                             R_loc=K2_R)))
    return out


def _gathered(P, devex):
    return (torch.empty((P, 5 if devex else 2), dtype=torch.float64),
            torch.empty((P, 2), dtype=torch.int32))


def _old_order(st, P, policy):
    """PR 15's window: the step before K5, then per pivot K5, the sum,
    the ratio test, K2, the pack, the gathers and the step after them
    (``sharded_step_post_plain``: the fold, the step after K2 and the next
    step before K5)."""
    ranks = _ranks(st, P)
    V, Ix = _gathered(P, st["w"] is not None)
    for x in ranks:
        kb.sharded_step_pre_plain(x["s"], MAX_ITER, EPS, **x["where"])
    for t in range(PIVOTS):
        col = sum(kb.ah(x["Tt"], x["F"], x["C"], x["s"].hl, t, own=x["s"].own)
                  for x in ranks)
        for rank, x in enumerate(ranks):
            s = x["s"]
            x["ah"].copy_(col)
            kb.sharded_ratio_plain(s, col, x["b"], EPS)
            kb.colk_costs(x["Tt"], x["C"], x["F"], x["costs"], s.k, t, s.u,
                          s.do, x["r"], EPS, col, x["b"], x["base"], s.h,
                          s.p, s.bk, x["w"],
                          out=(s.h_d, s.v_d, s.h_b, s.v_b),
                          offset=x["where"]["offset"],
                          w_h=None if x["w"] is None else s.wh)
            kb.sharded_pack_plain(s, x["w"], x["where"]["offset"], V[rank],
                                  Ix[rank])
        for x in ranks:
            kb.sharded_step_post_plain(x["s"], V, Ix, MAX_ITER, EPS, *policy,
                                       t + 1 < PIVOTS, **x["where"])
    return ranks


def _new_order(st, P, policy, seen_h):
    """The window as ``run_window_sharded`` now enqueues it, through the
    wrappers: the step before K5, then per pivot K5 (from the second on
    with the fold and the step before K5 as its head), the sum, the ratio
    test, K2 with its sharded tail and the pack into the send buffers,
    and the gathers; then ``sharded_fold``. ``seen_h`` gets rank 0's h
    after each pivot's tail and after the next head."""
    ranks = _ranks(st, P)
    V, Ix = _gathered(P, st["w"] is not None)
    for x in ranks:
        kb.sharded_step_pre(x["s"], MAX_ITER, EPS, **x["where"])
    for t in range(PIVOTS):
        for x in ranks:
            if t:
                kb.ah_fold_head(x["Tt"], x["F"], x["C"], t, x["s"], V, Ix,
                                MAX_ITER, EPS, x["where"]["offset"],
                                out=x["ah"])
            else:
                kb.ah(x["Tt"], x["F"], x["C"], x["s"].hl, t, own=x["s"].own,
                      out=x["ah"])
        seen_h.append(int(ranks[0]["s"].h))
        col = sum(x["ah"] for x in ranks)
        for rank, x in enumerate(ranks):
            s = x["s"]
            x["ah"].copy_(col)
            kb.sharded_ratio(s, x["ah"], x["b"], EPS)
            kb.colk_costs_sharded_tail(
                x["Tt"], x["C"], x["F"], x["costs"], t, x["r"], EPS, x["ah"],
                x["b"], x["base"], x["w"], s, MAX_ITER,
                offset=x["where"]["offset"], bland_static=policy[0],
                threshold=policy[1], send_v=V[rank], send_i=Ix[rank])
    for x in ranks:
        kb.sharded_fold(x["s"], V, Ix)
    return ranks


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("rule", ["devex", "dantzig"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_new_order_matches_the_old_order(case, P, rule, policy):
    """Three pivots of a window in the new order (the step after K2 and
    the pack as K2's tail, the fold and the next step before K5 as K5's
    head, ``sharded_fold`` last) and in the order it replaced: every rank's
    scalars, column, factors and vectors equal. The step after K2 now
    runs before the fold that used to precede it; the two touch disjoint
    fields. In a taken pivot the fold moves h between the tail and the
    head."""
    devex = rule == "devex"
    st = _window_state(case, P, devex, seed=len(case) * 7 + P)
    seen_h = []
    new = _new_order(st, P, POLICIES[policy], seen_h)
    old = _old_order(st, P, POLICIES[policy])
    for rank, (a, b_) in enumerate(zip(new, old)):
        for name, x in a["s"].tensors().items():
            assert torch.equal(x, getattr(b_["s"], name)), (rank, name)
        for name in ("ah", "C", "F", "costs", "w", "b", "base"):
            if a[name] is not None:
                assert torch.equal(a[name], b_[name]), (rank, name)
    if case in ("pivot", "ties"):
        assert int(old[0]["s"].iterations) == CASES[case][1] + PIVOTS
        assert len(set(seen_h)) > 1, seen_h


@pytest.mark.parametrize("edge", ["nan_b", "cross_block_tie", "no_eligible",
                                  "north_star_m"])
def test_sharded_ratio_edge_cases(edge):
    """``sharded_ratio`` (its plain version here; the card's cluster in
    tests/test_torch_cuda.py) against numpy's argmin of the same
    quotients: a NaN b on an eligible row comes first; equal quotients on
    rows 2,048 and 4,096 apart (two blocks of the card's cluster, and one
    thread's two constraints) go to the lowest row; with no eligible row
    k = 0 and the pivot is unbounded; and the north star's M_pad = 10,112
    (two constraints for some threads)."""
    rng = np.random.default_rng(5)
    M = 10112 if edge == "north_star_m" else 8192
    a = rng.uniform(-1, 1, M).astype(np.float32)
    b = rng.uniform(0, 10, M)
    want_k = None
    if edge == "nan_b":
        a[[100, 7000]] = 0.5
        b[[100, 7000]] = np.nan
        want_k = 100
    elif edge == "cross_block_tie":
        a[[1000, 3048, 5096]] = 4.0
        b[[1000, 3048, 5096]] = 1e-3
        want_k = 1000
    elif edge == "no_eligible":
        a = -np.abs(a)
        want_k = 0
    mask = a >= np.float32(EPS)
    q = np.where(mask, b / np.where(mask, a, 1).astype(np.float64), np.inf)
    k = int(np.argmin(q))
    assert want_k is None or k == want_k
    s = kb.sharded_scalars(torch.tensor(0.0), False)
    s.active.fill_(True)
    s.minc.fill_(-0.75)
    kb.sharded_ratio(s, torch.from_numpy(a), torch.from_numpy(b), EPS)
    unb = not mask.any()
    assert (int(s.k), bool(s.unb), bool(s.do)) == (k, unb, not unb)
    assert float(s.p) == (1.0 if unb else float(a[k]))
    assert np.array_equal(float(s.bk), b[k], equal_nan=True)
    assert float(s.u) == (0.0 if unb else -0.75 / float(np.float32(a[k])))


def test_window_launches_in_order(monkeypatch, tmp_path):
    """``run_window_sharded`` enqueues ``sharded_step_pre`` once; per
    pivot K5 (with its head from the second pivot on), the column's
    all_reduce, the ratio test, K2 with its sharded tail and the pack
    into the send buffers, and the two all_gathers; then ``sharded_fold``
    once. No standalone step after the gathers is left, and
    ``sharded_pack`` runs only in the window boundary's fold
    (``ShardedKernelLoop.refold``), before its gathers."""
    calls = []

    def record(name):
        real = getattr(ps, name)

        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    names = ("sharded_step_pre", "ah", "ah_fold_head", "all_reduce_",
             "sharded_ratio", "colk_costs_sharded_tail", "sharded_pack",
             "all_gather_into", "sharded_fold")
    with pg.world(0, 1, "gloo", str(tmp_path)) as group:
        tab, _, shard, opts = _phase1_slice(96, 40, 11, group)
        loop = ps.sharded_kernel_loop(tab, shard, opts)
        for name in names:
            monkeypatch.setattr(ps, name, record(name))
        ps.run_window_sharded(loop, opts, 5000)
        window = list(calls)
        calls.clear()
        loop.refold(float(opts.eps_resolved))
    L = int(opts.block_pivots)
    tail = ["all_reduce_", "sharded_ratio", "colk_costs_sharded_tail",
            "all_gather_into", "all_gather_into"]
    assert window == (["sharded_step_pre", "ah"] + tail
                      + (["ah_fold_head"] + tail) * (L - 1)
                      + ["sharded_fold"])
    assert calls == ["sharded_pack", "all_gather_into", "all_gather_into",
                     "sharded_fold"]
    assert not hasattr(kb, "sharded_step_post")
    assert "sharded_step_post" not in kb.LAUNCHES
    assert kb.TAILS["sharded_post_tail"] == "colk_costs"
    assert kb.TAILS["sharded_pack_tail"] == "colk_costs"
    assert kb.TAILS["sharded_fold_head"] == "ah"


# ---------------------------------------------------------------------------
# K2's pack tail: its wiring. On the CPU the tail is by definition the
# chain it replaced; the card's kernel is held to that chain over the NaN,
# tie and no-eligible cases in tests/test_torch_cuda.py and chip_smoke.py.

PACK_M, PACK_R, PACK_L, PACK_T, PACK_P = 128, 128, 8, 3, 2


def _pack_state(devex, seed):
    """One K2 call's operands on ``PACK_P`` slices of ``PACK_R`` columns
    (M = 128, L = 8, t = 3) and the scalars of a taken pivot whose
    entering column h, in the last slice, stays by far its most negative
    cost and its first eligible one: both of that slice's candidates are
    h, whose weight K2 raises."""
    rng = np.random.default_rng(seed)
    R = PACK_P * PACK_R
    f32 = np.float32
    Tt = rng.uniform(-1, 1, (PACK_M, R)).astype(f32)
    C = rng.uniform(-1, 1, (PACK_L, R)).astype(f32)
    F = rng.uniform(-0.1, 0.1, (PACK_L, PACK_M)).astype(f32)
    C[PACK_T:] = 0
    F[PACK_T:] = 0
    costs = rng.uniform(-1, 1, R)
    w = rng.uniform(1, 3, R).astype(f32)
    ah = rng.uniform(-1, 1, PACK_M).astype(f32)
    k = int(rng.integers(0, PACK_M))
    ah[k] = 0.9
    h = (PACK_P - 1) * PACK_R + 5
    costs[h - 5:h] = 20.0
    costs[h] = -50.0
    Tt[k, h] = 2 * ah[k]              # alpha about 2: w[h] grows
    s = kb.sharded_scalars(torch.tensor(rng.uniform(-5, 5)), False)
    vals = dict(status=RUNNING, iterations=3, stall=4, active=True,
                optimal=False, unb=0, do=True, k=k, h=h, p=float(ah[k]),
                u=-0.7 / float(ah[k]), bk=rng.uniform(0, 1),
                wh=float(w[h]) if devex else 1.0)
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    ranks = []
    for rank in range(PACK_P):
        cols = slice(rank * PACK_R, (rank + 1) * PACK_R)
        ranks.append(dict(
            s=_clone(s), Tt=torch.from_numpy(Tt[:, cols].copy()),
            C=torch.from_numpy(C[:, cols].copy()),
            F=torch.from_numpy(F.copy()),
            costs=torch.from_numpy(costs[cols].copy()),
            w=torch.from_numpy(w[cols].copy()) if devex else None,
            ah=torch.from_numpy(ah.copy()),
            b=torch.from_numpy(rng.uniform(0, 10, PACK_M)),
            base=torch.from_numpy(rng.integers(0, R, PACK_M)
                                  .astype(np.int32)),
            offset=rank * PACK_R))
    return ranks


def _pack_tail(x, **send):
    kb.colk_costs_sharded_tail(
        x["Tt"], x["C"], x["F"], x["costs"], PACK_T, PACK_R, EPS, x["ah"],
        x["b"], x["base"], x["w"], x["s"], MAX_ITER, offset=x["offset"],
        bland_static=False, threshold=50, **send)


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_pack_tail_matches_the_old_chain(rule):
    """K2 with the step after K2 and the pack as its tail against K2 with
    the step alone and then ``sharded_pack_plain``, on each of two
    slices: the gathered send buffers, every scalar and every vector
    equal. The pack follows K2: the last slice sends h at its global
    index, under devex with the weight K2 left at h."""
    devex = rule == "devex"
    ranks = _pack_state(devex, seed=11)
    runs = []
    for tail in (True, False):
        V, Ix = _gathered(PACK_P, devex)
        states = []
        for rank, x0 in enumerate(ranks):
            x = {n: v.clone() if isinstance(v, torch.Tensor) else v
                 for n, v in x0.items()}
            x["s"] = _clone(x0["s"])
            if tail:
                _pack_tail(x, send_v=V[rank], send_i=Ix[rank])
            else:
                _pack_tail(x)
                kb.sharded_pack_plain(x["s"], x["w"], x["offset"], V[rank],
                                      Ix[rank])
            states.append(x)
        runs.append((states, V, Ix))
    (new, Vn, In), (old, Vo, Io) = runs
    assert torch.equal(Vn, Vo) and torch.equal(In, Io)
    for rank, (a, b_) in enumerate(zip(new, old)):
        for name, x in a["s"].tensors().items():
            assert torch.equal(x, getattr(b_["s"], name)), (rank, name)
        for name in ("C", "F", "costs", "w", "b", "base"):
            if a[name] is not None:
                assert torch.equal(a[name], b_[name]), (rank, name)
    last = new[-1]
    h = int(last["s"].h)
    assert int(last["s"].h_d) == int(last["s"].h_b) == 5
    assert In[-1].tolist() == [h, h]
    if devex:
        assert float(Vn[-1, 2]) == float(Vn[-1, 3]) == float(last["w"][5])
        assert float(last["w"][5]) != float(ranks[-1]["w"][5])


def test_pack_tail_takes_both_buffers():
    x = _pack_state(True, seed=2)[0]
    with pytest.raises(ValueError, match="both or neither"):
        _pack_tail(x, send_v=torch.empty(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="send_v"):
        _pack_tail(x, send_v=torch.empty(2, dtype=torch.float64),
                   send_i=torch.empty(2, dtype=torch.int32))


@pytest.mark.parametrize("pack", [True, False])
def test_pack_tail_launch_is_wired(monkeypatch, pack):
    """The card's path, its library stubbed: one ``colk_costs_launch`` with
    as many arguments as its ctypes signature, the send buffers' pointers
    after the four candidates' (null without a pack) and the step's
    pointers given; the launch counts ``colk_costs`` and
    ``sharded_post_tail``, and ``sharded_pack_tail`` with the buffers."""
    from simplex_tpu_torch.kernels import _build

    got = []

    class Lib:
        def colk_costs_launch(self, *args):
            got.append(args)
            return 0

    monkeypatch.setattr(kb, "_on_card", lambda *a: True)
    monkeypatch.setattr(kb, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    x = _pack_state(True, seed=3)[1]
    V, Ix = _gathered(PACK_P, True)
    kb.reset_launches()
    _pack_tail(x, **(dict(send_v=V[1], send_i=Ix[1]) if pack else {}))
    (args,) = got
    assert len(args) == len(_build.SIGNATURES["colk_costs_launch"])
    ptrs = [a.value or 0 for a in args[23:29]]
    assert ptrs[:4] == [x["s"].h_d.data_ptr(), x["s"].v_d.data_ptr(),
                        x["s"].h_b.data_ptr(), x["s"].v_b.data_ptr()]
    assert ptrs[4:] == ([V[1].data_ptr(), Ix[1].data_ptr()] if pack
                        else [0, 0])
    assert args[29] is not None
    assert kb.LAUNCHES["colk_costs"] == kb.LAUNCHES["sharded_post_tail"] == 1
    assert kb.LAUNCHES["sharded_pack_tail"] == int(pack)
    assert kb.LAUNCHES["sharded_pack"] == 0
