"""The port's ``solve_sharded`` on gloo ranks on the CPU against the JAX
package's ``solve_sharded`` on a CPU mesh of as many devices (conftest
gives 8), and against the port's own single-device ``solve``: the
default f64 options (the sequential sharded loop) at P in {1, 2, 3}, the
f64 blocked loop (the plain blocked sharded loop) under Dantzig and
devex, the f32 tableau with the kernels off (the same loop re-priced every
window; on status and the refined objective only), and the statuses of tests/test_sharded.py:45-225
(infeasible, unbounded, degenerate under 'continue', non-finite
inputs). The mixed modes are in tests/test_torch_sharded_mixed.py.

Rules (ROADMAP's north star): f64 walks equal in their pivot counts,
objectives within 1e-9 of the JAX package's; against the port's
``solve`` the walks equal and the objectives within 1e-12 (the same
arithmetic on each slice, tests/test_sharded.py:33-42, 225-240 pin the
same for JAX). One rank runs in this process; two and three are each one
spawn that solves every instance.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu.parallel.sharded import solve_sharded as jax_sharded
from simplex_tpu_torch.parallel.group import spawn, world
from simplex_tpu_torch.parallel.sharded import solve_sharded_rank

from conftest import DATA

F64 = {}
BLOCKED = dict(block_pivots=8, pivot_rule="dantzig")
BLOCKED_DEVEX = dict(block_pivots=8, pivot_rule="devex")
#: The f32 tableau with the kernels off: the plain blocked sharded loop,
#: re-priced every window, refined and certified in f64.
PLAIN_F32 = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
                 block_pivots=8, use_pallas=False)


def _random(n, m, seed):
    return pst.generate_random_problem(n, m, seed, 1.0, 100.0)


def _nan(where):
    p = _random(48, 16, 3)
    arrs = {k: getattr(p, k).copy() for k in "Abc"}
    arrs[where].flat[arrs[where].size // 2] = np.nan
    return pst.Problem(**arrs)


#: (id, problem, SolverOptions fields, the status both must report).
CASES = [
    ("f64-96x40", _random(96, 40, 42), F64, pst.Status.OPTIMAL),
    ("f64-60x25", _random(60, 25, 7), F64, pst.Status.OPTIMAL),
    ("f64-64x24", _random(64, 24, 9), F64, pst.Status.OPTIMAL),
    ("blocked-64x24", _random(64, 24, 9), BLOCKED, pst.Status.OPTIMAL),
    ("blocked-devex-64x24", _random(64, 24, 9), BLOCKED_DEVEX,
     pst.Status.OPTIMAL),
    ("plain-f32-60x25", _random(60, 25, 7), PLAIN_F32, pst.Status.OPTIMAL),
    ("small", pst.read_problem(DATA / "smallProblem.txt"), F64,
     pst.Status.OPTIMAL),
    ("infeasible", pst.read_problem(DATA / "infeasibleProblem.txt"), F64,
     pst.Status.INFEASIBLE),
    ("unbounded", pst.Problem(A=np.array([[-1.0, 1.0]]), b=np.array([1.0]),
                              c=np.array([1.0, 0.0])), F64,
     pst.Status.UNBOUNDED),
    ("degenerate-continue",
     pst.Problem(A=np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
                             [1.0, -1.0, 0.0]]),
                 b=np.array([4.0, 4.0, 0.0]), c=np.array([2.0, 3.0, 1.0])),
     F64, pst.Status.OPTIMAL),
    ("nan-A", _nan("A"), F64, pst.Status.NUMERIC),
    ("nan-b", _nan("b"), F64, pst.Status.NUMERIC),
    ("nan-c", _nan("c"), F64, pst.Status.NUMERIC),
]
IDS = [c[0] for c in CASES]
#: The instances also run at three ranks.
AT_THREE = ["f64-96x40", "f64-60x25", "blocked-64x24", "blocked-devex-64x24",
            "plain-f32-60x25", "degenerate-continue"]
#: Held on status and on the refined objective only: an f32 walk is not
#: pinned (ROADMAP's translation rules).
LOOSE = {"plain-f32-60x25"}


#: (case, P) pairs of the comparisons.
RUNS = [pytest.param(c, P, id=f"{c[0]}-P{P}") for P in (1, 2, 3)
        for c in CASES if P < 3 or c[0] in AT_THREE]


def _cases(ids):
    return [(p, pst.SolverOptions(**o)) for i, p, o, _ in CASES
            if i in ids]


@pytest.fixture(scope="module")
def port_runs():
    """{P: {id: SolveResult}} for P in 1 (this process), 2, 3."""
    runs = {}
    with tempfile.TemporaryDirectory() as td:
        with world(0, 1, "gloo", td) as group:
            runs[1] = dict(zip(IDS, solve_sharded_rank(
                group, torch.device("cpu"), _cases(IDS))))
    runs[2] = dict(zip(IDS, spawn(solve_sharded_rank, 2, "gloo", "cpu",
                                  _cases(IDS))))
    runs[3] = dict(zip(AT_THREE, spawn(solve_sharded_rank, 3, "gloo", "cpu",
                                       _cases(AT_THREE))))
    return runs


@pytest.fixture(scope="module")
def single():
    """The port's single-device solve of every instance."""
    return {i: pst.solve(p, device="cpu", **o) for i, p, o, _ in CASES}


def _walk(r):
    return r.iterations_phase1, r.iterations_phase2


@pytest.mark.parametrize("case,P", RUNS)
def test_matches_jax_sharded(port_runs, case, P):
    cid, problem, options, status = case
    got = port_runs[P][cid]
    mesh = Mesh(np.array(jax.devices()[:P]), ("vars",))
    want = jax_sharded(problem, mesh, jst.SolverOptions(**options))
    assert got.status == want.status == status
    if status != pst.Status.OPTIMAL:
        assert got.x is None and want.x is None
        return
    if cid in LOOSE:
        assert got.refine.certified and want.refine.certified
        assert got.objective == pytest.approx(want.objective, rel=1e-9)
        return
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    np.testing.assert_allclose(got.x, want.x, atol=1e-7)


@pytest.mark.parametrize("case,P", RUNS)
def test_matches_port_solve(port_runs, single, case, P):
    cid = case[0]
    got, want = port_runs[P][cid], single[cid]
    assert got.status == want.status == case[3]
    if cid in LOOSE:
        assert got.objective == pytest.approx(want.objective, rel=1e-9)
        return
    assert _walk(got) == _walk(want)
    if got.status == pst.Status.OPTIMAL:
        assert got.objective == pytest.approx(want.objective, rel=1e-12)
        np.testing.assert_allclose(got.x, want.x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("opts", [F64, dict(dtype=np.float32,
                                            vector_dtype=np.float64,
                                            block_pivots=8)],
                         ids=["f64", "kernel-path"])
def test_slices_are_the_jax_tableau_cut(P, opts):
    """Each rank's own slice (``build_phase1_sharded``, built from A by
    global column) equals the JAX package's global sharded phase-1
    tableau cut by ``shard_tableau``, with the JAX padding for P ranks,
    bit for bit; b < 0 rows exercise the sign fix."""
    from simplex_tpu.parallel import sharded as jsh
    from simplex_tpu_torch.config import kernel_blocked_enabled
    from simplex_tpu_torch.parallel.group import Shard
    from simplex_tpu_torch.parallel.sharded import (build_phase1_sharded,
                                                     shard_tableau,
                                                     sharded_padded_dims)
    from simplex_tpu_torch.tableau import tableau_from_numpy

    p = _random(40, 12, 5)
    b = p.b.copy()
    b[::3] *= -1.0
    n, m = p.vars, p.constraints
    jopt, popt = jst.SolverOptions(**opts), pst.SolverOptions(**opts)
    # The JAX package pads for its kernels only on a TPU backend; ask it
    # for the kernel path's padding where the port takes that path.
    jt = jsh.build_phase1_sharded(p.A, b, n, m, P, jopt,
                                  kernel=kernel_blocked_enabled(popt))
    R_pad, M_pad = sharded_padded_dims(n, m, P, popt)
    assert (R_pad, M_pad) == tuple(jt.T.shape)
    whole = tableau_from_numpy(jt.T, jt.b, jt.costs, jt.z, jt.base, n, m,
                               jt.r)
    for rank in range(P):
        want = shard_tableau(whole, rank, P)
        got = build_phase1_sharded(torch.from_numpy(p.A),
                                   torch.from_numpy(b), n, m,
                                   Shard(None, rank, P, R_pad // P), popt,
                                   M_pad, "cpu")
        for name in ("Tt", "b", "costs", "base", "z"):
            assert torch.equal(getattr(got, name).to(getattr(want, name)
                                                     .dtype),
                               getattr(want, name)), (rank, name)
        assert (got.n, got.m, got.r) == (want.n, want.m, want.r)
