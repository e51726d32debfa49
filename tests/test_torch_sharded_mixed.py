"""The port's ``solve_sharded`` in the mixed mode (f32 tableau, f64
vectors, refinement) on gloo ranks on the CPU: the kernel loop (K5, K2,
K3/K4 through their plain versions) under devex, Dantzig and Bland, and
the plain f32 blocked loop (``use_pallas=False``), against the JAX
package's ``solve_sharded`` on a CPU mesh (its kernels in interpret mode)
and against the port's own ``solve``.

Rules (ROADMAP's north star): against JAX, the mixed walks on status and
on the refined objective at 1e-9, certified, pivot counts within
max(3, 10%) (the walks part at reduced-cost near-ties: the JAX kernels
fold f32 hi parts, the port f64 values); against the port's ``solve`` at
one and two ranks, the same walk (the same arithmetic on each slice) and
the same refined objective at 1e-12.
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

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
             block_pivots=8)


def _random(n, m, seed):
    return pst.generate_random_problem(n, m, seed, 1.0, 100.0)


#: (id, problem, SolverOptions fields).
CASES = [
    ("kernel-devex-96x40", _random(96, 40, 42), MIXED),
    ("kernel-devex-72x28", _random(72, 28, 13), MIXED),
    ("kernel-dantzig-96x40", _random(96, 40, 5),
     dict(MIXED, pivot_rule="dantzig")),
    ("kernel-bland-64x24", _random(64, 24, 9),
     dict(MIXED, pivot_rule="bland", block_pivots=16)),
    ("plain-f32-devex-64x24", _random(64, 24, 1),
     dict(MIXED, use_pallas=False)),
]
IDS = [c[0] for c in CASES]
RUNS = [pytest.param(c, P, id=f"{c[0]}-P{P}") for P in (1, 2)
        for c in CASES]


def _cases():
    return [(p, pst.SolverOptions(**o)) for _, p, o in CASES]


@pytest.fixture(scope="module")
def port_runs():
    """{P: {id: SolveResult}}: one rank in this process, two spawned."""
    with tempfile.TemporaryDirectory() as td:
        with world(0, 1, "gloo", td) as group:
            one = solve_sharded_rank(group, torch.device("cpu"), _cases())
    two = spawn(solve_sharded_rank, 2, "gloo", "cpu", _cases())
    return {1: dict(zip(IDS, one)), 2: dict(zip(IDS, two))}


def _walk(r):
    return r.iterations_phase1, r.iterations_phase2


@pytest.mark.parametrize("case,P", RUNS)
def test_matches_jax_sharded(port_runs, case, P):
    cid, problem, opts = case
    got = port_runs[P][cid]
    mesh = Mesh(np.array(jax.devices()[:P]), ("vars",))
    want = jax_sharded(problem, mesh, jst.SolverOptions(**opts),
                       interpret=True)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified and want.refine.certified
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    for a, b in zip(_walk(got), _walk(want)):
        assert abs(a - b) <= max(3, 0.1 * b), (_walk(got), _walk(want))


@pytest.mark.parametrize("case,P", RUNS)
def test_matches_port_solve(port_runs, case, P):
    cid, problem, opts = case
    got = port_runs[P][cid]
    want = pst.solve(problem, device="cpu", **opts)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)


def test_restart_round_on_slices_matches_restart_device(tmp_path):
    """One reinversion restart from a drifted, suboptimal basis
    (tests/test_reinvert.py's inputs) on the slices at one rank:
    ``restart_sharded`` walks as ``reinvert.restart_device`` does, to the
    same optimum and the same slack block."""
    from simplex_tpu_torch.parallel.group import Shard
    from simplex_tpu_torch.parallel.sharded import restart_sharded
    from simplex_tpu_torch.reinvert import restart_device
    from test_reinvert import MIXED as RMIXED, _drifted_restart_inputs

    p = pst.generate_random_problem(200, 80, 9, 1, 100)
    base, binv_t, xB = _drifted_restart_inputs(p, stop_short=6, drift=1e-3)
    args = [torch.from_numpy(np.array(v)) for v in (p.A, p.b, p.c, base)]
    args += [torch.from_numpy(np.array(binv_t).T.copy()),
             torch.from_numpy(np.array(xB))]
    opts = pst.SolverOptions(**RMIXED)
    want, wbinv, _ = restart_device(*args, p.vars, p.constraints, opts)
    with world(0, 1, "gloo", str(tmp_path)) as group:
        shard = Shard.of(group, 1)
        got, gbinv, _ = restart_sharded(shard, *args, p.vars,
                                        p.constraints, opts)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.iterations_phase2 == want.iterations_phase2 > 0
    assert got.objective == want.objective
    assert torch.equal(got.base, want.base) and torch.equal(gbinv, wbinv)
