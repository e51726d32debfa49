"""The scenario fleet (``solve_batched(mesh=group)``) on two gloo ranks on
the CPU against ``solve_batch`` on one device: every lane the same
status, walk, objective and x bit for bit (a lane's solve does not depend
on the lanes beside it; tests/test_torch_batch.py pins that for one
batch), and against the JAX package's fleet over a CPU mesh (status and
refined objective at 1e-9). A batch that does not divide across the
ranks raises, as ``simplex_tpu/batch.py:489-494`` does."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu_torch.batch import solve_batched_rank
from simplex_tpu_torch.parallel.group import spawn

OPTS = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5,
            block_pivots=8)


def _problems(k):
    spread = [pst.Problem(A=np.array(A), b=np.array(b), c=np.array(c))
              for A, b, c in (([[1.0, 0.0], [1.0, 0.0]], [1.0, 2.0],
                               [1.0, 1.0]),
                              ([[-1.0, 0.0], [1.0, 0.0]], [-1.0, 0.5],
                               [1.0, 0.0]))]
    return [pst.generate_random_problem(30, 12, s, 1, 100)
            for s in range(k)], spread


@pytest.fixture(scope="module")
def fleet():
    problems, _ = _problems(6)
    return problems, spawn(solve_batched_rank, 2, "gloo", "cpu", problems,
                           pst.SolverOptions(**OPTS))


def test_fleet_equals_one_batch(fleet):
    problems, got = fleet
    want = pst.solve_batch(problems, device="cpu", **OPTS)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.status == w.status == pst.Status.OPTIMAL
        assert (g.iterations_phase1, g.iterations_phase2) == (
            w.iterations_phase1, w.iterations_phase2)
        assert g.objective == w.objective
        np.testing.assert_array_equal(g.x, w.x)
        assert g.refine.certified


def test_fleet_matches_jax_fleet(fleet):
    problems, got = fleet
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
    want = jst.solve_batch(problems, jst.SolverOptions(**OPTS), mesh=mesh)
    for g, w in zip(got, want):
        assert g.status == w.status
        assert g.objective == pytest.approx(w.objective, rel=1e-9)


def test_fleet_statuses_and_the_divisibility_rule():
    """Unbounded and infeasible lanes come back in their places; three
    lanes do not split across two ranks."""
    _, spread = _problems(0)
    got = spawn(solve_batched_rank, 2, "gloo", "cpu", spread,
                pst.SolverOptions(**OPTS))
    assert [r.status for r in got] == [pst.Status.UNBOUNDED,
                                       pst.Status.INFEASIBLE]
    with pytest.raises(Exception, match="must divide across 2 devices"):
        spawn(solve_batched_rank, 2, "gloo", "cpu", spread + spread[:1],
              pst.SolverOptions(**OPTS))
