"""The port's checkpointed solves (``simplex_tpu_torch.checkpoint``) on the
CPU against the JAX package's (``simplex_tpu.checkpoint``).

* Every test of tests/test_checkpoint.py, through the port: full runs in
  small windows, resume after an interrupt, the state round trip,
  ``max_iter`` never overshot (the sequential and the blocked loop), the
  clamp warning, the shape and dtype rejections, a reference-degeneracy
  verdict deleting the file, and the sharded contract (full run, resume
  midway, width and kind mismatches).
* The same results as the JAX package: for the f64 default options the
  same status, the objective within 1e-9 and the same pivot counts; for
  the mixed mode the status and the refined objective within 1e-9,
  certified.
* Checkpoints cross packages both ways, in both phases, single-card and
  sharded: a file written by one package (a MAXITER run, which keeps it)
  is finished by the other, as the other's uninterrupted run ends, and
  both packages' ``load_state`` read it alike once the layouts are
  mapped (the port's ``Tt`` is the JAX ``T`` transposed; its single-card
  phase-2 file is cut to ``R2_pad`` variables).

The sharded port runs on two gloo ranks in one spawn (``sharded_runs``)
and at one rank in this process; the JAX package on its CPU mesh.
"""

import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import simplex_tpu as jst
from simplex_tpu import checkpoint as jck
import simplex_tpu_torch as pst
from simplex_tpu_torch import checkpoint as pck
from simplex_tpu_torch.parallel.group import spawn, world
from simplex_tpu_torch.solver import run_solve_loop
from simplex_tpu_torch.tableau import build_phase1, gaussian_eliminate

#: tests/test_checkpoint.py's problem; its f64 walk is 98 + 16.
PROBLEM = jst.generate_random_problem(120, 50, 3, 1, 100)
#: A longer phase 2 than phase 1 (f64: 10 + 16), so that a MAXITER run
#: stops in phase 2 and leaves a phase-2 file.
LONG2 = jst.generate_random_problem(300, 8, 2, 1, 100)
#: The f64 default options without the Bland clamp, so windows may be
#: small (the sequential walk does not depend on them then).
F64 = dict(bland_threshold=None)
MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=8)
#: Per phase of the file: (problem, max_iter of the interrupted run,
#: checkpoint_every).
INTERRUPT = {1: (PROBLEM, 60, 25), 2: (LONG2, 12, 5)}


@pytest.fixture
def problem():
    return PROBLEM


def _port(problem, path, every=1000, **kw):
    return pck.solve_resumable(problem, str(path), every, device="cpu", **kw)


def _jax(problem, path, every=1000, **kw):
    return jck.solve_resumable(problem, str(path), every, **kw)


SOLVERS = {"port": _port, "jax": _jax}


def _walk(r):
    return r.iterations_phase1, r.iterations_phase2


def _port_phase1(problem, options):
    A, b = (torch.as_tensor(np.asarray(v)) for v in (problem.A, problem.b))
    return gaussian_eliminate(build_phase1(A, b, problem.vars,
                                           problem.constraints, options))


def test_full_run_with_small_windows(problem, tmp_path):
    path = tmp_path / "state.npz"
    want = jst.solve_oracle(problem)
    got = _port(problem, path, 50, **F64)
    assert got.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not path.exists(), "checkpoint removed on success"


def test_resume_after_interrupt(problem, tmp_path):
    """Run 30 phase-1 pivots, 'crash', resume from the dump."""
    path = str(tmp_path / "state.npz")
    options = pst.SolverOptions()
    tab, _, it = run_solve_loop(_port_phase1(problem, options), options, 30)
    assert it == 30
    pck.save_state(path, tab, phase=1, iterations=30)
    want = jst.solve_oracle(problem)
    got = _port(problem, path, 50)
    assert got.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert _walk(got) == _walk(_port(problem, tmp_path / "fresh.npz"))


def test_state_roundtrip(problem, tmp_path):
    path = str(tmp_path / "state.npz")
    tab = _port_phase1(problem, pst.SolverOptions())
    pck.save_state(path, tab, phase=1, iterations=7, iters1=3)
    tab2, phase, iterations, iters1, n_shards = pck.load_state(
        path, device="cpu")
    assert (phase, iterations, iters1, n_shards) == (1, 7, 3, 0)
    assert (tab2.n, tab2.m, tab2.r) == (tab.n, tab.m, tab.r)
    for f in ("Tt", "b", "costs", "z", "base"):
        np.testing.assert_array_equal(getattr(tab, f).numpy(),
                                      getattr(tab2, f).numpy())


@pytest.mark.parametrize("opts", [F64, MIXED], ids=["sequential",
                                                     "blocked"])
def test_max_iter_never_overshoots(problem, tmp_path, opts):
    """The last window is capped to the remaining budget, so the total
    cannot pass max_iter -- the blocked loop's windows of 8 included."""
    got = _port(problem, tmp_path / "state.npz", 40, max_iter=10,
                **dict(opts, bland_threshold=None))
    assert got.status == pst.Status.MAXITER
    assert got.iterations_phase1 == 10


def test_checkpoint_every_clamp_warns(problem, tmp_path):
    with pytest.warns(RuntimeWarning, match="raised to"):
        got = _port(problem, tmp_path / "state.npz", 10)
    assert got.status == pst.Status.OPTIMAL


@pytest.mark.parametrize("case", ["shape", "dtype"])
def test_mismatch_rejected(problem, tmp_path, case):
    """A checkpoint of another problem, or of other dtypes, is refused
    with the JAX package's messages."""
    path = str(tmp_path / "state.npz")
    pck.save_state(path, _port_phase1(problem, pst.SolverOptions()),
                   phase=1, iterations=0)
    if case == "shape":
        with pytest.raises(ValueError, match="checkpoint is for"):
            _port(jst.generate_random_problem(60, 30, 5, 1, 100), path)
    else:
        with pytest.raises(ValueError, match="dtypes"):
            _port(problem, path, options=pst.SolverOptions(dtype=np.float32))


def test_reference_degeneracy_deletes_checkpoint(tmp_path):
    """A terminal DEGENERATE verdict (reference policy) removes the file,
    from a hand-built phase-1-OPTIMAL state whose basis still holds an
    artificial at value 0 (tests/test_checkpoint.py:195-226)."""
    from simplex_tpu_torch.tableau import Tableau

    n, m = 2, 2
    problem = pst.Problem(A=np.eye(2), b=np.array([1.0, 0.0]),
                          c=np.array([1.0, 1.0]))
    R_pad, M_pad = 8, 128
    Tt = torch.zeros((M_pad, R_pad), dtype=torch.float64)
    Tt[0, 0] = 1.0              # x1 basic in constraint 0 at value 1
    Tt[1, n + m + 1] = 1.0      # artificial a2 basic at value 0
    base = torch.full((M_pad,), R_pad, dtype=torch.int32)
    base[:m] = torch.tensor([0, n + m + 1])
    b = torch.zeros(M_pad, dtype=torch.float64)
    b[0] = 1.0
    tab = Tableau(Tt=Tt, b=b, costs=torch.zeros(R_pad, dtype=torch.float64),
                  z=torch.zeros((), dtype=torch.float64), base=base, n=n,
                  m=m, r=n + 2 * m)
    path = tmp_path / "state.npz"
    pck.save_state(str(path), tab, phase=1, iterations=5)
    got = _port(problem, path, 50, degeneracy="reference")
    assert got.status == pst.Status.DEGENERATE
    assert got.degenerate
    assert not path.exists(), "terminal DEGENERATE must delete the file"


@pytest.mark.parametrize("every,opts", [
    (1000, {}), (30, F64), (60, MIXED)],
    ids=["f64-default", "f64-windows-of-30", "mixed-L8"])
def test_matches_jax(problem, tmp_path, every, opts):
    """f64: the same status and pivot counts, objectives within 1e-9;
    mixed: the same status, both refined and certified within 1e-9 of
    each other and of the oracle."""
    got = _port(problem, tmp_path / "p.npz", every, **opts)
    want = _jax(problem, tmp_path / "j.npz", every, **opts)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    if "dtype" in opts:
        assert got.refine.certified and want.refine.certified
        assert got.refine.method == "tableau"
        assert got.objective == pytest.approx(
            jst.solve_oracle(problem).objective, rel=1e-9)
    else:
        assert got.refine is None
        assert _walk(got) == _walk(want)


@pytest.fixture(scope="module")
def written():
    """{(writer, phase): path} of an interrupted run's file (MAXITER keeps
    it) written by each package, in each phase; tests copy them."""
    files = {}
    with tempfile.TemporaryDirectory() as td:
        for writer, solve in SOLVERS.items():
            for phase, (problem, cap, every) in INTERRUPT.items():
                path = os.path.join(td, f"{writer}{phase}.npz")
                r = solve(problem, path, every, max_iter=cap, **F64)
                assert r.status == pst.Status.MAXITER and os.path.exists(path)
                files[writer, phase] = path
        yield files


def _copy(written, key, tmp_path):
    path = tmp_path / "state.npz"
    shutil.copy(written[key], path)
    return path


KEYS = [(w, ph) for w in SOLVERS for ph in INTERRUPT]
KEY_IDS = [f"{w}-writes-phase{ph}" for w, ph in KEYS]


@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_cross_package_resume(written, tmp_path, key):
    """The other package finishes the file, as its uninterrupted run ends:
    the same walk, the objective within 1e-9."""
    writer, phase = key
    problem = INTERRUPT[phase][0]
    reader = SOLVERS["jax" if writer == "port" else "port"]
    path = _copy(written, key, tmp_path)
    with np.load(path) as z:
        assert int(z["__meta__"][3]) == phase
    got = reader(problem, path, 5, **F64)
    want = reader(problem, tmp_path / "fresh.npz", 5, **F64)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not path.exists()


@pytest.mark.parametrize("key", KEYS, ids=KEY_IDS)
def test_load_state_maps_layouts(written, key):
    """Both packages' ``load_state`` of one file: the port's ``Tt`` is
    the JAX ``T`` transposed, the vectors and counters equal, and the
    base equal where live (below r), past r in both where not. The
    port's single-card phase-2 file holds R2_pad variables, the JAX
    package's shape."""
    import simplex_tpu.tableau as jtab

    path = written[key]
    jt, *jmeta = jck.load_state(path)
    pt, *pmeta = pck.load_state(path, device="cpu")
    assert jmeta == pmeta
    np.testing.assert_array_equal(pt.Tt.numpy().T, np.asarray(jt.T))
    for f in ("b", "costs", "z"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    jb, pb = np.asarray(jt.base), pt.base.numpy()
    live = jb < jt.r
    np.testing.assert_array_equal(pb[live], jb[live])
    assert (pb[~live] >= pt.r).all()
    if key == ("port", 2):
        problem = INTERRUPT[2][0]
        R2 = jtab.padded_dims(problem.vars, problem.constraints,
                              jst.SolverOptions())[1]
        assert jt.T.shape[0] == R2


# ---------------------------------------------------------------------------
# Sharded: two gloo ranks in one spawn, one rank in this process, the JAX
# package on a CPU mesh of as many devices.

def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("vars",))


def _jax_sharded(problem, path, every, n=2, **kw):
    return jck.solve_resumable_sharded(problem, _mesh(n), str(path), every,
                                       **kw)


@pytest.fixture(scope="module")
def sharded_runs():
    """The port's two-rank runs, in one spawn, in order: a full f64 run; a
    full mixed run; a MAXITER run that keeps its file and its resume; the
    resume of a JAX-written two-shard file; a MAXITER run whose file JAX
    then finishes. Yields (results by name, the directory of the files)."""
    opts = jst.SolverOptions(**F64)
    mixed = jst.SolverOptions(**MIXED)
    capped = jst.SolverOptions(max_iter=60, **F64)
    with tempfile.TemporaryDirectory() as td:
        f = {k: os.path.join(td, f"{k}.npz") for k in
             ("full", "mixed", "mid", "from_jax", "for_jax")}
        r = _jax_sharded(PROBLEM, f["from_jax"], 25, max_iter=60, **F64)
        assert r.status == jst.Status.MAXITER
        names = ["full", "mixed", "mid_capped", "mid_resumed", "from_jax",
                 "for_jax"]
        cases = [(PROBLEM, f["full"], 25, opts),
                 (PROBLEM, f["mixed"], 60, mixed),
                 (PROBLEM, f["mid"], 25, capped),
                 (PROBLEM, f["mid"], 25, opts),
                 (PROBLEM, f["from_jax"], 25, opts),
                 (PROBLEM, f["for_jax"], 25, capped)]
        res = spawn(pck.solve_resumable_sharded_rank, 2, "gloo", "cpu", cases)
        yield dict(zip(names, res)), f


def test_sharded_full_run_matches_jax(sharded_runs):
    """Two ranks, windows of 25: the JAX sharded walk and objective; the
    file removed."""
    runs, f = sharded_runs
    want = _jax_sharded(PROBLEM, f["full"] + ".jax", 25, **F64)
    got = runs["full"]
    assert got.status == want.status == pst.Status.OPTIMAL
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not os.path.exists(f["full"])


def test_sharded_mixed_full_run_certified(sharded_runs):
    got = sharded_runs[0]["mixed"]
    assert got.status == pst.Status.OPTIMAL and got.refine.certified
    assert got.objective == pytest.approx(
        jst.solve_oracle(PROBLEM).objective, rel=1e-9)


def test_sharded_resume_midway(sharded_runs):
    """MAXITER keeps the file; the resume ends as the full run did."""
    runs, f = sharded_runs
    assert runs["mid_capped"].status == pst.Status.MAXITER
    assert runs["mid_capped"].iterations_phase1 == 60
    got = runs["mid_resumed"]
    assert got.status == pst.Status.OPTIMAL
    assert _walk(got) == _walk(runs["full"])
    assert got.objective == pytest.approx(runs["full"].objective, rel=1e-12)
    assert not os.path.exists(f["mid"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_cross_package_resume(sharded_runs, tmp_path, writer):
    """A two-shard file of one package finished by the other, as the
    other's uninterrupted two-shard run ends."""
    runs, f = sharded_runs
    if writer == "jax":
        got, want = runs["from_jax"], runs["full"]
    else:
        assert runs["for_jax"].status == pst.Status.MAXITER
        path = tmp_path / "state.npz"
        shutil.copy(f["for_jax"], path)
        got = _jax_sharded(PROBLEM, path, 25, **F64)
        want = _jax_sharded(PROBLEM, tmp_path / "fresh.npz", 25, **F64)
        assert not path.exists()
    assert got.status == want.status == pst.Status.OPTIMAL
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def test_sharded_width_mismatch_rejected(sharded_runs, tmp_path):
    """A two-shard file (the port's) refused at one rank, as the JAX
    package refuses a 4-shard file on 2 shards."""
    path = tmp_path / "state.npz"
    shutil.copy(sharded_runs[1]["for_jax"], path)
    with world(0, 1, "gloo", str(tmp_path)) as group:
        with pytest.raises(ValueError, match="2-shard mesh"):
            pck.solve_resumable_sharded(PROBLEM, group, str(path),
                                        device="cpu")


@pytest.mark.parametrize("writer", ["sharded", "single"])
def test_kind_mismatch_rejected(sharded_runs, tmp_path, writer):
    """A single-card resume refuses a sharded file, and a sharded resume
    a single-card one."""
    path = tmp_path / "state.npz"
    if writer == "sharded":
        shutil.copy(sharded_runs[1]["for_jax"], path)
        with pytest.raises(ValueError, match="sharded"):
            _port(PROBLEM, path)
        return
    r = _port(PROBLEM, path, 25, max_iter=60, **F64)
    assert r.status == pst.Status.MAXITER and path.exists()
    with world(0, 1, "gloo", str(tmp_path)) as group:
        with pytest.raises(ValueError, match="single-chip"):
            pck.solve_resumable_sharded(PROBLEM, group, str(path),
                                        device="cpu")


@pytest.mark.parametrize("every,opts", [(25, F64), (60, MIXED)],
                         ids=["f64", "mixed"])
def test_one_rank_walks_as_single_card(tmp_path, every, opts):
    """At one rank the sharded resumable solve walks as ``solve_resumable``
    and ends at its objective (the same arithmetic on the one slice)."""
    with world(0, 1, "gloo", str(tmp_path)) as group:
        got = pck.solve_resumable_sharded(PROBLEM, group,
                                          str(tmp_path / "s.npz"), every,
                                          device="cpu", **opts)
    want = _port(PROBLEM, tmp_path / "c.npz", every, **opts)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert _walk(got) == _walk(want)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert (got.refine is None) == (want.refine is None)

