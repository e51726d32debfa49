"""Guards of the PyTorch port: it imports no JAX, its device is explicit,
the configurations that once raised (not ported then) solve and match
the JAX package, and the CPU path never counts a kernel launch."""

import ast
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import simplex_tpu as jst
import simplex_tpu_torch as pst
from simplex_tpu_torch.kernels import _build
from simplex_tpu_torch.kernels import blocked as kb

from conftest import DATA

ROOT = DATA.parents[1]
PROD = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=128)


#: A path component naming the JAX package, in a string of the code.
JAX_PATH = re.compile(r"(^|[/\\])simplex_tpu($|[/\\])")


def _code_strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_never_imports_jax():
    """A fresh interpreter imports every module of the port and runs a
    CPU solve: neither jax nor simplex_tpu may be loaded. No module of the
    port builds a path into the JAX package (a ``"simplex_tpu"`` path
    component in a string of the code, as ``parents[2] / "simplex_tpu"``
    was; docstrings and comments citing ``simplex_tpu/...:line`` stay
    allowed): what the port needs from there it keeps a copy of."""
    hits = [(str(f.relative_to(ROOT)), line, text)
            for f in sorted((ROOT / "simplex_tpu_torch").rglob("*.py"))
            for line, text in _code_strings(f) if JAX_PATH.search(text)]
    assert hits == []
    assert JAX_PATH.search("simplex_tpu") and JAX_PATH.search(
        "../simplex_tpu/native") and not JAX_PATH.search("simplex_tpu_torch")
    code = (
        "import sys\n"
        "import simplex_tpu_torch as st\n"
        "import simplex_tpu_torch.checkpoint as ck\n"
        "import simplex_tpu_torch.reinvert, simplex_tpu_torch.refine\n"
        "import simplex_tpu_torch.kernels._build\n"
        "import simplex_tpu_torch.cli, simplex_tpu_torch.timed\n"
        "import simplex_tpu_torch.chrono, simplex_tpu_torch.kernels.pivot\n"
        "import simplex_tpu_torch.oracle, simplex_tpu_torch.finish\n"
        "import simplex_tpu_torch.scaling, simplex_tpu_torch.batch_fallback\n"
        "import simplex_tpu_torch.utils.cuda_order\n"
        "import simplex_tpu_torch.utils.fma_native\n"
        "import simplex_tpu_torch.parallel.group as pg\n"
        "import simplex_tpu_torch.parallel.sharded, tempfile\n"
        "import simplex_tpu_torch.bench, simplex_tpu_torch.bench_batch\n"
        "import simplex_tpu_torch.bench_sharded\n"
        "import simplex_tpu_torch.sweep_table\n"
        "import simplex_tpu_torch.validate_refine_sweep\n"
        "import simplex_tpu_torch.measure_refine_flagship\n"
        "with tempfile.TemporaryDirectory() as td, \\\n"
        "        pg.world(0, 1, 'gloo', td) as g:\n"
        "    r = st.solve_sharded(st.read_problem(\n"
        "        'data/examples/smallProblem.txt'), g, device='cpu')\n"
        "    assert r.status == st.Status.OPTIMAL and r.objective == 64.0\n"
        "    rb = st.solve_batch([st.generate_random_problem(8, 4, 1, 1, 9)],\n"
        "                        device='cpu', mesh=g, dtype='float32',\n"
        "                        vector_dtype='float64', block_pivots=8)\n"
        "    assert rb[0].status == st.Status.OPTIMAL\n"
        "r = st.solve(st.read_problem('data/examples/smallProblem.txt'),\n"
        "             device='cpu')\n"
        "assert r.status == st.Status.OPTIMAL and r.objective == 64.0\n"
        "r = st.solve(st.read_problem('data/examples/smallProblem.txt'),\n"
        "             device='cpu', dtype='float32', vector_dtype='float64',\n"
        "             block_pivots=128)\n"
        "assert r.status == st.Status.OPTIMAL\n"
        "rb = st.solve_batch([st.generate_random_problem(8, 4, 1, 1, 9)],\n"
        "                    device='cpu', dtype='float32',\n"
        "                    vector_dtype='float64', block_pivots=8)\n"
        "assert rb[0].status == st.Status.OPTIMAL\n"
        "p = st.generate_random_problem(8, 4, 1, 1, 9)\n"
        "assert st.solve_batch([p], device='cpu')[0].status == 0\n"
        "assert st.solve(p, device='cpu', equilibrate=True).status == 0\n"
        "assert st.solve_oracle(p, tie_rule='cuda',\n"
        "                       update_rule='fma').status == 0\n"
        "with tempfile.TemporaryDirectory() as td:\n"
        "    r = st.solve_resumable(p, td + '/s.npz', 5, device='cpu',\n"
        "                           bland_threshold=None)\n"
        "    assert r.status == 0\n"
        "    with pg.world(0, 1, 'gloo', td) as g:\n"
        "        r = ck.solve_resumable_sharded(p, g, td + '/t.npz',\n"
        "                                       device='cpu')\n"
        "    assert r.status == 0\n"
        "A, b, c = st.generate_random_problem_device(8, 4, 1, device='cpu')\n"
        "assert st.compare(1.0, 1.0) == 0\n"
        "from simplex_tpu_torch.two_phase import fallback_solve\n"
        "assert fallback_solve(p, st.SolverOptions(), device='cpu').refine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'simplex_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(RuntimeError, match="cuda"):
        pst.solve(p, **PROD)              # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        pst.solve_resumable(p, str(tmp_path / "state.npz"))
    with pytest.raises(RuntimeError, match="cuda"):
        pst.generate_random_problem_device(8, 4, 1)
    assert not (tmp_path / "state.npz").exists()


@pytest.mark.parametrize("module", ["bench", "bench_batch",
                                    "bench_sharded", "validate_refine_sweep",
                                    "measure_refine_flagship"])
def test_bench_entry_points_need_the_card(module, tmp_path):
    """The benchmark and measurement entry points run on the card unless
    given ``--device cpu``: without one they exit non-zero, naming cuda,
    print nothing on stdout and write no record."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    out = tmp_path / "sweep.json"
    args = (["--limit", "256", "--out", str(out)]
            if module == "validate_refine_sweep"
            else ["--vars", "40", "--constraints", "10"])
    proc = subprocess.run(
        [sys.executable, "-m", f"simplex_tpu_torch.{module}", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "cuda" in proc.stderr
    assert not out.exists()


def test_sharded_and_fleet_default_to_cuda(tmp_path):
    """solve_sharded, the fleet and solve_resumable_sharded default to the
    card, and raise where it is absent -- before they touch the group."""
    from simplex_tpu_torch.checkpoint import solve_resumable_sharded
    from simplex_tpu_torch.parallel.group import world

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(RuntimeError, match="cuda"):
        pst.solve_sharded(p, None, **PROD)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_resumable_sharded(p, None, str(tmp_path / "state.npz"), **PROD)
    with world(0, 1, "gloo", str(tmp_path)) as group:
        with pytest.raises(RuntimeError, match="cuda"):
            pst.solve_batch(_batch(), mesh=group, **BATCH)


def test_unknown_device_raises():
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(ValueError, match="device"):
        pst.solve(p, device="meta", **PROD)


@pytest.mark.parametrize("opts", [
    dict(),                                                   # f64 default
    dict(dtype=np.float64, block_pivots=128),
    dict(dtype=np.float32, vector_dtype=np.float64),
    dict(dtype=np.float32, vector_dtype=np.float32, use_pallas=True),
    dict(PROD, block_pivots=12),
    dict(PROD, use_pallas=False),
    dict(PROD, equilibrate=True),
], ids=["f64-default", "f64-blocked", "f32-sequential", "pallas-sequential",
        "L-not-multiple-of-8", "kernels-off", "equilibrate"])
def test_unported_configurations_raise(opts):
    """Every option set of the JAX ``solve`` is ported: these cases (they
    raised until the sequential and plain blocked loops, and then
    ``scaling.py``, landed) solve on the CPU and match the JAX result --
    status and pivot counts, the objective within 1e-12 (within 1e-9
    after the mixed modes' refinement)."""
    p = pst.read_problem(DATA / "smallProblem.txt")
    got, want = pst.solve(p, device="cpu", **opts), jst.solve(p, **opts)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert (got.iterations_phase1, got.iterations_phase2) == \
        (want.iterations_phase1, want.iterations_phase2)
    rel = 1e-9 if got.refine is not None else 1e-12
    assert got.objective == pytest.approx(want.objective, rel=rel)
    assert got.objective == pytest.approx(64.0, rel=rel)


def test_production_call_resolves_like_jax():
    """README's production call keeps the JAX defaults and resolves to
    devex pricing, eps 1e-4 and refinement on."""
    from simplex_tpu_torch.config import (kernel_blocked_enabled,
                                          refine_enabled)

    opts = pst.SolverOptions(**PROD)
    assert kernel_blocked_enabled(opts) and refine_enabled(opts)
    assert opts.pivot_rule_resolved == "devex"
    assert opts.eps_resolved == 1e-4
    assert pst.SolverOptions().dtype == np.float64


def test_cpu_solve_counts_no_launch():
    kb.reset_launches()
    r = pst.solve(pst.generate_random_problem(64, 16, 1, 1, 100),
                  device="cpu", **PROD)
    assert r.status == pst.Status.OPTIMAL
    assert all(v == 0 for v in kb.LAUNCHES.values()), kb.LAUNCHES


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_name_follows_the_sources():
    """The build is keyed by a hash of the sources and flags: one name
    per tree, stable across calls."""
    assert _build.source_digest() == _build.source_digest()
    assert len(_build.source_digest()) == 16
    assert [s.name for s in _build._sources()] == [
        "batched.cu", "blocked.cu", "eta.cu", "pivot.cu", "seq.cu",
        "sharded_step.cu", "step.cu"]


BATCH = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=8,
             eps=1e-5)


def _batch(k=2):
    return [pst.generate_random_problem(12, 6, s, 1, 100)
            for s in range(1, k + 1)]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=object()), TypeError, "ProcessGroup"),
    (dict(kernel=False), None, None),
    (dict(dtype=np.float64), None, None),
    (dict(block_pivots=1), None, None),
    (dict(block_pivots=12), None, None),
    (dict(kernel="interpret"), ValueError, "device='cpu'"),
], ids=["mesh", "kernel-false", "f64", "sequential", "L-not-multiple-of-8",
        "interpret"])
def test_batch_unported_configurations_raise(kw, exc, match):
    """A ``mesh`` that is no ProcessGroup and the JAX package's
    ``kernel="interpret"`` raise. The options the batched kernels do not
    take (``kernel=False``, an f64 tableau, a sequential one, an L that is
    not a multiple of 8) raised until the batched fallback landed: they
    now solve and match ``simplex_tpu.solve_batch`` (whose kernels are off
    on the CPU, so it runs its fallback) -- statuses equal, the objective
    within 1e-9 (refined in the mixed modes), pivot counts equal in f64
    and within max(3, 10%) in the mixed walks, which are not pinned."""
    opts = dict(BATCH)
    opts.update({k: v for k, v in kw.items() if k not in ("mesh", "kernel")})
    extra = {k: v for k, v in kw.items() if k in ("mesh", "kernel")}
    if exc is not None:
        with pytest.raises(exc, match=match):
            pst.solve_batch(_batch(), device="cpu", **extra, **opts)
        return
    got = pst.solve_batch(_batch(), device="cpu", **extra, **opts)
    want = jst.solve_batch(_batch(), jst.SolverOptions(**opts),
                           kernel=extra.get("kernel", "auto"))
    f64 = np.dtype(opts["dtype"]) == np.float64
    for g, w in zip(got, want):
        assert g.status == w.status == pst.Status.OPTIMAL
        assert g.objective == pytest.approx(w.objective, rel=1e-9)
        for a, b in ((g.iterations_phase1, w.iterations_phase1),
                     (g.iterations_phase2, w.iterations_phase2)):
            assert a == b if f64 else abs(a - b) <= max(3, 0.1 * b)


def test_batch_block_pivots_lifts_the_alignment_rule():
    """An explicit batch_block_pivots is the window; block_pivots' own
    alignment is then irrelevant, as in simplex_tpu.batch."""
    res = pst.solve_batch(_batch(), device="cpu",
                          **dict(BATCH, block_pivots=12,
                                 batch_block_pivots=16))
    assert all(r.status == pst.Status.OPTIMAL for r in res)


def test_heterogeneous_batch_raises():
    with pytest.raises(ValueError, match="homogeneous"):
        pst.solve_batch(_batch() + [pst.generate_random_problem(13, 6, 9, 1,
                                                                 100)],
                        device="cpu", **BATCH)


def test_batch_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        pst.solve_batch(_batch(), **BATCH)     # device defaults to "cuda"


def test_cpu_batch_counts_no_launch():
    from simplex_tpu_torch.kernels import batched as kbt

    kbt.reset_launches()
    res = pst.solve_batch(_batch(3), device="cpu", **BATCH)
    assert all(r.status == pst.Status.OPTIMAL for r in res)
    assert all(v == 0 for v in kbt.LAUNCHES.values()), kbt.LAUNCHES
    assert pst.solve_batched is pst.solve_batch


def test_batch_lane_that_never_certifies_raises():
    """No certificate passes at refine_tol=1e-300: after the two
    reinversion rounds (which the JAX package does not run) the lane goes
    to the f64 finishing tier, as in ``simplex_tpu.batch._refine_lane``,
    and comes back OPTIMAL with ``refine.fallback`` set, at the JAX
    package's objective (it raised until the finishing tier landed)."""
    opts = dict(BATCH, refine_tol=1e-300)
    (got,) = pst.solve_batch(_batch(1), device="cpu", **opts)
    (want,) = jst.solve_batch(_batch(1), jst.SolverOptions(**opts),
                              kernel="interpret")
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.fallback and want.refine.fallback
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert got.x.shape == (12,) and np.isfinite(got.x).all()


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_collective_structure_pinned(rule):
    """The port's counterpart of tests/test_sharded_kernel.py:169-231, on
    two gloo ranks: the kernel loop (L = 8, re-pricing every 2 windows)
    capped at 8, 16 and 24 pivots (1, 2, 3 windows, the second on the
    re-pricing cadence) issues exactly

    * once: 1 all_gather for the cost scale, 2 for the first candidates;
    * per pivot: 2 all_gathers (candidate values, candidate indices) and
      1 all_reduce (the entering column);
    * per window: under devex 1 all_gather (the weights' re-anchor); on a
      re-pricing window 1 all_reduce (basic costs) and 3 all_gathers (the
      premature-optimal minimum and the candidates), none off cadence (K4);

    the sequential f64 loop 2 all_gathers and 1 all_reduce per pivot; and
    a whole mixed solve one (m, m) all_reduce, the slack block. A change
    that adds a collective per pivot or per window fails here."""
    from simplex_tpu_torch.parallel.group import spawn
    from simplex_tpu_torch.parallel.sharded import count_collectives

    n, m, L = 96, 48, 8
    problem = pst.generate_random_problem(n, m, 3, 1, 100)
    mixed = pst.SolverOptions(**dict(PROD, block_pivots=L, eps=1e-5,
                                     pivot_rule=rule))
    (loops, shapes), (seq, _) = spawn(
        count_collectives, 2, "gloo", "cpu", problem,
        [(mixed, [L, 2 * L, 3 * L]), (pst.SolverOptions(), [8])])
    devex = int(rule == "devex")
    for windows, (iters, counts) in enumerate(loops, start=1):
        assert iters == windows * L
        reprices = windows // 2
        assert counts == {
            "all_gather": 3 + windows * (2 * L + devex) + 3 * reprices,
            "all_reduce": windows * L + reprices}, (windows, counts)
    assert seq == [(8, {"all_gather": 16, "all_reduce": 8})]
    assert shapes[("all_reduce", (m, m))] == 1


@pytest.mark.parametrize("rule", ["devex", "dantzig"])
def test_plain_blocked_collectives_pinned(rule):
    """The plain blocked sharded loop (``solve_loop_blocked_sharded``: the
    f64 tableau with L = 8, and the f32 one with the kernels off) on two
    gloo ranks, capped at 8 and 16 pivots (1 and 2 windows), issues
    exactly

    * per pivot: 2 all_gathers (candidate values, candidate indices) and 1
      all_reduce (the entering column), and under devex 1 all_gather more
      (the re-anchor's largest weights);
    * per window, on the f32 tableau only: 1 all_reduce (the basic costs of
      the exact re-pricing) and 1 all_gather (the premature-optimal
      minimum);
    * once, on the f32 tableau only: 1 all_gather (the cost scale);

    as the eager loop it replaced did. A change that adds a collective per
    pivot or per window fails here."""
    from simplex_tpu_torch.parallel.group import spawn
    from simplex_tpu_torch.parallel.sharded import count_collectives

    n, m, L = 96, 48, 8
    problem = pst.generate_random_problem(n, m, 3, 1, 100)
    f64 = pst.SolverOptions(block_pivots=L, pivot_rule=rule)
    f32 = pst.SolverOptions(**dict(PROD, block_pivots=L, eps=1e-5,
                                   pivot_rule=rule, use_pallas=False))
    runs = spawn(count_collectives, 2, "gloo", "cpu", problem,
                 [(f64, [L, 2 * L]), (f32, [L, 2 * L])])
    devex = int(rule == "devex")
    for reprice, (loops, _) in enumerate(runs):
        for windows, (iters, counts) in enumerate(loops, start=1):
            assert iters == windows * L
            assert counts == {
                "all_gather": reprice + windows * ((2 + devex) * L
                                                   + reprice),
                "all_reduce": windows * (L + reprice)}, (reprice, windows,
                                                         counts)
