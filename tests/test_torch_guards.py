"""Guards of the PyTorch port: it imports no JAX, its device is explicit,
configurations it does not port yet raise (the ones ported since solve
and match the JAX package), and the CPU path never counts a kernel
launch."""

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


def test_port_never_imports_jax():
    """A fresh interpreter imports every module of the port and runs a
    CPU solve: neither jax nor simplex_tpu may be loaded."""
    code = (
        "import sys\n"
        "import simplex_tpu_torch as st\n"
        "import simplex_tpu_torch.reinvert, simplex_tpu_torch.refine\n"
        "import simplex_tpu_torch.kernels._build\n"
        "import simplex_tpu_torch.cli, simplex_tpu_torch.timed\n"
        "import simplex_tpu_torch.chrono, simplex_tpu_torch.kernels.pivot\n"
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'simplex_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(RuntimeError, match="cuda"):
        pst.solve(p, **PROD)              # device defaults to "cuda"


def test_unknown_device_raises():
    p = pst.read_problem(DATA / "smallProblem.txt")
    with pytest.raises(ValueError, match="device"):
        pst.solve(p, device="meta", **PROD)


@pytest.mark.parametrize("opts,item", [
    (dict(), None),                                           # f64 default
    (dict(dtype=np.float64, block_pivots=128), None),
    (dict(dtype=np.float32, vector_dtype=np.float64), None),
    (dict(dtype=np.float32, vector_dtype=np.float32, use_pallas=True),
     None),
    (dict(PROD, block_pivots=12), None),
    (dict(PROD, use_pallas=False), None),
    (dict(PROD, equilibrate=True), "item 6"),
], ids=["f64-default", "f64-blocked", "f32-sequential", "pallas-sequential",
        "L-not-multiple-of-8", "kernels-off", "equilibrate"])
def test_unported_configurations_raise(opts, item):
    """Every option set of the JAX ``solve`` but ``equilibrate`` is
    ported: those cases (they raised until the sequential and plain
    blocked loops landed) solve on the CPU and match the JAX result --
    status and pivot counts, the objective within 1e-12 (within 1e-9
    after the mixed modes' refinement). ``equilibrate`` still raises,
    naming its ROADMAP item."""
    p = pst.read_problem(DATA / "smallProblem.txt")
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            pst.solve(p, device="cpu", **opts)
        return
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
    assert [s.name for s in _build._sources()] == ["batched.cu",
                                                    "blocked.cu", "pivot.cu"]


BATCH = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=8,
             eps=1e-5)


def _batch(k=2):
    return [pst.generate_random_problem(12, 6, s, 1, 100)
            for s in range(1, k + 1)]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=object()), NotImplementedError, "ROADMAP queue 1 item 8"),
    (dict(kernel=False), NotImplementedError, "ROADMAP queue 1 item 7"),
    (dict(dtype=np.float64), NotImplementedError, "ROADMAP queue 1 item 7"),
    (dict(block_pivots=1), NotImplementedError, "ROADMAP queue 1 item 7"),
    (dict(block_pivots=12), NotImplementedError, "ROADMAP queue 1 item 7"),
    (dict(kernel="interpret"), ValueError, "device='cpu'"),
], ids=["mesh", "kernel-false", "f64", "sequential", "L-not-multiple-of-8",
        "interpret"])
def test_batch_unported_configurations_raise(kw, exc, match):
    opts = dict(BATCH)
    opts.update({k: v for k, v in kw.items() if k not in ("mesh", "kernel")})
    with pytest.raises(exc, match=match):
        pst.solve_batch(_batch(), device="cpu",
                        **{k: v for k, v in kw.items()
                           if k in ("mesh", "kernel")}, **opts)


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
    reinversion rounds the lane raises, naming the f64 finishing solve."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        pst.solve_batch(_batch(1), device="cpu",
                        **dict(BATCH, refine_tol=1e-300))
