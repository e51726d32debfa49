"""The port's benchmark entry points on the CPU at tiny shapes:
``simplex_tpu_torch.bench`` (the one-JSON-line contract of bench.py,
pinned as tests/test_bench.py pins it), its tableau and capped loop
against the JAX package's, the restore of its in-place working tableau,
its floor's counts (``pivot_work``) and its amortised fallback;
``simplex_tpu_torch.bench_batch`` (``BENCH_BATCH_OK``) and
``simplex_tpu_torch.bench_sharded`` (its one line, at one and two gloo
ranks).

Rules: f64 walks equal the JAX package's in status and pivots, z within
1e-12 relative; mixed walks equal in status, pivots within max(3, 10%)
(their near-ties part across implementations, as tests/test_torch_loop.py
states). The JAX side runs its own dispatch (``run_solve_loop``); in the
mixed mode with its blocked kernels in interpret mode, as the JAX
package's tests run them.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu.config as jax_config
import simplex_tpu.solver as jax_solver
from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.tableau import build_phase1, gaussian_eliminate
from simplex_tpu_torch import bench, bench_batch, bench_sharded
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.solver import run_solve_loop

#: tests/test_bench.py:43-49: the key set of bench.py's line.
KEYS = {"metric", "value", "unit", "vs_baseline", "ceiling_gbs",
        "floor_ms_per_pivot", "efficiency_pct", "pivot_rule",
        "dantzig_ms_per_pivot", "build_trace_s", "build_compile_s",
        "build_exec_s", "loop_trace_s", "loop_compile_s"}
STAGES = ("build_trace_s", "build_compile_s", "build_exec_s",
          "loop_trace_s", "loop_compile_s")
MODES = {
    "f64": dict(dtype=np.float64, block_pivots=128),
    "mixed": dict(dtype=np.float32, vector_dtype=np.float64,
                  block_pivots=128),
}


def _one_line(capsys, main, argv):
    """Run ``main(argv)``: exit code 0 and one line on stdout, parsed as
    JSON; returns it and stderr."""
    rc = main(argv)
    out = capsys.readouterr()
    lines = [l for l in out.out.splitlines() if l.strip()]
    assert rc == 0
    assert len(lines) == 1, lines
    return json.loads(lines[0]), out.err


@pytest.mark.parametrize("extra", [
    [],                                           # blocked L=128, mixed
    ["--block", "0", "--no-pallas"],              # sequential plain loop
    ["--dtype", "float64"],                       # exact-parity dtype
    ["--block", "0", "--vector-dtype", "float32"],  # K6's path
], ids=["default", "sequential", "f64", "k6"])
def test_one_json_line_contract(capsys, extra):
    rec, _ = _one_line(capsys, bench.main,
                       ["--vars", "1200", "--constraints", "250", "--iters",
                        "16", "--repeats", "1", "--device", "cpu"] + extra)
    assert set(rec) == KEYS
    for k in STAGES:
        assert rec[k] >= 0
    assert rec["build_trace_s"] == rec["loop_trace_s"] == 0.0
    assert rec["loop_compile_s"] == 0.0
    assert rec["build_compile_s"] == 0.0          # nothing is built here
    assert rec["pivot_rule"] in ("dantzig", "devex", "bland")
    assert (rec["dantzig_ms_per_pivot"] is None) == (
        rec["pivot_rule"] == "dantzig")
    assert rec["unit"] == "GB/s/chip"
    assert rec["value"] > 0
    assert rec["ceiling_gbs"] > 0
    assert rec["floor_ms_per_pivot"] > 0
    assert rec["efficiency_pct"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.REFERENCE_GBPS, abs=0.011)


def _numpy_inputs(n=300, m=80, seed=20261017):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 100, (m, n)).astype(np.float32),
            rng.uniform(1, 100, m).astype(np.float32))


def _jax_run(tab, opts, cap, costs0, interpret):
    """The JAX package's ``run_solve_loop``; with ``interpret`` its blocked
    kernels run in interpret mode (the dispatch takes them as on a TPU)."""
    if not interpret:
        return jax_solver.run_solve_loop(tab, opts, cap, costs0)
    saved = (jax_config.kernel_blocked_enabled,
             jax_solver.solve_loop_blocked_kernel)
    jax_config.kernel_blocked_enabled = jax_config.kernel_blocked_eligible
    jax_solver.solve_loop_blocked_kernel = functools.partial(
        saved[1], interpret=True)
    try:
        return jax_solver.run_solve_loop(tab, opts, cap, costs0)
    finally:
        (jax_config.kernel_blocked_enabled,
         jax_solver.solve_loop_blocked_kernel) = saved


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_walk_matches_jax(mode):
    """The bench's tableau (``bench_tableau``) and capped loop
    (``run_capped``) against the JAX package's build, elimination and
    ``run_solve_loop`` from the same A and b, at two caps inside the walk
    and one past its end."""
    n, m = 300, 80
    A, b = _numpy_inputs(n, m)
    popt, jopt = SolverOptions(**MODES[mode]), JaxOptions(**MODES[mode])
    dt = getattr(torch, popt.dtype.name)
    tab0, costs0 = bench.bench_tableau(torch.from_numpy(A).to(dt),
                                       torch.from_numpy(b).to(dt), n, m, popt)
    M_pad, R_pad = tab0.Tt.shape
    jtab = build_phase1(jnp.asarray(A, popt.dtype), jnp.asarray(b, popt.dtype),
                        n, m, jopt, dims=(R_pad, M_pad))
    jcosts0 = jtab.costs
    jtab = gaussian_eliminate(jtab)
    z0 = abs(float(jtab.z))
    work = bench.working_copy(tab0)
    for cap in (40, 90, 5000):
        got = bench.run_capped(work, tab0, costs0, popt, cap)
        wtab, wst, wit = _jax_run(jtab, jopt, cap, jcosts0, mode == "mixed")
        assert got.status == int(wst)
        if mode == "mixed":
            assert abs(got.iterations - int(wit)) <= max(3, int(wit) // 10)
            continue
        assert got.iterations == int(wit)
        z, wz = float.fromhex(got.z), float(wtab.z)
        # Phase 1 ends at z = 0, where a relative error means nothing:
        # there the error is taken relative to the objective's start.
        scale = abs(wz) if got.status == int(Status.RUNNING) else z0
        assert abs(z - wz) <= 1e-12 * scale, (cap, z, wz)
    assert got.status == int(Status.OPTIMAL)


@pytest.mark.parametrize("opts", [
    dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=16),
    dict(dtype=np.float32, vector_dtype=np.float32, use_pallas=True),
], ids=["blocked-kernel-loop", "k6"])
def test_restore_repeats_the_walk(opts):
    """Two repeats from the restored working copy and a fresh run walk
    the same (iterations, z, base) bit for bit; the ceiling pass leaves
    the pristine tableau untouched; without the restore the loop, which
    updates the tableau in place, walks on from where it stopped."""
    options = SolverOptions(**opts)
    n, m, cap = 300, 80, 24

    def fresh():
        tab0, costs0 = bench.build_bench_state(n, m, torch.float32, options,
                                               {}, "cpu")
        return tab0, costs0, bench.working_copy(tab0)

    tab0, costs0, work = fresh()
    before = [getattr(tab0, f).clone() for f in ("Tt", "b", "costs", "z",
                                                 "base")]
    assert bench.measure_rmw_ceiling(work.Tt, iters=2, repeats=1) > 0
    for f, x in zip(("Tt", "b", "costs", "z", "base"), before):
        assert torch.equal(getattr(tab0, f), x), f
    assert not torch.equal(work.Tt, tab0.Tt)      # the pass changed the copy

    runs = [bench.run_capped(work, tab0, costs0, options, cap)
            for _ in range(2)]
    assert not torch.equal(work.Tt, tab0.Tt)      # updated in place
    tab1, costs1, work1 = fresh()
    runs.append(bench.run_capped(work1, tab1, costs1, options, cap))
    first = runs[0]
    assert first.iterations == cap
    for r in runs[1:]:
        assert (r.iterations, r.z) == (first.iterations, first.z)
        assert torch.equal(r.base, first.base)

    out, _, it = run_solve_loop(work, options, cap, costs0)
    assert (it, float(out.z).hex()) != (first.iterations, first.z)


def test_pivot_work_hand_count():
    """``pivot_work`` at M=4, R=8, L=2, t=1 against a count by hand."""
    M, R, L, t = 4, 8, 2, 1
    got = bench.pivot_work(M, R, L, t, True, 4)
    # K1: Tt[:, h] 16, F[:1] 16, C[:1, h] 4, b (f64) 32, a_h out 16 bytes;
    # 2tM = 8 f32 ops, M = 4 f64 quotients.
    assert got["ah_ratio"] == (84.0, 8.0, 4.0)
    # K2: Tt[k] 32, C[:1] 32, F[:1, k] 4, C[t] out 32, costs r+w 128,
    # devex w r+w 64, a_h 16, b r+w 64, base r+w 32, F[t] out 16 bytes;
    # 2tR + 4R = 48 f32 ops; 4R + 3M = 44 f64 ops.
    assert got["colk_costs"] == (420.0, 48.0, 44.0)
    # K3: Tt r+w 256, F and C 96, coeffs 32 and mv 64 bytes; 2LMR = 128
    # f32 ops, 2MR = 64 f64. K4: the apply alone.
    assert got["apply_reprice"] == (448.0, 128.0, 64.0)
    assert got["apply_window"] == (352.0, 128.0, 0.0)
    dantzig = bench.pivot_work(M, R, L, t, False, 4)
    assert dantzig["colk_costs"] == (420.0 - 64, 48.0 - 32, 44.0)
    # An f64 tableau: eight bytes a tableau element, its ops in f64.
    f64 = bench.pivot_work(M, R, L, t, False, 8)
    assert f64["apply_window"] == (2 * 352.0, 0.0, 128.0)
    assert f64["ah_ratio"] == (84.0 + 16 + 16 + 4 + 16, 0.0, 8.0 + 4.0)
    for L1 in (0, 1):
        for itemsize in (4, 8):
            seq = bench.pivot_work(M, R, L1, t, False, itemsize)
            assert list(seq) == ["pivot_update"]
            assert seq["pivot_update"][0] == 2 * R * M * itemsize
            opts = SolverOptions(dtype=np.dtype(f"float{8 * itemsize}"),
                                 block_pivots=L1 or None)
            assert bench.floor_seconds(M, R, opts, 1e9) == pytest.approx(
                2 * R * M * itemsize / 1e9)


def test_north_star_floor_counts_the_operations():
    """At M = 10,112, R = 120,064, L = 128 (the production options) and
    HBM's 3.35 TB/s: K1 ~0.8 us and K2 ~10.5 us at t = 64, bounded by
    bytes; the window apply bounded by its 2LMR operations (4.6 ms, where
    its bytes take 2.9), ~36.5 us a pivot; ~48 us in all, above bench.py's
    bytes-only figure (~37 us), whose window share is the sweep's bytes
    alone (~11 us)."""
    M, R, bps = 10_112, 120_064, 3.35e12
    opts = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                         block_pivots=128)
    work = bench.pivot_work(M, R, 128, 64, True, 4)
    secs = {k: bench.kernel_seconds(w, bps) for k, w in work.items()}
    assert secs["ah_ratio"] == pytest.approx(0.82e-6, rel=0.01)
    assert secs["colk_costs"] == pytest.approx(10.5e-6, rel=0.01)
    k4_bytes, k4_f32, _ = work["apply_window"]
    assert k4_f32 / bench.F32_FLOPS > k4_bytes / bps
    assert secs["apply_window"] == pytest.approx(4.64e-3, rel=0.01)
    floor = bench.floor_seconds(M, R, opts, bps)
    assert floor == pytest.approx(
        secs["ah_ratio"] + secs["colk_costs"]
        + (secs["apply_reprice"] + secs["apply_window"]) / 2 / 128)
    assert 47e-6 < floor < 49e-6
    assert bench.bytes_only_floor_seconds(M, R, 128, 4, bps) < floor


def test_amortised_fallback(capsys):
    """Both caps ending at the same pivot count (the solve finished before
    the lower cap) report the amortised average at the higher cap."""
    assert bench.marginal_seconds({8: (0.10, 30), 16: (0.12, 30)}) == (
        pytest.approx(0.12 / 30))
    assert bench.marginal_seconds({8: (0.10, 8), 16: (0.09, 16)}) == (
        pytest.approx(0.09 / 16))
    assert bench.marginal_seconds({8: (0.10, 8), 16: (0.30, 16)}) == (
        pytest.approx(0.20 / 8))
    rec, err = _one_line(capsys, bench.main,
                         ["--vars", "40", "--constraints", "10", "--iters",
                          "512", "--repeats", "1", "--device", "cpu"])
    assert set(rec) == KEYS and rec["value"] > 0
    assert "marginal estimate unavailable" in err


def test_bench_batch_ok(capsys):
    rc = bench_batch.main(["--batch", "4", "--vars", "60", "--constraints",
                           "20", "--repeats", "1", "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0
    assert out.out.splitlines()[-1] == "BENCH_BATCH_OK"
    assert out.err.count("4/4 OPTIMAL") == len(bench_batch.CONFIGS)
    assert out.err.count("refine_s") == len(bench_batch.CONFIGS)


def test_bench_sharded_line_across_ranks(capsys):
    """One and two gloo ranks: the JAX script's line, and the same pivot
    counts at both caps whatever the rank count."""
    recs = {}
    for ranks in (1, 2):
        recs[ranks], _ = _one_line(
            capsys, bench_sharded.main,
            ["--vars", "300", "--constraints", "80", "--lo", "16", "--hi",
             "48", "--repeats", "1", "--devices", str(ranks), "--device",
             "cpu"])
        assert set(recs[ranks]) == {f"sharded_ms_per_pivot_mesh{ranks}",
                                    "lo", "hi"}
    for ranks, rec in recs.items():
        assert isinstance(rec[f"sharded_ms_per_pivot_mesh{ranks}"], float)
        assert rec["lo"][1] == 16 and rec["hi"][1] == 48
        assert rec["lo"][0] > 0 and rec["hi"][0] > 0
