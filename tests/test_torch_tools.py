"""The port's measurement tools against the JAX package's, on the CPU:
``simplex_tpu_torch.sweep_table`` (byte for byte as ``tools/
sweep_table.py``), ``simplex_tpu_torch.validate_refine_sweep`` (rows held
to ``tools/validate_refine_sweep.py``'s and to the certified record
``data/measures/refine_sweep_r5.json``) and ``simplex_tpu_torch.
measure_refine_flagship`` (its lines, and its instance, refinement and
warm-finish branch held to the JAX package's functions).

The JAX tools run in this process, loaded from ``tools/`` with
``sys.argv`` set; on the CPU the JAX package's mixed solve takes its
plain blocked loop. Rules: mixed walks equal in status, their pivots
(both phases) within max(3, 10%) (near-ties part them across
implementations, as tests/test_torch_loop.py states); refined and finished objectives within
1e-9 relative; the 1e-9 certificates passing on both sides.
"""

import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from simplex_tpu.config import SolverOptions as JaxOptions
from simplex_tpu.finish import finish_from_basis as jax_finish
from simplex_tpu.problem import Problem as JaxProblem
from simplex_tpu.refine import certificates_pass as jax_certificates_pass
from simplex_tpu.refine import refine_solution_tableau as jax_refine
from simplex_tpu.two_phase import solve_device_with_binv as jax_solve_binv
from simplex_tpu_torch import (cli, finish, measure_refine_flagship,
                               sweep_table, validate_refine_sweep)
from simplex_tpu_torch.config import SolverOptions, Status
from simplex_tpu_torch.refine import refine_solution_tableau
from simplex_tpu_torch.two_phase import solve_device_with_binv

from conftest import DATA

ROOT = DATA.parents[1]
MEASURES = ROOT / "data" / "measures"
R5 = MEASURES / "refine_sweep_r5.json"
#: Two sizes of the -t grid: the JAX tool takes ~3 s at 256x256 here.
SWEEP = ["--limit", "512", "--sizes", "256x256,512x256"]
#: The JAX row's keys (tools/validate_refine_sweep.py:73-103).
ROW_KEYS = {"vars", "constraints", "seed", "status", "pivots", "objective",
            "wall_s", "certified", "certified_1e9", "fallback",
            "primal_residual", "dual_infeasibility", "artificial_mass",
            "objective_shift", "refine_wall_s", "refine_method"}
SUMMARY_KEYS = {"sizes", "optimal", "certified_1e9", "fallbacks", "wall_s",
                "pivot_rule", "block"}
FLAGSHIP = ["--vars", "1024", "--constraints", "256", "--device", "cpu"]
MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=128)


def _jax_tool(name):
    """``tools/<name>.py`` as a module (not on any import path)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv, monkeypatch, capsys):
    """Run the JAX tool's ``main()`` with ``sys.argv`` set; returns (rc,
    stdout, stderr)."""
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    rc = _jax_tool(name).main()
    out = capsys.readouterr()
    return rc, out.out, out.err


def _run_port(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


# ---------------------------------------------------------------- table

def _table_case(case, tmp_path):
    """(--ours directory, --label) of each case."""
    if case == "cli-csvs":
        rc = cli.main(["-t", "--limit", "256", "--timer", "--device", "cpu",
                       "--data-dir", str(tmp_path)])
        assert rc == 0
        return tmp_path / "measures", "port f64"
    if case == "empty":
        return tmp_path, ""
    return MEASURES / case, case


@pytest.mark.parametrize("case", ["v5e_f64", "v5e_mixed_devex_r5",
                                  "cli-csvs", "empty"])
def test_sweep_table_byte_for_byte(case, tmp_path, monkeypatch, capsys):
    """The same markdown table on stdout and the same ``N sizes`` line on
    stderr as ``tools/sweep_table.py``, on the archived 36-size sweeps,
    on CSVs the port's CLI writes and on an empty directory."""
    ours, label = _table_case(case, tmp_path)
    capsys.readouterr()
    argv = ["--ours", str(ours), "--ref", str(ROOT / "data"
                                              / "reference_measures"),
            "--label", label]
    want = _run_jax_tool("sweep_table", argv, monkeypatch, capsys)
    got = _run_port(sweep_table.main, argv, capsys)
    assert got == want
    rows = {"v5e_f64": 36, "v5e_mixed_devex_r5": 36, "cli-csvs": 1,
            "empty": 0}[case]
    assert got[2] == f"\n{rows} sizes\n"
    assert got[1].count("\n") == rows + 2
    if rows:
        # Every archived size has its reference row.
        assert "| — |" not in got[1]


def test_sweep_table_reads_the_cli_pivots(tmp_path, capsys):
    """On the CLI's CSVs the table's pivot counts are the ones the CLI
    printed for the size."""
    rc = cli.main(["-t", "--limit", "256", "--timer", "--device", "cpu",
                   "--data-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert rc == 0
    p1, p2 = printed.split("pivots=")[1].split()[0].split("+")
    (row,) = sweep_table.table_rows(tmp_path / "measures",
                                    ROOT / "data" / "reference_measures")
    assert row[:2] == (256, 256)
    assert row[2][:2] == (int(p1), int(p2))
    assert row[3] is not None and row[3][:2] == (460, 26)


# ---------------------------------------------------------------- sweep

@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Both tools' JSON at ``SWEEP`` (run once for the module)."""
    tmp = tmp_path_factory.mktemp("sweeps")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["tools/validate_refine_sweep.py", *SWEEP,
                                 "--out", str(tmp / "jax.json")])
        assert _jax_tool("validate_refine_sweep").main() == 0
    finally:
        mp.undo()
    assert validate_refine_sweep.main([*SWEEP, "--device", "cpu", "--out",
                                       str(tmp / "port.json")]) == 0
    return (json.loads((tmp / "port.json").read_text()),
            json.loads((tmp / "jax.json").read_text()))


def test_sweep_rows_match_the_jax_tool(sweeps):
    port, jax_ = sweeps
    assert [(r["vars"], r["constraints"], r["seed"]) for r in port["rows"]] \
        == [(r["vars"], r["constraints"], r["seed"]) for r in jax_["rows"]] \
        == [(256, 256, 25856), (512, 256, 51456)]
    for got, want in zip(port["rows"], jax_["rows"]):
        assert set(got) == set(want) == ROW_KEYS
        assert got["status"] == want["status"] == "OPTIMAL"
        assert _rel(got["objective"], want["objective"]) <= 1e-9
        assert got["certified_1e9"] and want["certified_1e9"]
        assert got["certified"] and not got["fallback"]
        # The walk's length, as tests/test_torch_bench.py holds it: a
        # near-tie may move a pivot across the phase boundary.
        g, w = sum(got["pivots"]), sum(want["pivots"])
        assert abs(g - w) <= max(3, w // 10), (got["pivots"], want["pivots"])


def test_sweep_rows_match_the_certified_record(sweeps):
    """Each row's objective within 1e-9 of ``refine_sweep_r5.json``'s row
    of the same seed."""
    record = {r["seed"]: r for r in json.loads(R5.read_text())["rows"]}
    for row in sweeps[0]["rows"]:
        want = record[row["seed"]]
        assert (want["vars"], want["constraints"]) == (row["vars"],
                                                       row["constraints"])
        assert _rel(row["objective"], want["objective"]) <= 1e-9


def test_sweep_summary_keys(sweeps):
    port, jax_ = sweeps
    assert set(jax_["summary"]) == SUMMARY_KEYS
    assert set(port["summary"]) == SUMMARY_KEYS | {"device"}
    assert port["summary"]["device"] == "cpu"
    for k in ("sizes", "optimal", "certified_1e9", "fallbacks",
              "pivot_rule", "block"):
        assert port["summary"][k] == jax_["summary"][k], k
    assert port["summary"]["sizes"] == port["summary"]["certified_1e9"] == 2


def test_sweep_default_out_is_the_ports_own():
    """The default ``--out`` never names the JAX package's record, which
    chip_smoke.py reads its goldens from."""
    out = validate_refine_sweep._parser().parse_args([]).out
    assert out == validate_refine_sweep.DEFAULT_OUT
    assert pathlib.Path(out).name != R5.name
    assert pathlib.Path(out).parent == pathlib.Path("data/measures")


def test_sweep_rewrites_after_every_size(tmp_path, monkeypatch, capsys):
    """The file holds the rows so far after each size (the summary only
    at the end), and the per-size line goes to stderr."""
    seen = []
    real = validate_refine_sweep.solve
    out = tmp_path / "s.json"

    def spy(*a, **kw):
        seen.append(json.loads(out.read_text()) if out.exists() else None)
        return real(*a, **kw)

    monkeypatch.setattr(validate_refine_sweep, "solve", spy)
    rc, stdout, err = _run_port(
        validate_refine_sweep.main,
        [*SWEEP, "--device", "cpu", "--out", str(out)], capsys)
    assert rc == 0 and stdout == ""
    assert seen[0] is None and list(seen[1]) == ["rows"]
    assert len(seen[1]["rows"]) == 1
    assert err.splitlines()[0].startswith("device=cpu (cpu) rule=devex")
    assert "  256x  256: OPTIMAL   pivots=" in err
    assert "cert1e9=True" in err and "wrote " in err


# ------------------------------------------------------------- flagship

def test_flagship_lines(capsys):
    rc, out, err = _run_port(measure_refine_flagship.main, FLAGSHIP, capsys)
    assert rc == 0
    lines = err.splitlines()
    for label in ("device: cpu", "on-device instance 256 x 1024 built",
                  "mixed solve: status=0 pivots=", "refine(tableau): cold=",
                  "certificates: pass@1e-6=True pass@1e-9=True",
                  "objective: raw="):
        assert any(l.startswith(label) for l in lines), label
    assert not any(l.startswith("warm finish") for l in lines)
    last = out.splitlines()[-1].split()
    assert last[0] == "REFINE_FLAGSHIP_OK" and float(last[1]) >= 0


@pytest.fixture(scope="module")
def flagship_instance():
    A, b, c = measure_refine_flagship.flagship_instance(1024, 256, "cpu")
    return A.numpy(), b.double().numpy(), c.double().numpy()


def test_flagship_instance_draw():
    """f32 in [1, 100), A then b then c from one generator seeded
    n*100 + m; A and b as ``bench.bench_problem`` draws them."""
    import torch

    from simplex_tpu_torch.bench import bench_problem

    A, b, c = measure_refine_flagship.flagship_instance(300, 80, "cpu")
    A0, b0 = bench_problem(300, 80, "cpu")
    assert A.shape == (80, 300) and b.shape == (80,) and c.shape == (300,)
    assert A.dtype == b.dtype == c.dtype == torch.float32
    assert bool((A == A0).all()) and bool((b == b0).all())
    for t in (A, b, c):
        assert float(t.min()) >= 1.0 and float(t.max()) < 100.0


def test_flagship_refinement_matches_jax(flagship_instance):
    """The port's instance through the port's and the JAX package's
    ``solve_device_with_binv`` + ``refine_solution_tableau``: same status,
    refined objectives within 1e-9, the 1e-9 certificates on both.

    The port's refinement casts A to f64 (simplex_tpu_torch/refine.py:
    138-141); the JAX one keeps an f32 A and rounds the iterate to f32 in
    A's products (ADVICE.md on simplex_tpu/refine.py:202), which stops its
    residual near f32 round-off. So the JAX refinement is handed the same
    values in f64, and the f32 call is shown to stop above the 1e-9
    bound the port meets."""
    import torch

    A, b, c = flagship_instance
    m, n = A.shape
    out, binv = solve_device_with_binv(torch.from_numpy(A),
                                       torch.from_numpy(b),
                                       torch.from_numpy(c), n, m,
                                       SolverOptions(**MIXED))
    ro = refine_solution_tableau(torch.from_numpy(A), torch.from_numpy(b),
                                 torch.from_numpy(c), out.base, binv, n=n,
                                 m=m)
    jout, jbinv = jax_solve_binv(jnp.asarray(A), jnp.asarray(b),
                                 jnp.asarray(c), n, m, JaxOptions(**MIXED))
    jro = jax_refine(jnp.asarray(A, jnp.float64), jnp.asarray(b),
                     jnp.asarray(c), jout.base, jbinv, n=n, m=m)
    assert out.status == Status.OPTIMAL and int(jout.status) == int(
        Status.OPTIMAL)
    assert _rel(float(ro.objective), float(jro.objective)) <= 1e-9
    assert measure_refine_flagship.strong_certified(ro, b, c)
    assert jax_certificates_pass(jro, b, c, 1e-9)
    jro32 = jax_refine(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                       jout.base, jbinv, n=n, m=m)
    bound = 1e-9 * (1.0 + float(np.max(np.abs(b))))
    assert float(jro32.primal_residual) > bound >= float(ro.primal_residual)


def test_flagship_warm_finish_matches_jax(flagship_instance, monkeypatch,
                                          capsys):
    """With the certificates made to fail, the tool measures the warm
    finish: the port's ``finish_from_basis`` on the drifted basis against
    the JAX package's on the same problem and basis, same status and
    objective within 1e-9."""
    calls = []
    real = finish.finish_from_basis

    def spy(problem, base, options, *a, **kw):
        res = real(problem, base, options, *a, **kw)
        calls.append((problem, np.asarray(base), res))
        return res

    monkeypatch.setattr(measure_refine_flagship, "certificates_pass",
                        lambda *a, **kw: False)
    monkeypatch.setattr(finish, "finish_from_basis", spy)
    rc, out, err = _run_port(measure_refine_flagship.main, FLAGSHIP, capsys)
    assert rc == 0 and out.splitlines()[-1].startswith("REFINE_FLAGSHIP_OK")
    assert "certificates: pass@1e-6=False" in err
    (problem, base, res), = calls
    A, b, c = flagship_instance
    assert np.array_equal(problem.A, A.astype(np.float64))
    assert np.array_equal(problem.b, b) and np.array_equal(problem.c, c)
    want = jax_finish(JaxProblem(A=A, b=b, c=c), base, JaxOptions(**MIXED))
    assert res is not None and want is not None
    assert res.status == want.status == Status.OPTIMAL
    assert _rel(res.objective, want.objective) <= 1e-9
    line, = [l for l in err.splitlines() if l.startswith("warm finish:")]
    assert f"objective {res.objective:.9f}" in line
