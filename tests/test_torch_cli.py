"""The port's CLI (``python -m simplex_tpu_torch.cli``) on the CPU: the
flag contract of tests/test_cli.py through the port, its stdout and CSVs
against the JAX package's CLI on the same arguments, and the flags it
does not port yet (``--checkpoint``)."""

import glob

import pytest

from simplex_tpu.cli import main as jax_main
from simplex_tpu_torch.cli import main

from conftest import DATA

SEED_256 = str(DATA / "benchmark_problems" / "random_256_256.txt")


def run_cli(args, tmp_path):
    return main(args + ["--data-dir", str(tmp_path), "--device", "cpu"])


def test_solve_file(tmp_path, capsys):
    assert run_cli(["-f", str(DATA / "smallProblem.txt")], tmp_path) == 0
    out = capsys.readouterr().out
    assert "Problem solved!" in out
    sol = (tmp_path / "solution.txt").read_text().splitlines()
    assert sol[:3] == ["8.000000", "0.000000", "0.000000"]
    assert sol[-1] == "Optimal value: 64.000000"


def test_infeasible_file(tmp_path, capsys):
    assert run_cli(["-f", str(DATA / "infeasibleProblem.txt")],
                   tmp_path) == 0
    assert "Problem INFEASIBLE!" in capsys.readouterr().out
    assert not (tmp_path / "solution.txt").exists()


def test_random_with_seed(tmp_path, capsys):
    assert run_cli(["-r", "30", "12", "99"], tmp_path) == 0
    assert "seed: 99" in capsys.readouterr().out


def test_random_save_seed_file(tmp_path):
    assert run_cli(["-rs", "20", "10", "7"], tmp_path) == 0
    saved = list((tmp_path / "examples").glob("random_*.txt"))
    assert len(saved) == 1
    assert saved[0].read_text().split() == ["20", "10", "7", "-100", "100"]


def _lines(out, tmp_path):
    return [line.replace(str(tmp_path), "<dir>")
            for line in out.splitlines()]


@pytest.mark.parametrize("args", [
    ["-f", str(DATA / "smallProblem.txt")],
    ["-f", str(DATA / "unboundedProblem.txt")],
    ["-rf", SEED_256],
], ids=["small", "unbounded", "random_256_256"])
def test_stdout_and_solution_match_jax(tmp_path, capsys, args):
    """The same stdout lines and solution.txt as the JAX CLI (f64, the
    same walk: 473 + 17 pivots and 5.535474 at random_256_256)."""
    outs = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        d = tmp_path / name
        assert fn(args + ["--data-dir", str(d)] + extra) == 0
        sol = d / "solution.txt"
        outs[name] = (_lines(capsys.readouterr().out, d),
                      sol.read_text() if sol.exists() else None)
    assert outs["port"] == outs["jax"]


def test_timer_csv_matches_jax(tmp_path):
    """Aggregate timing: the reference's schema and the same rows (vars,
    constraints, operation; the pivot counts) as the JAX CLI's CSV."""
    rows = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        d = tmp_path / name
        assert fn(["-r", "30", "12", "5", "--timer", "--data-dir", str(d)]
                  + extra) == 0
        (csv,) = glob.glob(str(d / "measures" / "times_*.txt"))
        lines = open(csv).read().splitlines()
        assert lines[0] == "vars,contraints,operation,elapsed_time"
        rows[name] = [line.split(",") for line in lines[1:]]
    key = [(r[0], r[1], r[2], r[3] if r[2] == "solveIterations" else "")
           for r in rows["port"]]
    assert key == [(r[0], r[1], r[2], r[3] if r[2] == "solveIterations"
                    else "") for r in rows["jax"]]
    assert key[0][2] == "fillTableau" and key[1][2] == "gauss1"


def test_per_iteration_rows(tmp_path):
    """--per-iteration: each phase has pivots + 1 solve rows."""
    assert run_cli(["-rf", SEED_256, "--timer", "--per-iteration"],
                   tmp_path) == 0
    (csv,) = glob.glob(str(tmp_path / "measures" / "times_*.txt"))
    rows = [line.split(",") for line in open(csv).read().splitlines()[1:]]
    solve = [r[0] for r in rows if r[2] == "solve"]
    assert (solve.count("769"), solve.count("513")) == (474, 18)


def test_benchmark_sweep_small(tmp_path, capsys):
    assert main(["-t", "--limit", "256", "--timer", "--device", "cpu",
                 "--data-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "status=OPTIMAL objective=5.535474 pivots=473+17" in out
    csv = (tmp_path / "measures" / "benchmark_256_256.txt").read_text()
    its = [line.split(",")[3] for line in csv.splitlines()
           if ",solveIterations," in line]
    assert its == ["473.000000", "17.000000"]
    assert csv.splitlines()[-1].split(",")[2] == "solution"
    # --resume-sweep skips the finished size.
    assert main(["-t", "--limit", "256", "--timer", "--resume-sweep",
                 "--device", "cpu", "--data-dir", str(tmp_path)]) == 0
    assert "already measured" in capsys.readouterr().out


def test_batch_mode(tmp_path, capsys):
    """--batch through solve_batch (f32 blocked options); -r draws from
    [-100, 100], so lanes may be unbounded or infeasible."""
    assert run_cli(["-r", "24", "10", "5", "--batch", "4", "--dtype",
                    "float32", "--block", "8"], tmp_path) == 0
    out = capsys.readouterr().out
    assert "Solving 4 instances" in out
    assert "seed 5:" in out and "seed 8:" in out


def test_batch_mode_f64_names_the_fallback(tmp_path, capsys):
    """--batch with the default dtype (f64, sequential: the batched
    fallback; it exited naming its ROADMAP item until that landed)
    prints the JAX CLI's lines, wall times aside and with "batched" where
    the JAX CLI says "vmapped", with the same f64 walks; -r draws from
    [-100, 100], so lanes may be unbounded or infeasible, and a seed file
    of [1, 100] instances makes them all OPTIMAL."""
    from simplex_tpu_torch.problem import write_seed_file

    seeds = tmp_path / "seeds.txt"
    write_seed_file(str(seeds), 24, 10, 5, 1, 100)
    for args in (["-r", "24", "10", "5"], ["-rf", str(seeds)]):
        outs = {}
        for name, fn, extra in (("port", main, ["--device", "cpu"]),
                                ("jax", jax_main, [])):
            d = tmp_path / name
            assert fn(args + ["--batch", "4", "--data-dir", str(d)]
                      + extra) == 0
            lines, walks = _timeless(_lines(capsys.readouterr().out, d))
            outs[name] = ([line.replace(") batched...", ") vmapped...")
                           for line in lines], walks)
        assert outs["port"] == outs["jax"]
        assert any(line.startswith("seed 8:") for line in outs["port"][0])
    assert all(" OPTIMAL " in line for line in outs["port"][0][3:7])


def test_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert run_cli(["-f", str(DATA / "smallProblem.txt"), "--profile",
                    str(prof)], tmp_path) == 0
    assert (prof / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags,match", [
    (["--sharded", "2", "--checkpoint", "state.npz"],
     "ROADMAP queue 1 item 9"),
    (["--fleet", "2"], "--fleet requires --batch"),
    (["--checkpoint", "state.npz"], "ROADMAP queue 1 item 9"),
    (["--equilibrate"], None),
], ids=["sharded", "fleet", "checkpoint", "equilibrate"])
def test_unported_flags_exit(tmp_path, capsys, flags, match):
    """What the port does not run yet exits naming its ROADMAP item:
    ``--checkpoint``, with ``--sharded`` too; ``--fleet`` without
    ``--batch`` exits as the JAX CLI does. ``--equilibrate`` (it exited
    naming its ROADMAP item until ``scaling.py`` landed) exits 0
    with the JAX CLI's stdout lines and solution.txt."""
    args = ["-r", "10", "5", "1"] + flags
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            run_cli(args, tmp_path)
        return
    outs = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        d = tmp_path / name
        assert fn(args + ["--data-dir", str(d)] + extra) == 0
        sol = d / "solution.txt"
        outs[name] = (_lines(capsys.readouterr().out, d),
                      sol.read_text() if sol.exists() else None)
    assert outs["port"] == outs["jax"]


def _timeless(lines):
    """The lines without the wall times, which differ run to run, and
    the per-seed pivot counts split off (returned apart)."""
    kept, pivots = [], []
    for line in lines:
        if line.startswith(("Sharded solve finished in", "Batch solved in")):
            continue
        if line.startswith("seed ") and " pivots=" in line:
            line, walk = line.split(" pivots=")
            pivots.append([int(v) for v in walk.split("+")])
        kept.append(line)
    return kept, pivots


@pytest.mark.parametrize("args", [
    ["-rf", SEED_256, "--sharded", "2"],
    ["-rf", "<seeds>", "--batch", "4", "--fleet", "2", "--dtype",
     "float32", "--block", "8", "--eps", "1e-5"],
], ids=["sharded", "fleet"])
def test_sharded_and_fleet_match_jax(tmp_path, capsys, args):
    """``--sharded 2`` (two gloo ranks, f64; 473 + 17 pivots at
    random_256_256, as one device walks) and ``--fleet 2 --batch 4``
    (mixed): the JAX CLI's stdout lines, its wall times aside, and
    solution.txt; the fleet's mixed walks within max(3, 10%) of the JAX
    ones (ROADMAP: mixed walks are not pinned across implementations)."""
    from simplex_tpu_torch.problem import write_seed_file

    seeds = tmp_path / "seeds.txt"          # 30 x 12 in [1, 100]: OPTIMAL
    write_seed_file(str(seeds), 30, 12, 5, 1, 100)
    args = [str(seeds) if a == "<seeds>" else a for a in args]
    outs = {}
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        d = tmp_path / name
        assert fn(args + ["--data-dir", str(d)] + extra) == 0
        sol = d / "solution.txt"
        lines, walks = _timeless(_lines(capsys.readouterr().out, d))
        outs[name] = (lines, sol.read_text() if sol.exists() else None,
                      walks)
    assert outs["port"][:2] == outs["jax"][:2]
    assert any(line.startswith(("(phase-1", "seed 8:"))
               for line in outs["port"][0])
    assert len(outs["port"][2]) == len(outs["jax"][2])
    for got, want in zip(outs["port"][2], outs["jax"][2]):
        for a, b in zip(got, want):
            assert abs(a - b) <= max(3, 0.1 * b), (got, want)
