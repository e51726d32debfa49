"""The reference fingerprints through the port: the port's oracle
(``simplex_tpu_torch.solve_oracle``) replays the reference CUDA program's
recorded per-phase pivot counts (``data/reference_measures/``) on the
bit-exact regenerated instances, with the reference GPU's eps-tie order
(``tie_rule="cuda"``), as tests/test_parity.py holds the JAX package's
oracle; the fma-faithful update (the port's own native helper, built into
``simplex_tpu_torch/_build/``) gives the same counts; and the port's
``solve`` on random_256_256 reaches the oracle's objective within 1e-9.
The sizes tests/test_parity.py marks slow are marked slow here too, and
the 4096 and 8192 replays run only when asked, as there."""

import os
import pathlib

import pytest

import simplex_tpu_torch as pst
from simplex_tpu_torch.utils import fma_native

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def reference_counts(n: int, m: int) -> tuple[int, int]:
    """Per-phase pivot counts from the vendored reference CSV (rows minus
    the exit-check iteration), as tests/test_parity.py reads them."""
    path = DATA / "reference_measures" / f"benchmark_{n}_{m}.txt"
    lines = path.read_text().splitlines()
    p1 = sum(1 for l in lines if l.startswith(f"{n + 2 * m + 1},{m},solve,"))
    p2 = sum(1 for l in lines if l.startswith(f"{n + m + 1},{m},solve,"))
    return p1 - 1, p2 - 1


def _problem(name):
    n, m, seed, lo, hi = pst.read_seed_file(
        DATA / "examples" / "benchmark_problems" / f"{name}.txt")
    return (n, m), pst.generate_random_problem(n, m, seed, lo, hi)


def _assert_parity(name, update_rule="blas"):
    (n, m), problem = _problem(name)
    result = pst.solve_oracle(problem,
                              pst.SolverOptions(bland_threshold=None),
                              tie_rule="cuda", update_rule=update_rule)
    assert result.status == pst.Status.OPTIMAL
    assert (result.iterations_phase1,
            result.iterations_phase2) == reference_counts(n, m)


@pytest.mark.parametrize("name", ["random_256_256", "random_512_256",
                                  "random_512_512", "random_2048_256"])
def test_pivot_count_parity(name):
    _assert_parity(name)


@pytest.mark.slow
def test_pivot_count_parity_1024_1024():
    _assert_parity("random_1024_1024")


@pytest.mark.slow
def test_pivot_count_parity_2048_2048():
    _assert_parity("random_2048_2048")


def test_solve_same_instance_close():
    """The port's f64 ``solve`` (lowest-index ties) on the bit-exact
    random_256_256 reaches the oracle's optimum within 1e-9 relative."""
    _, problem = _problem("random_256_256")
    want = pst.solve_oracle(problem, pst.SolverOptions(bland_threshold=None),
                            tie_rule="cuda")
    got = pst.solve(problem, device="cpu")
    assert got.status == pst.Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


class TestFmaHelper:
    """The port's copy of the fma-faithful update
    (``simplex_tpu_torch/native/fma_update.cpp``)."""

    def test_builds_into_the_port(self):
        # g++ is part of the supported toolchain: the helper must build.
        assert fma_native.available()
        built = list((pathlib.Path(pst.__file__).parent / "_build")
                     .glob("libfma_*.so"))
        assert built

    def test_fma_scalar_is_single_rounding(self):
        # (1 + 2^-30)^2 = 1 + 2^-29 + 2^-60: fma keeps the 2^-60 term
        # that mul-then-add rounds away.
        a = 1.0 + 2.0 ** -30
        assert fma_native.fma_scalar(a, a, -1.0) == 2.0 ** -29 + 2.0 ** -60
        assert (a * a - 1.0) == 2.0 ** -29

    def test_parity_small_sizes_fma(self):
        for name in ("random_256_256", "random_512_512"):
            _assert_parity(name, update_rule="fma")


def test_pivot_count_parity_4096_4096_fma():
    if not os.environ.get("PARITY_4096"):
        pytest.skip("~6 min replay; run with PARITY_4096=1")
    _assert_parity("random_4096_4096", update_rule="fma")


def test_pivot_count_parity_8192_8192_fma():
    if not os.environ.get("PARITY_8192"):
        pytest.skip("~57 min replay; run with PARITY_8192=1")
    _assert_parity("random_8192_8192", update_rule="fma")
