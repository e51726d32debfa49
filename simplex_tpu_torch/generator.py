"""Seeded random problem generator (host side), as in
``simplex_tpu.generator``.

Equivalent of the reference's cuRAND generator component (reference:
include/generator.cuh, src/generator.cu:9-32, src/problem.cu:49-126).

The reference derives three sub-seeds from the user seed via C
``srand``/``rand`` (problem.cu:63-67) and then runs counter-based cuRAND
streams: one independent stream per matrix column (generator.cu:15) and per
vector element (generator.cu:29), uniform in ``(min, max]``.

The default stream is **bit-exact cuRAND XORWOW** (native/xorwow.cpp,
the port's copy of the JAX package's, built and loaded by
utils/curand.py): because the
reference's per-thread offsets tile contiguously, its whole
matrix/vector is one plain XORWOW sequence, so the
seed-file instances regenerate identically off-GPU. Validated by exact
per-phase pivot-count parity against the reference's measure CSVs on its
regenerated benchmark instances (tests/test_parity.py). A NumPy-Philox
stream remains available for compiler-less environments.

``generate_random_problem_device`` draws the instance on the device
instead, from ``torch.Generator`` streams with the same sub-seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from .problem import Problem
from .utils.crand import derive_subseeds

#: Default generation range of the reference CLI (main.cu:7-8).
DEFAULT_MIN, DEFAULT_MAX = -100.0, 100.0


def _philox_uniform(seed: int, count: int, lo: float, hi: float) -> np.ndarray:
    bits = np.random.Generator(np.random.Philox(key=seed)).random(
        count, dtype=np.float64)
    return bits * (hi - lo) + lo


def generate_random_problem(
    n_vars: int,
    n_constraints: int,
    seed: int,
    lo: float = DEFAULT_MIN,
    hi: float = DEFAULT_MAX,
    rand_flavor: str = "msvc",
    stream: str = "curand",
) -> Problem:
    """Generate a random dense LP, reproducible from
    ``(n, m, seed, lo, hi)`` (reference generateRandomProblem,
    problem.cu:49-126).

    Sub-seed fan-out matches problem.cu:63-67: ``srand(seed)`` then three
    ``rand()`` draws — seedOne -> b, seedTwo -> c, seedThree -> A
    (``rand_flavor``: 'msvc' — the default — reproduces the shipped
    benchmark artifacts, which were generated by the reference's Windows
    batch builds (compile.bat/benchmark.bat; validated by exact
    pivot-count parity against its measure CSVs, tests/test_parity.py);
    'glibc' matches a compile.sh Linux build).

    ``stream`` selects the uniform generator:

    * 'curand' (default): **bit-exact cuRAND XORWOW** via the native
      library (utils/curand.py) — regenerates the
      reference's seed-file instances identically. Draw order follows
      generator.cu:9-21: one logical stream per constraint column with
      contiguous offsets, i.e. ``A[c, v] = seq[c * n_vars + v]``.
    * 'philox': platform-independent NumPy Philox (no native code; a
      different but equally reproducible instance distribution).
    """
    if n_vars <= 0 or n_constraints <= 0:
        raise ValueError("n_vars and n_constraints must be positive")
    seed_b, seed_c, seed_a = derive_subseeds(seed, rand_flavor)
    if stream == "curand":
        from .utils.curand import xorwow_uniform

        b = xorwow_uniform(seed_b, n_constraints, lo, hi)
        c = xorwow_uniform(seed_c, n_vars, lo, hi)
        A = xorwow_uniform(seed_a, n_vars * n_constraints, lo, hi).reshape(
            n_constraints, n_vars)
        return Problem(A=A, b=b, c=c)
    if stream != "philox":
        raise ValueError(f"unknown stream {stream!r}")
    b = _philox_uniform(seed_b, n_constraints, lo, hi)
    c = _philox_uniform(seed_c, n_vars, lo, hi)
    a_cols = _philox_uniform(seed_a, n_vars * n_constraints, lo, hi)
    # Variable-major draw order -> (n, m), transposed to (m, n) storage.
    A = a_cols.reshape(n_vars, n_constraints).T
    return Problem(A=A, b=b, c=c)


def benchmark_seed(n_vars: int, n_constraints: int) -> int:
    """The reference benchmark sweep's seed formula (main.cu:63):
    ``vars*100 + constraints``, +1 for the special-cased 1024x8192 pair."""
    return n_vars * 100 + n_constraints + (
        1 if (n_vars == 1024 and n_constraints == 8192) else 0)


def benchmark_sizes(limit: int = 8192) -> list[tuple[int, int]]:
    """The (vars, constraints) pairs of the reference's ``-t`` sweep
    (main.cu:59-73): powers of two 256..limit in both dimensions,
    constraint-major order."""
    sizes = []
    constraints = 256
    while constraints <= limit:
        n_vars = 256
        while n_vars <= limit:
            sizes.append((n_vars, constraints))
            n_vars *= 2
        constraints *= 2
    return sizes


def generate_random_problem_device(
    n_vars: int,
    n_constraints: int,
    seed: int,
    lo: float = DEFAULT_MIN,
    hi: float = DEFAULT_MAX,
    dtype=None,
    rand_flavor: str = "msvc",
    *,
    device="cuda",
):
    """Generate ``(A, b, c)`` on ``device`` (``simplex_tpu.generator.
    generate_random_problem_device``): tensors ``(n_constraints, n_vars)``,
    ``(n_constraints,)`` and ``(n_vars,)`` in ``dtype`` (default: the
    default options' float64), drawn uniform in ``[lo, hi)`` in float32 and
    then cast.

    The sub-seeds are the host path's (``derive_subseeds``; ``rand_flavor``
    defaults to 'msvc' there too): b, c and A each come from one explicit
    ``torch.Generator(device=device)`` seeded with its sub-seed. The
    stream is neither cuRAND's XORWOW (the host path) nor JAX's threefry
    (the JAX package's device path), and it depends on the device kind:
    the CUDA generator is Philox, the CPU one is not. What is shared is
    the contract: the same seed, device kind and shape give the same bits.
    ``device="cuda"`` raises where CUDA is absent."""
    from .two_phase import resolve_device

    if n_vars <= 0 or n_constraints <= 0:
        raise ValueError("n_vars and n_constraints must be positive")
    dev = resolve_device(device)
    dtype = getattr(torch, np.dtype(dtype or np.float64).name)
    seed_b, seed_c, seed_a = derive_subseeds(seed, rand_flavor)

    def uniform(sub_seed: int, shape) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(sub_seed)
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        x.uniform_(lo, hi, generator=g)
        # CUDA's uniform_ maps a draw that rounds up to ``hi`` back to
        # ``lo``; the same on every device keeps the range half-open.
        return x.masked_fill_(x >= hi, lo).to(dtype)

    b = uniform(seed_b, (n_constraints,))
    c = uniform(seed_c, (n_vars,))
    A = uniform(seed_a, (n_constraints, n_vars))
    return A, b, c
