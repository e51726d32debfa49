"""simplex_tpu_torch: the dense two-phase simplex solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``simplex_tpu`` (JAX/Pallas on a TPU), which stays the
reference. This package imports ``torch`` and neither ``jax`` nor
``simplex_tpu``. Public API, with the names and behaviour of
``simplex_tpu``::

    from simplex_tpu_torch import read_problem, solve, Status
    p = read_problem("data/examples/smallProblem.txt")
    r = solve(p)                      # f64 tableau, the reference loop
    r = solve(p, dtype="float32", vector_dtype="float64", block_pivots=128)

What is ported: ``solve`` with every option set of the JAX ``solve`` --
the sequential reference loop (f64 by default; over the fused pivot
kernel K6 with ``use_pallas=True`` on a pure-f32 tableau, ``dtype`` and
``vector_dtype`` both float32), the plain deferred block-pivot loop, and
the blocked-kernel loop over K1-K4, with f64 refinement, reinversion
restarts and the f64 finishing tiers (``finish.finish_from_basis``, the
full f64 re-solve of ``two_phase.fallback_solve``) in the mixed mode, and
power-of-two ``equilibrate``; ``solve_batch`` on the batched kernels
K7-K10 and, for the options they do not take (``DEFAULT_OPTIONS``
among them), the batched fallback, and with ``mesh=`` (a
``torch.distributed`` ProcessGroup) the scenario fleet across ranks;
``solve_sharded``, the variable axis split across the ranks of a process
group (K5 on its kernel path); ``solve_timed`` with the reference's
per-operation CSV (``chrono``); the host oracle ``solve_oracle`` (with
the reference GPU's tie order and fma update); the CLI, ``python -m
simplex_tpu_torch.cli``, ``--checkpoint`` included; ``solve_resumable``,
the two-phase solve in windows of pivots with a checkpoint file after
each, resumed from the newest after a crash (``checkpoint.py``; the file
is the JAX package's, so either package resumes the other's), and
``checkpoint.solve_resumable_sharded`` across the ranks of a process
group; the problem files, the seeded generator (on the host, bit for bit
the reference's instances, and ``generate_random_problem_device`` on the
device), the reference's three-way ``compare`` and the host refinement
``refine_solution_host``.

Every entry point runs on the device it is given (``device="cuda"`` by
default, which raises where CUDA is absent; ``device="cpu"`` runs the
kernels' plain PyTorch versions).
"""

from .batch import solve_batched  # noqa: F401
from .checkpoint import solve_resumable  # noqa: F401
from .config import EPS, SolverOptions, Status, compare  # noqa: F401
from .generator import (benchmark_seed, benchmark_sizes,  # noqa: F401
                        generate_random_problem,
                        generate_random_problem_device)
from .oracle import solve_oracle  # noqa: F401
from .problem import (Problem, format_problem, read_problem,  # noqa: F401
                      read_random_problem, read_seed_file, write_problem,
                      write_seed_file)
from .parallel.sharded import solve_sharded  # noqa: F401
from .refine import refine_solution_host  # noqa: F401
from .result import SolveResult  # noqa: F401
from .timed import solve_timed  # noqa: F401
from .two_phase import solve  # noqa: F401

#: Alias with the JAX package's public name.
solve_batch = solve_batched

__version__ = "0.1.0"
