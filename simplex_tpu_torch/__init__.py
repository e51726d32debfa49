"""simplex_tpu_torch: the dense two-phase simplex solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``simplex_tpu`` (JAX/Pallas on a TPU), which stays the
reference. This package imports ``torch`` and neither ``jax`` nor
``simplex_tpu``. Public API, with the names and behaviour of
``simplex_tpu``::

    from simplex_tpu_torch import read_problem, solve, Status
    p = read_problem("data/examples/smallProblem.txt")
    r = solve(p, dtype="float32", vector_dtype="float64", block_pivots=128)

``solve`` and ``solve_batch`` (many LPs of one shape in one call) run on
the device they are given (``device="cuda"`` by default, which raises
where CUDA is absent; ``device="cpu"`` runs the kernels' plain PyTorch
versions). Only configurations that resolve to the blocked-kernel loop
(``solve``) or the batched kernels (``solve_batch``) are ported; the
others raise ``NotImplementedError`` naming the ROADMAP item that will
port them.
"""

from .batch import solve_batched  # noqa: F401
from .config import EPS, SolverOptions, Status  # noqa: F401
from .generator import generate_random_problem  # noqa: F401
from .problem import Problem, read_problem, read_random_problem  # noqa: F401
from .result import SolveResult  # noqa: F401
from .two_phase import solve  # noqa: F401

#: Alias with the JAX package's public name.
solve_batch = solve_batched

__version__ = "0.1.0"
