"""Checkpoint / resume of the solve state.

Port of ``simplex_tpu.checkpoint``. The solver state -- (Tt, b, costs,
z, base) plus the loop counters -- is dumped to one ``.npz`` between
windows of ``checkpoint_every`` pivots; ``solve_resumable`` picks up from
the newest file after an interruption: kill the process at any point and
rerun the same call to continue.

The file is the JAX package's (``simplex_tpu/checkpoint.py:35-85``), so a
checkpoint written by either package resumes in the other:

* ``T``, the tableau in the JAX layout ``(R_pad, M_pad)`` (variable-
  major): the transpose of the port's ``Tt``. It is written as the
  Fortran-ordered view ``Tt.T`` of a host copy, which ``np.savez`` stores
  without a transposed copy; ``np.load`` gives the same array either way;
* ``b``, ``costs``, ``z`` in the vector dtype, ``base`` int32;
* ``__meta__ = int64[n, m, r, phase, iterations, iters1, n_shards]``
  (a 6-entry ``__meta__`` reads as ``n_shards = 0``).

A loaded file is re-padded to the port's dimensions for the options
(zeros outside the live block, padding entries of ``base`` set to the
port's sentinel): the JAX package pads the variable axis to 8 where the
port's kernel loop needs 128, and cuts the single-chip phase-2 tableau to
``R2_pad`` variables. The port keeps the phase-1 width through phase 2
(``tableau.phase2_reset``); its single-card writer stores the JAX
single-chip shape all the same, the first ``R2_pad`` variables, and its
resume runs phase 2 at that width. The sharded writer stores the JAX
sharded shape, ``R1_pad`` variables in both phases. The tableau moves
between card and host in chunks of ``CHUNK_BYTES``, so no second device
copy of it is made.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .config import DEFAULT_OPTIONS, SolverOptions, Status, refine_enabled
from .parallel.group import Shard, all_reduce, barrier, gather
from .parallel.sharded import (build_phase1_sharded, gather_slack_block,
                               gaussian_eliminate_sharded, phase2_costs_local,
                               pivot_out_artificials_sharded, restart_sharded,
                               run_solve_loop_sharded, sharded_padded_dims)
from .problem import Problem
from .result import SolveResult
from .solver import run_solve_loop
from .tableau import (Tableau, build_phase1, count_basic_artificials,
                      extract_solution, gaussian_eliminate, padded_dims,
                      phase1_objective, phase2_reset)
from .two_phase import certify, pivot_out_artificials, resolve_device

_FIELDS = ("T", "b", "costs", "z", "base")

#: Bytes of tableau moved between card and host per copy.
CHUNK_BYTES = 1 << 28

RUNNING = int(Status.RUNNING)


def _host_tt(Tt: torch.Tensor) -> np.ndarray:
    """A C-ordered host copy of ``Tt (M, R)`` (any strides, any device),
    copied in row chunks of at most ``CHUNK_BYTES``."""
    M, R = Tt.shape
    out = torch.empty((M, R), dtype=Tt.dtype)
    rows = max(1, CHUNK_BYTES // max(1, R * Tt.element_size()))
    for i in range(0, M, rows):
        out[i:i + rows].copy_(Tt[i:i + rows])
    return out.numpy()


def _write(path: str, T: np.ndarray, b, costs, z, base, meta) -> None:
    """The atomic write (``simplex_tpu/checkpoint.py:35-57``): a
    temporary file in the target's directory, then ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __meta__=np.asarray(meta, dtype=np.int64), T=T,
                     b=b, costs=costs, z=z,
                     base=np.asarray(base, dtype=np.int32))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_state(path: str, tab: Tableau, *, phase: int, iterations: int,
               iters1: int = 0, n_shards: int = 0) -> None:
    """Atomically persist a Tableau + progress counters to ``path``, ``T``
    in the JAX layout (``simplex_tpu.checkpoint.save_state``).
    ``n_shards`` records the width of a sharded solve (0 = single card)."""
    _write(path, _host_tt(tab.Tt).T, _host(tab.b), _host(tab.costs),
           _host(tab.z), _host(tab.base),
           [tab.n, tab.m, tab.r, phase, iterations, iters1, n_shards])


def _read(path: str):
    """(arrays by field, (n, m, r, phase, iterations, iters1, n_shards))
    of a checkpoint file, on the host."""
    with np.load(path) as z:
        meta = [int(v) for v in z["__meta__"]]
        arrays = {f: z[f] for f in _FIELDS}
    n_shards = meta[6] if len(meta) > 6 else 0
    return arrays, (*meta[:6], n_shards)


def _tableau(arrays, meta, R_pad: int, M_pad: int, device,
             lo: int = 0, hi: int | None = None) -> Tableau:
    """The port's tableau from a file's arrays, re-padded to ``(R_pad,
    M_pad)``: the variables ``[lo, hi)`` of it (a rank's slice; default
    all), the live block copied, zeros elsewhere, ``base`` entries at or
    past ``r`` (padding, dropped rows) set to ``R_pad``. The tableau goes
    to ``device`` in chunks of constraints, transposed on the host."""
    n, m, r = meta[:3]
    hi = R_pad if hi is None else hi
    dev = torch.device(device)
    T = arrays["T"]
    keep = max(0, min(T.shape[0], hi) - lo)
    Tt = torch.zeros((M_pad, hi - lo), dtype=getattr(torch, T.dtype.name),
                     device=dev)
    cols = max(1, CHUNK_BYTES // max(1, keep * T.itemsize))
    for j in range(0, m if keep else 0, cols):
        jj = min(j + cols, m)
        Tt[j:jj, :keep].copy_(torch.from_numpy(
            np.ascontiguousarray(T[lo:lo + keep, j:jj].T)))
    vd = getattr(torch, arrays["b"].dtype.name)
    costs = torch.zeros(hi - lo, dtype=vd)
    costs[:keep] = torch.from_numpy(np.asarray(arrays["costs"])[lo:lo + keep])
    b = torch.zeros(M_pad, dtype=vd)
    b[:m] = torch.from_numpy(np.asarray(arrays["b"])[:m])
    base_file = np.asarray(arrays["base"])[:m].astype(np.int64)
    base = torch.full((M_pad,), R_pad, dtype=torch.int32)
    base[:m] = torch.from_numpy(np.where(base_file < r, base_file,
                                         R_pad).astype(np.int32))
    return Tableau(Tt=Tt, b=b.to(dev), costs=costs.to(dev),
                   z=torch.as_tensor(np.asarray(arrays["z"]),
                                     dtype=vd).to(dev),
                   base=base.to(dev), n=n, m=m, r=r)


def load_state(path: str, *, device="cuda"):
    """Inverse of save_state, for a file of either package: (tableau,
    phase, iterations, iters1, n_shards), the tableau in the port's
    layout on ``device`` at the file's own dimensions."""
    arrays, meta = _read(path)
    R_pad, M_pad = arrays["T"].shape
    tab = _tableau(arrays, meta, R_pad, M_pad, resolve_device(device))
    return (tab, *meta[3:])


class _Card:
    """The single-card stages of the resumable solve (build, the window
    runner, phase 2, the degenerate-basis repair, the certification) and
    its checkpoint file (existence, load, save, delete). The sharded
    solve overrides them (``_Ranks``)."""

    n_shards = 0

    def __init__(self, problem: Problem, options: SolverOptions, path: str,
                 dev: torch.device):
        self.problem, self.options, self.path, self.dev = (problem, options,
                                                           path, dev)
        self.n, self.m = problem.vars, problem.constraints

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def delete(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)

    def load(self, arrays, meta) -> Tableau:
        R1, R2, M_pad = padded_dims(self.n, self.m, self.options)
        return _tableau(arrays, meta, R1 if meta[3] == 1 else R2, M_pad,
                        self.dev)

    def save(self, tab: Tableau, phase: int, iterations: int,
             iters1: int) -> None:
        if phase == 2:
            # The JAX single-chip phase-2 shape: the first R2_pad
            # variables.
            R2 = padded_dims(self.n, self.m, self.options)[1]
            tab = dataclasses.replace(tab, Tt=tab.Tt[:, :R2],
                                      costs=tab.costs[:R2])
        save_state(self.path, tab, phase=phase, iterations=iterations,
                   iters1=iters1)

    def build(self) -> Tableau:
        p = self.problem
        A = torch.as_tensor(np.asarray(p.A), device=self.dev)
        b = torch.as_tensor(np.asarray(p.b), device=self.dev)
        return gaussian_eliminate(build_phase1(A, b, self.n, self.m,
                                               self.options))

    def columns(self, tab: Tableau) -> torch.Tensor:
        """The global variable index of each column of ``tab``."""
        return torch.arange(tab.costs.shape[0], device=self.dev)

    def costs0(self, tab: Tableau, phase: int) -> torch.Tensor:
        """The phase's pre-elimination costs (ones on the artificials;
        ``[-c | 0]``), rebuilt so that the blocked loops' window-boundary
        re-pricing runs on a resumed solve too."""
        n, m = self.n, self.m
        gi = self.columns(tab)
        vd = tab.costs.dtype
        if phase == 1:
            return ((gi >= n + m) & (gi < n + 2 * m)).to(vd)
        c = torch.as_tensor(np.asarray(self.problem.c), dtype=vd,
                            device=self.dev)
        return torch.where(gi < n, -c.index_select(0, gi.clamp(max=n - 1)),
                           0.0)

    def run(self, tab: Tableau, window: int, costs0: torch.Tensor):
        return run_solve_loop(tab, self.options, window, costs0)

    def pivot_out(self, tab: Tableau) -> Tableau:
        return pivot_out_artificials(tab, self.options)

    def phase2(self, tab: Tableau) -> Tableau:
        c = torch.as_tensor(np.asarray(self.problem.c), device=self.dev)
        return gaussian_eliminate(phase2_reset(tab, c))

    def certify(self, tab: Tableau, objective: float):
        """``two_phase.certify`` of the final basis, from its slack
        block."""
        A, b, c = (torch.as_tensor(np.asarray(v), device=self.dev)
                   for v in (self.problem.A, self.problem.b, self.problem.c))
        n, m = self.n, self.m
        return certify(self.problem, tab.base, tab.Tt[:m, n:n + m],
                       objective, self.options, A, b, c)


def _run_windows(stages: _Card, tab: Tableau, max_iter: int, phase: int,
                 done: int, every: int, costs0, iters1: int = 0):
    """Run the solve loop ``every`` pivots at a time, checkpointing after
    each window (``simplex_tpu/checkpoint.py:88-146``). Returns (tab,
    status: int, total iterations).

    The stall counter behind the Bland anti-cycling fallback, the devex
    weights and the re-pricing cadence restart at each window, so
    ``every`` is clamped (with a warning) to at least 4x the Bland
    threshold under Dantzig pricing. The last window is capped to the
    remaining ``max_iter - done``, so the total never overshoots
    ``max_iter``."""
    options = stages.options
    if options.bland_threshold and options.pivot_rule_resolved == "dantzig":
        clamped = max(every, 4 * int(options.bland_threshold))
        if clamped != every:
            warnings.warn(
                f"checkpoint_every={every} raised to {clamped} (4x the "
                f"Bland anti-cycling threshold of "
                f"{options.bland_threshold}); pass bland_threshold=None "
                "or a smaller threshold for finer checkpoints",
                RuntimeWarning, stacklevel=3)
        every = clamped

    while True:
        window = min(every, max_iter - done)
        if window <= 0:
            return tab, RUNNING, done
        tab, status, it = stages.run(tab, window, costs0)
        done += it
        if status == RUNNING and it == 0:
            # No progress is possible (a window that pivots nothing):
            # stop instead of re-saving the same checkpoint forever, and
            # report MAXITER as the loop's own guard does.
            return tab, int(Status.MAXITER), done
        if status != RUNNING or done >= max_iter:
            return tab, status, done
        stages.save(tab, phase, done, iters1)


def _resumable_core(stages: _Card, checkpoint_every: int,
                    refine_extraction: bool | None) -> SolveResult:
    """The two-phase resumable orchestration shared by the single-card and
    sharded entry points (``simplex_tpu/checkpoint.py:149-289``):
    load-or-build, windowed phase 1, the INFEASIBLE / DEGENERATE /
    MAXITER ladder, the phase-2 transition checkpoint, windowed phase 2,
    and the file's lifecycle (terminal statuses delete it; MAXITER keeps
    it, so a rerun with a larger budget resumes); then the certification
    of an OPTIMAL result (``stages.certify``)."""
    problem, options = stages.problem, stages.options
    n, m = stages.n, stages.m
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)

    if stages.exists():
        arrays, meta = _read(stages.path)
        fn, fm, _, phase, done, iters1, ck_shards = meta
        if ck_shards != stages.n_shards:
            if stages.n_shards == 0:
                raise ValueError(
                    f"checkpoint was written by a {ck_shards}-shard "
                    "sharded solve; resume it with "
                    "solve_resumable_sharded / --sharded")
            if ck_shards == 0:
                raise ValueError(
                    "checkpoint was written by a single-chip solve; "
                    "resume it without --sharded (or delete it)")
            raise ValueError(
                f"checkpoint was written on a {ck_shards}-shard mesh, "
                f"resuming on {stages.n_shards} shards (re-shard by "
                "deleting the checkpoint or matching the mesh)")
        if (fn, fm) != (n, m):
            raise ValueError(f"checkpoint is for a {fn}x{fm} problem, "
                             f"got {n}x{m}")
        t_dt, b_dt = arrays["T"].dtype, arrays["b"].dtype
        if t_dt != options.dtype or b_dt != options.vector_dtype:
            raise ValueError(
                f"checkpoint dtypes ({t_dt}/{b_dt}) do not match options "
                f"({options.dtype}/{options.vector_dtype})")
        tab = stages.load(arrays, meta)
        del arrays
    else:
        tab = stages.build()
        phase, done, iters1 = 1, 0, 0

    degenerate = False
    if phase == 1:
        tab, status1, done = _run_windows(
            stages, tab, max_iter, 1, done, checkpoint_every,
            stages.costs0(tab, 1))
        if status1 == RUNNING:
            return SolveResult(Status.MAXITER, None, float(tab.z), done, 0)
        z1 = float(phase1_objective(tab))
        b_scale = 1.0 + float(np.max(np.abs(problem.b)))
        if z1 <= -eps * b_scale:
            stages.delete()
            return SolveResult(Status.INFEASIBLE, None, z1, done, 0)
        degenerate = count_basic_artificials(tab) > 0
        if degenerate and options.degeneracy == "reference":
            # Terminal: a rerun from the phase-1 file would only derive
            # the same verdict, so the file goes as on the other terminal
            # statuses.
            stages.delete()
            return SolveResult(Status.DEGENERATE, None, z1, done, 0,
                               degenerate=True)
        if degenerate:
            tab = stages.pivot_out(tab)
        tab = stages.phase2(tab)
        phase, iters1, done = 2, done, 0
        stages.save(tab, 2, 0, iters1)

    tab, status2, done = _run_windows(
        stages, tab, max_iter, 2, done, checkpoint_every,
        stages.costs0(tab, 2), iters1)
    if status2 == RUNNING:
        # Keep the checkpoint: rerunning with a larger max_iter resumes.
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1, done)
    stages.delete()
    if status2 != int(Status.OPTIMAL):
        return SolveResult(Status(status2), None, float(tab.z), iters1,
                           done, degenerate=degenerate)
    x = _host(extract_solution(tab))
    objective = float(np.dot(problem.c, x))
    if refine_extraction is None:
        refine_extraction = refine_enabled(options)
    if not refine_extraction:
        return SolveResult(Status.OPTIMAL, x, objective, iters1, done,
                           degenerate=degenerate)
    cert = stages.certify(tab, objective)
    if cert.fallback is not None:
        return cert.fallback
    return SolveResult(Status.OPTIMAL, cert.x, cert.objective, iters1,
                       done + cert.extra_pivots, degenerate=degenerate,
                       refine=cert.refine)


def _options(options: SolverOptions | None, replacements) -> SolverOptions:
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    return options


def solve_resumable(problem: Problem, checkpoint_path: str,
                    checkpoint_every: int = 1000,
                    options: SolverOptions | None = None,
                    refine_extraction: bool | None = None, *,
                    device="cuda", **replacements) -> SolveResult:
    """Two-phase solve on ``device`` with iteration-level checkpoint /
    resume (``simplex_tpu.checkpoint.solve_resumable``).

    If ``checkpoint_path`` exists, the solve continues from it (the
    problem must be the same one; the file may come from either package);
    otherwise it starts fresh. The file is removed on every terminal
    status and kept on MAXITER, so a rerun with a larger ``max_iter``
    resumes. The loop runs in windows of ``checkpoint_every`` pivots, each
    a call of ``solver.run_solve_loop`` followed by a write; the walk
    therefore differs from ``solve``'s where the loop carries state
    across pivots (the devex weights, the re-pricing cadence, the Bland
    stall counter), as in the JAX package.

    With ``refine_extraction`` (default: the mixed mode) an OPTIMAL
    result is certified as ``solve`` certifies it (``two_phase.certify``:
    f64 refinement of the final basis with its LU retry, up to two
    reinversion restarts, then the f64 finishing tier), so the contract
    is ``solve``'s. The JAX package's is weaker: it refines once from the
    slack block and returns the unrefined x with
    ``refine.certified=False`` when the certificates fail, which the
    production flagship's drifted final basis does on an H100.
    ``device="cuda"`` (the default) raises where CUDA is absent."""
    options = _options(options, replacements)
    stages = _Card(problem, options, checkpoint_path, resolve_device(device))
    return _resumable_core(stages, checkpoint_every, refine_extraction)


# ---------------------------------------------------------------------------
# The sharded resumable solve.

class _Ranks(_Card):
    """The sharded stages (``parallel.sharded``) on this rank's slice of
    the variables, and the file seen from a process group: rank 0 decides
    whether it exists (one ``all_reduce``) and is the one writer and
    deleter, after gathering the slices; every rank waits for each write
    and delete at a barrier, and every rank loads its own slice."""

    def __init__(self, problem, options, path, dev, group):
        super().__init__(problem, options, path, dev)
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.R_pad, self.M_pad = sharded_padded_dims(
            self.n, self.m, self.n_shards, options)
        self.shard = Shard.of(group, self.R_pad)

    def _sync(self) -> None:
        barrier(self.group, self.dev)

    def exists(self) -> bool:
        here = float(self.shard.rank == 0 and os.path.exists(self.path))
        return float(all_reduce(torch.tensor([here], device=self.dev),
                                self.group)) > 0

    def delete(self) -> None:
        if self.shard.rank == 0:
            super().delete()
        self._sync()

    def load(self, arrays, meta) -> Tableau:
        sh = self.shard
        return _tableau(arrays, meta, self.R_pad, self.M_pad, self.dev,
                        sh.offset, sh.offset + sh.R_loc)

    def save(self, tab: Tableau, phase: int, iterations: int,
             iters1: int) -> None:
        Tt = tab.Tt
        M, R_loc = Tt.shape
        P = self.n_shards
        root = self.shard.rank == 0
        rows = max(1, CHUNK_BYTES // max(1, P * R_loc * Tt.element_size()))
        host = torch.empty((M, P * R_loc), dtype=Tt.dtype) if root else None
        for i in range(0, M, rows):
            parts = gather(Tt[i:i + rows], self.group)     # (P, rows, R_loc)
            if root:
                host[i:i + rows].copy_(parts.permute(1, 0, 2).reshape(
                    parts.shape[1], P * R_loc))
        costs = gather(tab.costs, self.group)
        if root:
            _write(self.path, host.numpy().T, _host(tab.b),
                   _host(costs).reshape(-1), _host(tab.z), _host(tab.base),
                   [tab.n, tab.m, tab.r, phase, iterations, iters1, P])
        self._sync()

    def build(self) -> Tableau:
        p = self.problem
        tab = build_phase1_sharded(
            torch.as_tensor(np.asarray(p.A)),
            torch.as_tensor(np.asarray(p.b), device=self.dev), self.n,
            self.m, self.shard, self.options, self.M_pad, self.dev)
        return gaussian_eliminate_sharded(tab, self.shard)

    def columns(self, tab: Tableau) -> torch.Tensor:
        return self.shard.offset + torch.arange(self.shard.R_loc,
                                                device=self.dev)

    def run(self, tab: Tableau, window: int, costs0: torch.Tensor):
        return run_solve_loop_sharded(tab, self.shard, self.options, window,
                                      costs0)

    def pivot_out(self, tab: Tableau) -> Tableau:
        return pivot_out_artificials_sharded(tab, self.shard, self.options)

    def phase2(self, tab: Tableau) -> Tableau:
        c = torch.as_tensor(np.asarray(self.problem.c), device=self.dev)
        tab = dataclasses.replace(
            tab, costs=phase2_costs_local(tab, c, self.shard),
            r=self.n + self.m)
        return gaussian_eliminate_sharded(tab, self.shard)

    def certify(self, tab: Tableau, objective: float):
        A, b, c = (torch.as_tensor(np.asarray(v), device=self.dev)
                   for v in (self.problem.A, self.problem.b, self.problem.c))
        return certify(self.problem, tab.base,
                       gather_slack_block(tab, self.shard), objective,
                       self.options, A, b, c,
                       restart=functools.partial(restart_sharded, self.shard))


def solve_resumable_sharded(problem: Problem, mesh, checkpoint_path: str,
                            checkpoint_every: int = 1000,
                            options: SolverOptions | None = None, *,
                            device="cuda", **replacements) -> SolveResult:
    """Sharded two-phase solve with iteration-level checkpoint / resume
    (``simplex_tpu.checkpoint.solve_resumable_sharded``): the contract of
    ``solve_resumable`` with every stage on the ranks of ``mesh``, a
    ``torch.distributed`` ProcessGroup (None: the default group), the
    variable axis split as in ``parallel.sharded.solve_sharded``. Every
    rank calls it with the same arguments and returns the same result.

    Each window runs ``run_solve_loop_sharded`` (the kernel loop over K5,
    K2 and K3/K4 where the options take it); rank 0 gathers the slices
    and writes the global arrays in the JAX layout, ``R1_pad`` variables
    in both phases, with the group's size as ``n_shards``; on resume every
    rank loads its own slice. A file written at another width, or by a
    single-card solve, is refused. In the mixed mode an OPTIMAL result is
    certified as ``solve_sharded`` certifies it (the restart rounds on the
    slices). ``device`` is the rank's own (``"cuda"``, the default, raises
    where CUDA is absent)."""
    options = _options(options, replacements)
    dev = resolve_device(device)
    group = mesh if mesh is not None else dist.group.WORLD
    stages = _Ranks(problem, options, checkpoint_path, dev, group)
    return _resumable_core(stages, checkpoint_every, None)


def solve_resumable_sharded_rank(group, device, cases):
    """``solve_resumable_sharded`` of each (problem, checkpoint_path,
    checkpoint_every, options) in ``cases`` in turn, for ``group.spawn``
    (one spawn for several solves). Returns the results."""
    return [solve_resumable_sharded(p, group, path, every, o, device=device)
            for p, path, every, o in cases]
