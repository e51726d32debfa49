"""The process group that takes the place of the JAX package's mesh.

JAX runs one process holding a ``Mesh`` of devices under ``shard_map``;
the port runs one process per rank over ``torch.distributed``
(``simplex_tpu/parallel/sharded.py`` is the reference). This module holds
what replaces the mesh:

* ``Shard``: a rank's place in the group and its contiguous slice of the
  variable axis (``sharded.py:104-115``: the offset and the row mask);
* ``all_gather`` of a stack of scalars, ``all_reduce`` (sum) and
  ``gather`` onto rank 0, each raising its per-kind counter in ``COUNTS``
  (and ``SHAPES`` by operand shape), which the collective-structure test
  reads, and ``barrier`` (one counted ``all_reduce``);
* ``all_reduce_`` and ``all_gather_into``, the same collectives into
  fixed buffers, counted alike: the forms a CUDA graph can capture (over
  NCCL, ``capturable``), whose replays ``CapturedCollectives`` counts;
* ``world``, which sets up and tears down a group of this process, and
  ``spawn``, which runs a function on ``nranks`` new processes and
  returns rank 0's result (the CLI and the tests use it).

NCCL runs on CUDA tensors, one card per rank, and gloo on the CPU. Gloo
takes CUDA tensors too (several ranks on one card), but only some of its
collectives do, so they are staged through host memory there; that path
is for checks, not for speed. Every collective here is issued by every
rank in the same order: the loops decide on replicated values only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

#: Collectives issued since the last ``reset_counts``, by kind.
COUNTS: collections.Counter = collections.Counter()
#: The same, by (kind, operand shape).
SHAPES: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()
    SHAPES.clear()


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's slice of the variable axis: columns ``[offset, offset +
    R_loc)`` of the global ``R_pad``, on ``group``'s rank ``rank`` of
    ``size``."""

    group: dist.ProcessGroup
    rank: int
    size: int
    R_loc: int

    @classmethod
    def of(cls, group: dist.ProcessGroup, R_pad: int) -> "Shard":
        size = dist.get_world_size(group)
        if R_pad % size:
            raise ValueError(f"R_pad={R_pad} does not split into {size} "
                             "slices")
        return cls(group, dist.get_rank(group), size, R_pad // size)

    @property
    def offset(self) -> int:
        return self.rank * self.R_loc

    @property
    def R_pad(self) -> int:
        return self.size * self.R_loc

    def row_mask(self, r: int, device) -> torch.Tensor:
        """(R_loc,) bool: the slice's columns that are globally live
        (< r)."""
        return self.offset + torch.arange(self.R_loc, device=device) < r

    def local_r(self, r: int) -> int:
        """The live columns of the slice: ``clip(r - offset, 0, R_loc)``."""
        return min(max(r - self.offset, 0), self.R_loc)


def _staged(x: torch.Tensor, group) -> bool:
    """Gloo with a CUDA tensor: the collective goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (a stack of k scalars, (k,), or one, ()) as a
    (P, k) or (P,) tensor in rank order."""
    COUNTS["all_gather"] += 1
    SHAPES[("all_gather", tuple(x.shape))] += 1
    src = x.reshape(-1).contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts).view(len(parts), *x.shape)
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, returned as a new tensor. The
    loops' sums have one owner per element and zeros elsewhere, so they
    are exact in any order."""
    COUNTS["all_reduce"] += 1
    SHAPES[("all_reduce", tuple(x.shape))] += 1
    out = x.contiguous().clone()
    staged = _staged(out, group)
    if staged:
        out = out.cpu()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def all_reduce_(buf: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce`` summed into ``buf`` itself (contiguous), which is
    returned: over NCCL one collective that allocates nothing, as a CUDA
    graph needs; gloo with a CUDA tensor stages it through the host."""
    if not buf.is_contiguous():
        raise ValueError("all_reduce_: want a contiguous buffer")
    COUNTS["all_reduce"] += 1
    SHAPES[("all_reduce", tuple(buf.shape))] += 1
    if _staged(buf, group):
        host = buf.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def all_gather_into(out: torch.Tensor, src: torch.Tensor,
                    group) -> torch.Tensor:
    """``all_gather`` into ``out`` (P, *src.shape), contiguous, in rank
    order; returns ``out``. Over NCCL one ``all_gather_into_tensor``
    that allocates nothing, as a CUDA graph needs; over gloo the list
    form into ``out``'s rows, staged through the host for CUDA
    tensors."""
    P = dist.get_world_size(group)
    if (tuple(out.shape) != (P, *src.shape) or out.dtype != src.dtype
            or not out.is_contiguous()):
        raise ValueError(f"all_gather_into: want a contiguous {src.dtype} "
                         f"{(P, *src.shape)} output, got {out.dtype} "
                         f"{tuple(out.shape)}")
    COUNTS["all_gather"] += 1
    SHAPES[("all_gather", tuple(src.shape))] += 1
    flat = src.reshape(-1).contiguous()
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out.view(-1), flat, group=group)
        return out
    staged = _staged(flat, group)
    rows = out.cpu() if staged else out
    dist.all_gather(list(rows.view(P, -1).unbind(0)),
                    flat.cpu() if staged else flat, group=group)
    if staged:
        out.copy_(rows)
    return out


def capturable(group, x: torch.Tensor) -> bool:
    """Whether a CUDA graph can hold this group's collectives on ``x``:
    NCCL on a CUDA tensor. Gloo stages CUDA tensors through the host,
    which no graph captures."""
    return x.is_cuda and dist.get_backend(group) == "nccl"


class CapturedCollectives:
    """Collective counts for a CUDA graph, as
    ``kernels.blocked.CapturedLaunches`` counts launches: around a capture
    it takes back what the collectives counted while capturing (a capture
    runs nothing) and keeps it as the graph's own; ``replayed`` adds those
    to ``COUNTS`` and ``SHAPES`` once a replay."""

    def __enter__(self) -> "CapturedCollectives":
        self._before = (COUNTS.copy(), SHAPES.copy())
        return self

    def __exit__(self, *exc) -> None:
        counts, shapes = self._before
        self.counts, self.shapes = COUNTS - counts, SHAPES - shapes
        for live, saved in ((COUNTS, counts), (SHAPES, shapes)):
            live.clear()
            live.update(saved)

    def replayed(self) -> None:
        COUNTS.update(self.counts)
        SHAPES.update(self.shapes)


def gather(x: torch.Tensor, group) -> torch.Tensor | None:
    """Every rank's ``x`` stacked in rank order, ``(P, *x.shape)``, on the
    group's rank 0 (on x's device, or the host where gloo stages a CUDA
    tensor); None on the other ranks."""
    COUNTS["gather"] += 1
    SHAPES[("gather", tuple(x.shape))] += 1
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = None
    if dist.get_rank(group) == 0:
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    return None if parts is None else torch.stack(parts)


def barrier(group, device) -> None:
    """Return on each rank only once every rank has called it: one
    one-element ``all_reduce`` on ``device``, read on the host."""
    float(all_reduce(torch.zeros(1, device=device), group))


def backend_for(device) -> str:
    """NCCL for CUDA ranks, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def world(rank: int, nranks: int, backend: str, store_dir: str):
    """The default process group of this process, over a FileStore in
    ``store_dir`` (every rank passes the same directory), destroyed on
    exit. Yields ``dist.group.WORLD``."""
    store = dist.FileStore(os.path.join(store_dir, "store"), nranks)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nranks)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def rank_device(rank: int, device: str, backend: str) -> torch.device:
    """A rank's device: the CPU; or with NCCL card ``rank`` (one card per
    rank), with gloo the current card (several ranks may share it)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = rank if backend == "nccl" else torch.cuda.current_device()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _child(rank: int, fn, nranks: int, backend: str, device: str,
           store_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = rank_device(rank, device, backend)
    with world(rank, nranks, backend, store_dir) as group:
        out = fn(group, dev, *args)
    if rank == 0:
        with open(os.path.join(store_dir, "result.pkl"), "wb") as fh:
            pickle.dump(out, fh)


def spawn(fn, nranks: int, backend: str, device: str, *args):
    """Run ``fn(group, device, *args)`` on ``nranks`` new processes (one
    rank each, started with the spawn method, each with one CPU thread)
    and return rank 0's result. ``fn`` must be importable by name from a
    child, so it lives in this package. A rank that raises makes this
    raise with its traceback."""
    import torch.multiprocessing as mp

    if backend == "nccl" and nranks > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card per rank: {nranks} ranks, "
                         f"{torch.cuda.device_count()} card(s)")
    with tempfile.TemporaryDirectory() as td:
        mp.start_processes(_child, args=(fn, nranks, backend, device, td,
                                         args),
                           nprocs=nranks, join=True, start_method="spawn")
        with open(os.path.join(td, "result.pkl"), "rb") as fh:
            return pickle.load(fh)
