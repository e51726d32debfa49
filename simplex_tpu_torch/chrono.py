"""Per-operation timing to CSV.

Port of ``simplex_tpu.chrono``, the reference's chrono subsystem: the
same CSV schema -- header ``vars,contraints,operation,elapsed_time``
(sic, the reference's typo is kept for downstream compatibility), one
row per timed operation, elapsed time in **microseconds**. The ``vars``
column is the tableau row count *including* the cost row: n+2m+1 in
phase 1, n+m+1 in phase 2 (``timed.py`` passes them). Two file modes, as
in the reference: a timestamped ad-hoc file (``times_<stamp>.txt``) and
a benchmark-named one (``benchmark_<vars>_<constraints>.txt``).

On a CUDA device an operation is timed as the reference times it: CUDA
events recorded on the current stream around the operation, the elapsed
milliseconds times 1000. On the CPU, ``time.perf_counter`` around an
operation that has finished when it returns.
"""

from __future__ import annotations

import os
import time
from typing import Optional, TextIO

import torch

HEADER = "vars,contraints,operation,elapsed_time"


class Chrono:
    """CSV op timer. Use ``start(rows, cols, op, device)`` / ``stop()``
    around an operation on ``device``, or ``row(...)`` to record a
    pre-measured time."""

    def __init__(self, fh: TextIO, owns: bool = True):
        self._fh = fh
        self._owns = owns
        self._pending: Optional[tuple] = None
        fh.write(HEADER + "\n")

    @classmethod
    def open_timestamped(cls, measures_dir: str) -> "Chrono":
        """times_<stamp>.txt (reference initCsv)."""
        os.makedirs(measures_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d%H%M%S")
        return cls(open(os.path.join(measures_dir, f"times_{stamp}.txt"),
                        "w"))

    @classmethod
    def open_benchmark(cls, measures_dir: str, n_vars: int,
                       n_constraints: int) -> "Chrono":
        """benchmark_<vars>_<constraints>.txt (reference
        initCsvBenchmark)."""
        os.makedirs(measures_dir, exist_ok=True)
        path = os.path.join(measures_dir,
                            f"benchmark_{n_vars}_{n_constraints}.txt")
        return cls(open(path, "w"))

    def start(self, rows: int, cols: int, operation: str,
              device: torch.device | str = "cpu") -> None:
        # Flush the row prefix at once: a long device call follows, and a
        # crash inside it must leave an observable dangling row (the
        # CLI's --resume-sweep keys off it), not an empty buffered file.
        self._fh.write(f"{rows},{cols},{operation},")
        self._fh.flush()
        dev = torch.device(device)
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            self._pending = (stream, ev)
        else:
            self._pending = (None, time.perf_counter())

    def stop(self) -> None:
        if self._pending is None:
            raise RuntimeError("Chrono.stop() without start()")
        stream, mark = self._pending
        self._pending = None
        if stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            end.synchronize()
            elapsed_us = mark.elapsed_time(end) * 1e3
        else:
            elapsed_us = (time.perf_counter() - mark) * 1e6
        self._fh.write(f"{elapsed_us:f}\n")
        self._fh.flush()

    def row(self, rows: int, cols: int, operation: str,
            seconds: float) -> None:
        """Record an already-measured duration (seconds -> µs)."""
        self._fh.write(f"{rows},{cols},{operation},{seconds * 1e6:f}\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "Chrono":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullChrono:
    """No-op stand-in when timing is disabled (the reference compiles the
    chrono calls out without -D TIMER)."""

    def start(self, *a, **kw) -> None: ...
    def stop(self) -> None: ...
    def row(self, *a) -> None: ...
    def close(self) -> None: ...
    def __enter__(self): return self
    def __exit__(self, *exc): ...
