#!/usr/bin/env python3
"""The sequential loops as one CUDA graph a chunk, on the card.

0. ``tools/seq_variants.cu`` built with nvcc (its registers and spills
   from ``-Xptxas -v`` written to ``chiprun_out/seq_variants_ptxas.log``)
   and run: the ratio test and the pivot row's pass in every form tried,
   bit for bit against the kernels they replaced, and timed in turns
   (``--no-variants`` skips it); then ``tools/k6_tail_variants.cu`` the
   same way: the K6 loop's pivot in every form tried for its snapshot and
   its fold and step after (``--no-k6-variants`` skips it);
1. the kernel library's build (timed);
2. ``chip_smoke.phase_seq_kernels``: each sequential kernel against its
   plain version at the main paths' shapes, bit for bit, and timed -- the
   rank-1 update with row k (``seq_rank1``) in turns with ``batch_rank1``
   at one lane (the update without row k: what the design with a fourth
   node for row k would launch) and with ``Tt.addr_``;
3. the default options (f64) on random_256_256 (the ``-t`` sweep's
   smallest size, 473 + 17 pivots) and random_1024_1024 three ways in
   turns -- graph, ``graph=False``, the old eager ``iteration_body``, then
   back -- every run walking the same pivots and every loop call ending
   with the first run's state bit for bit; random_8192_8192 graphed once
   (``--no-big`` skips it);
4. K6's path on random_2048_2048, graph and ``graph=False`` in turns;
5. ``chip_smoke.phase_chunk_trace``: kernels a pivot and the device's
   busy share inside a replayed chunk and over its period.

Run from the root of a checkout on a CUDA card::

    python3 tools/seq_loop_probe.py [--no-big] [--no-variants]
        [--no-k6-variants]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def turns(label: str, p, opts: dict, ways, pallas: bool = False) -> None:
    """``chip_smoke.seq_loops`` of ``p`` each way in ``ways``, every run
    held to the first's walk and loop calls' states."""
    keep: list = []
    walk = None
    for i, way in enumerate(ways):
        r = cs.seq_loops(p, opts, way, pallas=pallas,
                         keep=None if i else keep, against=keep if i else None)
        res = r["res"]
        w = (res.iterations_phase1, res.iterations_phase2)
        cs.require(walk is None or w == walk, f"{label} {way} walked {w}, "
                   f"the first {walk}")
        walk = w
        cs.log(cs.seq_line(f"{label} {way}", r) + f"; {res.status.name} "
               f"objective {res.objective!r}; pivots {w[0]}+{w[1]}")


def variants(name: str) -> None:
    """Build and run ``tools/<name>.cu``; its output to the log,
    ptxas's report to ``<name>_ptxas.log`` in the output directory."""
    from simplex_tpu_torch.kernels import _build

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        exe = pathlib.Path(td) / name
        t0 = time.perf_counter()
        build = subprocess.run(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-o", str(exe),
             str(ROOT / "tools" / f"{name}.cu")],
            capture_output=True, text=True, timeout=900)
        (out / f"{name}_ptxas.log").write_text(build.stderr)
        cs.require(build.returncode == 0, f"{name}.cu did not build: "
                   + build.stderr[-3000:])
        cs.log(f"{name}.cu built in {time.perf_counter() - t0:.1f} s")
        run = subprocess.run([str(exe)], capture_output=True, text=True,
                             timeout=900)
    for line in run.stdout.splitlines():
        cs.log(f"{name}: {line}")
    cs.require(run.returncode == 0, f"{name} exited {run.returncode}: "
               + run.stderr[-2000:])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-big", action="store_true",
                        help="skip random_8192_8192")
    parser.add_argument("--no-variants", action="store_true",
                        help="skip tools/seq_variants.cu")
    parser.add_argument("--no-k6-variants", action="store_true",
                        help="skip tools/k6_tail_variants.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("seq_loop_probe: no CUDA card", file=sys.stderr)
        return 2
    from simplex_tpu_torch.kernels import _build

    cs.log(f"card: {cs.nvidia_smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    cs.log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    try:
        if not args.no_variants:
            variants("seq_variants")
        if not args.no_k6_variants:
            variants("k6_tail_variants")
        records: dict = {}
        cs.phase_seq_kernels(records)
        for name, rec in records.items():
            cs.log(f"record {name}: {rec}")
        ways = ("graph", "eager", "old", "old", "eager", "graph")
        for n in (256, 1024):
            turns(f"f64 random_{n}_{n}", cs.benchmark_problem(n), {}, ways)
        if not args.no_big:
            turns("f64 random_8192_8192", cs.benchmark_problem(8192), {},
                  ("graph",))
        turns("f32 K6 random_2048_2048", cs.benchmark_problem(2048),
              cs.K6_OPTS, ("graph", "eager", "eager", "graph"), pallas=True)
        cs.phase_chunk_trace()
    except cs.SmokeFailure as e:
        print(f"seq_loop_probe: FAILED: {e}", file=sys.stderr)
        return 1
    cs.log("seq_loop_probe: every check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
