#!/usr/bin/env python3
"""Can NCCL collectives live inside a CUDA graph here, and what do they
cost there? The question under the sharded kernel loop's graph
(``parallel.sharded.capture_window_sharded``).

At one NCCL rank in this process (every card's rank, one process a card,
where the host has more): the communicator is brought up by one eager
collective; then one graph is captured on a side stream with
``capture_error_mode="thread_local"`` (the capture of
``solver.capture_window``) holding, each between two small kernels, an
``all_reduce`` of an (M,) f32 buffer and ``all_gather_into_tensor``s of a
(5,) f64 and a (2,) int32 buffer into fixed (P, 5) and (P, 2) outputs
(``parallel.group.all_reduce_`` / ``all_gather_into``). It is replayed
``--replays`` times, each replay from fresh inputs and with eager
collectives on the same communicator between replays (what the loop's
window boundary does), and every output is checked. Then the time of a
collective inside a graph (graphs of ``--chain`` collectives of one
kind back to back, CUDA events over their replays) beside an eager
one's on the host clock, and beside a graph of as many one-element
kernels. Prints one line a measure and ``SHARDED_GRAPH_PROBE_OK`` last;
a failed capture or a wrong output exits non-zero. Run from the root of
a checkout on a CUDA card::

    python3 tools/sharded_graph_probe.py [--replays 1000] [--chain 100]
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


def log(msg: str) -> None:
    print(msg, flush=True)


def capture(fn, device):
    """``fn()`` captured as a CUDA graph on a side stream, thread-local."""
    import torch

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph


def replay_us(graph, per: int, replays: int = 20) -> float:
    """Device us per item of a graph holding ``per`` items: CUDA events
    around ``replays`` replays after one warm-up."""
    import torch

    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / (replays * per)


def host_us(fn, reps: int = 500) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def probe(group, device, M: int, replays: int, chain: int) -> dict:
    """The probe on one rank of ``group``; returns its measures."""
    import torch
    import torch.distributed as dist

    from simplex_tpu_torch.parallel import group as pg

    P = dist.get_world_size(group)
    rank = dist.get_rank(group)
    f64, i32 = torch.float64, torch.int32
    col = torch.zeros(M, dtype=torch.float32, device=device)
    send_v = torch.zeros(5, dtype=f64, device=device)
    send_i = torch.zeros(2, dtype=i32, device=device)
    recv_v = torch.zeros((P, 5), dtype=f64, device=device)
    recv_i = torch.zeros((P, 2), dtype=i32, device=device)
    require(pg.capturable(group, col), "the group is not capturable")
    # The communicator comes up lazily: bring it up outside any capture.
    pg.all_reduce(torch.ones(1, device=device), group)
    torch.cuda.synchronize()

    def body():
        col.add_(1.0)
        pg.all_reduce_(col, group)
        col.mul_(2.0)
        send_v.add_(1.0)
        pg.all_gather_into(recv_v, send_v, group)
        recv_v.mul_(3.0)
        send_i.add_(1)
        pg.all_gather_into(recv_i, send_i, group)
        recv_i.add_(7)

    t0 = time.perf_counter()
    with pg.CapturedCollectives() as colls:
        graph = capture(body, device)
    torch.cuda.synchronize()
    capture_ms = 1e3 * (time.perf_counter() - t0)
    require(dict(colls.counts) == {"all_reduce": 1, "all_gather": 2},
            f"the graph counted {dict(colls.counts)}")
    ranks = torch.arange(P, device=device)
    base = torch.arange(M, dtype=torch.float32, device=device)
    eager = torch.zeros(3, dtype=f64, device=device)
    for i in range(replays):
        col.copy_(base + (rank + i % 7))
        send_v.fill_(float(rank + i))
        send_i.fill_(rank * 100 + i)
        graph.replay()
        # Eager collectives on the same communicator between replays.
        eager.fill_(float(i))
        pg.all_reduce_(eager, group)
        got_g = pg.all_gather(torch.tensor(rank + i, device=device), group)
        want_col = (P * base + sum(r + i % 7 for r in range(P)) + P) * 2.0
        require(torch.equal(col, want_col), f"replay {i}: the all_reduce")
        require(torch.equal(recv_v, 3.0 * (ranks + i + 1.0).to(f64)[:, None]
                            .expand(P, 5)), f"replay {i}: the f64 gather")
        require(torch.equal(recv_i, (ranks * 100 + i + 8).to(i32)[:, None]
                            .expand(P, 2)), f"replay {i}: the int32 gather")
        require(bool((eager == P * i).all())
                and torch.equal(got_g, ranks + i),
                f"replay {i}: the eager collectives between replays")

    # A collective in a graph against one issued eagerly, and against a
    # one-element kernel in a graph.
    one = torch.zeros(1, device=device)
    chains = {
        f"all_reduce ({M},) f32": lambda: pg.all_reduce_(col, group),
        "all_gather (5,) f64": lambda: pg.all_gather_into(recv_v, send_v,
                                                          group),
        "all_gather (2,) int32": lambda: pg.all_gather_into(recv_i, send_i,
                                                            group),
        "one-element kernel": lambda: one.add_(1.0),
    }
    out = {"capture_ms": capture_ms, "replays": replays}
    for name, fn in chains.items():
        g = capture(lambda: [fn() for _ in range(chain)], device)
        out[f"graph us, {name}"] = replay_us(g, chain)
        out[f"eager host us, {name}"] = host_us(fn)
    return out


class ProbeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProbeFailure(msg)


def rank_main(group, device, M, replays, chain):
    return probe(group, device, M, replays, chain)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replays", type=int, default=1000)
    ap.add_argument("--chain", type=int, default=100)
    ap.add_argument("--m", type=int, default=8192,
                    help="the all_reduce's length (the flagship's M_pad)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sharded_graph_probe: torch.cuda is not available",
              file=sys.stderr)
        return 2
    from simplex_tpu_torch.parallel import group as pg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nccl = torch.cuda.nccl.version()
    if isinstance(nccl, tuple):
        nccl = ".".join(map(str, nccl))
    log(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}"
        f" NCCL {nccl}")
    cards = torch.cuda.device_count()
    try:
        with tempfile.TemporaryDirectory() as td, \
                pg.world(0, 1, "nccl", td) as group:
            out = probe(group, torch.device("cuda", 0), args.m,
                        args.replays, args.chain)
        log(f"1 NCCL rank: captured 1 all_reduce and 2 all_gathers in "
            f"{out.pop('capture_ms'):.2f} ms; {out.pop('replays')} replays, "
            "each output right, eager collectives between them")
        for name, v in out.items():
            log(f"1 NCCL rank: {name}: {v:.2f}")
        if cards > 1:
            outs = pg.spawn(rank_main, cards, "nccl", "cuda", args.m,
                            args.replays, args.chain)
            outs.pop("capture_ms")
            outs.pop("replays")
            for name, v in outs.items():
                log(f"{cards} NCCL ranks (rank 0): {name}: {v:.2f}")
    except (ProbeFailure, RuntimeError) as e:
        print(f"sharded_graph_probe: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(smi)
    print("SHARDED_GRAPH_PROBE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
