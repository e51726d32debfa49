"""How often torch.profiler hands back an empty session on the card.

``chip_smoke.py`` counts the kernels one call launches, and times kernels,
from torch.profiler (CUPTI) sessions that each hold one call or a few.
This probe runs many such sessions of one short call (seven small copies
and one elementwise kernel) and counts the sessions that recorded no event
on the card at all and those that recorded some but missed the kernel. It
alternates blocks of back-to-back sessions with blocks whose sessions
pause 50 ms after their start and before their end.

    python3 tools/profiler_probe.py   (on a machine with the card; ~1 min)

Prints the card's name and power limit, then one line a block and a JSON
summary last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=200,
                    help="sessions a block without pauses (half that with)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          flush=True)
    x = torch.zeros(1 << 20, device="cuda")
    ys = [torch.zeros(4096, device="cuda") for _ in range(7)]
    y0 = torch.ones(4096, device="cuda")

    def fn():
        for y in ys:
            y.copy_(y0)
        x.add_(1)

    def session(pause: float) -> tuple[int, int]:
        """(events on the card, of them the elementwise kernel)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            fn()
            torch.cuda.synchronize()
            time.sleep(pause)
        ev = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        return (sum(c for _, c in ev),
                sum(c for k, c in ev if "elementwise" in k.lower()))

    blocks = []
    for _ in range(args.rounds):
        for pause, n in ((0.0, args.sessions),
                         (0.05, max(1, args.sessions // 2))):
            empty = missed = 0
            t0 = time.perf_counter()
            for _ in range(n):
                events, kernel = session(pause)
                empty += events == 0
                missed += events > 0 and kernel != 1
            blocks.append({"pause_s": pause, "sessions": n, "empty": empty,
                           "missed_kernel": missed,
                           "s": time.perf_counter() - t0})
            print(f"pause {pause} s: {n} sessions, {empty} empty, {missed} "
                  f"with events but without the kernel "
                  f"({blocks[-1]['s']:.1f} s)", flush=True)
    print(json.dumps({"blocks": blocks,
                      "empty": sum(b["empty"] for b in blocks),
                      "sessions": sum(b["sessions"] for b in blocks)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
