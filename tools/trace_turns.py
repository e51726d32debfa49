#!/usr/bin/env python3
"""``chip_smoke.py``'s trace phases from several checkouts in turns.

Each ``--root`` is a checkout of the repository (this one by default, or
another commit unpacked with ``git archive``); the script runs one
process a root, in the order given, from that root: it builds that
checkout's kernels, then runs each ``--phase`` of that checkout's
``chip_smoke.py`` in order, which prints what it traced (a replayed
window's or chunk's kernels by name in microseconds a pivot, its span,
the device's busy share)::

    python3 tools/trace_turns.py --phase phase_sharded_seq_trace \\
        --phase phase_sharded_trace \\
        --root _checkout/parent --root . --root . --root _checkout/parent

Needs a CUDA card: a process that finds none exits non-zero, and so does
this script.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

#: The child: the root's kernels, then its phases by name.
CHILD = ("import sys\n"
         "sys.path.insert(0, '.')\n"
         "import torch\n"
         "if not torch.cuda.is_available():\n"
         "    sys.exit('trace_turns: no CUDA card')\n"
         "import chip_smoke\n"
         "from simplex_tpu_torch.kernels import _build\n"
         "_build.build()\n"
         "_build.load_library()\n"
         "print(chip_smoke.nvidia_smi_line(), flush=True)\n"
         "for name in sys.argv[1:]:\n"
         "    getattr(chip_smoke, name)()\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="a checkout to run (repeatable; default: .)")
    ap.add_argument("--phase", action="append", required=True,
                    help="a trace phase of chip_smoke.py (repeatable)")
    args = ap.parse_args()
    for root in args.root or ["."]:
        path = pathlib.Path(root).resolve()
        print(f"root {root} {path / 'chip_smoke.py'}", flush=True)
        done = subprocess.run([sys.executable, "-c", CHILD, *args.phase],
                              cwd=path)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
