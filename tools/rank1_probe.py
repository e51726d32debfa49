#!/usr/bin/env python3
"""How the rank-1 update ``T - f (x) c`` rounds, on the CPU and on the
card, and what the batched fallback's ``batch_rank1`` kernel costs.

1. Rounding. For each device (the CPU, then the card) and each of f64
   and f32, lanes of random ``T (B, M, R)``, ``f (B, M)`` and ``c (B, R)``
   are updated by ``addr_`` a lane (what the single-LP ``solve`` calls),
   and the script counts the elements where each of these differs from
   it: ``T - f * c`` in two torch ops (the product and the difference
   rounded apart), ``addcmul_`` and ``baddbmm_`` over all lanes, the
   kernel (on the card), and, for lane 0 in f64, one FMA an element
   (``utils.fma_native``, the reference CUDA program's rounding).
2. Time, on the card: ``batch_rank1`` on config 3's f64 phase-1 tableau
   (256 x 512 x 3,000, every lane live, its 16-byte vector tile), the
   same at R = 2,999 (the scalar tile), and ``addcmul_``, by CUDA events
   over 10 calls, in turns (kernel, scalar, addcmul_, addcmul_, scalar,
   kernel).

Run from the root of a checkout on a machine with a card::

    python3 tools/rank1_probe.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from simplex_tpu_torch.kernels import pivot as kp  # noqa: E402
from simplex_tpu_torch.utils import fma_native  # noqa: E402


def rounding(dev: torch.device, dtype: torch.dtype) -> dict:
    g = torch.Generator().manual_seed(1)
    B, M, R = 8, 512, 3000

    def rand(shape, scale):
        return ((torch.rand(shape, generator=g, dtype=torch.float64) * 2
                 - 1) * scale).to(dtype).to(dev)

    T0, f, c = rand((B, M, R), 100.0), rand((B, M), 1.0), rand((B, R), 100.0)
    ref = T0.clone()
    for i in range(B):
        ref[i].addr_(f[i], c[i], alpha=-1.0)
    outs = {"mul then sub": T0 - f[:, :, None] * c[:, None, :]}
    t = T0.clone()
    outs["addcmul_"] = t.addcmul_(f[:, :, None], c[:, None, :], value=-1.0)
    t = T0.clone()
    outs["baddbmm_"] = t.baddbmm_(f[:, :, None], c[:, None, :], alpha=-1.0)
    if dev.type == "cuda":
        t = T0.clone()
        kp.batch_rank1(t, f, c, torch.ones(B, dtype=torch.bool, device=dev))
        outs["batch_rank1"] = t
    counts = {k: int((v != ref).sum()) for k, v in outs.items()}
    if dtype == torch.float64 and fma_native.available():
        # T[i, j] = fma(-f[i], c[j], T[i, j]) for lane 0: the helper's
        # (rows, cols) layout with colk = f[0] and factor = c[0]; its
        # column k is rewritten, so column 0 is left out of the count.
        one = T0[0].cpu().numpy().copy()
        fma_native.pivot_update_fma(one, f[0].cpu().numpy(),
                                    c[0].cpu().numpy(), 0, 1.0)
        counts["one FMA (lane 0)"] = int(
            (one[:, 1:] != ref[0].cpu().numpy()[:, 1:]).sum())
    return counts


def timing() -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, M, R = 256, 512, 3000
    live = torch.ones(B, dtype=torch.bool, device=dev)
    cases = {}
    for name, r in (("vector tile", R), ("scalar tile", R - 1)):
        T = torch.rand((B, M, r), generator=g, device=dev,
                       dtype=torch.float64)
        f = torch.rand((B, M), generator=g, device=dev, dtype=torch.float64)
        c = torch.rand((B, r), generator=g, device=dev, dtype=torch.float64)
        cases[name] = (T, f, c)
    T, f, c = cases["vector tile"]
    fns = {
        "vector tile": lambda: kp.batch_rank1(*cases["vector tile"], live),
        "scalar tile": lambda: kp.batch_rank1(*cases["scalar tile"], live),
        "addcmul_": lambda: T.addcmul_(f[:, :, None], c[:, None, :],
                                       value=-1.0),
    }
    times: dict = {k: [] for k in fns}
    for name in ("vector tile", "scalar tile", "addcmul_", "addcmul_",
                 "scalar tile", "vector tile"):
        fn = fns[name]
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times[name].append(round(start.elapsed_time(end) / 10, 4))
    return times


def main() -> int:
    print("cpu", {str(dt): rounding(torch.device("cpu"), dt)
                  for dt in (torch.float64, torch.float32)}, flush=True)
    if not torch.cuda.is_available():
        print("no CUDA card: the card's part is not run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    print("cuda", {str(dt): rounding(torch.device("cuda"), dt)
                   for dt in (torch.float64, torch.float32)}, flush=True)
    B, M, R = 256, 512, 3000
    print(f"ms a call at B={B} M={M} R={R} f64 (scalar tile: R={R - 1}), "
          f"CUDA events over 10 calls, in turns: {timing()}; bound "
          f"{1e3 * 16 * B * M * R / 3.35e12:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
