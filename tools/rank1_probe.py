#!/usr/bin/env python3
"""How the rank-1 update ``T - f (x) c`` rounds, on the CPU and on the
card, and what the batched fallback's ``batch_rank1`` kernel costs under
each design.

1. Rounding. For each device (the CPU, then the card) and each of f64
   and f32, lanes of random ``T (B, M, R)``, ``f (B, M)`` and ``c (B, R)``
   are updated by ``addr_`` a lane (what the single-LP ``solve`` calls),
   and the script counts the elements where each of these differs from
   it: ``T - f * c`` in two torch ops (the product and the difference
   rounded apart), ``addcmul_`` and ``baddbmm_`` over all lanes, the
   kernel (on the card), and, for lane 0 in f64, one FMA an element
   (``utils.fma_native``, the reference CUDA program's rounding).
2. Designs, on the card. ``tools/rank1_variants.cu`` is built (nvcc,
   its registers and spills printed) and each design runs on four f64
   cases: config 3's phase-1 tableau of the default options (256 x 512 x
   3,000) with every lane live and with a quarter live (every fourth
   lane), R = 2,999 (rows that are not whole 16-byte vectors), and the
   wide batch's phase 1 (32 x 512 x 15,000). Designs (their list is at
   the head of tools/rank1_variants.cu): the kernel the shipped one
   replaced (``old``), the shipped kernel under ``rank1_plan``
   (``shipped``) and at each tile width, with streaming cache hints
   (``hinted``), persistent blocks walking the live tiles statically or
   claiming them from a counter (``persistent``), the bulk-copy ring
   (``bulk``), and ``addcmul_`` over all lanes. Each is checked bit for
   bit against the plain version (``addr_`` a live lane) on the same
   input, then timed by CUDA events over 10 calls, the designs in turns
   (the list forward, then backward).

Run from the root of a checkout on a machine with a card::

    python3 tools/rank1_probe.py
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

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


def build_variants() -> ctypes.CDLL:
    """nvcc tools/rank1_variants.cu into a temporary shared library."""
    from simplex_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path

    out = pathlib.Path(tempfile.mkdtemp()) / "librank1_variants.so"
    done = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(out), str(ROOT / "tools" / "rank1_variants.cu")],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stderr}")
    name = ""
    for line in done.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and "rank1" in name:
            print(f"ptxas {name}: {line.split(':', 1)[1].strip()}",
                  flush=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"old_rank1_launch": [P, P, P, P, I, I, I, I, P],
            "persistent_rank1_launch": [P, P, P, P, I, I, I, I, I, I, P, P],
            "bulk_rank1_launch": [P, P, P, P, I, I, I, I, I, I, I, P],
            "hinted_rank1_launch": [P, P, P, P, I, I, I, I, I, P],
            "tiles_rank1_launch": [P, P, P, P, I, I, I, I, I, P]}
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


def designs(lib: ctypes.CDLL, B: int, M: int, R: int) -> dict:
    """name -> fn(T, f, c, do) for every design at one shape (f64)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctr = torch.zeros(1, dtype=torch.int64, device="cuda")

    def ptrs(T, f, c, do):
        return [ctypes.c_void_p(x.data_ptr()) for x in (T, f, c, do)]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    out = {"old": lambda T, f, c, do: run(lib.old_rank1_launch(
        *ptrs(T, f, c, do), B, M, R, 8, stream()), "old"),
        "shipped": kp.batch_rank1}
    for vecs in (2, 4, 8):
        out[f"shipped vecs={vecs}"] = (
            lambda T, f, c, do, v=vecs: run(lib.tiles_rank1_launch(
                *ptrs(T, f, c, do), B, M, R, 8, v, stream()), "tiles"))
    out["hinted vecs=4"] = lambda T, f, c, do: run(lib.hinted_rank1_launch(
        *ptrs(T, f, c, do), B, M, R, 8, 4, stream()), "hinted")
    for vecs, per_sm, dyn in ((4, 2, False), (4, 4, False), (8, 2, False),
                              (4, 2, True), (4, 4, True), (8, 2, True)):
        def persistent(T, f, c, do, v=vecs, g=per_sm * sms, dyn=dyn):
            if dyn:
                ctr.zero_()
            run(lib.persistent_rank1_launch(
                *ptrs(T, f, c, do), B, M, R, 8, v, g,
                ctypes.c_void_p(ctr.data_ptr() if dyn else 0), stream()),
                "persistent")
        walk = "dynamic" if dyn else "static"
        out[f"persistent {walk} vecs={vecs} {per_sm}/SM"] = persistent
    for stages, kb, per_sm in ((8, 16, 1), (3, 32, 2)):
        out[f"bulk {stages} x {kb} KB {per_sm}/SM"] = (
            lambda T, f, c, do, s=stages, v=kb * 64, g=per_sm * sms: run(
                lib.bulk_rank1_launch(*ptrs(T, f, c, do), B, M, R, 8, s, v,
                                      g, stream()), "bulk"))
    out["addcmul_"] = lambda T, f, c, do: T.addcmul_(
        f[:, :, None], c[:, None, :], value=-1.0)
    return out


def timing(lib: ctypes.CDLL) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    cases = (("config-3 f64, every lane live", (256, 512, 3000), 1),
             ("config-3 f64, a quarter live", (256, 512, 3000), 4),
             ("R = 2,999", (256, 512, 2999), 1),
             ("wide f64 phase 1", (32, 512, 15000), 1))
    for label, (B, M, R), every in cases:
        T0 = torch.rand((B, M, R), generator=g, device=dev,
                        dtype=torch.float64) * 200 - 100
        f = torch.rand((B, M), generator=g, device=dev,
                       dtype=torch.float64) * 2 - 1
        c = torch.rand((B, R), generator=g, device=dev,
                       dtype=torch.float64) * 200 - 100
        do = torch.arange(B, device=dev) % every == 0
        want = T0.clone()
        kp.batch_rank1_plain(want, f, c, do)
        fns = designs(lib, B, M, R)
        diff = {}
        T = torch.empty_like(T0)
        for name, fn in fns.items():
            T.copy_(T0)
            fn(T, f, c, do)
            torch.cuda.synchronize()
            diff[name] = int((T != want).sum())
        del want
        times: dict = {k: [] for k in fns}
        for name in [*fns, *reversed(fns)]:
            fn = fns[name]
            fn(T, f, c, do)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                fn(T, f, c, do)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 10)
        live = int(do.sum())
        bound = 16 * live * M * R / 3.35e12 * 1e3
        print(f"{label}: B={B} M={M} R={R}, {live} lanes live, plan "
              f"{kp.rank1_plan(B, M, R, 8)}, bound {bound:.4f} ms "
              "(the live lanes' bytes / 3.35 TB/s)", flush=True)
        for name in fns:
            ms = times[name]
            print(f"  {name:34s} {ms[0]:.4f} / {ms[1]:.4f} ms "
                  f"({100 * bound / min(ms):.0f}% of the bound); elements "
                  f"differing from the plain version: {diff[name]}",
                  flush=True)
        del T0, T, f, c
        torch.cuda.empty_cache()


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
    timing(build_variants())
    return 0


if __name__ == "__main__":
    sys.exit(main())
