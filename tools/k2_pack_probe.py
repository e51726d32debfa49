#!/usr/bin/env python3
"""The sharded K2's pack tail on the card: the shipped form and the two
it was chosen over, against the two nodes it replaced, bit for bit, then
timed.

``tools/k2_pack_variants.cu`` is built (nvcc, the registers of each
kernel printed) into a shared library whose one entry point launches K2
with the step after K2 as its tail (the sharded loop's, at offset 0 with
the weight at h given) in one of four modes: no pack (mode 0); the pack
with the weights at the candidates carried through K2's partials and
fold (mode 1); loaded once the fold is done, before the last block's
stores (mode 2); loaded in the pack, after the last block's store of
w[h] (mode 3: ``csrc/blocked.cu``'s ``colk_costs_fused<true, true>``,
what the port launches). The ways compared:

* ``chain``: mode 0, then the port's ``sharded_pack`` kernel (the two
  nodes a pivot that the sharded window held before the pack tail);
* ``plain``: mode 0, then ``sharded_pack_plain``;
* ``carried``, ``early`` and ``shipped``: modes 1, 2 and 3, one node
  each.

States, at the sharded flagship's shapes at one rank (M = 8,192, R =
24,576, L = 128, t = 37 live eta rows), under devex and Dantzig: a taken
pivot over random costs and weights ("seeded"); a skipped one with NaN
weights on a third of the columns and at column 0 ("nan_weights"); a
skipped one with every cost positive ("no_eligible": h_d is 0 and the
weight there w[0]); a taken one whose entering column h stays by far
the most negative cost and the first eligible one ("h_candidate": both
candidates are h, whose new weight K2's last block stores); a skipped
one with equal costs and weights at columns 10 and 6,410 ("tie", R
blocks 0 and 100). Every way's send buffers, scalars and vectors must
equal the chain's, a NaN equal to a NaN.

Times: us a call of each way by CUDA events around 20 replays of a CUDA
graph of 50 calls on the seeded devex state, the ways in turns (forward,
then backward), three rounds; mode 0 alone too, so that each pack's own
cost is its time less mode 0's.

Run from the root of a checkout on a machine with a card::

    python3 tools/k2_pack_probe.py
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from simplex_tpu_torch.kernels import _build  # noqa: E402
from simplex_tpu_torch.kernels import blocked as kb  # noqa: E402

M, R, L, T = 8192, 24576, 128, 37
EPS, MAX_ITER = 1e-4, 2 ** 30
CASES = ("seeded", "nan_weights", "no_eligible", "h_candidate", "tie")
H = 12345
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: k2_pack_variant_launch: Tt C F costs k t u do r eps M R ah b base h p
#: bk w offset wh ws ws_bytes, four candidates, send_v send_i, the step's
#: pointers (by reference), max_iter, mode, stream.
ARGTYPES = ([_P] * 5 + [_I, _P, _P, _I, _D, _I, _I] + [_P] * 7
            + [_I, _P, _P, ctypes.c_longlong] + [_P] * 6
            + [_P, ctypes.c_longlong, _I, _P])
#: The carried form's workspace (``carry_ws_bytes``): 16 + 40 bytes a
#: block of 64 columns, 8 more a block than the port's K2 takes.
WS_BYTES = 16 + 40 * (R // 64)
MODES = {"K2+tail": 0, "carried": 1, "early": 2, "shipped": 3}
KERNELS = {"colk_costs_fusedILb1ELb0E": "mode 0 (K2+tail)",
           "colk_pack_variantILb1E": "mode 1 (carried)",
           "colk_pack_variantILb0E": "mode 2 (early)",
           "colk_costs_fusedILb1ELb1E": "mode 3 (shipped)"}


def build_variants() -> ctypes.CDLL:
    """nvcc tools/k2_pack_variants.cu into a shared library under the
    package's build directory; prints each mode's registers."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    td = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    out = pathlib.Path(td) / "libk2_pack_variants.so"
    done = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-o", str(out), str(ROOT / "tools" / "k2_pack_variants.cu")],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stderr}")
    lines = done.stderr.splitlines()
    for i, line in enumerate(lines):
        form = [v for n, v in KERNELS.items() if n in line]
        if "Compiling entry function" in line and form:
            props = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "stack frame" in x or "Used" in x]
            print(f"{form[0]}: " + "; ".join(props))
    lib = ctypes.CDLL(str(out))
    lib.k2_pack_variant_launch.argtypes = ARGTYPES
    lib.k2_pack_variant_launch.restype = _I
    return lib


def state(case: str, devex: bool, Tt, seed: int) -> dict:
    """One K2 call's operands and scalars on the card (see the module's
    docstring for the cases)."""
    dev = Tt.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def uni(shape, lo, hi, dtype=torch.float32):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=dtype) * (hi - lo) + lo

    C, F = uni((L, R), -1.0, 1.0), uni((L, M), -0.1, 0.1)
    C[T:] = 0
    F[T:] = 0
    costs, w = uni((R,), -1.0, 1.0, torch.float64), uni((R,), 1.0, 3.0)
    ah = uni((M,), -1.0, 1.0)
    k = 1234
    ah[k] = 0.9
    do = case in ("seeded", "h_candidate")
    if case == "nan_weights":
        w[uni((R,), 0.0, 1.0) < 1 / 3] = float("nan")
        w[0] = float("nan")
    elif case == "no_eligible":
        costs = costs.abs() + 0.1
    elif case == "h_candidate":
        costs[:H] = 20.0
        costs[H] = -50.0
    elif case == "tie":
        costs[[10, 6410]] = -3.0
        w[[10, 6410]] = 2.0
    s = kb.sharded_scalars(torch.zeros((), dtype=torch.float64,
                                       device=dev), False)
    p = float(ah[k])
    for name, v in dict(status=int(kb.RUNNING), iterations=3, stall=4,
                        active=True, optimal=False, unb=0, do=do, k=k, h=H,
                        p=p if do else 1.0, u=-0.7 / p if do else 0.0,
                        bk=0.25, wh=float(w[H]) if devex else 1.0).items():
        getattr(s, name).fill_(v)
    return dict(C=C, F=F, costs=costs, w=w if devex else None, ah=ah,
                b=uni((M,), 0.0, 10.0, torch.float64),
                base=torch.randint(0, R, (M,), generator=g, device=dev,
                                   dtype=torch.int32), s=s)


def copy(x0: dict) -> dict:
    """Fresh copies of a state's tensors and scalars, a zeroed workspace
    and send buffers."""
    x = {n: None if v is None else v.clone() for n, v in x0.items()
         if n != "s"}
    x["s"] = kb.ShardedScalars(**{n: v.clone()
                                  for n, v in x0["s"].tensors().items()})
    dev = x["C"].device
    x["ws"] = torch.zeros(WS_BYTES, dtype=torch.uint8, device=dev)
    x["send_v"] = torch.full((2 if x["w"] is None else 5,), -7.0,
                             dtype=torch.float64, device=dev)
    x["send_i"] = torch.full((2,), -7, dtype=torch.int32, device=dev)
    return x


def launch(lib, Tt, x: dict, mode: int, ptrs) -> None:
    s = x["s"]

    def ptr(v):
        return _P(0 if v is None else v.data_ptr())

    pack = mode != 0
    err = lib.k2_pack_variant_launch(
        ptr(Tt), ptr(x["C"]), ptr(x["F"]), ptr(x["costs"]), ptr(s.k), T,
        ptr(s.u), ptr(s.do), R - 100, EPS, M, R, ptr(x["ah"]), ptr(x["b"]),
        ptr(x["base"]), ptr(s.h), ptr(s.p), ptr(s.bk), ptr(x["w"]), 0,
        ptr(None if x["w"] is None else s.wh), ptr(x["ws"]), WS_BYTES,
        ptr(s.h_d), ptr(s.v_d), ptr(s.h_b), ptr(s.v_b),
        ptr(x["send_v"] if pack else None), ptr(x["send_i"] if pack
                                                 else None),
        ctypes.byref(ptrs), MAX_ITER, mode,
        _P(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"k2_pack_variant_launch mode {mode}: CUDA "
                           f"error {err}")


def way(lib, Tt, x: dict, name: str):
    """A callable running one way on ``x`` (the step pointers bound
    once)."""
    ptrs = kb._step_ptrs(x["s"])
    s = x["s"]
    if name in ("chain", "plain"):
        pack = kb.sharded_pack if name == "chain" else kb.sharded_pack_plain

        def fn():
            launch(lib, Tt, x, 0, ptrs)
            pack(s, x["w"], 0, x["send_v"], x["send_i"])
        return fn
    return lambda: launch(lib, Tt, x, MODES[name], ptrs)


def same(a, b) -> bool:
    return a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
        if a.is_floating_point() else torch.equal(a, b))


def check(lib, Tt) -> None:
    n = 0
    for devex in (True, False):
        for i, case in enumerate(CASES):
            x0 = state(case, devex, Tt, 100 + i)
            runs = {}
            for name in ("chain", "plain", "carried", "early", "shipped"):
                x = copy(x0)
                way(lib, Tt, x, name)()
                runs[name] = x
            torch.cuda.synchronize()
            ref = runs["chain"]
            for name, x in runs.items():
                for field in ("C", "F", "costs", "w", "b", "base", "send_v",
                              "send_i"):
                    if ref[field] is not None:
                        assert same(x[field], ref[field]), (
                            case, devex, name, field, x[field], ref[field])
                for field, v in x["s"].tensors().items():
                    assert same(v, getattr(ref["s"], field)), (
                        case, devex, name, field)
            s = ref["s"]
            print(f"{case} {'devex' if devex else 'dantzig'}: do "
                  f"{int(s.do)}, h_d {int(s.h_d)}, h_b {int(s.h_b)}; send_v "
                  f"{ref['send_v'].tolist()}; chain, plain, carried, early "
                  "and shipped bit for bit")
            if case == "h_candidate":
                assert int(s.h_d) == int(s.h_b) == H
            elif case == "tie":
                assert int(s.h_d) == 10
            elif case == "no_eligible":
                assert int(s.h_b) == kb.BIG_INDEX
            n += 1
    print(f"{n} states: every way equals the chain bit for bit")


def graph_us(fn, calls: int = 50, replays: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / (calls * replays)


def timing(lib, Tt) -> None:
    names = ("K2+tail", "chain", "carried", "early", "shipped")
    x0 = state("seeded", True, Tt, 7)
    fns = {name: way(lib, Tt, copy(x0), name) for name in names}
    us = {name: [] for name in names}
    for _ in range(3):
        for name in names + names[::-1]:
            us[name].append(graph_us(fns[name]))
    mean = {name: statistics.mean(v) for name, v in us.items()}
    for name in names:
        print(f"{name}: " + ", ".join(f"{v:.3f}" for v in us[name])
              + f" us a call (mean {mean[name]:.3f}; less K2+tail "
              f"{mean[name] - mean['K2+tail']:+.3f})")


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_pack_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    lib = build_variants()
    _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(3)
    Tt = torch.rand((M, R), generator=g, device="cuda") * 2 - 1
    check(lib, Tt)
    timing(lib, Tt)
    print("K2_PACK_PROBE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
