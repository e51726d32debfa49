"""Build and load the port's hand-written CUDA kernels.

The sources ``kernels/csrc/*.cu`` have a plain C interface (no PyTorch
headers): one ``nvcc`` per source, all started together, compiles them
in seconds, and one more links the objects into a shared library, which
``ctypes`` loads. The library lands in the package's gitignored
``_build`` directory under a name keyed by a hash of the sources, their
headers (``*.cuh``) and the flags: an edit to any of them rebuilds it, an
unchanged tree reuses it. A failed build raises with nvcc's stderr.

Nothing here runs at import time; ``load_library`` is called by the
kernel wrappers on their first CUDA launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin, /usr/local/cuda/bin);"
        " the CUDA kernels are built from source at first use")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; wait for all, then raise on the
    first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")


def build() -> pathlib.Path:
    """Compile the sources if the library for their hash is missing;
    returns the library's path."""
    lib_path = BUILD_DIR / f"libsimplex_kernels_{source_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [pathlib.Path(td) / f"{src.stem}.o" for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
        tmp = pathlib.Path(td) / lib_path.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
        os.replace(tmp, lib_path)    # atomic: a concurrent build is harmless
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

#: argtypes of every C entry point in csrc/*.cu.
SIGNATURES = {
    # Tt F C b h t M R eps ah workspace, its bytes, k p bk unb stream
    "ah_ratio_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P,
                        ctypes.c_longlong, _P, _P, _P, _P, _P],
    # Tt C F costs k t u do r eps M R
    "colk_costs_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _D, _I, _I,
                          # ah b base h p bk w workspace, its bytes
                          _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                          # four candidates, stream
                          _P, _P, _P, _P, _P],
    "apply_reprice_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "apply_window_launch": [_P, _P, _P, _I, _I, _I, _P],
    # Tt F C h t M R ah stream
    "ah_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # Tt M R coeffs part mv stream
    "reprice_launch": [_P, _I, _I, _P, _P, _P, _P],
    # csrc/batched.cu: Tt costs b z base w sci c0 cf C F AH piv nlive,
    # B M R L r eps bland_static threshold, the plan (cs vec res_c res_f
    # smem), stream
    "batch_window_launch": [_P] * 14 + [_I, _I, _I, _I, _I, _D, _I, _I,
                                        _I, _I, _I, _I, ctypes.c_longlong,
                                        _P],
    # Tt F C B M R L nlive stream
    "batch_apply_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # Tt F C B M R L nlive do_r cf part mv stream
    "batch_apply_reprice_launch": [_P, _P, _P, _I, _I, _I, _I,
                                   _P, _P, _P, _P, _P, _P],
    # Tt B M R flags cf part mv stream
    "batch_reprice_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    # csrc/pivot.cu: Tt costs colk ah p minc k do, M R r eps, four
    # partials, four candidates, stream
    "fused_pivot_launch": [_P] * 8 + [_I, _I, _I, _F] + [_P] * 9,
    # Tt factor colk do B M R stream
    "batch_rank1_f64_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    "batch_rank1_f32_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def load_library() -> ctypes.CDLL:
    """Build on first use (thread-safe) and bind the entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [_I]
            lib.kernel_error_string.restype = ctypes.c_char_p
            # M R cs devex vec res_c res_f -> bytes
            lib.batch_window_smem_bytes.argtypes = [_I] * 7
            lib.batch_window_smem_bytes.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
