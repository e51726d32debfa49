"""ctypes wrapper around the native XORWOW generator.

Bit-exact cuRAND XORWOW, so the seed-file benchmark instances regenerate
identically to the JAX package's (and therefore carry the same certified
objectives). The C++ source is ``simplex_tpu_torch/native/xorwow.cpp``,
the port's own copy of the JAX package's; the shared library is built on
first use with the system C++ compiler into the port's build directory
(keyed by a hash of the source). Without a compiler the pure-Python
generator answers instead (same bits, ~1000x slower).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import warnings

import numpy as np

_SRC = (pathlib.Path(__file__).resolve().parents[1] / "native"
        / "xorwow.cpp")
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_LIB: ctypes.CDLL | None = None
_BUILD_FAILED = False


def _build_library() -> ctypes.CDLL | None:
    global _BUILD_FAILED
    if _BUILD_FAILED:
        return None
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = _BUILD_DIR / f"libxorwow_{digest}.so"
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
                tmp = os.path.join(td, lib_path.name)
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                                "-o", tmp], check=True, capture_output=True)
                os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.CalledProcessError) as e:
        detail = ""
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            detail = ": " + e.stderr.decode(errors="replace").strip()
        warnings.warn(
            f"native XORWOW build failed ({e.__class__.__name__}{detail}); "
            "falling back to the pure-Python generator, which is ~1000x "
            "slower", RuntimeWarning, stacklevel=3)
        _BUILD_FAILED = True
        return None
    lib.xorwow_uniform.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.POINTER(ctypes.c_double)]
    lib.xorwow_uniform.restype = None
    return lib


def _library() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is None:
        _LIB = _build_library()
    return _LIB


def _init_state(seed: int) -> tuple[list[int], int]:
    mask = 0xFFFFFFFF
    s0 = (seed & mask) ^ 0xAAD26B49
    s1 = ((seed >> 32) & mask) ^ 0xF7DCEFDD
    t0 = (1099087573 * s0) & mask
    t1 = (2591861531 * s1) & mask
    v = [(123456789 + t0) & mask, (362436069 ^ t0) & mask,
         (521288629 + t1) & mask, (88675123 ^ t1) & mask,
         (5783321 + t0) & mask]
    d = (6615241 + t1 + t0) & mask
    return v, d


def xorwow_raw_py(seed: int, count: int) -> np.ndarray:
    """Pure-Python XORWOW (cuRAND's default generator)."""
    mask = 0xFFFFFFFF
    v, d = _init_state(seed)
    out = np.empty(count, dtype=np.uint32)
    for i in range(count):
        t = v[0] ^ (v[0] >> 2)
        v[0], v[1], v[2], v[3] = v[1], v[2], v[3], v[4]
        v[4] = ((v[4] ^ ((v[4] << 4) & mask)) ^ (t ^ ((t << 1) & mask))) \
            & mask
        d = (d + 362437) & mask
        out[i] = (v[4] + d) & mask
    return out


def _uniform_from_raw(raw: np.ndarray, lo: float, hi: float) -> np.ndarray:
    inv = np.float32(2.3283064e-10)
    u = raw.astype(np.float32) * inv + inv / np.float32(2.0)
    return u.astype(np.float64) * (hi - lo) + lo


def xorwow_uniform(seed: int, count: int, lo: float, hi: float) -> np.ndarray:
    """float32 curand_uniform in (0, 1], scaled in double to [lo, hi)."""
    lib = _library()
    if lib is None:
        return _uniform_from_raw(xorwow_raw_py(seed, count), lo, hi)
    out = np.empty(count, dtype=np.float64)
    lib.xorwow_uniform(seed, count, float(lo), float(hi),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
