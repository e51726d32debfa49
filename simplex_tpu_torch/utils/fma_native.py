"""ctypes wrapper around the fma-faithful oracle update
(``simplex_tpu_torch/native/fma_update.cpp``, the port's own copy of the
JAX package's helper).

The reference GPU's rank-1 pivot update rounds each element once
(hardware fma, src/solver.cu:43,55); NumPy/BLAS host updates round the
product and the subtraction separately. A rank-1 update has no
accumulation order, so that single rounding is the only arithmetic gap
between the GPU and a host replay; these routines close it
(``oracle.solve_oracle(update_rule="fma")``). Compiled on first use with
the system C++ compiler into the port's build directory (``_build/``,
keyed by a hash of the source). ``available()`` is False when the build
fails; callers that asked for the fma update then raise rather than take
the BLAS path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = (pathlib.Path(__file__).resolve().parents[1] / "native"
        / "fma_update.cpp")
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_LIB: ctypes.CDLL | None = None
_BUILD_FAILED = False

_F64P = ctypes.POINTER(ctypes.c_double)


def _build_library() -> ctypes.CDLL | None:
    global _BUILD_FAILED
    if _BUILD_FAILED:
        return None
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = _BUILD_DIR / f"libfma_{digest}.so"
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
                tmp = os.path.join(td, lib_path.name)
                # -march=native lowers std::fma to the hardware vfmadd;
                # the libm call it replaces is bit-identical, so a host
                # that refuses the flag builds without it.
                base = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                        tmp]
                try:
                    subprocess.run(base[:2] + ["-march=native"] + base[2:],
                                   check=True, capture_output=True)
                except subprocess.CalledProcessError:
                    subprocess.run(base, check=True, capture_output=True)
                os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.CalledProcessError):
        _BUILD_FAILED = True
        return None
    lib.pivot_update_fma.argtypes = [_F64P, _F64P, _F64P, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_double]
    lib.axpy_fma.argtypes = [_F64P, _F64P, ctypes.c_double, ctypes.c_int64]
    lib.fma_scalar.argtypes = [ctypes.c_double] * 3
    lib.fma_scalar.restype = ctypes.c_double
    return lib


def _library() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is None:
        _LIB = _build_library()
    return _LIB


def available() -> bool:
    return _library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F64P)


def pivot_update_fma(T: np.ndarray, colk: np.ndarray, factor: np.ndarray,
                     k: int, p: float) -> None:
    """In place: ``T[i, j] = fma(-factor[j], colk[i], T[i, j])`` for j !=
    k; ``T[:, k] = colk / p``. T must be C-contiguous float64."""
    assert T.flags.c_contiguous and T.dtype == np.float64
    rows, cols = T.shape
    _library().pivot_update_fma(_ptr(T), _ptr(np.ascontiguousarray(colk)),
                                _ptr(np.ascontiguousarray(factor)),
                                rows, cols, int(k), float(p))


def axpy_fma(x: np.ndarray, v: np.ndarray, a: float) -> None:
    """In place: ``x[i] = fma(a, v[i], x[i])``."""
    assert x.flags.c_contiguous and x.dtype == np.float64
    _library().axpy_fma(_ptr(x), _ptr(np.ascontiguousarray(v)), float(a),
                        x.size)


def fma_scalar(a: float, b: float, c: float) -> float:
    """Correctly rounded ``a*b + c`` (``math.fma`` needs Python 3.13)."""
    return float(_library().fma_scalar(float(a), float(b), float(c)))
