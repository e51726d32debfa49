"""The port's ``compare`` and ``generate_random_problem_device`` on the
CPU: ``compare`` equal to ``simplex_tpu.config.compare`` over a grid that
crosses the eps boundary in both signs; the device generator with the
contract of tests/test_generator.py:57-74 (the 'msvc' sub-seeds by
default, flavor-sensitive, deterministic) and its shapes, dtypes and
half-open range. Its stream is ``torch.Generator``'s, so its values are
not compared with the JAX package's (threefry) or the host path's
(XORWOW)."""

import inspect

import numpy as np
import pytest
import torch

import simplex_tpu_torch as pst
from simplex_tpu.config import compare as jax_compare
from simplex_tpu_torch.utils.crand import derive_subseeds

EPS = 1e-9


@pytest.mark.parametrize("x,y,eps", [
    (0.0, 0.0, EPS), (1.0, 1.0, EPS),
    (EPS / 2, 0.0, EPS), (-EPS / 2, 0.0, EPS),
    (EPS, 0.0, EPS), (-EPS, 0.0, EPS),          # |x - y| == eps: not equal
    (2 * EPS, 0.0, EPS), (-2 * EPS, 0.0, EPS),
    (1.0, 1.0 + 5e-10, EPS), (1.0, 1.0 + 2e-9, EPS),
    (-3.0, 2.0, EPS), (3.0, -2.0, EPS),
    (0.5, 0.4, 0.2), (0.4, 0.5, 0.05),
    (np.float64(1e-4), 0.0, 1e-4), (np.float32(-1e-5), 0.0, 1e-4),
])
def test_compare_matches_jax(x, y, eps):
    assert pst.compare(x, y, eps) == jax_compare(x, y, eps)
    assert pst.compare(x, y, eps) in (-1, 0, 1)


def test_compare_defaults():
    assert pst.compare(EPS / 2) == jax_compare(EPS / 2) == 0
    assert pst.compare(-1.0) == -1 and pst.compare(1.0) == 1


def _gen(*args, **kw):
    return pst.generate_random_problem_device(*args, device="cpu", **kw)


def test_device_generator_subseed_flavor_matches_host():
    """The 'msvc' sub-seeds by default, as the host path; flavor-sensitive
    and deterministic (tests/test_generator.py:57-74)."""
    sig = inspect.signature(pst.generate_random_problem_device)
    assert sig.parameters["rand_flavor"].default == "msvc"
    assert sig.parameters["device"].default == "cuda"
    msvc = _gen(8, 4, 1, 1.0, 100.0)
    msvc2 = _gen(8, 4, 1, 1.0, 100.0, rand_flavor="msvc")
    glibc = _gen(8, 4, 1, 1.0, 100.0, rand_flavor="glibc")
    for a, b in zip(msvc, msvc2):
        assert torch.equal(a, b)
    assert not torch.equal(msvc[0], glibc[0])


@pytest.mark.parametrize("dtype", [None, np.float32, np.float64])
def test_device_generator_shapes_dtypes_range(dtype):
    n, m, lo, hi = 300, 70, -100.0, 100.0
    A, b, c = _gen(n, m, 12345, lo, hi, dtype)
    want = torch.float32 if dtype is np.float32 else torch.float64
    assert (A.shape, b.shape, c.shape) == ((m, n), (m,), (n,))
    for x in (A, b, c):
        assert x.dtype == want and x.device.type == "cpu"
        assert bool(((x >= lo) & (x < hi)).all())
    # The three streams are the three sub-seeds' own.
    seed_b, _, seed_a = derive_subseeds(12345, "msvc")
    g = torch.Generator().manual_seed(seed_b)
    first = torch.empty(m, dtype=torch.float32).uniform_(lo, hi, generator=g)
    assert torch.equal(b, first.masked_fill_(first >= hi, lo).to(want))
    assert not torch.equal(A[0, :m], b.to(A.dtype))


def test_device_generator_rejects_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        _gen(0, 4, 1)
