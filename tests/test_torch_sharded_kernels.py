"""The plain PyTorch versions of K5 (``ah``), K11 (``reprice``) and K12
(``batch_reprice``) against the JAX package's Pallas kernels run in
interpret mode (``ah_pass``, ``reprice_pass``, ``batch_reprice_pass``), on
the same seeded numpy inputs; mirrors tests/test_blocked_kernel.py
(TestRepricePass, TestAhPass) and tests/test_batched_kernel.py
(TestRepriceKernel).

Tolerances and why:

* K5's f32 column to 1e-5 * (1 + |x|) of the Pallas column: the eta
  correction sums t products in another order; bit for bit against K1's
  column (``ah_ratio_plain`` calls ``ah_plain``; on the card the two
  kernels share their device code, tests/test_torch_cuda.py);
* K11 / K12 against the exact f64 formula on the same f32 tableau at
  1e-12 of the terms' magnitude (only the f64 summation order differs);
  against the JAX pairs at 1e-7 of the result's scale: interpret mode
  runs the double-f32 arithmetic under XLA:CPU, which contracts the
  Dekker products into FMAs and leaves ~one f32 rounding (2^-25) of the
  total (tests/test_blocked_kernel.py TestRepricePass);
* K11 equal to K3 (``apply_reprice``) with zero etas, K12 equal to
  ``batch_apply_reprice`` with no live eta row: the same fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.kernels.batched import batch_reprice_pass
from simplex_tpu.kernels.blocked import ah_pass, ff32_from_f64, reprice_pass
from simplex_tpu_torch.kernels import batched as kbt
from simplex_tpu_torch.kernels import blocked as kb

M_PAD, R_PAD, L = 256, 384, 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _i32(v):
    return torch.tensor(int(v), dtype=torch.int32)


def _factors(t, seed):
    rng = np.random.default_rng(seed)
    Tt = rng.uniform(-1, 1, (M_PAD, R_PAD)).astype(np.float32)
    C = rng.uniform(-1, 1, (L, R_PAD)).astype(np.float32)
    F = rng.uniform(-0.1, 0.1, (L, M_PAD)).astype(np.float32)
    C[t:] = 0.0                      # rows >= t are dead by contract
    F[t:] = 0.0
    return Tt, C, F


@pytest.mark.parametrize("h", [127, 128, 255], ids=lambda h: f"h{h}")
@pytest.mark.parametrize("t", [0, L // 2 - 3, L - 1], ids=lambda t: f"t{t}")
def test_ah_matches_pallas(t, h):
    """h on both sides of a 128-lane edge, t from an empty window to a
    full one."""
    Tt, C, F = _factors(t, 500 + t + h)
    want = np.asarray(ah_pass(jnp.asarray(Tt), jnp.asarray(F),
                              jnp.asarray(C), jnp.int32(h), jnp.int32(t),
                              interpret=True), np.float64)
    got = kb.ah(_t(Tt), _t(F), _t(C), _i32(h), t)
    assert got.dtype == torch.float32 and got.shape == (M_PAD,)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 1e-5 * (1 + np.abs(want))).all(), err.max()
    k1 = kb.ah_ratio(_t(Tt), _t(F), _t(C),
                     _t(np.random.default_rng(t).uniform(0, 9, M_PAD)),
                     _i32(h), t, 1e-4)[0]
    assert torch.equal(got, k1)


def test_ah_clamps_and_rejects():
    Tt, C, F = _factors(3, 7)
    last = kb.ah(_t(Tt), _t(F), _t(C), _i32(R_PAD - 1), 3)
    assert torch.equal(kb.ah(_t(Tt), _t(F), _t(C), _i32(R_PAD + 50), 3),
                       last)
    with pytest.raises(ValueError):
        kb.ah(_t(Tt), _t(F), _t(C), _i32(3), L)
    with pytest.raises(ValueError):
        kb.ah(_t(Tt), _t(F), _t(C), torch.tensor(3), 2)


@pytest.mark.parametrize("m_pad,r_pad", [(128, 384), (256, 8192 + 128)])
def test_reprice_matches_pallas(m_pad, r_pad):
    rng = np.random.default_rng(40 + r_pad)
    Tt = rng.uniform(-100, 100, (m_pad, r_pad)).astype(np.float32)
    coeffs = rng.uniform(-100, 100, m_pad)
    hi, lo = reprice_pass(jnp.asarray(Tt), *ff32_from_f64(
        jnp.asarray(coeffs)), interpret=True)
    pairs = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    got = kb.reprice(_t(Tt), _t(coeffs)).numpy()
    T64 = Tt.astype(np.float64)
    exact = coeffs @ T64
    assert (np.abs(got - exact) <= 1e-12 * (np.abs(coeffs) @ np.abs(T64))
            ).all()
    scale = np.abs(exact).max() + 1.0
    assert (np.abs(got - pairs) <= 1e-7 * scale).all()


def test_reprice_equals_apply_reprice_with_zero_etas():
    rng = np.random.default_rng(3)
    Tt = _t(rng.uniform(-1, 1, (M_PAD, R_PAD)).astype(np.float32))
    coeffs = _t(rng.uniform(-5, 5, M_PAD))
    zC, zF = torch.zeros((8, R_PAD)), torch.zeros((8, M_PAD))
    mv = kb.apply_reprice(Tt.clone(), zC, zF, coeffs)
    assert torch.equal(kb.reprice(Tt, coeffs), mv)
    with pytest.raises(ValueError):
        kb.reprice(Tt[:, :200].contiguous(), coeffs)


def test_batch_reprice_matches_pallas():
    rng = np.random.default_rng(0)
    B, m_pad, r_pad = 3, 128, 256
    Tt = rng.uniform(-50, 50, (B * m_pad, r_pad)).astype(np.float32)
    coeffs = rng.uniform(-3, 3, (B, m_pad))
    flags = np.array([1, 0, 1], np.int32)
    c_hi, c_lo = ff32_from_f64(jnp.asarray(coeffs))
    hi, lo = batch_reprice_pass(
        jnp.asarray(Tt), jnp.asarray(c_hi).reshape(B * m_pad, 1),
        jnp.asarray(c_lo).reshape(B * m_pad, 1), jnp.asarray(flags),
        interpret=True)
    pairs = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    got = kbt.batch_reprice(_t(Tt), _t(coeffs), _t(flags)).numpy()
    T3 = Tt.astype(np.float64).reshape(B, m_pad, r_pad)
    exact = np.einsum("bm,bmr->br", coeffs, T3)
    terms = np.einsum("bm,bmr->br", np.abs(coeffs), np.abs(T3))
    on = flags != 0
    assert (np.abs(got - exact)[on] <= 1e-12 * terms[on]).all()
    assert not got[1].any() and not pairs[1].any()
    scale = np.abs(exact).max() + 1.0
    assert (np.abs(got - pairs) <= 1e-7 * scale).all()


def test_batch_reprice_equals_apply_reprice_fold():
    """batch_apply_reprice with no live eta row applies nothing and folds
    the same mv."""
    rng = np.random.default_rng(5)
    B, m_pad, r_pad, Lb = 4, 128, 384, 8
    Tt = _t(rng.uniform(-1, 1, (B * m_pad, r_pad)).astype(np.float32))
    cf = _t(rng.uniform(-2, 2, (B, m_pad)))
    flags = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    mv = kbt.batch_reprice(Tt, cf, flags)
    zC = torch.zeros((B * Lb, r_pad))
    zF = torch.zeros((B * Lb, m_pad))
    T2 = Tt.clone()
    fold = kbt.batch_apply_reprice(T2, zC, zF, cf, flags,
                                   torch.zeros(B, dtype=torch.int32))
    assert torch.equal(T2, Tt) and torch.equal(mv, fold)


def test_new_wrappers_count_no_cpu_launch():
    kb.reset_launches()
    kbt.reset_launches()
    Tt, C, F = _factors(4, 9)
    kb.ah(_t(Tt), _t(F), _t(C), _i32(5), 4)
    kb.reprice(_t(Tt), torch.ones(M_PAD, dtype=torch.float64))
    kbt.batch_reprice(_t(Tt), torch.ones((2, M_PAD // 2),
                                         dtype=torch.float64),
                      torch.ones(2, dtype=torch.int32))
    assert kb.LAUNCHES["ah"] == kb.LAUNCHES["reprice"] == 0
    assert kbt.LAUNCHES["batch_reprice"] == 0
