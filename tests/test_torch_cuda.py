"""The CUDA kernels on the card, at small shapes: each against its plain
PyTorch version on the same tensors, and a solve on the card against
the same solve on the CPU. Marked ``gpu``; skipped where torch.cuda is
not available. The card's own check at full shapes is chip_smoke.py.

This file imports neither JAX nor tests/conftest.py, so on a machine
with a card and no JAX it runs as::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

import simplex_tpu_torch as pst
from simplex_tpu_torch.kernels import blocked as kb
from simplex_tpu_torch.tableau import tt_matvec

pytestmark = pytest.mark.gpu

DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "examples"
PROD = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, lo=-1.0, hi=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(dtype))


def test_kernels_match_plain_on_card(cuda):
    """f32 outputs to 1e-5 * (1 + |x|) (another summation order);
    integer outputs equal; the f64 vectors (costs, mv) to 1e-12 relative
    of the f64 formula on the kernel's own f32 operands, which an f32
    accumulation would miss."""

    M, R, L, t, eps = 256, 384, 16, 7, 1e-4
    Tt = _rand((M, R), 1).to(cuda)
    C = _rand((L, R), 2).to(cuda)
    F = _rand((L, M), 3, -0.1, 0.1).to(cuda)
    C[t:] = 0
    F[t:] = 0
    b = _rand((M,), 4, 0, 100, np.float64).to(cuda)
    h = torch.tensor(33, dtype=torch.int32, device=cuda)
    got = kb.ah_ratio(Tt, F, C, b, h, t, eps)
    want = kb.ah_ratio_plain(Tt, F, C, b, h, t, eps)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert int(got[1]) == int(want[1]) and int(got[4]) == int(want[4]) == 0

    ah, k, p, bk = got[:4]
    u = -0.5 / p.double()
    do = torch.tensor(True, device=cuda)
    costs = _rand((R,), 5, dtype=np.float64).to(cuda)
    base = torch.arange(M, dtype=torch.int32, device=cuda)
    w = _rand((R,), 6, 1, 2).to(cuda)
    outs = []
    for fn in (kb.colk_costs, kb.colk_costs_plain):
        st = [C.clone(), F.clone(), costs.clone(), b.clone(), base.clone(),
              w.clone()]
        cand = fn(Tt, st[0], st[1], st[2], k, t, u, do, R - 5, eps, ah,
                  st[3], st[4], h, p, bk, st[5])
        outs.append((st, cand))
    (sk, ck), (sp, cp) = outs
    torch.testing.assert_close(sk[0], sp[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sk[1], sp[1], rtol=1e-6, atol=1e-7)
    costs_x = costs - u * sk[0][t].double()
    assert ((sk[2] - costs_x).abs() <= 1e-12 * (1 + costs_x.abs())).all()
    assert torch.equal(sk[4], sp[4])
    assert int(ck[0]) == int(cp[0]) and int(ck[2]) == int(cp[2])

    coeffs = _rand((M,), 7, dtype=np.float64).to(cuda)
    Tk, Tp = Tt.clone(), Tt.clone()
    mv_k = kb.apply_reprice(Tk, C, F, coeffs)
    kb.apply_reprice_plain(Tp, C, F, coeffs)
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)
    mv_x = tt_matvec(Tk, coeffs)
    scale = tt_matvec(Tk.abs(), coeffs.abs())
    assert ((mv_k - mv_x).abs() <= 1e-12 * scale).all()
    kb.apply_window(Tk, C, F)
    kb.apply_window_plain(Tp, C, F)
    torch.testing.assert_close(Tk, Tp, rtol=1e-5, atol=1e-5)


def test_solve_on_card_matches_cpu(cuda):
    p = pst.generate_random_problem(128, 64, 2, 1, 100)
    kb.reset_launches()
    got = pst.solve(p, device="cuda", **PROD)
    assert kb.LAUNCHES["ah_ratio"] > 0 and kb.LAUNCHES["colk_costs"] > 0
    want = pst.solve(p, device="cpu", **PROD)
    assert got.status == want.status == pst.Status.OPTIMAL
    assert got.refine.certified
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
