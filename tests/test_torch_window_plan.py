"""The host plan of the batched window kernel (K7/K8): how
``kernels.batched.window_plan`` spreads a lane over a thread-block cluster
and which eta rows it keeps in shared memory, checked on the CPU. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py, tools/k7_variants.cu); it refuses a plan whose byte count
differs from its own, and the card test holds the two counts equal.
"""

import pathlib
import re

import pytest

from simplex_tpu_torch.kernels import batched as kbt

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "simplex_tpu_torch" / "kernels" / "csrc" / "batched.cu"
BENCH = ROOT / "tools" / "k7_variants.cu"


@pytest.mark.parametrize("R", [384, 3072, 15104, 24576])
@pytest.mark.parametrize("M", [128, 512, 4096])
@pytest.mark.parametrize("L", [8, 16, 32, 64, 128])
def test_plan_fits_and_covers(L, M, R):
    """At every shape, for few and many lanes, devex or not: the cluster
    size divides M and R, so its blocks cover both exactly, each block's
    columns whole 16-byte chunks; the resident rows are at most L; the
    byte count is window_smem_bytes's and fits 227 KB a block."""
    for B in (1, 32, 256):
        for devex in (True, False):
            p = kbt.window_plan(B, M, R, L, devex)
            assert p.cs in kbt.CLUSTERS
            assert M % p.cs == 0 and R % p.cs == 0
            assert p.cs * (M // p.cs) == M and p.cs * (R // p.cs) == R
            assert (R // p.cs) % 4 == 0
            assert 0 <= p.res_c <= L and 0 <= p.res_f <= L
            assert p.smem == kbt.window_smem_bytes(M, R, p.cs, devex, p.vec,
                                                   p.res_c, p.res_f)
            assert p.smem <= kbt.BLOCK_SMEM
            # Rows stay out of shared memory only where they do not fit.
            if p.res_c < L or p.res_f < L or not p.vec:
                full = kbt.window_smem_bytes(M, R, p.cs, devex, True, L, L)
                assert full > p.smem


def test_smem_bytes_layout():
    """The header, then the block's vectors (costs f64, w f32, the pivot
    row f32 over R / cs columns; b f64, base, a_h and the entering column
    over M / cs rows), then the resident rows of C and F."""
    M, R, cs = 512, 3072, 8
    rc, mc = R // cs, M // cs
    assert kbt.window_smem_bytes(M, R, cs, True, True, 32, 32) == (
        2048 + rc * 16 + mc * 20 + 4 * 32 * (rc + mc))
    assert kbt.window_smem_bytes(M, R, cs, False, True, 5, 7) == (
        2048 + rc * 12 + mc * 20 + 4 * (5 * rc + 7 * mc))
    assert kbt.window_smem_bytes(M, R, cs, True, False, 0, 0) == 2048


def test_plan_constants_match_kernel():
    """The header size, the block limit and the threads a block are the
    kernel's own."""
    src = CSRC.read_text()
    assert f"constexpr int WIN_HEADER = {kbt.WINDOW_HEADER};" in src
    assert f"constexpr int WIN_THREADS = {kbt.WINDOW_THREADS};" in src
    assert f"WIN_SMEM_LIMIT = {kbt.BLOCK_SMEM};" in src
    assert f"constexpr int LMAX = {kbt.LMAX};" in src


def test_bench_shipped_plans_are_window_plans():
    """tools/k7_variants.cu times, as "shipped", the plan window_plan
    gives each of its shapes on a 132-SM card."""
    src = BENCH.read_text()
    shapes = [tuple(int(v) for v in m[:4]) + (m[4] == "true",) for m in
              re.findall(r'\{"[^"]+", (\d+), (\d+), (\d+), (\d+), '
                         r'(true|false)\}', src)]
    shipped = [tuple(int(v) for v in m) for m in re.findall(
        r'\{"shipped", (\d+), (\d+), (\d+), (\d+), (\d+)\}', src)]
    assert len(shapes) == len(shipped) == 5
    for (B, M, R, L, devex), want in zip(shapes, shipped):
        p = kbt.window_plan(B, M, R, L, devex)
        assert (p.cs, kbt.WINDOW_THREADS, int(p.vec), p.res_c,
                p.res_f) == want


def test_plan_fills_the_card():
    """The cluster grows until B x cs reaches 90% of the SMs, but not past
    WINDOW_THREADS columns a block: config 3's 256 lanes one block each,
    the 32 wide lanes four, 64 lanes of R = 3,072 two; a lane of R = 384
    one block whatever B."""
    assert kbt.window_plan(256, 512, 3072, 32, True).cs == 1
    assert kbt.window_plan(32, 512, 15104, 32, True).cs == 4
    assert kbt.window_plan(64, 512, 3072, 128, True).cs == 2
    assert kbt.window_plan(1, 512, 24576, 32, True).cs == 16
    assert kbt.window_plan(1, 128, 384, 8, False).cs == 1
    assert kbt.window_plan(32, 512, 15104, 32, True, sms=64).cs == 2


@pytest.mark.parametrize("bad", [dict(M=100), dict(R=200), dict(L=0),
                                 dict(L=129), dict(B=0)])
def test_plan_rejects_shapes_the_kernel_cannot_run(bad):
    shape = dict(B=4, M=128, R=384, L=16) | bad
    with pytest.raises(ValueError):
        kbt.window_plan(**shape, devex=True)
