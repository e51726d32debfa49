"""The host plan of the plain blocked loop's kernels (``eta_ratio``,
``eta_colk``): how ``kernels.eta.eta_plan`` cuts a pivot into blocks and
rounds of slab rows, and what shared memory a block then takes (as
csrc/eta.cu ``smem_bytes`` counts it), checked on the CPU. The kernels run
only on the card (tests/test_torch_cuda.py, chip_smoke.py,
tools/eta_variants.cu), where csrc/eta.cu refuses a plan whose rounds do
not fit.
"""

import pytest

from simplex_tpu_torch.kernels import eta as ke

#: The tableau's element bytes of the three dtype pairs: (f64, f64) 8,
#: (f32, f64) and (f32, f32) 4.
ITEMS = {"f64": 8, "mixed": 4, "f32": 4}


def _owners(n: int, width: int) -> list[int]:
    """How many blocks of ``width`` own each of n indices."""
    count = [0] * n
    for blk in range(-(-n // width)):
        for i in range(blk * width, min(n, (blk + 1) * width)):
            count[i] += 1
    return count


@pytest.mark.parametrize("pair", sorted(ITEMS))
@pytest.mark.parametrize("L", [1, 8, 13, 128, 300])
@pytest.mark.parametrize("R", [3, 257, 6143, 6144, 24576, 120064])
@pytest.mark.parametrize("M", [1, 37, 2047, 2048, 8192, 10112])
def test_plan_owns_each_index_once_and_fits(M, R, L, pair):
    """At every shape and window, for every t: each row is owned by one
    block of ``eta_ratio`` and each column by one column block of
    ``eta_colk`` (whose blocks past the columns own each row once), a
    block's width a multiple of 4 within its threads; at least one slab
    row a round, two rounds and the window's coefficients within a
    block's shared memory; a block's bytes those of min(t, 2 stage) slab
    rows and t coefficients, nothing at t = 0; and every slab row the
    kernels copy -- row s of F from element s M + j0, of C from s R + i0
    -- fits its slots at its own misalignment within a 16-byte chunk, its
    unaligned head and tail included."""
    item = ITEMS[pair]
    vec = 16 // item
    plan = ke.eta_plan(M, R, L, item)
    assert plan.rows in ke.ETA_ROWS and plan.cols in ke.ETA_COLS
    assert plan.rows <= ke.ETA_RATIO_THREADS
    assert plan.cols <= ke.eta_colk_threads(plan.cols)
    assert plan.rows % 4 == 0 and plan.cols % 4 == 0
    assert set(_owners(M, plan.rows)) == {1}
    assert set(_owners(R, plan.cols)) == {1}
    assert set(_owners(M, ke.eta_colk_threads(plan.cols))) == {1}
    for ld, width, stage in ((M, plan.rows, plan.stage_ratio),
                             (R, plan.cols, plan.stage_colk)):
        slots = width + vec
        assert 1 <= stage <= ke.ETA_STAGE_MAX
        assert (2 * stage * slots * item + -(-L * item // 16) * 16
                <= ke.ETA_SLAB_SMEM)
        for t in range(L):
            smem = (min(t, 2 * stage) * slots * item
                    + -(-t * item // 16) * 16)
            assert smem <= ke.ETA_SLAB_SMEM
            assert (smem == 0) == (t == 0)
        for c0 in range(0, ld, width):
            ncol = min(width, ld - c0)
            for s in range(min(L, 2 * vec)):
                mis = (s * ld + c0) % vec
                assert mis + ncol <= slots, (s, c0)


def test_grid_sized_to_the_card():
    """The 2048^2 tableau (M 2,048, R 6,144) runs 64 blocks of
    ``eta_ratio`` and 96 + 16 of ``eta_colk`` (the grids before were 32 and
    48 + 16); the 8192^2 one 64 and 96 + 32 (256 columns a block); the
    north star's (M 10,112, R 120,064) 79 and 469 + 40. Each width is the
    narrowest whose grid fits half the SMs (``eta_ratio``) or, with its
    blocks of F[t] and b, one block an SM (``eta_colk``), the widest where
    none does."""
    assert ke.eta_grid(2048, 6144) == (32, 64)
    assert ke.eta_grid(8192, 24576) == (128, 256)
    assert ke.eta_grid(10112, 120064) == (128, 256)
    assert ke.eta_colk_blocks(2048, 6144, 64) == 96 + 16
    assert ke.eta_colk_blocks(8192, 24576, 256) == 96 + 32
    assert ke.eta_colk_blocks(10112, 120064, 256) == 469 + 40
    for M in (1, 100, 1056, 1057, 2048, 4224, 8448, 8449, 10112, 40000):
        for R in (3, 4224, 4225, 6144, 8448, 8449, 16896, 16897, 120064):
            rows, cols = ke.eta_grid(M, R)
            assert -(-M // rows) <= ke.ETA_SMS // 2 or rows == ke.ETA_ROWS[-1]
            assert all(-(-M // w) > ke.ETA_SMS // 2
                       for w in ke.ETA_ROWS if w < rows)
            assert (ke.eta_colk_blocks(M, R, cols) <= ke.ETA_SMS
                    or cols == ke.ETA_COLS[-1])
            assert all(ke.eta_colk_blocks(M, R, w) > ke.ETA_SMS
                       for w in ke.ETA_COLS if w < cols)


@pytest.mark.parametrize("pair", sorted(ITEMS))
def test_stage_follows_the_waves(pair):
    """``eta_ratio``, and ``eta_colk`` where its grid takes one wave, send
    for as many slab rows a round as two rounds fit (at most 128);
    ``eta_colk`` past one wave ``ETA_STAGE_WAVES`` rows, so that several of
    its blocks share an SM: the north star's 16 rows a round in every
    pair, the 2048^2 and 8192^2 tableaus' as many as fit."""
    item = ITEMS[pair]
    for M, R, L in ((2048, 6144, 128), (8192, 24576, 128),
                    (10112, 120064, 128), (37, 6143, 13), (4097, 257, 300),
                    (40000, 400000, 64)):
        plan = ke.eta_plan(M, R, L, item)
        assert plan.stage_ratio == ke.eta_stage(plan.rows, L, item)
        waves = ke.eta_colk_blocks(M, R, plan.cols) > ke.ETA_SMS
        assert plan.stage_colk == (
            min(ke.ETA_STAGE_WAVES, ke.eta_stage(plan.cols, L, item))
            if waves else ke.eta_stage(plan.cols, L, item))
    assert ke.eta_plan(10112, 120064, 128, item).stage_colk == 16
    assert ke.eta_plan(8192, 24576, 128, item).stage_colk == \
        ke.eta_stage(256, 128, item) > 16
    assert ke.eta_stage(256, 128, 8) == 55
    assert ke.eta_stage(64, 128, 8) == 128


def test_stage_of_a_window_too_long_is_zero():
    """A window whose coefficients leave no room for two rounds of one
    slab row plans 0 rows a round, which csrc/eta.cu refuses."""
    assert ke.eta_stage(128, 60000, 8) == 0
    assert ke.eta_stage(16, 28000, 8) == (ke.ETA_SLAB_SMEM - 224000) // 288
    assert ke.eta_plan(1, 3, 60000, 8).stage_ratio == 0
