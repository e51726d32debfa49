"""The host plan of the batched rank-1 update (``batch_rank1``): how
``kernels.pivot.rank1_plan`` cuts each lane into tiles, one block a tile,
and the kernel's walk under it (``rank1_cover``), checked on the CPU. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py, tools/rank1_probe.py); it refuses a plan whose tile count
differs from its own, and the card test holds the two counts equal.
"""

import pathlib

import pytest
import torch

from simplex_tpu_torch.kernels import pivot as kp

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "simplex_tpu_torch" / "kernels" / "csrc" / "pivot.cu"

#: (label, B, M, R, itemsize): config 3's f64 phase-1 tableau of the
#: default options, the wide batch's, rows that are not whole 16-byte
#: vectors, and the smallest lanes.
SHAPES = [("config 3", 256, 512, 3000, 8), ("wide", 32, 512, 15000, 8),
          ("R = 2,999", 256, 512, 2999, 8), ("R = 1", 7, 1, 1, 8),
          ("R = 1 f32", 300, 3, 1, 4), ("f32", 64, 37, 63, 4)]


@pytest.mark.parametrize("label,B,M,R,itemsize", SHAPES)
def test_plan_is_deterministic_and_fits(label, B, M, R, itemsize):
    """The same shape gives the same plan; its tile width is the
    kernel's, and its tiles cover the lane's 16-byte vectors with
    less than one tile to spare, inside the grid's limits."""
    plan = kp.rank1_plan(B, M, R, itemsize)
    assert plan == kp.rank1_plan(B, M, R, itemsize)
    assert plan.vecs == kp.RANK1_VECS
    tv = kp.RANK1_THREADS * plan.vecs
    nvec = M * R * itemsize // 16
    assert plan.tiles == kp.rank1_lane_tiles(M, R, itemsize, plan.vecs)
    assert plan.tiles * tv >= nvec and (plan.tiles - 1) * tv < max(nvec, 1)
    assert 1 <= plan.tiles <= 2**31 - 1 and B <= 65535


def test_plan_tiles_at_the_main_shapes():
    """Config 3's f64 phase-1 lane (512 x 3,000) is 768,000 vectors, 750
    tiles of 1,024; the wide lane (512 x 15,000) 3,750; a lane of one
    element one tile."""
    assert kp.RANK1_THREADS * kp.RANK1_VECS == 1024
    assert kp.rank1_plan(256, 512, 3000, 8).tiles == 750
    assert kp.rank1_plan(32, 512, 15000, 8).tiles == 3750
    assert kp.rank1_plan(7, 1, 1, 8).tiles == 1


#: (B, M, R, itemsize, offset in bytes, live lanes): both types, rows of
#: whole vectors and not, one row, one column, a tile that does not end
#: on a row, many lanes of one tile each, a tableau that does not start on
#: a 16-byte boundary (so lanes do not either where M R is odd), one live
#: lane and none.
COVER = [(5, 37, 64, 8, 0, "some"), (5, 37, 63, 8, 0, "some"),
         (5, 37, 64, 4, 0, "some"), (5, 37, 63, 4, 0, "some"),
         (4, 1, 2999, 8, 0, "all"), (3, 300, 1, 4, 0, "all"),
         (6, 1, 1, 8, 0, "some"), (2, 1, 2, 4, 4, "all"),
         (2, 700, 63, 8, 0, "all"), (1100, 2, 3, 4, 0, "some"),
         (1100, 2, 3, 8, 8, "some"), (5, 37, 63, 8, 8, "some"),
         (5, 37, 63, 4, 12, "some"), (9, 37, 63, 8, 0, "one"),
         (9, 37, 63, 8, 0, "none")]


@pytest.mark.parametrize("B,M,R,itemsize,offset,which", COVER)
def test_walk_covers_every_live_element_once(B, M, R, itemsize, offset,
                                             which):
    """Under the plan, and at the other tile widths the probe runs (512
    and 2,048 vectors a tile), every element of every live lane is
    updated exactly once and no element of a dead lane at all."""
    do = {"all": [True] * B, "none": [False] * B,
          "one": [i == B // 2 for i in range(B)],
          "some": [i % 3 != 1 for i in range(B)]}[which]
    want = torch.tensor(do, dtype=torch.int64)[:, None].expand(B, M * R)
    plans = [kp.rank1_plan(B, M, R, itemsize)] + [
        kp.Rank1Plan(v, kp.rank1_lane_tiles(M, R, itemsize, v))
        for v in (2, 8)]
    for plan in plans:
        assert torch.equal(kp.rank1_cover(plan, M, R, itemsize, do, offset),
                           want)


@pytest.mark.parametrize("bad", [dict(B=0), dict(B=65536), dict(M=0),
                                 dict(R=0), dict(itemsize=2)])
def test_plan_rejects_what_the_kernel_cannot_run(bad):
    shape = dict(B=4, M=8, R=8, itemsize=8) | bad
    with pytest.raises(ValueError):
        kp.rank1_plan(**shape)


def test_plan_constants_match_kernel():
    """The threads a block and the tile width are the kernel's own."""
    src = CSRC.read_text()
    assert f"constexpr int R1_THREADS = {kp.RANK1_THREADS};" in src
    assert f"constexpr int R1_VECS = {kp.RANK1_VECS};" in src


def test_cpu_tensors_take_the_plain_version_at_an_offset():
    """A contiguous T3 that does not start on a 16-byte boundary (which
    the wrapper lets through) takes the plain version on the CPU and
    equals it bit for bit, a dead lane's -0.0 kept."""
    g = torch.Generator().manual_seed(3)
    B, M, R = 3, 5, 7
    buf = torch.rand(B * M * R + 1, generator=g, dtype=torch.float64) - 0.5
    T3 = buf[1:].view(B, M, R)
    T3[1, 0, 0] = -0.0
    want = T3.clone()
    factor = torch.rand((B, M), generator=g, dtype=torch.float64)
    colk = torch.rand((B, R), generator=g, dtype=torch.float64)
    do = torch.tensor([True, False, True])
    kp.batch_rank1_plain(want, factor, colk, do)
    kp.reset_launches()
    kp.batch_rank1(T3, factor, colk, do)
    assert kp.LAUNCHES["batch_rank1"] == 0
    assert torch.equal(T3, want) and torch.signbit(T3[1, 0, 0])
