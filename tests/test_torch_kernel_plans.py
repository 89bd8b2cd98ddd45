"""Plans and builds of the port's CUDA kernels, checked without a card.

``w8a8_plan`` decides, from (M, N, K) alone, which W8A8 kernel runs, how K
is split across blocks, the grid and the int32 workspace; these tests hold
it to what the kernels in ``csrc/w8a8_gemm.cu`` assume. ``build`` hashes
what a library is built from.
"""

import math
import os

import numpy as np
import pytest

from ctranslate2_tpu_torch.kernels import build
from ctranslate2_tpu_torch.kernels import quant_matmul as qm

# (K, N) of every int8 linear on the main paths: the Generator at Llama-3-8B's
# widths (qkv, o, gate/up, down, the vocabulary projection) and the
# Translator at Transformer-base's (encoder and decoder projections, the
# 32,000-word output).
GENERATOR_KN = [(4096, 6144), (4096, 4096), (4096, 14336), (14336, 4096),
                (4096, 128256)]
TRANSLATOR_KN = [(512, 1536), (512, 512), (512, 1024), (512, 2048),
                 (2048, 512), (512, 32000)]
MS = [1, 4, 8, 9, 16, 64, 65, 128, 300, 2048, 8192]
EDGES = [(1, 16, 128), (4, 16, 128256), (4, 14336, 128256), (3, 100, 50),
         (7, 520, 300), (1, 8, 8), (65535 * 64, 100, 3), (70000, 4096, 4096)]
SHAPES = sorted({(M, K, N) for M in MS for K, N in GENERATOR_KN + TRANSLATOR_KN}
                | set(EDGES))

GRID_X_MAX = 2 ** 31 - 1


def _check_plan(M, K, N, aligned):
    plan = qm.w8a8_plan(M, N, K, aligned)
    vec = aligned and K % 16 == 0
    if plan.path == "wgmma":
        assert vec and K >= 128 and N >= 128 and M >= qm.WGMMA_MIN_M
        assert plan.splits == 1 and plan.workspace == 0
        tiles = math.ceil(M / 128) * math.ceil(N / 128)
        assert plan.grid == (tiles, 1, 1) and tiles <= GRID_X_MAX
        return plan
    assert plan.path == ("splitk" if vec else "ragged")
    assert plan.mt in qm.SPLITK_MTS and (M <= plan.mt or plan.mt == 64)
    # The K slices: whole 128-byte stages, each non-empty, covering K once.
    assert plan.k_chunk % qm.SPLITK_BK == 0 and plan.k_chunk > 0
    assert (plan.splits - 1) * plan.k_chunk < max(K, 1) <= plan.splits * plan.k_chunk
    starts = [z * plan.k_chunk for z in range(plan.splits)]
    covered = np.zeros(K, np.int32)
    for s in starts:
        covered[s:min(K, s + plan.k_chunk)] += 1
    assert (covered == 1).all()
    tiles_n, tiles_m, splits = plan.grid
    assert tiles_n * qm.SPLITK_BN >= N > (tiles_n - 1) * qm.SPLITK_BN
    assert tiles_m * plan.mt >= M > (tiles_m - 1) * plan.mt
    assert splits == plan.splits
    assert tiles_n <= GRID_X_MAX and tiles_m <= 65535 and splits <= 65535
    # The workspace holds the int32 sums and one counter a tile.
    if plan.splits > 1:
        assert plan.workspace == M * N + tiles_n * tiles_m
    else:
        assert plan.workspace == 0
    return plan


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_w8a8_plan_covers_k_once_and_fits_the_grid(M, K, N, aligned):
    _check_plan(M, K, N, aligned)


@pytest.mark.parametrize("M", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("K,N", GENERATOR_KN[:4] + TRANSLATOR_KN[:4])
def test_w8a8_plan_fills_the_card_at_small_m(M, K, N):
    """Split-K gives every small-M shape at least two blocks an SM, as far
    as K has stages to split."""
    plan = _check_plan(M, K, N, True)
    assert plan.path == "splitk"
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    steps = math.ceil(K / qm.SPLITK_BK)
    assert blocks >= min(2 * qm.CARD_SMS, plan.grid[0] * plan.grid[1] * steps)


@pytest.mark.parametrize("M,K,N", [(8192, 4096, 4096), (8192, 14336, 4096),
                                   (2048, 2048, 512), (300, 4096, 14336)])
def test_w8a8_plan_takes_wgmma_at_large_m(M, K, N):
    assert qm.w8a8_plan(M, N, K).path == "wgmma"
    # Unaligned operands or K off a multiple of 16: the ragged kernel.
    assert qm.w8a8_plan(M, N, K, aligned=False).path == "ragged"
    assert qm.w8a8_plan(M, N, K + 8).path == "ragged"


def test_w8a8_plan_every_accepted_shape_has_a_path():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        M, N, K = (int(x) for x in rng.integers(1, [20000, 40000, 20000]))
        _check_plan(M, K, N, bool(rng.integers(2)))


def test_w8a8_plan_raises_beyond_the_ragged_grid():
    """The only shape limit left: the ragged kernel's M over its grid's y
    dimension (65,535 tiles of 64 rows); the wgmma path has none."""
    limit = qm.GRID_Y_MAX * 64
    _check_plan(limit, 100, 8, True)
    with pytest.raises(ValueError, match=f"M={limit + 1}"):
        qm.w8a8_plan(limit + 1, 8, 100)
    assert qm.w8a8_plan(limit + 1, 4096, 4096).path == "wgmma"


def test_w8a8_main_path_split_counts_are_few():
    """The card tests run every main-path shape; their split counts are
    the ones the plan gives there."""
    splits = {qm.w8a8_plan(M, N, K).splits
              for M in MS for K, N in GENERATOR_KN + TRANSLATOR_KN}
    assert 1 in splits and max(splits) <= 2 * qm.SPLITK_BLOCKS_PER_SM * qm.CARD_SMS


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setenv("CT2TPU_TORCH_BUILD_DIR", str(tmp_path / "out"))
    return csrc


def test_library_path_changes_with_a_shared_header(fake_csrc):
    before = build.library_path("k")
    assert build.library_path("k") == before
    (fake_csrc / "h.cuh").write_text("// header, edited\n")
    assert build.library_path("k") != before
    (fake_csrc / "new.cuh").write_text("// another header\n")
    assert len({before, build.library_path("k")}) == 2


def test_library_path_changes_with_the_flags(fake_csrc, monkeypatch):
    before = build.library_path("k")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != before
    assert os.path.basename(before).startswith("libk-")
