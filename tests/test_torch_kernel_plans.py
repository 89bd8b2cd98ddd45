"""Plans and builds of the port's CUDA kernels, checked without a card.

``w8a8_plan`` decides, from (M, N, K) alone, which W8A8 kernel runs, how K
is split across blocks, the grid and the int32 workspace; these tests hold
it to what the kernels in ``csrc/w8a8_gemm.cu`` assume. ``w4_plan`` does the
same for the two dispatched AWQ-W4 products and ``csrc/w4_gemm.cu``.
``build`` hashes what a library is built from.
"""

import math
import os

import numpy as np
import pytest
import torch

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


# (K, N) of the AWQ-W4 linears at Llama-3-8B's widths (o, qkv, gate/up,
# down) and the group sizes the port takes.
W4_KN = [(4096, 4096), (4096, 6144), (4096, 14336), (14336, 4096)]
W4_MS = [1, 4, 8, 16, 33, 64, 65, 128, 8192]
W4_EDGES = [(4, 256, 64, 128), (1, 32, 16, 16), (64, 14336, 4096, 32),
            (5, 768, 48, 48), (64, 4096, 128256, 128), (300, 512, 384, 32)]
W4_SHAPES = sorted({(M, K, N, 128) for M in W4_MS for K, N in W4_KN} | set(W4_EDGES))


def _check_w4_plan(M, K, N, G, packed, aligned=True, half=True):
    plan = qm.w4_plan(M, N, K, G, packed, aligned, half)
    rows = K // 2 if packed else K
    splitk = half and aligned and N % 16 == 0 and M <= qm.W4_SPLITK_MAX_M
    if plan.path == "tile":
        assert not splitk
        assert plan.splits == 1 and plan.k_chunk == rows and plan.counters == 0
        assert plan.tile == qm.W4_TILE
        assert plan.grid == (math.ceil(N / 64), math.ceil(M / 64), 1)
        return plan
    assert splitk and plan.path == "splitk"
    assert plan.mt in qm.W4_SPLITK_MTS and (M <= plan.mt or plan.mt == 64)
    # Slices of whole groups and whole stages, each non-empty, covering the
    # payload rows once.
    assert plan.k_chunk > 0 and plan.k_chunk % G == 0
    assert plan.k_chunk % qm.W4_SPLITK_BK == 0
    assert (plan.splits - 1) * plan.k_chunk < rows <= plan.splits * plan.k_chunk
    covered = np.zeros(rows, np.int32)
    for z in range(plan.splits):
        covered[z * plan.k_chunk:min(rows, (z + 1) * plan.k_chunk)] += 1
    assert (covered == 1).all()
    # Every slice boundary is a group boundary of k, in both halves of a
    # packed byte row (rows r and r + K/2).
    for b in [z * plan.k_chunk for z in range(plan.splits)] + [rows]:
        assert b % G == 0 and (not packed or (b + rows) % G == 0)
    tiles_n, tiles_m, splits = plan.grid
    assert tiles_n * qm.W4_SPLITK_BN >= N > (tiles_n - 1) * qm.W4_SPLITK_BN
    assert tiles_m * plan.mt >= M > (tiles_m - 1) * plan.mt
    assert splits == plan.splits and tiles_m <= 65535 and splits <= 65535
    assert plan.counters == (tiles_n * tiles_m if splits > 1 else 0)
    assert plan.counters <= qm.W4_COUNTERS
    return plan


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M,K,N,G", W4_SHAPES)
def test_w4_plan_covers_k_once_on_group_boundaries(M, K, N, G, packed):
    _check_w4_plan(M, K, N, G, packed)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("K,N", W4_KN)
def test_w4_plan_fills_the_card_at_small_m(K, N, M, packed):
    """At decode M the split-K path gives about the blocks an SM it aims
    at (``W4_SPLITK_BLOCKS_PER_SM``) over the four Llama (K, N), as far as
    whole groups allow."""
    plan = _check_w4_plan(M, K, N, 128, packed)
    assert plan.path == "splitk" and plan.mt == max(8, M)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    want = qm.W4_SPLITK_BLOCKS_PER_SM * qm.CARD_SMS
    assert 0.5 * want <= blocks <= 1.5 * want


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("K,N", W4_KN)
def test_w4_plan_takes_the_tile_above_64_rows(K, N, packed):
    """Prefill M (8,192), M = 65 and float32 activations take the tile,
    as do an unaligned payload and N off a multiple of 16."""
    for M in (65, 8192):
        assert qm.w4_plan(M, N, K, 128, packed).path == "tile"
    assert qm.w4_plan(4, N, K, 128, packed, half=False).path == "tile"
    assert qm.w4_plan(4, N, K, 128, packed, aligned=False).path == "tile"
    assert qm.w4_plan(4, N + 8, K, 128, packed).path == "tile"


def test_w4_plan_packed_half_is_one_group():
    """K = 256 at G = 128 packed: each byte row's halves are one group each,
    so the whole K is one slice of 128 payload rows."""
    plan = _check_w4_plan(4, 256, 4096, 128, True)
    assert plan.path == "splitk" and plan.splits == 1 and plan.k_chunk == 128


def test_w4_plan_every_accepted_shape_has_a_path():
    rng = np.random.default_rng(1)
    for _ in range(2000):
        G = 16 * int(rng.integers(1, 17))
        packed = bool(rng.integers(2))
        K = G * int(rng.integers(1, 64)) * (2 if packed else 1)
        M, N = int(rng.integers(1, 200)), 16 * int(rng.integers(1, 2000))
        _check_w4_plan(M, K, N, G, packed, bool(rng.integers(4)), bool(rng.integers(4)))


def test_w4_wrapper_plan_sends_folded_forms_to_the_tile():
    x = torch.zeros((4, 256), dtype=torch.float16)
    w = torch.zeros((128, 64), dtype=torch.int8)
    gs = torch.zeros((2, 64))
    assert qm.w4_wrapper_plan(x, w, gs, True, False).path == "splitk"
    assert qm.w4_wrapper_plan(x, w, gs, True, True).path == "tile"
    assert qm.w4_wrapper_plan(x.float(), w, gs, True, False).path == "tile"


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
