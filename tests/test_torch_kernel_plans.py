"""Plans and builds of the port's CUDA kernels, checked without a card.

``w8a8_plan`` decides, from (M, N, K) alone, which W8A8 kernel runs, how K
is split across blocks, the grid and the int32 workspace; these tests hold
it to what the kernels in ``csrc/w8a8_gemm.cu`` assume. ``w4_plan`` does the
same for the two dispatched AWQ-W4 products and ``csrc/w4_gemm.cu``, and
``decode_plan`` for the int8-KV decode kernel (``csrc/decode_attention_int8.cu``).
The attention dispatch sends only the head dims those kernels take to them.
``build`` hashes what a library is built from.
"""

import inspect
import math
import os

import numpy as np
import pytest
import torch

from ctranslate2_tpu_torch.kernels import build
from ctranslate2_tpu_torch.kernels import decode_attention as da
from ctranslate2_tpu_torch.kernels import quant_matmul as qm
from ctranslate2_tpu_torch.kernels.flash_attention import HEAD_DIMS
from ctranslate2_tpu_torch.models import transformer as TT

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


def _w4_expected_path(M, K, N, aligned=True, half=True):
    """``w4_plan``'s rule, written out: the tile off the fast paths' limits;
    split-K up to ``W4_SPLITK_MAX_M`` rows, or for a long K over a wgmma
    grid of few tiles; wgmma everywhere else."""
    if not (half and aligned and N % 16 == 0):
        return "tile"
    tiles = math.ceil(M / 128) * math.ceil(N / 128)
    if M <= qm.W4_SPLITK_MAX_M or (tiles < qm.W4_WGMMA_MIN_TILES
                                   and K >= qm.W4_SPLITK_LONG_K):
        return "splitk"
    return "wgmma"


def _w4_wgmma_rows(M, N, fold):
    """x rows a wgmma block: 128; for the folded forms 256 where the
    128-row grid needs more than one wave of the card's SMs."""
    wide = fold and math.ceil(M / 128) * math.ceil(N / 128) > qm.CARD_SMS
    return qm.W4_WGMMA_WIDE_ROWS if wide else 128


def _check_w4_plan(M, K, N, G, packed, aligned=True, half=True, fold=False):
    plan = qm.w4_plan(M, N, K, G, packed, aligned, half, fold)
    rows = K // 2 if packed else K
    assert plan.path == _w4_expected_path(M, K, N, aligned, half)
    if plan.path == "tile":
        assert plan.splits == 1 and plan.k_chunk == rows and plan.counters == 0
        assert plan.tile == qm.W4_TILE
        assert plan.grid == (math.ceil(N / 64), math.ceil(M / 64), 1)
        return plan
    if plan.path == "wgmma":
        # One block a bm x 128 output tile over the whole K.
        bm = _w4_wgmma_rows(M, N, fold)
        assert plan.splits == 1 and plan.k_chunk == rows and plan.counters == 0
        assert plan.tile == (bm, 128, 64) and plan.mt == bm
        assert plan.grid == (math.ceil(M / bm) * math.ceil(N / 128), 1, 1)
        assert plan.grid[0] < 2 ** 31
        return plan
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
    """Above 64 rows, and at decode M, a float16/bfloat16 product with an
    aligned payload and N % 16 == 0 takes split-K or wgmma, never the tile;
    the tile stays for float32 activations, an unaligned payload and N off
    a multiple of 16, at every M."""
    for M in (65, 128, 2048, 8192):
        assert qm.w4_plan(M, N, K, 128, packed).path in ("splitk", "wgmma")
    assert qm.w4_plan(8192, N, K, 128, packed).path == "wgmma"
    for M in (4, 65, 8192):
        assert qm.w4_plan(M, N, K, 128, packed, half=False).path == "tile"
        assert qm.w4_plan(M, N, K, 128, packed, aligned=False).path == "tile"
        assert qm.w4_plan(M, N + 8, K, 128, packed).path == "tile"


# The plan's path at each M range over the four Llama (K, N): split-K up to
# 64 rows; above, wgmma, except over 32 wgmma tiles with K = 14,336.
W4_PATH_CASES = [(M, K, N) for M in (1, 33, 64, 65, 100, 128, 129, 256, 512, 2048, 8192)
                 for K, N in W4_KN]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M,K,N", W4_PATH_CASES)
def test_w4_plan_sends_each_m_range_to_its_path(M, K, N, packed):
    plan = _check_w4_plan(M, K, N, 128, packed)
    if M <= 64:
        assert plan.path == "splitk"
    elif M > 128 or N > 4096 or K == 4096:
        assert plan.path == "wgmma"
    else:  # K 14,336, N 4,096, M 65-128: 32 wgmma blocks over the whole K
        assert plan.path == "splitk"


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("K,N", W4_KN)
def test_w4_plan_prefill_shapes_take_wgmma(K, N, packed):
    """The AWQ prefill's four products (4 prompts of 2,048 tokens)."""
    plan = _check_w4_plan(8192, K, N, 128, packed)
    assert plan.path == "wgmma" and plan.grid[0] == 64 * N // 128


@pytest.mark.parametrize("M,N", [(65, 4096), (128, 128), (200, 400), (1000, 14336),
                                 (8192, 4096), (8192, 6144), (300, 16), (4097, 1040),
                                 (130, 128256)])
def test_w4_wgmma_grid_covers_m_and_n_once(M, N):
    """The wgmma grid's blocks, laid out by the kernel's raster
    (``w4_wgmma_tile``), cover every 128 x 128 output tile once, and the
    consecutive blocks of a raster group share at most 8 x-row tiles."""
    plan = qm.w4_path_plan("wgmma", M, N, 4096, 128, True)
    tiles_m, tiles_n = math.ceil(M / 128), math.ceil(N / 128)
    seen = np.zeros((tiles_m, tiles_n), np.int32)
    for block in range(plan.grid[0]):
        tm, tn = qm.w4_wgmma_tile(block, M, N)
        assert 0 <= tm < tiles_m and 0 <= tn < tiles_n
        seen[tm, tn] += 1
    assert (seen == 1).all()
    span = qm.W4_WGMMA_RASTER * tiles_n  # the blocks of one raster group
    for start in range(0, plan.grid[0], span):
        rows = {qm.w4_wgmma_tile(b, M, N)[0]
                for b in range(start, min(start + span, plan.grid[0]))}
        assert len(rows) <= qm.W4_WGMMA_RASTER


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M", [4, 65, 8192])
def test_w4_plan_keeps_the_tile_off_the_fast_paths(M, packed):
    """float32, an unaligned payload and N off a multiple of 16 take the
    tile at every M, in every form; in a half type the folded forms take
    split-K or wgmma as the exact forms do."""
    for fold in (False, True):
        for kw in (dict(half=False), dict(aligned=False)):
            assert _check_w4_plan(M, 4096, 4096, 128, packed, fold=fold, **kw).path == "tile"
        assert _check_w4_plan(M, 4096, 4104, 128, packed, fold=fold).path == "tile"
    x = torch.zeros((M, 256), dtype=torch.float16)
    w = torch.zeros((128 if packed else 256, 4096), dtype=torch.int8)
    gs = torch.zeros((2, 4096))
    fast = "splitk" if M <= qm.W4_SPLITK_MAX_M else "wgmma"
    assert qm.w4_wrapper_plan(x, w, gs, packed, True).path == fast
    assert qm.w4_wrapper_plan(x.float(), w, gs, packed, True).path == "tile"
    assert qm.w4_wrapper_plan(x.float(), w, gs, packed, False).path == "tile"


def test_w4_path_plan_refuses_an_unknown_path():
    with pytest.raises(ValueError, match="no path"):
        qm.w4_path_plan("mma", 4, 64, 256, 128, True)


@pytest.mark.parametrize("fold,rows", [(False, 256), (False, 64), (True, 64), (True, 512)])
def test_w4_path_plan_refuses_a_wgmma_block_it_has_no_kernel_for(fold, rows):
    """The wgmma kernels take 128 x rows a block, the folded forms' also
    ``W4_WGMMA_WIDE_ROWS``."""
    for M in (300, 8192):  # the rule's block: 128 rows, folded 256 at 8,192
        with pytest.raises(ValueError, match="no wgmma block"):
            qm.w4_path_plan("wgmma", M, 4096, 4096, 128, True, fold, rows)
        assert qm.w4_path_plan("wgmma", M, 4096, 4096, 128, True, fold, 128).mt == 128
        if fold:
            wide = qm.W4_WGMMA_WIDE_ROWS
            assert qm.w4_path_plan("wgmma", M, 4096, 4096, 128, True, fold, wide).mt == wide


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
    """The folded forms take the tile where the exact forms do (float32
    activations, a payload off 16 bytes), and split-K or wgmma elsewhere."""
    x = torch.zeros((4, 256), dtype=torch.float16)
    w = torch.zeros((128, 64), dtype=torch.int8)
    gs = torch.zeros((2, 64))
    big = torch.zeros((512, 256), dtype=torch.float16)
    for fold in (False, True):
        assert qm.w4_wrapper_plan(x, w, gs, True, fold).path == "splitk"
        assert qm.w4_wrapper_plan(big, w, gs, True, fold).path == "wgmma"
        assert qm.w4_wrapper_plan(x.float(), w, gs, True, fold).path == "tile"
        off = torch.zeros(128 * 64 + 1, dtype=torch.int8)[1:].view(128, 64)
        assert qm.w4_wrapper_plan(x, off, gs, True, fold).path == "tile"


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M,K,N,G", W4_SHAPES)
def test_w4_fold_plan_covers_k_once_on_group_boundaries(M, K, N, G, packed):
    """The folded forms' plans: the exact forms' paths and split-K slices;
    only the wgmma block's x rows differ."""
    plan = _check_w4_plan(M, K, N, G, packed, fold=True)
    exact = qm.w4_plan(M, N, K, G, packed)
    assert plan.path == exact.path
    if plan.path != "wgmma":
        assert plan == exact


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("K,N", W4_KN)
def test_w4_fold_plan_prefill_shapes_take_the_wide_wgmma_block(K, N, packed):
    """The AWQ prefill's four products (M = 8,192): 256 x rows a block."""
    plan = _check_w4_plan(8192, K, N, 128, packed, fold=True)
    assert plan.path == "wgmma" and plan.mt == 256 and plan.grid[0] == 32 * N // 128


@pytest.mark.parametrize("M,N,bm", [(512, 4096, 128), (512, 6144, 256), (256, 14336, 256),
                                    (256, 4096, 128), (1024, 4096, 256), (65, 14336, 128),
                                    (16896, 16, 128), (17024, 16, 256)])
def test_w4_fold_wgmma_block_widens_past_one_wave(M, N, bm):
    """256 x rows a block once the 128-row grid has more than 132 tiles."""
    assert qm.w4_path_plan("wgmma", M, N, 4096, 128, True, fold=True).mt == bm
    assert qm.w4_path_plan("wgmma", M, N, 4096, 128, True).mt == 128


def test_w4_fold_plan_every_accepted_shape_has_a_path():
    rng = np.random.default_rng(2)
    for _ in range(2000):
        G = 16 * int(rng.integers(1, 17))
        packed = bool(rng.integers(2))
        K = G * int(rng.integers(1, 64)) * (2 if packed else 1)
        M, N = int(rng.integers(1, 3000)), 16 * int(rng.integers(1, 2000))
        _check_w4_plan(M, K, N, G, packed, bool(rng.integers(4)), bool(rng.integers(4)), True)


@pytest.mark.parametrize("M,N", [(8192, 4096), (8192, 14336), (1000, 14336), (4097, 1040),
                                 (257, 16), (2048, 6144)])
def test_w4_fold_wgmma_grid_covers_m_and_n_once(M, N):
    """The wide block's grid, in the kernel's raster (``w4_wgmma_tile``
    with its x rows), covers every 256 x 128 output tile once."""
    bm = qm.W4_WGMMA_WIDE_ROWS
    plan = qm.w4_path_plan("wgmma", M, N, 4096, 128, True, True, bm)
    assert plan.mt == bm and plan.tile == (bm, 128, 64)
    tiles_m, tiles_n = math.ceil(M / bm), math.ceil(N / 128)
    seen = np.zeros((tiles_m, tiles_n), np.int32)
    for block in range(plan.grid[0]):
        tm, tn = qm.w4_wgmma_tile(block, M, N, bm)
        assert 0 <= tm < tiles_m and 0 <= tn < tiles_n
        seen[tm, tn] += 1
    assert (seen == 1).all()


# The int8-KV decode kernel: (B, Hkv, G, C) of the Generator's main paths
# (Llama-3-8B and Gemma-2-9B widths at batch 4), a long batch, MHA and MQA,
# and capacities below one tile.
DECODE_BHGC = [(4, 8, 4, 2176), (4, 8, 2, 2176), (64, 8, 4, 4096), (1, 32, 1, 300),
               (3, 1, 8, 70), (2, 2, 5, 20), (1, 1, 1, 1), (1, 2, 3, 33)]
DECODE_DS = [32, 64, 72, 128, 200, 256]
DECODE_SMS = [132, 78]


def _decode_lengths(C):
    return sorted({0, 1, 2, C // 3, C // 2, C - 1, C, C + 5})


@pytest.mark.parametrize("sms", DECODE_SMS)
@pytest.mark.parametrize("D", DECODE_DS)
@pytest.mark.parametrize("B,Hkv,G,C", DECODE_BHGC)
def test_decode_plan_slices_cover_every_visible_key_once(B, Hkv, G, C, D, sms):
    plan = da.decode_plan(B, Hkv, G, C, D, sms)
    for length in _decode_lengths(C):
        for window in (0, 1, 7, C + 3):
            hi = min(length, C)
            lo = max(hi - window, 0) if window else 0
            seen = np.zeros(C + 1, np.int32)
            for z in range(plan.splits):
                c0, c1 = da.decode_split_range(length, C, window, plan.splits,
                                               plan.tile, z)
                if c1 > c0:
                    assert lo <= c0 and c1 <= hi
                    # Whole tiles, dealt out evenly, but the row's last.
                    assert (c0 - lo) % plan.tile == 0
                    assert c1 - c0 <= math.ceil(math.ceil((hi - lo) / plan.tile)
                                                / plan.splits) * plan.tile
                    seen[c0:c1] += 1
            assert (seen[lo:hi] == 1).all() and seen.sum() == hi - lo


@pytest.mark.parametrize("sms", DECODE_SMS)
@pytest.mark.parametrize("D", DECODE_DS)
@pytest.mark.parametrize("B,Hkv,G,C", DECODE_BHGC)
def test_decode_plan_fits_the_kernel(B, Hkv, G, C, D, sms):
    """What ``csrc/decode_attention_int8.cu`` assumes: 16 dims a lane on
    its FMA path, tiles of 64 keys, 1-64 splits (never more than the
    capacity has tiles), a grid that fits, counters only with a cross-block
    merge."""
    plan = da.decode_plan(B, Hkv, G, C, D, sms)
    assert plan.lanes in (8, 16) and plan.lanes * 16 >= D
    assert plan.lanes == 8 or D > 128
    assert plan.tile == da.DECODE_TILE == 64
    assert plan.gt in (1, 2, 4) and (plan.gt >= G or plan.gt == 4)
    assert 1 <= plan.splits <= min(da.DECODE_MAX_SPLITS, math.ceil(C / plan.tile))
    gtiles = math.ceil(G / plan.gt)
    assert plan.grid == (plan.splits, Hkv * gtiles, B)
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    groups = B * Hkv * gtiles
    assert plan.counters == (groups if plan.splits > 1 else 0)
    assert plan.counters <= da.DECODE_COUNTERS
    # As many splits as keep the grid in one wave of the blocks an SM
    # holds, as far as the capacity has tiles.
    resident = da.DECODE_BLOCKS_PER_SM * sms
    assert plan.splits == 1 or plan.splits * groups <= resident
    assert ((plan.splits + 1) * groups > resident
            or plan.splits == min(da.DECODE_MAX_SPLITS, math.ceil(C / plan.tile)))


def test_decode_plan_reads_shapes_only():
    """No length enters the plan, so every step of a generation launches the
    same grid (a CUDA graph can hold it)."""
    assert list(inspect.signature(da.decode_plan).parameters) == [
        "B", "Hkv", "G", "C", "D", "sms"]
    # The main path's shape: 8 splits, 256 blocks on 132 SMs.
    plan = da.decode_plan(4, 8, 4, 2176, 128)
    assert (plan.lanes, plan.gt, plan.tile, plan.splits) == (8, 4, 64, 8)
    assert da.decode_plan(4, 8, 2, 2176, 256)[:3] == (16, 2, 64)


@pytest.mark.parametrize("D", [0, 257, 512])
def test_decode_plan_raises_outside_its_head_dims(D):
    with pytest.raises(ValueError, match="head dims 1-256"):
        da.decode_plan(1, 1, 1, 16, D)


class _CardTensor:
    """Stands in for a CUDA tensor [B, H, T, D]: the dispatch rules read
    only ``is_cuda`` and ``shape``."""
    is_cuda = True

    def __init__(self, T, D):
        self.shape = (2, 4, T, D)


@pytest.mark.parametrize("D", [64, 128, 200, 256, 257, 288, 320, 512])
@pytest.mark.parametrize("T", [2047, 2048, 4096])
def test_flash_dispatch_declines_heads_wider_than_the_kernel(T, D):
    """``_flash_eligible`` sends a head dim to the flash kernel only up to
    its widest instance (``HEAD_DIMS[-1]``, 256); wider heads take the plain
    attention, whatever the lengths and switches."""
    q = _CardTensor(T, D)
    assert TT._flash_eligible(q, q) == (T >= 2048 and D <= HEAD_DIMS[-1])
    assert TT._flash_eligible(q, q, min_len=0) == (D <= HEAD_DIMS[-1])


@pytest.mark.parametrize("D", [1, 72, 128, 256, 257, 320, 512])
def test_decode_dispatch_declines_heads_wider_than_the_kernel(D, monkeypatch):
    """``_use_decode_kernel`` sends a single-token step to the int8-KV
    decode kernel only for head dims up to ``DECODE_MAX_D`` (256); wider
    heads dequantize the cache for the plain attention. The CPU and
    ``CT2TPU_DECODE_KERNEL=0`` never take the kernel."""
    q = _CardTensor(1, D)
    assert TT._use_decode_kernel(q) == (D <= da.DECODE_MAX_D)
    assert not TT._use_decode_kernel(torch.zeros(2, 4, 1, D))
    monkeypatch.setenv("CT2TPU_DECODE_KERNEL", "0")
    assert not TT._use_decode_kernel(q)


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
