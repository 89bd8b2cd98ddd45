"""Quantized matmuls: W8A8 and the four AWQ-W4 products.

Counterparts of ``ctranslate2_tpu/kernels/quant_matmul.py``:

- ``matmul_w8a8``: int8 activations x int8 weights, f32 dequant epilogue.
  The CUDA kernels are ``csrc/w8a8_gemm.cu``: a split-K ``mma.sync`` path
  for small M and a TMA-fed ``wgmma`` path for large M, chosen by
  ``w8a8_plan``. Weights keep the model.bin layout, ``wq`` int8 [N, K]
  (out, in): K-major, what both paths take.
- ``matmul_w4a16`` / ``matmul_w4a16_fold``: float activations x ``w4``
  int8 (q - z) [K, N] x f32 group scales [K/G, N].
- ``matmul_w4p`` / ``matmul_w4p_fold``: float activations x ``w4p`` bytes
  [K/2, N] (low nibble row r, high nibble row r + K/2) x group scales and
  zero * scale terms [K/G, N].

The four W4 products share one CUDA source, ``csrc/w4_gemm.cu``, and keep
the JAX layouts: in float16/bfloat16 a split-K ``mma.sync`` path at small M
and a TMA-fed ``wgmma`` path above it, and a 64 x 64 tile for everything
else, chosen by ``w4_plan``. The ``_fold`` forms fold the scale into the
weight fragment (one rounding of ``payload * scale`` to the activation
type); they are not dispatched by ``linear()`` (as in the JAX package) and
are held by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from . import count_launch
from . import build


CARD_SMS = 132  # streaming multiprocessors of the H100 SXM
GRID_Y_MAX = 65535
# Split-K path: a block owns SPLITK_BN output columns x ``mt`` rows and
# streams K in stages of SPLITK_BK bytes; K is split until the grid holds
# about SPLITK_BLOCKS_PER_SM blocks an SM.
SPLITK_BN = 64
SPLITK_BK = 128
SPLITK_MTS = (8, 16, 32, 64)
SPLITK_BLOCKS_PER_SM = 4
# wgmma path: 128 x 128 output tiles, K in 128-byte stages, taken from
# WGMMA_MIN_M rows on: at M = 128 and 2,048 it measured faster than split-K
# at every main-path (K, N), at M = 4 slower (chip_smoke.py times both).
WGMMA_TILE = 128
WGMMA_MIN_M = 128


class W8A8Plan(NamedTuple):
    """How ``matmul_w8a8`` runs one (M, N, K) on the card.

    ``path``: "wgmma" (TMA-fed s8 wgmma, large M), "splitk" (cp.async
    ring, mma.sync with the weights as the A operand, K split across
    blocks) or "ragged" (the split-K kernel with byte-wise loads, for K off
    a multiple of 16 or unaligned operands). ``k_chunk`` bytes of K a
    slice, ``splits`` slices; ``tile`` (rows, columns, K bytes a stage);
    ``grid`` the CUDA grid; ``workspace`` int32 entries of the split-K
    workspace, M * N sums then a counter a tile (0: none).
    """
    path: str
    mt: int
    splits: int
    k_chunk: int
    tile: Tuple[int, int, int]
    grid: Tuple[int, int, int]
    workspace: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def w8a8_plan(M: int, N: int, K: int, aligned: bool = True) -> W8A8Plan:
    """The path, split and grid of ``matmul_w8a8`` for q [M, K] x wq [N, K].

    ``aligned``: both int8 operands start on 16 bytes. Raises ValueError for
    an M beyond the grid of the ragged path."""
    vec = aligned and K % 16 == 0
    if vec and M >= WGMMA_MIN_M and N >= WGMMA_TILE and K >= WGMMA_TILE:
        tiles = _cdiv(M, WGMMA_TILE) * _cdiv(N, WGMMA_TILE)
        return W8A8Plan("wgmma", WGMMA_TILE, 1, K,
                        (WGMMA_TILE, WGMMA_TILE, WGMMA_TILE), (tiles, 1, 1), 0)
    mt = next((m for m in SPLITK_MTS if M <= m), SPLITK_MTS[-1])
    tiles_n, tiles_m = _cdiv(N, SPLITK_BN), _cdiv(M, mt)
    if tiles_m > GRID_Y_MAX:
        raise ValueError(f"matmul_w8a8: M={M} exceeds the kernel's grid "
                         f"({GRID_Y_MAX} x {mt} rows)")
    steps = max(1, _cdiv(K, SPLITK_BK))
    want = _cdiv(SPLITK_BLOCKS_PER_SM * CARD_SMS, max(1, tiles_n * tiles_m))
    per = _cdiv(steps, max(1, min(steps, want)))
    splits = _cdiv(steps, per)
    workspace = M * N + tiles_n * tiles_m if splits > 1 else 0
    return W8A8Plan("splitk" if vec else "ragged", mt, splits, per * SPLITK_BK,
                    (mt, SPLITK_BN, SPLITK_BK), (tiles_n, tiles_m, splits),
                    workspace)


def _lib() -> ctypes.CDLL:
    lib = build.load("w8a8_gemm")
    if not lib.ct2_w8a8_gemm_splitk.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ct2_w8a8_gemm_splitk.restype = i
        lib.ct2_w8a8_gemm_splitk.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.ct2_w8a8_gemm_wgmma.restype = i
        lib.ct2_w8a8_gemm_wgmma.argtypes = [p] * 5 + [i] * 3 + [p]
    return lib


def _check(q, wq, a_scale, w_scale):
    if q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("matmul_w8a8 takes int8 activations and weights, got "
                        f"{q.dtype} and {wq.dtype}")
    if a_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("matmul_w8a8 takes float32 scales")
    if q.dim() != 2 or wq.dim() != 2 or q.shape[1] != wq.shape[1]:
        raise ValueError("matmul_w8a8 takes q [M, K] and wq [N, K], got "
                         f"{tuple(q.shape)} and {tuple(wq.shape)}")
    if a_scale.shape != (q.shape[0],) or w_scale.shape != (wq.shape[0],):
        raise ValueError("matmul_w8a8 takes a_scale [M] and w_scale [N]")
    devices = {t.device for t in (q, wq, a_scale, w_scale)}
    if len(devices) != 1:
        raise ValueError(f"matmul_w8a8 operands lie on {sorted(map(str, devices))}")


def matmul_w8a8_plain(q, wq, a_scale, w_scale):
    """Plain PyTorch version: the int8 product in float64 (exact, since
    |sum| < 2**53), rounded to float32 like an int32 accumulator, then the
    same epilogue as the kernel."""
    acc = torch.matmul(q.to(torch.float64), wq.to(torch.float64).t())
    a = torch.where(a_scale == 0, torch.ones_like(a_scale), a_scale)
    return acc.to(torch.float32) / (a[:, None] * w_scale[None, :])


_w8a8_workspace_cache: Dict[Tuple[int, int], torch.Tensor] = {}
_w8a8_workspace_lock = threading.Lock()


def _w8a8_workspace(device, stream: int, entries: int) -> torch.Tensor:
    """The split-K path's int32 workspace for (device, stream), at least
    ``entries`` long: zeroed once when made (or grown), and left zeroed by
    every call (the last block of each tile zeroes the sums it read and its
    counter), so a call needs no memset. Keyed by stream, so that kernels of
    two streams never share it. While a CUDA graph is being captured, a
    buffer that the stream does not have yet, or too short a one, is made
    for that call alone: its zeroing becomes a node of the graph, and
    nothing made inside a capture is kept."""
    key = (device.index, stream)
    with _w8a8_workspace_lock:
        buf = _w8a8_workspace_cache.get(key)
        if buf is None or buf.numel() < entries:
            buf = torch.zeros(entries, dtype=torch.int32, device=device)
            if not torch.cuda.is_current_stream_capturing():
                _w8a8_workspace_cache[key] = buf
        return buf


def _w8a8_launch(q, wq, a_scale, w_scale, plan: W8A8Plan):
    """Runs ``plan`` on the card (the wrapper's body, without its checks)."""
    M, K = q.shape
    N = wq.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), wq.data_ptr(), a_scale.data_ptr(),
                w_scale.data_ptr(), out.data_ptr())
        if plan.path == "wgmma":
            err = _lib().ct2_w8a8_gemm_wgmma(*args, M, N, K, stream)
        else:
            ws = (_w8a8_workspace(q.device, stream, plan.workspace)
                  if plan.workspace else None)
            err = _lib().ct2_w8a8_gemm_splitk(
                *args, None if ws is None else ws.data_ptr(), M, N, K, plan.mt,
                plan.k_chunk, plan.splits, int(plan.path == "splitk"), stream)
    if err:
        if plan.workspace:  # it may hold partial sums now
            with _w8a8_workspace_lock:
                _w8a8_workspace_cache.pop((q.device.index, stream), None)
        raise RuntimeError(f"w8a8_gemm ({plan.path}) launch failed with error {err} "
                           "(a CUDA error, or 9000 and up: no TMA tensor map)")
    return out


def matmul_w8a8(q, wq, a_scale, w_scale):
    """``q`` int8 [M, K], ``wq`` int8 [N, K], ``a_scale`` f32 [M],
    ``w_scale`` f32 [N] -> f32 [M, N] = (q @ wq.T) / (a_scale ⊗ w_scale),
    with a zero ``a_scale`` read as 1."""
    _check(q, wq, a_scale, w_scale)
    if q.device.type == "cpu":
        return matmul_w8a8_plain(q, wq, a_scale, w_scale)
    if q.device.type != "cuda":
        raise ValueError(f"matmul_w8a8 has no kernel for {q.device}")
    for t in (q, wq, a_scale, w_scale):
        if not t.is_contiguous():
            raise ValueError("matmul_w8a8 takes contiguous tensors")
    M, K = q.shape
    aligned = q.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    out = _w8a8_launch(q, wq, a_scale, w_scale,
                       w8a8_plan(M, wq.shape[0], K, aligned))
    count_launch("matmul_w8a8")
    return out


# ---------------------------------------------------------------------------
# AWQ W4: group-quantized weights, float activations.
# ---------------------------------------------------------------------------

W4_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
W4_MAX_ROWS = 65535 * 64  # gridDim.y of the kernels' 64-row tiles
# Split-K path (``matmul_w4a16`` / ``matmul_w4p``, float16/bfloat16): a
# block owns W4_SPLITK_BN output columns x ``mt`` rows and streams its slice
# of the payload rows in stages of W4_SPLITK_BK; K is split on group
# boundaries until the grid holds about W4_SPLITK_BLOCKS_PER_SM blocks an SM
# (eight ran faster than four at the decode shapes on the card). wgmma
# path: one block a W4_WGMMA_TILE (x rows, weight columns, payload rows a
# stage), the whole K. float32, an unaligned payload and N off a multiple of
# 16 take the tile kernel in every form: W4_TILE (rows, columns, payload
# rows a stage).
W4_SPLITK_BN = 64
W4_SPLITK_BK = 64
W4_SPLITK_MTS = (8, 16, 32, 64)
W4_SPLITK_BLOCKS_PER_SM = 8
W4_WGMMA_TILE = (128, 128, 64)
# The folded forms' wgmma path takes W4_WGMMA_WIDE_ROWS x rows a block where
# the 128-row grid needs more than one wave of CARD_SMS blocks: there the
# wider block is faster (its A fragments, the scales folded in, serve twice
# the rows), within one wave slower (half the blocks, each twice as long).
# chip_smoke.py's w4_crossover rows time both blocks of the folded forms.
W4_WGMMA_WIDE_ROWS = 256
# The crossover (chip_smoke.py's kernel_w4 and w4_crossover rows: both
# forms, float16, the four Llama (K, N); H100 80GB HBM3, 700 W). At M = 4
# split-K takes 9.4-33.2 us, wgmma 40.3-173.1: split-K up to W4_SPLITK_MAX_M
# rows. From M = 65 wgmma: where its grid has 48 tiles or more it takes
# 41.5-58.2 us at M = 65-128 against split-K's 56.2-176.0, over 32 tiles
# with K = 4,096 the two are within 7% either way, and from M = 256 on it
# is faster at every shape (2.1-2.9x at M = 8,192). Over fewer than
# W4_WGMMA_MIN_TILES tiles with K of W4_SPLITK_LONG_K or more (K 14,336,
# N 4,096 at M <= 128: 32 blocks, each over the whole K) split-K, whose K
# split fills the card, stays 8-29% faster. The folded forms take the same
# rule (their w4_crossover rows).
W4_SPLITK_MAX_M = 64
W4_WGMMA_MIN_TILES = 33
W4_SPLITK_LONG_K = 8192
W4_TILE = (64, 64, 32)
W4_PATHS = ("splitk", "wgmma", "tile")
# Per-tile counters of the split-K path's last-block sum. A split count
# above 1 needs fewer tiles than blocks wanted, so this many always suffice.
W4_COUNTERS = W4_SPLITK_BLOCKS_PER_SM * CARD_SMS


class W4Plan(NamedTuple):
    """How a W4 product runs one shape on the card.

    ``path``: "splitk" (swap-AB ``mma.sync`` over a ``cp.async`` ring, K
    split across blocks, deterministic cross-block sum), "wgmma" (swap-AB
    ``wgmma`` with the weights as register A fragments, x by TMA, one block
    a 128 x 128 output tile; ``grid`` counts the tiles, laid out in a
    grouped raster by the kernel) or "tile" (a 64 x 64 output tile, one
    block for the whole K). ``k_chunk`` payload rows a slice (a multiple of
    G), ``splits`` slices; ``tile`` (rows, columns, payload rows a stage);
    ``grid`` the CUDA grid; ``counters`` the per-tile counters the split-K
    sum needs (0: none, the f32 partials then skip the workspace).
    """
    path: str
    mt: int
    splits: int
    k_chunk: int
    tile: Tuple[int, int, int]
    grid: Tuple[int, int, int]
    counters: int


def w4_plan(M: int, N: int, K: int, G: int, packed: bool, aligned: bool = True,
            half: bool = True, fold: bool = False) -> W4Plan:
    """The path, split and grid of a W4 product for x [M, K] and a group
    size G: ``matmul_w4a16`` (``packed`` False) or ``matmul_w4p``, or with
    ``fold`` their folded forms.

    ``aligned``: the payload starts on 16 bytes; ``half``: float16/bfloat16
    activations. In a half type with an aligned payload and N % 16 == 0,
    the split-K path takes M up to ``W4_SPLITK_MAX_M`` and a long K on a
    wgmma grid of few tiles (``W4_WGMMA_MIN_TILES``, ``W4_SPLITK_LONG_K``),
    the wgmma path every other M; every other shape takes the tile."""
    if not (half and aligned and N % 16 == 0):
        return w4_path_plan("tile", M, N, K, G, packed, fold)
    bm, bn, _ = W4_WGMMA_TILE
    few_tiles = _cdiv(M, bm) * _cdiv(N, bn) < W4_WGMMA_MIN_TILES
    splitk = M <= W4_SPLITK_MAX_M or (few_tiles and K >= W4_SPLITK_LONG_K)
    return w4_path_plan("splitk" if splitk else "wgmma", M, N, K, G, packed, fold)


def w4_path_plan(path: str, M: int, N: int, K: int, G: int, packed: bool,
                 fold: bool = False, rows: int = 0) -> W4Plan:
    """The plan of ``path`` (one of ``W4_PATHS``) for this shape, whichever
    path ``w4_plan`` picks: the split-K and wgmma paths need a half type, an
    aligned payload and N % 16 == 0; the tile takes every shape. Only the
    wgmma path's tile depends on ``fold``: 128 x rows a block, or for the
    folded forms ``W4_WGMMA_WIDE_ROWS`` past one wave; ``rows`` (128 or,
    folded, ``W4_WGMMA_WIDE_ROWS``) sets them instead, for timing."""
    payload_rows = K // 2 if packed else K
    if path == "tile":
        return W4Plan("tile", W4_TILE[0], 1, payload_rows, W4_TILE,
                      (_cdiv(N, W4_TILE[1]), _cdiv(M, W4_TILE[0]), 1), 0)
    if path == "wgmma":
        bm, bn, bk = W4_WGMMA_TILE
        if rows:
            if rows not in ((bm, W4_WGMMA_WIDE_ROWS) if fold else (bm,)):
                raise ValueError(f"w4_path_plan: no wgmma block of {rows} x rows")
            bm = rows
        elif fold and _cdiv(M, bm) * _cdiv(N, bn) > CARD_SMS:
            bm = W4_WGMMA_WIDE_ROWS
        return W4Plan("wgmma", bm, 1, payload_rows, (bm, bn, bk),
                      (_cdiv(M, bm) * _cdiv(N, bn), 1, 1), 0)
    if path != "splitk":
        raise ValueError(f"w4_path_plan: no path {path!r} (one of {W4_PATHS})")
    mt = next((m for m in W4_SPLITK_MTS if M <= m), W4_SPLITK_MTS[-1])
    tiles_n, tiles_m = _cdiv(N, W4_SPLITK_BN), _cdiv(M, mt)
    unit = G * W4_SPLITK_BK // math.gcd(G, W4_SPLITK_BK)  # whole groups and stages
    units = max(1, _cdiv(payload_rows, unit))
    want = _cdiv(W4_SPLITK_BLOCKS_PER_SM * CARD_SMS, max(1, tiles_n * tiles_m))
    per = _cdiv(units, max(1, min(units, want)))
    splits = _cdiv(units, per)
    return W4Plan("splitk", mt, splits, per * unit, (mt, W4_SPLITK_BN, W4_SPLITK_BK),
                  (tiles_n, tiles_m, splits), tiles_n * tiles_m if splits > 1 else 0)


W4_WGMMA_RASTER = 8  # x-row tiles of a raster group (the kernel's WG_GROUP)


def w4_wgmma_tile(block: int, M: int, N: int, bm: int = W4_WGMMA_TILE[0]) -> Tuple[int, int]:
    """The (x-row tile, weight-column tile) that block ``block`` of the
    wgmma path computes for ``bm`` x rows a block: the kernels' own rule
    (``w4_wgmma_kernel``, ``w4_wgmma_fold_kernel`` in the CUDA source).
    Blocks walk groups of ``W4_WGMMA_RASTER`` row tiles, each group over
    every column tile, so that the blocks in flight share their x panels and
    payload columns in L2."""
    bn = W4_WGMMA_TILE[1]
    tiles_m, tiles_n = _cdiv(M, bm), _cdiv(N, bn)
    first_m = block // (W4_WGMMA_RASTER * tiles_n) * W4_WGMMA_RASTER
    group_m = min(tiles_m - first_m, W4_WGMMA_RASTER)
    return (first_m + block % group_m,
            block % (W4_WGMMA_RASTER * tiles_n) // group_m)


_w4_counter_cache: Dict[Tuple[int, int], torch.Tensor] = {}
_w4_counter_lock = threading.Lock()


def _w4_counters(device, stream: int) -> torch.Tensor:
    """The split-K path's per-tile counters for (device, stream): zeroed
    once when made; each last block re-zeroes its own, so a call needs no
    memset. Keyed by stream, so that kernels of two streams never share a
    counter. While a CUDA graph is being captured, a buffer that the stream
    does not have yet is made for that call alone: its zeroing becomes a
    node of the graph, and nothing made inside a capture is kept."""
    key = (device.index, stream)
    with _w4_counter_lock:
        buf = _w4_counter_cache.get(key)
        if buf is None:
            buf = torch.zeros(W4_COUNTERS, dtype=torch.int32, device=device)
            if not torch.cuda.is_current_stream_capturing():
                _w4_counter_cache[key] = buf
        return buf


def _w4_lib() -> ctypes.CDLL:
    lib = build.load("w4_gemm")
    if not lib.ct2_w4_gemm.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ct2_w4_gemm.restype = i
        lib.ct2_w4_gemm.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.ct2_w4_gemm_splitk.restype = i
        lib.ct2_w4_gemm_splitk.argtypes = [p] * 7 + [i] * 10 + [p]
        lib.ct2_w4_gemm_wgmma.restype = i
        lib.ct2_w4_gemm_wgmma.argtypes = [p] * 6 + [i] * 8 + [p]
    return lib


def _w4_check(name, x, w, g_scale, g_zs, packed):
    """Types, shapes and devices every W4 product takes (CPU and card)."""
    if x.dtype not in W4_DTYPE_CODES:
        raise TypeError(f"{name} takes float32/float16/bfloat16 activations, got {x.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"{name} takes an int8 payload, got {w.dtype}")
    scales = [g_scale] + ([g_zs] if packed else [])
    if any(t.dtype != torch.float32 for t in scales):
        raise TypeError(f"{name} takes float32 group scales")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name} takes x [M, K] and a 2-D payload, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    K, N = x.shape[1], w.shape[1]
    rows = K // 2 if packed else K
    ng = g_scale.shape[0] if g_scale.dim() == 2 else 0
    if (w.shape[0] != rows or (packed and K % 2) or ng == 0 or K % ng
            or any(tuple(t.shape) != (ng, N) for t in scales)):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, payload {tuple(w.shape)} and scales "
            f"{[tuple(t.shape) for t in scales]} do not fit together (payload "
            f"[{'K/2' if packed else 'K'}, N], scales [K/G, N])")
    devices = {t.device for t in [x, w] + scales}
    if len(devices) != 1:
        raise ValueError(f"{name} operands lie on {sorted(map(str, devices))}")


def _w4_limit(x_shape, w_shape, g_scale_shape, packed) -> str:
    """Why the CUDA kernel cannot take these shapes ("" when it can): G
    divides K and is a multiple of 16 (one mma k-step stays in one group);
    packed, (K/2) % G == 0 too; M at most ``W4_MAX_ROWS``."""
    M, K = x_shape
    G = K // g_scale_shape[0]
    if G % 16:
        return f"group size {G} is not a multiple of 16"
    if packed and (K // 2) % G:
        return f"K/2 = {K // 2} is not a multiple of the group size {G}"
    if M > W4_MAX_ROWS:
        return f"M = {M} exceeds {W4_MAX_ROWS} rows"
    return ""


def w4a16_supported(x_shape, w4_shape, g_scale_shape) -> bool:
    K = w4_shape[0]
    if not g_scale_shape[0] or K % g_scale_shape[0]:
        return False
    return not _w4_limit(x_shape, w4_shape, g_scale_shape, packed=False)


def w4p_supported(x_shape, w4p_shape, g_scale_shape) -> bool:
    K = x_shape[-1]
    if K != 2 * w4p_shape[0] or not g_scale_shape[0] or K % g_scale_shape[0]:
        return False
    return not _w4_limit(x_shape, w4p_shape, g_scale_shape, packed=True)


def _w4p_values(w4p):
    """[K/2, N] packed bytes -> [K, N] float32 nibble values (read unsigned)."""
    u = w4p.view(torch.uint8)
    return torch.cat([u & 0xF, u >> 4]).float()


def matmul_w4a16_plain(x, w4, g_scale):
    """Plain PyTorch version of the TPU kernel's arithmetic: per group g, a
    float32 partial dot times the group's scale row, summed in float32."""
    M, K = x.shape
    ng = g_scale.shape[0]
    G = K // ng
    x32 = x.float()
    acc = x32.new_zeros((M, w4.shape[1]))
    for g in range(ng):
        sl = slice(g * G, (g + 1) * G)
        acc = acc + (x32[:, sl] @ w4[sl].float()) * g_scale[g]
    return acc


def matmul_w4p_plain(x, w4p, g_scale, g_zs):
    """Plain PyTorch version: per group g,
    ``acc += (x_g @ q_g) * s[g] - rowsum(x_g) * zs[g]`` in float32."""
    M, K = x.shape
    ng = g_scale.shape[0]
    G = K // ng
    x32 = x.float()
    q = _w4p_values(w4p)
    acc = x32.new_zeros((M, w4p.shape[1]))
    for g in range(ng):
        sl = slice(g * G, (g + 1) * G)
        xg = x32[:, sl]
        acc = acc + (xg @ q[sl]) * g_scale[g] - xg.sum(1, keepdim=True) * g_zs[g]
    return acc


def matmul_w4a16_fold_plain(x, w4, g_scale):
    """Plain PyTorch version of the scale-folded form: one float32 dot with
    the scales folded into the weights."""
    G = x.shape[1] // g_scale.shape[0]
    return x.float() @ (w4.float() * g_scale.repeat_interleave(G, dim=0))


def _w4p_zero_term(x, g_zs):
    """``rowsum_g(x) @ g_zs``: the zero-point term of the folded packed form,
    outside the kernel (the JAX package leaves it to XLA)."""
    M, K = x.shape
    ng = g_zs.shape[0]
    return x.float().reshape(M, ng, K // ng).sum(-1) @ g_zs


def _w4p_sub_zero_term(out, x, g_zs):
    """``out -= rowsum_g(x) @ g_zs`` on the card: the group sums in float32
    straight from x (no float32 copy of x), then one product into ``out``."""
    M, K = x.shape
    ng = g_zs.shape[0]
    rs = x.reshape(M, ng, K // ng).sum(-1, dtype=torch.float32)
    return out.addmm_(rs, g_zs, alpha=-1)


def matmul_w4p_fold_plain(x, w4p, g_scale, g_zs):
    """Plain PyTorch version of the scale-folded packed form:
    ``x @ (q * s) - rowsum_g(x) @ zs`` in float32."""
    G = x.shape[1] // g_scale.shape[0]
    w = _w4p_values(w4p) * g_scale.repeat_interleave(G, dim=0)
    return x.float() @ w - _w4p_zero_term(x, g_zs)


def w4_error_bound(x, payload, g_scale, g_zs, fold):
    """Elementwise bound on |kernel - plain| for one W4 product (the
    tolerance the tests and ``chip_smoke.py`` hold the kernels to), from the
    sum of the absolute terms of each output: 2**-16 of it for float32 sums
    taken in another order (the tensor cores' included), plus, for a folded
    kernel with half activations, one rounding of ``payload * scale`` to the
    activation type (2**-11 float16, 2**-8 bfloat16) on each term. A wrong
    group, nibble half or zero term moves an output by about its own size,
    far above this bound. ``g_zs`` is None for the unpacked payload."""
    G = x.shape[1] // g_scale.shape[0]
    values = payload.float() if g_zs is None else _w4p_values(payload)
    scaled = values.abs() * g_scale.repeat_interleave(G, 0)
    ax = x.float().abs()
    terms = ax @ scaled
    if g_zs is not None:
        terms = terms + ax @ g_zs.repeat_interleave(G, 0)
    half_u = {torch.float16: 2.0 ** -11, torch.bfloat16: 2.0 ** -8}.get(x.dtype, 0.0)
    return 2.0 ** -16 * terms + (half_u * (ax @ scaled) if fold else 0.0)


def w4_wrapper_plan(x, w, g_scale, packed, fold) -> W4Plan:
    """The plan the wrapper runs for these operands (``w4_plan``'s)."""
    M, K = x.shape
    N = w.shape[1]
    G = K // g_scale.shape[0]
    return w4_plan(M, N, K, G, packed, w.data_ptr() % 16 == 0,
                   x.dtype != torch.float32, fold)


def _w4_run(x, w, g_scale, g_zs, packed, fold, plan: W4Plan):
    """Runs ``plan`` on the card (the wrapper's body, after its checks; x
    contiguous and 16-byte aligned). Returns f32 [M, N]."""
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    G = K // g_scale.shape[0]
    zs_ptr = None if g_zs is None else g_zs.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.path == "splitk":
            part = counters = None
            if plan.splits > 1:
                part = torch.empty((plan.splits, M, N), dtype=torch.float32,
                                   device=x.device)
                counters = _w4_counters(x.device, stream)
                if plan.counters > counters.numel():
                    raise ValueError(f"w4_gemm: {plan.counters} tiles exceed the "
                                     f"{counters.numel()} split-K counters")
            err = _w4_lib().ct2_w4_gemm_splitk(
                x.data_ptr(), w.data_ptr(), g_scale.data_ptr(), zs_ptr,
                out.data_ptr(), None if part is None else part.data_ptr(),
                None if counters is None else counters.data_ptr(), M, N, K, G,
                W4_DTYPE_CODES[x.dtype], int(packed), int(fold), plan.mt, plan.k_chunk,
                plan.splits, stream)
        elif plan.path == "wgmma":
            # matmul_w4p: rowsum(x_g) [K/G, M rounded up to 4] for the zero
            # term, made by the kernel's first launch.
            rs = (torch.empty((K // G, _cdiv(M, 4) * 4), dtype=torch.float32,
                              device=x.device) if packed and not fold else None)
            err = _w4_lib().ct2_w4_gemm_wgmma(
                x.data_ptr(), w.data_ptr(), g_scale.data_ptr(), zs_ptr,
                out.data_ptr(), None if rs is None else rs.data_ptr(), M, N, K, G,
                W4_DTYPE_CODES[x.dtype], int(packed), int(fold), plan.mt, stream)
        else:
            vec = int(N % 16 == 0 and w.data_ptr() % 16 == 0)
            err = _w4_lib().ct2_w4_gemm(
                x.data_ptr(), w.data_ptr(), g_scale.data_ptr(), zs_ptr,
                out.data_ptr(), M, N, K, G, W4_DTYPE_CODES[x.dtype], int(packed),
                int(fold), vec, stream)
    if err:
        raise RuntimeError(f"w4_gemm ({plan.path}) launch failed with error {err} "
                           "(a CUDA error, or 9000 and up: no TMA tensor map)")
    return out


def _w4_launch(name, x, w, g_scale, g_zs, packed, fold):
    if x.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {x.device}")
    why = _w4_limit(tuple(x.shape), tuple(w.shape), tuple(g_scale.shape), packed)
    if why:
        raise ValueError(f"{name}: the CUDA kernel does not take x "
                         f"{tuple(x.shape)} x payload {tuple(w.shape)} with "
                         f"scales {tuple(g_scale.shape)}: {why}")
    for t in (w, g_scale, g_zs):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous payload and scales")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # a view that starts off the kernel's 16-byte loads
    out = _w4_run(x, w, g_scale, g_zs, packed, fold,
                  w4_wrapper_plan(x, w, g_scale, packed, fold))
    if out.numel():
        count_launch(name)
    return out


def matmul_w4a16(x, w4, g_scale):
    """``x`` [M, K] float, ``w4`` int8 (q - z) [K, N], ``g_scale`` f32
    [K/G, N] -> f32 [M, N] = ``x @ (w4 * expand(g_scale))``."""
    _w4_check("matmul_w4a16", x, w4, g_scale, None, packed=False)
    if x.device.type == "cpu":
        return matmul_w4a16_plain(x, w4, g_scale)
    return _w4_launch("matmul_w4a16", x, w4, g_scale, None, False, False)


def matmul_w4a16_fold(x, w4, g_scale):
    """``matmul_w4a16`` with the scales folded into the weight tile (one
    product per k-step; the kernel rounds ``(q - z) * s`` to x's type)."""
    _w4_check("matmul_w4a16_fold", x, w4, g_scale, None, packed=False)
    if x.device.type == "cpu":
        return matmul_w4a16_fold_plain(x, w4, g_scale)
    return _w4_launch("matmul_w4a16_fold", x, w4, g_scale, None, False, True)


def matmul_w4p(x, w4p, g_scale, g_zs):
    """``x`` [M, K] float, ``w4p`` int8 bytes [K/2, N] (low nibble row r,
    high nibble row r + K/2, read unsigned), ``g_scale``/``g_zs`` f32
    [K/G, N] -> f32 [M, N] = ``x @ (q * s - zs)`` per group."""
    _w4_check("matmul_w4p", x, w4p, g_scale, g_zs, packed=True)
    if x.device.type == "cpu":
        return matmul_w4p_plain(x, w4p, g_scale, g_zs)
    return _w4_launch("matmul_w4p", x, w4p, g_scale, g_zs, True, False)


def matmul_w4p_fold(x, w4p, g_scale, g_zs):
    """``matmul_w4p`` with the scales folded into the weight tile; the
    zero-point term ``rowsum_g(x) @ g_zs`` is one float32 matmul outside
    the kernel."""
    _w4_check("matmul_w4p_fold", x, w4p, g_scale, g_zs, packed=True)
    if x.device.type == "cpu":
        return matmul_w4p_fold_plain(x, w4p, g_scale, g_zs)
    out = _w4_launch("matmul_w4p_fold", x, w4p, g_scale, None, True, True)
    return _w4p_sub_zero_term(out, x, g_zs)
