"""Flash attention (prefill / full sequence).

Counterpart of ``ctranslate2_tpu/kernels/flash_attention.py``: blockwise
online-softmax attention that never materializes the [Tq, Tk] score matrix,
with GQA/MQA, causal masking with a query offset, per-batch KV lengths,
sliding windows, segment ids, ALiBi in both conventions and the T5
relative-position bias recomputed from its bucket table. The CUDA kernel is
``csrc/flash_attention.cu`` (wgmma fed by TMA for float16/bfloat16, plain
FMAs for float32), built for head dims 64 and 128; a smaller head dim is
zero-padded to the next of the two (``flash_head_dim``), as the JAX kernel
pads to 128.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build, count_launch
from .norms import DTYPE_CODES

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's instances; smaller D is padded up
# Under a causal mask the f16/bf16 kernel runs its query tiles last-first,
# the heaviest first, so the short ones fill the tail of the grid
# (chip_smoke.py times both orders at the prefill shape).
HEAVIEST_FIRST = True


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not lib.ct2_flash_attention.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ct2_flash_attention.restype = i
        lib.ct2_flash_attention.argtypes = (
            [p] * 9 + [i] * 6 + [f] + [i] * 6 + [f, i, i, p])
    return lib


def flash_head_dim(D: int) -> int:
    """The head dim the kernel runs for a head dim ``D``: the smallest of
    ``HEAD_DIMS`` that holds it (q, k and v are zero-padded up to it, which
    adds nothing to Q.K^T, and the output is sliced back). Raises
    NotImplementedError above 128: a D = 256 instance needs its own register
    plan (its output accumulators alone take 128 registers a thread)."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise NotImplementedError(
        f"flash_attention on the card takes head dims up to {HEAD_DIMS[-1]}, got {D}")


def relative_position_bucket(relp, num_buckets: int, max_distance: int,
                             bidirectional: bool):
    """T5 bucket index of ``relp = key position - query position``
    (reference: src/layers/attention.cc:51-101)."""
    if bidirectional:
        nbh = num_buckets // 2
        base = torch.where(relp > 0, nbh, 0)
        r = relp.abs()
    else:
        nbh = num_buckets
        base = torch.zeros_like(relp)
        r = -torch.clamp(relp, max=0)
    max_exact = nbh // 2
    r_safe = r.clamp(min=1).float()
    large = max_exact + (
        torch.log(r_safe / max_exact) / math.log(max_distance / max_exact)
        * (nbh - max_exact)).to(relp.dtype)
    large = large.clamp(max=nbh - 1)
    return base + torch.where(r < max_exact, r, large)


def _alibi_offs(alibi_positive: bool, q_offset: int, Tq: int) -> int:
    """The negative convention ends at 0 on the last valid key."""
    return 0 if alibi_positive else q_offset + Tq - 1


def flash_attention_plain(q, k, v, *, scale: float = 1.0, causal: bool = False,
                          q_offset: int = 0, lengths=None, window: int = 0,
                          segment_ids=None, alibi_slopes=None,
                          alibi_positive: bool = False, rel_bias_table=None,
                          rel_max_distance: int = 0,
                          rel_bidirectional: bool = True):
    """Plain PyTorch version of ``flash_attention``: the whole score matrix,
    float32 softmax, P cast to V's dtype before P.V."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qg = (q.float() * scale).reshape(B, Hkv, G, Tq, D)
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))  # [B,Hkv,G,Tq,Tk]
    s = s.reshape(B, Hq, Tq, Tk)
    q_pos = (torch.arange(Tq, device=dev) + q_offset)[:, None]
    k_pos = torch.arange(Tk, device=dev)[None, :]
    if alibi_slopes is not None:
        offs = _alibi_offs(alibi_positive, q_offset, Tq)
        s = s + alibi_slopes.float()[None, :, None, None] \
            * (k_pos - offs).float()[None, None]
    if rel_bias_table is not None:
        bucket = relative_position_bucket(
            k_pos - q_pos, rel_bias_table.shape[0], rel_max_distance,
            rel_bidirectional)  # [Tq, Tk]
        s = s + rel_bias_table.float().t()[:, bucket][None]
    mask = torch.ones((1, Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    if lengths is not None:
        mask = mask & (k_pos[None] < lengths[:, None, None])
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, 0.0)  # a fully masked row gives zeros
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = torch.matmul(p.to(v.dtype).reshape(B, Hkv, G, Tq, Tk), v[:, :, None])
    out = pv.float().reshape(B, Hq, Tq, D) / denom
    return out.to(q.dtype)


def flash_attention(q, k, v, *, scale: float = 1.0, causal: bool = False,
                    q_offset: int = 0, lengths=None, window: int = 0,
                    segment_ids=None, alibi_slopes=None,
                    alibi_positive: bool = False, rel_bias_table=None,
                    rel_max_distance: int = 0, rel_bidirectional: bool = True):
    """Blockwise attention; returns [B, Hq, Tq, D] in q's dtype.

    ``q`` [B, Hq, Tq, D]; ``k``/``v`` [B, Hkv, Tk, D]; ``lengths`` int32 [B]
    valid KV lengths; ``segment_ids`` int32 [B, T] (self-attention, Tq ==
    Tk); ``alibi_slopes`` f32 [Hq]; ``rel_bias_table`` [num_buckets, Hq], the
    learned T5 table as stored. ``scale`` is the caller's; the padding of
    a head dim off 64/128 never changes it. On the card the result comes back
    as a [B, Tq, Hq, D] buffer viewed as [B, Hq, Tq, D], so merging the heads
    afterwards copies nothing, for D in ``HEAD_DIMS``; any other D <= 128
    runs on zero-padded copies of q, k and v and returns a slice of the
    padded output, which a merge of the heads copies.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D]")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k and v of one dtype")
    if segment_ids is not None and (Tq != Tk or segment_ids.shape != (B, Tk)):
        raise ValueError("flash_attention takes segment_ids [B, T] with Tq == Tk")
    if rel_bias_table is not None and rel_bias_table.shape[1] != Hq:
        raise ValueError("rel_bias_table must be [num_buckets, Hq]")
    extras = [t for t in (lengths, segment_ids, alibi_slopes, rel_bias_table)
              if t is not None]
    devices = {t.device for t in [q, k, v] + extras}
    if len(devices) != 1:
        raise ValueError(f"flash_attention operands lie on {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, scale=scale, causal=causal, q_offset=q_offset,
            lengths=lengths, window=window, segment_ids=segment_ids,
            alibi_slopes=alibi_slopes, alibi_positive=alibi_positive,
            rel_bias_table=rel_bias_table, rel_max_distance=rel_max_distance,
            rel_bidirectional=rel_bidirectional)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32/float16/bfloat16, got {q.dtype}")
    Dk = flash_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))

    def strided(t):
        # The kernel addresses (batch, head, time) by strides (TMA tensor
        # maps for f16/bf16); it wants a dense last dim, 16-byte aligned rows
        # and a nonzero stride on every dimension longer than 1.
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)) \
                or t.data_ptr() % 16:
            t = t.contiguous()
        return t

    q, k, v = strided(q), strided(k), strided(v)
    out = torch.empty((B, Tq, Hq, Dk), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])

    def i32(t):
        return None if t is None else t.to(torch.int32).contiguous()

    lengths, segment_ids = i32(lengths), i32(segment_ids)
    slopes = None if alibi_slopes is None else alibi_slopes.float().contiguous()
    table, rel_nb, log_ratio = None, 0, 1.0
    if rel_bias_table is not None:
        rel_nb = rel_bias_table.shape[0]
        table = rel_bias_table.float().t().contiguous()  # [Hq, NB]
        nbh = rel_nb // 2 if rel_bidirectional else rel_nb
        log_ratio = math.log(rel_max_distance / (nbh // 2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().ct2_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            ptr(lengths), ptr(segment_ids), ptr(slopes), ptr(table),
            B, Hq, Hkv, Tq, Tk, Dk, scale, int(causal), q_offset, window,
            _alibi_offs(alibi_positive, q_offset, Tq), int(rel_bidirectional),
            rel_nb, log_ratio, DTYPE_CODES[q.dtype],
            int(causal and HEAVIEST_FIRST), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed with error {err} "
                           "(a CUDA error, or 9000 and up: no TMA tensor map)")
    count_launch("flash_attention")
    return out if Dk == D else out[..., :D]
