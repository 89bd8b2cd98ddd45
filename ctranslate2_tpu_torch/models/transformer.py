"""Transformer encoder/decoder forwards on torch tensors.

Port of ``ctranslate2_tpu/models/transformer.py`` for the encoder-decoder
main path (reference: src/layers/transformer.cc, src/layers/attention.cc):

- inputs are padded; padding is handled with additive masks;
- the self-attention KV cache has a fixed capacity and is written IN PLACE
  at the decode position. Single-token steps attend over the pre-append
  cache plus the fresh token, then append, as the JAX package does;
- cross-attention keys/values are computed once per source sequence and
  shared across beams by folding the beam into the query time axis;
- GQA keeps KV heads un-replicated.

Beam reorder goes through the fused gather kernel (``cache_gather_rows``).
Decoder-only models run with rotary positions, an optional int8 KV cache
(``CT2TPU_KV_CACHE=int8``: int8 payloads plus one scale per cached vector,
read by the int8 decode kernel) and, for a long prompt's first prefill, the
flash kernel. The architecture features of the JAX package run too: ALiBi
(both conventions, ``scale_alibi``), Shaw and T5 relative positions,
sliding windows with O(window) ring caches (``ring_block``), merged
self+cross attention (T5Gemma2), sandwich-norm (Gemma-2/3, T5Gemma) and
parallel-residual (GPT-J, GPT-NeoX, Falcon) layers. The JAX package's
stacked (scan) layers are an XLA compile-time device; the port's per-layer
loop is their counterpart and reads their stacked parameters
(``params_from_numpy``). Whisper's encoder (two GELU convolutions, a
learned position table, a pre-norm stack: ``speech_encoder_forward``) runs
here; ``decoder_forward`` also returns the pre-softmax cross-attention
scores of chosen (layer, head) pairs for Whisper's alignment.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from ..kernels.decode_attention import (DECODE_MAX_D, decode_attention_int8,
                                        quantize_kv)
from ..kernels.flash_attention import HEAD_DIMS, flash_attention
from ..kernels.gather_rows import gather_rows_fused
from ..ops import attention as attn_ops
from ..ops.activations import gelu, get_activation
from ..ops.conv import conv1d
from ..ops.linear import linear, quantize_input
from ..ops.norms import add_and_norm, apply_norm
from ..ops.positions import (alibi_slopes, apply_rotary, rotary_tables,
                             sinusoidal_position_encoding)
from .spec import ArchSpec, AttentionSpec


# ---------------------------------------------------------------------------
# Constants.
# ---------------------------------------------------------------------------


def _rotary_consts(spec: AttentionSpec, attn_params: dict, max_positions: int,
                   device):
    r = spec.rotary
    dim = r.dim if r.dim else spec.head_dim
    long_factor = attn_params.get("rotary_long_factor")
    short_factor = attn_params.get("rotary_short_factor")
    sin, cos = rotary_tables(
        max_positions,
        dim,
        base=r.base,
        interleave=r.interleave,
        scaling_type=r.scaling_type,
        scaling_factor=r.scaling_factor,
        long_factor=(long_factor.cpu().numpy()
                     if long_factor is not None else None),
        short_factor=(short_factor.cpu().numpy()
                      if short_factor is not None else None),
        low_freq_factor=r.low_freq_factor,
        high_freq_factor=r.high_freq_factor,
        original_max_position_embeddings=r.original_max_position_embeddings,
        max_position_embeddings=r.max_position_embeddings,
    )
    return {"sin": torch.from_numpy(np.ascontiguousarray(sin)).to(device),
            "cos": torch.from_numpy(np.ascontiguousarray(cos)).to(device)}


def make_consts(arch: ArchSpec, params: dict, max_positions: int = 4096,
                device="cpu") -> dict:
    """Precompute the sinusoidal and rotary position tables and the ALiBi
    slopes on ``device``. Layers with the same rotary spec share one pair of
    tables."""
    consts: dict = {"max_positions": max_positions}
    for side, spec in (("encoder", arch.encoder), ("decoder", arch.decoder)):
        if spec is None:
            continue
        side_consts: dict = {}
        if spec.sinusoidal_positions:
            embs = params[side]["embeddings"]
            dim = embs[0].get("w", embs[0].get("wq")).shape[-1]
            if spec.embeddings.num_features > 1 and spec.embeddings.merge == "concat":
                dim = sum(e.get("w", e.get("wq")).shape[-1] for e in embs)
            side_consts["sinusoidal"] = torch.from_numpy(
                sinusoidal_position_encoding(max_positions, dim)).to(device)
        rotary_layers: dict = {}
        shared: dict = {}
        for i, layer in enumerate(spec.layers):
            a = layer.self_attention
            if a.rotary is None:
                continue
            ap = params[side]["layers"][i]["self_attention"]
            if "rotary_long_factor" in ap:
                rotary_layers[str(i)] = _rotary_consts(a, ap, max_positions, device)
                continue
            key = (a.rotary, a.head_dim)
            if key not in shared:
                shared[key] = _rotary_consts(a, ap, max_positions, device)
            rotary_layers[str(i)] = shared[key]
        if rotary_layers:
            side_consts["rotary"] = rotary_layers
        if getattr(spec, "alibi", False):
            side_consts["alibi_slopes"] = torch.from_numpy(
                alibi_slopes(spec.num_heads)).to(device)
        consts[side] = side_consts
    return consts


# ---------------------------------------------------------------------------
# Embeddings.
# ---------------------------------------------------------------------------


def embed_tokens(emb_params: dict, ids, out_dtype):
    """Gather embedding rows, dequantizing int8 payloads after the gather
    (reference: src/layers/common.cc:66-81)."""
    if "wq" in emb_params:
        rows = emb_params["wq"][ids].float()
        scale = emb_params["scale"][ids]
        return (rows / scale[..., None]).to(out_dtype)
    return emb_params["w"][ids].to(out_dtype)


def embed(side_params: dict, spec, ids, out_dtype, merge: str = "concat"):
    """Single- or multi-feature embedding lookup; ``ids`` is [B, T] or a
    tuple of [B, T] for multi-feature models."""
    if not isinstance(ids, (tuple, list)):
        ids = (ids,)
    outs = [embed_tokens(p, i, out_dtype)
            for p, i in zip(side_params["embeddings"], ids)]
    if len(outs) == 1:
        return outs[0]
    if merge == "add":
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return torch.cat(outs, dim=-1)


def _row_positions(pos, T: int, limit: int):
    """[B, T] absolute positions ``pos[b] + t`` of per-row offsets, clipped
    to a table of ``limit`` rows (the JAX package's gather clips as well)."""
    t = torch.arange(T, device=pos.device)
    return (pos.to(torch.int64)[:, None] + t[None, :]).clamp(0, limit - 1)


def _apply_positions(side_params, side_consts, spec, x, offset):
    """Add learned or sinusoidal position encodings at ``offset``, an int or
    an int [B] tensor of per-row offsets (the sinusoidal row t encodes
    position t+1, the reference's convention)."""
    T = x.shape[1]
    if spec.has_position_embedding:
        table = side_params["position_encodings"]
    elif spec.sinusoidal_positions:
        table = side_consts["sinusoidal"]
    else:
        return x
    if attn_ops.per_row(offset):
        return x + table[_row_positions(offset, T, table.shape[0])].to(x.dtype)
    return x + table[offset:offset + T].to(x.dtype)[None]


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------


def _eps(arch: ArchSpec, p: dict) -> float:
    eps = arch.ln_epsilon
    if eps is None:
        eps = 1e-5 if "beta" in p else 1e-6
    return eps


def _norm(arch: ArchSpec, p: Optional[dict], x):
    if p is None:
        return x
    return apply_norm(p, x, _eps(arch, p))


# The residual stream of a pre-norm stack travels as (x, delta): ``delta``
# is the last block's output, not yet added to ``x`` (None: nothing
# pending). The next norm adds it in the same launch (``_add_norm``), so
# the add costs no launch of its own; where no norm reads the stream, a
# plain add makes it whole (``_settle``).


def _settle(x, delta):
    return x if delta is None else x + delta


def _add_norm(arch: ArchSpec, p: Optional[dict], x, delta, quantize: bool = False,
              keep_sum: bool = True):
    """(s, h): s = x + delta, the residual stream, and h = norm(s) (for
    ``quantize``, per-row int8 for the int8 linears after the norm); s is
    None where ``keep_sum`` is False and a delta was added."""
    if p is None:
        s = _settle(x, delta)
        return s, s
    return add_and_norm(p, x, _eps(arch, p), residual=delta, quantize=quantize,
                        keep_sum=keep_sum)


def _int8_fed(quantize_acts: bool, *linears: dict) -> bool:
    """Whether the norm before ``linears`` quantizes for them: all are int8
    (W8A8) and activations are quantized."""
    return quantize_acts and all("wq" in p for p in linears)


def _project_qkv(arch, ap: dict, spec: AttentionSpec, x, quantize_acts: bool):
    """Fused QKV projection (the artifact layout) + head split + q/k/v
    norms."""
    fused = linear(ap["qkv"], x, quantize_activations=quantize_acts)
    Dq = spec.num_heads * spec.head_dim
    Dkv = spec.num_heads_kv * spec.head_dim
    q = attn_ops.split_heads(fused[..., :Dq], spec.num_heads)
    k = attn_ops.split_heads(fused[..., Dq:Dq + Dkv], spec.num_heads_kv)
    v = attn_ops.split_heads(fused[..., Dq + Dkv:], spec.num_heads_kv)
    if spec.has_q_norm:
        q = _norm(arch, ap.get("q_norm"), q)
    if spec.has_k_norm:
        k = _norm(arch, ap.get("k_norm"), k)
    if spec.has_v_norm:
        v = _norm(arch, ap.get("v_norm"), v)
    return q, k, v


def _maybe_rotary(spec: AttentionSpec, rot_consts, q, k, offset):
    if spec.rotary is None:
        return q, k
    T = q.shape[2]
    dim = spec.rotary.dim if spec.rotary.dim else spec.head_dim
    if attn_ops.per_row(offset):  # gathered once a call (_per_call_rotary)
        sin, cos = rot_consts["row_sin"], rot_consts["row_cos"]
    else:
        sin = rot_consts["sin"][offset:offset + T]
        cos = rot_consts["cos"][offset:offset + T]
    q = apply_rotary(q, sin, cos, spec.rotary.interleave, dim)
    k = apply_rotary(k, sin, cos, spec.rotary.interleave, dim)
    return q, k


def _per_call_rotary(rotary: dict, pos, T: int) -> dict:
    """The decoder's rotary tables with each row's phases at per-row
    positions ([B, 1, T, dim], broadcasting over the heads) as ``row_sin``
    and ``row_cos``, gathered once a call for each distinct pair of tables,
    not once a layer."""
    gathered = {}
    out = {}
    for name, consts in rotary.items():
        key = id(consts["sin"])
        if key not in gathered:
            rows = _row_positions(pos, T, consts["sin"].shape[0])
            gathered[key] = dict(consts, row_sin=consts["sin"][rows][:, None],
                                 row_cos=consts["cos"][rows][:, None])
        out[name] = gathered[key]
    return out


def _decode_chunk() -> int:
    """Chunk size for length-adaptive decode attention (0 disables)."""
    return int(os.environ.get("CT2TPU_DECODE_CHUNK", "128"))


def _chunked(causal_only: bool, capacity: int) -> int:
    """The chunk for a length-adaptive cache read, or 0 for the masked
    full-capacity read (the JAX package's eligibility rule)."""
    chunk = _decode_chunk()
    if causal_only and chunk and capacity >= 2 * chunk and capacity % chunk == 0:
        return chunk
    return 0


def _flash_eligible(q, k, min_len=None, *, alibi_bias=None, alibi_slopes=None,
                    position_bias=None, rel_bias_table=None,
                    rel_positions=None) -> bool:
    """Static dispatch decision for the flash-attention kernel: on the card,
    for an uncached attention whose query and key lengths both reach the
    threshold (``arch.flash_min_len`` when the ``flash_attention=True``
    constructor flag set it, else ``CT2TPU_FLASH_MIN_LEN``, default 2048)
    and whose head dim the kernel takes (up to its widest instance,
    ``HEAD_DIMS[-1]``; wider heads take the plain attention, as the JAX
    package declines its kernels for shapes they do not serve).
    ALiBi rides the kernel as its slopes and the T5 bias as its bucket
    table; Shaw relative keys/values decline it (they gather
    score-matrix-sized embeddings, not per-head scalars), as does a bias
    given without its kernel form. ``CT2TPU_FLASH=0`` turns it off."""
    if rel_positions is not None:
        return False
    if position_bias is not None and rel_bias_table is None:
        return False
    if alibi_bias is not None and alibi_slopes is None:
        return False
    if os.environ.get("CT2TPU_FLASH", "1") == "0":
        return False
    if not q.is_cuda or q.shape[-1] > HEAD_DIMS[-1]:
        return False
    threshold = (min_len if min_len is not None
                 else int(os.environ.get("CT2TPU_FLASH_MIN_LEN", "2048")))
    return q.shape[2] >= threshold and k.shape[2] >= threshold


def ring_block(arch: ArchSpec) -> int:
    """The sliding-window ring granularity Wr of this model, or 0 where ring
    caches do not apply (no windows, windows of several sizes, or
    ``CT2TPU_WINDOW_RING=0``).

    A windowed layer stores only ``2 * Wr`` KV slots, written at
    ``position % (2 * Wr)``: the O(window) memory of the reference's cache
    eviction (src/layers/attention.cc:536-557) without moving any data.
    Prefill chunks split at multiples of Wr (``split_prefill_chunks``)."""
    if os.environ.get("CT2TPU_WINDOW_RING", "1") == "0":
        return 0
    if arch.decoder is None:
        return 0
    windows = {layer.self_attention.sliding_window for layer in arch.decoder.layers
               if layer.self_attention.sliding_window > 1
               and not layer.self_attention.has_memory_kv}
    if len(windows) != 1:
        return 0
    (w,) = windows
    return ((w + 127) // 128) * 128


def ring_capacity(arch: ArchSpec) -> int:
    """A ring layer's capacity (0: no ring)."""
    wr = ring_block(arch)
    return 2 * wr if wr else 0


def check_speculation_window(arch: ArchSpec, speculation_k: int) -> None:
    """Raises unless a ring-cached model's smallest sliding window holds
    ``speculation_k`` tokens: a verify chunk reuses ``ring_window_bias``,
    which holds while a chunk spans at most one window."""
    if not ring_capacity(arch):
        return
    min_window = min((layer.self_attention.sliding_window for layer in arch.decoder.layers
                      if layer.self_attention.sliding_window > 1), default=0)
    if min_window and speculation_k > min_window:
        raise ValueError(
            f"speculation_k ({speculation_k}) must not exceed the smallest sliding "
            f"window ({min_window}) of a ring-cached model")


def split_prefill_chunks(start: int, length: int, block: int):
    """The absolute position range [start, start + length) split at every
    multiple of ``block`` (the reference's chunked prefill over window-size
    pieces: src/layers/transformer.cc:735-792): a list of (offset, size),
    the whole range when ``block`` is 0."""
    if block <= 0 or length <= 0:
        return [(start, length)]
    out = []
    p = start
    end = start + length
    while p < end:
        nxt = min((p // block + 1) * block, end)
        out.append((p, nxt - p))
        p = nxt
    return out


def _cache_write(buf, new, offset, ring: int = 0):
    """Write ``new`` [B, H, T, D] into ``buf`` [B, H, C, D] at time slot
    ``offset``, in place; with ``ring`` the positions wrap at the ring's
    end (window-aligned chunks never reach it). ``offset`` may be an int
    [B] tensor: row b is written at its own ``offset[b]`` (a scatter;
    ``ring`` wraps each written position)."""
    T = new.shape[2]
    new = new.to(buf.dtype)
    if attn_ops.per_row(offset):
        B = buf.shape[0]
        rows = torch.arange(B, device=buf.device)
        if T == 1:
            buf[rows, :, offset.long()] = new[:, :, 0]
            return buf
        cols = offset.long()[:, None] + torch.arange(T, device=buf.device)[None, :]
        if ring:
            cols = torch.remainder(cols, ring)
        # [B, T] indices around the heads' slice: the value is [B, T, H, D].
        buf[rows[:, None], :, cols] = new.transpose(1, 2)
        return buf
    if ring and offset + T > ring:
        head = ring - offset
        buf[:, :, offset:] = new[:, :, :head]
        buf[:, :, :T - head] = new[:, :, head:]
        return buf
    buf[:, :, offset:offset + T] = new
    return buf


def _append_int8_cache(cache: dict, k8, ks, v8, vs, offset, ring: int = 0):
    """Write quantized K/V [B, H, T, D] and their scales [B, H, T] into the
    int8 cache at time slot ``offset`` (wrapping as ``_cache_write``), in
    place."""
    _cache_write(cache["k"], k8, offset, ring)
    _cache_write(cache["v"], v8, offset, ring)
    _cache_write(cache["k_scale"].transpose(2, 3), ks[..., None], offset, ring)
    _cache_write(cache["v_scale"].transpose(2, 3), vs[..., None], offset, ring)
    return cache


def _update_int8_cache(cache: dict, k, v, offset, ring: int = 0):
    """Quantize and append new K/V vectors at ``offset``."""
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    return _append_int8_cache(cache, k8, ks, v8, vs, offset, ring)


def _dequantize_cache(cache: dict, dtype):
    k = cache["k"].float() / cache["k_scale"].transpose(2, 3)
    v = cache["v"].float() / cache["v_scale"].transpose(2, 3)
    return k.to(dtype), v.to(dtype)


def _use_decode_kernel(q) -> bool:
    """The int8 decode kernel serves single-token steps on the card for the
    head dims it takes (up to ``DECODE_MAX_D``; wider heads dequantize the
    cache for the plain attention); ``CT2TPU_DECODE_KERNEL=0`` dequantizes
    the whole cache instead."""
    return (q.is_cuda and q.shape[-1] <= DECODE_MAX_D
            and bool(int(os.environ.get("CT2TPU_DECODE_KERNEL", "1"))))


def _begin(arch, spec: AttentionSpec, ap: dict, x, delta, pre_norm: bool,
           wrap_norm: bool, quantize_acts: bool, fed_by=("qkv",)):
    """A block's input: (x, h, fused). In a pre-norm block (``fused``) the
    norm adds the pending ``delta`` and, under W8A8, quantizes h for the
    linears ``fed_by``; otherwise h is the settled stream (with
    ``wrap_norm`` False the caller normed it already)."""
    fused = wrap_norm and pre_norm and spec.has_layer_norm
    if fused:
        x, h = _add_norm(arch, ap.get("layer_norm"), x, delta,
                         _int8_fed(quantize_acts, *(ap[n] for n in fed_by)))
    else:
        x = h = _settle(x, delta)
    return x, h, fused


def _end(arch, spec: AttentionSpec, ap: dict, x, out, fused: bool, wrap_norm: bool):
    """A block's result (x, delta): in a pre-norm block the stream and the
    output whose add the next norm makes; post-norm: norm(out + x); with
    ``wrap_norm`` False the output alone."""
    if fused:
        return x, out
    if wrap_norm and spec.has_layer_norm:  # post-norm: norm(out + x)
        out = _add_norm(arch, ap.get("layer_norm"), x, out, keep_sum=False)[1]
    return out, None


def self_attention_block(
    arch: ArchSpec,
    spec: AttentionSpec,
    ap: dict,
    x,
    *,
    bias,
    rot_consts=None,
    offset=0,  # an int, or an int [B] tensor of per-row positions
    cache: Optional[dict] = None,
    pre_norm: bool = True,
    quantize_acts: bool = True,
    alibi_bias=None,  # [Hq, 1, Tk] float32 ([B, Hq, T, Tk] per row)
    rel_positions=None,  # [Tq, Tk] Shaw indices ([B, Tq, Tk] per row)
    position_bias=None,  # [Hq, Tq, Tk] T5 bias ([B, Hq, Tq, Tk] per row), or a
    # function that builds
    # it (called only where the plain attention runs)
    wrap_norm: bool = True,  # False: ``x`` is normed already, no residual
    causal: bool = False,
    flash_lengths=None,  # [B] valid lengths, given to the flash kernel
    causal_only: bool = False,  # ``bias`` is exactly the T == 1 causal mask
    beam_chain=None,  # [N, C] origin chain (chain-mask beam attention)
    beam_chain_size: int = 1,
    ring: int = 0,  # ring KV buffer size R (0: linear cache): writes land at
    # ``offset % R`` and ``bias`` is a ring_window_bias over R
    alibi_slopes=None,  # [Hq] float32: the flash kernel's form of ALiBi
    alibi_positive: bool = True,
    rel_bias_table=None,  # [num_buckets, Hq]: the flash kernel's T5 form
    rel_max_distance: int = 0,
    rel_bidirectional: bool = True,
    fresh_prefill: bool = False,  # the cache is empty and this call writes
    # its first T positions: attend over the fresh tensors only (O(T^2),
    # flash-eligible); ``bias`` must then cover [*, T, T]
    kv_lengths=None,  # int32 [B] filled with ``offset`` (int8 decode kernel)
    delta=None,  # the previous block's output, not yet added to ``x``
    pos_bound: Optional[int] = None,  # per-row ``offset``: a bound of its
    # largest entry known on the host, for the length-adaptive cache read
):
    """Self-attention with an optional fixed-capacity KV cache.

    Returns (x, delta, cache): in a pre-norm block the residual stream and
    this block's output, whose add the next norm makes; otherwise the
    block's output and None. ``cache`` holds {"k","v"} of shape
    [B, Hkv, C, D] (plus {"k_scale","v_scale"} [B, Hkv, 1, C] in the int8
    layout); this call's keys/values are written at ``offset`` (modulo
    ``ring`` for a ring layer), in place. The path at each point is the
    JAX package's: ALiBi, T5 and Shaw positions and ring layers leave the
    int8 decode kernel for the dequantized cache; relative positions leave
    the chain mask and the one-token fast path for the masked attention.
    """
    if ring:
        assert beam_chain is None, \
            "ring KV caches are incompatible with chain-mask beam attention"
    x, h, fused = _begin(arch, spec, ap, x, delta, pre_norm, wrap_norm,
                         quantize_acts)

    q, k, v = _project_qkv(arch, ap, spec, h, quantize_acts)
    q, k = _maybe_rotary(spec, rot_consts, q, k, offset)
    T = q.shape[2]
    # The write slot: the absolute position in a linear cache, wrapped in
    # a ring (rotary phases always take the absolute position).
    w_off = offset % ring if ring else offset
    relative = rel_positions is not None or position_bias is not None
    extra_free = alibi_bias is None and not relative

    attn_cache = cache
    if cache is not None and fresh_prefill and T > 1:
        # First-chunk prefill: write the cache, then attend over the fresh
        # Q/K/V as if cache-less.
        if "k_scale" in cache:
            _update_int8_cache(cache, k, v, w_off, ring)
        else:
            _cache_write(cache["k"], k, w_off, ring)
            _cache_write(cache["v"], v, w_off, ring)
        attn_cache = None

    ctx = None
    if attn_cache is not None and "k_scale" in attn_cache:
        if (T == 1 and extra_free and spec.sliding_window != 1 and not ring
                and _use_decode_kernel(q)):
            # Attend over [pre-append cache | fresh K/V], then append.
            k8, ks = quantize_kv(k)
            v8, vs = quantize_kv(v)
            if kv_lengths is None:
                kv_lengths = (offset.to(torch.int32) if attn_ops.per_row(offset)
                              else torch.full((q.shape[0],), offset,
                                              dtype=torch.int32, device=q.device))
            ctx = decode_attention_int8(
                q, cache["k"], cache["k_scale"][:, :, 0, :],
                cache["v"], cache["v_scale"][:, :, 0, :], kv_lengths,
                k_new8=k8, kn_scale=ks, v_new8=v8, vn_scale=vs,
                scale=spec.queries_scale, window=spec.sliding_window)
            _append_int8_cache(cache, k8, ks, v8, vs, offset)
            ctx = ctx.to(x.dtype)
        else:
            # A prefill into a filled cache, a ring layer, an extra bias, or
            # the CPU: dequantize the whole cache for the masked attention.
            _update_int8_cache(cache, k, v, w_off, ring)
            k, v = _dequantize_cache(cache, q.dtype)
    elif attn_cache is not None and T == 1 and not relative:
        ck, cv = cache["k"], cache["v"]
        k_new, v_new = k.to(ck.dtype), v.to(cv.dtype)
        chunk = _chunked(causal_only and alibi_bias is None, ck.shape[2])
        if beam_chain is not None:
            # Chain attention over the PRE-append cache + the fresh token.
            if chunk:
                ctx = attn_ops.chunked_beam_chain_attention(
                    q, ck, cv, beam_chain, k_new, v_new, offset,
                    beam_size=beam_chain_size,
                    queries_scale=spec.queries_scale, chunk=chunk)
            else:
                fresh_bias = None
                if alibi_bias is not None:
                    G = spec.num_heads // spec.num_heads_kv
                    fresh_bias = alibi_bias.float()[..., offset].reshape(
                        1, 1, spec.num_heads_kv, G, 1)
                ctx = attn_ops.beam_chain_attention(
                    q, ck, cv, beam_chain, beam_size=beam_chain_size,
                    queries_scale=spec.queries_scale, bias=bias,
                    alibi_bias=alibi_bias, k_new=k_new, v_new=v_new,
                    fresh_bias=fresh_bias)
        elif chunk:
            ctx = attn_ops.chunked_decode_attention(
                q, ck, cv, k_new, v_new, offset,
                queries_scale=spec.queries_scale, chunk=chunk, pos_bound=pos_bound)
        else:
            ctx = attn_ops.decode_step_attention(
                q, ck, cv, k_new, v_new, w_off,
                queries_scale=spec.queries_scale, bias=bias,
                alibi_bias=alibi_bias)
        # The append comes after the attention read the pre-append cache.
        _cache_write(ck, k_new, w_off)
        _cache_write(cv, v_new, w_off)
    elif attn_cache is not None:
        k = _cache_write(cache["k"], k, w_off, ring)
        v = _cache_write(cache["v"], v, w_off, ring)

    if ctx is None:
        if attn_cache is None and _flash_eligible(
                q, k, arch.flash_min_len, alibi_bias=alibi_bias,
                alibi_slopes=alibi_slopes, position_bias=position_bias,
                rel_bias_table=rel_bias_table, rel_positions=rel_positions):
            ctx = flash_attention(
                q, k, v, scale=spec.queries_scale, causal=causal,
                lengths=(None if flash_lengths is None
                         else flash_lengths.to(torch.int32)),
                window=spec.sliding_window,
                alibi_slopes=alibi_slopes if alibi_bias is not None else None,
                alibi_positive=alibi_positive,
                rel_bias_table=rel_bias_table,
                rel_max_distance=rel_max_distance,
                rel_bidirectional=rel_bidirectional)
        else:
            if callable(position_bias):
                position_bias = position_bias()
            full_bias = attn_ops.combine_bias(
                bias, attn_ops.combine_bias(alibi_bias, position_bias))
            ctx = attn_ops.dot_product_attention(
                q, k, v, bias=full_bias, queries_scale=spec.queries_scale,
                rel_position_keys=ap.get("relative_position_keys"),
                rel_position_values=ap.get("relative_position_values"),
                rel_positions=rel_positions)

    out = attn_ops.combine_heads(ctx)
    out = linear(ap["o"], out, quantize_activations=quantize_acts)
    return (*_end(arch, spec, ap, x, out, fused, wrap_norm), cache)


def merged_attention_block(
    arch: ArchSpec,
    spec: AttentionSpec,
    ap: dict,
    x,
    mem_kv: dict,  # {"k","v"} [B, Hkv, S, D] (beam-shared, k_norm applied)
    *,
    bias,  # self-keys bias (causal/lengths) [., ., T, C]
    memory_bias,  # [B, 1, 1, S] additive float32 or None
    rot_consts=None,
    offset: int = 0,
    cache: Optional[dict] = None,
    pre_norm: bool = True,
    quantize_acts: bool = True,
    wrap_norm: bool = True,
    delta=None,
):
    """T5Gemma2-style merged self+cross attention: one softmax over
    [self keys | memory keys] (reference: src/layers/attention.cc:625-796
    forward_merged). The memory K/V come from the ``memory_kv`` projection
    (k_norm only, no rotary) and are shared by the beams. Returns
    (x, delta, cache) as ``self_attention_block``."""
    x, h, fused = _begin(arch, spec, ap, x, delta, pre_norm, wrap_norm,
                         quantize_acts)
    q, k, v = _project_qkv(arch, ap, spec, h, quantize_acts)
    q, k = _maybe_rotary(spec, rot_consts, q, k, offset)

    if cache is not None and "k_scale" in cache:
        _update_int8_cache(cache, k, v, offset)
        k, v = _dequantize_cache(cache, q.dtype)
    elif cache is not None:
        k = _cache_write(cache["k"], k, offset)
        v = _cache_write(cache["v"], v, offset)

    BK, _, T, _ = q.shape
    B, _, S, _ = mem_kv["k"].shape
    beam = BK // B
    mem_k, mem_v = mem_kv["k"], mem_kv["v"]
    if beam > 1:
        mem_k = mem_k.repeat_interleave(beam, dim=0)
        mem_v = mem_v.repeat_interleave(beam, dim=0)
    keys = torch.cat([k, mem_k.to(k.dtype)], dim=2)
    values = torch.cat([v, mem_v.to(v.dtype)], dim=2)

    C = k.shape[2]
    self_bias = (bias.float().expand(BK, 1, T, C) if bias is not None
                 else torch.zeros((BK, 1, T, C), dtype=torch.float32, device=q.device))
    if memory_bias is not None:
        mem_b = memory_bias.float().repeat_interleave(beam, dim=0).expand(BK, 1, T, S)
    else:
        mem_b = torch.zeros((BK, 1, T, S), dtype=torch.float32, device=q.device)
    ctx = attn_ops.dot_product_attention(
        q, keys, values, bias=torch.cat([self_bias, mem_b], dim=-1),
        queries_scale=spec.queries_scale)
    out = linear(ap["o"], attn_ops.combine_heads(ctx), quantize_activations=quantize_acts)
    return (*_end(arch, spec, ap, x, out, fused, wrap_norm), cache)


def precompute_merged_memory_kv(arch: ArchSpec, spec: AttentionSpec, ap: dict,
                                memory, quantize_acts: bool = True):
    """Project the encoder output through the merged attention's
    ``memory_kv`` linear (k_norm only, no rotary; reference:
    src/layers/attention.cc:706-735)."""
    Hkv, D = spec.num_heads_kv, spec.head_dim
    fused = linear(ap["memory_kv"], memory, quantize_activations=quantize_acts)
    k = attn_ops.split_heads(fused[..., :Hkv * D], Hkv)
    v = attn_ops.split_heads(fused[..., Hkv * D:], Hkv)
    if spec.has_k_norm:
        k = _norm(arch, ap.get("k_norm"), k)
    return {"k": k, "v": v}


def precompute_cross_kv(arch: ArchSpec, spec: AttentionSpec, ap: dict, memory,
                        quantize_acts: bool = True):
    """Project encoder output to cross-attention K/V once
    (reference caches these on step 0: src/layers/attention.cc:371-440)."""
    Hkv = spec.num_heads_kv
    k = attn_ops.split_heads(
        linear(ap["k"], memory, quantize_activations=quantize_acts), Hkv)
    v = attn_ops.split_heads(
        linear(ap["v"], memory, quantize_activations=quantize_acts), Hkv)
    if spec.has_k_norm:
        k = _norm(arch, ap.get("k_norm"), k)
    if spec.has_v_norm:
        v = _norm(arch, ap.get("v_norm"), v)
    return {"k": k, "v": v}


def cross_attention_block(
    arch: ArchSpec,
    spec: AttentionSpec,
    ap: dict,
    x,
    mem_kv: dict,
    *,
    memory_bias,
    pre_norm: bool = True,
    quantize_acts: bool = True,
    delta=None,  # the previous block's output, not yet added to ``x``
    return_weights=False,  # False | True | "logits" (the pre-softmax scores)
    wrap_norm: bool = True,  # False: ``x`` is normed already, no residual
):
    """Cross-attention with beam-shared memory; returns (x, delta, weights):
    (x, delta) as ``self_attention_block`` does, and with
    ``return_weights`` the softmax weights [B*beam, Hq, T, S], or with
    ``"logits"`` the scores before the softmax (else None).
    The weights leave the residual stream as it is.

    ``x``: [B*beam, T, D_model]; ``mem_kv["k"]``: [B, Hkv, S, Dh]. The beam
    folds into the query time axis so memory K/V are read once.
    """
    x, h, fused = _begin(arch, spec, ap, x, delta, pre_norm, wrap_norm,
                         quantize_acts, fed_by=("q",))

    BK, T, _ = h.shape
    B = mem_kv["k"].shape[0]
    K = BK // B

    q = linear(ap["q"], h, quantize_activations=quantize_acts)
    if spec.has_q_norm:
        q = _norm(arch, ap.get("q_norm"), q)
    q = attn_ops.split_heads(q.reshape(B, K * T, -1), spec.num_heads)
    out = attn_ops.dot_product_attention(
        q, mem_kv["k"], mem_kv["v"], bias=memory_bias,
        queries_scale=spec.queries_scale, return_weights=return_weights)
    weights = None
    if return_weights:
        ctx, weights = out
        # [B, Hq, K*T, S] -> [B*K, Hq, T, S]
        H, S = spec.num_heads, weights.shape[-1]
        weights = (weights.reshape(B, H, K, T, S).transpose(1, 2)
                   .reshape(BK, H, T, S))
    else:
        ctx = out
    ctx = attn_ops.combine_heads(ctx).reshape(BK, T, -1)
    y = linear(ap["o"], ctx, quantize_activations=quantize_acts)
    return (*_end(arch, spec, ap, x, y, fused, wrap_norm), weights)


def ffn_block(arch: ArchSpec, spec, fp: dict, x, pre_norm: bool,
              quantize_acts: bool = True, delta=None, wrap_norm: bool = True):
    """Feed-forward with optional GLU (reference:
    src/layers/transformer.cc:8-51); returns (x, delta) as
    ``self_attention_block`` does (with ``wrap_norm`` False, ``x`` is the
    normed input and the output comes alone). Under W8A8 the norm
    quantizes ``h`` once for both GLU linears."""
    has_norm = wrap_norm and "layer_norm" in fp
    fused = pre_norm and has_norm
    if fused:
        x, h = _add_norm(arch, fp["layer_norm"], x, delta,
                         _int8_fed(quantize_acts, *_ffn_firsts(spec, fp)))
    else:
        x = h = _settle(x, delta)
    act = get_activation(spec.activation)
    inner = linear(fp["linear_0"], h, activation=act, quantize_activations=quantize_acts)
    if spec.glu:
        gate = linear(fp["linear_0_noact"], h, quantize_activations=quantize_acts)
        inner = inner * gate
    out = linear(fp["linear_1"], inner, quantize_activations=quantize_acts)
    if fused:
        return x, out
    if has_norm:  # post-norm: norm(out + x)
        out = _add_norm(arch, fp["layer_norm"], x, out, keep_sum=False)[1]
    return out, None


def _ffn_firsts(spec, fp: dict):
    """The FFN linears that read its input."""
    return (fp["linear_0"], fp["linear_0_noact"]) if spec.glu else (fp["linear_0"],)


# ---------------------------------------------------------------------------
# Encoder.
# ---------------------------------------------------------------------------


def encoder_forward(arch: ArchSpec, params: dict, consts: dict, ids, lengths,
                    quantize_acts: bool = True, out_dtype=torch.float32):
    """Full encoder pass. ids [B, S], lengths [B] -> [B, S, D]."""
    spec = arch.encoder
    ep = params["encoder"]
    ec = consts.get("encoder", {})

    x = embed(ep, spec, ids, out_dtype, spec.embeddings.merge)
    if spec.embeddings.scale:
        x = x * torch.tensor(spec.embeddings.scale, dtype=x.dtype)
    x = _apply_positions(ep, ec, spec, x, 0)
    if spec.has_layernorm_embedding:
        x = _norm(arch, ep.get("layernorm_embedding"), x)

    main_ids = ids[0] if isinstance(ids, (tuple, list)) else ids
    S = main_ids.shape[-1]
    bias = attn_ops.length_mask_bias(lengths, S)
    delta = None
    position_bias = rel_table = None
    rel_maxd = 0
    for i, layer in enumerate(spec.layers):
        lp = ep["layers"][i]
        aspec = layer.self_attention
        ap = lp["self_attention"]
        rel_positions = None
        if aspec.has_rel_position_keys or aspec.has_rel_asymmetric_keys:
            rel_positions = attn_ops.make_relative_positions(
                S, S, aspec.max_relative_position,
                asymmetric=aspec.has_rel_asymmetric_keys,
                left_max=aspec.rel_left_max, right_max=aspec.rel_right_max,
                device=x.device)
        if aspec.has_rel_attention_bias and rel_table is None:
            # The T5 bias of layer 0's table serves every layer: the flash
            # kernel takes the table itself, the plain attention the dense
            # [H, S, S] bias, built once, the first time the kernel is not
            # taken.
            rel_table = ap["relative_attention_bias"]
            rel_maxd = aspec.rel_max_distance
            position_bias = functools.cache(functools.partial(
                attn_ops.t5_position_bias, rel_table, S, S, rel_maxd,
                bidirectional=True))
        kw = dict(bias=bias, rot_consts=ec.get("rotary", {}).get(str(i)),
                  pre_norm=spec.pre_norm, quantize_acts=quantize_acts,
                  rel_positions=rel_positions, position_bias=position_bias,
                  rel_bias_table=rel_table, rel_max_distance=rel_maxd,
                  causal=False, flash_lengths=lengths)
        if layer.sandwich_norm:
            x, h = _add_norm(arch, lp["input_layer_norm"], x, delta,
                             _int8_fed(quantize_acts, ap["qkv"]))
            ctx, _, _ = self_attention_block(arch, aspec, ap, h, wrap_norm=False, **kw)
            delta = _norm(arch, lp["post_attention_layer_norm"], ctx)
            x, delta = _sandwich_ffn(arch, layer.ffn, lp, x, delta, spec.pre_norm,
                                     quantize_acts)
        else:
            x, delta, _ = self_attention_block(arch, aspec, ap, x, delta=delta, **kw)
            x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm,
                                 quantize_acts, delta=delta)

    if spec.has_output_norm:
        return _add_norm(arch, ep.get("layer_norm"), x, delta, keep_sum=False)[1]
    return _settle(x, delta)


def _sandwich_ffn(arch, fspec, lp: dict, x, delta, pre_norm: bool, quantize_acts: bool):
    """A sandwich layer's FFN half: the pre-FFN norm adds the pending delta
    (and under W8A8 quantizes for the FFN's first linears), and the post-FFN
    norm normalises the FFN's output alone, which becomes the new delta."""
    x, h = _add_norm(arch, lp["pre_feedforward_layer_norm"], x, delta,
                     _int8_fed(quantize_acts, *_ffn_firsts(fspec, lp["ffn"])))
    f, _ = ffn_block(arch, fspec, lp["ffn"], h, pre_norm, quantize_acts,
                     wrap_norm=False)
    return x, _norm(arch, lp["post_feedforward_layer_norm"], f)


# ---------------------------------------------------------------------------
# Decoder cache.
# ---------------------------------------------------------------------------


def pre_norm_stack(arch: ArchSpec, spec, ep: dict, x, quantize_acts: bool,
                   after=None):
    """A speech encoder's stack of plain pre-norm layers (no mask, no
    positions) and its output norm, which under W8A8 quantizes for the
    linear ``after`` when one reads it (Wav2Vec2's CTC head)."""
    delta = None
    for i, layer in enumerate(spec.layers):
        lp = ep["layers"][i]
        x, delta, _ = self_attention_block(
            arch, layer.self_attention, lp["self_attention"], x, bias=None,
            pre_norm=spec.pre_norm, quantize_acts=quantize_acts, delta=delta)
        x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm,
                             quantize_acts, delta=delta)
    if ep.get("layer_norm") is None:
        return _settle(x, delta)
    quantize = after is not None and _int8_fed(quantize_acts, after)
    return _add_norm(arch, ep["layer_norm"], x, delta, quantize, keep_sum=False)[1]


def speech_encoder_forward(arch: ArchSpec, params: dict, consts: dict, features,
                           quantize_acts: bool = True, out_dtype=torch.float32):
    """Whisper's encoder (reference: src/layers/whisper.cc:25-62): two
    convolutions of width 3 with GELU, the second of stride 2, the learned
    position table cut to the output length, the pre-norm stack and the
    output norm. ``features`` [B, n_mels, T] -> [B, T // 2, D]."""
    spec = arch.encoder
    ep = params["encoder"]
    x = features
    convs = ep["convs"]
    for i, conv in enumerate(convs):
        x = conv1d(x, conv["w"], conv.get("b"), stride=2 if i == len(convs) - 1 else 1,
                   padding=1, activation=gelu)
    x = x.transpose(1, 2).to(out_dtype)
    x = x + ep["position_encodings"][:x.shape[1]].to(x.dtype)[None]
    return pre_norm_stack(arch, spec, ep, x, quantize_acts)


def layer_cache_capacity(arch: ArchSpec, aspec: AttentionSpec, capacity: int,
                         ring: bool) -> int:
    """A layer's KV capacity: with ``ring``, a windowed layer stores only
    ``2 * Wr`` slots (O(window) memory); every other layer the whole
    ``capacity``."""
    if not ring or not aspec.sliding_window > 1 or aspec.has_memory_kv:
        return capacity
    rc = ring_capacity(arch)
    return min(capacity, rc) if rc else capacity


def init_self_cache(arch: ArchSpec, batch: int, capacity: int,
                    dtype=torch.float32, device="cpu", ring: bool = False):
    """Fixed-capacity self-attention KV cache: one dict per decoder layer
    with "k" and "v" of [batch, Hkv, C, D], C the layer's capacity
    (``layer_cache_capacity``: with ``ring``, windowed layers take 2 x Wr
    slots). ``dtype=torch.int8`` selects the quantized layout: int8
    payloads plus "k_scale" and "v_scale" of [batch, Hkv, 1, C], one float
    scale per cached vector (ones where nothing is written, so dequantizing
    stays finite)."""
    out = []
    for layer in arch.decoder.layers:
        a = layer.self_attention
        cap = layer_cache_capacity(arch, a, capacity, ring)
        shape = (batch, a.num_heads_kv, cap, a.head_dim)
        layer_cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            sshape = (batch, a.num_heads_kv, 1, cap)
            layer_cache["k_scale"] = torch.ones(sshape, dtype=torch.float32,
                                                device=device)
            layer_cache["v_scale"] = torch.ones(sshape, dtype=torch.float32,
                                                device=device)
        out.append(layer_cache)
    return out


def cache_gather_rows(cache, rows):
    """Reorder/select cache batch rows (beam reorder) in one fused gather
    over every cache array (the scales too, in the int8 layout); returns a
    new cache."""
    if cache is None:
        return None
    names = [list(layer) for layer in cache]
    out = iter(gather_rows_fused(
        [layer[n] for layer, ns in zip(cache, names) for n in ns], rows))
    return [{n: next(out) for n in ns} for ns in names]


def cache_repeat_rows(cache, n: int):
    """Tile every batch row ``n`` times (beam/hypothesis replication)."""
    if cache is None:
        return None
    return [{name: a.repeat_interleave(n, dim=0) for name, a in layer.items()}
            for layer in cache]


def cache_slice_rows(cache, start: int, size: int):
    """Batch rows [start, start + size) of every cache array (views)."""
    if cache is None:
        return None
    return [{name: a[start:start + size] for name, a in layer.items()}
            for layer in cache]


def cache_grow(cache, n_rows: int, capacity: int, arch: Optional[ArchSpec] = None):
    """A cache of ``n_rows`` batch rows and ``capacity`` positions: each row
    tiled ``n_rows // rows`` times, the time axis padded with zeros (the
    int8 layout's scales with ones, so dequantizing stays finite). A ring
    layer (a windowed layer of exactly ``ring_capacity`` slots; ``arch``
    tells) keeps its size: growing it would break its ``position % ring``
    slot mapping. Arrays already of that size are returned as they are."""
    if cache is None:
        return None
    rc = ring_capacity(arch) if arch is not None else 0

    def grow(name, a, cap):
        if a.shape[0] != n_rows:
            a = a.repeat_interleave(n_rows // a.shape[0], dim=0)
        axis = 3 if name.endswith("_scale") else 2
        if a.shape[axis] < cap:
            pad = list(a.shape)
            pad[axis] = cap - a.shape[axis]
            fill = torch.ones if name.endswith("_scale") else torch.zeros
            a = torch.cat([a, fill(pad, dtype=a.dtype, device=a.device)], dim=axis)
        return a

    return [{name: grow(name, a, rc if rc and layer["k"].shape[2] == rc else capacity)
             for name, a in layer.items()} for layer in cache]


def cache_insert_row(cache, sub_cache, slot: int):
    """Write a 1-row ``sub_cache`` into batch row ``slot`` of ``cache``, in
    place; returns ``cache``. The sub-cache may have a smaller capacity (a
    prompt-sized prefill cache): only its slots are written, and the stale
    entries after them are never read, since the decode masks exclude
    unwritten positions. The continuous batcher admits a prefilled request
    into a free slot with it."""
    for layer, sub in zip(cache, sub_cache):
        for name, buf in layer.items():
            src = sub[name]
            axis = 3 if name.endswith("_scale") else 2
            n = min(src.shape[axis], buf.shape[axis])
            buf[slot].narrow(axis - 1, 0, n).copy_(src[0].narrow(axis - 1, 0, n))
    return cache


def project_logits(arch: ArchSpec, params: dict, x, quantize_acts: bool = True):
    """The output projection of hidden states ``x`` [..., D] (the decoder's
    last normed states), with the final logit soft-capping."""
    x = linear(params["decoder"]["projection"], x, quantize_activations=quantize_acts)
    cap = arch.decoder.final_logit_softcapping
    if cap:
        x = torch.tanh(x / cap) * cap
    return x


def precompute_memory(arch: ArchSpec, params: dict, memory, quantize_acts: bool = True):
    """Project encoder output into per-layer cross K/V (prefill-once): the
    cross-attention's K and V, or a merged attention's ``memory_kv``. Under
    W8A8 the memory is quantized once for every layer's projections."""
    layers = params["decoder"]["layers"]
    kv = [p for i, layer in enumerate(arch.decoder.layers)
          for p in ((layers[i]["attention"]["k"], layers[i]["attention"]["v"])
                    if layer.cross_attention is not None
                    else (layers[i]["self_attention"]["memory_kv"],)
                    if layer.self_attention.has_memory_kv else ())]
    if kv and _int8_fed(quantize_acts, *kv):
        memory = quantize_input(memory)
    out = []
    for i, layer in enumerate(arch.decoder.layers):
        if layer.cross_attention is not None:
            out.append(precompute_cross_kv(arch, layer.cross_attention,
                                           layers[i]["attention"], memory,
                                           quantize_acts))
        elif layer.self_attention.has_memory_kv:
            out.append(precompute_merged_memory_kv(
                arch, layer.self_attention, layers[i]["self_attention"], memory,
                quantize_acts))
        else:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# Decoder.
# ---------------------------------------------------------------------------


class _LayerExtras:
    """A decoder call's per-layer attention extras (the JAX package's
    ``layer_extras``): the self-attention bias over the layer's keys (the
    causal and length masks, the sliding window, or a ring layer's
    ``ring_window_bias``, which replaces them), the ALiBi bias, the Shaw
    indices, the T5 bias and the ring size. Each is built once per key
    length. A layer's key length is its own capacity, so a hybrid stack of
    ring and linear layers (Gemma-2) gets each its own bias. With per-row
    positions (``pos`` an int [B] tensor) every position-dependent bias
    gains a batch axis: the causal, window and ring biases [B, 1, T, Tk],
    negative-convention ALiBi [B, H, T, Tk], the Shaw indices [B, T, Tk] and
    the T5 bias [B, H, T, Tk]."""

    def __init__(self, arch: ArchSpec, dc: dict, T: int, pos,
                 attn_cached: bool, fresh: bool, lengths, device):
        self.arch, self.dc, self.T, self.pos = arch, dc, T, pos
        self.attn_cached, self.fresh = attn_cached, fresh
        self.lengths, self.device = lengths, device
        self.pos_vec = attn_ops.per_row(pos)
        self.ring = ring_capacity(arch)
        self._memo: dict = {}

    def _once(self, key, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def _base(self, Tk: int):
        """The causal (+ length) bias over ``Tk`` keys."""
        def build():
            off = self.pos if self.attn_cached else 0
            bias = attn_ops.causal_mask_bias(self.T, Tk, offset=off, device=self.device)
            if self.lengths is not None:
                bias = bias + attn_ops.length_mask_bias(self.lengths, Tk)
            return bias
        return self._once(("base", Tk), build)

    def __call__(self, layer, lp: dict, cache_i, t5: bool = True):
        """(bias, alibi_bias, rel_positions, t5_bias, ring) of one layer;
        the T5 bias only with ``t5`` (once a call: layer 0's serves every
        layer)."""
        arch, T, pos = self.arch, self.T, self.pos
        aspec = layer.self_attention
        window = aspec.sliding_window
        cap = cache_i["k"].shape[2] if cache_i is not None else T
        Tk = cap if self.attn_cached else T
        bias = self._base(Tk)
        ring = 0
        if (window > 1 and self.ring and cache_i is not None and cap == self.ring
                and not aspec.has_memory_kv):
            ring = self.ring
        if window and self.attn_cached:
            if ring:
                bias = self._once(("ring", window), lambda: attn_ops.ring_window_bias(
                    T, ring, window, offset=pos, device=self.device))
            else:
                bias = self._once(("window", window, Tk), lambda: bias + (
                    attn_ops.sliding_window_bias(T, Tk, window, offset=pos,
                                                 device=self.device)))
        elif window:
            bias = self._once(("window", window, Tk), lambda: bias + (
                attn_ops.sliding_window_bias(T, T, window, device=self.device)))

        spec = arch.decoder
        alibi_bias = None
        if spec.alibi:
            scale = aspec.queries_scale if spec.scale_alibi else 1.0

            def alibi():
                positions = torch.arange(Tk, dtype=torch.float32, device=self.device)
                slopes = self.dc["alibi_slopes"]
                if (self.pos_vec and self.attn_cached
                        and not spec.alibi_use_positive_positions):
                    # Each query's keys end at 0 on the query itself, at
                    # its row's own position: [B, H, T, Tk].
                    q_pos = (pos.float()[:, None] + torch.arange(
                        T, dtype=torch.float32, device=self.device)[None, :])
                    rel = positions[None, None, :] - q_pos[:, :, None]
                    return slopes[None, :, None, None] * rel[:, None] * scale
                if not spec.alibi_use_positive_positions:
                    # Negative positions end at 0 on the last current key
                    # (reference: src/layers/attention_layer.cc:38-41).
                    cur_len = (pos + T) if self.attn_cached else T
                    positions = positions - (torch.tensor(
                        cur_len, dtype=torch.float32, device=self.device) - 1)
                return slopes[:, None, None] * positions[None, None, :] * scale
            alibi_bias = self._once(("alibi", Tk, scale), alibi)

        rel_positions = None
        if aspec.has_rel_position_keys:
            rel_positions = self._once(
                ("shaw", Tk, aspec.max_relative_position),
                lambda: attn_ops.make_relative_positions(
                    T, Tk, aspec.max_relative_position,
                    query_offset=pos if (self.attn_cached or self.pos_vec) else None,
                    device=self.device))
        pbias = None
        if aspec.has_rel_attention_bias and t5:
            pbias = attn_ops.t5_position_bias(
                lp["self_attention"]["relative_attention_bias"], T, Tk,
                aspec.rel_max_distance, bidirectional=False,
                query_offset=pos if (self.attn_cached or self.pos_vec) else 0)
        if ring and (alibi_bias is not None or rel_positions is not None
                     or pbias is not None):
            raise NotImplementedError(
                "ring KV caches do not take ALiBi or relative-position layers "
                "(set CT2TPU_WINDOW_RING=0)")
        return bias, alibi_bias, rel_positions, pbias, ring


def decoder_forward(
    arch: ArchSpec,
    params: dict,
    consts: dict,
    ids,  # [B*beam, T]
    pos,  # position of ids[:, 0]: an int, or an int [B*beam] tensor (per row)
    self_cache,  # list per layer of {"k","v"} [B*beam, Hkv, C, D], or None
    mem_kv=None,  # list per layer of {"k","v"} [B, Hkv, S, D] (beam-shared)
    memory_bias=None,  # [B, 1, 1, S] additive f32
    *,
    beam_size: int = 1,
    lengths=None,  # [B*beam] optional per-row valid lengths
    quantize_acts: bool = True,
    out_dtype=torch.float32,
    return_logits: bool = True,
    beam_chain=None,  # [N, C] origin chain: beam attention by mask
    fresh_prefill: bool = False,  # the cache is empty and ``ids`` are its
    # first positions: prefill attention runs over the fresh tensors only
    # (O(T^2), flash-eligible) while still writing the cache
    return_attention: bool = False,
    alignment_pairs=None,  # tuple of (layer, head): collect these heads'
    # cross-attention
    raw_attention: bool = False,  # the pairs' pre-softmax scores
    pos_bound: Optional[int] = None,  # per-row ``pos``: a bound of its
    # largest entry known on the host (the length-adaptive cache read's
    # trip count; the whole capacity when None)
):
    """Decoder pass covering both modes:

    - cached step/prefill: ``self_cache`` given; keys live at [0, pos+T)
      and this call's keys are written in place;
    - full sequence (scoring): ``self_cache=None``; plain causal masking.

    ``pos`` may be an int [B*beam] tensor on the model's device: each row
    then sits at its own position (continuous batching), for the position
    tables, the rotary phases, the cache writes, every bias and the decode
    attention's lengths, as in the JAX package.

    ``mem_kv`` is None for a decoder-only model. Returns (logits
    [B*beam, T, V] (or the hidden states when ``return_logits`` is False),
    self_cache); with ``return_attention`` also the cross-attention weights
    of layer ``spec.alignment_layer`` averaged over its first
    ``spec.alignment_heads`` heads, float32 [B*beam, T, S] (None without a
    cross-attention there) (reference: src/layers/transformer.cc:565-603).
    With ``alignment_pairs`` the third output is instead the cross-attention
    of those (layer, head) pairs, [B*beam, P, T, S] in pair order: the
    float32 softmax weights, or with ``raw_attention`` the scores before it
    (Whisper's alignment, reference: src/models/whisper.cc:495-556).
    """
    spec = arch.decoder
    dp = params["decoder"]
    dc = consts.get("decoder", {})
    main_ids = ids[0] if isinstance(ids, (tuple, list)) else ids
    T = main_ids.shape[-1]
    device = main_ids.device
    pos_vec = attn_ops.per_row(pos)
    if pos_vec and tuple(pos.shape) != (main_ids.shape[0],):
        raise ValueError(
            f"per-row positions take one entry a row: pos {tuple(pos.shape)} "
            f"for {main_ids.shape[0]} rows")
    if pos_vec:
        pos = pos.long()  # one conversion for every index built from it

    x = embed(dp, spec, ids, out_dtype, spec.embeddings.merge)
    if spec.start_from_zero_embedding and pos_vec:
        # The rows whose step is at position 0.
        t_idx = pos.long()[:, None] + torch.arange(T, device=device)[None, :]
        x = torch.where((t_idx == 0)[:, :, None], torch.zeros_like(x), x)
    elif spec.start_from_zero_embedding and pos == 0:
        # Zero the embedding of the BOS timestep at step 0
        # (reference: src/layers/transformer.cc:637-640).
        x = x.clone()
        x[:, 0] = 0
    if spec.embeddings.scale:
        x = x * torch.tensor(spec.embeddings.scale, dtype=x.dtype)
    if spec.has_project_in:
        x = linear(dp["project_in"], x, quantize_activations=quantize_acts)
    x = _apply_positions(dp, dc, spec, x, pos)
    if spec.has_layernorm_embedding:
        x = _norm(arch, dp.get("layernorm_embedding"), x)

    fresh = fresh_prefill and self_cache is not None and T > 1
    attn_cached = self_cache is not None and not fresh
    kv_lengths = None
    causal_only = attn_cached and T == 1 and lengths is None
    if attn_cached and T == 1 and "k_scale" in self_cache[0]:
        kv_lengths = (pos.to(torch.int32) if pos_vec else
                      torch.full((x.shape[0],), pos, dtype=torch.int32, device=device))
    extras = _LayerExtras(arch, dc, T, pos, attn_cached, fresh, lengths, device)
    flash_alibi = None
    if spec.alibi:
        # The flash kernel's ALiBi: the slopes, with scale_alibi folded in.
        flash_alibi = dc["alibi_slopes"]
        if spec.scale_alibi:
            flash_alibi = flash_alibi * spec.layers[0].self_attention.queries_scale

    rotary = dc.get("rotary", {})
    if pos_vec and rotary:
        rotary = _per_call_rotary(rotary, pos, T)
    qa = quantize_acts
    delta = None
    attention = None
    position_bias = None
    pair_heads: dict = {}
    for li, hi in alignment_pairs or ():
        pair_heads.setdefault(li, []).append(hi)
    collected = []
    for i, layer in enumerate(spec.layers):
        lp = dp["layers"][i]
        aspec = layer.self_attention
        ap = lp["self_attention"]
        cache_i = self_cache[i] if self_cache is not None else None
        layer_bias, alibi_bias, rel_positions, pbias, ring = extras(
            layer, lp, cache_i, t5=position_bias is None)
        if pbias is not None:
            position_bias = pbias  # T5: layer 0's bias serves every layer
        kw = dict(rot_consts=rotary.get(str(i)), offset=pos, cache=cache_i,
                  pre_norm=spec.pre_norm, quantize_acts=qa)
        self_kw = dict(kw, bias=layer_bias, alibi_bias=alibi_bias,
                       rel_positions=rel_positions, position_bias=position_bias,
                       causal=True, flash_lengths=lengths,
                       causal_only=causal_only and not aspec.sliding_window,
                       beam_chain=beam_chain, beam_chain_size=beam_size, ring=ring,
                       alibi_slopes=flash_alibi,
                       alibi_positive=spec.alibi_use_positive_positions,
                       fresh_prefill=fresh, kv_lengths=kv_lengths, pos_bound=pos_bound)
        if alignment_pairs is not None:
            want = ("logits" if raw_attention else True) if i in pair_heads else False
        else:
            want = return_attention and i == spec.alignment_layer
        weights = None
        if layer.sandwich_norm:
            x, h = _add_norm(arch, lp["input_layer_norm"], x, delta,
                             _int8_fed(qa, ap["qkv"]))
            if aspec.has_memory_kv:
                # Merged self+cross attention (T5Gemma2,
                # reference: src/layers/attention.cc:625-796).
                ctx, _, _ = merged_attention_block(
                    arch, aspec, ap, h, mem_kv[i], bias=layer_bias,
                    memory_bias=memory_bias, wrap_norm=False, **kw)
            else:
                ctx, _, _ = self_attention_block(arch, aspec, ap, h,
                                                 wrap_norm=False, **self_kw)
            # The post-attention norm normalises the block's output alone;
            # the next norm adds it to the stream.
            delta = _norm(arch, lp["post_attention_layer_norm"], ctx)
            if layer.cross_attention is not None:
                if layer.external_pre_cross_norm:
                    x, h = _add_norm(
                        arch, lp["external_pre_encoder_attention_layer_norm"], x,
                        delta, _int8_fed(qa, lp["attention"]["q"]))
                else:
                    x = h = _settle(x, delta)
                ctx, _, weights = cross_attention_block(
                    arch, layer.cross_attention, lp["attention"], h, mem_kv[i],
                    memory_bias=memory_bias, pre_norm=spec.pre_norm,
                    quantize_acts=qa, return_weights=want, wrap_norm=False)
                if layer.external_post_cross_norm:
                    ctx = _norm(arch, lp["external_post_encoder_attention_layer_norm"],
                                ctx)
                delta = ctx
            x, delta = _sandwich_ffn(arch, layer.ffn, lp, x, delta, spec.pre_norm, qa)
            if layer.layer_scalar != 1.0:
                x = _settle(x, delta) * torch.tensor(layer.layer_scalar, dtype=x.dtype)
                delta = None
        elif layer.shared_layer_norm or layer.input_layer_norm:
            # Parallel residual (reference: src/layers/transformer.cc:298-332):
            # one shared norm (GPT-J, Falcon) quantizes once for the QKV and
            # the FFN's first linears; GPT-NeoX norms the same input twice.
            norm_p = lp.get("shared_layer_norm") or lp.get("input_layer_norm")
            firsts = _ffn_firsts(layer.ffn, lp["ffn"])
            two_norms = layer.post_attention_layer_norm
            x, h = _add_norm(arch, norm_p, x, delta, _int8_fed(
                qa, ap["qkv"], *(() if two_norms else firsts)))
            a, _, _ = self_attention_block(arch, aspec, ap, h, wrap_norm=False,
                                           **self_kw)
            if two_norms:
                h = _add_norm(arch, lp["post_attention_layer_norm"], x, None,
                              _int8_fed(qa, *firsts))[1]
            f, _ = ffn_block(arch, layer.ffn, lp["ffn"], h, spec.pre_norm, qa,
                             wrap_norm=False)
            # x + a + f, summed in that order as the JAX package does.
            x, delta = x + a, f
        elif aspec.has_memory_kv:
            x, delta, _ = merged_attention_block(
                arch, aspec, ap, x, mem_kv[i], bias=layer_bias,
                memory_bias=memory_bias, delta=delta, **kw)
            x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm, qa,
                                 delta=delta)
        else:
            x, delta, _ = self_attention_block(arch, aspec, ap, x, delta=delta,
                                               **self_kw)
            if layer.cross_attention is not None:
                x, delta, weights = cross_attention_block(
                    arch, layer.cross_attention, lp["attention"], x, mem_kv[i],
                    memory_bias=memory_bias, pre_norm=spec.pre_norm,
                    quantize_acts=qa, delta=delta, return_weights=want)
            x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm, qa,
                                 delta=delta)
        if want and weights is not None:
            if alignment_pairs is not None:
                collected += [weights[:, h:h + 1] for h in pair_heads[i]]
            else:
                attention = weights[:, :spec.alignment_heads].mean(dim=1)

    if spec.has_output_norm:
        # Under W8A8 the norm quantizes for the linear that reads its output.
        after = (dp["project_out"] if spec.has_project_out
                 else dp["projection"] if (return_logits and spec.has_projection
                                           and not spec.has_outputs_scale)
                 else None)
        x = _add_norm(arch, dp.get("layer_norm"), x, delta,
                      after is not None and _int8_fed(quantize_acts, after),
                      keep_sum=False)[1]
    else:
        x = _settle(x, delta)
    if spec.has_project_out:
        x = linear(dp["project_out"], x, quantize_activations=quantize_acts)
    if spec.has_outputs_scale:
        x = x * dp["scale_outputs"].to(x.dtype)
    if return_logits and spec.has_projection:
        x = project_logits(arch, params, x, quantize_acts)
    if alignment_pairs is not None:
        return x, self_cache, (torch.cat(collected, dim=1) if collected else None)
    if return_attention:
        return x, self_cache, attention
    return x, self_cache
