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
flash kernel. ALiBi, relative positions, sliding windows, parallel-residual
and sandwich-norm layers and merged attention raise ``NotImplementedError``
until their slice.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..kernels.decode_attention import (DECODE_MAX_D, decode_attention_int8,
                                        quantize_kv)
from ..kernels.flash_attention import HEAD_DIMS, flash_attention
from ..kernels.gather_rows import gather_rows_fused
from ..ops import attention as attn_ops
from ..ops.activations import get_activation
from ..ops.linear import linear, quantize_input
from ..ops.norms import add_and_norm, apply_norm
from ..ops.positions import (apply_rotary, rotary_tables,
                             sinusoidal_position_encoding)
from .spec import ArchSpec, AttentionSpec


# ---------------------------------------------------------------------------
# Unsupported branches.
# ---------------------------------------------------------------------------


def _check_attention(spec: AttentionSpec) -> None:
    if (spec.has_rel_position_keys or spec.has_rel_asymmetric_keys
            or spec.has_rel_attention_bias):
        raise NotImplementedError("relative position attention is not ported yet")
    if spec.sliding_window:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if spec.has_memory_kv:
        raise NotImplementedError("merged self+cross attention is not ported yet")


def check_supported(arch: ArchSpec) -> None:
    """Raise NotImplementedError for architecture features this port does
    not run yet."""
    for side in (arch.encoder, arch.decoder):
        if side is None:
            continue
        if getattr(side, "alibi", False):
            raise NotImplementedError("ALiBi is not ported yet")
        if getattr(side, "num_conv_layers", 0) or getattr(side, "is_wav2vec2", False):
            raise NotImplementedError("speech encoders are not ported yet")
        for layer in side.layers:
            _check_attention(layer.self_attention)
            cross = getattr(layer, "cross_attention", None)
            if cross is not None:
                _check_attention(cross)
            if layer.sandwich_norm or getattr(layer, "shared_layer_norm", False) \
                    or getattr(layer, "input_layer_norm", False):
                raise NotImplementedError(
                    "sandwich-norm and parallel-residual layers are not ported yet")


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
    """Precompute the sinusoidal and rotary position tables on ``device``.
    Layers with the same rotary spec share one pair of tables."""
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


def _apply_positions(side_params, side_consts, spec, x, offset: int):
    """Add learned or sinusoidal position encodings at ``offset`` (the
    sinusoidal row t encodes position t+1, the reference's convention)."""
    T = x.shape[1]
    if spec.has_position_embedding:
        table = side_params["position_encodings"]
    elif spec.sinusoidal_positions:
        table = side_consts["sinusoidal"]
    else:
        return x
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


def _maybe_rotary(spec: AttentionSpec, rot_consts, q, k, offset: int):
    if spec.rotary is None:
        return q, k
    T = q.shape[2]
    dim = spec.rotary.dim if spec.rotary.dim else spec.head_dim
    sin = rot_consts["sin"][offset:offset + T]
    cos = rot_consts["cos"][offset:offset + T]
    q = apply_rotary(q, sin, cos, spec.rotary.interleave, dim)
    k = apply_rotary(k, sin, cos, spec.rotary.interleave, dim)
    return q, k


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


def _flash_eligible(q, k, min_len=None) -> bool:
    """Static dispatch decision for the flash-attention kernel: on the card,
    for an uncached attention whose query and key lengths both reach the
    threshold (``arch.flash_min_len`` when the ``flash_attention=True``
    constructor flag set it, else ``CT2TPU_FLASH_MIN_LEN``, default 2048)
    and whose head dim the kernel takes (up to its widest instance,
    ``HEAD_DIMS[-1]``; wider heads take the plain attention, as the JAX
    package declines its kernels for shapes they do not serve).
    ``CT2TPU_FLASH=0`` turns it off. Shaw and T5 relative positions and
    ALiBi, which the JAX package also weighs here, raise before this point
    in the port."""
    if os.environ.get("CT2TPU_FLASH", "1") == "0":
        return False
    if not q.is_cuda or q.shape[-1] > HEAD_DIMS[-1]:
        return False
    threshold = (min_len if min_len is not None
                 else int(os.environ.get("CT2TPU_FLASH_MIN_LEN", "2048")))
    return q.shape[2] >= threshold and k.shape[2] >= threshold


def _cache_write(buf, new, offset: int):
    """Write ``new`` [B, H, T, D] into ``buf`` [B, H, C, D] at time slot
    ``offset``, in place."""
    buf[:, :, offset:offset + new.shape[2]] = new.to(buf.dtype)
    return buf


def _append_int8_cache(cache: dict, k8, ks, v8, vs, offset: int):
    """Write quantized K/V [B, H, T, D] and their scales [B, H, T] into the
    int8 cache at time slot ``offset``, in place."""
    T = k8.shape[2]
    cache["k"][:, :, offset:offset + T] = k8
    cache["v"][:, :, offset:offset + T] = v8
    cache["k_scale"][:, :, 0, offset:offset + T] = ks
    cache["v_scale"][:, :, 0, offset:offset + T] = vs
    return cache


def _update_int8_cache(cache: dict, k, v, offset: int):
    """Quantize and append new K/V vectors at ``offset``."""
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    return _append_int8_cache(cache, k8, ks, v8, vs, offset)


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


def self_attention_block(
    arch: ArchSpec,
    spec: AttentionSpec,
    ap: dict,
    x,
    *,
    bias,
    rot_consts=None,
    offset: int = 0,
    cache: Optional[dict] = None,
    pre_norm: bool = True,
    quantize_acts: bool = True,
    causal: bool = False,
    flash_lengths=None,  # [B] valid lengths, given to the flash kernel
    causal_only: bool = False,  # ``bias`` is exactly the T == 1 causal mask
    beam_chain=None,  # [N, C] origin chain (chain-mask beam attention)
    beam_chain_size: int = 1,
    fresh_prefill: bool = False,  # the cache is empty and this call writes
    # its first T positions: attend over the fresh tensors only (O(T^2),
    # flash-eligible); ``bias`` must then cover [*, T, T]
    kv_lengths=None,  # int32 [B] filled with ``offset`` (int8 decode kernel)
    delta=None,  # the previous block's output, not yet added to ``x``
):
    """Self-attention with an optional fixed-capacity KV cache.

    Returns (x, delta, cache): in a pre-norm block the residual stream and
    this block's output, whose add the next norm makes; otherwise the
    block's output and None. ``cache`` holds {"k","v"} of shape
    [B, Hkv, C, D] (plus {"k_scale","v_scale"} [B, Hkv, 1, C] in the int8
    layout); this call's keys/values are written at ``offset``, in place.
    """
    fused = pre_norm and spec.has_layer_norm
    if fused:
        x, h = _add_norm(arch, ap.get("layer_norm"), x, delta,
                         _int8_fed(quantize_acts, ap["qkv"]))
    else:
        x = h = _settle(x, delta)

    q, k, v = _project_qkv(arch, ap, spec, h, quantize_acts)
    q, k = _maybe_rotary(spec, rot_consts, q, k, offset)
    T = q.shape[2]

    attn_cache = cache
    if cache is not None and fresh_prefill and T > 1:
        # First-chunk prefill: write the cache, then attend over the fresh
        # Q/K/V as if cache-less.
        if "k_scale" in cache:
            _update_int8_cache(cache, k, v, offset)
        else:
            _cache_write(cache["k"], k, offset)
            _cache_write(cache["v"], v, offset)
        attn_cache = None

    if attn_cache is not None and "k_scale" in attn_cache:
        if T == 1 and _use_decode_kernel(q):
            # Attend over [pre-append cache | fresh K/V], then append.
            k8, ks = quantize_kv(k)
            v8, vs = quantize_kv(v)
            if kv_lengths is None:
                kv_lengths = torch.full((q.shape[0],), offset, dtype=torch.int32,
                                        device=q.device)
            ctx = decode_attention_int8(
                q, cache["k"], cache["k_scale"][:, :, 0, :],
                cache["v"], cache["v_scale"][:, :, 0, :], kv_lengths,
                k_new8=k8, kn_scale=ks, v_new8=v8, vn_scale=vs,
                scale=spec.queries_scale, window=spec.sliding_window)
            _append_int8_cache(cache, k8, ks, v8, vs, offset)
            ctx = ctx.to(x.dtype)
        else:
            # Prefill into a filled cache, or the CPU: dequantize the whole
            # cache for the masked attention.
            _update_int8_cache(cache, k, v, offset)
            kd, vd = _dequantize_cache(cache, q.dtype)
            ctx = attn_ops.dot_product_attention(
                q, kd, vd, bias=bias, queries_scale=spec.queries_scale)
    elif attn_cache is not None and T == 1:
        ck, cv = cache["k"], cache["v"]
        k_new, v_new = k.to(ck.dtype), v.to(cv.dtype)
        chunk = _chunked(causal_only, ck.shape[2])
        if beam_chain is not None:
            # Chain attention over the PRE-append cache + the fresh token.
            if chunk:
                ctx = attn_ops.chunked_beam_chain_attention(
                    q, ck, cv, beam_chain, k_new, v_new, offset,
                    beam_size=beam_chain_size,
                    queries_scale=spec.queries_scale, chunk=chunk)
            else:
                ctx = attn_ops.beam_chain_attention(
                    q, ck, cv, beam_chain, beam_size=beam_chain_size,
                    queries_scale=spec.queries_scale, bias=bias,
                    k_new=k_new, v_new=v_new)
        elif chunk:
            ctx = attn_ops.chunked_decode_attention(
                q, ck, cv, k_new, v_new, offset,
                queries_scale=spec.queries_scale, chunk=chunk)
        else:
            ctx = attn_ops.decode_step_attention(
                q, ck, cv, k_new, v_new, offset,
                queries_scale=spec.queries_scale, bias=bias)
        # The append comes after the attention read the pre-append cache.
        _cache_write(ck, k_new, offset)
        _cache_write(cv, v_new, offset)
    else:
        if attn_cache is not None:
            k = _cache_write(cache["k"], k, offset)
            v = _cache_write(cache["v"], v, offset)
        if attn_cache is None and _flash_eligible(q, k, arch.flash_min_len):
            ctx = flash_attention(
                q, k, v, scale=spec.queries_scale, causal=causal,
                lengths=(None if flash_lengths is None
                         else flash_lengths.to(torch.int32)),
                window=spec.sliding_window)
        else:
            ctx = attn_ops.dot_product_attention(
                q, k, v, bias=bias, queries_scale=spec.queries_scale)

    out = attn_ops.combine_heads(ctx)
    out = linear(ap["o"], out, quantize_activations=quantize_acts)
    if fused:
        return x, out, cache
    if spec.has_layer_norm:  # post-norm: norm(out + x)
        out = _add_norm(arch, ap.get("layer_norm"), x, out, keep_sum=False)[1]
    return out, None, cache


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
    return_weights: bool = False,
):
    """Cross-attention with beam-shared memory; returns (x, delta, weights):
    (x, delta) as ``self_attention_block`` does, and with
    ``return_weights`` the softmax weights [B*beam, Hq, T, S] (else None).
    The weights leave the residual stream as it is.

    ``x``: [B*beam, T, D_model]; ``mem_kv["k"]``: [B, Hkv, S, Dh]. The beam
    folds into the query time axis so memory K/V are read once.
    """
    fused = pre_norm and spec.has_layer_norm
    if fused:
        x, h = _add_norm(arch, ap.get("layer_norm"), x, delta,
                         _int8_fed(quantize_acts, ap["q"]))
    else:
        x = h = _settle(x, delta)

    BK, T, _ = x.shape
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
    if fused:
        return x, y, weights
    if spec.has_layer_norm:  # post-norm: norm(y + x)
        y = _add_norm(arch, ap.get("layer_norm"), x, y, keep_sum=False)[1]
    return y, None, weights


def ffn_block(arch: ArchSpec, spec, fp: dict, x, pre_norm: bool,
              quantize_acts: bool = True, delta=None):
    """Feed-forward with optional GLU (reference:
    src/layers/transformer.cc:8-51); returns (x, delta) as
    ``self_attention_block`` does. Under W8A8 the norm quantizes ``h`` once
    for both GLU linears."""
    has_norm = "layer_norm" in fp
    fused = pre_norm and has_norm
    if fused:
        firsts = ((fp["linear_0"], fp["linear_0_noact"]) if spec.glu
                  else (fp["linear_0"],))
        x, h = _add_norm(arch, fp["layer_norm"], x, delta,
                         _int8_fed(quantize_acts, *firsts))
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


# ---------------------------------------------------------------------------
# Encoder.
# ---------------------------------------------------------------------------


def encoder_forward(arch: ArchSpec, params: dict, consts: dict, ids, lengths,
                    quantize_acts: bool = True, out_dtype=torch.float32):
    """Full encoder pass. ids [B, S], lengths [B] -> [B, S, D]."""
    check_supported(arch)
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
    bias = attn_ops.length_mask_bias(lengths, main_ids.shape[-1])
    delta = None
    for i, layer in enumerate(spec.layers):
        lp = ep["layers"][i]
        x, delta, _ = self_attention_block(
            arch, layer.self_attention, lp["self_attention"], x,
            bias=bias, rot_consts=ec.get("rotary", {}).get(str(i)),
            pre_norm=spec.pre_norm, quantize_acts=quantize_acts,
            causal=False, flash_lengths=lengths, delta=delta)
        x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm,
                             quantize_acts, delta=delta)

    if spec.has_output_norm:
        return _add_norm(arch, ep.get("layer_norm"), x, delta, keep_sum=False)[1]
    return _settle(x, delta)


# ---------------------------------------------------------------------------
# Decoder cache.
# ---------------------------------------------------------------------------


def init_self_cache(arch: ArchSpec, batch: int, capacity: int,
                    dtype=torch.float32, device="cpu"):
    """Fixed-capacity self-attention KV cache: one dict per decoder layer
    with "k" and "v" of [batch, Hkv, capacity, D]. ``dtype=torch.int8``
    selects the quantized layout: int8 payloads plus "k_scale" and
    "v_scale" of [batch, Hkv, 1, capacity], one float scale per cached
    vector (ones where nothing is written, so dequantizing stays finite)."""
    out = []
    for layer in arch.decoder.layers:
        a = layer.self_attention
        shape = (batch, a.num_heads_kv, capacity, a.head_dim)
        layer_cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            sshape = (batch, a.num_heads_kv, 1, capacity)
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


def cache_grow(cache, n_rows: int, capacity: int):
    """A cache of ``n_rows`` batch rows and ``capacity`` positions: each row
    tiled ``n_rows // rows`` times, the time axis padded with zeros (the
    int8 layout's scales with ones, so dequantizing stays finite). Arrays
    already of that size are returned as they are."""
    if cache is None:
        return None

    def grow(name, a):
        if a.shape[0] != n_rows:
            a = a.repeat_interleave(n_rows // a.shape[0], dim=0)
        axis = 3 if name.endswith("_scale") else 2
        if a.shape[axis] < capacity:
            pad = list(a.shape)
            pad[axis] = capacity - a.shape[axis]
            fill = torch.ones if name.endswith("_scale") else torch.zeros
            a = torch.cat([a, fill(pad, dtype=a.dtype, device=a.device)], dim=axis)
        return a

    return [{name: grow(name, a) for name, a in layer.items()} for layer in cache]


def precompute_memory(arch: ArchSpec, params: dict, memory, quantize_acts: bool = True):
    """Project encoder output into per-layer cross K/V (prefill-once). Under
    W8A8 the memory is quantized once for every layer's K and V."""
    layers = params["decoder"]["layers"]
    kv = [layers[i]["attention"][n] for i, layer in enumerate(arch.decoder.layers)
          if layer.cross_attention is not None for n in ("k", "v")]
    if kv and _int8_fed(quantize_acts, *kv):
        memory = quantize_input(memory)
    out = []
    for i, layer in enumerate(arch.decoder.layers):
        if layer.cross_attention is None:
            out.append(None)
            continue
        out.append(precompute_cross_kv(arch, layer.cross_attention,
                                       layers[i]["attention"], memory,
                                       quantize_acts))
    return out


# ---------------------------------------------------------------------------
# Decoder.
# ---------------------------------------------------------------------------


def decoder_forward(
    arch: ArchSpec,
    params: dict,
    consts: dict,
    ids,  # [B*beam, T]
    pos: int,  # position of ids[:, 0]
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
):
    """Decoder pass covering both modes:

    - cached step/prefill: ``self_cache`` given; keys live at [0, pos+T)
      and this call's keys are written in place;
    - full sequence (scoring): ``self_cache=None``; plain causal masking.

    ``mem_kv`` is None for a decoder-only model. Returns (logits
    [B*beam, T, V] (or the hidden states when ``return_logits`` is False),
    self_cache); with ``return_attention`` also the cross-attention weights
    of layer ``spec.alignment_layer`` averaged over its first
    ``spec.alignment_heads`` heads, float32 [B*beam, T, S] (None without a
    cross-attention there) (reference: src/layers/transformer.cc:565-603).
    """
    check_supported(arch)
    if getattr(pos, "ndim", 0) > 0:
        raise NotImplementedError(
            "per-row positions (continuous batching) are not ported yet")
    spec = arch.decoder
    dp = params["decoder"]
    dc = consts.get("decoder", {})
    T = ids.shape[-1]
    device = (ids[0] if isinstance(ids, (tuple, list)) else ids).device

    x = embed(dp, spec, ids, out_dtype, spec.embeddings.merge)
    if spec.start_from_zero_embedding and pos == 0:
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
    kv_lengths = None
    if self_cache is not None and not fresh:
        C = self_cache[0]["k"].shape[2]
        bias = attn_ops.causal_mask_bias(T, C, offset=pos, device=device)
        if lengths is not None:
            bias = bias + attn_ops.length_mask_bias(lengths, C)
        causal_only = T == 1 and lengths is None
        if T == 1 and "k_scale" in self_cache[0]:
            kv_lengths = torch.full((x.shape[0],), pos, dtype=torch.int32,
                                    device=device)
    else:
        # No cache, or an empty one: attention sees the T fresh positions.
        bias = attn_ops.causal_mask_bias(T, T, device=device)
        if lengths is not None:
            bias = bias + attn_ops.length_mask_bias(lengths, T)
        causal_only = False

    rotary = dc.get("rotary", {})
    delta = None
    attention = None
    for i, layer in enumerate(spec.layers):
        lp = dp["layers"][i]
        x, delta, _ = self_attention_block(
            arch, layer.self_attention, lp["self_attention"], x,
            bias=bias, rot_consts=rotary.get(str(i)), offset=pos,
            cache=self_cache[i] if self_cache is not None else None,
            pre_norm=spec.pre_norm, quantize_acts=quantize_acts,
            causal=True, flash_lengths=lengths,
            causal_only=causal_only,
            beam_chain=beam_chain, beam_chain_size=beam_size,
            fresh_prefill=fresh, kv_lengths=kv_lengths, delta=delta)
        if layer.cross_attention is not None:
            want = return_attention and i == spec.alignment_layer
            x, delta, weights = cross_attention_block(
                arch, layer.cross_attention, lp["attention"], x, mem_kv[i],
                memory_bias=memory_bias, pre_norm=spec.pre_norm,
                quantize_acts=quantize_acts, delta=delta, return_weights=want)
            if want:
                attention = weights[:, :spec.alignment_heads].mean(dim=1)
        x, delta = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm,
                             quantize_acts, delta=delta)

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
        x = linear(dp["projection"], x, quantize_activations=quantize_acts)
        if spec.final_logit_softcapping:
            cap = spec.final_logit_softcapping
            x = torch.tanh(x / cap) * cap
    if return_attention:
        return x, self_cache, attention
    return x, self_cache
