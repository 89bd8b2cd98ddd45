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
Rotary, ALiBi, relative positions, sliding windows, parallel-residual and
sandwich-norm layers, merged attention, the int8 KV cache and the flash
kernel raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..kernels.gather_rows import gather_rows_fused
from ..ops import attention as attn_ops
from ..ops.activations import get_activation
from ..ops.linear import linear
from ..ops.norms import apply_norm
from ..ops.positions import sinusoidal_position_encoding
from .spec import ArchSpec, AttentionSpec


# ---------------------------------------------------------------------------
# Unsupported branches.
# ---------------------------------------------------------------------------


def _check_attention(spec: AttentionSpec) -> None:
    if spec.rotary is not None:
        raise NotImplementedError("rotary position embeddings are not ported yet")
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


def make_consts(arch: ArchSpec, params: dict, max_positions: int = 4096,
                device="cpu") -> dict:
    """Precompute the sinusoidal position tables on ``device``."""
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


def _norm(arch: ArchSpec, p: Optional[dict], x):
    if p is None:
        return x
    eps = arch.ln_epsilon
    if eps is None:
        eps = 1e-5 if "beta" in p else 1e-6
    return apply_norm(p, x, eps)


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


def _check_flash(q, k) -> None:
    """The JAX package sends uncached self-attention of T, S >= 2048 on its
    accelerator to the flash kernel (its ``_flash_eligible``); that kernel
    is not ported yet, so the same call on the card raises instead of
    taking the plain path. ``CT2TPU_FLASH=0`` opts out, as there."""
    if not q.is_cuda or os.environ.get("CT2TPU_FLASH", "1") == "0":
        return
    threshold = int(os.environ.get("CT2TPU_FLASH_MIN_LEN", "2048"))
    if q.shape[2] >= threshold and k.shape[2] >= threshold:
        raise NotImplementedError(
            "flash attention is not ported yet (sequence of "
            f"{q.shape[2]} >= CT2TPU_FLASH_MIN_LEN={threshold}; "
            "CT2TPU_FLASH=0 takes the plain attention)")


def _cache_write(buf, new, offset: int):
    """Write ``new`` [B, H, T, D] into ``buf`` [B, H, C, D] at time slot
    ``offset``, in place."""
    buf[:, :, offset:offset + new.shape[2]] = new.to(buf.dtype)
    return buf


def self_attention_block(
    arch: ArchSpec,
    spec: AttentionSpec,
    ap: dict,
    x,
    *,
    bias,
    offset: int = 0,
    cache: Optional[dict] = None,
    pre_norm: bool = True,
    quantize_acts: bool = True,
    causal_only: bool = False,  # ``bias`` is exactly the T == 1 causal mask
    beam_chain=None,  # [N, C] origin chain (chain-mask beam attention)
    beam_chain_size: int = 1,
):
    """Self-attention with an optional fixed-capacity KV cache.

    Returns (output, cache). ``cache`` holds {"k","v"} of shape
    [B, Hkv, C, D]; this call's keys/values are written at ``offset``, in
    place.
    """
    residual = x
    h = x
    if pre_norm and spec.has_layer_norm:
        h = _norm(arch, ap.get("layer_norm"), h)

    q, k, v = _project_qkv(arch, ap, spec, h, quantize_acts)
    T = q.shape[2]

    if cache is not None and T == 1:
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
        if cache is not None:
            k = _cache_write(cache["k"], k, offset)
            v = _cache_write(cache["v"], v, offset)
        else:
            _check_flash(q, k)
        ctx = attn_ops.dot_product_attention(
            q, k, v, bias=bias, queries_scale=spec.queries_scale)

    out = attn_ops.combine_heads(ctx)
    res = residual if spec.has_layer_norm else None
    out = linear(ap["o"], out, residual=res, quantize_activations=quantize_acts)
    if not pre_norm and spec.has_layer_norm:
        out = _norm(arch, ap.get("layer_norm"), out)
    return out, cache


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
):
    """Cross-attention with beam-shared memory.

    ``x``: [B*beam, T, D_model]; ``mem_kv["k"]``: [B, Hkv, S, Dh]. The beam
    folds into the query time axis so memory K/V are read once.
    """
    residual = x
    h = x
    if pre_norm and spec.has_layer_norm:
        h = _norm(arch, ap.get("layer_norm"), h)

    BK, T, _ = h.shape
    B = mem_kv["k"].shape[0]
    K = BK // B

    q = linear(ap["q"], h, quantize_activations=quantize_acts)
    if spec.has_q_norm:
        q = _norm(arch, ap.get("q_norm"), q)
    q = attn_ops.split_heads(q.reshape(B, K * T, -1), spec.num_heads)
    ctx = attn_ops.dot_product_attention(
        q, mem_kv["k"], mem_kv["v"], bias=memory_bias,
        queries_scale=spec.queries_scale)
    ctx = attn_ops.combine_heads(ctx).reshape(BK, T, -1)
    res = residual if spec.has_layer_norm else None
    y = linear(ap["o"], ctx, residual=res, quantize_activations=quantize_acts)
    if not pre_norm and spec.has_layer_norm:
        y = _norm(arch, ap.get("layer_norm"), y)
    return y


def ffn_block(arch: ArchSpec, spec, fp: dict, x, pre_norm: bool,
              quantize_acts: bool = True):
    """Feed-forward with optional GLU (reference: src/layers/transformer.cc:8-51)."""
    residual = x
    h = x
    has_norm = "layer_norm" in fp
    if pre_norm and has_norm:
        h = _norm(arch, fp.get("layer_norm"), h)
    act = get_activation(spec.activation)
    inner = linear(fp["linear_0"], h, activation=act, quantize_activations=quantize_acts)
    if spec.glu:
        gate = linear(fp["linear_0_noact"], h, quantize_activations=quantize_acts)
        inner = inner * gate
    res = residual if has_norm else None
    out = linear(fp["linear_1"], inner, residual=res, quantize_activations=quantize_acts)
    if not pre_norm and has_norm:
        out = _norm(arch, fp.get("layer_norm"), out)
    return out


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
    for i, layer in enumerate(spec.layers):
        lp = ep["layers"][i]
        x, _ = self_attention_block(
            arch, layer.self_attention, lp["self_attention"], x,
            bias=bias, pre_norm=spec.pre_norm, quantize_acts=quantize_acts)
        x = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm, quantize_acts)

    if spec.has_output_norm:
        x = _norm(arch, ep.get("layer_norm"), x)
    return x


# ---------------------------------------------------------------------------
# Decoder cache.
# ---------------------------------------------------------------------------


def init_self_cache(arch: ArchSpec, batch: int, capacity: int,
                    dtype=torch.float32, device="cpu"):
    """Fixed-capacity self-attention KV cache: one {"k","v"} dict of
    [batch, Hkv, capacity, D] per decoder layer."""
    out = []
    for layer in arch.decoder.layers:
        a = layer.self_attention
        shape = (batch, a.num_heads_kv, capacity, a.head_dim)
        out.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)})
    return out


def cache_gather_rows(cache, rows):
    """Reorder/select cache batch rows (beam reorder) in one fused gather
    over every cache array; returns a new cache."""
    if cache is None:
        return None
    leaves = [a for layer in cache for a in (layer["k"], layer["v"])]
    out = gather_rows_fused(leaves, rows)
    return [{"k": out[2 * i], "v": out[2 * i + 1]} for i in range(len(cache))]


def precompute_memory(arch: ArchSpec, params: dict, memory, quantize_acts: bool = True):
    """Project encoder output into per-layer cross K/V (prefill-once)."""
    layers = params["decoder"]["layers"]
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
):
    """Decoder pass covering both modes:

    - cached step/prefill: ``self_cache`` given; keys live at [0, pos+T)
      and this call's keys are written in place;
    - full sequence (scoring): ``self_cache=None``; plain causal masking.

    Returns (logits [B*beam, T, V] (or the hidden states when
    ``return_logits`` is False), self_cache).
    """
    check_supported(arch)
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

    if self_cache is not None:
        C = self_cache[0]["k"].shape[2]
        bias = attn_ops.causal_mask_bias(T, C, offset=pos, device=device)
        if lengths is not None:
            bias = bias + attn_ops.length_mask_bias(lengths, C)
        causal_only = T == 1 and lengths is None
    else:
        bias = attn_ops.causal_mask_bias(T, T, device=device)
        if lengths is not None:
            bias = bias + attn_ops.length_mask_bias(lengths, T)
        causal_only = False

    for i, layer in enumerate(spec.layers):
        lp = dp["layers"][i]
        x, _ = self_attention_block(
            arch, layer.self_attention, lp["self_attention"], x,
            bias=bias, offset=pos,
            cache=self_cache[i] if self_cache is not None else None,
            pre_norm=spec.pre_norm, quantize_acts=quantize_acts,
            causal_only=causal_only,
            beam_chain=beam_chain, beam_chain_size=beam_size)
        if layer.cross_attention is not None:
            x = cross_attention_block(
                arch, layer.cross_attention, lp["attention"], x, mem_kv[i],
                memory_bias=memory_bias, pre_norm=spec.pre_norm,
                quantize_acts=quantize_acts)
        x = ffn_block(arch, layer.ffn, lp["ffn"], x, spec.pre_norm, quantize_acts)

    if spec.has_output_norm:
        x = _norm(arch, dp.get("layer_norm"), x)
    if spec.has_project_out:
        x = linear(dp["project_out"], x, quantize_activations=quantize_acts)
    if spec.has_outputs_scale:
        x = x * dp["scale_outputs"].to(x.dtype)
    if not (return_logits and spec.has_projection):
        return x, self_cache
    logits = linear(dp["projection"], x, quantize_activations=quantize_acts)
    if spec.final_logit_softcapping:
        cap = spec.final_logit_softcapping
        logits = torch.tanh(logits / cap) * cap
    return logits, self_cache
