"""Scaled dot-product attention with GQA grouping and additive masks.

Port of ``ctranslate2_tpu/ops/attention.py``: KV heads stay un-replicated
and queries are grouped ([B, Hkv, G, Tq, D]); the KV cache has a fixed
capacity; masks are additive float32 biases; softmax runs in float32.
Products run in the activation dtype and their results are read as
float32, as the JAX package's ``preferred_element_type=float32`` does.

Relative positions (Shaw, T5), ALiBi and ring-buffer masks are not ported
yet.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Mask builders (additive f32 biases broadcastable to [B, H, Tq, Tk];
# 0 = attend, NEG_INF = masked).
# ---------------------------------------------------------------------------

def _where_bias(valid):
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def length_mask_bias(lengths, num_keys: int):
    """[B, 1, 1, Tk] bias masking keys >= length."""
    key_pos = torch.arange(num_keys, device=lengths.device)
    valid = key_pos[None, :] < lengths[:, None]
    return _where_bias(valid)[:, None, None, :]


def causal_mask_bias(num_queries: int, num_keys: int, offset: int = 0,
                     device=None):
    """[1, 1, Tq, Tk] causal bias; query i attends keys <= i + offset."""
    q_pos = torch.arange(num_queries, device=device)[:, None] + offset
    k_pos = torch.arange(num_keys, device=device)[None, :]
    return _where_bias(k_pos <= q_pos)[None, None]


def combine_bias(*biases):
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out


# ---------------------------------------------------------------------------
# Core attention.
# ---------------------------------------------------------------------------

def _group_bias(bias, Hkv: int, group: int):
    """Reshape a [B|1, H|1, Tq, Tk] bias to broadcast over [B, Hkv, G, ...]."""
    bias = bias.float()
    if bias.dim() == 3:  # per-head [Hq, Tq, Tk]
        return bias.reshape(1, Hkv, group, *bias.shape[1:])
    if bias.dim() == 4:
        if bias.shape[1] == 1:
            return bias[:, :, None]
        return bias.reshape(bias.shape[0], Hkv, group, *bias.shape[2:])
    return bias


def dot_product_attention(
    q,  # [B, Hq, Tq, D]
    k,  # [B, Hkv, Tk, D]
    v,  # [B, Hkv, Tk, D]
    bias=None,  # additive f32, broadcastable to [B, Hq, Tq, Tk]
    queries_scale: float = 1.0,
):
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv

    qg = q.reshape(B, Hkv, group, Tq, D)
    logits = torch.matmul(qg, k[:, :, None].transpose(-1, -2)).float() * queries_scale
    if bias is not None:
        logits = logits + _group_bias(bias, Hkv, group)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype), v[:, :, None])
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def split_heads(x, num_heads: int):
    """[B, T, H*D] -> [B, H, T, D]"""
    B, T, HD = x.shape
    return x.reshape(B, T, num_heads, HD // num_heads).transpose(1, 2)


def combine_heads(x):
    """[B, H, T, D] -> [B, T, H*D]"""
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def beam_chain_attention(
    q,  # [N, Hq, 1, D], N = B*beam row-major
    k,  # [N, Hkv, C, D] (never physically reordered)
    v,  # [N, Hkv, C, D]
    chain,  # [N, C] int: slot j's owning beam within the group, or -1
    *,
    beam_size: int,
    queries_scale: float = 1.0,
    bias=None,  # additive, broadcastable over slots [.., 1, C]
    k_new=None,  # [N, Hkv, 1, D]: this step's fresh key (pre-append)
    v_new=None,
):
    """Beam attention without physical cache reordering.

    Each query attends over its WHOLE beam group's cache [beam*C slots]
    with an additive mask selecting, per slot, the one physical beam
    recorded in the origin chain. Unwritten slots are -1, which also
    subsumes the causal mask for single-token decode.
    """
    N, Hq, Tq, D = q.shape
    Hkv, C = k.shape[1], k.shape[2]
    K = beam_size
    B = N // K
    group = Hq // Hkv

    qg = q.reshape(B, K, Hkv, group, Tq, D)
    kg = k.reshape(B, K, Hkv, C, D)
    vg = v.reshape(B, K, Hkv, C, D)

    logits = torch.einsum("bkhgqd,bphcd->bkhgqpc", qg, kg).float() * queries_scale

    # Chain mask: slot (p, c) visible to beam k iff chain[b, k, c] == p.
    ch = chain.reshape(B, K, C)
    beams = torch.arange(K, dtype=chain.dtype, device=chain.device)
    valid = ch[:, :, None, :] == beams[None, None, :, None]
    mask = torch.where(valid, 0.0, -1e30).to(torch.float32)  # [B, K, K, C]
    logits = logits + mask[:, :, None, None, None, :, :]
    if bias is not None:
        b4 = bias.float()
        logits = logits + b4.reshape(
            (1,) * 4 + (Tq, 1, C) if b4.dim() <= 4 else tuple(b4.shape))

    flat = logits.reshape(B, K, Hkv, group, Tq, K * C)
    if k_new is not None:
        # Fresh token attends through its own row (kept out of the cache so
        # the append can come after the attention).
        lf = torch.einsum("bkhgqd,bkhd->bkhgq", qg,
                          k_new.reshape(B, K, Hkv, D)).float() * queries_scale
        flat = torch.cat([flat, lf[..., None]], dim=-1)
    weights = torch.softmax(flat, dim=-1)
    wc = weights[..., :K * C].reshape(B, K, Hkv, group, Tq, K, C)
    out = torch.einsum("bkhgqpc,bphcd->bkhgqd", wc.to(v.dtype), vg).float()
    if k_new is not None:
        out = out + torch.einsum(
            "bkhgq,bkhd->bkhgqd", weights[..., K * C].to(v.dtype),
            v_new.reshape(B, K, Hkv, D)).float()
    return out.reshape(N, Hq, Tq, D).to(q.dtype)


def chunked_beam_chain_attention(
    q,  # [N, Hq, 1, D], N = B*beam row-major
    k,  # [N, Hkv, C, D]
    v,
    chain,  # [N, C] int origin chain
    k_new,  # [N, Hkv, 1, D]
    v_new,
    pos: int,  # number of valid cached slots
    *,
    beam_size: int,
    queries_scale: float = 1.0,
    chunk: int = 128,
):
    """``beam_chain_attention`` (fresh-token form) reading only the written
    cache prefix, via an online-softmax loop over ``ceil(pos/chunk)``
    chunks (see ``chunked_decode_attention``)."""
    N, Hq, Tq, D = q.shape
    Hkv, C = k.shape[1], k.shape[2]
    K = beam_size
    B = N // K
    group = Hq // Hkv

    qg = q.reshape(B, K, Hkv, group, D)
    kg = k.reshape(B, K, Hkv, C, D)
    vg = v.reshape(B, K, Hkv, C, D)
    ch = chain.reshape(B, K, C)

    lf = torch.einsum("bkhgd,bkhd->bkhg", qg,
                      k_new.reshape(B, K, Hkv, D)).float() * queries_scale
    m = lf
    l = torch.ones_like(lf)
    acc = v_new.reshape(B, K, Hkv, 1, D).float().expand(B, K, Hkv, group, D)

    beams = torch.arange(K, dtype=chain.dtype, device=chain.device)
    for start in range(0, pos, chunk):
        kc = kg[:, :, :, start:start + chunk]
        vc = vg[:, :, :, start:start + chunk]
        chc = ch[:, :, start:start + chunk]
        s = torch.einsum("bkhgd,bphcd->bkhgpc", qg, kc).float() * queries_scale
        # Slot (p, c) visible to query beam k iff chain[b, k, c] == p (an
        # unwritten slot is -1, matching no beam).
        valid = chc[:, :, None, :] == beams[None, None, :, None]
        s = s + torch.where(valid, 0.0, -1e30).to(torch.float32)[:, :, None, None]
        s = s.reshape(B, K, Hkv, group, -1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pw = p.reshape(B, K, Hkv, group, K, -1).to(vc.dtype)
        acc = acc * corr[..., None] + torch.einsum(
            "bkhgpc,bphcd->bkhgd", pw, vc).float()
        m = m_new
    ctx = acc / l[..., None]
    return ctx.reshape(N, Hq, Tq, D).to(q.dtype)


def decode_step_attention(
    q,  # [B, Hq, 1, D]
    k_pre,  # [B, Hkv, C, D] cache BEFORE this step's append
    v_pre,
    k_new,  # [B, Hkv, 1, D] this step's key/value
    v_new,
    pos: int,  # slot the fresh token occupies
    *,
    queries_scale: float = 1.0,
    bias=None,  # additive over cache slots, broadcastable [.., 1, C]
):
    """Single-token decode attention over [pre-update cache | fresh token].

    Mathematically identical to appending first and attending over the
    updated cache; slot ``pos`` of the pre-cache (stale data) is masked out
    explicitly, and the cache append comes after.
    """
    B, Hq, Tq, D = q.shape
    Hkv, C = k_pre.shape[1], k_pre.shape[2]
    group = Hq // Hkv

    qg = q.reshape(B, Hkv, group, Tq, D)
    lc = torch.matmul(qg, k_pre[:, :, None].transpose(-1, -2)).float() * queries_scale
    lf = torch.einsum("bhgqd,bhd->bhgq", qg, k_new[:, :, 0]).float() * queries_scale

    excl = torch.where(torch.arange(C, device=q.device) == pos, -1e30, 0.0)
    lc = lc + excl.to(torch.float32)
    if bias is not None:
        lc = lc + _group_bias(bias, Hkv, group)

    full = torch.cat([lc, lf[..., None]], dim=-1)  # [..., C+1]
    w = torch.softmax(full, dim=-1)
    ctx = torch.matmul(w[..., :C].to(v_pre.dtype), v_pre[:, :, None]).float()
    ctx = ctx + torch.einsum(
        "bhgq,bhd->bhgqd", w[..., C].to(v_new.dtype), v_new[:, :, 0]).float()
    return ctx.reshape(B, Hq, Tq, D).to(q.dtype)


def chunked_decode_attention(
    q,  # [B, Hq, 1, D]
    k_pre,  # [B, Hkv, C, D] cache BEFORE this step's append
    v_pre,
    k_new,  # [B, Hkv, 1, D]
    v_new,
    pos: int,  # number of valid cached slots (< pos)
    *,
    queries_scale: float = 1.0,
    chunk: int = 128,
):
    """``decode_step_attention`` that only READS the written cache prefix:
    an online-softmax loop over ``ceil(pos/chunk)`` chunks, so per-step
    traffic scales with the actual length."""
    B, Hq, Tq, D = q.shape
    Hkv, C = k_pre.shape[1], k_pre.shape[2]
    group = Hq // Hkv

    qg = q.reshape(B, Hkv, group, D)
    # Seed the accumulators with the fresh token (its logit is the running
    # max, weight exp(0)=1).
    lf = torch.einsum("bhgd,bhd->bhg", qg, k_new[:, :, 0]).float() * queries_scale
    m = lf
    l = torch.ones_like(lf)
    acc = v_new[:, :, None, 0].float().expand(B, Hkv, group, D)

    for start in range(0, pos, chunk):
        kc = k_pre[:, :, start:start + chunk]
        vc = v_pre[:, :, start:start + chunk]
        s = torch.einsum("bhgd,bhcd->bhgc", qg, kc).float() * queries_scale
        valid = (start + torch.arange(kc.shape[2], device=q.device)) < pos
        s = torch.where(valid[None, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgc,bhcd->bhgd", p.to(vc.dtype), vc).float()
        m = m_new
    ctx = acc / l[..., None]
    return ctx.reshape(B, Hq, Tq, D).to(q.dtype)
