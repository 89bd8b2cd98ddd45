"""Scaled dot-product attention with GQA grouping and additive masks.

Port of ``ctranslate2_tpu/ops/attention.py``: KV heads stay un-replicated
and queries are grouped ([B, Hkv, G, Tq, D]); the KV cache has a fixed
capacity; masks are additive float32 biases; softmax runs in float32.
Products run in the activation dtype and their results are read as
float32, as the JAX package's ``preferred_element_type=float32`` does.

Sliding windows, ring-buffer windows, ALiBi, and the relative-position
schemes (Shaw keys/values, T5 buckets; reference:
src/layers/attention.cc:16-165) build the same biases and indices as the
JAX package, bit for bit. Every position may be a Python int shared by
the batch or an int [B] tensor of per-row positions (continuous batching:
each slot decodes at its own position); the per-row forms gain a leading
batch axis.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import relative_position_bucket

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


def per_row(offset) -> bool:
    """Whether ``offset`` is a [B] tensor of per-row positions."""
    return getattr(offset, "ndim", 0) > 0


def _query_positions(num_queries: int, offset, device):
    """Absolute query positions: [Tq, 1] for a shared offset, [B, Tq, 1]
    for per-row offsets (row b's query i sits at ``offset[b] + i``)."""
    if per_row(offset):
        return (offset.to(torch.int64)[:, None, None]
                + torch.arange(num_queries, device=offset.device)[None, :, None])
    return torch.arange(num_queries, device=device)[:, None] + offset


def _bias_rows(valid):
    """[1, 1, Tq, Tk] from a shared [Tq, Tk] mask, [B, 1, Tq, Tk] from a
    per-row [B, Tq, Tk] one."""
    b = _where_bias(valid)
    return b[:, None] if b.dim() == 3 else b[None, None]


def causal_mask_bias(num_queries: int, num_keys: int, offset=0, device=None):
    """[1, 1, Tq, Tk] causal bias, query i attending keys <= i + offset;
    [B, 1, Tq, Tk] for per-row offsets."""
    q_pos = _query_positions(num_queries, offset, device)
    k_pos = torch.arange(num_keys, device=q_pos.device)
    return _bias_rows(k_pos <= q_pos)


def sliding_window_bias(num_queries: int, num_keys: int, window: int,
                        offset=0, device=None):
    """[1, 1, Tq, Tk] ([B, 1, Tq, Tk] for per-row offsets): restrict
    attention to the last ``window`` keys (inclusive of self)."""
    q_pos = _query_positions(num_queries, offset, device)
    k_pos = torch.arange(num_keys, device=q_pos.device)
    return _bias_rows(k_pos > q_pos - window)


def ring_window_bias(num_queries: int, ring: int, window: int, offset=0,
                     device=None):
    """[1, 1, Tq, ring] ([B, 1, Tq, ring] for per-row offsets): the bias of
    a RING KV buffer of ``ring`` slots holding a sliding window of
    ``window`` positions (the reference evicts instead:
    src/layers/attention.cc:536-557, 587-595).

    Keys are written at ``position % ring``. For a query at absolute
    position q, slot j holds position ``q - d``, ``d = (q - j) mod ring``;
    the slot is valid iff ``d < window`` (inside the window) and ``d <= q``
    (written). With ``ring >= 2 * window`` and prefill chunks of at most
    ``window`` tokens, same-chunk future keys wrap to ``d >= window``, so
    the one formula covers chunked prefill and decode. It encodes the causal
    mask too: it replaces the causal bias, never adds to it. The slot of
    d == 0 is the query's own: decode-step callers attend the fresh token
    separately and exclude that stale slot themselves."""
    q = _query_positions(num_queries, offset, device)
    j = torch.arange(ring, device=q.device)
    d = torch.remainder(q - j, ring)
    return _bias_rows((d < window) & (d <= q))


def combine_bias(*biases):
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out


# ---------------------------------------------------------------------------
# Relative position representations.
# ---------------------------------------------------------------------------

def make_relative_positions(num_queries: int, num_keys: int, max_position: int,
                            asymmetric: bool = False, left_max: int = 0,
                            right_max: int = 0, query_offset=None, device=None):
    """Clipped relative-position index matrix [Tq, Tk], int32
    (reference: src/layers/attention.cc:16-49); [B, Tq, Tk] for a per-row
    ``query_offset``. ``query_offset`` is the absolute position of query 0;
    None right-aligns the queries with the keys (offset Tk - Tq), the
    full-sequence convention."""
    if not asymmetric and per_row(query_offset):
        q_pos = _query_positions(num_queries, query_offset, device)
        j = torch.arange(num_keys, device=q_pos.device)
        rel = torch.clamp(j - q_pos, -max_position, max_position) + max_position
        return rel.to(torch.int32)
    i = torch.arange(num_queries, device=device)[:, None]
    j = torch.arange(num_keys, device=device)[None, :]
    if asymmetric:
        rel = torch.clamp(j - i, -left_max, right_max) + left_max
    else:
        offset = (num_keys - num_queries) if query_offset is None else query_offset
        rel = torch.clamp(j - (i + offset), -max_position, max_position) + max_position
    return rel.to(torch.int32)


def t5_position_bias(rel_attention_bias, num_queries: int, num_keys: int,
                     max_distance: int, bidirectional: bool, query_offset=0):
    """[H, Tq, Tk] float32 additive bias from the learned [num_buckets, H]
    table ([B, H, Tq, Tk] for a per-row ``query_offset``); the buckets are
    the flash kernel's plain version's."""
    device = rel_attention_bias.device
    i = _query_positions(num_queries, query_offset, device)
    j = torch.arange(num_keys, device=device)
    buckets = relative_position_bucket(
        j - i, rel_attention_bias.shape[0], max_distance, bidirectional)
    values = rel_attention_bias[buckets.long()]  # [(B,) Tq, Tk, H]
    if values.dim() == 4:
        return values.permute(0, 3, 1, 2).float()
    return values.permute(2, 0, 1).float()


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
    return_weights=False,  # False | True (the softmax) | "logits"
    rel_position_keys=None,  # [2P+1, D] Shaw tables (float32)
    rel_position_values=None,
    rel_positions=None,  # [Tq, Tk] ([B, Tq, Tk] per row) indices into the tables
):
    """The attention output [B, Hq, Tq, D]; with ``return_weights``, also
    the float32 softmax weights [B, Hq, Tq, Tk] (with ``"logits"`` the
    pre-softmax scores, bias added, for consumers that re-normalize after
    removing padding: reference src/models/whisper.cc:520-556). The Shaw tables add
    ``q . rel_keys[rel]`` to the logits and ``weights . rel_values[rel]``
    to the output, in float32 (reference: src/layers/attention.cc:128-165)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv

    qg = q.reshape(B, Hkv, group, Tq, D)
    logits = torch.matmul(qg, k[:, :, None].transpose(-1, -2)).float() * queries_scale
    if rel_position_keys is not None:
        rel_rep = rel_position_keys.float()[rel_positions.long()]  # [(B,) Tq, Tk, D]
        eq = "bhgqd,bqkd->bhgqk" if rel_positions.dim() == 3 else "bhgqd,qkd->bhgqk"
        logits = logits + torch.einsum(eq, qg.float(), rel_rep) * queries_scale
    if bias is not None:
        logits = logits + _group_bias(bias, Hkv, group)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype), v[:, :, None])
    if rel_position_values is not None:
        rel_rep_v = rel_position_values.float()[rel_positions.long()]
        eq = "bhgqk,bqkd->bhgqd" if rel_positions.dim() == 3 else "bhgqk,qkd->bhgqd"
        out = out.float() + torch.einsum(eq, weights.to(v.dtype).float(), rel_rep_v)
    out = out.reshape(B, Hq, Tq, D).to(q.dtype)
    if return_weights == "logits":
        return out, logits.reshape(B, Hq, Tq, -1)
    if return_weights:
        return out, weights.reshape(B, Hq, Tq, -1)
    return out


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
    alibi_bias=None,  # [Hq, 1, C]
    k_new=None,  # [N, Hkv, 1, D]: this step's fresh key (pre-append)
    v_new=None,
    fresh_bias=None,  # additive for the fresh token, broadcastable [1, 1, Hkv, G, 1]
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
    if alibi_bias is not None:
        logits = logits + alibi_bias.float().reshape(1, 1, Hkv, group, Tq, 1, C)

    flat = logits.reshape(B, K, Hkv, group, Tq, K * C)
    if k_new is not None:
        # Fresh token attends through its own row (kept out of the cache so
        # the append can come after the attention).
        lf = torch.einsum("bkhgqd,bkhd->bkhgq", qg,
                          k_new.reshape(B, K, Hkv, D)).float() * queries_scale
        if fresh_bias is not None:
            lf = lf + fresh_bias
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
    pos,  # slot the fresh token occupies: an int, or int [B] per row
    *,
    queries_scale: float = 1.0,
    bias=None,  # additive over cache slots, broadcastable [.., 1, C]
    alibi_bias=None,  # [Hq, Tq, C] shared or [B, Hq, Tq, C] per row
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

    slots = torch.arange(C, device=q.device)
    if per_row(pos):
        excl = torch.where(slots[None, :] == pos[:, None], -1e30, 0.0).reshape(
            B, 1, 1, 1, C)
    else:
        excl = torch.where(slots == pos, -1e30, 0.0)
    lc = lc + excl.to(torch.float32)
    if bias is not None:
        lc = lc + _group_bias(bias, Hkv, group)
    if alibi_bias is not None:
        ab = alibi_bias.float()
        if ab.dim() == 3:
            ab = ab[None]
        lc = lc + ab.reshape(ab.shape[0], Hkv, group, Tq, C)
        # The fresh token sits at slot ``pos``: its column of the bias.
        if per_row(pos):
            col = ab.expand(B, Hq, Tq, C).gather(
                -1, pos.long().reshape(B, 1, 1, 1).expand(B, Hq, Tq, 1))[..., 0]
            lf = lf + col.reshape(B, Hkv, group, Tq)
        else:
            lf = lf + ab[..., pos].reshape(ab.shape[0], Hkv, group, Tq)

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
    pos,  # number of valid cached slots (< pos): an int, or int [B] per row
    *,
    queries_scale: float = 1.0,
    chunk: int = 128,
    pos_bound: int = None,
):
    """``decode_step_attention`` that only READS the written cache prefix:
    an online-softmax loop over ``ceil(pos/chunk)`` chunks, so per-step
    traffic scales with the actual length.

    With per-row ``pos`` each row is masked at its own length and the loop
    walks to ``pos_bound``, a bound of ``max(pos)`` known on the host (the
    whole capacity when None): the loop's trip count never reads the
    device, so a decode step does not wait for the card."""
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

    rows = per_row(pos)
    end = min(C if pos_bound is None else pos_bound, C) if rows else pos
    for start in range(0, end, chunk):
        kc = k_pre[:, :, start:start + chunk]
        vc = v_pre[:, :, start:start + chunk]
        s = torch.einsum("bhgd,bhcd->bhgc", qg, kc).float() * queries_scale
        cols = start + torch.arange(kc.shape[2], device=q.device)
        if rows:
            valid = (cols[None, :] < pos[:, None])[:, None, None, :]
        else:
            valid = (cols < pos)[None, None, None, :]
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgc,bhcd->bhgd", p.to(vc.dtype), vc).float()
        m = m_new
    ctx = acc / l[..., None]
    return ctx.reshape(B, Hq, Tq, D).to(q.dtype)
