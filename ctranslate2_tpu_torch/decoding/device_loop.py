"""Whole-generation decode loops whose state stays on the device.

Port of ``ctranslate2_tpu/decoding/device_loop.py``. The JAX package runs
each loop as one ``lax.while_loop``; here it is a Python loop over steps
whose every tensor stays on the model's device, so the host only issues
kernels. The loop checks on the host whether any batch is still active
once every ``SYNC_EVERY`` steps (one device sync each): the extra steps a
finished batch may run harvest nothing, because every store update is
masked by ``batch_active``, so the result equals checking every step.
"""

from __future__ import annotations

import os

import torch

from ..models import transformer as T
from ..ops import attention as attn_ops
from . import processors as proc
from .sampling import greedy_tokens, small_top_k

SYNC_EVERY = 8
NEG = -1e10


def use_beam_chain(arch, beam_size: int) -> bool:
    """Chain-mask beam attention (no physical cache reorder) applies to a
    float per-layer cache without relative biases; CT2TPU_BEAM_CHAIN=0
    turns it off, and the loop then reorders the cache with the fused
    gather kernel each step."""
    return (beam_size > 1
            and os.environ.get("CT2TPU_BEAM_CHAIN", "1") != "0"
            and not any(
                l.self_attention.has_rel_position_keys
                or l.self_attention.has_rel_attention_bias
                or l.self_attention.has_rel_asymmetric_keys
                or l.self_attention.has_memory_kv
                for l in arch.decoder.layers))


def _apply_processors(sig, l, step: int, min_steps_rows, alive_flat):
    l = proc.disable_tokens(l, sig.suppress_ids)
    if sig.begin_suppress_ids and step == 0:
        l = proc.disable_tokens(l, sig.begin_suppress_ids)
    if sig.end_ids:
        l = proc.disable_tokens_if(l, sig.end_ids, step < min_steps_rows)
    if sig.use_alive_seq:
        if sig.repetition_penalty != 1.0:
            l = proc.repetition_penalty(l, alive_flat, step, sig.repetition_penalty)
        if sig.no_repeat_ngram_size > 0:
            l = proc.no_repeat_ngram(l, alive_flat, step, sig.no_repeat_ngram_size)
        if sig.suppress_sequences:
            l = proc.suppress_sequences_mask(l, alive_flat, step, sig.suppress_sequences)
    return l


def _encode(model, params, consts, encoder_ids, encoder_lengths):
    """Fused encode + cross-KV projection for one request."""
    qa = model.policy.quantize_activations
    memory = T.encoder_forward(model.arch, params, consts, encoder_ids,
                               encoder_lengths, quantize_acts=qa,
                               out_dtype=model.out_dtype)
    mem_kv = T.precompute_memory(model.arch, params, memory, quantize_acts=qa)
    mem_bias = attn_ops.length_mask_bias(encoder_lengths, memory.shape[1])
    return mem_kv, mem_bias


def beam_loop(model, params, consts, sig, *, max_steps: int, capacity: int,
              beam_size: int, num_hyp: int, max_candidates: int,
              length_penalty: float, return_prefix: bool, include_eos: bool,
              count_eos: bool, max_length: int, allow_early_exit: bool,
              has_prefix: bool, control, start_pos: int,
              encoder_ids, encoder_lengths):
    """Whole-generation beam search with the reference's candidate
    bookkeeping (2*beam candidates, EOS harvesting with secondary
    promotion, hard-prefix override — reference: src/decoding.cc:411-720).
    Hypotheses land in a fixed [B, num_hyp] best-score store.

    ``control`` [B, 3 + K + P]: prefix_len | min_steps | pad | start tokens
    (per beam) | prefix rows. Returns the store as host tensors
    (seqs [B, M, L], lens [B, M], scores [B, M]).
    """
    device = model.device
    arch = model.arch
    K = beam_size
    K2 = 2 * K
    M = num_hyp
    L = max_steps
    end_ids = torch.as_tensor(sig.end_ids or (0,), dtype=torch.long, device=device)
    has_end = bool(sig.end_ids)

    def is_end(tok):
        if not has_end:
            return torch.zeros(tok.shape, dtype=torch.bool, device=device)
        return (tok[..., None] == end_ids).any(dim=-1)

    control = control.to(device)
    prefix_len = control[:, 0]
    min_steps = control[:, 1]
    tokens = control[:, 3:3 + K].reshape(-1)
    prefix = control[:, 3 + K:]
    B = control.shape[0]
    N = B * K
    P = prefix.shape[1]
    use_chain = use_beam_chain(arch, K)

    mem_kv, mem_bias = _encode(model, params, consts, encoder_ids, encoder_lengths)
    cache = T.init_self_cache(arch, N, capacity, dtype=model.kv_dtype, device=device)

    rows_b = torch.arange(B, device=device)
    alive = torch.zeros((B, K, L), dtype=torch.long, device=device)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    chain = None
    if use_chain:
        # Prefix slots (< start_pos) hold beam-identical rows: "self" is a
        # correct owner; future slots are -1 (which also subsumes the causal
        # mask for single-token decode).
        self_ids = torch.arange(K, device=device).repeat(B)
        cpos = torch.arange(capacity, device=device)[None, :]
        chain = torch.where(cpos < start_pos, self_ids[:, None], -1)
    store_seqs = torch.zeros((B, M, L), dtype=torch.long, device=device)
    store_lens = torch.zeros((B, M), dtype=torch.long, device=device)
    store_scores = torch.full((B, M), float("-inf"), dtype=torch.float32, device=device)
    store_count = torch.zeros(B, dtype=torch.long, device=device)
    top_beam_finished = torch.zeros(B, dtype=torch.bool, device=device)
    batch_active = torch.ones(B, dtype=torch.bool, device=device)

    zeros_b = torch.zeros(B, dtype=torch.long, device=device)
    plen_off = prefix_len if (has_prefix and not return_prefix) else zeros_b
    last_step_of = max_length + plen_off
    start_off = plen_off if not return_prefix else zeros_b
    min_rows = min_steps.repeat_interleave(K)
    cand_idx = torch.arange(K2, device=device)[None, :]
    slots = torch.arange(M, device=device)[None, :]

    for step in range(max_steps):
        if step and step % SYNC_EVERY == 0 and not bool(batch_active.any()):
            break
        logits, cache = T.decoder_forward(
            arch, params, consts, tokens[:, None], start_pos + step, cache,
            mem_kv, mem_bias, beam_size=K,
            quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype, beam_chain=chain)
        l = logits[:, -1].float()  # [N, V]
        V = l.shape[-1]
        l = _apply_processors(sig, l, step, min_rows, alive.reshape(N, L))

        log_probs = torch.log_softmax(l, dim=-1)
        total = log_probs + scores.reshape(N)[:, None]
        ts, ti = small_top_k(total.reshape(B, K * V), K2)  # [B, 2K]
        words = ti % V
        origins = ti // V

        if has_prefix:
            forced = (step < prefix_len)[:, None]
            ptok = prefix[:, min(step, P - 1)][:, None]
            words = torch.where(forced, ptok, words)
            ts = torch.where(forced, torch.where(cand_idx == 0, 0.0, NEG), ts)
            origins = torch.where(forced, 0, origins)
            # Penalize EOS in secondary candidates at the first free step
            # (reference: src/decoding.cc:50-57).
            boundary = (step == prefix_len)[:, None]
            eos_k = is_end(words) & (cand_idx > 0) & boundary
            words = torch.where(eos_k, 0, words)
            ts = torch.where(eos_k, NEG, ts)

        is_eos_cand = is_end(words)  # [B, 2K]
        past_prefix = (step >= prefix_len)[:, None] if has_prefix else True
        last_step_b = (step + 1) == last_step_of  # [B]

        # ---- harvest finished hypotheses among the first K candidates ----
        finish_k = batch_active[:, None] & (
            (is_eos_cand[:, :K] & past_prefix) | last_step_b[:, None])
        top_beam_finished = top_beam_finished | finish_k[:, 0]

        for k in range(K):
            seq = alive[rows_b, origins[:, k]]  # [B, L], a copy
            seq[:, step] = words[:, k]
            eos = is_eos_cand[:, k]
            hyp_len = torch.where(eos & (not include_eos), step, step + 1)
            score_len = torch.where(eos & (not count_eos), step, step + 1)
            norm_len = (score_len - start_off).clamp(min=1).float()
            norm_score = ts[:, k] / torch.pow(norm_len, length_penalty)

            slot = torch.argmin(store_scores, dim=1)  # [B]
            cur_min = store_scores[rows_b, slot]
            do = finish_k[:, k] & (norm_score > cur_min)
            sel = (slots == slot[:, None]) & do[:, None]  # [B, M]
            store_scores = torch.where(sel, norm_score[:, None], store_scores)
            store_lens = torch.where(sel, hyp_len[:, None], store_lens)
            store_seqs = torch.where(sel[:, :, None], seq[:, None, :], store_seqs)
            store_count = store_count + finish_k[:, k].long()

        # ---- batch finish conditions ----
        if allow_early_exit:
            finished_b = top_beam_finished & (store_count >= num_hyp)
        else:
            finished_b = store_count >= max_candidates
        batch_active = batch_active & ~(finished_b | last_step_b)

        # ---- select the next K active beams (non-EOS first, stable) ----
        order = torch.sort(is_eos_cand.int(), dim=1, stable=True).indices[:, :K]
        new_words = words.gather(1, order)
        scores = ts.gather(1, order)
        new_origins = origins.gather(1, order)

        rows = (rows_b[:, None] * K + new_origins).reshape(N)
        if use_chain:
            chain = chain[rows]
            # Record who wrote slot `step`: the origin beam's row.
            chain[:, start_pos + step] = new_origins.reshape(N)
        else:
            cache = T.cache_gather_rows(cache, rows.to(torch.int32))
        alive = alive.gather(1, new_origins[:, :, None].expand(B, K, L))
        alive[:, :, step] = new_words
        tokens = new_words.reshape(N)

    return store_seqs.cpu(), store_lens.cpu(), store_scores.cpu()


def greedy_loop(model, params, consts, sig, *, max_steps: int, capacity: int,
                has_prefix: bool, control, start_pos: int,
                encoder_ids, encoder_lengths):
    """Whole-generation greedy loop (argmax; random sampling is not ported
    yet). ``control`` [N, 3 + P]: prefix_len | min_steps | start_token |
    prefix. Returns host tensors (tokens [N, max_steps], num_steps [N],
    scores [N])."""
    device = model.device
    arch = model.arch
    end_ids = torch.as_tensor(sig.end_ids or (0,), dtype=torch.long, device=device)
    has_end = bool(sig.end_ids)

    control = control.to(device)
    prefix_len = control[:, 0]
    min_steps = control[:, 1]
    tokens = control[:, 2]
    prefix = control[:, 3:]
    N = control.shape[0]
    P = prefix.shape[1] if has_prefix else 0

    mem_kv, mem_bias = _encode(model, params, consts, encoder_ids, encoder_lengths)
    cache = T.init_self_cache(arch, N, capacity, dtype=model.kv_dtype, device=device)

    out_buf = torch.zeros((N, max_steps), dtype=torch.long, device=device)
    scores = torch.zeros(N, dtype=torch.float32, device=device)
    finished = torch.zeros(N, dtype=torch.bool, device=device)
    num_steps = torch.zeros(N, dtype=torch.long, device=device)

    for step in range(max_steps):
        if step and step % SYNC_EVERY == 0 and bool(finished.all()):
            break
        logits, cache = T.decoder_forward(
            arch, params, consts, tokens[:, None], start_pos + step, cache,
            mem_kv, mem_bias, beam_size=1,
            quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype)
        l = logits[:, -1].float()
        l = _apply_processors(sig, l, step, min_steps, out_buf)
        log_probs = torch.log_softmax(l, dim=-1)
        sampled, sampled_scores = greedy_tokens(log_probs)

        if P > 0:
            forced = step < prefix_len
            new_tok = torch.where(forced, prefix[:, min(step, P - 1)], sampled)
            step_score = torch.where(forced, 0.0, sampled_scores)
        else:
            forced = torch.zeros(N, dtype=torch.bool, device=device)
            new_tok = sampled
            step_score = sampled_scores

        scores = scores + torch.where(finished, 0.0, step_score)
        out_buf[:, step] = torch.where(finished, out_buf[:, step], new_tok)
        is_eos = (new_tok[:, None] == end_ids[None, :]).any(dim=-1) if has_end \
            else torch.zeros(N, dtype=torch.bool, device=device)
        newly_finished = ~finished & is_eos & ~forced
        num_steps = torch.where(finished, num_steps, step + 1)
        finished = finished | newly_finished
        tokens = new_tok

    return out_buf.cpu(), num_steps.cpu(), scores.cpu()
