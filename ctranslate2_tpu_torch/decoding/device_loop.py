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
from . import processors as proc
from .sampling import greedy_tokens, sample_noise_shape, sample_tokens, small_top_k

SYNC_EVERY = 8
NEG = -1e10


def use_beam_chain(arch, beam_size: int, kv_dtype, prefilled: bool) -> bool:
    """Chain-mask beam attention (no physical cache reorder) applies to a
    float per-layer cache that the loop creates itself, without relative
    biases; CT2TPU_BEAM_CHAIN=0 turns it off. Otherwise (and with a
    prefilled or int8 cache) the loop reorders the cache with the fused
    gather kernel each step."""
    return (beam_size > 1
            and os.environ.get("CT2TPU_BEAM_CHAIN", "1") != "0"
            and not prefilled and kv_dtype != torch.int8
            and not any(
                l.self_attention.has_rel_position_keys
                or l.self_attention.has_rel_attention_bias
                or l.self_attention.has_rel_asymmetric_keys
                or l.self_attention.has_memory_kv
                for l in arch.decoder.layers))


def _self_cache(model, cache, rows: int, capacity: int, ring: bool = False):
    """The loop's self-attention cache: a new one (with ``ring``, windowed
    layers get ring buffers, as greedy search makes them), or the caller's
    prefilled one, which must already have ``rows`` rows and ``capacity``
    slots (a ring layer its ring's)."""
    if cache is None:
        return T.init_self_cache(model.arch, rows, capacity,
                                 dtype=model.kv_dtype, device=model.device, ring=ring)
    rc = T.ring_capacity(model.arch)
    for layer in cache:
        shape = tuple(layer["k"].shape)
        if shape[0] != rows or shape[2] not in (capacity, rc):
            raise ValueError(f"the prefilled cache has {shape[0]} rows of "
                             f"{shape[2]} slots; the loop needs {rows} of {capacity}")
    return cache


def apply_processors(sig, l, step: int, disable_end, alive_flat, sample_begin=None):
    """The logits processors of one step: ``l`` [N, V] float32,
    ``disable_end`` bool [N] (the rows whose end tokens are off this step),
    ``alive_flat`` [N, L] the tokens generated so far, ``sample_begin``
    [N] the forced prefix steps of each row for Whisper's timestamp rules
    (zeros when None)."""
    l = proc.disable_tokens(l, sig.suppress_ids)
    if sig.begin_suppress_ids and step == 0:
        l = proc.disable_tokens(l, sig.begin_suppress_ids)
    if sig.end_ids:
        l = proc.disable_tokens_if(l, sig.end_ids, disable_end)
    if sig.use_alive_seq:
        if sig.repetition_penalty != 1.0:
            l = proc.repetition_penalty(l, alive_flat, step, sig.repetition_penalty)
        if sig.no_repeat_ngram_size > 0:
            l = proc.no_repeat_ngram(l, alive_flat, step, sig.no_repeat_ngram_size)
        if sig.suppress_sequences:
            l = proc.suppress_sequences_mask(l, alive_flat, step, sig.suppress_sequences)
        if sig.whisper_ts is not None:
            if sample_begin is None:
                sample_begin = torch.zeros(l.shape[0], dtype=torch.long, device=l.device)
            l = proc.whisper_timestamp_rules(l, alive_flat, step, sample_begin,
                                             *sig.whisper_ts)
    return l


def beam_loop(model, params, consts, sig, *, max_steps: int, capacity: int,
              beam_size: int, num_hyp: int, max_candidates: int,
              length_penalty: float, return_prefix: bool, include_eos: bool,
              count_eos: bool, max_length: int, allow_early_exit: bool,
              has_prefix: bool, control, start_pos: int,
              memory=(None, None), cache=None, token_map=None):
    """Whole-generation beam search with the reference's candidate
    bookkeeping (2*beam candidates, EOS harvesting with secondary
    promotion, hard-prefix override — reference: src/decoding.cc:411-720).
    Hypotheses land in a fixed [B, num_hyp] best-score store.

    ``control`` [B, 3 + K + P]: prefix_len | min_steps | pad | start tokens
    (per beam) | prefix rows. ``memory`` is the encoder's (mem_kv,
    mem_bias), or (None, None) for a decoder-only model. ``cache`` is a
    prefilled self-attention cache of B*beam rows (a decoder-only prompt),
    or None to start an empty one. ``token_map`` (long [V']) maps the ids of
    a vocabulary-restricted projection to the embedding's (``use_vmap``):
    each step feeds ``token_map[tokens]``. Returns the store as host tensors
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
    use_chain = use_beam_chain(arch, K, model.kv_dtype, cache is not None)

    mem_kv, mem_bias = memory
    cache = _self_cache(model, cache, N, capacity)
    if token_map is not None:
        token_map = token_map.to(device)

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
    plen_rows = prefix_len.repeat_interleave(K)  # Whisper's sample_begin
    cand_idx = torch.arange(K2, device=device)[None, :]
    slots = torch.arange(M, device=device)[None, :]

    for step in range(max_steps):
        if step and step % SYNC_EVERY == 0 and not bool(batch_active.any()):
            break
        fed = tokens if token_map is None else token_map[tokens]
        logits, cache = T.decoder_forward(
            arch, params, consts, fed[:, None], start_pos + step, cache,
            mem_kv, mem_bias, beam_size=K,
            quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype, beam_chain=chain)
        l = logits[:, -1].float()  # [N, V]
        V = l.shape[-1]
        l = apply_processors(sig, l, step, step < min_rows, alive.reshape(N, L),
                             sample_begin=plen_rows)

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
                memory=(None, None), cache=None, noise=None, token_map=None):
    """Whole-generation greedy loop: the argmax, or under a random sampler
    one draw a row and step with ``noise(step, shape, device)``
    (``sampling.noise_source``). ``control`` [N, 3 + P]: prefix_len |
    min_steps | start_token | prefix. ``cache`` is a prefilled
    self-attention cache holding positions [0, start_pos), or None to start
    an empty one; ``memory`` and ``token_map`` as in ``beam_loop``. Returns
    host tensors (tokens [N, max_steps], num_steps [N], scores [N])."""
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

    mem_kv, mem_bias = memory
    # Greedy search decodes one token at a time: windowed layers take
    # O(window) ring buffers (chain-mask beam attention cannot).
    cache = _self_cache(model, cache, N, capacity, ring=True)
    if token_map is not None:
        token_map = token_map.to(device)

    out_buf = torch.zeros((N, max_steps), dtype=torch.long, device=device)
    scores = torch.zeros(N, dtype=torch.float32, device=device)
    finished = torch.zeros(N, dtype=torch.bool, device=device)
    num_steps = torch.zeros(N, dtype=torch.long, device=device)

    for step in range(max_steps):
        if step and step % SYNC_EVERY == 0 and bool(finished.all()):
            break
        fed = tokens if token_map is None else token_map[tokens]
        logits, cache = T.decoder_forward(
            arch, params, consts, fed[:, None], start_pos + step, cache,
            mem_kv, mem_bias, beam_size=1,
            quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype)
        l = logits[:, -1].float()
        l = apply_processors(sig, l, step, step < min_steps, out_buf,
                             sample_begin=prefix_len)
        log_probs = torch.log_softmax(l, dim=-1)
        if sig.greedy_sampler:
            sampled, sampled_scores = greedy_tokens(log_probs)
        else:
            shape = sample_noise_shape(N, log_probs.shape[-1], sig.sampling_topk)
            sampled, sampled_scores = sample_tokens(
                log_probs, noise(step, shape, device), topk=sig.sampling_topk,
                topp=sig.sampling_topp, temperature=sig.sampling_temperature)

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


def draft_tokens(K: int, start_tokens, tokens, out_buf, gen, prefix=None,
                 prefix_len=None):
    """[N, K-1] prompt-lookup drafts on the device: the most recent n-gram
    continuation of each row's own context [start token | emitted tokens],
    padded with the row's last token; while a row's forced ``prefix``
    lasts, its prefix tokens themselves, so the forced chunk is accepted
    whole (chunked prefill). ``ContinuousBatcher._draft`` applies the same
    rule on the host, where a request's context lives and its drafts ride
    the dispatch's one upload; a test holds the two to each other. ``tokens`` [N] the last token of each row,
    ``out_buf`` [N, L] the emitted tokens, ``gen`` [N] how many."""
    N = out_buf.shape[0]
    device = out_buf.device
    ctx = torch.cat([start_tokens[:, None], out_buf], dim=1)
    n = gen + 1  # the valid context length
    a_tok = ctx.gather(1, (n - 2).clamp(min=0)[:, None])[:, 0]
    j_idx = torch.arange(ctx.shape[1], device=device)[None, :]
    prev = torch.cat([torch.zeros((N, 1), dtype=ctx.dtype, device=device), ctx[:, :-1]],
                     dim=1)
    match = ((j_idx >= 1) & (j_idx <= (n - 2)[:, None])
             & (ctx == tokens[:, None]) & (prev == a_tok[:, None]) & (n >= 3)[:, None])
    jbest = torch.where(match, j_idx, -1).max(dim=1).values  # [N]
    offs = torch.arange(1, K, device=device)[None, :]  # [1, K-1]
    gpos = jbest[:, None] + offs
    valid = (jbest >= 0)[:, None] & (gpos < n[:, None])
    gathered = ctx.gather(1, gpos.clamp(0, ctx.shape[1] - 1))
    drafts = torch.where(valid, gathered, tokens[:, None])
    if prefix is not None:
        dpos = gen[:, None] + offs  # the generated index each draft lands on
        ptok = prefix.gather(1, dpos.clamp(0, prefix.shape[1] - 1))
        drafts = torch.where(dpos < prefix_len[:, None], ptok, drafts)
    return drafts


def spec_greedy_loop(model, params, consts, sig, *, max_steps: int, capacity: int,
                     spec_k: int, has_prefix: bool, control, start_pos: int,
                     cache=None):
    """Whole-generation greedy loop with lossless self-speculation.

    Each iteration drafts ``spec_k - 1`` tokens a row by prompt lookup on
    the device (``draft_tokens``), verifies them in ONE decoder forward of
    T = ``spec_k`` at per-row positions, and accepts the matched prefix plus
    one bonus token: under the argmax each accepted token is the one the
    sequential loop emits, while the verify's linears see M = N x spec_k
    rows. Rows advance by different amounts, so the loop carries per-row
    positions ``pos`` [N]; a rejected draft's cache write lies past its
    row's position, masked by the per-row causal bias and overwritten by
    a later verify. Every write is clamped to ``capacity - spec_k``: only
    a finished row reaches past it (the capacity carries a spec_k margin).

    ``control``, ``cache`` and the result as in ``greedy_loop``; the
    forced prefix (the prompt remainder) is drafted and forced, so the
    prompt goes in chunks of ``spec_k`` tokens."""
    device = model.device
    arch = model.arch
    K = spec_k
    L = max_steps
    assert sig.greedy_sampler, "speculation requires greedy decoding"
    assert not sig.use_alive_seq, "speculation takes no alive-seq logits processors"
    end_ids = torch.as_tensor(sig.end_ids or (0,), dtype=torch.long, device=device)
    has_end = bool(sig.end_ids)

    control = control.to(device)
    prefix_len = control[:, 0]
    min_steps = control[:, 1]
    start_tokens = control[:, 2]
    prefix = control[:, 3:] if has_prefix else None
    N = control.shape[0]
    cache = _self_cache(model, cache, N, capacity, ring=True)

    # Column L takes the writes of rejected and finished positions.
    out_buf = torch.zeros((N, L + 1), dtype=torch.long, device=device)
    scores = torch.zeros(N, dtype=torch.float32, device=device)
    finished = torch.zeros(N, dtype=torch.bool, device=device)
    gen = torch.zeros(N, dtype=torch.long, device=device)
    pos = torch.full((N,), start_pos, dtype=torch.long, device=device)
    tokens = start_tokens
    kk = torch.arange(K, device=device)

    for it in range(L):
        if it and it % SYNC_EVERY == 0 and bool(finished.all()):
            break
        drafts = draft_tokens(K, start_tokens, tokens, out_buf[:, :L], gen, prefix,
                              prefix_len)
        fed = torch.cat([tokens[:, None], drafts], dim=1)  # [N, K]
        logits, cache = T.decoder_forward(
            arch, params, consts, fed, pos.clamp(max=capacity - K), cache,
            beam_size=1, quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype)
        l = logits.float()  # [N, K, V]
        gpos = gen[:, None] + kk[None, :]  # [N, K] emit positions
        l = proc.disable_tokens(l, sig.suppress_ids)
        if sig.begin_suppress_ids:
            l = torch.where((gpos == 0)[..., None],
                            proc.disable_tokens(l, sig.begin_suppress_ids), l)
        if has_end:
            end_mask = proc._token_mask(sig.end_ids, l.shape[-1], device)
            l = torch.where((gpos < min_steps[:, None])[..., None] & end_mask,
                            proc.DISABLE, l)
        greedy, picked = greedy_tokens(torch.log_softmax(l, dim=-1))  # [N, K]

        if prefix is not None:
            forced = gpos < prefix_len[:, None]
            ptok = prefix.gather(1, gpos.clamp(0, prefix.shape[1] - 1))
            greedy = torch.where(forced, ptok, greedy)
            picked = torch.where(forced, 0.0, picked)
        else:
            forced = torch.zeros((N, K), dtype=torch.bool, device=device)

        # Accept while each fed draft matched the previous greedy target;
        # stop after an end token or the buffer edge.
        match = fed[:, 1:] == greedy[:, :-1]  # [N, K-1]
        chain_ok = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=device),
                              torch.cumprod(match.long(), dim=1).bool()], dim=1)
        eos = ((greedy[..., None] == end_ids).any(dim=-1) & ~forced) if has_end \
            else torch.zeros((N, K), dtype=torch.bool, device=device)
        eos_before = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=device),
                                torch.cumsum(eos.long(), dim=1)[:, :-1] > 0], dim=1)
        accept = chain_ok & ~eos_before & (gpos < L) & ~finished[:, None]
        counts = accept.sum(dim=1)  # [N]
        out_buf.scatter_(1, torch.where(accept, gpos, L), greedy)
        scores = scores + torch.where(accept, picked, 0.0).sum(dim=1)
        hit_end = (accept & eos).any(dim=1)
        last_tok = greedy.gather(1, (counts - 1).clamp(min=0)[:, None])[:, 0]
        tokens = torch.where(counts > 0, last_tok, tokens)
        pos = pos + counts
        gen = gen + counts
        finished = finished | hit_end | (gen >= L)

    return out_buf[:, :L].cpu(), gen.cpu(), scores.cpu()
