"""Token selection for the decode loops.

Port of ``ctranslate2_tpu/decoding/sampling.py``: argmax, and random
sampling in the reference RandomSampler's order (reference:
src/sampling.cc:35-101): top-k restriction, temperature, top-p (nucleus)
mask, Gumbel-max draw, and the pick's score from the unmodified
distribution; ``sample_tokens_per_row``, the continuous batcher's sampler,
with every row's own top-k, top-p, temperature and noise; and the beam
draws without replacement, ``gumbel_top_k`` and ``gumbel_top_k_per_row``
(the latter beam serving's candidate draw).

The samplers take their Gumbel noise as an argument. The decode loops get
it from a noise source, ``noise(step, shape, device)``, which
``noise_source`` makes for one call from its seed: one explicit
``torch.Generator`` on the device, never the global one, so two calls with
one seed draw the same tokens. The JAX package draws from
``fold_in(PRNGKey(seed), step)`` instead; fed the same noise, the two
sample the same tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from .processors import DISABLE

# Above this k an exact top-k is a stable sort (the JAX package's
# ``lax.top_k``), below it k argmax passes.
SMALL_TOP_K_MAX = 16
# jax.random.uniform's minval in the JAX package's Gumbel draw.
UNIFORM_MIN = 1e-20


def small_top_k(x, k: int):
    """Exact top-k along the last axis.

    Returns (values [..., k], indices [..., k]) in descending order. Among
    equal values the lowest index comes first, as in the JAX package's
    block tournament and ``lax.top_k`` (``torch.argmax`` returns the first
    maximal index and the sort is stable; ``torch.topk`` guarantees no tie
    order).
    """
    shape = x.shape
    V = shape[-1]
    if k > SMALL_TOP_K_MAX:
        vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idxs[..., :k]
    work = x.reshape(-1, V)
    cols = torch.arange(V, device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(work, dim=-1)
        vals.append(work.gather(1, idx[:, None])[:, 0])
        idxs.append(idx)
        work = torch.where(cols[None, :] == idx[:, None], DISABLE, work)
    return (torch.stack(vals, -1).reshape(*shape[:-1], k),
            torch.stack(idxs, -1).reshape(*shape[:-1], k))


def greedy_tokens(log_probs):
    """Returns (ids, scores): the argmax over the last axis of ``log_probs``
    ([N, V] or [N, K, V]) and its log-prob."""
    ids = torch.argmax(log_probs, dim=-1)
    return ids, log_probs.gather(-1, ids[..., None])[..., 0]


def _divide(scores, temperature: float):
    # Two tensors: a true division, as the JAX package divides (a Python
    # scalar divisor is multiplied by its reciprocal on the card); filled
    # on the device, since a copy from the host would sync every step.
    return scores / torch.full_like(scores, temperature)


def top_p_mask(scores, p: float):
    """Mask scores outside the nucleus of cumulative probability ``p``:
    keep the smallest set of highest-probability tokens whose cumulative
    probability reaches ``p``; the first token is always kept
    (reference: src/ops/topp_mask.cc)."""
    sorted_scores = torch.sort(scores, dim=-1, descending=True).values
    probs = torch.softmax(sorted_scores, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Exclusive cumulative sum: a token is kept while the mass before it < p.
    num_keep = ((cum - probs) < p).sum(dim=-1, keepdim=True)
    threshold = sorted_scores.gather(-1, num_keep - 1)
    return torch.where(scores >= threshold, scores, DISABLE)


def sample_noise_shape(rows: int, vocab: int, topk: int):
    """The shape of the noise ``sample_tokens`` takes: [rows, topk] under a
    top-k restriction, else [rows, vocab]."""
    return (rows, topk if 0 < topk < vocab else vocab)


def sample_tokens(log_probs, noise, *, topk: int = 1, topp: float = 1.0,
                  temperature: float = 1.0):
    """One random draw a row: ``log_probs`` [N, V] log-softmaxed scores,
    ``noise`` Gumbel noise of ``sample_noise_shape(N, V, topk)``. Returns
    (ids [N], scores [N]), the scores the picks' log-probs."""
    V = log_probs.shape[-1]
    scores = log_probs
    top_ids = None
    if 0 < topk < V:
        scores, top_ids = small_top_k(scores, topk)
    if temperature != 1.0:
        scores = _divide(scores, temperature)
    if topp < 1.0:
        scores = top_p_mask(scores, topp)
    # jax.random.categorical: the argmax of the scores plus Gumbel noise.
    sampled = torch.argmax(scores + noise, dim=-1)
    ids = sampled if top_ids is None else top_ids.gather(1, sampled[:, None])[:, 0]
    return ids, log_probs.gather(1, ids[:, None])[:, 0]


def sample_tokens_per_row(log_probs, noise, *, topks, topps, temps,
                          max_topk: int):
    """The continuous batcher's sampler: every row carries its own options
    (the reference's per-call options through the buffered wrapper,
    include/ctranslate2/translation.h:11-86). ``log_probs`` [S, V]
    log-softmaxed scores; ``topks`` int [S] (0 the whole vocabulary, 1 the
    argmax, k a top-k restriction, k <= ``max_topk``); ``topps`` float [S]
    (1.0 off); ``temps`` float [S]; ``noise`` [S, V] Gumbel noise, one
    field a row. Rows with topk 1 take the argmax. Returns (ids [S],
    scores [S]), the scores the picks' log-probs.

    The order of operations is the JAX package's (temperature, the k-th
    value's threshold, the nucleus, the Gumbel-max draw): fed the same
    noise, both draw the same tokens. The JAX package draws each row's
    field from ``fold_in(key, seed)``; the batcher gives each slot a
    ``torch.Generator`` of its own (``slot_noise``)."""
    S, V = log_probs.shape
    greedy_rows = topks == 1
    work = log_probs / torch.clamp(temps, min=1e-6)[:, None]
    if max_topk > 0:
        vals, _ = small_top_k(work, min(max_topk, V))  # descending
        kth = vals.gather(1, (topks.long() - 1).clamp(0, vals.shape[1] - 1)[:, None])
        use_topk = ((topks > 1) & (topks < V))[:, None]
        work = torch.where(use_topk & (work < kth), DISABLE, work)
    masked = top_p_mask(work, torch.clamp(topps, max=1.0)[:, None])
    work = torch.where((topps < 1.0)[:, None], masked, work)
    sampled = torch.argmax(work + noise, dim=-1)
    ids = torch.where(greedy_rows, torch.argmax(log_probs, dim=-1), sampled)
    return ids, log_probs.gather(1, ids[:, None])[:, 0]


def gumbel_top_k_per_row(flat_scores, noise, k: int, *, topks, topps, temps,
                         max_topk: int):
    """Beam serving's candidate draw: ``k`` draws without replacement a row
    (the reference's RandomSampler composed with beam search,
    src/sampling.cc:60-92), every row with its own options.
    ``flat_scores`` [S, W] (a slot's K beams' running scores over the
    vocabulary, flattened); ``noise`` [S, W] Gumbel noise; ``topks``,
    ``topps``, ``temps`` as in ``sample_tokens_per_row``. Rows with topk 1
    take the deterministic top-k picks and read no noise (a row of zeros
    will do). Returns (scores [S, k], indices [S, k]), the scores from the
    unperturbed ``flat_scores``.

    The batcher draws each sampled slot's [W] noise from the slot's own
    ``torch.Generator`` (``slot_noise``); the JAX package draws row s's from
    ``fold_in(fold_in(key, step), seed_s)``. Fed the same noise, both pick
    the same candidates."""
    W = flat_scores.shape[-1]
    greedy_rows = topks == 1
    work = flat_scores / torch.clamp(temps, min=1e-6)[:, None]
    if max_topk > 0:
        vals, _ = small_top_k(work, min(max_topk, W))  # descending
        kth = vals.gather(1, (topks.long() - 1).clamp(0, vals.shape[1] - 1)[:, None])
        use_topk = ((topks > 1) & (topks < W))[:, None]
        work = torch.where(use_topk & (work < kth), DISABLE, work)
    masked = top_p_mask(work, torch.clamp(topps, max=1.0)[:, None])
    work = torch.where((topps < 1.0)[:, None], masked, work)
    noisy = torch.where(work <= DISABLE / 2, DISABLE, work + noise)
    det_i = small_top_k(flat_scores, k)[1]
    smp_i = small_top_k(noisy, k)[1]
    idx = torch.where(greedy_rows[:, None], det_i, smp_i)
    return flat_scores.gather(-1, idx), idx


def gumbel_top_k(flat_scores, uniform, k: int, *, topk: int = 0, topp: float = 1.0,
                 temperature: float = 1.0):
    """``k`` draws without replacement by the Gumbel-max trick (reference:
    src/ops/gumbel_max.cc, which RandomSampler uses when it draws more than
    one sample, src/sampling.cc:60-92). ``uniform`` is a uniform draw in
    [1e-20, 1) of ``flat_scores``' shape (the JAX package's
    ``jax.random.uniform(key, shape, minval=1e-20)``). Returns (scores,
    indices), the scores from the unperturbed ``flat_scores``."""
    work = flat_scores
    if topk and topk < work.shape[-1]:
        kth = small_top_k(work, topk)[0][..., -1:]
        work = torch.where(work >= kth, work, DISABLE)
    if temperature != 1.0:
        work = _divide(work, temperature)
    if topp < 1.0:
        work = top_p_mask(work, topp)
    gumbel = -torch.log(-torch.log(uniform))
    noisy = torch.where(work <= DISABLE / 2, DISABLE, work + gumbel)
    idx = small_top_k(noisy, k)[1]
    return flat_scores.gather(-1, idx), idx


def slot_noise(generators, vocab: int, device):
    """[S, V] Gumbel noise for the batcher's slots: row s drawn from
    ``generators[s]``, or zeros where it is None (a slot that does not
    sample)."""
    rows = [draw_gumbel(g, (1, vocab), device) if g is not None
            else torch.zeros((1, vocab), dtype=torch.float32, device=device)
            for g in generators]
    return torch.cat(rows)


def draw_gumbel(generator: torch.Generator, shape, device):
    """Standard Gumbel noise of ``shape`` in float32 on ``device``, drawn
    from ``generator`` (which lives on that device): -log(-log(u)) of u
    uniform in [1e-20, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_min_(UNIFORM_MIN)
    return -torch.log(-torch.log(u))


def noise_source(seed: int, device):
    """One call's noise: a function (step, shape, device) -> Gumbel noise,
    drawn in step order from one ``torch.Generator`` on ``device`` seeded
    with ``seed``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))

    def noise(step: int, shape, device):
        return draw_gumbel(generator, shape, device)

    return noise


def truncated_probabilities(log_probs, topk: int, topp: float, temperature: float):
    """The distribution ``sample_tokens`` draws from for one row of
    ``log_probs``, in float64 numpy: the top-k words, tempered, renormalized,
    cut to the nucleus and renormalized again (the plain reference that
    frequency checks hold the sampler's draws to)."""
    p = np.exp(np.asarray(log_probs, np.float64))
    order = np.argsort(-p, kind="stable")
    keep = order[:topk] if topk else order
    w = np.exp(np.log(p[keep]) / temperature)
    w /= w.sum()
    nucleus = keep[(np.cumsum(w) - w) < topp]
    w = np.exp(np.log(p[nucleus]) / temperature)
    out = np.zeros_like(p)
    out[nucleus] = w / w.sum()
    return out
