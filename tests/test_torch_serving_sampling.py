"""The continuous batcher's per-row sampler and logits processors against
the JAX package's, on the CPU.

- ``sample_tokens_per_row`` fed the JAX package's Gumbel noise (each row's
  field from ``fold_in(key, seed)``, as the JAX sampler draws it) picks the
  same ids with bit-equal scores, over rows mixing greedy, top-k (below and
  above 16), top-p and temperature;
- ``repetition_penalty_per_row``, ``no_repeat_ngram_per_row`` and
  ``disable_tokens_per_row`` equal the JAX package's on random tables;
- the batcher's per-slot noise (``slot_noise``, one ``torch.Generator`` a
  slot) repeats itself under a seed, and each slot's draws follow its own
  truncated, renormalized distribution (within 5 standard errors a word,
  none outside the support).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctranslate2_tpu.decoding import processors as jp
from ctranslate2_tpu.decoding import sampling as js
from ctranslate2_tpu_torch.decoding import processors as tp
from ctranslate2_tpu_torch.decoding import sampling as ts
from test_torch_cuda import assert_frequencies

MAX_TOPK = 64
# Per row: (topk, topp, temperature, seed).
ROWS = [(1, 1.0, 1.0, 0), (0, 0.9, 0.7, 3), (5, 1.0, 1.3, 4), (40, 0.5, 1.0, 5),
        (1, 0.3, 1.0, 6), (3, 0.8, 2.0, 7), (0, 1.0, 1.0, 8), (64, 1.0, 0.5, 9)]


def _log_probs(rows, vocab, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _options(rows):
    topks, topps, temps, seeds = (np.array(c) for c in zip(*rows))
    return (topks.astype(np.int32), topps.astype(np.float32),
            temps.astype(np.float32), seeds.astype(np.int32))


@pytest.mark.parametrize("vocab", [50, 300])
@pytest.mark.parametrize("step", [0, 1, 2])
def test_sample_tokens_per_row_matches_fed_jax_noise(vocab, step):
    lp = _log_probs(len(ROWS), vocab, seed=10 + step)
    topks, topps, temps, seeds = _options(ROWS)
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    ref_ids, ref_scores = js.sample_tokens_per_row(
        jnp.asarray(lp), key, topks=jnp.asarray(topks), topps=jnp.asarray(topps),
        temps=jnp.asarray(temps), seeds=jnp.asarray(seeds), max_topk=MAX_TOPK)
    # The JAX sampler's own noise: each row's field from fold_in(key, seed).
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, int(s)), (vocab,), jnp.float32)) for s in seeds])
    ids, scores = ts.sample_tokens_per_row(
        torch.from_numpy(lp), torch.from_numpy(noise), topks=torch.from_numpy(topks),
        topps=torch.from_numpy(topps), temps=torch.from_numpy(temps),
        max_topk=MAX_TOPK)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    greedy = topks == 1
    np.testing.assert_array_equal(ids.numpy()[greedy], lp.argmax(-1)[greedy])


def test_repetition_penalty_per_row_matches():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 40)).astype(np.float32)
    seen = rng.random((5, 40)) < 0.3
    pens = np.array([1.0, 1.2, 0.8, 2.0, 1.5], np.float32)
    ref = jp.repetition_penalty_per_row(jnp.asarray(logits), jnp.asarray(seen),
                                        jnp.asarray(pens))
    out = tp.repetition_penalty_per_row(torch.from_numpy(logits),
                                        torch.from_numpy(seen), torch.from_numpy(pens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy()[0], logits[0])


@pytest.mark.parametrize("max_n", [2, 4, 8])
def test_no_repeat_ngram_per_row_matches(max_n):
    rng = np.random.default_rng(max_n)
    N, V, L = 6, 7, 24
    logits = rng.standard_normal((N, V)).astype(np.float32)
    hist = rng.integers(0, 3, (N, L)).astype(np.int32)  # few words: many repeats
    seq_len = np.array([0, 3, 10, 24, 17, 5], np.int32)
    sizes = np.array([2, 0, 3, min(4, max_n), 2, max_n], np.int32)
    ref = jp.no_repeat_ngram_per_row(jnp.asarray(logits), jnp.asarray(hist),
                                     jnp.asarray(seq_len), jnp.asarray(sizes), max_n)
    out = tp.no_repeat_ngram_per_row(torch.from_numpy(logits), torch.from_numpy(hist),
                                     torch.from_numpy(seq_len), torch.from_numpy(sizes),
                                     max_n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() == tp.DISABLE).any()
    # One shared size equals the batch processor's bans.
    shared = np.full(N, 3, np.int32)
    a = tp.no_repeat_ngram_per_row(torch.from_numpy(logits), torch.from_numpy(hist),
                                   torch.from_numpy(seq_len), torch.from_numpy(shared),
                                   max(max_n, 3))
    b = jp.no_repeat_ngram(jnp.asarray(logits), jnp.asarray(hist),
                           jnp.asarray(seq_len), 3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("width", [0, 1, 4])
def test_disable_tokens_per_row_matches(width):
    rng = np.random.default_rng(width)
    logits = rng.standard_normal((4, 30)).astype(np.float32)
    table = rng.integers(0, 30, (4, width)).astype(np.int32)
    ref = jp.disable_tokens_per_row(jnp.asarray(logits), jnp.asarray(table))
    out = tp.disable_tokens_per_row(torch.from_numpy(logits), torch.from_numpy(table))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_disable_tokens_per_row_padding_drops():
    """-1 entries pad a row's table and disable nothing. The JAX package's
    scatter normalizes a negative index before ``mode="drop"`` sees it, so
    there a -1 disables the LAST vocabulary id (a fault of the JAX
    package, ROADMAP queue 3); the port follows the documented rule."""
    logits = np.zeros((2, 6), np.float32)
    table = np.array([[2, -1], [-1, -1]], np.int32)
    out = tp.disable_tokens_per_row(torch.from_numpy(logits), torch.from_numpy(table))
    banned = out.numpy() == tp.DISABLE
    assert banned.tolist() == [[False, False, True, False, False, False],
                               [False] * 6]
    ref = np.asarray(jp.disable_tokens_per_row(jnp.asarray(logits), jnp.asarray(table)))
    assert (ref[:, -1] == jp.DISABLE).all()
    np.testing.assert_array_equal(out.numpy()[:, :-1], ref[:, :-1])


def _slot_generators(seeds):
    gens = []
    for s in seeds:
        g = torch.Generator()
        g.manual_seed(int(s))
        gens.append(g)
    return gens


def draw_slot_samples(log_probs, steps, rows, device="cpu"):
    """``steps`` draws per slot, one a step as the batcher draws them: every
    slot samples ``log_probs`` [V] under its own (topk, topp, temperature,
    seed) with noise from its own generator. Returns ids [steps, S]."""
    topks, topps, temps, seeds = (torch.from_numpy(a).to(device) for a in _options(rows))
    gens = []
    for s in seeds.tolist():
        g = torch.Generator(device=device)
        g.manual_seed(s)
        gens.append(g)
    S, V = len(rows), log_probs.shape[-1]
    batch = log_probs.expand(S, V).contiguous()
    out = []
    for _ in range(steps):
        ids, scores = ts.sample_tokens_per_row(
            batch, ts.slot_noise(gens, V, device), topks=topks, topps=topps,
            temps=temps, max_topk=MAX_TOPK)
        assert torch.equal(scores, log_probs[ids])
        out.append(ids)
    return torch.stack(out)


def test_slot_noise_repeats_under_a_seed_and_zero_without_a_generator():
    a = ts.slot_noise(_slot_generators([3, 4]) + [None], 20, "cpu")
    b = ts.slot_noise(_slot_generators([3, 5]) + [None], 20, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    assert torch.equal(a[2], torch.zeros(20))


def test_slot_sampler_frequencies():
    """3,000 draws a slot from one 40-word distribution, four slots under
    four option sets, each held to its own truncated distribution."""
    rows = [(0, 1.0, 1.0, 1), (8, 1.0, 0.7, 2), (0, 0.8, 1.0, 3), (12, 0.9, 1.5, 4)]
    steps = 3000
    lp = torch.log_softmax(torch.from_numpy(
        np.random.default_rng(6).standard_normal(40).astype(np.float32)) * 1.5, -1)
    ids = draw_slot_samples(lp, steps, rows)
    for s, (topk, topp, temp, _) in enumerate(rows):
        assert_frequencies(ids[:, s].numpy(), ts.truncated_probabilities(
            lp.numpy(), topk, topp, temp), steps)
    again = draw_slot_samples(lp, 50, rows)
    assert torch.equal(again, ids[:50])
