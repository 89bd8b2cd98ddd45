"""Sliding windows and ring KV caches in the port against the JAX package,
on the CPU.

A windowed layer's cache under greedy search is a ring of ``2 x Wr``
slots (Wr: the window rounded up to 128), written at ``position % (2 x
Wr)``; prompts run in chunks split at multiples of Wr. The builder models
here (2 layers, d_model 64, 4 heads, rotary, vocabulary 96) take a window of
4 (a 256-slot ring) and prompts of up to 300 tokens, so the writes wrap
past ``2 x Wr``; a window of 200 (a 256-token block: prefill chunks of
256 and 43), a window of 1, and a Gemma-style hybrid stack (every second
layer global, its cache linear beside 256-slot rings).

- ``ring_block``, ``ring_capacity``, ``split_prefill_chunks``,
  ``layer_cache_capacity`` and ``init_self_cache(ring=True)`` give the
  JAX package's sizes; ``cache_grow`` leaves a ring layer at its ring
  size; the beam gather and the row tiling take a cache of ring and
  linear layers; ``_cache_write`` wraps at a ring's end;
- ``Generator.generate_batch`` gives the JAX package's tokens (scores
  within ``TOL``, 1e-3 with the int8 KV cache), ring on and
  ``CT2TPU_WINDOW_RING=0``, greedy and beam (beam keeps linear caches);
- the ring on and off give the same tokens with the float KV cache.

The JAX package's decoder builds the causal bias over layer 0's capacity
and gives it to every layer, so a hybrid stack whose prefill fills a ring
shorter than the global layers' caches fails there with a shape error. The
port builds each layer's bias over its own capacity; its hybrid ring run is
held against its own ring-off run and the JAX package's ring-off run, and
against the JAX package's ring run where that one runs (the prompt fed
token by token, ``include_prompt_in_result=True``).
"""

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.models import transformer as JT
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.models import transformer as TT

from test_torch_positions_bias import (FED_TOL, TOL, compare_generators,
                                       half_step_witness, prompts, score_tol, set_kv)

BASE = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
            rotary_dim=0, num_heads_kv=2)
WINDOWS = {
    "window_4": dict(sliding_window=4),
    "window_200": dict(sliding_window=200),
    "window_1": dict(sliding_window=1),
    "hybrid": dict(sliding_window=4, sliding_window_pattern=2, num_layers=3),
}
LONG = (300, 300, 290)  # past 2 x Wr = 256: the ring writes wrap
# Inputs free of W8A8 half-step ties (see test_torch_positions_bias.py), by
# case: the seed of ``prompts``.
TIE_FREE_SEEDS = {("window_200", "int8"): 1}


@pytest.fixture(scope="module")
def window_dirs(tmp_path_factory):
    dirs = {}
    for name, kw in WINDOWS.items():
        for dtype, quant in (("float32", None), ("int8", "int8")):
            path = str(tmp_path_factory.mktemp(f"{name}_{dtype}"))
            tbuilder.build_decoder_only_model(path, quantization=quant,
                                              **{**BASE, **kw})
            dirs[name, dtype] = path
    return dirs


def _arch(window_dirs, name):
    return tt.load_model(window_dirs[name, "float32"], device="cpu").arch


# ---------------------------------------------------------------------------
# Sizes and slots.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring_env", ["1", "0"])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_ring_sizes_match_jax(window_dirs, monkeypatch, name, ring_env):
    monkeypatch.setenv("CT2TPU_WINDOW_RING", ring_env)
    arch = _arch(window_dirs, name)
    assert TT.ring_block(arch) == JT.ring_block(arch)
    assert TT.ring_capacity(arch) == JT.ring_capacity(arch)
    for capacity in (64, 320):
        for ring in (False, True):
            t = TT.init_self_cache(arch, 2, capacity, ring=ring)
            j = JT.init_self_cache(arch, 2, capacity, ring=ring)
            assert [tuple(l["k"].shape) for l in t] == [tuple(l["k"].shape) for l in j]
            for layer in arch.decoder.layers:
                assert TT.layer_cache_capacity(arch, layer.self_attention, capacity,
                                               ring) == \
                    JT.layer_cache_capacity(arch, layer.self_attention, capacity, ring)


@pytest.mark.parametrize("start,length,block", [
    (0, 300, 128), (0, 8256, 4096), (5, 300, 256), (0, 44, 0), (100, 1, 128),
    (256, 256, 128)])
def test_split_prefill_chunks_matches_jax(start, length, block):
    assert TT.split_prefill_chunks(start, length, block) == \
        JT.split_prefill_chunks(start, length, block)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_cache_grow_keeps_ring_layers(window_dirs, dtype):
    arch = _arch(window_dirs, "hybrid")
    rc = TT.ring_capacity(arch)
    cache = TT.init_self_cache(arch, 1, 320, dtype=dtype, ring=True)
    grown = TT.cache_grow(cache, 3, 448, arch=arch)
    caps = [layer["k"].shape[2] for layer in grown]
    assert caps == [rc, 448, rc]
    assert all(layer["k"].shape[0] == 3 for layer in grown)
    if dtype == torch.int8:
        assert [layer["k_scale"].shape[3] for layer in grown] == caps
        assert torch.all(grown[1]["k_scale"][..., 320:] == 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_cache_gather_and_repeat_rows_take_a_mixed_cache(window_dirs, dtype):
    """Ring and linear layers side by side: the fused gather (its plain
    version here) and the row tiling handle every array at its own size."""
    arch = _arch(window_dirs, "hybrid")
    cache = TT.init_self_cache(arch, 3, 320, dtype=dtype, ring=True)
    g = torch.Generator().manual_seed(0)
    for layer in cache:
        for name, a in layer.items():
            a.copy_(torch.randint(-100, 100, a.shape, generator=g).to(a.dtype))
    rows = torch.tensor([2, 0, 0, 1], dtype=torch.int32)
    gathered = TT.cache_gather_rows(cache, rows)
    tiled = TT.cache_repeat_rows(cache, 2)
    for layer, got, rep in zip(cache, gathered, tiled):
        for name, a in layer.items():
            assert torch.equal(got[name], a[rows.long()])
            assert torch.equal(rep[name], a.repeat_interleave(2, dim=0))
    assert [layer["k"].shape[2] for layer in gathered] == [256, 320, 256]


def test_cache_write_wraps_at_the_ring_end():
    buf = torch.zeros(1, 1, 8, 2)
    new = torch.arange(10, dtype=torch.float32).reshape(1, 1, 5, 2)
    TT._cache_write(buf, new, 6, ring=8)
    assert buf[0, 0, :, 0].tolist() == [4, 6, 8, 0, 0, 0, 0, 2]


# ---------------------------------------------------------------------------
# Generation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring_env", ["1", "0"])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["window_4", "window_200", "window_1"])
def test_long_prompt_generates_like_jax(window_dirs, monkeypatch, name, dtype, kv,
                                        ring_env):
    """Prompts past 2 x Wr, prefilled in window-aligned chunks (ring on)."""
    set_kv(monkeypatch, kv)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", ring_env)
    compare_generators(window_dirs[name, dtype],
                       prompts(TIE_FREE_SEEDS.get((name, dtype), 0), lengths=LONG), kv,
                       max_length=12, include_prompt_in_result=False)


@pytest.mark.parametrize("ring_env", ["1", "0"])
def test_int8_disagreement_is_a_half_step_tie(window_dirs, monkeypatch, ring_env):
    """Seed 0, which ``TIE_FREE_SEEDS`` moves the int8 window of 200 off:
    with the float KV cache the two packages' scores part there (by 8.2e-5
    with the ring, 5.2e-4 without) through one activation at a half step;
    fed the JAX package's activations the port gives its tokens and scores."""
    monkeypatch.delenv("CT2TPU_KV_CACHE", raising=False)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", ring_env)
    path = window_dirs["window_200", "int8"]
    batch = prompts(0, lengths=LONG)
    opts = dict(max_length=12, include_prompt_in_result=False, return_scores=True)
    jg, tg = ct.Generator(path, device="cpu"), tt.Generator(path, device="cpu")
    ref, free, fed = half_step_witness(monkeypatch, lambda: jg.generate_batch(batch, **opts),
                                       lambda: tg.generate_batch(batch, **opts))
    assert max(abs(o.scores[0] - r.scores[0]) for o, r in zip(free, ref)) > 1e-5
    for f, r in zip(fed, ref):
        assert f.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(f.scores, r.scores, atol=FED_TOL, rtol=0)


@pytest.mark.parametrize("search", ["beam", "greedy_prompt_in_result"])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("name", ["window_4", "hybrid"])
def test_windowed_search_generates_like_jax(window_dirs, monkeypatch, name, kv, search):
    """Beam search keeps linear caches; a prompt fed token by token through
    the greedy loop writes the ring one slot at a time."""
    set_kv(monkeypatch, kv)
    compare_generators(window_dirs[name, "float32"], prompts(lengths=LONG), kv,
                       max_length=8, beam_size=2 if search == "beam" else 1,
                       include_prompt_in_result=search != "beam")


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hybrid_stack_ring_off_generates_like_jax(window_dirs, monkeypatch, dtype, kv):
    set_kv(monkeypatch, kv)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", "0")
    compare_generators(window_dirs["hybrid", dtype], prompts(lengths=LONG), kv,
                       max_length=12, include_prompt_in_result=False)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_ring_on_and_off_give_the_same_tokens(window_dirs, monkeypatch, name, dtype):
    """The float KV cache, where both read the same keys: the ring's slots
    are a permutation of the linear cache's window."""
    monkeypatch.delenv("CT2TPU_KV_CACHE", raising=False)
    opts = dict(max_length=12, return_scores=True, include_prompt_in_result=False)
    gen = tt.Generator(window_dirs[name, dtype], device="cpu")
    monkeypatch.setenv("CT2TPU_WINDOW_RING", "1")
    on = gen.generate_batch(prompts(lengths=LONG), **opts)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", "0")
    off = gen.generate_batch(prompts(lengths=LONG), **opts)
    for a, b in zip(on, off):
        assert a.sequences_ids == b.sequences_ids
        np.testing.assert_allclose(a.scores, b.scores, atol=TOL, rtol=0)


def test_hybrid_ring_cache_mixes_ring_and_linear_layers(window_dirs, monkeypatch):
    """The greedy loop's cache: 256-slot rings on the windowed layers, the
    call's whole capacity on the global one."""
    monkeypatch.delenv("CT2TPU_WINDOW_RING", raising=False)
    gen = tt.Generator(window_dirs["hybrid", "float32"], device="cpu")
    seen = []
    real = TT.decoder_forward

    def spy(arch, params, consts, ids, pos, self_cache, *args, **kwargs):
        if self_cache is not None:
            seen.append([layer["k"].shape[2] for layer in self_cache])
        return real(arch, params, consts, ids, pos, self_cache, *args, **kwargs)

    monkeypatch.setattr(TT, "decoder_forward", spy)
    gen.generate_batch(prompts(lengths=LONG), max_length=4,
                       include_prompt_in_result=False)
    assert seen and all(caps[0] == caps[2] == 256 and caps[1] > 256 for caps in seen)


@pytest.mark.parametrize("beam", [1, 2])
def test_static_prompt_with_windows_generates_like_jax(window_dirs, monkeypatch, beam):
    """The static prompt's cache is keyed by the ring: greedy copies a ring
    cache, beam a linear one."""
    monkeypatch.delenv("CT2TPU_KV_CACHE", raising=False)
    static = prompts(seed=3, lengths=(260,))[0]
    gen = tt.Generator(window_dirs["window_4", "float32"], device="cpu")
    jgen = ct.Generator(window_dirs["window_4", "float32"], device="cpu")
    opts = dict(static_prompt=static, max_length=8, return_scores=True,
                beam_size=beam, include_prompt_in_result=False)
    out = gen.generate_batch(prompts(lengths=(6, 6)), **opts)
    ref = jgen.generate_batch(prompts(lengths=(6, 6)), **opts)
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=score_tol("float"), rtol=0)
    assert [key[1] for key in gen._static_prompt_cache] == [beam == 1]
