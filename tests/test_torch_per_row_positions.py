"""Per-row positions in the port's ``decoder_forward`` against the JAX
package's, on the CPU (continuous batching: every slot decodes at its own
position).

For every position family the continuous batcher serves (rotary, learned,
sinusoidal, ALiBi in both conventions, the T5 bias, Shaw keys/values, a
sliding window over ring caches and a hybrid window/global stack), in the
float and the int8 KV cache, on builder models (float32 weights, 2 layers,
d_model 64, 4 heads, vocabulary 96; the hybrid stack 4 layers):

- rows are prefilled one by one into prompt-sized caches (a prompt longer
  than the ring block in window-aligned chunks) and inserted into a slot
  cache with ``cache_insert_row``, which writes the same cache as the JAX
  package's from the same prefill caches;
- three decode steps of the whole slot cache at a position vector: the
  port fed the JAX package's cache before each step gives its logits
  within ``TOL`` (``INT8_KV_TOL`` with the int8 cache, where a cached
  vector at a half-step tie lands one int8 step apart) and writes the same
  cache entries;
- each row of the per-row call equals the port's scalar-position call on
  that row alone within ``ROW_TOL`` (with the int8 cache within
  ``INT8_KV_TOL``: a batch of three and a batch of one can round the fresh
  K/V an ulp apart, which the int8 quantization can turn into one step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctranslate2_tpu.converters import builder as jbuilder
from ctranslate2_tpu.models import loader as jloader
from ctranslate2_tpu.models import transformer as JT
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.formats.model_file import load_model_file
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.models.params import cache_from_numpy

TOL = 1e-4
INT8_KV_TOL = 1e-3
ROW_TOL = 1e-5
BASE = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
FAMILIES = {
    "rotary": dict(BASE, num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
                   activation="swish"),
    "learned": BASE,
    "sinusoidal": BASE,  # the learned table dropped from the file
    "alibi": dict(BASE, alibi=True),
    "alibi_negative": dict(BASE, alibi=True, alibi_positive=False),
    "t5": dict(BASE, rel_bias_buckets=8, rel_bias_max_distance=20),
    "shaw": dict(BASE, rel_position_max=4),
    "ring_window": dict(BASE, sliding_window=16, rotary_dim=0),
    "hybrid": dict(BASE, num_layers=4, sliding_window=16, sliding_window_pattern=2,
                   rotary_dim=0),
}
# Slot capacity and each row's prompt length (a row of 0 starts empty).
CAPACITY = {"ring_window": 320, "hybrid": 256}
PROMPTS = {"ring_window": (20, 300, 0), "hybrid": (20, 200, 0)}
STEPS = 3
BUCKET = 16


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    dirs = {}
    for name, kwargs in FAMILIES.items():
        path = jbuilder.build_decoder_only_model(
            str(tmp_path_factory.mktemp(name)), **kwargs)
        if name == "sinusoidal":
            mf = load_model_file(path)
            del mf.variables["decoder/position_encodings/encodings"]
            mf.save(path)
        dirs[name] = path
    return dirs


def _np_cache(cache):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in cache]


def _jax_prefill_row(jm, ids, kv_dtype, capacity):
    """A 1-row cache holding ``ids`` as the JAX batcher's admit builds it:
    one fresh prefill into a prompt-sized cache, or window-aligned chunks
    into a slot-sized ring cache when the prompt exceeds the ring block."""
    arch = jm.arch
    rb = JT.ring_block(arch)
    if rb and len(ids) > rb:
        cache = JT.init_self_cache(arch, 1, capacity, dtype=kv_dtype, ring=True)
        for off, size in JT.split_prefill_chunks(0, len(ids), rb):
            pad = -(-size // BUCKET) * BUCKET
            chunk = np.zeros((1, pad), np.int32)
            chunk[0, :size] = ids[off:off + size]
            _, cache, _ = JT.decoder_forward(
                arch, jm.params, jm.consts, jnp.asarray(chunk), off, cache,
                quantize_acts=False, fresh_prefill=(off == 0))
        return cache
    P = -(-len(ids) // BUCKET) * BUCKET
    padded = np.zeros((1, P), np.int32)
    padded[0, :len(ids)] = ids
    cache = JT.init_self_cache(arch, 1, P, dtype=kv_dtype, ring=True)
    _, cache, _ = JT.decoder_forward(
        arch, jm.params, jm.consts, jnp.asarray(padded), 0, cache,
        lengths=jnp.asarray([len(ids)], jnp.int32), quantize_acts=False,
        fresh_prefill=True)
    return cache


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_row_decode_matches_jax(family_dirs, monkeypatch, family, kv):
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    else:
        monkeypatch.delenv("CT2TPU_KV_CACHE", raising=False)
    path = family_dirs[family]
    jm = jloader.load_model(path, stack_layers=False)
    tm = tt.load_model(path, device="cpu")
    if family == "sinusoidal":
        assert tm.arch.decoder.sinusoidal_positions
    if family in ("ring_window", "hybrid"):
        assert TT.ring_capacity(tm.arch) == 256
    C = CAPACITY.get(family, 64)
    lengths = PROMPTS.get(family, (7, 12, 0))
    B = len(lengths)
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(11)

    # Admit: prefill each row alone, insert it into its slot.
    jcache = JT.init_self_cache(jm.arch, B, C, dtype=jdt, ring=True)
    tcache = TT.init_self_cache(tm.arch, B, C, dtype=tdt, ring=True)
    for r, n in enumerate(lengths):
        if not n:
            continue
        sub = _jax_prefill_row(jm, rng.integers(3, 96, n).tolist(), jdt, C)
        jcache = JT.cache_insert_row(jcache, sub, jnp.int32(r))
        out = TT.cache_insert_row(tcache, cache_from_numpy(_np_cache(sub)), r)
        assert out is tcache
    for tl, jl in zip(tcache, _np_cache(jcache)):
        for name in tl:
            np.testing.assert_array_equal(tl[name].numpy(), jl[name], err_msg=name)

    tol = INT8_KV_TOL if kv == "int8" else TOL
    for step in range(STEPS):
        pos = np.asarray(lengths, np.int32) + step
        ids = rng.integers(3, 96, (B, 1))
        before = _np_cache(jcache)
        jlogits, jcache, _ = JT.decoder_forward(
            jm.arch, jm.params, jm.consts, jnp.asarray(ids, jnp.int32),
            jnp.asarray(pos), jcache, quantize_acts=False)
        tcache = cache_from_numpy(before)
        tlogits, tcache = TT.decoder_forward(
            tm.arch, tm.params, tm.consts, torch.from_numpy(ids),
            torch.from_numpy(pos), tcache, quantize_acts=False)
        assert tuple(tlogits.shape) == (B, 1, 96)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=tol,
                                   rtol=0)
        for tl, jl in zip(tcache, _np_cache(jcache)):
            for name in tl:
                if kv == "int8" and name in ("k", "v"):
                    # A fresh vector at a half-step tie may land one step apart.
                    diff = np.abs(tl[name].numpy().astype(int) - jl[name].astype(int))
                    assert diff.max() <= 1 and diff.mean() < 1e-2, name
                else:
                    np.testing.assert_allclose(tl[name].numpy(), jl[name], atol=tol,
                                               rtol=0, err_msg=name)
        # Each row alone, at its scalar position.
        for r in range(B):
            row_cache = [{k: v[r:r + 1].clone() for k, v in layer.items()}
                         for layer in cache_from_numpy(before)]
            alone, _ = TT.decoder_forward(
                tm.arch, tm.params, tm.consts, torch.from_numpy(ids[r:r + 1]),
                int(pos[r]), row_cache, quantize_acts=False)
            np.testing.assert_allclose(alone[0].numpy(), tlogits[r].numpy(),
                                       atol=ROW_TOL if kv == "float" else tol, rtol=0)


def test_per_row_positions_clip_the_learned_table_and_zero_step_zero(family_dirs):
    """A per-row position past the learned table reads its last row (the
    JAX package's gather clips too); ``start_from_zero_embedding`` zeroes
    exactly the rows at position 0."""
    tm = tt.load_model(family_dirs["learned"], device="cpu")
    table = tm.params["decoder"]["position_encodings"]
    x = torch.zeros((2, 1, table.shape[1]))
    out = TT._apply_positions(tm.params["decoder"], {}, tm.arch.decoder, x,
                              torch.tensor([3, table.shape[0] + 5]))
    assert torch.equal(out[0, 0], table[3]) and torch.equal(out[1, 0], table[-1])

    import dataclasses
    arch = dataclasses.replace(tm.arch, decoder=dataclasses.replace(
        tm.arch.decoder, start_from_zero_embedding=True))
    ids = torch.tensor([[5], [5]])
    cache = TT.init_self_cache(arch, 2, 16)
    vec, _ = TT.decoder_forward(arch, tm.params, tm.consts, ids,
                                torch.tensor([0, 4]), cache, quantize_acts=False)
    for r, p in enumerate((0, 4)):
        alone, _ = TT.decoder_forward(arch, tm.params, tm.consts, ids[r:r + 1], p,
                                      TT.init_self_cache(arch, 1, 16),
                                      quantize_acts=False)
        np.testing.assert_allclose(vec[r].numpy(), alone[0].numpy(), atol=ROW_TOL)
