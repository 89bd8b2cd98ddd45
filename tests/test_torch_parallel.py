"""Tensor parallelism of the port against the JAX package, on the CPU.

The port runs one process a rank over gloo (``parallel/launch.py``); its
ranks never import JAX. This test process runs the JAX package: unsharded,
and one-flag tensor-parallel on the 8-device CPU mesh ``conftest.py``
gives it. Two jobs run once for the module (``jobs`` fixture), each rank
writing every case's result; each test then reads one case:

- world 2 (model axis 2): ``Generator`` greedy with float32 scores (within
  ``SCORE_TOL``, as ``test_one_flag_tensor_parallel`` holds them), beam 2,
  int8 weights, the int8 KV cache, AWQ (unpacked and packed, through the
  kernels' plain versions), a model whose single KV head does not divide
  the world, negative-convention ALiBi, ``Translator`` (also with a vocabulary map), ``Encoder``,
  ``Whisper``, ``Wav2Vec2``,
  ``Wav2Vec2Bert``, unload and reload, the layer-0 KV cache after a
  prefill, and the row-parallel int8 scale;
- world 4 (data 2 x model 2): ``Generator``, ``Translator`` and
  ``Whisper`` batches split over the data axis (each data rank runs its
  half, counted; a share that fails raises on every rank; a sampled call
  runs whole and draws as one process does), the ring prefill (counted)
  of a single prompt at ``CT2TPU_RING_PREFILL_MIN_LEN=64``, and
  ``ring_attention`` against the JAX package's and dense attention.

Every rank's result must equal every other's. Tokens equal the JAX
package's, unsharded and one-flag tensor-parallel; float outputs agree
within the stated tolerances. The shard layout is checked here, in this
process, against ``param_specs`` / ``fit_spec``'s slices.

Run a rank by hand: ``python tests/test_torch_parallel.py --worker SPEC
OUT_DIR`` under ``python -m ctranslate2_tpu_torch.parallel.launch``.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-4  # float32 scores (test_one_flag_tensor_parallel's)
FLOAT_TOL = 1e-5  # float32 hidden states, logits and attention
PROMPTS = [["tok1", "tok2"], ["tok3"], ["tok4", "tok1", "tok5"]]
LLAMA = dict(vocab_size=64, num_layers=2, num_heads=8, num_heads_kv=4, d_model=64,
             d_ff=128, rotary_dim=0, glu=True, rms_norm=True, activation="swish")
SOURCES = [["tok1", "tok2", "tok3"], ["tok4"], ["tok2", "tok5", "tok7", "tok1"]]
RING_PROMPT = [f"tok{1 + (i % 5)}" for i in range(257)]
ALIGN_TEXTS = [[3, 4, 5, 6, 7], [8, 9], [10, 11, 12]]
WHISPER_PROMPT = ["<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"]


# ---------------------------------------------------------------------------
# The ranks (no JAX here).
# ---------------------------------------------------------------------------


def _features(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gen(r):
    return {"seqs": [x.sequences_ids for x in r],
            "scores": [list(x.scores) for x in r]}


def _world2_cases(spec, grid):
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.models import transformer as T
    from ctranslate2_tpu_torch.ops.linear import linear, quantize_per_row

    out = {}
    g = tt.Generator(spec["llama"], device="cpu", tensor_parallel=True)
    out["greedy"] = _gen(g.generate_batch(PROMPTS, max_length=8, return_scores=True))
    out["beam"] = _gen(g.generate_batch(PROMPTS[:1], beam_size=2, num_hypotheses=2,
                                        max_length=8, return_scores=True))
    os.environ["CT2TPU_KV_CACHE"] = "int8"
    out["int8_kv"] = _gen(g.generate_batch(PROMPTS, max_length=8))
    del os.environ["CT2TPU_KV_CACHE"]
    lin0 = g.model.params["decoder"]["layers"][0]["ffn"]["linear_0"]["w"]
    out["shard_shape"] = list(lin0.shape)
    ids = torch.tensor([[5, 9, 11, 7]])
    cache = T.init_self_cache(g.model.arch, 1, 16)
    T.decoder_forward(g.model.arch, g.model.params, g.model.consts, ids, 0, cache,
                      quantize_acts=False)
    out["cache_k0"] = cache[0]["k"].numpy()
    g.unload_model(to_cpu=True)
    unloaded = g.model_is_loaded
    g.load_model()
    out["unload"] = {"unloaded": not unloaded,
                     **_gen(g.generate_batch(PROMPTS, max_length=8, return_scores=True))}

    gi = tt.Generator(spec["llama"], device="cpu", compute_type="int8", tensor_parallel=True)
    out["int8"] = _gen(gi.generate_batch(PROMPTS, max_length=8))
    for packed in ("0", "1"):
        os.environ["CT2TPU_W4_PACKED"] = packed
        ga = tt.Generator(spec["awq"], device="cpu", tensor_parallel=True)
        o = ga.model.params["decoder"]["layers"][0]["self_attention"]["o"]
        out[f"awq_{packed}"] = dict(_gen(ga.generate_batch(PROMPTS, max_length=8,
                                                           return_scores=True)),
                                    keys=sorted(k for k in o if k != "tp"))
    del os.environ["CT2TPU_W4_PACKED"]
    gm = tt.Generator(spec["mqa"], device="cpu", tensor_parallel=True)
    a0 = gm.model.arch.decoder.layers[0].self_attention
    out["mqa"] = dict(_gen(gm.generate_batch(PROMPTS, max_length=8, return_scores=True)),
                      heads=[a0.num_heads, a0.num_heads_kv])
    gl = tt.Generator(spec["alibi"], device="cpu", tensor_parallel=True)
    out["alibi"] = _gen(gl.generate_batch(PROMPTS, max_length=8, return_scores=True))

    t = tt.Translator(spec["s2s"], device="cpu", tensor_parallel=True)
    res = t.translate_batch(SOURCES, beam_size=2, max_decoding_length=10,
                            return_scores=True, return_attention=True)
    out["translator"] = {"seqs": [r.hypotheses for r in res],
                         "scores": [list(r.scores) for r in res],
                         "attention": [np.asarray(r.attention[0]).tolist() for r in res]}
    tv = tt.Translator(spec["s2s_vmap"], device="cpu", tensor_parallel=True)
    res = tv.translate_batch(SOURCES, beam_size=2, max_decoding_length=10,
                             return_scores=True, use_vmap=True)
    out["vmap"] = {"seqs": [r.hypotheses for r in res],
                   "scores": [list(r.scores) for r in res]}
    e = tt.Encoder(spec["bert"], device="cpu", tensor_parallel=True)
    eo = e.forward_batch([["tok3", "tok7", "tok1"], ["tok9"]])
    out["encoder"] = {"hidden": np.asarray(eo.last_hidden_state),
                      "pooler": np.asarray(eo.pooler_output)}
    w = tt.Whisper(spec["whisper"], device="cpu", tensor_parallel=True)
    feats = _features(5, (2, 24, 100))
    wr = w.generate(feats, [WHISPER_PROMPT] * 2, beam_size=2, max_length=24,
                    return_scores=True)
    out["whisper"] = {"seqs": [r.sequences_ids for r in wr],
                      "scores": [list(r.scores) for r in wr]}
    start = [w._vocab.to_id(t) for t in WHISPER_PROMPT[:3]]
    al = w.align(_features(6, (3, 24, 100)), start, ALIGN_TEXTS, 50)
    out["whisper_align"] = {"alignments": [a.alignments for a in al],
                            "probs": [list(a.text_token_probs) for a in al],
                            "languages": w.detect_language(feats)}
    w2 = tt.Wav2Vec2(spec["wav2vec2"], device="cpu", tensor_parallel=True)
    out["wav2vec2"] = w2.encode(_features(3, (2, 1, 1234)), to_cpu=True).numpy()
    wb = tt.Wav2Vec2Bert(spec["w2v_bert"], device="cpu", tensor_parallel=True)
    out["w2v_bert"] = {"logits": wb.encode(_features(4, (2, 37, 48)), to_cpu=True).numpy(),
                       "tensor_parallel": wb.tensor_parallel}

    # The row-parallel int8 scale: the second half of row 0 holds the
    # row's absmax, so rank 0's own absmax would quantize its half with
    # another (finer) step.
    x = _features(7, (2, 8))
    x[0, 5] = 9.0
    r, half = grid.model.rank, 4
    mine = torch.from_numpy(x[:, r * half:(r + 1) * half])
    q_group, s_group = quantize_per_row(mine, comm=grid.model)
    q_local, s_local = quantize_per_row(mine)
    w8 = _features(8, (6, 8))
    wq, wscale = quantize_per_row(torch.from_numpy(w8))
    from ctranslate2_tpu_torch.parallel.sharding import Split

    row = {"wq": wq[:, r * half:(r + 1) * half].contiguous(), "scale": wscale,
           "b": torch.arange(6, dtype=torch.float32), "tp": Split("row", grid.model)}
    full = {"wq": wq, "scale": wscale, "b": torch.arange(6, dtype=torch.float32)}
    out["row_scale"] = {"q_group": q_group.numpy(), "s_group": s_group.numpy(),
                        "q_local": q_local.numpy(), "s_local": s_local.numpy(),
                        "y_tp": linear(row, mine).numpy(),
                        "y_full": linear(full, torch.from_numpy(x)).numpy()}
    return out


def _world4_cases(spec, grid):
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.parallel import context as ctx_par

    out = {}
    g = tt.Generator(spec["llama"], device="cpu", tensor_parallel=True, device_index=[0, 1])
    out["grid"] = [g.model.grid.num_data, g.model.grid.num_model, g.num_replicas]
    batch = PROMPTS + [["tok5", "tok6"]]
    generate, ran = g._generate, []

    def counted_generate(starts, *args):  # the rows of each share this rank ran
        ran.append([tuple(s) for s in starts])
        return generate(starts, *args)

    g._generate = counted_generate
    out["data_axis"] = _gen(g.generate_batch(batch, max_length=8, return_scores=True))
    out[f"data_rows_{grid.rank}"] = ran[:]
    # A sampled call runs its batch whole on every data rank: its draws
    # equal one process's (the unsharded port in this rank).
    sample = dict(max_length=8, sampling_topk=5, seed=7, return_scores=True)
    out["sampled"] = {"tp": _gen(g.generate_batch(batch, **sample)),
                      "one": _gen(tt.Generator(spec["llama"], device="cpu")
                                  .generate_batch(batch, **sample)),
                      "rows": [len(r) for r in ran[1:]]}

    def failing(starts, *args):
        if grid.data.rank == 1:
            raise ValueError("injected share failure")
        return generate(starts, *args)

    g._generate = failing
    try:
        g.generate_batch(batch, max_length=8)
        out[f"share_failure_{grid.rank}"] = None
    except Exception as e:  # noqa: BLE001
        out[f"share_failure_{grid.rank}"] = f"{type(e).__name__}: {e}"
    g._generate = generate
    t = tt.Translator(spec["s2s"], device="cpu", tensor_parallel=True, device_index=[0, 1])
    res = t.translate_batch(SOURCES + [["tok6", "tok3"]], beam_size=2, max_decoding_length=10,
                            return_scores=True)
    out["data_translator"] = {"seqs": [r.hypotheses for r in res],
                              "scores": [list(r.scores) for r in res]}
    w = tt.Whisper(spec["whisper"], device="cpu", tensor_parallel=True, device_index=[0, 1])
    wr = w.generate(_features(5, (2, 24, 100)), [WHISPER_PROMPT] * 2, beam_size=2,
                    max_length=24, return_scores=True)
    out["data_whisper"] = {"seqs": [r.sequences_ids for r in wr],
                           "scores": [list(r.scores) for r in wr]}

    calls = []
    orig = ctx_par.ring_attention_prefill

    def counted(*a, **k):
        calls.append(a[0].shape[2])
        return orig(*a, **k)

    ctx_par.ring_attention_prefill = counted
    os.environ["CT2TPU_RING_PREFILL_MIN_LEN"] = "64"
    out["ring_prefill"] = dict(_gen(g.generate_batch(
        [RING_PROMPT], max_length=8, include_prompt_in_result=False, return_scores=True)),
        calls=calls)
    del os.environ["CT2TPU_RING_PREFILL_MIN_LEN"]
    ctx_par.ring_attention_prefill = orig

    B, H, T, D = 2, 4, 64, 32
    q, k, v = (_features(s, (B, H, T, D)) for s in (0, 1, 2))
    n, d = grid.data.size, grid.data.rank
    part = slice(d * T // n, (d + 1) * T // n)
    for causal in (True, False):
        local = ctx_par.ring_attention(*(torch.from_numpy(a[:, :, part].copy())
                                         for a in (q, k, v)),
                                       grid.data, causal=causal, scale=1 / np.sqrt(D))
        out[f"ring_attention_{causal}"] = grid.data.all_gather(local, dim=2).numpy()
    return out


def worker(spec_path, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from ctranslate2_tpu_torch.parallel.sharding import make_grid, initialize_distributed

    spec = json.load(open(spec_path))
    info = initialize_distributed(device="cpu")
    world = info["process_count"]
    grid = make_grid(2 if world == 4 else 1, "cpu")
    out = _world2_cases(spec, grid) if world == 2 else _world4_cases(spec, grid)
    torch.save(out, os.path.join(out_dir, f"rank{grid.rank}.pt"))
    print(f"MP_OK rank={grid.rank} cases={sorted(out)}", flush=True)


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The test process: the JAX package's runs and the checks.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The test models: the builders' (the JAX builder writes the port's
    files byte for byte), a BERT encoder and small converted speech
    encoders."""
    transformers = pytest.importorskip("transformers")
    from ctranslate2_tpu.converters import builder as jb
    from test_torch_cuda import build_bert_model
    from test_torch_speech_encoders import _convert

    def mk(name):
        return str(tmp_path_factory.mktemp(name))

    d = {"llama": mk("llama"), "awq": mk("awq"), "mqa": mk("mqa"), "s2s": mk("s2s"),
         "whisper": mk("whisper")}
    jb.build_decoder_only_model(d["llama"], **LLAMA)
    jb.build_decoder_only_model(d["awq"], quantization="awq_gemm", **LLAMA)
    jb.build_decoder_only_model(d["mqa"], **dict(LLAMA, num_heads_kv=1))
    d["alibi"] = mk("alibi")
    jb.build_decoder_only_model(d["alibi"], vocab_size=64, num_layers=2, num_heads=8,
                                d_model=64, d_ff=128, alibi=True, alibi_positive=False)
    jb.build_seq2seq_model(d["s2s"], vocab_size=64, num_layers=2, num_heads=8,
                           d_model=64, d_ff=128)
    jb.build_whisper_model(d["whisper"])
    d["s2s_vmap"] = mk("s2s_vmap")
    shutil.copytree(d["s2s"], d["s2s_vmap"], dirs_exist_ok=True)
    with open(os.path.join(d["s2s_vmap"], "vmap.txt"), "w") as f:
        for i in range(64):  # each source token proposes six target tokens
            f.write(f"tok{i}\t" + " ".join(f"tok{(i * 7 + j) % 64}" for j in range(6)) + "\n")
    d["bert"] = build_bert_model(mk("bert"), vocab_size=96, num_layers=2, num_heads=4,
                                 d_model=64, d_ff=128, max_positions=64)
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=(16, 16, 32), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 3), num_feat_extract_layers=3, do_stable_layer_norm=True,
        feat_extract_norm="layer", num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16)
    d["wav2vec2"] = _convert(transformers.Wav2Vec2ForCTC(cfg).eval(), mk("w2v"), 32)
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_adapter_layers=1, num_attention_heads=4,
        intermediate_size=64, feature_projection_input_dim=48, output_hidden_size=32,
        vocab_size=20, left_max_position_embeddings=8, right_max_position_embeddings=8,
        position_embeddings_type="relative_key", conv_depthwise_kernel_size=31,
        add_adapter=True, layerdrop=0.0, feat_proj_dropout=0.0, hidden_dropout=0.0)
    d["w2v_bert"] = _convert(transformers.Wav2Vec2BertForCTC(cfg).eval(), mk("w2vbert"), 20)
    return d


@pytest.fixture(scope="module")
def jobs(models, tmp_path_factory):
    """Each rank's results of the world-2 and the world-4 job ({world:
    [rank 0's, rank 1's, ...]})."""
    from ctranslate2_tpu_torch.parallel.launch import launch

    spec = str(tmp_path_factory.mktemp("spec") / "spec.json")
    json.dump(models, open(spec, "w"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    out = {}
    for world in (2, 4):
        out_dir = str(tmp_path_factory.mktemp(f"world{world}"))
        rc, logs = launch([os.path.abspath(__file__), "--worker", spec, out_dir], world,
                          timeout=600, env=env, log_dir=out_dir)
        assert rc == 0, "\n".join(log[-3000:] for log in logs)
        out[world] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                      for r in range(world)]
    return out


def _case(jobs, world, name):
    """Rank 0's result of ``name``, after checking every rank's equals it."""
    results = [r[name] for r in jobs[world]]
    for other in results[1:]:
        _assert_equal(other, results[0])
    return results[0]


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _jax_gen(results):
    return {"seqs": [r.sequences_ids for r in results],
            "scores": [list(r.scores) for r in results]}


def _same_gen(got, want, tol=SCORE_TOL, scores=True):
    assert got["seqs"] == want["seqs"]
    if scores:
        np.testing.assert_allclose(np.concatenate(got["scores"]),
                                   np.concatenate(want["scores"]), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def jax_generators(models):
    import ctranslate2_tpu as ct

    cache = {}

    def get(name, tp=False, **kw):
        key = (name, tp, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = ct.Generator(models[name], tensor_parallel=tp, **kw)
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# World 2: the one-flag tensor-parallel path.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [False, True], ids=["jax", "jax_tp"])
def test_greedy_scores(jobs, jax_generators, tp):
    want = _jax_gen(jax_generators("llama", tp).generate_batch(
        PROMPTS, max_length=8, return_scores=True))
    _same_gen(_case(jobs, 2, "greedy"), want)


@pytest.mark.parametrize("tp", [False, True], ids=["jax", "jax_tp"])
def test_beam(jobs, jax_generators, tp):
    want = _jax_gen(jax_generators("llama", tp).generate_batch(
        PROMPTS[:1], beam_size=2, num_hypotheses=2, max_length=8, return_scores=True))
    _same_gen(_case(jobs, 2, "beam"), want)


@pytest.mark.parametrize("tp", [False, True], ids=["jax", "jax_tp"])
def test_int8_weights(jobs, jax_generators, tp):
    want = _jax_gen(jax_generators("llama", tp, compute_type="int8").generate_batch(
        PROMPTS, max_length=8))
    _same_gen(_case(jobs, 2, "int8"), want, scores=False)


def test_int8_kv_cache(jobs, models, monkeypatch):
    import ctranslate2_tpu as ct

    monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")  # read as the JAX engine builds
    want = _jax_gen(ct.Generator(models["llama"]).generate_batch(PROMPTS, max_length=8))
    _same_gen(_case(jobs, 2, "int8_kv"), want, scores=False)


@pytest.mark.parametrize("packed", ["0", "1"])
def test_awq(jobs, jax_generators, packed):
    got = _case(jobs, 2, f"awq_{packed}")
    assert got["keys"] == (["b", "g_scale", "g_zs", "w4p"] if packed == "1"
                           else ["b", "g_scale", "w4"])[-len(got["keys"]):]
    want = _jax_gen(jax_generators("awq").generate_batch(PROMPTS, max_length=8,
                                                         return_scores=True))
    _same_gen(got, want)


def test_kv_heads_that_do_not_divide(jobs, jax_generators):
    """One KV head for 8 query heads at world 2: each rank runs 4 query
    heads over the one KV head they read."""
    assert [r["mqa"].pop("heads") for r in jobs[2]] == [[4, 1], [4, 1]]
    got = _case(jobs, 2, "mqa")
    want = _jax_gen(jax_generators("mqa").generate_batch(PROMPTS, max_length=8,
                                                         return_scores=True))
    _same_gen({k: got[k] for k in ("seqs", "scores")}, want)


def test_alibi_slopes_of_the_ranks_heads(jobs, jax_generators):
    """Negative-convention ALiBi (8 heads, 4 a rank): each rank's shard
    carries the slopes of its heads."""
    want = _jax_gen(jax_generators("alibi").generate_batch(PROMPTS, max_length=8,
                                                           return_scores=True))
    _same_gen(_case(jobs, 2, "alibi"), want)


def test_translator(jobs, models):
    import ctranslate2_tpu as ct

    res = ct.Translator(models["s2s"]).translate_batch(
        SOURCES, beam_size=2, max_decoding_length=10, return_scores=True,
        return_attention=True)
    got = _case(jobs, 2, "translator")
    assert got["seqs"] == [r.hypotheses for r in res]
    np.testing.assert_allclose(np.concatenate(got["scores"]),
                               np.concatenate([r.scores for r in res]), atol=SCORE_TOL)
    for a, r in zip(got["attention"], res):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r.attention[0]), atol=FLOAT_TOL)


def test_translator_vocabulary_map(jobs, models):
    """``use_vmap`` cuts the vocabulary-sharded projection to the
    candidates each rank holds, summed over the ranks."""
    import ctranslate2_tpu as ct

    res = ct.Translator(models["s2s_vmap"]).translate_batch(
        SOURCES, beam_size=2, max_decoding_length=10, return_scores=True, use_vmap=True)
    got = _case(jobs, 2, "vmap")
    assert got["seqs"] == [r.hypotheses for r in res]
    np.testing.assert_allclose(np.concatenate(got["scores"]),
                               np.concatenate([r.scores for r in res]), atol=SCORE_TOL)


def test_encoder(jobs, models):
    import ctranslate2_tpu as ct

    ref = ct.Encoder(models["bert"], device="cpu").forward_batch(
        [["tok3", "tok7", "tok1"], ["tok9"]])
    got = _case(jobs, 2, "encoder")
    np.testing.assert_allclose(got["hidden"], np.asarray(ref.last_hidden_state),
                               atol=FLOAT_TOL, rtol=0)
    np.testing.assert_allclose(got["pooler"], np.asarray(ref.pooler_output),
                               atol=FLOAT_TOL, rtol=0)


def test_whisper(jobs, models):
    import ctranslate2_tpu as ct

    res = ct.Whisper(models["whisper"], device="cpu").generate(
        _features(5, (2, 24, 100)), [WHISPER_PROMPT] * 2, beam_size=2, max_length=24,
        return_scores=True)
    _same_gen(_case(jobs, 2, "whisper"), _jax_gen(res))


def test_whisper_align_and_language(jobs, models):
    """The cross-attention heads ``align`` reads live on several ranks:
    each rank gathers them whole."""
    import ctranslate2_tpu as ct

    jw = ct.Whisper(models["whisper"], device="cpu")
    start = [jw._vocab.to_id(t) for t in WHISPER_PROMPT[:3]]
    ref = jw.align(_features(6, (3, 24, 100)), start, ALIGN_TEXTS, 50)
    got = _case(jobs, 2, "whisper_align")
    assert got["alignments"] == [r.alignments for r in ref]
    np.testing.assert_allclose(np.concatenate(got["probs"]),
                               np.concatenate([r.text_token_probs for r in ref]),
                               atol=FLOAT_TOL, rtol=0)
    langs = jw.detect_language(_features(5, (2, 24, 100)))
    for g, r in zip(got["languages"], langs):
        assert [x[0] for x in g] == [x[0] for x in r]
        np.testing.assert_allclose([x[1] for x in g], [x[1] for x in r], atol=FLOAT_TOL)


def test_wav2vec2(jobs, models):
    from ctranslate2_tpu.runtime.wav2vec2 import Wav2Vec2

    ref = Wav2Vec2(models["wav2vec2"], device="cpu").encode(
        _features(3, (2, 1, 1234)), to_cpu=True)
    np.testing.assert_allclose(_case(jobs, 2, "wav2vec2"), np.asarray(ref),
                               atol=FLOAT_TOL, rtol=0)


def test_wav2vec2bert_runs_replicated(jobs, models):
    import ctranslate2_tpu as ct

    ref = ct.Wav2Vec2Bert(models["w2v_bert"]).encode(_features(4, (2, 37, 48)), to_cpu=True)
    got = _case(jobs, 2, "w2v_bert")
    assert got["tensor_parallel"] is True
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=FLOAT_TOL, rtol=0)


def test_unload_and_reload(jobs):
    got = _case(jobs, 2, "unload")
    assert got["unloaded"]
    assert got["seqs"] == _case(jobs, 2, "greedy")["seqs"]
    assert got["scores"] == _case(jobs, 2, "greedy")["scores"]


def test_kv_cache_holds_the_ranks_heads(jobs, models):
    """Layer 0's cache after a 4-token prefill: rank r holds KV heads
    [2r, 2r + 2) of the JAX package's cache, its ``cache_specs`` slice on
    the model axis."""
    import jax
    import jax.numpy as jnp
    from ctranslate2_tpu.models import transformer as JT
    from ctranslate2_tpu.models.loader import load_model
    from ctranslate2_tpu.parallel.sharding import cache_specs, fit_spec, make_mesh

    m = load_model(models["llama"], compute_type="float32", fuse_qkv=False)
    cache = JT.init_self_cache(m.arch, 1, 16)
    _, cache, _ = JT.decoder_forward_jit(m.arch, m.params, m.consts,
                                         jnp.asarray([[5, 9, 11, 7]], jnp.int32),
                                         jnp.int32(0), cache, None, None,
                                         quantize_acts=False)
    full = np.asarray(cache[0]["k"])
    mesh = make_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
    spec = fit_spec(cache_specs(m.arch, mesh)[0]["k"], full.shape, mesh)
    assert tuple(spec) == ("data", "model", None, None)  # a data axis of 1
    for r, rank in enumerate(jobs[2]):
        np.testing.assert_allclose(rank["cache_k0"], full[:, 2 * r:2 * r + 2],
                                   atol=FLOAT_TOL, rtol=0)
        assert rank["shard_shape"] == [64, 64]  # linear_0: (in, d_ff / 2)


def test_row_parallel_int8_scale(jobs):
    """A row-parallel W8A8 linear quantizes with the whole row's absmax: the
    rank-local absmax of rank 0 would put its half one step apart."""
    for r, rank in enumerate(jobs[2]):
        got = rank["row_scale"]
        x = _features(7, (2, 8))
        x[0, 5] = 9.0
        amax = np.abs(x).max(axis=1)
        np.testing.assert_allclose(got["s_group"], 127.0 / amax, rtol=1e-6)
        q_full = np.clip(np.rint(x * (127.0 / amax)[:, None]), -128, 127)
        np.testing.assert_array_equal(got["q_group"], q_full[:, 4 * r:4 * r + 4])
        np.testing.assert_allclose(got["y_tp"], got["y_full"], atol=1e-5, rtol=1e-6)
    local = jobs[2][0]["row_scale"]
    assert (local["s_local"] != local["s_group"]).any()
    assert (local["q_local"] != local["q_group"]).any()


def test_layout_is_the_jax_slices(models):
    """Each leaf of rank r's shard is the slice r that ``param_specs``
    and ``fit_spec`` give on a model axis of 2, fused QKV taken apart."""
    import jax
    from ctranslate2_tpu.models.loader import load_model
    from ctranslate2_tpu.parallel.sharding import fit_spec, make_mesh, param_specs
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.parallel.sharding import shard_params

    for compute in ("float32", "int8"):
        jm = load_model(models["llama"], compute_type=compute, fuse_qkv=False)
        mesh = make_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
        specs = param_specs(jm.arch, jm.params)
        tm = tt.load_model(models["llama"], compute_type=compute, device="cpu")

        def jslice(path, r):
            node, spec = jm.params, specs
            for key in path:
                node, spec = node[key], spec[key]
            a = np.asarray(node)
            spec = fit_spec(spec, a.shape, mesh)
            idx = tuple(slice(r * n // 2, (r + 1) * n // 2) if ax == "model" else slice(None)
                        for ax, n in zip(tuple(spec) + (None,) * a.ndim, a.shape))
            return a[idx]

        for r in range(2):
            params, arch = shard_params(tm.params, tm.arch, 2, r, None)
            dp = params["decoder"]
            wkey = "wq" if compute == "int8" else "w"

            def port(lin):  # (in, out) as the JAX package lays it out
                return lin[wkey].numpy().T if wkey == "wq" else lin[wkey].numpy()

            for i in range(2):
                jp = ("decoder", "layers", i)
                ap = dp["layers"][i]["self_attention"]
                q = ap["qkv"]
                n_q, n_kv = 4 * 8, 2 * 8
                fused = port(q)
                np.testing.assert_array_equal(fused[:, :n_q], jslice(jp + ("self_attention", "q", wkey), r))
                np.testing.assert_array_equal(fused[:, n_q:n_q + n_kv],
                                              jslice(jp + ("self_attention", "k", wkey), r))
                np.testing.assert_array_equal(fused[:, n_q + n_kv:],
                                              jslice(jp + ("self_attention", "v", wkey), r))
                np.testing.assert_array_equal(port(ap["o"]), jslice(jp + ("self_attention", "o", wkey), r))
                fp = dp["layers"][i]["ffn"]
                for name in ("linear_0", "linear_0_noact", "linear_1"):
                    np.testing.assert_array_equal(port(fp[name]), jslice(jp + ("ffn", name, wkey), r))
                if compute == "int8":
                    scales = q["scale"].numpy()
                    np.testing.assert_array_equal(scales[:n_q], jslice(jp + ("self_attention", "q", "scale"), r))
                    np.testing.assert_array_equal(fp["linear_0"]["scale"].numpy(),
                                                  jslice(jp + ("ffn", "linear_0", "scale"), r))
                    np.testing.assert_array_equal(fp["linear_1"]["scale"].numpy(),
                                                  jslice(jp + ("ffn", "linear_1", "scale"), r))
                np.testing.assert_array_equal(
                    dp["layers"][i]["ffn"]["layer_norm"]["gamma"].numpy(),
                    jslice(jp + ("ffn", "layer_norm", "gamma"), r))
            emb = dp["embeddings"][0]
            np.testing.assert_array_equal(emb[wkey if compute == "int8" and "wq" in emb else "w"].numpy(),
                                          jslice(("decoder", "embeddings", 0,
                                                  "wq" if "wq" in emb else "w"), r))
            np.testing.assert_array_equal(port(dp["projection"]),
                                          jslice(("decoder", "projection", wkey), r))
            assert arch.decoder.layers[0].self_attention.num_heads == 4
            assert arch.decoder.layers[0].self_attention.num_heads_kv == 2


# ---------------------------------------------------------------------------
# World 4: data 2 x model 2.
# ---------------------------------------------------------------------------


def test_data_axis(jobs, jax_generators):
    assert _case(jobs, 4, "grid") == [2, 2, 1]
    batch = PROMPTS + [["tok5", "tok6"]]
    for tp in (False, True):
        kw = {"device_index": [0, 1]} if tp else {}
        want = _jax_gen(jax_generators("llama", tp, **{k: tuple(v) for k, v in kw.items()})
                        .generate_batch(batch, max_length=8, return_scores=True))
        _same_gen(_case(jobs, 4, "data_axis"), want)


def test_data_axis_splits_the_batch(jobs):
    """Data rank d (world ranks 2d and 2d + 1) runs the d-th half of the
    batch, once: the halves are disjoint and make the batch."""
    rows = [jobs[4][r][f"data_rows_{r}"] for r in range(4)]
    assert rows[0] == rows[1] and rows[2] == rows[3]
    assert len(rows[0]) == len(rows[2]) == 1 and len(rows[0][0]) == len(rows[2][0]) == 2
    assert not set(rows[0][0]) & set(rows[2][0])


def test_sampled_call_runs_whole_on_the_data_axis(jobs):
    got = _case(jobs, 4, "sampled")
    assert got["rows"] == [4]
    _same_gen(got["tp"], got["one"])


def test_failed_share_raises_on_every_rank(jobs):
    errors = [jobs[4][r][f"share_failure_{r}"] for r in range(4)]
    assert errors[2] == errors[3] == "ValueError: injected share failure"
    assert errors[0] == errors[1] == (
        "RuntimeError: data rank 1 failed: ValueError: injected share failure")


def test_data_axis_translator_and_whisper(jobs, models):
    import ctranslate2_tpu as ct

    res = ct.Translator(models["s2s"]).translate_batch(
        SOURCES + [["tok6", "tok3"]], beam_size=2, max_decoding_length=10,
        return_scores=True)
    _same_gen(_case(jobs, 4, "data_translator"),
              {"seqs": [r.hypotheses for r in res], "scores": [r.scores for r in res]})
    res = ct.Whisper(models["whisper"], device="cpu").generate(
        _features(5, (2, 24, 100)), [WHISPER_PROMPT] * 2, beam_size=2, max_length=24,
        return_scores=True)
    _same_gen(_case(jobs, 4, "data_whisper"), _jax_gen(res))


def test_ring_prefill_fires(jobs, jax_generators, monkeypatch):
    monkeypatch.setenv("CT2TPU_RING_PREFILL", "0")
    want = _jax_gen(jax_generators("llama").generate_batch(
        [RING_PROMPT], max_length=8, include_prompt_in_result=False, return_scores=True))
    got = _case(jobs, 4, "ring_prefill")
    assert got["calls"] == [256, 256], got["calls"]  # one a layer, 256 tokens
    _same_gen({k: got[k] for k in ("seqs", "scores")}, want)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention(jobs, causal):
    import jax
    import jax.numpy as jnp
    from ctranslate2_tpu.parallel.context import ring_attention
    from ctranslate2_tpu.parallel.sharding import make_mesh

    B, H, T, D = 2, 4, 64, 32
    q, k, v = (_features(s, (B, H, T, D)) for s in (0, 1, 2))
    scale = 1 / np.sqrt(D)
    mesh = make_mesh(num_data=1, num_model=8)
    ref = np.asarray(ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                                    causal=causal, scale=scale))
    got = _case(jobs, 4, f"ring_attention_{causal}")
    np.testing.assert_allclose(got, ref, atol=FLOAT_TOL, rtol=0)
    s = np.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got, dense, atol=FLOAT_TOL, rtol=0)
