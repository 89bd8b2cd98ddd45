"""The port's Hugging Face Transformers converter against the JAX
package's, on the CPU.

Every tiny random model that ``test_transformers_converters.py`` converts
(38 architectures: decoders, encoder-decoders, encoders, speech, the
SmoothQuant ``activation_scales`` fold), the mock Gemma4 / MixFormer /
T5Gemma2 modules of ``test_new_converters.py`` and the AutoAWQ-style
checkpoint of ``test_awq.py`` is converted by both packages, without
quantization and under int8: the two model directories must be
byte-identical (``model.bin``, ``config.json``, the vocabularies), or both
conversions must raise the same error. Each conversion takes a fresh copy
of the model, since the SmoothQuant fold rescales the modules in place.
For Llama (GQA), T5, Whisper, BERT and Marian the port runs the converted
model on the CPU against the Hugging Face torch forward, at those tests'
tolerances. The models and tokenizers are those tests' own, imported.
"""

import copy
import importlib
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_new_converters import G4Cfg, G4Model, MixModel, TG2Model, Tok  # noqa: E402
from test_transformers_converters import IDS, DummyTokenizer  # noqa: E402

PACKAGES = ["ctranslate2_tpu", "ctranslate2_tpu_torch"]
QUANTIZATIONS = [None, "int8"]
t = transformers


def _g4_k_eq_v():
    model = G4Model()
    model.config = G4Cfg()
    model.config.attention_k_eq_v = True
    return model


def _t5gemma():
    enc = t.T5GemmaModuleConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, intermediate_size=64, vocab_size=64, sliding_window=4,
        query_pre_attn_scalar=8, layer_types=["sliding_attention", "full_attention"],
        max_position_embeddings=64)
    return t.T5GemmaForConditionalGeneration(
        t.T5GemmaConfig(encoder=enc, decoder=enc, vocab_size=64))


def _opt():
    return t.OPTForCausalLM(t.OPTConfig(
        vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=32))


def _awq_llama():
    """``test_awq_hf_conversion``'s Llama with AutoAWQ GEMM linears."""
    from ctranslate2_tpu_torch.ops import awq

    model = ARCHS["llama_gqa"][0]()

    class WQLinear_GEMM(torch.nn.Module):
        w_bit = 4
        group_size = 16

        def __init__(self, lin):
            super().__init__()
            qw, scales, qz = awq.quantize_awq(lin.weight.detach().numpy(), self.group_size,
                                              awq.AWQ_GEMM)
            self.qweight = torch.tensor(qw)
            self.scales = torch.tensor(scales)
            self.qzeros = torch.tensor(qz)
            self.bias = lin.bias

    for layer in model.model.layers:
        a, m = layer.self_attn, layer.mlp
        for parent, names in ((a, ("q_proj", "k_proj", "v_proj", "o_proj")),
                              (m, ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                setattr(parent, n, WQLinear_GEMM(getattr(parent, n)))
    return model


def _smoothquant_scales():
    """``test_opt_smoothquant_activation_scales``'s scales (2 layers)."""
    g = torch.Generator().manual_seed(0)
    scales = {}
    for i in range(2):
        scope = f"model.decoder.layers.{i}"
        scales[f"{scope}.self_attn.q_proj"] = torch.rand(32, generator=g) * 4 + 0.1
        scales[f"{scope}.fc1"] = torch.rand(32, generator=g) * 4 + 0.1
    return scales


# name: (model factory, vocabulary size, converter keyword arguments).
ARCHS = {
    "gpt2": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4)), 64, {}),
    "llama_gqa": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)), 64, {}),
    "llama_rope_llama3": (lambda: t.LlamaForCausalLM(t.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64})), 64, {}),
    "mistral_sliding_window": (lambda: t.MistralForCausalLM(t.MistralConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, sliding_window=4,
        max_position_embeddings=64, pad_token_id=3)), 64, {}),
    "qwen2": (lambda: t.Qwen2ForCausalLM(t.Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)), 64, {}),
    "opt": (_opt, 64, {}),
    "gpt_neox": (lambda: t.GPTNeoXForCausalLM(t.GPTNeoXConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, rotary_pct=0.5, max_position_embeddings=64)), 64, {}),
    "bloom": (lambda: t.BloomForCausalLM(t.BloomConfig(
        vocab_size=64, hidden_size=32, n_layer=2, n_head=4)), 64, {}),
    "gemma": (lambda: t.GemmaForCausalLM(t.GemmaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64)), 64, {}),
    "t5": (lambda: t.T5ForConditionalGeneration(t.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="relu", decoder_start_token_id=3, tie_word_embeddings=True)),
        64, {}),
    "bart": (lambda: t.BartForConditionalGeneration(t.BartConfig(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=False,
        decoder_start_token_id=2)), 64, {}),
    "bert": (lambda: t.BertModel(t.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64)), 64, {}),
    "whisper": (lambda: t.WhisperForConditionalGeneration(t.WhisperConfig(
        vocab_size=64, num_mel_bins=16, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=32, max_target_positions=32,
        pad_token_id=3, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)), 64, {}),
    "wav2vec2": (lambda: t.Wav2Vec2ForCTC(t.Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=(16, 16, 32), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 3), num_feat_extract_layers=3, do_stable_layer_norm=True,
        feat_extract_norm="layer", num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16)), 32, {}),
    "wav2vec2bert": (lambda: t.Wav2Vec2BertForCTC(t.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_adapter_layers=1, num_attention_heads=4,
        intermediate_size=64, feature_projection_input_dim=48, output_hidden_size=32,
        vocab_size=20, left_max_position_embeddings=8, right_max_position_embeddings=8,
        position_embeddings_type="relative_key", conv_depthwise_kernel_size=31,
        add_adapter=True, layerdrop=0.0, feat_proj_dropout=0.0, hidden_dropout=0.0)),
        20, {}),
    "gptj": (lambda: t.GPTJForCausalLM(t.GPTJConfig(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4, rotary_dim=8)),
        64, {}),
    "codegen": (lambda: t.CodeGenForCausalLM(t.CodeGenConfig(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4, rotary_dim=8,
        n_inner=None)), 64, {}),
    "gpt_bigcode": (lambda: t.GPTBigCodeForCausalLM(t.GPTBigCodeConfig(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4, multi_query=True)),
        64, {}),
    "falcon_new_arch": (lambda: t.FalconForCausalLM(t.FalconConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, new_decoder_architecture=True, parallel_attn=True, bias=False,
        alibi=False)), 64, {}),
    "falcon_alibi": (lambda: t.FalconForCausalLM(t.FalconConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        new_decoder_architecture=False, multi_query=True, parallel_attn=True, bias=False,
        alibi=True)), 64, {}),
    "mpt": (lambda: t.MptForCausalLM(t.MptConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_seq_len=64)), 64, {}),
    "phi": (lambda: t.PhiForCausalLM(t.PhiConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, partial_rotary_factor=0.5, max_position_embeddings=64)),
        64, {}),
    "phi3": (lambda: t.Phi3ForCausalLM(t.Phi3Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        pad_token_id=3)), 64, {}),
    "pegasus": (lambda: t.PegasusForConditionalGeneration(t.PegasusConfig(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=True)), 64, {}),
    "distilbert": (lambda: t.DistilBertModel(t.DistilBertConfig(
        vocab_size=64, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
        max_position_embeddings=64)), 64, {}),
    "mbart": (lambda: t.MBartForConditionalGeneration(t.MBartConfig(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64)), 64, {}),
    "gemma3": (lambda: t.Gemma3ForCausalLM(t.Gemma3TextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, sliding_window=4, sliding_window_pattern=2,
        query_pre_attn_scalar=8, rope_theta=1_000_000.0, rope_local_base_freq=10_000.0)),
        64, {}),
    "t5gemma": (_t5gemma, 64, {}),
    "gemma2": (lambda: t.Gemma2ForCausalLM(t.Gemma2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, sliding_window=16,
        query_pre_attn_scalar=8, attn_logit_softcapping=None,
        final_logit_softcapping=30.0)), 64, {}),
    "qwen3": (lambda: t.Qwen3ForCausalLM(t.Qwen3Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8)), 64, {}),
    "m2m100": (lambda: t.M2M100ForConditionalGeneration(t.M2M100Config(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=True)), 64, {}),
    "roberta": (lambda: t.RobertaModel(t.RobertaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=68, pad_token_id=1)), 64, {}),
    "mt5": (lambda: t.MT5ForConditionalGeneration(t.MT5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", decoder_start_token_id=3,
        tie_word_embeddings=False)), 64, {}),
    "marian_hf": (lambda: t.MarianMTModel(t.MarianConfig(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, decoder_start_token_id=3,
        static_position_embeddings=True, pad_token_id=63)), 64, {}),
    "opt_smoothquant": (_opt, 64, {"activation_scales": _smoothquant_scales}),
    "smoothquant_unsupported": (lambda: t.GPT2LMHeadModel(t.GPT2Config(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=1, n_head=4)), 64,
        {"activation_scales": dict}),
    "gemma4": (G4Model, 64, {}),
    "gemma4_k_eq_v": (_g4_k_eq_v, 64, {}),
    "mixformer": (MixModel, 64, {}),
    "t5gemma2": (TG2Model, 64, {}),
    "awq_llama": (_awq_llama, 64, {}),
}
MOCKS = {"gemma4", "gemma4_k_eq_v", "mixformer", "t5gemma2"}


def convert(pkg, name, model, out, quantization):
    """(None, ``out``) or the conversion's error as (type name, message)."""
    _, vocab, kw = ARCHS[name]
    conv = importlib.import_module(f"{pkg}.converters.transformers_conv")
    tok = Tok(vocab) if name in MOCKS else DummyTokenizer(vocab)
    kw = {k: v() for k, v in kw.items()}
    try:
        conv.TransformersConverter(model=copy.deepcopy(model), tokenizer=tok, **kw).convert(
            out, quantization=quantization, force=True)
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return type(e).__name__, str(e)
    return None


def convert_both(name, tmp_path, quantization=None):
    torch.manual_seed(0)
    model = ARCHS[name][0]().eval()
    outs = [str(tmp_path / pkg) for pkg in PACKAGES]
    errors = [convert(pkg, name, model, out, quantization) for pkg, out in zip(PACKAGES, outs)]
    assert errors[1] == errors[0]
    if errors[0] is None:
        names = sorted(os.listdir(outs[0]))
        assert names == sorted(os.listdir(outs[1])) and "model.bin" in names
        for n in names:
            with open(os.path.join(outs[0], n), "rb") as a, \
                    open(os.path.join(outs[1], n), "rb") as b:
                assert a.read() == b.read(), n
    return model, outs[1], errors[0]


@pytest.mark.parametrize("quantization", QUANTIZATIONS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_port_writes_the_jax_directory(name, quantization, tmp_path):
    _, _, error = convert_both(name, tmp_path, quantization)
    # Only the GPT-2 fold is expected to fail, in both packages alike.
    assert (error is None) == (name != "smoothquant_unsupported"), error


def _port(out_dir):
    from ctranslate2_tpu_torch.models.loader import load_model

    return load_model(out_dir, compute_type="float32", device="cpu")


def _seq2seq_logits(m, src, tgt):
    from ctranslate2_tpu_torch.models import transformer as T
    from ctranslate2_tpu_torch.ops import attention as A

    src_t = torch.tensor(src)
    src_len = torch.tensor([len(src[0])])
    memory = T.encoder_forward(m.arch, m.params, m.consts, src_t, src_len,
                               quantize_acts=False)
    mem_kv = T.precompute_memory(m.arch, m.params, memory, quantize_acts=False)
    logits, _ = T.decoder_forward(m.arch, m.params, m.consts, torch.tensor(tgt), 0, None,
                                  mem_kv, A.length_mask_bias(src_len, memory.shape[1]),
                                  quantize_acts=False)
    return logits.float().numpy()


@pytest.mark.parametrize("name", ["llama_gqa", "t5", "whisper", "bert", "marian_hf"])
def test_port_runs_the_converted_model_like_hugging_face(name, tmp_path):
    """``test_transformers_converters.py``'s parity checks on the port."""
    from ctranslate2_tpu_torch.models import transformer as T

    model, out_dir, _ = convert_both(name, tmp_path)
    m = _port(out_dir)
    atol = 1e-2 if name == "marian_hf" else 2e-3
    with torch.no_grad():
        if name == "llama_gqa":
            ids = torch.tensor(IDS)
            ours = T.decoder_forward(m.arch, m.params, m.consts, ids, 0, None,
                                     lengths=torch.tensor([ids.shape[1]]),
                                     quantize_acts=False)[0].float().numpy()
            theirs = model(ids).logits.numpy()
        elif name == "bert":
            ids = torch.tensor([[4, 9, 17, 23]])
            ours = T.encoder_forward(m.arch, m.params, m.consts, (ids, torch.zeros_like(ids)),
                                     torch.tensor([4]), quantize_acts=False).numpy()
            theirs = model(ids).last_hidden_state.numpy()
        elif name == "whisper":
            feats = np.random.default_rng(0).standard_normal((1, 16, 64)).astype(np.float32)
            ours = T.speech_encoder_forward(m.arch, m.params, m.consts, torch.tensor(feats),
                                            quantize_acts=False).numpy()
            theirs = model.model.encoder(torch.tensor(feats)).last_hidden_state.numpy()
        else:  # t5, marian_hf: the decoder over the encoded source
            src, tgt = [[5, 9, 12, 7]], [[3, 8, 15, 21]]
            ours = _seq2seq_logits(m, src, tgt)
            theirs = model(input_ids=torch.tensor(src),
                           decoder_input_ids=torch.tensor(tgt)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=1e-3)
