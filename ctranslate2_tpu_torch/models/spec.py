"""Architecture specs derived from a loaded model artifact.

The reference builds its layer graph by probing the variable index for
optional variables and scalar "attribute" variables (reference:
src/layers/transformer.cc:405-536, src/layers/attention_layer.cc:60-140).
Here the same probing happens once at load time and is frozen into hashable
dataclasses that configure the forward functions. A copy of
``ctranslate2_tpu/models/spec.py``, so both packages extract the same spec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..formats.model_file import ModelFile

ROTARY_SCALING_TYPES = {0: "linear", 1: "su", 2: "llama3"}  # serialized ids


@dataclass(frozen=True)
class RotarySpec:
    dim: int  # 0 = full head dim
    interleave: bool = True
    base: float = 10000.0
    scaling_type: Optional[str] = None
    scaling_factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 0
    max_position_embeddings: int = 0
    has_long_short_factors: bool = False


@dataclass(frozen=True)
class AttentionSpec:
    num_heads: int
    num_heads_kv: int
    head_dim: int
    queries_scale: float
    self_attention: bool = True
    multi_query: bool = False
    sliding_window: int = 0
    rotary: Optional[RotarySpec] = None
    has_layer_norm: bool = True  # norm inside the attention block
    has_q_norm: bool = False
    has_k_norm: bool = False
    has_v_norm: bool = False
    # Relative position variants.
    has_rel_position_keys: bool = False
    has_rel_position_values: bool = False
    has_rel_asymmetric_keys: bool = False
    rel_left_max: int = 0
    rel_right_max: int = 0
    max_relative_position: int = 0
    has_rel_attention_bias: bool = False
    rel_max_distance: int = 0
    has_memory_kv: bool = False  # T5Gemma merged attention


@dataclass(frozen=True)
class FFNSpec:
    activation: int  # ActivationType id
    glu: bool = False
    has_layer_norm: bool = True


@dataclass(frozen=True)
class EncoderLayerSpec:
    self_attention: AttentionSpec
    ffn: FFNSpec
    # T5Gemma sandwich norms.
    sandwich_norm: bool = False


@dataclass(frozen=True)
class DecoderLayerSpec:
    self_attention: AttentionSpec
    ffn: FFNSpec
    cross_attention: Optional[AttentionSpec] = None
    sandwich_norm: bool = False
    shared_layer_norm: bool = False  # GPT-J style parallel residual
    input_layer_norm: bool = False  # GPT-NeoX style parallel residual
    post_attention_layer_norm: bool = False
    external_pre_cross_norm: bool = False
    external_post_cross_norm: bool = False
    layer_scalar: float = 1.0


@dataclass(frozen=True)
class EmbeddingsSpec:
    num_features: int = 1
    merge: str = "concat"  # concat|add (EmbeddingsMerge ids 0/1)
    scale: float = 0.0  # multiply-by value; 0 = none


@dataclass(frozen=True)
class EncoderSpec:
    num_layers: int
    num_heads: int
    embeddings: EmbeddingsSpec
    layers: Tuple[EncoderLayerSpec, ...]
    pre_norm: bool = True
    has_position_embedding: bool = False  # learned table
    sinusoidal_positions: bool = False
    has_layernorm_embedding: bool = False
    has_output_norm: bool = False
    # Speech frontends: number of conv layers before the transformer stack
    # (Whisper: 2 — reference: src/layers/whisper.cc:8-23).
    num_conv_layers: int = 0
    # Wav2Vec2 (reference: src/layers/wav2vec2.cc): feature-extractor conv
    # stack + feature projection + positional conv + optional LM head.
    is_wav2vec2: bool = False
    num_feat_layers: int = 0
    has_lm_head: bool = False


@dataclass(frozen=True)
class DecoderSpec:
    num_layers: int
    num_heads: int
    embeddings: EmbeddingsSpec
    layers: Tuple[DecoderLayerSpec, ...]
    pre_norm: bool = True
    has_position_embedding: bool = False
    sinusoidal_positions: bool = False
    has_layernorm_embedding: bool = False
    has_output_norm: bool = False
    has_project_in: bool = False
    has_project_out: bool = False
    start_from_zero_embedding: bool = False
    with_cross_attention: bool = False
    alibi: bool = False
    alibi_use_positive_positions: bool = True
    scale_alibi: bool = False
    sliding_window: int = 0
    alignment_layer: int = -1
    alignment_heads: int = 1
    final_logit_softcapping: float = 0.0
    has_outputs_scale: bool = False
    has_projection: bool = True  # logits layer


@dataclass(frozen=True)
class ArchSpec:
    """Top-level static architecture description."""

    spec_name: str
    encoder: Optional[EncoderSpec] = None
    decoder: Optional[DecoderSpec] = None
    ln_epsilon: Optional[float] = None  # from config.json; None -> per-norm default
    # Per-model flash dispatch threshold override (the flash_attention
    # constructor flag sets 0). Part of the arch so jit caches key on it.
    flash_min_len: Optional[int] = None


# ---------------------------------------------------------------------------
# Extraction from a ModelFile.
# ---------------------------------------------------------------------------


def _count_layers(mf: ModelFile, scope: str) -> int:
    n = 0
    while f"{scope}/layer_{n}/ffn/linear_0/weight" in mf or (
        f"{scope}/layer_{n}/self_attention/linear_0/weight" in mf
    ):
        n += 1
    return n


def _linear_out_dim(mf: ModelFile, scope: str) -> int:
    var = mf.get(scope + "/weight")
    if var is None:
        var = mf.get(scope + "/weight_packed")
    if (scope + "/weight_zero") in mf:
        # AWQ layouts: GEMM stores [in, out/8] int32 (out = 8 * dim 1),
        # GEMV stores [out, in/8] (reference: src/ops/awq/gemv_gpu.cu:280).
        if int(mf.config.get("quantization_type", 1)) == 1:
            return var.shape[1] * 8
        return var.shape[0]
    return var.shape[0]


def _extract_rotary(mf: ModelFile, scope: str) -> Optional[RotarySpec]:
    rotary_dim = int(mf.attribute(scope + "/rotary_dim", -1))
    if rotary_dim < 0:
        return None
    scaling_id = int(mf.attribute(scope + "/rotary_scaling_type", -1))
    return RotarySpec(
        dim=rotary_dim,
        interleave=mf.flag(scope + "/rotary_interleave", True),
        base=float(mf.attribute(scope + "/rotary_base", 10000.0)),
        scaling_type=ROTARY_SCALING_TYPES.get(scaling_id),
        scaling_factor=float(mf.attribute(scope + "/rotary_scaling_factor", 1.0)),
        low_freq_factor=float(mf.attribute(scope + "/rotary_low_freq_factor", 1.0)),
        high_freq_factor=float(mf.attribute(scope + "/rotary_high_freq_factor", 4.0)),
        original_max_position_embeddings=int(
            mf.attribute(scope + "/original_max_position_embeddings", 0)
        ),
        max_position_embeddings=int(mf.attribute(scope + "/max_position_embeddings", 0)),
        has_long_short_factors=(scope + "/rotary_scaling_long_factor") in mf,
    )


def _extract_attention(
    mf: ModelFile, scope: str, num_heads: int, self_attention: bool
) -> AttentionSpec:
    d_model_out = _linear_out_dim(mf, scope + "/linear_" + ("1" if self_attention else "2"))
    head_dim = int(mf.attribute(scope + "/head_dim", d_model_out // num_heads))
    multi_query = mf.flag(scope + "/multi_query", False)
    if multi_query:
        num_heads_kv = 1
    else:
        num_heads_kv = int(mf.attribute(scope + "/num_heads_kv", num_heads))
    queries_scale = float(
        mf.attribute(scope + "/queries_scale", 1.0 / (head_dim ** 0.5))
    )

    has_rel_keys = (scope + "/relative_position_keys") in mf
    has_rel_asym = (scope + "/relative_asymmetric_position_keys") in mf
    has_rel_bias = (scope + "/relative_attention_bias") in mf
    max_rel = 0
    if has_rel_keys:
        max_rel = (mf.get(scope + "/relative_position_keys").shape[0] - 1) // 2
    elif has_rel_bias:
        max_rel = int(mf.attribute(scope + "/relative_attention_max_distance", 0))

    return AttentionSpec(
        num_heads=num_heads,
        num_heads_kv=num_heads_kv,
        head_dim=head_dim,
        queries_scale=queries_scale,
        self_attention=self_attention,
        multi_query=multi_query,
        sliding_window=int(mf.attribute(scope + "/sliding_window", 0)),
        rotary=_extract_rotary(mf, scope),
        has_layer_norm=(scope + "/layer_norm/gamma") in mf,
        has_q_norm=(scope + "/q_norm/gamma") in mf,
        has_k_norm=(scope + "/k_norm/gamma") in mf,
        has_v_norm=(scope + "/v_norm/gamma") in mf,
        has_rel_position_keys=has_rel_keys,
        has_rel_position_values=(scope + "/relative_position_values") in mf,
        has_rel_asymmetric_keys=has_rel_asym,
        rel_left_max=int(mf.attribute(scope + "/relative_left_max_position", 0)),
        rel_right_max=int(mf.attribute(scope + "/relative_right_max_position", 0)),
        max_relative_position=max_rel,
        has_rel_attention_bias=has_rel_bias,
        rel_max_distance=max_rel if has_rel_bias else 0,
        has_memory_kv=(scope + "/memory_kv/weight") in mf,
    )


def _extract_ffn(mf: ModelFile, scope: str, activation: int) -> FFNSpec:
    return FFNSpec(
        activation=activation,
        glu=(scope + "/linear_0_noact/weight") in mf,
        has_layer_norm=(scope + "/layer_norm/gamma") in mf,
    )


def _extract_embeddings(mf: ModelFile, scope: str, d_model_hint: int) -> EmbeddingsSpec:
    merge_id = int(mf.attribute(scope + "/embeddings_merge", 0))
    num_features = 1
    if (scope + "/embeddings/weight") not in mf:
        while f"{scope}/embeddings_{num_features - 1}/weight" in mf:
            num_features += 1
        num_features -= 1
        num_features = max(num_features, 1)

    # Embedding scale: flag or value (reference: src/layers/transformer.cc:381-402).
    base = scope + "/embeddings"
    if (base + "/weight") not in mf:
        base = scope + "/embeddings_0"
    emb_dim = mf.get(base + "/weight").shape[1]
    scale_var = mf.get(scope + "/scale_embeddings")
    if scale_var is None:
        scale_var = mf.get(scope + "/embeddings/multiply_by_sqrt_depth")
    if scale_var is None:
        scale = float(emb_dim) ** 0.5
    elif scale_var.dtype_name == "int8":
        scale = float(emb_dim) ** 0.5 if scale_var.as_scalar() else 0.0
    else:
        value = float(scale_var.as_scalar())
        scale = value if value != 1.0 else 0.0

    return EmbeddingsSpec(
        num_features=num_features,
        merge="concat" if merge_id == 0 else "add",
        scale=scale,
    )


def extract_encoder(mf: ModelFile, scope: str = "encoder") -> Optional[EncoderSpec]:
    if f"{scope}/layer_0/self_attention/linear_0/weight" not in mf:
        return None
    num_layers = _count_layers(mf, scope)
    num_heads = int(mf.attribute(scope + "/num_heads", 8))
    pre_norm = mf.flag(scope + "/pre_norm", True)
    activation = int(mf.attribute(scope + "/activation", 0))
    num_conv = 0
    while f"{scope}/conv{num_conv + 1}/weight" in mf:
        num_conv += 1
    is_wav2vec2 = f"{scope}/fp_projection/weight" in mf
    num_feat_layers = 0
    while f"{scope}/feat_layer_{num_feat_layers}/conv/weight" in mf:
        num_feat_layers += 1
    is_speech = num_conv > 0 or is_wav2vec2
    if is_speech:
        # Whisper encoders run GELU activations and pre-norm
        # (reference: src/layers/whisper.cc:6-22).
        pre_norm = True
        activation = 3

    layers = []
    for i in range(num_layers):
        lscope = f"{scope}/layer_{i}"
        attn = _extract_attention(mf, lscope + "/self_attention", num_heads, True)
        ffn = _extract_ffn(mf, lscope + "/ffn", activation)
        sandwich = all(
            (lscope + f"/{n}/gamma") in mf
            for n in (
                "input_layer_norm",
                "post_attention_layer_norm",
                "pre_feedforward_layer_norm",
                "post_feedforward_layer_norm",
            )
        )
        layers.append(EncoderLayerSpec(attn, ffn, sandwich_norm=sandwich))

    attn0 = layers[0].self_attention
    has_positional = (
        attn0.rotary is not None
        or attn0.has_rel_position_keys
        or attn0.has_rel_attention_bias
        or attn0.has_rel_asymmetric_keys
    )
    has_pe_table = (scope + "/position_encodings/encodings") in mf

    return EncoderSpec(
        num_layers=num_layers,
        num_heads=num_heads,
        embeddings=_extract_embeddings(mf, scope, 0) if not is_speech
        else EmbeddingsSpec(),
        layers=tuple(layers),
        pre_norm=pre_norm,
        has_position_embedding=has_pe_table,
        sinusoidal_positions=not has_pe_table and not has_positional
        and not is_speech,
        has_layernorm_embedding=(scope + "/layernorm_embedding/gamma") in mf,
        has_output_norm=(scope + "/layer_norm/gamma") in mf,
        num_conv_layers=num_conv,
        is_wav2vec2=is_wav2vec2,
        num_feat_layers=num_feat_layers,
        has_lm_head=(scope + "/lm_head/weight") in mf,
    )


def extract_decoder(mf: ModelFile, scope: str = "decoder") -> Optional[DecoderSpec]:
    if f"{scope}/layer_0/self_attention/linear_0/weight" not in mf:
        return None
    num_layers = _count_layers(mf, scope)
    num_heads = int(mf.attribute(scope + "/num_heads", 8))
    pre_norm = mf.flag(scope + "/pre_norm", True)
    activation = int(mf.attribute(scope + "/activation", 0))
    alibi = mf.flag(scope + "/alibi", False)

    layers = []
    for i in range(num_layers):
        lscope = f"{scope}/layer_{i}"
        attn = _extract_attention(mf, lscope + "/self_attention", num_heads, True)
        ffn = _extract_ffn(mf, lscope + "/ffn", activation)
        cross = None
        if (lscope + "/attention/linear_0/weight") in mf:
            cross = _extract_attention(mf, lscope + "/attention", num_heads, False)
        sandwich = (
            (lscope + "/pre_feedforward_layer_norm/gamma") in mf
            and (lscope + "/post_feedforward_layer_norm/gamma") in mf
        )
        layers.append(
            DecoderLayerSpec(
                self_attention=attn,
                ffn=ffn,
                cross_attention=cross,
                sandwich_norm=sandwich,
                shared_layer_norm=(lscope + "/shared_layer_norm/gamma") in mf,
                input_layer_norm=not sandwich and (lscope + "/input_layer_norm/gamma") in mf,
                post_attention_layer_norm=not sandwich
                and (lscope + "/post_attention_layer_norm/gamma") in mf,
                external_pre_cross_norm=(
                    lscope + "/external_pre_encoder_attention_layer_norm/gamma"
                )
                in mf,
                external_post_cross_norm=(
                    lscope + "/external_post_encoder_attention_layer_norm/gamma"
                )
                in mf,
                layer_scalar=float(mf.attribute(lscope + "/layer_scalar", 1.0)),
            )
        )

    attn0 = layers[0].self_attention
    has_positional = (
        attn0.rotary is not None
        or attn0.has_rel_position_keys
        or attn0.has_rel_attention_bias
        or attn0.has_rel_asymmetric_keys
        or alibi
    )
    has_pe_table = (scope + "/position_encodings/encodings") in mf

    alignment_layer = int(mf.attribute(scope + "/alignment_layer", -1))
    alignment_heads = int(mf.attribute(scope + "/alignment_heads", 1))
    if alignment_layer < 0:
        alignment_layer += num_layers
    if alignment_heads == 0:
        alignment_heads = num_heads

    return DecoderSpec(
        num_layers=num_layers,
        num_heads=num_heads,
        embeddings=_extract_embeddings(mf, scope, 0),
        layers=tuple(layers),
        pre_norm=pre_norm,
        has_position_embedding=has_pe_table,
        sinusoidal_positions=not has_pe_table and not has_positional,
        has_layernorm_embedding=(scope + "/layernorm_embedding/gamma") in mf,
        has_output_norm=(scope + "/layer_norm/gamma") in mf,
        has_project_in=(scope + "/project_in/weight") in mf,
        has_project_out=(scope + "/project_out/weight") in mf,
        start_from_zero_embedding=mf.flag(scope + "/start_from_zero_embedding", False),
        with_cross_attention=layers[0].cross_attention is not None
        or layers[0].self_attention.has_memory_kv,
        alibi=alibi,
        alibi_use_positive_positions=mf.flag(scope + "/alibi_use_positive_positions", True),
        scale_alibi=mf.flag(scope + "/scale_alibi", False),
        sliding_window=int(mf.attribute(scope + "/sliding_window", 0)),
        alignment_layer=alignment_layer,
        alignment_heads=alignment_heads,
        final_logit_softcapping=float(mf.attribute(scope + "/final_logit_softcapping", 0.0)),
        has_outputs_scale=(scope + "/scale_outputs") in mf,
        has_projection=(scope + "/projection/weight") in mf,
    )


# Legacy spec names imply the head count (reference: src/models/model_factory.cc:13-29).
_LEGACY_NUM_HEADS = {"": 8, "TransformerBase": 8, "TransformerBig": 16}


def extract_arch(mf: ModelFile) -> ArchSpec:
    # Legacy models lack the num_heads attribute; register it like the
    # reference does (reference: src/models/transformer.cc:63-81).
    if mf.spec_name in _LEGACY_NUM_HEADS and "num_heads" not in mf:
        from ..formats.model_file import make_variable

        mf.variables["num_heads"] = make_variable(
            "num_heads", _LEGACY_NUM_HEADS[mf.spec_name], "int8"
        )
    if mf.spec_name in _LEGACY_NUM_HEADS or mf.spec_revision < 5:
        for side in ("encoder", "decoder"):
            for attr in ("num_heads", "pre_norm", "activation", "embeddings_merge"):
                mf.aliases.setdefault(f"{side}/{attr}", attr)

    ln_eps = mf.config.get("layer_norm_epsilon")

    return ArchSpec(
        spec_name=mf.spec_name,
        encoder=extract_encoder(mf),
        decoder=extract_decoder(mf),
        ln_epsilon=float(ln_eps) if ln_eps is not None else None,
    )
