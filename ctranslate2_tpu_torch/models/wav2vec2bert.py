"""The Wav2Vec2Bert (conformer) encoder: spec, params and forward.

Port of ``ctranslate2_tpu/models/wav2vec2bert.py`` (reference:
src/layers/wav2vec2bert.cc, python wav2vec2bert_spec.py): the feature
projection, then N conformer layers (half-step FFNs around self-attention
with asymmetric relative position keys, and the convolution module: a
pointwise GLU, a causal depthwise convolution, LayerNorm, swish, a
pointwise convolution), then M adapter layers (stride-2 GLU convolutions,
attention, a ReLU FFN), then the optional CTC head.

Artifact scopes: ``encoder/fp_layer_norm``, ``encoder/encoder_layers_i/*``,
``encoder/adapter_layers_i/*``, ``encoder/lm_head``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..formats.model_file import ModelFile
from ..ops import attention as attn_ops
from ..ops.activations import relu, swish
from ..ops.conv import conv1d
from ..ops.linear import linear
from ..ops.norms import apply_norm
from .params import ParamsBuilder


@dataclass(frozen=True)
class Wav2Vec2BertSpec:
    num_encoder_layers: int
    num_adapter_layers: int
    num_heads: int
    rel_left_max: int
    rel_right_max: int
    has_lm_head: bool


def extract_wav2vec2bert(mf: ModelFile) -> Wav2Vec2BertSpec:
    sc = "encoder"
    n_enc = 0
    while f"{sc}/encoder_layers_{n_enc}/enc_ffn1/linear_0/weight" in mf:
        n_enc += 1
    n_adpt = 0
    while f"{sc}/adapter_layers_{n_adpt}/adpt_ffn/linear_0/weight" in mf:
        n_adpt += 1
    l0 = f"{sc}/encoder_layers_0"
    return Wav2Vec2BertSpec(
        num_encoder_layers=n_enc,
        num_adapter_layers=n_adpt,
        # The reference defaults to 16 heads where the spec serializes none
        # (reference: src/layers/wav2vec2bert.cc:11).
        num_heads=int(mf.attribute(f"{l0}/enc_attn/num_heads",
                                   mf.attribute(f"{l0}/num_heads", 16))),
        rel_left_max=int(mf.attribute(f"{l0}/enc_attn/relative_left_max_position", 0)),
        rel_right_max=int(mf.attribute(f"{l0}/enc_attn/relative_right_max_position", 0)),
        has_lm_head=f"{sc}/lm_head/weight" in mf,
    )


def is_wav2vec2bert(mf: ModelFile) -> bool:
    return (mf.spec_name == "Wav2Vec2BertSpec"
            or "encoder/encoder_layers_0/enc_ffn1/linear_0/weight" in mf)


def build_wav2vec2bert_params(mf: ModelFile, spec: Wav2Vec2BertSpec, policy,
                              device="cpu") -> dict:
    b = ParamsBuilder(mf, policy, device)
    sc = "encoder"

    def ffn(scope):
        return {"linear_0": b.linear(f"{scope}/linear_0"),
                "linear_1": b.linear(f"{scope}/linear_1")}

    out = {"fp_layer_norm": b.norm(f"{sc}/fp_layer_norm"),
           "fp_projection": b.linear(f"{sc}/fp_projection"),
           "encoder_layers": [], "adapter_layers": []}
    for i in range(spec.num_encoder_layers):
        ls = f"{sc}/encoder_layers_{i}"
        attn = ffn(f"{ls}/enc_attn")
        rel = b.array(f"{ls}/enc_attn/relative_asymmetric_position_keys", torch.float32)
        if rel is not None:
            attn["relative_asymmetric_position_keys"] = rel
        lp = {"enc_attn": attn, "enc_ffn1": ffn(f"{ls}/enc_ffn1"),
              "enc_ffn2": ffn(f"{ls}/enc_ffn2")}
        for name in ("enc_ffn1_layer_norm", "enc_attn_layer_norm", "enc_conv_layer_norm",
                     "enc_conv_depthwise_layer_norm", "enc_ffn2_layer_norm",
                     "enc_final_layer_norm"):
            lp[name] = b.norm(f"{ls}/{name}")
        for name in ("enc_conv_pointwise_conv1", "enc_conv_depthwise_conv",
                     "enc_conv_pointwise_conv2"):
            lp[name] = b.conv(f"{ls}/{name}")
        out["encoder_layers"].append(lp)
    for i in range(spec.num_adapter_layers):
        ls = f"{sc}/adapter_layers_{i}"
        lp = {"adpt_attn_layer": ffn(f"{ls}/adpt_attn_layer"),
              "adpt_ffn": ffn(f"{ls}/adpt_ffn")}
        for name in ("adpt_residual_layer_norm", "adpt_attn_layer_norm",
                     "adpt_ffn_layer_norm"):
            lp[name] = b.norm(f"{ls}/{name}")
        for name in ("adpt_residual_conv", "adpt_attn_conv"):
            lp[name] = b.conv(f"{ls}/{name}")
        out["adapter_layers"].append(lp)
    if spec.has_lm_head:
        out["lm_head"] = b.linear(f"{sc}/lm_head")
    return out


def _norm(p, x, eps=1e-5):
    return x if p is None else apply_norm(p, x, eps)


def _glu_channels(x):
    """GLU over the channel axis of [B, C, T]: the first half times the
    sigmoid of the second (reference: src/layers/wav2vec2bert.cc:72-76)."""
    a, g = x.chunk(2, dim=1)
    return a * torch.sigmoid(g)


def _self_attention(ap: dict, spec: Wav2Vec2BertSpec, x, *, rel=False,
                    quantize_acts=True):
    """Fused-QKV self-attention, with the asymmetric relative position keys
    where ``rel`` (reference: src/layers/attention.cc:128-165)."""
    H = spec.num_heads
    q, k, v = linear(ap["linear_0"], x, quantize_activations=quantize_acts).chunk(3, dim=-1)
    q, k, v = (attn_ops.split_heads(t, H) for t in (q, k, v))
    rel_positions = rel_keys = None
    if rel and "relative_asymmetric_position_keys" in ap:
        T = x.shape[1]
        rel_positions = attn_ops.make_relative_positions(
            T, T, 0, asymmetric=True, left_max=spec.rel_left_max,
            right_max=spec.rel_right_max, device=x.device)
        rel_keys = ap["relative_asymmetric_position_keys"]
    ctx = attn_ops.dot_product_attention(
        q, k, v, queries_scale=1.0 / (q.shape[-1] ** 0.5),
        rel_position_keys=rel_keys, rel_positions=rel_positions)
    return linear(ap["linear_1"], attn_ops.combine_heads(ctx),
                  quantize_activations=quantize_acts)


def _half_ffn(lnp, fp, x, activation, quantize_acts):
    """The conformer's half-step FFN, ``x + 0.5 * ffn(ln(x))`` (reference:
    src/layers/wav2vec2bert.cc:44-48)."""
    h = linear(fp["linear_0"], _norm(lnp, x), activation=activation,
               quantize_activations=quantize_acts)
    h = linear(fp["linear_1"], h, quantize_activations=quantize_acts)
    return x + 0.5 * h


def _conv(p, h, **kw):
    return conv1d(h, p["w"], p.get("b"), **kw)


def _conformer_conv(lp, x):
    """The convolution module: LN, pointwise GLU, causal depthwise, LN,
    swish, pointwise (reference: src/layers/wav2vec2bert.cc:64-89)."""
    h = _norm(lp["enc_conv_layer_norm"], x).transpose(1, 2)  # [B, C, T]
    h = _glu_channels(_conv(lp["enc_conv_pointwise_conv1"], h))
    dw = lp["enc_conv_depthwise_conv"]
    K = dw["w"].shape[-1]
    # Causal: K - 1 zero frames on the left (reference: wav2vec2bert.cc:78-83).
    h = _conv(dw, F.pad(h, (K - 1, 0)), groups=dw["w"].shape[0])
    h = swish(_norm(lp["enc_conv_depthwise_layer_norm"], h.transpose(1, 2)))
    h = _conv(lp["enc_conv_pointwise_conv2"], h.transpose(1, 2)).transpose(1, 2)
    return h + x


def wav2vec2bert_forward(spec: Wav2Vec2BertSpec, params: dict, features,
                         quantize_acts: bool = True, out_dtype=torch.float32):
    """[B, T, C_feat] input features -> CTC logits (or hidden states)
    (reference call path: src/layers/wav2vec2bert.cc:166-215)."""
    qa = quantize_acts
    x = features.to(out_dtype)
    x = linear(params["fp_projection"], _norm(params["fp_layer_norm"], x),
               quantize_activations=qa)

    for lp in params["encoder_layers"]:
        x = _half_ffn(lp["enc_ffn1_layer_norm"], lp["enc_ffn1"], x, swish, qa)
        h = _norm(lp["enc_attn_layer_norm"], x)
        x = x + _self_attention(lp["enc_attn"], spec, h, rel=True, quantize_acts=qa)
        x = _conformer_conv(lp, x)
        x = _half_ffn(lp["enc_ffn2_layer_norm"], lp["enc_ffn2"], x, swish, qa)
        x = _norm(lp["enc_final_layer_norm"], x)

    for lp in params["adapter_layers"]:
        # The residual branch: LN, stride-2 GLU convolution (reference:
        # wav2vec2bert.cc:122-137).
        h = _norm(lp["adpt_residual_layer_norm"], x).transpose(1, 2)
        residual = _glu_channels(_conv(lp["adpt_residual_conv"], h, stride=2,
                                       padding=1)).transpose(1, 2)
        # The attention branch: LN, stride-2 GLU convolution, attention.
        h = _norm(lp["adpt_attn_layer_norm"], x).transpose(1, 2)
        h = _glu_channels(_conv(lp["adpt_attn_conv"], h, stride=2,
                                padding=1)).transpose(1, 2)
        x = _self_attention(lp["adpt_attn_layer"], spec, h, quantize_acts=qa) + residual
        # A full-step ReLU FFN (reference: wav2vec2bert.cc:175-179).
        h = linear(lp["adpt_ffn"]["linear_0"], _norm(lp["adpt_ffn_layer_norm"], x),
                   activation=relu, quantize_activations=qa)
        x = x + linear(lp["adpt_ffn"]["linear_1"], h, quantize_activations=qa)

    if spec.has_lm_head:
        x = linear(params["lm_head"], x, quantize_activations=qa)
    return x
