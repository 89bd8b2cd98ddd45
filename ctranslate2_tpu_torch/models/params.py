"""Parameter dicts built from a model artifact.

Maps the artifact's scope-named variables into nested dicts of torch
tensors on one device:

- float linear weights are transposed to ``(in, out)``, as the JAX package
  lays them out;
- int8 weights keep the artifact layout ``(out, in)`` with per-output-
  channel scales: K-major, the operand layout of the W8A8 kernel. Float
  weights are quantized per row on load when the policy asks for int8
  (reference: src/models/model.cc:304-369);
- AWQ 4-bit weights become ``w4`` int8 (q - z) [in, out] or packed ``w4p``
  bytes [in/2, out], with f32 group scales ``g_scale`` (and ``g_zs``,
  zero * scale, for ``w4p``) [in/G, out]: the JAX package's layouts;
- self-attention keeps the artifact's fused QKV projection as one linear
  (``qkv``); cross-attention K/V are split into ``k`` and ``v``;
- embeddings stay in gather layout ``(vocab, dim)``; int8 embeddings keep
  payload + scales and dequantize after the gather;
- the relative-position tables (Shaw keys/values, the T5 bucket table) stay
  float32; merged attention's ``memory_kv`` is one fused linear; the
  layer-level norms of sandwich and parallel-residual layers sit in the
  layer's dict under their artifact names;
- convolution weights (the speech frontends) are float32 [C_out,
  C_in/groups, K], dequantized on load when the artifact stores them in
  int8, as the JAX package keeps them.

The variables are views into ``model.bin``'s map, possibly read-only or
unaligned: every payload goes through ``utils.transfer.to_device``, which
uploads a view to the card as it is and copies on the CPU only what
cannot be shared safely.

``params_from_numpy`` converts the JAX package's parameter tree (as numpy
arrays) into the same layout, so both packages can run on identical
weights (its stacked-layer tree too); ``cache_from_numpy`` does the same
for a self-attention KV cache.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..formats.model_file import ModelFile, Variable
from ..ops.awq import AWQ_GEMM, build_awq_linear_lazy
from ..utils.dtypes import DTypePolicy
from ..utils.transfer import to_device
from .spec import ArchSpec, AttentionSpec, DecoderSpec, EncoderSpec


def _dequantize(var: Variable, scale: Optional[Variable], device) -> torch.Tensor:
    """An int8 or int16 payload as float32 on ``device``. It travels as
    stored, a quarter or half of its float32 bytes, and is divided by its
    scale there (an 8B model's int8 projection is 0.5 GB). The divisor is
    always a float32 tensor, which gives numpy's ``q / s`` to the bit: a
    Python-scalar divisor is multiplied by its reciprocal on the card."""
    q = to_device(var.array, device, torch.float32)
    if scale is None:
        if var.dtype_name != "int16":
            return q
        # Legacy int16 models carry no scale; the global scale is 1000
        # (reference: src/models/model.cc:310-316).
        s = np.full((1,), 1000.0, np.float32)
    else:
        s = scale.as_float32()
        s = (s.reshape(1) if s.size == 1
             else s.reshape(s.shape + (1,) * (q.ndim - s.ndim)))
    return q / torch.from_numpy(np.ascontiguousarray(s)).to(device)


def _quantize_per_row(w: np.ndarray):
    """Symmetric int8 row-wise quantization (rows = output channels)
    (reference: python/ctranslate2/specs/model_spec.py:228-244)."""
    amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
    amax = np.where(amax > 0, amax, 1.0)
    scale = 127.0 / amax
    q = np.clip(np.rint(w * scale.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


# The layer-level norms of sandwich-norm (Gemma-2/3, T5Gemma) and
# parallel-residual (GPT-J, GPT-NeoX, Falcon) layers.
ENCODER_LAYER_NORMS = ("input_layer_norm", "post_attention_layer_norm",
                       "pre_feedforward_layer_norm", "post_feedforward_layer_norm")
DECODER_LAYER_NORMS = ("shared_layer_norm",) + ENCODER_LAYER_NORMS + (
    "external_pre_encoder_attention_layer_norm",
    "external_post_encoder_attention_layer_norm")


class ParamsBuilder:
    def __init__(self, mf: ModelFile, policy: DTypePolicy, device, target=None):
        self.mf = mf
        self.policy = policy
        self.device = torch.device(device)
        # The device the params will run on, where they are built elsewhere
        # first (tensor parallelism shards on the host): it picks the
        # layouts that depend on the device.
        self.target = torch.device(target) if target is not None else self.device
        self.float_dtype = policy.float_weight_torch

    def tensor(self, array: np.ndarray, dtype=None) -> torch.Tensor:
        return to_device(array, self.device, dtype)

    def float_tensor(self, var: Variable, dtype, transpose: bool = False) -> torch.Tensor:
        """A float variable in ``dtype`` on the device. float16 and float32
        payloads travel as they are stored and are converted (and
        transposed) there, not on the host: an 8B model's float16
        embeddings and projection are 1 GB each. bfloat16, stored as raw
        bits, goes through float32 on the host."""
        t = self.tensor(var.as_float32() if var.dtype_name == "bfloat16" else var.array)
        t = t.to(dtype)
        return t.t().contiguous() if transpose else t

    def array(self, name: str, dtype=None) -> Optional[torch.Tensor]:
        var = self.mf.get(name)
        if var is None:
            return None
        return self.float_tensor(var, dtype or self.float_dtype)

    def linear(self, scope: str) -> Optional[dict]:
        var = self.mf.get(scope + "/weight")
        if var is None:
            return None
        scale = self.mf.get(scope + "/weight_scale")
        zero = self.mf.get(scope + "/weight_zero")
        out: dict = {}
        if zero is not None:
            out = self.awq_linear(var, scale, zero)
        elif self.policy.weight_dtype == "int8":
            if var.dtype_name == "int8":
                q = var.array
                s = scale.as_float32().reshape(-1)
                s = np.broadcast_to(s, (var.shape[0],)) if s.size == 1 else s
            else:
                w = (_dequantize(var, scale, "cpu").numpy() if var.dtype_name == "int16"
                     else var.as_float32())
                q, s = _quantize_per_row(w)
            out["wq"] = self.tensor(q)
            out["scale"] = self.tensor(s, torch.float32)
        elif var.dtype_name in ("int8", "int16"):
            out["w"] = (_dequantize(var, scale, self.device).t()
                        .to(self.float_dtype).contiguous())
        else:
            out["w"] = self.float_tensor(var, self.float_dtype, transpose=True)
        bias = self.mf.get(scope + "/bias")
        if bias is not None:
            out["b"] = self.tensor(bias.as_float32(), torch.float32)
        return out

    def awq_linear(self, var: Variable, scale: Variable, zero: Variable) -> dict:
        """AWQ 4-bit group quantization (reference:
        python/ctranslate2/converters/transformers.py:237-248), kept W4
        whatever the compute type asks, as in the reference. The payload
        is unpacked on the model's device into the packed ``w4p`` layout
        when ``CT2TPU_W4_PACKED=1``, or when it is unset and the device is
        a CUDA card; otherwise into the unpacked ``w4`` layout."""
        quant_type = int(self.mf.config.get("quantization_type", AWQ_GEMM))
        packed_env = os.environ.get("CT2TPU_W4_PACKED")
        use_packed = (packed_env == "1" if packed_env is not None
                      else self.target.type == "cuda")
        # Packed rows split the in-dim in half: it must be even.
        payload_in = var.shape[0] if quant_type == AWQ_GEMM else var.shape[1] * 8
        return build_awq_linear_lazy(
            var.array, scale.as_float32(), zero.array, quant_type,
            packed=use_packed and payload_in % 2 == 0, device=self.device)

    def conv(self, scope: str) -> Optional[dict]:
        var = self.mf.get(scope + "/weight")
        if var is None:
            return None
        out = {"w": (_dequantize(var, self.mf.get(scope + "/weight_scale"), self.device)
                     if var.dtype_name in ("int8", "int16")
                     else self.tensor(var.as_float32(), torch.float32))}
        bias = self.mf.get(scope + "/bias")
        if bias is not None:
            out["b"] = self.tensor(bias.as_float32(), torch.float32)
        return out

    def norm(self, scope: str) -> Optional[dict]:
        gamma = self.mf.get(scope + "/gamma")
        if gamma is None:
            return None
        g = gamma.as_float32()
        if self.mf.flag(scope + "/layer_norm_use_residual", False):
            # Gemma RMSNorm variant: x * rms * (1 + gamma).
            g = g + 1.0
        out = {"gamma": self.tensor(g, torch.float32)}
        beta = self.mf.get(scope + "/beta")
        if beta is not None:
            out["beta"] = self.tensor(beta.as_float32(), torch.float32)
        return out

    def embeddings(self, scope: str) -> Optional[dict]:
        var = self.mf.get(scope + "/weight")
        if var is None:
            return None
        scale = self.mf.get(scope + "/weight_scale")
        if var.dtype_name == "int8":
            s = scale.as_float32()
            if not s.ndim:
                s = np.full((var.shape[0],), float(s), np.float32)
            return {"wq": self.tensor(var.array),
                    "scale": self.tensor(s, torch.float32)}
        if var.dtype_name == "int16":
            return {"w": _dequantize(var, scale, self.device).to(self.float_dtype)}
        return {"w": self.float_tensor(var, self.float_dtype)}

    def _split_linear(self, lin: dict, sizes) -> list:
        """Split a fused linear along the output axis."""
        outs = []
        offset = 0
        for size in sizes:
            part = {}
            if "wq" in lin:
                part["wq"] = lin["wq"][offset:offset + size].contiguous()
                part["scale"] = lin["scale"][offset:offset + size].contiguous()
            else:
                # float (in, out) and both W4 layouts: the output axis is last.
                for key in ("w", "w4", "w4p", "g_scale", "g_zs"):
                    if key in lin:
                        part[key] = lin[key][:, offset:offset + size].contiguous()
            if "b" in lin:
                part["b"] = lin["b"][offset:offset + size].contiguous()
            outs.append(part)
            offset += size
        return outs

    def attention(self, scope: str, spec: AttentionSpec) -> dict:
        Hkv, D = spec.num_heads_kv, spec.head_dim
        out: dict = {}
        if spec.self_attention:
            out["qkv"] = self.linear(f"{scope}/linear_0")
            out["o"] = self.linear(f"{scope}/linear_1")
        else:
            out["q"] = self.linear(f"{scope}/linear_0")
            out["k"], out["v"] = self._split_linear(
                self.linear(f"{scope}/linear_1"), [Hkv * D, Hkv * D])
            out["o"] = self.linear(f"{scope}/linear_2")
        for name in ("layer_norm", "q_norm", "k_norm", "v_norm"):
            n = self.norm(f"{scope}/{name}")
            if n is not None:
                out[name] = n
        for name in ("relative_attention_bias", "relative_position_keys",
                     "relative_asymmetric_position_keys", "relative_position_values"):
            arr = self.array(f"{scope}/{name}", torch.float32)
            if arr is not None:
                out[name] = arr
        if spec.rotary is not None and spec.rotary.has_long_short_factors:
            out["rotary_long_factor"] = self.array(
                f"{scope}/rotary_scaling_long_factor", torch.float32)
            out["rotary_short_factor"] = self.array(
                f"{scope}/rotary_scaling_short_factor", torch.float32)
        if spec.has_memory_kv:
            out["memory_kv"] = self.linear(f"{scope}/memory_kv")
        return out

    def layer_norms(self, lp: dict, lscope: str, names) -> dict:
        """Adds the layer-level norms ``names`` that the artifact holds."""
        for name in names:
            n = self.norm(f"{lscope}/{name}")
            if n is not None:
                lp[name] = n
        return lp

    def ffn(self, scope: str) -> dict:
        out = {"linear_0": self.linear(f"{scope}/linear_0"),
               "linear_1": self.linear(f"{scope}/linear_1")}
        noact = self.linear(f"{scope}/linear_0_noact")
        if noact is not None:
            out["linear_0_noact"] = noact
        ln = self.norm(f"{scope}/layer_norm")
        if ln is not None:
            out["layer_norm"] = ln
        return out

    def parallel_embeddings(self, scope: str, num_features: int) -> list:
        if num_features == 1:
            emb = self.embeddings(f"{scope}/embeddings")
            if emb is None:
                emb = self.embeddings(f"{scope}/embeddings_0")
            return [emb]
        return [self.embeddings(f"{scope}/embeddings_{i}")
                for i in range(num_features)]

    def _side(self, spec, scope: str, layer_fn) -> dict:
        out: dict = {
            "embeddings": self.parallel_embeddings(
                scope, spec.embeddings.num_features),
            "layers": [layer_fn(f"{scope}/layer_{i}", layer)
                       for i, layer in enumerate(spec.layers)],
        }
        if spec.has_position_embedding:
            out["position_encodings"] = self.array(
                f"{scope}/position_encodings/encodings")
        for name in ("layernorm_embedding", "layer_norm"):
            n = self.norm(f"{scope}/{name}")
            if n is not None:
                out[name] = n
        return out

    def encoder(self, spec: EncoderSpec, scope: str = "encoder") -> dict:
        def layer_fn(lscope, layer):
            return self.layer_norms(
                {"self_attention": self.attention(
                    f"{lscope}/self_attention", layer.self_attention),
                 "ffn": self.ffn(f"{lscope}/ffn")},
                lscope, ENCODER_LAYER_NORMS)

        if not (spec.num_conv_layers or spec.is_wav2vec2):
            return self._side(spec, scope, layer_fn)
        # A speech encoder: a convolution frontend in place of embeddings.
        out: dict = {"layers": [layer_fn(f"{scope}/layer_{i}", layer)
                                for i, layer in enumerate(spec.layers)]}
        if spec.is_wav2vec2:
            # Wav2Vec2 (reference: src/layers/wav2vec2.cc:48-72).
            def feat(name):
                return {"conv": self.conv(f"{scope}/{name}/conv"),
                        "layer_norm": self.norm(f"{scope}/{name}/layer_norm")}
            out["feat_layer0"] = feat("feat_layer0")
            out["feat_layers"] = [feat(f"feat_layer_{i}")
                                  for i in range(spec.num_feat_layers)]
            out["fp_layer_norm"] = self.norm(f"{scope}/fp_layer_norm")
            out["fp_projection"] = self.linear(f"{scope}/fp_projection")
            out["pos_conv_embed"] = {"conv": self.conv(f"{scope}/pos_conv_embed/conv")}
            if spec.has_lm_head:
                out["lm_head"] = self.linear(f"{scope}/lm_head")
        else:
            # Whisper (reference: src/layers/whisper.cc:8-23).
            out["convs"] = [self.conv(f"{scope}/conv{i + 1}")
                            for i in range(spec.num_conv_layers)]
        if spec.has_position_embedding:
            out["position_encodings"] = self.array(
                f"{scope}/position_encodings/encodings")
        norm = self.norm(f"{scope}/layer_norm")
        if norm is not None:
            out["layer_norm"] = norm
        return out

    def decoder(self, spec: DecoderSpec, scope: str = "decoder") -> dict:
        def layer_fn(lscope, layer):
            lp = {"self_attention": self.attention(
                      f"{lscope}/self_attention", layer.self_attention),
                  "ffn": self.ffn(f"{lscope}/ffn")}
            if layer.cross_attention is not None:
                lp["attention"] = self.attention(
                    f"{lscope}/attention", layer.cross_attention)
            return self.layer_norms(lp, lscope, DECODER_LAYER_NORMS)

        out = self._side(spec, scope, layer_fn)
        for name in ("project_in", "project_out", "projection"):
            lin = self.linear(f"{scope}/{name}")
            if lin is not None:
                out[name] = lin
        if spec.has_outputs_scale:
            out["scale_outputs"] = self.array(f"{scope}/scale_outputs",
                                              torch.float32)
        return out


def build_params(mf: ModelFile, arch: ArchSpec, policy: DTypePolicy,
                 device="cpu", target=None) -> dict:
    builder = ParamsBuilder(mf, policy, device, target)
    params: dict = {}
    if arch.encoder is not None:
        params["encoder"] = builder.encoder(arch.encoder)
    if arch.decoder is not None:
        params["decoder"] = builder.decoder(arch.decoder)
    return params


def params_from_numpy(jax_params, arch: ArchSpec, *, device="cpu",
                      float_dtype=torch.float32) -> dict:
    """Convert the JAX package's ``LoadedModel.params`` tree (leaves as
    numpy arrays, float QKV fused) into the port's params: int8 ``wq``
    goes from (in, out) back to (out, in); float weights keep (in, out) and
    take ``float_dtype``; scales, biases, norms and relative-position tables
    stay float32. AWQ leaves (``w4``, ``w4p``, ``g_scale``, ``g_zs``) keep
    their layouts and types. A stacked layer tree (``stack_layers=True``:
    one dict whose leaves carry the layer axis first) is split by layer."""
    device = torch.device(device)

    def unstack(tree, i):
        if isinstance(tree, dict):
            return {k: unstack(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def leaf(a, dtype=None):
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        return t.to(device=device, dtype=dtype or t.dtype)

    def convert(node, key=None):
        if key == "layers" and isinstance(node, dict):
            num_layers = len(arch.decoder.layers)
            return [convert(unstack(node, i)) for i in range(num_layers)]
        if isinstance(node, dict):
            if "wq" in node and "scale" in node and np.ndim(node["wq"]) == 2 \
                    and key != "embeddings":
                out = {"wq": leaf(np.asarray(node["wq"]).T),
                       "scale": leaf(node["scale"], torch.float32)}
                if "b" in node:
                    out["b"] = leaf(node["b"], torch.float32)
                return out
            if "w" in node and np.ndim(node["w"]) == 2 and key != "embeddings":
                out = {"w": leaf(node["w"], float_dtype)}
                if "b" in node:
                    out["b"] = leaf(node["b"], torch.float32)
                return out
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if key == "embeddings":
                return [{k: leaf(v, float_dtype if k == "w" else None)
                         for k, v in e.items()} for e in node]
            return [convert(v) for v in node]
        arr = np.asarray(node)
        return leaf(arr, float_dtype if arr.dtype.kind == "f"
                    and key == "position_encodings" else
                    (torch.float32 if arr.dtype.kind == "f" else None))

    return convert(jax_params)


def cache_from_numpy(jax_cache, device="cpu"):
    """The JAX package's self cache, float or int8 layout, with its leaves as
    numpy arrays, as the port's per-layer list on ``device``. The stacked
    layout ({"k": [L, N, ...], ...}) is split by layer."""
    def leaf(a):
        return torch.from_numpy(np.array(a)).to(device)

    if isinstance(jax_cache, dict):
        num_layers = next(iter(jax_cache.values())).shape[0]
        jax_cache = [{name: a[i] for name, a in jax_cache.items()}
                     for i in range(num_layers)]
    return [{name: leaf(a) for name, a in layer.items()} for layer in jax_cache]
