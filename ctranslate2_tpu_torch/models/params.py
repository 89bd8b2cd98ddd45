"""Parameter dicts built from a model artifact.

Maps the artifact's scope-named variables into nested dicts of torch
tensors on one device:

- float linear weights are transposed to ``(in, out)``, as the JAX package
  lays them out;
- int8 weights keep the artifact layout ``(out, in)`` with per-output-
  channel scales: K-major, the operand layout of the W8A8 kernel. Float
  weights are quantized per row on load when the policy asks for int8
  (reference: src/models/model.cc:304-369);
- self-attention keeps the artifact's fused QKV projection as one linear
  (``qkv``); cross-attention K/V are split into ``k`` and ``v``;
- embeddings stay in gather layout ``(vocab, dim)``; int8 embeddings keep
  payload + scales and dequantize after the gather.

``params_from_numpy`` converts the JAX package's parameter tree (as numpy
arrays) into the same layout, so both packages can run on identical
weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.model_file import ModelFile, Variable
from ..utils.dtypes import DTypePolicy
from .spec import ArchSpec, AttentionSpec, DecoderSpec, EncoderSpec


def _dequantize(var: Variable, scale: Optional[Variable]) -> np.ndarray:
    q = var.array.astype(np.float32)
    if scale is None:
        if var.dtype_name == "int16":
            # Legacy int16 models carry no scale; the global scale is 1000
            # (reference: src/models/model.cc:310-316).
            return q / 1000.0
        return q
    s = scale.as_float32()
    if s.ndim == 0 or s.size == 1:
        return q / float(s.reshape(()))
    return q / s.reshape(s.shape + (1,) * (q.ndim - s.ndim))


def _quantize_per_row(w: np.ndarray):
    """Symmetric int8 row-wise quantization (rows = output channels)
    (reference: python/ctranslate2/specs/model_spec.py:228-244)."""
    amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))
    amax = np.where(amax > 0, amax, 1.0)
    scale = 127.0 / amax
    q = np.clip(np.rint(w * scale.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


class ParamsBuilder:
    def __init__(self, mf: ModelFile, policy: DTypePolicy, device):
        self.mf = mf
        self.policy = policy
        self.device = torch.device(device)
        self.float_dtype = policy.float_weight_torch

    def tensor(self, array: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def array(self, name: str, dtype=None) -> Optional[torch.Tensor]:
        var = self.mf.get(name)
        if var is None:
            return None
        return self.tensor(var.as_float32(), dtype or self.float_dtype)

    def linear(self, scope: str) -> Optional[dict]:
        var = self.mf.get(scope + "/weight")
        if var is None:
            return None
        if self.mf.get(scope + "/weight_zero") is not None:
            raise NotImplementedError("AWQ 4-bit weights are not ported yet")
        scale = self.mf.get(scope + "/weight_scale")
        out: dict = {}
        if self.policy.weight_dtype == "int8":
            if var.dtype_name == "int8":
                q = var.array
                s = scale.as_float32().reshape(-1)
                s = np.broadcast_to(s, (var.shape[0],)) if s.size == 1 else s
            else:
                w = (_dequantize(var, scale) if var.dtype_name == "int16"
                     else var.as_float32())
                q, s = _quantize_per_row(w)
            out["wq"] = self.tensor(q)
            out["scale"] = self.tensor(s, torch.float32)
        else:
            w = (_dequantize(var, scale) if var.dtype_name in ("int8", "int16")
                 else var.as_float32())
            out["w"] = self.tensor(w.T, self.float_dtype)
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
            return {"w": self.tensor(_dequantize(var, scale), self.float_dtype)}
        return {"w": self.tensor(var.as_float32(), self.float_dtype)}

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
                part["w"] = lin["w"][:, offset:offset + size].contiguous()
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
        return out

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
        if spec.num_conv_layers or spec.is_wav2vec2:
            raise NotImplementedError("speech encoders are not ported yet")

        def layer_fn(lscope, layer):
            return {"self_attention": self.attention(
                        f"{lscope}/self_attention", layer.self_attention),
                    "ffn": self.ffn(f"{lscope}/ffn")}

        return self._side(spec, scope, layer_fn)

    def decoder(self, spec: DecoderSpec, scope: str = "decoder") -> dict:
        def layer_fn(lscope, layer):
            lp = {"self_attention": self.attention(
                      f"{lscope}/self_attention", layer.self_attention),
                  "ffn": self.ffn(f"{lscope}/ffn")}
            if layer.cross_attention is not None:
                lp["attention"] = self.attention(
                    f"{lscope}/attention", layer.cross_attention)
            return lp

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
                 device="cpu") -> dict:
    builder = ParamsBuilder(mf, policy, device)
    params: dict = {}
    if arch.encoder is not None:
        params["encoder"] = builder.encoder(arch.encoder)
    if arch.decoder is not None:
        params["decoder"] = builder.decoder(arch.decoder)
    return params


def params_from_numpy(jax_params, arch: ArchSpec, *, device="cpu",
                      float_dtype=torch.float32) -> dict:
    """Convert the JAX package's ``LoadedModel.params`` tree (leaves as
    numpy arrays, float QKV fused, unstacked layers) into the port's
    params: int8 ``wq`` goes from (in, out) back to (out, in); float
    weights keep (in, out) and take ``float_dtype``; scales, biases and
    norms stay float32."""
    device = torch.device(device)

    def leaf(a, dtype=None):
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        return t.to(device=device, dtype=dtype or t.dtype)

    def convert(node, key=None):
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
