"""Wav2Vec2 and Wav2Vec2Bert: encoder-only speech-to-logits APIs (CTC
decoding happens outside, as in the reference: src/models/wav2vec2.cc,
src/layers/wav2vec2.cc, src/models/wav2vec2bert.cc).

Port of ``ctranslate2_tpu/runtime/wav2vec2.py``. Both run on one CUDA card
by default, or on the CPU when ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats.model_file import ModelFile, load_model_file
from ..models import transformer as T
from ..models import wav2vec2bert as W
from ..models.loader import LoadedModel, load_model, resolve_device
from ..ops.activations import gelu
from ..ops.conv import conv1d
from ..ops.linear import linear
from ..utils.dtypes import resolve_compute_type
from .base import ModelResidency, TaskAPIMixin


def wav2vec2_forward(arch, params: dict, consts: dict, features,
                     quantize_acts: bool = True, out_dtype=torch.float32):
    """Wav2Vec2: raw features [B, C, T] -> CTC logits, or the hidden states
    without a CTC head (reference: src/layers/wav2vec2.cc:74-125)."""
    spec = arch.encoder
    ep = params["encoder"]

    def conv_ln_gelu(layer, x, stride):
        # conv -> LayerNorm over the channels -> GELU (reference:
        # Wav2Vec2LayerNormConvLayer, wav2vec2.cc:18-28). The norm reads a
        # contiguous [B * T', C] copy of the transposed output.
        x = conv1d(x, layer["conv"]["w"], layer["conv"].get("b"), stride=stride)
        x = T._norm(arch, layer["layer_norm"], x.transpose(1, 2).contiguous())
        return gelu(x.transpose(1, 2))

    x = conv_ln_gelu(ep["feat_layer0"], features.float(), stride=5)
    for layer in ep["feat_layers"]:
        x = conv_ln_gelu(layer, x, stride=2)
    x = x.transpose(1, 2).to(out_dtype)  # [B, T', C]

    # The feature projection.
    x = T._norm(arch, ep["fp_layer_norm"], x)
    x = linear(ep["fp_projection"], x, quantize_activations=quantize_acts)

    # The positional convolution: grouped (16 groups, padding 64), the last
    # frame dropped, GELU, added to the input (reference:
    # wav2vec2.cc:30-46).
    pc = ep["pos_conv_embed"]["conv"]
    xt = x.transpose(1, 2)
    pos = conv1d(xt, pc["w"], pc.get("b"), padding=64, groups=16)[:, :, :xt.shape[2]]
    x = x + gelu(pos).transpose(1, 2).to(x.dtype)

    # The pre-norm stack; its output norm quantizes for the CTC head.
    head = ep["lm_head"] if spec.has_lm_head else None
    x = T.pre_norm_stack(arch, spec, ep, x, quantize_acts, after=head)
    if head is not None:
        x = linear(head, x, quantize_activations=quantize_acts)
    return x


class Wav2Vec2(TaskAPIMixin):
    """Wav2Vec2 on one device. ``device`` is ``"cuda"`` (the default;
    raises without CUDA) or ``"cpu"``; ``flash_attention=True`` sends the
    stack's attention to the flash kernel on the card whatever its
    length."""

    def __init__(self, model_path: str, device: Optional[str] = None,
                 compute_type: str = "default", device_index=0,
                 inter_threads: int = 1, intra_threads: int = 0,
                 max_queued_batches: int = 0, **kwargs):
        if kwargs.get("tensor_parallel"):
            raise NotImplementedError("tensor parallelism is not ported yet")
        self.model: LoadedModel = load_model(
            model_path, compute_type=compute_type, files=kwargs.get("files"),
            device=resolve_device(device, device_index))
        enc = self.model.arch.encoder
        if enc is None or not enc.is_wav2vec2:
            raise ValueError(f"The model at {model_path} is not a Wav2Vec2 model")
        self._apply_flash_flag(kwargs)
        self._init_replicas(device, device_index)
        self._start_pool(inter_threads, max_queued_batches, kwargs)

    def encode(self, features, to_cpu: bool = False):
        """[B, C, T] raw features -> CTC logits [B, T', vocabulary] (or the
        hidden states when the model has no CTC head); on the CPU with
        ``to_cpu``."""
        model = self.model
        out = wav2vec2_forward(model.arch, model.params, model.consts,
                               torch.as_tensor(features).to(model.device),
                               quantize_acts=model.policy.quantize_activations,
                               out_dtype=model.out_dtype)
        return out.cpu() if to_cpu else out


class Wav2Vec2Bert(ModelResidency):
    """The conformer speech encoder (reference: src/models/wav2vec2bert.cc,
    python/cpp/wav2vec2bert.cc): features -> CTC logits or hidden states.
    ``device`` is ``"cuda"`` (the default; raises without CUDA) or
    ``"cpu"``. Its weights are ``self.params``; ``encode`` runs in the
    caller's thread, so no batch is ever pending on an unload."""

    def __init__(self, model_path: str, device: Optional[str] = None,
                 compute_type: str = "default", device_index=0, **kwargs):
        if kwargs.get("tensor_parallel"):
            raise NotImplementedError("tensor parallelism is not ported yet")
        self._device = resolve_device(device, device_index)
        # A directory, or a ModelFile already in memory (as load_model takes).
        self.mf = (model_path if isinstance(model_path, ModelFile)
                   else load_model_file(model_path))
        if not W.is_wav2vec2bert(self.mf):
            raise ValueError(f"The model at {model_path} is not a Wav2Vec2Bert model")
        self.spec = W.extract_wav2vec2bert(self.mf)
        # As in the JAX package, the policy takes float32 as the stored type.
        self.policy = resolve_compute_type(compute_type, "float32", self._device.type)
        self.params = W.build_wav2vec2bert_params(self.mf, self.spec, self.policy,
                                                  self._device)
        self.device_index = device_index

    @property
    def device(self) -> str:
        return self._device.type

    @property
    def compute_type(self) -> str:
        p = self.policy
        if p.weight_dtype == "int8":
            return ("int8_" + p.activation_dtype
                    if p.activation_dtype != "float32" else "int8")
        return p.weight_dtype

    def _resident(self):
        return self

    def _resident_device(self) -> torch.device:
        return self._device

    @property
    def num_active_batches(self) -> int:
        return 0

    def encode(self, features, to_cpu: bool = False):
        """[B, T, C_feat] input features -> logits [B, T', vocabulary] (or
        the hidden states without a CTC head); float32 on the CPU with
        ``to_cpu``."""
        out = W.wav2vec2bert_forward(
            self.spec, self.params, torch.as_tensor(features).to(self._device),
            quantize_acts=self.policy.quantize_activations,
            out_dtype=self.policy.activation_torch)
        return out.float().cpu() if to_cpu else out
