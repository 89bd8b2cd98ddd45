"""Model loading: artifact directory -> (spec, params, consts, vocabularies)."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..formats.model_file import (ModelFile, load_model_file,
                                  load_model_file_from_files)
from ..formats.vocabulary import Vocabulary, VocabularyInfo
from ..utils.dtypes import DTypePolicy, resolve_compute_type
from . import transformer
from .params import build_params
from .spec import ArchSpec, extract_arch


def _weights_dtype(mf: ModelFile) -> str:
    """Dtype of the model's linear weights on disk."""
    for name, var in mf.variables.items():
        if name.endswith("/weight") and len(var.shape) == 2 and "embeddings" not in name:
            if var.dtype_name == "int32" and (name + "_zero") in mf.variables:
                return "float16"  # AWQ payload (not ported yet)
            return var.dtype_name
    return "float32"


@dataclass
class LoadedModel:
    mf: ModelFile
    arch: ArchSpec
    params: dict
    policy: DTypePolicy
    consts: dict
    device: torch.device
    source_vocabularies: List[Vocabulary] = field(default_factory=list)
    target_vocabulary: Optional[Vocabulary] = None
    _consts_lock: object = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    @property
    def config(self) -> dict:
        return self.mf.config

    @property
    def is_sequence_to_sequence(self) -> bool:
        return self.arch.encoder is not None and self.arch.decoder is not None

    @property
    def out_dtype(self) -> torch.dtype:
        return self.policy.activation_torch

    @property
    def kv_dtype(self) -> torch.dtype:
        """Self-attention KV-cache dtype (the activation dtype)."""
        if os.environ.get("CT2TPU_KV_CACHE", "").lower() == "int8":
            raise NotImplementedError("the int8 KV cache is not ported yet")
        return self.policy.activation_torch

    def ensure_consts(self, max_positions: int) -> dict:
        with self._consts_lock:
            if max_positions > self.consts.get("max_positions", 0):
                grown = 1 << max(11, (max_positions - 1).bit_length())
                self.consts = transformer.make_consts(
                    self.arch, self.params, grown, self.device)
            return self.consts


def _map_v1_name(name: str) -> str:
    """Map spec-revision-1 (OpenNMT-tf style) variable names to the modern
    scheme (reference: src/models/transformer.cc:16-33). Each rule rewrites
    only the first occurrence."""
    rules = [
        ("transformer/", ""),
        (":0", ""),
        ("w_embs", "embeddings/weight"),
        ("kernel", "weight"),
        ("LayerNorm", "layer_norm"),
        ("dense", "projection"),
        ("conv1d_", "linear_"),
        ("conv1d", "linear_0"),
    ]
    for old, new in rules:
        name = name.replace(old, new, 1)
    if "encoder" in name:
        name = name.replace("multi_head", "self_attention", 1)
    else:
        name = name.replace("masked_multi_head", "self_attention", 1)
        name = name.replace("multi_head", "attention", 1)
    return name


_LEGACY_SPECS = ("", "TransformerBase", "TransformerBig")


def _apply_v1_mapping(mf: ModelFile) -> None:
    if mf.spec_name not in _LEGACY_SPECS or mf.spec_revision != 1:
        return
    renamed = {}
    for name, var in mf.variables.items():
        new_name = _map_v1_name(name)
        var.name = new_name
        renamed[new_name] = var
    mf.variables = renamed


def _legacy_config(mf: ModelFile) -> None:
    """Fill config defaults for pre-v6 binaries from attribute variables
    (reference: src/models/sequence_to_sequence.cc:60-77)."""

    def str_attr(name, default):
        var = mf.get(name)
        if var is None:
            return default
        return bytes(var.array.astype("int8").tobytes()).decode("utf-8")

    cfg = mf.config
    if mf.binary_version < 6:
        cfg.setdefault("unk_token", str_attr("unk_token", "<unk>"))
        cfg.setdefault("bos_token", str_attr("bos_token", "<s>"))
        cfg.setdefault("eos_token", str_attr("eos_token", "</s>"))
        cfg.setdefault("add_source_bos", bool(mf.attribute("with_source_bos", False)))
        cfg.setdefault("add_source_eos", bool(mf.attribute("with_source_eos", False)))
        if "decoder_start_token" not in cfg:
            if mf.attribute("user_decoder_start_tokens", False):
                cfg["decoder_start_token"] = None
            elif mf.attribute("with_target_bos", True):
                cfg["decoder_start_token"] = cfg["bos_token"]
            else:
                cfg["decoder_start_token"] = cfg["eos_token"]
    else:
        cfg.setdefault("unk_token", "<unk>")
        cfg.setdefault("bos_token", "<s>")
        cfg.setdefault("eos_token", "</s>")


def resolve_device(device: Optional[str] = None, device_index: int = 0
                   ) -> torch.device:
    """Map a reference device string to a ``torch.device``.

    ``None``, ``"auto"`` and ``"cuda"`` select CUDA card ``device_index``
    and raise when CUDA is unavailable: the port never falls back to the
    CPU on its own. ``"cpu"`` selects the CPU.
    """
    device = (device or "cuda").lower()
    if isinstance(device_index, (list, tuple)):
        if len(device_index) != 1:
            raise NotImplementedError(
                "one device per model: replicas are not ported yet")
        device_index = device_index[0]
    if device == "cpu":
        return torch.device("cpu")
    if device not in ("auto", "cuda"):
        raise ValueError(f"unsupported device {device!r} "
                         "(this runtime supports 'cuda' and 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device_index >= torch.cuda.device_count():
        raise ValueError(
            f"device index {device_index} is out of range "
            f"({torch.cuda.device_count()} CUDA device(s) available)")
    return torch.device("cuda", device_index)


def load_model(
    path,
    compute_type: str = "default",
    max_positions: int = 2048,
    device="cuda",
    files=None,
) -> LoadedModel:
    device = torch.device(device)
    if isinstance(path, ModelFile):
        mf = path
        path = ""
    elif files is not None:
        mf = load_model_file_from_files(path, files)
        path = ""
    else:
        mf = load_model_file(path)
    _apply_v1_mapping(mf)
    _legacy_config(mf)
    arch = extract_arch(mf)
    policy = resolve_compute_type(compute_type, _weights_dtype(mf),
                                  device.type)
    params = build_params(mf, arch, policy, device)
    consts = transformer.make_consts(arch, params, max_positions, device)

    info = VocabularyInfo(
        unk_token=mf.config.get("unk_token", "<unk>"),
        bos_token=mf.config.get("bos_token", "<s>"),
        eos_token=mf.config.get("eos_token", "</s>"),
    )
    if files is not None:
        def _load_vocab(name):
            return Vocabulary.load_from_files(files, name, info)
    elif path:
        def _load_vocab(name):
            return Vocabulary.load(path, name, info)
    else:
        def _load_vocab(name):
            return None

    shared = _load_vocab("shared_vocabulary")
    source_vocabularies = []
    if shared is not None:
        source_vocabularies = [shared]
        target_vocabulary = shared
    else:
        target_vocabulary = _load_vocab("target_vocabulary")
        source = _load_vocab("source_vocabulary")
        if source is not None:
            source_vocabularies = [source]
        else:
            i = 1
            while True:
                v = _load_vocab(f"source_{i}_vocabulary")
                if v is None:
                    break
                source_vocabularies.append(v)
                i += 1
        if target_vocabulary is None:
            target_vocabulary = _load_vocab("vocabulary")

    return LoadedModel(
        mf=mf,
        arch=arch,
        params=params,
        policy=policy,
        consts=consts,
        device=device,
        source_vocabularies=source_vocabularies,
        target_vocabulary=target_vocabulary,
    )
