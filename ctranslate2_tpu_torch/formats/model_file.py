"""Reader/writer for the CTranslate2 model artifact directory.

The artifact directory contains:
  - ``model.bin``     binary variable pack (versions 1..6 readable, 6 written)
  - ``config.json``   optional model configuration
  - ``*vocabulary.*`` vocabulary files (handled by :mod:`.vocabulary`)
  - ``vmap.txt``      optional vocabulary map

Binary layout (little-endian), mirroring the reference serializer
(reference: python/ctranslate2/specs/model_spec.py:382-414) and reader
(reference: src/models/model.cc:594-784):

  u32  binary_version
  str  spec_name              (only if version >= 2)
  u32  spec_revision          (only if version >= 2)
  u32  num_variables
  repeated:
    str  name
    u8   rank
    u32  dims[rank]
    if version >= 4:  u8 dtype_id ; u32 num_bytes
    else:             u8 item_size; u32 num_items
    raw  bytes
  u32  num_aliases            (only if version >= 3)
  repeated: str alias ; str target

where ``str`` = u16 (len+1), utf-8 bytes, single 0x00 terminator.

dtype_id order matches the reference DataType enum
(reference: include/ctranslate2/types.h, python model_spec.py:280-289).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

CURRENT_BINARY_VERSION = 6

# Index in this tuple == serialized dtype id.
_DTYPE_IDS: Tuple[str, ...] = ("float32", "int8", "int16", "int32", "float16", "bfloat16")

# numpy has no native bfloat16; we keep the raw uint16 payload and tag it.
_NUMPY_DTYPES = {
    "float32": np.float32,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "float16": np.float16,
    "bfloat16": np.uint16,  # bit pattern; see Variable.dtype_name
}

_ITEM_SIZE_TO_DTYPE = {4: "float32", 1: "int8", 2: "int16"}

# Attributes never turned into aliases even when equal across layers
# (reference: python/ctranslate2/specs/model_spec.py:38).
SKIP_CREATING_ALIAS = ("rotary_scaling_long_factor", "rotary_scaling_short_factor")


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    # Round-to-nearest-even, matching numpy/JAX bfloat16 casting.
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounding_bias = ((u >> 16) & 1) + 0x7FFF
    return ((u + rounding_bias) >> 16).astype(np.uint16)


@dataclass
class Variable:
    """A named tensor (or scalar attribute) from a model.bin pack."""

    name: str
    array: np.ndarray
    dtype_name: str  # one of _DTYPE_IDS; disambiguates bfloat16-as-uint16

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    def as_float32(self) -> np.ndarray:
        if self.dtype_name == "bfloat16":
            return _bf16_to_f32(self.array)
        return self.array.astype(np.float32)

    def as_scalar(self):
        """Return the value as a python scalar (attribute access).

        Mirrors StorageView::as_scalar (reference:
        include/ctranslate2/storage_view.h:215-221): any numeric dtype is
        accepted and cast to the caller's desired type.
        """
        if self.array.size != 1:
            raise ValueError(f"variable {self.name!r} is not a scalar")
        if self.dtype_name == "bfloat16":
            return float(_bf16_to_f32(self.array).reshape(()))
        return self.array.reshape(()).item()


def _read_str(f) -> str:
    (n,) = struct.unpack("<H", f.read(2))
    raw = f.read(n)
    return raw[:-1].decode("utf-8")


def _write_str(f, s: str) -> None:
    raw = s.encode("utf-8")
    f.write(struct.pack("<H", len(raw) + 1))
    f.write(raw)
    f.write(b"\x00")


@dataclass
class ModelFile:
    """Parsed contents of a model directory."""

    spec_name: str
    spec_revision: int
    binary_version: int
    variables: Dict[str, Variable] = field(default_factory=dict)
    aliases: Dict[str, str] = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    path: Optional[str] = None

    # ---- variable access (alias-aware), mirroring models::Model ----

    def resolve(self, name: str) -> str:
        seen = set()
        while name in self.aliases and name not in self.variables:
            if name in seen:
                break
            seen.add(name)
            name = self.aliases[name]
        return name

    def get(self, name: str) -> Optional[Variable]:
        return self.variables.get(self.resolve(name))

    def __contains__(self, name: str) -> bool:
        return self.resolve(name) in self.variables

    def attribute(self, name: str, default=None):
        var = self.get(name)
        if var is None:
            return default
        return var.as_scalar()

    def flag(self, name: str, default: bool = False) -> bool:
        # Flags are serialized as int8 scalars (reference model_spec).
        return bool(self.attribute(name, default))

    def names(self) -> Iterator[str]:
        return iter(self.variables)

    # ---- serialization ----

    def dedupe_aliases(self) -> int:
        """Replace duplicate variables with aliases before saving.

        Mirrors the reference's spec optimization: element-wise-equal
        non-scalar variables are written once, keeping the alphabetically
        first name and aliasing the rest (reference:
        python/ctranslate2/specs/model_spec.py:169-190,385-414). Halves the
        artifact size for tied embeddings / shared projections.
        """
        import hashlib

        first: Dict[tuple, str] = {}
        num_aliased = 0
        for name in sorted(self.variables):
            var = self.variables[name]
            if var.array.size <= 1:
                continue
            attr = name.rsplit("/", 1)[-1]
            if attr in SKIP_CREATING_ALIAS:
                continue
            payload = np.ascontiguousarray(var.array)
            key = (var.dtype_name, var.shape,
                   hashlib.blake2b(payload.tobytes(), digest_size=16).digest())
            target = first.get(key)
            if target is None:
                first[key] = name
            else:
                del self.variables[name]
                self.aliases[name] = target
                num_aliased += 1
        return num_aliased

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "model.bin"), "wb") as f:
            f.write(struct.pack("<I", CURRENT_BINARY_VERSION))
            _write_str(f, self.spec_name)
            f.write(struct.pack("<I", self.spec_revision))
            f.write(struct.pack("<I", len(self.variables)))
            for name, var in self.variables.items():
                _write_str(f, name)
                f.write(struct.pack("<B", len(var.array.shape)))
                for dim in var.array.shape:
                    f.write(struct.pack("<I", dim))
                f.write(struct.pack("<B", _DTYPE_IDS.index(var.dtype_name)))
                payload = np.ascontiguousarray(var.array).tobytes()
                f.write(struct.pack("<I", len(payload)))
                f.write(payload)
            f.write(struct.pack("<I", len(self.aliases)))
            for alias, target in self.aliases.items():
                _write_str(f, alias)
                _write_str(f, target)
        if self.config:
            with open(os.path.join(directory, "config.json"), "w", encoding="utf-8") as f:
                json.dump(self.config, f, indent=2, sort_keys=True)
                f.write("\n")


def _parse_model_bin(f):
    """Parse a model.bin stream (any binary file object) into
    ``(version, spec_name, spec_revision, variables, aliases)``."""
    (binary_version,) = struct.unpack("<I", f.read(4))
    if binary_version > CURRENT_BINARY_VERSION:
        raise ValueError(
            f"unsupported binary version {binary_version} "
            f"(max supported: {CURRENT_BINARY_VERSION})"
        )
    if binary_version >= 2:
        spec_name = _read_str(f)
        (spec_revision,) = struct.unpack("<I", f.read(4))
    else:
        spec_name = ""
        spec_revision = 1

    (num_variables,) = struct.unpack("<I", f.read(4))
    variables: Dict[str, Variable] = {}
    for _ in range(num_variables):
        name = _read_str(f)
        (rank,) = struct.unpack("<B", f.read(1))
        dims = struct.unpack(f"<{rank}I", f.read(4 * rank)) if rank else ()
        if binary_version >= 4:
            (dtype_id,) = struct.unpack("<B", f.read(1))
            (num_bytes,) = struct.unpack("<I", f.read(4))
            dtype_name = _DTYPE_IDS[dtype_id]
        else:
            (item_size,) = struct.unpack("<B", f.read(1))
            (num_items,) = struct.unpack("<I", f.read(4))
            num_bytes = num_items * item_size
            dtype_name = _ITEM_SIZE_TO_DTYPE[item_size]
        raw = f.read(num_bytes)
        arr = np.frombuffer(raw, dtype=_NUMPY_DTYPES[dtype_name]).reshape(dims).copy()
        variables[name] = Variable(name, arr, dtype_name)

    aliases: Dict[str, str] = {}
    if binary_version >= 3:
        (num_aliases,) = struct.unpack("<I", f.read(4))
        for _ in range(num_aliases):
            alias = _read_str(f)
            target = _read_str(f)
            aliases[alias] = target
            # Quantization scales/zeros follow their weight's alias
            # (reference: src/models/model.cc:771-776).
            aliases[alias + "_scale"] = target + "_scale"
            aliases[alias + "_zero"] = target + "_zero"
    return binary_version, spec_name, spec_revision, variables, aliases


def file_content_bytes(content) -> bytes:
    """Normalize an in-memory model file (bytes / bytearray / memoryview /
    binary file object) to bytes (reference: files= dict values,
    python/cpp/replica_pool.h model_memory_reader)."""
    if isinstance(content, (bytes, bytearray, memoryview)):
        return bytes(content)
    pos = content.tell() if hasattr(content, "tell") else None
    if hasattr(content, "seek"):
        content.seek(0)
    data = content.read()
    if pos is not None and hasattr(content, "seek"):
        content.seek(pos)
    if isinstance(data, str):
        data = data.encode("utf-8")
    return data


def load_model_file_from_files(name: str, files: Dict[str, object]) -> ModelFile:
    """Build a ModelFile from an in-memory ``{filename: content}`` mapping
    (reference: Translator(model_path, files=...) loads a model from
    memory without touching the filesystem — python/tests/
    test_translator.py test_load_model_from_memory)."""
    import io

    if "model.bin" not in files:
        raise ValueError(
            f"in-memory model {name!r} is missing a model.bin entry")
    data = file_content_bytes(files["model.bin"])
    binary_version, spec_name, spec_revision, variables, aliases = (
        _parse_model_bin(io.BytesIO(data)))
    config = {}
    if "config.json" in files:
        config = json.loads(file_content_bytes(files["config.json"]))
    return ModelFile(
        spec_name=spec_name,
        spec_revision=spec_revision,
        binary_version=binary_version,
        variables=variables,
        aliases=aliases,
        config=config,
        path=None,
    )


def load_model_file(directory: str) -> ModelFile:
    """Parse ``<directory>/model.bin`` (+ config.json) into a ModelFile."""
    bin_path = os.path.join(directory, "model.bin")
    with open(bin_path, "rb") as f:
        binary_version, spec_name, spec_revision, variables, aliases = (
            _parse_model_bin(f))

    config = {}
    config_path = os.path.join(directory, "config.json")
    if os.path.isfile(config_path):
        with open(config_path, encoding="utf-8") as f:
            config = json.load(f)

    return ModelFile(
        spec_name=spec_name,
        spec_revision=spec_revision,
        binary_version=binary_version,
        variables=variables,
        aliases=aliases,
        config=config,
        path=directory,
    )


def make_variable(name: str, value, dtype: Optional[str] = None) -> Variable:
    """Build a Variable from a numpy array or python scalar."""
    arr = np.asarray(value)
    if dtype is None:
        dtype = str(arr.dtype)
        if dtype not in _DTYPE_IDS:
            arr = arr.astype(np.float32)
            dtype = "float32"
    elif dtype == "bfloat16":
        arr = _f32_to_bf16(arr.astype(np.float32))
    else:
        arr = arr.astype(_NUMPY_DTYPES[dtype])
    return Variable(name, arr, dtype)
