"""Tensor parallelism: the grid of ranks and the per-rank weight shards.

Port of ``ctranslate2_tpu/parallel/sharding.py``. The JAX package builds a
``Mesh`` and lets GSPMD partition one program; the port runs one process a
rank with explicit collectives (``parallel/comm.py``), the reference's own
design (src/models/model.cc:639-744, 827-899). ``tensor_parallel=True`` on
a task class shards the model at load, so that each rank holds only its
slice, the slice the JAX package's ``param_specs`` / ``cache_specs`` give
it on the model axis:

- the world is data x model (``make_grid``; ``device_index`` as a list of
  N entries sizes the data axis, as in the JAX ``apply_tensor_parallel``);
  rank = data_rank * num_model + model_rank, the mesh's row-major order;
- q, k, v (the fused QKV keeps its layout, head-aligned: [q_r; k_r; v_r]),
  ``memory_kv``, ``linear_0``, ``linear_0_noact`` and ``projection`` split
  on their output axis; ``o`` and ``linear_1`` split on their input axis
  (row-parallel: the partial products are summed over the model group and
  the bias is added once, after the sum); int8 scales follow their
  weight's output axis; AWQ row-parallel weights split their input axis at
  group boundaries;
- embeddings split on the vocabulary axis (masked lookup, then a sum);
- norms, position tables, relative-position key tables and the speech
  frontends are replicated, as the JAX package places unknown keys; the
  T5 bias table and the ALiBi slopes (``alibi_slopes`` in the side's
  params) keep the rank's heads;
- the KV cache splits on heads: each rank's attention blocks run on its
  local heads (``local_attention``), so the caches they make hold those heads;
  its batch splits on the data axis (below).

``fit_spec``'s rule holds at the granularity of a head: an attention block
whose query heads do not divide the model axis runs replicated; where the
query heads divide and the KV heads do not, each rank keeps the KV heads
its query heads read (when they form one GQA group layout, else the block
runs replicated). A vocabulary or ``d_ff`` that does not divide stays
whole, as does an AWQ row-parallel weight whose shard would cut a group.

The data axis splits each batch of a call, as ``cache_specs`` puts the
batch on it: where the axis divides the batch's rows (``fit_spec``'s rule),
data rank d runs the d-th contiguous share of them, with the KV cache of
those rows only, and the shares' results are gathered, so that every rank
returns the whole batch (``runtime/base.py``, ``_split_over_data``). A batch
the axis does not divide (a single request) runs whole on every data rank,
which is where the ring prefill (``parallel/context.py``) splits a long
prompt's sequence over the axis instead. A sampled call, or one with a
per-step callback, runs whole too: its draws are taken over the whole
batch, and the callback sees every row.

Every host decision (an early exit, a beam's finished set, a sampled
draw) is taken on data identical on every rank, with no broadcast: the
logits are gathered whole, every replicated operation runs on identical
inputs, and each rank draws from the same seeded ``torch.Generator``.

A shard is marked by a ``"tp"`` entry in its param dict (a ``Split``):
``ops/linear.py`` and ``models/transformer.py`` read it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.spec import ArchSpec, AttentionSpec
from ..ops.positions import alibi_slopes
from .comm import Comm
from .launch import free_port


@dataclass(frozen=True)
class Split:
    """How a sharded param dict combines across the model group: ``"row"``
    (a row-parallel linear: the partial outputs are summed, the bias added
    once; W8A8 quantizes with the row's absmax over the group), ``"gather"``
    (a column-parallel linear whose output is gathered along its last axis:
    the vocabulary projection, its columns ``[offset, offset + columns)``)
    or ``"vocab"`` (an embedding table's rows ``[offset, offset + rows)``:
    masked lookup, then a sum). Not a tuple:
    the tree walks (``move_tree``) pass it through as a leaf."""
    kind: str
    comm: Comm
    offset: int = 0


@dataclass
class Grid:
    """The ranks of one tensor-parallel job: world = num_data x num_model,
    with a group for this rank's model row (``model``), its data column
    (``data``) and a gloo group over the world for the continuous engines'
    control records (``control``)."""
    rank: int
    world: int
    num_data: int
    num_model: int
    model: Comm
    data: Comm
    control: Comm
    device: torch.device

    @property
    def model_rank(self) -> int:
        return self.model.rank


def initialize_distributed(backend: Optional[str] = None, device: str = "cuda") -> dict:
    """The process group, initialised from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) where none
    is yet: NCCL for ``device="cuda"``, gloo for ``"cpu"``, or ``backend``.
    Without that environment the process is a world of one rank (on a free
    local port). One backend is chosen and kept: a failure raises. Returns
    ``device_info()``."""
    if not dist.is_initialized():
        if backend is None:
            backend = "gloo" if str(device).lower() == "cpu" else "nccl"
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            if world > 1:
                raise RuntimeError(
                    "WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT (or an "
                    "initialised torch.distributed process group)")
            port = str(free_port())
        if backend == "nccl":
            torch.cuda.set_device(_local_card())
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world)
    return device_info()


def _local_rank() -> int:
    from .. import MpiInfo

    return MpiInfo.getLocalRank()


def _local_card() -> int:
    """This rank's card: its node-local rank modulo the visible cards (two
    ranks on a one-card host share it)."""
    return _local_rank() % max(1, torch.cuda.device_count())


_grids: dict = {}
_control: Optional[Comm] = None


def _control_comm() -> Comm:
    """A gloo group of its own over the world: a control record never
    shares a group with the model's collectives, so a leader that fails
    between two of them can still send its last record."""
    global _control
    if _control is None:
        world = dist.get_world_size()
        _control = (Comm(None, [0]) if world == 1 else
                    Comm(dist.new_group(list(range(world)), backend="gloo"),
                         list(range(world))))
    return _control


def make_grid(num_data: int = 1, device: str = "cuda") -> Grid:
    """The data x model grid over the initialised world (the counterpart of
    ``make_mesh``): every rank must call it with the same ``num_data`` (the
    groups are made in one order on every rank). Raises when the world
    does not divide into ``num_data`` groups."""
    world = dist.get_world_size()
    if num_data < 1 or world % num_data:
        raise ValueError(
            f"cannot build a tensor-parallel mesh: {world} visible "
            f"device(s) do not divide into {num_data} replica group(s)")
    key = (num_data, str(device))
    if key in _grids:
        return _grids[key]
    rank = dist.get_rank()
    num_model = world // num_data
    control = _control_comm()
    model = data = None
    for d in range(num_data):  # every rank creates every group, in order
        ranks = [d * num_model + m for m in range(num_model)]
        group = dist.new_group(ranks) if num_model > 1 and num_data > 1 else None
        if rank in ranks:
            model = Comm(group if num_data > 1 else dist.group.WORLD, ranks)
    for m in range(num_model):
        ranks = [d * num_model + m for d in range(num_data)]
        group = dist.new_group(ranks) if num_data > 1 and num_model > 1 else None
        if rank in ranks:
            data = Comm(group if num_model > 1 else dist.group.WORLD, ranks)
    dev = (torch.device("cpu") if str(device).lower() == "cpu"
           else torch.device("cuda", _local_card()))
    grid = Grid(rank=rank, world=world, num_data=num_data, num_model=num_model,
                model=model, data=data, control=control, device=dev)
    _grids[key] = grid
    return grid


def shutdown_distributed() -> None:
    """Destroys the process group and forgets the grids made over it (and
    the data axis the ring prefill would use)."""
    global _control
    from .context import disable_context_parallel

    disable_context_parallel()
    _grids.clear()
    _control = None
    if dist.is_initialized():
        dist.destroy_process_group()


def device_info() -> dict:
    """Runtime topology (the analog of the reference's MpiInfo binding,
    python/cpp/mpi.cc), with the JAX package's keys."""
    from .. import get_device_info

    return get_device_info()


# ---------------------------------------------------------------------------
# Head layout.
# ---------------------------------------------------------------------------


def head_layout(spec: AttentionSpec, num_model: int, model_rank: int):
    """(q0, hq, kv0, hkv): the first query head and the count of them, the
    first KV head and the count of them on this rank, or None where the
    block runs replicated (the query heads do not divide the model axis, or
    the KV heads its query heads read do not form a GQA layout)."""
    Hq, Hkv = spec.num_heads, spec.num_heads_kv
    if num_model == 1 or Hq % num_model:
        return None
    hq = Hq // num_model
    q0 = model_rank * hq
    if Hkv % num_model == 0:
        hkv = Hkv // num_model
        return q0, hq, model_rank * hkv, hkv
    group = Hq // Hkv
    if group % hq == 0:  # the rank's query heads all read one KV head
        return q0, hq, q0 // group, 1
    return None


def local_attention(spec: AttentionSpec, layout) -> AttentionSpec:
    if layout is None:
        return spec
    _, hq, _, hkv = layout
    return dataclasses.replace(spec, num_heads=hq, num_heads_kv=hkv)


def _cols(lin: dict, idx: torch.Tensor) -> dict:
    """The output columns ``idx`` of a linear (every layout)."""
    out = {}
    for key, t in lin.items():
        if key == "wq":  # (out, in)
            out[key] = t.index_select(0, idx)
        elif key in ("scale", "b"):
            out[key] = t.index_select(0, idx) if t.ndim else t
        elif key in ("w", "w4", "w4p", "g_scale", "g_zs"):  # (in, out)
            out[key] = t.index_select(1, idx)
        else:
            out[key] = t
    return out


def _unpack_w4p(w4p: torch.Tensor) -> torch.Tensor:
    u = w4p.view(torch.uint8)
    return torch.cat([u & 0x0F, (u >> 4) & 0x0F], dim=0)


def _pack_w4p(w4: torch.Tensor) -> torch.Tensor:
    K = w4.shape[0]
    return (w4[:K // 2] | (w4[K // 2:] << 4)).view(torch.int8).contiguous()


def row_shardable(lin: dict, parts: int) -> bool:
    """Whether a linear's input axis splits into ``parts`` (at AWQ group
    boundaries, and an even count of rows for the packed layout)."""
    if "wq" in lin:
        K = lin["wq"].shape[1]
    elif "w4p" in lin:
        K = 2 * lin["w4p"].shape[0]
    else:
        K = (lin.get("w") if "w" in lin else lin["w4"]).shape[0]
    if K % parts:
        return False
    if "g_scale" in lin:
        G = K // lin["g_scale"].shape[0]
        k = K // parts
        return k % G == 0 and ("w4p" not in lin or k % 2 == 0)
    return True


def _rows(lin: dict, r: int, parts: int, comm: Comm) -> dict:
    """Input rows [r K/parts, (r + 1) K/parts) of a linear, marked
    row-parallel; the bias stays whole (added once, after the sum)."""
    out = {}
    if "wq" in lin:
        K = lin["wq"].shape[1]
        k = K // parts
        out["wq"] = lin["wq"][:, r * k:(r + 1) * k].contiguous()
        out["scale"] = lin["scale"]
    elif "w" in lin:
        k = lin["w"].shape[0] // parts
        out["w"] = lin["w"][r * k:(r + 1) * k].contiguous()
    else:
        w4 = _unpack_w4p(lin["w4p"]) if "w4p" in lin else lin["w4"]
        K = w4.shape[0]
        k = K // parts
        G = K // lin["g_scale"].shape[0]
        part = w4[r * k:(r + 1) * k]
        gs = slice(r * k // G, (r + 1) * k // G)
        out["g_scale"] = lin["g_scale"][gs].contiguous()
        if "w4p" in lin:
            out["w4p"] = _pack_w4p(part)
            out["g_zs"] = lin["g_zs"][gs].contiguous()
        else:
            out["w4"] = part.contiguous()
    if "b" in lin:
        out["b"] = lin["b"]
    out["tp"] = Split("row", comm)
    return out


def _head_cols(heads0: int, count: int, head_dim: int, base: int = 0):
    start = base + heads0 * head_dim
    return torch.arange(start, start + count * head_dim)


def shard_attention(ap: dict, spec: AttentionSpec, layout, r: int, parts: int,
                    comm: Comm) -> dict:
    """One attention block's shard (``layout`` from ``head_layout``; None
    keeps the block whole)."""
    if layout is None or not row_shardable(ap["o"], parts):
        return ap
    q0, hq, kv0, hkv = layout
    D, Hq, Hkv = spec.head_dim, spec.num_heads, spec.num_heads_kv
    q_cols = _head_cols(q0, hq, D)
    kv_cols = _head_cols(kv0, hkv, D)
    out = dict(ap)
    if "qkv" in ap:
        out["qkv"] = _cols(ap["qkv"], torch.cat(
            [q_cols, Hq * D + kv_cols, (Hq + Hkv) * D + kv_cols]))
    else:
        out["q"] = _cols(ap["q"], q_cols)
        out["k"] = _cols(ap["k"], kv_cols)
        out["v"] = _cols(ap["v"], kv_cols)
    if "memory_kv" in ap:
        out["memory_kv"] = _cols(ap["memory_kv"], torch.cat([kv_cols, Hkv * D + kv_cols]))
    if "relative_attention_bias" in ap:  # the T5 table [buckets, H]
        out["relative_attention_bias"] = (
            ap["relative_attention_bias"][:, q0:q0 + hq].contiguous())
    out["o"] = _rows(ap["o"], r, parts, comm)
    return out


def shard_ffn(fp: dict, r: int, parts: int, comm: Comm) -> dict:
    firsts = [n for n in ("linear_0", "linear_0_noact") if n in fp]
    lin0 = fp["linear_0"]
    d_ff = (lin0["wq"].shape[0] if "wq" in lin0 else
            next(lin0[k] for k in ("w", "w4", "w4p") if k in lin0).shape[1])
    if d_ff % parts or not row_shardable(fp["linear_1"], parts):
        return fp
    f = d_ff // parts
    cols = torch.arange(r * f, (r + 1) * f)
    out = dict(fp)
    for n in firsts:
        out[n] = _cols(fp[n], cols)
    out["linear_1"] = _rows(fp["linear_1"], r, parts, comm)
    return out


def shard_ids(split: Split, ids: torch.Tensor, rows: int):
    """(local ids, inside) of the global vocabulary ``ids`` on a shard of
    ``rows`` entries from ``split.offset``: the ids it holds, 0 where it
    holds none, and the mask of those it holds. The caller zeroes what the
    mask leaves out and sums over ``split.comm``: one rank adds each id."""
    local = ids - split.offset
    inside = (local >= 0) & (local < rows)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def shard_embeddings(emb: dict, r: int, parts: int, comm: Comm) -> dict:
    key = "wq" if "wq" in emb else "w"
    V = emb[key].shape[0]
    if V % parts:
        return emb
    v = V // parts
    out = {k: t[r * v:(r + 1) * v] for k, t in emb.items()}
    out["tp"] = Split("vocab", comm, r * v)
    return out


def shard_projection(lin: dict, r: int, parts: int, comm: Comm) -> dict:
    V = lin["wq"].shape[0] if "wq" in lin else lin["w"].shape[1]
    if V % parts or any(k in lin for k in ("w4", "w4p")):
        return lin
    v = V // parts
    out = _cols(lin, torch.arange(r * v, (r + 1) * v))
    out["tp"] = Split("gather", comm, r * v)
    return out


def shard_params(params: dict, arch: ArchSpec, num_model: int, model_rank: int,
                 comm: Comm):
    """(params, arch) of model rank ``model_rank`` of ``num_model``: the
    rank's shard of every leaf and the architecture of its local heads."""
    if num_model == 1:
        return params, arch
    r, M = model_rank, num_model
    out = dict(params)
    sides = {}
    for name in ("encoder", "decoder"):
        side = getattr(arch, name)
        if side is None or name not in params:
            continue
        sp = dict(params[name])
        layers, layer_specs = [], []
        for lp, ls in zip(sp["layers"], side.layers):
            lp = dict(lp)
            sa = ls.self_attention
            lay = head_layout(sa, M, r)
            new = shard_attention(lp["self_attention"], sa, lay, r, M, comm)
            if new is lp["self_attention"]:
                lay = None
            lp["self_attention"] = new
            changes = {"self_attention": local_attention(sa, lay)}
            if "attention" in lp and ls.cross_attention is not None:
                ca = ls.cross_attention
                clay = head_layout(ca, M, r)
                new = shard_attention(lp["attention"], ca, clay, r, M, comm)
                if new is lp["attention"]:
                    clay = None
                lp["attention"] = new
                changes["cross_attention"] = local_attention(ca, clay)
            lp["ffn"] = shard_ffn(lp["ffn"], r, M, comm)
            layers.append(lp)
            layer_specs.append(dataclasses.replace(ls, **changes))
        sp["layers"] = layers
        if getattr(side, "alibi", False) and layer_specs[0].self_attention != side.layers[0].self_attention:
            hq = layer_specs[0].self_attention.num_heads
            sp["alibi_slopes"] = torch.from_numpy(np.ascontiguousarray(
                alibi_slopes(side.num_heads)[r * hq:(r + 1) * hq]))
        if "embeddings" in sp:
            sp["embeddings"] = [shard_embeddings(e, r, M, comm) for e in sp["embeddings"]]
        if "projection" in sp:
            sp["projection"] = shard_projection(sp["projection"], r, M, comm)
        out[name] = sp
        sides[name] = dataclasses.replace(side, layers=tuple(layer_specs))
    return out, dataclasses.replace(arch, **sides)


def tree_to(tree, device):
    """``tree`` with every tensor copied to ``device`` on its own: a shard
    that views a larger host tensor moves its own elements only."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def apply_tensor_parallel(params: dict, arch: ArchSpec, grid: Grid):
    """The model's shard for this rank of ``grid`` and its local
    architecture; registers the data axis for the ring prefill. The tree
    stays where it is (the loader moves the shard to the rank's device)."""
    from .context import enable_context_parallel

    enable_context_parallel(grid.data)
    return shard_params(params, arch, grid.num_model, grid.model_rank, grid.model)


def setup_tensor_parallel(device, device_index) -> Grid:
    """The grid of a ``tensor_parallel=True`` task class: the process group
    (initialised from the environment where none is), a data axis of
    ``len(device_index)`` for a list, and this rank's device. Without CUDA
    a card device raises, before any group is made: the port never falls
    back to the CPU on its own."""
    device = "cpu" if str(device).lower() == "cpu" else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    initialize_distributed(device=device)
    num_data = len(device_index) if isinstance(device_index, (list, tuple)) else 1
    return make_grid(num_data, device)
