"""Context (sequence) parallelism: ring attention over the data axis.

Port of ``ctranslate2_tpu/parallel/context.py``. A long prompt's fresh
prefill splits its sequence over the data axis (idle during one request's
prefill): each rank keeps its T/n slice of the queries, the K/V slices
rotate n times around the ring (``Comm.ring_exchange``) and the
attention accumulates with the online softmax in float32, as the JAX
package's ``_ring_attention_local`` does; the outputs are gathered back along T.
Plain PyTorch, as the JAX body is einsums outside any Pallas kernel.

``tensor_parallel=True`` registers the data axis (``enable_context_
parallel``); a call whose batch the axis splits runs no ring
(``batch_on_data_axis``); ``CT2TPU_RING_PREFILL=0`` turns the dispatch off and
``CT2TPU_RING_PREFILL_MIN_LEN`` (4,096) sets the shortest prompt it takes.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

import torch

from .comm import Comm

NEG_INF = -1e30

# The data axis of the tensor-parallel model of this process (or None).
_ACTIVE_CP: Optional[Comm] = None
# Set in a thread whose call has split its batch over the data axis.
_SPLIT = threading.local()


def enable_context_parallel(comm: Comm) -> None:
    global _ACTIVE_CP
    _ACTIVE_CP = comm


def disable_context_parallel() -> None:
    global _ACTIVE_CP
    _ACTIVE_CP = None


@contextmanager
def batch_on_data_axis():
    """Marks the calling thread's work as a share of a batch split over the
    data axis: the data ranks hold other rows, so no ring runs over it."""
    _SPLIT.on = True
    try:
        yield
    finally:
        _SPLIT.on = False


def context_parallel_config() -> Optional[Comm]:
    """The data axis when context parallelism is available: registered,
    of more than one rank, not carrying a split batch, and not turned off
    by ``CT2TPU_RING_PREFILL=0``."""
    if _ACTIVE_CP is None or _ACTIVE_CP.size <= 1 or getattr(_SPLIT, "on", False):
        return None
    if os.environ.get("CT2TPU_RING_PREFILL", "1") == "0":
        return None
    return _ACTIVE_CP


def ring_prefill_min_len() -> int:
    return int(os.environ.get("CT2TPU_RING_PREFILL_MIN_LEN", "4096"))


def ring_prefill_eligible(T: int, n: int) -> bool:
    """The sequence divides the axis into slices of at least 128."""
    return T % n == 0 and T // n >= 128


def ring_attention(q, k, v, comm: Comm, *, causal: bool = True, scale: float = 1.0,
                   lengths=None):
    """Sequence-sharded attention, one rank's part: q, k, v are this rank's
    slices [B, H, T/n, D] of the sequence (slice ``comm.rank``); ``lengths``
    [B] masks key positions at or past a row's length. Returns the rank's
    slice of the output, in q's type."""
    n, idx = comm.size, comm.rank
    B, H, Tl, D = q.shape
    dev = q.device
    q32 = q.float() * scale
    q_pos = idx * Tl + torch.arange(Tl, device=dev)
    m = torch.full((B, H, Tl, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n  # the owner of the K/V slice held now
        k_pos = src * Tl + torch.arange(Tl, device=dev)
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float())
        if causal:
            s = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None], s,
                            torch.full_like(s, NEG_INF))
        if lengths is not None:
            valid = k_pos[None, :] < lengths.to(dev)[:, None]
            s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if i + 1 < n:
            k_cur = comm.ring_exchange(k_cur)
            v_cur = comm.ring_exchange(v_cur)
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def ring_attention_prefill(q, k, v, lengths=None, *, scale: float, comm: Comm):
    """Fresh causal prefill attention of q [B, Hq, T, D] over k, v
    [B, Hkv, T, D], every rank holding the whole sequence: GQA heads are
    expanded first, each rank attends its T/n queries through the ring and
    the slices are gathered back along T."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    n, idx = comm.size, comm.rank
    Tl = q.shape[2] // n
    part = slice(idx * Tl, (idx + 1) * Tl)
    out = ring_attention(q[:, :, part].contiguous(), k[:, :, part].contiguous(),
                         v[:, :, part].contiguous(), comm, causal=True, scale=scale,
                         lengths=lengths)
    return comm.all_gather(out, dim=2)
