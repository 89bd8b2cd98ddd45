"""The collectives tensor and context parallelism need, over one
``torch.distributed`` group.

The model runs one process a rank (the reference's MPI + NCCL design,
src/devices.cc:141-230, src/ops/nccl_ops_gpu.cu:52-92): a row-parallel
linear sums its partial products (``all_sum``), a row-parallel W8A8 linear
takes each row's absmax over the group (``all_max``), the vocabulary-
sharded projection gathers its logits (``all_gather``), ring attention
passes K/V shards to the next rank (``ring_exchange``), the data axis
gathers the results of each rank's share of a batch (``all_gather_objects``)
and the continuous engines' leader broadcasts its control records
(``broadcast_bytes``).

Every backend difference sits here. NCCL takes card tensors as they are.
gloo takes CPU tensors; a card tensor given to a gloo group goes through
host memory (``Comm._wire``), for every operation, since gloo has no
point-to-point transfer of card tensors and only some of its collectives
take them. A group of one rank returns its input: no collective runs.

Each operation runs inside a ``ct2tpu::comm::<op>`` range of
``torch.profiler`` and a ``comm::<op>`` scope of the port's profiler
(``utils/profiler.py``, which sees every thread: the task classes run
their calls on a worker thread), so both show the time spent in
collectives.
"""

from __future__ import annotations

import datetime
import struct
from contextlib import contextmanager
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils.profiler import profile

# A control record larger than this continues over further frames.
FRAME_BYTES = 1 << 16


@contextmanager
def _scope(op: str):
    with torch.profiler.record_function(f"ct2tpu::comm::{op}"), profile(f"comm::{op}"):
        yield


class Comm:
    """One ``torch.distributed`` group: ``ranks`` are its members' global
    ranks in group order, ``rank`` this process's index among them."""

    def __init__(self, group, ranks: List[int]):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank()) if self.size > 1 else 0
        self.backend = dist.get_backend(group) if self.size > 1 else "none"

    def __repr__(self):
        return f"Comm(ranks={self.ranks}, rank={self.rank}, backend={self.backend})"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: a contiguous CPU copy under gloo
        for a card tensor, float32 for the half types under gloo (whose
        reductions over them are partial across releases)."""
        if self.backend == "gloo":
            t = t.detach().cpu()
            if t.dtype in (torch.float16, torch.bfloat16):
                t = t.float()
        return t.contiguous()

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise sum of ``t`` over the group (a new tensor where
        it travelled, else ``t`` summed in place)."""
        if self.size == 1:
            return t
        with _scope("all_sum"):
            w = self._wire(t)
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
            return w.to(device=t.device, dtype=t.dtype)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum of ``t`` over the group."""
        if self.size == 1:
            return t
        with _scope("all_max"):
            w = self._wire(t)
            dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self.group)
            return w.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in group order (the
        ranks' tensors have one shape)."""
        if self.size == 1:
            return t
        with _scope("all_gather"):
            w = self._wire(t)
            parts = [torch.empty_like(w) for _ in range(self.size)]
            dist.all_gather(parts, w, group=self.group)
            return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)

    def ring_exchange(self, t: torch.Tensor) -> torch.Tensor:
        """Sends ``t`` to the next rank of the ring and returns what the
        previous rank sent (a tensor of ``t``'s shape and type)."""
        if self.size == 1:
            return t
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        with _scope("ring_exchange"):
            w = self._wire(t)
            buf = torch.empty_like(w)
            if self.backend == "nccl":
                ops = [dist.P2POp(dist.isend, w, nxt, self.group),
                       dist.P2POp(dist.irecv, buf, prv, self.group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            else:
                reqs = [dist.isend(w, nxt, group=self.group),
                        dist.irecv(buf, prv, group=self.group)]
                for req in reqs:
                    req.wait()
            return buf.to(device=t.device, dtype=t.dtype)

    def all_gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in group order."""
        if self.size == 1:
            return [obj]
        with _scope("all_gather_objects"):
            out = [None] * self.size
            dist.all_gather_object(out, obj, group=self.group)
            return out

    def broadcast_bytes(self, data: Optional[bytes], timeout: Optional[float] = None) -> bytes:
        """``data`` of the group's first rank on every rank, over frames of
        ``FRAME_BYTES``: the first carries the total length (8 bytes) and
        the head of the payload, the rest continue it; every rank derives
        the frame count from the length. Over NCCL the frames are card
        tensors of the current device. With ``timeout`` (seconds; gloo) a
        frame that the other ranks do not take within it raises."""
        if self.size == 1:
            return data
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.backend == "nccl" else torch.device("cpu"))
        root = self.ranks[0]
        leader = self.rank == 0

        def broadcast(wire):
            work = dist.broadcast(wire, root, group=self.group, async_op=timeout is not None)
            if work is not None:
                work.wait(timeout=datetime.timedelta(seconds=timeout))
        with _scope("broadcast_bytes"):
            frame = torch.zeros(FRAME_BYTES, dtype=torch.uint8)
            if leader:
                head = struct.pack("<Q", len(data)) + data[:FRAME_BYTES - 8]
                frame[:len(head)] = torch.frombuffer(bytearray(head), dtype=torch.uint8)
            wire = frame.to(device)
            broadcast(wire)
            first = wire.cpu().numpy().tobytes()
            total = struct.unpack("<Q", first[:8])[0]
            parts = [first[8:8 + min(total, FRAME_BYTES - 8)]]
            off = FRAME_BYTES - 8
            while off < total:
                n = min(total - off, FRAME_BYTES)
                frame = torch.zeros(FRAME_BYTES, dtype=torch.uint8)
                if leader:
                    frame[:n] = torch.frombuffer(bytearray(data[off:off + n]),
                                                 dtype=torch.uint8)
                wire = frame.to(device)
                broadcast(wire)
                parts.append(wire.cpu().numpy().tobytes()[:n])
                off += n
            return data if leader else b"".join(parts)
