"""Token selection for the decode loops.

Port of the greedy parts of ``ctranslate2_tpu/decoding/sampling.py``.
Random sampling is not ported yet.
"""

from __future__ import annotations

import torch

from .processors import DISABLE


def small_top_k(x, k: int):
    """Exact top-k along the last axis by ``k`` iterated argmax passes.

    Returns (values [..., k], indices [..., k]) in descending order. Among
    equal values the lowest index comes first, as in the JAX package's
    block tournament (``torch.argmax`` returns the first maximal index;
    ``torch.topk`` guarantees no tie order).
    """
    shape = x.shape
    V = shape[-1]
    work = x.reshape(-1, V)
    cols = torch.arange(V, device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(work, dim=-1)
        vals.append(work.gather(1, idx[:, None])[:, 0])
        idxs.append(idx)
        work = torch.where(cols[None, :] == idx[:, None], DISABLE, work)
    return (torch.stack(vals, -1).reshape(*shape[:-1], k),
            torch.stack(idxs, -1).reshape(*shape[:-1], k))


def greedy_tokens(log_probs):
    """Returns (ids [N], scores [N]): the argmax and its log-prob."""
    ids = torch.argmax(log_probs, dim=-1)
    return ids, log_probs.gather(1, ids[:, None])[:, 0]
