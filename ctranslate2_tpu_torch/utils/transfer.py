"""Host arrays to device tensors, safe for views into a mapped model file.

A loaded model's variables are views into ``model.bin``'s map
(``formats/model_file.py``): read-only where the bytes were given in
memory, and not aligned to their item size where the file does not place
them so.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def to_device(array: np.ndarray, device, dtype=None) -> torch.Tensor:
    """``array`` as a tensor on ``device`` (in ``dtype``, converted there).

    For a card, a contiguous array is copied straight from the memory it
    views, aligned or not, with no host copy in between. On the CPU the
    tensor shares the array's memory only where that memory is writable and
    aligned to the item size (a copy-on-write map of the file is: an
    in-place op copies the page it writes); otherwise it is a copy."""
    device = torch.device(device)
    flags = array.flags
    if device.type == "cpu":
        if not (flags.c_contiguous and flags.writeable and flags.aligned):
            array = np.array(array, order="C")
        t = torch.from_numpy(array)
    else:
        if not flags.c_contiguous:
            array = np.ascontiguousarray(array)
        if array.flags.writeable:
            t = torch.from_numpy(array).to(device)
        else:
            # The tensor is only read, by the copy to the card.
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(array)
            t = t.to(device)
    return t if dtype is None else t.to(dtype)
