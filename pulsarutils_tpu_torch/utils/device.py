"""Device selection and host transfer.

Entry points run on the card unless the caller asks for the CPU: a
request for ``cuda`` on a machine without one raises instead of quietly
running somewhere else.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda"):
    """``device`` as a ``torch.device``; raises if it is unusable here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda."
                "is_available() is False; pass device='cpu' to run on the "
                "host")
    elif dev.type != "cpu":
        raise ValueError(f"device={str(device)!r}: expected 'cuda' or 'cpu'")
    return dev


def on_device(tensor, device):
    """Whether ``tensor`` lies on ``device`` (``cuda`` with no index: the
    current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tensor.device == dev


def to_numpy(x):
    """A host numpy array from a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
