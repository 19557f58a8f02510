"""The device an entry point builds its tensors on, and the path a solver
takes on it.

The port runs on the card: ``device=None`` means the current CUDA device, and
a caller that wants the CPU asks for it (``device="cpu"``). Without a card,
``None`` raises rather than run quietly on the CPU. On the card a solver runs
its Hopper kernel unless the caller asks for the plain path
(``use_kernel=False``). ``host`` is the one copy of a tensor to the host
that the IO and utils modules make.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_use_kernel", "host"]


def resolve_device(device=None) -> torch.device:
    """``torch.device("cuda")`` for ``None``, ``torch.device(device)``
    otherwise. ``None`` raises ``RuntimeError`` when no CUDA device exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_use_kernel(use_kernel, tensor, allowed=(False, True, "blocked")):
    """``use_kernel=None`` is ``True`` for a CUDA ``tensor`` and ``False`` for
    a CPU one; the values in ``allowed`` (each solver passes the ones it
    admits) stand as given, and any other raises ``ValueError``."""
    if use_kernel is None:
        return tensor.device.type == "cuda"
    if use_kernel not in allowed:
        names = ", ".join(repr(v) for v in allowed)
        raise ValueError(f"use_kernel must be None or one of {names}, not {use_kernel!r}")
    return use_kernel


def host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor's one copy to the host (it waits for
    the card's work on it), anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
