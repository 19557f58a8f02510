"""The device an entry point builds its tensors on, and the path a solver
takes on it.

The port runs on the card: ``device=None`` means the current CUDA device, and
a caller that wants the CPU asks for it (``device="cpu"``). Without a card,
``None`` raises rather than run quietly on the CPU. On the card a solver runs
its Hopper kernel unless the caller asks for the plain path
(``use_kernel=False``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_use_kernel"]


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


def resolve_use_kernel(use_kernel, tensor):
    """``use_kernel=None`` is ``True`` for a CUDA ``tensor`` and ``False`` for
    a CPU one; ``False``, ``True`` and ``"blocked"`` stand as given."""
    if use_kernel is None:
        return tensor.device.type == "cuda"
    if use_kernel not in (False, True, "blocked"):
        raise ValueError(
            f"use_kernel must be None, False, True or 'blocked', not {use_kernel!r}")
    return use_kernel
