"""Invariant stacks with their uniform slots passed as scalars.

A chunk kernel reads per point a stack of chunk-invariant slots (moduli,
plastic parameters, old stresses, body forces). On the main paths most slots
hold one value everywhere. ``pack_slots`` finds them with one host read and
gives the kernel a table: per slot the index of its canvas in a smaller
stack, or ``-1`` and the scalar value. ``expand_slots`` rebuilds the full
stack from the table, bit for bit (the tests hold it to the original).
``derive_slots`` marks slots that a kernel computes itself from others.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SCALAR", "DERIVED", "PackedSlots", "pack_slots", "derive_slots", "expand_slots"]

SCALAR, DERIVED = -1, -2


class PackedSlots(NamedTuple):
    """The varying slots' canvases stacked ``(n_canvas, *shape)``, and per
    slot its canvas index (``SCALAR`` for a uniform slot) and its value
    (0.0 for a canvas)."""

    stack: torch.Tensor
    index: tuple
    values: tuple


def pack_slots(stack: torch.Tensor) -> PackedSlots:
    """Pack a contiguous stack ``(n_slots, *shape)``: a slot that holds one
    value everywhere goes in as that scalar."""
    flat = stack.reshape(stack.shape[0], -1)
    bits = flat.view({4: torch.int32, 8: torch.int64}[flat.element_size()])
    same = (bits == bits[:, :1]).all(dim=1).to(flat.dtype)  # bitwise: -0.0 is not 0.0
    uniform, first = torch.stack([same, flat[:, 0]]).tolist()
    index, values, keep = [], [], []
    for k, (u, v) in enumerate(zip(uniform, first)):
        if u:
            index.append(SCALAR)
            values.append(float(v))
        else:
            index.append(len(keep))
            values.append(0.0)
            keep.append(k)
    return PackedSlots(stack[keep].contiguous(), tuple(index), tuple(values))


def derive_slots(packed: PackedSlots, slots) -> PackedSlots:
    """The packing with ``slots`` marked ``DERIVED`` (the kernel computes
    them) and their canvases left out of the stack."""
    index, keep = [], []
    for k, i in enumerate(packed.index):
        if k in slots:
            index.append(DERIVED)
        elif i == SCALAR:
            index.append(SCALAR)
        else:
            index.append(len(keep))
            keep.append(i)
    return PackedSlots(packed.stack[keep].contiguous(), tuple(index), packed.values)


def expand_slots(packed: PackedSlots) -> torch.Tensor:
    """The full stack ``(n_slots, *shape)`` a packing came from."""
    shape = packed.stack.shape[1:]
    kw = dict(dtype=packed.stack.dtype, device=packed.stack.device)
    return torch.stack([
        packed.stack[k] if k != SCALAR else torch.full(shape, v, **kw)
        for k, v in zip(packed.index, packed.values)])
