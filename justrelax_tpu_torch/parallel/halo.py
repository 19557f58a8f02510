"""Halo exchange between the ranks of a process mesh.

Counterpart of ``justrelax_tpu/parallel/halo.py``. The global cell grid is
split into disjoint per-rank tiles; staggered arrays are stored as
per-rank local blocks that duplicate shared faces and vertices (the
blocked-local layout of :mod:`~justrelax_tpu_torch.parallel.decomp`). Each
rank runs the solve on its own tile:

- neighbour values arrive with :func:`extend`: the edge slabs go to the
  neighbours by point-to-point sends (``dist.batch_isend_irecv``, JAX's
  ``ppermute``) and come back as ghost layers, with the edge replicated at
  physical boundaries (the reference's ``update_halo!``);
- shared faces and vertices are computed redundantly by both neighbours
  from ghost-extended inputs ("compute in halo");
- physical boundary conditions take the rank's mesh coordinates, plain
  Python ints and bools (JAX's ``lax.axis_index`` masks);
- norms are sums of squares summed over the ranks by :func:`psum`, one
  ``dist.all_reduce``; every rank gets the same bits back, so every rank
  takes the same convergence decision.

JAX's permutes are cyclic and the wrapped values are thrown away at
physical edges, so :func:`extend` and :func:`exchange_ghosts` exchange only
across interior faces: the values are the same. Every send has its
receive in the same ``batch_isend_irecv``; :func:`extend_many` and
:func:`post_exchange_ghosts` put the slabs of several arrays in one batch.
Where the mesh is ``staged`` (gloo with tiles on the card) a batch's slabs
cross to host memory in one copy before they are sent, and back to the
card in one after they arrive: a host round trip per batch, not per
slab.

The functions read the mesh from ``mesh=`` or from the innermost
``with mesh:``. ``bytes_sent`` and ``exchanges`` count what this rank sent
and how many batches it posted; ``reset_counters()`` sets both to 0.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from justrelax_tpu_torch.parallel.mesh import GridMesh, current_mesh

__all__ = [
    "axis_edges",
    "is_first",
    "is_last",
    "from_prev",
    "from_next",
    "extend",
    "exchange_ghosts",
    "post_exchange_ghosts",
    "extend_many",
    "extend2_many",
    "extend_axes_many",
    "swap_many",
    "psum",
    "reset_counters",
    "timed_exchanges",
]

_AXES = ("x", "y", "z")
_ALIGN = 16  # bytes: each slab's offset in a staging buffer

bytes_sent = 0  # bytes this rank has sent to its neighbours
exchanges = 0  # batches of sends and receives this rank has posted


_spans = None  # (start, end) CUDA events of each exchange while timed


def reset_counters() -> None:
    global bytes_sent, exchanges
    bytes_sent = exchanges = 0


@contextlib.contextmanager
def timed_exchanges():
    """Record a pair of CUDA events around every exchange of tiles on the
    card (``extend``, ``exchange_ghosts``, a posted exchange and its wait)
    while the block runs; yields the list of pairs. Sum their
    ``elapsed_time`` after a synchronize for the card's time in the halo."""
    global _spans
    saved, _spans = _spans, []
    try:
        yield _spans
    finally:
        _spans = saved


_depth = 0  # spans open now: only the outermost is recorded


@contextlib.contextmanager
def _span(device):
    global _depth
    if _spans is None or device.type != "cuda" or _depth:
        yield
        return
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        end.record()
        _spans.append((start, end))


def is_first(mesh_axis: str, mesh: Optional[GridMesh] = None) -> bool:
    """This rank is at the low end of ``mesh_axis``."""
    return current_mesh(mesh).axis_index(mesh_axis) == 0


def is_last(mesh_axis: str, mesh: Optional[GridMesh] = None) -> bool:
    m = current_mesh(mesh)
    return m.axis_index(mesh_axis) == m.axis_size(mesh_axis) - 1


def axis_edges(mesh_axis: str, mesh: Optional[GridMesh] = None):
    return is_first(mesh_axis, mesh), is_last(mesh_axis, mesh)


def _from_bytes(flat, offset, shape, dtype):
    """The slab of ``shape`` and ``dtype`` packed at byte ``offset`` of
    ``flat``."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return flat[offset:offset + n].view(dtype).view(shape)


class Pending:
    """A posted batch of sends and receives; :meth:`wait` returns the
    received slabs in the order they were asked for (``None`` where no
    neighbour sends one), on the mesh's device."""

    def __init__(self, works, recvs, device, flat=None):
        self._works, self._recvs, self._device, self._flat = works, recvs, device, flat

    def wait(self):
        with _span(self._device):
            for w in self._works:
                w.wait()
            self._works = []
            if self._flat is None:
                return list(self._recvs)
            # staged: every slab of the batch crosses to the card in one copy
            flat = self._flat.to(self._device)
            return [_from_bytes(flat, *r) if isinstance(r, tuple) else r for r in self._recvs]


def _staged_layout(tensors):
    """Byte offsets of ``tensors`` packed one after another in one staging
    buffer, each aligned to 16 bytes (so that every slab views back into
    its dtype), and the buffer's length."""
    offsets, o = [], 0
    for t in tensors:
        offsets.append(o)
        o += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offsets, o


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _post(mesh: GridMesh, sends: Sequence, recvs: Sequence) -> Pending:
    """Post one batch: ``sends`` is a list of ``(peer, tensor, tag)``,
    ``recvs`` a list of ``(peer, like, tag)``; a ``None`` peer is skipped
    (its receive gives ``None``). A send to this rank itself (a cyclic axis
    of size 1) is a local copy that the receive with its tag takes. On a
    staged mesh the batch's send slabs cross to the host in one copy and its
    received slabs back in one; the slabs travel as bytes, so a batch may
    mix dtypes."""
    global bytes_sent, exchanges
    live = [(peer, t.contiguous(), tag) for peer, t, tag in sends if peer is not None]
    local = {tag: t.clone() for peer, t, tag in live if peer == mesh.rank}
    live = [x for x in live if x[0] != mesh.rank]
    bytes_sent += sum(t.numel() * t.element_size() for _, t, _ in live)
    if mesh.staged and live:
        offsets, n = _staged_layout([t for _, t, _ in live])
        dev = live[0][1].device
        buf = torch.zeros(n, dtype=torch.uint8, device=dev)
        for (_, t, _), o in zip(live, offsets):
            b = _as_bytes(t)
            buf[o:o + b.numel()] = b
        host = buf.cpu()
        live = [(peer, host[o:o + t.numel() * t.element_size()], tag)
                for (peer, t, tag), o in zip(live, offsets)]
    ops = [dist.P2POp(dist.isend, t, peer, mesh.group, tag) for peer, t, tag in live]
    remote = [like for peer, like, tag in recvs if peer is not None and peer != mesh.rank]
    flat = None
    if mesh.staged and remote:
        offsets, n = _staged_layout(remote)
        flat = torch.empty(n, dtype=torch.uint8)
        offsets = iter(offsets)
    out = []
    for peer, like, tag in recvs:
        if peer is None or peer == mesh.rank:
            out.append(None if peer is None else local[tag])
            continue
        if flat is not None:
            o = next(offsets)
            buf = flat[o:o + like.numel() * like.element_size()]
            out.append((o, like.shape, like.dtype))
        else:
            buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group, tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    if ops:
        exchanges += 1
    return Pending(works, out, mesh.device, flat)


def _swap_many(mesh: GridMesh, items) -> Pending:
    """One batch for every ``(mesh_axis, to_prev, to_next)`` of ``items``:
    send ``to_prev`` to the lower neighbour along ``mesh_axis`` and
    ``to_next`` to the higher one, receive the lower neighbour's ``to_next``
    and the higher one's ``to_prev``. ``wait()`` gives, item after item,
    (from the lower neighbour, from the higher one). Item k's slabs going
    down carry tag 2k, those going up 2k + 1: every rank posts the same
    items in the same order."""
    sends, recvs = [], []
    for k, (mesh_axis, to_prev, to_next) in enumerate(items):
        prev = mesh.neighbor(mesh_axis, -1)
        nxt = mesh.neighbor(mesh_axis, +1)
        sends += [(prev, to_prev, 2 * k), (nxt, to_next, 2 * k + 1)]
        recvs += [(prev, to_next, 2 * k + 1), (nxt, to_prev, 2 * k)]
    return _post(mesh, sends, recvs)


def _pairs(flat):
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(flat) // 2)]


def swap_many(items, mesh: Optional[GridMesh] = None):
    """For every ``(mesh_axis, to_prev, to_next)`` of ``items``, in one
    batch: ``to_prev`` goes to the lower neighbour along ``mesh_axis`` and
    ``to_next`` to the higher one. Returns, item after item, (what the lower
    neighbour sent up, what the higher one sent down), ``None`` past a
    physical edge."""
    m = current_mesh(mesh)
    with _span(items[0][1].device):
        return _pairs(_swap_many(m, items).wait())


def _shift(mesh: GridMesh, mesh_axis: str, x: torch.Tensor, step: int) -> torch.Tensor:
    """The cyclic permute of JAX's ``from_prev`` (step +1) / ``from_next``
    (step −1): each rank receives the ``x`` of the rank ``step`` below it."""
    prev = mesh.neighbor(mesh_axis, -1, True)
    nxt = mesh.neighbor(mesh_axis, +1, True)
    if step > 0:  # every slab goes up
        return _post(mesh, [(nxt, x, 1)], [(prev, x, 1)]).wait()[0]
    return _post(mesh, [(prev, x, 0)], [(nxt, x, 0)]).wait()[0]


def from_prev(x: torch.Tensor, mesh_axis: str, mesh: Optional[GridMesh] = None) -> torch.Tensor:
    """Each rank receives ``x`` from its lower-index neighbour (cyclic)."""
    return _shift(current_mesh(mesh), mesh_axis, x, +1)


def from_next(x: torch.Tensor, mesh_axis: str, mesh: Optional[GridMesh] = None) -> torch.Tensor:
    """Each rank receives ``x`` from its higher-index neighbour (cyclic)."""
    return _shift(current_mesh(mesh), mesh_axis, x, -1)


def extend_many(items, mesh: Optional[GridMesh] = None) -> List[torch.Tensor]:
    """:func:`extend` of every ``(A, axis, halo)`` of ``items`` in one batch
    of sends and receives (one host round trip on a staged mesh)."""
    m = current_mesh(mesh)
    items = [tuple(it) + (_AXES[it[1]],) if len(it) == 3 else tuple(it) for it in items]
    with _span(items[0][0].device):
        slabs = [(A.narrow(axis, 0, h), A.narrow(axis, A.shape[axis] - h, h))
                 for A, axis, h, _ in items]
        got = _pairs(_swap_many(m, [(ma, lo, hi) for (_, _, _, ma), (lo, hi)
                                    in zip(items, slabs)]).wait())
        out = []
        for (A, axis, h, _), (lo, hi), (g_lo, g_hi) in zip(items, slabs, got):
            n = A.shape[axis]
            # physical boundary: clamp (the outermost layer, h times)
            if g_lo is None:
                g_lo = A.narrow(axis, 0, 1).repeat_interleave(h, dim=axis) if h > 1 else lo
            if g_hi is None:
                g_hi = (A.narrow(axis, n - 1, 1).repeat_interleave(h, dim=axis) if h > 1
                        else hi)
            out.append(torch.cat([g_lo, A, g_hi], dim=axis))
        return out


def extend(A: torch.Tensor, axis: int, halo: int = 1, mesh_axis: Optional[str] = None,
           mesh: Optional[GridMesh] = None) -> torch.Tensor:
    """Ghost-extend a local block by ``halo`` layers on both sides of
    ``axis``: interior ranks receive the neighbour's adjacent layers, ranks
    at the physical boundary replicate their own edge layer (clamped
    stencil semantics)."""
    mesh_axis = _AXES[axis] if mesh_axis is None else mesh_axis
    return extend_many([(A, axis, halo, mesh_axis)], mesh)[0]


def extend_axes_many(items, mesh: Optional[GridMesh] = None) -> List[torch.Tensor]:
    """Every ``(A, axes, halo)`` of ``items`` extended along each axis of
    ``axes`` in turn (``extend(extend(A, axes[0], h), axes[1], h)``…), one
    batch per pass for all: pass k extends every item that has a k-th axis,
    so a corner ghost comes from the diagonal neighbour through the earlier
    pass."""
    out = [A for A, _, _ in items]
    for k in range(max((len(axes) for _, axes, _ in items), default=0)):
        live = [i for i, (_, axes, _) in enumerate(items) if k < len(axes)]
        got = extend_many([(out[i], items[i][1][k], items[i][2]) for i in live], mesh)
        for i, E in zip(live, got):
            out[i] = E
    return out


def extend2_many(items, mesh: Optional[GridMesh] = None) -> List[torch.Tensor]:
    """Every ``(A, halo)`` of ``items`` extended along x, then the results
    along y (``extend(extend(A, 0, h), 1, h)``): two batches for all."""
    return extend_axes_many([(A, (0, 1), h) for A, h in items], mesh)


def _ghost_sources(A, axis, n_owned):
    s = A.shape[axis]
    extra = s - n_owned
    if extra < 1:
        raise ValueError(f"array has no ghost layers along axis {axis}")
    # Blocked-local layout (decomp.block_staggered): tile r holds global
    # layers [r·n_owned, r·n_owned + n_owned + extra). Local j on tile r is
    # global r·n_owned + j, so my j=0 is the LEFT tile's local n_owned, and
    # my j=s−1 is the RIGHT tile's local extra−1. For extra ≥ 2 both source
    # layers are interior to their owner.
    return A.narrow(axis, extra - 1, 1), A.narrow(axis, n_owned, 1)


class PendingGhosts:
    """Posted ghost exchanges; :meth:`wait` returns the blocks with their
    ghost layers set."""

    def __init__(self, pending: Pending, items):
        self._pending, self._items = pending, items

    def wait(self) -> List[torch.Tensor]:
        got = _pairs(self._pending.wait())
        with _span(self._items[0][0].device):
            return [set_ghosts(A, axis, lo, hi)
                    for (A, axis, *_), (lo, hi) in zip(self._items, got)]


def post_exchange_ghosts(items, mesh: Optional[GridMesh] = None) -> PendingGhosts:
    """Post :func:`exchange_ghosts` of every ``(A, axis, n_owned[,
    mesh_axis])`` of ``items`` in one batch and return at once; ``wait()``
    gives the refreshed blocks. The ``@hide_communication`` form: the caller
    computes what reads no ghost before it waits."""
    m = current_mesh(mesh)
    items = list(items)
    with _span(items[0][0].device):
        swaps = [((rest or [_AXES[axis]])[0],) + _ghost_sources(A, axis, n)
                 for A, axis, n, *rest in items]
        return PendingGhosts(_swap_many(m, swaps), items)


def set_ghosts(A: torch.Tensor, axis: int, lo, hi) -> torch.Tensor:
    """``A`` with its outermost layers along ``axis`` replaced by ``lo`` and
    ``hi`` where they are not ``None``."""
    if lo is None and hi is None:
        return A
    s = A.shape[axis]
    parts = [A.narrow(axis, 0, 1) if lo is None else lo, A.narrow(axis, 1, s - 2),
             A.narrow(axis, s - 1, 1) if hi is None else hi]
    return torch.cat(parts, dim=axis)


def exchange_ghosts(A: torch.Tensor, axis: int, n_owned: int, mesh_axis: Optional[str] = None,
                    mesh: Optional[GridMesh] = None) -> torch.Tensor:
    """Refresh the outermost layers of an overlapping local block.

    For a block whose size along ``axis`` is ``n_owned + extra`` (extra ≥ 1
    layers shared with neighbours), set ``A[0] ←`` the lower neighbour's
    ``A[n_owned]`` and ``A[-1] ←`` the higher neighbour's ``A[extra − 1]``:
    the neighbour layer that holds the same global position (the analogue
    of ``update_halo!`` for velocity ghost rows and the ghosted T). Ranks at
    the physical boundary keep their (BC-set) values."""
    mesh_axis = _AXES[axis] if mesh_axis is None else mesh_axis
    return post_exchange_ghosts([(A, axis, n_owned, mesh_axis)], mesh).wait()[0]


def psum(values: torch.Tensor, mesh: Optional[GridMesh] = None) -> torch.Tensor:
    """``values`` summed over every rank of the mesh (JAX's ``lax.psum``):
    one ``dist.all_reduce``, whose result is bit-identical on every rank."""
    m = current_mesh(mesh)
    if not m.distributed:
        return values
    buf = values.detach().clone()
    if m.staged:
        buf = buf.cpu()
    dist.all_reduce(buf, group=m.group)
    return buf.to(values.device)
