"""Process-group bring-up, rank-local tiles, and the gather back.

Counterpart of ``justrelax_tpu/parallel/multihost.py`` (the reference's
``MPI.Init`` + ``init_global_grid``, src/grid/Grid.jl:18-46). The port runs
one process per rank on ``torch.distributed``:

- :func:`initialize` — ``dist.init_process_group`` from torchrun's
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``) or from its arguments. The rank's device decides the
  backend: a rank on the card takes ``cuda:{LOCAL_RANK % device_count}``
  and NCCL; a rank on the CPU (``device="cpu"``) takes gloo. Several ranks
  on one card ask for ``backend="gloo"``: NCCL refuses two ranks on one
  GPU, and the halo module then stages every slab through host memory.
  NCCL asked for and not available raises; it never turns into gloo.
- :func:`make_multihost_grid_mesh` — hosts along the first ("x") axis,
  each host's ranks along the rest, so only the x faces between hosts
  cross the network.
- :func:`blocks_from_tiles` / :func:`blocks_from_global` — this rank's tile
  of a field on the rank's device: no rank holds another's tile on its
  device.
- :func:`gather_blocked` — an ``all_gather`` of the tiles back into the
  blocked layout on every rank (the reference tests' ``gather!``).
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from justrelax_tpu_torch.core.device import resolve_device
from justrelax_tpu_torch.parallel.mesh import GridMesh, current_mesh, make_grid_mesh

__all__ = [
    "initialize",
    "shutdown",
    "make_multihost_grid_mesh",
    "blocks_from_tiles",
    "blocks_from_global",
    "gather_blocked",
    "process_count",
    "process_index",
    "rank_device",
]

DEFAULT_TIMEOUT_S = 300.0
# what initialize() chose for this process: the rank's device, and the
# host ("node") and local rank make_multihost_grid_mesh lays out
_RANK = {}


def _env_int(name, default=None):
    v = os.environ.get(name)
    return default if v is None or v == "" else int(v)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[float] = DEFAULT_TIMEOUT_S,
    local_world_size: Optional[int] = None,
    node_rank: Optional[int] = None,
) -> None:
    """Bring up the process group for this rank.

    ``coordinator_address`` is ``host:port`` (a TCP store on the first
    rank) or an ``init_method`` URL (``tcp://…``, ``file://…``); by default
    ``MASTER_ADDR:MASTER_PORT``. ``num_processes``, ``process_id`` and
    ``local_rank`` default to ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``;
    ``local_world_size`` and ``node_rank`` (the ranks per host and this
    host's index, for :func:`make_multihost_grid_mesh`) to
    ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK``. With no address and one process
    it does nothing (a world of one runs without a group); it does nothing
    either when the group is up already.

    ``device=None`` is the card, ``cuda:{local_rank % device_count}``, and
    raises without one; ``device="cpu"`` asks for the CPU. ``backend``
    defaults to NCCL on the card and gloo on the CPU; ``"gloo"`` with a rank
    on the card stages slabs through host memory. ``timeout`` (seconds)
    bounds every collective, so a rank that never arrives fails the others
    rather than hanging them. The group is checked with one ``all_reduce``
    before it returns: a backend that cannot serve this world raises here.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = "{}:{}".format(os.environ["MASTER_ADDR"],
                                             os.environ.get("MASTER_PORT", "29500"))
    num_processes = _env_int("WORLD_SIZE", 1) if num_processes is None else int(num_processes)
    process_id = _env_int("RANK", 0) if process_id is None else int(process_id)
    local_rank = _env_int("LOCAL_RANK", process_id) if local_rank is None else int(local_rank)
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", num_processes)
    if node_rank is None:
        node_rank = _env_int("GROUP_RANK", process_id // max(1, local_world_size))

    if device is None:
        dev = resolve_device(None)
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs the rank's tiles on the card; pass "
                             "backend='gloo' for CPU ranks")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL was asked for and this PyTorch build has none; pass "
                               "backend='gloo' to stage halos through host memory")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError("no coordinator address: pass coordinator_address or set "
                             "MASTER_ADDR and MASTER_PORT")
        _RANK.update(device=dev, local_rank=local_rank, node_rank=node_rank,
                     local_world_size=local_world_size)
        return
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    _RANK.update(device=dev, local_rank=local_rank, node_rank=node_rank,
                 local_world_size=local_world_size)
    # the first collective: every rank takes part, and a backend that
    # cannot serve this world (NCCL with two ranks on one GPU) raises here
    probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"the process group's first all_reduce gave {probe.item()}, "
                           f"not {num_processes}")


def shutdown() -> None:
    """Tear the process group down (``dist.destroy_process_group``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK.clear()


def rank_device() -> Optional[torch.device]:
    """The device :func:`initialize` chose for this rank (``None`` before)."""
    return _RANK.get("device")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_multihost_grid_mesh(
    ndim: int = 2,
    local_shape: Optional[Sequence[int]] = None,
    device=None,
) -> GridMesh:
    """Spatial ("x","y"[,"z"]) mesh with hosts stacked along the first axis.

    ``local_shape`` factors each host's ranks over the mesh axes (default:
    all of them along the last axis). The mesh is ``(hosts · lx, ly[, lz])``
    where ``local_shape = (lx, ly[, lz])``: position (i, j[, k]) belongs to
    host ``i // lx``, so the x faces between hosts are the only halos that
    cross the network. Ranks are ordered host-major (host, then local
    rank), from what each rank's :func:`initialize` recorded.
    """
    n_local = int(_RANK.get("local_world_size") or process_count())
    if local_shape is None:
        local_shape = (1,) * (ndim - 1) + (n_local,)
    local_shape = tuple(int(s) for s in local_shape)
    if int(np.prod(local_shape)) != n_local:
        raise ValueError(f"local_shape {local_shape} does not cover {n_local} local ranks")
    procs = process_count()
    if procs % n_local:
        raise ValueError(f"{procs} ranks do not split into hosts of {n_local}")
    me = (int(_RANK.get("node_rank", 0)), int(_RANK.get("local_rank", 0)), process_index())
    if dist.is_initialized():
        keys = [None] * procs
        dist.all_gather_object(keys, me)
    else:
        keys = [me]
    order = [k[2] for k in sorted(keys)]
    shape = (procs // n_local * local_shape[0],) + local_shape[1:]
    mesh = make_grid_mesh(shape, device=device)
    ranks = np.asarray(order, dtype=np.int64).reshape(shape)
    where = np.argwhere(ranks == mesh.rank)[0]
    return GridMesh(ranks=ranks, axis_names=mesh.axis_names, rank=mesh.rank,
                    coords=tuple(int(c) for c in where), device=mesh.device,
                    group=mesh.group, staged=mesh.staged)


def _as_torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def blocks_from_tiles(
    mesh: GridMesh,
    block_shape: Tuple[int, ...],
    tile_fn: Callable[[Tuple[int, ...]], np.ndarray],
    dtype=None,
) -> torch.Tensor:
    """This rank's tile from a per-tile callback: ``tile_fn(coords)`` gets
    the rank's mesh coordinates and returns its tile of shape
    ``block_shape`` (the rank-local allocation of ImplicitGlobalGrid). The
    tile is put on the mesh's device, in ``dtype`` if given."""
    tile = np.asarray(tile_fn(tuple(mesh.coords)))
    if tuple(tile.shape[: len(block_shape)]) != tuple(block_shape):
        raise ValueError(f"tile_fn gave a tile of shape {tile.shape}, expected {block_shape}")
    return torch.as_tensor(tile, dtype=_as_torch_dtype(dtype)).to(mesh.device)


def blocks_from_global(mesh: GridMesh, blocked_np: np.ndarray, dtype=None) -> torch.Tensor:
    """This rank's tile of an already-blocked array (``decomp.block_staggered``
    layout), on the mesh's device, in ``dtype`` if given: how a state
    carried across from the JAX package, or written by a serial run, enters
    the sharded solvers."""
    tile = np.ascontiguousarray(mesh.tile(np.asarray(blocked_np)))
    return torch.as_tensor(tile, dtype=_as_torch_dtype(dtype)).to(mesh.device)


def gather_blocked(A: torch.Tensor, mesh: Optional[GridMesh] = None) -> np.ndarray:
    """All-gather every rank's tile ``A`` into the blocked layout, as a
    numpy array on every rank (reference ``gather!``,
    test/test_shearband2D_MPI.jl). ``mesh`` defaults to the innermost
    ``with mesh:``."""
    mesh = current_mesh(mesh)
    if not mesh.distributed:
        return A.detach().cpu().numpy()
    src = A.detach().contiguous()
    if mesh.staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    members = (list(range(dist.get_world_size())) if mesh.group is None
               else dist.get_process_group_ranks(mesh.group))
    tiles = {r: p.cpu().numpy() for r, p in zip(members, parts)}
    nd = len(mesh.shape)
    s = src.shape
    out = np.empty(tuple(p * t for p, t in zip(mesh.shape, s[:nd])) + tuple(s[nd:]),
                   dtype=tiles[mesh.rank].dtype)
    for pos in np.ndindex(*mesh.shape):
        idx = tuple(slice(c * t, (c + 1) * t) for c, t in zip(pos, s[:nd]))
        out[idx] = tiles[int(mesh.ranks[pos])]
    return out
