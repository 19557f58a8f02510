"""PyTorch port, the process-group bring-up and the multi-host layout
(``parallel/multihost.py``), the reference's ``mpiexec -n 2`` tier
(test/runtests.jl:48-89) as tests/test_multihost.py holds the JAX package
to it: two "hosts" of two rank processes each, every rank started through
``initialize()`` from torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``) over gloo, run the sharded SolCx solve at 16² on
``make_multihost_grid_mesh`` (hosts along x), gather it with
``gather_blocked`` and match the serial solve of both packages (fields
within 1e-12 of their max, equal iterations). Also the bring-up's own
rules in this process: a world of one without a group, the tiles of
``blocks_from_tiles``/``blocks_from_global``, and the refusals."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.core.coeffs import PTStokesCoeffs as JCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import StokesState as JStokesState
from justrelax_tpu.solvers.stokes2d import solve_ve as j_solve_ve
from dist_parity import FS, assert_matches
from justrelax_tpu_torch.parallel import mesh as pmesh
from justrelax_tpu_torch.parallel import multihost
import dist_cases as dc

torch.set_num_threads(1)

CASE = dc.suite_cases("test")["ve_solcx"]


@pytest.fixture(scope="module")
def running():
    w = dc.world("multihost", device="cpu", hosts=2, timeout=300)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def jax_serial(running):
    """JAX's serial ``solve_ve`` of the case, while the ranks run."""
    n, d = CASE.n, dc.inputs(CASE)
    g = JGeometry((n, n), (1.0, 1.0))
    pt = JCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0, eps_rel=0.0)
    st = JStokesState.make((n, n))
    st = st.replace(viscosity=st.viscosity.replace(eta=jnp.asarray(d["eta"])))
    s, info = j_solve_ve(st, pt, g, FS, (jnp.asarray(d["rho_x"]), jnp.asarray(d["rho_y"])),
                         jnp.asarray(d["G"]), jnp.asarray(d["K"]), d["dt"],
                         iter_max=CASE.iters, nout=CASE.nout)
    out = dict(Vx=s.V.Vx, Vy=s.V.Vy, P=s.P, txx=s.tau.xx, tyy=s.tau.yy, txy=s.tau.xy)
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(err=float(info.err), iters=int(info.iters))
    return out


@pytest.fixture(scope="module")
def world(running, jax_serial):
    return running.result()


def test_multihost_layout(world):
    """Hosts along x: host 0's ranks 0, 1 on the first row, host 1's on the
    second, so only x faces cross between hosts."""
    lay = world["multihost_layout"]
    assert tuple(lay["shape"]) == (2, 2)
    np.testing.assert_array_equal(lay["ranks"], [[0, 1], [2, 3]])


def test_multihost_matches_serial(world):
    assert_matches(CASE, world["multihost"], dc.serial_solve(CASE, "cpu"), "serial")


def test_multihost_matches_jax_serial(world, jax_serial):
    assert_matches(CASE, world["multihost"], jax_serial, "jax serial")


def test_world_of_one(monkeypatch):
    """``initialize`` with one process and no address brings up no group;
    the mesh is a world of one on the device it chose, the tiles are the
    whole arrays and ``gather_blocked`` gives them back."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    try:
        assert not torch.distributed.is_initialized()
        assert multihost.rank_device() == torch.device("cpu")
        assert (multihost.process_count(), multihost.process_index()) == (1, 0)
        mesh = multihost.make_multihost_grid_mesh(ndim=2)
        assert mesh.shape == (1, 1) and mesh.device.type == "cpu" and not mesh.staged
        A = np.arange(12.0).reshape(3, 4)
        t = multihost.blocks_from_global(mesh, A, np.float32)
        assert t.dtype == torch.float32 and torch.equal(t, torch.as_tensor(A, dtype=t.dtype))
        t2 = multihost.blocks_from_tiles(mesh, (3, 4), lambda c: A + c[0], torch.float64)
        np.testing.assert_array_equal(multihost.gather_blocked(t2, mesh), A)
        with mesh:
            np.testing.assert_array_equal(multihost.gather_blocked(t2), A)
        with pytest.raises(ValueError, match="tile"):
            multihost.blocks_from_tiles(mesh, (2, 4), lambda c: A)
    finally:
        multihost.shutdown()
    assert multihost.rank_device() is None


def test_grid_mesh_and_sharding():
    """A (2, 3) mesh's coordinates and neighbours, and the cuts of
    ``grid_sharding``/``shard_pytree``/``GridMesh.local`` to one rank's tile
    (a mesh built by hand for rank 4)."""
    m = pmesh.GridMesh(ranks=np.arange(6).reshape(2, 3), axis_names=("x", "y"), rank=4,
                       coords=(1, 1), device=torch.device("cpu"))
    assert (m.axis_index("x"), m.axis_size("y"), m.size) == (1, 3, 6)
    assert (m.neighbor("x", -1), m.neighbor("x", 1), m.neighbor("x", 1, cyclic=True)) == \
        (1, None, 1)
    assert (m.neighbor("y", -1), m.neighbor("y", 1)) == (3, 5)
    B = np.arange(8 * 9, dtype=np.float64).reshape(8, 9)
    np.testing.assert_array_equal(pmesh.grid_sharding(m)(B).numpy(), B[4:8, 3:6])
    tree = dict(a=B, b=(B[:, :, None], np.float64(2.0)), c=np.arange(3.0))
    got = pmesh.shard_pytree(tree, m)
    np.testing.assert_array_equal(got["a"].numpy(), B[4:8, 3:6])
    np.testing.assert_array_equal(got["b"][0].numpy(), B[4:8, 3:6, None])
    assert got["b"][1] == 2.0 and got["c"].shape == (3,)
    assert torch.equal(m.local(B, (4, 3)), torch.as_tensor(B[4:8, 3:6]))
    assert m.local(B[:4, :3], (4, 3)).shape == (4, 3)
    assert m.local(torch.tensor(1.5), (4, 3)).shape == (4, 3)
    with pytest.raises(ValueError, match="neither"):
        m.local(B[:5], (4, 3))
    with pytest.raises(ValueError, match="no axis"):
        m.axis_index("z")


def test_initialize_refusals(monkeypatch):
    """NCCL with CPU tiles, an unknown backend, and several processes with no
    coordinator raise; without a card the default device raises rather than
    run on the CPU."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    try:
        with pytest.raises(ValueError, match="NCCL"):
            multihost.initialize("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
        with pytest.raises(ValueError, match="backend"):
            multihost.initialize("127.0.0.1:1", 2, 0, backend="mpi", device="cpu")
        with pytest.raises(ValueError, match="coordinator"):
            multihost.initialize(num_processes=2, process_id=0, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.initialize()
        with pytest.raises(ValueError, match="cover"):
            pmesh.make_grid_mesh((2, 2), device="cpu")
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()
