"""The JAX side of the distributed parity tests: each case of
``dist_cases.py`` through the JAX
package's sharded solver on the virtual CPU mesh (``tests/conftest.py``),
from the same numpy inputs, gathered to the global fields. The port's side
runs in a world of rank processes (``dist_cases.world``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.ops.bc import Faces, TemperatureBoundaryConditions, VelocityBoundaryConditions
from justrelax_tpu.ops.bc import thermal_bcs
from justrelax_tpu.parallel.decomp import (
    Decomp2D,
    Decomp3D,
    block_staggered,
    block_staggered_nd,
    unblock_staggered,
    unblock_staggered_nd,
)
import dist_cases as dc

FS = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True, top=True, bot=True))
# relative to each field's max: rounding only
FIELD_TOL = 1e-12
ERR_RTOL = 1e-6


def jax_mesh(shape):
    axes = ("x", "y", "z")[: len(shape)]
    devs = np.array(jax.devices("cpu")[: math.prod(shape)]).reshape(shape)
    return jax.sharding.Mesh(devs, axes)


def _j(A):
    return jnp.asarray(np.asarray(A))


def _B(dec, name, A):
    return _j(block_staggered(np.asarray(A), dec, dc.EXTRAS.get(name, (0, 0))))


def _unB(dec, name, A):
    return unblock_staggered(np.asarray(A), dec, dc.EXTRAS.get(name, (0, 0)))


def _phase(dec, A, vertex):
    nl, p = dec.ni_local, (dec.px, dec.py)
    return _j(block_staggered_nd(np.asarray(A), nl + (A.shape[-1],), p + (1,),
                                 (1, 1, 0) if vertex else (0, 0, 0)))


def jax_sharded(case: dc.Case) -> dict:
    """The case through the JAX package's sharded solver: the global fields
    (one dict per loading step for the VEP), ``err`` and ``iters``."""
    d = dc.inputs(case)
    n = case.n
    mesh = jax_mesh(case.mesh)
    if case.kind in ("thermal", "thermal3d"):
        from justrelax_tpu.parallel.thermal import (
            heatdiffusion_PT_sharded,
            heatdiffusion_PT_sharded_3d,
        )

        ndim = 2 if case.kind == "thermal" else 3
        g = Geometry((n,) * ndim, (1.0,) * ndim)
        bc = TemperatureBoundaryConditions(no_flux=Faces(**d["bc"]["no_flux"]),
                                           constant_value=Faces(**d["bc"]["constant_value"]))
        T = thermal_bcs(_j(d["T0"]), bc)
        K, rc, H = (_j(d[k]) for k in ("K", "rho_Cp", "H"))
        kw = {} if ndim == 2 else dict(CFL=0.9 / math.sqrt(3.0))
        pt = PTThermalCoeffs.make(K, rc, d["dt"], g.di, g.li, eps=1e-30, **kw)
        with mesh:
            if ndim == 2:
                dec = Decomp2D.make(g.ni, case.mesh)
                Tb = _j(block_staggered(np.asarray(T), dec, (2, 2)))
                Tb, err, iters = heatdiffusion_PT_sharded(
                    mesh, dec, Tb, K, rc, H, pt, bc, d["dt"], g.di, iter_max=case.iters,
                    nout=case.nout)
                Tg = unblock_staggered(np.asarray(Tb), dec, (2, 2))
            else:
                dec = Decomp3D.make(g.ni, case.mesh)
                nl = dec.ni_local
                Tb = _j(block_staggered_nd(np.asarray(T), nl, case.mesh, (2, 2, 2)))
                Tb, err, iters = heatdiffusion_PT_sharded_3d(
                    mesh, dec, Tb, K, rc, H, pt, bc, d["dt"], g.di, iter_max=case.iters,
                    nout=case.nout)
                Tg = unblock_staggered_nd(np.asarray(Tb), nl, case.mesh, (2, 2, 2))
        return dict(T=Tg, err=float(err), iters=int(iters))

    dec = Decomp2D.make((n, n), case.mesh)
    g = Geometry((n, n), (1.0, 1.0))
    if case.kind == "ve":
        from justrelax_tpu.parallel.stokes2d import solve_ve_sharded

        pt = PTStokesCoeffs.make(g.li, g.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0,
                                 eps_rel=0.0)
        z = np.zeros((n, n))
        glob = dict(Vx=np.zeros((n + 1, n + 2)), Vy=np.zeros((n + 2, n + 1)), P=z, P0=z,
                    Q=d["Q"], txx=z, tyy=z, txy=np.zeros((n + 1, n + 1)), txx_o=d["txx_o"],
                    tyy_o=d["tyy_o"], txy_o=d["txy_o"], eta=d["eta"], G=d["G"], K=d["K"],
                    rho_gx=d["rho_x"], rho_gy=d["rho_y"])
        blocks = {k: _B(dec, k, v) for k, v in glob.items()}
        blocks.update(inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
        with mesh:
            res = solve_ve_sharded(mesh, dec, blocks, pt, FS, d["dt"], iter_max=case.iters,
                                   nout=case.nout, overlap=case.overlap)
        out = {k: _unB(dec, k, getattr(res, k)) for k in dc.VE_FIELDS}
        out.update(err=float(res.err), iters=int(res.iters))
        return out

    from justrelax_tpu.rheology.materials import Material, MaterialStack

    zc, zv = np.zeros((n, n)), np.zeros((n + 1, n + 1))
    blocks = dict(P=zc, Q=zc, EII_pl=zc, eta=np.ones((n, n)), eta_v=np.ones_like(zv),
                  txx=zc, tyy=zc, txy_c=zc, txy_v=zv, txx_o=zc, tyy_o=zc, txy_c_o=zc,
                  txy_v_o=zv)
    if case.kind == "vep":
        from justrelax_tpu.parallel.stokes2d_vep import solve_vep_sharded

        tau_y, phi = 0.8, 30.0
        common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                      C=tau_y / math.cos(math.radians(phi)), friction_angle=phi,
                      eta_reg=8.0e-3)
        mat = MaterialStack.make([Material(G=1.0, **common), Material(G=0.5, **common)])
        pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0,
                                 CFL=0.75 / math.sqrt(2.1))
        blocks.update(Vx=d["Vx"], Vy=d["Vy"])
        blocks = {k: _B(dec, k, v) for k, v in blocks.items()}
        blocks.update(pr_c=_phase(dec, d["pr_c"], False), pr_v=_phase(dec, d["pr_v"], True),
                      inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
        inv = dict(inv_dx=blocks.pop("inv_dx"), inv_dy=blocks.pop("inv_dy"))
        # one compile for every step (the solver builds its shard_map anew
        # on each call)
        solve = jax.jit(lambda arrays: solve_vep_sharded(
            mesh, dec, dict(arrays, **inv), pt, FS, mat, d["dt"], iter_max=case.iters,
            iter_min=100, nout=case.nout))
        steps = []
        with mesh:
            for _ in range(case.nt):
                res = solve(blocks)
                for k in ("Vx", "Vy", "P", "eta", "eta_v", "txx", "tyy", "txy_c", "txy_v"):
                    blocks[k] = getattr(res, k)
                for k in ("txx", "tyy", "txy_c", "txy_v"):
                    blocks[k + "_o"] = getattr(res, k)
                out = {k: _unB(dec, k, getattr(res, k)) for k in dc.VEP_FIELDS}
                out.update(err=float(res.err), iters=int(res.iters))
                steps.append(out)
        return dict(steps=steps)

    from justrelax_tpu.parallel.stokes2d_variational import solve_variational_sharded

    mats = MaterialStack.make([
        Material(rho0=1.0, eta0=1.0, gravity=10.0),
        Material(rho0=0.0, eta0=1.0e-3, gravity=10.0),
        Material(rho0=2.0, eta0=1.0, gravity=10.0),
    ])
    pt = PTStokesCoeffs.make(g.li, g.di, eps_rel=0.0, eps_abs=0.0, CFL=1.0 / math.sqrt(2.1))
    blocks.update(Vx=np.zeros((n + 1, n + 2)), Vy=np.zeros((n + 2, n + 1)),
                  **{k: d[k] for k in ("phi_c", "phi_v", "vm_c", "vm_v", "vm_vx", "vm_vy")})
    blocks = {k: _B(dec, k, v) for k, v in blocks.items()}
    blocks.update(pr_c=_phase(dec, d["pr_c"], False), pr_v=_phase(dec, d["pr_v"], True),
                  inv_dx=1.0 / g.di[0], inv_dy=1.0 / g.di[1])
    with mesh:
        res = solve_variational_sharded(mesh, dec, blocks, pt, FS, mats, jnp.inf,
                                        iter_max=case.iters, iter_min=100, nout=case.nout)
    names = tuple(k for k in dc.VEP_FIELDS if k != "lam_v")
    out = {k: _unB(dec, k, getattr(res, k)) for k in names}
    out.update(err=float(res.err), iters=int(res.iters))
    return out


def global_diffs(a: dict, b: dict) -> dict:
    """Each field's max |a − b| over max |b| (both global)."""
    out = {}
    for k, ref in b.items():
        if k in ("err", "iters", "seconds") or k not in a:
            continue
        d = float(np.max(np.abs(np.asarray(a[k]) - ref), initial=0.0))
        out[k] = 0.0 if d == 0.0 else d / float(np.max(np.abs(ref), initial=0.0))
    return out


def as_global(case, result: dict) -> dict:
    """A gathered sharded result with its fields unblocked."""
    out = {k: (dc.unblock(case, k, v) if isinstance(v, np.ndarray) else v)
           for k, v in result.items()}
    return out


def assert_matches(case, port: dict, ref: dict, what: str):
    """Fields within FIELD_TOL of their max, equal iterations, err within
    ERR_RTOL, step by step."""
    for step, (a, b) in enumerate(zip(dc.steps_of(port), dc.steps_of(ref))):
        assert a["iters"] == b["iters"], (what, step)
        diffs = global_diffs(as_global(case, a), b)
        assert diffs and max(diffs.values()) <= FIELD_TOL, (what, step, diffs)
        assert a["err"] == pytest.approx(b["err"], rel=ERR_RTOL), (what, step)
