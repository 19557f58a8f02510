"""PyTorch port, the 3D PT thermal diffusion against the JAX package, in
float64 on the CPU:

- ``compute_flux`` (K path, material path, face phase ratios, constant
  flux), ``update_T`` and ``check_res`` (K path with adiabatic and Dirichlet
  terms, material path), one call each (1e-15);
- ``thermal_bcs`` for every combination of none, constant_value and no_flux
  over the six faces, edges and corners included, in JAX's face order
  (bit-equal), and periodic faces;
- ``heatdiffusion_PT`` at 8³ on the K/ρCp path and the material path: equal
  iterations, fields within 1e-10;
- ``diffusion3d.run(n=8)`` over two steps (1e-10), and its set-up bit-equal.

Differences are relative to each field's max, with no floor.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.core.coeffs import PTThermalCoeffs as JThermalCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.models import diffusion3d as jdiffusion3d
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import thermal as jops
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers.thermal import heatdiffusion_PT as j_heatdiffusion_PT
from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.models import diffusion3d
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import thermal as pops
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT
from test_torch_thermal import (
    MAT,
    MAT2,
    _faces,
    _info_close,
    _j,
    _rel,
    _res_scale,
    _t,
    _thermal_close,
)

torch.set_num_threads(1)

NI = (6, 5, 4)
FACES_3D = ("left", "right", "front", "back", "bot", "top")


def _fields(n=NI, seed=16):
    rng = np.random.default_rng(seed)
    nx, ny, nz = n
    g = (nx + 2, ny + 2, nz + 2)
    return dict(
        T=rng.uniform(500.0, 1500.0, g), Told=rng.uniform(500.0, 1500.0, g),
        qx=rng.standard_normal((nx + 1, ny, nz)), qy=rng.standard_normal((nx, ny + 1, nz)),
        qz=rng.standard_normal((nx, ny, nz + 1)),
        K=np.exp(rng.normal(size=n)), theta=rng.uniform(0.5, 2.0, n),
        P=rng.uniform(0.0, 1e9, n), H=rng.random(n) * 1e-6, sh=rng.random(n) * 1e-6,
        rc=rng.uniform(3e6, 4e6, n), dtau=rng.uniform(1e-7, 2e-7, n),
        ad=rng.random(n) * 1e-9, mask=rng.random(n) < 0.2,
        pr=rng.random(n + (2,)),
        prf=tuple(rng.random(tuple(m + (a == k) for k, m in enumerate(n)) + (2,))
                  for a in range(3)),
    )


def _stack(M, port):
    return M.MaterialStack.make([M.Material(**MAT), M.Material(**MAT2)],
                                **(dict(device="cpu") if port else {}))


INV_DI = (1.0 / 0.3, 1.0 / 0.2, 1.0 / 0.4)


@pytest.mark.parametrize("path", ["K", "material", "material_faces", "constant_flux"])
def test_compute_flux_3d(path):
    f = _fields()
    bc_flux = dict(left=1.5, back=-2.0, top=0.5) if path == "constant_flux" else {}
    out = []
    for port, conv, mod, M in ((True, _t, pops, pm), (False, _j, jops, jm)):
        if path in ("K", "constant_flux"):
            kw = dict(K=conv(f["K"]))
        else:
            kw = dict(material=_stack(M, port), P=conv(f["P"]))
        if path == "material_faces":
            kw["phase_ratios_faces"] = tuple(conv(x / x.sum(-1, keepdims=True)) for x in f["prf"])
        faces = (pbc if port else jbc).Faces(**bc_flux)
        q = (conv(f["qx"]), conv(f["qy"]), conv(f["qz"]))
        out.append(mod.compute_flux(q, q, conv(f["T"]), INV_DI, conv(f["theta"]), faces, **kw))
    for a, b in zip(out[0], out[1]):
        assert len(a) == 3
        for x, y in zip(a, b):
            assert _rel(x, y) <= 1e-15
    if path == "constant_flux":
        q = out[0][0]
        assert float(q[0][0, 0, 0]) == 1.5 and float(q[1][0, -1, 0]) == -2.0
        assert float(q[2][0, 0, -1]) == 0.5
    for name in ("face_average_x", "face_average_y", "face_average_z"):
        assert _rel(getattr(pops, name)(_t(f["K"])), getattr(jops, name)(_j(f["K"]))) == 0.0


@pytest.mark.parametrize("path", ["K", "K_adiabatic_dirichlet", "material"])
def test_update_T_and_check_res_3d(path):
    f = _fields()
    inv_dt = 1.0 / 3e11
    out = []
    for port, conv, mod, M in ((True, _t, pops, pm), (False, _j, jops, jm)):
        if path == "material":
            kw = dict(material=_stack(M, port), P=conv(f["P"]),
                      phase_ratios=conv(f["pr"] / f["pr"].sum(-1, keepdims=True)))
        else:
            kw = dict(rho_Cp=conv(f["rc"]))
        if path == "K_adiabatic_dirichlet":
            kw.update(adiabatic=conv(f["ad"]), dirichlet=(conv(f["mask"]), 1234.5))
        q = (conv(f["qx"]), conv(f["qy"]), conv(f["qz"]))
        args = (conv(f["T"]), conv(f["Told"]), q, conv(f["H"]), conv(f["sh"]), inv_dt, INV_DI)
        T = mod.update_T(*args[:5], inv_dt, INV_DI, conv(f["dtau"]), **kw)
        out.append((T, mod.check_res(*args, **kw)))
    for x, y in zip(*out):
        assert _rel(x, y) <= 1e-15
    T_port = out[0][0]
    assert np.array_equal(T_port[0].numpy(), f["T"][0])  # ghosts as they were
    if path == "K_adiabatic_dirichlet":
        assert (T_port[1:-1, 1:-1, 1:-1][_t(f["mask"])] == 1234.5).all()


def test_thermal_bcs_3d_every_face_combination():
    """Each of the six faces none, constant_value or no_flux: the whole
    ghosted T, edges and corners included, as the JAX package writes it
    (later faces overwrite the edge ghosts of earlier ones)."""
    rng = np.random.default_rng(19)
    n = 0
    for kinds in itertools.product(("none", "cv", "nf"), repeat=6):
        kw = dict(constant_value={f: float(rng.normal()) for f, k in zip(FACES_3D, kinds)
                                  if k == "cv"},
                  no_flux={f: True for f, k in zip(FACES_3D, kinds) if k == "nf"})
        T = rng.standard_normal((5, 4, 6))
        a = pbc.thermal_bcs(_t(T), _faces(kw, True))
        b = jbc.thermal_bcs(_j(T), _faces(kw, False))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(kinds))
        n += 1
    assert n == 3**6


_BC3 = {
    "both_on_faces": dict(constant_value=dict(left=2.0, front=1.0, top=-1.0),
                          no_flux=dict(left=True, back=True, bot=True)),
    "periodic_xy": dict(periodic=dict(left=True, right=True, front=True, back=True),
                        constant_value=dict(top=0.0, bot=1.0)),
    "periodic_all": dict(periodic={f: True for f in FACES_3D}, no_flux=dict(front=True)),
}


@pytest.mark.parametrize("case", sorted(_BC3))
def test_thermal_bcs_3d(case):
    T = np.random.default_rng(20).standard_normal((6, 5, 7))
    a = pbc.thermal_bcs(_t(T), _faces(_BC3[case], True))
    b = jbc.thermal_bcs(_j(T), _faces(_BC3[case], False))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not np.array_equal(a.numpy(), T)


# ---- the solve and the model ---------------------------------------------------
def _solve_inputs(port, n=8):
    """An 8³ unit cube: random smooth T between Dirichlet top and bottom,
    lognormal K, random H, shear heating and adiabatic term."""
    rng = np.random.default_rng(21)
    ni = (n, n, n)
    K = np.exp(0.3 * rng.normal(size=ni))
    rc = 1.0 + rng.random(ni)
    T = rng.random((n + 2, n + 2, n + 2))
    src = dict(H=rng.random(ni) * 0.1, shear_heating=rng.random(ni) * 0.05,
               adiabatic=rng.random(ni) * 0.01)
    conv = _t if port else _j
    kw = dict(device="cpu") if port else {}
    g = (Geometry if port else JGeometry)(ni, (1.0, 1.0, 1.0))
    th = (ThermalState if port else JThermalState).make(ni, **kw)
    th = th.replace(T=conv(T), Told=conv(T), **{k: conv(v) for k, v in src.items()})
    pt = (PTThermalCoeffs if port else JThermalCoeffs).make(conv(K), conv(rc), 0.3, g.di, g.li)
    return th, pt, g, conv(K), conv(rc)


_BC_SOLVE = dict(no_flux=dict(left=True, right=True, front=True, back=True),
                 constant_value=dict(top=0.0, bot=1.0))


@pytest.mark.parametrize("path", ["K", "material"])
def test_heatdiffusion_3d_matches_jax(path):
    outs = []
    for port in (True, False):
        th, pt, g, K, rc = _solve_inputs(port)
        M, conv = (pm, _t) if port else (jm, _j)
        bc = _faces(_BC_SOLVE, port)
        kw = dict(K=K, rho_Cp=rc, iter_max=4000, nout=200)
        if path == "material":
            mat = M.Material(rho0=1.0, alpha=1e-3, T0=0.0, Cp=1.0, k=1.0, H_r=0.05)
            P = conv(np.zeros(g.ni))
            pt = (PTThermalCoeffs if port else JThermalCoeffs).from_material(
                mat, th.T[1:-1, 1:-1, 1:-1], P, 0.3, g.di, g.li)
            kw = dict(material=mat, P=P, iter_max=4000, nout=200)
        if port:
            kw["use_kernel"] = False
        outs.append((heatdiffusion_PT if port else j_heatdiffusion_PT)(th, pt, bc, 0.3, g, **kw))
    (p_th, p_info), (j_th, j_info) = outs
    assert 0 < p_info.iters < 4000  # converged
    assert p_th.qTz is not None and tuple(p_th.qTz.shape) == (8, 8, 9)
    _thermal_close(p_th, j_th)
    rc = kw["rho_Cp"] if path == "K" else jm.compute_rhoCp(
        mat, T=j_th.T[1:-1, 1:-1, 1:-1], P=jnp.zeros(g.ni))
    _info_close(p_info, j_info, p_th, j_th, _res_scale(j_th.Told, rc, 0.3))


def test_heatdiffusion_3d_cpu_default_is_plain():
    """``use_kernel=None`` on CPU tensors is the plain path, in 3D too."""
    th, pt, g, K, rc = _solve_inputs(True)
    bc = _faces(_BC_SOLVE, True)
    a, ia = heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, iter_max=400, nout=100)
    b, ib = heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, iter_max=400, nout=100,
                             use_kernel=False)
    assert ia.iters == ib.iters and torch.equal(a.T, b.T)


def test_diffusion3d_matches_jax():
    kw = dict(n=8, ttot=2 * 50 * diffusion3d.KYR)
    p_th, p_info = diffusion3d.run(device="cpu", **kw)
    j_th, j_info = jdiffusion3d.run(**kw)
    assert float(p_info.err) < 1e-8
    _thermal_close(p_th, j_th)
    _info_close(p_info, j_info, p_th, j_th,
                _res_scale(j_th.Told, 3.1e3 * 1.2e3, 50 * diffusion3d.KYR))
    _, thermal, _, _ = diffusion3d._setup_thermal((8, 8, 8), (1e5,) * 3, None, "cpu")
    _, j_thermal, _, _ = jdiffusion3d._setup_thermal((8, 8, 8), (1e5,) * 3, None)
    assert _rel(thermal.T, j_thermal.T) == 0.0 and _rel(thermal.H, j_thermal.H) == 0.0


@pytest.mark.slow
def test_diffusion3d_golden():
    """tests/test_diffusion3d.py's goldens through the port (about a minute
    on one CPU thread)."""
    thermal, info = diffusion3d.run(n=32, device="cpu")
    T = thermal.T.numpy()
    assert T[15, 15, 15] == pytest.approx(1813.2470160788096, rel=1.0e-3)
    assert T[16, 16, 16] == pytest.approx(1831.2568044653274, rel=1.0e-3)
    assert float(info.err) < 1.0e-5
