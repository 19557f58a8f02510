"""PyTorch port, the 2D PT thermal diffusion slice against the JAX package,
in float64 on the CPU:

- ``ThermalState``, ``PTThermalCoeffs`` (``make`` and ``from_material``),
  ``thermal_bcs`` (every face combination, corners included), the thermal
  material functions, ``compute_flux`` (K path, material path, constant
  flux), ``update_T`` (with and without adiabatic and Dirichlet) and
  ``check_res``, one call each (1e-15);
- the plain version of the Hopper chunk, ``thermal_chunk_reference``, against
  the JAX array loop (1e-13) and the JAX TPU kernel ``thermal_chunk_vmem`` in
  interpret mode (1e-12) at n=24, in the three configurations of
  ``chip_smoke.thermal_case``; the wrapper's CPU route and ``nout=0``;
- where the kernel is refused, and the arguments that are not ported;
- ``heatdiffusion_PT`` against the JAX solve (K/ρCp path, material path,
  Dirichlet mask), the frozen values ``chip_smoke.py`` checks on the card,
  and ``diffusion2d.run`` over three steps (1e-10).

Differences are relative to each field's max, with no floor (``_rel``).
"""

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import GOLDEN_THERMAL, TH_CASES, pallas_thermal_setup, thermal_case
from justrelax_tpu.core.coeffs import PTThermalCoeffs as JThermalCoeffs
from justrelax_tpu.core.grid import Geometry as JGeometry
from justrelax_tpu.core.state import ThermalState as JThermalState
from justrelax_tpu.models import diffusion2d as jdiffusion2d
from justrelax_tpu.ops import bc as jbc
from justrelax_tpu.ops import thermal as jops
from justrelax_tpu.ops.pallas_thermal import thermal_chunk_vmem
from justrelax_tpu.rheology import materials as jm
from justrelax_tpu.solvers.thermal import heatdiffusion_PT as j_heatdiffusion_PT
from justrelax_tpu_torch import convert
from justrelax_tpu_torch.core.coeffs import PTThermalCoeffs
from justrelax_tpu_torch.core.state import ThermalState
from justrelax_tpu_torch.models import diffusion2d
from justrelax_tpu_torch.ops import bc as pbc
from justrelax_tpu_torch.ops import hopper_thermal as ht
from justrelax_tpu_torch.ops import thermal as pops
from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.solvers.thermal import heatdiffusion_PT

torch.set_num_threads(1)

CPU = torch.device("cpu")
MAT = dict(rho0=3.1e3, alpha=1.5e-5, beta=1e-11, T0=273.0, P0=1e5, Cp=1.2e3, k=3.0, H_r=1e-6)
MAT2 = dict(rho0=2.7e3, alpha=3e-5, T0=273.0, Cp=1.0e3, k=2.2, H_r=3e-6)


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def _j(x):
    """A value for the JAX package: tensors and arrays to jax arrays, tuples
    element by element."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return jnp.asarray(np.asarray(x))
    if isinstance(x, tuple):
        return tuple(map(_j, x))
    return x


def _rel(a, b):
    """max |a − b| relative to max |b|, with no floor; 0 when both agree
    exactly."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.max(np.abs(a - b), initial=0.0)
    return 0.0 if d == 0.0 else d / np.max(np.abs(b), initial=0.0)


def _faces(kw, port):
    return (pbc if port else jbc).TemperatureBoundaryConditions(**kw)


# ---- state and coefficients ---------------------------------------------------
def test_thermal_state_make_and_convert():
    p = ThermalState.make((6, 5), device="cpu")
    j = JThermalState.make((6, 5))
    a, b = convert.to_state_dict(p), serialization.to_state_dict(j)
    assert a.keys() == b.keys()
    for k in a:
        if b[k] is None:
            assert a[k] is None
        else:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert not a[k].any()
    assert p.ni == (6, 5) and tuple(p.T_inner.shape) == (6, 5)
    assert ThermalState.make((4, 4), dtype=torch.float32, device="cpu").T.dtype == torch.float32
    rng = np.random.default_rng(1)
    j = j.replace(T=jnp.asarray(rng.standard_normal((8, 7))))
    back = convert.thermal_state_from_dict(serialization.to_state_dict(j), device="cpu")
    assert np.array_equal(back.T.numpy(), np.asarray(j.T))
    assert back.replace(H=back.H + 1.0).H.sum() == 30.0
    with pytest.raises(NotImplementedError):
        ThermalState.make((4, 4, 4), device="cpu")


@pytest.mark.parametrize("scalars", [False, True])
def test_pt_thermal_coeffs_make(scalars):
    rng = np.random.default_rng(2)
    ni, di, li = (7, 6), (0.1, 0.2), (0.7, 1.2)
    K, rc = (3.0, 3.3e6) if scalars else (np.exp(rng.normal(size=ni)), 1.0 + rng.random(ni))
    a = PTThermalCoeffs.make(_t(K) if not scalars else K, _t(rc) if not scalars else rc,
                             0.3, di, li, eps=1e-7)
    b = JThermalCoeffs.make(_j(K) if not scalars else K, _j(rc) if not scalars else rc,
                            0.3, di, li, eps=1e-7)
    for f in ("CFL", "eps", "max_lxyz", "Vpdtau"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("theta_r_dtau", "dtau_rho"):
        assert _rel(getattr(a, f), getattr(b, f)) <= 1e-15


@pytest.mark.parametrize("with_ratios", [False, True])
def test_pt_thermal_coeffs_from_material(with_ratios):
    rng = np.random.default_rng(3)
    ni = (7, 6)
    T, P = rng.uniform(300.0, 1600.0, ni), rng.uniform(0.0, 1e9, ni)
    r = rng.random(ni + (2,))
    r = r / r.sum(-1, keepdims=True) if with_ratios else None
    mats = [MAT, MAT2] if with_ratios else [MAT]
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    kw = dict(eps=1e-5, CFL=0.99 / math.sqrt(2.1))
    a = PTThermalCoeffs.from_material(pmat, _t(T), _t(P), 2.5e11, (1e3, 2e3), (7e3, 12e3),
                                      phase_ratios=_t(r), **kw)
    b = JThermalCoeffs.from_material(jmat, _j(T), _j(P), 2.5e11, (1e3, 2e3), (7e3, 12e3),
                                     phase_ratios=_j(r), **kw)
    for f in ("theta_r_dtau", "dtau_rho"):
        assert _rel(getattr(a, f), getattr(b, f)) <= 1e-15


# ---- boundary conditions ------------------------------------------------------
_BC_CASES = {
    "nf_lr_cv_tb": dict(no_flux=dict(left=True, right=True), constant_value=dict(top=0.0, bot=1.0)),
    "cv_all": dict(constant_value=dict(left=0.2, right=0.4, bot=1.0, top=-0.5)),
    "nf_all": dict(no_flux=dict(left=True, right=True, bot=True, top=True)),
    "cv_lr_nf_tb": dict(constant_value=dict(left=2.0, right=3.0), no_flux=dict(bot=True, top=True)),
    "cv_and_nf_same_face": dict(constant_value=dict(left=2.0, bot=1.0), no_flux=dict(left=True, top=True)),
    "one_face": dict(constant_value=dict(top=5.0)),
    "periodic_lr": dict(periodic=dict(left=True, right=True), constant_value=dict(top=0.0, bot=1.0)),
    "periodic_all": dict(periodic=dict(left=True, right=True, bot=True, top=True),
                         no_flux=dict(left=True)),
}


@pytest.mark.parametrize("case", sorted(_BC_CASES))
def test_thermal_bcs(case):
    T = np.random.default_rng(4).standard_normal((9, 8))
    a = pbc.thermal_bcs(_t(T), _faces(_BC_CASES[case], True))
    b = jbc.thermal_bcs(_j(T), _faces(_BC_CASES[case], False))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # corners included
    assert not np.array_equal(a.numpy(), T)


def test_thermal_bcs_every_face_combination():
    """Each face none, constant_value, no_flux, both, or periodic: the whole
    ghosted T, corners included, as the JAX package writes it."""
    rng = np.random.default_rng(9)
    names = ("bot", "top", "left", "right")
    for kinds in itertools.product(("none", "cv", "nf", "both", "periodic"), repeat=4):
        kw = dict(constant_value={f: float(rng.normal()) for f, k in zip(names, kinds)
                                  if k in ("cv", "both")},
                  no_flux={f: True for f, k in zip(names, kinds) if k in ("nf", "both")},
                  periodic={f: True for f, k in zip(names, kinds) if k == "periodic"})
        T = rng.standard_normal((6, 5))
        a = pbc.thermal_bcs(_t(T), _faces(kw, True))
        b = jbc.thermal_bcs(_j(T), _faces(kw, False))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(kinds))


# ---- material functions ---------------------------------------------------------
@pytest.mark.parametrize("with_ratios", [False, True])
@pytest.mark.parametrize("with_P", [False, True])
def test_thermal_material_functions(with_ratios, with_P):
    rng = np.random.default_rng(5)
    ni = (6, 5)
    T, P = rng.uniform(300.0, 1600.0, ni), rng.uniform(0.0, 1e9, ni) if with_P else None
    r = rng.random(ni + (2,))
    r = r / r.sum(-1, keepdims=True) if with_ratios else None
    mats = [MAT, MAT2]
    pmat = pm.MaterialStack.make([pm.Material(**m) for m in mats], device="cpu")
    jmat = jm.MaterialStack.make([jm.Material(**m) for m in mats])
    for name in ("compute_rhoCp", "compute_conductivity", "compute_diffusivity",
                 "compute_density"):
        a = getattr(pm, name)(pmat, T=_t(T), P=_t(P), phase_ratios=_t(r))
        b = getattr(jm, name)(jmat, T=_j(T), P=_j(P), phase_ratios=_j(r))
        assert _rel(a, b) <= 1e-15, name
    assert _rel(pm.compute_radioactive_heating(pmat, _t(r)),
                jm.compute_radioactive_heating(jmat, _j(r))) <= 1e-15


# ---- flux, update, residual ---------------------------------------------------
def _fields(n=(7, 6), seed=6):
    rng = np.random.default_rng(seed)
    nx, ny = n
    return dict(
        T=rng.uniform(500.0, 1500.0, (nx + 2, ny + 2)),
        Told=rng.uniform(500.0, 1500.0, (nx + 2, ny + 2)),
        qx=rng.standard_normal((nx + 1, ny)), qy=rng.standard_normal((nx, ny + 1)),
        K=np.exp(rng.normal(size=n)), theta=rng.uniform(0.5, 2.0, n),
        P=rng.uniform(0.0, 1e9, n), H=rng.random(n) * 1e-6, sh=rng.random(n) * 1e-6,
        rc=rng.uniform(3e6, 4e6, n), dtau=rng.uniform(1e-7, 2e-7, n),
        ad=rng.random(n) * 1e-9, mask=rng.random(n) < 0.2,
        pr=rng.random(n + (2,)), prx=rng.random((nx + 1, ny, 2)), pry=rng.random((nx, ny + 1, 2)),
    )


@pytest.mark.parametrize("path", ["K", "material", "material_faces", "constant_flux"])
def test_compute_flux(path):
    f = _fields()
    inv_di = (1.0 / 0.3, 1.0 / 0.2)
    bc_flux = dict(left=1.5, top=-2.0) if path == "constant_flux" else {}
    out = []
    for port, conv, mod, M in ((True, _t, pops, pm), (False, _j, jops, jm)):
        kw = dict(K=conv(f["K"])) if path in ("K", "constant_flux") else dict(
            material=M.MaterialStack.make([M.Material(**MAT), M.Material(**MAT2)],
                                          **(dict(device="cpu") if port else {})),
            P=conv(f["P"]))
        if path == "material_faces":
            prf = [x / x.sum(-1, keepdims=True) for x in (f["prx"], f["pry"])]
            kw["phase_ratios_faces"] = tuple(map(conv, prf))
        faces = (pbc if port else jbc).Faces(**bc_flux)
        q = (conv(f["qx"]), conv(f["qy"]))
        out.append(mod.compute_flux(q, q, conv(f["T"]), inv_di, conv(f["theta"]), faces, **kw))
    for a, b in zip(out[0], out[1]):
        for x, y in zip(a, b):
            assert _rel(x, y) <= 1e-15
    if path == "constant_flux":
        assert float(out[0][0][0][0, 0]) == 1.5 and float(out[0][1][1][0, -1]) == -2.0


@pytest.mark.parametrize("path", ["K", "K_adiabatic_dirichlet", "material"])
def test_update_T_and_check_res(path):
    f = _fields()
    inv_di, inv_dt = (1.0 / 0.3, 1.0 / 0.2), 1.0 / 3e11
    out = []
    for port, conv, mod, M in ((True, _t, pops, pm), (False, _j, jops, jm)):
        if path == "material":
            kw = dict(material=M.Material(**MAT), P=conv(f["P"]))  # a bare material
        else:
            kw = dict(rho_Cp=conv(f["rc"]))
        if path == "K_adiabatic_dirichlet":
            kw.update(adiabatic=conv(f["ad"]), dirichlet=(conv(f["mask"]), 1234.5))
        q = (conv(f["qx"]), conv(f["qy"]))
        args = (conv(f["T"]), conv(f["Told"]), q, conv(f["H"]), conv(f["sh"]), inv_dt, inv_di)
        T = mod.update_T(*args[:5], inv_dt, inv_di, conv(f["dtau"]), **kw)
        out.append((T, mod.check_res(*args, **kw)))
    for x, y in zip(*out):
        assert _rel(x, y) <= 1e-15
    if path == "K_adiabatic_dirichlet":
        assert (out[0][0][1:-1, 1:-1][_t(f["mask"])] == 1234.5).all()
        assert (out[0][1][_t(f["mask"])] == 0.0).all()


# ---- the chunk: plain version against the JAX loop and the TPU kernel ---------
def _case(name, n=24):
    args, kw = thermal_case(name, n, torch.float64, CPU)
    jargs = tuple(_j(a) for a in args[:-1]) + (
        jbc.TemperatureBoundaryConditions(**{
            k: dataclasses.asdict(getattr(args[-1], k)) for k in
            ("no_flux", "constant_value", "constant_flux", "periodic")}),)
    return args, kw, jargs, {k: _j(v) for k, v in kw.items()}


def _jax_loop(jargs, jkw, nout):
    """heatdiffusion_PT's array-path iteration, as tests/test_pallas_thermal.py
    runs it."""
    T, qx, qy, Told, K, rc, H_tot, dtau, theta, inv_dt, inv_dx, inv_dy, bc = jargs
    q = (qx, qy)
    for _ in range(nout):
        q, _ = jops.compute_flux(q, q, T, (inv_dx, inv_dy), theta, bc.constant_flux, K=K)
        T = jops.update_T(T, Told, q, H_tot, 0.0, inv_dt, (inv_dx, inv_dy), dtau, rho_Cp=rc,
                          adiabatic=jkw["adiabatic"])
        T = jbc.thermal_bcs(T, bc)
    return T, q[0], q[1]


@pytest.mark.parametrize("nout", [1, 40])
@pytest.mark.parametrize("case", TH_CASES)
def test_chunk_reference_matches_jax(case, nout):
    pargs, pkw, jargs, jkw = _case(case)
    out = ht.thermal_chunk_reference(*pargs, nout=nout, **pkw)
    loop = _jax_loop(jargs, jkw, nout)
    tpu = thermal_chunk_vmem(*jargs, nout=nout, interpret=True, **jkw)
    for name, a, b, c in zip(("T", "qx", "qy"), out, loop, tpu):
        # the set-up's T varies along y only: its first x-flux is zero
        moves = not (case == "pallas_setup" and name == "qx" and nout == 1)
        assert float(np.abs(np.asarray(b)).max()) > 0.0 or not moves, name
        assert _rel(a, b) <= 1e-13, f"{name}: {_rel(a, b)} vs the JAX loop"
        assert _rel(a, c) <= 1e-12, f"{name}: {_rel(a, c)} vs the TPU kernel"
    assert _rel(out[0], pargs[0]) > 0.0  # T moved


def test_chunk_cpu_route_and_nout_zero():
    pargs, pkw, _, _ = _case("dirichlet_box", n=12)
    ht.thermal_chunk.launches = 0
    out = ht.thermal_chunk(*pargs, nout=3, **pkw)
    ref = ht.thermal_chunk_reference(*pargs, nout=3, **pkw)
    assert ht.thermal_chunk.launches == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    same = ht.thermal_chunk(*pargs, nout=0, **pkw)
    assert all(a is b for a, b in zip(same, pargs[:3]))
    assert ht.thermal_chunk.launches == 0


def test_bc_recipe_order():
    bc = pbc.TemperatureBoundaryConditions(constant_value=dict(left=2.0, bot=1.0),
                                           no_flux=dict(left=True, top=True))
    codes, values = ht._bc_recipe(bc)
    assert codes == [1, 0, 1, 0, 0, 2, 2, 0]  # (cv, nf) x (bot, top, left, right)
    assert values == [1.0, 0.0, 2.0, 0.0]


# ---- where the kernel is refused ----------------------------------------------
def _solve_inputs(n, port):
    g, K, rc, _, Tg = pallas_thermal_setup(n, torch.float64, CPU)
    ni = g.ni
    if port:
        th = ThermalState.make(ni, device="cpu").replace(T=Tg, Told=Tg)
        return th, PTThermalCoeffs.make(K, rc, 0.3, g.di, g.li), g, K, rc
    jg = JGeometry(ni, (1.0, 1.0))
    jK, jrc, jT = _j(K), _j(rc), _j(Tg)
    th = JThermalState.make(ni).replace(T=jT, Told=jT)
    return th, JThermalCoeffs.make(jK, jrc, 0.3, jg.di, jg.li), jg, jK, jrc


_REFUSED = {
    "periodic": (dict(periodic=dict(left=True, right=True), constant_value=dict(top=0.0, bot=1.0)), {}),
    "constant_flux": (dict(constant_flux=dict(left=0.5), constant_value=dict(top=0.0, bot=1.0)), {}),
    "material": (dict(constant_value=dict(top=0.0, bot=1.0)), dict(material=True)),
    "dirichlet": (dict(constant_value=dict(top=0.0, bot=1.0)), dict(dirichlet=True)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_kernel_refused_where_jax_refuses(case):
    bc_kw, extra = _REFUSED[case]
    n = 16
    for port in (False, True):
        th, pt, g, K, rc = _solve_inputs(n, port)
        conv, M = (_t, pm) if port else (_j, jm)
        kw = dict(K=K, rho_Cp=rc, iter_max=100, nout=50)
        if extra.get("material"):
            kw = dict(material=M.Material(**MAT), P=conv(np.zeros((n, n))), iter_max=100, nout=50)
        if extra.get("dirichlet"):
            kw["dirichlet"] = (conv(np.zeros((n, n), bool)), 0.5)
        bc = _faces(bc_kw, port)
        if port:
            reason = ht.thermal_chunk_unsupported(bc, g, kw.get("K"), kw.get("rho_Cp"),
                                                  kw.get("material"), kw.get("dirichlet"))
            assert reason is not None
            with pytest.raises(ValueError, match="use_kernel=False"):
                heatdiffusion_PT(th, pt, bc, 0.3, g, use_kernel=True, **kw)
        else:
            with pytest.raises(ValueError):
                j_heatdiffusion_PT(th, pt, bc, 0.3, g, use_pallas=True, **kw)
    th, pt, g, K, rc = _solve_inputs(n, True)
    ok = _faces(dict(no_flux=dict(left=True), constant_value=dict(top=0.0)), True)
    assert ht.thermal_chunk_supported(ok)
    assert ht.thermal_chunk_unsupported(ok, g, K, rc) is None  # an adiabatic term is taken


def test_not_ported_arguments():
    th, pt, g, K, rc = _solve_inputs(8, True)
    bc = _faces(dict(constant_value=dict(top=0.0, bot=1.0)), True)
    for kw in (dict(halo_exchange=lambda a: a), dict(reduce_norm=lambda a: a)):
        with pytest.raises(NotImplementedError):
            heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, **kw)

    @dataclasses.dataclass(frozen=True)
    class Nonuniform:
        di = g.di
        inv_flux_di = g.di

    with pytest.raises(NotImplementedError):
        heatdiffusion_PT(th, pt, bc, 0.3, Nonuniform(), K=K, rho_Cp=rc)
    with pytest.raises(ValueError):
        heatdiffusion_PT(th, pt, bc, 0.3, g, K=K, rho_Cp=rc, use_kernel="edges")
    assert ht.thermal_chunk_unsupported(bc, Nonuniform(), K, rc) == "needs a uniform grid"
    assert "halo" in ht.thermal_chunk_unsupported(bc, g, K, rc, halo_exchange=lambda a: a)


# ---- the solve and the model against the JAX package ---------------------------
def _thermal_close(port_state, jax_state, tol=1e-10):
    a = convert.to_state_dict(port_state)
    b = serialization.to_state_dict(jax_state)
    assert a.keys() == b.keys()
    for k in a:
        if b[k] is None:
            assert a[k] is None
        elif k == "ResT":  # a residual: rounding is absolute on its terms' scale
            continue
        else:
            assert _rel(a[k], b[k]) <= tol, (k, _rel(a[k], b[k]))


def _res_scale(Told, rho_Cp, dt):
    """The size of the terms the heat-equation residual sums (ρCp·T/dt): the
    residual and its norm are differences of such terms, so their rounding
    is absolute on this scale (near convergence the norm itself is
    rounding)."""
    return float(np.abs(np.asarray(Told)).max() * np.abs(np.asarray(rho_Cp)).max() / dt)


def _info_close(p_info, j_info, p_th, j_th, scale, tol=1e-10):
    """Iteration counts equal; the err history and ResT within ``tol`` of
    the residual scale."""
    assert p_info.iters == int(j_info.iters)
    x, y = np.asarray(p_info.err_history), np.asarray(j_info.err_history)
    assert np.array_equal(np.isnan(x), np.isnan(y))
    assert np.nanmax(np.abs(x - y)) <= tol * scale
    assert np.abs(np.asarray(p_th.ResT) - np.asarray(j_th.ResT)).max() <= tol * scale


_SOLVES = ("K_plain", "K_kernel_route", "material", "dirichlet")


@pytest.mark.parametrize("case", _SOLVES)
def test_heatdiffusion_matches_jax(case):
    """On CPU tensors ``use_kernel=True`` runs the wrapper's CPU route."""
    n = 16
    rng = np.random.default_rng(8)
    ni = (n, n)
    H, sh, ad = rng.random(ni) * 0.1, rng.random(ni) * 0.05, rng.random(ni) * 0.01
    outs = []
    for port in (True, False):
        th, pt, g, K, rc = _solve_inputs(n, port)
        conv, M = (_t, pm) if port else (_j, jm)
        th = th.replace(H=conv(H), shear_heating=conv(sh), adiabatic=conv(ad))
        bc = _faces(dict(no_flux=dict(left=True, right=True), constant_value=dict(top=0.0, bot=1.0)),
                    port)
        kw = dict(K=K, rho_Cp=rc, iter_max=4000, nout=200)
        if case == "material":
            mat = M.Material(rho0=1.0, alpha=1e-3, T0=0.0, Cp=1.0, k=1.0, H_r=0.05)
            P = conv(np.zeros(ni))
            pt = (PTThermalCoeffs if port else JThermalCoeffs).from_material(
                mat, th.T[1:-1, 1:-1], P, 0.3, g.di, g.li)
            kw = dict(material=mat, P=P, iter_max=4000, nout=200)
        if case == "dirichlet":
            mask = np.zeros(ni, bool)
            mask[5:8, 6:9] = True
            kw["dirichlet"] = (conv(mask), 0.25)
        if port:
            kw["use_kernel"] = case == "K_kernel_route"
        outs.append((heatdiffusion_PT if port else j_heatdiffusion_PT)(th, pt, bc, 0.3, g, **kw))
    (p_th, p_info), (j_th, j_info) = outs
    assert 0 < p_info.iters < 4000  # converged
    _thermal_close(p_th, j_th)
    rc = kw["rho_Cp"] if case != "material" else jm.compute_rhoCp(
        mat, T=j_th.T[1:-1, 1:-1], P=jnp.zeros(ni))
    _info_close(p_info, j_info, p_th, j_th, _res_scale(j_th.Told, rc, 0.3))


def test_golden_thermal_constants_match_jax():
    """``chip_smoke.GOLDEN_THERMAL`` is the JAX solve's f64 result, and the
    port's default path on the CPU reproduces it."""
    n = 32
    outs = []
    for port in (False, True):
        th, pt, g, K, rc = _solve_inputs(n, port)
        solve = heatdiffusion_PT if port else j_heatdiffusion_PT
        t, i = solve(th, pt, _faces(dict(no_flux=dict(left=True, right=True),
                                         constant_value=dict(top=0.0, bot=1.0)), port),
                     0.3, g, K=K, rho_Cp=rc, iter_max=4000, nout=200)
        outs.append(dict(iters=int(i.iters), err=float(i.err), T_centre=float(t.T[17, 17]),
                         T_corner_lo=float(t.T[1, 1]), T_corner_hi=float(t.T[32, 32])))
    jax_v, port_v = outs
    assert jax_v == pytest.approx(GOLDEN_THERMAL, rel=1e-13)
    assert port_v["iters"] == GOLDEN_THERMAL["iters"]
    for k in ("T_centre", "T_corner_lo", "T_corner_hi"):
        assert port_v[k] == pytest.approx(GOLDEN_THERMAL[k], rel=1e-10)


def test_diffusion2d_matches_jax():
    kw = dict(nx=16, ny=16, ttot=3 * 50 * diffusion2d.KYR)
    p_th, p_info = diffusion2d.run(device="cpu", **kw)
    j_th, j_info = jdiffusion2d.run(**kw)
    assert float(p_info.err) < 1e-8
    _thermal_close(p_th, j_th)
    _info_close(p_info, j_info, p_th, j_th, _res_scale(j_th.Told, 3.1e3 * 1.2e3, 50 * diffusion2d.KYR))
    geometry, material, thermal, bc = diffusion2d.setup(16, 16, device="cpu")
    _, _, j_thermal, _ = jdiffusion2d.setup(16, 16)
    assert _rel(thermal.T, j_thermal.T) == 0.0 and _rel(thermal.H, j_thermal.H) == 0.0
