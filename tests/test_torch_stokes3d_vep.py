"""PyTorch port, the 3D VEP ops, the canvas chunk and the edge kernel's plain
version against the JAX package, in float64 on the CPU:

- the serial ``update_stresses_center_edges_3d`` at (6, 5, 4) from random
  states near yield, plasticity on and off, Kb finite and ∞, with and
  without the hoisted ``make_vep_params_3d``: every output within 1e-14 of
  its field's max; ``make_vep_params_3d`` field by field;
- ``canvas_moves`` against ``serial_moves`` on the slots each family owns,
  and the closed-form index clamps that ``csrc/stokes3d_vep.cu`` evaluates
  against ``canvas_moves`` on a non-cubic grid;
- ``vep3d_canvas_consts`` in its three forms (the plain chunk's, B6's and
  B9's) and with buoyancy and a power-law creep table, against JAX's;
- the plain canvas chunk against JAX's ``vep3d_chunk_canvas`` at 8³, nit 1
  and 5, under tests/test_pallas_vep3d_blocked.py's ``_ATOL``;
- ``vep3d_edges_reference`` in its B6 and B9 forms against the TPU kernels
  ``vep3d_edges_blocked``/``vep3d_edges_split`` in interpret mode, one call
  each at 6³ with plasticity on, on the owned slots;
- the wrapper's CPU route, ``pack_edge_consts``' scalars, and the guard;
- the fused chunk (B8): its plain version against the TPU kernel
  ``stokes3d_vep_chunk_blocked`` in interpret mode, two iterations at 8³,
  plasticity on and off, under ``_ATOL``; the wrapper's CPU route; and
  ``pack_chunk_consts``.
"""

import math
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import vep3d_numpy
from justrelax_tpu.ops import stokes3d_vep as jvep
from justrelax_tpu.ops import stokes3d_vep_canvas as jcv
from justrelax_tpu.ops.pallas_stokes3d_vep_blocked import stokes3d_vep_chunk_blocked
from justrelax_tpu.ops.pallas_stokes3d_vep_blocked import vep3d_blocked_supported as j_supported
from justrelax_tpu.ops.pallas_vep3d_edges import vep3d_edges_blocked, vep3d_edges_split
from justrelax_tpu.rheology.materials import Material as JMaterial
from justrelax_tpu.rheology.materials import MaterialStack as JMaterialStack
from justrelax_tpu.rheology.phases import phase_ratios_from_field as j_ratios
from justrelax_tpu_torch.ops import hopper_stokes3d_vep as hc
from justrelax_tpu_torch.ops import hopper_vep3d_edges as he
from justrelax_tpu_torch.ops import stokes3d_vep as pvep
from justrelax_tpu_torch.ops import stokes3d_vep_canvas as pcv
from justrelax_tpu_torch.rheology.materials import Material, MaterialStack
from justrelax_tpu_torch.rheology.phases import phase_ratios_from_field
from justrelax_tpu_torch.solvers.stokes3d_vep import edges_unsupported

torch.set_num_threads(1)

NI = (6, 5, 4)
NAMES = ("yz", "xz", "xy")
AXES = ((1, 2), (0, 2), (0, 1))
# tests/test_pallas_vep3d_blocked.py:108
_ATOL = {False: 1e-14, True: 1e-9}


def _t(x):
    if isinstance(x, (tuple, list)):
        return tuple(map(_t, x))
    if x is None:
        return None
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def _j(x):
    if isinstance(x, (tuple, list)):
        return tuple(map(_j, x))
    if x is None:
        return None
    return jnp.asarray(np.asarray(x))


def _rel(a, b):
    """max |a − b| relative to max |b|; 0 when they agree exactly."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.max(np.abs(a - b), initial=0.0)
    return 0.0 if d == 0.0 else d / np.max(np.abs(b), initial=0.0)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    if hasattr(x, "_fields"):
        return [v for f in x._fields for v in _leaves(getattr(x, f))]
    return [] if x is None else [x]


def _materials(mats):
    return (MaterialStack.make([Material(**m) for m in mats], device="cpu"),
            JMaterialStack.make([JMaterial(**m) for m in mats]))


def _mats(plastic=True, Kb=4.0, **extra):
    common = dict(rho0=0.0, Kb=Kb, is_plastic=1.0,
                  C=(0.3 if plastic else 1.0e9) / math.cos(math.radians(30.0)),
                  friction_angle=30.0, dilation_angle=8.0, eta_reg=1.0e-2, **extra)
    return [dict(G=1.0, eta0=1.0, **common), dict(G=0.6, eta0=0.2, **common)]


# ---- the serial fused update ------------------------------------------------
def _serial_inputs(seed=3):
    """Random staggered fields at NI around the yield stress 0.3."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = NI
    es = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz))

    def r(*shape, scale=0.3):
        return scale * rng.standard_normal(shape)

    return dict(
        eps_c3=tuple(r(*NI) for _ in range(3)), eps_e3=tuple(r(*s) for s in es),
        tau_c6=tuple(r(*NI) for _ in range(6)), tau_e3=tuple(r(*s) for s in es),
        tau_o_c6=tuple(r(*NI) for _ in range(6)), tau_o_e3=tuple(r(*s) for s in es),
        Pr=r(*NI, scale=0.2), eta=np.exp(r(*NI)), lam=np.abs(r(*NI, scale=0.05)),
        lam_e3=tuple(np.abs(r(*s, scale=0.05)) for s in es),
        EII_pl=np.abs(r(*NI, scale=0.01)), phase=(rng.random(NI) < 0.4).astype(np.int64))


_KEYS = ("eps_c3", "eps_e3", "tau_c6", "tau_e3", "tau_o_c6", "tau_o_e3", "Pr", "eta", "lam",
         "lam_e3", "EII_pl")


def _serial_call(mod, args, material, ratios, hoisted):
    pr_c, pr_e = ratios
    params = None
    if hoisted:
        params = mod.make_vep_params_3d(material, args[10], pr_c, pr_e, args[4], args[5])
    return mod.update_stresses_center_edges_3d(*args, material, pr_c, pr_e, 0.2, 0.25, 0.7,
                                               params=params)


# JAX's side under one jit per form (op-by-op dispatch costs ~15 s here)
_jax_serial = jax.jit(partial(_serial_call, jvep), static_argnums=(3,))


@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("Kb", [4.0, math.inf], ids=["Kb4", "Kbinf"])
@pytest.mark.parametrize("plastic", [False, True])
def test_update_stresses_match_jax(plastic, Kb, hoisted):
    d = _serial_inputs()
    pmat, jmat = _materials(_mats(plastic, Kb))
    pr_p = phase_ratios_from_field(torch.as_tensor(d["phase"]), 2)
    pr_j = j_ratios(jnp.asarray(d["phase"]), 2)
    got = _serial_call(pvep, [_t(d[k]) for k in _KEYS], pmat,
                       (pr_p.center, (pr_p.edge_yz, pr_p.edge_xz, pr_p.edge_xy)), hoisted)
    want = _jax_serial([_j(d[k]) for k in _KEYS], jmat,
                       (pr_j.center, (pr_j.edge_yz, pr_j.edge_xz, pr_j.edge_xy)), hoisted)
    for name in want._fields:
        for k, (a, b) in enumerate(zip(_leaves(getattr(got, name)),
                                       _leaves(getattr(want, name)))):
            assert _rel(a.numpy(), b) <= 1e-14, (name, k, _rel(a.numpy(), b))
    if plastic:
        assert float(got.lam.max()) > 0.0 and min(float(t.max()) for t in got.lam_e) > 0.0
    else:
        assert torch.equal(got.lam, _t(d["lam"]))


def test_make_vep_params_3d_match_jax():
    d = _serial_inputs(seed=4)
    pmat, jmat = _materials(_mats(True, 4.0, tension_pT=-0.5))
    pr_p = phase_ratios_from_field(torch.as_tensor(d["phase"]), 2)
    pr_j = j_ratios(jnp.asarray(d["phase"]), 2)
    got = pvep.make_vep_params_3d(pmat, _t(d["EII_pl"]), pr_p.center,
                                  (pr_p.edge_yz, pr_p.edge_xz, pr_p.edge_xy),
                                  _t(d["tau_o_c6"]), _t(d["tau_o_e3"]))
    want = jvep.make_vep_params_3d(jmat, _j(d["EII_pl"]), pr_j.center,
                                   (pr_j.edge_yz, pr_j.edge_xz, pr_j.edge_xy),
                                   _j(d["tau_o_c6"]), _j(d["tau_o_e3"]))
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        assert _rel(x.numpy(), y) <= 1e-15, k


# ---- the canvas moves and the kernel's closed-form clamps -------------------
def test_canvas_moves_match_serial_moves():
    """Each canvas move on the slots its destination owns equals the serial
    move on the staggered arrays."""
    rng = np.random.default_rng(0)
    nx, ny, nz = NI
    sm, cm = pvep.serial_moves(NI), pcv.canvas_moves(NI)
    es = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1), (nx + 1, ny + 1, nz))
    C = torch.as_tensor(rng.random(NI) + 0.5)
    E = tuple(torch.as_tensor(rng.standard_normal(s)) for s in es)
    for k in range(3):
        for fn in ("center_to_edge", "harm_center_to_edge"):
            got = pcv.extract_edge(getattr(cm, fn)(pcv.embed_center(C), *AXES[k]), k)
            assert _rel(got, getattr(sm, fn)(C, *AXES[k])) <= 1e-15, (fn, k)
        for m in range(3):
            if m != k:
                got = pcv.extract_edge(cm.other_to_edge(NAMES[m], NAMES[k],
                                                        pcv.embed_edge(E[m], m)), k)
                assert _rel(got, sm.other_to_edge(NAMES[m], NAMES[k], E[m])) == 0.0, (m, k)
        got = pcv.extract_center(cm.edge_to_center(pcv.embed_edge(E[k], k), *AXES[k]))
        assert _rel(got, sm.edge_to_center(E[k], *AXES[k])) <= 1e-15, k


def _clamp(v, lo, hi):
    return min(max(v, lo), hi)


def _avg4(a, b, c, d):
    return 0.5 * (0.5 * (a + b) + 0.5 * (c + d))


@pytest.mark.parametrize("ni", [(5, 4, 3), (3, 6, 4)])
def test_kernel_clamp_rules_match_canvas_moves(ni):
    """The index rules ``csrc/stokes3d_vep.cu`` evaluates in closed form
    (``center_points``, ``other_points``), restated per slot, against the
    canvas moves of the plain version on every owned slot of a non-cubic
    grid: center → edge k averages the centers at clamp(j, 1, n) and
    clamp(j+1, 1, n) over k's edge axes, lower axis first; family m → edge
    k pairs j−1 and min(j, n−1) along k's normal axis, clamp(q, 1, n) and
    clamp(q+1, 1, n) along m's, and reads min(p, n−1) along the third."""
    n = ni
    shape = tuple(v + 2 for v in ni)
    A = torch.as_tensor(np.random.default_rng(1).standard_normal(shape))
    An = A.numpy()
    cm = pcv.canvas_moves(ni)
    _, Me = pcv.edge_masks(shape)
    for K in range(3):
        owned = [tuple(s) for s in np.argwhere(Me[K].expand(shape).numpy())]
        ce = cm.center_to_edge(A, *AXES[K]).numpy()
        a0, a1 = AXES[K]
        for s in owned:
            pts = []
            for w in (_clamp(s[a1], 1, n[a1]), _clamp(s[a1] + 1, 1, n[a1])):
                for u in (_clamp(s[a0], 1, n[a0]), _clamp(s[a0] + 1, 1, n[a0])):
                    c = list(s)
                    c[a0], c[a1] = u, w
                    pts.append(An[tuple(c)])
            assert _avg4(*pts) == ce[s], ("center", K, s)
        for M in range(3):
            if M == K:
                continue
            oe = cm.other_to_edge(NAMES[M], NAMES[K], A).numpy()
            so, do, sh = K, M, 3 - K - M
            for s in owned:
                pts = []
                for q in (_clamp(s[do], 1, n[do]), _clamp(s[do] + 1, 1, n[do])):
                    for j in (s[so] - 1, min(s[so], n[so] - 1)):
                        c = [0, 0, 0]
                        c[so], c[do], c[sh] = j, q, min(s[sh], n[sh] - 1)
                        pts.append(An[tuple(c)])
                assert _avg4(*pts) == oe[s], ("other", M, K, s)


# ---- the canvas consts and chunk ---------------------------------------------
def _canvas_inputs(name, n=8):
    """Port and JAX (carry, consts keywords, inv_di, chunk keywords) from
    chip_smoke.vep3d_numpy; "buoyant_powerlaw" adds ρ(T)·g and a power-law
    creep table to the non-cubic configuration."""
    d = vep3d_numpy("noncubic_near_yield" if name == "buoyant_powerlaw" else name, n)
    mats = d["mats"]
    T = None
    if name == "buoyant_powerlaw":
        mats = [dict(m, rho0=1.0 + k, alpha=0.1, T0=0.5, beta=0.01, gravity=1.0,
                     disl_A=0.5, disl_n=3.0) for k, m in enumerate(mats)]
        T = 0.5 + 0.1 * np.random.default_rng(2).standard_normal(d["ni"])
    pmat, jmat = _materials(mats)
    out = []
    for mod, conv, mat, ratios in ((pcv, _t, pmat, phase_ratios_from_field),
                                   (jcv, _j, jmat, j_ratios)):
        pr = ratios(conv(d["phase"]), 2)
        carry = mod.pack_vep_carry(conv(d["V"]), conv(d["P"]), conv(d["theta"]),
                                   conv(d["tau_c"]), conv(d["tau_e"]), conv(d["eta"]),
                                   conv(d["lam"]), conv(d["lam_e"]))
        ckw = dict(material=mat, tau_o_c6=conv(d["tau_o_c"]), tau_o_e3=conv(d["tau_o_e"]),
                   EII_pl=conv(d["EII"]), P0=conv(d["P0"]), Q=conv(d["Q"]),
                   phase_ratios_center=pr.center,
                   phase_ratios_edges=(pr.edge_yz, pr.edge_xz, pr.edge_xy), T=conv(T))
        out.append((carry, ckw))
    from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
    from justrelax_tpu_torch.core.grid import Geometry

    g = Geometry(d["ni"], d["li"])
    pt = PTStokesCoeffs.make(g.li, g.di, CFL=d["CFL"])
    kw = dict(dt=d["dt"], r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0e-2)
    return out, tuple(1.0 / v for v in g.di), kw, (pmat, jmat)


_FORMS = {"plain": {}, "B6": dict(hoist_tau_o=False, scalar_plastic=True, scalar_K=True),
          "B9": dict(scalar_plastic=True, scalar_K=True)}


@pytest.mark.parametrize("name", ["noncubic_near_yield", "buoyant_powerlaw"])
@pytest.mark.parametrize("form", sorted(_FORMS))
def test_canvas_consts_match_jax(form, name):
    (_, pkw), (_, jkw) = _canvas_inputs(name)[0]
    """Every const canvas equal; the hoisted τ_o interpolants on the slots
    their family owns, where they are read (JAX's default "slice" shift
    zero-fills the wrapped slots that the port's roll fills, and neither is
    read)."""
    got = pcv.vep3d_canvas_consts(**pkw, **_FORMS[form])
    want = jcv.vep3d_canvas_consts(**jkw, **_FORMS[form])
    assert got.visc_m == want.visc_m
    hoisted = got.params.tau_o6_e
    _, Me = pcv.edge_masks(tuple(got.P0.shape))
    for field in want._fields:
        if field == "visc_m":
            continue
        a, b = getattr(got, field), getattr(want, field)
        if field == "params":
            a, b = a._replace(tau_o6_e=None), b._replace(tau_o6_e=None)
        a, b = _leaves(a), _leaves(b)
        assert len(a) == len(b), field
        for k, (x, y) in enumerate(zip(a, b)):
            assert _rel(np.asarray(x), y) <= 1e-15, (field, k)
    assert (hoisted is None) == (want.params.tau_o6_e is None)
    for k in range(3 if hoisted is not None else 0):
        m = Me[k].expand(got.P0.shape).numpy()
        for j, (x, y) in enumerate(zip(hoisted[k], want.params.tau_o6_e[k])):
            assert _rel(x.numpy()[m], np.asarray(y)[m]) <= 1e-15, (k, j)


_jax_chunk = jax.jit(jcv.vep3d_chunk_canvas)   # nout traced: one compile


@pytest.mark.parametrize("nit", [1, 5])
@pytest.mark.parametrize("plastic", [False, True])
def test_plain_chunk_matches_jax(plastic, nit):
    """The set-up of tests/test_pallas_vep3d_blocked.py at 8³: the port's
    plain canvas chunk against JAX's ``vep3d_chunk_canvas`` (both on the
    plain chunk's consts), under that file's tolerances."""
    name = "blocked_plastic" if plastic else "blocked_elastic"
    ((pc, pkw), (jc, jkw)), inv_di, kw, (pmat, jmat) = _canvas_inputs(name)
    got = pcv.vep3d_chunk_canvas(pc, pcv.vep3d_canvas_consts(**pkw), pmat, inv_di, nit, **kw)
    want = _jax_chunk(jc, jcv.vep3d_canvas_consts(**jkw), jmat, inv_di, nit, **kw)
    for k, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_ATOL[plastic],
                                   err_msg=str(k))
    if plastic and nit == 5:
        assert float(got.lam.max()) > 0.0


@pytest.mark.parametrize("split", [False, True], ids=["B6", "B9"])
def test_edges_reference_matches_tpu_kernel(split):
    """One call at 6³ with plasticity on: the plain version of B6/B9 against
    the TPU kernel in interpret mode, on the slots each family owns (the TPU
    kernel leaves the others to the iteration's mask)."""
    ((pc, pkw), (jc, jkw)), inv_di, kw, _ = _canvas_inputs("blocked_plastic", n=6)
    forms = dict(scalar_plastic=True, scalar_K=True, hoist_tau_o=split)
    pco, jco = pcv.vep3d_canvas_consts(**pkw, **forms), jcv.vep3d_canvas_consts(**jkw, **forms)
    ekw = dict(dt=kw["dt"], theta_dtau=kw["theta_dtau"],
               lambda_relaxation=kw["lambda_relaxation"])
    # a state after one plain iteration, so that every field is non-trivial
    pc = pcv.vep3d_chunk_canvas(pc, pcv.vep3d_canvas_consts(**pkw), pkw["material"],
                                inv_di, 1, **kw)
    jc = jcv.VEP3DCanvasCarry(*(_j(f) for f in pc))
    got = he.vep3d_edges_reference(pc.V, pc.theta, pc.eta, pc.tau_c[:3], pc.tau_e, pc.lam_e,
                                   pco, inv_di, split=split, **ekw)
    t0 = time.perf_counter()
    fn = vep3d_edges_split if split else vep3d_edges_blocked
    want = fn(jc.V, jc.theta, jc.eta, jc.tau_c, jc.tau_e, jc.lam_e, jco, inv_di,
              interpret=True, plane_block=4, **ekw)
    print(f"interpret-mode call: {time.perf_counter() - t0:.1f} s")
    _, Me = pcv.edge_masks(tuple(pc.P.shape))
    for k in range(3):
        m = Me[k].expand(pc.P.shape).numpy()
        for a, b in ((got[0][k], want[0][k]), (got[1][k], want[1][k])):
            assert _rel(a.numpy()[m], np.asarray(b)[m]) <= 1e-14, k
    assert max(float(t.max()) for t in got[1]) > 0.0


def test_vep3d_edges_cpu_route():
    """On CPU tensors the wrapper is its plain version, with no launch."""
    ((pc, pkw), _), inv_di, kw, _ = _canvas_inputs("noncubic_near_yield")
    ekw = dict(dt=kw["dt"], theta_dtau=kw["theta_dtau"],
               lambda_relaxation=kw["lambda_relaxation"])
    he.vep3d_edges.launches = he.vep3d_edges.split_launches = 0
    for split in (False, True):
        co = pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True, scalar_K=True,
                                     hoist_tau_o=split)
        args = (pc.V, pc.theta, pc.eta, pc.tau_c[:3], pc.tau_e, pc.lam_e)
        a = he.vep3d_edges(*args, co, inv_di, split=split, **ekw)
        b = he.vep3d_edges_reference(*args, he.pack_edge_consts(co, split), inv_di,
                                     split=split, **ekw)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert he.vep3d_edges.launches == he.vep3d_edges.split_launches == 0


def test_pack_edge_consts_scalars_are_exact():
    """A G_e or old-stress canvas uniform on the slots it is read on goes in
    as its value; the plain version on consts whose scalar sources are
    replaced by canvases of that value everywhere (ghosts included) equals
    it on the originals: the slots outside the read region are never
    read."""
    d = vep3d_numpy("blocked_plastic", 6)   # τxx_o = −τyy_o = 0.3 uniform
    ((pc, pkw), _), inv_di, kw, _ = _canvas_inputs("blocked_plastic", n=6)
    ekw = dict(dt=kw["dt"], theta_dtau=kw["theta_dtau"],
               lambda_relaxation=kw["lambda_relaxation"])
    for split in (False, True):
        co = pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True, scalar_K=True,
                                     hoist_tau_o=split)
        packed = he.pack_edge_consts(co, split)
        # every τ_o source is uniform on its read slots here; G_e is not
        assert all(t is None for fam in packed.tau_o for t in fam)
        assert all(g is not None for g in packed.G)
        assert packed.tau_o_val[0][:2] == (d["tau_o_c"][0][0, 0, 0], d["tau_o_c"][1][0, 0, 0])

        def filled(t, v):
            return t if v is None else torch.full_like(t, v)

        p = co.params
        if split:
            params = p._replace(tau_o6_e=tuple(
                tuple(torch.full_like(t, v) for t, v in zip(fam, vals))
                for fam, vals in zip(p.tau_o6_e, packed.tau_o_val)))
            co2 = co._replace(params=params)
        else:
            vals = packed.tau_o_val[0]
            co2 = co._replace(tau_o_c=tuple(torch.full_like(t, v) for t, v in
                                            zip(co.tau_o_c[:3], vals[:3])) + co.tau_o_c[3:],
                              tau_o_e=tuple(torch.full_like(t, v)
                                            for t, v in zip(co.tau_o_e, vals[3:])))
        args = (pc.V, pc.theta, pc.eta, pc.tau_c[:3], pc.tau_e, pc.lam_e)
        a = he.vep3d_edges_reference(*args, co, inv_di, split=split, **ekw)
        b = he.vep3d_edges_reference(*args, co2, inv_di, split=split, **ekw)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_pack_edge_consts_canvases():
    """Non-uniform sources stay canvases; the B6 form shares its six sources
    across the families, B9 has six per family."""
    ((_, pkw), _), _, _, _ = _canvas_inputs("noncubic_near_yield")
    b6 = he.pack_edge_consts(pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True,
                                                     scalar_K=True, hoist_tau_o=False))
    assert all(g is not None for g in b6.G)
    assert all(t is not None for t in b6.tau_o[0])
    assert all(a is b for a, b in zip(b6.tau_o[0], b6.tau_o[2]))
    b9 = he.pack_edge_consts(pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True,
                                                     scalar_K=True), split=True)
    assert all(t is not None for fam in b9.tau_o for t in fam)
    assert len(b9.scalars) == len(he._PP_FIELDS) + 1
    with pytest.raises(ValueError, match="scalar_plastic"):
        he.pack_edge_consts(pcv.vep3d_canvas_consts(**pkw))
    with pytest.raises(ValueError, match="hoist_tau_o"):
        he.pack_edge_consts(pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True,
                                                    scalar_K=True, hoist_tau_o=False),
                            split=True)


@pytest.mark.parametrize("change", ["none", "soft_C_active", "C", "Kb", "friction_angle",
                                    "soft_C_nl"])
def test_guard_matches_jax(change):
    mats = _mats()
    if change in ("C", "Kb", "friction_angle"):
        mats[1] = dict(mats[1], **{change: mats[1][change] * 2.0})
    elif change != "none":
        mats = [dict(m, **{change: 1.0}) for m in mats]
    pmat, jmat = _materials(mats)
    assert he.vep3d_blocked_supported(pmat) == bool(j_supported(jmat))
    assert (edges_unsupported(pmat) is None) == (change == "none")


def test_pack_unpack_vep_carry_round_trip():
    d = vep3d_numpy("noncubic_near_yield")
    fields = tuple(_t(d[k]) for k in ("V", "P", "theta", "tau_c", "tau_e", "eta", "lam",
                                      "lam_e"))
    c = pcv.pack_vep_carry(*fields)
    assert all(t.shape == (13, 10, 8) for t in _leaves(c))
    back = pcv.unpack_vep_carry(c)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(fields)))


_B8 = dict(hoist_tau_o=False, scalar_plastic=True, scalar_K=True)


@pytest.mark.parametrize("plastic", [False, True])
def test_chunk_reference_matches_tpu_kernel(plastic):
    """Two iterations at 8³ of tests/test_pallas_vep3d_blocked.py's set-up:
    the plain version of B8 against the TPU kernel in interpret mode, every
    carry canvas under that file's tolerances."""
    name = "blocked_plastic" if plastic else "blocked_elastic"
    ((pc, pkw), (jc, jkw)), inv_di, kw, _ = _canvas_inputs(name, n=8)
    got = hc.stokes3d_vep_chunk_reference(pc, pcv.vep3d_canvas_consts(**pkw, **_B8), inv_di,
                                          2, **kw)
    t0 = time.perf_counter()
    want = stokes3d_vep_chunk_blocked(jc, jcv.vep3d_canvas_consts(**jkw, **_B8), inv_di, 2,
                                      interpret=True, plane_block=4, iters_per_pass=1, **kw)
    print(f"interpret-mode chunk: {time.perf_counter() - t0:.1f} s")
    for k, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_ATOL[plastic],
                                   err_msg=str(k))


@pytest.mark.parametrize("name", ["noncubic_near_yield", "buoyant_powerlaw"])
def test_stokes3d_vep_chunk_cpu_route(name):
    """On CPU tensors the wrapper is its plain version (the canvas chunk on
    B8's consts), with no launch."""
    ((pc, pkw), _), inv_di, kw, (pmat, _) = _canvas_inputs(name)
    co = pcv.vep3d_canvas_consts(**pkw, **_B8)
    hc.stokes3d_vep_chunk.launches = 0
    a = hc.stokes3d_vep_chunk(pc, co, inv_di, 3, **kw)
    b = pcv.vep3d_chunk_canvas(pc, co, pmat, inv_di, 3, **kw)
    c = hc.stokes3d_vep_chunk(pc, hc.pack_chunk_consts(co), inv_di, 3, **kw)
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(_leaves(a), _leaves(b), _leaves(c)))
    assert hc.stokes3d_vep_chunk.launches == 0


def test_pack_chunk_consts():
    """Which consts go in as canvases: the moduli and the viscosity target
    where they vary over the cells (or the family's edges), the old stresses
    where uniform as their values, no body force and the linear creep form
    as flags; with buoyancy and a power law, fzA/fzB and visc_A/visc_B."""
    ((_, pkw), _), _, _, _ = _canvas_inputs("blocked_plastic", n=6)
    pk = hc.pack_chunk_consts(pcv.vep3d_canvas_consts(**pkw, **_B8))
    names = dict(zip(hc.CONST_NAMES, zip(pk.canvases, pk.values)))
    assert len(pk.canvases) == len(pk.values) == len(hc.CONST_NAMES) == 20
    for nm in ("G_c", "G_e0", "G_e1", "G_e2", "visc_eta"):
        assert names[nm][0] is not None, nm
    assert names["tau_o_c0"] == (None, 0.3) and names["tau_o_c1"] == (None, -0.3)
    for nm in ("tau_o_c2", "tau_o_e0", "P0", "Q", "fzA", "fzB", "visc_A", "visc_B"):
        assert names[nm] == (None, 0.0), nm
    assert pk.linear and not pk.has_fz and pk.visc_m == 0.0
    assert len(pk.scalars) == len(he._PP_FIELDS) + 1 and pk.scalars[-1] == 4.0
    assert hc.pack_chunk_consts(pk) is pk

    ((_, pkw), _), _, _, _ = _canvas_inputs("buoyant_powerlaw")
    pk = hc.pack_chunk_consts(pcv.vep3d_canvas_consts(**pkw, **_B8))
    names = dict(zip(hc.CONST_NAMES, pk.canvases))
    assert pk.has_fz and not pk.linear and pk.visc_m == 2.0
    assert names["fzA"] is not None and names["fzB"] is not None
    assert names["visc_eta"] is None   # the power law's A and B are uniform here
    with pytest.raises(ValueError, match="scalar_plastic"):
        hc.pack_chunk_consts(pcv.vep3d_canvas_consts(**pkw))
    with pytest.raises(ValueError, match="scalar_K"):
        hc.pack_chunk_consts(pcv.vep3d_canvas_consts(**pkw, scalar_plastic=True))


def test_pack_chunk_consts_scalars_are_exact():
    """A const canvas uniform on the slots it is read on goes in as its
    value: the plain chunk on consts whose scalar sources are replaced by
    canvases of that value everywhere (ghosts included) equals it on the
    originals, so the slots outside the read regions are never read."""
    ((pc, pkw), _), inv_di, kw, (pmat, _) = _canvas_inputs("blocked_plastic", n=6)
    co = pcv.vep3d_canvas_consts(**pkw, **_B8)
    pk = hc.pack_chunk_consts(co)
    src = dict(zip(hc.CONST_NAMES, (co.params.G_c, *co.params.G_e, *co.tau_o_c,
                                    *co.tau_o_e, co.P0, co.Q)))
    full = {nm: torch.full_like(t, v) if c is None else t
            for (nm, t), c, v in zip(src.items(), pk.canvases, pk.values)}
    assert sum(c is None for c in pk.canvases[:15]) >= 10
    co2 = co._replace(
        params=co.params._replace(G_c=full["G_c"],
                                  G_e=tuple(full[f"G_e{k}"] for k in range(3))),
        tau_o_c=tuple(full[f"tau_o_c{j}"] for j in range(6)),
        tau_o_e=tuple(full[f"tau_o_e{j}"] for j in range(3)), P0=full["P0"], Q=full["Q"])
    a = pcv.vep3d_chunk_canvas(pc, co, pmat, inv_di, 3, **kw)
    b = pcv.vep3d_chunk_canvas(pc, co2, pmat, inv_di, 3, **kw)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
