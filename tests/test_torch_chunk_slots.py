"""PyTorch port, the host side of the tiled 2D chunk kernels, on the CPU:

- ``ops/slots.py``: packing a stack (uniform slots as scalars) and expanding
  it again gives back the stack bit for bit, on ``_vep_prepare``'s stacks
  in the four configurations of ``chip_smoke.chunk_case`` and on
  ``_ve_prepare``'s in the three of ``chip_smoke.ve_case``;
- the VE kernel's derived slots: ``eta_v`` and ``eta_tau`` are marked derived
  only where ``av_a`` / ``maxloc`` of the stack's η give the stack's own
  values;
- ``vep_chunk_words`` / ``ve_chunk_words``, the words per cell an iteration
  must move, on the main paths' inputs (25 on the shear band's first step,
  14 on SolCx) and on the random cases of the cuda tests.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import math

import pytest
import torch

from chip_smoke import (
    chunk_case,
    chunk_inputs_from_state,
    ve_case,
    ve_random_case,
    vep_random_case,
)
from justrelax_tpu_torch.models import shearband, solcx
from justrelax_tpu_torch.ops import hopper_stokes as hs
from justrelax_tpu_torch.ops import hopper_stokes_vep as hv
from justrelax_tpu_torch.ops.slots import (
    DERIVED,
    SCALAR,
    derive_slots,
    expand_slots,
    pack_slots,
)
from justrelax_tpu_torch.ops.stencil import maxloc

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64]


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _vep_stacks(args, kw):
    (_, _, theta, _, _, _, _, _, _, _, _, _, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII,
     material, pr_c, pr_v, T, dt, *_rest) = args
    _, visc_m = hv._resolve_static(material, None, "auto", like=theta)
    return hv._vep_prepare(theta, P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII, material,
                           pr_c, pr_v, T, kw.get("T_v"), dt, visc_m, theta.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["shearband", "dpcap", "powerlaw_noslip", "buoyancy"])
def test_vep_stacks_pack_and_expand_bit_for_bit(case, dtype):
    args, kw = chunk_case(case, 12, dtype, "cpu")
    for stack in _vep_stacks(args, kw):
        packed = pack_slots(stack)
        assert torch.equal(_bits(expand_slots(packed)), _bits(stack))
        # a scalar slot holds one value, a canvas slot more than one
        for k, i in enumerate(packed.index):
            assert (i == SCALAR) == bool((stack[k] == stack[k].reshape(-1)[0]).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["solcx", "ve_compressible", "elastic_buildup"])
def test_ve_stacks_pack_and_expand_bit_for_bit(case, dtype):
    args, kw = ve_case(case, 12, dtype, "cpu")
    P, txy, eta, eta_tau, rho_gx, rho_gy = args[2], args[5], *args[6:10]
    G, K, P0, Q, tau_o, dt = hs._ve_inputs(P, txy, kw.get("G"), kw.get("K"), kw.get("P0"),
                                           kw.get("Q"), kw.get("tau_o"), kw.get("dt"))
    for stack in hs._ve_prepare(eta, eta_tau, rho_gx, rho_gy, G, K, P0, Q, tau_o, dt, dtype):
        assert torch.equal(_bits(expand_slots(pack_slots(stack))), _bits(stack))


@pytest.mark.parametrize("vary", [True, False])
def test_ve_derived_slots(vary):
    """η_v is derived when the stack's slot is av_a(η) on the interior
    vertices; η_τ only when it equals maxloc(η)."""
    args, kw = ve_random_case((9, 13), torch.float64, "cpu", vary=vary)
    P, txy, eta, eta_tau, rho_gx, rho_gy = args[2], args[5], *args[6:10]
    pc, pv = hs._invariant_slots(P, txy, eta, eta_tau, rho_gx, rho_gy, kw.get("G"),
                                 kw.get("K"), kw.get("P0"), kw.get("Q"), kw.get("tau_o"),
                                 kw.get("dt"))
    assert pv.index[hs.VERTEX_SLOTS.index("eta_v")] == DERIVED
    derived_et = pc.index[hs.CELL_SLOTS.index("eta_tau")] == DERIVED
    assert derived_et == bool(torch.equal(eta_tau, maxloc(eta, 1)))
    assert derived_et is not vary
    # the derived slots' canvases left the stacks
    assert pv.stack.shape[0] == sum(i >= 0 for i in pv.index)
    assert pc.stack.shape[0] == sum(i >= 0 for i in pc.index)


def test_pack_slots_compares_bits():
    """-0.0 and 0.0 differ, a NaN slot is uniform, and derive_slots drops a
    canvas and keeps the scalars."""
    z = torch.zeros((3, 4))
    signed = z.clone()
    signed[1, 2] = -0.0
    stack = torch.stack([z, signed, torch.full((3, 4), math.nan), torch.arange(12.0).view(3, 4)])
    packed = pack_slots(stack)
    assert packed.index == (SCALAR, 0, SCALAR, 1)
    assert torch.equal(_bits(expand_slots(packed)), _bits(stack))
    derived = derive_slots(packed, [1])
    assert derived.index == (SCALAR, DERIVED, SCALAR, 0)
    assert torch.equal(derived.stack[0], stack[3])


def _shearband_first_step(n):
    geometry, material, pr_c, pr_v, st0, pt, _ = shearband._setup(
        n, dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0,
                C=1.6 / math.cos(math.radians(30.0)), friction_angle=30.0,
                eta_reg=8.0e-3), 0.5, torch.float32, "cpu",
        eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1))
    return chunk_inputs_from_state(st0, material, pr_c, pr_v, geometry, pt, 0.25)


def test_vep_chunk_words_on_the_main_path():
    """The shear band's first step: 11 carried fields read, 12 written, and
    the two slots that vary (1/(G dt) at cells and at vertices): 25."""
    args = _shearband_first_step(32)
    assert hv.vep_chunk_words(*args) == 25
    cinv, vinv = _vep_stacks(args, {})
    pc, pv = pack_slots(cinv), pack_slots(vinv)
    varying = [hv.CINV_SLOTS[k] for k, i in enumerate(pc.index) if i >= 0] + \
        [hv.VINV_SLOTS[k] for k, i in enumerate(pv.index) if i >= 0]
    assert varying == ["Gdt", "Gdt"]


@pytest.mark.parametrize("case,words", [("shearband", 25), ("dpcap", 25),
                                        ("powerlaw_noslip", 29), ("buoyancy", 24)])
def test_vep_chunk_words_on_the_parity_cases(case, words):
    args, kw = chunk_case(case, 12, torch.float64, "cpu")
    assert hv.vep_chunk_words(*args, **kw) == words


def test_vep_chunk_words_on_the_random_cases():
    modes = ("free_slip",) * 4
    a, k = vep_random_case((10, 14), modes, torch.float64, "cpu", vary=True)
    b, kb = vep_random_case((10, 14), modes, torch.float64, "cpu", vary=False)
    assert hv.vep_chunk_words(*a, **k) > hv.vep_chunk_words(*b, **kb) >= 23


def test_ve_chunk_words_on_the_main_path():
    """SolCx: the 6 unknowns read and written, η and ρg_y (η_τ and η_v are
    derived from η): 14."""
    n = 32
    geometry, st0, pt, _, rho_g, G, K, _ = solcx._setup(n, n, 1e6, 1.0, 1.0, torch.float32,
                                                        "cpu")
    eta = st0.viscosity.eta
    args = (st0.V.Vx, st0.V.Vy, st0.P, st0.tau.xx, st0.tau.yy, st0.tau.xy,
            eta, maxloc(eta, 1), *rho_g, 1.0 / geometry.di[0], 1.0 / geometry.di[1],
            pt.r, pt.theta_dtau, pt.etadtau)
    kw = dict(G=G, K=K, P0=st0.P0, Q=st0.Q,
              tau_o=(st0.tau_o.xx, st0.tau_o.yy, st0.tau_o.xy), dt=0.1)
    assert hs.ve_chunk_words(*args, **kw) == 14


@pytest.mark.parametrize("vary,words", [(True, 12 + 12), (False, 12)])
def test_ve_chunk_words_on_the_random_cases(vary, words):
    """Everything varies: the 10 cell slots (η_τ is read, not maxloc(η)) and
    the vertex 1/(G dt) and τxy_o (η_v derived); the viscous limit with a
    uniform η: every slot a scalar or derived."""
    args, kw = ve_random_case((10, 14), torch.float64, "cpu", vary=vary)
    assert hs.ve_chunk_words(*args, **kw) == words
