"""PyTorch port, a bare ``Material`` follows its fields: each public
rheology function, given a bare material and CPU fields, returns on the CPU
in the fields' dtype (float32 and float64), whether or not a card exists,
and equals the result from an explicit ``MaterialStack`` on the CPU in that
dtype; with no field to follow it raises. An explicit stack stands as given.
"""

import numpy as np
import pytest
import torch

from justrelax_tpu_torch.rheology import materials as pm
from justrelax_tpu_torch.rheology import plasticity as pp
from justrelax_tpu_torch.rheology import viscosity as pv

torch.set_num_threads(1)

KW = dict(rho0=3.1e3, alpha=1.5e-5, beta=1e-11, T0=273.0, P0=1e5, Cp=1.2e3, k=3.0, H_r=1e-6,
          G=3e10, Kb=6e10, eta0=1e21, disl_A=1e-16, disl_n=3.5, disl_E=530e3, is_plastic=1.0,
          C=1e7, friction_angle=30.0, dilation_angle=5.0, gravity=9.81)


def _calls(m, f, r):
    """(name, call) of every public rheology function on the material ``m``,
    fields ``f`` and phase ratios ``r``."""
    T, P, tau = f
    return {
        "compute_density": lambda: pm.compute_density(m, T=T, P=P, phase_ratios=r),
        "compute_density_P": lambda: pm.compute_density(m, P=P, phase_ratios=r),
        "compute_rhoCp": lambda: pm.compute_rhoCp(m, T=T, P=P, phase_ratios=r),
        "compute_conductivity": lambda: pm.compute_conductivity(m, T=T, phase_ratios=r),
        "compute_diffusivity": lambda: pm.compute_diffusivity(m, T=T, P=P, phase_ratios=r),
        "compute_radioactive_heating": lambda: pm.compute_radioactive_heating(m, r, like=T),
        "get_shear_modulus": lambda: pm.get_shear_modulus(m, r, like=T),
        "get_bulk_modulus": lambda: pm.get_bulk_modulus(m, r, like=T),
        "plastic_params_phase": lambda: pp.plastic_params_phase(m, tau, r).C_cosphi,
        "phase_viscosity": lambda: pv.phase_viscosity(m, tau, T, r, "tau", P=P),
        "powerlaw_recip_coeffs": lambda: pv.powerlaw_recip_coeffs(m, tau, T, r)[1],
    }


@pytest.mark.parametrize("with_ratios", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bare_material_follows_cpu_fields(dtype, with_ratios):
    rng = np.random.default_rng(0)
    shape = (5, 4)
    f = tuple(torch.tensor(x, dtype=dtype) for x in (
        rng.uniform(300.0, 1600.0, shape), rng.uniform(0.0, 1e9, shape),
        rng.uniform(1e6, 1e8, shape)))
    r = torch.ones(shape + (1,), dtype=dtype) if with_ratios else None
    bare = pm.Material(**KW)
    stack = pm.MaterialStack.make([bare], dtype=dtype, device="cpu")
    for name, call in _calls(bare, f, r).items():
        a = call()
        b = _calls(stack, f, r)[name]()
        assert a.device.type == "cpu" and a.dtype == dtype, name
        assert torch.equal(a, b), name
    for m in (bare, [bare, pm.Material(**KW)]):
        s = pm._as_stack(m, f[0])
        assert s.dtype == dtype and s.params.rho0.device.type == "cpu"
    assert pv._is_linear_creep(pm.Material(), f[0])
    assert pv.shared_powerlaw_exponent(bare, f[0]) == 2.5


def test_explicit_stack_stands_and_no_field_raises():
    T32 = torch.zeros(3, 3, dtype=torch.float32)
    stack64 = pm.MaterialStack.make([pm.Material(**KW)], device="cpu")
    assert pm._as_stack(stack64, T32) is stack64
    assert pm.compute_density(stack64, T=T32).dtype == torch.float64
    for call in (lambda: pm.get_shear_modulus(pm.Material(G=1.0)),
                 lambda: pm.compute_radioactive_heating(pm.Material()),
                 lambda: pm.compute_density(pm.Material()),
                 lambda: pv._is_linear_creep(pm.Material())):
        with pytest.raises(ValueError, match="bare Material"):
            call()
    with pytest.raises(TypeError):
        pm._as_stack("granite", T32)
