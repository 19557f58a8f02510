"""The coefficients the 3D VE chunk kernel (B7) derives from η and ητ, on
the CPU:

- ``hopper_stokes3d.derive_coefficients`` (the kernel's operation order in
  plain PyTorch) is bit-equal to the packed canvases it replaces: on SolVi's
  first chunk as ``solve_ve_3d`` builds it (the general form, dt = ∞, ψ from
  η), on the ``viscous_consts`` route, and on the viscous and dt = ∞ forms
  of ``chip_smoke.ve3d_case``, in float64 and float32;
- the slot table the kernel reads (``kernel_slots``) marks every varying
  derivable canvas ``DERIVED`` where dt = ∞ and streams the rest; with a
  finite dt only the face coefficients inv_eta are derived, and c3, b and
  the elastic terms stream;
- ``streamed_words`` counts what the kernel then reads: SolVi's 22 words.
"""

import pytest
import torch

from chip_smoke import ve3d_case
from justrelax_tpu_torch.models import solvi3d
from justrelax_tpu_torch.ops import hopper_stokes3d as h3
from justrelax_tpu_torch.solvers.stokes3d import kernel_chunk_inputs

torch.set_num_threads(1)

NI = (11, 8, 6)


def _packed(name, dtype):
    """(packed coefficients with their derivation, the coefficient canvases
    by name) of one configuration."""
    if name == "solvi3d":
        geometry, st, pt, _, rho_g, G, K, dt = solvi3d._setup(
            nx=10, ny=9, nz=8, rc=2.0, dtype=dtype, device="cpu")
        _, packed, _ = kernel_chunk_inputs(st, pt, geometry, rho_g, G, K, dt)
    else:
        form = "viscous" if name == "viscous_consts" else name
        _, co, _, _, (consts, scalars) = ve3d_case(form, NI, dtype, "cpu")
        derive_from = (consts[0], consts[1], scalars)
        if name == "viscous_consts":
            co, derive_from = h3._coefficients(None, consts, scalars)
        packed = h3.pack_coeffs(co, dtype, derive_from)
    canvases = {n: packed.stack[s] for n, s in zip(h3.COEF_NAMES, packed.slots) if s >= 0}
    return packed, canvases


def _bits(t):
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["solvi3d", "viscous_consts", "viscous", "ve_dt_inf",
                                  "ve_general"])
def test_derivation_is_bit_equal(name, dtype):
    packed, canvases = _packed(name, dtype)
    d = packed.derived
    assert d is not None
    got = h3.derive_coefficients(d.base, d.c3_mode, d.scalars)
    for n in d.names:
        assert torch.equal(_bits(got[n]), _bits(canvases[n])), n


@pytest.mark.parametrize("name", ["solvi3d", "viscous_consts", "viscous", "ve_dt_inf",
                                  "ve_general"])
def test_slot_table_derives_and_streams(name):
    packed, canvases = _packed(name, torch.float64)
    slots = dict(zip(h3.COEF_NAMES, h3.kernel_slots(packed)))
    if name == "ve_general":  # finite dt: G, K, P0, Q and tau_o shape c3, b and d
        derived = h3.DERIVABLE[5:]
        for n in ("c1", "c2", "c3", "a_c", "b_c", "d_c0", "a_e0", "b_e0", "d_e0"):
            assert slots[n] >= 0, n
    else:
        derived = h3.DERIVABLE
    assert packed.derived.names == derived
    for n in h3.DERIVABLE:
        assert (slots[n] == h3.DERIVED) == (n in derived), n
    # what still streams is a canvas of the stack; the rest is derived, a
    # scalar or absent
    streams = {n for n, s in slots.items() if s >= 0}
    assert streams == set(canvases) - set(derived)
    if name == "solvi3d":
        assert streams == set() and h3.streamed_words(packed) == 22
        assert packed.derived.c3_mode == h3.C3_DOUBLE_RCP  # ψ = 1/(1/η + 1/(G dt))


def test_no_derivation_without_its_inputs():
    """Packed without ``derive_from``, every varying canvas streams."""
    _, co, _, _, _ = ve3d_case("viscous", NI, torch.float64, "cpu")
    packed = h3.pack_coeffs(co)
    assert packed.derived is None
    assert h3.kernel_slots(packed) == packed.slots
    assert h3.streamed_words(packed) == 20 + packed.stack.shape[0]
