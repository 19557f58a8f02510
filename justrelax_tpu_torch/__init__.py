"""justrelax_tpu_torch — the PyTorch/CUDA port of ``justrelax_tpu``.

The same staggered-grid accelerated pseudo-transient solvers, written in
PyTorch for an NVIDIA H100, with the JAX package's TPU kernels replaced by
hand-written Hopper kernels (``csrc/``, bound through ``ctypes`` in
``ops/hopper_*.py``). Module for module it mirrors ``justrelax_tpu`` under
the same public names; ``use_pallas`` becomes ``use_kernel``. The JAX
package stays the reference the port is tested against.

Importing the package needs no GPU: each CUDA kernel is built and loaded
at its first launch on a CUDA tensor.
"""

from justrelax_tpu_torch.core.coeffs import PTStokesCoeffs
from justrelax_tpu_torch.core.grid import Geometry
from justrelax_tpu_torch.core.state import StokesState
from justrelax_tpu_torch.ops.bc import VelocityBoundaryConditions, flow_bcs

__version__ = "0.1.0"

__all__ = [
    "Geometry",
    "PTStokesCoeffs",
    "StokesState",
    "VelocityBoundaryConditions",
    "flow_bcs",
]
