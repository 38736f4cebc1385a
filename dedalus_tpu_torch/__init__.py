"""
dedalus_tpu_torch: the PyTorch/CUDA port of dedalus_tpu.

A second package beside the JAX package `dedalus_tpu`, which stays the
reference it is held against. Host-side symbolic and assembly code
(numpy/scipy) is carried over; device code is torch, with the JAX
package's one Pallas kernel (the banded substitution) rewritten by hand in
CUDA C++ for Hopper (csrc/banded_subst.cu).

Entry points run on `cuda` unless the caller passes `device="cpu"` to the
Distributor. The house dtype is float64.
"""

__version__ = "0.1.0"

from .tools.logging import setup_logging

setup_logging()
