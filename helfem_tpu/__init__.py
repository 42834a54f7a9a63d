"""helfem_tpu: finite-element electronic-structure suite in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of HelFEM (Helsinki
Finite Element Suite): fully numerical Hartree-Fock and DFT on atoms and
diatomic molecules using high-order 1D finite elements combined with exact
angular expansions.

Design (vs the C++/Armadillo/OpenMP reference):
  * element-stacked tensor layouts ([nelem, nq, nprim]) instead of per-element
    loops; global assembly by masked scatter-add,
  * batched einsum contractions over (L, M, element) axes for the Coulomb and
    exchange builds instead of OpenMP channel-pair loops,
  * prefix sums (cumsum over the element axis) for the cross-element
    factorized two-electron terms instead of O(Nel^2) loops,
  * batched whitened symmetric eigensolves over symmetry blocks,
  * IEEE float64 on device (GPU or CPU), with setup tables built on host
    in extended precision (numpy longdouble).
"""

from helfem_tpu.utils.config import setup_x64

setup_x64()

__version__ = "0.2.0"

# Library globals (reference: helfem::verbose / set_verbosity() / version(),
# libhelfem/include/helfem.source.h:26-41). The CLI drivers consult
# `verbose` for their per-phase timing printouts.
verbose: bool = False


def set_verbosity(v: bool) -> None:
    """Enable/disable library-wide verbose output."""
    global verbose
    verbose = bool(v)


def version() -> str:
    """Library version string."""
    return __version__
