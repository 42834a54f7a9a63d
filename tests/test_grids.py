"""Atomic grid-construction variants (reference: src/atomic/basis.cpp:56-167):
finite-nucleus sub-grid, off-center boundary sections, confinement boundary."""

import numpy as np
import scipy.linalg as sla

from helfem_tpu.models.atomic import AtomicBasis
from helfem_tpu.ops.grids import concatenate_grid, form_grid, get_grid


def test_concatenate_grid():
    a = get_grid(2.0, 3, 1)
    b = get_grid(5.0, 4, 1)
    c = concatenate_grid(a, b)
    assert c[0] == 0.0 and abs(c[-1] - 7.0) < 1e-14
    assert len(c) == len(a) + len(b) - 1
    assert np.all(np.diff(c) > 0)


def test_form_grid_finite_nucleus():
    """Sub-grid boundaries at r_nuc and 2 r_nuc, model-dependent radius
    (reference: basis.cpp:56-68 + form_grid:126-140)."""
    Rrms = 0.05
    for model, rnuc in [("hollow", Rrms), ("spherical", np.sqrt(5.0 / 3.0) * Rrms),
                        ("gaussian", 3.0 * Rrms)]:
        bval = form_grid(model, Rrms, 6, 30.0, nelem0=3)
        assert np.any(np.isclose(bval, rnuc, rtol=1e-12)), model
        assert np.any(np.isclose(bval, 2 * rnuc, rtol=1e-12)), model
        assert len(bval) == 3 + 3 + 6 + 1
    # nelem0 = 0 disables the sub-grid
    assert len(form_grid("gaussian", Rrms, 6, 30.0, nelem0=0)) == 7


def test_form_grid_offcenter_and_boundary():
    """Off-center sections put boundaries at b0 = Z Rh/(Z+Zr) and at Rh;
    add_boundary inserts the confinement radius (basis.cpp:70-117,152-167)."""
    bval = form_grid("point", 0.0, 6, 30.0, nelem0=2, Z=2, Zr=1, Rhalf=3.0)
    assert np.any(np.isclose(bval, 2.0))  # b0 = 2*3/(2+1)
    assert np.any(np.isclose(bval, 3.0))  # Rhalf
    assert abs(bval[-1] - 30.0) < 1e-12
    bval2 = form_grid("point", 0.0, 6, 30.0, add_boundary=7.7)
    assert np.any(np.isclose(bval2, 7.7)) and len(bval2) == 8
    # boundary already present: not duplicated
    bval3 = form_grid("point", 0.0, 6, 30.0, add_boundary=float(bval2[-1]))
    assert len(bval3) == 7


def _e0_finite(nelem, nelem0, model="spherical", Rrms=0.05):
    b = AtomicBasis(Z=1, lmax=0, mmax=0, rmax=30.0, nelem=nelem, nnodes=8,
                    finitenuc=model, Rrms=Rrms, nelem0=nelem0)
    H = b.kinetic() + b.nuclear_model(model, Rrms)
    return sla.eigh(H, b.overlap(), eigvals_only=True)[0]


def test_finite_nucleus_subgrid_stability():
    """Hydrogen with an (exaggerated) uniformly-charged-ball nucleus: the
    spherical model's potential has a second-derivative kink at R0, so an
    element boundary there (the sub-grid) makes energies stable under nelem
    changes."""
    e4, e6, e8 = _e0_finite(4, 3), _e0_finite(6, 3), _e0_finite(8, 3)
    assert abs(e6 - e8) < 1e-8
    # coarse-grid error improves over the plain grid
    p4, p8 = _e0_finite(4, 0), _e0_finite(8, 0)
    assert abs(e4 - e8) < 0.6 * abs(p4 - p8)


def test_offcenter_boundary_beats_plain_grid():
    """Single-center H2+ (proton at origin + unit charge at Rmid = 2):
    eigenvalue vs the exact electronic energy -1.1026342144949; the element
    boundary at Rmid (and at b0) tightens the error at fixed lmax."""
    exact = -1.1026342144949

    def e0(lmax, nelem0):
        b = AtomicBasis(Z=1, lmax=lmax, mmax=0, rmax=30.0, nelem=6, nnodes=10,
                        Zl=0, Zr=1, Rmid=2.0, nelem0=nelem0)
        H = b.kinetic() + b.nuclear() + b.nuclear_offcenter(0, 1, 2.0)
        return sla.eigh(H, b.overlap(), eigvals_only=True)[0]

    err_b = abs(e0(16, 2) - exact)
    err_p = abs(e0(16, 0) - exact)
    assert err_b < err_p
    assert err_b < 1e-3
    # single-center expansion converges in lmax
    assert abs(e0(10, 2) - exact) > err_b
