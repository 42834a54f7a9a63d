"""Range-separated hybrid SCF tests (reference: kshort*rs_exchange wiring,
src/atomic/main.cpp:708-779; range_separation, src/general/dftfuncs.cpp)."""

import numpy as np
import pytest

from helfem_tpu.models.atomic import AtomicBasis
from helfem_tpu.scf.atomic_scf import scf_atom

BASIS = dict(lmax=0, mmax=0, rmax=15.0, nelem=5, nnodes=8, nquad=40)


def _run(method, Z=4, nela=2, nelb=2, **kw):
    b = AtomicBasis(Z=Z, **BASIS)
    return scf_atom(b, nela, nelb, method=method, convthr=1e-9, maxit=60, **kw)


def test_parse_method_rs_spec():
    from helfem_tpu.ops.xc import parse_method, parse_method_rs

    s = parse_method_rs("lc-lda[omega=0.4]")
    assert s.kfull == 1.0 and s.kshort == -1.0 and s.omega == 0.4
    assert s.kernel == "erfc"
    assert any("lda_x_erf" in f.name for f in s.funcs)
    y = parse_method_rs("lcy-lda")
    assert y.kernel == "yukawa" and y.omega == 0.5
    # non-RS methods unchanged through the old interface
    funcs, kfrac = parse_method("pbe0")
    assert kfrac == 0.25
    with pytest.raises(ValueError):
        parse_method("lc-lda")  # RS must go through parse_method_rs


def test_sr_hybrid_omega_limits():
    """sr-pbe0 (alpha=0, beta=0.25, semilocal 0.75 PBE_x + PBE_c):
    omega -> 0 reproduces the global PBE0 hybrid exactly (0.75 PBE_x +
    0.25 K_full + PBE_c); omega -> inf drops the exact exchange, leaving
    the pure semilocal part."""
    E_pbe0 = _run("pbe0").E
    # omega = 0 exactly: kshort folds into kfrac (no tables built)
    E_w0 = _run("sr-pbe0[omega=0]").E
    assert abs(E_w0 - E_pbe0) < 1e-10
    # small omega: erfc kernel ~ full kernel. The in-element product
    # quadrature across the r=r' kink floors the agreement at ~1e-3 relative
    # on the exchange (same floor as the reference's erfc path; see
    # tests/test_yukawa.py) -> ~1e-3 Ha here, far below the PBE<->PBE0 gap
    E_small = _run("sr-pbe0[omega=1e-3]").E
    assert abs(E_small - E_pbe0) < 2e-3
    # large omega: exact exchange vanishes; the limit is the semilocal part
    # alone, constructed exactly by zeroing kshort
    E_limit = _run("sr-pbe0[omega=0,kshort=0]").E
    E_big = _run("sr-pbe0[omega=40.0]").E
    assert abs(E_big - E_limit) < 5e-3  # large-omega quadrature floor
    assert abs(E_limit - E_pbe0) > 0.1  # the limits are distinguishable


def test_lc_lda_omega_limits():
    """LC-LDA: omega -> 0 gives pure LDA (SR functional -> full Slater, HF
    parts cancel); omega -> inf gives HF exchange + PW92 correlation."""
    E_lda = _run("lda").E
    E_w0 = _run("lc-lda[omega=0]").E
    assert abs(E_w0 - E_lda) < 1e-7
    E_small = _run("lc-lda[omega=1e-3]").E
    assert abs(E_small - E_lda) < 5e-3  # erfc small-omega quadrature floor
    E_big = _run("lc-lda[omega=60.0]").E
    E_hfc = _run("hf").E  # HF (no correlation) should be ABOVE HF+PW92c
    assert E_big < E_hfc
    assert E_big > E_hfc - 0.3  # PW92 correlation for Be is ~ -0.22 Ha


def test_lc_lda_finite_omega_converges():
    """A finite-omega LC-LDA SCF converges and sits between its limits."""
    res = _run("lc-lda[omega=0.5]")
    assert res.converged
    E_lda = _run("lda").E
    E_inf = _run("lc-lda[omega=60.0]").E
    lo, hi = min(E_lda, E_inf), max(E_lda, E_inf)
    assert lo - 0.05 < res.E < hi + 0.05
    # the Exx component must be active (long-range HF)
    assert res.Exx < -0.1


def test_yukawa_rs_scf():
    """Yukawa-kernel RS exchange through the same wiring."""
    res = _run("lcy-lda[omega=0.7]")
    assert res.converged
    # yukawa-screened exchange is weaker than full exchange: between limits
    E_lda = _run("lda").E
    assert res.E != pytest.approx(E_lda, abs=1e-6)


def test_rs_unrestricted():
    """RS exchange in the unrestricted branch (Li, spin-polarized)."""
    res = _run("lc-lda[omega=0.5]", Z=3, nela=2, nelb=1)
    assert res.converged
    assert res.orbE_b is not None
