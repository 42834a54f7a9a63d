"""Spherically-averaged atom (sadatom/gensap) tests (SURVEY.md stage-7 gates)."""

import numpy as np
import pytest

from helfem_tpu.models.sadatom import (
    SadAtomBasis,
    coulomb_screening,
    sap_potential_table,
    solve_sadatom,
    totcoup_table,
)

NIST_LSD = {"Ne": -128.233481, "Ar": -525.946195}


def test_totcoup_l0():
    """s-s coupling is pure L=0 with weight 1/(4 pi) * 4 pi = known value."""
    t = totcoup_table(2)
    # <Y00 Y00|Y00 Y00>: G(0,0,0,0,0,0)^2 = 1/(4 pi)
    assert abs(t[0, 0, 0] - 1.0 / (4 * np.pi)) < 1e-14
    # closure: sum_L Lfac * totcoup(L, l, l') * (2l'+1)... spot-check symmetry
    # sum_{mo,mi} G^2 is symmetric in (lout, lin), so t * (2*lout+1) must be
    for L in range(t.shape[0]):
        w = t[L] * (2 * np.arange(3) + 1)[:, None]
        assert np.allclose(w, w.T, atol=1e-13)


def test_closed_shell_hf_matches_atomic():
    """Spherically averaged = true HF for closed shells: Be."""
    b = SadAtomBasis(Z=4, lmax=1)
    res = solve_sadatom(b, method="HF", convthr=1e-8, search=False)
    assert res.converged
    assert abs(res.E + 14.57302317) < 1e-7
    assert list(res.occs) == [4, 0]


@pytest.mark.parametrize("el,Z", [("Ne", 10), ("Ar", 18)])
def test_lsd_closed_shell(el, Z):
    b = SadAtomBasis(Z=Z, lmax=1)
    res = solve_sadatom(b, method="SVWN", convthr=1e-8, search=False)
    assert res.converged
    assert abs(res.E - NIST_LSD[el]) < 1e-6


def test_potassium_configuration():
    """Occupation search must put the 19th electron in 4s, not 3d."""
    b = SadAtomBasis(Z=19, lmax=2, rmax=50.0, nelem=8, nnodes=12)
    res = solve_sadatom(b, method="SVWN", convthr=1e-7)
    assert list(res.occs) == [7, 12, 0]


def test_coulomb_screening_asymptote():
    b = SadAtomBasis(Z=2, lmax=0, nelem=8, nnodes=10)
    res = solve_sadatom(b, method="HF", search=False)
    vc = coulomb_screening(b, res.Pl.sum(axis=0))
    r = b.rb.r.ravel()
    assert abs(vc[np.argmax(r)] - 2.0) < 1e-9


def test_sap_table_neon():
    """SAP Z_eff: Z at the nucleus, 0 asymptotically, monotone-ish decay."""
    r, zeff, res = sap_potential_table(10, lmax=1, nelem=8, nnodes=10)
    assert res.converged
    assert zeff[0] > 9.0
    assert abs(zeff[-1]) < 0.5


def test_unrestricted_li_exact():
    """s-only atoms are exactly spherical: sad-UHF Li == true UHF limit."""
    from helfem_tpu.models.sadatom import solve_sadatom_unrestricted

    b = SadAtomBasis(Z=3, lmax=1)
    r = solve_sadatom_unrestricted(b, 2, 1, method="HF", convthr=1e-8)
    assert r.converged
    assert abs(r.E + 7.432751) < 1e-6
    assert list(r.occs) == [2, 0] and list(r.occs_b) == [1, 0]


def test_unrestricted_nitrogen_config():
    from helfem_tpu.models.sadatom import solve_sadatom_unrestricted

    b = SadAtomBasis(Z=7, lmax=1, nelem=8, nnodes=12)
    r = solve_sadatom_unrestricted(b, 5, 2, method="SVWN", convthr=1e-7)
    assert r.converged
    assert list(r.occs) == [2, 3] and list(r.occs_b) == [2, 0]


def test_result_density_energy_consistent():
    """The reported converged E must be reproducible from the RETURNED
    density/orbitals (the fused path once handed back a density one
    diagonalization ahead of the printed energy, corrupting SAP/radii
    exports on non-converged runs)."""
    import jax.numpy as jnp

    from helfem_tpu.models.sadatom import (
        SadAtomBasis,
        density_cubes,
        make_sad_fock,
        solve_sadatom,
    )
    from helfem_tpu.ops.xc import parse_method

    b = SadAtomBasis(Z=10, lmax=1, rmax=30.0, nelem=6, nnodes=10)
    r = solve_sadatom(b, method="SVWN", convthr=1e-9, search=False)
    assert r.converged
    ops = b.build_ops()
    funcs, kfrac = parse_method("SVWN")[:2]
    fock = make_sad_fock(tuple(funcs), kfrac, b.lmax + 1, b.nrad)
    Pla, Panga = density_cubes(np.asarray(r.orbs), r.occs, True)
    _, _, Ekin, Enuc, Ecoul, Exx, Exc, _ = fock(
        ops, jnp.asarray(Pla / 2.0), jnp.asarray(Pla / 2.0),
        jnp.asarray(Panga), jnp.asarray(Panga)
    )
    Erec = float(Ekin + Enuc + Ecoul + Exx + Exc)
    assert abs(Erec - r.E) < 1e-7, (Erec, r.E)
    # and the returned Pl matches the returned orbitals
    assert np.abs(np.asarray(r.Pl) - Pla).max() < 1e-12


def test_sad_tpss_matches_atomic():
    """He spherically-averaged TPSS == atomic TPSS (-2.9096644)."""
    b = SadAtomBasis(Z=2, lmax=0, nelem=10, nnodes=15)
    r = solve_sadatom(b, method="TPSS", convthr=1e-7, search=False)
    assert r.converged
    assert abs(r.E + 2.9096644496) < 1e-8


def test_potential_variants_closed_shell_agree():
    """For a closed shell (Ne, M=1) rho_a == rho_b, so all five potential
    variants coincide; tau column integrates to the kinetic energy."""
    import numpy as np

    from helfem_tpu.models.sadatom import potential_table, solve_sadatom_unrestricted
    from helfem_tpu.ops.xc import parse_method

    b = SadAtomBasis(Z=10, lmax=1, nelem=8, nnodes=10)
    r = solve_sadatom_unrestricted(b, 5, 5, method="SVWN", convthr=1e-7)
    assert r.converged
    funcs, _ = parse_method("SVWN")
    tabs = {
        m: potential_table(b, r.Pl, r.Plb, funcs, mode=m)
        for m in ("average", "mean", "weighted", "highspin", "lowspin")
    }
    ref = tabs["average"][:, 6]
    for m in ("mean", "weighted", "highspin", "lowspin"):
        assert np.abs(tabs[m][:, 6] - ref).max() < 1e-10, m
    t = tabs["average"]
    # integral checks: density -> Nel, tau -> Ekin, 0.5 rho vcoul -> Ecoul
    assert abs(np.sum(t[:, 7] * t[:, 1]) - 10.0) < 1e-8
    assert abs(np.sum(t[:, 7] * t[:, 4]) - r.Ekin) < 1e-7
    # vcoul column comes from segment quadrature -> ~1e-6 agreement
    assert abs(np.sum(0.5 * t[:, 7] * t[:, 1] * t[:, 5] / t[:, 0]) - r.Ecoul) < 1e-5


def test_potential_variants_open_shell_order():
    """Open shell (N): high-spin sees the alpha density doubled so its
    screening differs from low-spin; weighted lies between them at large
    rho_a - rho_b contrast."""
    import numpy as np

    from helfem_tpu.models.sadatom import potential_table, solve_sadatom_unrestricted
    from helfem_tpu.ops.xc import parse_method

    b = SadAtomBasis(Z=7, lmax=1, nelem=8, nnodes=12)
    r = solve_sadatom_unrestricted(b, 5, 2, method="SVWN", convthr=1e-7)
    assert r.converged
    funcs, _ = parse_method("SVWN")
    hi = potential_table(b, r.Pl, r.Plb, funcs, mode="highspin")
    lo = potential_table(b, r.Pl, r.Plb, funcs, mode="lowspin")
    wt = potential_table(b, r.Pl, r.Plb, funcs, mode="weighted")
    assert np.abs(hi[:, 6] - lo[:, 6]).max() > 1e-3
    # all give the same density/coulomb columns
    assert np.abs(hi[:, 1] - lo[:, 1]).max() < 1e-12
    assert np.abs(hi[:, 5] - wt[:, 5]).max() < 1e-12


# ----------------------------------------------------------------------------
# configuration machinery (reference: src/sadatom/configurations.cpp,
# main.cpp:280-560 search)
# ----------------------------------------------------------------------------


def test_saito_table():
    from helfem_tpu.models.sadconf import get_configuration

    for Z in range(1, 119):
        conf = get_configuration(Z)
        assert conf.sum() == Z
        assert (conf >= 0).all()
    # anomalous ground states (Saito 2009)
    assert list(get_configuration(24)) == [7, 12, 5, 0]  # Cr 3d5 4s1
    assert list(get_configuration(29)) == [7, 12, 10, 0]  # Cu 3d10 4s1
    assert list(get_configuration(46)) == [8, 18, 20, 0]  # Pd 4d10 (no 5s)
    assert list(get_configuration(41)) == [9, 18, 14, 0]  # Nb 4d4 5s1
    assert list(get_configuration(57)) == [12, 24, 21, 0]  # La 5d1 (no 4f)
    assert list(get_configuration(64)) == [12, 24, 21, 7]  # Gd 4f7 5d1


def test_hund_rule_and_moves():
    from helfem_tpu.models.sadconf import hund_rule, move_electrons

    a, b = hund_rule(np.array([7, 12, 5, 0]))
    assert list(a) == [4, 6, 5, 0] and list(b) == [3, 6, 0, 0]
    # nitrogen p3: maximum multiplicity
    a, b = hund_rule(np.array([4, 3]))
    assert list(a) == [2, 3] and list(b) == [2, 0]
    moves = move_electrons(np.array([2, 0]), True)
    keys = {tuple(m) for m in moves}
    assert (1, 1) in keys and (0, 2) in keys


def test_restricted_search_cr_explores_d5():
    """The exhaustive search must solve (and rank) the 3d5 4s1 configuration;
    with level shifting every explored configuration converges."""
    from helfem_tpu.models.sadatom import SadAtomBasis, solve_sadatom

    basis = SadAtomBasis(Z=24, lmax=2, rmax=40.0, nelem=6, nnodes=10)
    res = solve_sadatom(basis, method="lda_x", search=True)
    keys = [k for k, _, _ in res.conf_list]
    assert (7, 12, 5) in keys
    assert all(conv for _, _, conv in res.conf_list[:5])
    # top configurations within 5 mEh: 4s2 3d4 vs 4s1 3d5 near-degenerate in
    # restricted exchange-only LDA
    assert res.conf_list[0][0] in [(8, 12, 4), (7, 12, 5)]


def test_unrestricted_search_cr_ground_state():
    """Spin polarization picks out the physical Cr 3d5 4s1 (M=7) state."""
    from helfem_tpu.models.sadatom import SadAtomBasis, search_sadatom_unrestricted

    basis = SadAtomBasis(Z=24, lmax=2, rmax=40.0, nelem=6, nnodes=10)
    ru = search_sadatom_unrestricted(basis, method="lda_x", mode="aufbau")
    assert ru.converged
    total = np.array(ru.occs) + np.array(ru.occs_b)
    assert list(total) == [7, 12, 5]  # 3d5 4s1
    assert int(sum(ru.occs) - sum(ru.occs_b) + 1) == 7  # septet


def test_fixed_occs_solve():
    """occs= runs exactly one fixed-occupation SCF (no search)."""
    from helfem_tpu.models.sadatom import SadAtomBasis, solve_sadatom

    basis = SadAtomBasis(Z=24, lmax=2, rmax=40.0, nelem=6, nnodes=10)
    res = solve_sadatom(basis, method="lda_x", occs=np.array([7, 12, 5]))
    assert res.converged
    assert list(res.occs) == [7, 12, 5]
    assert len(res.conf_list) == 1


def test_gga_xc_potential_is_functional_derivative():
    """The exported GGA potential must be the true functional derivative:
    dE_xc under a density perturbation = int v_xc dn 4 pi r^2 dr (validates
    the divergence correction; reference: src/sadatom/basis.cpp:1289-1463).

    The perturbation is localized to interior elements: at the nucleus the
    pointwise GGA potential has the well-known cusp divergence (the
    reference 'skips the nucleus' in its correction loop for the same
    reason) and integration by parts picks up boundary terms there."""
    import jax.numpy as jnp

    from helfem_tpu.models.sadatom import radial_density, xc_screening_polarized
    from helfem_tpu.ops.xc import parse_method, xc_eval

    b = SadAtomBasis(Z=10, lmax=1, nelem=8, nnodes=10)
    res = solve_sadatom(b, 10, method="PBE", convthr=1e-7)
    assert res.converged
    funcs, _ = parse_method("PBE")
    P = res.Pl.sum(axis=0)
    nrad = P.shape[0]

    def exc_of(Prad):
        r, n, dn, _, w = radial_density(b, Prad)
        h, dh = jnp.asarray(n / 2), jnp.asarray(dn / 2)
        s = dh * dh
        e, *_ = xc_eval(funcs, h, h, s, s, s)
        return float(np.sum(np.asarray(e) * w))

    # symmetric dP over basis functions of interior elements only
    gidx = b.rb.fem.gidx
    sel = sorted(set(int(i) for i in gidx[2:5].ravel() if i < nrad))
    rng = np.random.default_rng(3)
    v = np.zeros(nrad)
    v[sel] = rng.normal(size=len(sel))
    dP = 1e-4 * (np.outer(v, v) / nrad + 0.01 * np.diag(np.abs(v)))
    dE_fd = (exc_of(P + dP) - exc_of(P - dP)) / 2.0

    r, _, _, _, w = radial_density(b, P)
    _, dn_pert, _, _, _ = radial_density(b, dP)
    rva, _ = xc_screening_polarized(b, P / 2, P / 2, funcs)
    vxc = rva / r
    assert np.all(np.isfinite(vxc))
    dE_lin = float(np.sum(vxc * dn_pert * w))
    assert abs(dE_fd - dE_lin) < 1e-4 * abs(dE_fd)


def test_gga_potential_matches_lda_when_gradient_free():
    """With an LDA functional the GGA machinery must reduce exactly to the
    LDA potential (vsigma = 0 path through the jvp)."""
    from helfem_tpu.models.sadatom import radial_density, xc_screening
    from helfem_tpu.ops.xc import parse_method, xc_eval
    import jax.numpy as jnp

    b = SadAtomBasis(Z=10, lmax=1, nelem=6, nnodes=8)
    res = solve_sadatom(b, 10, method="LDA", convthr=1e-7)
    funcs, _ = parse_method("LDA")
    P = res.Pl.sum(axis=0)
    r, n, *_ = radial_density(b, P)
    half = jnp.asarray(n / 2)
    z = jnp.zeros_like(half)
    _, vra, *_ = xc_eval(funcs, half, half, z, z, z)
    rv = xc_screening(b, P, funcs)
    assert np.abs(rv - r * np.asarray(vra)).max() < 1e-12


def test_sadatom_confinement_matches_atomic():
    """Confined He (polynomial (r/R)^2 well): the spherically-averaged
    solver must agree with the atomic program for a closed shell
    (gensap --iconf parity, reference: src/sadatom/main.cpp:138-143)."""
    import numpy as np

    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.scf.atomic_scf import scf_atom

    b = SadAtomBasis(Z=2, lmax=0, nelem=8, nnodes=10, rmax=20.0,
                     iconf=1, conf_N=2, conf_R=4.0)
    r = solve_sadatom(b, method="HF", convthr=1e-8, search=False)
    assert r.converged

    ba = AtomicBasis(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=8, nnodes=10)
    ra = scf_atom(ba, 1, 1, method="HF", convthr=1e-8, iconf=1, conf_N=2, conf_R=4.0)
    assert ra.converged
    assert abs(r.E - ra.E) < 1e-8
    # confinement raises the energy above the free atom
    rfree = scf_atom(ba, 1, 1, method="HF", convthr=1e-8)
    assert r.E > rfree.E + 1e-3


def test_sadatom_finite_nucleus_matches_atomic():
    """Gaussian finite nucleus in the spherically-averaged solver matches
    the atomic program (gensap --finitenuc parity)."""
    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.scf.atomic_scf import scf_atom

    Rrms = 1e-2  # exaggerated radius so the shift is well above noise
    b = SadAtomBasis(Z=2, lmax=0, nelem=8, nnodes=10, rmax=20.0,
                     finitenuc="gaussian", Rrms=Rrms, nelem0=2)
    r = solve_sadatom(b, method="HF", convthr=1e-8, search=False)
    assert r.converged

    ba = AtomicBasis(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=8, nnodes=10,
                     finitenuc="gaussian", Rrms=Rrms, nelem0=2)
    ra = scf_atom(ba, 1, 1, method="HF", convthr=1e-8, finitenuc="gaussian", Rrms=Rrms)
    assert ra.converged
    assert abs(r.E - ra.E) < 1e-7
    # finite nucleus softens the cusp -> energy above the point nucleus
    bp = AtomicBasis(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=8, nnodes=10)
    rp = scf_atom(bp, 1, 1, method="HF", convthr=1e-8)
    assert r.E > rp.E + 1e-5


def test_xc_ingredients_integrals():
    """The xcing table (gensap --saveing) must integrate to the electron
    count and the kinetic energy."""
    import numpy as np

    from helfem_tpu.models.sadatom import radial_density, xc_ingredients

    b = SadAtomBasis(Z=10, lmax=1, nelem=8, nnodes=10)
    r = solve_sadatom(b, method="SVWN", convthr=1e-7, search=False)
    ing = xc_ingredients(b, r.Pl)
    _, _, _, _, wt = radial_density(b, r.Pl.sum(axis=0))
    nel = np.sum((ing[:, 1] + ing[:, 2]) * wt)
    assert abs(nel - 10.0) < 1e-8
    ekin = np.sum((ing[:, 8] + ing[:, 9]) * wt)
    assert abs(ekin - r.Ekin) < 1e-7


def test_occupied_orbital_table_hydrogenic():
    """The per-orbital analysis table (reference OrbitalChannel::Print /
    Rmatrices) on the exact hydrogen 1s orbital: <r^i>^(1/i) and the
    radius of max r^2-density are known in closed form."""
    import jax.numpy as jnp

    from helfem_tpu.models.sadatom import (
        SadAtomBasis,
        eig_channels,
        occupied_orbital_table,
    )
    from helfem_tpu.scf.guess import potential

    b = SadAtomBasis(Z=1, lmax=0, rmax=40.0, nelem=8, nnodes=10)
    ops = b.build_ops()
    Vg = jnp.asarray(b.rb.model_potential(potential("core", 1)(b.rb.r)))
    Eg, Cg = eig_channels((ops.at.T + Vg)[None], ops.at.Sinvh_rad)
    rows = occupied_orbital_table(b, np.array([1]), np.asarray(Eg), np.asarray(Cg))
    assert len(rows) == 1
    row = rows[0]
    assert row["n"] == 1 and row["l"] == 0 and row["nocc"] == 1
    assert abs(row["E"] + 0.5) < 1e-10
    # hydrogen 1s: <r^-2> = 2, <r^-1> = 1, <r> = 3/2, <r^2> = 3, <r^3> = 15/2
    exact = {-2: 2.0 ** (-0.5), -1: 1.0, 1: 1.5, 2: 3.0 ** 0.5,
             3: 7.5 ** (1.0 / 3.0)}
    for i, v in exact.items():
        assert abs(row["moments"][i] - v) < 1e-8, (i, row["moments"][i])
    # max of r^2 e^{-2r} is at r = 1 exactly
    assert abs(row["rmax"] - 1.0) < 1e-5
