"""Diatomic (prolate-spheroidal two-center) tests (SURVEY.md stage-8 gates)."""

import os

import numpy as np
import pytest

from helfem_tpu.models.diatomic import DiatomicBasis
from helfem_tpu.scf.diatomic_scf import eig_blocks_dia, scf_diatomic


def test_h2plus_ground_state():
    """H2+ at R=2: exact electronic 1s-sigma-g energy -1.1026342144949
    (reference model: src/diatomic/1e.cpp)."""
    b = DiatomicBasis(Z1=1, Z2=1, Rbond=2.0, lmax=(12,), rmax=40.0, nelem=6, nnodes=12)
    ops = b.build_operators()
    E, C = eig_blocks_dia(ops, ops.H0)
    E = np.sort(np.asarray(E).ravel())
    assert abs(E[0] + 1.1026342144949) < 1e-9
    # 2p sigma_u
    assert abs(E[1] + 0.66753439) < 1e-7


def test_h2_hf():
    """H2 HF at R=1.4; HF limit -1.133629571548."""
    b = DiatomicBasis(Z1=1, Z2=1, Rbond=1.4, lmax=(8,), rmax=40.0, nelem=6, nnodes=10)
    res = scf_diatomic(b, 1, 1, convthr=1e-8, maxit=30)
    assert res.converged
    assert abs(res.E + 1.13362957) < 1e-6


def test_he_as_diatomic():
    """Z2=0 reduces to an off-center atom: must agree with the atomic code."""
    b = DiatomicBasis(Z1=2, Z2=0, Rbond=2.0, lmax=(10,), rmax=35.0, nelem=6, nnodes=10)
    res = scf_diatomic(b, 1, 1, method="HF", convthr=1e-8, maxit=30)
    assert res.converged
    assert abs(res.E + 2.8616799956) < 5e-8
    res2 = scf_diatomic(b, 1, 1, method="SVWN", convthr=1e-8, maxit=30)
    assert res2.converged
    assert abs(res2.E + 2.834836) < 2e-6


def test_grid_overlap_dia():
    from helfem_tpu.models.diatomic_dft import build_dia_grid, eval_overlap_dia

    b = DiatomicBasis(Z1=1, Z2=1, Rbond=2.0, lmax=(4, 4), rmax=20.0, nelem=4, nnodes=8)
    ops = b.build_operators()
    g = build_dia_grid(b)
    S = np.asarray(eval_overlap_dia(g, b.nang, b.nrad))
    m = np.asarray(ops.shellmask).reshape(-1)
    S = S * m[:, None] * m[None, :]
    Sref = np.asarray(ops.S)
    d = np.diag(Sref).copy()
    d[d == 0] = 1
    assert (np.abs(S - Sref) / np.sqrt(np.outer(d, d))).max() < 1e-12


def test_n2_hf_regression():
    """N2 HF smoke/regression at a small discretization. The HF limit
    -108.9938255 (Kobus/x2dhf) is quoted AT R = 2.068 a0; this repo
    reproduces it to 6.1e-5 at (lmax=14, nelem=5, nnodes=8) and the
    residual is radial (the lmax=12->14 angular step is 8 uEh). Runs at
    R = 2.068 here cost ~7.1e-4 Eh more when mistakenly compared against
    runs at the experimental R = 2.0743 (measured geometry shift).
    This small config regression-pins the pipeline."""
    b = DiatomicBasis(Z1=7, Z2=7, Rbond=2.068, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8)
    r = scf_diatomic(b, 7, 7, convthr=1e-7, maxit=40, guess="SAP")
    assert r.converged
    assert abs(r.E + 108.5312159188) < 1e-6


def test_n2_hf_lmax12_pinned():
    """N2 HF at lmax=12 per |m| (the reference-converged angular basis):
    pinned to this repo's own converged CPU f64 value at nelem=5, nnodes=8,
    Rmax=25 (measured 2026-08-17: E = -108.9931061475, 9 iterations;
    ~33 min CPU with the dense exchange, ~5 min since the occupied-orbital
    factorized K). Gated behind HELFEM_SLOW=1 because of the cost; the GPU
    smoke run (chip_smoke.py n2_hf_lmax12) covers the same config class."""
    import os

    if not os.environ.get("HELFEM_SLOW"):
        pytest.skip("set HELFEM_SLOW=1 to run the lmax=12 pin (~5 min)")
    b = DiatomicBasis(Z1=7, Z2=7, Rbond=2.0743, lmax=(12, 12, 12), rmax=25.0,
                      nelem=5, nnodes=8)
    r = scf_diatomic(b, 7, 7, convthr=1e-7, maxit=40, guess="SAP")
    assert r.converged
    assert abs(r.E + 108.9931061475) < 2e-6


def test_n2_pbe_smoke():
    """N2 PBE end-to-end (BASELINE config 5, DFT side)."""
    b = DiatomicBasis(Z1=7, Z2=7, Rbond=2.068, lmax=(5, 5), rmax=25.0, nelem=5, nnodes=8)
    r = scf_diatomic(b, 7, 7, method="PBE", convthr=1e-6, maxit=40, guess="SAP")
    assert r.converged
    assert -110.0 < r.E < -107.0  # lmax=5 truncation is ~1.8 Eh


def test_tau_matches_kinetic_dia():
    """Integral of the grid tau equals Tr(P T) (machine precision)."""
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic_dft import _fields_dia, build_dia_grid

    b = DiatomicBasis(Z1=1, Z2=1, Rbond=2.0, lmax=(3, 3), rmax=15.0, nelem=4, nnodes=8)
    ops = b.build_operators()
    g = build_dia_grid(b)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((b.nbf, b.nbf)) * 0.1
    m = np.asarray(ops.shellmask).reshape(-1)
    P = (X @ X.T) * np.outer(m, m)
    nang, nrad = b.nang, b.nrad
    P4p = jnp.pad(
        jnp.asarray(P).reshape(nang, nrad, nang, nrad).transpose(0, 2, 1, 3),
        ((0, 0), (0, 0), (0, 1), (0, 1)),
    )
    rho, u, v, tau, _ = _fields_dia(g, P4p, True)
    Tgrid = float(jnp.sum(g.w * tau))
    Tref = float(np.vdot(P, np.asarray(ops.T)))
    assert abs(Tgrid - Tref) < 1e-10 * abs(Tref)


def test_he_tpss_cross_code():
    """He computed as diatomic (Z2=0) with TPSS matches the atomic TPSS."""
    b = DiatomicBasis(Z1=2, Z2=0, Rbond=2.0, lmax=(8,), rmax=30.0, nelem=6, nnodes=10)
    r = scf_diatomic(b, 1, 1, method="TPSS", convthr=1e-7, maxit=40, guess="SAP")
    assert r.converged
    assert abs(r.E + 2.9096644) < 2e-6


def test_core_basis_scan_h2plus():
    """corebasis equivalent: per-m lmax scan on the one-electron problem.
    The converged sigma eigenvalue must hit the exact H2+ value at R=2."""
    from helfem_tpu.models.diatomic_tools import (
        core_basis_scan,
        core_channel_energies,
        num_orbs,
    )

    assert num_orbs(1, 1) == [2]
    assert num_orbs(7, 7) == [6, 2]  # N2: 1s,2s,2p0 x2 sigma; 2p+-1 x2 pi
    res = core_basis_scan(1, 1, 2.0, thresh=6, nnodes=12, rmax=20.0)
    thrs = [t for t, _ in res]
    lms = [lm[0] for _, lm in res]
    assert thrs[0] == 1e-1 and thrs[-1] == 1e-6
    assert all(b >= a for a, b in zip(lms, lms[1:]))  # monotone growth
    # converged ground sigma at the final lmax: exact H2+ 1s sigma_g
    b = DiatomicBasis(Z1=1, Z2=1, Rbond=2.0, lmax=(max(lms[-1], 10),),
                      rmax=20.0, nelem=3, nnodes=14)
    E = core_channel_energies(b, {0: 1})
    assert abs(E[0] + 1.1026342144949) < 1e-8


def test_dia_scf_control_knobs():
    """Diatomic SCF control parity (--restricted/--perturb/--diisorder/
    --readocc): all paths converge to the same H2 HF energy."""
    import numpy as np

    b = DiatomicBasis(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=6)
    ops = b.build_operators()
    e_ref = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops).E
    r_u = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops, restricted=0, maxit=60)
    assert r_u.converged and abs(r_u.E - e_ref) < 1e-7
    r_p = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops, perturb=0.05, seed=1,
                       diisorder=6, maxit=60)
    assert r_p.converged and abs(r_p.E - e_ref) < 1e-8
    # enforced occupations: put both electrons in the gerade sigma block
    nblk = np.asarray(ops.blk_idx).shape[0]
    occs = np.zeros((nblk, 2))
    occs[0, 0] = occs[0, 1] = 1.0
    r_o = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops, occs=occs,
                       readocc_until=-1, maxit=60)
    assert r_o.converged and abs(r_o.E - e_ref) < 1e-8
    # sliding DIIS/ADIIS scale (--diisthr, reference diis.cpp:241)
    r_t = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops, diisthr=1e-3,
                       diiseps=1e-2, maxit=60)
    assert r_t.converged and abs(r_t.E - e_ref) < 1e-8
    # finite readocc boundary: enforced occs released on the exact iteration
    r_b = scf_diatomic(b, 1, 1, convthr=1e-8, ops=ops, occs=occs,
                       readocc_until=5, maxit=60)
    assert r_b.converged and abs(r_b.E - e_ref) < 1e-8


def test_beh_rohf():
    """Diatomic ROHF via the CUHF Fock update (reference: scf::ROHF_update
    wired in the diatomic SCF loop, src/diatomic/main.cpp:902-904): BeH
    radical (2-Sigma+, 3+2 electrons, integer sigma aufbau) with
    restricted=1. ROHF is variationally above UHF but must be close."""
    b = DiatomicBasis(Z1=4, Z2=1, Rbond=2.537, lmax=(4, 4), rmax=25.0,
                      nelem=4, nnodes=8)
    ops = b.build_operators()
    r_u = scf_diatomic(b, 3, 2, convthr=1e-7, ops=ops, restricted=0, maxit=60)
    assert r_u.converged
    r_ro = scf_diatomic(b, 3, 2, convthr=1e-7, ops=ops, restricted=1, maxit=80)
    assert r_ro.converged
    # variational ordering and proximity
    assert r_ro.E >= r_u.E - 1e-8
    assert r_ro.E - r_u.E < 5e-3
    assert r_ro.orbE_b is not None


def test_orbital_moments_and_nuclear_density():
    """Per-orbital radial moments about a focus and the on-nucleus density
    (reference: radial_moments + nuclear_density post-SCF analysis,
    src/diatomic/main.cpp:1000-1086): hydrogen-as-diatomic reproduces the
    exact 1s values <r^-1>=1, <r>=3/2, <r^2>=3, <r^3>=15/2, n(0)=1/pi."""
    import numpy as np
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic_tools import (
        nuclear_densities_dia,
        occupied_orbital_vectors_dia,
        orbital_moments_dia,
    )
    from helfem_tpu.scf.diatomic_scf import density_dia

    b = DiatomicBasis(Z1=1, Z2=0, Rbond=2.0, lmax=(8,), rmax=30.0, nelem=5, nnodes=10)
    r = scf_diatomic(b, 1, 0, convthr=1e-8, maxit=30)
    assert r.converged and abs(r.E + 0.5) < 2e-7
    E0, occ0, c = occupied_orbital_vectors_dia(b, r.orbs_a, r.occ_a, r.orbE_blocks_a)[0]
    assert abs(E0 + 0.5) < 2e-7
    m = orbital_moments_dia(b, c)
    for n, exact in [(-1, 1.0), (1, 1.5), (2, 3.0), (3, 7.5)]:
        assert abs(m["left"][n] - exact) < 1e-3, (n, m["left"][n])
    ops = b.build_operators()
    P = np.asarray(density_dia(ops, jnp.asarray(r.orbs_a), jnp.asarray(r.occ_a)))
    nl, _ = nuclear_densities_dia(b, P)
    assert abs(nl - 1.0 / np.pi) < 1e-6


def test_exchange_occ_factorized():
    """exchange_dia_occ(Co) == exchange_dia(Co Co^T): the occupied-orbital
    rank factorization of the exchange build is EXACT (it is the same
    operator, reference src/diatomic/basis.cpp:1532-1734, restructured
    through P = Co Co^T). Also: signed factorizations reproduce indefinite
    symmetric P, and zero-padded orbital columns are exact no-ops."""
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic import exchange_dia, exchange_dia_occ

    b = DiatomicBasis(Z1=2, Z2=1, Rbond=1.5, lmax=(3, 3), rmax=15.0,
                      nelem=3, nnodes=6)
    ops = b.build_operators()
    rng = np.random.default_rng(0)
    no = 5
    m2 = np.asarray(ops.shellmask).reshape(-1)
    Co = jnp.asarray(rng.standard_normal((b.nbf, no)) * 0.3) * m2[:, None]
    K_dense = exchange_dia(ops, Co @ Co.T)
    K_occ = exchange_dia_occ(ops, Co)
    scale = float(jnp.abs(K_dense).max())
    assert float(jnp.abs(K_dense - K_occ).max()) < 1e-12 * scale
    # indefinite P through a signed factorization
    sgn = jnp.asarray(np.where(rng.standard_normal(no) > 0, 1.0, -1.0))
    K_dense2 = exchange_dia(ops, Co @ jnp.diag(sgn) @ Co.T)
    K_occ2 = exchange_dia_occ(ops, Co, sgn)
    assert float(jnp.abs(K_dense2 - K_occ2).max()) < 1e-12 * scale
    # padded zero columns change nothing
    K_occ3 = exchange_dia_occ(ops, jnp.pad(Co, ((0, 0), (0, 3))))
    assert float(jnp.abs(K_occ - K_occ3).max()) < 1e-13 * scale


def test_exchange_dia_symmetry_high_L():
    """K(P) must be symmetric (to rounding) for symmetric random P at high
    angular momentum, where the Neumann P_L/Q_L factor tables span many
    orders of magnitude. Canary for element/channel scale-pairing bugs in
    the batched exchange contraction (the analogous atomic canary caught a
    1e-5 accuracy loss in the Yukawa cross-element triangles)."""
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic import coulomb_dia, exchange_dia

    b = DiatomicBasis(Z1=7, Z2=7, Rbond=2.0743, lmax=(8, 8), rmax=30.0,
                      nelem=4, nnodes=7)
    ops = b.build_operators()
    rng = np.random.default_rng(3)
    X = rng.standard_normal((b.nbf, b.nbf)) * 0.1
    m2 = np.asarray(ops.shellmask).reshape(-1)
    P = jnp.asarray((X @ X.T) * np.outer(m2, m2))
    K = np.asarray(exchange_dia(ops, P))
    scale = np.abs(K).max()
    assert np.abs(K - K.T).max() < 1e-11 * max(scale, 1.0)
    J = np.asarray(coulomb_dia(ops, P))
    assert np.abs(J - J.T).max() < 1e-11 * max(np.abs(J).max(), 1.0)


def test_eig_blocks_host_matches_device():
    """eig_blocks_dia_host (the host LAPACK reference) reproduces the
    device eigensolve eig_blocks_dia."""
    from helfem_tpu.scf.diatomic_scf import eig_blocks_dia_host

    b = DiatomicBasis(Z1=2, Z2=1, Rbond=1.5, lmax=(3, 3), rmax=15.0,
                      nelem=3, nnodes=6)
    ops = b.build_operators()
    F = np.asarray(ops.H0)
    E_d, C_d = eig_blocks_dia(ops, F)
    E_h, C_h = eig_blocks_dia_host(ops, F)
    E_d, C_d = np.asarray(E_d), np.asarray(C_d)
    assert np.abs(E_d - E_h).max() < 1e-9
    # eigenvectors up to sign/degenerate rotations: compare projectors of
    # the lowest few eigenvectors per block
    for blk in range(E_d.shape[0]):
        k = 3
        Pd = C_d[blk][:, :k] @ C_d[blk][:, :k].T
        Ph = C_h[blk][:, :k] @ C_h[blk][:, :k].T
        assert np.abs(Pd - Ph).max() < 1e-8


def test_lih_hf_heteronuclear_highl():
    """LiH HF at R=3.015, lmax=8 sigma-only: the heteronuclear (no g/u
    parity) path at high L. A Sigma ground state's occupied orbitals live
    entirely in the m=0 channel, so mmax=0 is exact for the HF energy.
    Value pinned from this framework's own converged ladder (lmax
    4/6/8/10/12: -7.8943310/-7.9845928/-7.9873060/-7.9873516/-7.9873519
    at nelem=4, nnodes=10)."""
    b = DiatomicBasis(Z1=3, Z2=1, Rbond=3.015, lmax=(8,), rmax=30.0,
                      nelem=4, nnodes=10)
    r = scf_diatomic(b, 2, 2, method="HF", convthr=1e-9, maxit=60)
    assert r.converged
    assert abs(r.E - (-7.9873060141)) < 1e-7


def test_lih_hf_limit_converged():
    """LiH HF at the reference-converged discretization vs the Kobus/x2dhf
    HF limit -7.987352 at R=3.015. Radial convergence cross-checked two
    ways (nelem=5/nnodes=10 and nelem=4/nnodes=12 agree to 2e-10); the
    lmax 12->14 angular move is 1e-8. Gated behind HELFEM_SLOW (~1 min)."""
    if not os.environ.get("HELFEM_SLOW"):
        pytest.skip("set HELFEM_SLOW=1 to run the converged LiH pin (~1 min)")
    b = DiatomicBasis(Z1=3, Z2=1, Rbond=3.015, lmax=(12,), rmax=30.0,
                      nelem=5, nnodes=10)
    r = scf_diatomic(b, 2, 2, method="HF", convthr=1e-9, maxit=60)
    assert r.converged
    # own pinned value (regression)
    assert abs(r.E - (-7.9873521984)) < 1e-8
    # literature HF limit (Kobus 2013 x2dhf tables)
    assert abs(r.E - (-7.987352)) < 5e-7


def test_co_hf_heteronuclear_multi_m():
    """CO HF at R=2.132 vs the Kobus/x2dhf HF limit -112.790907: the
    heteronuclear multi-m regime (occupied sigma AND pi shells, no g/u
    blocks) at the reference-converged class of discretization. Own ladder
    (nelem=4, nnodes=10): lmax 8/10/12 = -112.748249/-112.789396/
    -112.790863 — geometric angular decay leaves a 4.4e-5 lmax=12 tail
    (the pinned tolerance); radial is converged (nelem 4->5 at lmax=10
    moves 5.6e-6). Gated behind HELFEM_SLOW (~5 min)."""
    if not os.environ.get("HELFEM_SLOW"):
        pytest.skip("set HELFEM_SLOW=1 to run the converged CO pin (~5 min)")
    b = DiatomicBasis(Z1=6, Z2=8, Rbond=2.132, lmax=(12, 12), rmax=25.0,
                      nelem=4, nnodes=10)
    r = scf_diatomic(b, 7, 7, method="HF", convthr=1e-8, maxit=80)
    assert r.converged
    # own pinned value (regression)
    assert abs(r.E - (-112.790862994)) < 1e-6
    # literature HF limit within the documented lmax=12 angular tail
    assert abs(r.E - (-112.790907)) < 1e-4
