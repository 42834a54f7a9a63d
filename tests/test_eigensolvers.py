"""Iterative/subspace eigensolver tests (reference parity:
scf::eig_sub_wrk / eig_gsym_sub / eig_iter, src/general/scf_helpers.h:37-48).
"""

import numpy as np
import jax.numpy as jnp

from helfem_tpu.utils.linalg import eig_gsym_sub, eig_iter_gsym, form_sinvh


def _gsym_problem(n=120, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    F = (A + A.T) / 2 + np.diag(np.linspace(0.0, 50.0, n))
    B = rng.standard_normal((n, n))
    S = B @ B.T / n + np.eye(n)
    return F, S


def test_eig_iter_gsym_lowest():
    """LOBPCG (the device replacement for eig_iter's ARPACK Lanczos)
    finds the lowest eigenpairs of a generalized problem."""
    import scipy.linalg as sla

    F, S = _gsym_problem()
    Sinvh = form_sinvh(S)
    Eref = sla.eigh(F, S, eigvals_only=True)
    E, C = eig_iter_gsym(jnp.asarray(F), jnp.asarray(Sinvh), neig=6, maxit=300, tol=1e-10)
    assert np.abs(np.asarray(E) - Eref[:6]).max() < 1e-8
    # eigenvectors solve the generalized problem: ||F C - S C E|| small
    R = F @ np.asarray(C) - S @ np.asarray(C) @ np.diag(np.asarray(E))
    assert np.abs(R).max() < 1e-6


def test_eig_gsym_sub_rayleigh_ritz():
    """Rayleigh-Ritz in an S-orthonormal subspace reproduces the exact
    eigenpairs when the subspace is spanned by them (eig_sub_wrk)."""
    import scipy.linalg as sla

    F, S = _gsym_problem(seed=2)
    Eref, Cref = sla.eigh(F, S)
    E, C = eig_gsym_sub(jnp.asarray(F), jnp.asarray(Cref[:, :10]))
    assert np.abs(np.asarray(E) - Eref[:10]).max() < 1e-9
    # and in a perturbed subspace it gives an upper bound (variational)
    rng = np.random.default_rng(3)
    C0 = Cref[:, :10] + 0.01 * rng.standard_normal((F.shape[0], 10))
    # re-S-orthonormalize
    M = C0.T @ S @ C0
    C0 = C0 @ np.linalg.inv(np.linalg.cholesky(M).T)
    E2, _ = eig_gsym_sub(jnp.asarray(F), jnp.asarray(C0))
    assert np.all(np.asarray(E2) - Eref[:10] > -1e-10)


def test_scf_diag_and_eigiter_paths():
    """--diag 0 (Cholesky whitening) and --eigiter (LOBPCG blocked solve)
    converge to the same Be HF energy as the default dense path."""
    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.scf.atomic_scf import scf_atom

    b = AtomicBasis(Z=4, lmax=0, mmax=0, rmax=25.0, nelem=5, nnodes=8)
    ops = b.build_operators()
    e_ref = scf_atom(b, 2, 2, convthr=1e-8, ops=ops).E
    r_chol = scf_atom(b, 2, 2, convthr=1e-8, ops=ops, diag=False)
    assert r_chol.converged and abs(r_chol.E - e_ref) < 1e-9
    r_it = scf_atom(b, 2, 2, convthr=1e-8, ops=ops, eigiter=4, maxit=60)
    assert r_it.converged and abs(r_it.E - e_ref) < 1e-8
