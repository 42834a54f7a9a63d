"""Linear-algebra helpers (L7 support).

Symmetry-blocked generalized eigensolves, batched for the device:
because S = I_ang (x) S_rad, the half-inverse is per-radial-block and all
(l,m) symmetry blocks have identical radial dimension, so the per-block
whitened eigensolves batch into ONE vmapped eigh over the angular axis
(replacing the per-block LAPACK loop of scf::eig_gsym_sub,
src/general/scf_helpers.cpp:142-186).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["form_sinvh", "eigh_refined", "eigh_warm", "eig_gsym_lm",
           "eig_gsym_m"]


def _refine_passes(A, E, V, npass: int, tau: float):
    """The shared first-order refinement sweep of eigh_refined/eigh_warm:
    given an approximate eigensystem (E, V) of symmetric A, run `npass`
    perturbative correction + Newton re-orthonormalization passes (all
    matmuls, no QR). Returns (E, V, off) where off is the
    largest |off-diagonal| of V^T A V from the LAST pass (a residual
    certificate for the warm path's fallback decision)."""
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)

    def body(carry, _):
        E, V, _off = carry
        M = jnp.swapaxes(V, -1, -2) @ A @ V
        E = jnp.diagonal(M, axis1=-2, axis2=-1)
        off = jnp.max(jnp.abs(M - E[..., None] * eye))
        dE = E[..., None, :] - E[..., :, None]
        scale = jnp.maximum(jnp.abs(E[..., None, :]), jnp.abs(E[..., :, None])) + 1.0
        mask = jnp.abs(dE) > tau * scale
        C = jnp.where(mask, M / jnp.where(mask, dE, 1.0), 0.0)
        C = jnp.clip(C, -0.1, 0.1)
        V = V + V @ C
        V = V @ (1.5 * eye - 0.5 * (jnp.swapaxes(V, -1, -2) @ V))
        return (E, V, off), None

    (E, V, off), _ = jax.lax.scan(body, (E, V, jnp.asarray(0.0, A.dtype)),
                                  None, length=npass)
    return E, V, off


def _sort_eigs(E, V):
    order = jnp.argsort(E, axis=-1)
    return (jnp.take_along_axis(E, order, axis=-1),
            jnp.take_along_axis(V, order[..., None, :], axis=-1))


def eigh_refined(A: jnp.ndarray, npass: int = 4, tau: float = 1e-9):
    """Symmetric eigendecomposition: f64 eigh followed by `npass`
    first-order perturbative refinement sweeps, all matmuls:

        M = V^T A V;  E = diag(M);  C_ij = M_ij / (E_j - E_i)  (i != j)
        V <- V (I + C);  V <- V (3I - V^T V)/2   (Newton re-orthonormalization)

    The sweeps exist for eigh kernels that stop short of a backward-stable
    f64 residual: each pass contracts the residual quadratically (4 passes
    take 1e-4 errors to ~1e-13). Near-degenerate pairs (|dE| <= tau *
    scale) are masked out of C: rotations inside a degenerate cluster are
    physically irrelevant (any orthonormal basis of the cluster is equally
    valid for densities/occupations). Batches over leading axes (works
    under vmap). Reference: the f64 generalized eigensolve of scf::eig_gsym,
    src/general/scf_helpers.cpp:131-139."""
    E, V = jnp.linalg.eigh(A)
    E, V, _ = _refine_passes(A, E, V, npass, tau)
    # restore ascending order (refinement may perturb near-degenerate order)
    return _sort_eigs(E, V)


def eigh_warm(A: jnp.ndarray, V0: jnp.ndarray, npass: int = 3,
              tau: float = 1e-9, gate: float = 1e-10):
    """Warm-started symmetric eigendecomposition: refine the PREVIOUS
    iteration's eigenvectors V0 instead of running a fresh eigh.

    Inside an SCF the Fock matrix changes by O(DIIS error) between
    iterations, so V0^T A V0 is nearly diagonal and a few matmul-only
    refinement sweeps (_refine_passes) recover the new eigensystem.
    Correctness is gated by an EXACT residual certificate: npass+1 sweeps
    run, and the largest |off-diagonal| of V^T A V measured by the final
    sweep (i.e. the true residual after npass sweeps, in the same absolute
    units as the DIIS error the SCF gates on) must beat `gate`, else the
    result is REPLACED by a full eigh_refined(A) (one lax.cond; both
    branches compiled, the expensive one executed only when the
    certificate fails -- e.g. the first iteration after a unit-matrix V0,
    or a large DIIS extrapolation jump). Callers should set gate well
    below their convergence threshold (the SCF drivers use
    min(0.1 * convthr, 1e-9)).

    Returns (E, V, used_warm) with E/V sorted ascending; batches over
    leading axes like eigh_refined. V0 must be orthonormal (any orthonormal
    matrix is safe -- at worst the certificate fails and the cold path
    runs)."""
    E0 = jnp.diagonal(jnp.swapaxes(V0, -1, -2) @ A @ V0, axis1=-2, axis2=-1)
    E, V, off = _refine_passes(A, E0, V0, npass + 1, tau)
    good = off < gate

    def warm(_):
        return _sort_eigs(E, V)

    def cold(_):
        return eigh_refined(A, tau=tau)

    Es, Vs = jax.lax.cond(good, warm, cold, None)
    return Es, Vs, good


def form_sinvh(S: np.ndarray) -> np.ndarray:
    """Symmetric inverse square root via eigendecomposition
    (reference: utils::invh, libhelfem/src/utils.cpp)."""
    w, U = np.linalg.eigh(S)
    return U @ np.diag(w**-0.5) @ U.T


@jax.jit
def eig_gsym_lm(F: jnp.ndarray, Sinvh_rad: jnp.ndarray):
    """Generalized symmetric eigensolve restricted to (l,m) symmetry blocks
    (symm=2): batched whitened eigh over the angular axis.

    Returns (E [nang, nrad], C [nang, nrad, nrad]) where C[a] maps radial
    coefficients of block a; full-basis orbital vectors are delta_a * C[a].
    """
    nrad = Sinvh_rad.shape[0]
    nang = F.shape[0] // nrad
    Fb = F.reshape(nang, nrad, nang, nrad)[jnp.arange(nang), :, jnp.arange(nang), :]
    Forth = jnp.einsum("pi,apq,qj->aij", Sinvh_rad, Fb, Sinvh_rad)
    E, V = eigh_refined(Forth)
    C = jnp.einsum("pi,aij->apj", Sinvh_rad, V)
    return E, C


_BIG = 1e6


def form_sinvh_chol(S: np.ndarray) -> np.ndarray:
    """Inverse Cholesky factor L^-T with Sinvh^T S Sinvh = I (reference:
    the --diag 0 path, TwoDBasis::Sinvh(chol=true),
    src/atomic/main.cpp:88,446)."""
    L = np.linalg.cholesky(S)
    return np.linalg.inv(L).T


def build_blocks(S: np.ndarray, blocks, chol: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of index arrays into (blk_idx [nblk, blen] with trash=nbf,
    blk_sinvh [nblk, blen, blen]) for the batched blocked eigensolve.
    chol=True whitens with the inverse Cholesky factor instead of the
    symmetric inverse square root (reference --diag 0)."""
    nbf = S.shape[0]
    blen = max(len(b) for b in blocks)
    nblk = len(blocks)
    blk_idx = np.full((nblk, blen), nbf, dtype=np.int32)
    blk_sinvh = np.zeros((nblk, blen, blen))
    inv = form_sinvh_chol if chol else form_sinvh
    for i, idx in enumerate(blocks):
        blk_idx[i, : len(idx)] = idx
        blk_sinvh[i, : len(idx), : len(idx)] = inv(S[np.ix_(idx, idx)])
    return blk_idx, blk_sinvh


@jax.jit
def gather_blocks(F: jnp.ndarray, blk_idx: jnp.ndarray) -> jnp.ndarray:
    """Symmetry-block coordinates [nblk, blen, blen] of a global matrix
    (padded slots read the zero pad row/col)."""
    Fp = jnp.pad(F, ((0, 1), (0, 1)))
    return Fp[blk_idx[:, :, None], blk_idx[:, None, :]]


@functools.partial(jax.jit, static_argnames=("nbf",))
def eig_blocks_b(Fb: jnp.ndarray, blk_idx: jnp.ndarray, blk_sinvh: jnp.ndarray,
                 nbf: int):
    """Batched whitened eigensolve from BLOCK-coordinate Fock matrices
    [nblk, blen, blen] (the fused chunks keep their DIIS Fock history in
    block coordinates); padded slots (blk_idx == nbf) get eigenvalue _BIG
    (never occupied). Returns (E [nblk, blen], C [nblk, blen, blen]) in
    block coordinates."""
    Forth = jnp.einsum("bpi,bpq,bqj->bij", blk_sinvh, Fb, blk_sinvh)
    pad = (blk_idx == nbf).astype(Fb.dtype)
    Forth = Forth + _BIG * jnp.eye(blk_idx.shape[1])[None] * pad[:, None, :]
    E, V = eigh_refined(Forth)
    C = jnp.einsum("bpi,bij->bpj", blk_sinvh, V)
    return E, C


@functools.partial(jax.jit, static_argnames=("nbf",))
def eig_blocks_b_warm(Fb: jnp.ndarray, blk_idx: jnp.ndarray,
                      blk_sinvh: jnp.ndarray, nbf: int, V0: jnp.ndarray,
                      gate):
    """eig_blocks_b with a warm-started eigensolve: V0 [nblk, blen, blen]
    are the previous iteration's WHITENED block eigenvectors (identity on
    the first call -- the certificate then fails and the full eigh runs).
    Returns (E, C, V, used_warm); feed V back in on the next iteration.
    `gate` is the absolute residual tolerance (see eigh_warm); the SCF
    drivers pass min(0.1 * convthr, 1e-9)."""
    Forth = jnp.einsum("bpi,bpq,bqj->bij", blk_sinvh, Fb, blk_sinvh)
    pad = (blk_idx == nbf).astype(Fb.dtype)
    Forth = Forth + _BIG * jnp.eye(blk_idx.shape[1])[None] * pad[:, None, :]
    E, V, good = eigh_warm(Forth, V0, gate=gate)
    C = jnp.einsum("bpi,bij->bpj", blk_sinvh, V)
    return E, C, V, good


@jax.jit
def eig_blocks(F: jnp.ndarray, blk_idx: jnp.ndarray, blk_sinvh: jnp.ndarray):
    """Batched whitened eigensolve over padded symmetry blocks; padded slots
    get eigenvalue _BIG (never occupied). Returns (E [nblk, blen],
    C [nblk, blen, blen]) in block coordinates."""
    nbf = F.shape[0]
    Fb = gather_blocks(F, blk_idx)
    Forth = jnp.einsum("bpi,bpq,bqj->bij", blk_sinvh, Fb, blk_sinvh)
    pad = (blk_idx == nbf).astype(F.dtype)
    Forth = Forth + _BIG * jnp.eye(blk_idx.shape[1])[None] * pad[:, None, :]
    E, V = eigh_refined(Forth)
    C = jnp.einsum("bpi,bij->bpj", blk_sinvh, V)
    return E, C


@jax.jit
def density_blocks(C: jnp.ndarray, occ: jnp.ndarray, blk_idx: jnp.ndarray, S: jnp.ndarray):
    """Scatter block orbitals x occupations into the global density matrix."""
    nbf = S.shape[0]
    Pb = jnp.einsum("bpk,bk,bqk->bpq", C, occ, C)
    P = jnp.zeros((nbf + 1, nbf + 1))
    P = P.at[blk_idx[:, :, None], blk_idx[:, None, :]].add(Pb)
    return P[:nbf, :nbf]


def perturbation_matrix(n: int, magnitude: float, seed: int = 0) -> np.ndarray:
    """Random orthogonal perturbation rotation (reference:
    scf::perturbation_matrix): expm of a random antisymmetric matrix with
    the given magnitude."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = magnitude * (A - A.T) / 2.0
    w, V = np.linalg.eig(A)  # antisymmetric: imaginary spectrum
    R = (V @ np.diag(np.exp(w)) @ np.linalg.inv(V)).real
    # clean up to strict orthogonality
    U, _, Vt = np.linalg.svd(R)
    return U @ Vt


def form_sh(S: np.ndarray) -> np.ndarray:
    """Symmetric square root S^{1/2}. Eigenvalues are clamped at zero so
    masked (singular) overlaps -- e.g. the diatomic shell-masked S -- do
    not produce NaNs from roundoff-negative eigenvalues."""
    w, U = np.linalg.eigh(S)
    return U @ np.diag(np.sqrt(np.clip(w, 0.0, None))) @ U.T


def rohf_update(Fa, Fb, P, Sh, Sinvh, nocca, noccb):
    """Constrained-UHF (ROHF) Fock update of Tsuchimochi & Scuseria,
    JCP 134, 064101 (2011) (reference: scf::ROHF_update,
    src/general/scf_helpers.cpp): flip the sign of the core-virtual blocks
    of (Fa-Fb)/2 in the natural-orbital basis. Returns updated (Fa, Fb)."""
    # natural orbitals in increasing-occupation order
    M = Sh.T @ P @ Sh
    occs, V = np.linalg.eigh(M)  # ascending
    C = Sinvh @ V  # AO_to_NO, S-orthonormal columns
    no_to_ao = V.T @ Sh
    Delta_NO = C.T @ ((Fa - Fb) / 2.0) @ C
    n = C.shape[1]
    Nc = min(nocca, noccb)
    Na = max(nocca, noccb) - Nc
    Nv = n - Na - Nc
    lam = np.zeros_like(Delta_NO)
    # cores are the LAST Nc columns (highest occupation), virtuals the first Nv
    lam[n - Nc :, :Nv] = -Delta_NO[n - Nc :, :Nv]
    lam[:Nv, n - Nc :] = -Delta_NO[:Nv, n - Nc :]
    lam_AO = no_to_ao.T @ lam @ no_to_ao
    return Fa + lam_AO, Fb - lam_AO


def eig_gsym_m(F: jnp.ndarray, Sinvh_rad: jnp.ndarray, mgroups, nrad: int):
    """Generalized eigensolve on m-symmetry blocks (symm=1).

    mgroups: list of arrays of angular-shell indices sharing the same m.
    Groups of equal size are batched together. Returns a list of
    (shells, E [nsub*nrad], C [nsub*nrad, nsub*nrad]) per group.
    """
    out = []
    for shells in mgroups:
        ns = len(shells)
        idx = np.concatenate([a * nrad + np.arange(nrad) for a in shells])
        Fb = F[np.ix_(idx, idx)]
        Sinvh = jnp.kron(jnp.eye(ns), Sinvh_rad)
        Forth = Sinvh.T @ Fb @ Sinvh
        E, V = eigh_refined(Forth)
        out.append((idx, E, Sinvh @ V))
    return out


def eig_gsym_sub(F: jnp.ndarray, C0: jnp.ndarray):
    """Rayleigh-Ritz solution of F in the subspace spanned by the
    S-orthonormal columns of C0 (reference: scf::eig_sub_wrk /
    eig_gsym_sub, src/general/scf_helpers.h:37-44 -- the occupied + active
    virtual subspace diagonalization). One projected eigh; jittable.

    Returns (E [nsub], C [n, nsub]) with C = C0 @ V, still S-orthonormal."""
    Fsub = C0.T @ F @ C0
    E, V = eigh_refined(Fsub)
    return E, C0 @ V


def eig_iter_gsym(F: jnp.ndarray, Sinvh: jnp.ndarray, neig: int,
                  maxit: int = 100, tol: float = 1e-9, seed: int = 0):
    """Iterative generalized eigensolver for the LOWEST neig eigenpairs
    (reference: scf::eig_iter's ARPACK/newarp Lanczos,
    src/general/scf_helpers.cpp:397-421). Device design: LOBPCG -- a
    blocked, matmul-only Krylov method (ARPACK's single-vector Lanczos is
    sequential and host-bound). The spectrum is
    flipped (LOBPCG computes the top end) by negating the whitened
    operator.

    Returns (E [neig] ascending, C [n, neig]) in the non-orthonormal basis."""
    from jax.experimental.sparse.linalg import lobpcg_standard

    Forth = Sinvh.T @ F @ Sinvh
    n = Forth.shape[0]
    X0 = jnp.asarray(np.random.default_rng(seed).standard_normal((n, neig)))
    X0, _ = jnp.linalg.qr(X0)
    theta, U, it = lobpcg_standard(lambda X: -(Forth @ X), X0, m=maxit, tol=tol)
    E = -theta
    order = jnp.argsort(E)
    return E[order], Sinvh @ U[:, order]


def eig_blocks_iter(F, blk_idx: np.ndarray, blk_sinvh: np.ndarray,
                    neig: int, sigma: float, _BIG: float = 1e6):
    """Blocked generalized eigensolve computing only the LOWEST neig
    eigenpairs per symmetry block via shift-invert Lanczos (ARPACK, the
    same engine as the reference's scf::eig_iter newarp solver,
    src/general/scf_helpers.cpp:397-421) -- the --eigiter driver option.

    FEM Fock matrices have spectral radii ~1e5-1e7 while the occupied
    eigenvalues sit within a few hundred Eh of zero, so regular-mode
    iteration (both plain Lanczos and LOBPCG) sees relative gaps of ~1e-7
    and stalls; the shift-invert transform (Forth - sigma)^-1 makes the
    lowest states extremal. `sigma` must lie strictly BELOW the spectrum;
    the SCF driver passes the physical bound -0.6 Z^2 - 10 (orbital
    energies are bounded by the hydrogenic -Z^2/2). Blocks too small for
    the subspace (n < 3 neig) and ARPACK failures fall back to dense eigh.
    Uncomputed slots carry _BIG so aufbau never fills them.

    Returns (E [nblk, blen], C [nblk, blen, blen]) matching eig_blocks'
    block-coordinate convention."""
    from scipy.sparse.linalg import eigsh

    F = np.asarray(F)
    nbf = F.shape[0]
    Fp = np.pad(F, ((0, 1), (0, 1)))
    nblk, blen = blk_idx.shape
    E = np.full((nblk, blen), _BIG)
    C = np.zeros((nblk, blen, blen))
    for b in range(nblk):
        valid = blk_idx[b] < nbf
        nv = int(valid.sum())
        idx = blk_idx[b][valid]
        Fb = Fp[np.ix_(idx, idx)]
        Sb = blk_sinvh[b][:nv, :nv]
        Forth = Sb.T @ Fb @ Sb
        k = min(neig, nv)
        if 3 * k >= nv:
            w, V = np.linalg.eigh(Forth)
            E[b, :nv] = w
            C[b, :nv, :nv] = Sb @ V
            continue
        try:
            w, V = eigsh(Forth, k=k, sigma=sigma, which="LM")
        except Exception:
            w, V = np.linalg.eigh(Forth)
            w, V = w[:k], V[:, :k]
        order = np.argsort(w)
        E[b, :k] = w[order]
        C[b, :nv, :k] = Sb @ V[:, order]
    return E, C
