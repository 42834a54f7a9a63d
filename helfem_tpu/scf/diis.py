"""DIIS convergence acceleration (L7).

C2-DIIS (Sorensen-Osterby) with an SVD-based solve, as in the reference
(src/general/diis.cpp), for restricted and unrestricted SCF. The error vector
is the orthonormal-basis commutator Sinvh^T (F P S - S P F) Sinvh
(reference: diis.cpp error metric). Far from convergence (error above
`diis_eps`) the extrapolation weights come from the ADIIS energy model
(Hu & Yang, J. Chem. Phys. 132, 054109 (2010); reference: the ADIIS branch
of diis.cpp) when density history is available, with a damped Roothaan step
as the fallback.

Host-side numpy: the stacks are tiny (history <= ~10 matrices).
"""

import numpy as np

__all__ = ["DIIS", "device_diis_step"]


def device_diis_step(histF, histE, count, F, errv):
    """Fully on-device C2-DIIS update (used inside the fused SCF chunks):
    push (F, errv) into a circular history and return the extrapolated Fock.

    F may carry any leading shape (e.g. [2, nbf, nbf] spin-stacked for
    unrestricted SCF, matching the reference's combined-error uDIIS,
    src/general/diis.cpp); histF is [H, *F.shape], histE is [H, nerr].
    Invalid (not-yet-filled) history slots are masked by scaling the
    error-overlap matrix diagonal, and the candidate eigenvector with the
    smallest extrapolated error and bounded weights is selected -- the same
    C2-DIIS selection as DIIS.solve()."""
    import jax.numpy as jnp

    from helfem_tpu.utils.linalg import eigh_refined

    H = histF.shape[0]
    slot = count % H
    histF = histF.at[slot].set(F)
    histE = histE.at[slot].set(errv)
    count = count + 1
    valid = jnp.arange(H) < count
    B = histE @ histE.T
    # invalid-slot padding scaled relative to B; solve with the refined
    # eigh (a raw eigh's error is relative to ||B||)
    bscale = jnp.max(jnp.where(valid, jnp.diagonal(B), 0.0)) + 1e-300
    B = jnp.where(valid[:, None] & valid[None, :], B, 1e4 * bscale * jnp.eye(H))
    w, V = eigh_refined(B)
    s = jnp.sum(jnp.where(valid[:, None], V, 0.0), axis=0)
    safe = jnp.abs(s) > 1e-10
    c = V / jnp.where(safe, s, 1.0)[None, :]
    cerr = jnp.einsum("ik,ij,jk->k", c, B, c)
    bad = (~safe) | (jnp.max(jnp.abs(c), axis=0) > 20.0)
    cerr = jnp.where(bad, jnp.inf, cerr)
    k = jnp.argmin(cerr)
    wts = jnp.where(valid, c[:, k], 0.0)
    Fuse = jnp.tensordot(wts, histF, axes=1)
    return Fuse, histF, histE, count


class DIIS:
    def __init__(self, S, Sinvh, max_hist: int = 10, diis_eps: float = 0.1, damp: float = 0.5,
                 adiis: bool = True, diis_thr: float | None = None,
                 blocks=None):
        """diis_thr (reference --diisthr, src/general/diis.cpp:241): when
        set, errors in (diis_thr, diis_eps] use the reference's sliding
        DIIS/ADIIS weight blend diisw = 1 - (err-thr)/(eps-thr) instead of
        the hard switch at diis_eps; below diis_thr it is pure C2-DIIS.

        blocks=(blk_idx, blk_sinvh) (numpy, padded with nbf / zeros as in
        the blocked eigensolves): compute the error commutator PER SYMMETRY
        BLOCK. Exact whenever every F and P is block-diagonal over those
        blocks (true by construction for symmetry-blocked SCF drivers);
        sum_b blen^3 FLOPs instead of three dense nbf^3 matmuls -- the
        dense commutator is a dominant host-loop cost at nbf ~ 4000."""
        self.S = np.asarray(S)
        self.Sinvh = np.asarray(Sinvh)
        self.blocks = None
        if blocks is not None:
            bi = np.asarray(blocks[0])
            bs = np.asarray(blocks[1])
            Sp = np.pad(self.S, ((0, 1), (0, 1)))
            Sb = Sp[bi[:, :, None], bi[:, None, :]]
            self.blocks = (bi, bs, Sb)
        self.max_hist = max_hist
        self.diis_eps = diis_eps
        self.diis_thr = diis_thr
        self.damp = damp
        self.adiis = adiis
        self.Fs: list[list[np.ndarray]] = []
        self.Ps: list[list[np.ndarray]] = []
        self.errs: list[np.ndarray] = []

    def _error(self, F, P):
        if self.blocks is not None:
            bi, bs, Sb = self.blocks
            Fp = np.pad(np.asarray(F), ((0, 1), (0, 1)))
            Pp = np.pad(np.asarray(P), ((0, 1), (0, 1)))
            Fb = Fp[bi[:, :, None], bi[:, None, :]]
            Pb = Pp[bi[:, :, None], bi[:, None, :]]
            FPS = np.einsum("bpq,bqr,brs->bps", Fb, Pb, Sb, optimize=True)
            M = FPS - FPS.transpose(0, 2, 1)
            return np.einsum("bpi,bps,bsj->bij", bs, M, bs, optimize=True)
        FPS = F @ P @ self.S
        comm = FPS - FPS.T
        return self.Sinvh.T @ comm @ self.Sinvh

    def update(self, Fs, Ps):
        """Push Fock/density matrices (list per spin channel). Returns the
        DIIS error (max norm over channels)."""
        errv = np.concatenate([self._error(F, P).ravel() for F, P in zip(Fs, Ps)])
        return self.update_with_error(Fs, errv, Ps=Ps)

    def update_with_error(self, Fs, errv, Ps=None):
        """Push Fock matrices with a precomputed error vector (for drivers
        that evaluate the commutator on device)."""
        errv = np.asarray(errv).ravel()
        self.Fs.append([np.asarray(F).copy() for F in Fs])
        self.Ps.append(None if Ps is None else [np.asarray(P).copy() for P in Ps])
        self.errs.append(errv)
        if len(self.Fs) > self.max_hist:
            self.Fs.pop(0)
            self.Ps.pop(0)
            self.errs.pop(0)
        return float(np.max(np.abs(errv)))

    def _adiis_weights(self):
        """Simplex-constrained minimizer of the ADIIS energy model
        f(c) = 2 sum_i c_i <P_i - P_n, F_n> + sum_ij c_i c_j <P_i - P_n, F_j - F_n>
        via the c_i = x_i^2 / sum x^2 parameterization (BFGS on x)."""
        from scipy.optimize import minimize

        n = len(self.Fs)
        nch = len(self.Fs[0])
        Pn, Fn = self.Ps[-1], self.Fs[-1]
        dP = [[self.Ps[i][ch] - Pn[ch] for ch in range(nch)] for i in range(n)]
        dF = [[self.Fs[j][ch] - Fn[ch] for ch in range(nch)] for j in range(n)]
        d = np.array([sum(np.vdot(dP[i][ch], Fn[ch]).real for ch in range(nch)) for i in range(n)])
        H = np.array([
            [sum(np.vdot(dP[i][ch], dF[j][ch]).real for ch in range(nch)) for j in range(n)]
            for i in range(n)
        ])
        Hs = H + H.T

        def fg(x):
            x2 = x * x
            s = x2.sum()
            c = x2 / s
            gc = 2.0 * d + Hs @ c
            gx = (2.0 * x / s) * (gc - c @ gc)
            return 2.0 * c @ d + 0.5 * c @ Hs @ c, gx

        best_c, best_f = None, np.inf
        for x0 in (np.ones(n), np.r_[np.full(n - 1, 0.1), 1.0]):
            r = minimize(fg, x0, jac=True, method="BFGS",
                         options={"maxiter": 200, "gtol": 1e-10})
            c = r.x**2 / (r.x**2).sum()
            f = 2.0 * c @ d + 0.5 * c @ Hs @ c
            if f < best_f:
                best_f, best_c = f, c
        return best_c

    def solve(self):
        """Extrapolated Fock matrices (C2-DIIS: eigenvector of the error-overlap
        matrix with smallest error norm and acceptable weights)."""
        n = len(self.Fs)
        if n == 1:
            return self.Fs[-1]
        err = float(np.max(np.abs(self.errs[-1])))
        have_adiis = self.adiis and all(P is not None for P in self.Ps)
        if err > self.diis_eps:
            # not in the DIIS basin yet: ADIIS energy-model weights when the
            # density history is available, damped Roothaan otherwise
            if have_adiis:
                c = self._adiis_weights()
                return [
                    sum(c[i] * self.Fs[i][ch] for i in range(n))
                    for ch in range(len(self.Fs[0]))
                ]
            if n >= 2:
                return [
                    (1 - self.damp) * Fn + self.damp * Fo
                    for Fn, Fo in zip(self.Fs[-1], self.Fs[-2])
                ]
            return self.Fs[-1]
        B = np.empty((n, n))
        for i in range(n):
            for j in range(n):
                B[i, j] = np.dot(self.errs[i], self.errs[j])
        # C2-DIIS: solve B c = lambda c with sum(c)=1 normalization per
        # eigenvector, pick the solution with smallest extrapolated error
        w, V = np.linalg.eigh(B)
        best, best_err = None, np.inf
        for k in range(n):
            c = V[:, k]
            s = c.sum()
            if abs(s) < 1e-10:
                continue
            c = c / s
            if np.max(np.abs(c)) > 20.0:
                continue
            e = c @ B @ c
            if e < best_err:
                best_err, best = e, c
        if best is None:
            best = np.zeros(n)
            best[-1] = 1.0
        if (self.diis_thr is not None and err > self.diis_thr
                and self.diis_eps > self.diis_thr and have_adiis):
            # sliding DIIS/ADIIS scale between diisthr and diiseps
            # (reference: src/general/diis.cpp:241-243)
            diisw = max(min(1.0 - (err - self.diis_thr) / (self.diis_eps - self.diis_thr), 1.0), 0.0)
            best = diisw * best + (1.0 - diisw) * self._adiis_weights()
        return [
            sum(best[i] * self.Fs[i][ch] for i in range(n))
            for ch in range(len(self.Fs[0]))
        ]
