"""Atomic two-dimensional basis chi_{nlm} = b_n(r) Y_lm(theta, phi) (L5).

Device-batched redesign of atomic::basis::TwoDBasis (src/atomic/TwoDBasis.cpp):

* The full basis index is angular-major: bf = a * nrad + n for angular shell a
  (with quantum numbers l_a, m_a) and radial function n.
* One-electron operators are Kronecker-structured: S = I_ang (x) S_rad, etc.
* The Coulomb and exchange builds (the SCF hot path, TwoDBasis.cpp:817-1150)
  are pure jittable einsum pipelines over dense (L, M, element) axes:
    - angular contraction against a precomputed exact Gaunt tensor
      G[L, M, a, b],
    - per-element gathers of the density, batched in-element TEI contraction,
    - cross-element factorized terms via PREFIX SUMS over the element axis
      (cumsum) instead of the reference's O(Nel^2) loops,
    - exchange runs as a lax.scan over L with all (jang, kang) channel pairs
      batched (replacing the OpenMP collapse(2) loop).
* All tensors are static-shape; dropped boundary functions live in a trash
  slot nrad and are sliced off after scatter-adds.
"""

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from helfem_tpu.ops.fem import FEMBasis
from helfem_tpu.ops.gaunt import gaunt_table
from helfem_tpu.ops.grids import form_grid, get_grid
from helfem_tpu.ops.polynomials import get_basis
from helfem_tpu.ops.radial import RadialBasis

__all__ = ["angular_basis", "AtomicBasis", "AtomicOperators", "coulomb", "exchange"]


def angular_basis(lmax: int, mmax: int):
    """Angular shell enumeration (reference: src/atomic/basis.cpp:174-198):
    ordered by |m| then l, with +m before -m."""
    lval, mval = [], []
    for mabs in range(mmax + 1):
        for l in range(mabs, lmax + 1):
            lval.append(l)
            mval.append(mabs)
            if mabs > 0:
                lval.append(l)
                mval.append(-mabs)
    return np.array(lval), np.array(mval)


class AtomicOperators(NamedTuple):
    """Device-side constants for the jitted SCF hot path."""

    gidx: jnp.ndarray  # [nelem, nprim] int32, trash slot = nrad
    G: jnp.ndarray  # [NL, NM, nang, nang] Gaunt tensor
    Lfac: jnp.ndarray  # [NL] = 4 pi / (2L+1)
    tei: jnp.ndarray  # [NL, nelem, nprim, nprim, nprim, nprim]
    disjL: jnp.ndarray  # [NL, nelem, nprim, nprim]
    disjm1L: jnp.ndarray  # [NL, nelem, nprim, nprim]
    S: jnp.ndarray  # [nbf, nbf]
    H0: jnp.ndarray  # [nbf, nbf]
    T: jnp.ndarray  # [nbf, nbf]
    Vnuc: jnp.ndarray  # [nbf, nbf]
    Sinvh_rad: jnp.ndarray  # [nrad, nrad]
    # note: nang/nrad are derived from array shapes inside the jitted paths
    # (G.shape[-1], Sinvh_rad.shape[0]) so the pytree carries no static ints.


def confinement_Vr(r: np.ndarray, rmax: float, N, R: float, iconf: int = 1,
                   shift: float = 0.0) -> np.ndarray:
    """Confinement potentials on radial points (reference:
    RadialBasis.cpp:361-455): 1 polynomial ((r-shift)/R)^N, 2 exponential
    N! (e^x - sum_{k<N} x^k/k!) with x=(r-shift)/R, 3 barrier V0*theta(r-R)
    (N reused as the height), 4 Junquera
    V0 e^{-(rmax-shift)/(r-shift)} / (rmax-r)^N (N, V0=R slot)."""
    if iconf == 1:
        Vr = np.where(r > shift, ((r - shift) / R) ** int(N), 0.0)
    elif iconf == 2:
        x = np.where(r > shift, (r - shift) / R, 0.0)
        s = np.zeros_like(x)
        fact = 1.0
        xk = np.ones_like(x)
        for k in range(int(N)):
            s += xk / fact
            fact *= k + 1
            xk = xk * x
        Vr = np.where(r > shift, fact * (np.exp(x) - s), 0.0)
    elif iconf == 3:
        Vr = np.where(r > R, float(N), 0.0)
    elif iconf == 4:
        rc = rmax
        with np.errstate(over="ignore", divide="ignore"):
            Vr = np.where(
                r > shift,
                R * np.exp(-(rc - shift) / np.maximum(r - shift, 1e-300))
                / np.maximum(rc - r, 1e-300) ** int(N),
                0.0,
            )
        # the wall diverges at r = rc; cap it so quadrature points at or
        # beyond rc (the finite-nucleus grid extends past rmax, matching
        # the reference's finite_nuclear_grid) give a huge finite barrier
        # instead of inf poisoning the Hamiltonian
        Vr = np.minimum(Vr, 1e8)
    else:
        raise NotImplementedError(f"confinement type {iconf}")
    return Vr


def nuclear_model_V(model: str, Z: float, Rrms: float):
    """V(r) callable for a finite-nucleus charge model (reference: libhelfem
    {Gaussian,Spherical,Hollow,Regularized}Nucleus.cpp). model in
    {'gaussian', 'spherical', 'hollow', 'regularized'}; Rrms is the rms
    charge radius (the Gygi width parameter for 'regularized')."""
    import math

    if model == "point":
        return lambda r: -Z / r
    if model == "gaussian":
        mu = math.sqrt(1.5) / Rrms
        erf = np.vectorize(math.erf)
        return lambda r: -Z * erf(mu * r) / r
    if model == "spherical":
        # uniformly charged ball (Visscher-Dyall 1997 eq. 7)
        R0 = math.sqrt(5.0 / 3.0) * Rrms
        return lambda r: np.where(
            r >= R0, -Z / r, -Z * (3.0 - (r / R0) ** 2) / (2.0 * R0)
        )
    if model == "hollow":
        return lambda r: np.where(r >= Rrms, -Z / r, -Z / Rrms)
    if model == "regularized":
        from helfem_tpu.ops.gygi import gygi_V

        return lambda r: gygi_V(Z, Rrms, r)
    raise ValueError(model)


@dataclass
class AtomicBasis:
    """Host-side setup: builds all constant tensors for an atomic calculation."""

    Z: int
    lmax: int
    mmax: int
    rmax: float = 40.0
    nelem: int = 10
    nnodes: int = 15
    nquad: int = 0
    igrid: int = 4
    zexp: float = 2.0
    primbas: int = 4
    # grid-construction variants (reference: src/atomic/basis.cpp:56-167);
    # nelem0 > 0 activates the finite-nucleus sub-grid (with finitenuc/Rrms)
    # or the off-center boundary sections (with Zl/Zr/Rmid); conf_boundary
    # inserts an element boundary at the confinement onset radius
    finitenuc: str = "point"
    Rrms: float = 0.0
    nelem0: int = 0
    igrid0: int = 2
    zexp0: float = 2.0
    Zl: int = 0
    Zr: int = 0
    Rmid: float = 0.0
    conf_boundary: float = 0.0
    # drop the derivative DOF at Rmax too (Hermite bases; reference
    # --zeroder, src/atomic/main.cpp)
    zeroder: bool = False
    # explicit element boundaries in r (overrides the grid-construction
    # parameters; used when reconstructing a basis from a reference-schema
    # HDF5 checkpoint, which stores bval directly)
    bval: np.ndarray | None = None

    lval: np.ndarray = field(init=False)
    mval: np.ndarray = field(init=False)
    rb: RadialBasis = field(init=False)

    def __post_init__(self):
        self.lval, self.mval = angular_basis(self.lmax, self.mmax)
        poly = get_basis(self.primbas, self.nnodes)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        if self.bval is not None:
            bval = np.asarray(self.bval, dtype=float)
            self.nelem = len(bval) - 1
            self.rmax = float(bval[-1])
        else:
            bval = form_grid(
                self.finitenuc, self.Rrms, self.nelem, self.rmax, self.igrid,
                self.zexp, self.nelem0, self.igrid0, self.zexp0, self.Z,
                self.Zl, self.Zr, self.Rmid, self.conf_boundary,
            )
        fem = FEMBasis(poly, bval, drop_first=True, drop_last=True,
                       drop_last_deriv=self.zeroder)
        self.rb = RadialBasis(fem, self.nquad)

    # --- sizes ---------------------------------------------------------------
    @property
    def nang(self) -> int:
        return len(self.lval)

    @property
    def nrad(self) -> int:
        return self.rb.fem.nbf

    @property
    def nbf(self) -> int:
        return self.nang * self.nrad

    @property
    def NL(self) -> int:
        return 2 * int(self.lval.max()) + 1

    # --- one-electron operators (host, setup-time) ----------------------------
    def overlap(self) -> np.ndarray:
        return np.kron(np.eye(self.nang), self.rb.overlap())

    def kinetic(self) -> np.ndarray:
        Trad = self.rb.kinetic()
        Tl = self.rb.kinetic_l()
        ll1 = self.lval * (self.lval + 1.0)
        blocks = Trad[None, :, :] + ll1[:, None, None] * Tl[None, :, :]
        return _blockdiag(blocks)

    def nuclear(self) -> np.ndarray:
        return np.kron(np.eye(self.nang), self.Z * self.rb.nuclear())

    def model_potential(self, V) -> np.ndarray:
        """Guess Hamiltonian potential from V(r) callable (spherical)."""
        Vr = V(self.rb.r)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    def _angular_matrix(self, coupling) -> np.ndarray:
        """[nang, nang] table of an angular coupling function (la,ma,lb,mb)."""
        A = np.zeros((self.nang, self.nang))
        for a in range(self.nang):
            for b in range(self.nang):
                A[a, b] = coupling(
                    int(self.lval[a]), int(self.mval[a]), int(self.lval[b]), int(self.mval[b])
                )
        return A

    def dipole_z(self) -> np.ndarray:
        """<z> = <r cos theta> (reference: TwoDBasis::dipole_z,
        src/atomic/TwoDBasis.cpp:508-545)."""
        from helfem_tpu.ops.gaunt import cosk_coupling

        A = self._angular_matrix(lambda la, ma, lb, mb: cosk_coupling(1, la, ma, lb, mb))
        return np.kron(A, self.rb.radial_integral(1))

    def quadrupole_zz(self) -> np.ndarray:
        """<(3 z^2 - r^2)/2> (reference: TwoDBasis::quadrupole_zz)."""
        from helfem_tpu.ops.gaunt import cosk_coupling

        A2 = self._angular_matrix(lambda la, ma, lb, mb: cosk_coupling(2, la, ma, lb, mb))
        I = np.eye(self.nang)
        r2 = self.rb.radial_integral(2)
        return np.kron(1.5 * A2 - 0.5 * I, r2)

    def Bz_field(self, B: float) -> np.ndarray:
        """Orbital Zeeman B/2 L_z + diamagnetic B^2/8 r^2 sin^2(theta)
        (reference: TwoDBasis::Bz_field, src/atomic/TwoDBasis.cpp:591-636).
        The spin Zeeman -+ B/2 S term is added per spin channel in the SCF."""
        from helfem_tpu.ops.gaunt import sine2_coupling

        S2 = self._angular_matrix(sine2_coupling)
        out = np.kron(np.diag(self.mval * B / 2.0), self.rb.overlap())
        out += B * B / 8.0 * np.kron(S2, self.rb.radial_integral(2))
        return out

    def confinement(self, N, R: float, iconf: int = 1, shift: float = 0.0) -> np.ndarray:
        Vr = confinement_Vr(self.rb.r, self.rmax, N, R, iconf, shift)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    def nuclear_offcenter(self, Zl: int, Zr: int, Rhalf: float) -> np.ndarray:
        """Attraction to off-center charges Zr at +Rhalf z and Zl at -Rhalf z,
        by multipole expansion (reference: TwoDBasis::nuclear off-center path,
        src/atomic/TwoDBasis.cpp:378-454; RadialBasis::nuclear_offcenter).
        Most accurate when an element boundary sits at r = Rhalf (the
        reference's form_grid inserts one, src/atomic/basis.cpp:70-117)."""
        from helfem_tpu.ops.gaunt import gaunt_coefficient

        Lmax = 2 * self.lmax
        out = np.zeros((self.nbf, self.nbf))
        r = self.rb.r
        for L in range(0, Lmax + 1):
            zfac = Zr + (-1) ** L * Zl
            if zfac == 0:
                continue
            with np.errstate(over="ignore", divide="ignore"):
                fr = np.where(r <= Rhalf, r**L / Rhalf ** (L + 1), Rhalf**L / r ** (L + 1))
            rad = -np.sqrt(4.0 * np.pi / (2 * L + 1)) * zfac * self.rb.model_potential(fr)
            A = self._angular_matrix(
                lambda la, ma, lb, mb, L=L: gaunt_coefficient(la, ma, L, 0, lb, mb)
            )
            out += np.kron(A, rad)
        return out

    def nuclear_model(self, model: str, Rrms: float) -> np.ndarray:
        """Finite-nucleus attraction matrices (reference: libhelfem
        {Gaussian,Spherical,Hollow}Nucleus.cpp). model in {'point',
        'gaussian', 'spherical', 'hollow'}; Rrms is the rms charge radius."""
        if model == "point":
            return self.nuclear() * 1.0
        Vr = nuclear_model_V(model, self.Z, Rrms)(self.rb.r)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    def sinvh_rad(self) -> np.ndarray:
        S = self.rb.overlap()
        w, U = np.linalg.eigh(S)
        if w.min() < 1e-12 * w.max():
            raise RuntimeError("overlap matrix nearly singular")
        return U @ np.diag(w**-0.5) @ U.T

    # --- symmetry index sets ----------------------------------------------------
    def sym_blocks(self, symm: int = 2):
        """List of arrays of full-basis indices per symmetry block.

        symm=1: group angular shells by m; symm=2: each (l,m) shell its own
        block (reference: TwoDBasis::get_sym_idx, src/atomic/TwoDBasis.cpp:202)."""
        if symm == 0:
            return [np.arange(self.nbf)]
        blocks = []
        if symm == 1:
            for m in np.unique(self.mval):
                shells = np.nonzero(self.mval == m)[0]
                idx = np.concatenate(
                    [a * self.nrad + np.arange(self.nrad) for a in shells]
                )
                blocks.append(idx)
        else:
            for a in range(self.nang):
                blocks.append(a * self.nrad + np.arange(self.nrad))
        return blocks

    def sym_labels(self, symm: int = 2) -> list[str]:
        """Human-readable label per sym_blocks entry (used for orbital
        symmetry printouts, cf. reference orbital tables in
        src/atomic/main.cpp)."""
        spd = "spdfghikl"
        if symm == 0:
            return ["all"]
        if symm == 1:
            return [f"m={m:+d}" for m in np.unique(self.mval)]
        return [
            f"{spd[self.lval[a]] if self.lval[a] < len(spd) else 'l' + str(self.lval[a])}"
            f"(m={self.mval[a]:+d})"
            for a in range(self.nang)
        ]

    def build_erfc(self, mu: float) -> "ErfcOperators":
        """erfc short-range TEI tables (reference: TwoDBasis::compute_erfc,
        src/atomic/TwoDBasis.cpp:781)."""
        NL = self.NL
        tei = self.rb.erfc_integral(NL - 1, mu)
        Lfac = 4.0 * np.pi * mu / (2.0 * np.arange(NL) + 1.0)
        return ErfcOperators(tei=jnp.asarray(tei), Lfac=jnp.asarray(Lfac))

    def build_yukawa(self, lam: float) -> "RSOperators":
        """Yukawa (screened-Coulomb) TEI tables for range-separated exchange
        (reference: TwoDBasis::compute_yukawa, src/atomic/TwoDBasis.cpp:747)."""
        NL = self.NL
        tei = self.rb.yukawa_integral(NL - 1, lam)
        iL, kL = self.rb.yukawa_disjoint(NL - 1, lam)
        return RSOperators(
            tei=jnp.asarray(tei),
            iL=jnp.asarray(iL),
            kL=jnp.asarray(kL),
            Lfac=jnp.asarray(np.full(NL, 4.0 * np.pi * lam)),
        )

    # --- device constants ---------------------------------------------------------
    def build_operators(self) -> AtomicOperators:
        NL = self.NL
        tei = self.rb.twoe_integral(NL - 1)
        disjL, disjm1L = self.rb.disjoint_integrals(NL - 1)
        G = gaunt_table(self.lval, self.mval, NL - 1)
        Lfac = 4.0 * np.pi / (2.0 * np.arange(NL) + 1.0)
        T = self.kinetic()
        Vnuc = self.nuclear()
        return AtomicOperators(
            gidx=jnp.asarray(self.rb.fem.gidx),
            G=jnp.asarray(G),
            Lfac=jnp.asarray(Lfac),
            tei=jnp.asarray(tei),
            disjL=jnp.asarray(disjL),
            disjm1L=jnp.asarray(disjm1L),
            S=jnp.asarray(self.overlap()),
            H0=jnp.asarray(T + Vnuc),
            T=jnp.asarray(T),
            Vnuc=jnp.asarray(Vnuc),
            Sinvh_rad=jnp.asarray(self.sinvh_rad()),
        )


def _blockdiag(blocks: np.ndarray) -> np.ndarray:
    n, r, _ = blocks.shape
    out = np.zeros((n * r, n * r))
    for i in range(n):
        out[i * r : (i + 1) * r, i * r : (i + 1) * r] = blocks[i]
    return out


# ----------------------------------------------------------------------------
# Jitted SCF hot path: Coulomb and exchange builds
# (reference: TwoDBasis::coulomb / exchange, src/atomic/TwoDBasis.cpp:817-1150)
# ----------------------------------------------------------------------------


def _to4(P: jnp.ndarray, nang: int, nrad: int) -> jnp.ndarray:
    """[nbf,nbf] -> [nang, nang, nrad, nrad]"""
    return P.reshape(nang, nrad, nang, nrad).transpose(0, 2, 1, 3)


def _from4(P4: jnp.ndarray, nang: int, nrad: int) -> jnp.ndarray:
    return P4.transpose(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)


def _pad_rad(M: jnp.ndarray) -> jnp.ndarray:
    """Pad the last two (radial) axes by the trash slot."""
    pad = [(0, 0)] * (M.ndim - 2) + [(0, 1), (0, 1)]
    return jnp.pad(M, pad)


def _assembler(gidx: jnp.ndarray, nrad: int) -> jnp.ndarray:
    """One-hot FEM assembly operator A[e, p, n] = [gidx[e, p] == n] over the
    padded global radial axis (n = nrad is the trash slot).

    Element-window gathers and scatter-add assembly become batched MATMULS
    with A instead of XLA gather/scatter ops: Rw[e,f,p,q] = Rp[gi[e,p],
    gi[f,q]] is einsum('epn,nm,fqm'), and the transpose pair sums windows
    back. The matmul form runs as dense batched GEMMs where a gather or
    scatter-add would serialize on its indices."""
    return (gidx[:, :, None] == jnp.arange(nrad + 1)[None, None, :]).astype(jnp.float64)


def coulomb(ops: AtomicOperators, P: jnp.ndarray) -> jnp.ndarray:
    """J(P), jittable. Prefix sums replace the reference's per-element-pair
    loops (TwoDBasis.cpp:888-923)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    gi = ops.gidx
    P4 = _to4(P, nang, nrad)
    A = _assembler(gi, nrad)
    # angular (ket) contraction -> radial helpers per (L, M)
    Paux = jnp.einsum("LMab,abIJ->LMIJ", ops.G, P4)
    # element-window gather via the assembly matmul
    Pp = _pad_rad(Paux)
    Pg = jnp.einsum("ein,LMnm,ejm->LMeij", A, Pp, A)  # [NL,NM,e,i,j]
    # disjoint traces
    tsmall = jnp.einsum("Leij,LMeij->LMe", ops.disjL, Pg)
    tbig = jnp.einsum("Leij,LMeij->LMe", ops.disjm1L, Pg)
    # prefix over e' < e of tsmall; suffix over e' > e of tbig
    pre = jnp.cumsum(tsmall, axis=-1) - tsmall
    suf = jnp.cumsum(tbig[..., ::-1], axis=-1)[..., ::-1] - tbig
    Jel = (
        ops.disjm1L[:, None] * pre[..., None, None]
        + ops.disjL[:, None] * suf[..., None, None]
        + jnp.einsum("Leijkl,LMekl->LMeij", ops.tei, Pg)
    )
    Jel = Jel * ops.Lfac[:, None, None, None, None]
    # assembly scatter-add via the transposed matmul pair
    Jaux = jnp.einsum("ein,LMeij,ejm->LMnm", A, Jel, A)[:, :, :nrad, :nrad]
    # angular (bra) expansion
    J4 = jnp.einsum("LMba,LMIJ->abIJ", ops.G, Jaux)
    return _from4(J4, nang, nrad)


def exchange_kernel_L_pairwise(teiL, UL, VL, gidx, nrad, R):
    """Per-element-pair form of the cross-element exchange triangles: each
    (e, f) pair product V[e]·R_window·U[f] is contracted jointly, so the
    element scales of U and V stay PAIRED inside every multiply. Needed for
    the Yukawa range-separated tables, where i_L/k_L span e^(±λ·rmax)
    (~1e28 at λ=5): the stacked global-coordinate form below pre-sums the
    U side across elements and loses ~1e-5 of the operator (measured; the
    pairwise form is exact to 1e-19 on the same inputs). Slower: it
    materializes [batch, e, f, p, q] windows -- acceptable for the RS
    correction term, not for the full-range hot path."""
    nelem, nprim = gidx.shape
    Rp = _pad_rad(R)
    A = _assembler(gidx, nrad)
    eidx = jnp.arange(nelem)
    lower = (eidx[:, None] > eidx[None, :])[:, :, None, None]
    upper = (eidx[:, None] < eidx[None, :])[:, :, None, None]
    diag = (eidx[:, None] == eidx[None, :])[:, :, None, None]
    # element-window gather as one assembly matmul pair (all e,f at once)
    Rw = jnp.einsum("epn,...nm,fqm->...efpq", A, Rp, A)  # [..., e, f, p, q]
    Rg = Rw[..., eidx, eidx, :, :]  # diagonal windows [..., e, i, l]
    Kdiag = jnp.einsum("eijkl,...eil->...ejk", teiL, Rg)
    lo = jnp.einsum("eip,...efpj->...efij", VL,
                    jnp.einsum("fjq,...efpq->...efpj", UL, Rw))
    hi = jnp.einsum("eip,...efpj->...efij", UL,
                    jnp.einsum("fjq,...efpq->...efpj", VL, Rw))
    # masked broadcasts, NOT vmapped scatter-adds
    Kpair = (jnp.where(lower, lo, 0.0) + jnp.where(upper, hi, 0.0)
             + jnp.where(diag, Kdiag[..., :, None, :, :], 0.0))
    return jnp.einsum("ein,...efij,fjm->...nm", A, Kpair, A)


def exchange_kernel_L(teiL, UL, VL, gidx, nrad, R):
    """Radial exchange contraction for ONE L channel and a batch of radial
    helper matrices R[..., nrad, nrad] (already Gaunt-weighted):

        K[..., I, J] = sum_{elements} [ in-element ktei . R  +  factorized
                       cross-element U/V products ]

    Returns the result in the padded global radial square
    [..., nrad+1, nrad+1] (caller slices off the trash slot). Shared by the
    atomic exchange (batch = channel pairs) and the sadatom l-resolved
    exchange (batch = output l channel).

    DESIGN: the cross-element sums run in GLOBAL radial coordinates,

        K_lo = sum_e Av[e]^T (Cv[e] Rp SUlow[e]),   SUlow[e] = sum_{f<e} GU[f]
        K_hi = sum_e Au[e]^T (Cu[e] Rp SVhigh[e]),  SVhigh[e] = sum_{f>e} GV[f]

    with the per-element factors STACKED over e, so each triangle is three
    matmuls with [nelem*nprim, nrad+1]-class shapes. The earlier window
    form materialized [batch, e, f, p, p] tensors and contracted over
    p ~ nprim ~ 12 -- thousands of tiny matmuls instead of a few large
    ones. Matches
    ref:src/atomic/TwoDBasis.cpp:987-1135 term by term.
    """
    nelem, nprim = gidx.shape
    Rp = _pad_rad(R)
    A = _assembler(gidx, nrad)
    # U/V-weighted left factors [e, i, n] (rows of GV/GU' in global coords)
    Cv = jnp.einsum("eip,epn->ein", VL, A)
    Cu = jnp.einsum("eip,epn->ein", UL, A)
    # right factor matrices of the OTHER element of the pair:
    # GU[f][m', m] = sum_{qj} A[f,q,m'] U[f,j,q] A[f,j,m]
    GU = jnp.einsum("fjq,fqx->fjx", UL, A)
    GU = jnp.einsum("fjx,fjm->fxm", GU, A)
    GV = jnp.einsum("fjq,fqx->fjx", VL, A)
    GV = jnp.einsum("fjx,fjm->fxm", GV, A)
    SUlow = jnp.cumsum(GU, axis=0) - GU               # sum over f < e
    SVhigh = jnp.cumsum(GV[::-1], axis=0)[::-1] - GV  # sum over f > e

    def triangle(Cx, Ssum):
        Y = jnp.einsum("ein,...nm->...eim", Cx, Rp)   # stacked (e,i) matmul
        Z = jnp.einsum("...eix,exm->...eim", Y, Ssum)  # batched over e
        return jnp.einsum("ein,...eim->...nm", A, Z)   # stacked (e,i) matmul

    K = triangle(Cv, SUlow) + triangle(Cu, SVhigh)

    # in-element term: windows via the assembly matmuls, [np^2, np^2]-shaped
    # TEI contraction per element, assembled back the same way
    Rg1 = jnp.einsum("ein,...nm->...eim", A, Rp)
    Rg = jnp.einsum("...eim,elm->...eil", Rg1, A)
    Kd = jnp.einsum("eijkl,...eil->...ejk", teiL, Rg)
    Kd1 = jnp.einsum("...ejk,ekm->...ejm", Kd, A)
    K = K + jnp.einsum("ejn,...ejm->...nm", A, Kd1)
    return K


def exchange_general(ops: AtomicOperators, tei, U, V, Lfacv, P: jnp.ndarray,
                     pairwise: bool = False) -> jnp.ndarray:
    """Exchange build with caller-supplied radial kernels: (tei, U, V, Lfacv)
    are the in-element TEI tensors, the factorized small-side/big-side
    disjoint moments, and the per-L prefactors. Used for both the Coulomb
    kernel (U=<r^L>, V=<r^-L-1>, Lfac=4pi/(2L+1)) and the Yukawa
    range-separated kernel (U=<i_L>, V=<k_L>, Lfac=4 pi lambda;
    reference: TwoDBasis::rs_exchange, src/atomic/TwoDBasis.cpp:1142-1321).

    Returns the NEGATIVE exchange contribution to F (the convention of
    TwoDBasis::exchange: F += kfrac * exchange(P)). lax.scan over L; per L
    all (jang, kang) channel pairs and element pairs are batched einsums
    (replacing OpenMP collapse(2), TwoDBasis.cpp:987-1135)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    P4 = _to4(P, nang, nrad)

    # lax.scan over CHUNKS of L channels. Batching the FULL L axis into the
    # einsums multiplies the [nang, nang, nelem, nelem, np, np] working set
    # by NL (31 GB at Xe lmax=3), while per-L steps make NL sequential
    # steps. Chunks of `chunk` channels bound the working set by
    # HELFEM_EXCHANGE_HBM while cutting the step count NL -> NL/chunk.
    NL = int(Lfacv.shape[0])
    nelem, nprim = ops.gidx.shape
    # dominant per-L batched intermediates: R [nang^2, (nrad+1)^2] and the
    # Rw family [nang^2, nelem^2, nprim^2] (x3 lo/hi/T temporaries), at
    # 8 B per f64 element and one live copy (the compiled step's temp
    # bytes grow by 0.5-0.9 copies per added L at Xe lmax=3 on an H100)
    per_L = 8.0 * nang * nang * ((nrad + 1) ** 2 + 3.0 * nelem * nelem * nprim * nprim)
    import os as _os

    budget = float(_os.environ.get("HELFEM_EXCHANGE_HBM", 4e9))
    # cap: compile time grows with the batched body size, so bound the
    # batch even when the budget would allow more
    cap = int(_os.environ.get("HELFEM_EXCHANGE_CHUNK", 4))
    chunk = max(1, min(NL, cap, int(budget // max(per_L, 1.0))))
    npad = (-NL) % chunk
    G, Lf = ops.G, Lfacv
    if npad:
        # zero-padded channels contribute exactly zero (G = tei = U = V = 0)
        zpad = lambda x: jnp.pad(x, [(0, npad)] + [(0, 0)] * (x.ndim - 1))
        G, Lf, tei, U, V = zpad(G), zpad(Lf), zpad(tei), zpad(U), zpad(V)
    resh = lambda x: x.reshape((NL + npad) // chunk, chunk, *x.shape[1:])

    def body(K4, xs):
        GL, LfacL, teiL, UL, VL = xs  # leading axis: chunk of L channels
        # R[g,b,c,I,J] = Lfac_g * sum_{M,a,d} G[g,M,b,a] G[g,M,c,d] P[a,d,IJ]
        # contracted via the Gaunt-product table W so no [g,M,b,d,I,J]
        # intermediate is materialized (it ran out of memory at Xe-size
        # chunks); the remaining contraction is ONE [g b c, a d] x
        # [a d, I J] matmul
        W = jnp.einsum("gMba,gMcd->gbcad", GL, GL)
        R = LfacL[:, None, None, None, None] * jnp.einsum("gbcad,adIJ->gbcIJ", W, P4)
        kern = exchange_kernel_L_pairwise if pairwise else exchange_kernel_L
        Kg = jax.vmap(
            lambda t, u, v, r: kern(t, u, v, ops.gidx, nrad, r)
        )(teiL, UL, VL, R)
        return K4 + Kg.sum(axis=0), None

    K4 = jnp.zeros((nang, nang, nrad + 1, nrad + 1))
    K4, _ = jax.lax.scan(body, K4, tuple(resh(x) for x in (G, Lf, tei, U, V)))
    K4 = K4[:, :, :nrad, :nrad]
    return -_from4(K4, nang, nrad)


def exchange(ops: AtomicOperators, P: jnp.ndarray) -> jnp.ndarray:
    """Full-range exchange K(P) (negative contribution to F)."""
    return exchange_general(ops, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, P)


class RSOperators(NamedTuple):
    """Range-separated (Yukawa) exchange tables."""

    tei: jnp.ndarray  # [NL, nelem, np, np, np, np] yukawa in-element
    iL: jnp.ndarray  # [NL, nelem, np, np] <i_L(lam r)> small side
    kL: jnp.ndarray  # [NL, nelem, np, np] <k_L(lam r)> big side
    Lfac: jnp.ndarray  # [NL] = 4 pi lam


def rs_exchange(ops: AtomicOperators, rs: RSOperators, P: jnp.ndarray) -> jnp.ndarray:
    """Short-range (Yukawa-attenuated) exchange. Uses the pairwise cross-
    element kernel: the i_L/k_L tables span e^(±λ·rmax) and the stacked
    form loses accuracy when the scales are not paired per element."""
    return exchange_general(ops, rs.tei, rs.iL, rs.kL, rs.Lfac, P, pairwise=True)


class ErfcOperators(NamedTuple):
    """erfc short-range exchange tables (dense over element pairs)."""

    tei: jnp.ndarray  # [NL, nelem, nelem, np, np, np, np]
    Lfac: jnp.ndarray  # [NL] = 4 pi mu / (2L+1)


def erfc_exchange(ops: AtomicOperators, rs: "ErfcOperators", P: jnp.ndarray) -> jnp.ndarray:
    """Short-range erfc-attenuated exchange: the kernel does not factorize,
    so all element pairs contract against dense TEI blocks
    (reference: rs_exchange erfc path, src/atomic/TwoDBasis.cpp:1255-1283)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    A = _assembler(ops.gidx, nrad)
    P4 = _to4(P, nang, nrad)

    def body(K4, xs):
        GL, LfacL, teiL = xs
        t1 = jnp.einsum("Mba,adIJ->MbdIJ", GL, P4)
        R = LfacL * jnp.einsum("Mcd,MbdIJ->bcIJ", GL, t1)
        Rp = _pad_rad(R)
        Rw = jnp.einsum("ein,bcnm,flm->bcefil", A, Rp, A)
        # K[j,k] over (e-window, f-window) = sum_il tei[e,f,i,j,k,l] R[i,l]
        Kpair = jnp.einsum("efijkl,bcefil->bcefjk", teiL, Rw)
        K4 = K4 + jnp.einsum("ejn,bcefjk,fkm->bcnm", A, Kpair, A)
        return K4, None

    K4 = jnp.zeros((nang, nang, nrad + 1, nrad + 1))
    K4, _ = jax.lax.scan(body, K4, (ops.G, rs.Lfac, rs.tei))
    K4 = K4[:, :, :nrad, :nrad]
    return -_from4(K4, nang, nrad)


def channel_diag(P: jnp.ndarray, nang: int, nrad: int) -> jnp.ndarray:
    """Per-angular-channel diagonal radial blocks Pd[a] = P[a-block, a-block]
    of a full density matrix ([nbf,nbf] -> [nang, nrad, nrad])."""
    P4 = _to4(P, nang, nrad)
    return P4[jnp.arange(nang), jnp.arange(nang)]


def exchange_general_bd(ops: AtomicOperators, tei, U, V, Lfacv,
                        Pd: jnp.ndarray, pairwise: bool = False) -> jnp.ndarray:
    """Exchange for a density that is BLOCK-DIAGONAL over angular channels:
    P4[a, d] = delta_ad * Pd[a], which holds by construction whenever the
    SCF runs per-(l,m) symmetry blocks (the atomic default, reference
    dsym=2) -- every occupied orbital then lives in a single angular
    channel, so P never develops cross-channel blocks.

    DESIGN: the dense path builds NL*nang^2 channel-pair R matrices
    (R[g,b,c] = sum_{M,a,d} G[g,M,b,a] G[g,M,c,d] P4[a,d]) and runs the
    radial kernel on each. With P4 channel-diagonal,

        R[g,b,c] = sum_a wG[g,b,c,a] Pd[a],
        wG[g,b,c,a] = Lfac_g * sum_M G[g,M,b,a] G[g,M,c,a],

    and since the radial kernel is LINEAR in R, only NL*nang kernel
    evaluations are needed -- KK[g,a] = kernel_L(Pd[a]) -- followed by one
    Gaunt-weighting matmul K[b,c] = sum_{g,a} wG[g,b,c,a] KK[g,a]. That is
    ~nang x fewer kernel FLOPs AND ~nang x less working set than the dense
    path, so the whole exchange fits in ONE fused dispatch (no L-chunked
    scan). Exactly equal to exchange_general(P) for channel-diagonal P
    (tested); the reference computes the dense form unconditionally
    (src/atomic/TwoDBasis.cpp:957-1150)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    kern = exchange_kernel_L_pairwise if pairwise else exchange_kernel_L
    # radial kernel on every (L, channel) pair: batch axis = nang
    KK = jax.vmap(lambda t, u, v: kern(t, u, v, ops.gidx, nrad, Pd))(tei, U, V)
    wG = jnp.einsum("gMba,gMca->gbca", ops.G, ops.G) * Lfacv[:, None, None, None]
    K4 = jnp.einsum("gbca,gaNM->bcNM", wG, KK)[:, :, :nrad, :nrad]
    return -_from4(K4, nang, nrad)


def exchange_bd(ops: AtomicOperators, Pd: jnp.ndarray) -> jnp.ndarray:
    """Full-range exchange K(P) for channel-block-diagonal P, from the
    per-channel diagonal radial blocks Pd [nang, nrad, nrad]."""
    return exchange_general_bd(ops, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, Pd)


def rs_exchange_bd(ops: AtomicOperators, rs: RSOperators, Pd: jnp.ndarray) -> jnp.ndarray:
    """Yukawa short-range exchange for channel-block-diagonal P (pairwise
    cross-element kernel for the i_L/k_L scale pairing, see rs_exchange)."""
    return exchange_general_bd(ops, rs.tei, rs.iL, rs.kL, rs.Lfac, Pd, pairwise=True)


def erfc_exchange_bd(ops: AtomicOperators, rs: "ErfcOperators", Pd: jnp.ndarray) -> jnp.ndarray:
    """erfc short-range exchange for channel-block-diagonal P: same
    nang^2 -> nang collapse as exchange_general_bd, dense element-pair TEI
    blocks like erfc_exchange."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    A = _assembler(ops.gidx, nrad)
    Rp = _pad_rad(Pd)  # [a, nrad+1, nrad+1]
    Rw = jnp.einsum("ein,anm,flm->aefil", A, Rp, A)

    def body(K4, xs):
        GL, LfacL, teiL = xs
        Kpair = jnp.einsum("efijkl,aefil->aefjk", teiL, Rw)
        KA = jnp.einsum("ejn,aefjk,fkm->anm", A, Kpair, A)
        wG = LfacL * jnp.einsum("Mba,Mca->bca", GL, GL)
        return K4 + jnp.einsum("bca,anm->bcnm", wG, KA), None

    K4 = jnp.zeros((nang, nang, nrad + 1, nrad + 1))
    K4, _ = jax.lax.scan(body, K4, (ops.G, rs.Lfac, rs.tei))
    K4 = K4[:, :, :nrad, :nrad]
    return -_from4(K4, nang, nrad)
