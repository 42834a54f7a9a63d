"""Diatomic molecules: prolate-spheroidal two-center FEM (stage 8).

Redesign of src/diatomic/{basis,quadrature}.cpp. Electron coordinates
(mu, nu, phi) with xi = cosh mu, eta = cos nu; nuclei at z = +-Rh on the
z axis (Rh = R/2, "Rhalf"); volume element Rh^3 (cosh^2 mu - eta^2) sinh mu.

Basis chi_{n l m} = B_n(mu) Y_lm(nu, phi): radial FEM functions B in mu
(nothing dropped at mu=0 -- sigma orbitals reach the nuclei; the first radial
function of every m != 0 shell is removed via per-shell masks, replacing the
reference's pure_indices surgery, src/diatomic/basis.cpp:461-472), function
dropped at mu_max.

Operator structure (reference: src/diatomic/basis.cpp:677-953):
    S  = Rh^3 [ I(1,2) delta_ll' - I(1,0) cos2_coupling ]
    T  = Rh/2 [ <B'|sinh|B'> + l(l+1) I(1,0) + m^2 I(-1,0) ]
    V  = -Rh^2 [ (Z1+Z2) I(1,1) delta + (Z2-Z1) I(1,0) cos1_coupling ]
with I(m,n) = <B_i | sinh^m mu cosh^n mu | B_j>.

Two-electron integrals use the Neumann expansion of 1/r12 with Legendre
P_L^M(xi<) Q_L^M(xi>) radial kernels (ops/legendreq.py) and FOUR in-element
tensor families from the two cosh^2 volume-element slots; cross-element
terms factorize into P/Q moment products. The Coulomb/exchange builds are
jittable scans over the (L,M) channel list with batched einsums and
prefix sums over the element axis, replacing the reference's OpenMP loops
(src/diatomic/basis.cpp:1166-1734).
"""

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from helfem_tpu.ops.fem import FEMBasis
from helfem_tpu.ops.gaunt import (
    cosk_coupling,
    gaunt_coefficient,
    modified_gaunt_coefficient,
)
from helfem_tpu.ops.grids import get_grid
from helfem_tpu.ops.legendreq import legendre_PQ
from helfem_tpu.ops.polynomials import get_basis
from helfem_tpu.ops.quadrature import chebyshev
from helfem_tpu.utils.linalg import form_sinvh, form_sinvh_chol

__all__ = ["DiatomicBasis", "DiatomicOperators", "coulomb_dia", "exchange_dia"]


def lm_to_l_m(lmax_per_m):
    """Angular shells from a per-|m| lmax list
    (reference: diatomic::basis::lm_to_l_m, basis.cpp:287-302)."""
    lv, mv = [], []
    for mabs, lmax in enumerate(lmax_per_m):
        for l in range(mabs, lmax + 1):
            lv.append(l)
            mv.append(mabs)
            if mabs > 0:
                lv.append(l)
                mv.append(-mabs)
    return np.array(lv), np.array(mv)


class DiatomicOperators(NamedTuple):
    gidx: jnp.ndarray  # [nelem, nprim]
    shellmask: jnp.ndarray  # [nang, nrad]
    # one-electron
    S: jnp.ndarray
    H0: jnp.ndarray
    T: jnp.ndarray
    Vnuc: jnp.ndarray
    # signed (L,M) channel tables for J
    GmLM: jnp.ndarray  # [nLM, nang, nang] modified-Gaunt couplings
    GpLM: jnp.ndarray  # [nLM, nang, nang] plain-Gaunt couplings
    LM_ilm: jnp.ndarray  # [nLM] -> index into the (L,|M|) radial tables
    # unsigned (L,|M|) radial tables
    LMfac: jnp.ndarray  # [nlm] = 4 pi Rh^5 (-1)^M (L-|M|)!/(L+|M|)!
    # in-element radial TEI tables in MATMUL-NATIVE pair layouts, family
    # axis F = (00, 02, 20, 22). Minor dims are np^2 x np^2, so the J and
    # K contractions are plain matmuls with no 4-index transpose per call.
    teiJ: jnp.ndarray  # [nlm, 4, nelem, np^2(ij), np^2(kl)]  Coulomb pairing
    teiK: jnp.ndarray  # [nlm, 4, nelem, np^2(jk), np^2(il)]  exchange pairing
    dP0: jnp.ndarray  # [nlm, nelem, np, np] disjoint P/Q moments
    dP2: jnp.ndarray
    dQ0: jnp.ndarray
    dQ2: jnp.ndarray
    # exchange scan channel indexing: one entry per (L,|M|) channel; the
    # bra-shell axis is handled densely INSIDE each channel step (a real
    # matmul dimension, not a sequential-scan axis)
    step_ilm: jnp.ndarray  # [nlm] -> index into the (L,|M|) radial tables
    step_sp: jnp.ndarray  # [nlm] signed iLM for +|M|
    step_sm: jnp.ndarray  # [nlm] signed iLM for -|M| (== step_sp when M=0)
    step_wm: jnp.ndarray  # [nlm] 0.0 when M=0 (avoid double count) else 1.0
    # eigensolve blocks
    blk_idx: jnp.ndarray  # [nblk, blen] global indices (padded with nbf)
    blk_sinvh: jnp.ndarray  # [nblk, blen, blen]


@dataclass
class DiatomicBasis:
    Z1: int
    Z2: int
    Rbond: float
    lmax: tuple  # per-|m| lmax list, len = mmax+1
    rmax: float = 40.0
    nelem: int = 8
    nnodes: int = 12
    nquad: int = 0
    igrid: int = 4
    zexp: float = 2.0
    primbas: int = 4
    # explicit element boundaries in mu (overrides rmax/nelem/igrid/zexp;
    # used when reconstructing a basis from a reference-schema HDF5
    # checkpoint, which stores bval directly)
    bval: np.ndarray | None = None

    lval: np.ndarray = field(init=False)
    mval: np.ndarray = field(init=False)
    fem: FEMBasis = field(init=False)

    def __post_init__(self):
        if isinstance(self.lmax, int):
            self.lmax = (self.lmax,)
        self.lval, self.mval = lm_to_l_m(self.lmax)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        self.Rhalf = 0.5 * self.Rbond
        if self.bval is not None:
            bval = np.asarray(self.bval, dtype=float)
            self.nelem = len(bval) - 1
            self.rmax = float(self.Rhalf * np.cosh(bval[-1]))
        else:
            mumax = np.arccosh(self.rmax / self.Rhalf)
            bval = get_grid(mumax, self.nelem, self.igrid, self.zexp)
        poly = get_basis(self.primbas, self.nnodes)
        self.fem = FEMBasis(poly, bval, drop_first=False, drop_last=True)
        self.xq, self.wq = chebyshev(self.nquad)
        self.mu = self.fem.coords(self.xq)  # [nelem, nq]
        self.wmu = self.wq[None, :] * (0.5 * self.fem.lengths)[:, None]
        dn = self.fem.eval_dnf(self.xq, 1)
        self.B, self.dB = dn[0], dn[1]
        self._d2B = None
        # (L,|M|) and signed (L,M) channel maps
        self._build_channels()

    @property
    def d2B(self):
        """d^2B/dmu^2 at the quadrature points (laplacian meta-GGA path)."""
        if self._d2B is None:
            self._d2B = self.fem.eval_dnf(self.xq, 2)[2]
        return self._d2B

    # --- sizes ----------------------------------------------------------------
    @property
    def nang(self):
        return len(self.lval)

    @property
    def nrad(self):
        return self.fem.nbf

    @property
    def nbf(self):
        return self.nang * self.nrad  # incl. masked per-shell functions

    def shell_mask(self) -> np.ndarray:
        """[nang, nrad]: zero at the first radial function for m != 0 shells."""
        mask = np.ones((self.nang, self.nrad))
        mask[self.mval != 0, 0] = 0.0
        return mask

    def _build_channels(self):
        lms = set()
        LMs = set()
        for a in range(self.nang):
            for b in range(self.nang):
                M = int(self.mval[a] - self.mval[b])
                Lmin = max(abs(int(self.lval[a] - self.lval[b])) - 2, abs(M))
                Lmaxv = int(self.lval[a] + self.lval[b]) + 2
                for L in range(Lmin, Lmaxv + 1):
                    lms.add((L, abs(M)))
                    LMs.add((L, M))
        self.lm_map = sorted(lms)
        # M = 0 channels FIRST: GmLM/GpLM are built with the hard selection
        # m_a - m_b = M, so a symmetry-block-diagonal density (m_a = m_b,
        # guaranteed by the per-m blocked eigensolve) projects to zero on
        # every M != 0 channel -- the Coulomb build can run on this prefix
        # alone (coulomb_dia njbd), skipping ~8x of the channel scan.
        self.LM_map = sorted(LMs, key=lambda p: (p[1] != 0, p))
        self.njbd = sum(1 for (_, M) in self.LM_map if M == 0)
        self.lm_index = {p: i for i, p in enumerate(self.lm_map)}

    # --- radial integrals -------------------------------------------------------
    def radial_integral(self, m: int, n: int, per_element: bool = False):
        f = np.sinh(self.mu) ** m if m else np.ones_like(self.mu)
        if n:
            f = f * np.cosh(self.mu) ** n
        el = np.einsum("eqi,eq,eqj->eij", self.B, self.wmu * f, self.B, optimize=True)
        return el if per_element else self.fem.assemble(el)

    def kinetic_radial(self) -> np.ndarray:
        return self.fem.assemble(
            np.einsum("eqi,eq,eqj->eij", self.dB, self.wmu * np.sinh(self.mu), self.dB)
        )

    # --- one-electron operators ---------------------------------------------------
    def _couple(self, radial_blocks: dict) -> np.ndarray:
        """Assemble sum over couplings: radial_blocks maps coupling-kind
        ('delta' or ('cos', k)) -> radial matrix."""
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        for a in range(nang):
            for b in range(nang):
                if self.mval[a] != self.mval[b]:
                    continue
                blk = np.zeros((nrad, nrad))
                use = False
                for kind, mat in radial_blocks.items():
                    if kind == "delta":
                        if self.lval[a] == self.lval[b]:
                            blk = blk + mat
                            use = True
                    else:
                        k = kind[1]
                        c = cosk_coupling(
                            k, int(self.lval[a]), int(self.mval[a]), int(self.lval[b]), int(self.mval[b])
                        )
                        if c != 0.0:
                            blk = blk + c * mat
                            use = True
                if use:
                    out[a * nrad : (a + 1) * nrad, b * nrad : (b + 1) * nrad] = blk
        return out

    def overlap(self) -> np.ndarray:
        I12 = self.radial_integral(1, 2)
        I10 = self.radial_integral(1, 0)
        Rh = self.Rhalf
        return Rh**3 * self._couple({"delta": I12, ("cos", 2): -I10})

    def kinetic(self) -> np.ndarray:
        Trad = self.kinetic_radial()
        I10 = self.radial_integral(1, 0)
        Im10 = self.radial_integral(-1, 0)
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        for a in range(nang):
            l, m = int(self.lval[a]), int(self.mval[a])
            blk = Trad + l * (l + 1) * I10 + m * m * Im10
            out[a * nrad : (a + 1) * nrad, a * nrad : (a + 1) * nrad] = blk
        return 0.5 * self.Rhalf * out

    def nuclear(self) -> np.ndarray:
        I11 = self.radial_integral(1, 1)
        I10 = self.radial_integral(1, 0)
        Rh = self.Rhalf
        return -(Rh**2) * self._couple(
            {"delta": (self.Z1 + self.Z2) * I11, ("cos", 1): (self.Z2 - self.Z1) * I10}
        )

    def dipole_z(self) -> np.ndarray:
        I11 = self.radial_integral(1, 1)
        I13 = self.radial_integral(1, 3)
        return self.Rhalf**4 * self._couple({("cos", 1): I13, ("cos", 3): -I11})

    def quadrupole_zz(self) -> np.ndarray:
        """z^2 - (x^2 + y^2)/2 matrix in prolate coordinates (reference:
        diatomic TwoDBasis::quadrupole_zz, src/diatomic/basis.cpp:857-900)."""
        I10 = self.radial_integral(1, 0)
        I12 = self.radial_integral(1, 2)
        I14 = self.radial_integral(1, 4)
        return (self.Rhalf**5 / 2.0) * self._couple(
            {
                ("cos", 4): I10 - 3.0 * I12,
                ("cos", 2): 3.0 * I14 - I10,
                "delta": I12 - I14,
            }
        )

    def Bz_field(self, B: float) -> np.ndarray:
        """Orbital Zeeman + diamagnetic operator for a uniform field B along
        the bond axis: -B/2 L_z + B^2/8 (x^2 + y^2) (reference: diatomic
        TwoDBasis::Bz_field, src/diatomic/basis.cpp:902-953). The spin term
        -+ B/2 is applied by the SCF driver."""
        from helfem_tpu.ops.gaunt import cos2sin2_coupling, cosk_coupling, sine2_coupling

        Rh = self.Rhalf
        I10 = self.radial_integral(1, 0) * Rh**3
        I12 = self.radial_integral(1, 2) * Rh**3
        I30 = self.radial_integral(3, 0) * Rh**5
        I32 = self.radial_integral(3, 2) * Rh**5
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        cs = B * B / 8.0
        for a in range(nang):
            la, ma = int(self.lval[a]), int(self.mval[a])
            for b in range(nang):
                lb, mb = int(self.lval[b]), int(self.mval[b])
                if ma != mb:
                    continue
                blk = np.zeros((nrad, nrad))
                use = False
                # diamagnetic rho^2 = Rh^2 sinh^2 mu sin^2 nu:
                # sinh^2 cosh^2-weighted sin^2 and sinh^2-weighted cos^2 sin^2
                c2 = sine2_coupling(lb, mb, la, ma)
                if c2 != 0.0:
                    blk += cs * c2 * I32
                    use = True
                c22 = cos2sin2_coupling(lb, mb, la, ma)
                if c22 != 0.0:
                    blk -= cs * c22 * I30
                    use = True
                # paramagnetic -B/2 m <chi|chi>
                ds = -0.5 * ma * B
                if ds != 0.0:
                    if la == lb:
                        blk += ds * I12
                        use = True
                    c = cosk_coupling(2, lb, mb, la, ma)
                    if c != 0.0:
                        blk -= ds * c * I10
                        use = True
                if use:
                    out[a * nrad : (a + 1) * nrad, b * nrad : (b + 1) * nrad] = blk
        m2 = self.shell_mask().reshape(-1)
        return out * m2[:, None] * m2[None, :]

    # --- symmetry blocks -----------------------------------------------------------
    def sym_blocks(self, parity: bool = True):
        """Valid global indices per symmetry block: by m, plus gerade/
        ungerade (l parity) for homonuclear (reference: m_indices(m, odd),
        src/diatomic/basis.h:262-266). Respects per-shell radial masks.
        parity=False disables the g/u split (needed when an electric field
        couples even and odd l)."""
        mask = self.shell_mask()
        blocks = []
        parities = [0, 1] if (self.Z1 == self.Z2 and parity) else [None]
        for m in sorted(set(self.mval)):
            for par in parities:
                idx = []
                for a in range(self.nang):
                    if self.mval[a] != m:
                        continue
                    if par is not None and self.lval[a] % 2 != par:
                        continue
                    base = a * self.nrad
                    start = 0 if mask[a, 0] else 1
                    idx.extend(range(base + start, base + self.nrad))
                if idx:
                    blocks.append(np.array(idx))
        return blocks

    def sym_labels(self, parity: bool = True) -> list[str]:
        """Spectroscopic label per symmetry block, in sym_blocks order:
        sigma/pi/delta/... by |m|, with g/u parity for homonuclear
        (Y_lm inversion parity is (-1)^l; reference: classify_orbitals,
        src/diatomic/main.cpp)."""
        greek = ["sigma", "pi", "delta", "phi", "gamma", "eta"]
        labels = []
        parities = [0, 1] if (self.Z1 == self.Z2 and parity) else [None]
        mask = self.shell_mask()
        for m in sorted(set(self.mval)):
            for par in parities:
                has = any(
                    self.mval[a] == m and (par is None or self.lval[a] % 2 == par)
                    for a in range(self.nang)
                )
                if not has:
                    continue
                # mval carries SIGNED m; the spectroscopic letter is by |m|
                name = greek[abs(m)] if abs(m) < len(greek) else f"m={m}"
                if par is not None:
                    name += "g" if par == 0 else "u"
                labels.append(name)
        return labels

    # --- TEI tables -------------------------------------------------------------------
    def _legendre_tables(self):
        """P/Q at all outer and inner quadrature points, per element."""
        Lmax = max(L for L, _ in self.lm_map)
        Mmax = max(M for _, M in self.lm_map)
        nelem, nq = self.mu.shape
        # inner points per (element, segment)
        mu_in = np.empty((nelem, nq, nq))
        for e in range(nelem):
            lo = np.concatenate([[self.fem.bval[e]], self.mu[e][:-1]])
            hi = self.mu[e]
            mid, hlen = 0.5 * (lo + hi), 0.5 * (hi - lo)
            mu_in[e] = mid[:, None] + hlen[:, None] * self.xq[None, :]
        self._mu_in = mu_in
        P_out, Q_out = legendre_PQ(Lmax, Mmax, mu=self.mu.ravel())
        P_in, Q_in = legendre_PQ(Lmax, Mmax, mu=mu_in.ravel())
        return (
            P_out.reshape(Lmax + 1, Mmax + 1, nelem, nq),
            Q_out.reshape(Lmax + 1, Mmax + 1, nelem, nq),
            P_in.reshape(Lmax + 1, Mmax + 1, nelem, nq, nq),
            Q_in.reshape(Lmax + 1, Mmax + 1, nelem, nq, nq),
        )

    def compute_tei(self, k_layout: bool = True):
        """All radial TEI tables: in-element 4 families + disjoint moments,
        indexed by the (L,|M|) channel list. The in-element families are
        returned DIRECTLY in the two matmul-native pair layouts the J/K
        builds consume (teiJ rows (ij)/cols (kl); teiK rows (jk)/cols (il)).

        k_layout=False (the build_operators default): return teiJ with the
        REDUCED family axis [(0,0), (0,2), (2,2)] and teiK=None. The (2,0)
        family is exactly the per-block transpose of (0,2) (ws20 =
        wrk[(2,0)] + wrk[(0,2)].T = ws02.T) and the K pair layout is a pure
        index permutation of the J layout, so both are reconstructed ON
        DEVICE by tei_from_J3 -- shipping 3/8 of the bytes host->device
        (~2 GB of tables at the reference-converged N2 lmax=12).

        All contractions are batched over the full channel axis (the
        reference's OpenMP-over-(L,M) loop, src/diatomic/basis.cpp:1166-1187,
        becomes a handful of BLAS-backed einsums): at N2 lmax=12 that is
        207 channels x nelem elements in a few seconds instead of thousands
        of per-channel dispatches. The pair regroup runs per (channel,
        family, element) on L2-resident nprim^4 blocks -- one global
        transpose of the assembled [nlm, 4, nelem, np^4] tensor walks a
        multi-GB working set with cache-hostile strides and measured ~10x
        slower than the whole double quadrature."""
        nelem, nq = self.mu.shape
        nprim = self.fem.nprim
        nlm = len(self.lm_map)
        P_out, Q_out, P_in, Q_in = self._legendre_tables()
        ch_out = np.cosh(self.mu)
        sh_out = np.sinh(self.mu)
        mu_in = self._mu_in
        ch_in = np.cosh(mu_in)
        sh_in = np.sinh(mu_in)
        # channel-indexed P/Q slices: [nlm, nelem, nq(, nq)]
        Ls = np.array([L for L, _ in self.lm_map])
        Ms = np.array([Ma for _, Ma in self.lm_map])
        Pc_out, Qc_out = P_out[Ls, Ms], Q_out[Ls, Ms]
        Pc_in = P_in[Ls, Ms]

        # disjoint moments: <B_i B_j sinh cosh^k {P,Q}_LM>_e, batched over c
        def dmom(tab, k):
            w = (self.wmu * sh_out * ch_out**k)[None] * tab  # [c, e, q]
            return np.einsum("eqi,ceq,eqj->ceij", self.B, w, self.B, optimize=True)

        dP0, dQ0 = dmom(Pc_out, 0), dmom(Qc_out, 0)
        dP2, dQ2 = dmom(Pc_out, 2), dmom(Qc_out, 2)

        # in-element double quadrature, batched over channels per element.
        # hugepage-backed tables: this VM faults 4 KiB pages at ~15 s/GB on
        # first touch, which made ALLOCATING these (2 GB at lmax=12) cost
        # more than computing them (utils/hostmem.py)
        from helfem_tpu.utils.hostmem import huge_empty

        np2 = nprim * nprim
        nfam = 4 if k_layout else 3
        teiJ = huge_empty((nlm, nfam, nelem, np2, np2))
        teiK = huge_empty((nlm, 4, nelem, np2, np2)) if k_layout else None
        # basis values at inner points
        Bin = np.empty((nelem, nq, nq, nprim))
        for e in range(nelem):
            xpoly = (mu_in[e] - self.fem.mids[e]) / (0.5 * self.fem.lengths[e])
            Bin[e] = self.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, nprim)
        seg_hlen = np.empty((nelem, nq))
        for e in range(nelem):
            lo = np.concatenate([[self.fem.bval[e]], self.mu[e][:-1]])
            seg_hlen[e] = 0.5 * (self.mu[e] - lo)

        # family axis order; k_layout=False drops (2, 0) = (0, 2).T
        fams = ([(0, 0), (0, 2), (2, 0), (2, 2)] if k_layout
                else [(0, 0), (0, 2), (2, 2)])
        for e in range(nelem):
            # inner-point pair products [p, q, kl] and outer pair products [p, ij]
            BBin = (Bin[e][:, :, :, None] * Bin[e][:, :, None, :]).reshape(nq, nq, np2)
            BBout = (self.B[e][:, :, None] * self.B[e][:, None, :]).reshape(nq, np2)
            wbase = self.wq[None, None, :] * seg_hlen[e][None, :, None] * sh_in[e][None] * Pc_in[:, e]
            wrk = {}
            for l in (0, 2):
                wseg = wbase * ch_in[e][None] ** l  # [c, p, q]
                # segment integrals as p-batched GEMMs: [p,c,q] @ [p,q,kl]
                seg = np.matmul(wseg.transpose(1, 0, 2), BBin)  # [p, c, kl]
                inner = np.cumsum(seg, axis=0).transpose(1, 0, 2)  # [c, p, kl]
                for k in (0, 2):
                    wout = (self.wmu[e] * sh_out[e] * ch_out[e] ** k)[None] * Qc_out[:, e]
                    # [c, ij, kl] = sum_p wout[c,p] BBout[p,ij] inner[c,p,kl]
                    A = wout[:, :, None] * BBout[None]  # [c, p, ij]
                    wrk[(k, l)] = np.matmul(A.transpose(0, 2, 1), inner)  # [c,ij,kl]
            # symmetrize (ij)<->(kl) -- family (k,l) pairs with (l,k)
            # transposed -- and write both pair layouts per channel: the
            # [np^2, np^2] blocks stay cache-resident, and the J layout is
            # the symmetrized matrix itself (no 4-index reshuffle)
            for F, (k, l) in enumerate(fams):
                for c in range(nlm):
                    ws = wrk[(k, l)][c] + wrk[(l, k)][c].T
                    teiJ[c, F, e] = ws
                    if k_layout:
                        teiK[c, F, e] = (
                            ws.reshape(nprim, nprim, nprim, nprim)
                            .transpose(1, 2, 0, 3)
                            .reshape(np2, np2)
                        )
        return teiJ, teiK, dP0, dP2, dQ0, dQ2

    # --- device constants ----------------------------------------------------------------
    def build_operators(self, parity: bool = True, chol: bool = False) -> DiatomicOperators:
        """chol=True whitens each symmetry block with the inverse Cholesky
        factor instead of the symmetric eigendecomposition half-inverse
        (reference --diag 0, TwoDBasis::Sinvh(chol=true),
        src/diatomic/main.cpp:111,472)."""
        from math import factorial

        nang, nrad = self.nang, self.nrad
        nLM = len(self.LM_map)
        nlm = len(self.lm_map)
        GmLM = np.zeros((nLM, nang, nang))
        GpLM = np.zeros((nLM, nang, nang))
        LM_ilm = np.zeros(nLM, dtype=np.int32)
        for s, (L, M) in enumerate(self.LM_map):
            LM_ilm[s] = self.lm_index[(L, abs(M))]
            for a in range(nang):
                for b in range(nang):
                    if self.mval[a] - self.mval[b] != M:
                        continue
                    GmLM[s, a, b] = modified_gaunt_coefficient(
                        int(self.lval[a]), int(self.mval[a]), L, M, int(self.lval[b]), int(self.mval[b])
                    )
                    GpLM[s, a, b] = gaunt_coefficient(
                        int(self.lval[a]), int(self.mval[a]), L, M, int(self.lval[b]), int(self.mval[b])
                    )
        LMfac = np.array(
            [
                4.0 * np.pi * self.Rhalf**5 * (-1.0) ** Ma * factorial(L - Ma) / factorial(L + Ma)
                for (L, Ma) in self.lm_map
            ]
        )
        # in-element families in the two matmul-native pair layouts (teiJ
        # rows (ij)/cols (kl), teiK rows (jk)/cols (il)). Only the REDUCED
        # J table ([(0,0),(0,2),(2,2)] family axis, 3/8 of the bytes) is
        # computed on host and shipped; the (2,0) family (= (0,2).T per
        # block) and the whole K pair layout (a pure index permutation) are
        # reconstructed ON DEVICE (tei_from_J3), cutting the host->device
        # transfer of the ~GB tables at big bases by 5/8
        teiJ3, _, dP0, dP2, dQ0, dQ2 = self.compute_tei(k_layout=False)
        # Balance the disjoint P/Q moment tables per (L,|M|) channel: the
        # P_LM(cosh mu) moments reach ~1e49 at the reference-converged
        # lmax=12 (L up to 26, mu_max ~ 4.3) while the paired Q_LM moments
        # underflow toward zero; only same-channel P x Q products across
        # elements are ever consumed (the Neumann-expansion pairing in
        # coulomb_dia / exchange_dia / exchange_dia_occ and the sharded
        # mesh mirrors), so scaling dP by alpha_c and dQ by 1/alpha_c with
        # alpha_c = sqrt(max|dQ_c| / max|dP_c|) leaves every product
        # unchanged up to rounding.
        mP = np.maximum(np.abs(dP0).max(axis=(1, 2, 3)),
                        np.abs(dP2).max(axis=(1, 2, 3)))
        mQ = np.maximum(np.abs(dQ0).max(axis=(1, 2, 3)),
                        np.abs(dQ2).max(axis=(1, 2, 3)))
        ok = (mP > 0) & (mQ > 0)
        alpha = np.where(ok, np.sqrt(np.where(ok, mQ, 1.0) /
                                     np.where(ok, mP, 1.0)), 1.0)
        a4 = alpha[:, None, None, None]
        dP0, dP2 = dP0 * a4, dP2 * a4
        dQ0, dQ2 = dQ0 / a4, dQ2 / a4
        nprim = self.fem.nprim
        teiJ_dev, teiK_dev = tei_from_J3(jnp.asarray(teiJ3), nprim)

        # exchange scan channels: one step per (L,|M|) with signed-LM lookups
        LM_pos = {p: i for i, p in enumerate(self.LM_map)}
        s_ilm, s_sp, s_sm, s_wm = [], [], [], []
        for i, (L, Ma) in enumerate(self.lm_map):
            s_ilm.append(i)
            s_sp.append(LM_pos[(L, Ma)])
            if Ma > 0 and (L, -Ma) in LM_pos:
                s_sm.append(LM_pos[(L, -Ma)])
                s_wm.append(1.0)
            else:
                s_sm.append(LM_pos[(L, Ma)])
                s_wm.append(0.0)

        # symmetry blocks for the eigensolve, padded to a common length
        S = self.overlap()
        blocks = self.sym_blocks(parity)
        blen = max(len(b) for b in blocks)
        nblk = len(blocks)
        blk_idx = np.full((nblk, blen), self.nbf, dtype=np.int32)
        blk_sinvh = np.zeros((nblk, blen, blen))
        for i, idx in enumerate(blocks):
            blk_idx[i, : len(idx)] = idx
            inv = form_sinvh_chol if chol else form_sinvh
            blk_sinvh[i, : len(idx), : len(idx)] = inv(S[np.ix_(idx, idx)])

        T = self.kinetic()
        V = self.nuclear()
        mask = self.shell_mask()
        mv = mask.reshape(-1)
        # mask garbage rows/cols of the one-electron matrices
        S = S * mv[:, None] * mv[None, :]
        T = T * mv[:, None] * mv[None, :]
        V = V * mv[:, None] * mv[None, :]

        return DiatomicOperators(
            gidx=jnp.asarray(self.fem.gidx),
            shellmask=jnp.asarray(mask),
            S=jnp.asarray(S),
            H0=jnp.asarray(T + V),
            T=jnp.asarray(T),
            Vnuc=jnp.asarray(V),
            GmLM=jnp.asarray(GmLM),
            GpLM=jnp.asarray(GpLM),
            LM_ilm=jnp.asarray(LM_ilm),
            LMfac=jnp.asarray(LMfac),
            teiJ=teiJ_dev,
            teiK=teiK_dev,
            dP0=jnp.asarray(dP0),
            dP2=jnp.asarray(dP2),
            dQ0=jnp.asarray(dQ0),
            dQ2=jnp.asarray(dQ2),
            step_ilm=jnp.asarray(np.array(s_ilm, dtype=np.int32)),
            step_sp=jnp.asarray(np.array(s_sp, dtype=np.int32)),
            step_sm=jnp.asarray(np.array(s_sm, dtype=np.int32)),
            step_wm=jnp.asarray(np.array(s_wm)),
            blk_idx=jnp.asarray(blk_idx),
            blk_sinvh=jnp.asarray(blk_sinvh),
        )


# --------------------------------------------------------------------------------
# jitted J/K builds
# --------------------------------------------------------------------------------


from functools import partial as _partial


@jax.jit
def _tei_J_from_J3(teiJ3: jnp.ndarray):
    return jnp.stack(
        [teiJ3[:, 0], teiJ3[:, 1],
         jnp.swapaxes(teiJ3[:, 1], -1, -2), teiJ3[:, 2]], axis=1)


@_partial(jax.jit, static_argnames=("nprim",))
def _tei_K_from_J(teiJ: jnp.ndarray, nprim: int):
    nlm, _, nelem, np2, _ = teiJ.shape
    return (teiJ.reshape(nlm, 4, nelem, nprim, nprim, nprim, nprim)
            .transpose(0, 1, 2, 4, 5, 3, 6)
            .reshape(nlm, 4, nelem, np2, np2))


def tei_from_J3(teiJ3: jnp.ndarray, nprim: int):
    """Reconstruct the full 4-family teiJ [(0,0),(0,2),(2,0),(2,2)] and the
    K pair layout from the reduced 3-family J table ON DEVICE (see
    compute_tei k_layout=False): family (2,0) is the per-block transpose of
    (0,2) (the (ij)<->(kl) swap exchanges the cosh-power slots), and
    teiK[jk, il] is the fixed (i,j,k,l) -> (j,k,i,l) index permutation of
    teiJ[ij, kl] (reference builds the exchange-ordered copies on host:
    utils::exchange_tei, libhelfem/src/utils.cpp).

    TWO dispatches, not one: with a single fused program the reduced
    3-family input stays live while BOTH outputs materialize (11/8 of a
    full table transiently -- buffer donation cannot help, no output
    matches the input layout). Building
    teiJ first, dropping the input, then deriving teiK bounds the peak at
    8/8, the same as shipping both tables from the host did."""
    teiJ = _tei_J_from_J3(teiJ3)
    del teiJ3
    teiK = _tei_K_from_J(teiJ, nprim)
    return teiJ, teiK


def _to4(P, nang, nrad):
    return P.reshape(nang, nrad, nang, nrad).transpose(0, 2, 1, 3)


def _from4(P4, nang, nrad):
    return P4.transpose(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)


def coulomb_dia(ops: DiatomicOperators, P: jnp.ndarray,
                njbd: int | None = None) -> jnp.ndarray:
    """J(P): scan over CHUNKS of the signed (L,M) channels; per channel
    prefix sums over elements (reference: src/diatomic/basis.cpp:1359-1531).
    All per-channel work is batched einsums over the chunk (the dominant
    per-channel cost is the in-element TEI contraction and the two
    assembler matmul pairs); a device-memory budget (HELFEM_EXCHANGE_HBM)
    bounds the batched TEI gather [S, nelem, np^4].

    njbd (static; = basis.njbd): restrict the scan to the leading M = 0
    channels. EXACT for any symmetry-block-diagonal density (m_a = m_b
    everywhere P is nonzero -- true by construction for every density the
    blocked-eigensolve drivers produce): GmLM/GpLM carry the hard
    selection m_a - m_b = M, so all the skipped channels project P to
    exactly zero. Dense/probe callers leave njbd=None and scan all
    channels."""
    import os as _os

    GmLM = ops.GmLM if njbd is None else ops.GmLM[:njbd]
    GpLM = ops.GpLM if njbd is None else ops.GpLM[:njbd]
    LM_ilm = ops.LM_ilm if njbd is None else ops.LM_ilm[:njbd]
    nang = ops.GmLM.shape[-1]
    nrad = ops.shellmask.shape[-1]
    nelem, nprim = ops.gidx.shape
    gi = ops.gidx
    P4 = _to4(P, nang, nrad)
    Paux0 = jnp.einsum("sab,abIJ->sIJ", GmLM, P4)
    Paux2 = jnp.einsum("sab,abIJ->sIJ", GpLM, P4)
    Paux0 = jnp.pad(Paux0, ((0, 0), (0, 1), (0, 1)))
    Paux2 = jnp.pad(Paux2, ((0, 0), (0, 1), (0, 1)))

    from helfem_tpu.models.atomic import _assembler

    A = _assembler(gi, nrad)

    nLM = int(GmLM.shape[0])
    # per-channel working set at 8 B per f64 element and two live copies
    # (the compiled step's temp bytes grow by 1.7 copies per added channel
    # at the reference-converged N2 lmax=12 on an H100)
    per_s = 8.0 * 2 * (4.0 * nelem * nprim**4 + 4.0 * nang * (nrad + 1) ** 2)
    budget = float(_os.environ.get("HELFEM_EXCHANGE_HBM", 4e9))
    # J has its own step cap: it was silently riding HELFEM_EXCHANGE_STEPS
    # (with a different default), so tuning the exchange retuned J too
    cap = int(_os.environ.get("HELFEM_COULOMB_STEPS", 32))
    gs = max(1, min(nLM, cap, int(budget // max(per_s, 1.0))))
    npad = (-nLM) % gs
    padc = lambda x: jnp.pad(x, [(0, npad)] + [(0, 0)] * (x.ndim - 1))
    # padded channels: GmLM/GpLM rows are zero => Paux = 0 => contribute 0
    xs = tuple(
        padc(x).reshape((nLM + npad) // gs, gs, *x.shape[1:])
        for x in (Paux0, Paux2, LM_ilm, GmLM, GpLM)
    )

    def body(J4, xs_):
        Pa0, Pa2, ilm, Gm_s, Gp_s = xs_  # leading axis: chunk of channels
        fac = ops.LMfac[ilm]
        tJ = ops.teiJ[ilm]  # [s, 4, e, np^2(ij), np^2(kl)]
        p0, p2 = ops.dP0[ilm], ops.dP2[ilm]
        q0, q2 = ops.dQ0[ilm], ops.dQ2[ilm]
        # element-window gathers via the assembly matmul pair
        Pg0 = jnp.einsum("seim,ejm->seij", jnp.einsum("ein,snm->seim", A, Pa0), A)
        Pg2 = jnp.einsum("seim,ejm->seij", jnp.einsum("ein,snm->seim", A, Pa2), A)
        # disjoint traces
        ts = jnp.einsum("seij,seij->se", p0, Pg0) - jnp.einsum("seij,seij->se", p2, Pg2)
        tb = jnp.einsum("seij,seij->se", q0, Pg0) - jnp.einsum("seij,seij->se", q2, Pg2)
        sA = jnp.cumsum(ts, axis=1) - ts  # sum over jel < e
        sB = jnp.cumsum(tb[:, ::-1], axis=1)[:, ::-1] - tb  # jel > e
        J0 = p0 * sB[..., None, None] + q0 * sA[..., None, None]
        J2 = -p2 * sB[..., None, None] - q2 * sA[..., None, None]
        # in-element: one batched matmul over the family axis in the (ij),
        # (kl) pair layout; signs fold into the stacked density windows
        s_, e_ = Pg0.shape[0], Pg0.shape[1]
        Pg0v = Pg0.reshape(s_, e_, -1)
        Pg2v = Pg2.reshape(s_, e_, -1)
        PgF = jnp.stack([Pg0v, -Pg2v, -Pg0v, Pg2v], axis=1)  # [s, 4, e, kl]
        dJ = jnp.einsum("sFexy,sFey->sFex", tJ, PgF)
        J0 = J0 + (dJ[:, 0] + dJ[:, 1]).reshape(J0.shape)
        J2 = J2 + (dJ[:, 2] + dJ[:, 3]).reshape(J2.shape)
        # assembly scatter-add via the transposed matmul pair
        Jr0 = jnp.einsum("ein,seij,ejm->snm", A, J0, A)[:, :nrad, :nrad]
        Jr2 = jnp.einsum("ein,seij,ejm->snm", A, J2, A)[:, :nrad, :nrad]
        J4 = J4 + (
            jnp.einsum("sba,sIJ->abIJ", fac[:, None, None] * Gm_s, Jr0)
            + jnp.einsum("sba,sIJ->abIJ", fac[:, None, None] * Gp_s, Jr2)
        )
        return J4, None

    J4 = jnp.zeros((nang, nang, nrad, nrad))
    J4, _ = jax.lax.scan(body, J4, xs)
    m2 = ops.shellmask.reshape(-1)
    return _from4(J4, nang, nrad) * m2[:, None] * m2[None, :]


def exchange_dia(ops: DiatomicOperators, P: jnp.ndarray) -> jnp.ndarray:
    """K(P) for SYMMETRIC P (negative contribution): the upper cross-
    element triangle is recovered as the transpose of the lower one, which
    requires P = P.T (every SCF density is; a non-symmetric probe --
    transition density, MO intermediate -- needs K(P) + K(P.T)^T /
    symmetrization by the caller). Scan over CHUNKS of the (L,|M|)
    channels (reference: src/diatomic/basis.cpp:1532-1734). The bra-shell
    axis is DENSE inside each channel step -- a real batched matmul
    dimension -- so the sequential scan length is nlm, not nlm*nang
    (7375 -> 125 at the reference-converged N2 lmax=12). A device-memory
    budget (HELFEM_EXCHANGE_HBM, default 4 GB) sets how many channels
    batch into one step; padded channels carry weight 0 and contribute
    exactly nothing.

    DESIGN: like the atomic exchange_kernel_L, the cross-element
    triangles run in GLOBAL radial coordinates -- per (channel, element)
    right-factor matrices are prefix-summed over elements once per call
    (P-independent), and each step's four LOWER (left factor, radial
    family) combinations reduce to three stacked matmuls with
    [nelem*nprim, nrad+1]-class shapes; the four upper combinations are
    recovered as one transpose of the assembled cross matrix (valid for
    symmetric P; see the CLt/SSt construction note). The earlier form
    materialized [4, c, e, f, p, q] window tensors and contracted over
    p ~ nprim -- thousands of tiny matmuls per step."""
    import os as _os

    nang = ops.GmLM.shape[-1]
    nrad = ops.shellmask.shape[-1]
    nelem, nprim = ops.gidx.shape
    gi = ops.gidx
    P4 = _to4(P, nang, nrad)

    # one-hot FEM assembly operator: element-window gathers and the final
    # scatter-add become batched MATMULS instead of vmapped scatter-adds)
    from helfem_tpu.models.atomic import _assembler

    A = _assembler(gi, nrad)

    # P-independent per-channel element factors in global coordinates.
    # Left factors C*[t,e,i,n] = d*[t,e,i,p] A[e,p,n]; right factors
    # G*[t,f,m,m'] = d*[t,f,j,q] A[f,q,m] A[f,j,m'], prefix/suffix-summed
    # over the column element f so the cross-element triangles need no
    # [e, f] pair axis at all.
    def left(d):
        return jnp.einsum("tfip,fpn->tfin", d, A)

    def right_sums(d):
        G = jnp.einsum("tfjm,fjx->tfmx", jnp.einsum("tfjq,fqm->tfjm", d, A), A)
        low = jnp.cumsum(G, axis=1) - G                 # sum over f < e
        high = jnp.cumsum(G[:, ::-1], axis=1)[:, ::-1] - G  # sum over f > e
        return low, high

    # Only the LOWER (e > f) triangles are computed: for symmetric P the
    # per-channel R weights obey R00[c,b,J,I] = R00[b,c,I,J], R22 likewise,
    # and R02[c,b,J,I] = R20[b,c,I,J], so each upper (Cp*, SQ*hi, R) combo
    # is exactly the (b<->c, n<->m) transpose of a lower one -- the upper
    # half is added as ONE transpose of the assembled cross matrix, halving
    # the dominant Y/Z triangle tensors and their matmul work.
    Cq0, Cq2 = left(ops.dQ0), left(ops.dQ2)
    SP0lo = right_sums(ops.dP0)[0]
    SP2lo = right_sums(ops.dP2)[0]
    # pre-stacked channel tables so each step batch needs ONE gather each
    # (the scan body is many small ops; fewer gathers, fewer launches)
    CLt = jnp.stack([Cq0, Cq0, Cq2, Cq2], axis=1)  # [t, 4, e, i, n]
    SSt = jnp.stack([SP0lo, SP2lo, SP0lo, SP2lo], axis=1)  # [t, 4, e, m, x]

    nlm = int(ops.step_ilm.shape[0])
    # dominant batched intermediate PER CHANNEL (the bra axis b is dense):
    # the Y triangle tensor [4, b, c, nelem, nprim, nrad+1], plus the R
    # family and the TEI windows, at 8 B per f64 element and one live copy
    # (the compiled step's temp bytes grow by 0.5 copies per added channel
    # at the reference-converged N2 lmax=12 on an H100)
    nr1 = nrad + 1
    yel = 4.0 * nang * nang * nelem * nprim * nr1
    rel = 8.0 * nang * nang * nr1 * nr1
    per_chan = 8.0 * (yel + rel + 4.0 * nelem * nprim**4)
    budget = float(_os.environ.get("HELFEM_EXCHANGE_HBM", 4e9))
    # sequential steps vs memory: more channels per batch means fewer scan
    # steps, until the working set hits the budget
    cap = int(_os.environ.get("HELFEM_EXCHANGE_STEPS", 64))
    gs = max(1, min(nlm, cap, int(budget // max(per_chan, 1.0))))
    if _os.environ.get("HELFEM_DEBUG"):
        print(f"exchange_dia: nlm={nlm} gs={gs} per_chan={per_chan:.3e}")
    npad = (-nlm) % gs
    wv = jnp.concatenate([jnp.ones(nlm), jnp.zeros(npad)])
    stepxs = tuple(
        jnp.pad(x, (0, npad))
        for x in (ops.step_ilm, ops.step_sp, ops.step_sm, ops.step_wm)
    ) + (wv,)
    xs = tuple(x.reshape((nlm + npad) // gs, gs) for x in stepxs)

    def chan_K(ilm, sp, sm, wm, w):
        """K[b, c, nrad+1, nrad+1] contribution of ONE (L,|M|) channel,
        with the bra-shell axis b fully dense: every contraction below is
        a real batched matmul over b, not a scan axis. The
        t-axis keeps the signed sp/sm products channel-diagonal (no
        Gm[sp] x Gm[sm] cross terms)."""
        fac = ops.LMfac[ilm]
        s2 = jnp.stack([sp, sm])
        w2 = (w * fac) * jnp.stack([jnp.ones_like(wm), wm])
        Gm2 = ops.GmLM[s2]  # [2, b, a]
        Gp2 = ops.GpLM[s2]
        tm = jnp.einsum("tba,adIJ->tbdIJ", w2[:, None, None] * Gm2, P4)
        tp = jnp.einsum("tba,adIJ->tbdIJ", w2[:, None, None] * Gp2, P4)
        R00 = jnp.einsum("tcd,tbdIJ->bcIJ", Gm2, tm)
        R02 = -jnp.einsum("tcd,tbdIJ->bcIJ", Gp2, tm)
        R20 = -jnp.einsum("tcd,tbdIJ->bcIJ", Gm2, tp)
        R22 = jnp.einsum("tcd,tbdIJ->bcIJ", Gp2, tp)
        R = jnp.stack([R00, R02, R20, R22])  # [4, b, c, nrad, nrad]
        Rp = jnp.pad(R, ((0, 0), (0, 0), (0, 0), (0, 1), (0, 1)))
        # in-element: diagonal windows from global Rp via the assembly
        # matmuls, then ONE batched TEI matmul in the (jk),(il) pair layout
        Rg = jnp.einsum("Fbceim,elm->Fbceil",
                        jnp.einsum("ein,Fbcnm->Fbceim", A, Rp), A)
        Rgv = Rg.reshape(*Rg.shape[:4], -1)  # [4, b, c, e, np^2(il)]
        Kdiag = jnp.einsum("Fexy,Fbcey->bcex", ops.teiK[ilm], Rgv)
        Kdiag = Kdiag.reshape(*Kdiag.shape[:3], nprim, nprim)  # [b,c,e,j,k]
        Kd1 = jnp.einsum("bcejk,ekm->bcejm", Kdiag, A)
        # cross-element LOWER (e > f) triangles only: Q-left factors pair
        # with prefix-summed P-right factors across the 4 radial families;
        # the upper half is the (b<->c, n<->m) transpose (see CLt/SSt note)
        Y = jnp.einsum("Fein,Fbcnm->Fbceim", CLt[ilm], Rp)
        Z = jnp.einsum("Fbceim,Femx->bceix", Y, SSt[ilm])
        cross = jnp.einsum("ein,bceix->bcnx", A, Z)
        return (jnp.einsum("ein,bceim->bcnm", A, Kd1)
                + cross + jnp.transpose(cross, (1, 0, 3, 2)))

    def body(K3, xs_):
        ilm, sp, sm, wm, w = xs_
        if gs == 1:
            Kg = chan_K(ilm[0], sp[0], sm[0], wm[0], w[0])
        else:
            Kg = jax.vmap(chan_K)(ilm, sp, sm, wm, w).sum(0)
        return K3 + Kg[:, :, :nrad, :nrad], None

    K3 = jnp.zeros((nang, nang, nrad, nrad))  # [b, c, I, J]
    K3, _ = jax.lax.scan(body, K3, xs)
    m2 = ops.shellmask.reshape(-1)
    return -_from4(K3, nang, nrad) * m2[:, None] * m2[None, :]


def exchange_dia_occ(ops: DiatomicOperators, Co: jnp.ndarray,
                     sgn: jnp.ndarray | None = None) -> jnp.ndarray:
    """K(P) for P = Co @ diag(sgn) @ Co.T -- the OCCUPIED-ORBITAL
    factorized exchange (reference computes K(P) densely,
    src/diatomic/basis.cpp:1532-1734; the result is identical).

    Co [nbf, no]: sqrt(f)-weighted occupied orbital columns (zero columns
    are exact no-ops, so `no` can be a static padded width). sgn [no]
    (default +1) supports indefinite symmetric P via a signed
    eigenfactorization -- used by tests, never by SCF.

    DESIGN: K is linear in P, and P has rank ~nocc (<< nbf), so the
    per-channel R tensors factor as R_F[b,c,n,m] = sum_{t,o} cL[t,b,n,o]
    cR[t,c,m,o] with cL/cR [2, nang, nrad+1, no] built by two tiny Gaunt
    matmuls. The dense path's dominant [4,b,c,e,np,nrad+1] triangle
    tensors (~0.9 GB per channel at the reference-converged lmax=12)
    NEVER materialize: the cross-element triangles become one dense
    [(b g), (s F t e o)] x [(s F t e o), (c x)] matmul per chunk, and the
    in-element Rg window tensor runs on the b <= c shell-pair triangle only
    (Kdiag[b,c,j,k] = Kdiag[c,b,k,j] exactly; one transpose after the scan restores the full tensor --
    2x fewer FLOPs on the two dominant matmuls). Chunks of `gs` channels
    fold into the contraction axis, so the scan length drops to nlm/gs
    with NO growth in the materialized output."""
    import os as _os

    nang = ops.GmLM.shape[-1]
    nrad = ops.shellmask.shape[-1]
    nelem, nprim = ops.gidx.shape
    no = Co.shape[-1]
    from helfem_tpu.models.atomic import _assembler

    A = _assembler(ops.gidx, nrad)

    C4 = Co.reshape(nang, nrad, no)
    C4p = jnp.pad(C4, ((0, 0), (0, 1), (0, 0)))  # [a, n(nrad+1), o]
    Cs4p = C4p if sgn is None else C4p * sgn[None, None, :]

    # P-independent per-channel element factors (see exchange_dia); the
    # left factors are pre-assembled into GLOBAL row coordinates so the
    # cross term needs no separate A matmul per step
    def left(d):
        return jnp.einsum("tfip,fpn->tfin", d, A)

    def right_sums_low(d):
        G = jnp.einsum("tfjm,fjx->tfmx", jnp.einsum("tfjq,fqm->tfjm", d, A), A)
        return jnp.cumsum(G, axis=1) - G  # sum over f < e

    # The four (left table, right table, R family) lower-triangle combos
    # factor COMPLETELY: cross = (u_m - u_p)(v_0 - v_1) with u_q the
    # Cq-transform of the weighted Gaunt factors and v_q the prefix-summed
    # P-transform of the unweighted ones -- a 4x FLOP collapse of the
    # cross matmul. The LEFT factor stays in ELEMENT-LOCAL row coordinates
    # (i of width nprim) through the whole scan: its global rows are the
    # ~nprim rows of element e only, so accumulating the cross product in
    # global coordinates wastes nrad/nprim (~4.7x at the converged-N2
    # discretization, measured 16 s of a 22 s stage) on structurally-zero
    # rows; ONE one-hot assembly matmul after the scan restores global
    # rows. The right factor is prefix-summed over elements f < e and is
    # genuinely dense in its global column axis.
    CL2 = jnp.stack([left(ops.dQ0), left(ops.dQ2)], axis=1)  # [c, q, e, i, n]
    SS2T = jnp.stack([right_sums_low(ops.dP0), right_sums_low(ops.dP2)],
                     axis=1).transpose(0, 1, 2, 4, 3)  # [c, q, e, x, m]
    sgnF = jnp.asarray([[1.0, -1.0], [-1.0, 1.0]])  # R families [[00,02],[20,22]]

    # (b, c) PAIR TRIANGLE for the TEI contraction: Kdiag[b,c,e,j,k] =
    # Kdiag[c,b,e,k,j] exactly -- the verified teiK pair-layout symmetry
    # tK[q,r,(jk),(il)] = tK[r,q,(kj),(li)] composes with the rank-factor
    # relation R_qr[b,c,I,J] = R_rq[c,b,J,I] (the q<->r family swap rides
    # the b<->c transpose; holds for any sgn since the o-contraction
    # carries it symmetrically) -- so the Kd TEI matmul runs on the b <= c
    # pairs only and the full Kdiag is recovered by one transpose after
    # the scan. The Rg rank product itself runs on the FULL (b, c) grid
    # (see the chunk_factors note: a real GEMM beats the triangle's tiny
    # batched matmuls by far more than its 2x FLOPs).
    bP, cP = np.triu_indices(nang)
    pair_flat = jnp.asarray((bP * nang + cP).astype(np.int32))
    npair = int(bP.shape[0])
    bP = jnp.asarray(bP.astype(np.int32))
    cP = jnp.asarray(cP.astype(np.int32))

    nlm = int(ops.step_ilm.shape[0])
    # dominant chunk intermediates: the FULL-GRID Rg window tensor
    # [s, q, r, e, b, c, np^2] plus the AW operands, at 8 B per f64
    # element and two live copies (the compiled step's temp bytes grow by
    # 1.5 copies per added channel at the reference-converged N2 lmax=12
    # on an H100); cross-term u/v factors are O(nang * no) and negligible
    per_chan = 8.0 * 2 * (4.0 * nang * nang * nelem * nprim * nprim
                          + 4.0 * nang * nelem * nprim * no)
    budget = float(_os.environ.get("HELFEM_EXCHANGE_HBM", 4e9))
    cap = int(_os.environ.get("HELFEM_EXCHANGE_STEPS", 64))
    gs = max(1, min(nlm, cap, int(budget // max(per_chan, 1.0))))
    if _os.environ.get("HELFEM_DEBUG"):
        print(f"exchange_dia_occ: nlm={nlm} gs={gs} no={no} "
              f"per_chan={per_chan:.3e}")
    npad = (-nlm) % gs
    wv = jnp.concatenate([jnp.ones(nlm), jnp.zeros(npad)])
    stepxs = tuple(
        jnp.pad(x, (0, npad))
        for x in (ops.step_ilm, ops.step_sp, ops.step_sm, ops.step_wm)
    ) + (wv,)
    xs = tuple(x.reshape((nlm + npad) // gs, gs) for x in stepxs)

    def chunk_factors(ilm, sp, sm, wm, w):
        """One scan step: rank factors for a chunk of channels (~6 dispatch
        stages), its in-element TEI window sum, and its cross matmul. The
        chunk axis s joins the CONTRACTION dims of both outputs, so
        batching channels costs no output memory."""
        fac = ops.LMfac[ilm]  # [s]
        s2 = jnp.stack([sp, sm], axis=1)  # [s, 2]
        w2 = (w * fac)[:, None] * jnp.stack([jnp.ones_like(wm), wm], axis=1)
        Gq = jnp.stack([ops.GmLM[s2], ops.GpLM[s2]], axis=1)  # [s, q, t, x, y]
        # ONE Gaunt transform for both factor families (q = Gm/Gp)
        U = jnp.einsum("sqtba,ano->sqtbno", Gq, C4p)
        V = U if sgn is None else jnp.einsum("sqtba,ano->sqtbno", Gq, Cs4p)
        WW = jnp.stack([w2[:, None, :, None, None, None] * U, V], axis=1)
        # u: ELEMENT-LOCAL Cq transforms of the weighted factors (see the
        # CL2 note -- local rows i, assembled to global AFTER the scan);
        # v: prefix-summed P transforms of the unweighted ones
        ul = jnp.einsum("sqein,sqtbno->sqtebio", CL2[ilm], WW[:, 0])
        ud = ul[:, 0] - ul[:, 1]  # u_m - u_p  [s, t, e, b, i, o]
        vq = jnp.einsum("sqexm,sqtcmo->sqtecox", SS2T[ilm], WW[:, 1])
        vd = vq[:, 0] - vq[:, 1]  # v_0 - v_1  [s, t, e, c, o, x]
        cross = jnp.einsum("stebio,stecox->ebicx", ud, vd)
        # in-element: window factors (A shared over k, q), then the 2x2
        # rank product over the FULL (b, c) shell grid -- ONE real GEMM
        # per (s, q, r, e) with M = (b i) = nang*nprim, N = (c l),
        # K = (t o), instead of nang(nang+1)/2 tiny [2*nprim x 2*nprim x
        # 2*no] batched matmuls: the full-grid GEMM pays 1.97x the FLOPs
        # of the pair triangle at the reference-converged N2 (lmax=12,
        # nang=59) in exchange for one large matmul. The b <= c
        # triangle is then GATHERED (one take along the flattened (b, c)
        # axis) so the downstream TEI matmul keeps its halved cost.
        AW = jnp.einsum("ein,skqtbno->skqtebio", A, WW)
        Rgf = jnp.einsum("sqtebio,srteclo->sqrebcil", AW[:, 0], AW[:, 1])
        Rgp = Rgf.reshape(*Rgf.shape[:4], nang * nang, nprim * nprim)
        Rgv = jnp.take(Rgp, pair_flat, axis=4)  # [s, q, r, e, P, np^2(il)]
        tK = ops.teiK[ilm].reshape(-1, 2, 2, *ops.teiK.shape[2:])
        tK = tK * sgnF[None, :, :, None, None, None]
        Kd = jnp.einsum("sqrexy,sqrePy->Pex", tK, Rgv)
        return Kd, cross

    def body(carry, xs_):
        Kd_acc, cross_acc = carry
        Kd, cross = chunk_factors(*xs_)
        return (Kd_acc + Kd, cross_acc + cross), None

    nr1 = nrad + 1
    carry0 = (jnp.zeros((npair, nelem, nprim * nprim)),
              jnp.zeros((nelem, nang, nprim, nang, nr1)))
    (Kd_acc, cross_loc), _ = jax.lax.scan(body, carry0, xs)
    # left-local cross rows -> global coordinates (one one-hot matmul)
    cross_acc = jnp.einsum("eiu,ebicx->bucx", A, cross_loc)
    # unpack the pair triangle: scatter b <= c pairs, then add the exact
    # (b<->c, j<->k) transpose; diagonal pairs are halved so the transpose
    # restores them exactly (Kdiag[b,b,j,k] = Kdiag[b,b,k,j])
    wpair = jnp.where(bP == cP, 0.5, 1.0)
    Kd_w = Kd_acc * wpair[:, None, None]
    Kdiag = jnp.zeros((nang, nang, nelem, nprim * nprim)).at[bP, cP].set(Kd_w)
    Kdiag = Kdiag.reshape(nang, nang, nelem, nprim, nprim)
    Kdiag = Kdiag + jnp.transpose(Kdiag, (1, 0, 2, 4, 3))
    # in-element: TEI-contracted windows assembled to global coordinates
    Kd1 = jnp.einsum("bcejk,ekm->bcejm", Kdiag, A)
    Kin = jnp.einsum("ein,bceim->bcnm", A, Kd1)
    # cross-element lower triangles; the upper half is the (b<->c, g<->x)
    # transpose of the accumulated cross matrix
    cr = cross_acc.transpose(0, 2, 1, 3)  # [b, c, g, x]
    K3 = (Kin + cr + cr.transpose(1, 0, 3, 2))[:, :, :nrad, :nrad]
    m2 = ops.shellmask.reshape(-1)
    return -_from4(K3, nang, nrad) * m2[:, None] * m2[None, :]
