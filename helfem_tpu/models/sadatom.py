"""Spherically-averaged atom solver (sadatom / gensap, stage 7).

Redesign of src/sadatom/{basis,solver}.cpp: orbitals live in per-l radial
channels with integer shell occupations (fractional filling of degenerate
shells via capacity weighting); the density is spherically averaged, so

  * Coulomb is pure L=0 (reuses the atomic coulomb path with a trivial
    angular shell),
  * exact exchange is l-resolved with m-averaged angular weights
    totcoup(L; lout, lin) = sum_{mo,mi} G(lo mo; L M; li mi)^2 / (2 lout + 1)
    (reference: sadatom TwoDBasis::exchange, src/sadatom/basis.cpp:360-460),
  * XC lives on a radial-only grid.

The per-l channel axis is a batch axis: Fock cubes [nl, nrad, nrad], one
vmapped whitened eigh across all channels (replacing the reference's
l-supermatrix LAPACK solve, src/sadatom/solver.cpp:1132-1200).
"""

from dataclasses import dataclass, field
from typing import NamedTuple

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from helfem_tpu.models.atomic import AtomicOperators, coulomb, exchange_kernel_L
from helfem_tpu.ops.fem import FEMBasis
from helfem_tpu.ops.gaunt import gaunt_coefficient
from helfem_tpu.ops.grids import get_grid
from helfem_tpu.ops.polynomials import get_basis
from helfem_tpu.ops.radial import RadialBasis
from helfem_tpu.ops.xc import parse_method, xc_eval
from helfem_tpu.scf.guess import potential
from helfem_tpu.utils.linalg import eigh_refined, form_sinvh

__all__ = ["SadAtomBasis", "SadOps", "solve_sadatom", "totcoup_table"]


def totcoup_table(lmax: int) -> np.ndarray:
    """m-averaged squared Gaunt couplings [NL, nl, nl] with NL = 2*lmax+1."""
    NL = 2 * lmax + 1
    t = np.zeros((NL, lmax + 1, lmax + 1))
    for lo in range(lmax + 1):
        for li in range(lmax + 1):
            for mo in range(-lo, lo + 1):
                for mi in range(-li, li + 1):
                    M = mo - mi
                    for L in range(abs(lo - li), lo + li + 1):
                        c = gaunt_coefficient(lo, mo, L, M, li, mi)
                        t[L, lo, li] += c * c
            t[:, lo, li] /= 2 * lo + 1
    return t


class SadOps(NamedTuple):
    at: AtomicOperators  # nang=1 operators (radial S/T/Vnuc, TEI tensors)
    Tl: jnp.ndarray  # [nrad, nrad] 1/2 <BB/r^2>
    totcoup: jnp.ndarray  # [NL, nl, nl]
    # radial XC grid
    bg: jnp.ndarray
    dbg: jnp.ndarray
    r: jnp.ndarray
    w2: jnp.ndarray  # wr * 4 pi r^2


@dataclass
class SadAtomBasis:
    Z: int
    lmax: int = 3
    rmax: float = 40.0
    nelem: int = 10
    nnodes: int = 15
    nquad: int = 0
    igrid: int = 4
    zexp: float = 2.0
    primbas: int = 4
    # finite-nucleus model + optional sub-grid (reference: gensap --finitenuc
    # --Rrms --nelem0 --grid0 --zexp0, src/sadatom/main.cpp:104-110)
    finitenuc: str = "point"
    Rrms: float = 0.0
    nelem0: int = 0
    igrid0: int = 2
    zexp0: float = 2.0
    # confinement potential (gensap --iconf family, main.cpp:138-143)
    iconf: int = 0
    conf_N: int = 0
    conf_R: float = 0.0
    conf_barrier: float = 0.0
    shift_conf: float = 0.0
    conf_boundary: float = 0.0  # insert an element boundary here if > 0
    # drop the derivative DOF at Rmax too (Hermite bases; reference
    # gensap --zeroder, src/sadatom/main.cpp:132)
    zeroder: bool = False

    rb: RadialBasis = field(init=False)

    def __post_init__(self):
        from helfem_tpu.ops.grids import form_grid

        poly = get_basis(self.primbas, self.nnodes)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        bval = form_grid(
            self.finitenuc, self.Rrms, self.nelem, self.rmax, self.igrid,
            self.zexp, self.nelem0, self.igrid0, self.zexp0, self.Z,
            0, 0, 0.0, self.conf_boundary,
        )
        self.rb = RadialBasis(
            FEMBasis(poly, bval, drop_last_deriv=self.zeroder), self.nquad
        )
        self.Vconf = None  # set by build_ops when iconf != 0

    @property
    def nrad(self) -> int:
        return self.rb.fem.nbf

    @property
    def NL(self) -> int:
        return 2 * self.lmax + 1

    def build_ops(self) -> SadOps:
        rb = self.rb
        NL = self.NL
        tei = rb.twoe_integral(NL - 1)
        disjL, disjm1L = rb.disjoint_integrals(NL - 1)
        G = np.zeros((NL, 1, 1, 1))
        G[0, 0, 0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
        T = rb.kinetic()
        if self.finitenuc == "point":
            Vnuc = self.Z * rb.nuclear()
        else:
            from helfem_tpu.models.atomic import nuclear_model_V

            Vnuc = rb.model_potential(
                nuclear_model_V(self.finitenuc, self.Z, self.Rrms)(rb.r)
            )
        if self.iconf:
            from helfem_tpu.models.atomic import confinement_Vr

            N = self.conf_N if self.iconf != 3 else self.conf_barrier
            self.Vconf = rb.model_potential(
                confinement_Vr(rb.r, self.rmax, N, self.conf_R, self.iconf,
                               self.shift_conf)
            )
            # folded into the nuclear slot: the Fock build and total energy
            # pick it up; the CLI separates Econf = <P, Vconf> for printing
            Vnuc = Vnuc + self.Vconf
        else:
            self.Vconf = None
        at = AtomicOperators(
            gidx=jnp.asarray(rb.fem.gidx),
            G=jnp.asarray(G),
            Lfac=jnp.asarray(4.0 * np.pi / (2.0 * np.arange(NL) + 1.0)),
            tei=jnp.asarray(tei),
            disjL=jnp.asarray(disjL),
            disjm1L=jnp.asarray(disjm1L),
            S=jnp.asarray(rb.overlap()),
            H0=jnp.asarray(T + Vnuc),
            T=jnp.asarray(T),
            Vnuc=jnp.asarray(Vnuc),
            Sinvh_rad=jnp.asarray(form_sinvh(rb.overlap())),
        )
        return SadOps(
            at=at,
            Tl=jnp.asarray(rb.kinetic_l()),
            totcoup=jnp.asarray(totcoup_table(self.lmax)),
            bg=jnp.asarray(rb.b),
            dbg=jnp.asarray(rb.db),
            r=jnp.asarray(rb.r),
            w2=jnp.asarray(rb.wr * 4.0 * np.pi * rb.r**2),
        )


# ----------------------------------------------------------------------------
# jitted physics
# ----------------------------------------------------------------------------


def sad_exchange(ops: SadOps, Pang: jnp.ndarray) -> jnp.ndarray:
    """l-resolved exchange cube K[nl, nrad, nrad] (negative contribution)
    from the m-averaged angular density cube Pang[nl, nrad, nrad]."""
    nrad = ops.at.Sinvh_rad.shape[0]

    def body(K, xs):
        teiL, UL, VL, tcL, LfacL = xs
        R = LfacL * jnp.einsum("ok,kIJ->oIJ", tcL, Pang)
        K = K + exchange_kernel_L(teiL, UL, VL, ops.at.gidx, nrad, R)
        return K, None

    nl = ops.totcoup.shape[1]
    K = jnp.zeros((nl, nrad + 1, nrad + 1))
    K, _ = jax.lax.scan(
        body,
        K,
        (ops.at.tei, ops.at.disjL, ops.at.disjm1L, ops.totcoup, ops.at.Lfac),
    )
    return -K[:, :nrad, :nrad]


def sad_xc(funcs, ops: SadOps, Pla, Plb, thr: float = 1e-12):
    """Radial XC: returns (Fxc_a, Fxc_b, Exc, Nel); the Fock contribution is
    a single radial matrix for LDA/GGA and an [nl, nrad, nrad] cube for
    meta-GGAs (the vtau term carries the l(l+1) centrifugal piece).

    Density n_s(r) = sum_l P^s_l[I,J] b_I b_J / (4 pi)."""
    gi = ops.at.gidx
    nrad = ops.at.Sinvh_rad.shape[0]
    nl = ops.totcoup.shape[1]
    mgga = any(f.family == "mgga" for f in funcs)
    fourpi = 4.0 * jnp.pi

    def fields(Pl):
        Pr = jnp.sum(Pl, axis=0)
        Pp = jnp.pad(Pr, ((0, 1), (0, 1)))
        Pg = Pp[gi[:, :, None], gi[:, None, :]]
        n = jnp.einsum("eij,eqi,eqj->eq", Pg, ops.bg, ops.bg) / fourpi
        dn = 2.0 * jnp.einsum("eij,eqi,eqj->eq", Pg, ops.dbg, ops.bg) / fourpi
        tau = None
        if mgga:
            Plp = jnp.pad(Pl, ((0, 0), (0, 1), (0, 1)))
            Plg = Plp[:, gi[:, :, None], gi[:, None, :]]
            ll1 = (jnp.arange(nl) * (jnp.arange(nl) + 1.0))[:, None, None, None]
            tau = 0.5 * (
                jnp.einsum("leij,eqi,eqj->eq", Plg, ops.dbg, ops.dbg)
                + jnp.einsum(
                    "leij,leqi,eqj->eq", Plg, ll1 * ops.bg[None] / ops.r[None, :, :, None] ** 2, ops.bg
                )
            ) / fourpi
        return n, dn, tau

    na, dna, ta = fields(Pla)
    nb, dnb, tb = fields(Plb)
    out = xc_eval(funcs, na, nb, dna * dna, dna * dnb, dnb * dnb, thr, ta=ta, tb=tb)
    if mgga:
        e, vra, vrb, vsaa, vsab, vsbb, vta, vtb = out
    else:
        e, vra, vrb, vsaa, vsab, vsbb = out
        vta = vtb = None
    Exc = jnp.sum(ops.w2 * e)
    Nel = jnp.sum(ops.w2 * (na + nb))

    gga = any(f.family != "lda" for f in funcs)

    def fock(vr, gr, vt):
        w = ops.w2 / fourpi
        Fel = jnp.einsum("eq,eqi,eqj->eij", w * vr, ops.bg, ops.bg)
        if gga:
            rad = jnp.einsum("eq,eqi,eqj->eij", w * gr, ops.dbg, ops.bg)
            Fel = Fel + rad + jnp.swapaxes(rad, 1, 2)
        F = jnp.zeros((nrad + 1, nrad + 1))
        F = F.at[gi[:, :, None], gi[:, None, :]].add(Fel)
        F = F[:nrad, :nrad]
        if vt is None:
            return F
        # per-l vtau terms
        Fl1 = jnp.einsum("eq,eqi,eqj->eij", 0.5 * w * vt, ops.dbg, ops.dbg)
        Fl2 = jnp.einsum("eq,eqi,eqj->eij", 0.5 * w * vt / ops.r**2, ops.bg, ops.bg)
        F1 = jnp.zeros((nrad + 1, nrad + 1)).at[gi[:, :, None], gi[:, None, :]].add(Fl1)[:nrad, :nrad]
        F2 = jnp.zeros((nrad + 1, nrad + 1)).at[gi[:, :, None], gi[:, None, :]].add(Fl2)[:nrad, :nrad]
        ll1 = (jnp.arange(nl) * (jnp.arange(nl) + 1.0))[:, None, None]
        return F[None] + F1[None] + ll1 * F2[None]

    Fa = fock(vra, 2.0 * vsaa * dna + vsab * dnb, vta)
    Fb = fock(vrb, 2.0 * vsbb * dnb + vsab * dna, vtb)
    return Fa, Fb, Exc, Nel


# ----------------------------------------------------------------------------
# occupations and solver (host logic + jitted Fock/eig)
# ----------------------------------------------------------------------------


# one shared definition of the shell-filling rules (sadconf also runs the
# configuration searches with them; keeping a second copy here risked the
# two silently diverging)
from helfem_tpu.models.sadconf import (  # noqa: E402
    aufbau_from_energies as aufbau_occs,
    shell_capacity,
)


def density_cubes(C: np.ndarray, occs: np.ndarray, restricted: bool):
    """(Pl, Pang): integer-occupation and capacity-averaged density cubes
    from orbitals C[nl, nrad, nmo] and per-l electron counts occs[nl]."""
    nl, nrad, _ = C.shape
    Pl = np.zeros((nl, nrad, nrad))
    Pang = np.zeros((nl, nrad, nrad))
    for l in range(nl):
        cap = shell_capacity(l, restricted)
        left = int(occs[l])
        io = 0
        while left > 0:
            nocc = min(cap, left)
            c = C[l][:, io]
            Pl[l] += nocc * np.outer(c, c)
            Pang[l] += (nocc / cap) * np.outer(c, c)
            left -= nocc
            io += 1
    return Pl, Pang


def occ_weight_vectors(occs: np.ndarray, nl: int, nmo: int, restricted: bool):
    """(occw, angw)[nl, nmo]: per-orbital electron counts and
    capacity-averaged angular weights for fixed per-l electron counts --
    the static-occupation form of density_cubes, so the density build can
    run on device as one einsum."""
    occw = np.zeros((nl, nmo))
    angw = np.zeros((nl, nmo))
    for l in range(nl):
        cap = shell_capacity(l, restricted)
        left = int(occs[l])
        io = 0
        while left > 0:
            nocc = min(cap, left)
            occw[l, io] = nocc
            angw[l, io] = nocc / cap
            left -= nocc
            io += 1
    return occw, angw


@lru_cache(maxsize=None)
def make_sad_fused_chunk(funcs, kfrac, nl, nrad, nhist, nsteps,
                         dftthr=1e-12, restricted=True, shift=1.0):
    """`nsteps` fully on-device sadatom SCF iterations in ONE jitted
    lax.scan (density -> Fock -> device C2-DIIS -> level-shifted channel
    eigh), the sadatom analogue of the atomic fused chunk. The level shift
    switches off on-device once the DIIS error drops below 1e-3
    (reference: solver.cpp:1190-1193), so the whole solve stays fused.
    Occupations are FIXED within a chunk (per-configuration solves have
    static occupations; unrestricted aufbau refreshes between chunks)."""
    from helfem_tpu.scf.diis import device_diis_step

    fock = make_sad_fock(funcs, kfrac, nl, nrad, dftthr)

    @jax.jit
    def chunk(ops, occw, angw, occwb, angwb, C, Cb, Vw, Vwb,
              histF, histE, count, wgate):
        S = ops.at.S
        Sinvh = ops.at.Sinvh_rad

        def dens(C_, w):
            return jnp.einsum("lpk,lk,lqk->lpq", C_, w, C_)

        def errof(F, P):
            FPS = jnp.einsum("lpq,lqr,rs->lps", F, P, S)
            comm = FPS - jnp.swapaxes(FPS, 1, 2)
            return jnp.einsum("pi,lpq,qj->lij", Sinvh, comm, Sinvh).reshape(-1)

        def eig_sh(F, Cprev, w, shift_eff, Vprev):
            # level shift on the span of the previous virtuals
            # (reference: OrbitalChannel::UpdateOrbitalsShifted); the
            # eigensolve warm-starts from the previous step's whitened
            # eigenvectors (utils/linalg.py:eigh_warm) -- the shift
            # toggling at err=1e-3 just fails the certificate once
            virt = (w <= 0.0).astype(F.dtype)
            Cv = Cprev * virt[:, None, :]
            SC = jnp.einsum("pq,lqk->lpk", S, Cv)
            Fsh = F + shift_eff * jnp.einsum("lpk,lrk->lpr", SC, SC)
            Forth = jnp.einsum("pi,lpq,qj->lij", Sinvh, Fsh, Sinvh)
            from helfem_tpu.utils.linalg import eigh_warm

            E, V, _ = eigh_warm(Forth, Vprev, gate=wgate)
            return E, jnp.einsum("pi,lij->lpj", Sinvh, V), V

        def body(carry, _):
            C, Cb, Vw, Vwb, histF, histE, count = carry
            if restricted:
                Pl = dens(C, occw)
                Pang = dens(C, angw)
                Fla, Flb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(
                    ops, Pl / 2.0, Pl / 2.0, Pang, Pang
                )
                err = errof(Fla, Pl / 2.0)
                F = Fla
            else:
                Pla, Plb = dens(C, occw), dens(Cb, occwb)
                Panga, Pangb = dens(C, angw), dens(Cb, angwb)
                Fla, Flb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(
                    ops, Pla, Plb, Panga, Pangb
                )
                err = jnp.concatenate([errof(Fla, Pla), errof(Flb, Plb)])
                F = jnp.stack([Fla, Flb])
            Etot = Ekin + Enuc + Ecoul + Exx + Exc
            errmax = jnp.max(jnp.abs(err))
            Fuse, histF, histE, count = device_diis_step(histF, histE, count, F, err)
            shift_eff = jnp.where(errmax > 1e-3, shift, 0.0)
            if restricted:
                E, Cn, Vn = eig_sh(Fuse, C, occw, shift_eff, Vw)
                Eb, Cnb, Vnb = E, Cn, Vn
            else:
                E, Cn, Vn = eig_sh(Fuse[0], C, occw, shift_eff, Vw)
                Eb, Cnb, Vnb = eig_sh(Fuse[1], Cb, occwb, shift_eff, Vwb)
            return (Cn, Cnb, Vn, Vnb, histF, histE, count), (
                E, Eb, Cn, Cnb, Etot, errmax, (Ekin, Ecoul, Exx, Exc, Nel)
            )

        (C, Cb, Vw, Vwb, histF, histE, count), (Es, Ebs, Cs, Cbs, Etots, errs, comps) = jax.lax.scan(
            body, (C, Cb, Vw, Vwb, histF, histE, count), None, length=nsteps
        )
        return Es, Ebs, Cs, Cbs, Vw, Vwb, Etots, errs, comps, histF, histE, count

    return chunk


@lru_cache(maxsize=None)
def make_sad_fock(funcs, kfrac, nl, nrad, dftthr=1e-12):
    @jax.jit
    def fock(ops: SadOps, Pla, Plb, Panga, Pangb):
        Pl = Pla + Plb
        Pr = jnp.sum(Pl, axis=0)
        J = coulomb(ops.at, Pr)
        ll1 = jnp.arange(nl) * (jnp.arange(nl) + 1.0)
        kc = ll1[:, None, None] * ops.Tl[None]
        Fl = (ops.at.H0 + J)[None] + kc
        Fla, Flb = Fl, Fl
        Exx = 0.0
        if kfrac != 0.0:
            Ka = kfrac * sad_exchange(ops, Panga)
            Kb = kfrac * sad_exchange(ops, Pangb)
            Fla = Fla + Ka
            Flb = Flb + Kb
            Exx = 0.5 * (jnp.vdot(Pla, Ka) + jnp.vdot(Plb, Kb))
        Exc = 0.0
        Nel = 0.0
        if funcs:
            XCa, XCb, Exc, Nel = sad_xc(funcs, ops, Pla, Plb, dftthr)
            if XCa.ndim == 2:
                XCa, XCb = XCa[None], XCb[None]
            Fla = Fla + XCa
            Flb = Flb + XCb
        Ekin = jnp.vdot(Pr, ops.at.T) + jnp.vdot(Pl, kc)
        Enuc = jnp.vdot(Pr, ops.at.Vnuc)
        Ecoul = 0.5 * jnp.vdot(Pr, J)
        return Fla, Flb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


@jax.jit
def eig_channels(Fl: jnp.ndarray, Sinvh: jnp.ndarray):
    Forth = jnp.einsum("pi,lpq,qj->lij", Sinvh, Fl, Sinvh)
    E, V = eigh_refined(Forth)
    C = jnp.einsum("pi,lij->lpj", Sinvh, V)
    return E, C


def eig_channels_shifted(Fl, C_prev, occs, restricted, S, Sinvh, shift):
    """Level-shifted channel eigensolve: virtual orbitals of each l channel
    are pushed up by `shift` via S Cv Cv^T S before diagonalizing
    (reference: OrbitalChannel::UpdateOrbitalsShifted, solver.cpp:351-380)."""
    Fl = np.array(Fl, copy=True)
    C_prev = np.asarray(C_prev)
    nl = Fl.shape[0]
    for l in range(nl):
        cap = shell_capacity(l, restricted)
        nsh = int(np.ceil(occs[l] / cap)) if occs[l] > 0 else 0
        if nsh:
            Cv = C_prev[l][:, nsh:]
            Fl[l] += shift * (S @ Cv) @ (Cv.T @ S)
    return eig_channels(jnp.asarray(Fl), Sinvh)


@dataclass
class SadResult:
    converged: bool
    E: float
    occs: np.ndarray
    occs_b: np.ndarray | None
    Ekin: float
    Ecoul: float
    Exx: float
    Exc: float
    orbE: np.ndarray  # [nl, nmo]
    orbs: np.ndarray
    Pl: np.ndarray
    Plb: np.ndarray | None = None
    orbE_b: np.ndarray | None = None
    orbs_b: np.ndarray | None = None
    # energy-ordered configuration list from the ground-state search:
    # [(occs_key, E, converged)] where occs_key is the per-l electron-count
    # tuple (restricted) or an (occa, occb) tuple pair (unrestricted)
    conf_list: list | None = None


# ----------------------------------------------------------------------------
# densities / potentials on the radial grid (gensap outputs)
# ----------------------------------------------------------------------------


def radial_density(basis: SadAtomBasis, Prad: np.ndarray):
    """(r, n, dn/dr, lapl n, weights) flattened over the element grid;
    n(r) = P_IJ b_I b_J / (4 pi) (reference: sadatom electron_density)."""
    rb = basis.rb
    gi = rb.fem.gidx
    Pp = np.zeros((basis.nrad + 1, basis.nrad + 1))
    Pp[: basis.nrad, : basis.nrad] = Prad
    Pg = Pp[gi[:, :, None], gi[:, None, :]]
    fourpi = 4.0 * np.pi
    n = np.einsum("eij,eqi,eqj->eq", Pg, rb.b, rb.b) / fourpi
    dn = 2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.b) / fourpi
    ln = (
        2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.d2b, rb.b)
        + 2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.db)
        + 4.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.b) / rb.r
    ) / fourpi
    return rb.r.ravel(), n.ravel(), dn.ravel(), ln.ravel(), (rb.wr * fourpi * rb.r**2).ravel()


def occupied_orbital_table(basis: SadAtomBasis, occs: np.ndarray,
                           orbE: np.ndarray, orbs,
                           restricted: bool = True) -> list[dict]:
    """Per-occupied-shell analysis rows (reference: OrbitalChannel::Print,
    src/sadatom/solver.cpp:152-186, with the <r^i> operator set of
    TwoDBasis::Rmatrices, basis.cpp:1274-1282): for each occupied shell,
    (n, l, nocc, E, <r^i>^(1/i) for i in -2,-1,1,2,3, and the radius of
    the maximum of the r^2-weighted orbital density,
    electron_density_maximum_radius with rsqweight=true)."""
    powers = (-2, -1, 1, 2, 3)
    R = {i: basis.rb.radial_integral(i) for i in powers}
    rb = basis.rb
    gi = rb.fem.gidx
    rows = []
    for l in range(basis.lmax + 1):
        left = int(occs[l])
        # shell capacity: 2(2l+1) electrons restricted, 2l+1 per spin channel
        cap = (2 if restricted else 1) * (2 * l + 1)
        k = 0
        while left > 0:
            nocc = min(left, cap)
            left -= nocc
            c = np.asarray(orbs[l])[:, k]
            cp = np.append(c, 0.0)[gi]  # [nelem, nprim], trash slot dropped
            mom = {i: float(c @ R[i] @ c) ** (1.0 / i) for i in powers}
            # coarse max of r^2 |u(r)|^2 on the quadrature grid ...
            u = np.einsum("eqi,ei->eq", rb.b, cp)
            rfd = (rb.r * u) ** 2
            e0, q0 = np.unravel_index(np.argmax(rfd), rfd.shape)
            # ... then zoomed refinement within the winning element
            lo = rb.xq[q0 - 1] if q0 > 0 else -1.0
            hi = rb.xq[q0 + 1] if q0 + 1 < len(rb.xq) else 1.0
            for _ in range(4):
                xs = np.linspace(lo, hi, 65)
                Bf = basis.rb.fem.eval_dnf(xs, 0)[0][e0]  # [nxs, nprim]
                rs = basis.rb.fem.coords(xs)[e0]
                us = Bf @ cp[e0]  # u*r = B c
                j = int(np.argmax(us**2))  # (r u)^2 = (B c)^2
                lo = xs[max(j - 1, 0)]
                hi = xs[min(j + 1, len(xs) - 1)]
            rmax = float(rs[j])
            rows.append({
                "n": k + l + 1, "l": l, "nocc": nocc,
                "E": float(np.asarray(orbE)[l][k]),
                "moments": mom, "rmax": rmax,
            })
            k += 1
    return rows


def xc_ingredients(basis: SadAtomBasis, Pla: np.ndarray, Plb: np.ndarray | None = None):
    """XC-ingredient table on the radial grid: columns [r, rho_a, rho_b,
    sigma_aa, sigma_ab, sigma_bb, lapl_a, lapl_b, tau_a, tau_b]
    (reference: SCFSolver::XCIngredients -> DFTGrid::eval_ing,
    src/sadatom/solver.cpp:1585-1597, dftgrid.cpp:1099-1135; gensap
    --saveing writes it as xcing.dat). Restricted input (Plb=None) splits
    the density evenly over the spins like the reference's P/2 call."""
    if Plb is None:
        Pla = Pla / 2.0
        Plb = Pla
    r, na, dna, lna, _ = radial_density(basis, Pla.sum(axis=0))
    _, nb, dnb, lnb, _ = radial_density(basis, Plb.sum(axis=0))
    ta = kinetic_energy_density(basis, Pla)
    tb = kinetic_energy_density(basis, Plb)
    return np.column_stack(
        [r, na, nb, dna * dna, dna * dnb, dnb * dnb, lna, lnb, ta, tb]
    )


def kinetic_energy_density(basis: SadAtomBasis, Pl: np.ndarray):
    """tau(r) = 1/2 sum_l P_l[IJ] (b'_I b'_J + l(l+1) b_I b_J / r^2) / (4 pi)."""
    rb = basis.rb
    gi = rb.fem.gidx
    nl = Pl.shape[0]
    tau = np.zeros_like(rb.r)
    for l in range(nl):
        Pp = np.zeros((basis.nrad + 1, basis.nrad + 1))
        Pp[: basis.nrad, : basis.nrad] = Pl[l]
        Pg = Pp[gi[:, :, None], gi[:, None, :]]
        tau += 0.5 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.db)
        tau += 0.5 * l * (l + 1) * np.einsum("eij,eqi,eqj->eq", Pg, rb.b, rb.b) / rb.r**2
    return tau.ravel() / (4.0 * np.pi)


def coulomb_screening(basis: SadAtomBasis, Prad: np.ndarray) -> np.ndarray:
    """r * V_H(r) on the radial grid (effective electron screening charge;
    reference: sadatom TwoDBasis::coulomb_screening, basis.cpp:778-840).

    V_H(r) = (1/r) int_0^r rho_B dr' + int_r^inf rho_B / r' dr' with
    rho_B(r) = P_IJ B_I B_J (the radial charge density)."""
    rb = basis.rb
    gi = rb.fem.gidx
    nelem, nq = rb.r.shape
    Pp = np.zeros((basis.nrad + 1, basis.nrad + 1))
    Pp[: basis.nrad, : basis.nrad] = Prad
    Pg = Pp[gi[:, :, None], gi[:, None, :]]
    # per-element totals of <BB> and <BB/r>
    q0 = np.einsum("eij,eqi,eq,eqj->e", Pg, rb.B, rb.wr, rb.B)
    qm1 = np.einsum("eij,eqi,eq,eqj->e", Pg, rb.B / rb.r[:, :, None], rb.wr, rb.B)
    pre = np.concatenate([[0.0], np.cumsum(q0)[:-1]])  # charge inside element start
    suf = np.concatenate([np.cumsum(qm1[::-1])[::-1][1:], [0.0]])  # 1/r-weighted charge outside
    # in-element cumulative integrals per quadrature point (segment sums)
    V = np.zeros((nelem, nq))
    for e in range(nelem):
        rq = rb.r[e]
        lo = np.concatenate([[rb.fem.bval[e]], rq[:-1]])
        hi = rq
        mid, hlen = 0.5 * (lo + hi), 0.5 * (hi - lo)
        rp = mid[:, None] + hlen[:, None] * rb.xq[None, :]
        xpoly = (rp - rb.fem.mids[e]) / (0.5 * rb.fem.lengths[e])
        Bin = rb.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, -1)
        dens = np.einsum("ij,pqi,pqj->pq", Pg[e], Bin, Bin)
        seg0 = np.einsum("pq,q,p->p", dens, rb.wq, hlen)  # int B B over segment
        segm1 = np.einsum("pq,pq,q,p->p", dens, 1.0 / rp, rb.wq, hlen)
        cum0 = np.cumsum(seg0)  # int_lo(e)^rq
        cumm1_above = np.cumsum(segm1[::-1])[::-1] - segm1  # int_rq^hi(e)
        V[e] = (pre[e] + cum0) / rq + cumm1_above + suf[e]
    return (V * rb.r).ravel()


def _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r, thr: float = 1e-12):
    """Multiplicative xc potential per spin on the radial grid,

        v_s = dE/dn_s - div(2 v_sigma_ss grad n_s + v_sigma_st grad n_t),

    with the divergence in spherical symmetry div A = dA/dr + 2A/r and the
    radial derivative of v_sigma taken by ONE jax.jvp through the functional
    (replacing the reference's explicit libxc v2rhosigma/v2sigma2 chain rule,
    src/sadatom/basis.cpp:1289-1463). LDA functionals contribute zero
    v_sigma and fall out naturally; meta-GGAs have no multiplicative
    potential and raise (as the reference does)."""
    import jax
    import jax.numpy as jnp

    if any(f.family not in ("lda", "gga") for f in funcs):
        raise NotImplementedError("multiplicative xc potential: LDA/GGA only")
    na, nb = jnp.asarray(na), jnp.asarray(nb)
    dna, dnb = jnp.asarray(dna), jnp.asarray(dnb)
    # pure second radial derivative from the full laplacian: n'' = lapl - 2 n'/r
    d2na = jnp.asarray(lna) - 2.0 * dna / r
    d2nb = jnp.asarray(lnb) - 2.0 * dnb / r

    def pots(args):
        out = xc_eval(funcs, *args, thr=thr)
        return jnp.stack(out[1:6])  # vra, vrb, vsaa, vsab, vsbb

    prim = (na, nb, dna * dna, dna * dnb, dnb * dnb)
    tang = (dna, dnb, 2.0 * dna * d2na, d2na * dnb + dna * d2nb, 2.0 * dnb * d2nb)
    V, dV = jax.jvp(pots, (prim,), (tang,))
    vra, vrb, vsaa, vsab, vsbb = V
    _, _, dvsaa, dvsab, dvsbb = dV
    Aa = 2.0 * vsaa * dna + vsab * dnb
    Ab = 2.0 * vsbb * dnb + vsab * dna
    dAa = 2.0 * (dvsaa * dna + vsaa * d2na) + dvsab * dnb + vsab * d2nb
    dAb = 2.0 * (dvsbb * dnb + vsbb * d2nb) + dvsab * dna + vsab * d2na
    va = vra - (dAa + 2.0 * Aa / r)
    vb = vrb - (dAb + 2.0 * Ab / r)
    return np.asarray(va), np.asarray(vb)


def xc_screening(basis: SadAtomBasis, Prad: np.ndarray, funcs) -> np.ndarray:
    """r * v_xc(r) for LDA and GGA functionals (reference: sadatom
    TwoDBasis::xc_screening, src/sadatom/basis.cpp:1284-1288, incl. the
    GGA gradient-divergence correction)."""
    r, n, dn, ln, w = radial_density(basis, Prad)
    va, vb = _mult_vxc_radial(funcs, n / 2, n / 2, dn / 2, dn / 2, ln / 2, ln / 2, r)
    return r * 0.5 * (va + vb)


def xc_screening_polarized(basis: SadAtomBasis, Prad_a: np.ndarray, Prad_b: np.ndarray, funcs):
    """(r*vxc_a, r*vxc_b) for spin-polarized densities, LDA/GGA (reference:
    sadatom TwoDBasis::xc_screening(Pa,Pb,...), src/sadatom/basis.cpp:1289)."""
    r, na, dna, lna, _ = radial_density(basis, Prad_a)
    _, nb, dnb, lnb, _ = radial_density(basis, Prad_b)
    va, vb = _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r)
    return r * va, r * vb


def potential_table(
    basis: SadAtomBasis,
    Pla: np.ndarray,
    Plb: np.ndarray,
    funcs,
    mode: str = "average",
    dftthr: float = 1e-12,
):
    """9-column SAP potential table (r, rho, drho/dr, lapl rho, tau,
    r*V_H, r*v_xc, w, Z - Zeff), sorted by r. The spin-resolved xc column
    follows the reference's potential variants
    (src/sadatom/solver.cpp:1414-1571):

      average   restricted v_xc of the total density (AveragePotential)
      mean      mean of the spin-resolved potentials (UnrestrictedPotential)
      weighted  density-weighted spin average (WeightedPotential)
      highspin  restricted v_xc of 2*rho_alpha (HighSpinPotential)
      lowspin   restricted v_xc of 2*rho_beta (LowSpinPotential)
    """
    Pa, Pb = Pla.sum(axis=0), Plb.sum(axis=0)
    P = Pa + Pb
    r, na, dna, lna, wt = radial_density(basis, Pa)
    _, nb, dnb, lnb, _ = radial_density(basis, Pb)
    tau = kinetic_energy_density(basis, Pla) + kinetic_energy_density(basis, Plb)
    vcoul = coulomb_screening(basis, P)
    if mode == "average":
        vxc = xc_screening(basis, P, funcs)
    elif mode == "mean":
        va, vb = xc_screening_polarized(basis, Pa, Pb, funcs)
        vxc = 0.5 * (va + vb)
    elif mode == "weighted":
        va, vb = xc_screening_polarized(basis, Pa, Pb, funcs)
        n = na + nb
        vxc = np.where(n > dftthr, (va * na + vb * nb) / np.maximum(n, dftthr), 0.0)
    elif mode == "highspin":
        vxc = xc_screening(basis, 2.0 * Pa, funcs)
    elif mode == "lowspin":
        vxc = xc_screening(basis, 2.0 * Pb, funcs)
    else:
        raise ValueError(f"unknown potential mode {mode}")
    zeff = basis.Z - (vcoul + vxc)
    out = np.column_stack([r, na + nb, dna + dnb, lna + lnb, tau, vcoul, vxc, wt, zeff])
    return out[np.argsort(r)]


def vdw_radius(basis: SadAtomBasis, Prad: np.ndarray, threshold: float = 0.001) -> float:
    """Radius where the electron density drops to `threshold` (the van der
    Waals radius criterion; reference: sadatom TwoDBasis::vdw_radius,
    src/sadatom/basis.cpp:1043-1100). Bisection on the outermost crossing."""
    r, n, _, _, _ = radial_density(basis, Prad)
    order = np.argsort(r)
    r, n = r[order], n[order]
    above = np.nonzero(n > threshold)[0]
    if len(above) == 0:
        return 0.0
    i = above[-1]
    if i + 1 >= len(r):
        return r[-1]
    # linear interpolation in log density between the bracketing points
    r1, r2 = r[i], r[i + 1]
    n1, n2 = n[i], max(n[i + 1], 1e-300)
    t = (np.log(threshold) - np.log(n1)) / (np.log(n2) - np.log(n1))
    return float(r1 + t * (r2 - r1))


def electron_count_radius(basis: SadAtomBasis, Prad: np.ndarray, nel_inside: float) -> float:
    """Radius enclosing `nel_inside` electrons (reference:
    TwoDBasis::electron_count_radius, src/sadatom/basis.cpp:1119-1165,
    which bisects for the radius OUTSIDE of which eps electrons remain;
    callers pass nel_inside = nel_total - eps). Linear interpolation on the
    cumulative quadrature sum replaces the in-element bisection."""
    r, n, _, _, w = radial_density(basis, Prad)
    order = np.argsort(r)
    r, nw = r[order], (n * w)[order]
    cum = np.cumsum(nw)
    idx = int(np.searchsorted(cum, nel_inside))
    if idx >= len(r):
        return float(r[-1])
    if idx == 0:
        return float(r[0])
    c1, c2 = cum[idx - 1], cum[idx]
    t = (nel_inside - c1) / max(c2 - c1, 1e-300)
    return float(r[idx - 1] + t * (r[idx] - r[idx - 1]))


def xc_potential_table(basis: SadAtomBasis, Pla, Plb, funcs):
    """(r, vxc_a, vxc_b) on the radial grid for potential export (reference:
    SCFSolver::XCPotential -> xcpot.dat). LDA and GGA functionals (the
    multiplicative GGA potential via the divergence correction)."""
    r, na, dna, lna, _ = radial_density(basis, Pla.sum(axis=0))
    _, nb, dnb, lnb, _ = radial_density(basis, Plb.sum(axis=0))
    va, vb = _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r)
    order = np.argsort(r)
    return r[order], va[order], vb[order]


def sap_potential_table(Z: int, method: str = "lda_x", lmax: int = 3, **kw):
    """Generate the SAP effective-charge table for element Z by solving the
    spherically-averaged atom, regenerating the reference's tabulated
    Z_eff(r) data (src/general/sap.cpp was itself generated by gensap).

    The ground configuration comes from the Saito table
    (sadconf.get_configuration), so one fixed-occupation solve suffices —
    Cr/Cu-type 3d^n 4s^1 states included (reference:
    src/sadatom/configurations.cpp:24).

    Returns (r, Zeff) with Zeff(r) = Z - r V_H(r) - r v_xc(r)."""
    from helfem_tpu.models.sadconf import get_configuration

    conf = get_configuration(Z)
    if lmax < 3:
        if conf[lmax + 1 :].any():
            raise ValueError(f"Z={Z} ground state needs lmax >= {np.nonzero(conf)[0].max()}")
        conf = conf[: lmax + 1]
    basis = SadAtomBasis(Z=Z, lmax=lmax, **kw)
    res = solve_sadatom(basis, method=method, occs=conf)
    Prad = res.Pl.sum(axis=0)
    funcs, _ = parse_method(method)
    vcoul = coulomb_screening(basis, Prad)
    vxc = xc_screening(basis, Prad, funcs)
    r = basis.rb.r.ravel()
    Zeff = Z - (vcoul + vxc)
    order = np.argsort(r)
    return r[order], Zeff[order], res


def solve_sadatom_unrestricted(
    basis: SadAtomBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    occs_a: np.ndarray | None = None,
    occs_b: np.ndarray | None = None,
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: SadOps | None = None,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    diisthr: float | None = None,
) -> "SadResult":
    """Spin-polarized spherically-averaged SCF (reference: uconf_t path,
    src/sadatom/solver.cpp FockBuild(uconf_t)). Occupations per l channel
    and spin, capacities 2l+1 per spin. When occs_a/occs_b are given the
    configuration is FIXED (the reference's Solve(uconf_t) semantics);
    otherwise aufbau occupations are refreshed between cycles."""
    fixed = occs_a is not None and occs_b is not None
    if ops is None:
        ops = basis.build_ops()
    nl, nrad = basis.lmax + 1, basis.nrad
    funcs, kfrac = parse_method(method)
    fock = make_sad_fock(tuple(funcs), kfrac, nl, nrad, dftthr)

    Vg = jnp.asarray(basis.rb.model_potential(potential(guess, basis.Z)(basis.rb.r)))
    ll1 = np.arange(nl) * (np.arange(nl) + 1.0)
    Hg = (ops.at.T + Vg)[None] + jnp.asarray(ll1[:, None, None]) * ops.Tl[None]
    Eg, Cg = eig_channels(Hg, ops.at.Sinvh_rad)
    Ea, Ca = np.asarray(Eg), Cg
    Eb, Cb = Ea.copy(), Cg

    if occs_a is None:
        occs_a = aufbau_occs(Ea, nela, False)
    if occs_b is None:
        occs_b = aufbau_occs(Eb, nelb, False)

    from helfem_tpu.scf.diis import DIIS

    Svec = np.asarray(ops.at.S)
    Sinvh = np.asarray(ops.at.Sinvh_rad)
    diis = DIIS(Svec, Sinvh, max_hist=diisorder, diis_eps=diiseps,
                diis_thr=diisthr, adiis=False)
    Eold, Etot, converged = 0.0, 0.0, False
    Ekin = Ecoul = Exx = Exc = 0.0
    out = None
    warmup = 2
    nhist, CH = diisorder, 4
    fused = None
    hist = None
    it = 0
    while it < maxit:
        it += 1
        if it > warmup:
            # fused on-device chunks; occupations frozen per chunk and
            # (if not fixed) refreshed by aufbau between chunks
            if fused is None:
                fused = make_sad_fused_chunk(
                    tuple(funcs), kfrac, nl, nrad, nhist, CH,
                    dftthr=dftthr, restricted=False, shift=shift,
                )
                hist = (
                    jnp.zeros((nhist, 2, nl, nrad, nrad)),
                    jnp.zeros((nhist, 2 * nl * nrad * nrad)),
                    jnp.asarray(0),
                )
                # warm-eigensolve seed (identity -> first step runs the
                # full eigh); persists across chunks
                Vwa = jnp.broadcast_to(jnp.eye(nrad), (nl, nrad, nrad))
                Vwb = Vwa
                wgate = jnp.minimum(0.1 * convthr, 1e-9)
            ow_a, aw_a = occ_weight_vectors(occs_a, nl, nrad, False)
            ow_b, aw_b = occ_weight_vectors(occs_b, nl, nrad, False)
            Eas, Ebs, Cas, Cbs, Vwa, Vwb, Etots, errs, comps, hF, hE, cnt = fused(
                ops, jnp.asarray(ow_a), jnp.asarray(aw_a),
                jnp.asarray(ow_b), jnp.asarray(aw_b),
                jnp.asarray(Ca), jnp.asarray(Cb), Vwa, Vwb, *hist, wgate
            )
            hist = (hF, hE, cnt)
            Etots = np.asarray(Etots)
            errs = np.asarray(errs)
            kmax = min(CH, maxit - it + 1)
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k])
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"  it {it + k:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            it += k
            Ekin, Ecoul, Exx, Exc, _Nel = (float(x[k]) for x in comps)
            if converged or it >= maxit:
                # report orbitals CONSISTENT with Etot (the pre-eigh
                # density of step k = post-eigh orbitals of step k-1 /
                # the chunk input for k=0); see the restricted path
                if k > 0:
                    Ea, Eb = np.asarray(Eas[k - 1]), np.asarray(Ebs[k - 1])
                    Ca, Cb = Cas[k - 1], Cbs[k - 1]
                out = (Etot, Ekin, Ecoul, Exx, Exc)
                break
            Ea, Eb = np.asarray(Eas[k]), np.asarray(Ebs[k])
            Ca, Cb = Cas[k], Cbs[k]
            if not fixed:
                occs_a = aufbau_occs(Ea, nela, False)
                occs_b = aufbau_occs(Eb, nelb, False)
            continue

        Pla, Panga = density_cubes(np.asarray(Ca), occs_a, False)
        Plb, Pangb = density_cubes(np.asarray(Cb), occs_b, False)
        Fla, Flb, Ekin_, Enuc, Ecoul_, Exx_, Exc_, Nel = fock(
            ops, jnp.asarray(Pla), jnp.asarray(Plb), jnp.asarray(Panga), jnp.asarray(Pangb)
        )
        Etot = float(Ekin_ + Enuc + Ecoul_ + Exx_ + Exc_)
        Ekin, Ecoul, Exx, Exc = float(Ekin_), float(Ecoul_), float(Exx_), float(Exc_)
        dE = Etot - Eold
        Eold = Etot
        Fa, Fb = np.asarray(Fla), np.asarray(Flb)
        errv = []
        for l in range(nl):
            for F_, P_ in [(Fa[l], Pla[l]), (Fb[l], Plb[l])]:
                FPS = F_ @ P_ @ Svec
                errv.append((Sinvh.T @ (FPS - FPS.T) @ Sinvh).ravel())
        errv = np.concatenate(errv)
        err = diis.update_with_error(
            [Fa[l] for l in range(nl)] + [Fb[l] for l in range(nl)], errv
        )
        if verbose:
            print(f"  it {it:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
        if converged or it == maxit:
            out = (Etot, Ekin, Ecoul, Exx, Exc)
            break
        sols = diis.solve()
        Fa, Fb = np.stack(sols[:nl]), np.stack(sols[nl:])
        if err > 1e-3 and shift != 0.0:
            Ea_, Ca = eig_channels_shifted(Fa, Ca, occs_a, False, Svec, ops.at.Sinvh_rad, shift)
            Eb_, Cb = eig_channels_shifted(Fb, Cb, occs_b, False, Svec, ops.at.Sinvh_rad, shift)
        else:
            Ea_, Ca = eig_channels(jnp.asarray(Fa), ops.at.Sinvh_rad)
            Eb_, Cb = eig_channels(jnp.asarray(Fb), ops.at.Sinvh_rad)
        Ea, Eb = np.asarray(Ea_), np.asarray(Eb_)
        if not fixed:
            occs_a = aufbau_occs(Ea, nela, False)
            occs_b = aufbau_occs(Eb, nelb, False)

    Etot, Ekin, Ecoul, Exx, Exc = out
    # final densities from the returned orbitals (the fused path does not
    # materialize them on the host per iteration)
    Pla, _ = density_cubes(np.asarray(Ca), occs_a, False)
    Plb, _ = density_cubes(np.asarray(Cb), occs_b, False)
    return SadResult(
        converged=converged,
        E=Etot,
        occs=occs_a,
        occs_b=occs_b,
        Ekin=Ekin,
        Ecoul=Ecoul,
        Exx=Exx,
        Exc=Exc,
        orbE=Ea,
        orbs=np.asarray(Ca),
        Pl=Pla,
        Plb=Plb,
        orbE_b=Eb,
        orbs_b=np.asarray(Cb),
    )


def solve_sadatom(
    basis: SadAtomBasis,
    nel: int | None = None,
    method: str = "HF",
    occs: np.ndarray | None = None,
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: SadOps | None = None,
    search: bool = True,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    diisthr: float | None = None,
) -> SadResult:
    """Restricted spherically-averaged SCF. occs given -> one
    fixed-occupation solve; search=True -> exhaustive ground-configuration
    search (aufbau self-consistency + MoveElectrons neighbors, reference:
    sadatom/main.cpp:280-560); else aufbau self-consistency only. `shift`
    is the level shift applied until the DIIS error drops below 1e-3."""
    if nel is None:
        nel = basis.Z
    if ops is None:
        ops = basis.build_ops()
    nl, nrad = basis.lmax + 1, basis.nrad
    funcs, kfrac = parse_method(method)
    fock = make_sad_fock(tuple(funcs), kfrac, nl, nrad, dftthr)

    # guess orbitals
    Vg = jnp.asarray(basis.rb.model_potential(potential(guess, basis.Z)(basis.rb.r)))
    ll1 = np.arange(nl) * (np.arange(nl) + 1.0)
    Hg = (ops.at.T + Vg)[None] + jnp.asarray(ll1[:, None, None]) * ops.Tl[None]
    Eg, Cg = eig_channels(Hg, ops.at.Sinvh_rad)
    Eg, Cg = np.asarray(Eg), np.asarray(Cg)

    def run_scf(occs, E0, C0):
        # short host warmup on the SHARED DIIS implementation (scf/diis.py),
        # then fully on-device fused chunks (make_sad_fused_chunk): only
        # per-iteration (E, err) scalars reach the host, removing the
        # per-iteration device round trips
        from helfem_tpu.scf.diis import DIIS

        E_, C_ = E0.copy(), C0
        Eold, Etot = 0.0, 0.0
        Svec = np.asarray(ops.at.S)
        Sinvh = np.asarray(ops.at.Sinvh_rad)
        diis = DIIS(Svec, Sinvh, max_hist=diisorder, diis_eps=diiseps,
                    diis_thr=diisthr, adiis=False)
        occw_np, angw_np = occ_weight_vectors(occs, nl, nrad, True)
        occw = jnp.asarray(occw_np)
        angw = jnp.asarray(angw_np)
        converged = False
        out = None
        Ekin = Ecoul = Exx = Exc = 0.0
        warmup = 2
        nhist, CH = diisorder, 4
        fused = None
        hist = None
        it = 0
        while it < maxit:
            it += 1
            if it > warmup:
                if fused is None:
                    fused = make_sad_fused_chunk(
                        tuple(funcs), kfrac, nl, nrad, nhist, CH,
                        dftthr=dftthr, restricted=True, shift=shift,
                    )
                    hist = (
                        jnp.zeros((nhist, nl, nrad, nrad)),
                        jnp.zeros((nhist, nl * nrad * nrad)),
                        jnp.asarray(0),
                    )
                    Vwr = jnp.broadcast_to(jnp.eye(nrad), (nl, nrad, nrad))
                    wgate = jnp.minimum(0.1 * convthr, 1e-9)
                Cdev = jnp.asarray(C_)
                Es, _, Cs, _, Vwr, _, Etots, errs, comps, hF, hE, cnt = fused(
                    ops, occw, angw, occw, angw, Cdev, Cdev, Vwr, Vwr, *hist, wgate
                )
                hist = (hF, hE, cnt)
                Etots = np.asarray(Etots)
                errs = np.asarray(errs)
                kmax = min(CH, maxit - it + 1)
                k = 0
                for k in range(kmax):
                    Etot = float(Etots[k])
                    err = float(errs[k])
                    dE = Etot - Eold
                    Eold = Etot
                    if verbose:
                        print(f"  it {it + k:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
                    if err < convthr and abs(dE) < convthr:
                        converged = True
                        break
                it += k
                Ekin, Ecoul, Exx, Exc, _Nel = (float(x[k]) for x in comps)
                if converged or it >= maxit:
                    # orbitals CONSISTENT with the reported Etot: step k's
                    # energy comes from the PRE-eigh density, i.e. the
                    # post-eigh orbitals of step k-1 (the chunk input for
                    # k=0) -- matching the host path, which breaks before
                    # updating C_. Using Cs[k] would hand callers (SAP
                    # export, radii, xcpot.dat) a density one
                    # diagonalization ahead of the printed energy.
                    C_ = Cs[k - 1] if k > 0 else Cdev
                    if k > 0:
                        E_ = np.asarray(Es[k - 1])
                    Pl, _ = density_cubes(np.asarray(C_), occs, True)
                    out = (Etot, Ekin, Ecoul, Exx, Exc, E_, np.asarray(C_), Pl)
                    break
                E_ = np.asarray(Es[k])
                C_ = Cs[k]
                continue

            Pl, Pang = density_cubes(np.asarray(C_), occs, True)
            Pla = jnp.asarray(Pl / 2.0)
            # with restricted capacities 2(2l+1), Pang IS the per-spin
            # m-averaged density (fracocc = nocc/cap), matching the
            # reference's AngularDensity (src/sadatom/solver.cpp:505-528)
            Panga = jnp.asarray(Pang)
            Fla, Flb, Ekin_, Enuc, Ecoul_, Exx_, Exc_, Nel = fock(
                ops, Pla, Pla, Panga, Panga
            )
            Etot = float(Ekin_ + Enuc + Ecoul_ + Exx_ + Exc_)
            Ekin, Ecoul, Exx, Exc = float(Ekin_), float(Ecoul_), float(Exx_), float(Exc_)
            dE = Etot - Eold
            Eold = Etot
            Fn = np.asarray(Fla)
            errv = []
            for l in range(nl):
                FPS = Fn[l] @ (Pl[l] / 2.0) @ Svec
                errv.append((Sinvh.T @ (FPS - FPS.T) @ Sinvh).ravel())
            errv = np.concatenate(errv)
            err = diis.update_with_error([Fn[l] for l in range(nl)], errv)
            if verbose:
                print(f"  it {it:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
            if err < convthr and abs(dE) < convthr and it > 1:
                converged = True
            if converged or it == maxit:
                out = (Etot, Ekin, Ecoul, Exx, Exc, E_, np.asarray(C_), Pl)
                break
            Fuse = np.stack(diis.solve())
            if err > 1e-3 and shift != 0.0:
                # level shift on virtuals until DIIS takes over
                # (reference: solver.cpp:1190-1193)
                E_, C_ = eig_channels_shifted(
                    Fuse, C_, occs, True, Svec, ops.at.Sinvh_rad, shift
                )
            else:
                E_, C_ = eig_channels(jnp.asarray(Fuse), ops.at.Sinvh_rad)
            E_, C_ = np.asarray(E_), C_
        return converged, out, np.asarray(E_), np.asarray(C_)

    # memoized fixed-occupation solves, keyed by the occupation tuple
    results: dict[tuple, tuple] = {}

    def solve_cb(key):
        if key not in results:
            results[key] = run_scf(np.array(key, dtype=int), Eg, Cg)
        conv_, out_, Efin_, _ = results[key]
        return out_[0], conv_, Efin_

    conf_list = None
    if occs is not None:
        # enforced occupations: one fixed-occupation SCF, no search
        key = tuple(int(x) for x in occs)
        E_, conv_, _ = solve_cb(key)
        conf_list = [(key, E_, conv_)]
    elif search:
        # exhaustive ground-configuration search (aufbau self-consistency +
        # MoveElectrons neighbors; reference: src/sadatom/main.cpp:300-350)
        from helfem_tpu.models.sadconf import initial_occs, search_restricted

        try:
            occs0 = initial_occs(nel, basis.lmax)
        except ValueError:
            occs0 = aufbau_occs(Eg, nel, True)
        conf_list = search_restricted(solve_cb, occs0, nel, verbose=verbose)
    else:
        # aufbau self-consistency only
        key = tuple(int(x) for x in aufbau_occs(Eg, nel, True))
        seen = {key}
        for _ in range(6):
            _, _, Efin_ = solve_cb(key)
            newkey = tuple(int(x) for x in aufbau_occs(Efin_, nel, True))
            if newkey in seen:
                break
            seen.add(newkey)
            key = newkey
        conf_list = sorted(
            ((k, results[k][1][0], results[k][0]) for k in seen if k in results),
            key=lambda t: t[1],
        )

    best_key = conf_list[0][0]
    conv, out, Efin, Cfin = results[best_key]
    occs = np.array(best_key, dtype=int)
    Etot, Ekin, Ecoul, Exx, Exc, Eorb, Corb, Pl = out
    return SadResult(
        converged=conv,
        E=Etot,
        occs=occs,
        occs_b=None,
        Ekin=Ekin,
        Ecoul=Ecoul,
        Exx=Exx,
        Exc=Exc,
        orbE=np.asarray(Eorb),
        orbs=np.asarray(Corb),
        Pl=Pl,
        conf_list=conf_list,
    )


def search_sadatom_unrestricted(
    basis: SadAtomBasis,
    nel: int | None = None,
    method: str = "HF",
    mode: str = "aufbau",
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    max_dx: int = 5,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    diisthr: float | None = None,
) -> SadResult:
    """Unrestricted ground-configuration search.

    mode='aufbau': Hund-rule-coupled aufbau + MoveElectrons search (the
    reference's restricted=-1 path, src/sadatom/main.cpp:367-460).
    mode='scan': full multiplicity scan over spin splits dx=0..max_dx (the
    reference's restricted=0 path, main.cpp:460-560).

    Returns the best configuration's SadResult with the energy-ordered
    conf_list attached ([( (occa, occb), E, converged ), ...])."""
    from helfem_tpu.models.sadconf import (
        hund_rule,
        initial_occs,
        search_spin_scan,
        search_unrestricted,
    )

    if nel is None:
        nel = basis.Z
    ops = basis.build_ops()
    results: dict[tuple, SadResult] = {}

    def solve_cb(key):
        if key not in results:
            occa, occb = key
            results[key] = solve_sadatom_unrestricted(
                basis,
                int(sum(occa)),
                int(sum(occb)),
                method=method,
                occs_a=np.array(occa, dtype=int),
                occs_b=np.array(occb, dtype=int),
                maxit=maxit,
                convthr=convthr,
                guess=guess,
                verbose=verbose,
                ops=ops,
                shift=shift,
                dftthr=dftthr,
                diisorder=diisorder,
                diiseps=diiseps,
                diisthr=diisthr,
            )
        r = results[key]
        return r.E, r.converged, r.orbE, r.orbE_b

    if mode == "aufbau":
        try:
            occ0 = initial_occs(nel, basis.lmax)
        except ValueError:
            occ0 = None
        if occ0 is None:
            # fall back to a guess-hamiltonian aufbau
            Vg = jnp.asarray(basis.rb.model_potential(potential(guess, basis.Z)(basis.rb.r)))
            nl = basis.lmax + 1
            ll1 = np.arange(nl) * (np.arange(nl) + 1.0)
            Hg = (ops.at.T + Vg)[None] + jnp.asarray(ll1[:, None, None]) * ops.Tl[None]
            Eg, _ = eig_channels(Hg, ops.at.Sinvh_rad)
            occ0 = aufbau_occs(np.asarray(Eg), nel, True)
        occa0, occb0 = hund_rule(occ0)
        conf_list = search_unrestricted(solve_cb, occa0, occb0, nel, verbose=verbose)
    elif mode == "scan":
        conf_list = search_spin_scan(solve_cb, nel, basis.lmax, max_dx=max_dx, verbose=verbose)
    else:
        raise ValueError(f"unknown search mode {mode}")

    best = results[conf_list[0][0]]
    best.conf_list = conf_list
    return best
