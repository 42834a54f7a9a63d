"""Diatomic SCF driver (stage 8): HF/DFT on two-center systems.

Same loop shape as the atomic driver (and src/diatomic/main.cpp): the
symmetry blocks are per m (plus gerade/ungerade for homonuclear), solved as
one padded batched whitened eigh.
"""

from dataclasses import dataclass

from functools import lru_cache

import os

import jax
import jax.numpy as jnp
import numpy as np

from helfem_tpu.models.diatomic import (
    DiatomicBasis,
    DiatomicOperators,
    coulomb_dia,
    exchange_dia,
    exchange_dia_occ,
)
from helfem_tpu.scf.diis import DIIS, device_diis_step
from helfem_tpu.utils.linalg import eigh_refined, eigh_warm

__all__ = ["scf_diatomic", "eig_blocks_dia", "density_dia"]

_BIG = 1e6


@jax.jit
def gather_blocks_dia(ops: DiatomicOperators, F: jnp.ndarray):
    """Gather a dense [nbf, nbf] matrix into padded symmetry-block
    coordinates [nblk, blen, blen]. Padded slots (blk_idx == nbf) read the
    zero pad row/column. For any matrix that is block-diagonal over the
    symmetry blocks -- every Fock/density/overlap in this driver is, by
    construction of the blocked eigensolve -- this loses nothing."""
    Fp = jnp.pad(F, ((0, 1), (0, 1)))
    bi = ops.blk_idx
    return Fp[bi[:, :, None], bi[:, None, :]]


def _whiten_blocks_dia(ops: DiatomicOperators, Fb: jnp.ndarray):
    """Whitened block Fock matrices Sinvh_b^T F_b Sinvh_b [nblk, blen, blen];
    padded slots get eigenvalue _BIG (never occupied)."""
    bi = ops.blk_idx
    nbf = ops.S.shape[0]
    Forth = jnp.einsum("bpi,bpq,bqj->bij", ops.blk_sinvh, Fb, ops.blk_sinvh)
    pad = (bi == nbf).astype(Fb.dtype)
    return Forth + _BIG * jnp.eye(bi.shape[1])[None] * pad[:, None, :]


@jax.jit
def eig_blocks_dia_b(ops: DiatomicOperators, Fb: jnp.ndarray):
    """Batched whitened eigensolve from BLOCK-coordinate Fock matrices
    [nblk, blen, blen] (the fused chunk keeps its whole DIIS history in
    block coordinates; see make_dia_fused_chunk): one batched eigh over
    all symmetry blocks. Padded slots get eigenvalue _BIG (never occupied).
    Returns (E [nblk, blen], C [nblk, blen, blen]) in block coordinates."""
    E, V = eigh_refined(_whiten_blocks_dia(ops, Fb))
    C = jnp.einsum("bpi,bij->bpj", ops.blk_sinvh, V)
    return E, C


@jax.jit
def eig_blocks_dia_b_warm(ops: DiatomicOperators, Fb: jnp.ndarray,
                          V0: jnp.ndarray, wgate):
    """eig_blocks_dia_b with a warm-started eigensolve: V0 are the previous
    iteration's whitened block eigenvectors (identity on the first call);
    matmul-only refinement replaces the batched eigh whenever the residual
    certificate beats `wgate` (utils/linalg.py:eigh_warm), and the batched
    eigh runs otherwise. Returns (E, C, V, used_warm)."""
    E, V, good = eigh_warm(_whiten_blocks_dia(ops, Fb), V0, gate=wgate)
    C = jnp.einsum("bpi,bij->bpj", ops.blk_sinvh, V)
    return E, C, V, good


@jax.jit
def eig_blocks_dia(ops: DiatomicOperators, F: jnp.ndarray):
    """Batched whitened eigensolve over the padded symmetry blocks.

    Padded slots get eigenvalue _BIG (never occupied). Returns
    (E [nblk, blen], C [nblk, blen, blen]) in block coordinates."""
    return eig_blocks_dia_b(ops, gather_blocks_dia(ops, F))


def eig_blocks_dia_host(ops: DiatomicOperators, F: np.ndarray,
                        return_v: bool = False):
    """Host LAPACK mirror of eig_blocks_dia, same conventions: the plain
    reference that the tests and the GPU smoke run compare the device
    eigensolves with. The SCF itself never calls it.

    return_v=True also returns the whitened eigenvectors V (the warm
    eigensolve's seed; C = blk_sinvh @ V)."""
    nbf = F.shape[0]
    bi = np.asarray(ops.blk_idx)
    bs = np.asarray(ops.blk_sinvh)
    Fp = np.pad(np.asarray(F), ((0, 1), (0, 1)))
    Fb = Fp[bi[:, :, None], bi[:, None, :]]
    Forth = np.einsum("bpi,bpq,bqj->bij", bs, Fb, bs, optimize=True)
    pad = (bi == nbf).astype(Fp.dtype)
    Forth = Forth + _BIG * np.eye(bi.shape[1])[None] * pad[:, None, :]
    E, V = np.linalg.eigh(Forth)
    C = np.einsum("bpi,bij->bpj", bs, V, optimize=True)
    return (E, C, V) if return_v else (E, C)


def fock_m_average_dia(F: np.ndarray, basis) -> np.ndarray:
    """Average the Fock submatrices over the +m/-m symmetry pairs so the
    pi+/pi-, delta+/delta-, ... channels stay exactly degenerate
    (reference --maverage: scf::fock_symmetry_average over m_indices(m),
    m_indices(-m), src/diatomic/main.cpp:325-332,892-895). Shells are
    paired in ascending-l order; the +-m shells share the same l set and
    the same radial mask, so the full submatrices (including cross-l
    couplings within the m block) correspond one-to-one."""
    F = np.array(F)
    nrad = basis.nrad
    for m in sorted(set(basis.mval)):
        if m <= 0:
            continue
        sp = sorted((a for a in range(basis.nang) if basis.mval[a] == m),
                    key=lambda a: basis.lval[a])
        sm = sorted((a for a in range(basis.nang) if basis.mval[a] == -m),
                    key=lambda a: basis.lval[a])
        if len(sp) != len(sm):
            continue
        idxp = np.concatenate([np.arange(a * nrad, (a + 1) * nrad) for a in sp])
        idxm = np.concatenate([np.arange(a * nrad, (a + 1) * nrad) for a in sm])
        mean = 0.5 * (F[np.ix_(idxp, idxp)] + F[np.ix_(idxm, idxm)])
        F[np.ix_(idxp, idxp)] = mean
        F[np.ix_(idxm, idxm)] = mean
    return F


@jax.jit
def eig_blocks_dia_shifted(ops: DiatomicOperators, F: jnp.ndarray,
                           C_prev: jnp.ndarray, occ: jnp.ndarray, shift: float):
    """Level-shifted blocked eigensolve: push the span of the previous
    iteration's virtual orbitals up by `shift` via S Cv Cv^T S per block
    (the sadatom/reference UpdateOrbitalsShifted stabilizer, applied here
    to rough-potential functionals like BR89)."""
    Fb = gather_blocks_dia(ops, F)
    Sb = gather_blocks_dia(ops, ops.S)
    virt = (occ <= 0.0).astype(F.dtype)
    Cv = C_prev * virt[:, None, :]
    SC = jnp.einsum("bpq,bqk->bpk", Sb, Cv)
    Fb = Fb + shift * jnp.einsum("bpk,brk->bpr", SC, SC)
    E, V = eigh_refined(_whiten_blocks_dia(ops, Fb))
    C = jnp.einsum("bpi,bij->bpj", ops.blk_sinvh, V)
    return E, C


@jax.jit
def density_dia(ops: DiatomicOperators, C: jnp.ndarray, occ: jnp.ndarray):
    nbf = ops.S.shape[0]
    Pb = jnp.einsum("bpk,bk,bqk->bpq", C, occ, C)
    bi = ops.blk_idx
    P = jnp.zeros((nbf + 1, nbf + 1))
    P = P.at[bi[:, :, None], bi[:, None, :]].add(Pb)
    return P[:nbf, :nbf]


def _scatter_blocks_dia(ops: DiatomicOperators, Pb: jnp.ndarray):
    """Scatter block-coordinate matrices [nblk, blen, blen] back to a dense
    [nbf, nbf] (inverse of gather_blocks_dia for block-diagonal matrices;
    padded slots land in the trash row/column and are dropped)."""
    nbf = ops.S.shape[0]
    bi = ops.blk_idx
    P = jnp.zeros((nbf + 1, nbf + 1))
    P = P.at[bi[:, :, None], bi[:, None, :]].add(Pb)
    return P[:nbf, :nbf]


def occ_select(occ: np.ndarray, no: int):
    """Host-side occupied-orbital selector for the factorized exchange:
    (block, column, sqrt(f)) arrays padded to the static width `no`
    (padded entries carry weight 0 and are exact no-ops). Returns None
    when more than `no` orbitals carry occupation (degeneracy averaging
    can transiently spread fractions over many orbitals) -- the caller
    then falls back to the dense K(P) for that Fock build instead of
    aborting the SCF."""
    b, k = np.nonzero(occ > 0)
    if len(b) > no:
        return None
    ob = np.zeros(no, np.int32)
    ok = np.zeros(no, np.int32)
    sqf = np.zeros(no)
    ob[: len(b)] = b
    ok[: len(b)] = k
    sqf[: len(b)] = np.sqrt(occ[b, k])
    return jnp.asarray(ob), jnp.asarray(ok), jnp.asarray(sqf)


def occupied_dia(ops: DiatomicOperators, C: jnp.ndarray, sel):
    """sqrt(f)-weighted occupied orbital columns [nbf, no] assembled from
    block orbitals C [nblk, blen, blen] and an occ_select() selector."""
    ob, ok, sqf = sel
    nbf = ops.S.shape[0]
    no = sqf.shape[0]
    rows = ops.blk_idx[ob]  # [no, blen]; padded slots point at row nbf
    Csel = C[ob, :, ok] * sqf[:, None]  # [no, blen]
    Co = jnp.zeros((nbf + 1, no))
    Co = Co.at[rows, jnp.arange(no)[:, None]].add(Csel)
    return Co[:nbf]


def _aufbau_blocks(E: np.ndarray, nel: float) -> np.ndarray:
    """Occupations [nblk, blen] over globally sorted block eigenvalues with
    degeneracy averaging (pi_+/pi_- etc.)."""
    nblk, blen = E.shape
    occ = np.zeros(nblk * blen)
    flat = E.ravel()
    order = np.argsort(flat, kind="stable")
    left = float(nel)
    i = 0
    while left > 1e-12 and i < len(order):
        if flat[order[i]] > _BIG / 2:
            break
        j = i
        while j + 1 < len(order) and flat[order[j + 1]] - flat[order[i]] < 1e-8:
            j += 1
        ndeg = j - i + 1
        fill = min(left, float(ndeg))
        for k in range(i, j + 1):
            occ[order[k]] = fill / ndeg
        left -= fill
        i = j + 1
    if left > 1e-12:
        raise ValueError(
            f"aufbau could not place {left:g} electrons: only "
            f"{int((flat < _BIG / 2).sum())} usable eigenvalues"
        )
    return occ.reshape(nblk, blen)


def _occ_fixed_blocks(E: np.ndarray, nocc: np.ndarray) -> np.ndarray:
    """Occupations with a FIXED electron count per symmetry block
    (reference --readocc): aufbau within each block independently."""
    nblk, blen = E.shape
    occ = np.zeros((nblk, blen))
    for b in range(nblk):
        occ[b] = _aufbau_blocks(E[b : b + 1], float(nocc[b]))[0]
    return occ


@dataclass
class DiaSCFResult:
    converged: bool
    niter: int
    E: float
    Ekin: float
    Enucattr: float
    Enucrep: float
    Ecoul: float
    Exx: float
    Exc: float
    orbE_a: np.ndarray
    orbs_a: np.ndarray | None = None  # [nblk, blen, blen] block orbitals
    occ_a: np.ndarray | None = None  # [nblk, blen]
    orbE_b: np.ndarray | None = None
    orbs_b: np.ndarray | None = None
    occ_b: np.ndarray | None = None
    Efield: float = 0.0
    orbsym_a: list[str] | None = None  # spectroscopic label per orbE_a entry
    orbsym_b: list[str] | None = None
    orbE_blocks_a: np.ndarray | None = None  # [nblk, blen] block eigenvalues
    orbE_blocks_b: np.ndarray | None = None


@lru_cache(maxsize=None)
def make_dia_fock(funcs, kfrac, dftthr: float = 1e-12, restricted: bool = False,
                  njbd: int | None = None):
    """Jitted diatomic Fock builder. With restricted=True, Pb is assumed
    identical to Pa and the exchange operator is built once (it dominates
    the Fock cost). njbd restricts the Coulomb scan to the M = 0
    channel prefix -- exact for the symmetry-block-diagonal densities this
    driver produces (see coulomb_dia)."""

    @jax.jit
    def fock(ops: DiatomicOperators, g, Pa, Pb, Coa=None, Cob=None):
        P = Pa + Pb
        J = coulomb_dia(ops, P, njbd)
        Fa = ops.H0 + J
        Fb = ops.H0 + J
        Exx = 0.0
        if kfrac != 0.0:
            # occupied-orbital factorized exchange when sqrt(f)-weighted
            # orbital columns are supplied (the SCF loops always have
            # them); dense K(P) otherwise (P-only callers: warm starts,
            # cost probes)
            # per-spin fallback: a None selector (occupations wider than the
            # static column budget) drops that spin to the dense K(P)
            Ka = (kfrac * exchange_dia_occ(ops, Coa) if Coa is not None
                  else kfrac * exchange_dia(ops, Pa))
            Kb = (Ka if restricted
                  else kfrac * exchange_dia_occ(ops, Cob) if Cob is not None
                  else kfrac * exchange_dia(ops, Pb))
            Fa = Fa + Ka
            Fb = Fb + Kb
            Exx = 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))
        Exc = 0.0
        Nel = 0.0
        if funcs:
            from helfem_tpu.models.diatomic_dft import eval_fxc_dia

            XCa, XCb, Exc, Nel = eval_fxc_dia(funcs, g, ops, Pa, Pb, dftthr)
            Fa = Fa + XCa
            Fb = Fb + XCb
        Ekin = jnp.vdot(P, ops.T)
        Enuc = jnp.vdot(P, ops.Vnuc)
        Ecoul = 0.5 * jnp.vdot(P, J)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


@lru_cache(maxsize=None)
def make_dia_fused_chunk(funcs, kfrac, nhist: int, nsteps: int,
                         dftthr: float = 1e-12, restricted: bool = True,
                         Bz: float = 0.0, njbd: int | None = None):
    """Up to `nsteps` fully on-device diatomic SCF iterations in ONE
    jitted dispatch (density -> Fock -> device C2-DIIS -> blocked
    eigensolve), the diatomic analogue of the atomic fused chunk: only
    per-iteration (E, err) scalars reach the host, removing the
    per-iteration transfer and dispatch latency of the host-loop driver.
    Occupations are frozen within a chunk (the
    host refreshes them between chunks). The steps run under a
    lax.while_loop with the CONVERGENCE TEST ON DEVICE (err < convthr and
    |dE| < convthr, the host loop's own gate), so a chunk that converges
    mid-way stops immediately -- no wasted Fock builds -- while still amortizing the
    dispatch cost when far from convergence.

    DESIGN: every Fock/density/overlap here is block-diagonal over
    the symmetry blocks by construction (that is what makes the blocked
    eigensolve exact), so the WHOLE DIIS side runs in block coordinates:
    the error commutator is Sinvh_b^T (F_b P_b S_b - .T) Sinvh_b per block
    (sum_b blen^3 instead of three dense nbf^3 products -- ~60x fewer
    FLOPs at the reference-converged N2 lmax=12, nbf=4130), and the DIIS
    Fock history stores [nhist, nblk, blen, blen] blocks (~7x less device
    memory than dense [nhist, nbf, nbf]); the extrapolated Fock feeds
    eig_blocks_dia_b directly without a scatter/gather round trip. The
    dense Fock from fock() is gathered into blocks ONCE per iteration."""
    fock = make_dia_fock(funcs, kfrac, dftthr, restricted=restricted, njbd=njbd)

    @jax.jit
    def chunk(ops, g, Vextra, occa, occb, sela, selb,
              Ca, Cb, Vwa, Vwb, histF, histE, count, convthr, Eprev, nrun):
        Sb = gather_blocks_dia(ops, ops.S)
        # warm-eigensolve acceptance gate (see eigh_warm)
        wgate = jnp.minimum(0.1 * convthr, 1e-9)

        def errof_b(Fb, Pb):
            # block commutator; padded slots are exact zeros (blk_sinvh
            # and the gathered pads are zero there)
            FPS = jnp.einsum("bpq,bqr,brs->bps", Fb, Pb, Sb)
            M = FPS - jnp.transpose(FPS, (0, 2, 1))
            return jnp.einsum("bpi,bps,bsj->bij",
                              ops.blk_sinvh, M, ops.blk_sinvh).ravel()

        def step(Ca, Cb, Vwa, Vwb, histF, histE, count):
            Pab = jnp.einsum("bpk,bk,bqk->bpq", Ca, occa, Ca)
            Pa = _scatter_blocks_dia(ops, Pab)
            if restricted:
                Pbb, Pb = Pab, Pa
            else:
                Pbb = jnp.einsum("bpk,bk,bqk->bpq", Cb, occb, Cb)
                Pb = _scatter_blocks_dia(ops, Pbb)
            # sqrt(f)-weighted occupied columns for the factorized exchange
            # (sela is None for pure functionals or HELFEM_DIA_OCC=0)
            Coa = None if sela is None else occupied_dia(ops, Ca, sela)
            Cob = (Coa if restricted else
                   (None if selb is None else occupied_dia(ops, Cb, selb)))
            Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(
                ops, g, Pa, Pb, Coa, Cob
            )
            Efield = jnp.vdot(Pa + Pb, Vextra)
            Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield
            if Bz != 0.0:
                # spin Zeeman -+ B/2 per spin (reference: main.cpp Fa/Fb)
                Fa = Fa - 0.5 * Bz * ops.S
                Fb = Fb + 0.5 * Bz * ops.S
            Fab = gather_blocks_dia(ops, Fa)
            if restricted:
                err = errof_b(Fab, Pab)
                F = Fab
            else:
                Fbb = gather_blocks_dia(ops, Fb)
                err = jnp.concatenate([errof_b(Fab, Pab), errof_b(Fbb, Pbb)])
                F = jnp.stack([Fab, Fbb])
            errmax = jnp.max(jnp.abs(err))
            Fuse, histF, histE, count = device_diis_step(histF, histE, count, F, err)
            # warm-started blocked eigensolve (see eig_blocks_dia_b_warm):
            # the batched eigh runs only when the residual certificate fails
            if restricted:
                Ea, Cna, Vna, _ = eig_blocks_dia_b_warm(ops, Fuse, Vwa, wgate)
                Eb, Cnb, Vnb = Ea, Cna, Vna
            else:
                Ea, Cna, Vna, _ = eig_blocks_dia_b_warm(ops, Fuse[0], Vwa, wgate)
                Eb, Cnb, Vnb = eig_blocks_dia_b_warm(ops, Fuse[1], Vwb, wgate)[:3]
            return (Cna, Cnb, Vna, Vnb, histF, histE, count,
                    Ea, Eb, Etot, errmax, Nel,
                    jnp.stack([Ekin, Enuc, Ecoul, Exx, Exc, Efield]))

        def cond(st):
            k, done = st[0], st[1]
            return (k < nrun) & (~done)

        def body(st):
            (k, _done, Ca, Cb, Vwa, Vwb, histF, histE, count, Ep,
             Eas, Ebs, Cas, Cbs, Etots, errs, Nels, comps) = st
            (Cna, Cnb, Vna, Vnb, histF, histE, count,
             Ea, Eb, Etot, errmax, Nel, comp) = step(Ca, Cb, Vwa, Vwb,
                                                     histF, histE, count)
            done = (errmax < convthr) & (jnp.abs(Etot - Ep) < convthr)
            return (k + 1, done, Cna, Cnb, Vna, Vnb, histF, histE, count, Etot,
                    Eas.at[k].set(Ea),
                    Ebs if restricted else Ebs.at[k].set(Eb),
                    Cas.at[k].set(Cna),
                    Cbs if restricted else Cbs.at[k].set(Cnb),
                    Etots.at[k].set(Etot), errs.at[k].set(errmax),
                    Nels.at[k].set(Nel), comps.at[k].set(comp))

        nb, bl = Ca.shape[0], Ca.shape[1]
        # restricted: beta == alpha, so the per-step beta output buffers
        # ([nsteps, nb, bl, bl] -- ~300 MB at the reference-converged N2
        # lmax=12 with nsteps=16) are never read; allocate empty slots
        st0 = (jnp.asarray(0), jnp.asarray(False), Ca, Cb, Vwa, Vwb,
               histF, histE, count, Eprev,
               jnp.zeros((nsteps, nb, bl)),
               jnp.zeros((nsteps, 0, 0) if restricted else (nsteps, nb, bl)),
               jnp.zeros((nsteps, nb, bl, bl)),
               jnp.zeros((nsteps, 0, 0, 0) if restricted
                         else (nsteps, nb, bl, bl)),
               jnp.zeros(nsteps), jnp.zeros(nsteps), jnp.zeros(nsteps),
               jnp.zeros((nsteps, 6)))
        (k, _done, Ca, Cb, Vwa, Vwb, histF, histE, count, _Ep,
         Eas, Ebs, Cas, Cbs, Etots, errs, Nels, comps) = jax.lax.while_loop(
            cond, body, st0
        )
        return (Cas, Cbs, Eas, Ebs, Vwa, Vwb, histF, histE, count,
                Etots, errs, Nels, comps, k)

    return chunk


def scf_diatomic(
    basis: DiatomicBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    maxit: int = 100,
    convthr: float = 1e-7,
    verbose: bool = False,
    ops: DiatomicOperators | None = None,
    guess: str = "core",
    P0a: np.ndarray | None = None,
    P0b: np.ndarray | None = None,
    Ez: float = 0.0,
    Qzz: float = 0.0,
    Bz: float = 0.0,
    finitenuc: str = "point",
    Rrms1: float = 0.0,
    Rrms2: float = 0.0,
    shift: float = 0.0,
    restricted: int = -1,
    perturb: float = 0.0,
    seed: int = 0,
    diisorder: int = 10,
    diiseps: float = 0.1,
    dftthr: float = 1e-12,
    ldft: int = 0,
    occs: np.ndarray | None = None,
    readocc_until: int = 0,
    diisthr: float | None = None,
    save_cb=None,
    diag: bool = True,
    maverage: bool = False,
    ndev: int = 0,
) -> DiaSCFResult:
    """Diatomic SCF. Ez/Qzz/Bz add the electric-dipole, quadrupole, and
    magnetic (orbital Zeeman + diamagnetic + spin) field operators
    (reference: src/diatomic/main.cpp Vel/Vmag wiring); finitenuc switches
    the nuclear model, evaluated on the 2D quadrature grid
    (main.cpp:492-514). shift > 0 level-shifts the virtual orbitals until
    the DIIS error drops below 1e-3 (needed for rough-potential functionals
    like BR89). diag=False whitens the symmetry blocks with the inverse
    Cholesky factor (reference --diag 0); maverage averages the Fock
    submatrices over +-m symmetry pairs every iteration (reference
    --maverage, src/diatomic/main.cpp:892-895)."""
    from helfem_tpu.ops.xc import parse_method

    if ops is None:
        # an axial electric field couples even and odd l: no g/u blocks then
        ops = basis.build_operators(parity=(Ez == 0.0), chol=not diag)
    nbf = basis.nbf
    funcs, kfrac = parse_method(method)
    g = None
    if funcs:
        from helfem_tpu.models.diatomic_dft import build_dia_grid

        g = build_dia_grid(basis, neta=ldft)

    # extra one-electron terms folded into H0 (tracked as Efield)
    Vextra = np.zeros((nbf, nbf))
    mv = basis.shell_mask().reshape(-1)
    if finitenuc != "point":
        from helfem_tpu.models.diatomic_tools import finite_nucleus_Vnuc

        Vextra += finite_nucleus_Vnuc(basis, finitenuc, Rrms1, Rrms2) - np.asarray(ops.Vnuc)
    if Ez != 0.0:
        Vextra += Ez * basis.dipole_z() * mv[:, None] * mv[None, :]
    if Qzz != 0.0:
        Vextra += (Qzz / 3.0) * basis.quadrupole_zz() * mv[:, None] * mv[None, :]
    if Bz != 0.0:
        Vextra += basis.Bz_field(Bz)
    has_extra = np.abs(Vextra).max() > 0.0
    Vextra_dev = jnp.asarray(Vextra)
    if has_extra:
        ops = ops._replace(H0=ops.H0 + Vextra_dev)
    Enucrep = basis.Z1 * basis.Z2 / basis.Rbond

    # restricted: -1 auto (the reference convention); restricted=1 with
    # nela != nelb runs ROHF via the CUHF Fock update, exactly like the
    # atomic driver (reference: scf::ROHF_update wired in the diatomic SCF
    # loop, src/diatomic/main.cpp:902-904)
    rohf = False
    if restricted == -1:
        restricted = nela == nelb and Bz == 0.0
    elif restricted == 1:
        rohf = nela != nelb
        restricted = (not rohf) and Bz == 0.0
    else:
        restricted = False
    # every density here is symmetry-block-diagonal (per-m blocks), so the
    # Coulomb build runs on the M = 0 channel prefix (exact; coulomb_dia)
    njbd = getattr(basis, "njbd", None)
    fock = make_dia_fock(tuple(funcs), kfrac, dftthr=dftthr, restricted=restricted,
                         njbd=njbd)
    # occupied-orbital factorized exchange (HELFEM_DIA_OCC=0 forces the
    # dense K(P) path): static padded orbital-column widths per spin.
    # TWO-TIER widths: the cross-element exchange matmul scales linearly
    # in the padded width, so the normal path runs TIGHT (+2 -- diatomic
    # levels are at most 2-fold degenerate, so aufbau spreads rarely
    # exceed it) and a WIDE (+8) shape exists for degeneracy-averaged
    # fractional spreads; the wide jit specialization only compiles if an
    # overflow ever actually happens.
    use_occ = kfrac != 0.0 and os.environ.get("HELFEM_DIA_OCC", "1") != "0"
    noa = min(nbf, int(np.ceil(nela)) + 2)
    nob = min(nbf, int(np.ceil(nelb)) + 2)
    noa_w = min(nbf, int(np.ceil(nela)) + 8)
    nob_w = min(nbf, int(np.ceil(nelb)) + 8)

    def occ_select2(occ, no_t, no_w):
        sel = occ_select(occ, no_t)
        return sel if sel is not None else occ_select(occ, no_w)
    def eig_full(F):
        E, C = eig_blocks_dia(ops, jnp.asarray(F))
        return np.asarray(E), C

    # --ndev: multi-device mesh execution. The Fock build shards the
    # Coulomb (L,M) channel scan, the exchange (L,|M|) step scan, and the
    # XC mu-element axis over 'ch' with psum'ed partials; the blocked
    # eigensolve shards the symmetry-block axis (parallel.mesh.
    # sharded_dia_scf_fock / sharded_dia_eig) -- the multi-device replacement
    # for the reference's OpenMP sites (src/diatomic/basis.cpp:1175,1560).
    # Fused single-device chunks are disabled (warmup below).
    if ndev >= 1:
        from helfem_tpu.parallel.mesh import (make_mesh, sharded_dia_eig,
                                              sharded_dia_scf_fock)

        mesh = make_mesh(ndev)
        sfock_fn, _, _ = sharded_dia_scf_fock(
            mesh, ops, tuple(funcs), g, kfrac, dftthr, restricted=restricted,
        )
        fock = lambda ops_, g_, Pa, Pb, Coa=None, Cob=None: sfock_fn(  # noqa: E731
            Pa, Pb, Coa, Cob)
        eig_mesh = sharded_dia_eig(mesh, ops)

        def eig_full(F):  # noqa: F811 - mesh override of the local above
            E, C = eig_mesh(jnp.asarray(F))
            return np.asarray(E), C
    if P0a is not None:
        # warm start from a density (e.g. a loaded checkpoint): build the
        # Fock of the supplied density and diagonalize it as the guess
        # (reference --load restart, src/diatomic/main.cpp).
        P0b_ = P0a if P0b is None else P0b
        gfock = (fock if P0b is None
                 else make_dia_fock(tuple(funcs), kfrac, dftthr=dftthr, njbd=njbd))
        Fg_a, Fg_b, *_ = gfock(ops, g, jnp.asarray(P0a), jnp.asarray(P0b_))
        Ea, Ca = eig_full(Fg_a)
        if restricted:
            Eb, Cb = Ea.copy(), Ca
        else:
            Eb, Cb = eig_full(Fg_b)
    else:
        if guess == "core":
            Hguess = ops.H0
        else:
            from helfem_tpu.models.diatomic_tools import guess_hamiltonian_dia

            Hguess = jnp.asarray(guess_hamiltonian_dia(basis, guess))
        Ea, Ca = eig_full(Hguess)
        Eb, Cb = Ea.copy(), Ca
    if perturb:
        from helfem_tpu.utils.linalg import perturbation_matrix

        R = perturbation_matrix(Ca.shape[-1], perturb, seed)
        Ca = jnp.einsum("bpk,kq->bpq", Ca, jnp.asarray(R))
        if not restricted:
            # INDEPENDENT rotation per spin channel (the reference draws a
            # fresh perturbation for beta) so a symmetric guess can break
            # spin symmetry, e.g. toward spin-polarized UHF at stretch
            Rb = perturbation_matrix(np.asarray(Cb).shape[-1], perturb, seed + 1)
            Cb = jnp.einsum("bpk,kq->bpq", jnp.asarray(Cb), jnp.asarray(Rb))

    Sinvh_np = _full_sinvh(ops, nbf)
    # blockwise error commutator: F/P are symmetry-block-diagonal by
    # construction (the blocked eigensolve requires it), so the dense
    # nbf^3 commutator products are pure waste at big bases
    diis = DIIS(np.asarray(ops.S), Sinvh_np, max_hist=diisorder,
                diis_eps=diiseps, diis_thr=diisthr,
                blocks=(np.asarray(ops.blk_idx), np.asarray(ops.blk_sinvh)))
    Sh_np = None
    if rohf:
        from helfem_tpu.utils.linalg import form_sh

        Sh_np = form_sh(np.asarray(ops.S))

    Eold, Etot, converged = 0.0, 0.0, False
    # fused on-device chunks engage after TWO host warmup iterations,
    # matching the atomic path: the host DIIS runs ADIIS energy-model
    # weights in the large-error regime that the device chunk's pure
    # C2-DIIS cannot handle. Round-4 set warmup=0 here and the BeH UHF
    # test converged to a wrong stationary point (+0.164 Eh); the host
    # warmup is load-bearing for far-from-converged guesses. The level
    # shift and the ROHF Fock surgery need per-iteration host logic and
    # keep the host loop entirely.
    warmup = 2 if (shift == 0.0 and not rohf and not maverage
                   and ndev < 1) else maxit
    chunk_len = 4
    fused = None
    hist = None
    Nel = 0.0
    occa = occb = None
    it = 0
    while it < maxit:
        it += 1
        if occs is not None and (readocc_until < 0 or it <= readocc_until):
            # enforced per-symmetry-block occupations (reference --readocc
            # occs.dat, used until the nth Fock build): occs[b] = (na, nb)
            occa = _occ_fixed_blocks(Ea, np.asarray(occs)[:, 0])
            occb = occa if restricted else _occ_fixed_blocks(Eb, np.asarray(occs)[:, 1])
        else:
            occa = _aufbau_blocks(Ea, nela)
            occb = occa if restricted else _aufbau_blocks(Eb, nelb)

        # a finite --readocc boundary must land on the exact iteration
        # (reference semantics: enforced until the nth Fock build), so stay
        # on the host loop until it has passed; fused chunks freeze
        # occupations for up to CH iterations at a time (4, 8, ... doubling
        # schedule)
        readocc_hold = occs is not None and 0 < readocc_until and it <= readocc_until
        if it > warmup and not readocc_hold:
            if fused is None:
                nhist = 10
                # chunk length capped so the per-step coefficient output
                # buffers (Cas [CH, nblk, blen, blen]) stay under ~256 MB
                # and never crowd the resident TEI tables out of device memory; big
                # bases pay seconds per Fock build anyway, so dispatch
                # amortization matters only for the small ones
                CH = 16
                _nb, _bl = ops.blk_idx.shape
                while CH > 4 and CH * _nb * _bl * _bl * 8 > 256e6:
                    CH //= 2
                fused = make_dia_fused_chunk(
                    tuple(funcs), kfrac, nhist, CH, dftthr, restricted, Bz,
                    njbd=njbd,
                )
                # block-coordinate DIIS history (see make_dia_fused_chunk)
                nblk, blen = ops.blk_idx.shape
                nerr = (1 if restricted else 2) * nblk * blen * blen
                fshape = ((nhist, nblk, blen, blen) if restricted
                          else (nhist, 2, nblk, blen, blen))
                hist = (jnp.zeros(fshape), jnp.zeros((nhist, nerr)), jnp.asarray(0))
                # warm-eigensolve seed (identity -> first step runs the
                # full eigh); persists across chunks
                Vwa = jnp.broadcast_to(jnp.eye(blen), (nblk, blen, blen))
                Vwb = Vwa
            sela = occ_select2(occa, noa, noa_w) if use_occ else None
            selb = (None if restricted or not use_occ
                    else occ_select2(occb, nob, nob_w))
            Emag = -0.5 * Bz * (nela - nelb)
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            # the device chunk stops itself on the convergence gate; pass
            # the previous total energy on the chunk's own scale (without
            # the constant nuclear-repulsion + spin-Zeeman shifts)
            (Cas, Cbs, Eas, Ebs, Vwa, Vwb, hF, hE, cnt, Etots, errs, Nels,
             comps, kdev) = fused(
                ops, g, Vextra_dev,
                jnp.asarray(occa), jnp.asarray(occb), sela, selb, Ca, Cb,
                Vwa, Vwb, *hist,
                jnp.asarray(float(convthr)),
                jnp.asarray(Eold - Enucrep - Emag), jnp.asarray(nrun),
            )
            hist = (hF, hE, cnt)
            Etots = np.asarray(Etots)
            errs = np.asarray(errs)
            kmax = int(kdev)
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k]) + Enucrep + Emag
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"iter {it + k:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e} (fused)")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            it += k
            Ca = Cas[k]
            Cb = Ca if restricted else Cbs[k]
            Ea = np.asarray(Eas[k])
            Eb = Ea if restricted else np.asarray(Ebs[k])
            Nel = Nels[k]
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = np.asarray(comps[k])
            Efield = float(Efield)
            if save_cb is not None:
                save_cb(it, Etot, Ea, Ca, occa,
                        None if restricted else Eb,
                        None if restricted else Cb,
                        None if restricted else occb)
            if converged or it >= maxit:
                break
            continue

        Pa = density_dia(ops, Ca, jnp.asarray(occa))
        Pb = Pa if restricted else density_dia(ops, Cb, jnp.asarray(occb))
        sela_h = occ_select2(occa, noa, noa_w) if use_occ else None
        selb_h = (None if restricted or not use_occ
                  else occ_select2(occb, nob, nob_w))
        Coa = None if sela_h is None else occupied_dia(ops, Ca, sela_h)
        Cob = (Coa if restricted else
               (None if selb_h is None else occupied_dia(ops, Cb, selb_h)))
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Pb, Coa, Cob)
        Efield = float(jnp.vdot(Pa + Pb, Vextra_dev)) if has_extra else 0.0
        if Bz != 0.0:
            # spin Zeeman: -+ B/2 per spin (reference: main.cpp Fa/Fb -+ Bz/2 S)
            Fa = Fa - 0.5 * Bz * ops.S
            Fb = Fb + 0.5 * Bz * ops.S
        Emag = -0.5 * Bz * (nela - nelb)
        Etot = float(Ekin + Enuc + Ecoul + Exx + Exc) + Enucrep + Efield + Emag
        dE = Etot - Eold
        Eold = Etot

        if maverage:
            # average the Fock submatrices over the +-m symmetry pairs
            # (reference --maverage: scf::fock_symmetry_average over
            # m_indices(+-m), src/diatomic/main.cpp:325-332,892-895)
            Fa = fock_m_average_dia(np.asarray(Fa), basis)
            Fb = Fa if restricted else fock_m_average_dia(np.asarray(Fb), basis)

        if restricted:
            err = diis.update([np.asarray(Fa)], [np.asarray(Pa)])
            (Fa_,) = diis.solve()
            Fb_ = Fa_
        else:
            if rohf:
                from helfem_tpu.utils.linalg import rohf_update

                Fa, Fb = rohf_update(
                    np.asarray(Fa), np.asarray(Fb), np.asarray(Pa + Pb),
                    Sh_np, Sinvh_np, nela, nelb,
                )
            err = diis.update([np.asarray(Fa), np.asarray(Fb)], [np.asarray(Pa), np.asarray(Pb)])
            Fa_, Fb_ = diis.solve()

        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if save_cb is not None:
            save_cb(it, Etot, Ea, Ca, occa,
                    None if restricted else Eb,
                    None if restricted else Cb,
                    None if restricted else occb)
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break

        if err > 1e-3 and shift != 0.0:
            Ea, Ca = eig_blocks_dia_shifted(
                ops, jnp.asarray(Fa_), Ca, jnp.asarray(occa), shift
            )
            Ea = np.asarray(Ea)
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Eb, Cb = eig_blocks_dia_shifted(
                    ops, jnp.asarray(Fb_), Cb, jnp.asarray(occb), shift
                )
                Eb = np.asarray(Eb)
        else:
            Ea, Ca = eig_full(Fa_)
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Eb, Cb = eig_full(Fb_)

    oe = np.sort(Ea.ravel())
    eb = np.sort(np.asarray(Eb).ravel())

    # spectroscopic label per sorted eigenvalue (sigma g/u, pi g/u, ...)
    nblk = np.asarray(Ea).shape[0]
    labels = basis.sym_labels(True)
    if len(labels) != nblk:
        labels = basis.sym_labels(False)

    def _sorted_syms(E):
        flat = np.asarray(E).ravel()
        order = np.argsort(flat)
        order = order[flat[order] < _BIG / 2]
        return [labels[i // E.shape[1]] for i in order] if len(labels) == nblk else None

    return DiaSCFResult(
        converged=converged,
        niter=it,
        E=Etot,
        Ekin=float(Ekin),
        Enucattr=float(Enuc),
        Enucrep=Enucrep,
        Ecoul=float(Ecoul),
        Exx=float(Exx),
        Exc=float(Exc),
        orbE_a=oe[oe < _BIG / 2],
        orbs_a=np.asarray(Ca),
        occ_a=occa,
        orbE_b=None if restricted else eb[eb < _BIG / 2],
        orbs_b=None if restricted else np.asarray(Cb),
        occ_b=None if restricted else occb,
        Efield=Efield,
        orbsym_a=_sorted_syms(Ea),
        orbsym_b=None if restricted else _sorted_syms(np.asarray(Eb)),
        orbE_blocks_a=np.asarray(Ea),
        orbE_blocks_b=None if restricted else np.asarray(Eb),
    )


def _full_sinvh(ops: DiatomicOperators, nbf: int) -> np.ndarray:
    """Global Sinvh assembled from the block half-inverses (for the DIIS
    error metric)."""
    bi = np.asarray(ops.blk_idx)
    bs = np.asarray(ops.blk_sinvh)
    out = np.zeros((nbf + 1, nbf + 1))
    for b in range(bi.shape[0]):
        out[np.ix_(bi[b], bi[b])] += bs[b]
    return out[:nbf, :nbf]
