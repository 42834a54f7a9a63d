"""Atomic SCF driver (L7): HF and DFT (restricted/unrestricted) on atoms,
with electric/magnetic fields, confinement, and finite-nucleus models.

Mirrors the SCF loop of src/atomic/main.cpp:725-998:
  density -> J -> K and/or XC -> F -> DIIS -> symmetry-blocked eigensolve ->
  aufbau occupations, until |dE| and the DIIS error pass convthr.

The symmetry-blocked eigensolve runs as ONE padded batched whitened eigh
across all blocks ((l,m) blocks by default; m blocks when an electric field
couples l channels), the device replacement for the reference's per-block
LAPACK loop (scf::eig_gsym_sub).
"""

from dataclasses import dataclass

from functools import lru_cache

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from helfem_tpu.models.atomic import (
    AtomicBasis,
    AtomicOperators,
    channel_diag,
    coulomb,
    erfc_exchange,
    erfc_exchange_bd,
    exchange,
    exchange_bd,
    rs_exchange,
    rs_exchange_bd,
)
from helfem_tpu.models.atomic_dft import build_dft_grid, eval_fxc
from helfem_tpu.ops.xc import parse_method_rs
from helfem_tpu.scf.diis import DIIS, device_diis_step
from helfem_tpu.scf.guess import potential
from helfem_tpu.utils.linalg import (
    _BIG,
    build_blocks,
    density_blocks,
    eig_blocks,
    eig_blocks_b_warm,
    eigh_refined,
    gather_blocks,
)

__all__ = ["scf_atom", "SCFResult", "aufbau_blocks"]


@dataclass
class SCFResult:
    converged: bool
    niter: int
    E: float
    Ekin: float
    Enuc: float
    Ecoul: float
    Exx: float
    Exc: float
    Nelgrid: float
    Efield: float
    orbE_a: np.ndarray
    orbs_a: np.ndarray  # [nblk, blen, blen] block eigenvectors
    occ_a: np.ndarray  # [nblk, blen]
    orbE_b: np.ndarray | None = None
    orbs_b: np.ndarray | None = None
    occ_b: np.ndarray | None = None
    orbsym_a: list[str] | None = None  # symmetry label per orbE_a entry
    orbsym_b: list[str] | None = None
    # unsorted per-block eigenvalues [nblk, blen] matching orbs_a/b columns
    # (needed to assemble global energy-ordered orbital vectors, e.g. for
    # the reference-schema HDF5 checkpoint export)
    orbE_blocks_a: np.ndarray | None = None
    orbE_blocks_b: np.ndarray | None = None
    # symmetry-block setting the solve used (sym_blocks(symm) reproduces
    # the block index sets orbs_a/b are expressed in)
    symm_used: int | None = None


def aufbau_blocks(E: np.ndarray, nel: float) -> np.ndarray:
    """Occupations [nblk, blen] over globally sorted block eigenvalues with
    degeneracy averaging (keeps open shells spherical / pi_+- symmetric)."""
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
        # only reachable when usable eigenvalues ran out: an iterative
        # solve (--eigiter) that computed fewer eigenpairs per block than
        # the aufbau needs (the rest are padded at +_BIG). Silently
        # dropping electrons converges to a wrong state.
        raise ValueError(
            f"aufbau could not place {left:g} electrons: only "
            f"{int((flat < _BIG / 2).sum())} usable eigenvalues; "
            "increase --eigiter (or use the dense eigensolve)"
        )
    return occ.reshape(nblk, blen)


@jax.jit
def _diis_error(F, P, S, Sinvh):
    FPS = F @ P @ S
    e = Sinvh.T @ (FPS - FPS.T) @ Sinvh
    return e.ravel()


def _scatter_blocks(Pb, blk_idx, nbf):
    """Scatter block-coordinate matrices [nblk, blen, blen] into a global
    [nbf, nbf] (padded slots land on the trash row/col and are dropped)."""
    P = jnp.zeros((nbf + 1, nbf + 1))
    P = P.at[blk_idx[:, :, None], blk_idx[:, None, :]].add(Pb)
    return P[:nbf, :nbf]


def _diis_error_blocks(Fb, Pb, Sb, blk_sinvh):
    """DIIS error Sinvh^T ([F,P]S-commutator) Sinvh per SYMMETRY BLOCK,
    from block-coordinate matrices [nblk, blen, blen]. This is the
    reference's error metric under --symmetry: the reference zeroes the
    off-block Fock entries (scf::enforce_fock_symmetry,
    src/atomic/main.cpp:846) BEFORE DIIS, so the dense commutator's
    support is exactly the diagonal blocks -- the same definition the
    host-loop DIIS uses (scf/diis.py blocks=). Padded slots are exact
    zeros (blk_sinvh and the gathered pads are zero there). Sum_b blen^3
    FLOPs instead of three dense nbf^3 products."""
    FPS = jnp.einsum("bpq,bqr,brs->bps", Fb, Pb, Sb)
    M = FPS - jnp.transpose(FPS, (0, 2, 1))
    return jnp.einsum("bpi,bps,bsj->bij", blk_sinvh, M, blk_sinvh).ravel()


@lru_cache(maxsize=None)
def make_fock(funcs, kfrac: float, nrad: int, Bz: float = 0.0, dftthr: float = 1e-12,
              restricted: bool = False, kshort: float = 0.0, kernel: str = "erfc",
              bd: bool = False):
    """Jitted Fock builder for a fixed method (funcs/kfrac/kshort compile-
    time). The exchange operator is kfrac*K + kshort*K_sr(omega) with the
    short-range tables passed in as `rs` (reference: kfrac*exchange +
    kshort*rs_exchange, src/atomic/main.cpp:763-779). With restricted=True,
    Pb is assumed identical to Pa and the exchange build runs once (it
    dominates the Fock cost).

    bd=True asserts every density passed in is block-diagonal over angular
    channels (guaranteed by construction when the eigensolve runs per-(l,m)
    symmetry blocks, the atomic default) and routes the exchange through
    the collapsed exchange_bd path -- ~nang x fewer kernel FLOPs and one
    dispatch instead of an L-chunked scan. The result is identical to the
    dense exchange for such densities (tested)."""

    @jax.jit
    def fock(ops: AtomicOperators, g, Vextra, rs, Pa, Pb):
        P = Pa + Pb
        J = coulomb(ops, P)
        H = ops.H0 + Vextra
        Fa = H + J
        Fb = H + J
        Exx = 0.0
        if kfrac != 0.0 or kshort != 0.0:
            nang = ops.G.shape[-1]

            def K_of(Ps):
                K = jnp.zeros_like(J)
                Pdx = channel_diag(Ps, nang, nrad) if bd else None
                if kfrac != 0.0:
                    K = K + kfrac * (exchange_bd(ops, Pdx) if bd
                                     else exchange(ops, Ps))
                if kshort != 0.0:
                    if kernel == "erfc":
                        Ksr = (erfc_exchange_bd(ops, rs, Pdx) if bd
                               else erfc_exchange(ops, rs, Ps))
                    else:
                        Ksr = (rs_exchange_bd(ops, rs, Pdx) if bd
                               else rs_exchange(ops, rs, Ps))
                    K = K + kshort * Ksr
                return K

            Ka = K_of(Pa)
            Kb = Ka if restricted else K_of(Pb)
            Fa = Fa + Ka
            Fb = Fb + Kb
            Exx = 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))
        Exc = 0.0
        Nel = 0.0
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc(funcs, g, Pa, Pb, nrad, dftthr)
            Fa = Fa + XCa
            Fb = Fb + XCb
        if Bz != 0.0:
            Fa = Fa - 0.5 * Bz * ops.S
            Fb = Fb + 0.5 * Bz * ops.S
        Ekin = jnp.vdot(P, ops.T)
        Enuc = jnp.vdot(P, ops.Vnuc)
        Efield = jnp.vdot(P, Vextra)
        Ecoul = 0.5 * jnp.vdot(P, J)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield

    return fock


@lru_cache(maxsize=None)
def make_fused_step(funcs, kfrac: float, nrad: int, nhist: int, Bz: float = 0.0,
                    dftthr: float = 1e-12, kshort: float = 0.0, kernel: str = "erfc",
                    bd: bool = False):
    """One fully on-device restricted SCF iteration: density -> Fock ->
    C2-DIIS (device circular history) -> blocked eigensolve. Only two scalars
    (energy, DIIS error) need to reach the host per iteration, removing the
    per-iteration host DIIS/transfer overhead."""
    fock = make_fock(funcs, kfrac, nrad, Bz, dftthr, restricted=True,
                     kshort=kshort, kernel=kernel, bd=bd)

    @jax.jit
    def step(ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full, occ, C, Vw,
             histF, histE, count, wgate):
        nbf = ops.S.shape[0]
        Pab = jnp.einsum("bpk,bk,bqk->bpq", C, occ, C)
        Pa = _scatter_blocks(Pab, blk_idx, nbf)
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(ops, g, Vextra, rs, Pa, Pa)
        Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield
        if bd:
            # whole DIIS side in symmetry-block coordinates: blockwise
            # error (the reference's metric under --symmetry, see
            # _diis_error_blocks) and block-coordinate Fock history
            # ([nhist, nblk, blen, blen] -- the dense [nhist, nbf, nbf]
            # history's read/write traffic dominated the fused step).
            # Loss-free: the blocked eigensolve never reads off-block F.
            Fab = gather_blocks(Fa, blk_idx)
            Sb = gather_blocks(ops.S, blk_idx)
            err = _diis_error_blocks(Fab, Pab, Sb, blk_sinvh)
            errmax = jnp.max(jnp.abs(err))
            Fuse, histF, histE, count = device_diis_step(histF, histE, count, Fab, err)
        else:
            FPS = Fa @ Pa @ ops.S
            err = (Sinvh_full.T @ (FPS - FPS.T) @ Sinvh_full).ravel()
            errmax = jnp.max(jnp.abs(err))
            Fuse, histF, histE, count = device_diis_step(histF, histE, count, Fa, err)
            Fuse = gather_blocks(Fuse, blk_idx)
        # warm-started blocked eigensolve: the previous step's whitened
        # eigenvectors Vw seed matmul-only refinement; the full eigh runs
        # only when the residual certificate fails (first step of a chunk
        # entered with Vw = I, or a large DIIS jump). See
        # utils/linalg.py:eigh_warm.
        E, Cn, Vn, _good = eig_blocks_b_warm(Fuse, blk_idx, blk_sinvh, nbf,
                                             Vw, wgate)
        return Cn, E, Vn, histF, histE, count, Etot, errmax, Nel, (Ekin, Enuc, Ecoul, Exx, Exc, Efield)

    return step


@lru_cache(maxsize=None)
def make_fused_chunk(funcs, kfrac: float, nrad: int, nhist: int, nsteps: int,
                     Bz: float = 0.0, dftthr: float = 1e-12, kshort: float = 0.0,
                     kernel: str = "erfc", bd: bool = False):
    """Up to `nsteps` fused SCF iterations in ONE jitted dispatch:
    amortizes the per-call dispatch and host-transfer latency across
    iterations. Occupations are frozen within a chunk (the host
    refreshes them between chunks). The steps run under a lax.while_loop
    with the convergence gate ON DEVICE (err < convthr and |dE| < convthr,
    the host loop's own test), so a chunk that converges mid-way stops
    immediately instead of paying the remaining Fock builds."""
    step = make_fused_step(funcs, kfrac, nrad, nhist, Bz, dftthr, kshort, kernel, bd)
    # reuse the single-step trace inside the loop body
    inner = step.__wrapped__ if hasattr(step, "__wrapped__") else step

    @jax.jit
    def chunk(ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full, occ, C, Vw,
              histF, histE, count, convthr, Eprev, nrun):
        # warm-eigensolve acceptance gate: keep the eigensolve residual
        # well below the SCF convergence gate (see eigh_warm)
        wgate = jnp.minimum(0.1 * convthr, 1e-9)

        def cond(st):
            return (st[0] < nrun) & (~st[1])

        def body(st):
            (k, _done, C, Vw, histF, histE, count, Ep,
             Es, Cs, Etots, errs, Nels, comps) = st
            Cn, E, Vn, histF, histE, count, Etot, errmax, Nel, comp = inner(
                ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full, occ, C,
                Vw, histF, histE, count, wgate
            )
            done = (errmax < convthr) & (jnp.abs(Etot - Ep) < convthr)
            return (k + 1, done, Cn, Vn, histF, histE, count, Etot,
                    Es.at[k].set(E), Cs.at[k].set(Cn),
                    Etots.at[k].set(Etot), errs.at[k].set(errmax),
                    Nels.at[k].set(Nel), comps.at[k].set(jnp.stack(comp)))

        nb, bl = C.shape[0], C.shape[1]
        st0 = (jnp.asarray(0), jnp.asarray(False), C, Vw, histF, histE, count,
               Eprev,
               jnp.zeros((nsteps, nb, bl)), jnp.zeros((nsteps, nb, bl, bl)),
               jnp.zeros(nsteps), jnp.zeros(nsteps), jnp.zeros(nsteps),
               jnp.zeros((nsteps, 6)))
        (k, _done, C, Vw, histF, histE, count, _Ep,
         Es, Cs, Etots, errs, Nels, comps) = jax.lax.while_loop(cond, body, st0)
        return Cs, Es, Vw, histF, histE, count, Etots, errs, Nels, comps, k

    return chunk


@lru_cache(maxsize=None)
def make_fused_chunk_u(funcs, kfrac: float, nrad: int, nhist: int, nsteps: int,
                       Bz: float = 0.0, dftthr: float = 1e-12, kshort: float = 0.0,
                       kernel: str = "erfc", bd: bool = False):
    """Unrestricted analogue of make_fused_chunk: `nsteps` fully on-device
    UHF/UDFT iterations per dispatch. The DIIS history stores spin-stacked
    Fock pairs with the combined alpha+beta error vector (the reference's
    uDIIS combined-error mode, src/general/diis.cpp)."""
    fock = make_fock(funcs, kfrac, nrad, Bz, dftthr, restricted=False,
                     kshort=kshort, kernel=kernel, bd=bd)

    @jax.jit
    def chunk(ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full, occa, occb,
              Ca, Cb, Vwa, Vwb, histF, histE, count, convthr, Eprev, nrun):
        wgate = jnp.minimum(0.1 * convthr, 1e-9)

        def step(Ca, Cb, Vwa, Vwb, histF, histE, count):
            nbf = ops.S.shape[0]
            Pab = jnp.einsum("bpk,bk,bqk->bpq", Ca, occa, Ca)
            Pbb = jnp.einsum("bpk,bk,bqk->bpq", Cb, occb, Cb)
            Pa = _scatter_blocks(Pab, blk_idx, nbf)
            Pb = _scatter_blocks(Pbb, blk_idx, nbf)
            Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(
                ops, g, Vextra, rs, Pa, Pb
            )
            Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield

            if bd:
                # block-coordinate DIIS side (see make_fused_step)
                Sb = gather_blocks(ops.S, blk_idx)
                Fab = gather_blocks(Fa, blk_idx)
                Fbb = gather_blocks(Fb, blk_idx)
                err = jnp.concatenate([
                    _diis_error_blocks(Fab, Pab, Sb, blk_sinvh),
                    _diis_error_blocks(Fbb, Pbb, Sb, blk_sinvh),
                ])
                errmax = jnp.max(jnp.abs(err))
                Fuse, histF, histE, count = device_diis_step(
                    histF, histE, count, jnp.stack([Fab, Fbb]), err
                )
                Fua, Fub = Fuse[0], Fuse[1]
            else:
                def errof(F, P):
                    FPS = F @ P @ ops.S
                    return (Sinvh_full.T @ (FPS - FPS.T) @ Sinvh_full).ravel()

                err = jnp.concatenate([errof(Fa, Pa), errof(Fb, Pb)])
                errmax = jnp.max(jnp.abs(err))
                Fuse, histF, histE, count = device_diis_step(
                    histF, histE, count, jnp.stack([Fa, Fb]), err
                )
                Fua = gather_blocks(Fuse[0], blk_idx)
                Fub = gather_blocks(Fuse[1], blk_idx)
            # warm-started blocked eigensolves (see make_fused_step)
            Ea, Cna, Vna, _ = eig_blocks_b_warm(Fua, blk_idx, blk_sinvh, nbf,
                                                Vwa, wgate)
            Eb, Cnb, Vnb, _ = eig_blocks_b_warm(Fub, blk_idx, blk_sinvh, nbf,
                                                Vwb, wgate)
            return (Cna, Cnb, Vna, Vnb, histF, histE, count,
                    Ea, Eb, Etot, errmax, Nel,
                    jnp.stack([Ekin, Enuc, Ecoul, Exx, Exc, Efield]))

        def cond(st):
            return (st[0] < nrun) & (~st[1])

        def body(st):
            (k, _done, Ca, Cb, Vwa, Vwb, histF, histE, count, Ep,
             Eas, Ebs, Cas, Cbs, Etots, errs, Nels, comps) = st
            (Cna, Cnb, Vna, Vnb, histF, histE, count,
             Ea, Eb, Etot, errmax, Nel, comp) = step(Ca, Cb, Vwa, Vwb,
                                                     histF, histE, count)
            done = (errmax < convthr) & (jnp.abs(Etot - Ep) < convthr)
            return (k + 1, done, Cna, Cnb, Vna, Vnb, histF, histE, count, Etot,
                    Eas.at[k].set(Ea), Ebs.at[k].set(Eb),
                    Cas.at[k].set(Cna), Cbs.at[k].set(Cnb),
                    Etots.at[k].set(Etot), errs.at[k].set(errmax),
                    Nels.at[k].set(Nel), comps.at[k].set(comp))

        nb, bl = Ca.shape[0], Ca.shape[1]
        st0 = (jnp.asarray(0), jnp.asarray(False), Ca, Cb, Vwa, Vwb,
               histF, histE, count, Eprev,
               jnp.zeros((nsteps, nb, bl)), jnp.zeros((nsteps, nb, bl)),
               jnp.zeros((nsteps, nb, bl, bl)), jnp.zeros((nsteps, nb, bl, bl)),
               jnp.zeros(nsteps), jnp.zeros(nsteps), jnp.zeros(nsteps),
               jnp.zeros((nsteps, 6)))
        (k, _done, Ca, Cb, Vwa, Vwb, histF, histE, count, _Ep,
         Eas, Ebs, Cas, Cbs, Etots, errs, Nels, comps) = jax.lax.while_loop(
            cond, body, st0
        )
        return (
            Cas, Cbs, Eas, Ebs, Vwa, Vwb, histF, histE, count, Etots, errs,
            Nels, comps, k
        )

    return chunk


def _fock_m_average(F, basis) -> np.ndarray:
    """Average the diagonal (l,m) radial blocks over m for each l
    (reference: scf::fock_symmetry_average, src/general/scf_helpers.cpp:264,
    the --maverage option)."""
    F = np.array(F)
    nrad = basis.nrad
    for l in np.unique(basis.lval):
        shells = np.nonzero(basis.lval == l)[0]
        if len(shells) < 2:
            continue
        mean = sum(
            F[a * nrad : (a + 1) * nrad, a * nrad : (a + 1) * nrad] for a in shells
        ) / len(shells)
        for a in shells:
            F[a * nrad : (a + 1) * nrad, a * nrad : (a + 1) * nrad] = mean
    return F


def _damp_fock_mo(F, C_blocks, occ, blk_idx, S, factor: float) -> np.ndarray:
    """Scale the occupied-virtual MO blocks of F by `factor`
    (reference: the --dampfock off-diagonal damping,
    src/atomic/main.cpp:919-935; applied per symmetry block, which is
    equivalent to the reference's global MO transform when the Fock is
    symmetry-blocked)."""
    F = np.array(F)
    S = np.asarray(S)
    nbf = F.shape[0]
    for b in range(blk_idx.shape[0]):
        idx = blk_idx[b]
        idx = idx[idx < nbf]
        ni = len(idx)
        C = np.asarray(C_blocks[b])[:ni, :ni]
        occm = np.asarray(occ[b])[:ni] > 0
        if not occm.any() or occm.all():
            continue
        Fb = F[np.ix_(idx, idx)]
        Sb = S[np.ix_(idx, idx)]
        M = C.T @ Fb @ C
        M[np.ix_(occm, ~occm)] *= factor
        M[np.ix_(~occm, occm)] *= factor
        F[np.ix_(idx, idx)] = Sb @ C @ M @ C.T @ Sb
    return F


def scf_atom(
    basis: AtomicBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    maxit: int = 100,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: AtomicOperators | None = None,
    dftthr: float = 1e-12,
    restricted: int = -1,
    Ez: float = 0.0,
    Qzz: float = 0.0,
    Bz: float = 0.0,
    iconf: int = 0,
    conf_N: int = 0,
    conf_R: float = 0.0,
    conf_barrier: float = 0.0,
    shift_conf: float = 0.0,
    finitenuc: str = "point",
    Rrms: float = 0.0,
    Zl: int = 0,
    Zr: int = 0,
    Rmid: float = 0.0,
    occs: dict | None = None,
    perturb: float = 0.0,
    seed: int = 0,
    P0a: np.ndarray | None = None,
    P0b: np.ndarray | None = None,
    save_cb=None,
    symmetry: int = -1,
    maverage: bool = False,
    dampfock: float = 1.0,
    dampthr: float = 0.5,
    diisorder: int = 10,
    diiseps: float = 0.1,
    diisthr: float | None = None,
    ldft: int = 0,
    diag: bool = True,
    eigiter: int = 0,
    ndev: int = 0,
) -> SCFResult:
    """Restricted/unrestricted SCF. method: 'HF', 'LDA', 'SVWN', 'PBE', or
    an 'x_func,c_func' pair of functional names.

    occs: optional {(l, m): (na, nb)} per-symmetry enforced occupations
    (the reference's readocc mechanism); perturb/seed: random orthogonal
    rotation of the guess orbitals (reference: --perturb/--seed).

    P0a/P0b: warm-start densities (e.g. from utils.checkpoint
    warm_start_density): the guess diagonalizes Fock(P0) instead of the
    model-potential Hamiltonian (reference --load, main.cpp:507-609).

    save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb): crash-recovery
    checkpoint hook, called once per host-loop pass -- every iteration on
    the host path, every fused 4-iteration chunk once the on-device path
    engages (the reference writes HDF5 every iteration,
    main.cpp:735-737,854-855).

    ndev >= 1 runs the SCF over an ndev-device mesh (--ndev; 1 = mesh
    machinery on a single device): the Fock
    build shards the TEI L axis and the DFT-grid element axis over 'ch'
    with psum'ed partials, and the blocked eigensolve shards the
    symmetry-block axis (parallel.mesh.sharded_atomic_fock /
    sharded_eig_blocks) -- the multi-chip replacement for the reference's
    always-on OpenMP (src/atomic/TwoDBasis.cpp:987-1005,
    dftgrid.cpp:817-870). Converged energies equal the single-device
    path's (tested to 1e-9 on a virtual 8-device mesh)."""
    if ops is None:
        ops = basis.build_operators()
    nrad = basis.nrad
    spec = parse_method_rs(method)
    funcs, kfrac, kshort, omega, kernel = (
        spec.funcs, spec.kfull, spec.kshort, spec.omega, spec.kernel
    )
    # range separation: omega -> 0 means the short-range kernel IS the full
    # kernel; fold kshort into kfrac instead of building singular tables
    rs = None
    if kshort != 0.0:
        if omega == 0.0:
            kfrac, kshort = kfrac + kshort, 0.0
        else:
            rs = basis.build_erfc(omega) if kernel == "erfc" else basis.build_yukawa(omega)
    g = build_dft_grid(basis, ntheta=ldft) if funcs else None

    # extra one-electron terms
    Vextra = np.zeros((basis.nbf, basis.nbf))
    if finitenuc != "point":
        Vextra += basis.nuclear_model(finitenuc, Rrms) - basis.nuclear()
    if Ez != 0.0:
        Vextra += Ez * basis.dipole_z()
    if Qzz != 0.0:
        Vextra += Qzz * basis.quadrupole_zz() / 3.0
    if Bz != 0.0:
        Vextra += basis.Bz_field(Bz)
    if iconf:
        N = conf_N if iconf != 3 else conf_barrier
        Vextra += basis.confinement(N, conf_R, iconf, shift_conf)
    if (Zl or Zr) and Rmid > 0.0:
        Vextra += basis.nuclear_offcenter(Zl, Zr, Rmid)
    Vextra = jnp.asarray(Vextra)

    # symmetry blocks: (l,m) unless a field/off-center term couples l
    # channels; overridable via `symmetry` (reference --symmetry 0/1/2)
    symm = 1 if (Ez != 0.0 or Qzz != 0.0 or ((Zl or Zr) and Rmid > 0.0)) else 2
    if symmetry >= 0:
        symm = symmetry
    blk_idx_np, blk_sinvh_np = build_blocks(np.asarray(ops.S), basis.sym_blocks(symm),
                                            chol=not diag)
    blk_idx = jnp.asarray(blk_idx_np)
    blk_sinvh = jnp.asarray(blk_sinvh_np)

    # per-(l,m) symmetry blocks keep every density channel-block-diagonal,
    # enabling the collapsed exchange_bd path (identical result, ~nang x
    # fewer kernel FLOPs, one dispatch instead of an L-chunked scan)
    bd = symm == 2
    fock = make_fock(tuple(funcs), kfrac, nrad, Bz, dftthr, kshort=kshort,
                     kernel=kernel, bd=bd)

    def _channel_bd(P) -> bool:
        """Host check: is P block-diagonal over angular channels?"""
        P4 = np.asarray(P).reshape(basis.nang, nrad, basis.nang, nrad)
        off = P4.copy()
        off[np.arange(basis.nang), :, np.arange(basis.nang), :] = 0.0
        return float(np.abs(off).max()) <= 1e-12 * max(float(np.abs(P4).max()), 1.0)

    # guess
    if P0a is not None:
        # warm start: diagonalize the Fock of the supplied density. A
        # checkpoint density from a lower-symmetry run may carry
        # cross-channel blocks the bd exchange would silently drop -- use
        # the dense Fock for this one call if so
        P0b_ = P0a if P0b is None else P0b
        fg = fock
        if bd and not (_channel_bd(P0a) and _channel_bd(P0b_)):
            fg = make_fock(tuple(funcs), kfrac, nrad, Bz, dftthr,
                           kshort=kshort, kernel=kernel, bd=False)
        Fg_a, Fg_b, *_ = fg(ops, g, Vextra, rs, jnp.asarray(P0a), jnp.asarray(P0b_))
        Ea, Ca = eig_blocks(Fg_a, blk_idx, blk_sinvh)
        Ea = np.asarray(Ea)
        if P0b is not None:
            Eb_w, Cb_w = eig_blocks(Fg_b, blk_idx, blk_sinvh)
        else:
            Eb_w, Cb_w = None, None
    else:
        Hg = jnp.asarray(basis.kinetic() + basis.model_potential(potential(guess, basis.Z))) + Vextra
        Ea, Ca = eig_blocks(Hg, blk_idx, blk_sinvh)
        Ea = np.asarray(Ea)
        Eb_w, Cb_w = None, None
    Ca_unpert = Ca
    if perturb:
        from helfem_tpu.utils.linalg import perturbation_matrix

        R = perturbation_matrix(Ca.shape[-1], perturb, seed)
        Ca = jnp.einsum("bpk,kq->bpq", Ca, jnp.asarray(R))
    if Cb_w is not None:
        Eb, Cb = np.asarray(Eb_w), Cb_w
    else:
        Eb, Cb = Ea.copy(), Ca

    # per-symmetry enforced occupations (readocc): map (l, m) -> block row
    occ_fix = None
    if occs is not None:
        if symm != 2:
            raise ValueError("fixed occupations need (l,m) symmetry blocks")
        occ_fix = np.zeros((2, blk_idx_np.shape[0], blk_idx_np.shape[1]))
        for a in range(basis.nang):
            key = (int(basis.lval[a]), int(basis.mval[a]))
            if key in occs:
                na_, nb_ = occs[key]
                for s_, nocc in enumerate((na_, nb_)):
                    for k in range(int(nocc)):
                        occ_fix[s_, a, k] = 1.0

    # restricted: -1 auto (reference convention: restrict iff nela == nelb);
    # 1 with nela != nelb runs ROHF via the CUHF Fock update
    rohf = restricted == 1 and nela != nelb
    restricted = (nela == nelb and Bz == 0.0) if restricted == -1 else (restricted == 1 and not rohf and Bz == 0.0)
    if perturb and not restricted and Cb_w is None:
        # INDEPENDENT beta rotation (seed+1, applied to the UNperturbed
        # guess) so a symmetric guess can break spin symmetry -- matching
        # the diatomic path and the reference's fresh beta perturbation
        from helfem_tpu.utils.linalg import perturbation_matrix

        Rb = perturbation_matrix(np.asarray(Ca_unpert).shape[-1], perturb, seed + 1)
        Cb = jnp.einsum("bpk,kq->bpq", Ca_unpert, jnp.asarray(Rb))
    if restricted:
        # Pa == Pb throughout: build the exchange once per Fock
        fock = make_fock(tuple(funcs), kfrac, nrad, Bz, dftthr, restricted=True,
                         kshort=kshort, kernel=kernel, bd=bd)

    # --ndev: multi-device mesh execution (see docstring). The sharded
    # Fock/eigensolve replace the single-device jits in the host loop;
    # fused single-device chunks are disabled (warmup below).
    eig_sharded = None
    if ndev >= 1:
        if kshort != 0.0:
            raise NotImplementedError("--ndev does not support range-separated "
                                      "exchange yet (erfc/yukawa tables)")
        from helfem_tpu.parallel.mesh import (make_mesh, sharded_atomic_fock,
                                              sharded_eig_blocks)

        mesh = make_mesh(ndev)
        sfock, _, _ = sharded_atomic_fock(
            mesh, ops, tuple(funcs), g, kfrac, nrad, bd, Bz, dftthr,
            restricted=restricted,
        )
        fock = lambda ops_, g_, Vx_, rs_, Pa, Pb: sfock(Vx_, Pa, Pb)  # noqa: E731
        eig_sharded = sharded_eig_blocks(mesh, blk_idx_np, blk_sinvh_np, basis.nbf)
    Sinvh_np = _full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
    Sinvh_dev = jnp.asarray(Sinvh_np)
    # blockwise error commutator: F/P are block-diagonal over the SAME
    # blocks the eigensolve uses (any P that broke them would already
    # break eig_blocks), so the dense nbf^3 commutator is pure waste
    diis = DIIS(np.asarray(ops.S), Sinvh_np, max_hist=diisorder, diis_eps=diiseps,
                diis_thr=diisthr, blocks=(blk_idx_np, blk_sinvh_np))
    Sh_np = None
    if rohf:
        from helfem_tpu.utils.linalg import form_sh, rohf_update

        Sh_np = form_sh(np.asarray(ops.S))

    Eold = 0.0
    Etot = 0.0
    converged = False
    occa = occb = None
    # fused on-device chunks engage after the host warmup for both the
    # restricted and the plain-unrestricted paths. The TWO host warmup
    # iterations are load-bearing: the host DIIS runs ADIIS energy-model
    # weights in the large-error regime (err > diis_eps) that the device
    # chunk's pure C2-DIIS cannot handle (measured: Ar from a TF guess
    # stalls 0.1 Eh high without them). ROHF/CUHF, Fock m-averaging, and
    # MO-basis damping need host-side per-iteration Fock surgery and stay
    # on the host loop.
    warmup = maxit if (rohf or maverage or dampfock != 1.0 or eigiter > 0
                       or ndev >= 1) else 2
    # chunk-length schedule: 4, 8, 16 up to the compiled buffer size --
    # early chunks stay short so aufbau can reorder occupations while the
    # SCF is far from self-consistent, late chunks amortize the dispatch
    chunk_len = 4
    fused = None
    hist = None
    it = 0
    # HELFEM_ITER_WALL=1: per-iteration wall-clock prints (phase analysis
    # of the host-loop iterations, where dispatch latency and host
    # transfers can outweigh the FLOPs)
    _iterwall = os.environ.get("HELFEM_ITER_WALL") == "1"
    _tw = time.perf_counter() if _iterwall else 0.0
    while it < maxit:
        if _iterwall:
            _tn = time.perf_counter()
            print(f"[iterwall] iter {it:3d} starts at +{_tn - _tw:.3f}s",
                  flush=True)
        it += 1
        if occ_fix is not None:
            occa = occ_fix[0]
            occb = occ_fix[0] if restricted else occ_fix[1]
        else:
            occa = aufbau_blocks(Ea, nela)
            occb = occa if restricted else aufbau_blocks(Eb, nelb)

        if restricted and it > warmup:
            # fused on-device chunk: CH iterations of Fock + device C2-DIIS +
            # eigensolve in ONE jit call (amortizes the per-dispatch
            # latency); per-iteration (E, err) arrays come
            # back for host-side convergence checks
            if fused is None:
                nhist = 10
                CH = 16
                fused = make_fused_chunk(tuple(funcs), kfrac, nrad, nhist, CH, Bz, dftthr,
                                         kshort, kernel, bd)
                Sinvh_full = jnp.asarray(
                    _full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
                )
                # bd: DIIS history in symmetry-block coordinates (see
                # make_fused_step) -- nblk*blen^2 instead of nbf^2
                nblk, blen = blk_idx_np.shape
                hist = (
                    (jnp.zeros((nhist, nblk, blen, blen)) if bd else
                     jnp.zeros((nhist, basis.nbf, basis.nbf))),
                    jnp.zeros((nhist, (nblk * blen * blen) if bd
                               else basis.nbf * basis.nbf)),
                    jnp.asarray(0),
                )
                # warm-eigensolve seed: identity -> the first fused step's
                # residual certificate fails and the full eigh runs; the
                # final whitened eigenvectors persist across chunks
                Vw = jnp.broadcast_to(jnp.eye(blen), (nblk, blen, blen))
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            Cs, Es, Vw, hF, hE, cnt, Etots, errs, Nels, comps, kdev = fused(
                ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full, jnp.asarray(occa), Ca, Vw, *hist,
                jnp.asarray(float(convthr)), jnp.asarray(Eold), jnp.asarray(nrun)
            )
            hist = (hF, hE, cnt)
            Etots = np.asarray(Etots)
            errs = np.asarray(errs)
            # the device chunk stops itself at convergence or the maxit
            # boundary (nrun); kdev = steps actually run
            kmax = int(kdev)
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k])
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"iter {it + k:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e} (fused)")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            # true iteration count: the chunk ran k+1 counted iterations (one
            # was already counted by the outer loop); state is taken from the
            # exact reported iteration k, not the chunk end
            it += k
            Ca = Cs[k]
            Ea = np.asarray(Es[k])
            Eb, Cb = Ea, Ca
            Nel = Nels[k]
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = np.asarray(comps[k])
            if save_cb is not None:
                save_cb(it, Etot, Ea, Ca, occa, None, None, None)
            if converged or it >= maxit:
                break
            continue

        if not restricted and it > warmup:
            # unrestricted fused chunk (spin-stacked DIIS history)
            if fused is None:
                nhist = 10
                CH = 16
                fused = make_fused_chunk_u(tuple(funcs), kfrac, nrad, nhist, CH, Bz,
                                           dftthr, kshort, kernel, bd)
                Sinvh_full = jnp.asarray(
                    _full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
                )
                nblk, blen = blk_idx_np.shape
                hist = (
                    (jnp.zeros((nhist, 2, nblk, blen, blen)) if bd else
                     jnp.zeros((nhist, 2, basis.nbf, basis.nbf))),
                    jnp.zeros((nhist, 2 * ((nblk * blen * blen) if bd
                                           else basis.nbf * basis.nbf))),
                    jnp.asarray(0),
                )
                Vwa = jnp.broadcast_to(jnp.eye(blen), (nblk, blen, blen))
                Vwb = Vwa
            Emag = -0.5 * Bz * (nela - nelb)
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            (Cas, Cbs, Eas, Ebs, Vwa, Vwb, hF, hE, cnt, Etots, errs, Nels,
             comps, kdev) = fused(
                ops, g, Vextra, rs, blk_idx, blk_sinvh, Sinvh_full,
                jnp.asarray(occa), jnp.asarray(occb), Ca, Cb, Vwa, Vwb, *hist,
                jnp.asarray(float(convthr)), jnp.asarray(Eold - Emag),
                jnp.asarray(nrun)
            )
            hist = (hF, hE, cnt)
            Etots = np.asarray(Etots)
            errs = np.asarray(errs)
            kmax = int(kdev)
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k]) + Emag
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"iter {it + k:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e} (fused)")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            it += k
            Ca, Cb = Cas[k], Cbs[k]
            Ea = np.asarray(Eas[k])
            Eb = np.asarray(Ebs[k])
            Nel = Nels[k]
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = np.asarray(comps[k])
            if save_cb is not None:
                save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb)
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, jnp.asarray(occa), blk_idx, ops.S)
        Pb = Pa if restricted else density_blocks(Cb, jnp.asarray(occb), blk_idx, ops.S)
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(ops, g, Vextra, rs, Pa, Pb)
        Emag = -0.5 * Bz * (nela - nelb)
        Etot = float(Ekin + Enuc + Ecoul + Exx + Exc + Efield) + Emag
        dE = Etot - Eold
        Eold = Etot

        if maverage:
            Fa = jnp.asarray(_fock_m_average(Fa, basis))
            Fb = Fa if restricted else jnp.asarray(_fock_m_average(Fb, basis))

        if restricted:
            ev = _diis_error(Fa, Pa, ops.S, Sinvh_dev)
            err = diis.update_with_error([np.asarray(Fa)], np.asarray(ev))
            (Fa_,) = diis.solve()
            Fb_ = Fa_
        else:
            if rohf:
                from helfem_tpu.utils.linalg import rohf_update

                Fa, Fb = rohf_update(
                    np.asarray(Fa), np.asarray(Fb), np.asarray(Pa + Pb),
                    Sh_np, Sinvh_np, nela, nelb,
                )
            err = diis.update(
                [np.asarray(Fa), np.asarray(Fb)], [np.asarray(Pa), np.asarray(Pb)]
            )
            Fa_, Fb_ = diis.solve()

        if dampfock != 1.0 and err >= dampthr:
            if verbose:
                print(f"damping off-diagonal Fock elements by {dampfock:.3f}")
            Fa_ = _damp_fock_mo(Fa_, Ca, occa, blk_idx_np, ops.S, dampfock)
            if restricted:
                Fb_ = Fa_
            else:
                Fb_ = _damp_fock_mo(Fb_, Cb, occb, blk_idx_np, ops.S, dampfock)

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

        if eigiter > 0:
            # iterative (shift-invert ARPACK) blocked solve for the lowest eigiter
            # eigenpairs per block (--eigiter; reference: scf::eig_iter)
            from helfem_tpu.utils.linalg import eig_blocks_iter

            sigma = -0.6 * basis.Z**2 - 10.0
            Ea, Ca_np = eig_blocks_iter(np.asarray(Fa_), blk_idx_np, blk_sinvh_np,
                                        eigiter, sigma)
            Ca = jnp.asarray(Ca_np)
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Eb, Cb_np = eig_blocks_iter(np.asarray(Fb_), blk_idx_np, blk_sinvh_np,
                                            eigiter, sigma)
                Cb = jnp.asarray(Cb_np)
        else:
            eig_fn = eig_sharded if eig_sharded is not None else (
                lambda F: eig_blocks(F, blk_idx, blk_sinvh))
            Ea, Ca = eig_fn(jnp.asarray(Fa_))
            Ea = np.asarray(Ea)
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Eb, Cb = eig_fn(jnp.asarray(Fb_))
                Eb = np.asarray(Eb)

    labels = basis.sym_labels(symm)

    def _sorted_syms(E):
        """Block label per sorted eigenvalue (padded _BIG slots dropped)."""
        flat = E.ravel()
        order = np.argsort(flat)
        order = order[flat[order] < _BIG / 2]
        return [labels[i // E.shape[1]] for i in order]

    oe = np.sort(Ea.ravel())
    return SCFResult(
        converged=converged,
        niter=it,
        E=Etot,
        Ekin=float(Ekin),
        Enuc=float(Enuc),
        Ecoul=float(Ecoul),
        Exx=float(Exx),
        Exc=float(Exc),
        Nelgrid=float(Nel),
        Efield=float(Efield),
        orbE_a=oe[oe < _BIG / 2],
        orbs_a=np.asarray(Ca),
        occ_a=occa,
        orbE_b=None if restricted else np.sort(np.asarray(Eb).ravel()),
        orbs_b=None if restricted else np.asarray(Cb),
        occ_b=None if restricted else occb,
        orbsym_a=_sorted_syms(Ea),
        orbsym_b=None if restricted else _sorted_syms(np.asarray(Eb)),
        orbE_blocks_a=np.asarray(Ea),
        orbE_blocks_b=None if restricted else np.asarray(Eb),
        symm_used=symm,
    )


def atomic_analysis(basis: AtomicBasis, res: SCFResult, symm: int = 2) -> dict:
    """Post-SCF analysis (reference: src/atomic/main.cpp:1000-1059):
    <r^n> moments of the occupied orbitals, electron density and density
    gradient at the nucleus, and the cusp condition -n'(0)/(2 Z n(0))."""
    import jax.numpy as jnp

    from helfem_tpu.utils.linalg import build_blocks

    blk_idx, _ = build_blocks(basis.overlap(), basis.sym_blocks(symm))
    nbf = basis.nbf

    def full_P(C, occ):
        P = np.zeros((nbf + 1, nbf + 1))
        Pb = np.einsum("bpk,bk,bqk->bpq", np.asarray(C), occ, np.asarray(C))
        for b in range(blk_idx.shape[0]):
            P[np.ix_(blk_idx[b], blk_idx[b])] += Pb[b]
        return P[:nbf, :nbf]

    Pa = full_P(res.orbs_a, res.occ_a)
    Pb = full_P(res.orbs_b, res.occ_b) if res.orbs_b is not None else Pa
    P = Pa + Pb
    out = {}
    for n in (-1, 1, 2, 3):
        out[f"<r^{n}>"] = float(np.vdot(P, np.kron(np.eye(basis.nang), basis.rb.radial_integral(n))))
    # nuclear density: only s shells contribute; rho(0) = |sum_i c_i b_i(0) Y00|^2
    b0 = basis.rb.bf_at_origin()
    db0 = basis.rb.dbf_at_origin()
    s_shells = np.nonzero((basis.lval == 0) & (basis.mval == 0))[0]
    B0 = np.zeros(nbf)
    dB0 = np.zeros(nbf)
    for a in s_shells:
        B0[a * basis.nrad : (a + 1) * basis.nrad] = b0
        dB0[a * basis.nrad : (a + 1) * basis.nrad] = db0
    y00sq = 1.0 / (4.0 * np.pi)
    n0 = float(B0 @ P @ B0) * y00sq
    dn0 = 2.0 * float(dB0 @ P @ B0) * y00sq
    out["density_at_nucleus"] = n0
    out["density_gradient_at_nucleus"] = dn0
    out["cusp"] = -dn0 / (2.0 * basis.Z * n0) if n0 > 0 else 0.0
    out["dipole_z"] = -float(np.vdot(P, basis.dipole_z()))
    out["quadrupole_zz"] = -float(np.vdot(P, basis.quadrupole_zz()))
    # virial ratio -E/T = 1 exactly at the basis-set limit (main.cpp:1010)
    out["virial_ratio"] = -res.E / res.Ekin if res.Ekin else 0.0
    return out


def _full_sinvh(blk_idx: np.ndarray, blk_sinvh: np.ndarray, nbf: int) -> np.ndarray:
    out = np.zeros((nbf + 1, nbf + 1))
    for b in range(blk_idx.shape[0]):
        idx = blk_idx[b]
        out[np.ix_(idx, idx)] += blk_sinvh[b]
    return out[:nbf, :nbf]
