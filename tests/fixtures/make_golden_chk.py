"""Generate the golden reference-layout checkpoint fixtures.

These fixtures stand in for files produced by the upstream HelFEM binaries
(which cannot be built in this image: no Fortran compiler / Armadillo
headers / GSL, see BASELINE.md). The HDF5 layout is assembled here with
RAW h5py calls that replicate the reference ``Checkpoint`` class's HDF5
call sequence one-to-one (ref: src/general/checkpoint.cpp):

- ``arma::mat``:    dataset dims[0]=n_cols, dims[1]=n_rows; the written
                    buffer is the column-major matrix memory
                    (checkpoint.cpp:117-152) -> h5py data = M.T (C-order).
- ``arma::vec``:    binds the mat overload as an n x 1 column -> (1, n).
- ``arma::ivec``:   imat overload with dims (n_rows, n_cols) of native int
                    (checkpoint.cpp:219-258) -> (n, 1) int32.
- scalars:          H5S_SCALAR datasets of native int / double
                    (checkpoint.cpp:632-740).

Dataset names and set follow what the reference mains leave in the file at
convergence (basis serialization checkpoint.cpp:477-508 / 560-588; SCF
state src/atomic/main.cpp:233-966, src/diatomic/main.cpp:236-963).

The physical content is a converged SCF state of this repo's own solver at
the same discretization (the reference binary being unbuildable), which is
exactly what the interop test needs: the READER must reconstruct the basis
and warm-start from a file whose bytes this repo's writer did not produce.

Run from the repo root (CPU):
    JAX_PLATFORMS=cpu python tests/fixtures/make_golden_chk.py
The generated .chk files are committed; tests/test_checkpoint_h5.py loads
them and must keep passing bit-for-bit.
"""

import os

import h5py
import numpy as np


def w_mat(f, name, M):
    """arma::mat write: dims (n_cols, n_rows), column-major buffer."""
    M = np.asarray(M, dtype=np.float64)
    f.create_dataset(name, data=np.ascontiguousarray(M.T), dtype="<f8")


def w_vec(f, name, v):
    """arma::vec write (n x 1 column bound to the mat overload)."""
    v = np.asarray(v, dtype=np.float64).reshape(-1, 1)
    f.create_dataset(name, data=np.ascontiguousarray(v.T), dtype="<f8")


def w_ivec(f, name, v):
    """arma::ivec write: imat dims (n_rows, n_cols) of native int."""
    v = np.asarray(v, dtype=np.int32).reshape(-1, 1)
    f.create_dataset(name, data=v, dtype="<i4")


def w_int(f, name, x):
    f.create_dataset(name, data=np.int32(x))  # H5S_SCALAR native int


def w_float(f, name, x):
    f.create_dataset(name, data=np.float64(x))  # H5S_SCALAR native double


def _global_from_blocks(nbf, blocks, C_blocks, E_blocks, occ):
    """Dense energy-sorted global orbital matrix, eigenvalue vector, and
    density from padded per-block orbitals (independent re-derivation; the
    reference stores global column matrices sorted per symmetry... its
    mains concatenate per-block solutions in ascending-eigenvalue order)."""
    C_blocks = np.asarray(C_blocks)
    E_blocks = np.asarray(E_blocks)
    occ = np.asarray(occ)
    cols, evals, occs = [], [], []
    for b, idx in enumerate(blocks):
        n = len(idx)
        for k in range(n):
            if E_blocks[b, k] > 1e5:
                continue
            col = np.zeros(nbf)
            col[np.asarray(idx)] = C_blocks[b, : n, k]
            cols.append(col)
            evals.append(E_blocks[b, k])
            occs.append(occ[b, k])
    order = np.argsort(np.asarray(evals), kind="stable")
    C = np.stack(cols, axis=1)[:, order]
    E = np.asarray(evals)[order]
    focc = np.asarray(occs)[order]
    P = (C * focc[None, :]) @ C.T
    return C, E, P


def make_atomic(path):
    """He HF, lmax=1 (three angular shells), nelem=4, nnodes=6: the
    smallest atomic case that exercises multi-shell lval/mval round-trip."""
    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.scf.atomic_scf import scf_atom
    from helfem_tpu.utils.linalg import form_sh, form_sinvh

    basis = AtomicBasis(Z=2, lmax=1, mmax=1, rmax=30.0, nelem=4, nnodes=6)
    res = scf_atom(basis, 1, 1, convthr=1e-9, maxit=50)
    assert res.converged, "fixture SCF did not converge"
    symm = res.symm_used if res.symm_used is not None else 2
    blocks = basis.sym_blocks(symm)
    nbf = basis.nbf
    S = basis.overlap()
    T = basis.kinetic()
    V = basis.nuclear()
    Ca, Ea, Pa = _global_from_blocks(nbf, blocks, res.orbs_a,
                                     res.orbE_blocks_a, res.occ_a)

    # block-diagonal Sinvh exactly as the reference stores it (per
    # symmetry block, zero off-blocks: scf_helpers.cpp Sinvh per m)
    Sinvh = np.zeros((nbf, nbf))
    for idx in blocks:
        ix = np.ix_(np.asarray(idx), np.asarray(idx))
        Sinvh[ix] = form_sinvh(S[ix])

    with h5py.File(path, "w", libver="earliest") as f:
        # basis serialization (ref checkpoint.cpp:477-508)
        w_int(f, "HelFEM_ID", 1)
        w_int(f, "Z", 2)
        w_int(f, "Zl", 0)
        w_int(f, "Zr", 0)
        w_float(f, "Rhalf", 0.0)
        w_vec(f, "bval", basis.rb.fem.bval)
        w_int(f, "finitenuc", 0)  # point nucleus
        w_float(f, "Rrms", 0.0)
        w_int(f, "n_quad", basis.nquad)
        w_int(f, "poly_id", basis.primbas)
        w_int(f, "poly_nnodes", basis.nnodes)
        w_int(f, "zeroder", 0)
        # the reference resolves taylor_order=-1 to nprim-1 before the
        # basis is built and stores the resolved value
        # (src/atomic/main.cpp:252-253)
        w_int(f, "taylor_order", basis.nnodes - 1)
        w_ivec(f, "lval", basis.lval)
        w_ivec(f, "mval", basis.mval)
        # SCF state (ref src/atomic/main.cpp:233-966)
        w_int(f, "nela", 1)
        w_int(f, "nelb", 1)
        w_mat(f, "S", S)
        w_mat(f, "T", T)
        w_mat(f, "Vuc", V)  # [sic] ref src/atomic/main.cpp:468
        w_mat(f, "Vconf", np.zeros_like(S))
        w_mat(f, "H0", T + V)
        w_mat(f, "Sinvh", Sinvh)
        w_mat(f, "Sh", form_sh(S))
        w_mat(f, "Ca", Ca)
        w_mat(f, "Cb", Ca)
        w_vec(f, "Ea", Ea)
        w_vec(f, "Eb", Ea)
        w_mat(f, "Pa", Pa)
        w_mat(f, "Pb", Pa)
        w_mat(f, "P", 2.0 * Pa)
    return res.E


def make_diatomic(path):
    """H2 HF at lmax=(2,2), nelem=3, nnodes=6 (gerade/ungerade blocks,
    sigma+pi shells). Matrices are stored in the reference's compacted
    pure-function layout (first radial function of every m != 0 shell
    dropped, ref src/diatomic/basis.cpp:461-472)."""
    from helfem_tpu.models.diatomic import DiatomicBasis
    from helfem_tpu.scf.diatomic_scf import scf_diatomic
    from helfem_tpu.utils.linalg import form_sh, form_sinvh

    basis = DiatomicBasis(Z1=1, Z2=1, Rbond=1.4, lmax=(2, 2), rmax=20.0,
                          nelem=3, nnodes=6)
    res = scf_diatomic(basis, 1, 1, method="HF", convthr=1e-9, maxit=50)
    assert res.converged, "fixture SCF did not converge"
    nbf_pad = basis.nbf
    keep = np.nonzero(basis.shell_mask().reshape(-1).astype(bool))[0]
    nblk = np.asarray(res.orbE_blocks_a).shape[0]
    parity = len(basis.sym_blocks(True)) == nblk
    blocks = basis.sym_blocks(parity)
    mvv = basis.shell_mask().reshape(-1)

    def compact(M):
        M = M * mvv[:, None] * mvv[None, :]
        return M[np.ix_(keep, keep)]

    S = compact(basis.overlap())
    Ca_pad, Ea, Pa_pad = _global_from_blocks(nbf_pad, blocks, res.orbs_a,
                                             res.orbE_blocks_a, res.occ_a)
    Ca = Ca_pad[keep]
    Pa = Pa_pad[np.ix_(keep, keep)]
    Sinvh = np.zeros((len(keep), len(keep)))
    for idx in blocks:
        ix = np.searchsorted(keep, np.asarray(idx))
        Sinvh[np.ix_(ix, ix)] = form_sinvh(S[np.ix_(ix, ix)])

    with h5py.File(path, "w", libver="earliest") as f:
        # basis serialization (ref checkpoint.cpp:560-588)
        w_int(f, "HelFEM_ID", 2)
        w_int(f, "Z1", 1)
        w_int(f, "Z2", 1)
        w_float(f, "Rhalf", basis.Rhalf)
        w_vec(f, "bval", basis.fem.bval)
        w_int(f, "n_quad", basis.nquad)
        w_int(f, "poly_id", basis.primbas)
        w_int(f, "poly_nnodes", basis.nnodes)
        w_ivec(f, "lval", basis.lval)
        w_ivec(f, "mval", basis.mval)
        # SCF state (ref src/diatomic/main.cpp:236-963)
        w_int(f, "nela", 1)
        w_int(f, "nelb", 1)
        w_float(f, "Enucr", basis.Z1 * basis.Z2 / basis.Rbond)
        w_mat(f, "S", S)
        w_mat(f, "T", compact(basis.kinetic()))
        w_mat(f, "Vnuc", compact(basis.nuclear()))
        w_mat(f, "Sinvh", Sinvh)
        w_mat(f, "Sh", form_sh(S))
        w_mat(f, "Ca", Ca)
        w_mat(f, "Cb", Ca)
        w_vec(f, "Ea", Ea)
        w_vec(f, "Eb", Ea)
        w_mat(f, "Pa", Pa)
        w_mat(f, "Pb", Pa)
        w_mat(f, "P", 2.0 * Pa)
    return res.E


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    e_at = make_atomic(os.path.join(here, "he_hf_ref_layout.chk"))
    e_di = make_diatomic(os.path.join(here, "h2_hf_ref_layout.chk"))
    print(f"he_hf_ref_layout.chk  E = {e_at:.12f}")
    print(f"h2_hf_ref_layout.chk  E = {e_di:.12f}")
