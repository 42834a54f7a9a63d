"""Warm-started blocked diatomic eigensolve (scf/diatomic_scf.py:
eig_blocks_dia_b_warm, the fused SCF chunk's eigensolve): seeded with the
previous iteration's whitened eigenvectors it must reproduce the host
LAPACK reference eig_blocks_dia_host, and its residual certificate must
reject a seed that is far off."""

import jax.numpy as jnp
import numpy as np

from helfem_tpu.models.diatomic import DiatomicBasis
from helfem_tpu.scf.diatomic_scf import (eig_blocks_dia_b_warm,
                                         eig_blocks_dia_host,
                                         gather_blocks_dia)


def _basis():
    return DiatomicBasis(Z1=7, Z2=7, Rbond=2.0743, lmax=(3, 3), rmax=15.0,
                         nelem=3, nnodes=6)


def test_warm_refine_matches_lapack():
    b = _basis()
    ops = b.build_operators()
    F = np.asarray(ops.H0)
    E0, C0, V0 = eig_blocks_dia_host(ops, F, return_v=True)
    # a small Fock change, as between late SCF iterations
    F2 = F + 1e-7 * np.asarray(ops.S)
    E, C, V, good = eig_blocks_dia_b_warm(
        ops, gather_blocks_dia(ops, jnp.asarray(F2)), jnp.asarray(V0), 1e-9)
    assert bool(good), "certificate must accept a near seed"
    E2, C2 = eig_blocks_dia_host(ops, F2)
    assert np.abs(np.asarray(E) - E2).max() < 1e-9
    # accepted V stays orthonormal
    VtV = np.einsum("bpi,bpj->bij", np.asarray(V), np.asarray(V))
    eye = np.eye(V0.shape[-1])[None]
    assert np.abs(VtV - eye).max() < 1e-10


def test_warm_refine_reports_bad_seed():
    b = _basis()
    ops = b.build_operators()
    F = np.asarray(ops.H0)
    nblk, blen = np.asarray(ops.blk_idx).shape
    V0 = jnp.broadcast_to(jnp.eye(blen), (nblk, blen, blen))
    E, _, _, good = eig_blocks_dia_b_warm(
        ops, gather_blocks_dia(ops, jnp.asarray(F)), V0, 1e-9)
    assert not bool(good), "identity seed must fail the certificate"
    # the cold fallback still returns the exact spectrum
    assert np.abs(np.asarray(E) - eig_blocks_dia_host(ops, F)[0]).max() < 1e-9
