"""TEI quadrature-convergence scan (reference: src/diatomic/qtest.cpp:31 --
stale and unbuilt upstream; this is the working JAX-rebuild equivalent).

Doubles the per-element quadrature order nquad and reports the max-abs
change of the one-electron matrices (S, T, Vnuc) and of the in-element
two-electron tables between consecutive orders, demonstrating quadrature
convergence of the double-quadrature TEI kernels
(models/diatomic.py:compute_tei).

Usage: python scripts/qtest.py [--Z1 1] [--Z2 1] [--Rbond 1.4]
                               [--lmax 2] [--nelem 3] [--nnodes 6]
                               [--nq0 10] [--doublings 4]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--Z1", type=int, default=1)
    p.add_argument("--Z2", type=int, default=1)
    p.add_argument("--Rbond", type=float, default=1.4)
    p.add_argument("--lmax", type=int, default=2)
    p.add_argument("--rmax", type=float, default=10.0)
    p.add_argument("--nelem", type=int, default=3)
    p.add_argument("--nnodes", type=int, default=6)
    p.add_argument("--nq0", type=int, default=10)
    p.add_argument("--doublings", type=int, default=4)
    args = p.parse_args(argv)

    from helfem_tpu.models.diatomic import DiatomicBasis

    prev = None
    nq = args.nq0
    print(f"{'nquad':>7s} {'dS':>10s} {'dT':>10s} {'dV':>10s} {'dTEI':>10s}")
    for _ in range(args.doublings + 1):
        basis = DiatomicBasis(Z1=args.Z1, Z2=args.Z2, Rbond=args.Rbond,
                              lmax=(args.lmax,), rmax=args.rmax,
                              nelem=args.nelem, nnodes=args.nnodes, nquad=nq)
        S = np.asarray(basis.overlap())
        T = np.asarray(basis.kinetic())
        V = np.asarray(basis.nuclear())
        teiJ, *_ = basis.compute_tei(k_layout=False)
        cur = (S, T, V, np.asarray(teiJ))
        if prev is not None:
            ds, dt, dv, dtei = (np.abs(a - b).max() for a, b in zip(cur, prev))
            print(f"{nq:7d} {ds:10.3e} {dt:10.3e} {dv:10.3e} {dtei:10.3e}")
        else:
            print(f"{nq:7d} {'-':>10s} {'-':>10s} {'-':>10s} {'-':>10s}")
        prev = cur
        nq *= 2


if __name__ == "__main__":
    main()
