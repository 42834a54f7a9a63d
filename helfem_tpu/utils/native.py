"""ctypes bindings for the native (C++) host kernels in csrc/.

The device compute path is JAX/XLA; the host-side runtime kernels (setup-time
integral builders) have native implementations with a numpy fallback, in the
spirit of the reference's C++ core. The library is built on demand with
`make -C csrc`.
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _csrc_dir() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))


def get_lib():
    """Load (building if necessary) libhelfem_tei.so; None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    d = _csrc_dir()
    so = os.path.join(d, "libhelfem_tei.so")
    srcs = [
        os.path.join(d, f) for f in os.listdir(d) if f.endswith((".cpp", ".h"))
    ] + [os.path.join(d, "Makefile")]
    stale = os.path.exists(so) and any(
        os.path.exists(s) and os.path.getmtime(so) < os.path.getmtime(s) for s in srcs
    )
    if not os.path.exists(so) or stale:
        try:
            subprocess.run(["make", "-C", d, "-B"], capture_output=True, timeout=120, check=True)
        except Exception:
            if not os.path.exists(so):
                return None
    try:
        lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.tei_inelement.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, dp,
        ]
        lib.tei_inelement.restype = None
        lib.legendre_pq.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp,
        ]
        lib.legendre_pq.restype = None
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def legendre_pq(Lmax: int, Mmax: int, mu):
    """Native P_l^m/Q_l^m tables at mu = arccosh(xi) points: returns
    (P, Q) of shape [Lmax+1, Mmax+1, npts], or None when the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mu = np.ascontiguousarray(mu, dtype=np.float64)
    npts = mu.shape[0]
    P = np.empty((Lmax + 1, Mmax + 1, npts))
    Q = np.empty_like(P)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.legendre_pq(
        Lmax, Mmax, npts,
        mu.ctypes.data_as(dp), P.ctypes.data_as(dp), Q.ctypes.data_as(dp),
    )
    return P, Q


def tei_inelement(rq, rin, win, wout, Bout, Bin, NL):
    """Native in-element TEI for one element: returns [NL, np, np, np, np]
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nq, nprim = Bout.shape
    out = np.empty((NL, nprim, nprim, nprim, nprim))
    dp = ctypes.POINTER(ctypes.c_double)

    def P(a):
        a = np.ascontiguousarray(a, dtype=np.float64)
        return a, a.ctypes.data_as(dp)

    ka, pa = P(rq)
    kb, pb = P(rin)
    kc, pc = P(win)
    kd, pd = P(wout)
    ke, pe = P(Bout)
    kf, pf = P(Bin)
    lib.tei_inelement(
        nq, nprim, NL, pa, pb, pc, pd, pe, pf, out.ctypes.data_as(dp)
    )
    return out
