// Native associated-Legendre P_l^m / Q_l^m (x > 1) table builder.
//
// Same algorithm as helfem_tpu/ops/legendreq.py (the JAX rebuild of the
// reference's Fortran legendre library, src/legendre/*.f90): upward l
// recursion for P_l^0, exact product identity / Miller downward recursion
// for Q_l^0 (switched per point on theta = arccosh xi), and the
// order-raising relation for the m > 0 columns.  All internal arithmetic
// in `long double` (the numpy path uses np.longdouble); outputs double.
//
// Exposed with a plain C ABI for ctypes; OpenMP over points.

#include <cmath>
#include <vector>

extern "C" {

// Inputs:
//   Lmax, Mmax  table extents (l = 0..Lmax, m = 0..Mmax)
//   npts        number of evaluation points
//   mu          [npts]  mu = arccosh(xi) > 0 (mu keeps accuracy near xi = 1)
// Outputs (row-major [Lmax+1, Mmax+1, npts], matching legendreq.py):
//   P, Q
void legendre_pq(int Lmax, int Mmax, int npts, const double* mu, double* P,
                 double* Q) {
  const int nm = Mmax + 1;
  const size_t stride = (size_t)npts;  // per (l,m) slab
  const long double theta_switch = 3.0L;

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<long double> P0(Lmax + 1), Q0(Lmax + 1);
    // full [l][m] long double tables for the raising recursion
    std::vector<long double> Pt((size_t)(Lmax + 1) * nm, 0.0L);
    std::vector<long double> Qt((size_t)(Lmax + 1) * nm, 0.0L);

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int n = 0; n < npts; n++) {
      const long double m_ = (long double)mu[n];
      const long double xi = coshl(m_);
      const long double sh2 = sinhl(0.5L * m_);
      const long double xim1 = 2.0L * sh2 * sh2;  // xi - 1, no cancellation
      const long double theta = m_;

      // P_l^0 upward
      P0[0] = 1.0L;
      if (Lmax >= 1) P0[1] = xi;
      for (int l = 1; l < Lmax; l++)
        P0[l + 1] = ((2 * l + 1) * xi * P0[l] - l * P0[l - 1]) / (l + 1);

      // Q_0^0 exact
      const long double Q0v = 0.5L * logl((xi + 1.0L) / xim1);
      const int Leff = Lmax > 1 ? Lmax : 1;
      if (theta * Leff < theta_switch) {
        // exact identity Q_l = P_l Q_0 - W_{l-1},
        // W_{l-1} = sum_{k=1}^{l} P_{k-1} P_{l-k} / k
        Q0[0] = Q0v;
        for (int l = 1; l <= Lmax; l++) {
          long double W = 0.0L;
          for (int k = 1; k <= l; k++) W += P0[k - 1] * P0[l - k] / (long double)k;
          Q0[l] = P0[l] * Q0v - W;
        }
      } else {
        // Miller: downward ratio recursion r_l = Q_l / Q_{l-1} seeded r_N = 0
        const double th = theta > 1e-3L ? (double)theta : 1e-3;
        const int pad = (int)std::ceil(24.0 / th) + 10;
        const int N = Lmax + pad;
        std::vector<long double> rs(Lmax + 1);
        long double r = 0.0L;
        for (int l = N; l >= 1; l--) {
          r = (long double)l / ((2 * l + 1) * xi - (l + 1) * r);
          if (l <= Lmax) rs[l] = r;
        }
        Q0[0] = Q0v;
        for (int l = 1; l <= Lmax; l++) Q0[l] = Q0[l - 1] * rs[l];
      }

      // m-raising: sqrt(xi^2-1) f_l^{m+1} = (l-m) xi f_l^m - (l+m) f_{l-1}^m
      for (int l = 0; l <= Lmax; l++) {
        Pt[(size_t)l * nm] = P0[l];
        Qt[(size_t)l * nm] = Q0[l];
        for (int m = 1; m < nm; m++) {
          Pt[(size_t)l * nm + m] = 0.0L;
          Qt[(size_t)l * nm + m] = 0.0L;
        }
      }
      const long double s = sqrtl(xim1 * (xi + 1.0L));
      for (int m = 0; m < Mmax; m++)
        for (int l = m + 1; l <= Lmax; l++) {
          Pt[(size_t)l * nm + m + 1] =
              ((l - m) * xi * Pt[(size_t)l * nm + m] -
               (l + m) * Pt[(size_t)(l - 1) * nm + m]) / s;
          Qt[(size_t)l * nm + m + 1] =
              ((l - m) * xi * Qt[(size_t)l * nm + m] -
               (l + m) * Qt[(size_t)(l - 1) * nm + m]) / s;
        }

      for (int l = 0; l <= Lmax; l++)
        for (int m = 0; m < nm; m++) {
          const size_t o = ((size_t)l * nm + m) * stride + n;
          P[o] = (double)Pt[(size_t)l * nm + m];
          Q[o] = (double)Qt[(size_t)l * nm + m];
        }
    }
  }
}

}  // extern "C"
