"""JAX-native exchange-correlation functionals (L6).

Replaces libxc (reference: src/general/dftfuncs.cpp dispatches into libxc's
xc_lda/gga/mgga_exc_vxc, src/atomic/dftgrid.cpp:416-492). Each functional is a
pure-jnp energy density f(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb) -> e
(energy per unit volume); ALL potential terms (vrho, vsigma) come from one
reverse-mode autodiff pass (jax.vjp), which by construction matches the
energy exactly -- no hand-derived derivative code to get wrong.

Implemented: Slater exchange, VWN5 and PW92 correlation (LDA); PBE exchange
and correlation (GGA). Formulas from the original publications (Vosko-Wilk-
Nusair 1980; Perdew-Wang 1992; Perdew-Burke-Ernzerhof 1996).

Density threshold: points with rho < thr are masked out of energies and
potentials (libxc's dens_threshold convention, dftgrid.cpp:428).
"""

from functools import lru_cache
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["Functional", "MethodSpec", "get_functional", "xc_eval", "parse_method", "parse_method_rs"]

_TINY = 1e-30


def _clip_zeta(zeta):
    # keep |zeta| strictly below 1: phi = (1 -+ zeta)^{2/3} has an infinite
    # rho-derivative at zeta = +-1 (reached exactly when one spin density
    # rounds away), which would poison the autodiff potentials with NaNs
    return jnp.clip(zeta, -1.0 + 1e-15, 1.0 - 1e-15)


class Functional(NamedTuple):
    name: str
    family: str  # 'lda', 'gga' or 'mgga'
    f: Callable  # (ra, rb, saa, sab, sbb[, ta, tb], **params) -> energy per volume
    params: tuple = ()  # sorted ((key, value), ...) overrides, hashable
    # (reference: libxc ext_params via --x_pars/--c_pars, src/atomic/main.cpp:107-108)


# ----------------------------------------------------------------------------
# LDA exchange (Slater/Dirac)
# ----------------------------------------------------------------------------


def _ex_slater(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0):
    cx = -0.75 * (6.0 / jnp.pi) ** (1.0 / 3.0)
    return cx * (ra ** (4.0 / 3.0) + rb ** (4.0 / 3.0))


def _sr_lda_factor(a):
    """Short-range attenuation of the LDA exchange hole for the erf-split
    interaction (Gill-Adamson-Pople 1996 / Toulouse-Savin): the kept part is
    erfc(omega r12)/r12. a = omega / (2 kF). Evaluated directly for small a
    and by its large-a series (f -> 1/(36 a^2)) where the closed form loses
    all significance to cancellation."""
    a = jnp.maximum(a, 1e-10)
    asafe = jnp.minimum(a, 8.0)
    t = 1.0 / (2.0 * asafe)
    direct = 1.0 - (8.0 * asafe / 3.0) * (
        jnp.sqrt(jnp.pi) * jax.scipy.special.erf(t)
        + (2.0 * asafe - 4.0 * asafe**3) * jnp.exp(-(t * t))
        - 3.0 * asafe
        + 4.0 * asafe**3
    )
    abig = jnp.maximum(a, 8.0)
    series = 1.0 / (36.0 * abig * abig) - 1.0 / (960.0 * abig**4)
    return jnp.where(a < 8.0, direct, series)


def _ex_slater_erf(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0, *, omega=0.5):
    """Short-range (erfc-kernel) LDA exchange: the semilocal complement used
    by LC-type range-separated hybrids (libxc lda_x_erf analogue). Exact
    spin scaling E[ra, rb] = (E[2 ra] + E[2 rb]) / 2."""
    cx = -0.75 * (3.0 / jnp.pi) ** (1.0 / 3.0)

    def one(r):
        r2 = 2.0 * r
        kf = (3.0 * jnp.pi**2 * jnp.maximum(r2, _TINY)) ** (1.0 / 3.0)
        f = _sr_lda_factor(omega / (2.0 * kf))
        return 0.5 * cx * r2 ** (4.0 / 3.0) * f

    return one(ra) + one(rb)


# ----------------------------------------------------------------------------
# VWN5 correlation
# ----------------------------------------------------------------------------


def _vwn_F(x, A, x0, b, c):
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = jnp.sqrt(4.0 * c - b * b)
    atn = jnp.arctan(Q / (2.0 * x + b))
    return A * (
        jnp.log(x * x / X)
        + 2.0 * b / Q * atn
        - b * x0 / X0 * (jnp.log((x - x0) ** 2 / X) + 2.0 * (b + 2.0 * x0) / Q * atn)
    )


def _ec_vwn5(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0):
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    rs = (3.0 / (4.0 * jnp.pi * rho)) ** (1.0 / 3.0)
    x = jnp.sqrt(rs)
    ecP = _vwn_F(x, 0.0310907, -0.10498, 3.72744, 12.9352)
    ecF = _vwn_F(x, 0.01554535, -0.32500, 7.06042, 18.0578)
    ac = _vwn_F(x, -1.0 / (6.0 * jnp.pi**2), -0.00475840, 1.13107, 13.0045)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
    )
    fpp0 = 8.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))
    z4 = zeta**4
    ec = ecP + ac * fz / fpp0 * (1.0 - z4) + (ecF - ecP) * fz * z4
    return ec * rho


# ----------------------------------------------------------------------------
# PW92 correlation
# ----------------------------------------------------------------------------


def _pw92_G(rs, A, a1, b1, b2, b3, b4, p):
    srs = jnp.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs ** (p + 1.0))
    return -2.0 * A * (1.0 + a1 * rs) * jnp.log(1.0 + 1.0 / den)


def _ec_pw92_eps(rho, zeta):
    rs = (3.0 / (4.0 * jnp.pi * rho)) ** (1.0 / 3.0)
    ec0 = _pw92_G(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294, 1.0)
    ec1 = _pw92_G(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517, 1.0)
    mac = _pw92_G(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671, 1.0)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
    )
    fpp0 = 1.709920934161365617563962776245
    z4 = zeta**4
    return ec0 - mac * fz / fpp0 * (1.0 - z4) + (ec1 - ec0) * fz * z4


def _ec_pw92(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0):
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    return _ec_pw92_eps(rho, zeta) * rho


# ----------------------------------------------------------------------------
# PBE exchange
# ----------------------------------------------------------------------------


def _ex_pbe(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0, *,
            kappa=0.804, mu=0.2195149727645171):

    def exs(r2, s2x4):
        # E_x[rho] for the closed-shell density 2*rho_s with sigma 4*sigma_ss.
        # Range-safe form (every intermediate within ~1e+-38): the
        # reduced gradient is built from n^(-4/3) FACTORS (value <= 1e16,
        # first derivative <= 1e28 for n >= 1e-12) instead of dividing by
        # 4 kf^2 n^2 (~1e-22 in the tail), whose vjp squares the denominator
        # and overflows to inf on device.
        kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
        r13 = r2 ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r13 / (4.0 * jnp.pi)
        inv43 = r2 ** (-4.0 / 3.0)
        s2 = (s2x4 * inv43) * inv43 / (4.0 * kf1**2)
        Fx = 1.0 + kappa - kappa / (1.0 + mu * s2 / kappa)
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa) + exs(2.0 * rb, 4.0 * sbb))


def _ex_rpbe(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0, *,
             kappa=0.804, mu=0.2195149727645171):
    # RPBE (Hammer, Hansen, Norskov, PRB 59, 7413 (1999)): same UEG limit,
    # small-s expansion, and Lieb-Oxford-motivated 1+kappa bound as PBE,
    # but the enhancement saturates exponentially:
    # Fx = 1 + kappa (1 - exp(-mu s^2 / kappa)).
    def exs(r2, s2x4):
        kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
        r13 = r2 ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r13 / (4.0 * jnp.pi)
        inv43 = r2 ** (-4.0 / 3.0)
        s2 = (s2x4 * inv43) * inv43 / (4.0 * kf1**2)
        Fx = 1.0 + kappa * (1.0 - jnp.exp(-mu * s2 / kappa))
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa) + exs(2.0 * rb, 4.0 * sbb))


# ----------------------------------------------------------------------------
# PBE correlation
# ----------------------------------------------------------------------------


def _ec_pbe(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0, *,
            beta=0.06672455060314922):
    gamma = (1.0 - jnp.log(2.0)) / jnp.pi**2
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    eps = _ec_pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    sigma = saa + 2.0 * sab + sbb
    # t2 = sigma / (4 phi^2 ks^2 rho^2) with ks^2 = 4 kf / pi, built from
    # range-safe factors (within ~1e+-38, see _ex_pbe):
    # sigma * rho^(-4/3) stays ~O(1) in exponential tails, rho^(-1) <= 1e12.
    kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
    inv43 = rho ** (-4.0 / 3.0)
    t2 = (sigma * inv43) / rho * (jnp.pi / (16.0 * kf1)) / (phi * phi)
    expo = jnp.exp(-eps / (gamma * phi**3))
    A = beta / gamma / (expo - 1.0 + _TINY)
    # (1 + u)/(1 + u + u^2) rewritten as 1/(1 + u^2/(1+u)): the direct form's
    # quotient vjp squares a denominator that reaches ~1e28 near the density
    # threshold, outside the ~1e+-38 range kept here (see _ex_pbe)
    u = A * t2
    ratio = 1.0 / (1.0 + (u / (1.0 + u)) * u)
    H = gamma * phi**3 * jnp.log(1.0 + beta / gamma * t2 * ratio)
    return (eps + H) * rho


# ----------------------------------------------------------------------------
# B88 exchange
# ----------------------------------------------------------------------------


def _ex_b88(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0, *, beta=0.0042):
    """Becke 1988 gradient-corrected exchange."""

    def exs(r, s):
        r43 = r ** (4.0 / 3.0)
        # x = |grad rho| / rho^(4/3) via a multiplicative inverse power
        # (range-safe, see _ex_pbe);
        # the 1e-30 sigma floor keeps sqrt's derivative finite at sigma = 0
        x = jnp.sqrt(jnp.maximum(s, 0.0) + 1e-30) * r ** (-4.0 / 3.0)
        corr = -beta * r43 * x * x / (1.0 + 6.0 * beta * x * jnp.arcsinh(x))
        lda = -0.75 * (6.0 / jnp.pi) ** (1.0 / 3.0) * r43
        return lda + corr

    return exs(ra, saa) + exs(rb, sbb)


# ----------------------------------------------------------------------------
# LYP correlation (Miehlich et al. reformulation)
# ----------------------------------------------------------------------------


def _ec_lyp(ra, rb, saa, sab, sbb, ta=0.0, tb=0.0):
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    CF = 0.3 * (3.0 * jnp.pi**2) ** (2.0 / 3.0)
    rho = ra + rb
    r13 = rho ** (-1.0 / 3.0)
    den = 1.0 + d * r13
    delta = c * r13 + d * r13 / den
    sigma = saa + 2.0 * sab + sbb
    t1 = -a * 4.0 / den * (ra / rho) * rb
    # The omega * (ra rb t2 + t3) term is algebraically refactored so the
    # rho^(-11/3) weight multiplies each piece through O(1) spin ratios and
    # rho^(-4/3)/rho^(-1/3) factors -- rho^(-11/3) itself leaves the
    # ~1e+-38 range kept here in exponential tails (see _ex_pbe).
    xa, xb = ra / rho, rb / rho
    inv43 = rho ** (-4.0 / 3.0)

    def m53(q):  # q * rho^(-5/3), range-safe
        return (q * inv43) * r13

    T2 = (
        2.0 ** (11.0 / 3.0) * CF * (xa ** (8.0 / 3.0) + xb ** (8.0 / 3.0)) * rho
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * m53(sigma)
        - (2.5 - delta / 18.0) * m53(saa + sbb)
        - (delta - 11.0) / 9.0 * m53(xa * saa + xb * sbb)
    )
    T3 = (
        -2.0 / 3.0 * m53(sigma)
        + (2.0 / 3.0 - xa * xa) * m53(sbb)
        + (2.0 / 3.0 - xb * xb) * m53(saa)
    )
    omega0 = jnp.exp(-c * r13) / den
    return t1 - a * b * omega0 * (xa * xb * T2 + T3)


# ----------------------------------------------------------------------------
# TPSS meta-GGA (Tao-Perdew-Staroverov-Scuseria 2003)
# ----------------------------------------------------------------------------


def _tpss_Fx(p, z, alpha):
    """TPSS exchange enhancement factor, eqs. (5)-(10) of PRL 91, 146401."""
    kappa = 0.804
    b = 0.40
    c = 1.59096
    e = 1.537
    mu = 0.21951
    qb = 0.45 * (alpha - 1.0) / jnp.sqrt(1.0 + b * alpha * (alpha - 1.0)) + 2.0 * p / 3.0
    z2 = z * z
    num = (
        (10.0 / 81.0 + c * z2 / (1.0 + z2) ** 2) * p
        + 146.0 / 2025.0 * qb * qb
        - 73.0 / 405.0 * qb * jnp.sqrt(0.5 * (0.6 * z) ** 2 + 0.5 * p * p + 1e-30)
        + (1.0 / kappa) * (10.0 / 81.0) ** 2 * p * p
        + 2.0 * jnp.sqrt(e) * (10.0 / 81.0) * (0.6 * z) ** 2
        + e * mu * p**3
    )
    # divide by (1 + sqrt(e) p) twice: squaring the denominator first would
    # leave the ~1e+-38 range in the quotient's vjp for tail-sized p (see
    # _ex_pbe)
    den = 1.0 + jnp.sqrt(e) * p
    x = (num / den) / den
    return 1.0 + kappa - kappa / (1.0 + x / kappa)


def _ex_tpss(ra, rb, saa, sab, sbb, ta, tb):
    def exs(r2, s4, t2):
        # closed-shell quantities for the 2*rho_s density; reduced variables
        # built from n^(-k/3) factors (k <= 5) so primal values and first
        # derivatives stay inside ~1e+-38 for n >= 1e-12 (see _ex_pbe)
        kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * jnp.pi)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)  # von Weizsaecker
        tau = jnp.maximum(t2, tw + _TINY)
        # z = tw/tau through tunif-scaled ratios: both scale like n^(5/3) in
        # the tail, so the bare quotient's vjp squares a ~1e-20 denominator
        # and leaves the ~1e+-38 range (see _ex_pbe)
        tws = tw * inv53
        taus = tau * inv53
        z = jnp.clip(tws / jnp.maximum(taus, jnp.maximum(tws, 1e-15)), 0.0, 1.0)
        alpha = jnp.maximum((tau - tw) * inv53 / (0.3 * kf1**2), 0.0)
        return r2 * exu * _tpss_Fx(p, z, alpha)

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _ec_tpss(ra, rb, saa, sab, sbb, ta, tb):
    """TPSS correlation: revPKZB with the z^3 self-interaction correction."""
    d = 2.8
    rho = ra + rb
    tau = ta + tb
    sigma = saa + 2.0 * sab + sbb
    tw = sigma / (8.0 * rho + _TINY)
    # z = tw/tau via tunif-scaled ratios (range safety, see _ex_tpss)
    inv53 = rho ** (-5.0 / 3.0)
    tws = tw * inv53
    taus = jnp.maximum(tau, tw + _TINY) * inv53
    z = jnp.clip(tws / jnp.maximum(taus, jnp.maximum(tws, 1e-15)), 0.0, 1.0)
    zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-14, 1.0 - 1e-14)
    # C(zeta, xi)
    C0 = 0.53 + 0.87 * zeta**2 + 0.50 * zeta**4 + 2.26 * zeta**6
    # |grad zeta|^2 from O(1) spin ratios and one rho^-2 factor (range-safe;
    # rho^4 underflows in the tail)
    xa, xb = ra / rho, rb / rho
    gz2 = 4.0 * (xb * xb * saa - 2.0 * xa * xb * sab + xa * xa * sbb) * rho ** (-2.0)
    kf = (3.0 * jnp.pi**2 * rho) ** (1.0 / 3.0)
    xi2 = gz2 / (4.0 * kf**2 + _TINY)
    fz = 0.5 * ((1.0 + zeta) ** (-4.0 / 3.0) + (1.0 - zeta) ** (-4.0 / 3.0))
    # (1 + xi2 fz)^4 can exceed ~1e38 when one spin channel vanishes; the
    # log1p form underflows gracefully to C = 0
    C = C0 * jnp.exp(-4.0 * jnp.log1p(xi2 * fz))
    # epsilon_c^PBE of the full density (per particle)
    eps = _ec_pbe(ra, rb, saa, sab, sbb) / rho
    # per-spin fully polarized PBE epsilon, tilde constraint. The inputs are
    # floored at 1e-12: a vanishing spin density enters sumterm with weight
    # rho_s/rho -> 0 anyway, while autodiff through the PBE kernel at
    # rho ~ 1e-30 under XLA fusion produces NaNs.
    ra_s = jnp.maximum(ra, 1e-12)
    rb_s = jnp.maximum(rb, 1e-12)
    epsa = _ec_pbe(ra_s, _TINY, saa, 0.0, 0.0) / ra_s
    epsb = _ec_pbe(rb_s, _TINY, sbb, 0.0, 0.0) / rb_s
    epsta = jnp.maximum(epsa, eps)
    epstb = jnp.maximum(epsb, eps)
    sumterm = (ra * epsta + rb * epstb) / rho
    epsrev = eps * (1.0 + C * z * z) - (1.0 + C) * z * z * sumterm
    return rho * epsrev * (1.0 + d * epsrev * z**3)


# ----------------------------------------------------------------------------
# SCAN meta-GGA (Sun-Ruzsinszky-Perdew, PRL 115, 036402 (2015))
# ----------------------------------------------------------------------------


def _scan_falpha(alpha, c1, c2, d):
    """SCAN's iso-orbital interpolation f(alpha): exp(-c1 a/(1-a)) below
    a = 1, -d exp(c2/(1-a)) above. Both branches get range-clamped safe
    inputs so the inactive branch's vjp stays finite (the active branch's
    exponential underflows to an exact 0 before the 1/(1-a)^2 quotient
    factor can leave the ~1e+-38 range)."""
    a_lo = jnp.clip(alpha, 0.0, 1.0 - 1e-9)
    lo = jnp.exp(-c1 * a_lo / (1.0 - a_lo))
    a_hi = jnp.maximum(alpha, 1.0 + 1e-9)
    hi = -d * jnp.exp(c2 / (1.0 - a_hi))
    return jnp.where(alpha < 1.0, lo, hi)


def _ex_scan(ra, rb, saa, sab, sbb, ta, tb, *, k1=0.065, k0=0.174):
    """SCAN exchange. Constants from the PRL 115, 036402 supplement; the
    gradient-expansion block (b1..b4) is built from its exact fractions.
    alpha = 0 gives F_x = (1 + k0) g_x(p), which makes the hydrogen-atom
    exchange energy exactly -5/16 Eh (tested)."""
    muak = 10.0 / 81.0
    b2 = (5913.0 / 405000.0) ** 0.5
    b1 = (511.0 / 13500.0) / (2.0 * b2)
    b3 = 0.5
    b4 = muak * muak / k1 - 1606.0 / 18225.0 - b1 * b1
    a1 = 4.9479
    c1x, c2x, dx = 0.667, 0.8, 1.24
    h0x = 1.0 + k0

    def exs(r2, s4, t2):
        # reduced variables from n^(-k/3) FACTORS; see _ex_pbe/_ex_tpss for
        # the range analysis
        kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * jnp.pi)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)
        tau = jnp.maximum(t2, tw + _TINY)
        alpha = jnp.maximum((tau - tw) * inv53 / (0.3 * kf1**2), 0.0)
        oma = 1.0 - alpha
        x = muak * p * (1.0 + (b4 * p / muak) * jnp.exp(-jnp.abs(b4) * p / muak)) + (
            b1 * p + b2 * oma * jnp.exp(-b3 * oma * oma)
        ) ** 2
        # h1x saturates at 1 + k1 for x >> k1; cap x so the quotient's vjp
        # (which squares 1 + x/k1) stays within ~1e+-38 in far tails where
        # x reaches ~1e19. The cap changes h1x
        # by < k1^2/x ~ 4e-11 and zeroes an already ~1e-20 gradient.
        x = jnp.minimum(x, 1e8)
        h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
        fx = _scan_falpha(alpha, c1x, c2x, dx)
        # g_x = 1 - exp(-a1 p^(-1/4)): floor p so the vjp's p^(-5/4) factor
        # stays below the f32-exponent overflow while the exponential itself
        # has long underflowed to an exact zero
        pf = jnp.maximum(p, 1e-20)
        gx = 1.0 - jnp.exp(-a1 / jnp.sqrt(jnp.sqrt(pf)))
        Fx = (h1x + fx * (h0x - h1x)) * gx
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _ec_scan(ra, rb, saa, sab, sbb, ta, tb):
    """SCAN correlation: single-orbital (alpha=0) and slowly-varying
    (alpha=1) limits interpolated by f_c(alpha). Exactly zero for any fully
    spin-polarized one-electron density (alpha = 0, zeta = 1 -> g_c = 0),
    which is tested against a hydrogenic density."""
    c1c, c2c, dc = 0.64, 1.5, 0.7
    b1c, b2c, b3c = 0.0285764, 0.0889, 0.125541
    chi_inf = 0.128026
    gamma = 0.031091

    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    sigma = saa + 2.0 * sab + sbb
    tau = ta + tb
    kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
    inv43 = rho ** (-4.0 / 3.0)
    inv53 = rho ** (-5.0 / 3.0)
    rs = (3.0 / (4.0 * jnp.pi)) ** (1.0 / 3.0) * rho ** (-1.0 / 3.0)
    p = (sigma * inv43) * inv43 / (4.0 * kf1**2)
    tw = sigma / (8.0 * rho + _TINY)
    ds = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    taus = jnp.maximum(tau, tw + _TINY)
    alpha = jnp.maximum((taus - tw) * inv53 / (0.3 * kf1**2 * ds), 0.0)

    # alpha = 1 limit: PW92 + the SCAN gradient correction H1 (g = (1+4y)^-1/4
    # hole damping, rs-dependent beta)
    eps_lsda = _ec_pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    phi3 = phi * phi * phi
    t2 = (sigma * inv43) / rho * (jnp.pi / (16.0 * kf1)) / (phi * phi)
    w1 = jnp.expm1(-eps_lsda / (gamma * phi3))
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    y = beta_rs / (gamma * (w1 + _TINY)) * t2
    g = (1.0 + 4.0 * y) ** (-0.25)
    H1 = gamma * phi3 * jnp.log1p(w1 * (1.0 - g))
    eps1 = eps_lsda + H1

    # alpha = 0 limit: single-orbital LDA0 + H0, spin factor g_c(zeta)
    eps_lda0 = -b1c / (1.0 + b2c * jnp.sqrt(rs) + b3c * rs)
    w0 = jnp.expm1(-eps_lda0 / b1c)
    ginf = (1.0 + 4.0 * chi_inf * p) ** (-0.25)
    H0 = b1c * jnp.log1p(w0 * (1.0 - ginf))
    dxz = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gcz = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - zeta**12)
    eps0 = (eps_lda0 + H0) * gcz

    fc = _scan_falpha(alpha, c1c, c2c, dc)
    return rho * (eps1 + fc * (eps0 - eps1))


# ----------------------------------------------------------------------------
# rSCAN meta-GGA (Bartok-Yates, JCP 150, 161101 (2019)): SCAN with a
# regularized iso-orbital indicator and polynomial interpolation functions
# (removes SCAN's numerical pathologies around alpha = 1 on sparse grids)
# ----------------------------------------------------------------------------

# Degree-7 interpolation polynomials replacing SCAN's exponentials on
# [0, 2.5). VERIFIED against their defining conditions (scripts run in-tree):
# coefficients 0-2 equal the Taylor expansion of exp(-c1 a/(1-a)) at a=0
# (1, -c1, c1^2/2 - c1 exactly), and value/1st/2nd derivative match the
# -d exp(c2/(1-a)) branch at a = 2.5 to 1e-9.
_RSCAN_CX = (1.0, -0.667, -0.4445555, -0.663086601049, 1.451297044490,
             -0.887998041597, 0.234528941479, -0.023185843322)
_RSCAN_CC = (1.0, -0.64, -0.4352, -1.535685604549, 3.061560252175,
             -1.915710236206, 0.516884468372, -0.051848879792)
_RSCAN_TAU_R = 1.0e-4
_RSCAN_ALPHA_R = 1.0e-3


def _rscan_falpha(alpha, cs, c2, d):
    """rSCAN interpolation: degree-7 polynomial below alpha = 2.5, SCAN's
    damped exponential above. Both pieces are smooth, so no safe-input
    tricks are needed below the switch; the exponential branch gets the
    same clamp as _scan_falpha."""
    poly = jnp.zeros_like(alpha)
    for c in reversed(cs):
        poly = poly * alpha + c
    a_hi = jnp.maximum(alpha, 2.5)
    hi = -d * jnp.exp(c2 / (1.0 - a_hi))
    return jnp.where(alpha < 2.5, poly, hi)


def _rscan_alpha(num53, den53, inv53):
    """Regularized alpha' = a^3/(a^2 + alpha_r) with
    a = (tau - tau_W)/(tau_unif + tau_r): bounded derivatives at a = 0 (the
    rSCAN regularization). Inputs are the tunif-scaled numerator
    (tau - tw)*rho^(-5/3), the scaled tau_unif prefactor, and rho^(-5/3)
    itself (tau_r must be rescaled by it to stay in energy units). a is
    capped at 1e6 -- f(alpha) is constant there to 1e-6 -- so the
    rational's vjp (a^4-scale numerator) stays within ~1e+-38 in far tails
    where a reaches ~1e9."""
    a = num53 / (den53 + _RSCAN_TAU_R * inv53)
    a = jnp.minimum(a, 1e6)
    return a * a * a / (a * a + _RSCAN_ALPHA_R)


def _ex_rscan(ra, rb, saa, sab, sbb, ta, tb, *, k1=0.065, k0=0.174):
    """rSCAN exchange: SCAN's F_x with alpha -> alpha' and f_x -> the
    polynomial interpolation. Keeps SCAN's hydrogen-atom exactness
    (alpha' = 0 there) but relaxes the uniform-gas limit by ~6e-5
    (f_x poly(1) != 0 exactly -- the documented rSCAN tradeoff)."""
    muak = 10.0 / 81.0
    b2 = (5913.0 / 405000.0) ** 0.5
    b1 = (511.0 / 13500.0) / (2.0 * b2)
    b3 = 0.5
    b4 = muak * muak / k1 - 1606.0 / 18225.0 - b1 * b1
    a1 = 4.9479
    c2x, dx = 0.8, 1.24
    h0x = 1.0 + k0

    def exs(r2, s4, t2):
        kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * jnp.pi)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)
        tau = jnp.maximum(t2, tw + _TINY)
        alpha = _rscan_alpha(jnp.maximum((tau - tw) * inv53, 0.0), 0.3 * kf1**2, inv53)
        oma = 1.0 - alpha
        x = muak * p * (1.0 + (b4 * p / muak) * jnp.exp(-jnp.abs(b4) * p / muak)) + (
            b1 * p + b2 * oma * jnp.exp(-b3 * oma * oma)
        ) ** 2
        x = jnp.minimum(x, 1e8)  # same far-tail vjp cap as _ex_scan
        h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
        fx = _rscan_falpha(alpha, _RSCAN_CX, c2x, dx)
        pf = jnp.maximum(p, 1e-20)
        gx = 1.0 - jnp.exp(-a1 / jnp.sqrt(jnp.sqrt(pf)))
        Fx = (h1x + fx * (h0x - h1x)) * gx
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _ec_rscan(ra, rb, saa, sab, sbb, ta, tb):
    """rSCAN correlation: SCAN's eps_c0/eps_c1 interpolated by the f_c
    polynomial of the regularized alpha'."""
    c2c, dc = 1.5, 0.7
    b1c, b2c, b3c = 0.0285764, 0.0889, 0.125541
    chi_inf = 0.128026
    gamma = 0.031091

    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    sigma = saa + 2.0 * sab + sbb
    tau = ta + tb
    kf1 = (3.0 * jnp.pi**2) ** (1.0 / 3.0)
    inv43 = rho ** (-4.0 / 3.0)
    inv53 = rho ** (-5.0 / 3.0)
    rs = (3.0 / (4.0 * jnp.pi)) ** (1.0 / 3.0) * rho ** (-1.0 / 3.0)
    p = (sigma * inv43) * inv43 / (4.0 * kf1**2)
    tw = sigma / (8.0 * rho + _TINY)
    ds = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    taus = jnp.maximum(tau, tw + _TINY)
    alpha = _rscan_alpha(jnp.maximum((taus - tw) * inv53, 0.0), 0.3 * kf1**2 * ds, inv53)

    eps_lsda = _ec_pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    phi3 = phi * phi * phi
    t2 = (sigma * inv43) / rho * (jnp.pi / (16.0 * kf1)) / (phi * phi)
    w1 = jnp.expm1(-eps_lsda / (gamma * phi3))
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    y = beta_rs / (gamma * (w1 + _TINY)) * t2
    g = (1.0 + 4.0 * y) ** (-0.25)
    H1 = gamma * phi3 * jnp.log1p(w1 * (1.0 - g))
    eps1 = eps_lsda + H1

    eps_lda0 = -b1c / (1.0 + b2c * jnp.sqrt(rs) + b3c * rs)
    w0 = jnp.expm1(-eps_lda0 / b1c)
    ginf = (1.0 + 4.0 * chi_inf * p) ** (-0.25)
    H0 = b1c * jnp.log1p(w0 * (1.0 - ginf))
    dxz = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gcz = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - zeta**12)
    eps0 = (eps_lda0 + H0) * gcz

    fc = _rscan_falpha(alpha, _RSCAN_CC, c2c, dc)
    return rho * (eps1 + fc * (eps0 - eps1))


# ----------------------------------------------------------------------------
# BR89 exchange (laplacian-level meta-GGA)
# ----------------------------------------------------------------------------


def _br89_solve_x(y):
    """Invert y = x exp(-2x/3)/(x-2).

    g is monotone and bijective on each branch: (0,2) -> (-inf, 0) and
    (2, inf) -> (0, inf). Bisection (gradient-stopped) + Newton polish in
    log form, so the derivative flows through the converged Newton step
    (the implicit-function derivative)."""
    neg = y < 0.0
    # 1e-30 floor: the bottom of the ~1e+-38 range kept here (see _ex_pbe)
    ys = jnp.where(jnp.abs(y) > 1e-30, y, jnp.where(neg, -1e-30, 1e-30))

    def g(x):
        return x * jnp.exp(-2.0 * x / 3.0) / (x - 2.0)

    lo = jnp.where(neg, 1e-10, 2.0 + 1e-10)
    hi = jnp.where(neg, 2.0 - 1e-10, 600.0)

    def body(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        # g decreases on both branches: 0- -> -inf on (0,2), +inf -> 0+ on
        # (2,inf), so g(mid) > y always means x must grow
        too_small = g(mid) > ys
        lo = jnp.where(too_small, mid, lo)
        hi = jnp.where(too_small, hi, mid)
        return (lo, hi), None

    (lo, hi), _ = jax.lax.scan(body, (lo, hi), None, length=80)
    x = jax.lax.stop_gradient(0.5 * (lo + hi))
    # Newton on h(x) = ln|g(x)| - ln|y|: h' = 1/x - 2/3 - 1/(x-2)
    for _ in range(3):
        h = jnp.log(jnp.abs(g(x))) - jnp.log(jnp.abs(ys))
        hp = 1.0 / x - 2.0 / 3.0 - 1.0 / (x - 2.0)
        x = x - h / hp
    return x


def _ex_br89(ra, rb, saa, sab, sbb, ta, tb, la, lb, *, gamma=0.8):
    """Becke-Roussel 1989 exchange (PRA 38, 3761): model the exchange hole
    by a displaced exponential matched to the exact small-separation
    expansion. Exact for one-electron (hydrogenic) densities. Inputs use
    tau WITH the 1/2 convention; BR's tau = 2*tau_here."""

    def exs(r, s, t, l):
        D = 2.0 * t - 0.25 * s / (r + _TINY)
        Q = (l - 2.0 * gamma * D) / 6.0
        # floors at 1e-15: a divisor below ~1e-19 overflows when the vjp
        # squares it past the ~1e+-38 range kept here (see _ex_pbe);
        # |Q| ~ 1e-15 only in far tails where the hole model saturates anyway
        Qs = jnp.where(jnp.abs(Q) > 1e-15, Q, jnp.where(Q < 0.0, -1e-15, 1e-15))
        y = (2.0 / 3.0) * jnp.pi ** (2.0 / 3.0) * r ** (5.0 / 3.0) / Qs
        x = _br89_solve_x(y)
        ex = jnp.exp(-x)
        b3 = x**3 * ex / (8.0 * jnp.pi * r + _TINY)
        b = jnp.cbrt(b3)
        U = -(1.0 - ex - 0.5 * x * ex) / (b + 1e-15)
        return 0.5 * r * U

    return exs(ra, saa, ta, la) + exs(rb, sbb, tb, lb)


# ----------------------------------------------------------------------------
# catalog + evaluation
# ----------------------------------------------------------------------------

_CATALOG = {
    "lda_x": Functional("lda_x", "lda", _ex_slater),
    "lda_c_vwn": Functional("lda_c_vwn", "lda", _ec_vwn5),
    "lda_c_pw": Functional("lda_c_pw", "lda", _ec_pw92),
    "gga_x_pbe": Functional("gga_x_pbe", "gga", _ex_pbe),
    "gga_c_pbe": Functional("gga_c_pbe", "gga", _ec_pbe),
    "gga_x_rpbe": Functional("gga_x_rpbe", "gga", _ex_rpbe),
    "gga_x_b88": Functional("gga_x_b88", "gga", _ex_b88),
    "gga_c_lyp": Functional("gga_c_lyp", "gga", _ec_lyp),
    "mgga_x_tpss": Functional("mgga_x_tpss", "mgga", _ex_tpss),
    "mgga_c_tpss": Functional("mgga_c_tpss", "mgga", _ec_tpss),
    "mgga_x_scan": Functional("mgga_x_scan", "mgga", _ex_scan),
    "mgga_c_scan": Functional("mgga_c_scan", "mgga", _ec_scan),
    "mgga_x_rscan": Functional("mgga_x_rscan", "mgga", _ex_rscan),
    "mgga_c_rscan": Functional("mgga_c_rscan", "mgga", _ec_rscan),
    "mgga_x_br89": Functional("mgga_x_br89", "mggal", _ex_br89),
    "lda_x_erf": Functional("lda_x_erf", "lda", _ex_slater_erf),
}

# alias -> (kfrac, [(weight, functional-name, params-dict), ...])
_ALIASES = {
    "lda": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_pw", {})]),
    "svwn": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "svwn5": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "pbe": (0.0, [(1.0, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    "blyp": (0.0, [(1.0, "gga_x_b88", {}), (1.0, "gga_c_lyp", {})]),
    "tpss": (0.0, [(1.0, "mgga_x_tpss", {}), (1.0, "mgga_c_tpss", {})]),
    "scan": (0.0, [(1.0, "mgga_x_scan", {}), (1.0, "mgga_c_scan", {})]),
    "rscan": (0.0, [(1.0, "mgga_x_rscan", {}), (1.0, "mgga_c_rscan", {})]),
    "pbe0": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    "pbeh": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    # TPSSh: 10 % exact exchange (Staroverov et al. 2003)
    "tpssh": (0.10, [(0.9, "mgga_x_tpss", {}), (1.0, "mgga_c_tpss", {})]),
    # B3LYP with the VWN5 correlation variant ("B3LYP5"): the 0.72 weight
    # multiplies the FULL B88 (LDA + gradient correction), so the Slater
    # weight is 0.80 - 0.72 = 0.08
    "b3lyp5": (0.20, [(0.08, "lda_x", {}), (0.72, "gga_x_b88", {}),
                      (0.19, "lda_c_vwn", {}), (0.81, "gga_c_lyp", {})]),
    # parameter-override variants (Zhang-Yang revPBE; Perdew et al. PBEsol)
    "rpbe": (0.0, [(1.0, "gga_x_rpbe", {}), (1.0, "gga_c_pbe", {})]),
    "revpbe": (0.0, [(1.0, "gga_x_pbe", {"kappa": 1.245}), (1.0, "gga_c_pbe", {})]),
    "pbesol": (0.0, [(1.0, "gga_x_pbe", {"mu": 10.0 / 81.0}),
                     (1.0, "gga_c_pbe", {"beta": 0.046})]),
}


def get_functional(name: str) -> Functional:
    key = name.lower()
    if key not in _CATALOG:
        raise ValueError(f"unknown functional '{name}'")
    return _CATALOG[key]


def with_params(f: Functional, **overrides) -> Functional:
    """Functional with named parameter overrides (the JAX equivalent
    of the reference's libxc ext_params files, src/atomic/main.cpp:107-108).
    Keys are validated against the functional's keyword parameters."""
    if not overrides:
        return f
    import inspect

    valid = {
        k for k, p in inspect.signature(f.f).parameters.items()
        if p.kind == inspect.Parameter.KEYWORD_ONLY
    }
    bad = set(overrides) - valid
    if bad:
        raise ValueError(f"{f.name} has no parameters {sorted(bad)}; valid: {sorted(valid)}")
    params = dict(f.params)
    params.update(overrides)
    tag = ",".join(f"{k}={v:g}" for k, v in sorted(params.items()))
    return Functional(f"{f.name}[{tag}]", f.family, f.f, tuple(sorted(params.items())))


def scale_functional(w: float, f: Functional) -> Functional:
    if w == 1.0:
        return f
    return Functional(
        f"{w}*{f.name}", f.family,
        lambda *a, _f=f.f, _w=w, **kw: _w * _f(*a, **kw),
        f.params,
    )


def _parse_part(part: str) -> Functional:
    """'name' or 'name[k=v,k=v]' -> Functional with overrides."""
    if "[" in part:
        if not part.endswith("]"):
            raise ValueError(f"malformed functional spec '{part}'")
        name, argstr = part[:-1].split("[", 1)
        kv = {}
        for item in argstr.split(","):
            k, v = item.split("=")
            kv[k.strip()] = float(v)
        return with_params(get_functional(name), **kv)
    return get_functional(part)


class MethodSpec(NamedTuple):
    """Parsed method: semilocal functionals plus the exact-exchange mixing
    (reference: range_separation(), src/general/dftfuncs.cpp:505-560).

    The exchange operator is  kfull * K  +  kshort * K_sr(omega)  where
    K_sr uses the short-range kernel named by `kernel` ('erfc' for the
    erf/erfc split, 'yukawa' for exp(-omega r)/r screening).
    """

    funcs: tuple
    kfull: float  # libxc 'alpha': fraction of full-range exact exchange
    kshort: float  # libxc 'beta': additional short-range exact exchange
    omega: float = 0.0  # range-separation parameter
    kernel: str = "erfc"


# range-separated aliases: name -> (kfull, kshort, default omega, kernel,
# [(weight, func, params, give_omega)]); give_omega passes the (possibly
# overridden) omega into the functional's own parameter set
_RS_ALIASES = {
    # LC-type LDA: full long-range HF + short-range LDA exchange
    # (Savin's RSH scheme with the erf split)
    "lc-lda": (1.0, -1.0, 0.5, "erfc",
               [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    "ldaerf": (1.0, -1.0, 0.5, "erfc",
               [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    # Yukawa-kernel variant of the same split; the semilocal part keeps the
    # erf complement form (the closed-form SR-LDA hole), the HF part is
    # screened with the Yukawa kernel like the reference's CAMY functionals
    "lcy-lda": (1.0, -1.0, 0.5, "yukawa",
                [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    # short-range-only exact exchange + PBE correlation (HSE-like mixing
    # without the wPBE semilocal complement; useful for limit tests)
    "sr-pbe0": (0.0, 0.25, 0.11, "erfc",
                [(0.75, "gga_x_pbe", {}, False), (1.0, "gga_c_pbe", {}, False)]),
}


def _split_bracket(m: str):
    """'name[k=v,...]' -> (name, {k: v}); 'name' -> (name, {})."""
    if "[" not in m:
        return m, {}
    if not m.endswith("]"):
        raise ValueError(f"malformed method spec '{m}'")
    base, args = m[:-1].split("[", 1)
    kv = {}
    for item in args.split(","):
        k, v = item.split("=")
        kv[k.strip()] = float(v)
    return base, kv


@lru_cache(maxsize=None)
def parse_method_rs(method: str) -> MethodSpec:
    """Parse a method string including range-separated hybrids.

    'HF', composite aliases ('PBE', 'PBE0', 'LC-LDA[omega=0.4]', ...), or an
    'x_func,c_func' pair (each with optional bracketed parameter overrides).
    Returns a MethodSpec; kshort/omega are zero for global hybrids."""
    m = method.strip().lower()
    if m in ("hf", ""):
        return MethodSpec((), 1.0, 0.0)
    # an RS alias with overrides is a single 'name[...]' token; anything
    # else (e.g. 'x[k=v],c' pairs) falls through to the generic parser
    base, kv = m, {}
    if "[" in m and m.index("[") > 0 and m[: m.index("[")] in _RS_ALIASES:
        base, kv = _split_bracket(m)
    if base in _RS_ALIASES:
        kfull, kshort, omega, kernel, parts = _RS_ALIASES[base]
        omega = kv.pop("omega", omega)
        kfull = kv.pop("kfull", kfull)
        kshort = kv.pop("kshort", kshort)
        if kv:
            raise ValueError(f"unknown method overrides {sorted(kv)} for '{base}'")
        funcs = tuple(
            scale_functional(
                w, with_params(_CATALOG[k], **({**pv, "omega": omega} if go else pv))
            )
            for w, k, pv, go in parts
        )
        return MethodSpec(funcs, kfull, kshort, omega, kernel)
    if m in _ALIASES:
        kfrac, parts = _ALIASES[m]
        return MethodSpec(
            tuple(scale_functional(w, with_params(_CATALOG[k], **pv)) for w, k, pv in parts),
            kfrac,
            0.0,
        )
    # reference-compatible 'x-c' pair syntax: split at the FIRST top-level
    # dash (parse_xc_func, ref src/general/dftfuncs.cpp:99-108); catalog
    # names here use underscores, so a top-level dash is always the pair
    # separator (dash-named RS aliases were already resolved above)
    if "," not in m:
        depth = 0
        for i, ch in enumerate(m):
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            elif ch == "-" and depth == 0:
                m = m[:i] + "," + m[i + 1:]
                break
    # bracket-aware comma split: 'a[k=1,m=2],b' -> ['a[k=1,m=2]', 'b']
    parts, depth, cur = [], 0, ""
    for ch in m:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    parts = [p for p in parts if p and p != "none"]
    return MethodSpec(tuple(_parse_part(p) for p in parts), 0.0, 0.0)


def parse_method(method: str):
    """Back-compat wrapper: (funcs, kfrac) for non-range-separated methods.
    Range-separated methods must go through parse_method_rs (raising here
    keeps the short-range exchange from being silently dropped)."""
    spec = parse_method_rs(method)
    if spec.omega != 0.0 or spec.kshort != 0.0:
        raise ValueError(
            f"'{method}' is range-separated; use parse_method_rs / the scf "
            "drivers, which wire kshort*K_sr(omega)"
        )
    return list(spec.funcs), spec.kfull


_NARGS = {"lda": 5, "gga": 5, "mgga": 7, "mggal": 9}


def xc_eval(funcs, ra, rb, saa, sab, sbb, thr: float = 1e-12, ta=None, tb=None,
            la=None, lb=None):
    """Energy density and potentials on grid arrays.

    Returns (e, vra, vrb, vsaa, vsab, vsbb[, vta, vtb][, vla, vlb]) -- the
    tau potentials only when ta/tb are given, the density-laplacian
    potentials only when la/lb are given (laplacian-level meta-GGAs,
    family 'mggal'; reference: the do_lapl path of src/atomic/dftgrid.cpp).
    Points where rho < thr give exactly zero."""
    mask = (ra + rb) > thr
    rs = jnp.where(mask, ra, 1.0)
    rbs = jnp.where(mask, rb, 1.0)
    # per-spin density floor at thr (the analogue of libxc's
    # xc_func_set_dens_threshold, applied per spin channel): at a live point
    # one spin can still be arbitrarily small, and n^(-4/3)-type reduced
    # variables leave the ~1e+-38 range kept here below ~1e-12;
    # the spurious contribution of a floored channel is O(thr^(4/3)) per
    # point -- far below quadrature accuracy
    args = [
        jnp.maximum(rs, thr),
        jnp.maximum(rbs, thr),
        jnp.maximum(saa, 0.0),
        sab,
        jnp.maximum(sbb, 0.0),
    ]
    with_tau = ta is not None
    with_lapl = la is not None
    if with_tau:
        args += [jnp.maximum(ta, _TINY), jnp.maximum(tb, _TINY)]
    if with_lapl:
        if not with_tau:
            args += [jnp.zeros_like(la), jnp.zeros_like(la)]
        args += [la, lb]

    def ftot(*a):
        if not funcs:
            return jnp.zeros_like(a[0])
        return sum(f.f(*a[: _NARGS[f.family]], **dict(f.params)) for f in funcs)

    e, vjp = jax.vjp(ftot, *args)
    grads = vjp(jnp.ones_like(e))
    z = jnp.zeros_like(e)
    out = [jnp.where(mask, x, z) for x in (e, *grads)]
    if with_lapl and not with_tau:
        # drop the dummy tau slots
        out = out[:6] + out[8:]
    return tuple(out)
