"""Analytical solutions for verification: Halfar, Bueler, Schoof.

Vectorised numpy re-derivations of the closed-form solutions in
src/UPSY/basic/analytical_solutions/ (Halfar 1981 similarity dome; Bueler et
al. 2005 dome with accumulation; Schoof 2006 ice-stream). Used as test
oracles by the Halfar-dome and SSA_icestream integrated tests.

Units follow the reference: A in [Pa^-n yr^-1], t in [yr], lengths in [m],
velocities in [m yr^-1].
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import sec_per_year, ice_density, grav


# -- Halfar (1981) similarity solution --------------------------------------

def _halfar_gamma(A, n):
    return (2.0 / 5.0) * (A / sec_per_year) * (ice_density * grav) ** n


def _halfar_t0(A, n, H0, R0):
    G = _halfar_gamma(A, n)
    return (1.0 / ((5 * n + 3) * G) * ((2 * n + 1) / (n + 1)) ** n
            * R0 ** (n + 1) / H0 ** (2 * n + 1))


def halfar_H(A, n, H0, R0, x, y, t):
    """Halfar dome ice thickness at (x, y, t[yr])."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t0 = _halfar_t0(A, n, H0, R0)
    p1 = -2.0 / (5 * n + 3)
    p2 = -1.0 / (5 * n + 3)
    p3 = (n + 1.0) / n
    p4 = n / (2 * n + 1.0)
    f1 = ((t0 + t * sec_per_year) / t0) ** p1
    f2 = ((t0 + t * sec_per_year) / t0) ** p2
    r = np.sqrt(x ** 2 + y ** 2)
    G = 1.0 - np.minimum(1.0, f2 * r / R0) ** p3
    return H0 * f1 * G ** p4


def halfar_dHdt(A, n, H0, R0, x, y, t, eps=1e-3):
    """dH/dt [m/yr] via centred difference of the exact solution."""
    return (halfar_H(A, n, H0, R0, x, y, t + eps)
            - halfar_H(A, n, H0, R0, x, y, t - eps)) / (2 * eps)


def halfar_u_vav(A, n, H0, R0, x, y, t):
    """Vertically averaged horizontal velocity components [m/yr].

    From the SIA: u_vav = -2A/(n+2) (rho g)^n |grad H|^(n-1) H^(n+1) dH/dx
    (flat bed, Hs == H). Derived directly rather than via the reference's
    chain of Q/D_m helpers.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    eps = 1.0
    H = halfar_H(A, n, H0, R0, x, y, t)
    dHdx = (halfar_H(A, n, H0, R0, x + eps, y, t)
            - halfar_H(A, n, H0, R0, x - eps, y, t)) / (2 * eps)
    dHdy = (halfar_H(A, n, H0, R0, x, y + eps, t)
            - halfar_H(A, n, H0, R0, x, y - eps, t)) / (2 * eps)
    grad = np.sqrt(dHdx ** 2 + dHdy ** 2)
    D = -2.0 * A / (n + 2.0) * (ice_density * grav) ** n \
        * grad ** (n - 1) * H ** (n + 1)
    return D * dHdx, D * dHdy


# -- Bueler et al. (2005) dome with accumulation -----------------------------

def bueler_dome(A, n, H0, R0, lam, x, y, t):
    """Bueler exact solution: returns (H [m], M [m/yr])."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    alpha = (2.0 - (n + 1) * lam) / (5 * n + 3)
    beta = (1.0 + (2 * n + 1) * lam) / (5 * n + 3)
    Gamma = _halfar_gamma(A, n)
    f1 = (2 * n + 1) / (n + 1.0)
    f2 = R0 ** (n + 1) / H0 ** (2 * n + 1)
    t0 = (beta / Gamma) * f1 ** n * f2
    tp = t * sec_per_year
    g1 = (tp / t0) ** (-alpha)
    g2 = (tp / t0) ** (-beta)
    g3 = np.sqrt(x ** 2 + y ** 2) / R0
    g4 = np.maximum(0.0, 1.0 - (g2 * g3) ** ((n + 1.0) / n))
    H = H0 * g1 * g4 ** (n / (2 * n + 1.0))
    M = (lam / tp) * H * sec_per_year
    return H, M


# -- Schoof (2006) ice stream ------------------------------------------------

def schoof_icestream(A, n, H, tantheta, L, m, y):
    """Schoof 2006 ice-stream velocity u(y) [m/yr] and till yield stress.

    Band of increased slipperiness of width L along y=0 on a plane sloping
    in +x; valid for n=3 only.
    """
    assert n == 3.0, "Schoof solution only derived for n=3"
    y = np.asarray(y, dtype=np.float64)
    f = -ice_density * grav * H * tantheta
    B = A ** (-1.0 / 3.0)
    W = L * (m + 1.0) ** (1.0 / m)
    tau_yield = f * np.abs(y / L) ** m
    ua = -2.0 * f ** 3 * L ** 4 / (B ** 3 * H ** 3)
    ay = np.abs(y / L)
    ub = (1.0 / 4.0) * ((y / L) ** 4 - (m + 1) ** (4.0 / m))
    uc = (-3.0 / ((m + 1) * (m + 4))) * (ay ** (m + 4) - (m + 1) ** (1 + 4.0 / m))
    ud = (3.0 / ((m + 1) ** 2 * (2 * m + 4))) * (ay ** (2 * m + 4) - (m + 1) ** (2 + 4.0 / m))
    ue = (-1.0 / ((m + 1) ** 3 * (3 * m + 4))) * (ay ** (3 * m + 4) - (m + 1) ** (3 + 4.0 / m))
    u = ua * (ub + uc + ud + ue)
    u = np.where(np.abs(y) > W, 0.0, u)
    return u, tau_yield
