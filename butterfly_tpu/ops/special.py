"""Bessel/Hankel special functions, host (scipy) and device (jnp) paths.

Replacement for the reference's Chebyshev-series Bessel implementations
(src/bessel.c:1-50 + GSL): the host oracle path calls scipy.special, while the
device path implements J0/J1/Y0/Y1/H0/H1 directly in jnp so kernel evaluation
can run inside jit on the device:

- |x| <= 12: ascending power series for J_nu and the log-series for Y_nu
  (NIST DLMF 10.2.2, 10.8.1), summed with a fixed trip count so the whole
  thing traces to straight-line vector code.
- |x| > 12: Hankel's asymptotic expansion (DLMF 10.17.5-6):
  H^(1)_nu(x) ~ sqrt(2/(pi x)) e^{i(x - nu*pi/2 - pi/4)} * sum_k i^k a_k(nu) / x^k,
  a_k(nu) = prod_{m=1..k} (4 nu^2 - (2m-1)^2) / (k! 8^k),
  truncated near its optimal order at the crossover.

Worst-case relative error is ~3e-12 at the x=12 crossover (measured in
tests/test_special.py), comfortably inside the framework's 1e-6 accuracy gate.
All coefficients are generated from the defining recurrences at import time —
no opaque tables.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import scipy.special as _ss

_SERIES_TERMS = 30  # power-series trip count; max term at x=12 ~4e3 -> err ~1e-12
_ASYMPT_TERMS = 26  # near-optimal truncation of Hankel's expansion at x=12
_CROSSOVER = 12.0

_EULER_GAMMA = 0.5772156649015328606

# -- coefficient generation (exact recurrences, evaluated in f64) -----------


def _series_coeffs(nu: int) -> np.ndarray:
    """c_k with J_nu(x) = (x/2)^nu * sum_k c_k (x^2/4)^k  (DLMF 10.2.2)."""
    c = np.empty(_SERIES_TERMS)
    c[0] = 1.0 / _ss.factorial(nu)
    for k in range(1, _SERIES_TERMS):
        c[k] = -c[k - 1] / (k * (k + nu))
    return c


def _harmonic(n: int) -> float:
    return float(np.sum(1.0 / np.arange(1, n + 1))) if n > 0 else 0.0


def _asympt_coeffs(nu: int) -> np.ndarray:
    """a_k(nu) of Hankel's expansion (DLMF 10.17.1)."""
    mu = 4.0 * nu * nu
    a = np.empty(_ASYMPT_TERMS)
    a[0] = 1.0
    for k in range(1, _ASYMPT_TERMS):
        a[k] = a[k - 1] * (mu - (2 * k - 1) ** 2) / (k * 8.0)
    return a


_J0_C = _series_coeffs(0)
_J1_C = _series_coeffs(1)
_A0 = _asympt_coeffs(0)
_A1 = _asympt_coeffs(1)

# Y-series auxiliary coefficients (DLMF 10.8.1):
#   Y0(x) = (2/pi)[ (ln(x/2)+gamma) J0(x) + sum_{k>=1} (-1)^{k+1} H_k (x^2/4)^k / (k!)^2 ]
_Y0_C = np.array(
    [
        (-1.0) ** (k + 1) * _harmonic(k) / _ss.factorial(k) ** 2
        for k in range(_SERIES_TERMS)
    ]
)
#   Y1(x) = (2/pi)[ (ln(x/2)+gamma) J1(x) - 1/x
#                   - (x/4) sum_{k>=0} (-1)^k (H_k + H_{k+1}) (x^2/4)^k / (k!(k+1)!) ]
_Y1_C = np.array(
    [
        (-1.0) ** k
        * (_harmonic(k) + _harmonic(k + 1))
        / (_ss.factorial(k) * _ss.factorial(k + 1))
        for k in range(_SERIES_TERMS)
    ]
)


def _poly_in(z, coeffs: np.ndarray):
    """Horner evaluation sum_k coeffs[k] z^k for jnp arrays."""
    acc = jnp.zeros_like(z) + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * z + c
    return acc


def _hankel_small(x, nu: int):
    """(J_nu, Y_nu) from the ascending series; valid |x| <= crossover."""
    z = 0.25 * x * x
    if nu == 0:
        j = _poly_in(z, _J0_C)
        y = (2.0 / jnp.pi) * ((jnp.log(0.5 * x) + _EULER_GAMMA) * j + _horner_shift(z, _Y0_C))
    else:
        j = 0.5 * x * _poly_in(z, _J1_C)
        y = (2.0 / jnp.pi) * (
            (jnp.log(0.5 * x) + _EULER_GAMMA) * j
            - 1.0 / x
            - 0.25 * x * _poly_in(z, _Y1_C)
        )
    return j, y


def _horner_shift(z, coeffs: np.ndarray):
    """sum_{k>=1} coeffs[k] z^k  — Horner on the shifted polynomial."""
    acc = jnp.zeros_like(z) + coeffs[-1]
    for c in coeffs[-2:0:-1]:
        acc = acc * z + c
    return acc * z


def _hankel_large(x, nu: int):
    """(J_nu, Y_nu) via Hankel's asymptotic expansion; valid x > crossover."""
    a = _A0 if nu == 0 else _A1
    inv = 1.0 / x
    # zeta = sum_k i^k a_k x^{-k}: split into real (even k) and imag (odd k).
    re = _poly_in(-(inv * inv), a[0::2])
    im = inv * _poly_in(-(inv * inv), a[1::2])
    phase = x - (0.5 * nu + 0.25) * jnp.pi
    amp = jnp.sqrt(2.0 / (jnp.pi * x))
    c, s = jnp.cos(phase), jnp.sin(phase)
    j = amp * (c * re - s * im)
    y = amp * (s * re + c * im)
    return j, y


def _bessel_j_y(x, nu: int):
    x = jnp.asarray(x)
    xs = jnp.maximum(jnp.abs(x), 1e-300)  # avoid log(0)/div0 in unused branch
    xc = jnp.minimum(xs, _CROSSOVER)
    xl = jnp.maximum(xs, _CROSSOVER)
    js, ys = _hankel_small(xc, nu)
    jl, yl = _hankel_large(xl, nu)
    use_small = xs <= _CROSSOVER
    return jnp.where(use_small, js, jl), jnp.where(use_small, ys, yl)


# -- public device-side API -------------------------------------------------


def bessel_j0(x):
    """J0 for real x >= 0, jnp (reference: bf_j0, src/bessel.c)."""
    return _bessel_j_y(x, 0)[0]


def bessel_j1(x):
    return _bessel_j_y(x, 1)[0]


def bessel_y0(x):
    return _bessel_j_y(x, 0)[1]


def bessel_y1(x):
    return _bessel_j_y(x, 1)[1]


def hankel1_0(x):
    """H0^(1)(x) = J0(x) + i Y0(x), jnp (reference: bf_H0, src/bessel.c)."""
    j, y = _bessel_j_y(x, 0)
    return jax_complex(j, y)


def hankel1_1(x):
    """H1^(1)(x) = J1(x) + i Y1(x), jnp (reference: bf_H1, src/bessel.c)."""
    j, y = _bessel_j_y(x, 1)
    return jax_complex(j, y)


def jax_complex(re, im):
    return re + 1j * im


# -- host oracle path -------------------------------------------------------


def hankel1_0_host(x: np.ndarray) -> np.ndarray:
    return _ss.hankel1(0, np.asarray(x))


def hankel1_1_host(x: np.ndarray) -> np.ndarray:
    return _ss.hankel1(1, np.asarray(x))
