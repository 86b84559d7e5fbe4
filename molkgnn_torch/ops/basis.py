"""Radial and spherical bases of the DimeNet++ and SphereNet baselines.

Port of ``molkgnn_tpu/ops/basis.py``, without sympy. The JAX package builds
its bases with sympy and lambdifies them; here the same closed forms are
built from recurrences on exact integers and floats, once per shape on the
host, and evaluated with torch:

  * spherical Bessel functions j_l(z) = (A_l(z) sin z + B_l(z) cos z) /
    z^(l+1), where A_l and B_l are integer polynomials from the Rayleigh
    recurrence N_{l+1} = (2l+1) N_l - z^2 N_{l-1} on N_l = z^(l+1) j_l;
    below z = l + 1, where the closed form loses digits to cancellation,
    the power series z^l / (2l+1)!! sum_k (-z^2/2)^k / (k! (2l+3)...
    (2l+2k+1)) takes its place;
  * their zeros by bracketing (scipy ``brentq``, as in the JAX package) and
    the normalised radial basis b_ln(x) = j_l(z_ln x) / sqrt(j_{l+1}(z_ln)^2
    / 2);
  * real spherical harmonics Y_l0(theta) = sqrt((2l+1)/4pi) P_l(cos theta),
    and for SphereNet Y_lm(theta, phi) = sqrt(2) N_lm P_l^m(cos theta)
    cos(m phi) with the Condon-Shortley phase, from the Legendre
    recurrences on cos theta and |sin theta|.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

# Terms of the power series of j_l (z < l + 1): the remainder is below
# 1e-16 of the sum for l <= 6.
_SERIES_TERMS = 20


@lru_cache(maxsize=None)
def _rayleigh_polys(n: int) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(A_l, B_l) integer coefficients (ascending powers of z) for l < n."""
    polys = [((1,), (0,)), ((1,), (0, -1))]  # N_0 = sin z, N_1 = sin - z cos

    def combine(p, q, c):  # c * p - z^2 * q
        out = [c * a for a in p] + [0] * max(0, len(q) + 2 - len(p))
        for k, b in enumerate(q):
            out[k + 2] -= b
        return tuple(out)

    for l in range(1, n - 1):
        (a1, b1), (a0, b0) = polys[l], polys[l - 1]
        polys.append((combine(a1, a0, 2 * l + 1),
                      combine(b1, b0, 2 * l + 1)))
    return polys[:n]


def _poly(coeffs, z):
    out = torch.zeros_like(z)
    for c in reversed(coeffs):
        out = out * z + float(c)
    return out


def spherical_jn(l: int, z: torch.Tensor) -> torch.Tensor:
    """j_l(z) for z >= 0 (see the module doc)."""
    split = float(l + 1)
    small = torch.clamp(z, max=split)
    term = torch.ones_like(z)
    total = torch.ones_like(z)
    half_sq = -0.5 * small * small
    for k in range(1, _SERIES_TERMS + 1):
        term = term * half_sq / float(k * (2 * l + 2 * k + 1))
        total = total + term
    double_fact = float(math.prod(range(1, 2 * l + 2, 2)))
    series = small ** l / double_fact * total
    big = torch.clamp(z, min=split)
    a, b = _rayleigh_polys(l + 1)[l]
    closed = (_poly(a, big) * torch.sin(big) + _poly(b, big) * torch.cos(big)
              ) / big ** (l + 1)
    return torch.where(z < split, series, closed)


@lru_cache(maxsize=None)
def bessel_zeros(n: int, k: int) -> np.ndarray:
    """First k positive zeros of j_0..j_{n-1}, each bracketed by two
    consecutive zeros of the order below (scipy ``brentq``)."""
    from scipy.optimize import brentq
    from scipy.special import spherical_jn as sp_jn

    zeros = np.zeros((n, k), dtype=np.float64)
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1)
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = brentq(
                lambda x: sp_jn(i, x), points[j], points[j + 1]
            )
        points = racines.copy()
        zeros[i][:k] = racines[:k]
    return zeros


@lru_cache(maxsize=None)
def _bessel_normalizer(n: int, k: int) -> np.ndarray:
    from scipy.special import spherical_jn as sp_jn

    zeros = bessel_zeros(n, k)
    return np.array([
        [1.0 / np.sqrt(0.5 * sp_jn(order + 1, zeros[order, i]) ** 2)
         for i in range(k)]
        for order in range(n)
    ])


def bessel_basis(x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """[len(x), n, k] normalised spherical-Bessel radial basis b_lr(x), x =
    d / cutoff in (0, 1]. One ``spherical_jn`` call per order over its k
    roots; the constants enter as Python floats (nothing is copied from
    the host, so the forward can be captured in a CUDA graph)."""
    zeros = bessel_zeros(n, k)
    norm = _bessel_normalizer(n, k)
    out = []
    for l in range(n):
        z = torch.stack([x * float(zeros[l, r]) for r in range(k)], dim=-1)
        jl = spherical_jn(l, z)
        out.append(torch.stack([float(norm[l, r]) * jl[..., r]
                                for r in range(k)], dim=-1))
    return torch.stack(out, dim=-2)


def real_sph_harm(theta: torch.Tensor, n: int) -> torch.Tensor:
    """[len(theta), n] Y_l0(theta) = sqrt((2l+1)/4pi) P_l(cos theta)."""
    f = sph_harm_factors(theta, n, m_max=0)
    return torch.stack([f[l][0] for l in range(n)], dim=-1)


def sph_harm_factors(theta: torch.Tensor, n: int, m_max: int | None = None):
    """f[l][m], 0 <= m <= min(l, m_max), l < n: the theta part of the real
    harmonics, N_lm P_l^m(cos theta) (times sqrt 2 for m > 0), P_l^m with
    the Condon-Shortley phase, as sympy's ``assoc_legendre``.
    Y_lm(theta, phi) = f[l][m] cos(m phi) for m > 0, f[l][0] for m = 0."""
    c = torch.cos(theta)
    s = torch.abs(torch.sin(theta))
    out = [[None] * (l + 1) for l in range(n)]
    for m in range(n if m_max is None else m_max + 1):
        # P_m^m = (-1)^m (2m-1)!! s^m, then upward in l at fixed m.
        p_prev = None
        p = (-1) ** m * float(math.prod(range(1, 2 * m, 2))) * s ** m
        for l in range(m, n):
            if l == m + 1:
                p_prev, p = p, (2 * m + 1) * c * p
            elif l > m + 1:
                p_prev, p = p, ((2 * l - 1) * c * p
                                - (l + m - 1) * p_prev) / (l - m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            out[l][m] = (math.sqrt(2) * norm if m else norm) * p
    return out


def envelope(x: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """Smooth polynomial cutoff u(x) = 1/x + a x^(p-1) + b x^p + c x^(p+1)
    (DimeNet, eq. 8), p = exponent + 1; 0 for x >= 1."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    x_safe = torch.where(x > 0, x, 1.0)
    xp0 = x_safe ** (p - 1)
    val = (1.0 / x_safe + a * xp0 + b * xp0 * x_safe
           + c * xp0 * x_safe * x_safe)
    return torch.where(x < 1.0, val, 0.0)


def bessel_rbf(dist: torch.Tensor, freq: torch.Tensor, cutoff: float,
               exponent: int = 5) -> torch.Tensor:
    """[E, R] env(d/c) sin(freq d/c), ``freq`` learnable (init n pi)."""
    x = dist[:, None] / cutoff
    return envelope(x, exponent) * torch.sin(freq[None, :] * x)


def spherical_sbf(dist: torch.Tensor, angle: torch.Tensor,
                  num_spherical: int, num_radial: int, cutoff: float,
                  exponent: int = 5) -> torch.Tensor:
    """[T, S * R] b_lr(d/c) env(d/c) Y_l0(angle), ``dist`` and ``angle``
    per triplet (DimeNet++'s spherical basis)."""
    x = dist / cutoff
    rbf = bessel_basis(x, num_spherical, num_radial)
    rbf = rbf * envelope(x, exponent)[:, None, None]
    cbf = real_sph_harm(angle, num_spherical)
    return (rbf * cbf[:, :, None]).reshape(-1, num_spherical * num_radial)
