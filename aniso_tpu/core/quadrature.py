"""Gauss-Legendre quadrature rules.

Replacement for the reference's 22k-line generated table
(/root/reference/Quadrature.cpp:5418 `get_legendre_data`): rules are generated
at import time to full float64 accuracy by Newton iteration on the Legendre
polynomial, for any degree (the reference supports 1..128 via hard-coded
quad-precision string literals; we support any degree >= 1).

The `affine` transform (reference Quadrature.cpp:22194-22199) maps the rule
from [-1, 1] to [0, 1], halving the weights; it is used for the Duffy
singular rule.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Rule1D:
    """A 1D quadrature rule: sum_i w_i f(x_i)."""

    points: np.ndarray  # (n,) float64
    weights: np.ndarray  # (n,) float64

    @property
    def n(self) -> int:
        return self.points.shape[0]


@functools.lru_cache(maxsize=None)
def gauss_legendre(n: int) -> Rule1D:
    """n-point Gauss-Legendre rule on [-1, 1], exact for degree <= 2n-1.

    numpy's leggauss uses the Golub-Welsch eigenvalue method; we polish the
    roots with two Newton steps on P_n to reach ~1 ulp accuracy in float64,
    matching the reference's quad-precision tables to float64 round-off.
    """
    if n < 1:
        raise ValueError(f"quadrature degree must be >= 1, got {n}")
    x, w = np.polynomial.legendre.leggauss(n)
    # Newton polish: P_n(x) / P_n'(x)
    for _ in range(2):
        p, dp = _legendre_and_derivative(n, x)
        x = x - p / dp
    _, dp = _legendre_and_derivative(n, x)
    w = 2.0 / ((1.0 - x * x) * dp * dp)
    return Rule1D(points=x, weights=w)


def _legendre_and_derivative(n: int, x: np.ndarray):
    """Evaluate (P_n(x), P_n'(x)) by the three-term recurrence."""
    p_prev = np.ones_like(x)
    p = x.copy()
    if n == 0:
        return p_prev, np.zeros_like(x)
    for k in range(2, n + 1):
        p_prev, p = p, ((2 * k - 1) * x * p - (k - 1) * p_prev) / k
    dp = n * (x * p - p_prev) / (x * x - 1.0)
    return p, dp


def affine_01(rule: Rule1D) -> Rule1D:
    """Map a rule on [-1, 1] to [0, 1] (reference Quadrature.cpp:22194-22199)."""
    return Rule1D(points=(rule.points + 1.0) / 2.0, weights=rule.weights / 2.0)


def tensor_rule(rule: Rule1D):
    """Tensor-product 2D rule on [-1,1]^2 in the reference's ordering.

    Returns (qx, qy, w2d) flattened with k = r * n + c, where the x coordinate
    follows the row index r and y follows the column index c
    (reference Geometry.cpp:28-35).
    """
    n = rule.n
    qx = np.repeat(rule.points, n)
    qy = np.tile(rule.points, n)
    w2d = np.repeat(rule.weights, n) * np.tile(rule.weights, n)
    return qx, qy, w2d
