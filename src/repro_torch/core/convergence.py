"""Theorem 1 — convergence bound calculator, a numpy copy of
``repro.core.convergence`` (the reference module imports no JAX, but its
package does).

Implements the closed-form bound on the FedLDF↔FedAvg loss gap:

    F(Ĝ^{t+1}) − F(Ḡ^{t+1}) ≤ A^t [F(Ĝ^0) − F(Ḡ^0)] + B·(1 − A^t)/(1 − A)

with  A = 2ξ₂η²L²(1 − n/K)[1 + β(1 − n/K)]
      B = (ξ₁/ξ₂)·A + (1 − n/K)·G²/2

and the convergence condition 0 < ξ₂ < 1 / (2(1+β)η²L²).

The reference's `benchmarks/bound.py` uses it to check the paper's
analytical claims (gap shrinks as n→K; A<1 condition; asymptotic gap
formula).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoundParams:
    """Assumption constants (Assumptions 1-3) + protocol knobs."""

    beta: float          # smoothness
    xi1: float           # gradient-divergence intercept (Assumption 2)
    xi2: float           # gradient-divergence slope (Assumption 2)
    grad_bound: float    # G (Assumption 3)
    eta: float           # learning rate
    num_layers: int      # L
    n: int               # clients uploading each layer
    k: int               # participating clients


def contraction_A(p: BoundParams) -> float:
    """A = 2ξ₂η²L²(1−n/K)[1+β(1−n/K)]."""
    r = 1.0 - p.n / p.k
    return 2.0 * p.xi2 * p.eta**2 * p.num_layers**2 * r * (1.0 + p.beta * r)


def offset_B(p: BoundParams) -> float:
    """B = (ξ₁/ξ₂)A + (1−n/K)G²/2."""
    r = 1.0 - p.n / p.k
    return (p.xi1 / p.xi2) * contraction_A(p) + r * p.grad_bound**2 / 2.0


def xi2_max(p: BoundParams) -> float:
    """Convergence condition: ξ₂ < 1 / (2(1+β)η²L²)."""
    return 1.0 / (2.0 * (1.0 + p.beta) * p.eta**2 * p.num_layers**2)


def converges(p: BoundParams) -> bool:
    return 0.0 < p.xi2 < xi2_max(p) and contraction_A(p) < 1.0


def gap_bound(p: BoundParams, t: int, gap0: float) -> float:
    """Right-hand side of Eq. 9 after t rounds."""
    a = contraction_A(p)
    b = offset_B(p)
    if abs(1.0 - a) < 1e-12:
        return a**t * gap0 + b * t
    return a**t * gap0 + b * (1.0 - a**t) / (1.0 - a)


def asymptotic_gap(p: BoundParams) -> float:
    """t→∞ limit discussed under Theorem 1:
    ((1−n/K)G²/2 + ξ₁/ξ₂·A)/(1−A)  — equals B/(1−A); 0 when n = K."""
    a = contraction_A(p)
    if a >= 1.0:
        return np.inf
    return offset_B(p) / (1.0 - a)


def gap_curve(p: BoundParams, rounds: int, gap0: float = 0.0) -> np.ndarray:
    """Vectorised bound over t = 0..rounds (for benchmark plots/CSV)."""
    return np.array([gap_bound(p, t, gap0) for t in range(rounds + 1)])
