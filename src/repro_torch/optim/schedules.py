"""Stepsize schedules (port of `repro/optim/schedules.py`).

The paper's point is that FedGDA-GT admits a CONSTANT stepsize (Theorem 1)
while Local SGDA needs a diminishing one for exact convergence; both are
provided so benchmarks can compare the regimes.  A schedule returns a
Python float, the f64 value JAX computes, so a round reads its stepsize
without a device sync.
"""
from __future__ import annotations

from typing import Callable


def constant_schedule(eta: float) -> Callable[[int], float]:
    eta = float(eta)
    return lambda t: eta


def diminishing_schedule(eta0: float, decay: float = 1.0) -> Callable[[int], float]:
    """eta_t = eta0 / (1 + decay * t)  — the O(1/t) rate used by Local SGDA
    analyses [25, 26]."""
    return lambda t: eta0 / (1.0 + decay * t)
