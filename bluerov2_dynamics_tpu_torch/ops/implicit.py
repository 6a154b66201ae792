"""Implicit fixed-step integrators (fixed-iteration Newton, PyTorch).

Counterpart of ``bluerov2_dynamics_tpu/ops/implicit.py``.  The reference
integrates the stiff coupled ROV + tether system with scipy's adaptive
BDF; these A-stable fixed-step rules take a fixed number of Newton
iterations a step instead, the Jacobian from ``torch.func.jacfwd`` and a
dense ``torch.linalg.solve`` (the coupled state is small: 12 + 6(n-1)).

For the tether the substepped RK4 of :mod:`..models.tether` is usually
faster; use these where stability at a large dt matters.  The trapezoidal
rule is A- but not L-stable, so undamped stiff oscillations (the tether's
axial modes) ring at a large dt; **backward Euler** is the robust choice
there.

Steps operate on a single 1-D state; batch them with ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _newton_solve(g: Callable, y0, iters: int):
    y = y0
    for _ in range(iters):
        J = torch.func.jacfwd(g)(y)
        y = y - torch.linalg.solve(J, g(y))
    return y


def backward_euler_step(rhs: Callable, x, u, dt, newton_iters: int = 6):
    """Implicit (backward) Euler: solve ``y = x + dt f(y, u)``.  First
    order, L-stable."""
    def g(y):
        return y - x - dt * rhs(y, u)

    return _newton_solve(g, x + dt * rhs(x, u), newton_iters)


def trapezoidal_step(rhs: Callable, x, u, dt, newton_iters: int = 6):
    """Implicit trapezoidal rule: solve ``y = x + dt/2 (f(x,u) + f(y,u))``.
    Second order, A-stable."""
    f0 = rhs(x, u)

    def g(y):
        return y - x - 0.5 * dt * (f0 + rhs(y, u))

    return _newton_solve(g, x + dt * f0, newton_iters)


def make_implicit_step(
    rhs: Callable,
    dt: float,
    method: str = "trapezoidal",
    newton_iters: int = 6,
):
    """Build ``step(x, u) -> x'`` using an implicit rule."""
    steppers = {
        "trapezoidal": trapezoidal_step,
        "backward_euler": backward_euler_step,
    }
    if method not in steppers:
        raise ValueError(f"unknown method {method!r}; expected one of {sorted(steppers)}")
    stepper = steppers[method]

    def step(x, u):
        return stepper(rhs, x, u, dt, newton_iters)

    return step
