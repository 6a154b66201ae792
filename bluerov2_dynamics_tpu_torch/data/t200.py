"""T200 thrust-curve polynomial fitting from bench-test tables.

Counterpart of ``bluerov2_dynamics_tpu/data/t200.py``: fit
separate forward/reverse 5th-order thrust-magnitude polynomials (Newtons,
ascending-coefficient "gz plugin" format) from Blue Robotics public
performance data (PWM in [1100, 1900] us normalized to u = (PWM-1500)/400).

The workbook is read with the repo's own stdlib xlsx reader
(``data/xlsx.py``) — no pandas/openpyxl dependency; the fitting core takes
plain arrays so it is also testable without the spreadsheet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

MIN_PWM = 1100.0
MAX_PWM = 1900.0
MID_PWM = 0.5 * (MIN_PWM + MAX_PWM)
HALF_RANGE = 0.5 * (MAX_PWM - MIN_PWM)
POLY_DEG = 5
G0 = 9.80665  # kgf -> N


class ThrustFit(NamedTuple):
    pos_coeff: np.ndarray  # ascending powers, forward magnitude [N]
    neg_coeff: np.ndarray  # ascending powers, reverse magnitude [N]


def pwm_to_u(pwm):
    """Normalize PWM to u = (pwm - 1500) / 400 in [-1, 1]."""
    return (np.asarray(pwm, float) - MID_PWM) / HALF_RANGE


def eval_poly_asc(coeff_asc, u):
    """Horner evaluation of ascending-coefficient polynomials."""
    u = np.asarray(u, float)
    y = np.zeros_like(u)
    for a in np.asarray(coeff_asc)[::-1]:
        y = y * u + a
    return y


def eval_piecewise(fit: ThrustFit, u):
    """Signed thrust [N]: +pos(|u|) for u>=0, -neg(|u|) for u<0."""
    u = np.asarray(u, float)
    return np.where(
        u >= 0, eval_poly_asc(fit.pos_coeff, u), -eval_poly_asc(fit.neg_coeff, -u)
    )


def fit_forward_reverse(pwm, thrust_kgf, deg: int = POLY_DEG) -> ThrustFit:
    """Fit forward/reverse magnitude polynomials in Newtons."""
    pwm = np.asarray(pwm, float)
    thrust_kgf = np.asarray(thrust_kgf, float)
    u = pwm_to_u(pwm)

    def clean(x, y):
        m = np.isfinite(x) & np.isfinite(y)
        return x[m], y[m]

    u_pos, t_pos = clean(u[u >= 0], thrust_kgf[u >= 0])
    u_neg, t_neg = clean(-u[u <= 0], -thrust_kgf[u <= 0])
    pos = np.polyfit(u_pos, t_pos * G0, deg)[::-1]
    neg = np.polyfit(u_neg, t_neg * G0, deg)[::-1]
    return ThrustFit(pos_coeff=pos, neg_coeff=neg)


def fit_from_xlsx(
    xlsx_path,
    voltages: Tuple[int, ...] = (16, 18, 20),
    plot_dir: Optional[str] = None,
):
    """Fit polynomials per supply-voltage sheet of the Blue Robotics xlsx.

    Returns ``{voltage: ThrustFit}``.  Sheet/column discovery follows the
    reference's fuzzy matching (``T200_fit_polynomial.py:36-100``); the
    spreadsheet is read with the repo's dependency-free stdlib reader
    (:mod:`bluerov2_dynamics_tpu_torch.data.xlsx`) instead of
    pandas+openpyxl.  ``plot_dir``: write one fit figure per voltage
    there (matplotlib is imported only then).
    """
    from bluerov2_dynamics_tpu_torch.data import xlsx
    from bluerov2_dynamics_tpu_torch.utils.log import info, ok

    names = xlsx.sheet_names(xlsx_path)
    results = {}
    for V in voltages:
        sheet = _find_sheet(names, V)
        header, rows = xlsx.read_sheet(xlsx_path, sheet)
        pwm_col, thrust_col = _guess_columns(header)
        info(f"{V}V sheet={sheet!r} pwm_col={pwm_col!r} thrust_col={thrust_col!r}")
        pwm = xlsx.numeric_column(header, rows, pwm_col)
        kgf = xlsx.numeric_column(header, rows, thrust_col)
        m = np.isfinite(pwm) & np.isfinite(kgf) & (pwm >= MIN_PWM) & (pwm <= MAX_PWM)
        fit = fit_forward_reverse(pwm[m], kgf[m])
        ok(f"{V}V positiveThrustPolynomial = {list(fit.pos_coeff)}")
        ok(f"{V}V negativeThrustPolynomial = {list(fit.neg_coeff)}")
        results[V] = fit
        if plot_dir is not None:
            _plot_fit(fit, pwm[m], kgf[m], V, plot_dir)
    return results


def _find_sheet(names, voltage: int) -> str:
    v = str(voltage)
    for key in (f"{v}V", f"{v} V", f"{v}v", f"{v} v"):
        for n in names:
            if n.strip().lower() == key.strip().lower():
                return n
    for n in names:
        s = n.strip().lower().replace(" ", "")
        if v in s and "v" in s:
            return n
    raise ValueError(f"Could not find a {v}V sheet. Available: {names}")


def _guess_columns(columns) -> Tuple[str, str]:
    """Guess (pwm_col, thrust_col) from a list of header strings
    (``T200_fit_polynomial.py:57-99``)."""

    def norm(s: str) -> str:
        s = s.strip().lower().replace("µ", "u")
        s = s.replace("(", " ").replace(")", " ")
        return "".join(s.split())

    cols = list(columns)
    ncols = [norm(str(c)) for c in cols]

    def find(pred):
        for c, nc in zip(cols, ncols):
            if pred(nc):
                return c
        return None

    pwm_col = find(lambda s: "pwm" in s and "us" in s) or find(lambda s: "pwm" in s)
    if pwm_col is None:
        raise ValueError(f"Could not identify PWM column. Columns: {cols}")
    thrust_col = (
        find(lambda s: ("force" in s or "thrust" in s) and "kgf" in s)
        or find(lambda s: "kgf" in s)
        or find(lambda s: "thrust" in s)
        or find(lambda s: "force" in s)
    )
    if thrust_col is None:
        raise ValueError(f"Could not identify thrust column. Columns: {cols}")
    return pwm_col, thrust_col


def _plot_fit(fit: ThrustFit, pwm, kgf, voltage: int, plot_dir):
    """Measured-vs-fit figure in the reference's forward/reverse split
    style (``T200_fit_polynomial.py:207-253``)."""
    from pathlib import Path

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = np.linspace(MIN_PWM, MAX_PWM, 801)
    u_grid = pwm_to_u(grid)
    y_kgf = eval_piecewise(fit, u_grid) / G0
    fwd, rev = u_grid >= 0, u_grid < 0
    m_fwd = np.asarray(pwm) >= MID_PWM
    fig, ax = plt.subplots()
    ax.scatter(pwm[m_fwd], kgf[m_fwd], s=18, color="#0b3d91",
               label="Measured (forward)")
    ax.scatter(pwm[~m_fwd], kgf[~m_fwd], s=18, color="#7fb3ff",
               label="Measured (reverse)")
    ax.plot(grid[fwd], y_kgf[fwd], lw=2, color="#1b7f1b",
            label="Fitted (forward)")
    ax.plot(grid[rev], y_kgf[rev], lw=2, color="#6fdc6f",
            label="Fitted (reverse)")
    ax.set_xlim(MIN_PWM, MAX_PWM)
    ax.set_xlabel("PWM (µs)")
    ax.set_ylabel("Thrust (kgf)")
    ax.set_title(f"T200 Thrust Fit @ {voltage}V "
                 f"(fit domain: PWM {int(MIN_PWM)}–{int(MAX_PWM)})")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    out = Path(plot_dir) / f"T200_{voltage}V_thrust_polynomial_fit.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def main(argv=None) -> None:
    """CLI mirror of the reference script (``T200_fit_polynomial.py:159``):
    fit all three voltage sheets and write the fit figures."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("xlsx", help="Blue Robotics T200 performance .xlsx")
    ap.add_argument("--voltages", type=int, nargs="+", default=[16, 18, 20])
    ap.add_argument("--plot-dir", default=None,
                    help="write T200_{V}V_thrust_polynomial_fit.png here")
    args = ap.parse_args(argv)
    fit_from_xlsx(args.xlsx, tuple(args.voltages), plot_dir=args.plot_dir)


if __name__ == "__main__":
    main()
