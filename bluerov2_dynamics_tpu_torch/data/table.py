"""The port's column table: an ordered ``dict[str, np.ndarray]``, and the
few pandas operations the host data path needs, with pandas' exact
semantics in numpy and the standard library.

The JAX package's data path is built on pandas DataFrames
(``bag2csv``, ``bag_sqlite``, ``frames``, ``csv_loader``,
``wrench.augment_csv``); the card's machine has no pandas.  Each function
here names the pandas call it reproduces, and ``tests/test_torch_bag2csv.py``
holds it against that call:

* :func:`read_csv` / :func:`write_csv`: ``pd.read_csv`` / ``DataFrame.to_csv``
  (``index=False``), numbers parsed by pandas' own default converter
  (:func:`precise_xstrtod`, not always correctly rounded) or, on request,
  exactly;
* :func:`sort_index`: ``sort_values`` (numpy quicksort, NaN last);
* :func:`first_unique`: ``drop_duplicates(keep="first")``;
* :func:`asof_nearest`: ``merge_asof(direction="nearest", tolerance=...)``;
* :func:`to_ns`, :func:`resample_mean`, :func:`interpolate_time`:
  ``pd.to_timedelta(t, unit="s")``, ``TimedeltaIndex`` ``resample(step).mean()``
  and ``interpolate(method="time")``;
* :func:`ffill`, :func:`bfill`.

A table is a plain ``dict`` of equal-length 1-D arrays: float64 for numeric
columns, object arrays of ``str`` for columns that do not parse as numbers.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

Table = Dict[str, np.ndarray]

# pandas' default missing-value spellings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


_POW10 = np.array([float(f"1e{k}") for k in range(309)])  # the C literals 1e0 .. 1e308
_SPACE = np.zeros(256, bool)
_SPACE[[9, 10, 11, 12, 13, 32]] = True
_INF = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf, "+infinity": np.inf,
        "-inf": -np.inf, "-infinity": -np.inf}
# the parser's states
_LEAD, _INT, _FRAC, _ESIGN, _EXP, _TRAIL, _END, _ERR = range(8)


def precise_xstrtod(fields: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """pandas' default float converter (``precise_xstrtod`` of its C
    tokenizer), vectorised over ``fields``: ``(values, ok)``.

    It keeps at most 17 mantissa digits, leading zeros included (so
    ``0.05029208843735732`` loses its last digit), accumulates them as
    ``number * 10 + digit`` in double precision, then scales once by a
    power of ten.  The result is not always the correctly rounded value.
    ``ok`` is False where pandas' converter refuses the field (no
    digits, an ``e`` without exponent digits, trailing characters, an
    exponent above 308).
    """
    n = len(fields)
    try:
        raw = np.array(fields, dtype=bytes)
    except UnicodeEncodeError:
        return np.full(n, np.nan), np.zeros(n, bool)
    width = raw.dtype.itemsize
    chars = np.zeros((n, width + 1), np.uint8)
    if width:
        chars[:, :width] = np.frombuffer(raw.tobytes(), np.uint8).reshape(n, width)
    state = np.full(n, _LEAD, np.int8)
    neg, eneg = np.zeros(n, bool), np.zeros(n, bool)
    number = np.zeros(n)
    nd, ndec, ned = (np.zeros(n, np.int64) for _ in range(3))
    exponent, e_val = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for j in range(width + 1):
        c = chars[:, j]
        digit = (c >= 48) & (c <= 57)
        d = c.astype(np.float64) - 48.0
        space, end = _SPACE[c], c == 0
        sci = (c == 69) | (c == 101)
        # leading whitespace, then an optional sign; anything else is the number
        lead = state == _LEAD
        sign = lead & ((c == 45) | (c == 43))
        neg |= lead & (c == 45)
        st = np.where(lead & ~space & ~sign, _INT, state)  # this char is the number's first
        new = st.copy()
        new[sign] = _INT
        mant = (st == _INT) | (st == _FRAC)
        take = mant & digit & (nd < 17)
        number = np.where(take, number * 10.0 + d, number)
        exponent += (st == _INT) & digit & (nd >= 17)
        ndec += (st == _FRAC) & take
        nd += take
        intp = st == _INT
        new[intp & (c == 46)] = _FRAC
        new[mant & sci] = _ESIGN
        new[mant & end] = _END
        new[mant & space] = _TRAIL
        new[mant & ~digit & ~sci & ~end & ~space & ~(intp & (c == 46))] = _ERR
        es = st == _ESIGN
        eneg |= es & (c == 45)
        new[es & ((c == 45) | (c == 43))] = _EXP
        new[es & digit] = _EXP
        new[es & ~digit & (c != 45) & (c != 43)] = _ERR
        ex = (st == _EXP) | (es & digit)
        etake = ex & digit & (ned < 17)
        e_val = np.where(etake, e_val * 10 + (c.astype(np.int64) - 48), e_val)
        ned += etake
        new[ex & digit & ~etake] = _ERR  # an 18th exponent digit is not consumed
        new[ex & (end | space) & (ned == 0)] = _ERR
        new[ex & end & (ned > 0)] = _END
        new[ex & space & (ned > 0)] = _TRAIL
        new[ex & ~digit & ~end & ~space] = _ERR
        tr = st == _TRAIL
        new[tr & end] = _END
        new[tr & ~end & ~space] = _ERR
        state = new
    ok = (state == _END) & (nd > 0)
    number = np.where(neg, -number, number)
    e = exponent - ndec + np.where(eneg, -e_val, e_val)
    ok &= e <= 308
    out = np.where(e > 0, number * _POW10[np.clip(e, 0, 308)], number)
    sub = e < -308
    out = np.where(sub, number / _POW10[np.clip(-308 - e, 0, 308)] / _POW10[308], out)
    out = np.where(sub & (e < -616), 0.0, out)
    out = np.where((e <= 0) & ~sub, number / _POW10[np.clip(-e, 0, 308)], out)
    ok &= ~np.isinf(out)
    return out, ok


def _parse_column(values: List[str]) -> np.ndarray:
    """One column as pandas reads it: float64 (NaN for its missing-value
    spellings), or an object array of the strings where a field is not a
    number."""
    na = np.array([v in NA_STRINGS for v in values], bool)
    out, ok = precise_xstrtod(values)
    out[na] = np.nan
    if not na.any() and all(v.strip().lstrip("+-").isdigit() for v in values):
        try:  # an all-integer column is read as int64, then converted exactly
            return np.array([int(v) for v in values], np.int64).astype(np.float64)
        except OverflowError:
            pass
    for i in np.flatnonzero(~ok & ~na).tolist():
        inf = _INF.get(values[i].lower())
        if inf is None:
            return np.array(values, dtype=object)
        out[i] = inf
    return out


def read_csv(path) -> Table:
    """Read a comma-separated file with a header row into a table, as
    ``pd.read_csv(path)`` does.

    Blank lines are skipped and pandas' missing-value spellings read as
    NaN.  Numbers are parsed by pandas' own default converter, reproduced
    bit for bit (:func:`precise_xstrtod`), so the port's loaders give the
    JAX package's arrays exactly; that converter is not always correctly
    rounded (a 17-digit value written by ``repr`` can come back up to
    ~1e-12 relative off; ``tests/test_torch_csv_loader.py`` measures it).
    """
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh) if r]
    if not rows:
        raise ValueError(f"{path}: no header row")
    header, body = rows[0], rows[1:]
    n = len(header)
    for k, r in enumerate(body):
        if len(r) < n:
            body[k] = r + [""] * (n - len(r))
        elif len(r) > n:
            raise ValueError(f"{path}: row {k + 2} has {len(r)} fields, the header {n}")
    cols = list(zip(*body)) if body else [()] * n
    return {name: _parse_column(list(c)) for name, c in zip(header, cols)}


def _format(col: np.ndarray) -> List[str]:
    if col.dtype == object:
        return [str(v) for v in col.tolist()]
    col = np.asarray(col, np.float64)
    out = [repr(v) for v in col.tolist()]
    for i in np.flatnonzero(np.isnan(col)).tolist():
        out[i] = ""
    return out


def write_csv(path, table: Table) -> Path:
    """Write ``table`` as ``DataFrame.to_csv(path, index=False)`` does for
    float64 columns: the header row, then each value by its shortest
    round-trip ``repr``, NaN as an empty field."""
    path = Path(path)
    cols = [_format(np.asarray(v)) for v in table.values()]
    with open(path, "w", newline="") as fh:
        fh.write(",".join(table) + "\n")
        fh.writelines(",".join(r) + "\n" for r in zip(*cols))
    return path


def nrows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: Table, idx) -> Table:
    """Rows ``idx`` of every column (``DataFrame.iloc[idx]``)."""
    return {k: np.asarray(v)[idx] for k, v in table.items()}


def sort_index(a) -> np.ndarray:
    """The row order ``sort_values`` gives by one float column: numpy's
    quicksort of the non-NaN values (pandas' ``nargsort``), NaN rows
    last in their order.  The quicksort is not stable; this is the same
    call on the same values, so ties land where pandas puts them."""
    a = np.asarray(a, np.float64)
    mask = np.isnan(a)
    idx = np.arange(len(a))
    return np.concatenate([idx[~mask][a[~mask].argsort(kind="quicksort")],
                           np.flatnonzero(mask)])


def sort_by(table: Table, col: str = "t") -> Table:
    """``table.sort_values(col).reset_index(drop=True)``."""
    return take(table, sort_index(table[col]))


def first_unique(a) -> np.ndarray:
    """Sorted row indices ``drop_duplicates(subset=col, keep="first")``
    keeps: the first row of each value, NaN rows counting as one value."""
    _, first = np.unique(np.asarray(a, np.float64), return_index=True, equal_nan=True)
    return np.sort(first)


def asof_nearest(left, right, tolerance: float) -> np.ndarray:
    """For each key of ``left`` (sorted), the row of ``right`` (sorted) that
    ``merge_asof(direction="nearest", tolerance=tolerance)`` joins, or -1.

    pandas takes the backward match (the LAST right key <= left) and the
    forward match (the FIRST right key >= left), drops either one further
    than ``tolerance`` (a distance equal to it is kept), then keeps the
    backward one unless the forward one is strictly nearer.
    """
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    n = len(right)
    b = np.searchsorted(right, left, side="right") - 1
    f = np.searchsorted(right, left, side="left")
    f = np.where(f < n, f, -1)
    if n:
        bdiff = left - right[np.maximum(b, 0)]
        fdiff = right[np.maximum(f, 0)] - left
        b = np.where((b >= 0) & (bdiff > tolerance), -1, b)
        f = np.where((f >= 0) & (fdiff > tolerance), -1, f)
    both = (b >= 0) & (f >= 0)
    if n:
        bdiff = left - right[np.maximum(b, 0)]
        fdiff = right[np.maximum(f, 0)] - left
        pick = np.where(bdiff <= fdiff, b, f)
    else:
        pick = b
    return np.where(both, pick, np.where(b >= 0, b, f))


def merge_asof_nearest(left: Table, right: Table, on: str, tolerance: float) -> Table:
    """``pd.merge_asof(left, right, on=on, direction="nearest",
    tolerance=tolerance)`` for sorted ``on`` columns: the left columns,
    then the right ones (NaN where no row joins)."""
    j = asof_nearest(left[on], right[on], tolerance)
    out = dict(left)
    hit = j >= 0
    for k, v in right.items():
        if k == on:
            continue
        col = np.full(len(j), np.nan)
        col[hit] = np.asarray(v, np.float64)[j[hit]]
        out[k] = col
    return out


def dropna(table: Table, subset: Optional[Iterable[str]] = None) -> Table:
    """``table.dropna(subset=subset)`` (all columns by default)."""
    keys = list(table) if subset is None else list(subset)
    bad = np.zeros(nrows(table), bool)
    for k in keys:
        bad |= np.isnan(np.asarray(table[k], np.float64))
    return take(table, ~bad)


def to_ns(t) -> np.ndarray:
    """``pd.to_timedelta(t, unit="s")`` as int64 nanoseconds: the whole
    seconds, then the fraction rounded to 9 decimals (half to even) and
    truncated, as pandas' ``cast_from_unit_vectorized`` does (1.6e-9 s ->
    2 ns, 2.5e-9 s -> 2 ns)."""
    t = np.asarray(t, np.float64)
    base = t.astype(np.int64)
    frac = np.round(t - base, 9)
    return base * 1_000_000_000 + (frac * 1e9).astype(np.int64)


def step_ns(hz: float) -> int:
    """``pd.Timedelta(seconds=1.0 / hz)`` in nanoseconds (truncated)."""
    return int((1.0 / float(hz)) * 1_000_000_000)


def resample_mean(ns: np.ndarray, cols: Table, step: int) -> Tuple[np.ndarray, Table]:
    """``DataFrame.set_index(TimedeltaIndex(ns)).resample(step).mean()``.

    The bins are anchored at the FIRST sample, not at zero: bin ``k`` is
    ``[ns.min() + k*step, ns.min() + (k+1)*step)``, labelled by its start,
    up to the bin holding ``ns.max()``.  Each bin's mean skips NaN; an empty
    or all-NaN bin is NaN.  The sum is compensated (Kahan) in row order,
    with the compensation reset where it turns NaN (an infinite value), as
    pandas' ``group_mean`` does, so the means carry pandas' bits.  Rows are
    first put in time order by a stable sort, as resample does.
    """
    ns = np.asarray(ns, np.int64)
    order = np.argsort(ns, kind="mergesort")
    ns = ns[order]
    start, end = int(ns[0]), int(ns[-1])
    labels = np.arange(start, end + 1, step, dtype=np.int64)
    edges = np.searchsorted(ns, labels + step, side="left")
    lab = np.repeat(np.arange(len(labels)), np.diff(np.concatenate([[0], edges])))
    pos = np.arange(len(ns)) - np.concatenate([[0], edges])[lab]  # index within the bin
    out = {}
    for name, v in cols.items():
        v = np.asarray(v, np.float64)[order]
        s = np.zeros(len(labels))
        comp = np.zeros(len(labels))
        cnt = np.zeros(len(labels), np.int64)
        for k in range(int(pos.max()) + 1 if len(pos) else 0):
            rows = np.flatnonzero(pos == k)
            g, val = lab[rows], v[rows]
            ok = ~np.isnan(val)
            g, val = g[ok], val[ok]
            cnt[g] += 1
            y = val - comp[g]
            t = s[g] + y
            with np.errstate(invalid="ignore"):  # inf - inf: the NaN pandas resets
                c = t - s[g] - y
            comp[g] = np.where(np.isnan(c), 0.0, c)
            s[g] = t
        with np.errstate(invalid="ignore", divide="ignore"):
            out[name] = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
    return labels, out


def interpolate_time(x_ns: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``Series.interpolate(method="time")`` on a timedelta index: NaN
    between and after valid values filled by ``np.interp`` in the index's
    nanoseconds (after the last valid value: that value), NaN before the
    first valid value kept."""
    y = np.array(y, np.float64)
    invalid = np.isnan(y)
    if invalid.all() or not invalid.any():
        return y
    x = np.asarray(x_ns, np.int64)
    valid = ~invalid
    xv = x[valid]
    order = np.argsort(xv)
    y[invalid] = np.interp(x[invalid], xv[order], y[valid][order])
    y[:int(np.argmax(valid))] = np.nan
    return y


def ffill(a) -> np.ndarray:
    """``Series.ffill()``."""
    a = np.asarray(a, np.float64)
    idx = np.where(np.isnan(a), 0, np.arange(len(a)))
    np.maximum.accumulate(idx, out=idx)
    return a[idx]  # a leading NaN run maps to a[0], itself NaN


def bfill(a) -> np.ndarray:
    """``Series.bfill()``."""
    return ffill(np.asarray(a, np.float64)[::-1])[::-1]
