"""Dependency-free .xlsx sheet reader (stdlib ``zipfile`` + ``xml.etree``).

The reference reads the Blue Robotics T200 performance workbook with
``pandas.read_excel`` (``rosbags/T200/T200_fit_polynomial.py:168-178``),
which requires ``openpyxl``.  Neither is needed for the simple tabular
sheets involved: an .xlsx is a zip of XML parts — ``xl/workbook.xml``
names the sheets and maps them through ``xl/_rels/workbook.xml.rels`` to
``xl/worksheets/sheetN.xml``; string cells (``t="s"``) index into
``xl/sharedStrings.xml``.  This module implements exactly that subset
(shared/inline/formula strings, numeric and boolean cells), in the same
dependency-free spirit as the repo's sqlite3+CDR rosbag reader
(``data/bag_sqlite.py``).  Counterpart of
``bluerov2_dynamics_tpu/data/xlsx.py``.
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Tuple
from xml.etree import ElementTree as ET

import numpy as np

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
_REL_NS = {"r": "http://schemas.openxmlformats.org/package/2006/relationships"}
_RID = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
        "relationships}id")


def _col_index(cell_ref: str) -> int:
    """'A1' -> 0, 'G202' -> 6, 'AA3' -> 26."""
    idx = 0
    for ch in cell_ref:
        if not ch.isalpha():
            break
        idx = idx * 26 + (ord(ch.upper()) - ord("A") + 1)
    return idx - 1


def _sheet_targets(zf: zipfile.ZipFile) -> Dict[str, str]:
    """Map sheet name -> zip member path, in workbook order."""
    wb = ET.fromstring(zf.read("xl/workbook.xml"))
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    rid_to_target = {
        rel.get("Id"): rel.get("Target")
        for rel in rels.findall("r:Relationship", _REL_NS)
    }
    out: Dict[str, str] = {}
    for sheet in wb.findall("m:sheets/m:sheet", _NS):
        target = rid_to_target.get(sheet.get(_RID), "")
        if not target:
            continue
        if not target.startswith("/"):
            target = "xl/" + target
        out[sheet.get("name")] = target.lstrip("/")
    return out


def _shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
    except KeyError:
        return []
    strings = []
    for si in root.findall("m:si", _NS):
        # a <si> is either one <t> or rich-text <r><t> runs — join all <t>
        strings.append("".join(t.text or "" for t in si.iter(
            "{%s}t" % _NS["m"])))
    return strings


def _cell_value(c, shared: List[str]):
    t = c.get("t", "n")
    if t == "inlineStr":
        return "".join(el.text or "" for el in c.iter("{%s}t" % _NS["m"]))
    v = c.find("m:v", _NS)
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t == "str":
        return v.text
    if t == "b":
        return bool(int(v.text))
    try:
        return float(v.text)
    except ValueError:  # date/other oddities — hand back the raw text
        return v.text


def sheet_names(path) -> List[str]:
    """Sheet names in workbook order (parity: ``pd.ExcelFile.sheet_names``)."""
    with zipfile.ZipFile(path) as zf:
        return list(_sheet_targets(zf))


def read_sheet(path, sheet_name: str) -> Tuple[List[str], List[list]]:
    """Read one sheet as ``(header, rows)``.

    The first non-empty row is the header (stringified, like
    ``pd.read_excel``'s default ``header=0``); every following row is a
    list padded with ``None`` to the header width.  Fully-empty rows are
    dropped (parity: the reference's ``df.dropna(how="all")``,
    ``T200_fit_polynomial.py:177``).
    """
    with zipfile.ZipFile(path) as zf:
        targets = _sheet_targets(zf)
        if sheet_name not in targets:
            raise KeyError(
                f"sheet {sheet_name!r} not in {list(targets)}")
        shared = _shared_strings(zf)
        root = ET.fromstring(zf.read(targets[sheet_name]))

    raw_rows: List[Dict[int, object]] = []
    for row in root.findall("m:sheetData/m:row", _NS):
        cells = {}
        next_col = 0  # the cell 'r' attribute is optional; ref-less cells
        for c in row.findall("m:c", _NS):  # are positionally sequential
            ref = c.get("r")
            col = _col_index(ref) if ref else next_col
            next_col = col + 1
            val = _cell_value(c, shared)
            if val is not None:
                cells[col] = val
        if cells:
            raw_rows.append(cells)
    if not raw_rows:
        return [], []

    header_cells = raw_rows[0]
    # width = max column index over ALL rows, not just the header: a short
    # header row must not silently drop data cells beyond it (pandas
    # surfaces such columns as 'Unnamed: N'; here they become 'colN')
    ncols = max(max(cells) for cells in raw_rows) + 1
    header = [str(header_cells.get(i, f"col{i}")) for i in range(ncols)]
    rows = [[cells.get(i) for i in range(ncols)] for cells in raw_rows[1:]]
    return header, rows


def numeric_column(header: List[str], rows: List[list],
                   column: str) -> np.ndarray:
    """One column as float64, non-numeric coerced to NaN (parity:
    ``pd.to_numeric(errors="coerce")``)."""
    j = header.index(column)

    def coerce(v) -> float:
        if v is None:
            return np.nan
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, (int, float)):
            return float(v)
        try:
            return float(str(v).strip())
        except ValueError:
            return np.nan

    return np.array([coerce(r[j] if j < len(r) else None) for r in rows],
                    dtype=float)
