"""The analysis layer's CSV reader, without pandas (the card's machine
has none).

:func:`read_csv` reads a results CSV into ``{column: numpy array}`` as
``pandas.read_csv`` with its defaults would type it (int64, float64,
bool or strings; the default NA strings as missing), and parses floats
with :func:`pandas_float`, the digit loop of pandas' default C parser
(``precise_xstrtod``), which is not correctly rounded past 15 digits:
Python's ``float`` differs from it by one ulp on about a third of 17-digit
values, and a number read one ulp apart is written back one ulp apart.
The CSVs the analyzers write go through ``eval/single.py::write_csv``, so
they are byte-equal to the JAX package's pandas output.
"""

from __future__ import annotations

import csv
import re

import numpy as np

# pandas' default na_values
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"^[+-]?\d+$")
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_POW10 = [float(f"1e{i}") for i in range(309)]
_MAX_DIGITS = 17


def pandas_float(s: str) -> float:
    """``s`` as pandas' default float parser reads it: up to 17 significant
    digits accumulated in a double (``n = n * 10 + d``), then one multiply
    or divide by a power of ten.  Raises ``ValueError`` on a string that is
    not a number."""
    p, n = 0, len(s)
    while p < n and s[p].isspace():
        p += 1
    neg = p < n and s[p] == "-"
    p += p < n and s[p] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        decimals = 0
        while digits < _MAX_DIGITS and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            p, digits, decimals = p + 1, digits + 1, decimals + 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {s!r}")
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        p += 1
        eneg = p < n and s[p] == "-"
        p += p < n and s[p] in "+-"
        e, k = 0, 0
        while k < _MAX_DIGITS and p < n and s[p].isdigit():
            e, k, p = e * 10 + ord(s[p]) - 48, k + 1, p + 1
        exponent += -e if eneg else e
    while p < n and s[p].isspace():
        p += 1
    if p != n:
        raise ValueError(f"not a number: {s!r}")
    if exponent > 308:
        return -np.inf if neg else np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(fields: list) -> np.ndarray:
    """One column's fields typed as pandas types them."""
    missing = [f in NA_STRINGS for f in fields]
    present = [f for f, m in zip(fields, missing) if not m]
    if not any(missing) and present and all(_INT.match(f) for f in present):
        return np.array([int(f) for f in present], np.int64)
    try:
        return np.array([np.nan if m else pandas_float(f)
                         for f, m in zip(fields, missing)], np.float64)
    except ValueError:
        pass
    if not any(missing) and present and all(f in _BOOLS for f in present):
        return np.array([_BOOLS[f] for f in present], bool)
    return np.array([np.nan if m else f for f, m in zip(fields, missing)],
                    object)


def read_csv(path) -> dict:
    """``{column: array}`` of a CSV with a header row, in column order,
    typed as ``pandas.read_csv(path)`` types them."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _column([r[j] for r in body])
            for j, name in enumerate(header)}
