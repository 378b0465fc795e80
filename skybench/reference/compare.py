"""Judge one query's rows against the reference's.

Rows are matched by the query's group keys (``tpch.KEYS``), which must
be the same set on both sides, and so must the columns and the row
count. Each value is then compared by its relative gap,
``|got - want| / |want|`` (the gap itself where the reference reads 0):
the largest gap over the run is the number that the run's limit holds.
"""

from __future__ import annotations

import numpy as np

from skybench.reference.tpch import KEYS


def _by_keys(cols: dict, keys: tuple) -> dict:
    if not keys:
        return cols
    order = np.lexsort([np.asarray(cols[k]) for k in reversed(keys)])
    return {c: np.asarray(v)[order] for c, v in cols.items()}


def judge(q: str, got: dict, want: dict) -> tuple[str | None, float]:
    """(what differs in the rows' shape or keys, or None; the largest
    relative gap of a value)."""
    if sorted(got) != sorted(want):
        return f"columns {sorted(got)} != {sorted(want)}", float("inf")
    n_got = len(next(iter(got.values()))) if got else 0
    n_want = len(next(iter(want.values()))) if want else 0
    if n_got != n_want:
        return f"{n_got} rows, the reference {n_want}", float("inf")
    keys = KEYS[q]
    g, w = _by_keys(got, keys), _by_keys(want, keys)
    for k in keys:
        if not np.array_equal(np.asarray(g[k], np.int64),
                              np.asarray(w[k], np.int64)):
            return f"keys {k} differ", float("inf")
    gap = 0.0
    for c in want:
        if c in keys:
            continue
        a = np.asarray(g[c], np.float64)
        b = np.asarray(w[c], np.float64)
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            return f"{c} not finite", float("inf")
        den = np.where(b == 0, 1.0, np.abs(b))
        if len(a):
            gap = max(gap, float(np.max(np.abs(a - b) / den)))
    return None, gap
