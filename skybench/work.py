"""The work a query gives the fused scan and join kernels, counted from
the query itself, never from a kernel.

Each fused fragment reads each column it scans once (its lineitem rows)
and, for a join, the broadcast build side's columns once, in the
columns' own types (``tpchgen.SCHEMAS``); the scan arithmetic is counted
as float64 operations per lineitem row. Outputs (one row a group) and
the validity mask are left out, so a bound errs low, never high. The
bound is the larger of bytes over the card's bandwidth and operations
over its float64 rate.
"""

from __future__ import annotations

import numpy as np

from skybench import peaks, tpchgen

_WIDTH = {c[0]: np.dtype(c[2]).itemsize
          for cols in tpchgen.SCHEMAS.values() for c in cols}

# query → (lineitem columns scanned, build table or None, its columns,
#          float64 operations a lineitem row)
SCANS = {
    "q1": (("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax"), None, (), 13),
    "q6": (("l_shipdate", "l_discount", "l_quantity", "l_extendedprice"),
           None, (), 7),
    "q12": (("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
             "l_shipdate"), "orders", ("o_orderkey", "o_orderpriority"), 8),
    "q14": (("l_partkey", "l_shipdate", "l_extendedprice", "l_discount"),
            "part", ("p_partkey", "p_type"), 6),
    "q19": (("l_partkey", "l_quantity", "l_extendedprice", "l_discount",
             "l_shipmode", "l_shipinstruct"), "part",
            ("p_partkey", "p_brand", "p_container", "p_size"), 15),
}


def bound_s(q: str, fused: int, fragments: int,
            rows: dict[str, int]) -> float:
    """Least time of a pipeline of query ``q`` whose ``fused`` of
    ``fragments`` fragments ran a fused kernel, at the tables' ``rows``."""
    if q not in SCANS or fused <= 0 or fragments <= 0:
        return 0.0
    cols, build, bcols, ops = SCANS[q]
    probe = rows["lineitem"] * fused / fragments
    nbytes = probe * sum(_WIDTH[c] for c in cols)
    if build is not None:
        nbytes += fused * rows[build] * sum(_WIDTH[c] for c in bcols)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               probe * ops / peaks.FP64_FLOPS)
