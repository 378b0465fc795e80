"""The work a query gives the fused scan and join kernels, counted from
the query itself and the pipeline reports of its run, never from a
kernel.

A fused pipeline is classed by what fed it, read from the reports
(``PipelineReport``) of its own query:

- **scan-fed**: no other pipeline of the query with a lower ``pid``
  (the planner numbers a join's producers before the pipeline that
  reads them) wrote a hash exchange (its ``exchange_strategy`` is
  empty). Its fragments scan lineitem and, for a join, read the
  broadcast build side whole. Each fused fragment reads its share of
  each lineitem column it scans once and the build side's columns once,
  in the columns' own types (``tpchgen.SCHEMAS``); the scan arithmetic
  is counted as float64 operations per lineitem row (``bound_s``).
- **exchange-fed**: some such pipeline wrote a hash exchange: the
  planner repartitioned the join, and the fused pipeline reads its
  probe and build rows from the partitions those producers wrote
  (``scan_exchange`` in partition mode). Each producer's rows are its
  ``partition_stats`` rows (its ``rows_out`` where it has none); a
  pipeline whose fused fragments are ``fused`` of ``fragments`` is given
  the smallest ``len(partitions) * fused // fragments`` partitions of
  each. The join needs at least the columns ``EXCHANGED`` lists of each
  side: its key and what the join and the aggregate above it read. The
  two producers with the fewest rows stand for the two sides, the one
  with more rows paired with the narrower side, which is never more
  than the true pairing's bytes. A broadcast-downgraded build side
  (``core.adaptive``), which every fragment reads whole, is counted
  once; no operation is counted (``exchange_bound_s``).

Outputs (one row a group) and the validity mask are left out, so a
bound errs low, never high. The bound is the larger of bytes over the
card's bandwidth and operations over its float64 rate.
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

# the fused scan and join kernels a pipeline report can name
KERNELS = ("filter_agg", "groupby_onehot", "segmented_minmax",
           "join_probe_agg")

# query → (probe columns, build columns) a repartitioned join reads from
# its exchanges: the keys and what the join and the aggregate above it
# need (the probe side's filter ran in its producer)
EXCHANGED = {
    "q12": (("l_orderkey", "l_shipmode"), ("o_orderkey", "o_orderpriority")),
    "q14": (("l_partkey", "l_extendedprice", "l_discount"),
            ("p_partkey", "p_type")),
    "q19": (("l_partkey", "l_quantity", "l_extendedprice", "l_discount"),
            ("p_partkey", "p_brand", "p_container", "p_size")),
}


def bound_s(q: str, fused: int, fragments: int,
            rows: dict[str, int]) -> float:
    """Least time of a scan-fed pipeline of query ``q`` whose ``fused``
    of ``fragments`` fragments ran a fused kernel, at the tables'
    ``rows``."""
    if q not in SCANS or fused <= 0 or fragments <= 0:
        return 0.0
    cols, build, bcols, ops = SCANS[q]
    probe = rows["lineitem"] * fused / fragments
    nbytes = probe * sum(_WIDTH[c] for c in cols)
    if build is not None:
        nbytes += fused * rows[build] * sum(_WIDTH[c] for c in bcols)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               probe * ops / peaks.FP64_FLOPS)


def producers(report, query_reports) -> list:
    """The pipelines of the query that wrote a hash exchange before
    ``report``'s: none for a scan-fed pipeline."""
    return [r for r in query_reports if r is not report
            and r.exchange_strategy and r.pid < report.pid]


def exchange_rows(producer, fused: int, fragments: int) -> int:
    """The rows of ``producer``'s exchange that ``fused`` of
    ``fragments`` fragments read, at the least."""
    parts = sorted(int(s["rows"]) for s in producer.partition_stats) \
        if producer.partition_stats else [int(producer.rows_out)]
    return sum(parts[:len(parts) * fused // fragments])


def exchange_bound_s(q: str, fused: int, fragments: int,
                     feeders: list) -> float:
    """Least time of an exchange-fed pipeline of query ``q`` whose
    ``fused`` of ``fragments`` fragments ran a fused kernel, fed by the
    hash exchanges of ``feeders``."""
    if q not in EXCHANGED or fused <= 0 or fragments <= 0 or not feeders:
        return 0.0
    rows = sorted(exchange_rows(p, fused, fragments) for p in feeders)[:2]
    widths = sorted(sum(_WIDTH[c] for c in cols) for cols in EXCHANGED[q])
    # the most rows with the narrowest side's width
    nbytes = sum(r * w for r, w in zip(reversed(rows), widths))
    return nbytes / peaks.HBM_BYTES_PER_S


def fused_pipelines(run):
    """Each fused scan or join pipeline that completed in the window, of
    a query the yardstick counts: (query, report, its exchange feeders,
    its bound in seconds), in the order the window saw them."""
    for qid, _, rep in run.pipelines_in_window():
        if rep.kernel not in KERNELS or rep.cache_hit:
            continue
        q = run.kind_of_qid(qid)
        if q is None:
            continue
        with run.recorder.lock:
            mates = [r for _, r in run.recorder.pipelines.get(qid, [])]
        feeders = producers(rep, mates)
        if feeders:
            b = exchange_bound_s(q, rep.kernel_fragments, rep.n_fragments,
                                 feeders)
        else:
            b = bound_s(q, rep.kernel_fragments, rep.n_fragments,
                        run.table_rows)
        yield q, rep, feeders, b
