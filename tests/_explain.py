"""The port's EXPLAIN against the reference's: the one dispatch arm the port
takes where the reference misses, a sort-strategy aggregate over joins
(``repro_torch.exec.lower``'s ``sort_agg`` arm over a chain, TPC-H Q3's
join stage), which names its kernel on the port's pipeline line."""

import re

# the TPC-H queries with such a stage, and how many, at SF 0.01 under the
# default planner
JOIN_SORT_AGG = {"q3": 1}

_ARM = re.compile(r" · kernel=sort_agg( block=\d+ resident=\d+)? "
                  r"\(memory-bound\)(\n    ops: [^\n]* join → [^\n]*"
                  r"(partial|merge)_agg)")


def without_join_sort_agg(text: str) -> tuple[str, int]:
    """``text`` without the ``sort_agg`` annotation of each pipeline that
    joins before it aggregates, and how many it took out."""
    return _ARM.subn(r"\2", text)
