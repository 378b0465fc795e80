"""Bytes the fragment workers read from storage for one query: the
``bytes_read`` of each pipeline report, summed, over the queries
answered in the window."""


def read(run):
    if not run.done:
        return None
    total = sum(p.bytes_read for r in run.done for p in run.reports(r))
    return total / len(run.done)
