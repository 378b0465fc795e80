"""Card time a query costs, in ms: the seconds in which the card ran any
work (kernels, copies, fills: the union of the profiler's intervals)
from the window's open until the last query sent in the window has
answered, over the queries sent in it. Every query sent is counted
whole, with all of its work, so the window's close cuts none."""


def read(run):
    if run.trace is None or not run.records:
        return None
    return 1000.0 * run.trace.busy_s(whole=True) / len(run.records)
