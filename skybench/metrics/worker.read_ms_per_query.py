"""Milliseconds the fragment workers spent loading their inputs for one
query: the self time of each ``fragment.read`` span (storage GETs, SPAX
decode, concatenation; its ``fragment.wait`` children, the watches of a
partial manifest, left out), over the queries answered in the
window."""

from skybench import spans


def read(run):
    return spans.ms_per_query(run, ("fragment.read",), self_time=True)
