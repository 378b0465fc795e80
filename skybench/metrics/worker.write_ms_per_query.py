"""Milliseconds the fragment workers spent writing their outputs for one
query: each ``fragment.write`` span (the exchange's partitioned objects
or the result object, SPAX encode and the store's PUTs), over the
queries answered in the window."""

from skybench import spans


def read(run):
    return spans.ms_per_query(run, ("fragment.write",))
