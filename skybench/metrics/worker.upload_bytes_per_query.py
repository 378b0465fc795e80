"""Bytes the fragment workers copied to the card for one query: the
``bytes`` of each ``fragment.upload`` span (every input column at its
bucketed capacity, padding included, each validity mask and the Bloom
filter's words), over the queries answered in the window."""

from skybench import spans


def read(run):
    return spans.attr_per_query(run, "fragment.upload", "bytes")
