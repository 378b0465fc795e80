"""Thread-milliseconds a query spent waiting on its exchanges: the
engine's waits for an upstream pipeline (``engine.wait``: this plan's
producer gate, the partial manifest's admission, the build side's Bloom
filter) and each fragment's watch of a partial manifest
(``fragment.wait``), summed over threads, over the queries answered in
the window."""

from skybench import spans


def read(run):
    return spans.ms_per_query(run, ("engine.wait", "fragment.wait"))
