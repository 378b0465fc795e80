"""90th percentile of the seconds a client waited for a query's rows,
over the queries answered in the window."""

import numpy as np


def read(run):
    waits = [r["end"] - r["start"] for r in run.done]
    return float(np.percentile(waits, 90)) if waits else None
