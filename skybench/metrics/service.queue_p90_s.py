"""90th percentile of the seconds a request waited in the service's
queue: its ledger entry's ``started_at - submitted_at``, over the
requests answered in the window."""

import numpy as np


def read(run):
    waits = [a["started_at"] - a["submitted_at"] for a in run.acks
             if a["status"] == "SUCCEEDED" and a["started_at"] is not None
             and a["request_id"] in run.done_requests]
    return float(np.percentile(waits, 90)) if waits else None
