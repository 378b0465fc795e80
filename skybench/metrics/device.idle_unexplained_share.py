"""Share of the card's idle time in the window that no span explains:
of the idle gaps of at least 1 ms (``DeviceTrace.gaps``, mapped to the
host's clock through ``host_time``), the part in which no leaf span
(any span but ``query``, ``pipeline`` and ``fragment``) of any query
was open. None off the card."""

from skybench import spans


def read(run):
    shares = spans.idle_share_by_name(run)
    return None if shares is None else shares[None]
