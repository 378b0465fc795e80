"""Queries of all clients answered in the window with the reference's
rows, a minute. The rate follows the host's pace, which on a shared
host spreads too widely between runs to hold it end to end."""


def read(run):
    return len(run.done) * 60.0 / run.window_s
