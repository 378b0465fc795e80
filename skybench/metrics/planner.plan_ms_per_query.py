"""Milliseconds the planner took for one query: its ``query.plan`` span
(``SkyriseSession._plan_for``: parse, bind, optimize, compile), over the
queries answered in the window."""

from skybench import spans


def read(run):
    return spans.ms_per_query(run, ("query.plan",))
