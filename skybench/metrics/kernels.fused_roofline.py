"""The scan and join kernels' share of their roofline in the window.

Bound: ``skybench.work``'s least time of each fused scan or join
pipeline that completed in the window, counted from its query and, for
a pipeline fed by hash exchanges, from the rows its producers wrote
into them (``work.fused_pipelines``). Device time: the profiler's time
of the kernels those pipelines launch (the NVRTC-compiled scan kernels
``spec_*``, the join kernel and their finishing pass, all
``scan_agg::``). Where the profiler recorded fewer main launches than
the program counted (``kernels.ext.launches``), the time is scaled up by
the ratio, so a lost record cannot raise the share. Q3's top-k runs on
an intermediate the yardstick does not count, and stays out.
"""

from skybench import work

COUNTERS = ("filter_agg", "groupby", "groupby_minmax", "join_probe_agg")


def _ours(name):
    return name.startswith("spec_") or "scan_agg::" in name


def _main(name):
    return name.startswith("spec_") or "join_probe_kernel" in name


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_seconds()
    dev = sum(s for n, (s, _) in times.items() if _ours(n))
    recorded = sum(c for n, (_, c) in times.items() if _main(n))
    counted = sum(run.launches_in_window.get(k, 0) for k in COUNTERS)
    if dev <= 0 or recorded == 0:
        return None
    dev *= max(1.0, counted / recorded)
    bound = 0.0
    for _, _, _, b in work.fused_pipelines(run):
        bound += b
    return 100.0 * bound / dev if bound > 0 else None
