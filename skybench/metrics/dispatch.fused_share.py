"""Share of the fragments that ran a fused kernel (a non-empty
``kernel``), over every fragment the window's answered queries ran."""


def read(run):
    reps = [p for r in run.done for p in run.reports(r)
            if not p.cache_hit]
    n = sum(p.n_fragments for p in reps)
    return 100.0 * sum(p.kernel_fragments for p in reps) / n if n else None
