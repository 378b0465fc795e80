"""Multi-query DAG validation and topological ordering (service tier).

``QueryService.submit_dag`` takes a list of statements plus a
``depends_on`` edge map (statement index → indices it waits for). The
service only *admits* a node once every dependency SUCCEEDED, so edges
order execution; data sharing needs no edges at all — any two nodes
containing the same subplan (semantic hash) share one materialization
through the result registry automatically, whichever runs first.
"""

from __future__ import annotations


def validate_dag(n: int, depends_on: dict[int, list[int]]) -> None:
    """Reject out-of-range, self-referential, or cyclic edge maps."""
    for node, deps in depends_on.items():
        if not 0 <= node < n:
            raise ValueError(f"DAG node {node} out of range (n={n})")
        for d in deps:
            if not 0 <= d < n:
                raise ValueError(
                    f"DAG dependency {d} of node {node} out of range")
            if d == node:
                raise ValueError(f"DAG node {node} depends on itself")
    if topological_order(n, depends_on) is None:
        raise ValueError("DAG contains a dependency cycle")


def topological_order(n: int,
                      depends_on: dict[int, list[int]]) -> list[int] | None:
    """Kahn's algorithm over ``depends_on``; None if cyclic. Ties keep
    submission (index) order, so the schedule is deterministic."""
    deps = {i: set(depends_on.get(i, ())) for i in range(n)}
    order: list[int] = []
    ready = sorted(i for i in range(n) if not deps[i])
    while ready:
        node = ready.pop(0)
        order.append(node)
        newly = sorted(
            i for i in range(n)
            if node in deps[i] and not (deps[i] - set(order)))
        for i in newly:
            if i not in ready and i not in order:
                ready.append(i)
        ready.sort()
    return order if len(order) == n else None
