"""The one generator of the benchmark's traffic.

A traffic mix is a JSON file under ``skybench/traffic/``, read here:

- ``clients``: closed-loop clients, each sending its next query only
  when its last one has answered (analysts who wait for their answer);
- ``mix``: each query's weight, a whole number: how often it comes in
  each of a client's shuffled blocks of queries;
- ``queries_per_client``: the length of each client's list, some times
  what a window completes; a client that reaches its list's end sends
  no more, and the run says so.

From the seed it makes each client's list of (query, parameter set,
text): fixed by the seed, so that only how far a client gets depends on
the system's speed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from skybench import qgen


def load(name: str, root: Path) -> dict:
    t = json.loads((root / "traffic" / f"{name}.json").read_text())
    if set(t["mix"]) - set(qgen.QUERIES):
        raise ValueError(f"traffic {name}: unknown queries in its mix")
    if int(t["queries_per_client"]) < 1:
        raise ValueError(f"traffic {name}: no queries a client")
    return t


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator from the run's seed; any whole number, negative or
    past 64 bits, maps to a seed numpy takes."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def client_lists(traffic: dict,
                 seed: int) -> list[list[tuple[str, dict, str]]]:
    """Each client's ``queries_per_client`` queries. A client's queries
    come in blocks that hold each query of the mix as often as its
    (whole) weight, shuffled from the seed: every seed gives every
    client the same work, in another order and with other parameters.
    Parameter sets are drawn in turn over the clients, without
    replacement."""
    c = int(traffic["clients"])
    per = int(traffic["queries_per_client"])
    names = sorted(traffic["mix"])
    block = [q for q in names for _ in range(int(traffic["mix"][q]))]
    rng = rng_for(seed, 1)
    kinds = [[str(q) for _ in range(-(-per // len(block)))
              for q in rng.permutation(block)][:per] for _ in range(c)]
    draws = {q: qgen.ParamDraw(q, rng_for(seed, 2, i))
             for i, q in enumerate(qgen.QUERIES)}
    out: list[list] = [[] for _ in range(c)]
    for i in range(per):
        for k in range(c):
            q = kinds[k][i]
            p = draws[q]()
            out[k].append((q, p, qgen.render(q, p)))
    return out


def sequence(traffic: dict, seed: int) -> list[tuple[str, dict, str]]:
    """The clients' queries taken in turn: client 0's first, client 1's
    first, ..., client 0's second, ..."""
    lists = client_lists(traffic, seed)
    return [lst[i] for i in range(len(lists[0])) for lst in lists]
