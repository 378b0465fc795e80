"""Plain numpy answers to the benchmark's six TPC-H queries.

Written from the queries' text (spec §2.4 and ``skybench.qgen``), over the
benchmark's own numpy tables (``skybench.tpchgen``): no planner, no
engine, nothing of the program. Float arithmetic and every sum run in
``dtype``: float64 gives the reference; float32, the nearest precision
below, gives the control that the comparison must reject. Sums over a
few groups are numpy's pairwise sums over each group's rows, so the
reference's own rounding stays near float64's epsilon. What does not
depend on a query's parameters (the join indexes, Q1's groups, the rows
Q19's fixed terms keep) is made once a run.

A result is a dict of columns named as the query's select list; group
keys are the dictionary codes (int64) the port returns.
"""

from __future__ import annotations

import threading

import numpy as np

from skybench import tpchgen

EPOCH = np.datetime64("1970-01-01")
_PROMO = np.array([t.startswith("PROMO") for t in tpchgen.PTYPE])


def day(s: str) -> int:
    return int((np.datetime64(s) - EPOCH).astype(int))


def _month_after(year: int, month: int) -> str:
    y, m = (year + 1, 1) if month == 12 else (year, month + 1)
    return f"{y}-{m:02d}-01"


def _index(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Row of ``keys`` (unique) holding each probe key; -1 where none."""
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(keys[order], probe)
    pos = np.clip(pos, 0, len(keys) - 1)
    hit = keys[order][pos] == probe
    return np.where(hit, order[pos], -1)


class Tables:
    """The whole tables and what every query reuses: each lineitem row's
    order and part, each order's customer, and, made at first use, each
    Q1 group's rows in ship-date order and the rows Q19's fixed terms
    keep."""

    def __init__(self, tables: dict[str, dict[str, np.ndarray]]):
        self.li, self.o = tables["lineitem"], tables["orders"]
        self.c, self.p = tables["customer"], tables["part"]
        self.li_o = _index(self.o["o_orderkey"], self.li["l_orderkey"])
        self.li_p = _index(self.p["p_partkey"], self.li["l_partkey"])
        self.o_c = _index(self.c["c_custkey"], self.o["o_custkey"])
        self._lock = threading.Lock()
        self._made: dict[str, object] = {}

    def made(self, name: str, fn):
        with self._lock:
            if name not in self._made:
                self._made[name] = fn(self)
            return self._made[name]


def _gsum(values: np.ndarray, groups: np.ndarray, n: int) -> np.ndarray:
    """Sum of ``values`` by group id in ``values``' dtype."""
    if n <= 64:
        return np.array([values[groups == g].sum(dtype=values.dtype)
                         for g in range(n)], dtype=values.dtype)
    if values.dtype == np.float64:
        return np.bincount(groups, weights=values, minlength=n)
    order = np.argsort(groups, kind="stable")
    g, v = groups[order], values[order]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    out = np.zeros(n, values.dtype)
    if len(v):
        out[g[starts]] = np.add.reduceat(v, starts)
    return out


def _q1_groups(t: Tables) -> list[dict]:
    """Each (returnflag, linestatus) group's rows, by ship date."""
    li = t.li
    g = li["l_returnflag"].astype(np.int64) * len(tpchgen.LINESTATUS) \
        + li["l_linestatus"]
    order = np.lexsort((li["l_shipdate"], g))
    bounds = np.searchsorted(g[order], np.arange(
        len(tpchgen.RETURNFLAG) * len(tpchgen.LINESTATUS) + 1))
    cols = ("l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax")
    return [{c: li[c][order[a:b]] for c in cols}
            for a, b in zip(bounds[:-1], bounds[1:])]


def q1(t: Tables, p: dict, f=np.float64) -> dict:
    cut = day("1998-12-01") - int(p["delta"])
    one = f(1)
    rows = []
    for g, grp in enumerate(t.made("q1", _q1_groups)):
        n = int(np.searchsorted(grp["l_shipdate"], cut, side="right"))
        if n == 0:
            continue
        qty = grp["l_quantity"][:n].astype(f)
        price = grp["l_extendedprice"][:n].astype(f)
        disc = grp["l_discount"][:n].astype(f)
        tax = grp["l_tax"][:n].astype(f)
        disc_price = price * (one - disc)
        sums = [v.sum(dtype=f) for v in
                (qty, price, disc_price, disc_price * (one + tax), disc)]
        rows.append((g, n, sums))
    col = {k: np.array([r[2][i] for r in rows], dtype=f) for i, k in
           enumerate(("sum_qty", "sum_base_price", "sum_disc_price",
                      "sum_charge", "disc"))}
    keys = np.array([g for g, _, _ in rows], dtype=np.int64)
    cnt = np.array([n for _, n, _ in rows], dtype=f)
    return {
        "l_returnflag": keys // len(tpchgen.LINESTATUS),
        "l_linestatus": keys % len(tpchgen.LINESTATUS),
        "sum_qty": col["sum_qty"],
        "sum_base_price": col["sum_base_price"],
        "sum_disc_price": col["sum_disc_price"],
        "sum_charge": col["sum_charge"],
        "avg_qty": col["sum_qty"] / cnt,
        "avg_price": col["sum_base_price"] / cnt,
        "avg_disc": col["disc"] / cnt,
        "count_order": np.array([n for _, n, _ in rows], dtype=np.int64),
    }


def q3(t: Tables, p: dict, f=np.float64) -> dict:
    li, o = t.li, t.o
    d = day(p["date"])
    seg = tpchgen.MKTSEGMENT.index(p["segment"])
    cust_ok = t.c["c_mktsegment"] == seg
    order_ok = cust_ok[t.o_c] & (o["o_orderdate"] < d)
    m = order_ok[t.li_o] & (li["l_shipdate"] > d)
    oi = t.li_o[m]
    rev = li["l_extendedprice"][m].astype(f) \
        * (f(1) - li["l_discount"][m].astype(f))
    orders, g = np.unique(oi, return_inverse=True)
    revenue = _gsum(rev, g, len(orders))
    date = o["o_orderdate"][orders]
    # revenue desc, then o_orderdate; the order key last, so that the
    # order is total
    top = np.lexsort((o["o_orderkey"][orders], date, -revenue))[:10]
    return {"l_orderkey": o["o_orderkey"][orders][top].astype(np.int64),
            "revenue": revenue[top],
            "o_orderdate": date[top].astype(np.int64),
            "o_shippriority": o["o_shippriority"][orders][top]
            .astype(np.int64)}


def q6(t: Tables, p: dict, f=np.float64) -> dict:
    li = t.li
    y = int(p["year"])
    lo, hi = float(f"{(p['discount'] - 1) / 100:.2f}"), \
        float(f"{(p['discount'] + 1) / 100:.2f}")
    disc = li["l_discount"]
    m = ((li["l_shipdate"] >= day(f"{y}-01-01"))
         & (li["l_shipdate"] < day(f"{y + 1}-01-01"))
         & (disc >= lo) & (disc <= hi)
         & (li["l_quantity"] < float(p["quantity"])))
    rev = li["l_extendedprice"][m].astype(f) * disc[m].astype(f)
    return {"revenue": np.array([rev.sum(dtype=f)])}


def q12(t: Tables, p: dict, f=np.float64) -> dict:
    li = t.li
    y = int(p["year"])
    modes = [tpchgen.SHIPMODE.index(p["mode1"]),
             tpchgen.SHIPMODE.index(p["mode2"])]
    mode = li["l_shipmode"]
    m = (((mode == modes[0]) | (mode == modes[1]))
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= day(f"{y}-01-01"))
         & (li["l_receiptdate"] < day(f"{y + 1}-01-01")))
    prio = t.o["o_orderpriority"][t.li_o[m]]
    high = (prio == 0) | (prio == 1)       # 1-URGENT, 2-HIGH
    g = mode[m].astype(np.int64)
    n = len(tpchgen.SHIPMODE)
    hi_n = _gsum(high.astype(f), g, n)
    lo_n = _gsum((~high).astype(f), g, n)
    keep = np.flatnonzero(np.bincount(g, minlength=n) > 0)
    return {"l_shipmode": keep.astype(np.int64),
            "high_line_count": hi_n[keep], "low_line_count": lo_n[keep]}


def q14(t: Tables, p: dict, f=np.float64) -> dict:
    li = t.li
    start = f"{p['year']}-{p['month']:02d}-01"
    m = ((li["l_shipdate"] >= day(start))
         & (li["l_shipdate"] < day(_month_after(p["year"], p["month"]))))
    rev = li["l_extendedprice"][m].astype(f) \
        * (f(1) - li["l_discount"][m].astype(f))
    promo = _PROMO[t.p["p_type"][t.li_p[m]]]
    num = np.where(promo, rev, f(0)).sum(dtype=f)
    return {"promo_revenue": np.array([f(100) * num / rev.sum(dtype=f)])}


_CONTAINERS = {
    1: ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
    2: ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
    3: ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
}
_SIZE_HI = {1: 5, 2: 10, 3: 15}


def _q19_rows(t: Tables) -> dict:
    """Lineitem rows that Q19's fixed terms keep (ship mode AIR or REG
    AIR, DELIVER IN PERSON), with their part's brand, container, size."""
    li = t.li
    modes = [tpchgen.SHIPMODE.index("AIR"), tpchgen.SHIPMODE.index("REG AIR")]
    keep = np.flatnonzero(
        np.isin(li["l_shipmode"], modes)
        & (li["l_shipinstruct"]
           == tpchgen.SHIPINSTRUCT.index("DELIVER IN PERSON")))
    pi = t.li_p[keep]
    return {"l_quantity": li["l_quantity"][keep],
            "l_extendedprice": li["l_extendedprice"][keep],
            "l_discount": li["l_discount"][keep],
            "p_brand": t.p["p_brand"][pi], "p_container": t.p["p_container"][pi],
            "p_size": t.p["p_size"][pi]}


def q19(t: Tables, p: dict, f=np.float64) -> dict:
    r = t.made("q19", _q19_rows)
    qty = r["l_quantity"]
    m = np.zeros(len(qty), bool)
    for i in (1, 2, 3):
        code = tpchgen.BRAND.index(f"Brand#{p[f'brand{i}']}")
        conts = [tpchgen.CONTAINER.index(c) for c in _CONTAINERS[i]]
        lo = p[f"qty{i}"]
        m |= ((r["p_brand"] == code) & np.isin(r["p_container"], conts)
              & (qty >= lo) & (qty <= lo + 10)
              & (r["p_size"] >= 1) & (r["p_size"] <= _SIZE_HI[i]))
    rev = r["l_extendedprice"][m].astype(f) \
        * (f(1) - r["l_discount"][m].astype(f))
    return {"revenue": np.array([rev.sum(dtype=f)])}


ANSWER = {"q1": q1, "q3": q3, "q6": q6, "q12": q12, "q14": q14, "q19": q19}

# each query's group keys, by which its rows are matched
KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("l_orderkey",),
        "q6": (), "q12": ("l_shipmode",), "q14": (), "q19": ()}


def answer(t: Tables, q: str, p: dict, f=np.float64) -> dict:
    return ANSWER[q](t, p, f)
