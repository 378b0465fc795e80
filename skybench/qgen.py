"""TPC-H query texts and their substitution parameters (spec §2.4).

Each query is a template of the port's query text (``sql/queries.py``)
with its substitution parameters as placeholders, so that the template
filled with the spec's validation values is that text, character for
character. ``space(q)`` is every parameter set §2.4 allows, less the
validation set: the benchmark warms the cell with the validation texts
and never sends them in the measured window. Q19's space (18.9 million
sets) is sampled instead of listed.
"""

from __future__ import annotations

import itertools

import numpy as np

QUERIES = ("q1", "q3", "q6", "q12", "q14", "q19")

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
YEARS = (1993, 1994, 1995, 1996, 1997)

TEMPLATES = {
    "q1": """
select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '{delta}' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    "q3": """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{segment}'
    and c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate < date '{date}'
    and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
    "q6": """
select
    sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{year}-01-01'
    and l_shipdate < date '{year}-01-01' + interval '1' year
    and l_discount between {disc_lo} and {disc_hi}
    and l_quantity < {quantity}
""",
    "q12": """
select
    l_shipmode,
    sum(case when o_orderpriority = '1-URGENT'
        or o_orderpriority = '2-HIGH' then 1 else 0 end) as high_line_count,
    sum(case when o_orderpriority <> '1-URGENT'
        and o_orderpriority <> '2-HIGH' then 1 else 0
        end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
    and l_shipmode in ('{mode1}', '{mode2}')
    and l_commitdate < l_receiptdate
    and l_shipdate < l_commitdate
    and l_receiptdate >= date '{year}-01-01'
    and l_receiptdate < date '{year}-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
""",
    "q14": """
select
    100.00 * sum(case when p_type like 'PROMO%'
        then l_extendedprice * (1 - l_discount) else 0 end)
        / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
    and l_shipdate >= date '{year}-{month:02d}-01'
    and l_shipdate < date '{year}-{month:02d}-01' + interval '1' month
""",
    "q19": """
select
    sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where p_partkey = l_partkey
    and (
        (p_brand = 'Brand#{brand1}'
         and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
         and l_quantity >= {qty1} and l_quantity <= {qty1_hi}
         and p_size between 1 and 5)
     or (p_brand = 'Brand#{brand2}'
         and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
         and l_quantity >= {qty2} and l_quantity <= {qty2_hi}
         and p_size between 1 and 10)
     or (p_brand = 'Brand#{brand3}'
         and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
         and l_quantity >= {qty3} and l_quantity <= {qty3_hi}
         and p_size between 1 and 15))
    and l_shipmode in ('AIR', 'REG AIR')
    and l_shipinstruct = 'DELIVER IN PERSON'
""",
}

# the spec's validation values (§2.4), which the port's texts carry
VALIDATION = {
    "q1": {"delta": 90},
    "q3": {"segment": "BUILDING", "date": "1995-03-15"},
    "q6": {"year": 1994, "discount": 6, "quantity": 24},
    "q12": {"mode1": "MAIL", "mode2": "SHIP", "year": 1994},
    "q14": {"year": 1995, "month": 9},
    "q19": {"qty1": 1, "qty2": 10, "qty3": 20,
            "brand1": 12, "brand2": 23, "brand3": 34},
}


def render(q: str, p: dict) -> str:
    """The query text of ``q`` with parameter set ``p``."""
    fields = dict(p)
    if q == "q6":        # DISCOUNT in hundredths: the two bounds' literals
        fields["disc_lo"] = f"{(p['discount'] - 1) / 100:.2f}"
        fields["disc_hi"] = f"{(p['discount'] + 1) / 100:.2f}"
    if q == "q19":
        for i in (1, 2, 3):
            fields[f"qty{i}_hi"] = p[f"qty{i}"] + 10
    return TEMPLATES[q].format(**fields)


def _listed(q: str) -> list[dict]:
    """Every §2.4 parameter set of ``q`` (all but Q19's)."""
    if q == "q1":                       # DELTA in [60, 120] days
        return [{"delta": d} for d in range(60, 121)]
    if q == "q3":                       # SEGMENT; DATE in [1995-03-01, 31]
        return [{"segment": s, "date": f"1995-03-{d:02d}"}
                for s in SEGMENTS for d in range(1, 32)]
    if q == "q6":                       # year; DISCOUNT [0.02, 0.09]; QTY
        return [{"year": y, "discount": d, "quantity": n}
                for y in YEARS for d in range(2, 10) for n in (24, 25)]
    if q == "q12":                      # two different modes; year
        return [{"mode1": a, "mode2": b, "year": y}
                for a, b in itertools.combinations(SHIPMODES, 2)
                for y in YEARS]
    if q == "q14":                      # the first of a month, 1993-1997
        return [{"year": y, "month": m} for y in YEARS
                for m in range(1, 13)]
    raise KeyError(q)


def _key(q: str, p: dict) -> tuple:
    if q == "q12":                      # the pair is a set
        return (frozenset((p["mode1"], p["mode2"])), p["year"])
    return tuple(sorted(p.items()))


def space(q: str) -> list[dict] | None:
    """Every parameter set of ``q`` but the validation set; None for Q19,
    whose sets are drawn one at a time."""
    if q == "q19":
        return None
    val = _key(q, VALIDATION[q])
    return [p for p in _listed(q) if _key(q, p) != val]


def _draw_q19(rng: np.random.Generator) -> dict:
    q = rng.integers([1, 10, 20], [11, 21, 31])
    b = rng.integers(1, 6, size=6)
    return {"qty1": int(q[0]), "qty2": int(q[1]), "qty3": int(q[2]),
            "brand1": int(10 * b[0] + b[1]), "brand2": int(10 * b[2] + b[3]),
            "brand3": int(10 * b[4] + b[5])}


class ParamDraw:
    """Parameter sets of one query without replacement: a listed space
    is walked in a seeded order, and only once it is spent is it walked
    again, in a new order; Q19's sets are drawn and a set already given
    (or the validation set) is drawn again."""

    def __init__(self, q: str, rng: np.random.Generator):
        self.q, self.rng = q, rng
        self.listed = space(q)
        self.order: list[int] = []
        self.seen = {_key(q, VALIDATION[q])} if q == "q19" else None

    def __call__(self) -> dict:
        if self.listed is None:
            while True:
                p = _draw_q19(self.rng)
                if _key(self.q, p) not in self.seen:
                    self.seen.add(_key(self.q, p))
                    return p
        if not self.order:
            self.order = list(self.rng.permutation(len(self.listed)))
        p = dict(self.listed[int(self.order.pop())])
        if self.q == "q12" and self.rng.integers(2):
            p["mode1"], p["mode2"] = p["mode2"], p["mode1"]
        return p
