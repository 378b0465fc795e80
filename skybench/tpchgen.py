"""The TPC-H tables of the benchmark, made from its seed.

A frozen copy of the port's generator (``repro_torch.data.tpch``) as it
stood when the benchmark was defined: the same value distributions,
cross-table dependencies and per-(seed, table, partition) random
streams, so at a fixed seed its tables equal what
``ensure_tpch(sf, n_parts, seed)`` writes. It is kept here so that no
change to the program can change the data a cell runs on. numpy only:
the reference reads these arrays directly, and the loader writes them
through the port's SPAX writer.
"""

from __future__ import annotations

import numpy as np

EPOCH = np.datetime64("1970-01-01")
CURRENT_DATE = (np.datetime64("1995-06-17") - EPOCH).astype(int)
START_DATE = (np.datetime64("1992-01-01") - EPOCH).astype(int)
END_DATE = (np.datetime64("1998-12-31") - EPOCH).astype(int) - 151


def date_to_int(s: str) -> int:
    return int((np.datetime64(s) - EPOCH).astype(int))


# -- global dictionaries ------------------------------------------------------

RETURNFLAG = ("A", "N", "R")
LINESTATUS = ("F", "O")
SHIPMODE = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
SHIPINSTRUCT = ("COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN")
ORDERPRIORITY = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
ORDERSTATUS = ("F", "O", "P")
MKTSEGMENT = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
BRAND = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
_TYPE_S1 = ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
_TYPE_S2 = ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
_TYPE_S3 = ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")
PTYPE = tuple(f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2
              for c in _TYPE_S3)
_CONT_S1 = ("SM", "LG", "MED", "JUMBO", "WRAP")
_CONT_S2 = ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")
CONTAINER = tuple(f"{a} {b}" for a in _CONT_S1 for b in _CONT_S2)
NATION = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
          "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
          "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
          "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
          "UNITED STATES")
REGION = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1)

I64, I32, F64 = "<i8", "<i4", "<f8"


# a column: (name, kind, numpy dtype, dictionary or None), the fields of
# the SPAX writer's column spec
def _num(n): return (n, "num", I64, None)
def _f64(n): return (n, "num", F64, None)
def _date(n): return (n, "num", I32, None)
def _dict(n, d): return (n, "dict", I32, d)
def _bytes(n, w): return (n, "bytes", f"S{w}", None)


LINEITEM_SCHEMA = [
    _num("l_orderkey"), _num("l_partkey"), _num("l_suppkey"),
    _num("l_linenumber"), _f64("l_quantity"), _f64("l_extendedprice"),
    _f64("l_discount"), _f64("l_tax"), _dict("l_returnflag", RETURNFLAG),
    _dict("l_linestatus", LINESTATUS), _date("l_shipdate"),
    _date("l_commitdate"), _date("l_receiptdate"),
    _dict("l_shipinstruct", SHIPINSTRUCT), _dict("l_shipmode", SHIPMODE),
    _bytes("l_comment", 20),
]

ORDERS_SCHEMA = [
    _num("o_orderkey"), _num("o_custkey"),
    _dict("o_orderstatus", ORDERSTATUS), _f64("o_totalprice"),
    _date("o_orderdate"), _dict("o_orderpriority", ORDERPRIORITY),
    _bytes("o_clerk", 15), _num("o_shippriority"), _bytes("o_comment", 20),
]

CUSTOMER_SCHEMA = [
    _num("c_custkey"), _bytes("c_name", 18), _bytes("c_address", 20),
    _num("c_nationkey"), _bytes("c_phone", 15), _f64("c_acctbal"),
    _dict("c_mktsegment", MKTSEGMENT), _bytes("c_comment", 20),
]

PART_SCHEMA = [
    _num("p_partkey"), _bytes("p_name", 30), _bytes("p_mfgr", 14),
    _dict("p_brand", BRAND), _dict("p_type", PTYPE), _num("p_size"),
    _dict("p_container", CONTAINER), _f64("p_retailprice"),
    _bytes("p_comment", 14),
]

SUPPLIER_SCHEMA = [
    _num("s_suppkey"), _bytes("s_name", 18), _bytes("s_address", 20),
    _num("s_nationkey"), _bytes("s_phone", 15), _f64("s_acctbal"),
    _bytes("s_comment", 20),
]

PARTSUPP_SCHEMA = [
    _num("ps_partkey"), _num("ps_suppkey"), _num("ps_availqty"),
    _f64("ps_supplycost"), _bytes("ps_comment", 20),
]

NATION_SCHEMA = [
    _num("n_nationkey"), _dict("n_name", NATION), _num("n_regionkey"),
    _bytes("n_comment", 20),
]

REGION_SCHEMA = [
    _num("r_regionkey"), _dict("r_name", REGION), _bytes("r_comment", 20),
]

SCHEMAS = {
    "lineitem": LINEITEM_SCHEMA, "orders": ORDERS_SCHEMA,
    "customer": CUSTOMER_SCHEMA, "part": PART_SCHEMA,
    "supplier": SUPPLIER_SCHEMA, "partsupp": PARTSUPP_SCHEMA,
    "nation": NATION_SCHEMA, "region": REGION_SCHEMA,
}


def _retail_price(partkey: np.ndarray) -> np.ndarray:
    return (90000 + (partkey % 20001) + 100 * (partkey % 1000)) / 100.0


def _rand_bytes(rng: np.random.Generator, n: int, width: int) -> np.ndarray:
    letters = rng.integers(65, 91, size=(n, width), dtype=np.uint8)
    return letters.view(f"S{width}").reshape(n)


def _customer_count(sf: float) -> int: return max(int(150_000 * sf), 32)
def _orders_count(sf: float) -> int: return _customer_count(sf) * 10
def _part_count(sf: float) -> int: return max(int(200_000 * sf), 64)
def _supplier_count(sf: float) -> int: return max(int(10_000 * sf), 8)


def gen_orders_partition(sf: float, part: int, n_parts: int,
                         seed: int = 0) -> dict[str, np.ndarray]:
    """Orders rows [lo, hi) of the full table, plus their lineitems."""
    total = _orders_count(sf)
    lo = part * total // n_parts
    hi = (part + 1) * total // n_parts
    n = hi - lo
    rng = np.random.default_rng((seed, 1, part))
    okey = np.arange(lo + 1, hi + 1, dtype=np.int64)
    odate = rng.integers(START_DATE, END_DATE + 1, n).astype(np.int32)
    lines = rng.integers(1, 8, n)  # 1..7 lineitems per order

    orders = {
        "o_orderkey": okey,
        "o_custkey": rng.integers(1, _customer_count(sf) + 1, n,
                                  dtype=np.int64),
        "o_orderstatus": np.zeros(n, np.int32),  # fixed up below
        "o_totalprice": np.zeros(n),             # fixed up below
        "o_orderdate": odate,
        "o_orderpriority": rng.integers(0, len(ORDERPRIORITY), n,
                                        dtype=np.int32),
        "o_clerk": _rand_bytes(rng, n, 15),
        "o_shippriority": np.zeros(n, dtype=np.int64),
        "o_comment": _rand_bytes(rng, n, 20),
    }

    m = int(lines.sum())
    li_order = np.repeat(np.arange(n), lines)
    l_okey = okey[li_order]
    l_odate = odate[li_order].astype(np.int64)
    pk = rng.integers(1, _part_count(sf) + 1, m, dtype=np.int64)
    qty = rng.integers(1, 51, m).astype(np.float64)
    shipdate = (l_odate + rng.integers(1, 122, m)).astype(np.int32)
    commitdate = (l_odate + rng.integers(30, 91, m)).astype(np.int32)
    receiptdate = (shipdate.astype(np.int64)
                   + rng.integers(1, 31, m)).astype(np.int32)
    returned = receiptdate <= CURRENT_DATE
    rflag = np.where(returned,
                     rng.integers(0, 2, m) * 2,      # A(0) or R(2)
                     np.int64(1)).astype(np.int32)   # N(1)
    lstatus = (shipdate > CURRENT_DATE).astype(np.int32)  # F(0)/O(1)
    eprice = qty * _retail_price(pk)

    lineitem = {
        "l_orderkey": l_okey,
        "l_partkey": pk,
        "l_suppkey": rng.integers(1, _supplier_count(sf) + 1, m,
                                  dtype=np.int64),
        "l_linenumber": (np.arange(m, dtype=np.int64)
                         - np.repeat(np.cumsum(lines) - lines, lines) + 1),
        "l_quantity": qty,
        "l_extendedprice": eprice,
        "l_discount": rng.integers(0, 11, m) / 100.0,
        "l_tax": rng.integers(0, 9, m) / 100.0,
        "l_returnflag": rflag,
        "l_linestatus": lstatus,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipinstruct": rng.integers(0, len(SHIPINSTRUCT), m,
                                       dtype=np.int32),
        "l_shipmode": rng.integers(0, len(SHIPMODE), m, dtype=np.int32),
        "l_comment": _rand_bytes(rng, m, 20),
    }

    # Order-level aggregates derived from lineitems.
    price = eprice * (1 + lineitem["l_tax"]) * (1 - lineitem["l_discount"])
    orders["o_totalprice"] = np.bincount(li_order, weights=price,
                                         minlength=n)
    all_f = np.bincount(li_order, weights=(lstatus == 0), minlength=n) \
        == lines
    all_o = np.bincount(li_order, weights=(lstatus == 1), minlength=n) \
        == lines
    orders["o_orderstatus"] = np.where(
        all_f, 0, np.where(all_o, 1, 2)).astype(np.int32)
    return {"orders": orders, "lineitem": lineitem}


def gen_customer(sf: float, seed: int = 0) -> dict[str, np.ndarray]:
    n = _customer_count(sf)
    rng = np.random.default_rng((seed, 2))
    return {
        "c_custkey": np.arange(1, n + 1, dtype=np.int64),
        "c_name": _rand_bytes(rng, n, 18),
        "c_address": _rand_bytes(rng, n, 20),
        "c_nationkey": rng.integers(0, 25, n, dtype=np.int64),
        "c_phone": _rand_bytes(rng, n, 15),
        "c_acctbal": rng.integers(-99999, 1000000, n) / 100.0,
        "c_mktsegment": rng.integers(0, len(MKTSEGMENT), n, dtype=np.int32),
        "c_comment": _rand_bytes(rng, n, 20),
    }


def gen_part(sf: float, seed: int = 0) -> dict[str, np.ndarray]:
    n = _part_count(sf)
    rng = np.random.default_rng((seed, 3))
    pk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "p_partkey": pk,
        "p_name": _rand_bytes(rng, n, 30),
        "p_mfgr": _rand_bytes(rng, n, 14),
        "p_brand": rng.integers(0, len(BRAND), n, dtype=np.int32),
        "p_type": rng.integers(0, len(PTYPE), n, dtype=np.int32),
        "p_size": rng.integers(1, 51, n, dtype=np.int64),
        "p_container": rng.integers(0, len(CONTAINER), n, dtype=np.int32),
        "p_retailprice": _retail_price(pk),
        "p_comment": _rand_bytes(rng, n, 14),
    }


def gen_supplier(sf: float, seed: int = 0) -> dict[str, np.ndarray]:
    n = _supplier_count(sf)
    rng = np.random.default_rng((seed, 4))
    return {
        "s_suppkey": np.arange(1, n + 1, dtype=np.int64),
        "s_name": _rand_bytes(rng, n, 18),
        "s_address": _rand_bytes(rng, n, 20),
        "s_nationkey": rng.integers(0, 25, n, dtype=np.int64),
        "s_phone": _rand_bytes(rng, n, 15),
        "s_acctbal": rng.integers(-99999, 1000000, n) / 100.0,
        "s_comment": _rand_bytes(rng, n, 20),
    }


def gen_partsupp(sf: float, seed: int = 0) -> dict[str, np.ndarray]:
    n = _part_count(sf) * 4
    rng = np.random.default_rng((seed, 5))
    return {
        "ps_partkey": np.repeat(
            np.arange(1, _part_count(sf) + 1, dtype=np.int64), 4),
        "ps_suppkey": rng.integers(1, _supplier_count(sf) + 1, n,
                                   dtype=np.int64),
        "ps_availqty": rng.integers(1, 10000, n, dtype=np.int64),
        "ps_supplycost": rng.integers(100, 100001, n) / 100.0,
        "ps_comment": _rand_bytes(rng, n, 20),
    }


def gen_nation(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, 6))
    return {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.arange(25, dtype=np.int32),
        "n_regionkey": np.asarray(NATION_REGION, dtype=np.int64),
        "n_comment": _rand_bytes(rng, 25, 20),
    }


def gen_region(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, 7))
    return {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.arange(5, dtype=np.int32),
        "r_comment": _rand_bytes(rng, 5, 20),
    }


def n_parts_default(sf: float) -> int:
    """Lineitem/orders partitions at ``sf``: one per 250,000 orders, as
    the port's ``generate_tpch`` sizes them (6 at SF 1)."""
    return max(1, int(np.ceil(_orders_count(sf) / 250_000)))


def generate(sf: float, seed: int, n_parts: int | None = None,
             pool=None) -> dict[str, list[dict[str, np.ndarray]]]:
    """Every table as its list of partitions (lineitem and orders
    ``n_parts``, the others one), made on ``pool`` (an executor) where
    given: each partition draws from its own random stream."""
    n_parts = n_parts or n_parts_default(sf)
    # any whole number: numpy takes no negative seed
    seed = int(seed) % (1 << 64)
    jobs = {("orders", p): (gen_orders_partition, (sf, p, n_parts, seed))
            for p in range(n_parts)}
    jobs.update({
        ("customer", 0): (gen_customer, (sf, seed)),
        ("part", 0): (gen_part, (sf, seed)),
        ("supplier", 0): (gen_supplier, (sf, seed)),
        ("partsupp", 0): (gen_partsupp, (sf, seed)),
        ("nation", 0): (gen_nation, (seed,)),
        ("region", 0): (gen_region, (seed,)),
    })
    if pool is None:
        done = {k: fn(*a) for k, (fn, a) in jobs.items()}
    else:
        futs = {k: pool.submit(fn, *a) for k, (fn, a) in jobs.items()}
        done = {k: f.result() for k, f in futs.items()}
    out: dict[str, list] = {t: [] for t in SCHEMAS}
    for (table, p), cols in sorted(done.items()):
        if table == "orders":
            out["orders"].append(cols["orders"])
            out["lineitem"].append(cols["lineitem"])
        else:
            out[table].append(cols)
    return out


def concat(parts: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """One table's partitions as whole columns."""
    if len(parts) == 1:
        return parts[0]
    return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
