"""TPC-H query texts (the paper's workload: Q1, Q6, Q12; plus Q3/Q14 for
wider engine coverage). Parameterized with the spec's default substitution
values."""

TPCH_Q1 = """
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
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

TPCH_Q3 = """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
    and c_custkey = o_custkey
    and l_orderkey = o_orderkey
    and o_orderdate < date '1995-03-15'
    and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

TPCH_Q6 = """
select
    sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
    and l_shipdate < date '1994-01-01' + interval '1' year
    and l_discount between 0.05 and 0.07
    and l_quantity < 24
"""

TPCH_Q12 = """
select
    l_shipmode,
    sum(case when o_orderpriority = '1-URGENT'
        or o_orderpriority = '2-HIGH' then 1 else 0 end) as high_line_count,
    sum(case when o_orderpriority <> '1-URGENT'
        and o_orderpriority <> '2-HIGH' then 1 else 0
        end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
    and l_shipmode in ('MAIL', 'SHIP')
    and l_commitdate < l_receiptdate
    and l_shipdate < l_commitdate
    and l_receiptdate >= date '1994-01-01'
    and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
"""

TPCH_Q14 = """
select
    100.00 * sum(case when p_type like 'PROMO%'
        then l_extendedprice * (1 - l_discount) else 0 end)
        / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
    and l_shipdate >= date '1995-09-01'
    and l_shipdate < date '1995-09-01' + interval '1' month
"""

TPCH_Q19 = """
select
    sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where p_partkey = l_partkey
    and (
        (p_brand = 'Brand#12'
         and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
         and l_quantity >= 1 and l_quantity <= 11
         and p_size between 1 and 5)
     or (p_brand = 'Brand#23'
         and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
         and l_quantity >= 10 and l_quantity <= 20
         and p_size between 1 and 10)
     or (p_brand = 'Brand#34'
         and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
         and l_quantity >= 20 and l_quantity <= 30
         and p_size between 1 and 15))
    and l_shipmode in ('AIR', 'REG AIR')
    and l_shipinstruct = 'DELIVER IN PERSON'
"""

QUERIES = {"q1": TPCH_Q1, "q3": TPCH_Q3, "q6": TPCH_Q6, "q12": TPCH_Q12,
           "q14": TPCH_Q14, "q19": TPCH_Q19}
