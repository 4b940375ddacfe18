"""TPC-H-shaped data generator (lineitem) for benchmarks and BVT tests.

NOT the official dbgen (no C dbgen in this image): column domains,
correlations, and cardinalities follow the TPC-H spec for the columns Q1/Q6
touch — qty 1..50, discount 0.00..0.10, tax 0.00..0.08, extendedprice =
qty * partprice, returnflag R/A for shipped-before-1995-06-17 else N,
linestatus F/O by shipdate — so predicate selectivities and group
cardinalities match the real benchmark's shape. The correctness oracle is
pandas over the same arrays, so result checking is exact regardless.

Reference test corpus analogue: test/distributed/cases/benchmark/tpch.
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.storage.engine import Catalog, TableMeta

LINEITEM_SCHEMA = [
    ("l_orderkey", dt.INT64),
    ("l_partkey", dt.INT64),
    ("l_suppkey", dt.INT64),
    ("l_linenumber", dt.INT32),
    ("l_quantity", dt.decimal64(15, 2)),
    ("l_extendedprice", dt.decimal64(15, 2)),
    ("l_discount", dt.decimal64(15, 2)),
    ("l_tax", dt.decimal64(15, 2)),
    ("l_returnflag", dt.DType(dt.TypeOid.CHAR, width=1)),
    ("l_linestatus", dt.DType(dt.TypeOid.CHAR, width=1)),
    ("l_shipdate", dt.DATE),
    ("l_commitdate", dt.DATE),
    ("l_receiptdate", dt.DATE),
]

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


def gen_lineitem(n_rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n_rows).astype(np.int64)          # 1..50
    partprice = rng.integers(90000, 10500001, n_rows)           # cents
    extprice = (qty * partprice) // 100                         # cents
    discount = rng.integers(0, 11, n_rows).astype(np.int64)     # 0.00..0.10
    tax = rng.integers(0, 9, n_rows).astype(np.int64)           # 0.00..0.08
    ship = rng.integers(_days(1992, 1, 2), _days(1998, 12, 2),
                        n_rows).astype(np.int32)
    commit = ship + rng.integers(-30, 61, n_rows).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n_rows).astype(np.int32)
    cutoff = _days(1995, 6, 17)
    # returnflag: shipped long ago -> R or A; recent -> N (spec 4.2.3 shape)
    old = receipt <= cutoff
    ra = rng.integers(0, 2, n_rows)
    flag_codes = np.where(old, ra, 2).astype(np.int32)          # 0=A 1=R 2=N
    status_codes = (ship > _days(1995, 6, 17)).astype(np.int32)  # 0=F 1=O
    idx = np.arange(n_rows)
    return {
        # valid composite PK: 7 lines per order, unique (orderkey, lineno)
        "l_orderkey": (idx // 7 + 1).astype(np.int64),
        "l_partkey": rng.integers(1, 200001, n_rows).astype(np.int64),
        "l_suppkey": rng.integers(1, 10001, n_rows).astype(np.int64),
        "l_linenumber": (idx % 7 + 1).astype(np.int32),
        "l_quantity": qty * 100,          # decimal(15,2) scaled
        "l_extendedprice": extprice,      # already cents
        "l_discount": discount,           # cents scale (0.00-0.10)
        "l_tax": tax,
        "l_returnflag": flag_codes,
        "l_linestatus": status_codes,
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
    }


FLAG_CATS = ["A", "R", "N"]
STATUS_CATS = ["F", "O"]


def load_lineitem(catalog: Catalog, n_rows: int, seed: int = 0,
                  table: str = "lineitem") -> Dict[str, np.ndarray]:
    """Create + bulk-load lineitem; returns raw arrays for oracle checks."""
    # composite PK per the TPC-H spec (orderkey, linenumber); the synthetic
    # generator draws orderkeys randomly so single-column uniqueness would
    # be wrong anyway
    catalog.create_table(TableMeta(table, LINEITEM_SCHEMA,
                                   ["l_orderkey", "l_linenumber"]),
                         if_not_exists=True)
    t = catalog.get_table(table)
    arrays = gen_lineitem(n_rows, seed)
    t.insert_numpy(
        arrays,
        strings={"l_returnflag": (arrays["l_returnflag"], FLAG_CATS),
                 "l_linestatus": (arrays["l_linestatus"], STATUS_CATS)})
    return arrays


def q1_oracle(arrays: Dict[str, np.ndarray], delta_days: int = 90):
    """Exact integer-domain Q1 oracle (pandas-free, pure numpy)."""
    cutoff = _days(1998, 12, 1) - delta_days
    sel = arrays["l_shipdate"] <= cutoff
    flags = np.asarray(FLAG_CATS)[arrays["l_returnflag"][sel]]
    stats = np.asarray(STATUS_CATS)[arrays["l_linestatus"][sel]]
    qty = arrays["l_quantity"][sel]            # scale 2
    price = arrays["l_extendedprice"][sel]     # scale 2
    disc = arrays["l_discount"][sel]           # scale 2
    tax = arrays["l_tax"][sel]                 # scale 2
    out = {}
    for f in np.unique(flags):
        for s_ in np.unique(stats):
            m = (flags == f) & (stats == s_)
            if not m.any():
                continue
            q, p, d_, t_ = (x[m].astype(object) for x in (qty, price, disc, tax))
            disc_price = p * (100 - d_)                  # scale 4
            charge = disc_price * (100 + t_)             # scale 6
            out[(f, s_)] = {
                "sum_qty": int(q.sum()),                 # scale 2
                "sum_base_price": int(p.sum()),          # scale 2
                "sum_disc_price": int(disc_price.sum()),  # scale 4
                "sum_charge": int(charge.sum()),         # scale 6
                "avg_qty": q.sum() / len(q) / 100,
                "avg_price": p.sum() / len(p) / 100,
                "avg_disc": d_.sum() / len(d_) / 100,
                "count_order": int(m.sum()),
            }
    return out


def q1_check(rows, oracle) -> bool:
    """Full exactness check of Q1_SQL output against q1_oracle: group count
    and all 8 aggregate columns (exact integer domain for the sums, 1e-9
    for the float averages). Shared by tests and bench so the column/scale
    mapping lives in exactly one place."""
    if len(rows) != len(oracle):
        return False
    for r in rows:
        o = oracle.get((r[0], r[1]))
        if o is None:
            return False
        if round(r[2] * 100) != o["sum_qty"]:
            return False
        if round(r[3] * 100) != o["sum_base_price"]:
            return False
        if round(r[4] * 10000) != o["sum_disc_price"]:
            return False
        if round(r[5] * 1000000) != o["sum_charge"]:
            return False
        if r[9] != o["count_order"]:
            return False
        if abs(r[6] - o["avg_qty"]) > 1e-9:
            return False
        if abs(r[7] - o["avg_price"]) > 1e-6:
            return False
        if abs(r[8] - o["avg_disc"]) > 1e-12:
            return False
    return True


Q1_SQL = """
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

Q6_SQL = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""


# --------------------------------------------------------------- SSB Q1.x

LINEORDER_SCHEMA = [
    ("lo_orderkey", dt.INT64),
    ("lo_linenumber", dt.INT32),
    ("lo_orderdate", dt.INT32),         # FK into date dim (yyyymmdd int)
    ("lo_quantity", dt.INT64),
    ("lo_extendedprice", dt.INT64),     # cents
    ("lo_discount", dt.INT64),          # whole percent 0..10
    ("lo_revenue", dt.INT64),
]

DATE_SCHEMA = [
    ("d_datekey", dt.INT32),            # yyyymmdd
    ("d_year", dt.INT32),
    ("d_yearmonthnum", dt.INT32),
    ("d_weeknuminyear", dt.INT32),
]


def load_ssb(catalog: Catalog, n_rows: int, seed: int = 0):
    """Star-schema-benchmark shaped lineorder + date dim (spec domains for
    the Q1.x columns; oracle = numpy over the same arrays)."""
    rng = np.random.default_rng(seed)
    years = np.arange(1992, 1999)
    months = np.arange(1, 13)
    days = np.arange(1, 29)
    keys, yy, ym, wk = [], [], [], []
    for y in years:
        for m in months:
            for d in days:
                keys.append(y * 10000 + m * 100 + d)
                yy.append(y)
                ym.append(y * 100 + m)
                wk.append(((m - 1) * 28 + d - 1) // 7 + 1)
    date_arrays = {"d_datekey": np.asarray(keys, np.int32),
                   "d_year": np.asarray(yy, np.int32),
                   "d_yearmonthnum": np.asarray(ym, np.int32),
                   "d_weeknuminyear": np.asarray(wk, np.int32)}
    catalog.create_table(TableMeta("date_dim", DATE_SCHEMA, ["d_datekey"]),
                         if_not_exists=True)
    catalog.get_table("date_dim").insert_numpy(date_arrays)

    qty = rng.integers(1, 51, n_rows).astype(np.int64)
    price = rng.integers(90000, 10500001, n_rows).astype(np.int64)
    disc = rng.integers(0, 11, n_rows).astype(np.int64)
    odate = np.asarray(keys, np.int64)[
        rng.integers(0, len(keys), n_rows)].astype(np.int32)
    idx = np.arange(n_rows)
    lo = {"lo_orderkey": (idx // 7 + 1).astype(np.int64),
          "lo_linenumber": (idx % 7 + 1).astype(np.int32),
          "lo_orderdate": odate,
          "lo_quantity": qty,
          "lo_extendedprice": price,
          "lo_discount": disc,
          "lo_revenue": price * (100 - disc) // 100}
    catalog.create_table(TableMeta("lineorder", LINEORDER_SCHEMA,
                                   ["lo_orderkey", "lo_linenumber"]),
                         if_not_exists=True)
    catalog.get_table("lineorder").insert_numpy(lo)
    return lo, date_arrays


SSB_Q11 = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date_dim on lo_orderdate = d_datekey
where d_year = 1993 and lo_discount between 1 and 3 and lo_quantity < 25
"""

SSB_Q12 = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date_dim on lo_orderdate = d_datekey
where d_yearmonthnum = 199401 and lo_discount between 4 and 6
  and lo_quantity between 26 and 35
"""

SSB_Q13 = """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder join date_dim on lo_orderdate = d_datekey
where d_weeknuminyear = 6 and d_year = 1994
  and lo_discount between 5 and 7 and lo_quantity between 26 and 35
"""


def ssb_q1_oracle(lo, dates, q: str) -> int:
    import numpy as _np
    dk = dates["d_datekey"]
    if q == "q11":
        sel_dates = set(dk[dates["d_year"] == 1993].tolist())
        m = (_np.isin(lo["lo_orderdate"], list(sel_dates))
             & (lo["lo_discount"] >= 1) & (lo["lo_discount"] <= 3)
             & (lo["lo_quantity"] < 25))
    elif q == "q12":
        sel_dates = set(dk[dates["d_yearmonthnum"] == 199401].tolist())
        m = (_np.isin(lo["lo_orderdate"], list(sel_dates))
             & (lo["lo_discount"] >= 4) & (lo["lo_discount"] <= 6)
             & (lo["lo_quantity"] >= 26) & (lo["lo_quantity"] <= 35))
    else:
        sel_dates = set(dk[(dates["d_weeknuminyear"] == 6)
                           & (dates["d_year"] == 1994)].tolist())
        m = (_np.isin(lo["lo_orderdate"], list(sel_dates))
             & (lo["lo_discount"] >= 5) & (lo["lo_discount"] <= 7)
             & (lo["lo_quantity"] >= 26) & (lo["lo_quantity"] <= 35))
    return int((lo["lo_extendedprice"][m].astype(object)
                * lo["lo_discount"][m]).sum())


# ------------------------------------------------------------- TPC-H Q3

CUSTOMER_SCHEMA = [
    ("c_custkey", dt.INT64),
    ("c_mktsegment", dt.varchar(10)),
]

ORDERS_SCHEMA = [
    ("o_orderkey", dt.INT64),
    ("o_custkey", dt.INT64),
    ("o_orderdate", dt.DATE),
    ("o_shippriority", dt.INT32),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]


def load_tpch_q3(catalog: Catalog, n_orders: int, seed: int = 0):
    """customer + orders shaped for Q3 (lineitem reuses load_lineitem)."""
    rng = np.random.default_rng(seed)
    n_cust = max(n_orders // 10, 5)
    seg_codes = rng.integers(0, len(SEGMENTS), n_cust).astype(np.int32)
    catalog.create_table(TableMeta("customer", CUSTOMER_SCHEMA,
                                   ["c_custkey"]), if_not_exists=True)
    catalog.get_table("customer").insert_numpy(
        {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int64)},
        strings={"c_mktsegment": (seg_codes, SEGMENTS)})
    odate = rng.integers(_days(1992, 1, 1), _days(1998, 8, 3),
                         n_orders).astype(np.int32)
    orders = {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_orders).astype(np.int64),
        "o_orderdate": odate,
        "o_shippriority": np.zeros(n_orders, np.int32),
    }
    catalog.create_table(TableMeta("orders", ORDERS_SCHEMA, ["o_orderkey"]),
                         if_not_exists=True)
    catalog.get_table("orders").insert_numpy(orders)
    return {"seg_codes": seg_codes, "orders": orders}


Q3_SQL = """
select l_orderkey,
       sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer
join orders on c_custkey = o_custkey
join lineitem on l_orderkey = o_orderkey
where c_mktsegment = 'BUILDING'
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""


def q3_oracle(lineitem, q3data):
    """Exact integer-domain Q3 oracle."""
    import numpy as _np
    seg = q3data["seg_codes"]
    orders = q3data["orders"]
    building = set((_np.nonzero(seg == SEGMENTS.index("BUILDING"))[0] + 1)
                   .tolist())
    cutoff = _days(1995, 3, 15)
    omask = (_np.isin(orders["o_custkey"],
                      _np.asarray(sorted(building), _np.int64))
             & (orders["o_orderdate"] < cutoff))
    okeys = set(orders["o_orderkey"][omask].tolist())
    odate = dict(zip(orders["o_orderkey"].tolist(),
                     orders["o_orderdate"].tolist()))
    lmask = (_np.isin(lineitem["l_orderkey"],
                      _np.asarray(sorted(okeys), _np.int64))
             & (lineitem["l_shipdate"] > cutoff))
    rev = {}
    lk = lineitem["l_orderkey"][lmask]
    price = lineitem["l_extendedprice"][lmask].astype(object)
    disc = lineitem["l_discount"][lmask]
    for k, p, d_ in zip(lk.tolist(), price, disc.tolist()):
        rev[k] = rev.get(k, 0) + p * (100 - d_)
    rows = sorted(((v, -odate[k], k) for k, v in rev.items()),
                  key=lambda t: (-t[0], -t[1]))[:10]
    return [(k, v, -dneg) for v, dneg, k in rows]
