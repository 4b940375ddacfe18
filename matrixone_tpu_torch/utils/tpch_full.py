"""Full 8-table TPC-H corpus: generator, engine loader, sqlite3 oracle,
all 22 queries, and the refresh functions RF1/RF2 as SQL text.

NOT the official dbgen (no C dbgen in this image): cardinalities, key
relationships, and value domains follow the TPC-H spec (customer 150k/SF,
orders 10/customer, ~4 lines/order, partsupp 4 suppliers/part with the
spec's supplier-distribution formula, 25 nations / 5 regions, spec p_type /
container / shipmode vocabularies, 2/3 of customers with orders, comment
tokens that Q13/Q16 predicates rely on) so predicate selectivities and
join fan-outs are benchmark-shaped. Correctness is checked against
sqlite3 running the SAME data (dollars as REAL, dates as TEXT), so the
oracle is an independent SQL engine, not a re-derivation.

Reference test corpus analogue: pkg/sql/plan/tpch_test.go golden plans +
test/distributed/cases/benchmark/tpch BVT cases.

The port's copy of `matrixone_tpu/utils/tpch_full.py`, loading into the
port's engine; the tables and queries are the same.  The refresh
functions (`rf1`, `rf2`, `apply_refresh`) are the port's own workload
data for its write path, for this corpus and for `utils/tpch.py`'s Q3
tables.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
import sqlite3
from typing import Dict, List, Tuple

import numpy as np

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.storage.engine import Catalog, TableMeta
from matrixone_tpu_torch.utils import tpch

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


# ----------------------------------------------------------------- domains

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# (name, region index) — the spec's 25 nations
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
          "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger",
          "drab", "firebrick", "floral", "forest", "frosted", "gainsboro",
          "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
          "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
          "light", "lime", "linen", "magenta", "maroon", "medium", "metallic"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
COMMENT_WORDS = ["carefully", "final", "requests", "special", "accounts",
                 "deposits", "packages", "ideas", "theodolites", "quickly",
                 "slyly", "furiously", "pending", "regular", "express",
                 "bold", "even", "silent", "unusual", "blithely"]


def _comments(rng, n, extra_rate=0.0, extra=""):
    """Random 3-word comments; a fraction get `extra` injected (Q13/Q16
    predicate fodder)."""
    w = np.array(COMMENT_WORDS)
    pick = w[rng.integers(0, len(w), (n, 3))]
    out = [" ".join(row) for row in pick]
    if extra_rate > 0:
        hit = rng.random(n) < extra_rate
        for i in np.nonzero(hit)[0]:
            out[i] = f"{out[i].split(' ')[0]} {extra} {out[i]}"
    return np.array(out, dtype=object)


def _orders_lineitem(rng, o_keys: np.ndarray, active: np.ndarray,
                     n_supp: int, n_part: int, retailprice: np.ndarray):
    """orders with keys `o_keys` (customers drawn from `active`), each
    with 1-7 lineitems, and o_totalprice / o_orderstatus derived from
    the lines: the load's value generators, which the refresh function
    RF1 reuses."""
    n_ord = len(o_keys)
    o_cust = active[rng.integers(0, len(active), n_ord)]
    o_date = rng.integers(_days(1992, 1, 1), _days(1998, 8, 3),
                          n_ord).astype(np.int32)
    n_lines_per = rng.integers(1, 8, n_ord)
    orders = {
        "o_orderkey": o_keys,
        "o_custkey": o_cust.astype(np.int64),
        "o_orderstatus": None,          # filled after lineitem
        "o_totalprice": None,
        "o_orderdate": o_date,
        "o_orderpriority": np.array([PRIORITIES[i] for i in
                                     rng.integers(0, 5, n_ord)], dtype=object),
        "o_clerk": np.array([f"Clerk#{rng.integers(1, max(2, n_supp)):09d}"
                             for _ in range(n_ord)], dtype=object),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _comments(rng, n_ord, 0.02, "special requests"),
    }

    # lineitem
    l_order = np.repeat(orders["o_orderkey"], n_lines_per)
    # each line's order, as a position in o_keys
    l_pos = np.repeat(np.arange(n_ord), n_lines_per)
    n_li = len(l_order)
    l_linenum = np.concatenate([np.arange(1, k + 1) for k in n_lines_per]
                               ).astype(np.int64)
    l_part = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier must be one of the part's 4 partsupp suppliers (Q9 join)
    pick4 = rng.integers(0, 4, n_li)
    l_supp = ((l_part - 1 + pick4 * (n_supp // 4) + (l_part - 1) // n_supp)
              % n_supp) + 1
    qty = rng.integers(1, 51, n_li).astype(np.int64)
    extprice = qty * retailprice[l_part - 1]                    # cents
    discount = rng.integers(0, 11, n_li).astype(np.int64)       # cents (0.00-0.10)
    tax = rng.integers(0, 9, n_li).astype(np.int64)
    o_date_per_line = np.repeat(o_date, n_lines_per)
    l_ship = o_date_per_line + rng.integers(1, 122, n_li).astype(np.int32)
    l_commit = o_date_per_line + rng.integers(30, 91, n_li).astype(np.int32)
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype(np.int32)
    today = _days(1995, 6, 17)
    rf = np.where(l_receipt <= today,
                  np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    ls = np.where(l_ship > today, "O", "F")
    lineitem = {
        "l_orderkey": l_order,
        "l_partkey": l_part,
        "l_suppkey": l_supp,
        "l_linenumber": l_linenum,
        "l_quantity": qty * 100,                                 # cents
        "l_extendedprice": extprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": rf.astype(object),
        "l_linestatus": ls.astype(object),
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": np.array([INSTRUCTS[i] for i in
                                    rng.integers(0, 4, n_li)], dtype=object),
        "l_shipmode": np.array([SHIPMODES[i] for i in
                                rng.integers(0, 7, n_li)], dtype=object),
        "l_comment": _comments(rng, n_li),
    }

    # o_totalprice = sum(extprice*(1+tax)*(1-disc)); o_orderstatus from lines
    gross = (extprice * (100 - discount) * (100 + tax)) // 10000
    totol = np.zeros(n_ord, dtype=np.int64)
    np.add.at(totol, l_pos, gross)
    orders["o_totalprice"] = totol
    all_f = np.ones(n_ord, dtype=bool)
    any_f = np.zeros(n_ord, dtype=bool)
    np.logical_and.at(all_f, l_pos, ls == "F")
    np.logical_or.at(any_f, l_pos, ls == "F")
    status = np.where(all_f, "F", np.where(any_f, "P", "O"))
    orders["o_orderstatus"] = status.astype(object)
    return orders, lineitem


def gen_tpch(sf: float = 0.01, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """All 8 tables as column arrays. Money columns are in CENTS (int64,
    decimal64 scale-2 storage); dates are days-since-epoch int32; strings
    are object arrays."""
    rng = np.random.default_rng(seed)
    n_supp = max(10, int(10_000 * sf))
    n_part = max(40, int(200_000 * sf))
    n_cust = max(30, int(150_000 * sf))
    n_ord = n_cust * 10

    region = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": _comments(rng, 5),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": _comments(rng, 25),
    }

    s_nat = rng.integers(0, 25, n_supp)
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
                           dtype=object),
        "s_address": _comments(rng, n_supp),
        "s_nationkey": s_nat,
        "s_phone": np.array([f"{k + 10}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for k in s_nat], dtype=object),
        "s_acctbal": rng.integers(-99999, 999999, n_supp),   # cents
        # ~3% have complaints (Q16's NOT IN subquery must be non-empty)
        "s_comment": _comments(rng, n_supp, 0.03, "Customer Complaints"),
    }

    p_size = rng.integers(1, 51, n_part)
    p_type = np.array([f"{TYPE_S1[rng.integers(0, 6)]} "
                       f"{TYPE_S2[rng.integers(0, 5)]} "
                       f"{TYPE_S3[rng.integers(0, 5)]}"
                       for _ in range(n_part)], dtype=object)
    p_name = np.array([f"{COLORS[rng.integers(0, 50)]} "
                       f"{COLORS[rng.integers(0, 50)]} "
                       f"{COLORS[rng.integers(0, 50)]}"
                       for _ in range(n_part)], dtype=object)
    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": p_name,
        "p_mfgr": np.array([f"Manufacturer#{rng.integers(1, 6)}"
                            for _ in range(n_part)], dtype=object),
        "p_brand": np.array([f"Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}"
                             for _ in range(n_part)], dtype=object),
        "p_type": p_type,
        "p_size": p_size.astype(np.int64),
        "p_container": np.array([f"{CONT_S1[rng.integers(0, 5)]} "
                                 f"{CONT_S2[rng.integers(0, 8)]}"
                                 for _ in range(n_part)], dtype=object),
        # spec retail price formula (cents): 90000 + key%20000*10 + key%1000
        "p_retailprice": (90000 + (np.arange(1, n_part + 1) % 20000) * 10
                          + np.arange(1, n_part + 1) % 1000).astype(np.int64),
        "p_comment": _comments(rng, n_part),
    }

    # partsupp: 4 suppliers per part, spec distribution formula
    # the 4 suppliers of part p: strides of S//4 are distinct mod S for
    # i in 0..3 (3*(S//4) < S), so (p, s) pairs are unique by construction
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_supp = ((ps_part - 1 + i4 * (n_supp // 4) + (ps_part - 1) // n_supp)
               % n_supp) + 1
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, n_part * 4).astype(np.int64),
        "ps_supplycost": rng.integers(100, 100001, n_part * 4),  # cents
        "ps_comment": _comments(rng, n_part * 4),
    }

    c_nat = rng.integers(0, 25, n_cust)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
                           dtype=object),
        "c_address": _comments(rng, n_cust),
        "c_nationkey": c_nat,
        # country code = nationkey + 10 (Q22 keys on substring(phone,1,2))
        "c_phone": np.array([f"{k + 10}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for k in c_nat], dtype=object),
        "c_acctbal": rng.integers(-99999, 999999, n_cust),   # cents
        "c_mktsegment": np.array([SEGMENTS[i] for i in
                                  rng.integers(0, 5, n_cust)], dtype=object),
        "c_comment": _comments(rng, n_cust),
    }

    # orders: only 2/3 of customers place orders (Q13's zero-order groups)
    active = rng.permutation(n_cust)[:max(1, n_cust * 2 // 3)] + 1
    orders, lineitem = _orders_lineitem(
        rng, np.arange(1, n_ord + 1, dtype=np.int64), active, n_supp,
        n_part, part["p_retailprice"])

    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


# ------------------------------------------------------------ engine load

_D152 = dt.decimal64(15, 2)
_STR = dt.varchar(117)
_SCHEMAS = {
    "region": [("r_regionkey", dt.INT64), ("r_name", _STR),
               ("r_comment", _STR)],
    "nation": [("n_nationkey", dt.INT64), ("n_name", _STR),
               ("n_regionkey", dt.INT64), ("n_comment", _STR)],
    "supplier": [("s_suppkey", dt.INT64), ("s_name", _STR),
                 ("s_address", _STR), ("s_nationkey", dt.INT64),
                 ("s_phone", _STR), ("s_acctbal", _D152),
                 ("s_comment", _STR)],
    "part": [("p_partkey", dt.INT64), ("p_name", _STR), ("p_mfgr", _STR),
             ("p_brand", _STR), ("p_type", _STR), ("p_size", dt.INT64),
             ("p_container", _STR), ("p_retailprice", _D152),
             ("p_comment", _STR)],
    "partsupp": [("ps_partkey", dt.INT64), ("ps_suppkey", dt.INT64),
                 ("ps_availqty", dt.INT64), ("ps_supplycost", _D152),
                 ("ps_comment", _STR)],
    "customer": [("c_custkey", dt.INT64), ("c_name", _STR),
                 ("c_address", _STR), ("c_nationkey", dt.INT64),
                 ("c_phone", _STR), ("c_acctbal", _D152),
                 ("c_mktsegment", _STR), ("c_comment", _STR)],
    "orders": [("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
               ("o_orderstatus", _STR), ("o_totalprice", _D152),
               ("o_orderdate", dt.DATE), ("o_orderpriority", _STR),
               ("o_clerk", _STR), ("o_shippriority", dt.INT64),
               ("o_comment", _STR)],
    "lineitem": [("l_orderkey", dt.INT64), ("l_partkey", dt.INT64),
                 ("l_suppkey", dt.INT64), ("l_linenumber", dt.INT64),
                 ("l_quantity", _D152), ("l_extendedprice", _D152),
                 ("l_discount", _D152), ("l_tax", _D152),
                 ("l_returnflag", _STR), ("l_linestatus", _STR),
                 ("l_shipdate", dt.DATE), ("l_commitdate", dt.DATE),
                 ("l_receiptdate", dt.DATE), ("l_shipinstruct", _STR),
                 ("l_shipmode", _STR), ("l_comment", _STR)],
}
_PKS = {"region": ["r_regionkey"], "nation": ["n_nationkey"],
        "supplier": ["s_suppkey"], "part": ["p_partkey"],
        "partsupp": ["ps_partkey", "ps_suppkey"],
        "customer": ["c_custkey"], "orders": ["o_orderkey"],
        "lineitem": ["l_orderkey", "l_linenumber"]}


def _encode_strings(values: np.ndarray) -> Tuple[np.ndarray, list]:
    cats, lut, codes = [], {}, np.empty(len(values), np.int32)
    for i, s in enumerate(values):
        c = lut.get(s)
        if c is None:
            c = lut[s] = len(cats)
            cats.append(s)
        codes[i] = c
    return codes, cats


def load_tpch(catalog: Catalog, sf: float = 0.01, seed: int = 0
              ) -> Dict[str, Dict[str, np.ndarray]]:
    tables = gen_tpch(sf, seed)
    for name, arrays in tables.items():
        schema = _SCHEMAS[name]
        catalog.create_table(TableMeta(name, schema, _PKS[name]),
                             if_not_exists=True)
        t = catalog.get_table(name)
        strings = {}
        for col, dtype in schema:
            if dtype.is_varlen:
                strings[col] = _encode_strings(arrays[col])
        t.insert_numpy(arrays, strings=strings)
    return tables


# ------------------------------------------------------- refresh functions
# TPC-H's two refresh functions as SQL text (spec 2.5.2-2.5.3): workload
# data for the write path, applied alike to an engine session and to the
# sqlite3 oracle.  Both accept the 8-table corpus of `gen_tpch` and the
# Q3 tables of `utils/tpch.py` ({"lineitem": gen_lineitem's arrays,
# "orders": load_tpch_q3's orders}).

#: rows per INSERT ... VALUES of RF1; order keys per DELETE of RF2
RF1_ROWS_PER_INSERT = 500
RF2_KEYS_PER_DELETE = 150


@dataclasses.dataclass
class Refresh:
    """One refresh function: its statements (BEGIN ... COMMIT) and the
    rows they change, for the oracles (`apply_refresh`)."""
    statements: List[str]
    inserts: Dict[str, Dict[str, np.ndarray]]   # RF1: table -> columns
    delete_keys: np.ndarray                      # RF2: order keys


def _refresh_orders(sf: float) -> int:
    """SF x 1500 orders a refresh (at least one)."""
    return max(1, int(round(sf * 1500)))


def _schemas_of(tables) -> tuple:
    """(schema by table, categories of code columns) of either corpus."""
    if "part" in tables:
        return _SCHEMAS, {}
    return ({"lineitem": tpch.LINEITEM_SCHEMA, "orders": tpch.ORDERS_SCHEMA},
            {"l_returnflag": tpch.FLAG_CATS,
             "l_linestatus": tpch.STATUS_CATS})


def _sql_value(v, dtype, cats=None) -> str:
    if cats is not None:
        v = cats[int(v)]
    if dtype.oid == dt.TypeOid.DECIMAL64:
        v = int(v)
        sign, v = ("-" if v < 0 else ""), abs(v)
        q = 10 ** dtype.scale
        return f"{sign}{v // q}.{v % q:0{dtype.scale}d}"
    if dtype.oid == dt.TypeOid.DATE:
        day = _EPOCH + datetime.timedelta(days=int(v))
        return f"'{day.isoformat()}'"
    if dtype.is_varlen:
        return "'" + str(v).replace("'", "''") + "'"
    return str(int(v))


def insert_statements(table: str, schema, arrays, cats=None) -> List[str]:
    """Multi-row `INSERT INTO table VALUES` statements of at most
    `RF1_ROWS_PER_INSERT` rows, every column of `schema` in order."""
    cats = cats or {}
    cols = [[_sql_value(v, d, cats.get(c)) for v in arrays[c].tolist()]
            for c, d in schema]
    rows = [f"({', '.join(r)})" for r in zip(*cols)]
    return [f"insert into {table} values " + ", ".join(
        rows[i:i + RF1_ROWS_PER_INSERT])
        for i in range(0, len(rows), RF1_ROWS_PER_INSERT)]


def _next_order_keys(tables, n: int) -> np.ndarray:
    top = max(int(tables["orders"]["o_orderkey"].max()),
              int(tables["lineitem"]["l_orderkey"].max()))
    return np.arange(top + 1, top + 1 + n, dtype=np.int64)


def rf1(tables, sf: float, seed: int, q3data=None) -> Refresh:
    """RF1: SF x 1500 new orders with keys above the current maximum,
    each with 1-7 lineitems, from the load's value generators seeded by
    `seed`, as INSERTs in one transaction.  `tables` is the corpus's
    current state; for the Q3 tables, `q3data` is `load_tpch_q3`'s
    return (its customer count)."""
    rng = np.random.default_rng(seed)
    keys = _next_order_keys(tables, _refresh_orders(sf))
    schemas, cats = _schemas_of(tables)
    if "part" in tables:
        orders, lineitem = _orders_lineitem(
            rng, keys, np.unique(tables["orders"]["o_custkey"]),
            len(tables["supplier"]["s_suppkey"]),
            len(tables["part"]["p_partkey"]),
            tables["part"]["p_retailprice"])
    else:
        n_lines = rng.integers(1, 8, len(keys))
        lineitem = tpch.gen_lineitem(int(n_lines.sum()), seed=seed)
        lineitem["l_orderkey"] = np.repeat(keys, n_lines)
        lineitem["l_linenumber"] = np.concatenate(
            [np.arange(1, k + 1) for k in n_lines]).astype(np.int32)
        orders = {
            "o_orderkey": keys,
            "o_custkey": rng.integers(1, len(q3data["seg_codes"]) + 1,
                                      len(keys)).astype(np.int64),
            "o_orderdate": rng.integers(_days(1992, 1, 1),
                                        _days(1998, 8, 3),
                                        len(keys)).astype(np.int32),
            "o_shippriority": np.zeros(len(keys), np.int32)}
    stmts = (insert_statements("orders", schemas["orders"], orders, cats)
             + insert_statements("lineitem", schemas["lineitem"],
                                 lineitem, cats))
    return Refresh(["begin"] + stmts + ["commit"],
                   {"orders": orders, "lineitem": lineitem},
                   np.zeros(0, np.int64))


def rf2(tables, sf: float, seed: int) -> Refresh:
    """RF2: SF x 1500 existing orders chosen by `seed`, and all their
    lineitems, deleted by key in statements of at most
    `RF2_KEYS_PER_DELETE` keys, lineitem first, in one transaction."""
    rng = np.random.default_rng(seed)
    have = tables["orders"]["o_orderkey"]
    keys = np.sort(rng.choice(have, min(_refresh_orders(sf), len(have)),
                              replace=False)).astype(np.int64)
    stmts = []
    for table, col in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
        for i in range(0, len(keys), RF2_KEYS_PER_DELETE):
            part = ", ".join(str(k) for k in
                             keys[i:i + RF2_KEYS_PER_DELETE].tolist())
            stmts.append(f"delete from {table} where {col} in ({part})")
    return Refresh(["begin"] + stmts + ["commit"], {}, keys)


def insert_orders(tables, keys) -> Refresh:
    """The orders of `keys` and all their lineitems, as `tables` holds
    them, as RF1-shaped INSERTs in one transaction (a re-insert of
    orders RF2 deleted, or of live ones, which must collide)."""
    schemas, cats = _schemas_of(tables)
    keys = np.asarray(keys, np.int64)
    rows = {}
    stmts = []
    for table, col in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        pick = np.isin(tables[table][col], keys)
        rows[table] = {c: a[pick] for c, a in tables[table].items()}
        stmts += insert_statements(table, schemas[table], rows[table], cats)
    return Refresh(["begin"] + stmts + ["commit"], rows,
                   np.zeros(0, np.int64))


def apply_refresh(tables, refresh: Refresh) -> dict:
    """The corpus after `refresh`, as numpy arrays (a new dict; the
    tables it does not touch are shared)."""
    out = dict(tables)
    for table, rows in refresh.inserts.items():
        out[table] = {c: np.concatenate([a, rows[c]])
                      for c, a in tables[table].items()}
    if len(refresh.delete_keys):
        for table, col in (("lineitem", "l_orderkey"),
                           ("orders", "o_orderkey")):
            keep = ~np.isin(out[table][col], refresh.delete_keys)
            out[table] = {c: a[keep] for c, a in out[table].items()}
    return out


def apply_sqlite(conn: sqlite3.Connection, statements: List[str]) -> None:
    """Run refresh statements on the sqlite3 oracle."""
    for sql in statements:
        conn.execute(to_sqlite_sql(sql))


# ------------------------------------------------------------ sqlite oracle

def to_sqlite(tables: Dict[str, Dict[str, np.ndarray]]) -> sqlite3.Connection:
    conn = sqlite3.connect(":memory:")
    for name, arrays in tables.items():
        schema = _SCHEMAS[name]
        cols = ", ".join(c for c, _ in schema)
        conn.execute(f"create table {name} ({cols})")
        mats = []
        for c, dtype in schema:
            a = arrays[c]
            if dtype.oid == dt.TypeOid.DECIMAL64:
                mats.append([v / 100.0 for v in a.tolist()])
            elif dtype.oid == dt.TypeOid.DATE:
                mats.append([(
                    _EPOCH + datetime.timedelta(days=int(v))).isoformat()
                    for v in a.tolist()])
            elif dtype.is_varlen:
                mats.append([str(v) for v in a.tolist()])
            else:
                mats.append(a.tolist())
        rows = list(zip(*mats))
        ph = ",".join("?" * len(schema))
        conn.executemany(f"insert into {name} values ({ph})", rows)
    # join-key indexes: without them the oracle's nested loops are
    # unusable at sf >= 0.1 (Q19 alone runs for the better part of an
    # hour); the indexes change nothing about the golden answers
    for ix in ("lineitem (l_orderkey)", "lineitem (l_partkey)",
               "lineitem (l_suppkey)", "orders (o_orderkey)",
               "orders (o_custkey)", "customer (c_custkey)",
               "customer (c_nationkey)", "part (p_partkey)",
               "partsupp (ps_partkey)", "partsupp (ps_suppkey)",
               "supplier (s_suppkey)", "supplier (s_nationkey)",
               "nation (n_nationkey)", "region (r_regionkey)"):
        conn.execute(
            f"create index idx_{ix.split(' ')[0]}_"
            f"{ix.split('(')[1].rstrip(')')} on {ix}")
    conn.execute("analyze")
    conn.commit()
    return conn


_INTERVAL_RE = re.compile(
    r"date\s+'(\d{4})-(\d{2})-(\d{2})'\s*([+-])\s*interval\s+'(\d+)'\s+"
    r"(day|month|year)")
_EXTRACT_RE = re.compile(r"extract\s*\(\s*year\s+from\s+([a-z0-9_.]+)\s*\)")
_SUBSTR_RE = re.compile(r"substring\s*\(")


def _shift_date(y, m, d, sign, n, unit):
    if unit == "day":
        return datetime.date(y, m, d) + datetime.timedelta(days=sign * n)
    months = y * 12 + (m - 1) + sign * n * (12 if unit == "year" else 1)
    return datetime.date(months // 12, months % 12 + 1, d)


def to_sqlite_sql(sql: str) -> str:
    """Translate the engine dialect to sqlite: fold date +/- interval into
    literals, extract(year) -> strftime, substring -> substr, strip the
    date keyword."""
    def fold(m):
        y, mo, d, sign, n, unit = m.groups()
        out = _shift_date(int(y), int(mo), int(d),
                          1 if sign == "+" else -1, int(n), unit)
        return f"'{out.isoformat()}'"
    sql = _INTERVAL_RE.sub(fold, sql)
    sql = _EXTRACT_RE.sub(r"cast(strftime('%Y', \1) as integer)", sql)
    sql = _SUBSTR_RE.sub("substr(", sql)
    sql = re.sub(r"\bdate\s+'", "'", sql)
    return sql


# ------------------------------------------------------------- the queries

QUERIES: Dict[int, str] = {}

QUERIES[1] = """
select l_returnflag, l_linestatus,
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

QUERIES[2] = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
    s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
  and p_type like '%BRASS' and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost)
    from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

QUERIES[3] = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

QUERIES[4] = """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey
                and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
"""

QUERIES[5] = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc
"""

QUERIES[6] = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount >= 0.05 and l_discount <= 0.07
  and l_quantity < 24
"""

QUERIES[7] = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
          extract(year from l_shipdate) as l_year,
          l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey
        and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
          or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate >= date '1995-01-01'
        and l_shipdate <= date '1996-12-31') as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

QUERIES[8] = """
select o_year,
    sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
        as mkt_share
from (select extract(year from o_orderdate) as o_year,
          l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation
      from part, supplier, lineitem, orders, customer, nation n1,
          nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
        and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
        and o_orderdate >= date '1995-01-01'
        and o_orderdate <= date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL') as all_nations
group by o_year
order by o_year
"""

QUERIES[9] = """
select nation, o_year, sum(amount) as sum_profit
from (select n_name as nation, extract(year from o_orderdate) as o_year,
          l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity
              as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey and p_partkey = l_partkey
        and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%') as profit
group by nation, o_year
order by nation, o_year desc
"""

QUERIES[10] = """
select c_custkey, c_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
    c_comment
order by revenue desc
limit 20
"""

QUERIES[11] = """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
      and n_name = 'GERMANY')
order by value desc
"""

QUERIES[12] = """
select l_shipmode,
    sum(case when o_orderpriority = '1-URGENT'
          or o_orderpriority = '2-HIGH' then 1 else 0 end)
        as high_line_count,
    sum(case when o_orderpriority <> '1-URGENT'
          and o_orderpriority <> '2-HIGH' then 1 else 0 end)
        as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
"""

QUERIES[13] = """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders on c_custkey = o_custkey
        and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc
"""

QUERIES[14] = """
select 100.00 * sum(case when p_type like 'PROMO%'
        then l_extendedprice * (1 - l_discount) else 0 end)
    / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
"""

QUERIES[15] = """
with revenue0 as (
    select l_suppkey as supplier_no,
        sum(l_extendedprice * (1 - l_discount)) as total_revenue
    from lineitem
    where l_shipdate >= date '1996-01-01'
      and l_shipdate < date '1996-01-01' + interval '3' month
    group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
"""

QUERIES[16] = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
    select s_suppkey from supplier
    where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

QUERIES[17] = """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)
"""

QUERIES[18] = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum(l_quantity) as total_qty
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
"""

QUERIES[19] = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
    and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
    and l_quantity >= 1 and l_quantity <= 11
    and p_size >= 1 and p_size <= 5
    and l_shipmode in ('AIR', 'REG AIR')
    and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#23'
    and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
    and l_quantity >= 10 and l_quantity <= 20
    and p_size >= 1 and p_size <= 10
    and l_shipmode in ('AIR', 'REG AIR')
    and l_shipinstruct = 'DELIVER IN PERSON')
  or (p_partkey = l_partkey and p_brand = 'Brand#34'
    and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
    and l_quantity >= 20 and l_quantity <= 30
    and p_size >= 1 and p_size <= 15
    and l_shipmode in ('AIR', 'REG AIR')
    and l_shipinstruct = 'DELIVER IN PERSON')
"""

QUERIES[20] = """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'forest%')
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval '1' year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
"""

QUERIES[21] = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
"""

QUERIES[22] = """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone, 1, 2) in
            ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (
          select avg(c_acctbal) from customer
          where c_acctbal > 0.00
            and substring(c_phone, 1, 2) in
                ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select * from orders
                        where o_custkey = c_custkey)) as custsale
group by cntrycode
order by cntrycode
"""


# ------------------------------------------------------------- comparison

def normalize_rows(rows):
    """Rows -> sorted list of tuples (order-insensitive content comparison;
    ORDER BY ties make strict order comparison ill-defined for both
    engines). Values stay full-precision; compare with rows_match."""
    out = []
    for row in rows:
        norm = []
        for v in row:
            if v is None:
                norm.append(None)
            elif isinstance(v, (int, float, np.integer, np.floating)):
                norm.append(float(v))
            else:
                s = str(v)
                try:
                    norm.append(float(s))
                except ValueError:
                    norm.append(s)
        out.append(tuple(norm))
    return sorted(out, key=lambda r: tuple(
        (x is None, "" if isinstance(x, float) else str(x),
         x if isinstance(x, float) else 0.0) for x in r))


def _value_match(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        # our engine sums decimals exactly; sqlite sums floats — allow the
        # float error (abs for money magnitudes, rel for ratios)
        return abs(a - b) <= 0.02 + 1e-6 * max(abs(a), abs(b))
    return a == b


def rows_match(g, w) -> bool:
    if len(g) != len(w):
        return False
    if all(len(rg) == len(rw) and all(_value_match(x, y)
                                      for x, y in zip(rg, rw))
           for rg, rw in zip(g, w)):
        return True
    # positional compare can misalign when float noise reorders near-equal
    # sort keys; fall back to greedy tolerant multiset matching
    used = [False] * len(w)
    for rg in g:
        hit = False
        for i, rw in enumerate(w):
            if not used[i] and len(rg) == len(rw) and all(
                    _value_match(x, y) for x, y in zip(rg, rw)):
                used[i] = True
                hit = True
                break
        if not hit:
            return False
    return True


def run_compare(session, conn: sqlite3.Connection, qnum: int):
    """Run query qnum on both engines; raise AssertionError on mismatch."""
    sql = QUERIES[qnum]
    got = session.execute(sql).rows()
    want = conn.execute(to_sqlite_sql(sql)).fetchall()
    g = normalize_rows(got)
    w = normalize_rows(want)
    assert rows_match(g, w), (
        f"Q{qnum} mismatch: {len(g)} vs {len(w)} rows\n"
        f"  diff={[ (a, b) for a, b in zip(g, w) if not _value_match0(a, b)][:3] if len(g) == len(w) else (g[:3], w[:3])}")
    return len(g)


def _value_match0(ra, rb):
    return all(_value_match(x, y) for x, y in zip(ra, rb))
