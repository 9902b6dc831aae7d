"""TPC-H-shaped data generator.

Not the official dbgen (correctness tests compare this engine against a
pandas oracle *on the same generated data*, so bit-compatibility with dbgen
is unnecessary); row counts, column domains, value distributions and
cross-table relationships follow the spec closely enough that every one of
the 22 queries exercises its intended access pattern and selectivity.
Seeded and vectorized (numpy) so SF0.01 tests are instant and SF1+ bench
loads are fast.  The port's copy derives the orders columns with numpy
alone (the machine with the card has no pandas) and keeps string columns
as numpy string arrays, which the store dictionary-encodes in bulk; the
values equal the reference's lists element by element.
"""

from __future__ import annotations

import numpy as np

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
TYPE_SYLL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYLL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYLL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAME_WORDS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
                "black", "blanched", "blue", "blush", "brown", "burlywood",
                "burnished", "chartreuse", "chiffon", "chocolate", "coral",
                "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
                "dim", "dodger", "drab", "firebrick", "floral", "forest",
                "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
                "honeydew", "hot", "hotpink", "indian", "ivory", "khaki"]
COMMENT_WORDS = ["carefully", "final", "deposits", "requests", "special",
                 "regular", "express", "furiously", "quickly", "silent",
                 "pending", "ironic", "even", "bold", "blithely", "accounts",
                 "packages", "theodolites", "Customer", "Complaints",
                 "unusual", "slyly", "asymptotes", "instructions"]

_EPOCH = np.datetime64("1970-01-01", "D")


def _days(iso: str) -> int:
    return int((np.datetime64(iso, "D") - _EPOCH).astype(np.int64))


STARTDATE = _days("1992-01-01")
ENDDATE = _days("1998-08-02")


def _comments(rng, n, nwords=5):
    w = rng.choice(COMMENT_WORDS, size=(n, nwords))
    out = w[:, 0]
    for j in range(1, nwords):
        out = np.char.add(np.char.add(out, " "), w[:, j])
    return out


def generate(sf: float = 0.01, seed: int = 19980802) -> dict:
    """Returns {table: {column: np.ndarray|list}} (raw python/np values,
    ready for Session insert or .tbl writing)."""
    rng = np.random.default_rng(seed)
    out = {}

    out["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS,
        "r_comment": _comments(rng, 5),
    }
    out["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": np.asarray([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": _comments(rng, 25),
    }

    n_supp = max(int(10000 * sf), 20)
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    supp_nation = rng.integers(0, 25, n_supp)
    out["supplier"] = {
        "s_suppkey": sk,
        "s_name": [f"Supplier#{i:09d}" for i in sk],
        "s_address": _comments(rng, n_supp, 3),
        "s_nationkey": supp_nation.astype(np.int64),
        "s_phone": [f"{11+int(nk)}-{rng.integers(100,999)}-"
                    f"{rng.integers(100,999)}-{rng.integers(1000,9999)}"
                    for nk in supp_nation],
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": _comments(rng, n_supp, 8),
    }

    n_cust = max(int(150000 * sf), 100)
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    cust_nation = rng.integers(0, 25, n_cust)
    out["customer"] = {
        "c_custkey": ck,
        "c_name": [f"Customer#{i:09d}" for i in ck],
        "c_address": _comments(rng, n_cust, 3),
        "c_nationkey": cust_nation.astype(np.int64),
        "c_phone": [f"{11+int(nk)}-{a}-{b}-{c}" for nk, a, b, c in zip(
            cust_nation, rng.integers(100, 999, n_cust),
            rng.integers(100, 999, n_cust), rng.integers(1000, 9999, n_cust))],
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": rng.choice(SEGMENTS, n_cust),
        "c_comment": _comments(rng, n_cust, 8),
    }

    n_part = max(int(200000 * sf), 200)
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    ptype = [f"{a} {b} {c}" for a, b, c in zip(
        rng.choice(TYPE_SYLL1, n_part), rng.choice(TYPE_SYLL2, n_part),
        rng.choice(TYPE_SYLL3, n_part))]
    pprice = np.round(90000 + (pk % 200901) / 10 + 100 * (pk % 1000), 2) / 100
    out["part"] = {
        "p_partkey": pk,
        "p_name": [" ".join(rng.choice(P_NAME_WORDS, 5)) for _ in range(n_part)],
        "p_mfgr": [f"Manufacturer#{m}" for m in brand_m],
        "p_brand": [f"Brand#{m}{n}" for m, n in zip(brand_m, brand_n)],
        "p_type": ptype,
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": rng.choice(CONTAINERS, n_part),
        "p_retailprice": pprice,
        "p_comment": _comments(rng, n_part, 3),
    }

    # partsupp: 4 suppliers per part
    ps_pk = np.repeat(pk, 4)
    n_ps = len(ps_pk)
    ps_sk = ((ps_pk + (np.tile(np.arange(4), n_part)
                       * (n_supp // 4 + 1))) % n_supp) + 1
    out["partsupp"] = {
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk.astype(np.int64),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.00, 1000.00, n_ps), 2),
        "ps_comment": _comments(rng, n_ps, 8),
    }

    n_ord = max(int(1500000 * sf), 1000)
    ok = np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3  # sparse keys
    # dbgen never assigns orders to custkey % 3 == 0 (leaves 1/3 of
    # customers order-less — Q13/Q22 depend on this)
    o_ck = rng.integers(1, n_cust + 1, n_ord).astype(np.int64)
    o_ck = np.where(o_ck % 3 == 0, (o_ck % (n_cust - 1)) + 1, o_ck)
    o_ck = np.where(o_ck % 3 == 0, o_ck + 1, o_ck)
    o_date = rng.integers(STARTDATE, ENDDATE - 151, n_ord)
    out["orders"] = {
        "o_orderkey": ok,
        "o_custkey": o_ck,
        "o_orderstatus": ["F"] * n_ord,  # fixed below from lineitems
        "o_totalprice": np.zeros(n_ord),
        "o_orderdate": o_date.astype(np.int64),
        "o_orderpriority": rng.choice(PRIORITIES, n_ord),
        "o_clerk": [f"Clerk#{i:09d}" for i in rng.integers(1, 1001, n_ord)],
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _comments(rng, n_ord, 6),
    }

    # lineitem: 1..7 per order
    nlines = rng.integers(1, 8, n_ord)
    l_ok = np.repeat(ok, nlines)
    l_odate = np.repeat(o_date, nlines)
    n_li = len(l_ok)
    l_pk = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    # supplier co-located with partsupp rows (one of the part's 4 suppliers)
    pick = rng.integers(0, 4, n_li)
    l_sk = ((l_pk + pick * (n_supp // 4 + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n_li).astype(np.int64)
    eprice = np.round(qty * pprice[l_pk - 1], 2)
    disc = rng.integers(0, 11, n_li) / 100.0
    tax = rng.integers(0, 9, n_li) / 100.0
    shipdate = l_odate + rng.integers(1, 122, n_li)
    commitdate = l_odate + rng.integers(30, 91, n_li)
    receiptdate = shipdate + rng.integers(1, 31, n_li)
    cutoff = _days("1995-06-17")
    returnflag = np.where(receiptdate <= cutoff,
                          rng.choice(["R", "A"], n_li), "N")
    linestatus = np.where(shipdate > cutoff, "O", "F")
    linenumber = (np.arange(n_li, dtype=np.int64)
                  - np.repeat(np.cumsum(nlines) - nlines, nlines)) + 1
    out["lineitem"] = {
        "l_orderkey": l_ok,
        "l_partkey": l_pk,
        "l_suppkey": l_sk.astype(np.int64),
        "l_linenumber": linenumber,
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": eprice,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate.astype(np.int64),
        "l_commitdate": commitdate.astype(np.int64),
        "l_receiptdate": receiptdate.astype(np.int64),
        "l_shipinstruct": rng.choice(INSTRUCTS, n_li),
        "l_shipmode": rng.choice(SHIPMODES, n_li),
        "l_comment": _comments(rng, n_li, 4),
    }

    # orders derived columns, with numpy (no pandas on the card's
    # machine): every order has 1..7 lines, contiguous in l_ok, so each
    # order's lines are one reduceat segment
    first = np.cumsum(nlines) - nlines
    tot = np.add.reduceat(eprice, first)
    nf = np.add.reduceat((linestatus == "F").astype(np.int64), first)
    status = np.where(nf == nlines, "F", np.where(nf == 0, "O", "P"))
    out["orders"]["o_totalprice"] = np.round(tot, 2)
    out["orders"]["o_orderstatus"] = status
    return out


def to_date_strings(table: dict, date_cols: list[str]) -> dict:
    """Convert int day columns to ISO strings (for .tbl files / inserts)."""
    out = dict(table)
    for c in date_cols:
        out[c] = [str(_EPOCH + np.timedelta64(int(v), "D"))
                  for v in table[c]]
    return out


DATE_COLS = {
    "orders": ["o_orderdate"],
    "lineitem": ["l_shipdate", "l_commitdate", "l_receiptdate"],
}


TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")


def load_into(session, data: dict, tables=TABLES):
    """Bulk-load generated data through the session's insert path
    (`tables` picks a subset: Q1 and Q6 read lineitem alone)."""
    for tname in tables:
        tbl = data[tname]
        td = session.node.catalog.table(tname)
        st = session.node.stores[tname]
        n = len(next(iter(tbl.values())))
        session._insert_rows(td, st, tbl, n)


def load_into_cluster(session, data: dict, tables=TABLES):
    """Bulk-load generated data into a ClusterSession: each table through
    its `_insert_rows` (the locator routes every row to its DataNode),
    as the reference's distributed TPC-H suite loads its cluster."""
    for tname in tables:
        tbl = data[tname]
        td = session.cluster.catalog.table(tname)
        n = len(next(iter(tbl.values())))
        session._insert_rows(td, tbl, n)
