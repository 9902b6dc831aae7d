"""Deterministic TPC-DS-shaped data generator (starter scale).

Not dsdgen-conformant — a seeded synthetic population with the joins,
skew, and NULL characteristics the query set exercises (dsdgen's
output is only needed for published-result comparability; correctness
is asserted against pandas oracles on THIS data).

The port's copy adds TABLES and load_into / load_into_cluster, as the
port's tpch/datagen.py has them; generate() is the reference's."""

from __future__ import annotations

import numpy as np

BRANDS = [f"brand#{i}" for i in range(1, 11)]
CATEGORIES = ["Books", "Electronics", "Home", "Music", "Sports"]
CLASSES = ["c1", "c2", "c3"]
FIRST = ["ada", "bob", "carol", "dan", "eve", "frank"]
LAST = ["smith", "jones", "lee", "patel", "kim"]
STATES = ["TN", "GA", "OH", "TX", "CA", "WA", "NY", "FL"]
CITIES = [f"city_{i}" for i in range(12)]
COUNTIES = [f"county_{i}" for i in range(8)]
EDUCATION = ["Primary", "Secondary", "College", "Advanced Degree"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", ">5000"]


def generate(sf: float = 1.0, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    n_dates = 730                      # two years of days
    n_items = max(int(60 * sf), 20)
    n_cust = max(int(120 * sf), 30)
    n_addr = max(int(60 * sf), 20)
    n_stores = 6
    n_wh = 3
    n_cd = 48
    n_hd = 20
    n_promo = 10
    n_sm = 5
    n_reason = 8
    n_cc = 4
    n_web = 3
    n_ss = max(int(4000 * sf), 400)
    n_cs = max(int(1500 * sf), 150)
    n_ws = max(int(1500 * sf), 150)

    base = np.datetime64("1999-01-01")
    days = [base + np.timedelta64(i, "D") for i in range(n_dates)]
    dates = {
        "d_date_sk": np.arange(1, n_dates + 1, dtype=np.int64),
        "d_date": [str(d) for d in days],
        "d_year": np.asarray(
            [d.astype("datetime64[Y]").astype(int) + 1970 for d in days],
            np.int32),
        "d_moy": np.asarray([int(str(d)[5:7]) for d in days], np.int32),
        "d_dow": np.asarray(
            [(d.astype("datetime64[D]").astype(int) + 4) % 7
             for d in days], np.int32),          # 1970-01-01 = Thursday
        "d_month_seq": np.asarray(
            [d.astype("datetime64[M]").astype(int) for d in days],
            np.int32),
    }

    items = {
        "i_item_sk": np.arange(1, n_items + 1, dtype=np.int64),
        "i_brand_id": rng.integers(1, len(BRANDS) + 1,
                                   n_items).astype(np.int32),
        "i_category_id": rng.integers(1, len(CATEGORIES) + 1,
                                      n_items).astype(np.int32),
        "i_manufact_id": rng.integers(1, 12, n_items).astype(np.int32),
        "i_manager_id": rng.integers(1, 40, n_items).astype(np.int32),
        "i_current_price": np.round(
            rng.uniform(0.5, 99.0, n_items), 2),
    }
    items["i_brand"] = [BRANDS[b - 1] for b in items["i_brand_id"]]
    items["i_category"] = [CATEGORIES[c - 1]
                           for c in items["i_category_id"]]
    items["i_class"] = [CLASSES[i % len(CLASSES)]
                        for i in range(n_items)]

    stores = {
        "s_store_sk": np.arange(1, n_stores + 1, dtype=np.int64),
        "s_store_name": [f"store_{i}" for i in range(n_stores)],
        "s_state": [STATES[i % 4] for i in range(n_stores)],
        "s_county": [COUNTIES[i % 3] for i in range(n_stores)],
    }

    addr = {
        "ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64),
        "ca_state": [STATES[i % len(STATES)] for i in range(n_addr)],
        "ca_city": [CITIES[i % len(CITIES)] for i in range(n_addr)],
        "ca_county": [COUNTIES[i % len(COUNTIES)] for i in range(n_addr)],
        "ca_gmt_offset": np.asarray([-5 - (i % 2) for i in range(n_addr)],
                                    np.int32),
    }

    cd = {
        "cd_demo_sk": np.arange(1, n_cd + 1, dtype=np.int64),
        "cd_gender": ["M" if i % 2 else "F" for i in range(n_cd)],
        "cd_marital_status": ["MSDWU"[i % 5] for i in range(n_cd)],
        "cd_education_status": [EDUCATION[i % len(EDUCATION)]
                                for i in range(n_cd)],
        "cd_dep_count": np.asarray([i % 7 for i in range(n_cd)], np.int32),
    }

    hd = {
        "hd_demo_sk": np.arange(1, n_hd + 1, dtype=np.int64),
        "hd_buy_potential": [BUY_POTENTIAL[i % len(BUY_POTENTIAL)]
                             for i in range(n_hd)],
        "hd_dep_count": np.asarray([i % 6 for i in range(n_hd)], np.int32),
        "hd_vehicle_count": np.asarray([i % 5 for i in range(n_hd)],
                                       np.int32),
    }

    wh = {
        "w_warehouse_sk": np.arange(1, n_wh + 1, dtype=np.int64),
        "w_warehouse_name": [f"wh_{i}" for i in range(n_wh)],
        "w_state": [STATES[i % 3] for i in range(n_wh)],
    }

    promo = {
        "p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64),
        "p_channel_email": ["Y" if i % 3 == 0 else "N"
                            for i in range(n_promo)],
        "p_channel_event": ["Y" if i % 4 == 0 else "N"
                            for i in range(n_promo)],
    }

    SM_TYPES = ["EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
    sm = {
        "sm_ship_mode_sk": np.arange(1, n_sm + 1, dtype=np.int64),
        "sm_type": [SM_TYPES[i % len(SM_TYPES)] for i in range(n_sm)],
    }
    reason = {
        "r_reason_sk": np.arange(1, n_reason + 1, dtype=np.int64),
        "r_reason_desc": [f"reason_{i}" for i in range(n_reason)],
    }
    cc = {
        "cc_call_center_sk": np.arange(1, n_cc + 1, dtype=np.int64),
        "cc_name": [f"cc_{i}" for i in range(n_cc)],
        "cc_county": [COUNTIES[i % len(COUNTIES)] for i in range(n_cc)],
    }
    web = {
        "web_site_sk": np.arange(1, n_web + 1, dtype=np.int64),
        "web_name": [f"site_{i}" for i in range(n_web)],
    }

    cust = {
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_first_name": [FIRST[i % len(FIRST)] for i in range(n_cust)],
        "c_last_name": [LAST[i % len(LAST)] for i in range(n_cust)],
        "c_birth_year": rng.integers(1940, 2000,
                                     n_cust).astype(np.int32),
        "c_current_addr_sk": rng.integers(1, n_addr + 1,
                                          n_cust).astype(np.int64),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1,
                                           n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, n_hd + 1,
                                           n_cust).astype(np.int64),
    }

    def sales(n, prefix):
        out = {
            f"{prefix}_sold_date_sk": rng.integers(
                1, n_dates + 1, n).astype(np.int64),
            f"{prefix}_item_sk": (rng.zipf(1.3, n).clip(1, n_items)
                                  ).astype(np.int64),
            f"{prefix}_quantity": rng.integers(1, 20, n).astype(np.int32),
        }
        price = np.round(rng.uniform(1.0, 300.0, n), 2)
        out[f"{prefix}_ext_sales_price"] = price
        out[f"{prefix}_sales_price"] = np.round(
            price / out[f"{prefix}_quantity"], 2)
        return out

    ss = sales(n_ss, "ss")
    # store tickets group several line items sharing customer, store,
    # household, address, and date (TPC-DS ticket semantics — Q34/Q46
    # count items per ticket)
    n_tk = max(n_ss // 4, 1)
    tk_cust = rng.integers(1, n_cust + 1, n_tk).astype(np.int64)
    tk_hdemo = rng.integers(1, n_hd + 1, n_tk).astype(np.int64)
    tk_addr = rng.integers(1, n_addr + 1, n_tk).astype(np.int64)
    tk_store = rng.integers(1, n_stores + 1, n_tk).astype(np.int64)
    tk_date = rng.integers(1, n_dates + 1, n_tk).astype(np.int64)
    tid = rng.integers(0, n_tk, n_ss)
    ss["ss_ticket"] = (tid + 1).astype(np.int32)
    ss["ss_sold_date_sk"] = tk_date[tid]
    ss["ss_customer_sk"] = tk_cust[tid]
    ss["ss_cdemo_sk"] = rng.integers(1, n_cd + 1, n_ss).astype(np.int64)
    ss["ss_hdemo_sk"] = tk_hdemo[tid]
    ss["ss_addr_sk"] = tk_addr[tid]
    ss["ss_store_sk"] = tk_store[tid]
    ss["ss_promo_sk"] = rng.integers(1, n_promo + 1,
                                     n_ss).astype(np.int64)
    ss["ss_list_price"] = np.round(
        ss["ss_sales_price"] * rng.uniform(1.0, 1.5, n_ss), 2)
    ss["ss_coupon_amt"] = np.round(
        ss["ss_ext_sales_price"] * rng.uniform(0, 0.15, n_ss), 2)
    ss["ss_net_profit"] = np.round(
        ss["ss_ext_sales_price"] * rng.uniform(-0.2, 0.4, n_ss), 2)

    def returns(src, n_src, prefix, n_ret):
        idx = rng.choice(n_src, size=n_ret, replace=False)
        lag = rng.integers(1, 90, n_ret)
        rdate = np.minimum(src[f"{prefix}_sold_date_sk"][idx] + lag,
                           n_dates)
        qty = np.maximum(src[f"{prefix}_quantity"][idx] // 2, 1)
        amt = np.round(src[f"{prefix}_ext_sales_price"][idx]
                       * rng.uniform(0.2, 1.0, n_ret), 2)
        return idx, rdate, qty.astype(np.int32), amt

    sr_idx, sr_date, sr_qty, sr_amt = returns(ss, n_ss, "ss",
                                              n_ss // 4)
    sr = {
        "sr_ticket": ss["ss_ticket"][sr_idx],
        "sr_item_sk": ss["ss_item_sk"][sr_idx],
        "sr_returned_date_sk": sr_date,
        "sr_customer_sk": ss["ss_customer_sk"][sr_idx],
        "sr_store_sk": ss["ss_store_sk"][sr_idx],
        "sr_reason_sk": rng.integers(1, n_reason + 1,
                                     len(sr_idx)).astype(np.int64),
        "sr_return_quantity": sr_qty,
        "sr_return_amt": sr_amt,
    }

    cs = sales(n_cs, "cs")
    cs["cs_order"] = np.arange(1, n_cs + 1, dtype=np.int32)
    cs["cs_ship_date_sk"] = np.minimum(
        cs["cs_sold_date_sk"] + rng.integers(1, 120, n_cs), n_dates)
    cs["cs_bill_customer_sk"] = rng.integers(
        1, n_cust + 1, n_cs).astype(np.int64)
    cs["cs_bill_cdemo_sk"] = rng.integers(1, n_cd + 1,
                                          n_cs).astype(np.int64)
    cs["cs_warehouse_sk"] = rng.integers(1, n_wh + 1,
                                         n_cs).astype(np.int64)
    cs["cs_promo_sk"] = rng.integers(1, n_promo + 1,
                                     n_cs).astype(np.int64)
    cs["cs_ship_mode_sk"] = rng.integers(1, n_sm + 1,
                                         n_cs).astype(np.int64)
    cs["cs_call_center_sk"] = rng.integers(1, n_cc + 1,
                                           n_cs).astype(np.int64)
    cs["cs_net_profit"] = np.round(
        cs["cs_ext_sales_price"] * rng.uniform(-0.2, 0.4, n_cs), 2)

    cr_idx, cr_date, cr_qty, cr_amt = returns(cs, n_cs, "cs",
                                              n_cs // 4)
    cr = {
        "cr_order": cs["cs_order"][cr_idx],
        "cr_item_sk": cs["cs_item_sk"][cr_idx],
        "cr_returned_date_sk": cr_date,
        "cr_returning_customer_sk": cs["cs_bill_customer_sk"][cr_idx],
        "cr_call_center_sk": cs["cs_call_center_sk"][cr_idx],
        "cr_return_quantity": cr_qty,
        "cr_return_amount": cr_amt,
    }

    ws = sales(n_ws, "ws")
    ws["ws_order"] = np.arange(1, n_ws + 1, dtype=np.int32)
    ws["ws_ship_date_sk"] = np.minimum(
        ws["ws_sold_date_sk"] + rng.integers(1, 120, n_ws), n_dates)
    ws["ws_bill_customer_sk"] = rng.integers(
        1, n_cust + 1, n_ws).astype(np.int64)
    ws["ws_promo_sk"] = rng.integers(1, n_promo + 1,
                                     n_ws).astype(np.int64)
    ws["ws_ship_mode_sk"] = rng.integers(1, n_sm + 1,
                                         n_ws).astype(np.int64)
    ws["ws_warehouse_sk"] = rng.integers(1, n_wh + 1,
                                         n_ws).astype(np.int64)
    ws["ws_web_site_sk"] = rng.integers(1, n_web + 1,
                                        n_ws).astype(np.int64)
    ws["ws_net_profit"] = np.round(
        ws["ws_ext_sales_price"] * rng.uniform(-0.2, 0.4, n_ws), 2)

    wr_idx, wr_date, wr_qty, wr_amt = returns(ws, n_ws, "ws",
                                              n_ws // 4)
    wr = {
        "wr_order": ws["ws_order"][wr_idx],
        "wr_item_sk": ws["ws_item_sk"][wr_idx],
        "wr_returned_date_sk": wr_date,
        "wr_returning_customer_sk": ws["ws_bill_customer_sk"][wr_idx],
        "wr_return_quantity": wr_qty,
        "wr_return_amt": wr_amt,
        "wr_net_loss": np.round(wr_amt * rng.uniform(0.1, 0.6,
                                                     len(wr_idx)), 2),
    }

    # inventory: monthly snapshots per (item, warehouse)
    months = dates["d_date_sk"][np.asarray(
        [i for i in range(n_dates) if str(days[i])[8:10] == "01"])]
    ii, ww, mm = np.meshgrid(items["i_item_sk"], wh["w_warehouse_sk"],
                             months, indexing="ij")
    inv = {
        "inv_item_sk": ii.ravel().astype(np.int64),
        "inv_warehouse_sk": ww.ravel().astype(np.int64),
        "inv_date_sk": mm.ravel().astype(np.int64),
        "inv_quantity_on_hand": rng.integers(
            0, 1000, ii.size).astype(np.int32),
    }

    return {"date_dim": dates, "item": items, "store": stores,
            "customer": cust, "customer_address": addr,
            "customer_demographics": cd, "household_demographics": hd,
            "warehouse": wh, "promotion": promo, "ship_mode": sm,
            "reason": reason, "call_center": cc, "web_site": web,
            "store_sales": ss, "store_returns": sr,
            "catalog_sales": cs, "catalog_returns": cr,
            "web_sales": ws, "web_returns": wr, "inventory": inv}


TABLES = ("date_dim", "item", "store", "customer", "customer_address",
          "customer_demographics", "household_demographics", "warehouse",
          "promotion", "ship_mode", "reason", "call_center", "web_site",
          "store_sales", "store_returns", "catalog_sales",
          "catalog_returns", "web_sales", "web_returns", "inventory")


def load_into(session, data: dict, tables=TABLES):
    """Bulk-load generated data through the session's insert path."""
    for tname in tables:
        tbl = data[tname]
        td = session.node.catalog.table(tname)
        st = session.node.stores[tname]
        n = len(next(iter(tbl.values())))
        session._insert_rows(td, st, tbl, n)


def load_into_cluster(session, data: dict, tables=TABLES):
    """Bulk-load generated data into a ClusterSession (the locator routes
    every row to its DataNode)."""
    for tname in tables:
        tbl = data[tname]
        td = session.cluster.catalog.table(tname)
        n = len(next(iter(tbl.values())))
        session._insert_rows(td, tbl, n)
