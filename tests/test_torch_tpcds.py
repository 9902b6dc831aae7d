"""TPC-DS through the port against the JAX package: the generator and
query text, the 8 window queries and the plain queries that have a
pandas oracle, single node and (the window queries) on the port's
Cluster(2).  tests/test_torch_tpcds_plain.py holds the other plain
queries, the 23 set-operation queries and the 4 that raise.

The slice: the 64 "plain" TPC-DS queries (no window, set operation,
GROUPING SETS/ROLLUP or DISTINCT aggregate), the 8 window-only ones, and
the 23 whose set operations (UNION [ALL], INTERSECT, EXCEPT, and ROLLUP
through its UNION ALL expansion) run on Append and SetOp, 3 of them with
windows.  The other 4 wait for DISTINCT aggregates and raise
NotImplementedError in the port.  Both packages run single
node at the reference suite's scale (sf 0.3: 1,200 store_sales rows),
loaded once per module; the reference runs only through its
single-node Session, never its ClusterSession or mesh tier, whose
TPC-DS compile can abort the interpreter.  The pandas oracles of
tests/test_tpcds.py are reached through the module object, so pytest
does not collect that suite a second time here.
"""

import math

import numpy as np
import pandas as pd
import pytest
import torch

import test_tpcds as ref_suite

from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.tpcds import datagen as rdatagen
from opentenbase_tpu.tpcds.queries import Q
from opentenbase_tpu.tpcds.schema import SCHEMA
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.tpcds import datagen as tdatagen
from opentenbase_tpu_torch.tpcds.queries import Q as TQ
from opentenbase_tpu_torch.tpcds.schema import SCHEMA as TSCHEMA

SF = 0.3
#: f64 outputs: the order of f64 additions differs (1-2 ulp seen, q9);
#: decimal quotients hold at 1e-10 (ROADMAP queue 3), none needs it here
F64_RTOL = 1e-12

WINDOW_QUERIES = (12, 20, 44, 53, 63, 67, 89, 98)
SETOP_QUERIES = (2, 4, 5, 11, 14, 18, 22, 33, 36, 38, 49, 56, 60, 66, 70,
                 71, 74, 75, 76, 77, 80, 86, 87)
NOT_IN_SLICE = (16, 28, 94, 95)
PLAIN_QUERIES = tuple(q for q in range(1, 100)
                      if q not in WINDOW_QUERIES + SETOP_QUERIES
                      + NOT_IN_SLICE)
#: slice queries with a pandas oracle method in tests/test_tpcds.py
ORACLES = {1: "TestTpcdsExpansion", 3: "TestTpcdsStarter",
           6: "TestTpcdsExpansion", 7: "TestTpcdsExpansion",
           9: "TestTpcdsExpansion", 12: "TestTpcdsStarter",
           13: "TestTpcdsExpansion", 15: "TestTpcdsExpansion",
           19: "TestTpcdsExpansion", 25: "TestTpcdsExpansion",
           34: "TestTpcdsExpansion", 37: "TestTpcdsExpansion",
           40: "TestTpcdsExpansion", 42: "TestTpcdsStarter",
           43: "TestTpcdsExpansion", 46: "TestTpcdsExpansion",
           48: "TestTpcdsExpansion", 50: "TestTpcdsExpansion",
           51: "TestTpcdsStarter", 52: "TestTpcdsStarter",
           53: "TestTpcdsExpansion", 54: "TestTpcdsStarter",
           55: "TestTpcdsStarter", 61: "TestTpcdsExpansion",
           65: "TestTpcdsExpansion", 67: "TestTpcdsStarter",
           81: "TestTpcdsExpansion", 98: "TestTpcdsExpansion"}


def reference_session(data):
    r = RSession(RNode())
    r.execute(SCHEMA)
    for tname, cols in data.items():
        r._insert_rows(r.node.catalog.table(tname), r.node.stores[tname],
                       cols, len(next(iter(cols.values()))))
    return r


def port_session(data):
    t = TSession(TNode(device="cpu"))
    t.execute(TSCHEMA)
    tdatagen.load_into(t, data)
    return t


def generate_both(sf=SF):
    return rdatagen.generate(sf=sf), tdatagen.generate(sf=sf)


def rows_match(got, want, rtol=F64_RTOL):
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float) \
                    and not (math.isnan(a) and math.isnan(b)):
                assert a == pytest.approx(b, rel=rtol, abs=0), \
                    f"row {i}: {a} != {b} ({g} vs {w})"
            else:
                assert a == b or (a != a and b != b), \
                    f"row {i}: {a!r} != {b!r} ({g} vs {w})"


#: plain slice queries in this file (those with an oracle); the rest are
#: in tests/test_torch_tpcds_plain.py
PLAIN_HERE = tuple(q for q in PLAIN_QUERIES if q in ORACLES)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def both_data():
    return generate_both()


@pytest.fixture(scope="module")
def sessions(both_data):
    rdata, tdata = both_data
    return reference_session(rdata), port_session(tdata)


@pytest.fixture(scope="module")
def frames(both_data):
    return {name: pd.DataFrame(dict(cols))
            for name, cols in both_data[0].items()}


def assert_same_data(ref: dict, port: dict):
    assert list(port) == list(ref)
    for tname, cols in ref.items():
        assert list(port[tname]) == list(cols), tname
        for c, want in cols.items():
            a, b = np.asarray(port[tname][c]), np.asarray(want)
            assert a.shape == b.shape and a.dtype == b.dtype, (tname, c)
            np.testing.assert_array_equal(a, b, err_msg=f"{tname}.{c}")


def test_datagen_equal_array_by_array(both_data):
    assert_same_data(*both_data)


def test_datagen_equal_at_sf_7_2():
    assert_same_data(*generate_both(7.2))


@pytest.mark.slow
def test_datagen_equal_at_store_sales_sf1_size():
    ref, port = generate_both(720.1)
    assert len(port["store_sales"]["ss_item_sk"]) == 2_880_400
    assert_same_data(ref, port)


def test_queries_and_schema_are_the_same_text():
    assert TQ == Q and TSCHEMA == SCHEMA
    assert sorted(WINDOW_QUERIES + PLAIN_QUERIES + SETOP_QUERIES
                  + NOT_IN_SLICE) == list(range(1, 100))
    assert len(PLAIN_QUERIES) == 64 and len(SETOP_QUERIES) == 23


@pytest.mark.parametrize("q", WINDOW_QUERIES + PLAIN_HERE)
def test_query_matches_reference(sessions, q):
    r, t = sessions
    rows_match(t.query(TQ[q]), r.query(Q[q]))


@pytest.mark.parametrize("q", sorted(ORACLES))
def test_query_matches_pandas_oracle(sessions, frames, q):
    _, t = sessions
    oracle = getattr(getattr(ref_suite, ORACLES[q])(), f"_q{q}")
    ref_suite.rows_equal(t.query(TQ[q]), oracle(frames))


@pytest.fixture(scope="module")
def cluster(both_data):
    cs = ClusterSession(Cluster(2, device="cpu"))
    cs.execute(TSCHEMA)
    tdatagen.load_into_cluster(cs, both_data[1])
    return cs


@pytest.mark.parametrize("q", WINDOW_QUERIES)
def test_window_query_on_cluster_matches_single_node(sessions, cluster, q):
    _, t = sessions
    rows_match(cluster.query(TQ[q]), t.query(TQ[q]))
    assert cluster.last_tier == "mesh"
