"""TPC-DS through the port against the JAX package: the plain slice
queries without a pandas oracle, single node at sf 0.3, and the 27
queries outside the slice, which raise.  Set-up and tolerances are
tests/test_torch_tpcds.py's."""

import pytest
import torch

from opentenbase_tpu.tpcds.queries import Q
from opentenbase_tpu_torch.tpcds.queries import Q as TQ
from test_torch_tpcds import (NOT_IN_SLICE, ORACLES, PLAIN_QUERIES,
                              generate_both, port_session,
                              reference_session, rows_match)

PLAIN_HERE = tuple(q for q in PLAIN_QUERIES if q not in ORACLES)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def sessions():
    rdata, tdata = generate_both()
    return reference_session(rdata), port_session(tdata)


@pytest.mark.parametrize("q", PLAIN_HERE)
def test_plain_query_matches_reference(sessions, q):
    r, t = sessions
    rows_match(t.query(TQ[q]), r.query(Q[q]))


@pytest.mark.parametrize("q", NOT_IN_SLICE)
def test_query_outside_the_slice_raises(sessions, q):
    _, t = sessions
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t.query(TQ[q])
