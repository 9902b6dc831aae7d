"""Constraint enforcement on insert: NOT NULL.

A copy of the NOT NULL half of opentenbase_tpu/exec/constraints.py.
CHECK and FOREIGN KEY validation (set-based queries inside the writing
transaction) are not ported yet; the session refuses tables that
declare them.
"""

from __future__ import annotations

import numpy as np

from .executor import ExecError


class ConstraintViolation(ExecError):
    pass


def check_not_null(td, coldata: dict, n: int):
    """Host-side scan of the incoming column data (the one per-value
    pass that cannot be a query — the rows aren't stored yet)."""
    for c in td.columns:
        if c.nullable or c.name not in coldata:
            continue
        vals = coldata[c.name]
        if isinstance(vals, np.ndarray):
            bad = vals.dtype == object and any(v is None for v in vals)
        else:
            bad = any(v is None for v in vals)
        if bad:
            raise ConstraintViolation(
                f"null value in column {c.name!r} of relation "
                f"{td.name!r} violates not-null constraint")
