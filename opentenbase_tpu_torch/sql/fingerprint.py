"""Statement fingerprinting for SPM plan baselines (a copy of
opentenbase_tpu/sql/fingerprint.py).

Reference analog: the normalized-SQL keying of optimizer/spm/spm.c —
literals are masked so `WHERE k = 5` and `WHERE k = 9` share one
baseline, while any structural change (different tables, joins,
grouping) produces a different key.  The fingerprint is a SHA-256 of
the bound statement's AST with every constant replaced by '?'.
"""

from __future__ import annotations

import dataclasses
import hashlib

from . import ast as A


def _walk(node, out: list, mask: bool = True):
    if isinstance(node, (A.Const, A.TypedConst)):
        if mask:
            out.append("?")
            return
        # unmasked: serialize the WHOLE literal node — kind/type_name/
        # unit/qty distinguish `interval '1' day` from `... month` and
        # numeric 1.5 from string '1.5' (dropping them collides
        # distinct statements in the exact-plan cache)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        out.append(type(node).__name__)
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), out, mask)
        return
    if isinstance(node, (list, tuple)):
        out.append("[")
        for x in node:
            _walk(x, out, mask)
        out.append("]")
        return
    out.append(repr(node))


def fingerprint(stmt: A.Node, mask_literals: bool = True) -> str:
    """mask_literals=False keys the EXACT statement (literals
    included) — the generic ad-hoc plan cache key, vs the SPM
    baseline's literal-masked key."""
    out: list = []
    _walk(stmt, out, mask_literals)
    return hashlib.sha256("\x1f".join(out).encode()).hexdigest()[:24]


def struct_key(obj) -> str:
    """Stable digest of an arbitrary nested structure (tuples, frozen
    Expr dataclasses, scalars) — the canonical-fragment-signature hash
    the compiled-program caches key on (exec/plancache.py).  Unlike
    hash(), it never collides two distinct plan shapes into one
    compiled executable, and unlike the raw tuple it is cheap to hold
    as a dict key."""
    out: list = []
    _walk(obj, out, mask=False)
    return hashlib.sha256("\x1f".join(out).encode()).hexdigest()[:24]
