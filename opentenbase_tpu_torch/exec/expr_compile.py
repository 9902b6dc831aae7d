"""Expression compiler: typed Expr trees -> closures over torch tensors.

The counterpart of opentenbase_tpu/exec/expr_compile.py.  `compile_expr`
returns a python closure over a dict of column tensors; each call runs
the expression as eager PyTorch elementwise ops on the columns' device.

NULL semantics are compiled as a parallel mask program (compile_pair):
every expression yields (value_fn, null_fn|None).  Strict operators union
their children's masks and leave garbage at null positions of the value
tensor.  Non-strict nodes (AND/OR/NOT via Kleene 3VL, CASE, COALESCE,
NULLIF, IS NULL) manipulate the masks directly.  `null_fn is None` proves
the expression can never be NULL — the TPC-H hot paths carry no mask.

Predicates go through `compile_pred`, which returns the SQL "is true"
test (value & ~null): a WHERE clause keeps a row only when the qual is
definitely true.

String predicates (LIKE/=/< over TEXT) are resolved at compile time against
the store's dictionary into code sets; on device they are integer membership
tests.

Nothing here copies from the host while a fragment program is captured
(exec/fused.py): scalar constants are fills (`torch.full`), host-built
tables (membership code sets, string-hash LUTs) come from `device_const`,
whose cache the program's warm-up run fills, and a masked literal
(`__fraglitN`, or a numeric init-plan value) arrives as a 0-d device
tensor read from the program's literal buffer, never as a Python scalar
baked into the graph.

`emit_scan_agg` is the other back end: it turns a scan -> qual ->
aggregate fragment into the register program of the fused scan-aggregate
kernel (ops/kernels.py fused_scan_agg), op by op as compile_pair would
evaluate it, or declines.

Type promotion follows the reference: a binary operation promotes both
operands to their common dtype whatever their rank.  PyTorch alone would
let a dimensioned int32 column win over a 0-dim int64 literal, so every
binary operation goes through `_common`.  Integer division is floor
division (`torch.div(..., rounding_mode="floor")`), as jnp.floor_divide.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..catalog.types import TypeKind
from ..plan import exprs as E
from ..utils.dtypes import dev_dtype, device_float

Arrays = dict  # name -> tensor (null masks under NULLKEY + name)

NULLKEY = "__null__:"   # env key prefix for column null masks


def like_to_regex(pattern: str) -> re.Pattern:
    """SQL LIKE -> anchored python regex (%, _ wildcards)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.S)


_CONST_LOCK = threading.Lock()
_CONSTS: dict = {}      # guarded_by: _CONST_LOCK
_CONSTS_MAX = 4096


_RETAIN = threading.local()


def device_const(arr: np.ndarray, device) -> torch.Tensor:
    """A host-built constant table on `device`, cached by content: the
    same bytes give the same tensor, never written to.  A fragment
    program's warm-up run fills the cache, so its capture copies
    nothing from the host."""
    arr = np.ascontiguousarray(arr)
    key = (str(device), arr.dtype.str, arr.shape, arr.tobytes())
    with _CONST_LOCK:
        t = _CONSTS.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(device)
        with _CONST_LOCK:
            _CONSTS[key] = t
            while len(_CONSTS) > _CONSTS_MAX:
                _CONSTS.pop(next(iter(_CONSTS)))
    keep = getattr(_RETAIN, "consts", None)
    if keep is not None:
        keep.append(t)
    return t


class retain_consts:
    """Within the block, the constants `device_const` hands out on this
    thread are also collected in the list it yields: a captured program
    keeps them, since a replay reads them in place after the cache may
    have evicted them."""

    def __enter__(self) -> list:
        self.prev = getattr(_RETAIN, "consts", None)
        _RETAIN.consts = []
        return _RETAIN.consts

    def __exit__(self, *exc):
        _RETAIN.consts = self.prev


def _common(a, b):
    """Both operands at their common dtype (rank-blind promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return (a if a.dtype == dt else a.to(dt)), (b if b.dtype == dt
                                                 else b.to(dt))


def _where(cond, a, b):
    a, b = _common(a, b)
    return torch.where(cond, a, b)


def _wide(x):
    """x at its common dtype with int64 (the reference multiplies and
    divides decimals by int64 scalars)."""
    return x.to(torch.promote_types(x.dtype, torch.int64))


def _floordiv(x, d: int):
    return torch.div(_wide(x), d, rounding_mode="floor")


def _rescale(fn, from_scale: int, to_scale: int):
    if from_scale == to_scale:
        return fn
    if to_scale > from_scale:
        mult = 10 ** (to_scale - from_scale)
        return lambda cols, _f=fn, _m=mult: _wide(_f(cols)) * _m
    div = 10 ** (from_scale - to_scale)
    return lambda cols, _f=fn, _d=div: _floordiv(_f(cols), _d)


def case_text_dict(e) -> "list | None":
    """Branch dictionary for a TEXT-valued CASE whose THEN/ELSE values
    are all literals: distinct non-null strings in first-occurrence
    order (the codes the compiled expression emits index into it).
    None when any branch is not a TEXT literal."""
    branches = [v for _, v in e.whens]
    if e.else_ is not None:
        branches.append(e.else_)
    values: list = []
    for v in branches:
        if not isinstance(v, E.Lit):
            return None
        if v.value is None:
            continue
        if v.lit_type.kind != TypeKind.TEXT:
            return None
        s = str(v.value)
        if s not in values:
            values.append(s)
    return values or [""]


def _strpred_colname(pred: E.StrPred) -> str:
    c = pred.col
    return c.col.name if isinstance(c, E.TextExpr) else c.name


def _codes_for_strpred(pred: E.StrPred, dicts: dict) -> np.ndarray:
    name = _strpred_colname(pred)
    d = dicts.get(name)
    if d is None:
        raise E.ExprError(f"no dictionary for TEXT column {name!r}")
    transform = (pred.col.apply if isinstance(pred.col, E.TextExpr)
                 else (lambda s: s))
    k = pred.kind
    if k in ("eq", "ne", "in", "not_in"):
        wanted = set(pred.patterns)
        test = lambda s: transform(s) in wanted
    elif k in ("like", "not_like"):
        rx = like_to_regex(pred.patterns[0])
        test = lambda s: rx.match(transform(s)) is not None
    elif k in ("lt", "le", "gt", "ge"):
        p = pred.patterns[0]
        base = {"lt": lambda s: s < p, "le": lambda s: s <= p,
                "gt": lambda s: s > p, "ge": lambda s: s >= p}[k]
        test = lambda s: base(transform(s))
    else:
        raise E.ExprError(f"unknown string predicate {k}")
    return d.codes_matching(test)


def _membership(arr, codes: np.ndarray):
    """Integer membership test: small sets unroll to compares, larger
    sets use a sorted search.  Comparison values take the tensor's own
    dtype (dictionary codes are int32, InList values may be int64)."""
    if len(codes) == 0:
        return torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
    if len(codes) <= 16:
        m = arr == torch.full((), int(codes[0]), dtype=arr.dtype,
                              device=arr.device)
        for c in codes[1:]:
            m = m | (arr == torch.full((), int(c), dtype=arr.dtype,
                                       device=arr.device))
        return m
    sorted_codes = device_const(np.sort(codes), arr.device).to(arr.dtype)
    pos = torch.searchsorted(sorted_codes, arr)
    pos = torch.clamp(pos, 0, len(codes) - 1)
    return sorted_codes[pos] == arr


# days-since-epoch -> civil date fields (branchless; Howard Hinnant's
# civil_from_days, public-domain algorithm)
def _civil(days):
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097

    def fd(x, d):
        return torch.div(x, d, rounding_mode="floor")
    yoe = fd(doe - fd(doe, 1460) + fd(doe, 36524) - fd(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fd(yoe, 4) - fd(yoe, 100))
    mp = fd(5 * doy + 2, 153)
    day = doy - fd(153 * mp + 2, 5) + 1
    month = mp + torch.where(mp < 10, 3, -9)
    year = y + (month <= 2).to(torch.int64)
    return year, month, day


NullFn = Optional[Callable[[Arrays], object]]


def _text_hash_fn(e: E.Expr, dicts: dict,
                  device) -> Callable[[Arrays], object]:
    """Codes -> stable string-hash translation for one TEXT column
    (possibly transformed): cross-dictionary comparisons happen in the
    shared 64-bit hash space (utils/hashing.hash_string)."""
    from ..utils.hashing import hash_string
    if isinstance(e, E.TextExpr):
        name, transform = e.col.name, e.apply
    elif isinstance(e, E.Col):
        name, transform = e.name, (lambda s: s)
    else:
        raise E.ExprError(
            "text comparison requires plain text columns")
    d = dicts.get(name)
    if d is None:
        raise E.ExprError(f"no dictionary for TEXT column {name!r}")
    lut = np.asarray([hash_string(transform(v)) for v in d.values]
                     or [0], dtype=np.uint64).view(np.int64)
    jl = device_const(lut, device)
    return lambda cols, _j=jl, _n=name: \
        _j[torch.clamp(cols[_n], 0, _j.shape[0] - 1).to(torch.int64)]


def _union(*nfs: NullFn) -> NullFn:
    """OR-combine null masks (strict-operator propagation)."""
    live = [f for f in nfs if f is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def nf(env, _fs=tuple(live)):
        m = _fs[0](env)
        for f in _fs[1:]:
            m = m | f(env)
        return m
    return nf


def _truth(vf, nf: NullFn):
    """SQL three-valued 'is true' / 'is false' closures from a pair."""
    if nf is None:
        return vf, (lambda env, _v=vf: ~_v(env))
    t = lambda env, _v=vf, _n=nf: _v(env) & ~_n(env)
    f = lambda env, _v=vf, _n=nf: ~_v(env) & ~_n(env)
    return t, f


_CMP = {"=": torch.eq, "<>": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def compile_pair(e: E.Expr, dicts: dict, nullable=frozenset(),
                 device="cpu"):
    """Return (value_fn, null_fn|None).  `nullable` is the set of column
    names that carry a null mask in the eval env (under NULLKEY+name);
    null_fn None proves the result is never NULL.  Constants are made on
    `device`, the device of the columns."""

    def const(v, dt):
        if isinstance(v, torch.Tensor):
            # a masked literal: a 0-d view of the program's literal
            # buffer (exec/fused.py), at the literal's storage dtype
            return v.to(dt)
        return torch.full((), v, dtype=dt, device=device)

    def c(x: E.Expr):
        if isinstance(x, E.Col):
            name = x.name
            vf = lambda cols: cols[name]
            if name in nullable:
                key = NULLKEY + name
                return vf, (lambda env: env[key])
            return vf, None

        if isinstance(x, E.Lit):
            t = x.lit_type
            if t.kind == TypeKind.TEXT and x.value is not None:
                # a projected TEXT literal: code 0 under a one-entry
                # dictionary (the executor's _dict_for_expr supplies it)
                k = const(0, torch.int32)
                return (lambda cols: k), None
            dt = dev_dtype(t)
            if x.value is None:
                z, tr = const(0, dt), const(True, torch.bool)
                return (lambda cols: z), (lambda env: tr)
            v = const(x.value, dt)
            return (lambda cols: v), None

        if isinstance(x, E.Arith):
            lt, rt = x.left.type, x.right.type
            (lf, ln), (rf, rn) = c(x.left), c(x.right)
            nf = _union(ln, rn)
            if x.type.kind == TypeKind.FLOAT64:
                lf2 = (lambda cols, _f=lf, _s=lt.scale:
                       _f(cols).to(device_float()) / 10 ** _s) \
                    if lt.kind == TypeKind.DECIMAL else \
                    (lambda cols, _f=lf: _f(cols).to(device_float()))
                rf2 = (lambda cols, _f=rf, _s=rt.scale:
                       _f(cols).to(device_float()) / 10 ** _s) \
                    if rt.kind == TypeKind.DECIMAL else \
                    (lambda cols, _f=rf: _f(cols).to(device_float()))
                op = x.op
                return {"+": lambda cols: lf2(cols) + rf2(cols),
                        "-": lambda cols: lf2(cols) - rf2(cols),
                        "*": lambda cols: lf2(cols) * rf2(cols),
                        "/": lambda cols: lf2(cols) / rf2(cols)}[op], nf
            if x.type.kind == TypeKind.DECIMAL and x.op in "+-":
                s = x.type.scale
                lf = _rescale(lf, lt.scale if lt.kind == TypeKind.DECIMAL
                              else 0, s) if lt.kind == TypeKind.DECIMAL \
                    else _rescale(lambda cols, _f=lf:
                                  _f(cols).to(torch.int64), 0, s)
                rf = _rescale(rf, rt.scale if rt.kind == TypeKind.DECIMAL
                              else 0, s) if rt.kind == TypeKind.DECIMAL \
                    else _rescale(lambda cols, _f=rf:
                                  _f(cols).to(torch.int64), 0, s)
            if x.op == "+":
                return (lambda cols: torch.add(*_common(lf(cols),
                                                        rf(cols)))), nf
            if x.op == "-":
                return (lambda cols: torch.sub(*_common(lf(cols),
                                                        rf(cols)))), nf
            if x.op == "*":
                return (lambda cols: (lf(cols).to(torch.int64)
                                      * rf(cols).to(torch.int64))
                        if x.type.kind == TypeKind.DECIMAL
                        else torch.mul(*_common(lf(cols), rf(cols)))), nf
            if x.op == "%":
                # SQL modulo truncates toward zero (sign of the dividend)
                return (lambda cols: torch.fmod(*_common(lf(cols),
                                                         rf(cols)))), nf
            raise E.ExprError(f"bad arith op {x.op}")

        if isinstance(x, E.Neg):
            f, nf = c(x.arg)
            return (lambda cols: -f(cols)), nf

        if isinstance(x, E.Cmp):
            lt, rt = x.left.type, x.right.type
            if lt.kind == TypeKind.TEXT and rt.kind == TypeKind.TEXT:
                # text-to-text equality: dictionary codes live in
                # different code spaces per column — compare stable
                # string hashes instead
                if x.op not in ("=", "<>"):
                    raise E.ExprError(
                        "text-to-text ordering comparison unsupported "
                        "(dictionary orders are column-local)")
                lh = _text_hash_fn(x.left, dicts, device)
                rh = _text_hash_fn(x.right, dicts, device)
                _, lnn = c(x.left)
                _, rnn = c(x.right)
                if x.op == "=":
                    vf = lambda cols: lh(cols) == rh(cols)
                else:
                    vf = lambda cols: lh(cols) != rh(cols)
                return vf, _union(lnn, rnn)
            (lf, ln), (rf, rn) = c(x.left), c(x.right)
            # align decimal scales / promote to float if either is float
            if TypeKind.FLOAT64 in (lt.kind, rt.kind):
                def mk(f, t):
                    if t.kind == TypeKind.DECIMAL:
                        return lambda cols: (f(cols).to(device_float())
                                             / 10 ** t.scale)
                    return lambda cols: f(cols).to(device_float())
                lf, rf = mk(lf, lt), mk(rf, rt)
            elif TypeKind.DECIMAL in (lt.kind, rt.kind):
                s = max(lt.scale, rt.scale)
                lf = _rescale(lf, lt.scale, s)
                rf = _rescale(rf, rt.scale, s)
            cmp = _CMP[x.op]
            vf = lambda cols: cmp(*_common(lf(cols), rf(cols)))
            return vf, _union(ln, rn)

        if isinstance(x, E.BoolOp):
            pairs = [c(a) for a in x.args]
            if all(n is None for _, n in pairs):
                fs = [v for v, _ in pairs]
                if x.op == "and":
                    def andf(cols, _fs=tuple(fs)):
                        m = _fs[0](cols)
                        for f in _fs[1:]:
                            m = m & f(cols)
                        return m
                    return andf, None

                def orf(cols, _fs=tuple(fs)):
                    m = _fs[0](cols)
                    for f in _fs[1:]:
                        m = m | f(cols)
                    return m
                return orf, None
            # Kleene 3VL: value = "definitely true", false = "definitely
            # false", null = neither
            truths = [_truth(v, n) for v, n in pairs]
            if x.op == "and":
                def tf(env, _ts=tuple(t for t, _ in truths)):
                    m = _ts[0](env)
                    for t in _ts[1:]:
                        m = m & t(env)
                    return m

                def ff(env, _fs=tuple(f for _, f in truths)):
                    m = _fs[0](env)
                    for f in _fs[1:]:
                        m = m | f(env)
                    return m
            else:
                def tf(env, _ts=tuple(t for t, _ in truths)):
                    m = _ts[0](env)
                    for t in _ts[1:]:
                        m = m | t(env)
                    return m

                def ff(env, _fs=tuple(f for _, f in truths)):
                    m = _fs[0](env)
                    for f in _fs[1:]:
                        m = m & f(env)
                    return m
            return tf, (lambda env: ~tf(env) & ~ff(env))

        if isinstance(x, E.Not):
            vf, nf = c(x.arg)
            if nf is None:
                return (lambda cols: ~vf(cols)), None
            t, f = _truth(vf, nf)
            return f, nf  # NOT null is null; NOT true=false, NOT false=true

        if isinstance(x, E.IsNull):
            _, nf = c(x.arg)
            if nf is None:
                k = const(bool(x.negated), torch.bool)  # never null
                return (lambda cols: k), None
            if x.negated:
                return (lambda env: ~nf(env)), None
            return nf, None

        if isinstance(x, E.Coalesce):
            pairs = [c(a) for a in x.args]
            dt = dev_dtype(x.type)
            first_vf = pairs[0][0]
            if pairs[0][1] is None:
                return (lambda cols: first_vf(cols).to(dt)), None

            def vf(env, _pairs=tuple(pairs)):
                out = _pairs[-1][0](env).to(dt)
                for v, n in reversed(_pairs[:-1]):
                    if n is None:
                        out = v(env).to(dt)
                    else:
                        out = _where(n(env), out, v(env).to(dt))
                return out
            nfs = [n for _, n in pairs]
            if any(n is None for n in nfs):
                return vf, None  # some arg can never be null

            def nf(env, _ns=tuple(nfs)):
                m = _ns[0](env)
                for n in _ns[1:]:
                    m = m & n(env)
                return m
            return vf, nf

        if isinstance(x, E.NullIf):
            lf, ln = c(x.left)
            # the equality goes through Cmp so decimal scales/floats align
            eqt, _ = _truth(*c(E.Cmp("=", x.left, x.right)))
            nf = (lambda env: ln(env) | eqt(env)) if ln is not None \
                else eqt
            return lf, nf

        if isinstance(x, E.Case) and x.type.kind == TypeKind.TEXT:
            # TEXT result: branches must be literals; the value is a code
            # into the shared branch dictionary (case_text_dict)
            values = case_text_dict(x)
            if values is None:
                raise E.ExprError(
                    "CASE over TEXT requires literal THEN/ELSE values")
            index = {s: i for i, s in enumerate(values)}

            def code_of(v):
                return 0 if v.value is None else index[str(v.value)]

            cond_truths = [_truth(*c(w[0]))[0] for w in x.whens]
            when_codes = [const(code_of(v), torch.int32)
                          for _, v in x.whens]
            else_code = const(code_of(x.else_) if x.else_ is not None
                              else 0, torch.int32)

            def casef(env):
                out = else_code
                for cond, wc in zip(reversed(cond_truths),
                                    reversed(when_codes)):
                    out = torch.where(cond(env), wc, out)
                return out

            null_whens = [v.value is None for _, v in x.whens]
            else_is_null = x.else_ is None or x.else_.value is None
            if not any(null_whens) and not else_is_null:
                return casef, None
            when_nulls = [const(b, torch.bool) for b in null_whens]
            else_null = const(else_is_null, torch.bool)

            def case_nf(env):
                out = else_null
                for cond, bn in zip(reversed(cond_truths),
                                    reversed(when_nulls)):
                    out = torch.where(cond(env), bn, out)
                return out
            return casef, case_nf

        if isinstance(x, E.Case):
            cond_truths = [_truth(*c(w[0]))[0] for w in x.whens]
            val_pairs = [c(w[1]) for w in x.whens]
            else_pair = c(x.else_) if x.else_ is not None else None
            dt = dev_dtype(x.type)
            zero = const(0, dt)
            t_, f_ = const(True, torch.bool), const(False, torch.bool)

            def casef(env):
                out = else_pair[0](env) if else_pair is not None else zero
                for cond, (val, _) in zip(reversed(cond_truths),
                                          reversed(val_pairs)):
                    out = _where(cond(env), val(env), out)
                return out

            # null when the chosen branch is null; a missing ELSE is NULL
            branch_nulls = [n for _, n in val_pairs]
            else_null = None if else_pair is None else else_pair[1]
            if all(n is None for n in branch_nulls) and (
                    x.else_ is not None and else_null is None):
                return casef, None

            def case_nf(env):
                if x.else_ is None:
                    out = t_
                elif else_null is None:
                    out = f_
                else:
                    out = else_null(env)
                for cond, bn in zip(reversed(cond_truths),
                                    reversed(branch_nulls)):
                    bval = f_ if bn is None else bn(env)
                    out = torch.where(cond(env), bval, out)
                return out
            return casef, case_nf

        if isinstance(x, E.InList):
            f, nf = c(x.arg)
            vals = np.asarray(x.values)
            return (lambda cols: _membership(f(cols), vals)), nf

        if isinstance(x, E.StrPred):
            codes = _codes_for_strpred(x, dicts)
            name = _strpred_colname(x)
            neg = x.kind in ("ne", "not_like", "not_in")
            nf = (lambda env, _k=NULLKEY + name: env[_k]) \
                if name in nullable else None
            if neg:
                return (lambda cols: ~_membership(cols[name], codes)), nf
            return (lambda cols: _membership(cols[name], codes)), nf

        if isinstance(x, E.TextExpr):
            # codes pass through; only the decode dictionary changes
            name = x.col.name
            nf = (lambda env, _k=NULLKEY + name: env[_k]) \
                if name in nullable else None
            return (lambda cols: cols[name]), nf

        if isinstance(x, E.DistExpr):
            # K15 distances in f32, widened as the reference widens them;
            # the query vector is a device constant (never an upload under
            # capture), so each query vector is its own program
            from ..ops.ann import distances
            name = x.col.name
            qc = device_const(np.asarray(x.query, dtype=np.float32), device)
            metric = x.metric
            return (lambda cols: distances(cols[name], qc, metric)
                    .to(device_float())), None

        if isinstance(x, E.Extract):
            f, nf = c(x.arg)
            idx = {"year": 0, "month": 1, "day": 2}[x.field]
            return (lambda cols: _civil(f(cols))[idx].to(torch.int32)), nf

        if isinstance(x, E.Cast):
            f, nf = c(x.arg)
            src, dst = x.arg.type, x.to
            if src.kind == TypeKind.NULL:
                z, tr = const(0, dev_dtype(dst)), const(True, torch.bool)
                return (lambda cols: z), (lambda env: tr)
            if dst.kind == TypeKind.FLOAT64 and src.kind == TypeKind.DECIMAL:
                return (lambda cols: f(cols).to(device_float())
                        / 10 ** src.scale), nf
            if dst.kind == TypeKind.DECIMAL and src.kind == TypeKind.DECIMAL:
                return _rescale(f, src.scale, dst.scale), nf
            if dst.kind in (TypeKind.INT32, TypeKind.INT64) \
                    and src.kind == TypeKind.DECIMAL:
                dt = dev_dtype(dst)
                sc = 10 ** src.scale
                return (lambda cols: _floordiv(f(cols), sc).to(dt)), nf
            if dst.kind == TypeKind.DECIMAL and src.kind in (
                    TypeKind.INT32, TypeKind.INT64):
                return (lambda cols: f(cols).to(torch.int64)
                        * 10 ** dst.scale), nf
            if dst.kind == TypeKind.DECIMAL and src.kind == TypeKind.FLOAT64:
                return (lambda cols: torch.round(
                    f(cols) * 10 ** dst.scale).to(torch.int64)), nf
            dt = dev_dtype(dst)
            return (lambda cols: f(cols).to(dt)), nf

        raise E.ExprError(f"cannot compile {type(x).__name__}")

    return c(e)


def compile_expr(e: E.Expr, dicts: dict, nullable=frozenset(),
                 device="cpu") -> Callable[[Arrays], object]:
    """Value-only compile: fn(columns) -> tensor (garbage at null
    positions — pair with compile_pair's null_fn when they matter)."""
    return compile_pair(e, dicts, nullable, device)[0]


def compile_pred(e: E.Expr, dicts: dict, nullable=frozenset(),
                 device="cpu") -> Callable[[Arrays], object]:
    """Predicate compile under SQL 3VL: fn(env) -> bool tensor that is
    True exactly where the qual is definitely true (NULL counts as
    false)."""
    vf, nf = compile_pair(e, dicts, nullable, device)
    if nf is None:
        return vf
    return _truth(vf, nf)[0]


# ---------------------------------------------------------------------------
# register-program emitter for the fused scan-aggregate kernel
# ---------------------------------------------------------------------------

class Declined(Exception):
    """The fragment is outside what the fused scan-aggregate kernel
    evaluates; it runs the generic program instead."""


_F64, _I64, _I32, _BOOL = "f64", "i64", "i32", "bool"


def _reg_dtype(t) -> str:
    """The torch dtype compile_pair gives a value of SqlType `t`, as one
    of the emitter's register types."""
    dt = dev_dtype(t)
    if dt == torch.float64:
        return _F64
    if dt == torch.bool:
        return _BOOL
    if dt == torch.int64:
        return _I64
    if dt == torch.int32:
        return _I32
    raise Declined(f"value dtype {dt}")


def _promote(a: str, b: str) -> str:
    """torch.promote_types over the register types."""
    order = {_BOOL: 0, _I32: 1, _I64: 2, _F64: 3}
    return a if order[a] >= order[b] else b


class _Emitter:
    """Emits register instructions (ops/kernels.py FUSED_OPS) that
    compute what compile_pair computes, operation for operation:
    the same promotions, decimal rescales, int32 wrap-around and float
    conversions.  `col_slot(name)` -> column slot or None; `lit_slot(name)`
    -> literal column or None (a masked literal or numeric parameter)."""

    def __init__(self, col_slot, lit_slot, dicts):
        from ..ops.kernels import FUSED_LIMITS, FUSED_OPS
        self.ops = FUSED_OPS
        self.limits = FUSED_LIMITS
        self.col_slot = col_slot
        self.lit_slot = lit_slot
        self.dicts = dicts
        self.instrs: list = []
        self.consts: list = []
        self.nregs = 0
        self.cols: dict = {}      # slot -> register (shared part)
        self.in_qual = False

    def _reg(self) -> int:
        r = self.nregs
        self.nregs += 1
        if self.nregs > self.limits["regs"]:
            raise Declined("too many registers")
        return r

    def op(self, name: str, a: int = 0, b: int = 0) -> int:
        if len(self.instrs) >= self.limits["instrs"]:
            raise Declined("program too long")
        d = self._reg()
        self.instrs.append((self.ops[name], d, a, b))
        return d

    def const(self, v: int) -> int:
        v = int(v)
        if v not in self.consts:
            if len(self.consts) >= self.limits["consts"]:
                raise Declined("too many constants")
            self.consts.append(v)
        return self.op("CONST", self.consts.index(v))

    def fconst(self, v: float) -> int:
        bits = int(np.asarray([float(v)], np.float64).view(np.int64)[0])
        return self.const(bits)

    def load_col(self, slot: int) -> int:
        if slot not in self.cols:
            if self.in_qual:
                raise Declined("a column first read by the qual")
            self.cols[slot] = self.op("LDCOL", slot)
        return self.cols[slot]

    # -- conversions ---------------------------------------------------
    def to(self, reg: int, src: str, dst: str) -> int:
        if src == dst:
            return reg
        if dst == _F64:
            return self.op("I2F", reg)
        if src == _F64:
            raise Declined("float to int conversion")
        if dst == _I32 and src == _I64:
            return self.op("WRAP32", reg)
        return reg     # bool / int32 widen: the word already holds it

    def wrap(self, reg: int, dt: str) -> int:
        return self.op("WRAP32", reg) if dt == _I32 else reg

    def scaled_f(self, reg: int, dt: str, scale: int) -> int:
        """f(cols).to(f64) / 10 ** scale (compile_pair's decimal to
        float), the division skipped for scale 0 as x / 1 is x."""
        f = self.to(reg, dt, _F64)
        return self.op("FDIV", f, self.fconst(10 ** scale)) if scale else f

    def rescale(self, reg: int, dt: str, frm: int, to: int):
        """_rescale: multiply up (_wide: at least int64) or floor-divide
        down."""
        if frm == to:
            return reg, dt
        if dt == _F64:
            raise Declined("rescale of a float")
        if to > frm:
            return self.op("IMUL", reg, self.const(10 ** (to - frm))), _I64
        return self.op("IDIV", reg, self.const(10 ** (frm - to))), _I64

    # -- expressions ---------------------------------------------------
    def expr(self, x):
        """(register, register type) of x's value; x is never NULL."""
        if isinstance(x, E.Col):
            lit = self.lit_slot(x.name)
            if lit is not None:
                return self.op("LDLIT", lit), _reg_dtype(x.type)
            slot = self.col_slot(x.name)
            if slot is None:
                raise Declined(f"column {x.name}")
            return self.load_col(slot), _reg_dtype(x.type)
        if isinstance(x, E.Lit):
            if x.value is None or isinstance(x.value, torch.Tensor) \
                    or x.lit_type.kind == TypeKind.TEXT:
                raise Declined("literal")
            dt = _reg_dtype(x.lit_type)
            if dt == _F64:
                return self.fconst(x.value), dt
            return self.const(int(x.value)), dt
        if isinstance(x, E.Arith):
            return self.arith(x)
        if isinstance(x, E.Neg):
            r, dt = self.expr(x.arg)
            if dt == _F64:
                return self.op("FNEG", r), dt
            return self.wrap(self.op("INEG", r), dt), dt
        if isinstance(x, E.Cmp):
            return self.cmp(x), _BOOL
        if isinstance(x, E.BoolOp):
            regs = [self.pred(a) for a in x.args]
            acc = regs[0]
            for r in regs[1:]:
                acc = self.op("AND" if x.op == "and" else "OR", acc, r)
            return acc, _BOOL
        if isinstance(x, E.Not):
            return self.op("NOT", self.pred(x.arg)), _BOOL
        if isinstance(x, E.IsNull):
            return self.const(1 if x.negated else 0), _BOOL
        if isinstance(x, E.InList):
            r, dt = self.expr(x.arg)
            if dt == _F64 or not 0 < len(x.values) <= 16:
                raise Declined("IN list")
            acc = None
            for v in x.values:
                m = self.op("IEQ", r, self.const(int(v)))
                acc = m if acc is None else self.op("OR", acc, m)
            return acc, _BOOL
        if isinstance(x, E.StrPred):
            codes = _codes_for_strpred(x, self.dicts)
            r, _dt = self.expr(x.col if isinstance(x.col, E.Col) else
                               x.col.col)
            if len(codes) > 16:
                raise Declined("string predicate over many codes")
            if len(codes) == 0:
                acc = self.const(0)
            else:
                acc = None
                for c in codes:
                    m = self.op("IEQ", r, self.const(int(c)))
                    acc = m if acc is None else self.op("OR", acc, m)
            if x.kind in ("ne", "not_like", "not_in"):
                acc = self.op("NOT", acc)
            return acc, _BOOL
        if isinstance(x, E.Cast):
            return self.cast(x)
        raise Declined(type(x).__name__)

    def pred(self, x) -> int:
        r, dt = self.expr(x)
        if dt != _BOOL:
            raise Declined("non-boolean predicate")
        return r

    def arith(self, x):
        lt, rt = x.left.type, x.right.type
        (lr, ld), (rr, rd) = self.expr(x.left), self.expr(x.right)
        if x.type.kind == TypeKind.FLOAT64:
            lf = self.scaled_f(lr, ld, lt.scale) \
                if lt.kind == TypeKind.DECIMAL else self.to(lr, ld, _F64)
            rf = self.scaled_f(rr, rd, rt.scale) \
                if rt.kind == TypeKind.DECIMAL else self.to(rr, rd, _F64)
            name = {"+": "FADD", "-": "FSUB", "*": "FMUL",
                    "/": "FDIV"}.get(x.op)
            if name is None:
                raise Declined(f"float {x.op}")
            return self.op(name, lf, rf), _F64
        if x.type.kind == TypeKind.DECIMAL and x.op in "+-":
            s = x.type.scale
            if lt.kind == TypeKind.DECIMAL:
                lr, ld = self.rescale(lr, ld, lt.scale, s)
            else:
                lr, ld = self.rescale(self.to(lr, ld, _I64), _I64, 0, s)
            if rt.kind == TypeKind.DECIMAL:
                rr, rd = self.rescale(rr, rd, rt.scale, s)
            else:
                rr, rd = self.rescale(self.to(rr, rd, _I64), _I64, 0, s)
        if x.op == "*" and x.type.kind == TypeKind.DECIMAL:
            return self.op("IMUL", self.to(lr, ld, _I64),
                           self.to(rr, rd, _I64)), _I64
        name = {"+": "ADD", "-": "SUB", "*": "MUL", "%": "MOD"}.get(x.op)
        if name is None:
            raise Declined(f"integer {x.op}")
        dt = _promote(ld, rd)
        if dt == _BOOL:
            raise Declined("boolean arithmetic")
        a, b = self.to(lr, ld, dt), self.to(rr, rd, dt)
        if dt == _F64:
            if name == "MOD":
                raise Declined("float %")
            return self.op("F" + name, a, b), dt
        return self.wrap(self.op("I" + name, a, b), dt), dt

    def cmp(self, x) -> int:
        lt, rt = x.left.type, x.right.type
        if lt.kind == TypeKind.TEXT or rt.kind == TypeKind.TEXT:
            raise Declined("text comparison")
        (lr, ld), (rr, rd) = self.expr(x.left), self.expr(x.right)
        if TypeKind.FLOAT64 in (lt.kind, rt.kind):
            lr = self.scaled_f(lr, ld, lt.scale) \
                if lt.kind == TypeKind.DECIMAL else self.to(lr, ld, _F64)
            rr = self.scaled_f(rr, rd, rt.scale) \
                if rt.kind == TypeKind.DECIMAL else self.to(rr, rd, _F64)
            ld = rd = _F64
        elif TypeKind.DECIMAL in (lt.kind, rt.kind):
            s = max(lt.scale, rt.scale)
            lr, ld = self.rescale(lr, ld, lt.scale, s)
            rr, rd = self.rescale(rr, rd, rt.scale, s)
        dt = _promote(ld, rd)
        a, b = self.to(lr, ld, dt), self.to(rr, rd, dt)
        name = {"=": "EQ", "<>": "NE", "<": "LT", "<=": "LE", ">": "GT",
                ">=": "GE"}[x.op]
        return self.op(("F" if dt == _F64 else "I") + name, a, b)

    def cast(self, x):
        r, dt = self.expr(x.arg)
        src, dst = x.arg.type, x.to
        if dst.kind == TypeKind.FLOAT64 and src.kind == TypeKind.DECIMAL:
            return self.scaled_f(r, dt, src.scale), _F64
        if dst.kind == TypeKind.DECIMAL and src.kind == TypeKind.DECIMAL:
            return self.rescale(r, dt, src.scale, dst.scale)
        if dst.kind in (TypeKind.INT32, TypeKind.INT64) \
                and src.kind == TypeKind.DECIMAL:
            q, _ = self.rescale(r, dt, src.scale, 0)
            out = _reg_dtype(dst)
            return self.to(q, _I64, out), out
        if dst.kind == TypeKind.DECIMAL and src.kind in (TypeKind.INT32,
                                                         TypeKind.INT64):
            return self.op("IMUL", self.to(r, dt, _I64),
                           self.const(10 ** dst.scale)), _I64
        if dst.kind == TypeKind.DECIMAL and src.kind == TypeKind.FLOAT64:
            raise Declined("float to decimal cast")
        out = _reg_dtype(dst)
        return self.to(r, dt, out), out


def emit_scan_agg(quals, aggs, groups, col_slot, lit_slot, mv_slots,
                  dicts, n_lits: int):
    """The fused scan-aggregate program of one fragment, or None.

    quals: predicates over the scan's columns and literal columns (ANDed);
    aggs: (kind, expr or None) per kernel aggregate, kind one of
    ops/kernels.py FUSED_SUM / FUSED_COUNT / FUSED_MIN / FUSED_MAX (the
    expression never NULL, never f64); groups: (expr, domain) per dense
    group key, the group id built as K4's dense path builds it
    (gid * dom + clamp(code, 0, dom - 1)); mv_slots: the column slots of
    xmin_ts, xmax_ts, xmin_txid, xmax_txid.  Declines (None) anything
    compile_pair would evaluate another way: NULLs, text comparisons,
    CASE, EXTRACT, integer division, float aggregates."""
    from ..ops.kernels import ScanAggSpec
    em = _Emitter(col_slot, lit_slot, dicts)
    try:
        mv = tuple(em.load_col(s) for s in mv_slots)
        agg_regs = []
        for kind, e in aggs:
            if e is None:
                agg_regs.append((kind, 0))
                continue
            r, dt = em.expr(e)
            if dt == _F64:
                raise Declined("float aggregate input")
            agg_regs.append((kind, r))
        gid, n_groups = -1, 1
        for e, dom in groups:
            r, dt = em.expr(e)
            if dt == _F64:
                raise Declined("float group key")
            code = em.op("IMAX", r, em.const(0))
            code = em.op("IMIN", code, em.const(dom - 1))
            gid = code if gid < 0 else \
                em.op("IADD", em.op("IMUL", gid, em.const(dom)), code)
            n_groups *= dom
        # every column the quals read loads once, in the shared part
        for q in quals:
            for x in E.walk(q):
                if isinstance(x, E.Col) and lit_slot(x.name) is None:
                    slot = col_slot(x.name)
                    if slot is None:
                        raise Declined(f"column {x.name}")
                    em.load_col(slot)
        n_shared = len(em.instrs)
        em.in_qual = True
        qual = -1
        for q in quals:
            r = em.pred(q)
            qual = r if qual < 0 else em.op("AND", qual, r)
    except (Declined, E.ExprError):
        return None
    return ScanAggSpec(instrs=em.instrs, n_shared=n_shared,
                       consts=em.consts, aggs=agg_regs, gid_reg=gid,
                       qual_reg=qual, n_groups=n_groups, mv_regs=mv,
                       n_lits=n_lits)
