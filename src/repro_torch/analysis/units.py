"""Pass 3 — unit-consistency checker (UNT rules).

The copy of ``repro.analysis.units`` for the port, run over the
port's measurement stack (``DEFAULT_SUBDIRS``): dimensional analysis
driven by the repo's suffix convention:

  ``_w``/``_watts`` = W,  ``_j``/``_joules`` = J,  ``_s`` = seconds,
  ``_ms`` = milliseconds,  ``_hz``/``_qps`` = 1/s,
  ``_wh``/``_kwh`` = scale-tagged joules (3.6e3 / 3.6e6 J),
  ``_gco2`` = grams of CO2,  ``_gco2_per_kwh`` = grid carbon intensity,
  ``x_per_y`` = unit(x)/unit(y)  (counts are dimensionless).

Units propagate through assignments, arithmetic, calls, subscripts
(``per_node_j[n]`` is J; ``d["watts"]`` is W), and common numpy
reductions; ``np.trapezoid(watts, t_s)`` multiplies into J.  Bare
numeric literals are unit-chameleons (``max(dur_s, 1e-9)`` is fine);
an unknown operand silences the check rather than guessing.

Rules:

- UNT001  incompatible units combined with ``+``/``-``/comparison —
          ``watts + joules``, ``t_ms >= start_s``.  Seconds and
          milliseconds share a dimension but not a scale; adding them
          without the ``1e3`` is flagged.
- UNT002  assignment target's suffix disagrees with the expression —
          the classic ``energy_j = np.mean(watts)`` (missing the
          ``* dt_s``).
- UNT003  keyword argument unit disagrees with the parameter suffix —
          ``measure(duration_s=window_ms)``.
- UNT004  return expression unit disagrees with the function's own
          name suffix — ``def delay_s(...)`` returning watts.

W = J/s is built in: ``energy_j / window_s`` is W, ``watts * dt_s``
is J, ``1.0 / sample_hz`` is s.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import re
from typing import Optional

from repro_torch.analysis.findings import Finding, relpath
from repro_torch.analysis.purity import iter_py_files

# --- the unit algebra ----------------------------------------------------
# Base dimensions: J (energy), s (time), g (grams of CO2).
# W = J * s^-1; Wh and kWh are scale-tagged joules (3.6e3 / 3.6e6),
# gCO2/kWh a scale-tagged g/J.  ``scale`` disambiguates the variants
# within one dimension family (None = unknown/any scale, the state
# after multiplying by a bare literal).


@dataclasses.dataclass(frozen=True)
class Unit:
    dims: tuple                     # sorted ((dim, power), ...)
    scale: Optional[float] = 1.0    # None = any scale

    def __str__(self):
        if not self.dims:
            return "dimensionless"
        num = "*".join(f"{d}^{p}" if p != 1 else d
                       for d, p in self.dims if p > 0)
        den = "*".join(f"{d}^{-p}" if p != -1 else d
                       for d, p in self.dims if p < 0)
        s = num or "1"
        if den:
            s += f"/{den}"
        if self.scale not in (1.0, None):
            if self.dims == (("s", 1),):
                s = {1e-3: "ms"}.get(self.scale, s)
            elif self.dims == (("J", 1),):
                s = {3.6e3: "Wh", 3.6e6: "kWh"}.get(self.scale, s)
            elif self.dims == (("J", -1), ("g", 1)):
                s = {1.0 / 3.6e6: "g/kWh"}.get(self.scale, s)
        return s


def _mk(dims: dict, scale: Optional[float] = 1.0) -> Unit:
    return Unit(tuple(sorted((d, p) for d, p in dims.items() if p)),
                scale)


DIMENSIONLESS = _mk({})
J = _mk({"J": 1})
S = _mk({"s": 1})
MS = _mk({"s": 1}, scale=1e-3)
W = _mk({"J": 1, "s": -1})
HZ = _mk({"s": -1})
PER_J = _mk({"J": -1})
WH = _mk({"J": 1}, scale=3.6e3)
KWH = _mk({"J": 1}, scale=3.6e6)
GCO2 = _mk({"g": 1})
GCO2_PER_KWH = _mk({"J": -1, "g": 1}, scale=1.0 / 3.6e6)

# dimension families with more than one scale variant in the suffix
# table (s vs ms; J vs Wh vs kWh; their inverses; g/J vs g/kWh; plain
# g vs the g*(1/3.6e6) that J * gCO2/kWh leaves behind): multiplying
# by a bare literal inside one of these forgets the scale (the literal
# IS the conversion), and products keep their computed scale instead
# of canonicalizing to 1.0
_SCALED_DIMS = {
    (("s", 1),),
    (("J", 1),),
    (("J", -1),),
    (("J", -1), ("g", 1)),
    (("g", 1),),
}

# ANY: bare numeric literal / unit-preserving unknown — compatible with
# everything, disappears in products.
ANY = None


def _combine(a: Unit, b: Unit, sign: int) -> Optional[Unit]:
    """Product (sign=1) / quotient (sign=-1) of two known units."""
    dims = dict(a.dims)
    for d, p in b.dims:
        dims[d] = dims.get(d, 0) + sign * p
    if a.scale is None or b.scale is None:
        scale = None
    else:
        scale = a.scale * (b.scale if sign > 0 else 1.0 / b.scale)
        # canonicalize: scale only matters inside the multi-variant
        # dimension families (time, energy, carbon intensity)
        if tuple(sorted((d, p) for d, p in dims.items() if p)) not in \
                _SCALED_DIMS:
            scale = 1.0 if scale else scale
        elif math.isclose(scale, 1.0):
            # kWh * (g/kWh) computes 3.6e6 * (1/3.6e6): snap the
            # float dust so round-trip conversions land on canonical
            scale = 1.0
    return _mk(dims, scale)


def compatible(a: Unit, b: Unit) -> bool:
    if a.dims != b.dims:
        return False
    if a.scale is None or b.scale is None:
        return True
    return math.isclose(a.scale, b.scale)


# --- suffix convention ---------------------------------------------------

_UNIT_WORDS = {
    "w": W, "watts": W, "watt": W,
    "j": J, "joule": J, "joules": J,
    "s": S, "sec": S, "secs": S, "second": S, "seconds": S,
    "ms": MS,
    "hz": HZ, "qps": HZ,
    "wh": WH, "kwh": KWH,
    "gco2": GCO2,
}
# count-like words are dimensionless numerators/denominators in
# ``x_per_y`` names
_COUNT_WORDS = {
    "tok", "toks", "token", "tokens", "sample", "samples", "query",
    "queries", "inference", "inferences", "goodput", "request",
    "requests", "step", "steps", "chunk", "chunks", "meter",
    "replica", "replicas", "arrival", "arrivals",
}
# bare names that ARE a unit (no suffix needed); single letters are
# excluded — a local named ``w`` or ``s`` is usually an array or a
# loop variable, not a power reading
_BARE_NAMES = {k: v for k, v in _UNIT_WORDS.items() if len(k) >= 2}
_PER_RE = re.compile(r"^(?P<num>.+?)_per_(?P<den>[a-z]+)$")


def _word_unit(word: str) -> Optional[Unit]:
    if word in _UNIT_WORDS:
        return _UNIT_WORDS[word]
    if word in _COUNT_WORDS:
        return DIMENSIONLESS
    return None


def unit_of_name(name: str) -> Optional[Unit]:
    """Unit implied by an identifier, else None."""
    name = name.lower()
    m = _PER_RE.match(name)
    if m:
        den = _word_unit(m.group("den"))
        num_name = m.group("num")
        num = _word_unit(num_name) or unit_of_name(num_name) \
            or (DIMENSIONLESS if num_name.split("_")[-1] in _COUNT_WORDS
                else None)
        if den is None:
            return None
        if num is None:
            return None
        return _combine(num, den, -1)
    if name in _BARE_NAMES:
        return _BARE_NAMES[name]
    tail = name.rsplit("_", 1)[-1]
    if "_" in name and tail in _UNIT_WORDS:
        return _UNIT_WORDS[tail]
    return None


# --- expression inference ------------------------------------------------

# unit-preserving calls: result takes the (joined) unit of the args
_PRESERVE_1 = {
    "float", "int", "abs", "round", "sorted", "sum",
    "asarray", "array", "mean", "median", "std", "cumsum",
    "sort", "diff", "ravel", "flatten", "squeeze", "atleast_1d",
    "concatenate", "stack", "hstack", "vstack", "repeat", "tile",
    "maximum", "minimum", "max", "min", "amax", "amin", "nanmax",
    "nanmin", "nanmean", "nansum", "percentile", "nan_percentile",
    "full_like", "zeros_like", "ones_like", "broadcast_to", "copy",
    "ascontiguousarray", "arange", "linspace", "interp_x",
}
# calls whose result multiplies arg0 x arg1 (integration)
_INTEGRATE = {"trapezoid", "trapz", "_trapz", "simpson"}


class _Scope:
    def __init__(self, checker: "_UnitChecker", qual: str):
        self.checker = checker
        self.qual = qual
        self.env: dict[str, Optional[Unit]] = {}


class _UnitChecker:
    def __init__(self, path: str, src: str, root: str):
        self.path = relpath(path, root)
        self.tree = ast.parse(src)
        self.findings: list[Finding] = []

    def emit(self, rule: str, node: ast.AST, message: str, hint: str,
             qual: str):
        self.findings.append(Finding(
            rule, "error", self.path, getattr(node, "lineno", 1),
            message, hint, obj=qual))

    def run(self) -> list[Finding]:
        scope = _Scope(self, "<module>")
        self._exec_block(self.tree.body, scope)
        return self.findings

    # --- statement walk ----------------------------------------------
    def _exec_block(self, stmts, scope: _Scope):
        for stmt in stmts:
            self._exec_stmt(stmt, scope)

    def _exec_stmt(self, stmt, scope: _Scope):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._exec_function(stmt, scope)
            return
        if isinstance(stmt, ast.ClassDef):
            inner = _Scope(self.checker_self(), _join(scope.qual,
                                                      stmt.name))
            self._exec_block(stmt.body, inner)
            return
        if isinstance(stmt, ast.Assign):
            u = self.infer(stmt.value, scope)
            for target in stmt.targets:
                self._bind_target(target, u, stmt.value, scope)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            u = self.infer(stmt.value, scope)
            self._bind_target(stmt.target, u, stmt.value, scope)
            return
        if isinstance(stmt, ast.AugAssign):
            target_u = self._target_unit(stmt.target, scope)
            value_u = self.infer(stmt.value, scope)
            if isinstance(stmt.op, (ast.Add, ast.Sub)):
                target_u, value_u = _strip(target_u), _strip(value_u)
                if (target_u is not None and value_u is not None
                        and not compatible(target_u, value_u)):
                    self.emit(
                        "UNT002", stmt,
                        f"'{_src(stmt.target)} "
                        f"{'+=' if isinstance(stmt.op, ast.Add) else '-='} "
                        f"{_src(stmt.value)}' accumulates {value_u} "
                        f"into a {target_u} variable",
                        _conv_hint(target_u, value_u), scope.qual)
            elif isinstance(stmt.op, (ast.Mult, ast.Div)):
                if target_u is not None and value_u is not None:
                    new = _combine(target_u, value_u,
                                   1 if isinstance(stmt.op, ast.Mult)
                                   else -1)
                    self._bind_target(stmt.target, new, stmt.value,
                                      scope, check=True)
            # walk the value for nested call checks
            self.infer(stmt.value, scope)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            u = _strip(self.infer(stmt.value, scope))
            fn_unit = unit_of_name(scope.qual.rsplit(".", 1)[-1])
            if (fn_unit is not None and u is not None
                    and not compatible(fn_unit, u)):
                self.emit(
                    "UNT004", stmt,
                    f"'return {_src(stmt.value)}' returns {u} from "
                    f"{scope.qual!r}, whose name promises {fn_unit}",
                    "rename the function or convert the value",
                    scope.qual)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self.infer(stmt.test, scope)
            self._exec_block(stmt.body, scope)
            self._exec_block(stmt.orelse, scope)
            return
        if isinstance(stmt, ast.For):
            self.infer(stmt.iter, scope)
            # bind loop targets from the iterable where recognizable
            it_u = self.infer(stmt.iter, scope)
            for n in ast.walk(stmt.target):
                if isinstance(n, ast.Name):
                    scope.env[n.id] = it_u if it_u is not None else None
            self._exec_block(stmt.body, scope)
            self._exec_block(stmt.orelse, scope)
            return
        if isinstance(stmt, (ast.With,)):
            for item in stmt.items:
                self.infer(item.context_expr, scope)
            self._exec_block(stmt.body, scope)
            return
        if isinstance(stmt, ast.Try):
            self._exec_block(stmt.body, scope)
            for h in stmt.handlers:
                self._exec_block(h.body, scope)
            self._exec_block(stmt.orelse, scope)
            self._exec_block(stmt.finalbody, scope)
            return
        if isinstance(stmt, ast.Expr):
            self.infer(stmt.value, scope)
            return
        # other statements: walk for calls so UNT003 still fires
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self.infer(node, scope)

    def checker_self(self):
        return self

    def _exec_function(self, fn, scope: _Scope):
        inner = _Scope(self, _join(scope.qual, fn.name))
        for p in (fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs):
            inner.env[p.arg] = unit_of_name(p.arg)
        self._exec_block(fn.body, inner)

    # --- binding ------------------------------------------------------
    def _target_unit(self, target, scope: _Scope) -> Optional[Unit]:
        if isinstance(target, ast.Name):
            if target.id in scope.env:
                return scope.env[target.id]
            return unit_of_name(target.id)
        if isinstance(target, ast.Attribute):
            return unit_of_name(target.attr)
        if isinstance(target, ast.Subscript):
            return self._subscript_unit(target, scope)
        return None

    def _bind_target(self, target, u: Optional[Unit], value_node,
                     scope: _Scope, check: bool = True):
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, None, value_node, scope,
                                  check=False)
            return
        declared = None
        if isinstance(target, ast.Name):
            declared = unit_of_name(target.id)
        elif isinstance(target, ast.Attribute):
            declared = unit_of_name(target.attr)
        elif isinstance(target, ast.Subscript):
            declared = self._subscript_unit(target, scope)
        su = _strip(u)       # literals are unit-chameleons: QPS = 4.0
        if (check and declared is not None and su is not None
                and not compatible(declared, su)):
            self.emit(
                "UNT002", target,
                f"'{_src(target)} = {_src(value_node)}' assigns "
                f"{su} to a name declaring {declared}",
                _conv_hint(declared, su), scope.qual)
        if isinstance(target, ast.Name):
            # the declared suffix is the intent; a known expression
            # unit refines unknown, never overrides the suffix
            scope.env[target.id] = declared or u

    # --- expression units --------------------------------------------
    def infer(self, node, scope: _Scope) -> Optional[Unit]:
        if node is None:
            return None
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) and not \
                    isinstance(node.value, bool):
                return ANY_LITERAL
            return None
        if isinstance(node, ast.Name):
            # a bound-but-unknown local shadows the bare-name table
            # (``for s in samples`` makes ``s`` a sample, not seconds)
            if node.id in scope.env:
                return scope.env[node.id]
            return unit_of_name(node.id)
        if isinstance(node, ast.Attribute):
            self.infer(node.value, scope)
            return unit_of_name(node.attr)
        if isinstance(node, ast.Subscript):
            self.infer(node.slice, scope)
            return self._subscript_unit(node, scope)
        if isinstance(node, ast.BinOp):
            return self._infer_binop(node, scope)
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand, scope)
        if isinstance(node, ast.Compare):
            left_u = self.infer(node.left, scope)
            prev, prev_node = left_u, node.left
            for comparator in node.comparators:
                cu = self.infer(comparator, scope)
                pu, cu2 = _strip(prev), _strip(cu)
                if (pu is not None and cu2 is not None
                        and not compatible(pu, cu2)):
                    self.emit(
                        "UNT001", node,
                        f"comparison '{_src(prev_node)} ... "
                        f"{_src(comparator)}' compares {pu} against "
                        f"{cu2}", _conv_hint(pu, cu2), scope.qual)
                prev, prev_node = cu, comparator
            return None
        if isinstance(node, ast.BoolOp):
            units = [self.infer(v, scope) for v in node.values]
            known = [u for u in units if _strip(u) is not None]
            return known[0] if known else None
        if isinstance(node, ast.IfExp):
            self.infer(node.test, scope)
            a = self.infer(node.body, scope)
            b = self.infer(node.orelse, scope)
            return _join_units(a, b)
        if isinstance(node, ast.Call):
            return self._infer_call(node, scope)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp,
                             ast.SetComp)):
            sub = _Scope(self, scope.qual)
            sub.env.update(scope.env)
            for gen in node.generators:
                it_u = self.infer(gen.iter, sub)
                for n in ast.walk(gen.target):
                    if isinstance(n, ast.Name):
                        sub.env[n.id] = it_u
            return self.infer(node.elt, sub)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for el in node.elts:
                self.infer(el, scope)
            return None
        if isinstance(node, ast.Dict):
            for v in node.values:
                if v is not None:
                    self.infer(v, scope)
            return None
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.infer(v.value, scope)
            return None
        if isinstance(node, ast.Starred):
            return self.infer(node.value, scope)
        if isinstance(node, ast.Lambda):
            return None
        return None

    def _subscript_unit(self, node: ast.Subscript,
                        scope: _Scope) -> Optional[Unit]:
        # container suffix wins: per_node_j[name] is J, t_ms[sel] is ms
        base = None
        if isinstance(node.value, ast.Name):
            if node.value.id in scope.env:
                base = scope.env[node.value.id]
            else:
                base = unit_of_name(node.value.id)
        elif isinstance(node.value, ast.Attribute):
            base = unit_of_name(node.value.attr)
        if base is not None:
            return base
        # string-literal key with a unit name: d["watts"], d["t_ms"]
        key = node.slice
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            return unit_of_name(key.value)
        return None

    def _infer_binop(self, node: ast.BinOp, scope) -> Optional[Unit]:
        a = self.infer(node.left, scope)
        b = self.infer(node.right, scope)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            sa, sb = _strip(a), _strip(b)
            if sa is not None and sb is not None \
                    and not compatible(sa, sb):
                self.emit(
                    "UNT001", node,
                    f"'{_src(node)}' "
                    f"{'adds' if isinstance(node.op, ast.Add) else 'subtracts'}"
                    f" {sb} "
                    f"{'to' if isinstance(node.op, ast.Add) else 'from'}"
                    f" {sa}", _conv_hint(sa, sb), scope.qual)
                return None
            return _join_units(a, b)
        if isinstance(node.op, ast.Mult):
            return self._product(a, b, 1)
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            return self._product(a, b, -1)
        if isinstance(node.op, ast.Mod):
            return _join_units(a, b)
        return None

    @staticmethod
    def _product(a, b, sign) -> Optional[Unit]:
        # literal x unit keeps the dimension but forgets the scale
        # (the 1e3 in ``t_s * 1e3`` IS a scale conversion; same for
        # the 3.6e6 in ``energy_j / 3.6e6``)
        if a is ANY_LITERAL and b is ANY_LITERAL:
            return ANY_LITERAL
        if a is ANY_LITERAL and b is not None:
            u = b if sign > 0 else _combine(DIMENSIONLESS, b, -1)
            return dataclasses.replace(u, scale=None) \
                if u.dims in _SCALED_DIMS or b.dims in _SCALED_DIMS \
                else u
        if b is ANY_LITERAL and a is not None:
            return dataclasses.replace(a, scale=None) \
                if a.dims in _SCALED_DIMS else a
        if a is None or b is None:
            return None
        return _combine(a, b, sign)

    def _infer_call(self, node: ast.Call, scope) -> Optional[Unit]:
        arg_units = [self.infer(a, scope) for a in node.args]
        # UNT003: keyword arguments with unit-suffixed parameter names
        for kw in node.keywords:
            ku = self.infer(kw.value, scope)
            if kw.arg is None:
                continue
            declared = unit_of_name(kw.arg)
            sku = _strip(ku)
            if (declared is not None and sku is not None
                    and not compatible(declared, sku)):
                self.emit(
                    "UNT003", kw.value,
                    f"argument '{kw.arg}={_src(kw.value)}' passes "
                    f"{sku} where the parameter declares {declared}",
                    _conv_hint(declared, sku), scope.qual)
        fname = _call_name(node)
        leaf = fname.split(".")[-1] if fname else ""
        # a call to a unit-suffixed function returns that unit
        named = unit_of_name(leaf)
        if named is not None:
            return named
        if leaf in ("len", "argmax", "argmin", "argsort", "ord",
                    "count_nonzero"):
            return DIMENSIONLESS
        if leaf in _INTEGRATE and len(arg_units) >= 2:
            return self._product(arg_units[0], arg_units[1], 1)
        if leaf == "where" and len(arg_units) == 3:
            return _join_units(arg_units[1], arg_units[2])
        if leaf in ("interp",) and len(arg_units) >= 3:
            return arg_units[2]
        if leaf in ("full",) and len(arg_units) >= 2:
            return arg_units[1]
        if leaf in ("clip",) and arg_units:
            return arg_units[0]
        if leaf in _PRESERVE_1 and arg_units:
            known = [u for u in arg_units if u is not None]
            if not known:
                return None
            out = known[0]
            for u in known[1:]:
                out = _join_units(out, u)
            return out
        return None


ANY_LITERAL = Unit((("<any>", 1),), None)


def _strip(u: Optional[Unit]) -> Optional[Unit]:
    """ANY_LITERAL and unknown both mean 'do not check'."""
    if u is None or u is ANY_LITERAL or u.dims == (("<any>", 1),):
        return None
    return u


def _join_units(a: Optional[Unit], b: Optional[Unit]) -> Optional[Unit]:
    sa, sb = _strip(a), _strip(b)
    if sa is None:
        return sb if sb is not None else (
            ANY_LITERAL if a is ANY_LITERAL and b is ANY_LITERAL
            else None)
    if sb is None:
        return sa
    if not compatible(sa, sb):
        return None
    if sa.scale is None:
        return sb
    return sa


def _join(qual: str, name: str) -> str:
    return f"{qual}.{name}" if qual and qual != "<module>" else name


def _call_name(node: ast.Call) -> str:
    f = node.func
    parts = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _src(node) -> str:
    try:
        s = ast.unparse(node)
    except Exception:                                # noqa: BLE001
        return "<expr>"
    return s if len(s) <= 60 else s[:57] + "..."


def _conv_hint(want: Unit, got: Unit) -> str:
    pairs = {
        (str(W), str(J)): "divide the energy by the window seconds",
        (str(J), str(W)): "multiply the power by the interval "
                          "seconds (energy = integral of power)",
        (str(S), str(MS)): "divide the milliseconds by 1e3",
        (str(MS), str(S)): "multiply the seconds by 1e3",
        (str(J), str(KWH)): "multiply the kilowatt-hours by 3.6e6",
        (str(KWH), str(J)): "divide the joules by 3.6e6",
        (str(J), str(WH)): "multiply the watt-hours by 3.6e3",
        (str(WH), str(J)): "divide the joules by 3.6e3",
    }
    return pairs.get((str(want), str(got)),
                     f"expected {want}, got {got} — convert "
                     f"explicitly or fix the name")


DEFAULT_SUBDIRS = ("src/repro_torch/power", "src/repro_torch/core",
                   "src/repro_torch/harness", "src/repro_torch/fleet",
                   "src/repro_torch/benchmarks")


def run(root: str, subdirs: tuple = DEFAULT_SUBDIRS) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_py_files(root, subdirs):
        src = open(path).read()
        try:
            checker = _UnitChecker(path, src, root)
        except SyntaxError as e:
            findings.append(Finding(
                "UNT001", "error", relpath(path, root), e.lineno or 1,
                f"file does not parse: {e.msg}", "fix the syntax",
                obj=path))
            continue
        findings.extend(checker.run())
    return findings
