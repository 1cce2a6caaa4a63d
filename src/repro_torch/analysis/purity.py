"""Pass 2 — device-body purity linter (PUR rules): an AST pass over
``src/repro_torch/``.

The port's counterpart of ``repro.analysis.purity``.  The reference
checks what ``jax.jit`` traces (``_impl`` bodies); the port runs
eagerly, and what it promises instead is a declared list of **device
bodies** (``DEVICE_BODIES``): the engine's chunk functions, which make
no host read, so that a chunk costs one host copy and a CUDA graph can
capture it (ROADMAP A.3).  An override of one in a subclass, and a
function nested in one, is a device body too.  ``REFERENCE_BODIES``
maps every ``_impl`` body of the reference's serving engines to its
port counterpart: a device body, or exempt with its reason.

- PUR001  a host read in a device body: ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``int()`` /
          ``float()`` / ``bool()`` of a tensor, a synchronize, an op
          that sizes its output from the data (``nonzero``, ``unique``,
          ``masked_select``, ``bincount``), numpy calls, wall-clock
          reads.  Each stalls the host until the device drains.
- PUR002  a Python ``if`` / ``while`` / ``assert`` (or a conditional
          expression) on a tensor in a device body: a host read, and a
          branch a captured graph would freeze.
- PUR003  a shared mutable instance as a dataclass field default, as
          in the reference.
- PUR004  a random draw without ``generator=`` (``torch.rand*``,
          ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
          ``normal``, ``Tensor.uniform_`` / ``normal_`` / ...), anywhere
          in the port: the port's rule is an explicit, seeded generator
          (the reference's rule, a PRNG key drawn twice, has no
          counterpart in PyTorch's stateful generators).
- PUR005  a Python side effect in a device body that a CUDA-graph
          replay would skip: an assignment to ``self.*``, a ``global``
          or ``nonlocal`` write, ``.append`` (``extend``, ``insert``,
          ``add``) on a list the body did not make, ``count_launch``,
          ``print`` and logging.  The reference's rule (side effects in
          a ``fori_loop`` body, run once at trace time) is the same
          hazard: code that runs when the body is recorded, not when it
          is replayed.

"Tensor" is a flow-insensitive taint: a device body's parameters (but
``self`` and those annotated ``int``, ``bool``, ``float`` or ``str``),
``torch.*`` results, and every name assigned from a tainted expression;
``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``len()``,
``isinstance()`` and ``is None`` tests shield a reference.  A device
body's callees (the model's ``decode_step`` and below) are not walked:
the run-time tests that make every host read raise cover them.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding, relpath

ENGINE = "src/repro_torch/serving/engine.py"

# (path, qualified name): the functions the port promises run on the
# device without a host read
DEVICE_BODIES = (
    (ENGINE, "ContinuousBatchingEngine._decode_chunk"),
    (ENGINE, "ContinuousBatchingEngine._spec_chunk"),
    (ENGINE, "ContinuousBatchingEngine._prefill_chunk"),
)

# every jit-compiled ``_impl`` body of the reference's engines:
# (reference path:qualname, port path:qualname, "device" or "exempt: ...")
REFERENCE_BODIES = (
    ("src/repro/serving/engine.py:ServeEngine._prefill_impl",
     f"{ENGINE}:ServeEngine.run_batch",
     "exempt: the batch engine prefills eagerly in run_batch"),
    ("src/repro/serving/engine.py:ServeEngine._decode_impl",
     f"{ENGINE}:ServeEngine.run_batch",
     "exempt: run_batch reads each step's tokens to the host by design"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._prefill_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._prefill_slot",
     "exempt: eager slot prefill: takes host ints (slot, budget, pages) "
     "by design"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._extend_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._extend_slot",
     "exempt: eager prefix-hit admission: host slot, pages and start"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._prefill_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._prefill_chunk", "device"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._install_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._install_slot",
     "exempt: disaggregated install: scatters a worker's blocks at host "
     "page numbers"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._decode_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._decode_chunk", "device"),
    ("src/repro/serving/engine.py:"
     "ContinuousBatchingEngine._spec_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._spec_chunk", "device"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._prefill_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._prefill_slot",
     "exempt: inherited; eager slot prefill, as above"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._extend_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._extend_slot",
     "exempt: inherited; eager prefix-hit admission, as above"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._prefill_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._prefill_chunk",
     "device"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._install_slot_impl",
     f"{ENGINE}:ContinuousBatchingEngine._install_slot",
     "exempt: inherited; disaggregated install, as above"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._decode_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._decode_chunk", "device"),
    ("src/repro/serving/sharded.py:"
     "ShardedContinuousBatchingEngine._spec_chunk_impl",
     f"{ENGINE}:ContinuousBatchingEngine._spec_chunk", "device"),
    ("src/repro/serving/disagg.py:PrefillWorker._prefill_impl",
     "src/repro_torch/serving/disagg.py:PrefillWorker.prefill",
     "exempt: a worker thread's eager prefill, handed to the host's "
     "queue"),
)

# numpy attributes that are dtypes and constants, not computations
_NP_STATIC_OK = {"dtype", "float32", "int32", "int64", "bfloat16",
                 "float64", "int8", "bool_", "newaxis", "pi", "inf", "nan"}
# attribute reads on a tensor that are host metadata, not values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "layout"}
# methods of a tensor that return host metadata
_STATIC_METHODS = {"size", "dim", "numel", "stride", "data_ptr",
                   "element_size", "is_contiguous", "get_device"}
_SHIELD_CALLS = {"len", "isinstance", "getattr", "hasattr", "type", "id"}
_TIME_FUNCS = {"time", "monotonic", "perf_counter", "process_time",
               "time_ns", "perf_counter_ns", "monotonic_ns"}
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
# ops whose output size depends on the data: the host waits for it
_DATA_SIZED = {"nonzero", "unique", "unique_consecutive", "masked_select",
               "bincount", "argwhere"}
# torch functions that return host values
_TORCH_HOST = {"is_grad_enabled", "is_tensor", "is_floating_point",
               "get_default_dtype", "device", "dtype", "Size", "finfo",
               "iinfo", "no_grad", "inference_mode"}
_HOST_ANNOTATIONS = {"int", "bool", "float", "str"}
_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
          "bernoulli", "normal", "poisson", "rand_like", "randn_like",
          "randint_like"}
_DRAW_METHODS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                 "random_", "geometric_", "log_normal_", "cauchy_",
                 "multinomial", "bernoulli"}
_LIST_MUTATORS = {"append", "extend", "insert", "add"}
_LOG_NAMES = {"logging", "logger", "log", "LOG", "_log", "_logger"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}
# immutable builtins allowed as dataclass defaults when called
_IMMUTABLE_CALLS = {"tuple", "frozenset", "field", "MISSING"}


def _numpy_aliases(tree: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("numpy", "numpy.ma"):
                    names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy":
                for a in node.names:
                    names.add(a.asname or a.name)
    return names


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for an Attribute/Name chain, '' else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _walk_own(fn):
    """A function's own nodes, not those of nested function and class
    scopes (the scope walk visits those with their own context)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _names(target) -> list[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


class _Taint:
    """Which names of a device body may hold a tensor."""

    def __init__(self, fn, tainted: frozenset):
        self.names = set(tainted)
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            ann = p.annotation
            if p.arg in ("self", "cls"):
                continue
            if isinstance(ann, ast.Name) and ann.id in _HOST_ANNOTATIONS:
                continue
            self.names.add(p.arg)
        for p in (a.vararg, a.kwarg):
            if p is not None:
                self.names.add(p.arg)
        # two passes reach names assigned from later-assigned names
        for _ in range(2):
            for node in _walk_own(fn):
                self._assign(node)

    def _assign(self, node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._bind(t, node.value)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if node.value is not None:
                self._bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.comprehension)):
            self._bind(node.target, node.iter)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            self._bind(node.optional_vars, node.context_expr)

    def _bind(self, target, value):
        if (isinstance(target, (ast.Tuple, ast.List))
                and isinstance(value, (ast.Tuple, ast.List))
                and len(target.elts) == len(value.elts)):
            for t, v in zip(target.elts, value.elts):
                self._bind(t, v)
            return
        if self.live(value):
            self.names.update(_names(target) if not isinstance(
                target, (ast.Attribute, ast.Subscript)) else [])

    def live(self, expr) -> list:
        """The tainted references of ``expr`` that no metadata read
        shields, and its ``torch.*`` calls (tensors)."""
        if expr is None:
            return []
        shielded = set()
        hits = []
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                shielded.update(id(n) for n in ast.walk(sub.value))
            elif isinstance(sub, ast.Call):
                name = _dotted(sub.func)
                if name in _SHIELD_CALLS or (
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _STATIC_METHODS):
                    shielded.update(id(n) for n in ast.walk(sub))
                elif (name.startswith("torch.")
                      and name.split(".")[-1] not in _TORCH_HOST
                      and not name.startswith("torch.cuda.")):
                    hits.append(sub)
            elif (isinstance(sub, ast.Compare)
                  and all(isinstance(op, (ast.Is, ast.IsNot))
                          for op in sub.ops)):
                shielded.update(id(n) for n in ast.walk(sub))
        for sub in ast.walk(expr):
            if (isinstance(sub, ast.Name) and sub.id in self.names
                    and id(sub) not in shielded):
                hits.append(sub)
        return [h for h in hits if id(h) not in shielded]


class _FileChecker:
    def __init__(self, path: str, src: str, root: str,
                 frozen_classes: set[str], device_methods: dict):
        self.path = relpath(path, root)
        self.tree = ast.parse(src)
        self.np_names = _numpy_aliases(self.tree)
        self.frozen = frozen_classes
        self.device_methods = device_methods
        self.findings: list[Finding] = []

    def emit(self, rule: str, node: ast.AST, message: str, hint: str,
             obj: str):
        self.findings.append(Finding(
            rule, "error", self.path, getattr(node, "lineno", 1),
            message, hint, obj=obj))

    def run(self) -> list[Finding]:
        self._walk_scope(self.tree, None, "", "")
        self._check_draws()
        return self.findings

    def _walk_scope(self, node, device, qual: str, cls: str):
        """``device``: the taint of the enclosing device body (None
        outside one)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_qual = f"{qual}.{child.name}" if qual else child.name
                taint = None
                if device is not None:
                    taint = _Taint(child, frozenset(device.names))
                elif child.name in self.device_methods.get(cls, ()):
                    taint = _Taint(child, frozenset())
                if taint is not None:
                    self._check_device_fn(child, child_qual, taint)
                self._walk_scope(child, taint, child_qual, "")
            elif isinstance(child, ast.ClassDef):
                child_qual = f"{qual}.{child.name}" if qual else child.name
                self._check_dataclass(child, child_qual)
                self._walk_scope(child, device, child_qual, child.name)
            else:
                self._walk_scope(child, device, qual, cls)

    # --- PUR001 / PUR002 / PUR005 ---------------------------------------
    def _check_device_fn(self, fn, qual: str, taint: _Taint):
        local = set()
        for node in _walk_own(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                for t in getattr(node, "targets", None) or [node.target]:
                    local.update(_names(t))
            elif isinstance(node, (ast.For, ast.comprehension)):
                local.update(_names(node.target))
        for node in _walk_own(fn):
            if isinstance(node, ast.Call):
                self._check_host_read(node, taint, qual)
                self._check_call_effect(node, local, qual)
            elif isinstance(node, (ast.If, ast.IfExp, ast.While,
                                   ast.Assert)):
                self._check_branch(node, taint, qual)
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                self.emit("PUR005", node,
                          f"'{type(node).__name__.lower()}' write in "
                          f"device body {qual!r}: a CUDA-graph replay "
                          f"skips it",
                          "return the value, or thread it through the "
                          "state the body returns", qual)
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                targets = getattr(node, "targets", None) or [node.target]
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        op = ("+=" if isinstance(node, ast.AugAssign)
                              and isinstance(node.op, ast.Add) else "=")
                        self.emit(
                            "PUR005", node,
                            f"'self.{t.attr} {op} ...' in device body "
                            f"{qual!r}: a Python side effect that a "
                            f"CUDA-graph replay skips",
                            "count per replay outside the captured body "
                            "(ROADMAP A.3), or keep the count on the "
                            "device", qual)

    def _check_host_read(self, call: ast.Call, taint: _Taint, qual: str):
        name = _dotted(call.func)
        head = name.split(".")[0] if name else ""
        leaf = call.func.attr if isinstance(call.func, ast.Attribute) \
            else name
        if isinstance(call.func, ast.Attribute):
            if leaf in _HOST_READS and not call.args:
                self.emit("PUR001", call,
                          f"'.{leaf}()' in device body {qual!r} reads a "
                          f"tensor to the host",
                          "keep the value on the device (torch.where, "
                          "argmax) and read the chunk's result once, "
                          "after the body returns", qual)
                return
            if leaf == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in [*call.args,
                              *(k.value for k in call.keywords)]):
                self.emit("PUR001", call,
                          f"'.to(\"cpu\")' in device body {qual!r} copies "
                          f"a tensor to the host",
                          "read the chunk's result once, after the body "
                          "returns", qual)
                return
            if leaf == "synchronize":
                self.emit("PUR001", call,
                          f"'{name or leaf}()' in device body {qual!r} "
                          f"waits for the device",
                          "synchronize outside the body", qual)
                return
            if leaf in _DATA_SIZED and (head == "torch"
                                        or taint.live(call.func.value)):
                self.emit("PUR001", call,
                          f"'{leaf}' in device body {qual!r} sizes its "
                          f"output from the data: the host waits for it",
                          "use a fixed-size form (scatter_add_ counts, "
                          "torch.where with a mask)", qual)
                return
            if head in self.np_names and leaf not in _NP_STATIC_OK:
                self.emit("PUR001", call,
                          f"numpy call '{name}(...)' in device body "
                          f"{qual!r} runs on the host",
                          "use torch on the body's device", qual)
                return
            if head == "time" and leaf in _TIME_FUNCS:
                self.emit("PUR001", call,
                          f"wall-clock read '{name}()' in device body "
                          f"{qual!r}",
                          "time outside the body (a replay never reads "
                          "the clock)", qual)
                return
        if (isinstance(call.func, ast.Name)
                and call.func.id in ("float", "int", "bool")
                and len(call.args) == 1 and taint.live(call.args[0])):
            self.emit("PUR001", call,
                      f"'{call.func.id}({ast.unparse(call.args[0])})' on a "
                      f"tensor in device body {qual!r} reads it to the "
                      f"host",
                      "keep it a 0-d tensor, or pass a host int in", qual)

    def _check_branch(self, node, taint: _Taint, qual: str):
        live = [h for h in taint.live(node.test)
                if isinstance(h, ast.Name)]
        calls = [h for h in taint.live(node.test)
                 if not isinstance(h, ast.Name)]
        if not live and not calls:
            return
        what = live[0].id if live else ast.unparse(calls[0])[:40]
        kind = {ast.While: "while", ast.Assert: "assert"}.get(
            type(node), "if")
        self.emit("PUR002", node,
                  f"Python '{kind}' on tensor {what!r} in device body "
                  f"{qual!r}",
                  "branch on the device (torch.where) or on a host value "
                  "passed in; a captured graph freezes the branch", qual)

    def _check_call_effect(self, call: ast.Call, local: set, qual: str):
        name = _dotted(call.func)
        leaf = name.split(".")[-1] if name else ""
        if name == "print":
            self.emit("PUR005", call,
                      f"'print' in device body {qual!r} runs once at "
                      f"capture, never on a replay",
                      "print from the host loop", qual)
        elif leaf == "count_launch":
            self.emit("PUR005", call,
                      f"'count_launch' in device body {qual!r}: a replay "
                      f"launches without counting",
                      "count a replay's launches once per replay", qual)
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in _LOG_METHODS
              and _dotted(call.func.value) in _LOG_NAMES):
            self.emit("PUR005", call,
                      f"logging call '{name}' in device body {qual!r} "
                      f"runs once at capture",
                      "log from the host loop", qual)
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in _LIST_MUTATORS
              and not (isinstance(call.func.value, ast.Name)
                       and call.func.value.id in local)):
            self.emit("PUR005", call,
                      f"'.{call.func.attr}' on "
                      f"'{ast.unparse(call.func.value)}' in device body "
                      f"{qual!r} mutates host state once at capture",
                      "return the value in the body's outputs", qual)

    # --- PUR003 ---------------------------------------------------------
    def _check_dataclass(self, cls: ast.ClassDef, qual: str):
        is_dc = False
        for dec in cls.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _dotted(target).split(".")[-1] == "dataclass":
                is_dc = True
        if not is_dc:
            return
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and stmt.value is not None):
                continue
            v = stmt.value
            field = (stmt.target.id
                     if isinstance(stmt.target, ast.Name) else "?")
            if isinstance(v, (ast.List, ast.Dict, ast.Set)):
                self.emit("PUR003", stmt,
                          f"dataclass {qual!r} field {field!r} has a "
                          f"mutable literal default",
                          "use field(default_factory=list/dict/set)",
                          qual)
                continue
            if not isinstance(v, ast.Call):
                continue
            name = _dotted(v.func)
            leaf = name.split(".")[-1]
            if leaf in _IMMUTABLE_CALLS or leaf in self.frozen:
                continue
            if not leaf[:1].isupper() and leaf not in ("list", "dict",
                                                       "set"):
                continue            # lower-case calls: not constructors
            self.emit(
                "PUR003", stmt,
                f"dataclass {qual!r} field {field!r} defaults to a "
                f"shared '{name}()' instance — every instance "
                f"constructed without an explicit value aliases ONE "
                f"object, so a mutation leaks across instances",
                f"use field(default_factory={name}) (or freeze "
                f"{leaf})", qual)

    # --- PUR004 ---------------------------------------------------------
    def _check_draws(self):
        scopes = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                for sub in ast.walk(node):
                    scopes.setdefault(id(sub), node.name)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            leaf = name.split(".")[-1] if name else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else "")
            draw = ((name.startswith("torch.") and leaf in _DRAWS
                     and name.count(".") == 1)
                    or (isinstance(node.func, ast.Attribute)
                        and leaf in _DRAW_METHODS
                        and not name.startswith("np.")
                        and name.split(".")[0] not in self.np_names))
            if not draw or any(k.arg == "generator"
                               for k in node.keywords):
                continue
            where = scopes.get(id(node), "<module>")
            self.emit("PUR004", node,
                      f"random draw '{ast.unparse(node.func)}' in "
                      f"{where!r} without generator=: it draws from "
                      f"the process's global generator",
                      "pass an explicit, seeded torch.Generator "
                      "(generator=...)", where)


def _collect_classes(trees: dict) -> tuple[set, dict]:
    """(frozen dataclass names, {class: set of device-body methods}):
    the declared device bodies' classes and, by simple base name, every
    subclass of one, with the same method names."""
    frozen: set[str] = set()
    bases: dict[str, set] = {}
    for tree in trees.values():
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases.setdefault(node.name, set()).update(
                _dotted(b).split(".")[-1] for b in node.bases)
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                if _dotted(dec.func).split(".")[-1] != "dataclass":
                    continue
                for kw in dec.keywords:
                    if (kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True):
                        frozen.add(node.name)
    methods: dict[str, set] = {}
    for _, qual in DEVICE_BODIES:
        cls, name = qual.rsplit(".", 1)
        methods.setdefault(cls, set()).add(name)
    changed = True
    while changed:
        changed = False
        for cls, bs in bases.items():
            inherited = set().union(*(methods.get(b, set()) for b in bs))
            if not inherited <= methods.get(cls, set()):
                methods.setdefault(cls, set()).update(inherited)
                changed = True
    return frozen, methods


def iter_py_files(root: str, subdirs: tuple) -> list[str]:
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in sorted(filenames):
                if f.endswith(".py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


def run(root: str, subdirs: tuple = ("src/repro_torch",)
        ) -> list[Finding]:
    findings: list[Finding] = []
    trees, sources = {}, {}
    for path in iter_py_files(root, subdirs):
        src = open(path).read()
        try:
            trees[path] = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                "PUR001", "error", relpath(path, root), e.lineno or 1,
                f"file does not parse: {e.msg}", "fix the syntax error",
                obj=os.path.basename(path)))
            continue
        sources[path] = src
    frozen, methods = _collect_classes(trees)
    for path, src in sources.items():
        findings.extend(_FileChecker(path, src, root, frozen,
                                     methods).run())
    return findings
