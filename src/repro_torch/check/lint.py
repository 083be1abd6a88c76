"""Layer 3: the hazard lint, stdlib-``ast`` rules over ``src/repro_torch``.

Port of the JAX package's ``check/lint.py``: the same rule ids, the same
:class:`~repro_torch.check.Finding` shape (``tenant`` the file path,
``layer`` the line number) and the same suppression syntax.  Each rule
encodes a bug class that costs the served path; the lint keeps it out.

Rules:

* ``lint.host-sync``: ``.item()``, ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``np.asarray``/``np.array`` and ``synchronize()``
  (``torch.cuda.synchronize``, a stream's or an event's) inside the
  serving hot paths: the intra-module call graphs rooted at
  ``ContinuousBatcher.step``/``.tick`` and ``EdgeEngine.infer``.  Each
  blocks the host on the card mid-request.
* ``lint.traced-if``: the port's ``jax.jit`` is CUDA-graph capture
  (``kernels/graph.py``: ``StepGraph``, ``GraphedForward``).  A function a
  module passes to one of them, resolved to a ``def`` of the same module
  (a module function, a function defined in the calling function, or a
  method of the calling class through ``self``), and its intra-module
  callees are captured code: a Python ``if`` on one of their tensor
  parameters reads the tensor back to the host, which raises under
  capture.  The tensor parameters are those annotated ``Tensor``, and
  every unannotated parameter of the captured function itself (a graph
  feeds it tensors only).
* ``lint.time-in-jit``: ``time.time()``/``perf_counter()``/... or a host
  RNG (``random.*``, ``np.random.*``) in that captured code: the value is
  taken once, at capture, and every replay repeats it.
* ``lint.unlocked-shared-state``: a class that guards itself with
  ``self._lock`` mutating an attribute outside a ``with self._lock:``
  block in a non-``__init__`` method.
* ``lint.dict-order-hash``: ``json.dumps`` without ``sort_keys=True`` in a
  function that also hashes (``hashlib``): plan-cache keys must not depend
  on dict insertion order.

Per-line suppression::

    finite = torch.isfinite(last).all(dim=-1).cpu()  # repro: check-ok(lint.host-sync)

A bare ``# repro: check-ok`` suppresses every rule on that line.  The
suppression must name the finding's rule (or be bare) and sit on the
flagged line itself.
"""

from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.check import Finding

#: (class name, method name) roots of the serving hot paths.
HOT_PATH_ROOTS = (("ContinuousBatcher", "step"),
                  ("ContinuousBatcher", "tick"),
                  ("EdgeEngine", "infer"))

#: The capture entry points whose first argument is captured code.
CAPTURES = ("StepGraph", "GraphedForward")

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*check-ok(?:\(([^)]*)\))?")
_NP_NAMES = {"np", "numpy", "onp"}
_CLOCK_ATTRS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
                "monotonic_ns"}
# Method calls that copy a tensor to the host (no argument), and the
# synchronize of torch.cuda, a stream or an event.
_HOST_COPIES = ("item", "cpu", "numpy", "tolist")
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _suppressions(source: str) -> dict:
    """line number -> set of suppressed rules (empty set == all rules)."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            rules = m.group(1)
            out[i] = {r.strip() for r in rules.split(",")} if rules else set()
    return out


def _dotted(node) -> str | None:
    """'np.random.default_rng' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def lint_source(source: str, path: str) -> list:
    """All lint findings for one module's source text."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="lint.syntax", severity="error", tenant=path,
                        layer=e.lineno,
                        detail=f"file does not parse: {e.msg}")]
    suppress = _suppressions(source)
    findings = []

    def emit(rule, lineno, detail, severity="error"):
        rules = suppress.get(lineno)
        if rules is not None and (not rules or rule in rules):
            return
        findings.append(Finding(rule=rule, severity=severity, tenant=path,
                                layer=lineno, detail=detail))

    scope = _Scope(tree)
    _lint_host_sync(scope, emit)
    _lint_captured(tree, scope, emit)
    _lint_unlocked_state(tree, emit)
    _lint_dict_order_hash(tree, emit)
    return findings


def lint_paths(paths) -> list:
    findings = []
    for p in paths:
        p = pathlib.Path(p)
        findings += lint_source(p.read_text(), p.as_posix())
    return findings


class _Scope:
    """A module's functions: module level by name, methods by (class,
    name), and the intra-module call graph between them."""

    def __init__(self, tree):
        self.funcs = {}                  # name -> module-level def
        self.methods = {}                # (class, name) -> def
        for node in tree.body:
            if isinstance(node, _FUNCS):
                self.funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, _FUNCS):
                        self.methods[(node.name, item.name)] = item

    def fn(self, key):
        cls, name = key
        return self.methods[key] if cls else self.funcs[name]

    def callees(self, owner, fn) -> list:
        """(class, method) for ``self.m(...)`` calls to the owner's methods,
        (None, name) for calls to module-level functions."""
        out = []
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and (owner, f.attr) in self.methods:
                out.append((owner, f.attr))
            elif isinstance(f, ast.Name) and f.id in self.funcs:
                out.append((None, f.id))
        return out

    def closure(self, roots) -> list:
        """The (owner class, def) pairs ``roots`` and everything they call
        within the module."""
        seen, out, queue = set(), [], list(roots)
        while queue:
            owner, fn = queue.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            out.append((owner, fn))
            queue += [(c, self.fn((c, n))) for c, n in self.callees(owner,
                                                                    fn)]
        return out


# ---------------------------------------------------------------------------
# lint.host-sync
# ---------------------------------------------------------------------------

def _lint_host_sync(scope, emit) -> None:
    """Walk the intra-module call graph from the hot-path roots and flag
    host-synchronizing calls anywhere reachable."""
    roots = [k for k in HOT_PATH_ROOTS if k in scope.methods]
    root_names = "/".join(f"{c}.{m}" for c, m in roots)
    for owner, fn in scope.closure([(c, scope.methods[(c, m)])
                                    for c, m in roots]):
        where = f"{owner}.{fn.name}" if owner else fn.name
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call) \
                    or not isinstance(call.func, ast.Attribute):
                continue
            f = call.func
            dotted = _dotted(f) or ""
            sync = None
            if f.attr in _HOST_COPIES and not call.args:
                sync = f".{f.attr}()"
            elif f.attr == "synchronize":
                sync = f"{dotted}()" if dotted else ".synchronize()"
            elif dotted.split(".")[0] in _NP_NAMES \
                    and f.attr in ("asarray", "array"):
                sync = dotted
            if sync:
                emit("lint.host-sync", call.lineno,
                     f"{sync} in serving hot path (reachable from {where}, "
                     f"rooted at {root_names}): blocks the host on the "
                     f"card mid-request")


# ---------------------------------------------------------------------------
# lint.traced-if / lint.time-in-jit
# ---------------------------------------------------------------------------

def _params(fn) -> list:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _is_tensor(annotation) -> bool:
    name = _dotted(annotation) if annotation is not None else None
    if isinstance(annotation, ast.Constant) and \
            isinstance(annotation.value, str):
        name = annotation.value
    return bool(name) and name.split(".")[-1] == "Tensor"


def _captured_roots(tree, scope) -> list:
    """(owner class, def or lambda) of every function the module passes to
    a capture entry point that resolves to code of this module."""
    roots = []

    def resolve(arg, owner, enclosing):
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and arg.value.id == "self":
            return scope.methods.get((owner, arg.attr))
        if isinstance(arg, ast.Name):
            for fn in reversed(enclosing):
                for node in ast.walk(fn):
                    if isinstance(node, _FUNCS) and node.name == arg.id \
                            and node is not fn:
                        return node
            return scope.funcs.get(arg.id)
        return None

    def visit(node, owner, enclosing):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name, [])
                continue
            inner = enclosing + [child] if isinstance(child, _FUNCS) \
                else enclosing
            if isinstance(child, ast.Call) and child.args and \
                    (_dotted(child.func) or "").split(".")[-1] in CAPTURES:
                fn = resolve(child.args[0], owner, enclosing)
                if fn is not None:
                    roots.append((owner, fn))
            visit(child, owner, inner)

    visit(tree, None, [])
    return roots


def _lint_captured(tree, scope, emit) -> None:
    for owner, root in _captured_roots(tree, scope):
        for _, fn in scope.closure([(owner, root)]):
            name = getattr(fn, "name", "<lambda>")
            tensors = {a.arg for a in _params(fn)
                       if _is_tensor(a.annotation)
                       or (fn is root and a.annotation is None
                           and a.arg not in ("self", "cls"))}
            _lint_captured_body(fn, name, tensors, emit)


def _lint_captured_body(fn, name: str, tensors: set, emit) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            names = {n.id for n in ast.walk(node.test)
                     if isinstance(n, ast.Name)}
            hit = sorted(names & tensors)
            if hit:
                emit("lint.traced-if", node.lineno,
                     f"Python `if` on tensor parameter(s) "
                     f"{', '.join(hit)} inside graph-captured {name!r}: "
                     f"reads the tensor back to the host, which raises "
                     f"under CUDA-graph capture (use torch.where)")
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            parts = dotted.split(".")
            if dotted.startswith("time.") and parts[-1] in _CLOCK_ATTRS:
                emit("lint.time-in-jit", node.lineno,
                     f"{dotted}() inside graph-captured {name!r}: the clock "
                     f"reads once at capture and every replay repeats it")
            elif parts[0] == "random" or (len(parts) >= 2
                                          and parts[0] in _NP_NAMES
                                          and parts[1] == "random"):
                emit("lint.time-in-jit", node.lineno,
                     f"host RNG {dotted}() inside graph-captured {name!r}: "
                     f"the draw is baked in at capture (draw on the device "
                     f"instead)")


# ---------------------------------------------------------------------------
# lint.unlocked-shared-state
# ---------------------------------------------------------------------------

def _under_lock(node, parents) -> bool:
    n = parents.get(id(node))
    while n is not None:
        if isinstance(n, ast.With):
            for item in n.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Attribute) and \
                            sub.attr.endswith("_lock"):
                        return True
        n = parents.get(id(n))
    return False


def _lint_unlocked_state(tree, emit) -> None:
    """Classes that allocate ``self._lock`` in ``__init__`` have declared
    their mutable state shared; every other method must mutate it under
    the lock."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        init = next((m for m in cls.body
                     if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is None or not any(
                isinstance(t, ast.Attribute) and t.attr == "_lock"
                for a in ast.walk(init) if isinstance(a, ast.Assign)
                for t in a.targets):
            continue
        for m in cls.body:
            if not isinstance(m, ast.FunctionDef) or m.name == "__init__":
                continue
            parents = {id(child): parent
                       for parent in ast.walk(m)
                       for child in ast.iter_child_nodes(parent)}
            for node in ast.walk(m):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self" and \
                                not _under_lock(node, parents):
                            emit("lint.unlocked-shared-state", node.lineno,
                                 f"{cls.name}.{m.name} mutates "
                                 f"self.{t.attr} outside `with "
                                 f"self._lock:` - {cls.name} declared its "
                                 f"state shared by allocating the lock")


# ---------------------------------------------------------------------------
# lint.dict-order-hash
# ---------------------------------------------------------------------------

def _lint_dict_order_hash(tree, emit) -> None:
    """A function that both hashes and serializes must serialize
    deterministically: ``json.dumps`` without ``sort_keys=True`` next to a
    ``hashlib`` call makes cache keys depend on dict insertion order."""
    for fn in ast.walk(tree):
        if not isinstance(fn, _FUNCS):
            continue
        hashes = any(
            (_dotted(c.func) or "").startswith("hashlib.")
            for c in ast.walk(fn) if isinstance(c, ast.Call))
        if not hashes:
            continue
        for c in ast.walk(fn):
            if not isinstance(c, ast.Call):
                continue
            if (_dotted(c.func) or "") != "json.dumps":
                continue
            sorted_kw = any(
                kw.arg == "sort_keys" and
                isinstance(kw.value, ast.Constant) and kw.value.value is True
                for kw in c.keywords)
            if not sorted_kw:
                emit("lint.dict-order-hash", c.lineno,
                     f"json.dumps without sort_keys=True inside hashing "
                     f"function {fn.name!r}: the digest depends on dict "
                     f"insertion order")
