"""Lock-discipline checker (``lock-discipline``).

The threading convention: a class whose instances are
shared across threads — the metrics registry and its instruments, the
HealthEngine, the CanaryController, the FaultPlan, the
QuarantineManifest, the Tracer — **marks itself thread-safe by owning
``self._lock``** and mutates its shared state only under ``with
self._lock:``.  (Classes with main-thread-only state plus one
cross-thread corner use a *differently named* lock for that corner —
``BudgetAccountant._async_lock`` — and are deliberately outside this
rule.)

For every class that assigns ``self._lock = threading.Lock()/RLock()``
(directly or by inheriting such a class in the same module), the
checker flags mutations of ``self.*`` state outside a lock scope:

* assignments / augmented assignments to ``self.attr`` or
  ``self.attr[...]``, and ``del`` of either;
* mutating method calls on an attribute (``self.attr.append(...)``,
  ``.pop``, ``.update``, ...).

Sanctioned:

* ``__init__``/``__new__`` (construction precedes sharing);
* code lexically inside ``with self.<...lock>:`` (any attribute ending
  in ``lock``, so an auxiliary ``_async_lock`` scope counts);
* private methods whose every call site within the class is inside a
  lock scope (the ``HealthEngine._raise``/``_decay``/``_refold``
  pattern: helpers with a caller-holds-the-lock contract), computed
  transitively.
"""

from __future__ import annotations

import ast

from .core import dotted_name, register

_MUTATORS = {"append", "extend", "insert", "add", "update", "pop",
             "popitem", "remove", "discard", "clear", "setdefault",
             "appendleft", "popleft", "extendleft"}
_EXEMPT_METHODS = {"__init__", "__new__", "__init_subclass__"}


def _is_self_attr(node):
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _mutated_self_attr(node):
    """The ``self.attr`` an Assign/AugAssign/Delete target mutates, or
    ``None``."""
    target = node
    if isinstance(target, ast.Subscript):
        target = target.value
    if _is_self_attr(target):
        return target.attr
    return None


def _lock_scoped(ancestors):
    """Is any enclosing ``with`` holding ``self.<...lock>``?"""
    for anc in ancestors:
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            expr = item.context_expr
            if _is_self_attr(expr) and expr.attr.endswith("lock"):
                return True
    return False


def _assigns_lock(cls):
    """Does this class body assign ``self._lock = threading.Lock()``?"""
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee.rsplit(".", 1)[-1] not in ("Lock", "RLock"):
            continue
        for target in node.targets:
            if _is_self_attr(target) and target.attr == "_lock":
                return True
    return False


def _marked_classes(tree):
    """Names of thread-safe-marked classes in this module, including
    subclasses of marked classes (fixpoint over local base names)."""
    classes = {n.name: n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)}
    marked = {name for name, cls in classes.items() if _assigns_lock(cls)}
    changed = True
    while changed:
        changed = False
        for name, cls in classes.items():
            if name in marked:
                continue
            for base in cls.bases:
                if isinstance(base, ast.Name) and base.id in marked:
                    marked.add(name)
                    changed = True
    return {classes[name] for name in marked}


@register
class LockDisciplineChecker:
    id = "lock-discipline"
    ids = ("lock-discipline",)

    def check(self, ctx):
        out = []
        for cls in _marked_classes(ctx.tree):
            out.extend(self._check_class(ctx, cls))
        return out

    def _check_class(self, ctx, cls):
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        lock_held_only = self._lock_held_private_methods(ctx, cls,
                                                         methods)
        out = []
        for node in ast.walk(cls):
            attr, verb = self._mutation(node)
            if attr is None or attr.endswith("lock"):
                continue
            ancestors = ctx.ancestors(node)
            method = self._enclosing_method(ancestors, cls)
            if method is None or method.name in _EXEMPT_METHODS:
                continue
            if method.name in lock_held_only:
                continue
            if _lock_scoped(ancestors):
                continue
            out.append(ctx.finding(
                node, "lock-discipline",
                f"{cls.name}.{method.name} mutates self.{attr} "
                f"({verb}) outside `with self._lock:` — {cls.name} is "
                "marked thread-safe (it owns self._lock); take the "
                "lock, or waive with the reason the race is benign"))
        return out

    def _mutation(self, node):
        """(attr, verb) when ``node`` mutates ``self.attr``."""
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                attr = _mutated_self_attr(target)
                if attr is not None:
                    return attr, ("augmented assign"
                                  if isinstance(node, ast.AugAssign)
                                  else "assign")
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                attr = _mutated_self_attr(target)
                if attr is not None:
                    return attr, "del"
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _MUTATORS \
                    and _is_self_attr(func.value):
                return func.value.attr, f".{func.attr}()"
        return None, None

    def _enclosing_method(self, ancestors, cls):
        """The method of ``cls`` the node sits in (the outermost
        function directly in the class body — nested defs belong to
        their method)."""
        method = None
        for anc in ancestors:
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                method = anc
            elif isinstance(anc, ast.ClassDef):
                return method if anc is cls else None
        return None

    def _lock_held_private_methods(self, ctx, cls, methods):
        """Private methods every call site of which (within the class)
        is lock-scoped or inside another such method — their mutations
        inherit the caller's lock."""
        # collect per-method call sites: method -> [(callee, locked)]
        calls = []
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not _is_self_attr(func):
                continue
            callee = func.attr
            if callee not in methods or not callee.startswith("_"):
                continue
            ancestors = ctx.ancestors(node)
            caller = self._enclosing_method(ancestors, cls)
            calls.append((callee, caller.name if caller else None,
                          _lock_scoped(ancestors)))
        held = set()
        changed = True
        while changed:
            changed = False
            for name in methods:
                if name in held or not name.startswith("_"):
                    continue
                sites = [(caller, locked) for callee, caller, locked
                         in calls if callee == name]
                if sites and all(locked or caller in held
                                 for caller, locked in sites):
                    held.add(name)
                    changed = True
        return held
