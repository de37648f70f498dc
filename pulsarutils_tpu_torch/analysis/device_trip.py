"""Undeclared device-trip checker (``device-trip``), torch spellings.

The accounting contract: **every device round trip is
budget-attributed** — a readback outside a budget bucket silently lands
in the chunk's ``unattributed`` residual, which is exactly the blind
spot the BudgetAccountant was built to close.

Scope: modules under ``ops/``, ``parallel/`` and ``tuning/`` (the
device-code layers; the autotuner launches real kernels, so it obeys
the same attribution contract).  Flagged spellings — the ways torch
code moves device data to the host or blocks on it:

* ``np.asarray(x)`` of a tensor (numpy reads it back);
* ``x.item()``, ``x.cpu()``, ``x.tolist()``;
* ``torch.cuda.synchronize()``.

Sanctioned seams (not flagged):

* code lexically inside a ``with budget_bucket(...)`` /
  ``with <acct>.bucket(...)`` / ``with with_timer(...)`` block — the
  span/budget layer is measuring it, which is the whole point;
* functions whose *job* is the readback or the measurement, listed in
  :data:`SANCTIONED_FUNCTIONS`;
* calls whose operand is provably host-side, via a per-function
  host-value inference: literals, ``np.*``/``math.*`` call results,
  shape/dtype metadata (``x.shape``, ``.ndim``, ...), results of scalar
  builtins (``len``/``min``/``max``/``int``/...), values already read
  back (``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``,
  ``to_numpy(...)``), local names every assignment of which is host
  (fixpoint), and method calls on such names;
* the value conversions (``np.asarray``, ``.item()``, ``.tolist()``) in
  functions that never name ``torch`` (pure-host helpers hold numpy
  values; ``.cpu()`` and ``torch.cuda.synchronize()`` are device by
  name and get no such grace).

Everything else is either a genuine unattributed trip (fix: wrap it in
the bucket that should own its wall time) or a host-side conversion the
checker cannot prove — waive those inline with a one-line reason.
"""

from __future__ import annotations

import ast

from .core import dotted_name, name_root, register

#: functions that ARE the sanctioned readback/measurement seams
SANCTIONED_FUNCTIONS = {
    "fetch_global",          # parallel.mesh: multiprocess-safe readback
    "measure_device_rtt",    # utils.logging_utils: prices the trip
    # ops.search / parallel.sharded_fdmt: the fused hybrid programs' one
    # readback each; every caller runs them inside the search/fused bucket
    "_fused_seed",
    "_fused_mesh_round",
    # tuning.autotune: the tuner's whole job is a deliberate
    # host-blocking measurement, fenced with a synchronize so one
    # candidate's asynchronous device time cannot leak into the next
    # candidate's clock; every wall second it spends sits inside the
    # caller's search/autotune budget bucket
    "measure_kernel_wall",
}

#: with-context callee names that mark an attributed region
_BUCKET_CALLS = {"budget_bucket", "bucket", "with_timer", "stage"}

_NUMPY_ROOTS = {"np", "numpy", "math"}

#: builtins (and the port's ``utils.device.to_numpy``) whose result is a
#: host scalar/container whatever the input
_HOST_BUILTINS = {"len", "min", "max", "abs", "round", "sum", "int",
                  "float", "bool", "range", "sorted", "divmod", "pow",
                  "to_numpy"}

#: attributes that are host metadata on any array (device or not)
_HOST_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
               "device", "is_cuda"}

#: methods whose result is on the host whatever the operand
_READBACK_METHODS = {"cpu", "numpy", "tolist", "item"}


def _is_attributed(ctx, node):
    """Inside a ``with`` whose context manager is a budget/span bucket?"""
    for anc in ctx.ancestors(node):
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            expr = item.context_expr
            if not isinstance(expr, ast.Call):
                continue
            name = dotted_name(expr.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _BUCKET_CALLS:
                return True
    return False


def _looks_host(node, host_vars=frozenset()):
    """Conservatively true for expressions that cannot be device arrays:
    literals/containers, ``np.*``/``math.*`` call results, host-scalar
    builtins, shape/dtype metadata, names proven host by
    :func:`_host_vars` and method calls on any of those."""
    if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.Dict,
                         ast.Set, ast.ListComp, ast.DictComp,
                         ast.GeneratorExp, ast.JoinedStr)):
        return True
    if isinstance(node, ast.Name):
        return node.id in host_vars
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
            return True
        if name_root(func) in _NUMPY_ROOTS:
            return True
        if isinstance(func, ast.Attribute) \
                and func.attr in _READBACK_METHODS:
            return True
        # a method call on a host expression stays host
        # (``shifts.min()``, ``(shifts - base).astype(np.int32)``)
        if isinstance(func, ast.Attribute):
            return _looks_host(func.value, host_vars)
        return False
    if isinstance(node, ast.Attribute):
        if node.attr in _HOST_ATTRS:
            return True
        return _looks_host(node.value, host_vars)
    if isinstance(node, ast.Subscript):
        return _looks_host(node.value, host_vars)
    if isinstance(node, ast.BinOp):
        return (_looks_host(node.left, host_vars)
                and _looks_host(node.right, host_vars))
    if isinstance(node, ast.UnaryOp):
        return _looks_host(node.operand, host_vars)
    if isinstance(node, ast.IfExp):
        return (_looks_host(node.body, host_vars)
                and _looks_host(node.orelse, host_vars))
    return False


def _host_vars(scope):
    """Names in ``scope`` (a function or module) every assignment of
    which is a host expression — fixpoint, so host-ness chains through
    ``a = np.rint(x); b = a.astype(np.int32)``.  Shape-tuple unpacking
    (``nchan, t = data.shape``) marks each target host.  A name with
    any non-host assignment (or used as a loop/with/except target) is
    never host."""
    assigns = {}      # name -> [value expressions]
    tainted = set()   # bound by for/with/comprehension/except: unknown

    def bind(target, value):
        if isinstance(target, ast.Name):
            assigns.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # unpacking a host expression (``nchan, t = data.shape``,
            # ``a, b = np.shape(x)``) yields host elements; anything
            # else leaves the targets unknown
            for el in target.elts:
                if isinstance(el, ast.Name):
                    assigns.setdefault(el.id, []).append(value)
                else:
                    taint(el)

    def taint(target):
        if isinstance(target, ast.Name):
            tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List, ast.Starred)):
            for el in getattr(target, "elts", [target.value]
                              if isinstance(target, ast.Starred) else []):
                taint(el)

    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            tainted.add(arg.arg)  # parameters are unknown, never host

    todo = [scope]
    while todo:
        node = todo.pop()
        if node is not scope and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef, ast.Lambda)):
            continue  # nested scopes run their own inference
        todo.extend(ast.iter_child_nodes(node))
        if isinstance(node, ast.Assign):
            for target in node.targets:
                bind(target, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            bind(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            taint(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    taint(item.optional_vars)
        elif isinstance(node, (ast.NamedExpr,)):
            taint(node.target)

    hosts = set()
    changed = True
    while changed:
        changed = False
        for name, values in assigns.items():
            if name in hosts or name in tainted:
                continue
            if all(_looks_host(v, hosts) for v in values):
                hosts.add(name)
                changed = True
    return frozenset(hosts)


def _function_touches_torch(fn):
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "torch":
            return True
    return False


@register
class DeviceTripChecker:
    id = "device-trip"
    ids = ("device-trip",)

    def check(self, ctx):
        pkg = ctx.pkgpath or ""
        if not pkg.startswith(("ops/", "parallel/", "tuning/")):
            return []
        out = []
        torch_fns = {}  # FunctionDef -> names torch (memoized)
        host_vars = {}  # scope node -> frozenset of proven-host names
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            scope = ctx.enclosing_function(node) or ctx.tree
            if scope not in host_vars:
                host_vars[scope] = _host_vars(scope)
            label = self._trip_label(node, host_vars[scope])
            if label is None:
                continue
            if _is_attributed(ctx, node):
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and fn.name in SANCTIONED_FUNCTIONS:
                continue
            # pure-host helpers cannot hold device values; only the
            # value-conversion spellings get this escape
            if label in ("np.asarray", ".item()", ".tolist()"):
                if fn is not None:
                    if fn not in torch_fns:
                        torch_fns[fn] = _function_touches_torch(fn)
                    if not torch_fns[fn]:
                        continue
                elif not _function_touches_torch(ctx.tree):
                    continue
            out.append(ctx.finding(
                node, "device-trip",
                f"{label} outside a budget bucket in {pkg} — a device "
                "trip here lands in the chunk's unattributed residual; "
                "wrap it in the bucket that owns its wall time (or "
                "waive with a reason if provably host-side)"))
        return out

    def _trip_label(self, call, hosts):
        func = call.func
        name = dotted_name(func)
        if name in ("np.asarray", "numpy.asarray"):
            if call.args and not _looks_host(call.args[0], hosts):
                return "np.asarray"
            return None
        if name == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(func, ast.Attribute) and not call.args \
                and func.attr in ("item", "cpu", "tolist") \
                and not _looks_host(func.value, hosts):
            return f".{func.attr}()"
        return None
