"""Span-leak checker (``span-leak``).

An :class:`~pulsarutils_tpu_torch.obs.trace.AsyncSpan` from ``begin_span()``
must be ``end()``-ed, or the trace shows a ``b`` event with no ``e``
forever — Perfetto renders an unterminated bar and the budget/trace
cross-reference lies.  ``end()`` is idempotent and free, so the rule is
purely about reachability (the lock-discipline style: lexical evidence,
not symbolic execution).  A ``begin_span()`` call is clean when its
handle is bound to a local name whose ``.end()`` is reachable on every
path of the enclosing function, which the checker accepts in exactly
two lexical shapes:

* ``h = begin_span(...)`` followed by ``h.end()`` inside a ``finally:``
  block somewhere in the same function (the canonical pairing — a
  ``finally`` runs on every path);
* ``h.end()`` in the same statement list after the assignment with only
  simple statements between (assignments/expressions — nothing that can
  branch, loop, return or raise-and-skip past the end).

Everything else is a finding: a handle that is discarded, returned,
passed to another function, or stored on an attribute/container ends —
if it ends — somewhere this function cannot guarantee.  Reviewed
cross-method/cross-thread seams (the persist worker's span, the fleet
coordinator's lease spans) are exactly what inline waivers with reasons
are for.
"""

from __future__ import annotations

import ast

from .core import dotted_name, register

#: statements that cannot skip past a following sibling (no branch, no
#: early exit) — the straight-line rule's "simple" set
_STRAIGHT_LINE = (ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
                  ast.Pass, ast.Import, ast.ImportFrom, ast.Assert)


def _is_begin_span(node):
    if not isinstance(node, ast.Call):
        return False
    callee = dotted_name(node.func) or ""
    return callee.rsplit(".", 1)[-1] == "begin_span"


def _end_calls(fn, var):
    """Every ``<var>.end(...)`` call node inside ``fn``."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "end" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == var:
            out.append(node)
    return out


def _in_finally(ctx, node, fn):
    """Is ``node`` lexically inside a ``finally:`` block within ``fn``?"""
    chain = [node] + ctx.ancestors(node)
    for child, parent in zip(chain, chain[1:]):
        if parent is fn:
            break
        if isinstance(parent, ast.Try):
            for stmt in parent.finalbody:
                if child is stmt or any(child is d for d in
                                        ast.walk(stmt)):
                    return True
    return False


def _statement_list(ctx, stmt):
    """The (owner, list, index) holding ``stmt``, or ``None``."""
    owner = ctx.parents().get(stmt)
    if owner is None:
        return None
    for field in owner._fields:
        value = getattr(owner, field, None)
        if isinstance(value, list) and stmt in value:
            return owner, value, value.index(stmt)
    return None


def _straight_line_end(ctx, assign, var):
    """Does ``var.end()`` appear after ``assign`` in the same statement
    list with only simple statements between?"""
    where = _statement_list(ctx, assign)
    if where is None:
        return False
    _owner, stmts, idx = where
    for stmt in stmts[idx + 1:]:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "end" \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == var:
                return True
        if not isinstance(stmt, _STRAIGHT_LINE):
            return False
    return False


@register
class SpanLeakChecker:
    id = "span-leak"
    ids = ("span-leak",)

    def check(self, ctx):
        out = []
        for node in ast.walk(ctx.tree):
            if not _is_begin_span(node):
                continue
            fn = ctx.enclosing_function(node)
            parent = ctx.parents().get(node)
            var = None
            if isinstance(parent, ast.Assign) and parent.value is node \
                    and len(parent.targets) == 1 \
                    and isinstance(parent.targets[0], ast.Name):
                var = parent.targets[0].id
            qual = ctx.qualname(node) or "<module>"
            if var is None or fn is None:
                out.append(ctx.finding(
                    node, "span-leak",
                    f"{qual}: begin_span() handle is not bound to a "
                    "local name — it is discarded, returned, passed "
                    "along, or stored on an attribute, so this function "
                    "cannot guarantee AsyncSpan.end() runs on every "
                    "path; bind it and end it in a finally, or waive "
                    "the reviewed seam with the reason"))
                continue
            ends = _end_calls(fn, var)
            guaranteed = any(_in_finally(ctx, e, fn) for e in ends) \
                or _straight_line_end(ctx, parent, var)
            if not guaranteed:
                out.append(ctx.finding(
                    node, "span-leak",
                    f"{qual}: AsyncSpan {var!r} has no .end() reachable "
                    "on every path of this function (expected inside a "
                    "finally:, or straight-line after the begin) — an "
                    "exception or early return leaves an unterminated "
                    "span in the trace"))
        return out
