"""Dtype checkers for torch device code: ``float64-leak`` and ``bf16-cast``.

float64-leak
------------

Device code is float32/bfloat16/integer by design: the hot kernels are
memory bound, so a double-precision tensor on the card doubles the
bytes where it hurts most.  Host-side float64 (offset planning,
reference-semantics numpy paths, threshold math) is correct and
deliberately common, and is spelled ``np.float64`` — so the checker
only flags the torch spellings, in ``ops/`` and ``parallel/``:

* the ``torch.float64`` / ``torch.double`` / ``torch.complex128``
  dtypes wherever they appear (a ``dtype=`` argument, ``.to(...)``, a
  dtype comparison);
* ``.double()`` conversions.

A float64 tensor that is deliberate (the score packs keep a peak index
exact at any length; a host plan built as a CPU tensor) carries an
inline ``putpu-lint: disable=float64-leak`` waiver saying why.

bf16-cast
---------

Half precision is allowed in device code ONLY through the
:mod:`~pulsarutils_tpu_torch.precision` policy seam: an ad-hoc cast to
bfloat16 in a kernel wrapper silently trades 16 significand bits for
bandwidth with no declared error bound and no autotuner equivalence
gate.  The checker flags, in the same ``ops/``/``parallel/`` scope:

* ``.to(torch.bfloat16)`` / ``.to(dtype=torch.float16)`` and a torch
  constructor's ``dtype=`` of a half dtype;
* ``.bfloat16()`` / ``.half()`` conversions.

Dtype *comparisons* (``x.dtype == torch.bfloat16``) are not casts and
do not fire.  A policy-gated cast carries an inline
``putpu-lint: disable=bf16-cast`` waiver naming the policy that gates
it.
"""

from __future__ import annotations

import ast

from .core import name_root, register

_WIDE = {"float64", "double", "complex128", "cdouble"}
_HALF = {"bfloat16", "float16", "half"}
_DEVICE_LAYERS = ("ops/", "parallel/")


def _is_torch_dtype(node, names):
    """``torch.<name>`` for a name in ``names``?"""
    return (isinstance(node, ast.Attribute) and node.attr in names
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch")


@register
class Float64LeakChecker:
    id = "float64-leak"
    ids = ("float64-leak",)

    def check(self, ctx):
        if not (ctx.pkgpath or "").startswith(_DEVICE_LAYERS):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            msg = self._leak(node)
            if msg:
                out.append(ctx.finding(
                    node, "float64-leak",
                    msg + " — device code is float32/bf16/integer by "
                    "design (a float64 tensor doubles the bytes of a "
                    "memory-bound kernel); waive a deliberate one with "
                    "its reason"))
        return out

    def _leak(self, node):
        if _is_torch_dtype(node, _WIDE):
            return f"torch.{node.attr}"
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "double" and not node.args:
            return ".double()"
        return None


@register
class Bf16CastChecker:
    id = "bf16-cast"
    ids = ("bf16-cast",)

    def check(self, ctx):
        if not (ctx.pkgpath or "").startswith(_DEVICE_LAYERS):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            msg = self._cast(node)
            if msg:
                out.append(ctx.finding(
                    node, "bf16-cast",
                    msg + " — half precision enters device code only "
                    "through the precision-policy seam (a registered "
                    "strategy with a declared error bound); ad-hoc casts "
                    "dodge the bound and the autotuner equivalence "
                    "gate"))
        return out

    def _cast(self, node):
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        if isinstance(func, ast.Attribute) and not node.args \
                and func.attr in ("bfloat16", "half"):
            return f".{func.attr}()"
        half_args = [a for a in node.args if _is_torch_dtype(a, _HALF)]
        half_kw = [kw for kw in node.keywords if kw.arg == "dtype"
                   and _is_torch_dtype(kw.value, _HALF)]
        if isinstance(func, ast.Attribute) and func.attr == "to" \
                and (half_args or half_kw):
            return ".to(bf16/f16)"
        if name_root(func) == "torch" and half_kw:
            return "torch constructor with a bf16/f16 dtype"
        return None
