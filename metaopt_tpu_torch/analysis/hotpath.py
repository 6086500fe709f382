"""Host-sync checker for hot device functions (MTJ003), the PyTorch
counterpart of ``metaopt_tpu/analysis/jax_hygiene.py``'s ``_host_sync``.

A function marked hot — by a ``# mtpu: hotpath`` pragma on (or directly
above) its ``def``, or by name in ``LintConfig.hotpath_registry`` — must
never make the host wait for the device. In PyTorch that means none of
``LintConfig.host_sync_calls``:

* ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` on a tensor;
* ``torch.cuda.synchronize()``;
* ``float(x)``, ``int(x)``, ``bool(x)`` of a non-constant (a tensor
  argument reads its value back);
* ``np.asarray(x)`` / ``np.array(x)`` (a CUDA tensor has no host copy
  without a sync).

Matching is on the call's dotted name, as the reference does: a pattern
with a dot matches the whole name or its tail (``torch.cuda.synchronize``),
a bare pattern matches the last component. Unlike the reference, a method
called on a call's result (``x.max().item()``, ``t.cpu().numpy()``)
matches by its name too: in PyTorch that chain is the usual spelling.

The reference's other JAX rules have no counterpart here, because the port
JITs nothing:

* MTJ001 (a buffer read after ``jax.jit`` donated it) — PyTorch has no
  buffer donation; an in-place op is visible to every alias.
* MTJ002 (ambient context read inside a ``jax.jit``-traced function, the
  value frozen at trace time) — eager PyTorch reads the context on every
  call.
* MTJ004 (a non-hashable value bound to ``static_argnames``) — there are
  no static arguments without a tracer.
"""

from __future__ import annotations

import ast
from typing import List

from metaopt_tpu_torch.analysis.core import Finding, LintModule, dotted_name
from metaopt_tpu_torch.analysis.registry import LintConfig

_CASTS = ("float", "int", "bool")


def _host_sync(mod: LintModule, fn: ast.AST, qn: str,
               cfg: LintConfig) -> List[Finding]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn is None:
            if not isinstance(node.func, ast.Attribute):
                continue
            # a call-rooted chain (``x.detach().numpy()``): its method name
            # is the sync however the receiver was computed
            dn = "?." + node.func.attr
        last = dn.split(".")[-1]
        for pat in sorted(cfg.host_sync_calls):
            hit = (dn == pat or dn.endswith("." + pat)) if "." in pat \
                else last == pat
            if not hit:
                continue
            if last in _CASTS and (not node.args
                                 or isinstance(node.args[0], ast.Constant)):
                continue
            out.append(Finding(
                "MTJ003", mod.relpath, node.lineno,
                f"host-sync call {dn}() inside hotpath {qn}",
                symbol=qn, detail=pat))
            break
    return out


def _is_hot(mod: LintModule, fn: ast.AST, cls, cfg: LintConfig) -> bool:
    if mod.is_hotpath(fn):
        return True
    qn = f"{cls.name}.{fn.name}" if cls is not None else fn.name
    reg = cfg.hotpath_registry
    return fn.name in reg or qn in reg


def check_hotpath(modules: List[LintModule], cfg: LintConfig
                  ) -> List[Finding]:
    """MTJ003 over every hot function of ``modules``; a finding on a line
    with ``# mtpu: lint-ok MTJ003 <why>`` is dropped."""
    out: List[Finding] = []
    for mod in modules:
        for fn, cls in mod.functions():
            if _is_hot(mod, fn, cls, cfg):
                out.extend(f for f in _host_sync(mod, fn,
                                                 mod.qualname(fn), cfg)
                           if not mod.suppressed(f.line, f.rule))
    return out
