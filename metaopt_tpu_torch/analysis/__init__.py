"""AST-based static analysis for the port's invariants (``lint``), crash
consistency (``crashcheck``) and race detection (``race``); port of
``metaopt_tpu/analysis/``, scanning ``metaopt_tpu_torch``.

The coordinator and the ledger carry three classes of invariants that
review alone cannot keep:

* a sharded lock hierarchy in the coordinator (``_exp_locks`` under
  ``_exp_locks_guard``, WAL buffer locks, reply-cache guards) with a
  documented acquisition order, and the hosted algorithms' device state
  (TPE's and GP-BO's CUDA buffers) under their kernel and launch locks;
* hot device functions (``# mtpu: hotpath``) that must never make the
  host wait for the card;
* a durability contract: every acked mutation journals to the WAL before
  its reply leaves the sender thread.

Checker families and rule ids:

=========  ==============================================================
MTL001     lock-order inversion (cycle in the lock-acquisition graph)
MTL002     blocking call while holding a no-block lock
MTL003     write to a registered guarded attribute outside its guard
MTL004     call into a ``holds(X)``-annotated function without X held
MTJ003     host-sync call inside a ``# mtpu: hotpath`` function
           (``.item()``, ``.cpu()``, ``torch.cuda.synchronize`` ...;
           ``hotpath.py``)
MTD001     journaled op whose dispatch branch reaches no journal call
MTD002     registry drift between protocol registry and server op sets
MTD003     reply-journaled op whose handler never journals its reply
MTD004     mutating/journaled op missing from the binary-wire
           ``WIRE_OPCODES`` table, or a duplicate/reserved opcode value
MTP001-4   persistence order, WAL-before-ack, durable sequences, dead
           crash barriers (``crashcheck.py``); MTP101-103 the crash
           suites' certification failures
MTR001     shared-written attribute without a guard declaration;
           MTR101/MTR102 the race suites' data races and lock-order
           inversions (``dynrace.py``)
=========  ==============================================================

The reference's MTJ001 (use after ``jax.jit`` donation), MTJ002 (ambient
context read at trace time) and MTJ004 (non-hashable ``static_argnames``)
have no counterpart: the port JITs nothing.

Findings carry ``file:line`` + rule id. Checked-in baselines
(``analysis/{baseline,race_baseline,crash_baseline}.json``, all empty)
grandfather pre-existing findings so the gates fail only on regressions.

Source pragmas (comments)::

    # mtpu: hotpath             -- function must never host-sync (MTJ003)
    # mtpu: holds(_lock)        -- caller holds _lock (MTL003/MTL004)
    # mtpu: lint-ok MTL003 why  -- suppress one rule on this line
"""

from metaopt_tpu_torch.analysis.core import Finding, LintModule, load_paths
from metaopt_tpu_torch.analysis.registry import LintConfig, default_config
from metaopt_tpu_torch.analysis.runner import run_lint

__all__ = [
    "Finding", "LintModule", "load_paths",
    "LintConfig", "default_config", "run_lint",
]
