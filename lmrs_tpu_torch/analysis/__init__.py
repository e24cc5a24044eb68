"""`lmrs-lint-torch`: the repo's static analysis over the PyTorch port
(docs/torch/ANALYSIS.md), a port of the reference's ``lmrs-lint``.

Four AST-based pass families over ``lmrs_tpu_torch/**``, ``chip_smoke.py``
and ``scripts/torch_*.py``:

* **race** (`locks.py`) — lock discipline learned from ``# guarded-by:``
  annotations: unguarded writes to guarded state, lock-acquisition-order
  cycles, locks held across blocking calls;
* **tracing** (`tracing.py`) — hazards in the eager step code of
  ``models/`` and ``ops/`` (host syncs, Python branches on device values)
  plus the deprecated-API sub-pass, which also refuses any import of
  ``jax`` or the reference package;
* **drift** (`drift.py`) — code-vs-docs contract drift: fault-injection
  sites vs docs/torch/ROBUSTNESS.md, ``lmrs_*`` metric names vs
  docs/torch/OBSERVABILITY.md, trace-instant args vs
  ``validate_trace_events``;
* **env** (`envpass.py`) — every ``LMRS_*`` env read must route through
  ``lmrs_tpu_torch.utils.env`` and appear in docs/torch/KNOBS.md.

Entry points: the ``lmrs-lint-torch`` console script / ``python -m
lmrs_tpu_torch.analysis``, or :func:`run_repo` programmatically.
"""

from lmrs_tpu_torch.analysis.core import (Baseline, Finding, Module,
                                          RepoContext, run_passes, run_repo)

__all__ = ["Baseline", "Finding", "Module", "RepoContext", "run_passes",
           "run_repo"]
