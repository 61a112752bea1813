"""The port's contract checker: static analysis of the CUDA stack.

The counterpart of ``repro/analysis/lint``.  Four passes, each proving
a contract the runtime checks silently or not at all:

* :mod:`.ledger`: the launch contract, each ``extern "C"`` entry point
  of ``kernels/csrc/*.cu`` against the ``ctypes`` types its wrapper
  binds, and the limits both sides state;
* :mod:`.budget`: the tuner's shared-memory byte model
  (:func:`repro_torch.tune.space.kernel_smem_bytes`) over every
  candidate it can propose;
* :mod:`.hygiene`: AST rules for the retrace/warn bug classes
  (jit-in-fn, ``torch.compile`` in a function included,
  warn-stacklevel, mutable-default, nonhashable-static, unused-import);
* :mod:`.cache_audit`: re-checks persisted tune decisions against the
  current planner, with the dispatcher's own audit.

CLI: ``python -m repro_torch.analysis.lint`` emits one JSON document of
structured findings and exits nonzero when any survive.
"""

from .budget import screen_candidate_spaces  # noqa: F401
from .cache_audit import (audit_cache_file,  # noqa: F401
                          audit_tuned_config, run_cache_audit_pass)
from .common import Finding, PassResult  # noqa: F401
from .hygiene import check_source, run_hygiene_pass  # noqa: F401
from .ledger import (Binding, bindings, limit_facts,  # noqa: F401
                     parse_entries, run_ledger_pass)
