"""Shared finding record for the port's contract checker.

The port's copy of ``repro/analysis/lint/common.py``.  Every lint pass
emits :class:`Finding` rows; the CLI aggregates them into one JSON
document and exits nonzero when any survive.  A finding is a *proved*
contract violation (the launch contract read from the CUDA source and
the wrapper's own table, the shared-memory bytes computed by the
tuner's model, the AST node on disk, the cached decision re-checked by
the planner), never a heuristic score: the clean tree reports zero
findings and stays the false-positive gate.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Finding", "PassResult"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``pass_name`` is the emitting pass (``ledger``/``budget``/
    ``hygiene``/``cache``), ``rule`` a stable machine-readable
    identifier, ``where`` the subject (entry point, file:line, cache
    file, config label) and ``detail`` the human explanation with the
    concrete numbers that prove the violation.
    """

    pass_name: str
    rule: str
    where: str
    detail: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.pass_name}:{self.rule}] {self.where}: {self.detail}"


@dataclasses.dataclass
class PassResult:
    """One pass's outcome: findings plus what was actually checked.

    ``checked`` counts the units the pass proved clean (entry points and
    limits, configs screened, files walked, cache entries audited) so
    an accidentally-vacuous pass — zero findings because zero work — is
    visible in the report instead of reading as a clean bill.
    """

    pass_name: str
    findings: list
    checked: int
    notes: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return {"pass": self.pass_name, "checked": self.checked,
                "findings": [f.as_dict() for f in self.findings],
                "notes": list(self.notes)}
