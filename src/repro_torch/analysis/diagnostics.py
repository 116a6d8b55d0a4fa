"""Structured diagnostics for the static analyzers.

Every analyzer in :mod:`repro_torch.analysis` (and the AST lint in
``tools/repro_lint.py``) reports findings as :class:`Diagnostic` records —
a stable rule id, a human message, an optional (row, col) locus inside the
offending encoding and an optional population index — instead of a bare
bool. Callers that only need the verdict use :func:`is_legal`; callers
that enforce it raise :class:`MappingLegalityError` via ``assert_legal``
(see :mod:`repro_torch.analysis.mapping`).
"""
from __future__ import annotations

from dataclasses import dataclass

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding.

    ``rule`` is the stable id (``MAP001``..``MAP007`` for mapping
    legality, ``RL001``.. for the AST lint); ``row``/``col`` locate the
    finding inside a single encoding (micro-batch row / layer column) —
    or, for the AST lint, source line / column; ``individual`` is the
    population index when the finding came from a stacked-population
    check."""

    rule: str
    message: str
    severity: str = ERROR
    row: "int | None" = None
    col: "int | None" = None
    individual: "int | None" = None

    def __str__(self) -> str:
        loc = []
        if self.individual is not None:
            loc.append(f"individual {self.individual}")
        if self.row is not None:
            loc.append(f"row {self.row}")
        if self.col is not None:
            loc.append(f"col {self.col}")
        where = f" [{', '.join(loc)}]" if loc else ""
        return f"{self.rule} ({self.severity}){where}: {self.message}"


def is_legal(diagnostics: "list[Diagnostic]") -> bool:
    """True when no diagnostic is an error (warnings don't block)."""
    return not any(d.severity == ERROR for d in diagnostics)


def format_diagnostics(diagnostics: "list[Diagnostic]",
                       limit: int = 8) -> str:
    """Human-readable multi-line rendering, truncated to ``limit``."""
    lines = [str(d) for d in diagnostics[:limit]]
    if len(diagnostics) > limit:
        lines.append(f"... and {len(diagnostics) - limit} more")
    return "\n".join(lines)
