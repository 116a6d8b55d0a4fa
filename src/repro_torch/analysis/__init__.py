"""Static mapping-legality analyzer (:mod:`.mapping`) and its structured
diagnostics (:mod:`.diagnostics`): the encoding contract checked before
pricing, wired as ``GAConfig(verify=True)`` and the
``REPRO_VERIFY_MAPPINGS=1`` evaluator gate."""
from .diagnostics import ERROR, WARNING, Diagnostic, format_diagnostics, is_legal
from .mapping import (
    VERIFY_ENV,
    MappingLegalityError,
    assert_legal,
    assert_population_legal,
    population_legal_mask,
    verify_encoding,
    verify_env_enabled,
    verify_order,
    verify_population,
    verify_ppos,
    verify_requests,
)

__all__ = [
    "Diagnostic", "ERROR", "WARNING", "format_diagnostics", "is_legal",
    "MappingLegalityError", "assert_legal", "assert_population_legal",
    "population_legal_mask", "verify_encoding", "verify_order",
    "verify_population", "verify_ppos", "verify_requests",
    "VERIFY_ENV", "verify_env_enabled",
]
