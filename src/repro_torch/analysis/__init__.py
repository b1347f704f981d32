"""Hot-path contract checker (port of ``repro.analysis``): rule-based
checks over the op trace of one profiled engine step, the engine's call
shapes, and the port's Python AST.

Importing this package registers every shipped rule in ``REGISTRY`` (the
reference's 13 ids and severities).  ``artifacts.verify_engine`` is the
gate behind ``ServingEngine(verify_contracts=True)``; ``check`` is the
CLI.
"""
from .core import (ContractViolation, Finding, REGISTRY, Report, Rule,
                   Severity, all_rules, register, run_rules)
from .op_rules import HLO_RULES
from .trace_rules import TRACE_RULES, TraceSentinel
from .ast_rules import AST_RULES, ast_context

__all__ = [
    "AST_RULES", "ContractViolation", "Finding", "HLO_RULES", "REGISTRY",
    "Report", "Rule", "Severity", "TRACE_RULES", "TraceSentinel",
    "all_rules", "ast_context", "register", "run_rules",
]
