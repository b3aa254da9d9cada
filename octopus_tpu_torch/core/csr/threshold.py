"""Threshold call filtering from boolean measure expressions.

Capability-equivalent to the reference's ThresholdFilter family
(src/core/csr/filters/threshold_filter.{hpp,cpp}) with the expression
parser behind --filter-expression.  An expression like

    "QUAL < 10 | MQ < 10 | SB > 0.98"

fails a call (FILTER label per failed clause) when any clause is true.
Filter IDs follow the reference's convention: measure name + threshold
(e.g. QUAL10, SB0.98).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# The four default expressions below are verbatim copies of the reference's
# CLI defaults (src/config/option_parser.cpp:730-744), diffed clause-by-clause
DEFAULT_GERMLINE_EXPRESSION = (
    "QUAL < 10 | MQ < 10 | MP < 10 | AD < 1 | AF < 0.01 | AFB > 0.25 "
    "| SB > 0.98 | BQ < 15 | DP < 1 | ADP < 1"
)
DEFAULT_SOMATIC_EXPRESSION = (
    "QUAL < 2 | GQ < 20 | MQ < 30 | SMQ < 40 | SB > 0.9 | SD > 0.9 | BQ < 20 "
    "| DP < 3 | ADP < 1 | MF > 0.2 | NC > 1 | FRF > 0.5 | AD < 1 | AF < 0.0001"
)
DEFAULT_DENOVO_EXPRESSION = (
    "QUAL < 50 | PP < 40 | GQ < 20 | MQ < 30 | AD < 1 | AF < 0.1 | AFB > 0.2 "
    "| SB > 0.95 | BQ < 20 | DP < 10 | ADP < 1 | DC > 1 | MF > 0.2 | FRF > 0.5 "
    "| MP < 30 | MQ0 > 2"
)
DEFAULT_REFCALL_EXPRESSION = "QUAL < 2 | GQ < 20 | MQ < 10 | DP < 10 | MF > 0.2"


@dataclass(frozen=True)
class Clause:
    measure: str
    op: str           # '<' '>' '<=' '>=' '==' '!='
    value: float

    @property
    def filter_id(self) -> str:
        v = f"{self.value:g}"
        return f"{self.measure}{v}"

    def fails(self, measures: dict) -> bool:
        x = measures.get(self.measure)
        if x is None:
            return False
        if self.op == "<":
            return x < self.value
        if self.op == ">":
            return x > self.value
        if self.op == "<=":
            return x <= self.value
        if self.op == ">=":
            return x >= self.value
        if self.op == "==":
            return x == self.value
        if self.op == "!=":
            return x != self.value
        raise ValueError(self.op)


_CLAUSE_RE = re.compile(r"\s*([A-Za-z0-9_]+)\s*(<=|>=|==|!=|<|>)\s*([-+0-9.eE]+)\s*")


def parse_filter_expression(expr: str) -> list[Clause]:
    clauses = []
    for part in expr.split("|"):
        m = _CLAUSE_RE.fullmatch(part)
        if not m:
            raise ValueError(f"bad filter clause: {part!r}")
        clauses.append(Clause(m.group(1), m.group(2), float(m.group(3))))
    return clauses


class ThresholdFilter:
    def __init__(self, expression: str | None = None,
                 somatic_expression: str | None = None,
                 denovo_expression: str | None = None,
                 refcall_expression: str | None = None):
        self.clauses = parse_filter_expression(
            expression or DEFAULT_GERMLINE_EXPRESSION)
        self.somatic_clauses = parse_filter_expression(
            somatic_expression or DEFAULT_SOMATIC_EXPRESSION)
        self.denovo_clauses = parse_filter_expression(
            denovo_expression or DEFAULT_DENOVO_EXPRESSION)
        self.refcall_clauses = parse_filter_expression(
            refcall_expression or DEFAULT_REFCALL_EXPRESSION)

    def classify(self, measures: dict, somatic: bool = False,
                 denovo: bool = False, refcall: bool = False) -> list[str]:
        """Failed filter IDs ([] == PASS)."""
        if refcall:
            clauses = self.refcall_clauses
        elif denovo:
            clauses = self.denovo_clauses
        elif somatic:
            clauses = self.somatic_clauses
        else:
            clauses = self.clauses
        return [c.filter_id for c in clauses if c.fails(measures)]

    def filter_ids(self) -> list[str]:
        return sorted({c.filter_id for c in (self.clauses + self.somatic_clauses
                                             + self.denovo_clauses
                                             + self.refcall_clauses)})


__all__ = [
    "ThresholdFilter",
    "parse_filter_expression",
    "Clause",
    "DEFAULT_GERMLINE_EXPRESSION",
    "DEFAULT_SOMATIC_EXPRESSION",
    "DEFAULT_DENOVO_EXPRESSION",
    "DEFAULT_REFCALL_EXPRESSION",
]
