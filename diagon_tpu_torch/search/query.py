"""Query types (host-side AST): the port's own copy of
``diagon_tpu/search/query.py``.

Mirrors the reference's query zoo (``search/``, SURVEY.md section 2.7):
TermQuery, BooleanQuery (MUST / SHOULD / FILTER / MUST_NOT +
minimumNumberShouldMatch), PhraseQuery (slop = 0 exact), MatchAllDocsQuery,
NumericRangeQuery (doc-values scan), PointRangeQuery (point index),
DoubleRangeQuery. Queries compile to row plans in ``search/row_engine.py``.
The port's searcher takes only these classes; ``search/convert.py``
carries a JAX package query across.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence, Tuple


class Query:
    boost: float = 1.0


class Occur(enum.Enum):
    MUST = "MUST"
    SHOULD = "SHOULD"
    FILTER = "FILTER"  # required, not scored
    MUST_NOT = "MUST_NOT"


@dataclass(frozen=True)
class Term:
    field: str
    text: str


class TermQuery(Query):
    def __init__(self, field: str, text: str, boost: float = 1.0):
        self.term = Term(field, text)
        self.boost = boost

    def __repr__(self):
        b = f"^{self.boost}" if self.boost != 1.0 else ""
        return f"TermQuery({self.term.field}:{self.term.text}{b})"


@dataclass
class BooleanClause:
    query: Query
    occur: Occur


class BooleanQuery(Query):
    def __init__(
        self,
        clauses: Sequence[BooleanClause],
        minimum_number_should_match: int = 0,
        boost: float = 1.0,
    ):
        self.clauses = list(clauses)
        self.minimum_number_should_match = minimum_number_should_match
        self.boost = boost

    class Builder:
        def __init__(self):
            self._clauses: List[BooleanClause] = []
            self._min_should: int = 0

        def add(self, query: Query, occur: Occur) -> "BooleanQuery.Builder":
            self._clauses.append(BooleanClause(query, occur))
            return self

        def set_minimum_number_should_match(self, n: int):
            self._min_should = n
            return self

        def build(self) -> "BooleanQuery":
            return BooleanQuery(self._clauses, self._min_should)

    def split(self) -> Tuple[List[Query], List[Query], List[Query], List[Query]]:
        must, should, filt, must_not = [], [], [], []
        for c in self.clauses:
            if c.occur == Occur.MUST:
                must.append(c.query)
            elif c.occur == Occur.SHOULD:
                should.append(c.query)
            elif c.occur == Occur.FILTER:
                filt.append(c.query)
            else:
                must_not.append(c.query)
        return must, should, filt, must_not

    def __repr__(self):
        ms = (
            f", min_should={self.minimum_number_should_match}"
            if self.minimum_number_should_match
            else ""
        )
        return f"BooleanQuery({self.clauses}{ms})"


class PhraseQuery(Query):
    """Exact phrase, slop = 0 (reference ``PhraseQuery.cpp:27-90``)."""

    def __init__(self, field: str, terms: Sequence[str], boost: float = 1.0):
        self.field = field
        self.terms = list(terms)
        self.boost = boost

    class Builder:
        def __init__(self, field: str):
            self.field = field
            self._terms: List[str] = []

        def add(self, term: str) -> "PhraseQuery.Builder":
            self._terms.append(term)
            return self

        def build(self) -> "PhraseQuery":
            return PhraseQuery(self.field, self._terms)

    def __repr__(self):
        b = f"^{self.boost}" if self.boost != 1.0 else ""
        return f"PhraseQuery({self.field}:{' '.join(self.terms)}{b})"


class MatchAllDocsQuery(Query):
    def __repr__(self):
        return "MatchAllDocsQuery()"


class NumericRangeQuery(Query):
    """Range over NUMERIC doc values (inclusive bounds; None = open)."""

    def __init__(
        self,
        field: str,
        lower: Optional[int] = None,
        upper: Optional[int] = None,
    ):
        self.field = field
        self.lower = lower
        self.upper = upper

    def __repr__(self):
        return f"NumericRangeQuery({self.field}:[{self.lower},{self.upper}])"


class PointRangeQuery(Query):
    """Range over a 1-D point field (inclusive; reference PointRangeQuery)."""

    def __init__(self, field: str, lower=None, upper=None):
        self.field = field
        self.lower = lower
        self.upper = upper

    def __repr__(self):
        return f"PointRangeQuery({self.field}:[{self.lower},{self.upper}])"


class DoubleRangeQuery(Query):
    """Range over DOUBLE doc values with open/closed bounds
    (reference ``DoubleRangeQuery.cpp``: NumericDocValues hold the
    double's int64 bit pattern — ``diagon_c_api.cpp:441`` — and the
    scorer bit-casts back and filters; constant score 1.0)."""

    def __init__(
        self,
        field: str,
        lower: Optional[float] = None,
        upper: Optional[float] = None,
        include_lower: bool = True,
        include_upper: bool = True,
    ):
        self.field = field
        self.lower = lower
        self.upper = upper
        self.include_lower = include_lower
        self.include_upper = include_upper

    @classmethod
    def new_upper_bound_query(cls, field: str, upper: float,
                              include_upper: bool = True):
        return cls(field, None, upper, include_upper=include_upper)

    @classmethod
    def new_lower_bound_query(cls, field: str, lower: float,
                              include_lower: bool = True):
        return cls(field, lower, None, include_lower=include_lower)

    @classmethod
    def new_exact_query(cls, field: str, value: float):
        return cls(field, value, value)

    def __repr__(self):
        lo = "[" if self.include_lower else "("
        hi = "]" if self.include_upper else ")"
        return (
            f"DoubleRangeQuery({self.field}:{lo}{self.lower},"
            f"{self.upper}{hi})"
        )
