"""AST for the Dedalus subset the case-study protocols use.

A Dedalus program is Datalog with an implicit logical-time attribute:
deductive rules close within a timestep, `@next` rules derive at t+1 on the
same node, `@async` rules deliver a message whose head location (first
argument) may differ from the body's.  See the Molly invocation headers in
the reference's case studies (e.g. case-studies/pb_asynchronous.ded:2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Rule temporal kinds.
DEDUCTIVE = ""
NEXT = "next"
ASYNC = "async"


@dataclass(frozen=True)
class Term:
    """One argument position.

    kind: "var" (capitalized identifier), "const" (quoted string or bare
    int), "wild" (`_`), "arith" (`Var+k`), or "agg" (`count<Var>`, head-only).
    """

    kind: str
    name: str = ""  # var name for var/arith/agg
    value: str = ""  # constant value (always stored as a string)
    offset: int = 0  # for arith: Var + offset

    def __repr__(self) -> str:  # compact, for error messages
        if self.kind == "var":
            return self.name
        if self.kind == "const":
            return repr(self.value)
        if self.kind == "wild":
            return "_"
        if self.kind == "arith":
            return f"{self.name}+{self.offset}"
        return f"count<{self.name}>"


@dataclass(frozen=True)
class Atom:
    rel: str
    args: tuple[Term, ...]

    def __repr__(self) -> str:
        return f"{self.rel}({', '.join(map(repr, self.args))})"


@dataclass(frozen=True)
class Comparison:
    """X op Y where each side is a var or a constant; numeric when both sides
    evaluate to integers, lexicographic otherwise."""

    op: str  # one of != == > < >= <=
    left: Term
    right: Term


@dataclass
class Rule:
    head: Atom
    kind: str  # DEDUCTIVE | NEXT | ASYNC
    body: list[Atom] = field(default_factory=list)  # positive atoms, in order
    negated: list[Atom] = field(default_factory=list)  # notin atoms
    comparisons: list[Comparison] = field(default_factory=list)
    line: int = 0  # source line, for error messages

    @property
    def is_aggregating(self) -> bool:
        return any(t.kind == "agg" for t in self.head.args)


@dataclass
class Fact:
    atom: Atom  # all-const args
    time: int  # the @<int> annotation


@dataclass
class Program:
    rules: list[Rule] = field(default_factory=list)
    facts: list[Fact] = field(default_factory=list)

    @property
    def relations(self) -> set[str]:
        rels = {f.atom.rel for f in self.facts}
        for r in self.rules:
            rels.add(r.head.rel)
            for a in r.body + r.negated:
                rels.add(a.rel)
        return rels
