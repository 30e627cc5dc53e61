"""Parser for the Dedalus subset.

Grammar (statements end with `;`, `//` comments to end of line):

    fact:  rel(const, ...)@<int>;
    rule:  head(args) [@next|@async] :- body_elem, body_elem, ... ;
    body_elem: rel(args) | notin rel(args) | X != Y | X == Y
             | X > k | X < k | X >= k | X <= k
    args:  Var | "quoted" | bare-int | _ | Var+int | count<Var>

Variables are capitalized identifiers; relation names are lowercase.
"""

from __future__ import annotations

import re

from .ast import ASYNC, DEDUCTIVE, NEXT, Atom, Comparison, Fact, Program, Rule, Term

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<comment>//[^\n]*)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<annot>@next\b|@async\b|@\d+)
      | (?P<entail>:-)
      | (?P<cmp>!=|==|>=|<=|>|<)
      | (?P<punct>[(),;_])
      | (?P<agg>count<[A-Za-z_][A-Za-z0-9_]*>)
      | (?P<plus>\+\d+)
      | (?P<int>-?\d+)
      | (?P<ident>[A-Za-z][A-Za-z0-9_]*)
    )""",
    re.VERBOSE,
)


class DedalusSyntaxError(ValueError):
    pass


def _tokenize(text: str) -> list[tuple[str, str, int]]:
    tokens: list[tuple[str, str, int]] = []
    pos, line = 0, 1
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise DedalusSyntaxError(f"line {line}: cannot tokenize near {text[pos:pos+20]!r}")
            break
        line += text[pos : m.end()].count("\n")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        tokens.append((m.lastgroup, m.group(0).strip(), line))
    return tokens


class _Parser:
    def __init__(self, tokens: list[tuple[str, str, int]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str, int]:
        if self.i >= len(self.toks):
            return ("eof", "", self.toks[-1][2] if self.toks else 0)
        return self.toks[self.i]

    def next(self) -> tuple[str, str, int]:
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, value: str) -> tuple[str, str, int]:
        tok = self.next()
        if tok[1] != value:
            raise DedalusSyntaxError(f"line {tok[2]}: expected {value!r}, got {tok[1]!r}")
        return tok

    def parse_term(self) -> Term:
        kind, val, line = self.next()
        if kind == "punct" and val == "_":
            return Term("wild")
        if kind == "string":
            return Term("const", value=val[1:-1].replace('\\"', '"'))
        if kind == "int":
            return Term("const", value=val)
        if kind == "agg":
            return Term("agg", name=val[len("count<") : -1])
        if kind == "ident":
            if val[0].isupper():
                nk, nv, _ = self.peek()
                if nk == "plus":
                    self.next()
                    return Term("arith", name=val, offset=int(nv[1:]))
                return Term("var", name=val)
            return Term("const", value=val)  # lowercase bare word = constant
        raise DedalusSyntaxError(f"line {line}: unexpected term {val!r}")

    def parse_atom(self, rel: str) -> Atom:
        self.expect("(")
        args: list[Term] = []
        while True:
            args.append(self.parse_term())
            kind, val, line = self.next()
            if val == ")":
                break
            if val != ",":
                raise DedalusSyntaxError(f"line {line}: expected ',' or ')', got {val!r}")
        return Atom(rel=rel, args=tuple(args))

    def parse_statement(self, prog: Program) -> None:
        kind, val, line = self.next()
        if kind != "ident" or not val[0].islower():
            raise DedalusSyntaxError(f"line {line}: expected relation name, got {val!r}")
        head = self.parse_atom(val)

        kind2, val2, line2 = self.next()
        if kind2 == "annot" and val2[1:].isdigit():  # fact
            time = int(val2[1:])
            self.expect(";")
            if any(t.kind != "const" for t in head.args):
                raise DedalusSyntaxError(f"line {line}: fact arguments must be constants")
            prog.facts.append(Fact(atom=head, time=time))
            return

        rule_kind = DEDUCTIVE
        if kind2 == "annot":
            rule_kind = NEXT if val2 == "@next" else ASYNC
            kind2, val2, line2 = self.next()
        if val2 != ":-":
            raise DedalusSyntaxError(f"line {line2}: expected ':-' or '@<time>;', got {val2!r}")

        rule = Rule(head=head, kind=rule_kind, line=line)
        while True:
            kind3, val3, line3 = self.next()
            if kind3 == "ident" and val3 == "notin":
                rk, rv, rl = self.next()
                if rk != "ident":
                    raise DedalusSyntaxError(f"line {rl}: expected relation after notin")
                rule.negated.append(self.parse_atom(rv))
            elif kind3 == "ident" and val3[0].islower() and self.peek()[1] == "(":
                rule.body.append(self.parse_atom(val3))
            else:
                # comparison: term op term
                self.i -= 1
                left = self.parse_term()
                ok, ov, ol = self.next()
                if ok != "cmp":
                    raise DedalusSyntaxError(f"line {ol}: expected comparison operator, got {ov!r}")
                right = self.parse_term()
                rule.comparisons.append(Comparison(op=ov, left=left, right=right))
            sep_kind, sep, sep_line = self.next()
            if sep == ";":
                break
            if sep != ",":
                raise DedalusSyntaxError(f"line {sep_line}: expected ',' or ';', got {sep!r}")
        prog.rules.append(rule)

    def parse(self) -> Program:
        prog = Program()
        while self.peek()[0] != "eof":
            self.parse_statement(prog)
        return prog


def parse_program(text: str) -> Program:
    return _Parser(_tokenize(text)).parse()


def load_program(path: str) -> Program:
    with open(path, "r", encoding="utf-8") as f:
        return parse_program(f.read())
