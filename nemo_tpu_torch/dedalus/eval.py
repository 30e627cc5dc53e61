"""Bottom-up Dedalus evaluation with provenance capture.

Synchronous-timestep semantics (the Molly execution model the reference's
case studies assume, see the invocation headers in case-studies/*.ded):

  * time advances 1..EOT; deductive rules reach a stratified fixpoint within
    each step; `@next` rules derive facts at t+1 on the same node; `@async`
    rules send a message delivered at t+1 (synchronous network) unless the
    fault model drops it;
  * a node crashed at tc sends nothing and receives nothing from tc on, and
    its `@next` state stops advancing — but facts elsewhere still mention it
    and the built-in `crash(N, N, Tc)` relation is visible at every step, so
    specs guard with `notin crash(...)` exactly like the reference's
    (case-studies/pb_asynchronous.ded:62-63);
  * an omission (src, dst, t) drops the message sent at t from src to dst.

Provenance: every derived fact instance is a goal node; every rule firing is
a rule node with edges head-goal -> rule -> body-goals (the reference's
DUETO orientation, graphing/pre-post-prov.go:150-195); async firings add the
`clock(src, dst, t, __WILDCARD__)` subgoal whose label carries the timestep
for the loader's regexes (faultinjectors/molly.go:76-89).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import count
from typing import Any, Iterable

from .ast import ASYNC, DEDUCTIVE, NEXT, Atom, Comparison, Program, Rule, Term

CRASH_REL = "crash"


@dataclass(frozen=True)
class FactInst:
    rel: str
    args: tuple[str, ...]
    time: int


@dataclass(frozen=True)
class SentMessage:
    rel: str
    args: tuple[str, ...]
    src: str
    dst: str
    send_time: int
    delivered: bool


class Provenance:
    """Derivation DAG over fact instances, in Molly JSON vocabulary."""

    def __init__(self) -> None:
        self._ids = count()
        self.goal_id: dict[FactInst, str] = {}
        self.goals: list[dict[str, Any]] = []
        self.rules: list[dict[str, Any]] = []
        self.edges: list[tuple[str, str]] = []
        self._firings: set[tuple] = set()

    def goal(self, fact: FactInst) -> str:
        gid = self.goal_id.get(fact)
        if gid is None:
            gid = f"goal_{next(self._ids)}"
            self.goal_id[fact] = gid
            self.goals.append(
                {
                    "id": gid,
                    "label": f"{fact.rel}({', '.join(fact.args)})",
                    "table": fact.rel,
                    "time": str(fact.time),
                }
            )
        return gid

    def clock_goal(self, src: str, dst: str, t: int) -> str:
        fact = FactInst("clock", (src, dst, str(t), "__WILDCARD__"), t)
        gid = self.goal_id.get(fact)
        if gid is None:
            gid = f"goal_{next(self._ids)}"
            self.goal_id[fact] = gid
            self.goals.append(
                {
                    "id": gid,
                    "label": f"clock({src}, {dst}, {t}, __WILDCARD__)",
                    "table": "clock",
                    "time": "",  # the loader extracts it from the label
                }
            )
        return gid

    def firing(
        self,
        head: FactInst,
        rule_table: str,
        rule_label: str,
        rule_type: str,
        bodies: Iterable[FactInst],
        clock: tuple[str, str, int] | None = None,
    ) -> None:
        bodies = tuple(bodies)
        key = (head, rule_table, rule_type, bodies, clock)
        if key in self._firings:
            return
        self._firings.add(key)
        rid = f"rule_{next(self._ids)}"
        self.rules.append({"id": rid, "label": rule_label, "table": rule_table, "type": rule_type})
        self.edges.append((self.goal(head), rid))
        for b in bodies:
            self.edges.append((rid, self.goal(b)))
        if clock is not None:
            self.edges.append((rid, self.clock_goal(*clock)))

    def extract(self, roots: list[FactInst]) -> dict[str, Any]:
        """The subgraph reachable from `roots` along goal->rule->goal edges,
        in Molly provenance-JSON shape."""
        out_edges: dict[str, list[str]] = {}
        for s, d in self.edges:
            out_edges.setdefault(s, []).append(d)
        keep: set[str] = set()
        stack = [self.goal_id[r] for r in roots if r in self.goal_id]
        while stack:
            node = stack.pop()
            if node in keep:
                continue
            keep.add(node)
            stack.extend(out_edges.get(node, ()))
        return {
            "goals": [g for g in self.goals if g["id"] in keep],
            "rules": [r for r in self.rules if r["id"] in keep],
            "edges": [
                {"from": s, "to": d} for s, d in self.edges if s in keep and d in keep
            ],
        }


class EvalError(ValueError):
    pass


def stratify(rules: list[Rule]) -> list[list[Rule]]:
    """Stratum numbers for DEDUCTIVE rules: a relation depending on another
    through negation or aggregation sits strictly above it.  @next/@async
    rules read the finished state of step t, so they are excluded here."""
    deductive = [r for r in rules if r.kind == DEDUCTIVE]
    stratum: dict[str, int] = {}
    for r in deductive:
        stratum.setdefault(r.head.rel, 0)
    for _ in range(len(deductive) * len(deductive) + 2):
        changed = False
        for r in deductive:
            need = 0
            for a in r.body:
                bump = 1 if r.is_aggregating else 0  # agg reads a closed stratum
                need = max(need, stratum.get(a.rel, 0) + bump)
            for a in r.negated:
                need = max(need, stratum.get(a.rel, 0) + 1)
            if need > stratum[r.head.rel]:
                if need > len(deductive) + 1:
                    raise EvalError(f"negation/aggregation cycle through {r.head.rel!r}")
                stratum[r.head.rel] = need
                changed = True
        if not changed:
            break
    else:
        raise EvalError("stratification did not converge")
    n = max(stratum.values(), default=0) + 1
    out: list[list[Rule]] = [[] for _ in range(n)]
    for r in deductive:
        out[stratum[r.head.rel]].append(r)
    return out


def _subst(term: Term, env: dict[str, str]) -> str | None:
    """Ground a term under env; None if an unbound var remains."""
    if term.kind == "const":
        return term.value
    if term.kind == "var":
        return env.get(term.name)
    if term.kind == "arith":
        v = env.get(term.name)
        if v is None:
            return None
        try:
            return str(int(v) + term.offset)
        except ValueError as ex:
            raise EvalError(f"arithmetic on non-integer {v!r}") from ex
    return None  # wild/agg never ground to a single value here


def _match(atom: Atom, fact_args: tuple[str, ...], env: dict[str, str]) -> dict[str, str] | None:
    if len(atom.args) != len(fact_args):
        return None
    new = dict(env)
    for term, val in zip(atom.args, fact_args):
        if term.kind == "wild":
            continue
        if term.kind == "const":
            if term.value != val:
                return None
        elif term.kind == "var":
            bound = new.get(term.name)
            if bound is None:
                new[term.name] = val
            elif bound != val:
                return None
        elif term.kind == "arith":
            bound = new.get(term.name)
            try:
                want = int(val) - term.offset
            except ValueError:
                return None
            if bound is None:
                new[term.name] = str(want)
            elif bound != str(want):
                return None
        else:
            return None
    return new


def _cmp_holds(c: Comparison, env: dict[str, str]) -> bool:
    left = _subst(c.left, env)
    right = _subst(c.right, env)
    if left is None or right is None:
        raise EvalError(f"comparison on unbound variable: {c}")
    try:
        lv: Any = int(left)
        rv: Any = int(right)
    except ValueError:
        lv, rv = left, right
    return {
        "!=": lv != rv,
        "==": lv == rv,
        ">": lv > rv,
        "<": lv < rv,
        ">=": lv >= rv,
        "<=": lv <= rv,
    }[c.op]


@dataclass
class StepState:
    """Facts visible at one timestep, indexed by relation."""

    by_rel: dict[str, set[tuple[str, ...]]] = field(default_factory=dict)
    src: dict[tuple[str, tuple[str, ...]], FactInst] = field(default_factory=dict)

    def add(self, fact: FactInst) -> bool:
        rel_set = self.by_rel.setdefault(fact.rel, set())
        if fact.args in rel_set:
            return False
        rel_set.add(fact.args)
        self.src[(fact.rel, fact.args)] = fact
        return True

    def facts(self, rel: str) -> list[tuple[str, ...]]:
        return sorted(self.by_rel.get(rel, ()))

    def inst(self, rel: str, args: tuple[str, ...]) -> FactInst:
        return self.src[(rel, args)]


@dataclass
class RunResult:
    derived: dict[int, StepState]
    prov: Provenance
    messages: list[SentMessage]
    pre_rows: list[list[str]]  # [args..., str(t)] rows, Model.Tables shape
    post_rows: list[list[str]]
    status: str  # "success" | "fail"


class Evaluator:
    def __init__(
        self,
        program: Program,
        eot: int,
        crashes: dict[str, int] | None = None,
        omissions: set[tuple[str, str, int]] | None = None,
    ) -> None:
        self.program = program
        self.eot = eot
        self.crashes = dict(crashes or {})
        self.omissions = set(omissions or ())
        self.strata = stratify(program.rules)
        self.next_rules = [r for r in program.rules if r.kind == NEXT]
        self.async_rules = [r for r in program.rules if r.kind == ASYNC]

    # ------------------------------------------------------------ helpers

    def _crashed(self, node: str, t: int) -> bool:
        tc = self.crashes.get(node)
        return tc is not None and t >= tc

    def _join(
        self, rule: Rule, state: StepState
    ) -> list[tuple[dict[str, str], list[FactInst]]]:
        """All satisfying bindings of the rule's body against one step, each
        with the body fact instances that actually produced it (in body-atom
        order) — so provenance edges cite the true supporting facts rather
        than a re-matched first-sorted candidate (which diverges under
        wildcards)."""
        envs: list[tuple[dict[str, str], list[FactInst]]] = [({}, [])]
        for atom in rule.body:
            nxt: list[tuple[dict[str, str], list[FactInst]]] = []
            for env, insts in envs:
                for args in state.facts(atom.rel):
                    new = _match(atom, args, env)
                    if new is not None:
                        nxt.append((new, [*insts, state.inst(atom.rel, args)]))
            envs = nxt
            if not envs:
                return []
        out = []
        for env, insts in envs:
            if any(self._neg_holds(a, state, env) for a in rule.negated):
                continue
            if all(_cmp_holds(c, env) for c in rule.comparisons):
                out.append((env, insts))
        return out

    def _neg_holds(self, atom: Atom, state: StepState, env: dict[str, str]) -> bool:
        for args in state.facts(atom.rel):
            if _match(atom, args, env) is not None:
                return True
        return False

    def _head_args(self, rule: Rule, env: dict[str, str]) -> tuple[str, ...] | None:
        vals = []
        for t in rule.head.args:
            v = _subst(t, env)
            if v is None:
                raise EvalError(
                    f"line {rule.line}: unbound variable in head of {rule.head.rel}"
                )
            vals.append(v)
        return tuple(vals)

    # --------------------------------------------------------------- run

    def run(self) -> RunResult:
        prov = Provenance()
        messages: list[SentMessage] = []
        derived: dict[int, StepState] = {t: StepState() for t in range(1, self.eot + 2)}

        # EDB facts: grounded at their stated time with a base firing; crash
        # facts are visible at every step (specs match `notin crash(..., _)`).
        for f in sorted(self.program.facts, key=lambda f: (f.atom.rel, f.time)):
            args = tuple(t.value for t in f.atom.args)
            node = args[0] if args else ""
            if f.time < 1:
                raise EvalError(f"fact {f.atom.rel} timed @{f.time}; time starts at 1")
            if f.time > self.eot or self._crashed(node, f.time):
                continue
            inst = FactInst(f.atom.rel, args, f.time)
            if derived[f.time].add(inst):
                prov.firing(inst, f.atom.rel, f.atom.rel, "", (), clock=(node, node, f.time))
        for node, tc in sorted(self.crashes.items()):
            for t in range(1, self.eot + 1):
                derived[t].add(FactInst(CRASH_REL, (node, node, str(tc)), t))

        for t in range(1, self.eot + 1):
            state = derived[t]
            # Deductive fixpoint, stratum by stratum.
            for stratum in self.strata:
                changed = True
                while changed:
                    changed = False
                    for rule in stratum:
                        if rule.is_aggregating:
                            changed |= self._fire_aggregate(rule, state, t, prov)
                            continue
                        for env, bodies in self._join(rule, state):
                            head = self._head_args(rule, env)
                            inst = FactInst(rule.head.rel, head, t)
                            if state.add(inst):
                                changed = True
                            prov.firing(
                                inst, rule.head.rel, rule.head.rel, "", bodies
                            )

            if t == self.eot:
                break

            # @next induction into t+1.
            for rule in self.next_rules:
                for env, bodies in self._join(rule, state):
                    head = self._head_args(rule, env)
                    node = head[0] if head else ""
                    if self._crashed(node, t + 1):
                        continue
                    inst = FactInst(rule.head.rel, head, t + 1)
                    derived[t + 1].add(inst)
                    prov.firing(
                        inst,
                        rule.head.rel,
                        f"{rule.head.rel}_next",
                        "next",
                        bodies,
                    )

            # @async messaging delivered at t+1.  The sender is the body's
            # location: Dedalus rule bodies are co-located (all positive
            # atoms share their first argument) — enforced here because a
            # mis-located body would silently defeat omission/crash faults.
            for rule in self.async_rules:
                for env, bodies in self._join(rule, state):
                    head = self._head_args(rule, env)
                    dst = head[0] if head else ""
                    locs = {b.args[0] for b in bodies if b.args}
                    if len(locs) > 1:
                        raise EvalError(
                            f"line {rule.line}: @async body atoms are not "
                            f"co-located (first arguments {sorted(locs)}); "
                            "route the triggering fact to the sending node "
                            "first"
                        )
                    src = bodies[0].args[0] if bodies and bodies[0].args else dst
                    dropped = (
                        self._crashed(src, t)
                        or self._crashed(dst, t + 1)
                        or (src, dst, t) in self.omissions
                    )
                    messages.append(
                        SentMessage(rule.head.rel, head, src, dst, t, not dropped)
                    )
                    if dropped:
                        continue
                    inst = FactInst(rule.head.rel, head, t + 1)
                    derived[t + 1].add(inst)
                    prov.firing(
                        inst,
                        rule.head.rel,
                        rule.head.rel,
                        "async",
                        bodies,
                        clock=(src, dst, t),
                    )

        pre_rows = [
            [*args, str(t)]
            for t in range(1, self.eot + 1)
            for args in derived[t].facts("pre")
        ]
        post_rows = [
            [*args, str(t)]
            for t in range(1, self.eot + 1)
            for args in derived[t].facts("post")
        ]
        # Invariant check at EOT (pre ⇒ post on the final step).
        final = derived[self.eot]
        violated = any(
            args not in final.by_rel.get("post", set())
            for args in final.by_rel.get("pre", set())
        )
        return RunResult(
            derived=derived,
            prov=prov,
            messages=messages,
            pre_rows=pre_rows,
            post_rows=post_rows,
            status="fail" if violated else "success",
        )

    def _fire_aggregate(self, rule: Rule, state: StepState, t: int, prov: Provenance) -> bool:
        """count<V> head aggregation: group by the non-agg head args over all
        body matches, count distinct V bindings."""
        groups: dict[tuple[str, ...], set[str]] = {}
        contributors: dict[tuple[str, ...], list[FactInst]] = {}
        agg_var = next(term.name for term in rule.head.args if term.kind == "agg")
        for env, bodies in self._join(rule, state):
            key = tuple(
                _subst(term, env) or "" for term in rule.head.args if term.kind != "agg"
            )
            val = env.get(agg_var)
            if val is None:
                raise EvalError(f"line {rule.line}: count<{agg_var}> variable unbound")
            groups.setdefault(key, set()).add(val)
            contributors.setdefault(key, []).extend(bodies)
        changed = False
        for key, vals in sorted(groups.items()):
            head = []
            it = iter(key)
            for term in rule.head.args:
                head.append(str(len(vals)) if term.kind == "agg" else next(it))
            inst = FactInst(rule.head.rel, tuple(head), t)
            if state.add(inst):
                changed = True
            seen: set[FactInst] = set()
            uniq = [b for b in contributors[key] if not (b in seen or seen.add(b))]
            prov.firing(inst, rule.head.rel, rule.head.rel, "", uniq)
        return changed
