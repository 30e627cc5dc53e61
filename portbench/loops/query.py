"""The query loop: one analyst's closed loop of provenance queries, each
parsed and executed through the program's query engine (``parse_query``
then ``execute_query``) over the configuration's corpora, which set-up put
in the program's corpus store, with the result cache bypassed.

Traffic parameters (traffic/<mix>.json): ``canned``, the query texts; and
``query_host_work``, the engine's lane crossovers to run each text under
(``null``: the engine's own rule; ``0``: every bucket on the device lane).
The pool is every corpus x text x crossover; the seed draws the order of
the loop over it (and the corpora's run order)."""

from __future__ import annotations

import multiprocessing
import os
import random

from portbench.check import query_mismatch


def query_pool(traffic: dict, names: list[str]) -> list[tuple[str, str, int | None]]:
    """(corpus, text, crossover) of every query of the pool."""
    return [(name, text, hw) for name in names for text in traffic["canned"] for hw in traffic["query_host_work"]]


class Loop:
    unit = "queries"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.corpora: list[dict] = []
        self.molly: dict = {}
        self.order: list[tuple] = []
        self.cycle = 1

    def setup(self) -> None:
        from nemo_tpu_torch.query.engine import ingest_corpus

        self.corpora = self.ctx.timed("corpora", self.ctx.write_corpora)
        store = os.path.join(self.ctx.workdir, "corpus-store")
        for c in self.corpora:
            self.molly[c["name"]] = self.ctx.timed("ingest", lambda: ingest_corpus(c["dir"], store))
        pool = query_pool(self.traffic, [c["name"] for c in self.corpora])
        self.order = random.Random(f"{self.ctx.seed}:order").sample(pool, len(pool))
        self.cycle = len(self.order)

    def _run(self, name: str, text: str, host_work: int | None) -> dict:
        from nemo_tpu_torch.query.engine import execute_query
        from nemo_tpu_torch.query.lang import parse_query

        return execute_query(parse_query(text), self.molly[name], device=self.ctx.device,
                             use_cache=self.traffic["use_cache"], query_host_work=host_work)

    def warm(self) -> None:
        """Every query of the pool once, untimed."""
        for q in self.order:
            self._run(*q)

    def step(self, k: int) -> dict:
        name, text, host_work = self.order[k % len(self.order)]
        with self.ctx.annotate("query"):
            return {"corpus": name, "text": text, "query_host_work": host_work,
                    "doc": self._run(name, text, host_work), "queries": 1}

    def release(self) -> None:
        self.molly = {}

    def check(self, records: list[dict]) -> dict:
        """Every query the window answered, against the reference's document
        of its corpus and text: one spawned worker a corpus (joined before
        this returns)."""
        by_name = {c["name"]: c["dir"] for c in self.corpora}
        jobs: dict[str, list] = {}
        for k, rec in enumerate(records):
            jobs.setdefault(rec["corpus"], []).append((k, rec["text"], rec["doc"]))
        args = [(by_name[name], js) for name, js in jobs.items()]
        if len(args) == 1:
            found = [judge(*args[0])]
        else:
            with multiprocessing.get_context("spawn").Pool(min(len(args), os.cpu_count() or 1)) as pool:
                found = pool.starmap(judge, args)
        return {"attempted": len(records), "mismatched_documents": [m for bad in found for m in bad]}


def judge(corpus_dir: str, answers: list[tuple[int, str, dict]]) -> list[str]:
    """The answers of one corpus that depart from the reference's document
    of their text, each named by its place in the window."""
    from portbench.reference.molly import load_molly_output
    from portbench.reference.qlang import parse_query
    from portbench.reference.query import expected_query

    ref = load_molly_output(corpus_dir)
    expected: dict[str, dict] = {}
    bad = []
    for k, text, doc in answers:
        if text not in expected:
            expected[text] = expected_query(parse_query(text), ref)
        if query_mismatch(doc, expected[text]):
            bad.append(f"query {k} ({os.path.basename(corpus_dir)}): {text}")
    return bad
