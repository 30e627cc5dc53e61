"""The report loop: whole debugging reports of the configuration's corpora,
one after another, each read from its directory (``run_debug`` on the
program's ``TorchBackend``), so ingest, packing, the map and reduce, the
report verbs and the writer are all in the window.

Traffic parameters (traffic/<mix>.json): ``figures`` (the figure policy),
``corpus_cache`` and ``result_cache`` (``off``: every report analyses its
corpus afresh) and ``svg_cache`` (``off``: every selected figure renders)."""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil

from portbench.check import report_mismatches
from portbench.reference.report import expected_report


class Loop:
    unit = "runs"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.reports_root = os.path.join(ctx.workdir, "reports")
        self.corpora: list[dict] = []
        self.cycle = 1

    def setup(self) -> None:
        os.environ["NEMO_SVG_CACHE"] = self.traffic["svg_cache"]
        self.corpora = self.ctx.timed("corpora", self.ctx.write_corpora)
        self.cycle = len(self.corpora)

    def warm(self) -> None:
        """One untimed report of every corpus: every kernel and host
        library built and loaded, every shape of the traffic seen once."""
        for c in self.corpora:
            shutil.rmtree(self._report(c, "warm")["dir"])

    def _report(self, corpus: dict, tag: str) -> dict:
        from nemo_tpu_torch.analysis.pipeline import run_debug
        from nemo_tpu_torch.backend.torch_backend import TorchBackend

        res = run_debug(corpus["dir"], self.reports_root, TorchBackend(device=self.ctx.device),
                        figures=self.traffic["figures"], report_name=f"{corpus['name']}-{tag}",
                        corpus_cache=self.traffic["corpus_cache"], result_cache=self.traffic["result_cache"])
        with open(os.path.join(res.report_dir, "telemetry.json"), encoding="utf-8") as f:
            timings = json.load(f)["timings"]
        return {"corpus": corpus["name"], "dir": res.report_dir, "runs": len(res.molly.runs), "timings": timings}

    def step(self, k: int) -> dict:
        corpus = self.corpora[k % len(self.corpora)]
        with self.ctx.annotate(f"report:{corpus['name']}"):
            return self._report(corpus, str(k))

    def check(self, records: list[dict]) -> dict:
        """Every report the window wrote, against the reference's report of
        its corpus: one spawned worker a corpus (joined before this
        returns), so that the reference's time stays under the window's."""
        by_name = {c["name"]: c["dir"] for c in self.corpora}
        reports: dict[str, list[str]] = {}
        for rec in records:
            reports.setdefault(rec["corpus"], []).append(rec["dir"])
        jobs = [(by_name[name], self.traffic["figures"], dirs) for name, dirs in reports.items()]
        if len(jobs) == 1:
            found = [judge(*jobs[0])]
        else:
            with multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
                found = pool.starmap(judge, jobs)
        return {"attempted": len(records), "mismatched_documents": [m for bad in found for m in bad]}


def judge(corpus_dir: str, figures: str, report_dirs: list[str]) -> list[str]:
    """The documents of each report of one corpus that depart from the
    reference's, each named by its report; each report is deleted once
    judged."""
    expected = expected_report(corpus_dir, figures)
    bad: list[str] = []
    for d in report_dirs:
        bad += [f"{os.path.basename(d)}: {m}" for m in report_mismatches(d, expected)]
        shutil.rmtree(d, ignore_errors=True)
    return bad
