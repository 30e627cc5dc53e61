"""GraphBackend: the backend interface the report pipeline drives, a copy of
the JAX package's ``backend/base.py`` trimmed to what ``run_debug`` calls.

The reference defines this interface implicitly against Neo4j
(main.go:33-44, ten methods); here it is explicit.  Shadow-run numbering
follows the reference: simplified graphs live at run 1000+i
(preprocessing.go:15), differential graphs at 2000+i
(differential-provenance.go:40).

Determinism note: the reference iterates Go maps in several outputs
(corrections, extensions, prototype collection order), so its output ordering
is nondeterministic.  Canonical deterministic orders are documented on each
method.
"""

from __future__ import annotations

import abc

from nemo_tpu_torch.ingest.datatypes import MissingEvent
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.report.dot import DotGraph


class NoSuccessfulRunError(RuntimeError):
    """Raised when an analysis that needs a baseline "good" run (differential
    provenance, trigger queries) runs on a corpus where no run succeeded.
    The reference hard-codes run 0 as the good run
    (differential-provenance.go:22-26, corrections.go:210-216) and silently
    produces a nonsense diff when run 0 failed; the port raises instead."""


class GraphBackend(abc.ABC):
    """Interface over the graph analytics engine (reference: main.go:33-44).
    The map/reduce of analysis/delta.py also reads the per-run hooks
    (proto_tables_by_run, achieved_pre_goal_counts, extension_suggestions,
    synth_candidates) of a backend that declares them."""

    #: True when the backend has the per-run hooks proto_tables_by_run,
    #: achieved_pre_goal_counts and extension_suggestions, which the
    #: segment map/reduce (analysis/delta.py) merges across store segments.
    #: A backend without them (Neo4jBackend) runs the global verbs
    #: create_prototypes and generate_extensions in one map over the whole
    #: corpus, with no partial cache.
    supports_delta = False

    #: True when the backend has :meth:`synth_candidates`, the per-run
    #: extension candidates of the ranked repairs (analysis/synth.py).  A
    #: report of a backend without it has no repairs.json.
    supports_synth = False

    molly: MollyOutput | None

    def stream_clone(self):
        """A fresh backend for the segment-streamed map (analysis/stream.py):
        the prefetch thread initializes segment k+1's instance while segment
        k's dispatches run, so one instance cannot serve both.  None (the
        default) means this backend does not stream; an override shares
        what is expensive (the executor) and returns an instance whose
        init_graph_db is safe on another thread."""
        return None

    def good_run_iter(self) -> int:
        """Iteration of the baseline successful run used for differential
        provenance and the trigger queries: the first successful run that
        ACHIEVED the consequent, else the first successful run
        (analysis/delta.py:choose_good_run); raises NoSuccessfulRunError
        when no run succeeded."""
        assert self.molly is not None
        from nemo_tpu_torch.analysis.delta import choose_good_run

        good = choose_good_run(self.molly)
        if good is None:
            raise NoSuccessfulRunError(
                "no successful run in this corpus: differential provenance "
                "and correction synthesis need a good run to diff against"
            )
        return good

    def baseline_run_iter(self) -> int:
        """The good run when one exists, else the first run
        (analysis/delta.py:choose_baseline_run).  Extension candidates read
        the antecedent provenance's async boundary, which failed runs have
        too (extensions.go:63-67 uses run 0 unconditionally)."""
        assert self.molly is not None
        from nemo_tpu_torch.analysis.delta import choose_baseline_run, choose_good_run

        return choose_baseline_run(self.molly, choose_good_run(self.molly))

    def proto_tables_by_run(
        self, success_iters: list[int], failed_iters: list[int]
    ) -> tuple[dict[int, list[str]], dict[int, set[str]]]:
        """(per success run: ordered qualifying prototype rule tables, []
        when the run did not achieve the antecedent; per failed run: the
        distinct rule tables of its simplified consequent graph)."""
        raise NotImplementedError

    def achieved_pre_goal_counts(self) -> dict[int, int]:
        """Per run: the count of antecedent goals with condition_holds
        (extensions.go:25-50 counts goals, not runs)."""
        raise NotImplementedError

    def extension_suggestions(self) -> list[str]:
        """The extension suggestion list from the baseline run's antecedent
        provenance, ungated (the reduce applies the all-achieved gate)."""
        raise NotImplementedError

    def synth_candidates(self, iters: list[int]) -> dict[int, list[str]]:
        """Per run in ``iters``: the sorted distinct extension-candidate
        rule tables of its antecedent provenance (the ranked repairs'
        per-run input, analysis/synth.py)."""
        raise NotImplementedError

    @abc.abstractmethod
    def init_graph_db(self, conn: str, molly: MollyOutput) -> None:
        """Attach to the backing store and register the runs
        (reference: InitGraphDB, graphing/helpers.go:17-55)."""

    @abc.abstractmethod
    def close_db(self) -> None:
        """Release resources (reference: CloseDB, graphing/helpers.go:58-86)."""

    @abc.abstractmethod
    def load_raw_provenance(self) -> None:
        """Load every run's pre/post provenance and mark condition_holds
        (reference: LoadRawProvenance, graphing/pre-post-prov.go:247-285)."""

    @abc.abstractmethod
    def simplify_prov(self, iters: list[int]) -> None:
        """Create simplified shadow graphs at run 1000+i (reference:
        SimplifyProv, graphing/preprocessing.go:351-387): the clean copy of
        Goal-[*0..]->Goal paths, then @next chain contraction."""

    def create_hazard_analysis(
        self, fault_inj_out: str, iters: list[int] | None = None
    ) -> list[DotGraph]:
        """Recolored space-time diagram per run (reference:
        CreateHazardAnalysis, graphing/hazard-analysis.go:16-88).  Host-side
        only (Molly's DOT files and the holds maps).  ``iters`` restricts to
        a subset of runs (the pipeline's figure policy); None = all runs."""
        from nemo_tpu_torch.report.figures import create_hazard_dot

        assert self.molly is not None
        by_iter = {r.iteration: r for r in self.molly.runs}
        run_ids = [r.iteration for r in self.molly.runs] if iters is None else list(iters)
        dots = []
        # Runs of one family repeat the same diagram and holds maps, so the
        # parse and recolor are memoized on the full inputs.  Identical
        # inputs SHARE the returned DotGraph: the report writer treats
        # figures as frozen once created.
        memo: dict[tuple, object] = {}
        for i in run_ids:
            run = by_iter[i]
            text = self.molly.spacetime_dot_text(run.iteration, run=run)
            key = (
                text,
                tuple(sorted(run.time_pre_holds.items())),
                tuple(sorted(run.time_post_holds.items())),
            )
            dot = memo.get(key)
            if dot is None:
                dot = memo[key] = create_hazard_dot(
                    text, run.time_pre_holds, run.time_post_holds
                )
            dots.append(dot)
        return dots

    @abc.abstractmethod
    def pull_pre_post_prov(
        self, iters: list[int] | None = None
    ) -> tuple[list[DotGraph], list[DotGraph], list[DotGraph], list[DotGraph]]:
        """Per-run DOT graphs: (pre, post, pre_clean, post_clean), aligned
        with ``iters`` (None = all runs)
        (reference: PullPrePostProv, graphing/pre-post-prov.go:288-459)."""

    @abc.abstractmethod
    def create_naive_diff_prov(
        self,
        symmetric: bool,
        failed_iters: list[int],
        success_post_dot: DotGraph,
        dot_iters: list[int] | None = None,
    ) -> tuple[list[DotGraph], list[DotGraph], list[list[MissingEvent]]]:
        """Differential provenance good-minus-bad per failed run (reference:
        CreateNaiveDiffProv, differential-provenance.go:18-243).  Missing
        events for every failed run; the overlay DOTs only for the runs in
        ``dot_iters`` (None = all failed runs).  ``symmetric`` is accepted
        and unused, as in the reference (:18).  Each failed run is diffed
        against its own labels (the reference's template bug at :43 diffs
        every later run against the first failed run's)."""

    @abc.abstractmethod
    def generate_corrections(self) -> list[str]:
        """Correction suggestions from the good run's trigger boundaries
        (reference: GenerateCorrections, graphing/corrections.go:202-328)."""

    @abc.abstractmethod
    def generate_extensions(self) -> tuple[bool, list[str]]:
        """(all_runs_achieved_pre, extension suggestions)
        (reference: GenerateExtensions, graphing/extensions.go:13-99)."""
