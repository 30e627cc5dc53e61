"""The packed corpus in one ``.npz`` file (``--save-corpus``).

A copy of the JAX package's ``graphs/corpus.py``, in its file format
(``FORMAT_VERSION`` 1), so a file either package saves loads in the other.
Every run's pre and post provenance graph in packed form, the shared string
vocabularies and the run statuses go into one compressed ``.npz``: per
condition the graphs are concatenated along a node axis and an edge axis
with ``[R+1]`` offset tables (a CSR of graphs), so analysis can be run again
without parsing the sweep.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from nemo_tpu_torch.graphs.packed import CorpusVocab, PackedGraph, pack_graph
from nemo_tpu_torch.graphs.vocab import Vocab
from nemo_tpu_torch.ingest.molly import MollyOutput

FORMAT_VERSION = 1
CONDITIONS = ("pre", "post")
_COLUMNS = ("table_id", "label_id", "time_id", "type_id")


@dataclass
class PackedCorpus:
    """The packed form of one ingested corpus."""

    run_name: str
    run_ids: list[int]
    statuses: list[str]  # per run, the reference's Run.Status (data-types.go:82)
    vocab: CorpusVocab
    graphs: dict[tuple[int, str], PackedGraph] = field(default_factory=dict)


def pack_corpus(molly: MollyOutput) -> PackedCorpus:
    """Pack every run's pre and post provenance with one shared vocabulary,
    interning every pre graph, then every post graph (the order of the
    other pack paths, so the ids agree with theirs)."""
    corpus = PackedCorpus(
        run_name=molly.run_name,
        run_ids=[r.iteration for r in molly.runs],
        statuses=[r.status for r in molly.runs],
        vocab=CorpusVocab(),
    )
    for cond in CONDITIONS:
        for run in molly.runs:
            corpus.graphs[(run.iteration, cond)] = pack_graph(run.pre_prov if cond == "pre" else run.post_prov,
                                                              corpus.vocab)
    return corpus


def save_corpus(corpus: PackedCorpus, path: str) -> None:
    """Write the corpus as one compressed ``.npz``."""
    arrays: dict[str, np.ndarray] = {}
    meta = {
        "version": FORMAT_VERSION,
        "run_name": corpus.run_name,
        "run_ids": corpus.run_ids,
        "statuses": corpus.statuses,
        "vocab_tables": corpus.vocab.tables.strings,
        "vocab_labels": corpus.vocab.labels.strings,
        "vocab_times": corpus.vocab.times.strings,
    }
    for cond in CONDITIONS:
        graphs = [corpus.graphs[(i, cond)] for i in corpus.run_ids]
        node_off = np.zeros(len(graphs) + 1, dtype=np.int64)
        edge_off = np.zeros(len(graphs) + 1, dtype=np.int64)
        for k, g in enumerate(graphs):
            node_off[k + 1] = node_off[k] + g.n_nodes
            edge_off[k + 1] = edge_off[k] + len(g.edges)
        arrays[f"{cond}_node_off"] = node_off
        arrays[f"{cond}_edge_off"] = edge_off
        arrays[f"{cond}_n_goals"] = np.array([g.n_goals for g in graphs], dtype=np.int32)
        for col in _COLUMNS:
            arrays[f"{cond}_{col}"] = (
                np.concatenate([getattr(g, col) for g in graphs]) if graphs else np.zeros(0, dtype=np.int32)
            )
        arrays[f"{cond}_edges"] = (
            np.concatenate([g.edges for g in graphs]) if graphs else np.zeros((0, 2), dtype=np.int32)
        )
        arrays[f"{cond}_node_ids"] = np.array([nid for g in graphs for nid in g.node_ids], dtype=np.str_)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _vocab(strings: list[str]) -> Vocab:
    return Vocab(strings=list(strings), ids={s: i for i, s in enumerate(strings)})


def load_corpus(path: str) -> PackedCorpus:
    """Load a file save_corpus wrote; the arrays come back bit for bit."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported corpus format version {meta['version']}")
        corpus = PackedCorpus(
            run_name=meta["run_name"],
            run_ids=[int(i) for i in meta["run_ids"]],
            statuses=list(meta["statuses"]),
            vocab=CorpusVocab(
                tables=_vocab(meta["vocab_tables"]),
                labels=_vocab(meta["vocab_labels"]),
                times=_vocab(meta["vocab_times"]),
            ),
        )
        for cond in CONDITIONS:
            node_off = z[f"{cond}_node_off"]
            edge_off = z[f"{cond}_edge_off"]
            n_goals = z[f"{cond}_n_goals"]
            cols = {c: z[f"{cond}_{c}"] for c in _COLUMNS}
            edges = z[f"{cond}_edges"]
            node_ids = z[f"{cond}_node_ids"]
            for k, rid in enumerate(corpus.run_ids):
                lo, hi = int(node_off[k]), int(node_off[k + 1])
                elo, ehi = int(edge_off[k]), int(edge_off[k + 1])
                corpus.graphs[(rid, cond)] = PackedGraph(
                    n_goals=int(n_goals[k]),
                    n_nodes=hi - lo,
                    node_ids=[str(s) for s in node_ids[lo:hi]],
                    **{c: cols[c][lo:hi].astype(np.int32, copy=True) for c in _COLUMNS},
                    edges=edges[elo:ehi].astype(np.int32, copy=True).reshape(-1, 2),
                )
    return corpus
