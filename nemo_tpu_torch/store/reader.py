"""Warm-load side of the ``.npack`` store: mapped shards -> packed MollyOutput.

A copy of the JAX package's ``store/reader.py``.  The loaded object is
interchangeable with the packed-first loader's
(``ingest/native.py:load_molly_output_packed``): runs carry RawProv
placeholders splicing the stored serializations, head fragments come from
the stored blob, ``.native_corpus`` exposes the (read-only, mapped) arrays.
The failureSpec/model/messages trio materializes only if something reads
it: from the source runs.json (Molly), or from the stored head fragment
where the layout has no runs.json (trace-JSON).  A store of a quarantined
or repaired corpus maps its rows to source positions (``positions``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from nemo_tpu_torch.ingest.datatypes import RunData
from nemo_tpu_torch.ingest.molly import MollyOutput
from nemo_tpu_torch.ingest.native import LazyRunData, NativeCondBatch, NativeCorpus, RawProv
from nemo_tpu_torch.store.npack import _COND_ARRAYS, ShardReader, StoreCorrupt

#: Padding per cond-array (the native fills), for consolidating segments
#: of different (V, E).
_PAD = {
    "table_id": -1,
    "label_id": -1,
    "time_id": -1,
    "type_id": 0,
    "is_goal": False,
    "node_mask": False,
    "edge_src": 0,
    "edge_dst": 0,
    "edge_mask": False,
}


class LazyCondBatch:
    """NativeCondBatch of a multi-segment store: the per-run vectors
    (n_nodes, n_goals, chain_linear) concatenate at once; a [B,V]/[B,E]
    plane is padded and concatenated on its first access (then cached), so
    a report-only touch never builds them; ``take`` gathers rows from the
    per-segment maps without the whole plane."""

    def __init__(self, cond: str, seg_readers: list[dict], segs: list[dict]) -> None:
        self._cond = cond
        self._readers = seg_readers
        self._segs = segs
        self._v = max(int(s["v"]) for s in segs)
        self._e = max(int(s["e"]) for s in segs)
        self._kind = dict(_COND_ARRAYS)
        seg_runs = [int(s["n_runs"]) for s in segs]
        self._b = sum(seg_runs)
        self._starts = np.cumsum([0] + seg_runs)
        for name, kind in _COND_ARRAYS:
            if kind == "b":
                setattr(self, name, np.concatenate([self._region(k, name) for k in range(len(segs))]))

    def _region(self, k: int, name: str) -> np.ndarray:
        return self._readers[k][f"arrays_{self._cond}.bin"].region(name)

    def _width(self, kind: str) -> int:
        return self._v if kind == "bv" else self._e

    def __getattr__(self, name: str) -> np.ndarray:
        # Reached only while the attribute is unset: consolidate and cache.
        kind = self.__dict__.get("_kind", {}).get(name)
        if kind is None or kind == "b":
            raise AttributeError(name)
        parts = [self._region(k, name) for k in range(len(self._segs))]
        out = np.full((self._b, self._width(kind)), _PAD[name], dtype=parts[0].dtype)
        row = 0
        for p in parts:
            out[row : row + p.shape[0], : p.shape[1]] = p
            row += p.shape[0]
        setattr(self, name, out)
        return out

    def take(self, name: str, rows) -> np.ndarray:
        """Rows ``rows`` (global positions) of one plane, padded to the
        consolidated width: ``consolidated[rows]`` without consolidating."""
        kind = self._kind[name]
        idx = np.asarray(rows, dtype=np.int64)
        if kind == "b":
            return getattr(self, name)[idx]
        if name in self.__dict__:
            return self.__dict__[name][idx]
        seg_of = np.searchsorted(self._starts, idx, side="right") - 1
        out = np.full((len(idx), self._width(kind)), _PAD[name], dtype=self._region(0, name).dtype)
        for k in np.unique(seg_of):
            sel = np.nonzero(seg_of == k)[0]
            src = self._region(int(k), name)
            out[sel, : src.shape[1]] = src[idx[sel] - int(self._starts[k])]
        return out


class _SegmentStrings:
    """One segment's strings: the meta shard's status/holds/head blobs and
    the row-chunked prov/node-id shards of each condition."""

    def __init__(self, entry: dict, readers: dict) -> None:
        self.chunk = int(entry["string_chunk_rows"])
        self.meta = readers["meta.bin"]
        self.head = self.meta.blob("head")
        self._chunks: dict[str, list] = {"pre": [], "post": []}
        for cond in ("pre", "post"):
            k = 0
            while f"strings_{cond}_{k:03d}.bin" in readers:
                self._chunks[cond].append(readers[f"strings_{cond}_{k:03d}.bin"])
                k += 1

    def blob(self, cond: str, row: int, name: str) -> bytes:
        return self._chunks[cond][row // self.chunk].blob(name).row(row % self.chunk)


class StoreStrings:
    """Global-row string access over all segments."""

    def __init__(self, segments: list[_SegmentStrings], seg_runs: list[int]) -> None:
        self.segments = segments
        self.starts = np.cumsum([0] + seg_runs)

    def _locate(self, row: int) -> tuple[_SegmentStrings, int]:
        s = int(np.searchsorted(self.starts, row, side="right")) - 1
        return self.segments[s], row - int(self.starts[s])

    def prov(self, cond: str, row: int) -> bytes:
        seg, r = self._locate(row)
        return seg.blob(cond, r, "prov")

    def node_ids(self, cond: str, row: int) -> bytes:
        seg, r = self._locate(row)
        return seg.blob(cond, r, "node_ids")

    def head(self, row: int) -> bytes:
        seg, r = self._locate(row)
        return seg.head.row(r)


@dataclass
class StoreCorpus(NativeCorpus):
    """NativeCorpus whose per-run strings come from store blobs instead of
    a live C++ handle; its arrays are maps (one segment) or LazyCondBatch
    planes (several)."""

    strings: StoreStrings | None = None

    def prov_json(self, cond_name: str, row: int) -> bytes:
        out = self.strings.prov(cond_name, row)
        if not out:
            raise StoreCorrupt(f"empty stored provenance for cond {cond_name} run row {row}")
        return out

    def run_head_json(self, row: int) -> bytes:
        out = self.strings.head(row)
        if not out:
            raise StoreCorrupt(f"empty stored head fragment for run row {row}")
        return out

    def lazy_node_ids(self, cond_name: str, row: int) -> list[str]:
        joined = self.strings.node_ids(cond_name, row).decode()
        return joined.split("\n") if joined else []


class _RawRuns:
    """The source runs.json, parsed at most once per load and only when a
    run's metadata trio is read."""

    def __init__(self, path: str, expected_n: int) -> None:
        self.path = path
        self.expected_n = expected_n
        self._rows: list | None = None

    def row(self, i: int) -> dict:
        if self._rows is None:
            with open(self.path, "r", encoding="utf-8") as fh:
                self._rows = json.load(fh)
            if len(self._rows) < self.expected_n:
                raise StoreCorrupt(f"{self.path} has {len(self._rows)} runs but the store holds {self.expected_n}")
        return self._rows[i]


class _HeadRuns:
    """The trio's source for a layout without runs.json: the stored head
    fragment, the same five pairs the populate serialized.  Indexed by
    source position like _RawRuns."""

    def __init__(self, corpus: "StoreCorpus", positions: list[int] | None) -> None:
        self._corpus = corpus
        self._row_of = {int(p): r for r, p in enumerate(positions)} if positions else None

    def row(self, i: int) -> dict:
        row = self._row_of[i] if self._row_of is not None else i
        return json.loads(b"{" + self._corpus.run_head_json(row) + b"}")


class _RawProxy:
    """dict-shaped view of one run's runs.json entry, parsed on demand."""

    __slots__ = ("_runs", "_i")

    def __init__(self, runs: _RawRuns, i: int) -> None:
        self._runs = runs
        self._i = i

    def get(self, key, default=None):
        return self._runs.row(self._i).get(key, default)

    def __getitem__(self, key):
        return self._runs.row(self._i)[key]


class StoreRunData(LazyRunData):
    """LazyRunData whose trio parses the source runs.json only on access,
    whose head fragment comes from the store and whose holds maps decode
    from the store's blobs on first touch.  Built by molly_from_corpus from
    a template ``__dict__``, not through the dataclass constructor."""

    def _holds_get(self, cond: str) -> dict:
        got = self._holds.get(cond)
        if got is None:
            pre_b, post_b, local = self._holds_blobs
            raw = (pre_b if cond == "pre" else post_b).row(local)
            # attach_run_metadata's keying; deduplicated in order when stored.
            got = self._holds[cond] = dict.fromkeys(json.loads(raw), True)
        return got

    time_pre_holds = property(lambda s: s._holds_get("pre"), lambda s, v: s._holds.__setitem__("pre", v))
    time_post_holds = property(lambda s: s._holds_get("post"), lambda s, v: s._holds.__setitem__("post", v))


def open_segments(store_dir: str, header: dict, verify: bool) -> tuple:
    """Map every shard of every segment (checking CRCs when ``verify``);
    returns (per-segment reader dicts, vocab reader, total mapped bytes)."""
    seg_readers: list[dict[str, ShardReader]] = []
    total = 0
    for entry in header["segments"]:
        readers: dict[str, ShardReader] = {}
        for manifest in entry["shards"]:
            rd = ShardReader(os.path.join(store_dir, entry["name"], manifest["file"]), manifest)
            if verify:
                rd.verify()
            readers[manifest["file"]] = rd
            total += rd.nbytes
        seg_readers.append(readers)
    vocab_rd = ShardReader(os.path.join(store_dir, header["vocab_shard"]["file"]), header["vocab_shard"])
    if verify:
        vocab_rd.verify()
    total += vocab_rd.nbytes
    return seg_readers, vocab_rd, total


def decode_vocab(vocab_rd: ShardReader, part: str) -> list[str]:
    blob = vocab_rd.blob(part)
    return [blob.row(i).decode() for i in range(len(blob))]


def build_corpus(store_dir: str, header: dict, seg_readers: list[dict], vocab_rd) -> StoreCorpus:
    """The StoreCorpus of the mapped shards: zero-copy map views for one
    segment, LazyCondBatch planes for several."""
    segs = header["segments"]
    seg_runs = [int(s["n_runs"]) for s in segs]

    def cond_batch(cond: str):
        if len(segs) == 1:
            rd = seg_readers[0][f"arrays_{cond}.bin"]
            return NativeCondBatch(**{n: rd.region(n) for n, _ in _COND_ARRAYS})
        return LazyCondBatch(cond, seg_readers, segs)

    def runs_region(name: str) -> np.ndarray:
        if len(segs) == 1:
            return seg_readers[0]["runs.bin"].region(name)
        return np.concatenate([sr["runs.bin"].region(name) for sr in seg_readers])

    return StoreCorpus(
        n_runs=sum(seg_runs),
        v=max(int(s["v"]) for s in segs),
        e=max(int(s["e"]) for s in segs),
        tables=decode_vocab(vocab_rd, "tables"),
        labels=decode_vocab(vocab_rd, "labels"),
        times=decode_vocab(vocab_rd, "times"),
        pre_tid=int(header["pre_tid"]),
        post_tid=int(header["post_tid"]),
        max_depth=max(int(s["max_depth"]) for s in segs),
        iteration=runs_region("iteration"),
        success=runs_region("success"),
        pre=cond_batch("pre"),
        post=cond_batch("post"),
        node_ids_pre=[],
        node_ids_post=[],
        handle=None,
        strings=StoreStrings([_SegmentStrings(s, rd) for s, rd in zip(segs, seg_readers)], seg_runs),
    )


def molly_from_corpus(corpus: StoreCorpus, corpus_dir: str, positions: list[int] | None = None) -> MollyOutput:
    """StoreCorpus -> MollyOutput, the packed-first loader's product without
    reading any source JSON: per run a template dict, lazy holds and trio.
    ``positions`` maps a stored row to its source position
    (npack.stored_positions; the identity when None), which the lazy trio
    reads by."""
    runs_path = os.path.join(corpus_dir, "runs.json")
    molly_layout = os.path.exists(runs_path)
    out = MollyOutput(run_name=os.path.basename(os.path.normpath(corpus_dir)), output_dir=corpus_dir,
                      ships_spacetime_dots=molly_layout)
    expected_n = (max(positions) + 1) if positions else corpus.n_runs
    raws = _RawRuns(runs_path, expected_n) if molly_layout else _HeadRuns(corpus, positions)
    # Every RunData default, taken once from the real constructor; mutable
    # containers are copied per run.
    tmpl = RunData().__dict__
    plain = [(k, v) for k, v in tmpl.items() if not isinstance(v, (list, dict))]
    mutable = [(k, v) for k, v in tmpl.items() if isinstance(v, (list, dict))]
    sentinel = LazyRunData._SENTINEL
    iters = np.asarray(corpus.iteration)
    iters_list = iters.tolist()
    runs = []
    row = 0
    for seg in corpus.strings.segments:
        statuses = seg.meta.blob("status").rows()
        hpre_b, hpost_b = seg.meta.blob("holds_pre"), seg.meta.blob("holds_post")
        for local in range(len(statuses)):
            d = dict(plain)
            for k, v in mutable:
                d[k] = v.copy()
            d["iteration"] = iters_list[row]
            d["status"] = statuses[local].decode()
            d["_raw"] = _RawProxy(raws, positions[row] if positions else row)
            d["_lazy"] = {"failure_spec": sentinel, "model": sentinel, "messages": sentinel}
            d["_head_corpus"] = corpus
            d["_head_row"] = row
            d["_holds"] = {}
            d["_holds_blobs"] = (hpre_b, hpost_b, local)
            d["pre_prov"] = RawProv(corpus, "pre", row)
            d["post_prov"] = RawProv(corpus, "post", row)
            run = StoreRunData.__new__(StoreRunData)
            run.__dict__ = d
            runs.append(run)
            row += 1
    out.runs = runs
    # attach_run_metadata's bookkeeping, vectorized (``success`` is the
    # stored exact-"success" classification, molly.go:53).
    succ = np.asarray(corpus.success, dtype=bool)
    out.runs_iters = iters_list
    out.success_runs_iters = iters[succ].tolist()
    out.failed_runs_iters = iters[~succ].tolist()
    out.native_corpus = corpus
    return out
