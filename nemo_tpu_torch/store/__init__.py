"""The port's persistent memory-mapped corpus store (``.npack``).

A copy of the JAX package's ``store/__init__.py``:

  * ``resolve_store(arg)``: a ``CorpusStore`` over the resolved root
    (``--corpus-cache``, ``NEMO_CORPUS_CACHE``, default
    ``~/.cache/nemo_tpu_torch/corpus``), or None when ``off``.
  * ``CorpusStore.load_packed(dir)``: the warm path, a packed MollyOutput
    mapped from the store (appending the new runs first when the directory
    grew); None, logged, on a miss, a stale or a corrupt store.
  * ``CorpusStore.put(dir, molly)``: populate from either loader.

A corpus with quarantined runs stores its healthy rows and the quarantine
records (``header["quarantined"]``, each with the stats of its run's
files); a warm load puts the records back on the MollyOutput, and a
repaired file re-ingests that run as a GROWN append.  A Molly directory
grows by per-run files and runs.json; a trace-JSON one inside its one
document, which the index append reads entry by entry.  The format,
fingerprints and shard IO are in ``npack.py``, the mapping reader in
``reader.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid

from nemo_tpu_torch import obs
from nemo_tpu_torch.store.npack import (
    GROWN,
    HIT,
    NPACK_ABI_VERSION,
    NPACK_FORMAT_VERSION,
    STORE_WORKERS,
    StoreCorrupt,
    _runs_prefix_sha,
    classify_source,
    corpus_cache_dir,
    fingerprint_mode,
    head_bytes,
    payload_from_molly,
    payload_from_runs,
    quarantine_changed,
    quarantine_file_names,
    quarantine_files_from_snapshot,
    segment_fingerprint,
    segment_source_fp,
    segment_source_fp_positions,
    snapshot_source,
    snapshot_source_appended,
    source_from_snapshot,
    stored_positions,
    write_segment,
    write_vocab,
)
from nemo_tpu_torch.utils import chaos

__all__ = ["CorpusStore", "StoreCorrupt", "attach_store_provenance", "resolve_store", "store_size_bytes"]

_log = obs.log.get_logger("nemo.store")


def attach_store_provenance(obj, store_dir: str, header: dict) -> None:
    """Stamp a loaded corpus or MollyOutput with the store identity the
    result cache keys on: one ``{name, n_runs, fingerprint}`` per segment,
    in append order (the global run order)."""
    obj.store_dir = store_dir
    obj.store_segments = [
        {"name": e["name"], "n_runs": int(e["n_runs"]), "fingerprint": segment_fingerprint(e)}
        for e in header["segments"]
    ]


def _index_file(corpus_dir: str) -> str:
    """The layout's index file (ingest/adapters.py), recorded in the stored
    source so later loads classify and append by it; runs.json where no
    layout sniffs."""
    from nemo_tpu_torch.ingest.adapters import resolve_injector

    try:
        return resolve_injector(corpus_dir).index_file
    except ValueError:
        return "runs.json"


def resolve_store(arg: str | None = None) -> "CorpusStore | None":
    root = corpus_cache_dir(arg)
    return CorpusStore(root) if root else None


def store_size_bytes(store_dir: str) -> int:
    """On-disk bytes of one directory tree (stray tmp files included)."""
    return sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(store_dir) for f in fs)


#: Size cap of one corpus-store root: past it, populating evicts the least
#: recently used stores.
STORE_MAX_BYTES = 16_000_000_000


class _Lock:
    """fcntl advisory lock serializing the writers of ONE store (the lock
    file sits beside its .npack directory)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = None

    def __enter__(self):
        import fcntl

        self._fh = open(self.path, "w")
        fcntl.flock(self._fh, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        self._fh.close()
        self._fh = None


class CorpusStore:
    """One cache root holding ``.npack`` stores keyed by source realpath."""

    #: Crash leftovers older than this are swept at populate time; younger
    #: ones may belong to a live concurrent writer.
    _WRECKAGE_MAX_AGE_S = 3600.0

    def __init__(self, root: str) -> None:
        self.root = root

    def store_dir(self, corpus_dir: str) -> str:
        real = os.path.realpath(corpus_dir)
        key = hashlib.sha256(real.encode()).hexdigest()[:12]
        base = os.path.basename(real) or "corpus"
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in base)[:64]
        return os.path.join(self.root, f"{safe}-{key}.npack")

    def _lock(self, store_dir: str) -> _Lock:
        os.makedirs(self.root, exist_ok=True)
        return _Lock(f"{store_dir}.lock")

    #: _read_header's answer for a store that exists but cannot be trusted
    #: (another format/ABI, or an unreadable header): stale, not a miss.
    _HEADER_UNTRUSTED = object()

    def _read_header(self, store_dir: str):
        """dict, None (no store) or _HEADER_UNTRUSTED."""
        try:
            with open(os.path.join(store_dir, "header.json"), "r", encoding="utf-8") as fh:
                header = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as ex:
            _log.warning("store.header_unreadable", store=store_dir, error=f"{type(ex).__name__}: {ex}",
                         detail="treating the store as stale; the next populate replaces it")
            return self._HEADER_UNTRUSTED
        if header.get("format") != NPACK_FORMAT_VERSION or header.get("abi") != NPACK_ABI_VERSION:
            _log.warning(
                "store.version_mismatch", store=store_dir, format=header.get("format"), abi=header.get("abi"),
                expected_format=NPACK_FORMAT_VERSION, expected_abi=NPACK_ABI_VERSION,
            )
            return self._HEADER_UNTRUSTED
        return header

    def probe(self, corpus_dir: str) -> str:
        """'hit' / 'grown' / 'stale' / 'miss' without mapping any shard."""
        header = self._read_header(self.store_dir(corpus_dir))
        if header is None:
            return "miss"
        if header is self._HEADER_UNTRUSTED:
            return "stale"
        return classify_source(header, corpus_dir)

    # ----------------------------------------------------------------- load

    def load_packed(self, corpus_dir: str):
        """A packed MollyOutput mapped from the store, or None (miss, stale
        or corrupt; logged, never raised: the caller parses).  Its
        ``store_state`` says "hit" or "grown" (new runs appended first)."""
        return self._load(corpus_dir, build_molly=True)

    def load_corpus(self, corpus_dir: str):
        """Just the packed StoreCorpus, without the per-run MollyOutput."""
        return self._load(corpus_dir, build_molly=False)

    def _load(self, corpus_dir: str, build_molly: bool):
        with obs.span("ingest:store_load", dir=os.path.basename(corpus_dir)):
            return self._load_traced(corpus_dir, build_molly)

    def _load_traced(self, corpus_dir: str, build_molly: bool):
        from nemo_tpu_torch.store.reader import build_corpus, molly_from_corpus, open_segments

        store_dir = self.store_dir(corpus_dir)
        t0 = time.perf_counter()
        header = self._read_header(store_dir)
        if header is None:
            obs.metrics.inc("store.miss")
            return None
        if header is self._HEADER_UNTRUSTED:
            obs.metrics.inc("store.stale")
            return None
        state = classify_source(header, corpus_dir)
        grown = state == GROWN
        if grown:
            header = self._append(store_dir, header, corpus_dir)
            if header is None:
                obs.metrics.inc("store.stale")
                return None
            state = HIT
        if state != HIT:
            obs.metrics.inc("store.stale")
            _log.warning("store.stale", store=store_dir, corpus=corpus_dir,
                         detail="source fingerprint changed; falling back to the parse path")
            return None
        try:
            seg_readers, vocab_rd, mapped = open_segments(store_dir, header, verify=True)
            corpus = build_corpus(store_dir, header, seg_readers, vocab_rd)
            # A store of a quarantined or repaired corpus holds a subset of
            # the source positions, not in source order.
            pos = (stored_positions(header)
                   if header.get("quarantined") or any("positions" in s for s in header["segments"]) else None)
            out = molly_from_corpus(corpus, corpus_dir, positions=pos) if build_molly else corpus
            attach_store_provenance(corpus, store_dir, header)
            if out is not corpus:
                attach_store_provenance(out, store_dir, header)
            # The cold parse's quarantine records (report content), without
            # the watched files' stats (store bookkeeping).
            q = [{k: v for k, v in rec.items() if k != "files"} for rec in header.get("quarantined") or ()]
            if q:
                corpus.quarantined = q
                if out is not corpus:
                    out.quarantined = q
                obs.metrics.inc("ingest.quarantined", len(q))
            out.store_state = GROWN if grown else HIT
        except (StoreCorrupt, OSError, ValueError, KeyError) as ex:
            obs.metrics.inc("store.stale")
            _log.error(
                "store.corrupt", store=store_dir, corpus=corpus_dir, error=f"{type(ex).__name__}: {ex}",
                detail="falling back to the parse path; the next populate overwrites the bad store",
            )
            return None
        obs.metrics.inc("store.hit")
        obs.metrics.inc("store.bytes_mapped", mapped)
        obs.metrics.observe("store.load_s", time.perf_counter() - t0)
        try:
            # Last-use stamp for the size-cap eviction.
            os.utime(os.path.join(store_dir, "header.json"))
        except OSError:
            pass
        _log.info(
            "store.hit", corpus=corpus_dir, runs=corpus.n_runs, segments=len(header["segments"]),
            mapped_mb=round(mapped / 1e6, 1), seconds=round(time.perf_counter() - t0, 3),
        )
        return out

    # ------------------------------------------------------------- populate

    def snapshot(self, corpus_dir: str) -> dict:
        """The pre-parse source snapshot a parsing caller hands to put(), so
        a file changed during the parse mismatches on the next load."""
        return snapshot_source(corpus_dir, index_file=_index_file(corpus_dir))

    def put(self, corpus_dir: str, molly, snapshot: dict | None = None):
        """Populate (or replace) the store of ``corpus_dir`` from a parsed
        MollyOutput: its healthy rows, and its quarantine records with the
        stats of each quarantined run's files.  Returns the written header,
        or False (logged) when the write failed: populating never fails the
        caller."""
        try:
            return self._put(corpus_dir, molly, snapshot)
        except Exception as ex:  # a cache write must not fail the report
            obs.metrics.inc("store.write_failed")
            _log.warning("store.write_failed", corpus=corpus_dir, error=f"{type(ex).__name__}: {ex}")
            return False

    def _put(self, corpus_dir: str, molly, snapshot: dict | None):
        if not molly.runs:
            return False
        with obs.span("ingest:store_populate", dir=os.path.basename(corpus_dir)):
            return self._put_traced(corpus_dir, molly, snapshot)

    def _put_traced(self, corpus_dir: str, molly, snapshot: dict | None):
        t0 = time.perf_counter()
        payload = payload_from_molly(molly)
        snap = snapshot or self.snapshot(corpus_dir)
        # A quarantined run's files are watched in its record (a bad index
        # entry watches none: rewriting the index is its repair) and left
        # out of the class fingerprints, so a repair reads as GROWN.
        qrecs = [
            dict(rec, files=[] if rec.get("file") == "runs.json" else quarantine_files_from_snapshot(
                snap, rec["position"]))
            for rec in molly.quarantined or ()
        ]
        qpos = {rec["position"] for rec in qrecs}
        n_positions = payload.n_runs + len(qpos)
        source = source_from_snapshot(snap, n_positions, exclude=quarantine_file_names(qrecs))
        source["dir"] = os.path.realpath(corpus_dir)
        final = self.store_dir(corpus_dir)
        tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        try:
            seg_entry = write_segment(os.path.join(tmp, "seg-000"), payload, STORE_WORKERS)
            # Chaos kill point: the shard bytes are in tmp, the rename has
            # not published them (a SIGKILL runs no except below).
            chaos.on_store_publish()
            if qpos:
                healthy = sorted(set(range(n_positions)) - qpos)
                seg_entry["positions"] = healthy
                seg_entry["source_fp"] = segment_source_fp_positions(snap, healthy)
            else:
                seg_entry["source_fp"] = segment_source_fp(snap, 0, payload.n_runs)
            header = {
                "format": NPACK_FORMAT_VERSION,
                "abi": NPACK_ABI_VERSION,
                "source": source,
                "pre_tid": 0,
                "post_tid": 1,
                "vocab_shard": write_vocab(os.path.join(tmp, "vocab-0001.bin"), payload.vocab),
                "segments": [seg_entry],
            }
            if qrecs:
                header["quarantined"] = qrecs
            with open(os.path.join(tmp, "header.json"), "w", encoding="utf-8") as fh:
                json.dump(header, fh, indent=1)
            with self._lock(final):
                doomed = None
                if os.path.isdir(final):
                    doomed = f"{final}.doomed-{uuid.uuid4().hex[:8]}"
                    os.rename(final, doomed)
                os.rename(tmp, final)
            if doomed:
                shutil.rmtree(doomed, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._evict_over_cap(keep=final)
        obs.metrics.inc("store.populate")
        _log.info("store.populated", corpus=corpus_dir, runs=payload.n_runs, store=final,
                  seconds=round(time.perf_counter() - t0, 2))
        return header

    # ------------------------------------------------------------- eviction

    def _evict_over_cap(self, keep: str) -> None:
        """Sweep aged crash leftovers, then, past STORE_MAX_BYTES, evict
        the least recently used stores (header.json mtime, stamped on every
        hit), never the one just written.  Lock files are never removed: a
        live writer may hold one."""
        now = time.time()

        def aged(path: str) -> bool:
            try:
                return now - os.path.getmtime(path) >= self._WRECKAGE_MAX_AGE_S
            except OSError:
                return False

        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            path = os.path.join(self.root, name)
            if ".npack.tmp-" in name or ".npack.doomed-" in name:
                victims = [path]
            elif name.endswith(".npack"):
                try:
                    victims = [os.path.join(path, c) for c in os.listdir(path) if ".tmp-" in c]
                except OSError:
                    continue
            else:
                continue
            for victim in victims:
                if aged(victim):
                    (shutil.rmtree if os.path.isdir(victim) else os.remove)(victim)
                    obs.metrics.inc("store.gc_wreckage")
                    _log.info("store.gc_wreckage", path=victim)
        cap = STORE_MAX_BYTES
        stores = []
        for name in names:
            path = os.path.join(self.root, name)
            if not name.endswith(".npack") or not os.path.isdir(path):
                continue
            try:
                used = os.path.getmtime(os.path.join(path, "header.json"))
            except OSError:
                used = 0.0  # headerless wreckage goes first
            stores.append((used, store_size_bytes(path), path))
        total = sum(s for _, s, _ in stores)
        for _used, size, path in sorted(stores):
            if total <= cap:
                break
            if os.path.abspath(path) == os.path.abspath(keep):
                continue
            shutil.rmtree(path, ignore_errors=True)
            total -= size
            obs.metrics.inc("store.evicted")
            _log.info("store.evicted", store=path, freed_mb=round(size / 1e6, 1), cap_gb=round(cap / 1e9, 1))

    # --------------------------------------------------------------- append

    def _append(self, store_dir: str, header: dict, corpus_dir: str) -> dict | None:
        """The directory GREW, or a quarantined run was repaired: pack only
        the new and repaired runs against the stored vocabulary as a fresh
        segment.  Returns the new header, or None (logged; the caller
        parses) when the old entries cannot be confirmed unchanged.  A
        runs.json layout takes the per-run-file append, a single-document
        one (trace.json) the index append."""
        try:
            index_file = (header.get("source") or {}).get("index_file") or "runs.json"
            if index_file != "runs.json":
                return self._append_index_locked(store_dir, corpus_dir, index_file)
            return self._append_locked(store_dir, corpus_dir)
        except Exception as ex:
            obs.metrics.inc("store.append_failed")
            _log.warning("store.append_failed", corpus=corpus_dir, error=f"{type(ex).__name__}: {ex}")
            return None

    def _reread_grown(self, store_dir: str, corpus_dir: str):
        """Under the lock: the header as another appender may have left it;
        returned with "hit" when nothing is left to append, None when the
        store cannot be appended to."""
        header = self._read_header(store_dir)
        if not isinstance(header, dict):
            return None, None
        state = classify_source(header, corpus_dir)
        return (header, state) if state in (HIT, GROWN) else (None, None)

    @staticmethod
    def _stored_vocab(vocab_rd):
        """The stored vocabulary, to be extended in place by the new graphs
        ("pre"/"post" re-intern to their pinned 0/1)."""
        from nemo_tpu_torch.graphs.packed import CorpusVocab
        from nemo_tpu_torch.store.reader import decode_vocab

        vocab = CorpusVocab()
        for part in ("tables", "labels", "times"):
            v = getattr(vocab, part)
            for s in decode_vocab(vocab_rd, part):
                v.intern(s)
        return vocab

    def _commit_append(self, store_dir: str, corpus_dir: str, header: dict, snap: dict, n_total: int,
                       vocab, new_runs: list, new_positions: list[int], final_q: list[dict], changed: bool,
                       exclude: set) -> dict | None:
        """Write the new runs' segment (positions listed unless it is the
        plain contiguous tail), a new vocab generation and the header; with
        no new run, only the source and the quarantine records change.
        None when nothing changed."""
        n_old = int(header["source"]["n_runs"])
        seg_name = f"seg-{len(header['segments']):03d}"
        segments = header["segments"]
        if new_runs:
            tmp_seg = os.path.join(store_dir, f"{seg_name}.tmp-{uuid.uuid4().hex[:8]}")
            try:
                seg_entry = write_segment(tmp_seg, payload_from_runs(new_runs, vocab), STORE_WORKERS)
                seg_entry["name"] = seg_name
                seg_entry["source_fp"] = segment_source_fp_positions(snap, new_positions)
                if final_q or header.get("quarantined") or new_positions != list(
                    range(n_old, n_old + len(new_positions))
                ):
                    seg_entry["positions"] = list(new_positions)
                os.rename(tmp_seg, os.path.join(store_dir, seg_name))
            except BaseException:
                shutil.rmtree(tmp_seg, ignore_errors=True)
                raise
            segments = segments + [seg_entry]
            # A new vocab generation: the old file stays for readers of the
            # old header.
            vshard = write_vocab(os.path.join(store_dir, f"vocab-{len(segments):04d}.bin"), vocab)
        elif not changed:
            return None
        else:
            vshard = header["vocab_shard"]
        source = source_from_snapshot(snap, n_total, exclude=exclude)
        source["dir"] = os.path.realpath(corpus_dir)
        header = dict(header, source=source, vocab_shard=vshard, segments=segments)
        header["quarantined"] = final_q
        if not final_q:
            header.pop("quarantined")
        # The commit point: the header swap.
        tmp_header = os.path.join(store_dir, f"header.json.tmp-{uuid.uuid4().hex[:8]}")
        with open(tmp_header, "w", encoding="utf-8") as fh:
            json.dump(header, fh, indent=1)
        os.replace(tmp_header, os.path.join(store_dir, "header.json"))
        obs.metrics.inc("store.append")
        _log.info(
            "store.appended", corpus=corpus_dir, new_runs=len(new_runs),
            repaired=sum(p < n_old for p in new_positions), quarantined=len(final_q), total_runs=n_total,
            segment=seg_name if new_runs else None,
        )
        return header

    def _append_locked(self, store_dir: str, corpus_dir: str) -> dict | None:
        from nemo_tpu_torch.ingest.datatypes import RunData
        from nemo_tpu_torch.ingest.molly import load_run_prov, quarantine_record
        from nemo_tpu_torch.store.reader import build_corpus, open_segments
        from nemo_tpu_torch.utils.env import quarantine_enabled

        with self._lock(store_dir), obs.span("ingest:store_append", dir=os.path.basename(corpus_dir)):
            header, state = self._reread_grown(store_dir, corpus_dir)
            if state == HIT or header is None:
                return header
            src = header["source"]
            n_old = int(src["n_runs"])
            # Repair candidates: quarantined positions whose watched files
            # changed; re-ingested beside the appended tail.
            qrecs_old = list(header.get("quarantined") or ())
            repair_pos = {int(r["position"]) for r in quarantine_changed(corpus_dir, qrecs_old)}
            # Snapshot before parsing: a file changed during the tail parse
            # then mismatches the published fingerprint (fail-safe).
            snap = (
                snapshot_source(corpus_dir)
                if fingerprint_mode() == "full"
                else snapshot_source_appended(corpus_dir, n_old, extra_positions=repair_pos)
            )
            with open(os.path.join(corpus_dir, "runs.json"), "r", encoding="utf-8") as fh:
                raw_runs = json.load(fh)
            if len(raw_runs) < n_old or (len(raw_runs) == n_old and not repair_pos):
                return None
            seg_readers, vocab_rd, _ = open_segments(store_dir, header, verify=False)
            # Old-entry check: the byte prefix of runs.json when its
            # serializer is stable; else every stored row's iteration and
            # status, plus the whole head fragment of a <= 64-row spread.
            strong = src.get("runs_prefix_sha") and _runs_prefix_sha(
                corpus_dir, (src.get("runs_json") or [0])[0]
            ) == src.get("runs_prefix_sha")
            if not strong:
                old = build_corpus(store_dir, header, seg_readers, vocab_rd)
                rows_pos = stored_positions(header)
                for row, pos in enumerate(rows_pos):
                    r = raw_runs[pos]
                    if int(r.get("iteration", 0)) != int(old.iteration[row]) or (
                        (r.get("status", "") == "success") != bool(old.success[row])
                    ):
                        _log.warning("store.append_refused", corpus=corpus_dir, row=pos,
                                     detail="runs.json entry changed")
                        return None
                n_stored = len(rows_pos)
                stride = max(1, n_stored // 64)
                for row in sorted(set(range(0, n_stored, stride)) | {0, n_stored - 1}):
                    if head_bytes(RunData.from_json(raw_runs[rows_pos[row]])) != old.run_head_json(row):
                        _log.warning("store.append_refused", corpus=corpus_dir, row=rows_pos[row],
                                     detail="head of the run changed")
                        return None
            vocab = self._stored_vocab(vocab_rd)
            # Each candidate parses under the loader's per-run quarantine: a
            # malformed one joins (or stays in) the quarantine.
            quarantine = quarantine_enabled()
            new_runs, new_positions, new_q = [], [], []
            for pos in sorted(repair_pos | set(range(n_old, len(raw_runs)))):
                try:
                    run = RunData.from_json(raw_runs[pos])
                except Exception as ex:
                    if not quarantine:
                        return None
                    new_q.append(quarantine_record(pos, None, "runs.json", ex))
                    continue
                try:
                    load_run_prov(corpus_dir, pos, run)
                except Exception as ex:
                    if not quarantine:
                        return None
                    cond = "post" if run.pre_prov is not None else "pre"
                    new_q.append(quarantine_record(pos, run.iteration, f"run_{pos}_{cond}_provenance.json", ex))
                    continue
                new_runs.append(run)
                new_positions.append(pos)
            for rec in new_q:
                rec["files"] = [] if rec["file"] == "runs.json" else quarantine_files_from_snapshot(
                    snap, rec["position"])
                obs.metrics.inc("ingest.quarantined")
            kept_q = [r for r in qrecs_old if int(r["position"]) not in repair_pos]
            final_q = sorted(kept_q + new_q, key=lambda r: int(r["position"]))
            return self._commit_append(store_dir, corpus_dir, header, snap, len(raw_runs), vocab, new_runs,
                                       new_positions, final_q, bool(new_q or repair_pos),
                                       quarantine_file_names(final_q))

    def _append_index_locked(self, store_dir: str, corpus_dir: str, index_file: str) -> dict | None:
        """The index append of a single-document layout (trace.json): the
        sweep grows inside the document, so the injector's ``index_runs``
        re-reads it; every stored row's identity pair and the head fragment
        of a <= 64-row spread must be unchanged, and only the entries past
        the stored count (and every quarantined one: a single document has
        no per-file repair tripwire) are packed into a fresh segment."""
        from nemo_tpu_torch.ingest.adapters import INJECTORS
        from nemo_tpu_torch.ingest.molly import quarantine_record
        from nemo_tpu_torch.store.reader import build_corpus, open_segments
        from nemo_tpu_torch.utils.env import quarantine_enabled

        inj = next((c for c in INJECTORS.values() if c.index_file == index_file), None)
        if inj is None:
            return None
        with self._lock(store_dir), obs.span("ingest:store_append", dir=os.path.basename(corpus_dir)):
            header, state = self._reread_grown(store_dir, corpus_dir)
            if state == HIT or header is None:
                return header
            n_old = int(header["source"]["n_runs"])
            snap = (
                snapshot_source(corpus_dir, index_file=index_file)
                if fingerprint_mode() == "full"
                else snapshot_source_appended(corpus_dir, n_old, index_file=index_file)
            )
            n_total, parse_entry, entry_head = inj.index_runs(corpus_dir)
            q_old_pos = {int(r["position"]) for r in header.get("quarantined") or ()}
            if n_total < n_old or (n_total == n_old and not q_old_pos):
                return None
            seg_readers, vocab_rd, _ = open_segments(store_dir, header, verify=False)
            old = build_corpus(store_dir, header, seg_readers, vocab_rd)
            rows_pos = stored_positions(header)
            n_stored = len(rows_pos)
            try:
                for row, pos in enumerate(rows_pos):
                    it, success = entry_head(pos)
                    if it != int(old.iteration[row]) or success != bool(old.success[row]):
                        _log.warning("store.append_refused", corpus=corpus_dir, row=pos,
                                     detail=f"{index_file} entry changed")
                        return None
                stride = max(1, n_stored // 64)
                for row in sorted(set(range(0, n_stored, stride)) | {0, n_stored - 1}):
                    if head_bytes(parse_entry(rows_pos[row])) != old.run_head_json(row):
                        _log.warning("store.append_refused", corpus=corpus_dir, row=rows_pos[row],
                                     detail="head of the run changed")
                        return None
            except Exception as ex:
                _log.warning("store.append_refused", corpus=corpus_dir,
                             detail=f"a stored {index_file} entry no longer parses ({type(ex).__name__}: {ex})")
                return None
            vocab = self._stored_vocab(vocab_rd)
            quarantine = quarantine_enabled()
            new_runs, new_positions, new_q = [], [], []
            for pos in sorted(q_old_pos | set(range(n_old, n_total))):
                try:
                    run = parse_entry(pos)
                except Exception as ex:
                    if not quarantine:
                        return None
                    try:
                        rid = entry_head(pos)[0]
                    except Exception:  # the entry is quarantined either way; the id only names it
                        rid = None
                    new_q.append(dict(quarantine_record(pos, rid, index_file, ex), files=[]))
                    obs.metrics.inc("ingest.quarantined")
                    continue
                new_runs.append(run)
                new_positions.append(pos)
            return self._commit_append(store_dir, corpus_dir, header, snap, n_total, vocab, new_runs,
                                       new_positions, new_q, bool(new_q), set())
