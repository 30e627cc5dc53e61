"""The port's persistent memory-mapped corpus store (``.npack``).

A copy of the JAX package's ``store/__init__.py`` for the Molly layout:

  * ``resolve_store(arg)``: a ``CorpusStore`` over the resolved root
    (``--corpus-cache``, ``NEMO_CORPUS_CACHE``, default
    ``~/.cache/nemo_tpu_torch/corpus``), or None when ``off``.
  * ``CorpusStore.load_packed(dir)``: the warm path, a packed MollyOutput
    mapped from the store (appending the new runs first when the directory
    grew); None, logged, on a miss, a stale or a corrupt store.
  * ``CorpusStore.put(dir, molly)``: populate from either loader.

A corpus with quarantined runs is not stored (``put`` returns False and
logs it): the port's store keeps no quarantine bookkeeping.  The format,
fingerprints and shard IO are in ``npack.py``, the mapping reader in
``reader.py``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
import uuid

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
    segment_fingerprint,
    segment_source_fp,
    snapshot_source,
    snapshot_source_appended,
    source_from_snapshot,
    write_segment,
    write_vocab,
)

__all__ = ["CorpusStore", "StoreCorrupt", "attach_store_provenance", "resolve_store", "store_size_bytes"]

_log = logging.getLogger("nemo_tpu_torch.store")


def attach_store_provenance(obj, store_dir: str, header: dict) -> None:
    """Stamp a loaded corpus or MollyOutput with the store identity the
    result cache keys on: one ``{name, n_runs, fingerprint}`` per segment,
    in append order (the global run order)."""
    obj.store_dir = store_dir
    obj.store_segments = [
        {"name": e["name"], "n_runs": int(e["n_runs"]), "fingerprint": segment_fingerprint(e)}
        for e in header["segments"]
    ]


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
            _log.warning("store header of %s unreadable (%s: %s); stale", store_dir, type(ex).__name__, ex)
            return self._HEADER_UNTRUSTED
        if header.get("format") != NPACK_FORMAT_VERSION or header.get("abi") != NPACK_ABI_VERSION:
            _log.warning(
                "store %s has format %s abi %s, expected %s/%s; stale",
                store_dir, header.get("format"), header.get("abi"), NPACK_FORMAT_VERSION, NPACK_ABI_VERSION,
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
        from nemo_tpu_torch.store.reader import build_corpus, molly_from_corpus, open_segments

        store_dir = self.store_dir(corpus_dir)
        t0 = time.perf_counter()
        header = self._read_header(store_dir)
        if not isinstance(header, dict):
            return None
        state = classify_source(header, corpus_dir)
        grown = state == GROWN
        if grown:
            header = self._append(store_dir, corpus_dir)
            if header is None:
                return None
            state = HIT
        if state != HIT:
            _log.warning("store %s is stale for %s (source changed); parsing", store_dir, corpus_dir)
            return None
        try:
            seg_readers, vocab_rd, mapped = open_segments(store_dir, header, verify=True)
            corpus = build_corpus(store_dir, header, seg_readers, vocab_rd)
            out = molly_from_corpus(corpus, corpus_dir) if build_molly else corpus
            attach_store_provenance(corpus, store_dir, header)
            if out is not corpus:
                attach_store_provenance(out, store_dir, header)
            out.store_state = GROWN if grown else HIT
        except (StoreCorrupt, OSError, ValueError, KeyError) as ex:
            _log.error(
                "store %s is corrupt (%s: %s); parsing, and the next populate replaces it",
                store_dir, type(ex).__name__, ex,
            )
            return None
        try:
            # Last-use stamp for the size-cap eviction.
            os.utime(os.path.join(store_dir, "header.json"))
        except OSError:
            pass
        _log.info(
            "store hit %s: %d runs, %d segments, %.1f MB mapped in %.3f s",
            corpus_dir, corpus.n_runs, len(header["segments"]), mapped / 1e6, time.perf_counter() - t0,
        )
        return out

    # ------------------------------------------------------------- populate

    def snapshot(self, corpus_dir: str) -> dict:
        """The pre-parse source snapshot a parsing caller hands to put(), so
        a file changed during the parse mismatches on the next load."""
        return snapshot_source(corpus_dir)

    def put(self, corpus_dir: str, molly, snapshot: dict | None = None):
        """Populate (or replace) the store of ``corpus_dir`` from a parsed
        MollyOutput.  Returns the written header, or False (logged) when
        the corpus has quarantined runs or the write failed: populating
        never fails the caller."""
        if getattr(molly, "quarantined", None):
            _log.warning(
                "corpus %s has %d quarantined runs; not stored (the port's store keeps healthy corpora only)",
                corpus_dir, len(molly.quarantined),
            )
            return False
        try:
            return self._put(corpus_dir, molly, snapshot)
        except Exception as ex:  # a cache write must not fail the report
            _log.warning("store write for %s failed: %s: %s", corpus_dir, type(ex).__name__, ex)
            return False

    def _put(self, corpus_dir: str, molly, snapshot: dict | None):
        if not molly.runs:
            return False
        t0 = time.perf_counter()
        payload = payload_from_molly(molly)
        snap = snapshot or snapshot_source(corpus_dir)
        source = source_from_snapshot(snap, payload.n_runs)
        source["dir"] = os.path.realpath(corpus_dir)
        final = self.store_dir(corpus_dir)
        tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        try:
            seg_entry = write_segment(os.path.join(tmp, "seg-000"), payload, STORE_WORKERS)
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
        _log.info("store populated %s: %d runs in %.2f s", final, payload.n_runs, time.perf_counter() - t0)
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
            _log.info("store evicted %s (%.1f MB) to stay under %.1f GB", path, size / 1e6, cap / 1e9)

    # --------------------------------------------------------------- append

    def _append(self, store_dir: str, corpus_dir: str) -> dict | None:
        """The directory GREW: pack only the new runs (the Python loader)
        against the stored vocabulary as a fresh segment.  Returns the new
        header, or None (logged; the caller parses) when the old entries
        cannot be confirmed unchanged or a new run fails to parse."""
        try:
            return self._append_locked(store_dir, corpus_dir)
        except Exception as ex:
            _log.warning("store append for %s failed (%s: %s); parsing", corpus_dir, type(ex).__name__, ex)
            return None

    def _append_locked(self, store_dir: str, corpus_dir: str) -> dict | None:
        from nemo_tpu_torch.graphs.packed import CorpusVocab
        from nemo_tpu_torch.ingest.datatypes import RunData
        from nemo_tpu_torch.ingest.molly import load_run_prov
        from nemo_tpu_torch.store.reader import build_corpus, decode_vocab, open_segments

        with self._lock(store_dir):
            # Re-read under the lock: a concurrent appender may have won.
            header = self._read_header(store_dir)
            if not isinstance(header, dict):
                return None
            state = classify_source(header, corpus_dir)
            if state == HIT:
                return header
            if state != GROWN:
                return None
            src = header["source"]
            n_old = int(src["n_runs"])
            # Snapshot before parsing: a file changed during the tail parse
            # then mismatches the published fingerprint (fail-safe).
            snap = (
                snapshot_source(corpus_dir)
                if fingerprint_mode() == "full"
                else snapshot_source_appended(corpus_dir, n_old)
            )
            with open(os.path.join(corpus_dir, "runs.json"), "r", encoding="utf-8") as fh:
                raw_runs = json.load(fh)
            if len(raw_runs) <= n_old:
                return None
            seg_readers, vocab_rd, _ = open_segments(store_dir, header, verify=False)
            # Old-entry check: the byte prefix of runs.json when its
            # serializer is stable; else every old entry's iteration and
            # status, plus the whole head fragment of a <= 64-entry spread.
            strong = src.get("runs_prefix_sha") and _runs_prefix_sha(
                corpus_dir, (src.get("runs_json") or [0])[0]
            ) == src.get("runs_prefix_sha")
            if not strong:
                old = build_corpus(store_dir, header, seg_readers, vocab_rd)
                for row in range(n_old):
                    r = raw_runs[row]
                    if int(r.get("iteration", 0)) != int(old.iteration[row]) or (
                        (r.get("status", "") == "success") != bool(old.success[row])
                    ):
                        _log.warning("store append refused for %s: runs.json entry %d changed", corpus_dir, row)
                        return None
                stride = max(1, n_old // 64)
                for row in sorted(set(range(0, n_old, stride)) | {0, n_old - 1}):
                    if head_bytes(RunData.from_json(raw_runs[row])) != old.run_head_json(row):
                        _log.warning("store append refused for %s: head of run row %d changed", corpus_dir, row)
                        return None
            # The stored vocabulary, extended in place by the new graphs.
            vocab = CorpusVocab()
            for part in ("tables", "labels", "times"):
                v = getattr(vocab, part)
                for s in decode_vocab(vocab_rd, part):
                    v.intern(s)
            new_runs = []
            for pos in range(n_old, len(raw_runs)):
                run = RunData.from_json(raw_runs[pos])
                load_run_prov(corpus_dir, pos, run)
                new_runs.append(run)
            seg_name = f"seg-{len(header['segments']):03d}"
            tmp_seg = os.path.join(store_dir, f"{seg_name}.tmp-{uuid.uuid4().hex[:8]}")
            try:
                seg_entry = write_segment(tmp_seg, payload_from_runs(new_runs, vocab), STORE_WORKERS)
                seg_entry["name"] = seg_name
                seg_entry["source_fp"] = segment_source_fp(snap, n_old, len(raw_runs))
                os.rename(tmp_seg, os.path.join(store_dir, seg_name))
            except BaseException:
                shutil.rmtree(tmp_seg, ignore_errors=True)
                raise
            segments = header["segments"] + [seg_entry]
            # A new vocab generation (the old file stays for readers of the
            # old header), then the commit point: the header swap.
            vshard = write_vocab(os.path.join(store_dir, f"vocab-{len(segments):04d}.bin"), vocab)
            source = source_from_snapshot(snap, len(raw_runs))
            source["dir"] = os.path.realpath(corpus_dir)
            header = dict(header, source=source, vocab_shard=vshard, segments=segments)
            tmp_header = os.path.join(store_dir, f"header.json.tmp-{uuid.uuid4().hex[:8]}")
            with open(tmp_header, "w", encoding="utf-8") as fh:
                json.dump(header, fh, indent=1)
            os.replace(tmp_header, os.path.join(store_dir, "header.json"))
        _log.info(
            "store appended %s: %d new runs as %s, %d in all", corpus_dir, len(new_runs), seg_name, len(raw_runs)
        )
        return header
