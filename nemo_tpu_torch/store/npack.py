"""The ``.npack`` corpus store format: parse once, memory-map after.

A copy of the JAX package's ``store/npack.py``.  A store persists exactly
what the ETL produces:

  * the packed ``[B,V]``/``[B,E]`` arrays of both conditions (the native
    engine's padding: -1 table/label/time ids, 0 type and edge ids, False
    masks) and the per-run ``n_nodes``/``n_goals``/``chain_linear``,
  * the corpus vocabularies ("pre"/"post" pinned to table ids 0/1),
  * the per-run strings the report splices verbatim: namespaced provenance
    JSON, the debugging.json head fragment, the joined node ids, the
    status and the holds-map keys,

so a warm load is ``np.memmap`` of each shard plus a small JSON header, and
the loaded MollyOutput is interchangeable with the packed-first loader's
(``ingest/native.py:load_molly_output_packed``).  Loading needs no C++.

Layout (one directory per source corpus, keyed by its realpath)::

    <root>/<basename>-<hash12>.npack/
      header.json            format/ABI versions, source fingerprint,
                             segment and shard manifests (offsets, checksums)
      vocab-<n>.bin          tables/labels/times (a new generation per
                             append; old ones stay for in-flight readers)
      seg-000/
        arrays_pre.bin       the 12 packed arrays of the pre condition
        arrays_post.bin      ... and of the post condition
        runs.bin             iteration / success
        meta.bin             status, holds-key and head-fragment blobs
        strings_pre_000.bin  prov JSON and node-id blobs, chunked by rows
        strings_post_000.bin   so the shards are written in parallel
      seg-001/ ...           appended segments (a grown sweep)

Integrity and invalidation: every shard carries a CRC32 (checked on every
load) and a SHA-256; the header records a
fingerprint of the directory's file names, sizes and mtimes, split into
old-run / other / new-run classes so a GROWN directory (runs appended) is
told from a STALE one.  The layout's index file (``runs.json``, or
``trace.json`` for the trace-JSON layout, ingest/adapters.py) is compared
apart, by its stat.  A quarantined run's files are left out of the class
fingerprints and watched one by one in its record in the header
(``quarantined``): a repaired file reads as GROWN.  Version, fingerprint and checksum mismatches all
fall back, logged, to the parse path.  The default ``fast`` fingerprint
catches every entry added, removed or renamed and any change to runs.json,
the directory mtime or a <= 64-file stat sample; an in-place rewrite of one
unsampled provenance file is outside it (``NEMO_STORE_FINGERPRINT=full``
stats every file).

Appending packs only the new runs (and the repaired quarantined ones)
against the stored vocabulary as a fresh segment and swaps the header
atomically; such a segment lists the source positions of its rows.  Writers
serialize on an ``fcntl`` lock and publish by rename; readers never lock.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from dataclasses import dataclass

import numpy as np

#: On-disk layout version: bump when the shard/region/blob encoding changes.
NPACK_FORMAT_VERSION = 1
#: Content ABI: what is persisted (array set, string blobs, padding); moves
#: with the native engine's ABI.
NPACK_ABI_VERSION = 5

_ALIGN = 64

#: Region set of one condition's shard, in NativeCondBatch field order.
_COND_ARRAYS = (
    ("table_id", "bv"),
    ("label_id", "bv"),
    ("time_id", "bv"),
    ("type_id", "bv"),
    ("is_goal", "bv"),
    ("node_mask", "bv"),
    ("edge_src", "be"),
    ("edge_dst", "be"),
    ("edge_mask", "be"),
    ("n_nodes", "b"),
    ("n_goals", "b"),
    ("chain_linear", "b"),
)


# ---------------------------------------------------------------------------
# roots and workers
# ---------------------------------------------------------------------------


def corpus_cache_dir(arg: str | None = None) -> str | None:
    """The corpus store root: ``arg``, else ``NEMO_CORPUS_CACHE``, else
    ``~/.cache/nemo_tpu_torch/corpus``; ``off`` disables (None)."""
    from nemo_tpu_torch.utils.env import cache_root

    return cache_root(arg, "NEMO_CORPUS_CACHE", "corpus")


def _store_workers() -> int:
    """Parallel shard writers: min(8, the cores this process may run on).
    Threads: the payloads are shared numpy arrays, and writes and hashing
    release the GIL."""
    try:
        cores = len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    return max(1, min(8, cores))


#: The shard writers' thread count.
STORE_WORKERS = _store_workers()


# ---------------------------------------------------------------------------
# shard files: aligned regions + checksums
# ---------------------------------------------------------------------------


def _blob_regions(name: str, rows: list[bytes]) -> list[tuple[str, np.ndarray]]:
    """A variable-length string column as two regions: int64 row offsets
    [n+1] and the concatenated bytes."""
    offs = np.zeros(len(rows) + 1, dtype=np.int64)
    if rows:
        np.cumsum([len(r) for r in rows], out=offs[1:])
    data = np.frombuffer(b"".join(rows), dtype=np.uint8)
    return [(f"{name}.offsets", offs), (f"{name}.bytes", data)]


def write_shard(path: str, regions: list[tuple[str, np.ndarray]]) -> dict:
    """Write one shard file (64-byte aligned raw regions) and return its
    manifest ``{file, nbytes, crc32, sha256, regions}``; the checksums cover
    the whole file, padding included."""
    crc = 0
    sha = hashlib.sha256()
    manifest: list[dict] = []
    pos = 0
    with open(path, "wb") as fh:

        def emit(buf) -> None:
            nonlocal crc, pos
            fh.write(buf)
            crc = zlib.crc32(buf, crc)
            sha.update(buf)
            pos += len(buf)

        for name, arr in regions:
            arr = np.ascontiguousarray(arr)
            pad = -pos % _ALIGN
            if pad:
                emit(b"\0" * pad)
            manifest.append({"name": name, "dtype": arr.dtype.name, "shape": list(arr.shape), "offset": pos})
            emit(memoryview(arr).cast("B"))
    return {
        "file": os.path.basename(path),
        "nbytes": pos,
        "crc32": crc & 0xFFFFFFFF,
        "sha256": sha.hexdigest(),
        "regions": manifest,
    }


class StoreCorrupt(RuntimeError):
    """A store exists but cannot be trusted (checksum, size, structure)."""


class ShardReader:
    """One memory-mapped shard: zero-copy region views over the file."""

    def __init__(self, path: str, manifest: dict) -> None:
        self.path = path
        self.manifest = manifest
        self.nbytes = int(manifest["nbytes"])
        # np.memmap refuses zero-length files.
        self._mm = np.memmap(path, dtype=np.uint8, mode="r") if self.nbytes else np.zeros(0, np.uint8)
        if self._mm.size != self.nbytes:
            raise StoreCorrupt(f"{path}: size {self._mm.size} != manifest nbytes {self.nbytes}")
        self._by_name = {r["name"]: r for r in manifest["regions"]}
        self._blobs: dict[str, BlobView] = {}

    def verify(self) -> None:
        """CRC32 over the whole file."""
        crc = zlib.crc32(memoryview(self._mm)) & 0xFFFFFFFF
        if crc != int(self.manifest["crc32"]):
            raise StoreCorrupt(f"{self.path}: crc32 {crc:#010x} != manifest {int(self.manifest['crc32']):#010x}")

    def region(self, name: str) -> np.ndarray:
        r = self._by_name[name]
        dtype = np.dtype(r["dtype"])
        shape = tuple(r["shape"])
        n = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
        off = int(r["offset"])
        if off + n > self.nbytes:
            raise StoreCorrupt(f"{self.path}: region {name} overruns the file")
        return self._mm[off : off + n].view(dtype).reshape(shape)

    def blob(self, name: str) -> "BlobView":
        # Memoized per column: the report reads one provenance blob per run.
        view = self._blobs.get(name)
        if view is None:
            view = self._blobs[name] = BlobView(self.region(f"{name}.offsets"), self.region(f"{name}.bytes"))
        return view


class BlobView:
    """Row accessor over an (offsets, bytes) blob pair."""

    __slots__ = ("offsets", "data", "_offs")

    def __init__(self, offsets: np.ndarray, data: np.ndarray) -> None:
        self.offsets = offsets
        self.data = data
        self._offs = None  # the offsets, copied off the mmap on first row

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def row(self, i: int) -> bytes:
        # Per-row memmap scalar indexing costs microseconds of numpy
        # dispatch; one in-memory copy of the small offsets column makes
        # every later row a plain index.  The payload stays mapped.
        if self._offs is None:
            self._offs = np.array(self.offsets)
        o0, o1 = int(self._offs[i]), int(self._offs[i + 1])
        return self.data[o0:o1].tobytes()

    def rows(self) -> list[bytes]:
        """Every row, from one bulk read."""
        buf = self.data.tobytes()
        offs = self.offsets.tolist()
        return [buf[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]


# ---------------------------------------------------------------------------
# source fingerprinting
# ---------------------------------------------------------------------------

#: Per-file stat budget of the fast fingerprint check.
_SAMPLE_FILES = 64

HIT, GROWN, STALE = "hit", "grown", "stale"


def _select_sample(entries: list) -> list:
    """The deterministic <= _SAMPLE_FILES spread every fingerprint sample
    uses: an even stride over ``sorted(entries)`` plus the last one."""
    base = sorted(entries)
    stride = max(1, len(base) // _SAMPLE_FILES)
    sample = base[::stride][:_SAMPLE_FILES]
    if base and base[-1] not in sample:
        sample.append(base[-1])
    return sample


def fingerprint_mode() -> str:
    """``fast`` (default): a load compares file NAMES, runs.json's stat and
    the stored stat sample.  ``NEMO_STORE_FINGERPRINT=full``: every file's
    size and mtime.  Populate-time fingerprints always stat every file;
    append-time snapshots follow the mode (a fast append publishes no
    per-class stat fingerprints, so a later full-mode load repopulates)."""
    return "full" if os.environ.get("NEMO_STORE_FINGERPRINT", "").strip().lower() == "full" else "fast"


def _fp(lines: list[str]) -> str:
    return hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()


def _run_index(name: str) -> str:
    """The ``<i>`` of a ``run_<i>_*`` file name, else ""."""
    if not name.startswith("run_"):
        return ""
    cut = name.find("_", 4)
    idx = name[4:cut] if cut > 4 else ""
    return idx if idx.isdigit() else ""


def _runs_prefix_sha(corpus_dir: str, nbytes: int, index_file: str = "runs.json") -> str | None:
    """SHA-256 of the index file's first ``nbytes - 1`` bytes: a stable
    serializer that appends entries keeps it, the strong old-entry check of
    a runs.json append (a single-document layout rewrites its tail on
    growth, so its append never trusts it)."""
    try:
        sha = hashlib.sha256()
        remaining = max(0, nbytes - 1)
        with open(os.path.join(corpus_dir, index_file), "rb") as fh:
            while remaining:
                chunk = fh.read(min(1 << 20, remaining))
                if not chunk:
                    return None
                sha.update(chunk)
                remaining -= len(chunk)
        return sha.hexdigest()
    except OSError:
        return None


def snapshot_source(corpus_dir: str, with_stats: bool = True, index_file: str = "runs.json") -> dict:
    """(name, size, mtime_ns) of every file of the sweep directory, taken
    BEFORE a writer parses it, so a file changed during the parse mismatches
    on the next load.  The index file (runs.json or trace.json), which
    changes on append, is kept apart, and its name recorded."""
    dir_mtime_ns = os.stat(corpus_dir).st_mtime_ns
    entries: list[tuple[str, int, int]] = []
    runs_json: list[int] | None = None
    with os.scandir(corpus_dir) as it:
        for entry in it:
            if entry.name == index_file:
                st = entry.stat()
                runs_json = [st.st_size, st.st_mtime_ns]
                continue
            if not entry.is_file(follow_symlinks=True):
                continue
            if with_stats:
                st = entry.stat()
                entries.append((entry.name, st.st_size, st.st_mtime_ns))
            else:
                entries.append((entry.name, 0, 0))
    return {
        "dir_mtime_ns": dir_mtime_ns,
        "runs_json": runs_json,
        "index_file": index_file,
        "entries": entries,
        "with_stats": with_stats,
        "runs_prefix_sha": _runs_prefix_sha(corpus_dir, (runs_json or [0])[0], index_file) if with_stats else None,
    }


def snapshot_source_appended(corpus_dir: str, n_old: int, extra_positions: set | None = None,
                             index_file: str = "runs.json") -> dict:
    """Partial pre-parse snapshot for an append in ``fast`` mode: names of
    every file, stats only of the index file, the new runs' files
    (positions >= ``n_old``, their segment's source fingerprint), the
    repaired quarantined positions (``extra_positions``) and the stat
    sample, so the append costs in proportion to the growth, not the
    corpus."""
    dir_mtime_ns = os.stat(corpus_dir).st_mtime_ns
    entries: list[tuple] = []
    runs_json: list[int] | None = None
    with os.scandir(corpus_dir) as it:
        for entry in it:
            if entry.name == index_file:
                st = entry.stat()
                runs_json = [st.st_size, st.st_mtime_ns]
                continue
            if not entry.is_file(follow_symlinks=True):
                continue
            idx = _run_index(entry.name)
            if idx and (int(idx) >= n_old or (extra_positions and int(idx) in extra_positions)):
                st = entry.stat()
                entries.append((entry.name, st.st_size, st.st_mtime_ns))
            else:
                entries.append((entry.name, None, None))
    sampled: list[list] = []
    for name, size, mtime_ns in _select_sample(entries):
        if size is None:
            st = os.stat(os.path.join(corpus_dir, name))
            size, mtime_ns = st.st_size, st.st_mtime_ns
        sampled.append([name, size, mtime_ns])
    return {
        "dir_mtime_ns": dir_mtime_ns,
        "runs_json": runs_json,
        "index_file": index_file,
        "entries": entries,
        "with_stats": False,
        "sample": sampled,
        "runs_prefix_sha": _runs_prefix_sha(corpus_dir, (runs_json or [0])[0], index_file),
    }


def source_from_snapshot(snap: dict, n_old: int, exclude: set | None = None) -> dict:
    """Snapshot -> fingerprint dict, classed so GROWN is told from STALE:
    ``old`` run_<i>_* files with i < n_old, ``new`` those with i >= n_old,
    ``other`` every other file but the index file (compared separately, its
    name recorded when it is not runs.json).  Per class a names-only
    fingerprint and, when the snapshot has stats, a stat fingerprint;
    ``sample`` is the stat sample of old + other.  ``exclude`` (the
    quarantined runs' files) leaves files out of every class and the
    sample: their repair must read as GROWN, not STALE."""
    exclude = exclude or frozenset()
    classes: dict[str, list] = {"old": [], "new": [], "other": []}
    for rec in snap["entries"]:
        if rec[0] in exclude:
            continue
        idx = _run_index(rec[0])
        if idx:
            classes["old" if int(idx) < n_old else "new"].append(rec)
        else:
            classes["other"].append(rec)
    with_stats = snap.get("with_stats", True)
    out: dict = {
        "runs_json": snap["runs_json"],
        "n_new_files": len(classes["new"]),
        "dir_mtime_ns": snap["dir_mtime_ns"],
        "n_runs": n_old,
        "runs_prefix_sha": snap.get("runs_prefix_sha"),
    }
    if (snap.get("index_file") or "runs.json") != "runs.json":
        out["index_file"] = snap["index_file"]
    for cls, recs in classes.items():
        out[f"{cls}_names_fp"] = _fp([n for n, _, _ in recs])
        if with_stats:
            out[f"{cls}_fp"] = _fp([f"{n}\0{s}\0{t}" for n, s, t in recs])
    if with_stats:
        out["sample"] = [list(rec) for rec in _select_sample(classes["old"] + classes["other"])]
    elif snap.get("sample") is not None:
        out["sample"] = [list(rec) for rec in snap["sample"] if rec[0] not in exclude]
    return out


def segment_source_fp(snapshot: dict, lo: int, hi: int) -> str:
    """Fingerprint of the source files of run positions [lo, hi): names and
    stats of the ``run_<pos>_*`` files.  Part of a segment's identity for
    the result cache: the hazard figures read the spacetime DOTs, which the
    packed arrays do not mirror."""
    lines = []
    for rec in snapshot["entries"]:
        idx = _run_index(rec[0])
        if idx and lo <= int(idx) < hi:
            lines.append(f"{rec[0]}\0{rec[1]}\0{rec[2]}")
    return _fp(lines)


def segment_source_fp_positions(snapshot: dict, positions) -> str:
    """segment_source_fp over a set of positions: a segment of repaired
    quarantined runs holds positions that are not one range."""
    want = {int(p) for p in positions}
    lines = []
    for rec in snapshot["entries"]:
        idx = _run_index(rec[0])
        if idx and int(idx) in want:
            lines.append(f"{rec[0]}\0{rec[1]}\0{rec[2]}")
    return _fp(lines)


# ---------------------------------------------------------------------------
# quarantine bookkeeping
# ---------------------------------------------------------------------------


def quarantine_file_names(qrecs) -> set:
    """Every file name the header's quarantine records watch."""
    return {f[0] for rec in qrecs or () for f in rec.get("files") or ()}


def quarantine_files_from_snapshot(snap: dict, position: int) -> list:
    """Every ``run_<position>_*`` file of one quarantined position with the
    snapshot's stats: the record a repair is detected by (a repair tool
    typically rewrites the whole run, so every file is watched)."""
    prefix = f"run_{position}_"
    return sorted([rec[0], rec[1], rec[2]] for rec in snap["entries"] if rec[0].startswith(prefix))


def quarantine_changed(corpus_dir: str, qrecs) -> list:
    """The quarantine records whose watched files' stats changed: repair
    candidates of the GROWN append.  A record with no watched files (a bad
    index entry, repaired by rewriting the index) never matches here."""
    changed = []
    for rec in qrecs or ():
        for name, size, mtime_ns in rec.get("files") or ():
            try:
                st = os.stat(os.path.join(corpus_dir, name))
            except OSError:
                changed.append(rec)
                break
            if st.st_size != size or st.st_mtime_ns != mtime_ns:
                changed.append(rec)
                break
    return changed


def stored_positions(header: dict) -> list[int]:
    """Stored row -> source position over every segment in append order; a
    segment without ``positions`` continues after the largest position
    before it."""
    out: list[int] = []
    nxt = 0
    for seg in header["segments"]:
        pos = seg.get("positions")
        if pos is None:
            pos = range(nxt, nxt + int(seg["n_runs"]))
        out.extend(int(p) for p in pos)
        nxt = (max(out) + 1) if out else 0
    return out


def segment_fingerprint(entry: dict) -> str:
    """Content address of one store segment: its shards' checksums, its
    shape row and its source fingerprint.  The result cache keys every
    partial (and, over all segments, every report) on this."""
    doc = [
        int(entry["n_runs"]),
        int(entry["v"]),
        int(entry["e"]),
        int(entry["max_depth"]),
        entry.get("source_fp") or "",
        sorted((m["file"], m["sha256"]) for m in entry["shards"]),
    ]
    return hashlib.sha256(json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def _sample_ok(corpus_dir: str, sample: list) -> bool:
    for name, size, mtime_ns in sample or ():
        try:
            st = os.stat(os.path.join(corpus_dir, name))
        except OSError:
            return False
        if st.st_size != size or st.st_mtime_ns != mtime_ns:
            return False
    return True


def classify_source(header: dict, corpus_dir: str) -> str:
    """HIT (the store may be served), GROWN (runs were appended, or a
    quarantined run's file changed) or STALE.

    ``fast`` mode first tries tier 0 — an unchanged directory mtime, index
    file stat and sample is a HIT with no enumeration — then compares the
    names-only fingerprints; ``full`` mode re-stats every file.  A
    quarantined run's files are left out of both and statted one by one: a
    change is the GROWN case (the append re-ingests the repaired run)."""
    src = header.get("source") or {}
    index_file = src.get("index_file") or "runs.json"
    qrecs = header.get("quarantined") or ()
    full = fingerprint_mode() == "full"
    if not full and src.get("dir_mtime_ns"):
        try:
            st = os.stat(corpus_dir)
            rj = os.stat(os.path.join(corpus_dir, index_file)) if src.get("runs_json") is not None else None
        except OSError:
            return STALE
        cur_rj = [rj.st_size, rj.st_mtime_ns] if rj is not None else None
        if (
            st.st_mtime_ns == src["dir_mtime_ns"]
            and cur_rj == src.get("runs_json")
            and _sample_ok(corpus_dir, src.get("sample"))
        ):
            # An in-place repair moves neither the directory nor the index.
            return GROWN if qrecs and quarantine_changed(corpus_dir, qrecs) else HIT
    cur = source_from_snapshot(
        snapshot_source(corpus_dir, with_stats=full, index_file=index_file),
        int(src.get("n_runs", 0)),
        exclude=quarantine_file_names(qrecs),
    )
    if full:
        base_ok = cur["old_fp"] == src.get("old_fp") and cur["other_fp"] == src.get("other_fp")
        hit_ok = base_ok and cur["new_fp"] == src.get("new_fp")
    else:
        base_ok = (
            cur["old_names_fp"] == src.get("old_names_fp")
            and cur["other_names_fp"] == src.get("other_names_fp")
            and _sample_ok(corpus_dir, src.get("sample"))
        )
        hit_ok = base_ok and cur["new_names_fp"] == src.get("new_names_fp")
    if not base_ok:
        return STALE
    if hit_ok and cur["runs_json"] == src.get("runs_json"):
        return GROWN if qrecs and quarantine_changed(corpus_dir, qrecs) else HIT
    # Append candidate: every stored file untouched, the index changed, new
    # run files present, and none were pending when the store was written.
    if (
        cur["n_new_files"] > 0
        and int(src.get("n_new_files", 0)) == 0
        and cur["runs_json"] != src.get("runs_json")
    ):
        return GROWN
    # A single-document layout (trace.json) grows inside its index file and
    # never gains per-run files: an index-only change is the append
    # candidate (the append checks the old entries before trusting it).
    if (
        index_file != "runs.json"
        and cur["n_new_files"] == 0
        and int(src.get("n_new_files", 0)) == 0
        and cur["runs_json"] != src.get("runs_json")
    ):
        return GROWN
    return STALE


# ---------------------------------------------------------------------------
# segment payloads (what a writer persists)
# ---------------------------------------------------------------------------


@dataclass
class SegmentPayload:
    """One segment's content, whichever loader produced it.  ``head``,
    ``prov`` and ``node_ids`` are callables, so the native producer's
    strings are fetched inside the parallel shard writers."""

    n_runs: int
    v: int
    e: int
    max_depth: int
    pre: object  # NativeCondBatch-shaped (12 arrays)
    post: object
    iteration: np.ndarray
    success: np.ndarray
    statuses: list[bytes]
    holds_pre: list[bytes]  # per run: JSON array of holds-map keys
    holds_post: list[bytes]
    head: object  # row -> bytes
    prov: object  # (cond_name, row) -> bytes
    node_ids: object  # (cond_name, row) -> bytes ("\n"-joined)
    #: the vocabulary these arrays were encoded against (CorpusVocab or
    #: {part: list[str]})
    vocab: object = None


def _int32_checked(values, what: str) -> np.ndarray:
    arr = np.asarray(values, dtype=np.int64)
    if arr.size and (arr.max(initial=0) > 2**31 - 1 or arr.min(initial=0) < -(2**31)):
        raise ValueError(f"{what} out of int32 range")
    return arr.astype(np.int32)


def payload_from_packed_molly(molly) -> SegmentPayload:
    """Native producer: the arrays of the packed-first loader's corpus, the
    strings from its live handle."""
    nc = molly.native_corpus
    runs = molly.runs
    return SegmentPayload(
        n_runs=nc.n_runs,
        v=nc.v,
        e=nc.e,
        max_depth=nc.max_depth,
        pre=nc.pre,
        post=nc.post,
        iteration=np.asarray(nc.iteration, dtype=np.int32),
        success=np.asarray(nc.success, dtype=bool),
        statuses=[r.status.encode() for r in runs],
        holds_pre=[json.dumps(list(r.time_pre_holds)).encode() for r in runs],
        holds_post=[json.dumps(list(r.time_post_holds)).encode() for r in runs],
        head=nc.run_head_json,
        prov=nc.prov_json,
        node_ids=lambda c, i: "\n".join(nc.lazy_node_ids(c, i)).encode(),
        vocab={"tables": nc.tables, "labels": nc.labels, "times": nc.times},
    )


def head_bytes(run) -> bytes:
    """The debugging.json head fragment of a parsed run, byte-equal to the
    C++ engine's build_run_head and to analysis/pipeline._run_json_str."""
    return (
        f'"iteration": {json.dumps(run.iteration)}, '
        f'"status": {json.dumps(run.status)}, '
        f'"failureSpec": {json.dumps(run.failure_spec.to_json() if run.failure_spec else None)}, '
        f'"model": {json.dumps(run.model.to_json() if run.model else None)}, '
        f'"messages": {json.dumps([m.to_json() for m in run.messages])}'
    ).encode()


def payload_from_runs(runs: list, vocab) -> SegmentPayload:
    """Python producer: pack RunData objects against ``vocab`` (a fresh
    CorpusVocab for a full store, the stored one for an append, which this
    extends).  Interning order is the engine's: all pre graphs in run
    order, then all post."""
    from nemo_tpu_torch.graphs.packed import bucket_size, longest_path_len, pack_graph
    from nemo_tpu_torch.ingest.native import NativeCondBatch
    from nemo_tpu_torch.ops.simplify import chains_linear_rows

    graphs = {
        "pre": [pack_graph(r.pre_prov, vocab) for r in runs],
        "post": [pack_graph(r.post_prov, vocab) for r in runs],
    }
    all_g = graphs["pre"] + graphs["post"]
    v = bucket_size(max((g.n_nodes for g in all_g), default=1))
    e = bucket_size(max((len(g.edges) for g in all_g), default=1))
    max_lp = max((longest_path_len(g.n_nodes, g.edges) for g in all_g), default=0)
    b = len(runs)

    def pack_cond(gs) -> NativeCondBatch:
        out = dict(
            table_id=np.full((b, v), -1, np.int32),
            label_id=np.full((b, v), -1, np.int32),
            time_id=np.full((b, v), -1, np.int32),
            type_id=np.zeros((b, v), np.int32),
            is_goal=np.zeros((b, v), bool),
            node_mask=np.zeros((b, v), bool),
            edge_src=np.zeros((b, e), np.int32),
            edge_dst=np.zeros((b, e), np.int32),
            edge_mask=np.zeros((b, e), bool),
            n_nodes=np.zeros(b, np.int32),
            n_goals=np.zeros(b, np.int32),
            chain_linear=np.zeros(b, bool),
        )
        for i, g in enumerate(gs):
            n = g.n_nodes
            out["n_nodes"][i] = n
            out["n_goals"][i] = g.n_goals
            out["table_id"][i, :n] = g.table_id
            out["label_id"][i, :n] = g.label_id
            out["time_id"][i, :n] = g.time_id
            out["type_id"][i, :n] = g.type_id
            out["is_goal"][i, : g.n_goals] = True
            out["node_mask"][i, :n] = True
            ne = len(g.edges)
            if ne:
                out["edge_src"][i, :ne] = g.edges[:, 0]
                out["edge_dst"][i, :ne] = g.edges[:, 1]
                out["edge_mask"][i, :ne] = True
        # @next-chain linearity per graph: the Python mirror of the
        # engine's parse-time graph_chain_linear.
        out["chain_linear"] = chains_linear_rows(
            out["is_goal"], out["node_mask"], out["type_id"], out["edge_src"], out["edge_dst"], out["edge_mask"]
        )
        return NativeCondBatch(**out)

    def holds_keys(run, cond: str) -> bytes:
        # The keying of ingest/molly.py:attach_run_metadata, first-seen order.
        tables = run.model.tables if run.model else {}
        return json.dumps(list({row[-1]: True for row in tables.get(cond, []) if row})).encode()

    return SegmentPayload(
        n_runs=b,
        v=v,
        e=e,
        max_depth=min(v, max(1, max_lp + 1)),
        pre=pack_cond(graphs["pre"]),
        post=pack_cond(graphs["post"]),
        iteration=_int32_checked([r.iteration for r in runs], "run iteration"),
        success=np.asarray([r.succeeded for r in runs], dtype=bool),
        statuses=[r.status.encode() for r in runs],
        holds_pre=[holds_keys(r, "pre") for r in runs],
        holds_post=[holds_keys(r, "post") for r in runs],
        head=lambda i: head_bytes(runs[i]),
        prov=lambda c, i: json.dumps((runs[i].pre_prov if c == "pre" else runs[i].post_prov).to_json()).encode(),
        node_ids=lambda c, i: "\n".join(graphs[c][i].node_ids).encode(),
        vocab=vocab,
    )


def payload_from_molly(molly) -> SegmentPayload:
    """A packed-first MollyOutput persists its native corpus as it is; an
    object-loader one is packed in Python.  Both give the same store."""
    if getattr(molly, "native_corpus", None) is not None:
        return payload_from_packed_molly(molly)
    from nemo_tpu_torch.graphs.packed import CorpusVocab

    return payload_from_runs(list(molly.runs), CorpusVocab())


def corpus_from_payload(payload: SegmentPayload):
    """The NativeCorpus of a payload's arrays and vocabulary, without a C++
    handle: how the Python loader's runs reach the packed-first backend."""
    from nemo_tpu_torch.ingest.native import NativeCorpus

    voc = payload.vocab
    parts = voc if isinstance(voc, dict) else {k: list(getattr(voc, k).strings) for k in ("tables", "labels", "times")}

    def node_ids(cond: str) -> list[list[str]]:
        joined = (payload.node_ids(cond, i).decode() for i in range(payload.n_runs))
        return [j.split("\n") if j else [] for j in joined]

    return NativeCorpus(
        n_runs=payload.n_runs,
        v=payload.v,
        e=payload.e,
        tables=parts["tables"],
        labels=parts["labels"],
        times=parts["times"],
        pre_tid=parts["tables"].index("pre"),
        post_tid=parts["tables"].index("post"),
        max_depth=payload.max_depth,
        iteration=payload.iteration,
        success=payload.success,
        pre=payload.pre,
        post=payload.post,
        node_ids_pre=node_ids("pre"),
        node_ids_post=node_ids("post"),
    )


# ---------------------------------------------------------------------------
# segment writing (parallel shards)
# ---------------------------------------------------------------------------


def _string_chunk_rows(b: int, workers: int) -> int:
    return max(256, -(-b // max(1, workers * 2)))


def write_segment(seg_dir: str, payload: SegmentPayload, workers: int) -> dict:
    """Write one segment directory, its shards in parallel on a thread pool
    (one shard per array group, row-chunked string shards per condition);
    returns its header entry."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(seg_dir, exist_ok=True)
    b = payload.n_runs
    chunk = _string_chunk_rows(b, workers)

    def cond_regions(cond):
        return lambda: [(name, getattr(cond, name)) for name, _ in _COND_ARRAYS]

    jobs: list[tuple[str, object]] = [
        ("arrays_pre.bin", cond_regions(payload.pre)),
        ("arrays_post.bin", cond_regions(payload.post)),
        (
            "runs.bin",
            lambda: [("iteration", payload.iteration), ("success", np.asarray(payload.success, dtype=bool))],
        ),
        (
            "meta.bin",
            lambda: (
                _blob_regions("status", payload.statuses)
                + _blob_regions("holds_pre", payload.holds_pre)
                + _blob_regions("holds_post", payload.holds_post)
                + _blob_regions("head", [payload.head(i) for i in range(b)])
            ),
        ),
    ]

    def string_shard(cond_name: str, start: int, end: int):
        def build():
            prov = [payload.prov(cond_name, i) for i in range(start, end)]
            ids = [payload.node_ids(cond_name, i) for i in range(start, end)]
            return _blob_regions("prov", prov) + _blob_regions("node_ids", ids)

        return build

    for cond_name in ("pre", "post"):
        for k, start in enumerate(range(0, b, chunk)):
            jobs.append((f"strings_{cond_name}_{k:03d}.bin", string_shard(cond_name, start, min(b, start + chunk))))

    def run_job(job):
        fname, regions = job
        return write_shard(os.path.join(seg_dir, fname), regions())

    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            manifests = list(pool.map(run_job, jobs))
    else:
        manifests = [run_job(j) for j in jobs]
    return {
        "name": os.path.basename(seg_dir),
        "n_runs": b,
        "v": payload.v,
        "e": payload.e,
        "max_depth": payload.max_depth,
        "string_chunk_rows": chunk,
        "shards": manifests,
    }


def write_vocab(path: str, vocab) -> dict:
    """tables/labels/times blobs (a CorpusVocab or {part: list[str]})."""
    regions = []
    for part in ("tables", "labels", "times"):
        v = vocab[part] if isinstance(vocab, dict) else getattr(vocab, part)
        regions += _blob_regions(part, [s.encode() for s in getattr(v, "strings", v)])
    return write_shard(path, regions)
