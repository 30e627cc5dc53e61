"""Content-addressed analysis result cache of the port (local tier).

A copy of the JAX package's ``store/rcache.py`` without its shared fleet
tier and leases.  Three entry kinds under one size-capped root
(``--result-cache``, ``NEMO_RESULT_CACHE``, default
``~/.cache/nemo_tpu_torch/results``; ``off`` disables):

  * ``partial/<key>/``: one store segment's ``SegmentPartial``
    (``partial.json``) and its rendered figure files.  A grown corpus maps
    only its new segment and merges these (analysis/delta.py).
  * ``report/<key>/``: a whole report tree (telemetry left out), minus the
    figure files of the partials it names in ``entry.json``: those are
    linked from the partial entries, so a figure is stored once.  A
    repeated request restores the tree with no backend and no kernel
    launch.
  * ``blob_<namespace>/<key>/``: one opaque payload (``payload.bin``): the
    query engine's result documents (``query``) and segment partials
    (``query-partial``).

Keys come from ``analysis/delta.py`` and are pure content addresses, so no
invalidation is needed: a changed input is a new key, and old entries age
out under the LRU cap (``RESULT_CACHE_MAX_BYTES``; last use stamped on
``entry.json`` by every hit).  ``entry.json`` carries the entry's own byte
count, so eviction reads one small file per entry and never walks a tree.

Files are hardlinked between cache and report where the filesystem allows,
else copied.  Every entry carries a manifest of its files' identities
(size, inode, mtime): an entry whose file was removed, replaced, truncated
or written in place (through a hardlinked report file, say) fails it and is
a logged miss, never served.  The verify stats each file and reads none,
so a lookup costs one ``stat`` per file.  A partial's figure files are
linked into a staging directory at lookup, so an eviction between the
lookup and the report cannot take them: a partial that cannot be staged
whole is a miss, and its segment is mapped.  The staging directory then
becomes the report's ``figures/`` by one rename.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import time
import uuid
from collections import Counter
from contextlib import contextmanager

from nemo_tpu_torch import obs

_log = obs.log.get_logger("nemo.rcache")

#: Size cap of one result-cache root: past it, a publish evicts the least
#: recently used entries.
RESULT_CACHE_MAX_BYTES = 8_000_000_000


def result_cache_dir(arg: str | None = None) -> str | None:
    """The result-cache root: ``arg``, else ``NEMO_RESULT_CACHE``, else
    ``~/.cache/nemo_tpu_torch/results``; ``off`` disables (None)."""
    from nemo_tpu_torch.utils.env import cache_root

    return cache_root(arg, "NEMO_RESULT_CACHE", "results")


def resolve_result_cache(arg: str | None = None) -> "ResultCache | None":
    root = result_cache_dir(arg)
    return ResultCache(root) if root else None


def _identity(path: str) -> list[int]:
    st = os.stat(path)
    return [st.st_size, st.st_ino, st.st_mtime_ns]


def _first_mismatch(entry_dir: str, manifest: list) -> str | None:
    """The first manifest path whose file is gone or changed, else None."""
    for rel, *ident in manifest:
        try:
            if _identity(os.path.join(entry_dir, rel)) != ident:
                return rel
        except OSError:
            return rel
    return None


def _link(src: str, dst: str) -> None:
    """Hardlink ``src`` to ``dst``, else (another filesystem, or one without
    hardlinks) copy it.  Raises OSError if ``src`` is gone or ``dst``
    exists."""
    try:
        os.link(src, dst)
    except FileExistsError:
        raise
    except OSError:
        if not os.path.exists(src):
            raise
        shutil.copy2(src, dst)


def _link_all(pairs: list[tuple[str, str]]) -> None:
    """_link every (src, dst), making each parent directory once."""
    made: set[str] = set()
    for src, dst in pairs:
        parent = os.path.dirname(dst)
        if parent not in made:
            os.makedirs(parent, exist_ok=True)
            made.add(parent)
        _link(src, dst)


class ResultCache:
    """One result-cache root.  Writes are atomic (a tmp directory renamed
    under a per-kind fcntl lock) and best-effort: a failed write is logged
    and never fails the report."""

    _WRECKAGE_MAX_AGE_S = 3600.0

    def __init__(self, root: str) -> None:
        self.root = root

    @contextmanager
    def _publish_lock(self, kind: str):
        """Makes the exists-check + rename of one kind atomic across
        processes racing to publish the same key."""
        ldir = os.path.join(self.root, ".locks")
        os.makedirs(ldir, exist_ok=True)
        fd = os.open(os.path.join(ldir, f"{kind}.lock"), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _load_entry(self, kind: str, key: str):
        """(entry dict, entry dir, manifest) of an entry whose files all
        match their manifest, else None, counted ``rcache.<kind>_miss`` (no
        entry) or ``rcache.<kind>_stale`` (unreadable, or failing its
        manifest).  An entry that fails it is removed, so the next publish
        of its key replaces it.  The hit is the caller's to count
        (``_hit``), once the payload is in hand."""
        d = os.path.join(self.root, kind, key)
        try:
            with open(os.path.join(d, "entry.json"), "r", encoding="utf-8") as fh:
                entry = json.load(fh)
            with open(os.path.join(d, "manifest.json"), "r", encoding="utf-8") as fh:
                manifest = json.load(fh)
        except FileNotFoundError:
            obs.metrics.inc(f"rcache.{kind}_miss")
            return None
        except (OSError, ValueError) as ex:
            obs.metrics.inc(f"rcache.{kind}_stale")
            _log.warning("rcache.entry_unreadable", kind=kind, key=key, error=f"{type(ex).__name__}: {ex}")
            return None
        bad = _first_mismatch(d, manifest)
        if bad is not None:
            obs.metrics.inc(f"rcache.{kind}_stale")
            _log.error("rcache.entry_corrupt", kind=kind, key=key, file=bad,
                       detail="failing its manifest; removing it and recomputing instead of serving it")
            self._discard(d)
            return None
        return entry, d, manifest

    def _hit(self, kind: str, entry_dir: str) -> None:
        """A served hit: its counter and the LRU last-use stamp."""
        obs.metrics.inc(f"rcache.{kind}_hit")
        self._stamp(entry_dir)

    @staticmethod
    def _whole(entry_dir: str) -> bool:
        try:
            with open(os.path.join(entry_dir, "manifest.json"), "r", encoding="utf-8") as fh:
                return _first_mismatch(entry_dir, json.load(fh)) is None
        except (OSError, ValueError):
            return False

    def _discard(self, entry_dir: str) -> None:
        doomed = f"{entry_dir}.tmp-doomed-{uuid.uuid4().hex[:8]}"
        try:
            os.rename(entry_dir, doomed)
        except OSError:
            return
        shutil.rmtree(doomed, ignore_errors=True)

    @staticmethod
    def _stamp(entry_dir: str) -> None:
        """LRU last-use stamp of a served hit."""
        try:
            os.utime(os.path.join(entry_dir, "entry.json"))
        except OSError:
            pass

    def _put_entry(self, kind: str, key: str, entry: dict, pairs: list[tuple[str, str]], write=None) -> bool:
        """Publish one entry atomically: every (src, relpath) of ``pairs``
        is linked into it, ``write(tmp_dir)`` writes what is not linked and
        returns its relpaths, and the manifest and ``entry.json`` are added
        here.  False (logged) on any failure."""
        try:
            os.makedirs(os.path.join(self.root, kind), exist_ok=True)
            final = os.path.join(self.root, kind, key)
            tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
            os.makedirs(tmp, exist_ok=True)
            try:
                _link_all([(src, os.path.join(tmp, rel)) for src, rel in pairs])
                rels = [rel for _, rel in pairs] + (write(tmp) if write is not None else [])
                manifest = [[rel, *_identity(os.path.join(tmp, rel))] for rel in rels]
                with open(os.path.join(tmp, "manifest.json"), "w", encoding="utf-8") as fh:
                    json.dump(manifest, fh, separators=(",", ":"))
                entry = dict(entry, kind=kind, key=key, created=time.time(), bytes=sum(m[1] for m in manifest))
                with open(os.path.join(tmp, "entry.json"), "w", encoding="utf-8") as fh:
                    json.dump(entry, fh, indent=1)
                with self._publish_lock(kind):
                    if os.path.isdir(final) and self._whole(final):
                        # Same key, same bytes: the winner of the race stays.
                        obs.metrics.inc("rcache.publish_race")
                        shutil.rmtree(tmp, ignore_errors=True)
                    else:
                        self._discard(final)
                        os.rename(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            obs.metrics.inc(f"rcache.{kind}_put")
            self._evict_over_cap(keep=final)
            return True
        except Exception as ex:
            obs.metrics.inc("rcache.write_failed")
            _log.warning("rcache.write_failed", kind=kind, key=key, error=f"{type(ex).__name__}: {ex}")
            return False

    # ------------------------------------------------------------- reports

    def load_report(self, key: str, results_root: str, report_dir: str) -> bool:
        """Restore a cached report tree into ``report_dir`` (replacing any
        report there): its own files, and the figure files of the partials
        it names.  True on a hit, with every file in place: the caller
        writes fresh telemetry and is done.  A missing or failing partial
        is a miss."""
        got = self._load_entry("report", key)
        if got is None:
            return False
        entry, d, manifest = got
        t0 = time.perf_counter()
        with obs.span("report:cache_restore", key=key[:12]):
            dsts: dict[str, str] = {}
            for rel, *_ in manifest:
                dsts[os.path.relpath(rel, "tree")] = os.path.join(d, rel)
            used = []
            for pkey in entry.get("partials", ()):
                part = self._load_entry("partial", pkey)
                if part is None:
                    obs.metrics.inc("rcache.report_stale")  # metrics-doc: rcache.<kind>_stale
                    return False
                _, pd, pman = part
                used.append(pd)
                for rel, *_ in pman:
                    if rel.startswith("figures/"):
                        # The report's own copy wins (a name two partials list).
                        dsts.setdefault(rel, os.path.join(pd, rel))
            os.makedirs(results_root, exist_ok=True)
            tmp = f"{report_dir}.tmp-{uuid.uuid4().hex[:8]}"
            try:
                _link_all([(src, os.path.join(tmp, rel)) for rel, src in dsts.items()])
                if os.path.isdir(report_dir):
                    shutil.rmtree(report_dir)
                os.rename(tmp, report_dir)
            except OSError as ex:
                shutil.rmtree(tmp, ignore_errors=True)
                obs.metrics.inc("rcache.restore_failed")
                _log.warning("rcache.restore_failed", key=key, error=str(ex))
                return False
        self._hit("report", d)
        for ed in used:
            self._stamp(ed)
        obs.metrics.observe("rcache.restore_s", time.perf_counter() - t0)
        _log.info("rcache.report_hit", key=key[:12], report_dir=report_dir, files=len(dsts),
                  seconds=round(time.perf_counter() - t0, 3))
        return True

    def put_report(self, key: str, report_dir: str, exclude: frozenset, partials: dict[str, list[str]]) -> bool:
        """Cache a freshly written report tree, minus the ``exclude``
        basenames (the nondeterministic telemetry) and minus the figure
        files of ``partials`` (partial key -> its figure basenames, each a
        published entry), which the entry names instead of holding."""
        counts = Counter(f for figs in partials.values() for f in figs)
        shared = {f for f, n in counts.items() if n == 1}
        pairs = []
        for dirpath, _, files in os.walk(report_dir):
            rel_dir = os.path.relpath(dirpath, report_dir)
            for f in files:
                if f in exclude or (rel_dir == "figures" and f in shared):
                    continue
                pairs.append((os.path.join(dirpath, f), os.path.normpath(os.path.join("tree", rel_dir, f))))
        return self._put_entry("report", key, {"partials": sorted(partials)}, pairs)

    # ------------------------------------------------------------ partials

    def load_partial(self, key: str, stage_dir: str):
        """A cached SegmentPartial whose figure files are all linked into
        ``stage_dir`` (so no eviction can take them before the report), or
        None: a miss, and the caller maps the segment."""
        from nemo_tpu_torch.analysis.delta import SegmentPartial

        got = self._load_entry("partial", key)
        if got is None:
            return None
        _, d, _ = got
        try:
            with open(os.path.join(d, "partial.json"), "r", encoding="utf-8") as fh:
                p = SegmentPartial.from_json(json.load(fh))
        except (OSError, KeyError, TypeError, ValueError) as ex:
            obs.metrics.inc("rcache.partial_stale")
            _log.warning("rcache.partial_undecodable", key=key, error=f"{type(ex).__name__}: {ex}")
            return None
        linked: list[str] = []
        try:
            os.makedirs(stage_dir, exist_ok=True)
            for n in p.fig_files:
                _link(os.path.join(d, "figures", n), os.path.join(stage_dir, n))
                linked.append(n)
        except OSError as ex:
            for n in linked:
                os.remove(os.path.join(stage_dir, n))
            obs.metrics.inc("rcache.figures_missing")
            _log.error("rcache.figure_restore_failed", entry=d, error=f"{type(ex).__name__}: {ex}",
                       detail="a cached figure cannot be staged; the partial is a miss and its segment is mapped")
            if not self._whole(d):
                self._discard(d)
            return None
        self._hit("partial", d)
        obs.metrics.inc("rcache.figures_restored", len(linked))
        return p

    def put_partial(self, key: str, partial, figures_dir: str) -> bool:
        """Cache one segment's partial and its figure files (hardlinked from
        the just-written report's figures/)."""

        def write(tmp: str) -> list[str]:
            with open(os.path.join(tmp, "partial.json"), "w", encoding="utf-8") as fh:
                json.dump(partial.to_json(), fh, separators=(",", ":"))
            return ["partial.json"]

        pairs = [(os.path.join(figures_dir, n), os.path.join("figures", n)) for n in partial.fig_files]
        return self._put_entry("partial", key, {}, pairs, write)

    # --------------------------------------------------------------- blobs

    def load_blob(self, namespace: str, key: str) -> bytes | None:
        """The payload of a verified ``blob_<namespace>`` entry, else None."""
        got = self._load_entry(f"blob_{namespace}", key)
        if got is None:
            return None
        _, d, _ = got
        try:
            with open(os.path.join(d, "payload.bin"), "rb") as fh:
                payload = fh.read()
        except OSError as ex:
            obs.metrics.inc(f"rcache.blob_{namespace}_stale")
            _log.warning("rcache.entry_unreadable", kind=f"blob_{namespace}", key=key, error=str(ex))
            return None
        self._hit(f"blob_{namespace}", d)
        return payload

    def put_blob(self, namespace: str, key: str, payload: bytes) -> bool:
        """Publish one opaque payload under ``blob_<namespace>/<key>``."""

        def write(tmp: str) -> list[str]:
            with open(os.path.join(tmp, "payload.bin"), "wb") as fh:
                fh.write(payload)
            return ["payload.bin"]

        return self._put_entry(f"blob_{namespace}", key, {}, [], write)

    # ------------------------------------------------------------ eviction

    def _evict_over_cap(self, keep: str) -> None:
        """Sweep aged crash leftovers, then, past RESULT_CACHE_MAX_BYTES,
        evict the least recently used entries (entry.json mtime), never the
        one just written.  Sizes come from each entry.json: hardlinks
        between entries are never counted twice, since a report entry holds
        no file of the partials it names."""
        now = time.time()
        entries = []
        try:
            kinds = [k for k in os.listdir(self.root) if not k.startswith(".")]
        except OSError:
            kinds = []
        for kind in kinds:
            kdir = os.path.join(self.root, kind)
            try:
                names = os.listdir(kdir)
            except OSError:
                continue
            for name in names:
                path = os.path.join(kdir, name)
                if ".tmp-" in name:
                    try:
                        if now - os.path.getmtime(path) >= self._WRECKAGE_MAX_AGE_S:
                            shutil.rmtree(path, ignore_errors=True)
                            obs.metrics.inc("rcache.gc_wreckage")
                    except OSError:
                        pass
                    continue
                ej = os.path.join(path, "entry.json")
                try:
                    used = os.path.getmtime(ej)
                    with open(ej, "r", encoding="utf-8") as fh:
                        size = int(json.load(fh)["bytes"])
                except (OSError, ValueError, KeyError, TypeError):
                    used, size = 0.0, 0  # wreckage without a readable entry goes first
                entries.append((used, size, path))
        total = sum(s for _, s, _ in entries)
        for _used, size, path in sorted(entries):
            if total <= RESULT_CACHE_MAX_BYTES:
                break
            if os.path.abspath(path) == os.path.abspath(keep):
                continue
            shutil.rmtree(path, ignore_errors=True)
            total -= size
            obs.metrics.inc("rcache.evicted")
            _log.info("rcache.evicted", entry=path, freed_mb=round(size / 1e6, 1))
