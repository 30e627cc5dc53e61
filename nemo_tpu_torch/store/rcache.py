"""Content-addressed analysis result cache of the port, with the fleet's
shared tier and leader leases.

A copy of the JAX package's ``store/rcache.py``.  Three entry kinds under
one size-capped root (``--result-cache``, ``NEMO_RESULT_CACHE``, default
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

**The shared fleet tier.**  ``NEMO_RCACHE_SHARED`` (the sidecar's
``--shared-cache DIR``) names a second root that every replica of a fleet
reaches.  Reads look in the local root first, then in the shared one
(``rcache.<kind>_shared_hit``); every local publish is replicated to the
shared root (``rcache.<kind>_shared_put``).  Keys are content addresses,
so two replicas publishing one key publish the same bytes: the loser of
the locked check-then-rename is counted ``rcache.publish_race``, never
torn.  A replicated entry's manifest holds the identities of the shared
root's own files (a copy across filesystems has new inodes), so every
replica verifies it as its publisher does.  ``off`` on the result cache
turns the shared tier off too.

The shared root also holds the fleet's **leader leases** (:class:`Lease`,
``<shared>/lease/<namespace>/<key>.lease``): one replica of a herd runs a
content address while the others wait for its publish; a heartbeat keeps
the lease, and a lease whose heartbeat is older than ``NEMO_LEASE_TTL_S``
is a dead leader's, stolen by the next replica (``rcache.lease_steal``).
Eviction never sweeps ``lease/``.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import socket
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


def shared_cache_dir(arg: str | None = None) -> str | None:
    """The shared (fleet) tier's root: ``arg``, else ``NEMO_RCACHE_SHARED``;
    ``off`` disables (None).  No default: a shared tier names a directory
    every replica reaches, a deployment's choice."""
    raw = arg if arg is not None else os.environ.get("NEMO_RCACHE_SHARED")
    if raw is None:
        return None
    raw = raw.strip()
    if raw.lower() in ("", "0", "off", "none", "false"):
        return None
    return os.path.expanduser(raw)


def lease_ttl_s() -> float:
    """The leader lease's heartbeat TTL (``NEMO_LEASE_TTL_S``, default 10 s,
    at least 0.05): a lease older than this is a dead leader's."""
    from nemo_tpu_torch.utils.env import env_float

    return max(0.05, env_float("NEMO_LEASE_TTL_S", 10.0))


def resolve_result_cache(arg: str | None = None, shared_arg: str | None = None) -> "ResultCache | None":
    """The result cache: the local root and, when ``shared_arg`` or
    ``NEMO_RCACHE_SHARED`` names one, the fleet's shared tier.  ``off`` on
    the result cache turns everything off, the shared tier and its leases
    included; a replica that wants the shared tier alone points
    ``NEMO_RESULT_CACHE`` at it."""
    root = result_cache_dir(arg)
    return ResultCache(root, shared_root=shared_cache_dir(shared_arg)) if root else None


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
    """One result-cache root, and for a fleet the shared tier.  Writes are
    atomic (a tmp directory renamed under a per-kind fcntl lock) and
    best-effort: a failed write is logged and never fails the report."""

    _WRECKAGE_MAX_AGE_S = 3600.0

    def __init__(self, root: str, shared_root: str | None = None) -> None:
        self.root = root
        #: Where the leader leases live: the shared tier (None: no fleet).
        self.lease_root = shared_root
        #: The second read and replication root; None without a shared tier
        #: or when the shared root is the local one.
        if shared_root is not None and os.path.abspath(shared_root) == os.path.abspath(root):
            shared_root = None
        self.shared_root = shared_root

    @contextmanager
    def _publish_lock(self, root: str, kind: str):
        """Makes the exists-check + rename of one kind at one root atomic
        across processes racing to publish the same key."""
        ldir = os.path.join(root, ".locks")
        os.makedirs(ldir, exist_ok=True)
        fd = os.open(os.path.join(ldir, f"{kind}.lock"), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _load_entry_at(self, root: str, kind: str, key: str):
        """One root's read: ("hit", entry, dir, manifest) of an entry whose
        files all match their manifest, ("miss",) or ("stale",), uncounted
        (``_load_entry`` counts).  An entry that fails its manifest is
        removed, so the next publish of its key replaces it."""
        d = os.path.join(root, kind, key)
        try:
            with open(os.path.join(d, "entry.json"), "r", encoding="utf-8") as fh:
                entry = json.load(fh)
            with open(os.path.join(d, "manifest.json"), "r", encoding="utf-8") as fh:
                manifest = json.load(fh)
        except FileNotFoundError:
            return ("miss",)
        except (OSError, ValueError) as ex:
            _log.warning("rcache.entry_unreadable", kind=kind, key=key, root=root,
                         error=f"{type(ex).__name__}: {ex}")
            return ("stale",)
        bad = _first_mismatch(d, manifest)
        if bad is not None:
            _log.error("rcache.entry_corrupt", kind=kind, key=key, root=root, file=bad,
                       detail="failing its manifest; removing it and recomputing instead of serving it")
            self._discard(d)
            return ("stale",)
        return ("hit", entry, d, manifest)

    def _load_entry(self, kind: str, key: str):
        """(entry dict, entry dir, manifest) from the local root, else from
        the shared tier (counted ``rcache.<kind>_shared_hit``), else None.
        Each root's stale entry counts ``rcache.<kind>_stale``; a miss in
        both roots with none stale counts ``rcache.<kind>_miss``.  The hit
        is the caller's to count (``_hit``), once the payload is in hand."""
        stale = False
        for shared, root in ((False, self.root), (True, self.shared_root)):
            if root is None:
                continue
            got = self._load_entry_at(root, kind, key)
            if got[0] == "hit":
                if shared:
                    obs.metrics.inc(f"rcache.{kind}_shared_hit")
                return got[1:]
            if got[0] == "stale":
                stale = True
                obs.metrics.inc(f"rcache.{kind}_stale")
        if not stale:
            obs.metrics.inc(f"rcache.{kind}_miss")
        return None

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

    def _commit_tmp(self, root: str, kind: str, key: str, tmp: str) -> str:
        """Publish a built tmp entry at ``root`` under the kind's lock and
        return the entry's directory.  A whole entry of the key already
        there wins (same key, same bytes), and the race is counted
        ``rcache.publish_race``; a broken one is replaced."""
        final = os.path.join(root, kind, key)
        with self._publish_lock(root, kind):
            if os.path.isdir(final) and self._whole(final):
                obs.metrics.inc("rcache.publish_race")
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                self._discard(final)
                os.rename(tmp, final)
        return final

    @staticmethod
    def _write_meta(tmp: str, rels: list[str], entry: dict) -> None:
        """The manifest (each file's identity where it lies) and
        ``entry.json`` (with the entry's byte count) of a tmp entry."""
        manifest = [[rel, *_identity(os.path.join(tmp, rel))] for rel in rels]
        with open(os.path.join(tmp, "manifest.json"), "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, separators=(",", ":"))
        with open(os.path.join(tmp, "entry.json"), "w", encoding="utf-8") as fh:
            json.dump(dict(entry, bytes=sum(m[1] for m in manifest)), fh, indent=1)

    def _put_entry(self, kind: str, key: str, entry: dict, pairs: list[tuple[str, str]], write=None) -> bool:
        """Publish one entry atomically: every (src, relpath) of ``pairs``
        is linked into it, ``write(tmp_dir)`` writes what is not linked and
        returns its relpaths, and the manifest and ``entry.json`` are added
        here; then replicate it to the shared tier, if any.  False (logged)
        on any failure."""
        try:
            os.makedirs(os.path.join(self.root, kind), exist_ok=True)
            final = os.path.join(self.root, kind, key)
            tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
            os.makedirs(tmp, exist_ok=True)
            try:
                _link_all([(src, os.path.join(tmp, rel)) for src, rel in pairs])
                rels = [rel for _, rel in pairs] + (write(tmp) if write is not None else [])
                self._write_meta(tmp, rels, dict(entry, kind=kind, key=key, created=time.time()))
                self._commit_tmp(self.root, kind, key, tmp)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            obs.metrics.inc(f"rcache.{kind}_put")
            self._replicate_shared(final, kind, key)
            self._evict_over_cap(keep=final)
            return True
        except Exception as ex:
            obs.metrics.inc("rcache.write_failed")
            _log.warning("rcache.write_failed", kind=kind, key=key, error=f"{type(ex).__name__}: {ex}")
            return False

    def _replicate_shared(self, src: str, kind: str, key: str) -> None:
        """Replicate a just-published local entry into the shared tier: its
        files linked (or copied, across filesystems) into a tmp entry whose
        manifest records the identities of the shared files themselves,
        then committed.  Best-effort: a shared-tier failure is counted
        ``rcache.write_failed`` and logged, and never fails the publish; a
        whole entry already there is a counted race."""
        root = self.shared_root
        if root is None:
            return
        try:
            final = os.path.join(root, kind, key)
            if os.path.isdir(final) and self._whole(final):
                obs.metrics.inc("rcache.publish_race")
                return
            with open(os.path.join(src, "manifest.json"), "r", encoding="utf-8") as fh:
                rels = [m[0] for m in json.load(fh)]
            with open(os.path.join(src, "entry.json"), "r", encoding="utf-8") as fh:
                entry = json.load(fh)
            os.makedirs(os.path.join(root, kind), exist_ok=True)
            tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
            try:
                _link_all([(os.path.join(src, rel), os.path.join(tmp, rel)) for rel in rels])
                self._write_meta(tmp, rels, entry)
                self._commit_tmp(root, kind, key, tmp)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            obs.metrics.inc(f"rcache.{kind}_shared_put")
            self._evict_over_cap(keep=final, root=root)
        except Exception as ex:
            obs.metrics.inc("rcache.write_failed")
            _log.warning("rcache.shared_replicate_failed", kind=kind, key=key, root=root,
                         error=f"{type(ex).__name__}: {ex}")

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

    def blob_present(self, namespace: str, key: str) -> bool:
        """Whether a ``blob_<namespace>`` entry of ``key`` is in either root:
        no verify, no counter (the fleet follower's poll; entries appear by
        one rename, so a present one is whole, and its ``load_blob``
        verifies and counts)."""
        return any(root and os.path.isdir(os.path.join(root, f"blob_{namespace}", key))
                   for root in (self.root, self.shared_root))

    # ------------------------------------------------------------ eviction

    def _evict_over_cap(self, keep: str, root: str | None = None) -> None:
        """Sweep aged crash leftovers at ``root`` (default the local root),
        then, past RESULT_CACHE_MAX_BYTES, evict the least recently used
        entries (entry.json mtime), never the one just written.  Sizes come
        from each entry.json: hardlinks between entries are never counted
        twice, since a report entry holds no file of the partials it names.
        ``lease/`` is never swept: a lease is liveness, not content (an
        evicted one would read as a dead leader)."""
        root = self.root if root is None else root
        now = time.time()
        entries = []
        try:
            kinds = [k for k in os.listdir(root) if not k.startswith(".") and k != "lease"]
        except OSError:
            kinds = []
        for kind in kinds:
            kdir = os.path.join(root, kind)
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


# ---------------------------------------------------------------- leases


class Lease:
    """A cross-replica leader lease: one file under the shared tier
    (``<root>/lease/<namespace>/<key>.lease``), taken by an
    ``O_CREAT|O_EXCL`` create, kept by mtime heartbeats, and stolen once
    its heartbeat is older than the TTL (``NEMO_LEASE_TTL_S``): how the
    followers of a dead leader elect a new one.

    Stealers take a per-namespace fcntl lock and look again, so no stealer
    unlinks another's fresh lease.  A heartbeat between the look and the
    unlink is the accepted race: the old leader then finds its lease gone
    at release, and what it publishes is the new leader's bytes (the key
    is a content address).
    """

    def __init__(self, root: str, namespace: str, key: str, owner: str | None = None,
                 ttl_s: float | None = None) -> None:
        self.dir = os.path.join(root, "lease", namespace)
        self.path = os.path.join(self.dir, f"{key}.lease")
        self.owner = owner or f"{socket.gethostname()}-{os.getpid()}"
        self.ttl_s = lease_ttl_s() if ttl_s is None else float(ttl_s)
        self._held = False
        #: True after a failure of the shared tier itself (not writable, not
        #: a directory): distinct from "another replica leads", so the
        #: caller runs at once instead of waiting for a publish that cannot
        #: come.
        self.broken = False

    @property
    def held(self) -> bool:
        return self._held

    def _create(self) -> bool:
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump({"owner": self.owner, "acquired": time.time()}, fh)
        self._held = True
        return True

    def try_acquire(self) -> bool:
        """True when this process now holds the lease: a fresh create, or a
        steal from a holder whose heartbeat is older than the TTL (counted
        ``rcache.lease_steal``, and the flight recorder's ``lease_steal``
        trigger).  An OSError of the shared tier sets ``broken`` and is
        False."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            if self._create():
                obs.metrics.inc("rcache.lease_acquired")
                return True
            if not self.holder_stale():
                return False
            lock_fd = os.open(os.path.join(self.dir, ".lease.lock"), os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
                if not self.holder_stale():
                    return False
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
                if not self._create():
                    return False
                obs.metrics.inc("rcache.lease_steal")
                _log.warning("rcache.lease_stolen", path=self.path, owner=self.owner,
                             detail="previous leader's heartbeat expired; re-elected")
                # A steal means a leader died in flight: the moment a
                # postmortem bundle is worth its disk.
                obs.flight.trigger("lease_steal", path=self.path, new_owner=self.owner)
                return True
            finally:
                fcntl.flock(lock_fd, fcntl.LOCK_UN)
                os.close(lock_fd)
        except OSError as ex:
            self.broken = True
            _log.warning("rcache.lease_error", path=self.path, error=str(ex))
            return False

    def holder_stale(self) -> bool:
        """True when the holder's heartbeat (the file's mtime) is older than
        the TTL, or the lease is gone."""
        try:
            return time.time() - os.path.getmtime(self.path) > self.ttl_s
        except OSError:
            return True

    def read_owner(self) -> str | None:
        """The lease file's current owner, whoever holds it (a follower
        links its trace to the leader's with it), or None."""
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                return json.load(fh).get("owner")
        except (OSError, ValueError):
            return None

    def heartbeat(self) -> None:
        """Refresh the holder's liveness stamp (nothing unless held)."""
        if not self._held:
            return
        try:
            os.utime(self.path)
        except OSError:
            pass

    def release(self) -> None:
        """Drop a held lease, once.  A lease another replica stole belongs
        to its new leader and stays (unlinking it would invite a third
        run)."""
        if not self._held:
            return
        self._held = False
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                if json.load(fh).get("owner") != self.owner:
                    return
        except (OSError, ValueError):
            return
        try:
            os.unlink(self.path)
        except OSError:
            pass
