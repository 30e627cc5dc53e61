"""Cross-request continuous batching for kernel dispatches.

A copy of the JAX package's ``serve/batch.py``.  Several in-flight client
sessions dispatching the same verb with the same bucket signature
(identical statics, identical per-row array shapes and dtypes) over the
sidecar's Kernel RPC are one padded launch, not N.

Only the row-independent verbs merge (``condition``, ``simplify``,
``proto``, ``synth_ext``), and only in their RUN-BATCHED form: each output
row is a function of its input row alone, so concatenating requests along
the run axis and slicing the outputs apart is exact.  :data:`BATCH_RANK`
gates on the canonical array's rank, so a per-graph dispatch (leading axis
nodes, not runs) is never merged.  ``fused``/``giant`` never merge (the
fused step diffs every row against its batch's row 0 and reduces the
prototypes over the whole batch), nor does ``diff`` (its good-run graph is
in its arrays), nor the sparse verbs, for the same reasons.

Mechanics, continuous rather than windowed: the first arrival for a
signature launches at once; arrivals while a launch is in flight
accumulate and go out as ONE merged launch when it returns
(``NEMO_SERVE_BATCH_WINDOW_MS`` adds a short gather wait, default 0).
Each leader runs exactly one launch, its own request plus what
accumulated, then hands leadership to the first waiting request, so every
request's latency is bounded by its own batch and a failed launch fails
only the requests in that batch.  The merged batch pads its run axis to
the bucket power of two (``graphs/packed.py:bucket_size``) and runs as a
device-pinned ``parallel/sched.py:Job`` on the executor's device, tagged
``source="serve"``, whatever ``NEMO_SCHED`` says: on a card a failed launch
raises to the requests of its batch and never moves to the host
(``HeterogeneousScheduler.on_card``).  The executor's ``rows`` hint
carries the real merged row count, so pad rows never count; per-request
rows land in ``serve.batch.request_rows``.

Demux: each request's rows are a contiguous slice of the merged batch;
every output's leading dim is checked against the padded width first, so
a non-per-row output fails loudly instead of being mis-attributed.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from nemo_tpu_torch import obs
from nemo_tpu_torch.serve.admission import _env_float

_log = obs.log.get_logger("nemo.serve")

#: Merge-eligible verbs mapped to (canonical array, required rank) of their
#: RUN-BATCHED dispatch shape.  A dispatch whose canonical array has any
#: other rank is the per-graph form of the same verb (leading axis = nodes)
#: and must never be merged.
BATCH_RANK = {
    "condition": ("is_goal", 2),
    "simplify": ("is_goal", 2),
    "proto": ("adj", 3),
    # The synthesis verb is row-independent by construction —
    # every output row is a function of its own run's planes — and only
    # ever dispatches run-batched ([B,V] is_goal), so cross-request
    # merging is exact.
    "synth_ext": ("is_goal", 2),
}

#: Verbs whose run-batched outputs are all per-row functions of per-row
#: inputs (see module docstring for why fused/giant/diff are excluded).
#: The sparse-CSR device verbs ("sparse_fused", "sparse_diff")
#: are excluded for the fused/diff reasons exactly — sparse_fused carries
#: the cross-run prototype reductions, sparse_diff diffs every row against
#: one shared good graph — so they pass through solo like their dense
#: twins.
BATCHABLE_VERBS = frozenset(BATCH_RANK)


def window_seconds() -> float:
    return _env_float("NEMO_SERVE_BATCH_WINDOW_MS", 0.0) / 1000.0


def dispatch_signature(verb: str, arrays: dict, params: dict):
    """The merge-compatibility key: verb + every static param + every
    array's (name, dtype, trailing shape), minus the leading (run) dim — two dispatches sharing this
    signature concatenate into one program's batch."""
    p = tuple(sorted((k, int(v)) for k, v in params.items()))
    a = tuple(
        sorted(
            (n, str(np.asarray(x).dtype), tuple(np.shape(x)[1:]))
            for n, x in arrays.items()
            if x is not None
        )
    )
    return (verb, p, a)


def _eligible_rows(verb: str, arrays: dict) -> int | None:
    """The run-batch width of a merge-eligible dispatch, or None.

    Eligibility gates on the canonical array's RANK (run-batched vs
    per-graph dispatch of the same verb) and on every array sharing one
    leading dim — anything else executes solo."""
    spec = BATCH_RANK.get(verb)
    if spec is None:
        return None
    name, rank = spec
    canon = arrays.get(name)
    if canon is None or np.ndim(canon) != rank:
        return None
    dims = {
        int(np.shape(a)[0])
        for a in arrays.values()
        if a is not None and np.ndim(a) > 0
    }
    return dims.pop() if len(dims) == 1 else None


class _Pending:
    __slots__ = ("arrays", "rows", "event", "result", "error", "promoted")

    def __init__(self, arrays: dict, rows: int) -> None:
        self.arrays = arrays
        self.rows = rows
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None
        #: Set (with the event) when leadership is handed to this waiter
        #: instead of a result: it wakes, drains the queue, and launches.
        self.promoted = False


class _Group:
    __slots__ = ("in_flight", "pending")

    def __init__(self) -> None:
        self.in_flight = False
        self.pending: list[_Pending] = []


class KernelBatcher:
    """Per-signature continuous batcher over an executor's ``run``."""

    #: Bound on one waiter's wait for its merged launch.
    WAIT_TIMEOUT_S = 600.0

    def __init__(self, window_s: float | None = None) -> None:
        self.window_s = window_seconds() if window_s is None else float(window_s)
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Group] = {}

    # ------------------------------------------------------------ public

    def run(
        self, executor, verb: str, arrays: dict, params: dict, rows: int | None = None
    ) -> dict[str, np.ndarray]:
        """Drop-in for ``executor.run``: merge-eligible dispatches ride the
        continuous batch; everything else (non-batchable verbs, per-graph
        dispatch shapes) executes directly, counted ``serve.batch.solo``."""
        my_rows = _eligible_rows(verb, arrays)
        if not my_rows:
            obs.metrics.inc("serve.batch.solo")
            return executor.run(verb, arrays, params, rows=rows)
        sig = dispatch_signature(verb, arrays, params)
        me = _Pending(arrays, my_rows)
        with self._lock:
            group = self._groups.get(sig)
            if group is None:
                group = self._groups[sig] = _Group()
            if group.in_flight:
                # A launch for this signature is on the device: accumulate.
                group.pending.append(me)
                leader = False
            else:
                group.in_flight = True
                leader = True
        if not leader:
            if not me.event.wait(self.WAIT_TIMEOUT_S):
                with self._lock:
                    if me in group.pending:
                        group.pending.remove(me)
                        raise TimeoutError(
                            f"batched {verb} dispatch not launched in "
                            f"{self.WAIT_TIMEOUT_S:.0f}s"
                        )
                # Raced a launch/promotion that already took this entry out
                # of the queue: the event is moments away.
                me.event.wait(self.WAIT_TIMEOUT_S)
            if me.error is not None:
                raise me.error
            if me.result is not None:
                return me.result
            if not me.promoted:  # double timeout with no handoff
                raise TimeoutError(
                    f"batched {verb} dispatch neither launched nor promoted in "
                    f"{2 * self.WAIT_TIMEOUT_S:.0f}s"
                )
            # Leadership handoff: fall through and launch.
        # Leader for exactly ONE launch: this request plus everything
        # pending right now.  Afterwards the token is handed to the first
        # still-waiting request (promotion) or released — a leader never
        # drains other requests' batches after its own work finished, so
        # its latency is bounded and a later batch's failure cannot reach
        # it.
        if self.window_s:
            time.sleep(self.window_s)
        with self._lock:
            batch = [me] + group.pending
            group.pending = []
        try:
            self._launch(executor, verb, params, batch, sig)
        finally:
            self._handoff(group, sig)
        if me.error is not None:
            raise me.error
        assert me.result is not None
        return me.result

    def _handoff(self, group: _Group, sig: tuple) -> None:
        """Pass the in-flight token to the next waiter, or retire it.  The
        idle group is dropped from the table — signatures arrive verbatim
        from clients (shapes, statics), so a retained entry per distinct
        signature would grow without bound on a long-lived sidecar."""
        with self._lock:
            if group.pending:
                nxt = group.pending.pop(0)
                nxt.promoted = True
                nxt.event.set()  # token transfers; in_flight stays True
            else:
                group.in_flight = False
                if self._groups.get(sig) is group:
                    del self._groups[sig]

    # ----------------------------------------------------------- launch

    def _launch(
        self, executor, verb: str, params: dict, batch: list[_Pending], sig: tuple
    ) -> None:
        from nemo_tpu_torch.graphs.packed import bucket_size
        from nemo_tpu_torch.parallel import sched

        total = sum(p.rows for p in batch)
        padded = bucket_size(total, minimum=1)
        names = list(batch[0].arrays)
        try:
            merged: dict = {}
            for n in names:
                parts = [np.asarray(p.arrays[n]) for p in batch]
                if padded > total:
                    # Pad rows are copies of the first request's row 0 —
                    # per-row verbs compute them independently and the
                    # demux below never returns them.
                    parts.append(
                        np.repeat(parts[0][:1], padded - total, axis=0)
                    )
                merged[n] = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

            v = int(params.get("v", params.get("num_tables", 0)))
            e = int(np.shape(merged.get("edge_src", ()))[-1]) if "edge_src" in merged else 0

            def execute(lane: str, reason: str, stolen: bool) -> dict:
                # The rows hint carries the real merged row count past the
                # pad (the executor's cost table and batch_rows histogram).
                res = executor.run(verb, merged, params, rows=total)
                # A cold launch's wall must not feed the scheduler's EWMA.
                if getattr(executor, "last_dispatch_cold", False):
                    job.wall_tainted = True
                return res

            job = sched.Job(
                index=0,
                verb=verb,
                rows=total,
                v=v,
                e=e,
                work=total * max(v + e, 1),
                execute=execute,
                pinned="device",
                reason="serve_batch",
                source="serve",
            )
            out = sched.HeterogeneousScheduler(device=getattr(executor, "device", None)).run([job])[0]

            obs.metrics.inc("serve.batch.launches")
            obs.metrics.inc("serve.batch.merged_requests", len(batch))
            if len(batch) > 1:
                obs.metrics.inc("serve.batch.coalesced_requests", len(batch) - 1)
            obs.metrics.inc("serve.batch.rows", total)
            obs.metrics.inc("serve.batch.pad_rows", padded - total)
            for n, o in out.items():
                lead = int(np.shape(o)[0]) if np.ndim(o) > 0 else -1
                if lead != padded:
                    raise RuntimeError(
                        f"kernel {verb!r} output {n!r} is not per-row shaped "
                        f"(leading dim {lead}, batch {padded}); it cannot be "
                        "demuxed across requests — remove the verb from "
                        "serve.batch.BATCHABLE_VERBS"
                    )
            off = 0
            for p in batch:
                obs.metrics.observe("serve.batch.request_rows", p.rows)
                p.result = {n: np.asarray(o)[off : off + p.rows] for n, o in out.items()}
                off += p.rows
        except BaseException as ex:
            # Only THIS batch's requests fail; the handoff in run()'s
            # finally passes the token on regardless.
            for p in batch:
                p.error = ex
            raise
        finally:
            for p in batch:
                p.event.set()


# --------------------------------------------------------------- singleton

_batcher: KernelBatcher | None = None
_batcher_lock = threading.Lock()


def batcher() -> KernelBatcher:
    global _batcher
    with _batcher_lock:
        if _batcher is None:
            _batcher = KernelBatcher()
        return _batcher


def reset_batcher() -> None:
    global _batcher
    with _batcher_lock:
        _batcher = None
