"""The fleet's autoscale signal: queue depth, in-flight work and sheds
folded into one hysteresis recommendation a Kubernetes HPA (or a person)
acts on.

A copy of the JAX package's ``serve/autoscale.py``.  The router polls
every replica's Health RPC and keeps the metrics snapshot each answer
carries (serve/router.py); this module turns those snapshots into:

    +1  scale up    (utilization above the high watermark, held, or any
                     shed since the last poll: a shed is the queue saying no)
     0  hold
    -1  scale down  (utilization below the low watermark, held, no shed,
                     and the cooldown since the last flip passed)

It is served as the ``nemo_fleet_autoscale_recommendation`` gauge on the
router's federated ``/metrics`` and as JSON on its ``/autoscale``::

    {"recommendation": -1|0|1, "desired_replicas": N, "replicas_live": N,
     "replicas_total": N, "utilization": float, "queue_depth": float,
     "inflight": float, "capacity": float, "shed_delta": float,
     "reason": str, "thresholds": {...}}

``desired_replicas`` is ``max(1, replicas_live + recommendation)``.
Utilization is ``(queue_depth + inflight) / capacity`` over the live
replicas, a replica's capacity its ``serve.capacity`` gauge (the admission
in-flight cap; ``DEFAULT_CAPACITY`` without one).  Knobs (warn-and-default,
utils/env.py): ``NEMO_AUTOSCALE_UP`` (0.8) and ``NEMO_AUTOSCALE_DOWN``
(0.2), the watermarks; ``NEMO_AUTOSCALE_HOLD_UP`` (2) and
``NEMO_AUTOSCALE_HOLD_DOWN`` (5), the polls a new signal must hold;
``NEMO_AUTOSCALE_COOLDOWN_S`` (60), the wait after a flip before a lower
recommendation (scaling up never waits).

A pure state machine over the samples it is fed: no I/O, no threads.
"""

from __future__ import annotations

import time

from nemo_tpu_torch.utils.env import env_float, env_int

__all__ = ["Autoscaler", "DEFAULT_CAPACITY"]

#: A replica's admission capacity when its snapshot has no ``serve.capacity``.
DEFAULT_CAPACITY = 4.0


class Autoscaler:
    """Feed ``update()`` once a router health-poll round; read ``doc()``."""

    def __init__(self, up_util: float | None = None, down_util: float | None = None, hold_up: int | None = None,
                 hold_down: int | None = None, cooldown_s: float | None = None) -> None:
        self.up_util = up_util if up_util is not None else env_float("NEMO_AUTOSCALE_UP", 0.8)
        self.down_util = down_util if down_util is not None else env_float("NEMO_AUTOSCALE_DOWN", 0.2)
        self.hold_up = hold_up if hold_up is not None else env_int("NEMO_AUTOSCALE_HOLD_UP", 2)
        self.hold_down = hold_down if hold_down is not None else env_int("NEMO_AUTOSCALE_HOLD_DOWN", 5)
        self.cooldown_s = cooldown_s if cooldown_s is not None else env_float("NEMO_AUTOSCALE_COOLDOWN_S", 60.0)
        self._rec = 0
        self._pending_sig = 0
        self._pending_n = 0
        self._last_flip: float | None = None
        self._prev_shed: dict[str, float] = {}
        self._doc: dict = {"recommendation": 0, "reason": "no data"}

    @staticmethod
    def _shed_total(snap: dict) -> float:
        return float(snap.get("counters", {}).get("serve.rejected", 0.0))

    def update(self, snaps: dict[str, dict], up: dict[str, bool], now: float | None = None) -> int:
        """One poll round (each replica's snapshot and liveness) -> the
        recommendation, changed or not."""
        if now is None:
            now = time.monotonic()
        live = [t for t, ok in up.items() if ok]
        depth = inflight = capacity = 0.0
        for t in live:
            g = (snaps.get(t) or {}).get("gauges", {})
            depth += float(g.get("serve.queue_depth", 0.0))
            inflight += float(g.get("serve.inflight", 0.0))
            capacity += float(g.get("serve.capacity", DEFAULT_CAPACITY))
        util = (depth + inflight) / capacity if capacity else 0.0
        shed_delta = 0.0
        for t, snap in snaps.items():
            total = self._shed_total(snap or {})
            prev = self._prev_shed.get(t)
            if prev is not None and total > prev:
                shed_delta += total - prev
            self._prev_shed[t] = total

        if not live:
            sig, reason = 1, "no live replicas"
        elif shed_delta > 0:
            sig, reason = 1, f"shedding ({shed_delta:g} rejects since last poll)"
        elif util > self.up_util:
            sig, reason = 1, f"utilization {util:.2f} > {self.up_util:g}"
        elif util < self.down_util:
            sig, reason = -1, f"utilization {util:.2f} < {self.down_util:g}"
        else:
            sig, reason = 0, f"utilization {util:.2f} in band"

        if sig == self._rec:
            self._pending_n = 0
        else:
            if sig == self._pending_sig:
                self._pending_n += 1
            else:
                self._pending_sig, self._pending_n = sig, 1
            hold = self.hold_up if sig > self._rec else self.hold_down
            cooled = sig > self._rec or self._last_flip is None or now - self._last_flip >= self.cooldown_s
            if self._pending_n >= hold and cooled:
                self._rec = sig
                self._pending_n = 0
                self._last_flip = now
            else:
                reason += f" (held: {self._pending_n}/{hold}" + ("" if cooled else ", cooling down") + ")"

        self._doc = {
            "recommendation": self._rec,
            "desired_replicas": max(1, len(live) + self._rec),
            "replicas_live": len(live),
            "replicas_total": len(up),
            "utilization": round(util, 4),
            "queue_depth": depth,
            "inflight": inflight,
            "capacity": capacity,
            "shed_delta": shed_delta,
            "reason": reason,
            "thresholds": {
                "up_util": self.up_util,
                "down_util": self.down_util,
                "hold_up": self.hold_up,
                "hold_down": self.hold_down,
                "cooldown_s": self.cooldown_s,
            },
        }
        return self._rec

    @property
    def recommendation(self) -> int:
        return self._rec

    def doc(self) -> dict:
        """The ``/autoscale`` JSON body of the last round."""
        return dict(self._doc)
