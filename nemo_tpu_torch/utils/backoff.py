"""The jittered exponential backoff of the scheduler's failover and of the
sidecar client's retries: a copy of the JAX package's ``utils/backoff.py``
(``FAILOVER_POLICY``, ``RPC_POLICY``).

Attempt k waits ``base * multiplier**k``, capped at ``max_delay``, scaled
by a uniform ``1 ± jitter`` factor (jitter keeps a burst of failures from
retrying in step); a server's hint replaces the exponential term; past the
session's total budget ``delay()`` returns None and the caller gives up.
Pass ``rng`` (a ``random.Random``) to pin the jitter in tests.
"""

from __future__ import annotations

import random


class BackoffPolicy:
    """The shape of the waits (stateless)."""

    def __init__(
        self,
        base_s: float = 0.2,
        multiplier: float = 2.0,
        max_delay_s: float = 10.0,
        jitter: float = 0.25,
        budget_s: float = 60.0,
    ) -> None:
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.budget_s = float(budget_s)

    def session(self, rng: random.Random | None = None) -> "BackoffSession":
        return BackoffSession(self, rng)


class BackoffSession:
    """One operation's attempt counter and spent budget: ``delay(hint_s=)``
    is the next sleep in seconds, or None once the budget is spent."""

    def __init__(self, policy: BackoffPolicy, rng: random.Random | None = None) -> None:
        self.policy = policy
        self.attempt = 0
        self.spent_s = 0.0
        self._rng = rng or random

    def delay(self, hint_s: float | None = None) -> float | None:
        p = self.policy
        if hint_s is not None and hint_s >= 0:
            raw = float(hint_s)
        else:
            raw = p.base_s * (p.multiplier ** self.attempt)
        raw = min(raw, p.max_delay_s)
        factor = 1.0 + p.jitter * (2.0 * self._rng.random() - 1.0)
        wait = max(0.0, raw * factor)
        if self.spent_s + wait > p.budget_s:
            return None
        self.attempt += 1
        self.spent_s += wait
        return wait


#: The scheduler's pause before a failed device job runs on the host lane
#: (parallel/sched.py): short, with a tight budget so that a burst of
#: failing jobs never stalls a drain.  The scheduler takes its base from
#: ``NEMO_FAILOVER_BACKOFF_S`` (utils/env.py), whose default is this one.
FAILOVER_POLICY = BackoffPolicy(base_s=0.05, multiplier=2.0, max_delay_s=1.0, jitter=0.5, budget_s=5.0)


#: The sidecar client's retries (service/client.py): UNAVAILABLE and the
#: server's ``nemo-retry-after-s`` throttle hint share it; a request that
#: cannot land within a minute of waiting in all fails.
RPC_POLICY = BackoffPolicy(base_s=0.2, multiplier=2.0, max_delay_s=10.0, jitter=0.25, budget_s=60.0)
