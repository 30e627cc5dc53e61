"""The live watch loop: re-debug a fault-injection sweep while the injector
writes it.

A copy of the JAX package's ``watch/``.  :class:`Watcher` tails one sweep
directory and republishes its report on every batch of new runs; each
update costs O(new runs) through the corpus store's GROWN append and the
result cache's per-segment partials, and a half-written file is
quarantined until it is repaired.  :func:`replay_corpus` feeds a finished
corpus into a directory generation by generation, the deterministic
stand-in for a running sweep.
"""

from nemo_tpu_torch.watch.replay import replay_corpus, replay_plan, start_replay
from nemo_tpu_torch.watch.watcher import WatchConfig, Watcher

__all__ = ["WatchConfig", "Watcher", "replay_corpus", "replay_plan", "start_replay"]
