"""ServiceBackend: TorchBackend with its device verbs on the sidecar.

A port of the JAX package's ``backend/service_backend.py``: the client
process ingests, packs, routes and writes the report; every device verb
travels the sidecar's Kernel RPC as a (verb, named arrays, params) triple
and runs there through the same ``TorchExecutor`` table, so the reports
equal TorchBackend's byte for byte.  ``target`` is the sidecar's
``host:port`` (gRPC) or a ``service.server.Loopback`` (the same handlers
in this process).  Select it with the CLI's ``--graph-backend service``
and the address ``-graphDBConn``; start the sidecar with
``python -m nemo_tpu_torch.service.server``.

The routes do not follow this process's device: the sidecar owns the
card.  On ``analysis_impl="auto"`` the fused buckets take the dense verb
and the synth pass the host lane on this host (both reason
``platform``), the diff the host lane within ``diff_host_work`` and the
dense verb past it, and giant runs the giant verb (``giant_impl="auto"``
resolves to ``device``), as the JAX package's ServiceBackend routes
them.  A forced ``analysis_impl`` routes as TorchBackend's.

The executor connects in ``init_graph_db`` and closes in ``close_db``,
so the backend is reusable across corpora; a segment clone of the
streamed map shares its parent's connection.
"""

from __future__ import annotations

import torch

from nemo_tpu_torch.backend.torch_backend import TorchBackend


class _Unconnected:
    """The executor before init_graph_db and after close_db: the surface
    the backend reads before it connects, and no dispatch."""

    device = torch.device("cpu")
    shard = "off"
    last_dispatch_cold = False

    def __init__(self) -> None:
        self.dispatches: dict = {}
        self.wall_s: dict = {}
        self.host_runs: dict = {}

    def run(self, verb, arrays, params, rows=None):
        raise RuntimeError("ServiceBackend is not connected; call init_graph_db first")

    def count_host(self, verb: str) -> None:
        raise RuntimeError("ServiceBackend is not connected; call init_graph_db first")


class ServiceBackend(TorchBackend):
    """TorchBackend whose executor is a ``service.client.RemoteExecutor``
    on ``target``.  The knobs are TorchBackend's, resolved as the module's
    docstring says."""

    def __init__(self, target="127.0.0.1:50051", analysis_impl: str = "auto", giant_impl: str = "auto",
                 max_batch: int | None = None, **knobs) -> None:
        self.target = target
        self._knobs = dict(knobs)
        super().__init__(analysis_impl=analysis_impl, giant_impl=giant_impl, max_batch=max_batch,
                         executor=_Unconnected(), **knobs)
        #: a segment clone on its parent's connection detaches at close_db
        self._shared_executor = False

    def init_graph_db(self, conn: str, molly) -> None:
        from nemo_tpu_torch.service.client import RemoteExecutor

        if conn and not conn.startswith("bolt://"):
            self.target = conn
        # Reconnect when unconnected or pointed at another sidecar since.
        if not isinstance(self.executor, _Unconnected) and self.executor.target != self.target:
            self.close_db()
        if isinstance(self.executor, _Unconnected):
            self.executor = RemoteExecutor(target=self.target)
            self._shared_executor = False
        super().init_graph_db(conn, molly)

    def stream_clone(self) -> "ServiceBackend":
        clone = type(self)(target=self.target, analysis_impl=self.analysis_impl, giant_impl=self.giant_impl,
                           max_batch=self.max_batch, **self._knobs)
        if not isinstance(self.executor, _Unconnected):
            clone.executor = self.executor
            clone._shared_executor = True
        return clone

    def close_db(self) -> None:
        super().close_db()
        if isinstance(self.executor, _Unconnected):
            return
        if not self._shared_executor:
            self.executor.close()
        self.executor = _Unconnected()
        self._shared_executor = False

    # ---------------------------------------------------------------- routes

    def _analysis_route(self, rows: int, v: int, e: int, rows_dispatch: int) -> tuple[str, str, int]:
        if self.analysis_impl == "auto":
            return "dense", "platform", rows * (v + e)
        return super()._analysis_route(rows, v, e, rows_dispatch)

    def _diff_route(self, good_nodes: int, good_edges: int, n_failed: int, f_pad: int, v: int
                    ) -> tuple[str, str, int]:
        if self.analysis_impl != "auto" or good_nodes > self.giant_v:
            return super()._diff_route(good_nodes, good_edges, n_failed, f_pad, v)
        work = n_failed * (good_nodes + good_edges)
        if work <= self.diff_host_work:
            return "sparse", "crossover", work
        return "dense", "crossover", work

    def _synth_route(self, rows: int, v: int, e: int) -> tuple[str, str, int]:
        if self.analysis_impl == "auto":
            return "sparse", "platform", rows * (v + e)
        return super()._synth_route(rows, v, e)

    def _giant_route(self) -> str:
        if self.giant_impl != "auto":
            return self.giant_impl
        return {"sparse": "host", "sparse_device": "sparse_device"}.get(self.analysis_impl, "device")
